"""Kernel 5, the Gram-bank pass B (``csrc/update_wss_rows.cu``): rows i
and j read from the bank, the update of G, and the next i with the gap's
ends, folded across blocks in the launch.

Reads 2 B bank rows of l and four (B, n) state rows, writes G (B, n);
reads mu, i, j and the bank index, writes the (B,) next i, its G and the
gap's min.  ``act`` adds the (B, n) mask; ``conj`` the direction (B, l)
read and written and its step, and 2 B n operations.
"""

KERNEL = "update_wss_rows_kernel"
WRAPPERS = ("update_wss_batched_rows", "update_wss_batched_rows_h2",
            "update_wss_batched_rows_act", "update_wss_batched_rows_conj")


def need(l: int, B: int, H: int, item: int, act: bool = False,
         conj: bool = False) -> tuple:
    """(bytes, operations) of one launch."""
    n = H * l
    n_bytes = ((2 * B * l + 5 * B * n + B) * item + 16 * B
               + B * (2 * item + 4) + (B * n if act else 0))
    if conj:
        return n_bytes + 2 * B * l * item + B * item, 6 * B * n + 2 * B * n
    return n_bytes, 6 * B * n
