"""Kernel 2, the lane-batched rbf pass B (``csrc/rbf_update_wss.cuh``):
rows i and j from ``X``, the update of G, and the next i with the gap's
ends.

Reads X and its squared norms, four (B, n) state rows, 2 B query rows and
four lane vectors; writes G (B, n) and (B, nb) block max, min and int32
argument.  ``act`` adds the (B, n) mask; the conjugate variant (``conj``)
reads the direction (B, l) and its step and writes the next direction
(B, l), and counts 2 B n more operations.
"""

KERNEL = "update_wss_tile_kernel"
WRAPPERS = ("rbf_update_wss_batched", "rbf_update_wss_batched_h2",
            "rbf_update_wss_batched_act", "rbf_update_wss_batched_conj")
BLOCK_L = 128


def need(l: int, d: int, B: int, H: int, item: int, act: bool = False,
         conj: bool = False, block_l: int = BLOCK_L) -> tuple:
    """(bytes, operations) of one launch."""
    n = H * l
    nb = -(-l // block_l)
    n_bytes = ((l * d + l + 4 * B * n + 2 * B * d + 4 * B) * item
               + B * n * item + B * nb * (2 * item + 4))
    if conj:
        # the conjugate variants: 4 B l d + 12 B n, plus the direction
        return (n_bytes + (B * n if act else 0) + 2 * B * l * item + B * item,
                4 * B * l * d + 12 * B * n + 2 * B * n)
    if act:
        return n_bytes + B * n, 4 * B * l * d + 20 * B * l
    return n_bytes, 4 * B * l * d + (20 * B * l if H == 1 else 12 * B * n)
