"""Kernel 4, the Gram-bank pass A (``csrc/row_wss_rows.cu``): each lane's
row i read from the bank, and the second-order pick of j, folded across
blocks in the launch.

Reads B bank rows of l, four (B, n) state rows, four lane vectors, the
int32 i, the int64 bank index and a flag; writes the (B,) gain and int32
j.  ``act`` adds the (B, n) mask.
"""

KERNEL = "row_wss_rows_kernel"
WRAPPERS = ("row_wss_batched_rows", "row_wss_batched_rows_h2",
            "row_wss_batched_rows_act")


def need(l: int, B: int, H: int, item: int, act: bool = False) -> tuple:
    """(bytes, operations) of one launch."""
    n = H * l
    n_bytes = ((B * l + 4 * B * n + 4 * B) * item + 13 * B + B * (item + 4)
               + (B * n if act else 0))
    return n_bytes, 20 * B * n
