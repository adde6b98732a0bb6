"""Kernel 6, the single-lane rbf pass A (``csrc/rbf_row_wss_single.cu``).

Reads X and its squared norms, four state vectors, the query row and
seven scalars; writes the row (l) and (nb,) block max and int32 argument.
"""

KERNEL = "row_wss_single_kernel"
WRAPPERS = ("rbf_row_wss",)
BLOCK_L = 128


def need(l: int, d: int, item: int, block_l: int = BLOCK_L) -> tuple:
    """(bytes, operations) of one launch."""
    nb = -(-l // block_l)
    return ((l * d + 5 * l + d + 6) * item + 5 + l * item
            + nb * (item + 4)), 2 * l * d + 25 * l
