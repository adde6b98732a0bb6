"""Kernel 7, the single-lane rbf pass B (``csrc/rbf_update_wss_single.cu``).

Reads X and its squared norms, G, k_i, alpha, L, U, the query row and
three scalars; writes G (l) and (nb,) block max, int32 argument and min.
"""

KERNEL = "update_wss_single_kernel"
WRAPPERS = ("rbf_update_wss",)
BLOCK_L = 128


def need(l: int, d: int, item: int, block_l: int = BLOCK_L) -> tuple:
    """(bytes, operations) of one launch."""
    nb = -(-l // block_l)
    return ((l * d + 6 * l + d + 3) * item + l * item
            + nb * (2 * item + 4)), 2 * l * d + 12 * l
