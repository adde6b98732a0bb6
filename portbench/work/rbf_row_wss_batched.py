"""Kernel 1, the lane-batched rbf pass A (``csrc/rbf_row_wss.cuh``): each
lane's row k(x_i, X) computed from ``X``, and the second-order pick of j.

Reads X (l x d) and its squared norms, four (B, n) state rows, the B query
rows and six lane vectors, an int32 index and a flag a lane; writes a
(B, nb) block max and its int32 argument (nb blocks of ``block_l``
columns).  The ``act`` variant reads the (B, n) mask too.
"""

KERNEL = "row_wss_tile_kernel"
WRAPPERS = ("rbf_row_wss_batched", "rbf_row_wss_batched_h2",
            "rbf_row_wss_batched_act")
BLOCK_L = 128


def need(l: int, d: int, B: int, H: int, item: int, act: bool = False,
         block_l: int = BLOCK_L) -> tuple:
    """(bytes, operations) of one launch at l rows of d features, B lanes
    of n = H l coordinates."""
    n = H * l
    nb = -(-l // block_l)
    n_bytes = ((l * d + l + 4 * B * n + B * d + 6 * B) * item + 5 * B
               + B * nb * (item + 4) + (B * n if act else 0))
    return n_bytes, 2 * B * l * d + 20 * B * n
