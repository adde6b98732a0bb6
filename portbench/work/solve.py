"""The least work a whole solve needs, counted from the algorithm and not
from the launches that carry it out, so it reads the same whatever kernels
implement it: ``solve_mfu`` is this time at the data-sheet peaks over the
measured ``solve_s``.

A lane costs only while it runs (a converged lane needs nothing more), so
the loop's part follows each lane's own iteration count.  An iteration of
a running lane needs the two kernel-matrix rows its step reads (i and j,
base rows of l values): read from the bank, or computed from ``X``, two
rows of l products of d, with ``X`` read once an iteration for all lanes.
It also needs the lane's G, alpha and bounds L, U read once and G written
once (5 n values, n = H l coordinates), and 4 n operations to update G.
Each part is bound by its bytes or its operations, whichever takes longer,
and the parts add up: an iteration, the bank build (one symmetric Gram a
gamma) and the held-out decisions (one cross Gram a gamma, and each lane's
m x l product).
"""

from portbench.work import gram_block, peaks


def loop_s(lane_iterations, *, l: int, d: int, H: int, dtype: str,
           bank: bool) -> float:
    """Seconds the loop needs at the peaks, for lanes that ran the given
    iteration counts."""
    item = peaks.ITEM[dtype]
    n = H * l
    lane_bytes = 5 * n * item + (2 * l * item if bank else 0)
    lane_ops = 4 * n + (0 if bank else 4 * l * d)
    shared = 0 if bank else l * d * item
    total, done = 0.0, 0
    counts = sorted(int(t) for t in lane_iterations)
    for k, t in enumerate(counts):
        # iterations done .. t run with the lanes still going
        steps, running = t - done, len(counts) - k
        if steps > 0:
            total += steps * peaks.bound_s(shared + running * lane_bytes,
                                           running * lane_ops, dtype)[0]
            done = t
    return total


def bank_s(n_gamma: int, *, l: int, d: int, dtype: str) -> float:
    """Seconds the bank build needs: a symmetric Gram a gamma."""
    return n_gamma * peaks.bound_s(
        *gram_block.symmetric(l, d, peaks.ITEM[dtype]), dtype)[0]


def decision_s(lanes_per_gamma, *, m: int, l: int, d: int,
               dtype: str) -> float:
    """Seconds the held-out decisions need: for each gamma the cross Gram
    (m x l) and its product with that gamma's lanes' coefficients."""
    item = peaks.ITEM[dtype]
    total = 0.0
    for b in lanes_per_gamma:
        total += peaks.bound_s(*gram_block.cross(m, l, d, item), dtype)[0]
        total += peaks.bound_s((b * l + b * m) * item, 2 * b * m * l,
                               dtype)[0]
    return total
