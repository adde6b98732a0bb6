"""The frozen work counts reproduce the bound column of PERF.md's kernel
table (l = 16384, d = 128, float64, at 3.35 TB/s and 67 TFLOP/s)."""

import pytest

from portbench.work import (gram_block, peaks, rbf_row_wss,
                            rbf_row_wss_batched, rbf_update_wss,
                            rbf_update_wss_batched, row_wss_batched_rows,
                            solve, update_wss_batched_rows)

L, D, M, IT = 16384, 128, 4096, 8

CASES = {
    "k1 H1 B10": (rbf_row_wss_batched.need(L, D, 10, 1, IT), 0.00662),
    "k1 H2 B18": (rbf_row_wss_batched.need(L, D, 18, 2, IT), 0.01070),
    "k1 act B90": (rbf_row_wss_batched.need(L, D, 90, 1, IT, act=True),
                   0.01964),
    "k2 H1 B10": (rbf_update_wss_batched.need(L, D, 10, 1, IT), 0.00702),
    "k2 H2 B18": (rbf_update_wss_batched.need(L, D, 18, 2, IT), 0.01211),
    "k2 act B90": (rbf_update_wss_batched.need(L, D, 90, 1, IT, act=True),
                   0.02322),
    "k2 conj H1 B10": (rbf_update_wss_batched.need(L, D, 10, 1, IT,
                                                   conj=True), 0.00780),
    "k2 conj act B90": (rbf_update_wss_batched.need(L, D, 90, 1, IT,
                                                    act=True, conj=True),
                        0.03026),
    "k2 conj H2 B1": (rbf_update_wss_batched.need(L, D, 1, 2, IT,
                                                  conj=True), 0.00552),
    "k3 predict": (gram_block.cross(M, L, D, IT), 0.26243),
    "k3 bank entry": (gram_block.symmetric(L, D, IT), 0.64605),
    "k4 H1 B90": (row_wss_batched_rows.need(L, 90, 1, IT), 0.01761),
    "k4 H2 B18": (row_wss_batched_rows.need(L, 18, 2, IT), 0.00634),
    "k4 act H1 B90": (row_wss_batched_rows.need(L, 90, 1, IT, act=True),
                      0.01805),
    "k5 H1 B90": (update_wss_batched_rows.need(L, 90, 1, IT), 0.02465),
    "k5 H2 B18": (update_wss_batched_rows.need(L, 18, 2, IT), 0.00845),
    "k5 conj H1 B90": (update_wss_batched_rows.need(L, 90, 1, IT,
                                                    conj=True), 0.03169),
    "k5 conj act H2 B1": (update_wss_batched_rows.need(L, 1, 2, IT,
                                                       act=True, conj=True),
                          0.00056),
    "k6": (rbf_row_wss.need(L, D, IT), 0.00524),
    "k7": (rbf_update_wss.need(L, D, IT), 0.00528),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bound_matches_kernel_table(case):
    (n_bytes, n_ops), want_ms = CASES[case]
    got = peaks.bound_s(n_bytes, n_ops, "float64")[0] * 1e3
    assert round(got, 5) == want_ms


def test_f32_single_lane_bounds():
    assert round(peaks.bound_s(*rbf_row_wss.need(L, D, 4), "float32")[0]
                 * 1e3, 5) == 0.00262


def test_solve_need_counts_running_lanes_only():
    one = solve.loop_s([100], l=L, d=D, H=1, dtype="float64", bank=True)
    # two lanes, one stopping at 50: 50 iterations of two, 50 of one
    two = solve.loop_s([50, 100], l=L, d=D, H=1, dtype="float64",
                       bank=True)
    assert two == pytest.approx(one * 1.5)
    assert solve.loop_s([], l=L, d=D, H=1, dtype="float64",
                        bank=True) == 0.0


def test_solve_need_reads_x_once_an_iteration():
    # rows from X: one lane or many read X once an iteration
    a = solve.loop_s([10], l=L, d=784, H=1, dtype="float64", bank=False)
    x_read = peaks.bound_s(L * 784 * 8, 0, "float64")[0] * 10
    assert x_read < a < 1.1 * x_read
