"""Hand-written Hopper kernels of the port, their wrappers and their plain
PyTorch versions.

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); :func:`reset_launches` and :func:`launches` read
and clear them together, so a run can show which kernels it went through.
The Gram wrapper also counts its symmetric-mode launches
(``gram_block.gram_cross.symmetric_launches``, cleared with the rest).
A CUDA graph launches kernels without calling their wrappers: whoever
replays one adds its launches with :func:`add_launches`.  The counters
are exact across host threads (:mod:`repro_torch.kernels.tally`), and
``launches(thread=True)`` reads the calling thread's own.
"""

from repro_torch.kernels import (gram_block, rbf_row_wss, rbf_update_wss,
                                 tally)

# the single-lane wrappers share their modules' names, so the registry
# reaches every wrapper through its module
WRAPPERS = {
    "rbf_row_wss_batched": rbf_row_wss.rbf_row_wss_batched,
    "rbf_update_wss_batched": rbf_update_wss.rbf_update_wss_batched,
    "gram_block": gram_block.gram_cross,
    "row_wss_batched_rows": rbf_row_wss.row_wss_batched_rows,
    "update_wss_batched_rows": rbf_update_wss.update_wss_batched_rows,
    "rbf_row_wss": rbf_row_wss.rbf_row_wss,
    "rbf_update_wss": rbf_update_wss.rbf_update_wss,
    "rbf_row_wss_batched_h2": rbf_row_wss.rbf_row_wss_batched_h2,
    "rbf_update_wss_batched_h2": rbf_update_wss.rbf_update_wss_batched_h2,
    "row_wss_batched_rows_h2": rbf_row_wss.row_wss_batched_rows_h2,
    "update_wss_batched_rows_h2": rbf_update_wss.update_wss_batched_rows_h2,
    "rbf_row_wss_batched_act": rbf_row_wss.rbf_row_wss_batched_act,
    "rbf_update_wss_batched_act": rbf_update_wss.rbf_update_wss_batched_act,
    "row_wss_batched_rows_act": rbf_row_wss.row_wss_batched_rows_act,
    "update_wss_batched_rows_act": rbf_update_wss.update_wss_batched_rows_act,
    "rbf_update_wss_batched_conj":
        rbf_update_wss.rbf_update_wss_batched_conj,
    "update_wss_batched_rows_conj":
        rbf_update_wss.update_wss_batched_rows_conj,
}


def reset_launches() -> None:
    with tally.LOCK:
        for w in WRAPPERS.values():
            w.launches = 0
        gram_block.gram_cross.symmetric_launches = 0


def launches(thread: bool = False) -> dict:
    """{name: launches} of the process, or with ``thread`` of the calling
    thread alone."""
    if thread:
        mine = tally.mine()
        return {name: mine[w] for name, w in WRAPPERS.items()}
    return {name: w.launches for name, w in WRAPPERS.items()}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` ({name: launches}) to the counters, the
    calling thread's included."""
    for name, n in counts.items():
        tally.count(WRAPPERS[name], times * n)
