"""Hand-written Hopper kernels of the port, their wrappers and their plain
PyTorch versions.

Each wrapper counts its launches in a plain integer attribute
(``wrapper.launches``); :func:`reset_launches` and :func:`launches` read
and clear them together, so a run can show which kernels it went through.
"""

from repro_torch.kernels.gram_block import gram_cross
from repro_torch.kernels.rbf_row_wss import (rbf_row_wss_batched,
                                             row_wss_batched_rows)
from repro_torch.kernels.rbf_update_wss import (rbf_update_wss_batched,
                                                update_wss_batched_rows)

WRAPPERS = {
    "rbf_row_wss_batched": rbf_row_wss_batched,
    "rbf_update_wss_batched": rbf_update_wss_batched,
    "gram_block": gram_cross,
    "row_wss_batched_rows": row_wss_batched_rows,
    "update_wss_batched_rows": update_wss_batched_rows,
}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launches() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}
