"""Data-sheet peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W), the
yardstick of every roofline share and of ``solve_mfu``.

HBM at 3.35 TB/s; 67 TFLOP/s in float64 on the tensor cores and in
float32 on the CUDA cores (NVIDIA's H100 data sheet, dense rates), as
``chip_smoke.py`` counts them.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}
ITEM = {"float64": 8, "float32": 4}


def bound_s(n_bytes: float, n_ops: float, dtype: str) -> tuple:
    """(least seconds, what bounds it): the larger of the bytes at the HBM
    rate and the operations at the dtype's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
