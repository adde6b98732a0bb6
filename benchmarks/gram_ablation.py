#!/usr/bin/env python3
"""What holds the port's Gram kernel (``csrc/gram_block.cu``) on the card.

    python3 benchmarks/gram_ablation.py

from the root of a checkout, on a CUDA card.  Builds the kernel's source
three ways, each into a library of its own under
``build/gram_ablation/``: as it stands, without the exp (the epilogue
stores the squared distance), and without the stores (every store behind
a test that never passes, so the values are still computed).  Times each
at the predict shape (4096 x 16384, d = 128, cross) and the bank shape
(16384 x 16384, d = 128, symmetric) in f64 and f32 with CUDA events, and
cuBLAS's ``X1 @ X2.T`` (the product alone) beside them.  The two
ablations are not the Gram: they only say what the exp and the stores
cost inside the kernel.  Prints one line per (variant, dtype, shape).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the epilogue's rbf_entry(s1, s2, prod, gamma) -> the squared distance
NO_EXP_HELPER = ("template <typename T> __device__ __forceinline__ T "
                 "gram_d2(T a, T b, T p, T g) { return (a + b) - T(2) * p; }")


def variants(src: str) -> dict:
    no_exp = src.replace("namespace repro {",
                         "namespace repro {\n" + NO_EXP_HELPER, 1)
    no_exp = no_exp.replace("rbf_entry(", "gram_d2(")
    no_store = src
    for store in ("stg<", "out[row", "out[(size_t)"):
        no_store = no_store.replace(store, "if (gamma < 0) " + store)
    return {"kept": src, "no exp": no_exp, "no store": no_store}


def build_all(out_dir: pathlib.Path) -> dict:
    from repro_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    src = (build.CSRC / "gram_block.cu").read_text()
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        cu = out_dir / f"gram_{i}.cu"
        cu.write_text(text)
        # -fno-gnu-unique: each library keeps its own once-per-device
        # shared-memory flags
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
               "-shared", "-I", str(build.CSRC), str(cu), "-o",
               str(out_dir / f"gram_{i}.so")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out_dir / f"gram_{i}.so")
    libs = {}
    for name, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("gram_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import gram_block
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_all(ROOT / "build" / "gram_ablation")
    timer = cs.DeviceTimer()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for dtype, bits in ((torch.float64, 64), (torch.float32, 32)):
        Xq = torch.tensor(rng.normal(size=(cs.N_TEST, cs.D)), dtype=dtype,
                          device=dev)
        X = torch.tensor(rng.normal(size=(cs.N_TRAIN, cs.D)), dtype=dtype,
                         device=dev)
        sq, sx = (Xq * Xq).sum(-1), (X * X).sum(-1)
        shapes = {"predict": (Xq, X, sq, sx), "bank": (X, X, sx, sx)}
        for shape, (X1, X2, s1, s2) in shapes.items():
            assert (shape == "bank") == gram_block.is_symmetric(X1, X2)
            out = torch.empty((X1.shape[0], X2.shape[0]), dtype=dtype,
                              device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            for name, lib in libs.items():
                fn = getattr(lib, f"gram_block_f{bits}")
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_double]
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                args = [t.data_ptr() for t in (X1, X2, s1, s2, out)] + [
                    1.0 / (2 * cs.D), X1.shape[0], X2.shape[0], cs.D, 0,
                    stream]

                def run():
                    assert fn(*args) == 0, name
                ms = min(timer.ms(run, 10) for _ in range(2))
                print(f"[ablation] {str(dtype)[6:]} {shape} {name}: "
                      f"{ms:.5f} ms", flush=True)
            gemm = min(timer.ms(lambda: X1 @ X2.T, 10) for _ in range(2))
            print(f"[ablation] {str(dtype)[6:]} {shape} cuBLAS X1 @ X2.T: "
                  f"{gemm:.5f} ms", flush=True)
            del out
    print(f"[ablation] card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
