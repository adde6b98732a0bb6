"""Build the port's CUDA kernels with ``nvcc`` at first use; load them with
``ctypes``.

The sources under ``csrc/`` have a plain ``extern "C"`` interface, so no
PyTorch header is compiled: each ``.cu`` file is compiled on its own by one
``nvcc`` process (all started together), then linked into one shared
library.  The library lands in ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources and flags, so a changed
source builds anew and an unchanged one loads at once.

Nothing here runs when the module is imported: :func:`load` builds and
loads on its first call, which is the first kernel launch.  The slabs of
the lane-sharded engine launch from several host threads, so the build
and the load run once a process, under a lock.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
# Columns of l per thread block in the rbf pass A / pass B kernels; must
# equal kBlockL in csrc/common.cuh (checked when the library loads).  The
# bank passes size their blocks at each launch (launch_lanes in
# csrc/bank_pass.cuh).
BLOCK_L = 128
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: it swaps exp and division for approximations, and the
# float32 kernels must match their plain versions to 1e-5.
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signature of each kernel entry (the _f32 and _f64 variants share it).
SIGNATURES = {
    # XT sqn G alpha L U XQ sqq a_i L_i U_i g_i i_idx use_exact gammas
    # act bmax barg | B H l d device | stream  (act may be NULL)
    "rbf_row_wss_batched": [_P] * 18 + [_I] * 5 + [_P],
    # XT sqn G alpha L U XQi sqqi XQj sqqj mu gammas act dirv mu2 G_out
    # bmax barg bmin r_out | B H l d device | stream  (act, and dirv with
    # mu2 and r_out, may be NULL)
    "rbf_update_wss_batched": [_P] * 20 + [_I] * 5 + [_P],
    # XT sqn G alpha L U xq sqq a_i L_i U_i g_i i_idx use_exact gamma run
    # k_out bmax barg | l d device | stream
    "rbf_row_wss": [_P] * 19 + [_I] * 3 + [_P],
    # XT sqn G k_i alpha L U xqj sqqj mu gamma G_out bmax barg bmin
    # | l d device | stream
    "rbf_update_wss": [_P] * 15 + [_I] * 3 + [_P],
    # gram gram_idx G alpha L U a_i L_i U_i g_i i_idx use_exact act part_v
    # part_i tickets j gain | B H l nb_cap | bank_stride row_stride |
    # device | stream  (gram_idx NULL: pre-gathered rows)
    "row_wss_batched_rows": [_P] * 18 + [_I] * 4 + [_LL] * 2 + [_I, _P],
    # gram_i gram_j gram_idx i_idx j_idx G alpha_new L U mu act dirv mu2
    # G_out part_v part_i part_m tickets i_next g_i_next g_dn r_out | B H
    # l nb_cap | bank_stride row_stride | device | stream  (gram_idx, i_idx
    # and j_idx NULL: pre-gathered rows)
    "update_wss_batched_rows": [_P] * 22 + [_I] * 4 + [_LL] * 2 + [_I, _P],
    # X1 X2 s1 s2 out | gamma | m n d device | stream
    "gram_block": [_P] * 5 + [ctypes.c_double] + [_I] * 4 + [_P],
}
# Resource queries (name + "_attrs", not kernels): the batched passes'
# tiled variants take B H masked | out int[4], pass B with conj before
# out; the single-lane passes (kernels 6 and 7) out alone; the Gram vec |
# out int[6].
ATTRS = {
    "rbf_row_wss_batched": [_I] * 3 + [_P],
    "rbf_update_wss_batched": [_I] * 4 + [_P],
    "rbf_row_wss": [_P],
    "rbf_update_wss": [_P],
    "gram_block": [_I, _P],
}


# nvcc builds this process ran, by source hash (the capture guard holds a
# (C, gamma) sweep to one a hash)
BUILDS: collections.Counter = collections.Counter()
# the loaded library, once a process; _LOAD_LOCK serialises the first
# build and load
_LIB: list = []
_LOAD_LOCK = threading.Lock()


def sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    """Hash of every source and of the flags: the library's name."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"librepro_torch_kernels-{source_hash()}.so"


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    ``nvcc`` on ``PATH``."""
    cands = [os.path.join(os.environ[k], "bin", "nvcc")
             for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "the repro_torch CUDA kernels need nvcc to build, and none was "
            "found (set CUDA_HOME or put nvcc on PATH)")
    return found


def compile_commands(nvcc: str, out_dir: pathlib.Path,
                     verbose: bool = False) -> list[list[str]]:
    """One ``nvcc -c`` command per ``.cu`` source."""
    extra = ["-Xptxas", "-v"] if verbose else []
    return [[nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
             "-o", str(out_dir / (src.stem + ".o"))]
            for src in sources() if src.suffix == ".cu"]


def build(verbose: bool = False) -> pathlib.Path:
    """Build the shared library unless the current sources already have one.

    Returns its path.  ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) and prints the compiler's output.
    Raises ``RuntimeError`` with the compiler's output when a step fails.
    """
    path = library_path()
    if path.exists():
        return path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = pathlib.Path(tmp)
        cmds = compile_commands(nvcc, tmp, verbose)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        failed = [(c, log) for c, p, log in zip(cmds, procs, logs)
                  if p.returncode != 0]
        if verbose:
            for c, log in zip(cmds, logs):
                print(f"[nvcc {pathlib.Path(c[-3]).name}]\n{log}", flush=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"$ {' '.join(c)}\n{log}" for c, log in failed))
        objs = sorted(str(o) for o in tmp.glob("*.o"))
        lib = tmp / path.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, path)
    BUILDS[source_hash()] += 1
    return path


def load() -> ctypes.CDLL:
    """The kernel library: built if needed and loaded on the first call of
    the process (under a lock, so threads that launch together run one
    ``nvcc`` build and one load), the same library after."""
    if _LIB:
        return _LIB[0]
    with _LOAD_LOCK:
        if not _LIB:
            _LIB.append(_load())
        return _LIB[0]


def _load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry's ``argtypes``."""
    lib = ctypes.CDLL(str(build()))
    lib.repro_block_l.argtypes = []
    lib.repro_block_l.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    if lib.repro_block_l() != BLOCK_L:
        raise RuntimeError(f"kernel library has kBlockL = "
                           f"{lib.repro_block_l()}, the wrappers expect "
                           f"{BLOCK_L}")
    for name, argtypes in SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for name, argtypes in ATTRS.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + "_attrs" + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def entry(name: str, dtype_bits: int):
    """The loaded C entry ``name`` for float32 (32) or float64 (64)."""
    return getattr(load(), f"{name}_f{dtype_bits}")


def tile_attrs(name: str, dtype_bits: int, B: int, H: int, masked: bool,
               conj: bool = False) -> dict:
    """Resources of the tiled variant that a launch of the batched rbf pass
    ``name`` ("rbf_row_wss_batched" or "rbf_update_wss_batched") at B
    lanes takes, from ``cudaFuncGetAttributes``: registers a thread, local
    memory a thread (spills included: 0 means none), static and dynamic
    shared memory a block."""
    out = (ctypes.c_int * 4)()
    args = [B, H, int(masked)]
    if name == "rbf_update_wss_batched":
        args.append(int(conj))
    fn = f"{name}_attrs_f{dtype_bits}"
    check(getattr(load(), fn)(*args, out), fn)
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem"),
                    out))


def single_attrs(name: str, dtype_bits: int) -> dict:
    """Resources of the single-lane pass ``name`` ("rbf_row_wss", kernel 6,
    or "rbf_update_wss", kernel 7) in the variant the main path launches,
    as :func:`tile_attrs` gives them."""
    out = (ctypes.c_int * 4)()
    fn = f"{name}_attrs_f{dtype_bits}"
    check(getattr(load(), fn)(out), fn)
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem"),
                    out))


def gram_attrs(dtype_bits: int, vec: bool) -> dict:
    """Resources of the Gram kernel's instance with (``vec``, f64 only)
    or without 16-byte copies of X1 and X2, as :func:`tile_attrs` gives
    them, and its output tile (``tm`` x ``tn``)."""
    out = (ctypes.c_int * 6)()
    fn = f"gram_block_attrs_f{dtype_bits}"
    check(getattr(load(), fn)(int(vec), out), fn)
    return dict(zip(("regs", "local_bytes", "static_smem", "dynamic_smem",
                     "tm", "tn"), out))


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = load().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
