"""Build and load the port's CUDA kernels (nvcc + ctypes).

At first use, every `csrc/*.cu` source is compiled by its own `nvcc`
process (all started together) into a shared library with a plain C
interface under `<repo>/build/repro_torch_kernels/<hash>/`, where the
hash covers the sources and the flags, so an edited source rebuilds and
an unchanged one loads at once. A missing `nvcc` or a failed build
raises: no caller falls back to the plain PyTorch versions on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported function, by library
SIGNATURES = {
    "flash_attention": {
        # q, k, v, o, lse, bh, s, d, dtype, causal, window, scale, stream
        "flash_fwd": [P, P, P, P, P, I, I, I, I, I, I, F, P],
        # q, k, v, delta, lse, dout, dk, dv, bh, s, d, dtype, causal,
        # window, scale, stream
        "flash_bwd_dkdv": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
        # q, k, v, o, lse, dout, dq, delta, bh, s, d, dtype, causal,
        # window, scale, stream
        "flash_bwd_dq": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P],
    },
    "moe_gmm": {
        # x, w, y, e, m, k, n, dtype, stream
        "gmm_fwd": [P, P, P, I, I, I, I, I, P],
        # dy, w, dx, e, m, k, n, dtype, stream
        "gmm_bwd_dx": [P, P, P, I, I, I, I, I, P],
        # x, dy, dw, e, m, k, n, dtype, stream
        "gmm_bwd_dw": [P, P, P, I, I, I, I, I, P],
    },
    "rglru_scan": {
        # a, x, h, ws, b, s, d, chunk, a_dtype, x_dtype, stream
        "rglru_fwd": [P, P, P, P, I, I, I, I, I, I, P],
        # a, h, g, da, dx, ws, b, s, d, chunk, a_dtype, x_dtype, stream
        "rglru_bwd": [P, P, P, P, P, P, I, I, I, I, I, I, P],
    },
    "mlstm": {
        # q, k, v, log_i, log_f, h, C_st, n_st, m_st, m_loc, den, ws, bh,
        # s, k_dim, chunk, dtype, scale, stream
        "mlstm_fwd": [P] * 12 + [I] * 5 + [F, P],
        # q, k, v, log_i, log_f, h, dh, C_st, n_st, m_st, m_loc, den, dq,
        # dk, dC, dn, ws, bh, s, k_dim, chunk, dtype, scale, stream
        "mlstm_bwd_dqdk": [P] * 17 + [I] * 5 + [F, P],
        # q, k, log_i, dh, m_loc, dC, ws (mlstm_bwd_dqdk's), dq, dk, dv,
        # dlog_i, dlog_f, bh, s, k_dim, chunk, dtype, scale, stream
        "mlstm_bwd_dv": [P] * 12 + [I] * 5 + [F, P],
    },
}


class KernelLibraries:
    """The loaded libraries plus what their build cost: `seconds` is
    the wall time of the build (0 when every library was already built
    for these sources) and `log` holds nvcc's output (registers, shared
    memory and spills of every kernel, from -Xptxas -v)."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.seconds = 0.0
        self.log: Dict[str, str] = {}

    def __getitem__(self, name: str) -> ctypes.CDLL:
        return self.libs[name]


_LOADED: Optional[KernelLibraries] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*")):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def libraries() -> KernelLibraries:
    """Build (if needed) and load every kernel library, once per
    process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    out = KernelLibraries()
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        so = _target(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out.log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    out.seconds = time.perf_counter() - t0 if procs else 0.0
    for name, sigs in SIGNATURES.items():
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        out.libs[name] = lib
    _LOADED = out
    return out
