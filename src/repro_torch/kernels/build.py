"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launch functions that return the
``cudaError_t`` of their launch. All sources compile in parallel, one nvcc
per file, at the first call that needs a kernel, into
``build/repro_torch_kernels/<hash>/`` at the repository root, where
``<hash>`` covers the sources, the headers they share (``csrc/*.cuh``) and
the flags: a changed source or header builds anew, an unchanged tree loads
what is there. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("masked_pseudo_ce", "csr_compact", "staleness_agg",
           "sparse_delta", "csr_quant", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# launch function -> (source, argtypes); every one returns cudaError_t
# (csr_quant_blocks a block count, or -cudaError_t)
SIGNATURES = {
    "masked_pseudo_ce_launch": ("masked_pseudo_ce",
                                (_P, _P, _P, _I, _I, _F, _P)),
    "masked_pseudo_ce_bwd_launch": ("masked_pseudo_ce",
                                    (_P, _P, _P, _P, _I, _I, _P)),
    "masked_pseudo_ce_wide_launch": ("masked_pseudo_ce",
                                     (_P, _P, _P, _I, _I, _F, _P)),
    "masked_pseudo_ce_wide_bwd_launch": ("masked_pseudo_ce",
                                         (_P, _P, _P, _P, _I, _I, _P)),
    "csr_compact_launch": ("csr_compact", (_P, _P, _P, _P, _P, _P, _P, _LL,
                                           _LL, _I, _I, _I, _P)),
    "staleness_agg_launch": ("staleness_agg", (_P, _P, _P, _I, _LL, _P)),
    "sparse_delta_launch": ("sparse_delta",
                            (_P, _P, _P, _P, _I, _LL, _I, _P)),
    "csr_quant_blocks": ("csr_quant", (_I,)),
    "csr_quant_launch": ("csr_quant", (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _LL, _LL, _I, _I, _I, _I, _I,
                                       _P)),
    "flash_attention_launch": ("flash_attention",
                               (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _F, _P)),
}

_loaded = {}    # launch function name -> ctypes function, once built
build_log = {}  # source -> nvcc's stderr (ptxas register/spill report)


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "CUDA kernels of repro_torch cannot be built")


def build_dir():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build():
    """Compile every source that is not built yet, all nvcc processes
    started together; returns the build directory. Raises with nvcc's
    output if any compile fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out / f"{n}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        build_log[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                          f"{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def kernel(fn_name):
    """The ctypes launch function ``fn_name``, building and loading its
    library on first use."""
    fn = _loaded.get(fn_name)
    if fn is None:
        source, argtypes = SIGNATURES[fn_name]
        lib = ctypes.CDLL(str(build() / f"{source}.so"))
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[fn_name] = fn
    return fn
