"""Build and load the port's CUDA kernels; count their launches.

The sources in ``csrc/`` have a plain C interface, so they are compiled by
``nvcc`` alone (seconds; no PyTorch headers), one process per source, all
started together, and linked into one shared library,
``build/torch_kernels/libcot_kernels-<hash>.so`` at the repo root, named by
the hash of the sources and flags: the first use after a source change
rebuilds, later uses load the cached build.  The library is loaded with
ctypes; every pointer and the stream are passed as ``c_void_p``, and every
entry point returns a ``cudaError_t`` that the wrappers turn into an
exception.

Nothing here runs at import: modules that import this one must stay
importable on hosts without nvcc or a card.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: launches per kernel name, added to by each wrapper where it launches
#: its kernel and nowhere else (chip_smoke.py resets and reads it)
launches: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()
#: seconds the last load() spent building (0.0 when the cache was warm)
build_seconds = 0.0

_VP = ctypes.c_void_p
_I = ctypes.c_int
_Fl = ctypes.c_float


def reset_launches() -> None:
    launches.clear()


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _so_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(_BUILD_DIR, f"libcot_kernels-{h.hexdigest()[:16]}.so")


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def _compile(so: str) -> None:
    """One nvcc per source, all started together, then one link."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    cu = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    try:
        _run([[_nvcc(), *compile_flags, "-c", "-o", o, s]
              for s, o in zip(cu, objs)])
        _run([[_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)


def _declare(lib) -> None:
    lib.cot_sweep_check.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I,
                                    ctypes.POINTER(_I)]
    lib.cot_sweep_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                _VP, _VP, _I, _I, _I, _I, _Fl, _Fl, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _VP]
    lib.cot_sweep_tiled_check.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I,
                                          ctypes.POINTER(_I)]
    lib.cot_sweep_tiled_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                      _VP, _VP, _VP, _I, _I, _I, _I, _Fl,
                                      _Fl, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _VP]
    lib.cot_matvec_occupancy.argtypes = [_I, ctypes.POINTER(_I)]
    lib.cot_ax_minus_b_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                     _I, _VP]
    lib.cot_neg_at_r_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                                   _I, _I, _I, _Fl, _VP]
    lib.cot_block_power_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _Fl, _VP]
    lib.cot_block_gram_t.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                     _I, _VP]
    lib.cot_block_power_gram_t.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I,
                                           _Fl, _VP]
    lib.cot_batch_sweep_check.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _I, ctypes.POINTER(_I)]
    lib.cot_batch_sweep_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                      _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                      _I, _I, _Fl, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _VP]
    lib.cot_ax_minus_b_batch_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I,
                                           _I, _I, _I, _VP]
    lib.cot_matvec_batch_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.cot_neg_at_r_batch_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I,
                                         _I, _I, _I, _I, _I, _Fl, _VP]
    lib.cot_sweep_slab_t.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                     _VP, _VP, _VP, _I, _I, _I, _I, _Fl, _Fl,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _VP]
    lib.cot_error_string.argtypes = [_I]
    lib.cot_error_string.restype = ctypes.c_char_p
    for fn in (lib.cot_sweep_check, lib.cot_sweep_t, lib.cot_sweep_slab_t,
               lib.cot_sweep_tiled_check, lib.cot_sweep_tiled_t,
               lib.cot_matvec_occupancy, lib.cot_ax_minus_b_t,
               lib.cot_neg_at_r_t, lib.cot_block_power_t,
               lib.cot_block_gram_t, lib.cot_block_power_gram_t,
               lib.cot_batch_sweep_check, lib.cot_batch_sweep_t,
               lib.cot_matvec_batch_plan, lib.cot_ax_minus_b_batch_t,
               lib.cot_neg_at_r_batch_t):
        fn.restype = _I


def load():
    """The kernel library, built on first use; raises when it cannot be
    built or loaded."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = _so_path()
            t0 = time.perf_counter()
            if not os.path.exists(so):
                _compile(so)
            build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(so)
            _declare(lib)
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel entry point."""
    if err != 0:
        msg = load().cot_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
