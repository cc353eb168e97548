"""ctypes binding to the native host runtime ``native/co_native.cpp``.

Counterpart of ``convex_optimization_tpu/utils/native.py``, for the entry
points the port's main path uses: ``gaussian`` (threaded normal fill for
data generation), ``cd64_sweeps``, ``cd64_group_sweeps``,
``group_power_l``, ``gather_cols``, ``atr_mixed`` and ``ax_sparse`` (the
f64 polish).  The same C++ source is built with g++ at
first use into ``build/torch_native/`` (named by the source's and the
host's hash, so a stale or foreign build is never loaded) and checked
against the ABI version below.  Every entry point has a NumPy fallback for
hosts without a compiler; ``gaussian``'s fallback draws other numbers than
the native generator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "co_native.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_native")

#: must equal co_version() in native/co_native.cpp
_EXPECTED_VERSION = 7

_lib = None
_lib_path: str | None = None
_lock = threading.Lock()
_build_failed = False

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64


def _host_signature() -> str:
    """-march=native code from another host can SIGILL inside the polish,
    so the build is keyed by the host's CPU flags too."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        pass
    return f"{os.uname().machine}|{flags.strip()}"


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + _host_signature().encode())
    return os.path.join(_BUILD_DIR, f"co_native-{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    """Compile to a temporary name and rename into place (atomic)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", "-pthread", _SRC, "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib) -> None:
    lib.co_version.restype = ctypes.c_int
    lib.co_gaussian_fill.argtypes = [_F, _I64, ctypes.c_uint64, ctypes.c_int]
    lib.co_gaussian_fill.restype = None
    lib.co_cd64_sweeps.argtypes = [_F, _I64, _I64, _D, _D, _D,
                                   ctypes.c_double, ctypes.c_double,
                                   ctypes.c_int, ctypes.c_int]
    lib.co_cd64_sweeps.restype = None
    lib.co_gather_cols.argtypes = [_F, _I64, ctypes.POINTER(_I64), _I64,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.co_gather_cols.restype = None
    lib.co_atr_mixed.argtypes = [_F, _I64, _I64, _D, ctypes.c_double, _D, _D]
    lib.co_atr_mixed.restype = None
    lib.co_ax_sparse.argtypes = [_F, _I64, _I64, _D, _D, _D]
    lib.co_ax_sparse.restype = None
    lib.co_cd64_group_sweeps.argtypes = [_F, _I64, _I64, _I64, _D, _D, _D,
                                         _D, ctypes.c_double,
                                         ctypes.c_double, ctypes.c_int, _D]
    lib.co_cd64_group_sweeps.restype = None
    lib.co_group_power_l.argtypes = [_F, _I64, _I64, _I64, ctypes.c_int,
                                     ctypes.c_double, ctypes.c_double, _D,
                                     _D]
    lib.co_group_power_l.restype = None


def _load():
    """Build if needed and load the library; None when unavailable (set
    CO_NATIVE_DEBUG=1 to see why)."""
    global _lib, _lib_path, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = _so_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            _declare(lib)
            if lib.co_version() != _EXPECTED_VERSION:
                raise RuntimeError(
                    f"co_native ABI {lib.co_version()}, "
                    f"expected {_EXPECTED_VERSION}")
            _lib, _lib_path = lib, so
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            if os.environ.get("CO_NATIVE_DEBUG"):
                import traceback

                traceback.print_exc()
            _build_failed = True
    return _lib


def have_native() -> bool:
    return _load() is not None


def library_path() -> str | None:
    """Path of the loaded native library; None on the NumPy fallback."""
    _load()
    return _lib_path


def gaussian(shape, seed: int, *, nthreads: int | None = None) -> np.ndarray:
    """Standard-normal f32 array, deterministic in seed (and independent
    of nthreads); identical to the JAX package's ``native.gaussian``."""
    size = int(np.prod(shape))
    lib = _load()
    if lib is None:
        return np.random.default_rng(seed).standard_normal(
            size).astype(np.float32).reshape(shape)
    out = np.empty(size, dtype=np.float32)
    lib.co_gaussian_fill(out.ctypes.data_as(_F), size, ctypes.c_uint64(seed),
                         nthreads or os.cpu_count() or 1)
    return out.reshape(shape)


def _f32_slab_ok(lib, As32, *vecs) -> bool:
    return (lib is not None and As32.dtype == np.float32
            and As32.flags.f_contiguous
            and all(v is None or (v.dtype == np.float64
                                  and v.flags.c_contiguous) for v in vecs))


def cd64_sweeps(As32: np.ndarray, xs: np.ndarray, r: np.ndarray,
                col_sq: np.ndarray, lam1: float, lam2: float,
                nonneg: bool, sweeps: int) -> bool:
    """``sweeps`` cyclic f64 CD sweeps over the column-major f32 slab,
    updating xs and r in place; False when the caller must run NumPy."""
    lib = _load()
    if not _f32_slab_ok(lib, As32, xs, r, col_sq):
        return False
    m, width = As32.shape
    lib.co_cd64_sweeps(As32.ctypes.data_as(_F), m, width,
                       xs.ctypes.data_as(_D), r.ctypes.data_as(_D),
                       col_sq.ctypes.data_as(_D), float(lam1), float(lam2),
                       1 if nonneg else 0, int(sweeps))
    return True


def cd64_group_sweeps(As32: np.ndarray, gsize: int, xs: np.ndarray,
                      r: np.ndarray, L: np.ndarray, w: np.ndarray,
                      lam1: float, lam2: float, sweeps: int) -> bool:
    """Group analog of cd64_sweeps: ``sweeps`` Gauss-Seidel passes over
    contiguous gsize-wide groups (per-group Lipschitz L, weights w),
    updating xs and r in place; False when the caller must run NumPy."""
    lib = _load()
    if (not _f32_slab_ok(lib, As32, xs, r, L, w)
            or As32.shape[1] % gsize != 0):
        return False
    m, width = As32.shape
    scratch = np.empty(2 * gsize, np.float64)
    lib.co_cd64_group_sweeps(As32.ctypes.data_as(_F), m, width, gsize,
                             xs.ctypes.data_as(_D), r.ctypes.data_as(_D),
                             L.ctypes.data_as(_D), w.ctypes.data_as(_D),
                             float(lam1), float(lam2), int(sweeps),
                             scratch.ctypes.data_as(_D))
    return True


def group_power_l(As32: np.ndarray, gsize: int, iters: int, safety: float,
                  lam2: float) -> np.ndarray | None:
    """Per-group block Lipschitz safety * lam_max(Ag^T Ag) + lam2 by
    ``iters`` f64 power iterations from the tilted ones start; None when
    the caller must run NumPy."""
    lib = _load()
    if not _f32_slab_ok(lib, As32) or As32.shape[1] % gsize != 0:
        return None
    m, width = As32.shape
    L = np.empty(width // gsize, np.float64)
    scratch = np.empty(gsize + m, np.float64)
    lib.co_group_power_l(As32.ctypes.data_as(_F), m, width, gsize,
                         int(iters), float(safety), float(lam2),
                         L.ctypes.data_as(_D), scratch.ctypes.data_as(_D))
    return L


def gather_cols(A: np.ndarray, idx: np.ndarray, dtype) -> np.ndarray | None:
    """F-ordered column gather (+ optional f64 cast) from an f32
    column-major matrix; None when unavailable or the layout is wrong."""
    lib = _load()
    dtype = np.dtype(dtype)
    if (lib is None or A.dtype != np.float32 or not A.flags.f_contiguous
            or dtype not in (np.float32, np.float64)):
        return None
    idx64 = np.ascontiguousarray(idx, np.int64)
    # the C gather dereferences unconditionally: bounds-check first
    if len(idx64) and (int(idx64.min()) < 0
                       or int(idx64.max()) >= A.shape[1]):
        raise IndexError(
            f"gather_cols: index out of range for {A.shape[1]} columns")
    out = np.zeros((A.shape[0], len(idx64)), dtype, order="F")
    lib.co_gather_cols(A.ctypes.data_as(_F), A.shape[0],
                       idx64.ctypes.data_as(ctypes.POINTER(_I64)),
                       len(idx64), 1 if dtype == np.float64 else 0,
                       out.ctypes.data_as(ctypes.c_void_p))
    return out


def atr_mixed(As32: np.ndarray, r: np.ndarray, lam2: float,
              xs: np.ndarray | None) -> np.ndarray | None:
    """z = -(As^T r) - lam2*xs in f64; None → NumPy path."""
    lib = _load()
    if not _f32_slab_ok(lib, As32, r, xs):
        return None
    m, width = As32.shape
    z = np.empty(width, np.float64)
    lib.co_atr_mixed(As32.ctypes.data_as(_F), m, width, r.ctypes.data_as(_D),
                     float(lam2),
                     None if xs is None else xs.ctypes.data_as(_D),
                     z.ctypes.data_as(_D))
    return z


def ax_sparse(As32: np.ndarray, xs: np.ndarray,
              b: np.ndarray) -> np.ndarray | None:
    """r = As xs - b in f64 over the nonzero columns; None → NumPy path."""
    lib = _load()
    if not _f32_slab_ok(lib, As32, xs, b):
        return None
    m, width = As32.shape
    r = np.empty(m, np.float64)
    lib.co_ax_sparse(As32.ctypes.data_as(_F), m, width, xs.ctypes.data_as(_D),
                     b.ctypes.data_as(_D), r.ctypes.data_as(_D))
    return r
