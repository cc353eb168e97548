"""Device and precision policy of the PyTorch port.

Counterpart of the backend set-up in ``convex_optimization_tpu/__init__.py``
and of the JAX package's rule against reduced-precision dots
(``convex_optimization_tpu/ops/bcd_sweep_pallas.py``, "Precision"): a
float32 matrix product that silently runs in TF32 keeps about three decimal
digits, which floors every solve far above the 1e-6 certificate.
"""

from __future__ import annotations

import torch


def set_precision_flags() -> None:
    """Full float32 for every matmul and convolution (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def require_cuda() -> torch.device:
    """The first CUDA device; raises when no card is present.  The port
    never falls back to the CPU on its own: a CPU run is asked for by
    putting the problem's tensors on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU): the
    solvers' walls are taken between two of these."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
