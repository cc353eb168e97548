"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit: 80
GB of HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores.
A card set below 700 W runs slower under load; the run prints its limit
beside every share of these peaks.
"""

from __future__ import annotations

#: (substring of torch.cuda.get_device_name(), bytes/s, f32 FLOP/s)
PEAKS = [
    ("H100", 3.35e12, 67e12),
]


def peaks(device_name: str) -> tuple[float, float] | None:
    """(HBM bytes/s, f32 FLOP/s) of the card, None for a card not listed."""
    for key, bw, flops in PEAKS:
        if key in device_name:
            return bw, flops
    return None


def bound_s(work: tuple[int, int], device_name: str) -> float | None:
    """The least time the card could take for (bytes, flops): the larger
    of the bytes at peak bandwidth and the operations at peak rate."""
    p = peaks(device_name)
    if p is None:
        return None
    nbytes, flops = work
    return max(nbytes / p[0], flops / p[1])
