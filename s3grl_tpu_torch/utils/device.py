"""The one place that turns a device argument into a ``torch.device``, and
the cards' published peak rates that a kernel's bound divides by.

Entry points default to ``"cuda"``. Asking for CUDA where there is none is
an error: a run never quietly continues on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` (``"cuda"`` becomes the current card,
    ``cuda:N``); raises RuntimeError if CUDA is asked for and not available.

    Also turns TF32 off for float32 matmuls and convolutions: the JAX
    package computes in float32 at ``Precision.HIGHEST``, and TF32 keeps
    about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        # Name the card, so that the device compares equal to a tensor's.
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclass(frozen=True)
class Work:
    """What one kernel call must do for its data: the bytes it must move
    (each input read once, each output written once) and its floating-point
    operations (a multiply-add is two)."""

    n_bytes: float
    flops: float


@dataclass(frozen=True)
class PeakRates:
    """A card's published peak rates: device memory in bytes/s and float32
    outside the tensor cores in FLOP/s (the kernels compute in f32 FMA)."""

    hbm_bytes_per_s: float
    fp32_flop_per_s: float


# By the name torch.cuda.get_device_name gives. NVIDIA's data sheets, SXM
# parts, dense rates; they assume the card's full power limit (700 W).
PEAK_RATES = {
    "NVIDIA H100 80GB HBM3": PeakRates(hbm_bytes_per_s=3.35e12, fp32_flop_per_s=67e12),
}


def peak_rates(name: str) -> Optional[PeakRates]:
    """The peak rates of the card called ``name``; None for a card not in
    :data:`PEAK_RATES` (its shares are then unknown, not guessed)."""
    return PEAK_RATES.get(name)


def bound_ms(work: Work, rates: Optional[PeakRates]) -> tuple[Optional[float], Optional[str]]:
    """(the least milliseconds the card could take for ``work``, "bytes" or
    "operations": which of the two times is larger); (None, None) where the
    card's rates are unknown."""
    if rates is None:
        return None, None
    t_bytes = work.n_bytes / rates.hbm_bytes_per_s
    t_ops = work.flops / rates.fp32_flop_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
