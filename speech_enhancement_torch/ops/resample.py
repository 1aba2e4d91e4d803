"""Polyphase windowed-sinc resampling (counterpart of
speech_enhancement_tpu/ops/resample.py; the ``julius`` algorithm).

A Hann-windowed sinc low-pass evaluated at ``new_sr`` fractional phases is
applied as one strided ``conv1d`` with the phase bank as output channels,
and the phases are then interleaved. Demucs's internal 2x up- and
down-sampling (``upsample2`` / ``downsample2``, 56 zero crossings) run
through it. The bank is built in numpy and cached; the port keeps its own
copy of the JAX module's ``_kernel_bank``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _kernel_bank(old_sr: int, new_sr: int, zeros: int, rolloff: float):
    """Phase bank [new_sr, 1, K] for gcd-reduced rates; returns (bank, half_width)."""
    # cutoff in cycles per input sample
    fc = 0.5 * rolloff * min(1.0, new_sr / old_sr)
    half_width = int(math.ceil(zeros / (2.0 * fc)))
    k = np.arange(-half_width, half_width + 1, dtype=np.float64)
    phases = np.arange(new_sr, dtype=np.float64) * old_sr / new_sr  # fractional centres
    t = phases[:, None] - k[None, :]  # h(offset_p - d)
    window = np.cos(np.pi * t * fc / zeros / 2.0) ** 2  # Hann over +-zeros / (2 fc)
    window = np.where(np.abs(t) <= half_width + 1e-9, window, 0.0)
    kernel = 2.0 * fc * np.sinc(2.0 * fc * t) * window
    return kernel[:, None, :].astype(np.float32), half_width


def resample_frac(x: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24,
                  rolloff: float = 0.945, output_length: Optional[int] = None) -> torch.Tensor:
    """Resample [..., T] from ``old_sr`` to ``new_sr`` (julius.resample_frac's
    API): f32 inside (f64 for an f64 ``x``), the result in x's dtype,
    ``ceil(new_sr T / old_sr)`` samples unless ``output_length`` says
    otherwise."""
    gcd = math.gcd(old_sr, new_sr)
    old, new = old_sr // gcd, new_sr // gcd
    length = x.shape[-1]
    target = int(math.ceil(new_sr * length / old_sr)) if output_length is None else output_length
    if old == new:
        return x
    bank, half_width = _kernel_bank(old, new, zeros, rolloff)
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, length).to(torch.promote_types(x.dtype, torch.float32))
    flat = F.pad(flat, (half_width, half_width + old))
    out = F.conv1d(flat, torch.from_numpy(bank).to(flat), stride=old)  # [N, new, Q]
    out = out.transpose(1, 2).reshape(flat.shape[0], -1)[:, :target]  # interleave phases
    return out.reshape(*lead, target).to(x.dtype)


def upsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """2x upsample (Demucs's ``julius.resample_frac(x, 1, 2)``)."""
    return resample_frac(x, 1, 2, zeros=zeros)


def downsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """2x downsample (Demucs's ``julius.resample_frac(x, 2, 1)``)."""
    return resample_frac(x, 2, 1, zeros=zeros)
