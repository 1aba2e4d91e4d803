"""Dynamic-range compressor (counterpart of
speech_enhancement_tpu/ha/compressor.py; reference src/ha/compressor.py,
Clarity MSBG).

Per-sample pipeline: sliding RMS over a rectangular window of
``rms_buffer_size`` seconds (f64 running sums), then an attack/release-smoothed compression
gain multiplied into the signal. The smoother

    c_t = a_t * c_{t-1} + b_t,   c_{-1} = 1,
    (a_t, b_t) = (1 - attack,  attack * g(rms_t))   if rms_t > threshold
                 (1 - release, release)             otherwise

is a first-order linear recurrence whose coefficients depend on rms_t
alone. The reference walks it in a Python loop per sample; JAX evaluates it
with ``lax.associative_scan``; here it is :func:`linear_scan`, a doubling
scan batched over every row on the signal's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c_t = a_t c_{t-1} + b_t along the last axis from c_{-1} = 0.

    A Hillis-Steele doubling scan: each element carries the affine map
    (A, B) of its window, and pass k composes it with the element 2^k
    before, ``(A, B) <- (A * A_prev, A * B_prev + B)``, so ceil(log2 T)
    passes cover the sequence (19 at 10 s of 44.1 kHz). Products of A that
    underflow to zero belong to maps whose weight on the far past is below
    f32's resolution anyway.
    """
    steps = a.shape[-1]
    shift = 1
    while shift < steps:
        b = torch.cat([b[..., :shift], a[..., shift:] * b[..., :-shift] + b[..., shift:]], -1)
        a = torch.cat([a[..., :shift], a[..., shift:] * a[..., :-shift]], -1)
        shift *= 2
    return b


class Compressor:
    def __init__(
        self,
        fs: int = 44100,
        attack: float = 5.0,
        release: float = 20.0,
        threshold: float = 1.0,
        attenuation: float = 0.0001,
        rms_buffer_size: float = 0.2,
        makeup_gain: float = 1.0,
    ):
        self.fs = fs
        self.attack = (1000.0 / attack) / fs  # reciprocal ms -> per-sample coeff
        self.release = (1000.0 / release) / fs
        self.threshold = threshold
        self.attenuation = attenuation
        self.win_len = int(rms_buffer_size * fs)
        self.makeup_gain = makeup_gain
        self.eps = 1e-8

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        """[..., T] -> [..., T], compressed on the signal's device."""
        lead = signal.shape[:-1]
        length = signal.shape[-1]
        flat = signal.reshape(-1, length)
        # sliding mean square over win_len samples, with a (win_len - 1)
        # left zero pad (compressor.py:85-91), as a difference of f64
        # running sums: exact to 1e-14 on every device, where an f32 box
        # conv sums in a device-dependent order whose rounding can tip an
        # RMS sample across the threshold (and costs 150x more on the CPU)
        sq = F.pad(flat.double() ** 2, (self.win_len, 0))
        total = torch.cumsum(sq, dim=-1)
        mean_sq = (total[:, self.win_len:] - total[:, :-self.win_len]) / self.win_len
        rms = torch.sqrt(mean_sq + self.eps).to(signal.dtype)  # [N, T]

        over = rms > self.threshold
        temp_comp = rms * self.attenuation + (1.0 - self.attenuation) * self.threshold
        coeff_a = torch.where(over, 1.0 - self.attack, 1.0 - self.release).to(signal.dtype)
        coeff_b = torch.where(over, temp_comp * self.attack,
                              torch.full_like(rms, self.release))
        # c_{-1} = 1: fold the initial condition into the first element
        coeff_b = torch.cat([coeff_b[:, :1] + coeff_a[:, :1], coeff_b[:, 1:]], -1)
        comp = linear_scan(coeff_a, coeff_b)
        return (flat * comp).reshape(*lead, length)

    process = __call__  # reference API name (compressor.py:73)
