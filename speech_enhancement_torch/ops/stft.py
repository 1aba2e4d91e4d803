"""STFT / iSTFT front end (counterpart of speech_enhancement_tpu/ops/stft.py).

The reference's transform contract:

* forward: periodic Hann window of ``win_length`` zero-padded centred to
  ``n_fft``, ``center=True`` reflect padding, one-sided transform, and the
  reference's extra ``1 / win_length`` scaling in ``stft_custom``;
* inverse: windowed overlap-add divided by the squared-window envelope
  (where it is above 1e-11), centre-trimmed, ``* win_length`` in
  ``istft_custom``.

Three forward methods, as in the JAX package: ``"fft"`` (``torch.fft.rfft``;
XLA's FFT in JAX), ``"matmul"`` (framed matmul against the rFFT basis) and
``"pallas"``, which goes through the port's STFT kernel wrapper
(``kernels/stft.py:stft_kernel``) with the window folded into the basis, so
the frame tensor is never stored; it needs ``hop_length`` to divide
``n_fft`` on the card. The inverse takes ``"fft"`` or ``"matmul"``.
``torch.stft`` / ``torch.istft`` are not used.

Shapes at the model boundary: ``stft_custom`` [B, C, T] -> [B, C, F, T',
2] (or [B, S, C, T] -> [B, S, C, F, T', 2]); ``istft_custom`` inverts it,
trimmed to ``length``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from speech_enhancement_torch.kernels.stft import stft_kernel
from speech_enhancement_torch.ops.frame import frame_signal, overlap_add


def _hann_np(win_length: int, n_fft: Optional[int] = None) -> np.ndarray:
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if n_fft is not None and n_fft != win_length:
        left = (n_fft - win_length) // 2
        w = np.pad(w, (left, n_fft - win_length - left))
    return w


def hann_window(win_length: int, n_fft: Optional[int] = None,
                dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, zero-padded centred to ``n_fft`` (torch.stft rule)."""
    return torch.as_tensor(_hann_np(win_length, n_fft), dtype=dtype, device=device)


@lru_cache(maxsize=16)
def _rfft_basis(n_fft: int):
    """Real / imaginary rFFT basis, [n_fft, F] each, F = n_fft // 2 + 1."""
    k = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@lru_cache(maxsize=16)
def _irfft_basis(n_fft: int):
    """Inverse basis: x[k] = Xr @ Br[k] + Xi @ Bi[k]; [F, n_fft] each."""
    n_freq = n_fft // 2 + 1
    f = np.arange(n_freq)[:, None]
    k = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * f * k / n_fft
    weight = np.full((n_freq, 1), 2.0 / n_fft)
    weight[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        weight[-1] = 1.0 / n_fft
    return (np.cos(ang) * weight).astype(np.float32), (-np.sin(ang) * weight).astype(np.float32)


@lru_cache(maxsize=16)
def _window_basis(n_fft: int, win_length: int) -> np.ndarray:
    """[n_fft, 2F]: the rFFT basis [real | imag] times the window, for the kernel."""
    br, bi = _rfft_basis(n_fft)
    window = _hann_np(win_length, n_fft).astype(np.float32)
    return np.concatenate([br, bi], axis=1) * window[:, None]


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
         center: bool = True, pad_mode: str = "reflect", method: str = "fft") -> torch.Tensor:
    """STFT of ``x`` [..., T] -> complex64 [..., F, n_frames] (torch.stft layout)."""
    win_length = win_length or n_fft
    x = x.float()
    n_freq = n_fft // 2 + 1
    if method == "pallas":
        if center:
            pad = n_fft // 2
            lead = x.shape[:-1]
            x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
            x = x.reshape(*lead, x.shape[-1])
        basis = torch.from_numpy(_window_basis(n_fft, win_length)).to(x.device)
        lead = x.shape[:-1]
        out = stft_kernel(x.reshape(-1, x.shape[-1]).contiguous(), basis, hop_length, n_fft)
        spec = torch.complex(out[..., :n_freq], out[..., n_freq:])
        return spec.reshape(*lead, *spec.shape[1:]).transpose(-1, -2)
    if method not in ("fft", "matmul"):
        raise ValueError(f"unknown stft method {method!r}")
    window = hann_window(win_length, n_fft, device=x.device)
    frames = frame_signal(x, n_fft, hop_length, center=center, pad_mode=pad_mode) * window
    if method == "matmul":
        br, bi = (torch.from_numpy(b).to(x.device) for b in _rfft_basis(n_fft))
        spec = torch.complex(torch.matmul(frames, br), torch.matmul(frames, bi))
    else:
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)  # [..., n_frames, F] -> [..., F, n_frames]


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: Optional[int] = None,
          length: Optional[int] = None, center: bool = True, method: str = "fft") -> torch.Tensor:
    """Inverse STFT of complex [..., F, n_frames] -> [..., T] (torch.istft rule)."""
    win_length = win_length or n_fft
    window = hann_window(win_length, n_fft, device=spec.device)
    spec = spec.transpose(-1, -2)  # [..., n_frames, F]
    if method == "matmul":
        br, bi = (torch.from_numpy(b).to(spec.device) for b in _irfft_basis(n_fft))
        frames = torch.matmul(spec.real, br) + torch.matmul(spec.imag, bi)
    elif method == "fft":
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        raise ValueError(f"unknown istft method {method!r}")
    frames = frames * window
    n_frames = frames.shape[-2]
    signal = overlap_add(frames, hop_length)
    envelope = overlap_add((window * window).expand(n_frames, n_fft), hop_length)
    signal = signal / torch.where(envelope > 1e-11, envelope, torch.ones_like(envelope))
    if center:
        pad = n_fft // 2
        signal = signal[..., pad:]
        if length is not None:
            signal = signal[..., :length]
        else:
            signal = signal[..., : signal.shape[-1] - pad]
    elif length is not None:
        signal = signal[..., :length]
    return signal


def _center(model_config) -> bool:
    return bool(model_config.get("center", True) if hasattr(model_config, "get") else True)


def stft_custom(x: torch.Tensor, model_config) -> torch.Tensor:
    """The reference's model-boundary STFT: [B, C, T] or [B, S, C, T] ->
    [..., F, T', 2] (real, imaginary last), scaled by 1 / win_length."""
    spec = stft(x, n_fft=int(model_config.n_fft), hop_length=int(model_config.hop_length),
                win_length=int(model_config.win_length), center=_center(model_config))
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out / int(model_config.win_length)


def istft_custom(spec_ri: torch.Tensor, length: int, model_config) -> torch.Tensor:
    """The reference's model-boundary iSTFT: [..., F, T', 2] -> [..., length],
    multiplying the 1 / win_length back."""
    spec_ri = spec_ri * int(model_config.win_length)
    spec = torch.complex(spec_ri[..., 0].float(), spec_ri[..., 1].float())
    return istft(spec, n_fft=int(model_config.n_fft), hop_length=int(model_config.hop_length),
                 win_length=int(model_config.win_length), length=int(length),
                 center=_center(model_config))
