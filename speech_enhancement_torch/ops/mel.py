"""Mel filterbanks (counterpart of speech_enhancement_tpu/ops/mel.py, in numpy).

The reference uses torchaudio's ``MelScale`` / ``InverseMelScale`` (HTK
scale). Here the filterbank is a precomputed [F, n_mels] matrix, one
matmul either way; the inverse is the least-squares pseudo-inverse, whose
reconstructed spectrum the caller clamps at >= 0. Both are cached.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] (torchaudio's "htk" scale), f32."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [F, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@lru_cache(maxsize=16)
def inverse_mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                           f_max: Optional[float] = None) -> np.ndarray:
    """Least-squares inverse [n_mels, n_freqs] (pinv in f64, returned f32).

    ``mel @ inverse`` projects back onto the filterbank's column space;
    callers clamp the reconstructed spectrum, not the matrix.
    """
    fb = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
    return np.linalg.pinv(fb.astype(np.float64)).astype(np.float32)
