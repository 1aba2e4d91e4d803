"""Native numpy STOI (Short-Time Objective Intelligibility, Taal et al. 2011;
counterpart of speech_enhancement_tpu/train/stoi.py).

The reference scores STOI through the ``pystoi`` package
(src/metric.py:126-144); that package is not available in this image, so the
algorithm is implemented here from the paper:

  C. H. Taal, R. C. Hendriks, R. Heusdens, J. Jensen, "An Algorithm for
  Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
  IEEE TASLP 2011.

Pipeline: resample to 10 kHz -> remove silent frames (40 dB dynamic range)
-> 256/512 Hann STFT -> 15 one-third-octave bands from 150 Hz -> 30-frame
segments -> normalized+clipped correlation, averaged. ``extended=True``
implements the ESTOI variant (Jensen & Taal 2016).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS = 10000  # internal sample rate
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30  # segment length in frames
BETA = -15.0  # lower SDR clip (dB)
DYN_RANGE = 40


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands).astype(float)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    hi = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        l_idx = np.argmin((f - lo[i]) ** 2)
        h_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, l_idx:h_idx] = 1.0
    return obm, cf


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    n_frames = (len(x) - frame_len) // hop + 1
    if n_frames < 1:
        return x, y
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    x_frames = x[idx] * w
    y_frames = y[idx] * w
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    n_kept = x_frames.shape[0]
    out_len = (n_kept - 1) * hop + frame_len if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):
        sl = slice(i * hop, i * hop + frame_len)
        x_out[sl] += x_frames[i]
        y_out[sl] += y_frames[i]
    return x_out, y_out


def _stft_mag(x, frame_len, hop, nfft):
    w = np.hanning(frame_len + 2)[1:-1]
    n_frames = (len(x) - frame_len) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    frames = x[idx] * w
    return np.fft.rfft(frames, n=nfft, axis=1)


def stoi(clean: np.ndarray, denoised: np.ndarray, fs_sig: int, extended: bool = False) -> float:
    """STOI score in [~0, 1]. Inputs are 1-D waveforms at ``fs_sig`` Hz."""
    if clean.shape != denoised.shape:
        raise ValueError("clean/denoised length mismatch")
    x = np.asarray(clean, dtype=np.float64)
    y = np.asarray(denoised, dtype=np.float64)
    if fs_sig != FS:
        x = resample_poly(x, FS, fs_sig)
        y = resample_poly(y, FS, fs_sig)

    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)
    if len(x) < N_FRAME + (N - 1) * (N_FRAME // 2):
        return 1e-5  # not enough active speech

    obm, _ = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    x_spec = _stft_mag(x, N_FRAME, N_FRAME // 2, NFFT).T  # [F, T]
    y_spec = _stft_mag(y, N_FRAME, N_FRAME // 2, NFFT).T
    x_toct = np.sqrt(obm @ (np.abs(x_spec) ** 2))  # [15, T]
    y_toct = np.sqrt(obm @ (np.abs(y_spec) ** 2))

    n_frames = x_toct.shape[1]
    if n_frames < N:
        return 1e-5

    if extended:
        corrs = []
        for m in range(N, n_frames + 1):
            xs = x_toct[:, m - N : m]
            ys = y_toct[:, m - N : m]
            xs = xs - xs.mean(axis=1, keepdims=True)
            ys = ys - ys.mean(axis=1, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=1, keepdims=True) + 1e-12)
            ys = ys / (np.linalg.norm(ys, axis=1, keepdims=True) + 1e-12)
            xs = xs - xs.mean(axis=0, keepdims=True)
            ys = ys - ys.mean(axis=0, keepdims=True)
            xs = xs / (np.linalg.norm(xs, axis=0, keepdims=True) + 1e-12)
            ys = ys / (np.linalg.norm(ys, axis=0, keepdims=True) + 1e-12)
            corrs.append(np.sum(xs * ys) / NUMBAND)
        return float(np.mean(corrs))

    clip = 10 ** (-BETA / 20.0)
    d_sum = 0.0
    count = 0
    for m in range(N, n_frames + 1):
        xs = x_toct[:, m - N : m]  # [15, N]
        ys = y_toct[:, m - N : m]
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + 1e-12
        )
        ys_norm = ys * alpha
        ys_clip = np.minimum(ys_norm, xs * (1 + clip))
        xm = xs - xs.mean(axis=1, keepdims=True)
        ym = ys_clip - ys_clip.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        d_sum += np.sum(num / den)
        count += NUMBAND
    return float(d_sum / count)
