"""NAL-R linear hearing-aid amplifier (counterpart of
speech_enhancement_tpu/ha/amplifier.py; reference src/ha/amplifier.py).

The NAL-R prescription maps an audiogram (hearing thresholds at standard
audiometric frequencies) to per-frequency insertion gains, realised as a
linear-phase FIR. Filter design is host numpy/scipy, once per listener
(``interp1d`` and ``firwin2``, as in JAX); filter application is a
full-padding ``conv1d`` on the signal's own device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.interpolate import interp1d
from scipy.signal import firwin2

AUDIOMETRIC_FREQS = np.array([250.0, 500.0, 1000.0, 2000.0, 4000.0, 6000.0])


class NALR:
    """NAL-R FIR designer + applier.

    nfir: filter order (taps = nfir + 1); fs: sample rate in Hz.
    """

    def __init__(self, nfir: int, fs: int):
        self.nfir = nfir
        self.fs = fs
        self.fmax = 0.5 * fs
        delay = np.zeros(nfir + 1, np.float32)
        delay[nfir // 2] = 1.0
        self.delay = delay

    def nalr_gains_db(self, hl: np.ndarray, cfs: np.ndarray | None = None) -> np.ndarray:
        """NAL-R gain rule at the audiometric frequencies (amplifier.py:174-189).

        hl: hearing levels (dB) at ``cfs`` (default [250..6000] with 3 kHz).
        """
        if cfs is None:
            cfs = np.array([250, 500, 1000, 2000, 3000, 6000], dtype=float)
        hl_at_aud = interp1d(np.asarray(cfs, float), np.asarray(hl, float))(
            AUDIOMETRIC_FREQS
        )
        bias = np.array([-17.0, -8.0, 1.0, -1.0, -2.0, -2.0])
        t3 = hl_at_aud[1] + hl_at_aud[2] + hl_at_aud[3]  # 500 + 1k + 2k
        xave = 0.05 * t3 if t3 <= 180 else 9.0 + 0.116 * (t3 - 180)
        return np.clip(xave + 0.31 * hl_at_aud + bias, 0.0, None)

    def build(self, hl: np.ndarray, cfs: np.ndarray | None = None) -> np.ndarray:
        """Design the NAL-R FIR for an audiogram -> float32 [nfir + 1]."""
        gains_db = self.nalr_gains_db(hl, cfs)
        if np.max(np.asarray(hl, float)) <= 0:
            return self.delay.copy()
        # Interpolate the gain curve onto a uniform frequency grid 0..nyquist.
        freqs = np.concatenate(([0.0], AUDIOMETRIC_FREQS, [self.fmax]))
        gains = np.concatenate(([gains_db[0]], gains_db, [gains_db[-1]]))
        grid = np.linspace(0.0, 1.0, self.nfir + 1)
        grid_gain_db = interp1d(freqs / self.fmax, gains)(grid)
        taps = firwin2(self.nfir + 1, grid, 10.0 ** (grid_gain_db / 20.0))
        return taps.astype(np.float32)

    @staticmethod
    def apply(fir, wav: torch.Tensor) -> torch.Tensor:
        """Full-padding FIR convolution: [..., T] -> [..., T + taps - 1].

        ``fir`` (numpy or tensor, [taps]) is moved to ``wav``'s device and
        dtype. Correlation with the reversed taps is the true convolution,
        as torch.conv1d(wav, fir_reversed, padding=taps-1) in the reference
        (amplifier.py:204-216).
        """
        fir = torch.as_tensor(fir, dtype=wav.dtype, device=wav.device)
        taps = fir.shape[-1]
        lead = wav.shape[:-1]
        flat = wav.reshape(-1, 1, wav.shape[-1])
        out = F.conv1d(flat, fir.flip(-1).reshape(1, 1, taps), padding=taps - 1)
        return out.reshape(*lead, -1)
