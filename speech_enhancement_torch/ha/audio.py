"""Hearing-aid amplification chain + channel conversion (counterpart of
speech_enhancement_tpu/ha/audio.py; reference src/audio.py).

``amplify``: per-ear NAL-R FIR from the listener's audiogram -> FIR apply
-> dynamic-range compression -> optional tanh soft clip -> stereo stack
(reference amplify_torch, audio.py:33-61), on the signal's device.

The reference overwrites the right-ear FIR with the left's (audio.py:49);
the default uses the right ear's own filter, and ``stereo_bug_compat=True``
replicates the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from speech_enhancement_torch.ha.amplifier import NALR
from speech_enhancement_torch.ha.compressor import Compressor


def convert_audio_channels(wav: torch.Tensor, channels: int = 2) -> torch.Tensor:
    """Up/down-mix [..., C, T] to ``channels`` (reference audio.py:6-31)."""
    *shape, src_channels, length = wav.shape
    if src_channels == channels:
        return wav
    if channels == 1:
        return wav.mean(dim=-2, keepdim=True)
    if src_channels == 1:
        return wav.expand(*shape, channels, length)
    if src_channels >= channels:
        return wav[..., :channels, :]
    raise ValueError("audio has fewer channels than requested but is not mono")


def amplify(
    signal: torch.Tensor,
    enhancer: NALR,
    compressor: Compressor,
    audiogram: dict,
    soft_clip: bool = True,
    stereo_bug_compat: bool = False,
) -> torch.Tensor:
    """Apply the hearing-aid chain to [B, S, 2, T] -> [B, S, 2, T'].

    audiogram: {"audiogram_cfs": [...], "audiogram_levels_l": [...],
    "audiogram_levels_r": [...]} (Clarity listeners.json entry).
    """
    cfs = np.asarray(audiogram["audiogram_cfs"], float)
    fir_left = enhancer.build(audiogram["audiogram_levels_l"], cfs)
    if stereo_bug_compat:
        fir_right = fir_left  # reference bug: right FIR = left's (audio.py:49)
    else:
        fir_right = enhancer.build(audiogram["audiogram_levels_r"], cfs)

    out_l = compressor(NALR.apply(fir_left, signal[:, :, 0, :]))
    out_r = compressor(NALR.apply(fir_right, signal[:, :, 1, :]))
    if soft_clip:
        out_l = torch.tanh(out_l)
        out_r = torch.tanh(out_r)
    return torch.stack([out_l, out_r], dim=2)
