"""Small host-side utilities (counterpart of speech_enhancement_tpu/utils.py;
reference: src/utils.py).

All functions here operate on numpy arrays on the host; device-side helpers
live in :mod:`speech_enhancement_torch.ops`.
"""

from __future__ import annotations

import os
import random
from typing import List, Sequence, Tuple

import numpy as np


def pad_last(array: np.ndarray, target: int, value: float = 0.0) -> np.ndarray:
    """Pad the last axis of ``array`` up to length ``target``.

    Reference: ``pad_last`` (src/utils.py:12-16), used by the collate path to
    round utterances up to a multiple of the segment length.
    """
    length = array.shape[-1]
    if length >= target:
        return array
    pad = [(0, 0)] * (array.ndim - 1) + [(0, target - length)]
    return np.pad(array, pad, mode="constant", constant_values=value)


def split_list(items: Sequence, ratios: Sequence[float]) -> List[List]:
    """Split ``items`` into len(ratios) contiguous chunks by ratio.

    Reference: ``split_list`` (src/utils.py:52-61) used to carve the
    VoiceBank-DEMAND train dirs into train/val/test.
    """
    total = len(items)
    out: List[List] = []
    start = 0
    for i, ratio in enumerate(ratios):
        if i == len(ratios) - 1:
            end = total
        else:
            end = start + int(total * ratio)
        out.append(list(items[start:end]))
        start = end
    return out


def sample_fixed_length_data_aligned(
    data_a: np.ndarray,
    data_b: np.ndarray,
    sample_length: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random aligned crop of two arrays along the last axis.

    Reference: ``sample_fixed_length_data_aligned`` (src/utils.py:63-87).
    If the signals are shorter than ``sample_length`` they are zero-padded.
    """
    assert data_a.shape[-1] == data_b.shape[-1], "mixture/clean length mismatch"
    length = data_a.shape[-1]
    if length <= sample_length:
        return pad_last(data_a, sample_length), pad_last(data_b, sample_length)
    start = int(rng.integers(0, length - sample_length + 1))
    end = start + sample_length
    return data_a[..., start:end], data_b[..., start:end]


def seed_everything(seed: int) -> np.random.Generator:
    """Seed Python's, numpy's and torch's global RNGs (reference:
    src/train.py:30-32); returns a numpy Generator from the same seed.

    Model weights do not come from these: ``main`` passes ``build_model`` a
    ``torch.Generator`` seeded with the same value.
    """
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def find_folder(name: str, root: str) -> List[str]:
    """Recursively find directories named ``name`` (reference: utils.py:118-133)."""
    hits = []
    for dirpath, dirnames, _ in os.walk(root):
        for d in dirnames:
            if d == name:
                hits.append(os.path.join(dirpath, d))
    return hits


def get_filtered_snr_file(
    dset_name: str,
    path: str,
    snr_range: Tuple[float, float] = (0.0, 5.0),
) -> List[str]:
    """Filter utterances/scenes by SNR range [min, max).

    Reference: ``get_filtered_snr_file`` (src/utils.py:17-50). For
    VoiceBank-DEMAND, ``path`` is the logfiles dir ("name type SNR" lines in
    ``*trainset*`` text files); for Clarity, ``path`` is the
    scenes.train.snr.json file ({scene: snr}).
    """
    import glob
    import json

    snr_min, snr_max = snr_range
    filtered: List[str] = []
    if dset_name == "VoiceBankDEMAND":
        for text_file in glob.glob(os.path.join(path, "*trainset*")):
            with open(text_file) as handle:
                for line in handle.read().split("\n"):
                    parts = line.split(" ")
                    if len(parts) == 3:
                        name, _, snr = parts
                        if snr_min <= int(snr) < snr_max:
                            filtered.append(name)
    elif dset_name == "Clarity":
        with open(path) as handle:
            metadata = json.load(handle)
        for scene, snr in metadata.items():
            if snr_min <= float(snr) < snr_max:
                filtered.append(scene)
    else:
        raise ValueError(f"unknown dataset {dset_name!r}")
    return filtered


def human_bytes(num: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(num) < 1024.0:
            return f"{num:.3f} {unit}"
        num /= 1024.0
    return f"{num:.3f} PB"
