"""Datasets: VoiceBank-DEMAND-style paired dirs and Clarity-2023 scenes
(counterpart of speech_enhancement_tpu/data/dataset.py).

Host-side numpy only. Item contract (dicts, channel-first float32):

* train:  {"mixture": [C, T], "sources": [S, C, T], "mixture_meta",
           "sources_meta", "name"} — normalized + randomly cropped to
  ``sample_length`` (reference: src/dataset.py:95-170 WavDataset.__getitem__).
* eval:   {"mixture": [C, T], "sources": [S, C, T], "original_length",
           "name"} — full utterance, unnormalized (the eval pipeline
  normalizes internally; reference src/evaluate.py:18-27).

Normalization metadata mirrors the reference's per-utterance dicts
(src/dataset.py:131-161): z-score keeps (mean, std), linear-scale keeps
(min, max), both per channel.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.signal import resample_poly

from speech_enhancement_torch.data.wav_io import find_wav_files, read_wav
from speech_enhancement_torch.utils import sample_fixed_length_data_aligned

_EPS = 1e-6


def _resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return x
    g = np.gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g, axis=-1).astype(np.float32)


def normalize_with_meta(x: np.ndarray, mode: str) -> tuple:
    """Per-utterance normalization + metadata (reference: dataset.py:146-161)."""
    meta = {"min": 0.0, "max": 0.0, "mean": 0.0, "std": 0.0}
    if mode == "z-score":
        meta["mean"] = np.mean(x, axis=-1, keepdims=True)
        meta["std"] = np.std(x, axis=-1, keepdims=True, ddof=1)
        x = (x - meta["mean"]) / (meta["std"] + _EPS)
    elif mode == "linear-scale":
        meta["max"] = np.max(x, axis=-1, keepdims=True)
        meta["min"] = np.min(x, axis=-1, keepdims=True)
        x = (x - meta["min"]) / (meta["max"] - meta["min"] + _EPS)
    return x.astype(np.float32), meta


def denormalize(x: np.ndarray, meta: Dict, mode: str) -> np.ndarray:
    if mode == "z-score":
        return x * (meta["std"] + _EPS) + meta["mean"]
    if mode == "linear-scale":
        return x * (meta["max"] - meta["min"] + _EPS) + meta["min"]
    return x


class WavDataset:
    """Paired mixture/clean directories (VoiceBank-DEMAND layout).

    Reference: ``WavDataset`` (src/dataset.py:27-170). ``scenes`` selects
    indices into the sorted file list (the reference's split mechanism).
    """

    def __init__(
        self,
        mixture_dataset: str,
        clean_dataset: str,
        scenes: Optional[Sequence[int]] = None,
        sample_length: Optional[int] = None,
        normalize: str = "",
        sample_rate: int = 16000,
        audio_channels: int = 1,
        train: bool = True,
        seed: int = 0,
    ):
        if not (os.path.exists(mixture_dataset) and os.path.exists(clean_dataset)):
            raise FileNotFoundError(f"{mixture_dataset} or {clean_dataset} missing")
        mixture_files = find_wav_files(mixture_dataset)
        clean_files = find_wav_files(clean_dataset)
        if scenes is not None:
            mixture_files = [mixture_files[i] for i in scenes]
            clean_files = [clean_files[i] for i in scenes]
        if train:
            order = np.random.default_rng(seed).permutation(len(mixture_files))
            mixture_files = [mixture_files[i] for i in order]
            clean_files = [clean_files[i] for i in order]
        assert len(mixture_files) == len(clean_files), "mixture/clean count mismatch"
        self.mixture_files = mixture_files
        self.clean_files = clean_files
        self.train = train
        self.sample_length = sample_length
        self.normalize = normalize
        self.sample_rate = sample_rate
        self.audio_channels = audio_channels
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the crop RNG stream; called by the loader each epoch."""
        self._epoch = int(epoch)

    def _crop_rng(self, item: int) -> np.random.Generator:
        # Deterministic per (seed, epoch, item): random crops vary across
        # epochs but are independent of iteration order, so num_workers
        # threads and multi-host shards see identical data (a shared
        # mutable RNG would be both order-dependent and racy).
        return np.random.default_rng((self._seed + 1, self._epoch, int(item)))

    def __len__(self) -> int:
        return len(self.mixture_files)

    def __getitem__(self, item: int) -> Dict:
        name = os.path.splitext(os.path.basename(self.clean_files[item]))[0]
        mixture, sr_m = read_wav(self.mixture_files[item])
        clean, sr_c = read_wav(self.clean_files[item])
        original_length = mixture.shape[-1]
        mixture = _resample(mixture, sr_m, self.sample_rate)
        clean = _resample(clean, sr_c, self.sample_rate)
        sources = clean[None, ...]  # [S=1, C, T]

        if not self.train:
            return {
                "mixture": mixture,
                "sources": sources,
                "original_length": original_length,
                "name": name,
            }

        mixture, mixture_meta = normalize_with_meta(mixture, self.normalize)
        sources, sources_meta = normalize_with_meta(sources, self.normalize)
        if self.sample_length:
            mixture, sources = sample_fixed_length_data_aligned(
                mixture, sources, self.sample_length, self._crop_rng(item)
            )
        return {
            "mixture": mixture,
            "sources": sources,
            "mixture_meta": mixture_meta,
            "sources_meta": sources_meta,
            "name": name,
        }


class ClarityWavDataset:
    """Clarity-2023 scene dataset (reference: src/dataset.py:172-411).

    File template ``{root}/{split}/scenes/{scene}_{kind}_{ch}.wav`` with
    kinds mix/target/target_anechoic/interferer. ``type_dataset="se"`` trains
    on channels CH0..CH3 against ``target``; ``"deverb"`` trains on CH1
    against ``target_anechoic``. Sources stack [clean, interferer] for
    2-speaker separation training (reference dataset.py:350).
    """

    CHANNELS = {"se": ("CH0", "CH1", "CH2", "CH3"), "deverb": ("CH1",)}

    def __init__(
        self,
        path_dataset: str,
        scenes: Sequence[str],
        sample_length: Optional[int] = None,
        normalize: str = "",
        sample_rate: int = 16000,
        audio_channels: int = 2,
        train: bool = True,
        dev_clarity: bool = False,
        type_dataset: str = "se",
        seed: int = 0,
    ):
        if not os.path.exists(path_dataset):
            raise FileNotFoundError(path_dataset)
        target_kind = "target" if type_dataset == "se" else "target_anechoic"
        entries: List[tuple] = []
        if train and not dev_clarity:
            split = "train"
            channels = self.CHANNELS[type_dataset]
        else:
            split = "dev" if dev_clarity else "train"
            channels = ("CH1",)
        for scene in scenes:
            for ch in channels:
                base = os.path.join(path_dataset, split, "scenes", f"{scene}_")
                entries.append(
                    (base + f"mix_{ch}.wav", base + f"{target_kind}_{ch}.wav",
                     base + f"interferer_{ch}.wav")
                )
        entries.sort()
        if train and not dev_clarity:
            order = np.random.default_rng(seed).permutation(len(entries))
            entries = [entries[i] for i in order]
        self.entries = entries
        self.train = train
        self.sample_length = sample_length
        self.normalize = normalize
        self.sample_rate = sample_rate
        self.audio_channels = audio_channels
        self._seed = seed
        self._epoch = 0
        time_meta = os.path.join(path_dataset, "custom_metadata", "scenes.train.time.json")
        self.target_time = None
        if os.path.exists(time_meta):
            with open(time_meta) as handle:
                self.target_time = json.load(handle)

    set_epoch = WavDataset.set_epoch
    _crop_rng = WavDataset._crop_rng

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, item: int) -> Dict:
        mix_path, clean_path, interferer_path = self.entries[item]
        name = os.path.splitext(os.path.basename(clean_path))[0]
        mixture, sr = read_wav(mix_path)
        clean, _ = read_wav(clean_path)
        interferer, _ = read_wav(interferer_path)
        original_length = mixture.shape[-1]
        assert mixture.shape[0] == clean.shape[0], "channel mismatch in scene"

        sources = np.stack([clean, interferer], axis=0)  # [2, C, T]
        mixture = _resample(mixture, sr, self.sample_rate)
        sources = _resample(sources, sr, self.sample_rate)

        if not self.train:
            return {
                "mixture": mixture,
                "sources": sources,
                "original_length": original_length,
                "name": name,
            }

        mixture, mixture_meta = normalize_with_meta(mixture, self.normalize)
        sources, sources_meta = normalize_with_meta(sources, self.normalize)
        if self.sample_length:
            mixture, sources = sample_fixed_length_data_aligned(
                mixture, sources, self.sample_length, self._crop_rng(item)
            )
        return {
            "mixture": mixture,
            "sources": sources,
            "mixture_meta": mixture_meta,
            "sources_meta": sources_meta,
            "name": name,
        }
