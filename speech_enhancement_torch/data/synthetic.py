"""Synthetic dataset fixtures: tone+noise wav trees for hermetic tests/demos
(counterpart of speech_enhancement_tpu/data/synthetic.py; for the same
arguments both write byte-identical files).

The reference has no hermetic test data — its tests require real
VoiceBank-DEMAND / Clarity trees on disk (SURVEY §4). These builders create
miniature datasets with the same directory layouts so every pipeline test
runs anywhere.
"""

from __future__ import annotations

import json
import os

import numpy as np

from speech_enhancement_torch.data.wav_io import write_wav


def _speech_like(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    f0 = rng.uniform(120, 300)
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t))
    sig = np.zeros(n)
    for harmonic in (1, 2, 3):
        sig += rng.uniform(0.2, 1.0) / harmonic * np.sin(2 * np.pi * f0 * harmonic * t)
    return (0.3 * env * sig).astype(np.float32)


def make_voicebank_demand(
    root: str,
    n_utterances: int = 8,
    sr: int = 16000,
    min_seconds: float = 1.0,
    max_seconds: float = 3.0,
    channels: int = 1,
    seed: int = 0,
) -> str:
    """Create {root}/{noisy_trainset_wav,clean_trainset_wav}/p000_XXX.wav pairs."""
    rng = np.random.default_rng(seed)
    noisy_dir = os.path.join(root, "noisy_trainset_wav")
    clean_dir = os.path.join(root, "clean_trainset_wav")
    os.makedirs(noisy_dir, exist_ok=True)
    os.makedirs(clean_dir, exist_ok=True)
    for i in range(n_utterances):
        n = int(sr * rng.uniform(min_seconds, max_seconds))
        clean = np.stack([_speech_like(rng, n, sr) for _ in range(channels)])
        noise = 0.1 * rng.standard_normal((channels, n)).astype(np.float32)
        name = f"p000_{i:03d}.wav"
        write_wav(os.path.join(clean_dir, name), clean, sr)
        write_wav(os.path.join(noisy_dir, name), clean + noise, sr)
    return root


def make_clarity(
    root: str,
    n_scenes: int = 4,
    sr: int = 16000,
    seconds: float = 2.0,
    seed: int = 0,
) -> str:
    """Create a miniature Clarity train tree with CH0..CH3 + metadata JSON."""
    rng = np.random.default_rng(seed)
    scene_dir = os.path.join(root, "train", "scenes")
    dev_dir = os.path.join(root, "dev", "scenes")
    meta_dir = os.path.join(root, "custom_metadata")
    os.makedirs(scene_dir, exist_ok=True)
    os.makedirs(dev_dir, exist_ok=True)
    os.makedirs(meta_dir, exist_ok=True)
    scenes = [f"S{i:05d}" for i in range(1, n_scenes + 1)]
    n = int(sr * seconds)
    times = {}
    for scene in scenes:
        target = np.stack([_speech_like(rng, n, sr) for _ in range(2)])
        interferer = 0.2 * np.stack(
            [_speech_like(rng, n, sr) for _ in range(2)]
        ) + 0.05 * rng.standard_normal((2, n)).astype(np.float32)
        interferer = interferer.astype(np.float32)
        for ch in ("CH0", "CH1", "CH2", "CH3"):
            write_wav(os.path.join(scene_dir, f"{scene}_target_{ch}.wav"), target, sr)
            write_wav(
                os.path.join(scene_dir, f"{scene}_target_anechoic_{ch}.wav"), target, sr
            )
            write_wav(
                os.path.join(scene_dir, f"{scene}_interferer_{ch}.wav"), interferer, sr
            )
            write_wav(
                os.path.join(scene_dir, f"{scene}_mix_{ch}.wav"), target + interferer, sr
            )
        times[scene] = [0, n]
        # dev split mirrors CH1 files only (the eval path, dataset.py:280-292)
        for kind in ("target", "target_anechoic", "interferer", "mix"):
            src = os.path.join(scene_dir, f"{scene}_{kind}_CH1.wav")
            dst = os.path.join(dev_dir, f"{scene}_{kind}_CH1.wav")
            with open(src, "rb") as fin, open(dst, "wb") as fout:
                fout.write(fin.read())
    with open(os.path.join(meta_dir, "scenes.train.json"), "w") as handle:
        json.dump(scenes, handle)
    with open(os.path.join(meta_dir, "scenes.dev.json"), "w") as handle:
        json.dump(scenes, handle)
    with open(os.path.join(meta_dir, "scenes.train.time.json"), "w") as handle:
        json.dump(times, handle)
    return root


def make_ha_config(
    root: str,
    scenes=None,
    n_listeners: int = 2,
    fs: int = 44100,
    seed: int = 0,
) -> str:
    """Write a miniature Clarity hearing-aid config tree and return the
    ha.yaml path (the ``config.ha`` surface: reference src/ha/conf/config.yaml
    + clarity_data/metadata/listeners.json + scenes_listeners.json)."""
    rng = np.random.default_rng(seed)
    meta_dir = os.path.join(root, "metadata")
    os.makedirs(meta_dir, exist_ok=True)

    cfs = [250, 500, 1000, 2000, 3000, 4000, 6000, 8000]
    listeners = {}
    for i in range(1, n_listeners + 1):
        # mild-to-moderate sloping losses, the typical Clarity shape
        base = rng.uniform(15, 40)
        slope = rng.uniform(2, 8)
        levels = [round(float(base + slope * j + rng.uniform(-5, 5)), 1)
                  for j in range(len(cfs))]
        listeners[f"L{i:04d}"] = {
            "name": f"L{i:04d}",
            "audiogram_cfs": cfs,
            "audiogram_levels_l": levels,
            "audiogram_levels_r": [round(v + 2.0, 1) for v in levels],
        }
    listeners_file = os.path.join(meta_dir, "listeners.json")
    with open(listeners_file, "w") as handle:
        json.dump(listeners, handle)

    scenes_file = os.path.join(meta_dir, "scenes_listeners.json")
    ids = list(listeners)
    scene_map = {s: [ids[i % len(ids)]] for i, s in enumerate(scenes or [])}
    with open(scenes_file, "w") as handle:
        json.dump(scene_map, handle)

    ha_yaml = os.path.join(root, "ha.yaml")
    with open(ha_yaml, "w") as handle:
        handle.write(
            f"""path:
  root: '{root}'
  metadata_dir: ${{path.root}}/metadata
  listeners_file: ${{path.metadata_dir}}/listeners.json
  scenes_listeners_file: ${{path.metadata_dir}}/scenes_listeners.json

nalr:
  nfir: 220
  fs: {fs}

compressor:
  threshold: 0.35
  attenuation: 0.1
  attack: 50
  release: 1000
  rms_buffer_size: 0.064

soft_clip: True
"""
        )
    return ha_yaml
