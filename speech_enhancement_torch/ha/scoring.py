"""Clarity hearing-aid scoring (counterpart of
speech_enhancement_tpu/ha/scoring.py; reference src/solver.py:723-746
``compute_metric_clarity`` and the external evaluate_clarity recipe).

Loads the hearing-aid config (OmegaConf-style YAML with ``${...}``
interpolation, reference src/ha/conf/config.yaml) and the listener
audiograms (listeners.json), then per test utterance resamples to the HA
rate, amplifies with each listener's NAL-R + compressor chain and scores
HASPI / HASQI. Resampling and amplification run on the scorer's device
(CUDA unless the caller asks for the CPU) in f64, so no convolution there
takes TF32 (cuDNN's default for f32) and the card's chain matches the
CPU's to f32 rounding whatever the backend flags say; the amplified signal
is f32, as the JAX chain's. The ear model is numpy on the host, fed one
copy of each amplified signal.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import yaml

from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.ha.amplifier import NALR
from speech_enhancement_torch.ha.audio import amplify
from speech_enhancement_torch.ha.compressor import Compressor
from speech_enhancement_torch.ops.resample import resample_frac

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve(value, root: dict):
    """Minimal OmegaConf-style ``${dotted.path}`` interpolation."""
    if isinstance(value, dict):
        return {k: _resolve(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, root) for v in value]
    if isinstance(value, str):
        for _ in range(8):  # nested interpolations
            match = _INTERP.search(value)
            if not match:
                break
            node = root
            for part in match.group(1).split("."):
                node = node[part]
            value = value[: match.start()] + str(node) + value[match.end():]
        return value
    return value


def load_ha_config(path: str) -> dict:
    """Load the hearing-aid YAML (reference src/ha/conf/config.yaml surface:
    ``path.listeners_file``, ``nalr``, ``compressor``, ``soft_clip``)."""
    with open(path) as handle:
        raw = yaml.safe_load(handle)
    return _resolve(raw, raw)


class ClarityScorer:
    """Per-utterance Clarity HA amplification + HASPI/HASQI scoring.

    ``score()`` amplifies the enhanced AND the mixture signal through each
    listener's chain (dual scoring like the reference, solver.py:610-616)
    and returns ``{haspi,hasqi}_{enhance,mixture}`` means (``None`` when no
    listener scored), the last listener's amplified enhanced signal, and
    the seconds spent in the amplification chain (``amplify_s``, ending in
    the copy to the host) and in the ear model (``ear_model_s``).
    """

    def __init__(self, ha_config_path: str, input_sr: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg = load_ha_config(ha_config_path)
        nalr_cfg = cfg.get("nalr", {})
        comp_cfg = cfg.get("compressor", {})
        self.fs = int(nalr_cfg.get("fs", 44100))
        self.input_sr = int(input_sr)
        self.enhancer = NALR(nfir=int(nalr_cfg.get("nfir", 220)), fs=self.fs)
        self.compressor = Compressor(
            fs=self.fs,
            threshold=float(comp_cfg.get("threshold", 0.35)),
            attenuation=float(comp_cfg.get("attenuation", 0.1)),
            attack=float(comp_cfg.get("attack", 50)),
            release=float(comp_cfg.get("release", 1000)),
            rms_buffer_size=float(comp_cfg.get("rms_buffer_size", 0.064)),
        )
        self.soft_clip = bool(cfg.get("soft_clip", True))

        paths = cfg.get("path", {}) or {}
        listeners_file = paths.get("listeners_file", "")
        if not listeners_file or not os.path.exists(listeners_file):
            raise FileNotFoundError(
                f"ha config {ha_config_path}: path.listeners_file "
                f"{listeners_file!r} not found (Clarity listeners.json)"
            )
        with open(listeners_file, encoding="utf-8") as handle:
            self.listeners: Dict[str, dict] = json.load(handle)

        self.scene_listeners: Optional[Dict[str, List[str]]] = None
        scenes_file = paths.get("scenes_listeners_file", "")
        if scenes_file and os.path.exists(scenes_file):
            with open(scenes_file, encoding="utf-8") as handle:
                self.scene_listeners = json.load(handle)

    # ------------------------------------------------------------------
    def listeners_for_scene(self, scene: str) -> List[dict]:
        if self.scene_listeners and scene in self.scene_listeners:
            ids = self.scene_listeners[scene]
            return [self.listeners[i] for i in ids if i in self.listeners]
        return list(self.listeners.values())

    def amplify_for_listener(self, signal, listener: dict) -> torch.Tensor:
        """[C, T] at the HA rate (an array or a tensor) -> [2, T'] f32 on the
        device, through NAL-R + compressor in f64; a mono input is
        broadcast to both ears."""
        sig = torch.as_tensor(signal, device=self.device).double()
        if sig.shape[0] == 1:
            sig = sig.expand(2, sig.shape[-1])
        out = amplify(sig[None, None, :2], self.enhancer, self.compressor, listener,
                      soft_clip=self.soft_clip)
        return out[0, 0].float()

    def _resample(self, signal) -> torch.Tensor:
        """[C, T] at input_sr -> [C, T'] f64 at the HA rate, on the device."""
        sig = torch.as_tensor(signal, device=self.device).double()
        if self.input_sr == self.fs:
            return sig
        return resample_frac(sig, self.input_sr, self.fs)

    @staticmethod
    def _haspi_hasqi(reference: np.ndarray, processed: np.ndarray, fs: int,
                     listener: dict):
        """Better-ear HASPI/HASQI: the external ``clarity`` package when it
        imports (the reference's backend, src/solver.py:82-89), else the
        port's copy of the from-paper ear model in ha/earmodel.py."""
        try:
            from clarity.evaluator.haspi import haspi_v2_be  # type: ignore
            from clarity.evaluator.hasqi import hasqi_v2_be  # type: ignore
        except ImportError:
            from speech_enhancement_torch.ha.earmodel import (haspi_v1_better_ear,
                                                              hasqi_v2_better_ear)
            args = (
                reference[0], reference[-1], processed[0], processed[-1],
                fs,
                np.asarray(listener["audiogram_levels_l"], dtype=float),
                np.asarray(listener["audiogram_levels_r"], dtype=float),
                np.asarray(listener["audiogram_cfs"], dtype=float),
            )
            return haspi_v1_better_ear(*args), hasqi_v2_better_ear(*args)
        kwargs = dict(
            reference_left=reference[0], reference_right=reference[-1],
            processed_left=processed[0], processed_right=processed[-1],
            sample_rate=fs,
            audiogram_left=np.asarray(listener["audiogram_levels_l"]),
            audiogram_right=np.asarray(listener["audiogram_levels_r"]),
        )
        return float(haspi_v2_be(**kwargs)), float(hasqi_v2_be(**kwargs))

    def score(self, clean, mixture, enhanced, name: str) -> Dict[str, Optional[float]]:
        """Dual HA scoring of one utterance ([C, T] arrays at input_sr)."""
        scene = name.split("_")[0]
        t0 = time.perf_counter()
        clean_rs = self._resample(clean).float().cpu().numpy()
        mixture_rs = self._resample(mixture)
        enhanced_rs = self._resample(enhanced)
        amplify_s = time.perf_counter() - t0
        ear_model_s = 0.0
        if clean_rs.shape[0] == 1:
            clean_rs = np.broadcast_to(clean_rs, (2, clean_rs.shape[-1]))

        agg: Dict[str, list] = {
            "haspi_enhance": [], "hasqi_enhance": [],
            "haspi_mixture": [], "hasqi_mixture": [],
        }
        amplified = None
        for listener in self.listeners_for_scene(scene):
            t0 = time.perf_counter()
            amp_enh = self.amplify_for_listener(enhanced_rs, listener).cpu().numpy()
            amp_mix = self.amplify_for_listener(mixture_rs, listener).cpu().numpy()
            t1 = time.perf_counter()
            amplified = amp_enh
            h_e, q_e = self._haspi_hasqi(clean_rs, amp_enh, self.fs, listener)
            h_m, q_m = self._haspi_hasqi(clean_rs, amp_mix, self.fs, listener)
            amplify_s += t1 - t0
            ear_model_s += time.perf_counter() - t1
            if h_e is not None:
                agg["haspi_enhance"].append(h_e)
                agg["hasqi_enhance"].append(q_e)
                agg["haspi_mixture"].append(h_m)
                agg["hasqi_mixture"].append(q_m)

        scores: Dict[str, Optional[float]] = {
            key: (float(np.mean(vals)) if vals else None)
            for key, vals in agg.items()
        }
        scores["amplified"] = amplified  # type: ignore[assignment]
        scores["amplify_s"] = amplify_s
        scores["ear_model_s"] = ear_model_s
        return scores
