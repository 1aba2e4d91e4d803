"""Per-model smoke CLI (counterpart of speech_enhancement_tpu/models/__main__.py).

    python -m speech_enhancement_torch.models <name> [--config Y] [--seconds S]
                                              [--device cuda|cpu]
    python -m speech_enhancement_torch.models --all [--device cuda|cpu]

Builds the model from its shipped config (``configs/<name>_*.yaml``, or
``--config``; registry defaults when there is none), runs one forward on a
random waveform (through ``stft_custom`` for an stft-domain model) and
prints the output shape and the parameters in MB. The device defaults to
``cuda`` and the CLI exits non-zero without a card unless ``--device cpu``
is given. ``--all`` keeps sweeping after a failure and exits 1 if any
family failed.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional


def _smoke(name: str, config_path: Optional[str], seconds: float, device: str) -> None:
    import numpy as np
    import torch

    from speech_enhancement_torch.config import Config, load_config
    from speech_enhancement_torch.models import build_model, param_count, param_megabytes
    from speech_enhancement_torch.ops.stft import stft_custom

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if config_path is None:
        slug = name.replace("-", "_")
        candidates = sorted(glob.glob(os.path.join(root, "configs", f"{slug}_*.yaml")))
        config_path = candidates[0] if candidates else None
    if config_path:
        cfg = load_config(config_path)
        model_cfg = cfg.model
        channels = int(cfg.dset.get("audio_channels", 1))
    else:
        model_cfg = Config({"name": name})
        channels = 1

    model, spec = build_model(model_cfg, device=device)
    sr = int(model_cfg.get("sample_rate", 16000))
    wav = np.random.default_rng(0).standard_normal(
        (1, channels, int(sr * seconds))).astype(np.float32) * 0.1
    inputs = torch.from_numpy(wav).to(device)
    if spec.domain == "stft":
        inputs = stft_custom(inputs, model_cfg)
    with torch.inference_mode():
        out = model(inputs)
    print(f"{name:16s} in {tuple(inputs.shape)} -> out {tuple(out.shape)}  "
          f"params {param_count(model) / 1e6:8.3f}M = {param_megabytes(model):8.3f} MB  "
          f"domain={spec.domain} monarch={spec.monarch} device={out.device}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(
        description="build a zoo model and run a random-input forward")
    parser.add_argument("name", nargs="?", help="registry name (e.g. dccrn)")
    parser.add_argument("--all", action="store_true", help="smoke every model")
    parser.add_argument("--config", default=None, help="explicit config YAML")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args()

    from speech_enhancement_torch.device import resolve_device
    from speech_enhancement_torch.models import model_names

    if not args.all and args.name is None:
        parser.error("give a model name or --all; options: " + ", ".join(model_names()))
    try:
        device = str(resolve_device(args.device))
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr, flush=True)
        return 2
    failed = []
    for name in model_names() if args.all else [args.name]:
        try:
            _smoke(name, args.config, args.seconds, device)
        except Exception as exc:  # keep sweeping on --all
            failed.append(name)
            print(f"{name:16s} FAILED: {type(exc).__name__}: {exc}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
