"""Enhance one WAV with a trained run of the port, and optionally score it.

    python -m speech_enhancement_torch.tools.inference --run-dir result/dccrn/<stamp> \\
        --wav noisy.wav --out enhanced.wav [--clean clean.wav] [--device cpu]

Reads the run's ``config.yaml``, builds its model and loads the weights and
running statistics of its newest checkpoint (``checkpoints/
latest_model.ckpt``, through ``train/checkpoints.py``), enhances the file
with ``train/evaluate.py:evaluate_utterance`` (a separator keeps its first
speaker), writes the result, and with ``--clean`` prints SI-SDR and STOI
against the clean file. Runs on the CUDA card unless ``--device cpu``.
The port's counterpart of ``examples/inference.py``, for a run of the port.
"""

from __future__ import annotations

import argparse
import os

from speech_enhancement_torch.config import load_config
from speech_enhancement_torch.data.wav_io import read_wav, write_wav
from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.train import checkpoints as ckpt
from speech_enhancement_torch.train.evaluate import evaluate_utterance
from speech_enhancement_torch.train.metrics import compute_metrics


def enhance_file(run_dir: str, wav_path: str, out_path: str, clean_path: str = None,
                 device: DeviceLike = None) -> dict:
    """The tool's work; returns ``{"enhanced": [C, T] array, "scores": dict
    or None}``."""
    dev = resolve_device(device)
    path = ckpt.latest_checkpoint(run_dir)
    if path is None:
        raise SystemExit(f"no checkpoints/latest_model.ckpt under {run_dir}")
    config = load_config(os.path.join(run_dir, "config.yaml"))
    model, spec = build_model(config.model, device=dev)
    model.load_state_dict(ckpt.model_state(path))

    wav, sr = read_wav(wav_path)
    if sr != int(config.dset.sample_rate):
        raise SystemExit(f"{wav_path} is {sr} Hz; the run expects {config.dset.sample_rate}")
    enhanced = evaluate_utterance(wav[None], model, spec, config, device=dev)
    if spec.multi_speaker:
        enhanced = enhanced[:, 0]
    enhanced = enhanced[0]  # [C, T]
    write_wav(out_path, enhanced, sr)
    print(f"wrote {out_path} ({enhanced.shape[-1] / sr:.2f} s)")
    scores = None
    if clean_path:
        clean, _ = read_wav(clean_path)
        scores = compute_metrics(clean[None], enhanced[None], sr, ("sisdr", "stoi"))
        print("scores vs clean:", scores)
    return {"enhanced": enhanced, "scores": scores}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m speech_enhancement_torch.tools.inference",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--run-dir", required=True, help="training run directory")
    parser.add_argument("--wav", required=True, help="input (noisy) wav")
    parser.add_argument("--out", default="enhanced.wav")
    parser.add_argument("--clean", default=None, help="optional clean wav for scoring")
    parser.add_argument("--device", default=None,
                        help="torch device (e.g. cpu); default cuda, which needs a card")
    args = parser.parse_args(argv)
    enhance_file(args.run_dir, args.wav, args.out, args.clean, args.device)


if __name__ == "__main__":
    main()
