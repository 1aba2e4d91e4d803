"""Lay out downloaded VoiceBank-DEMAND / Clarity corpora for ``configs/*.yaml``.

The port's counterpart of the repository's ``tools/prepare_data.py``: the
same command line, the same output tree and the same JSON line, with WAVs
read and written by ``data/wav_io.py`` and resampled by
``ops/resample.py:resample_frac`` on the CUDA card unless ``--device cpu``
is given (in f64, which no TF32 setting reaches, rounded to f32 on write).

VoiceBank-DEMAND (clean_trainset_28spk_wav, noisy_trainset_28spk_wav and
the test-set folders, unzipped under one root):

    python -m speech_enhancement_torch.tools.prepare_data vbd --src /path/to/VBD \\
        --dst ./data/VoiceBank-DEMAND [--sample-rate 16000] [--copy] [--device cpu]

  writes {dst}/{noisy,clean}_trainset_wav[, {noisy,clean}_testset_wav] with
  paired file names: resampled when --sample-rate is given, else symlinked
  (or copied with --copy).

Clarity (a CEC1 / CEC2 data package):

    python -m speech_enhancement_torch.tools.prepare_data clarity --src /path/to/clarity_data \\
        --dst ./data/Clarity [--copy]

  writes {dst}/{train,dev}/scenes, {dst}/custom_metadata/ (scenes.train.json,
  scenes.dev.json, scenes.train.time.json from the scene WAVs or the
  package's metadata) and {dst}/metadata/{listeners.json,
  scenes_listeners.json} for hearing-aid scoring.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
from typing import Optional

import torch

from speech_enhancement_torch.data.wav_io import read_wav, write_wav
from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.ops.resample import resample_frac


def _place(src: str, dst: str, copy: bool) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.lexists(dst):
        return
    if copy:
        shutil.copy2(src, dst)
    else:
        os.symlink(os.path.abspath(src), dst)


def resample_wav(src: str, dst: str, sr: int, device: torch.device) -> None:
    """Read ``src``, resample it to ``sr`` on ``device`` (f64) unless it is
    at ``sr`` already, and write ``dst`` as f32."""
    wav, file_sr = read_wav(src)
    if file_sr != sr:
        signal = torch.from_numpy(wav).to(device=device, dtype=torch.float64)
        wav = resample_frac(signal, file_sr, sr).float().cpu().numpy()
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    write_wav(dst, wav, sr)


def _find_dir(src: str, needle: str) -> Optional[str]:
    """First directory under src whose name contains needle and that holds
    a WAV (the reference's find_folder contract)."""
    hits = sorted(
        d for d, _, files in os.walk(src)
        if needle in os.path.basename(d) and any(f.endswith(".wav") for f in files)
    )
    return hits[0] if hits else None


def prepare_vbd(src: str, dst: str, sample_rate: int, copy: bool,
                device: DeviceLike = None) -> dict:
    """Place (or resample) the four VoiceBank-DEMAND folders; print and
    return the JSON summary. ``device`` (default ``cuda``) is resolved only
    when ``sample_rate`` asks for resampling."""
    dev = resolve_device(device) if sample_rate else None
    pairs = [
        ("noisy_trainset", "noisy_trainset_wav"),
        ("clean_trainset", "clean_trainset_wav"),
        ("noisy_testset", "noisy_testset_wav"),
        ("clean_testset", "clean_testset_wav"),
    ]
    placed = {}
    for needle, out_name in pairs:
        found = _find_dir(src, needle)
        if found is None:
            if "trainset" in needle:
                raise SystemExit(f"no '{needle}*' wav folder under {src}")
            continue  # test sets are optional
        out_dir = os.path.join(dst, out_name)
        wavs = sorted(glob.glob(os.path.join(found, "*.wav")))
        for wav in wavs:
            target = os.path.join(out_dir, os.path.basename(wav))
            if sample_rate:
                resample_wav(wav, target, sample_rate, dev)
            else:
                _place(wav, target, copy)
        placed[out_name] = len(wavs)
    # every noisy train wav must have a clean twin
    noisy = {os.path.basename(p) for p in
             glob.glob(os.path.join(dst, "noisy_trainset_wav", "*.wav"))}
    clean = {os.path.basename(p) for p in
             glob.glob(os.path.join(dst, "clean_trainset_wav", "*.wav"))}
    missing = sorted(noisy - clean)[:5]
    if missing:
        raise SystemExit(f"unpaired noisy wavs (no clean twin): {missing} ...")
    summary = {"dataset": "VoiceBank-DEMAND", "root": dst, **placed}
    print(json.dumps(summary))
    return summary


_SCENE_RE = re.compile(r"^(S\d+)_mix_CH1\.wav$")


def _clarity_scan(scene_dir: str) -> list:
    return sorted(m.group(1) for f in os.listdir(scene_dir) if (m := _SCENE_RE.match(f)))


def _first(*paths: str) -> Optional[str]:
    return next((p for p in paths if os.path.exists(p)), None)


def _target_spans(src: str) -> dict:
    """Scene -> [start, end] of the target from the package's
    scenes.train.json, where it has one."""
    meta = _first(os.path.join(src, "metadata", "scenes.train.json"),
                  os.path.join(src, "clarity_data", "metadata", "scenes.train.json"))
    if meta is None:
        return {}
    with open(meta) as fh:
        raw = json.load(fh)
    spans = {}
    for item in raw if isinstance(raw, list) else []:
        scene = item.get("scene")
        tgt = item.get("target", {})
        if scene and "time_start" in tgt:
            spans[scene] = [int(tgt["time_start"]), int(tgt["time_end"])]
    return spans


def prepare_clarity_tree(src: str, dst: str, copy: bool) -> dict:
    """Place the Clarity scenes and write the metadata the loaders and the
    hearing-aid scorer read; print and return the JSON summary."""
    placed = {}
    for split in ("train", "dev"):
        found = next((c for c in (os.path.join(src, split, "scenes"),
                                  os.path.join(src, "clarity_data", split, "scenes"))
                      if os.path.isdir(c)), None)
        if found is None:
            if split == "train":
                raise SystemExit(f"no {split}/scenes under {src}")
            continue
        out_dir = os.path.join(dst, split, "scenes")
        for wav in sorted(glob.glob(os.path.join(found, "*.wav"))):
            _place(wav, os.path.join(out_dir, os.path.basename(wav)), copy)
        scenes = _clarity_scan(out_dir)
        placed[split] = len(scenes)

        meta_dir = os.path.join(dst, "custom_metadata")
        os.makedirs(meta_dir, exist_ok=True)
        with open(os.path.join(meta_dir, f"scenes.{split}.json"), "w") as fh:
            json.dump(scenes, fh)
        if split == "train":
            # the target-active spans; absent the package's metadata the
            # whole utterance keeps every segment trainable
            spans = _target_spans(src)
            times = {}
            for scene in scenes:
                if scene not in spans:
                    wav, _ = read_wav(os.path.join(out_dir, f"{scene}_mix_CH1.wav"))
                    spans[scene] = [0, int(wav.shape[-1])]
                times[scene] = spans[scene]
            with open(os.path.join(meta_dir, "scenes.train.time.json"), "w") as fh:
                json.dump(times, fh)

    ha_meta = os.path.join(dst, "metadata")  # for configs/ha_clarity.yaml
    os.makedirs(ha_meta, exist_ok=True)
    for name in ("listeners.json", "scenes_listeners.json"):
        found = _first(os.path.join(src, "metadata", name),
                       os.path.join(src, "clarity_data", "metadata", name))
        if found is not None:
            _place(found, os.path.join(ha_meta, name), copy)
            placed[name] = True
    summary = {"dataset": "Clarity", "root": dst, **placed}
    print(json.dumps(summary))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m speech_enhancement_torch.tools.prepare_data",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("vbd", "clarity"):
        p = sub.add_parser(name)
        p.add_argument("--src", required=True, help="downloaded corpus root")
        p.add_argument("--dst", required=True, help="output tree for configs")
        p.add_argument("--copy", action="store_true",
                       help="copy files instead of symlinking")
        if name == "vbd":
            p.add_argument("--sample-rate", type=int, default=0,
                           help="resample wavs (e.g. 16000); 0 = keep as-is")
            p.add_argument("--device", default=None,
                           help="torch device for resampling (e.g. cpu); default cuda")
    args = ap.parse_args(argv)
    if args.cmd == "vbd":
        prepare_vbd(args.src, args.dst, args.sample_rate, args.copy, args.device)
    else:
        prepare_clarity_tree(args.src, args.dst, args.copy)


if __name__ == "__main__":
    main()
