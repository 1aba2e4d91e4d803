"""Full-utterance inference: segment -> model -> overlap-discard stitch.

Counterpart of speech_enhancement_tpu/train/evaluate.py:

1. normalise each utterance over its own samples (z-score with ddof=1, or
   linear-scale) with masked statistics, so zero padding changes nothing;
2. cut sliding windows of ``sample_rate * segment`` samples at stride
   ``model.win_length``, zero-filled beyond the end; the window count is
   rounded up to a multiple of ``_BUCKET``;
3. run the model over all windows as one batch (an stft-domain model gets
   ``stft_custom`` of the windows, and its output goes back through
   ``istft_custom`` to ``window`` samples);
4. stitch by overlap-discard: window 0 is kept whole, every later window
   contributes only its last ``stride`` samples;
5. denormalise and trim to the utterance length.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from speech_enhancement_torch.device import DeviceLike, module_device, resolve_device
from speech_enhancement_torch.models.types import SignalSpec
from speech_enhancement_torch.ops.stft import istft_custom, stft_custom

_BUCKET = 4  # window-count granularity, as in the JAX package


def _num_windows(length: int, window: int, stride: int) -> int:
    if length <= window:
        return 1
    return -(-(length - window) // stride) + 1


def extract_windows(wav: torch.Tensor, window: int, stride: int, n_windows: int) -> torch.Tensor:
    """[..., T] -> [n_windows, ..., window], zero-filled beyond the end."""
    total = window + (n_windows - 1) * stride
    pad = total - wav.shape[-1]
    if pad > 0:
        wav = F.pad(wav, (0, pad))
    out = wav[..., :total].unfold(-1, window, stride)  # [..., n_windows, window]
    return out.movedim(-2, 0)


def stitch_overlap_discard(windows: torch.Tensor, stride: int, length: int) -> torch.Tensor:
    """Overlap-discard stitch: [N, ..., W] -> [..., length]."""
    n_windows = windows.shape[0]
    head = windows[0]
    if n_windows > 1:
        tails = windows[1:, ..., -stride:].movedim(0, -2)  # [..., N-1, stride]
        tails = tails.reshape(*tails.shape[:-2], (n_windows - 1) * stride)
        full = torch.cat([head, tails], dim=-1)
    else:
        full = head
    pad = length - full.shape[-1]
    if pad > 0:
        full = F.pad(full, (0, pad))
    return full[..., :length]


def evaluate_utterance(
    mixture,
    model,
    spec: SignalSpec,
    config,
    num_sources: Optional[int] = None,
    lengths=None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Enhance an utterance batch [B, C, T] -> numpy [B, C, T] (or [B, S, C, T]).

    ``model`` is an eval-mode module called on the window batch
    [N*B, C, window], or None for the identity passthrough. ``lengths``:
    per-utterance true lengths [B] when the rows are zero-padded to a shared
    T; each row is normalised over its own samples. ``device`` defaults to
    ``cuda`` and raises when no card is present; it must be the model's.
    """
    dev = resolve_device(device)
    model_dev = module_device(model)
    if model_dev is not None:
        if model_dev.type != dev.type:
            raise ValueError(f"model is on {model_dev} but evaluation runs on {dev}")
        dev = model_dev
    if model is not None and model.training:
        raise ValueError("evaluate_utterance needs the model in eval mode")
    model_cfg = config.model
    norm = str(config.dset.norm)
    window = int(config.dset.sample_rate * model_cfg.segment)
    stride = int(model_cfg.win_length)

    host = np.asarray(mixture, dtype=np.float32)  # [B, C, T]
    length = host.shape[-1]
    n_pad = -(-_num_windows(length, window, stride) // _BUCKET) * _BUCKET
    total = window + (n_pad - 1) * stride  # bucket-static padded length
    padded = np.zeros(host.shape[:-1] + (total,), np.float32)
    padded[..., :length] = host
    row_lengths = (np.asarray(lengths, np.int64) if lengths is not None
                   else np.full(host.shape[0], length, np.int64))

    with torch.inference_mode():
        padded_t = torch.from_numpy(padded).to(dev)
        lens = torch.from_numpy(row_lengths).to(dev).reshape(-1, 1, 1)
        mask = (torch.arange(total, device=dev) < lens).float()
        cnt = lens.float()
        if norm == "z-score":
            mean = (padded_t * mask).sum(-1, keepdim=True) / cnt
            var = (((padded_t - mean) * mask) ** 2).sum(-1, keepdim=True) / (cnt - 1.0)
            std = torch.sqrt(var)  # ddof=1
            x = (padded_t - mean) / (std + 1e-9) * mask
        elif norm == "linear-scale":
            big = torch.finfo(torch.float32).max
            valid = mask.bool()
            mx = torch.where(valid, padded_t, -big).amax(-1, keepdim=True)
            mn = torch.where(valid, padded_t, big).amin(-1, keepdim=True)
            x = (padded_t - mn) / (mx - mn + 1e-9) * mask
        else:
            x = padded_t

        windows = extract_windows(x, window, stride, n_pad)  # [N, B, C, W]
        _, nbatch, nchannel, _ = windows.shape
        batched = windows.reshape(n_pad * nbatch, nchannel, window)
        if spec.domain == "stft":
            batched = stft_custom(batched, model_cfg)
        output = batched if model is None else model(batched)
        if spec.monarch and output.dim() == batched.dim() + 1 and output.shape[1] == 1:
            output = output[:, 0]
        if spec.domain == "stft":
            output = istft_custom(output, window, model_cfg)
        multi = spec.multi_speaker and model is not None
        if multi:
            n_src = num_sources or output.shape[1]
            output = output.reshape(n_pad, nbatch, n_src, nchannel, window)
        else:
            output = output.reshape(n_pad, nbatch, nchannel, window)
        enhanced = stitch_overlap_discard(output, stride, total)

        if norm == "z-score":
            scale, offset = std + 1e-9, mean
        elif norm == "linear-scale":
            scale, offset = mx - mn + 1e-9, mn
        else:
            scale = offset = None
        if scale is not None:
            if multi:
                scale, offset = scale[:, None], offset[:, None]
            enhanced = enhanced * scale + offset
        return enhanced.cpu().numpy()[..., :length]
