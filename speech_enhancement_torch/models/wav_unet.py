"""Wave-U-Net (counterpart of speech_enhancement_tpu/models/wav_unet.py).

  [B, 1, T], zero-padded to a multiple of 2^``unet_nlayers``
      -> ``unet_nlayers`` x (Conv1d k 15 -> BatchNorm -> leaky-ReLU 0.1,
         kept as a skip, then every second frame)
      -> a middle block
      -> ``unet_nlayers`` x (2x linear upsampling with align_corners, the
         skip concatenated, Conv1d k 5 -> BatchNorm -> leaky-ReLU 0.1)
      -> the input concatenated, a 1x1 Conv1d and tanh in f32
      -> the first T samples

Activations [B, C, T]. The convs and activations run in ``dtype``,
BatchNorm (flax's) in f32. Parameter names are the reference's
(``encoder.{i}.main.{0,1}``, ``middle.{0,1}``, ``decoder.{i}.main.{0,1}``,
``out.0``), so ``compat.wav_unet_state_from_jax`` and the JAX package's
``wav_unet_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import WAV_MONO, SignalSpec
from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.layers import compute_dtype, conv, run_conv


class _ConvBN(nn.ModuleList):
    """Conv1d (pads k // 2) -> BatchNorm -> leaky-ReLU 0.1, out in ``cd``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: Optional[torch.Generator]):
        super().__init__([conv(in_ch, out_ch, kernel, generator), BatchNorm(out_ch)])

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        pad = self[0].kernel_size[0] // 2
        y = self[1](run_conv(self[0], x, cd, [(pad, pad)]))
        return F.leaky_relu(y, 0.1).to(cd)


class _Main(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.main = _ConvBN(in_ch, out_ch, kernel, generator)

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        return self.main(x, cd)


class WavUNet(nn.Module):
    SPEC: SignalSpec = WAV_MONO

    def __init__(self, unet_nlayers: int = 12, channels_interval: int = 24,
                 dtype: str = "float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype(dtype)
        self.n_layers = n = unet_nlayers
        ci = channels_interval
        enc_in = [1] + [i * ci for i in range(1, n)]
        self.encoder = nn.ModuleList([_Main(enc_in[i], (i + 1) * ci, 15, generator)
                                      for i in range(n)])
        self.middle = _ConvBN(n * ci, n * ci, 15, generator)
        # decoder i: the trunk ((n - i + 1) ci wide, n ci after the middle)
        # and the skip of encoder n - 1 - i ((n - i) ci wide)
        self.decoder = nn.ModuleList([
            _Main((2 * n - 2 * i + 1 if i else 2 * n) * ci, (n - i) * ci, 5, generator)
            for i in range(n)])
        self.out = nn.ModuleList([conv(ci + 1, 1, 1, generator)])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] -> [B, 1, T]."""
        cd = self.compute_dtype
        length = wav.shape[-1]
        pad = (-length) % (2**self.n_layers)
        x = F.pad(wav, (0, pad)).to(cd) if pad else wav.to(cd)
        inp = x
        skips = []
        for block in self.encoder:
            x = block(x, cd)
            skips.append(x)
            x = x[..., ::2]
        x = self.middle(x, cd)
        for i, block in enumerate(self.decoder):
            x = F.interpolate(x.float(), scale_factor=2, mode="linear", align_corners=True)
            x = block(torch.cat([x, skips[self.n_layers - 1 - i].float()], dim=1), cd)
        x = run_conv(self.out[0], torch.cat([x, inp], dim=1), torch.float32)
        return torch.tanh(x)[..., :length]
