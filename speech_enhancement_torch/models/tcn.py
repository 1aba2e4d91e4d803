"""Dilated TCN (counterpart of speech_enhancement_tpu/models/tcn.py).

  [B, 1, T] -> encoder Conv1d (k 2s, stride s, flax "SAME" pads)
      -> ``tcn_repeats`` x ``tcn_blocks`` residual blocks: causal dilated
         conv (k ``tcn_kernel``, dilation 2^b) -> GELU (tanh form) ->
         GroupNorm (1 group, eps 1e-6) -> 1x1 projection, added to the input
      -> decoder ConvTranspose1d (k 2s, stride s, flax "SAME") in f32
      -> the first T samples

Activations [B, C, T]. The convs and the residual stream run in ``dtype``,
GroupNorm and the decoder in f32. The reference declares the family but
implements nothing, so the parameter names follow the flax modules
(``encoder``, ``block_{r}_{b}.{dilated,norm,project}``, ``decoder``); the
decoder's weight is torch's ConvTranspose1d layout, the flax kernel
flipped.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import WAV_MONO, SignalSpec
from speech_enhancement_torch.ops.layers import (GroupNorm, compute_dtype, conv, conv_transpose,
                                                 run_conv, run_conv_transpose, same_pads)


class _TCNBlock(nn.Module):
    def __init__(self, hidden: int, channels: int, kernel: int, dilation: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.pad = (kernel - 1) * dilation  # causal
        self.dilated = conv(channels, hidden, kernel, generator, dilation=dilation)
        self.norm = GroupNorm(1, hidden)
        self.project = conv(hidden, channels, 1, generator)

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = F.gelu(run_conv(self.dilated, x, cd, [(self.pad, 0)]), approximate="tanh")
        y = run_conv(self.project, self.norm(y), cd)
        return x.to(cd) + y


class DilatedTCN(nn.Module):
    SPEC: SignalSpec = WAV_MONO

    def __init__(self, tcn_channels: int = 64, tcn_hidden: int = 128, tcn_kernel: int = 3,
                 tcn_blocks: int = 8, tcn_repeats: int = 2, tcn_stride: int = 16,
                 dtype: str = "float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype(dtype)
        self.stride = tcn_stride
        self.encoder = conv(1, tcn_channels, 2 * tcn_stride, generator, stride=tcn_stride)
        self.blocks = [(r, b) for r in range(tcn_repeats) for b in range(tcn_blocks)]
        for r, b in self.blocks:
            setattr(self, f"block_{r}_{b}", _TCNBlock(tcn_hidden, tcn_channels, tcn_kernel,
                                                      2**b, generator))
        self.decoder = conv_transpose(tcn_channels, 1, 2 * tcn_stride, generator,
                                      stride=tcn_stride)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] -> [B, 1, T]."""
        cd = self.compute_dtype
        pads = same_pads(wav.shape[-1], 2 * self.stride, self.stride)
        x = run_conv(self.encoder, wav, cd, [pads])
        for r, b in self.blocks:
            x = getattr(self, f"block_{r}_{b}")(x, cd)
        x = run_conv_transpose(self.decoder, x.float(), torch.float32, "SAME")
        return x[..., : wav.shape[-1]]
