"""UNet magnitude-mask model (counterpart of speech_enhancement_tpu/models/unet.py).

  [B, C, F, T, 2] spectrum -> |re^2 + im^2| (the reference's "amplitude",
  which is the power: a quirk kept) as [B, C, F, T]
      -> ``unet_layer`` Down blocks (DoubleConv -> 2x2 max pool, kept as
         skips; the deepest DoubleConv with dropout 0.5)
      -> a middle DoubleConv with dropout 0.5
      -> Up blocks: ConvTranspose2d k 2 s 2 (or 2x bilinear upsampling with
         align_corners), zero-padded to the skip, the skip concatenated,
         a DoubleConv
      -> a last Up against the power map itself, down to ``unet_channels``
      -> the mask times the input spectrum

DoubleConv is (3x3 conv without bias -> BatchNorm -> leaky-ReLU 0.01) x 2
[-> dropout]. Convs and activations run in ``dtype``, BatchNorm (flax's)
in f32. Parameter names are the reference's
(``encoder.{n}.maxpool_conv.0.double_conv``, ``middle.double_conv``,
``decoder.{n}.{up,conv.double_conv}``, ``outconv.{up,conv.double_conv}``;
conv at 0 and 3, BatchNorm at 1 and 4), so ``compat.unet_state_from_jax``
and the JAX package's ``unet_from_torch_state`` map weights one to one.
Dropout in ``train()`` mode draws from torch's global generator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import STFT_MONO, SignalSpec
from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.layers import (compute_dtype, conv, conv_transpose, run_conv,
                                                 run_conv_transpose)


class _DoubleConv(nn.Module):
    def __init__(self, in_ch: int, features: int, mid: Optional[int], dropout: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        mid = mid or features
        self.double_conv = nn.ModuleList([
            conv(in_ch, mid, (3, 3), generator, bias=False), BatchNorm(mid),
            nn.LeakyReLU(0.01),
            conv(mid, features, (3, 3), generator, bias=False), BatchNorm(features),
            nn.LeakyReLU(0.01)])
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        layers = self.double_conv
        for conv_i, bn_i in ((0, 1), (3, 4)):
            x = F.leaky_relu(layers[bn_i](run_conv(layers[conv_i], x, cd, [(1, 1), (1, 1)])),
                             0.01).to(cd)
        return x if self.dropout is None else self.dropout(x)


class _Down(nn.Module):
    def __init__(self, in_ch: int, features: int, dropout: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.maxpool_conv = nn.ModuleList([_DoubleConv(in_ch, features, None, dropout, generator),
                                           nn.MaxPool2d(2)])

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        return F.max_pool2d(self.maxpool_conv[0](x, cd), 2)


class _Up(nn.Module):
    """[trunk -> up (unless ``first``), zero-padded to the skip] ++ skip -> DoubleConv."""

    def __init__(self, trunk: int, skip: int, features: int, bilinear: bool, first: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.bilinear = bilinear
        self.first = first
        self.up = None
        mid = trunk // 2 if bilinear else None  # the reference Up's in_channels // 2
        if not first and not bilinear:
            self.up = conv_transpose(trunk, trunk // 2, (2, 2), generator, stride=2)
            trunk //= 2
        self.conv = _DoubleConv(trunk + skip, features, mid, 0.0, generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        if not self.first:
            if self.bilinear:
                x = F.interpolate(x.float(), scale_factor=2, mode="bilinear", align_corners=True)
            else:
                x = run_conv_transpose(self.up, x, cd)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        x = F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x.float(), skip.float()], dim=1), cd)


class UNet(nn.Module):
    SPEC: SignalSpec = STFT_MONO

    def __init__(self, unet_channels: int = 1, unet_layer: int = 4, bilinear: bool = False,
                 dtype: str = "float32", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype(dtype)
        n_layers = unet_layer
        channels = [unet_channels] + [(2**n) * 16 for n in range(n_layers + 1)]
        self.encoder = nn.ModuleList([
            _Down(channels[n], channels[n + 1], 0.0 if n < n_layers - 1 else 0.5, generator)
            for n in range(n_layers)])
        self.middle = _DoubleConv(channels[-2], channels[-1], None, 0.5, generator)
        rev = channels[::-1]
        self.decoder = nn.ModuleList([
            _Up(rev[n], rev[n + 1], rev[n + 1], bilinear, n == 0, generator)
            for n in range(n_layers)])
        self.outconv = _Up(rev[-2], unet_channels, unet_channels, bilinear, False, generator)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """[B, C, F, T, 2] -> the masked spectrum."""
        cd = self.compute_dtype
        amp = torch.abs(mix[..., 0] ** 2 + mix[..., 1] ** 2)  # the power quirk
        x = amp
        skips = []
        for down in self.encoder:
            x = down(x, cd)
            skips.append(x)
        x = self.middle(x, cd)
        for n, up in enumerate(self.decoder):
            x = up(x, skips[len(skips) - 1 - n], cd)
        mask = self.outconv(x, amp, cd).to(mix.dtype)
        return mix * mask[..., None]
