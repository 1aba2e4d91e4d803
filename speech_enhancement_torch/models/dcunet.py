"""DCUnet, the deep complex U-Net (counterpart of speech_enhancement_tpu/models/dcunet.py).

  [B, C, F, T, 2] spectrum -> (real, imag) as [B, C, T, F] (time first, as
  the reference transposes on entry)
      -> depth / 2 complex encoder blocks (paired real convs combined as a
         complex product, each part's own BatchNorm, leaky-ReLU 0.01)
      -> depth / 2 complex decoder blocks (paired ConvTranspose2d, VALID,
         cropped by the table's padding), each but the last followed by
         the encoder skip, the trunk first cropped or zero-padded to it
      -> cropped or padded to the input's (T, F), a complex 1x1 conv and
         tanh in f32: the complex mask
      -> masking mode E (bounded magnitude times the input's, phases
         added), C (complex product) or R (each part by its own)

``data_type=False`` is the JAX package's real path, a documented deviation
from the reference: the "amplitude" |re^2 - im^2| enters as the real part
with a zero imaginary part, and the real mask scales both parts.
Convolutions and activations run in ``dtype``; BatchNorm (flax's, each part
alone: ``ops/complex_ops.py:ComplexBatchNormSimple``) and the mask head in
f32. Parameter names are the reference's (``encoder{i}.conv.conv_{re,im}``,
``encoder{i}.bn.bn_{re,im}``, ``decoder{i}.transconv.tconv_{re,im}``,
``decoder{i}.bn``, ``linear.conv_{re,im}``), so ``compat.dcunet_state_from_jax``
and the JAX package's ``dcunet_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import STFT_MONO, SignalSpec
from speech_enhancement_torch.ops.complex_ops import ComplexBatchNormSimple
from speech_enhancement_torch.ops.layers import (compute_dtype, conv, conv_transpose, run_conv,
                                                 run_conv_transpose)

Pair = Tuple[torch.Tensor, torch.Tensor]


def _tables(complexity: int, depth: int, audio_channels: int):
    """Channel, kernel, stride and padding tables (the JAX package's ``_tables``)."""
    c = complexity
    if depth == 10:
        enc_ch = [audio_channels, c, c * 2, c * 2, c * 2, c * 2]
        enc_k = [(7, 5), (7, 5), (5, 3), (5, 3), (5, 3)]
        enc_s = [(2, 2), (2, 2), (2, 2), (2, 2), (2, 1)]
        enc_p = [(2, 1), None, None, None, None]
        dec_ch = [0, c * 2, c * 2, c * 2, c * 2, c * 2]
        dec_k = [(4, 3), (4, 4), (6, 4), (6, 4), (7, 5)]
        dec_s = [(2, 1), (2, 2), (2, 2), (2, 2), (2, 2)]
        dec_p = [(1, 1), (1, 1), (2, 1), (2, 1), (2, 1)]
    elif depth == 20:
        enc_ch = [audio_channels, c, c, c * 2, c * 2, c * 2, c * 2, c * 2, c * 2, c * 2, 128]
        enc_k = [(7, 1), (1, 7), (6, 4), (7, 5), (5, 3), (5, 3), (5, 3), (5, 3), (5, 3), (5, 3)]
        enc_s = [(1, 1), (1, 1), (2, 2), (2, 1), (2, 2), (2, 1), (2, 2), (2, 1), (2, 2), (2, 1)]
        enc_p = [(3, 0), (0, 3)] + [None] * 8
        dec_ch = [0] + [c * 2] * 11
        dec_k = [(4, 3), (4, 2), (4, 3), (4, 2), (4, 3), (4, 2), (6, 3), (7, 5), (1, 7), (7, 1)]
        dec_s = [(2, 1), (2, 2), (2, 1), (2, 2), (2, 1), (2, 2), (2, 1), (2, 2), (1, 1), (1, 1)]
        dec_p = [(1, 1), (1, 0), (1, 1), (1, 0), (1, 1), (1, 0), (2, 1), (2, 1), (0, 3), (3, 0)]
    else:
        raise ValueError(f"unknown model depth {depth}")
    enc_p = [p if p is not None else tuple((k - 1) // 2 for k in ks)
             for p, ks in zip(enc_p, enc_k)]
    return enc_ch, enc_k, enc_s, enc_p, dec_ch, dec_k, dec_s, dec_p


class _ConvPair(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride, generator):
        super().__init__()
        self.conv_re = conv(in_ch, out_ch, kernel, generator, stride=stride)
        self.conv_im = conv(in_ch, out_ch, kernel, generator, stride=stride)


class _TConvPair(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride, generator):
        super().__init__()
        self.tconv_re = conv_transpose(in_ch, out_ch, kernel, generator, stride=stride)
        self.tconv_im = conv_transpose(in_ch, out_ch, kernel, generator, stride=stride)


class _EncoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride, pad,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.pads = [(pad[0], pad[0]), (pad[1], pad[1])]
        self.conv = _ConvPair(in_ch, out_ch, kernel, stride, generator)
        self.bn = ComplexBatchNormSimple(out_ch)

    def forward(self, x: Pair, cd: torch.dtype) -> Pair:
        xr, xi = x
        re, im = self.conv.conv_re, self.conv.conv_im
        yr = run_conv(re, xr, cd, self.pads) - run_conv(im, xi, cd, self.pads)
        yi = run_conv(re, xi, cd, self.pads) + run_conv(im, xr, cd, self.pads)
        yr, yi = self.bn((yr, yi))
        return F.leaky_relu(yr, 0.01).to(cd), F.leaky_relu(yi, 0.01).to(cd)


class _DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel, stride, pad,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.pad = pad
        self.transconv = _TConvPair(in_ch, out_ch, kernel, stride, generator)
        self.bn = ComplexBatchNormSimple(out_ch)

    def _crop(self, y: torch.Tensor) -> torch.Tensor:
        p0, p1 = self.pad
        return y[:, :, p0: y.shape[2] - p0, p1: y.shape[3] - p1]

    def forward(self, x: Pair, cd: torch.dtype) -> Pair:
        xr, xi = x
        re, im = self.transconv.tconv_re, self.transconv.tconv_im
        yr = self._crop(run_conv_transpose(re, xr, cd) - run_conv_transpose(im, xi, cd))
        yi = self._crop(run_conv_transpose(re, xi, cd) + run_conv_transpose(im, xr, cd))
        yr, yi = self.bn((yr, yi))
        return F.leaky_relu(yr, 0.01).to(cd), F.leaky_relu(yi, 0.01).to(cd)


def _fit(x: torch.Tensor, t: int, f: int) -> torch.Tensor:
    """Crop or zero-pad [B, C, T, F] to exactly (t, f)."""
    x = x[:, :, :t, :f]
    return F.pad(x, (0, f - x.shape[3], 0, t - x.shape[2]))


class DCUnet(nn.Module):
    SPEC: SignalSpec = STFT_MONO

    def __init__(self, audio_channels: int = 1, data_type: bool = True,
                 model_complexity: int = 45, model_depth: int = 10, padding_mode: str = "zeros",
                 masking_mode: str = "E", dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if masking_mode not in ("E", "C", "R"):
            raise ValueError(f"unknown masking_mode {masking_mode!r}")
        self.compute_dtype = compute_dtype(dtype)
        self.data_type = data_type
        self.masking_mode = masking_mode
        complexity = int(model_complexity // 1.414) if data_type else model_complexity
        enc_ch, enc_k, enc_s, enc_p, dec_ch, dec_k, dec_s, dec_p = _tables(
            complexity, model_depth, audio_channels)
        self.model_length = n = model_depth // 2
        for i in range(n):
            setattr(self, f"encoder{i}", _EncoderBlock(enc_ch[i], enc_ch[i + 1], enc_k[i],
                                                       enc_s[i], enc_p[i], generator))
        for i in range(n):
            in_ch = enc_ch[n] if i == 0 else dec_ch[i] + enc_ch[n - i]
            setattr(self, f"decoder{i}", _DecoderBlock(in_ch, dec_ch[i + 1], dec_k[i],
                                                       dec_s[i], dec_p[i], generator))
        self.linear = _ConvPair(dec_ch[n], 1, (1, 1), 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, F, T, 2] -> the masked spectrum of the same shape."""
        cd = self.compute_dtype
        real, imag = x[..., 0], x[..., 1]
        if self.data_type:
            h = (real.transpose(2, 3), imag.transpose(2, 3))
        else:
            amp = torch.abs(real**2 - imag**2).transpose(2, 3)  # the reference's quirk
            h = (amp, torch.zeros_like(amp))
        in_t, in_f = h[0].shape[2], h[0].shape[3]
        n = self.model_length
        skips = []
        for i in range(n):
            skips.append(h)
            h = getattr(self, f"encoder{i}")(h, cd)
        for i in range(n):
            h = getattr(self, f"decoder{i}")(h, cd)
            if i == n - 1:
                break
            skip_r, skip_i = skips[n - 1 - i]
            t, f = skip_r.shape[2], skip_r.shape[3]
            h = (torch.cat([_fit(h[0], t, f).float(), skip_r.float()], dim=1),
                 torch.cat([_fit(h[1], t, f).float(), skip_i.float()], dim=1))
        hr, hi = (_fit(part, in_t, in_f).float() for part in h)
        re, im = self.linear.conv_re, self.linear.conv_im
        f32 = torch.float32
        mask_r = torch.tanh(run_conv(re, hr, f32) - run_conv(im, hi, f32)).transpose(2, 3)
        mask_i = torch.tanh(run_conv(re, hi, f32) + run_conv(im, hr, f32)).transpose(2, 3)
        if not self.data_type:
            return torch.stack([real * mask_r, imag * mask_r], dim=-1)
        if self.masking_mode == "E":
            x_mag = torch.sqrt(real**2 + imag**2 + 1e-8)
            x_phase = torch.atan2(imag, real)
            mags = torch.sqrt(mask_r**2 + mask_i**2)
            mask_phase = torch.atan2(mask_i / (mags + 1e-8), mask_r / (mags + 1e-8))
            est_mags = torch.tanh(mags) * x_mag
            est_phase = x_phase + mask_phase
            out_r, out_i = est_mags * torch.cos(est_phase), est_mags * torch.sin(est_phase)
        elif self.masking_mode == "C":
            out_r, out_i = real * mask_r - imag * mask_i, real * mask_i + imag * mask_r
        else:
            out_r, out_i = real * mask_r, imag * mask_i
        return torch.stack([out_r, out_i], dim=-1)
