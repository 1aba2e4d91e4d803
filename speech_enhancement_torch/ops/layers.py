"""flax's convolution, dense and group-norm layers in torch's layouts.

The zoo's models keep torch's channels-first layout ([B, C, T] or
[B, C, H, W]) and the reference's parameter names, and reproduce flax's
arithmetic where the two differ:

* ``conv`` / ``conv_transpose`` / ``linear`` build torch modules with
  flax's default init (a truncated-normal kernel of variance 1 / fan-in,
  zero bias) from a ``torch.Generator``;
* ``run_conv`` computes a flax ``Conv`` with compute dtype ``dtype``:
  input, kernel and bias cast to it, explicit (low, high) pads per axis;
* ``run_conv_transpose`` computes a flax ``ConvTranspose``, which does not
  flip its kernel: the torch weight [in, out, *k] holds the flax kernel
  flipped, and flax's pads (``transpose_pads``: "SAME", "VALID" or
  explicit) are met by cropping torch's full output (or zero-padding it)
  before the bias is added;
* ``GroupNorm`` is flax's: statistics in f32 as E[x^2] - E[x]^2, eps 1e-6,
  f32 out.

A ``dtype`` of float32 is also flax's ``dtype=None`` with f32 parameters
(the result type of an f32 kernel and any input).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.ops.rnn import lecun_normal

Pads = Sequence[Tuple[int, int]]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {name!r}")
    return DTYPES[name]


def _init(module: nn.Module, fan_in: int, generator: Optional[torch.Generator]) -> nn.Module:
    with torch.no_grad():
        module.weight.copy_(lecun_normal(module.weight.shape, fan_in, generator))
        if module.bias is not None:
            module.bias.zero_()
    return module


def conv(in_ch: int, out_ch: int, kernel: Union[int, Sequence[int]],
         generator: Optional[torch.Generator], *, stride=1, dilation=1, groups: int = 1,
         bias: bool = True) -> nn.Module:
    """``nn.Conv1d`` / ``nn.Conv2d`` (by the kernel's rank) with flax's init."""
    kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
    cls = nn.Conv1d if len(kernel) == 1 else nn.Conv2d
    module = cls(in_ch, out_ch, kernel, stride=stride, dilation=dilation, groups=groups,
                 bias=bias)
    return _init(module, in_ch // groups * math.prod(kernel), generator)


def conv_transpose(in_ch: int, out_ch: int, kernel: Union[int, Sequence[int]],
                   generator: Optional[torch.Generator], *, stride=1,
                   bias: bool = True) -> nn.Module:
    """``nn.ConvTranspose1d`` / ``2d`` with flax ``ConvTranspose``'s init
    (fan-in: ``in_ch`` times the kernel's size)."""
    kernel = (kernel,) if isinstance(kernel, int) else tuple(kernel)
    cls = nn.ConvTranspose1d if len(kernel) == 1 else nn.ConvTranspose2d
    module = cls(in_ch, out_ch, kernel, stride=stride, bias=bias)
    return _init(module, in_ch * math.prod(kernel), generator)


def linear(in_features: int, out_features: int, generator: Optional[torch.Generator],
           bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with flax ``Dense``'s init."""
    return _init(nn.Linear(in_features, out_features, bias=bias), in_features, generator)


def same_pads(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax ``Conv(padding="SAME")``'s (low, high) pads on one axis: the
    output has ceil(length / stride) frames, the extra pad goes high."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def _call(fn, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], *args):
    """``fn(x, weight, bias, *args)``. On the CPU a bf16 convolution runs on
    f32 copies of its bf16 operands and rounds the result to bf16 (f32
    accumulation, as cuDNN's on the card): torch's own CPU bf16
    convolution returns wrong values at stride 4 (torch 2.13, oneDNN)."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        bias = None if bias is None else bias.float()
        return fn(x.float(), weight.float(), bias, *args).to(torch.bfloat16)
    return fn(x, weight, bias, *args)


def run_conv(module: nn.Module, x: torch.Tensor, dtype: torch.dtype,
             pads: Optional[Pads] = None) -> torch.Tensor:
    """flax ``Conv`` with compute dtype ``dtype``: ``pads`` is one (low,
    high) pair per spatial axis (None: VALID)."""
    x = x.to(dtype)
    if pads is not None and any(p for pair in pads for p in pair):
        flat = [p for pair in reversed(list(pads)) for p in pair]  # F.pad: last axis first
        x = F.pad(x, flat)
    fn = F.conv1d if x.dim() == 3 else F.conv2d
    bias = None if module.bias is None else module.bias.to(dtype)
    return _call(fn, x, module.weight.to(dtype), bias, module.stride, 0, module.dilation,
                 module.groups)


def transpose_pads(kernel: int, stride: int, padding) -> Tuple[int, int]:
    """``lax.conv_transpose``'s (low, high) pads of the stride-dilated input."""
    if padding == "SAME":
        pad_len = kernel + stride - 2
        pad_a = kernel - 1 if stride > kernel - 1 else int(math.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = kernel + stride - 2 + max(kernel - stride, 0)
        pad_a = kernel - 1
    else:
        return tuple(padding)
    return pad_a, pad_len - pad_a


def run_conv_transpose(module: nn.Module, x: torch.Tensor, dtype: torch.dtype,
                       padding="VALID") -> torch.Tensor:
    """flax ``ConvTranspose`` (``padding`` "SAME", "VALID" or one (low,
    high) pair per axis) with compute dtype ``dtype``: torch's full
    transposed conv (pads k - 1 on both sides), cropped or zero-padded to
    flax's pads, then the bias, so a zero-padded frame holds the bias as in
    flax."""
    x = x.to(dtype)
    fn = F.conv_transpose1d if x.dim() == 3 else F.conv_transpose2d
    y = _call(fn, x, module.weight.to(dtype), None, module.stride)
    kernels = module.kernel_size
    pads = [padding] * len(kernels) if isinstance(padding, str) else list(padding)
    flat = []  # F.pad's order: the last axis first; a negative pad crops
    for k, s, p in reversed(list(zip(kernels, module.stride, pads))):
        flat.extend(pad - (k - 1) for pad in transpose_pads(k, s, p))
    if any(flat):
        y = F.pad(y, flat)
    if module.bias is not None:
        y = y + module.bias.to(dtype).view((1, -1) + (1,) * len(kernels))
    return y


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over channels-first [B, C, ...]: per group,
    mean and E[x^2] in f32, var = max(0, E[x^2] - mean^2), ``(x - mean) *
    rsqrt(var + eps) * weight + bias`` in f32. Parameters ``weight`` and
    ``bias`` (torch ``nn.GroupNorm``'s names)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.float().reshape(x.shape[0], self.groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = torch.clamp(g.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.view(shape) + self.bias.view(shape)
