"""Normalization layers (counterpart of speech_enhancement_tpu/ops/norms.py).

Only ``GlobalLayerNorm`` is ported so far (Sepformer's gLN); the
channel-wise and cumulative norms, ``EMA`` and ``PCEN`` come with the
models that use them. Channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn


class GlobalLayerNorm(nn.Module):
    """gLN over every axis but the batch, per-channel affine, channels last.

    The JAX arithmetic: mean and E[x^2] in f32 (x * x taken in x's dtype),
    var = E[x^2] - mean^2 clipped at zero, then ``x * scale + shift`` in
    x's dtype with ``scale = gamma / sqrt(var + eps)`` and ``shift = beta -
    gamma * mean / sqrt(var + eps)`` rounded to it. Parameters are
    ``weight`` (gamma) and ``bias`` (beta), the reference's GroupNorm names.
    """

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.dim()))
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mean = x.float().mean(dim=dims).reshape(shape)
        var = (x * x).float().mean(dim=dims).reshape(shape) - mean**2
        root = torch.sqrt(torch.clamp(var, min=0.0) + self.eps)
        scale = (self.weight / root).to(x.dtype)
        shift = (self.bias - self.weight * mean / root).to(x.dtype)
        return x * scale + shift
