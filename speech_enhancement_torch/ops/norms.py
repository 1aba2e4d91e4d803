"""Normalization layers and the EMA smoother (counterpart of
speech_enhancement_tpu/ops/norms.py).

``GlobalLayerNorm`` (Sepformer's and Conv-TasNet's gLN),
``ChannelwiseLayerNorm`` (Conv-TasNet's cLN), ``CumulativeLayerNorm``
(causal cLN), ``ema_scan`` (the DNN's EMA smoothers), and the library
blocks no model of either package builds: ``EMA`` (a fixed or learnable
smoother) and ``PCEN`` (trainable (s)PCEN). Channels-last, as in the JAX
package; the functional forms take the affine parameters so a model can
keep them under the reference's names and layouts.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def global_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """gLN over every axis but the batch, channels last (the JAX arithmetic:
    statistics in f32, the affine folded into a scale and a shift rounded
    to x's dtype)."""
    dims = tuple(range(1, x.dim()))
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mean = x.float().mean(dim=dims).reshape(shape)
    var = (x * x).float().mean(dim=dims).reshape(shape) - mean**2
    root = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    scale = (weight / root).to(x.dtype)
    shift = (bias - weight * mean / root).to(x.dtype)
    return x * scale + shift


def channelwise_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-8) -> torch.Tensor:
    """cLN over the last (channel) axis at each step: mean and E[x^2] in f32
    (x * x taken in x's dtype), ``(x - mean) / sqrt(var + eps) * weight +
    bias`` in f32, rounded to x's dtype."""
    mean = x.float().mean(dim=-1, keepdim=True)
    var = (x * x).float().mean(dim=-1, keepdim=True) - mean**2
    inv = 1.0 / torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return ((x.float() - mean) * inv * weight + bias).to(x.dtype)


class GlobalLayerNorm(nn.Module):
    """gLN with per-channel affine, channels last. Parameters are ``weight``
    (gamma) and ``bias`` (beta), the reference Sepformer's GroupNorm names."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_layer_norm(x, self.weight, self.bias, self.eps)


class ChannelwiseLayerNorm(nn.Module):
    """cLN: normalise over the channel axis at each time step; affine."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channelwise_layer_norm(x, self.weight, self.bias, self.eps)


class CumulativeLayerNorm(nn.Module):
    """Causal cLN over [B, T, C]: step t is normalised by the statistics of
    every frame <= t (pooled over past time and channels), from two
    cumulative sums, in x's dtype as in JAX."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        channels = x.shape[-1]
        cum_sum = torch.cumsum(x.sum(-1), dim=1)[..., None]
        cum_sq = torch.cumsum((x**2).sum(-1), dim=1)[..., None]
        count = (torch.arange(1, x.shape[1] + 1, device=x.device) * channels)
        count = count[None, :, None].to(x.dtype)
        mean = cum_sum / count
        var = cum_sq / count - mean**2
        return self.weight * (x - mean) / torch.sqrt(torch.clamp(var, min=0.0) + self.eps) \
            + self.bias


def ema_scan(x: torch.Tensor, alpha, dim: int = 1) -> torch.Tensor:
    """First-order EMA along ``dim``: y_t = (1 - a) y_{t-1} + a x_t, y_-1 = 0
    (the first output is ``a * x_0``).

    A log-depth doubling scan, the counterpart of JAX's
    ``lax.associative_scan``: each element carries the pair (A, B) of the
    affine map y -> A y + B over its window, and round k composes every
    element with the one 2^k steps before it, so ceil(log2 T) rounds of
    shifted multiply-adds cover the sequence. No per-frame loop and no
    ``(1 - a)^-t`` closed form (which overflows in f32 at a = 0.85 by T
    501). ``alpha`` is a scalar or a per-channel tensor that broadcasts
    against x with time on ``dim``.
    """
    x = x.movedim(dim, 0)
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).expand(x.shape[1:])
    coeff = (1.0 - a).expand(x.shape)
    val = x * a
    shift, steps = 1, x.shape[0]
    while shift < steps:
        val = torch.cat([val[:shift], val[shift:] + coeff[shift:] * val[:-shift]])
        coeff = torch.cat([coeff[:shift], coeff[shift:] * coeff[:-shift]])
        shift *= 2
    return val.movedim(0, dim)


class EMA(nn.Module):
    """EMA smoother over [B, T, C] (:func:`ema_scan` along time) with a fixed
    coefficient ``alpha`` or, with ``trainable``, a learnable per-channel
    one: ``sigmoid(alpha_logit)``, the logit starting at ``log(alpha / (1 -
    alpha))`` taken in f32 as JAX takes it."""

    def __init__(self, channels: int, alpha: float = 0.1, trainable: bool = False):
        super().__init__()
        self.alpha = alpha
        self.trainable = trainable
        if trainable:
            logit0 = float(np.log(np.float32(alpha / (1.0 - alpha))))
            self.alpha_logit = nn.Parameter(torch.full((channels,), logit0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.alpha_logit) if self.trainable else self.alpha
        return ema_scan(x, alpha, dim=1)


class PCEN(nn.Module):
    """Per-channel energy normalisation over [B, T, C] magnitudes:
    ``(x * exp(-alpha * log(floor + EMA(x))) + delta) ** (1 / max(root,
    1e-3)) - delta ** (1 / max(root, 1e-3))``, with trainable per-channel
    ``alpha``, ``delta`` and ``root`` and the smoother ``smoother`` (an
    :class:`EMA` of ``smooth_coef``, learnable per channel with ``spcen``);
    the JAX ``PCEN`` operation for operation."""

    def __init__(self, channels: int, alpha: float = 0.96, delta: float = 2.0,
                 root: float = 2.0, smooth_coef: float = 0.04, floor: float = 1e-6,
                 spcen: bool = False):
        super().__init__()
        self.floor = floor
        self.alpha = nn.Parameter(torch.full((channels,), alpha))
        self.delta = nn.Parameter(torch.full((channels,), delta))
        self.root = nn.Parameter(torch.full((channels,), root))
        self.smoother = EMA(channels, smooth_coef, trainable=spcen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        smoother = self.smoother(x)
        one_over_root = 1.0 / torch.clamp(self.root, min=1e-3)
        smooth = torch.exp(-self.alpha * torch.log(self.floor + smoother))
        return (x * smooth + self.delta) ** one_over_root - self.delta ** one_over_root
