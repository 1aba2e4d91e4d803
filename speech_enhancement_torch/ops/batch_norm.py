"""flax ``nn.BatchNorm`` with torch ``BatchNorm{1,2}d``'s parameter names.

Counterpart of the ``nn.BatchNorm(momentum=0.9)`` layers of the JAX CRN and
RNN STFT-mask models. The arithmetic is flax's, not torch's:

* statistics in f32 over every axis but the feature axis, the variance
  the biased one-pass form ``max(0, E[x^2] - E[x]^2)``;
* ``train()`` mode normalises with the batch statistics and updates the
  running ones as ``r = 0.9 r + 0.1 batch`` (torch's ``F.batch_norm``
  would update with the unbiased variance);
* ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``, in f32 whatever
  the input dtype (flax promotes a bf16 input against its f32 parameters).

Parameters ``weight``, ``bias`` and buffers ``running_mean``,
``running_var`` (no ``num_batches_tracked``).
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, feature_dim: int = 1) -> torch.Tensor:
        x = x.float()
        feature_dim %= x.dim()
        axes = tuple(d for d in range(x.dim()) if d != feature_dim)
        if self.training:
            mean = x.mean(axes)
            var = torch.clamp(x.square().mean(axes) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1] * x.dim()
        shape[feature_dim] = -1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
