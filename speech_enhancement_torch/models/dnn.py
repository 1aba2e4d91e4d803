"""DNN magnitude-mask model (counterpart of speech_enhancement_tpu/models/dnn.py).

  [B, C, F, T, 2] spectrum -> magnitude, frames as rows [B C T, F]
      -> (``dnn_ema``) a context Linear and the input EMA (alpha 0.1)
      -> ``n_layers`` x (Linear -> BatchNorm -> activation -> dropout),
         the last block Linear -> BatchNorm only
      -> (``dnn_ema``) the output EMA (alpha 0.85)
      -> the magnitude mask times the input ("mask"), or (|x|, 0)
         ("reconstruct", the reference's collapse of x exp(i angle(x)))

The Linears of the stack run in ``dtype``; the context Linear, BatchNorm
(flax's: momentum 0.9, biased batch variance), the EMAs (log-depth scans,
``ops/norms.py:ema_scan``) and the mask stay f32. Dropout in ``train()``
mode draws from torch's global generator. Parameter names are the
reference's (``context``, ``model.{n}.model.0`` Linear, ``model.{n}.model.1``
BatchNorm1d), so ``compat.dnn_state_from_jax`` and the JAX package's
``dnn_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import STFT_MONO, SignalSpec
from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.layers import compute_dtype, linear
from speech_enhancement_torch.ops.norms import ema_scan

_ACTIVATIONS = {
    "linear": lambda x: x,
    "leaky-relu": lambda x: F.leaky_relu(x, 0.1),
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


class _Block(nn.Module):
    """``model.0`` Linear, ``model.1`` BatchNorm (the reference's Sequential)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.model = nn.ModuleList([linear(in_features, out_features, generator, bias),
                                    BatchNorm(out_features)])


class DNN(nn.Module):
    SPEC: SignalSpec = STFT_MONO

    def __init__(self, n_fft: int = 512, n_layers: int = 4, hidden_layer: int = 1024,
                 bias: bool = True, activation: str = "leaky-relu", drop_out: float = 0.0,
                 dnn_method: str = "mask", dnn_ema: bool = True, dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation must be one of {sorted(_ACTIVATIONS)}, "
                             f"got {activation!r}")
        self.compute_dtype = compute_dtype(dtype)
        self.activation = activation
        self.drop_out = drop_out
        self.dnn_method = dnn_method
        self.dnn_ema = dnn_ema
        n_feature = n_fft // 2 + 1
        if dnn_ema:
            self.context = linear(n_feature, n_feature, generator)
        widths = [n_feature] + [hidden_layer] * (n_layers - 1) + [n_feature]
        self.model = nn.ModuleList([_Block(widths[n], widths[n + 1], bias, generator)
                                    for n in range(n_layers)])

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """[B, C, F, T, 2] -> the masked spectrum (or the reconstruction)."""
        batch, n_channel, n_feature, n_frame, _ = mix.shape
        cd = self.compute_dtype
        act = _ACTIVATIONS[self.activation]
        x = torch.sqrt(mix[..., 0] ** 2 + mix[..., 1] ** 2)
        x = x.reshape(batch * n_channel, n_feature, n_frame).transpose(1, 2)  # [B C, T, F]
        if self.dnn_ema:
            x = ema_scan(self.context(x.float()), 0.1, dim=1)
        x = x.reshape(batch * n_channel * n_frame, n_feature)
        for n, block in enumerate(self.model):
            lin, bn = block.model
            bias = None if lin.bias is None else lin.bias.to(cd)
            x = bn(F.linear(x.to(cd), lin.weight.to(cd), bias))
            if n < len(self.model) - 1:
                x = act(x).to(cd)
                x = F.dropout(x, self.drop_out, self.training)
        x = x.reshape(batch * n_channel, n_frame, n_feature).float()
        if self.dnn_ema:
            x = ema_scan(x, 0.85, dim=1)
        x = x.transpose(1, 2).reshape(batch, n_channel, n_feature, n_frame)
        if self.dnn_method == "reconstruct":
            return torch.stack([x.abs(), torch.zeros_like(x)], dim=-1)
        return mix * x[..., None]
