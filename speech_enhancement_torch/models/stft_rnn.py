"""RNN STFT-mask multi-speaker separator (counterpart of
speech_enhancement_tpu/models/stft_rnn.py).

  [B, C, F, T, 2] -> |re^2 - im^2| (the reference's amplitude quirk)
      -> [B*C, T, F] -> LSTM stack without bias (optionally bidirectional)
      -> BatchNorm over the stack's features -> Linear to F * num_spk -> ReLU
      -> per-speaker masks times the mixture spectrum: [B, S, C, F, T, 2]

The stack runs in the compute dtype (``dtype``); BatchNorm, the Linear head
and the masking in f32. ``fused_rnn=True`` runs every layer and direction
through the recurrence kernels (``kernels/lstm.py``; the backward direction
with ``reverse``), on a CUDA tensor, and their plain versions on a CPU
tensor; GRU and vanilla-RNN stacks run the plain loop. ``drop_out`` drops
between the stack's layers in ``train()`` mode (``ops/rnn.py:RNNStack``;
its masks are not flax's). ``rnn_over_batch_compat=True`` swaps the batch
and time axes around the stack, as the reference runs a
``batch_first=False`` RNN on [B*C, T, F].

Parameter names are the reference torch STFT_RNN's (``rnn.weight_ih_l{k}``
[``_reverse``], ``batchnorm.*``, ``fc_layers.0.*``), so
``compat.rnn_stft_mask_state_from_jax`` and the JAX package's
``rnn_stft_mask_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from speech_enhancement_torch.models.types import STFT_MULTI, SignalSpec
from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.rnn import RNNStack, lecun_normal

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def amplitude_quirk(x: torch.Tensor) -> torch.Tensor:
    """|re^2 - im^2| (the reference's Amplitude; speech_enhancement_tpu/
    models/mel_rnn.py:22-24)."""
    return torch.abs(x[..., 0] ** 2 - x[..., 1] ** 2)


def dense(in_features: int, out_features: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """``nn.Linear`` with flax Dense's default init (LeCun normal, zero bias)."""
    fc = nn.Linear(in_features, out_features)
    with torch.no_grad():
        fc.weight.copy_(lecun_normal((out_features, in_features), in_features, generator))
        fc.bias.zero_()
    return fc


class RNNSTFTMask(nn.Module):
    SPEC: SignalSpec = STFT_MULTI

    def __init__(self, num_spk: int = 2, n_fft: int = 512, rnn_hidden: int = 256,
                 rnn_layer: int = 2, rnn_type: str = "rnn", drop_out: float = 0.5,
                 bidirectional: bool = False, rnn_over_batch_compat: bool = False,
                 dtype: str = "float32", fused_rnn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(fused_rnn, bool):
            raise ValueError(f"fused_rnn takes True or False, got {fused_rnn!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.num_spk = num_spk
        self.rnn_over_batch_compat = rnn_over_batch_compat
        n_feature = n_fft // 2 + 1
        width = rnn_hidden * (2 if bidirectional else 1)
        self.rnn = RNNStack(rnn_type, n_feature, rnn_hidden, num_layers=rnn_layer,
                            bidirectional=bidirectional, dropout=drop_out, use_bias=False,
                            dtype=_DTYPES[dtype], fused=fused_rnn, generator=generator)
        self.batchnorm = BatchNorm(width)
        self.fc_layers = nn.Sequential(dense(width, n_feature * num_spk, generator), nn.ReLU())

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """[B, C, F, T, 2] -> [B, S, C, F, T, 2]."""
        batch, n_channel, n_feature, n_frame, _ = inputs.shape
        mask = amplitude_quirk(inputs.float()).reshape(batch * n_channel, n_feature, n_frame)
        mask = mask.transpose(1, 2)  # [B*C, T, F]
        if self.rnn_over_batch_compat:
            mask = mask.transpose(0, 1)
        mask = self.rnn(mask).float()  # [B*C, T, H']
        if self.rnn_over_batch_compat:
            mask = mask.transpose(0, 1)
        mask = self.batchnorm(mask, feature_dim=-1)
        mask = self.fc_layers(mask)  # [B*C, T, F*S], f32
        mask = mask.transpose(1, 2).reshape(batch, n_channel, self.num_spk, n_feature, n_frame)
        mask = mask.transpose(1, 2)  # [B, S, C, F, T]
        return mask[..., None] * inputs[:, None]
