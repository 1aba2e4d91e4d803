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
tensor. Only LSTM stacks are ported; the inter-layer dropout is
train-time and is not (the stack raises in ``train()`` mode with
``drop_out`` > 0), and neither is ``rnn_over_batch_compat=True``.

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


class RNNSTFTMask(nn.Module):
    SPEC: SignalSpec = STFT_MULTI

    def __init__(self, num_spk: int = 2, n_fft: int = 512, rnn_hidden: int = 256,
                 rnn_layer: int = 2, rnn_type: str = "rnn", drop_out: float = 0.5,
                 bidirectional: bool = False, rnn_over_batch_compat: bool = False,
                 dtype: str = "float32", fused_rnn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_over_batch_compat:
            raise NotImplementedError(
                "rnn_over_batch_compat=True (the reference's recurrence over the batch "
                "axis) is not ported yet: the rnn-stft-mask training slice ports it")
        if not isinstance(fused_rnn, bool):
            raise ValueError(f"fused_rnn takes True or False, got {fused_rnn!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.num_spk = num_spk
        n_feature = n_fft // 2 + 1
        width = rnn_hidden * (2 if bidirectional else 1)
        self.rnn = RNNStack(rnn_type, n_feature, rnn_hidden, num_layers=rnn_layer,
                            bidirectional=bidirectional, dropout=drop_out, use_bias=False,
                            dtype=_DTYPES[dtype], fused=fused_rnn, generator=generator)
        self.batchnorm = BatchNorm(width)
        fc = nn.Linear(width, n_feature * num_spk)
        with torch.no_grad():  # flax Dense's default init
            fc.weight.copy_(lecun_normal((n_feature * num_spk, width), width, generator))
            fc.bias.zero_()
        self.fc_layers = nn.Sequential(fc, nn.ReLU())

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """[B, C, F, T, 2] -> [B, S, C, F, T, 2]."""
        batch, n_channel, n_feature, n_frame, _ = inputs.shape
        mask = amplitude_quirk(inputs.float()).reshape(batch * n_channel, n_feature, n_frame)
        mask = self.rnn(mask.transpose(1, 2)).float()  # [B*C, T, H']
        mask = self.batchnorm(mask, feature_dim=-1)
        mask = self.fc_layers(mask)  # [B*C, T, F*S], f32
        mask = mask.transpose(1, 2).reshape(batch, n_channel, self.num_spk, n_feature, n_frame)
        mask = mask.transpose(1, 2)  # [B, S, C, F, T]
        return mask[..., None] * inputs[:, None]
