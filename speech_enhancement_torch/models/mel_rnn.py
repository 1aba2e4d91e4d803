"""MelRNN magnitude-mask model (counterpart of speech_enhancement_tpu/models/mel_rnn.py).

  [B, 1, F, T, 2] -> |re^2 - im^2| (the reference's amplitude quirk)
      -> optional mel projection after a power 0.3 compression
      -> RNN / LSTM / GRU stack without bias over [B, T, features]
      -> BatchNorm over the features (flax's, momentum 0.9)
      -> Linear + ReLU -> Linear + Sigmoid
      -> optional inverse mel, clamped at >= 0
      -> the mask times (re, im): [B, 1, F, T, 2]

Everything runs in f32, as the JAX model passes no compute dtype to its
stack. ``fused_rnn=True`` runs an LSTM stack's recurrences through
``kernels/lstm.py`` (the kernels on CUDA tensors, their plain versions on
CPU tensors); GRU and vanilla-RNN stacks have no kernel.
``rnn_over_batch_compat=True`` swaps the batch and time axes around the
stack, as the reference runs a ``batch_first=False`` RNN on [B, T, F].

Parameter names are the reference torch MelRNN's (``rnn.weight_ih_l{k}``,
``batchnorm.*``, ``fc_layers.{0,2}.*``), so ``compat.mel_rnn_state_from_jax``
and the JAX package's ``mel_rnn_from_torch_state`` map weights one to one;
the filterbanks are buffers outside the ``state_dict``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from speech_enhancement_torch.models.stft_rnn import amplitude_quirk, dense
from speech_enhancement_torch.models.types import STFT_MONO, SignalSpec
from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.mel import inverse_mel_filterbank, mel_filterbank
from speech_enhancement_torch.ops.rnn import RNNStack


class MelRNN(nn.Module):
    SPEC: SignalSpec = STFT_MONO

    def __init__(self, n_fft: int = 512, hop_length: int = 256, n_mels: int = 0,
                 f_min: float = 100.0, f_max: float = 8000.0, sample_rate: int = 16000,
                 rnn_hidden: int = 256, rnn_layer: int = 2, rnn_type: str = "rnn",
                 rnn_over_batch_compat: bool = False, fused_rnn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(fused_rnn, bool):
            raise ValueError(f"fused_rnn takes True or False, got {fused_rnn!r}")
        self.rnn_over_batch_compat = rnn_over_batch_compat
        n_freqs = n_fft // 2 + 1
        self.n_mels = n_mels
        features = n_mels or n_freqs
        if n_mels:
            fb = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
            inv = inverse_mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
            self.register_buffer("mel_fb", torch.from_numpy(fb), persistent=False)
            self.register_buffer("mel_inv", torch.from_numpy(inv), persistent=False)
        self.rnn = RNNStack(rnn_type, features, rnn_hidden, num_layers=rnn_layer,
                            use_bias=False, fused=fused_rnn, generator=generator)
        self.batchnorm = BatchNorm(rnn_hidden)
        self.fc_layers = nn.Sequential(dense(rnn_hidden, features, generator), nn.ReLU(),
                                       dense(features, features, generator), nn.Sigmoid())

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """[B, 1, F, T, 2] -> the masked spectrum, same shape."""
        x = amplitude_quirk(inputs.float())[:, 0]  # [B, F, T]
        if self.n_mels:
            x = torch.einsum("bft,fm->bmt", torch.pow(x, 0.3), self.mel_fb)
        x = x.transpose(1, 2)  # [B, T, features]
        if self.rnn_over_batch_compat:
            x = x.transpose(0, 1)
        x = self.rnn(x)
        if self.rnn_over_batch_compat:
            x = x.transpose(0, 1)
        x = self.fc_layers(self.batchnorm(x, feature_dim=-1)).transpose(1, 2)  # [B, features, T]
        if self.n_mels:
            x = torch.clamp(torch.einsum("bmt,mf->bft", x, self.mel_inv), min=0.0)
        return inputs * x[:, None, :, :, None]
