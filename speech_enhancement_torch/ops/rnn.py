"""LSTM layers (counterpart of speech_enhancement_tpu/ops/rnn.py).

``LSTMLayer`` keeps the JAX package's evaluation order:

* the input projection for all timesteps is hoisted out of the recurrence
  into one matmul, accumulated in f32, cast to the compute dtype, then the
  bias ``b_ih + b_hh`` (cast to the compute dtype) is added;
* the recurrence is a plain loop over time (the counterpart of
  ``lax.scan``): per step one [B, H] @ [H, 4H] matmul plus the gates, in
  torch's gate order i, f, g, o, with the state carried in the compute
  dtype; or, with ``fused``, the recurrence kernels of ``kernels/lstm.py``
  (the JAX ``fused`` path, ops/pallas/lstm.py).

``RNNStack`` stacks LSTM layers (bidirectional: forward and reversed,
concatenated), as the JAX ``RNNStack`` does for ``rnn_type="lstm"``.

Parameter names are torch ``nn.LSTM``'s (``weight_ih_l0`` [4H, D],
``weight_hh_l0`` [4H, H], ``bias_ih_l0``, ``bias_hh_l0``), so the
reference's ``state_dict`` keys load as they are; cuDNN's LSTM is not used.
All modules take and return batch-major [B, T, D] tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.kernels.lstm import fused_lstm


def _uniform(generator: Optional[torch.Generator], bound: float, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


def lstm_recurrence(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                    bias: Optional[torch.Tensor], dtype: Optional[torch.dtype] = None,
                    reverse: bool = False, init_state=None, fused: bool = False
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM direction over [B, T, D] -> ([B, T, H], (h_last, c_last)).

    ``w_ih`` [4H, D] and ``w_hh`` [4H, H] are torch ``nn.LSTM``'s layouts,
    ``bias`` is ``b_ih + b_hh`` (or None), ``dtype`` the compute dtype. The
    input projection is hoisted (f32 accumulation, cast, then the bias cast
    to the compute dtype); ``init_state`` (h0, c0) is cast to the compute
    dtype, as the JAX scan carry. ``reverse`` walks t = T-1 .. 0 and
    returns the outputs in time order; (h_last, c_last) are the state after
    the last step walked.

    ``fused=False`` is the plain loop: per step one [B, H] @ [H, 4H] matmul
    and the gates, with the state carried in the compute dtype (the JAX
    ``lax.scan`` path). ``fused=True`` goes through
    :func:`kernels.lstm.fused_lstm`: the hand-written recurrence kernels on
    a CUDA tensor and their plain versions on a CPU tensor, for any H, with
    h and c carried in f32 and the f32 product added to x_proj unrounded,
    so in bf16 the two paths differ, as in JAX. The JAX ``fused=True`` also
    checks ``H % 128`` (a TPU lane rule, not copied) and takes its scan on
    the CPU; the port's ``fused=True`` on the CPU is the JAX ``"force"``.
    """
    cd = dtype or x.dtype
    batch, steps, _ = x.shape
    hidden = w_hh.shape[1]
    if init_state is None:
        h0 = x.new_zeros((batch, hidden), dtype=cd)
        c0 = torch.zeros_like(h0)
    else:
        h0, c0 = (s.to(cd) for s in init_state)
    if fused:
        # time-major projection [T, B, 4H], as the kernel takes it
        x_proj = F.linear(x.transpose(0, 1).to(cd), w_ih.to(cd))
        if bias is not None:
            x_proj = x_proj + bias.to(cd)
        h_seq, h_last, c_last = fused_lstm(x_proj, w_hh.to(cd).t(), h0, c0, reverse)
        return h_seq.transpose(0, 1), (h_last, c_last)
    x_proj = F.linear(x.to(cd), w_ih.to(cd))
    if bias is not None:
        x_proj = x_proj + bias.to(cd)
    w_hh_t = w_hh.to(cd).t()
    h, c = h0, c0
    outs = [None] * steps
    for t in (range(steps - 1, -1, -1) if reverse else range(steps)):
        gates = torch.addmm(x_proj[:, t], h, w_hh_t)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs, dim=1), (h, c)


class LSTMLayer(nn.Module):
    """Single-direction LSTM layer over [B, T, D] -> [B, T, H].

    ``dtype`` is the compute dtype (e.g. ``torch.bfloat16``); parameters
    stay float32. Weights are drawn from U(-1/sqrt(H), 1/sqrt(H)) with
    ``generator``. ``reverse``, ``use_bias`` and ``fused`` as
    :func:`lstm_recurrence` takes them.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, *, reverse: bool = False,
                 use_bias: bool = True, fused: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.reverse = reverse
        self.fused = fused
        h4 = 4 * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        self.weight_ih_l0 = _uniform(generator, bound, h4, input_size)
        self.weight_hh_l0 = _uniform(generator, bound, h4, hidden_size)
        if use_bias:
            self.bias_ih_l0 = _uniform(generator, bound, h4)
            self.bias_hh_l0 = _uniform(generator, bound, h4)
        else:
            self.bias_ih_l0 = self.bias_hh_l0 = None

    def forward(self, x: torch.Tensor, init_state=None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Returns (outputs [B, T, H], (h_last, c_last))."""
        bias = None if self.bias_ih_l0 is None else self.bias_ih_l0 + self.bias_hh_l0
        return lstm_recurrence(x, self.weight_ih_l0, self.weight_hh_l0, bias, self.dtype,
                               self.reverse, init_state, self.fused)


class RNNStack(nn.Module):
    """Multi-layer, optionally bidirectional LSTM stack over [B, T, D]
    (counterpart of the JAX ``RNNStack`` with ``rnn_type="lstm"``).

    Parameters carry torch ``nn.LSTM``'s names (``weight_ih_l{k}``,
    ``weight_hh_l{k}``, ``bias_{ih,hh}_l{k}``, and ``_reverse`` for the
    backward direction, which is the JAX layer ``l{k}_bwd``), so a reference
    ``state_dict`` loads as it is. The output is ``hidden * (2 if
    bidirectional else 1)`` wide, forward then backward. Inter-layer
    dropout is train-time only and is not ported: a stack with dropout
    raises in ``train()`` mode. GRU and vanilla-RNN stacks are not ported.
    """

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_type != "lstm":
            raise NotImplementedError(
                f"RNNStack rnn_type={rnn_type!r} is not ported yet: the mel-rnn slice "
                "(ROADMAP queue 1, item 8) ports the GRU and vanilla-RNN layers")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.use_bias = use_bias
        self.dtype = dtype
        self.fused = fused
        bound = 1.0 / math.sqrt(hidden_size)
        h4 = 4 * hidden_size
        for layer in range(num_layers):
            width = input_size if layer == 0 else hidden_size * (2 if bidirectional else 1)
            for suffix in self._suffixes():
                name = f"l{layer}{suffix}"
                setattr(self, f"weight_ih_{name}", _uniform(generator, bound, h4, width))
                setattr(self, f"weight_hh_{name}", _uniform(generator, bound, h4, hidden_size))
                if use_bias:
                    setattr(self, f"bias_ih_{name}", _uniform(generator, bound, h4))
                    setattr(self, f"bias_hh_{name}", _uniform(generator, bound, h4))

    def _suffixes(self):
        return ("", "_reverse") if self.bidirectional else ("",)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.dropout > 0 and self.num_layers > 1:
            raise NotImplementedError(
                "RNNStack inter-layer dropout in train() mode is not ported yet: the "
                "rnn-stft-mask training slice ports it")
        out = x
        for layer in range(self.num_layers):
            parts = []
            for suffix in self._suffixes():
                name = f"l{layer}{suffix}"
                bias = (getattr(self, f"bias_ih_{name}") + getattr(self, f"bias_hh_{name}")
                        if self.use_bias else None)
                y, _ = lstm_recurrence(out, getattr(self, f"weight_ih_{name}"),
                                       getattr(self, f"weight_hh_{name}"), bias, self.dtype,
                                       reverse=suffix == "_reverse", fused=self.fused)
                parts.append(y)
            out = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        return out


class _Linear(nn.Module):
    """Projection with torch ``nn.Linear`` parameter names and layout."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((out_features, in_features), in_features,
                                                generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        cd = dtype or x.dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


def lecun_normal(shape, fan_in: int, generator: Optional[torch.Generator] = None):
    """Truncated normal, variance 1/fan_in (flax's default kernel init)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # unit-variance truncation
    out = torch.empty(shape)
    nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return out


class ComplexLSTM(nn.Module):
    """DCCRN's complex LSTM: out_r = Lr(xr) - Li(xi), out_i = Lr(xi) + Li(xr).

    (xr, xi) are stacked on the batch axis so each real LSTM runs once over
    [xr; xi]. With ``projection_dim`` the two parts get independent real
    projections ``r_trans``/``i_trans`` in the compute dtype.
    """

    def __init__(self, input_size: int, hidden_size: int,
                 projection_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.real_lstm = LSTMLayer(input_size, hidden_size, dtype, generator)
        self.imag_lstm = LSTMLayer(input_size, hidden_size, dtype, generator)
        if projection_dim is not None:
            self.r_trans = _Linear(hidden_size, projection_dim, generator)
            self.i_trans = _Linear(hidden_size, projection_dim, generator)
        else:
            self.r_trans = self.i_trans = None

    def forward(self, xr: torch.Tensor, xi: torch.Tensor):
        batch = xr.shape[0]
        stacked = torch.cat([xr, xi], dim=0)
        r_both, _ = self.real_lstm(stacked)  # [Lr(xr); Lr(xi)]
        i_both, _ = self.imag_lstm(stacked)  # [Li(xr); Li(xi)]
        out_r = r_both[:batch] - i_both[batch:]
        out_i = r_both[batch:] + i_both[:batch]
        if self.r_trans is not None:
            out_r = self.r_trans(out_r, self.dtype)
            out_i = self.i_trans(out_i, self.dtype)
        return out_r, out_i
