"""Recurrent layers (counterpart of speech_enhancement_tpu/ops/rnn.py).

Every layer keeps the JAX package's evaluation order:

* the input projection for all timesteps is hoisted out of the recurrence
  into one matmul, accumulated in f32, cast to the compute dtype, then the
  input bias (cast to the compute dtype) is added: ``b_ih + b_hh`` for the
  LSTM and the vanilla RNN, ``b_ih`` for the GRU;
* the recurrence is a plain loop over time (the counterpart of
  ``lax.scan``), with the state carried in the compute dtype and each
  step's [B, H] @ [H, G H] product rounded to it: the LSTM's gates in
  torch's order i, f, g, o; the GRU's r, z, n with ``b_hh`` inside
  ``r * (W_hn h + b_hn)``; the vanilla RNN's tanh. With ``fused`` an LSTM
  runs the recurrence kernels of ``kernels/lstm.py`` instead (the JAX
  ``fused`` path, ops/pallas/lstm.py); the GRU and the vanilla RNN have
  no kernel, in JAX as here.

``RNNStack`` stacks layers of one type (bidirectional: forward and
reversed, concatenated), with the JAX stack's inter-layer dropout in
``train()`` mode; an LSTM stack and ``ComplexLSTM`` also take and return
their (h, c) state, which a stream carries from one chunk to the next
(serve/streaming.py).

Parameter names are torch ``nn.LSTM`` / ``nn.GRU`` / ``nn.RNN``'s
(``weight_ih_l0`` [G H, D], ``weight_hh_l0`` [G H, H], ``bias_ih_l0``,
``bias_hh_l0``; G = 4, 3, 1), so the reference's ``state_dict`` keys load
as they are; cuDNN's recurrences are not used. All modules take and return
batch-major [B, T, D] tensors.
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


def _visit(steps: int, reverse: bool):
    return range(steps - 1, -1, -1) if reverse else range(steps)


def _project(x: torch.Tensor, w_ih: torch.Tensor, bias: Optional[torch.Tensor],
             cd: torch.dtype) -> torch.Tensor:
    """The hoisted input projection: f32 accumulation rounded to ``cd``,
    then the bias cast to ``cd`` added."""
    x_proj = F.linear(x.to(cd), w_ih.to(cd))
    return x_proj if bias is None else x_proj + bias.to(cd)


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
        x_proj = _project(x.transpose(0, 1), w_ih, bias, cd)
        h_seq, h_last, c_last = fused_lstm(x_proj, w_hh.to(cd).t(), h0, c0, reverse)
        return h_seq.transpose(0, 1), (h_last, c_last)
    x_proj = _project(x, w_ih, bias, cd)
    w_hh_t = w_hh.to(cd).t()
    h, c = h0, c0
    outs = [None] * steps
    for t in _visit(steps, reverse):
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


def gru_recurrence(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   b_ih: Optional[torch.Tensor], b_hh: Optional[torch.Tensor],
                   dtype: Optional[torch.dtype] = None, reverse: bool = False) -> torch.Tensor:
    """One GRU direction over [B, T, D] -> [B, T, H] (the JAX ``GRULayer``).

    ``w_ih`` [3H, D], ``w_hh`` [3H, H] in torch ``nn.GRU``'s gate order r, z,
    n. Per step ``h W_hh`` is rounded to the compute dtype and ``b_hh``
    added, then r = σ(x_r + h_r), z = σ(x_z + h_z), n = tanh(x_n + r h_n),
    h = (1 - z) n + z h, all in the compute dtype, from h = 0.
    """
    cd = dtype or x.dtype
    batch, steps, _ = x.shape
    x_proj = _project(x, w_ih, b_ih, cd)
    w_hh_t = w_hh.to(cd).t()
    b_hh = None if b_hh is None else b_hh.to(cd)
    h = x.new_zeros((batch, w_hh.shape[1]), dtype=cd)
    outs = [None] * steps
    for t in _visit(steps, reverse):
        hp = torch.matmul(h, w_hh_t)
        if b_hh is not None:
            hp = hp + b_hh
        xr, xz, xn = x_proj[:, t].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1)


def rnn_recurrence(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                   bias: Optional[torch.Tensor], dtype: Optional[torch.dtype] = None,
                   reverse: bool = False) -> torch.Tensor:
    """One Elman RNN direction over [B, T, D] -> [B, T, H] with tanh (the JAX
    ``VanillaRNNLayer``): h = tanh(x W_ih + b + h W_hh), each product rounded
    to the compute dtype, from h = 0. ``bias`` is ``b_ih + b_hh``, the JAX
    layer's single ``b``."""
    cd = dtype or x.dtype
    batch, steps, _ = x.shape
    x_proj = _project(x, w_ih, bias, cd)
    w_hh_t = w_hh.to(cd).t()
    h = x.new_zeros((batch, w_hh.shape[1]), dtype=cd)
    outs = [None] * steps
    for t in _visit(steps, reverse):
        h = torch.tanh(x_proj[:, t] + torch.matmul(h, w_hh_t))
        outs[t] = h
    return torch.stack(outs, dim=1)


_GATES = {"lstm": 4, "gru": 3, "rnn": 1}


def _direction(rnn_type: str, x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               b_ih: Optional[torch.Tensor], b_hh: Optional[torch.Tensor],
               dtype: Optional[torch.dtype], reverse: bool, fused: bool, init_state=None
               ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One direction of one layer of ``rnn_type`` -> ([B, T, H], the LSTM's
    final (h, c), or None for the GRU and the vanilla RNN, which start
    from zero)."""
    if rnn_type == "gru":
        return gru_recurrence(x, w_ih, w_hh, b_ih, b_hh, dtype, reverse), None
    bias = None if b_ih is None else b_ih + b_hh
    if rnn_type == "rnn":
        return rnn_recurrence(x, w_ih, w_hh, bias, dtype, reverse), None
    return lstm_recurrence(x, w_ih, w_hh, bias, dtype, reverse, init_state, fused)


class _Recurrent(nn.Module):
    """A single-direction GRU or vanilla-RNN layer (torch parameter names)."""

    rnn_type = ""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None, *, reverse: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.reverse = reverse
        rows = _GATES[self.rnn_type] * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        self.weight_ih_l0 = _uniform(generator, bound, rows, input_size)
        self.weight_hh_l0 = _uniform(generator, bound, rows, hidden_size)
        if use_bias:
            self.bias_ih_l0 = _uniform(generator, bound, rows)
            self.bias_hh_l0 = _uniform(generator, bound, rows)
        else:
            self.bias_ih_l0 = self.bias_hh_l0 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _direction(self.rnn_type, x, self.weight_ih_l0, self.weight_hh_l0,
                          self.bias_ih_l0, self.bias_hh_l0, self.dtype, self.reverse, False)[0]


class GRULayer(_Recurrent):
    """Single-direction GRU layer over [B, T, D] -> [B, T, H] (gate order r, z, n)."""

    rnn_type = "gru"


class VanillaRNNLayer(_Recurrent):
    """Single-direction Elman RNN layer with tanh (torch ``nn.RNN``'s default).
    The JAX layer's single bias ``b`` is ``bias_ih_l0 + bias_hh_l0`` here."""

    rnn_type = "rnn"


class RNNStack(nn.Module):
    """Multi-layer, optionally bidirectional LSTM, GRU or vanilla-RNN stack
    over [B, T, D] (counterpart of the JAX ``RNNStack``).

    Parameters carry torch ``nn.LSTM`` / ``nn.GRU`` / ``nn.RNN``'s names
    (``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_{ih,hh}_l{k}``, and
    ``_reverse`` for the backward direction, which is the JAX layer
    ``l{k}_bwd``), so a reference ``state_dict`` loads as it is. The output
    is ``hidden * (2 if bidirectional else 1)`` wide, forward then backward.
    ``fused`` reaches the LSTM layers only, as in JAX.

    ``dropout`` > 0 drops between layers (not after the last) in
    ``train()`` mode only, keeping each element with probability 1 - p and
    scaling the kept ones by 1 / (1 - p), as flax's ``nn.Dropout``. The
    masks come from a ``torch.Generator`` of the stack, one for each device
    the stack runs on, seeded from a number drawn from ``generator`` at
    construction (only for a stack that can drop, so other stacks' weights
    do not move); they are never the flax masks.
    """

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False, dropout: float = 0.0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rnn_type not in _GATES:
            raise ValueError(f"rnn_type must be one of {sorted(_GATES)}, got {rnn_type!r}")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout!r}")
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.use_bias = use_bias
        self.dtype = dtype
        self.fused = fused
        bound = 1.0 / math.sqrt(hidden_size)
        rows = _GATES[rnn_type] * hidden_size
        for layer in range(num_layers):
            width = input_size if layer == 0 else hidden_size * (2 if bidirectional else 1)
            for suffix in self._suffixes():
                name = f"l{layer}{suffix}"
                setattr(self, f"weight_ih_{name}", _uniform(generator, bound, rows, width))
                setattr(self, f"weight_hh_{name}", _uniform(generator, bound, rows, hidden_size))
                if use_bias:
                    setattr(self, f"bias_ih_{name}", _uniform(generator, bound, rows))
                    setattr(self, f"bias_hh_{name}", _uniform(generator, bound, rows))
        self.dropout_seed = None
        if dropout > 0 and num_layers > 1:
            self.dropout_seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        self._dropout_generators = {}

    def _suffixes(self):
        return ("", "_reverse") if self.bidirectional else ("",)

    def reseed_dropout(self, seed: int) -> None:
        """Draw the dropout masks from ``seed`` from here on (a data-parallel
        rank folds its shard's index in: ``parallel/mesh.py``)."""
        self.dropout_seed = int(seed)
        self._dropout_generators.clear()

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        """The generator of the dropout masks on ``device`` (made at first use)."""
        device = torch.device(device)
        if device not in self._dropout_generators:
            self._dropout_generators[device] = torch.Generator(device=device).manual_seed(
                self.dropout_seed)
        return self._dropout_generators[device]

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=self.dropout_generator(x.device),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x: torch.Tensor, init_state=None, return_state: bool = False):
        """[B, T, D] -> [B, T, H * directions].

        LSTM stacks carry state: ``init_state`` is one (h0, c0) [B, H] per
        layer and direction, in the order of the parameters (l0,
        l0_reverse, l1, ...); ``return_state=True`` returns (output, the
        final (h, c) in that order), as a stream continues the recurrence
        from one chunk to the next (serve/streaming.py)."""
        if (init_state is not None or return_state) and self.rnn_type != "lstm":
            raise ValueError(f"carried state is for LSTM stacks, not {self.rnn_type!r}")
        out = x
        states = []
        for layer in range(self.num_layers):
            parts = []
            for suffix in self._suffixes():
                name = f"l{layer}{suffix}"
                biases = ((getattr(self, f"bias_ih_{name}"), getattr(self, f"bias_hh_{name}"))
                          if self.use_bias else (None, None))
                start = None if init_state is None else init_state[len(states)]
                seq, state = _direction(self.rnn_type, out, getattr(self, f"weight_ih_{name}"),
                                        getattr(self, f"weight_hh_{name}"), *biases, self.dtype,
                                        suffix == "_reverse", self.fused, start)
                parts.append(seq)
                states.append(state)
            out = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
            if self.training and self.dropout_seed is not None and layer < self.num_layers - 1:
                out = self._drop(out)
        return (out, states) if return_state else out


class Linear(nn.Module):
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
            self.r_trans = Linear(hidden_size, projection_dim, generator)
            self.i_trans = Linear(hidden_size, projection_dim, generator)
        else:
            self.r_trans = self.i_trans = None

    def forward(self, xr: torch.Tensor, xi: torch.Tensor, init_state=None,
                return_state: bool = False):
        """(out_r, out_i); with ``return_state``, ((out_r, out_i), state).

        The state is ((h_r, c_r), (h_i, c_i)), the real and the imaginary
        LSTM's, each [2B, H] because [xr; xi] is stacked on the batch;
        ``init_state`` takes the same (the JAX ``return_state`` stream
        mode, serve/streaming.py)."""
        batch = xr.shape[0]
        stacked = torch.cat([xr, xi], dim=0)
        state_r, state_i = (None, None) if init_state is None else init_state
        r_both, state_r = self.real_lstm(stacked, state_r)  # [Lr(xr); Lr(xi)]
        i_both, state_i = self.imag_lstm(stacked, state_i)  # [Li(xr); Li(xi)]
        out_r = r_both[:batch] - i_both[batch:]
        out_i = r_both[batch:] + i_both[:batch]
        if self.r_trans is not None:
            out_r = self.r_trans(out_r, self.dtype)
            out_i = self.i_trans(out_i, self.dtype)
        if return_state:
            return (out_r, out_i), (state_r, state_i)
        return out_r, out_i
