"""Demucs v2/v3-style time-domain separator (counterpart of
speech_enhancement_tpu/models/demucs.py).

  [B, C, T] mixture -> normalised by the mono mix's mean and std (ddof 1),
  zero-padded to ``valid_length``, 2x upsampled (``ops/resample.py``)
      -> ``depth`` encoder layers: Conv1d (k 8, stride 4) [-> GroupNorm]
         -> GELU [-> DConv] [-> 1x1 rewrite to 2 ch [-> GroupNorm] -> GLU]
      -> [a BLSTM over the bottleneck, ``lstm_layers``]
      -> ``depth`` decoder layers: + the centre-trimmed skip -> rewrite
         (k 2 context + 1) [-> GroupNorm] -> GLU [-> DConv] ->
         ConvTranspose1d (k 8, stride 4) [-> GroupNorm -> GELU]
      -> 2x downsampled, denormalised, centre-trimmed: [B, S, C, T]

DConv is the residual branch of each layer: ``dconv_depth`` x (dilated
conv to C / ``dconv_comp`` -> GroupNorm -> GELU [-> BLSTM, from layer
``dconv_lstm``] [-> LocalState attention, from layer ``dconv_attn``] -> 1x1
to 2 C -> GroupNorm -> GLU -> LayerScale), each added to the input. The
BLSTM frames a sequence longer than 200 steps into half-overlapping
windows run as one batch and stitches them back; its two bidirectional
LSTM layers (``ops/rnn.py:RNNStack``) run the recurrence kernels of
``kernels/lstm.py`` with ``fused_rnn=True`` (four forward launches a
BLSTM, and four backward launches in training) and the plain loop
without. ``lstm_layers`` adds such a BLSTM (unframed) at the bottleneck;
at configs/demucs_clarity.yaml's widths it is 2048 units, which the
kernels' wide design takes.

Activations [B, C, T]. Convs run in ``dtype``; GroupNorm (flax's: f32,
eps 1e-6) promotes to f32, and what follows it stays f32 until the next
conv, as flax's promotion has it: the BLSTMs and LocalState see f32
inputs and so compute in f32 at the shipped config; GELU is the tanh
form. ``remat`` recomputes each encoder and decoder layer in the backward
(``torch.utils.checkpoint``). ``post_init_params`` is the reference's
weight rescale (``rescale_module``), which the Solver applies on a fresh
start. Parameter names are the reference's (``encoder.{i}.{k}`` and
``decoder.{depth - 1 - i}.{k}`` in the reference Sequentials' positions,
DConv ``layers.{d}.{k}``, BLSTM ``lstm.*`` and ``linear.*``), so
``compat.demucs_state_from_jax`` and the JAX package's
``demucs_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_enhancement_torch.models.types import WAV_MULTI, SignalSpec
from speech_enhancement_torch.ops.layers import (GroupNorm, compute_dtype, conv, conv_transpose,
                                                 linear, run_conv, run_conv_transpose)
from speech_enhancement_torch.ops.resample import downsample2, upsample2
from speech_enhancement_torch.ops.rnn import RNNStack


def center_trim(tensor: torch.Tensor, length: int, dim: int = -1) -> torch.Tensor:
    """Trim ``tensor`` along ``dim`` to ``length``, centred."""
    delta = tensor.shape[dim] - length
    if delta < 0:
        raise ValueError(f"tensor ({tensor.shape[dim]}) shorter than reference ({length})")
    return tensor.narrow(dim, delta // 2, length) if delta else tensor


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


class LayerScale(nn.Module):
    """Per-channel residual rescale ``scale`` [C] over [B, C, T]."""

    def __init__(self, channels: int, init: float = 0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale[:, None] * x


class BLSTM(nn.Module):
    """Bidirectional LSTM over [B, C, T] (``layers`` layers, hidden ``dim``),
    a Linear from 2 ``dim`` back to ``dim`` in f32, and with ``skip`` the
    input added. With ``max_steps`` and T above it the sequence is framed
    into windows of ``max_steps`` at half that stride, all windows run as
    one batch, and the outputs are stitched dropping a quarter window at
    each inner boundary."""

    def __init__(self, dim: int, layers: int = 1, max_steps: Optional[int] = None,
                 skip: bool = False, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.max_steps = max_steps
        self.skip = skip
        self.lstm = RNNStack("lstm", dim, dim, num_layers=layers, bidirectional=True,
                             fused=fused, generator=generator)
        self.linear = linear(2 * dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        x = x.transpose(1, 2)  # [B, T, C]
        batch, length, channels = x.shape
        framed = self.max_steps is not None and length > self.max_steps
        if framed:
            width = self.max_steps
            stride = width // 2
            n_frames = max(1, -(-(length - width) // stride) + 1)
            total = width + (n_frames - 1) * stride
            x = F.pad(x, (0, 0, 0, total - length))
            x = x.unfold(1, width, stride).transpose(2, 3)  # [B, n_frames, width, C]
            x = x.reshape(batch * n_frames, width, channels)
        h = self.lstm(x)
        h = F.linear(h.float(), self.linear.weight, self.linear.bias)
        if framed:
            frames = h.reshape(batch, n_frames, width, self.dim)
            limit = stride // 2
            pieces = []
            for k in range(n_frames):
                lo = limit if k > 0 else 0
                hi = width - limit if k < n_frames - 1 else width
                pieces.append(frames[:, k, lo:hi])
            h = torch.cat(pieces, dim=1)[:, :length]
        h = h.transpose(1, 2)
        return h + y if self.skip else h


class LocalState(nn.Module):
    """Local attention with a learned decay, no positional embedding, over
    [B, C, T]: scores over keys t for each query s, a decay term
    -f |t - s| / sqrt(ndecay) weighted by sigmoid(query_decay) / 2, -100 on
    the diagonal, softmax over the keys; the result through ``proj`` added
    to the input. 1x1 convs in f32 (flax's promotion)."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        self.ndecay = ndecay
        self.content = conv(channels, channels, 1, generator)
        self.query = conv(channels, channels, 1, generator)
        self.key = conv(channels, channels, 1, generator)
        if ndecay:
            self.query_decay = conv(channels, heads * ndecay, 1, generator)
            with torch.no_grad():  # flax: variance_scaling(1e-4, fan_in), bias -2
                self.query_decay.weight.mul_(0.01)
                self.query_decay.bias.fill_(-2.0)
        self.proj = conv(channels, channels, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, channels, length = x.shape
        heads = self.heads
        f32 = torch.float32
        queries = run_conv(self.query, x, f32).reshape(batch, heads, -1, length)
        keys = run_conv(self.key, x, f32).reshape(batch, heads, -1, length)
        dots = torch.einsum("bhct,bhcs->bhts", keys, queries) / math.sqrt(queries.shape[2])
        if self.ndecay:
            decay_q = torch.sigmoid(run_conv(self.query_decay, x, f32).reshape(
                batch, heads, self.ndecay, length)) / 2.0
            idx = torch.arange(length, device=x.device)
            delta = (idx[:, None] - idx[None, :]).abs()
            decays = torch.arange(1, self.ndecay + 1, device=x.device)
            kernel = -decays[:, None, None] * delta[None] / math.sqrt(self.ndecay)
            dots = dots + torch.einsum("fts,bhfs->bhts", kernel.to(dots.dtype), decay_q)
        eye = torch.eye(length, dtype=torch.bool, device=x.device)
        dots = dots.masked_fill(eye, -100.0)
        weights = torch.softmax(dots, dim=2)
        content = run_conv(self.content, x, f32).reshape(batch, heads, -1, length)
        result = torch.einsum("bhts,bhct->bhcs", weights, content).reshape(batch, channels,
                                                                             length)
        return x + run_conv(self.proj, result, f32)


class DConv(nn.Module):
    """The residual branch (``layers.{d}`` in the reference Sequential's order:
    conv, GroupNorm, GELU, [BLSTM], [LocalState], 1x1, GroupNorm, GLU,
    LayerScale)."""

    def __init__(self, channels: int, compress: float = 4.0, depth: int = 2,
                 init: float = 1e-4, norm: bool = True, attn: bool = False, heads: int = 4,
                 ndecay: int = 4, lstm: bool = False, kernel: int = 3, fused_rnn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = int(channels / compress)
        self.depth = depth
        self.kernel = kernel
        layers = []
        for d in range(abs(depth)):
            dilation = 2**d if depth > 0 else 1
            mods = [conv(channels, hidden, kernel, generator, dilation=dilation),
                    GroupNorm(1, hidden) if norm else nn.Identity(), nn.GELU("tanh")]
            if lstm:
                mods.append(BLSTM(hidden, layers=2, max_steps=200, skip=True, fused=fused_rnn,
                                  generator=generator))
            if attn:
                mods.append(LocalState(hidden, heads=heads, ndecay=ndecay, generator=generator))
            mods += [conv(hidden, 2 * channels, 1, generator),
                     GroupNorm(1, 2 * channels) if norm else nn.Identity(), nn.GLU(1),
                     LayerScale(channels, init)]
            layers.append(nn.ModuleList(mods))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        for d, mods in enumerate(self.layers):
            dilation = 2**d if self.depth > 0 else 1
            pad = dilation * (self.kernel // 2)
            y = _gelu(mods[1](run_conv(mods[0], x, cd, [(pad, pad)])))
            for mod in mods[3:-4]:  # BLSTM, LocalState
                y = mod(y)
            y = mods[-3](run_conv(mods[-4], y, cd))
            x = x + mods[-1](F.glu(y, dim=1))
        return x


class Demucs(nn.Module):
    SPEC: SignalSpec = WAV_MULTI

    def __init__(self, sources: Sequence = (None, None), audio_channels: int = 2,
                 channels: int = 64, growth: float = 2.0, depth: int = 6, rewrite: bool = True,
                 lstm_layers: int = 0, kernel_size: int = 8, stride: int = 4, context: int = 1,
                 glu: bool = True, norm_starts: int = 4, norm_groups: int = 4,
                 dconv_mode: int = 1, dconv_depth: int = 2, dconv_comp: float = 4.0,
                 dconv_attn: int = 4, dconv_lstm: int = 4, dconv_init: float = 1e-4,
                 normalize: bool = True, resample: bool = True, rescale: float = 0.1,
                 dtype: str = "float32", fused_rnn: bool = False, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(fused_rnn, bool):
            raise ValueError(
                f"fused_rnn takes True or False, got {fused_rnn!r} (the kernel wrappers "
                "already pick the kernel or its plain version by device)")
        self.compute_dtype = compute_dtype(dtype)
        self.n_spk = len(sources)
        self.audio_channels = audio_channels
        self.depth = depth
        self.kernel_size = kernel_size
        self.stride = stride
        self.context = context
        self.rewrite = rewrite
        self.glu = glu
        self.norm_starts = norm_starts
        self.dconv_mode = dconv_mode
        self.normalize = normalize
        self.resample = resample
        self.rescale = rescale
        self.fused_rnn = fused_rnn
        self.remat = remat
        ch_scale = 2 if glu else 1
        enc = self.enc_channels = []
        width = channels
        for _ in range(depth):
            enc.append(width)
            width = int(growth * width)

        def norm(index: int, n_channels: int) -> nn.Module:
            return (GroupNorm(norm_groups, n_channels) if index >= norm_starts
                    else nn.Identity())

        def dconv(index: int, n_channels: int) -> nn.Module:
            return DConv(n_channels, compress=dconv_comp, depth=dconv_depth, init=dconv_init,
                         attn=index >= dconv_attn, lstm=index >= dconv_lstm,
                         fused_rnn=fused_rnn, generator=generator)

        def gate() -> nn.Module:
            return nn.GLU(1) if glu else nn.ReLU()

        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for index in range(depth):
            ch, in_ch = enc[index], enc[index - 1] if index else audio_channels
            mods = [conv(in_ch, ch, kernel_size, generator, stride=stride), norm(index, ch),
                    nn.GELU("tanh")]
            if dconv_mode & 1:
                mods.append(dconv(index, ch))
            if rewrite:
                mods += [conv(ch, ch_scale * ch, 1, generator), norm(index, ch_scale * ch), gate()]
            self.encoder.append(nn.ModuleList(mods))
            out_ch = enc[index - 1] if index else self.n_spk * audio_channels
            mods = []
            if rewrite:
                mods += [conv(ch, ch_scale * ch, 2 * context + 1, generator),
                         norm(index, ch_scale * ch), gate()]
            if dconv_mode & 2:
                mods.append(dconv(index, ch))
            mods.append(conv_transpose(ch, out_ch, kernel_size, generator, stride=stride))
            if index > 0:
                mods += [norm(index, out_ch), nn.GELU("tanh")]
            self.decoder.insert(0, nn.ModuleList(mods))
        self.lstm = (BLSTM(enc[-1], layers=lstm_layers, fused=fused_rnn, generator=generator)
                     if lstm_layers else None)

    def valid_length(self, length: int) -> int:
        """The nearest padded length the convolutions leave no remainder of."""
        if self.resample:
            length *= 2
        for _ in range(self.depth):
            length = max(1, math.ceil((length - self.kernel_size) / self.stride) + 1)
        for _ in range(self.depth):
            length = (length - 1) * self.stride + self.kernel_size
        if self.resample:
            length = math.ceil(length / 2)
        return int(length)

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        return F.glu(x, dim=1) if self.glu else F.relu(x)

    def _enc_layer(self, x: torch.Tensor, index: int) -> torch.Tensor:
        cd = self.compute_dtype
        mods = self.encoder[index]
        x = _gelu(mods[1](run_conv(mods[0], x, cd)))
        j = 3
        if self.dconv_mode & 1:
            x = mods[3](x, cd)
            j = 4
        if self.rewrite:
            x = self._gate(mods[j + 1](run_conv(mods[j], x, cd)))
        return x

    def _dec_layer(self, x: torch.Tensor, skip: torch.Tensor, index: int) -> torch.Tensor:
        cd = self.compute_dtype
        mods = self.decoder[self.depth - 1 - index]
        x = x + skip
        j = 0
        if self.rewrite:
            x = self._gate(mods[1](run_conv(mods[0], x, cd, [(self.context, self.context)])))
            j = 3
        if self.dconv_mode & 2:
            x = mods[j](x, cd)
            j += 1
        x = run_conv_transpose(mods[j], x, cd)
        if index > 0:
            x = _gelu(mods[j + 1](x))
        return x

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, S, C, T]."""
        length = mix.shape[-1]
        x = mix
        if self.normalize:
            mono = mix.mean(dim=1, keepdim=True)
            mean = mono.mean(dim=-1, keepdim=True)
            std = mono.std(dim=-1, keepdim=True, correction=1)
            x = (x - mean) / (1e-5 + std)
        delta = self.valid_length(length) - length
        x = F.pad(x, (delta // 2, delta - delta // 2))
        if self.resample:
            x = upsample2(x)
        x = x.to(self.compute_dtype)
        remat = self.remat and torch.is_grad_enabled()
        saved = []
        for index in range(self.depth):
            x = (checkpoint(self._enc_layer, x, index, use_reentrant=False) if remat
                 else self._enc_layer(x, index))
            saved.append(x)
        if self.lstm is not None:
            x = self.lstm(x)
        for index in range(self.depth - 1, -1, -1):
            skip = center_trim(saved.pop(-1), x.shape[-1])
            x = (checkpoint(self._dec_layer, x, skip, index, use_reentrant=False) if remat
                 else self._dec_layer(x, skip, index))
        x = x.float()
        if self.resample:
            x = downsample2(x)
        if self.normalize:
            x = x * std + mean
        x = center_trim(x, length)
        return x.reshape(x.shape[0], self.n_spk, self.audio_channels, x.shape[-1])

    @torch.no_grad()
    def post_init_params(self) -> None:
        """The reference's weight rescale, in place: each Conv1d and
        ConvTranspose1d weight and bias divided by sqrt(std(weight) /
        ``rescale``) (the population std; Linears and LSTMs untouched)."""
        if not self.rescale:
            return
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.ConvTranspose1d)):
                std = module.weight.std(correction=0)
                scale = torch.sqrt(torch.clamp(std / self.rescale, min=1e-8))
                module.weight.div_(scale)
                if module.bias is not None:
                    module.bias.div_(scale)
