"""Sepformer, dual-path transformer separation (counterpart of
speech_enhancement_tpu/models/sepformer.py).

  [B, C, T] mixture
      -> encoder Conv1d (k 16, s 8, no bias) + ReLU: [B, L, N]
      -> mask net: gLN, 1x1 projection, half-overlapping chunks of K
         frames [B, S, K, N], ``masknet_numlayers`` dual blocks (an
         intra-chunk transformer stack, gLN, skip; an inter-chunk stack,
         gLN, skip), PReLU, speaker expansion, overlap-add back to [B * spks,
         L, N], tanh x sigmoid gate, 1x1 projection, ReLU masks
      -> masks times the encoding -> ConvTranspose1d decoder (k 16, s 8)
      -> [B, spks, C, T], padded or trimmed to T

Transformer layers are pre-norm (or post-norm) self-attention and a
position-wise feed-forward, with sinusoidal positions added at each
stack's input and a final LayerNorm (eps 1e-6) after it. With
``attention_type="RelPosMHAXL"`` the attention is Transformer-XL's
relative-position attention (plain PyTorch, as the JAX module is plain
einsums): no positions are added, and every layer reads the same relative
embeddings. ``intra_block`` / ``inter_block="rnn"`` replace a path's
transformer stack by a bidirectional LSTM stack (the plain loop in the
input's dtype, as the JAX block passes neither ``fused`` nor a dtype) and a
Linear back to the model width. ``remat=True`` recomputes each transformer
layer in the backward pass (``torch.utils.checkpoint``, non-reentrant),
which runs the attention kernel's forward again. ``remat_policy`` names
what JAX's ``save_only_these_names`` keeps: with ``attn_out`` in it, each
layer's attention (projections, core, out projection) runs outside the
recomputed regions, so autograd keeps its output and residuals and the
kernel's forward runs once a step; the LayerNorms and the feed-forward
around it are recomputed (pre-norm: ``norm1`` in a region of its own,
then the residual, ``norm2`` and the FFN in a second). Selective
activation checkpointing cannot express this: it sorts saves by
dispatcher op, and the attention kernel launches through ctypes, which
the dispatcher never sees. A name the model does not tag saves nothing.

Precision (``dtype="bfloat16"``) follows the flax module layer by layer:
dense layers, convolutions and attention compute in bf16 and return bf16;
``GlobalLayerNorm`` returns its input's dtype; flax's ``nn.LayerNorm`` (f32
parameters, eps 1e-6, E[x^2] - mean^2) returns f32, so the residual stream
turns f32 after the first intra stack's final norm, and the positions are
added in the stream's dtype. Parameters stay f32.

``fused_attention=True`` (the JAX default; ``"force"`` is accepted as
True) runs each attention core through ``kernels/attention.py``: the
kernels on CUDA tensors, their plain versions (the arithmetic of the JAX
``"force"`` path: f32 scores, softmax and P V) on CPU tensors. ``False``
runs the twin of flax's ``nn.MultiHeadDotProductAttention``: q divided by
sqrt(D) in the compute dtype, scores, softmax and P V in it too.

Parameter names are the reference torch Sepformer's
(``encoder.conv1d``, ``masknet.norm``, ``masknet.dual_mdl.{i}.intra_mdl.
mdl.layers.{j}.self_att.att.in_proj_weight``, ``...norm1.norm``,
``...pos_ffn.ffn.{0,3}``, ``masknet.conv2d``, ``masknet.output.0``,
``decoder``), so ``compat.sepformer_state_from_jax`` and the JAX
package's ``sepformer_from_torch_state`` map weights one to one. The
options that importer does not map are named after the reference's
speechbrain modules (``SURVEY.md``): RelPosMHAXL's ``...self_att.
in_proj_weight`` [3E, E] (q, k, v packed per head), ``self_att.linear_pos``,
``self_att.pos_bias_{u,v}`` [D, H], ``self_att.out_proj``; an RNN block's
``{intra,inter}_mdl.mdl.rnn.*_l{k}[_reverse]`` and ``{intra,inter}_linear.w``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_enhancement_torch.kernels.attention import fused_mha_packed
from speech_enhancement_torch.models.types import WAV_MULTI, SignalSpec
from speech_enhancement_torch.ops.norms import GlobalLayerNorm
from speech_enhancement_torch.ops.rnn import RNNStack, lecun_normal

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def sinusoidal_positions(length: int, d_model: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    out = np.zeros((length, d_model), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div[: (d_model + 1) // 2])
    return out


@functools.lru_cache(maxsize=None)
def relative_positions(length: int, d_model: int) -> np.ndarray:
    """Sinusoidal embeddings [2L - 1, d_model] of the offsets L-1 .. -(L-1),
    positive offsets first (the reference RelPosMHAXL's ``pos_embs``)."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    out = np.zeros((2 * length - 1, d_model), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div[: (d_model + 1) // 2])
    return out


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL's relative shift: scores [B, H, L, 2L-1] against the
    offset-ordered positions -> [B, H, L, L], where out[..., i, j] is the
    score at offset i - j."""
    b, h, qlen, pos_len = x.shape
    x = F.pad(x, (1, 0)).reshape(b, h, pos_len + 1, qlen)
    return x[:, :, 1:].reshape(b, h, qlen, pos_len)[..., : pos_len // 2 + 1]


def _segment(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, int]:
    """[B, L, N] -> half-overlapping chunks [B, S, K, N] and the end padding."""
    batch, length, features = x.shape
    p = k // 2
    gap = k - (p + length % k) % k
    x = F.pad(x, (0, 0, p, p + gap))
    first = x[:, :-p].reshape(batch, -1, k, features)
    second = x[:, p:].reshape(batch, -1, k, features)
    return torch.stack([first, second], dim=2).reshape(batch, -1, k, features), gap


def _over_add(x: torch.Tensor, gap: int) -> torch.Tensor:
    """Inverse of :func:`_segment`: [B, S, K, N] -> [B, L, N]."""
    batch, n_chunks, k, features = x.shape
    p = k // 2
    x = x.reshape(batch, n_chunks // 2, 2 * k, features)
    first = x[:, :, :k].reshape(batch, -1, features)[:, p:]
    second = x[:, :, k:].reshape(batch, -1, features)[:, :-p]
    out = first + second
    return out[:, :-gap] if gap > 0 else out


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: torch.dtype) -> torch.Tensor:
    """flax Dense (or a 1x1 conv) with ``dtype``: input, kernel and bias cast
    to it, the product rounded, then the bias added."""
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def _init(module: nn.Linear, fan_in: int, generator) -> None:
    with torch.no_grad():
        module.weight.copy_(lecun_normal(module.weight.shape, fan_in, generator))
        if module.bias is not None:
            module.bias.zero_()


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6, f32 statistics as E[x^2] - mean^2,
    f32 output) under the reference wrapper's ``.norm`` key."""

    def __init__(self, d_model: int):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (xf - mean) * (torch.rsqrt(var + self.norm.eps) * self.norm.weight) + self.norm.bias


class _AttentionParams(nn.Module):
    """The parameters of torch's ``nn.MultiheadAttention``: ``in_proj_weight``
    [3E, E] (query, key, value rows), ``in_proj_bias``, ``out_proj``."""

    def __init__(self, d_model: int, generator):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.cat(
            [lecun_normal((d_model, d_model), d_model, generator) for _ in range(3)]))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        _init(self.out_proj, d_model, generator)


def _flax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """flax ``dot_product_attention`` on [B, L, H * D] in their dtype: q / sqrt(D)
    rounded, scores, softmax (sum in f32, rounded) and P V in that dtype."""
    batch, length, embed = q.shape
    depth = embed // heads
    q, k, v = (t.reshape(batch, length, heads, depth) for t in (q, k, v))
    q = q / torch.tensor(math.sqrt(depth), dtype=q.dtype)
    s = torch.einsum("blhd,bmhd->bhlm", q, k)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(e.dtype)
    return torch.einsum("bhlm,bmhd->blhd", p, v).reshape(batch, length, embed)


class MultiheadAttention(nn.Module):
    """Self-attention of one transformer layer (flax's
    ``nn.MultiHeadDotProductAttention`` or the JAX ``_FusedMHA``, which share
    their parameters): q, k, v projections, the core, the out projection."""

    def __init__(self, d_model: int, nhead: int, fused: bool, dtype: torch.dtype, generator):
        super().__init__()
        self.nhead, self.fused, self.dtype = nhead, fused, dtype
        self.att = _AttentionParams(d_model, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att, cd = self.att, self.dtype
        x = x.to(cd)  # once for the three projections
        q, k, v = (_dense(x, w, b, cd) for w, b in zip(att.in_proj_weight.chunk(3),
                                                        att.in_proj_bias.chunk(3)))
        if self.fused:  # packed [B, H * D, L], as the JAX _FusedMHA calls the kernel
            o = fused_mha_packed(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 self.nhead, 0.0).transpose(1, 2)
        else:
            o = _flax_attention(q, k, v, self.nhead)
        return _dense(o, att.out_proj.weight, att.out_proj.bias, cd)


class RelPosMHAXL(nn.Module):
    """Transformer-XL relative-position self-attention (the JAX
    ``RelPosMHAXL``): a packed q, k, v projection without bias (split per
    head), the position projection ``linear_pos`` without bias, the learned
    content and position biases ``pos_bias_u`` / ``pos_bias_v`` [D, H], the
    relative shift, the reference's 1 / sqrt(embed_dim) scale (not per head),
    the softmax in f32 and ``out_proj``; the products in the compute dtype."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype, generator):
        super().__init__()
        head = d_model // nhead
        if head * nhead != d_model:
            raise ValueError(f"d_model {d_model} is not a multiple of {nhead} heads")
        self.nhead, self.dtype = nhead, dtype
        self.in_proj_weight = nn.Parameter(lecun_normal((3 * d_model, d_model), d_model,
                                                        generator))
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        _init(self.linear_pos, d_model, generator)
        bound = math.sqrt(6.0 / (head + nhead))  # flax xavier_uniform on [D, H]
        self.pos_bias_u = nn.Parameter(torch.empty(head, nhead).uniform_(-bound, bound,
                                                                         generator=generator))
        self.pos_bias_v = nn.Parameter(torch.empty(head, nhead).uniform_(-bound, bound,
                                                                         generator=generator))
        self.out_proj = nn.Linear(d_model, d_model)
        _init(self.out_proj, d_model, generator)

    def forward(self, x: torch.Tensor, pos_embs: torch.Tensor) -> torch.Tensor:
        """x [B, L, E], pos_embs [2L - 1, E] -> [B, L, E] in the compute dtype."""
        cd, heads = self.dtype, self.nhead
        batch, length, embed = x.shape
        qkv = _dense(x, self.in_proj_weight, None, cd).reshape(batch, length, heads, -1)
        q, k, v = qkv.chunk(3, dim=-1)  # [B, L, H, D] each
        p_k = _dense(pos_embs, self.linear_pos.weight, None, cd).reshape(-1, heads,
                                                                         embed // heads)
        content = torch.einsum("blhd,bmhd->bhlm", q + self.pos_bias_u.t().to(cd), k)
        position = _rel_shift(torch.einsum("blhd,mhd->bhlm", q + self.pos_bias_v.t().to(cd),
                                           p_k))
        score = (content + position) * (1.0 / math.sqrt(embed))
        probs = torch.softmax(score.float(), dim=-1).to(cd)
        out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(batch, length, embed)
        return _dense(out, self.out_proj.weight, self.out_proj.bias, cd)


class _FeedForward(nn.Module):
    """Position-wise feed-forward under the reference's ``ffn.{0,3}`` keys
    (its ``ffn.1`` is the activation, ``ffn.2`` a dropout of rate 0)."""

    def __init__(self, d_model: int, d_ffn: int, activation: str, dtype: torch.dtype,
                 generator):
        super().__init__()
        self.activation, self.dtype = activation, dtype
        self.ffn = nn.ModuleList([nn.Linear(d_model, d_ffn), nn.Identity(), nn.Identity(),
                                  nn.Linear(d_ffn, d_model)])
        _init(self.ffn[0], d_model, generator)
        _init(self.ffn[3], d_ffn, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _dense(x, self.ffn[0].weight, self.ffn[0].bias, self.dtype)
        # flax's nn.gelu is the tanh approximation
        h = F.gelu(h, approximate="tanh") if self.activation == "gelu" else F.relu(h)
        return _dense(h, self.ffn[3].weight, self.ffn[3].bias, self.dtype)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm (``norm_before``) or post-norm self-attention + feed-forward."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, norm_before: bool = True,
                 fused_attention: bool = True, ffn_activation: str = "relu",
                 dtype: torch.dtype = torch.float32, attention_type: str = "regularMHA",
                 generator=None):
        super().__init__()
        if ffn_activation not in ("relu", "gelu"):
            raise ValueError(f"ffn_activation must be relu or gelu, got {ffn_activation!r}")
        self.norm_before = norm_before
        self.relative = attention_type == "RelPosMHAXL"
        self.self_att = (RelPosMHAXL(d_model, nhead, dtype, generator) if self.relative else
                         MultiheadAttention(d_model, nhead, fused_attention, dtype, generator))
        self.pos_ffn = _FeedForward(d_model, d_ffn, ffn_activation, dtype, generator)
        self.norm1 = _LayerNorm(d_model)
        self.norm2 = _LayerNorm(d_model)

    def _attend(self, x: torch.Tensor, pos_embs: Optional[torch.Tensor]) -> torch.Tensor:
        return self.self_att(x, pos_embs) if self.relative else self.self_att(x)

    def finish(self, x: torch.Tensor, attn_out: torch.Tensor) -> torch.Tensor:
        """The layer after its attention output (JAX's ``attn_out``): the
        residual, the norms and the feed-forward."""
        if self.norm_before:
            x = x + attn_out
            return x + self.pos_ffn(self.norm2(x))
        x = self.norm1(x + attn_out)
        return self.norm2(x + self.pos_ffn(x))

    def forward(self, x: torch.Tensor, pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.finish(x, self._attend(self.norm1(x) if self.norm_before else x, pos_embs))

    def recomputed(self, x: torch.Tensor, pos_embs: Optional[torch.Tensor],
                   names: frozenset) -> torch.Tensor:
        """The layer recomputed in backward under the named saves ``names``."""
        if "attn_out" not in names:
            return checkpoint(self, x, pos_embs, use_reentrant=False)
        h = checkpoint(self.norm1, x, use_reentrant=False) if self.norm_before else x
        return checkpoint(self.finish, x, self._attend(h, pos_embs), use_reentrant=False)


class _TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 fused_attention: bool, dtype: torch.dtype, attention_type: str, generator):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, nhead, d_ffn, fused_attention=fused_attention,
                                    dtype=dtype, attention_type=attention_type,
                                    generator=generator)
            for _ in range(num_layers)])
        self.norm = _LayerNorm(d_model)


class SBTransformerBlock(nn.Module):
    """A stack of pre-norm transformer layers over [B', L, N]: sinusoidal
    positions added in the input's dtype (or, with RelPosMHAXL, relative
    embeddings handed to every layer), the layers, each recomputed in the
    backward pass with ``remat`` under the named saves of
    ``remat_policy``, then the final LayerNorm (eps 1e-6)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int = 2048,
                 fused_attention: bool = True, dtype: torch.dtype = torch.float32,
                 attention_type: str = "regularMHA", remat: bool = False,
                 remat_policy: str = "", generator=None):
        super().__init__()
        self.relative = attention_type == "RelPosMHAXL"
        self.remat = remat
        self.remat_names = frozenset(str(remat_policy).split(","))
        self.mdl = _TransformerEncoder(num_layers, d_model, nhead, d_ffn, fused_attention, dtype,
                                       attention_type, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos_embs = None
        if self.relative:
            pos_embs = torch.from_numpy(relative_positions(x.shape[1], x.shape[2])).to(x.device)
        else:
            pos = torch.from_numpy(sinusoidal_positions(x.shape[1], x.shape[2]))
            x = x + pos.to(device=x.device, dtype=x.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.mdl.layers:
            x = layer.recomputed(x, pos_embs, self.remat_names) if remat else layer(x, pos_embs)
        return self.mdl.norm(x)


class _RNN(nn.Module):
    """The reference's speechbrain RNN wrapper, whose torch module is ``.rnn``."""

    def __init__(self, rnn: RNNStack):
        super().__init__()
        self.rnn = rnn


class SBRNNBlock(nn.Module):
    """A (bi)directional LSTM stack over [B', L, N] (the JAX ``SBRNNBlock``),
    in its input's dtype, under the reference's ``mdl.rnn`` keys."""

    def __init__(self, input_size: int, hidden: int, num_layers: int, bidirectional: bool,
                 generator=None):
        super().__init__()
        self.mdl = _RNN(RNNStack("lstm", input_size, hidden, num_layers=num_layers,
                                 bidirectional=bidirectional, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mdl.rnn(x)


class _SBLinear(nn.Module):
    """The reference's speechbrain Linear wrapper, whose torch module is ``.w``."""

    def __init__(self, in_features: int, out_features: int, generator):
        super().__init__()
        self.w = nn.Linear(in_features, out_features)
        _init(self.w, in_features, generator)


class DualComputationBlock(nn.Module):
    """Intra-chunk then inter-chunk paths over [B, S, K, N], each a
    transformer stack or an RNN block and its Linear, followed by a gLN and a
    skip (the intra one optional)."""

    def __init__(self, d_model: int, intra_layers: int, inter_layers: int, intra_nhead: int,
                 inter_nhead: int, intra_dffn: int, inter_dffn: int,
                 intra_block: str = "transformer", inter_block: str = "transformer",
                 rnn_hidden: int = 256, rnn_bidirectional: bool = True,
                 attention_type: str = "regularMHA", fused_attention: bool = True,
                 remat: bool = False, remat_policy: str = "", skip_around_intra: bool = True,
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.skip_around_intra = skip_around_intra
        self.dtype = dtype
        rnn_width = rnn_hidden * (2 if rnn_bidirectional else 1)

        def path(block, layers, nhead, dffn):
            if block == "rnn":
                return (SBRNNBlock(d_model, rnn_hidden, layers, rnn_bidirectional, generator),
                        _SBLinear(rnn_width, d_model, generator))
            return SBTransformerBlock(layers, d_model, nhead, dffn,
                                      fused_attention=fused_attention, dtype=dtype,
                                      attention_type=attention_type, remat=remat,
                                      remat_policy=remat_policy, generator=generator), None

        self.intra_mdl, self.intra_linear = path(intra_block, intra_layers, intra_nhead,
                                                 intra_dffn)
        self.inter_mdl, self.inter_linear = path(inter_block, inter_layers, inter_nhead,
                                                 inter_dffn)
        self.intra_norm = GlobalLayerNorm(d_model)
        self.inter_norm = GlobalLayerNorm(d_model)

    def _path(self, x: torch.Tensor, mdl: nn.Module, linear: Optional[_SBLinear]
              ) -> torch.Tensor:
        h = mdl(x)
        return h if linear is None else _dense(h, linear.w.weight, linear.w.bias, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, n_chunks, k, features = x.shape
        intra = self._path(x.reshape(batch * n_chunks, k, features), self.intra_mdl,
                           self.intra_linear)
        intra = self.intra_norm(intra.reshape(batch, n_chunks, k, features))
        if self.skip_around_intra:
            intra = intra + x
        inter = intra.transpose(1, 2).reshape(batch * k, n_chunks, features)
        inter = self._path(inter, self.inter_mdl, self.inter_linear)
        inter = inter.reshape(batch, k, n_chunks, features).transpose(1, 2)
        return self.inter_norm(inter) + intra


class _PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


def _conv1x1(c_in: int, c_out: int, bias: bool, generator) -> nn.Conv1d:
    conv = nn.Conv1d(c_in, c_out, 1, bias=bias)
    _init(conv, c_in, generator)
    return conv


class _MaskNet(nn.Module):
    def __init__(self, d_model: int, n_spk: int, n_blocks: int, block_kwargs: dict,
                 dtype: torch.dtype, generator):
        super().__init__()
        self.norm = GlobalLayerNorm(d_model)
        self.conv1d = _conv1x1(d_model, d_model, False, generator)
        self.dual_mdl = nn.ModuleList([
            DualComputationBlock(d_model, **block_kwargs, dtype=dtype, generator=generator)
            for _ in range(n_blocks)])
        self.prelu = _PReLU()
        self.conv2d = nn.Conv2d(d_model, d_model * n_spk, 1)
        _init(self.conv2d, d_model, generator)
        self.output = nn.ModuleList([_conv1x1(d_model, d_model, True, generator)])
        self.output_gate = nn.ModuleList([_conv1x1(d_model, d_model, True, generator)])
        self.end_conv1x1 = _conv1x1(d_model, d_model, False, generator)


class _Encoder(nn.Module):
    def __init__(self, c_in: int, d_model: int, kernel: int, generator):
        super().__init__()
        self.conv1d = nn.Conv1d(c_in, d_model, kernel, stride=kernel // 2, bias=False)
        _init(self.conv1d, kernel * c_in, generator)


class Sepformer(nn.Module):
    SPEC: SignalSpec = WAV_MULTI

    def __init__(self, encoder_kernel_size: int = 16, encoder_in_nchannels: int = 1,
                 encoder_out_nchannels: int = 256, masknet_chunksize: int = 250,
                 masknet_numlayers: int = 2, masknet_numspks: int = 2,
                 masknet_extraskipconnection: bool = True, intra_numlayers: int = 8,
                 inter_numlayers: int = 8, intra_nhead: int = 8, inter_nhead: int = 8,
                 intra_dffn: int = 1024, inter_dffn: int = 1024,
                 attention_type: str = "regularMHA", intra_block: str = "transformer",
                 inter_block: str = "transformer", rnn_hidden: int = 256,
                 rnn_bidirectional: bool = True, dtype: str = "float32", remat: bool = False,
                 remat_policy: str = "", fused_attention=True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention_type not in ("regularMHA", "RelPosMHAXL"):
            raise ValueError(f"unknown attention_type {attention_type!r}")
        if {intra_block, inter_block} - {"transformer", "rnn"}:
            raise ValueError(f"unknown block types {intra_block!r}, {inter_block!r}")
        if fused_attention not in (True, False, "force"):
            raise ValueError(f"fused_attention takes True, False or 'force', got "
                             f"{fused_attention!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.compute_dtype = _DTYPES[dtype]
        self.fused_attention = bool(fused_attention)
        self.kernel_size = encoder_kernel_size
        self.in_channels = encoder_in_nchannels
        self.d_model = encoder_out_nchannels
        self.chunk = masknet_chunksize
        self.num_spk = masknet_numspks
        self.encoder = _Encoder(encoder_in_nchannels, encoder_out_nchannels, encoder_kernel_size,
                                generator)
        block_kwargs = dict(intra_layers=intra_numlayers, inter_layers=inter_numlayers,
                            intra_nhead=intra_nhead, inter_nhead=inter_nhead,
                            intra_dffn=intra_dffn, inter_dffn=inter_dffn,
                            intra_block=intra_block, inter_block=inter_block,
                            rnn_hidden=rnn_hidden, rnn_bidirectional=rnn_bidirectional,
                            attention_type=attention_type, fused_attention=self.fused_attention,
                            remat=remat, remat_policy=remat_policy,
                            skip_around_intra=masknet_extraskipconnection)
        self.masknet = _MaskNet(encoder_out_nchannels, masknet_numspks, masknet_numlayers,
                                block_kwargs, self.compute_dtype, generator)
        self.decoder = nn.ConvTranspose1d(encoder_out_nchannels, encoder_in_nchannels,
                                          encoder_kernel_size, stride=encoder_kernel_size // 2,
                                          bias=False)
        _init(self.decoder, encoder_kernel_size * encoder_out_nchannels, generator)

    # -- stages (forward composes them; chip_smoke.py times each) ----------
    def encode(self, mix: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> ReLU(Conv1d) [B, L, N] in the compute dtype."""
        cd = self.compute_dtype
        w = F.conv1d(mix.to(cd), self.encoder.conv1d.weight.to(cd), stride=self.kernel_size // 2)
        return F.relu(w.transpose(1, 2))

    def mask(self, mix_w: torch.Tensor) -> torch.Tensor:
        """Encoding [B, L, N] -> speaker masks [B, spks, L, N]."""
        net, cd = self.masknet, self.compute_dtype
        batch, d_model, n_spk = mix_w.shape[0], self.d_model, self.num_spk
        h = _dense(net.norm(mix_w), net.conv1d.weight[:, :, 0], None, cd)
        h, gap = _segment(h, self.chunk)
        for block in net.dual_mdl:
            h = block(h)
        h = net.prelu(h)
        h = _dense(h, net.conv2d.weight[:, :, 0, 0], net.conv2d.bias, cd)  # [B, S, K, N*spks]
        b, s_chunks, k, _ = h.shape
        h = h.reshape(b, s_chunks, k, n_spk, d_model).permute(0, 3, 1, 2, 4)
        h = _over_add(h.reshape(b * n_spk, s_chunks, k, d_model), gap)  # [B*spks, L, N]
        gate = torch.sigmoid(_dense(h, net.output_gate[0].weight[:, :, 0],
                                    net.output_gate[0].bias, cd))
        h = torch.tanh(_dense(h, net.output[0].weight[:, :, 0], net.output[0].bias, cd)) * gate
        h = _dense(h, net.end_conv1x1.weight[:, :, 0], None, cd)
        return F.relu(h).reshape(batch, n_spk, -1, d_model)

    def decode(self, mix_w: torch.Tensor, mask: torch.Tensor, length: int) -> torch.Tensor:
        """Masked encodings -> ConvTranspose1d waveforms [B, spks, C, length] f32."""
        cd = self.compute_dtype
        batch = mix_w.shape[0]
        sep = (mix_w[:, None] * mask).reshape(batch * self.num_spk, -1, self.d_model)
        wav = F.conv_transpose1d(sep.transpose(1, 2).to(cd), self.decoder.weight.to(cd),
                                 stride=self.kernel_size // 2)
        wav = wav.float().reshape(batch, self.num_spk, self.in_channels, -1)
        if length > wav.shape[-1]:
            wav = F.pad(wav, (0, length - wav.shape[-1]))
        return wav[..., :length]

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> separated sources [B, spks, C, T]."""
        mix_w = self.encode(mix)
        return self.decode(mix_w, self.mask(mix_w), mix.shape[-1])
