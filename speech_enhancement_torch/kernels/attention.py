"""Multi-head attention for short sequences: CUDA wrappers and plain versions.

Counterpart of speech_enhancement_tpu/ops/pallas/attention.py
(``fused_mha_packed``, ``fused_mha``, ``_mha_fwd_call``, ``_mha_bwd_call``),
with the same contract:

* q, k, v and the output are PACKED ``[B, H * D, L]`` (dim 1 = h * D + d,
  the sequence contiguous), float32 or bfloat16, one dtype;
* ``scale`` 0.0 means ``1 / sqrt(D)``; the scores are ``(q . k) * scale``
  in f32, the softmax and ``P V`` in f32, and only the output (and each
  gradient) is rounded to the i/o dtype.

``mha_fwd`` launches ``csrc/attention_fwd.cu`` for CUDA tensors (one launch
for all sequences and heads, counted in ``mha_fwd.launches``) and runs
:func:`fused_mha_packed_plain` for CPU tensors; ``mha_bwd`` does the same
with ``csrc/attention_bwd.cu`` and :func:`mha_bwd_plain`. Any other device
raises, and there is no fallback from a kernel to its plain version: a
shape whose staging does not fit a block's shared memory raises
(:func:`mma_refuses` says which bf16 shapes). The kernel sources say what
bounds them and how they are laid out; :func:`mma_plan` mirrors the bf16
kernels' launch plan (``csrc/attention.cuh``: ``fwd_plan``, ``bwd_plan``).

:func:`fused_mha_packed` is the autograd Function :class:`FusedMHA`, which
saves q, k and v (as the JAX custom VJP does) and whose backward runs
``mha_bwd``; :func:`fused_mha` is the ``[B, H, L, D]`` adapter.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from speech_enhancement_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _scale(scale: float, depth: int) -> float:
    return scale or 1.0 / math.sqrt(depth)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, H * D, L] -> f32 [B, H, D, L]."""
    batch, hd, length = x.shape
    return x.float().reshape(batch, heads, hd // heads, length)


def _probs(qt: torch.Tensor, kt: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 probabilities [B, H, Lq, Lk] from [B, H, D, L] (``_probs``)."""
    s = torch.einsum("bhdl,bhdm->bhlm", qt, kt) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def fused_mha_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                           scale: float = 0.0) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch (``_mha_fwd_kernel``)."""
    scale = _scale(scale, q.shape[1] // heads)
    p = _probs(_heads(q, heads), _heads(k, heads), scale)
    ot = torch.einsum("bhdm,bhlm->bhdl", _heads(v, heads), p)
    return ot.reshape(q.shape).to(q.dtype)


def mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  heads: int, scale: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in PyTorch (``_mha_bwd_kernel``):
    (dq, dk, dv) packed, in q's dtype."""
    scale = _scale(scale, q.shape[1] // heads)
    qt, kt, vt, gt = (_heads(x, heads) for x in (q, k, v, g))
    p = _probs(qt, kt, scale)
    dvt = torch.einsum("bhdl,bhlm->bhdm", gt, p)
    dp = torch.einsum("bhdl,bhdm->bhlm", gt, vt)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dqt = torch.einsum("bhdm,bhlm->bhdl", kt, ds) * scale
    dkt = torch.einsum("bhdl,bhlm->bhdm", qt, ds) * scale
    return tuple(x.reshape(q.shape).to(q.dtype) for x in (dqt, dkt, dvt))


# -- CUDA -------------------------------------------------------------------

# cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100, less the 128 bytes the
# kernels keep for static shared variables (csrc/attention.cuh: STATIC_SMEM)
H100_SHARED = 232448 - 128


def _raw_bytes(depth: int, length: int) -> int:
    """Shared bytes a head block takes as a bulk copy lands it."""
    return -(-2 * depth * length // 16) * 16 + 16


def mma_plan(batch_heads: int, depth: int, length: int, backward: bool = False,
             aligned: bool = True, shared: int = H100_SHARED) -> dict:
    """The bf16 kernels' launch plan, as ``csrc/attention.cuh``'s
    ``fwd_plan`` / ``bwd_plan`` make it: the depth tile ``dp``, L padded to
    16 (``lp``), the pitch of the staged tiles, warps and threads a block,
    head blocks a block walks (``per_block``), blocks, the bytes of a
    tensor's landed head block (``raw``, 0 without bulk copies: ``aligned``
    says whether the tensors start at 16-byte addresses), the dynamic
    shared bytes and whether a warp takes two 16-row tiles at once
    (``pair``)."""
    dp = 16 if depth <= 16 else 32 if depth <= 32 else 64
    lp = -(-length // 16) * 16
    pitch, tiles = lp + 8, lp // 16
    if backward:  # q, k, v, g tiles, the f32 dQ sums [lp][dp + 8], three row statistics
        raw, warps, per_block = 0, min(tiles, 8), 8
        smem = 4 * dp * pitch * 2 + lp * (dp + 8) * 4 + 3 * lp * 4
    else:  # q (then the output), k, v tiles and, with bulk copies, their landed blocks
        tile_bytes = 3 * dp * pitch * 2
        copyable = aligned and depth * length % 8 == 0
        raw = _raw_bytes(depth, length)
        raw = raw if copyable and tile_bytes + 3 * raw <= shared else 0
        warps = min(tiles, 8) if raw else (tiles if tiles <= 8 else 4)
        per_block = 8
        smem = tile_bytes + 3 * raw
    # the forward's warps take two query tiles at once where they all have two
    pair = not backward and dp <= 32 and tiles % 2 == 0 and tiles >= 2 * warps
    return {"dp": dp, "lp": lp, "pitch": pitch, "warps": warps, "threads": 32 * warps,
            "per_block": per_block, "blocks": -(-batch_heads // per_block), "raw": raw,
            "smem": smem, "pair": pair}


def mma_refuses(batch_heads: int, depth: int, length: int, backward: bool = False,
                shared: int = H100_SHARED) -> bool:
    """Whether the bf16 kernel refuses the shape: an empty one or a depth over
    64 (cudaErrorInvalidValue), or tiles beyond a block's ``shared`` bytes
    (cudaErrorInvalidConfiguration)."""
    if batch_heads <= 0 or depth <= 0 or depth > 64 or length <= 0:
        return True
    return mma_plan(batch_heads, depth, length, backward, shared=shared)["smem"] > shared


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    "mha_fwd": ("attention_fwd", [_I] + [_P] * 4 + [_I] * 3 + [_F, _P]),
    "mha_bwd": ("attention_bwd", [_I] + [_P] * 7 + [_I] * 3 + [_F, _P]),
}


@functools.cache
def _entry(name: str):
    library, argtypes = _ENTRIES[name]
    fn = getattr(_build.library(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(what: str, heads: int, tensors) -> bool:
    """Shapes, devices and dtypes of packed tensors. True for CUDA tensors,
    False for CPU tensors; raises otherwise."""
    shape = tensors[0].shape
    if len(shape) != 3 or heads <= 0 or shape[1] % heads or 0 in shape:
        raise ValueError(f"{what}: want packed [B, H * D, L] with H = {heads}, got "
                         f"{tuple(shape)}")
    if any(t.shape != shape for t in tensors):
        raise ValueError(f"{what}: shapes differ: {[tuple(t.shape) for t in tensors]}")
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what}: tensors on {sorted({str(t.device) for t in tensors})}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {device}")
    dtype = tensors[0].dtype
    if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    return True


def _launch(name: str, tensors, heads: int, scale: float) -> None:
    like = tensors[0]
    batch, hd, length = like.shape
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        code = _entry(name)(int(like.dtype == torch.bfloat16), *(t.data_ptr() for t in tensors),
                            batch * heads, hd // heads, length, scale, stream)
    _build.check(_build.library(_ENTRIES[name][0]), code,
                 f"{name} launch (B {batch}, H {heads}, D {hd // heads}, L {length}, "
                 f"{like.dtype}; D <= 64 and the block's staging within the device's shared "
                 "memory)")


def mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
            scale: float = 0.0) -> torch.Tensor:
    """Attention output [B, H * D, L] in q's dtype. A CUDA tensor launches
    ``csrc/attention_fwd.cu`` once (counted in ``mha_fwd.launches``); a CPU
    tensor runs :func:`fused_mha_packed_plain`. Not differentiable: use
    :func:`fused_mha_packed`."""
    if not _check("mha_fwd", heads, [q, k, v]):
        return fused_mha_packed_plain(q, k, v, heads, scale)
    scale = _scale(scale, q.shape[1] // heads)
    q, k, v = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    _launch("mha_fwd", [q, k, v, out], heads, scale)
    mha_fwd.launches += 1
    return out


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, heads: int,
            scale: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) [B, H * D, L] in q's dtype for the output cotangent g. A
    CUDA tensor launches ``csrc/attention_bwd.cu`` once (counted in
    ``mha_bwd.launches``); a CPU tensor runs :func:`mha_bwd_plain`."""
    if not _check("mha_bwd", heads, [q, k, v, g]):
        return mha_bwd_plain(q, k, v, g, heads, scale)
    scale = _scale(scale, q.shape[1] // heads)
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    _launch("mha_bwd", [q, k, v, g, dq, dk, dv], heads, scale)
    mha_bwd.launches += 1
    return dq, dk, dv


mha_fwd.launches = 0
mha_bwd.launches = 0


class FusedMHA(torch.autograd.Function):
    """Packed attention with exact gradients for q, k and v, as the JAX
    custom VJP of ``fused_mha_packed``: the forward saves q, k, v, and the
    backward recomputes the probabilities in ``mha_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return mha_fwd(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, g.to(q.dtype), ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def fused_mha_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     scale: float = 0.0) -> torch.Tensor:
    """Attention over packed [B, H * D, L] tensors (dim 1 = h * D + d);
    ``scale`` 0.0 means 1 / sqrt(D). Differentiable (:class:`FusedMHA`)."""
    return FusedMHA.apply(q, k, v, heads, scale)


def _pack(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(2, 3).reshape(b, h * d, l)


def _unpack(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, hd, l = x.shape
    return x.reshape(b, heads, hd // heads, l).transpose(2, 3)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float = 0.0) -> torch.Tensor:
    """[B, H, L, D] adapter over :func:`fused_mha_packed`."""
    heads = q.shape[1]
    return _unpack(fused_mha_packed(_pack(q), _pack(k), _pack(v), heads, scale), heads)


def fused_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float = 0.0) -> torch.Tensor:
    """[B, H, L, D] adapter over :func:`fused_mha_packed_plain`."""
    heads = q.shape[1]
    return _unpack(fused_mha_packed_plain(_pack(q), _pack(k), _pack(v), heads, scale), heads)
