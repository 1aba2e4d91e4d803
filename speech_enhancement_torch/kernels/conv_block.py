"""Fused DCCRN conv-block kernels: CUDA wrappers and plain versions.

Counterpart of speech_enhancement_tpu/ops/pallas/experimental/conv_block.py
(``fused_conv_block``, ``fused_deconv_block``), with the same signatures and
activation layout: ``[B, F * C2, T]``, frequency-major, the channels of a
frequency row stacked ``[r..., i...]``, time contiguous. Each block computes

    z = PReLU(a_diag * x + a_cross * partner(x) + c0)   (folded complex BN)
    y = complex conv (encoder) or transposed conv with the skip join
        (decoder) of z, + bias

and, with ``with_stats``, per-row partial sums ``[B, R_out, 8]`` f32 (lanes
sum y, sum y^2, sum y*partner, then zeros) of the f32 result before it is
rounded, for :func:`ops.complex_ops.stats_from_partials`. The kernels are
``csrc/conv_block.cu`` and ``csrc/deconv_block.cu``; their sources say what
bounds them and how they are tiled.

Rounding, as in the JAX kernels: the coefficients are rounded to the
activation dtype, the pointwise runs in f32 and its result is rounded to
the activation dtype; the convolution accumulates in f32, adds the f32 bias
and rounds once.

``fused_conv_block`` / ``fused_deconv_block`` run their plain versions for
CPU tensors and launch the kernels for CUDA tensors; any other device
raises. There is no fallback from a kernel to its plain version. The plain
versions are differentiable; the kernel wrappers are not, so their CUDA
branch raises when autograd would need a backward.

Training goes through :func:`conv_block_train` / :func:`deconv_block_train`
(counterparts of the JAX custom VJPs of the same names): autograd Functions
whose forward is the block kernel with stats and whose backward runs four
more kernels, ``csrc/conv_block_bwd.cu`` (``enc_bwd_gz``, ``enc_bwd_dw``)
and ``csrc/deconv_block_bwd.cu`` (``dec_bwd_gz``, ``dec_bwd_dw``), for the
input and weight gradients of the convolution; the stats cotangent, the
bias gradient and the pointwise backward (``pointwise_bwd``) are plain
PyTorch in f32, as they are XLA in JAX. Each backward wrapper runs its
plain version (``*_plain``) on CPU tensors, as the forward ones do. The
stats -> coefficients -> next block chain stays ordinary autograd outside
the Functions, so the complex-BN backward composes as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from speech_enhancement_torch.kernels import _build
from speech_enhancement_torch.ops.complex_conv import (complex_cat, complex_conv,
                                                       complex_deconv, conv_from_hwio,
                                                       deconv_from_hwio, hwio_from_conv,
                                                       hwio_from_deconv)

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Alpha = Union[torch.Tensor, float]
_BK = 16  # input channels per K step of the kernels (csrc/block_gemm.cuh)


def identity_coeffs(c2: int, device=None) -> Coeffs:
    """Pass-through pointwise: (ones, zeros, zeros) f32 over ``c2`` channels."""
    return (torch.ones(c2, device=device), torch.zeros(c2, device=device),
            torch.zeros(c2, device=device))


def swap_parts(a: torch.Tensor) -> torch.Tensor:
    """partner() over [B, F, C2, ...]: swap the stacked r / i channel halves."""
    c = a.shape[2] // 2
    return torch.cat([a[:, :, c:], a[:, :, :c]], dim=2)


def pointwise(x: torch.Tensor, a_diag, a_cross, c0, alpha: Alpha) -> torch.Tensor:
    """``PReLU(a_diag*x + a_cross*partner(x) + c0)`` on [B, F, C2, T], in f32."""
    x = x.float()
    view = (1, 1, -1, 1)
    z = (a_diag.float().view(view) * x + a_cross.float().view(view) * swap_parts(x)
         + c0.float().view(view))
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    return torch.where(z >= 0, z, alpha * z)


def _prologue(x: torch.Tensor, f: int, c2: int, coef: Coeffs, alpha: Alpha) -> torch.Tensor:
    """[B, f * c2, T] -> activated [B, c2, f, T] in f32, rounded as the kernels round."""
    batch, _, n_time = x.shape
    coef = [v.to(x.dtype) for v in coef]
    z = pointwise(x.view(batch, f, c2, n_time), *coef, alpha).to(x.dtype)
    return z.float().permute(0, 2, 1, 3)


def _epilogue(y: torch.Tensor, dtype: torch.dtype, with_stats: bool):
    """f32 conv output [B, C2out, F, T] -> [B, F * C2out, T] in ``dtype``
    (and the per-row stats partials of the f32 values)."""
    batch, c2out, f_out, n_time = y.shape
    y = y.permute(0, 2, 1, 3)  # [B, F, C2out, T]
    out = y.to(dtype).reshape(batch, f_out * c2out, n_time)
    if not with_stats:
        return out
    sums = torch.stack([y.sum(-1), (y * y).sum(-1), (y * swap_parts(y)).sum(-1)], dim=-1)
    partials = F.pad(sums, (0, 5)).reshape(batch, f_out * c2out, 8)
    return out, partials


def fused_conv_block_plain(x, w2, b2, a_diag, a_cross, c0, alpha, *, f_in: int, c2in: int,
                           c2out: int, with_stats: bool = False):
    """The encoder block with PyTorch ops: the prologue, then the DCCRN
    encoder's own convolution (``ops/complex_conv.py:complex_conv``) in f32."""
    z = _prologue(x, f_in, c2in, (a_diag, a_cross, c0), alpha)
    kernel = conv_from_hwio(w2.to(x.dtype).float())
    return _epilogue(complex_conv(z, kernel, b2.float()), x.dtype, with_stats)


def fused_deconv_block_plain(x, skip, w2, b2, coef_x: Coeffs, alpha_x: Alpha, coef_s: Coeffs,
                             alpha_s: Alpha, *, f_in: int, c2x: int, c2s: int, c2out: int,
                             with_stats: bool = False):
    """The decoder block with PyTorch ops: both prologues, the skip join and
    the DCCRN decoder's own transposed convolution in f32."""
    zx = _prologue(x, f_in, c2x, coef_x, alpha_x)
    zs = _prologue(skip, f_in, c2s, coef_s, alpha_s)
    kernel = deconv_from_hwio(w2.to(x.dtype).float())
    y = complex_deconv(complex_cat(zx, zs), kernel, b2.float())
    return _epilogue(y, x.dtype, with_stats)


# -- CUDA -------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_REGION = [_P, _P, _P, _I, _I]
# C entry point -> (library, argument types); every entry point ends with
# the stream and returns cudaGetLastError()
_ENTRIES = {
    "conv_block": ("conv_block", [_I] + _REGION + [_P] * 3 + [_I] * 7 + [_P]),
    "deconv_block": ("deconv_block", [_I] + _REGION * 2 + [_P] * 3 + [_I] * 7 + [_P]),
    "enc_bwd_gz": ("conv_block_bwd", [_I, _P, _P, _I, _I, _P] + [_I] * 7 + [_P]),
    "enc_bwd_dw": ("conv_block_bwd", [_I, _P, _P, _P] + [_I] * 8 + [_P]),
    "dec_bwd_gz": ("deconv_block_bwd", [_I, _P, _P, _I, _I, _P, _I, _P] + [_I] * 6 + [_P]),
    "dec_bwd_dw": ("deconv_block_bwd", [_I, _P, _I, _P, _I, _P, _P] + [_I] * 7 + [_P]),
}


@functools.cache
def _entry(name: str):
    library, argtypes = _ENTRIES[name]
    fn = getattr(_build.library(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(what: str, acts: Sequence[torch.Tensor], rest: Sequence) -> None:
    x = acts[0]
    tensors = [t for t in list(acts) + list(rest) if isinstance(t, torch.Tensor)]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: tensors on {sorted({str(t.device) for t in tensors})}")
    if any(a.dtype not in (torch.float32, torch.bfloat16) or a.dtype != x.dtype for a in acts):
        raise TypeError(f"{what} takes float32 or bfloat16 activations of one dtype, got "
                        f"{[a.dtype for a in acts]}")
    if any(not a.is_contiguous() for a in acts):
        raise ValueError(f"{what} takes contiguous activations")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward of its own: run it under torch.no_grad() / "
            "torch.inference_mode(), or train through conv_block_train / deconv_block_train")


def _pack_coeffs(coef: Coeffs, alpha: Alpha, dtype: torch.dtype, device) -> torch.Tensor:
    """[3 * C2 + 1] f32: the coefficients rounded to ``dtype``, then alpha."""
    parts = [v.to(dtype).float().reshape(-1) for v in coef]
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device).reshape(1)
    return torch.cat(parts + [alpha]).contiguous()


def _pack_weights(w: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """HWIO [5, 2, C2r, C2out] -> the kernel's [5, 2, C2out, kp] (input
    channels contiguous, zero-padded to a multiple of the K step)."""
    c2r = w.shape[2]
    kp = -(-c2r // _BK) * _BK
    return F.pad(w.permute(0, 1, 3, 2).to(dtype), (0, kp - c2r)).contiguous(), kp


def block_tile(m: int) -> Tuple[int, int]:
    """(BM, NB) of the bf16 block kernels (``csrc/block_mma.cuh``) for a
    GEMM of ``m`` output channels (twice the channels with row pairs): BM
    channels x NB segments of 64 frames, each a batch item, so that every
    staged weight step serves 128 or 256 frames. 128 x 2 from 128 channels,
    64 x 2 from 64, else 32 x 4 or 16 x 4, whose eight warps take 32 frames
    each. Measured with tools/block_phase_probe.py --sweep at T 643: the
    best of the four tiles at all twelve decoder launches (B 128 / 192) and
    at all twelve encoder launches (rows 3 and 5, B 192 / 128; e.g. enc1's
    forward 2.28 ms against 3.13 to 3.89 on the other tiles, enc4's input
    gradient 2.34 against 3.20 to 6.86)."""
    if m >= 128:
        return 128, 2
    if m >= 64:
        return 64, 2
    return (32, 4) if m >= 32 else (16, 4)


def block_pair(m: int) -> bool:
    """Whether a bf16 block kernel with a GEMM of ``m`` output channels
    computes output rows 2r and 2r + 1 in one block (``csrc/block_mma.cuh``,
    kPair): the input rows they share are staged and activated once for
    both (the decoder block and the encoder's input gradient: 40% fewer
    stages a row, the odd row's first tap empty; the encoder block: 30%
    fewer stages, 40% more products). For m <= 64, where the stages, not
    the products, bound the kernel. Measured with tools/block_phase_probe.py
    --sweep at T 643, each block's best tile with and without: the decoder
    block (B 192) dec2 to dec5 19 to 38% faster, dec0 and dec1 16 to 18%
    slower; the encoder block (B 192) enc0 21% and enc2 8% faster, enc1 even,
    enc3 to enc5 22% slower; its input gradient (B 128) enc0 40%, enc1 23%,
    enc2 2% and enc3 12% faster, enc4 and enc5 18% slower. The decoder's
    input gradient (row 7, the encoder indexing) takes no pairs."""
    return m <= 64


def _pack_mma_weights(w: torch.Tensor, bm: int, dtype: torch.dtype, pair: bool = False,
                      decoder: bool = True) -> Tuple[torch.Tensor, int]:
    """HWIO [5, 2, K, M] (input and output channels each stacked [r...,
    i...]) -> ``csrc/block_mma.cuh``'s [m_tiles, taps, kp / 16, 2, bm, 16]:
    for each tile of bm rows (bm / 2 real output channels, then their
    imaginary partners), tap and k16 step, both time taps' rows of 16
    slots, slot 2p + h holding input channel h * K / 2 + 8 step + p (pairs
    interleaved; zero past K / 2 pairs and past the last output channel).
    With ``pair`` (row pairs) the tile's two halves are the even and the
    odd output row, each bm / 4 real channels and their partners, and the
    taps are the input rows d of a pair: on the ``decoder`` indexing d = 0,
    1, 2 with jf = 2 d for the even row, 2 d - 1 for the odd (none for d =
    0); on the encoder's d = 0..6 with jf = d for the even row, d - 2 for
    the odd. Returns it with kp = 16 ceil(K / 16)."""
    k, m = w.shape[2], w.shape[3]
    c, half = k // 2, m // 2
    nks = -(-c // 8)
    rows = bm // 4 if pair else bm // 2  # channels a tile, each part
    m_tiles = -(-half // rows)
    wt = w.to(dtype).permute(0, 1, 3, 2)  # [5, 2, M, K]
    # (tap, parity, HWIO tap) of the kernel's K walk
    if not pair:
        taps = [(jf, 0, jf) for jf in range(5)]
    elif decoder:
        taps = [(d, parity, 2 * d - parity) for d in range(3) for parity in range(2)
                if 2 * d - parity >= 0]
    else:
        taps = [(d, parity, d - 2 * parity) for d in range(7) for parity in range(2)
                if 0 <= d - 2 * parity < 5]
    n_taps = 1 + max(tap for tap, _, _ in taps)
    halves = 2 if pair else 1
    out = wt.new_zeros((n_taps, 2, halves, 2, m_tiles * rows, nks * 8, 2))  # [tap, jt, parity,
    for tap, parity, jf in taps:                                             #  part, j, pair, h]
        for part in range(2):
            for h in range(2):
                out[tap, :, parity, part, :half, :c, h] = wt[jf, :, part * half:(part + 1) * half,
                                                             h * c:(h + 1) * c]
    out = out.view(n_taps, 2, halves, 2, m_tiles, rows, nks, 16)
    # -> [tile, tap, step, jt, parity, part, r, slot]
    out = out.permute(4, 0, 6, 1, 2, 3, 5, 7).reshape(m_tiles, n_taps, nks, 2, bm, 16)
    return out.contiguous(), 16 * nks


def _outputs(x: torch.Tensor, rows: int, with_stats: bool):
    batch, _, n_time = x.shape
    y = torch.empty((batch, rows, n_time), dtype=x.dtype, device=x.device)
    stats = (torch.zeros((batch, rows, 8), dtype=torch.float32, device=x.device)
             if with_stats else None)
    return y, stats


def _launch(name: str, args: list, x: torch.Tensor) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _entry(name)(*args, stream)
    _build.check(_build.library(_ENTRIES[name][0]), code, f"{name} launch")


def _check_shapes(x: torch.Tensor, f_in: int, c2: int, what: str) -> None:
    if x.dim() != 3 or x.shape[1] != f_in * c2:
        raise ValueError(f"{what}: want [B, {f_in} * {c2}, T], got {tuple(x.shape)}")


def fused_conv_block(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, a_diag, a_cross, c0,
                     alpha: Alpha, *, f_in: int, c2in: int, c2out: int,
                     with_stats: bool = False):
    """``PReLU(CBN_fold(x))`` then the stride-(2, 1) complex conv, one pass.

    x: [B, f_in * c2in, T]; w2: [5, 2, c2in, c2out] block-matrix kernel
    (HWIO, as the JAX package's); b2: [c2out]; (a_diag, a_cross, c0): folded
    coefficients of the input channels (identity for the first block);
    alpha: the input's PReLU slope (1 = none). Returns y [B, f_in/2 * c2out,
    T] in x's dtype, and with ``with_stats`` the partials [B, f_in/2 *
    c2out, 8] f32. A CUDA tensor launches ``csrc/conv_block.cu`` (counted in
    ``fused_conv_block.launches``), a CPU tensor runs the plain version.
    """
    _check_shapes(x, f_in, c2in, "fused_conv_block")
    if w2.shape != (5, 2, c2in, c2out) or b2.shape != (c2out,):
        raise ValueError(f"fused_conv_block: w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if x.device.type == "cpu":
        return fused_conv_block_plain(x, w2, b2, a_diag, a_cross, c0, alpha, f_in=f_in,
                                      c2in=c2in, c2out=c2out, with_stats=with_stats)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_block runs on cuda or cpu tensors, not {x.device}")
    _check_cuda("fused_conv_block", [x], [w2, b2, a_diag, a_cross, c0, alpha])
    args, (y, stats), _keep = _conv_block_args(x, w2, b2, a_diag, a_cross, c0, alpha, f_in,
                                               c2in, c2out, with_stats)
    _launch("conv_block", args, x)
    fused_conv_block.launches += 1
    return (y, stats) if with_stats else y


def _conv_block_args(x, w2, b2, a_diag, a_cross, c0, alpha, f_in, c2in, c2out, with_stats,
                     tile=None, pair=None):
    """The arguments of ``csrc/conv_block.cu:conv_block`` but the stream,
    its outputs (y, stats or None) and the packed operands they point to.
    bf16 packs the weights for row pairs where ``block_pair`` says so and
    the f_in / 2 output rows pair up (or ``pair``) and for the tile
    ``block_tile`` picks for the GEMM's rows (or ``tile``), f32 as
    ``block_gemm.cuh`` takes them."""
    bf16 = x.dtype == torch.bfloat16
    pair = bf16 and (block_pair(c2out) and f_in % 4 == 0 if pair is None else pair)
    bm, nb = (tile or block_tile(2 * c2out if pair else c2out)) if bf16 else (0, 0)
    w, kp = (_pack_mma_weights(w2, bm, x.dtype, pair, decoder=False) if bf16 else
             _pack_weights(w2, x.dtype))
    coef = _pack_coeffs((a_diag, a_cross, c0), alpha, x.dtype, x.device)
    bias = b2.float().contiguous()
    y, stats = _outputs(x, f_in // 2 * c2out, with_stats)
    batch, _, n_time = x.shape
    args = [int(bf16), x.data_ptr(), coef.data_ptr(), w.data_ptr(), c2in, kp, bias.data_ptr(),
            y.data_ptr(), stats.data_ptr() if with_stats else None, batch, f_in, c2out, n_time,
            bm, nb, int(pair)]
    return args, (y, stats), (w, coef, bias)


def _joined_rows(c2x: int, c2s: int) -> Tuple[list, list]:
    """Positions of the trunk's and the skip's channels, each in its own
    [r..., i...] order, in the joined order [xr, sr, xi, si]."""
    cx, cs = c2x // 2, c2s // 2
    x_rows = list(range(cx)) + list(range(cx + cs, 2 * cx + cs))
    s_rows = list(range(cx, cx + cs)) + list(range(2 * cx + cs, 2 * cx + 2 * cs))
    return x_rows, s_rows


def _split_joined(w2: torch.Tensor, c2x: int, c2s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joined-input rows [xr, sr, xi, si] of w2 -> (trunk rows, skip rows),
    each in its own [r..., i...] order. Slices, not an index list: indexing
    a CUDA tensor with a list copies the list to the card and waits for it."""
    cx, cs = c2x // 2, c2s // 2
    return (torch.cat([w2[:, :, :cx], w2[:, :, cx + cs:2 * cx + cs]], dim=2),
            torch.cat([w2[:, :, cx:cx + cs], w2[:, :, 2 * cx + cs:]], dim=2))


def fused_deconv_block(x: torch.Tensor, skip: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       coef_x: Coeffs, alpha_x: Alpha, coef_s: Coeffs, alpha_s: Alpha, *,
                       f_in: int, c2x: int, c2s: int, c2out: int, with_stats: bool = False):
    """Decoder block: both pointwise prologues, the skip join and the
    stride-2 transposed complex conv, one pass; the join is never stored.

    x: [B, f_in * c2x, T]; skip: [B, f_in * c2s, T]; w2: [5, 2, c2x + c2s,
    c2out], the ``lax.conv_transpose`` HWIO kernel with joined input order
    [xr, sr, xi, si]; coef_x / coef_s: (a_diag, a_cross, c0) of each input.
    Returns y [B, 2 f_in * c2out, T] (and with ``with_stats`` the partials
    [B, 2 f_in * c2out, 8] f32). A CUDA tensor launches
    ``csrc/deconv_block.cu`` (counted in ``fused_deconv_block.launches``), a
    CPU tensor runs the plain version.
    """
    _check_shapes(x, f_in, c2x, "fused_deconv_block")
    _check_shapes(skip, f_in, c2s, "fused_deconv_block skip")
    if (skip.shape[0], skip.shape[2]) != (x.shape[0], x.shape[2]):
        raise ValueError(f"fused_deconv_block: x {tuple(x.shape)} and skip {tuple(skip.shape)}")
    if w2.shape != (5, 2, c2x + c2s, c2out) or b2.shape != (c2out,):
        raise ValueError(f"fused_deconv_block: w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if x.device.type == "cpu":
        return fused_deconv_block_plain(x, skip, w2, b2, coef_x, alpha_x, coef_s, alpha_s,
                                        f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out,
                                        with_stats=with_stats)
    if x.device.type != "cuda":
        raise ValueError(f"fused_deconv_block runs on cuda or cpu tensors, not {x.device}")
    _check_cuda("fused_deconv_block", [x, skip],
                [w2, b2, *coef_x, alpha_x, *coef_s, alpha_s])
    args, (y, stats), _keep = _deconv_block_args(x, skip, w2, b2, coef_x, alpha_x, coef_s,
                                                 alpha_s, f_in, c2x, c2s, c2out, with_stats)
    _launch("deconv_block", args, x)
    fused_deconv_block.launches += 1
    return (y, stats) if with_stats else y


def _deconv_block_args(x, skip, w2, b2, coef_x, alpha_x, coef_s, alpha_s, f_in, c2x, c2s, c2out,
                       with_stats, tile=None, pair=None):
    """The arguments of ``csrc/deconv_block.cu:deconv_block`` but the
    stream, its outputs (y, stats or None) and the packed operands they
    point to. bf16 packs the weights for row pairs where ``block_pair``
    says so (or ``pair``) and for the tile ``block_tile`` picks for the
    GEMM's rows (or ``tile``), f32 as ``block_gemm.cuh`` takes them."""
    wx, ws = _split_joined(w2, c2x, c2s)
    bf16 = x.dtype == torch.bfloat16
    pair = bf16 and (block_pair(c2out) if pair is None else pair)
    bm, nb = (tile or block_tile(2 * c2out if pair else c2out)) if bf16 else (0, 0)
    (wx, kp_x), (ws, kp_s) = ((_pack_mma_weights(w, bm, x.dtype, pair) if bf16 else
                               _pack_weights(w, x.dtype)) for w in (wx, ws))
    cx = _pack_coeffs(coef_x, alpha_x, x.dtype, x.device)
    cs = _pack_coeffs(coef_s, alpha_s, x.dtype, x.device)
    bias = b2.float().contiguous()
    y, stats = _outputs(x, 2 * f_in * c2out, with_stats)
    batch, _, n_time = x.shape
    args = [int(bf16), x.data_ptr(), cx.data_ptr(), wx.data_ptr(), c2x, kp_x,
            skip.data_ptr(), cs.data_ptr(), ws.data_ptr(), c2s, kp_s,
            bias.data_ptr(), y.data_ptr(), stats.data_ptr() if with_stats else None,
            batch, f_in, c2out, n_time, bm, nb, int(pair)]
    return args, (y, stats), (wx, ws, cx, cs, bias)


fused_conv_block.launches = 0
fused_deconv_block.launches = 0


# -- training: the backward pieces in plain PyTorch (XLA in JAX) -------------

def stats_cotangent(g_p: torch.Tensor, y: torch.Tensor, f_out: int, c2out: int) -> torch.Tensor:
    """g_y contribution of the stats partials' cotangent, f32 [B, R, T].

    Lanes per row: [sum y, sum y^2, sum y*partner], so d/dy[row] = gp0 + 2 y
    gp1 + (gp2[row] + gp2[partner]) y[partner].
    """
    batch, _, n_time = y.shape
    yb = y.float().view(batch, f_out, c2out, n_time)
    gb = g_p.float().view(batch, f_out, c2out, 8)
    g0, g1, g2 = (gb[..., i, None] for i in range(3))
    out = g0 + 2.0 * yb * g1 + (g2 + swap_parts(g2)) * swap_parts(yb)
    return out.reshape(batch, f_out * c2out, n_time)


def pointwise_bwd(g_z: torch.Tensor, x: torch.Tensor, a_diag, a_cross, c0, alpha, f: int,
                  c2: int):
    """Backward of ``z = PReLU(a_diag*x + a_cross*partner(x) + c0)`` in f32,
    with the f32 coefficients as given (not rounded), as JAX's
    ``_pointwise_bwd``. g_z, x: [B, f * c2, T]. Returns (g_x f32, z f32 [B, f
    * c2, T], d_a_diag, d_a_cross, d_c0 [c2], d_alpha [1])."""
    batch, _, n_time = x.shape
    xb = x.float().view(batch, f, c2, n_time)
    gzb = g_z.float().view(batch, f, c2, n_time)
    view = (1, 1, -1, 1)
    d, k = a_diag.float().view(view), a_cross.float().view(view)
    v = d * xb + k * swap_parts(xb) + c0.float().view(view)
    alpha = alpha.float().reshape(())
    gv = gzb * torch.where(v >= 0, 1.0, alpha)
    g_x = d * gv + swap_parts(k * gv)
    dims = (0, 1, 3)
    d_ad = (gv * xb).sum(dims)
    d_ac = (gv * swap_parts(xb)).sum(dims)
    d_c0 = gv.sum(dims)
    d_alpha = (gzb * torch.where(v < 0, v, 0.0)).sum().reshape(1)
    z = torch.where(v >= 0, v, alpha * v)
    return (g_x.reshape(batch, f * c2, n_time), z.reshape(batch, f * c2, n_time),
            d_ad, d_ac, d_c0, d_alpha)


def _nchw(a: torch.Tensor, f: int, c2: int) -> torch.Tensor:
    """[B, f * c2, T] -> [B, c2, f, T] in f32."""
    return a.float().view(a.shape[0], f, c2, a.shape[-1]).permute(0, 2, 1, 3)


def _rows(a: torch.Tensor) -> torch.Tensor:
    """[B, c2, f, T] -> [B, f * c2, T]."""
    batch, c2, f, n_time = a.shape
    return a.permute(0, 2, 1, 3).reshape(batch, f * c2, n_time)


def _vjp(fn, primal: torch.Tensor, cotangent: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        primal = primal.detach().requires_grad_()
        (grad,) = torch.autograd.grad(fn(primal), primal, cotangent)
    return grad


def enc_bwd_gz_plain(gy: torch.Tensor, w2: torch.Tensor, *, f_in: int, c2in: int,
                     c2out: int) -> torch.Tensor:
    """Encoder input gradient: the transpose of the block's conv
    (``ops/complex_conv.py:complex_conv``) applied to gy, in f32 with the
    weights rounded to gy's dtype; [B, f_in * c2in, T] in gy's dtype."""
    kernel = conv_from_hwio(w2.to(gy.dtype).float())
    z = gy.new_zeros((gy.shape[0], c2in, f_in, gy.shape[-1]), dtype=torch.float32)
    g_z = _vjp(lambda t: complex_conv(t, kernel, None), z, _nchw(gy, f_in // 2, c2out))
    return _rows(g_z).to(gy.dtype)


def enc_bwd_dw_plain(z: torch.Tensor, gy: torch.Tensor, *, f_in: int, c2in: int,
                     c2out: int) -> torch.Tensor:
    """Encoder weight gradient in f32: HWIO [5, 2, c2in, c2out]."""
    kernel = z.new_zeros((c2out, c2in, 5, 2), dtype=torch.float32)
    z = _nchw(z, f_in, c2in)
    dk = _vjp(lambda k: complex_conv(z, k, None), kernel, _nchw(gy, f_in // 2, c2out))
    return hwio_from_conv(dk)


def dec_bwd_gz_plain(gy: torch.Tensor, w2: torch.Tensor, *, f_in: int, c2x: int, c2s: int,
                     c2out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder input gradients of trunk and skip: the transpose of the
    block's transposed conv (``complex_deconv``) applied to gy, in f32 with
    the weights rounded to gy's dtype, the joined gradient split back."""
    kernel = deconv_from_hwio(w2.to(gy.dtype).float())
    joined = gy.new_zeros((gy.shape[0], c2x + c2s, f_in, gy.shape[-1]), dtype=torch.float32)
    g = _vjp(lambda t: complex_deconv(t, kernel, None), joined, _nchw(gy, 2 * f_in, c2out))
    x_rows, s_rows = _joined_rows(c2x, c2s)
    return _rows(g[:, x_rows]).to(gy.dtype), _rows(g[:, s_rows]).to(gy.dtype)


def dec_bwd_dw_plain(zx: torch.Tensor, zs: torch.Tensor, gy: torch.Tensor, *, f_in: int,
                     c2x: int, c2s: int, c2out: int) -> torch.Tensor:
    """Decoder weight gradient in f32: HWIO [5, 2, c2x + c2s, c2out], input
    rows in the joined order [xr, sr, xi, si]."""
    kernel = zx.new_zeros((c2x + c2s, c2out, 5, 2), dtype=torch.float32)
    joined = complex_cat(_nchw(zx, f_in, c2x), _nchw(zs, f_in, c2s))
    dk = _vjp(lambda k: complex_deconv(joined, k, None), kernel, _nchw(gy, 2 * f_in, c2out))
    return hwio_from_deconv(dk)


# -- training: the backward kernels ------------------------------------------

_DW_BLOCKS = 2048  # blocks a weight-gradient launch aims for: ~16 per SM of an H100
#                   (twice that for the 128-thread bf16 tiles, more of which fit an SM)
_DW_PART_BYTES = 1 << 28  # cap on its split-K partials


def _windows(widths: Sequence[int], decoder: bool) -> list:
    """(input rows of a window, channels) of each GEMM of the bf16
    weight-gradient kernel: the encoder's five rows, the decoder's even
    (three rows) and odd (two) output rows of the trunk and of the skip."""
    return [(rows, c2) for c2 in widths for rows in ((3, 2) if decoder else (5,))]


def dw_tile(widths: Sequence[int], c2out: int, dtype: torch.dtype, *,
            decoder: bool = False) -> Tuple[int, int]:
    """Tile of the weight-gradient kernels (``csrc/dw_gemm.cuh``). bf16: BM
    window rows (tap, input channel) x BN columns (time tap, output
    channel), from the widest window M and N = 2 c2out: 128 x 128 where
    both are large, else 64 x 64, 32 x 32 (16 x 32 for a window of at most
    16 rows) or, for N <= 8, 32 x 8 (measured at DCCRN's twelve blocks,
    B 128, T 643: tools/dw_phase_probe.py --tile); f32: 32 x 32 channels."""
    if dtype != torch.bfloat16:
        return 32, 32
    m = max(rows * c2 for rows, c2 in _windows(widths, decoder))
    n = 2 * c2out
    if n >= 128 and m >= 256:
        return 128, 128
    if n > 32:
        return 64, 64
    return (16 if m <= 16 else 32, 32) if n > 8 else (32, 8)


def dw_splits(batch: int, f_in: int, n_time: int, widths: Sequence[int], c2out: int, bm: int,
              bn: int, dtype: torch.dtype, *, decoder: bool = False) -> int:
    """K splits of a weight-gradient launch: enough blocks to fill the card
    (``_DW_BLOCKS``, or twice that for bf16 tiles smaller than 128 x 128,
    over the blocks of one split), at most one per step, partials within
    ``_DW_PART_BYTES``. bf16 steps are (b, 64-frame chunk, output row of a
    parity) and a split has every GEMM's BM x BN tiles; f32 steps are (b,
    output row, 32-frame chunk) and a split has 5 taps x the 32 x 32
    channel tiles."""
    c2tot = sum(widths)
    aim = _DW_BLOCKS
    if dtype == torch.bfloat16:
        rows, bk = (f_in if decoder else f_in // 2), 64
        blocks = sum(-(-(r * c2) // bm) for r, c2 in _windows(widths, decoder)) * -(
            -c2out // (bn // 2))
        aim = _DW_BLOCKS if bm * bn >= 128 * 128 else 2 * _DW_BLOCKS
    else:
        rows, bk = (2 * f_in if decoder else f_in // 2), 32
        blocks = 5 * sum(-(-c2 // bm) for c2 in widths) * -(-c2out // bn)
    steps = batch * rows * -(-n_time // bk)
    cap = max(1, _DW_PART_BYTES // (10 * c2tot * c2out * 4))
    return max(1, min(-(-aim // blocks), steps, cap, 65535))


def _check_bwd(what: str, acts: Sequence[torch.Tensor], rest: Sequence = ()) -> bool:
    """True for CUDA tensors (checked), False for CPU tensors; raises on any
    other device."""
    device = acts[0].device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {device}")
    _check_cuda(what, acts, rest)
    return True


def _is_bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def enc_bwd_gz(gy: torch.Tensor, w2: torch.Tensor, *, f_in: int, c2in: int,
               c2out: int) -> torch.Tensor:
    """Encoder input gradient g_z [B, f_in * c2in, T] in gy's dtype from
    the output gradient gy [B, f_in/2 * c2out, T] and HWIO w2 [5, 2, c2in,
    c2out]. A CUDA tensor launches ``csrc/conv_block_bwd.cu:enc_bwd_gz``
    (counted in ``enc_bwd_gz.launches``), a CPU tensor runs the plain version."""
    _check_shapes(gy, f_in // 2, c2out, "enc_bwd_gz")
    if w2.shape != (5, 2, c2in, c2out):
        raise ValueError(f"enc_bwd_gz: w2 {tuple(w2.shape)}")
    if not _check_bwd("enc_bwd_gz", [gy], [w2]):
        return enc_bwd_gz_plain(gy, w2, f_in=f_in, c2in=c2in, c2out=c2out)
    args, gz, _keep = _enc_bwd_gz_args(gy, w2, f_in, c2in, c2out)
    _launch("enc_bwd_gz", args, gy)
    enc_bwd_gz.launches += 1
    return gz


def _enc_bwd_gz_args(gy, w2, f_in, c2in, c2out, tile=None, pair=None):
    """The arguments of ``csrc/conv_block_bwd.cu:enc_bwd_gz`` but the
    stream, its output g_z and the packed weights: the taps reversed (jf' =
    4 - jf, jt' = 1 - jt), input and output swapped; bf16 packed for row
    pairs where ``block_pair`` says so (or ``pair``) and for the tile
    ``block_tile`` picks (or ``tile``) over the c2in output channels."""
    bf16 = gy.dtype == torch.bfloat16
    pair = bf16 and (block_pair(c2in) if pair is None else pair)
    bm, nb = (tile or block_tile(2 * c2in if pair else c2in)) if bf16 else (0, 0)
    flipped = w2.flip(0, 1).transpose(2, 3)
    w, kp = (_pack_mma_weights(flipped, bm, gy.dtype, pair) if bf16 else
             _pack_weights(flipped, gy.dtype))
    batch, _, n_time = gy.shape
    gz = torch.empty((batch, f_in * c2in, n_time), dtype=gy.dtype, device=gy.device)
    args = [int(bf16), gy.data_ptr(), w.data_ptr(), c2out, kp, gz.data_ptr(), batch, f_in, c2in,
            n_time, bm, nb, int(pair)]
    return args, gz, (w,)


def enc_bwd_dw(z: torch.Tensor, gy: torch.Tensor, *, f_in: int, c2in: int,
               c2out: int) -> torch.Tensor:
    """Encoder weight gradient, HWIO [5, 2, c2in, c2out] f32, from the
    activated input z [B, f_in * c2in, T] and gy [B, f_in/2 * c2out, T] of
    one dtype. A CUDA tensor launches ``csrc/conv_block_bwd.cu:enc_bwd_dw``
    (counted in ``enc_bwd_dw.launches``) and sums its split-K partials; a
    CPU tensor runs the plain version."""
    _check_shapes(z, f_in, c2in, "enc_bwd_dw")
    _check_shapes(gy, f_in // 2, c2out, "enc_bwd_dw g")
    if not _check_bwd("enc_bwd_dw", [z, gy]):
        return enc_bwd_dw_plain(z, gy, f_in=f_in, c2in=c2in, c2out=c2out)
    batch, _, n_time = z.shape
    bm, bn = dw_tile((c2in,), c2out, z.dtype)
    splits = dw_splits(batch, f_in, n_time, (c2in,), c2out, bm, bn, z.dtype)
    part = torch.empty((splits, 5, 2, c2in, c2out), dtype=torch.float32, device=z.device)
    _launch("enc_bwd_dw", [_is_bf16(z), z.data_ptr(), gy.data_ptr(), part.data_ptr(), splits,
                           bm, bn, batch, f_in, c2in, c2out, n_time], z)
    enc_bwd_dw.launches += 1
    return part.sum(0)


def dec_bwd_gz(gy: torch.Tensor, w2: torch.Tensor, *, f_in: int, c2x: int, c2s: int,
               c2out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder input gradients (g_zx [B, f_in * c2x, T], g_zs [B, f_in *
    c2s, T]) in gy's dtype from gy [B, 2 f_in * c2out, T] and the joined
    HWIO w2 [5, 2, c2x + c2s, c2out]. A CUDA tensor launches
    ``csrc/deconv_block_bwd.cu:dec_bwd_gz`` (counted in
    ``dec_bwd_gz.launches``), a CPU tensor runs the plain version."""
    _check_shapes(gy, 2 * f_in, c2out, "dec_bwd_gz")
    if w2.shape != (5, 2, c2x + c2s, c2out):
        raise ValueError(f"dec_bwd_gz: w2 {tuple(w2.shape)}")
    if not _check_bwd("dec_bwd_gz", [gy], [w2]):
        return dec_bwd_gz_plain(gy, w2, f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    args, (gzx, gzs), _keep = _dec_bwd_gz_args(gy, w2, f_in, c2x, c2s, c2out)
    _launch("dec_bwd_gz", args, gy)
    dec_bwd_gz.launches += 1
    return gzx, gzs


def _dec_bwd_gz_args(gy, w2, f_in, c2x, c2s, c2out, tile=None):
    """The arguments of ``csrc/deconv_block_bwd.cu:dec_bwd_gz`` but the
    stream, its outputs (g_zx, g_zs) and the packed weights: the taps
    reversed (jf' = 4 - jf, jt' = 1 - jt), input and output swapped; bf16
    packed for the tile ``block_tile`` picks (or ``tile``) over the joined
    output channels."""
    bf16 = gy.dtype == torch.bfloat16
    bm, nb = (tile or block_tile(c2x + c2s)) if bf16 else (0, 0)
    flipped = w2.flip(0, 1).transpose(2, 3)
    w, kp = (_pack_mma_weights(flipped, bm, gy.dtype) if bf16 else
             _pack_weights(flipped, gy.dtype))
    batch, _, n_time = gy.shape
    gzx = torch.empty((batch, f_in * c2x, n_time), dtype=gy.dtype, device=gy.device)
    gzs = torch.empty((batch, f_in * c2s, n_time), dtype=gy.dtype, device=gy.device)
    args = [int(bf16), gy.data_ptr(), w.data_ptr(), c2out, kp, gzx.data_ptr(), c2x,
            gzs.data_ptr(), c2s, batch, f_in, n_time, bm, nb]
    return args, (gzx, gzs), (w,)


def dec_bwd_dw(zx: torch.Tensor, zs: torch.Tensor, gy: torch.Tensor, *, f_in: int, c2x: int,
               c2s: int, c2out: int) -> torch.Tensor:
    """Decoder weight gradient, HWIO [5, 2, c2x + c2s, c2out] f32 with input
    rows in the joined order [xr, sr, xi, si], from the activated inputs zx,
    zs and gy of one dtype. A CUDA tensor launches
    ``csrc/deconv_block_bwd.cu:dec_bwd_dw`` (counted in
    ``dec_bwd_dw.launches``), sums its split-K partials and puts the rows
    in the joined order; a CPU tensor runs the plain version."""
    _check_shapes(zx, f_in, c2x, "dec_bwd_dw")
    _check_shapes(zs, f_in, c2s, "dec_bwd_dw skip")
    _check_shapes(gy, 2 * f_in, c2out, "dec_bwd_dw g")
    if not _check_bwd("dec_bwd_dw", [zx, zs, gy]):
        return dec_bwd_dw_plain(zx, zs, gy, f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    batch, _, n_time = zx.shape
    bm, bn = dw_tile((c2x, c2s), c2out, zx.dtype, decoder=True)
    splits = dw_splits(batch, f_in, n_time, (c2x, c2s), c2out, bm, bn, zx.dtype, decoder=True)
    part = torch.empty((splits, 5, 2, c2x + c2s, c2out), dtype=torch.float32, device=zx.device)
    _launch("dec_bwd_dw", [_is_bf16(zx), zx.data_ptr(), c2x, zs.data_ptr(), c2s, gy.data_ptr(),
                           part.data_ptr(), splits, bm, bn, batch, f_in, c2out, n_time], zx)
    dec_bwd_dw.launches += 1
    return joined_from_regions(part.sum(0), c2x, c2s)


def joined_from_regions(dw: torch.Tensor, c2x: int, c2s: int) -> torch.Tensor:
    """[5, 2, c2x + c2s, C] with the trunk's rows then the skip's -> the
    joined order [xr, sr, xi, si] (inverse of ``_split_joined``)."""
    cx, cs = c2x // 2, c2s // 2
    parts = (dw[:, :, :cx], dw[:, :, c2x:c2x + cs], dw[:, :, cx:c2x], dw[:, :, c2x + cs:])
    return torch.cat(parts, dim=2)


enc_bwd_gz.launches = 0
enc_bwd_dw.launches = 0
dec_bwd_gz.launches = 0
dec_bwd_dw.launches = 0


# -- training: autograd Functions --------------------------------------------

def _gy_eff(g_y, g_p, y, f_out: int, c2out: int, dtype: torch.dtype) -> torch.Tensor:
    """The output's cotangent plus the stats partials', rounded to the
    activation dtype (both gradients read it so)."""
    return (g_y.float() + stats_cotangent(g_p, y, f_out, c2out)).to(dtype)


def _bias_grad(g: torch.Tensor, f_out: int, c2out: int) -> torch.Tensor:
    return g.float().view(g.shape[0], f_out, c2out, -1).sum((0, 1, 3))


class ConvBlockTrain(torch.autograd.Function):
    """Training-mode fused encoder block: (y, stats partials) with exact
    gradients for (x, w2, b2, a_diag, a_cross, c0, alpha)."""

    @staticmethod
    def forward(ctx, x, w2, b2, a_diag, a_cross, c0, alpha, f_in, c2in, c2out):
        y, partials = fused_conv_block(x, w2, b2, a_diag, a_cross, c0, alpha, f_in=f_in,
                                       c2in=c2in, c2out=c2out, with_stats=True)
        ctx.save_for_backward(x, w2, a_diag, a_cross, c0, alpha, y)
        ctx.shapes = (f_in, c2in, c2out)
        return y, partials

    @staticmethod
    def backward(ctx, g_y, g_p):
        x, w2, a_diag, a_cross, c0, alpha, y = ctx.saved_tensors
        f_in, c2in, c2out = ctx.shapes
        need = ctx.needs_input_grad
        g = _gy_eff(g_y, g_p, y, f_in // 2, c2out, x.dtype)
        shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out)
        grads = [None] * 7
        if any(need[i] for i in (0, 3, 4, 5, 6)):  # not for the spectrogram's block
            g_z = enc_bwd_gz(g, w2, **shapes)
            g_x, z, *coef_grads = pointwise_bwd(g_z, x, a_diag, a_cross, c0, alpha, f_in, c2in)
            grads[0] = g_x.to(x.dtype)
            grads[3:7] = coef_grads[:3] + [coef_grads[3].view_as(alpha)]
        else:
            z = pointwise(x.view(x.shape[0], f_in, c2in, -1), a_diag, a_cross, c0, alpha)
        if need[1]:
            grads[1] = enc_bwd_dw(z.reshape(x.shape).to(x.dtype), g, **shapes).to(w2.dtype)
        grads[2] = _bias_grad(g, f_in // 2, c2out)
        return (*grads, None, None, None)


class DeconvBlockTrain(torch.autograd.Function):
    """Training-mode fused decoder block: (y, stats partials) with exact
    gradients for (x, skip, w2, b2) and both inputs' coefficients and slopes."""

    @staticmethod
    def forward(ctx, x, skip, w2, b2, adx, acx, c0x, alpha_x, ads, acs, c0s, alpha_s, f_in, c2x,
                c2s, c2out):
        y, partials = fused_deconv_block(
            x, skip, w2, b2, (adx, acx, c0x), alpha_x, (ads, acs, c0s), alpha_s, f_in=f_in,
            c2x=c2x, c2s=c2s, c2out=c2out, with_stats=True)
        ctx.save_for_backward(x, skip, w2, adx, acx, c0x, alpha_x, ads, acs, c0s, alpha_s, y)
        ctx.shapes = (f_in, c2x, c2s, c2out)
        return y, partials

    @staticmethod
    def backward(ctx, g_y, g_p):
        x, skip, w2, adx, acx, c0x, alpha_x, ads, acs, c0s, alpha_s, y = ctx.saved_tensors
        f_in, c2x, c2s, c2out = ctx.shapes
        need = ctx.needs_input_grad
        g = _gy_eff(g_y, g_p, y, 2 * f_in, c2out, x.dtype)
        shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
        grads = [None] * 12
        regions = ((0, x, (adx, acx, c0x, alpha_x), c2x, 4),
                   (1, skip, (ads, acs, c0s, alpha_s), c2s, 8))
        zs = []
        if any(need[i] for i in (0, 1, *range(4, 12))):
            for (slot, act, (ad, ac, c0, alpha), c2, first), g_z in zip(
                    regions, dec_bwd_gz(g, w2, **shapes)):
                g_a, z, *coef_grads = pointwise_bwd(g_z, act, ad, ac, c0, alpha, f_in, c2)
                grads[slot] = g_a.to(act.dtype)
                grads[first:first + 4] = coef_grads[:3] + [coef_grads[3].view_as(alpha)]
                zs.append(z)
        else:
            zs = [pointwise(act.view(act.shape[0], f_in, c2, -1), *coef)
                  for _, act, coef, c2, _ in regions]
        if need[2]:
            zx, z_s = (z.reshape(act.shape).to(x.dtype) for z, (_, act, *_) in zip(zs, regions))
            grads[2] = dec_bwd_dw(zx, z_s, g, **shapes).to(w2.dtype)
        grads[3] = _bias_grad(g, 2 * f_in, c2out)
        return (*grads, None, None, None, None)


def conv_block_train(x, w2, b2, a_diag, a_cross, c0, alpha: torch.Tensor, *, f_in: int,
                     c2in: int, c2out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-mode encoder block (counterpart of the JAX custom VJP
    ``conv_block_train``): ``fused_conv_block(..., with_stats=True)`` with a
    backward through ``enc_bwd_gz`` / ``enc_bwd_dw``; alpha is a [1]
    tensor. The input-gradient kernel is skipped when neither x nor its
    coefficients need a gradient (the first block, whose input is the
    spectrogram)."""
    return ConvBlockTrain.apply(x, w2, b2, a_diag, a_cross, c0, alpha, f_in, c2in, c2out)


def deconv_block_train(x, skip, w2, b2, coef_x: Coeffs, alpha_x: torch.Tensor, coef_s: Coeffs,
                       alpha_s: torch.Tensor, *, f_in: int, c2x: int, c2s: int,
                       c2out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-mode decoder block (counterpart of the JAX custom VJP
    ``deconv_block_train``): ``fused_deconv_block(..., with_stats=True)``
    with a backward through ``dec_bwd_gz`` / ``dec_bwd_dw``; the slopes are
    [1] tensors."""
    return DeconvBlockTrain.apply(x, skip, w2, b2, *coef_x, alpha_x, *coef_s, alpha_s, f_in,
                                  c2x, c2s, c2out)
