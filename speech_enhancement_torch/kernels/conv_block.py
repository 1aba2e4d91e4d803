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
versions are differentiable; the kernels have no backward yet, so the CUDA
branch raises when autograd would need one.
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
                                                       deconv_from_hwio)

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Alpha = Union[torch.Tensor, float]
_BK = 16  # input channels per K step of the kernels (csrc/block_gemm.cuh)


def identity_coeffs(c2: int, device=None) -> Coeffs:
    """Pass-through pointwise: (ones, zeros, zeros) f32 over ``c2`` channels."""
    return (torch.ones(c2, device=device), torch.zeros(c2, device=device),
            torch.zeros(c2, device=device))


def pointwise(x: torch.Tensor, a_diag, a_cross, c0, alpha: Alpha) -> torch.Tensor:
    """``PReLU(a_diag*x + a_cross*partner(x) + c0)`` on [B, F, C2, T], in f32."""
    c = x.shape[2] // 2
    x = x.float()
    partner = torch.cat([x[:, :, c:], x[:, :, :c]], dim=2)
    view = (1, 1, -1, 1)
    z = (a_diag.float().view(view) * x + a_cross.float().view(view) * partner
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
    c = c2out // 2
    partner = torch.cat([y[:, :, c:], y[:, :, :c]], dim=2)
    sums = torch.stack([y.sum(-1), (y * y).sum(-1), (y * partner).sum(-1)], dim=-1)
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

@functools.cache
def _entry(name: str):
    fn = getattr(_build.library(name), name)
    region = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    regions = region if name == "conv_block" else region + region
    fn.argtypes = ([ctypes.c_int] + regions + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
            f"{what} has no backward kernel yet (the train slice brings it); run it under "
            "torch.no_grad() / torch.inference_mode(), or on the CPU for gradients")


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
    _build.check(_build.library(name), code, f"{name} launch")


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
    coef = _pack_coeffs((a_diag, a_cross, c0), alpha, x.dtype, x.device)
    w, kp = _pack_weights(w2, x.dtype)
    bias = b2.float().contiguous()
    y, stats = _outputs(x, f_in // 2 * c2out, with_stats)
    batch, _, n_time = x.shape
    _launch("conv_block", [int(x.dtype == torch.bfloat16), x.data_ptr(), coef.data_ptr(),
                           w.data_ptr(), c2in, kp, bias.data_ptr(), y.data_ptr(),
                           stats.data_ptr() if with_stats else None,
                           batch, f_in, c2out, n_time], x)
    fused_conv_block.launches += 1
    return (y, stats) if with_stats else y


def _split_joined(w2: torch.Tensor, c2x: int, c2s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joined-input rows [xr, sr, xi, si] of w2 -> (trunk rows, skip rows),
    each in its own [r..., i...] order."""
    cx, cs = c2x // 2, c2s // 2
    x_rows = list(range(cx)) + list(range(cx + cs, 2 * cx + cs))
    s_rows = list(range(cx, cx + cs)) + list(range(2 * cx + cs, 2 * cx + 2 * cs))
    return w2[:, :, x_rows], w2[:, :, s_rows]


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
    wx, ws = _split_joined(w2, c2x, c2s)
    wx, kp_x = _pack_weights(wx, x.dtype)
    ws, kp_s = _pack_weights(ws, x.dtype)
    cx = _pack_coeffs(coef_x, alpha_x, x.dtype, x.device)
    cs = _pack_coeffs(coef_s, alpha_s, x.dtype, x.device)
    bias = b2.float().contiguous()
    y, stats = _outputs(x, 2 * f_in * c2out, with_stats)
    batch, _, n_time = x.shape
    _launch("deconv_block", [int(x.dtype == torch.bfloat16),
                             x.data_ptr(), cx.data_ptr(), wx.data_ptr(), c2x, kp_x,
                             skip.data_ptr(), cs.data_ptr(), ws.data_ptr(), c2s, kp_s,
                             bias.data_ptr(), y.data_ptr(),
                             stats.data_ptr() if with_stats else None,
                             batch, f_in, c2out, n_time], x)
    fused_deconv_block.launches += 1
    return (y, stats) if with_stats else y


fused_conv_block.launches = 0
fused_deconv_block.launches = 0

