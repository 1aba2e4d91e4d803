"""Complex-valued blocks as paired real tensors (counterpart of
speech_enhancement_tpu/ops/complex_ops.py).

``ComplexBatchNormSimple`` (DCUnet's) is two independent real BatchNorms,
``bn_re`` and ``bn_im`` (the reference DCUnet's names). ``ComplexBatchNorm``
(DCCRN's) whitens with the full 2x2 covariance, as below;
``ComplexBatchNormStacked`` is the same math over one channel-stacked
tensor. ``ComplexConv2d``, ``ComplexConvTranspose2d``, ``ComplexDense`` and
``complex_prelu`` are the JAX package's library blocks, which no model of
either package builds: two real layers cross-combined by the
(rr - ii, ri + ir) rule, in torch's channels-first layout [B, C, H, W]
(JAX: channels last), with flax's pads ("SAME", "VALID" or (low, high)
pairs) and flax's init through ``ops/layers.py``.
Per channel: subtract the complex mean, whiten by the inverse matrix square
root of the (Vrr, Vri; Vri, Vii) covariance, then apply a 2x2 affine
(Wrr/Wri/Wii, Br/Bi). Parameter and buffer names are the reference torch
DCCRN's (``Wrr``..., running stats ``RMr``...``RVii``), so a reference
``state_dict`` loads as it is.

Takes and returns a pair ``(real, imag)`` of [B, C, ...] tensors (channels
on axis 1). The whitening math runs in float32 whatever the input dtype;
the centred path casts its output back to the input dtype, the folded path
applies per-channel coefficients in the input dtype.

Named saves (``NamedSaves``): under DCCRN's ``remat`` a block runs twice,
forward and again in backward (``torch.utils.checkpoint``). The batch
moments are the JAX ``cbn_stats`` save point: one autograd node
(``_Moments``) whose backward is elementwise, so with ``cbn_stats`` saved
the recompute reuses the first run's moments and skips the reductions.
Either way the running statistics move once, on the first run.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.layers import (conv, conv_transpose, linear, run_conv,
                                                 run_conv_transpose, same_pads)

ComplexPair = Tuple[torch.Tensor, torch.Tensor]
_STATS = ("mean_r", "mean_i", "vrr", "vii", "vri")


class NamedSaves:
    """The named-saves state of one recomputed call (JAX's
    ``jax.checkpoint_policies.save_only_these_names``).

    ``torch.utils.checkpoint`` runs the wrapped function twice: forward,
    then in backward to recompute what autograd did not keep. The function
    calls :meth:`run` at its start. A save point asks :meth:`slot` for its
    name: None when the name is not saved, else a list that holds the first
    run's value for the recompute to reuse (one save point a name per
    call). ``recomputing`` is true from the second run on, where running
    statistics must not move again.
    """

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self.runs = 0
        self._slots: Dict[str, List] = {}

    def run(self) -> "NamedSaves":
        self.runs += 1
        return self

    @property
    def recomputing(self) -> bool:
        return self.runs > 1

    def slot(self, name: str) -> Optional[List]:
        return self._slots.setdefault(name, []) if name in self.names else None


def _moments(fr: torch.Tensor, fi: torch.Tensor, fold: bool):
    """f32 [B, C, ...] parts -> ((mean_r, mean_i, vrr, vii, vri) per
    channel, (cr, ci)): centred, two passes, with the centred parts; or
    ``fold``'s one pass ``E[x^2] - E[x]^2`` with the variances clamped at
    0, and (None, None)."""
    dims = [d for d in range(fr.dim()) if d != 1]
    mean_r = fr.mean(dim=dims)
    mean_i = fi.mean(dim=dims)
    if fold:
        return (mean_r, mean_i,
                torch.clamp((fr * fr).mean(dim=dims) - mean_r * mean_r, min=0.0),
                torch.clamp((fi * fi).mean(dim=dims) - mean_i * mean_i, min=0.0),
                (fr * fi).mean(dim=dims) - mean_r * mean_i), (None, None)
    shape = (1, -1) + (1,) * (fr.dim() - 2)
    cr = fr - mean_r.view(shape)
    ci = fi - mean_i.view(shape)
    return (mean_r, mean_i, (cr * cr).mean(dim=dims), (ci * ci).mean(dim=dims),
            (cr * ci).mean(dim=dims)), (cr, ci)


class _Moments(torch.autograd.Function):
    """:func:`_moments` of (xr, xi) in any float dtype as one autograd node.

    Backward is elementwise from the inputs and the means it saves, with
    ``n`` elements a channel: ``dxr = (g_mr + 2 g_vrr (xr - mr) + g_vri
    (xi - mi)) / n`` and its mirror for ``xi`` (``fold``: the variance terms
    are zero where the clamp held them at 0). The centred form's exact
    gradient also subtracts ``mean(xr - mr)``, which is zero. ``slot``
    (a :meth:`NamedSaves.slot`) is empty on the first run, which fills it,
    and full on the recompute, which reuses it instead of reducing again;
    either way the node saves the same tensors, as checkpoint requires.
    """

    @staticmethod
    def forward(ctx, xr, xi, fold: bool, slot: Optional[List]):
        if slot:
            moments = slot[0]
        else:
            stats = _moments(xr.float(), xi.float(), fold)[0]
            keep = (stats[2] > 0, stats[3] > 0) if fold else (None, None)
            moments = (*stats, *keep)
            if slot is not None:
                slot.append(moments)
        mean_r, mean_i, vrr, vii, vri, keep_r, keep_i = moments
        ctx.save_for_backward(xr, xi, mean_r, mean_i, keep_r, keep_i)
        return tuple(v.clone() for v in (mean_r, mean_i, vrr, vii, vri))

    @staticmethod
    def backward(ctx, g_mr, g_mi, g_vrr, g_vii, g_vri):
        xr, xi, mean_r, mean_i, keep_r, keep_i = ctx.saved_tensors
        shape = (1, -1) + (1,) * (xr.dim() - 2)
        n = xr.numel() // xr.shape[1]
        cr = xr.float() - mean_r.view(shape)
        ci = xi.float() - mean_i.view(shape)
        a_r, a_i = 2.0 * g_vrr, 2.0 * g_vii
        if keep_r is not None:
            a_r, a_i = a_r * keep_r, a_i * keep_i
        v = (lambda t: t.view(shape))
        gr = (v(g_mr) + v(a_r) * cr + v(g_vri) * ci) / n
        gi = (v(g_mi) + v(a_i) * ci + v(g_vri) * cr) / n
        return gr.to(xr.dtype), gi.to(xi.dtype), None, None


class ComplexBatchNormSimple(nn.Module):
    """A flax BatchNorm on each part (momentum 0.9, eps 1e-5), f32 out."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.bn_re = BatchNorm(channels, momentum, eps)
        self.bn_im = BatchNorm(channels, momentum, eps)

    def forward(self, x: ComplexPair) -> ComplexPair:
        return self.bn_re(x[0]), self.bn_im(x[1])


class ComplexBatchNorm(nn.Module):
    """``train()`` mode normalises with batch statistics and updates the
    running statistics (momentum 0.9 on the old value); ``eval()`` mode
    uses the running statistics.

    ``fold=True``: one-pass f32 moments over the raw activations, with
    whitening and affine folded into per-channel 2x2 coefficients applied
    in the input dtype (the JAX package's ``fold`` path).
    """

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 fold: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.fold = fold
        rt2 = 1.0 / math.sqrt(2.0)
        self.Wrr = nn.Parameter(torch.full((channels,), rt2))
        self.Wri = nn.Parameter(torch.zeros(channels))
        self.Wii = nn.Parameter(torch.full((channels,), rt2))
        self.Br = nn.Parameter(torch.zeros(channels))
        self.Bi = nn.Parameter(torch.zeros(channels))
        self.register_buffer("RMr", torch.zeros(channels))
        self.register_buffer("RMi", torch.zeros(channels))
        self.register_buffer("RVrr", torch.full((channels,), rt2))
        self.register_buffer("RVri", torch.zeros(channels))
        self.register_buffer("RVii", torch.full((channels,), rt2))

    def _update(self, stats: Dict[str, torch.Tensor]) -> None:
        m = self.momentum
        with torch.no_grad():
            for key, buf in self.running_stats().items():
                buf.mul_(m).add_((1 - m) * stats[key])

    def _whitening(self, vrr, vii, vri):
        vrr = vrr + self.eps
        vii = vii + self.eps
        det = vrr * vii - vri * vri
        s = torch.sqrt(torch.clamp(det, min=1e-12))
        t = torch.sqrt(vrr + vii + 2.0 * s)
        inv_st = 1.0 / (s * t)
        return (vii + s) * inv_st, (vrr + s) * inv_st, -vri * inv_st

    def batch_stats(self, xr: torch.Tensor, xi: torch.Tensor,
                    saves: Optional[NamedSaves] = None):
        """The batch moments (a dict with the keys of :meth:`running_stats`)
        and, on the centred path without ``saves``, the centred f32 parts
        (else (None, None)); the running statistics move towards the
        moments unless ``saves`` is recomputing. Without ``saves`` they are
        plain autograd ops; with it, the ``cbn_stats`` save point
        (:class:`_Moments`)."""
        if saves is None:
            stats, centred = _moments(xr.float(), xi.float(), self.fold)
        else:
            stats = _Moments.apply(xr, xi, self.fold, saves.slot("cbn_stats"))
            centred = (None, None)
        stats = dict(zip(_STATS, stats))
        if saves is None or not saves.recomputing:
            self._update(stats)
        return stats, centred

    def forward(self, xr: torch.Tensor, xi: torch.Tensor,
                saves: Optional[NamedSaves] = None) -> ComplexPair:
        """``saves``: the named-saves state of the recomputed block that
        calls this (train mode only)."""
        if self.fold:
            return self._folded(xr, xi, saves)
        bshape = (1, -1) + (1,) * (xr.dim() - 2)
        fr = xr.float()
        fi = xi.float()
        if self.training:
            stats, (cr, ci) = self.batch_stats(xr, xi, saves)
            vrr, vii, vri = stats["vrr"], stats["vii"], stats["vri"]
            if cr is None:
                cr = fr - stats["mean_r"].view(bshape)
                ci = fi - stats["mean_i"].view(bshape)
        else:
            vrr, vii, vri = self.RVrr, self.RVii, self.RVri
            cr = fr - self.RMr.view(bshape)
            ci = fi - self.RMi.view(bshape)
        wrr, wii, wri = self._whitening(vrr, vii, vri)
        yr = wrr.view(bshape) * cr + wri.view(bshape) * ci
        yi = wri.view(bshape) * cr + wii.view(bshape) * ci
        zr = self.Wrr.view(bshape) * yr + self.Wri.view(bshape) * yi + self.Br.view(bshape)
        zi = self.Wri.view(bshape) * yr + self.Wii.view(bshape) * yi + self.Bi.view(bshape)
        return zr.to(xr.dtype), zi.to(xi.dtype)

    def running_stats(self) -> Dict[str, torch.Tensor]:
        return {"mean_r": self.RMr, "mean_i": self.RMi, "vrr": self.RVrr,
                "vii": self.RVii, "vri": self.RVri}

    def fold_coeffs(self, stats: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Whitening and affine folded into stacked per-channel coefficients.

        Returns f32 ``(a_diag, a_cross, c0)`` over ``[r..., i...]`` channels
        such that ``z[ch] = a_diag[ch]*x[ch] + a_cross[ch]*x[partner] + c0[ch]``
        (the partner of a channel is its complex counterpart, ch +- C), from
        ``stats`` (keys of :func:`stats_from_partials`) or, by default, the
        running statistics. Counterpart of the JAX package's
        ``ops/pallas/experimental/conv_block.py:fold_cbn_coeffs``.
        """
        stats = self.running_stats() if stats is None else stats
        wrr, wii, wri = self._whitening(stats["vrr"], stats["vii"], stats["vri"])
        arr = self.Wrr * wrr + self.Wri * wri
        ari = self.Wrr * wri + self.Wri * wii
        air = self.Wri * wrr + self.Wii * wri
        aii = self.Wri * wri + self.Wii * wii
        cr0 = self.Br - (arr * stats["mean_r"] + ari * stats["mean_i"])
        ci0 = self.Bi - (air * stats["mean_r"] + aii * stats["mean_i"])
        return torch.cat([arr, aii]), torch.cat([ari, air]), torch.cat([cr0, ci0])

    def _folded(self, xr: torch.Tensor, xi: torch.Tensor,
                saves: Optional[NamedSaves] = None) -> ComplexPair:
        bshape = (1, -1) + (1,) * (xr.dim() - 2)
        stats = self.batch_stats(xr, xi, saves)[0] if self.training else None
        a_diag, a_cross, c0 = (v.to(xr.dtype) for v in self.fold_coeffs(stats))
        c = a_diag.shape[0] // 2
        arr, aii, ari, air, cr0, ci0 = (v.view(bshape) for v in (
            a_diag[:c], a_diag[c:], a_cross[:c], a_cross[c:], c0[:c], c0[c:]))
        zr = arr * xr + ari * xi + cr0
        zi = air * xr + aii * xi + ci0
        return zr, zi


def stats_from_partials(partials: torch.Tensor, c2out: int,
                        n_per_channel: int) -> Dict[str, torch.Tensor]:
    """[B, R_out, 8] per-row partial sums -> complex-BN batch statistics.

    Lanes 0..2 of each output row hold sum(y), sum(y^2) and sum(y*partner)
    over time (``kernels/conv_block.py``); ``n_per_channel`` = B * F_out * T.
    One-pass ``E[y^2] - E[y]^2`` moments clamped at 0, as the folded path
    above; the cross moment is read from the r-half rows. Counterpart of
    ``ops/pallas/experimental/conv_block.py:stats_from_partials``.
    """
    total = partials.float().sum(dim=0)  # [R, 8]
    per = total.reshape(-1, c2out, 8).sum(dim=0)  # [c2out, 8]
    c = c2out // 2
    inv_n = 1.0 / float(n_per_channel)
    mean_r = per[:c, 0] * inv_n
    mean_i = per[c:, 0] * inv_n
    return {
        "mean_r": mean_r, "mean_i": mean_i,
        "vrr": torch.clamp(per[:c, 1] * inv_n - mean_r * mean_r, min=0.0),
        "vii": torch.clamp(per[c:, 1] * inv_n - mean_i * mean_i, min=0.0),
        "vri": per[:c, 2] * inv_n - mean_r * mean_i,
    }


class ComplexBatchNormStacked(nn.Module):
    """:class:`ComplexBatchNorm`'s math over one channel-stacked tensor
    [B, 2C, ...] ([r..., i...] on axis 1): the (r, i) cross terms come from
    rolling the channels by C (the JAX package's tested alternative, which
    no model uses). Statistics in f32, the output in the input's dtype.
    Parameters as :class:`ComplexBatchNorm`'s (``Wrr``, ``Wri``, ``Wii``,
    ``Br``, ``Bi``); running statistics under flax's names: ``mean2`` and
    ``var2`` [2C], ``vri`` [C]."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        rt2 = 1.0 / math.sqrt(2.0)
        self.Wrr = nn.Parameter(torch.full((channels,), rt2))
        self.Wri = nn.Parameter(torch.zeros(channels))
        self.Wii = nn.Parameter(torch.full((channels,), rt2))
        self.Br = nn.Parameter(torch.zeros(channels))
        self.Bi = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean2", torch.zeros(2 * channels))
        self.register_buffer("var2", torch.full((2 * channels,), rt2))
        self.register_buffer("vri", torch.zeros(channels))

    def forward(self, y2: torch.Tensor) -> torch.Tensor:
        c = y2.shape[1] // 2
        dims = [d for d in range(y2.dim()) if d != 1]
        shape = (1, -1) + (1,) * (y2.dim() - 2)
        f = y2.float()
        if self.training:
            mean2 = f.mean(dim=dims)
            centered = f - mean2.view(shape)
            rolled = torch.roll(centered, c, dims=1)
            var2 = (centered * centered).mean(dim=dims)
            vri = (centered * rolled).mean(dim=dims)[:c]
            m = self.momentum
            with torch.no_grad():
                for buf, new in ((self.mean2, mean2), (self.var2, var2), (self.vri, vri)):
                    buf.mul_(m).add_((1 - m) * new)
        else:
            mean2, var2, vri = self.mean2, self.var2, self.vri
            centered = f - mean2.view(shape)
            rolled = torch.roll(centered, c, dims=1)
        vrr = var2[:c] + self.eps
        vii = var2[c:] + self.eps
        det = vrr * vii - vri * vri
        s = torch.sqrt(torch.clamp(det, min=1e-12))
        t = torch.sqrt(vrr + vii + 2.0 * s)
        inv_st = 1.0 / (s * t)
        wrr, wii, wri = (vii + s) * inv_st, (vrr + s) * inv_st, -vri * inv_st
        w_diag = torch.cat([wrr, wii]).view(shape)
        w_cross = torch.cat([wri, wri]).view(shape)
        whitened = centered * w_diag + rolled * w_cross
        g_diag = torch.cat([self.Wrr, self.Wii]).view(shape)
        g_cross = torch.cat([self.Wri, self.Wri]).view(shape)
        beta2 = torch.cat([self.Br, self.Bi]).view(shape)
        out = whitened * g_diag + torch.roll(whitened, c, dims=1) * g_cross + beta2
        return out.to(y2.dtype)


def _pads(padding, x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]):
    """flax ``Conv``'s ``padding`` ("SAME", "VALID", an int or one (low,
    high) pair an axis) -> (low, high) pairs over x's spatial axes."""
    if padding == "SAME":
        return [same_pads(n, k, s) for n, k, s in zip(x.shape[2:], kernel, stride)]
    if padding == "VALID":
        return None
    if isinstance(padding, int):
        return [(padding, padding)] * len(kernel)
    return [tuple(p) for p in padding]


def _result_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's ``dtype=None`` with f32 parameters: the promotion with f32."""
    return torch.promote_types(x.dtype, torch.float32)


class ComplexConv2d(nn.Module):
    """Complex 2-D convolution on [B, C, H, W] parts: ``(conv_r(xr) -
    conv_i(xi), conv_r(xi) + conv_i(xr))``, each a flax ``Conv`` (``padding``
    "SAME", "VALID", an int or (low, high) pairs; flax's init)."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding="SAME", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding = padding
        self.conv_r = conv(in_channels, features, tuple(kernel_size), generator,
                           stride=tuple(strides), bias=use_bias)
        self.conv_i = conv(in_channels, features, tuple(kernel_size), generator,
                           stride=tuple(strides), bias=use_bias)

    def _conv(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        pads = _pads(self.padding, x, module.kernel_size, module.stride)
        return run_conv(module, x, _result_dtype(x), pads)

    def forward(self, x: ComplexPair) -> ComplexPair:
        xr, xi = x
        return (self._conv(self.conv_r, xr) - self._conv(self.conv_i, xi),
                self._conv(self.conv_r, xi) + self._conv(self.conv_i, xr))


class ComplexConvTranspose2d(nn.Module):
    """Complex transposed 2-D convolution on [B, C, H, W] parts, each a flax
    ``ConvTranspose`` (unflipped kernel, ``padding`` "SAME", "VALID" or
    (low, high) pairs; default "VALID", as in JAX)."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding="VALID", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.padding = padding
        self.conv_r = conv_transpose(in_channels, features, tuple(kernel_size), generator,
                                     stride=tuple(strides), bias=use_bias)
        self.conv_i = conv_transpose(in_channels, features, tuple(kernel_size), generator,
                                     stride=tuple(strides), bias=use_bias)

    def _conv(self, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return run_conv_transpose(module, x, _result_dtype(x), self.padding)

    def forward(self, x: ComplexPair) -> ComplexPair:
        xr, xi = x
        return (self._conv(self.conv_r, xr) - self._conv(self.conv_i, xi),
                self._conv(self.conv_r, xi) + self._conv(self.conv_i, xr))


class ComplexDense(nn.Module):
    """Complex linear layer over the last axis: two flax ``Dense`` layers
    (``dense_r``, ``dense_i``) cross-combined."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense_r = linear(in_features, features, generator, bias=use_bias)
        self.dense_i = linear(in_features, features, generator, bias=use_bias)

    @staticmethod
    def _dense(module: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dtype = _result_dtype(x)
        bias = None if module.bias is None else module.bias.to(dtype)
        return F.linear(x.to(dtype), module.weight.to(dtype), bias)

    def forward(self, x: ComplexPair) -> ComplexPair:
        xr, xi = x
        return (self._dense(self.dense_r, xr) - self._dense(self.dense_i, xi),
                self._dense(self.dense_r, xi) + self._dense(self.dense_i, xr))


def complex_prelu(x: ComplexPair, alpha_r: torch.Tensor, alpha_i: torch.Tensor) -> ComplexPair:
    """PReLU on each part with its own slope (the reference's choice)."""
    xr, xi = x
    return torch.where(xr >= 0, xr, alpha_r * xr), torch.where(xi >= 0, xi, alpha_i * xi)
