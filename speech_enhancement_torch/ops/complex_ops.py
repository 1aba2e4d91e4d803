"""Complex batch norms (counterpart of speech_enhancement_tpu/ops/complex_ops.py).

``ComplexBatchNormSimple`` (DCUnet's) is two independent real BatchNorms,
``bn_re`` and ``bn_im`` (the reference DCUnet's names). ``ComplexBatchNorm``
(DCCRN's) whitens with the full 2x2 covariance, as below.
Per channel: subtract the complex mean, whiten by the inverse matrix square
root of the (Vrr, Vri; Vri, Vii) covariance, then apply a 2x2 affine
(Wrr/Wri/Wii, Br/Bi). Parameter and buffer names are the reference torch
DCCRN's (``Wrr``..., running stats ``RMr``...``RVii``), so a reference
``state_dict`` loads as it is.

Takes and returns a pair ``(real, imag)`` of [B, C, ...] tensors (channels
on axis 1). The whitening math runs in float32 whatever the input dtype;
the centred path casts its output back to the input dtype, the folded path
applies per-channel coefficients in the input dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from speech_enhancement_torch.ops.batch_norm import BatchNorm

ComplexPair = Tuple[torch.Tensor, torch.Tensor]


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

    def forward(self, xr: torch.Tensor, xi: torch.Tensor) -> ComplexPair:
        if self.fold:
            return self._folded(xr, xi)
        reduce_dims = [d for d in range(xr.dim()) if d != 1]
        bshape = (1, -1) + (1,) * (xr.dim() - 2)
        fr = xr.float()
        fi = xi.float()
        if self.training:
            mean_r = fr.mean(dim=reduce_dims)
            mean_i = fi.mean(dim=reduce_dims)
            cr = fr - mean_r.view(bshape)
            ci = fi - mean_i.view(bshape)
            vrr = (cr * cr).mean(dim=reduce_dims)
            vii = (ci * ci).mean(dim=reduce_dims)
            vri = (cr * ci).mean(dim=reduce_dims)
            self._update({"mean_r": mean_r, "mean_i": mean_i, "vrr": vrr,
                          "vii": vii, "vri": vri})
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

    def _folded(self, xr: torch.Tensor, xi: torch.Tensor) -> ComplexPair:
        reduce_dims = [d for d in range(xr.dim()) if d != 1]
        bshape = (1, -1) + (1,) * (xr.dim() - 2)
        stats = None
        if self.training:
            fr = xr.float()
            fi = xi.float()
            mean_r = fr.mean(dim=reduce_dims)
            mean_i = fi.mean(dim=reduce_dims)
            stats = {
                "mean_r": mean_r, "mean_i": mean_i,
                "vrr": torch.clamp((fr * fr).mean(dim=reduce_dims) - mean_r * mean_r, min=0.0),
                "vii": torch.clamp((fi * fi).mean(dim=reduce_dims) - mean_i * mean_i, min=0.0),
                "vri": (fr * fi).mean(dim=reduce_dims) - mean_r * mean_i,
            }
            self._update(stats)
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
