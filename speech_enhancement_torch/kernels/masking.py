"""DCCRN masking mode 'E': CUDA kernel wrapper and plain version.

Counterpart of speech_enhancement_tpu/ops/pallas/masking.py
(``apply_mask_e``). The kernel is ``csrc/masking.cu``; its source says
what bounds it and how it is laid out.

``mask_e_kernel`` launches the kernel for CUDA tensors and runs
``mask_e_plain`` for CPU tensors; any other device raises. There is no
fallback from the kernel to the plain version. On CUDA tensors it goes
through :class:`MaskE`, an autograd Function (counterpart of the JAX
``apply_mask_e_diff``) whose forward is the kernel and whose backward is
the gradient of the pole-free formula :func:`mask_e_ref` in plain PyTorch,
as it is XLA in JAX: the ``1e-12`` inside its square root keeps the
gradient finite where the mask is zero.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from speech_enhancement_torch.kernels import _build


def mask_e_plain(xr, xi, mr, mi) -> Tuple[torch.Tensor, torch.Tensor]:
    """``s = tanh(|M|)/(|M|+1e-8)``, ``out = s * (X * M)`` (complex product)."""
    mag = torch.sqrt(mr * mr + mi * mi)
    scale = torch.tanh(mag) / (mag + 1e-8)
    return scale * (xr * mr - xi * mi), scale * (xr * mi + xi * mr)


def mask_e_ref(xr, xi, mr, mi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask E with ``|M| = sqrt(mr^2 + mi^2 + 1e-12)``, the form whose
    gradient :class:`MaskE` takes (JAX ``_mask_e_ref``)."""
    mag = torch.sqrt(mr * mr + mi * mi + 1e-12)
    scale = torch.tanh(mag) / (mag + 1e-8)
    return scale * (xr * mr - xi * mi), scale * (xr * mi + xi * mr)


class MaskE(torch.autograd.Function):
    """Mask E with the kernel forward (plain on CPU tensors) and the
    backward of :func:`mask_e_ref`."""

    @staticmethod
    def forward(ctx, xr, xi, mr, mi):
        ctx.save_for_backward(xr, xi, mr, mi)
        if xr.device.type == "cpu":
            return mask_e_plain(xr, xi, mr, mi)
        return _launch(xr, xi, mr, mi)

    @staticmethod
    def backward(ctx, g_r, g_i):
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
            outs = mask_e_ref(*inputs)
            return torch.autograd.grad(outs, inputs, (g_r, g_i))


@functools.cache
def _entry():
    fn = _build.library("masking").mask_e_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mask_e_kernel(xr, xi, mr, mi) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask mode 'E' over four same-shape f32 arrays -> (out_r, out_i).

    On CUDA tensors this launches ``csrc/masking.cu`` on the current stream
    (counted in ``mask_e_kernel.launches``), differentiably through
    :class:`MaskE`; on CPU tensors it runs :func:`mask_e_plain`.
    """
    arrays = (xr, xi, mr, mi)
    if any(a.shape != xr.shape for a in arrays):
        raise ValueError(f"shapes differ: {[tuple(a.shape) for a in arrays]}")
    if any(a.device != xr.device for a in arrays):
        raise ValueError(f"devices differ: {[str(a.device) for a in arrays]}")
    if xr.device.type == "cpu":
        return mask_e_plain(xr, xi, mr, mi)
    if xr.device.type != "cuda":
        raise ValueError(f"mask_e_kernel runs on cuda or cpu tensors, not {xr.device}")
    if any(a.dtype != torch.float32 for a in arrays):
        raise TypeError(f"mask_e_kernel takes float32, got {[a.dtype for a in arrays]}")
    if any(not a.is_contiguous() or a.data_ptr() % 16 for a in arrays):
        raise ValueError("mask_e_kernel takes contiguous, 16-byte aligned arrays")
    if xr.numel() == 0:
        raise ValueError("mask_e_kernel takes non-empty arrays")
    if torch.is_grad_enabled() and any(a.requires_grad for a in arrays):
        return MaskE.apply(xr, xi, mr, mi)
    return _launch(xr, xi, mr, mi)


def _launch(xr, xi, mr, mi) -> Tuple[torch.Tensor, torch.Tensor]:
    out_r = torch.empty_like(xr)
    out_i = torch.empty_like(xr)
    fn = _entry()
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        code = fn(xr.data_ptr(), xi.data_ptr(), mr.data_ptr(), mi.data_ptr(),
                  out_r.data_ptr(), out_i.data_ptr(), xr.numel(), stream)
    _build.check(_build.library("masking"), code, "mask_e_kernel launch")
    mask_e_kernel.launches += 1
    return out_r, out_i


mask_e_kernel.launches = 0
