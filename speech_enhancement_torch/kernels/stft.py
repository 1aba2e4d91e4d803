"""Fused framing + basis-matmul STFT: CUDA kernel wrapper and plain version.

Counterpart of speech_enhancement_tpu/ops/pallas/stft.py (``stft_pallas``).
The kernel is ``csrc/stft.cu``; its source says what bounds it and how it
is laid out. It has two designs, which the C code picks from the geometry:
split-f32 operands on tensor cores (3xTF32) where the signal, the hop and
the window are whole 16-byte words, and the first design's f32 FMA
elsewhere; :func:`tc_plan` mirrors the choice and :func:`stft_design` asks
the built library for it.

``stft_kernel`` launches the kernel for a CUDA tensor and runs
``stft_plain`` for a CPU tensor; any other device raises. There is no
fallback from the kernel to the plain version. When the signal needs a
gradient, the CUDA branch goes through :class:`STFT`, an autograd Function
(counterpart of the JAX ``stft_pallas_diff``) whose backward is the exact
cotangent of the signal, ``g @ basis^T`` overlap-added at the hop, in plain
PyTorch (XLA in JAX); the basis gets no gradient (JAX returns zeros).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from speech_enhancement_torch.kernels import _build
from speech_enhancement_torch.ops.frame import overlap_add

_MAX_ROWS = 65535 * 128  # grid.y holds the 128-frame row tiles (csrc/stft.cu)

# csrc/stft.cu, namespace tc: frames and columns a block, taps a slab, the
# ring's slots, the floats of a split slab
TC_BM, TC_BN, TC_BK, TC_STAGES = 128, 176, 16, 3
TC_SPLIT_FLOATS = (TC_BK // 8) * (TC_BN // 8) * 32 * 4
H100_SHARED = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100


def tc_plan(batch: int, total: int, hop: int, win: int, dim: int, aligned: bool = True,
            smem_limit: int = H100_SHARED):
    """``tc::make_plan`` of ``csrc/stft.cu``, line for line: the split-f32
    kernel's plan (``gap``: floats between two batch items' pieces of a
    block's signal span; ``span_floats``; ``col_tiles``; ``smem_bytes``), or
    None where the first design runs. ``aligned``: x and the scratch at a
    16-byte address, the output at 8. Change both together."""
    n_frames = (total - win) // hop + 1
    if not aligned or total % 4 or hop % 4 or win % 8 or dim % 2:
        return None
    gap = -(-max(win - hop, 0) // 32) * 32
    pieces = min((n_frames - 1 + TC_BM - 1) // n_frames + 1, batch)
    span = (TC_BM - 1) * hop + win + (pieces - 1) * gap
    smem = 4 * TC_STAGES * TC_SPLIT_FLOATS + -(-4 * span // 16) * 16 + 8 * (TC_STAGES + 1)
    if smem > smem_limit:
        return None
    return {"gap": gap, "span_floats": span, "col_tiles": -(-dim // TC_BN), "smem_bytes": smem}


def stft_plain(x: torch.Tensor, basis: torch.Tensor, hop: int, win: int) -> torch.Tensor:
    """[B, T] x [win, D] -> [B, n_frames, D], n_frames = (T - win)//hop + 1."""
    return torch.matmul(x.unfold(-1, win, hop), basis)


class STFT(torch.autograd.Function):
    """Frames of x times basis, with the signal's exact gradient."""

    @staticmethod
    def forward(ctx, x, basis, hop, win):
        ctx.save_for_backward(basis)
        ctx.geometry = (x.shape[-1], hop)
        if x.device.type == "cpu":
            return stft_plain(x, basis, hop, win)
        return _launch(x, basis, hop, win)

    @staticmethod
    def backward(ctx, g):
        (basis,) = ctx.saved_tensors
        total, hop = ctx.geometry
        sig = overlap_add(torch.matmul(g.float(), basis.float().t()), hop)
        cover = sig.shape[-1]  # (n_frames - 1) * hop + win <= total
        sig = F.pad(sig, (0, total - cover)) if cover < total else sig[..., :total]
        return sig, None, None, None


def stft_design(batch: int, total: int, hop: int, win: int, dim: int, aligned: bool = True):
    """("tc", plan) or ("simt", None): the design ``csrc/stft.cu`` takes on
    the current card for this geometry, as its ``stft_plan`` entry reports.
    Needs a card."""
    fn = _build.library("stft").stft_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    n_frames = (total - win) // hop + 1
    code = fn(batch, total, n_frames, hop, win, dim, int(aligned), ctypes.addressof(out))
    _build.check(_build.library("stft"), code, "stft_plan")
    if out[0] == 0:
        return "simt", None
    return "tc", dict(zip(("gap", "span_floats", "col_tiles", "smem_bytes"), out[1:]))


@functools.cache
def _entry():
    fn = _build.library("stft").stft_frames_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _split_floats(win: int, dim: int) -> int:
    """Floats of the scratch the split-f32 design splits the basis into."""
    fn = _build.library("stft").stft_split_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(win, dim)


def _check_inputs(x: torch.Tensor, basis: torch.Tensor, hop: int, win: int) -> None:
    if x.dim() != 2 or basis.dim() != 2:
        raise ValueError(f"want x [B, T] and basis [win, D], got {tuple(x.shape)} "
                         f"and {tuple(basis.shape)}")
    if basis.shape[0] != win:
        raise ValueError(f"basis has {basis.shape[0]} rows, want win={win}")
    if hop <= 0 or x.shape[-1] < win:
        raise ValueError(f"need hop > 0 and T >= win, got hop={hop}, T={x.shape[-1]}")
    if x.device != basis.device:
        raise ValueError(f"x on {x.device} but basis on {basis.device}")


def stft_kernel(x: torch.Tensor, basis: torch.Tensor, hop: int, win: int) -> torch.Tensor:
    """Frames of ``x`` [B, T] times ``basis`` [win, D] -> [B, n_frames, D] f32.

    The frame tensor is never stored. On a CUDA tensor this launches
    ``csrc/stft.cu`` on the current stream (counted in
    ``stft_kernel.launches``), through :class:`STFT` when x needs a
    gradient; on a CPU tensor it runs :func:`stft_plain`.
    """
    _check_inputs(x, basis, hop, win)
    if x.device.type == "cpu":
        return stft_plain(x, basis, hop, win)
    if x.device.type != "cuda":
        raise ValueError(f"stft_kernel runs on cuda or cpu tensors, not {x.device}")
    if x.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError(f"stft_kernel takes float32, got {x.dtype} and {basis.dtype}")
    if not (x.is_contiguous() and basis.is_contiguous()):
        raise ValueError("stft_kernel takes contiguous x and basis")
    batch, total = x.shape
    dim = basis.shape[1]
    n_frames = (total - win) // hop + 1
    if batch * n_frames > _MAX_ROWS:
        raise ValueError(f"stft_kernel takes at most {_MAX_ROWS} frames a launch, "
                         f"got {batch} x {n_frames}")
    if torch.is_grad_enabled() and x.requires_grad:
        return STFT.apply(x, basis, hop, win)
    return _launch(x, basis, hop, win)


def _launch(x: torch.Tensor, basis: torch.Tensor, hop: int, win: int) -> torch.Tensor:
    batch, total = x.shape
    dim = basis.shape[1]
    n_frames = (total - win) // hop + 1
    out = torch.empty((batch, n_frames, dim), dtype=torch.float32, device=x.device)
    # the basis in big and small parts, written by the launch itself
    split = torch.empty(_split_floats(win, dim), dtype=torch.float32, device=x.device)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), basis.data_ptr(), out.data_ptr(), split.data_ptr(), batch, total,
                  n_frames, hop, win, dim, stream)
    _build.check(_build.library("stft"), code, "stft_kernel launch")
    stft_kernel.launches += 1
    return out


stft_kernel.launches = 0
