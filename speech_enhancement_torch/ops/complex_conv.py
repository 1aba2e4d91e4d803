"""DCCRN's complex (transposed) convolutions as one real conv each.

Counterpart of the convolutions inside the JAX package's
``models/dccrn.py:_ComplexConvBlock`` / ``_ComplexDeconvBlock`` with
``layout="nchw"``. Activations are stacked ``[B, 2C, F, T]`` with the
real-part channels first; the block kernel ``[[Wr, -Wi], [Wi, Wr]]`` makes
one real conv compute the complex product. The DCCRN blocks and the plain
versions of the fused-block kernels (``kernels/conv_block.py``) both call
these, so the convolution is written once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_block_kernel(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Conv2d pair [Cout, Cin, kh, kw] -> block kernel [2Cout, 2Cin, kh, kw]."""
    return torch.cat([torch.cat([wr, -wi], 1), torch.cat([wi, wr], 1)], 0)


def deconv_block_kernel(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d pair [Cin, Cout, kh, kw] -> block kernel [2Cin, 2Cout, kh, kw]."""
    return torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0)


def complex_conv(x2: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 time_mode: str = "offline") -> torch.Tensor:
    """Stride (2, 1), freq pad (2, 2), causal time pad (1, 0):
    [B, 2Cin, F, T] -> [B, 2Cout, F/2, T].

    ``time_mode="stream"`` takes no time pad: the streaming caller prepends
    the cached previous frame (serve/streaming.py), so [.., T + 1] in gives
    the offline frames at those T indices."""
    x2 = F.pad(x2, (1 if time_mode == "offline" else 0, 0, 2, 2))  # time (1, 0), freq (2, 2)
    return F.conv2d(x2, kernel, bias, stride=(2, 1))


def complex_deconv(joined: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   time_mode: str = "offline") -> torch.Tensor:
    """Transposed conv, stride (2, 1), freq crop [2:-1], time chomp [1:]:
    [B, 2Cin, F, T] -> [B, 2Cout, 2F, T].

    ``time_mode="stream"``: the caller prepends the cached previous input
    frame and the time slice is [1:-1], so the T output frames of a
    [.., T + 1] input are the offline frames one earlier (the one-frame
    lookahead of each decoder layer becomes a one-frame delay)."""
    # torch's padding=(2, 0), output_padding=(1, 0) is the VALID transpose
    # cropped to rows [2:-1]; the time axis grows by one and loses its
    # first frame (the reference's chomp)
    y2 = F.conv_transpose2d(joined, kernel, bias, stride=(2, 1), padding=(2, 0),
                            output_padding=(1, 0))
    return y2[..., 1:] if time_mode == "offline" else y2[..., 1:-1]


def complex_cat(x2: torch.Tensor, skip2: torch.Tensor) -> torch.Tensor:
    """The decoder's skip join: channels [x_r, skip_r, x_i, skip_i]."""
    cx, cs = x2.shape[1] // 2, skip2.shape[1] // 2
    return torch.cat([x2[:, :cx], skip2[:, :cs], x2[:, cx:], skip2[:, cs:]], dim=1)


def hwio_from_conv(kernel: torch.Tensor) -> torch.Tensor:
    """Conv2d block kernel [O, I, kh, kw] -> the JAX HWIO kernel [kh, kw, I, O]."""
    return kernel.permute(2, 3, 1, 0)


def conv_from_hwio(w2: torch.Tensor) -> torch.Tensor:
    return w2.permute(3, 2, 0, 1)


def hwio_from_deconv(kernel: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d block kernel [I, O, kh, kw] -> the JAX HWIO kernel of
    ``lax.conv_transpose`` [kh, kw, I, O], which is its spatial flip."""
    return kernel.flip(2, 3).permute(2, 3, 0, 1)


def deconv_from_hwio(w2: torch.Tensor) -> torch.Tensor:
    return w2.permute(2, 3, 0, 1).flip(2, 3)

