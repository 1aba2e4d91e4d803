"""DCCRN, deep complex conv-recurrent net on raw waveform (Hu et al. 2020).

Counterpart of speech_enhancement_tpu/models/dccrn.py (inference and the
train() forward):

  wav -> ConvSTFT (win 400 / hop 100 / fft 512, non-centred, Hann)
      -> drop DC bin, complex encoder x6 (complex conv k=(5,2) s=(2,1),
         causal time pad, complex BN, PReLU)
      -> complex LSTM x2 (hidden rnn_units/2 per part, final projection);
         with ``use_clstm=False`` a real LSTM stack of rnn_units over the
         flattened [B, T, 2C * D] (channels [r..., i...]) and a Linear back
      -> complex decoder x6 (complex transposed conv, complex-cat skips,
         time chomp)
      -> mask head (modes E / C / R) -> ConviSTFT (pinv basis,
         window-envelope normalised) -> clamp(-1, 1)

Activations flow NCHW, stacked [B, 2C, F, T] with the real-part channels
first (the JAX package's ``layout="nchw"``). Each complex conv is one real
conv with the block kernel [[Wr, -Wi], [Wi, Wr]] on cuDNN. The decoder's
skip join concatenates [trunk_r, skip_r, trunk_i, skip_i], which equals
the JAX split-weight sum up to summation order.

Two hand-written CUDA kernels carry the front end and the mask head:
``use_stft_kernel`` (kernels/stft.py) and ``use_mask_kernel``
(kernels/masking.py). With True (the default) their wrappers launch the
kernel for a CUDA tensor and run the plain version for a CPU tensor; False
runs the plain framing + matmul / plain mask formula everywhere, the
counterpart of the JAX ``use_pallas_*=False``.

``use_fused_blocks=True`` (default False, as in the JAX package) runs the
encoder and decoder as the fused block kernels of kernels/conv_block.py:
activations flow as [B, F * 2C, T], each block is one launch that applies
the previous block's folded complex BN and PReLU to its input while it
reads it, and the decoder's skip join is never stored. In train() mode the
blocks are autograd Functions whose backward runs the backward kernels.
The parameters are the same either way.

``remat=True`` recomputes each unfused encoder and decoder block in the
backward pass, one block at a time (``torch.utils.checkpoint``,
non-reentrant), as the JAX ``nn.remat`` does. ``remat_policy`` is JAX's
named-saves policy: a comma-separated list of the names the model tags,
each kept rather than recomputed. ``conv_out`` is a block's (transposed)
conv output before complex BN: the conv runs in a region of its own whose
output is kept, so backward recomputes only its input's cast (and the
decoder's skip join), not the conv. ``cbn_stats`` are complex BN's batch
moments (``ops/complex_ops.py:_Moments``), reused by the recompute instead
of reduced again. A name the model does not tag saves nothing. The running
statistics move once a step either way. The STFT and the mask head stay
outside the recomputed blocks; the fused path ignores both options, as in
JAX.

Precision policy (``dtype="bfloat16"``): convs and LSTM in bf16, complex
BN statistics in f32, mask head and synthesis in f32. Parameters stay f32.

Parameter names follow the reference torch DCCRN (``encoder.{i}.0.
real_conv.weight``, ``encoder.{i}.1.Wrr``, ``encoder.{i}.2.weight``,
``enhance.{l}.real_lstm.weight_ih_l0``...), so ``compat`` converters on
both sides map weights one to one. The ``use_clstm=False`` branch, whose
reference keys no importer maps, is named after the flax modules:
``lstm.{l}.weight_ih_l0``... and ``transform.{weight,bias}``. As in JAX,
its LSTM layers (with bias, no ``fused``) and the Linear run in their
input's dtype promoted to f32, whatever ``dtype`` says.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from speech_enhancement_torch.kernels.conv_block import (conv_block_train, deconv_block_train,
                                                         fused_conv_block, fused_deconv_block,
                                                         identity_coeffs, pointwise)
from speech_enhancement_torch.kernels.masking import mask_e_kernel
from speech_enhancement_torch.kernels.stft import stft_kernel
from speech_enhancement_torch.models.types import WAV_MONO, SignalSpec
from speech_enhancement_torch.ops.complex_conv import (complex_cat, complex_conv, complex_deconv,
                                                       conv_block_kernel, deconv_block_kernel,
                                                       hwio_from_conv, hwio_from_deconv)
from speech_enhancement_torch.ops.complex_ops import (ComplexBatchNorm, NamedSaves,
                                                      stats_from_partials)
from speech_enhancement_torch.ops.frame import frame_signal, overlap_add
from speech_enhancement_torch.ops.rnn import ComplexLSTM, Linear, LSTMLayer, lecun_normal

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@lru_cache(maxsize=8)
def _stft_bases(win_len: int, fft_len: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(forward [win, 2F], inverse [2F, win], window [win]), built in numpy."""
    n = np.arange(win_len)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)  # periodic Hann
    fourier = np.fft.rfft(np.eye(fft_len))[:win_len]  # [win, F]
    kernel = np.concatenate([np.real(fourier), np.imag(fourier)], axis=1).T  # [2F, win]
    inv = np.linalg.pinv(kernel).T  # [2F, win]
    fwd = (kernel * window).T.astype(np.float32)  # [win, 2F]
    inv = (inv * window).astype(np.float32)  # [2F, win]
    return fwd, inv, window.astype(np.float32)


def conv_stft(wav: torch.Tensor, fwd: torch.Tensor, win_inc: int,
              use_kernel: bool = True) -> torch.Tensor:
    """[B, T] -> [B, 2F, T'] with the (win - hop) pad on both sides.

    ``fwd`` is the window-folded basis [win, 2F]. With ``use_kernel`` and
    ``win % hop == 0`` it goes through the STFT kernel wrapper (the frame
    tensor is never stored); otherwise frames are cut and multiplied.
    """
    win_len = fwd.shape[0]
    pad = win_len - win_inc
    x = F.pad(wav, (pad, pad))
    if use_kernel and win_len % win_inc == 0:
        spec = stft_kernel(x.contiguous(), fwd, win_inc, win_len)
    else:
        spec = torch.matmul(frame_signal(x, win_len, win_inc), fwd)
    return spec.transpose(1, 2)  # [B, 2F, T']


def conv_istft(spec: torch.Tensor, inv: torch.Tensor, window: torch.Tensor,
               win_inc: int, length: int) -> torch.Tensor:
    """[B, 2F, T'] -> [B, length] via the pinv basis + window-envelope division."""
    win_len = inv.shape[1]
    frames = torch.matmul(spec.transpose(1, 2), inv)  # [B, T', win]
    signal = overlap_add(frames, win_inc)
    n_frames = spec.shape[-1]
    env = overlap_add((window * window).expand(n_frames, win_len), win_inc)
    signal = signal / (env + 1e-8)
    pad = win_len - win_inc
    return signal[..., pad : pad + length]


class _PReLU(nn.Module):
    """PReLU with a single alpha (torch ``nn.PReLU()`` parameter layout)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # alpha is f32: a bf16 x is promoted, as in the JAX package
        return torch.where(x >= 0, x, self.weight * x)


class _ConvPair(nn.Module):
    """(real, imag) kernels of a complex (transposed) conv, reference names.

    Conv2d layout [Cout, Cin, kh, kw]; ConvTranspose2d layout
    [Cin, Cout, kh, kw]. Only the parameters live here; the blocks run one
    real conv with the block kernel.
    """

    def __init__(self, shape: Sequence[int], fan_in: int, out_ch: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.real_conv = _Kernel(shape, fan_in, out_ch, generator)
        self.imag_conv = _Kernel(shape, fan_in, out_ch, generator)


class _Kernel(nn.Module):
    def __init__(self, shape, fan_in, out_ch, generator):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal(tuple(shape), fan_in, generator))
        self.bias = nn.Parameter(torch.zeros(out_ch))


def _split(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x2.shape[1] // 2
    return x2[:, :n], x2[:, n:]


def _cbn_prelu(cbn: ComplexBatchNorm, prelu: _PReLU, y2: torch.Tensor,
               saves: Optional[NamedSaves] = None) -> torch.Tensor:
    zr, zi = cbn(*_split(y2), saves=saves)
    return prelu(torch.cat([zr, zi], dim=1))


def recompute_block(conv, post, inputs: Sequence[torch.Tensor], names: frozenset
                    ) -> torch.Tensor:
    """``post(conv(*inputs), saves)`` recomputed in backward under JAX's
    named saves ``names`` (see the module note): with ``conv_out`` the conv
    is a checkpointed region of its own whose output autograd keeps, else
    one region runs both. ``post`` is None for a block without complex BN.
    """
    if post is None:
        return checkpoint(conv, *inputs, use_reentrant=False)
    saves = NamedSaves(names)
    if "conv_out" in names:
        y2 = checkpoint(conv, *inputs, use_reentrant=False)
        return checkpoint(lambda y: post(y, saves.run()), y2, use_reentrant=False)
    return checkpoint(lambda *a: post(conv(*a), saves.run()), *inputs, use_reentrant=False)


class _ComplexConvBlock(nn.Sequential):
    """Complex conv k=(k,2), s=(2,1), freq pad (2,2), causal time pad (1,0)
    + complex BN + PReLU, on stacked [B, 2Cin, F, T] -> [B, 2Cout, F/2, T]."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32, cbn_fold: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(
            _ConvPair((out_ch, in_ch, kernel_size, 2), kernel_size * 2 * in_ch, out_ch,
                      generator),
            ComplexBatchNorm(out_ch, fold=cbn_fold),
            _PReLU(),
        )
        self.dtype = dtype

    def block_kernel(self) -> Tuple[torch.Tensor, torch.Tensor]:
        conv = self[0]
        kernel = conv_block_kernel(conv.real_conv.weight, conv.imag_conv.weight)
        return kernel, torch.cat([conv.real_conv.bias, conv.imag_conv.bias])

    def conv(self, x2: torch.Tensor, time_mode: str = "offline") -> torch.Tensor:
        """The complex conv (the ``conv_out`` save point); ``time_mode`` as
        :func:`ops.complex_conv.complex_conv` takes it."""
        kernel, bias = self.block_kernel()
        return complex_conv(x2.to(self.dtype), kernel.to(self.dtype), bias.to(self.dtype),
                            time_mode)

    def post(self, y2: torch.Tensor, saves: Optional[NamedSaves] = None) -> torch.Tensor:
        """Complex BN and PReLU on the conv output."""
        return _cbn_prelu(self[1], self[2], y2, saves)

    def forward(self, x2: torch.Tensor, time_mode: str = "offline") -> torch.Tensor:
        return self.post(self.conv(x2, time_mode))


class _ComplexDeconvBlock(nn.Sequential):
    """Complex transposed conv k=(k,2), s=(2,1) on [trunk; skip] with freq
    crop [2:-1] and time chomp [1:], then complex BN + PReLU unless last."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, last: bool = False,
                 dtype: torch.dtype = torch.float32, cbn_fold: bool = False,
                 generator: Optional[torch.Generator] = None):
        # the fan-in of the JAX kernel [k, 2, in_ch, out_ch] (HWIO)
        pair = _ConvPair((in_ch, out_ch, kernel_size, 2), kernel_size * 2 * in_ch, out_ch,
                         generator)
        if last:
            super().__init__(pair)
        else:
            super().__init__(pair, ComplexBatchNorm(out_ch, fold=cbn_fold), _PReLU())
        self.dtype = dtype
        self.last = last

    def block_kernel(self) -> Tuple[torch.Tensor, torch.Tensor]:
        conv = self[0]
        kernel = deconv_block_kernel(conv.real_conv.weight, conv.imag_conv.weight)
        return kernel, torch.cat([conv.real_conv.bias, conv.imag_conv.bias])

    def forward(self, x2: torch.Tensor, skip2: torch.Tensor) -> torch.Tensor:
        return self.post(self.conv_skip(x2, skip2))

    def conv_skip(self, x2: torch.Tensor, skip2: torch.Tensor) -> torch.Tensor:
        """:meth:`conv` on the trunk and the skip joined (:func:`complex_cat`)."""
        return self.conv(complex_cat(x2.to(self.dtype), skip2.to(self.dtype)))

    def conv(self, joined: torch.Tensor, time_mode: str = "offline") -> torch.Tensor:
        """The complex transposed conv on the joined [trunk; skip] channels
        (the ``conv_out`` save point); ``time_mode`` as
        :func:`ops.complex_conv.complex_deconv` takes it."""
        kernel, bias = self.block_kernel()
        return complex_deconv(joined.to(self.dtype), kernel.to(self.dtype), bias.to(self.dtype),
                              time_mode)

    def post(self, y2: torch.Tensor, saves: Optional[NamedSaves] = None) -> torch.Tensor:
        """Complex BN and PReLU on the conv output (the last block has none)."""
        return y2 if self.last else _cbn_prelu(self[1], self[2], y2, saves)

    def deconv(self, joined: torch.Tensor, time_mode: str = "offline") -> torch.Tensor:
        """The block on the joined channels."""
        return self.post(self.conv(joined, time_mode))


class _FusedSkip(NamedTuple):
    """A fused encoder block's raw conv output [B, f * c2, T] and the
    pointwise still to apply to it: folded complex-BN coefficients and the
    PReLU slope."""

    y: torch.Tensor
    f: int
    c2: int
    coef: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    alpha: torch.Tensor


class DCCRN(nn.Module):
    SPEC: SignalSpec = WAV_MONO

    def __init__(
        self,
        rnn_layers: int = 2,
        rnn_units: int = 128,
        win_len: int = 400,
        win_inc: int = 100,
        fft_len: int = 512,
        masking_mode: str = "E",
        use_clstm: bool = True,
        kernel_size: int = 5,
        kernel_num: Sequence[int] = (16, 32, 64, 128, 256, 256),
        dtype: str = "float32",
        cbn_fold: bool = False,
        use_stft_kernel: bool = True,
        use_mask_kernel: bool = True,
        use_fused_blocks: bool = False,
        remat: bool = False,
        remat_policy: str = "",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not isinstance(use_fused_blocks, bool):
            raise ValueError(
                f"use_fused_blocks takes True or False, got {use_fused_blocks!r} (the "
                "kernel wrappers already pick the kernel or its plain version by device)")
        if masking_mode not in ("E", "C", "R"):
            raise ValueError(f"unknown masking_mode {masking_mode!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.win_len = win_len
        self.win_inc = win_inc
        self.fft_len = fft_len
        self.masking_mode = masking_mode
        self.use_stft_kernel = use_stft_kernel
        self.use_mask_kernel = use_mask_kernel
        self.use_fused_blocks = use_fused_blocks
        self.use_clstm = use_clstm
        # the names kept under remat (None: no remat); "".split(",") names
        # nothing the model tags, as JAX's empty policy saves nothing
        self.remat_names = frozenset(str(remat_policy).split(",")) if remat else None
        self.compute_dtype = _DTYPES[dtype]

        fwd, inv, window = _stft_bases(win_len, fft_len)
        self.register_buffer("stft_fwd", torch.from_numpy(fwd), persistent=False)
        self.register_buffer("stft_inv", torch.from_numpy(inv), persistent=False)
        self.register_buffer("stft_window", torch.from_numpy(window), persistent=False)

        cd = self.compute_dtype
        channels = [2] + list(kernel_num)  # stacked (r, i) channel counts
        self.encoder = nn.ModuleList(
            _ComplexConvBlock(channels[i] // 2, channels[i + 1] // 2, kernel_size, cd,
                              cbn_fold, generator)
            for i in range(len(kernel_num)))
        dims = fft_len // 2  # frequency rows after each stride-2 encoder conv
        for _ in kernel_num:
            dims = (dims - 1) // 2 + 1
        per_part = kernel_num[-1] // 2
        hidden = rnn_units // 2
        if use_clstm:
            self.enhance = nn.ModuleList(
                ComplexLSTM(per_part * dims if idx == 0 else hidden, hidden,
                            projection_dim=per_part * dims if idx == rnn_layers - 1 else None,
                            dtype=cd, generator=generator)
                for idx in range(rnn_layers))
        else:
            width = kernel_num[-1] * dims
            self.lstm = nn.ModuleList(
                LSTMLayer(width if idx == 0 else rnn_units, rnn_units, generator=generator)
                for idx in range(rnn_layers))
            self.transform = Linear(rnn_units, width, generator)
        dec_out = list(kernel_num[::-1][1:]) + [2]
        trunk = kernel_num[-1]
        decoder = []
        for idx, out in enumerate(dec_out):
            skip = kernel_num[len(kernel_num) - 1 - idx]
            decoder.append(_ComplexDeconvBlock(
                (trunk + skip) // 2, out // 2, kernel_size,
                last=idx == len(dec_out) - 1, dtype=cd, cbn_fold=cbn_fold,
                generator=generator))
            trunk = out
        self.decoder = nn.ModuleList(decoder)

    # -- stages (forward composes them; chip_smoke.py times each) ----------
    def analyze(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] -> (real, imag) spectra [B, F, T'] in f32, contiguous."""
        specs = conv_stft(wav.float(), self.stft_fwd, self.win_inc, self.use_stft_kernel)
        n_freq = self.fft_len // 2 + 1
        return specs[:, :n_freq].contiguous(), specs[:, n_freq:].contiguous()

    def encode(self, real: torch.Tensor, imag: torch.Tensor) -> List:
        """Spectra -> every encoder block's output (the last is the trunk).

        With ``use_fused_blocks`` each output is a :class:`_FusedSkip`: the
        block's raw conv output and the pointwise still to apply to it.
        """
        if self.use_fused_blocks:
            return self._encode_fused(real, imag)
        x2 = torch.stack([real[:, 1:], imag[:, 1:]], dim=1)  # DC bin dropped
        skips = []
        for block in self.encoder:
            if self._recomputing():
                x2 = recompute_block(block.conv, block.post, (x2,), self.remat_names)
            else:
                x2 = block(x2)
            skips.append(x2)
        return skips

    def _recomputing(self) -> bool:
        """remat applies to a train() forward under a gradient."""
        return self.remat_names is not None and self.training and torch.is_grad_enabled()

    def recur(self, x2) -> torch.Tensor:
        """Complex LSTM bottleneck on [B, 2C, D, T] -> same shape (fused:
        the last :class:`_FusedSkip` -> [B, D * 2C, T])."""
        if self.use_fused_blocks:
            return self._recur_fused(x2)
        batch, channels2, dims, frames = x2.shape
        if not self.use_clstm:  # [B, 2C, D, T] -> [B, T, 2C * D] and back
            flat = self._real_lstm(x2.permute(0, 3, 1, 2).reshape(batch, frames, -1))
            return flat.reshape(batch, frames, channels2, dims).permute(0, 2, 3, 1)
        channels = channels2 // 2
        xr, xi = _split(x2)
        # [B, C, D, T] -> [B, T, C*D] (C outer, D inner: the reference order)
        r_in = xr.permute(0, 3, 1, 2).reshape(batch, frames, channels * dims)
        i_in = xi.permute(0, 3, 1, 2).reshape(batch, frames, channels * dims)
        for layer in self.enhance:
            r_in, i_in = layer(r_in, i_in)
        xr = r_in.reshape(batch, frames, channels, dims).permute(0, 2, 3, 1)
        xi = i_in.reshape(batch, frames, channels, dims).permute(0, 2, 3, 1)
        return torch.cat([xr, xi], dim=1)

    def decode(self, x2: torch.Tensor, skips: List
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Trunk + skips -> (mask_real, mask_imag) [B, F, T] in f32, DC bin back."""
        if self.use_fused_blocks:
            return self._decode_fused(x2, skips)
        for idx, block in enumerate(self.decoder):
            skip2 = skips[len(skips) - 1 - idx]
            if self._recomputing():
                x2 = recompute_block(block.conv_skip, None if block.last else block.post,
                                     (x2, skip2), self.remat_names)
            else:
                x2 = block(x2, skip2)
        x2 = x2.float()  # mask head and synthesis in f32
        mask_real = F.pad(x2[:, 0], (0, 0, 1, 0))
        mask_imag = F.pad(x2[:, 1], (0, 0, 1, 0))
        return mask_real, mask_imag

    # -- use_fused_blocks: the JAX package's _fused_encoder_decoder ----------
    # Activations flow as [B, F * C2, T] (channels stacked [r..., i...] per
    # frequency row). Each block is one kernel launch that applies the
    # previous block's folded complex BN and PReLU while it reads its input.
    # In train() mode each block is the autograd Function conv_block_train /
    # deconv_block_train (backward kernels for the conv's input and weight
    # gradients); its per-row sums give the batch moments, which update the
    # running statistics and fold into the next block's coefficients as
    # ordinary autograd, as JAX composes them outside its custom VJPs.
    def _encode_fused(self, real: torch.Tensor, imag: torch.Tensor) -> List["_FusedSkip"]:
        batch, _, n_time = real.shape
        f = self.fft_len // 2  # DC bin dropped
        x = torch.stack([real[:, 1:], imag[:, 1:]], dim=2)  # [B, F, 2, T]
        x = x.reshape(batch, f * 2, n_time).to(self.compute_dtype)
        coef, alpha, c2in = identity_coeffs(2, x.device), torch.ones(1, device=x.device), 2
        outs = []
        for block in self.encoder:
            kernel, bias = block.block_kernel()
            cbn, prelu = block[1], block[2]
            c2out = bias.shape[0]
            args = (x, hwio_from_conv(kernel), bias, *coef, alpha)
            shapes = dict(f_in=f, c2in=c2in, c2out=c2out)
            stats = None
            if self.training:
                y, partials = conv_block_train(*args, **shapes)
                stats = stats_from_partials(partials, c2out, batch * (f // 2) * n_time)
                cbn._update(stats)
            else:
                y = fused_conv_block(*args, **shapes)
            coef, alpha = cbn.fold_coeffs(stats), prelu.weight
            x, f, c2in = y, f // 2, c2out
            outs.append(_FusedSkip(y, f, c2out, coef, alpha))
        return outs

    def _real_lstm(self, flat: torch.Tensor) -> torch.Tensor:
        """``use_clstm=False``: the LSTM layers, then the Linear in f32 (flax
        Dense promotes its input against the f32 kernel), on [B, T, 2C * D]."""
        for layer in self.lstm:
            flat, _ = layer(flat)
        return self.transform(flat, torch.promote_types(flat.dtype, torch.float32))

    def _recur_fused(self, last: "_FusedSkip") -> torch.Tensor:
        batch, _, n_time = last.y.shape
        c = last.c2 // 2
        z = pointwise(last.y.view(batch, last.f, last.c2, n_time), *last.coef, last.alpha)
        if not self.use_clstm:  # [B, F, 2C, T] -> [B, T, 2C * F] and back
            flat = self._real_lstm(z.permute(0, 3, 2, 1).reshape(batch, n_time, -1))
            x = flat.reshape(batch, n_time, last.c2, last.f).permute(0, 3, 2, 1)
            return x.reshape(batch, last.f * last.c2, n_time).to(self.compute_dtype)
        # [B, F, C, T] -> [B, T, C*F] (C outer, F inner: the reference order)
        r_in = z[:, :, :c].permute(0, 3, 2, 1).reshape(batch, n_time, c * last.f)
        i_in = z[:, :, c:].permute(0, 3, 2, 1).reshape(batch, n_time, c * last.f)
        for layer in self.enhance:
            r_in, i_in = layer(r_in, i_in)
        r = r_in.reshape(batch, n_time, c, last.f).permute(0, 3, 2, 1)
        i = i_in.reshape(batch, n_time, c, last.f).permute(0, 3, 2, 1)
        x = torch.cat([r, i], dim=2)  # [B, F, 2C, T]
        return x.reshape(batch, last.f * last.c2, n_time).to(self.compute_dtype)

    def _decode_fused(self, x: torch.Tensor, skips: List["_FusedSkip"]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch, _, n_time = x.shape
        f, c2x = skips[-1].f, skips[-1].c2
        # the LSTM output has no pointwise pending
        coef, alpha = identity_coeffs(c2x, x.device), torch.ones(1, device=x.device)
        for idx, block in enumerate(self.decoder):
            # skip k is encoder block 5-k's raw conv output; the kernel
            # applies that block's pointwise as it reads it
            skip = skips[len(skips) - 1 - idx]
            kernel, bias = block.block_kernel()
            c2out = bias.shape[0]
            args = (x, skip.y, hwio_from_deconv(kernel), bias, coef, alpha, skip.coef,
                    skip.alpha)
            shapes = dict(f_in=f, c2x=c2x, c2s=skip.c2, c2out=c2out)
            stats = None
            if self.training:  # the last block's stats go unused, as in JAX
                y, partials = deconv_block_train(*args, **shapes)
                if not block.last:
                    stats = stats_from_partials(partials, c2out, batch * 2 * f * n_time)
                    block[1]._update(stats)
            else:
                y = fused_deconv_block(*args, **shapes)
            if not block.last:
                coef, alpha = block[1].fold_coeffs(stats), block[2].weight
            x, f, c2x = y, 2 * f, c2out
        y = x.float().reshape(batch, f, 2, n_time)  # mask head and synthesis in f32
        return F.pad(y[:, :, 0], (0, 0, 1, 0)), F.pad(y[:, :, 1], (0, 0, 1, 0))

    def apply_mask(self, real, imag, mask_real, mask_imag) -> torch.Tensor:
        """Masking modes E / C / R -> masked spectrum [B, 2F, T]."""
        if self.masking_mode == "E" and self.use_mask_kernel:
            out_real, out_imag = mask_e_kernel(real, imag, mask_real, mask_imag)
        elif self.masking_mode == "E":
            # trig-free tanh(|M|)*|X| at phase(X)+phase(M); the 1e-12 keeps
            # the square root's gradient finite at M == 0
            mags = torch.sqrt(mask_real**2 + mask_imag**2 + 1e-12)
            scale = torch.tanh(mags) / (mags + 1e-8)
            out_real = scale * (real * mask_real - imag * mask_imag)
            out_imag = scale * (real * mask_imag + imag * mask_real)
        elif self.masking_mode == "C":
            out_real = real * mask_real - imag * mask_imag
            out_imag = real * mask_imag + imag * mask_real
        else:  # "R"
            out_real = real * mask_real
            out_imag = imag * mask_imag
        return torch.cat([out_real, out_imag], dim=1)

    def synthesize(self, spec: torch.Tensor, length: int) -> torch.Tensor:
        """Masked spectrum -> waveform [B, length], clamped to [-1, 1]."""
        wav = conv_istft(spec, self.stft_inv, self.stft_window, self.win_inc, length)
        return torch.clamp(wav, -1.0, 1.0)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] or [B, T] -> enhanced waveform of the same shape."""
        squeeze_channel = inputs.dim() == 3
        wav = inputs[:, 0] if squeeze_channel else inputs
        real, imag = self.analyze(wav)
        skips = self.encode(real, imag)
        x2 = self.recur(skips[-1])
        mask_real, mask_imag = self.decode(x2, skips)
        spec = self.apply_mask(real, imag, mask_real, mask_imag)
        out = self.synthesize(spec, wav.shape[-1])
        return out[:, None, :] if squeeze_channel else out
