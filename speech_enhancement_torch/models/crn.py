"""CRN, the convolutional recurrent masking net (counterpart of
speech_enhancement_tpu/models/crn.py).

  [B, 1, F, T, 2] spectrum -> magnitude
      -> 5 causal conv blocks (k (3, 2), s (2, 1), time pad (1, 0), BN, ELU)
      -> 2 LSTM layers over the channel-major flatten c * F + f (1792 wide
         at n_fft 512)
      -> 5 causal transposed-conv blocks on [trunk, skip] (time chomp,
         torch's output_padding (1, 0) on the fourth, BN, ELU; ReLU last)
      -> magnitude mask times the input spectrum

Activations flow NCHW ([B, C, F, T]). ``amplitude_compat=True`` keeps the
reference's ``sqrt(re^2 - im^2)`` (NaN where im > re); the default is the
true magnitude ``sqrt(re^2 + im^2 + 1e-8)``.

Precision (``dtype="bfloat16"``): the convolutions and the LSTMs in bf16,
BatchNorm and everything after it in f32; parameters stay f32.
``fused_rnn=True`` runs both LSTM layers through the recurrence kernels
(``kernels/lstm.py``: one forward launch a layer, and one backward launch
a layer in training) on a CUDA tensor and their plain versions on a CPU
tensor, in either dtype (at the class default f32 the 1792-wide layers
take the kernels' wide design); False runs the plain loop, the JAX
``lax.scan`` path.

Parameter names are the reference torch CRN's (``conv_block_{i}.conv``,
``conv_block_{i}.norm``, ``lstm_layer.*_l{0,1}``, ``tran_conv_block_{i}``),
so ``compat.crn_state_from_jax`` and the JAX package's
``crn_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import STFT_MONO, SignalSpec
from speech_enhancement_torch.ops.batch_norm import BatchNorm
from speech_enhancement_torch.ops.rnn import RNNStack, lecun_normal

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ENC_CHANNELS = (16, 32, 64, 128, 256)
_DEC_CHANNELS = (128, 64, 32, 16, 1)


class _CausalConvBlock(nn.Module):
    """Conv2d k (3, 2) s (2, 1): frequency VALID, time causal (pad left 1);
    then BatchNorm and ELU."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, out_ch, (3, 2), stride=(2, 1))
        with torch.no_grad():
            self.conv.weight.copy_(lecun_normal((out_ch, in_ch, 3, 2), in_ch * 6, generator))
            self.conv.bias.zero_()
        self.norm = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, time_mode: str = "offline") -> torch.Tensor:
        """``time_mode="stream"`` takes no time pad: the streaming caller
        prepends the cached previous frame (serve/streaming.py)."""
        cd = self.dtype
        x = F.pad(x.to(cd), (1 if time_mode == "offline" else 0, 0))
        y = F.conv2d(x, self.conv.weight.to(cd), self.conv.bias.to(cd), stride=(2, 1))
        return F.elu(self.norm(y))


class _CausalTransConvBlock(nn.Module):
    """ConvTranspose2d k (3, 2) s (2, 1), the last frame chomped; torch's
    ``output_padding`` (extra_freq_pad, 0) appends high-frequency rows that
    get the bias alone; then BatchNorm and ELU (ReLU on the last block)."""

    def __init__(self, in_ch: int, out_ch: int, is_last: bool, extra_freq_pad: int,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.dtype = dtype
        self.is_last = is_last
        self.extra_freq_pad = extra_freq_pad
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, (3, 2), stride=(2, 1))
        with torch.no_grad():
            # flax ConvTranspose's default init: fan-in of its HWIO kernel
            self.conv.weight.copy_(lecun_normal((in_ch, out_ch, 3, 2), in_ch * 6, generator))
            self.conv.bias.zero_()
        self.norm = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, time_mode: str = "offline") -> torch.Tensor:
        """``time_mode="stream"``: the caller prepends the cached previous
        input frame, and the T + 2 outputs are sliced [1:-1] instead of
        [:-1], so a chunk's outputs are the offline frames."""
        cd = self.dtype
        y = F.conv_transpose2d(x.to(cd), self.conv.weight.to(cd), self.conv.bias.to(cd),
                               stride=(2, 1), output_padding=(self.extra_freq_pad, 0))
        # causal chomp of the last frame
        y = self.norm(y[..., :-1] if time_mode == "offline" else y[..., 1:-1])
        return F.relu(y) if self.is_last else F.elu(y)


class CRN(nn.Module):
    SPEC: SignalSpec = STFT_MONO

    def __init__(self, n_fft: int = 512, use_lstm: bool = True, amplitude_compat: bool = False,
                 dtype: str = "float32", fused_rnn: bool = False, hop_length: int = 128,
                 win_length: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(fused_rnn, bool):
            raise ValueError(
                f"fused_rnn takes True or False, got {fused_rnn!r} (the kernel wrappers "
                "already pick the kernel or its plain version by device)")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        cd = _DTYPES[dtype]
        self.compute_dtype = cd
        # the STFT the model is served behind (the config's n_fft, hop_length,
        # win_length); only serve/streaming.py reads hop and window
        self.n_fft = n_fft
        self.hop_length = int(hop_length)
        self.win_length = int(win_length or n_fft)
        self.use_lstm = use_lstm
        self.amplitude_compat = amplitude_compat
        self.fused_rnn = fused_rnn
        n_freq = n_fft // 2 + 1
        in_ch = 1
        for i, out_ch in enumerate(_ENC_CHANNELS):
            setattr(self, f"conv_block_{i + 1}", _CausalConvBlock(in_ch, out_ch, cd, generator))
            in_ch, n_freq = out_ch, (n_freq - 3) // 2 + 1
        self.width = _ENC_CHANNELS[-1] * n_freq  # 1792 at n_fft 512
        if use_lstm:
            self.lstm_layer = RNNStack("lstm", self.width, self.width, num_layers=2, dtype=cd,
                                       fused=fused_rnn, generator=generator)
        trunk = _ENC_CHANNELS[-1]
        for i, out_ch in enumerate(_DEC_CHANNELS):
            skip = _ENC_CHANNELS[len(_ENC_CHANNELS) - 1 - i]
            setattr(self, f"tran_conv_block_{i + 1}", _CausalTransConvBlock(
                trunk + skip, out_ch, i == len(_DEC_CHANNELS) - 1, 1 if i == 3 else 0, cd,
                generator))
            trunk = out_ch

    # -- stages (forward composes them; chip_smoke.py times each) ----------
    def magnitude(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, F, T, 2] -> [B, 1, F, T] f32."""
        re, im = x[..., 0].float(), x[..., 1].float()
        if self.amplitude_compat:
            return torch.sqrt(re**2 - im**2)  # the reference's NaN quirk
        return torch.sqrt(re**2 + im**2 + 1e-8)

    def encode(self, h: torch.Tensor) -> List[torch.Tensor]:
        """Magnitude [B, 1, F, T] -> every encoder block's output (the last is the trunk)."""
        skips = []
        for i in range(len(_ENC_CHANNELS)):
            h = getattr(self, f"conv_block_{i + 1}")(h)
            skips.append(h)
        return skips

    def recur(self, h: torch.Tensor) -> torch.Tensor:
        """The two LSTM layers over [B, C, F, T] -> same shape (compute dtype)."""
        if not self.use_lstm:
            return h
        batch, n_chan, n_freq, n_frame = h.shape
        # channel-major flatten: feature c * F + f (the reference's order)
        flat = h.permute(0, 3, 1, 2).reshape(batch, n_frame, n_chan * n_freq)
        flat = self.lstm_layer(flat)
        return flat.reshape(batch, n_frame, n_chan, n_freq).permute(0, 2, 3, 1)

    def decode(self, d: torch.Tensor, skips: List[torch.Tensor]) -> torch.Tensor:
        """Trunk + skips -> the magnitude mask [B, 1, F, T] f32."""
        for i in range(len(_DEC_CHANNELS)):
            skip = skips[len(skips) - 1 - i]
            d = getattr(self, f"tran_conv_block_{i + 1}")(torch.cat([d.float(), skip], dim=1))
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, F, T, 2] -> the masked spectrum of the same shape."""
        skips = self.encode(self.magnitude(x))
        mask = self.decode(self.recur(skips[-1]), skips)
        return mask[..., None] * x
