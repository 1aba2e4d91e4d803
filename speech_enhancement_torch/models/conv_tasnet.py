"""Conv-TasNet (counterpart of speech_enhancement_tpu/models/conv_tasnet.py;
Luo & Mesgarani 2019).

  [B, C, T] mixture
      -> encoder Conv1d (k L, stride L / 2, no bias) + ReLU: [B, N, K]
      -> separator: cLN, 1x1 bottleneck to B channels, R x X temporal
         blocks (1x1 conv to H, PReLU, gLN / cLN, depthwise dilated conv
         2^x with causal or centred pads, PReLU, norm, 1x1 back to B, added
         to the block's input; with ``skip`` a second 1x1 whose outputs are
         summed), 1x1 mask conv to S N, ReLU or softmax over the speakers
      -> decoder: the masked encoding through a linear basis (N -> C L)
         and the overlap-add at hop L / 2 in f32 (``ops/frame.py``)
      -> [B, S, C, T]

Activations [B, channels, K]. The convs run in ``dtype`` and so do the
masks (as the JAX module's mask conv); PReLU promotes to f32 against its
f32 slope, the norms keep their statistics in f32, and the overlap-add is
f32. Parameter names are the reference's (``encoder.conv1d_U``,
``separator.network.{0,1,2,3}``, or with ``skip`` ``separator.layer_norm`` /
``bottleneck_conv1x1`` / ``temporal_conv_net`` / ``mask_conv1x1``; blocks
``{r}.{x}.net.{0,1,2,3}`` with the depthwise separable conv's
``net.{0,1,2}``, ``pointwise_conv`` and ``skip_conv``; norms ``gamma`` /
``beta`` [1, N, 1]; ``decoder.basis_signals``), so
``compat.conv_tasnet_state_from_jax`` and the JAX package's
``conv_tasnet_from_torch_state`` map weights one to one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speech_enhancement_torch.models.types import WAV_MULTI, SignalSpec
from speech_enhancement_torch.ops.frame import overlap_add
from speech_enhancement_torch.ops.layers import compute_dtype, conv, linear, run_conv
from speech_enhancement_torch.ops.norms import channelwise_layer_norm, global_layer_norm


class _PReLU(nn.Module):
    """One slope (init 0.25); f32 out, as flax promotes against it."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return torch.where(x >= 0, x, self.weight * x)


class _Norm(nn.Module):
    """gLN or cLN over [B, C, K] with the reference's ``gamma`` / ``beta`` [1, C, 1]."""

    def __init__(self, norm_type: str, channels: int):
        super().__init__()
        if norm_type not in ("gLN", "cLN"):
            raise ValueError(f"unsupported norm {norm_type!r}")
        self.norm_type = norm_type
        self.gamma = nn.Parameter(torch.ones(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = global_layer_norm if self.norm_type == "gLN" else channelwise_layer_norm
        y = fn(x.transpose(1, 2), self.gamma.reshape(-1), self.beta.reshape(-1))
        return y.transpose(1, 2)


class _DepthwiseSeparable(nn.Module):
    def __init__(self, hidden: int, bottleneck: int, kernel: int, dilation: int, norm_type: str,
                 causal: bool, skip: bool, generator: Optional[torch.Generator]):
        super().__init__()
        pad = (kernel - 1) * dilation
        self.pads = [(pad, 0)] if causal else [(pad // 2, pad - pad // 2)]
        self.net = nn.ModuleList([
            conv(hidden, hidden, kernel, generator, dilation=dilation, groups=hidden, bias=False),
            _PReLU(), _Norm(norm_type, hidden)])
        self.pointwise_conv = conv(hidden, bottleneck, 1, generator, bias=False)
        self.skip_conv = conv(hidden, bottleneck, 1, generator, bias=False) if skip else None

    def forward(self, x: torch.Tensor, cd: torch.dtype):
        depthwise, prelu, norm = self.net
        y = norm(prelu(run_conv(depthwise, x, cd, self.pads)))
        out = run_conv(self.pointwise_conv, y, cd)
        skip = None if self.skip_conv is None else run_conv(self.skip_conv, y, cd)
        return out, skip


class _TemporalBlock(nn.Module):
    def __init__(self, hidden: int, bottleneck: int, kernel: int, dilation: int, norm_type: str,
                 causal: bool, skip: bool, generator: Optional[torch.Generator]):
        super().__init__()
        self.net = nn.ModuleList([
            conv(bottleneck, hidden, 1, generator, bias=False), _PReLU(),
            _Norm(norm_type, hidden),
            _DepthwiseSeparable(hidden, bottleneck, kernel, dilation, norm_type, causal, skip,
                                generator)])

    def forward(self, x: torch.Tensor, cd: torch.dtype):
        conv1x1, prelu, norm, dsconv = self.net
        out, skip = dsconv(norm(prelu(run_conv(conv1x1, x, cd))), cd)
        return x + out, skip


class _Encoder(nn.Module):
    def __init__(self, channels: int, n: int, length: int, generator):
        super().__init__()
        self.conv1d_U = conv(channels, n, length, generator, stride=length // 2, bias=False)


class _Decoder(nn.Module):
    def __init__(self, n: int, out: int, generator):
        super().__init__()
        self.basis_signals = linear(n, out, generator, bias=False)


class _Separator(nn.Module):
    """The reference's two layouts: one ``network`` list, or named parts with ``skip``."""

    _NAMES = ("layer_norm", "bottleneck_conv1x1", "temporal_conv_net", "mask_conv1x1")

    def __init__(self, parts: Sequence[nn.Module], skip: bool):
        super().__init__()
        self.skip = skip
        if skip:
            for name, part in zip(self._NAMES, parts):
                setattr(self, name, part)
        else:
            self.network = nn.ModuleList(parts)

    def parts(self):
        return ([getattr(self, name) for name in self._NAMES] if self.skip
                else list(self.network))


class ConvTasNet(nn.Module):
    SPEC: SignalSpec = WAV_MULTI

    def __init__(self, sources: Sequence = (None, None), N: int = 128, L: int = 40,
                 B: int = 128, H: int = 256, P: int = 3, X: int = 7, R: int = 2,
                 audio_channels: int = 2, norm_type: str = "gLN", causal: bool = False,
                 mask_nonlinear: str = "relu", skip: bool = False, dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mask_nonlinear not in ("relu", "softmax"):
            raise ValueError(f"unsupported mask nonlinearity {mask_nonlinear!r}")
        self.compute_dtype = compute_dtype(dtype)
        self.n_spk = len(sources)
        self.N, self.L, self.audio_channels = N, L, audio_channels
        self.mask_nonlinear = mask_nonlinear
        self.encoder = _Encoder(audio_channels, N, L, generator)
        tcn = nn.ModuleList([
            nn.ModuleList([_TemporalBlock(H, B, P, 2**x, norm_type, causal, skip, generator)
                           for x in range(X)]) for _ in range(R)])
        self.separator = _Separator([_Norm("cLN", N), conv(N, B, 1, generator, bias=False), tcn,
                                     conv(B, self.n_spk * N, 1, generator, bias=False)], skip)
        self.decoder = _Decoder(N, audio_channels * L, generator)

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, S, C, T]."""
        cd = self.compute_dtype
        length = mixture.shape[-1]
        mixture_w = F.relu(run_conv(self.encoder.conv1d_U, mixture, cd))  # [B, N, K]
        layer_norm, bottleneck, tcn, mask_conv = self.separator.parts()
        y = run_conv(bottleneck, layer_norm(mixture_w), cd)
        skip_sum = None
        for repeat in tcn:
            for block in repeat:
                y, skip = block(y, cd)
                if skip is not None:
                    skip_sum = skip if skip_sum is None else skip_sum + skip
        mask = run_conv(mask_conv, skip_sum if self.separator.skip else y, cd)
        batch, _, k_frames = mask.shape
        mask = mask.reshape(batch, self.n_spk, self.N, k_frames)
        mask = torch.softmax(mask, dim=1) if self.mask_nonlinear == "softmax" else F.relu(mask)
        source_w = (mixture_w[:, None] * mask).transpose(2, 3)  # [B, S, K, N]
        basis = self.decoder.basis_signals.weight
        frames = F.linear(source_w, basis.to(cd)).float()  # [B, S, K, C L]; OLA in f32
        frames = frames.reshape(batch, self.n_spk, k_frames, self.audio_channels, self.L)
        est = overlap_add(frames.permute(0, 1, 3, 2, 4), self.L // 2)  # [B, S, C, T']
        pad = length - est.shape[-1]
        if pad > 0:
            est = F.pad(est, (0, pad))
        return est[..., :length]
