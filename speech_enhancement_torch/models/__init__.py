"""Model registry of the port (counterpart of speech_enhancement_tpu/models/__init__.py).

Every family of the JAX package's registry: dnn, mel-rnn, rnn-stft-mask,
crn, unet, dcunet, dccrn, wav-unet, demucs, conv-tasnet, sepformer and tcn.
"""

from __future__ import annotations

import inspect
from typing import Optional, Tuple, Type

import torch
from torch import nn

from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.models.conv_tasnet import ConvTasNet
from speech_enhancement_torch.models.crn import CRN
from speech_enhancement_torch.models.dccrn import DCCRN
from speech_enhancement_torch.models.dcunet import DCUnet
from speech_enhancement_torch.models.demucs import Demucs
from speech_enhancement_torch.models.dnn import DNN
from speech_enhancement_torch.models.mel_rnn import MelRNN
from speech_enhancement_torch.models.sepformer import Sepformer
from speech_enhancement_torch.models.stft_rnn import RNNSTFTMask
from speech_enhancement_torch.models.tcn import DilatedTCN
from speech_enhancement_torch.models.types import SignalSpec
from speech_enhancement_torch.models.unet import UNet
from speech_enhancement_torch.models.wav_unet import WavUNet

_REGISTRY = {"dnn": DNN, "mel-rnn": MelRNN, "rnn-stft-mask": RNNSTFTMask, "crn": CRN,
             "unet": UNet, "dcunet": DCUnet, "dccrn": DCCRN, "wav-unet": WavUNet,
             "demucs": Demucs, "conv-tasnet": ConvTasNet, "sepformer": Sepformer,
             "tcn": DilatedTCN}


def model_names() -> list:
    return sorted(_REGISTRY)


def get_model_class(name: str) -> Type[nn.Module]:
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; options: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def param_count(module: nn.Module) -> int:
    """Parameters of ``module`` (running statistics excluded, as the JAX
    ``param_count`` counts the ``params`` tree)."""
    return sum(p.numel() for p in module.parameters())


def param_megabytes(module: nn.Module) -> float:
    """The parameters' bytes / 1e6, as in JAX."""
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 1e6


def build_model(model_config, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Tuple[nn.Module, SignalSpec]:
    """Instantiate a model from the config bag on ``device``, in eval mode.

    Returns ``(module, spec)``. Only the constructor fields the class
    declares are read from the config. ``device`` defaults to ``cuda`` and
    raises when no card is present (pass ``device="cpu"`` for the CPU).
    Weights are drawn on the CPU from ``generator`` (default: seed 0), so
    the same seed gives the same weights on every device.
    """
    dev = resolve_device(device)
    cls = get_model_class(str(model_config.name))
    fields = set(inspect.signature(cls).parameters) - {"generator"}
    cfg = model_config.to_dict() if hasattr(model_config, "to_dict") else dict(model_config)
    kwargs = {k: v for k, v in cfg.items() if k in fields}
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module = cls(**kwargs, generator=generator)
    return module.to(dev).eval(), cls.SPEC
