"""The train step (counterpart of speech_enhancement_tpu/train/solver.py:
``get_optimizer``, ``Solver._decode_wire`` and the step function of
``Solver._build_train_step``).

One step: decode the batch (f32, or the int16 wire ``{"q", "scale"}`` of
``data/loader.py:encode_wire_int16``) on the device, run the model in
``train()`` mode (which also updates the complex-BN running statistics),
take the loss and its gradients, then the global norm of the gradients
before clipping, optax's global-norm clip and the optimizer's update. The
JAX package's ``steps_per_call`` scan and data parallelism are not ported.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from speech_enhancement_torch.device import DeviceLike, module_device, resolve_device
from speech_enhancement_torch.models.types import SignalSpec
from speech_enhancement_torch.ops.stft import stft_custom
from speech_enhancement_torch.train import losses as losses_lib

Batch = Union[np.ndarray, torch.Tensor, Mapping[str, Union[np.ndarray, torch.Tensor]]]


class ClippedOptimizer:
    """A torch optimizer behind optax's ``clip_by_global_norm``.

    :meth:`step` computes the global norm ``sqrt(sum |g|^2)`` of the
    parameters' gradients (a missing gradient counts as zeros, as optax sees
    every leaf), replaces each g by ``(g / norm) * clip`` when norm >= clip
    (``clip`` 0: no clipping), steps the optimizer and returns the norm
    before clipping. Unlike ``torch.nn.utils.clip_grad_norm_`` it adds no
    ``1e-6`` to the norm.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, clip: float):
        self.optimizer = optimizer
        self.clip = clip
        self.params = [p for group in optimizer.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        if self.clip > 0:
            for g in grads:  # optax: select(norm < clip, g, (g / norm) * clip)
                g.copy_(torch.where(norm < self.clip, g, g / norm * self.clip))
        self.optimizer.step()
        return norm


def get_optimizer(optim_config, params: Iterable[nn.Parameter]) -> ClippedOptimizer:
    """Optimizer from the config's ``optim`` section, as optax builds it:

    * ``adam``: eps 1e-8 added outside the square root (optax's eps_root 0);
    * ``adamw``: the same with optax's default weight decay 1e-4 (torch's
      default is 1e-2), applied as ``p -= lr * wd * p``;
    * ``sgd``: optax's momentum trace ``t = g + momentum * t`` (default 0.9),
      no dampening, no Nesterov;
    * ``clip_grad`` > 0: the global-norm clip of :class:`ClippedOptimizer`.
    """
    params = list(params)
    name = str(optim_config.optim)
    lr = float(optim_config.lr)
    if name in ("adam", "adamw"):
        betas = (float(optim_config.beta1), float(optim_config.beta2))
        if name == "adam":
            opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
        else:
            opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=1e-4)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(optim_config.get("momentum", 0.9)))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return ClippedOptimizer(opt, float(optim_config.get("clip_grad", 0) or 0))


def decode_wire(batch: Batch, device: torch.device) -> torch.Tensor:
    """f32 batch, or the int16 wire ``{"q": int16, "scale": f32 [..., 1]}``,
    -> f32 on ``device``; the wire is decoded there (one multiply)."""
    if isinstance(batch, Mapping):
        q = torch.as_tensor(batch["q"]).to(device)
        return q.float() * torch.as_tensor(batch["scale"]).to(device)
    return torch.as_tensor(batch).to(device=device, dtype=torch.float32)


def compute_loss(loss_name: str, output: torch.Tensor, target: torch.Tensor,
                 mixture: torch.Tensor, use_pit: bool = False) -> torch.Tensor:
    """The JAX Solver's ``_compute_loss``: PIT over the speaker axis when
    ``use_pit`` and the target has two or more speakers; psa losses also
    take the mixture."""
    loss_fn = losses_lib.get_loss_function(loss_name)
    if loss_name.startswith("psa"):
        def pair(e, t):
            return loss_fn(e, t, mixture)
    else:
        pair = loss_fn
    if use_pit and target.dim() >= 2 and target.shape[1] >= 2:
        return losses_lib.pit_loss(output, target, pair)[0]
    return pair(output, target)


def train_step(model: nn.Module, spec: SignalSpec, optimizer: ClippedOptimizer,
               mixture: Batch, sources: Batch, loss_name: str = "mse", *,
               use_pit: bool = False, device: DeviceLike = None, model_config=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on the batch ``mixture`` [B, C, L] and ``sources``
    [B, S, C, L] (f32 or int16 wire). Returns ``(loss, grad_norm)`` as
    0-dim tensors on the device, not synchronised; grad_norm is the global
    norm before clipping.

    The JAX Solver's ``_adapt``: a monaural model's target is the first
    speaker; an stft-domain model (``spec.domain == "stft"``) takes
    ``stft_custom`` of the mixture and the target, with the transform's
    fields from ``model_config`` (the config's ``model`` section), and the
    loss is taken on the spectrograms.

    ``device`` defaults to ``cuda`` and raises when no card is present; it
    must be the model's. The model is left in ``train()`` mode.
    """
    dev = resolve_device(device)
    model_dev = module_device(model)
    if model_dev is not None:
        if model_dev.type != dev.type:
            raise ValueError(f"model is on {model_dev} but the step runs on {dev}")
        dev = model_dev
    if spec.domain == "stft" and model_config is None:
        raise ValueError("an stft-domain model's train step needs model_config (n_fft, "
                         "hop_length, win_length) for stft_custom")
    mixture = decode_wire(mixture, dev)
    sources = decode_wire(sources, dev)
    target = sources[:, 0] if spec.monarch else sources
    if spec.domain == "stft":
        mixture = stft_custom(mixture, model_config)
        target = stft_custom(target, model_config)
    model.train()
    optimizer.zero_grad()
    output = model(mixture)
    loss = compute_loss(loss_name, output, target, mixture, use_pit=use_pit)
    loss.backward()
    grad_norm = optimizer.step()
    return loss.detach(), grad_norm
