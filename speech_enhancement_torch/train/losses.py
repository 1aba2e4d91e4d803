"""Loss functions and permutation-invariant training.

Counterpart of speech_enhancement_tpu/train/losses.py, which reproduces the
reference's loss surface (src/loss.py):

* ``l1`` / ``mse``: plain means;
* ``si_snr`` / ``loss_sisdr``: the reference's SI-SNR *without* removing
  the means (src/loss.py:14-29);
* ``loss_psa``: phase-sensitive approximation with the reference's
  ``tanh(imag / real)`` pseudo-angle; ``loss_psa_fixed`` uses atan2;
* ``pit_loss``: utterance-level PIT over every permutation of the speaker
  axis, the minimum taken over one [S, S] matrix of pairwise losses, so the
  gradient flows through the best assignment only.
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable, Tuple

import torch

EPS = 1e-8


def l1_loss(enhanced: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(enhanced - target))


def mse_loss(enhanced: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((enhanced - target) ** 2)


def si_snr(s1: torch.Tensor, s2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Reference SI-SNR of estimate ``s1`` against target ``s2`` (no mean removal)."""
    s1_s2 = torch.sum(s1 * s2, dim=-1, keepdim=True)
    s2_s2 = torch.sum(s2 * s2, dim=-1, keepdim=True)
    s_target = s1_s2 / (s2_s2 + eps) * s2
    e_noise = s1 - s_target
    target_norm = torch.sum(s_target * s_target, dim=-1, keepdim=True)
    noise_norm = torch.sum(e_noise * e_noise, dim=-1, keepdim=True)
    snr = 10.0 * torch.log10(target_norm / (noise_norm + eps) + eps)
    return torch.mean(snr)


def loss_sisdr(enhanced: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -si_snr(enhanced, target)


def _psa(enhanced, target, mixture, angle_fn) -> torch.Tensor:
    amp_enhanced = torch.sqrt(enhanced[..., 1] ** 2 + enhanced[..., 0] ** 2)
    amp_target = torch.sqrt(target[..., 1] ** 2 + target[..., 0] ** 2)
    err = amp_enhanced - amp_target * torch.cos(angle_fn(target) - angle_fn(mixture))
    return torch.mean(err**2)


def loss_psa(enhanced: torch.Tensor, target: torch.Tensor,
             mixture: torch.Tensor) -> torch.Tensor:
    """PSA with the reference's tanh(imag / real) pseudo-angle (src/loss.py:48-49)."""
    return _psa(enhanced, target, mixture,
                lambda x: torch.tanh(x[..., 1] / (x[..., 0] + 1e-9)))


def loss_psa_fixed(enhanced: torch.Tensor, target: torch.Tensor,
                   mixture: torch.Tensor) -> torch.Tensor:
    """PSA with the true phase (atan2), the paper's formulation."""
    return _psa(enhanced, target, mixture, lambda x: torch.atan2(x[..., 1], x[..., 0]))


def pit_loss(enhanced: torch.Tensor, target: torch.Tensor,
             loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Utterance-level PIT over speaker axis 1 of [B, S, ...] tensors.

    Returns ``(loss, perm_index)``, ``perm_index`` indexing
    ``itertools.permutations(range(S))``.
    """
    if enhanced.shape != target.shape:
        raise ValueError(f"shapes differ: {tuple(enhanced.shape)} vs {tuple(target.shape)}")
    n_spk = enhanced.shape[1]
    if n_spk > 4:
        raise ValueError(f"PIT with {n_spk} speakers is factorially expensive; cap is 4")
    pairwise = torch.stack([
        torch.stack([loss_fn(enhanced[:, i], target[:, j]) for j in range(n_spk)])
        for i in range(n_spk)])  # [S_enh, S_tgt]
    perm_losses = torch.stack([
        sum(pairwise[perm[j], j] for j in range(n_spk)) / n_spk
        for perm in permutations(range(n_spk))])
    return torch.min(perm_losses), torch.argmin(perm_losses)


def get_loss_function(name: str) -> Callable:
    """Loss by its config name (reference: src/distrib.py:263-275)."""
    table = {
        "l1": l1_loss,
        "mse": mse_loss,
        "si-sdr": loss_sisdr,
        "sisdr": loss_sisdr,
        "psa": loss_psa,
        "psa-fixed": loss_psa_fixed,
    }
    if name not in table:
        raise ValueError(f"unknown loss {name!r}; options: {sorted(table)}")
    return table[name]
