"""Checkpoint artifacts of a run dir (counterpart of
speech_enhancement_tpu/train/checkpoints.py; reference src/solver.py:295-341).

Per run dir ``result/{model}/{stamp}/checkpoints/``:

* ``latest_model.ckpt``: ``{"model": state_dict, "optimizer":
  optimizer state_dict, "step": int}``, written with ``torch.save``;
* ``model_{epoch:04d}_{metric}_{score:.4f}.ckpt``: the model's bare
  ``state_dict``. Its keys are the reference's, so the file is a reference
  ``.pth`` in all but its suffix;
* ``best_model.ckpt``: as ``latest_model.ckpt``, when the epoch is the best;
* ``state.json``: the score history.

Resume restores weights, running statistics and the step, and the
optimizer only when asked (reference solver.py:233-260); preload loads
bare weights (solver.py:262-279).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from speech_enhancement_torch.config import load_json, save_json


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    checkpoint_dir: str,
    state: Dict[str, Any],
    epoch: int,
    metric: str,
    score: float,
    scores: Dict,
    is_best: bool,
) -> None:
    """``state`` is ``{"model": state_dict, "optimizer": state_dict, "step": int}``."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    state = _to_cpu(state)  # files that load on a host without the card
    torch.save(state, os.path.join(checkpoint_dir, "latest_model.ckpt"))
    name = f"model_{epoch:04d}_{metric}_{score:.4f}.ckpt"
    torch.save(state["model"], os.path.join(checkpoint_dir, name))
    if is_best:
        torch.save(state, os.path.join(checkpoint_dir, "best_model.ckpt"))
    save_json(scores, os.path.join(checkpoint_dir, "state.json"))


def load_checkpoint(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Load a checkpoint file over ``template``: a top-level key the file
    lacks (e.g. ``step``) keeps its template value instead of failing the
    restore."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    restored = dict(template)
    restored.update({k: raw[k] for k in template if k in raw})
    return restored


def model_state(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a file: a port checkpoint (``{"model": ...}``,
    as the reference's ``.tar`` files hold them) or a bare ``state_dict``
    (a ``model_*.ckpt``, or a reference ``.pth``/``.pt``)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob.get("model"), Mapping):
        return dict(blob["model"])
    return dict(blob)


def latest_checkpoint(run_dir: str) -> Optional[str]:
    path = os.path.join(run_dir, "checkpoints", "latest_model.ckpt")
    return path if os.path.exists(path) else None


def load_scores(run_dir: str) -> Optional[Dict]:
    path = os.path.join(run_dir, "checkpoints", "state.json")
    return load_json(path) if os.path.exists(path) else None
