"""Orchestration entry point (counterpart of speech_enhancement_tpu/main.py;
reference src/train.py:18-110 ``main``).

Builds datasets -> loaders -> model -> Solver from one YAML config and
dispatches on the mode: train, validation, test, or None (build only).
Returns the Solver when ``return_solver``, so notebooks and tests can drive
it further.

Data-parallel training (``parallel.data`` > 1) runs one process a card:

    torchrun --standalone --nproc_per_node N -m speech_enhancement_torch \
        --config <yaml>      # with parallel.data: N

``main`` joins the process group before any data or model work
(``parallel/mesh.py:init_distributed``) and runs on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import faulthandler
import signal
from typing import Optional, Union

import torch

from speech_enhancement_torch.config import Config, load_config, with_defaults
from speech_enhancement_torch.data.loader import (get_dataloader, get_dev_wav_clarity,
                                                  get_train_wav_dataset)
from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from speech_enhancement_torch.train.solver import Solver
from speech_enhancement_torch.utils import seed_everything


def main(
    config: Union[str, Config],
    mode: Optional[str] = "train",
    return_solver: bool = False,
    save: bool = False,
    dev: bool = False,
    device: DeviceLike = None,
    run_dir: Optional[str] = None,
    mesh: Optional[Mesh] = None,
):
    """Run ``mode`` for ``config`` (a YAML path or a :class:`Config`).

    ``device`` defaults to ``cuda`` (``cuda:LOCAL_RANK`` under a process
    group) and raises when no card is present; ``"cpu"`` runs on the CPU.
    ``save`` writes the enhanced wavs at test; ``dev`` tests on the Clarity
    dev scenes (reference train.py:20,36). ``mesh`` makes training data
    parallel; without one it is built from ``parallel.data`` /
    ``parallel.model`` when ``parallel.data`` > 1.
    """
    # `kill -USR1 <pid>` dumps every thread's stack without stopping the run
    if hasattr(signal, "SIGUSR1"):
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=True)
    if mode not in ("train", "validation", "test", None):
        raise ValueError(f"unknown mode {mode!r}")
    device = resolve_device(mesh.device if device is None and mesh is not None else device)
    config = load_config(config) if isinstance(config, str) else with_defaults(config)
    in_group = init_distributed(config.parallel, device)
    if in_group and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())  # cuda:LOCAL_RANK
    if mesh is None and int(config.parallel.get("data", 1) or 1) > 1:
        mesh = make_mesh(data=int(config.parallel.data),
                         model=int(config.parallel.get("model", 1) or 1), device=device)

    seed = int(config.get("seed", 10))
    seed_everything(seed)
    train_set, val_set, test_set = get_train_wav_dataset(config.dset, config.model, seed=seed)
    if dev:
        test_set = get_dev_wav_clarity(config.dset, seed=seed)
    train_loader = get_dataloader(train_set, config, train=True, seed=seed)
    val_loader = get_dataloader(val_set, config, train=True, seed=seed + 1, validation=True)
    test_loader = get_dataloader(test_set, config, train=False)

    model, spec = build_model(config.model, device,
                              generator=torch.Generator().manual_seed(seed))
    solver = Solver(config, model, spec, train_loader, val_loader, test_loader,
                    run_dir=run_dir, device=device, mesh=mesh)

    if mode == "train":
        solver.train()
    elif mode == "validation":
        print(f"validation loss={solver._run_one_epoch(0, train=False):.5f}")
    elif mode == "test":
        solver.inference(save=save)
    return solver if return_solver else None
