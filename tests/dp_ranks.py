"""The ranks of tests/test_torch_parallel.py: each runs in a process of its
own (``parallel/mesh.py:spawn``), joins a gloo group through a ``file://``
store under the test's temporary directory and saves what it found to
``rank<r>.pt`` there. This module imports neither JAX nor the JAX package,
so that a rank starts quickly."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.data.loader import get_train_wav_dataset, shard_for_process
from speech_enhancement_torch.main import main
from speech_enhancement_torch.parallel import mesh as mesh_lib

# tests/test_parallel.py's small dnn, whose mse decomposes over equal shards
DNN = {
    "name": "dnn", "audio_channels": 1, "num_spk": 1, "segment": 1, "sample_rate": 16000,
    "n_fft": 256, "hop_length": 128, "win_length": 256, "n_layers": 2, "hidden_layer": 32,
    "drop_out": 0.0, "dnn_method": "mask", "dnn_ema": False,
}


def dnn_config(vbd_root: str, run_root: str, data_parallel: int, **solver) -> dict:
    """tests/test_parallel.py's config as a plain dict (both packages' Config
    take it)."""
    section = {
        "root": run_root, "epochs": 1, "batch_size": 8, "all_steps": False, "total_steps": 2,
        "save_checkpoint_interval": 1,
        "validation": {"total_steps": 1, "interval": 1, "metric": "loss"},
        "test": {"total_steps": 1, "interval": 1, "num_show": 0, "metric": "sisdr"},
    }
    section.update(solver)
    return {
        "seed": 3,
        "optim": {"optim": "adam", "lr": 1e-3, "loss": "mse", "clip_grad": 5},
        "model": dict(DNN),
        "dset": {"name": "VoiceBankDEMAND", "wav": vbd_root, "split": [0.6, 0.2, 0.2],
                 "segment": 1, "audio_channels": 1, "sample_rate": 16000, "norm": "z-score"},
        "solver": section,
        "parallel": {"data": data_parallel, "model": 1},
    }


def tcn_config(vbd_root: str, run_root: str, data_parallel: int) -> dict:
    """The dnn's run with a small f32 tcn, whose GroupNorm normalises each
    example alone: its data-parallel step equals the one-process step."""
    cfg = dnn_config(vbd_root, run_root, data_parallel)
    cfg["model"] = {"name": "tcn", "dtype": "float32", "audio_channels": 1, "num_spk": 1,
                    "segment": 1, "sample_rate": 16000, "tcn_channels": 8, "tcn_hidden": 16,
                    "tcn_kernel": 3, "tcn_blocks": 2, "tcn_repeats": 1}
    return cfg


def dccrn_config(vbd_root: str, run_root: str, data_parallel: int, small: dict) -> dict:
    """A small f32 DCCRN (``small``: the constructor's fields) on 0.1 s
    segments, batch 4, mse."""
    cfg = dnn_config(vbd_root, run_root, data_parallel, batch_size=4)
    cfg["optim"] = {"optim": "adam", "lr": 3e-4, "loss": "mse", "clip_grad": 5}
    cfg["model"] = dict(small, name="dccrn", segment=0.1)
    cfg["dset"]["segment"] = 0.1
    return cfg


def _main(cfg: dict, mode="train", run_dir=None):
    return main(with_defaults(Config(cfg)), mode=mode, return_solver=True, device="cpu",
                run_dir=run_dir)


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _join(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'init')}",
                            world_size=world, rank=rank)


class _Unused(torch.nn.Module):
    """``b`` feeds the output on rank 0 only: on rank 1 it gets no gradient."""

    def __init__(self, use_b: bool):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
        self.b = torch.nn.Parameter(torch.tensor([3.0]))
        self.use_b = use_b

    def forward(self, x):
        out = x * self.a
        return out * self.b if self.use_b else out


def cases(rank: int, world: int, tmp: str, vbd_root: str, init_pth: str, dccrn: dict) -> None:
    """Every data-parallel case of the test file on this rank, in one order
    on every rank (each collective is matched):

    * the mesh of the group, and ``make_mesh``'s refusals;
    * the train split on one host (no ``LOCAL_WORLD_SIZE``), then with each
      rank a host of its own;
    * the dnn through ``main()`` on a data=2 mesh from the weights in
      ``init_pth``: f32, the int16 wire, ``steps_per_call`` 2; its test pass;
      then both ranks resume the rank-0 run;
    * the small tcn through ``main()``;
    * ``dccrn``: the Solver's epoch over one given batch from given
      weights (``dccrn["config"]``, ``dccrn["state"]``, ``dccrn["batch"]``);
    * a parameter that feeds the output on rank 0 only, over two steps.
    """
    _join(rank, world, tmp)
    out = {}
    try:
        mesh = mesh_lib.make_mesh(data=2, device="cpu")
        out["mesh"] = {"shape": dict(mesh.shape), "rank": mesh.rank,
                       "world_size": mesh.world_size, "data_index": mesh.data_index,
                       "model2": dict(mesh_lib.make_mesh(data=1, model=2, device="cpu").shape)}
        for data, model in ((4, 1), (1, 1), (2, 2)):
            try:
                mesh_lib.make_mesh(data=data, model=model, device="cpu")
                out["mesh"][f"{data}x{model}"] = None
            except ValueError as err:
                out["mesh"][f"{data}x{model}"] = str(err)

        cfg = with_defaults(Config(dnn_config(vbd_root, tmp, 2)))
        files = get_train_wav_dataset(cfg.dset, cfg.model, seed=3)[0].mixture_files
        os.environ["LOCAL_WORLD_SIZE"] = "1"
        try:
            two_hosts = get_train_wav_dataset(cfg.dset, cfg.model, seed=3)[0].mixture_files
            out["host_index_count"] = mesh_lib.host_index_count()
            out["shard_of_10"] = shard_for_process(list(range(10)))
        finally:
            del os.environ["LOCAL_WORLD_SIZE"]
        out["train_files"] = {"one_host": list(files), "two_hosts": list(two_hosts)}

        f32 = _main(dnn_config(vbd_root, tmp, 2, preloaded_model=init_pth),
                    run_dir=os.path.join(tmp, f"f32_rank{rank}"))
        out["f32"] = {"train_loss": f32.scores["train_loss"], "val_loss": f32.scores["val_loss"],
                      "is_primary": f32.is_primary, "writer": f32.writer is not None,
                      "step": f32._global_step, "state": _state(f32.model),
                      "wrapper": type(f32._train_model).__name__}
        wire = dnn_config(vbd_root, tmp, 2, preloaded_model=init_pth)
        wire["dset"]["wire"] = "int16"
        out["int16"] = _main(wire, run_dir=os.path.join(tmp, f"int16_rank{rank}")
                             ).scores["train_loss"]
        multi = _main(dnn_config(vbd_root, tmp, 2, preloaded_model=init_pth, steps_per_call=2,
                                 total_steps=3), run_dir=os.path.join(tmp, f"multi_rank{rank}"))
        out["multi"] = {"train_loss": multi.scores["train_loss"], "step": multi._global_step}
        out["summary"] = f32.inference()  # every rank scores; rank 0 writes
        resumed = _main(dnn_config(vbd_root, tmp, 2, resume=os.path.join(tmp, "f32_rank0"),
                                   epochs=0), run_dir=os.path.join(tmp, f"resume_rank{rank}"))
        out["resume"] = {"state": _state(resumed.model), "step": resumed._global_step,
                         "best_score": resumed.scores["best_score"]}

        out["tcn"] = _main(tcn_config(vbd_root, tmp, 2),
                           run_dir=os.path.join(tmp, f"tcn_rank{rank}")).scores["train_loss"]

        solver = _main(dccrn["config"], mode=None, run_dir=os.path.join(tmp, f"dccrn_rank{rank}"))
        solver.model.load_state_dict(torch.load(dccrn["state"]))
        solver.train_loader = [dict(np.load(dccrn["batch"]))]
        out["dccrn"] = {"loss": solver._run_one_epoch(0), "state": _state(solver.model)}

        model = _Unused(use_b=rank == 0)
        ddp = mesh_lib.shard_train_step(model, mesh)
        grads = []
        for _ in range(2):  # DDP refuses a second step after a skipped reduction
            model.zero_grad()
            ddp(torch.tensor([1.0, 1.0])).sum().backward()
            grads.append({n: None if p.grad is None else p.grad.clone()
                          for n, p in model.named_parameters()})
        out["unused"] = grads
    finally:
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.destroy_process_group()
