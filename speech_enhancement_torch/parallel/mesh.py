"""Data-parallel training over ``torch.distributed`` (counterpart of
speech_enhancement_tpu/parallel/mesh.py).

The JAX package maps its train step over a ``(data, model)`` device mesh
with ``shard_map``: one replica of the parameters per device, the batch
split along dim 0, and gradients, the reported loss and the BatchNorm
statistics averaged with ``pmean`` over the ``data`` axis after each step.
Here a device is a process holding one card (or one CPU process, for the
tests) in a ``torch.distributed`` group: NCCL on the card, gloo on the CPU.

* :func:`init_distributed` joins the group (``tcp://`` from the config, or
  ``env://`` as ``torchrun`` sets it) before any data or model work.
* :func:`make_mesh` records this process's place: ``shape`` ``{"data": d,
  "model": m}`` with ``d * m`` the world size, its rank, its ``data_index``
  (``rank // m``) and its device. As in JAX, nothing is sharded over
  ``model``: ranks that share a ``data_index`` compute the same shard.
* :func:`shard_batch` cuts this rank's rows out of the host batch.
  ``solver.batch_size`` is the batch of one host (a JAX process), which the
  ranks of that host split; the hosts read disjoint shards of the train
  files (``data/loader.py:shard_for_process``), so the global batch is
  ``batch_size`` times the number of hosts, as in JAX.
* :func:`shard_train_step` wraps the model in ``DistributedDataParallel``,
  whose gradient average is JAX's ``pmean`` of the gradients; the
  optimizer then clips the averaged gradients, as ``optax`` clips after the
  ``pmean``. :func:`pmean_` averages the loss (for reporting) and the
  running statistics (:func:`batch_stats`) after each step.
* :func:`fold_in_data_index` gives each data shard its own dropout masks,
  as JAX folds the axis index into the step's random key.
* :func:`spawn` runs a function on several ranks of this host, each with
  a time limit (the tests, the dry run and the smoke use it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import warnings
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.ops.rnn import RNNStack


def _group_in_use() -> bool:
    return dist.is_available() and dist.is_initialized()


def host_ranks() -> int:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else (no
    launcher told us) the whole group counts as one host."""
    world = dist.get_world_size() if _group_in_use() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def host_index_count() -> tuple:
    """(this host's index, the number of hosts): a JAX process is one host
    driving all of its devices, so file lists are sharded by host, not by
    rank. ``(0, 1)`` without a group."""
    if not _group_in_use():
        return 0, 1
    local = host_ranks()
    return dist.get_rank() // local, max(dist.get_world_size() // local, 1)


def init_distributed(parallel_config, device: DeviceLike = None) -> bool:
    """Join the process group that ``parallel_config`` needs; return
    whether a group is in use.

    A group is needed when ``multihost`` is set or ``data * model > 1``.
    The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU.
    With ``coordinator_address`` the init method is
    ``tcp://<address>``, with ``num_processes`` / ``process_id`` as the
    world size and rank where they are given (a process is one card);
    otherwise ``env://``, as ``torchrun`` sets it. A group that already
    exists is kept. On CUDA the process takes the card ``LOCAL_RANK``.
    """
    dev = resolve_device(device)
    if not _group_in_use():
        data = int(parallel_config.get("data", 1) or 1)
        model = int(parallel_config.get("model", 1) or 1)
        if not parallel_config.get("multihost") and data * model <= 1:
            return False
        kwargs = {"backend": "nccl" if dev.type == "cuda" else "gloo"}
        addr = str(parallel_config.get("coordinator_address", "") or "")
        if addr:
            kwargs["init_method"] = f"tcp://{addr}"
            nproc = int(parallel_config.get("num_processes", 0) or 0)
            if nproc > 0:
                kwargs["world_size"] = nproc
            pid = int(parallel_config.get("process_id", -1))
            if pid >= 0:
                kwargs["rank"] = pid
        elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
            kwargs["init_method"] = "env://"
        else:
            raise RuntimeError(
                "parallel.data * parallel.model > 1 or parallel.multihost needs a process "
                "group: launch with torchrun (torchrun --standalone --nproc_per_node N -m "
                "speech_enhancement_torch ...) or set parallel.coordinator_address, "
                "num_processes and process_id")
        dist.init_process_group(**kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ``(data, model)`` mesh."""

    shape: Mapping[str, int]
    rank: int
    world_size: int
    data_index: int
    device: torch.device
    host_ranks: int  # ranks on this host, which split its batch


def make_mesh(data: Optional[int] = None, model: int = 1, device: DeviceLike = None) -> Mesh:
    """The mesh of the current group (``data`` defaults to world size /
    ``model``). Without a group only ``data = model = 1`` is valid.
    ``device`` defaults to the current CUDA device."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if _group_in_use() else (0, 1)
    model = int(model)
    data = world // model if data is None else int(data)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a (data={data}, model={model}) mesh needs {data * model} "
                         f"processes; the group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    local = host_ranks()
    if local % model or world % local:
        raise ValueError(f"{local} ranks a host do not hold whole model groups of {model} "
                         f"in a world of {world}")
    return Mesh(shape={"data": data, "model": model}, rank=rank, world_size=world,
                data_index=rank // model, device=dev, host_ranks=local)


def check_batch_size(mesh: Mesh, batch: int) -> None:
    """The JAX Solver's check: each device must receive an equal shard."""
    n_data = int(mesh.shape.get("data", 1))
    if batch % max(n_data, 1) != 0:
        raise ValueError(
            f"solver.batch_size={batch} is not divisible by the data-parallel mesh axis "
            f"(data={n_data}); each device must receive an equal batch shard. Use a batch "
            f"size that is a multiple of {n_data}.")


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of the host batch: an array or tensor, or a mapping
    of them (the int16 wire's ``q`` and ``scale``), each cut on dim 0.

    The host's ``host_ranks / model`` data ranks split its batch in
    order of their data index."""
    if isinstance(batch, Mapping):
        return {key: shard_batch(mesh, value) for key, value in batch.items()}
    per_host = mesh.host_ranks // mesh.shape["model"]
    rows = batch.shape[0]
    if rows % per_host:
        raise ValueError(f"a host batch of {rows} rows does not split over its {per_host} "
                         "data ranks")
    size = rows // per_host
    local = mesh.data_index % per_host
    return batch[local * size:(local + 1) * size]


def shard_train_step(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The module a data-parallel train step runs: ``DistributedDataParallel``
    over ``model`` when a group is in use, ``model`` itself otherwise.

    ``broadcast_buffers=False``: DDP would copy rank 0's buffers into every
    rank each forward, where JAX averages each shard's updated statistics
    (:func:`pmean_` of :func:`batch_stats` after the step).
    ``find_unused_parameters=True``: a parameter that gets no gradient on a
    rank is reduced all the same, as ``pmean`` reduces its zeros.
    """
    if not _group_in_use():
        return model
    from torch.nn.parallel import DistributedDataParallel

    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    with warnings.catch_warnings():
        # newer torch renames the flag (forward_sync_buffers) and warns;
        # False means the same under both names, and older torch has only this one
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*", category=FutureWarning)
        return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False,
                                       find_unused_parameters=True)


def batch_stats(model: nn.Module) -> list:
    """The running statistics: the module's persistent floating buffers
    (JAX's ``batch_stats`` collection; the non-persistent ones are
    constants such as STFT bases)."""
    persistent = set(model.state_dict())
    return [b for name, b in model.named_buffers() if name in persistent and b.is_floating_point()]


def pmean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average each tensor over the group in place (one all-reduce per
    dtype); nothing without a group."""
    if not _group_in_use() or not tensors:
        return
    world = dist.get_world_size()
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _fold(seed: int, index: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def fold_in_data_index(model: nn.Module, seed: int, mesh: Mesh) -> None:
    """Dropout masks of their own for each data shard: torch's global
    generators (model-level dropout) and each stack's ``dropout_seed``
    (``ops/rnn.py:RNNStack``) get the shard's index folded in."""
    torch.manual_seed(_fold(seed, mesh.data_index))
    for module in model.modules():
        if isinstance(module, RNNStack) and module.dropout_seed is not None:
            module.reseed_dropout(_fold(module.dropout_seed, mesh.data_index))


def spawn(fn, world_size: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (``spawn`` start method) and wait at most ``timeout`` seconds for all of
    them; on a failure or at the limit every rank still alive is killed
    and this raises. ``fn`` must be importable by name (a module's
    top-level function)."""
    import torch.multiprocessing as mp

    context = mp.start_processes(fn, args=(world_size,) + tuple(args), nprocs=world_size,
                                 join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} did not finish in "
                                   f"{timeout} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
            process.join(5)
