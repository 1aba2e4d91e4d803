"""Entry points of a compile check and a multi-device dry run (counterpart
of the repository's ``__graft_entry__.py``).

``entry`` gives the default DCCRN's forward and an example input.
``dryrun_multichip(n)`` starts ``n`` ranks (one a card over NCCL, or CPU
processes over gloo with ``device="cpu"``), and each takes one
data-parallel train step of three families at ``__graft_entry__.py``'s
small sizes: DCCRN, Demucs with ``remat`` (checkpointed layers under the
reducer's hooks) and Sepformer with the fused attention (on the card, the
attention kernels under DDP). The step is si-sdr, Adam 3e-4, clip 5, on a
host batch of two rows a rank; the checks are a finite loss and gradient
norm and an optimizer step count of 1, as the JAX dry run checks.

    python -m speech_enhancement_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from speech_enhancement_torch.config import Config
from speech_enhancement_torch.device import DeviceLike, resolve_device
from speech_enhancement_torch.parallel import mesh as mesh_lib

FAMILIES = ("dccrn", "demucs", "sepformer")
SAMPLES = 1600
OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}


def entry(device: DeviceLike = None) -> Tuple[Callable, tuple]:
    """(forward, example args) of the default DCCRN (the reference's
    configuration) on ``device``: ``forward(*args)`` serves a [4, 1, 16000]
    batch of zeros."""
    from speech_enhancement_torch.models.dccrn import DCCRN

    dev = resolve_device(device)
    model = DCCRN(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    wav = torch.zeros(4, 1, 16000, device=dev)

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return forward, (wav,)


def _model(family: str, device: torch.device):
    generator = torch.Generator().manual_seed(0)
    if family == "demucs":
        from speech_enhancement_torch.models.demucs import Demucs

        model = Demucs(audio_channels=1, channels=4, depth=3, remat=True, generator=generator)
    elif family == "sepformer":
        from speech_enhancement_torch.models.sepformer import Sepformer

        model = Sepformer(encoder_out_nchannels=32, masknet_chunksize=16, masknet_numlayers=1,
                          intra_numlayers=1, inter_numlayers=1, intra_nhead=4, inter_nhead=4,
                          intra_dffn=64, inter_dffn=64, remat=True, fused_attention="force",
                          generator=generator)
    else:
        from speech_enhancement_torch.models.dccrn import DCCRN

        model = DCCRN(kernel_num=(4, 8, 8, 16, 16, 32), rnn_units=16, generator=generator)
    return model.to(device), model.SPEC


def family_step(family: str, mesh: mesh_lib.Mesh) -> dict:
    """One data-parallel train step of ``family`` on this rank's shard of a
    host batch of two rows a data rank (numpy, seed 2; the sources are the
    mixture scaled, one a speaker)."""
    from speech_enhancement_torch.train.solver import get_optimizer, train_step

    model, spec = _model(family, mesh.device)
    post_init = getattr(model, "post_init_params", None)
    if post_init is not None:
        post_init()
    optimizer = get_optimizer(Config(OPTIM), model.parameters())
    n_src = 1 if spec.monarch else 2
    rows = 2 * (mesh.host_ranks // mesh.shape["model"])
    mixture = 0.1 * np.random.default_rng(2).standard_normal((rows, 1, SAMPLES))
    mixture = mixture.astype(np.float32)
    sources = np.stack([mixture * (0.9 - 0.2 * s) for s in range(n_src)], axis=1)
    ddp = mesh_lib.shard_train_step(model, mesh)
    loss, grad_norm = train_step(ddp, spec, optimizer, mesh_lib.shard_batch(mesh, mixture),
                                 mesh_lib.shard_batch(mesh, sources), "si-sdr",
                                 device=mesh.device)
    mesh_lib.pmean_(mesh_lib.batch_stats(model))
    loss = loss.float().reshape(1)
    mesh_lib.pmean_([loss])
    steps = {int(state["step"]) for state in optimizer.optimizer.state.values()}
    result = {"loss": float(loss), "grad_norm": float(grad_norm), "step": max(steps)}
    if not (np.isfinite(result["loss"]) and np.isfinite(result["grad_norm"])
            and steps == {1}):
        raise RuntimeError(f"dryrun {family} on rank {mesh.rank}: {result}, steps {steps}")
    return result


def _rank(rank: int, world: int, init_file: str, device_type: str, out_dir: str) -> None:
    from speech_enhancement_torch.kernels import counted

    if device_type == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{init_file}", world_size=world, rank=rank)
    try:
        device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        mesh = mesh_lib.make_mesh(data=world, device=device)
        for wrapper in counted().values():
            wrapper.launches = 0
        results = {family: family_step(family, mesh) for family in FAMILIES}
        results["launches"] = {name: w.launches for name, w in counted().items()}
        if rank == 0:
            for family in FAMILIES:
                r = results[family]
                print(f"dryrun_multichip({world}) {family}: loss={r['loss']:.4f} "
                      f"grad_norm={r['grad_norm']:.4f} OK", flush=True)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     timeout: float = 600.0) -> List[dict]:
    """One data-parallel train step of each of ``FAMILIES`` on ``n_devices``
    ranks: NCCL on ``n_devices`` cards, or gloo CPU processes with
    ``device="cpu"``. Returns each rank's ``{family: {"loss", "grad_norm",
    "step"}, "launches": {kernel: count}}``; raises if a rank fails or the
    ranks do not finish within ``timeout`` seconds."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, found {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="se_torch_dryrun_")
    try:
        mesh_lib.spawn(_rank, n_devices, (os.path.join(tmp, "init"), dev.type, tmp),
                       timeout=timeout)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n_devices)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m speech_enhancement_torch.parallel.dryrun")
    parser.add_argument("n", type=int, nargs="?", default=None,
                        help="ranks (default: every CUDA device; 2 on the CPU)")
    parser.add_argument("--device", default=None, help="cpu: gloo CPU ranks; default cuda")
    args = parser.parse_args()
    n = args.n if args.n is not None else (2 if args.device == "cpu" else torch.cuda.device_count())
    forward, example = entry(args.device)
    print("entry OK:", tuple(forward(*example).shape))
    dryrun_multichip(n, args.device)
