"""The training engine (counterpart of speech_enhancement_tpu/train/solver.py;
reference src/solver.py:109-746).

``train_step``: decode the batch (f32, or the int16 wire ``{"q", "scale"}``
of ``data/loader.py:encode_wire_int16``) on the device, run the model in
``train()`` mode (which also updates the complex-BN running statistics),
take the loss and its gradients, then the global norm of the gradients
before clipping, optax's global-norm clip and the optimizer's update.

``Solver`` drives it: epochs with validation, early stopping with
patience, checkpoints, resume and preload, and the test pass that scores
the enhanced and the mixture signals (SI-SDR, STOI, PESQ) into
``results.csv`` and ``test_summary.json``, with the Clarity hearing-aid
columns (HASPI / HASQI through ``ha/scoring.py``) when ``config.ha`` is
set. The JAX package's ``steps_per_call`` scan runs here as a plain loop
of steps. With a ``mesh`` (``parallel/mesh.py``) the steps are data
parallel: each rank takes its rows of the host batch through the model
wrapped in ``DistributedDataParallel`` (the gradients averaged before the
clip), and the running statistics and the reported loss are averaged over
the group after each step, as the JAX step's ``pmean``. Validation and the
test pass run whole on every rank on the bare model, so every rank takes the
same early-stopping decision; rank 0 writes every artifact.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from speech_enhancement_torch.config import save_json, save_yaml
from speech_enhancement_torch.data.wav_io import write_wav
from speech_enhancement_torch.device import DeviceLike, module_device, resolve_device
from speech_enhancement_torch.models.types import SignalSpec
from speech_enhancement_torch.ops.stft import stft, stft_custom
from speech_enhancement_torch.parallel import mesh as mesh_lib
from speech_enhancement_torch.train import checkpoints as ckpt
from speech_enhancement_torch.train import losses as losses_lib
from speech_enhancement_torch.train import metrics as metrics_lib
from speech_enhancement_torch.train.evaluate import _BUCKET as _EVAL_BUCKET
from speech_enhancement_torch.train.evaluate import _num_windows, evaluate_utterance

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


def adapt(spec: SignalSpec, mixture: torch.Tensor, sources: torch.Tensor, model_config
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX Solver's ``_adapt``: a monaural model's target is the first
    speaker; an stft-domain model takes ``stft_custom`` of the mixture and
    the target."""
    target = sources[:, 0] if spec.monarch else sources
    if spec.domain == "stft":
        mixture = stft_custom(mixture, model_config)
        target = stft_custom(target, model_config)
    return mixture, target


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
    mixture, target = adapt(spec, decode_wire(mixture, dev), decode_wire(sources, dev),
                            model_config)
    model.train()
    optimizer.zero_grad()
    output = model(mixture)
    loss = compute_loss(loss_name, output, target, mixture, use_pit=use_pit)
    loss.backward()
    grad_norm = optimizer.step()
    return loss.detach(), grad_norm


METRIC_HIGHER_BETTER = {"loss": False, "sisdr": True, "stoi": True, "pesq": True}

# Fetch the staged losses and gradient norms every DRAIN_EVERY steps (and at
# the epoch's end) in one device-to-host copy, instead of a sync per step:
# the DCCRN step is host-bound, and a sync a step would stall the launches
# of the next one. It also bounds how long a non-finite loss trains on.
DRAIN_EVERY = 64


def _is_primary() -> bool:
    """Process 0 writes every artifact when several processes share a run."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class Solver:
    """Train / validate / test engine for one model and dataset configuration.

    ``model`` is the module ``build_model`` returns, on ``device`` (default
    ``cuda``, which raises without a card); ``spec`` its ``SignalSpec``. The
    loaders are ``data/loader.py``'s. ``mesh`` (``parallel/mesh.py:
    make_mesh``) makes the train steps data parallel.
    """

    def __init__(self, config, model: nn.Module, spec: SignalSpec, train_loader,
                 val_loader, test_loader=None, run_dir: Optional[str] = None,
                 device: DeviceLike = None, mesh: Optional[mesh_lib.Mesh] = None):
        self.mesh = mesh
        if mesh is not None:
            mesh_lib.check_batch_size(mesh, int(config.solver.batch_size))
        self.device = resolve_device(device)
        model_dev = module_device(model)
        if model_dev is not None and model_dev.type != self.device.type:
            raise ValueError(f"model is on {model_dev} but the Solver runs on {self.device}")
        self.config = config
        self.model = model
        self.spec = spec
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader

        self.loss_name = str(config.optim.loss)
        self.use_pit = bool(config.optim.get("pit", False)) and spec.multi_speaker
        # the reference computes utterance-PIT and then discards it
        # (src/solver.py:469-480): with the flag the plain loss is taken
        self.pit_discard_compat = bool(config.optim.get("pit_discard_compat", False))
        self.optimizer = get_optimizer(config.optim, model.parameters())
        self.model_config = config.model if spec.domain == "stft" else None
        # Clarity hearing-aid scoring (reference solver.py:124-130): config.ha
        # names the HA YAML whose listeners.json holds the audiograms; built
        # here, on the Solver's device, so that a bad path fails at init
        self.clarity_scorer = None
        ha_path = str(config.get("ha", "") or "")
        if ha_path:
            from speech_enhancement_torch.ha.scoring import ClarityScorer

            self.clarity_scorer = ClarityScorer(ha_path, input_sr=int(config.dset.sample_rate),
                                                device=self.device)

        root = str(config.solver.get("root", "."))
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = run_dir or os.path.join(root, "result", str(config.model.name), stamp)
        self.checkpoint_dir = os.path.join(self.run_dir, "checkpoints")
        self.log_dir = os.path.join(self.run_dir, "logs")
        self.is_primary = _is_primary()
        if self.is_primary:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            os.makedirs(self.log_dir, exist_ok=True)
            save_yaml(config, os.path.join(self.run_dir, "config.yaml"))
        self.writer = self._make_writer() if self.is_primary else None
        self.scores: Dict[str, Any] = {"train_loss": [], "val_loss": [],
                                       "best_score": None, "epoch_wall_s": []}
        self.start_epoch = 0
        self.early_stop_count = 0
        self._global_step = 0  # optimizer steps taken, carried across resume
        self.steps_per_call = max(1, int(config.solver.get("steps_per_call", 1)))
        # per epoch: train steps, train and validation seconds (host clock,
        # each ending in a fetch from the device)
        self.epoch_stats: list = []
        self._epoch_steps = 0
        self.test_timing: Dict[str, float] = {}
        self._profiler = None

        if hasattr(model, "post_init_params"):
            # the model's own fresh-start transform (Demucs's weight
            # rescale), as the JAX Solver applies it to its initial params;
            # a resume or a preload then overwrites what it loads
            model.post_init_params()
        resume = str(config.solver.get("resume", "") or "")
        preload = str(config.solver.get("preloaded_model", "") or "")
        if resume:
            self._resume_checkpoint(resume)
        elif preload:
            self._preload_model(preload)
        # the module the train steps run (DDP under a group) and the running
        # statistics averaged after each; built after the weights are final
        self._train_model, self._stats = model, []
        if mesh is not None:
            mesh_lib.fold_in_data_index(model, int(config.get("seed", 10)), mesh)
            self._train_model = mesh_lib.shard_train_step(model, mesh)
            self._stats = mesh_lib.batch_stats(model)

    # ------------------------------------------------------------------ setup
    def _make_writer(self):
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(self.log_dir, max_queue=5, flush_secs=30)
        except ImportError:  # tensorboard is optional
            return None

    def _loss(self, output, target, inputs) -> torch.Tensor:
        return compute_loss(self.loss_name, output, target, inputs,
                            use_pit=self.use_pit and not self.pit_discard_compat)

    def _val_step(self, mixture, sources, mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """Masked sum of per-example losses, and the mask's sum.

        Each example's loss (PIT and psa included) is taken alone, and the
        zero-padded rows of a validation epoch's last batch are masked out,
        so every segment counts once whatever the batch size (the
        reference's variable-size batches, src/distrib.py:38-98)."""
        inputs, target = adapt(self.spec, decode_wire(mixture, self.device),
                               decode_wire(sources, self.device), self.model_config)
        output = self.model(inputs)
        per_example = torch.stack([
            self._loss(output[b:b + 1], target[b:b + 1], inputs[b:b + 1]).float()
            for b in range(output.shape[0])])
        mask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
        return torch.sum(per_example * mask), torch.sum(mask)

    # ----------------------------------------------------------------- epochs
    def _run_one_epoch(self, epoch: int, train: bool = True) -> float:
        """Mean loss of one training (or validation) epoch.

        Step caps apply only when ``solver.all_steps`` is false, to training
        and validation alike (reference src/solver.py:409-417)."""
        loader = self.train_loader if train else self.val_loader
        cfg = self.config.solver
        limit = None
        if not bool(cfg.get("all_steps", True)):
            section = cfg if train else cfg.validation
            limit = int(section.get("total_steps", 0)) or None
        if not train:
            return self._validate(loader, limit)

        total, count, steps = 0.0, 0, 0
        pending: list = []  # (loss, grad_norm) 0-dim device tensors, not fetched
        chunk: list = []

        def drain() -> None:
            nonlocal total, count
            if not pending:
                return
            stacked = torch.stack([torch.stack(p) for p in pending]).float()
            if self.mesh is not None:
                mesh_lib.pmean_([stacked[:, 0]])  # the loss over the data shards
            fetched = stacked.cpu().numpy()
            first = self._global_step - len(pending) + 1
            for offset, (loss_value, grad_norm) in enumerate(fetched):
                loss_value = float(loss_value)
                if not np.isfinite(loss_value):
                    raise FloatingPointError(
                        f"non-finite loss {loss_value} at epoch {epoch} global step "
                        f"{first + offset}")
                if self.writer:
                    self.writer.add_scalar("train/step_loss", loss_value, first + offset)
                    self.writer.add_scalar("train/grad_norm", float(grad_norm), first + offset)
                total += loss_value
                count += 1
            pending.clear()

        def run_chunk() -> None:
            # steps_per_call: the JAX package's scan of N steps, a plain loop here
            for mixture, sources in chunk:
                loss, grad_norm = train_step(
                    self._train_model, self.spec, self.optimizer, mixture, sources,
                    self.loss_name, use_pit=self.use_pit and not self.pit_discard_compat,
                    device=self.device, model_config=self.model_config)
                mesh_lib.pmean_(self._stats)
                self._global_step += 1
                pending.append((loss, grad_norm))
            chunk.clear()

        for step, batch in enumerate(loader):
            if limit is not None and step >= limit:
                break
            mixture, sources = batch["mixture"], batch["sources"]
            if self.mesh is not None:
                mixture = mesh_lib.shard_batch(self.mesh, mixture)
                sources = mesh_lib.shard_batch(self.mesh, sources)
            chunk.append((mixture, sources))
            steps += 1
            if len(chunk) == self.steps_per_call:
                run_chunk()
            if len(pending) >= DRAIN_EVERY:
                drain()
        run_chunk()
        drain()
        self._epoch_steps = steps
        return total / max(count, 1)

    def _validate(self, loader, limit: Optional[int]) -> float:
        self.model.eval()
        sums = []
        with torch.inference_mode():
            for step, batch in enumerate(loader):
                if limit is not None and step >= limit:
                    break
                mixture = batch["mixture"]
                n_items = (mixture["q"] if isinstance(mixture, Mapping) else mixture).shape[0]
                mask = batch.get("mask", np.ones(n_items, np.float32))
                sums.append(torch.stack(self._val_step(mixture, batch["sources"], mask)))
        if not sums:
            return 0.0
        loss_sum, n_valid = torch.stack(sums).double().sum(0).cpu().tolist()
        return loss_sum / max(n_valid, 1.0)

    def train(self) -> Dict[str, Any]:
        cfg = self.config.solver
        epochs = int(cfg.epochs)
        patience = int(cfg.get("patience", 40))
        val_interval = int(cfg.validation.get("interval", 1))
        save_interval = int(cfg.get("save_checkpoint_interval", 1))
        metric_name = str(cfg.validation.get("metric", "loss"))
        profile = bool(cfg.get("profile", False))

        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            if profile and epoch == self.start_epoch:
                self.start_profiler()
            train_loss = self._run_one_epoch(epoch, train=True)
            if profile and epoch == self.start_epoch:
                self.stop_profiler()
            train_s = time.time() - t0
            self.scores["train_loss"].append(train_loss)
            if self.writer:
                self.writer.add_scalar("train/epoch_loss", train_loss, epoch)

            val_loss = None
            if (epoch + 1) % val_interval == 0:
                val_loss = self._run_one_epoch(epoch, train=False)
                self.scores["val_loss"].append(val_loss)
                if self.writer:
                    self.writer.add_scalar("val/epoch_loss", val_loss, epoch)
            val_s = time.time() - t0 - train_s

            # best checkpoint and patience move only on epochs with a
            # validation pass (reference src/solver.py:370-377)
            score = val_loss if val_loss is not None else train_loss
            is_best = False
            if val_loss is not None:
                is_best = self._is_best(metric_name, val_loss)
                self.early_stop_count = 0 if is_best else self.early_stop_count + 1
            if self.is_primary and ((epoch + 1) % save_interval == 0 or is_best):
                ckpt.save_checkpoint(self.checkpoint_dir, self.checkpoint_state(), epoch,
                                     metric_name, float(score), self.scores, is_best)
            best = self.scores.get("best_score")
            self.scores["epoch_wall_s"].append(round(time.time() - t0, 2))
            self.epoch_stats.append({"epoch": epoch, "train_steps": self._epoch_steps,
                                     "train_s": train_s, "val_s": val_s})
            print(
                f"epoch {epoch}: train_loss={train_loss:.5f}"
                + (f" val_loss={val_loss:.5f}" if val_loss is not None else "")
                + (f" best={best:.5f}" if best is not None else "")
                + f" ({time.time() - t0:.1f}s)"
            )
            if self.early_stop_count > patience:
                print(f"early stopping at epoch {epoch} (patience {patience})")
                break
        if self.is_primary:
            save_json(self.scores, os.path.join(self.checkpoint_dir, "state.json"))
        return self.scores

    def _is_best(self, metric_name: str, score: float) -> bool:
        higher_better = METRIC_HIGHER_BETTER.get(metric_name, False)
        best = self.scores.get("best_score")
        if best is None or (score > best if higher_better else score < best):
            self.scores["best_score"] = float(score)
            return True
        return False

    # -------------------------------------------------------------- inference
    def inference(self, save: bool = False, results_csv: Optional[str] = None
                  ) -> Dict[str, Any]:
        """Full-utterance test pass with enhanced-vs-mixture scoring
        (reference src/solver.py:534-641).

        Utterances whose window counts fall in one bucket are packed, up to
        ``solver.test.batch_size`` rows and ``max_windows`` windows, into one
        ``evaluate_utterance`` call; each row is normalised over its own
        samples, so the rows equal the batch-1 pass. Scoring (STOI and PESQ
        on the host) runs on two worker threads while the device enhances
        the next group; rows are written in loader order.
        """
        if self.test_loader is None:
            raise ValueError("no test loader configured")
        cfg = self.config.solver.test
        limit = int(cfg.get("total_steps", 0)) or None
        sr = int(self.config.dset.sample_rate)
        metrics = cfg.get("metrics", ("sisdr", "stoi", "pesq"))
        include = (metrics,) if isinstance(metrics, str) else tuple(metrics)
        self.model.eval()

        results = metrics_lib.SpeechMetricResultsFile(
            results_csv or os.path.join(self.run_dir, "results.csv")
        ) if self.is_primary else None
        if results is not None:
            results.clear()
        agg = {"enhanced": {"sisdr": [], "stoi": [], "pesq": []},
               "mixture": {"sisdr": [], "stoi": [], "pesq": []}}
        timing = {"utterances": 0, "device_s": 0.0, "scoring_s": 0.0}
        score_ha = (self.clarity_scorer is not None
                    and str(self.config.dset.name).lower() == "clarity")
        if score_ha:
            timing.update(ha_amplify_s=0.0, ha_ear_model_s=0.0)

        def score(clean, enhanced_np, mixture_np, name):
            t0 = time.perf_counter()
            m_enh = metrics_lib.compute_metrics(clean, enhanced_np, sr, include)
            m_mix = metrics_lib.compute_metrics(clean, mixture_np, sr, include)
            # Clarity HA scoring (reference solver.py:610-616): resample to
            # the HA rate, amplify for each scene listener, HASPI / HASQI
            ha_scores = (self.compute_metric_clarity(mixture_np[0], enhanced_np[0], clean[0],
                                                     name) if score_ha else {})
            if save and self.is_primary:
                write_wav(os.path.join(self.run_dir, "enhanced", f"{name}.wav"),
                          enhanced_np[0], sr)
            return m_enh, m_mix, ha_scores, time.perf_counter() - t0

        def ha_col(ha_scores, col):
            if self.clarity_scorer is None:
                return None
            value = ha_scores.get(col)
            return "gated" if value is None else value

        def consume(name, future) -> None:
            m_enh, m_mix, ha_scores, seconds = future.result()
            timing["scoring_s"] += seconds
            if score_ha:
                timing["ha_amplify_s"] += ha_scores.get("amplify_s", 0.0)
                timing["ha_ear_model_s"] += ha_scores.get("ear_model_s", 0.0)
            for key in include:
                if m_enh.get(key) is not None:
                    agg["enhanced"].setdefault(key, []).append(m_enh[key])
                if m_mix.get(key) is not None:
                    agg["mixture"].setdefault(key, []).append(m_mix[key])
            for key in ("haspi", "hasqi"):
                for side, agg_side in (("enhance", "enhanced"), ("mixture", "mixture")):
                    value = ha_scores.get(f"{key}_{side}")
                    if value is not None:
                        agg[agg_side].setdefault(key, []).append(value)
            if results is not None:
                results.add_result(
                    name,
                    sisdr_enhance=m_enh.get("sisdr"), sisdr_mixture=m_mix.get("sisdr"),
                    stoi_enhance=m_enh.get("stoi"), stoi_mixture=m_mix.get("stoi"),
                    pesq_enhance=m_enh.get("pesq"), pesq_mixture=m_mix.get("pesq"),
                    **{col: ha_col(ha_scores, col) for col in (
                        "haspi_enhance", "haspi_mixture", "hasqi_enhance", "hasqi_mixture")},
                )

        eval_batch = max(1, int(cfg.get("batch_size", 1)))
        num_sources = int(self.config.model.get("num_spk", 1))
        window = int(self.config.dset.sample_rate * self.config.model.segment)
        stride = int(self.config.model.win_length)
        # cap the windows of one packed call: a long utterance is already a
        # large window batch, and packing multiplies it
        max_windows = max(_EVAL_BUCKET, int(cfg.get("max_windows", 256)))
        pending: dict = {}  # step -> (name, future)
        next_emit = 0

        def pack_rows(bucket: int) -> int:
            return max(1, min(eval_batch, max_windows // (bucket * _EVAL_BUCKET)))

        def drain(everything: bool) -> None:
            nonlocal next_emit
            while next_emit in pending and (everything or len(pending) > 2 * eval_batch
                                            or pending[next_emit][1].done()):
                consume(*pending.pop(next_emit))
                next_emit += 1

        def flush(bucket, group, pool) -> None:
            rows = len(group)
            pack = pack_rows(bucket)
            t_max = max(item["mixture"].shape[-1] for _, item in group)
            channels = group[0][1]["mixture"].shape[0]
            mix = np.zeros((pack, channels, t_max), np.float32)
            lengths = np.zeros(pack, np.int32)
            for b, (_, item) in enumerate(group):
                mix[b, :, :item["mixture"].shape[-1]] = item["mixture"]
                lengths[b] = item["mixture"].shape[-1]
            # pad the batch with the last row: one shape per bucket
            mix[rows:] = mix[rows - 1]
            lengths[rows:] = lengths[rows - 1]
            t0 = time.perf_counter()
            enhanced = evaluate_utterance(mix, self.model, self.spec, self.config,
                                          num_sources=num_sources, lengths=lengths,
                                          device=self.device)
            timing["device_s"] += time.perf_counter() - t0
            if self.spec.multi_speaker:
                enhanced = enhanced[:, 0]  # score the target-speaker estimate
            for b, (step, item) in enumerate(group):
                enhanced_np = enhanced[b:b + 1, ..., :int(lengths[b])]
                mixture_np = np.asarray(item["mixture"])[None]
                clean = np.asarray(item["sources"][0])[None]
                if step < int(cfg.get("num_show", 0)):
                    self.spec_audio_visualization(mixture_np[0], enhanced_np[0], clean[0],
                                                  item["name"], step)
                pending[step] = (item["name"], pool.submit(score, clean, enhanced_np,
                                                           mixture_np, item["name"]))
            timing["utterances"] += rows

        t_start = time.perf_counter()
        groups: dict = {}  # window-count bucket -> [(step, item), ...]
        with ThreadPoolExecutor(max_workers=2) as pool:
            for step, item in enumerate(self.test_loader):
                if limit is not None and step >= limit:
                    break
                n_win = _num_windows(item["mixture"].shape[-1], window, stride)
                bucket = -(-n_win // _EVAL_BUCKET)
                groups.setdefault(bucket, []).append((step, item))
                if len(groups[bucket]) >= pack_rows(bucket):
                    flush(bucket, groups.pop(bucket), pool)
                drain(everything=False)
            for bucket in sorted(groups):
                flush(bucket, groups.pop(bucket), pool)
            drain(everything=True)
        timing["wall_s"] = time.perf_counter() - t_start
        self.test_timing = timing

        summary = {side: {k: float(np.mean(v)) for k, v in vals.items() if v}
                   for side, vals in agg.items()}
        if self.writer:
            for side, vals in summary.items():
                for k, v in vals.items():
                    self.writer.add_scalar(f"test/{side}_{k}", v, 0)
        if self.is_primary:
            save_json(summary, os.path.join(self.run_dir, "test_summary.json"))
        return summary

    def compute_metric_clarity(self, mixture: np.ndarray, enhanced: np.ndarray,
                               clean: np.ndarray, name: str) -> Dict[str, Any]:
        """Clarity hearing-aid scoring of one utterance ([C, T] arrays;
        reference solver.py:723-746): ``{haspi,hasqi}_{enhance,mixture}``
        means over the scene's listeners, from ``ha.scoring.ClarityScorer``."""
        if self.clarity_scorer is None:
            raise ValueError("config.ha is not set")
        return self.clarity_scorer.score(clean, mixture, enhanced, name)

    # ---------------------------------------------------------- observability
    def spec_audio_visualization(self, mixture: np.ndarray, enhanced: np.ndarray,
                                 clean: np.ndarray, name: str, step: int) -> None:
        """Waveform and magma spectrogram panels of mixture, enhanced and
        clean to TensorBoard (reference solver.py:643-702); nothing without
        a writer or matplotlib."""
        if self.writer is None:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        sr = int(self.config.dset.sample_rate)
        rows = [("mixture", mixture), ("enhanced", enhanced), ("clean", clean)]
        fig_w, axes_w = plt.subplots(3, 1, figsize=(8, 6), constrained_layout=True)
        for ax, (label, wav) in zip(axes_w, rows):
            flat = np.asarray(wav).reshape(-1)
            ax.plot(np.arange(len(flat)) / sr, flat, linewidth=0.4)
            ax.set_title(f"{label}  mean={flat.mean():.3f} max={np.abs(flat).max():.3f}")
        self.writer.add_figure(f"waveform/{name}", fig_w, step)
        plt.close(fig_w)

        fig_s, axes_s = plt.subplots(3, 1, figsize=(8, 6), constrained_layout=True)
        for ax, (label, wav) in zip(axes_s, rows):
            flat = torch.from_numpy(np.ascontiguousarray(wav, np.float32).reshape(1, -1))
            mag = stft(flat, 512, 128, 512).abs()[0].numpy()
            ax.imshow(20 * np.log10(mag + 1e-8), origin="lower", aspect="auto", cmap="magma")
            ax.set_title(label)
        self.writer.add_figure(f"spectrogram/{name}", fig_s, step)
        plt.close(fig_s)

    def start_profiler(self) -> None:
        """``torch.profiler`` over the first epoch (``solver.profile: true``),
        its trace written into the run's log dir."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities,
                                 on_trace_ready=tensorboard_trace_handler(self.log_dir))
        self._profiler.start()

    def stop_profiler(self) -> None:
        self._profiler.stop()
        self._profiler = None

    # ------------------------------------------------------------ checkpoints
    def checkpoint_state(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.optimizer.state_dict(),
                "step": self._global_step}

    def _resume_checkpoint(self, run_dir: str) -> None:
        """Weights and running statistics, the step and the best score; the
        optimizer's state only with ``optim.load`` (its hyperparameters
        stay the config's)."""
        path = ckpt.latest_checkpoint(run_dir)
        if path is None:
            raise FileNotFoundError(f"no latest_model.ckpt under {run_dir}")
        restored = ckpt.load_checkpoint(path, {"model": None, "optimizer": None,
                                               "step": self._global_step})
        self.model.load_state_dict(restored["model"])
        if bool(self.config.optim.get("load", False)) and restored["optimizer"] is not None:
            optimizer = self.optimizer.optimizer
            settings = [{k: v for k, v in g.items() if k != "params"}
                        for g in optimizer.param_groups]
            optimizer.load_state_dict(restored["optimizer"])
            for group, setting in zip(optimizer.param_groups, settings):
                group.update(setting)
        self._global_step = int(restored["step"])
        scores = ckpt.load_scores(run_dir)
        if scores:
            self.scores["best_score"] = scores.get("best_score")
        print(f"resumed from {path}")

    def _preload_model(self, path: str) -> None:
        """Weights only, as the JAX Solver's preload: a reference ``.pth`` /
        ``.pt`` / ``.tar`` loads as it is, BatchNorm running statistics
        included (the port's keys are the reference's); a port ``.ckpt``
        restores the parameters alone (``named_parameters``), and every
        buffer keeps the value the model was built with, as the JAX Solver
        restores ``{"params"}`` and leaves ``batch_stats`` at their initial
        values. Keys the model does not have are ignored; a key the file
        lacks raises."""
        state = ckpt.model_state(path)
        wanted = list(self.model.state_dict())
        if not path.endswith((".pth", ".pt", ".tar")):
            wanted = [name for name, _ in self.model.named_parameters()]
            state = {k: v for k, v in state.items() if k in wanted}
        missing = [k for k in wanted if k not in state]
        if missing:
            raise KeyError(f"{path} lacks {len(missing)} of the model's keys, e.g. "
                           f"{missing[:3]}")
        self.model.load_state_dict(state, strict=False)
        print(f"preloaded weights from {path}")
