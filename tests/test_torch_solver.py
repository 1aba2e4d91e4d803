"""The port's Solver and CLI on the CPU: the JAX package's tests/test_solver.py
and tests/test_eval_batched.py, mirrored on a small f32 DCCRN.

Artifacts, resume, early stop, validation invariant to the batch size, the
step caps gated on ``all_steps``, ``steps_per_call`` 2 equal to 1 bit for
bit, the int16 wire against f32, PIT only for a multi-speaker model, the
packed test pass equal to batch 1 (a capped packing group included), the
non-finite-loss stop, preload, what raises, and the command line.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.data.synthetic import make_voicebank_demand
from speech_enhancement_torch.main import main
from speech_enhancement_torch.train import checkpoints as ckpt
from speech_enhancement_torch.train import metrics as port_metrics
from speech_enhancement_torch.train import solver as solver_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"name": "dccrn", "kernel_num": [8, 16], "rnn_units": 16, "segment": 1,
         "win_length": 512}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models on the CPU run on one intra-op thread: as fast alone,
    and not slowed by the other test processes that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vbd_root(tmp_path_factory):
    return make_voicebank_demand(str(tmp_path_factory.mktemp("torch_vbd")), n_utterances=10,
                                 min_seconds=1.1, max_seconds=1.9, seed=3)


def _config(vbd_root, run_root, **solver):
    base = {
        "root": run_root, "epochs": 2, "batch_size": 4, "all_steps": False,
        "total_steps": 3, "save_checkpoint_interval": 1, "patience": 40,
        "validation": {"total_steps": 2, "interval": 1, "metric": "loss"},
        "test": {"total_steps": 3, "interval": 1, "num_show": 1, "metric": "sisdr"},
    }
    base.update(solver)
    return with_defaults(Config({
        "seed": 7,
        "optim": {"optim": "adam", "lr": 1e-3, "loss": "si-sdr", "clip_grad": 5},
        "model": SMALL,
        "dset": {"name": "VoiceBankDEMAND", "wav": vbd_root, "split": [0.5, 0.2, 0.3],
                 "segment": 1, "audio_channels": 1, "sample_rate": 16000, "norm": "z-score"},
        "solver": base,
    }))


@pytest.fixture(scope="module")
def trained(vbd_root, tmp_path_factory):
    """Two capped epochs under the profiler, then the resumed test pass."""
    cfg = _config(vbd_root, str(tmp_path_factory.mktemp("torch_run")), profile=True)
    solver = main(cfg, mode="train", return_solver=True, device="cpu")
    return solver


def test_train_writes_the_run_dir(trained):
    solver = trained
    assert len(solver.scores["train_loss"]) == len(solver.scores["val_loss"]) == 2
    assert all(np.isfinite(solver.scores["train_loss"] + solver.scores["val_loss"]))
    files = sorted(os.listdir(solver.checkpoint_dir))
    assert {"latest_model.ckpt", "best_model.ckpt", "state.json"} <= set(files)
    assert len([f for f in files if f.startswith("model_")]) == 2
    state = json.load(open(os.path.join(solver.checkpoint_dir, "state.json")))
    assert state["best_score"] == min(state["val_loss"]) and len(state["epoch_wall_s"]) == 2
    latest = torch.load(os.path.join(solver.checkpoint_dir, "latest_model.ckpt"),
                        weights_only=True)
    assert sorted(latest) == ["model", "optimizer", "step"]
    assert latest["step"] == solver._global_step == sum(
        e["train_steps"] for e in solver.epoch_stats) > 0
    # a per-epoch file is a bare state_dict with the reference's keys
    per_epoch = [f for f in files if f.startswith("model_")][0]
    bare = torch.load(os.path.join(solver.checkpoint_dir, per_epoch), weights_only=True)
    assert "encoder.0.0.real_conv.weight" in bare and "enhance.0.real_lstm.weight_ih_l0" in bare
    assert sorted(solver.model.state_dict()) == sorted(bare)
    assert yaml.safe_load(open(os.path.join(solver.run_dir, "config.yaml")))["seed"] == 7
    traces = [f for _, _, names in os.walk(solver.log_dir) for f in names if "trace" in f]
    assert traces, "solver.profile wrote no torch.profiler trace"


@pytest.mark.parametrize("load_optimizer", [False, True])
def test_resume_restores_weights_step_and_optimizer(trained, vbd_root, tmp_path,
                                                    load_optimizer):
    cfg = _config(vbd_root, str(tmp_path), resume=trained.run_dir, epochs=0)
    cfg.optim.load = load_optimizer
    cfg.optim.lr = 5e-4
    solver = main(cfg, mode="validation", return_solver=True, device="cpu")
    for key, value in trained.model.state_dict().items():
        assert torch.equal(solver.model.state_dict()[key], value), key
    assert solver._global_step == trained._global_step > 0
    assert solver.scores["best_score"] == trained.scores["best_score"]
    opt = solver.optimizer.optimizer
    assert bool(opt.state) == load_optimizer
    assert opt.param_groups[0]["lr"] == 5e-4  # the config's, not the file's
    if load_optimizer:
        want = trained.optimizer.optimizer.state_dict()["state"]
        for idx, entry in opt.state_dict()["state"].items():
            assert torch.equal(entry["exp_avg"], want[idx]["exp_avg"])


def test_inference_scores_enhanced_and_mixture(trained, vbd_root, tmp_path):
    cfg = _config(vbd_root, str(tmp_path), resume=trained.run_dir, epochs=0)
    cfg.solver.test.metrics = "sisdr"  # a scalar is one metric, not its letters
    only_sisdr = main(cfg, mode="test", return_solver=True, device="cpu")
    summary = json.load(open(os.path.join(only_sisdr.run_dir, "test_summary.json")))
    assert sorted(summary["enhanced"]) == sorted(summary["mixture"]) == ["sisdr"]

    cfg.solver.test.metrics = ["sisdr", "stoi", "pesq"]
    solver = main(cfg, mode="test", return_solver=True, device="cpu", save=True)
    summary = json.load(open(os.path.join(solver.run_dir, "test_summary.json")))
    assert sorted(summary["enhanced"]) == ["pesq", "sisdr", "stoi"]
    rows = list(csv.DictReader(open(os.path.join(solver.run_dir, "results.csv"))))
    assert len(rows) == 3 == solver.test_timing["utterances"]
    assert port_metrics.pesq_backend()[0] is not None
    for row in rows:
        assert 1.0 <= float(row["pesq_enhance"]) <= 4.65 and np.isfinite(
            float(row["sisdr_enhance"]))
        assert row["haspi_enhance"] == ""
    wavs = sorted(os.listdir(os.path.join(solver.run_dir, "enhanced")))
    assert wavs == sorted(f"{row['scene']}.wav" for row in rows)


def test_pit_only_for_a_multi_speaker_model(trained):
    """optim.pit on a single-speaker model: the JAX Solver turns PIT off
    (speech_enhancement_tpu/train/solver.py:110), and so does the port's."""
    cfg = trained.config.copy()
    cfg.optim.pit = True
    solver = solver_mod.Solver(cfg, trained.model, trained.spec, trained.train_loader,
                               trained.val_loader, run_dir=trained.run_dir + "_pit",
                               device="cpu")
    assert not solver.use_pit


def test_val_loss_invariant_to_batch_size(vbd_root, tmp_path):
    """Validation counts every segment once (last batch zero-padded and
    masked), so the epoch's loss does not depend on the batch size."""
    losses = []
    for i, batch_size in enumerate((4, 3)):
        cfg = _config(vbd_root, str(tmp_path / str(i)), batch_size=batch_size,
                      all_steps=True, epochs=0)
        solver = main(cfg, mode=None, return_solver=True, device="cpu")
        losses.append(solver._run_one_epoch(0, train=False))
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


class _CountingLoader:
    def __init__(self, inner):
        self.inner = inner
        self.batches = 0

    def __iter__(self):
        for batch in self.inner:
            self.batches += 1
            yield batch


def test_val_step_cap_gated_on_all_steps(vbd_root, tmp_path):
    cfg = _config(vbd_root, str(tmp_path), batch_size=2, all_steps=True, epochs=0)
    cfg.dset.split = [0.1, 0.6, 0.3]  # 6 validation utterances -> 3 batches
    cfg.solver.validation.total_steps = 1
    solver = main(cfg, mode=None, return_solver=True, device="cpu")
    full = len(list(solver.val_loader))
    assert full > 1
    counter = _CountingLoader(solver.val_loader)
    solver.val_loader = counter
    solver._run_one_epoch(0, train=False)
    assert counter.batches == full  # no cap with all_steps
    solver.config.solver.all_steps = False
    capped = _CountingLoader(counter.inner)
    solver.val_loader = capped
    solver._run_one_epoch(0, train=False)
    assert capped.batches < full


def test_early_stop_only_counts_validation_epochs(vbd_root, tmp_path):
    cfg = _config(vbd_root, str(tmp_path), epochs=4)
    cfg.solver.validation.interval = 2
    solver = main(cfg, mode="train", return_solver=True, device="cpu")
    assert len(solver.scores["val_loss"]) == 2  # epochs 1 and 3 only
    assert solver.early_stop_count <= 2


def test_patience_stops_training(vbd_root, tmp_path):
    """Validation losses that only rise: with patience 1 the third epoch
    is the last (best at 0, worse at 1 and 2)."""
    cfg = _config(vbd_root, str(tmp_path), epochs=6, patience=1)
    solver = main(cfg, mode=None, return_solver=True, device="cpu")
    solver._run_one_epoch = lambda epoch, train=True: 1.0 if train else float(epoch)
    scores = solver.train()
    assert scores["val_loss"] == [0.0, 1.0, 2.0] and scores["best_score"] == 0.0
    assert solver.early_stop_count == 2


def test_steps_per_call_equals_single_steps_bitwise(vbd_root, tmp_path):
    runs = []
    for spc in (1, 2):
        cfg = _config(vbd_root, str(tmp_path / str(spc)), steps_per_call=spc, total_steps=3,
                      epochs=1, batch_size=1)
        runs.append(main(cfg, mode="train", return_solver=True, device="cpu"))
    assert runs[0].epoch_stats[0]["train_steps"] == 3  # an odd count: a partial chunk
    assert runs[0].scores["train_loss"] == runs[1].scores["train_loss"]
    assert runs[0].scores["val_loss"] == runs[1].scores["val_loss"]
    for (key, a), b in zip(runs[0].model.state_dict().items(),
                           runs[1].model.state_dict().values()):
        assert torch.equal(a, b), key


def test_int16_wire_matches_f32(vbd_root, tmp_path):
    runs = []
    for wire in ("f32", "int16"):
        cfg = _config(vbd_root, str(tmp_path / wire))
        cfg.dset.wire = wire
        runs.append(main(cfg, mode="train", return_solver=True, device="cpu"))
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(runs[1].scores[key], runs[0].scores[key], rtol=2e-3,
                                   atol=1e-5)


def test_pit_discard_compat_takes_the_plain_loss(trained):
    """The reference computes PIT and throws it away (src/solver.py:469-480):
    with the flag the Solver's loss is the plain one."""
    solver = trained
    rng = np.random.default_rng(0)
    target = torch.from_numpy(rng.standard_normal((2, 2, 1, 400)).astype(np.float32))
    output = target.flip(1) + 0.1 * torch.from_numpy(
        rng.standard_normal((2, 2, 1, 400)).astype(np.float32))
    solver.use_pit = True
    try:
        pit = solver._loss(output, target, None)
        solver.pit_discard_compat = True
        plain = solver._loss(output, target, None)
    finally:
        solver.use_pit = solver.pit_discard_compat = False
    assert pit < plain
    assert torch.equal(plain, solver._loss(output, target, None))


def test_non_finite_loss_stops_training(trained, monkeypatch):
    def nan_step(model, *args, **kwargs):
        return torch.tensor(float("nan")), torch.tensor(1.0)

    monkeypatch.setattr(solver_mod, "train_step", nan_step)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trained._run_one_epoch(5, train=True)


@pytest.mark.parametrize("max_windows", [256, 16])
def test_packed_test_pass_equals_batch_one(trained, vbd_root, tmp_path, max_windows):
    """solver.test.batch_size 4 gives the rows and the summary of batch 1;
    max_windows 16 caps a group of 1.1 to 1.9 s utterances (two to four
    buckets of 4 windows each) below the batch size."""
    outputs = []
    for batch in (1, 4):
        cfg = _config(vbd_root, str(tmp_path / str(batch)), resume=trained.run_dir, epochs=0)
        cfg.solver.test.total_steps = 0
        cfg.solver.test.batch_size = batch
        cfg.solver.test.max_windows = max_windows
        cfg.dset.split = [0.5, 0.0, 0.5]
        cfg.solver.test.metrics = ["sisdr", "stoi"]
        solver = main(cfg, mode="test", return_solver=True, device="cpu")
        rows = list(csv.reader(open(os.path.join(solver.run_dir, "results.csv"))))
        outputs.append((rows, json.load(open(os.path.join(solver.run_dir,
                                                          "test_summary.json")))))
    assert len(outputs[0][0]) == 6  # header + five utterances
    assert outputs[0] == outputs[1]


def test_preload_port_checkpoint_and_bare_state_dict(trained, vbd_root, tmp_path):
    bare = str(tmp_path / "weights.pth")
    torch.save({k: v.clone() for k, v in trained.model.state_dict().items()}, bare)
    built = main(_config(vbd_root, str(tmp_path / "built"), epochs=0), mode=None,
                 return_solver=True, device="cpu").model.state_dict()
    for i, path in enumerate((os.path.join(trained.checkpoint_dir, "best_model.ckpt"), bare)):
        cfg = _config(vbd_root, str(tmp_path / f"run{i}"), epochs=0, preloaded_model=path)
        solver = main(cfg, mode=None, return_solver=True, device="cpu")
        want = ckpt.model_state(path)
        params = dict(solver.model.named_parameters())
        for key, value in solver.model.state_dict().items():
            # a port .ckpt restores the parameters only, the running
            # statistics stay as built (the JAX Solver's preload); a .pth
            # loads whole
            expected = want[key] if path == bare or key in params else built[key]
            assert torch.equal(value, expected), key
        buffers = [k for k in want if k not in params]
        assert buffers and any(not torch.equal(want[k], built[k]) for k in buffers)
        assert solver._global_step == 0 and not solver.optimizer.optimizer.state
    partial = str(tmp_path / "partial.pth")
    torch.save({"encoder.0.2.weight": torch.ones(1)}, partial)
    cfg = _config(vbd_root, str(tmp_path / "partial"), preloaded_model=partial)
    with pytest.raises(KeyError, match="lacks"):
        main(cfg, mode=None, device="cpu")


def test_main_raises_for_what_is_not_ported(vbd_root, tmp_path, monkeypatch):
    cfg = _config(vbd_root, str(tmp_path))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(cfg, mode=None)
    with pytest.raises(ValueError, match="unknown mode"):
        main(cfg, mode="serve", device="cpu")
    # data parallelism needs a process group: without torchrun's environment
    # or a coordinator address main() names the launcher
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for parallel in ({"data": 2}, {"multihost": True}):
        with pytest.raises(RuntimeError, match="torchrun"):
            main(cfg.merged({"parallel": parallel}), mode=None, device="cpu")


def test_cli_runs_validation(vbd_root, tmp_path):
    cfg = _config(vbd_root, str(tmp_path / "root"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    run_dir = str(tmp_path / "cli_run")
    proc = subprocess.run(
        [sys.executable, "-m", "speech_enhancement_torch", "--config", str(path),
         "--mode", "validation", "--device", "cpu", "--run-dir", run_dir],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    loss = float(proc.stdout.split("validation loss=")[1].split()[0])
    assert np.isfinite(loss)
    assert os.path.exists(os.path.join(run_dir, "config.yaml"))
