"""The port's Solver vs the JAX package's, on the CPU, on a small f32 DCCRN.

Both Solvers are built by their own ``main(cfg, mode=None)`` from the same
config and the same ``make_voicebank_demand`` fixture; the JAX run's
initial weights are carried into the port's model by
``compat.dccrn_state_from_jax``. Both train two capped epochs on the same
batches (the loaders are equal bit for bit, tests/test_torch_data.py) and
test the same utterances. Per-epoch train and validation losses agree to
rtol 2e-3, the train-step parity's tolerance
(tests/test_torch_train_step.py): Adam moves a conv bias that complex BN
follows (true gradient zero, rounding residue either way) by up to lr a
step in either direction, which BN cancels in training but not in the
eval-mode validation. The test summaries agree to rtol 1e-3 (STOI) and
1e-2 absolute (PESQ, and SI-SDR in dB: the enhanced signals' SI-SDR here
is near 0 dB, where a relative bound says nothing; 1e-2 dB is the losses'
2e-3 at their 5 dB). A reference-style ``.pth`` preloaded by both Solvers
gives the same validation loss.
"""

import csv
import os

import numpy as np
import pytest
import torch

from speech_enhancement_torch.compat import dccrn_state_from_jax
from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.data.synthetic import make_voicebank_demand
from speech_enhancement_torch.main import main
from speech_enhancement_torch.train.checkpoints import model_state
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.main import main as jax_main

CONFIG = {
    "seed": 7,
    "optim": {"optim": "adam", "lr": 3e-4, "loss": "si-sdr", "clip_grad": 5},
    "model": {"name": "dccrn", "kernel_num": [8, 16], "rnn_units": 16, "segment": 1,
              "win_length": 512},
    "dset": {"name": "VoiceBankDEMAND", "split": [0.5, 0.2, 0.3], "segment": 1},
    "solver": {"epochs": 2, "batch_size": 2, "all_steps": False, "total_steps": 3,
               "validation": {"total_steps": 2},
               "test": {"total_steps": 3, "num_show": 0,
                        "metrics": ["sisdr", "stoi", "pesq"]}},
}


def _configs(root, tmp):
    out = []
    for cls, defaults, name in ((Config, with_defaults, "port"),
                                (JaxConfig, jax_with_defaults, "jax")):
        cfg = defaults(cls(CONFIG))
        cfg.dset.wav = root
        cfg.solver.root = str(tmp / name)
        out.append(cfg)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models on the CPU run on one intra-op thread: as fast alone,
    and not slowed by the other test processes that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parity")
    root = make_voicebank_demand(str(tmp / "vbd"), n_utterances=10, min_seconds=1.1,
                                 max_seconds=1.9, seed=5)
    port_cfg, jax_cfg = _configs(root, tmp)
    jax_solver = jax_main(jax_cfg, mode=None, return_solver=True)
    port = main(port_cfg, mode=None, return_solver=True, device="cpu")
    port.model.load_state_dict(dccrn_state_from_jax(jax_solver.state["params"],
                                                    jax_solver.state["batch_stats"]))
    for solver in (jax_solver, port):
        solver.train()
        solver.inference()
    return {"root": root, "tmp": tmp, "port": port, "jax": jax_solver}


def test_train_and_validation_losses_match(runs):
    port, ref = runs["port"].scores, runs["jax"].scores
    assert len(port["train_loss"]) == len(port["val_loss"]) == 2
    assert runs["port"]._global_step == int(runs["jax"].state["step"]) == 4
    for key in ("train_loss", "val_loss", "best_score"):
        np.testing.assert_allclose(port[key], ref[key], rtol=2e-3, err_msg=key)


def test_test_summaries_match(runs):
    rows = []
    for solver in (runs["port"], runs["jax"]):
        with open(os.path.join(solver.run_dir, "results.csv")) as handle:
            rows.append(list(csv.DictReader(handle)))
    assert [r["scene"] for r in rows[0]] == [r["scene"] for r in rows[1]]
    assert len(rows[0]) == 3
    port = runs["port"].inference()
    ref = runs["jax"].inference()
    for side in ("enhanced", "mixture"):
        assert sorted(port[side]) == sorted(ref[side]) == ["pesq", "sisdr", "stoi"]
        np.testing.assert_allclose(port[side]["stoi"], ref[side]["stoi"], rtol=1e-3)
        for key in ("sisdr", "pesq"):
            np.testing.assert_allclose(port[side][key], ref[side][key], rtol=0, atol=1e-2,
                                       err_msg=f"{side} {key}")


def test_preloaded_pth_gives_the_jax_validation_loss(runs):
    """A port DCCRN's state_dict saved as a reference .pth: the port's
    Solver loads it as it is, the JAX Solver through
    params_from_torch_checkpoint. Both Solvers have run the same epochs, so
    their validation loaders crop the same segments."""
    from speech_enhancement_torch.models import build_model

    pth = str(runs["tmp"] / "dccrn.pth")
    model, _ = build_model(runs["port"].config.model, device="cpu",
                           generator=torch.Generator().manual_seed(21))
    torch.save(model.state_dict(), pth)
    losses = []
    for solver in (runs["port"], runs["jax"]):
        solver._preload_model(pth)
        losses.append(solver._run_one_epoch(0, train=False))
    for key, value in model.state_dict().items():
        assert torch.equal(runs["port"].model.state_dict()[key], value), key
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_preloaded_ckpt_restores_parameters_only_in_both_solvers(runs):
    """Each package's own trained ``latest_model.ckpt`` preloaded into a
    fresh Solver of that package: both restore the parameters alone and
    keep the complex-BN running statistics as built (the JAX Solver
    restores ``{"params"}``), so both validate the same to the train
    losses' rtol 2e-3. Loading the port's file whole, running statistics
    included (what the port's preload did before), validates elsewhere:
    the gap is stated, and it is far outside that bound."""
    tmp = runs["tmp"]
    port_cfg, jax_cfg = _configs(runs["root"], tmp / "preload")
    port_cfg.solver.preloaded_model = os.path.join(runs["port"].checkpoint_dir,
                                                   "latest_model.ckpt")
    jax_cfg.solver.preloaded_model = os.path.join(runs["jax"].checkpoint_dir,
                                                  "latest_model.ckpt")
    jax_fresh = jax_main(jax_cfg, mode=None, return_solver=True)
    port_fresh = main(port_cfg, mode=None, return_solver=True, device="cpu")
    built = dccrn_state_from_jax(jax_fresh.state["params"], jax_fresh.state["batch_stats"])
    trained = model_state(port_cfg.solver.preloaded_model)
    params = dict(port_fresh.model.named_parameters())
    for key, value in port_fresh.model.state_dict().items():
        want = trained[key] if key in params else built[key]
        assert torch.equal(value, want), key
    port_loss = port_fresh._run_one_epoch(0, train=False)
    jax_loss = jax_fresh._run_one_epoch(0, train=False)
    np.testing.assert_allclose(port_loss, jax_loss, rtol=2e-3)

    old = main(port_cfg.merged({"solver": {"preloaded_model": ""}}), mode=None,
               return_solver=True, device="cpu")
    old.model.load_state_dict(trained)
    old_loss = old._run_one_epoch(0, train=False)
    gap = abs(old_loss - jax_loss) / abs(jax_loss)
    print(f"ckpt preload validation: port {port_loss:.6f}, JAX {jax_loss:.6f}; the whole "
          f"state_dict (old behaviour) {old_loss:.6f}, {gap:.3e} of the JAX loss off")
    assert gap > 10 * 2e-3
