"""The port's data parallelism (parallel/mesh.py) against the JAX package's,
on the CPU.

The ranks are processes of their own (``parallel/mesh.py:spawn``) in a gloo
group joined through a ``file://`` store under the test's temporary
directory, so test workers never share a port; every check that needs the
group runs in one spawn of two ranks (tests/dp_ranks.py:cases), joined with
a time limit. The JAX package runs here on its 8-device virtual CPU mesh
(tests/conftest.py), at tests/test_parallel.py's small dnn config on a
fixture large enough for two steps a run:

* the dnn's 2-rank losses equal JAX ``main`` with ``parallel.data: 2``
  (rtol 1e-4). The dnn has BatchNorm, whose statistics are each shard's
  own in both packages, so its data-parallel loss is not the one-process
  loss; the small tcn (GroupNorm: each example alone) shows that identity,
  2 ranks against 1 (rtol 1e-4);
* the int16 wire against f32 under data parallelism (rtol 2e-3), and
  ``steps_per_call: 2``;
* a small f32 DCCRN with JAX's weights (``compat.dccrn_state_from_jax``):
  one Solver epoch of one batch on 2 ranks against the JAX Solver's
  ``shard_train_step`` on a data=2 mesh, parameters and complex-BN running
  statistics within tests/test_torch_train_step.py's train-step bounds,
  and the statistics unlike rank 0's half batch alone;
* the mesh, ``shard_batch``, the ``init_distributed`` wiring, the host
  sharding of the train files, rank 0's writes, resume on every rank, a
  parameter unused on one rank, the dropout seeds, and
  ``dryrun_multichip(2, device="cpu")``.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dp_ranks
from speech_enhancement_torch.compat import dccrn_state_from_jax, dnn_state_from_jax
from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.data.loader import get_train_wav_dataset
from speech_enhancement_torch.data.synthetic import make_voicebank_demand
from speech_enhancement_torch.ops.rnn import RNNStack
from speech_enhancement_torch.parallel import mesh as mesh_lib
from speech_enhancement_torch.parallel.dryrun import FAMILIES, dryrun_multichip
from speech_enhancement_torch.train import checkpoints as ckpt
from speech_enhancement_torch.train.solver import Solver
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.main import main as jax_main
from speech_enhancement_tpu.parallel import mesh as jax_mesh
from speech_enhancement_tpu.train.solver import Solver as JaxSolver
from test_torch_train_step import OPTIM, SMALL, _assert_leaves_close, _jax_variables

SPAWN_TIMEOUT = 240  # seconds for the two ranks; they take about 30


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs and the port's one-process runs here while two spawns
    of two ranks run (dp_ranks.cases, and the dry run); returns what each
    side found."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    # 24 train files of 2 to 3 s: three batches of 8 one-second segments
    root = make_voicebank_demand(str(tmp / "vbd"), n_utterances=40, min_seconds=2.1,
                                 max_seconds=2.9)
    out = {"tmp": str(tmp), "root": root}

    # the weights both sides start from: the JAX dnn's initial ones, and
    # the small DCCRN's perturbed ones with one batch of four
    jax_dp = jax_main(jax_with_defaults(JaxConfig(dp_ranks.dnn_config(root, str(tmp / "jax"),
                                                                       2))),
                      mode=None, return_solver=True)
    init_pth = str(tmp / "dnn_init.pth")
    torch.save(dnn_state_from_jax(jax_dp.state["params"], jax_dp.state["batch_stats"]), init_pth)
    variables = _jax_variables()
    state_pt = str(tmp / "dccrn_init.pt")
    torch.save(dccrn_state_from_jax(variables["params"], variables["batch_stats"]), state_pt)
    rng = np.random.default_rng(31)
    batch = {"mixture": (0.5 * rng.standard_normal((4, 1, 1600))).astype(np.float32),
             "sources": (0.5 * rng.standard_normal((4, 1, 1, 1600))).astype(np.float32)}
    batch_npz = str(tmp / "dccrn_batch.npz")
    np.savez(batch_npz, **batch)
    out["batch"], out["dccrn_init"] = batch, state_pt

    # the two ranks run while this process takes the JAX and one-process runs
    dccrn = {"config": dp_ranks.dccrn_config(root, str(tmp), 2, SMALL), "state": state_pt,
             "batch": batch_npz}
    with ThreadPoolExecutor(max_workers=2) as pool, pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the ranks' intra-op threads
        ranks = pool.submit(mesh_lib.spawn, dp_ranks.cases, 2, (str(tmp), root, init_pth, dccrn),
                            timeout=SPAWN_TIMEOUT)
        dryrun = pool.submit(dryrun_multichip, 2, device="cpu", timeout=SPAWN_TIMEOUT)
        jax_dp.train()
        out["jax_dnn"] = jax_dp.scores["train_loss"]
        one = dp_ranks._main(dp_ranks.dnn_config(root, str(tmp), 1, preloaded_model=init_pth),
                             run_dir=str(tmp / "dnn_one"))
        out["one_dnn_ckpt"] = os.path.join(one.checkpoint_dir, "latest_model.ckpt")
        out["one_tcn"] = dp_ranks._main(dp_ranks.tcn_config(root, str(tmp), 1),
                                        run_dir=str(tmp / "tcn_one")).scores["train_loss"]
        cfg = with_defaults(Config(dp_ranks.dnn_config(root, str(tmp), 1)))
        out["train_files"] = get_train_wav_dataset(cfg.dset, cfg.model, seed=3)[0].mixture_files

        dccrn_cfg = dp_ranks.dccrn_config(root, str(tmp / "jax_dccrn"), 2, SMALL)
        jax_solver = jax_main(jax_with_defaults(JaxConfig(dccrn_cfg)), mode=None,
                              return_solver=True,
                              mesh=jax_mesh.make_mesh(data=2, devices=jax.devices()[:2]))
        params = jax.tree.map(jnp.asarray, variables["params"])
        jax_solver.state = {"params": params,
                            "batch_stats": jax.tree.map(jnp.asarray, variables["batch_stats"]),
                            "opt_state": jax_solver.optimizer.init(params),
                            "step": jnp.zeros((), jnp.int32)}
        jax_solver.train_loader = [batch]
        out["jax_dccrn"] = {"loss": jax_solver._run_one_epoch(0),
                            "state": dccrn_state_from_jax(jax_solver.state["params"],
                                                          jax_solver.state["batch_stats"])}
        ranks.result()
        out["dryrun"] = dryrun.result()
    out["ranks"] = [torch.load(str(tmp / f"rank{r}.pt")) for r in range(2)]
    return out


def _fake_mesh(rank, world=2, model=1, host_ranks=None):
    return mesh_lib.Mesh(shape={"data": world // model, "model": model}, rank=rank,
                         world_size=world, data_index=rank // model, device=torch.device("cpu"),
                         host_ranks=world if host_ranks is None else host_ranks)


def test_make_mesh_shapes_and_errors(runs):
    for rank, found in enumerate(r["mesh"] for r in runs["ranks"]):
        assert found["shape"] == {"data": 2, "model": 1}
        assert found["model2"] == {"data": 1, "model": 2}
        assert (found["rank"], found["world_size"], found["data_index"]) == (rank, 2, rank)
        for key in ("4x1", "1x1", "2x2"):
            assert "processes; the group has 2" in found[key], key
    # no group: only a mesh of one
    assert mesh_lib.make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="the group has 1"):
        mesh_lib.make_mesh(data=2, device="cpu")


def test_shard_batch_cuts_every_leaf_as_jax_shards_it():
    rng = np.random.default_rng(4)
    wire = {"q": rng.integers(-2**15, 2**15, (8, 1, 50)).astype(np.int16),
            "scale": rng.uniform(0.1, 1.0, (8, 1, 1)).astype(np.float32)}
    sharded = jax_mesh.shard_batch(jax_mesh.make_mesh(data=2, devices=jax.devices()[:2]), wire)
    for rank in range(2):
        got = mesh_lib.shard_batch(_fake_mesh(rank), wire)
        for key in ("q", "scale"):
            want = np.asarray(sharded[key].addressable_shards[rank].data)
            np.testing.assert_array_equal(got[key], want)
            np.testing.assert_array_equal(got[key], wire[key][4 * rank:4 * rank + 4])
    # two hosts of one rank each: every rank takes its host's whole batch
    assert mesh_lib.shard_batch(_fake_mesh(1, host_ranks=1), wire["q"]).shape == (8, 1, 50)
    # a model axis of 2: the ranks of a data index take the same rows
    halves = [mesh_lib.shard_batch(_fake_mesh(r, world=4, model=2), wire["q"]) for r in range(4)]
    np.testing.assert_array_equal(halves[2], halves[3])
    np.testing.assert_array_equal(halves[2], wire["q"][4:])
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.shard_batch(_fake_mesh(0), wire["q"][:3])


def test_batch_size_check_raises_the_jax_solvers_error(tmp_path):
    cfg = dp_ranks.dnn_config(str(tmp_path), str(tmp_path), 2, batch_size=3)
    with pytest.raises(ValueError) as jax_err:
        JaxSolver(jax_with_defaults(JaxConfig(cfg)), None, None, None, None,
                  mesh=jax_mesh.make_mesh(data=2, devices=jax.devices()[:2]))
    with pytest.raises(ValueError) as port_err:
        Solver(with_defaults(Config(cfg)), None, None, None, None, device="cpu",
               mesh=_fake_mesh(0))
    assert str(port_err.value) == str(jax_err.value)


def test_init_distributed_wiring(monkeypatch):
    """The group's init method from the config (tcp://) or torchrun's
    environment (env://); none without a need for one; a raise naming
    torchrun when neither route is set; an existing group kept."""
    dist = torch.distributed
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_lib.init_distributed(Config({"multihost": False}), "cpu") is False
    assert mesh_lib.init_distributed(Config({"data": 1, "model": 1}), "cpu") is False
    assert calls == []
    for needs_group in ({"data": 2}, {"multihost": True}, {"data": 1, "model": 2}):
        with pytest.raises(RuntimeError, match="torchrun"):
            mesh_lib.init_distributed(Config(needs_group), "cpu")
    assert calls == []
    cfg = Config({"multihost": True, "coordinator_address": "10.0.0.1:1234",
                  "num_processes": 4, "process_id": 2})
    assert mesh_lib.init_distributed(cfg, "cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4,
                      "rank": 2}]
    for var, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"), ("RANK", "0"),
                       ("WORLD_SIZE", "2")):
        monkeypatch.setenv(var, value)
    assert mesh_lib.init_distributed(Config({"data": 2}), "cpu") is True
    assert calls[-1] == {"backend": "gloo", "init_method": "env://"}
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert mesh_lib.init_distributed(Config({"data": 2}), "cpu") is True
    assert len(calls) == 2


def test_host_sharding_of_the_train_files(runs):
    """One host (no LOCAL_WORLD_SIZE): every rank reads the list one JAX
    process reads. Each rank a host: disjoint shards whose union is it."""
    full = list(runs["train_files"])
    shards = []
    for rank, found in enumerate(r for r in runs["ranks"]):
        assert found["train_files"]["one_host"] == full
        shards.append(found["train_files"]["two_hosts"])
        assert found["host_index_count"] == (rank, 2)
        assert found["shard_of_10"] == list(range(rank, 10, 2))
    assert set(shards[0]).isdisjoint(shards[1])
    assert sorted(shards[0] + shards[1]) == sorted(full)


def test_dnn_data_parallel_loss_matches_jax(runs):
    for found in runs["ranks"]:
        assert found["f32"]["wrapper"] == "DistributedDataParallel"
        assert found["f32"]["step"] == 2  # two steps of the per-host batch of 8
        np.testing.assert_allclose(found["f32"]["train_loss"], runs["jax_dnn"], rtol=1e-4)
        assert found["f32"]["train_loss"][0] > 0
    assert runs["ranks"][0]["f32"]["train_loss"] == runs["ranks"][1]["f32"]["train_loss"]
    assert runs["ranks"][0]["f32"]["val_loss"] == runs["ranks"][1]["f32"]["val_loss"]


def test_tcn_two_ranks_match_one(runs):
    """GroupNorm normalises each example alone, so the mean of the shards'
    mse and of their gradients is the whole batch's."""
    assert runs["one_tcn"][0] > 0
    for found in runs["ranks"]:
        np.testing.assert_allclose(found["tcn"], runs["one_tcn"], rtol=1e-4)


def test_int16_wire_under_data_parallelism(runs):
    for found in runs["ranks"]:
        np.testing.assert_allclose(found["int16"], found["f32"]["train_loss"], rtol=2e-3)


def test_steps_per_call_under_data_parallelism(runs):
    for found in runs["ranks"]:
        assert found["multi"]["step"] == 3  # one chunk of two, then one step
        assert np.all(np.isfinite(found["multi"]["train_loss"]))
    assert runs["ranks"][0]["multi"] == runs["ranks"][1]["multi"]


def test_replicas_stay_identical(runs):
    r0, r1 = (r["f32"]["state"] for r in runs["ranks"])
    assert sorted(r0) == sorted(r1)
    for key in r0:
        assert torch.equal(r0[key], r1[key]), key


def test_checkpoint_discipline(runs):
    """Rank 0 writes every artifact and rank 1 none; the checkpoint's keys
    are a one-process run's (no ``module.`` prefix); both ranks resume the
    rank-0 run to the same parameters, step and best score."""
    tmp = runs["tmp"]
    r0, r1 = runs["ranks"]
    assert r0["f32"]["is_primary"] and r0["f32"]["writer"]
    assert not r1["f32"]["is_primary"] and not r1["f32"]["writer"]
    for run in ("f32", "int16", "multi", "resume", "tcn", "dccrn"):
        assert os.path.isdir(os.path.join(tmp, f"{run}_rank0")), run
        assert not os.path.exists(os.path.join(tmp, f"{run}_rank1")), run
    assert os.path.exists(os.path.join(tmp, "f32_rank0", "results.csv"))
    assert r0["summary"] == r1["summary"]
    dp_keys = list(ckpt.model_state(os.path.join(tmp, "f32_rank0", "checkpoints",
                                                 "latest_model.ckpt")))
    assert dp_keys == list(ckpt.model_state(runs["one_dnn_ckpt"]))
    assert not any(k.startswith("module.") for k in dp_keys)
    assert r0["resume"]["step"] == r1["resume"]["step"] == r0["f32"]["step"] == 2
    assert r0["resume"]["best_score"] == r1["resume"]["best_score"] is not None
    for key, value in r0["f32"]["state"].items():
        assert torch.equal(r0["resume"]["state"][key], value), key
        assert torch.equal(r1["resume"]["state"][key], value), key


def test_dccrn_batch_stats_match_jax_shard_train_step(runs):
    """One step on 2 ranks against the JAX Solver on a data=2 mesh from the
    same weights and batch: loss rtol 2e-3; parameters and running
    statistics within the train step's bounds (one step: Adam's 2 lr, and
    0.1 of it on the running means). The statistics are the mean of the
    shards' and not rank 0's half batch alone, which is what DDP's default
    ``broadcast_buffers`` would leave after its next forward."""
    from speech_enhancement_torch.models.dccrn import DCCRN
    from speech_enhancement_torch.train.solver import get_optimizer, train_step

    want = runs["jax_dccrn"]
    lr = OPTIM["lr"]
    n_blocks = len(SMALL["kernel_num"])
    for found in runs["ranks"]:
        np.testing.assert_allclose(found["dccrn"]["loss"], want["loss"], rtol=2e-3)
        _assert_leaves_close(found["dccrn"]["state"], want["state"], n_blocks, extra=2 * lr,
                             rms_extra=2 * lr * 0.1)
    for key, value in runs["ranks"][0]["dccrn"]["state"].items():
        assert torch.equal(runs["ranks"][1]["dccrn"]["state"][key], value), key

    half = DCCRN(**SMALL)
    half.load_state_dict(torch.load(runs["dccrn_init"]))
    batch = runs["batch"]
    train_step(half, half.SPEC, get_optimizer(Config(OPTIM), half.parameters()),
               batch["mixture"][:2], batch["sources"][:2], "mse", device="cpu")
    stats = [k for k in want["state"] if k.endswith((".RMr", ".RMi", ".RVrr", ".RVri", ".RVii"))]
    assert stats
    gaps = {}
    for key in stats:
        ref = want["state"][key]
        bound = 2e-3 * max(ref.abs().max().item(), 1e-8) + 2 * lr * 0.1
        gaps[key] = (half.state_dict()[key] - ref).abs().max().item() / bound
    assert max(gaps.values()) > 10, gaps  # far outside the bound the ranks keep


def test_parameter_unused_on_one_rank_is_reduced(runs):
    """``b`` feeds the output on rank 0 only (gradient 3) and none on rank 1:
    both ranks get the mean 1.5 (pmean of 3 and zero), on both steps."""
    for found in runs["ranks"]:
        for step in found["unused"]:
            assert torch.equal(step["a"], torch.tensor([2.0, 2.0]))  # (3 + 1) / 2
            assert torch.equal(step["b"], torch.tensor([1.5]))


def test_dropout_masks_differ_between_data_shards():
    """Each shard's dropout: its index folded into the stacks' seeds and
    into torch's generator; the same index gives the same masks."""
    def masks(index):
        stack = RNNStack("lstm", 8, 8, num_layers=2, dropout=0.5,
                         generator=torch.Generator().manual_seed(1))
        mesh_lib.fold_in_data_index(stack, 10, _fake_mesh(index))
        return stack.dropout_seed, stack._drop(torch.ones(64)), torch.rand(4)

    a, b, again = masks(0), masks(1), masks(0)
    assert a[0] != b[0] and a[0] == again[0]
    assert not torch.equal(a[1], b[1]) and torch.equal(a[1], again[1])
    assert not torch.equal(a[2], b[2]) and torch.equal(a[2], again[2])


def test_dryrun_multichip_on_two_cpu_ranks(runs):
    ranks = runs["dryrun"]
    assert len(ranks) == 2
    for family in FAMILIES:
        r0, r1 = ranks[0][family], ranks[1][family]
        assert r0 == r1, family  # the loss averaged, the grad norm of the averaged gradients
        assert r0["step"] == 1 and np.isfinite(r0["loss"]) and np.isfinite(r0["grad_norm"])
    assert all(n == 0 for r in ranks for n in r["launches"].values())  # plain versions on the CPU
