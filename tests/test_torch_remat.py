"""Rematerialisation with named saves, the port vs the JAX package, on the CPU.

DCCRN: the small model of tests/test_complex_ops.py:154-172
(``kernel_num=(8, 16)``, one complex LSTM layer of 16 units, f32), its
weights the JAX initial tree with biases, BN statistics and slopes moved,
carried over by ``dccrn_state_from_jax``. Each remat policy, centred and
``cbn_fold``, takes one MSE step against JAX's same variant: the train()
output within tests/test_complex_ops.py's 3e-5, the loss, grad norm, every
gradient and every parameter after one Adam step within
tests/test_torch_train_step.py's bounds, and the running statistics after
the step within 2e-5 of JAX's and of the port's remat-off step (a second
momentum update on the recompute would move them by 0.1 of their change).

Sepformer: ``remat_policy="attn_out"`` against JAX's same variant (the
small model of tests/test_torch_sepformer.py), and against remat off
within tests/test_torch_sepformer_options.py's 1e-6.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.models import dccrn as jax_dccrn
from speech_enhancement_tpu.models import sepformer as jax_sep
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import dccrn_state_from_jax, sepformer_state_from_jax
from speech_enhancement_torch.config import Config
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models import dccrn as port_dccrn
from speech_enhancement_torch.models import sepformer as port_sep
from speech_enhancement_torch.train.solver import compute_loss, get_optimizer, train_step

from test_torch_sepformer import OPTIM as SEP_OPTIM
from test_torch_sepformer import SAMPLES, SMALL as SEP_SMALL, _mixture
from test_torch_sepformer import _assert_leaves_close as _sep_leaves_close
from test_torch_sepformer import _params as _sep_params
from test_torch_train_step import OPTIM, _assert_leaves_close, _perturb, zero_grad_bias

SMALL = dict(kernel_num=(8, 16), rnn_layers=1, rnn_units=16)
N_BLOCKS = len(SMALL["kernel_num"])
POLICIES = ["", "conv_out", "cbn_stats", "conv_out,cbn_stats"]
STATS = (".RMr", ".RMi", ".RVrr", ".RVri", ".RVii")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _dccrn_variables():
    init = jax.jit(jax_dccrn.DCCRN(**SMALL).init)
    variables = init(jax.random.PRNGKey(0), jnp.zeros((2, 1, 4000), jnp.float32))
    return {k: _perturb(v, np.random.default_rng(23)) for k, v in variables.items()}


def _dccrn_batch():
    rng = np.random.default_rng(24)
    mixture = (0.5 * rng.standard_normal((2, 1, 4000))).astype(np.float32)
    target = (0.5 * rng.standard_normal((2, 1, 4000))).astype(np.float32)
    return mixture, target


@functools.lru_cache(maxsize=None)
def _jax_dccrn_step(fold: bool, policy: str):
    """JAX's variant: one MSE train step, jitted; returns the train()
    output, the loss, the grad norm, the clipped gradients, the updated
    parameters and the updated statistics."""
    model = jax_dccrn.DCCRN(cbn_fold=fold, remat=True, remat_policy=policy,
                            use_pallas_stft=False, use_pallas_mask=False, **SMALL)
    optimizer = jax_solver.get_optimizer(JaxConfig(OPTIM))
    mse = jax_losses.get_loss_function("mse")
    variables = _dccrn_variables()
    params, stats = variables["params"], variables["batch_stats"]
    mixture, target = _dccrn_batch()

    @jax.jit
    def step(params, stats, mixture, target):
        def loss_of(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats}, mixture,
                                       train=True, mutable=["batch_stats"])
            return mse(out, target), (out, mutated["batch_stats"])

        (loss, (out, new_stats)), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        clipped, _ = optax.clip_by_global_norm(OPTIM["clip_grad"]).update(grads, None)
        return (out, loss, optax.global_norm(grads), clipped, optax.apply_updates(params, updates),
                new_stats)

    return jax.tree_util.tree_map(np.asarray, step(params, stats, mixture, target))


def _port_dccrn_step(**options):
    """The port's train_step, unrolled to keep the train() output."""
    variables = _dccrn_variables()
    model = port_dccrn.DCCRN(**SMALL, **options)
    model.load_state_dict(dccrn_state_from_jax(variables["params"], variables["batch_stats"]))
    opt = get_optimizer(Config(OPTIM), model.parameters())
    mixture, target = (torch.from_numpy(a) for a in _dccrn_batch())
    model.train()
    opt.zero_grad()
    out = model(mixture)
    loss = compute_loss("mse", out, target, mixture)
    loss.backward()
    norm = opt.step()  # clips the gradients in place
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out.detach(), loss.item(), norm.item(), grads, model.state_dict()


@functools.lru_cache(maxsize=None)
def _port_no_remat(fold: bool):
    return _port_dccrn_step(cbn_fold=fold)


@pytest.mark.parametrize("policy", POLICIES, ids=["empty", "conv_out", "cbn_stats", "both"])
@pytest.mark.parametrize("fold", [False, True], ids=["centred", "cbn_fold"])
def test_dccrn_remat_policy_matches_jax(fold, policy):
    out_j, loss_j, norm_j, grads_j, params_j, stats_j = _jax_dccrn_step(fold, policy)
    out, loss, norm, grads, state = _port_dccrn_step(cbn_fold=fold, remat=True,
                                                     remat_policy=policy)
    np.testing.assert_allclose(out.numpy(), out_j, atol=3e-5)
    np.testing.assert_allclose(loss, float(loss_j), rtol=2e-3)
    np.testing.assert_allclose(norm, float(norm_j), rtol=2e-3)
    want = dccrn_state_from_jax(grads_j, stats_j)
    _assert_leaves_close(grads, {k: want[k] for k in grads}, N_BLOCKS)
    # parameters after one Adam step: 2 lr more (an element whose gradient
    # is within rounding of zero may move either way); statistics at 2e-5
    want = dccrn_state_from_jax(params_j, stats_j)
    params = {k: v for k, v in state.items() if not k.endswith(STATS)}
    _assert_leaves_close(params, {k: want[k] for k in params}, N_BLOCKS, extra=2 * OPTIM["lr"])
    no_remat = _port_no_remat(fold)[4]
    stat_keys = [k for k in state if k.endswith(STATS)]
    assert len(stat_keys) == 5 * (2 * N_BLOCKS - 1)
    for key in stat_keys:
        np.testing.assert_allclose(state[key].numpy(), want[key].numpy(), atol=2e-5,
                                   err_msg=key)
        np.testing.assert_allclose(state[key].numpy(), no_remat[key].numpy(), atol=2e-5,
                                   err_msg=key)


@pytest.mark.parametrize("policy", ["conv_out,cbn_stats", "attn_out"])
def test_dccrn_remat_gives_remat_off_step(policy):
    """Every policy, and a name the model does not tag (``attn_out`` is
    Sepformer's), gives remat-off's step: output, gradients and running
    statistics to 1e-6 of their scale. The conv biases that complex BN
    follows have a true gradient of zero: their rounding residue is compared
    at the global scale, and Adam may move them by lr either way."""
    out_a, loss_a, norm_a, grads_a, state_a = _port_no_remat(False)
    out_b, loss_b, norm_b, grads_b, state_b = _port_dccrn_step(remat=True, remat_policy=policy)
    torch.testing.assert_close(out_b, out_a, rtol=0, atol=1e-6)
    np.testing.assert_allclose([loss_b, norm_b], [loss_a, norm_a], rtol=1e-6)
    for what_a, what_b, extra in ((grads_a, grads_b, 0.0),
                                  (state_a, state_b, 2 * OPTIM["lr"])):
        scale = max(v.abs().max().item() for v in what_a.values())
        for key, value in what_a.items():
            leaf, bias = value.abs().max().item(), zero_grad_bias(key, N_BLOCKS)
            torch.testing.assert_close(what_b[key], value, rtol=1e-6, msg=key, atol=(
                1e-6 * (scale if bias else leaf + 1e-12) + (extra if bias else 0.0)))


def test_dccrn_remat_recomputes_by_policy():
    """What the recompute runs: no conv with ``conv_out`` saved, no moment
    reduction with ``cbn_stats`` saved (aten ops dispatched in backward);
    remat off recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    mixture = torch.from_numpy(_dccrn_batch()[0])[:, 0]
    seen = {}
    for policy in (None, "", "conv_out", "cbn_stats", "conv_out,cbn_stats"):
        options = {} if policy is None else {"remat": True, "remat_policy": policy}
        model = port_dccrn.DCCRN(**SMALL, **options).train()
        loss = (model(mixture) ** 2).mean()
        with Count() as count:
            loss.backward()
        seen[policy] = (count.ops.get("aten.convolution", 0), count.ops.get("aten.mean", 0))
    # three blocks with complex BN (the last decoder block has none, and its
    # conv output feeds no saved tensor of its region)
    assert seen == {None: (0, 0), "": (3, 15), "conv_out": (0, 15), "cbn_stats": (3, 0),
                    "conv_out,cbn_stats": (0, 0)}


def test_build_model_keeps_dccrn_remat():
    cfg = Config({"name": "dccrn", "remat": True, "remat_policy": "conv_out,cbn_stats",
                  **SMALL})
    model, _ = build_model(cfg, device="cpu")
    assert model.remat_names == frozenset({"conv_out", "cbn_stats"})
    model, _ = build_model(Config({"name": "dccrn", **SMALL}), device="cpu")
    assert model.remat_names is None


# -- Sepformer attn_out ----------------------------------------------------------

def _sep_batch():
    mixture = _mixture(64)
    sources = (0.5 * np.random.default_rng(65).standard_normal((2, 2, 2, SAMPLES))
               ).astype(np.float32)
    return mixture, sources


@functools.lru_cache(maxsize=None)
def _jax_sep_grads(policy: str):
    model = jax_sep.Sepformer(fused_attention="force", remat=True, remat_policy=policy,
                              **SEP_SMALL)
    solver = types.SimpleNamespace(use_pit=True, loss_name="si-sdr", pit_discard_compat=False,
                                   loss_fn=jax_losses.get_loss_function("si-sdr"))

    @jax.jit
    def grads_of(params, mixture, sources):
        def loss_of(p):
            out = model.apply({"params": p}, mixture, train=True)
            return jax_solver.Solver._compute_loss(solver, out, sources, mixture)

        return jax.value_and_grad(loss_of)(params)

    loss, grads = grads_of(_sep_params(), *_sep_batch())
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_sep_step(**options):
    model = port_sep.Sepformer(fused_attention=True, **SEP_SMALL, **options)
    model.load_state_dict(sepformer_state_from_jax(_sep_params()))
    opt = get_optimizer(Config(SEP_OPTIM), model.parameters())
    loss, norm = train_step(model, model.SPEC, opt, *_sep_batch(), "si-sdr", use_pit=True,
                            device="cpu")
    return loss.item(), norm.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_sepformer_attn_out_matches_jax():
    """Loss within 2e-3 and every (clipped) gradient within 2e-3 of its
    leaf's scale of JAX's ``remat_policy="attn_out"`` gradients."""
    want_loss, want_grads = _jax_sep_grads("attn_out")
    loss, norm, grads = _port_sep_step(remat=True, remat_policy="attn_out")
    np.testing.assert_allclose(loss, want_loss, rtol=2e-3)
    np.testing.assert_allclose(norm, float(optax.global_norm(want_grads)), rtol=2e-3)
    clipped, _ = optax.clip_by_global_norm(SEP_OPTIM["clip_grad"]).update(want_grads, None)
    _sep_leaves_close(grads, sepformer_state_from_jax(clipped))


@pytest.mark.parametrize("policy", ["attn_out", "conv_out"])
def test_sepformer_remat_policy_gives_remat_off_step(policy):
    """``attn_out``, and a name Sepformer does not tag (``conv_out`` is
    DCCRN's), give remat-off's loss and gradients to 1e-6."""
    loss_a, norm_a, grads_a = _port_sep_step()
    loss_b, norm_b, grads_b = _port_sep_step(remat=True, remat_policy=policy)
    np.testing.assert_allclose([loss_b, norm_b], [loss_a, norm_a], rtol=1e-6)
    for key, grad in grads_a.items():
        torch.testing.assert_close(grads_b[key], grad, rtol=1e-6, atol=1e-6 * (
            grad.abs().max().item() + 1e-12), msg=key)


def test_sepformer_attn_out_runs_the_attention_once():
    """Attention calls a train step (the wrapper, counted on the CPU): remat
    off and ``attn_out`` one a layer, ``""`` two (the recompute)."""
    calls = []
    real = port_sep.fused_mha_packed

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    seen = {}
    port_sep.fused_mha_packed = counting
    try:
        for options in ({}, {"remat": True}, {"remat": True, "remat_policy": "attn_out"}):
            calls.clear()
            _port_sep_step(**options)
            seen[options.get("remat_policy", "off" if not options else "")] = len(calls)
    finally:
        port_sep.fused_mha_packed = real
    assert seen == {"off": 2, "": 4, "attn_out": 2}
