"""The port's Sepformer options vs the JAX package's, on the CPU:
``attention_type="RelPosMHAXL"`` (with ``relative_positions`` and
``_rel_shift``), ``intra_block`` / ``inter_block="rnn"`` and ``remat``.

At the small size of tests/test_torch_sepformer.py (d_model 32, chunk 50,
one dual block of 1 + 1 layers, 4 heads, FFN 64; RNN blocks of 16 units
a direction), stereo in and two speakers out. Weights are the JAX model's
initial tree with biases, norms and the PReLU slope moved, carried over by
``sepformer_state_from_jax``; inputs are numpy-made.
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
from speech_enhancement_tpu.models import sepformer as jax_sep
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import sepformer_state_from_jax
from speech_enhancement_torch.compat.jax_weights import _linear
from speech_enhancement_torch.config import Config
from speech_enhancement_torch.models import sepformer as port_sep
from speech_enhancement_torch.train.solver import get_optimizer, train_step

from test_torch_sepformer import OPTIM, SAMPLES, SMALL, _assert_leaves_close, _mixture, _perturb

RELPOS = {"attention_type": "RelPosMHAXL"}
RNN = {"intra_block": "rnn", "inter_block": "rnn", "rnn_hidden": 16}
MIXED = {"inter_block": "rnn", "rnn_hidden": 16, "rnn_bidirectional": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("length", [5, 50])
def test_relative_positions_and_rel_shift_match_jax(length):
    np.testing.assert_array_equal(port_sep.relative_positions(length, 32),
                                  jax_sep.relative_positions(length, 32))
    x = np.random.default_rng(length).standard_normal((2, 3, length, 2 * length - 1))
    x = x.astype(np.float32)
    got = port_sep._rel_shift(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_sep._rel_shift(jnp.asarray(x))))
    assert got.shape == (2, 3, length, length)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relpos_mhaxl_matches_jax(dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 20, 32)).astype(np.float32)
    pos = jax_sep.relative_positions(20, 32)
    mha = jax_sep.RelPosMHAXL(32, 4, dtype=jnp.dtype(dtype))
    params = _perturb(jax.jit(mha.init)(jax.random.PRNGKey(2), jnp.asarray(x),
                                        jnp.asarray(pos))["params"], rng)
    want = np.asarray(mha.apply({"params": params}, jnp.asarray(x), jnp.asarray(pos)),
                      np.float32)
    port = port_sep.RelPosMHAXL(32, 4, getattr(torch, dtype), None)
    sd = {"in_proj_weight": torch.from_numpy(np.array(params["in_proj"]["kernel"]).T.copy()),
          "pos_bias_u": torch.from_numpy(np.array(params["pos_bias_u"])),
          "pos_bias_v": torch.from_numpy(np.array(params["pos_bias_v"]))}
    _linear(sd, "linear_pos", params["linear_pos"])
    _linear(sd, "out_proj", params["out_proj"])
    port.load_state_dict(sd)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":  # the bounds of tests/test_torch_sepformer.py's f32 forward
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    else:  # the smoke's bf16 bound: mean <= 2%, worst <= 20% of the RMS
        err, rms = np.abs(got.float().numpy() - want), np.sqrt(np.mean(want**2))
        assert err.mean() <= 0.02 * rms and err.max() <= 0.2 * rms


@functools.lru_cache(maxsize=None)
def _params(option: str):
    extra = {"relpos": RELPOS, "rnn": RNN, "mixed": MIXED}[option]
    init = jax.jit(jax_sep.Sepformer(fused_attention=False, **SMALL, **extra).init)
    variables = init(jax.random.PRNGKey(0), jnp.zeros((2, 2, SAMPLES), jnp.float32))
    return _perturb(variables["params"], np.random.default_rng(52))


def _pair(option: str):
    extra = {"relpos": RELPOS, "rnn": RNN, "mixed": MIXED}[option]
    jax_model = jax_sep.Sepformer(fused_attention="force", **SMALL, **extra)
    port = port_sep.Sepformer(fused_attention=True, **SMALL, **extra)
    state = sepformer_state_from_jax(_params(option))
    assert sorted(port.state_dict()) == sorted(state)
    port.load_state_dict(state)
    return jax_model, port.eval()


@pytest.mark.parametrize("option", ["relpos", "rnn", "mixed"])
def test_sepformer_option_forward_matches_jax(option):
    """f32 at the bounds of tests/test_pallas.py:252-255 (atol 2e-5, rtol 1e-4)."""
    jax_model, port = _pair(option)
    x = _mixture(5)
    want = np.asarray(jax_model.apply({"params": _params(option)}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, SAMPLES)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_step(option: str):
    """One jitted JAX train step with the Solver's own loss (si-sdr, PIT)."""
    extra = {"relpos": RELPOS, "rnn": RNN, "mixed": MIXED}[option]
    model = jax_sep.Sepformer(fused_attention="force", **SMALL, **extra)
    optimizer = jax_solver.get_optimizer(JaxConfig(OPTIM))
    solver = types.SimpleNamespace(use_pit=True, loss_name="si-sdr", pit_discard_compat=False,
                                   loss_fn=jax_losses.get_loss_function("si-sdr"))

    @jax.jit
    def step(params, opt_state, mixture, sources):
        def loss_of(p):
            out = model.apply({"params": p}, mixture, train=True)
            return jax_solver.Solver._compute_loss(solver, out, sources, mixture)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        clipped, _ = optax.clip_by_global_norm(OPTIM["clip_grad"]).update(grads, None)
        return optax.apply_updates(params, updates), loss, optax.global_norm(grads), clipped

    return optimizer, step


def _batch(seed):
    rng = np.random.default_rng(seed)
    sources = (0.5 * rng.standard_normal((2, 2, 2, SAMPLES))).astype(np.float32)
    mixture = sources.sum(axis=1) + (0.05 * rng.standard_normal((2, 2, SAMPLES))).astype(
        np.float32)
    return mixture, sources


@pytest.mark.parametrize("option", ["relpos", "rnn"])
def test_sepformer_option_pit_train_step_matches_jax(option):
    """One si-sdr PIT step: loss and grad norm within 2e-3, every (clipped)
    gradient and updated parameter within 2e-3 of its leaf's scale (the
    parameters plus 2 lr, Adam's largest move), as the regularMHA test."""
    mixture, sources = _batch(62)
    optimizer, step = _jax_step(option)
    params = _params(option)
    new_params, want_loss, want_norm, grads = step(
        params, optimizer.init(params), jnp.asarray(mixture), jnp.asarray(sources))
    _, port = _pair(option)
    opt = get_optimizer(Config(OPTIM), port.parameters())
    loss, norm = train_step(port, port.SPEC, opt, mixture, sources, "si-sdr", use_pit=True,
                            device="cpu")
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=2e-3)
    _assert_leaves_close({k: p.grad for k, p in port.named_parameters()},
                         sepformer_state_from_jax(grads))
    _assert_leaves_close(port.state_dict(), sepformer_state_from_jax(new_params),
                         extra=2 * OPTIM["lr"])


@pytest.mark.parametrize("extra", [{}, RELPOS], ids=["regularMHA", "RelPosMHAXL"])
def test_remat_gives_the_same_step(extra):
    """remat=True recomputes each layer in the backward pass (through the
    attention Function's plain version here): the same loss and gradients
    as remat=False, to 1e-6."""
    mixture, sources = _batch(63)
    results = []
    for remat in (False, True):
        model = port_sep.Sepformer(fused_attention=True, remat=remat, **SMALL, **extra,
                                   generator=torch.Generator().manual_seed(4))
        opt = get_optimizer(Config(OPTIM), model.parameters())
        loss, norm = train_step(model, model.SPEC, opt, mixture, sources, "si-sdr",
                                use_pit=True, device="cpu")
        results.append((loss.item(), norm.item(),
                        {k: p.grad.clone() for k, p in model.named_parameters()}))
    (loss_a, norm_a, grads_a), (loss_b, norm_b, grads_b) = results
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-6)
    np.testing.assert_allclose(norm_b, norm_a, rtol=1e-6)
    for key, grad in grads_a.items():
        torch.testing.assert_close(grads_b[key], grad, rtol=1e-6, atol=1e-6 * (
            grad.abs().max().item() + 1e-12), msg=key)


def test_remat_policy_has_no_torch_counterpart():
    """JAX's named saves have their counterpart: ``remat_policy="attn_out"``
    keeps each layer's attention output and gives remat off's train step
    (loss, grad norm, gradients to 1e-6); a name the model does not tag
    saves nothing, so it gives exactly the values of ``""``."""
    mixture, sources = _batch(64)
    results = {}
    for key, options in (("off", {}), ("attn_out", {"remat": True, "remat_policy": "attn_out"}),
                         ("", {"remat": True, "remat_policy": ""}),
                         ("untagged", {"remat": True, "remat_policy": "conv_out"})):
        model = port_sep.Sepformer(fused_attention=True, **SMALL, **options,
                                   generator=torch.Generator().manual_seed(4))
        opt = get_optimizer(Config(OPTIM), model.parameters())
        loss, norm = train_step(model, model.SPEC, opt, mixture, sources, "si-sdr",
                                use_pit=True, device="cpu")
        results[key] = (loss.item(), norm.item(),
                        {k: p.grad.clone() for k, p in model.named_parameters()})
    loss_a, norm_a, grads_a = results["off"]
    loss_b, norm_b, grads_b = results["attn_out"]
    np.testing.assert_allclose([loss_b, norm_b], [loss_a, norm_a], rtol=1e-6)
    for key, grad in grads_a.items():
        torch.testing.assert_close(grads_b[key], grad, rtol=1e-6, atol=1e-6 * (
            grad.abs().max().item() + 1e-12), msg=key)
    assert results["untagged"][:2] == results[""][:2]
    for key, grad in results[""][2].items():
        assert torch.equal(results["untagged"][2][key], grad), key
