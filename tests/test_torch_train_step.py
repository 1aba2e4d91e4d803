"""The port's train step vs the JAX package's, on the CPU.

``get_optimizer`` against the optax chain of the JAX ``get_optimizer``;
the mask-E and STFT autograd Functions against ``jax.vjp`` of the JAX
functions; two full train steps of the small DCCRN of
tests/test_dccrn_fused.py, unfused and with ``use_fused_blocks``, against
the JAX step (``use_fused_blocks=False`` / ``"force"``, interpret mode) with
the same weights (crossed over by ``dccrn_state_from_jax``) and the same
batch through the int16 wire.
"""

import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.data.loader import encode_wire_int16
from speech_enhancement_tpu.models import dccrn as jax_dccrn
from speech_enhancement_tpu.ops.pallas import masking as jax_masking
from speech_enhancement_tpu.ops.pallas.stft import stft_pallas_diff
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import dccrn_state_from_jax
from speech_enhancement_torch.config import Config
from speech_enhancement_torch.kernels.masking import MaskE
from speech_enhancement_torch.kernels.stft import STFT
from speech_enhancement_torch.models import dccrn as port_dccrn
from speech_enhancement_torch.models.dccrn import _stft_bases
from speech_enhancement_torch.train.solver import decode_wire, get_optimizer, train_step

# tests/test_dccrn_fused.py:17-21
SMALL = dict(win_len=128, win_inc=32, fft_len=256, kernel_num=(4, 8, 8, 16, 16, 16),
             rnn_layers=2, rnn_units=16)
OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
OPTIMS = {
    "adam": {"optim": "adam", "lr": 1e-3, "beta1": 0.9, "beta2": 0.999},
    "adamw": {"optim": "adamw", "lr": 1e-3, "beta1": 0.8, "beta2": 0.99},
    "sgd": {"optim": "sgd", "lr": 0.1, "momentum": 0.5},
}


@pytest.mark.parametrize("clip", [0, 0.5])
@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_optimizer_matches_optax_over_two_updates(rng, name, clip):
    cfg = dict(OPTIMS[name], clip_grad=clip)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    opt = jax_solver.get_optimizer(JaxConfig(cfg))
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jax_params)
    leaves = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    port = get_optimizer(Config(cfg), leaves.values())
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state,
                                    jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = port.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for k, p in leaves.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name} {k}")
    assert port.clip == clip and (clip == 0 or norm.item() > clip)  # the clip was taken


def test_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer(Config({"optim": "lamb", "lr": 1.0}), [torch.nn.Parameter(torch.ones(1))])


@pytest.mark.parametrize("zero_mask", [False, True])
def test_mask_e_function_backward_matches_jax_vjp(rng, zero_mask):
    """The backward of the pole-free formula: finite where the mask is 0."""
    arrays = [rng.standard_normal((2, 9, 13)).astype(np.float32) for _ in range(4)]
    if zero_mask:
        arrays[2][0, :3] = 0.0
        arrays[3][0, :3] = 0.0
    cot = [rng.standard_normal((2, 9, 13)).astype(np.float32) for _ in range(2)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.autograd.backward(MaskE.apply(*leaves), [torch.from_numpy(c) for c in cot])
    _, vjp = jax.vjp(jax_masking._mask_e_ref, *map(jnp.asarray, arrays))
    for leaf, want in zip(leaves, vjp(tuple(map(jnp.asarray, cot)))):
        assert torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("total", [16600, 7050])  # 163 frames; a tail no frame covers
def test_stft_function_backward_matches_jax_vjp(rng, total):
    basis = _stft_bases(400, 512)[0]
    x = rng.standard_normal((2, total)).astype(np.float32)
    n_frames = (total - 400) // 100 + 1
    g = rng.standard_normal((2, n_frames, basis.shape[1])).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    STFT.apply(xt, torch.from_numpy(basis), 100, 400).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda s: stft_pallas_diff(s, basis, 100, 400, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    assert xt.grad.shape == x.shape
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_wire_matches_jax(rng):
    batch = (0.3 * rng.standard_normal((2, 1, 500))).astype(np.float32)
    wire = encode_wire_int16(batch)
    got = decode_wire(wire, torch.device("cpu"))
    want = jax_solver.Solver._decode_wire({k: jnp.asarray(v) for k, v in wire.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy() - batch).max() <= np.abs(batch).max() / 32767
    np.testing.assert_array_equal(decode_wire(batch, torch.device("cpu")).numpy(), batch)


def _perturb(tree, rng):
    """The flax tree as numpy, biases, BN statistics and slopes moved off
    their initial values."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _perturb(value, rng)
            continue
        a = np.asarray(value, np.float32)
        if key in ("vrr", "vii"):
            a = rng.uniform(0.5, 1.5, a.shape)
        elif key in ("mean_r", "mean_i", "vri"):
            a = 0.1 * rng.standard_normal(a.shape)
        elif key == "alpha":
            a = rng.uniform(0.1, 0.4, a.shape)
        elif key in ("br", "bi", "bias", "beta_r", "beta_i", "gamma_ri"):
            a = a + 0.05 * rng.standard_normal(a.shape)
        out[key] = np.asarray(a, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """Perturbed init of the small DCCRN (the fused path's tree is the same,
    tests/test_dccrn_fused.py:35-47), jitted: eager flax init takes longer."""
    init = jax.jit(jax_dccrn.DCCRN(**SMALL).init)
    variables = init(jax.random.PRNGKey(0), jnp.zeros((2, 1, 1600), jnp.float32))
    return {k: _perturb(v, np.random.default_rng(22)) for k, v in variables.items()}


@functools.lru_cache(maxsize=None)
def _jax_step(fused: bool):
    """The JAX DCCRN and one jitted train step whose loss is si-sdr or mse
    by a traced flag, so both losses share one compile of each path."""
    model = jax_dccrn.DCCRN(use_fused_blocks="force" if fused else False,
                            use_pallas_stft=False, use_pallas_mask=False, **SMALL)
    optimizer = jax_solver.get_optimizer(JaxConfig(OPTIM))
    mse, sisdr = (jax_losses.get_loss_function(n) for n in ("mse", "si-sdr"))

    @jax.jit
    def step(params, stats, opt_state, use_sisdr, mixture, target):
        def loss_of(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats}, mixture,
                                       train=True, mutable=["batch_stats"])
            loss = jnp.where(use_sisdr, sisdr(out, target), mse(out, target))
            return loss, mutated["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        clipped, _ = optax.clip_by_global_norm(OPTIM["clip_grad"]).update(grads, None)
        return (optax.apply_updates(params, updates), new_stats, opt_state, loss,
                optax.global_norm(grads), clipped)

    return model, optimizer, step


def zero_grad_bias(key: str, n_blocks: int) -> bool:
    """Conv biases followed by complex BN: every block's but the last decoder's."""
    return key.endswith("_conv.bias") and not key.startswith(f"decoder.{n_blocks - 1}.")


def _assert_leaves_close(got, want, n_blocks, extra=0.0, rms_extra=0.0):
    """Each leaf within 2e-3 of its largest magnitude (tests/test_dccrn_fused.py:
    97-113), plus ``extra``; the conv biases that complex BN follows have an
    exactly zero true gradient, so they hold rounding residue only and are
    compared at the global scale; running means get ``rms_extra`` more."""
    assert sorted(got) == sorted(want)
    scale = max(v.abs().max().item() for v in want.values())
    for key, value in want.items():
        err = (got[key] - value).abs().max().item()
        bound = 2e-3 * max(value.abs().max().item(), 1e-8) + extra
        if zero_grad_bias(key, n_blocks):
            bound = 2e-3 * scale + extra
        elif key.endswith((".RMr", ".RMi")):
            bound += rms_extra
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("loss", ["mse", "si-sdr"])
@pytest.mark.parametrize("fused", [False, True])
def test_two_train_steps_match_jax(fused, loss):
    """Loss and grad norm of both steps and every (clipped) gradient of the
    first within 2e-3 of each leaf's scale; then every parameter and running
    statistic after the second. Adam moves an element by up to lr a step
    whatever the size of its gradient, so an element whose gradient is
    within the comparison's rounding of zero may move the other way: the
    parameters get 2 steps x 2 lr more. The batch mean of a block's output
    moves with its conv bias, and so does its running mean: 2 steps x 2 lr
    x (1 - momentum) more."""
    # at amplitude 0.5 the gradients are ~1e-3; at 0.1 (MSE gradients ~1e-5)
    # the JAX fused path's interpret-mode gradients sit up to 5e-7 (absolute)
    # from its own XLA path's, which the port's match to 1e-6 of each leaf
    rng = np.random.default_rng(21)
    mixture = (0.5 * rng.standard_normal((2, 1, 1600))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, 1600))).astype(np.float32)
    wire_m, wire_s = encode_wire_int16(mixture), encode_wire_int16(sources)

    _, optimizer, step = _jax_step(fused)
    variables = _jax_variables()
    decode = jax_solver.Solver._decode_wire
    jax_mix = decode({k: jnp.asarray(v) for k, v in wire_m.items()})
    jax_tgt = decode({k: jnp.asarray(v) for k, v in wire_s.items()})[:, 0]
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = optimizer.init(params)
    n_blocks = len(SMALL["kernel_num"])

    port = port_dccrn.DCCRN(use_fused_blocks=fused, **SMALL)
    port.load_state_dict(dccrn_state_from_jax(params, stats))
    opt = get_optimizer(Config(OPTIM), port.parameters())
    for i in range(2):
        params, stats, opt_state, want_loss, want_norm, grads = step(
            params, stats, opt_state, loss == "si-sdr", jax_mix, jax_tgt)
        got_loss, got_norm = train_step(port, port.SPEC, opt, wire_m, wire_s, loss,
                                        device="cpu")
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-3)
        np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=2e-3)
        if i == 0:  # the gradients' tree, mapped as the parameters' (stats dropped)
            got = {k: p.grad for k, p in port.named_parameters()}
            want = dccrn_state_from_jax(grads, stats)
            _assert_leaves_close(got, {k: want[k] for k in got}, n_blocks)
    assert port.training
    lr = OPTIM["lr"]
    _assert_leaves_close(port.state_dict(), dccrn_state_from_jax(params, stats), n_blocks,
                         extra=2 * 2 * lr, rms_extra=2 * 2 * lr * 0.1)


def test_train_step_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    port = port_dccrn.DCCRN(**SMALL)
    opt = get_optimizer(Config(OPTIMS["sgd"]), port.parameters())
    batch = np.zeros((1, 1, 1600), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_step(port, port.SPEC, opt, batch, batch[:, None])
    with pytest.raises(ValueError, match="model_config"):  # stft_custom needs the transform
        from speech_enhancement_torch.models.types import SignalSpec
        train_step(port, SignalSpec(domain="stft"), opt, batch, batch[:, None], device="cpu")
