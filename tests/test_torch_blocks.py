"""The library blocks no model builds, the port vs the JAX package, on the CPU.

``ops/norms.py``'s ``EMA`` (fixed and trainable) and ``PCEN`` (``spcen``
off and on) over [B, T, C]; ``ops/complex_ops.py``'s ``ComplexConv2d``,
``ComplexConvTranspose2d`` (flax's "SAME", "VALID" and explicit pads),
``ComplexDense``, ``ComplexBatchNormStacked`` (train and eval, its running
statistics, and against the paired ``ComplexBatchNorm``) and
``complex_prelu``. Weights are flax's initial trees with trainable
coefficients moved, carried over by the ``compat`` converters; inputs are
numpy-made. The JAX blocks are channels-last, the port's complex blocks
channels-first: the tests transpose. Outputs and the gradients of a
random cotangent (input and every parameter) within f32 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops import complex_ops as jax_cx
from speech_enhancement_tpu.ops import norms as jax_norms
from speech_enhancement_torch.compat import (complex_bn_stacked_state_from_jax,
                                             complex_conv_state_from_jax,
                                             complex_dense_state_from_jax, ema_state_from_jax,
                                             pcen_state_from_jax)
from speech_enhancement_torch.ops import complex_ops as port_cx
from speech_enhancement_torch.ops import norms as port_norms

NCHW, NHWC = (0, 3, 1, 2), (0, 2, 3, 1)


def _moved(tree, rng, scale=0.1):
    """A numpy copy of a flax tree with every leaf moved by ``scale`` of noise."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def _jax_vjp(fn, params, inputs, cot):
    """(output, d params, d inputs) of sum(fn(params, *inputs) * cot),
    jitted (constants evaluated at trace time: EMA's trainable logit is a
    Python float at apply)."""
    def run(params, inputs, cot):
        with jax.ensure_compile_time_eval():
            out, vjp = jax.vjp(fn, params, *inputs)
            grads = vjp(cot)
        return out, grads[0], grads[1:]

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(params, tuple(inputs), cot))


def _port_vjp(module, fn, inputs, cot):
    """The same for ``fn`` (a call of ``module``) on numpy inputs."""
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(outs, [torch.from_numpy(np.ascontiguousarray(c)) for c in cots])
    grads = {k: p.grad for k, p in module.named_parameters()}
    return out, grads, [leaf.grad for leaf in leaves]


def _close(got, want, rtol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _close_state(got: dict, want: dict, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], rtol, key)


# -- EMA and PCEN -----------------------------------------------------------------

@pytest.mark.parametrize("trainable", [False, True])
def test_ema_matches_jax(trainable):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 5)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    mod = jax_norms.EMA(alpha=0.3, trainable=trainable)
    params = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 5))).get("params", {})
    if trainable:
        params = _moved(params, rng, 0.5)
    out, d_params, (d_x,) = _jax_vjp(lambda p, v: mod.apply({"params": p}, v), params, (x,),
                                     cot)
    port = port_norms.EMA(5, alpha=0.3, trainable=trainable)
    if not trainable:
        assert not list(port.parameters())
    else:
        # the initial logit, taken in f32 as JAX takes it
        init = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 5)))["params"]["alpha_logit"]
        np.testing.assert_array_equal(port.alpha_logit.detach().numpy(), np.asarray(init))
    port.load_state_dict(ema_state_from_jax(params))
    got, grads, (g_x,) = _port_vjp(port, port, (x,), cot)
    _close(got, out, what="output")
    _close(g_x, d_x, what="input gradient")
    _close_state(grads, ema_state_from_jax(d_params))


@pytest.mark.parametrize("spcen", [False, True])
def test_pcen_matches_jax(spcen):
    rng = np.random.default_rng(2)
    x = np.abs(rng.standard_normal((2, 41, 6))).astype(np.float32) + 0.01
    cot = rng.standard_normal(x.shape).astype(np.float32)
    mod = jax_norms.PCEN(spcen=spcen)
    params = _moved(mod.init(jax.random.PRNGKey(0), jnp.ones((1, 1, 6)))["params"], rng, 0.2)
    out, d_params, (d_x,) = _jax_vjp(lambda p, v: mod.apply({"params": p}, v), params, (x,),
                                     cot)
    port = port_norms.PCEN(6, spcen=spcen)
    assert sorted(port.state_dict()) == sorted(pcen_state_from_jax(params))
    port.load_state_dict(pcen_state_from_jax(params))
    got, grads, (g_x,) = _port_vjp(port, port, (x,), cot)
    _close(got, out, what="output")
    _close(g_x, d_x, what="input gradient")
    _close_state(grads, pcen_state_from_jax(d_params))


def test_pcen_floor_and_root_clamp_match_jax():
    """All-zero frames (the smoother at 0: ``log(floor)``), and a root below
    the 1e-3 clamp on a silent channel with delta 1 (else delta ** 1000
    overflows, in JAX as here)."""
    x = np.zeros((1, 9, 3), np.float32)
    x[0, 4:, 1:] = 0.5
    mod = jax_norms.PCEN()
    params = dict(mod.init(jax.random.PRNGKey(0), jnp.ones((1, 1, 3)))["params"])
    params["root"] = np.array([1e-4, 2.0, 1.5], np.float32)
    params["delta"] = np.array([1.0, 2.0, 2.0], np.float32)
    want = np.asarray(jax.jit(mod.apply)({"params": params}, jnp.asarray(x)))
    port = port_norms.PCEN(3)
    port.load_state_dict(pcen_state_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert np.isfinite(want).all()
    _close(got, want)


# -- the complex blocks -------------------------------------------------------------

def _pair(rng, shape):
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(2))


CONVS = [
    ("same", dict(kernel_size=(3, 3)), (8, 8)),
    ("same-stride", dict(kernel_size=(5, 2), strides=(2, 1)), (9, 7)),
    ("valid", dict(kernel_size=(3, 2), padding="VALID"), (8, 6)),
    ("pairs", dict(kernel_size=(5, 2), strides=(2, 1), padding=((2, 2), (1, 0))), (16, 6)),
    ("no-bias", dict(kernel_size=(3, 3), use_bias=False), (6, 5)),
]


@pytest.mark.parametrize("name,kwargs,hw", CONVS, ids=[c[0] for c in CONVS])
def test_complex_conv2d_matches_jax(name, kwargs, hw):
    rng = np.random.default_rng(3)
    x = _pair(rng, (2, *hw, 3))  # NHWC
    mod = jax_cx.ComplexConv2d(4, **kwargs)
    params = _moved(mod.init(jax.random.PRNGKey(1), x)["params"], rng)
    out = mod.apply({"params": params}, x)
    cot = tuple(rng.standard_normal(o.shape).astype(np.float32) for o in out)
    out, d_params, d_x = _jax_vjp(lambda p, a, b: mod.apply({"params": p}, (a, b)), params, x,
                                  cot)
    port = port_cx.ComplexConv2d(3, 4, **kwargs)
    port.load_state_dict(complex_conv_state_from_jax(params))
    got, grads, g_x = _port_vjp(port, lambda a, b: port((a, b)),
                                tuple(a.transpose(NCHW) for a in x),
                                tuple(c.transpose(NCHW) for c in cot))
    for part in range(2):
        _close(got[part].detach().numpy().transpose(NHWC), out[part], what=f"output {part}")
        _close(g_x[part].numpy().transpose(NHWC), d_x[part], what=f"input gradient {part}")
    _close_state(grads, complex_conv_state_from_jax(d_params))


TCONVS = [
    ("valid", dict(kernel_size=(3, 2), strides=(2, 1)), (6, 5)),
    ("same", dict(kernel_size=(4, 3), strides=(2, 2), padding="SAME"), (5, 4)),
    ("pairs", dict(kernel_size=(5, 2), strides=(2, 1), padding=((2, 3), (1, 1))), (7, 5)),
]


@pytest.mark.parametrize("name,kwargs,hw", TCONVS, ids=[c[0] for c in TCONVS])
def test_complex_conv_transpose2d_matches_jax(name, kwargs, hw):
    rng = np.random.default_rng(4)
    x = _pair(rng, (2, *hw, 3))
    mod = jax_cx.ComplexConvTranspose2d(2, **kwargs)
    params = _moved(mod.init(jax.random.PRNGKey(2), x)["params"], rng)
    out = mod.apply({"params": params}, x)
    cot = tuple(rng.standard_normal(o.shape).astype(np.float32) for o in out)
    out, d_params, d_x = _jax_vjp(lambda p, a, b: mod.apply({"params": p}, (a, b)), params, x,
                                  cot)
    port = port_cx.ComplexConvTranspose2d(3, 2, **kwargs)
    port.load_state_dict(complex_conv_state_from_jax(params, transposed=True))
    got, grads, g_x = _port_vjp(port, lambda a, b: port((a, b)),
                                tuple(a.transpose(NCHW) for a in x),
                                tuple(c.transpose(NCHW) for c in cot))
    for part in range(2):
        _close(got[part].detach().numpy().transpose(NHWC), out[part], what=f"output {part}")
        _close(g_x[part].numpy().transpose(NHWC), d_x[part], what=f"input gradient {part}")
    _close_state(grads, complex_conv_state_from_jax(d_params, transposed=True))


@pytest.mark.parametrize("use_bias", [True, False])
def test_complex_dense_matches_jax(use_bias):
    rng = np.random.default_rng(5)
    x = _pair(rng, (4, 3, 6))
    mod = jax_cx.ComplexDense(5, use_bias=use_bias)
    params = _moved(mod.init(jax.random.PRNGKey(3), x)["params"], rng)
    cot = _pair(rng, (4, 3, 5))
    out, d_params, d_x = _jax_vjp(lambda p, a, b: mod.apply({"params": p}, (a, b)), params, x,
                                  cot)
    port = port_cx.ComplexDense(6, 5, use_bias=use_bias)
    port.load_state_dict(complex_dense_state_from_jax(params))
    got, grads, g_x = _port_vjp(port, lambda a, b: port((a, b)), x, cot)
    for part in range(2):
        _close(got[part], out[part], what=f"output {part}")
        _close(g_x[part], d_x[part], what=f"input gradient {part}")
    _close_state(grads, complex_dense_state_from_jax(d_params))


@functools.lru_cache(maxsize=None)
def _stacked_case():
    """JAX's stacked complex BN on [64, 4, 4, 2C] (C 3) with moved affine
    and statistics: train output, its gradients, the updated statistics,
    and the eval output on them."""
    rng = np.random.default_rng(6)
    xr = (rng.standard_normal((64, 4, 4, 3)) * 2 + 1).astype(np.float32)
    xi = (rng.standard_normal((64, 4, 4, 3)) - 0.5 + 0.3 * xr).astype(np.float32)
    y2 = np.concatenate([xr, xi], axis=-1)
    mod = jax_cx.ComplexBatchNormStacked()
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(y2))
    params = _moved(variables["params"], rng)
    stats = {k: np.asarray(v) + np.float32(0.1) for k, v in variables["batch_stats"].items()}
    cot = rng.standard_normal(y2.shape).astype(np.float32)

    def train(p, x):
        return mod.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])

    out, new_stats = train(params, jnp.asarray(y2))
    _, vjp = jax.vjp(lambda p, x: train(p, x)[0], params, jnp.asarray(y2))
    d_params, d_y = vjp(jnp.asarray(cot))
    new_stats = new_stats["batch_stats"]
    evaluated = mod.apply({"params": params, "batch_stats": new_stats}, jnp.asarray(y2),
                          use_running_average=True)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (y2, cot, params, stats, as_np(out), as_np(d_params), np.asarray(d_y),
            as_np(new_stats), np.asarray(evaluated))


def test_complex_bn_stacked_matches_jax():
    y2, cot, params, stats, out, d_params, d_y, new_stats, evaluated = _stacked_case()
    port = port_cx.ComplexBatchNormStacked(3).train()
    port.load_state_dict(complex_bn_stacked_state_from_jax(params, stats))
    got, grads, (g_y,) = _port_vjp(port, port, (y2.transpose(NCHW),), cot.transpose(NCHW))
    _close(got.detach().numpy().transpose(NHWC), out, what="train output")
    _close(g_y.numpy().transpose(NHWC), d_y, what="input gradient")
    want = complex_bn_stacked_state_from_jax(d_params, new_stats)
    _close_state(grads, {k: want[k] for k in grads})
    for key in ("mean2", "var2", "vri"):
        _close(getattr(port, key), new_stats[key], 2e-6, key)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(y2.transpose(NCHW).copy()))
    _close(got.numpy().transpose(NHWC), evaluated, what="eval output")


def test_complex_bn_stacked_matches_paired():
    """The stacked form against the port's paired ``ComplexBatchNorm`` with
    the same affine and the same starting statistics: the train outputs,
    the updated statistics, then the eval outputs, within 2e-5
    (tests/test_complex_ops.py's bound)."""
    y2, _, params, stats, *_ = _stacked_case()
    x = torch.from_numpy(y2.transpose(NCHW).copy())
    paired = port_cx.ComplexBatchNorm(3)
    paired.load_state_dict({**{k: v for k, v in paired.state_dict().items() if k[0] == "R"},
                            **{k: torch.from_numpy(params[j]) for j, k in (
                                ("gamma_rr", "Wrr"), ("gamma_ri", "Wri"), ("gamma_ii", "Wii"),
                                ("beta_r", "Br"), ("beta_i", "Bi"))}})
    stacked = port_cx.ComplexBatchNormStacked(3)
    stacked.load_state_dict(complex_bn_stacked_state_from_jax(params, {
        "mean2": torch.cat([paired.RMr, paired.RMi]), "var2": torch.cat([paired.RVrr, paired.RVii]),
        "vri": paired.RVri}))
    for mode in ("train", "eval"):
        getattr(stacked, mode)()
        getattr(paired, mode)()
        with torch.no_grad():
            want = torch.cat(paired(x[:, :3], x[:, 3:]), dim=1)
            got = stacked(x)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=mode)
        for got_s, want_s in ((stacked.mean2, torch.cat([paired.RMr, paired.RMi])),
                              (stacked.var2, torch.cat([paired.RVrr, paired.RVii])),
                              (stacked.vri, paired.RVri)):
            torch.testing.assert_close(got_s, want_s, rtol=0, atol=2e-5, msg=mode)


def test_complex_prelu_matches_jax():
    rng = np.random.default_rng(7)
    x = _pair(rng, (3, 5, 4))
    alpha_r, alpha_i = np.float32(0.2), np.float32(0.35)
    want = jax_cx.complex_prelu(tuple(map(jnp.asarray, x)), alpha_r, alpha_i)
    got = port_cx.complex_prelu(tuple(map(torch.from_numpy, x)), torch.tensor(alpha_r),
                                torch.tensor(alpha_i))
    for part in range(2):
        np.testing.assert_array_equal(got[part].numpy(), np.asarray(want[part]))
