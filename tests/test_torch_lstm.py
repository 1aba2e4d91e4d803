"""The port's LSTM recurrence vs the JAX package's, on the CPU.

``kernels/lstm.py:fused_lstm`` (its autograd Function; on CPU tensors the
wrappers run the kernels' plain versions) against the JAX ``fused_lstm``
in interpret mode: outputs and the gradients of all four inputs, in both
directions, with and without an initial state, in f32 and bf16. Then
``ops/rnn.py``'s ``LSTMLayer`` (plain loop and ``fused``) and the
bidirectional ``RNNStack`` against their JAX counterparts with the same
weights. Inputs are numpy-made.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops import rnn as jax_rnn
from speech_enhancement_tpu.ops.pallas import lstm as jax_lstm
from speech_enhancement_torch.kernels import lstm as port_lstm
from speech_enhancement_torch.ops import rnn as port_rnn

T, B, H = 9, 3, 32

# tests/test_pallas_lstm.py's bounds in f32 (forward 1e-5, gradients 2e-4)
# and bf16 (3e-2)
TOL = {"float32": (1e-5, 2e-4), "bfloat16": (3e-2, 3e-2)}


def _inputs(seed: int, with_state: bool):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    if with_state:
        h0, c0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32), (
            0.5 * rng.standard_normal((B, H))).astype(np.float32)
    else:
        h0 = c0 = np.zeros((B, H), np.float32)
    return x_proj, w_hh, h0, c0


def _loss_jax(reverse):
    def fn(x_proj, w_hh, h0, c0):
        out, h_last, c_last = jax_lstm.fused_lstm(x_proj, w_hh, h0, c0, reverse, True)
        # tests/test_pallas_lstm.py:48-55: every cotangent path, incl. the edges
        return (jnp.sum(jnp.sin(out.astype(jnp.float32)))
                + jnp.sum(jnp.cos(h_last.astype(jnp.float32)))
                + jnp.sum(jnp.tanh(c_last.astype(jnp.float32))))
    return fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstm_matches_jax_kernel(reverse, with_state, dtype):
    arrays = _inputs(3, with_state)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fwd_tol, grad_tol = TOL[dtype]
    j_in = [jnp.asarray(a).astype(jdt) for a in arrays]
    want_out = jax_lstm.fused_lstm(*j_in, reverse, True)
    want_grads = jax.grad(_loss_jax(reverse), argnums=(0, 1, 2, 3))(*j_in)

    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrays]
    got_out = port_lstm.fused_lstm(*leaves, reverse)
    for got, want in zip(got_out, want_out):
        assert got.dtype == tdt and got.shape == want.shape
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=fwd_tol, atol=fwd_tol)
    out, h_last, c_last = got_out
    loss = (torch.sin(out.float()).sum() + torch.cos(h_last.float()).sum()
            + torch.tanh(c_last.float()).sum())
    loss.backward()
    for name, leaf, want in zip(("x_proj", "w_hh", "h0", "c0"), leaves, want_grads):
        assert leaf.grad.dtype == tdt, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=grad_tol, atol=grad_tol, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_versions_match_jax_calls(reverse):
    """The two kernels' plain versions against the JAX kernel calls
    themselves (interpret mode), including the stored gates and c."""
    x_proj, w_hh, h0, c0 = _inputs(4, True)
    want = jax_lstm._lstm_fwd_call(*map(jnp.asarray, (x_proj, w_hh, h0, c0)), reverse, True)
    got = port_lstm.fused_lstm_plain(*map(torch.from_numpy, (x_proj, w_hh, h0, c0)), reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    h_seq, c_seq, gates = (np.asarray(a) for a in want)
    rng = np.random.default_rng(5)
    dout = rng.standard_normal((T, B, H)).astype(np.float32)
    dh_t, dc_t = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    c_prev = np.asarray(jax_lstm._shift_prev(jnp.asarray(c_seq), jnp.asarray(c0), reverse))
    want = jax_lstm._lstm_bwd_call(*map(jnp.asarray, (gates, c_seq, c_prev, dout, w_hh.T, dh_t,
                                                      dc_t)), reverse, True)
    got = port_lstm.lstm_bwd_plain(*map(torch.from_numpy, (gates, c_seq, c_prev, dout, w_hh,
                                                           dh_t, dc_t)), reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _layer_pair(rng, reverse, fused, dtype=None, hidden=128, in_dim=16):
    """A JAX LSTMLayer (fused "force" or scan) and the port's with the same weights."""
    jax_layer = jax_rnn.LSTMLayer(hidden, reverse=reverse, fused="force" if fused else False,
                                  dtype=dtype and jnp.dtype(dtype))
    x = rng.standard_normal((B, T, in_dim)).astype(np.float32)
    params = jax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = port_rnn.LSTMLayer(in_dim, hidden, dtype=dtype and getattr(torch, dtype),
                              reverse=reverse, fused=fused)
    port.load_state_dict({"weight_ih_l0": torch.from_numpy(np.asarray(params["w_ih"]).T.copy()),
                          "weight_hh_l0": torch.from_numpy(np.asarray(params["w_hh"]).T.copy()),
                          "bias_ih_l0": torch.from_numpy(np.asarray(params["b_ih"]).copy()),
                          "bias_hh_l0": torch.from_numpy(np.asarray(params["b_hh"]).copy())})
    return jax_layer, {"params": params}, port, x


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax(rng, reverse, fused, with_state):
    jax_layer, variables, port, x = _layer_pair(rng, reverse, fused)
    state = None
    if with_state:
        state = tuple((0.1 * rng.standard_normal((B, 128))).astype(np.float32) for _ in range(2))
    want, want_state = jax_layer.apply(variables, jnp.asarray(x),
                                       None if state is None else tuple(map(jnp.asarray, state)))
    got, got_state = port(torch.from_numpy(x),
                          None if state is None else tuple(map(torch.from_numpy, state)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_lstm_layer_bf16_close_to_jax(rng, fused):
    """bf16 compute: each path against its JAX twin within bf16 noise (the
    two paths round in other places, as in JAX)."""
    jax_layer, variables, port, x = _layer_pair(rng, False, fused, dtype="bfloat16")
    want, _ = jax_layer.apply(variables, jnp.asarray(x))
    got, _ = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_rnnstack_bidirectional_matches_jax(rng, fused, use_bias):
    stack = jax_rnn.RNNStack("lstm", 128, num_layers=2, bidirectional=True, use_bias=use_bias,
                             fused="force" if fused else False)
    x = rng.standard_normal((B, T, 24)).astype(np.float32)
    params = stack.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    port = port_rnn.RNNStack("lstm", 24, 128, num_layers=2, bidirectional=True,
                             use_bias=use_bias, fused=fused)
    sd = {}
    for k in range(2):
        for jax_name, suffix in ((f"l{k}_fwd", ""), (f"l{k}_bwd", "_reverse")):
            layer = {key: np.asarray(v) for key, v in params[jax_name].items()}
            sd[f"weight_ih_l{k}{suffix}"] = torch.from_numpy(layer["w_ih"].T.copy())
            sd[f"weight_hh_l{k}{suffix}"] = torch.from_numpy(layer["w_hh"].T.copy())
            if use_bias:
                sd[f"bias_ih_l{k}{suffix}"] = torch.from_numpy(layer["b_ih"].copy())
                sd[f"bias_hh_l{k}{suffix}"] = torch.from_numpy(layer["b_hh"].copy())
    port.load_state_dict(sd)
    want = stack.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (B, T, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rnnstack_refuses_what_is_not_ported():
    """Every JAX type and the dropout are ported now: only what JAX refuses
    too is refused (an unknown type, a rate outside [0, 1))."""
    with pytest.raises(ValueError, match="rnn_type"):
        port_rnn.RNNStack("qrnn", 8, 8)
    with pytest.raises(ValueError, match="dropout"):
        port_rnn.RNNStack("lstm", 8, 8, num_layers=2, dropout=1.0)
    for kind in ("gru", "rnn"):
        assert port_rnn.RNNStack(kind, 8, 8)(torch.zeros(1, 3, 8)).shape == (1, 3, 8)
    stack = port_rnn.RNNStack("lstm", 8, 8, num_layers=2, dropout=0.5)
    stack.eval()(torch.zeros(1, 3, 8))  # dropout is off in eval()
    assert stack.train()(torch.zeros(1, 3, 8)).shape == (1, 3, 8)


def test_wrappers_reject_bad_shapes_and_devices():
    x_proj, w_hh, h0, c0 = map(torch.from_numpy, _inputs(6, False))
    with pytest.raises(ValueError):
        port_lstm.lstm_fwd(x_proj, w_hh[:, :-4], h0, c0)
    with pytest.raises(ValueError):
        port_lstm.lstm_fwd(x_proj[:0], w_hh, h0, c0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_lstm.lstm_fwd(*(t.to("meta") for t in (x_proj, w_hh, h0, c0)))
    h_seq, c_seq, gates = port_lstm.lstm_fwd(x_proj, w_hh, h0, c0)
    with pytest.raises(ValueError):
        port_lstm.lstm_bwd(gates, c_seq, c_seq, h_seq[:, :1], w_hh, h0, c0)
