"""The port's Demucs vs the JAX package's, on the CPU (tests/zoo_parity.py's
checks), stereo with two speakers at 8 channels, depth 3, GroupNorm from layer 1,
LocalState and the DConv BLSTMs in layer 2 (T 61 there for 2000 samples); l1 with PIT in the train steps, with ``remat``. Besides:
``center_trim``, ``LocalState``, the framed BLSTM (T > ``max_steps``), the
BLSTM with ``fused_rnn=True`` (the recurrence kernels' plain versions on
the CPU) against the JAX ``fused="force"`` Pallas kernel in interpret mode,
and the weight rescale against ``post_init_params`` on the same weights."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_torch.compat import demucs_state_from_jax
from speech_enhancement_torch.compat.jax_weights import _conv_k, _rnn_stack
from speech_enhancement_torch.kernels import lstm as lstm_k
from speech_enhancement_torch.models import demucs as port_demucs
from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.models import demucs as jax_demucs
from zoo_parity import (Family, check_evaluate, check_eval, check_round_trip,
                        check_train_forward, check_two_train_steps, perturb)

SMALL = dict(sources=("target", "interferer"), audio_channels=2, channels=8, depth=3,
             norm_starts=1, norm_groups=2, dconv_attn=2, dconv_lstm=2)
FAMILY = Family(
    name="demucs", jax_cls=jax_demucs.Demucs, port_cls=port_demucs.Demucs, kwargs=SMALL,
    to_port=lambda params, stats: demucs_state_from_jax(params), domain="wav", channels=2,
    samples=2000, loss="l1", pit=True, n_src=2, seed=17,
    # a key's bias shifts every score of a query alike, which the softmax
    # over keys cancels: its true gradient is zero
    zero_grad=lambda key: key.endswith(".key.bias"))
IMPORTER = functools.partial(jax_compat.demucs_from_torch_state, depth=3, norm_starts=1,
                             dconv_attn=2, dconv_lstm=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_demucs_weights_round_trip_through_the_jax_importer():
    check_round_trip(FAMILY, IMPORTER)


def test_demucs_options_round_trip_and_match_jax():
    """Both DConvs, the bottleneck BLSTM, ReLU gates, no normalisation and no
    resampling, at depth 2."""
    fam = FAMILY.variant(dconv_mode=3, lstm_layers=1, depth=2, dconv_attn=1, dconv_lstm=1,
                         normalize=False, resample=False, glu=False)
    check_round_trip(fam, functools.partial(IMPORTER, depth=2, dconv_mode=3, lstm_layers=1,
                                            dconv_attn=1, dconv_lstm=1))
    check_eval(fam, np.random.default_rng(2))


def test_demucs_bottleneck_blstm_fused_matches_jax(monkeypatch):
    """The bottleneck BLSTM of two layers with ``fused_rnn`` (on the card at
    configs/demucs_clarity.yaml's widths, 2048 units, the wide design), at
    a bottleneck of 128 (channels 32, depth 3: a lane multiple, so the JAX
    ``fused_rnn="force"`` takes its Pallas kernel, in interpret mode):
    the port's plain versions of the kernels against it, the bottleneck's
    four recurrences through ``fused_lstm``."""
    fam = FAMILY.variant(channels=32, lstm_layers=2, fused_rnn=True)
    fam = dataclasses.replace(fam, jax_factory=lambda **kw: jax_demucs.Demucs(
        **{**kw, "fused_rnn": "force"}))
    check_round_trip(fam, functools.partial(IMPORTER, lstm_layers=2))
    calls = []
    plain = lstm_k.fused_lstm_plain

    def spy(x_proj, *args, **kw):
        calls.append(x_proj.shape[-1])
        return plain(x_proj, *args, **kw)

    monkeypatch.setattr(lstm_k, "fused_lstm_plain", spy)
    check_eval(fam, np.random.default_rng(3))
    assert calls.count(4 * 128) == 4  # two layers x two directions at the bottleneck


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demucs_eval_matches_jax(rng, dtype):
    check_eval(FAMILY, rng, dtype=dtype)


def test_demucs_train_forward_matches_jax(rng):
    check_train_forward(FAMILY, rng)


def test_demucs_two_pit_train_steps_with_remat_match_jax():
    check_two_train_steps(FAMILY.variant(remat=True))


def test_demucs_evaluate_utterance_matches_jax(rng):
    check_evaluate(FAMILY, rng, window=2000)


def test_demucs_rescale_matches_post_init_params():
    """The port's in-place rescale on the same weights as the JAX
    ``post_init_params`` (convs only; Linears, LSTMs, norms untouched)."""
    params = FAMILY.variables["params"]
    want = demucs_state_from_jax(jax_demucs.Demucs(**SMALL).post_init_params(
        jax.tree_util.tree_map(jnp.asarray, params)))
    _, port = FAMILY.pair()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.post_init_params()
    got = port.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    assert not torch.equal(got["encoder.0.0.weight"], before["encoder.0.0.weight"])
    assert torch.equal(got["encoder.2.3.layers.0.3.linear.weight"],
                       before["encoder.2.3.layers.0.3.linear.weight"])


def test_center_trim():
    x = torch.arange(10.0).reshape(1, 10)
    assert port_demucs.center_trim(x, 10) is x
    torch.testing.assert_close(port_demucs.center_trim(x, 7), x[:, 1:8])
    torch.testing.assert_close(port_demucs.center_trim(x.t(), 6, dim=0), x.t()[2:8])
    want = np.asarray(jax_demucs.center_trim(jnp.arange(10.0).reshape(1, 10), 7, axis=1))
    np.testing.assert_array_equal(port_demucs.center_trim(x, 7).numpy(), want)
    with pytest.raises(ValueError, match="shorter"):
        port_demucs.center_trim(x, 11)


def _flax_params(module, x, seed):
    init = jax.jit(module.init)(jax.random.PRNGKey(seed), x)["params"]
    return perturb(init, np.random.default_rng(seed))


def test_local_state_matches_jax():
    """-100 on the diagonal, the softmax over keys, the decay term."""
    x = np.random.default_rng(7).standard_normal((2, 50, 8)).astype(np.float32)
    module = jax_demucs.LocalState(8, heads=2, ndecay=4)
    params = _flax_params(module, jnp.asarray(x), 7)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    port = port_demucs.LocalState(8, heads=2, ndecay=4)
    sd = {}
    for name, tree in params.items():
        _conv_k(sd, name, tree)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


def _blstm_pair(dim, steps, max_steps, fused, seed):
    x = (0.5 * np.random.default_rng(seed).standard_normal((2, steps, dim))).astype(np.float32)
    module = jax_demucs.BLSTM(dim, layers=2, max_steps=max_steps, skip=True,
                              fused="force" if fused else False)
    params = _flax_params(module, jnp.asarray(x), seed)
    port = port_demucs.BLSTM(dim, layers=2, max_steps=max_steps, skip=True, fused=fused)
    sd = {}
    _rnn_stack(sd, "lstm", params)
    sd["linear.weight"] = torch.from_numpy(np.ascontiguousarray(params["linear"]["kernel"].T))
    sd["linear.bias"] = torch.from_numpy(params["linear"]["bias"])
    port.load_state_dict(sd)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    return got, want


@pytest.mark.parametrize("steps", [200, 201, 450])
def test_framed_blstm_matches_jax(steps):
    """T above ``max_steps`` 200: half-overlapping windows, stitched."""
    got, want = _blstm_pair(16, steps, 200, False, steps)
    assert got.shape == want.shape == (2, steps, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


def test_fused_blstm_runs_the_kernels_plain_versions_and_matches_jax(monkeypatch):
    """``fused=True`` on CPU tensors goes through ``fused_lstm`` (the
    kernels' plain versions), held against the JAX Pallas LSTM in interpret
    mode (H 128, a lane multiple, so JAX's "force" takes the kernel)."""
    calls = []
    original = lstm_k.fused_lstm_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return original(*args, **kw)

    monkeypatch.setattr(lstm_k, "fused_lstm_plain", counted)
    got, want = _blstm_pair(128, 24, 200, True, 3)
    assert len(calls) == 4  # two layers x two directions
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


def test_solver_rescales_a_fresh_demucs(tmp_path):
    """The Solver applies ``post_init_params`` on a fresh start, as the JAX
    Solver does to its initial params; ``build_model`` does not."""
    from speech_enhancement_torch.config import Config, with_defaults
    from speech_enhancement_torch.models import build_model
    from speech_enhancement_torch.train.solver import Solver

    cfg = with_defaults(Config({
        "optim": {"optim": "adam", "lr": 3e-4, "loss": "l1", "pit": True},
        "model": {"name": "demucs", **SMALL},
        "dset": {"sample_rate": 16000, "audio_channels": 2},
        "solver": {"root": str(tmp_path)}}))
    model, spec = build_model(cfg.model, device="cpu")
    built = {k: v.clone() for k, v in model.state_dict().items()}
    want = port_demucs.Demucs(**SMALL)
    want.load_state_dict(built)
    want.post_init_params()
    Solver(cfg, model, spec, None, None, run_dir=str(tmp_path / "run"), device="cpu")
    for key, value in want.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    assert not torch.equal(model.state_dict()["encoder.0.0.weight"], built["encoder.0.0.weight"])
