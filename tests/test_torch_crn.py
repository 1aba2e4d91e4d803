"""The port's CRN and RNN STFT-mask models vs the JAX package's, on the CPU.

CRN at n_fft 128 (its channels are fixed, so H = 256 is its narrowest
LSTM) on fewer than 130 frames, RNN STFT-mask as a small bidirectional
LSTM stack. Weights are the JAX models' initial trees with the biases and
BatchNorm statistics moved off their initial values, carried over by
``crn_state_from_jax`` / ``rnn_stft_mask_state_from_jax``; inputs are
numpy-made. ``fused_rnn=True`` on CPU tensors runs the recurrence kernels'
plain versions and is held against the JAX ``fused_rnn="force"``
(interpret mode); ``False`` against the JAX scan.
"""

import functools
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.models import crn as jax_crn
from speech_enhancement_tpu.models import stft_rnn as jax_stft_rnn
from speech_enhancement_tpu.models.types import STFT_MONO as JAX_STFT_MONO
from speech_enhancement_tpu.models.types import STFT_MULTI as JAX_STFT_MULTI
from speech_enhancement_tpu.ops.stft import stft_custom as jax_stft_custom
from speech_enhancement_tpu.train import evaluate as jax_eval
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import crn_state_from_jax, rnn_stft_mask_state_from_jax
from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models import crn as port_crn
from speech_enhancement_torch.models import stft_rnn as port_stft_rnn
from speech_enhancement_torch.ops.stft import stft_custom
from speech_enhancement_torch.train import evaluate as port_eval
from speech_enhancement_torch.train.solver import get_optimizer, train_step

STFT = {"n_fft": 128, "hop_length": 32, "win_length": 128, "center": True}
OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
SAMPLES = 3968  # 125 frames at hop 32
MASK = dict(num_spk=2, n_fft=128, rnn_hidden=128, rnn_layer=2, rnn_type="lstm",
            bidirectional=True, drop_out=0.5)


def _perturb(tree, rng):
    """Numpy copy of a flax tree with biases and BN statistics moved."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _perturb(value, rng)
            continue
        a = np.asarray(value, np.float32)
        if key == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif key in ("mean", "bias", "b_ih", "b_hh"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif key == "scale":
            a = rng.uniform(0.8, 1.2, a.shape)
        out[key] = np.asarray(a, np.float32)
    return out


def _spectrum(rng, batch, channels, samples=SAMPLES):
    wav = (0.5 * rng.standard_normal((batch, channels, samples))).astype(np.float32)
    return wav, np.array(jax_stft_custom(jnp.asarray(wav), JaxConfig(STFT)))


@functools.lru_cache(maxsize=None)
def _crn_variables():
    model = jax_crn.CRN()
    init = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 1, 65, SAMPLES // 32 + 1, 2)))
    return {k: _perturb(v, np.random.default_rng(31)) for k, v in init.items()}


def _crn_pair(fused: bool):
    variables = _crn_variables()
    jax_model = jax_crn.CRN(fused_rnn="force" if fused else False)
    port = port_crn.CRN(n_fft=128, fused_rnn=fused)
    port.load_state_dict(crn_state_from_jax(variables["params"], variables["batch_stats"]))
    return jax_model, variables, port.eval()


def test_crn_weights_round_trip_through_the_jax_importer():
    variables = _crn_variables()
    port = port_crn.CRN(n_fft=128)
    port.load_state_dict(crn_state_from_jax(variables["params"], variables["batch_stats"]))
    params, stats = jax_compat.crn_from_torch_state(port.state_dict())
    for want, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf, err_msg=str(path))
    assert port.width == 256


@pytest.mark.parametrize("fused", [False, True])
def test_crn_eval_matches_jax(rng, fused):
    jax_model, variables, port = _crn_pair(fused)
    _, spec = _spectrum(rng, 2, 1)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(spec)))
    with torch.inference_mode():
        got = port(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == spec.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_crn_train_forward_updates_batch_norm_as_flax(rng):
    """train(): batch statistics, and the running ones move as flax's
    (momentum 0.9, biased batch variance, eps 1e-5)."""
    jax_model, variables, port = _crn_pair(False)
    _, spec = _spectrum(rng, 2, 1)
    want, updated = jax_model.apply(variables, jnp.asarray(spec), train=True,
                                    mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(spec))
    # the JAX package's train-mode bounds (tests/test_dccrn_fused.py:58-74):
    # batch statistics summed in another order, through the one-pass variance
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    state = crn_state_from_jax(variables["params"], updated["batch_stats"])
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), state[key].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=key)


@functools.lru_cache(maxsize=None)
def _jax_crn_step(fused: bool):
    model = jax_crn.CRN(fused_rnn="force" if fused else False)
    optimizer = jax_solver.get_optimizer(JaxConfig(OPTIM))
    mse = jax_losses.get_loss_function("mse")

    @jax.jit
    def step(params, stats, opt_state, mixture, sources):
        inputs = jax_stft_custom(mixture, JaxConfig(STFT))  # the Solver's _adapt
        target = jax_stft_custom(sources[:, 0], JaxConfig(STFT))

        def loss_of(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats}, inputs, train=True,
                                       mutable=["batch_stats"])
            return mse(out, target), mutated["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, opt_state, loss,
                optax.global_norm(grads), grads)

    return optimizer, step


def _assert_leaves_close(got, want, extra=0.0):
    """Each leaf within 2e-3 of its largest magnitude (the JAX package's
    fused-gradient bound, tests/test_dccrn_fused.py:97-113), plus ``extra``.
    Every conv bias is followed by BatchNorm, so its true gradient is
    exactly zero and both sides hold rounding residue only: those are
    compared at the global scale."""
    assert sorted(got) == sorted(want)
    scale = max(v.abs().max().item() for v in want.values())
    for key, value in want.items():
        err = (got[key] - value).abs().max().item()
        leaf = scale if key.endswith(".conv.bias") else max(value.abs().max().item(), 1e-8)
        bound = 2e-3 * leaf + extra
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("fused", [False, True])
def test_crn_two_train_steps_match_jax(fused):
    """Loss and grad norm of both steps and every gradient of the first
    within 2e-3 of each leaf's scale, then every parameter and running
    statistic after the second; Adam moves an element by up to lr a step
    whatever its gradient's size, so the parameters get 2 steps x 2 lr more."""
    rng = np.random.default_rng(41)
    mixture = (0.5 * rng.standard_normal((2, 1, SAMPLES))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, SAMPLES))).astype(np.float32)
    optimizer, step = _jax_crn_step(fused)
    variables = _crn_variables()
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = optimizer.init(params)
    _, _, port = _crn_pair(fused)
    opt = get_optimizer(Config(OPTIM), port.parameters())
    for i in range(2):
        params, stats, opt_state, want_loss, want_norm, grads = step(
            params, stats, opt_state, jnp.asarray(mixture), jnp.asarray(sources))
        got_loss, got_norm = train_step(port, port.SPEC, opt, mixture, sources, "mse",
                                        device="cpu", model_config=Config(STFT))
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-3)
        np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=2e-3)
        if i == 0:
            got = {k: p.grad for k, p in port.named_parameters()}
            want = crn_state_from_jax(grads, stats)
            _assert_leaves_close(got, {k: want[k] for k in got})
    assert port.training
    _assert_leaves_close(port.state_dict(), crn_state_from_jax(params, stats),
                         extra=2 * 2 * OPTIM["lr"])


def _eval_configs(name, channels):
    raw = {"model": {"name": name, "segment": 0.25, "sample_rate": 16000, **STFT},
           "dset": {"sample_rate": 16000, "norm": "z-score", "audio_channels": channels}}
    return with_defaults(Config(raw)), jax_with_defaults(JaxConfig(raw))


def test_crn_evaluate_utterance_matches_jax(rng):
    jax_model, variables, port = _crn_pair(True)
    port_cfg, jax_cfg = _eval_configs("crn", 1)
    wav = (0.3 * rng.standard_normal((2, 1, 9000))).astype(np.float32)
    want = jax_eval.evaluate_utterance(wav, jax_model.apply, variables, JAX_STFT_MONO, jax_cfg,
                                       lengths=[9000, 7000])
    got = port_eval.evaluate_utterance(wav, port, port.SPEC, port_cfg, lengths=[9000, 7000],
                                       device="cpu")
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_stft_identity_through_evaluate_matches_jax(rng):
    port_cfg, jax_cfg = _eval_configs("crn", 1)
    wav = (0.3 * rng.standard_normal((1, 1, 6000))).astype(np.float32)
    want = jax_eval.evaluate_utterance(wav, None, None, JAX_STFT_MONO, jax_cfg)
    got = port_eval.evaluate_utterance(wav, None, port_crn.CRN.SPEC,
                                       port_cfg, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, wav, atol=1e-4)  # the transform inverts


@functools.lru_cache(maxsize=None)
def _mask_variables():
    model = jax_stft_rnn.RNNSTFTMask(**MASK)
    init = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 2, 65, 40, 2)))
    return {k: _perturb(v, np.random.default_rng(32)) for k, v in init.items()}


def _mask_pair(fused: bool):
    variables = _mask_variables()
    jax_model = jax_stft_rnn.RNNSTFTMask(**MASK, fused_rnn="force" if fused else False)
    port = port_stft_rnn.RNNSTFTMask(**MASK, fused_rnn=fused)
    port.load_state_dict(rnn_stft_mask_state_from_jax(variables["params"],
                                                      variables["batch_stats"]))
    return jax_model, variables, port.eval()


def test_rnn_stft_mask_weights_round_trip_through_the_jax_importer():
    variables = _mask_variables()
    _, _, port = _mask_pair(False)
    params, stats = jax_compat.rnn_stft_mask_from_torch_state(
        port.state_dict(), rnn_layer=2, rnn_type="lstm", bidirectional=True)
    for want, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("fused", [False, True])
def test_rnn_stft_mask_eval_matches_jax(rng, fused):
    jax_model, variables, port = _mask_pair(fused)
    _, spec = _spectrum(rng, 2, 2, samples=1248)  # 40 frames
    want = np.asarray(jax_model.apply(variables, jnp.asarray(spec)))
    with torch.inference_mode():
        got = port(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == (2, 2) + spec.shape[1:]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_rnn_stft_mask_evaluate_utterance_matches_jax(rng):
    jax_model, variables, port = _mask_pair(True)
    port_cfg, jax_cfg = _eval_configs("rnn-stft-mask", 2)
    wav = (0.3 * rng.standard_normal((1, 2, 7000))).astype(np.float32)
    want = jax_eval.evaluate_utterance(wav, jax_model.apply, variables, JAX_STFT_MULTI, jax_cfg,
                                       num_sources=2)
    got = port_eval.evaluate_utterance(wav, port, port.SPEC, port_cfg, num_sources=2,
                                       device="cpu")
    assert got.shape == want.shape == (1, 2, 2, 7000)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_crn_config_at_f32_routes_through_fused_lstm(rng, monkeypatch):
    """configs/crn_vbd.yaml with ``dtype: float32`` (the class default, the
    reference's own precision) and its ``fused_rnn: true``, cut to n_fft
    128: it builds through ``build_model``, both LSTM layers go through
    ``fused_lstm`` in f32 (the kernels' plain versions on the CPU; on the
    card, at the config's 1792 units, the wide design), and it matches the
    JAX ``fused_rnn="force"`` CRN on the same weights."""
    from speech_enhancement_torch.config import load_config
    from speech_enhancement_torch.kernels import lstm as lstm_k

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs" / "crn_vbd.yaml"))
    assert cfg.model.fused_rnn is True and cfg.model.n_fft == 512
    cfg.model.dtype = "float32"
    for key, value in STFT.items():
        setattr(cfg.model, key, value)
    model, _ = build_model(cfg.model, device="cpu")
    assert model.fused_rnn and model.lstm_layer.dtype == torch.float32 and model.width == 256
    variables = _crn_variables()
    model.load_state_dict(crn_state_from_jax(variables["params"], variables["batch_stats"]))
    calls = []
    plain = lstm_k.fused_lstm_plain

    def spy(x_proj, *args, **kw):
        calls.append((tuple(x_proj.shape), x_proj.dtype))
        return plain(x_proj, *args, **kw)

    monkeypatch.setattr(lstm_k, "fused_lstm_plain", spy)
    _, spec = _spectrum(rng, 2, 1)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(spec)).numpy()
    assert len(calls) == 2 and all(shape[-1] == 4 * 256 and dtype == torch.float32
                                   for shape, dtype in calls)
    want = np.asarray(jax_crn.CRN(fused_rnn="force").apply(variables, jnp.asarray(spec)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_build_model_builds_both_families_on_the_cpu():
    crn, spec = build_model(Config({"name": "crn", **STFT, "dtype": "bfloat16",
                                    "fused_rnn": True}), device="cpu")
    assert spec.domain == "stft" and crn.fused_rnn and crn.lstm_layer.dtype == torch.bfloat16
    mask, spec = build_model(Config({"name": "rnn-stft-mask", **MASK, "fused_rnn": True}),
                             device="cpu")
    assert spec.multi_speaker and mask.rnn.fused and mask.rnn.bidirectional
    with pytest.raises(ValueError, match="True or False"):
        build_model(Config({"name": "crn", "fused_rnn": "force"}), device="cpu")
    compat, _ = build_model(Config({"name": "rnn-stft-mask", **MASK, "rnn_over_batch_compat":
                                    True}), device="cpu")  # ported: builds
    assert compat.rnn_over_batch_compat and not mask.rnn_over_batch_compat
    spec_in = stft_custom(torch.zeros(1, 1, SAMPLES), Config(STFT))
    with torch.inference_mode():
        assert crn(spec_in).shape == spec_in.shape
