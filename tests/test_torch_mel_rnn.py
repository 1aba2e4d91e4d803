"""The port's mel filterbanks, GRU / vanilla-RNN / LSTM stacks and MelRNN vs
the JAX package's, on the CPU.

Layers and stacks at T 9, B 3, H 32; MelRNN at n_fft 128 (65 bins) on 40
frames, H 32 on the scan and H 128 on the fused path (the JAX kernel's
lane rule). Weights are the JAX trees with biases and BatchNorm statistics
moved off their initial values, carried over by ``compat.jax_weights``;
inputs are numpy-made. ``fused_rnn=True`` on CPU tensors runs the LSTM
kernels' plain versions, held against the JAX ``fused_rnn="force"``
(interpret mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.models import mel_rnn as jax_mel_rnn
from speech_enhancement_tpu.models.types import STFT_MONO as JAX_STFT_MONO
from speech_enhancement_tpu.ops import mel as jax_mel
from speech_enhancement_tpu.ops import rnn as jax_rnn
from speech_enhancement_tpu.ops.stft import stft_custom as jax_stft_custom
from speech_enhancement_tpu.train import evaluate as jax_eval
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import jax_weights, mel_rnn_state_from_jax
from speech_enhancement_torch.config import Config, load_config, with_defaults
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models import mel_rnn as port_mel_rnn
from speech_enhancement_torch.ops import mel as port_mel
from speech_enhancement_torch.ops import rnn as port_rnn
from speech_enhancement_torch.train import evaluate as port_eval
from speech_enhancement_torch.train.solver import get_optimizer, train_step

T, B, D, H = 9, 3, 12, 32
STFT = {"n_fft": 128, "hop_length": 32, "win_length": 128, "center": True}
OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
SAMPLES = 1248  # 40 frames at hop 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models on the CPU run on one intra-op thread: as fast alone,
    and not slowed by the other test processes that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moved(tree, rng):
    """Numpy copy of a flax tree with biases and BatchNorm statistics moved."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = _moved(value, rng)
            continue
        a = np.asarray(value, np.float32)
        if key == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif key in ("mean", "bias", "b", "b_ih", "b_hh"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif key == "scale":
            a = rng.uniform(0.8, 1.2, a.shape)
        out[key] = np.asarray(a, np.float32)
    return out


def _stack_state(rnn_params):
    sd = {}
    jax_weights._rnn_stack(sd, "rnn", rnn_params)
    return {k[len("rnn."):]: v for k, v in sd.items()}


def _close(got, want, dtype):
    """f32: rtol 1e-4, atol 1e-5 of the output's scale; bf16: within 5% of
    max(1, scale), tests/test_rnn.py's bf16 bound."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert np.abs(got - want).max() / max(1.0, scale) < 0.05


@pytest.mark.parametrize("n_mels", [16, 40])
def test_filterbanks_equal_jax(n_mels):
    args = (65, n_mels, 16000, 125.0, 8000.0)
    np.testing.assert_allclose(port_mel.mel_filterbank(*args), jax_mel.mel_filterbank(*args),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port_mel.inverse_mel_filterbank(*args),
                               jax_mel.inverse_mel_filterbank(*args), rtol=1e-6, atol=1e-6)
    assert port_mel.mel_filterbank(*args) is port_mel.mel_filterbank(*args)  # cached


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["gru", "rnn"])
def test_gru_and_vanilla_layers_match_jax(rng, kind, reverse):
    jax_cls = jax_rnn.GRULayer if kind == "gru" else jax_rnn.VanillaRNNLayer
    port_cls = port_rnn.GRULayer if kind == "gru" else port_rnn.VanillaRNNLayer
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    layer = jax_cls(H, reverse=reverse)
    params = _moved(layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = layer.apply({"params": params}, jnp.asarray(x))
    port = port_cls(D, H, reverse=reverse)
    sd = {}
    jax_weights._stack_layer(sd, "l0", params)
    port.load_state_dict(sd)
    if kind == "rnn":  # the JAX layer's one bias is the sum of the port's two
        np.testing.assert_array_equal((port.bias_ih_l0 + port.bias_hh_l0).detach().numpy(),
                                      params["b"])
    _close(port(torch.from_numpy(x)), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn"])
def test_rnn_stack_matches_jax(rng, kind, bidirectional, dtype):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    stack = jax_rnn.RNNStack(kind, H, num_layers=2, bidirectional=bidirectional, dtype=jdt)
    params = _moved(stack.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    want = stack.apply({"params": params}, jnp.asarray(x))
    port = port_rnn.RNNStack(kind, D, H, num_layers=2, bidirectional=bidirectional,
                             dtype=None if dtype == "float32" else torch.bfloat16)
    port.load_state_dict(_stack_state(params))
    got = port(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, T, H * (2 if bidirectional else 1))
    _close(got, want, dtype)
    # the port's keys carried back through the JAX importer give the tree
    back = jax_compat._rnn_stack({f"rnn.{k}": v.numpy() for k, v in port.state_dict().items()},
                                 "rnn", 2, kind, bidirectional)
    for name, layer in params.items():
        for key, leaf in layer.items():
            np.testing.assert_allclose(back[name][key], leaf, rtol=0, atol=1e-7,
                                       err_msg=f"{name}.{key}")


def _mel_cfg(n_mels, kind, hidden, compat=False):
    return dict(n_fft=128, hop_length=32, n_mels=n_mels, rnn_hidden=hidden, rnn_layer=2,
                rnn_type=kind, rnn_over_batch_compat=compat)


@functools.lru_cache(maxsize=None)
def _mel_variables(n_mels, kind, hidden):
    model = jax_mel_rnn.MelRNN(**_mel_cfg(n_mels, kind, hidden))
    init = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((2, 1, 65, 40, 2)))
    return {k: _moved(v, np.random.default_rng(33)) for k, v in init.items()}


def _mel_pair(n_mels, kind, hidden=H, compat=False, fused=False):
    variables = _mel_variables(n_mels, kind, hidden)
    cfg = _mel_cfg(n_mels, kind, hidden, compat)
    jax_model = jax_mel_rnn.MelRNN(**cfg, fused_rnn="force" if fused else False)
    port = port_mel_rnn.MelRNN(**cfg, fused_rnn=fused)
    port.load_state_dict(mel_rnn_state_from_jax(variables["params"], variables["batch_stats"]))
    return jax_model, variables, port.eval()


def _spectrum(rng, batch, samples=SAMPLES):
    wav = (0.5 * rng.standard_normal((batch, 1, samples))).astype(np.float32)
    return wav, np.array(jax_stft_custom(jnp.asarray(wav), JaxConfig(STFT)))


def test_mel_rnn_weights_round_trip_through_the_jax_importer():
    variables = _mel_variables(16, "gru", H)
    _, _, port = _mel_pair(16, "gru")
    assert sorted(port.state_dict()) == sorted(
        mel_rnn_state_from_jax(variables["params"], variables["batch_stats"]))
    params, stats = jax_compat.mel_rnn_from_torch_state(port.state_dict(), rnn_layer=2,
                                                        rnn_type="gru")
    for want, got in ((variables["params"], params), (variables["batch_stats"], stats)):
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("n_mels,kind,compat,fused,hidden", [
    (0, "gru", False, False, H), (16, "rnn", False, False, H), (0, "lstm", True, False, H),
    (16, "gru", True, False, H), (0, "lstm", False, True, 128), (16, "lstm", True, True, 128)])
def test_mel_rnn_eval_matches_jax(rng, n_mels, kind, compat, fused, hidden):
    jax_model, variables, port = _mel_pair(n_mels, kind, hidden, compat, fused)
    _, spec = _spectrum(rng, 2)
    want = np.asarray(jax_model.apply(variables, jnp.asarray(spec)))
    with torch.inference_mode():
        got = port(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == spec.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_mel_step():
    model = jax_mel_rnn.MelRNN(**_mel_cfg(16, "lstm", H))
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
        return optax.apply_updates(params, updates), new_stats, opt_state, loss, \
            optax.global_norm(grads)

    return optimizer, step


def test_mel_rnn_two_train_steps_match_jax():
    """mse on the spectrograms through the mel projection, Adam 3e-4, clip 5:
    loss and grad norm of both steps within rtol 2e-3."""
    rng = np.random.default_rng(43)
    mixture = (0.5 * rng.standard_normal((2, 1, SAMPLES))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, SAMPLES))).astype(np.float32)
    optimizer, step = _jax_mel_step()
    variables = _mel_variables(16, "lstm", H)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = optimizer.init(params)
    _, _, port = _mel_pair(16, "lstm")
    opt = get_optimizer(Config(OPTIM), port.parameters())
    for _ in range(2):
        params, stats, opt_state, want_loss, want_norm = step(
            params, stats, opt_state, jnp.asarray(mixture), jnp.asarray(sources))
        got_loss, got_norm = train_step(port, port.SPEC, opt, mixture, sources, "mse",
                                        device="cpu", model_config=Config(STFT))
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-3)
        np.testing.assert_allclose(got_norm.item(), float(want_norm), rtol=2e-3)
    np.testing.assert_allclose(port.batchnorm.running_var.numpy(), stats["bn"]["var"],
                               rtol=1e-3, atol=1e-5)


def test_mel_rnn_evaluate_utterance_matches_jax(rng):
    jax_model, variables, port = _mel_pair(16, "lstm", 128, fused=True)
    raw = {"model": {"name": "mel-rnn", "segment": 0.25, "sample_rate": 16000, **STFT},
           "dset": {"sample_rate": 16000, "norm": "z-score", "audio_channels": 1}}
    port_cfg, jax_cfg = with_defaults(Config(raw)), jax_with_defaults(JaxConfig(raw))
    wav = (0.3 * rng.standard_normal((1, 1, 7000))).astype(np.float32)
    want = jax_eval.evaluate_utterance(wav, jax_model.apply, variables, JAX_STFT_MONO, jax_cfg)
    got = port_eval.evaluate_utterance(wav, port, port.SPEC, port_cfg, device="cpu")
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_build_model_builds_the_shipped_config():
    cfg = load_config("configs/mel_rnn_vbd.yaml")
    model, spec = build_model(cfg.model, device="cpu")
    assert isinstance(model, port_mel_rnn.MelRNN) and spec.domain == "stft" and spec.monarch
    assert model.rnn.fused and model.rnn.rnn_type == "lstm" and model.rnn.dtype is None
    assert model.rnn.weight_hh_l1.shape == (4 * 256, 256) and not model.rnn.use_bias
    assert model.fc_layers[2].weight.shape == (257, 257) and model.n_mels == 0
    with pytest.raises(ValueError, match="True or False"):
        build_model(Config({"name": "mel-rnn", "fused_rnn": "force"}), device="cpu")
