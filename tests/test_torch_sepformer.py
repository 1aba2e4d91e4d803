"""The port's Sepformer vs the JAX package's, on the CPU.

At the small size of tests/test_pallas.py:226-263 (d_model 32, chunk 50,
one dual block of 1 + 1 layers, 4 heads, FFN 64), stereo in and two
speakers out. Weights are the JAX model's initial tree with its biases,
norms and PReLU slope moved off their initial values, carried over by
``sepformer_state_from_jax``; inputs are numpy-made. The port's
``fused_attention=True`` on CPU tensors runs the attention kernels' plain
versions and is held against the JAX ``"force"`` path (Pallas in interpret
mode); ``False`` against flax's attention.
"""

import functools
import types
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.compat import torch_weights as jax_compat
from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import load_config as jax_load_config
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.models import sepformer as jax_sep
from speech_enhancement_tpu.models.types import WAV_MULTI as JAX_WAV_MULTI
from speech_enhancement_tpu.train import evaluate as jax_eval
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import sepformer_state_from_jax
from speech_enhancement_torch.compat.jax_weights import _transformer_block
from speech_enhancement_torch.config import Config, load_config, with_defaults
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models import sepformer as port_sep
from speech_enhancement_torch.train import evaluate as port_eval
from speech_enhancement_torch.train.solver import get_optimizer, train_step

SMALL = dict(encoder_in_nchannels=2, encoder_out_nchannels=32, masknet_chunksize=50,
             masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1, intra_nhead=4,
             inter_nhead=4, intra_dffn=64, inter_dffn=64)
LAYERS = dict(masknet_numlayers=1, intra_numlayers=1, inter_numlayers=1, intra_nhead=4,
              inter_nhead=4)
SAMPLES = 1500
# configs/sepformer_clarity.yaml's optimizer
OPTIM = {"optim": "adam", "lr": 1.5e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}


def _perturb(tree, rng):
    """Numpy copy of a flax tree with biases, norms and the PReLU slope moved."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = _perturb(value, rng)
            continue
        a = np.asarray(value, np.float32)
        if key in ("bias", "beta"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        elif key in ("scale", "gamma"):
            a = rng.uniform(0.8, 1.2, a.shape)
        elif key == "alpha":
            a = rng.uniform(0.1, 0.4, a.shape)
        out[key] = np.asarray(a, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _params():
    init = jax.jit(jax_sep.Sepformer(fused_attention=False, **SMALL).init)
    variables = init(jax.random.PRNGKey(0), jnp.zeros((2, 2, SAMPLES), jnp.float32))
    return _perturb(variables["params"], np.random.default_rng(51))


def _pair(fused: bool, dtype: str = "float32"):
    jax_model = jax_sep.Sepformer(fused_attention="force" if fused else False, dtype=dtype,
                                  **SMALL)
    port = port_sep.Sepformer(fused_attention=fused, dtype=dtype, **SMALL)
    port.load_state_dict(sepformer_state_from_jax(_params()))
    return jax_model, port.eval()


def _mixture(seed: int, batch: int = 2, samples: int = SAMPLES) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((batch, 2, samples))).astype(np.float32)


def test_sepformer_weights_round_trip_through_the_jax_importer():
    params = _params()
    state = sepformer_state_from_jax(params)
    port = port_sep.Sepformer(**SMALL)
    assert sorted(port.state_dict()) == sorted(state)
    port.load_state_dict(state)
    back, _ = jax_compat.sepformer_from_torch_state(port.state_dict(), **LAYERS)
    flat_w = jax.tree_util.tree_leaves_with_path(params)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("length", [120, 125, 149, 150])  # gaps 30, 25, 1, 50 (= K)
def test_segment_and_over_add_match_jax(length):
    x = np.random.default_rng(length).standard_normal((2, length, 3)).astype(np.float32)
    want, want_gap = jax_sep._segment(jnp.asarray(x), 50)
    got, gap = port_sep._segment(torch.from_numpy(x), 50)
    assert gap == want_gap > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    chunks = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    np.testing.assert_allclose(port_sep._over_add(torch.from_numpy(chunks), gap).numpy(),
                               np.asarray(jax_sep._over_add(jnp.asarray(chunks), gap)),
                               rtol=1e-6, atol=1e-6)
    assert port_sep._over_add(got, gap).shape == (2, length, 3)


@pytest.mark.parametrize("fused", [False, True])
def test_sepformer_forward_matches_jax(fused):
    """f32 at the bounds of tests/test_pallas.py:252-255 (atol 2e-5, rtol 1e-4)."""
    jax_model, port = _pair(fused)
    x = _mixture(5)
    want = np.asarray(jax_model.apply({"params": _params()}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, SAMPLES)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_sepformer_bf16_forward_follows_jax(fused):
    """bf16 compute, f32 parameters: the port mirrors flax's dtypes layer by
    layer but rounds in other places (torch's bf16 matmuls and reductions),
    so the outputs agree at the bounds the smoke test holds bf16 paths to:
    mean error <= 2% and worst sample <= 20% of the output's RMS."""
    jax_model, port = _pair(fused, "bfloat16")
    x = _mixture(6)
    want = np.asarray(jax_model.apply({"params": _params()}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    rms = np.sqrt(np.mean(want**2))
    err = np.abs(got - want)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert err.mean() <= 0.02 * rms and err.max() <= 0.2 * rms, (err.mean() / rms,
                                                                 err.max() / rms)


@pytest.mark.parametrize("norm_before,activation", [(True, "relu"), (False, "gelu")])
def test_transformer_layer_matches_jax(norm_before, activation):
    """Both norm placements and both FFN activations (flax's gelu is the tanh
    approximation) of one layer, on the flax attention path."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 20, 32)).astype(np.float32)
    layer = jax_sep.TransformerEncoderLayer(32, 4, 64, norm_before, ffn_activation=activation)
    variables = jax.jit(layer.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _perturb(variables["params"], rng)
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    block_sd = {}  # the converter's keys for a one-layer stack
    _transformer_block(block_sd, "mdl", {"layer_0": params, "norm": params["ln1"]})
    port = port_sep.TransformerEncoderLayer(32, 4, 64, norm_before, fused_attention=False,
                                            ffn_activation=activation)
    port.load_state_dict({k[len("mdl.layers.0."):]: v for k, v in block_sd.items()
                          if k.startswith("mdl.layers.0.")})
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_step(fused: bool):
    """One jitted JAX train step with the Solver's own loss (si-sdr, PIT)."""
    model = jax_sep.Sepformer(fused_attention="force" if fused else False, **SMALL)
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


def _assert_leaves_close(got, want, extra=0.0):
    """Each leaf within 2e-3 of its largest magnitude (tests/test_torch_train_step.py's
    bound, from tests/test_dccrn_fused.py:97-113), plus ``extra``."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        err = (got[key] - value).abs().max().item()
        bound = 2e-3 * max(value.abs().max().item(), 1e-8) + extra
        assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("fused", [False, True])
def test_sepformer_pit_train_step_matches_jax(fused):
    """One si-sdr PIT step on [B, S, C, T] targets: loss and grad norm within
    2e-3, every (clipped) gradient within 2e-3 of its leaf's scale, every updated
    parameter too, plus 2 lr (Adam moves an element by up to lr whatever its
    gradient's size, so one whose gradient is rounding residue may move
    the other way)."""
    rng = np.random.default_rng(61)
    sources = (0.5 * rng.standard_normal((2, 2, 2, SAMPLES))).astype(np.float32)
    mixture = sources.sum(axis=1) + (0.05 * rng.standard_normal((2, 2, SAMPLES))).astype(
        np.float32)
    optimizer, step = _jax_step(fused)
    params = _params()
    new_params, want_loss, want_norm, grads = step(
        params, optimizer.init(params), jnp.asarray(mixture), jnp.asarray(sources))
    _, port = _pair(fused)
    opt = get_optimizer(Config(OPTIM), port.parameters())
    loss, norm = train_step(port, port.SPEC, opt, mixture, sources, "si-sdr", use_pit=True,
                            device="cpu")
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=2e-3)
    got = {k: p.grad for k, p in port.named_parameters()}
    _assert_leaves_close(got, sepformer_state_from_jax(grads))
    _assert_leaves_close(port.state_dict(), sepformer_state_from_jax(new_params),
                         extra=2 * OPTIM["lr"])


def test_sepformer_evaluate_utterance_matches_jax():
    """Two speakers, stereo, rows of two true lengths: windows of 1500
    samples at stride 512, the multi-speaker stitch and de-normalisation."""
    jax_model, port = _pair(True)
    raw = {"model": {"name": "sepformer", "segment": SAMPLES / 16000, "sample_rate": 16000,
                     "win_length": 512, **SMALL},
           "dset": {"sample_rate": 16000, "norm": "z-score", "audio_channels": 2}}
    port_cfg, jax_cfg = with_defaults(Config(raw)), jax_with_defaults(JaxConfig(raw))
    wav = _mixture(8, samples=4000)
    want = jax_eval.evaluate_utterance(wav, jax_model.apply, {"params": _params()},
                                       JAX_WAV_MULTI, jax_cfg, lengths=[4000, 3100])
    got = port_eval.evaluate_utterance(wav, port, port.SPEC, port_cfg, lengths=[4000, 3100],
                                       device="cpu")
    assert got.shape == want.shape == (2, 2, 2, 4000)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("option", [{"attention_type": "RelPosMHAXL"}, {"intra_block": "rnn"},
                                    {"inter_block": "rnn"}, {"remat": True}])
def test_options_of_later_slices_raise(option):
    """The four options are ported (tests/test_torch_sepformer_options.py):
    each builds, and what stays refused beside it raises: an unknown
    attention or block type. JAX's ``remat_policy`` is accepted: with
    ``attn_out``, and with a name the model does not tag, a train() loss
    and its gradients equal remat off's to 1e-6."""
    with torch.inference_mode():
        assert port_sep.Sepformer(**SMALL, **option)(torch.zeros(1, 2, 800)).shape == (
            1, 2, 2, 800)
    key, value = next(iter(option.items()))
    if key != "remat":
        with pytest.raises(ValueError, match="unknown"):
            port_sep.Sepformer(**SMALL, **{key: value + "_x"})
        return
    mixture = torch.from_numpy(_mixture(66, samples=800))
    results = []
    for policy in (None, "attn_out", "not_a_tag"):
        model = port_sep.Sepformer(**SMALL, remat=policy is not None, remat_policy=policy or "",
                                   generator=torch.Generator().manual_seed(9)).train()
        loss = (model(mixture) ** 2).mean()
        loss.backward()
        results.append((loss.item(), [p.grad for p in model.parameters()]))
    for loss, grads in results[1:]:
        np.testing.assert_allclose(loss, results[0][0], rtol=1e-6)
        for got, want in zip(grads, results[0][1]):
            torch.testing.assert_close(got, want, rtol=1e-6,
                                       atol=1e-6 * (want.abs().max().item() + 1e-12))


def test_build_model_builds_the_shipped_config_at_full_width():
    cfg = load_config("configs/sepformer_clarity.yaml")
    model, spec = build_model(cfg.model, device="cpu")
    assert isinstance(model, port_sep.Sepformer) and spec.multi_speaker and not spec.monarch
    assert model.compute_dtype == torch.bfloat16 and model.fused_attention
    assert all(p.dtype == torch.float32 for p in model.parameters())
    layers = model.masknet.dual_mdl[0].intra_mdl.mdl.layers
    assert len(model.masknet.dual_mdl) == 2 and len(layers) == 8
    assert layers[0].self_att.att.in_proj_weight.shape == (3 * 256, 256)
    assert model.encoder.conv1d.weight.shape == (256, 2, 16)


def test_shipped_config_gives_the_jax_optimizer_section():
    """The YAML sets no Adam betas: the merged defaults must supply the JAX
    package's, so get_optimizer builds from ``cfg.optim`` as the Solver does."""
    path = "configs/sepformer_clarity.yaml"
    port_optim = load_config(path).optim
    assert port_optim.to_dict() == jax_load_config(path).optim.to_dict()
    opt = get_optimizer(port_optim, [torch.nn.Parameter(torch.zeros(3))])
    assert opt.clip == 5.0 and opt.optimizer.defaults["lr"] == 1.5e-4
    assert opt.optimizer.defaults["betas"] == (0.9, 0.999)
