"""The port's DCCRN and its modules vs the JAX package, on the CPU.

Weights come from JAX init (perturbed with a numpy seed so that biases,
complex-BN statistics and PReLU slopes are not at their trivial initial
values) and cross over through ``compat.dccrn_state_from_jax``; inputs are
numpy arrays fed to both.
"""

import os
import subprocess
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.compat import dccrn_from_torch_state
from speech_enhancement_tpu.models import dccrn as jax_dccrn
from speech_enhancement_tpu.ops import complex_ops as jax_cops
from speech_enhancement_tpu.ops import rnn as jax_rnn
from speech_enhancement_torch.compat import dccrn_state_from_jax
from speech_enhancement_torch.compat import jax_weights
from speech_enhancement_torch.config import Config, load_config
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models import dccrn as port_dccrn
from speech_enhancement_torch.ops.complex_ops import ComplexBatchNorm
from speech_enhancement_torch.ops.rnn import ComplexLSTM, LSTMLayer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(rnn_layers=2, rnn_units=64, kernel_num=(16, 32, 64))  # tests/test_parity.py:44-63


def perturb(tree, rng):
    """Copy of a flax variable tree as numpy, with non-trivial values."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = perturb(value, rng)
            continue
        a = np.asarray(value, np.float32)
        if key in ("vrr", "vii"):
            a = rng.uniform(0.5, 1.5, a.shape)
        elif key == "vri":
            a = rng.uniform(-0.2, 0.2, a.shape)
        elif key in ("mean_r", "mean_i"):
            a = 0.1 * rng.standard_normal(a.shape)
        elif key == "alpha":
            a = rng.uniform(0.1, 0.4, a.shape)
        elif key in ("br", "bi", "b_ih", "b_hh", "bias", "beta_r", "beta_i", "gamma_ri"):
            a = a + 0.05 * rng.standard_normal(a.shape)
        elif key in ("gamma_rr", "gamma_ii"):
            a = a + 0.1 * rng.standard_normal(a.shape)
        out[key] = np.asarray(a, np.float32)
    return out


def jax_variables(module, *inputs, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), *inputs)
    rng = np.random.default_rng(seed + 1)
    return {name: perturb(tree, rng) for name, tree in variables.items()}


def small_dccrn_pair(rng, **overrides):
    """(JAX model, its perturbed variables, port model with the same weights)."""
    cfg = dict(SMALL, **overrides)
    jax_model = jax_dccrn.DCCRN(**cfg)
    variables = jax_variables(jax_model, jnp.zeros((1, 4000), jnp.float32))
    port_cfg = {k: v for k, v in cfg.items() if not k.startswith("use_pallas")}
    port = port_dccrn.DCCRN(**port_cfg)
    port.load_state_dict(dccrn_state_from_jax(variables["params"], variables["batch_stats"]))
    return jax_model, variables, port.eval()


def _unclamped_share(out):
    return float(np.mean(np.abs(out) < 0.999))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_complex_batchnorm_matches_jax(rng, fold, train):
    xr, xi = (rng.standard_normal((3, 6, 5, 7)).astype(np.float32) * 1.5 + 0.3
              for _ in range(2))
    jax_bn = jax_cops.ComplexBatchNorm(fold=fold, channel_axis=1)
    variables = jax_variables(jax_bn, (jnp.asarray(xr), jnp.asarray(xi)))
    if train:
        (wr, wi), updated = jax_bn.apply(variables, (jnp.asarray(xr), jnp.asarray(xi)),
                                         use_running_average=False, mutable=["batch_stats"])
    else:
        wr, wi = jax_bn.apply(variables, (jnp.asarray(xr), jnp.asarray(xi)),
                              use_running_average=True)
    bn = ComplexBatchNorm(6, fold=fold).train(train)
    state = {t: torch.from_numpy(variables["params"][j]) for j, t in jax_weights._CBN_PARAMS}
    state.update({t: torch.from_numpy(variables["batch_stats"][j])
                  for j, t in jax_weights._CBN_STATS})
    bn.load_state_dict(state)
    gr, gi = bn(torch.from_numpy(xr), torch.from_numpy(xi))
    np.testing.assert_allclose(gr.detach().numpy(), np.asarray(wr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gi.detach().numpy(), np.asarray(wi), rtol=1e-5, atol=1e-5)
    if train:
        for jax_key, torch_key in jax_weights._CBN_STATS:
            np.testing.assert_allclose(getattr(bn, torch_key).numpy(),
                                       np.asarray(updated["batch_stats"][jax_key]),
                                       rtol=1e-5, atol=1e-6)


def _block_state(params, stats, transposed):
    sd = {}
    jax_weights._block(sd, "b", params, stats, transposed)
    return {key[2:]: value for key, value in sd.items()}


def test_conv_block_matches_jax_nchw(rng):
    x2 = rng.standard_normal((2, 8, 16, 9)).astype(np.float32)  # [B, 2Cin, F, T]
    jax_block = jax_dccrn._ComplexConvBlock(features=6, layout="nchw")
    variables = jax_variables(jax_block, jnp.asarray(x2), False)
    want = np.asarray(jax_block.apply(variables, jnp.asarray(x2), False))
    block = port_dccrn._ComplexConvBlock(4, 6).eval()
    block.load_state_dict(_block_state(variables["params"], variables["batch_stats"], False))
    got = block(torch.from_numpy(x2)).detach().numpy()
    assert got.shape == want.shape == (2, 12, 8, 9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("last", [False, True])
def test_deconv_block_matches_jax_nchw(rng, last):
    x2 = rng.standard_normal((2, 8, 4, 9)).astype(np.float32)    # trunk, 4 per part
    skip2 = rng.standard_normal((2, 6, 4, 9)).astype(np.float32)  # skip, 3 per part
    jax_block = jax_dccrn._ComplexDeconvBlock(features=5, last=last, layout="nchw")
    variables = jax_variables(jax_block, jnp.asarray(x2), False, jnp.asarray(skip2))
    want = np.asarray(jax_block.apply(variables, jnp.asarray(x2), False, jnp.asarray(skip2)))
    block = port_dccrn._ComplexDeconvBlock(7, 5, last=last).eval()
    block.load_state_dict(_block_state(variables["params"],
                                       variables.get("batch_stats", {}), True))
    got = block(torch.from_numpy(x2), torch.from_numpy(skip2)).detach().numpy()
    assert got.shape == want.shape == (2, 10, 8, 9)
    # JAX sums two split-weight deconvs, the port one deconv of the concat
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def _lstm_state(prefix, params):
    sd = {}
    jax_weights._lstm(sd, prefix, params)
    return sd


def test_lstm_layer_matches_jax(rng):
    x = rng.standard_normal((3, 11, 10)).astype(np.float32)
    jax_layer = jax_rnn.LSTMLayer(8)
    variables = jax_variables(jax_layer, jnp.asarray(x))
    want, (wh, wc) = jax_layer.apply(variables, jnp.asarray(x))
    layer = LSTMLayer(10, 8)
    layer.load_state_dict({k[2:]: v for k, v in _lstm_state("l", variables["params"]).items()})
    got, (gh, gc) = layer(torch.from_numpy(x))
    for g, w in ((got, want), (gh, wh), (gc, wc)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_complex_lstm_matches_jax(rng):
    xr, xi = (rng.standard_normal((2, 9, 12)).astype(np.float32) for _ in range(2))
    jax_layer = jax_rnn.ComplexLSTM(hidden_size=8, projection_dim=12)
    variables = jax_variables(jax_layer, jnp.asarray(xr), jnp.asarray(xi))
    wr, wi = jax_layer.apply(variables, jnp.asarray(xr), jnp.asarray(xi))
    params = variables["params"]
    sd = {**_lstm_state("real_lstm", params["real_lstm"]),
          **_lstm_state("imag_lstm", params["imag_lstm"])}
    for part, key in (("r_trans", "proj_r"), ("i_trans", "proj_i")):
        sd[f"{part}.weight"] = torch.from_numpy(params[key]["kernel"].T.copy())
        sd[f"{part}.bias"] = torch.from_numpy(params[key]["bias"])
    layer = ComplexLSTM(12, 8, projection_dim=12)
    layer.load_state_dict(sd)
    gr, gi = layer(torch.from_numpy(xr), torch.from_numpy(xi))
    np.testing.assert_allclose(gr.detach().numpy(), np.asarray(wr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gi.detach().numpy(), np.asarray(wi), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masking_mode", ["E", "C", "R"])
def test_dccrn_matches_jax_xla_path_f32(rng, masking_mode):
    jax_model, variables, port = small_dccrn_pair(rng, masking_mode=masking_mode)
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    want = np.asarray(jax_model.apply(variables, jnp.asarray(wav), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == wav.shape
    assert _unclamped_share(want) > 0.5  # the clamp does not hide the comparison
    np.testing.assert_allclose(got, want, atol=2e-4)  # as tests/test_parity.py


def test_dccrn_matches_jax_pallas_path_f32(rng):
    """Port with both kernel wrappers on (plain versions on the CPU) vs the
    JAX DCCRN with both Pallas kernels forced (interpret mode)."""
    jax_model, variables, port = small_dccrn_pair(
        rng, use_pallas_stft="force", use_pallas_mask="force")
    assert port.use_stft_kernel and port.use_mask_kernel
    wav = rng.standard_normal((1, 1, 4000)).astype(np.float32) * 0.1
    want = np.asarray(jax_model.apply(variables, jnp.asarray(wav), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=2e-3)  # as tests/test_pallas.py DCCRN paths


def test_dccrn_plain_path_matches_kernel_path_f32(rng):
    _, _, port = small_dccrn_pair(rng)
    wav = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32) * 0.1)
    with torch.no_grad():
        a = port(wav)
        port.use_stft_kernel = port.use_mask_kernel = False
        b = port(wav)
    # differ only in the mask's +1e-12 inside the square root
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_dccrn_bf16_close_to_jax_bf16(rng):
    """bf16 compute on both sides. Each framework rounds to bf16 (8-bit
    mantissa, relative step 2^-8 = 0.4%) at different places (e.g. the
    port adds conv biases before rounding, JAX after), so single rounding
    flips propagate through 3 + 3 conv blocks and 2 x 25 LSTM steps. We
    hold the mean error to 2% and the worst sample to 10% of the output's
    RMS (at f32 the same comparison agrees to ~1e-7)."""
    jax_model, variables, port = small_dccrn_pair(rng, dtype="bfloat16")
    wav = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    want = np.asarray(jax_model.apply(variables, jnp.asarray(wav), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(wav)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want**2)))
    err = np.abs(got - want)
    assert err.mean() < 0.02 * rms, (err.mean(), rms)
    assert err.max() < 0.1 * rms, (err.max(), rms)


# the small config of tests/test_dccrn_fused.py:17-21
FUSED_SMALL = dict(win_len=128, win_inc=32, fft_len=256, kernel_num=(4, 8, 8, 16, 16, 16),
                   rnn_layers=2, rnn_units=16)


@pytest.fixture(scope="module")
def fused_pair():
    """JAX DCCRN with the fused Pallas blocks forced (interpret mode), its
    perturbed variables, the port's fused DCCRN with the same weights, and
    the waveform."""
    jax_model = jax_dccrn.DCCRN(use_fused_blocks="force", use_pallas_stft=False,
                                use_pallas_mask=False, **FUSED_SMALL)
    wav = (0.1 * np.random.default_rng(3).standard_normal((2, 1, 1600))).astype(np.float32)
    variables = jax_variables(jax_model, jnp.asarray(wav))
    port = port_dccrn.DCCRN(use_fused_blocks=True, **FUSED_SMALL)
    port.load_state_dict(dccrn_state_from_jax(variables["params"], variables["batch_stats"]))
    return jax_model, variables, port, wav


def test_fused_param_tree_is_the_unfused_one():
    """dccrn_state_from_jax serves the fused path as it is: the JAX tree is
    the same with the flag on or off, and so is the port's state_dict."""
    wav = jnp.zeros((1, 1, 1600), jnp.float32)
    trees = [jax.eval_shape(jax_dccrn.DCCRN(use_fused_blocks=flag, **FUSED_SMALL).init,
                            jax.random.PRNGKey(0), wav) for flag in (False, "force")]
    leaves = [[(jax.tree_util.keystr(p), v.shape)
               for p, v in jax.tree_util.tree_leaves_with_path(t)] for t in trees]
    assert leaves[0] == leaves[1]
    states = [port_dccrn.DCCRN(use_fused_blocks=flag, **FUSED_SMALL).state_dict()
              for flag in (False, True)]
    assert [(k, v.shape) for k, v in states[0].items()] == [
        (k, v.shape) for k, v in states[1].items()]


def test_fused_dccrn_matches_jax_fused_eval(fused_pair):
    jax_model, variables, port, wav = fused_pair
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(wav)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)  # tests/test_dccrn_fused.py:54-55


def test_fused_dccrn_matches_jax_fused_train(fused_pair):
    """train() mode: batch moments from the kernels' stats partials fold
    into the next block and update the running statistics
    (tests/test_dccrn_fused.py:58-74)."""
    jax_model, variables, port, wav = fused_pair
    want, updated = jax_model.apply(variables, jnp.asarray(wav), train=True,
                                    mutable=["batch_stats"])
    port = port_dccrn.DCCRN(use_fused_blocks=True, **FUSED_SMALL)
    port.load_state_dict(dccrn_state_from_jax(variables["params"], variables["batch_stats"]))
    got = port.train()(torch.from_numpy(wav))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    stats_want = dccrn_state_from_jax(variables["params"], updated["batch_stats"])
    stats_got = port.state_dict()
    keys = [k for k in stats_want if k.split(".")[-1] in ("RMr", "RMi", "RVrr", "RVri", "RVii")]
    assert len(keys) == 5 * (6 + 5)  # every block with complex BN updated its stats
    for key in keys:
        np.testing.assert_allclose(stats_got[key].numpy(), stats_want[key].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=key)
    assert got.requires_grad  # the plain versions stay differentiable on the CPU


@pytest.mark.parametrize("train", [False, True])
def test_fused_dccrn_matches_port_unfused(fused_pair, train):
    _, _, fused, wav = fused_pair
    unfused = port_dccrn.DCCRN(cbn_fold=train, **FUSED_SMALL)
    unfused.load_state_dict(fused.state_dict())
    fused = port_dccrn.DCCRN(use_fused_blocks=True, **FUSED_SMALL)
    fused.load_state_dict(unfused.state_dict())
    with torch.no_grad():
        a = fused.train(train)(torch.from_numpy(wav))
        b = unfused.train(train)(torch.from_numpy(wav))
    # the same weights; folded complex BN against the centred one (eval)
    # or against the folded one of the unfused path (train)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    for (key, va), vb in zip(fused.state_dict().items(), unfused.state_dict().values()):
        np.testing.assert_allclose(va.numpy(), vb.numpy(), rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_dccrn_real_lstm_matches_jax(fused):
    """use_clstm=False (a real LSTM over the flattened [B, T, 2C * D] and the
    ``transform`` Linear) at FUSED_SMALL on both execution paths, eval, f32:
    the unfused path against the JAX XLA path (tests/test_parity.py's atol
    2e-4), the fused blocks against the JAX fused "force" path
    (tests/test_dccrn_fused.py's bounds)."""
    cfg = dict(FUSED_SMALL, use_clstm=False)
    jax_model = jax_dccrn.DCCRN(use_fused_blocks="force" if fused else False,
                                use_pallas_stft=False, use_pallas_mask=False, **cfg)
    wav = (0.1 * np.random.default_rng(71).standard_normal((2, 1, 1600))).astype(np.float32)
    init = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(wav))
    variables = {k: perturb(v, np.random.default_rng(72)) for k, v in init.items()}
    port = port_dccrn.DCCRN(use_fused_blocks=fused, **cfg)
    port.load_state_dict(dccrn_state_from_jax(variables["params"], variables["batch_stats"]))
    assert not hasattr(port, "enhance") and len(port.lstm) == 2
    assert port.transform.weight.shape[0] == port.lstm[0].weight_ih_l0.shape[1]
    want = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(wav)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == wav.shape
    if fused:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_weight_round_trip_is_exact(rng):
    _, variables, port = small_dccrn_pair(rng)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    params, batch_stats = dccrn_from_torch_state(state, n_encoder=3, rnn_layers=2)
    flat_want = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        {"params": params, "batch_stats": batch_stats}))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path], want, err_msg=str(path))


def test_shipped_config_matches_jax_param_tree():
    """configs/dccrn_vbd.yaml at full width: the port's weights, carried
    back through the JAX importer, have the JAX model's exact tree."""
    cfg = load_config(os.path.join(REPO, "configs", "dccrn_vbd.yaml"))
    port, spec = build_model(cfg.model, device="cpu")
    assert spec.domain == "wav" and port.compute_dtype == torch.bfloat16
    assert not port.training
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = dccrn_from_torch_state(state, n_encoder=6, rnn_layers=2)
    jax_model = jax_dccrn.DCCRN(rnn_layers=2, rnn_units=128,
                                kernel_num=(16, 32, 64, 128, 256, 256))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16000), jnp.float32))
    want = jax.tree_util.tree_map(lambda s: s.shape, {"params": shapes["params"],
                                                      "batch_stats": shapes["batch_stats"]})
    got = jax.tree_util.tree_map(np.shape, {"params": params, "batch_stats": stats})
    assert got == want
    n_params = sum(p.numel() for p in port.parameters())
    assert n_params == sum(np.prod(s) for s in jax.tree_util.tree_leaves(
        want["params"], is_leaf=lambda s: isinstance(s, tuple)))


def test_build_model_needs_cuda_or_explicit_cpu():
    cfg = Config({"name": "dccrn", **SMALL})
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError):
        build_model(cfg, device="cuda")
    model, _ = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_build_model_names_later_slices_and_seeds_weights():
    mel, spec = build_model(Config({"name": "mel-rnn"}), device="cpu")  # ported: builds
    assert type(mel).__name__ == "MelRNN" and spec.domain == "stft"
    tasnet, spec = build_model(Config({"name": "conv-tasnet"}), device="cpu")  # ported too
    assert type(tasnet).__name__ == "ConvTasNet" and spec.multi_speaker
    with pytest.raises(ValueError):
        build_model(Config({"name": "no-such-model"}), device="cpu")
    fused, _ = build_model(Config({"name": "dccrn", **SMALL, "use_fused_blocks": True}),
                           device="cpu")
    assert fused.use_fused_blocks and not port_dccrn.DCCRN(**SMALL).use_fused_blocks
    with pytest.raises(ValueError, match="True or False"):  # the JAX "force" has no meaning here
        build_model(Config({"name": "dccrn", "use_fused_blocks": "force"}), device="cpu")
    cfg = Config({"name": "dccrn", **SMALL})
    a, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert any(not torch.equal(pa, pc) for pa, pc in zip(a.parameters(), c.parameters()))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import speech_enhancement_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax',\n"
        "                                            'speech_enhancement_tpu')))\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 45  # every port module was imported
