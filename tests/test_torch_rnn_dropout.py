"""``RNNStack``'s inter-layer dropout, and rnn-stft-mask training, on the CPU.

The port draws its masks from a ``torch.Generator`` of the stack, so they
cannot equal flax's: the dropout is held to its statistics (the kept
share, the 1 / (1 - p) scale, eval mode, the seed, the layers it follows),
and the train step is held against the JAX package at ``drop_out=0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.models import stft_rnn as jax_stft_rnn
from speech_enhancement_tpu.ops.stft import stft_custom as jax_stft_custom
from speech_enhancement_tpu.train import losses as jax_losses
from speech_enhancement_tpu.train import solver as jax_solver
from speech_enhancement_torch.compat import rnn_stft_mask_state_from_jax
from speech_enhancement_torch.config import Config
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models import stft_rnn as port_stft_rnn
from speech_enhancement_torch.ops.rnn import RNNStack
from speech_enhancement_torch.train.solver import get_optimizer, train_step

STFT = {"n_fft": 128, "hop_length": 32, "win_length": 128, "center": True}
OPTIM = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
MASK = dict(num_spk=2, n_fft=128, rnn_hidden=32, rnn_layer=2, rnn_type="lstm",
            bidirectional=True)
SAMPLES = 1248  # 40 frames at hop 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stack(p=0.5, seed=0, layers=3, kind="gru"):
    return RNNStack(kind, 6, 8, num_layers=layers, bidirectional=True, dropout=p,
                    generator=torch.Generator().manual_seed(seed))


def test_kept_share_is_within_three_sigma_of_one_minus_p():
    p, n = 0.5, 200_000
    stack = _stack(p).train()
    kept = (stack._drop(torch.ones(n)) != 0).float().mean().item()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(kept - (1 - p)) < 3 * sigma, (kept, sigma)


@pytest.mark.parametrize("p", [0.25, 0.5])
def test_kept_elements_are_scaled_by_one_over_keep(p):
    x = torch.randn(4, 50, 16)
    out = _stack(p)._drop(x)
    kept = out != 0
    assert 0 < kept.float().mean().item() < 1
    torch.testing.assert_close(out[kept], x[kept] / (1 - p), rtol=0, atol=0)
    assert out.dtype == x.dtype
    bf16 = _stack(p)._drop(x.bfloat16())
    assert bf16.dtype == torch.bfloat16


def test_eval_mode_is_the_identity():
    x = torch.randn(2, 7, 6)
    dropping, plain = _stack(0.5), _stack(0.0)
    plain.load_state_dict(dropping.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(dropping.eval()(x), plain.eval()(x), rtol=0, atol=0)
        torch.testing.assert_close(plain.train()(x), plain.eval()(x), rtol=0, atol=0)
        assert not torch.equal(dropping.train()(x), plain(x))


def test_the_same_seed_gives_the_same_masks():
    x = torch.randn(2, 7, 6)
    a, b, c = _stack(seed=3).train(), _stack(seed=3).train(), _stack(seed=4).train()
    with torch.no_grad():
        first = a(x)
        torch.testing.assert_close(first, b(x), rtol=0, atol=0)
        assert not torch.equal(first, a(x))  # the generator moves on
        assert not torch.equal(_stack(seed=3).train()(x), c(x))
    assert a.dropout_seed == b.dropout_seed != c.dropout_seed
    assert _stack(p=0.0).dropout_seed is None and _stack(layers=1).dropout_seed is None


@pytest.mark.parametrize("layers", [2, 3])
def test_no_dropout_after_the_last_layer(layers):
    stack = _stack(layers=layers).train()
    calls = []
    drop = stack._drop

    def counted(x):
        calls.append(x.shape)
        return drop(x)

    stack._drop = counted
    with torch.no_grad():
        out = stack(torch.randn(2, 7, 6))
    assert calls == [(2, 7, 16)] * (layers - 1)
    assert bool((out != 0).all())  # the last layer's output is not dropped


def test_shipped_rnn_stft_mask_builds_a_dropping_stack():
    from speech_enhancement_torch.config import load_config

    cfg = load_config("configs/rnn_stft_mask_clarity.yaml")
    model, _ = build_model(cfg.model, device="cpu")
    assert model.rnn.dropout == 0.5 and model.rnn.dropout_seed is not None
    again, _ = build_model(cfg.model, device="cpu")
    assert again.rnn.dropout_seed == model.rnn.dropout_seed  # seeded from the model's generator


def _jax_step(model):
    optimizer = jax_solver.get_optimizer(JaxConfig(OPTIM))
    mse = jax_losses.get_loss_function("mse")

    @jax.jit
    def step(params, stats, opt_state, mixture, sources):
        inputs = jax_stft_custom(mixture, JaxConfig(STFT))  # the Solver's _adapt
        target = jax_stft_custom(sources, JaxConfig(STFT))

        def loss_of(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats}, inputs, train=True,
                                       mutable=["batch_stats"])
            return jax_losses.pit_loss(out, target, mse)[0], mutated["batch_stats"]

        (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, optax.global_norm(grads)

    return optimizer, step


@pytest.mark.parametrize("compat", [False, True])
def test_rnn_stft_mask_train_step_at_no_dropout_matches_jax(compat):
    """A stereo two-speaker mse PIT step, without dropout on both sides:
    loss and grad norm within rtol 2e-3, the updated stack weights within
    2e-3 of each leaf's scale plus 2 lr (Adam's largest move)."""
    rng = np.random.default_rng(47)
    sources = (0.5 * rng.standard_normal((2, 2, 2, SAMPLES))).astype(np.float32)
    mixture = sources.sum(axis=1)
    jax_model = jax_stft_rnn.RNNSTFTMask(**MASK, drop_out=0.0, rnn_over_batch_compat=compat)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(5), jnp.zeros((2, 2, 65, 40, 2)))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    optimizer, step = _jax_step(jax_model)
    new_params, want_loss, want_norm = step(params, stats, optimizer.init(params),
                                            jnp.asarray(mixture), jnp.asarray(sources))
    port = port_stft_rnn.RNNSTFTMask(**MASK, drop_out=0.0, rnn_over_batch_compat=compat)
    port.load_state_dict(rnn_stft_mask_state_from_jax(params, stats))
    opt = get_optimizer(Config(OPTIM), port.parameters())
    loss, norm = train_step(port, port.SPEC, opt, mixture, sources, "mse", use_pit=True,
                            device="cpu", model_config=Config(STFT))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3)
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=2e-3)
    want = rnn_stft_mask_state_from_jax(new_params, stats)
    for key, value in port.state_dict().items():
        if key.startswith("rnn."):
            err = (value - want[key]).abs().max().item()
            assert err <= 2e-3 * want[key].abs().max().item() + 2 * OPTIM["lr"], key


def test_rnn_stft_mask_trains_with_dropout():
    """drop_out 0.5 in train(): finite steps, and two runs from one seed agree."""
    rng = np.random.default_rng(48)
    sources = (0.5 * rng.standard_normal((2, 2, 2, SAMPLES))).astype(np.float32)
    mixture = sources.sum(axis=1)
    losses = []
    for _ in range(2):
        model = port_stft_rnn.RNNSTFTMask(**MASK, drop_out=0.5,
                                          generator=torch.Generator().manual_seed(9))
        opt = get_optimizer(Config(OPTIM), model.parameters())
        losses.append([train_step(model, model.SPEC, opt, mixture, sources, "mse",
                                  use_pit=True, device="cpu",
                                  model_config=Config(STFT))[0].item() for _ in range(2)])
    assert np.isfinite(losses).all() and losses[0] == losses[1]
