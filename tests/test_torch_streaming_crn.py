"""The port's streaming CRN (``serve/streaming.py:CRNStreamer``) on the CPU.

CRN at n_fft 128 / hop 32 (its channels are fixed, so H = 256 is its
narrowest LSTM), with the JAX CRN's initial tree perturbed by a numpy seed
and carried over by ``compat.crn_state_from_jax``. Held against the port's
own offline path (``stft_custom`` -> CRN -> ``istft_custom``, held to
JAX's in tests/test_torch_crn.py), and once against the JAX
``CRNStreamer`` on the same weights: the JAX streamer runs once in this
file, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models import crn as jax_crn
from speech_enhancement_tpu.serve import CRNStreamer as JaxCRNStreamer
from speech_enhancement_torch.compat import crn_state_from_jax
from speech_enhancement_torch.config import Config
from speech_enhancement_torch.models import crn as port_crn
from speech_enhancement_torch.ops.rnn import RNNStack
from speech_enhancement_torch.ops.stft import istft_custom, stft_custom
from speech_enhancement_torch.serve import CRNStreamer
from test_torch_crn import _perturb

WIN = 128


def _port(variables, **overrides):
    model = port_crn.CRN(**{"n_fft": 128, "hop_length": 32, **overrides})
    model.load_state_dict(crn_state_from_jax(variables["params"], variables["batch_stats"]))
    return model.eval()


def _offline(model, wav: torch.Tensor) -> np.ndarray:
    cfg = Config({"n_fft": model.n_fft, "hop_length": model.hop_length,
                  "win_length": model.win_length, "center": True})
    with torch.no_grad():
        out = model(stft_custom(wav[:, None], cfg))
        return istft_custom(out, wav.shape[-1], cfg)[:, 0].numpy()


def _streamer(model, chunk_frames=8):
    return CRNStreamer(model, chunk_frames=chunk_frames)


@pytest.fixture(scope="module")
def jax_stream():
    """Perturbed JAX CRN variables, a B 2 x 4096 input and the JAX
    streamer's output for it at chunk 8, once."""
    model = jax_crn.CRN()
    init = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 65, 16, 2)))
    variables = {k: _perturb(v, np.random.default_rng(5)) for k, v in init.items()}
    wav = torch.from_numpy(
        (0.3 * np.random.default_rng(1).standard_normal((2, 4096))).astype(np.float32))
    out = JaxCRNStreamer(model, variables, chunk_frames=8, n_fft=128, hop=32).enhance(
        jnp.asarray(wav.numpy()))
    return variables, wav, np.asarray(out)


def test_stream_matches_jax_streamer(jax_stream):
    """Same weights, same chunks: the whole output within 2e-4 of its peak."""
    variables, wav, want = jax_stream
    got = _streamer(_port(variables)).enhance(wav).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
def test_stream_matches_offline(jax_stream, fused):
    """All but the final ``win`` samples within 2e-4 of the offline peak,
    those within 0.05; ``fused_rnn`` runs the LSTM kernel's plain version
    with the carried h0 / c0."""
    variables, wav, _ = jax_stream
    model = _port(variables, fused_rnn=fused)
    offline = _offline(model, wav)
    got = _streamer(model).enhance(wav).numpy()
    peak = np.abs(offline).max()
    assert peak > 1e-3
    np.testing.assert_allclose(got[:, :-WIN], offline[:, :-WIN], rtol=0, atol=2e-4 * peak)
    assert np.abs(got[:, -WIN:] - offline[:, -WIN:]).max() < 0.05


def test_stream_takes_the_model_stft(jax_stream):
    """The streamer reads n_fft, hop and window from the model: a 96-sample
    window zero-padded to n_fft 128 (the config's win_length) tracks the
    offline path at the same bounds as the full window."""
    variables, wav, _ = jax_stream
    model = _port(variables, win_length=96)
    streamer = _streamer(model)
    assert (streamer.n_fft, streamer.hop, streamer.latency) == (128, 32, 96)
    offline = _offline(model, wav)
    got = streamer.enhance(wav).numpy()
    peak = np.abs(offline).max()
    np.testing.assert_allclose(got[:, :-WIN], offline[:, :-WIN], rtol=0, atol=2e-4 * peak)
    assert np.abs(got[:, -WIN:] - offline[:, -WIN:]).max() < 0.05


def test_first_chunk_priming(jax_stream):
    """The first step frames from offline frame 0 with the reflected head:
    it emits ``latency`` fewer samples, already equal to the offline ones
    (no warmup), and the second step carries on seamlessly."""
    variables, wav, _ = jax_stream
    model = _port(variables)
    streamer = _streamer(model)
    assert streamer.latency == WIN - 32
    cs = streamer.chunk_samples
    offline = _offline(model, wav[:, :8 * cs])
    state = streamer.init_state(2)
    assert state["fresh"]
    state, out0 = streamer.step(state, wav[:, :cs])
    state, out1 = streamer.step(state, wav[:, cs:2 * cs])
    assert not state["fresh"]
    assert out0.shape == (2, cs - streamer.latency) and out1.shape == (2, cs)
    got = torch.cat([out0, out1], -1).numpy()
    np.testing.assert_allclose(got, offline[:, :got.shape[-1]], rtol=0,
                               atol=2e-4 * np.abs(offline).max())


def test_stream_chunk_size_invariance(jax_stream):
    variables, wav, _ = jax_stream
    model = _port(variables)
    a = _streamer(model, 6).enhance(wav[:1, :3000]).numpy()
    b = _streamer(model, 12).enhance(wav[:1, :3000]).numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_state_shapes_fixed(jax_stream, dtype):
    variables, wav, _ = jax_stream
    streamer = _streamer(_port(variables, dtype=dtype))
    state = streamer.init_state(2)
    layout = lambda s: [(tuple(t.shape), t.dtype) for t in _leaves(s)]
    first = layout(state)
    cs = streamer.chunk_samples
    for c in range(3):
        state, _ = streamer.step(state, wav[:, c * cs:(c + 1) * cs])
        assert layout(state) == first


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, bool):
        return []
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def test_stream_bf16_tracks_f32(jax_stream):
    """A bf16 stream within 0.1 of the f32 offline peak."""
    variables, wav, _ = jax_stream
    offline = _offline(_port(variables), wav[:1])
    got = _streamer(_port(variables, dtype="bfloat16")).enhance(wav[:1]).numpy()
    assert np.abs(got - offline).max() / np.abs(offline).max() < 0.1


def test_streamer_checks(jax_stream):
    variables, _, _ = jax_stream
    with pytest.raises(ValueError, match="too small"):
        _streamer(_port(variables), chunk_frames=4)
    with pytest.raises(ValueError, match="multiple of hop"):
        CRNStreamer(_port(variables, hop_length=48))
    with pytest.raises(ValueError, match="use_lstm"):
        CRNStreamer(port_crn.CRN(n_fft=128, hop_length=32, use_lstm=False))


@pytest.mark.parametrize("fused", [False, True])
def test_rnn_stack_carries_state(rng, fused):
    """Two chunks with each layer's (h, c) carried equal one pass (1e-6);
    a GRU stack takes no state."""
    stack = RNNStack("lstm", 6, 5, num_layers=2, fused=fused,
                     generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((2, 9, 6)).astype(np.float32))
    with torch.no_grad():
        whole, final = stack(x, return_state=True)
        a, carry = stack(x[:, :4], return_state=True)
        b, carry = stack(x[:, 4:], init_state=carry, return_state=True)
    torch.testing.assert_close(torch.cat([a, b], 1), whole, rtol=0, atol=1e-6)
    assert len(carry) == 2
    for (h, c), (hw, cw) in zip(carry, final):
        torch.testing.assert_close(h, hw, rtol=0, atol=1e-6)
        torch.testing.assert_close(c, cw, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="LSTM stacks"):
        RNNStack("gru", 6, 5)(x, return_state=True)
