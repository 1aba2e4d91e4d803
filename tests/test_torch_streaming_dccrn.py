"""The port's streaming DCCRN (``serve/streaming.py:DCCRNStreamer``) on the CPU.

Held against the port's own offline forward, as tests/test_streaming.py
holds the JAX streamer against JAX's (the offline forwards are held to
each other in tests/test_torch_dccrn.py), and once against the JAX
``DCCRNStreamer`` on the same weights (converted by
``compat.dccrn_state_from_jax``): the JAX streamer runs once in this file,
in a module-scoped fixture. Weights are the small JAX DCCRN's initial
tree, perturbed with a numpy seed; inputs are numpy-made.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.models import dccrn as jax_dccrn
from speech_enhancement_tpu.ops import rnn as jax_rnn
from speech_enhancement_tpu.serve import DCCRNStreamer as JaxDCCRNStreamer
from speech_enhancement_torch.compat import dccrn_state_from_jax
from speech_enhancement_torch.compat import jax_weights
from speech_enhancement_torch.models import dccrn as port_dccrn
from speech_enhancement_torch.ops.rnn import ComplexLSTM
from speech_enhancement_torch.serve import DCCRNStreamer
from test_torch_dccrn import jax_variables

SMALL = dict(rnn_layers=2, rnn_units=32, win_len=400, win_inc=100, fft_len=512,
             masking_mode="E", use_clstm=True, kernel_num=(4, 8, 8))  # tests/test_streaming.py


def _variables(**overrides):
    model = jax_dccrn.DCCRN(**dict(SMALL, use_pallas_stft=False, use_pallas_mask=False,
                                   **overrides))
    return model, jax_variables(model, jnp.zeros((1, 4000), jnp.float32))


def _port(variables, **overrides):
    model = port_dccrn.DCCRN(**dict(SMALL, **overrides))
    model.load_state_dict(dccrn_state_from_jax(variables["params"], variables["batch_stats"]))
    return model.eval()


def _wav(batch, length, seed):
    return torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((batch, length))).astype(np.float32))


@pytest.fixture(scope="module")
def jax_stream():
    """The JAX streamer's output for B 2 x 4000 samples at chunk 8, once."""
    model, variables = _variables()
    wav = _wav(2, 4000, 1)
    out = np.asarray(JaxDCCRNStreamer(model, variables, chunk_frames=8).enhance(
        jnp.asarray(wav.numpy())))
    return variables, wav, out


def test_stream_matches_jax_streamer(jax_stream):
    """Same weights, same chunks: the whole output, warmup-compensated head
    and end-of-stream tail included, within 2e-4 of its peak."""
    variables, wav, want = jax_stream
    got = DCCRNStreamer(_port(variables), chunk_frames=8).enhance(wav).numpy()
    assert got.shape == want.shape
    assert np.mean(np.abs(want) < 0.999) > 0.5  # not a clamped output
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("masking_mode", ["E", "C", "R"])
def test_stream_matches_offline(jax_stream, masking_mode):
    """Interior (all but the final ``latency`` samples) within 2e-4 of the
    offline peak, the tail within 0.05, and the first n_layers * hop
    emitted samples exactly zero."""
    variables, wav, _ = jax_stream
    model = _port(variables, masking_mode=masking_mode)
    with torch.no_grad():
        offline = model(wav).numpy()
    streamer = DCCRNStreamer(model, chunk_frames=8)
    assert streamer.latency == 3 * 100 + 300  # n_layers * hop + (win - hop)
    got = streamer.enhance(wav).numpy()
    assert got.shape == offline.shape
    interior = wav.shape[-1] - streamer.latency
    np.testing.assert_allclose(got[:, :interior], offline[:, :interior], rtol=0,
                               atol=2e-4 * max(1e-6, np.abs(offline).max()),
                               err_msg=f"mode {masking_mode}")
    assert np.abs(got[:, interior:] - offline[:, interior:]).max() < 0.05
    _, out0 = streamer.step(streamer.init_state(2), wav[:, :streamer.chunk_samples])
    n_zero = streamer.latency - (streamer.win - streamer.hop)
    assert torch.count_nonzero(out0[:, :n_zero]) == 0


def test_stream_chunk_size_invariance(jax_stream):
    variables, wav, _ = jax_stream
    model = _port(variables)
    a = DCCRNStreamer(model, chunk_frames=4).enhance(wav[:1, :3200]).numpy()
    b = DCCRNStreamer(model, chunk_frames=16).enhance(wav[:1, :3200]).numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_state_shapes_fixed(jax_stream, dtype):
    """The state's shapes and dtypes are the same after every step."""
    variables, wav, _ = jax_stream
    streamer = DCCRNStreamer(_port(variables, dtype=dtype), chunk_frames=8)
    state = streamer.init_state(2)
    assert sorted(state) == ["dec_cache", "enc_cache", "lstm", "ola_tail", "skip_buf",
                             "spec_buf", "wav_tail"]
    layout = lambda tree: [(tuple(t.shape), t.dtype) for t in _leaves(tree)]
    first = layout(state)
    cs = streamer.chunk_samples
    for c in range(3):
        state, out = streamer.step(state, wav[:, c * cs:(c + 1) * cs])
        assert out.shape == (2, cs) and layout(state) == first


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def test_stream_bf16_tracks_f32(jax_stream):
    """The serving precision: a bf16 stream within 0.1 of the f32 offline peak."""
    variables, wav, _ = jax_stream
    with torch.no_grad():
        offline = _port(variables)(wav[:1, :3000]).numpy()
    got = DCCRNStreamer(_port(variables, dtype="bfloat16"), chunk_frames=8).enhance(
        wav[:1, :3000]).numpy()
    assert np.abs(got - offline).max() / max(1e-6, np.abs(offline).max()) < 0.1


def test_stream_ignores_fused_blocks_and_kernel_flags(jax_stream):
    """The stream runs the unfused blocks in stream mode whatever
    ``use_fused_blocks`` says; with the kernel flags off it takes the plain
    framing and mask, which the wrappers run on CPU tensors anyway."""
    variables, wav, _ = jax_stream
    want = DCCRNStreamer(_port(variables), chunk_frames=8).enhance(wav).numpy()
    for flags in (dict(use_fused_blocks=True),
                  dict(use_stft_kernel=False, use_mask_kernel=False)):
        got = DCCRNStreamer(_port(variables, **flags), chunk_frames=8).enhance(wav).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=str(flags))


def test_streamer_checks(jax_stream):
    variables, _, _ = jax_stream
    with pytest.raises(ValueError, match="n_layers"):
        DCCRNStreamer(_port(variables), chunk_frames=2)
    with pytest.raises(ValueError, match="multiple of win_inc"):
        DCCRNStreamer(port_dccrn.DCCRN(**dict(SMALL, win_len=350)))
    with pytest.raises(ValueError, match="use_clstm"):
        DCCRNStreamer(port_dccrn.DCCRN(**dict(SMALL, use_clstm=False)))


def test_complex_lstm_carried_state_matches_jax(rng):
    """``ComplexLSTM`` with ``init_state`` / ``return_state`` against the JAX
    ``return_state`` mode: two chunks with the state carried equal one pass,
    within 1e-5."""
    xr, xi = (rng.standard_normal((2, 12, 6)).astype(np.float32) for _ in range(2))
    jax_mod = jax_rnn.ComplexLSTM(hidden_size=5, projection_dim=4, return_state=True)
    params = jax_variables(jax_mod, jnp.asarray(xr), jnp.asarray(xi))["params"]
    (wr, wi), state = jax_mod.apply({"params": params}, jnp.asarray(xr), jnp.asarray(xi))
    port = ComplexLSTM(6, 5, projection_dim=4)
    sd = {}
    jax_weights._lstm(sd, "real_lstm", params["real_lstm"])
    jax_weights._lstm(sd, "imag_lstm", params["imag_lstm"])
    jax_weights._linear(sd, "r_trans", params["proj_r"])
    jax_weights._linear(sd, "i_trans", params["proj_i"])
    port.load_state_dict(sd)
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    with torch.no_grad():
        (ar, ai), carry = port(tr[:, :7], ti[:, :7], return_state=True)
        (br, bi), carry = port(tr[:, 7:], ti[:, 7:], init_state=carry, return_state=True)
        whole = port(tr, ti)
    for got, want in ((torch.cat([ar, br], 1), wr), (torch.cat([ai, bi], 1), wi),
                      (whole[0], wr), (whole[1], wi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for (h, c), (jh, jc) in zip(carry, state):
        assert h.shape == (4, 5)  # [2B, H]: [xr; xi] on the batch
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
