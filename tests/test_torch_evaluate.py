"""The port's full-utterance evaluation vs speech_enhancement_tpu/train/evaluate.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from speech_enhancement_tpu.config import Config as JaxConfig
from speech_enhancement_tpu.config import with_defaults as jax_with_defaults
from speech_enhancement_tpu.models.types import WAV_MONO as JAX_WAV_MONO
from speech_enhancement_tpu.models.types import SignalSpec as JaxSignalSpec
from speech_enhancement_tpu.train import evaluate as jax_eval
from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.models.types import WAV_MONO, SignalSpec
from speech_enhancement_torch.train import evaluate as port_eval
from test_torch_dccrn import small_dccrn_pair

CFG = {"model": {"name": "dccrn", "segment": 0.25, "sample_rate": 16000,
                 "n_fft": 512, "hop_length": 128, "win_length": 512},
       "dset": {"sample_rate": 16000}}


def _configs(norm):
    raw = {**CFG, "dset": {**CFG["dset"], "norm": norm}}
    return with_defaults(Config(raw)), jax_with_defaults(JaxConfig(raw))


def _mixture(rng, rows, length):
    t = np.arange(length) / 16000
    speech = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (speech + 0.05 * rng.standard_normal((rows, 1, length))).astype(np.float32)


def test_extract_and_stitch_match_jax(rng):
    x = rng.standard_normal((1, 2, 5000)).astype(np.float32)
    want_w = np.asarray(jax_eval.extract_windows(jnp.asarray(x), 1600, 400, 12))
    got_w = port_eval.extract_windows(torch.from_numpy(x), 1600, 400, 12)
    np.testing.assert_array_equal(got_w.numpy(), want_w)  # slicing: exact
    want = np.asarray(jax_eval.stitch_overlap_discard(jnp.asarray(want_w), 400, 5000))
    got = port_eval.stitch_overlap_discard(got_w, 400, 5000)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)  # identical windows stitch back


@pytest.mark.parametrize("norm", ["z-score", "linear-scale", "none"])
def test_identity_matches_jax_with_mixed_lengths(rng, norm):
    port_cfg, jax_cfg = _configs(norm)
    x = _mixture(rng, 2, 9000)
    lengths = [9000, 6100]
    x[1, :, 6100:] = 0.0
    want = jax_eval.evaluate_utterance(x, None, None, JAX_WAV_MONO, jax_cfg, lengths=lengths)
    got = port_eval.evaluate_utterance(x, None, WAV_MONO, port_cfg, lengths=lengths,
                                       device="cpu")
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0], x[0], atol=1e-5)  # identity round trip


def test_small_dccrn_matches_jax_with_mixed_lengths(rng):
    port_cfg, jax_cfg = _configs("z-score")
    jax_model, variables, port = small_dccrn_pair(rng)
    x = _mixture(rng, 2, 9000)
    lengths = [9000, 7000]
    x[1, :, 7000:] = 0.0

    def apply_fn(v, inputs):
        return jax_model.apply(v, inputs, train=False)

    want = jax_eval.evaluate_utterance(x, apply_fn, variables, JAX_WAV_MONO, jax_cfg,
                                       lengths=lengths)
    got = port_eval.evaluate_utterance(x, port, WAV_MONO, port_cfg, lengths=lengths,
                                       device="cpu")
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    # the model agrees to 2e-4 on its [-1, 1] scale; denormalising
    # multiplies by each row's std
    std = x.std(axis=-1, keepdims=True)
    np.testing.assert_allclose(got, want, atol=float(2e-4 * std.max()))


class _TwoSources(nn.Module):
    def forward(self, x):  # [N, C, W] -> [N, 2, C, W]
        return torch.stack([x, 0.5 * x], dim=1)


def test_multi_speaker_output_matches_jax(rng):
    port_cfg, jax_cfg = _configs("z-score")
    x = _mixture(rng, 1, 8000)
    want = jax_eval.evaluate_utterance(
        x, lambda v, inp: jnp.stack([inp, 0.5 * inp], axis=1), None,
        JaxSignalSpec(multi_speaker=True, monarch=False), jax_cfg, num_sources=2)
    got = port_eval.evaluate_utterance(
        x, _TwoSources().eval(), SignalSpec(multi_speaker=True, monarch=False), port_cfg,
        num_sources=2, device="cpu")
    assert got.shape == want.shape == (1, 2, 1, 8000)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_refuses_what_it_cannot_run(rng):
    port_cfg, _ = _configs("z-score")
    x = _mixture(rng, 1, 5000)
    no_stft = Config({**port_cfg.to_dict(), "model": {
        k: v for k, v in port_cfg.model.to_dict().items() if k != "n_fft"}})
    with pytest.raises(AttributeError, match="n_fft"):  # an stft-domain model needs the transform
        port_eval.evaluate_utterance(x, None, SignalSpec(domain="stft"), no_stft, device="cpu")
    with pytest.raises(ValueError, match="eval mode"):
        port_eval.evaluate_utterance(x, _TwoSources().train(), WAV_MONO, port_cfg,
                                     device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_eval.evaluate_utterance(x, None, WAV_MONO, port_cfg)
