"""The zoo's norms, the EMA scan and the resampler vs the JAX package's, on the CPU.

``ema_scan`` (the DNN's smoothers) against ``jax.lax.associative_scan`` and
the plain recurrence; gLN, cLN and the cumulative cLN channels last, in f32
and bf16; the polyphase resampler at several rate pairs and odd lengths,
and Demucs's 2x up- and down-sampling (56 zero crossings).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_torch.ops import norms as port_norms
from speech_enhancement_torch.ops.norms import ema_scan
from speech_enhancement_torch.ops.resample import (_kernel_bank, downsample2, resample_frac,
                                                   upsample2)
from speech_enhancement_tpu.ops import norms as jax_norms
from speech_enhancement_tpu.ops import resample as jax_resample
from speech_enhancement_tpu.ops.norms import ema_scan as jax_ema_scan


@pytest.mark.parametrize("steps", [1, 2, 7, 64, 501])
@pytest.mark.parametrize("alpha", [0.1, 0.85, "per-channel"])
def test_ema_scan_matches_jax(steps, alpha):
    """The doubling scan against JAX's associative scan and the plain
    recurrence, over T up to 501 at a = 0.85 (where (1 - a)^-t overflows
    f32), time on axis 1 and on axis 2."""
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((3, steps, 5)).astype(np.float32)
    a = rng.uniform(0.05, 0.95, 5).astype(np.float32) if alpha == "per-channel" else alpha
    got = ema_scan(torch.from_numpy(x), torch.as_tensor(a) if alpha == "per-channel" else a)
    want = np.asarray(jax_ema_scan(jnp.asarray(x), a, axis=1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    y, ref = np.zeros((3, 5), np.float64), np.zeros_like(x, np.float64)
    for t in range(steps):
        y = (1 - np.asarray(a, np.float64)) * y + np.asarray(a, np.float64) * x[:, t]
        ref[:, t] = y
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    if alpha != "per-channel":
        np.testing.assert_allclose(ema_scan(torch.from_numpy(xt), a, dim=2).numpy(),
                                   np.asarray(jax_ema_scan(jnp.asarray(xt), a, axis=2)),
                                   rtol=1e-5, atol=1e-6)


def _affine(rng, channels):
    return (rng.uniform(0.5, 1.5, channels).astype(np.float32),
            (0.1 * rng.standard_normal(channels)).astype(np.float32))


@pytest.mark.parametrize("kind,dtype", [
    ("GlobalLayerNorm", np.float32), ("GlobalLayerNorm", "bfloat16"),
    ("ChannelwiseLayerNorm", np.float32), ("ChannelwiseLayerNorm", "bfloat16"),
    ("CumulativeLayerNorm", np.float32)])
def test_layer_norms_match_jax(kind, dtype):
    """f32: 1e-5 of the peak; bf16 (gLN and cLN keep their statistics in f32
    and return bf16): one bf16 rounding step of the peak, 2^-7. The
    cumulative cLN computes in its input's dtype on both sides."""
    rng = np.random.default_rng(4)
    x = (2.0 * rng.standard_normal((2, 37, 6)) + 0.5).astype(np.float32)
    gamma, beta = _affine(rng, 6)
    module = getattr(jax_norms, kind)()
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(module.apply({"params": {"gamma": gamma, "beta": beta}}, xj), np.float32)
    port = getattr(port_norms, kind)(6)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(gamma))
        port.bias.copy_(torch.from_numpy(beta))
        xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        got = port(xt)
    assert got.dtype == xt.dtype
    tol = 1e-5 if dtype == np.float32 else 2.0**-7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


RATES = [(1, 2), (2, 1), (16000, 44100), (44100, 16000), (3, 2), (16000, 8000)]


@pytest.mark.parametrize("old_sr,new_sr", RATES)
@pytest.mark.parametrize("length", [1, 257, 1000])
def test_resample_frac_matches_jax(old_sr, new_sr, length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, 3, length)).astype(np.float32)
    want = np.asarray(jax_resample.resample_frac(jnp.asarray(x), old_sr, new_sr))
    got = resample_frac(torch.from_numpy(x), old_sr, new_sr).numpy()
    assert got.shape == want.shape == (2, 3, -(-new_sr * length // old_sr))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resample_bank_output_length_and_identity():
    bank, half = _kernel_bank(2, 1, 56, 0.945)
    want_bank, want_half = jax_resample._kernel_bank(2, 1, 56, 0.945)
    assert half == want_half == 119
    np.testing.assert_array_equal(bank, want_bank)
    x = torch.randn(1, 500)
    assert resample_frac(x, 16000, 16000) is x
    assert resample_frac(x, 3, 2, output_length=300).shape == (1, 300)


def test_demucs_up_and_down_sampling_match_jax():
    x = np.random.default_rng(6).standard_normal((2, 2, 1283)).astype(np.float32)
    up = upsample2(torch.from_numpy(x))
    np.testing.assert_allclose(up.numpy(), np.asarray(jax_resample.upsample2(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    down = downsample2(up)
    np.testing.assert_allclose(down.numpy(), np.asarray(jax_resample.downsample2(
        jax_resample.upsample2(jnp.asarray(x)))), rtol=1e-5, atol=1e-5)
    assert down.shape == x.shape
