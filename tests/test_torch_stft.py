"""The port's ops/stft.py vs speech_enhancement_tpu/ops/stft.py on the CPU.

Signals are numpy-made; the port's ``method="pallas"`` (the STFT kernel
wrapper's plain version on a CPU tensor) is held against the JAX Pallas
kernel in interpret mode.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_torch.config import Config
from speech_enhancement_torch.ops import stft as port_stft

# the JAX package's ops/__init__.py exports a function named stft
jax_stft = importlib.import_module("speech_enhancement_tpu.ops.stft")

GEOMETRIES = [(512, 128, 512), (128, 32, 128), (512, 128, 400)]  # n_fft, hop, win


def _signal(rng, shape):
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def test_window_and_bases_match_jax():
    for n_fft, _, win in GEOMETRIES:
        np.testing.assert_array_equal(port_stft.hann_window(win, n_fft).numpy(),
                                      np.asarray(jax_stft.hann_window(win, n_fft)))
        for got, want in zip(port_stft._rfft_basis(n_fft) + port_stft._irfft_basis(n_fft),
                             jax_stft._rfft_basis(n_fft) + jax_stft._irfft_basis(n_fft)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["fft", "matmul", "pallas"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_stft_matches_jax(rng, geometry, method):
    n_fft, hop, win = geometry
    x = _signal(rng, (2, 3, 4000))
    want = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft, hop, win, method=method))
    got = port_stft.stft(torch.from_numpy(x), n_fft, hop, win, method=method)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    # f32 sums of n_fft products (tests/test_pallas.py:22's bound)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_istft_matches_jax_and_inverts(rng, geometry, method):
    n_fft, hop, win = geometry
    x = _signal(rng, (2, 4000))
    spec = np.array(jax_stft.stft(jnp.asarray(x), n_fft, hop, win))
    want = np.asarray(jax_stft.istft(jnp.asarray(spec), n_fft, hop, win, length=4000,
                                     method=method))
    got = port_stft.istft(torch.from_numpy(spec), n_fft, hop, win, length=4000, method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x, atol=1e-4)  # perfect reconstruction
    no_length = port_stft.istft(torch.from_numpy(spec), n_fft, hop, win, method=method)
    want_no_length = np.asarray(jax_stft.istft(jnp.asarray(spec), n_fft, hop, win, method=method))
    np.testing.assert_allclose(no_length.numpy(), want_no_length, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("geometry", GEOMETRIES[:2])
@pytest.mark.parametrize("speakers", [False, True])
def test_custom_transforms_match_jax(rng, geometry, speakers):
    n_fft, hop, win = geometry
    cfg = {"n_fft": n_fft, "hop_length": hop, "win_length": win, "center": True}
    x = _signal(rng, (2, 2, 2, 3000) if speakers else (2, 1, 3000))
    want = np.asarray(jax_stft.stft_custom(jnp.asarray(x), Config(cfg)))
    got = port_stft.stft_custom(torch.from_numpy(x), Config(cfg))
    assert got.shape == want.shape == x.shape[:-1] + (n_fft // 2 + 1, 3000 // hop + 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)  # 1/win of the above
    back_want = np.asarray(jax_stft.istft_custom(jnp.asarray(want), 3000, Config(cfg)))
    back = port_stft.istft_custom(got, 3000, Config(cfg))
    np.testing.assert_allclose(back.numpy(), back_want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)
