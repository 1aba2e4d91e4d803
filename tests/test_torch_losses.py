"""The port's losses vs the JAX package's train/losses.py, on the CPU."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.train import losses as jl
from speech_enhancement_torch.train import losses as pl


def _pair(rng, shape, offset=0.0):
    a = (rng.standard_normal(shape) * 0.3 + offset).astype(np.float32)
    return a, torch.from_numpy(a)


@pytest.mark.parametrize("name", ["l1", "mse", "si-sdr", "sisdr"])
def test_waveform_losses_and_gradients_match_jax(rng, name):
    """Value and gradient; the signals carry a DC offset, which the
    reference's SI-SNR keeps (no mean removal)."""
    est, est_t = _pair(rng, (3, 1, 400), offset=0.2)
    tgt, tgt_t = _pair(rng, (3, 1, 400), offset=-0.1)
    est_t.requires_grad_()
    got = pl.get_loss_function(name)(est_t, tgt_t)
    got.backward()
    want, grad = jax.value_and_grad(jl.get_loss_function(name))(jnp.asarray(est),
                                                                jnp.asarray(tgt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(est_t.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-7)


def test_si_snr_keeps_the_mean(rng):
    """The non-zero-mean quirk: adding a DC offset to both signals changes
    the reference SI-SNR (a zero-mean SI-SNR would not move), in both."""
    est, est_t = _pair(rng, (2, 800))
    tgt, tgt_t = _pair(rng, (2, 800))
    base = pl.si_snr(est_t, tgt_t).item()
    shifted = pl.si_snr(est_t + 0.5, tgt_t + 0.5).item()
    assert abs(shifted - base) > 0.1
    np.testing.assert_allclose(shifted, float(jl.si_snr(jnp.asarray(est) + 0.5,
                                                        jnp.asarray(tgt) + 0.5)), rtol=1e-5)


@pytest.mark.parametrize("name", ["psa", "psa-fixed"])
def test_psa_losses_match_jax(rng, name):
    est, est_t = _pair(rng, (2, 9, 11, 2))
    tgt, tgt_t = _pair(rng, (2, 9, 11, 2))
    mix, mix_t = _pair(rng, (2, 9, 11, 2))
    got = pl.get_loss_function(name)(est_t, tgt_t, mix_t).item()
    want = float(jl.get_loss_function(name)(*map(jnp.asarray, (est, tgt, mix))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_spk", [2, 3])
@pytest.mark.parametrize("name", ["mse", "si-sdr"])
def test_pit_matches_jax_and_finds_the_permutation(rng, n_spk, name):
    tgt, tgt_t = _pair(rng, (2, n_spk, 300))
    perm = list(itertools.permutations(range(n_spk)))[-1]
    est = tgt[:, list(perm)] + 0.05 * rng.standard_normal(tgt.shape).astype(np.float32)
    est_t = torch.from_numpy(est).requires_grad_()
    loss, index = pl.pit_loss(est_t, tgt_t, pl.get_loss_function(name))
    loss.backward()

    def jax_loss(e):
        return jl.pit_loss(e, jnp.asarray(tgt), jl.get_loss_function(name))[0]

    want_loss, want_index = jl.pit_loss(jnp.asarray(est), jnp.asarray(tgt),
                                        jl.get_loss_function(name))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-6)
    assert int(index) == int(want_index)
    # the estimate holds the targets in the order ``perm``: est[:, i] ~ tgt[:, perm[i]]
    best = list(itertools.permutations(range(n_spk)))[int(index)]
    assert all(perm[best[j]] == j for j in range(n_spk))
    np.testing.assert_allclose(est_t.grad.numpy(), np.asarray(jax.grad(jax_loss)(
        jnp.asarray(est))), rtol=1e-4, atol=1e-7)


def test_pit_and_factory_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="unknown loss"):
        pl.get_loss_function("no-such-loss")
    with pytest.raises(ValueError, match="cap is 4"):
        pl.pit_loss(torch.zeros(1, 5, 8), torch.zeros(1, 5, 8), pl.mse_loss)
    with pytest.raises(ValueError, match="shapes differ"):
        pl.pit_loss(torch.zeros(1, 2, 8), torch.zeros(1, 2, 9), pl.mse_loss)
