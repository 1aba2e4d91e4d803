"""The port's fused-block kernels: plain versions vs the JAX Pallas kernels.

The same numpy inputs go through the port's ``fused_conv_block`` /
``fused_deconv_block`` (a CPU tensor selects the plain versions) and the JAX
functions in interpret mode, as tests/test_pallas_conv_block.py runs them,
at f32. The folded complex-BN coefficients and the stats reduction are held
against ``fold_cbn_coeffs`` / ``stats_from_partials``. The CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py); here a numpy loop
over the kernels' packed weight layout, with their tap and parity indexing,
is held against the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas.experimental import conv_block as cb
from speech_enhancement_torch.kernels import conv_block as pk
from speech_enhancement_torch.ops.complex_ops import ComplexBatchNorm, stats_from_partials


def _coeffs(rng, c2):
    return tuple((base + 0.1 * rng.standard_normal(c2)).astype(np.float32)
                 for base in (1.0, 0.0, 0.0))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _enc_inputs(rng, c2in, c2out, batch=2, f_in=16, n_time=40):
    x = rng.standard_normal((batch, f_in * c2in, n_time)).astype(np.float32)
    w2 = (0.2 * rng.standard_normal((5, 2, c2in, c2out))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c2out)).astype(np.float32)
    return x, w2, b2, _coeffs(rng, c2in), 0.25


def _dec_inputs(rng, c2x, c2s, c2out, batch=2, f_in=8, n_time=33):
    x = rng.standard_normal((batch, f_in * c2x, n_time)).astype(np.float32)
    skip = rng.standard_normal((batch, f_in * c2s, n_time)).astype(np.float32)
    w2 = (0.2 * rng.standard_normal((5, 2, c2x + c2s, c2out))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c2out)).astype(np.float32)
    return x, skip, w2, b2, _coeffs(rng, c2x), 0.25, _coeffs(rng, c2s), 0.1


def _assert_outputs(got, want, with_stats):
    """rtol / atol 1e-5, as tests/test_pallas_conv_block.py:65-66. The stats
    partials are f32 sums over T of terms up to ~100, summed in another
    order: a sum near zero keeps the terms' rounding, so their atol is 1e-5
    of the lane's largest magnitude."""
    if not with_stats:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    if with_stats:
        s, s_want = got[1].numpy(), np.asarray(want[1])
        scale = np.abs(s_want).max(axis=(0, 1), keepdims=True)
        assert s.shape == s_want.shape
        assert (np.abs(s - s_want) <= 1e-5 * np.abs(s_want) + 1e-5 * scale).all()


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("c2in,c2out", [(2, 16), (16, 32), (8, 2)])
def test_conv_block_plain_matches_pallas(rng, c2in, c2out, with_stats):
    x, w2, b2, coef, alpha = _enc_inputs(rng, c2in, c2out)
    shapes = dict(f_in=16, c2in=c2in, c2out=c2out, with_stats=with_stats)
    want = cb.fused_conv_block(jnp.asarray(x), jnp.asarray(w2), jnp.asarray(b2),
                               *map(jnp.asarray, coef), alpha, interpret=True, **shapes)
    got = pk.fused_conv_block(*_t((x, w2, b2)), *_t(coef), torch.tensor([alpha]), **shapes)
    _assert_outputs(got, want, with_stats)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("c2x,c2s,c2out", [(16, 16, 8), (8, 8, 2), (4, 6, 16)])
def test_deconv_block_plain_matches_pallas(rng, c2x, c2s, c2out, with_stats):
    x, skip, w2, b2, cx, ax, cs, a_s = _dec_inputs(rng, c2x, c2s, c2out)
    shapes = dict(f_in=8, c2x=c2x, c2s=c2s, c2out=c2out, with_stats=with_stats)
    want = cb.fused_deconv_block(jnp.asarray(x), jnp.asarray(skip), jnp.asarray(w2),
                                 jnp.asarray(b2), tuple(map(jnp.asarray, cx)), ax,
                                 tuple(map(jnp.asarray, cs)), a_s, interpret=True, **shapes)
    got = pk.fused_deconv_block(*_t((x, skip, w2, b2)), _t(cx), torch.tensor([ax]), _t(cs),
                                torch.tensor([a_s]), **shapes)
    _assert_outputs(got, want, with_stats)


def _emulate(regions, bias, f_in, f_out, c2out, n_time, decoder):
    """The CUDA kernels' sum written out in numpy (csrc/block_gemm.cuh):
    packed weights [5, 2, C2out, kp], taps jf -> input row 2 fo + jf - 2
    (encoder) or (fo + jf - 2) / 2 for fo + jf even (decoder), time tap jt
    -> frame t - 1 + jt (encoder) or t + jt (decoder), zero outside."""
    batch = regions[0][0].shape[0]
    y = np.zeros((batch, f_out, c2out, n_time))
    for x, coef, alpha, w, c2 in regions:
        z = pk.pointwise(torch.from_numpy(x).view(batch, f_in, c2, n_time),
                         *_t(coef), alpha).numpy()
        padded = np.zeros((batch, f_in, c2, n_time + 2))
        padded[..., 1:n_time + 1] = z
        for fo in range(f_out):
            for jf in range(5):
                if decoder and (fo + jf) % 2:
                    continue
                fi = (fo + jf - 2) // 2 if decoder else 2 * fo + jf - 2
                if not 0 <= fi < f_in:
                    continue
                for jt in range(2):
                    frames = np.arange(n_time) + jt + (0 if decoder else -1) + 1
                    y[:, fo] += np.einsum("oc,bct->bot", w[jf, jt, :, :c2],
                                          padded[:, fi][:, :, frames])
    return (y + bias[None, None, :, None]).reshape(batch, f_out * c2out, n_time)


@pytest.mark.parametrize("block", ["encoder", "decoder"])
def test_kernel_indexing_over_packed_weights_matches_plain(rng, block):
    if block == "encoder":
        x, w2, b2, coef, alpha = _enc_inputs(rng, 6, 10, n_time=21)
        wp, kp = pk._pack_weights(torch.from_numpy(w2), torch.float32)
        assert kp == 16 and wp.shape == (5, 2, 10, 16) and not wp[..., 6:].any()
        got = _emulate([(x, coef, alpha, wp.numpy(), 6)], b2, 16, 8, 10, 21, False)
        want = pk.fused_conv_block(*_t((x, w2, b2)), *_t(coef), alpha, f_in=16, c2in=6,
                                   c2out=10)
    else:
        x, skip, w2, b2, cx, ax, cs, a_s = _dec_inputs(rng, 6, 4, 6, n_time=21)
        wx, ws = pk._split_joined(torch.from_numpy(w2), 6, 4)
        regions = [(x, cx, ax, pk._pack_weights(wx, torch.float32)[0].numpy(), 6),
                   (skip, cs, a_s, pk._pack_weights(ws, torch.float32)[0].numpy(), 4)]
        got = _emulate(regions, b2, 8, 16, 6, 21, True)
        want = pk.fused_deconv_block(*_t((x, skip, w2, b2)), _t(cx), ax, _t(cs), a_s,
                                     f_in=8, c2x=6, c2s=4, c2out=6)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


def _cbn_stats(rng, c):
    return {"mean_r": 0.1 * rng.standard_normal(c), "mean_i": 0.1 * rng.standard_normal(c),
            "vrr": rng.uniform(0.5, 1.5, c), "vii": rng.uniform(0.5, 1.5, c),
            "vri": rng.uniform(-0.2, 0.2, c)}


@pytest.mark.parametrize("source", ["running", "given"])
def test_fold_coeffs_match_jax(rng, source):
    c = 5
    params = {"gamma_rr": 0.7 + 0.1 * rng.standard_normal(c),
              "gamma_ri": 0.05 * rng.standard_normal(c),
              "gamma_ii": 0.7 + 0.1 * rng.standard_normal(c),
              "beta_r": 0.05 * rng.standard_normal(c), "beta_i": 0.05 * rng.standard_normal(c)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    stats = {k: v.astype(np.float32) for k, v in _cbn_stats(rng, c).items()}
    bn = ComplexBatchNorm(c)
    with torch.no_grad():
        for jax_key, attr in (("gamma_rr", "Wrr"), ("gamma_ri", "Wri"), ("gamma_ii", "Wii"),
                              ("beta_r", "Br"), ("beta_i", "Bi")):
            getattr(bn, attr).copy_(torch.from_numpy(params[jax_key]))
        if source == "running":
            for key, attr in (("mean_r", "RMr"), ("mean_i", "RMi"), ("vrr", "RVrr"),
                              ("vii", "RVii"), ("vri", "RVri")):
                getattr(bn, attr).copy_(torch.from_numpy(stats[key]))
    given = None if source == "running" else {k: torch.from_numpy(v) for k, v in stats.items()}
    got = bn.fold_coeffs(given)
    want = cb.fold_cbn_coeffs({k: jnp.asarray(v) for k, v in params.items()},
                              {k: jnp.asarray(v) for k, v in stats.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c2", [2, 8])
def test_identity_coeffs_pass_through(rng, c2):
    x = torch.from_numpy(rng.standard_normal((2, 3, c2, 5)).astype(np.float32))
    z = pk.pointwise(x, *pk.identity_coeffs(c2), 1.0)
    want = cb._pointwise_ref(jnp.asarray(x.numpy()), *cb.identity_coeffs(c2), 1.0)
    np.testing.assert_array_equal(z.numpy(), np.asarray(want))
    np.testing.assert_array_equal(z.numpy(), x.numpy())


def test_stats_from_partials_matches_jax(rng):
    partials = rng.standard_normal((3, 4 * 6, 8)).astype(np.float32)
    partials[..., 1] = np.abs(partials[..., 1]) * 40 + 10  # sums of squares
    got = stats_from_partials(torch.from_numpy(partials), 6, 3 * 4 * 20)
    want = cb.stats_from_partials(jnp.asarray(partials), 6, 3 * 4 * 20)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_wrappers_take_only_cpu_or_cuda_tensors(rng):
    x, w2, b2, coef, alpha = _enc_inputs(rng, 4, 4)
    meta = [torch.empty(a.shape, device="meta") for a in (x, w2, b2, *coef)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pk.fused_conv_block(*meta, alpha, f_in=16, c2in=4, c2out=4)
    with pytest.raises(ValueError):  # shapes are checked before anything runs
        pk.fused_conv_block(*_t((x, w2, b2)), *_t(coef), alpha, f_in=8, c2in=4, c2out=4)
    before = pk.fused_conv_block.launches
    pk.fused_conv_block(*_t((x, w2, b2)), *_t(coef), alpha, f_in=16, c2in=4, c2out=4)
    assert pk.fused_conv_block.launches == before  # the plain version launches nothing
