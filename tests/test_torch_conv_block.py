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


# -- the bf16 block kernels' schedule (csrc/block_mma.cuh), in numpy ----------

SEG = 64  # frames of a column segment


def _input_row(decoder, fo, jf, f_in):
    """block_mma.cuh:input_row: -1 outside [0, f_in) or for the other parity."""
    if decoder:
        if (fo + jf) % 2:
            return -1
        fi = (fo + jf - 2) // 2
    else:
        fi = 2 * fo + jf - 2
    return fi if 0 <= fi < f_in else -1


def _out_channel(r, m_tile, c_half, bm):
    """block_mma.cuh:out_channel: tile row -> output channel, or -1."""
    h = bm // 2
    j = m_tile * h + (r if r < h else r - h)
    if j >= c_half:
        return -1
    return j if r < h else c_half + j


def _emulate_mma(regions, f_in, f_out, m, n_time, decoder, grad, tile, bias=None, pair=False):
    """mma_kernel's sums block by block, as the kernel walks them. regions:
    (x [B, f_in * c2, T], (a_diag, a_cross, c0) or None, alpha, packed
    weights [m_tiles, taps, nks, 2, bm, 16], c2). A block (frame tile,
    output row fo, group of nb batch items, tile of bm rows) walks the K
    steps (region, live tap, k16 step of 8 interleaved pairs) two to a
    stage, stages each segment's 65 frames from t_first (t0, or t0 - 1 for
    the encoder indexing) with the pair's pointwise (or as they are, grad),
    zero outside [0, T), and multiplies both time taps' weight tiles with
    rows n + jt. With ``pair`` (row pairs) a block is output rows 2 r and
    2 r + 1, the tile's halves, and its taps the input rows r - 1 + d
    (decoder indexing, d < 3) or 4 r - 2 + d (encoder, d < 7). Returns y
    [B, f_out, m, T] (+ bias)."""
    bm, nb = tile
    hrows = bm // 2 if pair else bm  # tile rows of one output row
    batch = regions[0][0].shape[0]
    m_tiles = -(-(m // 2) // (hrows // 2))
    y = np.zeros((batch, f_out, m, n_time))
    for r in range(hrows):  # the stats rule: a row's partner lies in the same tile
        pr = r + hrows // 2 if r < hrows // 2 else r - hrows // 2
        for mt in range(m_tiles):
            co, cp = _out_channel(r, mt, m // 2, hrows), _out_channel(pr, mt, m // 2, hrows)
            assert (co < 0) == (cp < 0) and (co < 0 or (co + m // 2) % m == cp)

    def tap_row(blk, jf):
        if pair:
            fi = (blk - 1 if decoder else 4 * blk - 2) + jf
            return fi if 0 <= fi < f_in else -1
        return _input_row(decoder, blk, jf, f_in)

    n_taps = (3 if decoder else 7) if pair else 5

    for t0 in range(0, n_time, SEG):
        frames = (t0 if decoder else t0 - 1) + np.arange(SEG + 1)
        inside = (frames >= 0) & (frames < n_time)
        fc = np.clip(frames, 0, n_time - 1)
        n_valid = min(SEG, n_time - t0)
        for blk in range(f_out // 2 if pair else f_out):
            live = [jf for jf in range(n_taps) if tap_row(blk, jf) >= 0]
            steps = [(reg, jf, ks) for reg, (*_, w, _c2) in enumerate(regions) for jf in live
                     for ks in range(w.shape[2])]
            for bg in range(-(-batch // nb)):
                for mt in range(m_tiles):
                    acc = np.zeros((bm, nb, SEG))
                    for s0 in range(0, len(steps), 2):  # a stage: two k16 steps
                        for reg, jf, ks in steps[s0:s0 + 2]:
                            x, coef, alpha, w, c2 = regions[reg]
                            c = c2 // 2
                            fi = tap_row(blk, jf)
                            z = np.zeros((nb, SEG + 1, 16))  # [segment][frame][slot]
                            for sg in range(nb):
                                b = bg * nb + sg
                                for pp in range(8):
                                    j = ks * 8 + pp
                                    if b >= batch or j >= c:
                                        continue
                                    vr = x[b, fi * c2 + j, fc]
                                    vi = x[b, fi * c2 + c + j, fc]
                                    if not grad:
                                        ad, ac, c0 = coef
                                        zr = ad[j] * vr + ac[j] * vi + c0[j]
                                        zi = ad[c + j] * vi + ac[c + j] * vr + c0[c + j]
                                        vr = np.where(zr >= 0, zr, alpha * zr)
                                        vi = np.where(zi >= 0, zi, alpha * zi)
                                    z[sg, :, 2 * pp] = np.where(inside, vr, 0.0)
                                    z[sg, :, 2 * pp + 1] = np.where(inside, vi, 0.0)
                            for jt in range(2):
                                acc += np.einsum("mk,snk->msn", w[mt, jf, ks, jt],
                                                 z[:, jt:jt + SEG])
                    for r in range(bm):  # the epilogue
                        half, rr = divmod(r, hrows)
                        co = _out_channel(rr, mt, m // 2, hrows)
                        fo = 2 * blk + half if pair else blk
                        for sg in range(nb):
                            b = bg * nb + sg
                            if co >= 0 and b < batch:
                                y[b, fo, co, t0:t0 + n_valid] = acc[r, sg, :n_valid]
    return y if bias is None else y + bias[None, None, :, None]


def _stats(y):
    """The stats partials of y [B, F, C2, T] (lanes sum y, sum y^2, sum y * partner)."""
    partner = np.concatenate([y[:, :, y.shape[2] // 2:], y[:, :, :y.shape[2] // 2]], axis=2)
    sums = np.stack([y.sum(-1), (y * y).sum(-1), (y * partner).sum(-1)], axis=-1)
    out = np.zeros(sums.shape[:-1] + (8,))
    out[..., :3] = sums
    return out.reshape(y.shape[0], -1, 8)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("c2x,c2s,c2out,batch,f_in,n_time,tile", [
    (16, 16, 2, 1, 8, 21, None),     # dec5's channels, B 1, T < one frame tile
    (6, 4, 6, 5, 4, 70, None),       # pairs not a multiple of 8, ragged groups and frame tile
    (8, 6, 34, 3, 2, 67, (32, 4)),   # two row tiles, the last one ragged
    (32, 32, 64, 2, 2, 65, (64, 2)),  # two k16 steps a tap: the 65th frame in a new tile
    (8, 8, 16, 3, 2, 33, (128, 2)),   # the large tile, mostly empty rows
])
def test_mma_schedule_matches_plain_decoder_block(rng, c2x, c2s, c2out, batch, f_in, n_time,
                                                   tile, pair):
    """The forward's bf16 kernel walked in numpy with the wrapper's packing
    (pair-interleaved K, stages of two k16 steps, nb batch items a block,
    the row tile of block_tile unless given; one output row a block, or
    row pairs) against the plain version."""
    x, skip, w2, b2, cx, ax, cs, a_s = _dec_inputs(rng, c2x, c2s, c2out, batch=batch,
                                                   f_in=f_in, n_time=n_time)
    tile = tile or pk.block_tile(2 * c2out if pair else c2out)
    wx, ws = pk._split_joined(torch.from_numpy(w2), c2x, c2s)
    regions = []
    for act, coef, alpha, w, c2 in ((x, cx, ax, wx, c2x), (skip, cs, a_s, ws, c2s)):
        packed, kp = pk._pack_mma_weights(w, tile[0], torch.float32, pair)
        assert kp == 16 * -(-c2 // 16) and packed.shape[1:3] == (3 if pair else 5, kp // 16)
        regions.append((act.astype(np.float64), coef, alpha, packed.numpy(), c2))
    y = _emulate_mma(regions, f_in, 2 * f_in, c2out, n_time, True, False, tile, b2, pair)
    want, partials = pk.fused_deconv_block(*_t((x, skip, w2, b2)), _t(cx), ax, _t(cs), a_s,
                                           f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out,
                                           with_stats=True)
    np.testing.assert_allclose(y.reshape(want.shape), want.numpy(), rtol=1e-5, atol=1e-5)
    s, s_want = _stats(y), partials.numpy()
    scale = np.abs(s_want).max(axis=(0, 1), keepdims=True)
    assert (np.abs(s - s_want) <= 1e-5 * np.abs(s_want) + 1e-5 * scale).all()


# DCCRN's encoder widths (c2in -> c2out, enc0 to enc5), then ragged shapes: a
# partial batch group, frame tiles of 21, 67 and 65 frames (T < one tile, one
# frame past a tile), pairs not a multiple of 8 (c2in 6, 20), output widths
# not a multiple of 16 (10, 34) and two row tiles with the last one ragged
ENC_MMA_SHAPES = [  # c2in, c2out, batch, f_in, n_time, tile (None: block_tile's)
    (2, 16, 3, 16, 70, None), (16, 32, 2, 8, 67, None), (32, 64, 1, 8, 21, None),
    (64, 128, 2, 4, 65, None), (128, 256, 1, 4, 33, None), (256, 256, 2, 4, 40, None),
    (6, 10, 5, 8, 67, None), (20, 34, 3, 4, 65, (32, 4)), (2, 2, 2, 4, 70, (16, 4)),
]


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("c2in,c2out,batch,f_in,n_time,tile", ENC_MMA_SHAPES)
def test_mma_schedule_matches_plain_encoder_block(rng, c2in, c2out, batch, f_in, n_time, tile,
                                                  with_stats, pair):
    """The encoder block's bf16 kernel walked in numpy (the encoder indexing:
    taps jf read input rows 2 fo + jf - 2, frames from t0 - 1, where frame -1
    stages as zero after the pointwise, the causal pad) with the wrapper's
    packing (pair-interleaved K: enc0's one pair fills one of a k16 step's
    eight slots, the rest zero; one output row a block, or row pairs over
    seven taps), against the plain version with and without stats."""
    x, w2, b2, coef, alpha = _enc_inputs(rng, c2in, c2out, batch=batch, f_in=f_in,
                                         n_time=n_time)
    tile = tile or pk.block_tile(2 * c2out if pair else c2out)
    packed, kp = pk._pack_mma_weights(torch.from_numpy(w2), tile[0], torch.float32, pair,
                                      decoder=False)
    assert kp == 16 * -(-c2in // 16) and packed.shape[1:3] == (7 if pair else 5, kp // 16)
    regions = [(x.astype(np.float64), coef, alpha, packed.numpy(), c2in)]
    y = _emulate_mma(regions, f_in, f_in // 2, c2out, n_time, False, False, tile, b2, pair)
    got = pk.fused_conv_block(*_t((x, w2, b2)), *_t(coef), torch.tensor([alpha]), f_in=f_in,
                              c2in=c2in, c2out=c2out, with_stats=with_stats)
    want = got[0] if with_stats else got
    np.testing.assert_allclose(y.reshape(want.shape), want.numpy(), rtol=1e-5, atol=1e-5)
    if with_stats:
        s, s_want = _stats(y), got[1].numpy()
        scale = np.abs(s_want).max(axis=(0, 1), keepdims=True)
        assert (np.abs(s - s_want) <= 1e-5 * np.abs(s_want) + 1e-5 * scale).all()


# (row, block) -> (GEMM output channels, tile) at DCCRN's twelve blocks: row 4
# (the decoder forward) has c2out rows (twice that for its row pairs, dec2 to
# dec5), row 7 (its input gradient) c2x + c2s, row 3 (the encoder forward)
# c2out, row 5 (its input gradient) c2in
MMA_TILES = {
    ("fwd", "dec0"): (256, (128, 2)), ("fwd", "dec1"): (128, (128, 2)),
    ("fwd", "dec2"): (64, (128, 2)), ("fwd", "dec3"): (32, (64, 2)),
    ("fwd", "dec4"): (16, (32, 4)), ("fwd", "dec5"): (2, (16, 4)),
    ("gz", "dec0"): (512, (128, 2)), ("gz", "dec1"): (512, (128, 2)),
    ("gz", "dec2"): (256, (128, 2)), ("gz", "dec3"): (128, (128, 2)),
    ("gz", "dec4"): (64, (64, 2)), ("gz", "dec5"): (32, (32, 4)),
    ("enc_fwd", "enc0"): (16, (32, 4)), ("enc_fwd", "enc1"): (32, (64, 2)),
    ("enc_fwd", "enc2"): (64, (128, 2)), ("enc_fwd", "enc3"): (128, (128, 2)),
    ("enc_fwd", "enc4"): (256, (128, 2)), ("enc_fwd", "enc5"): (256, (128, 2)),
    ("enc_gz", "enc0"): (2, (16, 4)), ("enc_gz", "enc1"): (16, (32, 4)),
    ("enc_gz", "enc2"): (32, (64, 2)), ("enc_gz", "enc3"): (64, (128, 2)),
    ("enc_gz", "enc4"): (128, (128, 2)), ("enc_gz", "enc5"): (256, (128, 2)),
}
PAIRED = {("fwd", "dec2"), ("fwd", "dec3"), ("fwd", "dec4"), ("fwd", "dec5"),
          ("enc_fwd", "enc0"), ("enc_fwd", "enc1"), ("enc_fwd", "enc2"),
          ("enc_gz", "enc0"), ("enc_gz", "enc1"), ("enc_gz", "enc2"), ("enc_gz", "enc3")}


@pytest.mark.parametrize("row,block", sorted(MMA_TILES))
def test_block_tile_rule_at_dccrn(row, block):
    """The tile and row pairs the wrappers pick at the twenty-four (row,
    block) launches of DCCRN's decoder and encoder: every staged weight step
    serves 128 or 256 frames, the small GEMMs keep all eight warps busy on
    32 frames each or take row pairs, and the grid's batch groups fit at
    bench.py's and serving's batches."""
    m, tile = MMA_TILES[(row, block)]
    pair = row != "gz" and pk.block_pair(m)  # row 7 takes no pairs
    assert pk.block_tile(2 * m if pair else m) == tile
    assert pair == ((row, block) in PAIRED)
    bm, nb = tile
    assert bm >= min(m, 16) and (bm // 2) * -(-(m // 2) // (bm // 2)) >= m // 2
    for batch in (128, 192):
        assert -(-batch // nb) * -(-(m // 2) // (bm // 2)) <= 65535


def test_pack_mma_weights_layout(rng):
    """Tile row r of tile t is output channel t * bm/2 + r (r < bm/2) or its
    imaginary partner; slot 2p + h of k16 step s is input channel h * K/2 +
    8 s + p; zero past both. K = 20: 10 pairs, two k16 steps, the second
    ragged; K = 2 (enc0's input): one pair in slots 0 and 1 of one step."""
    for k, m, bm, nks in ((20, 6, 16, 2), (2, 16, 16, 1)):
        w = torch.from_numpy(rng.standard_normal((5, 2, k, m)).astype(np.float32))
        packed, kp = pk._pack_mma_weights(w, bm, torch.float32)
        assert packed.shape == (1, 5, nks, 2, bm, 16) and kp == 16 * nks
        c, half = k // 2, m // 2
        for jf, s, jt, r, slot in np.ndindex(5, nks, 2, bm, 16):
            co = _out_channel(r, 0, half, bm)
            p, h = divmod(slot, 2)
            ci = 8 * s + p
            want = 0.0 if co < 0 or ci >= c else float(w[jf, jt, h * c + ci, co])
            assert float(packed[0, jf, s, jt, r, slot]) == want


# -- the staging of one unit (block_mma.cuh: load_unit, store_unit), mirrored --

def _ld_chunk(memory, start, k, ok, f0, s, span, n_time):
    """ld_pred of chunk k around frame f0 of a row: zeros unless it holds a
    frame of [max(f0, 0), min(f0 + span, T))."""
    cf = f0 - s + 8 * k
    if not (ok and cf < min(f0 + span, n_time) and cf + 8 > max(f0, 0)):
        return [0] * 4
    e = memory[start - s + 8 * k:start - s + 8 * k + 8]
    return [int(e[2 * i]) | int(e[2 * i + 1]) << 16 for i in range(4)]


def _stage_unit(memory, row_r, row_i, f0, u, n_time):
    """One unit of the input gradient's staging: the rows' frames f0 ... f0
    + 7 (u = 7: and f0 + 8) of a complex pair -> {row within the segment's
    8 u ...: word (real low, imaginary high)}, the words rotated by u and
    stored at rows (i + u) % 8 as the kernel does."""
    from test_torch_conv_block_train import _mask_frames, _realign
    span = 9 if u == 7 else 8
    start_r, start_i = row_r + f0, row_i + f0
    s_r, s_i = start_r % 8, start_i % 8
    lo_r, hi_r = (_ld_chunk(memory, start_r, k, True, f0, s_r, span, n_time) for k in (0, 1))
    lo_i, hi_i = (_ld_chunk(memory, start_i, k, True, f0, s_i, span, n_time) for k in (0, 1))
    vr = _realign(lo_r, hi_r, s_r)
    vi = _realign(lo_i, hi_i, s_i)
    words = []
    for k in range(4):
        words.append((vr[k] & 0xFFFF) | (vi[k] & 0xFFFF) << 16)  # __byte_perm 0x5410
        words.append(vr[k] >> 16 | (vi[k] & 0xFFFF0000))        # __byte_perm 0x7632
    words = [w if 0 <= f0 + e < n_time else 0 for e, w in enumerate(words)]
    for sh in (1, 2, 4):  # the rotation by u: rot[i] = words[(i + u) % 8]
        words = [words[(i + sh) % 8] if u & sh else words[i] for i in range(8)]
    stored = {(i + u) % 8: words[i] for i in range(8)}  # step i: row (i + u) % 8
    if u == 7:
        er = hi_r[s_r >> 1] >> (16 * (s_r & 1)) & 0xFFFF  # block_mma.cuh:element
        ei = hi_i[s_i >> 1] >> (16 * (s_i & 1)) & 0xFFFF
        stored[8] = er | ei << 16 if 0 <= f0 + 8 < n_time else 0
    return stored


@pytest.mark.parametrize("f0,u", [(-1, 0), (7, 1), (56, 7), (639, 7), (632, 0), (640, 7)])
@pytest.mark.parametrize("residue", range(8))
def test_mma_staging_realigns_every_residue(residue, f0, u):
    """A unit of the decoder kernels' staging, mirrored from block_mma.cuh:
    the real row's frame f0 sits ``residue`` elements into its 16-byte
    chunk, the imaginary row (c rows of T = 643 frames later) at another
    residue; the unit's words hold frame f0 + row's (real, imaginary) pair,
    zero outside [0, T), the 65th frame of a segment included (u = 7)."""
    n_time, c = 643, 3
    memory = (np.arange(1 << 14) * 7 + 3) % 65521 + 1  # no zero anywhere, frames or not
    row_r = 4000 + residue - (4000 + f0) % 8  # element of frame 0 of the real row
    row_i = row_r + c * n_time
    assert (row_r + f0) % 8 == residue
    stored = _stage_unit(memory, row_r, row_i, f0, u, n_time)
    assert sorted(stored) == list(range(9 if u == 7 else 8))
    for e, word in stored.items():
        f = f0 + e
        want = (int(memory[row_r + f]) | int(memory[row_i + f]) << 16
                if 0 <= f < n_time else 0)
        assert word == want, (e, f)


@pytest.mark.parametrize("nb", [2, 4])
def test_mma_staging_units_cover_the_stage_and_spread_over_banks(nb):
    """Units q = ur * 256 + tid (frames 8 u.. with u = q % 8, pair q / 8 % 8
    of k16 step q / 64 % 2, segment q / 128) cover every (segment, frame
    0..64, pair slot) of a stage once (the 65th frame by u = 7); each warp's
    loads read four rows, eight lanes on consecutive 16-byte chunks of
    each, and each of its word stores hits 32 distinct banks (pitch 40
    elements)."""
    ks = 2  # k16 steps a stage
    pitch_words, zrows = (16 * ks + 8) // 2, SEG + 1
    seen = set()
    for ur in range(nb * ks // 4):
        for warp in range(8):
            rows = {}
            for lane in range(32):
                q = ur * 256 + warp * 32 + lane
                rows.setdefault(((q >> 6) % ks, (q >> 3) & 7, q // (64 * ks)), []).append(q & 7)
            assert len(rows) == 4 and all(us == list(range(8)) for us in rows.values())
            for i in range(8):
                banks = set()
                for lane in range(32):
                    q = ur * 256 + warp * 32 + lane
                    u, pp, kk, sg = q & 7, (q >> 3) & 7, (q >> 6) % ks, q // (64 * ks)
                    frame = 8 * u + (i + u) % 8
                    banks.add(((sg * zrows + frame) * pitch_words + kk * 8 + pp) % 32)
                    seen.add((sg, frame, kk, pp))
                    if u == 7 and i == 0:
                        seen.add((sg, SEG, kk, pp))
                assert len(banks) == 32
    assert seen == {(sg, f, kk, pp) for sg in range(nb) for f in range(SEG + 1)
                    for kk in range(ks) for pp in range(8)}
