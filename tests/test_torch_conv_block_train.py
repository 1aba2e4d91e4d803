"""The port's fused-block backward vs the JAX package's, on the CPU.

Each plain backward function (the CPU branch of the port's ``enc_bwd_gz`` /
``enc_bwd_dw`` / ``dec_bwd_gz`` / ``dec_bwd_dw``) is held against the JAX
kernel of the same name in interpret mode, at tests/test_conv_block_vjp.py's
sizes, in f32 and bf16. The autograd Functions ``conv_block_train`` /
``deconv_block_train`` are held against the JAX custom VJPs and against
torch autograd of the plain forward. The CUDA kernels run only on a card
(tests/test_torch_cuda.py); here a numpy loop over their packed weights and
split-K partials, with their exact indexing, is held against the plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas.experimental import conv_block as jcb
from speech_enhancement_torch.kernels import conv_block as pk

ENC = dict(batch=2, f_in=16, n_time=40)  # tests/test_conv_block_vjp.py:36
DEC = dict(batch=2, f_in=8, n_time=33)   # tests/test_conv_block_vjp.py:82
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(a, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(a).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def _assert_act_close(got, want, dtype):
    """f32: rtol / atol 1e-5. bf16: both round the same f32 sum once, summed
    in another order, so one bf16 step apart at most: |d| <= 2^-7 |ref| + 1e-3."""
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - want) <= 2**-7 * np.abs(want) + 1e-3).all()


def _assert_dw_close(got, want):
    """f32 weight gradients, in f32 or from bf16 inputs (exact f32
    products): sums of up to B x rows x T ~ 1,300 products of magnitude ~1
    in another order, so an absolute 1e-5 is below their rounding (~5e-5 at
    sums of ~35); rtol / atol 1e-5 of the largest magnitude, as
    tests/test_conv_block_vjp.py scales its gradients."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c2in,c2out", [(8, 16), (2, 16)])
def test_enc_bwd_plain_matches_pallas(rng, dtype, c2in, c2out):
    b, f_in, t = ENC["batch"], ENC["f_in"], ENC["n_time"]
    gy, gy_j = _pair(_normal(rng, (b, f_in // 2 * c2out, t)), dtype)
    z, z_j = _pair(_normal(rng, (b, f_in * c2in, t)), dtype)
    w2 = _normal(rng, (5, 2, c2in, c2out), 0.2)
    shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out)
    got = pk.enc_bwd_gz(gy, torch.from_numpy(w2), **shapes)
    want = jcb._enc_bwd_gz(gy_j, jnp.asarray(w2), interpret=True, **shapes)
    assert got.dtype == gy.dtype
    _assert_act_close(got, want, dtype)
    got = pk.enc_bwd_dw(z, gy, **shapes)
    want = jcb._enc_bwd_dw(z_j, gy_j, interpret=True, **shapes)
    _assert_dw_close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c2x,c2s,c2out", [(8, 8, 8), (4, 6, 16)])
def test_dec_bwd_plain_matches_pallas(rng, dtype, c2x, c2s, c2out):
    b, f_in, t = DEC["batch"], DEC["f_in"], DEC["n_time"]
    gy, gy_j = _pair(_normal(rng, (b, 2 * f_in * c2out, t)), dtype)
    zx, zx_j = _pair(_normal(rng, (b, f_in * c2x, t)), dtype)
    zs, zs_j = _pair(_normal(rng, (b, f_in * c2s, t)), dtype)
    w2 = _normal(rng, (5, 2, c2x + c2s, c2out), 0.2)
    shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    got = pk.dec_bwd_gz(gy, torch.from_numpy(w2), **shapes)
    want = jcb._dec_bwd_gz(gy_j, jnp.asarray(w2), interpret=True, **shapes)
    for g, w in zip(got, want):
        _assert_act_close(g, w, dtype)
    got = pk.dec_bwd_dw(zx, zs, gy, **shapes)
    want = jcb._dec_bwd_dw(zx_j, zs_j, gy_j, interpret=True, **shapes)
    _assert_dw_close(got, want)


def _coeffs(rng, c2):
    return tuple(_normal(rng, c2, 0.1) + base for base in (1.0, 0.0, 0.0))


def _enc_args(rng, c2in=8, c2out=16):
    b, f_in, t = ENC["batch"], ENC["f_in"], ENC["n_time"]
    return ([_normal(rng, (b, f_in * c2in, t), 0.5), _normal(rng, (5, 2, c2in, c2out), 0.2),
             _normal(rng, c2out, 0.1), *_coeffs(rng, c2in), np.array([0.25], np.float32)],
            dict(f_in=f_in, c2in=c2in, c2out=c2out), f_in // 2 * c2out)


def _dec_args(rng, c2x=8, c2s=8, c2out=8):
    b, f_in, t = DEC["batch"], DEC["f_in"], DEC["n_time"]
    return ([_normal(rng, (b, f_in * c2x, t), 0.5), _normal(rng, (b, f_in * c2s, t), 0.5),
             _normal(rng, (5, 2, c2x + c2s, c2out), 0.2), _normal(rng, c2out, 0.1),
             *_coeffs(rng, c2x), np.array([0.25], np.float32), *_coeffs(rng, c2s),
             np.array([0.1], np.float32)],
            dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out), 2 * f_in * c2out)


def _port_train(block):
    if block == "encoder":
        return pk.conv_block_train

    def deconv(x, s, w2, b2, a0, a1, a2, ax, s0, s1, s2, a_s, **shapes):
        return pk.deconv_block_train(x, s, w2, b2, (a0, a1, a2), ax, (s0, s1, s2), a_s,
                                     **shapes)
    return deconv


def _port_plain(block):
    if block == "encoder":
        return lambda *a, **k: pk.fused_conv_block_plain(*a, **k, with_stats=True)

    def deconv(x, s, w2, b2, a0, a1, a2, ax, s0, s1, s2, a_s, **shapes):
        return pk.fused_deconv_block_plain(x, s, w2, b2, (a0, a1, a2), ax, (s0, s1, s2), a_s,
                                           **shapes, with_stats=True)
    return deconv


def _torch_grads(fn, arrays, shapes, g_y, g_p):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, partials = fn(*leaves, **shapes)
    torch.autograd.backward((y, partials), (torch.from_numpy(g_y), torch.from_numpy(g_p)))
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("block", ["encoder", "decoder"])
def test_block_train_grads_match_jax_vjp_and_autograd(rng, block):
    """Every gradient under random cotangents on both outputs, against the
    JAX custom VJP (interpret mode) at tests/test_conv_block_vjp.py's
    tolerance (1e-5 of each gradient's scale), and against torch autograd of
    the plain forward (which also rounds nothing in f32)."""
    arrays, shapes, rows = _enc_args(rng) if block == "encoder" else _dec_args(rng)
    n_time = arrays[0].shape[-1]
    g_y = _normal(rng, (2, rows, n_time))
    g_p = _normal(rng, (2, rows, 8))
    got = _torch_grads(_port_train(block), arrays, shapes, g_y, g_p)
    if block == "encoder":
        def jax_fn(*args):
            return jcb.conv_block_train(shapes["f_in"], shapes["c2in"], shapes["c2out"], True,
                                        *args)
    else:
        def jax_fn(*args):
            return jcb.deconv_block_train(shapes["f_in"], shapes["c2x"], shapes["c2s"],
                                          shapes["c2out"], True, *args)
    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, arrays))
    want = vjp((jnp.asarray(g_y), jnp.asarray(g_p)))
    autograd = _torch_grads(_port_plain(block), arrays, shapes, g_y, g_p)
    assert len(got) == len(want) == len(autograd) == len(arrays)
    for i, (g, w, a) in enumerate(zip(got, want, autograd)):
        w = np.asarray(w)
        assert g.shape == w.shape == a.shape, i
        scale = max(np.abs(w).max(), 1e-8)
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-5, err_msg=f"input {i}")
        np.testing.assert_allclose(g / scale, a / scale, atol=1e-5, err_msg=f"input {i}")


def test_encoder_input_gradient_is_skipped_for_constant_inputs(rng):
    """enc0: no gradient wanted for x or its coefficients -> no g_z (the
    CUDA branch does not launch enc_bwd_gz); dW and db still flow."""
    arrays, shapes, _ = _enc_args(rng, c2in=2)
    leaves = [torch.from_numpy(a) for a in arrays]
    leaves[1].requires_grad_()
    leaves[2].requires_grad_()
    y, partials = pk.conv_block_train(*leaves, **shapes)
    (y.float().sum() + partials.sum()).backward()
    assert leaves[1].grad is not None and leaves[2].grad is not None
    want = _torch_grads(_port_plain("encoder"), arrays, shapes,
                        np.ones(y.shape, np.float32), np.ones(partials.shape, np.float32))
    np.testing.assert_allclose(leaves[1].grad.numpy(), want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(leaves[2].grad.numpy(), want[2], rtol=1e-5, atol=1e-5)


# -- the CUDA kernels' indexing, in numpy -------------------------------------

def _emulate_block(act, w, f_in, f_out, c2, c2out, n_time, decoder):
    """block_gemm.cuh's sum with a raw input (no pointwise, no bias):
    packed w [5, 2, c2out, kp], taps jf -> input row (fo + jf - 2) / 2 for
    fo + jf even (decoder indexing) or 2 fo + jf - 2 (encoder), time tap jt
    -> frame t + jt (decoder) or t - 1 + jt (encoder), zero outside."""
    batch = act.shape[0]
    x = act.reshape(batch, f_in, c2, n_time).astype(np.float64)
    padded = np.zeros((batch, f_in, c2, n_time + 2))
    padded[..., 1:n_time + 1] = x
    y = np.zeros((batch, f_out, c2out, n_time))
    for fo in range(f_out):
        for jf in range(5):
            if decoder and (fo + jf) % 2:
                continue
            fi = (fo + jf - 2) // 2 if decoder else 2 * fo + jf - 2
            if not 0 <= fi < f_in:
                continue
            for jt in range(2):
                frames = np.arange(n_time) + jt + (0 if decoder else -1) + 1
                y[:, fo] += np.einsum("oc,bct->bot", w[jf, jt, :, :c2], padded[:, fi][:, :, frames])
    return y


def _out_row_split(y, c2a):
    """block_gemm.cuh:out_row with y2: joined channels [a_r, s_r, a_i, s_i]
    of y [B, F, C2, T] -> (a [B, F * c2a, T], s [B, F * (C2 - c2a), T])."""
    batch, f, c2, n_time = y.shape
    c_half, ca, c2s = c2 // 2, c2a // 2, c2 - c2a
    a = np.zeros((batch, f, c2a, n_time))
    s = np.zeros((batch, f, c2s, n_time))
    for co in range(c2):
        imag = co >= c_half
        j = co - c_half if imag else co
        if j < ca:
            a[:, :, j + (ca if imag else 0)] = y[:, :, co]
        else:
            s[:, :, j - ca + (c2s // 2 if imag else 0)] = y[:, :, co]
    return a.reshape(batch, f * c2a, n_time), s.reshape(batch, f * c2s, n_time)


def _emulate_dw(regions, gy, f_in, f_out, c2out, n_time, decoder, splits, bk, bm=16):
    """dw_gemm.cuh's bf16 split-K partials [S, 5, 2, C2tot, C2out]. One GEMM
    per (region, output-row parity): its rows are the window of input rows
    an output row m reads (taps in the rows: window row w, channel ci is
    tap jf = w, or 2 w + parity in the decoder), its columns (jt, co), g
    shifted by the time tap. Split s takes the steps [s * steps / S, (s +
    1) * steps / S) of the (b, frame chunk, m) list, m fastest (the
    decoder's chunks start early, so that the partial one comes first); a
    tile of bm window rows skips the steps whose rows all fall outside [0,
    f_in)."""
    batch = gy.shape[0]
    g = gy.reshape(batch, f_out, c2out, n_time).astype(np.float64)
    c2tot = sum(c2 for _, c2, _ in regions)
    off = (bk - n_time % bk) % bk if decoder else 0
    chunks = -(-(n_time + off) // bk)
    k_rows = f_in if decoder else f_out
    steps = batch * chunks * k_rows
    part = np.zeros((splits, 5, 2, c2tot, c2out))
    for z, c2, row0 in regions:
        zr = z.reshape(batch, f_in * c2, n_time).astype(np.float64)
        for parity in ((0, 1) if decoder else (0,)):
            rows = 3 - parity if decoder else 5
            for s in range(splits):
                for step in range(steps * s // splits, steps * (s + 1) // splits):
                    rest, m = divmod(step, k_rows)
                    b, chunk = divmod(rest, chunks)
                    first = (m - 1 + parity if decoder else 2 * m - 2) * c2  # window's first row
                    fo = 2 * m + parity if decoder else m
                    u = np.arange(max(chunk * bk - off, 0), min((chunk + 1) * bk - off, n_time))
                    cols = []
                    for jt in range(2):  # g at u + 1 - jt (encoder), u - jt (decoder)
                        src = u - jt if decoder else u + 1 - jt
                        ok = (src >= 0) & (src < n_time)
                        cols.append(np.where(ok, g[b, fo][:, np.clip(src, 0, n_time - 1)], 0.0))
                    g_t = np.concatenate(cols)  # [(jt, co), frames]
                    for r0 in range(0, rows * c2, bm):
                        r = np.arange(r0, min(r0 + bm, rows * c2))
                        if not (first + r[0] < f_in * c2 and first + r[-1] >= 0):
                            continue
                        ok = (first + r >= 0) & (first + r < f_in * c2)
                        z_t = np.where(ok[:, None],
                                       zr[b][np.clip(first + r, 0, f_in * c2 - 1)][:, u], 0.0)
                        prod = z_t @ g_t.T
                        w, ci = np.divmod(r, c2)
                        jf = 2 * w + parity if decoder else w
                        for jt in range(2):
                            part[s, jf, jt, row0 + ci] += prod[:, jt * c2out:(jt + 1) * c2out]
    return part


@pytest.mark.parametrize("splits", [1, 3])
def test_encoder_backward_kernels_indexing_matches_plain(rng, splits):
    f_in, c2in, c2out, n_time = 8, 6, 10, 21
    gy = _normal(rng, (2, f_in // 2 * c2out, n_time))
    z = _normal(rng, (2, f_in * c2in, n_time))
    w2 = torch.from_numpy(_normal(rng, (5, 2, c2in, c2out), 0.2))
    shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out)
    # the wrapper's packing: taps reversed, input and output swapped
    w, kp = pk._pack_weights(w2.flip(0, 1).transpose(2, 3), torch.float32)
    assert kp == 16 and w.shape == (5, 2, c2in, 16) and not w[..., c2out:].any()
    gz = _emulate_block(gy, w.numpy(), f_in // 2, f_in, c2out, c2in, n_time, decoder=True)
    want = pk.enc_bwd_gz(torch.from_numpy(gy), w2, **shapes)
    np.testing.assert_allclose(gz.reshape(want.shape), want.numpy(), rtol=1e-5, atol=1e-5)
    part = _emulate_dw([(z, c2in, 0)], gy, f_in, f_in // 2, c2out, n_time, False, splits, 16)
    want = pk.enc_bwd_dw(torch.from_numpy(z), torch.from_numpy(gy), **shapes)
    np.testing.assert_allclose(part.sum(0), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("splits", [1, 4])
def test_decoder_backward_kernels_indexing_matches_plain(rng, splits):
    f_in, c2x, c2s, c2out, n_time = 4, 6, 4, 6, 21
    gy = _normal(rng, (2, 2 * f_in * c2out, n_time))
    zx, zs = _normal(rng, (2, f_in * c2x, n_time)), _normal(rng, (2, f_in * c2s, n_time))
    w2 = torch.from_numpy(_normal(rng, (5, 2, c2x + c2s, c2out), 0.2))
    shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    w, _ = pk._pack_weights(w2.flip(0, 1).transpose(2, 3), torch.float32)
    joined = _emulate_block(gy, w.numpy(), 2 * f_in, f_in, c2out, c2x + c2s, n_time,
                            decoder=False)
    want = pk.dec_bwd_gz(torch.from_numpy(gy), w2, **shapes)
    for got, ref in zip(_out_row_split(joined, c2x), want):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)
    part = _emulate_dw([(zx, c2x, 0), (zs, c2s, c2x)], gy, f_in, 2 * f_in, c2out, n_time,
                       True, splits, 16)
    got = pk.joined_from_regions(torch.from_numpy(part.sum(0)), c2x, c2s)
    want = pk.dec_bwd_dw(torch.from_numpy(zx), torch.from_numpy(zs), torch.from_numpy(gy),
                         **shapes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# (f_in, widths, c2out) -> (bm, bn, splits) of DCCRN's twelve blocks
DW_PLANS = {
    "enc0": ((256, (2,), 16), (16, 32, 4096)),
    "enc1": ((128, (16,), 32), (64, 64, 2048)),
    "enc2": ((64, (32,), 64), (64, 64, 683)),
    "enc3": ((32, (64,), 128), (128, 128, 342)),
    "enc4": ((16, (128,), 256), (128, 128, 103)),
    "enc5": ((8, (256,), 256), (128, 128, 52)),
    "dec0": ((4, (256, 256), 256), (128, 128, 26)),
    "dec1": ((8, (256, 256), 128), (128, 128, 52)),
    "dec2": ((16, (128, 128), 64), (128, 128, 205)),
    "dec3": ((32, (64, 64), 32), (64, 64, 410)),
    "dec4": ((64, (32, 32), 16), (32, 32, 410)),
    "dec5": ((128, (16, 16), 2), (32, 8, 683)),
}


@pytest.mark.parametrize("block", sorted(DW_PLANS))
def test_dw_tiles_and_splits_cover_the_model(block):
    """The tile and split rules the wrappers pass to the weight-gradient
    kernels, at the twelve full-width blocks (B = 128, T = 643, bf16): tiles
    of window rows no taller than needed (enc0's ten rows in one of 16),
    about 2048 blocks a launch (4096 for the small tiles), partials
    bounded."""
    (f_in, widths, c2out), plan = DW_PLANS[block]
    decoder = block.startswith("dec")
    bm, bn = pk.dw_tile(widths, c2out, torch.bfloat16, decoder=decoder)
    splits = pk.dw_splits(128, f_in, 643, widths, c2out, bm, bn, torch.bfloat16,
                          decoder=decoder)
    assert (bm, bn, splits) == plan
    assert splits * 10 * sum(widths) * c2out * 4 <= pk._DW_PART_BYTES
    assert pk.dw_tile(widths, c2out, torch.float32, decoder=decoder) == (32, 32)


def test_dw_splits_edges():
    assert pk.dw_splits(1, 2, 10, (2,), 2, 16, 32, torch.bfloat16) == 1  # one step: one split
    # f32: (b, output row, 32-frame chunk) steps over 5 taps x 32 x 32 tiles
    assert pk.dw_splits(128, 8, 643, (256, 256), 256, 32, 32, torch.float32,
                        decoder=True) == 4
    assert pk.dw_splits(128, 256, 643, (2,), 16, 32, 32, torch.float32) == 410


def _realign(lo, hi, s):
    """dw_gemm.cuh:realign word for word: elements [s, s + 8) of lo:hi."""
    w = list(lo) + list(hi)
    x = [w[k + 2] if s & 4 else w[k] for k in range(6)]
    y = [x[k + 1] if s & 2 else x[k] for k in range(5)]
    sh = (s & 1) * 16
    return [hi[k] if s == 8 else ((y[k] | y[k + 1] << 32) >> sh) & 0xFFFFFFFF
            for k in range(4)]


def _mask_frames(v, f0, n):
    """dw_gemm.cuh:mask_frames: zero the elements whose frame is outside [0, n)."""
    return [word & ((0xFFFF if 0 <= f0 + 2 * k < n else 0)
                    | (0xFFFF0000 if 0 <= f0 + 2 * k + 1 < n else 0))
            for k, word in enumerate(v)]


@pytest.mark.parametrize("fs", [0, -1, 600])  # z / encoder g, decoder g, last chunk
@pytest.mark.parametrize("residue", range(8))
def test_dw_staging_realigns_every_residue(residue, fs):
    """The bf16 kernel's staging of one row, mirrored from dw_gemm.cuh
    (issue, store, load): the row's frame fs sits ``residue`` elements into
    its aligned 16-byte chunk; lane c loads chunks c and c + 1, or zeros
    where no wanted frame lies in one, and shifts them by the residue (the
    jt = 1 copy of g, or z) and by the residue + 1 (the jt = 0 copy): frames
    fs ... fs + 64 in order, those outside [0, n_time) zero."""
    n_time, span = 643, 65
    memory = (np.arange(4096) * 7 + 3) % 65521 + 1  # no zero anywhere, frames or not
    row = 1000 + residue - (1000 + fs) % 8  # element of frame 0: frame fs at the residue
    assert (row + fs) % 8 == residue
    aligned = row + fs - residue

    def chunk(k):
        cf = fs - residue + 8 * k
        if not (cf + 8 > max(fs, 0) and cf < min(fs + span, n_time)):
            return [0] * 4
        e = memory[aligned + 8 * k:aligned + 8 * k + 8]
        return [int(e[2 * i]) | int(e[2 * i + 1]) << 16 for i in range(4)]

    lanes = [chunk(c) for c in range(9)]
    for shift in (0, 1):
        got, want = [], []
        for c in range(8):
            f0 = fs + shift + 8 * c
            words = _mask_frames(_realign(lanes[c], lanes[c + 1], residue + shift), f0, n_time)
            got += [half for word in words for half in (word & 0xFFFF, word >> 16)]
            want += [int(memory[row + f]) if 0 <= f < n_time else 0
                     for f in range(f0, f0 + 8)]
        assert got == want


@pytest.mark.parametrize("c2x,c2s,c2out,batch,f_in,n_time,tile", [
    (16, 16, 2, 1, 8, 21, None),     # dec5's g (two channels: one pair), B 1, T < one tile
    (6, 4, 6, 5, 4, 70, None),       # three pairs, ragged batch group and frame tile
    (8, 8, 18, 3, 2, 67, (16, 4)),   # two k16 steps a tap (9 pairs), four row tiles
    (64, 64, 16, 2, 2, 65, (128, 2)),  # the large tile; frame -1 of each segment
])
def test_mma_schedule_matches_plain_decoder_input_gradient(rng, c2x, c2s, c2out, batch, f_in,
                                                            n_time, tile):
    """dec_bwd_gz's bf16 kernel walked in numpy (test_torch_conv_block.py:
    _emulate_mma, the encoder indexing on g as it is) with the wrapper's
    packing of the flipped, transposed weights over the joined output
    channels, split by out_row, against the plain version."""
    from test_torch_conv_block import _emulate_mma
    gy = _normal(rng, (batch, 2 * f_in * c2out, n_time))
    w2 = torch.from_numpy(_normal(rng, (5, 2, c2x + c2s, c2out), 0.2))
    tile = tile or pk.block_tile(c2x + c2s)
    packed, kp = pk._pack_mma_weights(w2.flip(0, 1).transpose(2, 3), tile[0], torch.float32)
    assert kp == 16 * -(-c2out // 16)
    joined = _emulate_mma([(gy.astype(np.float64), None, None, packed.numpy(), c2out)],
                          2 * f_in, f_in, c2x + c2s, n_time, False, True, tile)
    want = pk.dec_bwd_gz(torch.from_numpy(gy), w2, f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    for got, ref in zip(_out_row_split(joined, c2x), want):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("c2in,c2out,batch,f_in,n_time,tile", [
    (2, 16, 3, 16, 70, None),     # enc0: two output channels (one pair), ragged batch group
    (16, 32, 2, 8, 67, None),     # enc1
    (32, 64, 1, 8, 21, None),     # enc2, B 1, T < one frame tile
    (64, 128, 2, 4, 65, None),    # enc3: the 65th frame in a new tile
    (128, 256, 1, 4, 33, None),   # enc4
    (256, 256, 2, 2, 40, None),   # enc5
    (6, 10, 5, 8, 67, None),      # g of 5 pairs, 3 output pairs: ragged K, M and batch group
    (34, 20, 3, 4, 70, (32, 4)),  # 17 output pairs: two row tiles, the last ragged; g's 10
    #                               pairs: two k16 steps, the second ragged
    (20, 36, 2, 4, 130, (16, 4)),  # g's 18 pairs: three k16 steps a tap; frame tiles 64, 64, 2
])
def test_mma_schedule_matches_plain_encoder_input_gradient(rng, c2in, c2out, batch, f_in,
                                                           n_time, tile, pair):
    """enc_bwd_gz's bf16 kernel walked in numpy (test_torch_conv_block.py:
    _emulate_mma, the decoder indexing on g as it is: taps with fo + jf even,
    frames from t0, frame T zero; one output row a block, or row pairs over
    g's rows r - 1 .. r + 1) with the wrapper's packing of the flipped,
    transposed weights over the c2in output channels, against the plain
    version. The weights give g_z of unit variance (as the card tests'), so
    the plain version's f32 sums of up to 2560 terms stay within 1e-5."""
    from test_torch_conv_block import _emulate_mma
    gy = _normal(rng, (batch, f_in // 2 * c2out, n_time))
    w2 = torch.from_numpy(_normal(rng, (5, 2, c2in, c2out), (10 * c2out) ** -0.5))
    tile = tile or pk.block_tile(2 * c2in if pair else c2in)
    packed, kp = pk._pack_mma_weights(w2.flip(0, 1).transpose(2, 3), tile[0], torch.float32,
                                      pair)
    assert kp == 16 * -(-c2out // 16) and packed.shape[1:3] == (3 if pair else 5, kp // 16)
    gz = _emulate_mma([(gy.astype(np.float64), None, None, packed.numpy(), c2out)], f_in // 2,
                      f_in, c2in, n_time, True, True, tile, pair=pair)
    want = pk.enc_bwd_gz(torch.from_numpy(gy), w2, f_in=f_in, c2in=c2in, c2out=c2out)
    np.testing.assert_allclose(gz.reshape(want.shape), want.numpy(), rtol=1e-5, atol=1e-5)
