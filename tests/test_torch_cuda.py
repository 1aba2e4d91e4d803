"""The port on a CUDA card: each kernel vs its plain version, and the small
DCCRN on the card vs the same weights on the CPU.

Marked ``cuda``; every test skips (from the fixture) without a card. The file
imports neither JAX nor the JAX package, so on a GPU host without JAX it
runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from speech_enhancement_torch.config import Config, with_defaults
from speech_enhancement_torch.kernels import conv_block as cb
from speech_enhancement_torch.kernels.conv_block import (fused_conv_block, fused_conv_block_plain,
                                                         fused_deconv_block,
                                                         fused_deconv_block_plain)
from speech_enhancement_torch.kernels.masking import mask_e_kernel, mask_e_plain, mask_e_ref
from speech_enhancement_torch.kernels.stft import stft_kernel, stft_plain
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models.dccrn import _stft_bases
from speech_enhancement_torch.train.evaluate import evaluate_utterance
from speech_enhancement_torch.train.solver import get_optimizer, train_step

pytestmark = pytest.mark.cuda

SMALL = {"name": "dccrn", "kernel_num": [16, 32, 64], "rnn_units": 64, "dtype": "float32"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)


@pytest.mark.parametrize("total", [64600, 7000])  # 643 frames; 67 (ragged tile)
def test_stft_kernel_matches_plain(card, total):
    basis = torch.from_numpy(_stft_bases(400, 512)[0]).to(card)
    x = _randn((3, total), 0, card)
    before = stft_kernel.launches
    got = stft_kernel(x, basis, 100, 400)
    want = stft_plain(x, basis, 100, 400)
    torch.cuda.synchronize()
    assert stft_kernel.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)  # tests/test_pallas.py:22


# (B, T): the split-f32 kernel (stft_tf32x3) at one DCCRN window (B 1: one
# batch item a block), a ragged last row tile whose block crosses two batch
# items (67 frames an item: three pieces in a block), 643-frame items with a
# block across two of them; T % 4 != 0 takes the first design
@pytest.mark.parametrize("batch,total,design", [(1, 64600, "tc"), (3, 7000, "tc"),
                                                (5, 64600, "tc"), (3, 7002, "simt")])
def test_stft_kernel_designs_match_plain(card, batch, total, design):
    from speech_enhancement_torch.kernels.stft import stft_design, tc_plan
    basis = torch.from_numpy(_stft_bases(400, 512)[0]).to(card)
    x = _randn((batch, total), total + batch, card)
    before = stft_kernel.launches
    got = stft_kernel(x, basis, 100, 400)
    want = stft_plain(x, basis, 100, 400)
    torch.cuda.synchronize()
    assert stft_kernel.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)  # tests/test_pallas.py:22
    taken, plan = stft_design(batch, total, 100, 400, basis.shape[1])
    assert taken == design
    if design == "tc":
        assert plan == tc_plan(batch, total, 100, 400, basis.shape[1],
                               smem_limit=_card_plan_args(card)[1])
    assert stft_design(batch, total, 100, 400, basis.shape[1], aligned=False)[0] == "simt"


@pytest.mark.parametrize("shape", [(4, 257, 643), (1, 3, 5)])  # second: n % 4 != 0
def test_mask_e_kernel_matches_plain(card, shape):
    arrays = [_randn(shape, seed, card) for seed in range(4)]
    before = mask_e_kernel.launches
    got = mask_e_kernel(*arrays)
    want = mask_e_plain(*arrays)
    torch.cuda.synchronize()
    assert mask_e_kernel.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)  # same f32 formula


def test_kernels_reject_what_they_do_not_take(card):
    basis = torch.from_numpy(_stft_bases(400, 512)[0]).to(card)
    x = _randn((2, 4000), 0, card)
    with pytest.raises(TypeError):
        stft_kernel(x.double(), basis.double(), 100, 400)
    with pytest.raises(ValueError):
        stft_kernel(_randn((4000, 2), 0, card).t(), basis, 100, 400)  # not contiguous
    flat = _randn((4 * 12 + 1,), 1, card)
    misaligned = flat[1:].view(4, 12)  # 4-byte offset: no 16-byte loads
    with pytest.raises(ValueError):
        mask_e_kernel(misaligned, misaligned, misaligned, misaligned)
    with pytest.raises(TypeError):
        mask_e_kernel(*([torch.zeros(2, 3, device=card, dtype=torch.bfloat16)] * 4))


def test_small_dccrn_on_card_matches_cpu(card):
    """Kernels on the card vs plain versions on the CPU (which the CPU tests
    hold against the JAX package), same seeded weights, f32."""
    model_card, spec = build_model(Config(SMALL), device=card,
                                   generator=torch.Generator().manual_seed(5))
    model_cpu, _ = build_model(Config(SMALL), device="cpu",
                               generator=torch.Generator().manual_seed(5))
    cfg = with_defaults(Config({"model": {"name": "dccrn", "segment": 0.25,
                                          "win_length": 512},
                                "dset": {"norm": "z-score"}}))
    rng = np.random.default_rng(2)
    mixture = (0.1 * rng.standard_normal((2, 1, 9000))).astype(np.float32)
    before = (stft_kernel.launches, mask_e_kernel.launches)
    got = evaluate_utterance(mixture, model_card, spec, cfg, lengths=[9000, 7000], device=card)
    assert (stft_kernel.launches, mask_e_kernel.launches) == (before[0] + 1, before[1] + 1)
    want = evaluate_utterance(mixture, model_cpu, spec, cfg, lengths=[9000, 7000],
                              device="cpu")
    assert got.shape == want.shape == mixture.shape and np.isfinite(got).all()
    std = float(mixture.std())
    np.testing.assert_allclose(got, want, atol=2e-4 * std)  # the parity bound, denormalised


def _block_inputs(seed, dev, dtype, batch, f_in, c2_ins, c2out, n_time):
    """Activations per input region, HWIO weights, bias, coefficients and
    slopes, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    acts = [t(rng.standard_normal((batch, f_in * c2, n_time))).to(dtype) for c2 in c2_ins]
    w2 = t(rng.standard_normal((5, 2, sum(c2_ins), c2out)) / np.sqrt(10 * sum(c2_ins)))
    b2 = t(0.1 * rng.standard_normal(c2out))
    coefs = [(t(1 + 0.1 * rng.standard_normal(c2)), t(0.1 * rng.standard_normal(c2)),
              t(0.1 * rng.standard_normal(c2))) for c2 in c2_ins]
    alphas = [t(rng.uniform(0.1, 0.4, 1)) for _ in c2_ins]
    return acts, w2, b2, coefs, alphas


def _assert_block_close(got, want, with_stats, dtype):
    """bf16: both paths round the same f32 sums once, in another summation
    order: |dy| <= 2^-7 |y| + 1e-3. f32: 1e-4 relative, 1e-5 absolute.
    Stats partials (f32, atomics across frame tiles): 1e-4 of each lane's
    largest magnitude (1e-3 in bf16, where a flipped rounding of an
    activated input moves a sum)."""
    if with_stats:
        (y, s), (y_want, s_want) = got, want
        scale = s_want.abs().amax(dim=(0, 1), keepdim=True) + 1e-6
        rel = 1e-3 if dtype == torch.bfloat16 else 1e-4
        assert ((s - s_want).abs() <= rel * scale).all(), (s - s_want).abs().max()
    else:
        y, y_want = got, want
    assert y.dtype == y_want.dtype == dtype and y.shape == y_want.shape
    y, y_want = y.float(), y_want.float()
    if dtype == torch.bfloat16:
        assert ((y - y_want).abs() <= 2**-7 * y_want.abs() + 1e-3).all(), (y - y_want).abs().max()
    else:
        torch.testing.assert_close(y, y_want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2in,c2out,n_time", [
    (2, 16, 2, 16, 70),    # enc0's channels (K = 2 padded to 16), ragged frame tile
    (1, 8, 16, 32, 67),    # B = 1
    (1, 4, 64, 256, 65),   # two tiles of output channels
])
def test_conv_block_kernel_matches_plain(card, with_stats, dtype, batch, f_in, c2in, c2out,
                                         n_time):
    (x,), w2, b2, (coef,), (alpha,) = _block_inputs(0, card, dtype, batch, f_in, (c2in,),
                                                    c2out, n_time)
    shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out, with_stats=with_stats)
    before = fused_conv_block.launches
    got = fused_conv_block(x, w2, b2, *coef, alpha, **shapes)
    want = fused_conv_block_plain(x, w2, b2, *coef, alpha, **shapes)
    torch.cuda.synchronize()
    assert fused_conv_block.launches == before + 1
    _assert_block_close(got, want, with_stats, dtype)


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2x,c2s,c2out,n_time", [
    (1, 8, 16, 16, 2, 67),     # dec5's channels, B = 1, ragged frame tile
    (2, 4, 32, 32, 64, 70),    # 64 output channels: the fourth tile height
    (1, 4, 64, 32, 256, 65),   # trunk and skip of different widths, two channel tiles
])
def test_deconv_block_kernel_matches_plain(card, with_stats, dtype, batch, f_in, c2x, c2s,
                                           c2out, n_time):
    (x, s), w2, b2, (cx, cs), (ax, a_s) = _block_inputs(1, card, dtype, batch, f_in,
                                                        (c2x, c2s), c2out, n_time)
    shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out, with_stats=with_stats)
    before = fused_deconv_block.launches
    got = fused_deconv_block(x, s, w2, b2, cx, ax, cs, a_s, **shapes)
    want = fused_deconv_block_plain(x, s, w2, b2, cx, ax, cs, a_s, **shapes)
    torch.cuda.synchronize()
    assert fused_deconv_block.launches == before + 1
    _assert_block_close(got, want, with_stats, dtype)


def test_block_kernels_reject_what_they_do_not_take(card):
    (x, s), w2, b2, (cx, cs), (ax, a_s) = _block_inputs(2, card, torch.float32, 2, 8,
                                                        (16, 16), 8, 20)
    enc = dict(f_in=8, c2in=16, c2out=8)
    w_enc = w2[:, :, :16].contiguous()
    before = fused_conv_block.launches, fused_deconv_block.launches
    with pytest.raises(TypeError):
        fused_conv_block(x.double(), w_enc, b2, *cx, ax, **enc)
    with pytest.raises(TypeError):  # trunk and skip of different dtypes
        fused_deconv_block(x, s.bfloat16(), w2, b2, cx, ax, cs, a_s, f_in=8, c2x=16, c2s=16,
                           c2out=8)
    strided = torch.empty(2, 8 * 16, 40, device=card)[:, :, ::2]
    strided.copy_(x)
    with pytest.raises(ValueError):
        fused_conv_block(strided, w_enc, b2, *cx, ax, **enc)
    w_grad = w_enc.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="conv_block_train"):
        fused_conv_block(x, w_grad, b2, *cx, ax, **enc)
    with torch.no_grad():  # no autograd: the kernel runs
        fused_conv_block(x, w_grad, b2, *cx, ax, **enc)
    assert (fused_conv_block.launches, fused_deconv_block.launches) == (before[0] + 1,
                                                                       before[1])


def test_small_fused_dccrn_on_card_matches_cpu(card):
    """use_fused_blocks=True: every block kernel on the card vs the plain
    versions on the CPU (held against the JAX package's fused DCCRN by the
    CPU tests), same seeded weights, f32."""
    cfg = Config(dict(SMALL, use_fused_blocks=True))
    model_card, _ = build_model(cfg, device=card, generator=torch.Generator().manual_seed(5))
    model_cpu, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    wav = (0.1 * np.random.default_rng(3).standard_normal((2, 8000))).astype(np.float32)
    before = fused_conv_block.launches, fused_deconv_block.launches
    with torch.inference_mode():
        got = model_card(torch.from_numpy(wav).to(card)).cpu().numpy()
        want = model_cpu(torch.from_numpy(wav)).numpy()
    assert (fused_conv_block.launches, fused_deconv_block.launches) == (before[0] + 3,
                                                                       before[1] + 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4)  # the parity bound


def _assert_gz_close(got, want, dtype):
    """bf16: one bf16 step apart at most, as the forward blocks; f32: 1e-4
    relative, 1e-5 absolute (f32 sums in another order)."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        assert ((got - want).abs() <= 2**-7 * want.abs() + 1e-3).all(), (got - want).abs().max()
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _assert_dw_close(got, want):
    """f32 sums over B x rows x T products in another order (split-K
    partials summed by torch.sum): within 1e-4 of the largest magnitude."""
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    scale = want.abs().max().item() + 1e-12
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2in,c2out,n_time", [
    (2, 16, 2, 16, 70),    # enc0's channels, ragged frame chunk
    (1, 8, 16, 32, 67),
    (2, 8, 64, 256, 130),  # several channel tiles
    (1, 256, 2, 16, 643),  # enc0 at the real frame count: rows at every 16-byte residue
    (1, 16, 128, 256, 643),  # enc4
    (2, 8, 6, 16, 100),    # windows of 5 x 6 rows: not a multiple of the tile
    (2, 2, 16, 32, 70),    # f_in 2: windows mostly outside the input
])
def test_encoder_backward_kernels_match_plain(card, dtype, batch, f_in, c2in, c2out, n_time):
    rng = np.random.default_rng(7)
    gy = torch.from_numpy(rng.standard_normal((batch, f_in // 2 * c2out, n_time),
                                              dtype=np.float32)).to(card, dtype)
    z = torch.from_numpy(rng.standard_normal((batch, f_in * c2in, n_time),
                                             dtype=np.float32)).to(card, dtype)
    w2 = _randn((5, 2, c2in, c2out), 8, card) / np.sqrt(10 * c2in)
    shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out)
    before = cb.enc_bwd_gz.launches, cb.enc_bwd_dw.launches
    gz = cb.enc_bwd_gz(gy, w2, **shapes)
    dw = cb.enc_bwd_dw(z, gy, **shapes)
    torch.cuda.synchronize()
    assert (cb.enc_bwd_gz.launches, cb.enc_bwd_dw.launches) == (before[0] + 1, before[1] + 1)
    _assert_gz_close(gz, cb.enc_bwd_gz_plain(gy, w2, **shapes), dtype)
    _assert_dw_close(dw, cb.enc_bwd_dw_plain(z, gy, **shapes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2x,c2s,c2out,n_time", [
    (1, 8, 16, 16, 2, 67),      # dec5's channels
    (2, 4, 32, 32, 64, 70),
    (1, 4, 64, 32, 256, 130),   # trunk and skip of different widths
    (1, 4, 256, 256, 256, 643),  # dec0 at the real frame count: every 16-byte residue
    (1, 128, 16, 16, 2, 643),   # dec5
    (2, 8, 64, 32, 32, 100),    # different widths, another tile
])
def test_decoder_backward_kernels_match_plain(card, dtype, batch, f_in, c2x, c2s, c2out,
                                              n_time):
    rng = np.random.default_rng(9)

    def act(rows):
        return torch.from_numpy(rng.standard_normal((batch, rows, n_time),
                                                    dtype=np.float32)).to(card, dtype)

    gy, zx, zs = act(2 * f_in * c2out), act(f_in * c2x), act(f_in * c2s)
    w2 = _randn((5, 2, c2x + c2s, c2out), 10, card) / np.sqrt(10 * (c2x + c2s))
    shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    before = cb.dec_bwd_gz.launches, cb.dec_bwd_dw.launches
    gzx, gzs = cb.dec_bwd_gz(gy, w2, **shapes)
    dw = cb.dec_bwd_dw(zx, zs, gy, **shapes)
    torch.cuda.synchronize()
    assert (cb.dec_bwd_gz.launches, cb.dec_bwd_dw.launches) == (before[0] + 1, before[1] + 1)
    want_x, want_s = cb.dec_bwd_gz_plain(gy, w2, **shapes)
    _assert_gz_close(gzx, want_x, dtype)
    _assert_gz_close(gzs, want_s, dtype)
    _assert_dw_close(dw, cb.dec_bwd_dw_plain(zx, zs, gy, **shapes))


# the decoder blocks of configs/dccrn_vbd.yaml (f_in, c2x, c2s, c2out) at T = 643,
# then ragged shapes: T < one frame tile with B 1, pairs not a multiple of 8
# with a ragged batch group, two row tiles with the last one ragged
MMA_SHAPES = [(2, 4, 256, 256, 256, 643), (2, 8, 256, 256, 128, 643),
              (2, 16, 128, 128, 64, 643), (1, 32, 64, 64, 32, 643), (1, 64, 32, 32, 16, 643),
              (3, 128, 16, 16, 2, 643), (1, 8, 16, 16, 2, 21), (5, 4, 6, 4, 6, 70),
              (3, 2, 8, 6, 34, 67)]


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2x,c2s,c2out,n_time", MMA_SHAPES)
def test_decoder_block_mma_kernel_matches_plain(card, with_stats, dtype, batch, f_in, c2x, c2s,
                                                c2out, n_time):
    """Row 4: bf16 runs block_mma.cuh's kernel, f32 block_gemm.cuh's."""
    (x, s), w2, b2, (cx, cs), (ax, a_s) = _block_inputs(11, card, dtype, batch, f_in,
                                                        (c2x, c2s), c2out, n_time)
    shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out, with_stats=with_stats)
    before = fused_deconv_block.launches
    got = fused_deconv_block(x, s, w2, b2, cx, ax, cs, a_s, **shapes)
    want = fused_deconv_block_plain(x, s, w2, b2, cx, ax, cs, a_s, **shapes)
    torch.cuda.synchronize()
    assert fused_deconv_block.launches == before + 1
    _assert_block_close(got, want, with_stats, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2x,c2s,c2out,n_time", MMA_SHAPES)
def test_decoder_input_gradient_mma_kernel_matches_plain(card, dtype, batch, f_in, c2x, c2s,
                                                         c2out, n_time):
    """Row 7: bf16 runs block_mma.cuh's kernel, f32 block_gemm.cuh's."""
    rng = np.random.default_rng(12)
    gy = torch.from_numpy(rng.standard_normal((batch, 2 * f_in * c2out, n_time),
                                              dtype=np.float32)).to(card, dtype)
    w2 = _randn((5, 2, c2x + c2s, c2out), 13, card) / np.sqrt(10 * (c2x + c2s))
    shapes = dict(f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    before = cb.dec_bwd_gz.launches
    gzx, gzs = cb.dec_bwd_gz(gy, w2, **shapes)
    torch.cuda.synchronize()
    assert cb.dec_bwd_gz.launches == before + 1
    want_x, want_s = cb.dec_bwd_gz_plain(gy, w2, **shapes)
    _assert_gz_close(gzx, want_x, dtype)
    _assert_gz_close(gzs, want_s, dtype)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("tile", [(128, 2), (64, 2), (32, 4), (16, 4)])
def test_decoder_mma_kernels_take_every_tile(card, tile, pair):
    """Both bf16 decoder kernels with each tile of block_mma.cuh:launch (the
    forward with and without row-pair blocks), at dec2's widths (B 5: a
    ragged batch group), against the plain versions."""
    batch, f_in, c2x, c2s, c2out, n_time = 5, 4, 128, 128, 64, 130
    (x, s), w2, b2, (cx, cs), (ax, a_s) = _block_inputs(14, card, torch.bfloat16, batch, f_in,
                                                        (c2x, c2s), c2out, n_time)
    args, outs, _keep = cb._deconv_block_args(x, s, w2, b2, cx, ax, cs, a_s, f_in, c2x, c2s,
                                              c2out, True, tile, pair)
    cb._launch("deconv_block", args, x)
    want = fused_deconv_block_plain(x, s, w2, b2, cx, ax, cs, a_s, f_in=f_in, c2x=c2x,
                                    c2s=c2s, c2out=c2out, with_stats=True)
    torch.cuda.synchronize()
    _assert_block_close(outs, want, True, torch.bfloat16)
    gy = _randn((batch, 2 * f_in * c2out, n_time), 15, card).bfloat16()
    args, (gzx, gzs), _keep = cb._dec_bwd_gz_args(gy, w2, f_in, c2x, c2s, c2out, tile)
    cb._launch("dec_bwd_gz", args, gy)
    want_x, want_s = cb.dec_bwd_gz_plain(gy, w2, f_in=f_in, c2x=c2x, c2s=c2s, c2out=c2out)
    torch.cuda.synchronize()
    _assert_gz_close(gzx, want_x, torch.bfloat16)
    _assert_gz_close(gzs, want_s, torch.bfloat16)


# the encoder blocks of configs/dccrn_vbd.yaml (f_in, c2in, c2out) at T = 643,
# then ragged shapes: T < one frame tile with B 1, pairs not a multiple of 8
# with a ragged batch group, two row tiles with the last one ragged and g of
# two k16 steps, an output width not a multiple of 16, an odd number of
# output rows (the forward takes no row pairs there)
ENC_MMA_SHAPES = [(2, 256, 2, 16, 643), (2, 128, 16, 32, 643), (2, 64, 32, 64, 643),
                  (1, 32, 64, 128, 643), (1, 16, 128, 256, 643), (3, 8, 256, 256, 643),
                  (1, 8, 16, 32, 21), (5, 8, 6, 10, 70), (3, 4, 34, 20, 67),
                  (2, 16, 2, 2, 130), (2, 6, 16, 32, 70)]


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2in,c2out,n_time", ENC_MMA_SHAPES)
def test_encoder_block_mma_kernel_matches_plain(card, with_stats, dtype, batch, f_in, c2in,
                                                c2out, n_time):
    """Row 3: bf16 runs block_mma.cuh's kernel, f32 block_gemm.cuh's."""
    (x,), w2, b2, (coef,), (alpha,) = _block_inputs(16, card, dtype, batch, f_in, (c2in,),
                                                    c2out, n_time)
    shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out, with_stats=with_stats)
    before = fused_conv_block.launches
    got = fused_conv_block(x, w2, b2, *coef, alpha, **shapes)
    want = fused_conv_block_plain(x, w2, b2, *coef, alpha, **shapes)
    torch.cuda.synchronize()
    assert fused_conv_block.launches == before + 1
    _assert_block_close(got, want, with_stats, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f_in,c2in,c2out,n_time", ENC_MMA_SHAPES)
def test_encoder_input_gradient_mma_kernel_matches_plain(card, dtype, batch, f_in, c2in, c2out,
                                                         n_time):
    """Row 5: bf16 runs block_mma.cuh's kernel, f32 block_gemm.cuh's."""
    rng = np.random.default_rng(17)
    gy = torch.from_numpy(rng.standard_normal((batch, f_in // 2 * c2out, n_time),
                                              dtype=np.float32)).to(card, dtype)
    w2 = _randn((5, 2, c2in, c2out), 18, card) / np.sqrt(10 * c2out)
    shapes = dict(f_in=f_in, c2in=c2in, c2out=c2out)
    before = cb.enc_bwd_gz.launches
    gz = cb.enc_bwd_gz(gy, w2, **shapes)
    torch.cuda.synchronize()
    assert cb.enc_bwd_gz.launches == before + 1
    _assert_gz_close(gz, cb.enc_bwd_gz_plain(gy, w2, **shapes), dtype)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("c2in,c2out", [(2, 16), (32, 64)])  # enc0's and enc2's widths
@pytest.mark.parametrize("tile", [(128, 2), (64, 2), (32, 4), (16, 4)])
def test_encoder_mma_kernels_take_every_tile(card, tile, c2in, c2out, pair):
    """Both bf16 encoder kernels with each tile of block_mma.cuh:launch, one
    output row a block or row pairs, at enc0's and enc2's widths (B 5: a
    ragged batch group), against the plain versions."""
    batch, f_in, n_time = 5, 16, 130
    (x,), w2, b2, (coef,), (alpha,) = _block_inputs(19, card, torch.bfloat16, batch, f_in,
                                                    (c2in,), c2out, n_time)
    args, outs, _keep = cb._conv_block_args(x, w2, b2, *coef, alpha, f_in, c2in, c2out, True,
                                            tile, pair)
    cb._launch("conv_block", args, x)
    want = fused_conv_block_plain(x, w2, b2, *coef, alpha, f_in=f_in, c2in=c2in, c2out=c2out,
                                  with_stats=True)
    torch.cuda.synchronize()
    _assert_block_close(outs, want, True, torch.bfloat16)
    gy = _randn((batch, f_in // 2 * c2out, n_time), 20, card).bfloat16()
    args, gz, _keep = cb._enc_bwd_gz_args(gy, w2, f_in, c2in, c2out, tile, pair)
    cb._launch("enc_bwd_gz", args, gy)
    want = cb.enc_bwd_gz_plain(gy, w2, f_in=f_in, c2in=c2in, c2out=c2out)
    torch.cuda.synchronize()
    _assert_gz_close(gz, want, torch.bfloat16)


def test_encoder_kernels_keep_block_kernel(card):
    """Rows 3 and 5 (the encoder block and its input gradient) keep
    block_gemm.cuh's block_kernel for f32 only: every bf16 variant of the
    four block libraries, the encoder's as the decoder's, is block_mma.cuh's
    mma_kernel (the ptxas report of each build names the kernels it
    compiled)."""
    from speech_enhancement_torch.kernels import _build
    names = ("conv_block", "conv_block_bwd", "deconv_block", "deconv_block_bwd")
    _build.build(names)
    bf16_block, mma = "block_kernelI13__nv_bfloat16", "8blockmma10mma_kernel"
    for name in names:
        log = _build.build_log(name)
        assert mma in log and bf16_block not in log
        assert "block_kernelIf" in log  # the f32 variants


def _leaf_close(got, want, rel=2e-3):
    """Within ``rel`` of the leaf's largest magnitude (tests/test_dccrn_fused.py:97-113)."""
    scale = max(want.abs().max().item(), got.abs().max().item(), 1e-8)
    assert (got - want).abs().max().item() <= rel * scale, ((got - want).abs().max(), scale)


@pytest.mark.parametrize("block", ["encoder", "decoder"])
def test_block_train_functions_on_card_match_cpu(card, block):
    """conv_block_train / deconv_block_train, f32: every gradient of the
    kernels' backward on the card vs the plain backward on the CPU."""
    if block == "encoder":
        (x,), w2, b2, (coef,), (alpha,) = _block_inputs(3, "cpu", torch.float32, 2, 16,
                                                        (16,), 32, 40)
        inputs = [x, w2, b2, *coef, alpha]
        shapes = dict(f_in=16, c2in=16, c2out=32)
        fn, counters = cb.conv_block_train, (cb.enc_bwd_gz, cb.enc_bwd_dw)
        rows = 8 * 32
    else:
        (x, s), w2, b2, (cx, cs), (ax, a_s) = _block_inputs(4, "cpu", torch.float32, 2, 8,
                                                            (16, 16), 8, 33)
        inputs = [x, s, w2, b2, *cx, ax, *cs, a_s]
        shapes = dict(f_in=8, c2x=16, c2s=16, c2out=8)
        counters = (cb.dec_bwd_gz, cb.dec_bwd_dw)

        def fn(x, s, w2, b2, a0, a1, a2, ax, s0, s1, s2, a_s, **kw):
            return cb.deconv_block_train(x, s, w2, b2, (a0, a1, a2), ax, (s0, s1, s2), a_s, **kw)
        rows = 16 * 8
    rng = np.random.default_rng(11)
    g_y = torch.from_numpy(rng.standard_normal((2, rows, x.shape[-1]), dtype=np.float32))
    g_p = torch.from_numpy(rng.standard_normal((2, rows, 8), dtype=np.float32))
    grads = []
    for dev in (card, "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in inputs]
        y, partials = fn(*leaves, **shapes)
        before = [c.launches for c in counters]
        torch.autograd.backward((y, partials), (g_y.to(dev), g_p.to(dev)))
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([1, 1] if dev == card else [0, 0])
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(*grads):
        _leaf_close(got, want)


def test_repaired_gradients_on_card_match_plain(card):
    """Mask E and the STFT launch their kernels under autograd and give the
    plain path's gradients (the pole-free mask formula; the STFT's exact
    signal cotangent)."""
    rng = np.random.default_rng(12)
    arrays = [torch.from_numpy(rng.standard_normal((2, 257, 67), dtype=np.float32))
              for _ in range(4)]
    arrays[2][0, :5] = 0.0  # a zero mask: finite gradients
    arrays[3][0, :5] = 0.0
    g = [torch.from_numpy(rng.standard_normal((2, 257, 67), dtype=np.float32))
         for _ in range(2)]
    got = [a.to(card).requires_grad_() for a in arrays]
    before = mask_e_kernel.launches
    torch.autograd.backward(mask_e_kernel(*got), [t.to(card) for t in g])
    assert mask_e_kernel.launches == before + 1
    want = [a.clone().requires_grad_() for a in arrays]
    torch.autograd.backward(mask_e_ref(*want), g)
    for a, b in zip(got, want):
        assert torch.isfinite(a.grad).all()
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5, atol=1e-5)

    basis = torch.from_numpy(_stft_bases(400, 512)[0])
    x = torch.from_numpy(rng.standard_normal((2, 7000), dtype=np.float32))
    gs = torch.from_numpy(rng.standard_normal((2, 67, 514), dtype=np.float32))
    xc = x.to(card).requires_grad_()
    before = stft_kernel.launches
    stft_kernel(xc, basis.to(card), 100, 400).backward(gs.to(card))
    assert stft_kernel.launches == before + 1
    xp = x.clone().requires_grad_()
    stft_plain(xp, basis, 100, 400).backward(gs)
    torch.testing.assert_close(xc.grad.cpu(), xp.grad, rtol=1e-4, atol=1e-4)


def test_small_fused_train_step_on_card_matches_cpu(card):
    """One fused train step of the small f32 DCCRN through every kernel on
    the card vs the same step on the CPU: loss, grad norm, every gradient
    and every updated parameter within 2e-3 of each leaf's scale."""
    cfg = Config(dict(SMALL, use_fused_blocks=True))
    optim = Config({"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5})
    rng = np.random.default_rng(13)
    mixture = (0.1 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    sources = (0.1 * rng.standard_normal((2, 1, 1, 8000))).astype(np.float32)
    results = []
    for dev in (card, "cpu"):
        model, spec = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(5))
        opt = get_optimizer(optim, model.parameters())
        before = cb.enc_bwd_gz.launches, cb.dec_bwd_dw.launches
        loss, norm = train_step(model, spec, opt, mixture, sources, "mse", device=dev)
        after = cb.enc_bwd_gz.launches, cb.dec_bwd_dw.launches
        assert (after[0] - before[0], after[1] - before[1]) == ((2, 3) if dev == card else (0, 0))
        results.append((float(loss), float(norm),
                        {k: p.grad.cpu() for k, p in model.named_parameters()},
                        {k: v.cpu() for k, v in model.state_dict().items()}))
    (loss_c, norm_c, grads_c, state_c), (loss_p, norm_p, grads_p, state_p) = results
    assert np.isfinite(loss_c) and abs(loss_c - loss_p) <= 2e-3 * abs(loss_p)
    assert abs(norm_c - norm_p) <= 2e-3 * norm_p
    for got, want in ((grads_c, grads_p), (state_c, state_p)):
        scale = max(v.abs().max().item() for v in want.values())
        for key in want:
            # a conv bias followed by complex BN has an exactly zero true
            # gradient, so both sides hold rounding residue (and Adam's
            # step on it): compare it at the global scale
            # (tests/test_dccrn_fused.py:102-108)
            if zero_grad_bias(key, len(SMALL["kernel_num"])):
                assert (got[key] - want[key]).abs().max().item() <= 2e-3 * scale, key
            else:
                _leaf_close(got[key], want[key])


def zero_grad_bias(key: str, n_blocks: int) -> bool:
    """Conv biases followed by complex BN: every block's but the last decoder's."""
    return key.endswith("_conv.bias") and not key.startswith(f"decoder.{n_blocks - 1}.")


# -- the LSTM recurrence kernels (kernels/lstm.py) ---------------------------

def _lstm_inputs(steps, batch, hidden, dtype, dev, seed=0, state=True):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((steps, batch, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32)
    h0, c0 = ((0.5 * rng.standard_normal((batch, hidden))).astype(np.float32) if state
              else np.zeros((batch, hidden), np.float32) for _ in range(2))
    return [torch.from_numpy(a).to(dev, dtype) for a in (x_proj, w_hh, h0, c0)]


# (T, B, H): small widths, a ragged last column tile (B 70; a second batch
# chunk on the f32 path), an H not a multiple of 8 (element staging), one more
# hidden unit than SMs (2 units a block)
LSTM_SHAPES = [(9, 3, 32), (20, 70, 64), (13, 5, 20), (6, 4, 133)]
# f32: the same FMA arithmetic, another summation order; bf16: sums in another
# order flip single bf16 roundings of h and c, which the recurrence carries
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _check_lstm_fwd(card, shape, reverse, dtype):
    from speech_enhancement_torch.kernels.lstm import fused_lstm_plain, lstm_fwd
    args = _lstm_inputs(*shape, dtype, card, seed=sum(shape))
    before = lstm_fwd.launches
    got = lstm_fwd(*args, reverse)
    want = fused_lstm_plain(*args, reverse)
    torch.cuda.synchronize()
    assert lstm_fwd.launches == before + 1
    for g, w, name in zip(got, want, ("h_seq", "c_seq", "gates")):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=LSTM_TOL[dtype],
                                   atol=LSTM_TOL[dtype], msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_fwd_kernel_matches_plain(card, shape, reverse, dtype):
    _check_lstm_fwd(card, shape, reverse, dtype)


# (T, B, H) at the served widths, where bf16 takes the forward's ring path:
# U 14 with the full shared-memory budget (B 192, one chunk of 192 columns),
# U 7 with two gates a tile (B 384), a ragged last batch chunk (B 200), and
# K split over the warps (B 16)
LSTM_WIDE_SHAPES = [(4, 192, 1792), (4, 384, 896), (4, 200, 1792), (4, 16, 1792)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_WIDE_SHAPES)
def test_lstm_fwd_kernel_matches_plain_at_served_widths(card, shape, reverse):
    _check_lstm_fwd(card, shape, reverse, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_bwd_kernel_matches_plain(card, shape, reverse, dtype):
    from speech_enhancement_torch.kernels.lstm import (fused_lstm_plain, lstm_bwd,
                                                       lstm_bwd_plain, shift_prev)
    x_proj, w_hh, h0, c0 = _lstm_inputs(*shape, dtype, card, seed=sum(shape) + 1)
    _, c_seq, gates = fused_lstm_plain(x_proj, w_hh, h0, c0, reverse)
    c_prev = shift_prev(c_seq, c0, reverse)
    rng = np.random.default_rng(7)
    dout = torch.from_numpy(rng.standard_normal(c_seq.shape).astype(np.float32)).to(card, dtype)
    dh_t, dc_t = (torch.from_numpy(rng.standard_normal(h0.shape).astype(np.float32)).to(card)
                  for _ in range(2))
    before = lstm_bwd.launches
    got = lstm_bwd(gates, c_seq, c_prev, dout, w_hh, dh_t, dc_t, reverse)
    want = lstm_bwd_plain(gates, c_seq, c_prev, dout, w_hh, dh_t, dc_t, reverse)
    torch.cuda.synchronize()
    assert lstm_bwd.launches == before + 1
    for g, w, name in zip(got, want, ("dgates", "dh0", "dc0")):
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=LSTM_TOL[dtype],
                                   atol=LSTM_TOL[dtype] * scale, msg=name)


def _card_plan_args(card):
    props = torch.cuda.get_device_properties(card)
    return props.multi_processor_count, getattr(props, "shared_memory_per_block_optin", 232448)


def _check_lstm_bwd(card, shape, reverse, dtype):
    """lstm_bwd against lstm_bwd_plain on one forward's outputs, launched
    once; returns the design the library reports for the shape."""
    from speech_enhancement_torch.kernels.lstm import (fused_lstm_plain, lstm_bwd,
                                                       lstm_bwd_design, lstm_bwd_plain,
                                                       shift_prev)
    steps, batch, hidden = shape
    x_proj, w_hh, h0, c0 = _lstm_inputs(*shape, dtype, card, seed=sum(shape) + 2)
    _, c_seq, gates = fused_lstm_plain(x_proj, w_hh, h0, c0, reverse)
    c_prev = shift_prev(c_seq, c0, reverse)
    rng = np.random.default_rng(sum(shape))
    dout = torch.from_numpy(rng.standard_normal(c_seq.shape).astype(np.float32)).to(card, dtype)
    dh_t, dc_t = (torch.from_numpy(rng.standard_normal(h0.shape).astype(np.float32)).to(card)
                  for _ in range(2))
    before = lstm_bwd.launches
    got = lstm_bwd(gates, c_seq, c_prev, dout, w_hh, dh_t, dc_t, reverse)
    want = lstm_bwd_plain(gates, c_seq, c_prev, dout, w_hh, dh_t, dc_t, reverse)
    torch.cuda.synchronize()
    assert lstm_bwd.launches == before + 1
    for g, w, name in zip(got, want, ("dgates", "dh0", "dc0")):
        assert g.shape == w.shape
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=LSTM_TOL[dtype],
                                   atol=LSTM_TOL[dtype] * scale, msg=name)
    return lstm_bwd_design(dtype, hidden, batch)


# bf16 rows of 16 bytes take the backward's ring (lstm_bwd_ring): B 1 and 5
# (one m16 tile, mostly zero-filled), 16 (CRN's train batch: one tile
# exactly), 24 and 70 (several tiles: warps along the batch, four pairs a
# thread), at CRN's H 1792 (U 14), rnn-stft-mask's 896 (U 7: one n8 tile)
# and 1790 (a last block of 12 units)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [1792, 896, 1790])
@pytest.mark.parametrize("batch", [1, 5, 16, 24, 70])
def test_lstm_bwd_ring_matches_plain(card, batch, hidden, reverse):
    from speech_enhancement_torch.kernels.lstm import bwd_ring_plan
    design, plan = _check_lstm_bwd(card, (4, batch, hidden), reverse, torch.bfloat16)
    sms, optin = _card_plan_args(card)
    want = bwd_ring_plan(-(-hidden // sms), hidden, batch, optin)
    assert design == "ring" and plan == {k: want[k] for k in plan}


# the first design: f32 wider than the split-f32 plans reach (H 1000: U 8),
# and bf16 rows that are not 16 bytes (4H % 8 != 0)
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (3, 5, 1000)),
                                         (torch.bfloat16, (5, 16, 133)),
                                         (torch.bfloat16, (3, 5, 1795))])
def test_lstm_bwd_first_design_stays(card, dtype, shape):
    assert _check_lstm_bwd(card, shape, True, dtype) == ("first", None)


# f32 at the served widths, where both kernels take the split-f32 design
# (csrc/lstm.cuh, namespace tc): mel-rnn's and Demucs's B 192 at H 256 and
# 512, Demucs's train batch B 8 (half an m16 tile), a ragged B 70 (warps
# along the batch and along K), and H 258, not a multiple of 4: the
# forward keeps the first design there, the backward (rows of 4H floats)
# does not
LSTM_F32_SHAPES = [(4, 192, 256), (4, 192, 512), (4, 8, 256), (4, 8, 512), (4, 70, 256),
                   (4, 16, 258)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", LSTM_F32_SHAPES)
def test_lstm_f32_kernels_take_their_plans(card, shape, reverse):
    """Both kernels against their plain versions within LSTM_TOL[float32],
    each taking the design its mirrored plan says (kernels/lstm.py:
    f32_design, which tests/test_torch_lstm_f32_ring.py walks)."""
    from speech_enhancement_torch.kernels.lstm import f32_design, lstm_fwd_design
    _, batch, hidden = shape
    sms, optin = _card_plan_args(card)
    _check_lstm_fwd(card, shape, reverse, torch.float32)
    fwd = lstm_fwd_design(torch.float32, hidden, batch)
    assert fwd == f32_design("fwd", hidden, batch, sms, optin)
    assert fwd[0] == ("f32" if hidden % 4 == 0 else "first")
    bwd = _check_lstm_bwd(card, shape, reverse, torch.float32)
    assert bwd == f32_design("bwd", hidden, batch, sms, optin) and bwd[0] == "f32"
    # unaligned pointers take the first design
    assert lstm_fwd_design(torch.float32, hidden, batch, aligned=False) == ("first", None)


def test_fused_lstm_gradients_on_card_match_cpu(card):
    """The autograd Function end to end in f32: kernels on the card vs the
    plain versions on the CPU (which tests/test_torch_lstm.py holds
    against JAX), within the JAX package's 2e-4 gradient bound."""
    from speech_enhancement_torch.kernels.lstm import fused_lstm
    grads = []
    for dev in (card, torch.device("cpu")):
        leaves = [a.requires_grad_() for a in _lstm_inputs(11, 6, 48, torch.float32, dev, 3)]
        out, h_last, c_last = fused_lstm(*leaves, True)
        (torch.sin(out).sum() + torch.cos(h_last).sum() + torch.tanh(c_last).sum()).backward()
        grads.append([leaf.grad.cpu() for leaf in leaves])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


# The wide design (csrc/lstm.cuh, namespace wide): the widths whose slice no
# other design holds beside its staging. CRN at f32 (H 1792) and Demucs's
# bottleneck BLSTM (H 2048, 16 units a block) in both dtypes, at CRN's
# train and serve batches and Demucs's B 8, a ragged batch (B 70); H 1790
# in f32 (not a multiple of 4: the forward stages h and its slice element
# by element)
LSTM_WIDE_DESIGN = [((4, 16, 1792), torch.float32), ((3, 192, 1792), torch.float32),
                    ((4, 8, 2048), torch.float32), ((3, 192, 2048), torch.float32),
                    ((4, 8, 2048), torch.bfloat16), ((3, 192, 2048), torch.bfloat16),
                    ((3, 70, 2048), torch.bfloat16), ((3, 5, 1790), torch.float32)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", LSTM_WIDE_DESIGN)
def test_lstm_wide_kernels_match_plain(card, shape, dtype, reverse):
    """Both kernels against their plain versions within LSTM_TOL, each
    launched once and taking the wide design with the plan that
    kernels/lstm.py:lstm_design mirrors (tests/test_torch_lstm_wide.py walks
    its indexing)."""
    from speech_enhancement_torch.kernels.lstm import (lstm_bwd_design, lstm_design,
                                                       lstm_fwd_design)
    _, batch, hidden = shape
    sms, optin = _card_plan_args(card)
    for kernel, design in (("fwd", lstm_fwd_design), ("bwd", lstm_bwd_design)):
        got = design(dtype, hidden, batch)
        assert got[0] == "wide", (kernel, got)
        assert got == lstm_design(kernel, dtype, hidden, batch, sms, optin)
    _check_lstm_fwd(card, shape, reverse, dtype)
    assert _check_lstm_bwd(card, shape, reverse, dtype)[0] == "wide"


@pytest.mark.parametrize("hidden,dtype", [(4096, torch.float32), (4096, torch.bfloat16)])
def test_lstm_kernels_refuse_a_grid_that_does_not_fit(card, hidden, dtype):
    """4096 units need more than 16 a block on a card of 132 SMs: both
    kernels raise instead of launching, in either dtype."""
    from speech_enhancement_torch.kernels.lstm import lstm_bwd, lstm_fwd
    x_proj, w_hh, h0, c0 = _lstm_inputs(2, 2, hidden, dtype, card, state=False)
    with pytest.raises(RuntimeError, match="cooperative"):
        lstm_fwd(x_proj, w_hh, h0, c0)
    seq = torch.zeros((2, 2, hidden), dtype=dtype, device=card)
    with pytest.raises(RuntimeError, match="cooperative"):
        lstm_bwd(x_proj, seq, seq, seq, w_hh, h0.float(), c0.float())


# -- the attention kernels (kernels/attention.py) ----------------------------

def _mha_inputs(batch, heads, length, depth, dtype, dev, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((batch, heads * depth, length),
                                                 dtype=np.float32)).to(dev, dtype)
            for _ in range(n)]


# (B, H, L, D): ragged (L, D off every tile), Sepformer's intra and inter
# chunks, the small Sepformer's depth 8, a depth between tile sizes, a head
# block of D * L = 444 elements (bf16: not whole 16-byte vectors, and every
# other block unaligned: the element-wise stores); L at the edges of the
# 16-steps (16, 17, 80, 81, 256), B * H not a multiple of the eight heads a
# bf16 block walks (9 at L 66, 5 at L 250), depth 64, and L under one 16-byte
# word (5)
MHA_SHAPES = [(3, 2, 50, 16), (4, 8, 250, 32), (8, 8, 66, 32), (2, 4, 37, 8), (2, 2, 40, 24),
              (2, 2, 37, 12), (1, 2, 16, 32), (1, 2, 17, 32), (2, 2, 80, 32), (2, 2, 81, 32),
              (1, 2, 256, 32), (3, 3, 66, 32), (5, 1, 250, 32), (2, 2, 70, 64), (2, 2, 5, 16)]
# f32: the same FMA arithmetic in another order (the bf16 kernel's probabilities
# go through exp2, 2e-6 relative); bf16: both round the same f32 values once,
# so a value may land one bf16 step (2^-8 relative) apart
MHA_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0**-9, 2.0**-7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MHA_SHAPES)
def test_attention_kernels_match_plain(card, shape, dtype):
    from speech_enhancement_torch.kernels.attention import (fused_mha_packed_plain, mha_bwd,
                                                            mha_bwd_plain, mha_fwd)
    batch, heads, length, depth = shape
    q, k, v, g = _mha_inputs(*shape, dtype, card, seed=sum(shape), n=4)
    before = (mha_fwd.launches, mha_bwd.launches)
    got = mha_fwd(q, k, v, heads)
    want = fused_mha_packed_plain(q, k, v, heads)
    grads = mha_bwd(q, k, v, g, heads)
    want_grads = mha_bwd_plain(q, k, v, g, heads)
    torch.cuda.synchronize()
    assert (mha_fwd.launches, mha_bwd.launches) == (before[0] + 1, before[1] + 1)
    atol, rtol = MHA_TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for got_g, want_g, name in zip(grads, want_grads, ("dq", "dk", "dv")):
        scale = want_g.float().abs().max().item()
        torch.testing.assert_close(got_g.float(), want_g.float(), rtol=rtol,
                                   atol=atol * max(scale, 1.0), msg=name)


def test_fused_mha_gradients_on_card_match_cpu(card):
    """The autograd Function end to end in f32 on the [B, H, L, D] adapter:
    kernels on the card vs the plain versions on the CPU (which
    tests/test_torch_attention.py holds against JAX)."""
    from speech_enhancement_torch.kernels.attention import fused_mha
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((2, 3, 50, 16)).astype(np.float32) for _ in range(3)]
    results = []
    for dev in (card, torch.device("cpu")):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
        out = fused_mha(*leaves)
        torch.sin(out).sum().backward()
        results.append([out.detach().cpu()] + [leaf.grad.cpu() for leaf in leaves])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,heads,length,depth", [(2, 8, 66, 32), (1, 4, 250, 32)])
def test_attention_kernels_take_an_unaligned_base(card, batch, heads, length, depth, dtype):
    """Packed tensors that start one element past an allocation's 16-byte
    boundary (every head block unaligned: the forward stages from global
    memory, at L 250 with two tiles a warp; element-wise stores) give what
    aligned copies give."""
    from speech_enhancement_torch.kernels.attention import mha_bwd, mha_fwd
    aligned = _mha_inputs(batch, heads, length, depth, dtype, card, seed=3, n=4)
    shifted = []
    for x in aligned:
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=card)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    torch.testing.assert_close(mha_fwd(*shifted[:3], heads), mha_fwd(*aligned[:3], heads),
                               atol=0.0, rtol=0.0)
    for got, want in zip(mha_bwd(*shifted, heads), mha_bwd(*aligned, heads)):
        torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


def test_attention_kernels_refuse_what_they_do_not_take(card):
    """A depth over 64, and a bf16 backward at the first L whose tiles exceed a
    block's shared memory at D 32 (kernels/attention.py:mma_refuses: L 529;
    PR 5's kernel refused from L 385), raise instead of launching."""
    from speech_enhancement_torch.kernels.attention import mha_bwd, mha_fwd, mma_refuses
    q = _mha_inputs(1, 1, 20, 80, torch.bfloat16, card, n=1)[0]
    with pytest.raises(RuntimeError, match="launch"):
        mha_fwd(q, q, q, 1)
    longest = max(L for L in range(1, 2048) if not mma_refuses(2, 32, L, backward=True))
    assert longest == 528
    q = _mha_inputs(1, 2, longest + 1, 32, torch.bfloat16, card, n=1)[0]
    with pytest.raises(RuntimeError, match="launch"):
        mha_bwd(q, q, q, q, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mha_fwd(q.half(), q.half(), q.half(), 2)


SMALL_SEPFORMER = {"name": "sepformer", "encoder_in_nchannels": 2, "encoder_out_nchannels": 64,
                   "masknet_chunksize": 50, "masknet_numlayers": 1, "intra_numlayers": 1,
                   "inter_numlayers": 1, "intra_nhead": 4, "inter_nhead": 4, "intra_dffn": 128,
                   "inter_dffn": 128, "dtype": "float32", "fused_attention": True,
                   "segment": 0.125, "sample_rate": 16000, "win_length": 512}


def test_small_sepformer_on_card_matches_cpu(card):
    """The small f32 Sepformer (D 16) with the attention kernels on the card vs
    the same weights on the CPU path: served within 2e-4, then one si-sdr PIT
    train step, every gradient and updated parameter within 2e-3 of its
    leaf's scale (Adam: 2 lr more on the parameters)."""
    from speech_enhancement_torch.kernels.attention import mha_bwd, mha_fwd
    cfg = with_defaults(Config({"model": SMALL_SEPFORMER,
                                "dset": {"sample_rate": 16000, "norm": "z-score",
                                         "audio_channels": 2}}))
    rng = np.random.default_rng(9)
    wav = (0.3 * rng.standard_normal((1, 2, 5000))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 2, 2, 2000))).astype(np.float32)
    mixture = sources.sum(axis=1)
    optim = {"optim": "adam", "lr": 1.5e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
    results = []
    for dev in (card, torch.device("cpu")):
        model, spec = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(4))
        before = mha_fwd.launches
        served = evaluate_utterance(wav, model, spec, cfg, device=dev)
        served_launches = mha_fwd.launches - before
        opt = get_optimizer(Config(optim), model.parameters())
        before = (mha_fwd.launches, mha_bwd.launches)
        loss, norm = train_step(model, spec, opt, mixture, sources, "si-sdr", use_pit=True,
                                device=dev)
        launches = (mha_fwd.launches - before[0], mha_bwd.launches - before[1])
        results.append((served, served_launches, launches, float(loss), float(norm),
                        {k: p.grad.cpu() for k, p in model.named_parameters()},
                        {k: v.cpu() for k, v in model.state_dict().items()}))
    (served_c, serve_l, train_l, loss_c, norm_c, grads_c, state_c), (
        served_p, serve_p, train_p, loss_p, norm_p, grads_p, state_p) = results
    assert (serve_l, train_l) == (2, (2, 2)) and (serve_p, train_p) == (0, (0, 0))
    assert served_c.shape == (1, 2, 2, 5000) and np.isfinite(served_c).all()
    np.testing.assert_allclose(served_c, served_p, atol=2e-4)
    np.testing.assert_allclose(loss_c, loss_p, rtol=2e-3)
    np.testing.assert_allclose(norm_c, norm_p, rtol=2e-3)
    for key in grads_p:
        _leaf_close(grads_c[key], grads_p[key])
        scale = max(state_p[key].abs().max().item(), 1e-8)
        err = (state_c[key] - state_p[key]).abs().max().item()
        assert err <= 2e-3 * scale + 2 * optim["lr"], (key, err, scale)


# -- mel-rnn, rnn-stft-mask training, Sepformer's options, DCCRN's real LSTM --

# (T, B, H, dtype) of this slice's LSTM paths: mel-rnn (f32 H 256 B 16: the
# split-f32 designs) and rnn-stft-mask training (bf16 H 896 B 16: the rings)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", [((6, 16, 256), torch.float32),
                                         ((6, 16, 896), torch.bfloat16)])
def test_lstm_kernels_at_the_recurrent_slice_shapes(card, shape, dtype, reverse):
    _check_lstm_fwd(card, shape, reverse, dtype)
    design, _ = _check_lstm_bwd(card, shape, reverse, dtype)
    assert design == ("ring" if dtype == torch.bfloat16 else "f32")


SMALL_MEL = {"name": "mel-rnn", "n_fft": 128, "hop_length": 32, "win_length": 128,
             "center": True, "segment": 0.25, "sample_rate": 16000, "rnn_type": "lstm",
             "rnn_hidden": 128, "rnn_layer": 2, "n_mels": 16, "fused_rnn": True}


def test_small_mel_rnn_on_card_matches_cpu(card):
    """The small f32 MelRNN with the LSTM kernels on the card vs the CPU path
    (which tests/test_torch_mel_rnn.py holds against JAX): served within
    2e-4 of the signal's scale, one mse train step's loss and grad norm
    within 2e-3; two forward launches serving, two of each training."""
    from speech_enhancement_torch.kernels.lstm import lstm_bwd, lstm_fwd
    cfg = with_defaults(Config({"model": SMALL_MEL, "dset": {"norm": "z-score"}}))
    rng = np.random.default_rng(12)
    wav = (0.3 * rng.standard_normal((1, 1, 7000))).astype(np.float32)
    mixture = (0.5 * rng.standard_normal((2, 1, 3968))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, 3968))).astype(np.float32)
    optim = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
    results = []
    for dev in (card, torch.device("cpu")):
        model, spec = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(6))
        before = lstm_fwd.launches
        served = evaluate_utterance(wav, model, spec, cfg, device=dev)
        served_l = lstm_fwd.launches - before
        opt = get_optimizer(Config(optim), model.parameters())
        before = (lstm_fwd.launches, lstm_bwd.launches)
        loss, norm = train_step(model, spec, opt, mixture, sources, "mse", device=dev,
                                model_config=cfg.model)
        results.append((served, served_l, (lstm_fwd.launches - before[0],
                                           lstm_bwd.launches - before[1]),
                        float(loss), float(norm)))
    (served_c, serve_l, train_l, loss_c, norm_c), (served_p, serve_p, train_p, loss_p,
                                                   norm_p) = results
    assert (serve_l, train_l) == (2, (2, 2)) and (serve_p, train_p) == (0, (0, 0))
    assert np.isfinite(served_c).all()
    np.testing.assert_allclose(served_c, served_p, atol=2e-4 * float(np.abs(wav).max()))
    np.testing.assert_allclose(loss_c, loss_p, rtol=2e-3)
    np.testing.assert_allclose(norm_c, norm_p, rtol=2e-3)


def test_sepformer_remat_on_card_relaunches_the_forward(card):
    """remat=True on the card: each layer's attention forward runs again in
    the backward's recompute (four mha_fwd launches for two layers, two
    mha_bwd), and the step equals remat=False's."""
    from speech_enhancement_torch.kernels.attention import mha_bwd, mha_fwd
    rng = np.random.default_rng(13)
    sources = (0.5 * rng.standard_normal((2, 2, 2, 2000))).astype(np.float32)
    mixture = sources.sum(axis=1)
    optim = {"optim": "adam", "lr": 1.5e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
    results = []
    for remat in (False, True):
        model, spec = build_model(Config(dict(SMALL_SEPFORMER, remat=remat)), device=card,
                                  generator=torch.Generator().manual_seed(4))
        opt = get_optimizer(Config(optim), model.parameters())
        before = (mha_fwd.launches, mha_bwd.launches)
        loss, norm = train_step(model, spec, opt, mixture, sources, "si-sdr", use_pit=True,
                                device=card)
        results.append(((mha_fwd.launches - before[0], mha_bwd.launches - before[1]),
                        float(loss), torch.cat([p.grad.flatten() for p in model.parameters()])))
    assert results[0][0] == (2, 2) and results[1][0] == (4, 2)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6)
    torch.testing.assert_close(results[1][2], results[0][2], rtol=1e-5, atol=1e-7)


def test_sepformer_attn_out_on_card_launches_the_forward_once(card):
    """remat_policy="attn_out" keeps each layer's attention output: two
    mha_fwd and two mha_bwd launches for two layers (no recompute of the
    kernel), and the step of remat=False."""
    from speech_enhancement_torch.kernels.attention import mha_bwd, mha_fwd
    rng = np.random.default_rng(13)
    sources = (0.5 * rng.standard_normal((2, 2, 2, 2000))).astype(np.float32)
    mixture = sources.sum(axis=1)
    optim = {"optim": "adam", "lr": 1.5e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
    results = []
    for options in ({}, {"remat": True, "remat_policy": "attn_out"}):
        model, spec = build_model(Config(dict(SMALL_SEPFORMER, **options)), device=card,
                                  generator=torch.Generator().manual_seed(4))
        opt = get_optimizer(Config(optim), model.parameters())
        before = (mha_fwd.launches, mha_bwd.launches)
        loss, _ = train_step(model, spec, opt, mixture, sources, "si-sdr", use_pit=True,
                             device=card)
        results.append(((mha_fwd.launches - before[0], mha_bwd.launches - before[1]),
                        float(loss), torch.cat([p.grad.flatten() for p in model.parameters()])))
    assert results[0][0] == results[1][0] == (2, 2)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6)
    torch.testing.assert_close(results[1][2], results[0][2], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("policy", ["", "conv_out", "cbn_stats", "conv_out,cbn_stats"])
@pytest.mark.parametrize("fold", [False, True])
def test_small_dccrn_remat_on_card_matches_remat_off(card, fold, policy):
    """DCCRN remat on the card: the STFT and mask-E kernels launch once a
    step (outside the recomputed blocks), and the loss, gradients and
    running statistics are remat off's (a conv bias that complex BN
    follows has a zero true gradient: its residue at the global scale)."""
    rng = np.random.default_rng(15)
    mixture = (0.5 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    sources = (0.5 * rng.standard_normal((2, 1, 1, 8000))).astype(np.float32)
    optim = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
    results = []
    for options in ({}, {"remat": True, "remat_policy": policy}):
        model, spec = build_model(Config(dict(SMALL, cbn_fold=fold, **options)), device=card,
                                  generator=torch.Generator().manual_seed(6))
        opt = get_optimizer(Config(optim), model.parameters())
        before = (stft_kernel.launches, mask_e_kernel.launches)
        loss, _ = train_step(model, spec, opt, mixture, sources, "mse", device=card)
        results.append(((stft_kernel.launches - before[0], mask_e_kernel.launches - before[1]),
                        float(loss), {k: p.grad.clone() for k, p in model.named_parameters()},
                        {k: b.clone() for k, b in model.named_buffers() if ".R" in k}))
    assert results[0][0] == results[1][0] == (1, 1)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6)
    for got, want in ((results[1][2], results[0][2]), (results[1][3], results[0][3])):
        scale = max(float(v.abs().max()) for v in want.values())
        for key, value in want.items():
            residue = key.endswith("_conv.bias") and not key.startswith("decoder.2.")
            leaf = scale if residue else float(value.abs().max())
            torch.testing.assert_close(got[key], value, rtol=1e-5, atol=1e-6 * leaf, msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_small_dccrn_real_lstm_on_card_matches_cpu(card, fused):
    """use_clstm=False on both execution paths: the card vs the CPU path
    (held against JAX in tests/test_torch_dccrn.py), f32, within 2e-4."""
    cfg = Config(dict(SMALL, use_clstm=False, use_fused_blocks=fused))
    wav = (0.1 * np.random.default_rng(14).standard_normal((2, 8000))).astype(np.float32)
    outs = []
    for dev in (card, torch.device("cpu")):
        model, _ = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(5))
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(wav).to(dev)).cpu().numpy())
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-4)


# -- the rest of the zoo --------------------------------------------------------

ZOO_STFT = {"n_fft": 128, "hop_length": 32, "win_length": 128, "center": True}
# the CPU tests' small models (tests/test_torch_{dnn,unet,dcunet,tcn,conv_tasnet,demucs}.py)
ZOO_SMALL = {
    "dnn": dict(n_layers=3, hidden_layer=64),
    "unet": dict(unet_layer=2),
    "wav-unet": dict(unet_nlayers=3, channels_interval=4),
    "dcunet": dict(model_complexity=8),
    "tcn": dict(tcn_channels=8, tcn_hidden=16, tcn_blocks=3, tcn_repeats=2),
    "conv-tasnet": dict(N=16, L=8, B=8, H=16, P=3, X=3, R=2, audio_channels=2),
    "demucs": dict(channels=8, depth=3, norm_starts=1, norm_groups=2, dconv_attn=2,
                   dconv_lstm=2, fused_rnn=True),
}


@pytest.mark.parametrize("name", sorted(ZOO_SMALL))
def test_zoo_small_family_on_card_matches_cpu(card, name):
    """Each family's small f32 model on the card vs the same weights on the
    CPU (which the CPU tests hold against JAX): a forward within 2e-4 of
    the output's peak; the small Demucs launches the LSTM forward kernel
    eight times a call (one BLSTM layer: 2 DConv depths x 2 layers x 2
    directions)."""
    from speech_enhancement_torch.kernels.lstm import lstm_fwd
    from speech_enhancement_torch.ops.stft import stft_custom
    cfg = Config({"name": name, **ZOO_STFT, **ZOO_SMALL[name]})
    channels = 2 if name in ("conv-tasnet", "demucs") else 1
    wav = torch.from_numpy((0.5 * np.random.default_rng(20).standard_normal(
        (2, channels, 4000))).astype(np.float32))
    outs, launches = [], []
    for dev in (card, torch.device("cpu")):
        model, spec = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(7))
        x = wav.to(dev)
        if spec.domain == "stft":
            x = stft_custom(x, cfg)
        before = lstm_fwd.launches
        with torch.inference_mode():
            outs.append(model(x).cpu().numpy())
        launches.append(lstm_fwd.launches - before)
    assert launches == [8 if name == "demucs" else 0, 0]
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=2e-4 * np.abs(outs[1]).max())


def test_zoo_demucs_remat_on_card_relaunches_the_blstm_forward(card):
    """The small Demucs with fused_rnn: remat recomputes each encoder layer,
    so a train step launches the LSTM forward 16 times (8 + 8) against 8
    without, the backward 8 times either way, and the step is the same."""
    from speech_enhancement_torch.kernels.lstm import lstm_bwd, lstm_fwd
    rng = np.random.default_rng(21)
    sources = (0.5 * rng.standard_normal((2, 2, 2, 4000))).astype(np.float32)
    mixture = sources.sum(axis=1)
    optim = {"optim": "adam", "lr": 3e-4, "beta1": 0.9, "beta2": 0.999, "clip_grad": 5}
    results = []
    for remat in (False, True):
        cfg = Config({"name": "demucs", **ZOO_SMALL["demucs"], "remat": remat})
        model, spec = build_model(cfg, device=card, generator=torch.Generator().manual_seed(8))
        opt = get_optimizer(Config(optim), model.parameters())
        before = (lstm_fwd.launches, lstm_bwd.launches)
        loss, _ = train_step(model, spec, opt, mixture, sources, "l1", use_pit=True, device=card)
        results.append(((lstm_fwd.launches - before[0], lstm_bwd.launches - before[1]),
                        float(loss), torch.cat([p.grad.flatten() for p in model.parameters()])))
    assert results[0][0] == (8, 8) and results[1][0] == (16, 8)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-6)
    torch.testing.assert_close(results[1][2], results[0][2], rtol=1e-5, atol=1e-7)


# (T, B, H): Demucs's DConv BLSTM layers at a short T, f32 (its path: the
# split-f32 designs)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(6, 8, 256), (6, 8, 512), (6, 192, 512)])
def test_zoo_lstm_kernels_at_the_demucs_shapes(card, shape, reverse):
    _check_lstm_fwd(card, shape, reverse, torch.float32)
    design, _ = _check_lstm_bwd(card, shape, reverse, torch.float32)
    assert design == "f32"


# -- streaming serving and the hearing-aid chain --------------------------------

SMALL_CRN = {"name": "crn", "n_fft": 128, "hop_length": 32, "win_length": 128, "center": True,
             "dtype": "float32", "fused_rnn": True}


# (B, T, H) of the stream's launches: the DCCRN chunk STFT over
# [(win - hop) tail | 16 x 100] samples, CRN's LSTMs at 16 frames with a
# carried, non-zero h0 / c0 (configs/crn_vbd.yaml: bf16, H 1792)
@pytest.mark.parametrize("batch", [1, 64])
def test_kernels_at_the_stream_shapes(card, batch):
    from speech_enhancement_torch.kernels.lstm import fused_lstm_plain, lstm_fwd
    basis = torch.from_numpy(_stft_bases(400, 512)[0]).to(card)
    x = _randn((batch, 300 + 1600), batch, card)
    torch.testing.assert_close(stft_kernel(x, basis, 100, 400), stft_plain(x, basis, 100, 400),
                               rtol=1e-4, atol=2e-3)  # tests/test_pallas.py:22
    args = _lstm_inputs(16, batch, 1792, torch.bfloat16, card, seed=batch)
    before = lstm_fwd.launches
    got = lstm_fwd(*args)
    want = fused_lstm_plain(*args)
    torch.cuda.synchronize()
    assert lstm_fwd.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=LSTM_TOL[torch.bfloat16],
                                   atol=LSTM_TOL[torch.bfloat16])


@pytest.mark.parametrize("family", ["dccrn", "crn"])
def test_small_streamer_on_card_matches_cpu(card, family):
    """A small f32 stream on the card vs the same weights on the CPU path
    (held against the JAX streamers in tests/test_torch_streaming_*.py),
    within 2e-4 of the peak; the card's chunks launch the STFT and mask-E
    kernels once each (DCCRN) or the LSTM forward once a layer (CRN)."""
    from speech_enhancement_torch.kernels.lstm import lstm_fwd
    from speech_enhancement_torch.serve import CRNStreamer, DCCRNStreamer
    cfg = Config(SMALL if family == "dccrn" else SMALL_CRN)
    wav = (0.3 * np.random.default_rng(21).standard_normal((2, 8000))).astype(np.float32)
    outs = []
    for dev in (card, torch.device("cpu")):
        model, _ = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(6))
        streamer = DCCRNStreamer(model) if family == "dccrn" else CRNStreamer(model)
        before = (stft_kernel.launches, mask_e_kernel.launches, lstm_fwd.launches)
        outs.append(streamer.enhance(torch.from_numpy(wav).to(dev)).cpu().numpy())
        after = (stft_kernel.launches, mask_e_kernel.launches, lstm_fwd.launches)
        chunks = -(-(8000 + streamer.latency + (0 if family == "dccrn" else
                                                 streamer.chunk_samples))
                   // streamer.chunk_samples)
        want = (chunks, chunks, 0) if family == "dccrn" else (0, 0, 2 * chunks)
        launched = tuple(a - b for a, b in zip(after, before))
        assert launched == (want if dev.type == "cuda" else (0, 0, 0)), launched
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=2e-4 * np.abs(outs[1]).max())


def test_ha_chain_on_card_matches_cpu(card, tmp_path):
    """ClarityScorer on the card with TF32 allowed (cuDNN's default for
    convolutions, and for matmuls too) vs the CPU: the resample, NAL-R and
    compressor within 1e-5 (tanh-clipped output); the four better-ear
    scores, which a speech-like input puts inside (0, 1), within 1e-4 of
    the CPU's relatively (tests/test_torch_ha.py's bounds)."""
    from speech_enhancement_torch.data.synthetic import make_ha_config
    from speech_enhancement_torch.ha.scoring import ClarityScorer
    ha_yaml = make_ha_config(str(tmp_path), scenes=["S00001"], n_listeners=2, fs=44100)
    rng = np.random.default_rng(22)
    t = np.arange(12000) / 16000
    phase = 2 * np.pi * np.cumsum(120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)) / 16000
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    clean = 0.1 * (voiced * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
                   + 0.5 * rng.standard_normal(t.shape))
    clean = np.stack([clean, 0.9 * clean]).astype(np.float32)
    mixture = (clean + 0.01 * rng.standard_normal(clean.shape)).astype(np.float32)
    enhanced = (clean + 0.002 * rng.standard_normal(clean.shape)).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        scores = [ClarityScorer(ha_yaml, input_sr=16000, device=dev).score(
            clean, mixture, enhanced, "S00001_mix") for dev in (card, "cpu")]
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_allclose(scores[0]["amplified"], scores[1]["amplified"], rtol=0,
                               atol=1e-5)
    for key in ("haspi_enhance", "hasqi_enhance", "haspi_mixture", "hasqi_mixture"):
        assert 0.0 < scores[1][key] < 1.0, (key, scores[1][key])
        assert abs(scores[0][key] - scores[1][key]) <= 1e-4 * scores[1][key], key


def test_dp_dryrun_over_nccl_launches_the_attention_kernels(card):
    """parallel/dryrun.py on every card (one NCCL rank each): one
    data-parallel step of DCCRN, Demucs and Sepformer; Sepformer's
    attention kernels run under DDP on every rank."""
    from speech_enhancement_torch.parallel.dryrun import FAMILIES, dryrun_multichip

    ranks = dryrun_multichip(torch.cuda.device_count(), timeout=300)
    for found in ranks:
        assert all(found[f]["step"] == 1 and np.isfinite(found[f]["loss"]) for f in FAMILIES)
        assert found["launches"]["mha_fwd"] > 0 and found["launches"]["mha_bwd"] > 0
        assert found["sepformer"] == ranks[0]["sepformer"]
