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
from speech_enhancement_torch.kernels.conv_block import (fused_conv_block, fused_conv_block_plain,
                                                         fused_deconv_block,
                                                         fused_deconv_block_plain)
from speech_enhancement_torch.kernels.masking import mask_e_kernel, mask_e_plain
from speech_enhancement_torch.kernels.stft import stft_kernel, stft_plain
from speech_enhancement_torch.models import build_model
from speech_enhancement_torch.models.dccrn import _stft_bases
from speech_enhancement_torch.train.evaluate import evaluate_utterance

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
    with pytest.raises(RuntimeError, match="backward"):
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
