"""A numpy run of the split-f32 STFT kernel's indexing, on the CPU.

``csrc/stft.cu:stft_tf32x3`` builds only on the card, so this file walks
its plan (``kernels/stft.py:tc_plan`` mirrors ``tc::make_plan``) with numpy:
the signal span a block stages (one piece per batch item its rows touch,
piece i at r hop + i gap), the A fragments' span offsets and their banks,
the basis slabs' split into big and small TF32 parts in the mma's fragment
order, the column split, and the three products a k8 step sums in f32. It
holds the result against ``stft_plain`` at DCCRN's geometry within the
smoke's f32 tolerance, and shows that one TF32 product (no split) falls
outside it; the card tests hold the CUDA code itself.
"""

import numpy as np
import pytest
import torch

from speech_enhancement_torch.kernels.stft import TC_BK, TC_BM, TC_BN, stft_plain, tc_plan
from speech_enhancement_torch.models.dccrn import _stft_bases

STFT_RTOL, STFT_ATOL = 1e-4, 2e-3  # chip_smoke.py's, as tests/test_pallas.py:22


def tf32(a):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from 0."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    big = tf32(a)
    return big, tf32(a - big)


def span_of(x, row0, n_frames, hop, win, gap, span_floats):
    """The block's staged span (NaN where nothing lands) and each of its
    128 rows' offsets into it (0 past the last frame), as the kernel
    computes them."""
    batch, total = x.shape
    rows = batch * n_frames
    nrows = min(TC_BM, rows - row0)
    b0 = row0 // n_frames
    span = np.full(span_floats, np.nan, np.float32)
    i = 0
    while True:
        first = (b0 + i) * n_frames - row0
        r_i = 0 if i == 0 else first
        if r_i >= nrows:
            break
        e_i = min(first + n_frames, nrows)
        words = ((e_i - r_i - 1) * hop + win) // 4
        src = (r_i - first) * hop
        dst = r_i * hop + i * gap
        assert dst % 4 == 0 and (b0 + i) * total % 4 == 0 and src % 4 == 0  # 16-byte copies
        span[dst:dst + 4 * words] = x[b0 + i, src:src + 4 * words]
        i += 1
    offs = np.array([r * hop + ((row0 + r) // n_frames - b0) * gap if r < nrows else 0
                     for r in range(TC_BM)])
    return span, offs, nrows


def fragment_split(basis, col0, k0, win):
    """A 16-tap slab of a column tile split into big and small parts in
    fragment order [k8][n8 tile][lane][4], as ``split_basis`` writes it
    (zero past win and D)."""
    dim = basis.shape[1]
    raw = np.zeros((TC_BK, TC_BN), np.float32)
    kk = min(TC_BK, win - k0)
    nn = min(TC_BN, dim - col0)
    raw[:kk, :nn] = basis[k0:k0 + kk, col0:col0 + nn]
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    sp = np.empty((TC_BK // 8, TC_BN // 8, 32, 4), np.float32)
    for ks in range(TC_BK // 8):
        cols = 8 * np.arange(TC_BN // 8)[:, None] + g  # [tile][lane]
        lo, hi = raw[8 * ks + q, cols], raw[8 * ks + q + 4, cols]
        (blo, slo), (bhi, shi) = split(lo), split(hi)
        sp[ks] = np.stack([blo, bhi, slo, shi], axis=-1)
    return sp


def emulate_tc(x, basis, hop, win, products=3):
    """The kernel's output, tile by tile: each k8 step adds a_small b_big,
    a_big b_small and a_big b_big (``products=1``: a_big b_big only) in f32."""
    batch, total = x.shape
    dim = basis.shape[1]
    n_frames = (total - win) // hop + 1
    p = tc_plan(batch, total, hop, win, dim)
    out = np.zeros((batch * n_frames, dim), np.float32)
    slabs = [[fragment_split(basis, c * TC_BN, st * TC_BK, win)
              for st in range(-(-win // TC_BK))] for c in range(p["col_tiles"])]
    frames = x.reshape(-1)
    for row0 in range(0, batch * n_frames, TC_BM):
        span, offs, nrows = span_of(x, row0, n_frames, hop, win, p["gap"], p["span_floats"])
        a_all = span[offs[:, None] + np.arange(win)]  # [128, win] as the fragments read it
        for r in range(nrows):  # the span holds each row's frame
            b, f = divmod(row0 + r, n_frames)
            np.testing.assert_array_equal(a_all[r], frames[b * total + f * hop:][:win])
        a_big, a_small = split(a_all)
        for c in range(p["col_tiles"]):
            acc = np.zeros((TC_BM, TC_BN), np.float32)
            for st, sp in enumerate(slabs[c]):
                for ks in range(min(TC_BK, win - st * TC_BK) // 8):
                    k = st * TC_BK + 8 * ks
                    # B [8 taps][176 columns] from lane (g, q)'s four values
                    lanes = sp[ks].reshape(TC_BN // 8, 8, 4, 4)  # [tile][g][q][4]
                    b_big = np.concatenate([lanes[..., 0], lanes[..., 1]], axis=2)  # [tile][g][k]
                    b_small = np.concatenate([lanes[..., 2], lanes[..., 3]], axis=2)
                    b_big = b_big.transpose(2, 0, 1).reshape(8, TC_BN)
                    b_small = b_small.transpose(2, 0, 1).reshape(8, TC_BN)
                    ab, as_ = a_big[:, k:k + 8], a_small[:, k:k + 8]
                    if products == 3:
                        acc += as_ @ b_big
                        acc += ab @ b_small
                    acc += ab @ b_big
            cols = min(TC_BN, dim - c * TC_BN)
            out[row0:row0 + nrows, c * TC_BN:c * TC_BN + cols] = acc[:nrows, :cols]
    return out.reshape(batch, n_frames, dim)


def dccrn_inputs(batch, total, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, total), dtype=np.float32)
    return x, _stft_bases(400, 512)[0].astype(np.float32)


@pytest.mark.parametrize("batch,total", [(2, 64600), (3, 7000)])
def test_tc_split_matches_plain_and_one_product_does_not(batch, total):
    """DCCRN's geometry (win 400, hop 100, D 514), a block across two batch
    items (643 frames an item) and, at 67 frames an item, a block across
    three, with a ragged last row tile: three products hold the smoke's
    f32 tolerance; one TF32 product does not."""
    x, basis = dccrn_inputs(batch, total, total + batch)
    want = stft_plain(torch.from_numpy(x), torch.from_numpy(basis), 100, 400).numpy()
    got = emulate_tc(x, basis, 100, 400)
    np.testing.assert_allclose(got, want, rtol=STFT_RTOL, atol=STFT_ATOL)
    one = emulate_tc(x, basis, 100, 400, products=1)
    excess = np.abs(one - want) - (STFT_ATOL + STFT_RTOL * np.abs(want))
    assert excess.max() > 0, "one TF32 product would hold the f32 tolerance"


def test_tc_plan_at_dccrn():
    """The plan at DCCRN's serving shape: the span of 128 frames across two
    batch items, three column tiles with at most 3% of computed columns
    idle, one block of 121 KB an SM; geometries the kernel does not take."""
    p = tc_plan(192, 64600, 100, 400, 514)
    assert p["gap"] == 320 and p["span_floats"] == 127 * 100 + 400 + 320
    computed = p["col_tiles"] * TC_BN
    assert p["col_tiles"] == 3 and (computed - 514) / computed <= 0.03
    # three split slabs, the span, four mbarriers
    assert p["smem_bytes"] == 4 * 3 * 5632 + 4 * p["span_floats"] + 32 == 121_296 <= 232_448
    assert tc_plan(1, 64600, 100, 400, 514)["span_floats"] == 13_100  # one item: one piece
    assert tc_plan(3, 7000, 100, 400, 514)["span_floats"] == 127 * 100 + 400 + 2 * 320
    for args in [(3, 7002, 100, 400, 514), (3, 7000, 102, 400, 514), (3, 7000, 100, 404, 514),
                 (3, 7000, 100, 400, 513)]:
        assert tc_plan(*args) is None  # not whole 16-byte words, win % 8, odd D
    assert tc_plan(192, 64600, 100, 400, 514, aligned=False) is None


@pytest.mark.parametrize("total", [64600, 7000])
def test_tc_a_fragments_free_of_bank_conflicts(total):
    """Lane (g, q) of a warp reads span[offset(row g) + k + q] (and rows
    g + 8): at hop 100 the 32 lanes hit 32 banks, in every block, across
    the pieces of two or three batch items as well."""
    batch, hop, win = 4, 100, 400
    n_frames = (total - win) // hop + 1
    p = tc_plan(batch, total, hop, win, 514)
    for row0 in range(0, batch * n_frames, TC_BM):
        _, offs, nrows = span_of(np.zeros((batch, total), np.float32), row0, n_frames, hop, win,
                                 p["gap"], p["span_floats"])
        for m16 in range(0, TC_BM, 8):
            if m16 + 8 > nrows:
                break
            for k in range(0, win, 8):
                banks = {(offs[m16 + lane // 4] + k + lane % 4) % 32 for lane in range(32)}
                assert len(banks) == 32, (row0, m16, k)
