"""A numpy walk of the bf16 attention kernels' plan and indexing, on the CPU.

``csrc/attention_fwd.cu`` and ``attention_bwd.cu`` build only on the card,
so this file holds their launch plan (``kernels/attention.py:mma_plan``,
the mirror of ``csrc/attention.cuh``'s ``fwd_plan`` / ``bwd_plan``) at the
shapes ``chip_smoke.py`` and Sepformer launch and at the limits, and walks
their indexing with numpy: the realigned 16-byte staging of a head block
into the pitched tile at every 4-byte residue, the ldmatrix / ldmatrix.trans
/ stmatrix.trans lane addresses (``trans_a``, ``trans_b``, ``plain_b``) and
the mma.sync fragment layouts of the PTX ISA, the realigned stores, and the
kernels' order of work (the forward's online softmax in steps of 32 and 16
keys; the backward's statistics pass and its pass over key tiles with the
staggered dQ rows). The walks are held against ``fused_mha_packed_plain``
and ``mha_bwd_plain``, so an error in any of those formulas shows here; the
card tests hold the CUDA code itself.
"""

import numpy as np
import pytest
import torch

from speech_enhancement_torch.kernels import attention as attn

LANES = np.arange(32)
G, T = LANES >> 2, LANES & 3  # the mma fragments' row group and column pair
PAIR = np.arange(2)
LOG2E = 1.4426950408889634
MASKED = -1e30
# chip_smoke.py's MHA_TOL for bf16: the forward's (atol, rtol); each gradient
# within 2^-7 of its largest element
BF16_TOL = (2.0**-9, 2.0**-7)


def bf16(x):
    """Values rounded to bf16 (round to nearest even, as torch and the card)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


# -- the plan ------------------------------------------------------------------

# (B', H, L, D): chip_smoke.py's MHA_TIMED and MHA_CHECKED, Sepformer's
# serving and training launches (configs/sepformer_clarity.yaml: chunk 250,
# H 8, D 32; intra L 250, inter L 66 at serving, L 66 at B 4 training), the
# small test models' depths, tests/test_torch_cuda.py's MHA_SHAPES
PLAN_CASES = [
    (12672, 8, 250, 32), (48000, 8, 66, 32), (264, 8, 250, 32), (1000, 8, 66, 32),
    (1024, 8, 250, 32), (1024, 8, 66, 32), (3, 2, 50, 16), (2, 4, 37, 8), (2, 2, 40, 24),
    (2, 2, 37, 12), (1, 1, 16, 32), (1, 1, 17, 32), (2, 2, 80, 32), (2, 2, 81, 32),
    (1, 2, 256, 32), (3, 3, 66, 32), (5, 1, 250, 32), (2, 2, 70, 64), (2, 2, 5, 16),
]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch,heads,length,depth", PLAN_CASES)
def test_plan_at_the_launched_shapes(batch, heads, length, depth, backward):
    p = attn.mma_plan(batch * heads, depth, length, backward)
    assert p["lp"] % 16 == 0 and p["lp"] - 16 < length <= p["lp"]
    assert p["dp"] in (16, 32, 64) and depth <= p["dp"] and (p["dp"] == 16 or 2 * depth > p["dp"])
    assert p["pitch"] == p["lp"] + 8 and (p["pitch"] * 2 // 16) % 2 == 1  # odd 16-byte words
    assert 1 <= p["warps"] <= 8 and p["threads"] == 32 * p["warps"]
    assert p["warps"] <= p["lp"] // 16  # every warp has a tile
    assert p["blocks"] * p["per_block"] >= batch * heads > (p["blocks"] - 1) * p["per_block"]
    assert p["smem"] <= attn.H100_SHARED and not attn.mma_refuses(batch * heads, depth, length,
                                                                     backward)


def test_plan_at_sepformers_shapes():
    """The numbers the kernels' source notes give."""
    fwd_intra, fwd_inter = attn.mma_plan(12672 * 8, 32, 250), attn.mma_plan(48000 * 8, 32, 66)
    assert (fwd_intra["lp"], fwd_intra["warps"], fwd_intra["per_block"], fwd_intra["blocks"],
            fwd_intra["raw"], fwd_intra["smem"]) == (256, 8, 8, 12672, 16016, 98736)
    assert (fwd_inter["lp"], fwd_inter["warps"], fwd_inter["per_block"], fwd_inter["blocks"],
            fwd_inter["raw"], fwd_inter["smem"]) == (80, 5, 8, 48000, 4240, 29616)
    # two forward blocks of eight warps an SM at L 250; without bulk copies
    # (an unaligned tensor) four of four
    assert 2 * (fwd_intra["smem"] + 1024) <= 233472
    plain = attn.mma_plan(12672 * 8, 32, 250, aligned=False)
    assert (plain["warps"], plain["raw"], plain["smem"]) == (4, 0, 50688)
    bwd_intra, bwd_inter = attn.mma_plan(264 * 8, 32, 250, True), attn.mma_plan(1000 * 8, 32, 66,
                                                                               True)
    assert (bwd_intra["warps"], bwd_intra["blocks"], bwd_intra["smem"]) == (8, 264, 111616)
    assert (bwd_inter["warps"], bwd_inter["blocks"], bwd_inter["smem"]) == (5, 1000, 36288)
    # two backward blocks fit an SM's 228 KB (1 KB reserved a block)
    assert 2 * (bwd_intra["smem"] + 1024) <= 233472


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("depth", [16, 32, 64])
def test_plan_limits(depth, backward):
    """The longest L each depth tile takes, the first it refuses, and the
    shapes refused whatever the memory: no wider than PR 5's kernels took
    (forward 1,440 / 800 / 416 at D 16 / 32 / 64, backward 672 / 384 / 192)."""
    longest = max(L for L in range(1, 4096) if not attn.mma_refuses(1, depth, L, backward))
    assert attn.mma_refuses(1, depth, longest + 1, backward)
    assert all(not attn.mma_refuses(1, depth, L, backward) for L in range(1, longest + 1, 7))
    taken_before = {False: {16: 1440, 32: 800, 64: 416}, True: {16: 672, 32: 384, 64: 192}}
    assert longest >= taken_before[backward][depth]
    for shape in ((0, depth, 10), (1, 0, 10), (1, 65, 10), (1, depth, 0)):
        assert attn.mma_refuses(*shape, backward)


# -- fragments: ldmatrix, stmatrix, movmatrix, mma.sync m16n8k16 ------------------

def trans_a(pitch, k0, r0):
    return (k0 + (LANES & 7) + ((LANES >> 4) << 3)) * pitch + r0 + (LANES & 8)


def trans_b(pitch, k0, n0):
    return (k0 + (LANES & 7) + (LANES & 8)) * pitch + n0 + ((LANES >> 4) << 3)


def plain_b(pitch, n0, k0):
    return (n0 + (LANES & 7) + ((LANES >> 4) << 3)) * pitch + k0 + (LANES & 8)


def ldsm(tile, addrs, trans):
    """ldmatrix.x4 (.trans): [4 matrices, 32 lanes, 2 elements]; lane i
    addresses row i % 8 of matrix i / 8, lane (g, t) gets [g][2t, 2t + 1]
    of each matrix, or of its transpose."""
    m = tile[addrs[:, None] + np.arange(8)].reshape(4, 8, 8)
    if trans:
        m = m.transpose(0, 2, 1)
    return m[:, G[:, None], 2 * T[:, None] + PAIR]


def stsm_trans(tile, addrs, regs):
    """stmatrix.x4.trans: the inverse of ldsm(..., trans=True)."""
    m = np.zeros((4, 8, 8))
    m[:, G[:, None], 2 * T[:, None] + PAIR] = regs
    for j in range(4):
        tile[addrs[8 * j:8 * j + 8, None] + np.arange(8)] = m[j].T


def movmatrix(reg):
    """movmatrix.m8n8.trans of one register a lane: [32, 2] -> [32, 2]."""
    m = np.zeros((8, 8))
    m[G[:, None], 2 * T[:, None] + PAIR] = reg
    return m.T[G[:, None], 2 * T[:, None] + PAIR]


def a_matrix(a):
    """A fragment [4, 32, 2] -> the 16 x 16 matrix: rows g, g + 8 at k 2t, 2t
    + 1 (registers 0, 1) and k 2t + 8, 2t + 9 (registers 2, 3)."""
    out = np.zeros((16, 16))
    out[G[:, None], 2 * T[:, None] + PAIR] = a[0]
    out[G[:, None] + 8, 2 * T[:, None] + PAIR] = a[1]
    out[G[:, None], 2 * T[:, None] + 8 + PAIR] = a[2]
    out[G[:, None] + 8, 2 * T[:, None] + 8 + PAIR] = a[3]
    return out


def b_matrix(b0, b1):
    """B fragment -> the 16 x 8 (k x n) matrix: k 2t, 2t + 1 (b0) and 2t + 8,
    2t + 9 (b1) of column g."""
    out = np.zeros((16, 8))
    out[2 * T[:, None] + PAIR, G[:, None]] = b0
    out[2 * T[:, None] + 8 + PAIR, G[:, None]] = b1
    return out


def acc_matrix(c):
    """Accumulator [32, 4] -> 16 x 8: rows g (c0, c1) and g + 8 (c2, c3) at
    columns 2t, 2t + 1."""
    out = np.zeros((16, 8))
    out[G[:, None], 2 * T[:, None] + PAIR] = c[:, :2]
    out[G[:, None] + 8, 2 * T[:, None] + PAIR] = c[:, 2:]
    return out


def acc_from(m):
    return np.concatenate([m[G[:, None], 2 * T[:, None] + PAIR],
                           m[G[:, None] + 8, 2 * T[:, None] + PAIR]], axis=1)


def mma(c, a, b0, b1):
    return acc_from(acc_matrix(c) + a_matrix(a) @ b_matrix(b0, b1))


def split(acc_pair, kk):
    """``a_split``: the A operand (hi, lo) of k16 slice kk of 16-row
    accumulators (a list of [32, 4] n8 tiles)."""
    x = np.stack([acc_pair[2 * kk][:, :2], acc_pair[2 * kk][:, 2:],
                  acc_pair[2 * kk + 1][:, :2], acc_pair[2 * kk + 1][:, 2:]])
    hi = bf16(x)
    return hi, bf16(x - hi)


def quad(x, op):
    """A reduction over the four lanes of each quad (lanes of one g)."""
    return np.repeat(op(x.reshape(8, 4), axis=1), 4)


def test_fragment_maps_on_a_pitched_tile():
    """ldmatrix.trans of a [k][row] tile at trans_a is the A fragment of its
    transpose; at trans_b, the B fragments of two n8 tiles of [k][n]; plain
    ldmatrix at plain_b, those of [n][k]; stmatrix.trans at plain_b is the
    inverse; movmatrix transposes a register's matrix."""
    rng = np.random.default_rng(0)
    pitch = 88
    tile = rng.standard_normal(40 * pitch)
    view = tile.reshape(40, pitch)
    a = ldsm(tile, trans_a(pitch, 16, 24), trans=True)  # rows 24.., k 16..
    np.testing.assert_array_equal(a_matrix(a), view[16:32, 24:40].T)
    b = ldsm(tile, trans_b(pitch, 16, 40), trans=True)  # k 16.., n 40..
    np.testing.assert_array_equal(b_matrix(b[0], b[1]), view[16:32, 40:48])
    np.testing.assert_array_equal(b_matrix(b[2], b[3]), view[16:32, 48:56])
    b = ldsm(tile, plain_b(pitch, 8, 32), trans=False)  # n 8.., k 32..
    np.testing.assert_array_equal(b_matrix(b[0], b[1]), view[8:16, 32:48].T)
    np.testing.assert_array_equal(b_matrix(b[2], b[3]), view[16:24, 32:48].T)
    out = np.zeros_like(tile)
    c = [rng.standard_normal((32, 4)) for _ in range(2)]  # two n8 tiles of a 16-row tile
    regs = np.stack([c[0][:, :2], c[0][:, 2:], c[1][:, :2], c[1][:, 2:]])
    stsm_trans(out, plain_b(pitch, 16, 48), regs)
    np.testing.assert_array_equal(out.reshape(40, pitch)[16:32, 48:64],
                                  np.concatenate([acc_matrix(c[0]), acc_matrix(c[1])], 1).T)
    reg = rng.standard_normal((32, 2))
    m = np.zeros((8, 8))
    m[G[:, None], 2 * T[:, None] + PAIR] = reg
    back = np.zeros((8, 8))
    back[G[:, None], 2 * T[:, None] + PAIR] = movmatrix(reg)
    np.testing.assert_array_equal(back, m.T)


@pytest.mark.parametrize("lp", range(16, 1216, 16))
def test_pitched_rows_fall_on_distinct_banks(lp):
    """Every ldmatrix / stmatrix matrix reads or writes eight 16-byte rows of a
    pitched tile; the pitch makes their bank groups distinct (no conflict)."""
    pitch = lp + 8
    for addrs in (trans_a(pitch, 0, 16), trans_b(pitch, 16, 0), plain_b(pitch, 0, 16)):
        for j in range(4):
            rows = addrs[8 * j:8 * j + 8] * 2  # bytes
            assert np.all(rows % 16 == 0)
            assert len(set((rows // 16) % 8)) == 8


# -- staging and stores ------------------------------------------------------------

def realign(lo, hi, s):
    return np.concatenate([lo, hi])[s:s + 8]


def unit_walk(threads, per_row, depth):
    """``UnitWalk``: each thread's units (d, c) of a [depth][per_row] grid,
    ``threads`` units a step, by its carries instead of a division."""
    for tid in range(threads):
        d, c = divmod(tid, per_row)
        dq, dr = divmod(threads, per_row)
        while d < depth:
            yield d, c
            c, d = c + dr, d + dq
            if c >= per_row:
                c, d = c - per_row, d + 1


def stage(mem, base, depth, length, lp, dp, pitch, threads=160):
    """``stage_tiles`` for one tensor: the head block at element ``base`` of
    the flat buffer ``mem`` (16-byte chunks = 8 elements) into a pitched
    [dp][pitch] tile, rows [depth, dp) zero. Also checks that every chunk
    read holds an element of the unit's row."""
    tile = np.full(dp * pitch, np.nan)
    tile[depth * pitch:] = 0.0  # zero_rows
    for d, c in unit_walk(threads, lp // 8, depth):
        l0 = 8 * c
        live = l0 < length
        p = base + d * length + l0
        s = p % 8 if live else 0
        row = range(base + d * length, base + (d + 1) * length)
        lo = hi = np.zeros(8)
        if live:
            lo = mem[p - s:p - s + 8]
            assert any(e in row for e in range(p - s, p - s + 8))
            if s > 0 and l0 + 8 - s < length:
                hi = mem[p - s + 8:p - s + 16]
                assert any(e in row for e in range(p - s + 8, p - s + 16))
        val = realign(lo, hi, s).copy()
        val[l0 + np.arange(8) >= length] = 0.0  # mask_frames
        assert np.isnan(tile[d * pitch + l0]), "a unit staged twice"
        tile[d * pitch + l0:d * pitch + l0 + 8] = val
    return tile


def land_and_realign(mem, base, depth, length, lp, dp, pitch, threads=256):
    """The bulk copy of an aligned head block (whole 16-byte words) into a
    raw buffer of ``_raw_bytes`` bytes, then ``realign_tiles``: reads stay
    inside the raw buffer."""
    n = depth * length
    assert base % 8 == 0 and n % 8 == 0
    raw = np.full(attn._raw_bytes(depth, length) // 2, np.nan)
    raw[:n] = mem[base:base + n]
    tile = np.full(dp * pitch, np.nan)
    tile[depth * pitch:] = 0.0
    for d, c in unit_walk(threads, lp // 8, depth):
        l0, e = 8 * c, d * length + 8 * c
        val = np.zeros(8)
        if l0 < length:
            w = e >> 3
            assert 8 * w + 16 <= len(raw)
            val = realign(raw[8 * w:8 * w + 8], raw[8 * w + 8:8 * w + 16], e & 7).copy()
            val[l0 + np.arange(8) >= length] = 0.0
        tile[d * pitch + l0:d * pitch + l0 + 8] = val
    assert not np.isnan(tile.reshape(dp, pitch)[:, :lp]).any()
    return tile


def store(mem, base, tile, depth, length, pitch, threads=160):
    """``store_tile``: rows [d][0, length) of the pitched tile into the head
    block at element ``base``; 16-byte words where the block allows, each
    thread's words walked by carries."""
    n = depth * length
    if n % 8 or base % 8 or length < 8:
        for e in range(n):
            d = e // length
            mem[base + e] = tile[d * pitch + e - d * length]
        return

    def row_chunk(row, l):
        a = row + (l & ~7)
        assert (l & ~7) + 16 <= pitch
        return realign(tile[a:a + 8], tile[a + 8:a + 16], l & 7)

    step = 8 * threads
    dq, dr = divmod(step, length)
    for tid in range(threads):
        d, l = divmod(8 * tid, length)
        for e in range(8 * tid, n, step):
            assert (d, l) == divmod(e, length)
            row = d * pitch
            if l + 8 <= length:
                val = row_chunk(row, l)
            else:
                val = realign(row_chunk(row, length - 8), tile[row + pitch:row + pitch + 8],
                              8 - (length - l))
            mem[base + e:base + e + 8] = val
            l, d = l + dr, d + dq
            if l >= length:
                l, d = l - length, d + 1


@pytest.mark.parametrize("residue", [0, 4, 8, 12])  # bytes past a 16-byte boundary
@pytest.mark.parametrize("depth,length", [(32, 250), (32, 66), (16, 17), (12, 37), (24, 16),
                                          (16, 5)])
def test_staging_and_stores_at_every_residue(residue, depth, length):
    rng = np.random.default_rng(length)
    base = 64 + residue // 2
    dp = 16 if depth <= 16 else 32 if depth <= 32 else 64
    lp = -(-length // 16) * 16
    pitch = lp + 8
    mem = rng.standard_normal(base + 2 * depth * length + 64)
    want = np.zeros((dp, pitch))
    want[:depth, :length] = mem[base:base + depth * length].reshape(depth, length)
    tiles = [stage(mem, base, depth, length, lp, dp, pitch, threads)
             for threads in (128, 160, 256)]
    if residue == 0 and depth * length % 8 == 0:
        tiles.append(land_and_realign(mem, base, depth, length, lp, dp, pitch))
    for tile in tiles:
        np.testing.assert_array_equal(tile.reshape(dp, pitch)[:, :lp], want[:, :lp])
    for threads in (128, 160, 256):
        out = np.full_like(mem, np.nan)
        store(out, base, tiles[0], depth, length, pitch, threads)
        np.testing.assert_array_equal(out[base:base + depth * length],
                                      mem[base:base + depth * length])
        assert np.isnan(out[:base]).all() and np.isnan(out[base + depth * length:]).all()


# -- the forward ---------------------------------------------------------------------

def attend_step(qa, ks, vs, pitch, c0, nt_count, mask, length, c, m, l, acc):
    """``attend_step`` for one of a warp's tiles: NT n8 key tiles from c0;
    keys past length set to -inf where ``mask`` (the last step)."""
    dk, dt_count = len(qa), len(acc)
    s = [np.zeros((32, 4)) for _ in range(nt_count)]
    for kk in range(dk):
        for npair in range(nt_count // 2):
            kb = ldsm(ks, trans_b(pitch, 16 * kk, c0 + 16 * npair), trans=True)
            s[2 * npair] = mma(s[2 * npair], qa[kk], kb[0], kb[1])
            s[2 * npair + 1] = mma(s[2 * npair + 1], qa[kk], kb[2], kb[3])
    col = c0 + 8 * np.arange(nt_count)[:, None, None] + 2 * T[None, :, None] + np.array(
        [0, 1, 0, 1])
    s = np.stack(s).astype(np.float32)
    if mask:
        s = np.where(col >= length, -np.inf, s)
    else:
        assert (col < length).all()
    mx = np.stack([s[:, :, 2 * r:2 * r + 2].max(axis=(0, 2)) for r in range(2)], 1)
    grown = np.maximum(m, np.stack([quad(mx[:, r], np.max) for r in range(2)], 1) * c)
    f = np.exp2(m - grown)
    m[:] = grown
    l *= f
    for dt in range(dt_count):
        acc[dt] *= np.repeat(f, 2, axis=1)
    p = np.exp2(s * c - np.repeat(m, 2, axis=1)[None])
    l += p.reshape(nt_count, 32, 2, 2).sum(axis=(0, 3))
    p = list(p)
    for kk in range(nt_count // 2):
        hi, lo = split(p, kk)
        for dpair in range(dt_count // 2):
            vb = ldsm(vs, plain_b(pitch, 16 * dpair, c0 + 16 * kk), trans=False)
            for half, part in ((0, hi), (0, lo), (1, hi), (1, lo)):
                acc[2 * dpair + half] = mma(acc[2 * dpair + half], part, vb[2 * half],
                                            vb[2 * half + 1])


def forward_head(qs, ks, vs, dp, lp, length, pitch, scale, warps, pair):
    """``mha_fwd_mma``'s work on one staged head: each warp's tiles (two at
    once where ``pair``: they share the K and V fragments, and each keeps its
    own statistics), the output written into q's tile."""
    c = np.float32(scale * LOG2E)
    qt = 2 if pair else 1
    starts = [r0 for w in range(warps) for r0 in range(16 * qt * w, lp, 16 * qt * warps)]
    assert sorted(r0 + 16 * q for r0 in starts for q in range(qt)) == list(range(0, lp, 16))
    last = lp - 16 if lp % 32 else lp - 32
    for r0 in (r0 + 16 * q for r0 in starts for q in range(qt)):
        qa = [ldsm(qs, trans_a(pitch, 16 * kk, r0), trans=True) for kk in range(dp // 16)]
        m = np.full((32, 2), -np.inf)
        l = np.zeros((32, 2))
        acc = [np.zeros((32, 4)) for _ in range(dp // 8)]
        for c0 in range(0, last, 32):
            attend_step(qa, ks, vs, pitch, c0, 4, False, length, c, m, l, acc)
        attend_step(qa, ks, vs, pitch, last, 2 if lp % 32 else 4, True, length, c, m, l, acc)
        inv = 1.0 / np.stack([quad(l[:, r], np.sum) for r in range(2)], 1)
        for dpair in range(dp // 16):
            a0, a1 = (acc[2 * dpair + j] * np.repeat(inv, 2, 1) for j in range(2))
            regs = bf16(np.stack([a0[:, :2], a0[:, 2:], a1[:, :2], a1[:, 2:]]))
            stsm_trans(qs, plain_b(pitch, 16 * dpair, r0), regs)


def packed(rng, batch, heads, depth, length):
    return [torch.from_numpy(rng.standard_normal((batch, heads * depth, length), np.float32))
            .to(torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("batch,heads,length,depth,residue", [
    (1, 2, 66, 32, 0), (1, 1, 50, 16, 4), (1, 2, 17, 16, 8), (1, 1, 37, 24, 12), (1, 1, 16, 32, 0),
    (1, 1, 250, 32, 0), (1, 1, 96, 16, 2), (1, 1, 250, 32, 4),
])
def test_forward_walk_matches_plain(batch, heads, length, depth, residue):
    """Stage, attend and store each head as the bf16 forward does, from a
    buffer whose head blocks start ``residue`` bytes past a 16-byte boundary."""
    rng = np.random.default_rng(depth + length)
    q, k, v, _ = packed(rng, batch, heads, depth, length)
    want = attn.fused_mha_packed_plain(q, k, v, heads).float().numpy()
    p = attn.mma_plan(batch * heads, depth, length, aligned=residue == 0)
    dp, lp, pitch = p["dp"], p["lp"], p["pitch"]
    n, base = depth * length, 64 + residue // 2
    flat = [np.concatenate([np.zeros(base), x.float().numpy().reshape(-1), np.zeros(64)])
            for x in (q, k, v)]
    out = np.full_like(flat[0], np.nan)
    for h in range(batch * heads):
        if p["raw"]:
            qs, ks, vs = (land_and_realign(x, base + h * n, depth, length, lp, dp, pitch,
                                           p["threads"]) for x in flat)
        else:
            qs, ks, vs = (stage(x, base + h * n, depth, length, lp, dp, pitch, p["threads"])
                          for x in flat)
        forward_head(qs, ks, vs, dp, lp, length, pitch, 1.0 / depth ** 0.5, p["warps"],
                     p["pair"])
        store(out, base + h * n, qs, depth, length, pitch, p["threads"])
    got = out[base:base + batch * heads * n].reshape(want.shape)
    atol, rtol = BF16_TOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# -- the backward --------------------------------------------------------------------

def stats_step(qa, ga, ks, vs, pitch, c0, nt_count, mask, length, c, m, l, dsum):
    """``stats_step``: S and dP for NT n8 key tiles from c0, the running max
    (log2 units), the sum of 2^(y - m) and of 2^(y - m) dP."""
    s = [np.zeros((32, 4)) for _ in range(nt_count)]
    dp = [np.zeros((32, 4)) for _ in range(nt_count)]
    for kk in range(len(qa)):
        for npair in range(nt_count // 2):
            kb = ldsm(ks, trans_b(pitch, 16 * kk, c0 + 16 * npair), trans=True)
            vb = ldsm(vs, trans_b(pitch, 16 * kk, c0 + 16 * npair), trans=True)
            for half in range(2):
                j = 2 * npair + half
                s[j] = mma(s[j], qa[kk], kb[2 * half], kb[2 * half + 1])
                dp[j] = mma(dp[j], ga[kk], vb[2 * half], vb[2 * half + 1])
    col = c0 + 8 * np.arange(nt_count)[:, None, None] + 2 * T[None, :, None] + np.array(
        [0, 1, 0, 1])
    s, dp = np.stack(s).astype(np.float32), np.stack(dp)
    if mask:
        s = np.where(col >= length, -np.inf, s)
    mx = np.stack([s[:, :, 2 * r:2 * r + 2].max(axis=(0, 2)) for r in range(2)], 1)
    grown = np.maximum(m, np.stack([quad(mx[:, r], np.max) for r in range(2)], 1) * c)
    f = np.exp2(m - grown)
    m[:] = grown
    l *= f
    dsum *= f
    p = np.exp2(s * c - np.repeat(m, 2, axis=1)[None])
    l += p.reshape(nt_count, 32, 2, 2).sum(axis=(0, 3))
    dsum += (p * dp).reshape(nt_count, 32, 2, 2).sum(axis=(0, 3))


def stats_tile(qs, ks, vs, gs, dp, lp, length, pitch, r0, c, row_m, row_il, row_d):
    qa = [ldsm(qs, trans_a(pitch, 16 * kk, r0), trans=True) for kk in range(dp // 16)]
    ga = [ldsm(gs, trans_a(pitch, 16 * kk, r0), trans=True) for kk in range(dp // 16)]
    m, l, dsum = np.full((32, 2), -np.inf), np.zeros((32, 2)), np.zeros((32, 2))
    last = lp - 16 if lp % 32 else lp - 32
    for c0 in range(0, last, 32):
        stats_step(qa, ga, ks, vs, pitch, c0, 4, False, length, c, m, l, dsum)
    stats_step(qa, ga, ks, vs, pitch, last, 2 if lp % 32 else 4, True, length, c, m, l, dsum)
    lead = T == 0  # the lane of each quad that writes
    for r in range(2):
        il = 1.0 / quad(l[:, r], np.sum)
        rows = r0 + G[lead] + 8 * r
        row_m[rows] = m[lead, r]
        row_il[rows] = il[lead]
        row_d[rows] = quad(dsum[:, r], np.sum)[lead] * il[lead]


def grad_step(qs, ks, vs, gs, stats, dq, dp, pitch, k0, q0, length, c, dk, dv):
    """``grad_step``: one warp's key tile against one 16-query step."""
    row_m, row_il, row_d = stats
    s = [np.zeros((32, 4)) for _ in range(2)]
    dpt = [np.zeros((32, 4)) for _ in range(2)]
    ka = [ldsm(ks, trans_a(pitch, 16 * kk, k0), trans=True) for kk in range(dp // 16)]
    va = [ldsm(vs, trans_a(pitch, 16 * kk, k0), trans=True) for kk in range(dp // 16)]
    kb = [ldsm(ks, plain_b(pitch, 16 * dpair, k0), trans=False) for dpair in range(dp // 16)]
    for kk in range(dp // 16):
        qb = ldsm(qs, trans_b(pitch, 16 * kk, q0), trans=True)
        gb = ldsm(gs, trans_b(pitch, 16 * kk, q0), trans=True)
        for half in range(2):
            s[half] = mma(s[half], ka[kk], qb[2 * half], qb[2 * half + 1])
            dpt[half] = mma(dpt[half], va[kk], gb[2 * half], gb[2 * half + 1])
    for nt in range(2):
        q = q0 + 8 * nt + 2 * T[:, None] + np.array([0, 1, 0, 1])
        key = k0 + G[:, None] + 8 * (np.arange(4) >> 1)
        p = np.exp2(s[nt] * c - row_m[q]) * row_il[q]
        p = np.where((key >= length) | (q >= length), 0.0, p)
        s[nt], dpt[nt] = p, p * (dpt[nt] - row_d[q])
    phi, plo = split(s, 0)
    shi, slo = split(dpt, 0)
    for dpair in range(dp // 16):
        gb = ldsm(gs, plain_b(pitch, 16 * dpair, q0), trans=False)
        qb = ldsm(qs, plain_b(pitch, 16 * dpair, q0), trans=False)
        for half in range(2):
            j = 2 * dpair + half
            for part in (phi, plo):
                dv[j] = mma(dv[j], part, gb[2 * half], gb[2 * half + 1])
            for part in (shi, slo):
                dk[j] = mma(dk[j], part, qb[2 * half], qb[2 * half + 1])
    ah = np.stack([movmatrix(shi[j]) for j in (0, 2, 1, 3)])
    al = np.stack([movmatrix(slo[j]) for j in (0, 2, 1, 3)])
    for dt in range(dp // 8):
        b = kb[dt // 2]
        d4 = mma(mma(np.zeros((32, 4)), ah, b[2 * (dt & 1)], b[2 * (dt & 1) + 1]), al,
                 b[2 * (dt & 1)], b[2 * (dt & 1) + 1])
        cols = 8 * dt + 2 * T[:, None] + PAIR
        dq[q0 + G[:, None], cols] += d4[:, :2]
        dq[q0 + G[:, None] + 8, cols] += d4[:, 2:]


def backward_head(qs, ks, vs, gs, depth, dp, lp, length, pitch, scale, warps):
    """``mha_bwd_mma``'s work on one staged head: the statistics pass, then
    the rounds of key tiles with their staggered query steps (checked: no
    two warps on one dQ row block in an iteration), dK and dV into k's and
    v's tiles, dQ (scaled, rounded) into q's."""
    c = np.float32(scale * LOG2E)
    stats = tuple(np.full(lp, np.nan) for _ in range(3))
    for w in range(warps):
        for r0 in range(16 * w, lp, 16 * warps):
            stats_tile(qs, ks, vs, gs, dp, lp, length, pitch, r0, c, *stats)
    assert not any(np.isnan(x).any() for x in stats)
    tiles = lp // 16
    dq = np.zeros((lp, dp))
    for rnd in range(-(-tiles // warps)):
        mine = [(w + rnd * warps) for w in range(warps) if w + rnd * warps < tiles]
        state = {kt: ([np.zeros((32, 4)) for _ in range(dp // 8)],
                      [np.zeros((32, 4)) for _ in range(dp // 8)]) for kt in mine}
        for i in range(tiles):
            steps = [(kt + i) % tiles for kt in mine]
            assert len(set(steps)) == len(steps)
            for kt in mine:
                grad_step(qs, ks, vs, gs, stats, dq, dp, pitch, 16 * kt, 16 * ((kt + i) % tiles),
                          length, c, *state[kt])
        for kt in mine:
            dk, dv = state[kt]
            for dpair in range(dp // 16):
                for tile, acc, mul in ((ks, dk, scale), (vs, dv, 1.0)):
                    a0, a1 = acc[2 * dpair] * mul, acc[2 * dpair + 1] * mul
                    regs = bf16(np.stack([a0[:, :2], a0[:, 2:], a1[:, :2], a1[:, 2:]]))
                    stsm_trans(tile, plain_b(pitch, 16 * dpair, 16 * kt), regs)
    assert not dq[:, depth:].any()  # K's padded rows are zero
    qs.reshape(dp, pitch)[:depth, :lp] = bf16(dq.T[:depth] * scale)


@pytest.mark.parametrize("batch,heads,length,depth,residue", [
    (1, 2, 66, 32, 0), (1, 1, 50, 16, 4), (1, 2, 17, 16, 8), (1, 1, 37, 24, 12),
    (1, 1, 16, 32, 0), (1, 1, 130, 32, 0),
])
def test_backward_walk_matches_plain(batch, heads, length, depth, residue):
    """Stage q, k, v, g; the two passes; store dq, dk, dv, as the bf16 backward
    does, against mha_bwd_plain (each gradient within 2^-7 of its largest,
    chip_smoke.py's bound)."""
    rng = np.random.default_rng(depth * length)
    q, k, v, g = packed(rng, batch, heads, depth, length)
    want = [x.float().numpy() for x in attn.mha_bwd_plain(q, k, v, g, heads)]
    p = attn.mma_plan(batch * heads, depth, length, backward=True)
    dp, lp, pitch = p["dp"], p["lp"], p["pitch"]
    assert p["raw"] == 0
    n, base = depth * length, 64 + residue // 2
    flat = [np.concatenate([np.zeros(base), x.float().numpy().reshape(-1), np.zeros(64)])
            for x in (q, k, v, g)]
    outs = [np.full_like(flat[0], np.nan) for _ in range(3)]
    for h in range(batch * heads):
        tiles = [stage(x, base + h * n, depth, length, lp, dp, pitch, p["threads"]) for x in flat]
        backward_head(*tiles, depth, dp, lp, length, pitch, 1.0 / depth ** 0.5, p["warps"])
        for out, tile in zip(outs, tiles[:3]):
            store(out, base + h * n, tile, depth, length, pitch, p["threads"])
    for out, ref, name in zip(outs, want, ("dq", "dk", "dv")):
        got = out[base:base + batch * heads * n].reshape(ref.shape)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= BF16_TOL[1], (name, err)
