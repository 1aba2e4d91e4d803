"""A numpy run of the bf16 LSTM backward kernel's ring path, on the CPU.

``csrc/lstm_bwd.cu:lstm_bwd_ring`` builds only on the card, so this file
walks its indexing with numpy, after the plan that
``kernels/lstm.py:bwd_ring_plan`` mirrors from ``ring::make_plan``: the
slice rows per unit, the ldmatrix row addresses of both operands (the
slab's swizzled batch rows, the slice's unit rows; the fragments of units
past U zeroed in registers), the rounds of each warp's K range in its own
ring (its own copies, the staggered round order, zero fill past B and 4H), the f32
partials each warp writes into its ring and the owners' fixed-order sums,
and the register epilogue of the (b, u) pairs each thread owns across all
steps. It holds the result against ``lstm_bwd_plain`` in f32, so an error
in any of those index formulas shows here; the card tests hold the CUDA
code itself.
"""

import math

import numpy as np
import pytest
import torch

from speech_enhancement_torch.kernels.lstm import bwd_ring_plan, lstm_bwd_plain, shift_prev

WARPS, THREADS, MAX_MW, PART_PITCH = 8, 256, 4, 24
H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SMS = 132


def ldmatrix(buf, addrs):
    """The four 8 x 8 matrices an ldmatrix.x4 reads: matrix i's row r is
    the 8 elements at lane 8 i + r's address."""
    rows = buf[np.asarray(addrs)[:, None] + np.arange(8)]
    return rows.reshape(4, 8, 8)


def conflict_free(addrs):
    """Each 8-lane phase of an ldmatrix reads eight 16-byte rows: they must
    sit on distinct 16-byte bank groups (addresses in 2-byte elements;
    lanes reading one address are a broadcast)."""
    for i in range(0, len(addrs), 8):
        rows = sorted(set(addrs[i:i + 8]))
        if len({(a * 2 // 16) % 8 for a in rows}) != len(rows):
            return False
    return True


def emulate_bwd_ring(gates, c_seq, c_prev, dout, w_hh, dh_last, dc_last, reverse, sms, smem):
    """The ring kernel's backward, block by block and warp by warp, in f32:
    (dgates, dh0, dc0, plan)."""
    steps, batch, g4 = gates.shape
    hidden = g4 // 4
    units = math.ceil(hidden / sms)
    blocks = math.ceil(hidden / units)
    p = bwd_ring_plan(units, hidden, batch, smem)
    assert p is not None and p["smem_bytes"] <= smem
    kc, kr, pitch, stages = p["kc"], p["kr"], p["pitch"], p["stages"]
    wm, wk, mw, nb, nt, ppt = p["wm"], p["wk"], p["mw"], p["nb"], p["nt"], p["ppt"]
    assert mw * 16 * PART_PITCH * 4 <= p["region"]  # the partials fit the ring they alias
    lc = {64: 3, 32: 2, 16: 1}[kc]
    lr, n_chunks_row, n16 = 3 - lc, kc // 8, kc // 16
    ring_at = p["ring_offset"] // 2  # element offsets (2-byte elements)
    slab_elems, region_elems = p["slab_bytes"] // 2, p["region"] // 2
    dgates = np.zeros_like(gates)

    # per block: shared memory (NaN where nothing was written), the pairs
    # each thread owns and their dh, dc registers
    state = []
    for blk in range(blocks):
        j0 = blk * units
        sm = np.full(ring_at + WARPS * region_elems, np.nan, np.float32)
        for r in range(units):
            sm[r * pitch:(r + 1) * pitch] = 0.0
            if j0 + r < hidden:
                sm[r * pitch:r * pitch + g4] = w_hh[j0 + r]
        pairs = []
        for tid in range(THREADS):
            for i in range(ppt):
                b, u = divmod(tid + THREADS * i, units)
                if b < batch and j0 + u < hidden:
                    pairs.append([b, u, float(dh_last[b, j0 + u]), float(dc_last[b, j0 + u])])
        state.append((j0, sm, pairs))

    def a_addr(lane, m, chunk):
        row = m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8
        return row * kc + ((chunk ^ ((row >> lr) & ((1 << lc) - 1))) << 3)

    def b_addr(lane, k):
        mi = lane >> 3
        unit = min((lane & 7) + 8 * (mi >> 1), units - 1)  # past U: row U - 1's address
        return unit * pitch + (mi & 1) * 8 + k

    for s in range(steps):
        t = s if reverse else steps - 1 - s
        for j0, sm, pairs in state:  # the pointwise part, from registers
            for pair in pairs:
                b, u, dh, dc = pair
                j = j0 + u
                i, f, g, o = gates[t, b, j::hidden]
                tc = np.tanh(c_seq[t, b, j])
                dh = dh + dout[t, b, j]
                d_o = dh * tc
                dc = dc + dh * o * (1 - tc * tc)
                di, df, dg = dc * g, dc * c_prev[t, b, j], dc * i
                dgates[t, b, j::hidden] = [di * i * (1 - i), df * f * (1 - f), dg * (1 - g * g),
                                           d_o * o * (1 - o)]
                pair[3] = dc * f
        src = dgates[t]  # the grid barrier: every block's dgates[t] is written
        for blk, (j0, sm, pairs) in enumerate(state):
            for c in range(p["chunks"]):
                sm[ring_at:] = np.nan  # whatever the ring held before
                parts = {}
                for warp in range(WARPS):
                    split, wmi = divmod(warp, wm)
                    row0 = c * nb + wmi * mw * 16
                    nv = min(max((batch - row0 + 15) // 16, 0), mw)
                    r_begin = split * p["rpw"]
                    ns = max(min(p["rpw"], kr - r_begin), 0)
                    first = blk % ns if ns else 0
                    region = ring_at + warp * region_elems
                    acc = np.zeros((MAX_MW, 2, 16, 8), np.float32)
                    for jr in range(ns):
                        r = r_begin + (first + jr) % ns
                        slab = region + (jr % stages) * slab_elems
                        # the warp's own copies of round r (issue()), lane by lane
                        for lane in range(32):
                            for idx in range(lane, nv * 16 * n_chunks_row, 32):
                                row, ch = idx >> lc, idx & (n_chunks_row - 1)
                                b, k = row0 + row, r * kc + ch * 8
                                dst = slab + row * kc + ((ch ^ ((row >> lr) & (n_chunks_row - 1)))
                                                         << 3)
                                sm[dst:dst + 8] = src[b, k:k + 8] if b < batch and k < g4 else 0.0
                        if nv == 0:
                            continue
                        for kk in range(n16):
                            kb = r * kc + 16 * kk
                            b_addrs = [b_addr(lane, kb) for lane in range(32)]
                            assert conflict_free(b_addrs[:16 if nt == 1 else 32])
                            mats = ldmatrix(sm, b_addrs)
                            b_tiles = [np.concatenate([mats[0], mats[1]], axis=1).T,
                                       np.concatenate([mats[2], mats[3]], axis=1).T]
                            for n in range(2):  # lane (g, q) zeroes unit n * 8 + g past U
                                b_tiles[n][:, np.arange(8) + 8 * n >= units] = 0.0
                            for m in range(nv):
                                addrs = [slab + a_addr(lane, m, 2 * kk + (lane >> 4))
                                         for lane in range(32)]
                                assert conflict_free(addrs)
                                am = ldmatrix(sm, addrs)
                                a_tile = np.block([[am[0], am[2]], [am[1], am[3]]])
                                for n in range(nt):
                                    acc[m, n] += a_tile @ b_tiles[n]
                    # the partials, [mw * 16 rows][PART_PITCH] f32 in the ring
                    part = np.full(mw * 16 * PART_PITCH, np.nan, np.float32)
                    for m in range(nv):
                        for n in range(nt):
                            for lane in range(32):
                                g, q = lane // 4, lane % 4
                                o = (m * 16 + g) * PART_PITCH + n * 8 + 2 * q
                                part[o:o + 2] = acc[m, n, g, 2 * q:2 * q + 2]
                                o += 8 * PART_PITCH
                                part[o:o + 2] = acc[m, n, g + 8, 2 * q:2 * q + 2]
                    parts[warp] = part
                for pair in pairs:  # the owners' sums, splits in order
                    bl = pair[0] - c * nb
                    if not 0 <= bl < nb:
                        continue
                    wg, row = divmod(bl, mw * 16)
                    v = np.float32(0.0)
                    for sp in range(wk):
                        v += parts[sp * wm + wg][row * PART_PITCH + pair[1]]
                    pair[2] = v
    dh0 = np.zeros((batch, hidden), np.float32)
    dc0 = np.zeros_like(dh0)
    for j0, _, pairs in state:
        for b, u, dh, dc in pairs:
            dh0[b, j0 + u], dc0[b, j0 + u] = dh, dc
    return dgates, dh0, dc0, p


def _inputs(steps, batch, hidden, reverse, seed):
    """A forward's gates and c (from ``fused_lstm_plain``'s formulas in
    numpy), and random gradients, in f32."""
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((steps, batch, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32)
    from speech_enhancement_torch.kernels.lstm import fused_lstm_plain
    h0, c0 = (0.5 * rng.standard_normal((2, batch, hidden))).astype(np.float32)
    _, c_seq, gates = fused_lstm_plain(*(torch.from_numpy(a) for a in (x_proj, w_hh, h0, c0)),
                                       reverse)
    c_prev = shift_prev(c_seq, torch.from_numpy(c0), reverse)
    dout = rng.standard_normal((steps, batch, hidden)).astype(np.float32)
    dh_last, dc_last = rng.standard_normal((2, batch, hidden)).astype(np.float32)
    return gates.numpy(), c_seq.numpy(), c_prev.numpy(), dout, w_hh, dh_last, dc_last


# (T, B, H, SMs, shared memory): each case takes another plan (checked
# below): B 16 in one m16 tile, K split eight ways, a round of 32 k and some
# splits without rounds; B 5 with nine units (units 9 to 15 of the second
# n8 tile zeroed in registers); a ragged last block (H 42, U 11) with two
# warps along the batch; B 70 over all eight warps along the batch, three
# of them without batch rows, four pairs a thread, k 16 a round; one n8 tile
# (U 8) and two m16 tiles a warp; B 300 in three chunks, sixteen pairs a
# thread; a 64-k round (H 128, U 11); three m16 tiles a warp, the last warp
# along the batch with two of them in the batch
RING_CASES = [
    (2, 16, 40, 4, 1 << 20),
    (3, 5, 36, 4, 48 * 1024),
    (2, 20, 42, 4, 40 * 1024),
    (2, 70, 40, 4, 24000),
    (2, 40, 64, 8, 1 << 20),
    (2, 300, 40, 4, 28000),
    (2, 9, 128, 12, 1 << 20),
    (2, 70, 40, 4, 1 << 20),
]
WANT_PLANS = [  # (kc, stages, wm, wk, mw, chunks, ppt, nt) of each case
    (32, 8, 1, 8, 1, 1, 1, 2),
    (32, 5, 1, 8, 1, 1, 1, 2),
    (32, 4, 2, 4, 1, 1, 1, 2),
    (16, 5, 8, 1, 1, 1, 4, 2),
    (64, 8, 2, 4, 2, 1, 4, 1),
    (32, 3, 8, 1, 1, 3, 16, 2),
    (64, 8, 1, 8, 1, 1, 1, 2),
    (64, 8, 2, 4, 3, 1, 4, 2),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case,want_plan", list(zip(RING_CASES, WANT_PLANS)))
def test_bwd_ring_indexing_matches_plain(case, want_plan, reverse):
    steps, batch, hidden, sms, smem = case
    args = _inputs(steps, batch, hidden, reverse, sum(case[:3]) + reverse)
    dgates, dh0, dc0, p = emulate_bwd_ring(*args, reverse, sms, smem)
    assert tuple(p[k] for k in ("kc", "stages", "wm", "wk", "mw", "chunks", "ppt",
                                "nt")) == want_plan
    want = lstm_bwd_plain(*(torch.from_numpy(a) for a in args), reverse)
    for got, ref, name in zip((dgates, dh0, dc0), want, ("dgates", "dh0", "dc0")):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_bwd_ring_plan_at_the_trained_shapes():
    """The plans on an H100 at CRN's train shape and at rnn-stft-mask's
    widest: the slice and the eight rings fit the 227 KB of a
    block, and each shape gets the split the kernel's source note
    describes."""
    def plan(hidden, batch):
        return bwd_ring_plan(math.ceil(hidden / H100_SMS), hidden, batch, H100_SMEM)

    train = plan(1792, 16)  # U 14: B 16 is one m16 tile; K split eight ways
    assert (train["units"], train["nt"], train["wm"], train["wk"], train["mw"],
            train["chunks"], train["ppt"]) == (14, 2, 1, 8, 1, 1, 1)
    assert train["pitch"] == 7176 and train["ring_offset"] == 200_928  # 14 x 7176 bf16
    # 28 rounds of 32 k a warp, a ring of three 1 KB slabs (the probe's choice)
    assert (train["kc"], train["stages"], train["rpw"]) == (32, 3, 28)
    mask = plan(896, 384)  # U 7: one n8 tile; all warps along the batch, three m-tiles each
    assert (mask["nt"], mask["kc"], mask["wm"], mask["wk"], mask["mw"], mask["nb"],
            mask["chunks"], mask["ppt"]) == (1, 64, 8, 1, 3, 384, 1, 16)
    for p in (train, mask, plan(1792, 1), plan(1792, 70), plan(896, 16)):
        assert p["smem_bytes"] <= H100_SMEM
        assert (p["pitch"] // 8) % 2 == 1  # the slice's ldmatrix rows on distinct bank groups
        assert 16 * p["mw"] * PART_PITCH * 4 <= p["region"]
    # more than 16 x 256 (b, u) pairs a block: the first design
    assert plan(1792, 16 * 256 // 14 + 1) is None
