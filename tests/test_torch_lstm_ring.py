"""A numpy run of the bf16 LSTM forward kernel's ring path, on the CPU.

``csrc/lstm_fwd.cu:lstm_fwd_ring`` builds only on the card, so this file
takes its host plan's mirror (``kernels/lstm.py:fwd_ring_plan``, line for
line ``ring::make_plan``) and walks its indexing with numpy: the slice
rows per gate and unit, the ldmatrix row addresses of the A and B
fragments, the rounds' slabs of h_prev in the ring (each warp's
own copies, the staggered k order, zero fill past B and H), the split
partials' shared-memory layout
and the register epilogue's reading of the accumulators. It holds the
result against ``fused_lstm_plain`` in f32, so an error in any of those
index formulas shows here; the card tests hold the CUDA code itself.
"""

import math

import numpy as np
import pytest
import torch

from speech_enhancement_torch.kernels.lstm import fused_lstm_plain
from speech_enhancement_torch.kernels.lstm import fwd_ring_plan as ring_plan

WARPS = 8
H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SMS = 132


def ldmatrix(buf, addrs):
    """The four 8 x 8 matrices an ldmatrix.x4 reads: matrix i's row r is
    the 8 elements at lane 8 i + r's address."""
    return [np.stack([buf[addrs[8 * i + r]:addrs[8 * i + r] + 8] for r in range(8)])
            for i in range(4)]


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def emulate_ring(x_proj, w_hh, h0, c0, reverse, sms, smem_limit):
    """The ring kernel's forward, block by block and warp by warp, in f32."""
    steps, batch, g4 = x_proj.shape
    hidden = g4 // 4
    units = math.ceil(hidden / sms)
    blocks = math.ceil(hidden / units)
    p = ring_plan(units, hidden, batch, smem_limit)
    mt, ntw, kc, kr, nb = p["mt"], p["ntw"], p["kc"], p["kr"], p["nb"]
    pitch, spitch, splits, wn_all = p["pitch"], p["spitch"], p["splits"], p["wn"]
    upt = 2 if mt == 4 else 1
    nt = (batch + 7) // 8
    wt = np.ascontiguousarray(w_hh.T)  # [4H, H]
    c = c0.astype(np.float32).copy()
    h_seq = np.zeros((steps, batch, hidden), np.float32)
    c_seq = np.zeros_like(h_seq)
    gates = np.zeros_like(x_proj)

    slices = []
    for blk in range(blocks):
        ws = np.zeros(p["rows"] * pitch, np.float32)
        j0 = blk * units
        for r in range(p["rows"]):
            gate, u = divmod(r, units)
            if j0 + u < hidden:
                ws[r * pitch:r * pitch + hidden] = wt[gate * hidden + j0 + u]
        slices.append(ws)

    def a_offsets(lane):
        mi, rr = lane >> 3, (lane & 7) + ((lane >> 3) & 1) * 8
        offs = []
        for m in range(mt):
            gate = m if mt == 4 else 2 * m + (rr >> 3)
            unit = min(rr if mt == 4 else rr & 7, units - 1)
            offs.append((gate * units + unit) * pitch + (mi >> 1) * 8)
        return offs

    a_off = [a_offsets(lane) for lane in range(32)]

    def copy_slab(hprev, n0, k0, c_i):
        """A round's slab as each warp sees it (the kernel's issue()): only
        a warp barrier publishes the copies, so warp w may read only what
        its own lanes copied (zero past B and H); all else is NaN here, and
        a product that read it would show."""
        views = {}
        vrow = kc // 8
        for warp in range(WARPS):
            split, wn = divmod(warp, wn_all)
            if split >= splits:
                continue
            slab = views[warp] = np.full(nb * spitch, np.nan, np.float32)

            def put(n, k, ok, slab=slab):
                slab[n * spitch + k - k0:n * spitch + k - k0 + 8] = (
                    hprev[n0 + n, k:k + 8] if ok else 0.0)

            for lane in range(32):
                if splits == 1:
                    base = wn * ntw * 8
                    nrows = min(max(nt - (c_i * nb // 8 + wn * ntw), 0), ntw) * 8
                    k = k0 + (lane % vrow) * 8
                    rows = batch - n0 - base if k < hidden else 0
                    for n in range(lane // vrow, nrows, 32 // vrow):
                        put(base + n, k, n < rows)
                else:
                    row, kh = wn * 8 + (lane & 7), ((lane >> 3) & 1) * 8
                    for k16 in range(split + (lane >> 4) * splits, kc // 16, 2 * splits):
                        k = k0 + k16 * 16 + kh
                        put(row, k, n0 + row < batch and k < hidden)
        return views

    for s in range(steps):
        t = steps - 1 - s if reverse else s
        hprev = h0 if s == 0 else h_seq[t + 1 if reverse else t - 1]
        new = []
        for blk in range(blocks):
            j0, ws = blk * units, slices[blk]

            def slab_k0(r):
                ks = r % kr + blk % kr
                return (ks - kr if ks >= kr else ks) * kc

            part = np.zeros(max(splits - 1, 0) * mt * 16 * nb, np.float32)
            for c_i in range(p["chunks"]):
                acc = {}  # (warp, j, m) -> [16, 8]
                for r in range(c_i * kr, (c_i + 1) * kr):
                    n0, k0 = r // kr * nb, slab_k0(r)
                    views = copy_slab(hprev, n0, k0, c_i)
                    n16 = min(p["hp"] - k0, kc) // 16
                    for warp in range(WARPS):
                        split, wn = divmod(warp, wn_all)
                        nv = min(max(nt - (c_i * nb // 8 + wn * ntw), 0), ntw)
                        if split >= splits or nv == 0:
                            continue
                        for k16 in range(split, n16, splits):
                            a_tiles = []
                            for m in range(mt):
                                mats = ldmatrix(ws, [a_off[ln][m] + k0 + 16 * k16
                                                     for ln in range(32)])
                                a_tiles.append(np.block([[mats[0], mats[2]],
                                                         [mats[1], mats[3]]]))
                            for jp in range((ntw + 1) // 2):
                                addrs = []
                                for ln in range(32):
                                    mi = ln >> 3
                                    tile = wn * ntw + 2 * jp + (mi >> 1)
                                    off = (tile * 8 + (ln & 7)) * spitch + (mi & 1) * 8
                                    addrs.append(min(off + 16 * k16, nb * spitch - 8))
                                mats = ldmatrix(views[warp], addrs)
                                for j, (b0, b1) in ((2 * jp, mats[:2]), (2 * jp + 1, mats[2:])):
                                    if j >= nv:
                                        continue
                                    b_tile = np.concatenate([b0, b1], axis=1).T  # [k16, n8]
                                    for m in range(mt):
                                        key = (warp, j, m)
                                        acc[key] = acc.get(key, 0) + a_tiles[m] @ b_tile

                def reg(warp, j, m, lane, e):
                    """Accumulator e of a lane: rows g, g + 8; columns 2q, 2q + 1."""
                    g, q = lane // 4, lane % 4
                    tile = acc.get((warp, j, m))
                    return 0.0 if tile is None else tile[g + 8 * (e >> 1), 2 * q + (e & 1)]

                regs = {}
                for warp in range(WARPS):
                    split, wn = divmod(warp, wn_all)
                    for lane in range(32):
                        for j in range(ntw):
                            for m in range(mt):
                                regs[warp, lane, j, m] = [reg(warp, j, m, lane, e)
                                                          for e in range(4)]
                if splits > 1:  # the partials' round trip through shared memory
                    for warp in range(WARPS):
                        split, wn = divmod(warp, wn_all)
                        if 0 < split < splits:
                            for lane in range(32):
                                g, q = lane // 4, lane % 4
                                for m in range(mt):
                                    for e in range(4):
                                        idx = ((split - 1) * mt * 16 + m * 16 + g
                                               + 8 * (e >> 1)) * nb + wn * 8 + 2 * q + (e & 1)
                                        part[idx] = regs[warp, lane, 0, m][e]
                    for wn in range(wn_all):
                        for lane in range(32):
                            g, q = lane // 4, lane % 4
                            for sp in range(1, splits):
                                for m in range(mt):
                                    for e in range(4):
                                        idx = ((sp - 1) * mt * 16 + m * 16 + g
                                               + 8 * (e >> 1)) * nb + wn * 8 + 2 * q + (e & 1)
                                        regs[wn, lane, 0, m][e] += part[idx]
                for wn in range(wn_all):  # the owners' epilogue (split 0)
                    nv = min(max(nt - (c_i * nb // 8 + wn * ntw), 0), ntw)
                    for lane in range(32):
                        g, q = lane // 4, lane % 4
                        for j in range(nv):
                            for e in range(2):
                                b = c_i * nb + (wn * ntw + j) * 8 + 2 * q + e
                                for us in range(upt):
                                    u = g + 8 * us
                                    if b >= batch or u >= units or j0 + u >= hidden:
                                        continue
                                    if mt == 4:
                                        lin = [regs[wn, lane, j, gate][2 * us + e]
                                               for gate in range(4)]
                                    else:
                                        lin = [regs[wn, lane, j, gate >> 1][2 * (gate & 1) + e]
                                               for gate in range(4)]
                                    x = x_proj[t, b, j0 + u::hidden]
                                    i, f, gg, o = (sigmoid(x[0] + lin[0]), sigmoid(x[1] + lin[1]),
                                                   np.tanh(x[2] + lin[2]), sigmoid(x[3] + lin[3]))
                                    cn = f * c[b, j0 + u] + i * gg
                                    new.append((b, j0 + u, cn, o * np.tanh(cn), (i, f, gg, o)))
        for b, j, cn, h, gv in new:  # the grid barrier: the step's writes land together
            c[b, j] = cn
            h_seq[t, b, j], c_seq[t, b, j] = h, cn
            gates[t, b, j::hidden] = gv
    return h_seq, c_seq, gates, p


# (T, B, H, SMs, shared memory): a gate a tile (MT 4) with a ragged batch in
# two chunks of one column tile a warp, three tiles a warp (.x4 and .x2 B
# loads) over three k rounds, K split over warps (B < 64) with a partial
# last round, two gates a tile (MT 2) with a ragged last block, four tiles a
# warp, and an H not a multiple of 16 with one unit in the second row half
RING_CASES = [
    (3, 70, 40, 4, 4480 + 3 * 64 * 24 * 2),
    (2, 190, 40, 4, 4480 + 3 * 192 * 24 * 2),
    (3, 20, 40, 4, 4480 + 1 * 4 * 16 * 24 * 4 + 3 * 24 * 40 * 2),
    (3, 3, 40, 6, 48 * 1024),
    (3, 200, 24, 4, 1 << 20),
    (2, 12, 72, 8, 48 * 1024),
]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_indexing_matches_plain(case, reverse):
    steps, batch, hidden, sms, smem = case
    rng = np.random.default_rng(sum(case[:3]) + reverse)
    x_proj = rng.standard_normal((steps, batch, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32)
    h0, c0 = (0.5 * rng.standard_normal((2, batch, hidden))).astype(np.float32)
    got = emulate_ring(x_proj, w_hh, h0, c0, reverse, sms, smem)
    want = fused_lstm_plain(*(torch.from_numpy(a) for a in (x_proj, w_hh, h0, c0)), reverse)
    for g, w, name in zip(got[:3], want, ("h_seq", "c_seq", "gates")):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


def test_ring_plan_at_the_served_shapes():
    """The plans at CRN's and rnn-stft-mask's shapes on an H100: the slice
    and three slabs fit the 227 KB of a block, and each shape gets the
    chunking the kernel's source note describes."""
    def plan(hidden, batch):
        return ring_plan(math.ceil(hidden / H100_SMS), hidden, batch, H100_SMEM)

    serve = plan(1792, 192)  # U 14: one chunk of 192 columns, 112 rounds of k 16
    assert (serve["mt"], serve["ntw"], serve["chunks"], serve["kc"], serve["kr"]) == (4, 3, 1, 16,
                                                                                      112)
    assert serve["ring_offset"] == 201_600 and serve["smem_bytes"] == 229_248
    train = plan(1792, 16)  # K split four ways over two column tiles
    assert (train["splits"], train["wn"], train["nb"], train["kc"], train["kr"]) == (4, 2, 16,
                                                                                     128, 14)
    ragged = plan(1792, 200)  # 25 tiles: two chunks of 16 tiles pad the fewest
    assert (ragged["ntw"], ragged["chunks"], ragged["kc"]) == (2, 2, 32)
    mask = plan(896, 384)  # U 7: two gates a tile, one chunk of 384 columns
    assert (mask["mt"], mask["ntw"], mask["nb"], mask["kc"], mask["kr"]) == (2, 6, 384, 64, 14)
    for p in (serve, train, ragged, mask):
        assert p["smem_bytes"] <= H100_SMEM
        assert (p["spitch"] // 8) % 2 == 1 and (p["pitch"] // 8) % 2 == 1  # ldmatrix rows
