"""A numpy run of the wide LSTM kernels' indexing, on the CPU.

``csrc/lstm_fwd.cu:lstm_fwd_wide`` and ``csrc/lstm_bwd.cu:lstm_bwd_wide``
build only on the card, so this file walks their plans
(``kernels/lstm.py:wide_plan`` mirrors ``lstm.cuh:wide::make_plan``, and
``lstm_design`` the kernels' whole choice) with numpy, on fake cards
(``sms``, ``smem_limit``) small enough that the wide design takes small
widths: the resident rounds of the slice and the streamed ones (each
staged with the batch rows of its round, zero past B, K and the last
unit), the rounds' order from each block's starting round, the two stage
slots, the 32-bit fragment loads of both operands (their banks), the
bf16 products and the split-f32 ones with both operands split in
registers, the K splits' partials and the fixed order in which split 0
adds them, and the owners' pointwise parts across all steps. It holds the
result against ``fused_lstm_plain`` / ``lstm_bwd_plain`` and the JAX
kernels in interpret mode, in f32 within 1e-4 (1 + |ref|) (chip_smoke.py's
LSTM_F32_TOL) and in bf16 within 3e-2 of the peak (tests/test_torch_lstm.py's
bf16 bound); then pins the designs on an H100 at every width from 128 to
2048. The card tests hold the CUDA code itself.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas import lstm as jax_lstm
from speech_enhancement_torch.kernels.lstm import (bwd_ring_plan, f32_plan, first_plan_bytes,
                                                   fused_lstm_plain, fwd_ring_plan, lstm_bwd_plain,
                                                   lstm_design, shift_prev, wide_plan)

WARPS = 8
H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SMS = 132
F32_TOL = 1e-4   # |d| <= 1e-4 (1 + |ref|): chip_smoke.py's LSTM_F32_TOL
BF16_TOL = 3e-2  # of the reference's largest magnitude: tests/test_torch_lstm.py's bf16 bound
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rounded(a, dtype):
    """``a`` stored in ``dtype`` (bf16: round to nearest even, as
    __float2bfloat16 and torch's cast), back in f32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(DTYPES[dtype]).float().numpy()


def split(a):
    """mmautil::split_tf32: the big part rounded to TF32 (ties away from
    zero), the small part (a - big) truncated to TF32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    rest = np.ascontiguousarray(a - big, np.float32).view(np.uint32)
    return big, (rest & np.uint32(0xFFFFE000)).view(np.float32)


def sigmoid(x):
    return np.float32(1.0) / (np.float32(1.0) + np.exp(-x))


def distinct_banks(word_addrs):
    """A warp's 32-bit shared loads (word addresses, one phase): no two
    lanes on one bank at different words."""
    seen = {}
    for w in word_addrs.tolist():
        if seen.setdefault(w % 32, w) != w:
            return False
    return True


_PATTERNS = {}


def banks_ok(word_addrs):
    """distinct_banks, once for each pattern of offsets from lane 0 (a
    shift of all the words keeps or breaks it alike)."""
    key = (word_addrs - word_addrs[0]).tobytes()
    if key not in _PATTERNS:
        _PATTERNS[key] = distinct_banks(word_addrs)
    return _PATTERNS[key]


LANE = np.arange(32)
G, Q = LANE // 4, LANE % 4


class Block:
    """One block of a wide kernel: its shared memory (NaN where nothing
    was written; the T region in elements, the f32 partials apart), its
    plan, its units and its own starting round."""

    def __init__(self, p, eb, index, w, hidden):
        self.p, self.eb, self.index = p, eb, index
        self.j0 = index * p["units"]
        self.w, self.hidden = w, hidden  # w: [rows of K] (w_hhᵀ forward, w_hh backward)
        assert p["stage_offset"] % 16 == 0 and p["slot_bytes"] % 16 == 0
        assert p["part_offset"] % 16 == 0 and p["smem_bytes"] <= p["limit"]
        self.tsm = np.full(p["part_offset"] // eb, np.nan, np.float32)
        self.part = np.full((p["smem_bytes"] - p["part_offset"]) // 4, np.nan, np.float32)
        self.first = index % p["kr"]
        self.grows = [self.slice_row(r) for r in range(p["rows"])]
        # wide::load_resident: [rows][pitch], zero past K and the last unit
        res_k = p["res_rounds"] * p["kc"]
        for r, grow in enumerate(self.grows):
            o = r * p["pitch"]
            assert (o * eb) % 16 == 0
            self.tsm[o:o + res_k] = self.row_range(grow, 0, res_k)

    def slice_row(self, r):
        """wide::slice_row: the row of w that slice row r holds, or -1."""
        p = self.p
        gate = r // p["units"] if p["mt"] == 4 else 0
        u = r - gate * p["units"]
        return gate * self.hidden + self.j0 + u if self.j0 + u < self.hidden else -1

    def row_range(self, grow, k0, n):
        """Elements [k0, k0 + n) of w's row grow, zero past K (or all zero)."""
        out = np.zeros(n, np.float32)
        if grow >= 0:
            got = self.w[grow, k0:k0 + n]
            out[:len(got)] = got
        return out

    def stage_round(self, slot, src, batch, n0, rnd):
        """wide::stage_round: a streamed round's slice rows, then the batch
        rows of the chunk, kc elements from k = rnd kc, zero past B and K;
        16-byte copies (vector v of a row: its first element's k < K)."""
        p, eb = self.p, self.eb
        v = 16 // eb
        k0 = rnd * p["kc"]
        base = p["stage_offset"] // eb + slot * p["slot_bytes"] // eb
        if rnd >= p["res_rounds"]:
            for r, grow in enumerate(self.grows):
                o = base + r * p["spitch"]
                assert (o * eb) % 16 == 0
                self.tsm[o:o + p["kc"]] = self.row_range(grow, k0, p["kc"])
        for n in range(p["nb"]):
            o = base + (p["rows"] + n) * p["spitch"]
            assert (o * eb) % 16 == 0 and (p["spitch"] * eb) % 16 == 0
            row = np.zeros(p["kc"], np.float32)
            if n0 + n < batch:
                got = src[n0 + n, k0:k0 + p["kc"]]
                assert len(got) % v == 0  # K % V == 0: a vector is whole or past K
                row[:len(got)] = got
            self.tsm[o:o + p["kc"]] = row

    def fragments(self, a_off, a_pitch, b_off, ar, k, wn_i, ntw):
        """One k step's fragments of a warp, as its lanes load them: the A
        tiles [mt, 16, kstep] (lane (g, q) loads rows g and g + 8 at k q and
        q + 4 in f32, k 2q and 2q + 8 in bf16) and the B tiles [ntw, kstep,
        8] (row g of each n8 batch tile), with the loads' banks checked."""
        p, eb, sm = self.p, self.eb, self.tsm
        bf16 = eb == 2
        cols = np.stack([2 * Q, 2 * Q + 8] if bf16 else [Q, Q + 4])  # [half, lane]
        a_addr = a_off + ar[:, :, None, :] * a_pitch + k + cols[None, None]  # [m, h, half, lane]
        b_rows = (wn_i * ntw + np.arange(ntw))[:, None] * 8 + G[None]  # [j, lane]
        b_addr = b_off + b_rows[:, None, :] * p["spitch"] + k + cols[None]  # [j, half, lane]
        a_tiles = np.full((p["mt"], 16, p["kstep"]), np.nan, np.float32)
        b_tiles = np.full((ntw, p["kstep"], 8), np.nan, np.float32)
        for addr, is_a in ((a_addr, True), (b_addr, False)):
            words = addr // 2 if bf16 else addr
            if bf16:  # ld32: two elements at an even element address
                assert (addr % 2 == 0).all()
            for row in words.reshape(-1, 32):
                assert banks_ok(row)
            for e in range(2 if bf16 else 1):
                vals = sm[addr + e]
                for half in range(2):
                    if is_a:
                        for h in range(2):
                            a_tiles[:, G + 8 * h, cols[half] + e] = vals[:, h, half]
                    else:
                        b_tiles[:, cols[half] + e, G] = vals[:, half]
        assert not np.isnan(a_tiles).any() and not np.isnan(b_tiles).any()
        return a_tiles, b_tiles

    def chunk(self, src, batch, n0):
        """wide::wide_chunk for every warp: (acc[warp][j][m] as 16 x 8 tiles
        after the partials met in split 0, the warps' nv)."""
        p, eb = self.p, self.eb
        mt, ntw, wn, wk, units = p["mt"], p["ntw"], p["wn"], p["wk"], p["units"]
        nt = (batch + 7) // 8
        ar = np.array([[(m * units if mt == 4 else 0) + np.minimum(G + 8 * h, units - 1)
                        for h in range(2)] for m in range(mt)])  # [m, h, lane]
        acc = np.zeros((WARPS, ntw, mt, 16, 8), np.float32)
        nvs = [min(max(nt - (n0 // 8 + (w % wn) * ntw), 0), ntw) for w in range(WARPS)]
        slot_elems = p["slot_bytes"] // eb
        stage = p["stage_offset"] // eb
        order = [(i + self.first) % p["kr"] for i in range(p["kr"])]
        self.stage_round(0, src, batch, n0, order[0])
        for i, rnd in enumerate(order):
            if i + 1 < p["kr"]:  # round i + 1 into the other slot, under round i's products
                self.stage_round((i + 1) & 1, src, batch, n0, order[i + 1])
            slot = stage + (i & 1) * slot_elems
            if rnd < p["res_rounds"]:
                a_off, a_pitch = rnd * p["kc"], p["pitch"]
            else:
                a_off, a_pitch = slot, p["spitch"]
            b_off = slot + p["rows"] * p["spitch"]
            for warp in range(WARPS):
                split_i, wn_i = divmod(warp, wn)
                if not nvs[warp]:
                    continue
                for ks in range(split_i, p["kc"] // p["kstep"], wk):
                    a_tiles, b_tiles = self.fragments(a_off, a_pitch, b_off, ar,
                                                      ks * p["kstep"], wn_i, ntw)
                    for j in range(nvs[warp]):
                        for m in range(mt):
                            if eb == 2:
                                acc[warp, j, m] += a_tiles[m] @ b_tiles[j]
                                continue
                            ab, a_s = split(a_tiles[m])
                            bb, bs = split(b_tiles[j])
                            acc[warp, j, m] += a_s @ bb
                            acc[warp, j, m] += ab @ bs
                            acc[warp, j, m] += ab @ bb
        if wk > 1:  # the partials, then split 0 adds them in split order
            part = self.part
            for warp in range(wn, WARPS):
                split_i, wn_i = divmod(warp, wn)
                for j in range(nvs[warp]):
                    for m in range(mt):
                        for e in range(4):
                            rows = (split_i - 1) * mt * 16 + m * 16 + G + 8 * (e >> 1)
                            cols = (wn_i * ntw + j) * 8 + 2 * Q + (e & 1)
                            part[rows * p["nb"] + cols] = acc[warp, j, m, G + 8 * (e >> 1),
                                                              2 * Q + (e & 1)]
            for warp in range(wn):
                for sp in range(1, wk):
                    for j in range(nvs[warp]):
                        for m in range(mt):
                            for e in range(4):
                                rows = (sp - 1) * mt * 16 + m * 16 + G + 8 * (e >> 1)
                                cols = (warp * ntw + j) * 8 + 2 * Q + (e & 1)
                                got = part[rows * p["nb"] + cols]
                                assert not np.isnan(got).any()
                                acc[warp, j, m, G + 8 * (e >> 1), 2 * Q + (e & 1)] += got
        return acc, nvs

    def owned(self, acc, nvs, batch, n0):
        """Split 0's owned outputs from the accumulators' layout (row g + 8
        (e / 2), column 2q + e % 2 of each tile): (b, j, acc[j][m] at (b, u)
        for each m, as [pairs, mt]), each (b, u) once."""
        p = self.p
        bs, us, vals = [], [], []
        for warp in range(p["wn"]):
            for j in range(nvs[warp]):
                for e in range(4):
                    rows, cols = G + 8 * (e >> 1), 2 * Q + (e & 1)
                    bs.append(n0 + (warp * p["ntw"] + j) * 8 + cols)
                    us.append(rows)
                    vals.append(acc[warp, j][:, rows, cols].T)
        b, u, v = np.concatenate(bs), np.concatenate(us), np.concatenate(vals)
        keep = (b < batch) & (u < p["units"]) & (self.j0 + u < self.hidden)
        assert len(set(zip(b[keep].tolist(), u[keep].tolist()))) == keep.sum()
        return b[keep], self.j0 + u[keep], v[keep]


def plan_for(kernel, dtype, hidden, batch, sms, smem):
    design, p = lstm_design(kernel, DTYPES[dtype], hidden, batch, sms, smem)
    assert design == "wide"
    return {**p, "limit": smem}


def emulate_fwd(x_proj, w_hh, h0, c0, reverse, sms, smem, dtype):
    """lstm_fwd_wide, block by block and warp by warp: (h_seq, c_seq,
    gates, plan), in the i/o dtype's values."""
    steps, batch, g4 = x_proj.shape
    hidden = g4 // 4
    eb = 2 if dtype == "bfloat16" else 4
    p = plan_for("fwd", dtype, hidden, batch, sms, smem)
    wt = np.ascontiguousarray(w_hh.T)  # [4H, H]
    blocks = [Block(p, eb, i, wt, hidden) for i in range(math.ceil(hidden / p["units"]))]
    c = c0.astype(np.float32).copy()  # the f32 carry (a.c)
    h_seq = np.zeros((steps, batch, hidden), np.float32)
    c_seq = np.zeros_like(h_seq)
    gates = np.zeros_like(x_proj)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    for s, t in enumerate(order):
        hprev = h0 if s == 0 else h_seq[t + 1 if reverse else t - 1]
        for blk in blocks:
            for n0 in range(0, batch, p["nb"]):
                acc, nvs = blk.chunk(hprev, batch, n0)
                b, j, acc_bj = blk.owned(acc, nvs, batch, n0)
                lin = np.stack([x_proj[t, b, gate * hidden + j] for gate in range(4)], 1)
                lin = lin + acc_bj
                i, f, g, o = sigmoid(lin[:, 0]), sigmoid(lin[:, 1]), np.tanh(lin[:, 2]), sigmoid(
                    lin[:, 3])
                cn = f * c[b, j] + i * g
                c[b, j] = cn
                h_seq[t, b, j], c_seq[t, b, j] = o * np.tanh(cn), cn
                for gate, v in enumerate((i, f, g, o)):
                    gates[t, b, gate * hidden + j] = v
        # the stores round to the i/o dtype; the next step reads h_seq as stored
        h_seq[t], c_seq[t], gates[t] = (rounded(a, dtype) for a in (h_seq[t], c_seq[t],
                                                                    gates[t]))
    return h_seq, c_seq, gates, p


def emulate_bwd(gates, c_seq, c_prev, dout, w_hh, dh_last, dc_last, reverse, sms, smem, dtype):
    """lstm_bwd_wide, block by block and warp by warp: (dgates, dh0, dc0,
    plan)."""
    steps, batch, g4 = gates.shape
    hidden = g4 // 4
    eb = 2 if dtype == "bfloat16" else 4
    p = plan_for("bwd", dtype, hidden, batch, sms, smem)
    blocks = [Block(p, eb, i, w_hh, hidden) for i in range(math.ceil(hidden / p["units"]))]
    dh = dh_last.astype(np.float32).copy()  # a.dh, a.dc: f32, each (b, j) its block's
    dc = dc_last.astype(np.float32).copy()
    dgates = np.zeros_like(gates)
    order = range(steps) if reverse else range(steps - 1, -1, -1)
    for t in order:
        for blk in blocks:  # the pointwise part for the block's own units
            for idx in range(p["units"] * batch):
                b, u = divmod(idx, p["units"])
                j = blk.j0 + u
                if j >= hidden:
                    continue
                i, f, g, o = gates[t, b, j::hidden]
                tc = np.tanh(c_seq[t, b, j])
                dhv = dh[b, j] + dout[t, b, j]
                d_o = dhv * tc
                dcv = dc[b, j] + dhv * o * (1 - tc * tc)
                di, df, dg = dcv * g, dcv * c_prev[t, b, j], dcv * i
                dgates[t, b, j::hidden] = (di * i * (1 - i), df * f * (1 - f), dg * (1 - g * g),
                                           d_o * o * (1 - o))
                dc[b, j] = dcv * f
        dgates[t] = rounded(dgates[t], dtype)  # the grid barrier: dgates[t] as stored
        for blk in blocks:
            for n0 in range(0, batch, p["nb"]):
                acc, nvs = blk.chunk(dgates[t], batch, n0)
                b, j, acc_bj = blk.owned(acc, nvs, batch, n0)
                dh[b, j] = acc_bj[:, 0]
    return dgates, dh, dc, p


def _fwd_inputs(steps, batch, hidden, seed, dtype, state=True):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((steps, batch, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32)
    h0, c0 = (0.5 * rng.standard_normal((2, batch, hidden))).astype(np.float32)
    if not state:
        h0, c0 = np.zeros_like(h0), np.zeros_like(c0)
    return tuple(rounded(a, dtype) for a in (x_proj, w_hh, h0, c0))


def _bwd_inputs(steps, batch, hidden, reverse, seed, dtype):
    """A forward's gates and c (fused_lstm_plain), and random gradients."""
    x_proj, w_hh, h0, c0 = _fwd_inputs(steps, batch, hidden, seed, dtype)
    tdt = DTYPES[dtype]
    _, c_seq, gates = fused_lstm_plain(*(torch.from_numpy(a).to(tdt)
                                         for a in (x_proj, w_hh, h0, c0)), reverse)
    c_prev = shift_prev(c_seq, torch.from_numpy(c0).to(tdt), reverse)
    rng = np.random.default_rng(seed + 1)
    dout = rounded(rng.standard_normal((steps, batch, hidden)), dtype)
    dh_last, dc_last = rng.standard_normal((2, batch, hidden)).astype(np.float32)
    return (gates.float().numpy(), c_seq.float().numpy(), c_prev.float().numpy(), dout, w_hh,
            dh_last, dc_last)


def _close(got, want, dtype, name):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        bound = F32_TOL * (1 + np.abs(want))
    else:
        bound = BF16_TOL * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (name, float(err.max()))


PLAN_KEYS = ("units", "wn", "wk", "ntw", "nb", "chunks", "kc", "kr", "res_rounds")

# (T, B, H, SMs, shared memory, dtype) and the plan (PLAN_KEYS) each takes.
# The forward: B 70 over eight warps along the batch (a phantom tile), K 192
# in 24 rounds of 8, one resident; B 12 over two warps along the batch and
# four along K, a ragged last block (H 100: U 13, the last 9), K 100 not a
# multiple of the round; B 5 over eight warps along K, no round resident;
# bf16: B 200 in two chunks of 192 (the second ragged); B 12 with a ragged
# last block (H 232: U 15, the last 7) and K
FWD_CASES = [
    ((2, 70, 192, 16, 19456, "float32"), (12, 8, 1, 2, 128, 1, 8, 24, 1)),
    ((3, 12, 100, 8, 39424, "float32"), (13, 2, 4, 1, 16, 1, 32, 4, 1)),
    ((3, 5, 192, 16, 45056, "float32"), (12, 1, 8, 1, 8, 1, 64, 3, 0)),
    ((2, 200, 192, 16, 25600, "bfloat16"), (12, 8, 1, 3, 192, 2, 16, 12, 1)),
    ((3, 12, 232, 16, 43008, "bfloat16"), (15, 2, 4, 1, 16, 1, 64, 4, 1)),
]
# The backward (K = 4H): B 16 over two warps along the batch and four along
# K, a ragged last block (H 36: U 5, the last 1) and K 144 not a multiple
# of the round; B 260 in two chunks of 256 (four tiles a warp); B 5 with
# none resident; bf16 B 12 (two of four rounds resident) and B 70
BWD_CASES = [
    ((3, 16, 36, 8, 10240, "float32"), (5, 2, 4, 1, 16, 1, 32, 5, 1)),
    ((2, 260, 64, 8, 26112, "float32"), (8, 8, 1, 4, 256, 2, 8, 32, 2)),
    ((3, 5, 64, 8, 12288, "float32"), (8, 1, 8, 1, 8, 1, 64, 4, 0)),
    ((3, 12, 64, 8, 12288, "bfloat16"), (8, 2, 4, 1, 16, 1, 64, 4, 2)),
    ((2, 70, 32, 4, 14336, "bfloat16"), (8, 8, 1, 2, 128, 1, 16, 8, 4)),
]
# (T, B, H, SMs, shared memory) of the comparisons with the JAX kernels:
# each a wide plan with the K split and part of the slice resident
JAX_CASES = {("fwd", "float32"): (4, 18, 192, 16, 54784),
             ("fwd", "bfloat16"): (3, 12, 232, 16, 43008),
             ("bwd", "float32"): (4, 18, 128, 8, 22528),
             ("bwd", "bfloat16"): (4, 18, 128, 8, 22528)}


def _plan_tuple(p):
    return tuple(p[k] for k in PLAN_KEYS)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case,want_plan", FWD_CASES)
def test_fwd_wide_indexing_matches_plain(case, want_plan, reverse):
    steps, batch, hidden, sms, smem, dtype = case
    args = _fwd_inputs(steps, batch, hidden, sum(case[:3]) + reverse, dtype)
    *got, p = emulate_fwd(*args, reverse, sms, smem, dtype)
    assert _plan_tuple(p) == want_plan
    tdt = DTYPES[dtype]
    want = fused_lstm_plain(*(torch.from_numpy(a).to(tdt) for a in args), reverse)
    for g, w, name in zip(got, want, ("h_seq", "c_seq", "gates")):
        _close(g, w.float().numpy(), dtype, name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case,want_plan", BWD_CASES)
def test_bwd_wide_indexing_matches_plain(case, want_plan, reverse):
    steps, batch, hidden, sms, smem, dtype = case
    args = _bwd_inputs(steps, batch, hidden, reverse, sum(case[:3]) + reverse, dtype)
    *got, p = emulate_bwd(*args, reverse, sms, smem, dtype)
    assert _plan_tuple(p) == want_plan
    tdt = DTYPES[dtype]
    want = lstm_bwd_plain(*(torch.from_numpy(a).to(tdt) for a in args[:5]),
                          *(torch.from_numpy(a) for a in args[5:]), reverse)
    for g, w, name in zip(got, want, ("dgates", "dh0", "dc0")):
        _close(g, w.float().numpy(), dtype, name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kernel,dtype", list(JAX_CASES))
def test_wide_designs_match_the_jax_kernels(kernel, dtype, reverse):
    """Each emulated kernel against its Pallas kernel in interpret mode,
    with an initial state (forward) and final-state gradients (backward),
    on a fake card whose wide plan splits K over the warps and keeps part
    of the slice resident."""
    steps, batch, hidden, sms, smem = JAX_CASES[kernel, dtype]
    jdt = jnp.dtype(dtype)
    if kernel == "fwd":
        args = _fwd_inputs(steps, batch, hidden, 21 + reverse, dtype)
        *got, p = emulate_fwd(*args, reverse, sms, smem, dtype)
        want = jax_lstm._lstm_fwd_call(*(jnp.asarray(a).astype(jdt) for a in args), reverse,
                                       True)
        names = ("h_seq", "c_seq", "gates")
    else:
        args = _bwd_inputs(steps, batch, hidden, reverse, 23 + reverse, dtype)
        gates, c_seq, c_prev, dout, w_hh, dh_last, dc_last = args
        *got, p = emulate_bwd(*args, reverse, sms, smem, dtype)
        want = jax_lstm._lstm_bwd_call(
            *(jnp.asarray(a).astype(jdt) for a in (gates, c_seq, c_prev, dout)),
            jnp.asarray(w_hh.T).astype(jdt), jnp.asarray(dh_last), jnp.asarray(dc_last),
            reverse, True)
        names = ("dgates", "dh0", "dc0")
    assert 0 < p["res_rounds"] < p["kr"] and p["wk"] > 1
    for g, w, name in zip(got, want, names):
        _close(g, np.asarray(w.astype(jnp.float32)), dtype, name)


# The designs of the shapes served today (chip_smoke.py's LSTM cases and
# the models' paths), pinned: the wide design must take none of them.
SERVED = [
    ("fwd", "bfloat16", 1792, 192, "ring"),     # CRN serve (bf16)
    ("fwd", "bfloat16", 1792, 16, "ring"),      # CRN train
    ("bwd", "bfloat16", 1792, 16, "ring"),
    ("fwd", "bfloat16", 896, 384, "ring"),      # rnn-stft-mask serve
    ("fwd", "bfloat16", 896, 16, "ring"),       # rnn-stft-mask train
    ("bwd", "bfloat16", 896, 16, "ring"),
    ("fwd", "float32", 256, 192, "f32"),        # mel-rnn serve, Demucs DConv layer 4
    ("fwd", "float32", 256, 16, "f32"),         # mel-rnn train
    ("bwd", "float32", 256, 16, "f32"),
    ("fwd", "float32", 256, 8, "f32"),          # Demucs DConv layer 4 train
    ("bwd", "float32", 256, 8, "f32"),
    ("fwd", "float32", 512, 192, "f32"),        # Demucs DConv layer 5
    ("fwd", "float32", 512, 8, "f32"),
    ("bwd", "float32", 512, 8, "f32"),
    ("fwd", "bfloat16", 512, 192, "ring"),
    ("bwd", "bfloat16", 512, 8, "ring"),
]
# This slice's shapes: CRN at f32 and Demucs's bottleneck BLSTM
WIDE = [("fwd", "float32", 1792, 192), ("fwd", "float32", 1792, 16),
        ("bwd", "float32", 1792, 16), ("fwd", "float32", 2048, 192),
        ("fwd", "float32", 2048, 8), ("bwd", "float32", 2048, 8),
        ("fwd", "bfloat16", 2048, 192), ("fwd", "bfloat16", 2048, 8),
        ("bwd", "bfloat16", 2048, 8)]


def _others_fit(kernel, dtype, hidden, batch):
    """Whether a design other than the wide one holds the shape on an H100
    (its plan's own test, as ``choose`` runs them)."""
    units = -(-hidden // H100_SMS)
    eb = 2 if dtype == "bfloat16" else 4
    if kernel == "fwd":
        if eb == 2:
            return fwd_ring_plan(units, hidden, batch, H100_SMEM) is not None
        if f32_plan(units, (units + 1) // 2, 8, hidden, batch, H100_SMEM) is not None:
            return True
        return first_plan_bytes(4, units, 4 * units, hidden, batch) <= H100_SMEM
    ring = (bwd_ring_plan(units, hidden, batch, H100_SMEM) if eb == 2
            else f32_plan(units, 1, units, 4 * hidden, batch, H100_SMEM))
    return ring is not None or first_plan_bytes(eb, units, units, 4 * hidden,
                                                batch) <= H100_SMEM


@pytest.mark.parametrize("batch", [8, 16, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_no_width_refused_on_an_h100(kernel, dtype, batch):
    """Every width from 128 to 2048 in steps of 128 takes a design on an
    H100 (132 SMs, 227 KB a block) that fits its shared memory; the wide
    design exactly where no other does."""
    for hidden in range(128, 2049, 128):
        got = lstm_design(kernel, DTYPES[dtype], hidden, batch, H100_SMS, H100_SMEM)
        assert got is not None, hidden
        design, p = got
        assert (design == "wide") == (not _others_fit(kernel, dtype, hidden, batch)), hidden
        if design == "wide":
            assert p["smem_bytes"] <= H100_SMEM and 0 < p["res_rounds"] < p["kr"], hidden
            assert p == wide_plan(2 if dtype == "bfloat16" else 4, -(-hidden // H100_SMS),
                                  4 if kernel == "fwd" else 1,
                                  hidden if kernel == "fwd" else 4 * hidden, batch, H100_SMEM)
        elif p is not None:
            assert p["smem_bytes"] <= H100_SMEM, hidden
    # past 16 units a block the grid does not fit: refused, as before
    assert lstm_design(kernel, DTYPES[dtype], 132 * 16 + 1, batch, H100_SMS, H100_SMEM) is None


def test_served_designs_unchanged_and_this_slice_wide():
    """The designs of today's served shapes stay as they were (the ring at
    CRN's bf16 1792 and rnn-stft-mask's 896, split-f32 at mel-rnn's and
    Demucs's DConv widths, with their plans), and CRN at f32 and Demucs's
    bottleneck take the wide design, with these plans on an H100."""
    for kernel, dtype, hidden, batch, want in SERVED:
        design, p = lstm_design(kernel, DTYPES[dtype], hidden, batch, H100_SMS, H100_SMEM)
        assert design == want, (kernel, dtype, hidden, batch)
        units = -(-hidden // H100_SMS)
        if want == "ring" and kernel == "fwd":
            assert p == fwd_ring_plan(units, hidden, batch, H100_SMEM)
        elif want == "ring":
            assert p == bwd_ring_plan(units, hidden, batch, H100_SMEM)
        else:
            nt, cols, k = ((units + 1) // 2, 8, hidden) if kernel == "fwd" else (1, units,
                                                                               4 * hidden)
            assert p == f32_plan(units, nt, cols, k, batch, H100_SMEM)
    plans = {case: lstm_design(case[0], DTYPES[case[1]], case[2], case[3], H100_SMS, H100_SMEM)
             for case in WIDE}
    assert all(d == "wide" for d, _ in plans.values())
    # CRN serve, f32: eight warps of three batch tiles, 56 rounds of 32, 22
    # of them (704 of 1792) resident; train: K split four ways
    assert _plan_tuple(plans[WIDE[0]][1]) == (14, 8, 1, 3, 192, 1, 32, 56, 22)
    assert _plan_tuple(plans[WIDE[1]][1]) == (14, 2, 4, 1, 16, 1, 128, 14, 4)
    assert _plan_tuple(plans[WIDE[2]][1]) == (14, 2, 4, 1, 16, 1, 128, 56, 27)
    # the Demucs bottleneck (H 2048: 16 units a block, the most)
    assert _plan_tuple(plans[WIDE[3]][1]) == (16, 8, 1, 3, 192, 1, 32, 64, 19)
    assert _plan_tuple(plans[WIDE[6]][1]) == (16, 8, 1, 3, 192, 1, 64, 32, 19)
    assert _plan_tuple(plans[WIDE[8]][1]) == (16, 1, 8, 1, 8, 1, 512, 16, 10)
    # unaligned pointers: the wide design still, with element loads
    assert lstm_design("fwd", torch.float32, 1792, 192, H100_SMS, H100_SMEM,
                       aligned=False)[0] == "wide"
    assert lstm_design("bwd", torch.bfloat16, 2048, 8, H100_SMS, H100_SMEM,
                       aligned=False)[0] == "wide"


@pytest.mark.parametrize("case", WIDE)
def test_wide_fragment_loads_free_of_bank_conflicts(case):
    """At this slice's plans on an H100: the 32-bit loads of both operands'
    fragments (resident rows at the resident pitch, staged rows at the
    stage pitch: 4 mod 8 words) hit 32 distinct banks a warp."""
    kernel, dtype, hidden, batch = case
    _, p = lstm_design(kernel, DTYPES[dtype], hidden, batch, H100_SMS, H100_SMEM)
    eb = 2 if dtype == "bfloat16" else 4
    for pitch in (p["pitch"], p["spitch"]):
        words = pitch * eb // 4
        assert words % 8 == 4
        for k in range(0, p["kc"], p["kstep"]):
            for half in range(2):
                col = (2 * Q + 8 * half) if eb == 2 else (Q + 4 * half)
                assert distinct_banks((G * pitch + k + col) * eb // 4)
