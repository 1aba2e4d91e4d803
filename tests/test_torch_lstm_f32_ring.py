"""A numpy run of the split-f32 LSTM kernels' indexing, on the CPU.

``csrc/lstm_fwd.cu:lstm_fwd_f32`` and ``csrc/lstm_bwd.cu:lstm_bwd_f32``
build only on the card, so this file walks their plans
(``kernels/lstm.py:f32_plan`` mirrors ``lstm.cuh:tc::make_plan``, and
``f32_design`` the kernels' choice) with numpy: the split slice in the
mma's fragment order, each warp's rounds of its rows and K range in its
own ring (the staggered round order, zero fill past B and K, the slot a
round lands in), the ldmatrix addresses of the TF32 A fragments and their
split into big and small parts, the three TF32 products of each k8 step,
the f32 partials each warp writes into its ring and the owners' sums in a
fixed order, and the pointwise parts of the (b, u) pairs each thread owns
across all steps. It holds the result against ``fused_lstm_plain`` /
``lstm_bwd_plain`` and against the JAX kernels in interpret mode, shows
that one TF32 product (no split) falls outside the smoke's f32 bound, and
checks the fragment loads' banks; the card tests hold the CUDA code itself.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas import lstm as jax_lstm
from speech_enhancement_torch.kernels.lstm import (f32_design, f32_plan, fused_lstm_plain,
                                                   lstm_bwd_plain, shift_prev)

WARPS, THREADS, KC, SP = 8, 256, 32, 36  # csrc/lstm.cuh, namespace tc
H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SMS = 132
LSTM_F32_TOL = 1e-4  # chip_smoke.py's f32 bound: |d| <= 1e-4 (1 + |ref|)


def tf32(a):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away from 0."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    """mmautil::split_tf32: the big part rounded, the small part truncated
    to TF32."""
    big = tf32(a)
    small = np.ascontiguousarray(a - big, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


def sigmoid(x):
    return np.float32(1.0) / (np.float32(1.0) + np.exp(-x))


def distinct_units(addrs, unit, lanes_a_phase):
    """Each phase of ``lanes_a_phase`` lanes reads ``unit``-byte words
    (addresses in floats): they sit on distinct bank groups, or are one
    address (a broadcast)."""
    for i in range(0, len(addrs), lanes_a_phase):
        words = sorted(set(addrs[i:i + lanes_a_phase]))
        if len({(a * 4 // unit) % (128 // unit) for a in words}) != len(words):
            return False
    return True


def put_split(sm, p, k, n, c, v):
    """tc::put_split: W[k][column c of tile n], split, in fragment order."""
    f = ((((k >> 3) * p["nt"] + n) * p["cols"] + c) * 4 + (k & 3)) * 4 + ((k >> 2) & 1)
    big, small = split(np.array([v], np.float32))
    sm[f], sm[f + 2] = big[0], small[0]


def a_offset(lane):
    """The ldmatrix row address of a lane in a slab (floats)."""
    return ((lane & 7) + ((lane >> 3) & 1) * 8) * SP + (lane >> 4) * 4


class Block:
    """A block's shared memory (NaN where nothing was written) and its plan."""

    def __init__(self, p):
        self.p = p
        self.sm = np.full(p["smem_bytes"] // 4, np.nan, np.float32)

    def region(self, warp):
        return (self.p["ring_offset"] + warp * self.p["region"]) // 4

    def warp_chunk(self, src, batch, row0, nv, r_begin, ns, r_first, warp, terms=3):
        """tc::warp_chunk of one warp: its ring, products and partials."""
        p, sm = self.p, self.sm
        nt, ld = p["nt"], src.shape[1]
        mw_max = 4 if nt <= 2 else 2
        acc = np.zeros((mw_max, nt, 16, 8), np.float32)
        region = self.region(warp)
        slab_f = p["slab_bytes"] // 4
        r_end = r_begin + ns
        state = {"r": r_first, "slot": 0, "issued": 0}

        def issue():
            if state["issued"] < ns:
                slab = region + state["slot"] * slab_f
                r = state["r"]
                copies = nv * 16 // 4
                for lane in range(32):
                    ch, crow = lane % 8, lane // 8
                    k = r * KC + ch * 4
                    for v in range(min(mw_max * 4, copies)):
                        row = crow + v * 4
                        ok = k < p["k"] and v * 4 < batch - row0 - crow
                        dst = slab + row * SP + ch * 4
                        sm[dst:dst + 4] = src[row0 + row, k:k + 4] if ok else 0.0
                state["r"] = r_begin if r + 1 == r_end else r + 1
                state["slot"] = (state["slot"] + 1) % p["stages"]
            state["issued"] += 1

        for _ in range(p["stages"] - 1):
            issue()
        r_cur, slot_cur = r_first, 0
        for _ in range(ns):
            issue()  # lands in the slot after the stages - 2 still in flight: never slot_cur
            slab = region + slot_cur * slab_f
            for kk in range(KC // 8 if nv else 0):
                s8 = r_cur * (KC // 8) + kk
                bb = np.zeros((nt, 8, 8), np.float32)
                bs = np.zeros_like(bb)
                for n in range(nt):
                    addrs = []
                    for lane in range(32):
                        g, q = lane // 4, lane % 4
                        col = min(g, p["cols"] - 1)
                        f = (((s8 * nt + n) * p["cols"] + col) * 4 + q) * 4
                        addrs.append(f)
                        if g < p["cols"]:
                            bb[n, q, g], bb[n, q + 4, g], bs[n, q, g], bs[n, q + 4, g] = \
                                sm[f:f + 4]
                    assert distinct_units(addrs, 16, 8)  # LDS.128: quarter-warp phases
                for m in range(nv):
                    addrs = [slab + m * 16 * SP + a_offset(lane) + kk * 8 for lane in range(32)]
                    assert distinct_units(addrs, 16, 8)  # ldmatrix: eight rows a phase
                    mats = [np.stack([sm[a:a + 4] for a in addrs[8 * i:8 * i + 8]])
                            for i in range(4)]
                    tile = np.block([[mats[0], mats[2]], [mats[1], mats[3]]])
                    ab, a_s = split(tile)
                    for n in range(nt):
                        if terms == 1:
                            acc[m, n] += ab @ bb[n]
                            continue
                        acc[m, n] += a_s @ bb[n]
                        acc[m, n] += ab @ bs[n]
                        acc[m, n] += ab @ bb[n]
            r_cur = r_begin if r_cur + 1 == r_end else r_cur + 1
            slot_cur = (slot_cur + 1) % p["stages"]
        # the partials, [mw * 16 rows][pitch], float2 stores
        for m in range(nv):
            for n in range(nt):
                addrs = []
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    o = region + (m * 16 + g) * p["pitch"] + n * 8 + 2 * q
                    addrs.append(o)
                    sm[o:o + 2] = acc[m, n, g, 2 * q:2 * q + 2]
                    o += 8 * p["pitch"]
                    sm[o:o + 2] = acc[m, n, g + 8, 2 * q:2 * q + 2]
                assert distinct_units(addrs, 8, 16)  # float2: half-warp phases

    def partial_row(self, sp, bl):
        """tc::partial_row: row bl of the chunk's partials in warp (sp, wg)."""
        p = self.p
        wg = bl // (p["mw"] * 16)
        return self.region(sp * p["wm"] + wg) + (bl - wg * p["mw"] * 16) * p["pitch"]

    def walk(self, src, batch, c, terms):
        """Every warp's chunk c (the block barrier after them is implied)."""
        p = self.p
        for warp in range(WARPS):
            sp, wmi = divmod(warp, p["wm"])
            row0 = c * p["nb"] + wmi * p["mw"] * 16
            nv = min(max((batch - row0 + 15) // 16, 0), p["mw"])
            r_begin = sp * p["rpw"]
            ns = max(min(p["rpw"], p["kr"] - r_begin), 0)
            first = r_begin + (self.index % ns if ns else 0)
            self.warp_chunk(src, batch, row0, nv, r_begin, ns, first, warp, terms)

    def pairs(self, batch, hidden, j0):
        """(b, u) of each pair a thread owns, tid + 256 i = b U + u."""
        u_count = self.p["units"]
        out = []
        for tid in range(THREADS):
            for i in range(self.p["ppt"]):
                b, u = divmod(tid + THREADS * i, u_count)
                if b < batch and j0 + u < hidden:
                    out.append((b, u))
        return out


def emulate_fwd(x_proj, w_hh, h0, c0, reverse, sms, smem, terms=3):
    """lstm_fwd_f32, block by block and warp by warp, in f32: (h_seq,
    c_seq, gates, plan)."""
    steps, batch, g4 = x_proj.shape
    hidden = g4 // 4
    design, p = f32_design("fwd", hidden, batch, sms, smem)
    assert design == "f32" and p["smem_bytes"] <= smem
    units = p["units"]
    blocks = []
    for index in range(math.ceil(hidden / units)):
        blk = Block(p)
        blk.index, blk.j0 = index, index * units
        for col in range(p["nt"] * 8):  # column 4u + gate: w_hh column gate * H + j0 + u
            u, gate = col >> 2, col & 3
            for k in range(p["kr"] * KC):
                v = (w_hh[k, gate * hidden + blk.j0 + u]
                     if u < units and blk.j0 + u < hidden and k < hidden else 0.0)
                put_split(blk.sm, p, k, col >> 3, col & 7, v)
        blk.owned = blk.pairs(batch, hidden, blk.j0)
        blk.c = {(b, u): np.float32(c0[b, blk.j0 + u]) for b, u in blk.owned}
        blocks.append(blk)
    h_seq = np.zeros((steps, batch, hidden), np.float32)
    c_seq = np.zeros_like(h_seq)
    gates = np.zeros_like(x_proj)
    order = range(steps - 1, -1, -1) if reverse else range(steps)
    for s, t in enumerate(order):
        hprev = h0 if s == 0 else h_seq[t + 1 if reverse else t - 1]
        for blk in blocks:
            for c in range(p["chunks"]):
                blk.walk(hprev, batch, c, terms)
                for b, u in blk.owned:
                    bl = b - c * p["nb"]
                    if not 0 <= bl < p["nb"]:
                        continue
                    j = blk.j0 + u
                    lin = x_proj[t, b, j::hidden].copy()  # the prefetched x_proj: i, f, g, o
                    for sp in range(p["wk"]):
                        o = blk.partial_row(sp, bl) + 4 * u
                        lin += blk.sm[o:o + 4]
                    i, f, g, o = sigmoid(lin[0]), sigmoid(lin[1]), np.tanh(lin[2]), sigmoid(lin[3])
                    cn = f * blk.c[b, u] + i * g
                    blk.c[b, u] = cn
                    h_seq[t, b, j], c_seq[t, b, j] = o * np.tanh(cn), cn
                    gates[t, b, j::hidden] = (i, f, g, o)
    return h_seq, c_seq, gates, p


def emulate_bwd(gates, c_seq, c_prev, dout, w_hh, dh_last, dc_last, reverse, sms, smem):
    """lstm_bwd_f32, block by block and warp by warp, in f32: (dgates, dh0,
    dc0, plan)."""
    steps, batch, g4 = gates.shape
    hidden = g4 // 4
    design, p = f32_design("bwd", hidden, batch, sms, smem)
    assert design == "f32" and p["smem_bytes"] <= smem
    units = p["units"]
    blocks = []
    for index in range(math.ceil(hidden / units)):
        blk = Block(p)
        blk.index, blk.j0 = index, index * units
        for u in range(units):  # column u: w_hh row j0 + u
            for k in range(p["kr"] * KC):
                v = w_hh[blk.j0 + u, k] if blk.j0 + u < hidden and k < g4 else 0.0
                put_split(blk.sm, p, k, 0, u, v)
        blk.owned = blk.pairs(batch, hidden, blk.j0)
        blk.dh = {(b, u): np.float32(dh_last[b, blk.j0 + u]) for b, u in blk.owned}
        blk.dc = {(b, u): np.float32(dc_last[b, blk.j0 + u]) for b, u in blk.owned}
        blocks.append(blk)
    dgates = np.zeros_like(gates)
    order = range(steps) if reverse else range(steps - 1, -1, -1)
    for t in order:
        for blk in blocks:  # the pointwise part, from registers
            for b, u in blk.owned:
                j = blk.j0 + u
                i, f, g, o = gates[t, b, j::hidden]
                tc = np.tanh(c_seq[t, b, j])
                dh = blk.dh[b, u] + dout[t, b, j]
                d_o = dh * tc
                dc = blk.dc[b, u] + dh * o * (1 - tc * tc)
                di, df, dg = dc * g, dc * c_prev[t, b, j], dc * i
                dgates[t, b, j::hidden] = (di * i * (1 - i), df * f * (1 - f), dg * (1 - g * g),
                                           d_o * o * (1 - o))
                blk.dc[b, u] = dc * f
        src = dgates[t]  # the grid barrier: every block's dgates[t] is written
        for blk in blocks:
            for c in range(p["chunks"]):
                blk.walk(src, batch, c, 3)
                for b, u in blk.owned:
                    bl = b - c * p["nb"]
                    if 0 <= bl < p["nb"]:
                        v = np.float32(0.0)
                        for sp in range(p["wk"]):
                            v += blk.sm[blk.partial_row(sp, bl) + u]
                        blk.dh[b, u] = v
    dh0 = np.zeros((batch, hidden), np.float32)
    dc0 = np.zeros_like(dh0)
    for blk in blocks:
        for b, u in blk.owned:
            dh0[b, blk.j0 + u], dc0[b, blk.j0 + u] = blk.dh[b, u], blk.dc[b, u]
    return dgates, dh0, dc0, p


def _fwd_inputs(steps, batch, hidden, seed):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((steps, batch, 4 * hidden)).astype(np.float32)
    w_hh = (rng.standard_normal((hidden, 4 * hidden)) / np.sqrt(hidden)).astype(np.float32)
    h0, c0 = (0.5 * rng.standard_normal((2, batch, hidden))).astype(np.float32)
    return x_proj, w_hh, h0, c0


def _bwd_inputs(steps, batch, hidden, reverse, seed):
    """A forward's gates and c (fused_lstm_plain), and random gradients."""
    x_proj, w_hh, h0, c0 = _fwd_inputs(steps, batch, hidden, seed)
    _, c_seq, gates = fused_lstm_plain(*(torch.from_numpy(a) for a in (x_proj, w_hh, h0, c0)),
                                       reverse)
    c_prev = shift_prev(c_seq, torch.from_numpy(c0), reverse)
    rng = np.random.default_rng(seed + 1)
    dout = rng.standard_normal((steps, batch, hidden)).astype(np.float32)
    dh_last, dc_last = rng.standard_normal((2, batch, hidden)).astype(np.float32)
    return gates.numpy(), c_seq.numpy(), c_prev.numpy(), dout, w_hh, dh_last, dc_last


PLAN_KEYS = ("units", "nt", "cols", "stages", "wm", "wk", "mw", "chunks", "rpw", "ppt")

# (T, B, H, SMs, shared memory) and the plan each takes (PLAN_KEYS). The
# forward: B 20 (one m16 tile and a ragged second) over two warps along the
# batch and four along K, three of them without a round (K 32 is one), two
# column tiles (U 4); B 5 (a third of a tile) with three units (the second
# tile's last four columns zero) in a ring of three slabs; a ragged last
# block (H 36, U 5: three column tiles); B 70 over three m16 tiles a warp,
# K in three rounds; B 300 in three chunks of 128 rows, four pairs a thread
FWD_CASES = [
    ((3, 20, 32, 8, 1 << 20), (4, 2, 8, 8, 2, 4, 1, 1, 1, 1)),
    ((3, 5, 24, 8, 64 * 1024), (3, 2, 8, 3, 1, 8, 1, 1, 1, 1)),
    ((2, 33, 36, 8, 1 << 20), (5, 3, 8, 8, 4, 2, 1, 1, 1, 1)),
    ((2, 70, 96, 48, 1 << 20), (2, 1, 8, 8, 2, 4, 3, 1, 1, 1)),
    ((2, 300, 32, 16, 4096 + 8 * 3 * 2304), (2, 1, 8, 3, 8, 1, 1, 3, 1, 4)),
]
# The backward: B 16 in one tile, K = 4H in eight splits of one round; B 5
# with three units (columns 3 to 7 of the tile zeroed in registers), a
# ragged last block and three slabs; B 40 over two warps along the batch
# and four along K; B 70 over three tiles a warp; two rounds a split,
# walked from each block's own start; B 300 in one chunk of 384 rows with
# all eight warps along the batch and H 16 (one unit a block)
BWD_CASES = [
    ((3, 16, 32, 8, 1 << 20), (4, 1, 4, 8, 1, 8, 1, 1, 1, 1)),
    ((3, 5, 34, 12, 64 * 1024), (3, 1, 3, 3, 1, 8, 1, 1, 1, 1)),
    ((2, 40, 32, 16, 1 << 20), (2, 1, 2, 8, 2, 4, 2, 1, 1, 1)),
    ((2, 70, 24, 12, 1 << 20), (2, 1, 2, 8, 2, 4, 3, 1, 1, 1)),
    ((2, 16, 96, 48, 1 << 20), (2, 1, 2, 8, 1, 8, 1, 1, 2, 1)),
    ((2, 300, 16, 16, 1 << 20), (1, 1, 1, 8, 8, 1, 3, 1, 2, 4)),
]


def _plan_tuple(p):
    return tuple(p[k] for k in PLAN_KEYS)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case,want_plan", FWD_CASES)
def test_fwd_f32_indexing_matches_plain(case, want_plan, reverse):
    steps, batch, hidden, sms, smem = case
    args = _fwd_inputs(steps, batch, hidden, sum(case[:3]) + reverse)
    *got, p = emulate_fwd(*args, reverse, sms, smem)
    assert _plan_tuple(p) == want_plan
    want = fused_lstm_plain(*(torch.from_numpy(a) for a in args), reverse)
    for g, w, name in zip(got, want, ("h_seq", "c_seq", "gates")):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case,want_plan", BWD_CASES)
def test_bwd_f32_indexing_matches_plain(case, want_plan, reverse):
    steps, batch, hidden, sms, smem = case
    args = _bwd_inputs(steps, batch, hidden, reverse, sum(case[:3]) + reverse)
    *got, p = emulate_bwd(*args, reverse, sms, smem)
    assert _plan_tuple(p) == want_plan
    want = lstm_bwd_plain(*(torch.from_numpy(a) for a in args), reverse)
    for g, w, name in zip(got, want, ("dgates", "dh0", "dc0")):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_f32_designs_match_the_jax_kernels(reverse):
    """Both emulated designs against the Pallas kernels in interpret mode
    (tests/test_torch_lstm.py's f32 forward bound, 1e-5)."""
    steps, batch, hidden, sms = 4, 18, 32, 8
    x_proj, w_hh, h0, c0 = _fwd_inputs(steps, batch, hidden, 11 + reverse)
    *got, _ = emulate_fwd(x_proj, w_hh, h0, c0, reverse, sms, 1 << 20)
    want = jax_lstm._lstm_fwd_call(*(jnp.asarray(a) for a in (x_proj, w_hh, h0, c0)), reverse,
                                   True)
    for g, w, name in zip(got, want, ("h_seq", "c_seq", "gates")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    args = _bwd_inputs(steps, batch, hidden, reverse, 12 + reverse)
    gates, c_seq, c_prev, dout, w_hh, dh_last, dc_last = args
    *got, _ = emulate_bwd(*args, reverse, sms, 1 << 20)
    want = jax_lstm._lstm_bwd_call(*(jnp.asarray(a) for a in (gates, c_seq, c_prev, dout)),
                                   jnp.asarray(w_hh.T), jnp.asarray(dh_last),
                                   jnp.asarray(dc_last), reverse, True)
    for g, w, name in zip(got, want, ("dgates", "dh0", "dc0")):
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5 * scale, err_msg=name)


def _recurrence(x_proj, w_hh, terms):
    """The forward's (h_seq, c_seq) with each step's product in split-f32
    (3 terms) or one TF32 product, summed in f32 over k8 steps as the
    kernel's mma.sync does (a vectorised stand-in for the emulation at
    mel-rnn's width)."""
    steps, batch, g4 = x_proj.shape
    hidden = g4 // 4
    wb, ws = split(w_hh)
    h = np.zeros((batch, hidden), np.float32)
    c = np.zeros_like(h)
    h_seq, c_seq = np.zeros((2, steps, batch, hidden), np.float32)
    for t in range(steps):
        hb, hs = split(h)
        lin = x_proj[t].copy()
        for k in range(0, hidden, 8):
            sl = slice(k, k + 8)
            if terms == 1:
                lin += hb[:, sl] @ wb[sl]
            else:
                lin += hs[:, sl] @ wb[sl] + hb[:, sl] @ ws[sl] + hb[:, sl] @ wb[sl]
        i, f = sigmoid(lin[:, :hidden]), sigmoid(lin[:, hidden:2 * hidden])
        g, o = np.tanh(lin[:, 2 * hidden:3 * hidden]), sigmoid(lin[:, 3 * hidden:])
        c = f * c + i * g
        h = o * np.tanh(c)
        h_seq[t], c_seq[t] = h, c
    return h_seq, c_seq


def test_one_tf32_product_misses_the_f32_bound():
    """At mel-rnn's width (H 256, B 16, 64 steps) the split products stay
    within a tenth of the smoke's 1e-4 (1 + |ref|) of the f32 plain loop
    (4e-7 measured), and a single TF32 product (10 mantissa bits) falls
    outside it (2.2e-4, carried along c): the reason for the split."""
    x_proj, w_hh, h0, _ = _fwd_inputs(64, 16, 256, 5)
    zero = np.zeros_like(h0)
    want = fused_lstm_plain(*(torch.from_numpy(a) for a in (x_proj, w_hh, zero, zero)))[:2]

    def worst(got):
        return max(float((np.abs(g - w.numpy()) / (1 + np.abs(w.numpy()))).max())
                   for g, w in zip(got, want))

    three, one = worst(_recurrence(x_proj, w_hh, 3)), worst(_recurrence(x_proj, w_hh, 1))
    assert three <= LSTM_F32_TOL / 10 and one > 1.5 * LSTM_F32_TOL, (three, one)


def test_f32_plans_at_the_served_shapes():
    """The plans on an H100 (132 SMs, 227 KB a block) at mel-rnn's and
    Demucs's f32 shapes, which design each takes, and the width where the
    first design takes over."""
    def plan(kernel, hidden, batch):
        design, p = f32_design(kernel, hidden, batch, H100_SMS, H100_SMEM)
        assert design == "f32" and p["smem_bytes"] <= H100_SMEM
        return p

    # the forward at B 192: the batch as M in 12 m16 tiles, four warps of
    # three tiles along it and two along K; mel-rnn's and Demucs layer 4's U 2
    # (one n8 tile, a 16 KB split slice), Demucs layer 5's U 4 (two, 64 KB)
    serve = plan("fwd", 256, 192)
    assert _plan_tuple(serve) == (2, 1, 8, 3, 4, 2, 3, 1, 4, 4)
    assert serve["ring_offset"] == 16384 and serve["smem_bytes"] == 182272
    wide = plan("fwd", 512, 192)
    assert _plan_tuple(wide) == (4, 2, 8, 3, 4, 2, 3, 1, 8, 4)
    assert wide["ring_offset"] == 65536 and wide["smem_bytes"] == 231424
    # B 16 and Demucs's B 8: one m16 tile, K split eight ways
    assert _plan_tuple(plan("fwd", 256, 16)) == (2, 1, 8, 8, 1, 8, 1, 1, 1, 1)
    assert _plan_tuple(plan("fwd", 256, 8)) == (2, 1, 8, 8, 1, 8, 1, 1, 1, 1)
    assert _plan_tuple(plan("fwd", 512, 8)) == (4, 2, 8, 8, 1, 8, 1, 1, 2, 1)
    # the backward: K = 4H over eight warps, U columns of one n8 tile
    assert _plan_tuple(plan("bwd", 256, 16)) == (2, 1, 2, 8, 1, 8, 1, 1, 4, 1)
    assert _plan_tuple(plan("bwd", 256, 8)) == (2, 1, 2, 8, 1, 8, 1, 1, 4, 1)
    assert _plan_tuple(plan("bwd", 512, 8)) == (4, 1, 4, 8, 1, 8, 1, 1, 8, 1)
    for kernel in ("fwd", "bwd"):
        assert plan(kernel, 256, 16)["ring_offset"] == 16384
    # where the first design takes over: past 792 units (U 7: the split
    # slice leaves no ring of three slabs), and in the forward at H % 4
    assert f32_design("fwd", 792, 192, H100_SMS, H100_SMEM)[0] == "f32"
    assert f32_design("bwd", 792, 16, H100_SMS, H100_SMEM)[0] == "f32"
    for kernel in ("fwd", "bwd"):
        assert all(f32_design(kernel, h, 16, H100_SMS, H100_SMEM) == ("first", None)
                   for h in range(796, 1800, 4))
    assert f32_design("fwd", 258, 16, H100_SMS, H100_SMEM) == ("first", None)
    assert f32_design("bwd", 258, 16, H100_SMS, H100_SMEM)[0] == "f32"
    # unaligned pointers (the smoke's way to time the first design)
    for kernel in ("fwd", "bwd"):
        assert f32_design(kernel, 256, 192, H100_SMS, H100_SMEM, aligned=False) == ("first", None)
    # more than 16 x 256 (b, u) pairs a block
    assert f32_design("bwd", 256, 2049, H100_SMS, H100_SMEM) == ("first", None)
    assert f32_design("fwd", 256, 2048, H100_SMS, H100_SMEM)[0] == "f32"
    # wider than 16 units a block: the grid does not fit
    assert f32_design("fwd", 132 * 16 + 1, 16, H100_SMS, H100_SMEM) is None


@pytest.mark.parametrize("kernel,hidden,batch", [("fwd", 256, 192), ("fwd", 512, 192),
                                                  ("fwd", 792, 192), ("bwd", 256, 16),
                                                  ("bwd", 512, 8)])
def test_f32_fragment_loads_free_of_bank_conflicts(kernel, hidden, batch):
    """At the served plans: the ldmatrix rows of every m16 tile and k8 step
    of a slab (pitch 36 floats: 4 words mod 32), the slice's 16-byte B
    loads of every k8 step and n8 tile (consecutive words), and the
    partials' float2 stores (pitch 8 mod 16 words) each spread over the
    banks of a phase."""
    _, p = f32_design(kernel, hidden, batch, H100_SMS, H100_SMEM)
    for m in range(p["mw"]):
        for kk in range(KC // 8):
            assert distinct_units([m * 16 * SP + a_offset(lane) + kk * 8 for lane in range(32)],
                                  16, 8)
    for s8 in range(p["kr"] * KC // 8):
        for n in range(p["nt"]):
            assert distinct_units([(((s8 * p["nt"] + n) * p["cols"] + min(ln // 4, p["cols"] - 1))
                                    * 4 + ln % 4) * 4 for ln in range(32)], 16, 8)
    for m in range(p["mw"]):
        for n in range(p["nt"]):
            assert distinct_units([(m * 16 + ln // 4) * p["pitch"] + n * 8 + 2 * (ln % 4)
                                   for ln in range(32)], 8, 16)
    assert (SP * 4 // 16) % 2 == 1 and p["pitch"] % 16 == 8
    assert f32_plan(p["units"], p["nt"], p["cols"], p["k"], batch, H100_SMEM) == p
