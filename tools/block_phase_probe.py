#!/usr/bin/env python3
"""Where the time of the fused blocks' bf16 kernels goes, on one GPU.

The kernels (``--rows``) are the decoder block ``fused_deconv_block``
(``fwd``, row 4 of PERF.md's table, ``deconv_block.cu``) and its input
gradient ``dec_bwd_gz`` (``gz``, row 7, ``deconv_block_bwd.cu``), the
encoder block ``fused_conv_block`` (``enc_fwd``, row 3, ``conv_block.cu``)
and its input gradient ``enc_bwd_gz`` (``enc_gz``, row 5,
``conv_block_bwd.cu``), all instantiations of the implicit GEMM in
``block_gemm.cuh`` (``--design before``: the first design,
``block_kernel``) or ``block_mma.cuh`` (``--design after``:
``mma_kernel``). This script copies a kernel source directory, inserts
``clock64`` stamps at fixed places of the kernel and compiles the copy into
``kernels/build/probe/``; the sources themselves are not changed. Thread 0
of every block sums each phase's cycles over its K steps and adds them,
with the block's whole span, to a few device counters once; the script
prints each phase as a share of the summed spans, beside the event time of
the stamped and of an unstamped build of the same source and the error of
the stamped result against the plain version. It also reckons the bytes
the launch stages into shared memory (each block's weight and activation
tiles summed over its K steps) against the bytes of the inputs and output
read or written once.

Designs:

* ``before``: ``block_kernel``, one block per (b, output row, 64 frames)
  and BM output channels, K steps of 16 channels: stage Z (element by
  element, with the pointwise for the forward), stage W, barrier 1,
  products (32-bit fragment loads and mma.sync for both time taps), barrier
  2; then the epilogue (f32 tile through shared memory, stores, stats).
  Pass the directory of that source with ``--csrc`` once the bf16 path has
  moved on (rows 4 and 7: ``git archive 66455ec
  speech_enhancement_torch/kernels/csrc``; rows 3 and 5: ``git archive
  4750f43 ...``).
* ``after``: ``mma_kernel``, stamped per stage: issue (the next stage's
  weight copies and activation loads), products and stores (ldmatrix and
  mma.sync on this stage, the loaded activations realigned, activated and
  stored into the other stage between the k16 steps), barrier; then the
  epilogue. ``--tile ROW:BLOCK=BMxNB`` launches a block with another tile,
  ``--pair on|off`` the forward rows and row 5 with or without row-pair
  blocks, ``--sweep`` every tile (and, for those rows, both).

``--stats off`` launches the forward rows without the stats epilogue.

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/block_phase_probe.py [--design after] [--shapes dec0,dec2]
    python3 tools/block_phase_probe.py --rows enc_fwd,enc_gz --shapes enc1,enc5
    python3 tools/block_phase_probe.py --design before --csrc DIR
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from speech_enhancement_torch.kernels import _build  # noqa: E402
from speech_enhancement_torch.kernels import conv_block as cb  # noqa: E402

T = 643
# one request's windows (the forwards); bench.py's train batch (the input gradients)
BATCH = {"fwd": 192, "gz": 128, "enc_fwd": 192, "enc_gz": 128}
# row -> (table row, C library, C entry point, the blocks' name prefix)
ROWS = {"fwd": ("fused_deconv_block (row 4)", "deconv_block", "deconv_block", "dec"),
        "gz": ("dec_bwd_gz (row 7)", "deconv_block_bwd", "dec_bwd_gz", "dec"),
        "enc_fwd": ("fused_conv_block (row 3)", "conv_block", "conv_block", "enc"),
        "enc_gz": ("enc_bwd_gz (row 5)", "conv_block_bwd", "enc_bwd_gz", "enc")}
# (name, f_in, input widths, c2out): the decoder blocks of configs/dccrn_vbd.yaml
# (trunk and skip), then its encoder blocks
SHAPES = [("dec0", 4, (256, 256), 256), ("dec1", 8, (256, 256), 128),
          ("dec2", 16, (128, 128), 64), ("dec3", 32, (64, 64), 32), ("dec4", 64, (32, 32), 16),
          ("dec5", 128, (16, 16), 2), ("enc0", 256, (2,), 16), ("enc1", 128, (16,), 32),
          ("enc2", 64, (32,), 64), ("enc3", 32, (64,), 128), ("enc4", 16, (128,), 256),
          ("enc5", 8, (256,), 256)]
DEFAULT_SHAPES = "dec0,dec2,dec4,dec5,enc1,enc3,enc5"
PHASES = {"before": ["stage Z", "stage W", "barrier 1", "products", "barrier 2", "epilogue"],
          "after": ["issue", "products and stores", "barrier", "epilogue"]}

PRELUDE = """
__device__ unsigned long long g_prof[8];
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// phases [0, n) of this block, its span in cycles and in ns: slots 0-5, 6, 7
__device__ __forceinline__ void probe_flush(const unsigned long long* acc, int n,
                                            unsigned long long cycles,
                                            unsigned long long ns) {
  if (threadIdx.x != 0) return;
  for (int i = 0; i < n; ++i) atomicAdd(&g_prof[i], acc[i]);
  atomicAdd(&g_prof[6], cycles);
  atomicAdd(&g_prof[7], ns);
}
"""

ENTRIES = """
extern "C" int probe_zero() {
  static unsigned long long zero[8];
  return static_cast<int>(cudaMemcpyToSymbol(NS::g_prof, zero, sizeof(zero)));
}
extern "C" int probe_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, NS::g_prof, sizeof(NS::g_prof)));
}
"""


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _stamp_before(cuh: str) -> str:
    """block_gemm.cuh's block_kernel: six phases."""
    return _patch(cuh, [
        ("namespace blockgemm {\n", "namespace blockgemm {\n" + PRELUDE),
        ("  for (int reg = 0; reg < p.n_reg; ++reg) {\n    const Region& rg",
         "  unsigned long long pacc[6] = {0, 0, 0, 0, 0, 0};\n"
         "  const unsigned long long pstart = clock64(), nstart = probe_ns();\n"
         "  for (int reg = 0; reg < p.n_reg; ++reg) {\n    const Region& rg"),
        ("        stage_z<T, BM, kGrad>(sm, rg, b, p.f_in, fi, ci0, t_first, p.n_time);\n"
         "        stage_w<T, BM>(sm, rg, jf, ci0, p.c2out, m_tile);\n"
         "        __syncthreads();\n",
         "        const unsigned long long s0 = clock64();\n"
         "        stage_z<T, BM, kGrad>(sm, rg, b, p.f_in, fi, ci0, t_first, p.n_time);\n"
         "        const unsigned long long s1 = clock64();\n"
         "        stage_w<T, BM>(sm, rg, jf, ci0, p.c2out, m_tile);\n"
         "        const unsigned long long s2 = clock64();\n"
         "        __syncthreads();\n"
         "        const unsigned long long s3 = clock64();\n"
         "        pacc[0] += s1 - s0;\n        pacc[1] += s2 - s1;\n        pacc[2] += s3 - s2;\n"),
        ("        __syncthreads();\n      }\n    }\n  }\n",
         "        const unsigned long long s4 = clock64();\n"
         "        __syncthreads();\n"
         "        const unsigned long long s5 = clock64();\n"
         "        pacc[3] += s4 - s3;\n        pacc[4] += s5 - s4;\n"
         "      }\n    }\n  }\n"
         "  const unsigned long long pepi = clock64();\n"),
        ("      if (co >= 0 && t < p.n_time) out_row<T>(p, b, fo, co, c_half)[t] = "
         "from_f32<T>(sm.c[r][n]);\n    }\n    return;\n",
         "      if (co >= 0 && t < p.n_time) out_row<T>(p, b, fo, co, c_half)[t] = "
         "from_f32<T>(sm.c[r][n]);\n    }\n"
         "    pacc[5] = clock64() - pepi;\n"
         "    probe_flush(pacc, 6, clock64() - pstart, probe_ns() - nstart);\n"
         "    return;\n"),
        ("      atomicAdd(dst + 2, s2);\n    }\n  }\n}\n",
         "      atomicAdd(dst + 2, s2);\n    }\n  }\n"
         "  pacc[5] = clock64() - pepi;\n"
         "  probe_flush(pacc, 6, clock64() - pstart, probe_ns() - nstart);\n}\n"),
    ])


def _stamp_after(cuh: str) -> str:
    """block_mma.cuh's mma_kernel: four phases."""
    return _patch(cuh, [
        ("namespace blockmma {\n", "namespace blockmma {\n" + PRELUDE),
        ("  // -- the K loop --\n",
         "  unsigned long long pacc[4] = {0, 0, 0, 0};\n"
         "  const unsigned long long pstart = clock64(), nstart = probe_ns();\n"
         "  // -- the K loop --\n"),
        ("    const bool more = s + 1 < n_stages;\n",
         "    const unsigned long long s0 = clock64();\n"
         "    const bool more = s + 1 < n_stages;\n"),
        ("    // products of this stage",
         "    const unsigned long long s1 = clock64();\n    pacc[0] += s1 - s0;\n"
         "    // products of this stage"),
        ("    cp_async_wait_all();\n    __syncthreads();\n",
         "    const unsigned long long s2 = clock64();\n    pacc[1] += s2 - s1;\n"
         "    cp_async_wait_all();\n    __syncthreads();\n"
         "    pacc[2] += clock64() - s2;\n"),
        ("  // -- epilogue --\n",
         "  const unsigned long long pepi = clock64();\n  // -- epilogue --\n"),
        ("  // -- end --\n",
         "  pacc[3] = clock64() - pepi;\n"
         "  probe_flush(pacc, 4, clock64() - pstart, probe_ns() - nstart);\n"),
    ])


VARIANTS = {
    "none": [],
    # one block an SM (no register cap)
    "minb1": [("constexpr int MINB = 2;", "constexpr int MINB = 1;")],
    # the epilogue's global stores taken out (and the stats with them)
    "no-epistore": [("      const bool ok0 = f >= 0 && f < n_valid, ok1 = f + 1 < n_valid;",
                     "      const bool ok0 = p.batch < 0 && f >= 0 && f < n_valid,\n"
                     "                 ok1 = p.batch < 0 && f + 1 < n_valid;")],
    # activations not loaded (zeros staged): what the weights and products take
    "no-zloads": [("      un.lo_r = ld_pred(aligned_chunk(row_r), ok &",
                   "      un.lo_r = ld_pred(aligned_chunk(row_r), (p.batch < 0) & ok &"),
                  ("      un.hi_r = ld_pred(aligned_chunk(row_r) + 1, ok &",
                   "      un.hi_r = ld_pred(aligned_chunk(row_r) + 1, (p.batch < 0) & ok &"),
                  ("      un.lo_i = ld_pred(aligned_chunk(row_i), ok &",
                   "      un.lo_i = ld_pred(aligned_chunk(row_i), (p.batch < 0) & ok &"),
                  ("      un.hi_i = ld_pred(aligned_chunk(row_i) + 1, ok &",
                   "      un.hi_i = ld_pred(aligned_chunk(row_i) + 1, (p.batch < 0) & ok &")],
    # no mma.sync: staging, fragments and epilogue alone
    "no-products": [("          for (int j = 0; j < C::NT; ++j) mma_bf16(",
                     "          for (int j = 0; j < C::NT * 0; ++j) mma_bf16(")],
}


def build(csrc: Path, design: str, stamped: bool, names, variant: str = "none"):
    """Stamped (or bare) copies of the C libraries ``names`` (of ROWS)."""
    tag = f"{design}-{variant}-{'stamped' if stamped else 'bare'}"
    out = _build.BUILD / "probe" / "block" / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in list(csrc.glob("*.cuh")) + [csrc / f"{name}.cu" for name in names]:
        shutil.copy(src, out / src.name)
    header, ns = (("block_gemm.cuh", "blockgemm") if design == "before" else
                  ("block_mma.cuh", "blockmma"))
    text = _patch((out / header).read_text(), VARIANTS[variant])
    if stamped:
        text = _stamp_before(text) if design == "before" else _stamp_after(text)
    (out / header).write_text(text)
    libs, procs = {}, {}
    for name in names:
        src = out / f"{name}.cu"
        if stamped:
            src.write_text(src.read_text() + ENTRIES.replace("NS", ns))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        for line in log.splitlines():
            if not stamped and any(key in line for key in ("registers", "spill",
                                                           "Function properties")):
                print(f"ptxas {tag} {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        if stamped:  # a pointer passed without argtypes would be cut to a C int
            lib.probe_zero.argtypes, lib.probe_zero.restype = [], ctypes.c_int
            lib.probe_read.argtypes, lib.probe_read.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = lib
    return libs


def live_taps(decoder: bool, f_in: int, f_out: int):
    """Live (output row, tap) pairs, as the kernels skip them."""
    pairs = 0
    for fo in range(f_out):
        for jf in range(5):
            if decoder:
                if (fo + jf) % 2:
                    continue
                fi = (fo + jf - 2) // 2
            else:
                fi = 2 * fo + jf - 2
            pairs += 0 <= fi < f_in
    return pairs


def gemm(kind: str, f_in, widths, c2out):
    """The implicit GEMM a row launches for a block: (decoder indexing, its
    input rows, its output rows, M output channels, K regions of channels).
    The input gradients run the other block's forward indexing on g."""
    dec = ROWS[kind][3] == "dec"
    f_block = 2 * f_in if dec else f_in // 2  # the block's output rows
    if kind in ("fwd", "enc_fwd"):
        return dec, f_in, f_block, c2out, tuple(widths)
    return not dec, f_block, f_in, sum(widths), (c2out,)


PAIRED = ("fwd", "enc_fwd", "enc_gz")  # the rows that may take row-pair blocks


def paired(kind, m, pair=None):
    """Whether the wrappers take row pairs for a GEMM of m output channels
    (or ``pair``, where the row takes them at all)."""
    if kind not in PAIRED:
        return False
    return cb.block_pair(m) if pair is None else pair


def reckon(design: str, kind: str, f_in, widths, c2out, tile=None, pair=None):
    """(weight bytes, activation bytes) all blocks stage into shared memory,
    and the bytes of the inputs and output once."""
    batch = BATCH[kind]
    decoder, rows_in, f_out, m, regions = gemm(kind, f_in, widths, c2out)
    live = live_taps(decoder, rows_in, f_out)
    frame_tiles = -(-T // 64)
    if design == "before":
        bm = 16 if m <= 16 else 32 if m <= 32 else 64 if m <= 64 else 128
        blocks_per_row = frame_tiles * batch * -(-m // bm)  # per output row
        steps = sum(-(-c2 // 16) for c2 in regions)
        w = blocks_per_row * live * steps * 2 * bm * 16 * 2
        # tiles of 65 frames x 16 channels (the forward loads each element's
        # partner too: twice these bytes in loads)
        z = blocks_per_row * live * steps * 65 * 16 * 2
    else:
        pair = paired(kind, m, pair)
        bm, nb = tile or cb.block_tile(2 * m if pair else m)
        channels = bm // 4 if pair else bm // 2  # complex output channels a tile
        blocks_per_row = frame_tiles * -(-batch // nb) * -(-(m // 2) // channels)
        if pair:  # (row pair, input row) pairs: 3 or 7 input rows a pair, fewer at the edges
            live = sum(0 <= (r - 1 if decoder else 4 * r - 2) + d < rows_in
                       for r in range(f_out // 2) for d in range(3 if decoder else 7))
        steps = sum(-(-(c2 // 2) // 8) for c2 in regions)  # k16 steps of 8 pairs a tap
        w = blocks_per_row * live * steps * 2 * bm * 16 * 2
        z = blocks_per_row * live * steps * nb * 65 * 16 * 2
    f_block = 2 * f_in if ROWS[kind][3] == "dec" else f_in // 2
    once = 2.0 * batch * T * (f_in * sum(widths) + f_block * c2out)
    return w, z, once


def _inputs(kind, name, f_in, widths, c2out, dev, gen):
    batch = BATCH[kind]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    w2 = randn(5, 2, sum(widths), c2out) / float(sum(widths) * 10) ** 0.5
    if kind in ("gz", "enc_gz"):
        f_block = 2 * f_in if kind == "gz" else f_in // 2
        return {"gy": randn(batch, f_block * c2out, T).to(torch.bfloat16), "w2": w2}
    acts = [randn(batch, f_in * c2, T).to(torch.bfloat16) for c2 in widths]
    coefs = [(1 + 0.1 * randn(c2), 0.1 * randn(c2), 0.1 * randn(c2)) for c2 in widths]
    return {"acts": acts, "w2": w2, "b2": 0.1 * randn(c2out), "coefs": coefs,
            "alphas": [torch.full((1,), 0.25, device=dev) for _ in widths]}


def _call_before(libs, kind, f_in, widths, c2out, inp, stats):
    """The first design's C entry points with its packing (as kernels/
    conv_block.py packed them before the bf16 path moved)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "enc_gz":
        gy, w2 = inp["gy"], inp["w2"]
        w, kp = cb._pack_weights(w2.flip(0, 1).transpose(2, 3), gy.dtype)
        batch, (c2in,) = gy.shape[0], widths
        gz = torch.empty(batch, f_in * c2in, T, dtype=gy.dtype, device=gy.device)
        fn = libs["conv_block_bwd"].enc_bwd_gz
        fn.argtypes = [i, p, p, i, i, p, i, i, i, i, p]
        args = [1, gy.data_ptr(), w.data_ptr(), c2out, kp, gz.data_ptr(), batch, f_in, c2in, T,
                stream]
        return libs["conv_block_bwd"], fn, args, gz, (w,)
    if kind == "enc_fwd":
        (x,), w2, (c2in,) = inp["acts"], inp["w2"], widths
        w, kp = cb._pack_weights(w2, x.dtype)
        coef = cb._pack_coeffs(inp["coefs"][0], inp["alphas"][0], x.dtype, x.device)
        bias = inp["b2"].float().contiguous()
        batch = x.shape[0]
        y = torch.empty(batch, f_in // 2 * c2out, T, dtype=x.dtype, device=x.device)
        st = torch.zeros(batch, f_in // 2 * c2out, 8, device=x.device) if stats else None
        fn = libs["conv_block"].conv_block
        fn.argtypes = [i, p, p, p, i, i, p, p, p, i, i, i, i, p]
        args = [1, x.data_ptr(), coef.data_ptr(), w.data_ptr(), c2in, kp, bias.data_ptr(),
                y.data_ptr(), st.data_ptr() if stats else None, batch, f_in, c2out, T, stream]
        return libs["conv_block"], fn, args, (y, st), (w, coef, bias)
    c2x, c2s = widths
    if kind == "gz":
        gy, w2 = inp["gy"], inp["w2"]
        w, kp = cb._pack_weights(w2.flip(0, 1).transpose(2, 3), gy.dtype)
        batch = gy.shape[0]
        gzx = torch.empty(batch, f_in * c2x, T, dtype=gy.dtype, device=gy.device)
        gzs = torch.empty(batch, f_in * c2s, T, dtype=gy.dtype, device=gy.device)
        fn = libs["deconv_block_bwd"].dec_bwd_gz
        fn.argtypes = [i, p, p, i, i, p, i, p, i, i, i, i, p]
        args = [1, gy.data_ptr(), w.data_ptr(), c2out, kp, gzx.data_ptr(), c2x, gzs.data_ptr(),
                c2s, batch, f_in, T, stream]
        return libs["deconv_block_bwd"], fn, args, (gzx, gzs), (w,)
    (x, s), w2 = inp["acts"], inp["w2"]
    wx, ws = cb._split_joined(w2, c2x, c2s)
    wx, kp_x = cb._pack_weights(wx, x.dtype)
    ws, kp_s = cb._pack_weights(ws, x.dtype)
    cx = cb._pack_coeffs(inp["coefs"][0], inp["alphas"][0], x.dtype, x.device)
    cs = cb._pack_coeffs(inp["coefs"][1], inp["alphas"][1], x.dtype, x.device)
    bias = inp["b2"].float().contiguous()
    batch = x.shape[0]
    y = torch.empty(batch, 2 * f_in * c2out, T, dtype=x.dtype, device=x.device)
    st = torch.zeros(batch, 2 * f_in * c2out, 8, device=x.device) if stats else None
    fn = libs["deconv_block"].deconv_block
    fn.argtypes = [i, p, p, p, i, i, p, p, p, i, i, p, p, p, i, i, i, i, p]
    args = [1, x.data_ptr(), cx.data_ptr(), wx.data_ptr(), c2x, kp_x, s.data_ptr(),
            cs.data_ptr(), ws.data_ptr(), c2s, kp_s, bias.data_ptr(), y.data_ptr(),
            st.data_ptr() if stats else None, batch, f_in, c2out, T, stream]
    return libs["deconv_block"], fn, args, (y, st), (wx, ws, cx, cs, bias)


def _call_after(libs, kind, f_in, widths, c2out, inp, tile, pair, stats):
    """The current C entry points with the current packing (kernels/
    conv_block.py), the tile from the wrappers' rule or ``tile``."""
    _, library, name, _ = ROWS[kind]
    lib = libs[library]
    fn = getattr(lib, name)
    fn.argtypes = cb._ENTRIES[name][1]
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "gz":
        args, outs, keep = cb._dec_bwd_gz_args(inp["gy"], inp["w2"], f_in, *widths, c2out, tile)
    elif kind == "enc_gz":
        args, outs, keep = cb._enc_bwd_gz_args(inp["gy"], inp["w2"], f_in, *widths, c2out, tile,
                                               pair)
    elif kind == "enc_fwd":
        args, outs, keep = cb._conv_block_args(
            *inp["acts"], inp["w2"], inp["b2"], *inp["coefs"][0], inp["alphas"][0], f_in,
            *widths, c2out, stats, tile, pair)
    else:
        args, outs, keep = cb._deconv_block_args(
            *inp["acts"], inp["w2"], inp["b2"], inp["coefs"][0], inp["alphas"][0],
            inp["coefs"][1], inp["alphas"][1], f_in, *widths, c2out, stats, tile, pair)
    return lib, fn, args + [stream], outs, keep


def _check(kind, f_in, widths, c2out, inp, outs, with_stats):
    """Largest error against the plain version, in units of the bound
    |d| <= 2^-7 |ref| + 1e-3 (chip_smoke.py's BLOCK_RTOL / BLOCK_ATOL); stats
    as a share of each lane's largest magnitude."""
    stats = 0.0
    if kind == "gz":
        shapes = dict(f_in=f_in, c2x=widths[0], c2s=widths[1], c2out=c2out)
        want = cb.dec_bwd_gz_plain(inp["gy"], inp["w2"], **shapes)
        got = outs
    elif kind == "enc_gz":
        want = (cb.enc_bwd_gz_plain(inp["gy"], inp["w2"], f_in=f_in, c2in=widths[0],
                                    c2out=c2out),)
        got = (outs,)
    else:
        if kind == "enc_fwd":
            want_y, want_st = cb.fused_conv_block_plain(
                *inp["acts"], inp["w2"], inp["b2"], *inp["coefs"][0], inp["alphas"][0],
                f_in=f_in, c2in=widths[0], c2out=c2out, with_stats=True)
        else:
            want_y, want_st = cb.fused_deconv_block_plain(
                *inp["acts"], inp["w2"], inp["b2"], inp["coefs"][0], inp["alphas"][0],
                inp["coefs"][1], inp["alphas"][1], f_in=f_in, c2x=widths[0], c2s=widths[1],
                c2out=c2out, with_stats=True)
        got, want = (outs[0],), (want_y,)
        if with_stats:
            scale = want_st.abs().amax(dim=(0, 1), keepdim=True) + 1e-6
            stats = ((outs[1] - want_st).abs() / scale).max().item()
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        worst = max(worst, ((g - w).abs() / (2.0**-7 * w.abs() + 1e-3)).max().item())
    return worst, stats


TILES = [(128, 2), (64, 2), (32, 4), (16, 4)]  # block_mma.cuh: launch


def run(libs, design, stamped, dev, shapes, kinds, tiles, sweep=False, pair=None, stats=True):
    gen = torch.Generator(device=dev).manual_seed(5)
    for kind in kinds:
        for name, f_in, widths, c2out in shapes:
            if not name.startswith(ROWS[kind][3]):
                continue
            inp = _inputs(kind, name, f_in, widths, c2out, dev, gen)
            pairs = (False, True) if sweep and kind in PAIRED else (pair,)
            for tile in (TILES if sweep else [tiles.get(f"{kind}:{name}")]):
                for one in pairs:
                    _run_one(libs, design, stamped, kind, name, f_in, widths, c2out, inp, tile,
                             one, stats)
            del inp


def _run_one(libs, design, stamped, kind, name, f_in, widths, c2out, inp, tile, pair, stats):
    """One launch (warm-up, then the read), its error and reckoning, printed."""
    fwd = kind in ("fwd", "enc_fwd")
    stats = stats and fwd
    if design == "before":
        lib, fn, args, outs, keep = _call_before(libs, kind, f_in, widths, c2out, inp, stats)
    else:
        lib, fn, args, outs, keep = _call_after(libs, kind, f_in, widths, c2out, inp,
                                                tile, pair, stats)
    for _ in range(2):  # warm up, then the launch read
        if stamped:
            torch.cuda.synchronize()
            _build.check(lib, lib.probe_zero(), "probe_zero")
        if stats:
            outs[1].zero_()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _build.check(lib, fn(*args), f"{name} launch")
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    err, err_stats = _check(kind, f_in, widths, c2out, inp, outs, stats)
    w, z, once = reckon(design, kind, f_in, widths, c2out, tile, pair)
    row = ROWS[kind][0]
    shown = "" if stats or not fwd else " no stats"
    if design == "after":
        m = gemm(kind, f_in, widths, c2out)[3]
        two = paired(kind, m, pair)
        shown += " tile %dx%d" % (tile or cb.block_tile(2 * m if two else m))
        shown += " row pairs" if two else ""
    line = (f"{design} {'stamped' if stamped else 'bare'} {row} {name}{shown} B "
            f"{BATCH[kind]}: {ms:.3f} ms; error {err:.2f} of the bound"
            + (f", stats {err_stats:.1e} of lane max" if stats else "")
            + f"; staged W {w / 1e9:.2f} GB, Z {z / 1e9:.2f} GB "
            f"({(w + z) / ms / 1e9:.2f} TB/s), in + out once {once / 1e9:.2f} GB")
    if stamped:
        prof = (ctypes.c_ulonglong * 8)()
        _build.check(lib, lib.probe_read(prof), "probe_read")
        span, ns = prof[6], prof[7]
        names = PHASES[design]
        shares = ", ".join(f"{n} {100 * prof[k] / span:.1f}%"
                           for k, n in enumerate(names))
        line += f"; {shares} (SM clock {span / ns:.3f} GHz)"
    print(line, flush=True)
    del outs, keep


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--design", choices=("before", "after"), default="after")
    parser.add_argument("--csrc", type=Path, default=_build.CSRC,
                        help="kernel source directory (the first design's for --design before)")
    parser.add_argument("--shapes", default=DEFAULT_SHAPES,
                        help="blocks to run, of " + ", ".join(s[0] for s in SHAPES))
    parser.add_argument("--rows", default="gz,fwd,enc_gz,enc_fwd",
                        help="gz (row 7, dec_bwd_gz), fwd (row 4, fused_deconv_block), "
                             "enc_gz (row 5, enc_bwd_gz), enc_fwd (row 3, fused_conv_block)")
    parser.add_argument("--tile", action="append", default=[], metavar="ROW:BLOCK=BMxNB",
                        help="after: launch a block with this tile, e.g. gz:dec0=64x4")
    parser.add_argument("--stats", choices=("on", "off"), default="on",
                        help="the forward rows with or without the stats epilogue")
    parser.add_argument("--bare", action="store_true", help="skip the stamped build")
    parser.add_argument("--pair", choices=("rule", "on", "off"), default="rule",
                        help="after, fwd, enc_fwd, enc_gz: row-pair blocks as the wrappers' "
                             "rule says, always, never")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="none",
                        help="after: build block_mma.cuh with this change")
    parser.add_argument("--sweep", action="store_true",
                        help="after, bare: launch every block with every tile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    tiles = {}
    for spec in args.tile:
        key, tile = spec.split("=")
        tiles[key] = tuple(int(v) for v in tile.split("x"))
    shapes = [s for s in SHAPES if s[0] in args.shapes.split(",")]
    kinds = args.rows.split(",")
    names = sorted({ROWS[kind][1] for kind in kinds})
    dev = torch.device("cuda")
    for stamped in (False,) if args.bare else (False, True):
        run(build(args.csrc.resolve(), args.design, stamped, names, args.variant), args.design,
            stamped, dev, shapes, kinds, tiles, args.sweep and not stamped,
            {"rule": None, "on": True, "off": False}[args.pair], args.stats == "on")


if __name__ == "__main__":
    main()
