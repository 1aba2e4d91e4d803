#!/usr/bin/env python3
"""Where the time of the LSTM recurrence kernels goes, on one GPU.

Builds an instrumented copy of ``speech_enhancement_torch/kernels/csrc/
lstm_fwd.cu`` or ``lstm_bwd.cu`` (and of ``lstm.cuh``): this script inserts
``clock64`` stamps at fixed places of the sources and compiles the copy into
``kernels/build/probe/``; the package's sources are not changed. Thread 0 of
every block adds each phase's cycles to a device array, and the script
prints the mean over blocks in microseconds a step (cycles converted by the
launch's own ``%globaltimer`` span), beside the kernel's event time and its
largest error against the plain version.

``--dtype float32`` takes mel-rnn's and Demucs's f32 shapes instead of
CRN's bf16 ones (``F32_SHAPES``, ``BWD_F32_SHAPES``), and ``--csrc DIR``
stamps another tree's sources (an earlier commit's, unpacked under
``_checkout/``).

The forward (``--kernel fwd``), three designs, all still in the source:

* ``ring`` (the bf16 path, ``lstm_fwd_ring``): wait (``cp.async.wait_group``
  and the round's warp barrier), issue (the next slab's copies), products
  (ldmatrix and mma.sync), other (the round loop and the epilogue), fill
  (the ring's first slabs) and barrier (x_proj prefetch and grid_sync);
  ``--stages`` rebuilds it with another ring depth.
* ``chunked`` (the first design, ``lstm_fwd_kernel`` with ``gemm_chunk``,
  which the bf16 path took before the ring): stage (storing the register-
  staged chunk between two block barriers), products (the next chunk's
  loads and the mma loop, to the next barrier), out-store (partials to
  shared memory), epilogue and barrier.
* ``f32`` (the split-f32 path, ``lstm_fwd_f32`` over ``lstm.cuh``'s
  ``tc::warp_chunk``), or ``f32:cvt`` with its A fragments split by
  ``cvt.rna.tf32``: fill, wait, issue and products of the warp's ring as
  in the ring, partials (the warp's f32 partials and the block barrier),
  sum (the owners' sums, gate math and stores), barrier (grid_sync),
  prefetch (the next step's x_proj issued) and other.

The backward (``--kernel bwd``) at CRN's train shape (T 501, B 16, H
1792), or at the f32 shapes, every design of ``--designs`` in one call:

* ``first`` (``lstm_bwd_kernel`` with ``gemm_chunk``, forced for bf16):
  pointwise (the loads, the math and the dgates stores' issue, to a block
  barrier), stores (thread 0's fence: the block's dgates stores landing),
  barrier (grid_sync), staging, products and partials (``gemm_chunk``'s
  register-staged chunks, mma loop and f32 out-store, as the forward's
  chunked split) and dh store (the split sums written to dh);
* ``ring`` (``lstm_bwd_ring``), or ``ring:KCxSTAGES`` with the round's k
  and the ring's depth forced: pointwise, stores and barrier as above,
  prefetch (the next step's operands issued), fill (the ring's first
  slabs), wait (``cp.async.wait_group`` and the warp barrier), issue (the
  next slab's copies), products (ldmatrix and mma.sync), partials (the
  warp's f32 partials and the block barrier) and sum (the owners' sums);
* ``f32`` (``lstm_bwd_f32``) or ``f32:cvt``: the ring's phases.
Each design is also timed without stamps (``bare``) in the same call.

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/lstm_fwd_phase_probe.py [--design ring|chunked] [--stages 3]
    python3 tools/lstm_fwd_phase_probe.py --kernel bwd [--designs first,ring,ring:32x3]
    python3 tools/lstm_fwd_phase_probe.py --dtype float32 --design f32|f32:cvt|chunked
    python3 tools/lstm_fwd_phase_probe.py --kernel bwd --dtype float32 --designs first,f32
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from speech_enhancement_torch.kernels import _build  # noqa: E402
from speech_enhancement_torch.kernels import lstm as lstm_k  # noqa: E402

SHAPES = [("crn serve", 501, 192, 1792), ("crn train", 501, 16, 1792),
          ("rnn-stft-mask serve", 501, 384, 896)]
# --dtype float32: mel-rnn's serving layer and Demucs's serving BLSTMs
# (configs/mel_rnn_vbd.yaml, configs/demucs_clarity.yaml), then mel-rnn's
# train batch
F32_SHAPES = [("mel-rnn serve", 501, 192, 256), ("demucs serve, layer 5", 30, 192, 512),
              ("demucs serve, layer 4", 124, 192, 256), ("mel-rnn train", 501, 16, 256)]
PHASES = {"ring": ["wait", "issue", "products", "other", "fill", "barrier"],
          "chunked": ["stage", "products", "out-store", "epilogue", "barrier"],
          "f32": ["wait", "issue", "products", "fill", "partials", "sum", "", "", "barrier",
                  "prefetch", "other"]}

SOURCES = _build.CSRC  # the kernel sources stamped (--csrc)
SLOTS = 16  # phases a block; the last two hold the launch's cycles and ns
PLAN_INTS = 20  # lstm_bwd_plan's out[] (17 before the split-f32 designs)
BWD_PHASES = {"first": ["staging", "products", "partials", "dh store", "pointwise", "stores",
                        "barrier"],
              "ring": ["wait", "issue", "products", "fill", "partials", "sum", "pointwise",
                       "stores", "barrier", "prefetch", "other"]}
BWD_PHASES["f32"] = BWD_PHASES["ring"]
BWD_SHAPE = ("crn train", 501, 16, 1792)
BWD_F32_SHAPES = [("mel-rnn train", 501, 16, 256), ("demucs train, layer 4", 124, 8, 256),
                  ("demucs train, layer 5", 30, 8, 512)]

PRELUDE = """
__device__ unsigned long long g_prof[16 * 1024];
__device__ __forceinline__ void probe_add(int k, unsigned long long v) {
  if (threadIdx.x == 0) atomicAdd(&g_prof[blockIdx.x * 16 + k], v);
}
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""

ENTRIES = """
extern "C" int probe_zero() {
  static unsigned long long zero[16 * 1024];
  return static_cast<int>(cudaMemcpyToSymbol(lstm::g_prof, zero, sizeof(zero)));
}
extern "C" int probe_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, lstm::g_prof, sizeof(lstm::g_prof)));
}
"""


# the parts of a kernel source that a design's stamps patch: its first
# design's kernel, its bf16 ring, its split-f32 kernel
FIRST = ("template <typename T>\n__global__", "namespace ring {")
RING = ("namespace ring {", "}  // namespace ring")
F32 = ("namespace f32 {", "}  // namespace f32")


def _patch(text: str, pairs, scope=None) -> str:
    """Each (old, new) of ``pairs`` once, in the part of ``text`` between
    the markers of ``scope`` (the whole text without one)."""
    if scope is not None:
        begin = text.index(scope[0])
        end = text.index(scope[1], begin)
        return text[:begin] + _patch(text[begin:end], pairs) + text[end:]
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _force_first(text: str) -> str:
    """Route every shape to the first design: the routing of this tree, or
    of an older one (--csrc), whose bf16 paths were the only others."""
    for old, new in FORCE_FIRST:
        if text.count(old) == 1:
            return text.replace(old, new)
    raise RuntimeError("no design choice found to force the first design")


FORCE_FIRST = [
    ("const int design = choose<T>(a, sms, optin, rp, fp, wp);",
     "const int design = choose<T>(a, sms, optin, rp, fp, wp) < 0 ? -1 : 0;"),
    ("const int design = choose<T>(a, sms, optin, rp, fp);",
     "const int design = choose<T>(a, sms, optin, rp, fp) < 0 ? -1 : 0;"),
    ("  if (sizeof(T) == 2 && a.vec && reinterpret_cast<uintptr_t>(a.wt) % 16 == 0) {",
     "  if (false) {"),
    ("  if (design == 1) return ring::launch(a, rp, blocks, stream);",
     "  if (design == 1 && false) return ring::launch(a, rp, blocks, stream);"),
]

# The split-f32 designs' shared ring (lstm.cuh, tc::warp_chunk), stamped in
# the slots of the backward ring's phases: 0 wait, 1 issue, 2 products, 3
# fill, 4 partials (the warp's stores and the block barrier), 10 other
TC_STAMPS = [
    ("  for (int i = 0; i < p.stages - 1; ++i) issue();\n\n  // ldmatrix",
     "  const unsigned long long f0 = clock64();\n"
     "  for (int i = 0; i < p.stages - 1; ++i) issue();\n"
     "  unsigned long long tl = clock64();\n  probe_add(3, tl - f0);\n\n  // ldmatrix"),
    ("    wait_rounds(p.stages - 2);  // this lane's copies of round j have landed\n"
     "    __syncwarp();               // the warp's have, and it is done with the slot it refills\n"
     "    issue();\n",
     "    const unsigned long long r0 = clock64();\n    probe_add(10, r0 - tl);\n"
     "    wait_rounds(p.stages - 2);\n    __syncwarp();\n"
     "    const unsigned long long r1 = clock64();\n    probe_add(0, r1 - r0);\n"
     "    issue();\n    tl = clock64();\n    probe_add(1, tl - r1);\n"),
    ("    if (++r_cur == r_end) r_cur = r_begin;\n",
     "    const unsigned long long r3 = clock64();\n    probe_add(2, r3 - tl);\n    tl = r3;\n"
     "    if (++r_cur == r_end) r_cur = r_begin;\n"),
    ("  __syncwarp();  // every lane's copies have landed and its reads are done\n",
     "  const unsigned long long p0 = clock64();\n  probe_add(10, p0 - tl);\n"
     "  __syncwarp();\n"),
    ("make_float2(acc[m][n][2], acc[m][n][3]);\n      }\n}",
     "make_float2(acc[m][n][2], acc[m][n][3]);\n      }\n  probe_add(4, clock64() - p0);\n}"),
]
TC_SCOPE = ("namespace tc {", "}  // namespace tc")
# the split-f32 designs with the A fragments split by two cvt.rna.tf32
# (both parts rounded), as the first version of the designs did
TC_CVT = [("            for (int e = 0; e < 4; ++e) mmautil::split_tf32(__uint_as_float(raw[e]), "
           "ab[e], as[e]);",
           "            for (int e = 0; e < 4; ++e) {\n"
           "              ab[e] = mmautil::to_tf32(__uint_as_float(raw[e]));\n"
           "              as[e] = mmautil::to_tf32(__uint_as_float(raw[e]) - "
           "__uint_as_float(ab[e]));\n            }")]
# the forward's split-f32 kernel: 4 partials (the block barrier too), 5
# sum (the owners' sums, gate math and stores), 8 barrier, 9 prefetch
FWD_F32_STAMPS = [
    ("  prefetch(a.reverse ? a.steps - 1 : 0);\n",
     "  prefetch(a.reverse ? a.steps - 1 : 0);\n"
     "  const unsigned long long pstart = clock64(), nstart = lstm::probe_ns();\n"),
    ("      __syncthreads();  // every warp's partials are in its ring\n",
     "      const unsigned long long e0 = clock64();\n      __syncthreads();\n"
     "      const unsigned long long e1 = clock64();\n      lstm::probe_add(4, e1 - e0);\n"),
    ("      if (c + 1 < p.chunks) __syncthreads();  // the next chunk's copies overwrite the"
     " partials\n    }\n    if (s + 1 < a.steps) {\n"
     "      lstm::grid_sync(a.bar, gridDim.x);  // h_seq[t] of every unit is written\n"
     "      prefetch(a.reverse ? t - 1 : t + 1);  // lands under the products\n    }\n  }\n",
     "      if (c + 1 < p.chunks) __syncthreads();\n      lstm::probe_add(5, clock64() - e1);\n"
     "    }\n    if (s + 1 < a.steps) {\n      const unsigned long long b0 = clock64();\n"
     "      lstm::grid_sync(a.bar, gridDim.x);\n      const unsigned long long b1 = clock64();\n"
     "      lstm::probe_add(8, b1 - b0);\n      prefetch(a.reverse ? t - 1 : t + 1);\n"
     "      lstm::probe_add(9, clock64() - b1);\n    }\n  }\n"
     "  lstm::probe_add(14, clock64() - pstart);\n"
     "  lstm::probe_add(15, lstm::probe_ns() - nstart);\n"),
]


def instrumented_sources(design: str, stages: int):
    """(lstm.cuh, lstm_fwd.cu) with the stamps of ``design``."""
    cuh = (SOURCES / "lstm.cuh").read_text()
    cu = (SOURCES / "lstm_fwd.cu").read_text()
    cuh = _patch(cuh, [("namespace lstm {\n", "namespace lstm {\n" + PRELUDE)])
    cu = _patch(cu, [("constexpr int STAGES = 3;", f"constexpr int STAGES = {stages};")])
    cu += ENTRIES
    if design.startswith("f32"):
        if design == "f32:cvt":
            cuh = _patch(cuh, TC_CVT, TC_SCOPE)
        cuh = _patch(cuh, TC_STAMPS, TC_SCOPE)
        cu = _patch(cu, FWD_F32_STAMPS, F32)
    elif design == "ring":
        cu = _patch(cu, [
            ("  prefetch(a.reverse ? a.steps - 1 : 0, 0);\n  for (int s = 0; s < a.steps; ++s) {",
             "  prefetch(a.reverse ? a.steps - 1 : 0, 0);\n"
             "  const unsigned long long pstart = clock64(), nstart = lstm::probe_ns();\n"
             "  unsigned long long tl = 0;\n"
             "  for (int s = 0; s < a.steps; ++s) {"),
            ("    for (int i = 0; i < STAGES - 1; ++i) issue(hprev);\n",
             "    const unsigned long long f0 = clock64();\n"
             "    for (int i = 0; i < STAGES - 1; ++i) issue(hprev);\n"
             "    tl = clock64();\n    lstm::probe_add(4, tl - f0);\n"),
            ("      cp_async_wait<STAGES - 2>();",
             "      const unsigned long long t0 = clock64();\n      lstm::probe_add(3, t0 - tl);\n"
             "      cp_async_wait<STAGES - 2>();"),
            ("      issue(hprev);\n      const int c = cur.chunk;",
             "      const unsigned long long t1 = clock64();\n      lstm::probe_add(0, t1 - t0);\n"
             "      issue(hprev);\n"
             "      const unsigned long long t2 = clock64();\n      lstm::probe_add(1, t2 - t1);\n"
             "      const int c = cur.chunk;"),
            ("      if (kk != p.kr - 1) continue;",
             "      tl = clock64();\n      lstm::probe_add(2, tl - t2);\n"
             "      if (kk != p.kr - 1) continue;"),
            ("    if (s + 1 < a.steps) {\n"
             "      prefetch(a.reverse ? t - 1 : t + 1, 0);"
             "  // independent of the other blocks\n"
             "      lstm::grid_sync(a.bar, gridDim.x);\n    }\n  }\n",
             "    const unsigned long long b0 = clock64();\n    lstm::probe_add(3, b0 - tl);\n"
             "    if (s + 1 < a.steps) {\n"
             "      prefetch(a.reverse ? t - 1 : t + 1, 0);\n"
             "      lstm::grid_sync(a.bar, gridDim.x);\n    }\n"
             "    lstm::probe_add(5, clock64() - b0);\n  }\n"
             "  lstm::probe_add(14, clock64() - pstart);\n"
             "  lstm::probe_add(15, lstm::probe_ns() - nstart);\n"),
        ], RING)
    else:
        cu = _patch(_force_first(cu), [
            ("  // (gemm_chunk's first __syncthreads publishes the slice)\n",
             "  const unsigned long long pstart = clock64(), nstart = lstm::probe_ns();\n"),
            ("      gemm_chunk<T>(p, ws, hprev, H, B, n0, a.vec != 0, stage, out);\n",
             "      gemm_chunk<T>(p, ws, hprev, H, B, n0, a.vec != 0, stage, out);\n"
             "      const unsigned long long e0 = clock64();\n"),
            ("        gt[3 * H] = from_f32<T>(o);\n      }\n    }\n"
             "    if (s + 1 < a.steps) grid_sync(a.bar, gridDim.x);\n  }\n}",
             "        gt[3 * H] = from_f32<T>(o);\n      }\n"
             "      __syncthreads();\n      probe_add(3, clock64() - e0);\n    }\n"
             "    const unsigned long long b0 = clock64();\n"
             "    if (s + 1 < a.steps) grid_sync(a.bar, gridDim.x);\n"
             "    probe_add(4, clock64() - b0);\n  }\n"
             "  probe_add(14, clock64() - pstart);\n  probe_add(15, probe_ns() - nstart);\n}"),
        ], FIRST)
        cuh = _patch(cuh, CHUNK_STAMPS)
    return cuh, cu


# gemm_chunk's stamps (lstm.cuh), both kernels' first design: 0 stage, 1
# products, 2 out-store
CHUNK_STAMPS = [
    ("  if (vec) st.load(p, src, ldb, n_total, n0, chunk_k0(0));\n"
     "  for (int c = 0; c < chunks; ++c) {\n"
     "    const int k0 = chunk_k0(c);\n"
     "    __syncthreads();  // the previous chunk's readers are done with the stage\n",
     "  if (vec) st.load(p, src, ldb, n_total, n0, chunk_k0(0));\n"
     "  unsigned long long pt0 = clock64(), pt1 = 0;\n"
     "  for (int c = 0; c < chunks; ++c) {\n"
     "    const int k0 = chunk_k0(c);\n    __syncthreads();\n"
     "    pt1 = clock64();\n    if (c > 0) probe_add(1, pt1 - pt0);\n"),
    ("    __syncthreads();\n    if (vec && c + 1 < chunks) st.load(",
     "    __syncthreads();\n    pt0 = clock64();\n    probe_add(0, pt0 - pt1);\n"
     "    if (vec && c + 1 < chunks) st.load("),
    ("\n  if constexpr (kMma) {\n    if (active) {\n",
     "\n  __syncthreads();\n  const unsigned long long pt3 = clock64();\n"
     "  probe_add(1, pt3 - pt0);\n  if constexpr (kMma) {\n    if (active) {\n"),
    ("  __syncthreads();\n}\n\n// Sum of the splits'",
     "  __syncthreads();\n  probe_add(2, clock64() - pt3);\n}\n\n// Sum of the splits'"),
]


# The backward's stamps (lstm_bwd.cu). The probe's own block barrier and
# thread 0's fence before grid_sync split the pointwise part from its
# stores' landing; grid_sync then finds no store of thread 0 to wait for.
BWD_FIRST_STAMPS = [
    ("  for (int s = 0; s < a.steps; ++s) {\n    const int t = a.reverse ? s : a.steps - 1 - s;\n"
     "    // the pointwise part for the block's own units\n",
     "  __syncthreads();\n"
     "  const unsigned long long pstart = clock64(), nstart = probe_ns();\n"
     "  for (int s = 0; s < a.steps; ++s) {\n    const int t = a.reverse ? s : a.steps - 1 - s;\n"
     "    const unsigned long long q0 = clock64();\n"),
    ("    grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written\n"
     "    const T* src = dgates",
     "    __syncthreads();\n    const unsigned long long q1 = clock64();\n"
     "    probe_add(4, q1 - q0);\n    if (threadIdx.x == 0) __threadfence();\n"
     "    const unsigned long long q2 = clock64();\n    probe_add(5, q2 - q1);\n"
     "    grid_sync(a.bar, gridDim.x);\n    probe_add(6, clock64() - q2);\n"
     "    const T* src = dgates"),
    ("      gemm_chunk<T>(p, ws, src, G4, B, n0, a.vec != 0, stage, out);\n",
     "      gemm_chunk<T>(p, ws, src, G4, B, n0, a.vec != 0, stage, out);\n"
     "      const unsigned long long e0 = clock64();\n"),
    ("gathered(p, out, u, n);\n      }\n    }\n"
     "    __syncthreads();  // the next step's pointwise part reads dh in another thread mapping\n"
     "  }\n}",
     "gathered(p, out, u, n);\n      }\n      __syncthreads();\n"
     "      probe_add(3, clock64() - e0);\n    }\n    __syncthreads();\n  }\n"
     "  probe_add(14, clock64() - pstart);\n  probe_add(15, probe_ns() - nstart);\n}"),
]
BWD_RING_STAMPS = [
    ("  prefetch(a.reverse ? 0 : a.steps - 1);\n  for (int s = 0; s < a.steps; ++s) {",
     "  prefetch(a.reverse ? 0 : a.steps - 1);\n"
     "  const unsigned long long pstart = clock64(), nstart = lstm::probe_ns();\n"
     "  for (int s = 0; s < a.steps; ++s) {"),
    ("    const long long trow = static_cast<long long>(t) * B;\n",
     "    const long long trow = static_cast<long long>(t) * B;\n"
     "    const unsigned long long q0 = clock64();\n"),
    ("    lstm::grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written\n"
     "    if (s + 1 < a.steps) prefetch(a.reverse ? t + 1 : t - 1);  // lands under the products\n",
     "    __syncthreads();\n    const unsigned long long q1 = clock64();\n"
     "    lstm::probe_add(6, q1 - q0);\n    if (threadIdx.x == 0) __threadfence();\n"
     "    const unsigned long long q2 = clock64();\n    lstm::probe_add(7, q2 - q1);\n"
     "    lstm::grid_sync(a.bar, gridDim.x);\n    const unsigned long long q3 = clock64();\n"
     "    lstm::probe_add(8, q3 - q2);\n"
     "    if (s + 1 < a.steps) prefetch(a.reverse ? t + 1 : t - 1);\n"
     "    unsigned long long tl = clock64();\n    lstm::probe_add(9, tl - q3);\n"),
    ("      for (int i = 0; i < p.stages - 1; ++i) issue();\n",
     "      const unsigned long long f0 = clock64();\n      lstm::probe_add(10, f0 - tl);\n"
     "      for (int i = 0; i < p.stages - 1; ++i) issue();\n"
     "      tl = clock64();\n      lstm::probe_add(3, tl - f0);\n"),
    ("        wait_rounds(p.stages - 2);  // this lane's copies of round j have landed\n"
     "        __syncwarp();               // the warp's have, and it is done with the slot it"
     " refills\n"
     "        issue();\n",
     "        const unsigned long long r0 = clock64();\n        lstm::probe_add(10, r0 - tl);\n"
     "        wait_rounds(p.stages - 2);\n        __syncwarp();\n"
     "        const unsigned long long r1 = clock64();\n        lstm::probe_add(0, r1 - r0);\n"
     "        issue();\n        tl = clock64();\n        lstm::probe_add(1, tl - r1);\n"),
    ("        if (++r_cur == r_end) r_cur = r_begin;\n",
     "        const unsigned long long r3 = clock64();\n        lstm::probe_add(2, r3 - tl);\n"
     "        tl = r3;\n        if (++r_cur == r_end) r_cur = r_begin;\n"),
    ("      __syncwarp();\n      float* part = reinterpret_cast<float*>(region);\n",
     "      const unsigned long long p0 = clock64();\n      lstm::probe_add(10, p0 - tl);\n"
     "      __syncwarp();\n      float* part = reinterpret_cast<float*>(region);\n"),
    ("      __syncthreads();\n#pragma unroll\n      for (int i = 0; i < PPT; ++i) {\n"
     "        const int bl = pb[i] - c * p.nb;",
     "      __syncthreads();\n      const unsigned long long p1 = clock64();\n"
     "      lstm::probe_add(4, p1 - p0);\n#pragma unroll\n      for (int i = 0; i < PPT; ++i) {\n"
     "        const int bl = pb[i] - c * p.nb;"),
    ("      if (c + 1 < p.chunks) __syncthreads();  // the next chunk's copies overwrite the"
     " partials\n"
     "    }\n  }\n",
     "      if (c + 1 < p.chunks) __syncthreads();\n      tl = clock64();\n"
     "      lstm::probe_add(5, tl - p1);\n    }\n  }\n"
     "  lstm::probe_add(14, clock64() - pstart);\n"
     "  lstm::probe_add(15, lstm::probe_ns() - nstart);\n"),
]


# Variants of the ring that leave a part out (their results are wrong; the
# time is what they show): no copies, no products, or the next step's
# operands loaded before the grid barrier instead of after it.
BWD_RING_FLAGS = {
    "nocopy": [("            mmautil::cp_async16(slab + row * KC",
                "            if (false) mmautil::cp_async16(slab + row * KC")],
    "noproducts": [("        if (nv > 0) {\n          const bf16* slab",
                    "        if (nv > 0 && false) {\n          const bf16* slab")],
    "early": [("    lstm::grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written\n"
               "    if (s + 1 < a.steps) prefetch(a.reverse ? t + 1 : t - 1);"
               "  // lands under the products\n",
               "    if (s + 1 < a.steps) prefetch(a.reverse ? t + 1 : t - 1);\n"
               "    lstm::grid_sync(a.bar, gridDim.x);\n")],
}


BWD_F32_STAMPS = [
    ("  prefetch(a.reverse ? 0 : a.steps - 1);\n",
     "  prefetch(a.reverse ? 0 : a.steps - 1);\n"
     "  const unsigned long long pstart = clock64(), nstart = lstm::probe_ns();\n"),
    BWD_RING_STAMPS[1],
    BWD_RING_STAMPS[2],
    ("      __syncthreads();  // every warp's partials are in its ring\n",
     "      const unsigned long long e0 = clock64();\n      __syncthreads();\n"
     "      const unsigned long long e1 = clock64();\n      lstm::probe_add(4, e1 - e0);\n"),
    ("      if (c + 1 < p.chunks) __syncthreads();  // the next chunk's copies overwrite the"
     " partials\n    }\n  }\n",
     "      if (c + 1 < p.chunks) __syncthreads();\n      lstm::probe_add(5, clock64() - e1);\n"
     "    }\n  }\n  lstm::probe_add(14, clock64() - pstart);\n"
     "  lstm::probe_add(15, lstm::probe_ns() - nstart);\n"),
]


def bwd_sources(variant: str, stamps: bool):
    """(lstm.cuh, lstm_bwd.cu) of a backward variant, with or without the
    stamps: ``first``, ``f32``, or ``ring`` with optional parts
    ``:KCxSTAGES`` (the round's k and the ring's depth forced) and
    ``:nocopy``, ``:noproducts`` or ``:early`` (BWD_RING_FLAGS, unstamped
    only)."""
    cuh = (SOURCES / "lstm.cuh").read_text()
    cu = (SOURCES / "lstm_bwd.cu").read_text()
    cuh = _patch(cuh, [("namespace lstm {\n", "namespace lstm {\n" + PRELUDE)])
    cu += ENTRIES
    design, *parts = variant.split(":")
    for part in parts:
        if part == "cvt":
            cuh = _patch(cuh, TC_CVT, TC_SCOPE)
            continue
        if part in BWD_RING_FLAGS:
            cu = _patch(cu, BWD_RING_FLAGS[part], RING)
            continue
        kc, stages = part.split("x")
        cu = _patch(cu, [
            ("constexpr int KCS[] = {64, 32, 16};", f"constexpr int KCS[] = {{{kc}}};"),
            ("constexpr int MIN_STAGES = 3;", f"constexpr int MIN_STAGES = {min(3, int(stages))};"),
            ("constexpr int MAX_STAGES = 8;", f"constexpr int MAX_STAGES = {stages};")], RING)
    if design == "first":
        cu = _force_first(cu)
        if stamps:
            cu = _patch(cu, BWD_FIRST_STAMPS, FIRST)
            cuh = _patch(cuh, CHUNK_STAMPS)
    elif design == "f32" and stamps:
        cuh = _patch(cuh, TC_STAMPS, TC_SCOPE)
        cu = _patch(cu, BWD_F32_STAMPS, F32)
    elif stamps:
        cu = _patch(cu, BWD_RING_STAMPS, RING)
    return cuh, cu


def build_bwd(variants) -> dict:
    """{(variant, stamped): library}, one nvcc per library, all at once."""
    jobs = {}
    for variant in variants:
        flagged = any(part in BWD_RING_FLAGS for part in variant.split(":"))
        for stamps in (False,) if flagged else (True, False):
            out = _build.BUILD / "probe" / f"bwd-{variant.replace(':', '-')}-{int(stamps)}"
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir(parents=True)
            cuh, cu = bwd_sources(variant, stamps)
            for header in SOURCES.glob("*.cuh"):
                shutil.copy(header, out / header.name)
            (out / "lstm.cuh").write_text(cuh)
            (out / "lstm_bwd.cu").write_text(cu)
            lib = out / "probe.so"
            jobs[variant, stamps] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "lstm_bwd.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        for line in log.splitlines():
            if key[1] and ("registers" in line or "spill" in line or "entry function" in line):
                print(f"ptxas {key[0]}: {line.strip()}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def run_bwd(libs: dict, dev: torch.device, dtype: torch.dtype) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    shapes = [BWD_SHAPE] if dtype == torch.bfloat16 else BWD_F32_SHAPES
    is_bf16 = int(dtype == torch.bfloat16)
    for tag, steps, batch, hidden in shapes:
        gen = torch.Generator(device=dev).manual_seed(5)
        x_proj = torch.randn(steps, batch, 4 * hidden, device=dev, generator=gen).to(dtype)
        w_hh = (torch.randn(hidden, 4 * hidden, device=dev, generator=gen) / hidden**0.5).to(dtype)
        h0 = torch.zeros(batch, hidden, device=dev, dtype=dtype)
        _, c_seq, gates = lstm_k.fused_lstm_plain(x_proj, w_hh, h0, h0)
        c_prev = lstm_k.shift_prev(c_seq, h0, False)
        dout = torch.randn(steps, batch, hidden, device=dev, generator=gen).to(dtype)
        d_last = torch.randn(batch, hidden, device=dev, generator=gen)
        zero = torch.zeros(batch, hidden, device=dev)
        want = lstm_k.lstm_bwd_plain(gates, c_seq, c_prev, dout, w_hh, zero, d_last)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = -(-hidden // -(-hidden // sms))
        for (variant, stamps), lib in libs.items():
            run_bwd_variant(lib, variant, stamps, (tag, steps, batch, hidden, blocks), is_bf16,
                            (gates, c_seq, c_prev, dout, w_hh, zero, d_last), want, dev)


def run_bwd_variant(lib, variant, stamps, shape, is_bf16, args, want, dev) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    tag, steps, batch, hidden, blocks = shape
    gates, c_seq, c_prev, dout, w_hh, zero, d_last = args
    lib.lstm_bwd.argtypes = [i] + [p] * 9 + [i] * 4 + [p]
    lib.lstm_bwd_plan.argtypes = [i] * 4 + [p]
    lib.probe_read.argtypes = [p]
    plan = (ctypes.c_int * PLAN_INTS)()
    _build.check(lib, lib.lstm_bwd_plan(is_bf16, hidden, batch, 1, ctypes.addressof(plan)),
                 "lstm_bwd_plan")
    for _ in range(2):  # the second launch is the one read
        dh, dc = zero.clone(), d_last.clone()
        dgates = torch.empty_like(gates)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        _build.check(lib, lib.probe_zero(), "probe_zero")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        code = lib.lstm_bwd(is_bf16, gates.data_ptr(), c_seq.data_ptr(), c_prev.data_ptr(),
                            dout.data_ptr(), w_hh.data_ptr(), dh.data_ptr(), dc.data_ptr(),
                            dgates.data_ptr(), bar.data_ptr(), steps, batch, hidden, 0,
                            torch.cuda.current_stream().cuda_stream)
        end.record()
        torch.cuda.synchronize()
        _build.check(lib, code, "lstm_bwd (instrumented)")
    rel = [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
           for g, w in zip((dgates, dh, dc), want)]
    ms = start.elapsed_time(end)
    design = variant.split(":")[0]  # lstm_bwd_plan is not forced to the first design
    ring = (f" (kc {plan[3]}, {plan[6]} stages, wm {plan[7]}, wk {plan[8]}, mw {plan[9]}, "
            f"{plan[16]} bytes)" if design == "ring" and plan[0] == 1 else
            f" ({plan[6]} stages, wm {plan[7]}, wk {plan[8]}, mw {plan[9]}, {plan[18]} bytes)"
            if design == "f32" and plan[0] == 2 else "")
    head = (f"bwd {variant}{'' if stamps else ' bare'} T {steps} B {batch} H {hidden} ({tag}), "
            f"{'bf16' if is_bf16 else 'f32'}, {design}{ring}: {ms:.3f} ms, "
            f"{ms * 1e3 / steps:.2f} us a step, dgates, dh0, dc0 "
            f"within {[f'{r:.2e}' for r in rel]} of their largest")
    if not stamps:
        print(head, flush=True)
        return
    prof = (ctypes.c_ulonglong * (SLOTS * 1024))()
    _build.check(lib, lib.probe_read(ctypes.addressof(prof)), "probe_read")
    rows = torch.tensor(list(prof), dtype=torch.float64).view(-1, SLOTS)[:blocks]
    ns_per_cycle = (rows[:, 15] / rows[:, 14]).mean().item()
    us = rows.mean(0) * ns_per_cycle / 1e3 / steps
    split = ", ".join(f"{n} {us[k].item():.2f}"
                      for k, n in enumerate(BWD_PHASES[design]))
    print(f"{head}; us a step, mean over {blocks} blocks: {split}, total "
          f"{us[14].item():.2f} (SM clock {1 / ns_per_cycle:.3f} GHz)", flush=True)


def build(design: str, stages: int) -> ctypes.CDLL:
    out = _build.BUILD / "probe" / f"{design}-{stages}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cuh, cu = instrumented_sources(design, stages)
    for header in SOURCES.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "lstm.cuh").write_text(cuh)
    (out / "lstm_fwd.cu").write_text(cu)
    lib = out / "probe.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "lstm_fwd.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def run(lib: ctypes.CDLL, design: str, dev: torch.device, dtype: torch.dtype) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd.argtypes = [i] + [p] * 8 + [i] * 4 + [p]
    lib.probe_read.argtypes = [p]
    names = PHASES[design.split(":")[0]]
    is_bf16 = int(dtype == torch.bfloat16)
    for tag, steps, batch, hidden in SHAPES if is_bf16 else F32_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(5)
        x_proj = torch.randn(steps, batch, 4 * hidden, device=dev, generator=gen).to(dtype)
        w_hh = (torch.randn(hidden, 4 * hidden, device=dev, generator=gen) / hidden**0.5).to(dtype)
        h0 = torch.zeros(batch, hidden, device=dev, dtype=dtype)
        c0 = torch.zeros_like(h0)
        want = lstm_k.fused_lstm_plain(x_proj, w_hh, h0, c0)
        w_t = w_hh.t().contiguous()
        for _ in range(2):  # the second launch is the one read
            c = torch.zeros(batch, hidden, device=dev)
            h_seq = torch.empty(steps, batch, hidden, device=dev, dtype=dtype)
            c_seq, gates = torch.empty_like(h_seq), torch.empty_like(x_proj)
            bar = torch.zeros(2, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            _build.check(lib, lib.probe_zero(), "probe_zero")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            code = lib.lstm_fwd(is_bf16, x_proj.data_ptr(), w_t.data_ptr(), h0.data_ptr(),
                                c.data_ptr(), h_seq.data_ptr(), c_seq.data_ptr(),
                                gates.data_ptr(), bar.data_ptr(), steps, batch, hidden, 0,
                                torch.cuda.current_stream().cuda_stream)
            end.record()
            torch.cuda.synchronize()
            _build.check(lib, code, "lstm_fwd (instrumented)")
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip((h_seq, c_seq, gates), want))
        prof = (ctypes.c_ulonglong * (SLOTS * 1024))()
        _build.check(lib, lib.probe_read(ctypes.addressof(prof)), "probe_read")
        blocks = -(-hidden // -(-hidden // torch.cuda.get_device_properties(dev)
                                .multi_processor_count))
        rows = torch.tensor(list(prof), dtype=torch.float64).view(-1, SLOTS)[:blocks]
        ns_per_cycle = (rows[:, 15] / rows[:, 14]).mean().item()
        us = rows.mean(0) * ns_per_cycle / 1e3 / steps
        ms = start.elapsed_time(end)
        split = ", ".join(f"{n} {us[k].item():.2f}" for k, n in enumerate(names) if n)
        print(f"{design} {'bf16' if is_bf16 else 'f32'} T {steps} B {batch} H {hidden} ({tag}): "
              f"{ms:.3f} ms, {ms * 1e3 / steps:.2f} us a step, max abs err vs plain {err:.3e}; "
              f"us a step, mean over {blocks} blocks: {split}, total {us[14].item():.2f} "
              f"(SM clock {1 / ns_per_cycle:.3f} GHz)", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    parser.add_argument("--design", choices=sorted(PHASES) + ["f32:cvt"], default="ring",
                        help="the forward's design (f32:cvt: the split-f32 design with its A "
                        "fragments split by cvt.rna.tf32)")
    parser.add_argument("--stages", type=int, default=3, help="the forward's ring slabs")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="the i/o dtype, and with it the shapes: bf16 CRN's, f32 mel-rnn's "
                        "and Demucs's")
    parser.add_argument("--designs", default="first,ring",
                        help="the backward's variants: first, ring, ring:KCxSTAGES (e.g. 32x3), "
                        "ring[:KCxSTAGES]:nocopy|noproducts|early, f32, f32:cvt")
    parser.add_argument("--csrc", default=str(_build.CSRC),
                        help="the kernel sources to stamp (e.g. an earlier commit's, unpacked "
                        "under _checkout/)")
    args = parser.parse_args()
    global SOURCES
    SOURCES = Path(args.csrc)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    dtype = getattr(torch, args.dtype)
    if args.kernel == "bwd":
        run_bwd(build_bwd(args.designs.split(",")), torch.device("cuda"), dtype)
    else:
        run(build(args.design, args.stages), args.design, torch.device("cuda"), dtype)


if __name__ == "__main__":
    main()
