#!/usr/bin/env python3
"""Where the time of the bf16 LSTM kernels goes, on one GPU.

Builds an instrumented copy of ``speech_enhancement_torch/kernels/csrc/
lstm_fwd.cu`` or ``lstm_bwd.cu`` (and of ``lstm.cuh``): this script inserts
``clock64`` stamps at fixed places of the sources and compiles the copy into
``kernels/build/probe/``; the package's sources are not changed. Thread 0 of
every block adds each phase's cycles to a device array, and the script
prints the mean over blocks in microseconds a step (cycles converted by the
launch's own ``%globaltimer`` span), beside the kernel's event time and its
largest error against the plain version.

The forward (``--kernel fwd``), two designs, both still in the source:

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

The backward (``--kernel bwd``) at CRN's train shape (T 501, B 16, H
1792), every design of ``--designs`` in one call:

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
  warp's f32 partials and the block barrier) and sum (the owners' sums).
Each design is also timed without stamps (``bare``) in the same call.

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/lstm_fwd_phase_probe.py [--design ring|chunked] [--stages 3]
    python3 tools/lstm_fwd_phase_probe.py --kernel bwd [--designs first,ring,ring:32x3]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from speech_enhancement_torch.kernels import _build  # noqa: E402
from speech_enhancement_torch.kernels import lstm as lstm_k  # noqa: E402

SHAPES = [("crn serve", 501, 192, 1792), ("crn train", 501, 16, 1792),
          ("rnn-stft-mask serve", 501, 384, 896)]
PHASES = {"ring": ["wait", "issue", "products", "other", "fill", "barrier"],
          "chunked": ["stage", "products", "out-store", "epilogue", "barrier"]}

SLOTS = 16  # phases a block; the last two hold the launch's cycles and ns
BWD_PHASES = {"first": ["staging", "products", "partials", "dh store", "pointwise", "stores",
                        "barrier"],
              "ring": ["wait", "issue", "products", "fill", "partials", "sum", "pointwise",
                       "stores", "barrier", "prefetch", "other"]}
BWD_SHAPE = ("crn train", 501, 16, 1792)

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


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def instrumented_sources(design: str, stages: int):
    """(lstm.cuh, lstm_fwd.cu) with the stamps of ``design``."""
    cuh = (_build.CSRC / "lstm.cuh").read_text()
    cu = (_build.CSRC / "lstm_fwd.cu").read_text()
    cuh = _patch(cuh, [("namespace lstm {\n", "namespace lstm {\n" + PRELUDE)])
    cu = _patch(cu, [("constexpr int STAGES = 3;", f"constexpr int STAGES = {stages};")])
    cu += ENTRIES
    if design == "ring":
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
        ])
    else:
        cu = _patch(cu, [
            ("  if (sizeof(T) == 2 && a.vec && reinterpret_cast<uintptr_t>(a.wt) % 16 == 0) {",
             "  if (false) {"),
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
        ])
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
    ("  if (design == 1) return ring::launch(a, rp, blocks, stream);",
     "  if (design == 1 && false) return ring::launch(a, rp, blocks, stream);"),
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


def bwd_sources(variant: str, stamps: bool):
    """(lstm.cuh, lstm_bwd.cu) of a backward variant, with or without the
    stamps: ``first``, or ``ring`` with optional parts ``:KCxSTAGES`` (the
    round's k and the ring's depth forced) and ``:nocopy``, ``:noproducts``
    or ``:early`` (BWD_RING_FLAGS, unstamped only)."""
    cuh = (_build.CSRC / "lstm.cuh").read_text()
    cu = (_build.CSRC / "lstm_bwd.cu").read_text()
    cuh = _patch(cuh, [("namespace lstm {\n", "namespace lstm {\n" + PRELUDE)])
    cu += ENTRIES
    design, *parts = variant.split(":")
    for part in parts:
        if part in BWD_RING_FLAGS:
            cu = _patch(cu, BWD_RING_FLAGS[part])
            continue
        kc, stages = part.split("x")
        cu = _patch(cu, [
            ("constexpr int KCS[] = {64, 32, 16};", f"constexpr int KCS[] = {{{kc}}};"),
            ("constexpr int MIN_STAGES = 3;", f"constexpr int MIN_STAGES = {min(3, int(stages))};"),
            ("constexpr int MAX_STAGES = 8;", f"constexpr int MAX_STAGES = {stages};")])
    if design == "first":
        cu = _patch(cu, BWD_FIRST_STAMPS if stamps else BWD_FIRST_STAMPS[:1])
        if stamps:
            cuh = _patch(cuh, CHUNK_STAMPS)
    elif stamps:
        cu = _patch(cu, BWD_RING_STAMPS)
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
            for header in _build.CSRC.glob("*.cuh"):
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


def run_bwd(libs: dict, dev: torch.device) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    tag, steps, batch, hidden = BWD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    x_proj = torch.randn(steps, batch, 4 * hidden, device=dev, generator=gen).to(bf16)
    w_hh = (torch.randn(hidden, 4 * hidden, device=dev, generator=gen) / hidden**0.5).to(bf16)
    h0 = torch.zeros(batch, hidden, device=dev, dtype=bf16)
    _, c_seq, gates = lstm_k.fused_lstm_plain(x_proj, w_hh, h0, h0)
    c_prev = lstm_k.shift_prev(c_seq, h0, False)
    dout = torch.randn(steps, batch, hidden, device=dev, generator=gen).to(bf16)
    d_last = torch.randn(batch, hidden, device=dev, generator=gen)
    zero = torch.zeros(batch, hidden, device=dev)
    want = lstm_k.lstm_bwd_plain(gates, c_seq, c_prev, dout, w_hh, zero, d_last)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = -(-hidden // -(-hidden // sms))
    for (variant, stamps), lib in libs.items():
        lib.lstm_bwd.argtypes = [i] + [p] * 9 + [i] * 4 + [p]
        lib.lstm_bwd_plan.argtypes = [i] * 4 + [p]
        lib.probe_read.argtypes = [p]
        plan = (ctypes.c_int * 17)()
        _build.check(lib, lib.lstm_bwd_plan(1, hidden, batch, 1, ctypes.addressof(plan)),
                     "lstm_bwd_plan")
        for _ in range(2):  # the second launch is the one read
            dh, dc = zero.clone(), d_last.clone()
            dgates = torch.empty_like(gates)
            bar = torch.zeros(2, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            _build.check(lib, lib.probe_zero(), "probe_zero")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            code = lib.lstm_bwd(1, gates.data_ptr(), c_seq.data_ptr(), c_prev.data_ptr(),
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
                f"{plan[16]} bytes)" if design == "ring" else "")
        head = (f"bwd {variant}{'' if stamps else ' bare'} T {steps} B {batch} H {hidden} ({tag}), "
                f"{design}{ring}: {ms:.3f} ms, {ms * 1e3 / steps:.2f} us a step, dgates, dh0, dc0 "
                f"within {[f'{r:.2e}' for r in rel]} of their largest")
        if not stamps:
            print(head, flush=True)
            continue
        prof = (ctypes.c_ulonglong * (SLOTS * 1024))()
        _build.check(lib, lib.probe_read(ctypes.addressof(prof)), "probe_read")
        rows = torch.tensor(list(prof), dtype=torch.float64).view(-1, SLOTS)[:blocks]
        ns_per_cycle = (rows[:, 15] / rows[:, 14]).mean().item()
        us = rows.mean(0) * ns_per_cycle / 1e3 / steps
        split = ", ".join(f"{n} {us[k].item():.2f}"
                          for k, n in enumerate(BWD_PHASES[variant.split(':')[0]]))
        print(f"{head}; us a step, mean over {blocks} blocks: {split}, total "
              f"{us[14].item():.2f} (SM clock {1 / ns_per_cycle:.3f} GHz)", flush=True)


def build(design: str, stages: int) -> ctypes.CDLL:
    out = _build.BUILD / "probe" / f"{design}-{stages}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cuh, cu = instrumented_sources(design, stages)
    for header in _build.CSRC.glob("*.cuh"):
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


def run(lib: ctypes.CDLL, design: str, dev: torch.device) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fwd.argtypes = [i] + [p] * 8 + [i] * 4 + [p]
    lib.probe_read.argtypes = [p]
    names = PHASES[design]
    for tag, steps, batch, hidden in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(5)
        bf16 = torch.bfloat16
        x_proj = torch.randn(steps, batch, 4 * hidden, device=dev, generator=gen).to(bf16)
        w_hh = (torch.randn(hidden, 4 * hidden, device=dev, generator=gen) / hidden**0.5).to(bf16)
        h0 = torch.zeros(batch, hidden, device=dev, dtype=bf16)
        c0 = torch.zeros_like(h0)
        want = lstm_k.fused_lstm_plain(x_proj, w_hh, h0, c0)
        w_t = w_hh.t().contiguous()
        for _ in range(2):  # the second launch is the one read
            c = torch.zeros(batch, hidden, device=dev)
            h_seq = torch.empty(steps, batch, hidden, device=dev, dtype=bf16)
            c_seq, gates = torch.empty_like(h_seq), torch.empty_like(x_proj)
            bar = torch.zeros(2, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            _build.check(lib, lib.probe_zero(), "probe_zero")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            code = lib.lstm_fwd(1, x_proj.data_ptr(), w_t.data_ptr(), h0.data_ptr(),
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
        split = ", ".join(f"{n} {us[k].item():.2f}" for k, n in enumerate(names))
        print(f"{design} T {steps} B {batch} H {hidden} ({tag}): {ms:.3f} ms, "
              f"{ms * 1e3 / steps:.2f} us a step, max abs err vs plain {err:.3e}; "
              f"us a step, mean over {blocks} blocks: {split}, total {us[14].item():.2f} "
              f"(SM clock {1 / ns_per_cycle:.3f} GHz)", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    parser.add_argument("--design", choices=sorted(PHASES), default="ring",
                        help="the forward's design")
    parser.add_argument("--stages", type=int, default=3, help="the forward's ring slabs")
    parser.add_argument("--designs", default="first,ring",
                        help="the backward's variants: first, ring, ring:KCxSTAGES (e.g. 32x3), "
                        "ring[:KCxSTAGES]:nocopy|noproducts|early")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    if args.kernel == "bwd":
        run_bwd(build_bwd(args.designs.split(",")), torch.device("cuda"))
    else:
        run(build(args.design, args.stages), args.design, torch.device("cuda"))


if __name__ == "__main__":
    main()
