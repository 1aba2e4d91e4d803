#!/usr/bin/env python3
"""Where the time of the bf16 LSTM forward kernel goes, on one GPU.

Builds an instrumented copy of ``speech_enhancement_torch/kernels/csrc/
lstm_fwd.cu`` (and of ``lstm.cuh``): this script inserts ``clock64`` stamps
at fixed places of the sources and compiles the copy into ``kernels/build/
probe/``; the package's sources are not changed. Thread 0 of every block
adds each phase's cycles to a device array, and the script prints the mean
over blocks in microseconds a step (cycles converted by the launch's own
``%globaltimer`` span), beside the kernel's event time and its largest
error against ``fused_lstm_plain``.

Two designs, both still in the source:

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

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/lstm_fwd_phase_probe.py [--design ring|chunked] [--stages 3]
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

PRELUDE = """
__device__ unsigned long long g_prof[8 * 1024];
__device__ __forceinline__ void probe_add(int k, unsigned long long v) {
  if (threadIdx.x == 0) atomicAdd(&g_prof[blockIdx.x * 8 + k], v);
}
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""

ENTRIES = """
extern "C" int probe_zero() {
  static unsigned long long zero[8 * 1024];
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
             "  lstm::probe_add(6, clock64() - pstart);\n"
             "  lstm::probe_add(7, lstm::probe_ns() - nstart);\n"),
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
             "  probe_add(6, clock64() - pstart);\n  probe_add(7, probe_ns() - nstart);\n}"),
        ])
        cuh = _patch(cuh, [
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
        ])
    return cuh, cu


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
        prof = (ctypes.c_ulonglong * (8 * 1024))()
        _build.check(lib, lib.probe_read(ctypes.addressof(prof)), "probe_read")
        blocks = -(-hidden // -(-hidden // torch.cuda.get_device_properties(dev)
                                .multi_processor_count))
        rows = torch.tensor(list(prof), dtype=torch.float64).view(-1, 8)[:blocks]
        ns_per_cycle = (rows[:, 7] / rows[:, 6]).mean().item()
        us = rows.mean(0) * ns_per_cycle / 1e3 / steps
        ms = start.elapsed_time(end)
        split = ", ".join(f"{n} {us[k].item():.2f}" for k, n in enumerate(names))
        print(f"{design} T {steps} B {batch} H {hidden} ({tag}): {ms:.3f} ms, "
              f"{ms * 1e3 / steps:.2f} us a step, max abs err vs plain {err:.3e}; "
              f"us a step, mean over {blocks} blocks: {split}, total {us[6].item():.2f} "
              f"(SM clock {1 / ns_per_cycle:.3f} GHz)", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--design", choices=sorted(PHASES), default="ring")
    parser.add_argument("--stages", type=int, default=3, help="ring slabs (ring design)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    run(build(args.design, args.stages), args.design, torch.device("cuda"))


if __name__ == "__main__":
    main()
