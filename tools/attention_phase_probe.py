#!/usr/bin/env python3
"""Where the time of the bf16 attention kernels goes, on one GPU.

The kernels are ``mha_fwd`` (row 11 of PERF.md's table,
``kernels/csrc/attention_fwd.cu``) and ``mha_bwd`` (row 12,
``attention_bwd.cu``), both over ``attention.cuh``. This script copies a
kernel source directory, inserts ``clock64`` stamps at fixed places of the
bf16 kernels and compiles the copy into ``kernels/build/probe/attention/``;
the sources themselves are not changed. Thread 0 of every block (so warp
0's view of the per-warp phases) sums each phase's cycles in shared memory
and adds them, with the block's whole span, to device counters once; the
script prints each phase as a share of the summed spans. Beside that: the
event time of an unstamped build at the four shapes of ``chip_smoke.py``'s
``MHA_TIMED`` (both kernels at each), the error of the unstamped result
against the plain version on the first 1,024 sequences (in units of
``chip_smoke.py``'s ``MHA_TOL``), the launch's blocks, threads and shared
bytes, the blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
and the registers and spills ``ptxas -v`` reports.

Phases (a stamp reads the clock when the warp issues it, so a product's
latency shows in the phase that first waits for its result):

* ``before`` (PR 5's design, one block per (b, h)): zero fill, staging (the
  element-wise scatter), barrier, Q Kᵀ products, softmax (the scale, mask,
  max, ``exp2`` and rescale; in the backward also rowsum(g ∘ O) and dS),
  other products (P V; in the backward also dP, dQ, dK, dV), epilogue and
  stores. Pass the directory of that source with ``--csrc`` (``git archive
  fc2556d speech_enhancement_torch/kernels/csrc``) once the kernels have
  moved on.
* ``after`` (the current sources): prefetch and staging (16-byte loads
  realigned into the pitched tiles), barrier, the score products (Q Kᵀ, in
  the backward's passes also g Vᵀ), softmax (the statistics, ``exp2``,
  rescale; the backward's P and dS), the other products (P V; the
  backward's dV, dK and dQ), the epilogue and stores (the output tile into
  shared memory, the barrier, the realigned 16-byte stores; the backward's
  dQ accumulator and its barriers too).

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/attention_phase_probe.py [--design after] [--shapes intra_serve,inter_train]
    python3 tools/attention_phase_probe.py --design before --csrc DIR
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
from speech_enhancement_torch.kernels import attention as attn_k  # noqa: E402

HEADS, DEPTH = 8, 32
# chip_smoke.py's MHA_TIMED: one serving request's and one train step's
# sequences (B' = windows x chunks)
SHAPES = {"intra_serve": (12672, 250), "inter_serve": (48000, 66),
          "intra_train": (264, 250), "inter_train": (1000, 66)}
CHECKED = 1024  # sequences held against the plain version
TOL = (2.0**-9, 2.0**-7, 2.0**-7)  # chip_smoke.py's MHA_TOL for bf16
PHASES = {  # slot names by (design, library)
    ("before", "attention_fwd"): ["zero fill", "staging", "barrier", "Q K^T", "softmax",
                                  "other products", "epilogue and stores"],
    ("after", "attention_fwd"): ["wait", "staging", "barrier", "score products", "softmax",
                                 "other products", "tile ends", "epilogue and stores"],
    ("after", "attention_bwd"): ["-", "staging", "barrier", "score products", "softmax",
                                 "other products", "pass-two barriers", "epilogue and stores"],
}
PHASES["before", "attention_bwd"] = PHASES["before", "attention_fwd"]

PRELUDE = """
// -- phase probe --
__shared__ unsigned long long probe_acc[8];
__device__ unsigned long long g_prof[10];
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_begin() {
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) probe_acc[i] = 0;
}
__device__ __forceinline__ void probe_add(int k, unsigned long long from) {
  if (threadIdx.x == 0) probe_acc[k] += clock64() - from;
}
// phases [0, 8) of this block, its span in cycles and in ns: slots 0-7, 8, 9
__device__ __forceinline__ void probe_end(unsigned long long c0, unsigned long long n0) {
  if (threadIdx.x != 0) return;
  for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], probe_acc[i]);
  atomicAdd(&g_prof[8], clock64() - c0);
  atomicAdd(&g_prof[9], probe_ns() - n0);
}
#define PROBE_T(name) const unsigned long long name = clock64()
"""

ENTRIES = """
extern "C" int probe_zero() {
  static unsigned long long zero[10];
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
}
extern "C" int probe_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));
}
"""

# blocks an SM, threads, shared bytes and blocks of a bf16 launch at depth
# 32 (the kernels' own launch rules)
OCCUPANCY = {
    ("before", "attention_fwd"): """
extern "C" int probe_plan(int batch_heads, int length, int copyable, int* out) {
  out[1] = MMA_THREADS;
  out[2] = static_cast<int>(mma_smem<32>(length));
  out[3] = batch_heads;
  cudaFuncSetAttribute(mha_fwd_mma<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, mha_fwd_mma<32>, out[1], out[2]));
}
""",
    ("before", "attention_bwd"): """
extern "C" int probe_plan(int batch_heads, int length, int copyable, int* out) {
  out[1] = MMA_THREADS;
  out[2] = static_cast<int>(mma_smem<32>(length));
  out[3] = batch_heads;
  cudaFuncSetAttribute(mha_bwd_mma<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, out[2]);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, mha_bwd_mma<32>, out[1], out[2]));
}
""",
    ("after", "attention_fwd"): """
extern "C" int probe_plan(int batch_heads, int length, int copyable, int* out) {
  const attn::Plan p =
      attn::fwd_plan(batch_heads, 32, 32, length, copyable, attn::max_shared_bytes());
  out[1] = p.threads;
  out[2] = p.smem;
  out[3] = p.blocks;
  cudaFuncSetAttribute(mha_fwd_mma<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, mha_fwd_mma<32>, p.threads, p.smem));
}
""",
    ("after", "attention_bwd"): """
extern "C" int probe_plan(int batch_heads, int length, int copyable, int* out) {
  const attn::Plan p = attn::bwd_plan(batch_heads, 32, length);
  out[1] = p.threads;
  out[2] = p.smem;
  out[3] = p.blocks;
  cudaFuncSetAttribute(mha_bwd_mma<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, mha_bwd_mma<32>, p.threads, p.smem));
}
""",
}


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _stamp_before(name: str, text: str) -> str:
    """PR 5's attention.cuh (attend_tile), attention_fwd.cu and
    attention_bwd.cu (the bf16 kernels)."""
    if name == "attention.cuh":
        return _patch(text, [
            ("namespace attn {\n", PRELUDE + "namespace attn {\n"),
            ("  for (int c0 = 0; c0 < lp; c0 += CHUNK) {\n    float s[4][4];\n",
             "  for (int c0 = 0; c0 < lp; c0 += CHUNK) {\n    PROBE_T(p_qk);\n"
             "    float s[4][4];\n"),
            ("    float mx[2] = {-INFINITY, -INFINITY};\n",
             "    probe_add(3, p_qk);\n    PROBE_T(p_sm);\n"
             "    float mx[2] = {-INFINITY, -INFINITY};\n"),
            ("#pragma unroll\n    for (int kk = 0; kk < 2; ++kk) {\n      uint32_t hi[4], lo[4];\n"
             "      a_operand(s, kk, hi, lo);\n",
             "    probe_add(4, p_sm);\n    PROBE_T(p_pv);\n"
             "#pragma unroll\n    for (int kk = 0; kk < 2; ++kk) {\n      uint32_t hi[4], lo[4];\n"
             "      a_operand(s, kk, hi, lo);\n"),
            ("        mma(acc[dt], lo, b0, b1);\n      }\n    }\n  }\n",
             "        mma(acc[dt], lo, b0, b1);\n      }\n    }\n    probe_add(5, p_pv);\n  }\n"),
        ])
    if name == "attention_fwd.cu":
        return _patch(text, [
            ("  attn::zero_shared(smem, mma_smem<DP>(length));\n  __syncthreads();\n",
             "  probe_begin();\n  PROBE_T(p_c0);\n  const unsigned long long p_n0 = probe_ns();\n"
             "  attn::zero_shared(smem, mma_smem<DP>(length));\n  __syncthreads();\n"
             "  probe_add(0, p_c0);\n  PROBE_T(p_st);\n"),
            ("  attn::stage(v + base, depth, length, none, 0, vts, vp);\n  __syncthreads();\n",
             "  attn::stage(v + base, depth, length, none, 0, vts, vp);\n  probe_add(1, p_st);\n"
             "  PROBE_T(p_b);\n  __syncthreads();\n  probe_add(2, p_b);\n"),
            ("    attn::attend_tile<DP>(qa, ks, vts, vp, lp, length, scale, g, t, m, l, acc);\n",
             "    attn::attend_tile<DP>(qa, ks, vts, vp, lp, length, scale, g, t, m, l, acc);\n"
             "    PROBE_T(p_e);\n"),
            ("      ots[(d + 1) * vp + r1] = __float2bfloat16(acc[dt][3] / l[1]);\n    }\n  }\n"
             "  __syncthreads();\n",
             "      ots[(d + 1) * vp + r1] = __float2bfloat16(acc[dt][3] / l[1]);\n    }\n"
             "    probe_add(6, p_e);\n  }\n  PROBE_T(p_f);\n  __syncthreads();\n"),
            ("    for (int e = threadIdx.x; e < n; e += MMA_THREADS) o[base + e] = get(e);\n"
             "    return;\n",
             "    for (int e = threadIdx.x; e < n; e += MMA_THREADS) o[base + e] = get(e);\n"
             "    probe_add(6, p_f);\n    probe_end(p_c0, p_n0);\n    return;\n"),
            ("    o4[i] = raw;\n  }\n}\n",
             "    o4[i] = raw;\n  }\n  probe_add(6, p_f);\n  probe_end(p_c0, p_n0);\n}\n"),
        ])
    if name == "attention_bwd.cu":
        return _patch(text, [
            ("  attn::zero_shared(smem, reinterpret_cast<unsigned char*>(row_max) - smem);\n"
             "  __syncthreads();\n",
             "  probe_begin();\n  PROBE_T(p_c0);\n  const unsigned long long p_n0 = probe_ns();\n"
             "  attn::zero_shared(smem, reinterpret_cast<unsigned char*>(row_max) - smem);\n"
             "  __syncthreads();\n  probe_add(0, p_c0);\n  PROBE_T(p_st);\n"),
            ("  attn::stage(go + base, depth, length, gs, QP, gts, vp);\n  __syncthreads();\n",
             "  attn::stage(go + base, depth, length, gs, QP, gts, vp);\n  probe_add(1, p_st);\n"
             "  PROBE_T(p_b);\n  __syncthreads();\n  probe_add(2, p_b);\n"),
            ("    const float m0 = m[0], m1 = m[1], l0 = l[0], l1 = l[1];\n",
             "    PROBE_T(p_dot);\n    const float m0 = m[0], m1 = m[1], l0 = l[0], l1 = l[1];\n"),
            ("    float dqa[DT][4];  // pass B: dQ = dS K\n",
             "    probe_add(4, p_dot);\n    float dqa[DT][4];  // pass B: dQ = dS K\n"),
            ("    for (int c0 = 0; c0 < lp; c0 += CHUNK) {\n      float s[4][4], dp[4][4];\n",
             "    for (int c0 = 0; c0 < lp; c0 += CHUNK) {\n      PROBE_T(p_q);\n"
             "      float s[4][4], dp[4][4];\n"),
            ("#pragma unroll\n      for (int nt = 0; nt < 4; ++nt) {\n#pragma unroll\n"
             "        for (int i = 0; i < 4; ++i) {\n          const bool valid",
             "      probe_add(3, p_q);\n      PROBE_T(p_s);\n"
             "#pragma unroll\n      for (int nt = 0; nt < 4; ++nt) {\n#pragma unroll\n"
             "        for (int i = 0; i < 4; ++i) {\n          const bool valid"),
            ("#pragma unroll\n      for (int kk = 0; kk < 2; ++kk) {\n"
             "        uint32_t hi[4], lo[4];\n        attn::a_operand(s, kk, hi, lo);\n",
             "      probe_add(4, p_s);\n      PROBE_T(p_o);\n"
             "#pragma unroll\n      for (int kk = 0; kk < 2; ++kk) {\n"
             "        uint32_t hi[4], lo[4];\n        attn::a_operand(s, kk, hi, lo);\n"),
            ("          attn::mma(dqa[dt], lo, b0, b1);\n        }\n      }\n    }\n",
             "          attn::mma(dqa[dt], lo, b0, b1);\n        }\n      }\n"
             "      probe_add(5, p_o);\n    }\n"),
            ("#pragma unroll\n    for (int dt = 0; dt < DT; ++dt)\n"
             "      store_frag(dq + base, dqa[dt], qt * 16 + g, dt * 8 + 2 * t, depth, length, "
             "scale);\n  }\n  __syncthreads();\n",
             "    PROBE_T(p_e);\n#pragma unroll\n    for (int dt = 0; dt < DT; ++dt)\n"
             "      store_frag(dq + base, dqa[dt], qt * 16 + g, dt * 8 + 2 * t, depth, length, "
             "scale);\n    probe_add(6, p_e);\n  }\n  PROBE_T(p_b2);\n  __syncthreads();\n"
             "  probe_add(2, p_b2);\n"),
            ("    for (int c0 = 0; c0 < lp; c0 += CHUNK) {\n      float pt[4][4], dst[4][4];",
             "    for (int c0 = 0; c0 < lp; c0 += CHUNK) {\n      PROBE_T(p_q2);\n"
             "      float pt[4][4], dst[4][4];"),
            ("#pragma unroll\n      for (int kk = 0; kk < 2; ++kk) {\n"
             "        uint32_t phi[4], plo[4], shi[4], slo[4];\n",
             "      probe_add(3, p_q2);\n      PROBE_T(p_o2);\n"
             "#pragma unroll\n      for (int kk = 0; kk < 2; ++kk) {\n"
             "        uint32_t phi[4], plo[4], shi[4], slo[4];\n"),
            ("          attn::mma(dka[dt], slo, q0, q1);\n        }\n      }\n    }\n",
             "          attn::mma(dka[dt], slo, q0, q1);\n        }\n      }\n"
             "      probe_add(5, p_o2);\n    }\n    PROBE_T(p_e2);\n"),
            ("      store_frag(dv + base, dva[dt], kt * 16 + g, dt * 8 + 2 * t, depth, length, "
             "1.f);\n    }\n  }\n}\n",
             "      store_frag(dv + base, dva[dt], kt * 16 + g, dt * 8 + 2 * t, depth, length, "
             "1.f);\n    }\n    probe_add(6, p_e2);\n  }\n  probe_end(p_c0, p_n0);\n}\n"),
        ])
    return text


def _stamp_after(name: str, text: str) -> str:
    """The current sources: every stamp sits at a `// -- name --` marker
    of the bf16 kernels."""
    if name == "attention.cuh":
        return _patch(text, [
            ("namespace attn {\n", PRELUDE + "namespace attn {\n"),
            ("  // -- scores --\n", "  PROBE_T(p_sc);\n"),
            ("  // -- softmax --\n", "  probe_add(3, p_sc);\n  PROBE_T(p_sm);\n"),
            ("  // -- products --\n", "  probe_add(4, p_sm);\n  PROBE_T(p_pv);\n"),
            ("  // -- end of step --\n", "  probe_add(5, p_pv);\n"),
            ("  // -- tile --\n", "  PROBE_T(p_t0);\n"),
            ("  // -- steps --\n", "  probe_add(6, p_t0);\n"),
            ("  // -- steps done --\n", "  PROBE_T(p_t1);\n"),
            ("  // -- tile done --\n", "  probe_add(6, p_t1);\n"),
        ])
    if name in ("attention_fwd.cu", "attention_bwd.cu"):
        pairs = []
        if name == "attention_bwd.cu":  # the passes' phases, at their own markers
            pairs = [
                ("  // -- p1 scores --\n", "  PROBE_T(p_sc);\n"),
                ("  // -- p1 softmax --\n", "  probe_add(3, p_sc);\n  PROBE_T(p_sm);\n"),
                ("  // -- p1 end --\n", "  probe_add(4, p_sm);\n"),
                ("  // -- p2 scores --\n", "  PROBE_T(p_sc);\n"),
                ("  // -- p2 softmax --\n", "  probe_add(3, p_sc);\n  PROBE_T(p_sm);\n"),
                ("  // -- p2 products --\n", "  probe_add(4, p_sm);\n  PROBE_T(p_pv);\n"),
                ("  // -- p2 end --\n", "  probe_add(5, p_pv);\n"),
                ("        // -- p2 barrier --\n", "        PROBE_T(p_b2);\n"),
                ("        // -- p2 barrier done --\n", "        probe_add(6, p_b2);\n"),
            ]
        return _patch(text, pairs + [
            ("  // -- begin --\n",
             "  probe_begin();\n  PROBE_T(p_c0);\n  const unsigned long long p_n0 = probe_ns();\n"),
            ("    // -- stage --\n", "    PROBE_T(p_st);\n"),
            ("    // -- landed --\n", "    probe_add(0, p_st);\n    PROBE_T(p_rl);\n"),
            ("    // -- staged --\n", "    probe_add(1, p_rl);\n    PROBE_T(p_b);\n"),
            ("    // -- tiles --\n", "    probe_add(2, p_b);\n"),
            ("    // -- epilogue --\n", "    PROBE_T(p_e);\n"),
            ("    // -- stored --\n", "    probe_add(7, p_e);\n"),
            ("  // -- end --\n", "  probe_end(p_c0, p_n0);\n"),
        ])
    return text


LIBS = ("attention_fwd", "attention_bwd")
VARIANTS = {  # (file, old text, new text)
    "none": [],
    # after, forward: every head block staged from global memory (no bulk copies)
    "no-copy": [("attention_fwd.cu", "  const bool copyable = (depth * length) % 8 == 0 &&",
                 "  const bool copyable = false && (depth * length) % 8 == 0 &&")],
    # after, forward: one query tile a warp at a time
    "single": [("attention.cuh", "  p.pair = dp <= 32 &&", "  p.pair = false && dp <= 32 &&")],
}


def build(csrc: Path, design: str, stamped: bool, names=LIBS, variant: str = "none"):
    """Stamped (or bare) copies of the attention libraries ``names``."""
    tag = f"{design}-{variant}-{'stamped' if stamped else 'bare'}"
    out = _build.BUILD / "probe" / "attention" / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    stamp = _stamp_before if design == "before" else _stamp_after
    for src in list(csrc.glob("*.cuh")) + [csrc / f"{name}.cu" for name in names]:
        text = src.read_text()
        text = _patch(text, [(a, b) for f, a, b in VARIANTS[variant] if f == src.name])
        if stamped:
            text = stamp(src.name, text)
        if src.suffix == ".cu":
            text += OCCUPANCY[design, src.stem] + (ENTRIES if stamped else "")
        (out / src.name).write_text(text)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(out / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in names}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        if not stamped:
            for line in log.splitlines():
                if any(key in line for key in ("registers", "spill", "Function properties")):
                    print(f"ptxas {tag} {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = getattr(lib, name.replace("attention", "mha"))
        fn.argtypes = attn_k._ENTRIES[name.replace("attention", "mha")][1]
        fn.restype = ctypes.c_int
        lib.probe_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.probe_plan.restype = ctypes.c_int
        if stamped:  # a pointer passed without argtypes would be cut to a C int
            lib.probe_zero.argtypes, lib.probe_zero.restype = [], ctypes.c_int
            lib.probe_read.argtypes, lib.probe_read.restype = [ctypes.c_void_p], ctypes.c_int
        libs[name] = (lib, fn)
    return libs


def _error(got, want) -> float:
    """Largest |got - want| in units of the forward bound atol + rtol |want|
    (the output) or of grad_tol times the largest |want| (a gradient)."""
    atol, rtol, grad_tol = TOL
    if len(got) == 1:
        g, w = got[0].float(), want.float()
        return ((g - w).abs() / (atol + rtol * w.abs())).max().item()
    return max(((g.float() - w.float()).abs().max() / (grad_tol * w.float().abs().max())).item()
               for g, w in zip(got, want))


def run(libs, design, variant, stamped, dev, shapes, reps):
    gen = torch.Generator(device=dev).manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / DEPTH ** 0.5
    for tag in shapes:
        batch, length = SHAPES[tag]
        q, k, v, g = (torch.randn(batch, HEADS * DEPTH, length, generator=gen,
                                  device=dev).to(torch.bfloat16) for _ in range(4))
        for name, (lib, fn) in libs.items():
            bwd = name == "attention_bwd"
            outs = [torch.empty_like(q) for _ in range(3 if bwd else 1)]
            ins = [q, k, v, g] if bwd else [q, k, v]
            args = [1, *(t.data_ptr() for t in ins + outs), batch * HEADS, DEPTH, length, scale,
                    stream]
            if stamped:
                torch.cuda.synchronize()
                _build.check(lib, lib.probe_zero(), "probe_zero")
                _build.check(lib, fn(*args), f"{name} launch")
                torch.cuda.synchronize()
                prof = (ctypes.c_ulonglong * 10)()
                _build.check(lib, lib.probe_read(prof), "probe_read")
                span, ns = prof[8], prof[9]
                shares = ", ".join(f"{p} {100 * prof[i] / span:.1f}%"
                                   for i, p in enumerate(PHASES[design, name]) if p != "-")
                print(f"{design} {variant} stamped {name} {tag} (B' {batch}, L {length}): "
                      f"{shares} (SM clock {span / ns:.3f} GHz)", flush=True)
                continue
            for _ in range(2):
                _build.check(lib, fn(*args), f"{name} launch")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
            n = min(batch, CHECKED)
            cut = [t[:n] for t in ins]
            want = (attn_k.mha_bwd_plain(*cut, HEADS) if bwd else
                    attn_k.fused_mha_packed_plain(*cut, HEADS))
            err = _error([t[:n] for t in outs], want)
            plan = (ctypes.c_int * 4)()
            _build.check(lib, lib.probe_plan(batch * HEADS, length, int(variant != "no-copy"),
                                             plan), "probe_plan")
            print(f"{design} {variant} bare {name} {tag} (B' {batch}, H {HEADS}, L {length}, "
                  f"D {DEPTH} bf16): {ms:.3f} ms; error {err:.3f} of the bound; {plan[3]} "
                  f"blocks of {plan[1]} threads, {plan[2]} shared bytes, {plan[0]} blocks an SM",
                  flush=True)
            del outs, want
        del q, k, v, g


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--design", choices=("before", "after"), default="after")
    parser.add_argument("--csrc", type=Path, default=_build.CSRC,
                        help="kernel source directory (PR 5's for --design before)")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="of " + ", ".join(SHAPES))
    parser.add_argument("--reps", type=int, default=10, help="timed launches a shape")
    parser.add_argument("--kernels", default="fwd,bwd", help="fwd (mha_fwd), bwd (mha_bwd)")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="none",
                        help="after: build the sources with this change")
    parser.add_argument("--bare", action="store_true", help="skip the stamped build")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    shapes = args.shapes.split(",")
    names = [f"attention_{kind}" for kind in args.kernels.split(",")]
    dev = torch.device("cuda")
    for stamped in (False,) if args.bare else (False, True):
        run(build(args.csrc.resolve(), args.design, stamped, names, args.variant), args.design,
            args.variant, stamped, dev, shapes, args.reps)


if __name__ == "__main__":
    main()
