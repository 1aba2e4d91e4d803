#!/usr/bin/env python3
"""Where the time of the bf16 weight-gradient kernels goes, on one GPU.

The kernels are ``dw_gemm.cuh``'s, behind ``enc_bwd_dw`` (``conv_block_bwd.cu``)
and ``dec_bwd_dw`` (``deconv_block_bwd.cu``). This script copies a kernel
source directory, inserts ``clock64`` stamps at fixed places of
``dw_gemm.cuh`` and compiles the copy into ``kernels/build/probe/``; the
sources themselves are not changed. Thread 0 of every block sums each
phase's cycles over its steps and adds them to a device array once; the
script prints the mean over blocks as shares of the block's stamped span,
beside the event time of the stamped and of an unstamped build of the same
source, and the error of the stamped result against the plain version.
It also reckons the bytes the launch stages (each block's operand tiles
summed over its steps) against the bytes of its inputs read once.

Designs:

* ``before``: the per-tap kernel with scalar staging (the source before
  the taps moved into the GEMM's rows; pass its directory with ``--csrc``):
  stage g (its loads and shared stores, one loop), stage z (both time
  taps), barrier 1, products (fragment loads and mma.sync), barrier 2.
  ``--loads-first`` rewrites both staging loops to issue every load into
  registers before the first shared store (phases: loads issued, stores,
  which wait on the loads).
* ``after``: the current kernel. On interior steps: issue (the next
  step's 16-byte loads), then products and realign (ldmatrix and mma.sync
  on the current stage, with the loaded rows shifted into place and stored
  to the other stage between the k16 steps); edge steps (the first and last
  frame chunks: the same work in series, with masks), whole; barrier.

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/dw_phase_probe.py [--design after]
    python3 tools/dw_phase_probe.py --design before --csrc DIR [--loads-first]
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

B, T = 128, 643
# (name, f_in, input widths, c2out): blocks of configs/dccrn_vbd.yaml
SHAPES = [("dec0", 4, (256, 256), 256), ("enc4", 16, (128,), 256), ("dec4", 64, (32, 32), 16),
          ("dec5", 128, (16, 16), 2), ("enc0", 256, (2,), 16), ("enc1", 128, (16,), 32),
          ("enc2", 64, (32,), 64), ("enc3", 32, (64,), 128), ("enc5", 8, (256,), 256),
          ("dec1", 8, (256, 256), 128), ("dec2", 16, (128, 128), 64), ("dec3", 32, (64, 64), 32)]
DEFAULT_SHAPES = "dec0,enc4,dec4,dec5,enc0"
PHASES = {"before": ["stage g", "stage z", "barrier 1", "products", "barrier 2"],
          "before-loads-first": ["loads issued", "stores", "barrier 1", "products",
                                 "barrier 2"],
          "after": ["issue", "products and realign", "edge steps", "barrier"]}
SLOTS = 8 * 8192

PRELUDE = f"""
__device__ unsigned long long g_prof[{SLOTS}];
__device__ __forceinline__ unsigned long long probe_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
__device__ __forceinline__ void probe_flush(const unsigned long long* acc, int n,
                                            unsigned long long cycles,
                                            unsigned long long ns) {{
  if (threadIdx.x != 0) return;
  const unsigned bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (bid >= {SLOTS // 8}) return;
  for (int i = 0; i < n; ++i) g_prof[bid * 8 + i] += acc[i];
  g_prof[bid * 8 + 6] += cycles;
  g_prof[bid * 8 + 7] += ns;
}}
"""

ENTRIES = f"""
extern "C" int probe_zero() {{
  static unsigned long long zero[{SLOTS}];
  return static_cast<int>(cudaMemcpyToSymbol(dwgemm::g_prof, zero, sizeof(zero)));
}}
extern "C" int probe_read(void* host) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, dwgemm::g_prof, sizeof(dwgemm::g_prof)));
}}
"""

LOADS_FIRST = """
    constexpr int GN = (BN * BK + THREADS - 1) / THREADS;
    constexpr int ZN = (2 * BM * BK + THREADS - 1) / THREADS;
    T gv[GN], zv[ZN];
    const T* grow = gsrc + (static_cast<long long>(b) * p.f_out + fo) * p.c2out * p.n_time;
    const T* zrow = zsrc + (static_cast<long long>(b) * p.f_in + fi) * rg.c2 * p.n_time;
#pragma unroll
    for (int e = 0; e < GN; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      const int n = idx / BK, k = idx - n * BK, co = co0 + n, t = t0 + k;
      gv[e] = idx < BN * BK && co < p.c2out && t < p.n_time
                  ? grow[static_cast<long long>(co) * p.n_time + t] : zero<T>();
    }
#pragma unroll
    for (int e = 0; e < ZN; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      const int jt = idx / (BM * BK), r = idx - jt * BM * BK, m = r / BK, k = r - m * BK;
      const int ci = ci0 + m, t = t0 + k + (kDecoder ? jt : jt - 1);
      zv[e] = idx < 2 * BM * BK && ci < rg.c2 && t >= 0 && t < p.n_time
                  ? zrow[static_cast<long long>(ci) * p.n_time + t] : zero<T>();
    }
    const unsigned long long s1 = clock64();
    pacc[0] += s1 - s0;
#pragma unroll
    for (int e = 0; e < GN; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      if (idx < BN * BK) sm.g[idx / BK][idx % BK] = gv[e];
    }
#pragma unroll
    for (int e = 0; e < ZN; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      if (idx < 2 * BM * BK) {
        const int jt = idx / (BM * BK), r = idx - jt * BM * BK;
        sm.z[jt][r / BK][r % BK] = zv[e];
      }
    }
"""


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _before(cuh: str, loads_first: bool) -> str:
    cuh = _patch(cuh, [
        ("  for (long long step = first; step < last; ++step) {\n",
         "  unsigned long long pacc[5] = {0, 0, 0, 0, 0};\n"
         "  const unsigned long long pstart = clock64(), nstart = probe_ns();\n"
         "  for (long long step = first; step < last; ++step) {\n"),
        ("    if (fi < 0) continue;  // the same for every thread of the block\n",
         "    if (fi < 0) continue;  // the same for every thread of the block\n"
         "    const unsigned long long s0 = clock64();\n"),
        ("    __syncthreads();\n    if constexpr (kMma) {\n",
         "    const unsigned long long s2 = clock64();\n    pacc[1] += s2 - s1;\n"
         "    __syncthreads();\n"
         "    const unsigned long long s3 = clock64();\n    pacc[2] += s3 - s2;\n"
         "    if constexpr (kMma) {\n"),
        ("    __syncthreads();\n  }\n\n  float* out",
         "    const unsigned long long s4 = clock64();\n    pacc[3] += s4 - s3;\n"
         "    __syncthreads();\n    pacc[4] += clock64() - s4;\n  }\n"
         "  probe_flush(pacc, 5, clock64() - pstart, probe_ns() - nstart);\n\n  float* out"),
    ])
    start = cuh.index("    const T* grow = gsrc")
    end = cuh.index("    const unsigned long long s2 = clock64();")
    if loads_first:
        return cuh[:start] + LOADS_FIRST + cuh[end:]
    body = cuh[start:end]
    split = body.index("    const T* zrow = zsrc")
    body = (body[:split] + "    const unsigned long long s1 = clock64();\n"
            "    pacc[0] += s1 - s0;\n" + body[split:])
    return cuh[:start] + body + cuh[end:]


VARIANTS = {
    "none": [],
    # staging and fragment loads alone: no mma.sync
    "no-products": [("      for (int j = 0; j < C::NT; ++j) mma_bf16(",
                     "      for (int j = 0; j < C::NT * 0; ++j) mma_bf16(")],
    # products and realignment alone: no global loads (zeros staged)
    "no-loads": [("    return ld_pred(aligned_chunk(src) + k, ok & want);",
                  "    return ld_pred(aligned_chunk(src) + k, ok & want & (p.batch < 0));")],
    # loads through L2 only (the load helper lives in mma_util.cuh)
    "cg": [],
    # twice the warps on the 128 x 128 and 64 x 64 tiles (warp tiles 32 x 32, 32 x 16)
    "more-warps": [("launch_mma<Cfg<128, 128, 2, 4, 1>", "launch_mma<Cfg<128, 128, 4, 4, 1>"),
                   ("launch_mma<Cfg<64, 64, 2, 2, 1>", "launch_mma<Cfg<64, 64, 2, 4, 1>")],
}


def _after(cuh: str) -> str:
    return _patch(cuh, [
        ("  Step cur;\n",
         "  unsigned long long pacc[4] = {0, 0, 0, 0};\n"
         "  const unsigned long long pstart = clock64(), nstart = probe_ns();\n"
         "  unsigned long long s0 = pstart;\n  Step cur;\n"),
        ("      issue(nxt, false);\n",
         "      issue(nxt, false);\n"
         "      const unsigned long long s1 = clock64();\n      pacc[0] += s1 - s0;\n"),
        ("            store_round(r, nxt, stage ^ 1, false);\n      });\n",
         "            store_round(r, nxt, stage ^ 1, false);\n      });\n"
         "      pacc[1] += clock64() - s1;\n"),
        ("      if (more) store(nxt, stage ^ 1, !interior(nxt));\n",
         "      if (more) store(nxt, stage ^ 1, !interior(nxt));\n"
         "      pacc[2] += clock64() - s0;\n"),
        ("    __syncthreads();\n    stage ^= 1;\n",
         "    const unsigned long long s3 = clock64();\n"
         "    __syncthreads();\n    s0 = clock64();\n    pacc[3] += s0 - s3;\n    stage ^= 1;\n"),
        ("  if constexpr (C::WARPS_K > 1) {  // sum",
         "  probe_flush(pacc, 4, clock64() - pstart, probe_ns() - nstart);\n"
         "  if constexpr (C::WARPS_K > 1) {  // sum"),
    ])


def build(csrc: Path, design: str, stamped: bool, variant: str = "none") -> ctypes.CDLL:
    tag = f"{design}-{variant}-{'stamped' if stamped else 'bare'}"
    out = _build.BUILD / "probe" / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in list(csrc.glob("*.cuh")) + list(csrc.glob("*_bwd.cu")):
        shutil.copy(src, out / src.name)
    cuh = (csrc / "dw_gemm.cuh").read_text()
    cuh = _patch(cuh, VARIANTS[variant])
    if variant == "cg":
        util = (csrc / "mma_util.cuh").read_text()
        (out / "mma_util.cuh").write_text(
            _patch(util, [(" @p ld.global.nc.v4.u32", " @p ld.global.cg.v4.u32")]))
    if stamped:
        cuh = _patch(cuh, [("namespace dwgemm {\n", "namespace dwgemm {\n" + PRELUDE)])
        cuh = _after(cuh) if design == "after" else _before(cuh, design.endswith("first"))
    (out / "dw_gemm.cuh").write_text(cuh)
    libs = {}
    procs = {}
    for name in ("conv_block_bwd", "deconv_block_bwd"):
        src = out / f"{name}.cu"
        if stamped:
            src.write_text(src.read_text() + ENTRIES)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        if stamped:
            for line in log.splitlines():
                if "dw_kernel" in line or ("registers" in line and "dw" in line):
                    print(f"ptxas {tag} {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def old_rules(name, f_in, widths, c2out):
    """dw_tile / dw_splits as the per-tap kernel took them (bf16)."""
    bm, bn = (16 if c <= 16 else 32 if c <= 32 else 64 for c in (max(widths), c2out))
    f_out = 2 * f_in if name.startswith("dec") else f_in // 2
    tiles = sum(-(-c2 // bm) for c2 in widths) * -(-c2out // bn)
    steps = B * f_out * -(-T // 64)
    cap = max(1, (1 << 28) // (10 * sum(widths) * c2out * 4))
    return bm, bn, max(1, min(-(-2048 // (5 * tiles)), steps, cap, 65535))


def new_rules(name, f_in, widths, c2out, tile=None):
    dec = name.startswith("dec")
    bm, bn = tile or cb.dw_tile(widths, c2out, torch.bfloat16, decoder=dec)
    return bm, bn, cb.dw_splits(B, f_in, T, widths, c2out, bm, bn, torch.bfloat16, decoder=dec)


def staged_bytes(design, name, f_in, widths, c2out, bm, bn, splits):
    """Bytes all blocks stage from global memory over the launch."""
    dec = name.startswith("dec")
    f_out = 2 * f_in if dec else f_in // 2
    chunks = -(-T // 64)
    if design.startswith("before"):
        total = 0
        for c2 in widths:
            m_tiles, n_tiles = -(-c2 // bm), -(-c2out // bn)
            live = 0
            for fo in range(f_out):
                for jf in range(5):
                    fi = (fo + jf - 2) / 2 if dec else 2 * fo + jf - 2
                    live += fi == int(fi) and 0 <= fi < f_in
            total += m_tiles * n_tiles * B * live * chunks * (bn + 2 * bm) * 64 * 2
        return total
    total = 0
    for c2 in widths:
        for rows in ((3, 2) if dec else (5,)):
            m_tiles = -(-(rows * c2) // bm)
            n_tiles = -(-(2 * c2out) // bn)
            steps = B * (f_in if dec else f_out) * chunks
            total += m_tiles * n_tiles * steps * (bm * 64 + bn // 2 * 72) * 2
    return total


def run(libs, design: str, stamped: bool, dev, shapes, tiles=None):
    gen = torch.Generator(device=dev).manual_seed(5)
    results = {}
    for name, f_in, widths, c2out in shapes:
        dec = name.startswith("dec")
        f_out = 2 * f_in if dec else f_in // 2
        gy = torch.randn(B, f_out * c2out, T, generator=gen, device=dev).to(torch.bfloat16)
        zs = [torch.randn(B, f_in * c2, T, generator=gen, device=dev).to(torch.bfloat16)
              for c2 in widths]
        if design.startswith("before"):
            bm, bn, splits = old_rules(name, f_in, widths, c2out)
        else:
            bm, bn, splits = new_rules(name, f_in, widths, c2out, (tiles or {}).get(name))
        part = torch.empty(splits, 5, 2, sum(widths), c2out, device=dev)
        p, i = ctypes.c_void_p, ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        if dec:
            fn = libs["deconv_block_bwd"].dec_bwd_dw
            fn.argtypes = [i, p, i, p, i, p, p] + [i] * 7 + [p]
            args = [1, zs[0].data_ptr(), widths[0], zs[1].data_ptr(), widths[1], gy.data_ptr(),
                    part.data_ptr(), splits, bm, bn, B, f_in, c2out, T, stream]
            lib = libs["deconv_block_bwd"]
        else:
            fn = libs["conv_block_bwd"].enc_bwd_dw
            fn.argtypes = [i, p, p, p] + [i] * 8 + [p]
            args = [1, zs[0].data_ptr(), gy.data_ptr(), part.data_ptr(), splits, bm, bn, B,
                    f_in, widths[0], c2out, T, stream]
            lib = libs["conv_block_bwd"]
        for _ in range(2):  # warm up, then the launch read
            if stamped:
                torch.cuda.synchronize()
                _build.check(lib, lib.probe_zero(), "probe_zero")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            _build.check(lib, fn(*args), f"{name} launch")
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        got = part.sum(0)
        if dec:
            got = cb.joined_from_regions(got, *widths)
            want = cb.dec_bwd_dw_plain(zs[0], zs[1], gy, f_in=f_in, c2x=widths[0], c2s=widths[1],
                                       c2out=c2out)
        else:
            want = cb.enc_bwd_dw_plain(zs[0], gy, f_in=f_in, c2in=widths[0], c2out=c2out)
        rel = ((got - want).abs().max() / want.abs().max()).item()
        staged = staged_bytes(design, name, f_in, widths, c2out, bm, bn, splits)
        unique = 2.0 * B * T * (f_in * sum(widths) + f_out * c2out)
        line = (f"{design} {'stamped' if stamped else 'bare'} {name}: tile {bm} x {bn}, "
                f"{splits} splits; {ms:.3f} ms, rel err {rel:.2e}; inputs {unique / 1e6:.0f} MB "
                f"({unique / ms / 1e9:.2f} TB/s once), staged {staged / 1e9:.2f} GB "
                f"({staged / unique:.1f}x, {staged / ms / 1e9:.2f} TB/s)")
        if stamped:
            prof = (ctypes.c_ulonglong * SLOTS)()
            _build.check(lib, lib.probe_read(ctypes.addressof(prof)), "probe_read")
            rows = torch.tensor(list(prof), dtype=torch.float64).view(-1, 8)
            rows = rows[rows[:, 6] > 0]
            span = rows[:, 6].mean().item()
            ns_per_cycle = (rows[:, 7] / rows[:, 6]).mean().item()
            names = PHASES[design]
            shares = ", ".join(f"{n} {100 * rows[:, k].mean().item() / span:.1f}%"
                               for k, n in enumerate(names))
            line += (f"; mean over {rows.shape[0]} blocks: span {span * ns_per_cycle / 1e3:.1f}"
                     f" us, {shares} (SM clock {1 / ns_per_cycle:.3f} GHz)")
        print(line, flush=True)
        results[name] = ms
        del gy, zs, part
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--design", choices=("before", "after"), default="after")
    parser.add_argument("--csrc", type=Path, default=_build.CSRC,
                        help="kernel source directory (the parent's for --design before)")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="none",
                        help="after: take out the products or the loads, or load through L2 only")
    parser.add_argument("--tile", action="append", default=[], metavar="BLOCK=BMxBN",
                        help="after: launch BLOCK with this tile (dw_gemm.cuh: launch)")
    parser.add_argument("--shapes", default=DEFAULT_SHAPES,
                        help="blocks to run, of " + ", ".join(s[0] for s in SHAPES))
    parser.add_argument("--bare", action="store_true", help="skip the stamped build")
    parser.add_argument("--blocks", type=int, default=cb._DW_BLOCKS,
                        help="after: kernels/conv_block.py:_DW_BLOCKS for dw_splits")
    parser.add_argument("--loads-first", action="store_true",
                        help="before: issue every staging load ahead of the stores")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    design = args.design + ("-loads-first" if args.loads_first else "")
    print(f"variant {args.variant}", flush=True)
    dev = torch.device("cuda")
    tiles = {}
    for spec in args.tile:
        block, tile = spec.split("=")
        tiles[block] = tuple(int(v) for v in tile.split("x"))
    shapes = [s for s in SHAPES if s[0] in args.shapes.split(",")]
    cb._DW_BLOCKS = args.blocks
    for stamped in (False,) if args.bare else (False, True):
        run(build(args.csrc.resolve(), design, stamped, args.variant), design, stamped, dev,
            shapes, tiles)


if __name__ == "__main__":
    main()
