#!/usr/bin/env python3
"""Where the time of the split-f32 STFT kernel goes, on one GPU.

Builds copies of ``speech_enhancement_torch/kernels/csrc/stft.cu`` into
``kernels/build/probe/`` (the package's source is not changed) and runs
each at DCCRN's serving shape (192 windows of 64,600 samples, win 400, hop
100, D 514), all in one call, beside the first design (f32 FMA) and
``torch.matmul`` on the unfolded frames:

* ``stamped``: ``clock64`` stamps by thread 0 of every frame block:
  prologue (the mbarriers set up, the span's and the first two slabs'
  bulk copies issued), wait (the span's and the slab's mbarrier and the
  block barrier), issue (the next slab's bulk copy), products (A's split
  and the mma.sync) and epilogue; the
  script prints the mean over block tiles in microseconds (cycles
  converted by each block's own ``%globaltimer`` span);
* unstamped variants, whose results are wrong where they leave work out
  (the time is what they show): ``bare`` (the kernel as it is), ``one``
  (one TF32 product a tile and k8 step instead of three), ``noproducts``,
  ``nosplitpass`` (the frames kernel alone, without the basis split).

Usage (on a machine with an NVIDIA GPU and nvcc)::

    python3 tools/stft_phase_probe.py [--variants stamped,bare,one,noproducts,nosplitpass]
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from speech_enhancement_torch.kernels import _build  # noqa: E402
from speech_enhancement_torch.kernels.stft import stft_plain  # noqa: E402
from speech_enhancement_torch.models.dccrn import _stft_bases  # noqa: E402

PHASES = ["prologue", "wait", "issue", "products", "epilogue"]
SLOTS = 8  # phases a block; the last two hold its cycles and ns
MAX_BLOCKS = 4096

PRELUDE = f"""
__device__ unsigned long long g_prof[{SLOTS} * {MAX_BLOCKS}];
__device__ __forceinline__ void probe_add(int k, unsigned long long v) {{
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && b < {MAX_BLOCKS}) atomicAdd(&g_prof[b * {SLOTS} + k], v);
}}
__device__ __forceinline__ unsigned long long probe_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
"""

ENTRIES = f"""
extern "C" int probe_zero() {{
  static unsigned long long zero[{SLOTS} * {MAX_BLOCKS}];
  return static_cast<int>(cudaMemcpyToSymbol(tc::g_prof, zero, sizeof(zero)));
}}
extern "C" int probe_read(void* host) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, tc::g_prof, sizeof(tc::g_prof)));
}}
"""

STAMPS = [
    ("  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n",
     "  const unsigned long long pstart = clock64(), nstart = probe_ns();\n"
     "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"),
    ("  __syncthreads();  // the mbarriers are initialised\n",
     "  __syncthreads();\n  unsigned long long tl = clock64();\n  probe_add(0, tl - pstart);\n"),
    ("    mmautil::mbar_wait(landed + st % STAGES, (st / STAGES) & 1);\n    __syncthreads();\n"
     "    issue(st + 2);\n",
     "    mmautil::mbar_wait(landed + st % STAGES, (st / STAGES) & 1);\n    __syncthreads();\n"
     "    const unsigned long long t1 = clock64();\n    probe_add(1, t1 - tl);\n"
     "    issue(st + 2);\n    const unsigned long long t2 = clock64();\n"
     "    probe_add(2, t2 - t1);\n"),
    ("    }\n  }\n\n#pragma unroll\n  for (int m = 0; m < 2; ++m)\n#pragma unroll\n"
     "    for (int h = 0; h < 2; ++h) {\n      const int r = wm * 32",
     "    }\n    tl = clock64();\n    probe_add(3, tl - t2);\n  }\n\n"
     "#pragma unroll\n  for (int m = 0; m < 2; ++m)\n#pragma unroll\n"
     "    for (int h = 0; h < 2; ++h) {\n      const int r = wm * 32"),
    ("          *reinterpret_cast<float2*>(o + c) = make_float2(acc[m][j][2 * h], "
     "acc[m][j][2 * h + 1]);\n      }\n    }\n}\n",
     "          *reinterpret_cast<float2*>(o + c) = make_float2(acc[m][j][2 * h], "
     "acc[m][j][2 * h + 1]);\n      }\n    }\n"
     "  probe_add(4, clock64() - tl);\n  probe_add(6, clock64() - pstart);\n"
     "  probe_add(7, probe_ns() - nstart);\n}\n"),
]

PRODUCTS = ("          mma_tf32(acc[m][j], as[m], bb);\n"
            "          mma_tf32(acc[m][j], ab[m], bs);\n")
SPLIT_PASS = ("    tc::split_basis<<<dim3(p.col_tiles, p.slabs), tc::THREADS, 0, s>>>(\n"
              "        static_cast<const float*>(basis), static_cast<float4*>(split), win, dim);\n")
VARIANTS = {
    "stamped": STAMPS,
    "bare": [],
    "one": [(PRODUCTS, "")],
    "noproducts": [(PRODUCTS + "          mma_tf32(acc[m][j], ab[m], bb);\n",
                    "          acc[m][j][0] += __uint_as_float(ab[m][0] ^ bb[0] ^ as[m][1] ^"
                    " bs[1]);\n")],
    "nosplitpass": [(SPLIT_PASS, "")],
}


def _patch(text: str, pairs) -> str:
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def source(variant: str) -> str:
    cu = (_build.CSRC / "stft.cu").read_text()
    cu = _patch(cu, [("namespace tc {\n", "namespace tc {\n" + PRELUDE)])
    return _patch(cu, VARIANTS[variant]) + ENTRIES


def build(variants) -> dict:
    """{variant: library}, one nvcc per variant, all at once."""
    jobs = {}
    for variant in variants:
        out = _build.BUILD / "probe" / f"stft-{variant}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        (out / "stft.cu").write_text(source(variant))
        lib = out / "probe.so"
        jobs[variant] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out / "stft.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {variant}: {line.strip()}", flush=True)
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default="stamped,bare,one,noproducts,nosplitpass")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    libs = build(args.variants.split(","))
    batch, total, win, hop = 192, 64600, 400, 100
    rng = np.random.default_rng(1234)
    x = torch.from_numpy(rng.standard_normal((batch, total), dtype=np.float32)).to(dev)
    x_off = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x).copy_(x)  # the first design
    basis = torch.from_numpy(_stft_bases(win, 512)[0]).to(dev)
    n_frames, dim = (total - win) // hop + 1, basis.shape[1]
    want = stft_plain(x, basis, hop, win)
    out = torch.empty_like(want)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    any_lib = next(iter(libs.values()))
    any_lib.stft_split_floats.argtypes = [i, i]
    any_lib.stft_split_floats.restype = ll
    split = torch.empty(any_lib.stft_split_floats(win, dim), device=dev)
    for variant, lib in libs.items():
        lib.stft_frames_f32.argtypes = [p, p, p, p, ll, ll, i, i, i, i, p]
        lib.probe_read.argtypes = [p]

        def call(xx, lib=lib):
            code = lib.stft_frames_f32(xx.data_ptr(), basis.data_ptr(), out.data_ptr(),
                                       split.data_ptr(), batch, total, n_frames, hop, win, dim,
                                       torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"stft_frames_f32 ({variant}): error {code}")

        ms = cuda_ms(lambda: call(x))
        _build.check(lib, lib.probe_zero(), "probe_zero")
        call(x)
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        line = f"stft {variant}: {ms:.4f} ms, max abs err vs plain {err:.3e}"
        if variant == "stamped":
            prof = (ctypes.c_ulonglong * (SLOTS * MAX_BLOCKS))()
            _build.check(lib, lib.probe_read(ctypes.addressof(prof)), "probe_read")
            tiles = 3 * -(-batch * n_frames // 128)
            rows = torch.tensor(list(prof), dtype=torch.float64).view(-1, SLOTS)[:tiles]
            ns_per_cycle = (rows[:, 7] / rows[:, 6]).mean().item()
            us = rows.mean(0) * ns_per_cycle / 1e3
            line += ("; us a block tile, mean over " + f"{tiles}: " + ", ".join(
                f"{n} {us[k].item():.2f}" for k, n in enumerate(PHASES))
                + f", total {us[6].item():.2f} (SM clock {1 / ns_per_cycle:.3f} GHz)")
        print(line, flush=True)
    first = cuda_ms(lambda: any_lib.stft_frames_f32(
        x_off.data_ptr(), basis.data_ptr(), out.data_ptr(), split.data_ptr(), batch, total,
        n_frames, hop, win, dim, torch.cuda.current_stream().cuda_stream))
    library = cuda_ms(lambda: torch.matmul(x.unfold(-1, win, hop), basis))
    print(f"stft first design (f32 FMA, an unaligned signal): {first:.4f} ms; torch.matmul on "
          f"x.unfold: {library:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
