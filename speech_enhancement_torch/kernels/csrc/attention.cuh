// Shared by attention_fwd.cu and attention_bwd.cu: short-sequence multi-head
// attention over the packed layout of the JAX package.
//
// Layout: q, k, v, the output and every gradient are [B, H * D, L] (dim 1 =
// h * D + d, L contiguous), so one (sequence b, head h) is the contiguous
// [D, L] block at offset (b * H + h) * D * L. One thread block owns one
// (b, h): it stages that head's tensors into shared memory once, and the
// [L, L] scores and probabilities never leave the block.
//
// Padding: the block works on L rounded up to CHUNK (the step of its inner
// loops) and D rounded up to the tile depth; padded rows and columns are
// staged as zeros, padded keys are masked to -1e30 after the scale (as the
// TPU kernel masks its lane padding), and padded rows are never stored.
//
// bf16 i/o uses mma.sync m16n8k16 (bf16 in, f32 accumulate). The products
// of two i/o tensors (Q Kᵀ, g Vᵀ) are exact in that form; a product with
// an f32 operand (probabilities or dS) splits it into a bf16 high part and
// a bf16 residual and issues two mmas, which keeps about 16 bits of the
// operand, so the sums match the TPU kernel's f32 arithmetic up to f32
// rounding. f32 i/o uses plain f32 FMA (no TF32), one thread per row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace attn {

constexpr int CHUNK = 32;        // keys (queries in the backward's second phase) per inner step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;  // the TPU kernel's mask value for padded keys

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Zeroes `bytes` (a multiple of 16) of shared memory at p, which pads
// every staged array before stage() fills its valid part.
__device__ __forceinline__ void zero_shared(void* p, size_t bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The head's [depth, length] block of src into shared memory as rows
// [l][d] (pitch row_pitch) and/or columns [d][l] (pitch col_pitch); a null
// destination is skipped, the padding is left as it is. The block reads
// the contiguous depth * length elements as 16-byte vectors (when src is
// 16-byte aligned and the count a multiple of a vector), eight of them in
// flight a thread, and scatters each element.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int depth, int length, T* rows,
                                      int row_pitch, T* cols, int col_pitch) {
  constexpr int V = 16 / sizeof(T);  // elements a vector
  constexpr int U = 8;               // vectors in flight a thread
  const int n = depth * length;
  auto put = [&](int e, T val) {
    const int d = e / length, l = e - d * length;
    if (rows) rows[l * row_pitch + d] = val;
    if (cols) cols[d * col_pitch + l] = val;
  };
  if (n % V || reinterpret_cast<uintptr_t>(src) % 16) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) put(e, src[e]);
    return;
  }
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  const int nv = n / V;
  for (int i0 = threadIdx.x; i0 < nv; i0 += U * blockDim.x) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < nv) raw[u] = src4[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < nv) {
        const T* vals = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int j = 0; j < V; ++j) put(i * V + j, vals[j]);
      }
    }
  }
}

// exp(x) as 2^(x log2 e): relative error about 2e-6 over the arguments a
// softmax keeps (x >= -30), far inside the f32 tolerances of the callers.
__device__ __forceinline__ float exp_approx(float x) { return exp2f(x * LOG2E); }

// Reductions over the four lanes of a quad, which share the rows of an
// mma accumulator fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d[16 x 8] += a[16 x 16] b[16 x 8]; fragment layouts of the PTX ISA: lane
// (g = lane / 4, t = lane % 4) holds a rows g, g + 8 at k 2t, 2t + 1 and
// 2t + 8, 2t + 9 (registers 0..3 = (g, k0), (g + 8, k0), (g, k8), (g + 8,
// k8)); b at k 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of column g; d at
// rows g (d0, d1) and g + 8 (d2, d3), columns 2t, 2t + 1.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// (x0, x1) as a bf16 pair hi and the pair of what hi leaves out, lo.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack(h0, h1);
  lo = pack(__float2bfloat16(x0 - __bfloat162float(h0)),
            __float2bfloat16(x1 - __bfloat162float(h1)));
}

// The A operand (hi and lo parts) of k16 slice kk of a 16 x 32 f32 tile
// held as four n8 accumulator fragments: the accumulator of columns
// [16 kk, 16 kk + 16) is, lane for lane, the A fragment of those k.
__device__ __forceinline__ void a_operand(const float (*acc)[4], int kk, uint32_t* hi,
                                          uint32_t* lo) {
  split(acc[2 * kk][0], acc[2 * kk][1], hi[0], lo[0]);
  split(acc[2 * kk][2], acc[2 * kk][3], hi[1], lo[1]);
  split(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[2], lo[2]);
  split(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[3], lo[3]);
}

// A fragments of rows [r, r + 16) of a row-major [rows][pitch] bf16 array,
// for the DK k16 steps over its columns.
template <int DK>
__device__ __forceinline__ void a_rows(const bf16* base, int pitch, int r, int g, int t,
                                       uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const bf16* p0 = base + (r + g) * pitch + kk * 16 + 2 * t;
    const bf16* p1 = p0 + 8 * pitch;
    a[kk][0] = ld32(p0);
    a[kk][1] = ld32(p1);
    a[kk][2] = ld32(p0 + 8);
    a[kk][3] = ld32(p1 + 8);
  }
}

// One warp's online softmax over the keys for a 16-row query tile with A
// fragments qa: the scores of each chunk of CHUNK keys (Q Kᵀ from ks, rows
// [key][DP + 8]) times scale, keys past length masked; the running row max
// m and sum l (this lane's rows g and g + 8; l is quad-reduced at the end)
// and the unnormalised O = sum exp(s - m) V (from vts, rows [d][vp]),
// rescaled whenever the max grows.
template <int DP>
__device__ __forceinline__ void attend_tile(const uint32_t (*qa)[4], const bf16* ks,
                                            const bf16* vts, int vp, int lp, int length,
                                            float scale, int g, int t, float* m, float* l,
                                            float (*acc)[4]) {
  constexpr int QP = DP + 8, DK = DP / 16, DT = DP / 8;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  for (int c0 = 0; c0 < lp; c0 += CHUNK) {
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = ks + (c0 + nt * 8 + g) * QP + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        mma(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = c0 + nt * 8 + 2 * t + (i & 1) < length ? s[nt][i] * scale : MASKED;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float n = fmaxf(m[r], quad_max(mx[r]));
      f[r] = exp_approx(m[r] - n);
      l[r] *= f[r];
      m[r] = n;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] *= f[i >> 1];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = exp_approx(s[nt][i] - m[i >> 1]);
        l[i >> 1] += s[nt][i];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t hi[4], lo[4];
      a_operand(s, kk, hi, lo);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* vr = vts + (dt * 8 + g) * vp + c0 + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma(acc[dt], hi, b0, b1);
        mma(acc[dt], lo, b0, b1);
      }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// Largest dynamic shared memory a block of the current device may use.
inline int max_shared_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace attn
