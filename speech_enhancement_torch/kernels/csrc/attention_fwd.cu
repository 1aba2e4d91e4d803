// Multi-head attention forward for short sequences, for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/attention.py, `_mha_fwd_call`
// / `_mha_fwd_kernel` with `_probs` (the Pallas TPU kernel). For each
// sequence b and head h, with q, k, v the head's [D, L] blocks upcast to f32:
//   s[l, m] = (sum_d q[d, l] k[d, m]) * scale     (keys past L: -1e30)
//   p[l, m] = exp(s[l, m] - max_m s[l, :]) / sum_m exp(...)
//   o[d, l] = sum_m v[d, m] p[l, m]                (rounded to the i/o type)
// The layout and padding are described in attention.cuh.
//
// What bounds it on an H100: the bytes. Sepformer's intra-chunk attention
// at serving width (B' 12,672 sequences, H 8, L 250, D 32, bf16) moves q,
// k, v and o once, 6.49 GB: 1.94 ms at 3.35 TB/s, against 0.82 ms for its
// 811 GFLOP at 989 TFLOP/s; at D = 32 it does L/2 operations a byte, under
// the card's ~295. The inter-chunk launch (B' 48,000, L 66) is bound by
// bytes too.
//
// Design: one block per (b, h), four warps. The TPU kernel groups 16
// sequences a grid cell for issue overhead and pads L to 128 lanes; here a
// block stages its head's q and k as rows [l][d] (the A and B operands of
// Q Kᵀ want d contiguous, the packed layout has l contiguous) and v as
// [d][m] (the B operand of P V wants m contiguous), all padded rows zero.
// Each warp takes query tiles of 16 rows and walks the keys in chunks of
// 32 with an online softmax (running row max and sum, the accumulator
// rescaled when the max grows), so neither the [L, L] scores (250 KB in
// f32 at L 250, more than a block's 227 KB) nor a full score row exists
// anywhere: a warp holds a 16 x 32 tile in registers. The output tile goes
// through shared memory so that the stores run along l. bf16 uses
// mma.sync with P split into hi and lo bf16 parts (attention.cuh); f32
// runs one thread per query row on full-f32 FMA.
//
// Shared memory (bf16, L 250, D 32): q and k 2 x 256 x 40, v and the
// output tile 2 x 32 x 264 elements, 74,752 bytes (three blocks an SM).
// A shape whose staging exceeds the device's limit is refused with
// cudaErrorInvalidConfiguration before launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using attn::bf16;
using attn::CHUNK;

constexpr int MMA_THREADS = 128;
constexpr int SIMT_THREADS = 128;

template <int DP>
__host__ __device__ constexpr size_t mma_smem(int length) {
  const int lp = attn::round_up(length, CHUNK);
  return sizeof(bf16) * (2 * static_cast<size_t>(lp) * (DP + 8) +
                         2 * static_cast<size_t>(DP) * (lp + 8));
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
    mha_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int depth, int length,
                float scale) {
  constexpr int QP = DP + 8;  // row pitch of qs, ks: conflict-free fragment loads
  constexpr int DK = DP / 16;
  constexpr int DT = DP / 8;
  const int lp = attn::round_up(length, CHUNK);
  const int vp = lp + 8;  // row pitch of vts, ots
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [lp][QP]
  bf16* ks = qs + lp * QP;                    // [lp][QP]
  bf16* vts = ks + lp * QP;                   // [DP][vp]
  bf16* ots = vts + DP * vp;                  // [DP][vp]

  const size_t base = static_cast<size_t>(blockIdx.x) * depth * length;
  bf16* none = nullptr;
  attn::zero_shared(smem, mma_smem<DP>(length));
  __syncthreads();
  attn::stage(q + base, depth, length, qs, QP, none, 0);
  attn::stage(k + base, depth, length, ks, QP, none, 0);
  attn::stage(v + base, depth, length, none, 0, vts, vp);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int qt = warp; qt < lp / 16; qt += MMA_THREADS / 32) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    uint32_t qa[DK][4];
    attn::a_rows<DK>(qs, QP, qt * 16, g, t, qa);
    float m[2], l[2], acc[DT][4];
    attn::attend_tile<DP>(qa, ks, vts, vp, lp, length, scale, g, t, m, l, acc);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      ots[d * vp + r0] = __float2bfloat16(acc[dt][0] / l[0]);
      ots[(d + 1) * vp + r0] = __float2bfloat16(acc[dt][1] / l[0]);
      ots[d * vp + r1] = __float2bfloat16(acc[dt][2] / l[1]);
      ots[(d + 1) * vp + r1] = __float2bfloat16(acc[dt][3] / l[1]);
    }
  }
  __syncthreads();
  // the [depth, length] output block from ots, 8 elements a 16-byte store
  // where the address and the count allow it
  const int n = depth * length;
  auto get = [&](int e) {
    const int d = e / length;
    return ots[d * vp + e - d * length];
  };
  if (n % 8 || reinterpret_cast<uintptr_t>(o + base) % 16) {
    for (int e = threadIdx.x; e < n; e += MMA_THREADS) o[base + e] = get(e);
    return;
  }
  uint4* o4 = reinterpret_cast<uint4*>(o + base);
  for (int i = threadIdx.x; i < n / 8; i += MMA_THREADS) {
    uint4 raw;
    bf16* vals = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) vals[j] = get(i * 8 + j);
    o4[i] = raw;
  }
}

template <int DP>
__host__ __device__ constexpr size_t simt_smem(int length) {
  return sizeof(float) * 2 * static_cast<size_t>(attn::round_up(length, CHUNK)) * (DP + 1);
}

template <int DP>
__global__ void __launch_bounds__(SIMT_THREADS)
    mha_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int depth, int length,
                 float scale) {
  constexpr int P = DP + 1;  // odd pitch: the transposing stage writes without conflicts
  const int lp = attn::round_up(length, CHUNK);
  extern __shared__ float fsm[];
  float* ks = fsm;           // [lp][P]
  float* vs = fsm + lp * P;  // [lp][P]
  const size_t base = static_cast<size_t>(blockIdx.x) * depth * length;
  float* none = nullptr;
  attn::zero_shared(fsm, simt_smem<DP>(length));
  __syncthreads();
  attn::stage(k + base, depth, length, ks, P, none, 0);
  attn::stage(v + base, depth, length, vs, P, none, 0);
  __syncthreads();

  for (int l = threadIdx.x; l < length; l += SIMT_THREADS) {
    float qr[DP], acc[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      qr[d] = d < depth ? q[base + static_cast<size_t>(d) * length + l] : 0.f;
      acc[d] = 0.f;
    }
    float m = -INFINITY, sum = 0.f;
    for (int c0 = 0; c0 < lp; c0 += CHUNK) {
      float s[CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float* kr = ks + (c0 + j) * P;
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) x = fmaf(qr[d], kr[d], x);
        x = c0 + j < length ? x * scale : attn::MASKED;
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      const float n = fmaxf(m, mx);
      const float f = expf(m - n);
      sum *= f;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] *= f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = expf(s[j] - n);
        sum += p;
        const float* vr = vs + (c0 + j) * P;
#pragma unroll
        for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
      m = n;
    }
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < depth) o[base + static_cast<size_t>(d) * length + l] = acc[d] / sum;
  }
}

// Checks the block's shared memory against the device, raises the
// kernel's limit to it and launches one block per (b, h).
template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, cudaStream_t stream, const void* q,
           const void* k, const void* v, void* o, int batch_heads, int depth, int length,
           float scale) {
  if (smem > static_cast<size_t>(attn::max_shared_bytes()))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch_heads, threads, smem, stream>>>(static_cast<const T*>(q),
                                                 static_cast<const T*>(k),
                                                 static_cast<const T*>(v), static_cast<T*>(o),
                                                 depth, length, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [batch * heads] head blocks of [depth, length], one dtype.
// bf16 takes the mma kernel at depth 16, 32 or 64 (a depth in between is
// zero-padded), f32 the FMA kernel at 8, 16, 32 or 64.
extern "C" int mha_fwd(int is_bf16, const void* q, const void* k, const void* v, void* o,
                       int batch_heads, int depth, int length, float scale,
                       cudaStream_t stream) {
  if (batch_heads <= 0 || depth <= 0 || depth > 64 || length <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = batch_heads;
  if (is_bf16) {
    if (depth <= 16)
      return launch<bf16>(mha_fwd_mma<16>, mma_smem<16>(length), MMA_THREADS, stream, q, k, v, o,
                          bh, depth, length, scale);
    if (depth <= 32)
      return launch<bf16>(mha_fwd_mma<32>, mma_smem<32>(length), MMA_THREADS, stream, q, k, v, o,
                          bh, depth, length, scale);
    return launch<bf16>(mha_fwd_mma<64>, mma_smem<64>(length), MMA_THREADS, stream, q, k, v, o,
                        bh, depth, length, scale);
  }
  if (depth <= 8)
    return launch<float>(mha_fwd_simt<8>, simt_smem<8>(length), SIMT_THREADS, stream, q, k, v, o,
                         bh, depth, length, scale);
  if (depth <= 16)
    return launch<float>(mha_fwd_simt<16>, simt_smem<16>(length), SIMT_THREADS, stream, q, k, v,
                         o, bh, depth, length, scale);
  if (depth <= 32)
    return launch<float>(mha_fwd_simt<32>, simt_smem<32>(length), SIMT_THREADS, stream, q, k, v,
                         o, bh, depth, length, scale);
  return launch<float>(mha_fwd_simt<64>, simt_smem<64>(length), SIMT_THREADS, stream, q, k, v, o,
                       bh, depth, length, scale);
}
