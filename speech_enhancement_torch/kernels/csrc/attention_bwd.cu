// Multi-head attention backward for short sequences, for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/attention.py, `_mha_bwd_call`
// / `_mha_bwd_kernel` (the Pallas TPU kernel of `fused_mha_packed`'s custom
// VJP). From q, k, v and the output cotangent g of one (sequence, head),
// with P recomputed as in the forward (attention_fwd.cu):
//   dV = Pᵀ g,   dP = g Vᵀ,   dS = P ∘ (dP − rowsum(dP ∘ P)),
//   dQ = dS K · scale,   dK = dSᵀ Q · scale
// all in f32, rounded once to the i/o type. rowsum(dP ∘ P) is taken as
// rowsum(g ∘ O) with O = P V in f32, which is the same sum.
//
// What bounds it on an H100: the bytes. At Sepformer's training batch (B'
// 264 sequences of L 250, or 1,000 of L 66; H 8, D 32, bf16) a launch reads
// q, k, v, g and writes dq, dk, dv: 7 x 264 x 256 x 250 x 2 B = 237 MB,
// 0.07 ms at 3.35 TB/s, against about 2.5 times the forward's operations
// (0.02 ms at 989 TFLOP/s).
//
// Design: one block per (b, h), eight warps, every operand staged once in
// shared memory in both orientations the products need ([l][d] for the
// operands contracted over d, [d][l] for those contracted over l). Phase 1,
// a warp per query tile of 16 rows: an online-softmax pass over the keys
// gives the row max, the row sum and O, hence rowsum(g ∘ O) (kept in
// shared memory with the max and sum); a second pass over the keys
// rebuilds P and dP chunk by chunk and accumulates dQ in registers. Phase
// 2, after a barrier, a warp per key tile of 16 rows: it rebuilds Pᵀ and
// dPᵀ from the stored row statistics, chunk by chunk over the queries,
// and accumulates dK and dV in registers. A block owns its whole (b, h),
// so no gradient needs atomics. bf16 runs mma.sync with the f32 operand
// (P or dS) split into hi and lo parts (attention.cuh); f32 runs one thread
// per row on full-f32 FMA. Results are stored from the fragments.
//
// Shared memory (bf16, L 250, D 32): 4 x 256 x 40 + 4 x 32 x 264 elements
// and 3 x 256 f32 statistics, 152,576 bytes (one block an SM). A shape
// whose staging exceeds the device's limit is refused with
// cudaErrorInvalidConfiguration before launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using attn::bf16;
using attn::CHUNK;

constexpr int MMA_THREADS = 256;
constexpr int SIMT_THREADS = 128;

template <int DP>
__host__ __device__ constexpr size_t mma_smem(int length) {
  const int lp = attn::round_up(length, CHUNK);
  return sizeof(bf16) * (4 * static_cast<size_t>(lp) * (DP + 8) +
                         4 * static_cast<size_t>(DP) * (lp + 8)) +
         sizeof(float) * 3 * static_cast<size_t>(lp);
}

// Stores an f32 fragment pair (rows r0 = r, r1 = r + 8; columns d, d + 1)
// times `mul` into the head's [depth, length] block of out, inside the tensor.
__device__ __forceinline__ void store_frag(bf16* out, const float* acc, int r, int d, int depth,
                                           int length, float mul) {
  const int rows[2] = {r, r + 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rows[i >> 1], col = d + (i & 1);
    if (row < length && col < depth)
      out[static_cast<size_t>(col) * length + row] = __float2bfloat16(acc[i] * mul);
  }
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
    mha_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ go, bf16* __restrict__ dq,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int depth, int length,
                float scale) {
  constexpr int QP = DP + 8;
  constexpr int DK = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int WARPS = MMA_THREADS / 32;
  const int lp = attn::round_up(length, CHUNK);
  const int vp = lp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [lp][QP] rows: query l, k = d
  bf16* ks = qs + lp * QP;                    // [lp][QP]
  bf16* vs = ks + lp * QP;                    // [lp][QP]
  bf16* gs = vs + lp * QP;                    // [lp][QP]
  bf16* qts = gs + lp * QP;                   // [DP][vp] rows: d, k = l
  bf16* kts = qts + DP * vp;                  // [DP][vp]
  bf16* vts = kts + DP * vp;                  // [DP][vp]
  bf16* gts = vts + DP * vp;                  // [DP][vp]
  float* row_max = reinterpret_cast<float*>(gts + DP * vp);  // [lp]
  float* row_sum = row_max + lp;                               // [lp]
  float* row_dot = row_sum + lp;                               // [lp] rowsum(g ∘ O)

  const size_t base = static_cast<size_t>(blockIdx.x) * depth * length;
  attn::zero_shared(smem, reinterpret_cast<unsigned char*>(row_max) - smem);
  __syncthreads();
  attn::stage(q + base, depth, length, qs, QP, qts, vp);
  attn::stage(k + base, depth, length, ks, QP, kts, vp);
  attn::stage(v + base, depth, length, vs, QP, vts, vp);
  attn::stage(go + base, depth, length, gs, QP, gts, vp);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // ---- phase 1: a warp per query tile: statistics, rowsum(g ∘ O), dQ
  for (int qt = warp; qt < lp / 16; qt += WARPS) {
    const int r0 = qt * 16 + g, r1 = r0 + 8;
    uint32_t qa[DK][4], ga[DK][4];
    attn::a_rows<DK>(qs, QP, qt * 16, g, t, qa);
    attn::a_rows<DK>(gs, QP, qt * 16, g, t, ga);
    float m[2], l[2], acc[DT][4];  // pass A: the statistics and O
    attn::attend_tile<DP>(qa, ks, vts, vp, lp, length, scale, g, t, m, l, acc);
    const float m0 = m[0], m1 = m[1], l0 = l[0], l1 = l[1];
    float dot0 = 0.f, dot1 = 0.f;  // rowsum(g ∘ O), O = acc / l
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      dot0 += attn::to_f32(gs[r0 * QP + d]) * acc[dt][0] +
              attn::to_f32(gs[r0 * QP + d + 1]) * acc[dt][1];
      dot1 += attn::to_f32(gs[r1 * QP + d]) * acc[dt][2] +
              attn::to_f32(gs[r1 * QP + d + 1]) * acc[dt][3];
    }
    dot0 = attn::quad_sum(dot0) / l0;
    dot1 = attn::quad_sum(dot1) / l1;
    if (t == 0) {
      row_max[r0] = m0; row_sum[r0] = l0; row_dot[r0] = dot0;
      row_max[r1] = m1; row_sum[r1] = l1; row_dot[r1] = dot1;
    }

    float dqa[DT][4];  // pass B: dQ = dS K
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) dqa[dt][0] = dqa[dt][1] = dqa[dt][2] = dqa[dt][3] = 0.f;
    for (int c0 = 0; c0 < lp; c0 += CHUNK) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        const bf16* kr = ks + (c0 + nt * 8 + g) * QP + 2 * t;
        const bf16* vr = vs + (c0 + nt * 8 + g) * QP + 2 * t;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          attn::mma(s[nt], qa[kk], attn::ld32(kr + kk * 16), attn::ld32(kr + kk * 16 + 8));
          attn::mma(dp[nt], ga[kk], attn::ld32(vr + kk * 16), attn::ld32(vr + kk * 16 + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool valid = c0 + nt * 8 + 2 * t + (i & 1) < length;
          const float p = valid ? attn::exp_approx(s[nt][i] * scale - (i < 2 ? m0 : m1)) /
                                      (i < 2 ? l0 : l1)
                                : 0.f;
          s[nt][i] = p * (dp[nt][i] - (i < 2 ? dot0 : dot1));  // dS
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t hi[4], lo[4];
        attn::a_operand(s, kk, hi, lo);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const bf16* kr = kts + (dt * 8 + g) * vp + c0 + kk * 16 + 2 * t;
          const uint32_t b0 = attn::ld32(kr), b1 = attn::ld32(kr + 8);
          attn::mma(dqa[dt], hi, b0, b1);
          attn::mma(dqa[dt], lo, b0, b1);
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store_frag(dq + base, dqa[dt], qt * 16 + g, dt * 8 + 2 * t, depth, length, scale);
  }
  __syncthreads();

  // ---- phase 2: a warp per key tile: dK = dSᵀ Q, dV = Pᵀ g
  for (int kt = warp; kt < lp / 16; kt += WARPS) {
    uint32_t ka[DK][4], va[DK][4];
    attn::a_rows<DK>(ks, QP, kt * 16, g, t, ka);
    attn::a_rows<DK>(vs, QP, kt * 16, g, t, va);
    float dka[DT][4], dva[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
      dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
    }
    for (int c0 = 0; c0 < lp; c0 += CHUNK) {
      float pt[4][4], dst[4][4];  // rows: keys of the tile; columns: queries c0 ..
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* qr = qs + (c0 + nt * 8 + g) * QP + 2 * t;
        const bf16* gr = gs + (c0 + nt * 8 + g) * QP + 2 * t;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          attn::mma(st, ka[kk], attn::ld32(qr + kk * 16), attn::ld32(qr + kk * 16 + 8));
          attn::mma(dpt, va[kk], attn::ld32(gr + kk * 16), attn::ld32(gr + kk * 16 + 8));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = c0 + nt * 8 + 2 * t + (i & 1);
          float p = 0.f;
          if (l < length) p = attn::exp_approx(st[i] * scale - row_max[l]) / row_sum[l];
          pt[nt][i] = p;
          dst[nt][i] = l < length ? p * (dpt[i] - row_dot[l]) : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t phi[4], plo[4], shi[4], slo[4];
        attn::a_operand(pt, kk, phi, plo);
        attn::a_operand(dst, kk, shi, slo);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const bf16* gr = gts + (dt * 8 + g) * vp + c0 + kk * 16 + 2 * t;
          const bf16* qr = qts + (dt * 8 + g) * vp + c0 + kk * 16 + 2 * t;
          const uint32_t g0 = attn::ld32(gr), g1 = attn::ld32(gr + 8);
          const uint32_t q0 = attn::ld32(qr), q1 = attn::ld32(qr + 8);
          attn::mma(dva[dt], phi, g0, g1);
          attn::mma(dva[dt], plo, g0, g1);
          attn::mma(dka[dt], shi, q0, q1);
          attn::mma(dka[dt], slo, q0, q1);
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      store_frag(dk + base, dka[dt], kt * 16 + g, dt * 8 + 2 * t, depth, length, scale);
      store_frag(dv + base, dva[dt], kt * 16 + g, dt * 8 + 2 * t, depth, length, 1.f);
    }
  }
}

template <int DP>
__host__ __device__ constexpr size_t simt_smem(int length) {
  const int lp = attn::round_up(length, CHUNK);
  return sizeof(float) * (4 * static_cast<size_t>(lp) * (DP + 1) + 3 * static_cast<size_t>(lp));
}

template <int DP>
__global__ void __launch_bounds__(SIMT_THREADS)
    mha_bwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ go,
                 float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                 int depth, int length, float scale) {
  constexpr int P = DP + 1;
  const int lp = attn::round_up(length, CHUNK);
  extern __shared__ float fsm[];
  float* qs = fsm;              // [lp][P]
  float* ks = qs + lp * P;      // [lp][P]
  float* vs = ks + lp * P;      // [lp][P]
  float* gs = vs + lp * P;      // [lp][P]
  float* row_max = gs + lp * P;  // [lp]
  float* row_sum = row_max + lp;
  float* row_dot = row_sum + lp;
  const size_t base = static_cast<size_t>(blockIdx.x) * depth * length;
  float* none = nullptr;
  attn::zero_shared(fsm, sizeof(float) * 4 * lp * P);
  __syncthreads();
  attn::stage(q + base, depth, length, qs, P, none, 0);
  attn::stage(k + base, depth, length, ks, P, none, 0);
  attn::stage(v + base, depth, length, vs, P, none, 0);
  attn::stage(go + base, depth, length, gs, P, none, 0);
  __syncthreads();

  // phase 1: a thread per query row
  for (int l = threadIdx.x; l < length; l += SIMT_THREADS) {
    float qr[DP], gr[DP], acc[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      qr[d] = qs[l * P + d];
      gr[d] = gs[l * P + d];
      acc[d] = 0.f;
    }
    float m = -INFINITY, sum = 0.f;
    for (int c0 = 0; c0 < lp; c0 += CHUNK) {
      float s[CHUNK];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < DP; ++d) x = fmaf(qr[d], ks[(c0 + j) * P + d], x);
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
#pragma unroll
        for (int d = 0; d < DP; ++d) acc[d] = fmaf(p, vs[(c0 + j) * P + d], acc[d]);
      }
      m = n;
    }
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) dot = fmaf(gr[d], acc[d], dot);
    dot /= sum;
    row_max[l] = m;
    row_sum[l] = sum;
    row_dot[l] = dot;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] = 0.f;  // now dQ
    for (int key = 0; key < length; ++key) {
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        x = fmaf(qr[d], ks[key * P + d], x);
        dp = fmaf(gr[d], vs[key * P + d], dp);
      }
      const float ds = expf(x * scale - m) / sum * (dp - dot);
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(ds, ks[key * P + d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < depth) dq[base + static_cast<size_t>(d) * length + l] = acc[d] * scale;
  }
  __syncthreads();

  // phase 2: a thread per key row
  for (int key = threadIdx.x; key < length; key += SIMT_THREADS) {
    float kr[DP], vr[DP], dka[DP], dva[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      kr[d] = ks[key * P + d];
      vr[d] = vs[key * P + d];
      dka[d] = dva[d] = 0.f;
    }
    for (int l = 0; l < length; ++l) {
      float x = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        x = fmaf(qs[l * P + d], kr[d], x);
        dp = fmaf(gs[l * P + d], vr[d], dp);
      }
      const float p = expf(x * scale - row_max[l]) / row_sum[l];
      const float ds = p * (dp - row_dot[l]);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dva[d] = fmaf(p, gs[l * P + d], dva[d]);
        dka[d] = fmaf(ds, qs[l * P + d], dka[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      if (d < depth) {
        dk[base + static_cast<size_t>(d) * length + key] = dka[d] * scale;
        dv[base + static_cast<size_t>(d) * length + key] = dva[d];
      }
    }
  }
}

// Checks the block's shared memory against the device, raises the
// kernel's limit to it and launches one block per (b, h).
template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, cudaStream_t stream, const void* q,
           const void* k, const void* v, const void* go, void* dq, void* dk, void* dv,
           int batch_heads, int depth, int length, float scale) {
  if (smem > static_cast<size_t>(attn::max_shared_bytes()))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch_heads, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(go), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      depth, length, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, go (the output cotangent), dq, dk, dv: [batch * heads] head
// blocks of [depth, length], one dtype. Depths as for mha_fwd.
extern "C" int mha_bwd(int is_bf16, const void* q, const void* k, const void* v, const void* go,
                       void* dq, void* dk, void* dv, int batch_heads, int depth, int length,
                       float scale, cudaStream_t stream) {
  if (batch_heads <= 0 || depth <= 0 || depth > 64 || length <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = batch_heads;
  if (is_bf16) {
    if (depth <= 16)
      return launch<bf16>(mha_bwd_mma<16>, mma_smem<16>(length), MMA_THREADS, stream, q, k, v,
                          go, dq, dk, dv, bh, depth, length, scale);
    if (depth <= 32)
      return launch<bf16>(mha_bwd_mma<32>, mma_smem<32>(length), MMA_THREADS, stream, q, k, v,
                          go, dq, dk, dv, bh, depth, length, scale);
    return launch<bf16>(mha_bwd_mma<64>, mma_smem<64>(length), MMA_THREADS, stream, q, k, v, go,
                        dq, dk, dv, bh, depth, length, scale);
  }
  if (depth <= 8)
    return launch<float>(mha_bwd_simt<8>, simt_smem<8>(length), SIMT_THREADS, stream, q, k, v,
                         go, dq, dk, dv, bh, depth, length, scale);
  if (depth <= 16)
    return launch<float>(mha_bwd_simt<16>, simt_smem<16>(length), SIMT_THREADS, stream, q, k, v,
                         go, dq, dk, dv, bh, depth, length, scale);
  if (depth <= 32)
    return launch<float>(mha_bwd_simt<32>, simt_smem<32>(length), SIMT_THREADS, stream, q, k, v,
                         go, dq, dk, dv, bh, depth, length, scale);
  return launch<float>(mha_bwd_simt<64>, simt_smem<64>(length), SIMT_THREADS, stream, q, k, v,
                       go, dq, dk, dv, bh, depth, length, scale);
}
