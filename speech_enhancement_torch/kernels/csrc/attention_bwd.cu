// Multi-head attention backward for short sequences, for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/attention.py, `_mha_bwd_call`
// / `_mha_bwd_kernel` (the Pallas TPU kernel of `fused_mha_packed`'s custom
// VJP). From q, k, v and the output cotangent g of one (sequence, head),
// with P recomputed as in the forward (attention_fwd.cu):
//   dV = Pᵀ g,   dP = g Vᵀ,   dS = P ∘ (dP − rowsum(dP ∘ P)),
//   dQ = dS K · scale,   dK = dSᵀ Q · scale
// all in f32, rounded once to the i/o type.
//
// What bounds it on an H100: the bytes. At Sepformer's training batch (B'
// 264 sequences of L 250, or 1,000 of L 66; H 8, D 32, bf16) a launch reads
// q, k, v, g and writes dq, dk, dv: 7 x 264 x 256 x 250 x 2 B = 237 MB,
// 0.07 ms at 3.35 TB/s, against about 2.5 times the forward's operations
// (0.02 ms at 989 TFLOP/s); the products issued (L padded to 256, the f32
// operands P and dS as hi and lo parts) are about 90 GFLOP at L 250.
//
// Design (bf16): a block of up to eight warps walks eight consecutive (b,
// h) head blocks (attention.cuh: bwd_plan). For each head it asks L2 for
// the next head's lines and stages q, k, v and g once each into pitched
// tiles [d][lp + 8] with 16-byte loads realigned in registers; both
// orientations every product needs come from ldmatrix and ldmatrix.trans
// of that one copy. Two passes:
//   1. statistics, a warp per 16-query tile: one online pass over the keys
//      with S = Q Kᵀ and dP = g Vᵀ gives the row max, 1 / (row sum) and
//      rowsum(P ∘ dP) (rescaled with the sum), kept in shared memory;
//   2. gradients, a warp per 16-key tile (rounds of `warps` tiles): Sᵀ = K
//      Qᵀ and dPᵀ = V gᵀ a 16-query step at a time, Pᵀ and dSᵀ from the
//      statistics, dV += Pᵀ g and dK += dSᵀ Q in registers, and dQ += dS K
//      (dS's A fragments by movmatrix from dSᵀ's) added into an f32 [lp][D
//      + 8] array in shared memory. The warps of a round take their query
//      steps staggered (warp w at iteration i takes step (kt + i) mod the
//      steps), with a barrier an iteration, so no two warps add into one dQ
//      row at once and every dQ sum runs in one fixed order, without
//      atomics: results do not change from run to run.
// Products with P or dS take them as bf16 hi and lo parts (attention.cuh).
// dK and dV go by stmatrix.trans into the warp's own columns of k's and v's
// tiles, dQ (scaled, rounded) into q's; the block stores the three along l
// in 16-byte words. f32 runs one block per (b, h), one thread per row on
// full-f32 FMA, with the element-wise staging.
//
// Shared memory (bf16, D 32): 4 x 32 x 264 elements of tiles, 256 x 40 f32
// of dQ sums and 3 x 256 f32 statistics at L 250, 111,616 bytes (two blocks
// of 256 threads an SM); 36,288 bytes at L 66 (five warps). A shape whose
// tiles exceed the device's limit is refused with
// cudaErrorInvalidConfiguration before launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"
#include "common.cuh"

namespace {

using attn::bf16;
using attn::CHUNK;

constexpr int SIMT_THREADS = 128;

// One step of NT n8 key tiles (32 or 16 keys from c0) of a warp's statistics
// pass over its 16-query tile: S = Q Kᵀ and dP = g Vᵀ, the running row max
// m of s * scale * log2 e, the sum l of 2^(y - m) and the sum of 2^(y - m)
// dP, both rescaled when the max grows (this lane's rows g and g + 8).
template <int DP, int NT, bool MASK>
__device__ __forceinline__ void stats_step(const uint32_t (*qa)[4], const uint32_t (*ga)[4],
                                           const bf16* ks, const bf16* vs, int pitch, int c0,
                                           int length, float c, int lane, float* m, float* l,
                                           float* dsum) {
  using namespace mmautil;
  constexpr int DK = DP / 16;
  const int t = lane & 3;
  // -- p1 scores --
  float s[NT][4], dp[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kb[4], vb[4];
      ldsm_x4_trans(kb, ks + attn::trans_b(pitch, 16 * kk, c0 + 16 * np, lane));
      ldsm_x4_trans(vb, vs + attn::trans_b(pitch, 16 * kk, c0 + 16 * np, lane));
      mma_bf16(s[2 * np], qa[kk], kb);
      mma_bf16(s[2 * np + 1], qa[kk], kb + 2);
      mma_bf16(dp[2 * np], ga[kk], vb);
      mma_bf16(dp[2 * np + 1], ga[kk], vb + 2);
    }
  }
  // -- p1 softmax --
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (MASK && c0 + 8 * nt + 2 * t + (i & 1) >= length) s[nt][i] = -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float grown = fmaxf(m[r], attn::quad_max(mx[r]) * c);
    const float f = attn::ex2(m[r] - grown);
    m[r] = grown;
    l[r] *= f;
    dsum[r] *= f;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = attn::ex2(fmaf(s[nt][i], c, -m[i >> 1]));
      l[i >> 1] += p;
      dsum[i >> 1] = fmaf(p, dp[nt][i], dsum[i >> 1]);
    }
  }
  // -- p1 end --
}

// Pass 1 for a warp's 16-query tile [r0, r0 + 16): its rows' max (log2
// units), 1 / sum and rowsum(P ∘ dP) into row_m, row_il, row_d.
template <int DP>
__device__ __forceinline__ void stats_tile(const bf16* qs, const bf16* ks, const bf16* vs,
                                           const bf16* gs, int pitch, int r0, int lp,
                                           int length, float c, int lane, float* row_m,
                                           float* row_il, float* row_d) {
  using namespace mmautil;
  constexpr int DK = DP / 16;
  uint32_t qa[DK][4], ga[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    ldsm_x4_trans(qa[kk], qs + attn::trans_a(pitch, 16 * kk, r0, lane));
    ldsm_x4_trans(ga[kk], gs + attn::trans_a(pitch, 16 * kk, r0, lane));
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  const int last = lp % 32 ? lp - 16 : lp - 32;  // the first key of the last step
  for (int c0 = 0; c0 < last; c0 += 32)
    stats_step<DP, 4, false>(qa, ga, ks, vs, pitch, c0, length, c, lane, m, l, dsum);
  if (lp % 32)
    stats_step<DP, 2, true>(qa, ga, ks, vs, pitch, last, length, c, lane, m, l, dsum);
  else
    stats_step<DP, 4, true>(qa, ga, ks, vs, pitch, last, length, c, lane, m, l, dsum);
  const float il[2] = {1.f / attn::quad_sum(l[0]), 1.f / attn::quad_sum(l[1])};
  const float ds[2] = {attn::quad_sum(dsum[0]), attn::quad_sum(dsum[1])};
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + (lane >> 2) + 8 * r;
      row_m[row] = m[r];
      row_il[row] = il[r];
      row_d[row] = ds[r] * il[r];
    }
  }
}

// Pass 2, one iteration of a warp's 16-key tile [k0, k0 + 16) against the
// 16-query step [q0, q0 + 16): Sᵀ, dPᵀ,
// then Pᵀ = 2^(y − m) / l and dSᵀ = Pᵀ ∘ (dPᵀ − rowsum) with the queries'
// statistics (zero for keys or queries past length), dV += Pᵀ g and dK +=
// dSᵀ Q in registers, and the step's dQ rows += dS K (K's B fragments
// loaded here, not held) in the f32 sums. Each product's operands are
// built just before it, so that no more than one of them is live at once.
template <int DP>
__device__ __forceinline__ void grad_step(const bf16* qs, const bf16* ks, const bf16* vs,
                                          const bf16* gs,
                                          const float* row_m, const float* row_il,
                                          const float* row_d, float* dq, int pitch, int k0,
                                          int q0, int length, float c, int lane,
                                          float (*dk)[4], float (*dv)[4]) {
  using namespace mmautil;
  constexpr int DK = DP / 16, DT = DP / 8, DQ_PITCH = DP + 8;
  const int g = lane >> 2, t = lane & 3;
  // -- p2 scores --
  float s[2][4], dpt[2][4];  // rows: keys k0 + g, + 8; columns: queries q0 + 8 nt + 2t, + 1
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    uint32_t ka[4], va[4], qb[4], gb[4];  // A: K and V rows (keys); B: Qᵀ and gᵀ
    ldsm_x4_trans(ka, ks + attn::trans_a(pitch, 16 * kk, k0, lane));
    ldsm_x4_trans(va, vs + attn::trans_a(pitch, 16 * kk, k0, lane));
    ldsm_x4_trans(qb, qs + attn::trans_b(pitch, 16 * kk, q0, lane));
    ldsm_x4_trans(gb, gs + attn::trans_b(pitch, 16 * kk, q0, lane));
    mma_bf16(s[0], ka, qb);
    mma_bf16(s[1], ka, qb + 2);
    mma_bf16(dpt[0], va, gb);
    mma_bf16(dpt[1], va, gb + 2);
  }
  // -- p2 softmax --
  const bool edge = k0 + 16 > length || q0 + 16 > length;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int q = q0 + 8 * nt + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mq = row_m[q + e], lq = row_il[q + e], dq1 = row_d[q + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 2 * r + e;
        float p = attn::ex2(fmaf(s[nt][i], c, -mq)) * lq;
        if (edge && (k0 + g + 8 * r >= length || q + e >= length)) p = 0.f;
        s[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - dq1);
      }
    }
  }
  // -- p2 products --
  {
    uint32_t hi[4], lo[4];
    attn::a_split(s, 0, hi, lo);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t gb[4];
      ldsm_x4(gb, gs + attn::plain_b(pitch, 16 * dp, q0, lane));
      mma_bf16(dv[2 * dp], hi, gb);
      mma_bf16(dv[2 * dp], lo, gb);
      mma_bf16(dv[2 * dp + 1], hi, gb + 2);
      mma_bf16(dv[2 * dp + 1], lo, gb + 2);
    }
  }
  uint32_t ah[4], al[4];  // dS (rows: queries, k: keys): dSᵀ's 8 x 8 blocks transposed
  {
    uint32_t hi[4], lo[4];
    attn::a_split(dpt, 0, hi, lo);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t qb[4];
      ldsm_x4(qb, qs + attn::plain_b(pitch, 16 * dp, q0, lane));
      mma_bf16(dk[2 * dp], hi, qb);
      mma_bf16(dk[2 * dp], lo, qb);
      mma_bf16(dk[2 * dp + 1], hi, qb + 2);
      mma_bf16(dk[2 * dp + 1], lo, qb + 2);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ah[j] = movmatrix_trans(hi[(j & 1) * 2 + (j >> 1)]);
      al[j] = movmatrix_trans(lo[(j & 1) * 2 + (j >> 1)]);
    }
  }
#pragma unroll
  for (int dp = 0; dp < DT / 2; ++dp) {
    uint32_t kb[4];  // B fragments of K (k: keys, n: d) for d tiles 2 dp, 2 dp + 1
    ldsm_x4(kb, ks + attn::plain_b(pitch, 16 * dp, k0, lane));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d4, ah, kb + 2 * half);
      mma_bf16(d4, al, kb + 2 * half);
      const int col = 8 * (2 * dp + half) + 2 * t;
      float2* r0 = reinterpret_cast<float2*>(dq + (q0 + g) * DQ_PITCH + col);
      float2* r1 = r0 + 4 * DQ_PITCH;  // row q0 + g + 8
      float2 x = *r0, y = *r1;
      x.x += d4[0];
      x.y += d4[1];
      y.x += d4[2];
      y.y += d4[3];
      *r0 = x;
      *r1 = y;
    }
  }
  // -- p2 end --
}

template <int DP>
__global__ void __launch_bounds__(256, DP <= 32 ? 2 : 1)
    mha_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ go, bf16* __restrict__ dq,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int batch_heads, int depth,
                int length, float scale, int per_block) {
  using namespace mmautil;
  constexpr int DT = DP / 8, DQ_PITCH = DP + 8;
  const int lp = attn::round_up(length, 16), pitch = lp + 8, tiles = lp / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [DP][pitch]: q, then dq
  bf16* ks = qs + DP * pitch;                 // k, then dk
  bf16* vs = ks + DP * pitch;                 // v, then dv
  bf16* gs = vs + DP * pitch;                 // g
  float* dqs = reinterpret_cast<float*>(gs + DP * pitch);  // [lp][DQ_PITCH] dQ sums
  float* row_m = dqs + lp * DQ_PITCH;                      // [lp] the statistics
  float* row_il = row_m + lp;
  float* row_d = row_il + lp;
  const size_t n = static_cast<size_t>(depth) * length;
  const int h0 = blockIdx.x * per_block, h1 = min(h0 + per_block, batch_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const float c = scale * attn::LOG2E;
  // -- begin --
  for (int i = 0; i < 4; ++i) attn::zero_rows(qs + i * DP * pitch, depth, DP, pitch);
  for (int h = h0; h < h1; ++h) {
    // -- stage --
    const size_t at = h * n;
    // -- landed --
    if (h + 1 < h1) {
      attn::prefetch_l2(q + at + n, n);
      attn::prefetch_l2(k + at + n, n);
      attn::prefetch_l2(v + at + n, n);
      attn::prefetch_l2(go + at + n, n);
    }
    attn::stage_tiles<4>({{q + at, k + at, v + at, go + at}}, qs, DP, depth, length, lp, pitch);
    for (int i = threadIdx.x; i < lp * DQ_PITCH / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dqs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    // -- staged --
    __syncthreads();
    // -- tiles --
    for (int r0 = 16 * warp; r0 < lp; r0 += 16 * warps)
      stats_tile<DP>(qs, ks, vs, gs, pitch, r0, lp, length, c, lane, row_m, row_il, row_d);
    __syncthreads();
    for (int round = 0; round * warps < tiles; ++round) {
      const int kt = warp + round * warps, k0 = 16 * kt;
      const bool mine = kt < tiles;  // a warp without a tile still meets the barriers
      float dka[DT][4], dva[DT][4];
      if (mine) {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dka[dt][i] = dva[dt][i] = 0.f;
      }
      for (int i = 0; i < tiles; ++i) {
        if (mine) {
          const int q0 = 16 * ((kt + i) % tiles);  // staggered: one warp a query step
          grad_step<DP>(qs, ks, vs, gs, row_m, row_il, row_d, dqs, pitch, k0, q0, length, c,
                        lane, dka, dva);
        }
        // -- p2 barrier --
        __syncthreads();
        // -- p2 barrier done --
      }
      if (mine) {  // dK and dV into the tile's own columns of k's and v's tiles
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          const float(*a)[4] = dka + 2 * dp;
          const float(*b)[4] = dva + 2 * dp;
          const uint32_t rk[4] = {attn::pack2(a[0][0] * scale, a[0][1] * scale),
                                  attn::pack2(a[0][2] * scale, a[0][3] * scale),
                                  attn::pack2(a[1][0] * scale, a[1][1] * scale),
                                  attn::pack2(a[1][2] * scale, a[1][3] * scale)};
          const uint32_t rv[4] = {attn::pack2(b[0][0], b[0][1]), attn::pack2(b[0][2], b[0][3]),
                                  attn::pack2(b[1][0], b[1][1]), attn::pack2(b[1][2], b[1][3])};
          stsm_x4_trans(ks + attn::plain_b(pitch, 16 * dp, k0, lane), rk);
          stsm_x4_trans(vs + attn::plain_b(pitch, 16 * dp, k0, lane), rv);
        }
      }
    }
    // -- epilogue --
    // dQ (scaled, rounded) into q's tile: units of 8 queries of one d, d fastest
    for (attn::UnitWalk w(depth); w.d < lp / 8; w.next()) {
      const float* src = dqs + 8 * w.d * DQ_PITCH + w.c;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = attn::pack2(src[2 * j * DQ_PITCH] * scale, src[(2 * j + 1) * DQ_PITCH] * scale);
      *reinterpret_cast<uint4*>(qs + w.c * pitch + 8 * w.d) = make_uint4(r[0], r[1], r[2], r[3]);
    }
    __syncthreads();
    attn::store_tile(dq + at, qs, depth, length, pitch);
    attn::store_tile(dk + at, ks, depth, length, pitch);
    attn::store_tile(dv + at, vs, depth, length, pitch);
    __syncthreads();
    // -- stored --
  }
  // -- end --
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

// The bf16 kernel at depth tile DP: the plan's shared memory checked
// against the device and granted, `blocks` blocks of `threads`.
template <int DP>
int launch_mma(cudaStream_t stream, const void* q, const void* k, const void* v, const void* go,
               void* dq, void* dk, void* dv, int batch_heads, int depth, int length,
               float scale) {
  const attn::Plan p = attn::bwd_plan(batch_heads, DP, length);
  if (p.smem > attn::max_shared_bytes()) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err =
      cudaFuncSetAttribute(mha_bwd_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_mma<DP><<<p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(go), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), batch_heads, depth, length, scale, p.per_block);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernel at depth tile DP: one block per (b, h).
template <int DP>
int launch_simt(cudaStream_t stream, const void* q, const void* k, const void* v, const void* go,
                void* dq, void* dk, void* dv, int batch_heads, int depth, int length,
                float scale) {
  const size_t smem = simt_smem<DP>(length);
  if (smem > static_cast<size_t>(attn::max_shared_bytes()))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_simt<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_simt<DP><<<batch_heads, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(go), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), depth, length, scale);
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
  const int bh = batch_heads, d = depth, l = length;
  if (is_bf16) {
    if (depth <= 16) return launch_mma<16>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
    if (depth <= 32) return launch_mma<32>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
    return launch_mma<64>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
  }
  if (depth <= 8) return launch_simt<8>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
  if (depth <= 16) return launch_simt<16>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
  if (depth <= 32) return launch_simt<32>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
  return launch_simt<64>(stream, q, k, v, go, dq, dk, dv, bh, d, l, scale);
}
