// Shared by attention_fwd.cu and attention_bwd.cu: short-sequence multi-head
// attention over the packed layout of the JAX package.
//
// Layout: q, k, v, the output and every gradient are [B, H * D, L] (dim 1 =
// h * D + d, L contiguous), so one (sequence b, head h) is the contiguous
// [D, L] block at offset (b * H + h) * D * L. A block stages a head's
// tensors into shared memory once, and the [L, L] scores and probabilities
// never leave the block.
//
// bf16 i/o (the mma kernels): a block walks `per_block` consecutive head
// blocks (Plan below) and fetches the next one while it works on the
// current one: the forward lands it in shared memory by a bulk copy where
// the head blocks are whole 16-byte words at 16-byte addresses, otherwise
// (and in the backward) it asks L2 for its lines. It stages each tensor in
// the packed orientation, as a pitched tile [d][pitch] with pitch = lp + 8
// (lp: L rounded up to 16): a head block's rows are not 16-byte aligned
// (L 250: 500 bytes a row), so each 8-element unit comes from the two
// aligned 16-byte words around it (as landed, or in global memory),
// realigned in registers (mma_util.cuh) and stored with one 16-byte shared
// store; columns [L, lp) are stored as zeros, rows [D, DP) are zeroed once.
// The pitch (an odd number of 16-byte words) keeps the eight rows of every
// ldmatrix on distinct banks. Operands contracted over d (Q and K of Q Kᵀ)
// come from ldmatrix.trans of that one copy, operands contracted over l
// (V of P V) from plain ldmatrix; results go back through stmatrix.trans
// into the same orientation and out with 16-byte stores along the head
// block (realigned again where a store spans two rows). Padded keys get a
// probability of 0 (their raw score is set to -inf; the TPU kernel masks
// its lane padding with -1e30 after the scale); padded rows are never
// stored.
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate): the products of two i/o
// tensors (Q Kᵀ, g Vᵀ) are exact in that form; a product with an f32
// operand (probabilities or dS) splits it into a bf16 high part and a bf16
// residual and issues two mmas, which keeps about 16 bits of the operand,
// so the sums match the TPU kernel's f32 arithmetic up to f32 rounding.
//
// f32 i/o (the SIMT kernels, small models only): one block per (b, h),
// plain f32 FMA (no TF32), one thread per row, element-wise staging in
// steps of CHUNK.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_util.cuh"

namespace attn {

constexpr int CHUNK = 32;        // the SIMT kernels' inner step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f;  // the TPU kernel's mask value for padded keys (SIMT)

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

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

// -- the bf16 kernels --------------------------------------------------------

// Launch geometry of a bf16 kernel (mirrored in kernels/attention.py,
// mma_plan): a block of `threads` walks `per_block` head blocks; lp is L
// rounded up to 16, the steps of the query tiles and of the key loops;
// `raw` is the shared bytes a tensor's head block takes as the bulk copy
// lands it (0: no bulk copies, the tiles are staged from global memory).
struct Plan {
  int lp, pitch, warps, threads, per_block, blocks, raw, smem, pair;
};

// A head block of n elements in shared memory as it lands: whole 16-byte
// words and one more, which the realignment may read past the last row.
inline int raw_bytes(int depth, int length) { return round_up(2 * depth * length, 16) + 16; }

// The forward: q, k, v pitched tiles (the output reuses q's) and, where the
// head blocks are whole 16-byte words at 16-byte addresses (`copyable`)
// and the shared memory holds them, their raw copies; eight heads a block
// (at Sepformer's width a sequence's eight heads). With the copies: one
// warp a 16-query tile up to eight warps (L 250: eight warps, two tiles
// each; L 66: lp 80, five warps); without: up to eight tiles one warp
// each, four warps above.
inline Plan fwd_plan(int batch_heads, int dp, int depth, int length, bool copyable, int shared) {
  Plan p;
  p.lp = round_up(length, 16);
  p.pitch = p.lp + 8;
  const int tiles = p.lp / 16, tile_bytes = 3 * dp * p.pitch * static_cast<int>(sizeof(bf16));
  p.raw = copyable && tile_bytes + 3 * raw_bytes(depth, length) <= shared
              ? raw_bytes(depth, length)
              : 0;
  p.warps = p.raw ? (tiles < 8 ? tiles : 8) : (tiles <= 8 ? tiles : 4);
  p.threads = 32 * p.warps;
  p.pair = dp <= 32 && tiles % 2 == 0 && tiles >= 2 * p.warps;  // two tiles a warp at once
  p.per_block = 8;
  p.blocks = (batch_heads + p.per_block - 1) / p.per_block;
  p.smem = tile_bytes + 3 * p.raw;
  return p;
}

// The backward: q, k, v, g pitched tiles (then dq, dk, dv), the f32 dQ sums
// [lp][dp + 8] and three row statistics; one warp a 16-row tile up to eight
// warps (L 250: eight warps, two query tiles in the statistics pass and
// two key tiles in the gradient pass each; L 66: five warps); eight heads
// a block; staged from global memory (bulk copies would not leave room for
// two blocks an SM at L 250).
inline Plan bwd_plan(int batch_heads, int dp, int length) {
  Plan p;
  p.lp = round_up(length, 16);
  p.pitch = p.lp + 8;
  const int tiles = p.lp / 16;
  p.warps = tiles < 8 ? tiles : 8;
  p.threads = 32 * p.warps;
  p.per_block = 8;
  p.blocks = (batch_heads + p.per_block - 1) / p.per_block;
  p.raw = 0;
  p.pair = 0;
  p.smem = 4 * dp * p.pitch * static_cast<int>(sizeof(bf16)) +
           p.lp * (dp + 8) * static_cast<int>(sizeof(float)) +
           3 * p.lp * static_cast<int>(sizeof(float));
  return p;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, 2 ulp; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- bulk copies (mma_util.cuh): one thread lands a head block in shared
// memory, an mbarrier counts its bytes, every thread waits on its phase.
using mmautil::bulk_copy;
using mmautil::mbar_expect;
using mmautil::mbar_init;
using mmautil::mbar_wait;

// Asks L2 for the 128-byte lines of n bf16 elements at p (every line holds
// one of them), one line a thread at a time.
__device__ __forceinline__ void prefetch_l2(const bf16* p, size_t n) {
  const uintptr_t end = reinterpret_cast<uintptr_t>(p + n);
  for (uintptr_t a = (reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(127)) +
                     128 * static_cast<uintptr_t>(threadIdx.x);
       a < end; a += 128 * static_cast<uintptr_t>(blockDim.x))
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

// Zeroes rows [depth, dp) of a pitched tile (the depth padding, which the
// staging never writes).
__device__ __forceinline__ void zero_rows(bf16* tile, int depth, int dp, int pitch) {
  uint4* p = reinterpret_cast<uint4*>(tile + depth * pitch);
  for (int i = threadIdx.x; i < (dp - depth) * pitch / 8; i += blockDim.x)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// A thread's walk over the units (d, 8-element column c) of a [depth][lp]
// tile, `blockDim.x` units a step, without a division a unit.
struct UnitWalk {
  int d, c, dq, dr, per_row;
  __device__ __forceinline__ explicit UnitWalk(int per_row_)
      : d(threadIdx.x / per_row_), c(threadIdx.x % per_row_),
        dq(blockDim.x / per_row_), dr(blockDim.x % per_row_), per_row(per_row_) {}
  __device__ __forceinline__ void next() {
    c += dr;
    d += dq;
    if (c >= per_row) {
      c -= per_row;
      ++d;
    }
  }
};

// The head blocks of NT tensors, one pointer each.
template <int NT>
struct Heads {
  const bf16* p[NT];
};

// Units (d, l0) of NT landed head blocks [depth, length] (raw tensor i at
// raw + i * raw_stride bytes, 16-byte aligned) into rows [d][0, lp) of the
// NT pitched tiles [dp][pitch] from `tiles`: the two 16-byte words around
// the unit, realigned by its residue, zeroed past length, one 16-byte
// store (two units of the NT tensors in flight a thread). Columns past
// length are stored as zeros without a read.
template <int NT>
__device__ __forceinline__ void realign_tiles(const unsigned char* raw, int raw_stride,
                                              bf16* tiles, int dp, int depth, int length,
                                              int lp, int pitch) {
  using namespace mmautil;
  constexpr int U = 2;
  UnitWalk w(lp / 8);
  while (w.d < depth) {
    uint4 lo[U][NT], hi[U][NT];
    int at[U], col[U], res[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int l0 = 8 * w.c, e = w.d * length + l0;
      const bool row = w.d < depth, live = row && l0 < length;
      at[j] = row ? w.d * pitch + l0 : -1;
      col[j] = l0;
      res[j] = e & 7;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        lo[j][i] = hi[j][i] = make_uint4(0u, 0u, 0u, 0u);
        if (live) {
          const uint4* r = reinterpret_cast<const uint4*>(raw + i * raw_stride) + (e >> 3);
          lo[j][i] = r[0];
          hi[j][i] = r[1];
        }
      }
      w.next();
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (at[j] < 0) continue;
#pragma unroll
      for (int i = 0; i < NT; ++i)
        *reinterpret_cast<uint4*>(tiles + i * dp * pitch + at[j]) =
            mask_frames(mmautil::realign(lo[j][i], hi[j][i], res[j]), col[j], length);
    }
  }
}

// The same from global memory, for head blocks a bulk copy cannot take:
// each unit's two aligned 16-byte chunks loaded (a chunk only where it
// holds an element of the row), two units of the NT tensors in flight a
// thread.
template <int NT>
__device__ __forceinline__ void stage_tiles(const Heads<NT>& src, bf16* tiles, int dp, int depth,
                                            int length, int lp, int pitch) {
  using namespace mmautil;
  constexpr int U = 2;
  UnitWalk w(lp / 8);
  while (w.d < depth) {
    uint4 lo[U][NT], hi[U][NT];
    int at[U], col[U], res[U][NT];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int l0 = 8 * w.c;
      const bool row = w.d < depth, live = row && l0 < length;
      at[j] = row ? w.d * pitch + l0 : -1;
      col[j] = l0;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const bf16* p = src.p[i] + w.d * length + l0;  // read only when live
        res[j][i] = residue(p);
        lo[j][i] = ld_pred(aligned_chunk(p), live);
        hi[j][i] = ld_pred(aligned_chunk(p) + 1, live && res[j][i] > 0 &&
                                                      l0 + 8 - res[j][i] < length);
      }
      w.next();
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (at[j] < 0) continue;
#pragma unroll
      for (int i = 0; i < NT; ++i)
        *reinterpret_cast<uint4*>(tiles + i * dp * pitch + at[j]) =
            mask_frames(mmautil::realign(lo[j][i], hi[j][i], res[j][i]), col[j], length);
    }
  }
}

// Elements [l, l + 8) of a pitched row (l + 8 <= pitch - 8).
__device__ __forceinline__ uint4 row_chunk(const bf16* row, int l) {
  const uint4* p = reinterpret_cast<const uint4*>(row + (l & ~7));
  return mmautil::realign(p[0], p[1], l & 7);
}

// Rows [d][0, length) of a pitched tile into the head block [depth, length]
// at dst: 16-byte stores along the block, each from one row or, where it
// spans two, from the last eight elements of the first and the head of the
// second; element by element where the block is not whole 16-byte words
// at a 16-byte address, or a row is shorter than a word.
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* tile, int depth, int length,
                                           int pitch) {
  const int n = depth * length;
  if ((n & 7) || (reinterpret_cast<uintptr_t>(dst) & 15) || length < 8) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int d = e / length;
      dst[e] = tile[d * pitch + e - d * length];
    }
    return;
  }
  const int step = 8 * blockDim.x, dq = step / length, dr = step % length;
  int d = 8 * threadIdx.x / length, l = 8 * threadIdx.x % length;
  for (int e = 8 * threadIdx.x; e < n; e += step) {
    const bf16* row = tile + d * pitch;
    uint4 val;
    if (l + 8 <= length) {
      val = row_chunk(row, l);
    } else {  // the tail of row d, then the head of row d + 1
      const uint4 next = *reinterpret_cast<const uint4*>(row + pitch);
      val = mmautil::realign(row_chunk(row, length - 8), next, 8 - (length - l));
    }
    *reinterpret_cast<uint4*>(dst + e) = val;
    l += dr;
    d += dq;
    if (l >= length) {
      l -= length;
      ++d;
    }
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {  // bf16 pair, lo in the low half
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as a bf16 pair hi and the pair of what hi leaves out, lo.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(x0 - __low2float(h), x1 - __high2float(h));
}

// The A operand (hi and lo parts) of k16 slice kk of a 16-row f32 tile held
// as n8 accumulator fragments: the accumulators of columns [16 kk, 16 kk +
// 16) are, lane for lane, the A fragment of those k.
__device__ __forceinline__ void a_split(const float (*acc)[4], int kk, uint32_t* hi, uint32_t* lo) {
  split2(acc[2 * kk][0], acc[2 * kk][1], hi[0], lo[0]);
  split2(acc[2 * kk][2], acc[2 * kk][3], hi[1], lo[1]);
  split2(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[2], lo[2]);
  split2(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[3], lo[3]);
}

// ldmatrix lane addresses in a pitched tile [row][col] (lane i addresses
// row i % 8 of matrix i / 8):
// - trans_a: the A fragment (16 rows x k16) of a tile stored [k][row]:
//   matrices (rows +0, k +0), (rows +8, k +0), (rows +0, k +8), (rows +8, k +8);
// - trans_b: B fragments of two n8 tiles of a tile stored [k][n]:
//   (k +0, n +0), (k +8, n +0), (k +0, n +8), (k +8, n +8);
// - plain_b: B fragments of two n8 tiles of a tile stored [n][k]:
//   (n +0, k +0), (n +0, k +8), (n +8, k +0), (n +8, k +8).
// The transposed store of two n8 accumulator tiles of a 16-row tile into
// [n][row] (stsm_x4_trans) takes plain_b's addresses with rows for k.
__device__ __forceinline__ int trans_a(int pitch, int k0, int r0, int lane) {
  return (k0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + r0 + (lane & 8);
}
__device__ __forceinline__ int trans_b(int pitch, int k0, int n0, int lane) {
  return (k0 + (lane & 7) + (lane & 8)) * pitch + n0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ int plain_b(int pitch, int n0, int k0, int lane) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + (lane & 8);
}

// One step of NT n8 key tiles (32 or 16 keys from c0) of a warp's online
// softmax for QT 16-query tiles with A fragments qa: the raw scores s = Q
// Kᵀ (keys past length set to -inf where MASK: the last step; the TPU
// kernel's -1e30 after the scale gives the same zero probability), the
// running row max m of y = s * scale * log2 e and sum l (per tile, this
// lane's rows g and g + 8; l is quad-reduced by the caller), and the
// unnormalised O = sum 2^(y - m) V, rescaled when the max grows. The QT
// tiles share every K and V fragment.
template <int DP, int NT, int QT, bool MASK>
__device__ __forceinline__ void attend_step(const uint32_t (*qa)[DP / 16][4], const bf16* ks,
                                            const bf16* vs, int pitch, int c0, int length,
                                            float c, int lane, float (*m)[2], float (*l)[2],
                                            float (*acc)[DP / 8][4]) {
  using namespace mmautil;
  constexpr int DK = DP / 16, DT = DP / 8;
  const int t = lane & 3;
  // -- scores --
  float s[QT][NT][4];
#pragma unroll
  for (int q = 0; q < QT; ++q)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[q][nt][0] = s[q][nt][1] = s[q][nt][2] = s[q][nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kb[4];
      ldsm_x4_trans(kb, ks + trans_b(pitch, 16 * kk, c0 + 16 * np, lane));
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        mma_bf16(s[q][2 * np], qa[q][kk], kb);
        mma_bf16(s[q][2 * np + 1], qa[q][kk], kb + 2);
      }
    }
  }
  // -- softmax --
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (MASK && c0 + 8 * nt + 2 * t + (i & 1) >= length) s[q][nt][i] = -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[q][nt][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float grown = fmaxf(m[q][r], quad_max(mx[r]) * c);
      const float f = ex2(m[q][r] - grown);
      m[q][r] = grown;
      l[q][r] *= f;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[q][dt][2 * r] *= f;
        acc[q][dt][2 * r + 1] *= f;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[q][nt][i] = ex2(fmaf(s[q][nt][i], c, -m[q][i >> 1]));
        l[q][i >> 1] += s[q][nt][i];
      }
    }
  }
  // -- products --
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t hi[QT][4], lo[QT][4];
#pragma unroll
    for (int q = 0; q < QT; ++q) a_split(s[q], kk, hi[q], lo[q]);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t vb[4];
      ldsm_x4(vb, vs + plain_b(pitch, 16 * dp, c0 + 16 * kk, lane));
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        mma_bf16(acc[q][2 * dp], hi[q], vb);
        mma_bf16(acc[q][2 * dp], lo[q], vb);
        mma_bf16(acc[q][2 * dp + 1], hi[q], vb + 2);
        mma_bf16(acc[q][2 * dp + 1], lo[q], vb + 2);
      }
    }
  }
  // -- end of step --
}

// A warp's QT 16-query tiles [r0, r0 + 16 QT) of one head: the online
// softmax over the keys in steps of 32 (the last one of 16 where lp is an
// odd number of 16s; only the last step holds keys past length, lp - L <
// 16), then O = acc / l written transposed into the tiles' own columns of
// os (q's tile: those columns are read by this warp alone, before).
template <int DP, int QT>
__device__ __forceinline__ void attend_tiles(const bf16* qs, const bf16* ks, const bf16* vs,
                                             bf16* os, int pitch, int r0, int lp, int length,
                                             float c, int lane) {
  using namespace mmautil;
  constexpr int DK = DP / 16, DT = DP / 8;
  // -- tile --
  uint32_t qa[QT][DK][4];
  float m[QT][2], l[QT][2], acc[QT][DT][4];
#pragma unroll
  for (int q = 0; q < QT; ++q) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      ldsm_x4_trans(qa[q][kk], qs + trans_a(pitch, 16 * kk, r0 + 16 * q, lane));
    m[q][0] = m[q][1] = -INFINITY;
    l[q][0] = l[q][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][dt][i] = 0.f;
  }
  // -- steps --
  const int last = lp % 32 ? lp - 16 : lp - 32;  // the first key of the last step
  for (int c0 = 0; c0 < last; c0 += 32)
    attend_step<DP, 4, QT, false>(qa, ks, vs, pitch, c0, length, c, lane, m, l, acc);
  if (lp % 32)
    attend_step<DP, 2, QT, true>(qa, ks, vs, pitch, last, length, c, lane, m, l, acc);
  else
    attend_step<DP, 4, QT, true>(qa, ks, vs, pitch, last, length, c, lane, m, l, acc);
  // -- steps done --
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    const float inv0 = 1.f / quad_sum(l[q][0]), inv1 = 1.f / quad_sum(l[q][1]);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      const float(*a)[4] = acc[q] + 2 * dp;
      const uint32_t r[4] = {
          pack2(a[0][0] * inv0, a[0][1] * inv0), pack2(a[0][2] * inv1, a[0][3] * inv1),
          pack2(a[1][0] * inv0, a[1][1] * inv0), pack2(a[1][2] * inv1, a[1][3] * inv1)};
      stsm_x4_trans(os + plain_b(pitch, 16 * dp, r0 + 16 * q, lane), r);
    }
  }
  // -- tile done --
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Largest dynamic shared memory a block of the current device may use,
// less STATIC_SMEM bytes for the kernels' static shared variables.
constexpr int STATIC_SMEM = 128;
inline int max_shared_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes - STATIC_SMEM;
}

}  // namespace attn
