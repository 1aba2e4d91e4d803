// The fused DCCRN block as a tiled implicit GEMM on Hopper (sm_90a).
//
// Shared by conv_block.cu (encoder block) and deconv_block.cu (decoder
// block); each source instantiates only its own variant. What the two
// compute, and what bounds them, is written at the top of each source.
// launch sends every bf16 variant (the encoder and decoder blocks and
// their input gradients) to block_mma.cuh's mma_kernel (the same sums with
// weight reuse, 16-byte staging and a pipelined ring); the four f32
// variants, which the small f32 models use, run block_kernel below, this
// file's first design.
// The input gradients of the two blocks are the same sums with the roles
// of the indexings swapped (conv_block_bwd.cu, deconv_block_bwd.cu): they
// run this kernel as its kGrad variant: the input staged as it is (no
// pointwise), no bias, no stats and, for the decoder's trunk and skip, two
// outputs.
//
// Layout: activations are [B, F * C2, T] (frequency-major, channels stacked
// [r..., i...] per frequency row, time contiguous), as in the JAX package.
// For one batch item b and output frequency row fo:
//
//   Y[co, t] = bias[co] + sum over (region, tap jf, time tap jt, channel ci)
//              W[jf, jt, co, ci] * Z[fi(fo, jf), ci, t + jt + t_shift]
//
// where Z = PReLU(a_diag * X + a_cross * partner(X) + c0) is the previous
// block's folded complex BN and PReLU, applied while the tile is staged
// (the partner of channel ci is ci +- C2/2 in the same frequency row, so it
// is read from the same row), and rounded to the activation type.
//
// Tiling: a block of 256 threads computes BM output channels x BN = 64
// frames of one (b, fo). The BM rows hold BM/2 real-part channels and their
// BM/2 imaginary partners, so the stats epilogue finds every row's partner
// in the same tile. The K loop walks taps jf, then channel steps of BK = 16:
// each step stages the Z rows of frames [t0 + t_shift, t0 + t_shift + BN]
// (BN + 1 frames: both time taps read the same staged rows, one frame
// apart) and the weights of both time taps in shared memory, then
//   bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate), 8 warps as a
//         WARPS_M x WARPS_N grid of WM x WN warp tiles;
//   f32:  plain f32 FMA (no TF32), each thread BM * BN / 256 outputs.
// Ragged edges: frames t >= T and channels past C2 stage as zeros; rows
// past C2out are not stored. The epilogue moves the f32 tile through
// shared memory, adds the bias in f32, stores the rows in the activation
// type, and (with stats) adds each row's sum y, sum y^2 and sum y*partner
// over its frames, from the f32 values before rounding, into a zeroed
// [B, R_out, 8] f32 array with atomicAdd (11 frame tiles per row at T = 643;
// the order of the adds varies from run to run).
//
// Shared memory: max(staging, epilogue) = (BN+1) x 24 + 2 x BM x 24
// elements, or BM x (BN+1) f32: 33.3 KB at BM = 128. Registers and spills
// per instantiation: the ptxas report of the build (chip_smoke.py logs it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_mma.cuh"
#include "mma_util.cuh"

namespace blockgemm {

using mmautil::mma_bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 64;         // frames per block
constexpr int BK = 16;         // input channels per K step (one mma depth)
constexpr int PITCH = BK + 8;  // staged row pitch in elements: conflict-free fragment loads
constexpr int ZROWS = BN + 1;  // staged frames: the tile and one more for the other time tap
constexpr int CPITCH = BN + 1; // f32 epilogue tile pitch: conflict-free row-wise reads

struct Region {
  const void* x;      // [B, f_in * c2, T], activation type
  const float* coef;  // [3 * c2 + 1]: a_diag, a_cross, c0 (rounded to the type), alpha;
                      // unused by the input gradients (kGrad)
  const void* w;      // [5, 2, c2out, kp], activation type, zero past c2
  int c2;             // channels (r and i stacked) of a frequency row
  int kp;             // c2 rounded up to BK
};

struct Params {
  Region reg[2];
  int n_reg;
  const float* bias;  // [c2out]; unused by the input gradients (kGrad)
  void* y;            // [B, f_out * c2out, T]
  float* stats;       // [B, f_out * c2out, 8], zeroed; null without stats
  int f_in, f_out, c2out, n_time, m_tiles;
  void* y2;           // kGrad: null, or with y a split of the output channels (out_row)
  int c2a;            // with y2: the channels (r and i) that go to y
  int bm, nb;         // bf16: the tile of block_mma.cuh the caller packed the weights for
  int pair;           // bf16: output row pairs a block (block_mma.cuh: kPair)
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

template <int BM> struct Tile {
  static constexpr int WARPS_M = BM == 16 ? 1 : (BM == 32 ? 2 : BM / 32);
  static constexpr int WARPS_N = WARPS / WARPS_M;
  static constexpr int WM = BM / WARPS_M;  // 16, 16, 32, 32
  static constexpr int WN = BN / WARPS_N;  // 8, 16, 16, 32
  static constexpr int MT = WM / 16;       // m16 fragments per warp
  static constexpr int NT = WN / 8;        // n8 fragments per warp
  static constexpr int PER_THREAD = BM * BN / THREADS;  // f32 path outputs
};

// Shared memory, one raw buffer: during the K loop the staged Z rows
// ([frame][channel], the mma's B operand, k contiguous) and the weights of
// both time taps ([tap][row][channel], the A operand); in the epilogue the
// f32 output tile [row][frame].
template <typename T, int BM> struct Smem {
  static constexpr int Z_BYTES = ZROWS * PITCH * sizeof(T);
  static constexpr int W_BYTES = 2 * BM * PITCH * sizeof(T);
  static constexpr int C_BYTES = BM * CPITCH * sizeof(float);
  static constexpr int BYTES = Z_BYTES + W_BYTES > C_BYTES ? Z_BYTES + W_BYTES : C_BYTES;
  static_assert(Z_BYTES % 16 == 0, "weights must start 16-byte aligned");

  T (*z)[PITCH];
  T (*w)[BM][PITCH];
  float (*c)[CPITCH];

  __device__ explicit Smem(unsigned char* raw)
      : z(reinterpret_cast<T (*)[PITCH]>(raw)),
        w(reinterpret_cast<T (*)[BM][PITCH]>(raw + Z_BYTES)),
        c(reinterpret_cast<float (*)[CPITCH]>(raw)) {}
};

// Output channel of tile row r: rows [0, BM/2) are real parts, [BM/2, BM)
// their imaginary partners; -1 past the last channel.
template <int BM>
__device__ __forceinline__ int out_channel(int r, int m_tile, int c_half) {
  const int h = BM / 2;
  const int j = m_tile * h + (r < h ? r : r - h);
  if (j >= c_half) return -1;
  return r < h ? j : c_half + j;
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Z rows of frames [t_first, t_first + ZROWS) for channels [ci0, ci0 + BK)
// of input row fi, with the pointwise applied (kGrad: as they are); zero
// outside the tensor.
template <typename T, int BM, bool kGrad>
__device__ __forceinline__ void stage_z(const Smem<T, BM>& sm, const Region& rg, int b, int f_in,
                                        int fi, int ci0, int t_first, int n_time) {
  const T* x = static_cast<const T*>(rg.x) +
               (static_cast<long long>(b) * f_in + fi) * rg.c2 * n_time;
  const int c = rg.c2 / 2;
  const float alpha = kGrad ? 1.f : rg.coef[3 * rg.c2];
  for (int idx = threadIdx.x; idx < BK * ZROWS; idx += THREADS) {
    const int k = idx / ZROWS;
    const int n = idx - k * ZROWS;  // consecutive threads read consecutive frames
    const int ci = ci0 + k;
    const int t = t_first + n;
    float z = 0.f;
    if (ci < rg.c2 && t >= 0 && t < n_time) {
      if constexpr (kGrad) {
        z = to_f32(x[static_cast<long long>(ci) * n_time + t]);
      } else {
        const int partner = ci < c ? ci + c : ci - c;
        const float v = to_f32(x[static_cast<long long>(ci) * n_time + t]);
        const float p = to_f32(x[static_cast<long long>(partner) * n_time + t]);
        z = rg.coef[ci] * v + rg.coef[rg.c2 + ci] * p + rg.coef[2 * rg.c2 + ci];
        z = z >= 0.f ? z : alpha * z;
      }
    }
    sm.z[n][k] = from_f32<T>(z);
  }
}

// Weights of tap jf, both time taps, channels [ci0, ci0 + BK), tile rows.
template <typename T, int BM>
__device__ __forceinline__ void stage_w(const Smem<T, BM>& sm, const Region& rg, int jf, int ci0,
                                        int c2out, int m_tile) {
  constexpr int V = BK * sizeof(T) / 16;  // 16-byte vectors per row
  const T* w = static_cast<const T*>(rg.w);
  for (int idx = threadIdx.x; idx < 2 * BM * V; idx += THREADS) {
    const int v = idx % V;
    const int row = idx / V;
    const int jt = row / BM;
    const int r = row - jt * BM;
    const int co = out_channel<BM>(r, m_tile, c2out / 2);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (co >= 0)
      val = reinterpret_cast<const uint4*>(
          w + (static_cast<long long>(jf * 2 + jt) * c2out + co) * rg.kp + ci0)[v];
    reinterpret_cast<uint4*>(&sm.w[jt][r][0])[v] = val;
  }
}

// kGrad: start of output channel co's row of frames for (b, fo). Without
// y2, row co of y [B, f_out * c2out, T]. With y2 (the decoder's input gradient),
// co counts the joined channels [a_r, s_r, a_i, s_i] of the decoder's
// input: the a channels (c2a of them, r and i) go to y [B, f_out * c2a,
// T], the s channels to y2 [B, f_out * (c2out - c2a), T], each stacked
// [r..., i...].
template <typename T>
__device__ __forceinline__ T* out_row(const Params& p, int b, int fo, int co, int c_half) {
  if (p.y2 == nullptr)
    return static_cast<T*>(p.y) +
           ((static_cast<long long>(b) * p.f_out + fo) * p.c2out + co) * p.n_time;
  const bool imag = co >= c_half;
  const int j = imag ? co - c_half : co;
  const int ca = p.c2a / 2;
  const int c2s = p.c2out - p.c2a;
  if (j < ca)
    return static_cast<T*>(p.y) +
           ((static_cast<long long>(b) * p.f_out + fo) * p.c2a + j + (imag ? ca : 0)) *
               p.n_time;
  return static_cast<T*>(p.y2) +
         ((static_cast<long long>(b) * p.f_out + fo) * c2s + (j - ca) + (imag ? c2s / 2 : 0)) *
             p.n_time;
}

// kDecoder = false: stride-2 conv, input row fi = 2 fo + jf - 2, frames
//   t - 1 + jt (causal zero at t = -1).
// kDecoder = true: stride-2 transposed conv cropped [2:-1] and chomped
//   [1:], input row fi = (fo + jf - 2) / 2 for fo + jf even, frames t + jt
//   (zero at t = T).
// kGrad = true (the input gradients): the input is staged as it is, no
//   bias, no stats, and the output may be split over y and y2 (out_row).
//   A template parameter, so the forward kernels compile as they did.
template <typename T, int BM, bool kDecoder, bool kGrad>
__global__ void __launch_bounds__(THREADS) block_kernel(const Params p) {
  using TL = Tile<BM>;
  __shared__ __align__(16) unsigned char raw[Smem<T, BM>::BYTES];
  const Smem<T, BM> sm(raw);
  const int t0 = blockIdx.x * BN;
  const int fo = blockIdx.y;
  const int b = blockIdx.z / p.m_tiles;
  const int m_tile = blockIdx.z - b * p.m_tiles;
  const int c_half = p.c2out / 2;
  const int t_first = kDecoder ? t0 : t0 - 1;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;  // fragment row / column group
  const int q = lane % 4;  // fragment k pair
  const int wm = warp / TL::WARPS_N;
  const int wn = warp % TL::WARPS_N;

  constexpr bool kMma = sizeof(T) == 2;
  float acc[kMma ? TL::MT * TL::NT * 4 : TL::PER_THREAD];
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(acc) / sizeof(float)); ++i) acc[i] = 0.f;

  for (int reg = 0; reg < p.n_reg; ++reg) {
    const Region& rg = p.reg[reg];
    for (int jf = 0; jf < 5; ++jf) {
      int fi;
      if (kDecoder) {
        if ((fo + jf) & 1) continue;  // even rows take taps 0, 2, 4; odd rows 1, 3
        fi = (fo + jf - 2) / 2;
      } else {
        fi = 2 * fo + jf - 2;
      }
      if (fi < 0 || fi >= p.f_in) continue;
      for (int ci0 = 0; ci0 < rg.c2; ci0 += BK) {
        stage_z<T, BM, kGrad>(sm, rg, b, p.f_in, fi, ci0, t_first, p.n_time);
        stage_w<T, BM>(sm, rg, jf, ci0, p.c2out, m_tile);
        __syncthreads();
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          if constexpr (kMma) {
            uint32_t a[TL::MT][4], bf[TL::NT][2];
#pragma unroll
            for (int i = 0; i < TL::MT; ++i) {
              const T* base = &sm.w[jt][wm * TL::WM + i * 16 + g][2 * q];
              a[i][0] = ld32(base);
              a[i][1] = ld32(base + 8 * PITCH);
              a[i][2] = ld32(base + 8);
              a[i][3] = ld32(base + 8 * PITCH + 8);
            }
#pragma unroll
            for (int j = 0; j < TL::NT; ++j) {
              const T* base = &sm.z[wn * TL::WN + j * 8 + g + jt][2 * q];
              bf[j][0] = ld32(base);
              bf[j][1] = ld32(base + 8);
            }
#pragma unroll
            for (int i = 0; i < TL::MT; ++i)
#pragma unroll
              for (int j = 0; j < TL::NT; ++j) mma_bf16(&acc[(i * TL::NT + j) * 4], a[i], bf[j]);
          } else {
#pragma unroll
            for (int e = 0; e < TL::PER_THREAD; ++e) {
              const int idx = threadIdx.x + e * THREADS;
              const int r = idx / BN;
              const int n = idx - r * BN;
              float s = acc[e];
#pragma unroll
              for (int k = 0; k < BK; ++k)
                s = fmaf(to_f32(sm.w[jt][r][k]), to_f32(sm.z[n + jt][k]), s);
              acc[e] = s;
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // epilogue: f32 tile -> shared memory (the staging buffers are dead)
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < TL::MT; ++i)
#pragma unroll
      for (int j = 0; j < TL::NT; ++j) {
        const float* d = &acc[(i * TL::NT + j) * 4];
        const int row = wm * TL::WM + i * 16 + g;
        const int col = wn * TL::WN + j * 8 + 2 * q;
        sm.c[row][col] = d[0];
        sm.c[row][col + 1] = d[1];
        sm.c[row + 8][col] = d[2];
        sm.c[row + 8][col + 1] = d[3];
      }
  } else {
#pragma unroll
    for (int e = 0; e < TL::PER_THREAD; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      sm.c[idx / BN][idx % BN] = acc[e];
    }
  }
  __syncthreads();

  if constexpr (kGrad) {
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN;
      const int n = idx - r * BN;
      const int co = out_channel<BM>(r, m_tile, c_half);
      const int t = t0 + n;
      if (co >= 0 && t < p.n_time) out_row<T>(p, b, fo, co, c_half)[t] = from_f32<T>(sm.c[r][n]);
    }
    return;
  }
  T* y = static_cast<T*>(p.y);
  const long long row0 = static_cast<long long>(b) * p.f_out * p.c2out + fo * p.c2out;
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int n = idx - r * BN;
    const int co = out_channel<BM>(r, m_tile, c_half);
    const int t = t0 + n;
    if (co >= 0 && t < p.n_time)
      y[(row0 + co) * p.n_time + t] = from_f32<T>(sm.c[r][n] + p.bias[co]);
  }
  if (p.stats != nullptr && threadIdx.x < BM) {
    const int r = threadIdx.x;
    const int co = out_channel<BM>(r, m_tile, c_half);
    if (co >= 0) {
      const int pr = r < BM / 2 ? r + BM / 2 : r - BM / 2;
      const float br = p.bias[co];
      const float bp = p.bias[out_channel<BM>(pr, m_tile, c_half)];
      const int n_valid = min(BN, p.n_time - t0);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int n = 0; n < n_valid; ++n) {
        const float v = sm.c[r][n] + br;
        s0 += v;
        s1 += v * v;
        s2 += v * (sm.c[pr][n] + bp);
      }
      float* dst = p.stats + (row0 + co) * 8;
      atomicAdd(dst, s0);
      atomicAdd(dst + 1, s1);
      atomicAdd(dst + 2, s2);
    }
  }
}

template <typename T, bool kDecoder, bool kGrad = false>
int launch(Params p, int batch, cudaStream_t stream) {
  if (batch <= 0 || p.n_time <= 0 || p.f_in <= 0 || p.c2out <= 0 || p.c2out % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kGrad ? (p.stats != nullptr ||
               (p.y2 != nullptr && (p.c2a <= 0 || p.c2a % 2 != 0 || p.c2a >= p.c2out)))
            : (p.y2 != nullptr || p.bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < p.n_reg; ++i)
    if (p.reg[i].c2 <= 0 || p.reg[i].c2 % 2 != 0 || p.reg[i].kp % BK != 0 ||
        p.reg[i].kp < p.reg[i].c2)
      return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2) {
    // bf16, rows 3 to 5 and 7 of PERF.md's table: block_mma.cuh, on weights
    // packed pair-interleaved for the tile (bm, nb)
    blockmma::Params q{};
    for (int i = 0; i < p.n_reg; ++i) {
      const Region& rg = p.reg[i];
      if (rg.kp != BK * ((rg.c2 / 2 + 7) / 8)) return static_cast<int>(cudaErrorInvalidValue);
      q.reg[i] = {static_cast<const blockmma::bf16*>(rg.x), rg.coef,
                  static_cast<const blockmma::bf16*>(rg.w), rg.c2, rg.kp / BK};
    }
    q.n_reg = p.n_reg;
    q.bias = p.bias;
    q.y = static_cast<blockmma::bf16*>(p.y);
    q.stats = p.stats;
    q.y2 = static_cast<blockmma::bf16*>(p.y2);
    q.c2a = p.c2a;
    q.batch = batch;
    q.f_in = p.f_in;
    q.f_out = p.f_out;
    q.c2out = p.c2out;
    q.n_time = p.n_time;
    return blockmma::launch<kDecoder, kGrad>(q, p.bm, p.nb, p.pair != 0, stream);
  } else {
    // block_kernel: the f32 variants
    const int bm = p.c2out <= 16 ? 16 : p.c2out <= 32 ? 32 : p.c2out <= 64 ? 64 : 128;
    p.m_tiles = (p.c2out / 2 + bm / 2 - 1) / (bm / 2);
    const long long z = static_cast<long long>(batch) * p.m_tiles;
    if (z > 65535 || p.f_out > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((p.n_time + BN - 1) / BN, p.f_out, static_cast<unsigned>(z));
    switch (bm) {
      case 16: block_kernel<T, 16, kDecoder, kGrad><<<grid, THREADS, 0, stream>>>(p); break;
      case 32: block_kernel<T, 32, kDecoder, kGrad><<<grid, THREADS, 0, stream>>>(p); break;
      case 64: block_kernel<T, 64, kDecoder, kGrad><<<grid, THREADS, 0, stream>>>(p); break;
      default: block_kernel<T, 128, kDecoder, kGrad><<<grid, THREADS, 0, stream>>>(p); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace blockgemm
