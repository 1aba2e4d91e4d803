// Weight gradient of a DCCRN block as a split-K GEMM on Hopper (sm_90a).
//
// Shared by conv_block_bwd.cu (encoder block) and deconv_block_bwd.cu
// (decoder block); each source instantiates only its own indexing. For the
// activated input z (recomputed and rounded to the activation type by the
// caller) and the output gradient g [B, f_out * C2out, T]:
//
//   dW[jf, jt, ci, co] = sum over (b, fo, t) of
//                        Z[b, fi(fo, jf), ci, t + shift(jt)] * G[b, fo, co, t]
//
//   encoder: fi = 2 fo + jf - 2, shift = jt - 1 (the causal pad);
//   decoder: fi = (fo + jf - 2) / 2 for fo + jf even, shift = jt;
//   Z = 0 outside [0, f_in) x [0, T).
//
// A GEMM per tap (jf, jt) with M = C2in, N = C2out (at most 512 x 256) and
// K = B x (rows) x T, up to 10.5 M at B = 128 (enc0). Blocks split K:
// grid (channel tiles, jf, split); split s walks the steps [s * steps / S,
// (s + 1) * steps / S) of the (b, fo, frame chunk) list in order, skips
// the rows that tap jf does not reach, and writes its own f32 partial tile
// into part[s, jf, jt] [S, 5, 2, C2tot, C2out]; the caller sums the S
// partials (torch.sum), so no atomics and the order of every sum is fixed.
// Each step stages g for BK frames of BN output channels once and Z for
// both time taps (two shifted copies, so the mma fragments stay aligned),
// then runs mma.sync m16n8k16 (bf16 in, f32 accumulate) for both taps; f32
// runs plain FMA (no TF32). 128 threads: 4 warps over a WARPS_M x WARPS_N
// grid of WM x WN warp tiles, and the rest over the chunk's K steps
// (WARPS_K > 1 on the small tiles), summed through shared memory at the end.
// Rows past C2in and columns past C2out stage as zeros and are not stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dwgemm {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <typename T> struct Chunk {
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // frames per step
  static constexpr int PITCH = BK + 8;  // staged row pitch: conflict-free fragment loads
};

struct Region {
  const void* z;  // [B, f_in * c2, T], activation type
  int c2;         // channels (r and i stacked) of a frequency row
  int row0;       // first row of its channels in the partials' C2tot axis
  int m_tiles;    // tiles of BM channels
};

struct Params {
  Region reg[2];
  int n_reg;
  const void* g;  // [B, f_out * c2out, T], activation type
  float* part;    // [splits, 5, 2, c2tot, c2out] f32
  int batch, f_in, f_out, c2out, c2tot, n_time, splits, n_tiles;
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <int BM, int BN> struct Tile {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = BN / 16 < WARPS / WARPS_M ? BN / 16 : WARPS / WARPS_M;
  static constexpr int WARPS_K = WARPS / (WARPS_M * WARPS_N);
  static constexpr int WM = BM / WARPS_M;  // 16 or 32
  static constexpr int WN = BN / WARPS_N;  // 16 or 32
  static constexpr int MT = WM / 16;       // m16 fragments per warp
  static constexpr int NT = WN / 8;        // n8 fragments per warp
  static constexpr int ACC = 2 * MT * NT * 4;  // both time taps
  static_assert(WARPS_M * WARPS_N * WARPS_K == WARPS, "warp grid");
};

template <typename T, int BM, int BN> struct Smem {
  using C = Chunk<T>;
  using TL = Tile<BM, BN>;
  static constexpr int Z_BYTES = 2 * BM * C::PITCH * sizeof(T);
  static constexpr int G_BYTES = BN * C::PITCH * sizeof(T);
  static constexpr int R_BYTES =
      (TL::WARPS_K - 1) * TL::WARPS_M * TL::WARPS_N * TL::ACC * 32 * sizeof(float);
  static constexpr int BYTES = Z_BYTES + G_BYTES > R_BYTES ? Z_BYTES + G_BYTES : R_BYTES;
  static_assert(Z_BYTES % 16 == 0, "g must start 16-byte aligned");

  T (*z)[BM][C::PITCH];
  T (*g)[C::PITCH];
  float* red;

  __device__ explicit Smem(unsigned char* raw)
      : z(reinterpret_cast<T (*)[BM][C::PITCH]>(raw)),
        g(reinterpret_cast<T (*)[C::PITCH]>(raw + Z_BYTES)),
        red(reinterpret_cast<float*>(raw)) {}
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Input row of output row fo under frequency tap jf, or -1 if none.
template <bool kDecoder>
__device__ __forceinline__ int input_row(int fo, int jf, int f_in) {
  int fi;
  if (kDecoder) {
    if ((fo + jf) & 1) return -1;
    fi = (fo + jf - 2) / 2;
  } else {
    fi = 2 * fo + jf - 2;
  }
  return fi >= 0 && fi < f_in ? fi : -1;
}

template <typename T, int BM, int BN, bool kDecoder>
__global__ void __launch_bounds__(THREADS) dw_kernel(const Params p) {
  using C = Chunk<T>;
  using TL = Tile<BM, BN>;
  constexpr int BK = C::BK;
  __shared__ __align__(16) unsigned char raw[Smem<T, BM, BN>::BYTES];
  const Smem<T, BM, BN> sm(raw);

  // channel tile: regions' M tiles in order, each with n_tiles N tiles
  int tile = blockIdx.x / p.n_tiles;
  const int n_tile = blockIdx.x - tile * p.n_tiles;
  const bool second = p.n_reg > 1 && tile >= p.reg[0].m_tiles;
  if (second) tile -= p.reg[0].m_tiles;
  const Region rg = second ? p.reg[1] : p.reg[0];
  const int ci0 = tile * BM;
  const int co0 = n_tile * BN;
  const int jf = blockIdx.y;
  const int split = blockIdx.z;

  const int chunks = (p.n_time + BK - 1) / BK;
  const long long steps = static_cast<long long>(p.batch) * p.f_out * chunks;
  const long long first = steps * split / p.splits;
  const long long last = steps * (split + 1) / p.splits;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int wk = warp / (TL::WARPS_M * TL::WARPS_N);
  const int wmn = warp - wk * TL::WARPS_M * TL::WARPS_N;
  const int wm = wmn / TL::WARPS_N;
  const int wn = wmn - wm * TL::WARPS_N;

  constexpr bool kMma = sizeof(T) == 2;
  constexpr int PER_THREAD = 2 * BM * BN / THREADS;  // f32 path outputs
  float acc[kMma ? TL::ACC : PER_THREAD];
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(acc) / sizeof(float)); ++i) acc[i] = 0.f;

  const T* gsrc = static_cast<const T*>(p.g);
  const T* zsrc = static_cast<const T*>(rg.z);
  for (long long step = first; step < last; ++step) {
    const int b = static_cast<int>(step / (static_cast<long long>(p.f_out) * chunks));
    const int rem = static_cast<int>(step - static_cast<long long>(b) * p.f_out * chunks);
    const int fo = rem / chunks;
    const int t0 = (rem - fo * chunks) * BK;
    const int fi = input_row<kDecoder>(fo, jf, p.f_in);
    if (fi < 0) continue;  // the same for every thread of the block

    const T* grow = gsrc + (static_cast<long long>(b) * p.f_out + fo) * p.c2out * p.n_time;
    for (int idx = threadIdx.x; idx < BN * BK; idx += THREADS) {
      const int n = idx / BK;
      const int k = idx - n * BK;  // consecutive threads read consecutive frames
      const int co = co0 + n;
      const int t = t0 + k;
      sm.g[n][k] = co < p.c2out && t < p.n_time
                       ? grow[static_cast<long long>(co) * p.n_time + t]
                       : zero<T>();
    }
    const T* zrow = zsrc + (static_cast<long long>(b) * p.f_in + fi) * rg.c2 * p.n_time;
    for (int idx = threadIdx.x; idx < 2 * BM * BK; idx += THREADS) {
      const int jt = idx / (BM * BK);
      const int r = idx - jt * BM * BK;
      const int m = r / BK;
      const int k = r - m * BK;
      const int ci = ci0 + m;
      const int t = t0 + k + (kDecoder ? jt : jt - 1);
      sm.z[jt][m][k] = ci < rg.c2 && t >= 0 && t < p.n_time
                           ? zrow[static_cast<long long>(ci) * p.n_time + t]
                           : zero<T>();
    }
    __syncthreads();
    if constexpr (kMma) {
#pragma unroll
      for (int ks = wk; ks < BK / 16; ks += TL::WARPS_K) {
        const int kk = ks * 16;
        uint32_t bf[TL::NT][2];
#pragma unroll
        for (int j = 0; j < TL::NT; ++j) {
          const T* base = &sm.g[wn * TL::WN + j * 8 + g][kk + 2 * q];
          bf[j][0] = ld32(base);
          bf[j][1] = ld32(base + 8);
        }
#pragma unroll
        for (int jt = 0; jt < 2; ++jt)
#pragma unroll
          for (int i = 0; i < TL::MT; ++i) {
            const T* base = &sm.z[jt][wm * TL::WM + i * 16 + g][kk + 2 * q];
            uint32_t a[4];
            a[0] = ld32(base);
            a[1] = ld32(base + 8 * C::PITCH);
            a[2] = ld32(base + 8);
            a[3] = ld32(base + 8 * C::PITCH + 8);
#pragma unroll
            for (int j = 0; j < TL::NT; ++j)
              mma_bf16(&acc[((jt * TL::MT + i) * TL::NT + j) * 4], a, bf[j]);
          }
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int idx = threadIdx.x + e * THREADS;
        const int jt = idx / (BM * BN);
        const int r = idx - jt * BM * BN;
        const int m = r / BN;
        const int n = r - m * BN;
        float s = acc[e];
        for (int k = 0; k < BK; ++k) s = fmaf(to_f32(sm.z[jt][m][k]), to_f32(sm.g[n][k]), s);
        acc[e] = s;
      }
    }
    __syncthreads();
  }

  float* out = p.part + (static_cast<long long>(split) * 5 + jf) * 2 * p.c2tot * p.c2out;
  const long long tap = static_cast<long long>(p.c2tot) * p.c2out;  // one (jf, jt) slice
  if constexpr (kMma) {
    if constexpr (TL::WARPS_K > 1) {  // sum the K-split warps through shared memory
      if (wk > 0) {
#pragma unroll
        for (int i = 0; i < TL::ACC; ++i)
          sm.red[(((wk - 1) * TL::WARPS_M * TL::WARPS_N + wmn) * TL::ACC + i) * 32 + lane] =
              acc[i];
      }
      __syncthreads();
      if (wk > 0) return;
      for (int w = 1; w < TL::WARPS_K; ++w) {
#pragma unroll
        for (int i = 0; i < TL::ACC; ++i)
          acc[i] += sm.red[(((w - 1) * TL::WARPS_M * TL::WARPS_N + wmn) * TL::ACC + i) * 32 +
                           lane];
      }
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int i = 0; i < TL::MT; ++i)
#pragma unroll
        for (int j = 0; j < TL::NT; ++j) {
          const float* d = &acc[((jt * TL::MT + i) * TL::NT + j) * 4];
          const int col = co0 + wn * TL::WN + j * 8 + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ci = ci0 + wm * TL::WM + i * 16 + g + 8 * h;
            if (ci >= rg.c2) continue;
            float* row = out + jt * tap + static_cast<long long>(rg.row0 + ci) * p.c2out;
            if (col < p.c2out) row[col] = d[2 * h];
            if (col + 1 < p.c2out) row[col + 1] = d[2 * h + 1];
          }
        }
  } else {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int idx = threadIdx.x + e * THREADS;
      const int jt = idx / (BM * BN);
      const int r = idx - jt * BM * BN;
      const int ci = ci0 + r / BN;
      const int co = co0 + r % BN;
      if (ci < rg.c2 && co < p.c2out)
        out[jt * tap + static_cast<long long>(rg.row0 + ci) * p.c2out + co] = acc[e];
    }
  }
}

// Launches dw_kernel with the tile (bm, bn) the caller chose: bf16 takes
// bm, bn in {16, 32, 64}, f32 only (32, 32). The caller sized part for
// p.splits and set each region's z, c2 and row0.
template <typename T, bool kDecoder>
int launch(Params p, int bm, int bn, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  const bool tile_ok = kMma ? ((bm == 16 || bm == 32 || bm == 64) &&
                               (bn == 16 || bn == 32 || bn == 64))
                            : (bm == 32 && bn == 32);
  if (!tile_ok || p.batch <= 0 || p.n_time <= 0 || p.f_in <= 0 || p.f_out <= 0 ||
      p.c2out <= 0 || p.splits <= 0 || p.splits > 65535 || p.n_reg < 1 || p.n_reg > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int m_tiles = 0;
  for (int i = 0; i < p.n_reg; ++i) {
    if (p.reg[i].c2 <= 0 || p.reg[i].row0 < 0 || p.reg[i].row0 + p.reg[i].c2 > p.c2tot)
      return static_cast<int>(cudaErrorInvalidValue);
    p.reg[i].m_tiles = (p.reg[i].c2 + bm - 1) / bm;
    m_tiles += p.reg[i].m_tiles;
  }
  p.n_tiles = (p.c2out + bn - 1) / bn;
  const dim3 grid(static_cast<unsigned>(m_tiles * p.n_tiles), 5, static_cast<unsigned>(p.splits));
  if constexpr (!kMma) {
    dw_kernel<T, 32, 32, kDecoder><<<grid, THREADS, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  } else {
#define DWGEMM_CASE(BM_, BN_)                                         \
    if (bm == BM_ && bn == BN_) {                                     \
      dw_kernel<T, BM_, BN_, kDecoder><<<grid, THREADS, 0, stream>>>(p); \
      return static_cast<int>(cudaGetLastError());                    \
    }
    DWGEMM_CASE(16, 16) DWGEMM_CASE(16, 32) DWGEMM_CASE(16, 64)
    DWGEMM_CASE(32, 16) DWGEMM_CASE(32, 32) DWGEMM_CASE(32, 64)
    DWGEMM_CASE(64, 16) DWGEMM_CASE(64, 32) DWGEMM_CASE(64, 64)
#undef DWGEMM_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dwgemm
