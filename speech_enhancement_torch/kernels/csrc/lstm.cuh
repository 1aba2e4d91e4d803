// The resident-weight LSTM recurrence on Hopper (sm_90a): what the forward
// (lstm_fwd.cu) and backward (lstm_bwd.cu) kernels share.
//
// Both are persistent cooperative kernels: one launch walks all T steps.
// The grid holds G = ceil(H / U) blocks of 256 threads, at most one per SM
// (U = ceil(H / SMs) hidden units each, 14 at H = 1792 on 132 SMs), and
// every block keeps its slice of the recurrent weights in shared memory for
// the whole launch: the weights are read from device memory once.
//
// Each step is a product [rows x K] (the block's weight slice, resident)
// times [K x B] (a sequence tensor of the step before, or of this step,
// written by every block and read from L2 with ld.global.cg), done in batch
// chunks of NB <= 64 columns and reduction chunks of KC elements
// (NB * KC = 4096): a chunk is staged in shared memory with 16-byte loads,
// the next chunk's loads are issued into registers before the current one
// is multiplied, so device-memory latency overlaps the product, and each
// block walks the chunks from its own starting point, so the blocks do not
// all ask the same L2 lines for the same chunk at once.
//   bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) on the slice's m16
//         row tiles x the chunk's n8 column tiles; when there are fewer
//         tiles than the 8 warps, the warps split the chunk's k16 steps
//         and their f32 partials are summed in a fixed order.
//   f32:  full-f32 FMA (no TF32), each thread up to 16 outputs.
// A grid-wide barrier (grid_sync: an arrival counter and a generation word
// in device memory, __threadfence() before arriving and after leaving)
// separates the steps that exchange data between blocks.
// The bf16 paths with 16-byte rows do not use gemm_chunk: the forward
// streams h_prev through a cp.async ring and runs its gate math from the
// mma registers (lstm_fwd.cu, lstm_fwd_ring), the backward streams each
// warp's K range of dgates through a ring of its own and keeps dh and dc in
// registers (lstm_bwd.cu, lstm_bwd_ring); both share the grid barrier, the
// unit split and the cooperative launch below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_gemm.cuh"

namespace lstm {

using blockgemm::from_f32;
using blockgemm::ld32;
using blockgemm::mma_bf16;
using blockgemm::to_f32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_UNITS = 16;       // forward rows 4U <= 64: four m16 tiles
constexpr int MAX_NB = 64;          // batch columns per chunk
constexpr int STAGE_ELEMS = 4096;   // NB * KC
constexpr int SPAD = 8;             // staged row padding: conflict-free fragment loads
constexpr int MAX_OUT = 16;         // f32 outputs per thread: 64 rows x 64 columns / 256

// Computed on the host from the shapes; the kernel and the occupancy check
// use the same numbers.
struct Plan {
  int units;         // hidden units a block owns (U)
  int rows;          // rows of its weight slice: 4U forward, U backward
  int k;             // reduction length: H forward, 4H backward
  int pitch;         // shared-memory row pitch of the slice (elements): k rounded up to KC, + 8
  int nb;            // batch columns per chunk
  int kc;            // reduction elements per staged chunk
  int splits;        // warps' split of a chunk's k16 steps (1: a warp per tile)
  int stage_offset;  // bytes: the slice, then the staged chunk, then the f32 partials
  int out_offset;
  int smem_bytes;
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) / 16 * 16; }

inline Plan make_plan(int elem_bytes, int units, int rows, int k, int batch) {
  Plan p;
  p.units = units;
  p.rows = rows;
  p.k = k;
  p.nb = (batch + 7) / 8 * 8;
  if (p.nb > MAX_NB) p.nb = MAX_NB;
  int kc = STAGE_ELEMS / p.nb / 64 * 64;
  if (kc < 64) kc = 64;
  const int k64 = (k + 63) / 64 * 64;
  p.kc = kc < k64 ? kc : k64;
  p.pitch = (k + p.kc - 1) / p.kc * p.kc + SPAD;
  const int mt = (rows + 15) / 16;
  const int tiles = mt * (p.nb / 8);
  int splits = 1;
  if (elem_bytes == 2 && tiles < WARPS) {
    splits = WARPS / tiles;
    if (splits > p.kc / 16) splits = p.kc / 16;
  }
  p.splits = splits;
  p.stage_offset = align16(rows * p.pitch * elem_bytes);
  p.out_offset = p.stage_offset + align16(p.nb * (p.kc + SPAD) * elem_bytes);
  p.smem_bytes = p.out_offset + splits * mt * 16 * p.nb * 4;
  return p;
}

// One element through L2 (ld.global.cg): the sequence tensors are written
// by other blocks during the launch, so no L1 line may serve them.
template <typename T> __device__ __forceinline__ T ldcg(const T* p);
template <> __device__ __forceinline__ float ldcg<float>(const float* p) { return __ldcg(p); }
template <>
__device__ __forceinline__ __nv_bfloat16 ldcg<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Grid-wide barrier over the launch's co-resident blocks. bar[0] counts
// arrivals, bar[1] is the generation; both start at 0 (the wrapper zeroes
// them). The last block to arrive resets the count and advances the
// generation; the others wait for it to move. The fences make every write
// made before the barrier visible to every block after it.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Register-staged chunk loads: [NB rows b][KC elements k] of a row-major
// [n_total, ldb] tensor, 16 bytes a load, zero outside the tensor.
template <typename T> struct Stager {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PER_THREAD = STAGE_ELEMS / V / THREADS;
  uint4 r[PER_THREAD];

  __device__ __forceinline__ void load(const Plan& p, const T* src, int ldb, int n_total, int n0,
                                       int k0) {
    const int per_row = p.kc / V;
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) {
      const int idx = threadIdx.x + v * THREADS;
      r[v] = make_uint4(0u, 0u, 0u, 0u);
      const int n = idx / per_row;
      const int k = k0 + (idx - n * per_row) * V;
      if (n < p.nb && n0 + n < n_total && k < p.k)
        r[v] = __ldcg(
            reinterpret_cast<const uint4*>(src + static_cast<long long>(n0 + n) * ldb + k));
    }
  }

  __device__ __forceinline__ void store(const Plan& p, T* stage) const {
    const int per_row = p.kc / V;
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) {
      const int idx = threadIdx.x + v * THREADS;
      const int n = idx / per_row;
      if (n < p.nb)
        *reinterpret_cast<uint4*>(stage + n * (p.kc + SPAD) + (idx - n * per_row) * V) = r[v];
    }
  }
};

// Element by element, for shapes whose rows are not 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_scalar(const Plan& p, const T* src, int ldb, int n_total,
                                             int n0, int k0, T* stage) {
  for (int idx = threadIdx.x; idx < p.nb * p.kc; idx += THREADS) {
    const int n = idx / p.kc;
    const int kk = idx - n * p.kc;
    const int k = k0 + kk;
    stage[n * (p.kc + SPAD) + kk] =
        (n0 + n < n_total && k < p.k) ? ldcg(src + static_cast<long long>(n0 + n) * ldb + k)
                                      : from_f32<T>(0.f);
  }
}

// out[split][row][n] = sum over k (this warp's share) of ws[row][k] * src[n0 + n][k]
// for the block's weight slice ws (shared memory, [rows][pitch], zero past k)
// and columns n < NB of batch chunk n0 of src [n_total, ldb]. Ends with a
// __syncthreads(); the caller sums the splits (out holds splits x mpad x NB).
template <typename T>
__device__ void gemm_chunk(const Plan& p, const T* __restrict__ ws, const T* __restrict__ src,
                           int ldb, int n_total, int n0, bool vec, T* stage, float* out) {
  constexpr bool kMma = sizeof(T) == 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int nt = p.nb / 8;
  const int mpad = (p.rows + 15) / 16 * 16;
  const int tiles = (mpad / 16) * nt;
  const int spitch = p.kc + SPAD;
  const int split = p.splits == 1 ? 0 : warp / tiles;
  const bool active = warp < tiles * p.splits || p.splits == 1;

  float acc[kMma ? 4 : MAX_OUT][4];
#pragma unroll
  for (int i = 0; i < (kMma ? 4 : MAX_OUT); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  Stager<T> st;
  // every block reads the same src; each starts at its own reduction chunk,
  // so the blocks' requests spread over the L2 slices instead of all
  // hitting the same lines at once
  const int chunks = (p.k + p.kc - 1) / p.kc;
  const int first = blockIdx.x % chunks;
  const auto chunk_k0 = [&](int c) {
    const int r = c + first;
    return (r < chunks ? r : r - chunks) * p.kc;
  };
  if (vec) st.load(p, src, ldb, n_total, n0, chunk_k0(0));
  for (int c = 0; c < chunks; ++c) {
    const int k0 = chunk_k0(c);
    __syncthreads();  // the previous chunk's readers are done with the stage
    if (vec) {
      st.store(p, stage);
    } else {
      stage_scalar(p, src, ldb, n_total, n0, k0, stage);
    }
    __syncthreads();
    if (vec && c + 1 < chunks) st.load(p, src, ldb, n_total, n0, chunk_k0(c + 1));
    if constexpr (kMma) {
      if (active) {
        for (int ks = split; ks < p.kc / 16; ks += p.splits) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int tile = p.splits == 1 ? warp + i * WARPS : (i == 0 ? warp % tiles : tiles);
            if (tile < tiles) {
              const int m = tile / nt;
              const int n = tile - m * nt;
              const int row = m * 16 + g;
              const T* a0 = ws + static_cast<long long>(row) * p.pitch + k0 + ks * 16 + 2 * q;
              uint32_t a[4], b[2];
              a[0] = row < p.rows ? ld32(a0) : 0u;
              a[2] = row < p.rows ? ld32(a0 + 8) : 0u;
              a[1] = row + 8 < p.rows ? ld32(a0 + 8 * p.pitch) : 0u;
              a[3] = row + 8 < p.rows ? ld32(a0 + 8 * p.pitch + 8) : 0u;
              const T* b0 = stage + (n * 8 + g) * spitch + ks * 16 + 2 * q;
              b[0] = ld32(b0);
              b[1] = ld32(b0 + 8);
              mma_bf16(acc[i], a, b);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < MAX_OUT; ++e) {
        const int o = threadIdx.x + e * THREADS;
        if (o < p.rows * p.nb) {
          const int r = o / p.nb;
          const T* wr = ws + static_cast<long long>(r) * p.pitch + k0;
          const T* hr = stage + (o - r * p.nb) * spitch;
          float s = acc[e][0];
          for (int kk = 0; kk < p.kc; ++kk) s = fmaf(to_f32(wr[kk]), to_f32(hr[kk]), s);
          acc[e][0] = s;
        }
      }
    }
  }

  if constexpr (kMma) {
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tile = p.splits == 1 ? warp + i * WARPS : (i == 0 ? warp % tiles : tiles);
        if (tile < tiles) {
          const int m = tile / nt;
          const int row = m * 16 + g;
          const int col = (tile - m * nt) * 8 + 2 * q;
          float* o = out + (static_cast<long long>(split) * mpad + row) * p.nb + col;
          o[0] = acc[i][0];
          o[1] = acc[i][1];
          o[8 * p.nb] = acc[i][2];
          o[8 * p.nb + 1] = acc[i][3];
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < MAX_OUT; ++e) {
      const int o = threadIdx.x + e * THREADS;
      if (o < p.rows * p.nb) out[o] = acc[e][0];  // row r = o / NB, column o % NB
    }
  }
  __syncthreads();
}

// Sum of the splits' partials of output (row, n).
__device__ __forceinline__ float gathered(const Plan& p, const float* out, int row, int n) {
  const int mpad = (p.rows + 15) / 16 * 16;
  float s = 0.f;
  for (int sp = 0; sp < p.splits; ++sp) s += out[(sp * mpad + row) * p.nb + n];
  return s;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Units per block and blocks for hidden width H, or 0 when H needs more
// than MAX_UNITS a block on this card.
inline int units_per_block(int hidden, int sms) {
  const int units = (hidden + sms - 1) / sms;
  return units <= MAX_UNITS ? units : 0;
}

// Cooperative launch of kernel(args, plan) on `blocks` blocks, after
// checking that they all fit on the card at once (a grid barrier over
// blocks that are not all resident would never return).
template <typename Args, typename P>
int launch(void (*kernel)(Args, P), const Args& args, const P& plan, int blocks,
           cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0, occupancy = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.smem_bytes > optin) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, THREADS,
                                                        plan.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occupancy * sms < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args a = args;
  P p = plan;
  void* params[] = {&a, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(THREADS),
                                    params, static_cast<size_t>(plan.smem_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

inline int multiprocessors() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace lstm
