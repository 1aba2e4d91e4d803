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
// unit split and the cooperative launch below. Nor do the f32 paths whose
// plan fits (namespace tc below: lstm_fwd_f32, lstm_bwd_f32): split-f32
// products on tensor cores in the backward ring's structure. gemm_chunk is
// left to bf16 rows that are not 16-byte aligned and to the f32 shapes that
// no split-f32 plan takes (wider than about 790 units, H % 4 != 0 in the
// forward, more than 16 x 256 (b, u) pairs a block, unaligned pointers).
// Where even the first design's slice does not fit beside its staging, the
// wide designs (namespace wide below: lstm_fwd_wide, lstm_bwd_wide) keep
// only part of the slice resident and read the rest every step.
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

// The shared memory a block may opt in to on this card (optin); returns a
// cudaError_t.
inline int optin_smem(int& optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

inline int multiprocessors() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

// cp.async.wait_group takes an immediate: a ring's depth is a plan value.
__device__ __forceinline__ void wait_rounds(int n) {
  switch (n) {
    case 0: mmautil::cp_async_wait<0>(); break;
    case 1: mmautil::cp_async_wait<1>(); break;
    case 2: mmautil::cp_async_wait<2>(); break;
    case 3: mmautil::cp_async_wait<3>(); break;
    case 4: mmautil::cp_async_wait<4>(); break;
    case 5: mmautil::cp_async_wait<5>(); break;
    default: mmautil::cp_async_wait<6>(); break;
  }
}

// -- the split-f32 designs -----------------------------------------------------
//
// lstm_fwd_f32 (lstm_fwd.cu) and lstm_bwd_f32 (lstm_bwd.cu) share the
// structure of the bf16 backward's ring: the step's product takes the batch
// as the mma's M (m16 tiles of 16 rows; B 8 is half a tile, its other rows
// zero-filled), the block's columns as N and a sequence tensor's row as K
// (forward: h_prev, K = H, columns 4u + gate, unit-major; backward:
// dgates[t], K = 4H, column u). The eight warps split into wm along the
// batch and wk along K; each streams its own rows and K range of the
// tensor, which other blocks write during the launch, through a cp.async.cg
// ring of its own (16 bytes a copy, zero-filled past B and K, one commit
// group a round, published by a warp barrier), so the K loop has no block
// barrier. A round is KC = 32 k: a slab of mw * 16 rows x 32 floats at a
// row pitch of 36 floats (4 words mod 32), so the ldmatrix.x4 that reads an
// m16 x k8 TF32 fragment (rows 0-7 | 8-15 x words 0-3 | 4-7) hits eight
// distinct 16-byte bank groups a phase.
//
// The products are split-f32 (3xTF32, as stft.cu's): one TF32 product keeps
// 10 mantissa bits, too few for the f32 path's 1e-4, so each operand is
// split into a TF32 big part and the TF32 rounding of the rest, and three
// mma.sync m16n8k8 (small x big + big x small + big x big) sum in f32. The
// slice (the block's weights) is split once, at load, and kept resident in
// the mma's fragment order: element [k8 step s][n8 tile n][column c][q] is a
// float4 {big b0, big b1, small b0, small b1}, b0 = W[8s + q][8n + c], b1 =
// W[8s + q + 4][8n + c], so lane (c, q) reads its B fragment with one 16-byte
// load, and the 32 lanes read consecutive words (a column past `cols` reads
// column cols - 1 and is zeroed in registers). The ring's A fragments are
// split in registers as they are loaded. Both splits run on the integer and
// FMA pipes (mmautil::split_tf32: the big part rounded, the small part
// truncated), not by cvt.rna.tf32.
//
// Each warp writes its f32 partials once a chunk into its own ring (no copy
// is then in flight), and after one block barrier the thread that owns (b,
// u) sums the K splits in a fixed order and runs the pointwise part from
// registers: the columns of one unit sit side by side (the forward's four
// gates are one float4), and the thread keeps its carries (the forward's c,
// the backward's dh and dc) in registers across all T steps.
namespace tc {

constexpr int KC = 32;       // k a round
constexpr int SP = KC + 4;   // slab row pitch (floats)
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 8;
// fixed costs in k of one m16 tile's split products, as the bf16 backward's
// ROUND_K and CHUNK_K (lstm_bwd.cu) with a k of split products costing
// about six of bf16's: a round's wait, copies and loop, a chunk's ring fill
constexpr int ROUND_K = 8;
constexpr int CHUNK_K = 64;

// m16 batch tiles a warp holds: the accumulators are mw * nt * 4 floats
__host__ __device__ constexpr int max_mw(int nt) { return nt <= 2 ? 4 : 2; }

// Computed on the host from the shapes (make_plan below); mirrored line for
// line by kernels/lstm.py:f32_plan.
struct Plan {
  int units;        // U
  int nt;           // n8 column tiles: ceil(4U / 8) forward, 1 backward
  int cols;         // columns a tile of the slice stores: 8 forward, U backward
  int k;            // K: H forward, 4H backward
  int kr;           // rounds over K: ceil(K / KC)
  int stages;       // slabs in each warp's ring
  int wm, wk;       // warps along the batch and along K (wm * wk = 8)
  int mw;           // m16 batch tiles a warp holds
  int nb;           // batch rows a chunk: wm * mw * 16
  int chunks;       // ceil(B / nb)
  int rpw;          // rounds a K split: ceil(kr / wk)
  int pitch;        // floats a partial row: 16 (nt / 2) + 8 (conflict-free float2 stores)
  int slab_bytes;   // mw * 16 * SP * 4
  int region;       // bytes of a warp's ring; its partials alias it
  int ring_offset;  // bytes of the split slice: kr * KC / 8 k8 steps x nt x cols x 64
  int ppt;          // (b, u) pairs a thread owns: 1, 4 or 16
  int smem_bytes;
};

// False where no plan fits (the caller then takes the first design): more
// than 8 columns a tile, more than 16 x 256 (b, u) pairs a block, or no
// ring of MIN_STAGES slabs beside the split slice.
inline bool make_plan(int units, int nt, int cols, int k, int batch, int smem_limit,
                      Plan& best) {
  if (units <= 0 || cols > 8 || nt < 1 || nt > 4) return false;
  const long long pairs = static_cast<long long>(batch) * units;
  const int ppt = pairs <= THREADS ? 1 : pairs <= 4 * THREADS ? 4 : pairs <= 16 * THREADS ? 16 : 0;
  if (ppt == 0) return false;
  const int kr = (k + KC - 1) / KC;
  const long long slice = static_cast<long long>(kr) * (KC / 8) * nt * cols * 64;
  if (slice >= smem_limit) return false;
  const int ring_offset = static_cast<int>(slice);
  const int region_max = (smem_limit - ring_offset) / WARPS / 16 * 16;
  const int pitch = 16 * (nt / 2) + 8;
  long long best_cost = 0;
  int best_flight = 0;
  for (int wm = 1; wm <= WARPS; wm *= 2) {
    const int wk = WARPS / wm;
    for (int mw = 1; mw <= max_mw(nt); ++mw) {
      const int slab = mw * 16 * SP * 4;
      const int part = mw * 16 * pitch * 4;
      int stages = region_max / slab;
      if (stages > MAX_STAGES) stages = MAX_STAGES;
      if (stages < MIN_STAGES) continue;
      const int region = stages * slab > part ? stages * slab : part;
      if (region > region_max) continue;
      const int nb = wm * mw * 16;
      const int chunks = (batch + nb - 1) / nb;
      const int rpw = (kr + wk - 1) / wk;
      // the k of one m16 tile a warp multiplies a step, with each round and
      // each chunk's ring fill counted as ROUND_K and CHUNK_K more, and the
      // bytes of its ring in flight while it multiplies one slab
      const long long cost =
          static_cast<long long>(chunks) * (mw * rpw * (KC + ROUND_K) + CHUNK_K);
      const int flight = (stages - 1) * slab;
      if (best_cost > 0 && (cost > best_cost || (cost == best_cost && flight <= best_flight)))
        continue;
      best_cost = cost;
      best_flight = flight;
      best.units = units;
      best.nt = nt;
      best.cols = cols;
      best.k = k;
      best.kr = kr;
      best.stages = stages;
      best.wm = wm;
      best.wk = wk;
      best.mw = mw;
      best.nb = nb;
      best.chunks = chunks;
      best.rpw = rpw;
      best.pitch = pitch;
      best.slab_bytes = slab;
      best.region = region;
      best.ring_offset = ring_offset;
      best.ppt = ppt;
      best.smem_bytes = ring_offset + WARPS * region;
    }
  }
  return best_cost > 0;
}

// The slice's element W[k][column c of n8 tile n], split, into its place
// in fragment order (ws: the slice's floats).
__device__ __forceinline__ void put_split(float* ws, const Plan& p, int k, int n, int c,
                                          float v) {
  uint32_t* f = reinterpret_cast<uint32_t*>(ws) +
                ((((k >> 3) * p.nt + n) * p.cols + c) * 4 + (k & 3)) * 4 + ((k >> 2) & 1);
  mmautil::split_tf32(v, f[0], f[2]);
}

// This warp's products of batch chunk c: acc[m][n] = its m16 tiles of
// src's rows ([B, ld] f32, written by other blocks; m < nv, the tiles that
// hold batch rows) times the slice's column tile n, over its split's
// rounds of K (a contiguous range, walked from the block's own starting
// round, so the blocks do not all ask L2 for the same lines at once),
// through its ring. Ends with the warp's f32 partials in its ring, [mw *
// 16 rows][pitch] (rows m * 16 + g, columns 8n + 2q, as the accumulators
// hold them).
template <int NT, int MW>
__device__ __forceinline__ void warp_chunk(const Plan& p, const float* ws, unsigned char* smem,
                                           const float* src, int ld, int batch, int c) {
  constexpr int C = KC / 4;   // 16-byte chunks a slab row
  constexpr int RPV = 32 / C; // slab rows a warp's copy instruction covers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int split = warp / p.wm, wmi = warp - split * p.wm;
  unsigned char* region = smem + p.ring_offset + warp * p.region;
  const int row0 = c * p.nb + wmi * p.mw * 16;  // the warp's first batch row
  int nv = (batch - row0 + 15) / 16;            // its m16 tiles that hold batch rows
  nv = nv < 0 ? 0 : (nv < p.mw ? nv : p.mw);
  const int r_begin = split * p.rpw;
  const int ns = p.kr - r_begin < p.rpw ? (p.kr - r_begin > 0 ? p.kr - r_begin : 0) : p.rpw;
  const int r_first = r_begin + (ns > 0 ? static_cast<int>(blockIdx.x % ns) : 0);
  float acc[MW][NT][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  // the copies of a round: instruction v copies row crow + v RPV, chunk ch,
  // at k r KC + 4 ch; zero past B and K
  const int ch = lane % C, crow = lane / C;
  const int copies = nv * 16 / RPV;
  const float* src_lane = src + static_cast<long long>(row0 + crow) * ld + ch * 4;
  const int rows_left = batch - row0 - crow;
  const int r_end = r_begin + ns;
  int r_next = r_first, slot_next = 0, issued = 0;
  const auto issue = [&]() {
    if (issued < ns) {
      float* slab = reinterpret_cast<float*>(region + slot_next * p.slab_bytes);
      const bool k_ok = r_next * KC + ch * 4 < p.k;
      const float* s = src_lane + r_next * KC;
#pragma unroll
      for (int v = 0; v < MW * 16 / RPV; ++v) {
        if (v >= copies) break;
        const int row = crow + v * RPV;
        const bool ok = k_ok && v * RPV < rows_left;
        mmautil::cp_async16(slab + row * SP + ch * 4,
                            ok ? s + static_cast<long long>(v * RPV) * ld : src, ok);
      }
      if (++r_next == r_end) r_next = r_begin;
      if (++slot_next == p.stages) slot_next = 0;
    }
    mmautil::cp_async_commit();  // an empty group past the last round keeps the count
    ++issued;
  };
  for (int i = 0; i < p.stages - 1; ++i) issue();

  // ldmatrix: matrix lane / 8 of an m16 x k8 tile is (rows 0-7 | 8-15) x
  // (words 0-3 | 4-7): a0, a1, a2, a3 of the TF32 A fragment
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * SP + (lane >> 4) * 4;
  const bool b_zero = g >= p.cols;
  const float4* b_lane =
      reinterpret_cast<const float4*>(ws) + (b_zero ? p.cols - 1 : g) * 4 + q;
  int r_cur = r_first, slot_cur = 0;
  for (int j = 0; j < ns; ++j) {
    wait_rounds(p.stages - 2);  // this lane's copies of round j have landed
    __syncwarp();               // the warp's have, and it is done with the slot it refills
    issue();
    if (nv > 0) {
      const float* slab = reinterpret_cast<const float*>(region + slot_cur * p.slab_bytes);
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const int s8 = r_cur * (KC / 8) + kk;
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float4 v = b_lane[(s8 * NT + n) * p.cols * 4];
          if (b_zero) v = make_float4(0.f, 0.f, 0.f, 0.f);
          bb[n][0] = __float_as_uint(v.x);
          bb[n][1] = __float_as_uint(v.y);
          bs[n][0] = __float_as_uint(v.z);
          bs[n][1] = __float_as_uint(v.w);
        }
#pragma unroll
        for (int m = 0; m < MW; ++m)
          if (m < nv) {
            uint32_t raw[4], ab[4], as[4];
            mmautil::ldsm_x4(raw, reinterpret_cast<const mmautil::bf16*>(
                                      slab + m * 16 * SP + a_off + kk * 8));
#pragma unroll
            for (int e = 0; e < 4; ++e) mmautil::split_tf32(__uint_as_float(raw[e]), ab[e], as[e]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              mmautil::mma_tf32(acc[m][n], as, bb[n]);
              mmautil::mma_tf32(acc[m][n], ab, bs[n]);
              mmautil::mma_tf32(acc[m][n], ab, bb[n]);
            }
          }
      }
    }
    if (++r_cur == r_end) r_cur = r_begin;
    if (++slot_cur == p.stages) slot_cur = 0;
  }

  __syncwarp();  // every lane's copies have landed and its reads are done
  float* part = reinterpret_cast<float*>(region);
#pragma unroll
  for (int m = 0; m < MW; ++m)
    if (m < nv)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* o = part + (m * 16 + g) * p.pitch + n * 8 + 2 * q;
        *reinterpret_cast<float2*>(o) = make_float2(acc[m][n][0], acc[m][n][1]);
        *reinterpret_cast<float2*>(o + 8 * p.pitch) = make_float2(acc[m][n][2], acc[m][n][3]);
      }
}

// Where batch row b of a chunk's partials lives: the region of warp
// (split sp, batch group wg) is smem + ring_offset + (sp * wm + wg) * region,
// and the row is bl - wg * mw * 16 (bl: b's index in the chunk).
__device__ __forceinline__ const float* partial_row(const unsigned char* smem, const Plan& p,
                                                    int sp, int bl) {
  const int wg = bl / (p.mw * 16);
  return reinterpret_cast<const float*>(smem + p.ring_offset + (sp * p.wm + wg) * p.region) +
         (bl - wg * p.mw * 16) * p.pitch;
}

}  // namespace tc

// -- the wide designs ----------------------------------------------------------
//
// lstm_fwd_wide (lstm_fwd.cu) and lstm_bwd_wide (lstm_bwd.cu) take the
// widths whose slice no other design can hold beside its staging (on 132
// SMs, f32 from 1152 to 1408 units by batch, bf16 from 1920; the whole
// card's opt-in shared
// memory, 30.7 MB, is less than w_hh itself there: 51.4 MB in f32 at H
// 1792). The block keeps the first res_rounds rounds of its slice's K range
// resident in shared memory and reads the rest from device memory (L2) every
// step, through the same two stage slots that bring in h_prev (forward) or
// dgates[t] (backward). Everything else is as in the first design: U units
// a block, one block an SM, one grid barrier a step, the cooperative launch,
// the f32 carries, the gate order and every output's layout.
//
// A step's product takes the slice's rows as the mma's M and the batch as
// N: the forward's m16 tile m is gate m and its rows are the units (row
// gate * U + u of the slice), the backward's one tile holds the U units.
// The eight warps split into wn along the batch, each holding ntw n8 tiles
// of a chunk of nb columns, and wk along K, each taking every wk-th k step
// of a round; their f32 partials meet in shared memory in a fixed order
// (split 1, 2, ... added to split 0's registers), and split 0's threads run
// the pointwise part from their accumulators. A round is kc = kstep x wk x s
// of K (s = 4, 2 or 1 k steps a warp: the largest whose two slots and the
// partials take at most half of the shared memory). Both slots are filled
// by 16-byte cp.async.cg copies (zero past B and K; element loads through
// L2 where rows are not 16-byte aligned) a round ahead of the products, one
// block barrier on each side of a round's products.
//   bf16: mma.sync m16n8k16, f32 accumulation, as the rings.
//   f32:  mma.sync m16n8k8 in split-f32 (3xTF32, as namespace tc): both
//         operands are split into big and small TF32 parts in registers as
//         they are loaded, so the resident slice stays raw f32 (a pre-split
//         slice takes twice the bytes).
// Rows are padded by 16 bytes (pitches of 4 mod 8 words), so the fragments'
// 32-bit loads hit 32 distinct banks. Each block walks the rounds from its
// own starting round (blockIdx.x % kr), so the blocks do not all ask L2 for
// the same lines of h_prev at once.
namespace wide {

constexpr int MAX_S = 4;  // k steps a warp takes of each round

// n8 batch tiles a warp holds: its accumulators are mt x ntw x 4 floats
__host__ __device__ constexpr int max_ntw(int mt) { return mt == 4 ? 3 : 4; }

// Computed on the host from the shapes (make_plan below); mirrored line for
// line by kernels/lstm.py:wide_plan.
struct Plan {
  int units;         // U
  int mt;            // m16 row tiles: 4 forward (tile = gate), 1 backward
  int rows;          // rows of the slice: 4U forward (gate * U + u), U backward
  int k;             // K: H forward, 4H backward
  int kstep;         // k of one mma: 8 (f32, m16n8k8) or 16 (bf16, m16n8k16)
  int wn, wk;        // warps along the batch and along K (wn * wk = 8)
  int ntw;           // n8 batch tiles a warp holds
  int nb;            // batch columns a chunk: wn * ntw * 8
  int chunks;        // ceil(B / nb)
  int kc;            // k a round: kstep * wk * s
  int kr;            // rounds over K: ceil(K / kc)
  int res_rounds;    // rounds of the slice resident in shared memory; the rest stream
  int pitch;         // resident row pitch (elements): res_rounds * kc + 16 bytes
  int spitch;        // stage row pitch (elements): kc + 16 bytes
  int stage_offset;  // bytes: the resident slice, then two stage slots, then the partials
  int slot_bytes;    // (rows + nb) * spitch elements: a streamed round's slice rows, then the batch
  int part_offset;
  int smem_bytes;
};

// False where two stage slots and the partials alone exceed smem_limit.
inline bool make_plan(int elem_bytes, int units, int mt, int k, int batch, int smem_limit,
                      Plan& p) {
  if (units <= 0 || units > MAX_UNITS || k <= 0 || batch <= 0) return false;
  const int pad = 16 / elem_bytes;
  p.units = units;
  p.mt = mt;
  p.rows = mt == 4 ? 4 * units : units;
  p.k = k;
  p.kstep = elem_bytes == 4 ? 8 : 16;
  const int nt = (batch + 7) / 8;
  p.wn = WARPS;
  while (p.wn > nt) p.wn /= 2;
  p.wk = WARPS / p.wn;
  p.ntw = (nt + p.wn - 1) / p.wn;
  if (p.ntw > max_ntw(mt)) p.ntw = max_ntw(mt);
  p.nb = p.wn * p.ntw * 8;
  p.chunks = (batch + p.nb - 1) / p.nb;
  const int part = (p.wk - 1) * mt * 16 * p.nb * 4;
  int s = MAX_S;
  while (s > 1 && 2 * (p.rows + p.nb) * (p.kstep * p.wk * s + pad) * elem_bytes + part >
                      smem_limit / 2)
    s /= 2;
  p.kc = p.kstep * p.wk * s;
  p.kr = (k + p.kc - 1) / p.kc;
  p.spitch = p.kc + pad;
  p.slot_bytes = (p.rows + p.nb) * p.spitch * elem_bytes;
  const int room = smem_limit - 2 * p.slot_bytes - part;
  if (room < 0) return false;
  int res = (room / (p.rows * elem_bytes) - pad) / p.kc;
  if (res < 0) res = 0;
  if (res > p.kr) res = p.kr;
  p.res_rounds = res;
  p.pitch = res * p.kc + pad;
  p.stage_offset = res > 0 ? p.rows * p.pitch * elem_bytes : 0;
  p.part_offset = p.stage_offset + 2 * p.slot_bytes;
  p.smem_bytes = p.part_offset + part;
  return true;
}

// The row of w (w_hhᵀ [4H, H] forward, w_hh [H, 4H] backward; rows of K
// elements) that row r of the block's slice holds, or -1 past the last unit.
__device__ __forceinline__ long long slice_row(const Plan& p, int r, int j0, int hidden) {
  const int gate = p.mt == 4 ? r / p.units : 0;
  const int u = r - gate * p.units;
  return j0 + u < hidden ? static_cast<long long>(gate) * hidden + j0 + u : -1;
}

// The resident part of the block's slice: [rows][pitch], k < res_rounds *
// kc, zero past K and past the last unit. Ends with a __syncthreads().
template <typename T>
__device__ void load_resident(const Plan& p, T* ws, const T* w, int j0, int hidden, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int res_k = p.res_rounds * p.kc;
  const int vpr = res_k / V;
  for (int idx = threadIdx.x; idx < p.rows * vpr; idx += THREADS) {
    const int r = idx / vpr;
    const int kk = (idx - r * vpr) * V;
    const long long grow = slice_row(p, r, j0, hidden);
    const T* src = w + grow * p.k + kk;
    T* dst = ws + r * p.pitch + kk;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = grow >= 0 && kk < p.k
                                           ? *reinterpret_cast<const uint4*>(src)
                                           : make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (int e = 0; e < V; ++e)
        dst[e] = grow >= 0 && kk + e < p.k ? src[e] : from_f32<T>(0.f);
    }
  }
  __syncthreads();
}

// Round `round` into a stage slot: for a streamed round (round >=
// res_rounds) the slice's rows [rows][spitch], then the nb batch rows of
// chunk n0 of src ([B, ld], written by other blocks during the launch)
// [nb][spitch], each kc elements from k = round * kc, zero past K, B and
// the last unit. 16-byte cp.async copies (vec) or element loads through L2.
template <typename T>
__device__ __forceinline__ void stage_round(const Plan& p, T* slot, const T* w, int j0,
                                            int hidden, const T* src, int ld, int batch, int n0,
                                            int round, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int k0 = round * p.kc;
  const int wrows = round >= p.res_rounds ? p.rows : 0;
  const int vpr = p.kc / V;
  for (int idx = threadIdx.x; idx < (wrows + p.nb) * vpr; idx += THREADS) {
    const int r = idx / vpr;
    const int kk = (idx - r * vpr) * V;
    const int k = k0 + kk;
    const T* from;
    T* dst;
    bool ok;
    if (r < wrows) {
      const long long grow = slice_row(p, r, j0, hidden);
      ok = grow >= 0 && k < p.k;
      from = w + grow * p.k + k;
      dst = slot + r * p.spitch + kk;
    } else {
      const int n = r - wrows;
      ok = n0 + n < batch && k < p.k;
      from = src + static_cast<long long>(n0 + n) * ld + k;
      dst = slot + (p.rows + n) * p.spitch + kk;
    }
    if (vec) {
      mmautil::cp_async16(dst, ok ? from : src, ok);
    } else {
      for (int e = 0; e < V; ++e)
        dst[e] = ok && k + e < p.k ? ldcg(from + e) : from_f32<T>(0.f);
    }
  }
}

// This warp's products of one round: acc[j][m] += rows of m16 tile m of
// the slice (a: resident or staged, row pitch a_pitch, at the round's k)
// times its n8 batch tile j (b: the slot's batch rows, pitch spitch), over
// the k steps split, split + wk, ... of the round; tiles j >= nv hold no
// batch rows. ar[m][h]: the slice row of the lane's row g + 8h of tile m.
template <typename T, int MT, int NTW>
__device__ __forceinline__ void round_products(const Plan& p, const T* a, int a_pitch,
                                               const T* b, int (&ar)[MT][2], int split,
                                               int wn_i, int nv, float (&acc)[NTW][MT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int steps = p.kc / p.kstep;
  for (int ks = split; ks < steps; ks += p.wk) {
    const int k = ks * p.kstep;
    if constexpr (sizeof(T) == 2) {
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const T* r0 = a + ar[m][0] * a_pitch + k + 2 * q;
        const T* r1 = a + ar[m][1] * a_pitch + k + 2 * q;
        af[m][0] = ld32(r0);
        af[m][1] = ld32(r1);
        af[m][2] = ld32(r0 + 8);
        af[m][3] = ld32(r1 + 8);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j < nv) {
          const T* br = b + ((wn_i * NTW + j) * 8 + g) * p.spitch + k + 2 * q;
          const uint32_t bf[2] = {ld32(br), ld32(br + 8)};
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(acc[j][m], af[m], bf);
        }
    } else {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const T* r0 = a + ar[m][0] * a_pitch + k + q;
        const T* r1 = a + ar[m][1] * a_pitch + k + q;
        mmautil::split_tf32(to_f32(r0[0]), ab[m][0], as[m][0]);
        mmautil::split_tf32(to_f32(r1[0]), ab[m][1], as[m][1]);
        mmautil::split_tf32(to_f32(r0[4]), ab[m][2], as[m][2]);
        mmautil::split_tf32(to_f32(r1[4]), ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j < nv) {
          const T* br = b + ((wn_i * NTW + j) * 8 + g) * p.spitch + k + q;
          uint32_t bb[2], bs[2];
          mmautil::split_tf32(to_f32(br[0]), bb[0], bs[0]);
          mmautil::split_tf32(to_f32(br[4]), bb[1], bs[1]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mmautil::mma_tf32(acc[j][m], as[m], bb);
            mmautil::mma_tf32(acc[j][m], ab[m], bs);
            mmautil::mma_tf32(acc[j][m], ab[m], bb);
          }
        }
    }
  }
}

// One batch chunk (columns n0 .. n0 + nb) of a step's product, complete in
// the registers of split 0's warps: acc[j][m][e] is row g + 8 (e / 2) of
// tile m, column (wn_i * NTW + j) * 8 + 2q + e % 2 of the chunk. The rounds
// run from the block's starting round, round i + 1 copied while round i is
// multiplied; then the other splits' partials are added in split order.
template <typename T, int MT, int NTW>
__device__ void wide_chunk(const Plan& p, unsigned char* smem, const T* w, int j0, int hidden,
                           const T* src, int ld, int batch, int n0, bool vec,
                           float (&acc)[NTW][MT][4]) {
  const T* ws = reinterpret_cast<const T*>(smem);
  T* slots = reinterpret_cast<T*>(smem + p.stage_offset);
  float* part = reinterpret_cast<float*>(smem + p.part_offset);
  const int slot_elems = p.slot_bytes / static_cast<int>(sizeof(T));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int split = warp / p.wn, wn_i = warp - split * p.wn;
  const int nt = (batch + 7) / 8;
  int nv = nt - (n0 / 8 + wn_i * NTW);
  nv = nv < 0 ? 0 : (nv < NTW ? nv : NTW);
  // the slice rows of this lane's rows g and g + 8 of each tile; a row past
  // the last unit reads unit U - 1, and its sums are never used
  int ar[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = g + 8 * h;
      ar[m][h] = (MT == 4 ? m * p.units : 0) + (u < p.units ? u : p.units - 1);
    }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.f;

  const int first = blockIdx.x % p.kr;
  const auto round_of = [&](int i) { return i + first < p.kr ? i + first : i + first - p.kr; };
  stage_round(p, slots, w, j0, hidden, src, ld, batch, n0, round_of(0), vec);
  mmautil::cp_async_commit();
  for (int i = 0; i < p.kr; ++i) {
    if (i + 1 < p.kr) {
      stage_round(p, slots + ((i + 1) & 1) * slot_elems, w, j0, hidden, src, ld, batch, n0,
                  round_of(i + 1), vec);
      mmautil::cp_async_commit();
      mmautil::cp_async_wait<1>();  // this thread's copies of round i have landed
    } else {
      mmautil::cp_async_wait<0>();
    }
    __syncthreads();  // every thread's have
    const int r = round_of(i);
    const T* slot = slots + (i & 1) * slot_elems;
    if (nv > 0) {
      if (r < p.res_rounds)
        round_products<T, MT, NTW>(p, ws + r * p.kc, p.pitch, slot + p.rows * p.spitch, ar,
                                   split, wn_i, nv, acc);
      else
        round_products<T, MT, NTW>(p, slot, p.spitch, slot + p.rows * p.spitch, ar, split,
                                   wn_i, nv, acc);
    }
    __syncthreads();  // done with the slot that round i + 2 refills
  }
  if (p.wk == 1) return;
  // the K splits' partials, [split - 1][tile row][column], then split 0 adds
  // them in split order
  const auto at = [&](int sp, int m, int e, int j) {
    return part + ((sp - 1) * MT * 16 + m * 16 + g + 8 * (e >> 1)) * p.nb +
           (wn_i * NTW + j) * 8 + 2 * q + (e & 1);
  };
  if (split > 0)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      if (j < nv)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) *at(split, m, e, j) = acc[j][m][e];
  __syncthreads();
  if (split == 0)
    for (int sp = 1; sp < p.wk; ++sp)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j < nv)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][m][e] += *at(sp, m, e, j);
}

}  // namespace wide

}  // namespace lstm
