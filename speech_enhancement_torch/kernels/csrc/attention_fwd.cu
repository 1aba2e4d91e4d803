// Multi-head attention forward for short sequences, for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/attention.py, `_mha_fwd_call`
// / `_mha_fwd_kernel` with `_probs` (the Pallas TPU kernel). For each
// sequence b and head h, with q, k, v the head's [D, L] blocks upcast to f32:
//   s[l, m] = (sum_d q[d, l] k[d, m]) * scale     (keys past L: -1e30)
//   p[l, m] = exp(s[l, m] - max_m s[l, :]) / sum_m exp(...)
//   o[d, l] = sum_m v[d, m] p[l, m]                (rounded to the i/o type)
// The layout, the staging and the padding are described in attention.cuh.
//
// What bounds it on an H100: the bytes, then the softmax. Sepformer's
// intra-chunk attention at serving width (B' 12,672 sequences, H 8, L 250,
// D 32, bf16) moves q, k, v and o once, 6.49 GB: 1.94 ms at 3.35 TB/s,
// against 0.82 ms for its 811 GFLOP at 989 TFLOP/s (1.3 TFLOP issued: L
// padded to 256 and P V twice, for P's hi and lo parts) and about 1.8 ms of
// the SFU for its 6.6 G exp2 (16 a clock an SM); the inter-chunk launch
// (B' 48,000, L 66) moves the same bytes.
//
// Design (bf16): a block of up to eight warps walks eight consecutive (b,
// h) head blocks (attention.cuh: fwd_plan; L 250: eight warps; L 66: five,
// a sequence's eight heads). Each head's q, k and v land in shared memory
// by bulk copies (cp.async.bulk, counted on an mbarrier) issued under the
// previous head's products, and are realigned from there into pitched
// tiles [d][lp + 8] (where a head block is not whole 16-byte words at a
// 16-byte address, from global memory after an L2 prefetch instead).
// After a barrier each warp takes its 16-query tiles, two at once where
// every warp has two (L 250): Q's A fragments by ldmatrix.trans, then an
// online softmax over the keys in steps of 32 (the last one of 16 where lp
// is an odd number of 16s: L 66 pads to 80), K's B fragments by
// ldmatrix.trans and V's by ldmatrix, shared by the two tiles; the scale
// folded into the exp2's FFMA, the running row max and sum in registers,
// the accumulator rescaled when the max grows, keys past L masked in the
// last step only, P split into hi and lo for P V. A warp's output tile
// goes by stmatrix.trans into its own columns of q's tile; after a barrier
// the block stores the head along l in 16-byte words, and a barrier frees
// the tiles for the next head (a second q tile, so that the stores could
// run beside the next head's staging, measured slower: PERF.md). Neither
// the [L, L] scores (250 KB in f32 at L 250) nor a full score row exists
// anywhere: a warp holds a 16 x 32 tile of each of its query tiles in
// registers. f32 runs one block per (b, h), one thread per query row on
// full-f32 FMA.
//
// Shared memory (bf16, D 32): three tiles of 32 x 264 elements and three
// landed head blocks of 16,016 bytes at L 250, 98,736 bytes (two blocks of
// 256 threads an SM); 29,616 bytes at L 66 (three blocks of 160 threads,
// by registers). Without the bulk copies the tiles alone. A shape whose
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

template <int DP>
__global__ void __launch_bounds__(256, 2)
    mha_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int batch_heads, int depth,
                int length, float scale, int per_block, int raw, int pair) {
  const int lp = attn::round_up(length, 16), pitch = lp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t landed;                 // the bulk copies' barrier
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [DP][pitch]: q, then the output
  bf16* ks = qs + DP * pitch;                 // [DP][pitch]
  bf16* vs = ks + DP * pitch;                 // [DP][pitch]
  unsigned char* raws = reinterpret_cast<unsigned char*>(vs + DP * pitch);  // 3 x raw bytes
  const size_t n = static_cast<size_t>(depth) * length;  // elements a head block
  const int h0 = blockIdx.x * per_block, h1 = min(h0 + per_block, batch_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const float c = scale * attn::LOG2E;
  // the three head blocks of head h into raws, counted on `landed`
  auto fetch = [&](int h) {
    const unsigned bytes = static_cast<unsigned>(2 * n);
    attn::mbar_expect(&landed, 3 * bytes);
    attn::bulk_copy(raws, q + h * n, bytes, &landed);
    attn::bulk_copy(raws + raw, k + h * n, bytes, &landed);
    attn::bulk_copy(raws + 2 * raw, v + h * n, bytes, &landed);
  };
  // -- begin --
  if (raw && threadIdx.x == 0) attn::mbar_init(&landed);
  for (int i = 0; i < 3; ++i) attn::zero_rows(qs + i * DP * pitch, depth, DP, pitch);
  __syncthreads();
  if (raw && threadIdx.x == 0) fetch(h0);
  for (int h = h0; h < h1; ++h) {
    // -- stage --
    const size_t at = h * n;
    if (raw) attn::mbar_wait(&landed, (h - h0) & 1);
    // -- landed --
    if (raw) {
      attn::realign_tiles<3>(raws, raw, qs, DP, depth, length, lp, pitch);
    } else {
      if (h + 1 < h1) {
        attn::prefetch_l2(q + at + n, n);
        attn::prefetch_l2(k + at + n, n);
        attn::prefetch_l2(v + at + n, n);
      }
      attn::stage_tiles<3>({{q + at, k + at, v + at}}, qs, DP, depth, length, lp, pitch);
    }
    // -- staged --
    __syncthreads();
    // -- tiles --
    if (raw && threadIdx.x == 0 && h + 1 < h1) fetch(h + 1);  // under this head's products
    const int qt = DP <= 32 && pair ? 2 : 1;  // tiles a warp takes at once
    for (int r0 = 16 * qt * warp; r0 < lp; r0 += 16 * qt * warps) {
      if constexpr (DP <= 32) {
        if (qt == 2) {
          attn::attend_tiles<DP, 2>(qs, ks, vs, qs, pitch, r0, lp, length, c, lane);
          continue;
        }
      }
      attn::attend_tiles<DP, 1>(qs, ks, vs, qs, pitch, r0, lp, length, c, lane);
    }
    // -- epilogue --
    __syncthreads();
    attn::store_tile(o + at, qs, depth, length, pitch);
    __syncthreads();
    // -- stored --
  }
  // -- end --
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

// The bf16 kernel at depth tile DP: the plan's shared memory checked
// against the device and granted, `blocks` blocks of `threads`; the bulk
// copies where every head block is whole 16-byte words at a 16-byte
// address.
template <int DP>
int launch_mma(cudaStream_t stream, const void* q, const void* k, const void* v, void* o,
               int batch_heads, int depth, int length, float scale) {
  const bool copyable = (depth * length) % 8 == 0 && attn::aligned16(q) && attn::aligned16(k) &&
                        attn::aligned16(v);
  const int shared = attn::max_shared_bytes();
  const attn::Plan p = attn::fwd_plan(batch_heads, DP, depth, length, copyable, shared);
  if (p.smem > shared) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err =
      cudaFuncSetAttribute(mha_fwd_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_fwd_mma<DP><<<p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), batch_heads, depth, length, scale, p.per_block, p.raw, p.pair);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernel at depth tile DP: one block per (b, h).
template <int DP>
int launch_simt(cudaStream_t stream, const void* q, const void* k, const void* v, void* o,
                int batch_heads, int depth, int length, float scale) {
  const size_t smem = simt_smem<DP>(length);
  if (smem > static_cast<size_t>(attn::max_shared_bytes()))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_simt<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_fwd_simt<DP><<<batch_heads, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), depth, length, scale);
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
    if (depth <= 16) return launch_mma<16>(stream, q, k, v, o, bh, depth, length, scale);
    if (depth <= 32) return launch_mma<32>(stream, q, k, v, o, bh, depth, length, scale);
    return launch_mma<64>(stream, q, k, v, o, bh, depth, length, scale);
  }
  if (depth <= 8) return launch_simt<8>(stream, q, k, v, o, bh, depth, length, scale);
  if (depth <= 16) return launch_simt<16>(stream, q, k, v, o, bh, depth, length, scale);
  if (depth <= 32) return launch_simt<32>(stream, q, k, v, o, bh, depth, length, scale);
  return launch_simt<64>(stream, q, k, v, o, bh, depth, length, scale);
}
