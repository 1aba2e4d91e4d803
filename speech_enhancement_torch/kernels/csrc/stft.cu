// Fused framing + window-folded rFFT-basis STFT for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/stft.py, `_stft_blocks` /
// `_kernel` (the Pallas TPU kernel behind `stft_pallas`).
//
// Computes out[b, f, d] = sum_j x[b, f*hop + j] * basis[j, d]
// for x [B, T] f32, basis [win, D] f32 (the Hann window is folded into the
// basis on the host), out [B, n_frames, D] f32, n_frames = (T - win)/hop + 1.
// As on the TPU, the [B, n_frames, win] frame tensor never exists in device
// memory: each block reads its frames straight from the signal.
//
// What bounds it on an H100: it is a GEMM with M = B*n_frames, N = D,
// K = win. At DCCRN's serving shape (B = 192 windows of 64,600 padded
// samples, 643 frames, win 400, D = 514) that is 2*M*N*K = 50.8 GFLOP
// against ~0.30 GB of compulsory traffic (x read once 50 MB, basis 0.8 MB,
// output 254 MB). Plain f32 arithmetic (67 TFLOP/s, no tensor cores) takes
// >= 0.76 ms for the FLOPs and the bytes take >= 0.09 ms at 3.35 TB/s, so
// the kernel is bound by operations.
//
// With tensor cores the operations bound falls: mma.sync's TF32 keeps 10
// bits of each operand, too few for the f32 tolerance (a 1xTF32 product
// errs by about 1e-2 at DCCRN's geometry), so each operand is split into a
// TF32 big part and a TF32 small part (x - big, rounded again), and three
// products (a_small b_big + a_big b_small + a_big b_big, summed in f32)
// recover f32 accuracy (3xTF32: about 3e-6). That is 3 x 50.8 GFLOP at 495
// TFLOP/s, >= 0.308 ms, beside the 0.76 ms of plain f32 FMA.
//
// Design (stft_tf32x3, where total, hop and win are whole 16-byte words,
// win a multiple of 8 and D even; DCCRN's 64,600 / 100 / 400 / 514 are):
// a 256-thread block computes 128 frames x 176 columns (22 n8 tiles: 3
// column tiles cover D 514 with 14 idle columns, 2.7%) with mma.sync
// m16n8k8 TF32; eight warps of 32 frames x 88 columns (2 m16 x 11 n8
// tiles, 88 f32 accumulators a thread).
//  - the signal span: the block's 128 frames overlap win / hop = 4 times,
//    so it stages their signal once, 127 hop + win floats (13,100 at
//    DCCRN), by one bulk copy (cp.async.bulk) a piece, as the TPU kernel
//    reassembles frames from shifted views; rows stay flattened over the
//    batch (192 x 643 frames fill 964.5 tiles of 128, where tiles per item
//    would idle 16%), so a block whose
//    frames cross a batch item's end stages one piece per item, piece i at
//    r hop + i gap (gap: win - hop rounded up to 32 floats). A fragments
//    are read out of the span at row r's offset + tap: with hop 100 words,
//    lane (g, q) hits bank (4 g + q) mod 32, free of conflicts, and the
//    gap keeps that across pieces. The A split into big and small runs in
//    registers at each fragment load (each value feeds 11 n8 tiles).
//  - the basis: split once a launch (split_basis, a 75-block pass at DCCRN)
//    into big and small TF32 parts in the mma's fragment order ([k8][n8
//    tile][lane][4]: one 16-byte shared load a tile), 1.7 MB in a scratch
//    the wrapper allocates; every block streams its column tile's 16-tap
//    slabs (22.5 KB each) from L2 through a 3-slot ring, one bulk copy a
//    slab by one thread, landing on the slot's mbarrier, so one block
//    barrier a slab orders the ring and the products.
// What bounds it as built (tools/stft_phase_probe.py, H100 80GB HBM3 at
// 700 W): the products, near mma.sync's TF32 rate, take about 70% of a
// block tile; the epilogue's 8-byte stores and the slab waits most of the
// rest (one block an SM at 174 registers, so nothing overlaps them).
// The first design (stft_frames_kernel, a register-blocked f32 SGEMM with
// 128 x 64 tiles) stays for the geometries the new one does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "mma_util.cuh"

namespace {

// -- the first design: f32 FMA -----------------------------------------------
// Each 256-thread block computes a 128-frame x 64-column tile, each thread
// an 8x4 sub-tile, over K steps of 16 taps staged in shared memory; the A
// tile is gathered from the signal at frame offsets (b*T + f*hop), ragged
// frame and D edges are masked.

constexpr int BM = 128;                         // frames per block tile
constexpr int BN = 64;                          // basis columns per block tile
constexpr int BK = 16;                          // taps per shared-memory stage
constexpr int TM = 8;                           // frames per thread
constexpr int TN = 4;                           // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_ROWS_PER_PASS = THREADS / BK;   // 16 frames loaded per pass
constexpr int A_PASSES = BM / A_ROWS_PER_PASS;  // 8
constexpr int B_ROWS_PER_PASS = THREADS / BN;   // 4 taps loaded per pass
constexpr int B_PASSES = BK / B_ROWS_PER_PASS;  // 4
constexpr int A_PITCH = BM + 4;                 // breaks bank conflicts on stores

__global__ void __launch_bounds__(THREADS)
stft_frames_kernel(const float* __restrict__ x, const float* __restrict__ basis,
                   float* __restrict__ out, long long rows, int n_frames,
                   long long total, int hop, int win, int dim) {
  __shared__ __align__(16) float a_tile[BK][A_PITCH];  // [tap][frame]
  __shared__ __align__(16) float b_tile[BK][BN];       // [tap][column]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;

  // Each thread loads tap a_k of frames a_m + p*16; the frame start in the
  // signal is computed once.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  long long a_off[A_PASSES];
  bool a_ok[A_PASSES];
#pragma unroll
  for (int p = 0; p < A_PASSES; ++p) {
    const long long r = row0 + a_m + p * A_ROWS_PER_PASS;
    a_ok[p] = r < rows;
    const long long b = r / n_frames;
    const long long f = r - b * n_frames;
    a_off[p] = a_ok[p] ? b * total + f * hop : 0;
  }
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_ok = col0 + b_n < dim;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < win; k0 += BK) {
    const int ka = k0 + a_k;
#pragma unroll
    for (int p = 0; p < A_PASSES; ++p)
      a_tile[a_k][a_m + p * A_ROWS_PER_PASS] =
          (a_ok[p] && ka < win) ? x[a_off[p] + ka] : 0.f;
#pragma unroll
    for (int p = 0; p < B_PASSES; ++p) {
      const int kk = b_k + p * B_ROWS_PER_PASS;
      const int kb = k0 + kk;
      b_tile[kk][b_n] =
          (b_ok && kb < win) ? basis[static_cast<long long>(kb) * dim + col0 + b_n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&a_tile[k][ty * TM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&a_tile[k][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[k][tx * TN]);
      const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty * TM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c < dim) out[r * dim + c] = acc[i][j];
    }
  }
}


// -- split-f32 operands on tensor cores --------------------------------------

namespace tc {

constexpr int BM = 128;                      // frames a block
constexpr int NTW = 11;                      // n8 tiles a warp
constexpr int BN = 2 * NTW * 8;              // 176 columns a block
constexpr int BK = 16;                       // taps a slab: two k8 steps
constexpr int THREADS = 256;                 // 4 warps along the frames x 2 along the columns
constexpr int STAGES = 3;                    // split basis slabs in a block's ring
constexpr int SPLIT_FLOATS = (BK / 8) * (BN / 8) * 32 * 4;  // a slab: [k8][n8 tile][lane][4]

// Computed on the host (make_plan); mirrored by kernels/stft.py:tc_plan.
struct Plan {
  int gap;          // floats between the pieces of two batch items in the span
  int span_floats;  // 127 hop + win + (pieces - 1) gap
  int col_tiles;    // ceil(D / BN)
  int slabs;        // ceil(win / BK)
  int smem_bytes;   // the ring of split slabs, the span, then the mbarriers
};

// False where the kernel does not take the geometry (the caller then
// launches the first design).
inline bool make_plan(long long batch, long long total, int n_frames, int hop, int win, int dim,
                      bool aligned, int smem_limit, Plan& p) {
  if (!aligned || total % 4 || hop % 4 || win % 8 || dim % 2) return false;
  const int overlap = win > hop ? win - hop : 0;
  p.gap = (overlap + 31) / 32 * 32;
  // batch items a block's 128 rows can touch: one more than the item ends
  // among rows f0 .. f0 + 127, f0 <= n_frames - 1
  long long pieces = (n_frames - 1 + BM - 1) / n_frames + 1;
  if (pieces > batch) pieces = batch;
  const long long span = static_cast<long long>(BM - 1) * hop + win + (pieces - 1) * p.gap;
  const long long bytes = 4LL * STAGES * SPLIT_FLOATS + (4 * span + 15) / 16 * 16 +
                          8 * (STAGES + 1);
  if (bytes > smem_limit) return false;
  p.span_floats = static_cast<int>(span);
  p.col_tiles = (dim + BN - 1) / BN;
  p.slabs = (win + BK - 1) / BK;
  p.smem_bytes = static_cast<int>(bytes);
  return true;
}

using mmautil::mma_tf32;
using mmautil::to_tf32;

// The basis split once a launch into big and small parts, slab by slab in
// the mma's fragment order: block (ct, st) writes slab st of column tile ct
// at split + (st * col_tiles + ct) * SPLIT_FLOATS, element [ks][tile][lane]
// holding b0 and b1 of lane (g, q) of n8 tile `tile` at k8 step ks (taps
// 16 st + 8 ks + q and + 4, column 176 ct + 8 tile + g), big then small;
// zero past win and D.
__global__ void __launch_bounds__(THREADS)
    split_basis(const float* __restrict__ basis, float4* __restrict__ split, int win, int dim) {
  const int ct = blockIdx.x, st = blockIdx.y;
  float4* dst = split + (static_cast<long long>(st) * gridDim.x + ct) * (SPLIT_FLOATS / 4);
  for (int v = threadIdx.x; v < SPLIT_FLOATS / 4; v += THREADS) {
    const int ln = v % 32, tile = (v / 32) % (BN / 8), ks = v / (32 * (BN / 8));
    const int k = st * BK + 8 * ks + ln % 4, n = ct * BN + 8 * tile + ln / 4;
    const float lo = k < win && n < dim ? basis[static_cast<long long>(k) * dim + n] : 0.f;
    const float hi = k + 4 < win && n < dim ? basis[static_cast<long long>(k + 4) * dim + n] : 0.f;
    const uint32_t blo = to_tf32(lo), bhi = to_tf32(hi);
    dst[v] = make_float4(__uint_as_float(blo), __uint_as_float(bhi),
                         __uint_as_float(to_tf32(lo - __uint_as_float(blo))),
                         __uint_as_float(to_tf32(hi - __uint_as_float(bhi))));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    stft_tf32x3(const float* __restrict__ x, const float4* __restrict__ split,
                float* __restrict__ out, long long rows, int n_frames, long long total, int hop,
                int win, int dim, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* span = reinterpret_cast<float*>(smem + 4 * STAGES * SPLIT_FLOATS);
  // mbarriers: slot s of the ring counts its slab's bytes, the last one the span's
  uint64_t* landed = reinterpret_cast<uint64_t*>(
      smem + 4 * STAGES * SPLIT_FLOATS + (4 * p.span_floats + 15) / 16 * 16);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const long long row0 = static_cast<long long>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;
  const int nrows = rows - row0 < BM ? static_cast<int>(rows - row0) : BM;
  const long long b0 = row0 / n_frames;

  // split slab st of this column tile into ring slot st % 3: one bulk copy
  // by thread 0, its bytes counted by the slot's mbarrier
  const auto issue = [&](int st) {
    if (tid == 0 && st < p.slabs) {
      uint64_t* bar = landed + st % STAGES;
      mmautil::mbar_expect(bar, 4 * SPLIT_FLOATS);
      mmautil::bulk_copy(ring + (st % STAGES) * SPLIT_FLOATS,
                         split + (static_cast<long long>(st) * p.col_tiles + blockIdx.x) *
                                     (SPLIT_FLOATS / 4),
                         4 * SPLIT_FLOATS, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mmautil::mbar_init(landed + s);
    // the span: piece i (batch item b0 + i) holds the signal of the block's
    // rows [r_i, e_i), row r's frame starting at r hop + i gap; one bulk
    // copy a piece
    unsigned bytes = 0;
    for (int pass = 0; pass < 2; ++pass)  // the pieces' bytes first, then their copies
      for (int i = 0;; ++i) {
        const long long first = (b0 + i) * n_frames - row0;  // frame 0 of the item, as a row
        const int r_i = i == 0 ? 0 : static_cast<int>(first);
        if (r_i >= nrows) break;
        const int e_i = first + n_frames < nrows ? static_cast<int>(first + n_frames) : nrows;
        const unsigned piece = 4u * ((e_i - r_i - 1) * hop + win);
        if (pass == 0) {
          bytes += piece;
          continue;
        }
        if (i == 0) mmautil::mbar_expect(landed + STAGES, bytes);
        mmautil::bulk_copy(span + r_i * hop + i * p.gap, x + (b0 + i) * total + (r_i - first) * hop,
                           piece, landed + STAGES);
      }
    issue(0);
    issue(1);
  }
  __syncthreads();  // the mbarriers are initialised

  // this thread's A rows (g, g + 8 of its two m16 tiles) as span offsets;
  // a row past the last frame reads the span's start (its sums are dropped)
  int a_off[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + m * 16 + g + 8 * h;
      a_off[m][h] = r < nrows ? r * hop + static_cast<int>((row0 + r) / n_frames - b0) * p.gap : 0;
    }

  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  mmautil::mbar_wait(landed + STAGES, 0);  // the span
  for (int st = 0; st < p.slabs; ++st) {
    // one barrier a slab: slab st has landed, and every warp is done with
    // slab st - 1, whose slot thread 0 refills
    mmautil::mbar_wait(landed + st % STAGES, (st / STAGES) & 1);
    __syncthreads();
    issue(st + 2);
    const float4* sp =
        reinterpret_cast<const float4*>(ring + (st % STAGES) * SPLIT_FLOATS) + wn * NTW * 32 + lane;
    const int ksteps = win - st * BK < BK ? (win - st * BK) / 8 : BK / 8;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      if (ks >= ksteps) break;
      const int k = st * BK + ks * 8 + q;
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // rows g, g + 8 x taps q, q + 4
          const float v = span[a_off[m][e & 1] + k + (e >> 1) * 4];
          ab[m][e] = to_tf32(v);
          as[m][e] = to_tf32(v - __uint_as_float(ab[m][e]));
        }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const float4 bv = sp[(ks * (BN / 8) + j) * 32];
        const uint32_t bb[2] = {__float_as_uint(bv.x), __float_as_uint(bv.y)};
        const uint32_t bs[2] = {__float_as_uint(bv.z), __float_as_uint(bv.w)};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_tf32(acc[m][j], as[m], bb);
          mma_tf32(acc[m][j], ab[m], bs);
          mma_tf32(acc[m][j], ab[m], bb);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + m * 16 + g + 8 * h;
      if (r >= nrows) continue;
      float* o = out + (row0 + r) * dim;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int c = col0 + (wn * NTW + j) * 8 + 2 * q;
        if (c < dim)
          *reinterpret_cast<float2*>(o + c) = make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
      }
    }
}

}  // namespace tc

}  // namespace

namespace {

// The design stft_frames_f32 takes: 1 with tc::make_plan's plan, else 0.
int choose(const void* x, const void* basis, const void* out, const void* split,
           long long batch, long long total, int n_frames, int hop, int win, int dim,
           tc::Plan& p) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(basis) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
                       split != nullptr && reinterpret_cast<uintptr_t>(split) % 16 == 0;
  return tc::make_plan(batch, total, n_frames, hop, win, dim, aligned, optin, p) ? 1 : 0;
}

}  // namespace

// Floats of the scratch that the split-f32 design's basis split takes:
// ceil(win / 16) slabs x ceil(dim / 176) column tiles x tc::SPLIT_FLOATS.
extern "C" long long stft_split_floats(int win, int dim) {
  return static_cast<long long>((win + tc::BK - 1) / tc::BK) * ((dim + tc::BN - 1) / tc::BN) *
         tc::SPLIT_FLOATS;
}

// x [batch, total], basis [win, dim], out [batch, n_frames, dim]; all f32,
// contiguous, on the current device; split: stft_split_floats(win, dim)
// f32 of scratch (or null: then the first design runs). Launches on
// `stream` (the split-f32 design: the basis split, then the frames) and
// returns cudaGetLastError() (0 = launched).
extern "C" int stft_frames_f32(const void* x, const void* basis, void* out, void* split,
                               long long batch, long long total, int n_frames,
                               int hop, int win, int dim, void* stream) {
  const long long rows = batch * n_frames;
  const long long row_tiles = (rows + BM - 1) / BM;
  if (row_tiles > 65535 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tc::Plan p;
  if (choose(x, basis, out, split, batch, total, n_frames, hop, win, dim, p)) {
    cudaError_t err = cudaFuncSetAttribute(tc::stft_tf32x3,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           p.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::split_basis<<<dim3(p.col_tiles, p.slabs), tc::THREADS, 0, s>>>(
        static_cast<const float*>(basis), static_cast<float4*>(split), win, dim);
    const dim3 grid(p.col_tiles, static_cast<unsigned>(row_tiles));
    tc::stft_tf32x3<<<grid, tc::THREADS, p.smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float4*>(split), static_cast<float*>(out),
        rows, n_frames, total, hop, win, dim, p);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((dim + BN - 1) / BN, static_cast<unsigned>(row_tiles));
  stft_frames_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(basis),
      static_cast<float*>(out), rows, n_frames, total, hop, win, dim);
  return static_cast<int>(cudaGetLastError());
}

// The design stft_frames_f32 takes on this card for these shapes and
// addresses (`aligned`: x and the scratch at 16 bytes, out at 8), for the
// tests: out[0] = 1 (split-f32 tensor cores) or 0 (the first design); then
// gap, span_floats, col_tiles, smem_bytes of the first. Returns a
// cudaError_t.
extern "C" int stft_plan(long long batch, long long total, int n_frames, int hop, int win,
                         int dim, int aligned, int* out) {
  const void* ptr = reinterpret_cast<const void*>(static_cast<uintptr_t>(aligned ? 256 : 4));
  tc::Plan p{};
  out[0] = choose(ptr, ptr, ptr, ptr, batch, total, n_frames, hop, win, dim, p);
  out[1] = out[0] ? p.gap : 0;
  out[2] = out[0] ? p.span_floats : 0;
  out[3] = out[0] ? p.col_tiles : 0;
  out[4] = out[0] ? p.smem_bytes : 0;
  return static_cast<int>(cudaSuccess);
}
