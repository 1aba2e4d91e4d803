// The LSTM recurrence backward, one launch walking all T steps in reverse,
// for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/lstm.py, `_lstm_bwd_call` /
// `_bwd_kernel` (the Pallas TPU kernel). Walking the forward's visit order
// backwards, per step t, with (dh, dc) carried in f32 from dh_T, dc_T:
//   dh  = dh + dout[t]
//   do  = dh * tanh(c[t]);   dc = dc + dh * o * (1 - tanh(c[t])^2)
//   di  = dc * g;  df = dc * c_prev[t];  dg = dc * i
//   dgates[t] = [di i (1-i), df f (1-f), dg (1-g^2), do o (1-o)]   (i/o type)
//   dh  = dgates[t] (as stored) @ w_hhᵀ   (f32 accumulation);  dc = dc * f
// and after the last step writes dh0 = dh, dc0 = dc. The gates and c are
// read in the i/o type, as the forward stored them. dw_hh = h_prevᵀ dgates
// is one large product outside the kernel (torch.matmul), as XLA does it in
// the JAX package.
//
// What bounds it on an H100: 2 B 4H H FLOPs a step, the forward's count:
// 0.206 TFLOP a layer at CRN's train shape (T 501, B 16, H 1792), 0.21 ms
// at 989 TFLOP/s; its bytes (gates, c, c_prev, dout in, dgates out, ~0.32
// GB) take 0.10 ms at 3.35 TB/s. As in the forward, the sequential steps'
// latency bounds it in practice.
//
// Design (lstm.cuh): as the forward, w_hh split by hidden unit of dh over
// one block per SM, resident in shared memory (U 14 rows of w_hh, 14 x 7168
// bf16 = 200,704 B). Each step the block first computes the pointwise part
// for its own units (it holds their dh and dc) and writes their dgates;
// one grid barrier publishes dgates[t]; then the block multiplies its rows
// by all of dgates[t] (K = 4H, from L2) for its units' next dh. dh and dc
// live in the f32 output arrays dh0 and dc0, which only the owning block
// touches, so one barrier a step suffices. bf16 rows that are not 16-byte
// aligned (4H % 8 != 0, or unaligned dgates or w_hh), f32 with unaligned
// dgates or w_hh or wider than about 790 units, and batches of more than
// 16 x 256 (b, u) pairs a block keep this first design (lstm_bwd_kernel:
// gemm_chunk's register-staged chunks, dh and dc in device memory), where
// its slice fits; the rest (on 132 SMs: f32 from 1408 units, bf16 from
// 1920, where neither the ring nor the split-f32 design fits) take the
// wide design (lstm_bwd_wide; lstm.cuh, namespace wide): this structure
// with the first rounds of the slice's K = 4H range resident and the rest
// streamed from L2 every step through the stage slots that bring in
// dgates[t], mma.sync in bf16 or split-f32 with both operands split in
// registers.
//
// The f32 path whose plan fits (lstm_bwd_f32) is the bf16 ring below with
// split-f32 products (lstm.cuh, namespace tc): the batch as M, the block's
// U units as the columns of one n8 tile (the split slice stores only
// those: 16 KB at H 256, 64 KB at H 512; the lanes of units past U zero
// their B fragment), K = 4H split over the warps, each warp's rows and K
// range of dgates[t] (f32) through its own cp.async ring, the A fragments
// split in registers, three mma.sync m16n8k8 a k8 step, dh and dc in
// registers across all T steps, and the next step's pointwise operands
// loaded right after the grid barrier.
//
// The bf16 path with 16-byte rows (lstm_bwd_ring) is built around the
// step's latency, as the forward's lstm_fwd_ring is. At CRN's train shape
// a step reads all of dgates[t] (16 x 7168 bf16, 229 KB) into every block
// from L2, beside a 200,928-byte resident slice; a warp issues only 112
// mma.sync a step, so the step is the copies' and rounds' latency. What
// each latency sink of the first design became:
//  - staging: the products take the batch as the mma's M (B 16 fills an
//    m16 tile exactly; units 14 and 15 of the n8 tiles are zeroed
//    registers) and the eight warps split K = 4H into contiguous ranges, so
//    a warp copies only its own rows and k: dgates[t] streams through a
//    cp.async.cg ring per warp (16 bytes a copy, zero-filled past B and
//    4H), published by a warp barrier; the K loop has no block barrier.
//    Slab rows are swizzled (16-byte chunk c of row r at c ^ (r / (8 /
//    C)) % C, C = kc / 8 chunks a row) instead of padded, so ldmatrix is
//    free of bank conflicts and the 31 KB beside the slice all goes to the
//    ring. A round has a fixed cost (its wait, copies and loop) about that
//    of two k16 steps, so the plan (make_plan) takes the largest round's k
//    (kc, a template parameter: the copies' and fragments' indexing is
//    then shifts and constants) with a ring of at least three slabs: at
//    CRN's train shape 28 rounds of 32 k a warp in three 1 KB slabs. Each
//    warp walks its rounds from the block's own starting round, as the
//    first design staggers its chunks.
//  - fragments: ldmatrix.x4 for both operands (the slab's [b][k] rows and
//    the slice's [u][k] rows, neither transposed); within a round the next
//    k16 step's fragments are loaded before the current mma.sync.
//  - epilogue: each warp writes its f32 partials once a step (a chunk)
//    into its own ring, and after one block barrier the thread that owns
//    (b, u) sums the K splits in a fixed order. That thread keeps dh and dc
//    in registers across all T steps (dh0 and dc0 are written once, at the
//    end), runs the pointwise part of the next step at once and writes
//    dgates for its unit as 4 stores of the i/o type.
//  - prefetch: the pointwise operands of the next step (four gates, c,
//    c_prev, dout) do not depend on the recurrence; they are loaded into
//    registers right after the grid barrier, so their device-memory
//    latency hides under the products (before the barrier, thread 0's
//    fence would wait for them).
//  - barrier: one grid_sync a step, as before; dgates, which other blocks
//    write during the launch, is read only by cp.async.cg.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "lstm.cuh"
#include "mma_util.cuh"

namespace {

struct BwdArgs {
  const void* gates;  // [T, B, 4H] i, f, g, o
  const void* cseq;   // [T, B, H]
  const void* cprev;  // [T, B, H]: c of the step before in the visit order (c0 first)
  const void* dout;   // [T, B, H]: gradient of h_seq
  const void* w;      // w_hh [H, 4H]
  float* dh;          // [B, H] f32: dh_T in, dh0 out
  float* dc;          // [B, H] f32: dc_T in, dc0 out
  void* dgates;       // [T, B, 4H]
  unsigned int* bar;  // [2], zeroed
  int steps, batch, hidden, reverse, vec;
};

template <typename T>
__global__ void __launch_bounds__(lstm::THREADS)
    lstm_bwd_kernel(const BwdArgs a, const lstm::Plan p) {
  using namespace lstm;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);
  T* stage = reinterpret_cast<T*>(smem + p.stage_offset);
  float* out = reinterpret_cast<float*>(smem + p.out_offset);
  const T* gates = static_cast<const T*>(a.gates);
  const T* cseq = static_cast<const T*>(a.cseq);
  const T* cprev = static_cast<const T*>(a.cprev);
  const T* dout = static_cast<const T*>(a.dout);
  const T* w = static_cast<const T*>(a.w);
  T* dgates = static_cast<T*>(a.dgates);
  const int H = a.hidden, B = a.batch, U = p.units, G4 = 4 * H;
  const int j0 = blockIdx.x * U;

  // the block's slice: row u is w_hh row j0 + u (its 4H gate columns)
  for (long long idx = threadIdx.x; idx < static_cast<long long>(p.rows) * p.pitch;
       idx += THREADS) {
    const int r = static_cast<int>(idx / p.pitch);
    const int k = static_cast<int>(idx - static_cast<long long>(r) * p.pitch);
    ws[idx] = (j0 + r < H && k < G4) ? w[static_cast<long long>(j0 + r) * G4 + k]
                                     : from_f32<T>(0.f);
  }

  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? s : a.steps - 1 - s;
    // the pointwise part for the block's own units
    for (int idx = threadIdx.x; idx < U * B; idx += THREADS) {
      const int b = idx / U;
      const int j = j0 + idx - b * U;
      if (j >= H) continue;
      const long long row = static_cast<long long>(t) * B + b;
      const T* gt = gates + row * G4 + j;
      const float i = to_f32(gt[0]);
      const float f = to_f32(gt[H]);
      const float g = to_f32(gt[2 * H]);
      const float o = to_f32(gt[3 * H]);
      const float tc = tanhf(to_f32(cseq[row * H + j]));
      float* dhp = a.dh + static_cast<long long>(b) * H + j;
      float* dcp = a.dc + static_cast<long long>(b) * H + j;
      const float dh = *dhp + to_f32(dout[row * H + j]);
      const float d_o = dh * tc;
      const float dc = *dcp + dh * o * (1.f - tc * tc);
      const float di = dc * g;
      const float df = dc * to_f32(cprev[row * H + j]);
      const float dg = dc * i;
      T* dgt = dgates + row * G4 + j;
      dgt[0] = from_f32<T>(di * i * (1.f - i));
      dgt[H] = from_f32<T>(df * f * (1.f - f));
      dgt[2 * H] = from_f32<T>(dg * (1.f - g * g));
      dgt[3 * H] = from_f32<T>(d_o * o * (1.f - o));
      *dcp = dc * f;
    }
    grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written
    const T* src = dgates + static_cast<long long>(t) * B * G4;
    for (int n0 = 0; n0 < B; n0 += p.nb) {
      gemm_chunk<T>(p, ws, src, G4, B, n0, a.vec != 0, stage, out);
      for (int idx = threadIdx.x; idx < U * p.nb; idx += THREADS) {
        const int n = idx / U;
        const int u = idx - n * U;
        if (n0 + n < B && j0 + u < H)
          a.dh[static_cast<long long>(n0 + n) * H + j0 + u] = gathered(p, out, u, n);
      }
    }
    __syncthreads();  // the next step's pointwise part reads dh in another thread mapping
  }
}


// -- the bf16 ring path ------------------------------------------------------

namespace ring {

using bf16 = __nv_bfloat16;
constexpr int THREADS = lstm::THREADS;
constexpr int WARPS = lstm::WARPS;
constexpr int KCS[] = {64, 32, 16};  // the round's k, in order of preference
constexpr int MIN_STAGES = 3;        // slabs in a warp's ring: two in flight at least
constexpr int MAX_STAGES = 8;
constexpr int MAX_MW = 4;            // m16 batch tiles a warp holds
constexpr int PART_PITCH = 24;       // floats a partial row: 16 units + 8 (no bank conflicts)
// fixed costs in k of one m16 tile's products (tools/lstm_fwd_phase_probe.py
// --kernel bwd): a round's (its wait, copies and loop, about two k16 steps)
// and a batch chunk's (its ring fill)
constexpr int ROUND_K = 32;
constexpr int CHUNK_K = 256;

// Computed on the host from the shapes (make_plan below); mirrored line for
// line by kernels/lstm.py:bwd_ring_plan.
struct Plan {
  int units;        // U
  int nt;           // n8 unit tiles: 1 (U <= 8) or 2
  int kc;           // k a round: 16, 32 or 64
  int kr;           // rounds over K = 4H: ceil(4H / kc)
  int pitch;        // slice row pitch (elements): kr * kc + 8
  int stages;       // slabs in each warp's ring
  int wm, wk;       // warps along the batch and along K (wm * wk = 8)
  int mw;           // m16 batch tiles a warp holds
  int nb;           // batch rows a chunk: wm * mw * 16
  int chunks;       // ceil(B / nb)
  int rpw;          // rounds a K split: ceil(kr / wk)
  int slab_bytes;   // mw * 16 * kc * 2
  int region;       // bytes of a warp's ring; its partials alias it
  int ring_offset;  // bytes: the slice, then the warps' rings
  int ppt;          // (b, u) pairs a thread owns: 1, 4 or 16
  int smem_bytes;
};

// False when no ring fits beside the slice, or a block has more than
// 16 x 256 (b, u) pairs (the caller then takes the first design).
inline bool make_plan(int units, int hidden, int batch, int smem_limit, Plan& best) {
  if (units <= 0 || units > 16) return false;
  const long long pairs = static_cast<long long>(batch) * units;
  const int ppt = pairs <= THREADS ? 1 : pairs <= 4 * THREADS ? 4 : pairs <= 16 * THREADS ? 16 : 0;
  if (ppt == 0) return false;
  const int k = 4 * hidden;
  long long best_cost = 0;
  int best_flight = 0;
  for (const int kc : KCS) {
    const int kr = (k + kc - 1) / kc;
    const int pitch = kr * kc + 8;
    const int ring_offset = lstm::align16(units * pitch * 2);
    const int region_max = (smem_limit - ring_offset) / WARPS / 16 * 16;
    for (int wm = 1; wm <= WARPS; wm *= 2) {
      const int wk = WARPS / wm;
      for (int mw = 1; mw <= MAX_MW; ++mw) {
        const int slab = mw * 16 * kc * 2;
        const int part = mw * 16 * PART_PITCH * 4;
        int stages = region_max / slab;
        if (stages > MAX_STAGES) stages = MAX_STAGES;
        if (stages < MIN_STAGES) continue;
        const int region = stages * slab > part ? stages * slab : part;
        if (region > region_max) continue;
        const int nb = wm * mw * 16;
        const int chunks = (batch + nb - 1) / nb;
        const int rpw = (kr + wk - 1) / wk;
        // the k of one m16 tile a warp multiplies a step, with each round
        // and each chunk's ring fill counted as ROUND_K and CHUNK_K more,
        // and the bytes of its ring in flight while it multiplies one slab
        const long long cost =
            static_cast<long long>(chunks) * (mw * rpw * (kc + ROUND_K) + CHUNK_K);
        const int flight = (stages - 1) * slab;
        if (best_cost > 0 && (cost > best_cost || (cost == best_cost && flight <= best_flight)))
          continue;
        best_cost = cost;
        best_flight = flight;
        best.units = units;
        best.nt = units > 8 ? 2 : 1;
        best.kc = kc;
        best.kr = kr;
        best.pitch = pitch;
        best.stages = stages;
        best.wm = wm;
        best.wk = wk;
        best.mw = mw;
        best.nb = nb;
        best.chunks = chunks;
        best.rpw = rpw;
        best.slab_bytes = slab;
        best.region = region;
        best.ring_offset = ring_offset;
        best.ppt = ppt;
        best.smem_bytes = ring_offset + WARPS * region;
      }
    }
  }
  return best_cost > 0;
}

using lstm::wait_rounds;

template <int PPT, int KC>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_ring(const BwdArgs a, const Plan p) {
  constexpr int C = KC / 8;                        // 16-byte chunks a slab row
  constexpr int LC = KC == 64 ? 3 : KC == 32 ? 2 : 1;
  constexpr int LR = 3 - LC;                       // log2 of the slab rows a 128-byte line
  constexpr int RPV = 32 / C;                      // slab rows a warp's copy instruction covers
  constexpr int N16 = KC / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  const bf16* gates = static_cast<const bf16*>(a.gates);
  const bf16* cseq = static_cast<const bf16*>(a.cseq);
  const bf16* cprev = static_cast<const bf16*>(a.cprev);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const bf16* w = static_cast<const bf16*>(a.w);
  bf16* dgates = static_cast<bf16*>(a.dgates);
  const int H = a.hidden, B = a.batch, U = p.units, G4 = 4 * H;
  const int j0 = blockIdx.x * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int split = warp / p.wm, wmi = warp - split * p.wm;
  unsigned char* region = smem + p.ring_offset + warp * p.region;

  // the block's slice, 16 bytes a load: row u is w_hh row j0 + u, zero past
  // 4H and past the last unit
  {
    const int vrow = p.pitch / 8;
    for (int idx = threadIdx.x; idx < U * vrow; idx += THREADS) {
      const int r = idx / vrow;
      const int k = (idx - r * vrow) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < H && k < G4)
        v = *reinterpret_cast<const uint4*>(w + static_cast<long long>(j0 + r) * G4 + k);
      *reinterpret_cast<uint4*>(ws + r * p.pitch + k) = v;
    }
    __syncthreads();
  }

  // ldmatrix addresses of this lane. A (the slab, [mw * 16 rows][KC],
  // chunk c of row r at c ^ (r >> LR) % C): matrix lane / 8 is (rows 0-7 |
  // 8-15) x (k 0-7 | 8-15) of m-tile m. B (the slice): matrix lane / 8 is
  // (units 0-7 | 8-15) x (k 0-7 | 8-15); a unit past U reads row U - 1 (the
  // same address as unit U - 1: no bank conflict), and the lanes that
  // receive it zero their fragment (b_zero).
  int a_row[MAX_MW], a_sw[MAX_MW];
#pragma unroll
  for (int m = 0; m < MAX_MW; ++m) {
    const int row = m * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_row[m] = row * KC;
    a_sw[m] = (row >> LR) & (C - 1);
  }
  const int a_hi = lane >> 4;
  const bf16* b_ptr;
  {
    const int mi = lane >> 3;
    const int unit = (lane & 7) + 8 * (mi >> 1);
    b_ptr = ws + (unit < U ? unit : U - 1) * p.pitch + (mi & 1) * 8;
  }
  const bool zero0 = g >= U, zero1 = g + 8 >= U;  // n8 tiles of units past U

  // the (b, u) pairs this thread owns: pair tid + 256 i is (b, u) =
  // divmod(tid + 256 i, U), kept while b < B and j0 + u < H
  int pb[PPT], pu[PPT];
  float dh[PPT], dc[PPT];
  __nv_bfloat162 gif[PPT], ggo[PPT], ccp[PPT];  // gates i, f; g, o; c, c_prev
  bf16 dov[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pair = threadIdx.x + THREADS * i;
    pb[i] = pair / U;
    pu[i] = pair - pb[i] * U;
    if (pb[i] >= B || j0 + pu[i] >= H) pb[i] = -1;
    const long long o = static_cast<long long>(pb[i]) * H + j0 + pu[i];
    dh[i] = pb[i] >= 0 ? a.dh[o] : 0.f;
    dc[i] = pb[i] >= 0 ? a.dc[o] : 0.f;
  }
  // the pointwise operands of step t into registers
  const auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (pb[i] < 0) continue;
      const long long row = static_cast<long long>(t) * B + pb[i];
      const bf16* gt = gates + row * G4 + j0 + pu[i];
      gif[i] = __halves2bfloat162(gt[0], gt[H]);
      ggo[i] = __halves2bfloat162(gt[2 * H], gt[3 * H]);
      const long long o = row * H + j0 + pu[i];
      ccp[i] = __halves2bfloat162(cseq[o], cprev[o]);
      dov[i] = dout[o];
    }
  };

  // this warp's rounds: a contiguous range of the K splits' rounds, walked
  // from the block's own starting round
  const int r_begin = split * p.rpw;
  const int ns = p.kr - r_begin < p.rpw ? (p.kr - r_begin > 0 ? p.kr - r_begin : 0) : p.rpw;
  const int r_first = r_begin + (ns > 0 ? static_cast<int>(blockIdx.x % ns) : 0);
  const int r_end = r_begin + ns;
  // the lane's copies: 16-byte chunk `ch` of slab rows crow, crow + RPV, ...
  const int ch = lane & (C - 1), crow = lane >> LC;

  float acc[MAX_MW][2][4];
  prefetch(a.reverse ? 0 : a.steps - 1);
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? s : a.steps - 1 - s;
    const long long trow = static_cast<long long>(t) * B;
    // the pointwise part for the thread's own pairs, from registers
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (pb[i] < 0) continue;
      const float ig = __low2float(gif[i]);
      const float fg = __high2float(gif[i]);
      const float gg = __low2float(ggo[i]);
      const float og = __high2float(ggo[i]);
      const float tc = tanhf(__low2float(ccp[i]));
      const float dhv = dh[i] + __bfloat162float(dov[i]);
      const float d_o = dhv * tc;
      const float dcv = dc[i] + dhv * og * (1.f - tc * tc);
      const float di = dcv * gg;
      const float df = dcv * __high2float(ccp[i]);
      const float dg = dcv * ig;
      bf16* dgt = dgates + (trow + pb[i]) * G4 + j0 + pu[i];
      dgt[0] = __float2bfloat16(di * ig * (1.f - ig));
      dgt[H] = __float2bfloat16(df * fg * (1.f - fg));
      dgt[2 * H] = __float2bfloat16(dg * (1.f - gg * gg));
      dgt[3 * H] = __float2bfloat16(d_o * og * (1.f - og));
      dc[i] = dcv * fg;
    }
    lstm::grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written
    if (s + 1 < a.steps) prefetch(a.reverse ? t + 1 : t - 1);  // lands under the products

    for (int c = 0; c < p.chunks; ++c) {
      const int row0 = c * p.nb + wmi * p.mw * 16;  // the warp's first batch row
      int nv = (B - row0 + 15) / 16;                // its m16 tiles that hold batch rows
      nv = nv < 0 ? 0 : (nv < p.mw ? nv : p.mw);
#pragma unroll
      for (int m = 0; m < MAX_MW; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

      // the copies of a round: instruction v copies row crow + v RPV,
      // chunk ch, at k r KC + 8 ch; zero past B and 4H
      const int copies = nv * 16 / RPV;  // copy instructions a lane issues a round
      const bf16* src_lane = dgates + (trow + row0 + crow) * G4 + ch * 8;
      const int rows_left = B - row0 - crow;  // rows of this lane's column still in the batch
      int r_next = r_first, slot_next = 0, issued = 0;
      const auto issue = [&]() {
        if (issued < ns) {
          bf16* slab = reinterpret_cast<bf16*>(region + slot_next * p.slab_bytes);
          const bool k_ok = r_next * KC + ch * 8 < G4;
          const bf16* src = src_lane + r_next * KC;
#pragma unroll
          for (int v = 0; v < MAX_MW * 16 / RPV; ++v) {
            if (v >= copies) break;
            const int row = crow + v * RPV;
            const bool ok = k_ok && v * RPV < rows_left;
            mmautil::cp_async16(slab + row * KC + ((ch ^ ((row >> LR) & (C - 1))) << 3),
                                ok ? src + static_cast<long long>(v * RPV) * G4 : dgates, ok);
          }
          if (++r_next == r_end) r_next = r_begin;
          if (++slot_next == p.stages) slot_next = 0;
        }
        mmautil::cp_async_commit();  // an empty group past the last round keeps the count
        ++issued;
      };
      for (int i = 0; i < p.stages - 1; ++i) issue();
      int r_cur = r_first, slot_cur = 0;
      for (int j = 0; j < ns; ++j) {
        wait_rounds(p.stages - 2);  // this lane's copies of round j have landed
        __syncwarp();               // the warp's have, and it is done with the slot it refills
        issue();
        if (nv > 0) {
          const bf16* slab = reinterpret_cast<const bf16*>(region + slot_cur * p.slab_bytes);
          const bf16* bk = b_ptr + r_cur * KC;
          // the k16 steps of the round, each step's fragments loaded before
          // the previous step's products
          uint32_t af[2][MAX_MW][4], bfr[2][4];
#pragma unroll
          for (int kk = 0; kk < N16; ++kk) {
            const int cur = kk & 1;
#pragma unroll
            for (int m = 0; m < MAX_MW; ++m)
              if (m < nv)
                mmautil::ldsm_x4(af[cur][m],
                                 slab + a_row[m] + (((2 * kk + a_hi) ^ a_sw[m]) << 3));
            if (p.nt == 2) {
              mmautil::ldsm_x4(bfr[cur], bk + 16 * kk);
            } else {
              mmautil::ldsm_x2(bfr[cur], bk + 16 * kk);
            }
            if (zero0) bfr[cur][0] = bfr[cur][1] = 0u;
            if (zero1) bfr[cur][2] = bfr[cur][3] = 0u;
            if (kk > 0) {
#pragma unroll
              for (int m = 0; m < MAX_MW; ++m)
                if (m < nv) {
                  mmautil::mma_bf16(acc[m][0], af[cur ^ 1][m], bfr[cur ^ 1]);
                  if (p.nt == 2) mmautil::mma_bf16(acc[m][1], af[cur ^ 1][m], bfr[cur ^ 1] + 2);
                }
            }
          }
          constexpr int LAST = (N16 - 1) & 1;
#pragma unroll
          for (int m = 0; m < MAX_MW; ++m)
            if (m < nv) {
              mmautil::mma_bf16(acc[m][0], af[LAST][m], bfr[LAST]);
              if (p.nt == 2) mmautil::mma_bf16(acc[m][1], af[LAST][m], bfr[LAST] + 2);
            }
        }
        if (++r_cur == r_end) r_cur = r_begin;
        if (++slot_cur == p.stages) slot_cur = 0;
      }

      // the warp's f32 partials into its own ring (no copy is in flight),
      // [mw * 16 rows b][PART_PITCH], then the owners sum the K splits in
      // a fixed order
      __syncwarp();
      float* part = reinterpret_cast<float*>(region);
#pragma unroll
      for (int m = 0; m < MAX_MW; ++m)
        if (m < nv)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            if (n < p.nt) {
              float* o = part + (m * 16 + g) * PART_PITCH + n * 8 + 2 * q;
              *reinterpret_cast<float2*>(o) = make_float2(acc[m][n][0], acc[m][n][1]);
              *reinterpret_cast<float2*>(o + 8 * PART_PITCH) =
                  make_float2(acc[m][n][2], acc[m][n][3]);
            }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int bl = pb[i] - c * p.nb;
        if (pb[i] < 0 || bl < 0 || bl >= p.nb) continue;
        const int wg = bl / (p.mw * 16);
        const int row = bl - wg * p.mw * 16;
        float v = 0.f;
        for (int sp = 0; sp < p.wk; ++sp) {
          const float* pp = reinterpret_cast<const float*>(smem + p.ring_offset +
                                                           (sp * p.wm + wg) * p.region);
          v += pp[row * PART_PITCH + pu[i]];
        }
        dh[i] = v;
      }
      if (c + 1 < p.chunks) __syncthreads();  // the next chunk's copies overwrite the partials
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (pb[i] < 0) continue;
    const long long o = static_cast<long long>(pb[i]) * H + j0 + pu[i];
    a.dh[o] = dh[i];
    a.dc[o] = dc[i];
  }
}

template <int PPT>
int launch_kc(const BwdArgs& a, const Plan& p, int blocks, cudaStream_t stream) {
  return p.kc == 64   ? lstm::launch(lstm_bwd_ring<PPT, 64>, a, p, blocks, stream)
         : p.kc == 32 ? lstm::launch(lstm_bwd_ring<PPT, 32>, a, p, blocks, stream)
                      : lstm::launch(lstm_bwd_ring<PPT, 16>, a, p, blocks, stream);
}

inline int launch(const BwdArgs& a, const Plan& p, int blocks, cudaStream_t stream) {
  return p.ppt == 1   ? launch_kc<1>(a, p, blocks, stream)
         : p.ppt == 4 ? launch_kc<4>(a, p, blocks, stream)
                      : launch_kc<16>(a, p, blocks, stream);
}

}  // namespace ring

// -- the split-f32 path ------------------------------------------------------

namespace f32 {

using lstm::THREADS;
using lstm::tc::Plan;

// The plan of the f32 design for U units a block: N = U columns (unit u at
// column u), K = 4H; false where it does not fit.
inline bool make_plan(int units, int hidden, int batch, int smem_limit, Plan& p) {
  return lstm::tc::make_plan(units, 1, units, 4 * hidden, batch, smem_limit, p);
}

template <int PPT>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_f32(const BwdArgs a, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  const float* gates = static_cast<const float*>(a.gates);
  const float* cseq = static_cast<const float*>(a.cseq);
  const float* cprev = static_cast<const float*>(a.cprev);
  const float* dout = static_cast<const float*>(a.dout);
  const float* w = static_cast<const float*>(a.w);
  float* dgates = static_cast<float*>(a.dgates);
  const int H = a.hidden, B = a.batch, U = p.units, G4 = 4 * H;
  const int j0 = blockIdx.x * U;

  // the block's slice, split once: column u is w_hh row j0 + u, 16 bytes
  // (four k) a load; zero past 4H and past the last unit
  {
    const int kv = p.kr * lstm::tc::KC / 4;
    for (int idx = threadIdx.x; idx < U * kv; idx += THREADS) {
      const int u = idx / kv;
      const int k = (idx - u * kv) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + u < H && k < G4)
        v = *reinterpret_cast<const float4*>(w + static_cast<long long>(j0 + u) * G4 + k);
      lstm::tc::put_split(ws, p, k, 0, u, v.x);
      lstm::tc::put_split(ws, p, k + 1, 0, u, v.y);
      lstm::tc::put_split(ws, p, k + 2, 0, u, v.z);
      lstm::tc::put_split(ws, p, k + 3, 0, u, v.w);
    }
    __syncthreads();
  }

  // the (b, u) pairs this thread owns: pair tid + 256 i is (b, u) =
  // divmod(tid + 256 i, U), kept while b < B and j0 + u < H; their dh and dc
  // in registers across the steps, their pointwise operands a step ahead
  int pb[PPT], pu[PPT];
  float dh[PPT], dc[PPT], gv[PPT][4], cv[PPT], cpv[PPT], dov[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pair = threadIdx.x + THREADS * i;
    pb[i] = pair / U;
    pu[i] = pair - pb[i] * U;
    if (pb[i] >= B || j0 + pu[i] >= H) pb[i] = -1;
    const long long o = static_cast<long long>(pb[i]) * H + j0 + pu[i];
    dh[i] = pb[i] >= 0 ? a.dh[o] : 0.f;
    dc[i] = pb[i] >= 0 ? a.dc[o] : 0.f;
  }
  const auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (pb[i] < 0) continue;
      const long long row = static_cast<long long>(t) * B + pb[i];
      const float* gt = gates + row * G4 + j0 + pu[i];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) gv[i][gate] = gt[gate * H];
      const long long o = row * H + j0 + pu[i];
      cv[i] = cseq[o];
      cpv[i] = cprev[o];
      dov[i] = dout[o];
    }
  };

  prefetch(a.reverse ? 0 : a.steps - 1);
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? s : a.steps - 1 - s;
    const long long trow = static_cast<long long>(t) * B;
    // the pointwise part for the thread's own pairs, from registers
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (pb[i] < 0) continue;
      const float ig = gv[i][0], fg = gv[i][1], gg = gv[i][2], og = gv[i][3];
      const float tc = tanhf(cv[i]);
      const float dhv = dh[i] + dov[i];
      const float d_o = dhv * tc;
      const float dcv = dc[i] + dhv * og * (1.f - tc * tc);
      const float di = dcv * gg;
      const float df = dcv * cpv[i];
      const float dg = dcv * ig;
      float* dgt = dgates + (trow + pb[i]) * G4 + j0 + pu[i];
      dgt[0] = di * ig * (1.f - ig);
      dgt[H] = df * fg * (1.f - fg);
      dgt[2 * H] = dg * (1.f - gg * gg);
      dgt[3 * H] = d_o * og * (1.f - og);
      dc[i] = dcv * fg;
    }
    lstm::grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written
    if (s + 1 < a.steps) prefetch(a.reverse ? t + 1 : t - 1);  // lands under the products

    for (int c = 0; c < p.chunks; ++c) {
      lstm::tc::warp_chunk<1, lstm::tc::max_mw(1)>(p, ws, smem, dgates + trow * G4, G4, B, c);
      __syncthreads();  // every warp's partials are in its ring
      // the owners sum the K splits in a fixed order
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int bl = pb[i] - c * p.nb;
        if (pb[i] < 0 || bl < 0 || bl >= p.nb) continue;
        float v = 0.f;
        for (int sp = 0; sp < p.wk; ++sp) v += lstm::tc::partial_row(smem, p, sp, bl)[pu[i]];
        dh[i] = v;
      }
      if (c + 1 < p.chunks) __syncthreads();  // the next chunk's copies overwrite the partials
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (pb[i] < 0) continue;
    const long long o = static_cast<long long>(pb[i]) * H + j0 + pu[i];
    a.dh[o] = dh[i];
    a.dc[o] = dc[i];
  }
}

inline int launch(const BwdArgs& a, const Plan& p, int blocks, cudaStream_t stream) {
  return p.ppt == 1   ? lstm::launch(lstm_bwd_f32<1>, a, p, blocks, stream)
         : p.ppt == 4 ? lstm::launch(lstm_bwd_f32<4>, a, p, blocks, stream)
                      : lstm::launch(lstm_bwd_f32<16>, a, p, blocks, stream);
}

}  // namespace f32

// -- the wide path -----------------------------------------------------------

// The widths no other design holds (lstm.cuh, namespace wide): the first
// res_rounds rounds of the slice (U rows of w_hh, K = 4H) resident, the
// rest streamed through the stage slots with dgates[t] each step. As in the
// first design, dh and dc live in dh0 and dc0, which only the owning block
// touches: the pointwise part reads them in (b, u) order, split 0's
// threads write dh from their accumulators.
template <typename T, int NTW>
__global__ void __launch_bounds__(lstm::THREADS, 1)
    lstm_bwd_wide(const BwdArgs a, const lstm::wide::Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* gates = static_cast<const T*>(a.gates);
  const T* cseq = static_cast<const T*>(a.cseq);
  const T* cprev = static_cast<const T*>(a.cprev);
  const T* dout = static_cast<const T*>(a.dout);
  const T* w = static_cast<const T*>(a.w);
  T* dgates = static_cast<T*>(a.dgates);
  const int H = a.hidden, B = a.batch, U = p.units, G4 = 4 * H;
  const int j0 = blockIdx.x * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const bool owner = warp < p.wn;  // split 0: writes dh
  lstm::wide::load_resident(p, reinterpret_cast<T*>(smem), w, j0, H, a.vec != 0);

  float acc[NTW][1][4];
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? s : a.steps - 1 - s;
    // the pointwise part for the block's own units
    for (int idx = threadIdx.x; idx < U * B; idx += lstm::THREADS) {
      const int b = idx / U;
      const int j = j0 + idx - b * U;
      if (j >= H) continue;
      const long long row = static_cast<long long>(t) * B + b;
      const T* gt = gates + row * G4 + j;
      const float i = lstm::to_f32(gt[0]);
      const float f = lstm::to_f32(gt[H]);
      const float gg = lstm::to_f32(gt[2 * H]);
      const float o = lstm::to_f32(gt[3 * H]);
      const float tc = tanhf(lstm::to_f32(cseq[row * H + j]));
      float* dhp = a.dh + static_cast<long long>(b) * H + j;
      float* dcp = a.dc + static_cast<long long>(b) * H + j;
      const float dh = *dhp + lstm::to_f32(dout[row * H + j]);
      const float d_o = dh * tc;
      const float dc = *dcp + dh * o * (1.f - tc * tc);
      const float di = dc * gg;
      const float df = dc * lstm::to_f32(cprev[row * H + j]);
      const float dg = dc * i;
      T* dgt = dgates + row * G4 + j;
      dgt[0] = lstm::from_f32<T>(di * i * (1.f - i));
      dgt[H] = lstm::from_f32<T>(df * f * (1.f - f));
      dgt[2 * H] = lstm::from_f32<T>(dg * (1.f - gg * gg));
      dgt[3 * H] = lstm::from_f32<T>(d_o * o * (1.f - o));
      *dcp = dc * f;
    }
    lstm::grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written
    const T* src = dgates + static_cast<long long>(t) * B * G4;
    for (int n0 = 0; n0 < B; n0 += p.nb) {
      lstm::wide::wide_chunk<T, 1, NTW>(p, smem, w, j0, H, src, G4, B, n0, a.vec != 0, acc);
      if (!owner) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = n0 + (warp * NTW + j) * 8 + 2 * q + (e & 1);
          const int u = g + 8 * (e >> 1);
          if (b < B && u < U && j0 + u < H)
            a.dh[static_cast<long long>(b) * H + j0 + u] = acc[j][0][e];
        }
    }
    __syncthreads();  // the next step's pointwise part reads dh in another thread mapping
  }
}

template <typename T>
int launch_wide(const BwdArgs& a, const lstm::wide::Plan& p, int blocks, cudaStream_t stream) {
  switch (p.ntw) {
    case 1: return lstm::launch(lstm_bwd_wide<T, 1>, a, p, blocks, stream);
    case 2: return lstm::launch(lstm_bwd_wide<T, 2>, a, p, blocks, stream);
    case 3: return lstm::launch(lstm_bwd_wide<T, 3>, a, p, blocks, stream);
    default: return lstm::launch(lstm_bwd_wide<T, 4>, a, p, blocks, stream);
  }
}

// Which design run() takes for these shapes (3: the wide design, 2: the
// split-f32 design, 1: the bf16 ring, 0: the first design; -1: refused)
// and its plan. The wide design takes exactly the shapes whose first-design
// plan exceeds optin where neither the ring nor the split-f32 design fits.
template <typename T>
int choose(const BwdArgs& a, int sms, int optin, ring::Plan& rp, f32::Plan& fp,
           lstm::wide::Plan& wp) {
  const int units = sms > 0 ? lstm::units_per_block(a.hidden, sms) : 0;
  if (units == 0) return -1;
  constexpr int V = 16 / sizeof(T);
  // 16-byte rows of dgates and of the slice
  const bool rows16 = (4 * a.hidden) % V == 0 && reinterpret_cast<uintptr_t>(a.dgates) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  if (rows16) {
    if (sizeof(T) == 2 && ring::make_plan(units, a.hidden, a.batch, optin, rp)) return 1;
    if (sizeof(T) == 4 && f32::make_plan(units, a.hidden, a.batch, optin, fp)) return 2;
  }
  if (lstm::make_plan(sizeof(T), units, units, 4 * a.hidden, a.batch).smem_bytes <= optin)
    return 0;
  return lstm::wide::make_plan(sizeof(T), units, 1, 4 * a.hidden, a.batch, optin, wp) ? 3 : -1;
}

template <typename T>
int run(BwdArgs a, cudaStream_t stream) {
  const int sms = lstm::multiprocessors();
  int optin = 0;
  if (const int err = lstm::optin_smem(optin)) return err;
  ring::Plan rp;
  f32::Plan fp;
  lstm::wide::Plan wp;
  const int design = choose<T>(a, sms, optin, rp, fp, wp);
  if (design < 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int units = lstm::units_per_block(a.hidden, sms);
  const int blocks = (a.hidden + units - 1) / units;
  if (design == 1) return ring::launch(a, rp, blocks, stream);
  if (design == 2) return f32::launch(a, fp, blocks, stream);
  constexpr int V = 16 / sizeof(T);
  a.vec = (4 * a.hidden) % V == 0 && reinterpret_cast<uintptr_t>(a.dgates) % 16 == 0;
  if (design == 3) {
    a.vec = a.vec && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
    return launch_wide<T>(a, wp, blocks, stream);
  }
  const lstm::Plan p = lstm::make_plan(sizeof(T), units, units, 4 * a.hidden, a.batch);
  return lstm::launch(lstm_bwd_kernel<T>, a, p, blocks, stream);
}

}  // namespace

// The backward over all steps; returns cudaGetLastError() (or
// cudaErrorCooperativeLaunchTooLarge where H needs more than 16 units a
// block).
extern "C" int lstm_bwd(int is_bf16, const void* gates, const void* cseq, const void* cprev,
                        const void* dout, const void* w, float* dh, float* dc, void* dgates,
                        unsigned int* bar, int steps, int batch, int hidden, int reverse,
                        cudaStream_t stream) {
  if (steps <= 0 || batch <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{gates, cseq, cprev, dout, w, dh, dc, dgates, bar, steps, batch, hidden,
                  reverse, 0};
  return is_bf16 ? run<__nv_bfloat16>(a, stream) : run<float>(a, stream);
}

// The design lstm_bwd takes on this card for these shapes, for the tests
// (`aligned`: dgates and w_hh at 16-byte addresses, else at the element's
// size): out[0] = 3 (the wide design), 2 (the split-f32 design), 1 (the
// bf16 ring), 0 (the first design) or -1 (refused); then its plan's fields,
// in the order of f32::Plan (units, nt, cols, k, kr, stages, wm, wk, mw,
// nb, chunks, rpw, pitch, slab_bytes, region, ring_offset, ppt, smem_bytes),
// of ring::Plan (units, nt, kc, kr, pitch, stages, wm, wk, mw, nb, chunks,
// rpw, region, ring_offset, ppt, smem_bytes) or of lstm::wide::Plan (units,
// mt, rows, k, kstep, wn, wk, ntw, nb, chunks, kc, kr, res_rounds, pitch,
// spitch, stage_offset, slot_bytes, part_offset, smem_bytes); zero past
// them. Returns a cudaError_t.
extern "C" int lstm_bwd_plan(int is_bf16, int hidden, int batch, int aligned, int* out) {
  int optin = 0;
  if (const int err = lstm::optin_smem(optin)) return err;
  // only the alignment of these two pointers is read
  const uintptr_t addr = aligned ? 256 : (is_bf16 ? 2 : 4);
  BwdArgs a{};
  a.w = reinterpret_cast<const void*>(addr);
  a.dgates = reinterpret_cast<void*>(addr);
  a.hidden = hidden;
  a.batch = batch;
  ring::Plan rp{};
  f32::Plan fp{};
  lstm::wide::Plan wp{};
  const int sms = lstm::multiprocessors();
  out[0] = is_bf16 ? choose<__nv_bfloat16>(a, sms, optin, rp, fp, wp)
                   : choose<float>(a, sms, optin, rp, fp, wp);
  const int f[] = {fp.units, fp.nt, fp.cols, fp.k, fp.kr, fp.stages, fp.wm, fp.wk, fp.mw,
                   fp.nb, fp.chunks, fp.rpw, fp.pitch, fp.slab_bytes, fp.region, fp.ring_offset,
                   fp.ppt, fp.smem_bytes};
  const int r[] = {rp.units, rp.nt, rp.kc, rp.kr, rp.pitch, rp.stages, rp.wm, rp.wk, rp.mw,
                   rp.nb, rp.chunks, rp.rpw, rp.region, rp.ring_offset, rp.ppt, rp.smem_bytes};
  const int w[] = {wp.units, wp.mt, wp.rows, wp.k, wp.kstep, wp.wn, wp.wk, wp.ntw, wp.nb,
                   wp.chunks, wp.kc, wp.kr, wp.res_rounds, wp.pitch, wp.spitch, wp.stage_offset,
                   wp.slot_bytes, wp.part_offset, wp.smem_bytes};
  for (int i = 0; i < 19; ++i)
    out[1 + i] = out[0] == 3   ? w[i]
                 : out[0] == 2 ? (i < 18 ? f[i] : 0)
                 : out[0] == 1 ? (i < 16 ? r[i] : 0)
                               : 0;
  return static_cast<int>(cudaSuccess);
}
