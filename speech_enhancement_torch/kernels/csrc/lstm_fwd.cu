// The LSTM recurrence forward over pre-projected inputs, one launch for all
// T steps, for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/lstm.py, `_lstm_fwd_call` /
// `_fwd_kernel` (the Pallas TPU kernel). Per step t, in the visit order
// (t = 0 .. T-1, or T-1 .. 0 with `reverse`):
//   lin   = x_proj[t] (f32) + h_prev (i/o type) @ w_hh   (f32 accumulation)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of lin's four H-wide parts
//   c     = f * c_prev + i * g      (f32 carry)
//   h     = o * tanh(c)
// storing h_seq[t], c_seq[t] (i/o type) and gates[t] = [i, f, g, o] (i/o
// type). h_prev is h0, then h_seq of the step before, rounded to the i/o
// type as stored, which is what the TPU kernel's dot reads.
//
// What bounds it on an H100: 2 B H 4H FLOPs a step. At CRN's serving shape
// (T 501, B 192, H 1792, bf16) that is 2.47 TFLOP a layer against 3.45 GB
// of x_proj in and h, c, gates out: 2.5 ms at 989 TFLOP/s, 1.0 ms at 3.35
// TB/s, so operations bound it. At the train batch (B 16) the bound is
// 0.21 ms, but the T steps are sequential: each needs all of the step
// before, so the step's latency (a barrier and a [B, H] x [H, 4H] product
// spread over the card) bounds it, not the rates. In this design every
// block also rereads all of h_prev from L2 each step (91 MB a step at
// B 192).
//
// Design (lstm.cuh): the TPU kernel holds the whole w_hh (25.7 MB in bf16
// at H 1792) in VMEM. Here it is split by hidden unit over one block per
// SM: a block owns U units and their four gate columns, 4U rows of w_hhᵀ
// (U 14: 56 x 1800 bf16 = 201,600 B of its 227 KB of shared memory), read
// from device memory once. Each step it multiplies its rows by the whole
// h_prev (from L2), and the gate math and the c update stay inside the
// block. One grid barrier a step publishes h_t. A width that needs more
// than 16 units a block is refused with cudaErrorCooperativeLaunchTooLarge
// rather than launched; a width whose slice does not fit beside the
// staging takes the wide design (below).
//
// The bf16 path with 16-byte rows (lstm_fwd_ring; H % 8 == 0 and aligned
// h0, h_seq) is built around the step's latency. A step is a sequence of
// rounds, each a [NB columns x KC] slab of h_prev; a warp owns NTW column
// tiles of 8 and all of the slice's rows, so its accumulators hold a batch
// chunk's whole product. What each latency sink of the first design
// became:
//  - staging: a ring of 3 slabs filled by cp.async.cg (16 bytes a copy,
//    zero-filled past B and H), one commit group a round; while a round is
//    multiplied the next two are in flight, and the ring runs on across
//    batch chunks, so it fills only once a step, after the grid barrier.
//    Each warp copies only the rows and k16 steps it multiplies, so a
//    warp barrier, not a block barrier, publishes a slab and the warps do
//    not wait on each other between rounds. Rows are padded by 16 bytes,
//    which keeps ldmatrix free of bank conflicts. KC is a power of two, so
//    a lane copies one fixed 16-byte column and the copy loop holds no
//    division.
//  - fragments: ldmatrix.x4 for A (the slice) and .x4 / .x2 for B (the
//    slab, stored [n][k], so no .trans), one instruction where there were
//    four or two scalar loads, and the next k16 step's fragments are
//    loaded before the current step's mma.sync.
//  - epilogue: the slice's rows are laid out in the mma's row space as
//    m-tile k = gate k, row r = unit r (U > 8), or two gates a tile, rows
//    g and g + 8 (U <= 8), so each thread holds i, f, g and o of its units
//    at its columns: the gate math runs from registers, and x_proj and
//    the f32 carry are loaded at the start of the chunk's K loop (the
//    first chunk's before the grid barrier), so their latency hides
//    behind the products. Only where a batch is too narrow for the eight
//    warps (B < 64) do warps split K, and their partials meet once a step
//    in shared memory.
//  - barrier: one grid_sync a step, as before.
// What bounds it as built (tools/lstm_fwd_phase_probe.py, H100 80GB HBM3
// at 700 W): the rounds, not the copies' latency. At B 192 the slice
// leaves 30.8 KB, so a round is 192 columns x 16 k (112 a step); the
// rounds' copy issue, k16 steps of products and loop take nine tenths of
// the step, waiting for a landed slab under a tenth. Fewer, larger rounds
// are the next lever.
// The f32 path with 16-byte rows whose plan fits (lstm_fwd_f32: H % 4 ==
// 0, h0, h_seq and w_hhᵀ at 16-byte addresses, at most about 790 units,
// at most 16 x 256 (b, u) pairs a block) takes split-f32 products on
// tensor cores in the bf16 backward ring's structure (lstm.cuh, namespace
// tc): the batch is the mma's M (B 192 is 12 m16 tiles; B 8 half of one),
// the block's 4U gate columns are N, laid out unit-major (column 4u +
// gate, so a unit's four gates are one float4 of the partials), K = H.
// The slice is split once into big and small TF32 parts, resident in the
// mma's fragment order (16 KB at H 256, 64 KB at H 512); each warp streams
// its batch rows and K range of h_prev through its own cp.async ring and
// splits its A fragments in registers; the thread that owns (b, u) sums
// the K splits, keeps c in registers across the steps and has x_proj
// loaded a step ahead (after the grid barrier, under the products). What
// each latency sink of the first design became: the serial fmaf chains
// over a runtime-length chunk (two shared loads an FMA, an 8-way bank
// conflict a load at f32's 72-word pitch) became three mma.sync m16n8k8 a
// k8 step from conflict-free fragments (ldmatrix at a 36-word pitch, one
// 16-byte load of the split slice); the two block barriers a staged chunk
// became one warp barrier a round and one block barrier a chunk. What
// bounds it as built (tools/lstm_fwd_phase_probe.py --dtype float32, H100
// 80GB HBM3 at 700 W; 15 us a step at B 192, H 256): the split products
// (4 us; each h_prev value feeds only 4U columns a block, so its split is a
// large share of them), the copies of h_prev, which every block reads
// whole from L2 each step (196,608 bytes; 3 us), the grid barrier (3 us)
// and the owners' gate math (2 us).
// bf16 rows that are not 16-byte aligned, and f32 shapes that no split-f32
// plan takes, keep the first design (lstm_fwd_kernel: gemm_chunk's
// register-staged chunks and an f32 output buffer in shared memory).
// The shapes that no design above holds (on 132 SMs: f32 from 1280 units
// at B 192, from 1408 at B 16, from 1152 at B 8; bf16 from 1920) take the
// wide design (lstm_fwd_wide; lstm.cuh, namespace wide): the first
// rounds of the slice's K range resident, the rest streamed from L2 every
// step through the stage slots that bring in h_prev, mma.sync in bf16 or
// split-f32 with both operands split in registers. At CRN's f32 width (H
// 1792, B 192, T 501) that is 2.47 TFLOP a layer: 14.99 ms at 3xTF32's
// 165 TFLOP/s against 2.07 ms of bytes, so operations bound it; the
// streamed part of w_hh (about 70% at B 192) adds about 32 MB of L2 reads a
// step, which the products hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "lstm.cuh"

namespace {

struct FwdArgs {
  const void* xp;     // [T, B, 4H]
  const void* wt;     // w_hhᵀ [4H, H]: row gate * H + j is gate column j of w_hh
  const void* h0;     // [B, H]
  float* c;           // [B, H] f32 carry: c0 in, c_last (unrounded) out
  void* hseq;         // [T, B, H]
  void* cseq;         // [T, B, H]
  void* gates;        // [T, B, 4H]
  unsigned int* bar;  // [2], zeroed
  int steps, batch, hidden, reverse, vec;
};

template <typename T>
__global__ void __launch_bounds__(lstm::THREADS)
    lstm_fwd_kernel(const FwdArgs a, const lstm::Plan p) {
  using namespace lstm;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);
  T* stage = reinterpret_cast<T*>(smem + p.stage_offset);
  float* out = reinterpret_cast<float*>(smem + p.out_offset);
  const T* xp = static_cast<const T*>(a.xp);
  const T* wt = static_cast<const T*>(a.wt);
  T* hseq = static_cast<T*>(a.hseq);
  T* cseq = static_cast<T*>(a.cseq);
  T* gates = static_cast<T*>(a.gates);
  const int H = a.hidden, B = a.batch, U = p.units;
  const int j0 = blockIdx.x * U;

  // the block's slice: row gate * U + u is w_hhᵀ row gate * H + j0 + u,
  // zero past the last unit and past k = H
  for (long long idx = threadIdx.x; idx < static_cast<long long>(p.rows) * p.pitch;
       idx += THREADS) {
    const int r = static_cast<int>(idx / p.pitch);
    const int k = static_cast<int>(idx - static_cast<long long>(r) * p.pitch);
    const int gate = r / U;
    const int j = j0 + r - gate * U;
    ws[idx] = (j < H && k < H) ? wt[(static_cast<long long>(gate) * H + j) * H + k]
                               : from_f32<T>(0.f);
  }
  // (gemm_chunk's first __syncthreads publishes the slice)

  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? a.steps - 1 - s : s;
    const T* hprev = s == 0 ? static_cast<const T*>(a.h0)
                            : hseq + static_cast<long long>(a.reverse ? t + 1 : t - 1) * B * H;
    for (int n0 = 0; n0 < B; n0 += p.nb) {
      gemm_chunk<T>(p, ws, hprev, H, B, n0, a.vec != 0, stage, out);
      for (int idx = threadIdx.x; idx < U * p.nb; idx += THREADS) {
        const int n = idx / U;
        const int u = idx - n * U;
        const int b = n0 + n;
        const int j = j0 + u;
        if (b >= B || j >= H) continue;
        const long long row = static_cast<long long>(t) * B + b;
        const T* x = xp + row * 4 * H + j;
        const float li = to_f32(x[0]) + gathered(p, out, u, n);
        const float lf = to_f32(x[H]) + gathered(p, out, U + u, n);
        const float lg = to_f32(x[2 * H]) + gathered(p, out, 2 * U + u, n);
        const float lo = to_f32(x[3 * H]) + gathered(p, out, 3 * U + u, n);
        const float i = sigmoid(li);
        const float f = sigmoid(lf);
        const float g = tanhf(lg);
        const float o = sigmoid(lo);
        float* cc = a.c + static_cast<long long>(b) * H + j;
        const float c = f * *cc + i * g;
        *cc = c;
        hseq[row * H + j] = from_f32<T>(o * tanhf(c));
        cseq[row * H + j] = from_f32<T>(c);
        T* gt = gates + row * 4 * H + j;
        gt[0] = from_f32<T>(i);
        gt[H] = from_f32<T>(f);
        gt[2 * H] = from_f32<T>(g);
        gt[3 * H] = from_f32<T>(o);
      }
    }
    if (s + 1 < a.steps) grid_sync(a.bar, gridDim.x);
  }
}

// -- the bf16 ring path ------------------------------------------------------

namespace ring {

using bf16 = __nv_bfloat16;
constexpr int THREADS = lstm::THREADS;
constexpr int WARPS = lstm::WARPS;
constexpr int STAGES = 3;     // slabs in the ring: one multiplied, two in flight
constexpr int SPAD = 8;       // slab and slice row padding (elements): ldmatrix without conflicts
constexpr int MAX_KC = 256;   // k per round

// Computed on the host from the shapes (make_plan below).
struct Plan {
  int units;        // U
  int mt;           // m16 tiles: 4 (a gate a tile, U 9..16) or 2 (two gates a tile, U <= 8)
  int rows;         // slice rows in shared memory: 4U (gate * U + unit)
  int hp;           // H rounded up to 16: the K of the products
  int pitch;        // slice row pitch (elements): hp + SPAD
  int nb;           // batch columns a chunk: wn * ntw * 8
  int kc;           // k a round (a multiple of 16)
  int spitch;       // slab row pitch (elements): kc + SPAD
  int kr;           // rounds a chunk: ceil(hp / kc)
  int chunks;       // batch chunks a step
  int ntw;          // n8 column tiles a warp owns in a chunk
  int wn;           // warps along the columns
  int splits;       // warps along K (1 unless B < 64)
  int ring_offset;  // bytes: the slice, then the ring, then the split partials
  int part_offset;
  int smem_bytes;
};

// The most n8 tiles a warp can hold accumulators for: 48 f32 registers.
__host__ __device__ constexpr int max_ntw(int mt) { return mt == 4 ? 3 : 6; }

// False when no ring fits beside the slice (the caller refuses the launch).
inline bool make_plan(int units, int hidden, int batch, int smem_limit, Plan& p) {
  p.units = units;
  p.mt = units > 8 ? 4 : 2;
  p.rows = 4 * units;
  p.hp = (hidden + 15) / 16 * 16;
  p.pitch = p.hp + SPAD;
  p.ring_offset = lstm::align16(p.rows * p.pitch * 2);
  const int nt = (batch + 7) / 8;
  // candidates: (ntw, wn, splits); wide batches prefer the ntw that pads the
  // fewest tiles a step, then the larger one (fewer reads of the slice)
  int best_kc = 0;
  for (int w = max_ntw(p.mt); w >= 1; --w) {
    const int wn = nt >= WARPS ? WARPS : nt;
    const int splits = nt >= WARPS ? 1 : WARPS / nt;
    if (splits > 1 && w > 1) continue;
    const int nb = wn * w * 8;
    const int chunks = (nt * 8 + nb - 1) / nb;
    const int part = (splits - 1) * p.mt * 16 * nb * 4;
    const int room = smem_limit - p.ring_offset - part;
    if (room <= 0) continue;
    // kc: a power of two (a thread's copies then share one k), as large as
    // the ring allows, up to MAX_KC and no more than one round past hp
    const int fit = room / STAGES / (nb * 2) - SPAD;
    if (fit < 16) continue;
    int kc = 16;
    while (2 * kc <= fit && 2 * kc <= MAX_KC && kc < p.hp) kc *= 2;
    if (best_kc > 0) {
      const int cost = chunks * w, best_cost = p.chunks * p.ntw;
      if (cost >= best_cost) continue;
    }
    p.ntw = w;
    p.wn = wn;
    p.splits = splits;
    p.nb = nb;
    p.chunks = chunks;
    p.kc = kc;
    best_kc = kc;
  }
  if (best_kc == 0) return false;
  p.spitch = p.kc + SPAD;
  p.kr = (p.hp + p.kc - 1) / p.kc;
  p.part_offset = p.ring_offset + STAGES * p.nb * p.spitch * 2;
  p.smem_bytes = p.part_offset + (p.splits - 1) * p.mt * 16 * p.nb * 4;
  return true;
}

using mmautil::cp_async16;
using mmautil::cp_async_commit;
using mmautil::cp_async_wait;

// One k16 step's fragments of a warp: A for its MT row tiles, B for its
// NTW column tiles.
template <int MT, int NTW> struct Frags {
  uint32_t a[MT][4];
  uint32_t b[NTW][2];

  __device__ __forceinline__ void load(const bf16* ws, const int* a_off, const bf16* slab,
                                       const int* b_off, int k_slice, int k_slab, int nv) {
#pragma unroll
    for (int m = 0; m < MT; ++m) mmautil::ldsm_x4(a[m], ws + a_off[m] + k_slice);
#pragma unroll
    for (int jp = 0; jp < (NTW + 1) / 2; ++jp) {
      const bf16* src = slab + b_off[jp] + k_slab;
      if (2 * jp + 1 < NTW && 2 * jp + 1 < nv) {
        uint32_t r[4];
        mmautil::ldsm_x4(r, src);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      } else if (2 * jp < nv) {
        mmautil::ldsm_x2(b[2 * jp], src);
      }
    }
  }

  __device__ __forceinline__ void mma(float (*acc)[MT][4], int nv) const {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      if (j < nv)
#pragma unroll
        for (int m = 0; m < MT; ++m) lstm::mma_bf16(acc[j][m], a[m], b[j]);
  }
};

// A round of a step: its batch chunk, its index in the chunk, its k slab
// (the index shifted by the block's starting slab, mod kr) and its ring slot.
struct Round {
  int chunk, kk, ks, slot;

  __device__ __forceinline__ void advance(int kr) {
    if (++ks == kr) ks = 0;
    if (++kk == kr) {
      kk = 0;
      ++chunk;
    }
    if (++slot == STAGES) slot = 0;
  }
};

// Gate `gate` of unit slot us (unit g + 8 us) at column 2q + e of tile j,
// as the accumulators hold it: MT 4, m-tile = gate and row g + 8 us; MT 2,
// m-tile gate / 2 and row g + 8 (gate % 2).
template <int MT, int NTW>
__device__ __forceinline__ float gate_sum(float (&acc)[NTW][MT][4], int j, int gate, int us,
                                          int e) {
  if constexpr (MT == 4) return acc[j][gate][2 * us + e];
  else return acc[j][gate >> 1][2 * (gate & 1) + e];
}

template <int MT, int NTW>
__global__ void __launch_bounds__(THREADS, 1) lstm_fwd_ring(const FwdArgs a, const Plan p) {
  constexpr int UPT = MT == 4 ? 2 : 1;  // units a thread holds: g and g + 8, or g
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* slabs = reinterpret_cast<bf16*>(smem + p.ring_offset);
  float* part = reinterpret_cast<float*>(smem + p.part_offset);
  const bf16* xp = static_cast<const bf16*>(a.xp);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  bf16* hseq = static_cast<bf16*>(a.hseq);
  bf16* cseq = static_cast<bf16*>(a.cseq);
  bf16* gates = static_cast<bf16*>(a.gates);
  const int H = a.hidden, B = a.batch, U = p.units;
  const int j0 = blockIdx.x * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int split = warp / p.wn, wn = warp - split * p.wn;
  const bool active = split < p.splits;     // a warp with products (the rest only copy)
  const bool owner = active && split == 0;  // a warp that runs the epilogue
  const int slab_elems = p.nb * p.spitch;
  const int nt = (B + 7) / 8;

  // the slice, 16 bytes a load: row gate * U + u is w_hhᵀ row gate * H + j0
  // + u, zero past the last unit and past k = H
  {
    const int vrow = p.pitch / 8;
    for (int idx = threadIdx.x; idx < p.rows * vrow; idx += THREADS) {
      const int r = idx / vrow;
      const int k = (idx - r * vrow) * 8;
      const int gate = r / U;
      const int j = j0 + r - gate * U;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < H && k < H)
        v = *reinterpret_cast<const uint4*>(wt + (static_cast<long long>(gate) * H + j) * H + k);
      *reinterpret_cast<uint4*>(ws + r * p.pitch + k) = v;
    }
    __syncthreads();  // the slice is every warp's
  }

  // ldmatrix row addresses of this lane. A: matrix lane / 8 of a tile is
  // (rows 0-7 | 8-15) x (k 0-7 | 8-15); a row past the block's units reads
  // any valid row, and its sums are never used.
  int a_off[MT];
  {
    const int mi = lane >> 3;
    const int rr = (lane & 7) + (mi & 1) * 8;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int gate = MT == 4 ? m : 2 * m + (rr >> 3);
      int unit = MT == 4 ? rr : (rr & 7);
      if (unit >= U) unit = U - 1;
      a_off[m] = (gate * U + unit) * p.pitch + (mi >> 1) * 8;
    }
  }
  // B: matrix lane / 8 is (tile 2jp | 2jp + 1) x (k 0-7 | 8-15) of the slab
  int b_off[(NTW + 1) / 2];
#pragma unroll
  for (int jp = 0; jp < (NTW + 1) / 2; ++jp) {
    const int mi = lane >> 3;
    const int tile = wn * p.ntw + 2 * jp + (mi >> 1);
    b_off[jp] = (tile * 8 + (lane & 7)) * p.spitch + (mi & 1) * 8;
  }

  float acc[NTW][MT][4];
  bf16 xv[NTW][UPT][2][4];  // x_proj of the thread's outputs: [tile][unit][column][gate]
  float cv[NTW][UPT][2];    // their f32 carries

  // column tiles of chunk c that this warp owns and that hold batch rows
  const auto valid_tiles = [&](int c) {
    const int v = nt - (c * p.nb / 8 + wn * p.ntw);
    return v < 0 ? 0 : (v < p.ntw ? v : p.ntw);
  };
  const auto column = [&](int c, int j, int e) {
    return c * p.nb + (wn * p.ntw + j) * 8 + 2 * q + e;
  };
  // x_proj and c of step t, chunk c, into registers (consumed by epilogue)
  const auto prefetch = [&](int t, int c) {
    if (!owner) return;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = column(c, j, e);
        if (j >= p.ntw || b >= B) continue;
        const long long row = static_cast<long long>(t) * B + b;
#pragma unroll
        for (int us = 0; us < UPT; ++us) {
          const int u = g + 8 * us;
          if (u >= U || j0 + u >= H) continue;
          const bf16* x = xp + row * 4 * H + j0 + u;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) xv[j][us][e][gate] = x[gate * H];
          cv[j][us][e] = a.c[static_cast<long long>(b) * H + j0 + u];
        }
      }
  };
  // The ring's copies. A warp copies only the slab rows and k16 steps it
  // multiplies, so a warp barrier, not a block barrier, publishes a slab
  // and the warps do not wait on each other between rounds. Without a K
  // split, kc / 8 vectors a row divide the 32 lanes, and a lane copies
  // vector ckv of rows cn, cn + dn, ... of the warp's column tiles; with
  // one, a lane copies row lane % 8 of the warp's tile, half (lane / 8) % 2
  // of the warp's k16 steps lane / 16, lane / 16 + 2, ...
  const int vrow = p.kc / 8;
  const int cn = lane / vrow, ckv = lane % vrow;
  const int dn = 32 / vrow;
  // the next round to copy: its chunk, index in the chunk, k slab and ring
  // slot; the blocks walk a chunk's k slabs from their own starting point
  // (blockIdx.x % kr), so they do not all ask L2 for the same lines at once
  const int first = blockIdx.x % p.kr;
  Round next{0, 0, first, 0};
  const auto issue = [&](const bf16* hprev) {
    if (active && next.chunk < p.chunks) {
      const int n0 = next.chunk * p.nb;
      const int k0 = next.ks * p.kc;
      bf16* slab = slabs + next.slot * slab_elems;
      if (p.splits == 1) {
        const int base = wn * p.ntw * 8;  // the warp's first slab row
        const int nrows = valid_tiles(next.chunk) * 8;
        const int k = k0 + ckv * 8;
        const int rows = k < H ? B - n0 - base : 0;  // rows to copy, the rest zero-filled
        bf16* dst = slab + (base + cn) * p.spitch + ckv * 8;
        const bf16* src = hprev + static_cast<long long>(n0 + base + cn) * H + k;
        for (int n = cn; n < nrows; n += dn) {
          cp_async16(dst, n < rows ? src : hprev, n < rows);
          dst += dn * p.spitch;
          src += static_cast<long long>(dn) * H;
        }
      } else {
        const int row = wn * 8 + (lane & 7);
        const int kh = ((lane >> 3) & 1) * 8;
        const bool in_batch = n0 + row < B;
        bf16* dst = slab + row * p.spitch + kh;
        const bf16* src = hprev + static_cast<long long>(n0 + row) * H + k0 + kh;
        for (int k16 = split + (lane >> 4) * p.splits; k16 < p.kc / 16; k16 += 2 * p.splits) {
          const bool ok = in_batch && k0 + k16 * 16 + kh < H;
          cp_async16(dst + k16 * 16, ok ? src + k16 * 16 : hprev, ok);
        }
      }
    }
    cp_async_commit();  // an empty group past the last round keeps the count
    next.advance(p.kr);
  };

  prefetch(a.reverse ? a.steps - 1 : 0, 0);
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? a.steps - 1 - s : s;
    const bf16* hprev = s == 0 ? static_cast<const bf16*>(a.h0)
                               : hseq + static_cast<long long>(a.reverse ? t + 1 : t - 1) * B * H;
    next = Round{0, 0, first, 0};
    for (int i = 0; i < STAGES - 1; ++i) issue(hprev);
    for (Round cur{0, 0, first, 0}; cur.chunk < p.chunks; cur.advance(p.kr)) {
      cp_async_wait<STAGES - 2>();  // this lane's copies of round cur have landed
      __syncwarp();                 // the warp's have, and it is done with the slot it refills
      issue(hprev);
      const int c = cur.chunk;
      const int kk = cur.kk;
      if (kk == 0) {
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.f;
        if (c > 0) prefetch(t, c);
      }
      const int nv = valid_tiles(c);
      if (active && nv > 0) {
        const bf16* slab = slabs + cur.slot * slab_elems;
        const int k0 = cur.ks * p.kc;
        const int n16 = (p.hp - k0 < p.kc ? p.hp - k0 : p.kc) / 16;
        // this warp's k16 steps split, split + splits, ...: the next one's
        // fragments are loaded before the current one's products
        Frags<MT, NTW> f0, f1;
        int k16 = split;
        if (k16 < n16) f0.load(ws, a_off, slab, b_off, k0 + 16 * k16, 16 * k16, nv);
        while (k16 < n16) {
          const int k1 = k16 + p.splits;
          if (k1 < n16) f1.load(ws, a_off, slab, b_off, k0 + 16 * k1, 16 * k1, nv);
          f0.mma(acc, nv);
          if (k1 >= n16) break;
          const int k2 = k1 + p.splits;
          if (k2 < n16) f0.load(ws, a_off, slab, b_off, k0 + 16 * k2, 16 * k2, nv);
          f1.mma(acc, nv);
          k16 = k2;
        }
      }
      if (kk != p.kr - 1) continue;

      // the chunk's products are complete: split partials meet in shared
      // memory (B < 64 only), then the gate math from registers
      if (p.splits > 1) {
        if (active && split > 0 && nv > 0) {
          float* pp = part + (static_cast<long long>(split - 1) * MT * 16) * p.nb;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pp[(m * 16 + g + 8 * (e >> 1)) * p.nb + wn * 8 + 2 * q + (e & 1)] = acc[0][m][e];
        }
        __syncthreads();
        if (owner && nv > 0)
          for (int sp = 1; sp < p.splits; ++sp) {
            const float* pp = part + (static_cast<long long>(sp - 1) * MT * 16) * p.nb;
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[0][m][e] += pp[(m * 16 + g + 8 * (e >> 1)) * p.nb + wn * 8 + 2 * q + (e & 1)];
          }
      }
      if (!owner) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = column(c, j, e);
          if (j >= nv || b >= B) continue;
          const long long row = static_cast<long long>(t) * B + b;
#pragma unroll
          for (int us = 0; us < UPT; ++us) {
            const int u = g + 8 * us;
            const int jj = j0 + u;
            if (u >= U || jj >= H) continue;
            const float i = lstm::sigmoid(__bfloat162float(xv[j][us][e][0]) +
                                          gate_sum<MT, NTW>(acc, j, 0, us, e));
            const float f = lstm::sigmoid(__bfloat162float(xv[j][us][e][1]) +
                                          gate_sum<MT, NTW>(acc, j, 1, us, e));
            const float gg = tanhf(__bfloat162float(xv[j][us][e][2]) +
                                   gate_sum<MT, NTW>(acc, j, 2, us, e));
            const float o = lstm::sigmoid(__bfloat162float(xv[j][us][e][3]) +
                                          gate_sum<MT, NTW>(acc, j, 3, us, e));
            const float cn = f * cv[j][us][e] + i * gg;
            a.c[static_cast<long long>(b) * H + jj] = cn;
            hseq[row * H + jj] = __float2bfloat16(o * tanhf(cn));
            cseq[row * H + jj] = __float2bfloat16(cn);
            bf16* gt = gates + row * 4 * H + jj;
            gt[0] = __float2bfloat16(i);
            gt[H] = __float2bfloat16(f);
            gt[2 * H] = __float2bfloat16(gg);
            gt[3 * H] = __float2bfloat16(o);
          }
        }
    }
    if (s + 1 < a.steps) {
      prefetch(a.reverse ? t - 1 : t + 1, 0);  // independent of the other blocks
      lstm::grid_sync(a.bar, gridDim.x);
    }
  }
}

template <int MT, int NTW>
int launch(const FwdArgs& a, const Plan& p, int blocks, cudaStream_t stream) {
  return lstm::launch(lstm_fwd_ring<MT, NTW>, a, p, blocks, stream);
}

}  // namespace ring

// -- the split-f32 path ------------------------------------------------------

namespace f32 {

using lstm::THREADS;
using lstm::tc::Plan;

// The plan of the f32 design for U units a block: N = 4U columns (gate of
// unit u at column 4u + gate), K = H; false where it does not fit.
inline bool make_plan(int units, int hidden, int batch, int smem_limit, Plan& p) {
  return lstm::tc::make_plan(units, (units + 1) / 2, 8, hidden, batch, smem_limit, p);
}

template <int PPT, int NT>
__global__ void __launch_bounds__(THREADS, 1) lstm_fwd_f32(const FwdArgs a, const Plan p) {
  constexpr int MW = lstm::tc::max_mw(NT);
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  const float* xp = static_cast<const float*>(a.xp);
  const float* wt = static_cast<const float*>(a.wt);
  float* hseq = static_cast<float*>(a.hseq);
  float* cseq = static_cast<float*>(a.cseq);
  float* gates = static_cast<float*>(a.gates);
  const int H = a.hidden, B = a.batch, U = p.units, G4 = 4 * H;
  const int j0 = blockIdx.x * U;

  // the block's slice, split once: column 4u + gate is w_hhᵀ row gate * H +
  // j0 + u, 16 bytes (four k) a load; zero past the last unit and past H
  {
    const int kv = p.kr * lstm::tc::KC / 4;
    for (int idx = threadIdx.x; idx < NT * 8 * kv; idx += THREADS) {
      const int col = idx / kv;
      const int k = (idx - col * kv) * 4;
      const int u = col >> 2, gate = col & 3;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (u < U && j0 + u < H && k < H)
        v = *reinterpret_cast<const float4*>(wt + (static_cast<long long>(gate) * H + j0 + u) * H +
                                             k);
      lstm::tc::put_split(ws, p, k, col >> 3, col & 7, v.x);
      lstm::tc::put_split(ws, p, k + 1, col >> 3, col & 7, v.y);
      lstm::tc::put_split(ws, p, k + 2, col >> 3, col & 7, v.z);
      lstm::tc::put_split(ws, p, k + 3, col >> 3, col & 7, v.w);
    }
    __syncthreads();
  }

  // the (b, u) pairs this thread owns: pair tid + 256 i is (b, u) =
  // divmod(tid + 256 i, U), kept while b < B and j0 + u < H; their c in
  // registers across the steps, their x_proj prefetched a step ahead
  int pb[PPT], pu[PPT];
  float cc[PPT], xv[PPT][4];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pair = threadIdx.x + THREADS * i;
    pb[i] = pair / U;
    pu[i] = pair - pb[i] * U;
    if (pb[i] >= B || j0 + pu[i] >= H) pb[i] = -1;
    cc[i] = pb[i] >= 0 ? a.c[static_cast<long long>(pb[i]) * H + j0 + pu[i]] : 0.f;
  }
  const auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (pb[i] < 0) continue;
      const float* x = xp + (static_cast<long long>(t) * B + pb[i]) * G4 + j0 + pu[i];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) xv[i][gate] = x[gate * H];
    }
  };

  prefetch(a.reverse ? a.steps - 1 : 0);
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? a.steps - 1 - s : s;
    const float* hprev = s == 0 ? static_cast<const float*>(a.h0)
                                : hseq + static_cast<long long>(a.reverse ? t + 1 : t - 1) * B * H;
    for (int c = 0; c < p.chunks; ++c) {
      lstm::tc::warp_chunk<NT, MW>(p, ws, smem, hprev, H, B, c);
      __syncthreads();  // every warp's partials are in its ring
      // the owners: the K splits' sums of their four gates in a fixed order,
      // then the gate math
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int bl = pb[i] - c * p.nb;
        if (pb[i] < 0 || bl < 0 || bl >= p.nb) continue;
        float4 lin = make_float4(xv[i][0], xv[i][1], xv[i][2], xv[i][3]);
        for (int sp = 0; sp < p.wk; ++sp) {
          const float4 v =
              *reinterpret_cast<const float4*>(lstm::tc::partial_row(smem, p, sp, bl) + 4 * pu[i]);
          lin.x += v.x;
          lin.y += v.y;
          lin.z += v.z;
          lin.w += v.w;
        }
        const float ig = lstm::sigmoid(lin.x);
        const float fg = lstm::sigmoid(lin.y);
        const float gg = tanhf(lin.z);
        const float og = lstm::sigmoid(lin.w);
        const float cn = fg * cc[i] + ig * gg;
        cc[i] = cn;
        const long long row = static_cast<long long>(t) * B + pb[i];
        const int j = j0 + pu[i];
        hseq[row * H + j] = og * tanhf(cn);
        cseq[row * H + j] = cn;
        float* gt = gates + row * G4 + j;
        gt[0] = ig;
        gt[H] = fg;
        gt[2 * H] = gg;
        gt[3 * H] = og;
      }
      if (c + 1 < p.chunks) __syncthreads();  // the next chunk's copies overwrite the partials
    }
    if (s + 1 < a.steps) {
      lstm::grid_sync(a.bar, gridDim.x);  // h_seq[t] of every unit is written
      prefetch(a.reverse ? t - 1 : t + 1);  // lands under the products
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i)
    if (pb[i] >= 0) a.c[static_cast<long long>(pb[i]) * H + j0 + pu[i]] = cc[i];
}

template <int PPT>
int launch_nt(const FwdArgs& a, const Plan& p, int blocks, cudaStream_t stream) {
  switch (p.nt) {
    case 1: return lstm::launch(lstm_fwd_f32<PPT, 1>, a, p, blocks, stream);
    case 2: return lstm::launch(lstm_fwd_f32<PPT, 2>, a, p, blocks, stream);
    case 3: return lstm::launch(lstm_fwd_f32<PPT, 3>, a, p, blocks, stream);
    default: return lstm::launch(lstm_fwd_f32<PPT, 4>, a, p, blocks, stream);
  }
}

inline int launch(const FwdArgs& a, const Plan& p, int blocks, cudaStream_t stream) {
  return p.ppt == 1   ? launch_nt<1>(a, p, blocks, stream)
         : p.ppt == 4 ? launch_nt<4>(a, p, blocks, stream)
                      : launch_nt<16>(a, p, blocks, stream);
}

}  // namespace f32

// -- the wide path -----------------------------------------------------------

// The widths no other design holds (lstm.cuh, namespace wide): the first
// res_rounds rounds of the slice resident, the rest streamed through the
// stage slots with h_prev each step. The gate math runs from split 0's
// accumulators: tile m is gate m, so a thread holds all four gates of units
// g and g + 8 at its columns.
template <typename T, int NTW>
__global__ void __launch_bounds__(lstm::THREADS, 1)
    lstm_fwd_wide(const FwdArgs a, const lstm::wide::Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* xp = static_cast<const T*>(a.xp);
  const T* wt = static_cast<const T*>(a.wt);
  T* hseq = static_cast<T*>(a.hseq);
  T* cseq = static_cast<T*>(a.cseq);
  T* gates = static_cast<T*>(a.gates);
  const int H = a.hidden, B = a.batch, U = p.units;
  const int j0 = blockIdx.x * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const bool owner = warp < p.wn;  // split 0: the pointwise part
  lstm::wide::load_resident(p, reinterpret_cast<T*>(smem), wt, j0, H, a.vec != 0);

  float acc[NTW][4][4];
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? a.steps - 1 - s : s;
    const T* hprev = s == 0 ? static_cast<const T*>(a.h0)
                            : hseq + static_cast<long long>(a.reverse ? t + 1 : t - 1) * B * H;
    for (int n0 = 0; n0 < B; n0 += p.nb) {
      lstm::wide::wide_chunk<T, 4, NTW>(p, smem, wt, j0, H, hprev, H, B, n0, a.vec != 0, acc);
      if (!owner) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = n0 + (warp * NTW + j) * 8 + 2 * q + (e & 1);
          const int u = g + 8 * (e >> 1);
          const int jj = j0 + u;
          if (b >= B || u >= U || jj >= H) continue;
          const long long row = static_cast<long long>(t) * B + b;
          const T* x = xp + row * 4 * H + jj;
          const float i = lstm::sigmoid(lstm::to_f32(x[0]) + acc[j][0][e]);
          const float f = lstm::sigmoid(lstm::to_f32(x[H]) + acc[j][1][e]);
          const float gg = tanhf(lstm::to_f32(x[2 * H]) + acc[j][2][e]);
          const float o = lstm::sigmoid(lstm::to_f32(x[3 * H]) + acc[j][3][e]);
          float* cc = a.c + static_cast<long long>(b) * H + jj;
          const float c = f * *cc + i * gg;
          *cc = c;
          hseq[row * H + jj] = lstm::from_f32<T>(o * tanhf(c));
          cseq[row * H + jj] = lstm::from_f32<T>(c);
          T* gt = gates + row * 4 * H + jj;
          gt[0] = lstm::from_f32<T>(i);
          gt[H] = lstm::from_f32<T>(f);
          gt[2 * H] = lstm::from_f32<T>(gg);
          gt[3 * H] = lstm::from_f32<T>(o);
        }
    }
    if (s + 1 < a.steps) lstm::grid_sync(a.bar, gridDim.x);
  }
}

template <typename T>
int launch_wide(const FwdArgs& a, const lstm::wide::Plan& p, int blocks, cudaStream_t stream) {
  switch (p.ntw) {
    case 1: return lstm::launch(lstm_fwd_wide<T, 1>, a, p, blocks, stream);
    case 2: return lstm::launch(lstm_fwd_wide<T, 2>, a, p, blocks, stream);
    default: return lstm::launch(lstm_fwd_wide<T, 3>, a, p, blocks, stream);
  }
}

// Which design run() takes for these shapes and addresses (3: the wide
// design, 2: the split-f32 design, 1: the bf16 ring, 0: the first design;
// -1: refused) and its plan. The wide design takes exactly the shapes that
// the others refuse (no ring beside a bf16 slice) or whose first-design plan
// exceeds optin.
template <typename T>
int choose(const FwdArgs& a, int sms, int optin, ring::Plan& rp, f32::Plan& fp,
           lstm::wide::Plan& wp) {
  const int units = sms > 0 ? lstm::units_per_block(a.hidden, sms) : 0;
  if (units == 0) return -1;
  constexpr int V = 16 / sizeof(T);
  // 16-byte rows of h_prev and of the slice
  const bool rows16 = a.hidden % V == 0 && reinterpret_cast<uintptr_t>(a.h0) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.hseq) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.wt) % 16 == 0;
  int code = 0;
  if (sizeof(T) == 2) {
    if (rows16) code = ring::make_plan(units, a.hidden, a.batch, optin, rp) ? 1 : -1;
  } else if (rows16 && f32::make_plan(units, a.hidden, a.batch, optin, fp)) {
    code = 2;
  }
  if (code > 0) return code;
  if (code == 0 &&
      lstm::make_plan(sizeof(T), units, 4 * units, a.hidden, a.batch).smem_bytes <= optin)
    return 0;
  return lstm::wide::make_plan(sizeof(T), units, 4, a.hidden, a.batch, optin, wp) ? 3 : -1;
}

template <typename T>
int run(FwdArgs a, cudaStream_t stream) {
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
  if (design == 1)
    return rp.mt == 4 ? ring::launch<4, ring::max_ntw(4)>(a, rp, blocks, stream)
                      : ring::launch<2, ring::max_ntw(2)>(a, rp, blocks, stream);
  if (design == 2) return f32::launch(a, fp, blocks, stream);
  constexpr int V = 16 / sizeof(T);
  a.vec = a.hidden % V == 0 && reinterpret_cast<uintptr_t>(a.h0) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.hseq) % 16 == 0;
  if (design == 3) {
    a.vec = a.vec && reinterpret_cast<uintptr_t>(a.wt) % 16 == 0;
    return launch_wide<T>(a, wp, blocks, stream);
  }
  const lstm::Plan p = lstm::make_plan(sizeof(T), units, 4 * units, a.hidden, a.batch);
  return lstm::launch(lstm_fwd_kernel<T>, a, p, blocks, stream);
}

}  // namespace

// The forward over all steps; returns cudaGetLastError() (or
// cudaErrorCooperativeLaunchTooLarge where H needs more than 16 units a
// block).
extern "C" int lstm_fwd(int is_bf16, const void* xp, const void* wt, const void* h0, float* c,
                        void* hseq, void* cseq, void* gates, unsigned int* bar, int steps,
                        int batch, int hidden, int reverse, cudaStream_t stream) {
  if (steps <= 0 || batch <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{xp, wt, h0, c, hseq, cseq, gates, bar, steps, batch, hidden, reverse, 0};
  return is_bf16 ? run<__nv_bfloat16>(a, stream) : run<float>(a, stream);
}

// The design lstm_fwd takes on this card for these shapes, for the tests
// (`aligned`: h0, h_seq and w_hhᵀ at 16-byte addresses, else at the
// element's size): out[0] = 3 (the wide design), 2 (the split-f32 design),
// 1 (the bf16 ring), 0 (the first design) or -1 (refused); then the plan's
// fields of the split-f32 design (units, nt, cols, k, kr, stages, wm, wk,
// mw, nb, chunks, rpw, pitch, slab_bytes, region, ring_offset, ppt,
// smem_bytes) or of the wide design (units, mt, rows, k, kstep, wn, wk,
// ntw, nb, chunks, kc, kr, res_rounds, pitch, spitch, stage_offset,
// slot_bytes, part_offset, smem_bytes), else zeros. Returns a cudaError_t.
extern "C" int lstm_fwd_plan(int is_bf16, int hidden, int batch, int aligned, int* out) {
  int optin = 0;
  if (const int err = lstm::optin_smem(optin)) return err;
  // only the alignment of these pointers is read
  const uintptr_t addr = aligned ? 256 : (is_bf16 ? 2 : 4);
  FwdArgs a{};
  a.wt = a.h0 = reinterpret_cast<const void*>(addr);
  a.hseq = reinterpret_cast<void*>(addr);
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
  const int w[] = {wp.units, wp.mt, wp.rows, wp.k, wp.kstep, wp.wn, wp.wk, wp.ntw, wp.nb,
                   wp.chunks, wp.kc, wp.kr, wp.res_rounds, wp.pitch, wp.spitch, wp.stage_offset,
                   wp.slot_bytes, wp.part_offset, wp.smem_bytes};
  for (int i = 0; i < 19; ++i) out[1 + i] = out[0] == 2 && i < 18 ? f[i] : out[0] == 3 ? w[i] : 0;
  return static_cast<int>(cudaSuccess);
}
