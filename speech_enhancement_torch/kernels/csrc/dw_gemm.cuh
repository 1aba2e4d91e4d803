// Weight gradient of a DCCRN block as a split-K GEMM on Hopper (sm_90a).
//
// Shared by conv_block_bwd.cu (encoder block) and deconv_block_bwd.cu
// (decoder block); each source instantiates only its own indexing. For the
// activated input z [B, f_in * C2in, T] (recomputed and rounded to the
// activation type by the caller) and the output gradient g [B, f_out *
// C2out, T]:
//
//   dW[jf, jt, ci, co] = sum over (b, fo, t) of
//                        Z[b, fi(fo, jf), ci, t + shift(jt)] * G[b, fo, co, t]
//
//   encoder: fi = 2 fo + jf - 2, shift = jt - 1 (the causal pad);
//   decoder: fi = (fo + jf - 2) / 2 for fo + jf even, shift = jt;
//   Z = 0 outside [0, f_in) x [0, T).
//
// Every block writes its own f32 partial tile into part[s, jf, jt] [S, 5,
// 2, C2tot, C2out] for its split s of the K steps; the caller sums the S
// partials (torch.sum), so no atomics and the order of every sum is fixed.
//
// bf16: the frequency taps in the GEMM's rows (dw_mma_kernel)
// -----------------------------------------------------------
// The input rows an output row reads are contiguous in z's row space, so
// all its frequency taps are one product. A "window" is that run of input
// rows: the encoder's output row m reads rows 2m - 2 ... 2m + 2 (taps jf =
// w = 0..4); the decoder's even output row 2m reads rows m - 1 ... m + 1
// (jf = 0, 2, 4) and its odd row 2m + 1 rows m, m + 1 (jf = 1, 3). One GEMM
// per problem: the encoder has one, the decoder four (trunk and skip, even
// and odd rows), each with
//   M = window rows x C2 (w, ci: contiguous rows of z, 5 C2in, 3 C2 or 2 C2),
//   N = 2 x C2out (jt, co: the time tap moved onto g, the smaller operand:
//       dW[jt] = sum over u of z[u] g[u + 1 - jt] (encoder), z[u] g[u - jt]
//       (decoder)),
//   K = (b, frame chunk, m) with m fastest, BK = 64 frames a step.
// The grid is (the problems' BM x BN tiles, splits); split s walks the steps
// [s * steps / S, (s + 1) * steps / S) of its problem's list. Rows of a
// window outside [0, f_in) stage as zeros, and a step whose tile has none
// inside is skipped. The decoder's chunks start 64 - T % 64 frames early,
// so that its one partial chunk is also the one that holds frame -1.
//
// What the design does about the per-tap kernel's costs (tools/
// dw_phase_probe.py --design before: staging took 84 to 87% of a block's
// time, the products 5 to 9%):
// - Scalar, exposed staging. Rows move as aligned 16-byte loads. T = 643 is
//   odd, so a row's first frame sits at any of the eight 2-byte offsets of
//   a 16-byte word: eight lanes stage a row's 64 frames, lane c loading the
//   aligned chunks c and c + 1 of the row's span and shifting the pair by
//   the row's residue (word selects, then a 16-bit funnel shift) into one
//   aligned shared store. g is loaded once for 65 frames and stored twice,
//   shifted by the residue and by one more element: the two time taps.
//   Frames outside [0, T) are masked to zero; no wrapper-side copy pads
//   anything. Two shared stages, one block barrier a step: a step issues
//   the next live step's loads (predicated, no branch), runs its products
//   on the current stage and realigns and stores the loaded rows into the
//   other one between its k16 steps (the edge chunks in series, masked).
// - Zeros in padded tiles. The taps are in the rows: enc0 (C2in 2) stages
//   10 live rows of a 16-row tile where the per-tap kernel staged 2, dec5
//   (C2out 2) a 32 x 8 tile of (jt, co) where it staged 2 of 16 columns.
// - Re-reads. Each staged row of z serves every tap that reads it, and the
//   grid has no tap dimension: z is staged once per N tile and window
//   covering it (2.5 windows a row in the encoder, 5 in the decoder), g
//   once per M tile, 1.9 (enc0) to 17.1 (dec0) times the inputs' bytes in
//   all, half the per-tap kernel's factor or less. Consecutive steps walk m,
//   so the rows two windows share come from L1, and the blocks of one split
//   read the same rows at about the same time, from L2.
//
// Products: mma.sync m16n8k16 (bf16 in, f32 accumulate) on warp tiles of
// WM x WN; fragments by ldmatrix (.x4 for A and for two n8 tiles of B, .x2
// for one) from rows padded to 72 elements (144 bytes: eight rows hit
// eight distinct bank quads), the next k16 step's fragments loaded before
// the current products. k16 steps outside [0, T) are skipped (T = 643
// leaves 3 frames in a partial chunk of 64). On small tiles the block's
// warps also split each step's k16 steps (WARPS_K > 1) and sum through
// shared memory at the end.
//
// What bounds it (the probe, H100): on the 128 x 128 tiles the staging
// instructions and mma.sync take about half the time each and do not
// overlap (dec0: 5.4 ms, 2.6 ms with the mma.sync taken out, 4.7 with the
// loads taken out; mma.sync runs at about 12 cycles an m16n8k16 on each of
// an SM's four schedulers); the small tiles by the staging's per-step
// instructions and load latency, 3 to 9x their byte bounds.
//
// f32 (dw_f32_kernel): the per-tap GEMM with scalar staging and plain FMA
// (no TF32), 32 x 32 channels a block, grid (tiles, jf, split); only the
// small f32 model takes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_util.cuh"

namespace dwgemm {

using namespace mmautil;  // ldmatrix, mma.sync, ld_pred, realign, mask_frames

struct Region {
  const void* z;  // [B, f_in * c2, T], activation type
  int c2;         // channels (r and i stacked) of a frequency row
  int row0;       // first row of its channels in the partials' C2tot axis
};

struct Params {
  Region reg[2];
  int n_reg;
  const void* g;  // [B, f_out * c2out, T], activation type
  float* part;    // [splits, 5, 2, c2tot, c2out] f32
  int batch, f_in, f_out, c2out, c2tot, n_time, splits;
};

// ---------------------------------------------------------------- bf16 --

constexpr int BK = 64;            // frames a step
constexpr int PITCH = BK + 8;     // staged row pitch (elements)
constexpr int LANES = BK / 8;     // lanes that stage one row, a 16-byte chunk each
constexpr int ROWS_PER_WARP = 32 / LANES;
constexpr int MAX_PROBLEMS = 4;

// One GEMM: the windows of one region and one output-row parity.
struct Problem {
  const bf16* z;
  int c2, row0;    // the region's channels and first partials row
  int rows;        // input rows of a window: 5, 3 or 2
  int parity;      // decoder: output row 2 m + parity, taps jf = 2 w + parity
  int m_rows;      // M = rows * c2
  int m_tiles;     // tiles of BM window rows
  int tile0;       // its first tile in blockIdx.x
};

struct MmaParams {
  Problem prob[MAX_PROBLEMS];
  int n_prob;
  const bf16* g;
  float* part;
  int batch, f_in, f_out, c2out, c2tot, n_time, splits;
  int n_tiles;     // tiles of BN columns (jt, co)
  int k_rows;      // output rows of a problem per (b, chunk): f_out or f_in
};

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int WARPS_K_> struct Cfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, WARPS_K = WARPS_K_;
  static constexpr int WARPS = WARPS_M * WARPS_N * WARPS_K;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;       // m16 tiles a warp
  static constexpr int NT = WN / 8;        // n8 tiles a warp
  static constexpr int ACC = MT * NT * 4;  // f32 accumulators a thread
  static constexpr int HALF = BN / 2;      // output channels of a tile (x 2 time taps)
  static constexpr int A_ROUNDS = BM / (ROWS_PER_WARP * WARPS);  // z rows a warp stages
  static constexpr int B_ROUNDS = (HALF + ROWS_PER_WARP * WARPS - 1) / (ROWS_PER_WARP * WARPS);
  static constexpr int KSTEPS = BK / 16 / WARPS_K;  // k16 steps of a warp a step
  static constexpr int STAGE = (BM + BN) * PITCH;   // elements of one stage
  static constexpr int RED = (WARPS_K - 1) * WARPS_M * WARPS_N * ACC * 32;  // f32
  static constexpr int SMEM = 2 * STAGE * 2 > RED * 4 ? 2 * STAGE * 2 : RED * 4;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && (NT == 1 || NT % 2 == 0), "warp tile");
  static_assert(BM % (ROWS_PER_WARP * WARPS) == 0 && BN % 2 == 0, "staging rounds");
  static_assert(BK / 16 % WARPS_K == 0, "k16 split");
};

// A step: its index in the split's list, batch element, first frame and
// output row m.
struct Step {
  int idx, b, t0, m;
};

template <class C, bool kDecoder>
__global__ void __launch_bounds__(C::THREADS) dw_mma_kernel(const MmaParams p) {
  constexpr int BM = C::BM, HALF = C::HALF;
  constexpr int DELTA = kDecoder ? 1 : 0;  // g is staged from frame t0 - DELTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  // the block's problem, M tile and N tile
  int pi = 0;
#pragma unroll
  for (int i = 1; i < MAX_PROBLEMS; ++i)
    if (i < p.n_prob && static_cast<int>(blockIdx.x) >= p.prob[i].tile0) pi = i;
  const Problem pr = p.prob[pi];
  const int tile = blockIdx.x - pr.tile0;
  const int mt = tile / p.n_tiles;
  const int nt = tile - mt * p.n_tiles;
  const int r_lo = mt * BM;                            // first window row of the tile
  const int r_hi = min(r_lo + BM, pr.m_rows);          // past its last live one
  const int split = blockIdx.y;

  // the steps (b, frame chunk, m) of this split, m fastest (fewer than 2^31
  // for any input that fits on a card); the decoder's chunks start off
  // frames early, so that its one partial chunk also holds frame -1 of g's
  // second time tap: one edge step a row
  const int off = kDecoder ? (BK - p.n_time % BK) % BK : 0;
  const int chunks = (p.n_time + off + BK - 1) / BK;
  const long long steps = static_cast<long long>(p.batch) * chunks * p.k_rows;
  const int first = static_cast<int>(steps * split / p.splits);
  const int last = static_cast<int>(steps * (split + 1) / p.splits);
  const long long f_in_rows = static_cast<long long>(p.f_in) * pr.c2;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wk = warp / (C::WARPS_M * C::WARPS_N);
  const int wmn = warp - wk * C::WARPS_M * C::WARPS_N;
  const int wm = wmn / C::WARPS_N;
  const int wn = wmn - wm * C::WARPS_N;
  const int lc = lane % LANES;  // the 16-byte chunk this lane stages

  auto advance = [&](Step s) {
    ++s.idx;
    if (++s.m == p.k_rows) {
      s.m = 0;
      s.t0 += BK;
      if (s.t0 >= p.n_time) {
        s.t0 = -off;
        ++s.b;
      }
    }
    return s;
  };
  // first input row of output row m's window
  auto window = [&](int m) { return kDecoder ? m - 1 + pr.parity : 2 * m - 2; };
  // a step is live when its window meets [0, f_in) within the tile's rows
  auto next_live = [&](Step s) {
    while (s.idx < last) {
      const long long fr = static_cast<long long>(window(s.m)) * pr.c2;
      if (fr + r_lo < f_in_rows && fr + r_hi > 0) break;
      s = advance(s);
    }
    return s;
  };

  // Staging. Round i of z stages tile row a_q(i) = (i * WARPS + warp) *
  // ROWS_PER_WARP + lane / LANES, round i of g channel nt * HALF + its slot;
  // lane lc loads the 16-byte chunks lc and lc + 1 of the row's aligned
  // span. Offsets from the step's first row are fixed for the block.
  const int slot = warp * ROWS_PER_WARP + lane / LANES;
  int a_row[C::A_ROUNDS], a_off[C::A_ROUNDS], b_off[C::B_ROUNDS];
  bool a_live[C::A_ROUNDS], b_ok[C::B_ROUNDS];
#pragma unroll
  for (int i = 0; i < C::A_ROUNDS; ++i) {
    a_row[i] = r_lo + i * C::WARPS * ROWS_PER_WARP + slot;
    a_live[i] = a_row[i] < r_hi;
    a_off[i] = a_row[i] * p.n_time;
  }
#pragma unroll
  for (int i = 0; i < C::B_ROUNDS; ++i) {
    const int n = i * C::WARPS * ROWS_PER_WARP + slot;
    const int co = nt * HALF + n;
    b_ok[i] = n < HALF && co < p.c2out;
    b_off[i] = co * p.n_time;
  }
  // a step's first element of z's window (frame t0) and of g (t0 - DELTA)
  auto z_base = [&](const Step& st) {
    return pr.z + ((static_cast<long long>(st.b) * p.f_in + window(st.m)) * pr.c2 * p.n_time +
                   st.t0);
  };
  auto g_base = [&](const Step& st) {
    const int fo = kDecoder ? 2 * st.m + pr.parity : st.m;
    return p.g + ((static_cast<long long>(st.b) * p.f_out + fo) * p.c2out * p.n_time + st.t0 -
                  DELTA);
  };
  // steps whose staged frames (z's t0 ... t0 + BK - 1, g's t0 - DELTA ...
  // t0 + BK - DELTA) all lie in [0, T) need no masks; every chunk they load
  // holds a frame of its row
  auto interior = [&](const Step& st) {
    return st.t0 >= DELTA && st.t0 + BK + 1 - DELTA <= p.n_time;
  };
  // chunk k of a row whose frame fs (span frames wanted) is src: zeros when
  // the row is out or none of the chunk's frames is wanted, so no load
  // leaves the row's frames
  auto load = [&](const bf16* src, bool ok, bool edge, int fs, int span, int k) {
    const int cf = fs - residue(src) + 8 * k;
    const bool want = edge ? (cf + 8 > max(fs, 0)) & (cf < min(fs + span, p.n_time))
                           : cf < fs + span;  // chunk 8 of z is past its span at residue 0
    return ld_pred(aligned_chunk(src) + k, ok & want);
  };

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  uint4 a_lo[C::A_ROUNDS], a_hi[C::A_ROUNDS], b_lo[C::B_ROUNDS], b_hi[C::B_ROUNDS];
  int a_res[C::A_ROUNDS], b_res[C::B_ROUNDS];
  auto issue = [&](const Step& st, bool edge) {
    const bf16* zs = z_base(st);
    const bf16* gs = g_base(st);
    const long long first_row = static_cast<long long>(window(st.m)) * pr.c2;
#pragma unroll
    for (int i = 0; i < C::A_ROUNDS; ++i) {
      const unsigned long long row = first_row + a_row[i];
      const bool ok = a_live[i] & (row < static_cast<unsigned long long>(f_in_rows));
      const bf16* src = zs + a_off[i];
      a_res[i] = residue(src);
      a_lo[i] = load(src, ok, edge, st.t0, BK, lc);
      a_hi[i] = load(src, ok, edge, st.t0, BK, lc + 1);
    }
#pragma unroll
    for (int i = 0; i < C::B_ROUNDS; ++i) {
      const bf16* src = gs + b_off[i];
      b_res[i] = residue(src);
      b_lo[i] = load(src, b_ok[i], edge, st.t0 - DELTA, BK + 1, lc);
      b_hi[i] = load(src, b_ok[i], edge, st.t0 - DELTA, BK + 1, lc + 1);
    }
  };
  // Realigns and stores round r of the loaded rows (z's rounds, then g's)
  // into a stage; edge steps mask the frames outside [0, T).
  auto store_round = [&](int r, const Step& st, int stage, bool edge) {
    bf16* sa = smem + stage * C::STAGE + slot * PITCH + 8 * lc;
    if (r < C::A_ROUNDS) {
      uint4 v = realign(a_lo[r], a_hi[r], a_res[r]);
      if (edge) v = mask_frames(v, st.t0 + 8 * lc, p.n_time);
      *reinterpret_cast<uint4*>(sa + r * C::WARPS * ROWS_PER_WARP * PITCH) = v;
      return;
    }
    const int i = r - C::A_ROUNDS;  // frames fs + k: tap jt = 1; fs + 1 + k: jt = 0
    const int n = i * C::WARPS * ROWS_PER_WARP + slot;
    if (C::HALF % (C::WARPS * ROWS_PER_WARP) != 0 && n >= HALF) return;
    uint4 v1 = realign(b_lo[i], b_hi[i], b_res[i]);
    uint4 v0 = realign(b_lo[i], b_hi[i], b_res[i] + 1);
    if (edge) {
      const int fb = st.t0 - DELTA + 8 * lc;
      v1 = mask_frames(v1, fb, p.n_time);
      v0 = mask_frames(v0, fb + 1, p.n_time);
    }
    bf16* dst = sa + (BM + i * C::WARPS * ROWS_PER_WARP) * PITCH;
    *reinterpret_cast<uint4*>(dst + HALF * PITCH) = v1;
    *reinterpret_cast<uint4*>(dst) = v0;
  };
  constexpr int ROUNDS = C::A_ROUNDS + C::B_ROUNDS;
  auto store = [&](const Step& st, int stage, bool edge) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) store_round(r, st, stage, edge);
  };

  // ldmatrix row addresses of this lane (elements within a stage)
  const int fa_off = (wm * C::WM + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const int fb_off = (BM + wn * C::WN + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                     ((lane >> 3) & 1) * 8;
  struct Frags {
    uint32_t a[C::MT][4];
    uint32_t b[C::NT][2];
  };
  auto load_frags = [&](Frags& f, const bf16* s, int ks) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i) ldsm_x4(f.a[i], s + fa_off + i * 16 * PITCH + ks * 16);
    if constexpr (C::NT == 1) {
      ldsm_x2(f.b[0], s + fb_off + ks * 16);
    } else {
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) ldsm_x4(f.b[j], s + fb_off + j * 8 * PITCH + ks * 16);
    }
  };
  auto mma_all = [&](const Frags& f) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j) mma_bf16(&acc[(i * C::NT + j) * 4], f.a[i], f.b[j]);
  };
  // The products of a full stage, the next k16 step's fragments loaded
  // before the current products; after(kk) runs after the warp's k16 step kk.
  auto products = [&](int stage, auto after) {
    const bf16* s = smem + stage * C::STAGE;
    Frags f[2];
    load_frags(f[0], s, wk);
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      if (kk + 1 < C::KSTEPS) load_frags(f[(kk + 1) & 1], s, (kk + 1) * C::WARPS_K + wk);
      mma_all(f[kk & 1]);
      after(kk);
    }
  };
  // The products of the k16 steps [ks_lo, ks_hi) of a stage (a partial chunk).
  auto products_range = [&](int stage, int ks_lo, int ks_hi) {
    const bf16* s = smem + stage * C::STAGE;
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const int ks = kk * C::WARPS_K + wk;
      if (ks < ks_lo || ks >= ks_hi) continue;
      Frags f;
      load_frags(f, s, ks);
      mma_all(f);
    }
  };

  Step cur;
  cur.idx = first;
  cur.m = first % p.k_rows;
  cur.t0 = first / p.k_rows % chunks * BK - off;
  cur.b = first / p.k_rows / chunks;
  cur = next_live(cur);
  if (cur.idx < last) {
    issue(cur, !interior(cur));
    store(cur, 0, !interior(cur));
  }
  __syncthreads();
  int stage = 0;
  while (cur.idx < last) {
    const Step nxt = next_live(advance(cur));
    const bool more = nxt.idx < last;
    // k16 steps holding frames in [0, T)
    const int ks_lo = max(0, -cur.t0) / 16;
    const int ks_hi = (min(BK, p.n_time - cur.t0) + 15) / 16;
    if (more && interior(nxt) && ks_lo == 0 && ks_hi == BK / 16) {
      // the common step: the next step's rows are realigned and stored
      // between the k16 steps' products, from the second one on
      issue(nxt, false);
      products(stage, [&](int kk) {
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r)
          if (C::KSTEPS == 1 || 1 + r * (C::KSTEPS - 1) / ROUNDS == kk)
            store_round(r, nxt, stage ^ 1, false);
      });
    } else {
      if (more) issue(nxt, !interior(nxt));
      products_range(stage, ks_lo, ks_hi);
      if (more) store(nxt, stage ^ 1, !interior(nxt));
    }
    __syncthreads();
    stage ^= 1;
    cur = nxt;
  }

  if constexpr (C::WARPS_K > 1) {  // sum the k-split warps through shared memory
    float* red = reinterpret_cast<float*>(smem_raw);
    if (wk > 0) {
#pragma unroll
      for (int i = 0; i < C::ACC; ++i)
        red[(((wk - 1) * C::WARPS_M * C::WARPS_N + wmn) * C::ACC + i) * 32 + lane] = acc[i];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < C::WARPS_K; ++w) {
#pragma unroll
      for (int i = 0; i < C::ACC; ++i)
        acc[i] += red[(((w - 1) * C::WARPS_M * C::WARPS_N + wmn) * C::ACC + i) * 32 + lane];
    }
  }

  // tile row r_lo + r is window row w = r / c2 (tap jf), channel ci; column
  // n is tap jt = n / HALF, channel nt * HALF + n % HALF
  const long long tap = static_cast<long long>(p.c2tot) * p.c2out;  // one (jf, jt) slice
  float* out = p.part + static_cast<long long>(split) * 10 * tap;
  const int g8 = lane / 4, q4 = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + wm * C::WM + i * 16 + g8 + 8 * h;
      if (r >= r_hi) continue;
      const int w = r / pr.c2;
      const int ci = r - w * pr.c2;
      const int jf = kDecoder ? 2 * w + pr.parity : w;
      float* row = out + jf * 2 * tap + static_cast<long long>(pr.row0 + ci) * p.c2out;
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn * C::WN + j * 8 + 2 * q4 + e;
          const int jt = n / HALF;
          const int co = nt * HALF + n - jt * HALF;
          if (co < p.c2out) row[jt * tap + co] = acc[(i * C::NT + j) * 4 + 2 * h + e];
        }
    }
}

// ----------------------------------------------------------------- f32 --

constexpr int F32_TILE = 32;  // input x output channels of a block
constexpr int F32_BK = 32;    // frames a step
constexpr int F32_THREADS = 128;

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

// Grid (the regions' 32 x 32 channel tiles, jf, split): split s walks the
// steps [s * steps / S, (s + 1) * steps / S) of the (b, fo, frame chunk)
// list, skips the rows tap jf does not reach, stages g and z for both time
// taps element by element and sums with FMA.
template <bool kDecoder>
__global__ void __launch_bounds__(F32_THREADS) dw_f32_kernel(const Params p, int m_tiles0,
                                                             int n_tiles) {
  constexpr int TL = F32_TILE, K = F32_BK, PER_THREAD = 2 * TL * TL / F32_THREADS;
  __shared__ float zs[2][TL][K + 1];
  __shared__ float gs[TL][K + 1];

  int tile = blockIdx.x / n_tiles;
  const int n_tile = blockIdx.x - tile * n_tiles;
  const bool second = p.n_reg > 1 && tile >= m_tiles0;
  if (second) tile -= m_tiles0;
  const Region rg = second ? p.reg[1] : p.reg[0];
  const int ci0 = tile * TL;
  const int co0 = n_tile * TL;
  const int jf = blockIdx.y;
  const int split = blockIdx.z;

  const int chunks = (p.n_time + K - 1) / K;
  const long long steps = static_cast<long long>(p.batch) * p.f_out * chunks;
  const long long first = steps * split / p.splits;
  const long long last = steps * (split + 1) / p.splits;

  float acc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;

  const float* gsrc = static_cast<const float*>(p.g);
  const float* zsrc = static_cast<const float*>(rg.z);
  for (long long step = first; step < last; ++step) {
    const int b = static_cast<int>(step / (static_cast<long long>(p.f_out) * chunks));
    const int rem = static_cast<int>(step - static_cast<long long>(b) * p.f_out * chunks);
    const int fo = rem / chunks;
    const int t0 = (rem - fo * chunks) * K;
    const int fi = input_row<kDecoder>(fo, jf, p.f_in);
    if (fi < 0) continue;  // the same for every thread of the block

    const float* grow = gsrc + (static_cast<long long>(b) * p.f_out + fo) * p.c2out * p.n_time;
    for (int idx = threadIdx.x; idx < TL * K; idx += F32_THREADS) {
      const int n = idx / K;
      const int k = idx - n * K;  // consecutive threads read consecutive frames
      const int co = co0 + n;
      const int t = t0 + k;
      gs[n][k] = co < p.c2out && t < p.n_time ? grow[static_cast<long long>(co) * p.n_time + t]
                                              : 0.f;
    }
    const float* zrow = zsrc + (static_cast<long long>(b) * p.f_in + fi) * rg.c2 * p.n_time;
    for (int idx = threadIdx.x; idx < 2 * TL * K; idx += F32_THREADS) {
      const int jt = idx / (TL * K);
      const int r = idx - jt * TL * K;
      const int m = r / K;
      const int k = r - m * K;
      const int ci = ci0 + m;
      const int t = t0 + k + (kDecoder ? jt : jt - 1);
      zs[jt][m][k] = ci < rg.c2 && t >= 0 && t < p.n_time
                         ? zrow[static_cast<long long>(ci) * p.n_time + t]
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int idx = threadIdx.x + e * F32_THREADS;
      const int jt = idx / (TL * TL);
      const int r = idx - jt * TL * TL;
      const int m = r / TL;
      const int n = r - m * TL;
      float s = acc[e];
      for (int k = 0; k < K; ++k) s = fmaf(zs[jt][m][k], gs[n][k], s);
      acc[e] = s;
    }
    __syncthreads();
  }

  float* out = p.part + (static_cast<long long>(split) * 5 + jf) * 2 * p.c2tot * p.c2out;
  const long long tap = static_cast<long long>(p.c2tot) * p.c2out;  // one (jf, jt) slice
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int idx = threadIdx.x + e * F32_THREADS;
    const int jt = idx / (TL * TL);
    const int r = idx - jt * TL * TL;
    const int ci = ci0 + r / TL;
    const int co = co0 + r % TL;
    if (ci < rg.c2 && co < p.c2out)
      out[jt * tap + static_cast<long long>(rg.row0 + ci) * p.c2out + co] = acc[e];
  }
}

// ---------------------------------------------------------------- launch --

template <class C, bool kDecoder> int launch_mma(MmaParams mp, cudaStream_t stream) {
  mp.n_tiles = (mp.c2out + C::HALF - 1) / C::HALF;
  int tiles = 0;
  for (int i = 0; i < mp.n_prob; ++i) {
    Problem& pr = mp.prob[i];
    pr.m_rows = pr.rows * pr.c2;
    pr.m_tiles = (pr.m_rows + C::BM - 1) / C::BM;
    pr.tile0 = tiles;
    tiles += pr.m_tiles * mp.n_tiles;
  }
  auto kernel = dw_mma_kernel<C, kDecoder>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(mp.splits)), C::THREADS,
           C::SMEM, stream>>>(mp);
  return static_cast<int>(cudaGetLastError());
}

// Launches the kernel of the tile (bm, bn) the caller chose (the Python
// side's dw_tile): bf16 takes (128, 128), (64, 64), (32, 32), (16, 32) or
// (32, 8) window rows x (jt, co) columns, f32 only (32, 32) channels. The
// caller sized part for p.splits and set each region's z, c2 and row0.
template <typename T, bool kDecoder>
int launch(const Params& p, int bm, int bn, cudaStream_t stream) {
  if (p.batch <= 0 || p.n_time <= 0 || p.f_in <= 0 || p.f_out <= 0 || p.c2out <= 0 ||
      p.splits <= 0 || p.splits > 65535 || p.n_reg < 1 || p.n_reg > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < p.n_reg; ++i)
    if (p.reg[i].c2 <= 0 || p.reg[i].row0 < 0 || p.reg[i].row0 + p.reg[i].c2 > p.c2tot)
      return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 4) {
    if (bm != F32_TILE || bn != F32_TILE) return static_cast<int>(cudaErrorInvalidValue);
    const int m_tiles0 = (p.reg[0].c2 + F32_TILE - 1) / F32_TILE;
    const int m_tiles = m_tiles0 + (p.n_reg > 1 ? (p.reg[1].c2 + F32_TILE - 1) / F32_TILE : 0);
    const int n_tiles = (p.c2out + F32_TILE - 1) / F32_TILE;
    const dim3 grid(static_cast<unsigned>(m_tiles * n_tiles), 5, static_cast<unsigned>(p.splits));
    dw_f32_kernel<kDecoder><<<grid, F32_THREADS, 0, stream>>>(p, m_tiles0, n_tiles);
    return static_cast<int>(cudaGetLastError());
  } else {
    MmaParams mp{};
    mp.n_prob = 0;
    for (int i = 0; i < p.n_reg; ++i)
      for (int parity = 0; parity < (kDecoder ? 2 : 1); ++parity) {
        Problem& pr = mp.prob[mp.n_prob++];
        pr.z = static_cast<const bf16*>(p.reg[i].z);
        pr.c2 = p.reg[i].c2;
        pr.row0 = p.reg[i].row0;
        pr.rows = kDecoder ? 3 - parity : 5;
        pr.parity = parity;
      }
    mp.g = static_cast<const bf16*>(p.g);
    mp.part = p.part;
    mp.batch = p.batch;
    mp.f_in = p.f_in;
    mp.f_out = p.f_out;
    mp.c2out = p.c2out;
    mp.c2tot = p.c2tot;
    mp.n_time = p.n_time;
    mp.splits = p.splits;
    mp.k_rows = kDecoder ? p.f_in : p.f_out;
    if (kDecoder && p.f_out != 2 * p.f_in) return static_cast<int>(cudaErrorInvalidValue);
    if (bm == 128 && bn == 128) return launch_mma<Cfg<128, 128, 2, 4, 1>, kDecoder>(mp, stream);
    if (bm == 64 && bn == 64) return launch_mma<Cfg<64, 64, 2, 2, 1>, kDecoder>(mp, stream);
    if (bm == 32 && bn == 32) return launch_mma<Cfg<32, 32, 2, 2, 1>, kDecoder>(mp, stream);
    if (bm == 16 && bn == 32) return launch_mma<Cfg<16, 32, 1, 2, 2>, kDecoder>(mp, stream);
    if (bm == 32 && bn == 8) return launch_mma<Cfg<32, 8, 2, 1, 2>, kDecoder>(mp, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dwgemm
