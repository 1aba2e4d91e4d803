// The fused DCCRN block's bf16 implicit GEMM with weight reuse, 16-byte
// staging and a two-stage pipeline, on Hopper (sm_90a): mma_kernel.
//
// Same sums as block_gemm.cuh (read its note for the layout and the two
// indexings): for one batch item b and output frequency row fo,
//
//   Y[co, t] = bias[co] + sum over (region, live tap jf, time tap jt, channel ci)
//              W[jf, jt, co, ci] * Z[fi(fo, jf), ci, t + jt + t_shift],
//
// Z = PReLU(a_diag * X + a_cross * partner(X) + c0) rounded to bf16 (the
// forward), or X as it is (kGrad, the input gradients). block_gemm.cuh's
// launch sends every bf16 variant here, over both indexings and both kGrad
// values (rows of PERF.md's table): the encoder block (row 3, encoder
// indexing), the decoder block (row 4, kDecoder), the encoder's input
// gradient (row 5, kGrad on the decoder indexing) and the decoder's (row 7,
// kGrad on the encoder indexing).
//
// Tiling. A block of 256 threads computes BM output channels x NB column
// segments of 64 frames: the same frames [t0, t0 + 64) of output row fo for
// NB consecutive batch items. Every staged weight step serves NB x 64
// columns, and each segment keeps its own staged rows, so time tap jt = 1
// stays a shift of one staged row. The
// BM rows hold BM/2 real-part channels and their BM/2 imaginary partners,
// so the stats epilogue finds every row's partner in the same tile. The
// host picks (BM, NB) per block (kernels/conv_block.py: block_tile): 128 x
// 2 for 128 output channels or more, 64 x 2, 32 x 4 and 16 x 4 below, so
// the small tiles get more frames per warp rather than idle warps. Two
// blocks an SM (128 registers a thread).
//
// Row pairs (kPair; not on the encoder indexing with kGrad). One block
// computes output rows 2r and 2r + 1 as the two halves of its tile,
// walking the input rows they read as its taps d, each staged and
// activated once for both. Decoder indexing: rows r - 1 + d, d = 0, 1, 2
// (even: jf = 2 d; odd: jf = 2 d - 1, none for d = 0), 40% fewer stages a
// row. Encoder indexing: rows 4 r - 2 + d, d = 0..6 (even: jf = d; odd: jf
// = d - 2), 30% fewer stages and 40% more products (the halves' weights
// are zero on the taps the other row alone reads). The host takes it for
// the small GEMMs, where the stages, not the products, bound the kernel.
//
// K order. The block walks its K steps: regions, live taps jf (the input
// rows inside [0, f_in); the decoder's even rows take jf = 0, 2, 4, odd
// rows 1, 3), then k16 steps of eight complex channel pairs, interleaved
// (slot 2p: real channel j + p, slot 2p + 1: its partner c + j + p, c =
// c2 / 2). One 16-byte load of each row of a pair serves both halves of the
// pointwise, whose partner is the other row. Pairs past c (a width that is
// not a multiple of 16) stage as zeros against zero weights. The wrapper
// packs the weights in this order ([m_tile][jf][k16 step][jt][BM rows][16]),
// so a step's weight tile is one contiguous run.
//
// Pipeline. Two shared-memory stages of two k16 steps (32 channels), one
// __syncthreads a stage. A stage issues the next stage's weight tiles as
// cp.async copies and its activations as 16-byte register loads (two
// aligned chunks around each row's eight frames, predicated: no load leaves
// a row's frames), runs its own products, and after them realigns the
// loaded rows (mma_util.cuh: realign, mask_frames), applies the folded CBN
// and PReLU in f32 in registers with the pair's coefficients read once
// from shared memory (the block copies both regions' coefficients there at
// its start), packs each (real, imaginary) pair of a frame into one word
// and stores it into the other stage: [segment][frame][slot] at a pitch of
// 40 elements (80 bytes: eight rows hit eight distinct bank quads for
// ldmatrix). Eight lanes stage one row's 64 frames, lane u loading the
// chunks around frames 8 u ... (a warp reads four rows, 128 contiguous
// bytes each); lane u stores frame (i + u) % 8 at step i, so each word
// store of the warp hits 32 distinct banks. The frame past a segment's 64
// (the other time tap) comes from the same loaded chunks.
//
// Products: mma.sync m16n8k16 (bf16 in, f32 accumulate) on warp tiles of
// WM x WN inside one segment; fragments by ldmatrix (.x4 for A and for two
// n8 tiles of B), one (k16 step, time tap) at a time.
//
// Epilogue (as block_gemm.cuh's): the f32 tile through shared memory, the
// bias added in f32, one rounding to bf16, stats from the f32 values before
// rounding (atomicAdd of each (row, segment)'s sums into [B, R_out, 8]);
// kGrad: no bias, no stats, the rows split over y and y2 (out_row).
//
// What bounds it (tools/block_phase_probe.py --design after, PERF.md
// section 6): on the 128 x 2 tiles the products, about three quarters of a
// block, overlapping the staging only in part; on the small tiles the
// latency of each stage's loads, which the few products there cannot
// cover. Registers and shared memory per tile: the notes of
// conv_block.cu, conv_block_bwd.cu, deconv_block.cu and deconv_block_bwd.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_util.cuh"

namespace blockmma {

using namespace mmautil;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 64;           // frames of a column segment
constexpr int ZROWS = SEG + 1;    // staged frames of a segment: both time taps
constexpr int KS = 2;             // k16 steps a stage
constexpr int PITCH = KS * 16 + 8;  // staged row pitch (elements): an odd number of 16 bytes
constexpr int MINB = 2;           // blocks an SM holds (__launch_bounds__: 128 registers)
constexpr int MAX_REG = 2;
static_assert((PITCH / 8) % 2 == 1, "ldmatrix's eight rows on distinct bank quads");

struct Region {
  const bf16* x;      // [B, f_in * c2, T]
  const float* coef;  // [3 * c2 + 1]: a_diag, a_cross, c0 (rounded to bf16), alpha; kGrad: null
  const bf16* w;      // [m_tiles, 5, nks, 2, BM, 16], pair-interleaved K, zero past c2 / out rows
  int c2;             // channels (r and i stacked) of a frequency row
  int nks;            // k16 steps a tap: ceil(c2 / 2 / 8)
};

struct Params {
  Region reg[MAX_REG];
  int n_reg;
  const float* bias;  // [c2out]; kGrad: unused
  bf16* y;            // [B, f_out * c2out, T], or with y2 the a channels [B, f_out * c2a, T]
  float* stats;       // [B, f_out * c2out, 8], zeroed; null without stats
  bf16* y2;           // kGrad: null, or the s channels [B, f_out * (c2out - c2a), T]
  int c2a;
  int batch, f_in, f_out, c2out, n_time;
  int m_tiles, b_groups;  // set by launch
};

template <int BM_, int NB_, int WARPS_M_> struct Cfg {
  static constexpr int BM = BM_, NB = NB_, N = NB * SEG;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = N / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8, ACC = MT * NT * 4;
  static constexpr int UNITS = NB * 8 * KS * 8 / THREADS;  // (segment, 8 frames, pair) a thread
  static constexpr int W_ELEMS = 2 * BM * PITCH;           // [jt][row][slot]
  static constexpr int Z_ELEMS = NB * ZROWS * PITCH;       // [segment][frame][slot]
  static constexpr int STAGE = W_ELEMS + Z_ELEMS;
  static constexpr int CPITCH = N + 8;                     // f32 epilogue tile pitch
  // bytes of shared memory besides the forward's coefficients (after the stages)
  static constexpr int STAGES_BYTES = 2 * STAGE * 2;
  static constexpr int TILE_BYTES = BM * CPITCH * 4;
  static_assert(WM % 16 == 0 && NT % 2 == 0 && SEG % WN == 0, "warp tile inside a segment");
  static_assert(UNITS >= 1 && UNITS <= 2 && NB * 8 * KS * 8 == UNITS * THREADS, "units");
  static_assert(W_ELEMS * 2 % 16 == 0 && STAGE * 2 % 16 == 0, "16-byte aligned stages");
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

// kGrad: start of output channel co's row of frames for (b, fo); with y2,
// co counts the joined channels [a_r, s_r, a_i, s_i] (block_gemm.cuh: out_row).
__device__ __forceinline__ bf16* out_row(const Params& p, int b, int fo, int co, int c_half) {
  if (p.y2 == nullptr)
    return p.y + ((static_cast<long long>(b) * p.f_out + fo) * p.c2out + co) * p.n_time;
  const bool imag = co >= c_half;
  const int j = imag ? co - c_half : co;
  const int ca = p.c2a / 2;
  const int c2s = p.c2out - p.c2a;
  if (j < ca)
    return p.y + ((static_cast<long long>(b) * p.f_out + fo) * p.c2a + j + (imag ? ca : 0)) *
                     p.n_time;
  return p.y2 + ((static_cast<long long>(b) * p.f_out + fo) * c2s + (j - ca) +
                 (imag ? c2s / 2 : 0)) *
                    p.n_time;
}

// Input row of output row fo under tap jf, or -1 (outside, or the other
// parity of the decoder).
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

// Element s (in [0, 8)) of the eight in hi, as the low half of a word.
__device__ __forceinline__ uint32_t element(uint4 hi, int s) {
  const uint32_t a = s & 2 ? hi.y : hi.x;
  const uint32_t b = s & 2 ? hi.w : hi.z;
  const uint32_t w = s & 4 ? b : a;
  return s & 1 ? w >> 16 : w & 0xffffu;
}

__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <bool kDecoder, bool kGrad, bool kPair, class C>
__global__ void __launch_bounds__(THREADS, MINB) mma_kernel(const Params p) {
  static_assert(!kPair || kDecoder || !kGrad, "row pairs: not on the encoder indexing's kGrad");
  constexpr int BM = C::BM, NB = C::NB, N = C::N;
  // kPair: the tile's two halves are output rows 2 row and 2 row + 1, whose
  // taps d read input rows row - 1 + d (decoder, d < 3) or 4 row - 2 + d
  // (encoder, d < 7); otherwise one output row, taps jf = 0..4
  constexpr int NTAPS = kPair ? (kDecoder ? 3 : 7) : 5;
  constexpr int HROWS = kPair ? BM / 2 : BM;  // tile rows of one output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int t0 = blockIdx.x * SEG;
  const int row = blockIdx.y;  // output row, or output row pair
  const int bg = blockIdx.z / p.m_tiles;
  const int m_tile = blockIdx.z - bg * p.m_tiles;
  const int c_half = p.c2out / 2;
  const int t_first = kDecoder ? t0 : t0 - 1;  // staged row 0 of every segment
  const bool edge = t_first < 0 || t_first + ZROWS > p.n_time;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;

  // the block's K steps: regions, live taps, k16 steps; taps lists the live
  // taps, three bits each
  auto tap_row = [&](int jf) {  // the input row tap jf reads, or -1
    if constexpr (kPair) {
      const int fi = (kDecoder ? row - 1 : 4 * row - 2) + jf;
      return fi >= 0 && fi < p.f_in ? fi : -1;
    }
    return input_row<kDecoder>(row, jf, p.f_in);
  };
  int taps = 0, n_live = 0;
#pragma unroll
  for (int jf = 0; jf < NTAPS; ++jf)
    if (tap_row(jf) >= 0) taps |= jf << (3 * n_live++);
  const int nks0 = p.reg[0].nks, nks1 = p.n_reg > 1 ? p.reg[1].nks : 0;
  const int n_steps = n_live * (nks0 + nks1);
  const int n_stages = (n_steps + KS - 1) / KS;
  // a position in the list: region, live tap, k16 step (no division, no copy
  // of the parameters; past the list, reg = n_reg)
  struct KPos {
    int reg, tl, ks;
  };
  auto advance = [&](KPos k) {
    if (++k.ks == (k.reg ? nks1 : nks0)) {
      k.ks = 0;
      if (++k.tl == n_live) {
        k.tl = 0;
        ++k.reg;
      }
    }
    return k;
  };

  // the forward's coefficients, both regions, in shared memory after the
  // stages (copied there once stage 0's loads are in flight)
  float* coefs = reinterpret_cast<float*>(smem_raw + C::STAGES_BYTES);
  const int coef0 = kGrad ? 0 : 3 * p.reg[0].c2 + 1;  // region 1's first coefficient

  // Staging units of this thread: unit q = ur * THREADS + tid is the eight
  // frames u = q % 8 (from 8 u) of pair pp = (q / 8) % 8 of the stage's k16
  // step kk = (q / 64) % KS, segment q / (64 KS). Eight lanes read one row's
  // consecutive 16-byte chunks; a warp covers four pairs.
  const int u_u = tid & 7;
  const int u_pp = (tid >> 3) & 7;
  const int u_kk = (tid >> 6) & (KS - 1);
  const int f0 = t_first + 8 * u_u;  // the unit's first frame
  int u_b[C::UNITS], u_zoff[C::UNITS];
  bool u_bok[C::UNITS];
#pragma unroll
  for (int ur = 0; ur < C::UNITS; ++ur) {
    const int seg = (ur * THREADS + tid) / (64 * KS);
    const int b = bg * NB + seg;
    u_bok[ur] = b < p.batch;
    u_b[ur] = min(b, p.batch - 1);
    u_zoff[ur] = C::W_ELEMS + (seg * ZROWS + 8 * u_u) * PITCH + u_kk * 16 + 2 * u_pp;
  }

  struct Unit {
    uint4 lo_r, hi_r, lo_i, hi_i;
    int s;   // residues: the real row's in bits 0-3, the imaginary row's in 4-7
    int cf;  // forward: the real channel's coefficient in shared memory, -1 for none
    int c;   // forward: the region's pairs
    int ca;  // forward: the region's PReLU slope in shared memory
  };
  Unit units[C::UNITS];

  // The stage whose first k16 step is at k: its weight tiles as cp.async
  // copies into `stage`, its activations as 16-byte loads into the units'
  // registers. Returns the position after the stage.
  auto issue = [&](KPos k, bf16* stage) {
    const int ld = u_kk;  // this thread's k16 step of the stage
    int my_reg = 0, my_ks = 0, my_jf = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const bool valid = k.reg < p.n_reg;
      const int jf = (taps >> (3 * k.tl)) & 7;
      if (kk == ld) {
        my_reg = valid ? k.reg : -1;
        my_ks = k.ks;
        my_jf = jf;
      }
      if (valid) {  // the same for the whole block
        const bf16* w = (k.reg ? p.reg[1].w : p.reg[0].w) +
                        ((static_cast<long long>(m_tile) * NTAPS + jf) * (k.reg ? nks1 : nks0) +
                         k.ks) * 2 * BM * 16;
#pragma unroll
        for (int i = 0; i < 4 * BM / THREADS + (4 * BM % THREADS != 0); ++i) {
          const int rest = i * THREADS + tid;  // (jt, row, half) in the tile's order
          if (4 * BM % THREADS != 0 && rest >= 4 * BM) break;
          cp_async16(stage + (rest >> 1) * PITCH + kk * 16 + (rest & 1) * 8, w + rest * 8);
        }
      }
      k = advance(k);
    }
    cp_async_commit();
    const int r = max(my_reg, 0);
    const int c2 = r ? p.reg[1].c2 : p.reg[0].c2;
    const int c = c2 / 2;
    const int j = my_ks * 8 + u_pp;
    const int fi = max(tap_row(my_jf), 0);
    const bool step_ok = (my_reg >= 0) & (j < c);
    const bf16* x = r ? p.reg[1].x : p.reg[0].x;
    const long long row0 = (static_cast<long long>(fi) * c2 + min(j, c - 1)) * p.n_time;
#pragma unroll
    for (int ur = 0; ur < C::UNITS; ++ur) {
      const bool ok = step_ok & u_bok[ur];
      const int span = u_u == 7 ? 9 : 8;
      const bf16* row_r =
          x + static_cast<long long>(u_b[ur]) * p.f_in * c2 * p.n_time + row0 + f0;
      const bf16* row_i = row_r + static_cast<long long>(c) * p.n_time;
      const int lo = max(f0, 0), hi = min(f0 + span, p.n_time);
      Unit& un = units[ur];
      const int s_r = residue(row_r), s_i = residue(row_i);
      un.s = s_r | (s_i << 4);
      const int cr = f0 - s_r, ci = f0 - s_i;  // first frame of each row's lo chunk
      un.lo_r = ld_pred(aligned_chunk(row_r), ok & (cr < hi) & (cr + 8 > lo));
      un.hi_r = ld_pred(aligned_chunk(row_r) + 1, ok & (cr + 8 < hi) & (cr + 16 > lo));
      un.lo_i = ld_pred(aligned_chunk(row_i), ok & (ci < hi) & (ci + 8 > lo));
      un.hi_i = ld_pred(aligned_chunk(row_i) + 1, ok & (ci + 8 < hi) & (ci + 16 > lo));
      un.cf = ok ? (r ? coef0 : 0) + j : -1;
      un.c = c;
      un.ca = (r ? coef0 : 0) + 3 * c2;
    }
    return k;
  };

  // Realign unit ur's rows, activate (forward: folded CBN and PReLU in f32,
  // from the coefficients in shared memory) or pair them (kGrad), mask the
  // frames outside [0, T) and store one word a frame into `stage`.
  auto store_unit = [&](int ur, bf16* stage) {
    const Unit& un = units[ur];
    const int s_r = un.s & 15, s_i = un.s >> 4;
    const uint4 vr = realign(un.lo_r, un.hi_r, s_r);
    const uint4 vi = realign(un.lo_i, un.hi_i, s_i);
    const uint32_t r4[4] = {vr.x, vr.y, vr.z, vr.w};
    const uint32_t i4[4] = {vi.x, vi.y, vi.z, vi.w};
    // zero coefficients give zero activations for missing pairs and batch items
    float ad_r = 0.f, ac_r = 0.f, c0_r = 0.f, ad_i = 0.f, ac_i = 0.f, c0_i = 0.f, alpha = 0.f;
    if constexpr (!kGrad) {
      if (un.cf >= 0) {
        const float* cf = coefs + un.cf;
        const int c2 = 2 * un.c;
        ad_r = cf[0];
        ad_i = cf[un.c];
        ac_r = cf[c2];
        ac_i = cf[c2 + un.c];
        c0_r = cf[2 * c2];
        c0_i = cf[2 * c2 + un.c];
        alpha = coefs[un.ca];
      }
    }
    // (real, imaginary) of one frame -> bf16 z_r in the low half, z_i in the high
    auto activate = [&](float r, float i) {
      float zr = ad_r * r + ac_r * i + c0_r;
      float zi = ad_i * i + ac_i * r + c0_i;
      zr = zr >= 0.f ? zr : alpha * zr;
      zi = zi >= 0.f ? zi : alpha * zi;
      const __nv_bfloat162 z = __floats2bfloat162_rn(zr, zi);
      return *reinterpret_cast<const uint32_t*>(&z);
    };
    uint32_t wd[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kGrad) {
        wd[2 * k] = __byte_perm(r4[k], i4[k], 0x5410);
        wd[2 * k + 1] = __byte_perm(r4[k], i4[k], 0x7632);
      } else {
        wd[2 * k] = activate(lo_f32(r4[k]), lo_f32(i4[k]));
        wd[2 * k + 1] = activate(hi_f32(r4[k]), hi_f32(i4[k]));
      }
    }
    if (edge) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (static_cast<unsigned>(f0 + e) >= static_cast<unsigned>(p.n_time)) wd[e] = 0u;
    }
    // lane u stores frame (i + u) % 8 at step i: the eight lanes of a row hit
    // eight distinct bank quads (rows 8 apart share banks at a pitch of 20
    // words), so the words are rotated by u first (rot[i] = wd[(i + u) % 8])
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1) {
      uint32_t rot[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) rot[i] = u_u & sh ? wd[(i + sh) & 7] : wd[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) wd[i] = rot[i];
    }
    bf16* dst = stage + u_zoff[ur];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(dst + ((i + u_u) & 7) * PITCH) = wd[i];
    if (u_u == 7) {  // frame 64 of the segment: element s of each hi chunk
      const uint32_t er = element(un.hi_r, s_r), ei = element(un.hi_i, s_i);
      uint32_t w;
      if constexpr (kGrad) {
        w = er | (ei << 16);
      } else {
        w = activate(lo_f32(er), lo_f32(ei));
      }
      if (static_cast<unsigned>(f0 + 8) >= static_cast<unsigned>(p.n_time)) w = 0u;
      *reinterpret_cast<uint32_t*>(dst + 8 * PITCH) = w;
    }
  };

  // fragments: ldmatrix row addresses of this lane (elements within a stage)
  const int n0 = wn * C::WN;
  const int fa_off = (wm * C::WM + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const int fb_off = C::W_ELEMS +
                     ((n0 / SEG) * ZROWS + n0 % SEG + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                     ((lane >> 3) & 1) * 8;
  struct Frags {
    uint32_t a[C::MT][4];
    uint32_t b[C::NT][2];
  };
  // sub-step sub = (k16 step kk, time tap jt)
  auto load_frags = [&](Frags& f, const bf16* s, int sub) {
    const int kk = sub >> 1, jt = sub & 1;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
      ldsm_x4(f.a[i], s + fa_off + (jt * BM + i * 16) * PITCH + kk * 16);
#pragma unroll
    for (int j = 0; j < C::NT; j += 2) ldsm_x4(f.b[j], s + fb_off + (jt + j * 8) * PITCH + kk * 16);
  };

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  // stage 0; the coefficients' loads wait behind its loads
  KPos next = issue(KPos{0, 0, 0}, smem);
  if constexpr (!kGrad) {
    const int n = coef0 + (p.n_reg > 1 ? 3 * p.reg[1].c2 + 1 : 0);
    for (int i = tid; i < n; i += THREADS)
      coefs[i] = i < coef0 ? p.reg[0].coef[i] : p.reg[1].coef[i - coef0];
    __syncthreads();
  }
#pragma unroll
  for (int ur = 0; ur < C::UNITS; ++ur) store_unit(ur, smem);
  cp_async_wait_all();
  __syncthreads();

  // -- the K loop --
  int buf = 0;
  for (int s = 0; s < n_stages; ++s) {
    const bool more = s + 1 < n_stages;
    const int n_sub = 2 * min(KS, n_steps - KS * s);  // (k16 step, time tap)s of this stage
    const bf16* cur = smem + buf * C::STAGE;
    bf16* nxt = smem + (buf ^ 1) * C::STAGE;
    if (more) next = issue(next, nxt);
    // products of this stage (one fragment buffer: loading the next
    // (k16 step, tap)'s fragments ahead cost the large tile 500 bytes of
    // spills at 128 registers, and the other block of the SM covers the
    // ldmatrix latency)
#pragma unroll
    for (int sub = 0; sub < 2 * KS; ++sub) {
      if (sub < n_sub) {
        Frags f;
        load_frags(f, cur, sub);
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT; ++j) mma_bf16(&acc[(i * C::NT + j) * 4], f.a[i], f.b[j]);
        // the next stage's rows after the last (k16 step, tap)s, so that the
        // products cover their loads
        if (more) {
#pragma unroll
          for (int ur = 0; ur < C::UNITS; ++ur)
            if (max(n_sub - C::UNITS + ur, 0) == sub) store_unit(ur, nxt);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    buf ^= 1;
  }

  // -- epilogue --
  float* ct = reinterpret_cast<float*>(smem_raw);  // [BM][CPITCH]; the stages are dead
  {
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const float* d = &acc[(i * C::NT + j) * 4];
        const int row = wm * C::WM + i * 16 + g;
        const int col = n0 + j * 8 + 2 * q;
        *reinterpret_cast<float2*>(&ct[row * C::CPITCH + col]) = make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(&ct[(row + 8) * C::CPITCH + col]) = make_float2(d[2], d[3]);
      }
  }
  __syncthreads();
  // A warp per (tile row, segment), GROUP of them at a time: their values are
  // read from the tile before any is stored, each lane takes two frames and
  // stores them as one 4-byte pair (a row of T = 643 frames starts at either
  // parity: with an odd start, lane 0 stores frame 0 alone and lane 31 frame
  // 63 besides its pair); the stats are summed across the warp.
  const int n_valid = min(SEG, p.n_time - t0);
  constexpr int GROUP = 4;
  for (int item0 = warp; item0 < BM * NB; item0 += GROUP * WARPS) {
    bf16* dst[GROUP];
    float* st[GROUP];
    int odd[GROUP];
    float v[GROUP][3], w[GROUP][3];  // this lane's frames 2 lane - odd + (0, 1), and 63
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const int item = item0 + g * WARPS;
      const int r = item / NB;
      const int seg = item - r * NB;
      const int b = bg * NB + seg;
      const int half = r / HROWS;      // kPair: the output row's parity
      const int rr = r - half * HROWS;  // its tile row within the half
      const int co = r < BM ? out_channel<HROWS>(rr, m_tile, c_half) : -1;
      const int fo = kPair ? 2 * row + half : row;
      dst[g] = nullptr;
      odd[g] = 0;
      if (co < 0 || b >= p.batch) continue;
      const long long out_row_index = (static_cast<long long>(b) * p.f_out + fo) * p.c2out + co;
      if constexpr (kGrad) {
        dst[g] = out_row(p, b, fo, co, c_half) + t0;
      } else {
        dst[g] = p.y + out_row_index * p.n_time + t0;
        st[g] = p.stats + out_row_index * 8;
      }
      odd[g] = static_cast<int>((reinterpret_cast<uintptr_t>(dst[g]) >> 1) & 1);
      const int f = 2 * lane - odd[g];
      const float* row = ct + r * C::CPITCH + seg * SEG;
      v[g][0] = row[max(f, 0)];
      v[g][1] = row[f + 1];
      v[g][2] = row[SEG - 1];
      if constexpr (!kGrad) {
        const int pr = rr < HROWS / 2 ? rr + HROWS / 2 : rr - HROWS / 2;
        const float* prow = ct + (half * HROWS + pr) * C::CPITCH + seg * SEG;
        const float br = p.bias[co];
        const float bp = p.bias[out_channel<HROWS>(pr, m_tile, c_half)];
#pragma unroll
        for (int k = 0; k < 3; ++k) v[g][k] += br;
        w[g][0] = prow[max(f, 0)] + bp;
        w[g][1] = prow[f + 1] + bp;
        w[g][2] = prow[SEG - 1] + bp;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (dst[g] == nullptr) continue;  // the same for the whole warp
      const int f = 2 * lane - odd[g];
      const bool ok0 = f >= 0 && f < n_valid, ok1 = f + 1 < n_valid;
      const bool ok63 = odd[g] && lane == 31 && SEG - 1 < n_valid;
      if (ok0 && ok1) {
        *reinterpret_cast<__nv_bfloat162*>(dst[g] + f) = __floats2bfloat162_rn(v[g][0], v[g][1]);
      } else {
        if (ok0) dst[g][f] = __float2bfloat16(v[g][0]);
        if (ok1) dst[g][f + 1] = __float2bfloat16(v[g][1]);
      }
      if (ok63) dst[g][SEG - 1] = __float2bfloat16(v[g][2]);
      if constexpr (!kGrad) {
        if (p.stats == nullptr) continue;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const bool ok = k == 0 ? ok0 : k == 1 ? ok1 : ok63;
          const float x = ok ? v[g][k] : 0.f;
          s0 += x;
          s1 += x * x;
          s2 += x * w[g][k];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (lane == 0) {
          atomicAdd(st[g], s0);
          atomicAdd(st[g] + 1, s1);
          atomicAdd(st[g] + 2, s2);
        }
      }
    }
  }
  // -- end --
}

template <bool kDecoder, bool kGrad, bool kPair, class C>
int launch_cfg(Params p, cudaStream_t stream) {
  constexpr int channels = kPair ? C::BM / 4 : C::BM / 2;  // complex channels a tile
  p.m_tiles = (p.c2out / 2 + channels - 1) / channels;
  p.b_groups = (p.batch + C::NB - 1) / C::NB;
  const long long z = static_cast<long long>(p.b_groups) * p.m_tiles;
  if (z > 65535 || p.f_out > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // the forward's coefficients of both regions follow the stages
  const int coef_bytes =
      kGrad ? 0 : 4 * (3 * p.reg[0].c2 + 1 + (p.n_reg > 1 ? 3 * p.reg[1].c2 + 1 : 0));
  const int smem = max(C::STAGES_BYTES + coef_bytes, C::TILE_BYTES);
  auto kernel = mma_kernel<kDecoder, kGrad, kPair, C>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_time + SEG - 1) / SEG, kPair ? p.f_out / 2 : p.f_out,
                  static_cast<unsigned>(z));
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDecoder, bool kGrad, bool kPair>
int launch_tile(const Params& p, int bm, int nb, cudaStream_t stream) {
  if (bm == 128 && nb == 2) return launch_cfg<kDecoder, kGrad, kPair, Cfg<128, 2, 2>>(p, stream);
  if (bm == 64 && nb == 2) return launch_cfg<kDecoder, kGrad, kPair, Cfg<64, 2, 2>>(p, stream);
  if (bm == 32 && nb == 4) return launch_cfg<kDecoder, kGrad, kPair, Cfg<32, 4, 1>>(p, stream);
  if (bm == 16 && nb == 4) return launch_cfg<kDecoder, kGrad, kPair, Cfg<16, 4, 1>>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the tile (bm, nb) the caller chose (kernels/conv_block.py:
// block_tile) and packed the weights for: 128 x 2, 64 x 2, 32 x 4 or 16 x 4
// (tile rows x 64-frame segments), and with pair output row pairs (the
// tile's halves; every variant but the decoder's input gradient, row 7).
// The caller checked the shapes.
template <bool kDecoder, bool kGrad>
int launch(const Params& p, int bm, int nb, bool pair, cudaStream_t stream) {
  if constexpr (kDecoder || !kGrad) {
    if (pair) {
      if (p.f_out % 2 != 0 || (kDecoder && p.f_out != 2 * p.f_in))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_tile<kDecoder, kGrad, true>(p, bm, nb, stream);
    }
  }
  if (pair) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile<kDecoder, kGrad, false>(p, bm, nb, stream);
}

}  // namespace blockmma
