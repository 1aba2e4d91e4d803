// Fused DCCRN encoder block for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/experimental/conv_block.py,
// `fused_conv_block` / `_enc_kernel` (the Pallas TPU kernel).
//
// Computes, per batch item, for x [B, f_in * C2in, T] (the previous block's
// raw conv output, or the spectrogram):
//   z = PReLU(a_diag * x + a_cross * partner(x) + c0)    (folded complex BN)
//   y = complex conv of z, k = (5, 2), stride (2, 1), freq pad (2, 2),
//       causal time pad (1, 0), + bias  ->  [B, f_in/2 * C2out, T]
// and, with stats, per-row partials (sum y, sum y^2, sum y*partner, 0...)
// [B, R_out, 8] f32 for the complex-BN batch moments. The activated input
// z is never stored in device memory.
//
// What bounds it on an H100 (B = 192 windows, T = 643 frames, bf16; FLOPs
// 2 * B * T * C2out * 2 * C2in per live (output row, frequency tap) pair,
// against 989 TFLOP/s; bytes of x and y once against 3.35 TB/s): enc0
// 2 -> 16 channels, enc1 16 -> 32 and enc2 32 -> 64 are bound by bytes
// (0.189, 0.302, 0.302 ms), enc3 64 -> 128, enc4 128 -> 256 and enc5
// 256 -> 256 by operations (0.315, 0.605, 0.556 ms). chip_smoke.py computes
// these from the shapes.
//
// Design. bf16 runs block_mma.cuh's mma_kernel (block_gemm.cuh's launch
// sends it there) on the encoder indexing: taps jf = 0..4 read input row fi
// = 2 fo + jf - 2 (rows outside [0, f_in) are skipped: the freq zero pad),
// time tap jt reads frame t - 1 + jt, so every segment stages frames from
// t0 - 1, and frame -1 is zeroed after the folded CBN and PReLU (which do
// not map zero to zero): the causal pad. A block computes BM output
// channels x 64 frames of NB batch items; K walks the live taps in k16
// steps of eight complex pairs interleaved (real, imaginary): enc0's one
// input pair fills one of a step's eight slots, the rest stage as zeros
// against zero weights. The tile comes from the wrapper
// (kernels/conv_block.py: block_tile, block_pair): enc0 to enc2 compute
// output rows 2r and 2r + 1 in one block from one staging of the seven
// input rows 4r - 2 .. 4r + 4 they read (row pairs; tiles 32 x 4, 64 x 2
// and 128 x 2 over both rows' channels), enc3 to enc5 one row a block on
// 128 x 2. The stats epilogue sums each (row, segment) across a warp and
// adds it into [B, R_out, 8] with atomicAdd. f32 (the small f32 model
// only) runs block_gemm.cuh's first design, block_kernel. The TPU kernel's
// banded weight matrices and group size (`_stride_band`, `_pick_g_stride`)
// exist for the MXU's fixed cost per matmul and are not carried over.
//
// Where the time goes (tools/block_phase_probe.py --rows enc_fwd, PERF.md
// section 6): enc4 and enc5 issue loads 19 to 22% of a block, products and
// stores 46 to 54%; on enc0 to enc3 the epilogue (the last stage's
// products draining, the f32 tile, the stats) takes 47 to 59%, of which
// the global stores and stats are 1 to 4% (--variant no-epistore).
//
// ptxas (sm_90a, the bf16 tiles 16 x 4 / 32 x 4 / 64 x 2 / 128 x 2): 125 /
// 127 / 127 / 126 registers, with row pairs 122 / 128 / 122 / 126 (two
// blocks an SM), no spills; dynamic shared memory 46.7 to 49.8 / 51.8 to
// 54.9 / 41.3 to 44.4 / 69.6 KB (the stages and the input coefficients, or
// the f32 tile). The f32 variants (block_kernel) 74 to 255 registers with
// spills of up to 36 bytes (used only by the small f32 model).

#include "block_gemm.cuh"
#include "common.cuh"

namespace {

template <typename T>
int run(const void* x, const void* coef, const void* w, int c2in, int kp, const void* bias,
        void* y, void* stats, int batch, int f_in, int c2out, int n_time, int bm, int nb,
        int pair, void* stream) {
  blockgemm::Params p{};
  p.reg[0] = {x, static_cast<const float*>(coef), w, c2in, kp};
  p.n_reg = 1;
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.stats = static_cast<float*>(stats);
  p.f_in = f_in;
  p.f_out = f_in / 2;
  p.c2out = c2out;
  p.n_time = n_time;
  p.bm = bm;
  p.nb = nb;
  p.pair = pair;
  if (f_in % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return blockgemm::launch<T, false>(p, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x [batch, f_in * c2in, T] (bf16 if is_bf16, else f32); coef [3 * c2in + 1]
// f32; w in x's type: bf16 [m_tiles, 5, kp / 16, 2, bm, 16] packed for
// block_mma.cuh's tile (bm, nb), or with pair [m_tiles, 7, kp / 16, 2, bm,
// 16] (the tile's halves the even and odd output rows of a pair, taps by
// input row), kp = 16 ceil(c2in / 16) (pair-interleaved channels), f32 [5,
// 2, c2out, kp] (bm, nb, pair unused); bias [c2out] f32; y like x with
// f_in / 2 rows of c2out; stats [batch, f_in / 2 * c2out, 8] f32, zeroed,
// or null. All contiguous on the current device. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int conv_block(int is_bf16, const void* x, const void* coef, const void* w,
                          int c2in, int kp, const void* bias, void* y, void* stats,
                          int batch, int f_in, int c2out, int n_time, int bm, int nb,
                          int pair, void* stream) {
  if (is_bf16)
    return run<__nv_bfloat16>(x, coef, w, c2in, kp, bias, y, stats, batch, f_in, c2out,
                              n_time, bm, nb, pair, stream);
  return run<float>(x, coef, w, c2in, kp, bias, y, stats, batch, f_in, c2out, n_time, bm, nb,
                    pair, stream);
}
