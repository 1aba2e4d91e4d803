// Backward of the fused DCCRN decoder block for Hopper (sm_90a): the input
// gradients of the trunk and the skip, and the weight gradient of its
// transposed complex conv.
//
// Replaces: speech_enhancement_tpu/ops/pallas/experimental/conv_block.py,
// `_dec_bwd_gz` / `_dec_bwd_gz_kernel` and `_dec_bwd_dw` /
// `_dec_bwd_dw_kernel` (the Pallas TPU kernels of `deconv_block_train`'s
// custom VJP).
//
// dec_bwd_gz: for the output gradient g [B, 2 f_in * C2out, T] and the
//   block's HWIO weights W [5, 2, C2x + C2s, C2out] (joined input order
//   [xr, sr, xi, si]),
//     g_z[fi, cj, t] = sum over jf, jt of W[jf, jt, cj, co] g[2 fi + 2 - jf, co, t - jt]
//   (g = 0 at frame -1 and outside the rows): every input row sees all 5
//   taps at stride 2, the encoder's forward indexing once the taps are
//   reindexed jf' = 4 - jf, jt' = 1 - jt. It runs the implicit GEMM on g
//   as it is (the encoder indexing, kGrad), with the weights W[4 - jf',
//   1 - jt'] transposed (C2x + C2s rows over C2out channels), and its
//   epilogue splits the joined channels into g_zx [B, f_in * C2x, T] and
//   g_zs [B, f_in * C2s, T]; the joined gradient is never stored. bf16
//   runs block_mma.cuh's mma_kernel (weights reused across NB batch items,
//   K in k16 steps of eight interleaved complex pairs of g, 16-byte staging
//   realigned in registers, two stages with one barrier a stage, cp.async
//   weights, ldmatrix and mma.sync; tiles 128 x 2 for dec0 to dec3, 64 x 2
//   for dec4, 32 x 4 for dec5, from kernels/conv_block.py: block_tile); f32
//   block_gemm.cuh's block_kernel.
// dec_bwd_dw: for the recomputed activated inputs z_x, z_s and g, dW[jf,
//   jt] = sum over (b, fo with fo + jf even, t) of z[(fo + jf - 2) / 2,
//   t + jt] g[fo, t]^T, both regions in one launch, as split-K partials
//   [S, 5, 2, C2x + C2s, C2out] f32 with the trunk's channels first and the
//   skip's after them; the wrapper sums the partials and puts the rows in
//   the joined order [xr, sr, xi, si] (dw_gemm.cuh: in bf16 four GEMMs,
//   trunk and skip by even and odd output rows, whose rows are the three
//   or two input rows an output row reads, the taps).
//
// What bounds them on an H100 (B = 128, T = 643, bf16; FLOPs as the
// forward's, 2.5 live taps per output row on average, against 989 TFLOP/s;
// bytes of each input read once and each output written once against
// 3.35 TB/s): both gradients of dec0 to dec2 are bound by operations
// (0.742, 0.807, 0.420 ms), of dec3 to dec5 by bytes (0.302, 0.302, 0.226
// ms); 2.799 ms for each of the two kernels over the six blocks.
// chip_smoke.py computes each bound from the shapes and prints it beside
// the kernel's time.
//
// Rounding, as the JAX kernels: g and the weights in the activation type,
// f32 accumulation, g_zx and g_zs stored in the activation type, dW in f32.
//
// What the input gradient's time goes to (tools/block_phase_probe.py,
// PERF.md section 6): dec0 to dec2 stage about 2 TB/s with the products
// taking three quarters of a block; dec4 and dec5, with a K of 16 and 2
// channels a tap, wait out each stage's load latency.
//
// ptxas (sm_90a, this source and its decoder/encoder twin): the weight-
// gradient kernels' reports are in PERF.md; the bf16 input gradient's tiles
// 16 x 4 / 32 x 4 / 64 x 2 / 128 x 2, 128 / 126 / 107 / 127 registers (two
// blocks an SM), no spills; the f32 variants of block_kernel up to 255
// registers with 40 bytes of spills at height 128 (used only by the small
// f32 model). chip_smoke.py logs the report of each build.

#include "block_gemm.cuh"
#include "common.cuh"
#include "dw_gemm.cuh"

namespace {

template <typename T>
int run_gz(const void* gy, const void* w, int c2out, int kp, void* gzx, int c2x, void* gzs,
           int c2s, int batch, int f_in, int n_time, int bm, int nb, void* stream) {
  blockgemm::Params p{};
  p.reg[0] = {gy, nullptr, w, c2out, kp};
  p.n_reg = 1;
  p.y = gzx;
  p.y2 = gzs;
  p.c2a = c2x;
  p.f_in = 2 * f_in;  // the rows of g
  p.f_out = f_in;     // the rows of g_zx and g_zs
  p.c2out = c2x + c2s;
  p.n_time = n_time;
  p.bm = bm;
  p.nb = nb;
  return blockgemm::launch<T, false, true>(p, batch, static_cast<cudaStream_t>(stream));
}

template <typename T>
int run_dw(const void* zx, int c2x, const void* zs, int c2s, const void* gy, void* part,
           int splits, int bm, int bn, int batch, int f_in, int c2out, int n_time,
           void* stream) {
  dwgemm::Params p{};
  p.reg[0] = {zx, c2x, 0};
  p.reg[1] = {zs, c2s, c2x};
  p.n_reg = 2;
  p.g = gy;
  p.part = static_cast<float*>(part);
  p.batch = batch;
  p.f_in = f_in;
  p.f_out = 2 * f_in;
  p.c2out = c2out;
  p.c2tot = c2x + c2s;
  p.n_time = n_time;
  p.splits = splits;
  return dwgemm::launch<T, true>(p, bm, bn, static_cast<cudaStream_t>(stream));
}

}  // namespace

// gy [batch, 2 f_in * c2out, T] (bf16 if is_bf16, else f32); w in gy's
// type, the taps flipped and transposed, output rows in the joined order:
// bf16 [m_tiles, 5, kp / 16, 2, bm, 16] packed for block_mma.cuh's tile (bm,
// nb), kp = 16 ceil(c2out / 16) (pair-interleaved channels of g), f32 [5, 2,
// c2x + c2s, kp] zero past c2out (bm, nb unused); gzx [batch, f_in * c2x, T]
// and gzs [batch, f_in * c2s, T] in gy's type. All contiguous on the current
// device. Launches on `stream`, returns cudaGetLastError().
extern "C" int dec_bwd_gz(int is_bf16, const void* gy, const void* w, int c2out, int kp,
                          void* gzx, int c2x, void* gzs, int c2s, int batch, int f_in,
                          int n_time, int bm, int nb, void* stream) {
  if (is_bf16)
    return run_gz<__nv_bfloat16>(gy, w, c2out, kp, gzx, c2x, gzs, c2s, batch, f_in, n_time,
                                 bm, nb, stream);
  return run_gz<float>(gy, w, c2out, kp, gzx, c2x, gzs, c2s, batch, f_in, n_time, bm, nb,
                       stream);
}

// zx [batch, f_in * c2x, T], zs [batch, f_in * c2s, T] and gy [batch, 2 f_in
// * c2out, T] of one type (bf16 if is_bf16, else f32); part [splits, 5, 2,
// c2x + c2s, c2out] f32, every element written, trunk rows then skip rows;
// (bm, bn) the channel tile (dw_gemm.cuh: launch).
extern "C" int dec_bwd_dw(int is_bf16, const void* zx, int c2x, const void* zs, int c2s,
                          const void* gy, void* part, int splits, int bm, int bn, int batch,
                          int f_in, int c2out, int n_time, void* stream) {
  if (is_bf16)
    return run_dw<__nv_bfloat16>(zx, c2x, zs, c2s, gy, part, splits, bm, bn, batch, f_in,
                                 c2out, n_time, stream);
  return run_dw<float>(zx, c2x, zs, c2s, gy, part, splits, bm, bn, batch, f_in, c2out, n_time,
                       stream);
}
