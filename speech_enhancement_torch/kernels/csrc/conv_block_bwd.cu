// Backward of the fused DCCRN encoder block for Hopper (sm_90a): the input
// gradient and the weight gradient of its complex conv.
//
// Replaces: speech_enhancement_tpu/ops/pallas/experimental/conv_block.py,
// `_enc_bwd_gz` / `_enc_bwd_gz_kernel` and `_enc_bwd_dw` /
// `_enc_bwd_dw_kernel` (the Pallas TPU kernels of `conv_block_train`'s
// custom VJP).
//
// enc_bwd_gz: for the output gradient g [B, f_in/2 * C2out, T] and the
//   block's HWIO weights W [5, 2, C2in, C2out],
//     g_z[fi, ci, t] = sum over jf with fi + jf even, jt of
//                      W[jf, jt, ci, co] g[(fi + 2 - jf) / 2, co, t + 1 - jt]
//   (g = 0 at frame T) -> [B, f_in * C2in, T]: a stride-2 transposed conv
//   over frequency, the causal shift reversed in time. With the taps
//   reindexed jf' = 4 - jf, jt' = 1 - jt it is exactly the decoder block's
//   forward indexing, run on g as it is (no pointwise, no bias, no stats,
//   one output). bf16 runs block_mma.cuh's mma_kernel (the decoder
//   indexing, kGrad; weights reused across NB batch items, K in k16 steps
//   of eight interleaved complex pairs of g, 16-byte staging realigned in
//   registers, two stages with one barrier a stage, cp.async weights,
//   ldmatrix and mma.sync) on the wrapper's weights W[4 - jf', 1 - jt']
//   packed for its tile (kernels/conv_block.py: block_tile, block_pair over
//   the C2in output channels): enc0 to enc3 compute output rows 2r and 2r
//   + 1 in one block from one staging of g's rows r - 1 .. r + 1 (row
//   pairs; tiles 16 x 4, 32 x 4, 64 x 2, 128 x 2), enc4 and enc5 one row a
//   block on 128 x 2; f32 block_gemm.cuh's block_kernel on [5, 2, C2in,
//   C2out padded to 16].
// enc_bwd_dw: for the recomputed activated input z [B, f_in * C2in, T]
//   and g, dW[jf, jt] = sum over (b, fo, t) of z[2 fo + jf - 2, t - 1 + jt]
//   g[fo, t]^T, as split-K partials [S, 5, 2, C2in, C2out] f32 that the
//   wrapper sums (dw_gemm.cuh: in bf16 one GEMM whose rows are the five
//   input rows an output row reads, the taps).
//
// What bounds them on an H100 (B = 128 windows, T = 643 frames, bf16; the
// FLOPs are the forward's, 2 * B * T * C2out * 2 * C2in per live (output
// row, frequency tap) pair, against 989 TFLOP/s; bytes of each input read
// once and each output written once against 3.35 TB/s): both gradients of
// enc0 to enc2 are bound by bytes (0.126, 0.201, 0.201 ms), of enc3 to enc5
// by operations (0.210, 0.404, 0.371 ms); 1.513 ms for each of the two
// kernels over the six blocks. chip_smoke.py computes each bound from the
// shapes and prints it beside the kernel's time.
//
// Rounding, as the JAX kernels: g and the weights in the activation type,
// f32 accumulation, g_z stored in the activation type, dW in f32.
//
// Where the input gradient's time goes (tools/block_phase_probe.py --rows
// enc_gz, PERF.md section 6): enc3 to enc5 stage about 1.8 to 2.2 TB/s,
// products and stores 47% of a block; on enc0 to enc2 the epilogue takes
// 40 to 55%, its global stores 1 to 3% (--variant no-epistore).
//
// ptxas (sm_90a): the weight-gradient kernels' reports are in PERF.md; the
// bf16 input gradient's tiles 16 x 4 / 32 x 4 / 64 x 2 / 128 x 2, 118 / 109
// / 115 / 126 registers, with row pairs 127 / 124 / 121 / 128 (two blocks
// an SM), no spills; dynamic shared memory 46.7 / 51.8 / 41.3 / 69.6 KB.
// The f32 variants of block_kernel up to 255 registers with 40 bytes of
// spills at height 128 (used only by the small f32 model). chip_smoke.py
// logs the report of each build.

#include "block_gemm.cuh"
#include "common.cuh"
#include "dw_gemm.cuh"

namespace {

template <typename T>
int run_gz(const void* gy, const void* w, int c2out, int kp, void* gz, int batch, int f_in,
           int c2in, int n_time, int bm, int nb, int pair, void* stream) {
  if (f_in % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  blockgemm::Params p{};
  p.reg[0] = {gy, nullptr, w, c2out, kp};
  p.n_reg = 1;
  p.y = gz;
  p.f_in = f_in / 2;  // the rows of g
  p.f_out = f_in;     // the rows of g_z
  p.c2out = c2in;
  p.n_time = n_time;
  p.bm = bm;
  p.nb = nb;
  p.pair = pair;
  return blockgemm::launch<T, true, true>(p, batch, static_cast<cudaStream_t>(stream));
}

template <typename T>
int run_dw(const void* z, const void* gy, void* part, int splits, int bm, int bn, int batch,
           int f_in, int c2in, int c2out, int n_time, void* stream) {
  if (f_in % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  dwgemm::Params p{};
  p.reg[0] = {z, c2in, 0};
  p.n_reg = 1;
  p.g = gy;
  p.part = static_cast<float*>(part);
  p.batch = batch;
  p.f_in = f_in;
  p.f_out = f_in / 2;
  p.c2out = c2out;
  p.c2tot = c2in;
  p.n_time = n_time;
  p.splits = splits;
  return dwgemm::launch<T, false>(p, bm, bn, static_cast<cudaStream_t>(stream));
}

}  // namespace

// gy [batch, f_in / 2 * c2out, T] (bf16 if is_bf16, else f32); w in gy's
// type, the flipped, transposed weights: bf16 [m_tiles, 5, kp / 16, 2, bm,
// 16] packed for block_mma.cuh's tile (bm, nb) over the c2in output
// channels, or with pair [m_tiles, 3, kp / 16, 2, bm, 16] (output rows 2r
// and 2r + 1 a block, taps by row of g), kp = 16 ceil(c2out / 16)
// (pair-interleaved channels of g), f32 [5, 2, c2in, kp] zero past c2out
// (bm, nb, pair unused); gz [batch, f_in * c2in, T] in gy's type. All
// contiguous on the current device. Launches on `stream`, returns
// cudaGetLastError().
extern "C" int enc_bwd_gz(int is_bf16, const void* gy, const void* w, int c2out, int kp,
                          void* gz, int batch, int f_in, int c2in, int n_time, int bm, int nb,
                          int pair, void* stream) {
  if (is_bf16)
    return run_gz<__nv_bfloat16>(gy, w, c2out, kp, gz, batch, f_in, c2in, n_time, bm, nb, pair,
                                 stream);
  return run_gz<float>(gy, w, c2out, kp, gz, batch, f_in, c2in, n_time, bm, nb, pair, stream);
}

// z [batch, f_in * c2in, T] and gy [batch, f_in / 2 * c2out, T] of one type
// (bf16 if is_bf16, else f32); part [splits, 5, 2, c2in, c2out] f32, every
// element written; (bm, bn) the channel tile (dw_gemm.cuh: launch).
extern "C" int enc_bwd_dw(int is_bf16, const void* z, const void* gy, void* part, int splits,
                          int bm, int bn, int batch, int f_in, int c2in, int c2out, int n_time,
                          void* stream) {
  if (is_bf16)
    return run_dw<__nv_bfloat16>(z, gy, part, splits, bm, bn, batch, f_in, c2in, c2out, n_time,
                                 stream);
  return run_dw<float>(z, gy, part, splits, bm, bn, batch, f_in, c2in, c2out, n_time, stream);
}
