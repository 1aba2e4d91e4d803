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
// ptxas (sm_90a, bf16 variants by tile height 16 / 32 / 64 / 128 rows):
// 64 / 76 / 80 / 128 registers, 4.6 / 8.3 / 16.6 / 33.3 KB shared memory,
// no spills but 8 bytes at height 16; the f32 variants 80 to 255 registers
// with spills of up to 36 bytes (used only by the small f32 model).
//
// Design: the implicit GEMM of block_gemm.cuh with one input region; taps
// jf = 0..4 read input row fi = 2 fo + jf - 2 (rows outside [0, f_in) are
// skipped: the freq zero pad), time tap jt reads frame t - 1 + jt (frame -1
// stages as zero: the causal pad). The TPU kernel's banded weight matrices
// and group size (`_stride_band`, `_pick_g_stride`) exist for the MXU's
// fixed cost per matmul and are not carried over.

#include "block_gemm.cuh"
#include "common.cuh"

namespace {

template <typename T>
int run(const void* x, const void* coef, const void* w, int c2in, int kp, const void* bias,
        void* y, void* stats, int batch, int f_in, int c2out, int n_time, void* stream) {
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
  if (f_in % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return blockgemm::launch<T, false>(p, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x [batch, f_in * c2in, T] (bf16 if is_bf16, else f32); coef [3 * c2in + 1]
// f32; w [5, 2, c2out, kp] in x's type; bias [c2out] f32; y like x with
// f_in / 2 rows of c2out; stats [batch, f_in / 2 * c2out, 8] f32, zeroed,
// or null. All contiguous on the current device. Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int conv_block(int is_bf16, const void* x, const void* coef, const void* w,
                          int c2in, int kp, const void* bias, void* y, void* stats,
                          int batch, int f_in, int c2out, int n_time, void* stream) {
  if (is_bf16)
    return run<__nv_bfloat16>(x, coef, w, c2in, kp, bias, y, stats, batch, f_in, c2out,
                              n_time, stream);
  return run<float>(x, coef, w, c2in, kp, bias, y, stats, batch, f_in, c2out, n_time,
                    stream);
}
