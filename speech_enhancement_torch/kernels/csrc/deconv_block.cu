// Fused DCCRN decoder block for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/experimental/conv_block.py,
// `fused_deconv_block` / `_dec_kernel` (the Pallas TPU kernel).
//
// Computes, per batch item, for the trunk x [B, f_in * C2x, T] and the skip
// s [B, f_in * C2s, T] (raw conv outputs):
//   zx = PReLU_x(folded CBN_x(x)),  zs = PReLU_s(folded CBN_s(s))
//   y  = complex transposed conv of the join [zx_r, zs_r, zx_i, zs_i],
//        k = (5, 2), stride (2, 1), freq crop [2:-1], time chomp [1:], + bias
//        ->  [B, 2 f_in * C2out, T]
//   i.e. y[fo, t] = sum over jf with fo + jf even, jt of
//        W[jf, jt] z[(fo + jf - 2) / 2, t + jt], with z[., T] = 0,
// and, with stats, the per-row partials [B, R_out, 8] f32. Neither the
// activated inputs nor the joined tensor is ever stored, not even in shared
// memory: trunk and skip are two regions of the K loop, each with its own
// coefficients, PReLU slope and slice of the weights.
//
// What bounds it on an H100 (B = 192, T = 643, bf16; FLOPs 2 * B * T *
// C2out * 2 * (C2x + C2s) per live (output row, frequency tap) pair, 2.5
// taps per output row on average, against 989 TFLOP/s; bytes of x, s and y
// once against 3.35 TB/s): dec0 256 + 256 -> 256, dec1 256 + 256 -> 128 and
// dec2 128 + 128 -> 64 are bound by operations (1.113, 1.211, 0.630 ms),
// dec3 64 + 64 -> 32, dec4 32 + 32 -> 16 and dec5 16 + 16 -> 2 by bytes
// (0.453, 0.453, 0.340 ms). chip_smoke.py computes these from the shapes.
//
// ptxas (sm_90a, bf16 variants by tile height 16 / 32 / 64 / 128 rows):
// 76 / 76 / 80 / 126 registers, 4.6 / 8.3 / 16.6 / 33.3 KB shared memory,
// no spills; the f32 variants 80 to 255 registers with spills of up to 36
// bytes (used only by the small f32 model).
//
// Design: the implicit GEMM of block_gemm.cuh with two input regions. Even
// output rows take taps jf = 0, 2, 4, odd rows 1, 3 (the two parity classes
// of the stride-2 transpose); time tap jt reads frame t + jt. The weights
// arrive re-laid out by the wrapper (kernels/conv_block.py) from the
// lax.conv_transpose HWIO kernel, split into the trunk's and the skip's
// input channels. The TPU kernel's parity bands (`_parity_band`,
// `_pick_g_parity`) are not carried over.

#include "block_gemm.cuh"
#include "common.cuh"

namespace {

template <typename T>
int run(const void* x, const void* coef_x, const void* w_x, int c2x, int kp_x,
        const void* s, const void* coef_s, const void* w_s, int c2s, int kp_s,
        const void* bias, void* y, void* stats, int batch, int f_in, int c2out, int n_time,
        void* stream) {
  blockgemm::Params p{};
  p.reg[0] = {x, static_cast<const float*>(coef_x), w_x, c2x, kp_x};
  p.reg[1] = {s, static_cast<const float*>(coef_s), w_s, c2s, kp_s};
  p.n_reg = 2;
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.stats = static_cast<float*>(stats);
  p.f_in = f_in;
  p.f_out = 2 * f_in;
  p.c2out = c2out;
  p.n_time = n_time;
  return blockgemm::launch<T, true>(p, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x [batch, f_in * c2x, T] and s [batch, f_in * c2s, T] (bf16 if is_bf16,
// else f32); coef_x / coef_s [3 * c2 + 1] f32; w_x / w_s [5, 2, c2out, kp]
// in x's type; bias [c2out] f32; y like x with 2 f_in rows of c2out; stats
// [batch, 2 f_in * c2out, 8] f32, zeroed, or null. All contiguous on the
// current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int deconv_block(int is_bf16, const void* x, const void* coef_x, const void* w_x,
                            int c2x, int kp_x, const void* s, const void* coef_s,
                            const void* w_s, int c2s, int kp_s, const void* bias, void* y,
                            void* stats, int batch, int f_in, int c2out, int n_time,
                            void* stream) {
  if (is_bf16)
    return run<__nv_bfloat16>(x, coef_x, w_x, c2x, kp_x, s, coef_s, w_s, c2s, kp_s, bias, y,
                              stats, batch, f_in, c2out, n_time, stream);
  return run<float>(x, coef_x, w_x, c2x, kp_x, s, coef_s, w_s, c2s, kp_s, bias, y, stats,
                    batch, f_in, c2out, n_time, stream);
}
