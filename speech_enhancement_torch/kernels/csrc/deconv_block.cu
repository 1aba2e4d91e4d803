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
// Design. bf16 runs block_mma.cuh's mma_kernel (block_gemm.cuh's launch
// sends it there): a block computes BM output channels x 64 frames of NB
// batch items, so every staged weight step serves NB x 64 columns; K walks
// the trunk's and the skip's channels as two regions, tap by live tap, in
// k16 steps of eight complex pairs interleaved (real, imaginary), so one
// 16-byte load of each row of a pair feeds the folded CBN and PReLU of
// both halves in registers, with the step's coefficients read once from
// shared memory; two stages, one barrier a stage, weights by cp.async,
// fragments by ldmatrix, mma.sync. dec2 to dec5 take row-pair blocks
// (output rows 2r and 2r + 1 from one staging of input rows r - 1 to r + 1;
// kernels/conv_block.py: block_pair). The tile per block comes from the
// wrapper (block_tile, rows of both halves with pairs): 128 x 2 for dec0,
// dec1 and dec2, 64 x 2 for dec3, 32 x 4 for dec4, 16 x 4 for dec5. f32
// (the small f32 model only) runs block_gemm.cuh's first design,
// block_kernel.
// Even output rows take taps jf = 0, 2, 4, odd rows 1, 3 (the two parity
// classes of the stride-2 transpose); time tap jt reads frame t + jt. The
// weights arrive re-laid out by the wrapper from the lax.conv_transpose
// HWIO kernel, split into the trunk's and the skip's input channels. The
// TPU kernel's parity bands (`_parity_band`, `_pick_g_parity`) are not
// carried over.
//
// Where the time goes (tools/block_phase_probe.py, PERF.md section 6):
// the first design spent 69 to 84% of a block staging its tiles element
// by element. This one stages 2 TB/s on dec0 and dec1, where the products
// (their mma.sync issue and the tail that drains into the epilogue) take
// about three quarters of a block and the staging without them 70%
// (`--variant no-products`): the two overlap only in part. The small
// blocks are bound by each stage's load latency, which few products
// cover; row pairs cut their stages.
//
// ptxas (sm_90a, the bf16 tiles 16 x 4 / 32 x 4 / 64 x 2 / 128 x 2): 122 /
// 116 / 114 / 123 registers, with row pairs 128 / 127 / 124 / 127 (two
// blocks an SM), no spills; dynamic shared memory up to 47.5 / 53.4 / 44.4
// / 69.6 KB. The f32 variants (block_kernel) 80 to 255 registers with
// spills of up to 36 bytes (used only by the small f32 model).

#include "block_gemm.cuh"
#include "common.cuh"

namespace {

template <typename T>
int run(const void* x, const void* coef_x, const void* w_x, int c2x, int kp_x,
        const void* s, const void* coef_s, const void* w_s, int c2s, int kp_s,
        const void* bias, void* y, void* stats, int batch, int f_in, int c2out, int n_time,
        int bm, int nb, int pair, void* stream) {
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
  p.bm = bm;
  p.nb = nb;
  p.pair = pair;
  return blockgemm::launch<T, true>(p, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x [batch, f_in * c2x, T] and s [batch, f_in * c2s, T] (bf16 if is_bf16,
// else f32); coef_x / coef_s [3 * c2 + 1] f32; w_x / w_s in x's type: bf16
// [m_tiles, 5, kp / 16, 2, bm, 16] packed for block_mma.cuh's tile (bm, nb),
// or with pair [m_tiles, 3, kp / 16, 2, bm, 16] (the tile's halves the even
// and odd output rows of a pair, taps by input row), kp = 16 ceil(c2 / 16)
// (pair-interleaved channels); f32 [5, 2, c2out, kp] (bm, nb, pair unused); bias [c2out] f32; y like x with 2 f_in rows of c2out;
// stats [batch, 2 f_in * c2out, 8] f32, zeroed, or null. All contiguous on
// the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int deconv_block(int is_bf16, const void* x, const void* coef_x, const void* w_x,
                            int c2x, int kp_x, const void* s, const void* coef_s,
                            const void* w_s, int c2s, int kp_s, const void* bias, void* y,
                            void* stats, int batch, int f_in, int c2out, int n_time, int bm,
                            int nb, int pair, void* stream) {
  if (is_bf16)
    return run<__nv_bfloat16>(x, coef_x, w_x, c2x, kp_x, s, coef_s, w_s, c2s, kp_s, bias, y,
                              stats, batch, f_in, c2out, n_time, bm, nb, pair, stream);
  return run<float>(x, coef_x, w_x, c2x, kp_x, s, coef_s, w_s, c2s, kp_s, bias, y, stats,
                    batch, f_in, c2out, n_time, bm, nb, pair, stream);
}
