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
// spread over the card) bounds it, not the rates.
//
// Design (lstm.cuh): the TPU kernel holds the whole w_hh (25.7 MB in bf16
// at H 1792) in VMEM. Here it is split by hidden unit over one block per
// SM: a block owns U units and their four gate columns, 4U rows of w_hhᵀ
// (U 14: 56 x 1792 bf16 = 200,704 B of its 227 KB of shared memory), read
// from device memory once. Each step it multiplies its rows by the whole
// h_prev (from L2), and the gate math and the c update stay inside the
// block, with c carried in f32 in device memory that only this block
// touches. One grid barrier a step publishes h_t. A width whose slice does
// not fit (f32 beyond about 1250 units, or more than 16 units a block) is
// refused with cudaErrorCooperativeLaunchTooLarge rather than launched.

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

template <typename T>
int run(FwdArgs a, cudaStream_t stream) {
  const int sms = lstm::multiprocessors();
  const int units = sms > 0 ? lstm::units_per_block(a.hidden, sms) : 0;
  if (units == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const lstm::Plan p = lstm::make_plan(sizeof(T), units, 4 * units, a.hidden, a.batch);
  constexpr int V = 16 / sizeof(T);
  a.vec = a.hidden % V == 0 && reinterpret_cast<uintptr_t>(a.h0) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.hseq) % 16 == 0;
  const int blocks = (a.hidden + units - 1) / units;
  return lstm::launch(lstm_fwd_kernel<T>, a, p, blocks, stream);
}

}  // namespace

// The forward over all steps; returns cudaGetLastError() (or
// cudaErrorCooperativeLaunchTooLarge when the grid does not fit).
extern "C" int lstm_fwd(int is_bf16, const void* xp, const void* wt, const void* h0, float* c,
                        void* hseq, void* cseq, void* gates, unsigned int* bar, int steps,
                        int batch, int hidden, int reverse, cudaStream_t stream) {
  if (steps <= 0 || batch <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{xp, wt, h0, c, hseq, cseq, gates, bar, steps, batch, hidden, reverse, 0};
  return is_bf16 ? run<__nv_bfloat16>(a, stream) : run<float>(a, stream);
}
