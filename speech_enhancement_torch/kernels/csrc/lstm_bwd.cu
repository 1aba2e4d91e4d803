// The LSTM recurrence backward, one launch walking all T steps in reverse,
// for Hopper (sm_90a).
//
// Replaces: speech_enhancement_tpu/ops/pallas/lstm.py, `_lstm_bwd_call` /
// `_bwd_kernel` (the Pallas TPU kernel). Walking the forward's visit order
// backwards, per step t, with (dh, dc) carried in f32 from dh_T, dc_T:
//   dh  = dh + dout[t]
//   do  = dh * tanh(c[t]);   dc = dc + dh * o * (1 - tanh(c[t])^2)
//   di  = dc * g;  df = dc * c_prev[t];  dg = dc * i
//   dgates[t] = [di i (1-i), df f (1-f), dg (1-g^2), do o (1-o)]   (i/o type)
//   dh  = dgates[t] (as stored) @ w_hhᵀ   (f32 accumulation);  dc = dc * f
// and after the last step writes dh0 = dh, dc0 = dc. The gates and c are
// read in the i/o type, as the forward stored them. dw_hh = h_prevᵀ dgates
// is one large product outside the kernel (torch.matmul), as XLA does it in
// the JAX package.
//
// What bounds it on an H100: 2 B 4H H FLOPs a step, the forward's count:
// 0.206 TFLOP a layer at CRN's train shape (T 501, B 16, H 1792), 0.21 ms
// at 989 TFLOP/s; its bytes (gates, c, c_prev, dout in, dgates out, ~0.32
// GB) take 0.10 ms at 3.35 TB/s. As in the forward, the sequential steps'
// latency bounds it in practice.
//
// Design (lstm.cuh): as the forward, w_hh split by hidden unit of dh over
// one block per SM, resident in shared memory (U 14 rows of w_hh, 14 x 7168
// bf16 = 200,704 B). Each step the block first computes the pointwise part
// for its own units (it holds their dh and dc) and writes their dgates;
// one grid barrier publishes dgates[t]; then the block multiplies its rows
// by all of dgates[t] (K = 4H, from L2) for its units' next dh. dh and dc
// live in the f32 output arrays dh0 and dc0, which only the owning block
// touches, so one barrier a step suffices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "lstm.cuh"

namespace {

struct BwdArgs {
  const void* gates;  // [T, B, 4H] i, f, g, o
  const void* cseq;   // [T, B, H]
  const void* cprev;  // [T, B, H]: c of the step before in the visit order (c0 first)
  const void* dout;   // [T, B, H]: gradient of h_seq
  const void* w;      // w_hh [H, 4H]
  float* dh;          // [B, H] f32: dh_T in, dh0 out
  float* dc;          // [B, H] f32: dc_T in, dc0 out
  void* dgates;       // [T, B, 4H]
  unsigned int* bar;  // [2], zeroed
  int steps, batch, hidden, reverse, vec;
};

template <typename T>
__global__ void __launch_bounds__(lstm::THREADS)
    lstm_bwd_kernel(const BwdArgs a, const lstm::Plan p) {
  using namespace lstm;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);
  T* stage = reinterpret_cast<T*>(smem + p.stage_offset);
  float* out = reinterpret_cast<float*>(smem + p.out_offset);
  const T* gates = static_cast<const T*>(a.gates);
  const T* cseq = static_cast<const T*>(a.cseq);
  const T* cprev = static_cast<const T*>(a.cprev);
  const T* dout = static_cast<const T*>(a.dout);
  const T* w = static_cast<const T*>(a.w);
  T* dgates = static_cast<T*>(a.dgates);
  const int H = a.hidden, B = a.batch, U = p.units, G4 = 4 * H;
  const int j0 = blockIdx.x * U;

  // the block's slice: row u is w_hh row j0 + u (its 4H gate columns)
  for (long long idx = threadIdx.x; idx < static_cast<long long>(p.rows) * p.pitch;
       idx += THREADS) {
    const int r = static_cast<int>(idx / p.pitch);
    const int k = static_cast<int>(idx - static_cast<long long>(r) * p.pitch);
    ws[idx] = (j0 + r < H && k < G4) ? w[static_cast<long long>(j0 + r) * G4 + k]
                                     : from_f32<T>(0.f);
  }

  for (int s = 0; s < a.steps; ++s) {
    const int t = a.reverse ? s : a.steps - 1 - s;
    // the pointwise part for the block's own units
    for (int idx = threadIdx.x; idx < U * B; idx += THREADS) {
      const int b = idx / U;
      const int j = j0 + idx - b * U;
      if (j >= H) continue;
      const long long row = static_cast<long long>(t) * B + b;
      const T* gt = gates + row * G4 + j;
      const float i = to_f32(gt[0]);
      const float f = to_f32(gt[H]);
      const float g = to_f32(gt[2 * H]);
      const float o = to_f32(gt[3 * H]);
      const float tc = tanhf(to_f32(cseq[row * H + j]));
      float* dhp = a.dh + static_cast<long long>(b) * H + j;
      float* dcp = a.dc + static_cast<long long>(b) * H + j;
      const float dh = *dhp + to_f32(dout[row * H + j]);
      const float d_o = dh * tc;
      const float dc = *dcp + dh * o * (1.f - tc * tc);
      const float di = dc * g;
      const float df = dc * to_f32(cprev[row * H + j]);
      const float dg = dc * i;
      T* dgt = dgates + row * G4 + j;
      dgt[0] = from_f32<T>(di * i * (1.f - i));
      dgt[H] = from_f32<T>(df * f * (1.f - f));
      dgt[2 * H] = from_f32<T>(dg * (1.f - g * g));
      dgt[3 * H] = from_f32<T>(d_o * o * (1.f - o));
      *dcp = dc * f;
    }
    grid_sync(a.bar, gridDim.x);  // dgates[t] of every unit is written
    const T* src = dgates + static_cast<long long>(t) * B * G4;
    for (int n0 = 0; n0 < B; n0 += p.nb) {
      gemm_chunk<T>(p, ws, src, G4, B, n0, a.vec != 0, stage, out);
      for (int idx = threadIdx.x; idx < U * p.nb; idx += THREADS) {
        const int n = idx / U;
        const int u = idx - n * U;
        if (n0 + n < B && j0 + u < H)
          a.dh[static_cast<long long>(n0 + n) * H + j0 + u] = gathered(p, out, u, n);
      }
    }
    __syncthreads();  // the next step's pointwise part reads dh in another thread mapping
  }
}

template <typename T>
int run(BwdArgs a, cudaStream_t stream) {
  const int sms = lstm::multiprocessors();
  const int units = sms > 0 ? lstm::units_per_block(a.hidden, sms) : 0;
  if (units == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const lstm::Plan p = lstm::make_plan(sizeof(T), units, units, 4 * a.hidden, a.batch);
  constexpr int V = 16 / sizeof(T);
  a.vec = (4 * a.hidden) % V == 0 && reinterpret_cast<uintptr_t>(a.dgates) % 16 == 0;
  const int blocks = (a.hidden + units - 1) / units;
  return lstm::launch(lstm_bwd_kernel<T>, a, p, blocks, stream);
}

}  // namespace

// The backward over all steps; returns cudaGetLastError() (or
// cudaErrorCooperativeLaunchTooLarge when the grid does not fit).
extern "C" int lstm_bwd(int is_bf16, const void* gates, const void* cseq, const void* cprev,
                        const void* dout, const void* w, float* dh, float* dc, void* dgates,
                        unsigned int* bar, int steps, int batch, int hidden, int reverse,
                        cudaStream_t stream) {
  if (steps <= 0 || batch <= 0 || hidden <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{gates, cseq, cprev, dout, w, dh, dc, dgates, bar, steps, batch, hidden,
                  reverse, 0};
  return is_bf16 ? run<__nv_bfloat16>(a, stream) : run<float>(a, stream);
}
