// Staging and fragment helpers shared by the kernels on Hopper (sm_90a):
// dw_gemm.cuh (the fused blocks' weight gradients), block_mma.cuh (the block
// kernels and their input gradients), attention.cuh (the attention kernels),
// the LSTM kernels' rings (lstm_fwd.cu, lstm_bwd.cu) and the split-f32 STFT
// (stft.cu) and LSTM kernels (lstm.cuh).
//
// - mma.sync m16n8k16 (bf16 in, f32 accumulate) and m16n8k8 (TF32 in, f32
//   accumulate), with cvt.rna.tf32, which rounds f32 to TF32 for the
//   split-f32 products; ldmatrix fragments, also transposed (.trans: the
//   operand stored with k along its rows), the transposed stmatrix and the
//   in-register transpose movmatrix;
// - 16-byte global loads, predicated without a branch, of the aligned
//   chunks around a row of frames, and the register shift (realign) that
//   takes eight frames starting at any of the eight 2-byte offsets of a
//   16-byte word out of two such chunks: T = 643 frames is odd, so the rows
//   of an activation start at every residue;
// - zeroing the realigned frames that fall outside [0, T);
// - cp.async copies of 16-byte chunks straight into shared memory, also
//   zero-filled;
// - bulk copies (cp.async.bulk) whose bytes an mbarrier counts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mmautil {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// Thread (g, t) of the warp gets elements [2t][g] and [2t + 1][g] of each
// 8 x 8 matrix, whose eight rows lanes 8j .. 8j + 7 address: the fragment
// of the transpose of what is stored.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
// The inverse of ldsm_x4_trans: register j of thread (g, t), elements [g][2t]
// and [g][2t + 1] of matrix j, lands at [2t][g], [2t + 1][g] of the rows that
// lanes 8j .. 8j + 7 address.
__device__ __forceinline__ void stsm_x4_trans(bf16* p, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
// The 8 x 8 matrix held as one register a lane (row g, columns 2t, 2t + 1),
// transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The TF32 value nearest v (10 explicit mantissa bits, ties away from zero),
// as the bits of an f32. One TF32 product keeps too few bits for an f32
// tolerance; a split-f32 product takes v's big part, to_tf32(v), and its
// small part, to_tf32(v - big), and sums small x big + big x small + big x
// big in f32 (3xTF32: about f32's accuracy).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// The same split on the integer and FMA pipes: big is v rounded to nearest
// TF32, ties away from zero (its bits plus half a TF32 ulp, masked: cvt.rna's
// result for a finite v), small is v - big (exact) truncated to TF32 (the
// mantissa bits an mma.sync reads).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xFFFFE000u;
}
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global memory through the read-only path, or zeros when
// !ok; a predicated load, no branch.
__device__ __forceinline__ uint4 ld_pred(const uint4* src, bool ok) {
  uint4 v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @p ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(src), "r"(static_cast<int>(ok)));
  return v;
}

// The 16-byte chunk that holds element src, and src's place in it.
__device__ __forceinline__ const uint4* aligned_chunk(const bf16* src) {
  return reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(src) &
                                        ~static_cast<uintptr_t>(15));
}
__device__ __forceinline__ int residue(const bf16* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 1);
}

// Elements [s, s + 8) of the 16 bf16 elements lo:hi (two per word, the
// lower element in the low half), s in [0, 8].
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int s) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t x[6], y[5];
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = s & 4 ? w[k + 2] : w[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) y[k] = s & 2 ? x[k + 1] : x[k];
  const unsigned sh = (s & 1) * 16;
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = s == 8 ? w[k + 4] : __funnelshift_r(y[k], y[k + 1], sh);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Zero the elements of a realigned chunk whose frames f0 .. f0 + 7 fall
// outside [0, n).
__device__ __forceinline__ uint4 mask_frames(uint4 v, int f0, int n) {
  if (f0 >= 0 && f0 + 8 <= n) return v;
  uint32_t o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = f0 + 2 * k;
    o[k] &= (static_cast<unsigned>(f) < static_cast<unsigned>(n) ? 0xffffu : 0u) |
            (static_cast<unsigned>(f + 1) < static_cast<unsigned>(n) ? 0xffff0000u : 0u);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 16 bytes from global to shared memory without passing through registers
// (cached in L2 only); completion by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// The same, zero-filled when !ok (src is then not read, but must be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's commit groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Bulk copies: one thread lands a block of bytes in shared memory, an
// mbarrier counts them, every thread waits on the barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

}  // namespace mmautil
