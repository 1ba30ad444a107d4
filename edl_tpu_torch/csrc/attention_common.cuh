// Shared pieces of the attention kernels (attention.cu, attention_sm90.cu,
// attention_wide_sm90.cu, attention_chunk_sm90.cu,
// attention_bwd_cluster_sm90.cu, attention_wide.cu): operand strides, the
// mma.sync / ldmatrix / cp.async helpers of the wide kernels, the
// fragment and reduction helpers, and the launchers each source exports to
// the C entry points in attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace edl_attn {

typedef __nv_bfloat16 bf16;

struct Strides {  // element strides of a [B, L, H, D] tensor
  long long b, l, h;
};

inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16 x 16): {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}
//   B (16 k x 8 n): {B[2t..][g], B[2t+8..][g]}
// Each is gathered from shared memory by one ldmatrix.x4 (four 8 x 8
// matrices; lanes 8i..8i+7 give the row addresses of matrix i).

// A fragment (16 x 16) of a row-major tile at (r0, c0).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld, int r0, int c0,
                                       int lane) {
  const bf16* p = s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// B fragments of two neighbouring n-tiles (n0 and n0 + 8; b[0..1] and
// b[2..3]) for k-chunk k0, from a tile stored as s[n][k] (k contiguous).
__device__ __forceinline__ void load_b_t(uint32_t b[4], const bf16* s, int ld, int n0, int k0,
                                         int lane) {
  const bf16* p = s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(p)));
}

// The same two B fragments from a tile stored as s[k][n] (n contiguous):
// ldmatrix.trans transposes each 8 x 8 matrix on the way.
__device__ __forceinline__ void load_b_n(uint32_t b[4], const bf16* s, int ld, int k0, int n0,
                                         int lane) {
  const bf16* p = s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(p)));
}

// A fragment of a 16 x 16 slice (columns 16kk..16kk+15) of a 16 x N f32
// accumulator held as N/8 C fragments: the C layout of two neighbouring
// n-tiles is the A layout of one k-chunk.  (A wgmma accumulator has this
// layout per warp, and a register A operand of wgmma the A layout.)
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void commit_group() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_group() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the sum of the products of eight bf16 pairs (delta = rowsum(dO * O))
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s += u.x * w.x + u.y * w.y;
  }
  return s;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launchers.  Arguments as the C entry points in attention.cu: `st` holds
// three (batch, row, head) element strides per tensor, in argument order.
// attention_sm90.cu: TMA + wgmma, warp-specialised.
cudaError_t fwd_sm90(int D, bool causal, const void* q, const void* k, const void* v, void* o,
                     void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                     cudaStream_t stream);
cudaError_t dkdv_sm90(int D, bool causal, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      const long long* st, int B, int H, int Lq, int Lk, float scale,
                      cudaStream_t stream);
// dK/dV at D = 320, 384: the consumers split dV and dK, the blocks the
// output columns.
cudaError_t dkdv_chunk_sm90(int D, bool causal, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                            const long long* st, int B, int H, int Lq, int Lk, float scale,
                            cudaStream_t stream);
// dQ with delta = rowsum(dO * O) folded in: `delta` is an output; `st` holds
// the strides of q, k, v, o, dout, dq.
cudaError_t dq_sm90(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                    int B, int H, int Lq, int Lk, float scale, cudaStream_t stream);
// attention_wide_sm90.cu: the forward at D = 320, 384, 448, 512, TMA +
// wgmma, warp-specialised, its consumers splitting the output columns.
cudaError_t fwd_split_sm90(int D, bool causal, const void* q, const void* k, const void* v, void* o,
                           void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                           cudaStream_t stream);
// attention_chunk_sm90.cu: the same above 512 (any D % 64 == 0) on chunks
// of the output columns.
cudaError_t fwd_chunk_sm90(int D, bool causal, const void* q, const void* k, const void* v, void* o,
                           void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                           cudaStream_t stream);
// attention_bwd_cluster_sm90.cu: dK/dV (run above 384) and dQ with delta
// folded in (run above 256) up to D = 2048 (any D % 64 == 0), on thread
// block clusters that split D; bwd_cluster_smem gives the dynamic shared
// memory a launch takes with `bpr` 64-column boxes a block (0 for a count
// that is not instantiated).
cudaError_t dkdv_cluster_sm90(int D, bool causal, const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                              const long long* st, int B, int H, int Lq, int Lk, float scale,
                              cudaStream_t stream);
cudaError_t dq_cluster_sm90(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                            int B, int H, int Lq, int Lk, float scale, cudaStream_t stream);
int bwd_cluster_smem(int bpr, bool dq);
// attention_wide.cu: dK/dV and dQ with delta folded in (mma.sync) for any
// D % 64 == 0, D a runtime argument (run above D = 2048, past the largest
// cluster).
cudaError_t dkdv_wide(int D, bool causal, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      const long long* st, int B, int H, int Lq, int Lk, float scale,
                      cudaStream_t stream);
cudaError_t dq_wide(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                    int B, int H, int Lq, int Lk, float scale, cudaStream_t stream);

}  // namespace edl_attn
