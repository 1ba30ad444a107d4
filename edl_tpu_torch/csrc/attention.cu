// Attention for Hopper (sm_90a): the C entry points, which route by head
// dim.  Causal (top-left: key j is visible to query i iff j <= i) or not,
// with Lq and Lk free.
//
// The entry points' kernels replace the Pallas TPU kernels that
// edl_tpu/ops/attention.py reaches (jax/experimental/pallas/ops/tpu/...):
//   _splash (lines 112-125), causal self-attention, the CAUSAL, Lq == Lk
//   use behind the edl_attn_* entry points:
//   - forward   : splash_attention/splash_attention_kernel.py:1137
//   - dq        : splash_attention/splash_attention_kernel.py:1635
//   - dk / dv   : splash_attention/splash_attention_kernel.py:2196
//   _flash (lines 81-87), causal or not, Lq != Lk, behind edl_flash_*:
//   - forward   : flash_attention.py:758
//   - dk / dv   : flash_attention.py:1121
//   - dq        : flash_attention.py:1456
//   and, for both, the backward's XLA rowsum(dO * O), which the dQ kernels
//   compute and return (splash_attention_kernel.py:2285,
//   flash_attention.py:273).
// Which kernel runs where:
//   - forward, D = 64..256 : attention_sm90.cu (TMA, wgmma, warp-specialised)
//   - dK/dV, D = 64, 128   : attention_sm90.cu, each consumer warpgroup
//                            owning 64 keys x both outputs
//   - dK/dV, D = 192, 256  : attention_sm90.cu, the consumers of a 64-key
//                            block splitting the outputs (one dV, one dK)
//   - dK/dV, D = 320, 384  : attention_sm90.cu, the same on half the output
//                            columns per block
//   - dQ with delta folded in, D = 64..256 : attention_sm90.cu
//   - forward, D = 320..512 : attention_wide_sm90.cu (TMA, wgmma,
//                            warp-specialised, the consumers splitting
//                            the output columns)
//   - forward above D = 512 (any D % 64 == 0): attention_chunk_sm90.cu, the
//                            same on chunks of the output columns
//   - dK/dV above D = 384 and dQ with delta folded in above D = 256, up to
//     D = 2048: attention_bwd_cluster_sm90.cu (TMA, wgmma, a thread block
//     cluster of up to 8 blocks splitting D and exchanging partial scores
//     through distributed shared memory)
//   - dK/dV and dQ with delta folded in above D = 2048 (past the largest
//     cluster): attention_wide.cu (mma.sync)
// The backward is dQ (which writes delta), then dK/dV (which reads it):
// one kernel each at every head dim.  No atomics: the backward is
// deterministic.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, D] with D contiguous and
// read through their (batch, row, head) strides, so neither the model nor the
// wrapper transposes.  The logsumexp and delta are f32 [B, H, Lq].
// Types: bf16 in and out, f32 inside.  Any Lq, Lk >= 1 (the ragged last
// tiles are masked).  sm_scale is applied in f32 to the f32 scores.  B * H
// rides on grid x (up to 2^31 - 1), the row tiles on grid y.

#include "attention_common.cuh"

namespace edl_attn {
namespace {

// Every D % 64 == 0 has a kernel; any other D gives cudaErrorInvalidValue.
bool head_dim_ok(int D) { return D >= 64 && D % 64 == 0; }

cudaError_t fwd(int D, bool causal, const void* q, const void* k, const void* v, void* o, void* lse,
                const long long* st, int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  if (D <= 256) return fwd_sm90(D, causal, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
  if (D <= 512) return fwd_split_sm90(D, causal, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
  return fwd_chunk_sm90(D, causal, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
}

cudaError_t dkdv(int D, bool causal, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, const long long* st, int B,
                 int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  if (D <= 256)
    return dkdv_sm90(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream);
  if (D <= 384)
    return dkdv_chunk_sm90(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale,
                           stream);
  if (D <= 2048)
    return dkdv_cluster_sm90(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale,
                             stream);
  return dkdv_wide(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream);
}

// dQ, which also writes delta.  `st` holds the strides of q, k, v, o, dout,
// dq.
cudaError_t dq(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dlt, void* dqp, const long long* st, int B,
               int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  if (D <= 256)
    return dq_sm90(D, causal, q, k, v, o, dout, lse, dlt, dqp, st, B, H, Lq, Lk, scale, stream);
  if (D <= 2048)
    return dq_cluster_sm90(D, causal, q, k, v, o, dout, lse, dlt, dqp, st, B, H, Lq, Lk, scale,
                           stream);
  return dq_wide(D, causal, q, k, v, o, dout, lse, dlt, dqp, st, B, H, Lq, Lk, scale, stream);
}

}  // namespace
}  // namespace edl_attn

// Plain C entry points (loaded with ctypes).  Each launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success), or the error of a
// refused set-up (a tensor map that does not encode, too much shared
// memory); a head dim that is not a multiple of 64 returns
// cudaErrorInvalidValue.  `st` holds (batch, row, head) element strides,
// three per tensor, in the order the [B, L, H, D] tensors are listed.  The
// dQ entry points write delta = rowsum(dO * O), which the dK/dV ones then
// read.  The edl_attn_* forward, dK/dV and dQ are causal self-attention
// (L = Lq = Lk); the edl_flash_* ones take Lq, Lk and `causal`.
// edl_attn_bwd_smem launches nothing: it gives the dynamic shared memory
// in bytes of the cluster dQ (is_dq != 0) or dK/dV kernel instantiated
// with `bpr` 64-column boxes a block, or 0 where there is none.
extern "C" {

using namespace edl_attn;

int edl_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 const long long* st, int B, int H, int L, int D, float scale, void* stream) {
  return fwd(D, true, q, k, v, o, lse, st, B, H, L, L, scale, (cudaStream_t)stream);
}

int edl_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dlt, void* dk, void* dv,
                      const long long* st, int B, int H, int L, int D, float scale,
                      void* stream) {
  return dkdv(D, true, q, k, v, dout, lse, dlt, dk, dv, st, B, H, L, L, scale, (cudaStream_t)stream);
}

int edl_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const void* lse, void* dlt, void* dqp, const long long* st, int B, int H, int L,
                    int D, float scale, void* stream) {
  return dq(D, true, q, k, v, o, dout, lse, dlt, dqp, st, B, H, L, L, scale, (cudaStream_t)stream);
}

int edl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  const long long* st, int B, int H, int Lq, int Lk, int D, int causal,
                  float scale, void* stream) {
  return fwd(D, causal != 0, q, k, v, o, lse, st, B, H, Lq, Lk, scale, (cudaStream_t)stream);
}

int edl_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dlt, void* dk, void* dv,
                       const long long* st, int B, int H, int Lq, int Lk, int D, int causal,
                       float scale, void* stream) {
  return dkdv(D, causal != 0, q, k, v, dout, lse, dlt, dk, dv, st, B, H, Lq, Lk, scale,
              (cudaStream_t)stream);
}

int edl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dlt, void* dqp, const long long* st,
                     int B, int H, int Lq, int Lk, int D, int causal, float scale, void* stream) {
  return dq(D, causal != 0, q, k, v, o, dout, lse, dlt, dqp, st, B, H, Lq, Lk, scale,
            (cudaStream_t)stream);
}

int edl_attn_bwd_smem(int bpr, int is_dq) { return bwd_cluster_smem(bpr, is_dq != 0); }

}  // extern "C"
