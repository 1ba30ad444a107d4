// Attention for Hopper (sm_90a): the C entry points, and the standalone
// delta = rowsum(dO * O) kernel for head dims above 256.  Causal (top-left:
// key j is visible to query i iff j <= i) or not, with Lq and Lk free.
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
//   and, for both, the backward's XLA rowsum(dO * O), which the dQ entry
//   points compute and return (splash_attention_kernel.py:2285,
//   flash_attention.py:273).
// Which kernel runs where:
//   - forward, D = 64..256 : attention_sm90.cu (TMA, wgmma, warp-specialised)
//   - dK/dV, D = 64, 128   : attention_sm90.cu, each consumer warpgroup
//                            owning 64 keys x both outputs
//   - dK/dV, D = 192, 256  : attention_sm90.cu, the consumers of a 64-key
//                            block splitting the outputs (one dV, one dK)
//   - dK/dV, D = 320..512  : attention_sm90.cu, the same on half the output
//                            columns per block
//   - dQ with delta folded in, D = 64..256 : attention_sm90.cu
//   - forward, D = 320..512 : attention_wide_sm90.cu (TMA, wgmma,
//                            warp-specialised, the consumers splitting
//                            the output columns)
//   - forward above D = 512 (any D % 64 == 0): attention_chunk_sm90.cu, the
//                            same on chunks of the output columns
//   - dQ above D = 256 and dK/dV above D = 512 (any D % 64 == 0):
//     attention_wide.cu (mma.sync); the dQ entry points run this file's
//     delta kernel first there
// The backward is dQ (which writes delta), then dK/dV (which reads it).
// Blocks never talk to each other, so the backward needs no atomics and is
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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// ---------------------------------------------------------------------------
// delta[b, h, l] = sum_d dO[b, l, h, d] * O[b, l, h, d] (the XLA einsums of
// splash_attention_kernel.py:2285 and flash_attention.py:273), standalone:
// the dQ entry points run it before the wide dQ at head dims above 256
// (below, the Hopper dQ computes delta itself).  One warp per (b, h, l)
// row; it only streams O and dO, so it is bound by their bytes.
__global__ void __launch_bounds__(kThreads)
    attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          float* __restrict__ delta, Strides so, Strides sdo, int H, int L, int D,
                          long long rows) {
  const long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = r / L;
  const int i = (int)(r % L), b = (int)(bh / H), h = (int)(bh % H);
  const bf16* orow = o + b * so.b + (long long)i * so.l + h * so.h;
  const bf16* drow = dout + b * sdo.b + (long long)i * sdo.l + h * sdo.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

cudaError_t delta(int D, const void* o, const void* dout, void* delta, const long long* st, int B,
                  int H, int L, cudaStream_t stream) {
  const long long rows = (long long)B * H * L;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  attn_bwd_delta_kernel<<<blocks, kThreads, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, strides_at(st, 0), strides_at(st, 1), H, L,
      D, rows);
  return cudaGetLastError();
}

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
  if (D <= 512)
    return dkdv_chunk_sm90(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale,
                           stream);
  return dkdv_wide(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream);
}

// dQ, which also writes delta: the Hopper kernel up to D = 256; above it,
// the delta kernel and then the wide dQ, which reads delta.  `st` holds the
// strides of q, k, v, o, dout, dq; `kernels` gets the number of kernels
// launched.
cudaError_t dq(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dlt, void* dqp, const long long* st, int B,
               int H, int Lq, int Lk, float scale, int* kernels, cudaStream_t stream) {
  *kernels = 0;
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  if (D <= 256) {
    *kernels = 1;
    return dq_sm90(D, causal, q, k, v, o, dout, lse, dlt, dqp, st, B, H, Lq, Lk, scale, stream);
  }
  long long st_delta[6], st_wide[15];  // (o, dout) and (q, k, v, dout, dq)
  for (int i = 0; i < 6; ++i) st_delta[i] = st[9 + i];
  for (int i = 0; i < 9; ++i) st_wide[i] = st[i];
  for (int i = 0; i < 6; ++i) st_wide[9 + i] = st[12 + i];
  cudaError_t err = delta(D, o, dout, dlt, st_delta, B, H, Lq, stream);
  if (err != cudaSuccess) return err;
  *kernels = 2;
  return dq_wide(D, causal, q, k, v, dout, lse, dlt, dqp, st_wide, B, H, Lq, Lk, scale, stream);
}

}  // namespace
}  // namespace edl_attn

// Plain C entry points (loaded with ctypes).  Each launches one kernel on
// `stream` (the dQ ones two above D = 256: delta, then the wide dQ) and
// returns cudaGetLastError() (0 on success), or the error of a refused
// set-up (a tensor map that does not encode, too much shared memory); a
// head dim that is not a multiple of 64 returns cudaErrorInvalidValue.
// `st` holds (batch, row, head) element strides, three per tensor, in the
// order the [B, L, H, D] tensors are listed.  The dQ entry points write
// delta = rowsum(dO * O), which the dK/dV ones then read, and set
// `*kernels` to the number of kernels they launched (1, or 2 above D = 256),
// so the caller counts the standalone delta's launches too.  The edl_attn_*
// forward, dK/dV and dQ are causal self-attention (L = Lq = Lk); the
// edl_flash_* ones take Lq, Lk and `causal`.
extern "C" {

using namespace edl_attn;

int edl_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 const long long* st, int B, int H, int L, int D, float scale, void* stream) {
  return fwd(D, true, q, k, v, o, lse, st, B, H, L, L, scale, (cudaStream_t)stream);
}

int edl_attn_bwd_delta(const void* o, const void* dout, void* dlt, const long long* st, int B,
                       int H, int L, int D, void* stream) {
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  return delta(D, o, dout, dlt, st, B, H, L, (cudaStream_t)stream);
}

int edl_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dlt, void* dk, void* dv,
                      const long long* st, int B, int H, int L, int D, float scale,
                      void* stream) {
  return dkdv(D, true, q, k, v, dout, lse, dlt, dk, dv, st, B, H, L, L, scale, (cudaStream_t)stream);
}

int edl_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const void* lse, void* dlt, void* dqp, const long long* st, int B, int H, int L,
                    int D, float scale, int* kernels, void* stream) {
  return dq(D, true, q, k, v, o, dout, lse, dlt, dqp, st, B, H, L, L, scale, kernels,
            (cudaStream_t)stream);
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
                     int B, int H, int Lq, int Lk, int D, int causal, float scale, int* kernels,
                     void* stream) {
  return dq(D, causal != 0, q, k, v, o, dout, lse, dlt, dqp, st, B, H, Lq, Lk, scale, kernels,
            (cudaStream_t)stream);
}

}  // extern "C"
