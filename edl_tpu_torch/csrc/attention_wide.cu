// Attention backward above head dim 2048, past the largest thread block
// cluster of attention_bwd_cluster_sm90.cu: dK/dV and dQ with delta =
// rowsum(dO * O) folded in, for any D % 64 == 0, D a runtime argument, so
// every head dim the JAX package's gates take has a kernel.
//
// Replaces the same Pallas TPU kernels as attention.cu and
// attention_bwd_cluster_sm90.cu (splash_attention_kernel.py:1635, :2196
// with the rowsum of :2285, and flash_attention.py:1121, :1456 with the di
// of :273) at those head dims.
//
// Design: right and simple first.  A block is 4 warps owning 64 rows (16 a
// warp) of one (batch, head) and a chunk of at most 128 output columns
// (grid z), so neither registers nor shared memory grow with D.  The score
// products (Q K^T and dO V^T) are accumulated over D in 64-column slices
// staged through shared memory by cp.async; the output products read a
// <= 128-column chunk.  mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by
// ldmatrix.  Each column chunk recomputes the scores, and slices are loaded
// anew for every tile: what bounds these kernels is those reloads and
// mma.sync's rate, not the card's bound (PERF.md).  Each dQ block computes
// delta for its rows from O and dO in device memory before its key loop;
// chunk 0 writes it for dK/dV.

#include "attention_common.cuh"

namespace edl_attn {
namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;       // rows a block owns, and rows of a walked tile
constexpr int kLdS = 64 + 8;    // a 64-column slice, padded
constexpr int kChunk = 128;     // output columns a block accumulates, at most
constexpr int kLdC = kChunk + 8;

// Copy rows [row0, row0 + rows) x columns [c, c + w) of one (batch, head)
// slice into s (row stride ld), 16 bytes per cp.async; rows >= L are
// zero-filled.  The caller commits and waits.
__device__ __forceinline__ void load_rows(bf16* s, int ld, const bf16* src, long long sl, int row0,
                                          int rows, int L, int c, int w) {
  const int per_row = w / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, cc = (i % per_row) * 8;
    const bool in = row0 + r < L;
    cp_async16(s + r * ld + cc, src + (long long)(in ? row0 + r : 0) * sl + c + cc, in);
  }
}

__device__ __forceinline__ void sync_copies() {
  commit_group();
  wait_group<0>();
  __syncthreads();
}

// acc[N/8][4] (+)= A B over one 16-row k-chunk per warp: A fragments from
// a row-major tile `a` (rows = this warp's 16, columns k), B = a tile
// stored b[n][k] (k contiguous).
template <int N>
__device__ __forceinline__ void mma_ab_t(float (&acc)[N / 8][4], const bf16* a, int lda, int ar0,
                                         const bf16* b, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4];
    load_a(af, a, lda, ar0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t bf[4];
      load_b_t(bf, b, ldb, n * 8, kk * 16, lane);
      mma16816(acc[n], af, bf);
      mma16816(acc[n + 1], af, bf + 2);
    }
  }
}

// acc[kChunk/8][4] += P B for the first w columns: P is 16 x (16 KS) per
// warp as f32 C fragments p[2 KS][4], B a tile stored b[k][n] (n
// contiguous).
template <int KS>
__device__ __forceinline__ void mma_p_b(float (&acc)[kChunk / 8][4], const float (&p)[2 * KS][4],
                                        const bf16* b, int w, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    acc_to_a(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < kChunk / 8; n += 2) {
      if (n * 8 < w) {
        uint32_t bf[4];
        load_b_n(bf, b, kLdC, kk * 16, n * 8, lane);
        mma16816(acc[n], af, bf);
        mma16816(acc[n + 1], af, bf + 2);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[kChunk / 8][4]) {
#pragma unroll
  for (int n = 0; n < kChunk / 8; ++n) a[n][0] = a[n][1] = a[n][2] = a[n][3] = 0.f;
}

// Write rows `row` (two per thread) of a 16 x w accumulator times `mul`.
__device__ __forceinline__ void store_rows(bf16* base, long long sl, const int (&row)[2], int L,
                                           const float (&acc)[kChunk / 8][4], float mul, int w,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= L) continue;
    bf16* r = base + (long long)row[i] * sl;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      if (n * 8 < w)
        *reinterpret_cast<uint32_t*>(r + n * 8 + 2 * t) =
            pack_f32(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV.  Grid (B * H, ceil(Lk / 64), ceil(D / 128)); a block owns 64
// keys and walks the query steps (32 rows) that see them.  A key tile no
// query sees (causal, k0 >= Lq) writes zeros.
constexpr int kStep = 32;

template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
                              Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int Lq,
                              int Lk, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * kLdS;
  bf16* Qs = Vs + kRows * kLdS;     // kStep x kLdS
  bf16* dOs = Qs + kStep * kLdS;    // kStep x kLdS
  bf16* Qc = dOs + kStep * kLdS;    // kStep x kLdC
  bf16* dOc = Qc + kStep * kLdC;    // kStep x kLdC
  float* stats = reinterpret_cast<float*>(dOc + kStep * kLdC);  // lse2[kStep], delta[kStep]

  const int k0 = blockIdx.y * kRows;
  const int c0 = blockIdx.z * kChunk, w = min(kChunk, D - c0);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;

  float dka[kChunk / 8][4], dva[kChunk / 8][4];
  zero(dka);
  zero(dva);
  const float sl2 = scale * kLog2e;
  const int kvrow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  for (int q0 = CAUSAL ? k0 : 0; q0 < Lq; q0 += kStep) {
    if (threadIdx.x < kStep) {
      const int i = q0 + threadIdx.x;
      stats[threadIdx.x] = i < Lq ? lse_b[i] * kLog2e : 0.f;
      stats[kStep + threadIdx.x] = i < Lq ? delta_b[i] : 0.f;
    }
    float p[kStep / 8][4], ds[kStep / 8][4];
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) {
      p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    }
    for (int c = 0; c < D; c += 64) {  // S^T = K Q^T and dP^T = V dO^T over slices
      load_rows(Ks, kLdS, kb, sk.l, k0, kRows, Lk, c, 64);
      load_rows(Vs, kLdS, vb, sv.l, k0, kRows, Lk, c, 64);
      load_rows(Qs, kLdS, qb, sq.l, q0, kStep, Lq, c, 64);
      load_rows(dOs, kLdS, dob, sdo.l, q0, kStep, Lq, c, 64);
      sync_copies();
      mma_ab_t<kStep>(p, Ks, kLdS, warp * 16, Qs, kLdS, lane);
      mma_ab_t<kStep>(ds, Vs, kLdS, warp * 16, dOs, kLdS, lane);
      __syncthreads();
    }
    load_rows(Qc, kLdC, qb, sq.l, q0, kStep, Lq, c0, w);
    load_rows(dOc, kLdC, dob, sdo.l, q0, kStep, Lq, c0, w);
    commit_group();

    const bool edge = (CAUSAL && q0 < k0 + kRows) || (q0 + kStep > Lq);
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), qi = q0 + ql;
        float x = exp2f(p[n][e] * sl2 - stats[ql]);
        if (edge && ((CAUSAL && qi < kvrow[e >> 1]) || qi >= Lq)) x = 0.f;
        p[n][e] = x;
        ds[n][e] = x * (ds[n][e] - stats[kStep + ql]);
      }
    }
    wait_group<0>();
    __syncthreads();
    mma_p_b<kStep / 16>(dva, p, dOc, w, lane);   // dV += P^T dO
    mma_p_b<kStep / 16>(dka, ds, Qc, w, lane);   // dK += dS^T Q
    __syncthreads();
  }

  store_rows(dk + b * sdk.b + h * sdk.h + c0, sdk.l, kvrow, Lk, dka, scale, w, t);
  store_rows(dv + b * sdv.b + h * sdv.h + c0, sdv.l, kvrow, Lk, dva, 1.f, w, t);
}

// ---------------------------------------------------------------------------
// dQ, with delta folded in.  Grid (B * H, ceil(Lq / 64), ceil(D / 128)); a
// block owns 64 query rows and walks the key tiles they see.
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ o,
                            const bf16* __restrict__ dout, const float* __restrict__ lse,
                            float* __restrict__ delta, bf16* __restrict__ dq, Strides sq, Strides sk,
                            Strides sv, Strides so, Strides sdo, Strides sdq, int H, int Lq, int Lk,
                            int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * kLdS;
  bf16* Ks = dOs + kRows * kLdS;
  bf16* Vs = Ks + kRows * kLdS;
  bf16* Kc = Vs + kRows * kLdS;  // kRows x kLdC

  const int n_tiles = (Lq + kRows - 1) / kRows;
  const int q0 = (CAUSAL ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y) * kRows;
  const int c0 = blockIdx.z * kChunk, w = min(kChunk, D - c0);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // delta of this thread's two rows (thread t of the quad sums 16-byte
  // chunks t, t + 4, ...), written by chunk 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float part = 0.f;
    if (row[i] < Lq) {
      const uint4* orow = reinterpret_cast<const uint4*>(o + b * so.b + (long long)row[i] * so.l + h * so.h);
      const uint4* drow = reinterpret_cast<const uint4*>(dob + (long long)row[i] * sdo.l);
      for (int c = t; c < D / 8; c += 4) part += dot8(orow[c], drow[c]);
    }
    dlt[i] = quad_sum(part);
    lse2[i] = row[i] < Lq ? lse[(long long)bh * Lq + row[i]] * kLog2e : 0.f;
    if (blockIdx.z == 0 && t == 0 && row[i] < Lq) delta[(long long)bh * Lq + row[i]] = dlt[i];
  }
  float dqa[kChunk / 8][4];
  zero(dqa);
  const float sl2 = scale * kLog2e;
  const int last = (CAUSAL ? min(q0 + kRows - 1, Lk - 1) : Lk - 1) / kRows;

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kRows;
    float p[8][4], ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    }
    for (int c = 0; c < D; c += 64) {  // S = Q K^T and dP = dO V^T over slices
      load_rows(Qs, kLdS, qb, sq.l, q0, kRows, Lq, c, 64);
      load_rows(dOs, kLdS, dob, sdo.l, q0, kRows, Lq, c, 64);
      load_rows(Ks, kLdS, kb, sk.l, k0, kRows, Lk, c, 64);
      load_rows(Vs, kLdS, vb, sv.l, k0, kRows, Lk, c, 64);
      sync_copies();
      mma_ab_t<64>(p, Qs, kLdS, warp * 16, Ks, kLdS, lane);
      mma_ab_t<64>(ds, dOs, kLdS, warp * 16, Vs, kLdS, lane);
      __syncthreads();
    }
    load_rows(Kc, kLdC, kb, sk.l, k0, kRows, Lk, c0, w);
    commit_group();

    const bool edge = (CAUSAL && k0 + kRows - 1 > q0) || (k0 + kRows > Lk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1), i = e >> 1;
        float x = exp2f(p[n][e] * sl2 - lse2[i]);
        if (edge && ((CAUSAL && col > row[i]) || col >= Lk)) x = 0.f;
        ds[n][e] = x * (ds[n][e] - dlt[i]);
      }
    }
    wait_group<0>();
    __syncthreads();
    mma_p_b<4>(dqa, ds, Kc, w, lane);  // dQ += dS K
    __syncthreads();
  }
  store_rows(dq + b * sdq.b + h * sdq.h + c0, sdq.l, row, Lq, dqa, scale, w, t);
}

dim3 grid_of(int L, int B, int H, int D) {
  return dim3((unsigned)B * H, (L + kRows - 1) / kRows, (D + kChunk - 1) / kChunk);
}

}  // namespace

cudaError_t dkdv_wide(int D, bool causal, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      const long long* st, int B, int H, int Lq, int Lk, float scale,
                      cudaStream_t stream) {
  const size_t smem = (2 * kRows * kLdS + 2 * kStep * kLdS + 2 * kStep * kLdC) * sizeof(bf16) +
                      2 * kStep * sizeof(float);
  auto kernel = causal ? &attn_bwd_dkdv_wide_kernel<true> : &attn_bwd_dkdv_wide_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(Lk, B, H, D), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Lq, Lk, D,
      scale);
  return cudaGetLastError();
}

cudaError_t dq_wide(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                    int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  const size_t smem = (4 * kRows * kLdS + kRows * kLdC) * sizeof(bf16);
  auto kernel = causal ? &attn_bwd_dq_wide_kernel<true> : &attn_bwd_dq_wide_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(Lq, B, H, D), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const bf16*)dout,
      (const float*)lse, (float*)delta, (bf16*)dq, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Lq, Lk, D,
      scale);
  return cudaGetLastError();
}

}  // namespace edl_attn
