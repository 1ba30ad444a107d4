// Attention for Hopper (sm_90a): the C entry points, and the mma.sync
// kernels of the backward that the Hopper kernels do not cover: dK/dV at
// D = 192 and 256, and the standalone delta = rowsum(dO * O) for head dims
// above 256.  Causal (top-left: key j is visible to query i iff j <= i) or
// not, with Lq and Lk free.
//
// The kernels replace the Pallas TPU kernels that edl_tpu/ops/attention.py
// reaches (jax/experimental/pallas/ops/tpu/...):
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
//   - dK/dV, D = 64, 128   : attention_sm90.cu
//   - dK/dV, D = 192, 256  : here (mma.sync; two 64 x D f32 accumulators do
//                            not fit a wgmma consumer's 240 registers)
//   - dQ with delta folded in, D = 64..256 : attention_sm90.cu
//   - forward, dK/dV, dQ, D > 256 (any D % 64 == 0): attention_wide.cu; the
//     dQ entry points run this file's delta kernel first there
// The backward is dQ (which writes delta), then dK/dV (which reads it).
// Blocks never talk to each other, so the backward needs no atomics and is
// deterministic.
//
// The mma.sync dK/dV: every thread block owns one (batch, head, 64-key
// tile) and walks the query steps itself; 4 warps of 16 rows, mma m16n8k16
// (bf16 in, f32 accumulate) fed by ldmatrix, cp.async double-buffered
// tiles, score tiles kept in registers.  A block owns half of the output
// columns (kCols) and grid z covers the halves; each half recomputes the
// scores.
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
constexpr int kTile = 64;    // key rows per block of the dK/dV kernel (16 per warp)
constexpr int kQStep = 32;   // query rows per step of the dK/dV kernel
constexpr int kPad = 8;      // shared-memory row padding, in bf16 elements

// Start copying rows [row0, row0 + ROWS) of one (batch, head) slice into
// shared memory (row stride D + kPad), 16 bytes per cp.async; rows >= L are
// zero-filled.  The caller commits the group and waits for it.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* src, long long sl, int row0,
                                          int L) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool in = row0 + r < L;
    cp_async16(s + r * (D + kPad) + c, src + (long long)(in ? row0 + r : 0) * sl + c, in);
  }
}

// Output columns a block of the dK/dV kernel accumulates: half of D.
template <int D>
constexpr int kCols = D / 2;

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

// ---------------------------------------------------------------------------
// dK and dV at D = 192 and 256 (replaces
// splash_attention_kernel.py:2196 and flash_attention.py:1121 there; D = 64
// and 128 run the wgmma kernel of attention_sm90.cu, D > 256 the wide one).
// Grid (B * H, ceil(Lk / 64), D / kCols); each block owns 64 key rows (16 per warp) and walks the query steps that see
// them, recomputing P^T from q, k and the saved logsumexp.  A key tile that
// no query sees (causal, k0 >= Lq) walks nothing and writes zeros.  Shared
// memory: the K and V tiles, then two stages of (Q step, dO step, their lse
// and delta).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int Lq,
                         int Lk, float scale) {
  constexpr int DV = kCols<D>, LD = D + kPad, STEP = kQStep * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile * LD;
  bf16* QdOs = Vs + kTile * LD;  // stage i: Q at QdOs + 2i STEP, dO right after it
  float* stats = reinterpret_cast<float*>(QdOs + 4 * STEP);  // stage i: lse, delta at 2i kQStep

  const int k0 = blockIdx.y * kTile;  // causal: tile 0 walks the most query steps: launched first
  const int c0 = blockIdx.z * DV;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;

  // one query step (Q, dO and their statistics) into a stage
  auto load_step = [&](int q0, int stage) {
    bf16* qs = QdOs + 2 * stage * STEP;
    load_tile<kQStep, D>(qs, qb, sq.l, q0, Lq);
    load_tile<kQStep, D>(qs + STEP, dob, sdo.l, q0, Lq);
    if (threadIdx.x < kQStep) {
      const int i = q0 + threadIdx.x;
      float* st = stats + 2 * stage * kQStep;
      st[threadIdx.x] = i < Lq ? lse_b[i] * kLog2e : 0.f;
      st[kQStep + threadIdx.x] = i < Lq ? delta_b[i] : 0.f;
    }
  };
  // causal: queries before k0 never see these keys
  const int q_first = CAUSAL ? k0 : 0;
  load_tile<kTile, D>(Ks, k + b * sk.b + h * sk.h, sk.l, k0, Lk);
  load_tile<kTile, D>(Vs, v + b * sv.b + h * sv.h, sv.l, k0, Lk);
  load_step(q_first, 0);
  commit_group();

  float dka[DV / 8][4], dva[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const int kvrow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  for (int q0 = q_first, j = 0; q0 < Lq; q0 += kQStep, ++j) {
    if (q0 + kQStep < Lq) {  // the next step loads while this one computes
      load_step(q0 + kQStep, (j + 1) & 1);
      commit_group();
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const bf16* Qs = QdOs + 2 * (j & 1) * STEP;
    const bf16* dOs = Qs + STEP;
    const float* lse_s = stats + 2 * (j & 1) * kQStep;
    const float* delta_s = lse_s + kQStep;

    // S^T = K Q^T for this warp's 16 keys x 32 queries
    float p[kQStep / 8][4];
#pragma unroll
    for (int n = 0; n < kQStep / 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      load_a(af, Ks, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kQStep / 8; n += 2) {
        uint32_t bf[4];
        load_b_t(bf, Qs, LD, n * 8, kk * 16, lane);
        mma16816(p[n], af, bf);
        mma16816(p[n + 1], af, bf + 2);
      }
    }
    const bool edge = (CAUSAL && q0 < k0 + kTile) || (q0 + kQStep > Lq);
#pragma unroll
    for (int n = 0; n < kQStep / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t + (e & 1), qi = q0 + ql;
        float x = exp2f(p[n][e] * sl2 - lse_s[ql]);
        if (edge && ((CAUSAL && qi < kvrow[e >> 1]) || qi >= Lq)) x = 0.f;
        p[n][e] = x;
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < kQStep / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t bf[4];
        load_b_n(bf, dOs, LD, kk * 16, c0 + n * 8, lane);
        mma16816(dva[n], af, bf);
        mma16816(dva[n + 1], af, bf + 2);
      }
    }
    // dP^T = V dO^T
    float ds[kQStep / 8][4];
#pragma unroll
    for (int n = 0; n < kQStep / 8; ++n) ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      load_a(af, Vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kQStep / 8; n += 2) {
        uint32_t bf[4];
        load_b_t(bf, dOs, LD, n * 8, kk * 16, lane);
        mma16816(ds[n], af, bf);
        mma16816(ds[n + 1], af, bf + 2);
      }
    }
    // dS^T = P^T * (dP^T - delta)
#pragma unroll
    for (int n = 0; n < kQStep / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - delta_s[n * 8 + 2 * t + (e & 1)]);
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kQStep / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t bf[4];
        load_b_n(bf, Qs, LD, kk * 16, c0 + n * 8, lane);
        mma16816(dka[n], af, bf);
        mma16816(dka[n + 1], af, bf + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  wait_group<0>();  // the first step's copies, when no query step was walked

  bf16* dkb = dk + b * sdk.b + h * sdk.h + c0;
  bf16* dvb = dv + b * sdv.b + h * sdv.h + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kvrow[i] >= Lk) continue;
    bf16* dkrow = dkb + (long long)kvrow[i] * sdk.l;
    bf16* dvrow = dvb + (long long)kvrow[i] * sdv.l;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkrow + n * 8 + 2 * t) =
          pack_f32(dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvrow + n * 8 + 2 * t) =
          pack_f32(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <int D>
dim3 grid_of(int L, int B, int H) {
  return dim3((unsigned)B * H, (L + kTile - 1) / kTile, D / kCols<D>);
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

template <int D, bool CAUSAL>
cudaError_t run_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, const long long* st, int B, int H, int Lq,
                     int Lk, float scale, cudaStream_t stream) {
  const size_t smem =
      (2 * kTile + 4 * kQStep) * (D + kPad) * sizeof(bf16) + 4 * kQStep * sizeof(float);
  cudaError_t err = set_smem(attn_bwd_dkdv_kernel<D, CAUSAL>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<D, CAUSAL><<<grid_of<D>(Lk, B, H), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Lq, Lk, scale);
  return cudaGetLastError();
}

// Every D % 64 == 0 has a kernel; any other D gives cudaErrorInvalidValue.
bool head_dim_ok(int D) { return D >= 64 && D % 64 == 0; }

cudaError_t fwd(int D, bool causal, const void* q, const void* k, const void* v, void* o, void* lse,
                const long long* st, int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  if (D <= 256) return fwd_sm90(D, causal, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
  return fwd_wide(D, causal, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
}

cudaError_t dkdv(int D, bool causal, const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, const long long* st, int B,
                 int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!head_dim_ok(D)) return cudaErrorInvalidValue;
  if (D <= 128)
    return dkdv_sm90(D, causal, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream);
  if (D == 192)
    return causal ? run_dkdv<192, true>(q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream)
                  : run_dkdv<192, false>(q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream);
  if (D == 256)
    return causal ? run_dkdv<256, true>(q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream)
                  : run_dkdv<256, false>(q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk, scale, stream);
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
