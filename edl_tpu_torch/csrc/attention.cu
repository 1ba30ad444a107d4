// Flash attention for Hopper (sm_90a): forward, and the backward as three
// kernels (delta = rowsum(dO * O), dK/dV, dQ); causal (top-left: key j is
// visible to query i iff j <= i) or not, with Lq and Lk free.
//
// Replaces the Pallas TPU kernels that edl_tpu/ops/attention.py reaches
// (jax/experimental/pallas/ops/tpu/...):
//   _splash (lines 112-125), causal self-attention, the CAUSAL, Lq == Lk
//   instantiation behind the edl_attn_* entry points:
//   - forward   : splash_attention/splash_attention_kernel.py:1137
//   - dq        : splash_attention/splash_attention_kernel.py:1635
//   - dk / dv   : splash_attention/splash_attention_kernel.py:2196
//   _flash (lines 81-87), causal or not, Lq != Lk, behind edl_flash_*:
//   - forward   : flash_attention.py:758
//   - dk / dv   : flash_attention.py:1121
//   - dq        : flash_attention.py:1456
//   and, for both, the backward's XLA rowsum(dO * O) (edl_attn_bwd_delta).
// The TPU kernels walk a sequential grid and carry their softmax statistics
// in scratch from one grid step to the next.  Here every thread block owns
// one (batch, head, 64-row tile) and walks its loop dimension itself; blocks
// never talk to each other, so the backward needs no atomics and is
// deterministic.
//
// What bounds it on an H100: at the model's shape ([8, 1024, 6, 128] bf16)
// the causal forward is ~13 GFLOP against ~50 MB of q/k/v/o, so it sits
// slightly on the operations side of the card's ridge (~295 FLOP/byte in
// bf16), and the non-causal one twice as far.  The design keeps every score
// tile in registers (the [Lq, Lk] matrix never touches device memory),
// skips the key tiles that causal masking hides, and runs both products of
// each tile on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate), fed by ldmatrix from shared memory.  The tiles that a block
// walks over are double-buffered: cp.async brings the next one in while the
// tensor cores work on this one.  No TMA and no wgmma yet; those are later
// work.
//
// Head dims: D is 64, 128, 192 or 256.  A warp holds a 16 x (output
// columns) f32 accumulator (two in dK/dV); above D = 128 that would not fit
// in the 255 registers a thread has, so a block then owns half of the
// output columns (kCols) and the grid's z dimension covers the two halves.
// Each half recomputes the scores, which costs 1.5x the forward's and
// dK/dV's products and 1.33x dQ's at D > 128; D <= 128 is unchanged.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, L, H, D] with D contiguous and
// read through their (batch, row, head) strides, so neither the model nor the
// wrapper transposes.  The logsumexp and delta are f32 [B, H, Lq].
// Types: bf16 in and out, f32 inside.  Any Lq, Lk >= 1 (the ragged last
// tiles are masked).  sm_scale is applied in f32 to the f32 scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Strides {  // element strides of a [B, L, H, D] tensor
  long long b, l, h;
};

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;    // query rows per block (16 per warp), key rows per step
constexpr int kQStep = 32;   // query rows per step of the dK/dV kernel
constexpr int kPad = 8;      // shared-memory row padding, in bf16 elements
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
// n-tiles is the A layout of one k-chunk.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

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
    const bf16* from = src + (long long)(in ? row0 + r : 0) * sl + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(s + r * (D + kPad) + c)), "l"(from), "r"(in ? 16 : 0));
  }
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

// Output columns a block accumulates: all of D up to 128, half above it.
template <int D>
constexpr int kCols = D > 128 ? D / 2 : D;

// ---------------------------------------------------------------------------
// Forward (replaces splash_attention_kernel.py:1137 and flash_attention.py:758).
// Grid (ceil(Lq / 64), B * H, D / kCols); 4 warps, each owning 16 query rows.
// Shared memory: the Q tile, then two stages of (K tile, V tile), which
// leaves room for 2 blocks per SM up to D = 128.  Naming those 2 blocks in
// __launch_bounds__ changes nothing they may use (256 registers a thread)
// but steers ptxas to a schedule that keeps more loads in flight: more
// registers, and a faster causal forward at D = 128 on an H100.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    Strides sq, Strides sk, Strides sv, Strides so, int H, int Lq, int Lk,
                    float scale) {
  constexpr int DV = kCols<D>, LD = D + kPad, TILE = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + TILE;  // stage i: K at KVs + 2i TILE, V right after it

  const int n_tiles = (Lq + kTile - 1) / kTile;
  // causal: the last query tiles see the most keys, so they launch first
  const int q0 = (CAUSAL ? n_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x) * kTile;
  const int c0 = D == DV ? 0 : blockIdx.z * DV;  // this block's output columns
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<kTile, D>(Qs, qb, sq.l, q0, Lq);
  commit_group();
  load_tile<kTile, D>(KVs, kb, sk.l, 0, Lk);
  load_tile<kTile, D>(KVs + TILE, vb, sv.l, 0, Lk);
  commit_group();
  wait_group<1>();  // the Q tile
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], Qs, LD, warp * 16, kk * 16, lane);

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // causal: the key tiles right of the tile's last row are skipped; key 0 is
  // visible to every row, so no row is ever fully masked
  const int last = (CAUSAL ? min(q0 + kTile - 1, Lk - 1) : Lk - 1) / kTile;

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTile;
    if (j < last) {  // the next tiles load while this one computes
      bf16* next = KVs + 2 * ((j + 1) & 1) * TILE;
      load_tile<kTile, D>(next, kb, sk.l, k0 + kTile, Lk);
      load_tile<kTile, D>(next + TILE, vb, sv.l, k0 + kTile, Lk);
      commit_group();
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const bf16* Ks = KVs + 2 * (j & 1) * TILE;
    const bf16* Vs = Ks + TILE;

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        uint32_t bf[4];
        load_b_t(bf, Ks, LD, n * 8, kk * 16, lane);
        mma16816(s[n], qf[kk], bf);
        mma16816(s[n + 1], qf[kk], bf + 2);
      }
    }
    const bool edge = (CAUSAL && k0 + kTile - 1 > q0) || (k0 + kTile > Lk);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * sl2;
        if (edge && ((CAUSAL && col > row[e >> 1]) || col >= Lk)) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    }
    // l stays a per-thread partial sum; alpha is common to the quad
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t bf[4];
        load_b_n(bf, Vs, LD, kk * 16, c0 + n * 8, lane);
        mma16816(acc[n], af, bf);
        mma16816(acc[n + 1], af, bf + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* ob = o + b * so.b + h * so.h + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tot = quad_sum(l[i]);
    if (row[i] >= Lq) continue;
    const float inv = 1.f / tot;
    bf16* orow = ob + (long long)row[i] * so.l;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_f32(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (c0 == 0 && t == 0) lse[(long long)bh * Lq + row[i]] = m[i] * kLn2 + logf(tot);
  }
}

// ---------------------------------------------------------------------------
// Backward, pass 1: delta[b, h, l] = sum_d dO[b, l, h, d] * O[b, l, h, d]
// (the XLA einsums of splash_attention_kernel.py:2285 and
// flash_attention.py:273).  One warp per (b, h, l) row; it only streams O and
// dO, so it is bound by their bytes.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          float* __restrict__ delta, Strides so, Strides sdo, int H, int L,
                          long long rows) {
  const long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = r / L;
  const int i = (int)(r % L), b = (int)(bh / H), h = (int)(bh % H);
  const bf16* orow = o + b * so.b + (long long)i * so.l + h * so.h;
  const bf16* drow = dout + b * sdo.b + (long long)i * sdo.l + h * sdo.h;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------
// Backward, pass 2: dK and dV (replaces splash_attention_kernel.py:2196 and
// flash_attention.py:1121).  Grid (ceil(Lk / 64), B * H, D / kCols); each
// block owns 64 key rows (16 per warp) and walks the query steps that see
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

  const int k0 = blockIdx.x * kTile;  // causal: tile 0 walks the most query steps: launched first
  const int c0 = D == DV ? 0 : blockIdx.z * DV;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
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

// ---------------------------------------------------------------------------
// Backward, pass 3: dQ (replaces splash_attention_kernel.py:1635 and
// flash_attention.py:1456).  Grid (ceil(Lq / 64), B * H, D / kCols); each
// block owns 64 query rows and walks the key tiles they see.  Shared memory:
// the Q and dO tiles, then two stages of (K tile, V tile).
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdq, int H, int Lq, int Lk, float scale) {
  constexpr int DV = kCols<D>, LD = D + kPad, TILE = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE;
  bf16* KVs = dOs + TILE;  // stage i: K at KVs + 2i TILE, V right after it

  const int n_tiles = (Lq + kTile - 1) / kTile;
  const int q0 = (CAUSAL ? n_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x) * kTile;
  const int c0 = D == DV ? 0 : blockIdx.z * DV;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  load_tile<kTile, D>(Qs, q + b * sq.b + h * sq.h, sq.l, q0, Lq);
  load_tile<kTile, D>(dOs, dout + b * sdo.b + h * sdo.h, sdo.l, q0, Lq);
  load_tile<kTile, D>(KVs, kb, sk.l, 0, Lk);
  load_tile<kTile, D>(KVs + TILE, vb, sv.l, 0, Lk);
  commit_group();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = row[i] < Lq ? lse[(long long)bh * Lq + row[i]] * kLog2e : 0.f;
    dlt[i] = row[i] < Lq ? delta[(long long)bh * Lq + row[i]] : 0.f;
  }
  float dqa[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl2 = scale * kLog2e;
  const int last = (CAUSAL ? min(q0 + kTile - 1, Lk - 1) : Lk - 1) / kTile;

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * kTile;
    if (j < last) {  // the next tiles load while this one computes
      bf16* next = KVs + 2 * ((j + 1) & 1) * TILE;
      load_tile<kTile, D>(next, kb, sk.l, k0 + kTile, Lk);
      load_tile<kTile, D>(next + TILE, vb, sv.l, k0 + kTile, Lk);
      commit_group();
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const bf16* Ks = KVs + 2 * (j & 1) * TILE;
    const bf16* Vs = Ks + TILE;

    float p[kTile / 8][4], ds[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    }
    // S = Q K^T and dP = dO V^T
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, Qs, LD, warp * 16, kk * 16, lane);
      load_a(ado, dOs, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        uint32_t bk[4], bv[4];
        load_b_t(bk, Ks, LD, n * 8, kk * 16, lane);
        load_b_t(bv, Vs, LD, n * 8, kk * 16, lane);
        mma16816(p[n], aq, bk);
        mma16816(p[n + 1], aq, bk + 2);
        mma16816(ds[n], ado, bv);
        mma16816(ds[n + 1], ado, bv + 2);
      }
    }
    const bool edge = (CAUSAL && k0 + kTile - 1 > q0) || (k0 + kTile > Lk);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1), i = e >> 1;
        float x = exp2f(p[n][e] * sl2 - lse2[i]);
        if (edge && ((CAUSAL && col > row[i]) || col >= Lk)) x = 0.f;
        ds[n][e] = x * (ds[n][e] - dlt[i]);
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DV / 8; n += 2) {
        uint32_t bf[4];
        load_b_n(bf, Ks, LD, kk * 16, c0 + n * 8, lane);
        mma16816(dqa[n], af, bf);
        mma16816(dqa[n + 1], af, bf + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Lq) continue;
    bf16* dqrow = dqb + (long long)row[i] * sdq.l;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dqrow + n * 8 + 2 * t) =
          pack_f32(dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
    }
  }
}

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

// Raise the dynamic shared-memory limit of an instantiation, then launch.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
dim3 grid_of(int L, int B, int H) {
  return dim3((L + kTile - 1) / kTile, B * H, D / kCols<D>);
}

// One launcher per kernel; dispatch() picks the instantiation.
struct Fwd {
  template <int D, bool CAUSAL>
  static cudaError_t run(const void* q, const void* k, const void* v, void* o, void* lse,
                         const long long* st, int B, int H, int Lq, int Lk, float scale,
                         cudaStream_t stream) {
    const size_t smem = 5 * kTile * (D + kPad) * sizeof(bf16);
    cudaError_t err = prepare(attn_fwd_kernel<D, CAUSAL>, smem);
    if (err != cudaSuccess) return err;
    attn_fwd_kernel<D, CAUSAL><<<grid_of<D>(Lq, B, H), kThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), H, Lq, Lk,
        scale);
    return cudaGetLastError();
  }
};

struct BwdDelta {
  template <int D, bool>
  static cudaError_t run(const void* o, const void* dout, void* delta, const long long* st,
                         int B, int H, int L, cudaStream_t stream) {
    const long long rows = (long long)B * H * L;
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    attn_bwd_delta_kernel<D><<<blocks, kThreads, 0, stream>>>(
        (const bf16*)o, (const bf16*)dout, (float*)delta, strides_at(st, 0), strides_at(st, 1),
        H, L, rows);
    return cudaGetLastError();
  }
};

struct BwdDkdv {
  template <int D, bool CAUSAL>
  static cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv,
                         const long long* st, int B, int H, int Lq, int Lk, float scale,
                         cudaStream_t stream) {
    const size_t smem =
        (2 * kTile + 4 * kQStep) * (D + kPad) * sizeof(bf16) + 4 * kQStep * sizeof(float);
    cudaError_t err = prepare(attn_bwd_dkdv_kernel<D, CAUSAL>, smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dkdv_kernel<D, CAUSAL><<<grid_of<D>(Lk, B, H), kThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        (const float*)delta, (bf16*)dk, (bf16*)dv, strides_at(st, 0), strides_at(st, 1),
        strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Lq, Lk,
        scale);
    return cudaGetLastError();
  }
};

struct BwdDq {
  template <int D, bool CAUSAL>
  static cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, const long long* st,
                         int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
    const size_t smem = 6 * kTile * (D + kPad) * sizeof(bf16);
    cudaError_t err = prepare(attn_bwd_dq_kernel<D, CAUSAL>, smem);
    if (err != cudaSuccess) return err;
    attn_bwd_dq_kernel<D, CAUSAL><<<grid_of<D>(Lq, B, H), kThreads, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        (const float*)delta, (bf16*)dq, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), strides_at(st, 4), H, Lq, Lk, scale);
    return cudaGetLastError();
  }
};

// Op::run<D, causal>(args...) for a head dim the kernels take; any other D
// gives cudaErrorInvalidValue.
template <typename Op, typename... Args>
int dispatch(int D, bool causal, Args... args) {
  switch (D) {
    case 64:
      return causal ? Op::template run<64, true>(args...) : Op::template run<64, false>(args...);
    case 128:
      return causal ? Op::template run<128, true>(args...) : Op::template run<128, false>(args...);
    case 192:
      return causal ? Op::template run<192, true>(args...) : Op::template run<192, false>(args...);
    case 256:
      return causal ? Op::template run<256, true>(args...) : Op::template run<256, false>(args...);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success); an unsupported D
// returns cudaErrorInvalidValue.  `st` holds (batch, row, head) element
// strides, three per tensor, in the order the tensors are listed.  The
// edl_attn_* forward, dK/dV and dQ are causal self-attention (L = Lq = Lk);
// the edl_flash_* ones take Lq, Lk and `causal`.
extern "C" {

int edl_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                 const long long* st, int B, int H, int L, int D, float scale, void* stream) {
  return dispatch<Fwd>(D, true, q, k, v, o, lse, st, B, H, L, L, scale, (cudaStream_t)stream);
}

int edl_attn_bwd_delta(const void* o, const void* dout, void* delta, const long long* st, int B,
                       int H, int L, int D, void* stream) {
  return dispatch<BwdDelta>(D, true, o, dout, delta, st, B, H, L, (cudaStream_t)stream);
}

int edl_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv,
                      const long long* st, int B, int H, int L, int D, float scale,
                      void* stream) {
  return dispatch<BwdDkdv>(D, true, q, k, v, dout, lse, delta, dk, dv, st, B, H, L, L, scale,
                           (cudaStream_t)stream);
}

int edl_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, const long long* st, int B,
                    int H, int L, int D, float scale, void* stream) {
  return dispatch<BwdDq>(D, true, q, k, v, dout, lse, delta, dq, st, B, H, L, L, scale,
                         (cudaStream_t)stream);
}

int edl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                  const long long* st, int B, int H, int Lq, int Lk, int D, int causal,
                  float scale, void* stream) {
  return dispatch<Fwd>(D, causal != 0, q, k, v, o, lse, st, B, H, Lq, Lk, scale,
                       (cudaStream_t)stream);
}

int edl_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const long long* st, int B, int H, int Lq, int Lk, int D, int causal,
                       float scale, void* stream) {
  return dispatch<BwdDkdv>(D, causal != 0, q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk,
                           scale, (cudaStream_t)stream);
}

int edl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, const long long* st, int B,
                     int H, int Lq, int Lk, int D, int causal, float scale, void* stream) {
  return dispatch<BwdDq>(D, causal != 0, q, k, v, dout, lse, delta, dq, st, B, H, Lq, Lk, scale,
                         (cudaStream_t)stream);
}

}  // extern "C"
