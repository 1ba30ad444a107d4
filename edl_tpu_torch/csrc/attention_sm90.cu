// The attention forward, dK/dV and dQ with delta = rowsum(dO * O) folded
// in, at D = 64, 128, 192 and 256, and dK/dV at D = 320 and 384, for
// Hopper: TMA tile loads into an mbarrier ring, wgmma products, one
// producer warpgroup and two consumer warpgroups.
//
// Replaces, behind the C entry points of attention.cu:
//   forward (edl_attn_fwd, edl_flash_fwd):
//     splash_attention/splash_attention_kernel.py:1137 and flash_attention.py:758
//   dK/dV (edl_attn_bwd_dkdv, edl_flash_bwd_dkdv):
//     splash_attention/splash_attention_kernel.py:2196 and flash_attention.py:1121
//   dQ (edl_attn_bwd_dq, edl_flash_bwd_dq):
//     splash_attention/splash_attention_kernel.py:1635 and flash_attention.py:1456,
//     with the XLA rowsum(dO * O) of splash_attention_kernel.py:2285 and
//     flash_attention.py:273
// (jax/experimental/pallas/ops/tpu/, reached from edl_tpu/ops/attention.py
// _splash and _flash).  The TPU kernels walk a sequential grid and carry
// their statistics in scratch; here a block owns one (batch, head, 128-row
// tile) and walks the other dimension itself, so blocks never talk to each
// other: no atomics, and the backward is deterministic.
//
// What bounds them on an H100: at the flagship shape [8, 1024, 6, 128] bf16
// the forward does 4 Lq Lk D flops per (b, h) on ~50 MB of q/k/v/o, which
// puts the non-causal forward and every backward kernel on the operations
// side of the card's ridge and the causal forward near it.  So the design
// is about keeping the tensor cores fed:
//   - wgmma (m64nNk16, bf16 in, f32 accumulate) for every product: the
//     only instruction that reaches the tensor cores' full rate on sm_90.
//     The score products read both operands from shared memory (K-major,
//     as the tensors are stored); P V, P^T dO, dS^T Q and dS K take P /
//     P^T / dS^T / dS from registers and V / dO / Q / K as transposed
//     (MN-major) B operands, so nothing is transposed in memory.
//   - Two consumer warpgroups of 64 rows each share every tile in shared
//     memory, so each K/V (forward, dQ) or Q/dO (dK/dV up to D = 128) byte
//     staged there feeds 128 rows.
//   - One producer warpgroup: one thread issues the TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, the layout wgmma reads)
//     into a ring of stages guarded by full/empty mbarriers, so the next
//     tiles load while the consumers compute.  setmaxnreg moves registers
//     from the producer (24) to the consumers (240).
//   - Tensor maps are 4-D {D, H, L, B} over the [B, L, H, D] tensors with
//     their byte strides; rows past L arrive zero-filled.  The column
//     mask (col >= Lk) and the causal mask (top-left: key j is visible to
//     query i iff j <= i) are applied to the f32 scores.
//   - The online softmax runs in f32 registers, in the log2 domain, with
//     the scale applied to the f32 scores.
//   - Forward ping-pong: in its turn a consumer issues tile j's S = Q K^T
//     and tile j - 1's O += P V back to back, hands the turn to the other
//     consumer (an mbarrier pair), and runs tile j's softmax while the
//     other's products hold the tensor cores.  K and V stages are released
//     separately (K after S, V after P V), and the producer loads in the
//     order they are taken (K of tile j, then V of tile j - 1).  On the
//     H100 this was faster, at every shape timed, than the same kernel
//     without turns (each consumer S, softmax, P V in order), which was in
//     turn faster than issuing S with P V without turns.  The wgmma issues
//     sit outside any branch: ptxas serialises wgmma in a divergent path
//     (warning C7520), which made a first version slower.
//   - dQ ping-pong (up to D = 128, kPingPong below): two turns per key
//     tile, one issuing S and dP, one issuing dQ += dS K (holding dS of
//     one tile while the next tile's S and dP accumulate, as the forward
//     holds P, would not fit the registers at D = 128).
//   - dQ compiles its masks (causal, col >= Lk) only into the tiles that
//     need them: the key loop runs the tiles every row of the warpgroup
//     sees, then the masked ones.  With one body and a runtime flag, as the
//     forward and dK/dV up to D = 128 still have, the causal dQ took as
//     long as the non-causal one.
//   - dQ computes delta for its rows before its key loop, from O and dO in
//     device memory, while the producer's first tiles load, and writes it
//     for dK/dV: the backward is two launches, not three.
//   - dK/dV at D = 192 and 256 compiles its causal mask only into the one
//     query step that needs it, as dQ does; up to D = 128 it still masks
//     through a runtime flag.
// Causal: query tiles launch longest first; key tiles right of a
// warpgroup's last row are skipped (key 0 is visible to every row, so no
// row is ever fully masked).  dK/dV: a key tile no query sees (k0 >= Lq)
// writes zeros.
//
// Head dims: the forward holds a 64 x D f32 accumulator per warpgroup (D/2
// registers a thread) beside the 64 x kBlockN scores: kBlockN = 128 up to
// D = 128 and 64 above it keeps them under 240 registers.  dQ holds the
// same accumulator beside S and dP (kBlockN each), with kBlockN = 128, 64
// and 32 at D <= 128, 192 and 256.  dK/dV up to D = 128 holds two 64 x D
// accumulators per consumer (D registers a thread); at D = 192 and 256
// that would be 192 and 256 of the 240, so there a block owns 64 keys and
// its consumers split the outputs: one accumulates dV, the other dK, each
// 64 x D (D/2 registers a thread), with P^T passed between them through
// shared memory (attn_dkdv_split_sm90_kernel).  From D = 320 on, one
// consumer's 64 x D output would not fit either: two blocks split the
// output columns and each runs that kernel's roles on its half
// (attn_dkdv_chunk_sm90_kernel).

#include <type_traits>

#include "sm90.cuh"

namespace edl_attn {
namespace {

// ---------------------------------------------------------------------------
// Forward.  Grid (B * H, ceil(Lq / 128)); block = producer + 2 consumer
// warpgroups, consumer c owning query rows q0 + 64c .. + 63.  Shared
// memory (with 1 KB of alignment slack): Q, then 2 stages of (K tile, V
// tile), then the barriers: 164,952 bytes at D = 128, 197,720 at D = 256.

template <int D>
struct FwdCfg {
  static constexpr int kBlockM = 128, kBlockN = D <= 128 ? 128 : 64, kStages = 2;
  static constexpr int kQBytes = kBlockM * D * 2, kKVBytes = kBlockN * D * 2;
  // Q, then per stage K and V, then the barriers; 1 KB of slack to align
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (3 + 4 * kStages);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                         float* __restrict__ lse, Strides so, int H, int Lq, int Lk, float scale) {
  using C = FwdCfg<D>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, S = C::kStages, KV = C::kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;  // stage s: K at sKV + 2 s KV, V after it
  const uint32_t bars = sKV + 2 * S * KV;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + S + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * S + s); };
  auto turn = [&](int c) { return bars + 8 * (1 + 4 * S + c); };  // consumer c may issue

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Lq + BM - 1) / BM;
  // causal: the last query tiles see the most keys, so they launch first
  const int q0 = (CAUSAL ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int n_kt = (CAUSAL ? min(q0 + BM - 1, Lk - 1) : Lk - 1) / BN + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * kWgThreads);
      mbar_init(v_empty(s), 2 * kWgThreads);
    }
    mbar_init(turn(0), kWgThreads);
    mbar_init(turn(1), kWgThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < D / 64; ++c) tma_load(sQ + c * BM * kRowBytes, &tq, q_full, c * 64, h, q0, b);
      // in the order the consumers take them: K of tile j with V of tile j - 1
      for (int j = 0; j <= n_kt; ++j) {
        if (j < n_kt) {
          const int s = j % S;
          mbar_wait(k_empty(s), ((j / S) & 1) ^ 1);
          mbar_expect_tx(k_full(s), KV);
          for (int c = 0; c < D / 64; ++c)
            tma_load(sKV + 2 * s * KV + c * BN * kRowBytes, &tk, k_full(s), c * 64, h, j * BN, b);
        }
        if (j > 0) {
          const int i = j - 1, s = i % S;
          mbar_wait(v_empty(s), ((i / S) & 1) ^ 1);
          mbar_expect_tx(v_full(s), KV);
          for (int c = 0; c < D / 64; ++c)
            tma_load(sKV + 2 * s * KV + KV + c * BN * kRowBytes, &tv, v_full(s), c * 64, h, i * BN, b);
        }
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + cw * 64;  // this warpgroup's first row
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  // causal: key tiles right of this warpgroup's last row hold no visible key
  const int my_kt = CAUSAL ? min(r0 + 63, Lk - 1) / BN + 1 : n_kt;
  // a tile from key k0 on needs the masks (a runtime flag in one tile body)
  auto edge = [&](int k0) { return (CAUSAL && k0 + BN - 1 > r0) || (k0 + BN > Lk); };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  float sc[BN / 8][4];               // S of the tile in hand, then its P in f32
  uint32_t pf[BN / 16][4];           // P in bf16, as A fragments
  auto kt_of = [&](int j) { return sKV + 2 * (j % S) * KV; };
  auto ph_of = [&](int j) { return (uint32_t)((j / S) & 1); };

  mbar_wait(q_full, 0);
  // Turn k issues tile k's S = Q K^T and tile k - 1's O += P V; the two
  // consumers take turns (turn barriers), so one's softmax runs while the
  // other's products hold the tensor cores.  Both take n_kt + 1 turns.
  if (cw == 1) mbar_arrive(turn(0));  // consumer 0 goes first
  // turn 0: S of tile 0
  mbar_wait(k_full(0), 0);
  mbar_wait(turn(cw), 0);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BN>(sc, kmajor(sQ, BM, cw * 64, kk), kmajor(kt_of(0), BN, 0, kk), kk > 0);
  wg_commit();
  mbar_arrive(turn(1 - cw));
  wg_wait<0>();
  fence_acc(sc);
  mbar_arrive(k_empty(0));
  softmax_tile<BN, CAUSAL>(sc, m, l, alpha, 0, row, Lk, sl2, t, edge(0));
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pf[kk], sc[2 * kk], sc[2 * kk + 1]);
  // turns 1 .. my_kt - 1: S of tile k, then P V of tile k - 1
  for (int k = 1; k < my_kt; ++k) {
    mbar_wait(k_full(k % S), ph_of(k));
    mbar_wait(v_full((k - 1) % S), ph_of(k - 1));
    mbar_wait(turn(cw), k & 1);
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(sc, kmajor(sQ, BM, cw * 64, kk), kmajor(kt_of(k), BN, 0, kk), kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb<D>(acc, pf[kk], mnmajor(kt_of(k - 1) + KV, BN, kk), 1);
    wg_commit();
    mbar_arrive(turn(1 - cw));
    wg_wait<1>();  // S of tile k
    fence_acc(sc);
    mbar_arrive(k_empty(k % S));
    softmax_tile<BN, CAUSAL>(sc, m, l, alpha, k * BN, row, Lk, sl2, t, edge(k * BN));
    wg_wait<0>();  // P V of tile k - 1
    fence_acc(acc);
    mbar_arrive(v_empty((k - 1) % S));
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pf[kk], sc[2 * kk], sc[2 * kk + 1]);
  }
  // turn my_kt: P V of the last tile
  mbar_wait(v_full((my_kt - 1) % S), ph_of(my_kt - 1));
  mbar_wait(turn(cw), my_kt & 1);
  fence_acc(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_tb<D>(acc, pf[kk], mnmajor(kt_of(my_kt - 1) + KV, BN, kk), 1);
  wg_commit();
  mbar_arrive(turn(1 - cw));
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive(v_empty((my_kt - 1) % S));
  // causal: tiles right of these rows hold no visible key; release them in
  // order, and take their turns so that both consumers take n_kt + 1
  for (int k = my_kt; k < n_kt; ++k) {
    mbar_wait(k_full(k % S), ph_of(k));
    mbar_arrive(k_empty(k % S));
    mbar_wait(v_full(k % S), ph_of(k));
    mbar_arrive(v_empty(k % S));
    mbar_wait(turn(cw), (k + 1) & 1);
    mbar_arrive(turn(1 - cw));
  }

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tot = quad_sum(l[i]);
    if (row[i] >= Lq) continue;
    const float inv = 1.f / tot;
    bf16* orow = ob + (long long)row[i] * so.l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_f32(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (t == 0) lse[(long long)bh * Lq + row[i]] = m[i] * kLn2 + logf(tot);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: what the kernels below share.  A block owns kBlockN keys; its
// producer warpgroup loads K and V once, then streams (Q, dO) steps of
// kBlockM queries through the ring; its first warp also copies each step's lse
// (times log2 e; +inf past Lq, which zeroes those rows' P^T) and delta into
// the stage.  A Cfg gives the tiles and, as byte offsets from the aligned
// base of shared memory, where stage s's Q step lies (its dO step follows
// it: q_off), its lse2[BM] and delta[BM] (stat_off), and the barriers
// (kBarOff): K and V loaded, then full and empty per stage, then the
// kernel's own.

template <int S>
__device__ __forceinline__ uint32_t dkdv_full(uint32_t bars, int s) { return bars + 8 * (1 + s); }
template <int S>
__device__ __forceinline__ uint32_t dkdv_empty(uint32_t bars, int s) { return bars + 8 * (1 + S + s); }

// The barriers, then n_extra more after them, each counting the arrivals of
// one consumer warpgroup.
template <int S>
__device__ __forceinline__ void dkdv_init_barriers(uint32_t bars, int n_extra) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(dkdv_full<S>(bars, s), 1 + 32);  // the TMA thread's expect_tx + the first warp's stats
      mbar_init(dkdv_empty<S>(bars, s), 2 * kWgThreads);
    }
    for (int j = 0; j < n_extra; ++j) mbar_init(bars + 8 * (1 + 2 * S + j), kWgThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup: its first warp loads and copies n_steps query
// steps from query i0 * BM on; the other warps leave at once.
template <int D, class C>
__device__ __forceinline__ void dkdv_produce(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const CUtensorMap* tdo,
                                             const float* lse, const float* delta, unsigned char* base,
                                             int bh, int b, int h, int k0, int i0, int n_steps, int Lq) {
  constexpr int BN = C::kBlockN, BM = C::kBlockM, S = C::kStages, STEP = C::kStepBytes;
  regs_dealloc<kProducerRegs>();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const uint32_t sK = smem_u32(base), sV = sK + C::kKVBytes, bars = sK + C::kBarOff;
  const float* lse_b = lse + (long long)bh * Lq;
  const float* delta_b = delta + (long long)bh * Lq;
  if (lane == 0 && n_steps > 0) {
    mbar_expect_tx(bars, 2 * C::kKVBytes);
    for (int c = 0; c < D / 64; ++c) {
      tma_load(sK + c * BN * kRowBytes, tk, bars, c * 64, h, k0, b);
      tma_load(sV + c * BN * kRowBytes, tv, bars, c * 64, h, k0, b);
    }
  }
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % S, q0 = (i0 + it) * BM;
    const uint32_t full = dkdv_full<S>(bars, s), sq = sK + C::q_off(s);
    mbar_wait(dkdv_empty<S>(bars, s), ((it / S) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(full, 2 * STEP);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sq + c * BM * kRowBytes, tq, full, c * 64, h, q0, b);
        tma_load(sq + STEP + c * BM * kRowBytes, tdo, full, c * 64, h, q0, b);
      }
    }
    float* st = reinterpret_cast<float*>(base + C::stat_off(s));
    for (int i = lane; i < BM; i += 32) {
      const int qi = q0 + i;
      st[i] = qi < Lq ? lse_b[qi] * kLog2e : INFINITY;
      st[BM + i] = qi < Lq ? delta_b[qi] : 0.f;
    }
    mbar_arrive(full);
  }
}

// This thread's rows[i] (those below Lk) of a 64 x W f32 accumulator, times
// mul, in bf16 to out (row stride ld), from column 8 n_from on.
template <int W>
__device__ __forceinline__ void dkdv_store(const float (&acc)[W / 8][4], bf16* out, long long ld,
                                           const int (&rows)[2], int Lk, float mul, int t,
                                           int n_from = 0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Lk) continue;
    bf16* orow = out + (long long)rows[i] * ld;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      if (n >= n_from)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_f32(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// dK and dV up to D = 128.  Grid (B * H, ceil(Lk / 128)); consumer c owns
// key rows k0 + 64c .. + 63 and both walk the query steps that see the
// block's keys, recomputing P^T from q, k and the saved logsumexp.  Shared
// memory: K, V, then 2 stages of (Q step, dO step, lse, delta): 133,160
// bytes at D = 128.

template <int D>
struct DkdvCfg {
  static constexpr int kBlockN = 128, kBlockM = 64, kStages = 2, kChunks = 1;
  static constexpr int kKVBytes = kBlockN * D * 2, kStepBytes = kBlockM * D * 2;
  static constexpr int kStageBytes = 2 * kStepBytes + 2 * kBlockM * 4;  // Q, dO, lse, delta
  static constexpr int kBarOff = 2 * kKVBytes + kStages * kStageBytes;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (1 + 2 * kStages);
  __host__ __device__ static constexpr int q_off(int s) { return 2 * kKVBytes + s * kStageBytes; }
  __host__ __device__ static constexpr int stat_off(int s) { return q_off(s) + 2 * kStepBytes; }
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv,
                          int H, int Lq, int Lk, float scale) {
  using C = DkdvCfg<D>;
  constexpr int BN = C::kBlockN, BM = C::kBlockM, S = C::kStages, STEP = C::kStepBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const aligned = align_1k(smem_raw);
  const uint32_t sK = smem_u32(aligned), sV = sK + C::kKVBytes, bars = sK + C::kBarOff;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BN;  // causal: key tile 0 walks the most steps: launched first
  const int i0 = CAUSAL ? k0 / BM : 0;  // queries before k0 never see these keys
  const int n_steps = max(0, (Lq + BM - 1) / BM - i0);

  dkdv_init_barriers<S>(bars, 0);
  if (threadIdx.x < kWgThreads) {
    dkdv_produce<D, C>(&tq, &tk, &tv, &tdo, lse, delta, aligned, bh, b, h, k0, i0, n_steps, Lq);
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + cw * 64;  // this warpgroup's first key
  const int kvrow[2] = {kr0 + warp * 16 + g, kr0 + warp * 16 + g + 8};
  const float sl2 = scale * kLog2e;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  if (n_steps > 0) mbar_wait(bars, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % S, q0 = (i0 + it) * BM;
    const uint32_t sq = sK + C::q_off(s), sdo = sq + STEP;
    mbar_wait(dkdv_full<S>(bars, s), (it / S) & 1);
    if (!CAUSAL || q0 + BM - 1 >= kr0) {  // else no query of the step sees these keys
      const float* lse2 = reinterpret_cast<const float*>(aligned + C::stat_off(s));
      const float* dlt = lse2 + BM;
      // S^T = K Q^T and dP^T = V dO^T for 64 keys x 64 queries
      float st[BM / 8][4], dpt[BM / 8][4];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM>(st, kmajor(sK, BN, cw * 64, kk), kmajor(sq, BM, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BM>(dpt, kmajor(sV, BN, cw * 64, kk), kmajor(sdo, BM, 0, kk), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      // P^T = exp2(S^T scale log2 e - lse2), dS^T = P^T (dP^T - delta)
      const bool edge = CAUSAL && q0 < kr0 + 64;
      uint32_t pf[BM / 16][4], dsf[BM / 16][4];
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t + (e & 1);
          float x = exp2f(st[n][e] * sl2 - lse2[ql]);
          if (edge && q0 + ql < kvrow[e >> 1]) x = 0.f;
          st[n][e] = x;
          dpt[n][e] = x * (dpt[n][e] - dlt[ql]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        acc_to_a(pf[kk], st[2 * kk], st[2 * kk + 1]);
        acc_to_a(dsf[kk], dpt[2 * kk], dpt[2 * kk + 1]);
      }
      // dV += P^T dO, dK += dS^T Q
      fence_acc(dva);
      fence_acc(dka);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs_tb<D>(dva, pf[kk], mnmajor(sdo, BM, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs_tb<D>(dka, dsf[kk], mnmajor(sq, BM, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_acc(dva);
      fence_acc(dka);
    }
    mbar_arrive(dkdv_empty<S>(bars, s));
  }

  dkdv_store<D>(dka, dk + b * sdk.b + h * sdk.h, sdk.l, kvrow, Lk, scale, t);
  dkdv_store<D>(dva, dv + b * sdv.b + h * sdv.h, sdv.l, kvrow, Lk, 1.f, t);
}

// ---------------------------------------------------------------------------
// dK and dV at D = 192 .. 384.  The form above holds two 64 x D f32
// accumulators per consumer, D registers a thread; here the consumers split
// the output instead: a block owns 64 keys, consumer 0 accumulates their dV
// and consumer 1 their dK, each 64 x W (W / 2 registers a thread).  Grid
// (B * H, ceil(Lk / 64), kChunks).  Per query step of kBlockM rows,
// consumer 0 computes S^T = K Q^T and P^T, hands P^T (f32) to consumer 1
// through a shared buffer, and runs dV += P^T dO; consumer 1 computes dP^T
// = V dO^T, takes P^T, forms dS^T = P^T (dP^T - delta) and runs dK += dS^T
// Q.  So each consumer issues one m64n(kBlockM) score product (both
// operands from shared memory) and one m64nW product (A from registers, B
// the stage's dO / Q read MN-major) a step, and the tensor cores take one
// consumer's products while the other computes P^T or dS^T.  The P^T
// buffer is double-buffered between two mbarrier pairs, so consumer 0 can
// run a step ahead.  Causal: the block's first 64 / kBlockM steps (queries
// k0 .. k0 + 63) are the only ones with a query before a key; only their
// body is compiled with the mask.
//   - attn_dkdv_split_sm90_kernel, D = 192 and 256: W = D, 64-query steps.
//     Shared memory: K, V, 2 stages of (Q step, dO step), 2 P^T buffers, 2
//     stages of (lse2, delta), the barriers: 231,496 bytes at D = 256,
//     182,344 at 192.
//   - attn_dkdv_chunk_sm90_kernel, D = 320 and 384: one 64 x D f32 output
//     is 80 to 96 KB, 160 to 192 registers a thread, so the output columns
//     are split across two blocks (grid z) in chunks of W = 192; chunk 1
//     starts D - W columns in, and at D = 320 computes the middle
//     64-column box again and does not store it.  Both score products
//     still reduce over the whole D, so a block does them for its chunk:
//     1.5 times the products the bound counts at D = 384.  K and V stay
//     resident (64 x D each), with 32-query steps.  Shared memory: 181,832
//     / 214,600 bytes at D = 320 / 384.  At D = 448 and 512 the cluster
//     kernel of attention_bwd_cluster_sm90.cu, which does every product
//     once, is faster (this kernel needed 16-query steps there); at 320
//     and 384 this one is (PERF.md).

// BM queries a step; W output columns a block accumulates, CHUNKS blocks
// in z
template <int D, int BM, int W, int CHUNKS>
struct DkdvOutSplitCfg {
  static constexpr int kBlockN = 64, kBlockM = BM, kStages = 2, kW = W, kChunks = CHUNKS;
  static constexpr int kKVBytes = kBlockN * D * 2, kStepBytes = kBlockM * D * 2;
  static constexpr int kPBytes = kBlockN * kBlockM * 4;  // one f32 P^T buffer
  static constexpr int kStatBytes = 2 * kBlockM * 4;      // one stage's lse2 and delta
  static constexpr int kPOff = 2 * kKVBytes + 2 * kStages * kStepBytes;  // P^T buffer j: + j kPBytes
  static constexpr int kBarOff = kPOff + 2 * kPBytes + kStages * kStatBytes;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (5 + 2 * kStages);
  __host__ __device__ static constexpr int q_off(int s) { return 2 * kKVBytes + 2 * s * kStepBytes; }
  __host__ __device__ static constexpr int stat_off(int s) { return kPOff + 2 * kPBytes + s * kStatBytes; }
};

template <int D>
using DkdvSplitCfg = DkdvOutSplitCfg<D, 64, D, 1>;
template <int D>
using DkdvChunkCfg = DkdvOutSplitCfg<D, 32, 192, 2>;

template <int D, class C, bool CAUSAL>
__device__ __forceinline__ void dkdv_split_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                                const CUtensorMap* tv, const CUtensorMap* tdo,
                                                const float* __restrict__ lse, const float* __restrict__ delta,
                                                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
                                                Strides sdv, int H, int Lq, int Lk, float scale) {
  constexpr int BN = C::kBlockN, BM = C::kBlockM, S = C::kStages, STEP = C::kStepBytes, W = C::kW;
  constexpr int kMaskSteps = BN / BM;  // causal: the steps whose queries start before the keys end
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const aligned = align_1k(smem_raw);
  const uint32_t sK = smem_u32(aligned), sV = sK + C::kKVBytes, bars = sK + C::kBarOff;
  auto p_full = [&](int j) { return bars + 8 * (1 + 2 * S + j); };   // P^T of buffer j written
  auto p_empty = [&](int j) { return bars + 8 * (3 + 2 * S + j); };  // P^T of buffer j taken

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BN;  // causal: key tile 0 walks the most steps: launched first
  const int i0 = CAUSAL ? k0 / BM : 0;  // queries before k0 never see these keys
  const int n_steps = max(0, (Lq + BM - 1) / BM - i0);
  // this block's output columns: boxes cb0 .. cb0 + W / 64 - 1 of D
  const int cb0 = (int)blockIdx.z * (D / 64 - W / 64);

  dkdv_init_barriers<S>(bars, 4);
  if (threadIdx.x < kWgThreads) {
    dkdv_produce<D, C>(tq, tk, tv, tdo, lse, delta, aligned, bh, b, h, k0, i0, n_steps, Lq);
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int kr[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's keys, from k0
  const float sl2 = scale * kLog2e;

  float acc[W / 8][4];  // consumer 0: dV; consumer 1: dK (before the scale)
#pragma unroll
  for (int n = 0; n < W / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // One query step.  The masked body (causal, the block's first kMaskSteps
  // steps, whose queries q0 + ql = k0 + it BM + ql see key k0 + kr iff
  // kr <= it BM + ql) is compiled only for those steps (MaskTag<true>).
  auto step = [&](int it, auto mask_tag) {
    constexpr bool kMask = decltype(mask_tag)::kOn;
    const int s = it % S, j = it & 1;
    const uint32_t sq = sK + C::q_off(s), sdo = sq + STEP;
    // this thread's slots of P^T buffer j: element block n at pbuf[n * kWgThreads]
    float4* pbuf = reinterpret_cast<float4*>(aligned + C::kPOff + j * C::kPBytes) + tid;
    mbar_wait(dkdv_full<S>(bars, s), (it / S) & 1);
    const float* lse2 = reinterpret_cast<const float*>(aligned + C::stat_off(s));
    const float* dlt = lse2 + BM;
    // consumer 0: S^T = K Q^T; consumer 1: dP^T = V dO^T (64 keys x BM queries)
    float x[BM / 8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BM>(x, kmajor(cw == 0 ? sK : sV, BN, 0, kk), kmajor(cw == 0 ? sq : sdo, BM, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_acc(x);
    if (cw == 0) {
      // P^T = exp2(S^T scale log2 e - lse2), handed to consumer 1 in f32
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t + (e & 1);
          float p = exp2f(x[n][e] * sl2 - lse2[ql]);
          if constexpr (kMask) {
            if (it * BM + ql < kr[e >> 1]) p = 0.f;
          }
          x[n][e] = p;
        }
      }
      mbar_wait(p_empty(j), ((it >> 1) & 1) ^ 1);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) pbuf[n * kWgThreads] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
      mbar_arrive(p_full(j));
    } else {
      // dS^T = P^T (dP^T - delta)
      mbar_wait(p_full(j), (it >> 1) & 1);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n) {
        const float4 p = pbuf[n * kWgThreads];
        const int ql = n * 8 + 2 * t;
        x[n][0] = p.x * (x[n][0] - dlt[ql]);
        x[n][1] = p.y * (x[n][1] - dlt[ql + 1]);
        x[n][2] = p.z * (x[n][2] - dlt[ql]);
        x[n][3] = p.w * (x[n][3] - dlt[ql + 1]);
      }
      mbar_arrive(p_empty(j));
    }
    uint32_t af[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) acc_to_a(af[kk], x[2 * kk], x[2 * kk + 1]);
    // consumer 0: dV += P^T dO; consumer 1: dK += dS^T Q (this block's columns)
    const uint32_t sb = (cw == 0 ? sdo : sq) + cb0 * BM * kRowBytes;
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) wgmma_rs_tb<W>(acc, af[kk], mnmajor(sb, BM, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive(dkdv_empty<S>(bars, s));
  };
  if (n_steps > 0) {
    mbar_wait(bars, 0);
    int it = 0;
    if constexpr (CAUSAL) {
      for (; it < min(kMaskSteps, n_steps); ++it) step(it, MaskTag<true>{});
    }
    for (; it < n_steps; ++it) step(it, MaskTag<false>{});
  }

  // chunk 1 leaves the columns chunk 0 stores (the middle box at an odd count)
  const Strides so = cw == 0 ? sdv : sdk;
  const int rows[2] = {k0 + kr[0], k0 + kr[1]};
  const int n_from = blockIdx.z == 0 ? 0 : (W - cb0 * 64) / 8;
  dkdv_store<W>(acc, (cw == 0 ? dv : dk) + b * so.b + h * so.h + cb0 * 64, so.l, rows, Lk,
                cw == 0 ? 1.f : scale, t, n_from);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dkdv_split_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv,
                                int H, int Lq, int Lk, float scale) {
  dkdv_split_body<D, DkdvSplitCfg<D>, CAUSAL>(&tq, &tk, &tv, &tdo, lse, delta, dk, dv, sdk, sdv, H, Lq,
                                              Lk, scale);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dkdv_chunk_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv,
                                int H, int Lq, int Lk, float scale) {
  dkdv_split_body<D, DkdvChunkCfg<D>, CAUSAL>(&tq, &tk, &tv, &tdo, lse, delta, dk, dv, sdk, sdv, H, Lq,
                                              Lk, scale);
}

// ---------------------------------------------------------------------------
// dQ, with delta = rowsum(dO * O) folded in.  Grid (B * H, ceil(Lq / 128));
// consumer c owns query rows q0 + 64c .. + 63 and both walk the key tiles
// that their rows see, recomputing P from q, k and the saved logsumexp.
// The producer loads Q and dO once, then streams (K, V) tiles through the
// ring.  Before the key loop each consumer computes delta for its rows
// from O and dO in device memory (a quad of threads shares a row), uses
// it, and writes it out for dK/dV.  Per key tile: S = Q K^T and dP = dO V^T
// (SS), P and dS = P (dP - delta) in f32 registers, dS to bf16 A fragments
// in place of dP, and dQ += dS K with K as the MN-major B operand (the
// form of P V in the forward).  Shared memory: Q, dO, then 2 stages of (K
// tile, V tile): 197,688 bytes at D = 128, 192 and 256 (99,384 at 64), the
// key tile shrinking as D grows (128 keys up to D = 128, 64 at 192, 32 at
// 256), which also keeps S, dP and the 64 x D accumulator under 240
// registers.

template <int D>
struct DqCfg {
  static constexpr int kBlockM = 128, kBlockN = D <= 128 ? 128 : D == 192 ? 64 : 32, kStages = 2;
  static constexpr int kQBytes = kBlockM * D * 2, kKVBytes = kBlockN * D * 2;
  // Q, dO, then per stage K and V, then the barriers; 1 KB of slack to align
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (3 + 2 * kStages);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                        const bf16* __restrict__ o, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
                        Strides so, Strides sdo, Strides sdq, int H, int Lq, int Lk, float scale) {
  using C = DqCfg<D>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, S = C::kStages, KV = C::kKVBytes;
  // Ping-pong turns up to D = 128; above it each consumer runs S and dP,
  // dS, dQ += dS K in plain order.  On the H100 the turns won at D = 64 and
  // 128 and lost at 256, where 32-key tiles make each turn short (PERF.md).
  constexpr bool kPingPong = D <= 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + C::kQBytes;
  const uint32_t sKV = sdO + C::kQBytes;  // stage s: K at sKV + 2 s KV, V after it
  const uint32_t bars = sKV + 2 * S * KV;
  const uint32_t qdo_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  auto turn = [&](int c) { return bars + 8 * (1 + 2 * S + c); };  // consumer c may issue

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Lq + BM - 1) / BM;
  // causal: the last query tiles see the most keys, so they launch first
  const int q0 = (CAUSAL ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int n_kt = (CAUSAL ? min(q0 + BM - 1, Lk - 1) : Lk - 1) / BN + 1;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * kWgThreads);
    }
    mbar_init(turn(0), kWgThreads);
    mbar_init(turn(1), kWgThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * C::kQBytes);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(sQ + c * BM * kRowBytes, &tq, qdo_full, c * 64, h, q0, b);
        tma_load(sdO + c * BM * kRowBytes, &tdo, qdo_full, c * 64, h, q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % S;
        const uint32_t sk = sKV + 2 * s * KV;
        mbar_wait(empty(s), ((j / S) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(sk + c * BN * kRowBytes, &tk, full(s), c * 64, h, j * BN, b);
          tma_load(sk + KV + c * BN * kRowBytes, &tv, full(s), c * 64, h, j * BN, b);
        }
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + cw * 64;  // this warpgroup's first row
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  // causal: key tiles right of this warpgroup's last row hold no visible key
  const int my_kt = CAUSAL ? min(r0 + 63, Lk - 1) / BN + 1 : n_kt;

  // delta of this thread's two rows (thread t of the quad sums 16-byte
  // chunks t, t + 4, ...), and the logsumexp in the log2 domain (+inf past
  // Lq, which zeroes those rows' P)
  float dlt[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float part = 0.f;
    if (row[i] < Lq) {
      const uint4* orow = reinterpret_cast<const uint4*>(o + b * so.b + (long long)row[i] * so.l + h * so.h);
      const uint4* drow =
          reinterpret_cast<const uint4*>(dout + b * sdo.b + (long long)row[i] * sdo.l + h * sdo.h);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) part += dot8(orow[4 * c + t], drow[4 * c + t]);
    }
    dlt[i] = quad_sum(part);
    lse2[i] = row[i] < Lq ? lse[(long long)bh * Lq + row[i]] * kLog2e : INFINITY;
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Lq) delta[(long long)bh * Lq + row[i]] = dlt[i];
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl2 = scale * kLog2e;
  auto ph_of = [&](int j) { return (uint32_t)((j / S) & 1); };

  mbar_wait(qdo_full, 0);
  // Ping-pong (D <= 128): each tile takes two turns per
  // consumer, one to issue S and dP, one to issue dQ += dS K; the consumers
  // alternate, so one's P and dS run while the other's products hold the
  // tensor cores.
  if (kPingPong && cw == 1) mbar_arrive(turn(0));  // consumer 0 goes first
  // One key tile: S and dP, P = exp2(S scale log2 e - lse2) and dS = P (dP -
  // delta) in place of dP, then dQ += dS K.  The masks (causal, col >= Lk)
  // are compiled only into the tiles that need them (MaskTag<true>).
  auto tile = [&](int j, auto mask_tag) {
    constexpr bool kMask = decltype(mask_tag)::kOn;
    const int s = j % S;
    const uint32_t sk = sKV + 2 * s * KV, sv = sk + KV;
    mbar_wait(full(s), ph_of(j));
    if (kPingPong) mbar_wait(turn(cw), 0);
    float sc[BN / 8][4], dp[BN / 8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(sc, kmajor(sQ, BM, cw * 64, kk), kmajor(sk, BN, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(dp, kmajor(sdO, BM, cw * 64, kk), kmajor(sv, BN, 0, kk), kk > 0);
    wg_commit();
    if (kPingPong) mbar_arrive(turn(1 - cw));
    wg_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = exp2f(sc[n][e] * sl2 - lse2[i]);
        if constexpr (kMask) {
          const int col = j * BN + n * 8 + 2 * t + (e & 1);
          if ((CAUSAL && col > row[i]) || col >= Lk) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dlt[i]);
      }
    }
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(dsf[kk], dp[2 * kk], dp[2 * kk + 1]);
    if (kPingPong) mbar_wait(turn(cw), 1);
    fence_acc(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tb<D>(dqa, dsf[kk], mnmajor(sk, BN, kk), 1);
    wg_commit();
    if (kPingPong) mbar_arrive(turn(1 - cw));
    wg_wait<0>();
    fence_acc(dqa);
    mbar_arrive(empty(s));
  };
  // tiles whose keys every row of this warpgroup sees, then the masked ones
  const int n_full = min(my_kt, CAUSAL ? min((r0 + 1) / BN, Lk / BN) : Lk / BN);
  for (int j = 0; j < n_full; ++j) tile(j, MaskTag<false>{});
  for (int j = n_full; j < my_kt; ++j) tile(j, MaskTag<true>{});
  // causal: tiles right of these rows hold no visible key; release them in
  // order, and take their turns, so that both consumers count the same
  // rounds on every barrier
  for (int j = my_kt; j < n_kt; ++j) {
    mbar_wait(full(j % S), ph_of(j));
    mbar_arrive(empty(j % S));
    if (kPingPong) {
      mbar_wait(turn(cw), 0);
      mbar_arrive(turn(1 - cw));
      mbar_wait(turn(cw), 1);
      mbar_arrive(turn(1 - cw));
    }
  }

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Lq) continue;
    bf16* dqrow = dqb + (long long)row[i] * sdq.l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dqrow + n * 8 + 2 * t) =
          pack_f32(dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
    }
  }
}

// -- host: launchers ----------------------------------------------------------

template <int D, bool CAUSAL>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    const long long* st, int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv;
  // a runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward on a thread of its own), which the
  // tensor-map encode, a driver call, needs
  cudaError_t err = set_smem(attn_fwd_sm90_kernel<D, CAUSAL>, C::kSmem);
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, C::kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, C::kBlockN);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lq + C::kBlockM - 1) / C::kBlockM);
  attn_fwd_sm90_kernel<D, CAUSAL><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, strides_at(st, 3), H, Lq, Lk, scale);
  return cudaGetLastError();
}

// dK/dV up to D = 128: two consumers of 64 keys each; above it, one block
// of 64 keys whose consumers split dV and dK, above 256 on a chunk of the
// output columns.
template <int D>
using DkdvCfgOf = std::conditional_t<(D <= 128), DkdvCfg<D>,
                                     std::conditional_t<(D <= 256), DkdvSplitCfg<D>, DkdvChunkCfg<D>>>;

template <int D, bool CAUSAL>
auto dkdv_kernel() {
  if constexpr (D <= 128) {
    return attn_dkdv_sm90_kernel<D, CAUSAL>;
  } else if constexpr (D <= 256) {
    return attn_dkdv_split_sm90_kernel<D, CAUSAL>;
  } else {
    return attn_dkdv_chunk_sm90_kernel<D, CAUSAL>;
  }
}

template <int D, bool CAUSAL>
cudaError_t run_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dk, void* dv, const long long* st, int B, int H, int Lq,
                     int Lk, float scale, cudaStream_t stream) {
  using C = DkdvCfgOf<D>;
  const auto kernel = dkdv_kernel<D, CAUSAL>();
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = set_smem(kernel, C::kSmem);  // first: see run_fwd
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, C::kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tdo, dout, strides_at(st, 3), B, Lq, H, D, C::kBlockM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lk + C::kBlockN - 1) / C::kBlockN, C::kChunks);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      strides_at(st, 4), strides_at(st, 5), H, Lq, Lk, scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, const long long* st, int B, int H, int Lq,
                   int Lk, float scale, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = set_smem(attn_dq_sm90_kernel<D, CAUSAL>, C::kSmem);  // first: see run_fwd
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, C::kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tdo, dout, strides_at(st, 4), B, Lq, H, D, C::kBlockM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lq + C::kBlockM - 1) / C::kBlockM);
  attn_dq_sm90_kernel<D, CAUSAL><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, (const bf16*)o, (const bf16*)dout, (const float*)lse, (float*)delta,
      (bf16*)dq, strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), H, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t fwd_sm90(int D, bool causal, const void* q, const void* k, const void* v, void* o,
                     void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                     cudaStream_t stream) {
#define EDL_FWD(DD)                                                                      \
  case DD:                                                                               \
    return causal ? run_fwd<DD, true>(q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream)  \
                  : run_fwd<DD, false>(q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
  switch (D) {
    EDL_FWD(64)
    EDL_FWD(128)
    EDL_FWD(192)
    EDL_FWD(256)
  }
#undef EDL_FWD
  return cudaErrorInvalidValue;
}

cudaError_t dkdv_sm90(int D, bool causal, const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      const long long* st, int B, int H, int Lq, int Lk, float scale,
                      cudaStream_t stream) {
#define EDL_DKDV(DD)                                                                          \
  case DD:                                                                                    \
    return causal ? run_dkdv<DD, true>(q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk,   \
                                       scale, stream)                                         \
                  : run_dkdv<DD, false>(q, k, v, dout, lse, delta, dk, dv, st, B, H, Lq, Lk,  \
                                        scale, stream);
  switch (D) {
    EDL_DKDV(64)
    EDL_DKDV(128)
    EDL_DKDV(192)
    EDL_DKDV(256)
  }
  return cudaErrorInvalidValue;
}

cudaError_t dkdv_chunk_sm90(int D, bool causal, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                            const long long* st, int B, int H, int Lq, int Lk, float scale,
                            cudaStream_t stream) {
#define EDL_DKDV_CHUNK(DD) EDL_DKDV(DD)
  switch (D) {
    EDL_DKDV_CHUNK(320)
    EDL_DKDV_CHUNK(384)
  }
#undef EDL_DKDV_CHUNK
#undef EDL_DKDV
  return cudaErrorInvalidValue;
}

cudaError_t dq_sm90(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                    int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
#define EDL_DQ(DD)                                                                                \
  case DD:                                                                                        \
    return causal ? run_dq<DD, true>(q, k, v, o, dout, lse, delta, dq, st, B, H, Lq, Lk, scale,   \
                                     stream)                                                      \
                  : run_dq<DD, false>(q, k, v, o, dout, lse, delta, dq, st, B, H, Lq, Lk, scale,  \
                                      stream);
  switch (D) {
    EDL_DQ(64)
    EDL_DQ(128)
    EDL_DQ(192)
    EDL_DQ(256)
  }
#undef EDL_DQ
  return cudaErrorInvalidValue;
}

}  // namespace edl_attn
