// The attention backward at head dims whose outputs and operands outgrow one
// block, for Hopper, on thread block clusters that split D: dK/dV above
// D = 384 and dQ, with delta = rowsum(dO * O) folded in, above D = 256, up to
// D = 2048 (a cluster of at most 8 blocks).
//
// Replaces, behind the dK/dV and dQ entry points of attention.cu
// (edl_attn_bwd_dkdv, edl_flash_bwd_dkdv, edl_attn_bwd_dq,
// edl_flash_bwd_dq), splash_attention/splash_attention_kernel.py:2196 and
// :1635 with the XLA rowsum(dO * O) of :2285, and flash_attention.py:1121
// and :1456 with the di of :273 (jax/experimental/pallas/ops/tpu/, reached
// from edl_tpu/ops/attention.py _splash and _flash), at those head dims:
// dK/dV and dQ, causal (top-left: key j is visible to query i iff j <= i)
// or not, Lq and Lk free; keys no query sees get exactly 0.
//
// What bounds them on an H100: 8 (dK/dV) and 6 (dQ) Lq Lk D flops per
// (b, h), on the operations side of the card's ridge at L = 1024 non-causal;
// causal dQ at D = 384 and 768 is on the bytes side, by a little.  The
// design does every product once:
//   - At D = 768 K and V alone take 192 KB and Q and dO as much, so no
//     block can hold what a 64-row tile's score products reduce over.  A
//     cluster of n = ceil(D / 256) blocks (grid z) splits D: each block
//     owns BPR = ceil(D / 64 / n) of its 64-column boxes (3 or 4: W = 192
//     or 256 columns; the last block's boxes may lie past D, where TMA
//     reads zeros, so every block runs one body), loads only its columns of
//     every operand, and computes the score products S = Q K^T and dP =
//     dO V^T over them.  Each block writes its f32 partials to its own
//     shared memory and, once its consumer warpgroup is there, lanes 0 ..
//     n - 1 of one warp arrive on an mbarrier in each block of the cluster
//     (one release for all); each block then reads every block's partials
//     through distributed shared memory (mapa / ld.shared::cluster), several
//     blocks' loads in flight at once, adding them in rank order, so every
//     block holds bit-identical S and dP.  So the score products are done
//     once (attention_wide.cu's mma.sync kernels, which this replaces, did
//     them once per 128-column chunk of the output: 3.5 times the bound's
//     products in dK/dV and 4.3 times in dQ at D = 768).  A release fence
//     before the arrivals, a release from each of n threads, partials
//     pushed with st.async, and one block's own partial read from local
//     shared memory all ran slower on the H100 (PERF.md).
//   - The exchange is double-buffered by parity: a block writes step i's
//     partial after every block signalled step i - 1's, which each did only
//     after reading step i - 2's, so one barrier a step and buffer
//     suffices; a final barrier keeps every block's shared memory alive
//     until the others have read it.  The cost grows with n (each block
//     reads n partials a step), so the plan takes the fewest blocks.
//   - dK/dV (attn_dkdv_cluster_sm90_kernel): a cluster owns 64 keys; each
//     block keeps attention_sm90.cu's split roles on its columns: consumer
//     0 forms S^T = K Q^T and P^T, hands P^T to consumer 1 through shared
//     memory, and accumulates dV += P^T dO; consumer 1 forms dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta) and accumulates dK += dS^T Q, each 64 x W
//     f32 (W / 2 registers a thread).  K and V stay resident; (Q, dO) steps
//     of 32 queries stream through a TMA ring of 3.  Each step issues its
//     scores with the step before's output product and exchanges while
//     that runs.
//   - dQ (attn_dq_cluster_sm90_kernel): a cluster owns 64 query rows; each
//     block keeps its columns of Q and dO resident and streams its columns
//     of 32-key (K, V) tiles through a TMA ring.  The two consumers take
//     alternate key tiles, each whole: S and dP, one exchange for both,
//     dS = P (dP - delta), dQ += dS K over the block's columns (64 x W
//     f32); so neither waits for the other, and one's exchange runs while
//     the other's products hold the tensor cores.  Their two dQ are added
//     at the end.  The ring has 4 stages at W = 192 and 3 at 256; at 3 a
//     consumer waits for a stage's release by the other before its next
//     phase.  Delta is a partial rowsum of dO * O over each block's
//     columns, read from device memory before the key loop and summed
//     across the cluster the same way; rank 0 writes it for dK/dV: the
//     backward is two launches.
//   - No wgmma sits in a branch, and none is in flight from one step to the
//     next; the causal masks are compiled only into the steps and tiles
//     that need them (MaskTag).
//   - setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240); the tensor maps are 4-D over [B, L, H, D] with the
//     operands' strides.
// Shared memory (with 1 KB of alignment slack), BPR = 3 / 4: dK/dV 173,952 /
// 214,912 bytes (K, V, 3 stages of (Q, dO), 2 P^T buffers, 4 exchange
// slots, the stages' lse and delta, the barriers); dQ 214,648 / 231,016
// (Q, dO, 4 / 3 stages of (K, V), 4 exchange slots of (S, dP), the delta
// partials, the barriers).

#include <type_traits>

#include "sm90.cuh"

namespace edl_attn {
namespace {

constexpr int kStep = 32;     // queries a dK/dV step, keys a dQ tile
constexpr int kMaxRanks = 8;  // blocks of a cluster, at most (the portable size)

// -- the cluster -------------------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ranks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of every block of the cluster: after it, each block's
// initialised barriers may take the others' arrivals.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of shared-memory address `addr` in the block of rank `rank`.
__device__ __forceinline__ uint32_t at_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void arrive_at(uint32_t bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(at_rank(bar, rank)) : "memory");
}

// mbar_wait, acquiring what other blocks of the cluster released (a wait of
// ~2^34 cycles traps, as mbar_wait's).
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ float4 ld_rank(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float ld_rank_f(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// One consumer warpgroup's own barrier (ids 2 and 3; 1 is both consumers').
__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + cw) : "memory");
}

// Once every thread of this consumer is here, thread r arrives on barrier
// `bar` of the block of rank r, releasing their writes to the cluster: one
// instruction of the first warp, so one release for all of them.
__device__ __forceinline__ void signal_all(uint32_t bar, int ranks, int cw, int tid) {
  consumer_sync(cw);
  if (tid < ranks) arrive_at(bar, tid);
}

// v = the sum over the cluster's blocks, in rank order, of each block's v
// (NB 16-byte element blocks a thread of this consumer; the same thread of
// every block holds the same elements): written to this block's slot at
// `slot_off` (block n of thread i at [n * 128 + i]), signalled on `full`,
// which completes a phase once every block has, then read from every
// block's slot, the loads from G blocks in flight together.  Every block
// gets the same bits.
template <int NB, int G>
__device__ __forceinline__ void cluster_sum(float4 (&v)[NB], unsigned char* base, int slot_off, uint32_t full,
                                            uint32_t parity, int ranks, int cw, int tid) {
  float4* mine = reinterpret_cast<float4*>(base + slot_off) + tid;
#pragma unroll
  for (int n = 0; n < NB; ++n) mine[n * kWgThreads] = v[n];
  signal_all(full, ranks, cw, tid);
  wait_cluster(full, parity);
  const uint32_t slot = smem_u32(base) + slot_off + tid * 16;
#pragma unroll
  for (int n = 0; n < NB; ++n) v[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < ranks; r0 += G) {
    float4 in[G][NB];
#pragma unroll
    for (int rr = 0; rr < G; ++rr) {
      if (r0 + rr < ranks) {
        const uint32_t at = at_rank(slot, r0 + rr);
#pragma unroll
        for (int n = 0; n < NB; ++n) in[rr][n] = ld_rank(at + n * kWgThreads * 16);
      }
    }
#pragma unroll
    for (int rr = 0; rr < G; ++rr) {
      if (r0 + rr < ranks) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          v[n].x += in[rr][n].x;
          v[n].y += in[rr][n].y;
          v[n].z += in[rr][n].z;
          v[n].w += in[rr][n].w;
        }
      }
    }
  }
}

// A 64 x N f32 accumulator as N / 8 element blocks (at v[off ..]) and back.
template <int N, int NB>
__device__ __forceinline__ void to_blocks(const float (&x)[N / 8][4], float4 (&v)[NB], int off) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) v[off + n] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
}

template <int N, int NB>
__device__ __forceinline__ void from_blocks(float (&x)[N / 8][4], const float4 (&v)[NB], int off) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    x[n][0] = v[off + n].x;
    x[n][1] = v[off + n].y;
    x[n][2] = v[off + n].z;
    x[n][3] = v[off + n].w;
  }
}

// The cluster of head dim D: `ranks` blocks of `bpr` 64-column boxes each
// (ranks * bpr >= D / 64; the boxes past D read as zeros).
struct BwdClusterPlan {
  int ranks, bpr;
};

__host__ __device__ constexpr BwdClusterPlan plan_bwd_cluster(int D) {
  const int nb = D / 64, ranks = (nb + 3) / 4;
  return BwdClusterPlan{ranks, ranks > 0 ? (nb + ranks - 1) / ranks : 0};
}

// ---------------------------------------------------------------------------
// dK and dV.  Grid (B * H, ceil(Lk / 64), ranks), a cluster along z; key
// tile 0, which walks the most causal steps, launched first.

template <int BPR>
struct DkdvClusterCfg {
  static constexpr int kW = 64 * BPR, kBlockN = 64, kBlockM = kStep, kStages = 3;
  static constexpr int kKVBytes = kBlockN * kW * 2;    // this block's columns of K or V
  static constexpr int kStepBytes = kBlockM * kW * 2;  // of one Q or dO step
  static constexpr int kTileBytes = kBlockN * kBlockM * 4;  // one f32 64 x BM tile
  // K, V, then per stage Q and dO, the P^T buffers, the exchange slots
  // (consumer c, parity j: 2 j + c), per stage lse2[BM] and delta[BM], the
  // barriers
  static constexpr int kQOff = 2 * kKVBytes;
  static constexpr int kPOff = kQOff + 2 * kStages * kStepBytes;
  static constexpr int kXOff = kPOff + 2 * kTileBytes;
  static constexpr int kStatOff = kXOff + 4 * kTileBytes;
  static constexpr int kBarOff = kStatOff + kStages * 2 * kBlockM * 4;
  static constexpr int kBars = 10 + 2 * kStages;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * kBars;
  __host__ __device__ static constexpr int q_off(int s) { return kQOff + 2 * s * kStepBytes; }
  __host__ __device__ static constexpr int stat_off(int s) { return kStatOff + s * 2 * kBlockM * 4; }
};

template <int BPR, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dkdv_cluster_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk, Strides sdv,
                                  int H, int Lq, int Lk, int D, float scale) {
  using C = DkdvClusterCfg<BPR>;
  constexpr int BN = C::kBlockN, BM = C::kBlockM, S = C::kStages, W = C::kW, STEP = C::kStepBytes;
  constexpr int kMaskSteps = BN / BM;  // causal: the steps whose queries start before the keys end
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = align_1k(smem_raw);
  const uint32_t sK = smem_u32(base), sV = sK + C::kKVBytes, bars = sK + C::kBarOff;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  auto p_full = [&](int j) { return bars + 8 * (1 + 2 * S + j); };   // P^T of buffer j written
  auto p_empty = [&](int j) { return bars + 8 * (3 + 2 * S + j); };  // P^T of buffer j taken
  auto x_full = [&](int c, int j) { return bars + 8 * (5 + 2 * S + 2 * j + c); };
  const uint32_t done = bars + 8 * (9 + 2 * S);

  const int ranks = cluster_ranks(), rank = cluster_rank();
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BN;
  const int i0 = CAUSAL ? k0 / BM : 0;  // queries before k0 never see these keys
  const int n_steps = max(0, (Lq + BM - 1) / BM - i0);
  const int cb0 = rank * BPR;  // this block's first 64-column box of D

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread's expect_tx + the first warp's stats
      mbar_init(empty(s), 2 * kWgThreads);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(p_full(j), kWgThreads);
      mbar_init(p_empty(j), kWgThreads);
      mbar_init(x_full(0, j), ranks);
      mbar_init(x_full(1, j), ranks);
    }
    mbar_init(done, 2 * ranks);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (threadIdx.x < kWgThreads) {  // producer: its first warp loads and copies the stats
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const float* lse_b = lse + (long long)bh * Lq;
    const float* delta_b = delta + (long long)bh * Lq;
    if (lane == 0 && n_steps > 0) {
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      for (int c = 0; c < BPR; ++c) {
        tma_load(sK + c * BN * kRowBytes, &tk, kv_full, (cb0 + c) * 64, h, k0, b);
        tma_load(sV + c * BN * kRowBytes, &tv, kv_full, (cb0 + c) * 64, h, k0, b);
      }
    }
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % S, q0 = (i0 + it) * BM;
      const uint32_t sq = sK + C::q_off(s);
      mbar_wait(empty(s), ((it / S) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * STEP);
        for (int c = 0; c < BPR; ++c) {
          tma_load(sq + c * BM * kRowBytes, &tq, full(s), (cb0 + c) * 64, h, q0, b);
          tma_load(sq + STEP + c * BM * kRowBytes, &tdo, full(s), (cb0 + c) * 64, h, q0, b);
        }
      }
      // lse in the log2 domain (+inf past Lq, which zeroes those queries' P^T)
      float* st = reinterpret_cast<float*>(base + C::stat_off(s));
      for (int i = lane; i < BM; i += 32) {
        const int qi = q0 + i;
        st[i] = qi < Lq ? lse_b[qi] * kLog2e : INFINITY;
        st[BM + i] = qi < Lq ? delta_b[qi] : 0.f;
      }
      mbar_arrive(full(s));
    }
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
  uint32_t af[BM / 16][4];  // the step before's P^T (consumer 0) or dS^T (consumer 1)
  // consumer 0: dV += P^T dO; consumer 1: dK += dS^T Q, for step `it`
  // (stage s), this block's columns
  auto issue_out = [&](int s) {
    const uint32_t sq = sK + C::q_off(s);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs_tb<W>(acc, af[kk], mnmajor(cw == 0 ? sq + STEP : sq, BM, kk), 1);
    wg_commit();
  };

  // One query step: issue its score product and the step before's output
  // product, wait for the scores only, sum them over the cluster and form
  // P^T or dS^T while the output product runs, then wait for it and
  // release the step before's stage.  No product is in flight from one
  // step to the next.  The masked body (causal, the first kMaskSteps
  // steps, whose queries k0 + it BM + ql see key k0 + kr iff kr <= it BM +
  // ql) is compiled only for those steps (MaskTag<true>).
  auto step = [&](int it, auto mask_tag, auto first_tag) {
    constexpr bool kMask = decltype(mask_tag)::kOn && CAUSAL, kFirst = decltype(first_tag)::value;
    const int s = it % S, j = it & 1;
    const uint32_t sq = sK + C::q_off(s), sdo = sq + STEP;
    mbar_wait(full(s), (it / S) & 1);
    const float* lse2 = reinterpret_cast<const float*>(base + C::stat_off(s));
    const float* dlt = lse2 + BM;
    // consumer 0: S^T = K Q^T; consumer 1: dP^T = V dO^T (64 keys x BM
    // queries), over this block's columns, then summed over the cluster
    float x[BM / 8][4];
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      wgmma_ss<BM>(x, kmajor(cw == 0 ? sK : sV, BN, 0, kk), kmajor(cw == 0 ? sq : sdo, BM, 0, kk), kk > 0);
    wg_commit();
    if constexpr (!kFirst) {
      issue_out((it - 1) % S);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    fence_acc(x);
    float4 xb[BM / 8];
    to_blocks<BM>(x, xb, 0);
    cluster_sum<BM / 8, 3>(xb, base, C::kXOff + (2 * j + cw) * C::kTileBytes, x_full(cw, j), (it >> 1) & 1,
                           ranks, cw, tid);
    from_blocks<BM>(x, xb, 0);
    // this thread's slots of P^T buffer j: element block n at pbuf[n * kWgThreads]
    float4* pbuf = reinterpret_cast<float4*>(base + C::kPOff + j * C::kTileBytes) + tid;
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
    if constexpr (!kFirst) {
      wg_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty((it - 1) % S));
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) acc_to_a(af[kk], x[2 * kk], x[2 * kk + 1]);
    fence_frag(af);
  };
  if (n_steps > 0) {
    mbar_wait(kv_full, 0);
    step(0, MaskTag<true>{}, std::true_type{});
    int it = 1;
    if constexpr (CAUSAL) {
      for (; it < min(kMaskSteps, n_steps); ++it) step(it, MaskTag<true>{}, std::false_type{});
    }
    for (; it < n_steps; ++it) step(it, MaskTag<false>{}, std::false_type{});
    // the last step's output product
    fence_acc(acc);
    wg_fence();
    issue_out((n_steps - 1) % S);
    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty((n_steps - 1) % S));
  }
  // no block leaves while another may still read its exchange slots
  signal_all(done, ranks, cw, tid);
  wait_cluster(done, 0);

  // this block's columns below D (a key tile no query sees writes zeros)
  const Strides so = cw == 0 ? sdv : sdk;
  bf16* out = (cw == 0 ? dv : dk) + b * so.b + h * so.h + cb0 * 64;
  const float mul = cw == 0 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + kr[i];
    if (row >= Lk) continue;
    bf16* orow = out + (long long)row * so.l;
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      if (cb0 * 64 + n * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_f32(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// dQ, with delta = rowsum(dO * O) folded in.  Grid (B * H, ceil(Lq / 64),
// ranks), a cluster along z; the longest causal rows launched first.

template <int BPR>
struct DqClusterCfg {
  // tile j lies in stage j % kStages and belongs to consumer j % 2
  static constexpr int kW = 64 * BPR, kBlockM = 64, kBlockN = kStep, kStages = BPR == 3 ? 4 : 3;
  static constexpr int kQBytes = kBlockM * kW * 2;      // this block's columns of Q or dO
  static constexpr int kKVBytes = kBlockN * kW * 2;     // of one K or V tile
  static constexpr int kPairBytes = 2 * kBlockM * kBlockN * 4;  // f32 64 x BN S and dP
  // Q, dO, then per stage K and V, the exchange slots (consumer c, parity
  // j: 2 j + c; at the end consumer 1's dQ), the delta partials (2
  // consumers x 64 rows), the barriers
  static constexpr int kKVOff = 2 * kQBytes;
  static constexpr int kXOff = kKVOff + 2 * kStages * kKVBytes;
  static constexpr int kDOff = kXOff + 4 * kPairBytes;
  static constexpr int kBarOff = kDOff + 2 * kBlockM * 4;
  static constexpr int kBars = 7 + 2 * kStages;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * kBars;
  static_assert(kBlockM * kW * 4 <= 4 * kPairBytes, "consumer 1's dQ fits the exchange slots");
};

template <int BPR, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dq_cluster_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
                                Strides so, Strides sdo, Strides sdq, int H, int Lq, int Lk, int D, float scale) {
  using C = DqClusterCfg<BPR>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, S = C::kStages, W = C::kW, KV = C::kKVBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = align_1k(smem_raw);
  const uint32_t sQ = smem_u32(base), sdO = sQ + C::kQBytes, sKV = sQ + C::kKVOff;
  const uint32_t bars = sQ + C::kBarOff;
  const uint32_t qdo_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  auto x_full = [&](int c, int j) { return bars + 8 * (1 + 2 * S + 2 * j + c); };
  const uint32_t d_full = bars + 8 * (5 + 2 * S), done = bars + 8 * (6 + 2 * S);

  const int ranks = cluster_ranks(), rank = cluster_rank();
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Lq + BM - 1) / BM;
  const int q0 = (CAUSAL ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int n_kt = (CAUSAL ? min(q0 + BM - 1, Lk - 1) : Lk - 1) / BN + 1;
  const int cb0 = rank * BPR;  // this block's first 64-column box of D

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgThreads);  // the tile's consumer
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(x_full(0, j), ranks);
      mbar_init(x_full(1, j), ranks);
    }
    mbar_init(d_full, 2 * ranks);
    mbar_init(done, 2 * ranks);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (threadIdx.x < kWgThreads) {  // producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qdo_full, 2 * C::kQBytes);
      for (int c = 0; c < BPR; ++c) {
        tma_load(sQ + c * BM * kRowBytes, &tq, qdo_full, (cb0 + c) * 64, h, q0, b);
        tma_load(sdO + c * BM * kRowBytes, &tdo, qdo_full, (cb0 + c) * 64, h, q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % S;
        const uint32_t sk = sKV + 2 * s * KV;
        mbar_wait(empty(s), ((j / S) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * KV);
        for (int c = 0; c < BPR; ++c) {
          tma_load(sk + c * BN * kRowBytes, &tk, full(s), (cb0 + c) * 64, h, j * BN, b);
          tma_load(sk + KV + c * BN * kRowBytes, &tv, full(s), (cb0 + c) * 64, h, j * BN, b);
        }
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's rows, from q0
  const int row[2] = {q0 + lrow[0], q0 + lrow[1]};

  // delta of this thread's two rows: the partial over this block's columns
  // below D (thread t of consumer c of a row's quad sums the 16-byte chunks
  // 8 m + 4 c + t), summed over both consumers of every block in rank order
  float dlt[2], lse2[2];
  float* dpart = reinterpret_cast<float*>(base + C::kDOff);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float part = 0.f;
    if (row[i] < Lq) {
      const uint4* orow = reinterpret_cast<const uint4*>(o + b * so.b + (long long)row[i] * so.l + h * so.h + cb0 * 64);
      const uint4* drow =
          reinterpret_cast<const uint4*>(dout + b * sdo.b + (long long)row[i] * sdo.l + h * sdo.h + cb0 * 64);
#pragma unroll
      for (int m = 0; m < BPR; ++m) {
        const int ch = 8 * m + 4 * cw + t;
        if (cb0 * 64 + ch * 8 < D) part += dot8(orow[ch], drow[ch]);
      }
    }
    part = quad_sum(part);
    if (t == 0) dpart[cw * BM + lrow[i]] = part;
    // the logsumexp in the log2 domain (+inf past Lq, which zeroes those rows' P)
    lse2[i] = row[i] < Lq ? lse[(long long)bh * Lq + row[i]] * kLog2e : INFINITY;
  }
  signal_all(d_full, ranks, cw, tid);
  wait_cluster(d_full, 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t at = smem_u32(dpart + lrow[i]);
    dlt[i] = 0.f;
    for (int r = 0; r < ranks; ++r) {
      dlt[i] += ld_rank_f(at_rank(at, r));
      dlt[i] += ld_rank_f(at_rank(at + BM * 4, r));
    }
  }
  if (rank == 0 && cw == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Lq) delta[(long long)bh * Lq + row[i]] = dlt[i];
  }

  float dqa[W / 8][4];  // this consumer's tiles' dQ, the block's columns (before the scale)
#pragma unroll
  for (int n = 0; n < W / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl2 = scale * kLog2e;

  // One key tile j, of this consumer: S = Q K^T and dP = dO V^T (64 rows x
  // BN keys) over this block's columns, summed over the cluster, dS = P (dP
  // - delta) with P = exp2(S scale log2 e - lse2), and dQ += dS K.  The
  // masks (causal, col >= Lk) are compiled only into the tiles that need
  // them (MaskTag<true>).
  auto tile = [&](int j, int it, auto mask_tag) {
    constexpr bool kMask = decltype(mask_tag)::kOn;
    const int s = j % S;
    const uint32_t sk = sKV + 2 * s * KV, sv = sk + KV;
    // at an odd stage count the stage's tile before was the other
    // consumer's: wait for its release, so that the full barrier is at tile
    // j's phase (at an even count each stage serves one consumer)
    if constexpr (S % 2 == 1) mbar_wait(empty(s), ((j / S) & 1) ^ 1);
    mbar_wait(full(s), (j / S) & 1);
    float sc[BN / 8][4], dp[BN / 8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) wgmma_ss<BN>(sc, kmajor(sQ, BM, 0, kk), kmajor(sk, BN, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) wgmma_ss<BN>(dp, kmajor(sdO, BM, 0, kk), kmajor(sv, BN, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    float4 xb[BN / 4];
    to_blocks<BN>(sc, xb, 0);
    to_blocks<BN>(dp, xb, BN / 8);
    cluster_sum<BN / 4, 1>(xb, base, C::kXOff + (2 * (it & 1) + cw) * C::kPairBytes, x_full(cw, it & 1),
                           (it >> 1) & 1, ranks, cw, tid);
    from_blocks<BN>(sc, xb, 0);
    from_blocks<BN>(dp, xb, BN / 8);
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
    fence_frag(dsf);
    fence_acc(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tb<W>(dqa, dsf[kk], mnmajor(sk, BN, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_acc(dqa);
    mbar_arrive(empty(s));
  };

  mbar_wait(qdo_full, 0);
  // consumer c takes the tiles c, c + 2, ...: those whose keys every row
  // sees, then those that need the masks
  const int n_full = min(n_kt, CAUSAL ? min((q0 + 1) / BN, Lk / BN) : Lk / BN);
  int j = cw, it = 0;
  for (; j < n_full; j += 2, ++it) tile(j, it, MaskTag<false>{});
  for (; j < n_kt; j += 2, ++it) tile(j, it, MaskTag<true>{});
  // no block leaves while another may still read its exchange slots or
  // delta partials
  signal_all(done, ranks, cw, tid);
  wait_cluster(done, 0);

  // dQ = consumer 0's + consumer 1's, through the exchange slots; consumer
  // 0 stores the block's columns below D
  float4* half = reinterpret_cast<float4*>(base + C::kXOff) + tid;
  if (cw == 1) {
#pragma unroll
    for (int n = 0; n < W / 8; ++n) half[n * kWgThreads] = make_float4(dqa[n][0], dqa[n][1], dqa[n][2], dqa[n][3]);
  }
  consumers_sync();
  if (cw == 1) return;
  bf16* dqb = dq + b * sdq.b + h * sdq.h + cb0 * 64;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const float4 o1 = half[n * kWgThreads];
    dqa[n][0] += o1.x;
    dqa[n][1] += o1.y;
    dqa[n][2] += o1.z;
    dqa[n][3] += o1.w;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Lq) continue;
    bf16* dqrow = dqb + (long long)row[i] * sdq.l;
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      if (cb0 * 64 + n * 8 < D)
        *reinterpret_cast<uint32_t*>(dqrow + n * 8 + 2 * t) =
            pack_f32(dqa[n][2 * i] * scale, dqa[n][2 * i + 1] * scale);
    }
  }
}

// -- host: launchers ----------------------------------------------------------

template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, size_t smem, int ranks, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ranks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BPR, bool CAUSAL>
cudaError_t run_dkdv_cluster(int ranks, int D, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                             const long long* st, int B, int H, int Lq, int Lk, float scale,
                             cudaStream_t stream) {
  using C = DkdvClusterCfg<BPR>;
  const auto kernel = attn_dkdv_cluster_sm90_kernel<BPR, CAUSAL>;
  CUtensorMap tq, tk, tv, tdo;
  // a runtime call first: it makes the device's context current in this
  // thread (autograd runs the backward on a thread of its own), which the
  // tensor-map encode, a driver call, needs
  cudaError_t err = set_smem(kernel, C::kSmem);
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, C::kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tdo, dout, strides_at(st, 3), B, Lq, H, D, C::kBlockM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lk + C::kBlockN - 1) / C::kBlockN, ranks);
  return launch_cluster(kernel, grid, C::kSmem, ranks, stream, tq, tk, tv, tdo, (const float*)lse,
                        (const float*)delta, (bf16*)dk, (bf16*)dv, strides_at(st, 4), strides_at(st, 5), H,
                        Lq, Lk, D, scale);
}

template <int BPR, bool CAUSAL>
cudaError_t run_dq_cluster(int ranks, int D, const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                           int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  using C = DqClusterCfg<BPR>;
  const auto kernel = attn_dq_cluster_sm90_kernel<BPR, CAUSAL>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = set_smem(kernel, C::kSmem);  // first: see run_dkdv_cluster
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, C::kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tdo, dout, strides_at(st, 4), B, Lq, H, D, C::kBlockM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lq + C::kBlockM - 1) / C::kBlockM, ranks);
  return launch_cluster(kernel, grid, C::kSmem, ranks, stream, tq, tk, tv, tdo, (const bf16*)o,
                        (const bf16*)dout, (const float*)lse, (float*)delta, (bf16*)dq, strides_at(st, 3),
                        strides_at(st, 4), strides_at(st, 5), H, Lq, Lk, D, scale);
}

// The plan of head dim D, if a cluster kernel takes it (256 < D <= 2048,
// D % 64 == 0).
bool cluster_plan(int D, BwdClusterPlan* p) {
  *p = plan_bwd_cluster(D);
  return D > 256 && D % 64 == 0 && p->ranks <= kMaxRanks;
}

}  // namespace

cudaError_t dkdv_cluster_sm90(int D, bool causal, const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                              const long long* st, int B, int H, int Lq, int Lk, float scale,
                              cudaStream_t stream) {
  BwdClusterPlan p;
  if (!cluster_plan(D, &p)) return cudaErrorInvalidValue;
#define EDL_DKDV_CLUSTER(BB)                                                                        \
  case BB:                                                                                          \
    return causal ? run_dkdv_cluster<BB, true>(p.ranks, D, q, k, v, dout, lse, delta, dk, dv, st, B, \
                                               H, Lq, Lk, scale, stream)                            \
                  : run_dkdv_cluster<BB, false>(p.ranks, D, q, k, v, dout, lse, delta, dk, dv, st, B, \
                                                H, Lq, Lk, scale, stream);
  switch (p.bpr) {
    EDL_DKDV_CLUSTER(3)
    EDL_DKDV_CLUSTER(4)
  }
#undef EDL_DKDV_CLUSTER
  return cudaErrorInvalidValue;
}

cudaError_t dq_cluster_sm90(int D, bool causal, const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta, void* dq, const long long* st,
                            int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  BwdClusterPlan p;
  if (!cluster_plan(D, &p)) return cudaErrorInvalidValue;
#define EDL_DQ_CLUSTER(BB)                                                                          \
  case BB:                                                                                          \
    return causal ? run_dq_cluster<BB, true>(p.ranks, D, q, k, v, o, dout, lse, delta, dq, st, B, H,  \
                                             Lq, Lk, scale, stream)                                 \
                  : run_dq_cluster<BB, false>(p.ranks, D, q, k, v, o, dout, lse, delta, dq, st, B, H, \
                                              Lq, Lk, scale, stream);
  switch (p.bpr) {
    EDL_DQ_CLUSTER(3)
    EDL_DQ_CLUSTER(4)
  }
#undef EDL_DQ_CLUSTER
  return cudaErrorInvalidValue;
}

int bwd_cluster_smem(int bpr, bool dq) {
  if (bpr == 3) return (int)(dq ? DqClusterCfg<3>::kSmem : DkdvClusterCfg<3>::kSmem);
  if (bpr == 4) return (int)(dq ? DqClusterCfg<4>::kSmem : DkdvClusterCfg<4>::kSmem);
  return 0;
}

}  // namespace edl_attn
