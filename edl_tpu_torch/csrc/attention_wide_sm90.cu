// The attention forward at head dims 320, 384, 448 and 512 (256 < D <= 512)
// for Hopper: TMA tile loads into an mbarrier ring, wgmma products, one
// producer warpgroup and two consumer warpgroups that split the output
// columns and exchange partial scores.  Above 512, attention_chunk_sm90.cu
// runs the same design on chunks of the output columns.
//
// Replaces, behind the forward entry points of attention.cu (edl_attn_fwd,
// edl_flash_fwd), splash_attention/splash_attention_kernel.py:1137 and
// flash_attention.py:758 (jax/experimental/pallas/ops/tpu/, reached from
// edl_tpu/ops/attention.py _splash and _flash) at the head dims those
// kernels tile in 128-lane repeats: O and the f32 logsumexp, causal
// (top-left: key j is visible to query i iff j <= i) or not, Lq and Lk
// free.
//
// What bounds it on an H100: 4 Lq Lk D flops per (b, h) on the bytes of
// q, k, v and o, so at L = 1024 the non-causal forward is on the
// operations side of the card's ridge and the causal one near it: the
// design keeps the tensor cores fed and does no product twice.
//   - A block owns one (batch, head) and 64 query rows; grid (B * H,
//     ceil(Lq / 64)), the longest causal rows first.  Both consumers own
//     the same rows and run one body (ptxas serialises wgmma in a path
//     that differs between warps), so each does the same work: the score
//     product's half of the 16-column k-steps of D (10 at D = 320, 12 at
//     384, 14 at 448, 16 at 512), and the output columns of half the
//     64-column boxes of D, rounded up (3 at D = 320 and 384, 4 at 448 and
//     512), accumulated in at most 64 x 256 f32 (128 registers a thread).
//     At an odd box count the two consumers' boxes overlap in the middle
//     one, which consumer 1 computes too but does not store: 1/6 more P V
//     work at D = 320, 1/8 at 448.
//   - Per key tile of 32 keys, each consumer computes its partial scores
//     S_c = Q[:, k_c] K[:, k_c]^T (wgmma SS, m64n32) over its k-steps k_c,
//     writes them to a double-buffered shared buffer in its accumulator
//     order (thread i of each consumer holds the same (row, key)
//     elements: 16-byte stores, no swizzle), and after one named barrier
//     of the two consumers reads both and adds them in one order, so both
//     hold bit-identical S.  Both run the same online softmax (f32, log2
//     domain, the scale applied to the f32 scores) and each applies P to
//     its own columns of V (wgmma RS, m64n(64 x boxes), V read MN-major).
//     So each product is done once; the mma.sync kernel this replaced
//     recomputed the scores for every 128-column chunk of O.
//   - Q is loaded once and stays; K and V stream through rings of their
//     own (3 stages up to D = 384, 2 above), K released after the scores,
//     V after the P V product, the producer loading in the order they are
//     taken (K of tile j + 1, then V of tile j).
//   - Each consumer issues tile j + 1's scores before tile j's exchange and
//     softmax, so those run while the tensor cores compute.
//   - The masks (causal; col >= Lk) are compiled only into the tiles that
//     need them: the diagonal ones, the ragged last one.
// On the H100 it reaches 16-26% of that bound (PERF.md): per 32-key tile a
// block spends a time that does not grow with D (each consumer's chain of
// exchange, barrier, softmax and rescale) beside the products, and 64-row
// blocks with 32-key tiles, which the registers and shared memory allow
// at these head dims, leave it exposed.
// Shared memory (with 1 KB of alignment slack): Q, the K stages, the V
// stages, the score exchange (2 parities x 2 consumers x 64 x 32 f32), the
// barriers: 197,736 bytes at D = 320, 230,504 at 384, 205,896 at 448,
// 230,472 at 512.  Key tiles of 64 would fit at D = 512 only with a single
// stage.

#include <type_traits>

#include "sm90.cuh"

namespace edl_attn {
namespace {

template <int D>
struct FwdSplitCfg {
  static constexpr int kBoxes = D / 64;          // 64-column boxes of D
  static constexpr int kOwn = (kBoxes + 1) / 2;  // output boxes each consumer accumulates
  static constexpr int kSteps = D / 32;          // score k-steps each consumer issues
  static constexpr int kBlockM = 64, kBlockN = 32;
  static constexpr int kStages = kBoxes <= 6 ? 3 : 2;
  static constexpr int kQBytes = kBlockM * kBoxes * kRowBytes;
  static constexpr int kTileBytes = kBlockN * kBoxes * kRowBytes;  // one K or V tile
  static constexpr int kXBytes = kBlockM * kBlockN * 4;  // one consumer's partial scores
  // Q, then the K stages, the V stages, the exchange, the barriers
  static constexpr int kKOff = kQBytes, kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kXOff = kVOff + kStages * kTileBytes;
  static constexpr int kBarOff = kXOff + 4 * kXBytes;
  static constexpr size_t kSmem = 1024 + kBarOff + 8 * (1 + 4 * kStages);
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_split_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                               float* __restrict__ lse, Strides so, int H, int Lq, int Lk, float scale) {
  using C = FwdSplitCfg<D>;
  constexpr int BM = C::kBlockM, BN = C::kBlockN, S = C::kStages, NB = C::kBoxes, OWN = C::kOwn;
  constexpr int TILE = C::kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = align_1k(smem_raw);
  const uint32_t sQ = smem_u32(base), sK = sQ + C::kKOff, sV = sQ + C::kVOff, bars = sQ + C::kBarOff;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + S + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * S + s); };
  auto ph_of = [&](int j) { return (uint32_t)((j / S) & 1); };

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NB * BM * kRowBytes);
      for (int c = 0; c < NB; ++c) tma_load(sQ + c * BM * kRowBytes, &tq, q_full, c * 64, h, q0, b);
      // tile j of K or V into its stage, once the consumers released it
      auto load = [&](uint32_t ring, const CUtensorMap* map, uint32_t full, uint32_t empty, int j) {
        mbar_wait(empty, ph_of(j) ^ 1);
        mbar_expect_tx(full, NB * BN * kRowBytes);
        for (int c = 0; c < NB; ++c)
          tma_load(ring + (j % S) * TILE + c * BN * kRowBytes, map, full, c * 64, h, j * BN, b);
      };
      // in the order the consumers take them: K of tile j + 1, then V of tile j
      load(sK, &tk, k_full(0), k_empty(0), 0);
      for (int j = 0; j < n_kt; ++j) {
        if (j + 1 < n_kt) load(sK, &tk, k_full((j + 1) % S), k_empty((j + 1) % S), j + 1);
        load(sV, &tv, v_full(j % S), v_empty(j % S), j);
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int kk0 = cw * C::kSteps;  // this consumer's first score k-step
  const int box0 = cw * (NB - OWN);  // and its first output box (overlapping if NB is odd)

  float acc[OWN * 8][4];  // this consumer's 64 x 64 OWN columns of O
#pragma unroll
  for (int n = 0; n < OWN * 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  float s[BN / 8][4];                // this consumer's partial scores, in flight
  uint32_t pf[BN / 16][4];           // P in bf16, as A fragments
  // exchange buffer (parity p, consumer c): element block n of thread i at
  // [(2 p + c) * BN / 8 * kWgThreads + n * kWgThreads + i]
  float4* const xbuf = reinterpret_cast<float4*>(base + C::kXOff);

  // S_c of tile j = Q[:, k_c] K_j[:, k_c]^T, one commit group
  auto issue_scores = [&](int j) {
    const uint32_t kt = sK + (j % S) * TILE;
    mbar_wait(k_full(j % S), ph_of(j));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
      wgmma_ss<BN>(s, kmajor(sQ, BM, 0, kk0 + kk), kmajor(kt, BN, 0, kk0 + kk), kk > 0);
    wg_commit();
  };

  // One key tile: its partial scores are in flight (issued by the tile
  // before, or below); with kNext, issue the next tile's before this one's
  // exchange and softmax.  Commit groups in flight on entry: S_c(j), then
  // tile j - 1's P V.
  auto tile = [&](int j, auto mask_tag, auto next_tag) {
    constexpr bool kMask = decltype(mask_tag)::kOn, kNext = decltype(next_tag)::value;
    wg_wait<1>();  // S_c(j)
    fence_acc(s);
    mbar_arrive(k_empty(j % S));
    float4* mine = xbuf + ((j & 1) * 2 + cw) * (BN / 8) * kWgThreads + tid;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) mine[n * kWgThreads] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    if constexpr (kNext) issue_scores(j + 1);
    consumers_sync();
    // S = S_0 + S_1, added in this order by both consumers
    const float4* both = xbuf + (j & 1) * 2 * (BN / 8) * kWgThreads + tid;
    float x[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float4 a = both[n * kWgThreads], c = both[(BN / 8 + n) * kWgThreads];
      x[n][0] = a.x + c.x;
      x[n][1] = a.y + c.y;
      x[n][2] = a.z + c.z;
      x[n][3] = a.w + c.w;
    }
    softmax_tile<BN, CAUSAL>(x, m, l, alpha, j * BN, row, Lk, sl2, t, kMask);
    if constexpr (kNext) {
      wg_wait<1>();  // tile j - 1's P V (S_c(j + 1) may still run)
    } else {
      wg_wait<0>();
    }
    fence_acc(acc);
    if (j > 0) mbar_arrive(v_empty((j - 1) % S));
#pragma unroll
    for (int n = 0; n < OWN * 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pf[kk], x[2 * kk], x[2 * kk + 1]);
    // O_c += P V_j[:, this consumer's boxes]
    mbar_wait(v_full(j % S), ph_of(j));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb<OWN * 64>(acc, pf[kk], mnmajor(sV + (j % S) * TILE + box0 * BN * kRowBytes, BN, kk),
                            1);
    wg_commit();
  };

  mbar_wait(q_full, 0);
  issue_scores(0);
  wg_commit();  // an empty group in the place of tile -1's P V
  // tiles every row sees in full, then those that need the masks; the last
  // tile (masked, for simplicity, if it need not be) issues no next scores
  const int n_full = CAUSAL ? min((q0 + 1) / BN, Lk / BN) : Lk / BN;
  const int last = n_kt - 1;
  int j = 0;
  for (; j < min(n_full, last); ++j) tile(j, MaskTag<false>{}, std::true_type{});
  for (; j < last; ++j) tile(j, MaskTag<true>{}, std::true_type{});
  tile(last, MaskTag<true>{}, std::false_type{});
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive(v_empty(last % S));

  // this consumer's columns (consumer 1's from where consumer 0's end), and
  // (consumer 0) the logsumexp
  const int c0 = box0 * 64;
  bf16* ob = o + b * so.b + h * so.h + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tot = quad_sum(l[i]);
    if (row[i] >= Lq) continue;
    const float inv = 1.f / tot;
    bf16* orow = ob + (long long)row[i] * so.l;
#pragma unroll
    for (int n = 0; n < OWN * 8; ++n) {
      if (c0 + n * 8 >= cw * OWN * 64)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_f32(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (cw == 0 && t == 0) lse[(long long)bh * Lq + row[i]] = m[i] * kLn2 + logf(tot);
  }
}

template <int D, bool CAUSAL>
cudaError_t run_fwd_split(const void* q, const void* k, const void* v, void* o, void* lse,
                          const long long* st, int B, int H, int Lq, int Lk, float scale,
                          cudaStream_t stream) {
  using C = FwdSplitCfg<D>;
  CUtensorMap tq, tk, tv;
  // a runtime call first: it makes the device's context current in this
  // thread, which the tensor-map encode, a driver call, needs
  cudaError_t err = set_smem(attn_fwd_split_sm90_kernel<D, CAUSAL>, C::kSmem);
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, C::kBlockM);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, C::kBlockN);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, C::kBlockN);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lq + C::kBlockM - 1) / C::kBlockM);
  attn_fwd_split_sm90_kernel<D, CAUSAL><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, strides_at(st, 3), H, Lq, Lk, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t fwd_split_sm90(int D, bool causal, const void* q, const void* k, const void* v, void* o,
                           void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                           cudaStream_t stream) {
#define EDL_FWD_SPLIT(DD)                                                                      \
  case DD:                                                                                     \
    return causal ? run_fwd_split<DD, true>(q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream)  \
                  : run_fwd_split<DD, false>(q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
  switch (D) {
    EDL_FWD_SPLIT(320)
    EDL_FWD_SPLIT(384)
    EDL_FWD_SPLIT(448)
    EDL_FWD_SPLIT(512)
  }
#undef EDL_FWD_SPLIT
  return cudaErrorInvalidValue;
}

}  // namespace edl_attn
