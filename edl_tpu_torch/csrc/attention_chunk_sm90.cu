// The attention forward above head dim 512 for Hopper, every D % 64 == 0:
// attention_wide_sm90.cu's design (TMA tile loads into mbarrier rings,
// wgmma products, one producer warpgroup and two consumer warpgroups that
// split the output columns and exchange partial scores) on chunks of the
// output columns.
//
// Replaces, behind the forward entry points of attention.cu (edl_attn_fwd,
// edl_flash_fwd), splash_attention/splash_attention_kernel.py:1137 and
// flash_attention.py:758 (jax/experimental/pallas/ops/tpu/, reached from
// edl_tpu/ops/attention.py _splash and _flash) above D = 512, where the
// mma.sync forward of attention_wide.cu ran before: O and the f32
// logsumexp, causal (top-left: key j is visible to query i iff j <= i) or
// not, Lq and Lk free.
//
// What bounds it on an H100: as attention_wide_sm90.cu's kernel, 4 Lq Lk D
// flops on the bytes of q, k, v and o.  What it does about it:
//   - A 64 x D f32 O is 160 KB or more at D >= 640, beyond the registers of
//     two consumers (128 a thread each at D = 512), so grid z splits the
//     output's 64-column boxes into ceil(D / 384) chunks of about equal
//     width (two of 320 columns at D = 640, two of 384 at 768).  Grid
//     (B * H, ceil(Lq / 64), chunks), the longest causal rows first.  Each
//     block computes the whole score product for its chunk: 1.6 times the
//     products the bound counts at D = 640 and 1.5 times at 768 (the
//     mma.sync kernel did 3 and 2.4 times, in 128-column chunks, and
//     reloaded every operand per tile).
//   - Within a block the two consumers split the chunk: each accumulates
//     kChunkOwn = 3 boxes (m64n192, 96 registers a thread), overlapping in
//     the middle when the chunk has fewer than 6, which consumer 1 then
//     does not store; each issues half the score k-steps, and the partial
//     scores cross through the double-buffered exchange of
//     attention_wide_sm90.cu, added in one order by both, so both run the
//     same softmax.
//   - Q stays resident while it fits.  K streams through a ring of
//     64-column boxes per consumer (32 keys x 64 columns, 4 KB): consumer
//     c's ring holds the boxes of its score k-steps, tile after tile, from
//     box c ceil(D / 128) on.  At an odd box count consumer 1's last box
//     lies past D, where TMA fills it with zeros, so both consumers run
//     one body (1/10 more score work at D = 576).  The rings take the
//     shared memory that Q, two V stages of the chunk's columns and the
//     exchange leave: from two tiles' boxes at D = 576 down to one at 768,
//     so the next tile's boxes load while this one's exchange and softmax
//     run.
//   - Per key tile j, each consumer issues S_c(j) and then the P V product
//     of tile j - 1, waits for S_c(j) only, exchanges and runs tile j's
//     softmax while P V runs, and waits for P V at the tile's end (the
//     order of FlashAttention-3's consumer loop).  No wgmma is in flight
//     from one tile to the next: attention_wide_sm90.cu's order, which
//     issues S(j + 1) before tile j's exchange, keeps an accumulator in
//     flight across the loop, and ptxas serialises every wgmma of such a
//     kernel (C7515); here that order ran 15-20% slower (PERF.md).
//   - Up to D = 768 the plan (chunks, ring slots, offsets) is a
//     compile-time constant, so every loop over boxes unrolls.  With a
//     run-time plan, ptxas injects a wgmma fence after the loop over boxes
//     and serialises every wgmma of the kernel (C7520); P's A fragments are
//     formed before the P V fence, as a fragment formed between two wgmmas
//     does the same.
//   - Above 768 (a run-time plan) the rings cannot hold a tile, so each
//     box is released as soon as its products finish (kSerial); where Q
//     does not fit beside two slots a ring (D >= 1088), each ring slot
//     also carries the Q box of its k-steps, read again for every key
//     tile.  Slower, but every D runs.
//   - Masks, exchange, softmax and the order of the P V products are those
//     of attention_wide_sm90.cu; the logsumexp is written by chunk 0.
// Shared memory (with 1 KB of alignment slack), ring slots per consumer:
// D = 576: 230,760 bytes, 10 slots; 640: 230,728, 9; 704: 230,664, 7;
// 768: 230,632, 6; 1024: 230,504, 2 (serial); 1088 and above: 230,632, 6
// (serial, Q in the slots) (plan_fwd_chunk).

#include <type_traits>

#include "sm90.cuh"

namespace edl_attn {
namespace {

constexpr int kChunkOwn = 3;      // output boxes each consumer accumulates
constexpr int kMaxSmem = 232448;  // shared memory a block may use on an H100

// The run-time plan of one head dim (plan_fwd_chunk); the kernel built for
// it takes only plans whose rings cannot hold a tile.
struct FwdChunkPlan {
  static constexpr bool kSerial = true;  // each box released as its products finish
  int nb, nc, nbc;  // 64-column boxes of D; chunks (grid z); boxes of a consumer's k-steps a tile
  int ring;         // slots of each consumer's K ring
  int qres;         // Q resident; else a Q box rides in each ring slot
  int serial;       // release each slot as its products finish (ring < nbc)
  int slot, vstage; // bytes of one ring slot, of one V stage
  int k_off, v_off, x_off, bar_off;  // byte offsets from the aligned base
  int smem;
};

// The largest rings (at most two tiles each) that fit beside Q (qres) or
// not, in slots of `slot` bytes; false if not one slot fits.
constexpr bool plan_rings(FwdChunkPlan& p, int qres, int slot) {
  p.qres = qres;
  p.slot = slot;
  p.k_off = qres ? p.nb * 64 * kRowBytes : 0;
  for (p.ring = 2 * p.nbc; p.ring > 0; --p.ring) {
    p.v_off = p.k_off + 2 * p.ring * slot;
    p.x_off = p.v_off + 2 * p.vstage;
    p.bar_off = p.x_off + 4 * 64 * 32 * 4;  // the exchange: 2 parities x 2 consumers x 64 x 32 f32
    p.smem = 1024 + p.bar_off + 8 * (1 + 4 * p.ring + 4);
    if (p.smem <= kMaxSmem) return true;
  }
  return false;
}

constexpr FwdChunkPlan plan_fwd_chunk(int D) {
  FwdChunkPlan p{};
  p.nb = D / 64;
  p.nc = (p.nb + 2 * kChunkOwn - 1) / (2 * kChunkOwn);
  p.nbc = (p.nb + 1) / 2;
  p.vstage = (p.nb + p.nc - 1) / p.nc * 32 * kRowBytes;
  if (!plan_rings(p, 1, 32 * kRowBytes) || p.ring < 2) plan_rings(p, 0, 96 * kRowBytes);
  p.serial = p.ring < p.nbc;
  return p;
}

// The plan of head dim D as compile-time constants (D <= 768: the rings
// hold a tile).
template <int D>
struct FwdChunkFixed {
  static constexpr FwdChunkPlan p = plan_fwd_chunk(D);
  static_assert(!p.serial && p.qres, "a fixed plan holds Q and a tile of K");
  static constexpr bool kSerial = false;
  static constexpr int nb = p.nb, nc = p.nc, nbc = p.nbc, ring = p.ring;
  static constexpr int qres = 1, slot = p.slot, vstage = p.vstage;
  static constexpr int k_off = p.k_off, v_off = p.v_off, x_off = p.x_off, bar_off = p.bar_off;
  static constexpr int smem = p.smem;
};

// P: FwdChunkFixed<D>, or FwdChunkPlan (a run-time plan whose rings cannot
// hold a tile).  Either is read through `pl`.
template <class P, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_chunk_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                               float* __restrict__ lse, Strides so, int H, int Lq, int Lk, float scale,
                               const P pl) {
  constexpr int BM = 64, BN = 32, S = 2, OWN = kChunkOwn;  // S: V stages
  constexpr int kBox = BN * kRowBytes;  // one 32-key box of 64 columns
  constexpr bool SERIAL = P::kSerial;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = align_1k(smem_raw);
  const uint32_t sQ = smem_u32(base), sK = sQ + pl.k_off, sV = sQ + pl.v_off, bars = sQ + pl.bar_off;
  const int NB = pl.nb, NBC = pl.nbc, R = pl.ring;
  const uint32_t q_full = bars;
  auto k_full = [&](int c, int s) { return bars + 8 * (1 + 2 * c * R + s); };
  auto k_empty = [&](int c, int s) { return bars + 8 * (1 + 2 * c * R + R + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + 4 * R + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 4 * R + S + s); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Lq + BM - 1) / BM;
  // causal: the last query tiles see the most keys, so they launch first
  const int q0 = (CAUSAL ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * BM;
  const int n_kt = (CAUSAL ? min(q0 + BM - 1, Lk - 1) : Lk - 1) / BN + 1;
  // this block's output boxes: cb of them from box b0
  const int b0 = (int)blockIdx.z * NB / pl.nc, cb = ((int)blockIdx.z + 1) * NB / pl.nc - b0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int c = 0; c < 2; ++c)
      for (int s = 0; s < R; ++s) {
        mbar_init(k_full(c, s), 1);
        mbar_init(k_empty(c, s), kWgThreads);
      }
    for (int s = 0; s < S; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // producer
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      if (pl.qres) {
        mbar_expect_tx(q_full, NB * BM * kRowBytes);
        for (int c = 0; c < NB; ++c) tma_load(sQ + c * BM * kRowBytes, &tq, q_full, c * 64, h, q0, b);
      }
      // the boxes of both consumers' k-steps of key tile j, in the order
      // they issue them
      auto load_k = [&](int j) {
        for (int i = 0; i < NBC; ++i)
          for (int c = 0; c < 2; ++c) {
            const int n = j * NBC + i, gb = c * NBC + i;
            const uint32_t slot = sK + (c * R + n % R) * pl.slot, full = k_full(c, n % R);
            mbar_wait(k_empty(c, n % R), ((n / R) & 1) ^ 1);
            mbar_expect_tx(full, pl.slot);
            if (!pl.qres) tma_load(slot, &tq, full, gb * 64, h, q0, b);
            tma_load(slot + pl.slot - kBox, &tk, full, gb * 64, h, j * BN, b);
          }
      };
      auto load_v = [&](int j) {
        const int s = j % S;
        mbar_wait(v_empty(s), ((j / S) & 1) ^ 1);
        mbar_expect_tx(v_full(s), cb * kBox);
        for (int c = 0; c < cb; ++c)
          tma_load(sV + s * pl.vstage + c * kBox, &tv, v_full(s), (b0 + c) * 64, h, j * BN, b);
      };
      // in the order the consumers take them: K of tile j with V of tile j - 1
      for (int j = 0; j < n_kt; ++j) {
        load_k(j);
        if (j > 0) load_v(j - 1);
      }
      load_v(n_kt - 1);
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int cw = threadIdx.x / kWgThreads - 1, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int vb = cw * (cb - OWN);  // this consumer's first output box in the chunk

  float acc[OWN * 8][4];  // this consumer's 64 x 64 OWN columns of O
#pragma unroll
  for (int n = 0; n < OWN * 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  uint32_t pf[BN / 16][4];           // P of the tile before, in bf16, as A fragments
  // exchange buffer (parity p, consumer c): element block n of thread i at
  // [(2 p + c) * BN / 8 * kWgThreads + n * kWgThreads + i]
  float4* const xbuf = reinterpret_cast<float4*>(base + pl.x_off);

  // One key tile j.  Issue S_c(j) = Q[:, k_c] K_j[:, k_c]^T and (but for
  // tile 0) O_c = alpha(j - 1) O_c + P(j - 1) V_{j-1}[:, this consumer's
  // boxes]; wait for S_c(j) and release K_j; exchange the partial scores;
  // run tile j's softmax (P(j), alpha(j)) while P V runs; wait for it and
  // release V_{j-1}.  No product is in flight from one tile to the next: an
  // accumulator kept in flight across the loop makes ptxas serialise every
  // wgmma (C7515), which a version that issued S(j + 1) before tile j's
  // softmax did.
  auto tile = [&](int j, auto mask_tag, auto first_tag) {
    constexpr bool kMask = decltype(mask_tag)::kOn, kFirst = decltype(first_tag)::value;
    float s[BN / 8][4];  // S_c(j)
#pragma unroll
    for (int i = 0; i < NBC; ++i) {  // this consumer's boxes of K_j
      const int n = j * NBC + i, gb = cw * NBC + i, si = n % R;
      const uint32_t slot = sK + (cw * R + si) * pl.slot, ka = slot + pl.slot - kBox;
      // the pad box (gb == NB) has zero K: any finite Q box will do
      const uint32_t qa = pl.qres ? sQ + (gb < NB ? gb : 0) * BM * kRowBytes : slot;
      mbar_wait(k_full(cw, si), (n / R) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN>(s, sw128_desc(qa + kk * 32, 16, 1024), sw128_desc(ka + kk * 32, 16, 1024),
                     i > 0 || kk > 0);
      if constexpr (SERIAL) {  // the ring holds less than a tile
        wg_commit();
        wg_wait<0>();
        fence_acc(s);
        mbar_arrive(k_empty(cw, si));
      }
    }
    wg_commit();
    if constexpr (!kFirst) {
#pragma unroll
      for (int n = 0; n < OWN * 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      mbar_wait(v_full((j - 1) % S), ((j - 1) / S) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_tb<OWN * 64>(acc, pf[kk], mnmajor(sV + (j - 1) % S * pl.vstage + vb * kBox, BN, kk), 1);
      wg_commit();
      wg_wait<1>();  // S_c(j); P V may still run
    } else {
      wg_wait<0>();
    }
    fence_acc(s);
    if constexpr (!SERIAL) {
#pragma unroll
      for (int i = 0; i < NBC; ++i) mbar_arrive(k_empty(cw, (j * NBC + i) % R));
    }
    float4* mine = xbuf + ((j & 1) * 2 + cw) * (BN / 8) * kWgThreads + tid;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) mine[n * kWgThreads] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
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
    if constexpr (!kFirst) {
      wg_wait<0>();  // P(j - 1) V_{j-1}
      fence_acc(acc);
      mbar_arrive(v_empty((j - 1) % S));
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pf[kk], x[2 * kk], x[2 * kk + 1]);
    fence_frag(pf);
  };

  if (pl.qres) mbar_wait(q_full, 0);
  // the first tile (masked, for simplicity, if it need not be), the tiles
  // every row sees in full, then those that need the masks
  const int n_full = CAUSAL ? min((q0 + 1) / BN, Lk / BN) : Lk / BN;
  tile(0, MaskTag<true>{}, std::true_type{});
  int j = 1;
  for (; j < n_full; ++j) tile(j, MaskTag<false>{}, std::false_type{});
  for (; j < n_kt; ++j) tile(j, MaskTag<true>{}, std::false_type{});
  // the last tile's P V
  const int last = n_kt - 1;
#pragma unroll
  for (int n = 0; n < OWN * 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  mbar_wait(v_full(last % S), (last / S) & 1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_tb<OWN * 64>(acc, pf[kk], mnmajor(sV + last % S * pl.vstage + vb * kBox, BN, kk), 1);
  wg_commit();
  wg_wait<0>();
  fence_acc(acc);
  mbar_arrive(v_empty(last % S));

  // this consumer's columns (consumer 1's from where consumer 0's end), and
  // (chunk 0, consumer 0) the logsumexp
  bf16* ob = o + b * so.b + h * so.h + (b0 + vb) * 64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tot = quad_sum(l[i]);
    if (row[i] >= Lq) continue;
    const float inv = 1.f / tot;
    bf16* orow = ob + (long long)row[i] * so.l;
#pragma unroll
    for (int n = 0; n < OWN * 8; ++n) {
      if (vb * 64 + n * 8 >= cw * OWN * 64)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_f32(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (cw == 0 && blockIdx.z == 0 && t == 0) lse[(long long)bh * Lq + row[i]] = m[i] * kLn2 + logf(tot);
  }
}

template <class P, bool CAUSAL>
cudaError_t run_fwd_chunk(const P& pl, int D, const void* q, const void* k, const void* v, void* o,
                          void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                          cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // a runtime call first: it makes the device's context current in this
  // thread, which the tensor-map encode, a driver call, needs
  cudaError_t err = set_smem(attn_fwd_chunk_sm90_kernel<P, CAUSAL>, pl.smem);
  if (err == cudaSuccess) err = make_map(&tq, q, strides_at(st, 0), B, Lq, H, D, 64);
  if (err == cudaSuccess) err = make_map(&tk, k, strides_at(st, 1), B, Lk, H, D, 32);
  if (err == cudaSuccess) err = make_map(&tv, v, strides_at(st, 2), B, Lk, H, D, 32);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)B * H, (Lq + 63) / 64, pl.nc);
  attn_fwd_chunk_sm90_kernel<P, CAUSAL><<<grid, kThreads, pl.smem, stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, strides_at(st, 3), H, Lq, Lk, scale, pl);
  return cudaGetLastError();
}

template <class P>
cudaError_t launch_fwd_chunk(const P& pl, int D, bool causal, const void* q, const void* k, const void* v,
                          void* o, void* lse, const long long* st, int B, int H, int Lq, int Lk,
                          float scale, cudaStream_t stream) {
  return causal ? run_fwd_chunk<P, true>(pl, D, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream)
                : run_fwd_chunk<P, false>(pl, D, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
}

}  // namespace

cudaError_t fwd_chunk_sm90(int D, bool causal, const void* q, const void* k, const void* v, void* o,
                           void* lse, const long long* st, int B, int H, int Lq, int Lk, float scale,
                           cudaStream_t stream) {
#define EDL_FWD_CHUNK(DD)                                                                  \
  case DD:                                                                                 \
    return launch_fwd_chunk(FwdChunkFixed<DD>{}, DD, causal, q, k, v, o, lse, st, B, H, Lq, Lk, \
                            scale, stream);
  switch (D) {
    EDL_FWD_CHUNK(576)
    EDL_FWD_CHUNK(640)
    EDL_FWD_CHUNK(704)
    EDL_FWD_CHUNK(768)
  }
#undef EDL_FWD_CHUNK
  if (D <= 768 || D % 64 != 0) return cudaErrorInvalidValue;
  const FwdChunkPlan pl = plan_fwd_chunk(D);
  if (!pl.serial) return cudaErrorInvalidValue;  // no plan above 768 holds a tile
  return launch_fwd_chunk(pl, D, causal, q, k, v, o, lse, st, B, H, Lq, Lk, scale, stream);
}

}  // namespace edl_attn
