// What the Hopper attention kernels (attention_sm90.cu,
// attention_wide_sm90.cu, attention_chunk_sm90.cu) share: mbarriers, TMA
// tile loads and their tensor maps, the wgmma fences, setmaxnreg, the
// shared-memory matrix descriptors of 128-byte-swizzled tiles, the online
// softmax of one score tile, the consumers' named barrier.
#pragma once

#include <cuda.h>

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace edl_attn {
namespace {

// -- mbarrier, TMA, wgmma and setmaxnreg -------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed (a barrier starts
// in phase 0; waiting on parity 1 then returns at once).  A wait of more
// than ~2^34 cycles (seconds) can only be a fault: it traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
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

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j]) :: "memory");
}

// Make the compiler form register A fragments here, before the fence that
// precedes their wgmma: a fragment put together between two wgmmas makes
// ptxas inject a fence there (C7519), which can serialise every wgmma of
// the kernel (C7520).
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

template <int R>
__device__ __forceinline__ void regs_dealloc() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R)); }
template <int R>
__device__ __forceinline__ void regs_alloc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R)); }

// Shared-memory matrix descriptor, 128-byte swizzle.  A tile is stored as
// 64-column boxes (128-byte rows, 8-row / 1024-byte swizzle atoms), the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B.  K-major operands:
// sbo = 1024 (next 8 rows), lbo unused; a 16-column k-step inside a box
// advances the start by 32 bytes.  MN-major operands (rows are k): sbo =
// 1024 (next 8 k-rows), lbo = the byte distance to the next 64-column box.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // producer warpgroup + two consumers
constexpr int kRowBytes = 128;            // one 64-column bf16 box row
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// K-major descriptor of k-step kk (16 columns) of a tile of `rows` rows,
// starting `row0` rows into each of its 64-column boxes.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * kRowBytes + row0 * kRowBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major descriptor of k-step kk (16 rows) of a tile of `rows` rows.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes, 1024);
}

// One step of the online softmax on a 64 x BN score tile (wgmma layout)
// whose first key is k0: mask if `edge` (causal, top-left; col >= Lk),
// scale into the log2 domain, update the running max m and per-thread
// partial sum l, and leave P = exp2(S - max) in sc and the rescale factor
// of the earlier tiles in alpha.  A caller that passes `edge` as a
// compile-time constant gets a body with or without the mask.
template <int BN, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, const int (&row)[2], int Lk,
                                             float sl2, int t, bool edge) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + n * 8 + 2 * t + (e & 1);
      float x = sc[n][e] * sl2;
      if (edge && ((CAUSAL && col > row[e >> 1]) || col >= Lk)) x = -INFINITY;
      sc[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
    alpha[i] = exp2f(m[i] - base[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sc[n][e] - base[e >> 1]);
      sc[n][e] = p;
      sum[e >> 1] += p;
    }
  }
  // l stays a per-thread partial sum; alpha is common to the quad
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// The two consumer warpgroups' own barrier (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Selects, at compile time, a tile body with or without masks.
template <bool ON>
struct MaskTag {
  static constexpr bool kOn = ON;
};

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + (((smem_u32(p) + 1023) & ~1023u) - smem_u32(p));
}

// -- host: tensor maps -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime, so that the
// library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over one bf16 [B, L, H, D] operand as the 4-D tensor {D, H, L, B}
// with its byte strides, read in boxes of 64 columns x `rows` rows with the
// 128-byte swizzle.  Rows past L read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, Strides st, int B, int L, int H, int D,
                     int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.l * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace edl_attn
