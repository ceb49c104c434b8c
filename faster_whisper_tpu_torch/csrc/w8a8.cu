// W8A8: the port's int8 product, y = rescale(quantize_rows(x) @ W), for a
// weight with one float32 scale per output channel (int8 codes in
// [-127, 127], or compute_type="int4"'s per-channel codes in [-7, 7]).
//
// It replaces no TPU kernel: the JAX package's ops/quant.py::int8_dense
// leaves this product to XLA.  On the card it replaces PyTorch's composition
// of ops/quant.py (_quantize_rows, torch._int_mm, _rescale: about 17
// launches, the product on cuBLASLt's sm80 WMMA kernel) by two launches of
// one call (the second alone for a further weight on the same x), with the
// same bits:
//
//   1. quantize_rows_kernel, one CTA per row of x (bfloat16 or float32):
//      amax = max |x| over the row, sx = max(amax * float32(1/127), 1e-10),
//      codes = clamp(rint(x / sx), -127, 127) as int8, the division IEEE
//      (__fdiv_rn) as PyTorch's tensor division is, rint half to even as
//      torch.round is;
//   2. w8a8_gemm_kernel: the int32 product on the tensor cores (wgmma
//      m64nNk32 .s32.s8.s8, both operands K-major in shared memory, loaded
//      by TMA into a ring of stages; one producer thread, one or two
//      consumer warpgroups), and in registers the rescale
//      ((float)acc * sx) * ws, then + b, then one rounding to the output
//      type (bfloat16 or float32): each product and sum rounded on its own
//      (__fmul_rn, __fadd_rn: no FMA contraction), in _rescale's order.
//
// The weight is the (in, out) view of (out, in)-contiguous codes
// (ops/quant.py::card_layout): s8 wgmma reads both operands K-major only.
//
// What bounds it on an H100: at the decode's 5-64 rows, the weight's bytes
// (1.6 MB for 1280 x 1280, 66 MB for the 1280 x 51872 logits head, at
// 3.35 TB/s), and below ~10 us the launch floor; at the encoder's 12000
// rows, int8 operations (1979 TOP/s).  What the design does about it: the
// plan follows the row count M, which the kernel observes, and nothing else
// (ops/quant.py::_plan):
//
//   * M <= 64: swap A and B.  The weight is wgmma's 64-row A operand and x
//     its B operand of 16, 32 or 64 columns, so the weight streams through
//     64-row tiles and x rides along;
//   * M > 64: 128 x 128 tiles of the output, two consumer warpgroups of 64
//     rows, x as A and the weight as B.
//
// Persistent CTAs walk the tiles, so the next tile's loads run under a
// tile's rescale.  The contraction is not split: on an H100, splits whose
// int32 partials were summed with atomic adds (the last CTA of a tile
// applying the rescale) lost at most shapes of the main path (40 x 1280 @
// 1280 x 1280: 10.7 us unsplit, 13.1-14.8 in 2 to 10 splits; 1500 x 1280 @
// 1280 x 1280: 16.3 against 54.5-204.4) and gained at most 3 us at the
// others (5 x 5120 @ 5120 x 1280: 13.9 in 5 splits, 16.8 unsplit), where
// the host's ~33 us a call paces the step.
//
// An int32 sum is exact in any order and the rescale is per element, so
// every plan gives the same bits: a row's output does not follow the row
// count or the grid.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int KT = 128;          // contraction bytes per tile: one 128-byte swizzle row
constexpr int Q_THREADS = 128;   // row quantization: one CTA per row
constexpr int Q_VEC = 8;         // elements per load
constexpr float kInv127 = (float)(1.0 / 127.0);  // PyTorch's amax * (1.0 / 127) in float32
constexpr float kScaleFloor = 1e-10f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor for a tile of 128-byte rows in the
// 128-byte swizzle that TMA writes (tile base 1024-byte aligned): start
// address in 16-byte units, leading offset 1 (not read for these widths),
// 1024 bytes between groups of 8 rows, layout 128B swizzle.  A k-step of
// 32 bytes adds 2 to it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 16, s32) (+)= A (64 x 32, s8) * B (32 x 16, s8), both K-major in shared
// memory (128-byte swizzle); D is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_m64n16k32(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, s32) (+)= A (64 x 32, s8) * B (32 x 32, s8), both K-major in shared
// memory (128-byte swizzle); D is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_m64n32k32(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, s32) (+)= A (64 x 32, s8) * B (32 x 64, s8), both K-major in shared
// memory (128-byte swizzle); D is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_m64n64k32(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, s32) (+)= A (64 x 32, s8) * B (32 x 128, s8), both K-major in shared
// memory (128-byte swizzle); D is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BN == 16) wgmma_m64n16k32(d, da, db, accumulate);
  else if constexpr (BN == 32) wgmma_m64n32k32(d, da, db, accumulate);
  else if constexpr (BN == 64) wgmma_m64n64k32(d, da, db, accumulate);
  else wgmma_m64n128k32(d, da, db, accumulate);
}

// ---------------------------------------------------------------------------
// 1. Row quantization
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Row `blockIdx.x` of x (K elements, rows `ldx` elements apart) into K
// int8 codes at xq + row * K and its scale at sx[row].
template <typename T>
__global__ void __launch_bounds__(Q_THREADS) quantize_rows_kernel(const T* __restrict__ x, long ldx,
                                                                  int K, int8_t* __restrict__ xq,
                                                                  float* __restrict__ sx) {
  __shared__ float warp_max[Q_THREADS / 32];
  const int row = blockIdx.x;
  const T* xr = x + (size_t)row * ldx;
  int8_t* qr = xq + (size_t)row * K;
  const int n_vec = K / Q_VEC;

  float amax = 0.f;
  for (int v = threadIdx.x; v < n_vec; v += Q_THREADS) {
    float f[Q_VEC];
    load8(xr + Q_VEC * v, f);
#pragma unroll
    for (int e = 0; e < Q_VEC; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < Q_THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = fmaxf(__fmul_rn(amax, kInv127), kScaleFloor);
  if (threadIdx.x == 0) sx[row] = s;
  for (int v = threadIdx.x; v < n_vec; v += Q_THREADS) {
    float f[Q_VEC];
    load8(xr + Q_VEC * v, f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < Q_VEC; ++e) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(f[e], s)), -127.f), 127.f);
      packed[e >> 2] |= ((uint32_t)(uint8_t)(int8_t)q) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(qr + Q_VEC * v) = make_uint2(packed[0], packed[1]);
  }
}

// ---------------------------------------------------------------------------
// 2. The int8 product and the rescale
// ---------------------------------------------------------------------------

template <typename OutT>
__device__ __forceinline__ OutT to_out(float y);
template <>
__device__ __forceinline__ float to_out<float>(float y) {
  return y;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float y) {
  return __float2bfloat16_rn(y);
}

// ((float)acc * sx) * ws (+ b), each step rounded on its own: _rescale.
// bias_kind: 0 none, 1 bfloat16, 2 float32.
__device__ __forceinline__ float rescale(int acc, float sxm, float wsn, const void* bias,
                                         int bias_kind, int n) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), wsn);
  if (bias_kind == 1) {
    y = __fadd_rn(y, __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]));
  } else if (bias_kind == 2) {
    y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
  }
  return y;
}

constexpr int gemm_smem_bytes(int bn, int nwg, int stages) {
  return 1024 /* alignment slack */ + stages * (64 * nwg + bn) * KT + 16 * stages;
}

// One CTA (three resident per SM with one consumer warpgroup, one with
// two): warpgroup 0's first thread issues every TMA load; warpgroups
// 1 .. NWG consume.  A tile of the accumulator is (64 NWG rows of A) x (BN
// rows of B): A is x's codes and B the weight's (SWAP false), or A the
// weight's and B x's (SWAP true).  CTAs take tiles blockIdx.x, +
// gridDim.x, ...; the ring's stage and parity run on across tiles, in the
// same order in the producer and the consumers.
template <int BN, int NWG, int STAGES, bool SWAP, typename OutT>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 3 : 1) w8a8_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const float* __restrict__ sx, const float* __restrict__ ws, const void* __restrict__ bias,
    int bias_kind, OutT* __restrict__ out, int M, int N, int k_tiles, int tiles_b, int n_tiles) {
  constexpr int BM = 64 * NWG;
  constexpr int A_BYTES = BM * KT;
  constexpr int B_BYTES = BN * KT;
  constexpr int CONSUMERS = 128 * NWG;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sa = (raw + 1023u) & ~1023u;    // A: STAGES tiles of BM x 128
  const uint32_t sb = sa + STAGES * A_BYTES;     // B: STAGES tiles of BN x 128
  const uint32_t bar = sb + STAGES * B_BYTES;    // mbarriers: full, then empty
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int a0 = (tile / tiles_b) * BM;
        const int b0 = (tile % tiles_b) * BN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(full(s), A_BYTES + B_BYTES);
          tma_load_2d(sa + s * A_BYTES, &tm_a, kt * KT, a0, full(s));
          tma_load_2d(sb + s * B_BYTES, &tm_b, kt * KT, b0, full(s));
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x - 128;  // consumer thread
  const int wg = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
  const int t = lane & 3;   // accumulator column pair
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int a0 = (tile / tiles_b) * BM;
    const int b0 = (tile % tiles_b) * BN;

    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = 0;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      const uint64_t da = sw128_desc(sa + s * A_BYTES + wg * 64 * KT);
      const uint64_t db = sw128_desc(sb + s * B_BYTES);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 32; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        reg_fence(acc);
        mbar_arrive(empty(prev));
      }
      prev = s;
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty(prev));

    // Accumulator element i of this thread: row 16 warp + g + 8 ((i >> 1) & 1)
    // of this warpgroup's 64, column 8 (i >> 2) + 2 t + (i & 1).
    if (SWAP) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int n = a0 + wg * 64 + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int m = b0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (m < M && n < N)
          out[(size_t)m * N + n] = to_out<OutT>(rescale(acc[i], sx[m], ws[n], bias, bias_kind, n));
      }
    } else {
      // Two neighbouring columns per store (N is even).
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int m = a0 + wg * 64 + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int n = b0 + 8 * (i >> 2) + 2 * t;
        if (m < M && n < N) {
          const float sxm = sx[m];
          const float y0 = rescale(acc[i], sxm, ws[n], bias, bias_kind, n);
          const float y1 = rescale(acc[i + 1], sxm, ws[n + 1], bias, bias_kind, n + 1);
          if constexpr (sizeof(OutT) == 4) {
            *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(y0, y1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) = __floats2bfloat162_rn(y0, y1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver entry point; the library is not linked
// against libcuda, so it is looked up in the driver PyTorch has loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A tensor map over `rows` rows of `cols` int8 codes, `ld` bytes apart,
// boxes of `box_rows` rows x 128 bytes in the 128-byte swizzle; what lies
// past the rows or the columns reads as zeros.
bool codes_map(CUtensorMap* map, const void* ptr, int rows, int cols, long ld, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)KT, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

struct Args {
  const void* xq;
  const float* sx;
  const void* w;
  long ldw;
  const float* ws;
  const void* bias;
  int bias_kind;
  void* out;
  int M, N, K;
};

template <int BN, int NWG, int STAGES, bool SWAP, typename OutT>
int launch_gemm(const Args& a, cudaStream_t stream) {
  auto kernel = w8a8_gemm_kernel<BN, NWG, STAGES, SWAP, OutT>;
  constexpr int smem = gemm_smem_bytes(BN, NWG, STAGES);
  constexpr int BM = 64 * NWG;
  // Per device: the kernel's shared-memory attribute is set and its
  // resident CTAs per SM read once.
  static int resident[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128 * (NWG + 1), smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  // A: x's codes (M rows) or the weight's (N rows); B the other.
  const int rows_a = SWAP ? a.N : a.M;
  const int rows_b = SWAP ? a.M : a.N;
  CUtensorMap ta, tb;
  const bool ok = SWAP ? codes_map(&ta, a.w, a.N, a.K, a.ldw, BM) && codes_map(&tb, a.xq, a.M, a.K, a.K, BN)
                       : codes_map(&ta, a.xq, a.M, a.K, a.K, BM) && codes_map(&tb, a.w, a.N, a.K, a.ldw, BN);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int k_tiles = (a.K + KT - 1) / KT;
  const int tiles_b = (rows_b + BN - 1) / BN;
  const int n_tiles = (rows_a + BM - 1) / BM * tiles_b;
  const int grid = n_tiles < resident[dev] ? n_tiles : resident[dev];
  kernel<<<grid, 128 * (NWG + 1), smem, stream>>>(ta, tb, a.sx, a.ws, a.bias, a.bias_kind,
                                                  (OutT*)a.out, a.M, a.N, k_tiles, tiles_b, n_tiles);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_plan(const Args& a, int swap, int bn, cudaStream_t stream) {
  if (!swap) return bn == 128 ? launch_gemm<128, 2, 6, false, OutT>(a, stream) : (int)cudaErrorInvalidValue;
  switch (bn) {
    case 16: return launch_gemm<16, 1, 4, true, OutT>(a, stream);
    case 32: return launch_gemm<32, 1, 4, true, OutT>(a, stream);
    case 64: return launch_gemm<64, 1, 4, true, OutT>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y (M x N, bfloat16 or float32) = the W8A8 product of x (M x K, bfloat16
// or float32, rows ldx elements apart) and the weight whose codes are
// rows of K int8, N of them, ldw bytes apart, with scales ws (N float32)
// and bias (N, bias_kind 0 none, 1 bfloat16, 2 float32).  scratch holds
// x's codes (M x K int8) and then, 16-byte aligned, their scales (M
// float32).  With `quantize` 0 the scratch already holds x's codes and
// scales (a product of the same x with another weight, earlier on the same
// stream) and only the product is launched.  The plan (swap, bn) comes
// from ops/quant.py::_plan.  Two launches, or one, on `stream`; returns the
// first CUDA error, 0 on success.
extern "C" int fwt_w8a8_dense(const void* x, int x_f32, long ldx, int M, int K, const void* w, long ldw,
                              int N, const void* ws, const void* bias, int bias_kind, void* out,
                              int out_f32, void* scratch, int quantize, int swap, int bn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* xq = static_cast<int8_t*>(scratch);
  float* sx = reinterpret_cast<float*>(xq + ((size_t)M * K + 15) / 16 * 16);
  if (quantize) {
    if (x_f32) {
      quantize_rows_kernel<float><<<M, Q_THREADS, 0, st>>>((const float*)x, ldx, K, xq, sx);
    } else {
      quantize_rows_kernel<__nv_bfloat16><<<M, Q_THREADS, 0, st>>>((const __nv_bfloat16*)x, ldx, K, xq,
                                                                   sx);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const Args a{xq, sx, w, ldw, (const float*)ws, bias, bias_kind, out, M, N, K};
  return out_f32 ? launch_plan<float>(a, swap, bn, st) : launch_plan<__nv_bfloat16>(a, swap, bn, st);
}
