// W8A8: the port's int8 product, y = rescale(quantize_rows(x) @ W), for a
// weight with one float32 scale per output channel (int8 codes in
// [-127, 127], or compute_type="int4"'s per-channel codes in [-7, 7]).
//
// It replaces no TPU kernel: the JAX package's ops/quant.py::int8_dense
// leaves this product to XLA.  On the card it replaces PyTorch's composition
// of ops/quant.py (_quantize_rows, torch._int_mm, _rescale: about 17
// launches, the product on cuBLASLt's sm80 WMMA kernel), with the same bits.
// Every form computes, per row of x (bfloat16 or float32):
//
//   amax = max |x| over the row, sx = max(amax * float32(1/127), 1e-10),
//   codes = clamp(rint(x / sx), -127, 127) as int8, the division IEEE
//   (__fdiv_rn) as PyTorch's tensor division is, rint half to even as
//   torch.round is (computed as x times RN(1 / sx), the quotient divided
//   exactly only where it nears a tie: codes8_rcp); then the int32 product on the tensor cores (wgmma
//   m64nNk32 .s32.s8.s8, both operands K-major in shared memory in the
//   128-byte swizzle) and the rescale ((float)acc * sx) * ws, then + b, then
//   one rounding to the output type (bfloat16 or float32), each product and
//   sum rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), in
//   _rescale's order.
//
// The weight is the (in, out) view of (out, in)-contiguous codes
// (ops/quant.py::card_layout): s8 wgmma reads both operands K-major only.
//
// What bounds it on an H100: at the decode's 1-64 rows, not the weight's
// bytes (1.6 MB for 1280 x 1280, 6.6 MB for 1280 x 5120, 66 MB for the 1280
// x 51872 logits head: 0.5, 2.0 and 19.8 us at 3.35 TB/s) but the latency
// of the chain a launch runs (the launch, x's quantization, a round trip
// to HBM, the reduction of a split: ~8 us at 1280 x 1280), and a CTA's
// TMA stream (~19 GB/s an SM: the head's 66 MB in 25-27 us over 132 SMs);
// at the encoder's 12000 rows, int8 operations (1979 TOP/s).  The plan
// follows the shape and the card alone (ops/quant.py::_plan), two forms:
//
//   * the decode plan, M <= 64 (w8a8_decode_kernel): ONE launch for x and
//     up to three weights (the self-attention's q, k and v share x).  The
//     weights' 64-row tiles are wgmma's A operand and x's rows its B
//     operand of 16, 32 or 64 columns.  Every CTA is resident at once (one
//     an SM), and the grid quantizes x once: CTA g takes rows g, g + grid,
//     ... whole (max, scale, codes) into a device buffer, counts itself
//     done, and every CTA waits for the count, then loads its k-tiles of
//     the codes by TMA (the first weight tiles' loads already in flight).
//     Where the card runs a cluster of C <= 8 CTAs (the portable size) for
//     every tile at once, the cluster splits each tile's 128-byte k-tiles:
//     CTA r streams its 1/C of them through a ring of stages, its int32
//     partials stay in its shared memory, and after a cluster barrier CTA r
//     sums its 1/C of the tile's outputs over the C peers through
//     distributed shared memory (DSMEM) and applies the rescale (1280 x
//     1280: 20 tiles x 5; 5120 x 1280: 20 x 5; q, k, v: 60 x 2).  Else
//     each CTA walks whole tiles (1280 x 5120: 80 CTAs; the head: 132).
//     The device buffer (x's codes and scales, the count) is one a device
//     (ops/quant.py::_state): the port's decode runs on one stream;
//   * M > 64 (quantize_rows_kernel, then w8a8_gemm_kernel): 128 x 128
//     tiles of the output, two consumer warpgroups of 64 rows, x's codes as
//     A and the weight as B, persistent CTAs; x's codes and scales go
//     through a scratch buffer, written once for all the weights of x.
//
// Measured on an H100 (700 W), warm (a CUDA graph of 50 calls), 40 rows,
// against the earlier swap plan (a quantize launch, then one unsplit CTA
// per 64 weight rows): 1280 x 1280 8.2 us against 8.9; 5120 x 1280 11.3
// against 17.3; 1280 x 5120 9.4 against 9.5; q, k, v in one launch 9.1
// against 18.0; the head 36.5 against 37.9.  What did not pay: quantizing
// inside each cluster (every cluster quantized all of x, the rows' maxima
// meeting through DSMEM: 9.4, 16.4, 15.0, 13.0 and 49.6 us, the ALU work of
// M x K / C codes a CTA); two grid barriers, one for the maxima and one for
// the codes (~2 us each); partials pushed to their owners by DSMEM stores
// (2.7-3.3 us slower than pulled); the codes copied between a cluster's
// CTAs (4.8 us by loads); the exact division for every code (0.7-1.6 us
// more a launch than codes8_rcp).  Before the swap plan, splits whose
// int32 partials were summed with global atomic adds lost (40 x 1280 @
// 1280 x 1280: 10.7 us unsplit, 13.1-14.8 in 2 to 10 splits) while the
// host's ~33 us a call paced the step.
//
// An int32 sum is exact in any order, a max too, and the rescale is per
// element, so every plan gives the same bits: a row's output does not
// follow the row count, the split or the grid.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// The cluster barrier, split: arrive (release: this thread's earlier
// reads and writes, shared memory of the cluster included, are ordered
// before it) and wait (acquire) until every thread of the cluster has
// arrived.  Each thread alternates the two.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

// Eight elements of x as loaded (one 16-byte load of bfloat16, two of
// float32), converted to float32 apart from the load, so that a thread
// can keep several loads in flight.
template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float* v) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float* v) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};

// Eight codes of x at the scale s: quantize_rows_kernel's arithmetic.
__device__ __forceinline__ uint2 codes8(const float* f, float s) {
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < Q_VEC; ++e) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(f[e], s)), -127.f), 127.f);
    packed[e >> 2] |= ((uint32_t)(uint8_t)(int8_t)q) << (8 * (e & 3));
  }
  return make_uint2(packed[0], packed[1]);
}

// rint(x / s), the quotient rounded once (IEEE) and then to the nearest
// integer (ties to even), from y = RN(1 / s), for |x / s| <= 128 (a row's
// codes: |x| <= amax, s ~ amax / 127): q = RN(x y) is within 1.5 units in
// the last place of x / s, and RN(x / s) within half a unit, under 2^-15 in
// all, so both round to the same integer unless q lies within 2^-13 of a
// half-integer.  Eight codes of x at the scale s: codes8's bits, the eight
// divided exactly where any of them nears a tie.
__device__ __forceinline__ uint2 codes8_rcp(const float* f, float s, float y) {
  float n[Q_VEC];
  bool near = false;
#pragma unroll
  for (int e = 0; e < Q_VEC; ++e) {
    const float q = __fmul_rn(f[e], y);
    n[e] = rintf(q);
    near |= fabsf(fabsf(__fsub_rn(q, n[e])) - 0.5f) <= 0x1p-13f;
  }
  if (near) return codes8(f, s);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < Q_VEC; ++e) {
    const float q = fminf(fmaxf(n[e], -127.f), 127.f);
    packed[e >> 2] |= ((uint32_t)(uint8_t)(int8_t)q) << (8 * (e & 3));
  }
  return make_uint2(packed[0], packed[1]);
}

// Row xr of x (K elements) into K codes at qr; returns the row's scale.
// Run by THREADS threads together; red holds THREADS / 32 floats of shared
// memory.  A thread's first KEEP vectors of 8 stay in registers from the
// max to the codes.
template <typename T, int THREADS, int KEEP>
__device__ __forceinline__ float quantize_row(const T* __restrict__ xr, int K, int8_t* __restrict__ qr,
                                              float* red) {
  const int tid = threadIdx.x;
  const int nvec = K / Q_VEC;
  Vec8<T> kept[KEEP];
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    if (tid + THREADS * j < nvec) kept[j].load(xr + Q_VEC * (tid + THREADS * j));
  }
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    if (tid + THREADS * j < nvec) {
      float f[Q_VEC];
      kept[j].get(f);
#pragma unroll
      for (int e = 0; e < Q_VEC; ++e) a = fmaxf(a, fabsf(f[e]));
    }
  }
  for (int v = tid + THREADS * KEEP; v < nvec; v += THREADS) {
    Vec8<T> w;
    w.load(xr + Q_VEC * v);
    float f[Q_VEC];
    w.get(f);
#pragma unroll
    for (int e = 0; e < Q_VEC; ++e) a = fmaxf(a, fabsf(f[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if ((tid & 31) == 0) red[tid >> 5] = a;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) a = fmaxf(a, red[w]);
  const float s = fmaxf(__fmul_rn(a, kInv127), kScaleFloor);
  const float y = __frcp_rn(s);
#pragma unroll
  for (int j = 0; j < KEEP; ++j) {
    const int v = tid + THREADS * j;
    if (v < nvec) {
      float f[Q_VEC];
      kept[j].get(f);
      *reinterpret_cast<uint2*>(qr + Q_VEC * v) = codes8_rcp(f, s, y);
    }
  }
  for (int v = tid + THREADS * KEEP; v < nvec; v += THREADS) {
    Vec8<T> w;
    w.load(xr + Q_VEC * v);
    float f[Q_VEC];
    w.get(f);
    *reinterpret_cast<uint2*>(qr + Q_VEC * v) = codes8_rcp(f, s, y);
  }
  __syncthreads();  // red is read before a next row writes it
  return s;
}

// Row `blockIdx.x` of x (K elements, rows `ldx` elements apart) into K
// int8 codes at xq + row * K and its scale at sx[row].
template <typename T>
__global__ void __launch_bounds__(Q_THREADS) quantize_rows_kernel(const T* __restrict__ x, long ldx,
                                                                  int K, int8_t* __restrict__ xq,
                                                                  float* __restrict__ sx) {
  __shared__ float red[Q_THREADS / 32];
  const int row = blockIdx.x;
  const float s = quantize_row<T, Q_THREADS, 2>(x + (size_t)row * ldx, K, xq + (size_t)row * K, red);
  if (threadIdx.x == 0) sx[row] = s;
}

// ---------------------------------------------------------------------------
// 2. The rescale
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

// Bias element n as float32 (bias_kind: 0 none, 1 bfloat16, 2 float32).
__device__ __forceinline__ float bias_at(const void* bias, int bias_kind, int n) {
  if (bias_kind == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
  if (bias_kind == 2) return static_cast<const float*>(bias)[n];
  return 0.f;
}

// ((float)acc * sx) * ws, then + b where there is a bias, each step
// rounded on its own: _rescale.
__device__ __forceinline__ float rescale_with(int acc, float sxm, float wsn, int bias_kind, float b) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), wsn);
  return bias_kind != 0 ? __fadd_rn(y, b) : y;
}

__device__ __forceinline__ float rescale(int acc, float sxm, float wsn, const void* bias,
                                         int bias_kind, int n) {
  return rescale_with(acc, sxm, wsn, bias_kind, bias_at(bias, bias_kind, n));
}

// Four neighbouring outputs, each rounded on its own.
__device__ __forceinline__ void store4(float* dst, const float* y) {
  *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* y) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// ---------------------------------------------------------------------------
// 3. M > 64: the product over x's codes in scratch
// ---------------------------------------------------------------------------

constexpr int gemm_smem_bytes(int bn, int nwg, int stages) {
  return 1024 /* alignment slack */ + stages * (64 * nwg + bn) * KT + 16 * stages;
}

// One CTA per SM: warpgroup 0's first thread issues every TMA load;
// warpgroups 1 .. NWG consume.  A tile of the accumulator is (64 NWG rows
// of x's codes) x (BN rows of the weight's).  CTAs take tiles blockIdx.x,
// + gridDim.x, ...; the ring's stage and parity run on across tiles, in the
// same order in the producer and the consumers.
template <int BN, int NWG, int STAGES, typename OutT>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) w8a8_gemm_kernel(
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
    // of this warpgroup's 64, column 8 (i >> 2) + 2 t + (i & 1); two
    // neighbouring columns per store (N is even).
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

// ---------------------------------------------------------------------------
// 4. M <= 64: the decode plan, one launch
// ---------------------------------------------------------------------------

constexpr int kMaxWeights = 3;       // weights of one x per launch: q, k and v
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int DEC_THREADS = 512;     // sixteen warps quantize (and reduce); the first four multiply
constexpr int DEC_MMA = 128;         // the warpgroup that runs wgmma
constexpr int DEC_PRODUCER = 128;    // the thread that issues every TMA load (warp 4)
constexpr int DEC_MAX_STAGES = 8;    // the ring's depth: 64 KB of weight tiles in flight
constexpr int DEC_EARLY = 4;         // weight tiles a CTA walking whole tiles loads before x's codes are
                                     // ready (a split CTA: its whole ring)
constexpr int W_ROWS = 64;           // weight rows per tile: wgmma's M
constexpr int W_BYTES = W_ROWS * KT;
constexpr int PART_LD = 68;          // int32 a row of a split tile's partials: 64 and 4 of padding, so
                                     // that the accumulator's stores meet each bank once and rows stay
                                     // 16-byte aligned
constexpr int XS_BYTES = 144 * 1024; // x's codes a CTA may keep (ops/quant.py::_XS_BYTES)
constexpr int MAX_SMEM = 232448;     // shared memory a CTA may have on sm_90
constexpr int kCodesBytes = kMaxCluster * XS_BYTES;          // x's codes of a launch at most
constexpr int kStateBytes = kCodesBytes + 64 * 4 + 2 * 4;    // and the rows' scales, the barrier

// The launch's arguments, in the kernel's parameter space (the tensor maps
// must be there or in global memory).
struct DecodeParams {
  CUtensorMap map[kMaxWeights];  // weight j's codes: n[j] rows of K, boxes of 64 rows x 128 bytes
  CUtensorMap xmap;              // x's codes: M rows of K at `codes`, boxes of BN rows x 128 bytes
  const float* ws[kMaxWeights];  // weight j's scales (n[j])
  const void* bias[kMaxWeights];
  void* out[kMaxWeights];        // its output, M x n[j]
  int n[kMaxWeights];
  int bias_kind[kMaxWeights];
  int tile_end[kMaxWeights];     // weight j owns tiles [tile_end[j - 1], tile_end[j]); n_tiles past the last
  const void* x;
  long ldx;
  int8_t* codes;                 // x's codes, M x K, written once a launch
  float* scales;                 // their rows' scales (M)
  unsigned* sync;                // rows' CTAs done, then CTAs that have seen them (both zero between launches)
  int M, K, k_tiles, n_tiles;
  int cluster;  // CTAs a cluster, splitting each tile's k-tiles; 1: each CTA takes whole tiles
  int nk_max;   // k-tiles of x's codes a CTA keeps
  int stages;
};

constexpr int decode_smem_bytes(int bn, int nk_max, int stages) {
  return 1024 /* alignment slack */ + stages * W_BYTES + nk_max * bn * KT + bn * PART_LD * 4 + 64 * 4 +
         16 * stages + 8;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Grid (clusters x C), clusters of C CTAs, every CTA resident at once
// (ops/quant.py::_plan keeps the grid within what the card runs together,
// and the launcher checks).  First the grid quantizes x once: CTA g takes
// rows g, g + gridDim.x, ... of x, each whole (its max, scale and codes at
// once), into `codes` and `scales`, and counts itself done in sync[0];
// every CTA waits for all of them there, counts itself in sync[1], and
// the last to do so sets both back to zero for the next launch.  Then each
// CTA loads its k-tiles of the codes by TMA.
// Split (C > 1): the cluster takes tile c of the weights' 64-row tiles
// (one a cluster) and CTA r multiplies k-tiles [r k_tiles / C, (r + 1)
// k_tiles / C) of it, the int32 partials summed through DSMEM.  Whole
// tiles (C = 1): CTA g takes tiles g, g + gridDim.x, ... over every
// k-tile.  Shared memory, at the same offsets in every CTA (the peers read
// part): the ring of weight tiles, x's codes (BN rows x 128 bytes a k-tile,
// 128-byte swizzle), a split tile's int32 partials (x's row m, the
// weight's row r at m PART_LD + r), the rows' scales, the mbarriers (full,
// empty, then x's codes).  Thread DEC_PRODUCER issues the TMA loads;
// warpgroup 0 consumes them.
template <int BN, typename XT, typename OutT>
__global__ void __launch_bounds__(DEC_THREADS, 1) w8a8_decode_kernel(const __grid_constant__ DecodeParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const bool split = C > 1;
  const int rank = (int)cluster.block_rank();
  const int k0 = split ? rank * p.k_tiles / C : 0;  // the k-tiles this CTA multiplies, from k0
  const int nk = split ? (rank + 1) * p.k_tiles / C - k0 : p.k_tiles;
  const int first = split ? blockIdx.x / C : blockIdx.x;  // its first tile, then every stride-th
  const int stride = split ? gridDim.x / C : gridDim.x;
  const int my_tiles = first < p.n_tiles ? (p.n_tiles - 1 - first) / stride + 1 : 0;
  const int total = my_tiles * nk;  // this CTA's loads
  const int stages = p.stages;
  const int early = split ? stages : DEC_EARLY;  // loads issued before x's codes are ready
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* xs = base + stages * W_BYTES;
  int* part = reinterpret_cast<int*>(xs + p.nk_max * BN * KT);
  float* sx_s = reinterpret_cast<float*>(part + BN * PART_LD);
  const uint32_t ring = smem_u32(base);
  const uint32_t xs_u = smem_u32(xs);
  const uint32_t bar = smem_u32(sx_s + 64);
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (stages + s); };
  const uint32_t codes_bar = bar + 16u * stages;  // x's codes have landed
  auto weight_of = [&](int tile) { return tile < p.tile_end[0] ? 0 : tile < p.tile_end[1] ? 1 : 2; };
  auto first_row = [&](int tile, int j) { return (tile - (j == 0 ? 0 : p.tile_end[j - 1])) * W_ROWS; };

  // Load L of this CTA: k-tile k0 + L % nk of its tile L / nk.
  auto issue = [&](int L) {
    const int s = L % stages;
    const int tile = first + (L / nk) * stride;
    const int j = weight_of(tile);
    mbar_expect_tx(full(s), W_BYTES);
    tma_load_2d(ring + s * W_BYTES, &p.map[j], (k0 + L % nk) * KT, first_row(tile, j), full(s));
  };

  // Warps 0 and 4 alone meet here: the mbarriers, then the first loads,
  // while the other warps start on x.
  if (warp == 0 || warp == DEC_PRODUCER / 32) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), DEC_MMA);
      }
      mbar_init(codes_bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("bar.sync 1, 64;\n" ::: "memory");
    if (tid == DEC_PRODUCER) {
      for (int L = 0; L < total && L < early; ++L) issue(L);  // HBM's latency runs under the quantization
    }
    __syncwarp();
  }

  // 1. x's rows, one CTA a row.
  const XT* x = static_cast<const XT*>(p.x);
  for (int m = blockIdx.x; m < p.M; m += gridDim.x) {
    const float s = quantize_row<XT, DEC_THREADS, 4>(x + (size_t)m * p.ldx, p.K, p.codes + (size_t)m * p.K, sx_s);
    if (tid == 0) p.scales[m] = s;
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the codes, written here, are read by TMA
  __syncthreads();
  const unsigned owners = min(p.M, (int)gridDim.x);  // CTAs with rows
  if (tid == 0) {
    if (blockIdx.x < owners) add_release(p.sync, 1u);
    while (ld_acquire(p.sync) != owners) {
    }
  }
  __syncthreads();
  if (tid < p.M) sx_s[tid] = __ldcg(p.scales + tid);
  __syncthreads();

  // 2. This CTA's k-tiles of x's codes by TMA (rows past M and columns past
  //    K read as zeros), then the rest of the weight's loads, each into a
  //    stage the consumers handed back.
  if (tid == DEC_PRODUCER) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    mbar_expect_tx(codes_bar, nk * BN * KT);
    for (int kk = 0; kk < nk; ++kk) tma_load_2d(xs_u + kk * BN * KT, &p.xmap, (k0 + kk) * KT, 0, codes_bar);
    if (atomicAdd(p.sync + 1, 1u) == gridDim.x - 1) {  // every CTA has seen the rows: ready for the next launch
      p.sync[0] = 0u;
      p.sync[1] = 0u;
    }
    for (int L = early; L < total; ++L) {
      if (L >= stages) mbar_wait(empty(L % stages), ((L / stages) & 1) ^ 1);
      issue(L);
    }
  }
  __syncwarp();

  // 3. Per tile: this CTA's k-tiles on the tensor cores (warpgroup 0); for
  //    whole tiles the rescale from registers, for a split the partials
  //    to shared memory and this CTA's share of the cluster's sums
  //    rescaled (every thread).
  const bool mma = tid < DEC_MMA;
  if (mma) mbar_wait(codes_bar, 0);
  if (!split && !mma) return;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
  const int t = lane & 3;   // accumulator column pair
  int s = 0, phase = 0, prev = 0, prev2 = 0;  // the ring's stage, its parity, the stages in use
  for (int ti = 0; ti < my_tiles; ++ti) {
    const int tile = first + ti * stride;
    const int j = weight_of(tile);
    const int n0 = first_row(tile, j);
    const int N = p.n[j];
    const float* ws = p.ws[j];
    OutT* out = static_cast<OutT*>(p.out[j]);
    // For whole tiles, this thread's two weight rows' scales and biases,
    // read under the k-loop.
    float wsr[2] = {0.f, 0.f}, br[2] = {0.f, 0.f};
    if (!split) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 16 * warp + g + 8 * h;
        if (n < N) {
          wsr[h] = ws[n];
          br[h] = bias_at(p.bias[j], p.bias_kind[j], n);
        }
      }
    }
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    if (mma) {
      for (int kk = 0; kk < nk; ++kk) {
        mbar_wait(full(s), phase);
        const uint64_t da = sw128_desc(ring + s * W_BYTES);
        const uint64_t db = sw128_desc(xs_u + kk * BN * KT);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < KT / 32; ++q) wgmma_tile<BN>(acc, da + 2 * q, db + 2 * q, kk > 0 || q > 0);
        wgmma_commit();
        if (kk > 1) {
          wgmma_wait<2>();  // the products of two stages back are done: hand that stage back
          reg_fence(acc);
          mbar_arrive(empty(prev2));
        }
        prev2 = prev;
        prev = s;
        if (++s == stages) s = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if (nk > 1) mbar_arrive(empty(prev2));
      if (nk > 0) mbar_arrive(empty(prev));
    }
    // Accumulator element i: the weight's row 16 warp + g + 8 ((i >> 1) & 1)
    // of the tile, x's row 8 (i >> 2) + 2 t + (i & 1).
    if (!split) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int m = 8 * (i >> 2) + 2 * t + (i & 1);
        const int h = (i >> 1) & 1;
        const int n = n0 + 16 * warp + g + 8 * h;
        if (m < p.M && n < N) out[(size_t)m * N + n] = to_out<OutT>(rescale_with(acc[i], sx_s[m], wsr[h],
                                                                                  p.bias_kind[j], br[h]));
      }
      continue;
    }
    // A split gives each cluster one tile, and each thread at most one
    // vector of 4 of its M x 64 outputs (v = 16 m + r / 4; rank q owns
    // [q nv / C, (q + 1) nv / C), nv / C <= 512): the thread's scales and
    // bias are read before the partials meet.
    const int nv = p.M * (W_ROWS / 4);
    const int v = rank * nv / C + tid;
    const int m = v >> 4, r = (v & 15) * 4, n = n0 + r;
    const bool mine = v < (rank + 1) * nv / C && n < N;  // N is a multiple of 8: a vector is all in or out
    float wsv[4], bv[4];
    if (mine) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wsv[e] = ws[n + e];
        bv[e] = bias_at(p.bias[j], p.bias_kind[j], n + e);
      }
    }
    if (mma) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        part[(8 * (i >> 2) + 2 * t + (i & 1)) * PART_LD + 16 * warp + g + 8 * ((i >> 1) & 1)] = acc[i];
      }
    }
    cluster_arrive();  // this CTA's partials are written (and every CTA has started)
    cluster_wait();
    // The int32 sum over the C peers (exact in any order), then the rescale.
    if (mine) {
      int4 c[kMaxCluster];  // every peer's load in flight at once
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < C) c[q] = *reinterpret_cast<const int4*>(cluster.map_shared_rank(part + m * PART_LD + r, q));
      }
      int sum[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < C) sum[0] += c[q].x, sum[1] += c[q].y, sum[2] += c[q].z, sum[3] += c[q].w;
      }
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = rescale_with(sum[e], sx_s[m], wsv[e], p.bias_kind[j], bv[e]);
      store4(out + (size_t)m * N + n, y);
    }
    __syncwarp();
    cluster_arrive();  // this CTA has read its peers' partials
    cluster_wait();    // no CTA leaves while a peer may still read its partials
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

template <typename OutT>
int launch_gemm(const Args& a, cudaStream_t stream) {
  constexpr int BN = 128, NWG = 2, STAGES = 6;
  auto kernel = w8a8_gemm_kernel<BN, NWG, STAGES, OutT>;
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
  // A: x's codes (M rows), B: the weight's (N rows)
  CUtensorMap ta, tb;
  if (!codes_map(&ta, a.xq, a.M, a.K, a.K, BM) || !codes_map(&tb, a.w, a.N, a.K, a.ldw, BN))
    return (int)cudaErrorInvalidValue;
  const int k_tiles = (a.K + KT - 1) / KT;
  const int tiles_b = (a.N + BN - 1) / BN;
  const int n_tiles = (a.M + BM - 1) / BM * tiles_b;
  const int grid = n_tiles < resident[dev] ? n_tiles : resident[dev];
  kernel<<<grid, 128 * (NWG + 1), smem, stream>>>(ta, tb, a.sx, a.ws, a.bias, a.bias_kind,
                                                  (OutT*)a.out, a.M, a.N, k_tiles, tiles_b, n_tiles);
  return (int)cudaGetLastError();
}

template <int BN, typename XT, typename OutT>
cudaError_t decode_ready(int* dev) {
  static bool ready[kMaxDevices] = {false};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[*dev]) {
    err = cudaFuncSetAttribute(w8a8_decode_kernel<BN, XT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    ready[*dev] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t decode_config(int clusters, int cluster, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cluster, 1, 1);
  cfg.blockDim = dim3(DEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BN, typename XT, typename OutT>
int launch_decode(const DecodeParams& p, int clusters, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = decode_ready<BN, XT, OutT>(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      decode_config(clusters, p.cluster, decode_smem_bytes(BN, p.nk_max, p.stages), stream, attr);
  err = cudaLaunchKernelEx(&cfg, w8a8_decode_kernel<BN, XT, OutT>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` decode CTAs (one an SM) the current device
// runs at once, read once a device and size.
cudaError_t cluster_slots(int cluster, int* slots) {
  static int cache[kMaxDevices][kMaxCluster + 1] = {};
  int dev = 0;
  cudaError_t err = decode_ready<64, __nv_bfloat16, __nv_bfloat16>(&dev);
  if (err != cudaSuccess) return err;
  if (cache[dev][cluster] == 0) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = decode_config(1, cluster, decode_smem_bytes(64, 2, 2), 0, attr);
    err = cudaOccupancyMaxActiveClusters(&cache[dev][cluster], w8a8_decode_kernel<64, __nv_bfloat16, __nv_bfloat16>,
                                         &cfg);
    if (err != cudaSuccess) return err;
  }
  *slots = cache[dev][cluster];
  return cudaSuccess;
}

template <typename XT, typename OutT>
int decode_bn(const DecodeParams& p, int bn, int clusters, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch_decode<16, XT, OutT>(p, clusters, stream);
    case 32: return launch_decode<32, XT, OutT>(p, clusters, stream);
    case 64: return launch_decode<64, XT, OutT>(p, clusters, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// M > 64: y (M x N, bfloat16 or float32) = the W8A8 product of x (M x K,
// bfloat16 or float32, rows ldx elements apart) and the weight whose codes
// are rows of K int8, N of them, ldw bytes apart, with scales ws (N
// float32) and bias (N, bias_kind 0 none, 1 bfloat16, 2 float32).  scratch
// holds x's codes (M x K int8) and then, 16-byte aligned, their scales (M
// float32).  With `quantize` 0 the scratch already holds x's codes and
// scales (a product of the same x with another weight, earlier on the same
// stream) and only the product is launched.  Two launches, or one, on
// `stream`; returns the first CUDA error, 0 on success.
extern "C" int fwt_w8a8_dense(const void* x, int x_f32, long ldx, int M, int K, const void* w, long ldw,
                              int N, const void* ws, const void* bias, int bias_kind, void* out,
                              int out_f32, void* scratch, int quantize, void* stream) {
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
  return out_f32 ? launch_gemm<float>(a, st) : launch_gemm<__nv_bfloat16>(a, st);
}

// M <= 64: the products of x (M x K, bfloat16 or float32, rows ldx elements
// apart, 16-byte aligned) with n_weights (1 to 3) weights in one launch,
// x quantized inside.  Weight j: codes w_j (n_j rows of K int8, ldw_j bytes
// apart), scales ws_j (n_j float32), bias b_j of kind bk_j (0 none, 1
// bfloat16, 2 float32), output out_j (M x n_j, bfloat16 or float32 as
// out_f32 says).  state: the device's decode state, kStateBytes: x's codes
// (kCodesBytes), their rows' scales (64 floats), the grid barrier's two
// counters (zero at first).  The plan (bn: x's rows
// in wgmma's B operand, 16, 32 or 64; cluster: CTAs a cluster, each taking
// 1/cluster of a tile's k-tiles, or 1: whole tiles a CTA; clusters) comes
// from ops/quant.py::_plan, which keeps the grid within what the card runs
// at once.  Returns the first CUDA error, 0 on success.
extern "C" int fwt_w8a8_decode(const void* x, int x_f32, long ldx, int M, int K, int out_f32, int n_weights,
                               const void* w0, long ldw0, int n0, const void* ws0, const void* b0, int bk0,
                               void* out0, const void* w1, long ldw1, int n1, const void* ws1,
                               const void* b1, int bk1, void* out1, const void* w2, long ldw2, int n2,
                               const void* ws2, const void* b2, int bk2, void* out2, void* state, int bn,
                               int cluster, int clusters, void* stream) {
  const void* w[kMaxWeights] = {w0, w1, w2};
  const long ldw[kMaxWeights] = {ldw0, ldw1, ldw2};
  const int n[kMaxWeights] = {n0, n1, n2};
  const void* ws[kMaxWeights] = {ws0, ws1, ws2};
  const void* b[kMaxWeights] = {b0, b1, b2};
  const int bk[kMaxWeights] = {bk0, bk1, bk2};
  void* out[kMaxWeights] = {out0, out1, out2};
  const int k_tiles = (K + KT - 1) / KT;
  if (M < 1 || M > bn || n_weights < 1 || n_weights > kMaxWeights || cluster < 1 ||
      cluster > kMaxCluster || cluster > k_tiles || clusters < 1 || (long)M * K > kCodesBytes)
    return (int)cudaErrorInvalidValue;
  DecodeParams p = {};
  int tiles = 0;
  for (int j = 0; j < kMaxWeights; ++j) {
    if (j < n_weights) {
      if (!codes_map(&p.map[j], w[j], n[j], K, ldw[j], W_ROWS)) return (int)cudaErrorInvalidValue;
      p.ws[j] = static_cast<const float*>(ws[j]);
      p.bias[j] = b[j];
      p.bias_kind[j] = bk[j];
      p.out[j] = out[j];
      p.n[j] = n[j];
      tiles += (n[j] + W_ROWS - 1) / W_ROWS;
    }
    p.tile_end[j] = tiles;
  }
  if (cluster > 1 && clusters != tiles) return (int)cudaErrorInvalidValue;  // a split: one tile a cluster
  int slots = 0;  // the grid quantizes x together: every CTA must be resident at once
  const cudaError_t err = cluster_slots(cluster, &slots);
  if (err != cudaSuccess) return (int)err;
  if (clusters > slots) return (int)cudaErrorCooperativeLaunchTooLarge;
  uint8_t* st = static_cast<uint8_t*>(state);
  p.codes = reinterpret_cast<int8_t*>(st);
  p.scales = reinterpret_cast<float*>(st + kCodesBytes);
  p.sync = reinterpret_cast<unsigned*>(p.scales + 64);
  if (!codes_map(&p.xmap, p.codes, M, K, K, bn)) return (int)cudaErrorInvalidValue;
  p.x = x;
  p.ldx = ldx;
  p.M = M;
  p.K = K;
  p.k_tiles = k_tiles;
  p.n_tiles = tiles;
  p.cluster = cluster;
  p.nk_max = (k_tiles + cluster - 1) / cluster;
  const int loads = (tiles + clusters - 1) / clusters * p.nk_max;  // the most a CTA makes (a cluster walks
                                                                   // the tiles; for whole tiles, a CTA)
  p.stages = loads < 1 ? 1 : loads < DEC_MAX_STAGES ? loads : DEC_MAX_STAGES;
  if (p.nk_max * bn * KT > XS_BYTES || decode_smem_bytes(bn, p.nk_max, p.stages) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t sm = (cudaStream_t)stream;
  if (x_f32) {
    return out_f32 ? decode_bn<float, float>(p, bn, clusters, sm) : decode_bn<float, __nv_bfloat16>(p, bn, clusters, sm);
  }
  return out_f32 ? decode_bn<__nv_bfloat16, float>(p, bn, clusters, sm)
                 : decode_bn<__nv_bfloat16, __nv_bfloat16>(p, bn, clusters, sm);
}

// The bytes of a device's decode state (fwt_w8a8_decode), zeroed once.
extern "C" int fwt_w8a8_state_bytes() { return kStateBytes; }

// How many clusters of `cluster` decode CTAs (one an SM) the current device
// runs at once, in *slots; returns the first CUDA error, 0 on success.
extern "C" int fwt_w8a8_cluster_slots(int cluster, int* slots) {
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  return (int)cluster_slots(cluster, slots);
}
