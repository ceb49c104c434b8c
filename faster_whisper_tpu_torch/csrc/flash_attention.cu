// K3: unmasked encoder self-attention, softmax(Q K^T / sqrt(64)) V, as a
// flash-attention forward over the (B, S, H, 64) layout, in bfloat16 (the
// default compute type) and in float32.
//
// Replaces the TPU kernel faster_whisper_tpu/ops/attention.py::_mha_flash_full
// (selected by mha_full; on the TPU it called the Pallas library kernel
// jax.experimental.pallas.ops.tpu.flash_attention, padded to 1536 with
// segment ids, at the input dtype).  The plain PyTorch version is
// ops/attention.py::mha.
//
// What bounds it on an H100: operations.  At the encoder's S=1500, D=64 it
// does 4*S*S*D FLOP per (b, h) against 4*S*D*2 B of input and output, about
// 375 FLOP/B, above the card's bf16 ridge of 295 FLOP/B, so the tensor
// cores are the limit (989 TFLOP/s dense bf16); in float32 the TF32 tensor
// cores (495 TFLOP/s dense) at three products per product, see below.
//
// bf16 design (Hopper): the (S, S) score matrix never exists in device
// memory.  A block owns 64 query rows of one (b, h), two blocks per SM (a
// block of 128 rows with two consumer warpgroups measured slower at B=1
// and B=8), and is warp specialised: warpgroup 0 is the producer, whose
// first thread issues TMA loads (tensor maps over the 4-D view (64, H, S,
// B), 128-byte swizzle): Q once, then K and V tiles of 128 keys into a
// ring of STAGES slots, each slot guarded by mbarriers (K full, V full,
// empty).  Warpgroup 1 is the consumer: S = Q K^T is wgmma m64n128k16
// with both operands read from shared memory through descriptors (K rows
// are d-contiguous, K-major as B needs); the online softmax runs in f32 on
// the accumulators (running max and sum per row, exp2 in the log2 domain on
// the special-function unit, ex2.approx.ftz);
// P is rounded to bf16 into wgmma A fragments in registers, and O += P V is
// wgmma m64n64k16 with V read from shared memory as an MN-major operand
// (the descriptor's transpose bit).  setmaxnreg moves registers from the
// producer to the consumer.  The ragged tail of S=1500 is masked in the
// kernel: TMA fills keys past S with zeros, which would score 0, so keys
// at or past S are set to -inf before the softmax; Q rows past S are
// computed on zeros and the TMA store of the output clips them.  The
// output is staged in the Q buffer (swizzled) and written with one TMA
// store.
//
// float32 design: a separate kernel at float32 accuracy on the TF32 tensor
// cores ("3xTF32", as CUTLASS names it), with mma.sync m16n8k8: each
// operand x is split into TF32 parts hi + lo, and a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32, within ~2^-21 of the
// float32 product (one TF32 product alone keeps three digits, and the
// float32 path is held to the JAX package's float32 at ~1e-5).  A block owns
// 64 query rows of one (b, h), four warps of 16 rows, with Q's split
// fragments in registers; K/V tiles of 64 keys are double-buffered in shared
// memory with 16-byte cp.async, the next tile landing while the current one
// is multiplied, rows padded so that the fragment loads are free of bank
// conflicts.  The online softmax runs in f32 on the accumulators (exp2f in
// the log2 domain, not the approximate unit); P is split from the score
// accumulators in registers.  Keys at or past S arrive as zeros and are set
// to -inf.  wgmma is not used: its TF32 form wants both shared-memory
// operands K-major, and V is MN-major in P V.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;                    // head dim
constexpr int QROWS = 64;                 // Q rows per block
constexpr int BN = 128;                   // keys per tile
constexpr int STAGES = 2;                 // K/V ring slots
constexpr int Q_BYTES = QROWS * HD * 2;   // 8 KB
constexpr int KV_BYTES = BN * HD * 2;     // 16 KB
constexpr int ROW_BYTES = HD * 2;         // 128: one swizzle atom wide

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A shared-memory matrix descriptor for a tile of 128-byte rows in the
// 128-byte swizzle that TMA writes (tile base 1024-byte aligned): start
// address in 16-byte units, leading offset 1 (not read for these widths),
// 1024 bytes between groups of 8 rows, layout 128B swizzle.
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16) * B (16 x 128), both from shared memory
// through descriptors, K-major; D is overwritten when accumulate is 0.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64) from shared
// memory through a descriptor, MN-major (tnspB = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
// (exp2f adds range handling around the same instruction).
__device__ __forceinline__ float fast_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of element (row r, column c) of a 64-wide bf16 tile in the
// 128-byte swizzle: 16-byte chunk c/8 of row r lands at chunk (c/8) ^ (r%8).
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2);
}

constexpr int WGMMA_SMEM_BYTES =
    1024 /* alignment slack */ + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);

// The producer warpgroup and one consumer warpgroup: 256 threads, two
// blocks per SM.
__global__ void __launch_bounds__(256, 2) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o, int S,
    float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q: 64 x 64
  const uint32_t sk = sq + Q_BYTES;             // K: STAGES tiles of 128 x 64
  const uint32_t sv = sk + STAGES * KV_BYTES;   // V: STAGES tiles of 128 x 64
  const uint32_t bar = sv + STAGES * KV_BYTES;  // mbarriers
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * STAGES + s); };

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * QROWS;
  const int n_tiles = (S + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load_4d(sq, &tm_q, 0, h, m0, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(s), KV_BYTES);
        tma_load_4d(sk + s * KV_BYTES, &tm_k, 0, h, it * BN, b, k_full(s));
        mbar_expect_tx(v_full(s), KV_BYTES);
        tma_load_4d(sv + s * KV_BYTES, &tm_v, 0, h, it * BN, b, v_full(s));
      }
    }
  } else {
    // The consumer warpgroup over Q rows m0 ... m0 + 63, with the registers
    // the producer gave up: 256 x 128 = 128 x 24 + 128 x 232.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tw = threadIdx.x - 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
    const int t = lane & 3;   // accumulator column pair
    const uint64_t dq = sw128_desc(sq);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw scores
    float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;

      // S = Q K^T: 64 rows x 128 keys, 4 k-steps of 16 over D (32 bytes each).
      float sc[64];
      const uint64_t dk = sw128_desc(sk + s * KV_BYTES);
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // Keys at or past S (zero-filled by TMA) score -inf.
      const int n0 = it * BN;
      if (n0 + BN > S) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n0 + 8 * j + 2 * t + e >= S) {
              sc[4 * j + e] = -INFINITY;
              sc[4 * j + 2 + e] = -INFINITY;
            }
          }
        }
      }

      // Online softmax: every tile holds a key < S, so the new max is finite.
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float corr_lo = fast_ex2((m_lo - mx_lo) * scale_log2);  // 0 on the first tile
      const float corr_hi = fast_ex2((m_hi - mx_hi) * scale_log2);
      m_lo = mx_lo;
      m_hi = mx_hi;
      const float ms_lo = mx_lo * scale_log2;
      const float ms_hi = mx_hi * scale_log2;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = fast_ex2(fmaf(sc[4 * j], scale_log2, -ms_lo));
        sc[4 * j + 1] = fast_ex2(fmaf(sc[4 * j + 1], scale_log2, -ms_lo));
        sc[4 * j + 2] = fast_ex2(fmaf(sc[4 * j + 2], scale_log2, -ms_hi));
        sc[4 * j + 3] = fast_ex2(fmaf(sc[4 * j + 3], scale_log2, -ms_hi));
        sum_lo += sc[4 * j] + sc[4 * j + 1];
        sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= corr_lo;
        o[4 * j + 1] *= corr_lo;
        o[4 * j + 2] *= corr_hi;
        o[4 * j + 3] *= corr_hi;
      }

      // P as bf16 A fragments: k-step kk covers keys 16 kk .. 16 kk + 15.
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: 8 k-steps of 16 keys (16 rows of 128 bytes = 2048 bytes each).
      const uint64_t dv = sw128_desc(sv + s * KV_BYTES);
      mbar_wait(v_full(s), ph);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs(o, pa[kk], dv + kk * (2048 >> 4));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o);
      mbar_arrive(empty(s));
    }

    // Epilogue: the full row sums, then O / l as bf16, staged in the Q
    // buffer (no longer read) and written by one TMA store, which clips
    // rows past S.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / l_lo;
    const float inv_hi = 1.f / l_hi;
    const int r_lo = warp * 16 + g;
    uint8_t* q_tile = smem_raw + (sq - raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(q_tile + sw128_offset(r_lo, col)) =
          pack_f32(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(q_tile + sw128_offset(r_lo + 8, col)) =
          pack_f32(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup only
    if (tw == 0) tma_store_4d(&tm_o, sq, 0, h, m0, b);
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 128;      // four warps, 16 query rows each
constexpr int F_ROWS = 64;          // query rows per block
constexpr int F_TILE = 64;          // keys per K/V tile
constexpr int F_KS = HD + 8;        // K row stride in floats: 8-byte fragment loads free of conflicts
constexpr int F_VS = HD + 4;        // V row stride in floats: 4-byte fragment loads free of conflicts
constexpr int F_STAGE = F_TILE * (F_KS + F_VS);  // floats per ring slot (K tile, then V tile)
constexpr int F_SMEM_BYTES = 2 * F_STAGE * 4;    // 71,680: two slots

// 16-byte asynchronous copy; with `valid` false the destination is filled
// with zeros and nothing is read.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero as cvt.rna.tf32.f32 rounds, in two integer operations on the
// full-rate pipes (the conversion instruction runs at a quarter of that).
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi and lo TF32 values: hi rounded to nearest, lo the
// rounded remainder (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, TF32, row) * b (8 x 8, TF32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product at float32 accuracy, a_hi b_hi into `big` and a_lo b_hi +
// a_hi b_lo into `small` (the a_lo b_lo term, below 2^-22 of the product,
// is dropped).
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// Fragments of m16n8k8 (lane = 4 g + t): A holds (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); B holds (k=t, n=g), (k=t+4, n=g); C holds (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).  The order of a contraction is free as long as A
// and B follow the same one, so the kernel maps the fragment's k = t and
// k = t+4 onto neighbouring elements 2t and 2t+1 of each group of 8: K's
// two B values are one 8-byte load, and P's A fragment is the score
// accumulator as it stands (C's (g, 2t), (g, 2t+1) are A's (g, t), (g, t+4)).
//
// The tensor cores round their f32 sums toward zero, so a long chain of
// mma into one accumulator drifts (~3e-5 of the output over 1500 keys).
// Each chain here is one tile long: S from zero per tile, hi*hi apart from
// the small terms, and a tile's P V from zero, folded into O with an
// ordinary (round-to-nearest) FMA.
__global__ void __launch_bounds__(F_THREADS, 2) flash_fwd_f32_kernel(
    const float* __restrict__ q,  // (B, S, H, 64)
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ out, int S,
    int H, float scale_log2) {
  extern __shared__ float4 f_smem4[];
  float* smem = reinterpret_cast<float*>(f_smem4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)H * HD;  // elements between rows
  const size_t base = (size_t)b * S * rs + (size_t)h * HD;
  const int r0 = blockIdx.x * F_ROWS + warp * 16 + g;  // this lane's rows: r0 and r0 + 8

  // K and V tile `tile` into ring slot tile % 2, 16 bytes per copy; keys
  // past S are zeros.
  auto load_tile = [&](int tile) {
    float* ks = smem + (tile & 1) * F_STAGE;
    float* vs = ks + F_TILE * F_KS;
    const int n0 = tile * F_TILE;
#pragma unroll
    for (int i = tid; i < F_TILE * HD / 4; i += F_THREADS) {
      const int r = i >> 4;
      const int c = (i & 15) * 4;
      const bool ok = n0 + r < S;
      const size_t off = base + (size_t)(ok ? n0 + r : 0) * rs + c;
      cp_async16_zfill(ks + r * F_KS + c, k + off, ok);
      cp_async16_zfill(vs + r * F_VS + c, v + off, ok);
    }
    cp_async_commit();
  };
  const int n_tiles = (S + F_TILE - 1) / F_TILE;
  load_tile(0);

  // Q's A fragments, scaled into the log2 domain and split, for the 8
  // k-steps over d: (g, t) <-> d = 8s + 2t, (g, t+4) <-> d = 8s + 2t + 1.
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float2 zero = make_float2(0.f, 0.f);
    const float2 x0 = r0 < S ? *reinterpret_cast<const float2*>(q + base + (size_t)r0 * rs + 8 * s + 2 * t) : zero;
    const float2 x1 = r0 + 8 < S ? *reinterpret_cast<const float2*>(q + base + (size_t)(r0 + 8) * rs + 8 * s + 2 * t) : zero;
    split_tf32(x0.x * scale_log2, qh[s][0], ql[s][0]);
    split_tf32(x1.x * scale_log2, qh[s][1], ql[s][1]);
    split_tf32(x0.y * scale_log2, qh[s][2], ql[s][2]);
    split_tf32(x1.y * scale_log2, qh[s][3], ql[s][3]);
  }

  // O's accumulators: d tile j holds (g, 8j+2t), (g, 8j+2t+1), (g+8, 8j+2t),
  // (g+8, 8j+2t+1).  Running max (log2 domain) and this lane's part of the
  // running sum, for rows g and g+8.
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1);  // lands while this tile is multiplied
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smem + (tile & 1) * F_STAGE;
    const float* vs = ks + F_TILE * F_KS;

    // S = Q K^T for keys 8n + (0..7) in sc[n].
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float small[4] = {0.f, 0.f, 0.f, 0.f};
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const float* kr = ks + (8 * n + g) * F_KS + 2 * t;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float2 kk = *reinterpret_cast<const float2*>(kr + 8 * s);
        mma_3xtf32(sc[n], small, qh[s], ql[s], kk.x, kk.y);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] += small[i];
    }
    const int n_valid = S - tile * F_TILE;  // keys at or past S score -inf
    if (n_valid < F_TILE) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (8 * n + 2 * t >= n_valid) sc[n][0] = sc[n][2] = -INFINITY;
        if (8 * n + 2 * t + 1 >= n_valid) sc[n][1] = sc[n][3] = -INFINITY;
      }
    }

    // Online softmax in f32 (exp2f, not the approximate unit).  The first
    // tile always holds a key, so the maxima are finite from then on.
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[n][0], sc[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
    }
    const float corr_lo = exp2f(m_lo - mx_lo);  // 0 on the first tile
    const float corr_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mx_lo);
      sc[n][1] = exp2f(sc[n][1] - mx_lo);
      sc[n][2] = exp2f(sc[n][2] - mx_hi);
      sc[n][3] = exp2f(sc[n][3] - mx_hi);
      l_lo += sc[n][0] + sc[n][1];
      l_hi += sc[n][2] + sc[n][3];
    }

    // This tile's P V, k-step n over keys 8n..8n+7: A = P's accumulators
    // ((g, t) <-> key 8n + 2t, (g, t+4) <-> key 8n + 2t + 1), B = V rows
    // 8n + 2t and 8n + 2t + 1 at column 8j + g.  Then O = O * corr + P V.
    float pv[8][4], pv_small[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[j][i] = pv_small[j][i] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t ph[4], pl[4];
      split_tf32(sc[n][0], ph[0], pl[0]);
      split_tf32(sc[n][2], ph[1], pl[1]);
      split_tf32(sc[n][1], ph[2], pl[2]);
      split_tf32(sc[n][3], ph[3], pl[3]);
      const float* vr = vs + (8 * n + 2 * t) * F_VS + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_3xtf32(pv[j], pv_small[j], ph, pl, vr[8 * j], vr[F_VS + 8 * j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] = fmaf(o[j][0], corr_lo, pv[j][0] + pv_small[j][0]);
      o[j][1] = fmaf(o[j][1], corr_lo, pv[j][1] + pv_small[j][1]);
      o[j][2] = fmaf(o[j][2], corr_hi, pv[j][2] + pv_small[j][2]);
      o[j][3] = fmaf(o[j][3], corr_hi, pv[j][3] + pv_small[j][3]);
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o2);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (r0 < S)
      *reinterpret_cast<float2*>(out + base + (size_t)r0 * rs + 8 * j + 2 * t) =
          make_float2(o[j][0] * inv_lo, o[j][1] * inv_lo);
    if (r0 + 8 < S)
      *reinterpret_cast<float2*>(out + base + (size_t)(r0 + 8) * rs + 8 * j + 2 * t) =
          make_float2(o[j][2] * inv_hi, o[j][3] * inv_hi);
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

// A tensor map over (B, S, H, 64) bf16 seen as the 4-D (64, H, S, B), boxes
// of `rows` rows of one (b, h), 128-byte swizzle; rows past S read as zeros
// and are not written.
bool head_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ROW_BYTES, (cuuint64_t)H * ROW_BYTES,
                                 (cuuint64_t)S * H * ROW_BYTES};
  const cuuint32_t box[4] = {(cuuint32_t)HD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                 float scale_log2, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!head_map(&tq, q, B, S, H, QROWS) || !head_map(&tk, k, B, S, H, BN) ||
      !head_map(&tv, v, B, S, H, BN) || !head_map(&to, out, B, S, H, QROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WGMMA_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + QROWS - 1) / QROWS, H, B);
  flash_fwd_wgmma_kernel<<<grid, 256, WGMMA_SMEM_BYTES, stream>>>(tq, tk, tv, to, S, scale_log2);
  return (int)cudaGetLastError();
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

extern "C" int fwt_mha_flash_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                  int S, int H, float scale, void* stream) {
  return launch_wgmma(q, k, v, out, B, S, H, scale * kLog2e, (cudaStream_t)stream);
}

extern "C" int fwt_mha_flash_f32(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int H, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + F_ROWS - 1) / F_ROWS, H, B);
  flash_fwd_f32_kernel<<<grid, F_THREADS, F_SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H, scale * kLog2e);
  return (int)cudaGetLastError();
}
