// K3: unmasked encoder self-attention, softmax(Q K^T / sqrt(64)) V, as a
// flash-attention forward over the (B, S, H, 64) bf16 layout.
//
// Replaces the TPU kernel faster_whisper_tpu/ops/attention.py::_mha_flash_full
// (selected by mha_full; on the TPU it called the Pallas library kernel
// jax.experimental.pallas.ops.tpu.flash_attention, padded to 1536 with
// segment ids).  The plain PyTorch version is ops/attention.py::mha.
//
// What bounds it on an H100: operations.  At the encoder's S=1500, D=64 it
// does 4*S*S*D FLOP per (b, h) against 4*S*D*2 B of input and output, about
// 375 FLOP/B, above the card's bf16 ridge of 295 FLOP/B, so the tensor
// cores are the limit (989 TFLOP/s dense bf16).
//
// What the design does about it: the (S, S) score matrix never exists in
// device memory.  One block of 4 warps owns a 64-row Q tile of one (b, h);
// each warp keeps its 16 Q rows as mma.sync A fragments in registers for
// the whole pass and walks the keys in tiles of 64 staged in shared memory.
// QK^T and PV run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate); the softmax is online, with an f32 running max and sum per
// row, and the P tile goes from the QK accumulators straight into PV A
// fragments (rounded to bf16) without a trip through shared memory.  The
// ragged tail of S=1500 is masked in the kernel: keys past S score -inf,
// Q rows past S are computed on zeros and not stored.  Single-buffered
// loads and mma.sync, no wgmma/TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;       // head dim
constexpr int BM = 64;       // Q rows per block (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int LDS = HD + 8;  // shared row stride (bf16), padded against bank conflicts
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)(*reinterpret_cast<uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<uint16_t*>(&hi)) << 16);
}

__global__ void __launch_bounds__(THREADS) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, S, H, 64)
    const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out,
    int S, int H, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BN][LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN][LDS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row_stride = (size_t)H * HD;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * HD;

  // Q fragments of this warp's 16 rows, 4 k-steps of 16 over D.
  const int r_lo = blockIdx.x * BM + warp * 16 + g;
  const int r_hi = r_lo + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kk * 16 + half * 8 + t * 2;
      qa[kk][half * 2 + 0] = r_lo < S
          ? *reinterpret_cast<const uint32_t*>(q + base + r_lo * row_stride + col)
          : 0u;
      qa[kk][half * 2 + 1] = r_hi < S
          ? *reinterpret_cast<const uint32_t*>(q + base + r_hi * row_stride + col)
          : 0u;
    }
  }

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (log2 domain)
  float l_lo = 0.f, l_hi = 0.f;              // running sum

  for (int n0 = 0; n0 < S; n0 += BN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BN * (HD / 8); i += THREADS) {
      const int r = i / (HD / 8);
      const int c8 = (i % (HD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (n0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(k + base + (n0 + r) * row_stride + c8);
        vv = *reinterpret_cast<const uint4*>(v + base + (n0 + r) * row_stride + c8);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c8]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r][c8]) = vv;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + t * 2]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 8 + t * 2]);
        mma_16816(s[nt], qa[kk], b0, b1);
      }
    }

    // Scale into the log2 domain, mask the ragged tail, online softmax.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = n0 + nt * 8 + t * 2 + e < S;
        s[nt][e] = valid ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][2 + e] = valid ? s[nt][2 + e] * scale_log2 : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[nt][e]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Every tile holds at least one key < S, so the new max is finite.
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo);
    const float corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      o[nd][0] *= corr_lo;
      o[nd][1] *= corr_lo;
      o[nd][2] *= corr_hi;
      o[nd][3] *= corr_hi;
    }

    // O += P V: 4 k-steps of 16 keys, 8 n-tiles of 8 head dims.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int kr = j * 16 + t * 2;
#pragma unroll
      for (int nd = 0; nd < 8; ++nd) {
        const int col = nd * 8 + g;
        const uint32_t b0 = pack_bf16(Vs[kr][col], Vs[kr + 1][col]);
        const uint32_t b1 = pack_bf16(Vs[kr + 8][col], Vs[kr + 9][col]);
        mma_16816(o[nd], pa, b0, b1);
      }
    }
  }

  const float inv_lo = 1.f / l_lo;
  const float inv_hi = 1.f / l_hi;
#pragma unroll
  for (int nd = 0; nd < 8; ++nd) {
    const int col = nd * 8 + t * 2;
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(out + base + r_lo * row_stride + col) =
          pack_f32(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    if (r_hi < S)
      *reinterpret_cast<uint32_t*>(out + base + r_hi * row_stride + col) =
          pack_f32(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
  }
}

}  // namespace

extern "C" int fwt_mha_flash_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int S, int H, float scale,
                                  void* stream) {
  const float log2e = 1.4426950408889634f;
  dim3 grid((S + BM - 1) / BM, H, B);
  flash_fwd_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, H, scale * log2e);
  return (int)cudaGetLastError();
}
