// K1: one decode step of beam self-attention with in-place KV-cache append.
//
// Replaces the TPU kernel faster_whisper_tpu/ops/beam_attention.py::_kernel_bf16
// (launched by beam_attend_append).  Semantics (shared with the plain
// PyTorch version beam_attend_append_ref beside the wrapper):
//
//   * the new token's K/V land at column pos_row[b] of every beam slot j of
//     layer `layer` of the (L, B, H, K, ctx, D) caches, in place;
//   * query beam k attends over all K slots with one joint softmax under
//     the ancestry mask anc[b,k,c] == j AND c <= pos: for every column c
//     exactly one slot, anc[b,k,c], is visible, so the softmax runs over
//     pos+1 gathered columns;
//   * q is scaled in f32 and rounded to bf16 before QK, scores and softmax
//     are f32, the weights are rounded to bf16 before PV, PV accumulates in
//     f32 and the output is bf16.
//
// What bounds it on an H100: bytes.  Per (b, h) it reads (pos+1)*K*D*2 B of
// K and as much of V (plus q, k_new, v_new, anc) and does ~4*K*(pos+1)*D
// FLOP, far below the card's 295 FLOP/B ridge.
//
// What the design does about it: one block per (b, h) keeps the K query
// rows, the new K/V rows and the K x (pos+1) score matrix in shared memory
// (at most 5*448*4 B = 9 KB at beam 5), so scores and softmax never touch
// device memory and every cache row a query needs is read once per query
// from L1/L2.  Column pos takes the new K/V from shared memory and is
// written back after the reads, so no block reads a column that it or
// another block writes.  The PV pass splits the columns in K1_NSPLIT
// chunks so that all threads stream V with bf16x2 loads that are coalesced
// along D.  Plain FMA, no tensor cores: at K=5 queries per (b, h) a matrix
// unit would idle.  No wgmma/TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_NSPLIT = 4;

__global__ void __launch_bounds__(K1_THREADS) beam_attend_append_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,      // (B, H, K, D)
    const __nv_bfloat16* __restrict__ k_new,  // (B, H, K, D)
    const __nv_bfloat16* __restrict__ v_new,  // (B, H, K, D)
    __nv_bfloat16* k_cache,                   // (L, B, H, K, ctx, D)
    __nv_bfloat16* v_cache,                   // (L, B, H, K, ctx, D)
    const int* __restrict__ anc,              // (B, K, ctx)
    const int* __restrict__ pos_row,          // (B,)
    __nv_bfloat16* __restrict__ out,          // (B, H, K, D)
    int B, int H, int K, int ctx, int D, int layer, float d_scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // K*D   q * d_scale, rounded to bf16
  float* kn = qs + K * D;        // K*D   new K rows
  float* vn = kn + K * D;        // K*D   new V rows
  float* part = vn + K * D;      // K1_NSPLIT*K*D   PV partial sums
  float* p = part + K1_NSPLIT * K * D;  // K*n   scores, then weights

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // The caller guarantees 0 <= pos < ctx; clamp so that a bad value can
  // never address memory outside the cache.
  const int pos = min(max(pos_row[b], 0), ctx - 1);
  const int n = pos + 1;  // columns 0..pos are visible

  const size_t row0 = ((size_t)b * H + h) * K;  // (b, h, slot 0) in (B,H,K)
  const size_t cache0 = (((size_t)layer * B + b) * H + h) * (size_t)K * ctx * D;
  const int* anc_b = anc + (size_t)b * K * ctx;

  for (int i = tid; i < K * D; i += blockDim.x) {
    float qv = __bfloat162float(q[row0 * D + i]) * d_scale;
    qs[i] = __bfloat162float(__float2bfloat16(qv));
    kn[i] = __bfloat162float(k_new[row0 * D + i]);
    vn[i] = __bfloat162float(v_new[row0 * D + i]);
  }
  __syncthreads();

  // Scores: one thread per (query k, column c), reading the visible slot's
  // row with 16-byte loads.
  for (int it = tid; it < K * n; it += blockDim.x) {
    const int k = it / n;
    const int c = it - k * n;
    const int j = anc_b[k * ctx + c];
    float s = -1e30f;
    if (j >= 0 && j < K) {
      const float* qk = qs + k * D;
      float acc = 0.f;
      if (c == pos) {
        const float* kr = kn + j * D;
        for (int d = 0; d < D; ++d) acc += qk[d] * kr[d];
      } else {
        const uint4* kr = reinterpret_cast<const uint4*>(
            k_cache + cache0 + ((size_t)j * ctx + c) * D);
        for (int d8 = 0; d8 < D / 8; ++d8) {
          uint4 raw = kr[d8];
          const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float2 f = __bfloat1622float2(pr[e]);
            acc += qk[d8 * 8 + 2 * e] * f.x + qk[d8 * 8 + 2 * e + 1] * f.y;
          }
        }
      }
      s = acc;
    }
    p[k * n + c] = s;
  }
  __syncthreads();

  // Softmax in f32, one warp per query; weights rounded to bf16.
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int k = warp; k < K; k += blockDim.x / 32) {
    float* pk = p + k * n;
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, pk[c]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      float e = expf(pk[c] - m);
      pk[c] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int c = lane; c < n; c += 32)
      pk[c] = __bfloat162float(__float2bfloat16(pk[c] / sum));
  }
  __syncthreads();

  // PV: thread item = (column chunk, query k, pair of D), bf16x2 loads.
  const int D2 = D / 2;
  const int chunk = (n + K1_NSPLIT - 1) / K1_NSPLIT;
  for (int it = tid; it < K1_NSPLIT * K * D2; it += blockDim.x) {
    const int d2 = it % D2;
    const int k = (it / D2) % K;
    const int sp = it / (D2 * K);
    const int c_end = min(n, (sp + 1) * chunk);
    float ax = 0.f, ay = 0.f;
    for (int c = sp * chunk; c < c_end; ++c) {
      const int j = anc_b[k * ctx + c];
      if (j < 0 || j >= K) continue;
      const float w = p[k * n + c];
      float2 v;
      if (c == pos) {
        v = make_float2(vn[j * D + 2 * d2], vn[j * D + 2 * d2 + 1]);
      } else {
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            v_cache + cache0 + ((size_t)j * ctx + c) * D + 2 * d2));
      }
      ax += w * v.x;
      ay += w * v.y;
    }
    part[(sp * K + k) * D + 2 * d2] = ax;
    part[(sp * K + k) * D + 2 * d2 + 1] = ay;
  }
  __syncthreads();

  for (int i = tid; i < K * D; i += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int sp = 0; sp < K1_NSPLIT; ++sp) acc += part[sp * K * D + i];
    out[row0 * D + i] = __float2bfloat16(acc);
  }

  // Append: column pos of every slot of this (layer, b, h), after all reads.
  for (int i = tid; i < K * D; i += blockDim.x) {
    const int j = i / D;
    const int d = i - j * D;
    const size_t off = cache0 + ((size_t)j * ctx + pos) * D + d;
    k_cache[off] = k_new[row0 * D + i];
    v_cache[off] = v_new[row0 * D + i];
  }
}

int smem_bytes(int K, int ctx, int D) {
  return (int)(sizeof(float) * ((3 + K1_NSPLIT) * K * D + K * ctx));
}

}  // namespace

extern "C" int fwt_beam_attend_append_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* anc, const void* pos_row, void* out, int B,
    int H, int K, int ctx, int D, int layer, float d_scale, void* stream) {
  // Past the card's shared memory per block, cudaFuncSetAttribute fails and
  // its error is returned.
  const int smem = smem_bytes(K, ctx, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_attend_append_bf16_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  beam_attend_append_bf16_kernel<<<B * H, K1_THREADS, smem,
                                   (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new,
      (const __nv_bfloat16*)v_new, (__nv_bfloat16*)k_cache,
      (__nv_bfloat16*)v_cache, (const int*)anc, (const int*)pos_row,
      (__nv_bfloat16*)out, B, H, K, ctx, D, layer, d_scale);
  return (int)cudaGetLastError();
}
