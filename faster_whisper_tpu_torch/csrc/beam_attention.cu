// K1 and K2: one decode step of beam self-attention with in-place KV-cache
// append, over a raw cache (K1) or an int8 cache with per-row scales (K2),
// with activations (q, the new K/V rows, the output; K1's cache too) in
// bfloat16 or float32.
//
// K1 replaces faster_whisper_tpu/ops/beam_attention.py::_kernel_bf16 and K2
// replaces ::_kernel_quant (both launched by beam_attend_append).
// Semantics (shared with the plain PyTorch version beam_attend_append_ref
// beside the wrapper):
//
//   * the new token's K/V land at column pos_row[b] of every beam slot j of
//     layer `layer` of the (L, B, H, K, ctx, D) caches, in place;
//   * query beam k attends over all K slots with one joint softmax under
//     the ancestry mask anc[b,k,c] == j AND c <= pos: for every column c
//     exactly one slot, anc[b,k,c], is visible, so the softmax runs over
//     pos+1 gathered columns;
//   * q is scaled in f32 and rounded to the activation type before QK,
//     scores and softmax are f32, the weights are rounded to the activation
//     type before PV, PV accumulates in f32 and the output is in the
//     activation type (in float32 nothing is rounded).
//
// K2 only: the int8 cache holds codes (L, B, H, K, ctx, D) and bf16 scales
// (L, B, H, K, ctx), in float32 runs too, as the JAX package stores them.  The new K/V row of each (beam, head) is quantized
// with s = max(max|x| * (1/127), 1e-10) and code = clamp(rint(x / s), -127,
// 127), and s is stored rounded to bf16.  These are the plain version's
// float32 operations (ops/quant.py::quantize_kv): the scale is a product
// by the float32 reciprocal, as XLA compiles the JAX package's
// max|x| / 127, the code a true division, rint rounds half to even as
// torch.round does.  Attention
// dequantizes in registers: a score is (q . codes) * bf16 scale, a PV
// weight is rounded to the activation type after the V scale is folded in.  The new
// column enters with the bf16-rounded scale the plain version reads back
// from the cache (the TPU kernel used the unrounded one).  Unlike the TPU
// kernel, q and the weights are not quantized: the TPU did that for the
// MXU's s8 path, and the plain version does not.
//
// What bounds them on an H100: bytes.  Per (b, h) a step reads (pos+1)*K
// rows of K and of V, D*2 B each for K1 and D B plus a 2 B scale for K2,
// and does ~4*K*(pos+1)*D FLOP, far below the card's 295 FLOP/B ridge.
//
// What the design does about it: one block per (b, h) keeps the K query
// rows, the new K/V rows and the K x (pos+1) score matrix in shared memory
// (at most 5*448*4 B = 9 KB at beam 5), so scores and softmax never touch
// device memory and every cache row a query needs is read once per query
// from L1/L2.  Column pos takes the new K/V from shared memory and is
// written back after the reads, so no block reads a column that it or
// another block writes.  The PV pass splits the columns in K1_NSPLIT
// chunks so that all threads stream V with 2-element loads that are
// coalesced along D, K1_BATCH columns' loads in flight at a time.  Plain FMA, no tensor cores: at K=5 queries per
// (b, h) a matrix unit would idle.  No wgmma/TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_NSPLIT = 4;
constexpr int K1_BATCH = 8;  // PV columns whose loads are in flight together

// Dot of a cache row with the f32 query row qk, with 16-byte loads: 8 bf16,
// 4 f32 or 16 int8 values (codes, unscaled) per load.
// qk is 16-byte aligned and read as float4.
__device__ __forceinline__ float row_dot(const __nv_bfloat16* row, const float* qk, int D) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(qk);
  float acc = 0.f;
#pragma unroll 8
  for (int d8 = 0; d8 < D / 8; ++d8) {
    uint4 raw = r[d8];
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 qa = q4[2 * d8], qb = q4[2 * d8 + 1];
    const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(pr[e]);
      acc += qv[2 * e] * f.x + qv[2 * e + 1] * f.y;
    }
  }
  return acc;
}

__device__ __forceinline__ float row_dot(const float* row, const float* qk, int D) {
  const float4* r = reinterpret_cast<const float4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(qk);
  float acc = 0.f;
#pragma unroll 8
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = r[d4], qq = q4[d4];
    acc += qq.x * x.x + qq.y * x.y;
    acc += qq.z * x.z + qq.w * x.w;
  }
  return acc;
}

__device__ __forceinline__ float row_dot(const int8_t* row, const float* qk, int D) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  const float4* q4 = reinterpret_cast<const float4*>(qk);
  float acc = 0.f;
#pragma unroll 4
  for (int d16 = 0; d16 < D / 16; ++d16) {
    uint4 raw = r[d16];
    const int8_t* pr = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      const float4 qq = q4[4 * d16 + e4];
      acc += qq.x * (float)pr[4 * e4];
      acc += qq.y * (float)pr[4 * e4 + 1];
      acc += qq.z * (float)pr[4 * e4 + 2];
      acc += qq.w * (float)pr[4 * e4 + 3];
    }
  }
  return acc;
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// ActT is the activation type, __nv_bfloat16 or float.  CacheT is ActT (K1)
// or int8_t (K2; then k_scale/v_scale are the (L, B, H, K, ctx) bf16
// scales, else unused).
template <typename ActT, typename CacheT>
__global__ void __launch_bounds__(K1_THREADS) beam_attend_append_kernel(
    const ActT* __restrict__ q,      // (B, H, K, D)
    const ActT* __restrict__ k_new,  // (B, H, K, D)
    const ActT* __restrict__ v_new,  // (B, H, K, D)
    CacheT* k_cache,                          // (L, B, H, K, ctx, D)
    __nv_bfloat16* k_scale,                   // (L, B, H, K, ctx), K2 only
    CacheT* v_cache,                          // (L, B, H, K, ctx, D)
    __nv_bfloat16* v_scale,                   // (L, B, H, K, ctx), K2 only
    const int* __restrict__ anc,              // (B, K, ctx)
    const int* __restrict__ pos_row,          // (B,)
    ActT* __restrict__ out,                   // (B, H, K, D)
    int B, int H, int K, int ctx, int D, int layer, float d_scale) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  // Rounds to the activation type where the plain version casts to it.
  auto act_round = [](float x) {
    if constexpr (std::is_same<ActT, float>::value) {
      return x;
    } else {
      return bf16_round(x);
    }
  };
  extern __shared__ float4 smem4[];  // 16-byte aligned: q rows are read as float4
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;              // K*D   q * d_scale, rounded to ActT
  float* kn = qs + K * D;        // K*D   new K rows (K2: their codes)
  float* vn = kn + K * D;        // K*D   new V rows (K2: their codes)
  float* part = vn + K * D;      // K1_NSPLIT*K*D   PV partial sums
  float* p = part + K1_NSPLIT * K * D;  // K*n   scores, then weights
  float* kns = p + K * ctx;      // K   K2: new rows' scales, bf16-rounded
  float* vns = kns + K;          // K
  float* kns_raw = vns + K;      // K   K2: the same, unrounded (for the codes)
  float* vns_raw = kns_raw + K;  // K

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // The caller guarantees 0 <= pos < ctx; clamp so that a bad value can
  // never address memory outside the cache.
  const int pos = min(max(pos_row[b], 0), ctx - 1);
  const int n = pos + 1;  // columns 0..pos are visible

  const size_t row0 = ((size_t)b * H + h) * K;  // (b, h, slot 0) in (B,H,K)
  const size_t srow0 = (((size_t)layer * B + b) * H + h) * (size_t)K * ctx;
  const size_t cache0 = srow0 * D;
  const int* anc_b = anc + (size_t)b * K * ctx;

  if constexpr (kQuant) {
    // One warp per new (beam, head) row: its scale from max|x| over D.
    for (int j = warp; j < 2 * K; j += nwarps) {
      const ActT* src = (j < K ? k_new : v_new) + (row0 + j % K) * D;
      float m = 0.f;
      for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(to_f32(src[d])));
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) {
        const float s = fmaxf(m * (1.f / 127.f), 1e-10f);
        (j < K ? kns_raw : vns_raw)[j % K] = s;
        (j < K ? kns : vns)[j % K] = bf16_round(s);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < K * D; i += blockDim.x) {
    float qv = to_f32(q[row0 * D + i]) * d_scale;
    qs[i] = act_round(qv);
    float kv = to_f32(k_new[row0 * D + i]);
    float vv = to_f32(v_new[row0 * D + i]);
    if constexpr (kQuant) {
      kv = fminf(fmaxf(rintf(kv / kns_raw[i / D]), -127.f), 127.f);
      vv = fminf(fmaxf(rintf(vv / vns_raw[i / D]), -127.f), 127.f);
    }
    kn[i] = kv;
    vn[i] = vv;
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
        if constexpr (kQuant) acc *= kns[j];
      } else {
        acc = row_dot(k_cache + cache0 + ((size_t)j * ctx + c) * D, qk, D);
        if constexpr (kQuant) acc *= __bfloat162float(k_scale[srow0 + (size_t)j * ctx + c]);
      }
      s = acc;
    }
    p[k * n + c] = s;
  }
  __syncthreads();

  // Softmax in f32, one warp per query; K2 folds the V scales in; the
  // weights are rounded to the activation type.
  for (int k = warp; k < K; k += nwarps) {
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
    for (int c = lane; c < n; c += 32) {
      float w = pk[c] / sum;
      if constexpr (kQuant) {
        const int j = anc_b[k * ctx + c];
        if (j >= 0 && j < K)
          w *= c == pos ? vns[j]
                        : __bfloat162float(v_scale[srow0 + (size_t)j * ctx + c]);
      }
      pk[c] = act_round(w);
    }
  }
  __syncthreads();

  // PV: thread item = (column chunk, query k, pair of D).  The ancestry
  // and then the V pairs of K1_BATCH columns are loaded before their FMAs,
  // so that their latencies overlap; the sum runs over c in order.
  const int D2 = D / 2;
  const int chunk = (n + K1_NSPLIT - 1) / K1_NSPLIT;
  for (int it = tid; it < K1_NSPLIT * K * D2; it += blockDim.x) {
    const int d2 = it % D2;
    const int k = (it / D2) % K;
    const int sp = it / (D2 * K);
    const int c_end = min(n, (sp + 1) * chunk);
    float ax = 0.f, ay = 0.f;
    for (int c0 = sp * chunk; c0 < c_end; c0 += K1_BATCH) {
      int jj[K1_BATCH];
      float2 v[K1_BATCH];
#pragma unroll
      for (int u = 0; u < K1_BATCH; ++u)
        jj[u] = c0 + u < c_end ? anc_b[k * ctx + c0 + u] : -1;
#pragma unroll
      for (int u = 0; u < K1_BATCH; ++u) {
        const int c = c0 + u;
        const int j = jj[u];
        if (j < 0 || j >= K) {
          v[u] = make_float2(0.f, 0.f);
        } else if (c == pos) {
          v[u] = make_float2(vn[j * D + 2 * d2], vn[j * D + 2 * d2 + 1]);
        } else {
          v[u] = load_pair(v_cache + cache0 + ((size_t)j * ctx + c) * D + 2 * d2);
        }
      }
#pragma unroll
      for (int u = 0; u < K1_BATCH; ++u) {
        if (jj[u] < 0 || jj[u] >= K) continue;
        const float w = p[k * n + c0 + u];
        ax += w * v[u].x;
        ay += w * v[u].y;
      }
    }
    part[(sp * K + k) * D + 2 * d2] = ax;
    part[(sp * K + k) * D + 2 * d2 + 1] = ay;
  }
  __syncthreads();

  for (int i = tid; i < K * D; i += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int sp = 0; sp < K1_NSPLIT; ++sp) acc += part[sp * K * D + i];
    store(out + row0 * D + i, acc);
  }

  // Append: column pos of every slot of this (layer, b, h), after all reads.
  for (int i = tid; i < K * D; i += blockDim.x) {
    const int j = i / D;
    const int d = i - j * D;
    const size_t off = cache0 + ((size_t)j * ctx + pos) * D + d;
    if constexpr (kQuant) {
      k_cache[off] = (int8_t)(int)kn[i];
      v_cache[off] = (CacheT)(int)vn[i];
    } else {
      k_cache[off] = k_new[row0 * D + i];
      v_cache[off] = v_new[row0 * D + i];
    }
  }
  if constexpr (kQuant) {
    for (int j = tid; j < K; j += blockDim.x) {
      k_scale[srow0 + (size_t)j * ctx + pos] = __float2bfloat16(kns[j]);
      v_scale[srow0 + (size_t)j * ctx + pos] = __float2bfloat16(vns[j]);
    }
  }
}

int smem_bytes(int K, int ctx, int D) {
  return (int)(sizeof(float) * ((3 + K1_NSPLIT) * K * D + K * ctx + 4 * K));
}

template <typename ActT, typename CacheT>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
           void* k_scale, void* v_cache, void* v_scale, const void* anc,
           const void* pos_row, void* out, int B, int H, int K, int ctx, int D,
           int layer, float d_scale, void* stream) {
  // Past the card's shared memory per block, cudaFuncSetAttribute fails and
  // its error is returned.
  const int smem = smem_bytes(K, ctx, D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        beam_attend_append_kernel<ActT, CacheT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  beam_attend_append_kernel<ActT, CacheT><<<B * H, K1_THREADS, smem, (cudaStream_t)stream>>>(
      (const ActT*)q, (const ActT*)k_new, (const ActT*)v_new, (CacheT*)k_cache,
      (__nv_bfloat16*)k_scale, (CacheT*)v_cache, (__nv_bfloat16*)v_scale, (const int*)anc,
      (const int*)pos_row, (ActT*)out, B, H, K, ctx, D, layer, d_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fwt_beam_attend_append_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* anc, const void* pos_row, void* out, int B,
    int H, int K, int ctx, int D, int layer, float d_scale, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, k_cache, nullptr, v_cache,
                                              nullptr, anc, pos_row, out, B, H, K, ctx, D,
                                              layer, d_scale, stream);
}

extern "C" int fwt_beam_attend_append_f32(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* anc, const void* pos_row, void* out, int B,
    int H, int K, int ctx, int D, int layer, float d_scale, void* stream) {
  return launch<float, float>(q, k_new, v_new, k_cache, nullptr, v_cache, nullptr, anc,
                              pos_row, out, B, H, K, ctx, D, layer, d_scale, stream);
}

extern "C" int fwt_beam_attend_append_int8(
    const void* q, const void* k_new, const void* v_new, void* k_codes,
    void* k_scale, void* v_codes, void* v_scale, const void* anc,
    const void* pos_row, void* out, int B, int H, int K, int ctx, int D,
    int layer, float d_scale, void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k_new, v_new, k_codes, k_scale, v_codes, v_scale,
                                       anc, pos_row, out, B, H, K, ctx, D, layer, d_scale,
                                       stream);
}

extern "C" int fwt_beam_attend_append_int8_f32(
    const void* q, const void* k_new, const void* v_new, void* k_codes,
    void* k_scale, void* v_codes, void* v_scale, const void* anc,
    const void* pos_row, void* out, int B, int H, int K, int ctx, int D,
    int layer, float d_scale, void* stream) {
  return launch<float, int8_t>(q, k_new, v_new, k_codes, k_scale, v_codes, v_scale, anc,
                               pos_row, out, B, H, K, ctx, D, layer, d_scale, stream);
}
