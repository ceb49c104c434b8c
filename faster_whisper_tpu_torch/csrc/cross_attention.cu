// K4: decode-step cross-attention of K beam queries over the shared encoder
// K/V of one layer, on a bf16 cache (K4a) or an int8 cache with per-(head,
// t) scales (K4b/K4c, one kernel for the function of both).
//
// Replaces faster_whisper_tpu/ops/beam_attention.py::_cross_kernel_raw
// (K4a), ::_cross_kernel_quant (K4b, whole T) and ::_cross_kernel_quant_flash
// (K4c, T-blocked online softmax), all launched by cross_attend.
// Semantics (shared with the plain PyTorch version cross_attend_ref beside
// the wrapper, which computes the JAX decode step's unfused branch):
//
//   * the caches are (L, B, H, T, D), the int8 scales (L, B, H, 1, T); the
//     layer is addressed by index, nothing is copied per layer;
//   * score[k, t] = (q[k] . K[t]) * d_scale in f32, times the K scale of t
//     on the int8 cache (codes dequantized in registers);
//   * softmax over t in f32; on the int8 cache the V scale of t is folded
//     into the weight of t; PV accumulates in f32; the output is bf16.
//     The weights stay f32 (the plain version rounds them to bf16 before
//     PV: the two agree to the bf16 tolerance).
//
// What bounds it on an H100: bytes.  One (b, h) reads T*D*2 B of K and of V
// (bf16) or T*D B plus 2*T B of scales (int8), and does 4*K*T*D FLOP:
// about 2.5 FLOP/B at K=5, far below the card's 295 FLOP/B ridge.
//
// What the design does about it: one block per (b, h) walks T in tiles of
// K4_TB columns with an online softmax (running max, denominator and a
// rescale of the PV sums per tile), so each K and V element is read once
// from device memory and scores never leave shared memory.  In the score
// pass each thread owns one column, loads its whole row (16-byte loads,
// all in flight at once) and computes all K queries' dots from it; in the
// PV pass each thread owns a pair of D for a chunk of the tile's columns,
// keeps up to 16 V loads in flight (2-element loads, coalesced along D)
// and accumulates all K queries in registers; the chunks are summed once
// at the end.  Queries and weights are read from shared memory as float4.
// The head dim and a bound on K are template parameters, so these loops
// have fixed trip counts and issue no instructions for absent beams.  Columns at or past T (the ragged last tile)
// are masked to -inf before the softmax and never loaded.  Not split over
// T: at B=1 the launch has H=20 blocks; a split over T with a second
// reduction pass is left to a later change.  Plain FMA, no tensor cores
// (K=5 rows per (b, h)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int K4_THREADS = 256;
constexpr int K4_TB = K4_THREADS;  // columns per tile: one per thread in the score pass
constexpr int K4_MAXK = 16;        // most queries per (b, h)

__device__ __forceinline__ void row_values(const __nv_bfloat16* src, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 x = __bfloat1622float2(pr[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void row_values(const int8_t* src, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* pr = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = (float)pr[e];
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// CacheT is __nv_bfloat16 (K4a) or int8_t (K4b/K4c; then k_scale/v_scale
// are the (L, B, H, 1, T) bf16 scales, else unused).  D is the head dim, KM
// a bound on the beam count K held in registers.
template <typename CacheT, int D, int KM>
__global__ void __launch_bounds__(K4_THREADS) cross_attend_kernel(
    const __nv_bfloat16* __restrict__ q,        // (B, H, K, D)
    const CacheT* __restrict__ k_cache,         // (L, B, H, T, D)
    const __nv_bfloat16* __restrict__ k_scale,  // (L, B, H, 1, T), int8 only
    const CacheT* __restrict__ v_cache,         // (L, B, H, T, D)
    const __nv_bfloat16* __restrict__ v_scale,  // (L, B, H, 1, T), int8 only
    __nv_bfloat16* __restrict__ out,            // (B, H, K, D)
    int B, int H, int K, int T, int layer, float d_scale) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int kVec = 16 / sizeof(CacheT);    // values per 16-byte load
  constexpr int kLoads = D / kVec;             // 16-byte loads per row
  constexpr int D2 = D / 2;
  constexpr int kSplit = K4_THREADS / D2;      // PV column chunks per tile
  constexpr int kChunk = K4_TB / kSplit;       // columns per chunk
  constexpr int kBatch = kChunk < 16 ? kChunk : 16;  // V loads in flight per thread
  extern __shared__ float4 smem4[];  // 16-byte aligned: q and w are read as float4
  float* qf = reinterpret_cast<float*>(smem4);  // K*D   queries in f32
  float* w = qf + K * D;               // K*K4_TB   scores, then weights
  float* part = w;                     // kSplit*K*D after the last tile
  const int region = K * K4_TB > kSplit * K * D ? K * K4_TB : kSplit * K * D;
  float* m = w + region;               // K     running max
  float* l = m + K;                    // K     running denominator
  float* alpha = l + K;                // K     rescale of this tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;  // b * H + h
  const size_t row0 = (size_t)bh * K;
  const size_t srow = ((size_t)layer * B * H + bh) * (size_t)T;  // scale row
  const CacheT* kc = k_cache + srow * D;
  const CacheT* vc = v_cache + srow * D;

  for (int i = tid; i < K * D; i += K4_THREADS) qf[i] = __bfloat162float(q[row0 * D + i]);
  for (int k = tid; k < K; k += K4_THREADS) {
    m[k] = -INFINITY;
    l[k] = 0.f;
  }

  const int sp = tid / D2;
  const int d2 = tid % D2;
  float ax[KM], ay[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) ax[k] = ay[k] = 0.f;

  for (int t0 = 0; t0 < T; t0 += K4_TB) {
    __syncthreads();  // the previous tile's PV pass is done with w

    // Scores: thread tid owns column t0 + tid; its whole row is loaded
    // before the dots.
    {
      const int t = t0 + tid;
      if (t < T) {
        uint4 raw[kLoads];
        const uint4* row = reinterpret_cast<const uint4*>(kc + (size_t)t * D);
#pragma unroll
        for (int i = 0; i < kLoads; ++i) raw[i] = row[i];
        float ks = 1.f;
        if constexpr (kQuant) ks = __bfloat162float(k_scale[srow + t]);
        float acc[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) acc[k] = 0.f;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          float f[kVec];
          row_values(reinterpret_cast<const CacheT*>(&raw[i]), f);
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            if (k < K) {
              const float4* q4 = reinterpret_cast<const float4*>(qf + k * D + i * kVec);
#pragma unroll
              for (int e4 = 0; e4 < kVec / 4; ++e4) {
                const float4 qq = q4[e4];
                acc[k] += qq.x * f[4 * e4];
                acc[k] += qq.y * f[4 * e4 + 1];
                acc[k] += qq.z * f[4 * e4 + 2];
                acc[k] += qq.w * f[4 * e4 + 3];
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (k < K) {
            float s = acc[k] * d_scale;
            if constexpr (kQuant) s *= ks;
            w[k * K4_TB + tid] = s;
          }
        }
      } else {
        for (int k = 0; k < K; ++k) w[k * K4_TB + tid] = -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, one warp per query: every tile holds a column < T, so
    // the new max is finite; alpha is 0 on the first tile.
    for (int k = warp; k < K; k += K4_THREADS / 32) {
      float* wk = w + k * K4_TB;
      float tmax = -INFINITY;
      for (int c = lane; c < K4_TB; c += 32) tmax = fmaxf(tmax, wk[c]);
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[k], tmax);
      float sum = 0.f;
      for (int c = lane; c < K4_TB; c += 32) {
        const float e = expf(wk[c] - m_new);  // 0 on masked columns
        sum += e;
        float wt = e;
        if constexpr (kQuant) {
          if (t0 + c < T) wt *= __bfloat162float(v_scale[srow + t0 + c]);
        }
        wk[c] = wt;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m[k] - m_new);
        alpha[k] = a;
        l[k] = l[k] * a + sum;
        m[k] = m_new;
      }
    }
    __syncthreads();

    // PV: thread (sp, d2) takes columns [sp*kChunk, (sp+1)*kChunk) of the
    // tile, kBatch V loads in flight at a time; columns at or past T load
    // zeros (their weights are 0).
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        ax[k] *= alpha[k];
        ay[k] *= alpha[k];
      }
    }
    const int tc0 = sp * kChunk;
    const int n_valid = T - t0 - tc0;
    for (int c = 0; c < kChunk; c += kBatch) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = c + u < n_valid ? load_pair(vc + (size_t)(t0 + tc0 + c + u) * D + 2 * d2)
                               : make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {
          const float4* w4 = reinterpret_cast<const float4*>(w + k * K4_TB + tc0 + c);
#pragma unroll
          for (int u4 = 0; u4 < kBatch / 4; ++u4) {
            const float4 wt = w4[u4];
            ax[k] += wt.x * v[4 * u4].x;
            ay[k] += wt.x * v[4 * u4].y;
            ax[k] += wt.y * v[4 * u4 + 1].x;
            ay[k] += wt.y * v[4 * u4 + 1].y;
            ax[k] += wt.z * v[4 * u4 + 2].x;
            ay[k] += wt.z * v[4 * u4 + 2].y;
            ax[k] += wt.w * v[4 * u4 + 3].x;
            ay[k] += wt.w * v[4 * u4 + 3].y;
          }
        }
      }
    }
  }
  __syncthreads();  // part aliases w

#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k < K) {
      part[(sp * K + k) * D + 2 * d2] = ax[k];
      part[(sp * K + k) * D + 2 * d2 + 1] = ay[k];
    }
  }
  __syncthreads();

  for (int i = tid; i < K * D; i += K4_THREADS) {
    float acc = 0.f;
    for (int s = 0; s < kSplit; ++s) acc += part[s * K * D + i];
    out[row0 * D + i] = __float2bfloat16(acc / l[i / D]);
  }
}

template <typename CacheT, int D, int KM>
int launch_d(const void* q, const void* k_cache, const void* k_scale,
             const void* v_cache, const void* v_scale, void* out, int B, int H,
             int K, int T, int layer, float d_scale, cudaStream_t stream) {
  constexpr int kSplit = K4_THREADS / (D / 2);
  const int region = K * K4_TB > kSplit * K * D ? K * K4_TB : kSplit * K * D;
  const int smem = (int)sizeof(float) * (K * D + region + 3 * K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cross_attend_kernel<CacheT, D, KM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cross_attend_kernel<CacheT, D, KM><<<B * H, K4_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const CacheT*)k_cache, (const __nv_bfloat16*)k_scale,
      (const CacheT*)v_cache, (const __nv_bfloat16*)v_scale, (__nv_bfloat16*)out,
      B, H, K, T, layer, d_scale);
  return (int)cudaGetLastError();
}

// The beam count picks the register bound: greedy (1), the default beam and
// best_of (5), then 8 and K4_MAXK.
template <typename CacheT, int D>
int launch_k(const void* q, const void* k_cache, const void* k_scale,
             const void* v_cache, const void* v_scale, void* out, int B, int H,
             int K, int T, int layer, float d_scale, cudaStream_t st) {
  if (K == 1)
    return launch_d<CacheT, D, 1>(q, k_cache, k_scale, v_cache, v_scale, out, B, H, K, T, layer, d_scale, st);
  if (K <= 5)
    return launch_d<CacheT, D, 5>(q, k_cache, k_scale, v_cache, v_scale, out, B, H, K, T, layer, d_scale, st);
  if (K <= 8)
    return launch_d<CacheT, D, 8>(q, k_cache, k_scale, v_cache, v_scale, out, B, H, K, T, layer, d_scale, st);
  return launch_d<CacheT, D, K4_MAXK>(q, k_cache, k_scale, v_cache, v_scale, out, B, H, K, T, layer, d_scale, st);
}

// Every Whisper size has a head dim of 64, the only one built (the kernel
// takes any power of two from 32 to 128 as its template parameter).
template <typename CacheT>
int launch(const void* q, const void* k_cache, const void* k_scale,
           const void* v_cache, const void* v_scale, void* out, int B, int H,
           int K, int T, int D, int layer, float d_scale, void* stream) {
  // The wrapper checks 1 <= K <= K4_MAXK and D == 64.
  if (K < 1 || K > K4_MAXK || D != 64) return (int)cudaErrorInvalidValue;
  return launch_k<CacheT, 64>(q, k_cache, k_scale, v_cache, v_scale, out, B, H, K, T,
                              layer, d_scale, (cudaStream_t)stream);
}

}  // namespace

extern "C" int fwt_cross_attend_bf16(const void* q, const void* k_cache,
                                     const void* v_cache, void* out, int B,
                                     int H, int K, int T, int D, int layer,
                                     float d_scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_cache, nullptr, v_cache, nullptr, out, B,
                               H, K, T, D, layer, d_scale, stream);
}

extern "C" int fwt_cross_attend_int8(const void* q, const void* k_codes,
                                     const void* k_scale, const void* v_codes,
                                     const void* v_scale, void* out, int B,
                                     int H, int K, int T, int D, int layer,
                                     float d_scale, void* stream) {
  return launch<int8_t>(q, k_codes, k_scale, v_codes, v_scale, out, B, H, K, T,
                        D, layer, d_scale, stream);
}
