// K4: decode-step cross-attention of K beam queries over the shared encoder
// K/V of one layer, on a raw cache (K4a) or an int8 cache with per-(head,
// t) scales (K4b/K4c, one kernel for the function of both); activations in
// bfloat16 or float32.
//
// Replaces faster_whisper_tpu/ops/beam_attention.py::_cross_kernel_raw
// (K4a), ::_cross_kernel_quant (K4b, whole T) and ::_cross_kernel_quant_flash
// (K4c, T-blocked online softmax), all launched by cross_attend.
// Semantics (shared with the plain PyTorch version cross_attend_ref beside
// the wrapper, which computes the JAX decode step's unfused branch):
//
//   * the caches are (L, B, H, T, D), the int8 scales (L, B, H, 1, T) in
//     bf16; the layer is addressed by index, nothing is copied per layer;
//   * score[k, t] = (q[k] . K[t]) * d_scale in f32, times the K scale of t
//     on the int8 cache (codes dequantized in registers);
//   * softmax over t in f32; on the int8 cache the V scale of t is folded
//     into the weight of t; PV accumulates in f32; the output is in q's
//     dtype.  The weights stay f32 (the plain version rounds them to q's
//     dtype before PV: at bf16 the two agree to the bf16 tolerance, at f32
//     there is no rounding).
//
// What bounds it on an H100: bytes.  One (b, h) reads T*D*2 B of K and of V
// (bf16), T*D*4 B (f32) or T*D B plus 2*T B of scales (int8), and does
// 4*K*T*D FLOP: about 2.5 FLOP/B at K=5 in bf16, far below the card's
// 295 FLOP/B ridge.
//
// What the design does about it: the launch splits T so that enough blocks
// stream the cache at once.  Block (chunk, b*H + h) owns `chunk` columns
// (ops/cross_attention.py::_split_plan: 80 columns for every B, H and
// card, 19 chunks at T=1500, 380 blocks at B=1, H=20 and 3040 at B=8, so
// that a row's partials merge in one order in any batch and in a slice of
// its heads).  It brings its K and V rows into shared memory with
// 16-byte cp.async copies in two groups, so the V copy lands while the
// scores are computed; rows are padded by 16 bytes so that the score pass,
// one thread per column reading its whole row, is free of bank conflicts.
// Each block keeps the chunk's max m, sum l and K x D PV sums o in f32
// (the int8 V scales folded into the weights) and writes them to scratch.
// The block that finishes a (b, h) last, found by a __threadfence and an
// atomic ticket per (b, h), merges the chunks in chunk order (never in the
// order they arrived) with exp(m_i - M) rescaling,
// writes the output and sets the ticket back to 0 for the next call: one
// launch per call.  Plain FMA, no tensor cores (K <= 16 rows per (b, h)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int K4_THREADS = 128;
constexpr int K4_MAXK = 16;       // most queries per (b, h)
constexpr int K4_MAX_CHUNK = 128; // one column per thread in the score pass

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// The values of one 16-byte piece of a cache row.
__device__ __forceinline__ void piece_values(const __nv_bfloat16* src, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(pr[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

__device__ __forceinline__ void piece_values(const int8_t* src, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* pr = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 16; ++e) f[e] = (float)pr[e];
}

__device__ __forceinline__ void piece_values(const float* src, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename CacheT, int D>
__host__ __device__ constexpr int row_bytes() {
  return D * (int)sizeof(CacheT) + 16;  // padded shared row
}

template <typename CacheT, int D>
int smem_bytes(int K, int chunk, int n_chunks) {
  constexpr int kSplit = K4_THREADS / (D / 2);
  return 2 * chunk * row_bytes<CacheT, D>() +
         (int)sizeof(float) * (K * D + K * chunk + kSplit * K * D + 2 * chunk + 2 * K +
                               n_chunks * K);
}

// Stores four outputs (16-byte aligned for float, 8-byte for bf16).
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// ActT is the activation type (q and the output): __nv_bfloat16 or float.
// CacheT is ActT (the raw cache) or int8_t (then k_scale/v_scale are the
// (L, B, H, 1, T) bf16 scales, else unused).  D is the head dim, KM a bound
// on the beam count K held in registers.
template <typename ActT, typename CacheT, int D, int KM>
__global__ void __launch_bounds__(K4_THREADS) cross_attend_kernel(
    const ActT* __restrict__ q,                 // (B, H, K, D)
    const CacheT* __restrict__ k_cache,         // (L, B, H, T, D)
    const __nv_bfloat16* __restrict__ k_scale,  // (L, B, H, 1, T), int8 only
    const CacheT* __restrict__ v_cache,         // (L, B, H, T, D)
    const __nv_bfloat16* __restrict__ v_scale,  // (L, B, H, 1, T), int8 only
    ActT* __restrict__ out,                     // (B, H, K, D)
    float* part_o,                              // (B*H, n_chunks, K, D) scratch
    float* part_ml,                             // (B*H, n_chunks, K, 2) scratch
    int* tickets,                               // (B*H,), 0 between calls
    int B, int H, int K, int T, int layer, int chunk, float d_scale) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int kVec = 16 / sizeof(CacheT);  // values per 16-byte piece
  constexpr int kPieces = D / kVec;          // pieces per row
  constexpr int kRow = row_bytes<CacheT, D>();
  constexpr int D2 = D / 2;
  constexpr int kSplit = K4_THREADS / D2;    // PV column ranges
  extern __shared__ float4 smem4[];
  uint8_t* ks = reinterpret_cast<uint8_t*>(smem4);  // chunk padded K rows
  uint8_t* vs = ks + chunk * kRow;                  // chunk padded V rows
  float* qf = reinterpret_cast<float*>(vs + chunk * kRow);  // K*D queries in f32
  float* w = qf + K * D;                 // K*chunk   scores, then weights
  float* part = w + K * chunk;           // kSplit*K*D   PV sums per column range
  float* ksc = part + kSplit * K * D;    // chunk   int8: K scales
  float* vsc = ksc + chunk;              // chunk   int8: V scales
  float* ml = vsc + chunk;               // 2*K     chunk max and sum; then M, 1/L
  float* cw = ml + 2 * K;                // n_chunks*K   merge: weight of chunk c for query k
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ci = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int bh = blockIdx.y;  // b * H + h
  const int t0 = ci * chunk;
  const int n = min(chunk, T - t0);  // >= 1: the plan leaves no chunk empty
  const size_t srow = ((size_t)layer * B * H + bh) * (size_t)T + t0;  // scale row
  const CacheT* kc = k_cache + srow * D;
  const CacheT* vc = v_cache + srow * D;

  // Two copy groups: this chunk's K rows, then its V rows.
  for (int i = tid; i < n * kPieces; i += K4_THREADS) {
    const int r = i / kPieces, c = i % kPieces;
    cp_async16(ks + r * kRow + c * 16, kc + (size_t)r * D + c * kVec);
  }
  cp_async_commit();
  for (int i = tid; i < n * kPieces; i += K4_THREADS) {
    const int r = i / kPieces, c = i % kPieces;
    cp_async16(vs + r * kRow + c * 16, vc + (size_t)r * D + c * kVec);
  }
  cp_async_commit();
  for (int i = tid; i < K * D; i += K4_THREADS) qf[i] = to_f32(q[(size_t)bh * K * D + i]);
  if constexpr (kQuant) {
    for (int c = tid; c < n; c += K4_THREADS) {
      ksc[c] = __bfloat162float(k_scale[srow + c]);
      vsc[c] = __bfloat162float(v_scale[srow + c]);
    }
  }
  cp_async_wait<1>();  // this thread's K pieces
  __syncthreads();

  // Scores: thread tid owns column tid and reads its whole row.
  if (tid < n) {
    float acc[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) acc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      float f[kVec];
      piece_values(reinterpret_cast<const CacheT*>(ks + tid * kRow + i * 16), f);
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
        if constexpr (kQuant) s *= ksc[tid];
        w[k * chunk + tid] = s;
      }
    }
  }
  __syncthreads();

  // The chunk's softmax, one warp per query: max, exp, sum; weights times
  // the V scale on the int8 cache.
  for (int k = warp; k < K; k += K4_THREADS / 32) {
    float* wk = w + k * chunk;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, wk[c]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(wk[c] - mx);
      sum += e;
      if constexpr (kQuant) {
        wk[c] = e * vsc[c];
      } else {
        wk[c] = e;
      }
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ml[2 * k] = mx;
      ml[2 * k + 1] = sum;
    }
  }
  cp_async_wait<0>();  // this thread's V pieces
  __syncthreads();

  // PV: thread (sp, d2) sums columns [sp*span, (sp+1)*span) for a pair of D,
  // all K queries at once; V pairs are coalesced along D within a row.
  {
    const int sp = tid / D2;
    const int d2 = tid % D2;
    const int span = (n + kSplit - 1) / kSplit;
    const int c_end = min(n, (sp + 1) * span);
    float ax[KM], ay[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) ax[k] = ay[k] = 0.f;
#pragma unroll 4
    for (int c = sp * span; c < c_end; ++c) {
      const float2 v = load_pair(reinterpret_cast<const CacheT*>(vs + c * kRow) + 2 * d2);
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        if (k < K) {
          const float wt = w[k * chunk + c];
          ax[k] += wt * v.x;
          ay[k] += wt * v.y;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        part[(sp * K + k) * D + 2 * d2] = ax[k];
        part[(sp * K + k) * D + 2 * d2 + 1] = ay[k];
      }
    }
  }
  __syncthreads();

  // This chunk's (m, l, o) to scratch, then the ticket.
  float* po = part_o + ((size_t)bh * n_chunks + ci) * K * D;
  float* pm = part_ml + ((size_t)bh * n_chunks + ci) * K * 2;
  for (int i = tid; i < K * D; i += K4_THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) acc += part[s * K * D + i];
    po[i] = acc;
  }
  for (int i = tid; i < 2 * K; i += K4_THREADS) pm[i] = ml[i];
  __threadfence();  // this thread's partials are visible before the ticket
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + bh, 1) == n_chunks - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block of this (b, h) merges every chunk:
  // out = sum_c e_c o_c / sum_c e_c l_c with e_c = exp(m_c - max_j m_j).
  __threadfence();
  const float2* all_ml = reinterpret_cast<const float2*>(part_ml) + (size_t)bh * n_chunks * K;
  // Per query, one warp: M and L = sum_c exp(m_c - M) l_c, each lane over
  // its chunks with an online rescale, then across the lanes.
  for (int k = warp; k < K; k += K4_THREADS / 32) {
    float m = -INFINITY, l = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const float2 x = __ldcg(all_ml + c * K + k);  // (m_c, l_c), m_c finite
      const float mn = fmaxf(m, x.x);
      l = l * expf(m - mn) + x.y * expf(x.x - mn);
      m = mn;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const float lo = __shfl_xor_sync(0xffffffffu, l, o);
      const float mn = fmaxf(m, mo);
      // A lane without chunks holds (-inf, 0) and adds nothing.
      l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
      m = mn;
    }
    if (lane == 0) {
      ml[2 * k] = m;
      ml[2 * k + 1] = 1.f / l;
    }
  }
  __syncthreads();
  for (int i = tid; i < n_chunks * K; i += K4_THREADS) {
    const int k = i % K;
    cw[i] = expf(__ldcg(all_ml + i).x - ml[2 * k]) * ml[2 * k + 1];
  }
  __syncthreads();
  // Four outputs per thread, the chunks' partial sums read 16 bytes at a
  // time, several in flight.
  const float4* all_o = reinterpret_cast<const float4*>(part_o) + (size_t)bh * n_chunks * K * D / 4;
  for (int i4 = tid; i4 < K * D / 4; i4 += K4_THREADS) {
    const int k = 4 * i4 / D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < n_chunks; ++c) {
      const float4 x = __ldcg(all_o + (size_t)c * K * D / 4 + i4);
      const float e = cw[c * K + k];
      acc.x += e * x.x;
      acc.y += e * x.y;
      acc.z += e * x.z;
      acc.w += e * x.w;
    }
    store4(out + (size_t)bh * K * D + 4 * i4, acc);
  }
  if (tid == 0) tickets[bh] = 0;  // ready for the next call
}

template <typename ActT, typename CacheT, int D, int KM>
int launch_d(const void* q, const void* k_cache, const void* k_scale, const void* v_cache,
             const void* v_scale, void* out, void* part_o, void* part_ml, void* tickets, int B,
             int H, int K, int T, int layer, int chunk, float d_scale, cudaStream_t stream) {
  const int n_chunks = (T + chunk - 1) / chunk;
  const int smem = smem_bytes<CacheT, D>(K, chunk, n_chunks);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cross_attend_kernel<ActT, CacheT, D, KM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_chunks, B * H);
  cross_attend_kernel<ActT, CacheT, D, KM><<<grid, K4_THREADS, smem, stream>>>(
      (const ActT*)q, (const CacheT*)k_cache, (const __nv_bfloat16*)k_scale,
      (const CacheT*)v_cache, (const __nv_bfloat16*)v_scale, (ActT*)out, (float*)part_o,
      (float*)part_ml, (int*)tickets, B, H, K, T, layer, chunk, d_scale);
  return (int)cudaGetLastError();
}

// Every Whisper size has a head dim of 64, the only one built.  The beam
// count picks the register bound: greedy (1), the default beam and best_of
// (5), then 8 and K4_MAXK.
template <typename ActT, typename CacheT>
int launch(const void* q, const void* k_cache, const void* k_scale, const void* v_cache,
           const void* v_scale, void* out, void* part_o, void* part_ml, void* tickets, int B,
           int H, int K, int T, int D, int layer, int chunk, float d_scale, void* stream) {
  // The wrapper checks 1 <= K <= K4_MAXK, D == 64 and the chunk.
  if (K < 1 || K > K4_MAXK || D != 64 || chunk < 1 || chunk > K4_MAX_CHUNK || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define K4_LAUNCH(KM)                                                                       \
  launch_d<ActT, CacheT, 64, KM>(q, k_cache, k_scale, v_cache, v_scale, out, part_o, part_ml, \
                                 tickets, B, H, K, T, layer, chunk, d_scale, st)
  if (K == 1) return K4_LAUNCH(1);
  if (K <= 5) return K4_LAUNCH(5);
  if (K <= 8) return K4_LAUNCH(8);
  return K4_LAUNCH(K4_MAXK);
#undef K4_LAUNCH
}

}  // namespace

extern "C" int fwt_cross_attend_bf16(const void* q, const void* k_cache, const void* v_cache,
                                     void* out, void* part_o, void* part_ml, void* tickets, int B,
                                     int H, int K, int T, int D, int layer, int chunk,
                                     float d_scale, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k_cache, nullptr, v_cache, nullptr, out, part_o,
                                              part_ml, tickets, B, H, K, T, D, layer, chunk,
                                              d_scale, stream);
}

extern "C" int fwt_cross_attend_f32(const void* q, const void* k_cache, const void* v_cache,
                                    void* out, void* part_o, void* part_ml, void* tickets, int B,
                                    int H, int K, int T, int D, int layer, int chunk,
                                    float d_scale, void* stream) {
  return launch<float, float>(q, k_cache, nullptr, v_cache, nullptr, out, part_o, part_ml,
                              tickets, B, H, K, T, D, layer, chunk, d_scale, stream);
}

extern "C" int fwt_cross_attend_int8(const void* q, const void* k_codes, const void* k_scale,
                                     const void* v_codes, const void* v_scale, void* out,
                                     void* part_o, void* part_ml, void* tickets, int B, int H,
                                     int K, int T, int D, int layer, int chunk, float d_scale,
                                     void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k_codes, k_scale, v_codes, v_scale, out, part_o,
                                       part_ml, tickets, B, H, K, T, D, layer, chunk, d_scale,
                                       stream);
}

extern "C" int fwt_cross_attend_int8_f32(const void* q, const void* k_codes, const void* k_scale,
                                         const void* v_codes, const void* v_scale, void* out,
                                         void* part_o, void* part_ml, void* tickets, int B, int H,
                                         int K, int T, int D, int layer, int chunk,
                                         float d_scale, void* stream) {
  return launch<float, int8_t>(q, k_codes, k_scale, v_codes, v_scale, out, part_o, part_ml,
                               tickets, B, H, K, T, D, layer, chunk, d_scale, stream);
}
