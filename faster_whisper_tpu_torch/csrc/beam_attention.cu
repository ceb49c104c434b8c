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
//     scores and softmax are f32, PV accumulates in f32 and the output is
//     in the activation type.  The weights stay f32 through PV (the plain
//     version rounds them to the activation type first: in bf16 the two
//     agree to the bf16 tolerance, in float32 nothing is rounded).
//
// K2 only: the int8 cache holds codes (L, B, H, K, ctx, D) and bf16 scales
// (L, B, H, K, ctx), in float32 runs too, as the JAX package stores them.
// The new K/V row of each (beam, head) is quantized with
// s = max(max|x| * (1/127), 1e-10) and code = clamp(rint(x / s), -127, 127),
// and s is stored rounded to bf16.  These are the plain version's float32
// operations (ops/quant.py::quantize_kv): the scale is a product by the
// float32 reciprocal, as XLA compiles the JAX package's max|x| / 127, the
// code a true division, rint rounds half to even as torch.round does.
// Attention dequantizes in registers: a score is (q . codes) * bf16 scale,
// and the V scale is folded into the weight.  The new column enters with
// the bf16-rounded scale the plain version reads back from the cache (the
// TPU kernel used the unrounded one).  Unlike the TPU kernel, q and the
// weights are not quantized: the TPU did that for the MXU's s8 path, and
// the plain version does not.
//
// What bounds them on an H100: bytes.  Per (b, h) a step reads each
// distinct (slot, column) cache row that some query sees, at most
// K*(pos+1) rows of K and of V, D*2 B each for K1 in bf16 and D B plus a
// 2 B scale for K2, and does ~4*K*(pos+1)*D FLOP, far below the card's
// 295 FLOP/B ridge.  At B=1 one block per (b, h) would leave 112 of the
// 132 SMs idle.
//
// What the design does about it: the launch splits the columns.  Block
// (chunk, b*H + h) owns `chunk` columns (ops/beam_attention.py::_split_plan
// picks the chunk from K and the row size alone: 32 columns at K=5, 14
// chunks at ctx=448, 280 blocks at B=1, H=20 and 2240 at B=8).  It never
// depends on B, H, the SM count, ctx or pos, so a row's chunks, and with
// them the order in which its partials merge, are the same in any batch,
// in a slice of its heads, on any card and on every step of a decode.  A
// block whose chunk starts past pos exits at once, and the others count
// only the chunks that hold a visible column.  Each block:
//
//   1. reads its columns' ancestry and q (with pos, not after it), and
//      marks per column the slots that some query sees there;
//   2. copies each marked K and V row once into its slot in shared memory
//      (slot (j, c) for beam slot j at column c), with 16-byte cp.async in
//      two groups, neighbouring threads on neighbouring pieces of one slot's
//      consecutive columns; the V rows land while the scores are computed.
//      Under a shared ancestry a row serves every query that sees it and is
//      fetched once;
//   3. scores one thread per (query, column) from shared memory, 16 bytes at
//      a time (slots padded by 16 bytes, so that neighbouring lanes' reads
//      fall in different banks);
//   4. takes the chunk's softmax in f32 (max m, sum l, the int8 V scales
//      folded into the weights) and PV in f32 with 16-byte V reads;
//   5. writes (m, l, o) to scratch; the block that finishes a (b, h) last,
//      found by a __threadfence and an atomic ticket per (b, h), merges the
//      chunks with exp(m_i - M) rescaling, reading them in chunk order
//      (never in the order they arrived), writes the output in the
//      activation type and sets its ticket back to 0 for the next call.
//
// Column pos comes from the new rows (copied, or quantized in shared
// memory on the int8 cache) and never from device memory; the block that
// owns column pos writes the append, so no block reads a column that any
// block writes.  Plain FMA, no tensor cores: at K=5 queries per (b, h) a
// matrix unit would idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int K1_THREADS = 128;
constexpr int K1_NWARPS = K1_THREADS / 32;
constexpr int K1_D = 64;          // head dim: every Whisper size
constexpr int K1_MAXK = 32;       // beams: one bit each in a 32-bit set
constexpr int K1_MAX_CHUNK = 64;  // columns per block

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The values of one 16-byte piece of a cache row: 8 bf16, 4 f32 or 16 int8
// (codes, unscaled).
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

// Stores four outputs (16-byte aligned for float, 8-byte for bf16).
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// The block's shared memory, carved in the order below (16-byte arrays
// first).  The host sizes it with the same function.  Row slot (j, c) of
// krow/vrow holds beam slot j's row at column c0 + c, kStride bytes apart;
// a slot that no query of the chunk sees is never filled.
struct Smem {
  float* qs;       // K*D          q * d_scale, rounded to the activation type
  uint8_t* krow;   // K*chunk      K row slots
  uint8_t* vrow;   // K*chunk      V row slots
  float* part;     // nsplit*K*D   PV sums per column range
  int8_t* newc;    // 2*K*D        K2: the new rows' codes (K, then V)
  float* w;        // K*chunk      scores, then weights, of query k at column c
  float* ksc;      // K*chunk      K2: the K scale of row slot (j, c)
  float* vsc;      // K*chunk      K2: the V scale of row slot (j, c)
  int* ancs;       // K*chunk      the slot query k sees at column c, -1 for none
  unsigned* need;  // chunk        the set of slots some query sees at column c
  float* nsc;      // 4*K          K2: new rows' scales, bf16-rounded (K, V), then unrounded (K, V)
  float* ml;       // 2*K          chunk max and sum; in the merge M and 1/L
  float* cw;       // n_chunks*K   merge: weight of chunk c for query k
  int* is_last;    // 1
};

// Bytes between row slots: a row and 16 bytes of padding, so that the 16-byte
// reads of one score pass (neighbouring lanes, neighbouring slots, the same
// piece) fall in different banks.
template <typename CacheT>
__host__ __device__ constexpr int row_stride() {
  return K1_D * (int)sizeof(CacheT) + 16;
}

__host__ __device__ inline int split_count(int K, int pieces) {
  const int items = K * pieces;
  return items >= K1_THREADS ? 1 : K1_THREADS / items;
}

// Reserves `bytes` at `off`, 16-byte aligned; returns where they start.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 15) & ~(size_t)15;
  return at;
}

// Fills `s` from the block's shared memory at `base` (if s is not null);
// returns the bytes needed.
template <typename CacheT>
__host__ __device__ inline size_t carve(uint8_t* base, int K, int chunk, int n_chunks, Smem* s) {
  const size_t R = (size_t)K * chunk;
  const int nsplit = split_count(K, K1_D * (int)sizeof(CacheT) / 16);
  size_t off = 0;
  const size_t qs = take(off, sizeof(float) * K * K1_D);
  const size_t krow = take(off, R * row_stride<CacheT>());
  const size_t vrow = take(off, R * row_stride<CacheT>());
  const size_t part = take(off, sizeof(float) * nsplit * K * K1_D);
  const size_t newc = take(off, 2 * K * K1_D);
  const size_t w = take(off, sizeof(float) * R);
  const size_t ksc = take(off, sizeof(float) * R);
  const size_t vsc = take(off, sizeof(float) * R);
  const size_t ancs = take(off, sizeof(int) * R);
  const size_t need = take(off, sizeof(unsigned) * chunk);
  const size_t nsc = take(off, sizeof(float) * 4 * K);
  const size_t ml = take(off, sizeof(float) * 2 * K);
  const size_t cw = take(off, sizeof(float) * n_chunks * K);
  const size_t is_last = take(off, sizeof(int));
  if (s != nullptr) {
    s->qs = reinterpret_cast<float*>(base + qs);
    s->krow = base + krow;
    s->vrow = base + vrow;
    s->part = reinterpret_cast<float*>(base + part);
    s->newc = reinterpret_cast<int8_t*>(base + newc);
    s->w = reinterpret_cast<float*>(base + w);
    s->ksc = reinterpret_cast<float*>(base + ksc);
    s->vsc = reinterpret_cast<float*>(base + vsc);
    s->ancs = reinterpret_cast<int*>(base + ancs);
    s->need = reinterpret_cast<unsigned*>(base + need);
    s->nsc = reinterpret_cast<float*>(base + nsc);
    s->ml = reinterpret_cast<float*>(base + ml);
    s->cw = reinterpret_cast<float*>(base + cw);
    s->is_last = reinterpret_cast<int*>(base + is_last);
  }
  return off;
}

// ActT is the activation type, __nv_bfloat16 or float.  CacheT is ActT (K1)
// or int8_t (K2; then k_scale/v_scale are the (L, B, H, K, ctx) bf16
// scales, else unused).
template <typename ActT, typename CacheT>
__global__ void __launch_bounds__(K1_THREADS) beam_attend_append_kernel(
    const ActT* __restrict__ q,      // (B, H, K, D)
    const ActT* __restrict__ k_new,  // (B, H, K, D)
    const ActT* __restrict__ v_new,  // (B, H, K, D)
    CacheT* k_cache,                 // (L, B, H, K, ctx, D)
    __nv_bfloat16* k_scale,          // (L, B, H, K, ctx), K2 only
    CacheT* v_cache,                 // (L, B, H, K, ctx, D)
    __nv_bfloat16* v_scale,          // (L, B, H, K, ctx), K2 only
    const int* __restrict__ anc,     // (B, K, ctx)
    const int* __restrict__ pos_row, // (B,)
    ActT* __restrict__ out,          // (B, H, K, D)
    float* part_o,                   // (B*H, n_chunks, K, D) scratch
    float* part_ml,                  // (B*H, n_chunks, K, 2) scratch
    int* tickets,                    // (B*H,), 0 between calls
    int B, int H, int K, int ctx, int layer, int chunk, float d_scale) {
  constexpr bool kQuant = std::is_same<CacheT, int8_t>::value;
  constexpr int D = K1_D;
  constexpr int kStride = row_stride<CacheT>();
  constexpr int kVec = 16 / (int)sizeof(CacheT);  // values per 16-byte piece
  constexpr int kPieces = D / kVec;               // pieces per row
  // Rounds to the activation type where the plain version casts to it.
  auto act_round = [](float x) {
    if constexpr (std::is_same<ActT, float>::value) {
      return x;
    } else {
      return bf16_round(x);
    }
  };
  extern __shared__ float4 smem4[];
  const int n_chunks = gridDim.x;
  Smem sm;
  carve<CacheT>(reinterpret_cast<uint8_t*>(smem4), K, chunk, n_chunks, &sm);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ci = blockIdx.x;
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int c0 = ci * chunk;
  const int ccols = min(chunk, ctx - c0);  // the chunk's columns, visible or not
  const size_t row0 = (size_t)bh * K;                                    // (b, h, slot 0) in (B,H,K)
  const size_t srow0 = ((size_t)layer * B * H + bh) * (size_t)K * ctx;  // scale row of slot 0
  const size_t cache0 = srow0 * D;
  const int* anc_b = anc + (size_t)b * K * ctx;

  // 1. The chunk's ancestry and q, which do not wait for pos; then pos.
  for (int i = tid; i < K * ccols; i += K1_THREADS) {
    const int k = i / ccols, c = i - k * ccols;
    const int j = anc_b[(size_t)k * ctx + c0 + c];
    sm.ancs[k * chunk + c] = (unsigned)j < (unsigned)K ? j : -1;
  }
  for (int i = tid; i < K * D; i += K1_THREADS) sm.qs[i] = act_round(to_f32(q[row0 * D + i]) * d_scale);
  // The caller guarantees 0 <= pos < ctx; clamp so that a bad value can
  // never address memory outside the cache.
  const int pos = min(max(pos_row[b], 0), ctx - 1);
  if (c0 > pos) return;  // no visible column: the other blocks count without this one
  const int n_active = pos / chunk + 1;       // chunks with a visible column
  const int ncol = min(chunk, pos + 1 - c0);  // this chunk's visible columns
  const bool owner = pos < c0 + chunk;        // holds column pos: quantizes and appends
  if constexpr (kQuant) {
    // The new rows' scales, one warp per row, from max|x| over D.
    if (owner) {
      for (int j = warp; j < 2 * K; j += K1_NWARPS) {
        const ActT* src = (j < K ? k_new : v_new) + (row0 + j % K) * D;
        float m = 0.f;
        for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(to_f32(src[d])));
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) {
          const float s = fmaxf(m * (1.f / 127.f), 1e-10f);
          sm.nsc[2 * K + j] = s;      // unrounded, for the codes
          sm.nsc[j] = bf16_round(s);  // as the cache stores it
        }
      }
    }
  }
  __syncthreads();

  // 2. The slots each visible column needs; the owner writes the append
  // (K2: the codes, kept for the slots of column pos).
  for (int c = tid; c < ncol; c += K1_THREADS) {
    unsigned need = 0;
    for (int k = 0; k < K; ++k) {
      const int j = sm.ancs[k * chunk + c];
      if (j >= 0) need |= 1u << j;
    }
    sm.need[c] = need;
  }
  if (owner) {
    for (int i = tid; i < K * D; i += K1_THREADS) {
      const int j = i / D;
      const size_t off = cache0 + ((size_t)j * ctx + pos) * D + (i - j * D);
      if constexpr (kQuant) {
        const int8_t kc = (int8_t)(int)fminf(fmaxf(rintf(to_f32(k_new[row0 * D + i]) / sm.nsc[2 * K + j]), -127.f), 127.f);
        const int8_t vc = (int8_t)(int)fminf(fmaxf(rintf(to_f32(v_new[row0 * D + i]) / sm.nsc[3 * K + j]), -127.f), 127.f);
        sm.newc[i] = kc;
        sm.newc[K * D + i] = vc;
        k_cache[off] = kc;
        v_cache[off] = vc;
      } else {
        k_cache[off] = k_new[row0 * D + i];
        v_cache[off] = v_new[row0 * D + i];
      }
    }
    if constexpr (kQuant) {
      for (int j = tid; j < K; j += K1_THREADS) {
        k_scale[srow0 + (size_t)j * ctx + pos] = __float2bfloat16(sm.nsc[j]);
        v_scale[srow0 + (size_t)j * ctx + pos] = __float2bfloat16(sm.nsc[K + j]);
      }
    }
  }
  __syncthreads();

  // 3. Each needed row once into its slot: the K rows, then the V rows, as
  // two copy groups; neighbouring threads copy neighbouring 16-byte pieces
  // of one slot's consecutive columns.  Column pos from the new rows.
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const CacheT* cache = kv ? v_cache : k_cache;
    uint8_t* rows = kv ? sm.vrow : sm.krow;
    for (int i = tid; i < K * ncol * kPieces; i += K1_THREADS) {
      const int p = i % kPieces;
      const int jc = i / kPieces;
      const int j = jc / ncol, c = jc - j * ncol;
      if (!((sm.need[c] >> j) & 1u)) continue;
      uint8_t* dst = rows + (j * chunk + c) * kStride + p * 16;
      if (c0 + c == pos) {
        if constexpr (kQuant) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(sm.newc + kv * K * D + j * D + p * kVec);
        } else {
          cp_async16(dst, (kv ? v_new : k_new) + (row0 + j) * D + p * kVec);
        }
      } else {
        cp_async16(dst, cache + cache0 + ((size_t)j * ctx + c0 + c) * D + p * kVec);
      }
    }
    cp_async_commit();
  }
  if constexpr (kQuant) {
    for (int i = tid; i < K * ncol; i += K1_THREADS) {
      const int j = i / ncol, c = i - j * ncol;
      if (!((sm.need[c] >> j) & 1u)) continue;
      const size_t si = srow0 + (size_t)j * ctx + c0 + c;
      sm.ksc[j * chunk + c] = c0 + c == pos ? sm.nsc[j] : __bfloat162float(k_scale[si]);
      sm.vsc[j * chunk + c] = c0 + c == pos ? sm.nsc[K + j] : __bfloat162float(v_scale[si]);
    }
  }
  cp_async_wait<1>();  // this thread's K pieces
  __syncthreads();

  // 4a. Scores, one thread per (query, column): the dot of q with the slot
  // the query sees there, read from shared memory 16 bytes at a time.
  for (int i = tid; i < K * ncol; i += K1_THREADS) {
    const int k = i / ncol, c = i - k * ncol;
    const int j = sm.ancs[k * chunk + c];
    float s = -INFINITY;
    if (j >= 0) {
      const uint8_t* row = sm.krow + (j * chunk + c) * kStride;
      const float4* q4 = reinterpret_cast<const float4*>(sm.qs + k * D);
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        float f[kVec];
        piece_values(reinterpret_cast<const CacheT*>(row + p * 16), f);
#pragma unroll
        for (int e4 = 0; e4 < kVec / 4; ++e4) {
          const float4 qq = q4[p * kVec / 4 + e4];
          acc += qq.x * f[4 * e4];
          acc += qq.y * f[4 * e4 + 1];
          acc += qq.z * f[4 * e4 + 2];
          acc += qq.w * f[4 * e4 + 3];
        }
      }
      s = acc;
      if constexpr (kQuant) s *= sm.ksc[j * chunk + c];
    }
    sm.w[k * chunk + c] = s;
  }
  __syncthreads();

  // 4b. The chunk's softmax, one warp per query: max, exp, sum; on the int8
  // cache the weights times the V scale of the row they weigh.
  for (int k = warp; k < K; k += K1_NWARPS) {
    float* wk = sm.w + k * chunk;
    float mx = -INFINITY;
    for (int c = lane; c < ncol; c += 32) mx = fmaxf(mx, wk[c]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float e = mx == -INFINITY ? 0.f : expf(wk[c] - mx);
      sum += e;
      if constexpr (kQuant) {
        const int j = sm.ancs[k * chunk + c];
        wk[c] = j < 0 ? 0.f : e * sm.vsc[j * chunk + c];
      } else {
        wk[c] = e;
      }
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      sm.ml[2 * k] = mx;
      sm.ml[2 * k + 1] = sum;
    }
  }
  cp_async_wait<0>();  // this thread's V pieces
  __syncthreads();

  // 4c. PV: thread item (column range sp, query k, piece p) sums its
  // columns' weighted V pieces, 16-byte reads of the slot each column's
  // query sees.
  {
    const int items = K * kPieces;
    const int nsplit = split_count(K, kPieces);
    const int span = (ncol + nsplit - 1) / nsplit;
    for (int it = tid; it < nsplit * items; it += K1_THREADS) {
      const int p = it % kPieces;
      const int k = (it / kPieces) % K;
      const int sp = it / items;
      const int cb = sp * span, ce = min(ncol, cb + span);
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
      // Not unrolled: unrolled by 4, this loop faulted with an illegal
      // instruction on the card whenever a range held 1 mod 4 columns.
#pragma unroll 1
      for (int c = cb; c < ce; ++c) {
        const int j = sm.ancs[k * chunk + c];
        if (j < 0) continue;
        const float wt = sm.w[k * chunk + c];
        float f[kVec];
        piece_values(reinterpret_cast<const CacheT*>(sm.vrow + (j * chunk + c) * kStride + p * 16), f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += wt * f[e];
      }
      float* dst = sm.part + (sp * K + k) * D + p * kVec;
#pragma unroll
      for (int e4 = 0; e4 < kVec / 4; ++e4)
        *reinterpret_cast<float4*>(dst + 4 * e4) =
            make_float4(acc[4 * e4], acc[4 * e4 + 1], acc[4 * e4 + 2], acc[4 * e4 + 3]);
    }
  }
  __syncthreads();

  // 5. This chunk's (m, l, o) to scratch, then the ticket.
  {
    const int nsplit = split_count(K, kPieces);
    float* po = part_o + ((size_t)bh * n_chunks + ci) * K * D;
    float* pm = part_ml + ((size_t)bh * n_chunks + ci) * K * 2;
    for (int i = tid; i < K * D; i += K1_THREADS) {
      float acc = 0.f;
      for (int s = 0; s < nsplit; ++s) acc += sm.part[s * K * D + i];
      po[i] = acc;
    }
    for (int i = tid; i < 2 * K; i += K1_THREADS) pm[i] = sm.ml[i];
  }
  __threadfence();  // this thread's partials are visible before the ticket
  __syncthreads();
  if (tid == 0) *sm.is_last = atomicAdd(tickets + bh, 1) == n_active - 1;
  __syncthreads();
  if (!*sm.is_last) return;

  // The last block of this (b, h) merges the active chunks:
  // out = sum_c e_c o_c / sum_c e_c l_c with e_c = exp(m_c - max_j m_j).
  __threadfence();
  const float2* all_ml = reinterpret_cast<const float2*>(part_ml) + (size_t)bh * n_chunks * K;
  for (int k = warp; k < K; k += K1_NWARPS) {
    float m = -INFINITY, l = 0.f;
    for (int c = lane; c < n_active; c += 32) {
      const float2 x = __ldcg(all_ml + c * K + k);  // (m_c, l_c)
      if (x.x == -INFINITY) continue;  // a chunk that sees nothing adds nothing
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
      sm.ml[2 * k] = m;
      sm.ml[2 * k + 1] = 1.f / l;
    }
  }
  __syncthreads();
  for (int i = tid; i < n_active * K; i += K1_THREADS) {
    const int k = i % K;
    const float mc = __ldcg(all_ml + i).x;
    sm.cw[i] = mc == -INFINITY ? 0.f : expf(mc - sm.ml[2 * k]) * sm.ml[2 * k + 1];
  }
  __syncthreads();
  // Four outputs per thread, the chunks' partial sums read 16 bytes at a
  // time, several in flight.
  const float4* all_o = reinterpret_cast<const float4*>(part_o) + (size_t)bh * n_chunks * K * D / 4;
  for (int i4 = tid; i4 < K * D / 4; i4 += K1_THREADS) {
    const int k = 4 * i4 / D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < n_active; ++c) {
      const float4 x = __ldcg(all_o + (size_t)c * K * D / 4 + i4);
      const float e = sm.cw[c * K + k];
      acc.x += e * x.x;
      acc.y += e * x.y;
      acc.z += e * x.z;
      acc.w += e * x.w;
    }
    store4(out + row0 * D + 4 * i4, acc);
  }
  if (tid == 0) tickets[bh] = 0;  // ready for the next call
}

template <typename ActT, typename CacheT>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* k_scale,
           void* v_cache, void* v_scale, const void* anc, const void* pos_row, void* out,
           void* part_o, void* part_ml, void* tickets, int B, int H, int K, int ctx, int D,
           int layer, int chunk, float d_scale, void* stream) {
  // The wrapper checks these and plans the chunk (ops/beam_attention.py).
  if (D != K1_D || K < 1 || K > K1_MAXK || chunk < 1 || chunk > K1_MAX_CHUNK || ctx < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (ctx + chunk - 1) / chunk;
  const int smem = (int)carve<CacheT>(nullptr, K, chunk, n_chunks, nullptr);
  // Past the card's shared memory per block, cudaFuncSetAttribute fails and
  // its error is returned.
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(beam_attend_append_kernel<ActT, CacheT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_chunks, B * H);
  beam_attend_append_kernel<ActT, CacheT><<<grid, K1_THREADS, smem, (cudaStream_t)stream>>>(
      (const ActT*)q, (const ActT*)k_new, (const ActT*)v_new, (CacheT*)k_cache,
      (__nv_bfloat16*)k_scale, (CacheT*)v_cache, (__nv_bfloat16*)v_scale, (const int*)anc,
      (const int*)pos_row, (ActT*)out, (float*)part_o, (float*)part_ml, (int*)tickets, B, H, K,
      ctx, layer, chunk, d_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fwt_beam_attend_append_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* anc, const void* pos_row, void* out, void* part_o, void* part_ml, void* tickets,
    int B, int H, int K, int ctx, int D, int layer, int chunk, float d_scale, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(q, k_new, v_new, k_cache, nullptr, v_cache, nullptr,
                                              anc, pos_row, out, part_o, part_ml, tickets, B, H, K,
                                              ctx, D, layer, chunk, d_scale, stream);
}

extern "C" int fwt_beam_attend_append_f32(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* anc, const void* pos_row, void* out, void* part_o, void* part_ml, void* tickets,
    int B, int H, int K, int ctx, int D, int layer, int chunk, float d_scale, void* stream) {
  return launch<float, float>(q, k_new, v_new, k_cache, nullptr, v_cache, nullptr, anc, pos_row,
                              out, part_o, part_ml, tickets, B, H, K, ctx, D, layer, chunk,
                              d_scale, stream);
}

extern "C" int fwt_beam_attend_append_int8(
    const void* q, const void* k_new, const void* v_new, void* k_codes, void* k_scale,
    void* v_codes, void* v_scale, const void* anc, const void* pos_row, void* out, void* part_o,
    void* part_ml, void* tickets, int B, int H, int K, int ctx, int D, int layer, int chunk,
    float d_scale, void* stream) {
  return launch<__nv_bfloat16, int8_t>(q, k_new, v_new, k_codes, k_scale, v_codes, v_scale, anc,
                                       pos_row, out, part_o, part_ml, tickets, B, H, K, ctx, D,
                                       layer, chunk, d_scale, stream);
}

extern "C" int fwt_beam_attend_append_int8_f32(
    const void* q, const void* k_new, const void* v_new, void* k_codes, void* k_scale,
    void* v_codes, void* v_scale, const void* anc, const void* pos_row, void* out, void* part_o,
    void* part_ml, void* tickets, int B, int H, int K, int ctx, int D, int layer, int chunk,
    float d_scale, void* stream) {
  return launch<float, int8_t>(q, k_new, v_new, k_codes, k_scale, v_codes, v_scale, anc, pos_row,
                               out, part_o, part_ml, tickets, B, H, K, ctx, D, layer, chunk,
                               d_scale, stream);
}
