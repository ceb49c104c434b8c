// P1 and P2: the kernel probes of the decode self-attention over the int8
// cache, on the s8 path of the TPU kernels.
//
// P1, fwt_attend_only_int8, replaces
// benchmarks/profile_call_anatomy.py::_attend_only_kernel: K2's attention
// (ops/beam_attention.py) with the append taken out.  P2b,
// fwt_scores_batched_int8, replaces
// benchmarks/profile_mosaic_micro.py::_batched_kernel and P2h,
// fwt_scores_perhead_int8, ::_perhead_kernel: the int8 QK scores of one
// layer summed over the slots and the columns, q head-major (B, H, K, D)
// with one scale per (h, k) row, or flat (B, K, H*D) with one scale per
// whole row, dotted per head slice.  Semantics (shared with the plain
// PyTorch versions beside the wrappers in ops/probes.py):
//
//   * a row of floats x is quantized with s = max(max|x| * (1/127), 1e-10)
//     (the float32 reciprocal, as XLA compiles the scripts' / 127.0) and
//     code = rint(x / s), clipped to [-127, 127] for q and not clipped for
//     P1's weights (their max over the row is 127 s);
//   * every s8 . s8 product is summed exactly in s32 (__dp4a, four byte
//     products at a time, where the bytes lie side by side), as the TPU's
//     MXU does;
//   * P1: q is scaled by D^-0.5 before its quantization; a score is
//     (dot * q_s) * k_scale; column c of query k is visible in slot
//     anc[b,k,c] when c <= pos[b] (every other (slot, column) pair is the
//     TPU kernel's -1e30, whose exponential is 0); one softmax over the
//     visible pairs; the weight (e / sum) * v_scale is quantized per
//     (k, slot) row over the columns; out = sum over slots in order of
//     float(PV dot) * p_s, rounded to bf16.  Products and sums that feed a
//     code use __fmul_rn/__fdiv_rn/__fadd_rn, so that no FMA contraction
//     moves a code off the plain version's.
//
// What bounds them on an H100: bytes.  At the probe shape (B=8, H=20, K=5,
// ctx=192, D=64) one call of P1 reads the visible K and V rows (13.0 MB
// with the scales at pos 120), of P2 every K row (9.9 MB), and does at most
// 2*K*K*ctx*D s8 products per (b, h), far below the card's ridge.
//
// What the designs do about it.
//
// P1: a thread-block cluster per (b, h) splits its columns.  The cluster
// size comes from ctx alone (p1_cluster_size: 4 CTAs of 48 columns at
// ctx=192, 640 CTAs of 128 threads at the probe shape), never from B or H.
// Each CTA scores its own columns (one thread per (query, column), the
// row's 64 bytes in four 16-byte loads and 16 __dp4a), and the row-wide
// values meet in distributed shared memory, each CTA reading the others'
// after a cluster barrier: each query's softmax max; each query's
// denominator, summed over the ranks in rank order, so that every CTA
// holds the same bits; the per-(query, slot) weight maxima (a max does
// not depend on order).  Each CTA then quantizes its own weights and sums
// its columns' PV in s32 per (query, slot, d): a thread owns one query, 16
// values of d and a range of columns, reads one column's V row 16 bytes at
// a time, and adds its sums into shared memory with integer atomics when
// the column's slot changes.  (PV sums over columns, whose bytes lie a row
// apart: a __dp4a would first need four rows' bytes transposed.)  The
// s32 sums meet exactly across the cluster (their order does not matter);
// each output (query, d) is read from every rank, scaled by the weights'
// scales slot by slot in order, and written by one thread of the cluster.
//
// P2b: one block of 512 threads per (b, h), 160 blocks at the probe shape;
// every row is read with four 16-byte loads by one thread, which holds the
// row's dots for all K queries in registers.
//
// P2h: one thread-block cluster of 8 CTAs (512 threads each) per batch row
// b, whatever B and H are: the row's H*K*ctx K rows are split evenly over
// the CTAs in head order, so a CTA's rows span at most a few heads (up to 4
// at the probe shape).  The row's scale couples all of its heads: each CTA reads an
// eighth of the flat q rows with 16-byte loads, issued first, and their
// max meets in distributed shared memory, so the flat row is read once; the
// CTA then codes the slices of the heads its rows span.  Its first two K
// rows per thread are in flight meanwhile.  The CTAs' int64 sums meet in
// rank 0's shared memory, exact in any order, and rank 0 scales the row's
// sum once: no global atomic, ticket or buffer between calls.  On an
// NVIDIA H100 80GB HBM3 at 700 W this design, its variants in
// tools/probe_variants.py (other cluster sizes and thread counts) and one
// with clusters of heads and a global atomic and ticket per row were all
// slower than P2b for the same bytes (PERF.md section 6): a CTA of P2h
// cannot code a row before the whole flat row's max is known.
//
// No tensor cores: a head's K=5 queries would leave a matrix unit mostly
// idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int PR_THREADS = 512;
constexpr int PR_NWARPS = PR_THREADS / 32;
constexpr int PR_D = 64;     // head dim: every Whisper size
constexpr int PR_MAXK = 8;   // beams (queries and slots) per (b, h)
constexpr float PR_RECIP_127 = 1.0f / 127.0f;
constexpr float PR_MIN_SCALE = 1e-10f;
constexpr float PR_NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ long long warp_sum64(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(__fmul_rn(amax, PR_RECIP_127), PR_MIN_SCALE);
}

__device__ __forceinline__ int8_t q_code(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// The s32 dot of a 64-byte row of codes in shared memory (16 words) with
// one in device memory (16-byte aligned).
__device__ __forceinline__ int dot64(const int* a, const int4* row) {
  int acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 v = __ldg(row + i);
    acc = __dp4a(a[4 * i], v.x, acc);
    acc = __dp4a(a[4 * i + 1], v.y, acc);
    acc = __dp4a(a[4 * i + 2], v.z, acc);
    acc = __dp4a(a[4 * i + 3], v.w, acc);
  }
  return acc;
}

// One warp quantizes q's row of 64 values (times `scale`) into `codes`
// (shared memory) and returns its scale; also to `out` when not null.
__device__ __forceinline__ float quant_row64(const __nv_bfloat16* src, float scale, int8_t* codes,
                                             int8_t* out, int lane) {
  const float x0 = __fmul_rn(__bfloat162float(src[lane]), scale);
  const float x1 = __fmul_rn(__bfloat162float(src[lane + 32]), scale);
  const float s = quant_scale(warp_max(fmaxf(fabsf(x0), fabsf(x1))));
  const int8_t c0 = q_code(x0, s), c1 = q_code(x1, s);
  codes[lane] = c0;
  codes[lane + 32] = c1;
  if (out != nullptr) {
    out[lane] = c0;
    out[lane + 32] = c1;
  }
  return s;
}

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

constexpr int P1_THREADS = 128;
constexpr int P1_NWARPS = P1_THREADS / 32;
constexpr int P1_COLS = 48;        // columns per CTA that the cluster size aims at
constexpr int P1_MAX_CLUSTER = 8;  // the portable cluster size

// CTAs per (b, h): from ctx alone.
inline int p1_cluster_size(int ctx) {
  const int cs = (ctx + P1_COLS - 1) / P1_COLS;
  return cs < 1 ? 1 : (cs > P1_MAX_CLUSTER ? P1_MAX_CLUSTER : cs);
}

// A CTA's shared memory, carved in the order below.  The first four arrays
// are read by the other CTAs of the cluster, at the same offsets in each.
struct P1Smem {
  float* mx;    // K      this CTA's score max per query
  float* lsum;  // K      this CTA's sum of exponentials per query
  float* pmax;  // K*K    this CTA's weight max per (k, slot), as bits
  int* pv;      // K*K*D  this CTA's s32 PV sums per (k, slot, d)
  int8_t* qc;   // K*D    q's codes
  float* qs;    // K      q's scales
  float* den;   // K      the row's softmax sums
  float* ps;    // K*K    the weights' scales
  float* sc;    // K*cw   scores, then exponentials, then weights
  int* sj;      // K*cw   the visible slot of (k, c), -1 if none
  int8_t* pc;   // K*cw   the weights' codes
};

__host__ __device__ inline size_t p1_carve(uint8_t* base, int K, int cw, P1Smem* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) / 16 * 16;
    return at;
  };
  const size_t mx = take(4 * K), lsum = take(4 * K), pmax = take(4 * K * K),
               pv = take(4 * (size_t)K * K * PR_D), qc = take((size_t)K * PR_D), qs = take(4 * K),
               den = take(4 * K), ps = take(4 * K * K), sc = take(4 * (size_t)K * cw),
               sj = take(4 * (size_t)K * cw), pc = take((size_t)K * cw);
  if (s != nullptr) {
    s->mx = reinterpret_cast<float*>(base + mx);
    s->lsum = reinterpret_cast<float*>(base + lsum);
    s->pmax = reinterpret_cast<float*>(base + pmax);
    s->pv = reinterpret_cast<int*>(base + pv);
    s->qc = reinterpret_cast<int8_t*>(base + qc);
    s->qs = reinterpret_cast<float*>(base + qs);
    s->den = reinterpret_cast<float*>(base + den);
    s->ps = reinterpret_cast<float*>(base + ps);
    s->sc = reinterpret_cast<float*>(base + sc);
    s->sj = reinterpret_cast<int*>(base + sj);
    s->pc = reinterpret_cast<int8_t*>(base + pc);
  }
  return off;
}

// Grid (cluster size, B*H), clusters of (cluster size, 1, 1): CTA `rank`
// of (b, h) owns columns [rank * cw, (rank + 1) * cw).  Every CTA reaches
// every cluster barrier, also one with no visible column.
__global__ void __launch_bounds__(P1_THREADS) attend_only_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, H, K, D)
    const int8_t* __restrict__ kq,          // (L, B, H, K, ctx, D)
    const __nv_bfloat16* __restrict__ ks,   // (L, B, H, K, ctx)
    const int8_t* __restrict__ vq,
    const __nv_bfloat16* __restrict__ vs,
    const int* __restrict__ anc,            // (B, K, ctx)
    const int* __restrict__ pos_row,        // (B,)
    __nv_bfloat16* __restrict__ out,        // (B, H, K, D)
    int8_t* __restrict__ q_codes,           // (B, H, K, D) or null
    int8_t* __restrict__ p_codes,           // (B, H, K, K, ctx) or null, zeroed by the caller
    int B, int H, int K, int ctx, int cw, int layer, float d_scale) {
  constexpr int D = PR_D;
  constexpr int kPieces = D / 16;  // 16-byte pieces of a row
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)gridDim.x;
  extern __shared__ float4 smem4[];
  P1Smem sm;
  p1_carve(reinterpret_cast<uint8_t*>(smem4), K, cw, &sm);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, b = bh / H;
  const size_t row0 = (size_t)bh * K;                                     // (b, h, 0) of (B, H, K)
  const size_t crow0 = ((size_t)layer * B * H + bh) * (size_t)K * ctx;  // (layer, b, h, 0, 0)
  const int n = min(max(pos_row[b], 0), ctx - 1) + 1;                    // visible columns
  const int c0 = rank * cw;
  const int ncol = max(0, min(cw, n - c0));  // this CTA's visible columns
  const int* anc_b = anc + (size_t)b * K * ctx + c0;

  // 1. q's codes and scales, one warp per row (rank 0 writes the codes
  //    out); the weights' maxima and the PV sums at 0.
  for (int k = warp; k < K; k += P1_NWARPS) {
    int8_t* qc_out = q_codes == nullptr || rank != 0 ? nullptr : q_codes + (row0 + k) * D;
    const float s = quant_row64(q + (row0 + k) * D, d_scale, sm.qc + k * D, qc_out, lane);
    if (lane == 0) sm.qs[k] = s;
  }
  for (int i = tid; i < K * K; i += P1_THREADS) sm.pmax[i] = 0.f;
  for (int i = tid; i < K * K * D; i += P1_THREADS) sm.pv[i] = 0;
  __syncthreads();

  // 2. One score per (query k, visible column c of this CTA), in the
  //    column's slot.
  const int* qc_words = reinterpret_cast<const int*>(sm.qc);
  for (int i = tid; i < K * ncol; i += P1_THREADS) {
    const int k = i / ncol, c = i - k * ncol;
    const int j = anc_b[(size_t)k * ctx + c];
    float s = PR_NEG_INF;
    int slot = -1;
    if ((unsigned)j < (unsigned)K) {
      const size_t r = crow0 + (size_t)j * ctx + c0 + c;
      const int dot = dot64(qc_words + k * (D / 4), reinterpret_cast<const int4*>(kq + r * D));
      s = __fmul_rn(__fmul_rn((float)dot, sm.qs[k]), __bfloat162float(ks[r]));
      slot = j;
    }
    sm.sc[k * cw + c] = s;
    sm.sj[k * cw + c] = slot;
  }
  __syncthreads();

  // 3. The softmax: this CTA's max per query, then the row's over the
  //    cluster; the exponentials in place and this CTA's sum per query.
  for (int k = warp; k < K; k += P1_NWARPS) {
    float m = -INFINITY;
    for (int c = lane; c < ncol; c += 32) m = fmaxf(m, sm.sc[k * cw + c]);
    m = warp_max(m);
    if (lane == 0) sm.mx[k] = m;
  }
  cluster.sync();
  for (int k = warp; k < K; k += P1_NWARPS) {
    float m = -INFINITY;
    for (int r = 0; r < cs; ++r) m = fmaxf(m, *cluster.map_shared_rank(sm.mx + k, r));
    float l = 0.f;
    for (int c = lane; c < ncol; c += 32) {
      const float e = expf(sm.sc[k * cw + c] - m);
      sm.sc[k * cw + c] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) sm.lsum[k] = l;
  }
  cluster.sync();

  // 4. Each query's denominator, the CTAs' sums added in rank order (the
  //    same bits in every CTA); the weights, times V's row scales, and
  //    their max per (k, slot): a weight is >= 0, so its bits order as the
  //    floats do; then the row's max over the cluster and the scales.
  for (int k = tid; k < K; k += P1_THREADS) {
    float l = 0.f;
    for (int r = 0; r < cs; ++r) l = __fadd_rn(l, *cluster.map_shared_rank(sm.lsum + k, r));
    sm.den[k] = l;
  }
  __syncthreads();
  for (int i = tid; i < K * ncol; i += P1_THREADS) {
    const int k = i / ncol, c = i - k * ncol;
    const int j = sm.sj[k * cw + c];
    float p = 0.f;
    if (j >= 0) {
      p = __fmul_rn(__fdiv_rn(sm.sc[k * cw + c], sm.den[k]),
                    __bfloat162float(vs[crow0 + (size_t)j * ctx + c0 + c]));
      atomicMax(reinterpret_cast<int*>(sm.pmax + k * K + j), __float_as_int(p));
    }
    sm.sc[k * cw + c] = p;
  }
  cluster.sync();
  for (int i = tid; i < K * K; i += P1_THREADS) {
    float m = 0.f;
    for (int r = 0; r < cs; ++r) m = fmaxf(m, *cluster.map_shared_rank(sm.pmax + i, r));
    sm.ps[i] = quant_scale(m);
  }
  __syncthreads();
  for (int i = tid; i < K * ncol; i += P1_THREADS) {
    const int k = i / ncol, c = i - k * ncol;
    const int j = sm.sj[k * cw + c];
    int8_t code = 0;
    if (j >= 0) {
      code = (int8_t)rintf(__fdiv_rn(sm.sc[k * cw + c], sm.ps[k * K + j]));
      if (p_codes != nullptr) p_codes[((row0 + k) * K + j) * ctx + c0 + c] = code;
    }
    sm.pc[k * cw + c] = code;
  }
  __syncthreads();

  // 5. PV over this CTA's columns: thread item (column range sp, query k,
  //    piece p) sums code * V byte in s32 for 16 values of d, one column's
  //    V row piece (16 bytes) per step, and adds the sums into the (k,
  //    slot) row of sm.pv when the column's slot changes (once per range
  //    on the identity ancestry).
  {
    const int items = K * kPieces;
    const int nsplit = max(1, P1_THREADS / items);
    const int span = (ncol + nsplit - 1) / nsplit;
    for (int it = tid; it < nsplit * items; it += P1_THREADS) {
      const int p = it % kPieces, k = (it / kPieces) % K, sp = it / items;
      const int cb = sp * span, ce = min(ncol, cb + span);
      int acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0;
      int cur = -1;
      for (int c = cb; c < ce; ++c) {
        const int j = sm.sj[k * cw + c];
        const int w = sm.pc[k * cw + c];
        if (j < 0 || w == 0) continue;
        if (j != cur) {
          if (cur >= 0) {
            int* dst = sm.pv + (k * K + cur) * D + p * 16;
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              atomicAdd(dst + e, acc[e]);
              acc[e] = 0;
            }
          }
          cur = j;
        }
        const int4 raw = __ldg(reinterpret_cast<const int4*>(vq + (crow0 + (size_t)j * ctx + c0 + c) * D) + p);
        const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] += w * (int)(int8_t)(words[e / 4] >> (8 * (e % 4)));
      }
      if (cur >= 0) {
        int* dst = sm.pv + (k * K + cur) * D + p * 16;
#pragma unroll
        for (int e = 0; e < 16; ++e) atomicAdd(dst + e, acc[e]);
      }
    }
  }
  cluster.sync();

  // 6. Each output (k, d) by one thread of the cluster: the s32 sums of
  //    every rank, exact in any order, then the slots in order.
  for (int i = rank * P1_THREADS + tid; i < K * D; i += cs * P1_THREADS) {
    const int k = i / D, d = i - k * D;
    float a = 0.f;
    for (int j = 0; j < K; ++j) {
      int tot = 0;
      for (int r = 0; r < cs; ++r) tot += *cluster.map_shared_rank(sm.pv + (k * K + j) * D + d, r);
      a = __fadd_rn(a, __fmul_rn((float)tot, sm.ps[k * K + j]));
    }
    out[(row0 + k) * D + d] = __float2bfloat16(a);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// P2
// ---------------------------------------------------------------------------

// P2b: q (B, H, K, D), one scale per (h, k), out (B, H, K); one block of
// PR_THREADS per (b, h).
__global__ void __launch_bounds__(PR_THREADS) scores_batched_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq, float* __restrict__ out,
    int8_t* __restrict__ q_codes, int B, int H, int K, int ctx, int layer) {
  constexpr int D = PR_D;
  __shared__ __align__(16) int8_t qc[PR_MAXK * D];
  __shared__ float qs[PR_MAXK];
  __shared__ long long part[PR_NWARPS][PR_MAXK];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;

  // q's codes of this head, one warp per query.
  for (int k = warp; k < K; k += PR_NWARPS) {
    const size_t r = (size_t)bh * K + k;
    const float s = quant_row64(q + r * D, 1.f, qc + k * D,
                                q_codes == nullptr ? nullptr : q_codes + r * D, lane);
    if (lane == 0) qs[k] = s;
  }
  __syncthreads();

  // Every (slot, column) row of this head, one thread per row, dotted with
  // all K queries.
  const int* qw = reinterpret_cast<const int*>(qc);
  const int4* rows = reinterpret_cast<const int4*>(kq + ((size_t)layer * B * H + bh) * (size_t)K * ctx * D);
  int acc[PR_MAXK];
#pragma unroll
  for (int k = 0; k < PR_MAXK; ++k) acc[k] = 0;
  for (int r = tid; r < K * ctx; r += PR_THREADS) {
    int4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(rows + (size_t)r * 4 + i);
#pragma unroll
    for (int k = 0; k < PR_MAXK; ++k) {
      if (k < K) {
        const int* a = qw + k * (D / 4);
        int d = acc[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d = __dp4a(a[4 * i], v[i].x, d);
          d = __dp4a(a[4 * i + 1], v[i].y, d);
          d = __dp4a(a[4 * i + 2], v[i].z, d);
          d = __dp4a(a[4 * i + 3], v[i].w, d);
        }
        acc[k] = d;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PR_MAXK; ++k) {
    const long long w = warp_sum64((long long)acc[k]);
    if (lane == 0) part[warp][k] = w;
  }
  __syncthreads();
  if (tid < K) {
    long long s = 0;
    for (int w = 0; w < PR_NWARPS; ++w) s += part[w][tid];
    out[(size_t)bh * K + tid] = __fmul_rn((float)s, qs[tid]);
  }
}

constexpr int P2H_THREADS = 512;
constexpr int P2H_NWARPS = P2H_THREADS / 32;
constexpr int P2H_HALF = P2H_THREADS / 2;
constexpr int P2H_CLUSTER = 8;  // CTAs per batch row: the portable cluster size

// The 64 code bytes of a K row (four 16-byte loads), or zeros past `end`.
__device__ __forceinline__ void load_row(int4* v, const int4* rows, int r, int end) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = r < end ? __ldg(rows + (size_t)r * 4 + i) : make_int4(0, 0, 0, 0);
}

// acc[k] += the s32 dot of one row's codes with query k's codes in shared
// memory (`codes`: K rows of 64 bytes).
__device__ __forceinline__ void dot_row(int* acc, const int4* v, const int8_t* codes, int K) {
#pragma unroll
  for (int k = 0; k < PR_MAXK; ++k) {
    if (k < K) {
      const int4* a4 = reinterpret_cast<const int4*>(codes + k * PR_D);
      int d = acc[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int4 a = a4[i];
        d = __dp4a(a.x, v[i].x, d);
        d = __dp4a(a.y, v[i].y, d);
        d = __dp4a(a.z, v[i].z, d);
        d = __dp4a(a.w, v[i].w, d);
      }
      acc[k] = d;
    }
  }
}

__device__ __forceinline__ void bf16x8(uint4 raw, float* x) {
  const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(pr[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// The largest number of heads one CTA's rows span: its share of a batch
// row's H * K * ctx rows, cut at head boundaries.
inline int p2h_span_heads(int H, int K, int ctx) {
  const int per_head = K * ctx, span = (H * per_head + P2H_CLUSTER - 1) / P2H_CLUSTER;
  const int nh = (span + per_head - 1) / per_head + 1;
  return nh < H ? nh : H;
}

// P2h: q flat (B, K, H*D), one scale per (b, k) over all heads, out (B, K).
// Grid (P2H_CLUSTER, B), one cluster per batch row: CTA `rank` owns the
// row's (head, slot, column) rows [rank * span, (rank + 1) * span) of the
// H * K * ctx in head order; dynamic shared memory holds the codes of the
// heads they span (`p2h_span_heads`).  Nothing is kept between calls.
__global__ void __launch_bounds__(P2H_THREADS, 2) scores_perhead_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq, float* __restrict__ out,
    int8_t* __restrict__ q_codes, int B, int H, int K, int ctx, int layer) {
  constexpr int D = PR_D;
  constexpr int kPer = D / 8;  // 16-byte pieces of a head's slice of q
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)gridDim.x;
  const int b = blockIdx.y;
  const int per_head = K * ctx, all_rows = H * per_head;
  const int span = (all_rows + cs - 1) / cs;
  const int r0 = min(rank * span, all_rows), r1 = min(r0 + span, all_rows);
  const int h0 = r0 / per_head;
  const int nh = r1 > r0 ? (r1 - 1) / per_head - h0 + 1 : 0;  // heads this CTA's rows span
  extern __shared__ int4 qc4[];
  int8_t* qc = reinterpret_cast<int8_t*>(qc4);  // (nh, K, D) codes
  __shared__ float amax[PR_MAXK];               // read by the cluster
  __shared__ float qs[PR_MAXK];
  __shared__ long long total[P2H_CLUSTER][PR_MAXK];  // rank 0's: every rank's sums
  __shared__ long long part[P2H_NWARPS][PR_MAXK];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const __nv_bfloat16* qrow = q + (size_t)b * K * H * D;  // piece i = (k * H + h) * kPer + c

  // 1. Loads first, all in flight together: the first half of the threads
  //    read this CTA's share of the flat q rows for their max (pieces
  //    rank, rank + cs, ...), the second half the pieces of the heads its
  //    rows span, for their codes; every thread its first two K rows.
  const int all_pieces = K * H * kPer, own_pieces = nh * K * kPer;
  const int ia = tid * cs + rank;                    // a max piece (first half)
  const int io = tid - P2H_HALF;                     // an own piece (second half)
  uint4 first = make_uint4(0, 0, 0, 0);
  if (tid < P2H_HALF ? ia < all_pieces : io < own_pieces) {
    int i = ia;
    if (tid >= P2H_HALF) i = ((io / kPer) % K * H + h0 + io / (K * kPer)) * kPer + io % kPer;
    first = __ldg(reinterpret_cast<const uint4*>(qrow) + i);
  }
  const int4* rows = reinterpret_cast<const int4*>(kq + ((size_t)layer * B + b) * (size_t)all_rows * D);
  int4 va[4], vb[4];
  load_row(va, rows, r0 + tid, r1);
  load_row(vb, rows, r0 + tid + P2H_THREADS, r1);
  if (tid < PR_MAXK) amax[tid] = 0.f;
  __syncthreads();

  // 2. This CTA's max per query, then the row's over the cluster.
  if (tid < P2H_HALF) {
    for (int j = 0, i = ia; i < all_pieces; ++j, i += P2H_HALF * cs) {
      float x[8];
      bf16x8(j == 0 ? first : __ldg(reinterpret_cast<const uint4*>(qrow) + i), x);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(x[e]));
      atomicMax(reinterpret_cast<int*>(amax + i / (H * kPer)), __float_as_int(a));
    }
  }
  cluster.sync();
  if (tid < K) {
    float m = 0.f;
    for (int r = 0; r < cs; ++r) m = fmaxf(m, *cluster.map_shared_rank(amax + tid, r));
    qs[tid] = quant_scale(m);
  }
  __syncthreads();

  // 3. The codes of the heads this CTA's rows span.
  if (tid >= P2H_HALF) {
    for (int j = 0, o = io; o < own_pieces; ++j, o += P2H_HALF) {
      const int hl = o / (K * kPer), k = (o / kPer) % K, c = o % kPer;
      const int i = (k * H + h0 + hl) * kPer + c;
      float x[8];
      bf16x8(j == 0 ? first : __ldg(reinterpret_cast<const uint4*>(qrow) + i), x);
      uint2 packed;
      int8_t* c8 = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; ++e) c8[e] = q_code(x[e], qs[k]);
      *reinterpret_cast<uint2*>(qc + (hl * K + k) * D + c * 8) = packed;
      if (q_codes != nullptr) *reinterpret_cast<uint2*>(q_codes + (size_t)b * K * H * D + (size_t)i * 8) = packed;
    }
  }
  __syncthreads();

  // 4. This CTA's rows, each dotted with its head's K queries.
  int acc[PR_MAXK];
#pragma unroll
  for (int k = 0; k < PR_MAXK; ++k) acc[k] = 0;
  int r = r0 + tid;
  if (r < r1) dot_row(acc, va, qc + (r / per_head - h0) * K * D, K);
  r += P2H_THREADS;
  if (r < r1) dot_row(acc, vb, qc + (r / per_head - h0) * K * D, K);
  for (r += P2H_THREADS; r < r1; r += P2H_THREADS) {
    load_row(va, rows, r, r1);
    dot_row(acc, va, qc + (r / per_head - h0) * K * D, K);
  }

  // 5. The CTA's int64 sums into rank 0's shared memory (every CTA has
  //    started: step 2 followed a cluster barrier); rank 0 adds them, exact
  //    in any order, and scales the row's sum once.
#pragma unroll
  for (int k = 0; k < PR_MAXK; ++k) {
    const long long w = warp_sum64((long long)acc[k]);
    if (lane == 0) part[warp][k] = w;
  }
  __syncthreads();
  if (tid < K) {
    long long s = 0;
    for (int w = 0; w < P2H_NWARPS; ++w) s += part[w][tid];
    *cluster.map_shared_rank(&total[rank][tid], 0) = s;
  }
  cluster.sync();  // no CTA reads another's shared memory past this barrier
  if (rank == 0 && tid < K) {
    long long s = 0;
    for (int r = 0; r < cs; ++r) s += total[r][tid];
    out[(size_t)b * K + tid] = __fmul_rn((float)s, qs[tid]);
  }
}

bool bad_shape(int K, int D, int ctx) { return D != PR_D || K < 1 || K > PR_MAXK || ctx < 1; }

// Launches `kernel` on a grid of (cs, rows) in clusters of (cs, 1, 1).
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int cs, int rows, int threads, int smem,
                    void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (cs > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fwt_attend_only_int8(const void* q, const void* k_codes, const void* k_scale,
                                    const void* v_codes, const void* v_scale, const void* anc,
                                    const void* pos_row, void* out, void* q_codes, void* p_codes,
                                    int B, int H, int K, int ctx, int D, int layer, float d_scale,
                                    void* stream) {
  if (bad_shape(K, D, ctx)) return (int)cudaErrorInvalidValue;
  const int cs = p1_cluster_size(ctx);
  const int cw = (ctx + cs - 1) / cs;
  return launch_clusters(
      attend_only_kernel, cs, B * H, P1_THREADS, (int)p1_carve(nullptr, K, cw, nullptr), stream,
      (const __nv_bfloat16*)q, (const int8_t*)k_codes, (const __nv_bfloat16*)k_scale,
      (const int8_t*)v_codes, (const __nv_bfloat16*)v_scale, (const int*)anc, (const int*)pos_row,
      (__nv_bfloat16*)out, (int8_t*)q_codes, (int8_t*)p_codes, B, H, K, ctx, cw, layer, d_scale);
}

extern "C" int fwt_scores_batched_int8(const void* q, const void* k_codes, void* out,
                                       void* q_codes, int B, int H, int K, int ctx, int D,
                                       int layer, void* stream) {
  if (bad_shape(K, D, ctx)) return (int)cudaErrorInvalidValue;
  scores_batched_kernel<<<B * H, PR_THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_codes, (float*)out, (int8_t*)q_codes, B, H, K,
      ctx, layer);
  return (int)cudaGetLastError();
}

extern "C" int fwt_scores_perhead_int8(const void* q, const void* k_codes, void* out,
                                       void* q_codes, int B, int H, int K, int ctx, int D,
                                       int layer, void* stream) {
  if (bad_shape(K, D, ctx)) return (int)cudaErrorInvalidValue;
  const int nh = p2h_span_heads(H, K, ctx);
  return launch_clusters(scores_perhead_kernel, P2H_CLUSTER, B, P2H_THREADS, nh * K * PR_D, stream,
                         (const __nv_bfloat16*)q, (const int8_t*)k_codes, (float*)out,
                         (int8_t*)q_codes, B, H, K, ctx, layer);
}
