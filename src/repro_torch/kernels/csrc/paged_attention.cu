// Decode attention over paged KV pools, split over the KV sequence.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` / `_kernel` in
// src/repro/kernels/paged_attention.py.  For every sequence b, KV head h
// and query row g of its group:
//   s[t]  = q[b,h,g] . K[h, tables[b, t / bs], t % bs] / sqrt(Dh)
//   s[t]  = -1e30 where t >= lengths[b]          (finite, as on the TPU)
//   out   = softmax(s) @ V                        (f32, cast to q's type)
// Table entries are clamped to [0, P-1], as the JAX oracle does, so a -1
// past a sequence's end is never dereferenced out of bounds.  A row with
// lengths[b] == 0 visits all NB blocks: every score is -1e30, so the
// result is the oracle's uniform mean of V over them.  With
// lengths[b] > 0 only the ceil(len / bs) blocks holding a position below
// the length are read: every later position has p = exp(-1e30 - m) = 0
// exactly, so skipping them changes nothing.
//
// Bound: device memory.  Each K and V row is read once and used for G
// query rows, so the work is about G flop per byte, far under the ~295
// flop per byte where an H100's bf16 tensor cores would become the limit
// (3.35 TB/s against 989 TFLOP/s).
//
// Split-KV, as "flash decoding": the TPU kernel walks its grid (B, KH, NB)
// in order on one core and carries (m, l, acc) in scratch from block to
// block.  B * KH alone (64 or 128 at the widths served) would leave most
// of the 132 SMs idle, so the positions of a sequence are cut into
// `splits` chunks of ceil(NB / splits) blocks, fixed on the host from the
// shapes alone (lengths are never read on the host).  A chunk has a fixed
// size, so no CTA straggles; the chunks past a short sequence's end have
// no work.  Every chunk's (m, l, acc) goes to an f32 workspace, and the
// chunks that held a block are merged in the same launch
// (`merge_splits`):
//   out = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30).
// Each CTA counts its arrival on a per-(sequence, KV head, group chunk)
// counter with atomicInc, which wraps it back to 0 for the next call, and
// the last to arrive merges.  One launch per call.  Scores are kept in
// base 2 (log2(e) folded into the scale), so every exponential is one
// exp2f, and the mask stays -1e30, so a masked p is exactly 0 beside any
// real score.
//
// bf16 and f16 (`mma_partial_kernel`): tensor cores fed from a ring of
// pages in shared memory.  Each of the 4 warps of a CTA takes every 4th
// tile of 16 positions of the chunk and keeps its own ring of `stages`
// (K, V) tile pairs, filled with 16-byte `cp.async` copies (each
// position's row found through the table, so any block size works; rows
// past the chunk are zero-filled) and stored with the 16-byte columns of
// row r XORed with r % 8, so `ldmatrix` reads 8 rows without a bank
// conflict; each copy instruction reads whole rows.  Table entries are
// loaded `kAhead` tiles ahead of the copies that use them, and turned into
// rows only then.  Per tile: S^T = K Q^T as `mma.sync.m16n8k16` (16
// positions x 8 query rows, Q as given, f32 accumulators), the scale and
// the mask on the f32 scores, an online softmax per query row with the
// row maximum shared over 8 lanes by shuffles, P rounded to the working
// type and turned into the B operand by `movmatrix`, and O^T += V^T P^T
// as `mma.sync` with V read by `ldmatrix.trans`.  Groups of more than 8
// rows are cut into chunks of 8 (grid y); a head dim runs on the instance
// of 64, 128 or 256 at or above it, its columns past Dh never read.  The
// warps' (m, l, acc) merge in shared memory at the end.
//
// float32 (`partial_kernel`) stays on CUDA cores: tensor cores would take
// f32 as TF32 and miss the 1e-5 the JAX tests hold f32 to.  Each lane
// holds its slices of the G pre-scaled query rows in registers; each group
// of `LPR` lanes reads one K and one V row per position with 16-byte
// vectors, `kUnroll` positions per step, the next step's rows in flight
// while this step's are used; the group reduces its G dot products with
// warp shuffles.  G is a template argument, instantiated for 1, 2, 4, 5
// and 8 (another G runs on the next larger instance with the rows past G
// masked); the head dim runs on the instance of 32, 64, 128 or 256 at or
// above it, its columns past Dh masked.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;          // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;           // query rows per CTA
constexpr int kTile = 16;              // positions per tensor-core tile
constexpr int kAhead = 4;              // tiles' table entries read ahead
constexpr int kMaxSplits = 512;        // splits of a sequence (the wrapper)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// blocks a sequence's attention reads: those holding a position below
// its length, or all NB when the length is 0 (the oracle's uniform mean)
__device__ __forceinline__ int blocks_visited(int len, int bs, int NB) {
  return len > 0 ? min(len / bs + (len % bs != 0), NB) : NB;
}

// Called by every CTA of an active split once its (m, l, acc) is in the
// workspace.  The last of the (b, kh, group chunk)'s `active` splits to
// arrive merges them all into `out`; atomicInc wraps its counter back to
// 0 for the next call.  Each warp weighs the splits of its query rows,
// e^(m_s - m*) / L, into `weight` (shared, gn * splits floats, no longer
// in use); then every output sums its splits' acc, the loads all
// independent.
template <typename T>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    unsigned* __restrict__ arrivals, T* __restrict__ out, float* weight,
    int b, int kh, int KH, int G, int g0, int gn, int Dh, int splits,
    int active) {
  __shared__ int last;
  __threadfence();                             // this split's writes first
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(arrivals + (int64_t)b * gridDim.y + blockIdx.y,
                     (unsigned)active - 1) == (unsigned)active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t split0 = ((int64_t)b * KH + kh) * splits * G + g0;
  for (int g = w; g < gn; g += kWarps) {
    const float* ml = ws_ml + (split0 + g) * 2;
    float mx = kNegInf;
    for (int s = lane; s < active; s += 32)
      mx = fmaxf(mx, __ldcg(ml + (int64_t)s * G * 2));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ls = 0.f;
    for (int s = lane; s < active; s += 32) {
      const float wt = exp2f(__ldcg(ml + (int64_t)s * G * 2) - mx);
      weight[g * splits + s] = wt;
      ls += wt * __ldcg(ml + (int64_t)s * G * 2 + 1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    const float inv = 1.f / fmaxf(ls, 1e-30f);
    for (int s = lane; s < active; s += 32) weight[g * splits + s] *= inv;
  }
  __syncthreads();
  T* orow = out + (((int64_t)b * KH + kh) * G + g0) * Dh;
  for (int i = threadIdx.x; i < gn * Dh; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    const float* acc_s = ws_acc + (split0 + g) * Dh + d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < active; ++s)
      a += weight[g * splits + s] * __ldcg(acc_s + (int64_t)s * G * Dh);
    orow[i] = from_f32<T>(a);
  }
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores

template <int DH, int GMAX>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
               const float* __restrict__ v_pool,
               const int32_t* __restrict__ tables,
               const int32_t* __restrict__ lengths,
               float* __restrict__ ws_acc, float* __restrict__ ws_ml,
               unsigned* __restrict__ arrivals, float* __restrict__ out,
               int KH, int G, int n_gchunk, int Dh, int P, int bs, int NB,
               int splits, int chunk_blocks, float scale) {
  constexpr int VE = 4;                        // floats per 16-byte vector
  constexpr int VPR = DH / VE;                 // vectors per row, at most
  constexpr int LPR = VPR < 32 ? VPR : 32;     // lanes per row
  constexpr int NV = VPR / LPR;                // vectors per lane
  constexpr int RP = kThreads / LPR;           // rows in parallel
  constexpr int EL = NV * VE;                  // elements per lane
  // K/V rows per row group and step: fewer for wide groups, whose
  // accumulators take the registers
  constexpr int kUnroll = GMAX <= 2 ? 4 : 2;

  __shared__ float red_m[RP][GMAX];
  __shared__ float red_l[RP][GMAX];
  __shared__ float red_acc[RP][GMAX][DH];
  static_assert(RP * DH >= kMaxSplits,
                "the merge's weights must fit red_acc");

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int blk1 = min((split + 1) * chunk_blocks,
                       blocks_visited(len, bs, NB));
  if (split * chunk_blocks >= blk1) return;      // no block in this split
  const int tok0 = split * chunk_blocks * bs;
  const int tok1 = blk1 * bs;

  const int kh = blockIdx.y / n_gchunk;
  const int g0 = (blockIdx.y % n_gchunk) * GMAX;
  const int gn = min(GMAX, G - g0);
  const int rg = threadIdx.x / LPR;
  const int lr = threadIdx.x % LPR;
  const int vpr = Dh / VE;                     // vectors of a row of Dh
  bool col_ok[NV];                             // this lane's vectors < Dh
#pragma unroll
  for (int n = 0; n < NV; ++n) col_ok[n] = lr + n * LPR < vpr;

  // this lane's slices of the query rows, pre-scaled; rows past G and
  // columns past Dh are 0
  const float* qrow = q + (((int64_t)b * KH + kh) * G + g0) * Dh;
  float qr[GMAX][EL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qr[g][n * VE + e] = g < gn && col_ok[n]
            ? qrow[g * Dh + (lr + n * LPR) * VE + e] * scale : 0.f;

  const int32_t* trow = tables + (int64_t)b * NB;
  const float4* kvec = reinterpret_cast<const float4*>(k_pool);
  const float4* vvec = reinterpret_cast<const float4*>(v_pool);

  float m[GMAX], l[GMAX], acc[GMAX][EL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[g][e] = 0.f;
  }

  // the physical block of a position, its table entry clamped into the pool
  auto block_of = [&](int pos) {
    return pos < tok1 ? min(max(__ldg(trow + pos / bs), 0), P - 1) : 0;
  };
  constexpr int kStep = RP * kUnroll;          // positions per loop step
  int blk[kUnroll];
  float4 kr[kUnroll][NV], vr[kUnroll][NV];     // the rows of this step
  // issue the loads of the step at `base`, then fetch the table entries
  // of the step after it; rows past tok1 and columns past Dh are 0
  auto issue = [&](int base, float4 (&kk)[kUnroll][NV],
                   float4 (&vv)[kUnroll][NV]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * RP + rg;
      const int64_t row = ((int64_t)kh * P + blk[u]) * bs + pos % bs;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const bool ok = pos < tok1 && col_ok[n];
        kk[u][n] = ok ? __ldg(kvec + row * vpr + lr + n * LPR)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u][n] = ok ? __ldg(vvec + row * vpr + lr + n * LPR)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      blk[u] = block_of(base + kStep + u * RP + rg);
  };
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) blk[u] = block_of(tok0 + u * RP + rg);
  issue(tok0, kr, vr);

  // the loop bound is uniform over the CTA, so every lane takes part in
  // the shuffles; rows past tok1 are switched off by `ok`.  The next
  // step's rows are in flight while this step's are used.
  for (int base = tok0; base < tok1; base += kStep) {
    float4 kn[kUnroll][NV], vn[kUnroll][NV];
    if (base + kStep < tok1) issue(base + kStep, kn, vn);
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ok[u] = base + u * RP + rg < tok1;
    float s[kUnroll][GMAX];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const float kf[VE] = {kr[u][n].x, kr[u][n].y, kr[u][n].z,
                              kr[u][n].w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            s[u][g] += qr[g][n * VE + e] * kf[e];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
      if (base + u * RP + rg >= len) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[u][g] = kNegInf;
      }
    }
    // online softmax over this step's rows; rows past tok1 weigh 0
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = exp2f(m[g] - mx);
      float lsum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][g] = ok[u] ? exp2f(s[u][g] - mx) : 0.f;   // now p
        lsum += s[u][g];
      }
      l[g] = l[g] * corr + lsum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const float vf[VE] = {vr[u][n].x, vr[u][n].y, vr[u][n].z,
                              vr[u][n].w};
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            acc[g][n * VE + e] += s[u][g] * vf[e];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        kr[u][n] = kn[u][n];
        vr[u][n] = vn[u][n];
      }
  }

  // merge the CTA's row groups, then write the split's (m, l, acc)
  if (lr == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) red_m[rg][g] = m[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float mx = kNegInf;
    for (int r = 0; r < RP; ++r) mx = fmaxf(mx, red_m[r][g]);
    const float w = exp2f(m[g] - mx);
    if (lr == 0) red_l[rg][g] = l[g] * w;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        red_acc[rg][g][(lr + n * LPR) * VE + e] = acc[g][n * VE + e] * w;
  }
  __syncthreads();
  const int64_t part = (((int64_t)b * KH + kh) * splits + split) * G + g0;
  for (int i = threadIdx.x; i < gn * Dh; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    float a = 0.f;
    for (int r = 0; r < RP; ++r) a += red_acc[r][g][d];
    ws_acc[(part + g) * Dh + d] = a;
  }
  if (threadIdx.x < gn) {
    const int g = threadIdx.x;
    float mx = kNegInf, ls = 0.f;
    for (int r = 0; r < RP; ++r) mx = fmaxf(mx, red_m[r][g]);
    for (int r = 0; r < RP; ++r) ls += red_l[r][g];
    ws_ml[(part + g) * 2] = mx;
    ws_ml[(part + g) * 2 + 1] = ls;
  }
  merge_splits<float>(ws_acc, ws_ml, arrivals, out, &red_acc[0][0][0], b, kh,
                      KH, G, g0, gn, Dh, splits,
                      (blocks_visited(len, bs, NB) + chunk_blocks - 1)
                          / chunk_blocks);
}

// ---------------------------------------------------------------------------
// bf16 and f16 on tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; `bytes` 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// the 8x8 b16 matrix of a warp's fragments, transposed
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  // d += a (16x16, row) * b (16x8, col), f32 accumulators
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (lo, hi) rounded to the working type, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
};

// (K, V) tile pairs per warp's ring: one being read while the rest load
template <int DH> struct Ring {
  static constexpr int stages = DH <= 64 ? 4 : DH <= 128 ? 3 : 2;
  static constexpr int tile = kTile * DH;                  // elements
  static constexpr int bytes = kWarps * stages * 2 * tile * 2;
};

static_assert(kMaxGroup * kMaxSplits * 4 <= Ring<64>::bytes,
              "the merge's weights must fit the ring");

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mma_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ lengths,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   unsigned* __restrict__ arrivals, T* __restrict__ out,
                   int KH, int G, int n_gchunk, int Dh, int P, int bs, int NB,
                   int splits, int chunk_blocks, float scale) {
  constexpr int NS = Ring<DH>::stages;
  constexpr int NK = DH / 16;                  // k16 steps of a row, at most
  constexpr int kTileElems = Ring<DH>::tile;
  extern __shared__ __align__(128) uint8_t smem[];

  const int split = blockIdx.x;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int blk1 = min((split + 1) * chunk_blocks,
                       blocks_visited(len, bs, NB));
  if (split * chunk_blocks >= blk1) return;      // no block in this split
  const int tok0 = split * chunk_blocks * bs;
  const int tok1 = blk1 * bs;

  const int kh = blockIdx.y / n_gchunk;
  const int g0 = (blockIdx.y % n_gchunk) * kMaxGroup;
  const int gn = min(kMaxGroup, G - g0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = Dh >> 4;                      // k16 steps of a row of Dh
  const int nch = Dh >> 3;                     // its 16-byte columns

  // Q^T as the B operand of S^T = K Q^T: lane holds query row lane / 4,
  // columns 2 (lane % 4) + {0, 1} and + 8 of each k16 step; 0 past G, Dh
  uint32_t qf[NK][2];
  {
    const int g = lane >> 2;
    const T* qrow = q + (((int64_t)b * KH + kh) * G + g0 + g) * Dh
                    + 2 * (lane & 3);
    const unsigned* q32 = reinterpret_cast<const unsigned*>(qrow);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      const bool ok = g < gn && kc < nk;
      qf[kc][0] = ok ? __ldg(q32 + 8 * kc) : 0u;
      qf[kc][1] = ok ? __ldg(q32 + 8 * kc + 4) : 0u;
    }
  }

  // this warp's tiles of 16 positions: w, w + 4, ... of the chunk
  const int n_tiles = (tok1 - tok0 + kTile - 1) / kTile;
  const int my_n = n_tiles > w ? (n_tiles - w + kWarps - 1) / kWarps : 0;
  T* ring = reinterpret_cast<T*>(smem) + w * NS * 2 * kTileElems;
  const int32_t* trow = tables + (int64_t)b * NB;
  const int64_t head = (int64_t)kh * P;

  // lane r < 16: the table entry of position r of the warp's i-th tile,
  // or kPast past the chunk (lanes 16..31 repeat 0..15), loaded kAhead
  // tiles before its copies and turned into a row only for them
  constexpr int kPast = INT_MIN;
  auto entry_of = [&](int i) -> int {
    const int p = tok0 + (w + i * kWarps) * kTile + (lane & 15);
    return i < my_n && p < tok1 ? __ldg(trow + p / bs) : kPast;
  };
  // the element offset of that position's row in the pools, or -1
  auto row_of = [&](int i, int entry) -> int64_t {
    if (entry == kPast) return -1;
    const int p = tok0 + (w + i * kWarps) * kTile + (lane & 15);
    return ((head + min(max(entry, 0), P - 1)) * bs + p % bs) * Dh;
  };
  // lane l copies 16-byte column l % NCH of rows l / NCH + RPI j, so one
  // instruction reads RPI whole rows; column c of row r lands at
  // c ^ (r % 8)
  constexpr int NCH = DH / 8;                  // 16-byte columns, at most
  constexpr int RPI = 32 / NCH;                // rows per instruction
  const int col = lane % NCH;
  auto issue = [&](int i, int64_t roff) {
    T* ks = ring + (i % NS) * 2 * kTileElems;
    T* vs = ks + kTileElems;
#pragma unroll
    for (int j = 0; j < kTile / RPI; ++j) {
      const int r = lane / NCH + RPI * j;
      const int64_t off = __shfl_sync(0xffffffffu, roff, r);
      if (col < nch) {
        const int bytes = off >= 0 ? 16 : 0;
        const int64_t from = (off >= 0 ? off : 0) + col * 8;
        const int at = r * DH + ((col ^ (r & 7)) << 3);
        cp_async16(ks + at, k_pool + from, bytes);
        cp_async16(vs + at, v_pool + from, bytes);
      }
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // query rows
  float acc[NK][4];                            // O^T: 16 columns x 8 rows
#pragma unroll
  for (int dt = 0; dt < NK; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j] = 0.f;

  // the table entries of the tiles after the ring's, `kAhead` of them in
  // flight: pipe[k] is tile i + NS - 1 + k's at step i.  The prologue
  // reads the first tiles' entries together, then issues all but the
  // last of the ring's tiles
  int first[NS - 1], pipe[kAhead];
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) first[t] = entry_of(t);
#pragma unroll
  for (int k = 0; k < kAhead; ++k) pipe[k] = entry_of(NS - 1 + k);
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < my_n) issue(t, row_of(t, first[t]));
    commit();
  }

  for (int i = 0; i < my_n; ++i) {
    // the stage of tile i - 1, read in the last step, takes tile i + NS - 1
    if (i + NS - 1 < my_n) issue(i + NS - 1, row_of(i + NS - 1, pipe[0]));
    commit();
#pragma unroll
    for (int k = 0; k + 1 < kAhead; ++k) pipe[k] = pipe[k + 1];
    pipe[kAhead - 1] = entry_of(i + NS - 1 + kAhead);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NS - 1) : "memory");
    __syncwarp();

    const T* ks = ring + (i % NS) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    // S^T = K Q^T: s[0..1] position lane / 4, query rows 2 (lane % 4)
    // + {0, 1}; s[2..3] position lane / 4 + 8.  All of K's fragments are
    // read first, and even and odd k16 steps sum apart, so the products
    // do not wait on one another's reads
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    {
      uint32_t a[NK][4];
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        const int c = 2 * kc + (lane >> 4);
        if (kc < nk) ldmatrix_x4(a[kc], ks + r * DH + ((c ^ (r & 7)) << 3));
      }
      float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
        if (kc < nk) Mma<T>::run(kc % 2 ? s2 : s, a[kc], qf[kc][0], qf[kc][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += s2[j];
    }
    const int pos = tok0 + (w + i * kWarps) * kTile + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {              // positions pos, pos + 8
      const int t = pos + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[2 * h + e];
        x = t < len ? x * scale : kNegInf;
        if (t >= tok1) x = -CUDART_INF_F;          // past the chunk: p = 0
      }
    }
    float p[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(s[e], s[e + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[e], mx);
      const float corr = exp2f(m[e] - m_new);
      p[e] = exp2f(s[e] - m_new);
      p[e + 2] = exp2f(s[e + 2] - m_new);
      l[e] = l[e] * corr + p[e] + p[e + 2];    // this lane's share
      m[e] = m_new;
#pragma unroll
      for (int dt = 0; dt < NK; ++dt) {
        acc[dt][e] *= corr;
        acc[dt][e + 2] *= corr;
      }
    }
    // P^T as the B operand of O^T = V^T P^T
    const uint32_t b0 = movmatrix_trans(Mma<T>::pack(p[0], p[1]));
    const uint32_t b1 = movmatrix_trans(Mma<T>::pack(p[2], p[3]));
    {
      uint32_t a[NK][4];                       // V's fragments, all first
      const int j = lane >> 3;
      const int r = (lane & 7) + (j >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < NK; ++dt) {
        const int c = 2 * dt + (j & 1);
        if (dt < nk)
          ldmatrix_x4_trans(a[dt], vs + r * DH + ((c ^ (r & 7)) << 3));
      }
#pragma unroll
      for (int dt = 0; dt < NK; ++dt)
        if (dt < nk) Mma<T>::run(acc[dt], a[dt], b0, b1);
    }
    __syncwarp();                              // the stage may be refilled
  }

  // merge the warps in shared memory (the ring's), then write the split's
  // (m, l, acc)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* red_m = reinterpret_cast<float*>(smem);         // [warp][row]
  float* red_l = red_m + kWarps * kMaxGroup;
  float* red_acc = red_l + kWarps * kMaxGroup;           // [warp][row][DH]
  if (lane < 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red_m[w * kMaxGroup + 2 * lane + e] = m[e];
      red_l[w * kMaxGroup + 2 * lane + e] = l[e];
    }
  }
#pragma unroll
  for (int dt = 0; dt < NK; ++dt) {
    if (dt < nk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = 2 * (lane & 3) + (j & 1);
        const int d = 16 * dt + (lane >> 2) + 8 * (j >> 1);
        red_acc[(w * kMaxGroup + g) * DH + d] = acc[dt][j];
      }
    }
  }
  __syncthreads();
  const int64_t part = (((int64_t)b * KH + kh) * splits + split) * G + g0;
  for (int i = threadIdx.x; i < gn * Dh; i += kThreads) {
    const int g = i / Dh, d = i % Dh;
    float mx = kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, red_m[v * kMaxGroup + g]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float wv = exp2f(red_m[v * kMaxGroup + g] - mx);
      a += wv * red_acc[(v * kMaxGroup + g) * DH + d];
      ls += wv * red_l[v * kMaxGroup + g];
    }
    ws_acc[(part + g) * Dh + d] = a;
    if (d == 0) {
      ws_ml[(part + g) * 2] = mx;
      ws_ml[(part + g) * 2 + 1] = ls;
    }
  }

  merge_splits<T>(ws_acc, ws_ml, arrivals, out,
                  reinterpret_cast<float*>(smem), b, kh, KH, G, g0, gn, Dh,
                  splits, (blocks_visited(len, bs, NB) + chunk_blocks - 1)
                              / chunk_blocks);
}

// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *lengths;
  void* out;
  float *ws_acc, *ws_ml;
  unsigned* arrivals;
  int B, KH, G, Dh, P, bs, NB, splits;
  cudaStream_t stream;
};

template <int DH, int GMAX>
int launch_f32(const Args& a) {
  const int n_gchunk = (a.G + GMAX - 1) / GMAX;
  const int chunk_blocks = (a.NB + a.splits - 1) / a.splits;
  const dim3 grid(a.splits, a.KH * n_gchunk, a.B);
  partial_kernel<DH, GMAX><<<grid, kThreads, 0, a.stream>>>(
      (const float*)a.q, (const float*)a.k_pool, (const float*)a.v_pool,
      (const int32_t*)a.tables, (const int32_t*)a.lengths, a.ws_acc,
      a.ws_ml, a.arrivals, (float*)a.out, a.KH, a.G, n_gchunk, a.Dh, a.P,
      a.bs, a.NB, a.splits, chunk_blocks, kLog2e / sqrtf((float)a.Dh));
  return (int)cudaGetLastError();
}

template <int DH>
int launch_f32_dh(const Args& a) {
  switch (a.G) {
    case 1: return launch_f32<DH, 1>(a);
    case 2: return launch_f32<DH, 2>(a);
    case 3:
    case 4: return launch_f32<DH, 4>(a);
    case 5: return launch_f32<DH, 5>(a);
  }
  return launch_f32<DH, kMaxGroup>(a);     // 6..8, or chunks of 8
}

template <typename T, int DH>
int launch_mma(const Args& a) {
  const int n_gchunk = (a.G + kMaxGroup - 1) / kMaxGroup;
  const int chunk_blocks = (a.NB + a.splits - 1) / a.splits;
  auto kernel = mma_partial_kernel<T, DH>;
  // the ring's shared memory is allowed once per device (bit d of `set`)
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(set.load() >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<DH>::bytes);
    if (err != cudaSuccess) return (int)err;
    set |= uint64_t{1} << dev;
  }
  const dim3 grid(a.splits, a.KH * n_gchunk, a.B);
  kernel<<<grid, kThreads, Ring<DH>::bytes, a.stream>>>(
      (const T*)a.q, (const T*)a.k_pool, (const T*)a.v_pool,
      (const int32_t*)a.tables, (const int32_t*)a.lengths, a.ws_acc,
      a.ws_ml, a.arrivals, (T*)a.out, a.KH, a.G, n_gchunk, a.Dh, a.P, a.bs,
      a.NB, a.splits, chunk_blocks, kLog2e / sqrtf((float)a.Dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma_dh(const Args& a) {
  if (a.Dh <= 64) return launch_mma<T, 64>(a);
  if (a.Dh <= 128) return launch_mma<T, 128>(a);
  return launch_mma<T, 256>(a);
}

template <typename T, int DH>
int occupancy_mma(int* ctas) {
  auto kernel = mma_partial_kernel<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<DH>::bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, kThreads, Ring<DH>::bytes);
}

template <typename T>
int occupancy_mma_dh(int Dh, int* ctas) {
  if (Dh <= 64) return occupancy_mma<T, 64>(ctas);
  if (Dh <= 128) return occupancy_mma<T, 128>(ctas);
  return occupancy_mma<T, 256>(ctas);
}

}  // namespace

// The id of the CUDA graph capture under way on `stream` (0 when none is),
// so the wrapper keeps arrival counters per capture.  Returns a
// cudaError_t.
extern "C" int paged_attention_capture_id(void* stream,
                                          unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  if (status != cudaStreamCaptureStatusActive) *id = 0;
  return (int)err;
}

// CTAs of the tensor-core kernel resident per SM on the current device
// for a bf16 (dtype 1) or f16 (2) call of head dim Dh, for checking the
// wrapper's fixed figures (chip_smoke.py).  Returns a cudaError_t (0 =
// *ctas set).
extern "C" int paged_attention_occupancy(int dtype, int Dh, int* ctas) {
  if (dtype == 1) return occupancy_mma_dh<__nv_bfloat16>(Dh, ctas);
  if (dtype == 2) return occupancy_mma_dh<__half>(Dh, ctas);
  return (int)cudaErrorInvalidValue;
}

// Returns the cudaError_t of the launch (0 = launched).  dtype 0 is
// float32 (CUDA cores), 1 bfloat16 and 2 float16 (tensor cores); Dh a
// multiple of 16 up to 256; bs >= 1; 1 <= splits <= kMaxSplits; the pools
// 16-byte aligned (the wrapper checks).  The workspace holds
// B*KH*splits*G*(Dh + 2) floats: the partial acc, then the (m, l) pairs.
// `arrivals` holds B*KH*ceil(G/8) counters that are 0 on entry and left 0
// on exit; no other call may use them meanwhile.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      void* workspace, void* arrivals,
                                      int dtype, int B, int KH, int G, int Dh,
                                      int P, int bs, int NB, int splits,
                                      void* stream) {
  if (B == 0 || KH == 0 || G == 0) return 0;
  if (Dh <= 0 || Dh > 256 || Dh % 16 != 0 || bs <= 0 || splits <= 0
      || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  float* ws = (float*)workspace;
  const Args a{q, k_pool, v_pool, tables, lengths, out, ws,
               ws + (int64_t)B * KH * splits * G * Dh, (unsigned*)arrivals,
               B, KH, G, Dh, P, bs, NB, splits, (cudaStream_t)stream};
  switch (dtype) {
    case 0:
      if (Dh <= 32) return launch_f32_dh<32>(a);
      if (Dh <= 64) return launch_f32_dh<64>(a);
      if (Dh <= 128) return launch_f32_dh<128>(a);
      return launch_f32_dh<256>(a);
    case 1: return launch_mma_dh<__nv_bfloat16>(a);
    case 2: return launch_mma_dh<__half>(a);
  }
  return (int)cudaErrorInvalidValue;
}
