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
// Design (split-KV, as "flash decoding"): the TPU kernel walks its grid
// (B, KH, NB) in order on one core and carries (m, l, acc) in scratch
// from block to block.  B * KH alone (64 or 128 at the widths served)
// would leave most of the 132 SMs idle, so the blocks of a sequence are
// cut into `splits` contiguous chunks of ceil(NB / splits) blocks, fixed
// on the host from B * KH and NB alone (lengths are never read on the
// host).  A chunk has a fixed size, so every CTA has at most one chunk of
// work and a long sequence does not straggle; the chunks past a short
// sequence's end have no work.
//   1. partial kernel, one CTA per (split, KV head [x group chunk], b).
//      Each lane holds its slices of the G pre-scaled f32 query rows in
//      registers.  Each group of `LPR` lanes reads one K row and one V
//      row per position with 16-byte vectors, kUnroll positions per step;
//      the next step's rows are loaded while this step's are used, and
//      its table entries a step earlier.  The group reduces its G dot
//      products with warp shuffles and keeps its own running (m, l, acc)
//      in f32 registers; the CTA merges its groups in shared memory and
//      writes the split's (m, l, acc) to an f32 workspace.  A split with
//      no block returns at once.
//   2. combine kernel, one thread per output, over the splits that held
//      a block (one without would add (-1e30, 0, 0), that is nothing):
//      out = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30).
// Scores are kept in base 2 (log2(e) folded into the query scale), so
// every exponential is one exp2f.  The group size is a template argument
// GMAX, instantiated for 1, 2, 4, 5 and 8 (the groups of the models and
// tests); another G runs on the next larger instance with the rows past
// G masked, and wider groups are cut into chunks of 8 (grid y).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // partial kernel: 4 warps
constexpr int kCombineThreads = 128;
constexpr int kMaxGroup = 8;           // query rows per CTA
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a 16-byte vector of T, widened to f32
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// blocks a sequence's attention reads: those holding a position below
// its length, or all NB when the length is 0 (the oracle's uniform mean)
__device__ __forceinline__ int blocks_visited(int len, int bs, int NB) {
  return len > 0 ? min(len / bs + (len % bs != 0), NB) : NB;
}

template <typename T, int DH, int GMAX>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
               const T* __restrict__ v_pool,
               const int32_t* __restrict__ tables,
               const int32_t* __restrict__ lengths,
               float* __restrict__ ws_acc, float* __restrict__ ws_ml,
               int KH, int G, int n_gchunk, int P, int bs, int NB,
               int splits, int chunk_blocks, float scale) {
  constexpr int VE = 16 / sizeof(T);           // elements per vector
  constexpr int VPR = DH / VE;                 // vectors per K/V row
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

  // this lane's slices of the query rows, pre-scaled; rows past G are 0
  const T* qrow = q + (((int64_t)b * KH + kh) * G + g0) * DH;
  float qr[GMAX][EL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        qr[g][n * VE + e] =
            g < gn ? to_f32(qrow[g * DH + (lr + n * LPR) * VE + e]) * scale
                   : 0.f;

  const int32_t* trow = tables + (int64_t)b * NB;
  const uint4* kvec = reinterpret_cast<const uint4*>(k_pool);
  const uint4* vvec = reinterpret_cast<const uint4*>(v_pool);

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
  uint4 kr[kUnroll][NV], vr[kUnroll][NV];      // the rows of this step
  // issue the loads of the step at `base`, then fetch the table entries
  // of the step after it
  auto issue = [&](int base, uint4 (&kk)[kUnroll][NV],
                   uint4 (&vv)[kUnroll][NV]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * RP + rg;
      if (pos < tok1) {
        const int64_t row = ((int64_t)kh * P + blk[u]) * bs + pos % bs;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          kk[u][n] = __ldg(kvec + row * VPR + lr + n * LPR);
          vv[u][n] = __ldg(vvec + row * VPR + lr + n * LPR);
        }
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
    uint4 kn[kUnroll][NV], vn[kUnroll][NV];
    if (base + kStep < tok1) issue(base + kStep, kn, vn);
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ok[u] = base + u * RP + rg < tok1;
    float s[kUnroll][GMAX];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[u][g] = 0.f;
      if (ok[u]) {
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float kf[VE];
          unpack(kr[u][n], kf, T());
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
#pragma unroll
            for (int e = 0; e < VE; ++e)
              s[u][g] += qr[g][n * VE + e] * kf[e];
        }
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
        float vf[VE];
        unpack(vr[u][n], vf, T());
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
  for (int i = threadIdx.x; i < gn * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float a = 0.f;
    for (int r = 0; r < RP; ++r) a += red_acc[r][g][d];
    ws_acc[(part + g) * DH + d] = a;
  }
  if (threadIdx.x < gn) {
    const int g = threadIdx.x;
    float mx = kNegInf, ls = 0.f;
    for (int r = 0; r < RP; ++r) mx = fmaxf(mx, red_m[r][g]);
    for (int r = 0; r < RP; ++r) ls += red_l[r][g];
    ws_ml[(part + g) * 2] = mx;
    ws_ml[(part + g) * 2 + 1] = ls;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml,
               const int32_t* __restrict__ lengths, T* __restrict__ out,
               int KH, int G, int Dh, int bs, int NB, int splits,
               int chunk_blocks) {
  const int64_t bk = blockIdx.x;               // b * KH + kh
  const int i = blockIdx.y * kCombineThreads + threadIdx.x;
  if (i >= G * Dh) return;
  const int g = i / Dh, d = i % Dh;
  const int visited = blocks_visited(lengths[bk / KH], bs, NB);
  const int active = (visited + chunk_blocks - 1) / chunk_blocks;
  const float* ml = ws_ml + (bk * splits * G + g) * 2;
  const float* acc = ws_acc + (bk * splits * G + g) * Dh + d;
  // one pass with a running maximum, so the loads of several splits are
  // in flight at once
  float mx = kNegInf, ls = 0.f, a = 0.f;
#pragma unroll 4
  for (int s = 0; s < active; ++s) {
    const float ms = ml[s * G * 2];
    const float m_new = fmaxf(mx, ms);
    const float c = exp2f(mx - m_new), w = exp2f(ms - m_new);
    ls = ls * c + w * ml[s * G * 2 + 1];
    a = a * c + w * acc[(int64_t)s * G * Dh];
    mx = m_new;
  }
  out[bk * G * Dh + i] = from_f32<T>(a / fmaxf(ls, 1e-30f));
}

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *lengths;
  void* out;
  float *ws_acc, *ws_ml;
  int B, KH, G, Dh, P, bs, NB, splits;
  cudaStream_t stream;
};

template <typename T, int DH, int GMAX>
int launch(const Args& a) {
  const int n_gchunk = (a.G + GMAX - 1) / GMAX;
  const int chunk_blocks = (a.NB + a.splits - 1) / a.splits;
  const dim3 grid(a.splits, a.KH * n_gchunk, a.B);
  partial_kernel<T, DH, GMAX><<<grid, kThreads, 0, a.stream>>>(
      (const T*)a.q, (const T*)a.k_pool, (const T*)a.v_pool,
      (const int32_t*)a.tables, (const int32_t*)a.lengths, a.ws_acc,
      a.ws_ml, a.KH, a.G, n_gchunk, a.P, a.bs, a.NB, a.splits, chunk_blocks,
      kLog2e / sqrtf((float)DH));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cgrid(a.B * a.KH,
                   (a.G * DH + kCombineThreads - 1) / kCombineThreads);
  combine_kernel<T><<<cgrid, kCombineThreads, 0, a.stream>>>(
      a.ws_acc, a.ws_ml, (const int32_t*)a.lengths, (T*)a.out, a.KH, a.G,
      DH, a.bs, a.NB, a.splits, chunk_blocks);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dh(const Args& a) {
  switch (a.G) {
    case 1: return launch<T, DH, 1>(a);
    case 2: return launch<T, DH, 2>(a);
    case 3:
    case 4: return launch<T, DH, 4>(a);
    case 5: return launch<T, DH, 5>(a);
  }
  return launch<T, DH, kMaxGroup>(a);      // 6..8, or chunks of 8
}

template <typename T>
int launch_t(const Args& a) {
  switch (a.Dh) {
    case 32: return launch_dh<T, 32>(a);
    case 64: return launch_dh<T, 64>(a);
    case 128: return launch_dh<T, 128>(a);
    case 256: return launch_dh<T, 256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the two launches (0 = launched).  dtype 0 is
// float32, 1 bfloat16; Dh is 32, 64, 128 or 256; bs a multiple of 8; the
// pools are 16-byte aligned.  The workspace holds B*KH*splits*G*(Dh + 2)
// floats: the partial acc, then the (m, l) pairs.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      void* workspace, int dtype, int B,
                                      int KH, int G, int Dh, int P, int bs,
                                      int NB, int splits, void* stream) {
  if (B == 0 || KH == 0 || G == 0) return 0;
  float* ws = (float*)workspace;
  const Args a{q, k_pool, v_pool, tables, lengths, out, ws,
               ws + (int64_t)B * KH * splits * G * Dh, B, KH, G, Dh, P, bs,
               NB, splits, (cudaStream_t)stream};
  if (dtype == 0) return launch_t<float>(a);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
