// The fast window's inner scan: the TLB and page-walk-cache chain of an
// event-free segment of steps, one warp per (run, simulated thread).
//
// No Pallas original: replaces the inner `lax.scan` of the JAX package's
// src/repro/core/sim.py::_build_fast_window (its `row`, sim.py:1015-1059).
// The tile's gathers, Bernoulli draws and latency terms are computed before
// the launch (core/sim.py::fast_window_tile); this kernel threads what is
// truly sequential through the segment's rows in order, per run l and
// thread t:
//   hit1, way1 = lookup(L1 dTLB, m)      hit2, way2 = lookup(STLB, m)
//   pde_hit, pde_way = lookup(PDE PWC, m >> rb)
//   pdpte_hit, pdpte_way = lookup(PDPTE PWC, m >> 2rb)
//   walkn = act & !hit1 & !hit2
//   mid = pde_hit ? 0 : mid_read_miss    full = !pde_hit & !pdpte_hit
//   top = thp ? 0 : (full ? top_read_miss : 0)
//   root = full ? llc_hit : 0
//   walk_cost = walkn ? ((leaf_read + mid) + top) + root : 0
//   walk_reads = walkn ? !leaf_llc + (!pde_hit & !up1_llc)
//                        + (thp ? 0 : full & !up2_llc) : 0
//   tlb_penalty = act & !hit1 ? stlb_hit : 0
//   stall = walk_cost + stall_frac * data_cost
//   total = ((act ? cpu_work : 0) + tlb_penalty) + stall
//   touch-or-insert m in L1 (act), in STLB (act & !hit1), the PDE and
//   PDPTE tags (walkn), each stamped now0 + row
//   ct += total, cwk += walk_cost, cst += stall, cdm += data_cost
//   l1 hits += act & hit1, stlb hits += act & !hit1 & hit2,
//   walks += walkn, walk reads += walk_reads
// A lookup hits at the lowest matching way; a miss picks the lowest way of
// least lru (an empty way carries -1), as the reference's argmax/argmin.
// Stamps must keep (now0 + R + 3) * ways below 2^32 (the wrapper checks).
// Outputs per row and thread: the four f32 accumulators and the four
// counts, cumulative from the launch ([L, R, 4, T] each); the caches and
// the accumulators are updated in place.
//
// Exactness: every f32 operation is a separate round-to-nearest intrinsic
// in the reference's order (no FMA contraction), so the kernel equals the
// per-step engine bit for bit.
//
// Bound: launch latency and the rows' serial chain.  A quickstart segment
// (64 rows, T = 32, benchmark_machine()) moves 955,392 B (its inputs once,
// the four caches of 32 threads and the accumulators read and written
// once, the outputs), 0.29 us at 3.35 TB/s, below one launch.
//
// Design.  The four caches of one thread (1,640 entries of tag and lru at
// benchmark_machine(), 13,120 B) are loaded into the warp's shared memory
// once per launch (16-byte loads where the layout allows) and written back
// at its end.  A row compares the ways of each set across the warp's lanes
// and takes hit and victim in one warp minimum of a key per way: the way
// itself where its tag matches, else ways * (lru + 2) + way, so the least
// key is the lowest matching way or, with none, the lowest way of least
// lru (the wrapper bounds the stamps so that the key fits 32 bits); the
// lane that holds the least key writes the entry.  The four probes are
// independent, so their chains overlap.
// The rows' inputs come 32 rows at a time, one row per lane, loaded a
// chunk ahead, and each row's are shuffled to the whole warp.  Every lane
// carries the same scalar chain.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Cache {
  int32_t* tags;       // this thread's [sets, ways] in global memory
  int32_t* lru;
  int32_t* s_tags;     // its copy in shared memory
  int32_t* s_lru;
  int sets;
  int ways;
};

__device__ __forceinline__ void copy_ints(int32_t* dst, const int32_t* src,
                                          int n, int lane) {
  if (n % 4 == 0 && ((uintptr_t)dst | (uintptr_t)src) % 16 == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = lane; i < n / 4; i += kWarp) d4[i] = s4[i];
  } else {
    for (int i = lane; i < n; i += kWarp) dst[i] = src[i];
  }
}

__device__ __forceinline__ void load(const Cache& c, int lane) {
  copy_ints(c.s_tags, c.tags, c.sets * c.ways, lane);
  copy_ints(c.s_lru, c.lru, c.sets * c.ways, lane);
}

__device__ __forceinline__ void store(const Cache& c, int lane) {
  copy_ints(c.tags, c.s_tags, c.sets * c.ways, lane);
  copy_ints(c.lru, c.s_lru, c.sets * c.ways, lane);
}

// A probe of `tag` in its set, which starts at entry `base` (see Design):
// each lane keys its ways, and the least key over the warp is < ways on a
// hit.  The one lane that holds it (keys are distinct) owns the entry.
struct Probe {
  int base, tag;
  unsigned key;        // this lane's least key
  int slot;            // its entry
  bool mine;           // this lane holds the warp's least key
  unsigned least;
};

__device__ __forceinline__ void key_way(const Cache& c, Probe& p, int w) {
  if (w < c.ways) {
    const int e = p.base + w;
    const unsigned k = c.s_tags[e] == p.tag
                           ? (unsigned)w
                           : (unsigned)c.ways * (unsigned)(c.s_lru[e] + 2) + w;
    if (k < p.key) {
      p.key = k;
      p.slot = e;
    }
  }
}

// The lane's first way (straight-line, so the four caches' loads issue
// together); ways past the warp's width (none on the repository's
// machines) in a loop.
__device__ __forceinline__ Probe probe_first(const Cache& c, int base,
                                             int tag, int lane) {
  Probe p{base, tag, UINT_MAX, base, false, 0};
  key_way(c, p, lane);
  return p;
}

__device__ __forceinline__ void probe_rest(const Cache& c, Probe& p,
                                           int lane) {
#pragma unroll 1
  for (int w = lane + kWarp; w < c.ways; w += kWarp) key_way(c, p, w);
}

__device__ __forceinline__ bool probe_hit(const Cache& c, Probe& p) {
  p.least = __reduce_min_sync(kFull, p.key);
  p.mine = p.key == p.least;
  return p.least < (unsigned)c.ways;
}

// Touch-or-insert: the lane that holds the entry writes it.
__device__ __forceinline__ void touch(const Cache& c, const Probe& p,
                                      int now, bool on) {
  if (on && p.mine) {
    c.s_tags[p.slot] = p.tag;
    c.s_lru[p.slot] = now;
  }
}

// The first entry of `tag`'s set.
__device__ __forceinline__ int set_base(int tag, int sets, int ways) {
  return tag % sets * ways;
}

struct Row {                 // one row's inputs for one thread
  int m;
  int flags;                 // active, leaf / mid / top LLC hit: bytes 0-3
  float4 x;                  // leaf read, mid and top read on a miss, data
};

__device__ __forceinline__ Row load_row(const int32_t* m_in,
                                        const int32_t* flags_in,
                                        const float4* terms_in, size_t idx,
                                        bool live) {
  Row row{0, 0, make_float4(0.f, 0.f, 0.f, 0.f)};
  if (live) {
    row.m = m_in[idx];
    row.flags = flags_in[idx];
    row.x = terms_in[idx];
  }
  return row;
}

__device__ __forceinline__ Row shfl_row(const Row& row, int src) {
  Row out;
  out.m = __shfl_sync(kFull, row.m, src);
  out.flags = __shfl_sync(kFull, row.flags, src);
  out.x.x = __shfl_sync(kFull, row.x.x, src);
  out.x.y = __shfl_sync(kFull, row.x.y, src);
  out.x.z = __shfl_sync(kFull, row.x.z, src);
  out.x.w = __shfl_sync(kFull, row.x.w, src);
  return out;
}

__global__ void fast_window_kernel(
    const int32_t* __restrict__ m_in, const int32_t* __restrict__ flags_in,
    const float4* __restrict__ terms_in, int32_t* l1_tags, int32_t* l1_lru,
    int32_t* stlb_tags, int32_t* stlb_lru, int32_t* pde_tags,
    int32_t* pde_lru, int32_t* pdpte_tags, int32_t* pdpte_lru, float* ct_io,
    float* cwk_io, float* cst_io, float* cdm_io, float* cum_out,
    int32_t* counts_out, int R, int T, int now0, int rb, int thp, int sets1,
    int ways1, int sets2, int ways2, int e3, int e4, float llc_hit,
    float stlb_hit, float cpu_work, float stall_frac) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x;
  const int run = blockIdx.x;            // l * T + t
  const int l = run / T, t = run % T;
  const int n1 = sets1 * ways1, n2 = sets2 * ways2;
  Cache c1{l1_tags + (size_t)run * n1, l1_lru + (size_t)run * n1, smem,
           smem + n1, sets1, ways1};
  Cache c2{stlb_tags + (size_t)run * n2, stlb_lru + (size_t)run * n2,
           smem + 2 * n1, smem + 2 * n1 + n2, sets2, ways2};
  int32_t* s3 = smem + 2 * (n1 + n2);
  Cache c3{pde_tags + (size_t)run * e3, pde_lru + (size_t)run * e3, s3,
           s3 + e3, 1, e3};
  Cache c4{pdpte_tags + (size_t)run * e4, pdpte_lru + (size_t)run * e4,
           s3 + 2 * e3, s3 + 2 * e3 + e4, 1, e4};
  // row r of (l, t) is at idx + r * T; lane k holds row r0 + k of a chunk
  const size_t idx = (size_t)l * R * T + t;
  Row next = load_row(m_in, flags_in, terms_in, idx + (size_t)lane * T,
                      lane < R);
  load(c1, lane);
  load(c2, lane);
  load(c3, lane);
  load(c4, lane);
  float ct = ct_io[run], cwk = cwk_io[run], cst = cst_io[run],
        cdm = cdm_io[run];
  int n_l1 = 0, n_stlb = 0, n_walk = 0, n_reads = 0;
  __syncwarp();

  Row chunk = next;
  for (int r = 0; r < R; ++r) {
    if ((r & (kWarp - 1)) == 0) {
      chunk = next;
      const int ahead = r + kWarp + lane;
      next = load_row(m_in, flags_in, terms_in, idx + (size_t)ahead * T,
                      ahead < R);
    }
    const Row row = shfl_row(chunk, r & (kWarp - 1));
    const int m = row.m;
    const float4 x = row.x;
    const bool act = row.flags & 0xff, leaf_llc = (row.flags >> 8) & 0xff,
               up1 = (row.flags >> 16) & 0xff, up2 = (row.flags >> 24) & 0xff;
    const int leaf = m >> rb, mid = m >> (2 * rb);
    Probe p1 =
        probe_first(c1, set_base(m, sets1, ways1), m, lane);
    Probe p2 =
        probe_first(c2, set_base(m, sets2, ways2), m, lane);
    Probe p3 = probe_first(c3, 0, leaf, lane);
    Probe p4 = probe_first(c4, 0, mid, lane);
    probe_rest(c1, p1, lane);
    probe_rest(c2, p2, lane);
    probe_rest(c3, p3, lane);
    probe_rest(c4, p4, lane);
    const bool hit1 = probe_hit(c1, p1), hit2 = probe_hit(c2, p2),
               pde_hit = probe_hit(c3, p3), pdpte_hit = probe_hit(c4, p4);
    const bool walkn = act && !hit1 && !hit2;
    const bool full = !pde_hit && !pdpte_hit;
    const float mid_read = pde_hit ? 0.f : x.y;
    const float top_read = (!thp && full) ? x.z : 0.f;
    const float root_read = full ? llc_hit : 0.f;
    const float walk_cost =
        walkn ? __fadd_rn(__fadd_rn(__fadd_rn(x.x, mid_read), top_read),
                          root_read)
              : 0.f;
    const int reads = walkn ? (int)!leaf_llc + (int)(!pde_hit && !up1) +
                                  (int)(!thp && full && !up2)
                            : 0;
    const float tlb_penalty = (act && !hit1) ? stlb_hit : 0.f;
    const float stall = __fadd_rn(walk_cost, __fmul_rn(stall_frac, x.w));
    const float total =
        __fadd_rn(__fadd_rn(act ? cpu_work : 0.f, tlb_penalty), stall);
    const int now = now0 + r;
    __syncwarp();                    // every lane has read the sets
    touch(c1, p1, now, act);
    touch(c2, p2, now, act && !hit1);
    touch(c3, p3, now, walkn);
    touch(c4, p4, now, walkn);
    __syncwarp();                    // the writes are seen by the next row
    ct = __fadd_rn(ct, total);
    cwk = __fadd_rn(cwk, walk_cost);
    cst = __fadd_rn(cst, stall);
    cdm = __fadd_rn(cdm, x.w);
    n_l1 += act && hit1;
    n_stlb += act && !hit1 && hit2;
    n_walk += walkn;
    n_reads += reads;
    // lanes 0-3 write the accumulators, lanes 4-7 the counts
    const size_t o = ((size_t)(l * R + r) * 4 + (lane & 3)) * T + t;
    if (lane < 4) {
      cum_out[o] = lane == 0 ? ct : lane == 1 ? cwk : lane == 2 ? cst : cdm;
    } else if (lane < 8) {
      const int k = lane & 3;
      counts_out[o] = k == 0 ? n_l1 : k == 1 ? n_stlb : k == 2 ? n_walk
                                                               : n_reads;
    }
  }
  __syncwarp();
  store(c1, lane);
  store(c2, lane);
  store(c3, lane);
  store(c4, lane);
  if (lane == 0) {
    ct_io[run] = ct;
    cwk_io[run] = cwk;
    cst_io[run] = cst;
    cdm_io[run] = cdm;
  }
}

}  // namespace

extern "C" int fast_window_launch(
    const void* m, const void* flags, const void* terms, void* l1_tags,
    void* l1_lru, void* stlb_tags, void* stlb_lru, void* pde_tags,
    void* pde_lru, void* pdpte_tags, void* pdpte_lru, void* ct, void* cwk,
    void* cst, void* cdm, void* cum, void* counts, int L, int R, int T,
    int now0, int rb, int thp, int sets1, int ways1, int sets2, int ways2,
    int e3, int e4, float llc_hit, float stlb_hit, float cpu_work,
    float stall_frac, void* stream) {
  if (L == 0 || T == 0) return 0;
  if (L < 0 || T < 0 || R < 0 || sets1 < 1 || ways1 < 1 || sets2 < 1 ||
      ways2 < 1 || e3 < 1 || e4 < 1 || rb < 0 || rb > 15)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      2 * sizeof(int32_t) *
      ((size_t)sets1 * ways1 + (size_t)sets2 * ways2 + e3 + e4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fast_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fast_window_kernel<<<L * T, kWarp, smem, (cudaStream_t)stream>>>(
      (const int32_t*)m, (const int32_t*)flags, (const float4*)terms,
      (int32_t*)l1_tags, (int32_t*)l1_lru, (int32_t*)stlb_tags,
      (int32_t*)stlb_lru, (int32_t*)pde_tags, (int32_t*)pde_lru,
      (int32_t*)pdpte_tags, (int32_t*)pdpte_lru, (float*)ct, (float*)cwk,
      (float*)cst, (float*)cdm, (float*)cum, (int32_t*)counts, R, T, now0, rb,
      thp, sets1, ways1, sets2, ways2, e3, e4, llc_hit, stlb_hit, cpu_work,
      stall_frac);
  return (int)cudaGetLastError();
}
