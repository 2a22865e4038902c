// Tier-migration block copy over one or two pool pairs in one launch:
// dst_p[g, ids[m,1]] = src_p[g, ids[m,0]] for every pool pair p (a
// migration's K pools and its V pools), group g and id pair m, in place
// in the destination pools.
//
// Replaces the Pallas TPU kernel `block_copy_kernel` / `_kernel` in
// src/repro/kernels/block_copy.py (which copied one [bs, KH, Dh] block per
// grid step through scalar-prefetched index maps); here one launch covers
// the leading group axis of [G, P, bs, KH, Dh] pools and both pool pairs
// of a migration.
//
// Bound: device memory.  A launch reads and writes pairs * M * G blocks:
// 2 * pairs * M * G * block_bytes over 3.35 TB/s on an H100 SXM (at
// Qwen1.5-0.5B's KV width a block is 16*16*64*2 = 32 KiB per group; a
// migration of 6 blocks over K and V moves 18.87 MB, 5.63 us).  What
// holds a copy back at that size is latency: the card needs about 2 MB of
// loads in flight to keep its memory busy.
//
// Design: the work is cut into items of (pair, group, id pair, chunk of
// kChunk bytes; a block's last chunk may be shorter), and the grid is
// sized from the items, not from M: min(items, kCtasPerSm * SMs) CTAs
// stride over them, so kCtasPerSm chunks per SM (16 MB over the card) can
// be in flight, and at a migration's size every CTA copies one item.  In
// each CTA one thread moves an item with Hopper's bulk asynchronous
// copies: it reads the item's ids, `cp.async.bulk` global -> shared
// completes on an mbarrier, `cp.async.bulk` shared -> global writes the
// chunk back in a bulk group, and the next item's load waits only until
// that store has read the buffer (`wait_group.read`).  Ids outside the
// pools follow the JAX oracle (below): an item whose destination lies
// outside its pool is skipped.  The only alignment assumed is what
// ops.block_copy checks: 16-byte block sizes and 16-byte pool bases, so
// every chunk starts and ends on 16 bytes, as the bulk copies require.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;     // bytes per item
constexpr int kCtasPerSm = 8;     // 8 buffers of 16 KiB per SM

struct Shape {
  uint32_t items;                 // pairs * groups * m * chunks
  int m, groups, chunks, p_src, p_dst;
  int64_t block_bytes;
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// src1 / dst1 are null for one pair.
__global__ void __launch_bounds__(32) block_copy_kernel(
    const uint8_t* src0, uint8_t* dst0, const uint8_t* src1, uint8_t* dst1,
    const int32_t* __restrict__ ids, Shape sh) {
  __shared__ __align__(128) uint8_t buf[kChunk];
  __shared__ uint64_t full;
  if (threadIdx.x != 0) return;
  const uint32_t bar = smem(&full);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  uint32_t parity = 0;
  for (uint32_t i = blockIdx.x; i < sh.items; i += gridDim.x) {
    const uint32_t c = i % (uint32_t)sh.chunks;
    const uint32_t rest = i / (uint32_t)sh.chunks;
    const int m = (int)(rest % (uint32_t)sh.m);
    const uint32_t pg = rest / (uint32_t)sh.m;        // pair * groups + g
    const bool second = pg >= (uint32_t)sh.groups;
    const int g = (int)(second ? pg - sh.groups : pg);
    // ids follow the JAX oracle's gather and scatter: a negative id counts
    // from the end once, a source is then clamped into the pool, and a
    // destination still outside its pool is dropped
    int s = __ldg(ids + 2 * m), d = __ldg(ids + 2 * m + 1);
    s = min(max(s < 0 ? s + sh.p_src : s, 0), sh.p_src - 1);
    if (d < 0) d += sh.p_dst;
    if (d < 0 || d >= sh.p_dst) continue;
    const int64_t off = (int64_t)c * kChunk;
    const int64_t left = sh.block_bytes - off;
    const uint32_t bytes = (uint32_t)(left < kChunk ? left : kChunk);
    const uint8_t* from = (second ? src1 : src0)
        + ((int64_t)g * sh.p_src + s) * sh.block_bytes + off;
    uint8_t* to = (second ? dst1 : dst0)
        + ((int64_t)g * sh.p_dst + d) * sh.block_bytes + off;
    // the previous item's store must have read the buffer
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem(buf)), "l"(from), "r"(bytes), "r"(bar) : "memory");
    mbar_wait(bar, parity);
    parity ^= 1;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(to), "r"(smem(buf)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  src1 and dst1 are
// null for one pair; block_bytes must be a multiple of 16 and every pool
// 16-byte aligned (the wrapper checks); pairs * groups * m * chunks must
// fit in 31 bits.  The grid is sized from the current device's SMs.
extern "C" int block_copy_launch(const void* src0, void* dst0,
                                 const void* src1, void* dst1,
                                 const void* ids, int m, int groups,
                                 int p_src, int p_dst, long long block_bytes,
                                 void* stream) {
  if ((src1 == nullptr) != (dst1 == nullptr)) return (int)cudaErrorInvalidValue;
  if (m == 0 || groups == 0) return 0;
  Shape sh;
  sh.m = m;
  sh.groups = groups;
  sh.p_src = p_src;
  sh.p_dst = p_dst;
  sh.block_bytes = block_bytes;
  sh.chunks = (int)((block_bytes + kChunk - 1) / kChunk);
  const long long items = (src1 ? 2ll : 1ll) * groups * m * sh.chunks;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  sh.items = (uint32_t)items;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const uint32_t cap = (uint32_t)kCtasPerSm * (uint32_t)sms;
  const uint32_t grid = sh.items < cap ? sh.items : cap;
  block_copy_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(src0), static_cast<uint8_t*>(dst0),
      static_cast<const uint8_t*>(src1), static_cast<uint8_t*>(dst1),
      (const int32_t*)ids, sh);
  return (int)cudaGetLastError();
}
