// Tier-migration block copy: dst[g, ids[m,1]] = src[g, ids[m,0]] for
// every pair m and group g, in place in the destination pool.
//
// Replaces the Pallas TPU kernel `block_copy_kernel` / `_kernel` in
// src/repro/kernels/block_copy.py (which copied one [bs, KH, Dh] block per
// grid step through scalar-prefetched index maps); here a launch also
// covers the leading group axis of a [G, P, bs, KH, Dh] pool.
//
// Bound: device memory.  A call reads and writes M * G blocks:
// 2 * M * G * block_bytes over 3.35 TB/s on an H100 SXM (at Qwen1.5-0.5B's
// KV width a block is 16*16*64*2 = 32 KiB per group, 786,432 B over 24
// groups).  Design: one CTA per (pair, group) copies one contiguous block
// with 16-byte vector loads and stores, consecutive threads on consecutive
// addresses.  The caller guarantees 16-byte block sizes and pool bases
// (ops.block_copy checks both).  A pair whose ids lie outside the pools is
// skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void block_copy_kernel(const uint4* __restrict__ src,
                                  uint4* __restrict__ dst,
                                  const int32_t* __restrict__ ids,
                                  int p_src, int p_dst, int64_t block_vecs) {
  const int m = blockIdx.x;
  const int g = blockIdx.y;
  const int32_t s = ids[2 * m];
  const int32_t d = ids[2 * m + 1];
  if (s < 0 || s >= p_src || d < 0 || d >= p_dst) return;
  const uint4* from = src + ((int64_t)g * p_src + s) * block_vecs;
  uint4* to = dst + ((int64_t)g * p_dst + d) * block_vecs;
  for (int64_t i = threadIdx.x; i < block_vecs; i += blockDim.x) to[i] = from[i];
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).  block_bytes must
// be a multiple of 16 and both pools 16-byte aligned.
extern "C" int block_copy_launch(const void* src, void* dst, const void* ids,
                                 int m, int groups, int p_src, int p_dst,
                                 long long block_bytes, void* stream) {
  if (m == 0 || groups == 0) return 0;
  const dim3 grid(m, groups);
  block_copy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, (const int32_t*)ids, p_src, p_dst,
      (int64_t)block_bytes / 16);
  return (int)cudaGetLastError();
}
