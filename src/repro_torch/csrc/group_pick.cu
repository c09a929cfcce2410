// Per-group fair-share pick for Hopper, sm_90a: for each engine group, the
// pool positions of the kmax smallest (vruntime, rid) keys, best first.
//
// Replaces the TPU kernel src/repro/kernels/group_pick/kernel.py:55
// (pick_order_pallas, body _pick_kernel).  Same kmax rounds of the
// three-step argmin: min vr, then min rid among the ties, then the least
// still-available position among the winners.  A taken slot gets
// vr = INT32_MAX and avail = CAP while its rid stays as it was, so once
// the valid keys run out a taken slot can win the rid tie at avail = CAP
// and every later column is CAP -- the reference's result, tail included.
// Each round is one lexicographic minimum of the triple (vr', rid, avail)
// over the row, which is what the three masked minima compute.
//
// What bounds it on an H100: at the fleet path's shape (G = 1024 groups,
// CAP = 32, kmax = 8) it reads 2 * G * CAP * 4 bytes and writes
// G * kmax * 4, about 0.3 MB: well under a microsecond of memory traffic,
// so the launch latency bounds it.  One warp owns one row: each lane scans
// the positions lane, lane + 32, ... of its row and keeps its lexicographic
// minimum, and five xor shuffles give every lane the row's minimum.  The
// taken positions are one bit each in shared memory (CAP / 32 words per
// warp), so the inputs are never written and any CAP fits.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                  // rows per block
constexpr int IMAX = 2147483647;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool lex_less(int a0, int a1, int a2, int b0,
                                         int b1, int b2) {
  if (a0 != b0) return a0 < b0;
  if (a1 != b1) return a1 < b1;
  return a2 < b2;
}

__global__ void group_pick_kernel(const int* __restrict__ vr,
                                  const int* __restrict__ rid,
                                  int* __restrict__ out, int G, int cap,
                                  int kmax) {
  extern __shared__ unsigned taken_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = (cap + 31) >> 5;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= G) return;                     // the whole warp leaves together
  unsigned* taken = taken_all + warp * words;
  for (int w = lane; w < words; w += 32) taken[w] = 0u;
  __syncwarp();
  const int* vrow = vr + size_t(g) * cap;
  const int* rrow = rid + size_t(g) * cap;
  int* orow = out + size_t(g) * kmax;
  for (int i = 0; i < kmax; ++i) {
    // (IMAX, IMAX, cap) is no less than any triple of the row
    int b0 = IMAX, b1 = IMAX, b2 = cap;
    for (int j = lane; j < cap; j += 32) {
      const bool t = (taken[j >> 5] >> (j & 31)) & 1u;
      const int a0 = t ? IMAX : vrow[j];
      const int a1 = rrow[j];
      const int a2 = t ? cap : j;
      if (lex_less(a0, a1, a2, b0, b1, b2)) {
        b0 = a0;
        b1 = a1;
        b2 = a2;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int c0 = __shfl_xor_sync(FULL, b0, off);
      const int c1 = __shfl_xor_sync(FULL, b1, off);
      const int c2 = __shfl_xor_sync(FULL, b2, off);
      if (lex_less(c0, c1, c2, b0, b1, b2)) {
        b0 = c0;
        b1 = c1;
        b2 = c2;
      }
    }
    // every lane holds the same minimum; position b2 belongs to lane b2 % 32
    if (lane == 0) orow[i] = b2;
    if (b2 < cap && lane == (b2 & 31)) taken[b2 >> 5] |= 1u << (b2 & 31);
    __syncwarp();
  }
}

}  // namespace

// vr, rid: [G, cap] int32, row-major; out: [G, kmax] int32.  Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int group_pick_fwd(const void* vr, const void* rid, void* out,
                              int G, int cap, int kmax, void* stream) {
  if (G < 0 || cap <= 0 || kmax < 0) return cudaErrorInvalidValue;
  if (G == 0 || kmax == 0) return cudaSuccess;
  const size_t smem = size_t(WARPS) * ((cap + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        group_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (G + WARPS - 1) / WARPS;
  group_pick_kernel<<<blocks, WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(vr), static_cast<const int*>(rid),
      static_cast<int*>(out), G, cap, kmax);
  return cudaGetLastError();
}
