// Decode attention (one query token per sequence against a KV cache) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:69
// (decode_attention_pallas, body _decode_kernel): q [B, H, D] against
// caches k, v [B, Smax, K, D], cache positions >= kv_len[b] masked and
// tiles past kv_len skipped, online softmax in fp32, l clamped to 1e-30
// (so kv_len = 0 gives a zero output).  It adds what the TPU kernel
// lacked and the model's decode needs (repro.models.layers
// .decode_attention with extra_kv): an optional in-flight entry
// k_new, v_new [B, K, D] that joins the softmax beside the cache, so that
// a step attends before it commits its own key and value.
//
// What bounds it on an H100: the bytes of the cache prefix it reads,
// 2 * kv_len * K * D elements per sequence; at the serving path's shapes
// (32 slots, Smax = 192) that is a few MB per layer, so in practice the
// launch latency.  One block owns one (sequence, kv head) pair and the
// G = H / K query heads that share it, so each cache row is read from
// device memory once.  Key and value tiles of 64 positions are staged in
// shared memory as fp32; the G x 64 scores, the softmax state and the
// G x D accumulators stay on chip.  G <= 16 and D <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;           // cache positions per tile
constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_G = 16;
constexpr int MAX_D = 128;
constexpr int ACC = MAX_G * MAX_D / NT;   // accumulators per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (size_t(G) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BK) * D + size_t(G) * BK + 3 * size_t(G));
}

template <typename T>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int* __restrict__ kv_len,
                  const T* __restrict__ k_new, const T* __restrict__ v_new,
                  T* __restrict__ o, int Smax, int H, int K, int D,
                  float scale) {
  const int G = H / K;
  const int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [G][DP], pre-scaled
  float* Ks = Qs + G * DP;           // [BK][DP]
  float* Vs = Ks + BK * DP;          // [BK][D]
  float* Ps = Vs + BK * D;           // [G][BK]
  float* Ms = Ps + G * BK;           // [G] running max
  float* Ls = Ms + G;                // [G] running sum
  float* Cs = Ls + G;                // [G] this tile's correction

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int n = min(max(kv_len[b], 0), Smax);
  const size_t row_stride = size_t(K) * D;   // between cache positions
  const T* kb = kc + size_t(b) * Smax * row_stride + size_t(kh) * D;
  const T* vb = vc + size_t(b) * Smax * row_stride + size_t(kh) * D;
  const T* qb = q + (size_t(b) * H + size_t(kh) * G) * D;

  for (int e = tid; e < G * D; e += NT)
    Qs[(e / D) * DP + e % D] = to_f(qb[e]) * scale;
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int n_tiles = (n + BK - 1) / BK;
  const bool extra = k_new != nullptr;
  for (int t = 0; t < n_tiles + (extra ? 1 : 0); ++t) {
    // a cache tile, or the one in-flight entry as a tile of one row
    const bool is_extra = t == n_tiles;
    const int rows = is_extra ? 1 : min(BK, n - t * BK);
    const T* ks = is_extra ? k_new + (size_t(b) * K + kh) * D
                           : kb + size_t(t) * BK * row_stride;
    const T* vs = is_extra ? v_new + (size_t(b) * K + kh) * D
                           : vb + size_t(t) * BK * row_stride;
    __syncthreads();   // Qs written / last tile's Ks, Vs, Ps no longer read
    for (int e = tid; e < rows * D; e += NT) {
      const int r = e / D, d = e % D;
      Ks[r * DP + d] = to_f(ks[size_t(r) * row_stride + d]);
      Vs[r * D + d] = to_f(vs[size_t(r) * row_stride + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * BK; e += NT) {
      const int g = e / BK, c = e % BK;
      float s = NEG_INF;
      if (c < rows) {
        s = 0.f;
        for (int d = 0; d < D; ++d) s += Qs[g * DP + d] * Ks[c * DP + d];
      }
      Ps[g * BK + c] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARP) {
      float mx = NEG_INF;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ps[g * BK + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float s = Ps[g * BK + c];
        const float p = s <= NEG_INF / 2 ? 0.f : expf(s - m_new);
        Ps[g * BK + c] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + psum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * NT;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[i] * Cs[g];
        for (int c = 0; c < rows; ++c) a += Ps[g * BK + c] * Vs[c * D + d];
        acc[i] = a;
      }
    }
  }

  __syncthreads();
  T* ob = o + (size_t(b) * H + size_t(kh) * G) * D;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * NT;
    if (e < G * D) store(ob + e, acc[i] / fmaxf(Ls[e / D], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, const void* k_new, const void* v_new,
                   void* o, int B, int Smax, int H, int K, int D,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / K, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  decode_kernel<T><<<dim3(K, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(o), Smax, H, K, D,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).
// k_new and v_new are both null (no in-flight entry) or both set.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    const void* k_new, const void* v_new,
                                    void* o, int B, int Smax, int H, int K,
                                    int D, float scale, int dtype,
                                    void* stream) {
  if (K <= 0 || H % K != 0 || H / K > MAX_G || D > MAX_D || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return launch<float>(q, k, v, len, k_new, v_new, o, B, Smax, H, K, D,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, len, k_new, v_new, o, B, Smax, H,
                                 K, D, scale, s);
  return cudaErrorInvalidValue;
}
