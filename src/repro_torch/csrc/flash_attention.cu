// Flash-attention forward (GQA, causal or not) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:71
// (flash_attention_pallas, body _attn_kernel).  Same function: online
// softmax over key tiles with the running (acc, m, l) in fp32, causal
// masking aligned top-left (query i sees keys 0..i; the callers require
// Sq == Skv when causal), key tiles above the diagonal skipped, fully
// masked rows zeroed and l clamped to 1e-30.
//
// Layout is the model's: q [B, Sq, H, D], k and v [B, Skv, K, D] with
// K dividing H (query head h reads kv head h / (H / K)), o [B, Sq, H, D],
// all contiguous, float32 or bfloat16.  D in {16, 32, 64, 80, 128}.
// Unlike the TPU kernel, a ragged last tile (Sq or Skv not a multiple of
// the tile) is masked here rather than refused.
//
// What bounds it on an H100: at the serving path's prefill (S = 8) it is
// launch latency; at long S it is the arithmetic, 4*S*S*D per head (half
// of it when causal), which this first version does with fp32 FMAs out of
// shared memory rather than on the tensor cores (wgmma), so it runs far
// below the card's 989 TFLOP/s bf16 peak.  One block owns 64 query rows
// of one head; four threads share each row, splitting its 64 keys per
// tile for the scores and its D output columns for P.V.  K and V tiles
// are staged in shared memory as fp32, padded by one float per row so
// that the column reads do not conflict on banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads per block
constexpr int TPR = NT / BQ;     // threads per query row
constexpr int KPT = BK / TPR;    // keys per thread in a tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int H, int K, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / TPR;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP], pre-scaled
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const size_t q_stride = size_t(H) * D;     // between sequence positions
  const size_t kv_stride = size_t(K) * D;
  const T* qb = q + size_t(b) * Sq * q_stride + size_t(h) * D;
  const T* kb = k + size_t(b) * Skv * kv_stride + size_t(kh) * D;
  const T* vb = v + size_t(b) * Skv * kv_stride + size_t(kh) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f(qb[size_t(q0 + r) * q_stride + d]) * scale;
    Qs[r * DP + d] = x;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;
  const int qpos = q0 + row;
  // causal: keys past this tile's last query row are never visible
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // Qs written / last tile's Ks, Vs no longer read
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Skv) {
        const size_t off = size_t(k0 + c) * kv_stride + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    // scores of this thread's row against keys lane + TPR * j
    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[row * DP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qd * Ks[(lane + TPR * j) * DP + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + lane + TPR * j;
      if (kpos >= Skv || (causal && kpos > qpos)) s[j] = NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    // the TPR threads of a row are neighbouring lanes of one warp
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = s[j] <= NEG_INF / 2 ? 0.f : expf(s[j] - m_new);
      Ps[row * (BK + 1) + lane + TPR * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();      // the row's P is written and read by its own warp

    const int nk = min(BK, Skv - k0);
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= corr;
    for (int c = 0; c < nk; ++c) {
      const float p = Ps[row * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += p * Vs[c * D + lane + TPR * j];
    }
  }

  if (qpos < Sq) {
    const float lc = fmaxf(l, 1e-30f);
    T* ob = o + (size_t(b) * Sq + qpos) * q_stride + size_t(h) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(ob + lane + TPR * j, acc[j] / lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int H, int K, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, K, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int Sq, int Skv, int H, int K,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Skv, int H, int K, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, K, scale,
                                     causal, s);
  return cudaErrorInvalidValue;
}
