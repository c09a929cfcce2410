// Mamba2 SSD intra-chunk (state-space duality) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:53
// (ssd_intra_chunk_pallas, body _ssd_kernel).  Same function, per
// (batch, chunk, head):
//
//   y[l, p]  = sum_{m <= l} (C[l] . B[m]) * exp(cum[l] - cum[m]) * dt[m] * x[m, p]
//   st[p, n] = sum_m exp(tot - cum[m]) * dt[m] * x[m, p] * B[m, n]
//
// with the decay masked to -inf above the diagonal BEFORE the exponential
// (cum[l] - cum[m] > 0 there and can overflow exp to inf, and inf * 0 is
// NaN).  Steps with dt = 0 (the padded tail of a ragged sequence) add
// exactly 0 to both outputs.
//
// Layout is the caller's (repro_torch.models.mamba2.ssd_chunked): x
// [b, nc, Q, H, P] float32 or bfloat16; dt and cum [b, nc, Q, H], tot
// [b, nc, H], B and C [b, nc, Q, 1, N] (one group, shared by every head),
// all float32; outputs y [b, nc, Q, H, P] and st [b, nc, H, P, N] float32.
// All contiguous.  Any Q >= 1 and H; P and N up to 128.
//
// What bounds it on an H100: at the serving prefill (Q = 8) launch
// latency; at a full chunk (Q = 256) the arithmetic, about Q*Q*(N + P)
// FMAs per head for y and Q*P*N for the state, which this first version
// does with fp32 FMAs out of shared memory (no tensor cores; the Pallas
// kernel's sharing of C.B across the heads of a block is not done here
// either, so the scores are recomputed per head).
//
// Two kernels behind one entry point:
//   ssd_y_kernel: one block owns BL = 64 rows l of one (batch, chunk,
//     head) and walks the m tiles up to its last row (tiles above the
//     diagonal are skipped).  Four threads share a row: each scores 16 of
//     a tile's 64 m against C[l] and then accumulates a quarter of the P
//     output columns.  A 256 x 256 f32 score tile would not fit in shared
//     memory; a 64 x 64 one does, recomputed per m tile.
//   ssd_state_kernel: one block owns PB = 16 rows p of one head's [P, N]
//     state and reduces over m in tiles of 64, each thread holding up to
//     8 of the block's 16 * N outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BL = 64;          // rows l per block (y)
constexpr int BM = 64;          // steps m per tile
constexpr int NT = 256;         // threads per block
constexpr int TPR = NT / BL;    // threads per row l
constexpr int MPT = BM / TPR;   // steps m scored per thread in a tile
constexpr int PB = 16;          // rows p per block (state)
constexpr int MAX_N = 128;
constexpr int OPT = PB * MAX_N / NT;   // state outputs per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t y_smem_bytes(int P, int N) {
  return sizeof(float) * (size_t(BL) * (N + 1) + size_t(BM) * (N + 1) +
                          size_t(BM) * P + size_t(BL) * (BM + 1) + 2 * BM);
}

template <typename T, int PMAX>
__global__ void __launch_bounds__(NT)
    ssd_y_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y, int Q,
                 int H, int P, int N) {
  constexpr int PPT = PMAX / TPR;   // output columns per thread
  const int NP = N + 1;             // padded rows: no bank conflicts
  extern __shared__ float smem[];
  float* Cs = smem;                 // [BL][N + 1]
  float* Bs = Cs + BL * NP;         // [BM][N + 1]
  float* Xs = Bs + BM * NP;         // [BM][P]
  float* Ws = Xs + BM * P;          // [BL][BM + 1]
  float* cm = Ws + BL * (BM + 1);   // [BM] cum of the tile's steps
  float* dm = cm + BM;              // [BM] dt of the tile's steps

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int l0 = blockIdx.x * BL;
  const int h = blockIdx.y;
  const size_t bc = blockIdx.z;     // batch * nc + chunk
  const T* xb = x + bc * Q * H * P;
  const float* dtb = dt + bc * Q * H;
  const float* cb = cum + bc * Q * H;
  const float* Bb = Bm + bc * Q * N;
  const float* Cb = Cm + bc * Q * N;

  for (int e = tid; e < BL * N; e += NT) {
    const int r = e / N, n = e % N;
    Cs[r * NP + n] = l0 + r < Q ? Cb[size_t(l0 + r) * N + n] : 0.f;
  }
  const int l = l0 + row;
  const float cum_l = l < Q ? cb[size_t(l) * H + h] : 0.f;
  float acc[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) acc[j] = 0.f;

  const int m_end = min(Q, l0 + BL);   // causal: m <= l < l0 + BL
  for (int m0 = 0; m0 < m_end; m0 += BM) {
    __syncthreads();   // Cs written / the last tile no longer read
    for (int e = tid; e < BM * N; e += NT) {
      const int r = e / N, n = e % N;
      Bs[r * NP + n] = m0 + r < Q ? Bb[size_t(m0 + r) * N + n] : 0.f;
    }
    for (int e = tid; e < BM * P; e += NT) {
      const int r = e / P, p = e % P;
      Xs[r * P + p] =
          m0 + r < Q ? to_f(xb[(size_t(m0 + r) * H + h) * P + p]) : 0.f;
    }
    if (tid < BM) {
      const bool in = m0 + tid < Q;
      cm[tid] = in ? cb[size_t(m0 + tid) * H + h] : 0.f;
      dm[tid] = in ? dtb[size_t(m0 + tid) * H + h] : 0.f;
    }
    __syncthreads();

    // scores of this thread's row against steps lane + TPR * j
    float s[MPT];
#pragma unroll
    for (int j = 0; j < MPT; ++j) s[j] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float c = Cs[row * NP + n];
#pragma unroll
      for (int j = 0; j < MPT; ++j) s[j] += c * Bs[(lane + TPR * j) * NP + n];
    }
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      const int c = lane + TPR * j;
      const int m = m0 + c;
      // mask before the exponential: exp(-inf) = 0
      const float dec = (l < Q && m <= l) ? cum_l - cm[c] : -INFINITY;
      Ws[row * (BM + 1) + c] = s[j] * expf(dec) * dm[c];
    }
    __syncwarp();      // the row's weights are written and read by one warp

    const int nm = min(BM, Q - m0);
    for (int c = 0; c < nm; ++c) {
      const float w = Ws[row * (BM + 1) + c];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int p = lane + TPR * j;
        if (p < P) acc[j] += w * Xs[c * P + p];
      }
    }
  }

  if (l < Q) {
    float* yb = y + (bc * Q + l) * H * P + size_t(h) * P;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = lane + TPR * j;
      if (p < P) yb[p] = acc[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
    ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum,
                     const float* __restrict__ tot,
                     const float* __restrict__ Bm, float* __restrict__ st,
                     int Q, int H, int P, int N) {
  __shared__ float Ws[BM * PB];      // exp(tot - cum[m]) * dt[m] * x[m, p]
  __shared__ float Bs[BM * MAX_N];   // B[m, n]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const size_t bc = blockIdx.z;
  const T* xb = x + bc * Q * H * P;
  const float* dtb = dt + bc * Q * H;
  const float* cb = cum + bc * Q * H;
  const float* Bb = Bm + bc * Q * N;
  const float tot_h = tot[bc * H + h];

  // this thread's outputs e = tid + NT * k of the block's [PB][N]
  int pp[OPT], nn[OPT];
  float acc[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int e = tid + NT * k;
    pp[k] = e / N;
    nn[k] = e % N;
    acc[k] = 0.f;
  }

  for (int m0 = 0; m0 < Q; m0 += BM) {
    __syncthreads();   // the last tile is no longer read
    for (int e = tid; e < BM * PB; e += NT) {
      const int r = e / PB, q = e % PB;
      const int m = m0 + r, p = p0 + q;
      float v = 0.f;
      if (m < Q && p < P) {
        const size_t mh = size_t(m) * H + h;
        v = expf(tot_h - cb[mh]) * dtb[mh] * to_f(xb[mh * P + p]);
      }
      Ws[e] = v;
    }
    for (int e = tid; e < BM * N; e += NT) {
      const int r = e / N, n = e % N;
      Bs[r * N + n] = m0 + r < Q ? Bb[size_t(m0 + r) * N + n] : 0.f;
    }
    __syncthreads();
    const int nm = min(BM, Q - m0);
    for (int c = 0; c < nm; ++c) {
#pragma unroll
      for (int k = 0; k < OPT; ++k)
        if (pp[k] < PB) acc[k] += Ws[c * PB + pp[k]] * Bs[c * N + nn[k]];
    }
  }

#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int p = p0 + pp[k];
    if (pp[k] < PB && p < P)
      st[((bc * H + h) * P + p) * N + nn[k]] = acc[k];
  }
}

template <typename T, int PMAX>
cudaError_t launch(const void* x, const void* dt, const void* cum,
                   const void* tot, const void* B, const void* C, void* y,
                   void* st, int BC, int Q, int H, int P, int N,
                   cudaStream_t stream) {
  const size_t smem = y_smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel<T, PMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* cumf = static_cast<const float*>(cum);
  const float* Bf = static_cast<const float*>(B);
  ssd_y_kernel<T, PMAX><<<dim3((Q + BL - 1) / BL, H, BC), NT, smem, stream>>>(
      xt, dtf, cumf, Bf, static_cast<const float*>(C),
      static_cast<float*>(y), Q, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_kernel<T><<<dim3((P + PB - 1) / PB, H, BC), NT, 0, stream>>>(
      xt, dtf, cumf, static_cast<const float*>(tot), Bf,
      static_cast<float*>(st), Q, H, P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const void* x, const void* dt, const void* cum,
                       const void* tot, const void* B, const void* C,
                       void* y, void* st, int BC, int Q, int H, int P, int N,
                       cudaStream_t s) {
  if (P <= 32)
    return launch<T, 32>(x, dt, cum, tot, B, C, y, st, BC, Q, H, P, N, s);
  if (P <= 64)
    return launch<T, 64>(x, dt, cum, tot, B, C, y, st, BC, Q, H, P, N, s);
  if (P <= 128)
    return launch<T, 128>(x, dt, cum, tot, B, C, y, st, BC, Q, H, P, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launches (0 when both were accepted).
// x_dtype: 0 = float32, 1 = bfloat16 (every other input is float32).
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt,
                                   const void* cum, const void* tot,
                                   const void* B, const void* C, void* y,
                                   void* st, int b, int nc, int Q, int H,
                                   int P, int N, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > MAX_N || P < 1 || Q < 1 || H < 1 || b * nc < 1 ||
      b * nc > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (x_dtype == 0)
    return dispatch_p<float>(x, dt, cum, tot, B, C, y, st, b * nc, Q, H, P,
                             N, s);
  if (x_dtype == 1)
    return dispatch_p<__nv_bfloat16>(x, dt, cum, tot, B, C, y, st, b * nc,
                                     Q, H, P, N, s);
  return cudaErrorInvalidValue;
}
