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
// all contiguous, float32 or bfloat16.  D in {16, 32, 64, 80, 128, 256}.
// Unlike the TPU kernel, a ragged last tile (Sq or Skv not a multiple of
// the tile) is masked here rather than refused.
//
// What bounds it on an H100: at the serving path's prefill (S = 8) it is
// launch latency; at long S it is the arithmetic, 4*S*S*D per head (half
// of it when causal).  Two kernels behind one entry point:
//
// - bfloat16, flash_mma_kernel<D>: the products run on the tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 accumulators).  One block of four
//   warps owns 64 query rows of one head, each warp 16 rows; the warp's
//   queries stay in registers as A fragments (ldmatrix), so their staging
//   tile borrows a K/V buffer.  K and V tiles of 64 keys arrive in bf16
//   through a double-buffered cp.async ring in shared memory (rows padded
//   by 16 bytes, so the ldmatrix rows do not conflict on banks), the next
//   tile loading while the current one is used.  At D = 256 a warp's O
//   accumulators alone take 128 registers a thread, so its queries stay
//   in a shared-memory tile of their own and their fragments are read
//   again for each 16 columns of every key tile (a quarter more ldmatrix
//   traffic than K's) instead of being held in registers, and the online
//   softmax takes each key tile in two steps of 32 keys (S's
//   accumulators halved), which keeps the kernel within 255 registers
//   without spills.  S = Q.K^T stays in the
//   accumulator fragments; the online softmax runs on them in fp32 (row
//   max and sum over the four lanes of a quad), and P is rounded to bf16
//   in registers to become the A operand of O += P.V (V through
//   ldmatrix.trans).  A causal block takes two query tiles, one from each
//   end, so that every block walks about the same number of key tiles;
//   only the diagonal tile is masked.  What bounds it now: each warp
//   reads the whole K and V tile from shared memory for its 16 rows, 32
//   KB of ldmatrix per 128 mma at D = 128, so shared-memory bandwidth
//   before the tensor cores; and mma.sync reaches only part of the rate
//   wgmma would.
// - float32, flash_fwd_kernel<float, D>: fp32 FMAs out of shared memory
//   (K and V staged as fp32, one padding float per row; four threads per
//   query row; at D = 256 the tiles take 213,760 bytes, one block an
//   SM).  Tensor cores would take TF32 for fp32 inputs, which keeps ~3
//   decimal digits and breaks the 2e-5 tolerance the float32 checks
//   hold, so float32 stays on the FMA units.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads per block (float32 kernel)
constexpr int TPR = NT / BQ;     // threads per query row
constexpr int KPT = BK / TPR;    // keys per thread in a tile
constexpr int NT_MMA = 128;      // threads per block (bf16 kernel)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---- bfloat16 on the tensor cores ----------------------------------------

// 16 bytes from global to shared memory, asynchronously; zeros when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int D>
constexpr int MMA_LD = D + 8;               // bf16 row stride in shared

// q's A fragments stay in registers up to D = 128; at D = 256 the 128
// registers a thread holds of O leave no room for them
template <int D>
constexpr bool Q_IN_REGS = D <= 128;

// 2 x (K, V) tiles; Q in V's second buffer until tile 1 loads, or, when
// its fragments are not held in registers, in a tile of its own after V
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(MMA_LD<D>) *
         (4 * BK + (Q_IN_REGS<D> ? 0 : BQ));
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): the
// accumulator c holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at
// columns 2t, 2t + 1 of its 8-column tile.
template <int D>
__global__ void __launch_bounds__(NT_MMA)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                     int K, float scale_log2, int causal) {
  constexpr int LD = MMA_LD<D>;
  constexpr int CH = D / 8;        // 16-byte chunks per row
  // keys per softmax step: the whole tile, or at D = 256 half of it, so
  // that S's accumulators (KW / 2 a thread) fit beside O's 128 without
  // spilling
  constexpr int KW = Q_IN_REGS<D> ? BK : BK / 2;
  constexpr int NKT = KW / 8;      // 8-key column tiles of S
  constexpr int NDT = D / 8;       // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;    // [2][BK][LD]
  __nv_bfloat16* Qs =                      // [BQ][LD]
      Vs + (Q_IN_REGS<D> ? BK * LD : 2 * BK * LD);
  static_assert(BQ == BK, "Q borrows the second V buffer");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / K);
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(K) * D;
  const __nv_bfloat16* qb = q + size_t(b) * Sq * q_stride + size_t(h) * D;
  const __nv_bfloat16* kb = k + size_t(b) * Skv * kv_stride + size_t(kh) * D;
  const __nv_bfloat16* vb = v + size_t(b) * Skv * kv_stride + size_t(kh) * D;

  // the query rows [q0, q0 + BQ): load them, walk the key tiles, store
  auto attend = [&](int q0) {
    for (int e = tid; e < BQ * CH; e += NT_MMA) {
      const int r = e / CH, c = e % CH;
      const bool ok = q0 + r < Sq;
      cp_async16(Qs + r * LD + c * 8,
                 qb + (ok ? size_t(q0 + r) * q_stride + c * 8 : 0), ok);
    }
    const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
    const int n_tiles = (kv_end + BK - 1) / BK;
    auto load_kv = [&](int t) {
      const int k0 = t * BK;
      __nv_bfloat16* kd = Ks + (t & 1) * BK * LD;
      __nv_bfloat16* vd = Vs + (t & 1) * BK * LD;
      for (int e = tid; e < BK * CH; e += NT_MMA) {
        const int r = e / CH, c = e % CH;
        const bool ok = k0 + r < Skv;
        const size_t off = ok ? size_t(k0 + r) * kv_stride + c * 8 : 0;
        cp_async16(kd + r * LD + c * 8, kb + off, ok);
        cp_async16(vd + r * LD + c * 8, vb + off, ok);
      }
    };
    if (n_tiles > 0) load_kv(0);
    cp_async_commit();

    const int wq0 = q0 + warp * 16;          // this warp's first query row
    const int row_a = wq0 + lane / 4, row_b = row_a + 8;
    uint32_t qf[Q_IN_REGS<D> ? D / 16 : 1][4];
    float acc[NDT][4];
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<0>();    // tile t (and, before tile 0, Q)
      __syncthreads();       // ... for every thread; tile t - 1 is done with
      if constexpr (Q_IN_REGS<D>) {
        if (t == 0) {
#pragma unroll
          for (int kc = 0; kc < D / 16; ++kc)
            ldmatrix_x4(qf[kc], Qs + (warp * 16 + (lane & 15)) * LD +
                                    kc * 16 + (lane >> 4) * 8);
          __syncthreads();   // Q's buffer is free for tile 1
        }
      }
      if (t + 1 < n_tiles) { // the next tile lands while this one is used
        load_kv(t + 1);
        cp_async_commit();
      }
      const __nv_bfloat16* Kt = Ks + (t & 1) * BK * LD;
      const __nv_bfloat16* Vt = Vs + (t & 1) * BK * LD;

#pragma unroll 1
      for (int h0 = 0; h0 < BK; h0 += KW) {
        float s[NKT][4];
#pragma unroll
        for (int j = 0; j < NKT; ++j)
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t qa[4];
          if constexpr (Q_IN_REGS<D>) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = qf[kc][i];
          } else {
            ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                                (lane >> 4) * 8);
          }
#pragma unroll
          for (int np = 0; np < NKT / 2; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, Kt + (h0 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     LD + kc * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qa, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          }
        }

        // scale into log2 units; mask the ragged end and, on the diagonal,
        // the keys above each row
        const int k0 = t * BK + h0;
        const bool masked = k0 + KW > Skv || (causal && k0 + KW - 1 > wq0);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = s[j][i] * scale_log2;
            if (masked) {
              const int kpos = k0 + j * 8 + 2 * (lane & 3) + (i & 1);
              const int qpos = i < 2 ? row_a : row_b;
              if (kpos >= Skv || (causal && kpos > qpos)) x = -INFINITY;
            }
            s[j][i] = x;
          }
          mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // a row with every key so far masked subtracts 0: exp2(-inf) = 0
        const float sub_a = mn_a == -INFINITY ? 0.f : mn_a;
        const float sub_b = mn_b == -INFINITY ? 0.f : mn_b;
        const float corr_a = exp2f(m_a - sub_a), corr_b = exp2f(m_b - sub_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
          s[j][0] = exp2f(s[j][0] - sub_a);
          s[j][1] = exp2f(s[j][1] - sub_a);
          s[j][2] = exp2f(s[j][2] - sub_b);
          s[j][3] = exp2f(s[j][3] - sub_b);
          ps_a += s[j][0] + s[j][1];
          ps_b += s[j][2] + s[j][3];
        }
        l_a = l_a * corr_a + ps_a;     // this lane's columns; summed at the end
        l_b = l_b * corr_b + ps_b;
#pragma unroll
        for (int j = 0; j < NDT; ++j) {
          acc[j][0] *= corr_a;
          acc[j][1] *= corr_a;
          acc[j][2] *= corr_b;
          acc[j][3] *= corr_b;
        }

        // O += P.V: two 8-key accumulator tiles of S make one A fragment
#pragma unroll
        for (int kc = 0; kc < KW / 16; ++kc) {
          const uint32_t pa[4] = {
              pack_bf16(s[2 * kc][0], s[2 * kc][1]),
              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
          for (int dp = 0; dp < NDT / 2; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, Vt + (h0 + kc * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * LD +
                                      dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
    cp_async_wait<0>();

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int d = j * 8 + 2 * (lane & 3);
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            o + (size_t(b) * Sq + row_a) * q_stride + size_t(h) * D + d) =
            __floats2bfloat162_rn(acc[j][0] * inv_a, acc[j][1] * inv_a);
      if (row_b < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            o + (size_t(b) * Sq + row_b) * q_stride + size_t(h) * D + d) =
            __floats2bfloat162_rn(acc[j][2] * inv_b, acc[j][3] * inv_b);
    }
  };

  // causal: block x takes query tiles nq - 1 - x and x, so that every
  // block walks about the same number of key tiles
  const int nq = (Sq + BQ - 1) / BQ, x = blockIdx.x;
  if (!causal) {
    attend(x * BQ);
    return;
  }
  attend((nq - 1 - x) * BQ);
  if (x != nq - 1 - x) {
    __syncthreads();   // the buffers are refilled
    attend(x * BQ);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int H, int K, float scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<float, D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, K,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Skv, int H, int K, float scale,
                        int causal, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return err;
  }
  const int nq = (Sq + BQ - 1) / BQ;
  const dim3 grid(causal ? (nq + 1) / 2 : nq, H, B);
  flash_mma_kernel<D><<<grid, NT_MMA, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Skv, H, K, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int Sq, int Skv, int H, int K, float scale,
                   int causal, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, B, Sq, Skv, H, K, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).
// dtype: 0 = float32, 1 = bfloat16 (pointers 16-byte aligned).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Skv, int H, int K, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
    case 32: return launch<32>(dtype, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
    case 80: return launch<80>(dtype, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
    case 256: return launch<256>(dtype, q, k, v, o, B, Sq, Skv, H, K, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
