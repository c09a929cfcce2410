// Decode attention (one query token per sequence against a KV cache) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:69
// (decode_attention_pallas, body _decode_kernel): q [B, H, D] against
// caches k, v [B, Smax, K, D], cache positions >= kv_len[b] masked and
// rows past kv_len never read, online softmax in fp32, l clamped to
// 1e-30 (so kv_len = 0 gives a zero output).  It adds what the TPU kernel
// lacked and the model's decode needs (repro.models.layers
// .decode_attention with extra_kv): an optional in-flight entry
// k_new, v_new [B, K, D] that joins the softmax beside the cache, so that
// a step attends before it commits its own key and value.
//
// What bounds it on an H100: the bytes of the cache prefix it reads,
// 2 * kv_len * K * D elements per sequence, a few MB per layer at the
// serving path's shapes (32 slots, Smax = 192), i.e. about a microsecond
// at 3.35 TB/s; so in practice the latency of one block's chain of loads,
// products and reductions.  The design:
//
// - one block per (kv head, sequence), reading each cache row once for
//   the G = H / K query heads that share it: rows come in tiles of 64
//   through cp.async, 16 bytes a thread, the next tile landing while this
//   one is used.
// - bfloat16 with D in {16, 32, 64, 80, 128, 256}, decode_mma_kernel<D,
//   I8>: the G heads are the 16 rows (padded) of an mma.sync m16n8k16
//   tile, so Q.K^T and P.V run on the tensor cores with fp32
//   accumulators, K and V through ldmatrix, q in registers up to D = 128
//   (at D = 256 the 128 accumulator registers of O leave no room: its
//   fragments are read again from shared memory for each 16 columns);
//   each warp takes 16 rows of every tile with its own online softmax,
//   and the four warps' states merge at the end.  At G = 1 (gemma-7b)
//   15 of the 16 rows are padding.
//   Scalar code has to read q from shared memory again for every row;
//   that shared-memory traffic, not HBM, bound the scalar version.
// - float32, or another head dim: decode_fma_kernel<T, VEC, I8>, fp32
//   FMAs with the scores in shared memory (element loads where a row is
//   not a multiple of 16 bytes).
// - an int8 cache (I8) with float32 per-token-head scales k_scale,
//   v_scale [B, Smax, K], as repro.models.layers.decode_attention reads
//   one: the tile's cache rows arrive as int8 (one 16-byte cp.async
//   carries 16 elements, half the bytes of bf16) into a staging buffer,
//   the next tile landing while this one is used, and are converted to
//   the kernel's working type in shared memory (exact: |x| <= 127); the
//   in-flight entry, not quantized, is copied in beside them.  Each
//   score is multiplied by its row's k_scale before the mask, and each
//   softmax weight by its row's v_scale after the row sum is taken and
//   before P.V, so no dequantized copy of V is formed.
//
// At a long cache and few sequences, B * K blocks leave most SMs idle and
// each walks its prefix alone; cutting the prefix into ranges (split-KV)
// would fill the card there, but no serving path of the port has such a
// cache yet (chip_smoke.py times the case "long" to show the cost).
//
// G <= 16, D <= 256; an int8 cache needs D % 16 == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;           // rows per tile
constexpr int NT = 128;          // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAX_G = 16;
constexpr int MAX_D = 256;
constexpr int HPT = MAX_G;       // most query heads a thread accumulates
constexpr float LOG2E = 1.4426950408889634f;
static_assert(NT == 2 * BK, "two threads score each row of a tile");
static_assert(NWARP * 16 == BK, "four warps of 16 rows cover a tile");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// two neighbouring elements of a shared-memory row, as floats
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// W = 16 / sizeof(T) neighbouring elements of a shared-memory row
__device__ __forceinline__ void chunk(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void chunk(const __nv_bfloat16* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
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
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
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

// 16 int8 values (16-byte aligned) as 16 elements of the working type
// (16-byte aligned): exact, |x| <= 127 fits bf16's 8-bit significand
__device__ __forceinline__ void widen16(const int8_t* src, float* dst) {
  const int4 a = *reinterpret_cast<const int4*>(src);
  const int8_t* x = reinterpret_cast<const int8_t*>(&a);
#pragma unroll
  for (int w = 0; w < 4; ++w)
    reinterpret_cast<float4*>(dst)[w] =
        make_float4(x[4 * w], x[4 * w + 1], x[4 * w + 2], x[4 * w + 3]);
}
__device__ __forceinline__ void widen16(const int8_t* src,
                                        __nv_bfloat16* dst) {
  const int4 a = *reinterpret_cast<const int4*>(src);
  const int8_t* x = reinterpret_cast<const int8_t*>(&a);
  uint4 out[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(out);
#pragma unroll
  for (int w = 0; w < 8; ++w)
    h[w] = __floats2bfloat162_rn(float(x[2 * w]), float(x[2 * w + 1]));
  reinterpret_cast<uint4*>(dst)[0] = out[0];
  reinterpret_cast<uint4*>(dst)[1] = out[1];
}

// The rows of this block (kv head blockIdx.x of sequence blockIdx.y): the
// sequence's cache prefix, then the in-flight entry when there is one.
struct Rows {
  int n_cache, rows, n_tiles, K;
  size_t cache0, new0, stride;   // element offsets; stride between rows
  size_t scale0;                 // row 0's scale (int8 cache); stride K

  __device__ Rows(const int* kv_len, bool has_new, int Smax, int K_, int D)
      : K(K_) {
    const int kh = blockIdx.x, b = blockIdx.y;
    n_cache = min(max(kv_len[b], 0), Smax);
    rows = n_cache + (has_new ? 1 : 0);
    n_tiles = (rows + BK - 1) / BK;
    stride = size_t(K) * D;
    cache0 = size_t(b) * Smax * stride + size_t(kh) * D;
    new0 = (size_t(b) * K + kh) * D;
    scale0 = size_t(b) * Smax * K + kh;
  }

  // rows [t * BK, t * BK + BK) into dst (row stride ld), W elements a
  // copy: 16-byte cp.async when VEC, else plain element copies
  template <typename T, bool VEC>
  __device__ void load(int t, const T* cache, const T* entry, T* dst, int D,
                       int ld) const {
    constexpr int W = VEC ? 16 / sizeof(T) : 1;
    const int t0 = t * BK, nr = min(BK, rows - t0), per_row = D / W;
    for (int e = threadIdx.x; e < nr * per_row; e += NT) {
      const int r = e / per_row, c = (e % per_row) * W;
      const int i = t0 + r;
      const T* src = i < n_cache ? cache + cache0 + size_t(i) * stride
                                 : entry + new0;
      if constexpr (VEC)
        cp_async16(dst + r * ld + c, src + c);
      else
        dst[r * ld + c] = src[c];
    }
  }

  // the cache rows of tile t of an int8 cache (not the in-flight entry)
  // into dst [BK][D], 16 elements a cp.async
  __device__ void load_i8(int t, const int8_t* cache, int8_t* dst,
                          int D) const {
    const int t0 = t * BK, nr = min(BK, n_cache - t0), per_row = D / 16;
    for (int e = threadIdx.x; e < nr * per_row; e += NT) {
      const int r = e / per_row, c = (e % per_row) * 16;
      cp_async16(dst + r * D + c,
                 cache + cache0 + size_t(t0 + r) * stride + c);
    }
  }

  // tile t of an int8 cache, staged by load_i8 in k8, v8, into the
  // working type at Kt, Vt (row stride ld), each row's scales into Ksc,
  // Vsc: cache rows widened, the in-flight entry copied with scales 1,
  // rows past the tile's end up to a multiple of 16 zeroed (V there meets
  // P = 0 on the tensor cores: stale bits could be NaN) with scales 1
  template <typename T>
  __device__ void convert_i8(int t, const int8_t* k8, const int8_t* v8,
                             const T* k_new, const T* v_new,
                             const float* ksc, const float* vsc, T* Kt,
                             T* Vt, float* Ksc, float* Vsc, int D,
                             int ld) const {
    const int t0 = t * BK, nr = min(BK, rows - t0);
    const int pad = (nr + 15) / 16 * 16, per_row = D / 16;
    for (int e = threadIdx.x; e < pad * per_row; e += NT) {
      const int r = e / per_row, c = (e % per_row) * 16, i = t0 + r;
      T* kd = Kt + r * ld + c;
      T* vd = Vt + r * ld + c;
      if (i < n_cache) {
        widen16(k8 + r * D + c, kd);
        widen16(v8 + r * D + c, vd);
      } else if (r < nr) {     // the in-flight entry
#pragma unroll
        for (int w = 0; w < 16; ++w) {
          kd[w] = k_new[new0 + c + w];
          vd[w] = v_new[new0 + c + w];
        }
      } else {
#pragma unroll
        for (int w = 0; w < 16; ++w) {
          store(kd + w, 0.f);
          store(vd + w, 0.f);
        }
      }
    }
    for (int r = threadIdx.x; r < BK; r += NT) {
      const int i = t0 + r;
      const bool cached = r < nr && i < n_cache;
      Ksc[r] = cached ? ksc[scale0 + size_t(i) * K] : 1.f;
      Vsc[r] = cached ? vsc[scale0 + size_t(i) * K] : 1.f;
    }
  }
};

// The block's output: o [G][D] (not yet divided by l) and l [G] from
// shared memory, l clamped to 1e-30 (no rows: o = 0, l = 0 -> zeros).
template <typename T>
__device__ void finish(const float* Os, const float* Ls, T* __restrict__ o,
                       int H, int D) {
  const int K = gridDim.x, G = H / K;
  T* ob = o + (size_t(blockIdx.y) * K + blockIdx.x) * G * D;
  for (int e = threadIdx.x; e < G * D; e += NT)
    store(ob + e, Os[e] / fmaxf(Ls[e / D], 1e-30f));
}

template <bool I8, typename T>
using Cache = std::conditional_t<I8, int8_t, T>;   // a cache element

// ---- bfloat16, D in {16, 32, 64, 80, 128, 256}: the tensor cores --------

template <int D>
constexpr int MMA_LD = D + 8;    // bf16 row stride: an odd number of 16 B

constexpr int STAGES = 2;        // bf16 cache tiles in flight

// q's A fragments stay in registers up to D = 128; at D = 256 the 128
// registers a thread holds of O leave no room for them
template <int D>
constexpr bool Q_IN_REGS = D <= 128;

// bf16 cache: STAGES x (K, V) tiles, then Q.  int8 cache: the int8
// (K, V) staging tile, the converted (K, V) tile, Q, the two tiles' scales.
template <int D, bool I8>
constexpr size_t mma_smem_bytes() {
  return I8 ? 2 * size_t(BK) * D +
                  sizeof(__nv_bfloat16) * size_t(MMA_LD<D>) * (2 * BK + 16) +
                  2 * sizeof(float) * BK
            : sizeof(__nv_bfloat16) * size_t(MMA_LD<D>) *
                  (STAGES * 2 * BK + 16);
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): the
// accumulator c holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at
// columns 2t, 2t + 1 of its 8-column tile.  Rows are query heads here.
template <int D, bool I8>
__global__ void __launch_bounds__(NT)
    decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const Cache<I8, __nv_bfloat16>* __restrict__ kc,
                      const Cache<I8, __nv_bfloat16>* __restrict__ vc,
                      const float* __restrict__ ksc,
                      const float* __restrict__ vsc,
                      const int* __restrict__ kv_len,
                      const __nv_bfloat16* __restrict__ k_new,
                      const __nv_bfloat16* __restrict__ v_new,
                      __nv_bfloat16* __restrict__ o, int Smax, int H,
                      float scale_log2) {
  constexpr int LD = MMA_LD<D>;
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int NDT = D / 8;       // 8-wide column tiles of O
  constexpr int TILE = BK * LD;    // elements of one K or V tile
  constexpr int NKV = I8 ? 1 : STAGES;        // bf16 (K, V) tiles
  constexpr size_t I8_BYTES = I8 ? 2 * size_t(BK) * D : 0;
  const int K = gridDim.x, G = H / K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // int8 cache: the staging tile first
  int8_t* K8 = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* V8 = K8 + BK * D;
  // bf16 cache: stage s holds tile t = s (mod STAGES), K at Ks + s * TILE,
  // V after; int8 cache: the converted tile
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + I8_BYTES);
  __nv_bfloat16* Vs = Ks + NKV * TILE;
  __nv_bfloat16* Qs = Vs + NKV * TILE;  // [16][LD], heads >= G are zeros
  float* Ksc = reinterpret_cast<float*>(Qs + 16 * LD);  // [BK], int8 cache
  float* Vsc = Ksc + BK;
  // once the tiles are done, over them: the warps' states, then the
  // block's (l, o)
  float* Mw = reinterpret_cast<float*>(smem_raw);       // [NWARP][16]
  float* Lw = Mw + NWARP * 16;                          // [NWARP][16]
  float* Ow = Lw + NWARP * 16;                          // [NWARP][16][D]
  float* Ls = Ow + NWARP * 16 * D;                      // [16]
  float* Os = Ls + 16;                                  // [16][D]
  static_assert(sizeof(float) * (NWARP * 16 * (D + 2) + 16 * (D + 1)) <=
                    I8_BYTES + sizeof(__nv_bfloat16) * 2 * NKV * TILE,
                "the merge fits over the tiles");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Rows rw(kv_len, k_new != nullptr, Smax, K, D);
  // tile t as one cp.async group (empty past the last tile, so that group
  // t is tile t): a bf16 cache into its stage, V rows past the tile's end
  // zeroed (they meet P = 0 on the tensor cores: stale bits, NaN, would
  // add NaN); an int8 cache's rows into the staging tile
  auto fetch = [&](int t) {
    if (t < rw.n_tiles) {
      if constexpr (I8) {
        rw.load_i8(t, kc, K8, D);
        rw.load_i8(t, vc, V8, D);
      } else {
        __nv_bfloat16* kd = Ks + (t % STAGES) * TILE;
        __nv_bfloat16* vd = Vs + (t % STAGES) * TILE;
        rw.load<__nv_bfloat16, true>(t, kc, k_new, kd, D, LD);
        rw.load<__nv_bfloat16, true>(t, vc, v_new, vd, D, LD);
        const int nr = min(BK, rw.rows - t * BK), pad = (nr + 15) / 16 * 16;
        for (int e = tid; e < (pad - nr) * CH; e += NT)
          *reinterpret_cast<uint4*>(vd + (nr + e / CH) * LD + (e % CH) * 8) =
              make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  fetch(0);
  const __nv_bfloat16* qb = q + (size_t(blockIdx.y) * H + blockIdx.x * G) * D;
  for (int e = tid; e < 16 * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) =
        r < G ? *reinterpret_cast<const uint4*>(qb + r * D + c)
              : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  uint32_t qf[Q_IN_REGS<D> ? D / 16 : 1][4];
  if constexpr (Q_IN_REGS<D>) {
#pragma unroll
    for (int kc2 = 0; kc2 < D / 16; ++kc2)
      ldmatrix_x4(qf[kc2],
                  Qs + (lane & 15) * LD + kc2 * 16 + (lane >> 4) * 8);
  }

  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const int wr0 = warp * 16;     // this warp's rows of each tile

  for (int t = 0; t < rw.n_tiles; ++t) {
    if constexpr (I8) {
      cp_async_wait<0>();        // tile t is staged ...
      __syncthreads();           // ... and tile t - 1's products are done
      rw.convert_i8(t, K8, V8, k_new, v_new, ksc, vsc, Ks, Vs, Ksc, Vsc, D,
                    LD);
      __syncthreads();
      fetch(t + 1);              // into the staging tile, now free
    } else {
      fetch(t + STAGES - 1);     // into the stage tile t - 1 has left
      cp_async_wait<STAGES - 1>(); // tile t has landed ...
      __syncthreads();             // ... for every thread
    }
    const int nr = min(BK, rw.rows - t * BK);
    if (wr0 < nr) {
      const __nv_bfloat16* Kt = Ks + (t % NKV) * TILE;
      const __nv_bfloat16* Vt = Vs + (t % NKV) * TILE;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc2 = 0; kc2 < D / 16; ++kc2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (wr0 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kc2 * 16 + ((lane >> 3) & 1) * 8);
        if constexpr (Q_IN_REGS<D>) {
          mma_bf16(s[0], qf[kc2], bk[0], bk[1]);
          mma_bf16(s[1], qf[kc2], bk[2], bk[3]);
        } else {
          uint32_t qa[4];
          ldmatrix_x4(qa, Qs + (lane & 15) * LD + kc2 * 16 + (lane >> 4) * 8);
          mma_bf16(s[0], qa, bk[0], bk[1]);
          mma_bf16(s[1], qa, bk[2], bk[3]);
        }
      }
      // online softmax in log2 units; an int8 cache's k_scale before the
      // mask
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wr0 + j * 8 + 2 * (lane & 3) + (i & 1);
          float x = s[j][i] * scale_log2;
          if constexpr (I8) x *= Ksc[r];
          s[j][i] = r < nr ? x : -INFINITY;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;                // finite: row wr0 of the tile is valid
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = exp2f(s[j][0] - mn_a);
        s[j][1] = exp2f(s[j][1] - mn_a);
        s[j][2] = exp2f(s[j][2] - mn_b);
        s[j][3] = exp2f(s[j][3] - mn_b);
      }
      l_a = l_a * corr_a + s[0][0] + s[0][1] + s[1][0] + s[1][1];
      l_b = l_b * corr_b + s[0][2] + s[0][3] + s[1][2] + s[1][3];
      if constexpr (I8) {        // v_scale, after the row sum
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[j][i] *= Vsc[wr0 + j * 8 + 2 * (lane & 3) + (i & 1)];
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        acc[2 * dp][0] *= corr_a;
        acc[2 * dp][1] *= corr_a;
        acc[2 * dp][2] *= corr_b;
        acc[2 * dp][3] *= corr_b;
        acc[2 * dp + 1][0] *= corr_a;
        acc[2 * dp + 1][1] *= corr_a;
        acc[2 * dp + 1][2] *= corr_b;
        acc[2 * dp + 1][3] *= corr_b;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (wr0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();             // tile t's buffers are free
  }
  cp_async_wait<0>();            // (only empty groups remain)

  // merge the four warps' states (each saw its own rows of every tile)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const int g = lane / 4;
  if (lane % 4 == 0) {
    Mw[warp * 16 + g] = m_a;
    Mw[warp * 16 + g + 8] = m_b;
    Lw[warp * 16 + g] = l_a;
    Lw[warp * 16 + g + 8] = l_b;
  }
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    float* oa = Ow + (warp * 16 + g) * D + j * 8 + 2 * (lane % 4);
    oa[0] = acc[j][0];
    oa[1] = acc[j][1];
    oa[8 * D] = acc[j][2];
    oa[8 * D + 1] = acc[j][3];
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += NT) {
    const int h = e / D, d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, Mw[w * 16 + h]);
    float x = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float m = Mw[w * 16 + h];
      const float wt = m == -INFINITY ? 0.f : exp2f(m - mx);
      lsum += wt * Lw[w * 16 + h];
      x += wt * Ow[(w * 16 + h) * D + d];
    }
    Os[e] = x;
    if (d == 0) Ls[h] = lsum;
  }
  __syncthreads();
  finish(Os, Ls, o, H, D);
}

// ---- float32, or another head dim -----------------------------------------

// Row stride in shared memory, in elements: a whole number of 16-byte
// units, and an odd one, so that eight rows read at one column fall on
// eight different bank groups.
int smem_ld(int D, int elem) {
  int units = (D * elem + 15) / 16;
  if (units % 2 == 0) ++units;
  return units * 16 / elem;
}

// (int8 cache: the int8 (K, V) staging tile,) the (K, V) tile, Q, P and
// the softmax state, (int8 cache: the tile's scales)
size_t smem_bytes(int G, int D, int ld, int elem, bool i8) {
  return (i8 ? 2 * size_t(BK) * D + 2 * sizeof(float) * BK : 0) +
         size_t(2) * BK * ld * elem +
         sizeof(float) * (size_t(G) * D + size_t(G) * BK + 3 * size_t(G));
}

template <typename T, bool VEC, bool I8>
__global__ void __launch_bounds__(NT)
    decode_fma_kernel(const T* __restrict__ q,
                      const Cache<I8, T>* __restrict__ kc,
                      const Cache<I8, T>* __restrict__ vc,
                      const float* __restrict__ ksc,
                      const float* __restrict__ vsc,
                      const int* __restrict__ kv_len,
                      const T* __restrict__ k_new,
                      const T* __restrict__ v_new, T* __restrict__ o,
                      int Smax, int H, int D, int ld, float scale) {
  static_assert(VEC || !I8, "an int8 cache is read 16 bytes a copy");
  constexpr int W = VEC ? 16 / sizeof(T) : 1;   // elements per load
  const int K = gridDim.x, G = H / K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* K8 = reinterpret_cast<int8_t*>(smem_raw);   // [BK][D], int8 cache
  int8_t* V8 = K8 + BK * D;
  T* Ks = reinterpret_cast<T*>(smem_raw + (I8 ? 2 * BK * D : 0)); // [BK][ld]
  T* Vs = Ks + BK * ld;                          // [BK][ld]
  float* Qs = reinterpret_cast<float*>(Vs + BK * ld);   // [G][D], scaled
  float* Ps = Qs + G * D;                        // [G][BK]
  float* Ms = Ps + G * BK;                       // [G] running max
  float* Ls = Ms + G;                            // [G] running sum
  float* Cs = Ls + G;                            // [G] this tile's correction
  float* Ksc = Cs + G;                           // [BK] int8 cache's scales
  float* Vsc = Ksc + BK;                         // [BK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Rows rw(kv_len, k_new != nullptr, Smax, K, D);
  if (rw.n_tiles > 0) {
    if constexpr (I8) {
      rw.load_i8(0, kc, K8, D);
      rw.load_i8(0, vc, V8, D);
    } else {
      rw.load<T, VEC>(0, kc, k_new, Ks, D, ld);
      cp_async_commit();
      rw.load<T, VEC>(0, vc, v_new, Vs, D, ld);
    }
    cp_async_commit();
  }
  const T* qb = q + (size_t(blockIdx.y) * H + blockIdx.x * G) * D;
  for (int e = tid; e < G * D; e += NT) Qs[e] = to_f(qb[e]) * scale;
  for (int g = tid; g < G; g += NT) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }

  // P.V mapping: thread -> a pair of columns and a slot; slot i takes
  // heads i, i + slots, ...
  const int n_pair = (D + 1) / 2;
  const int slots = NT / n_pair;                 // >= 1
  const int pcol = 2 * (tid % n_pair), slot = tid / n_pair;
  const bool pv_thread = slot < slots;
  float acc[HPT][2];
#pragma unroll
  for (int j = 0; j < HPT; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int t = 0; t < rw.n_tiles; ++t) {
    const int nr = min(BK, rw.rows - t * BK);
    const bool more = t + 1 < rw.n_tiles;
    if constexpr (I8) {
      cp_async_wait<0>();    // tile t is staged (and Qs written)
      __syncthreads();
      rw.convert_i8(t, K8, V8, k_new, v_new, ksc, vsc, Ks, Vs, Ksc, Vsc, D,
                    ld);
      __syncthreads();
      if (more) {            // the staging tile is free: the next tile
        rw.load_i8(t + 1, kc, K8, D);
        rw.load_i8(t + 1, vc, V8, D);
        cp_async_commit();
      }
    } else {
      cp_async_wait<1>();    // K of this tile; its V may still be landing
      __syncthreads();
    }
    // scores: thread -> row c = tid / 2 and heads hh, hh + 2, ...
    {
      const int c = tid / 2, hh = tid % 2;
      float s[MAX_G / 2];
#pragma unroll
      for (int j = 0; j < MAX_G / 2; ++j) s[j] = 0.f;
      if (c < nr) {
        for (int d = 0; d < D; d += W) {
          float kx[W];
          if constexpr (VEC)
            chunk(Ks + c * ld + d, kx);
          else
            kx[0] = to_f(Ks[c * ld + d]);
#pragma unroll
          for (int j = 0; j < MAX_G / 2; ++j) {
            const int g = hh + 2 * j;
            if (g < G) {
              const float* qg = Qs + g * D + d;
              if constexpr (VEC) {
#pragma unroll
                for (int w = 0; w < W; w += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + w);
                  s[j] += qv.x * kx[w] + qv.y * kx[w + 1] + qv.z * kx[w + 2] +
                          qv.w * kx[w + 3];
                }
              } else {
                s[j] += qg[0] * kx[0];
              }
            }
          }
        }
      }
      // an int8 cache's k_scale, before the mask
      const float ks = I8 && c < nr ? Ksc[c] : 1.f;
#pragma unroll
      for (int j = 0; j < MAX_G / 2; ++j) {
        const int g = hh + 2 * j;
        if (g < G) Ps[g * BK + c] = c < nr ? s[j] * ks : -INFINITY;
      }
    }
    __syncthreads();
    if constexpr (!I8) {
      if (more) {            // Ks is free: the next tile's keys
        rw.load<T, VEC>(t + 1, kc, k_new, Ks, D, ld);
        cp_async_commit();
      }
    }
    // online softmax, a warp per head
    for (int g = warp; g < G; g += NWARP) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, Ps[g * BK + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);   // finite: nr >= 1
      float psum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(Ps[g * BK + c] - m_new);   // -inf -> 0
        Ps[g * BK + c] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);   // m_prev = -inf -> 0
        Cs[g] = corr;
        Ls[g] = Ls[g] * corr + psum;
        Ms[g] = m_new;
      }
    }
    if constexpr (!I8) {
      if (more)
        cp_async_wait<1>();  // V of this tile (the next K may be landing)
      else
        cp_async_wait<0>();
    }
    __syncthreads();
    if (pv_thread) {
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int g = slot + j * slots;
        if (g < G) {
          const float corr = Cs[g];
          acc[j][0] *= corr;
          acc[j][1] *= corr;
        }
      }
#pragma unroll 4
      for (int c = 0; c < nr; ++c) {
        const float2 vx = pair(Vs + c * ld + pcol);
        // an int8 cache's v_scale, after the row sum
        const float vs = I8 ? Vsc[c] : 1.f;
#pragma unroll
        for (int j = 0; j < HPT; ++j) {
          const int g = slot + j * slots;
          if (g < G) {
            const float p = Ps[g * BK + c] * vs;
            acc[j][0] += p * vx.x;
            acc[j][1] += p * vx.y;
          }
        }
      }
    }
    __syncthreads();
    if constexpr (!I8) {
      if (more) {            // Vs is free: the next tile's values
        rw.load<T, VEC>(t + 1, vc, v_new, Vs, D, ld);
        cp_async_commit();
      }
    }
  }

  // o over the finished tiles (zeros, and l = 0, when there were none)
  __syncthreads();
  float* Os = reinterpret_cast<float*>(smem_raw);  // [G][D]
  if (pv_thread) {
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      const int g = slot + j * slots;
      if (g < G) {
        Os[g * D + pcol] = acc[j][0];
        if (pcol + 1 < D) Os[g * D + pcol + 1] = acc[j][1];
      }
    }
  }
  __syncthreads();
  finish(Os, Ls, o, H, D);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One block per (kv head, sequence).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), size_t smem, int K, int B,
                   cudaStream_t stream, Args... args) {
  // dynamic shared memory past 48 KB
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(K, B), NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const float* ksc, const float* vsc,
                       const int* kv_len, const void* k_new,
                       const void* v_new, void* o, int B, int Smax, int H,
                       int K, int D, float scale, bool vec, bool i8,
                       cudaStream_t stream) {
  const int ld = smem_ld(D, sizeof(T));
  const size_t smem = smem_bytes(H / K, D, ld, sizeof(T), i8);
  const T* qt = static_cast<const T*>(q);
  const T* knt = static_cast<const T*>(k_new);
  const T* vnt = static_cast<const T*>(v_new);
  T* ot = static_cast<T*>(o);
  if (i8)
    return launch(decode_fma_kernel<T, true, true>, smem, K, B, stream, qt,
                  static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                  ksc, vsc, kv_len, knt, vnt, ot, Smax, H, D, ld, scale);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (vec)
    return launch(decode_fma_kernel<T, true, false>, smem, K, B, stream, qt,
                  kt, vt, ksc, vsc, kv_len, knt, vnt, ot, Smax, H, D, ld,
                  scale);
  return launch(decode_fma_kernel<T, false, false>, smem, K, B, stream, qt,
                kt, vt, ksc, vsc, kv_len, knt, vnt, ot, Smax, H, D, ld,
                scale);
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted) and, in
// *variant, the kernel it chose: 0 decode_mma_kernel, 1 decode_fma_kernel,
// 2 and 3 the same over an int8 cache.
// k_new and v_new are both null (no in-flight entry) or both set.
// dtype (of q, k_new, v_new, o and a float cache): 0 = float32,
// 1 = bfloat16.  int8_cache: k, v are int8 with float32 k_scale, v_scale
// [B, Smax, K]; else the scales are null.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, const void* kv_len,
                                    const void* k_new, const void* v_new,
                                    void* o, int B, int Smax, int H, int K,
                                    int D, float scale, int dtype,
                                    int int8_cache, int* variant,
                                    void* stream) {
  const bool i8 = int8_cache != 0;
  if (K <= 0 || H % K != 0 || H / K > MAX_G || D > MAX_D || D <= 0 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (i8 && (D % 16 != 0 || !aligned16(k) || !aligned16(v) ||
             k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = D * elem % 16 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) &&
                   (k_new == nullptr || (aligned16(k_new) && aligned16(v_new)));
  using bf16 = __nv_bfloat16;
  // an int8 cache reads q 16 bytes a copy, and the in-flight entry by
  // elements
  if (dtype == 1 && (i8 ? aligned16(q) : vec)) {
    const auto* qb = static_cast<const bf16*>(q);
    const auto* kb = static_cast<const bf16*>(k);
    const auto* vb = static_cast<const bf16*>(v);
    const auto* k8 = static_cast<const int8_t*>(k);
    const auto* v8 = static_cast<const int8_t*>(v);
    const auto* knb = static_cast<const bf16*>(k_new);
    const auto* vnb = static_cast<const bf16*>(v_new);
    auto* ob = static_cast<bf16*>(o);
    const float sl = scale * LOG2E;
    *variant = i8 ? 2 : 0;
    switch (D) {
#define MMA_CASE(DD)                                                          \
  case DD:                                                                    \
    return i8 ? launch(decode_mma_kernel<DD, true>,                           \
                       mma_smem_bytes<DD, true>(), K, B, s, qb, k8, v8, ksc,  \
                       vsc, len, knb, vnb, ob, Smax, H, sl)                   \
              : launch(decode_mma_kernel<DD, false>,                          \
                       mma_smem_bytes<DD, false>(), K, B, s, qb, kb, vb, ksc, \
                       vsc, len, knb, vnb, ob, Smax, H, sl);
      MMA_CASE(16) MMA_CASE(32) MMA_CASE(64) MMA_CASE(80) MMA_CASE(128)
      MMA_CASE(256)
#undef MMA_CASE
    }
  }
  *variant = i8 ? 3 : 1;
  if (dtype == 0)
    return launch_fma<float>(q, k, v, ksc, vsc, len, k_new, v_new, o, B,
                             Smax, H, K, D, scale, vec, i8, s);
  return launch_fma<bf16>(q, k, v, ksc, vsc, len, k_new, v_new, o, B, Smax,
                          H, K, D, scale, vec, i8, s);
}
