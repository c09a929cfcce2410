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
// exactly 0 to both outputs: their weights are 0, so are both halves of
// their split, and so is every product they enter.
//
// Layout is the caller's (repro_torch.models.mamba2.ssd_chunked): x
// [b, nc, Q, H, P] float32 or bfloat16; dt and cum [b, nc, Q, H], tot
// [b, nc, H], B and C [b, nc, Q, 1, N] (one group, shared by every head),
// all float32; outputs y [b, nc, Q, H, P] and st [b, nc, H, P, N] float32.
// All contiguous.  Any Q >= 1 and H; P and N up to 128.
//
// What bounds it on an H100.  At the serving prefill (b*nc = 1, Q = 8,
// H = 64, P = 64, N = 128) the bytes would, 2 MB of states written
// against 0.3 MB of everything else (0.7 us); in practice a chain of
// latencies does: launch, the loads of B, C and x, S, W.x, the stores.
// At a full chunk (Q = 256) the three contractions, C.B^T once per
// chunk, W.x and (x.w)^T.B per head, each as three TF32 products.
//
// Design.  One __global__, ssd_scan_kernel, whose blocks take one of two
// roles by blockIdx.x, so one launch computes both outputs:
//
// - y blocks own 16 * RG rows l of one (batch, chunk) and a block of HB
//   heads.  S = C.B^T for those rows is computed once and kept in shared
//   memory as mma accumulator fragments, then every head of the block
//   reuses it, as the Pallas kernel shares it across its hb heads.  Per
//   head and step, W = S * exp(cum_l - cum_m) * dt_m goes from the S
//   fragment straight into the A fragment of y += W.x_h: the steps m of
//   each k = 8 slice are taken in the order 0,2,4,6,1,3,5,7, which makes
//   the accumulator layout of S the operand layout of W.  Tiles follow Q.
//   Q <= 16 (the serving prefill, RG = 1): one 16-row tile, 4 heads, two
//   warps a head, each half of P; S is split over all 8 warps (2 column
//   tiles x 4 quarters of N) and the x tiles load while it is computed,
//   so the chain from launch to store stays short.  Q > 16 (RG = 4): 64
//   rows, 16 heads in 2 head groups of 4 row warps; S is kept for 128
//   steps at a time (a later segment adds to the y the first stored, by
//   reductions that nothing waits for), and x tiles of 64 steps arrive by
//   cp.async into a double buffer, as do the B tiles of S.
// - state blocks compute st[h] = (x_h.w_h)^T.B for 64 rows p of one head
//   and all N columns, with w[m] = exp(tot_h - cum_m) * dt_m: x, B, cum
//   and dt tiles of 32 steps through a three-stage cp.async ring.
//
// Blocks take 128 registers, and at most 106 KB of shared memory for P =
// 64, so two share an SM: at the serving shape the 16 y blocks and the 64
// state blocks (which spread the 2 MB of state stores) run in one wave.
//
// All three contractions run on the tensor cores (mma.sync m16n8k8 TF32,
// fp32 accumulators) with each fp32 operand split into a TF32 hi part and
// a lo remainder: hi*hi + hi*lo + lo*hi, dropping lo*lo, keeps the
// float32 tolerance that one TF32 rounding breaks (tests/
// test_torch_ssd_precision.py).  hi is cvt.rna.tf32.f32's result computed
// by two integer operations, which issue faster than the conversion; the
// mma reads the TF32 part of lo (the top 19 bits).
// A bfloat16 x is exact in TF32, so its lo part is 0 and that product is
// skipped.  Exponentials and masking stay fp32 on the FMA/SFU units.
// Shared-memory rows are padded to 4 mod 16 floats so the fragment reads
// do not conflict on banks; y and st leave as 16-byte stores after one
// lane-pair shuffle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int NTH = NW * 32;
constexpr int MAX_N = 128;
constexpr int MAX_P = 128;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// what the entry point found 16-byte aligned (bit set: 16-byte moves)
constexpr int VEC_X_ROWS = 1;    // x rows of P floats
constexpr int VEC_BC = 2;        // B and C rows of N floats
constexpr int VEC_Y = 4;
constexpr int VEC_ST = 8;

struct Args {
  const void* x;
  const float* dt;
  const float* cum;
  const float* tot;
  const float* B;
  const float* C;
  float* y;
  float* st;
  int BC, Q, H, P, N;
  int n_y;                       // y blocks; the rest are state blocks
  int vec;
};

// ---- tile sizes, by the row-group count RG of the y blocks --------------

template <int PP, int NP, int RG>
struct Tiles {
  static constexpr int BL = 16 * RG;           // y rows per block
  // RG = 1: 4 heads a block, two warps a head, each half of P; RG = 4:
  // 16 heads, 8 each for 2 head groups (S is computed once per block)
  static constexpr int PS = RG == 1 ? 2 : 1;   // warps along P
  static constexpr int HB = RG == 1 ? 4 : 16;  // heads per y block
  static constexpr int HG = NW / (RG * PS);    // head groups
  static constexpr int HPG = HB / HG;          // heads per head group
  static constexpr int NQ = PP / 8 / PS;       // column tiles per warp
  static constexpr int SEG = RG == 1 ? 16 : 128;   // S columns kept
  static constexpr int NJ = SEG / 8;           // S fragments per row group
  static constexpr int BMS = RG == 1 ? 16 : 32;    // B tile (S phase)
  static constexpr int BMX = RG == 1 ? 16 : 64;    // x tile (y phase)
  static constexpr int NBUF = RG == 1 ? 1 : 2;     // x tile buffers
  static constexpr bool ALIAS = RG != 1;   // x tiles reuse the C/B tiles
  static constexpr int LDN = NP + 4;       // B, C row stride
  static constexpr int LDP = PP + 4;       // x row stride (y blocks)
  // RG = 1: the 8 warps split S's 2 column tiles x 4 quarters of N, and
  // the 4 partial sums are added where S is read
  static constexpr int KQ = RG == 1 ? NW / (BMS / 8) : 1;
  static constexpr int S_FLOATS = KQ * RG * NJ * 128;
  static constexpr int CL_FLOATS = BL * HB;    // cum of the block's rows
  static constexpr int CB_FLOATS = (BL + 2 * BMS) * LDN;
  static constexpr int X_FLOATS = HG * NBUF * BMX * (LDP + 2);
  static constexpr int Y_FLOATS =
      S_FLOATS + CL_FLOATS +
      (ALIAS ? (CB_FLOATS > X_FLOATS ? CB_FLOATS : X_FLOATS)
             : CB_FLOATS + X_FLOATS);
  // state blocks: rows p of one head
  static constexpr int SRW = 4;                // warps along rows
  static constexpr int SNW = NW / SRW;         // warps along n
  static constexpr int SR = 16 * SRW;          // rows p per block
  static constexpr int NC = NP / SNW;          // n columns per warp
  static constexpr int BMT = RG == 1 ? 16 : 32;    // steps per tile
  static constexpr int NST = RG == 1 ? 1 : 3;      // tiles in flight
  static constexpr int LDR = SR + 4;
  static constexpr int ST_FLOATS = NST * BMT * (LDR + LDN + 3);
  static constexpr size_t SMEM =
      sizeof(float) * size_t(Y_FLOATS > ST_FLOATS ? Y_FLOATS : ST_FLOATS);
  // two blocks an SM where the shared memory allows (registers <= 128)
  static constexpr int MIN_BLOCKS = SMEM <= 110 * 1024 ? 2 : 1;
};

// ---- primitives -----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes from global to shared memory, asynchronously; zeros when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows x cols (cols a multiple of 4) of a row-major matrix with row
// stride ld into shared memory with row stride lds, zeros outside
// [0, nr) x [0, nc).  float32 moves by cp.async (16 bytes where vec: then
// nc is a multiple of 4 too); bfloat16 is converted through registers.
__device__ __forceinline__ void stage(float* dst, int lds, const float* src,
                                      size_t ld, int rows, int cols, int nr,
                                      int nc, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += NTH) {
      const int r = e / c4, c = (e % c4) * 4;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NTH) {
      const int r = e / cols, c = e % cols;
      const bool ok = r < nr && c < nc;
      cp_async4(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
    }
  }
}
__device__ __forceinline__ void stage(float* dst, int lds,
                                      const __nv_bfloat16* src, size_t ld,
                                      int rows, int cols, int nr, int nc,
                                      bool) {
  for (int e = threadIdx.x; e < rows * cols; e += NTH) {
    const int r = e / cols, c = e % cols;
    dst[r * lds + c] =
        r < nr && c < nc ? __bfloat162float(src[r * ld + c]) : 0.f;
  }
}

// v = hi + lo exactly.  hi is v rounded to TF32, to nearest with ties away
// from zero (the bits cvt.rna.tf32.f32 gives, by two integer operations
// instead of the conversion unit); lo = v - hi is passed as float32, of
// which the mma reads the TF32 part (its low 13 bits are ignored).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d[16x8] += a[16x8] . b[8x8], TF32 in, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the three products of the split, small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, alo, bh0, bh1);
  mma(d, ahi, bl0, bl1);
  mma(d, ahi, bh0, bh1);
}

// Store a 16 x 8 accumulator fragment (rows row0 + g, row0 + g + 8, columns
// col0 + 2t, 2t + 1) as 16-byte rows: lanes t and t + 1 swap halves, so
// the even lane holds 4 columns of row g and the odd lane 4 of row g + 8.
// Rows >= nr and columns >= nc are left alone.  add: add to what this
// thread stored there before, by reductions that nothing waits for (one
// float32 add each, in the order the thread issued them).
__device__ __forceinline__ void store_frag(float* out, size_t ld, int row0,
                                           int col0, int nr, int nc,
                                           const float (&c)[4], bool vec,
                                           bool add) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const float s0 = __shfl_xor_sync(FULL, odd ? c[0] : c[2], 1);
  const float s1 = __shfl_xor_sync(FULL, odd ? c[1] : c[3], 1);
  float v[4];
  if (odd) {
    v[0] = s0; v[1] = s1; v[2] = c[2]; v[3] = c[3];
  } else {
    v[0] = c[0]; v[1] = c[1]; v[2] = s0; v[3] = s1;
  }
  const int row = row0 + g + (odd ? 8 : 0);
  const int col = col0 + 2 * (t & 2);
  if (row >= nr) return;
  float* p = out + size_t(row) * ld + col;
  if (add) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < nc) atomicAdd(p + e, v[e]);
  } else if (vec && col + 3 < nc) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < nc) p[e] = v[e];
  }
}

// ---- y blocks ------------------------------------------------------------

template <typename T, int PP, int NP, int RG>
__device__ __forceinline__ void y_block(const Args& a, float* smem,
                                        int blk) {
  using Tl = Tiles<PP, NP, RG>;
  constexpr int BL = Tl::BL, HB = Tl::HB, HG = Tl::HG, HPG = Tl::HPG,
                PS = Tl::PS, NQ = Tl::NQ, SEG = Tl::SEG,
                NJ = Tl::NJ, KQ = Tl::KQ, BMS = Tl::BMS, BMX = Tl::BMX,
                NBUF = Tl::NBUF, LDN = Tl::LDN, LDP = Tl::LDP;
  constexpr bool EXACT_X = std::is_same<T, __nv_bfloat16>::value;
  const int Q = a.Q, H = a.H, P = a.P, N = a.N;
  const T* x = static_cast<const T*>(a.x);

  // heaviest row tiles (longest causal reach) first
  const int nlt = (Q + BL - 1) / BL, nhb = (H + HB - 1) / HB;
  const int per_lt = nhb * a.BC;
  const int lt = nlt - 1 - blk / per_lt;
  const int hblk = (blk % per_lt) % nhb;
  const size_t bc = (blk % per_lt) / nhb;
  const int l0 = lt * BL, h0 = hblk * HB;
  const int m_end = min(Q, l0 + BL);

  float* Ss = smem;                              // [RG][NJ][32][4]
  float* cls = Ss + Tl::S_FLOATS;                // [BL][HB]
  float* Cs = cls + Tl::CL_FLOATS;               // [BL][LDN]
  float* Bs = Cs + BL * LDN;                     // [2][BMS][LDN]
  float* Xs = Tl::ALIAS ? Cs : Cs + Tl::CB_FLOATS;   // [HG][NBUF][BMX][LDP]
  float* cms = Xs + HG * NBUF * BMX * LDP;       // [HG][NBUF][BMX]
  float* dms = cms + HG * NBUF * BMX;            // [HG][NBUF][BMX]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % RG, hg = warp / RG % HG, ps = warp / (RG * HG);
  const int c0 = 8 * NQ * ps;                    // this warp's columns p
  const int row0 = l0 + 16 * rg;                 // this warp's first row
  const int lg = row0 + g, lg8 = lg + 8;         // its two fragment rows
  const size_t qh = size_t(Q) * H;

  const float* Bb = a.B + bc * Q * N;
  const float* Cb = a.C + bc * Q * N;
  const float* cumb = a.cum + bc * qh;
  const float* dtb = a.dt + bc * qh;
  const bool vx = a.vec & VEC_X_ROWS, vbc = a.vec & VEC_BC;

  // cum of the block's rows and heads, for every segment
  for (int e = threadIdx.x; e < BL * HB; e += NTH) {
    const int r = e / HB, hh = e % HB;
    const bool ok = l0 + r < Q && h0 + hh < H;
    cp_async4(cls + e, ok ? cumb + size_t(l0 + r) * H + h0 + hh : cumb, ok);
  }

  for (int seg0 = 0; seg0 < m_end; seg0 += SEG) {
    const int seg_end = min(m_end, seg0 + SEG);
    const int ntx = (seg_end - seg0 + BMX - 1) / BMX;
    const int nitems = HPG * ntx;
    // a step slice [m8, m8 + 8) this warp multiplies: inside the segment,
    // not wholly above the diagonal, rows inside Q
    auto live = [&](int m8) {
      return m8 < seg_end && m8 <= row0 + 15 && row0 < Q;
    };
    // item it: head slot it / ntx, x tile it % ntx, for every head group
    auto issue = [&](int it) {
      const int buf = it % NBUF;
      const int i = it / ntx, mt0 = seg0 + (it % ntx) * BMX;
      for (int q = 0; q < HG; ++q) {
        const int h = h0 + q + HG * i;
        const bool hv = h < H;
        const int nr = hv ? min(BMX, Q - mt0) : 0;
        const size_t off = (bc * Q + mt0) * H + (hv ? h : 0);
        stage(Xs + (q * NBUF + buf) * BMX * LDP, LDP, x + off * P,
              size_t(H) * P, BMX, PP, nr, P, vx);
        float* cm = cms + (q * NBUF + buf) * BMX;
        float* dm = dms + (q * NBUF + buf) * BMX;
        for (int e = threadIdx.x; e < BMX; e += NTH) {
          const bool ok = e < nr;
          const size_t o = ok ? (mt0 + e) * size_t(H) + h : 0;
          cp_async4(cm + e, cumb + o, ok);
          cp_async4(dm + e, dtb + o, ok);
        }
      }
      cp_async_commit();
    };
    auto issue_b = [&](int mt0) {
      stage(Bs + ((mt0 - seg0) / BMS % 2) * BMS * LDN, LDN,
            Bb + size_t(mt0) * N, N, BMS, NP, Q - mt0, N, vbc);
      cp_async_commit();
    };

    // ---- S = C . B^T for rows [l0, l0 + BL) and steps of the segment
    __syncthreads();   // the last segment's tiles are no longer read
    stage(Cs, LDN, Cb + size_t(l0) * N, N, BL, NP, Q - l0, N, vbc);
    issue_b(seg0);
    // RG = 1 has one segment and one B tile: its x tiles load while S is
    // computed
    if (!Tl::ALIAS) issue(0);
    for (int mt0 = seg0; mt0 < seg_end; mt0 += BMS) {
      if (mt0 + BMS < seg_end) {
        issue_b(mt0 + BMS);
        cp_async_wait<1>();
      } else if (!Tl::ALIAS) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* bt = Bs + ((mt0 - seg0) / BMS % 2) * BMS * LDN;
      // RG = 4: warp (rg, hg) takes column tiles hg, hg + HG, ... of its
      // rows over all of N; RG = 1: column tile warp % 2, quarter warp / 2
      const int kq = KQ == 1 ? 0 : warp / (BMS / 8);
      const int jt0 = KQ == 1 ? hg : warp % (BMS / 8);
      const int jstep = KQ == 1 ? HG : BMS / 8;
      for (int jt = jt0; jt < BMS / 8; jt += jstep) {
        const int m8 = mt0 + 8 * jt;
        if (!live(m8)) continue;
        // three chains, summed at the end: hi*hi + (lo*hi + hi*lo)
        float hh[4] = {0.f, 0.f, 0.f, 0.f}, lh[4] = {0.f, 0.f, 0.f, 0.f},
              hl[4] = {0.f, 0.f, 0.f, 0.f};
        const float* cr = Cs + (16 * rg + g) * LDN + t;
        const float* br = bt + (8 * jt + g) * LDN + t;
#pragma unroll 4
        for (int k = kq * (NP / KQ); k < (kq + 1) * (NP / KQ); k += 8) {
          uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
          split(cr[k], ah[0], al[0]);
          split(cr[8 * LDN + k], ah[1], al[1]);
          split(cr[k + 4], ah[2], al[2]);
          split(cr[8 * LDN + k + 4], ah[3], al[3]);
          split(br[k], bh0, bl0);
          split(br[k + 4], bh1, bl1);
          mma(lh, al, bh0, bh1);
          mma(hl, ah, bl0, bl1);
          mma(hh, ah, bh0, bh1);
        }
        float4 s;
        s.x = hh[0] + (lh[0] + hl[0]);
        s.y = hh[1] + (lh[1] + hl[1]);
        s.z = hh[2] + (lh[2] + hl[2]);
        s.w = hh[3] + (lh[3] + hl[3]);
        const int j = (m8 - seg0) / 8;
        reinterpret_cast<float4*>(Ss)[((kq * RG + rg) * NJ + j) * 32 + lane] =
            s;
      }
      __syncthreads();   // this B buffer is refilled next; at the end, S
    }                    // is complete and Cs, Bs are free

    // ---- per head: y_h += W_h . x_h over the segment's x tiles
    if (Tl::ALIAS) issue(0);
    float acc[NQ][4];
    float cl_g = 0.f, cl_g8 = 0.f;
    for (int it = 0; it < nitems; ++it) {
      if (NBUF == 1) {
        if (it > 0) issue(it);
        cp_async_wait<0>();
      } else if (it + 1 < nitems) {
        issue(it + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int buf = it % NBUF, xt = it % ntx;
      const int mt0 = seg0 + xt * BMX;
      const int h = h0 + hg + HG * (it / ntx);
      if (xt == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
        cl_g = cls[(lg - l0) * HB + h - h0];
        cl_g8 = cls[(lg8 - l0) * HB + h - h0];
      }
      const float* xs = Xs + (hg * NBUF + buf) * BMX * LDP;
      const float* cm = cms + (hg * NBUF + buf) * BMX;
      const float* dm = dms + (hg * NBUF + buf) * BMX;
      if (h < H) {
#pragma unroll 2
        for (int ks = 0; ks < BMX / 8; ++ks) {
          const int m8 = mt0 + 8 * ks;
          if (!live(m8)) continue;
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int kq = 0; kq < KQ; ++kq) {
            const float4 v = reinterpret_cast<const float4*>(
                Ss)[((kq * RG + rg) * NJ + (m8 - seg0) / 8) * 32 + lane];
            s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
          }
          // this lane's steps: ma (k = t) and mb = ma + 1 (k = t + 4)
          const int i0 = 8 * ks + 2 * t;
          const int ma = mt0 + i0, mb = ma + 1;
          const float ca = cm[i0], cb = cm[i0 + 1];
          const float da = dm[i0], db = dm[i0 + 1];
          // mask before the exponential: exp(-inf) = 0
          const float w0 = s.x * expf(lg < Q && ma <= lg ? cl_g - ca
                                                          : -INFINITY) * da;
          const float w1 = s.y * expf(lg < Q && mb <= lg ? cl_g - cb
                                                          : -INFINITY) * db;
          const float w2 = s.z * expf(lg8 < Q && ma <= lg8 ? cl_g8 - ca
                                                            : -INFINITY) * da;
          const float w3 = s.w * expf(lg8 < Q && mb <= lg8 ? cl_g8 - cb
                                                            : -INFINITY) * db;
          uint32_t ah[4], al[4];
          split(w0, ah[0], al[0]);   // (g, ma)
          split(w2, ah[1], al[1]);   // (g + 8, ma)
          split(w1, ah[2], al[2]);   // (g, mb)
          split(w3, ah[3], al[3]);   // (g + 8, mb)
          const float* xa = xs + i0 * LDP + c0 + g;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float x0 = xa[8 * q], x1 = xa[LDP + 8 * q];
            if (EXACT_X) {   // bfloat16 x: its TF32 lo part is 0
              const uint32_t b0 = __float_as_uint(x0),
                             b1 = __float_as_uint(x1);
              mma(acc[q], al, b0, b1);
              mma(acc[q], ah, b0, b1);
            } else {
              uint32_t bh0, bh1, bl0, bl1;
              split(x0, bh0, bl0);
              split(x1, bh1, bl1);
              mma3(acc[q], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
      }
      if (xt == ntx - 1 && h < H && row0 < Q) {
        float* yb = a.y + (bc * Q * H + h) * size_t(P);
        // a later segment adds to what the first stored
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          store_frag(yb, size_t(H) * P, row0, c0 + 8 * q, Q, P, acc[q],
                     a.vec & VEC_Y, seg0 > 0);
      }
      __syncthreads();   // buffer it % NBUF is refilled next
    }
  }
}

// ---- state blocks --------------------------------------------------------

template <typename T, int PP, int NP, int RG>
__device__ __forceinline__ void state_block(const Args& a, float* smem,
                                            int blk) {
  using Tl = Tiles<PP, NP, RG>;
  constexpr int SRW = Tl::SRW, SR = Tl::SR, NC = Tl::NC, BMT = Tl::BMT,
                NST = Tl::NST, LDR = Tl::LDR, LDN = Tl::LDN;
  const int Q = a.Q, H = a.H, P = a.P, N = a.N;
  const int npt = (P + SR - 1) / SR;
  const int pt = blk % npt;
  const int h = (blk / npt) % H;
  const size_t bc = blk / npt / H;
  const int p0 = pt * SR;

  float* Xs = smem;                               // [NST][BMT][LDR]
  float* Bs = Xs + NST * BMT * LDR;               // [NST][BMT][LDN]
  float* cms = Bs + NST * BMT * LDN;              // [NST][BMT] cum
  float* dms = cms + NST * BMT;                   // [NST][BMT] dt
  float* ws = dms + NST * BMT;                    // [NST][BMT] weights

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * (warp % SRW) + g;           // local rows rl, rl + 8
  const int n0 = NC * (warp / SRW);

  const T* xb = static_cast<const T*>(a.x) + (bc * Q * H + h) * P + p0;
  const float* Bb = a.B + bc * Q * N;
  const float* cumb = a.cum + bc * Q * H + h;
  const float* dtb = a.dt + bc * Q * H + h;
  const float tot_h = a.tot[bc * H + h];
  const bool vx = a.vec & VEC_X_ROWS, vbc = a.vec & VEC_BC;

  auto issue = [&](int tile) {
    const int buf = tile % NST, m0 = tile * BMT;
    stage(Xs + buf * BMT * LDR, LDR, xb + size_t(m0) * H * P,
          size_t(H) * P, BMT, SR, Q - m0, P - p0, vx);
    stage(Bs + buf * BMT * LDN, LDN, Bb + size_t(m0) * N, N, BMT, NP,
          Q - m0, N, vbc);
    for (int e = threadIdx.x; e < BMT; e += NTH) {
      const bool ok = m0 + e < Q;
      const size_t o = ok ? size_t(m0 + e) * H : 0;
      cp_async4(cms + buf * BMT + e, cumb + o, ok);
      cp_async4(dms + buf * BMT + e, dtb + o, ok);
    }
    cp_async_commit();
  };

  float acc[NC / 8][4];
#pragma unroll
  for (int q = 0; q < NC / 8; ++q)
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
  const int ntiles = (Q + BMT - 1) / BMT;
  for (int i = 0; i < NST - 1 && i < ntiles; ++i) issue(i);
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + NST - 1 < ntiles) issue(tile + NST - 1);
    // tile's group is complete when at most the later ones are pending
    const int later = min(NST - 1, ntiles - 1 - tile);
    if (later >= 2)
      cp_async_wait<2>();
    else if (later == 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int buf = tile % NST;
    float* w = ws + buf * BMT;
    // the decay to the chunk's end times dt of this tile's steps
    for (int e = threadIdx.x; e < BMT; e += NTH)
      w[e] = tile * BMT + e < Q
                 ? expf(tot_h - cms[buf * BMT + e]) * dms[buf * BMT + e]
                 : 0.f;
    __syncthreads();
    const float* xs = Xs + buf * BMT * LDR;
    const float* bs = Bs + buf * BMT * LDN + n0 + g;
#pragma unroll 2
    for (int ks = 0; ks < BMT / 8; ++ks) {
      // steps ia (k = t) and ia + 1 (k = t + 4)
      const int ia = 8 * ks + 2 * t;
      const float* x0 = xs + ia * LDR + rl;
      const float wa = w[ia], wb = w[ia + 1];
      uint32_t ah[4], al[4];
      split(x0[0] * wa, ah[0], al[0]);           // (g, ia)
      split(x0[8] * wa, ah[1], al[1]);           // (g + 8, ia)
      split(x0[LDR] * wb, ah[2], al[2]);         // (g, ia + 1)
      split(x0[LDR + 8] * wb, ah[3], al[3]);     // (g + 8, ia + 1)
      const float* b = bs + ia * LDN;
#pragma unroll
      for (int q = 0; q < NC / 8; ++q) {
        uint32_t bh0, bh1, bl0, bl1;
        split(b[8 * q], bh0, bl0);
        split(b[LDN + 8 * q], bh1, bl1);
        mma3(acc[q], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();   // buffer tile % NST is refilled next
  }
  float* sb = a.st + ((bc * H + h) * P + p0) * size_t(N);
#pragma unroll
  for (int q = 0; q < NC / 8; ++q)
    store_frag(sb, N, 16 * (warp % SRW), n0 + 8 * q, P - p0, N, acc[q],
               a.vec & VEC_ST, false);
}

template <typename T, int PP, int NP, int RG>
__global__ void __launch_bounds__(NTH, (Tiles<PP, NP, RG>::MIN_BLOCKS))
    ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int blk = blockIdx.x;
  if (blk < a.n_y)
    y_block<T, PP, NP, RG>(a, smem, blk);
  else
    state_block<T, PP, NP, RG>(a, smem, blk - a.n_y);
}

// cudaFuncSetAttribute once per instance and device, not on every call
template <typename T, int PP, int NP, int RG>
cudaError_t allow_smem() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_scan_kernel<T, PP, NP, RG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Tiles<PP, NP, RG>::SMEM));
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T, int PP, int NP, int RG>
cudaError_t launch(Args a, cudaStream_t stream) {
  using Tl = Tiles<PP, NP, RG>;
  cudaError_t err = allow_smem<T, PP, NP, RG>();
  if (err != cudaSuccess) return err;
  a.n_y = a.BC * ((a.Q + Tl::BL - 1) / Tl::BL) *
          ((a.H + Tl::HB - 1) / Tl::HB);
  const long long n_state =
      (long long)a.BC * a.H * ((a.P + Tl::SR - 1) / Tl::SR);
  const long long blocks = a.n_y + n_state;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ssd_scan_kernel<T, PP, NP, RG>
      <<<unsigned(blocks), NTH, Tl::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int PP, int NP>
cudaError_t dispatch_rg(const Args& a, cudaStream_t s) {
  return a.Q <= 16 ? launch<T, PP, NP, 1>(a, s) : launch<T, PP, NP, 4>(a, s);
}
template <typename T, int PP>
cudaError_t dispatch_np(const Args& a, cudaStream_t s) {
  return a.N <= 64 ? dispatch_rg<T, PP, 64>(a, s)
                   : dispatch_rg<T, PP, 128>(a, s);
}
template <typename T>
cudaError_t dispatch_pp(const Args& a, cudaStream_t s) {
  return a.P <= 64 ? dispatch_np<T, 64>(a, s) : dispatch_np<T, 128>(a, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Returns the CUDA error of the launch (0 when it was accepted).
// x_dtype: 0 = float32, 1 = bfloat16 (every other input is float32).
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dt,
                                   const void* cum, const void* tot,
                                   const void* B, const void* C, void* y,
                                   void* st, int b, int nc, int Q, int H,
                                   int P, int N, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > MAX_N || P < 1 || P > MAX_P || Q < 1 || H < 1 ||
      b * nc < 1 || b * nc > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(cum),
         static_cast<const float*>(tot), static_cast<const float*>(B),
         static_cast<const float*>(C), static_cast<float*>(y),
         static_cast<float*>(st), b * nc, Q, H, P, N, 0, 0};
  if (x_dtype == 0 && P % 4 == 0 && aligned16(x)) a.vec |= VEC_X_ROWS;
  if (N % 4 == 0 && aligned16(B) && aligned16(C)) a.vec |= VEC_BC;
  if (P % 4 == 0 && aligned16(y)) a.vec |= VEC_Y;
  if (N % 4 == 0 && aligned16(st)) a.vec |= VEC_ST;
  if (x_dtype == 0) return dispatch_pp<float>(a, s);
  if (x_dtype == 1) return dispatch_pp<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}
