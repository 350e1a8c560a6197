// Split-TF32 pieces shared by the f32 attention kernels on Hopper's tensor
// cores (flash_attention_online_tf32.cu, flash_attention_tf32.cu,
// attention_train_tf32.cu): the 3xTF32 split, the mma.sync m16n8k8 tf32
// product, f32 row copies into padded shared tiles, the fragment loads and
// the round-to-nearest fold.
//
// The products. Plain TF32 keeps 10 mantissa bits and would break the f32
// contracts (1e-4 absolute; 1e-5 of the largest value for the gradients),
// so every product a b is taken as three tensor-core products on a split
// of each operand: hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x -
// hi) (x - hi is exact in f32), and
//   a b ~= a_hi b_hi + (a_lo b_hi + a_hi b_lo),
// with f32 accumulators. The dropped a_lo b_lo and the rounding of lo are
// about 2^-21 of |a b|. The tensor cores' f32 accumulation does not round
// to nearest (it truncates: on an H100, 1 + 0.75 ulp gives 1), so a long
// sum in one accumulator drifts. So the hi products and the correction
// terms sum in two accumulators ("big" and "small"), each over one short
// run of products only (one key or query tile), and are added, and folded
// into the running sums, with round-to-nearest f32 operations (fold_rn).
//
// Fragment layout of m16n8k8 tf32 (PTX ISA), g = lane / 4, t = lane % 4:
// A [16 x 8]: a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8,
// t + 4); B [8 x 8]: b0 = (k t, n g), b1 = (k t + 4, n g); C [16 x 8]: c0,
// c1 = (g, 2t), (g, 2t + 1); c2, c3 = (g + 8, 2t), (g + 8, 2t + 1). A
// product sums over k in any order, so every product here takes the depth
// index permuted, k = t <-> 2t and k = t + 4 <-> 2t + 1: then
//   X Y^T over the head dim (S = Q K^T, dP = dO V^T, their transposes): a
//     thread's A and B values (head dims 2t, 2t + 1) are neighbours in a
//     row, one 8-byte shared load each (load_a_rows, load_b_pair);
//   A Y with A from accumulators (P V, dS K, P^T dO, dS^T Q): the
//     accumulators of an 8-column tile (columns 2t, 2t + 1 of rows g, g +
//     8) are the A fragment as they stand (a0 = c0, a1 = c2, a2 = c1, a3 =
//     c3; split_acc), with Y's B fragment read at rows 2t and 2t + 1
//     (mma3_acc_by_cols): no quad shuffles.
// There is no ldmatrix for 32-bit tiles, so the shared tiles' row strides
// are padded to keep the fragment loads free of bank conflicts (TfDims):
//   8-byte row loads (Q, K, the B pairs): a half-warp's 16 lanes read the
//     words g K_LD + 2t and + 1 (g = 0..3 within the half-warp, t = 0..3).
//     With K_LD = 8 or 24 (mod 32), g K_LD is 0, 8, 16, 24 (mod 32) in some
//     order and 2t, 2t + 1 cover 0..7: 32 distinct banks. K_LD = DH + 8:
//     72 (= 8 mod 32) at 64, 88 (= 24 mod 32) at 80.
//   4-byte column loads (V's B fragment, rows 2t and 2t + 1, column g): a
//     warp reads the words 2t V_LD + g. With 2 V_LD = 8 or 24 (mod 32), 2t
//     V_LD is 0, 8, 16, 24 and g covers 0..7: 32 distinct banks. V_LD = DH
//     + 4: 68 (136 = 8 mod 32) at 64, 84 (168 = 8 mod 32) at 80.
// Both hold for any head width that is a multiple of 16.
//
// Everything lives in an anonymous namespace, as in mma_attention.cuh,
// which this header includes for cp.async and the quad reductions.

#pragma once

#include "mma_attention.cuh"

namespace {

// The shapes that follow from a head width DH (64 or 80 in this port).
template <int DH>
struct TfDims {
  static constexpr int KS = DH / 8;    // 8-deep steps over the head dim
  static constexpr int DT = DH / 8;    // 8-column tiles of a [16 x DH] output
  static constexpr int K_LD = DH + 8;  // rows read as 8-byte pairs, floats
  static constexpr int V_LD = DH + 4;  // rows read as 4-byte columns, floats
  static_assert(DH % 16 == 0, "heads a multiple of 16 wide");
  static_assert(K_LD % 32 == 8 || K_LD % 32 == 24, "8-byte row loads conflict-free");
  static_assert(2 * V_LD % 32 == 8 || 2 * V_LD % 32 == 24, "column loads conflict-free");
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x ~= hi + lo, both TF32 values (f32 bit patterns, low 13 bits zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big += a_hi b_hi and small += a_lo b_hi + a_hi b_lo on the split operands
__device__ __forceinline__ void mma_3xtf32(float big[4], float small[4], const uint32_t ah[4],
                                           const uint32_t al[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// big + small, rounded to nearest: the fold of one short run of split
// products
__device__ __forceinline__ float fold_rn(float big, float small) { return __fadd_rn(big, small); }

__device__ __forceinline__ void zero4(float c[4]) { c[0] = c[1] = c[2] = c[3] = 0.f; }

// Rows [r0, r0 + rows) of an f32 [*, DH] operand (row stride sn elements)
// into a shared tile with rows of `ld` floats, by cp.async, all `threads`
// threads of the block taking part; rows at or past `live` are
// zero-filled.
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src, long long sn,
                                              int r0, int rows, int live, int threads) {
  constexpr int CHUNKS = DH / 4;  // 16-byte chunks of a row: 16 at 64, 20 at 80
  for (int c = threadIdx.x; c < rows * CHUNKS; c += threads) {
    const int i = c / CHUNKS, part = c % CHUNKS;
    const bool in = r0 + i < live;
    const float* s = src + (in ? (long long)(r0 + i) * sn + part * 4 : 0);
    cp_async16(smem_addr(dst + i * ld + part * 4), s, in ? 16 : 0);
  }
}

// The split A fragment of the 8-deep step kc for 16 rows of a shared tile
// (rows of K_LD floats; `rows` points at the warp's first row): head dims
// 8 kc + 2t (a0, a1) and 8 kc + 2t + 1 (a2, a3) of rows g and g + 8.
template <int DH>
__device__ __forceinline__ void load_a_rows(uint32_t ah[4], uint32_t al[4], const float* rows, int kc,
                                            int lane) {
  constexpr int K_LD = TfDims<DH>::K_LD;
  const int g = lane >> 2, t = lane & 3;
  const float* p = rows + g * K_LD + 8 * kc + 2 * t;
  const float2 top = *reinterpret_cast<const float2*>(p);
  const float2 bot = *reinterpret_cast<const float2*>(p + 8 * K_LD);
  split(top.x, ah[0], al[0]);
  split(bot.x, ah[1], al[1]);
  split(top.y, ah[2], al[2]);
  split(bot.y, ah[3], al[3]);
}

// The B values of X Y^T for the 8 rows n0.. of a shared tile Y (rows of
// K_LD floats) at the 8-deep step kc: head dims 8 kc + 2t and 8 kc + 2t + 1
// of row n0 + g.
template <int DH>
__device__ __forceinline__ float2 load_b_pair(const float* tile, int n0, int kc, int lane) {
  return *reinterpret_cast<const float2*>(tile + (n0 + (lane >> 2)) * TfDims<DH>::K_LD + 8 * kc +
                                          2 * (lane & 3));
}

// The split A fragment of an 8-deep step from the accumulators of one
// 8-column tile (columns 2t, 2t + 1 of rows g, g + 8: k = t and t + 4).
__device__ __forceinline__ void split_acc(uint32_t ah[4], uint32_t al[4], const float c[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// s[n] = X Y^T for a warp's 16 rows of X (split fragments xh, xl over the
// head dim) against the NT * 8 rows of a shared tile Y (rows of K_LD
// floats): the hi products and the correction terms over the head dim,
// folded with round to nearest.
template <int DH, int NT>
__device__ __forceinline__ void mma3_rows(float s[NT][4], const uint32_t xh[TfDims<DH>::KS][4],
                                          const uint32_t xl[TfDims<DH>::KS][4], const float* tile,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float small[4] = {0.f, 0.f, 0.f, 0.f};
    zero4(s[n]);
#pragma unroll
    for (int kc = 0; kc < TfDims<DH>::KS; ++kc) {
      const float2 b = load_b_pair<DH>(tile, 8 * n, kc, lane);
      mma_3xtf32(s[n], small, xh[kc], xl[kc], b.x, b.y);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = fold_rn(s[n][e], small[e]);
  }
}

// The same with X's 16 rows read from a shared tile (rows of K_LD floats,
// `xrows` at the warp's first row) and split as each step is read.
template <int DH, int NT>
__device__ __forceinline__ void mma3_rows_smem(float s[NT][4], const float* xrows, const float* tile,
                                               int lane) {
  float small[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    zero4(s[n]);
    zero4(small[n]);
  }
#pragma unroll
  for (int kc = 0; kc < TfDims<DH>::KS; ++kc) {
    uint32_t ah[4], al[4];
    load_a_rows<DH>(ah, al, xrows, kc, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 b = load_b_pair<DH>(tile, 8 * n, kc, lane);
      mma_3xtf32(s[n], small[n], ah, al, b.x, b.y);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = fold_rn(s[n][e], small[n][e]);
}

// acc[d] += (A Y) for the DT 8-column tiles of Y, A the accumulators of NT
// 8-column tiles (the NT 8-deep steps over rows k0.. of a shared tile Y
// with rows of `ld` floats): the hi products and the correction terms over
// the NT steps, folded into acc with round to nearest.
template <int DH, int NT>
__device__ __forceinline__ void mma3_acc_by_cols(float acc[TfDims<DH>::DT][4], const float a[NT][4],
                                                 const float* tile, int ld, int k0, int lane) {
  constexpr int DT = TfDims<DH>::DT;
  const int g = lane >> 2, t = lane & 3;
  float big[DT][4], small[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    zero4(big[d]);
    zero4(small[d]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ah[4], al[4];
    split_acc(ah, al, a[n]);
    const float* yr = tile + (k0 + 8 * n + 2 * t) * ld + g;
#pragma unroll
    for (int d = 0; d < DT; ++d) mma_3xtf32(big[d], small[d], ah, al, yr[8 * d], yr[ld + 8 * d]);
  }
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = __fadd_rn(acc[d][e], fold_rn(big[d][e], small[d][e]));
}

// mma3_acc_by_cols with its loops turned round: the NT split A fragments
// first, then each 8-column tile d of Y over the NT steps, its two
// accumulators folded into acc[d] before the next tile. Every accumulator
// takes the same products in the same order, so the values are the same;
// it holds 8 NT split registers and 8 accumulators where the other holds 8
// and 8 DT (80 at heads 80 wide).
template <int DH, int NT>
__device__ __forceinline__ void mma3_acc_by_cols_dmajor(float acc[TfDims<DH>::DT][4],
                                                        const float a[NT][4], const float* tile,
                                                        int ld, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) split_acc(ah[n], al[n], a[n]);
#pragma unroll
  for (int d = 0; d < TfDims<DH>::DT; ++d) {
    float big[4], small[4];
    zero4(big);
    zero4(small);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* yr = tile + (k0 + 8 * n + 2 * t) * ld + g;
      mma_3xtf32(big, small, ah[n], al[n], yr[8 * d], yr[ld + 8 * d]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = __fadd_rn(acc[d][e], fold_rn(big[e], small[e]));
  }
}

}  // namespace
