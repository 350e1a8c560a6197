// Tensor-core pieces shared by the bf16 attention kernels under csrc/
// (flash_attention_online_mma.cu, attention_train_mma.cu): the warp-level
// bf16 product mma.sync m16n8k16 with f32 accumulators, ldmatrix fragment
// loads (plain and transposed), cp.async 16-byte copies into padded shared
// tiles, and the quad reductions that give a row's max and sum on the
// accumulator fragments.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16
// with floating point type"), g = lane / 4, t = lane % 4:
//   A [16 x 16] row:  a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                     a3 = (g+8, 2t+8..), two bf16 a register;
//   B [16 x 8] col:   b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C [16 x 8] f32:   c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g+8, 2t), (g+8, 2t+1).
// So the accumulators of two neighbouring 8-column tiles of a product are,
// packed to bf16 pairs, the A fragment of one 16-deep step of the next
// product (the FlashAttention-2 register layout): P never goes to shared
// memory.
//
// Shared tiles are [rows][TILE_LD] bf16 with TILE_LD = 64 + 8: a row is 144
// bytes, so the eight 16-byte rows an ldmatrix 8x8 reads start 4 banks
// apart and never conflict, and every row start stays 16-byte aligned for
// cp.async. The pieces that depend on the head width are templated on it
// (MmaDims<DH>, default 64: the 64-wide kernels' code is unchanged); at 80
// wide a padded row is 88 bf16, 176 bytes, and the eight rows start 44
// words apart: banks 0, 12, 24, 4, 16, 28, 8, 20, again conflict-free.
//
// Everything lives in an anonymous namespace, as in common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MMA_DH = 64;            // the head width these kernels take
constexpr int TILE_LD = MMA_DH + 8;   // padded row of a shared tile, in bf16
constexpr int DH_CHUNKS = MMA_DH / 8; // 16-byte chunks in a row of the head dim

// The shapes that follow from a head width DH (MMA_DH, or 80 for the
// headwise block's heads).
template <int DH>
struct MmaDims {
  static constexpr int LD = DH + 8;      // padded row of a shared tile, in bf16
  static constexpr int CHUNKS = DH / 8;  // 16-byte chunks in a row of the head dim
  static_assert(DH % 16 == 0, "heads a multiple of 16 wide");
  // an ldmatrix 8x8 reads eight 16-byte rows: they fall on distinct
  // 4-bank groups when a row spans an odd number of 16-byte units
  static_assert((LD * 2 / 16) % 2 == 1, "ldmatrix rows conflict-free");
  static_assert(LD * 2 % 16 == 0, "rows 16-byte aligned for cp.async");
};
static_assert(MmaDims<MMA_DH>::LD == TILE_LD, "the 64-wide tiles as before");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the 16 bytes (a row past
// N or a masked V row) without reading global memory.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), each rounded to
// nearest even as torch's cast
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// max / sum over the four lanes of a quad (the lanes that share a row of
// an accumulator fragment), in a fixed order
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Rows [r0, r0 + rows) of a [*, DH] bf16 operand (row stride sn
// elements) into a shared tile of `cap` rows, with cp.async; rows at or
// past `live` are zero-filled. All `threads` threads of the block take part.
template <int DH = MMA_DH>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long sn, int r0, int cap, int live,
                                                int threads) {
  constexpr int CHUNKS = MmaDims<DH>::CHUNKS, LD = MmaDims<DH>::LD;
  for (int c = threadIdx.x; c < cap * CHUNKS; c += threads) {
    const int i = c / CHUNKS, part = c % CHUNKS;
    const bool in = r0 + i < live;
    // an out-of-range row reads nothing; its source address stays in bounds
    const __nv_bfloat16* s = src + (in ? (long long)(r0 + i) * sn + part * 8 : 0);
    cp_async16(smem_addr(dst + i * LD + part * 8), s, in ? 16 : 0);
  }
}

// The A fragments of a warp's 16 rows x DH from a shared tile: a[kc] is
// the 16-deep step kc (columns 16 kc .. 16 kc + 15).
template <int DH = MMA_DH>
__device__ __forceinline__ void load_a_frags(uint32_t a[DH / 16][4], const __nv_bfloat16* tile,
                                             int row0, int lane) {
  constexpr int LD = MmaDims<DH>::LD;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldmatrix_x4(a[kc], smem_addr(tile + (row0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8));
}

// B fragments for X Y^T where Y is a shared tile [n][DH] (keys, or
// queries, by rows): for 16 rows n0.. of Y and the 16-deep step kc, b[0..1]
// for the 8-column tile n0.. and b[2..3] for n0 + 8.. .
template <int DH = MMA_DH>
__device__ __forceinline__ void load_b_rows(uint32_t b[4], const __nv_bfloat16* tile, int n0, int kc,
                                            int lane) {
  constexpr int LD = MmaDims<DH>::LD;
  ldmatrix_x4(b, smem_addr(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                           ((lane >> 3) & 1) * 8));
}

// B fragments for X Y where Y is a shared tile [k][DH] (k: keys or
// queries): for the 16-deep step over rows k0.. and columns d0..d0 + 15,
// b[0..1] for the 8 columns d0.. and b[2..3] for d0 + 8.. .
template <int DH = MMA_DH>
__device__ __forceinline__ void load_b_cols(uint32_t b[4], const __nv_bfloat16* tile, int k0, int d0,
                                            int lane) {
  constexpr int LD = MmaDims<DH>::LD;
  ldmatrix_x4_trans(b, smem_addr(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + d0 +
                                 (lane >> 4) * 8));
}

// acc[16 x 8 n-tiles] += A[16 x 16 kk-steps] Y, Y a shared [k][DH] tile:
// the PV / dS K / P^T dO / dS^T Q product of one warp for 16 kk rows of Y
// starting at k0.
template <int DH = MMA_DH>
__device__ __forceinline__ void mma_a_by_cols(float acc[DH / 8][4], const uint32_t a[4],
                                              const __nv_bfloat16* tile, int k0, int lane) {
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t b[4];
    load_b_cols<DH>(b, tile, k0, dp * 16, lane);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// s[NT 8-column tiles][4] = A Y^T for a warp's 16 rows (A fragments over
// the head dim) against NT * 8 rows of a shared tile Y [n][DH].
template <int NT, int DH = MMA_DH>
__device__ __forceinline__ void mma_rows(float s[NT][4], const uint32_t a[DH / 16][4],
                                         const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      load_b_rows<DH>(b, tile, np * 16, kc, lane);
      mma_bf16(s[2 * np], a[kc], b[0], b[1]);
      mma_bf16(s[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// the A fragment of the 16-deep step kk from accumulators of 8-column tiles
// 2 kk and 2 kk + 1, each element cast to bf16
__device__ __forceinline__ void a_from_acc(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// a warp's [16 x DH] f32 accumulators, cast to bf16, into rows of out
// (row stride sn) where the row is below `rows`; row0 is the warp's first
// row.
template <int DH = MMA_DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sn, const float acc[DH / 8][4],
                                           int row0, int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= rows) continue;
    __nv_bfloat16* o = out + (long long)r * sn + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// s[n] = s[n] * scale + kb[j] for the keys j = j0 + 8 n + 2t (+ 1) of a
// tile (rows g and g + 8 share a key), each operation rounded on its own;
// keys at or past N are only scaled (the softmax masks them). ToMe's key
// bias in row 1's tensor-core routes (attn_block_mma.cuh, attn_block_tf32.cuh).
template <int NT>
__device__ __forceinline__ void add_key_bias(float s[NT][4], const float* kb, float scale, int j0,
                                             int N, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + 8 * n + 2 * t + c;
      const float bias = j < N ? kb[j] : 0.f;
      s[n][c] = __fadd_rn(__fmul_rn(s[n][c], scale), bias);
      s[n][c + 2] = __fadd_rn(__fmul_rn(s[n][c + 2], scale), bias);
    }
}

}  // namespace
