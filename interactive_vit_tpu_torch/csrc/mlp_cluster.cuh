// Pieces shared by the tensor-core MLP-branch kernels under csrc/
// (fused_mlp_block_mma.cu, bf16; fused_mlp_block_tf32.cu, f32 on split
// TF32; fused_mlp_w8a8_mma.cu, W8A8): the split of
// the hidden dimension over the blocks of a thread-block cluster, the row
// tile, the ring of weight tiles, the LayerNorm of a row staged in shared
// memory, the int8 product mma.sync m16n8k32 with its B operand transposed
// in shared memory, and the sum of the blocks' fc2 partials over
// distributed shared memory (DSMEM).
//
// The split. A cluster of S blocks (S = mc_cluster_size(md): the largest
// power of two up to MC_MAX_CLUSTER that divides md / MC_NC, at least
// MC_MIN_CLUSTER) takes one tile of BM rows; block `rank` of it owns the
// hidden columns [rank * md / S, (rank + 1) * md / S): it reads only that
// slice of fc1's columns and of fc2's rows, so the cluster reads each
// weight byte once for its row tile. LN2 is computed once a cluster: each
// block normalizes BM / S rows and copies the others from its peers over
// DSMEM. fc2's output is summed over the S slices: each block writes its
// partial sums of one chunk of MC_NC output columns into its own shared
// memory and arrives at the cluster barrier; after the next chunk's
// products it waits, and block `rank` adds up, in rank order 0, 1, ...,
// S - 1, the S partials of the MC_NC / S columns of the previous chunk it
// owns, read from the peers' shared memory. Two buffers alternate: the
// barrier a chunk orders the writes before the peers' reads and the reads
// before the buffer's next write. No block leaves before a last cluster
// barrier: a peer may still read its shared memory.
//
// The row tile BM is 32 or 64, chosen by the caller (ops/fused_mlp.py's
// row_tile): 32 while the 32-row tiles of M rows fit the clusters the card
// holds at once, so one image (197 rows) takes 7 clusters of 8 blocks, not
// 4; more rows take 64, each block then reading its weight slice once for
// twice the rows.
//
// Eight warps a block; warp w takes rows (w / 4) * BM / 2 and the 32
// columns (w % 4) * 32 of a chunk of MC_NC columns, BM / 32 16-row tiles by
// four 8-column tiles. The weights stream through a three-stage cp.async
// ring of 16 KB stages (8 KB for the W8A8 kernel's f32 activations, whose
// h takes the room), every thread issuing its share of the copies.
//
// The narrow chunk. Rows a multiple of 96 but not of 128 wide (swin_t's
// stages 0 and 1: d = 96 and 192, hidden 384 and 768) take chunks of
// MC_NC_NARROW = 96 columns (all three kernels): one or two chunks of d,
// and 4 or 8 of the hidden dimension, so the clusters are again of 4 and 8
// blocks and the rank-order sums, the partial buffers and McTile's items
// keep their logic. A bf16 or f32 warp then takes 24 columns, three
// 8-column tiles (McChunk<96>); an int8 warp keeps 32 (the prmt transpose's
// four columns a thread), so three warps take a chunk. The pieces below
// that depend on the chunk take it as a template argument NC whose default
// is MC_NC, so the 128-wide code is the code it was.
//
// Everything lives in an anonymous namespace, as in common.cuh.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_attention.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MC_THREADS = 256, MC_WARPS = MC_THREADS / 32;
constexpr int MC_ROWS = 64;            // rows of a tile (one cluster), at most
constexpr int MC_NC = 128;             // columns of a chunk (fc1 hidden, fc2 output)
constexpr int MC_NC_NARROW = 96;       // the narrow chunk (rows a multiple of 96, not 128)
constexpr int MC_MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MC_MIN_CLUSTER = 4;      // so a thread owns at most McTile::ITEMS groups
constexpr int MC_STAGES = 3;           // the weight ring
// weight bytes a stage (MC_NC columns): 16 KB where the block's shared
// memory allows (bf16 activations), else 8 KB (the W8A8 kernel's f32 h)
constexpr int MC_STAGE_BYTES = 16384, MC_STAGE_BYTES_F32 = 8192;
constexpr int MC_MAX_WIDTH = 1280;     // the widest row (LayerNorm in registers)
// 16-column units a lane owns, at most: a row of MC_MAX_WIDTH has
// MC_MAX_WIDTH / 16 of them over 32 lanes (1280: 80, lanes 0-15 own 3)
constexpr int MC_UNITS = (MC_MAX_WIDTH / 16 + 31) / 32;
constexpr int MC_PLD = MC_NC + 4;      // a row of a partial buffer, 32-bit words

// The shapes that follow from a chunk of NC columns (128 or 96): a row of a
// partial buffer (32-bit words), a warp's columns of a chunk (four warps
// across it) and their 8-column tiles.
template <int NC>
struct McChunk {
  static_assert(NC == MC_NC || NC == MC_NC_NARROW, "chunks of 128 or 96 columns");
  static constexpr int PLD = NC + 4;
  static constexpr int WN = NC / 4;
  static constexpr int NT = WN / 8;
};

// The shapes that follow from a tile of BM rows (32 or 64): a warp's 16-row
// tiles, a thread's 4-column groups of a chunk's sums (at most: with
// chunks of 96 the last item is short of threads), the two partial
// buffers ([BM][PLD] of 32 bits each).
template <int BM, int NC = MC_NC>
struct McTile {
  static_assert(BM == 32 || BM == 64, "tiles of 32 or 64 rows");
  static constexpr int MT = BM / 32;
  static constexpr int ITEMS = (BM * NC / 4 / MC_MIN_CLUSTER + MC_THREADS - 1) / MC_THREADS;
  static constexpr size_t PBUF = 2 * (size_t)BM * McChunk<NC>::PLD * 4;
};

// Cluster size for md hidden columns in chunks of NC, or 0 where md is not
// a whole number of chunks or takes fewer than MC_MIN_CLUSTER blocks (a 4x
// MLP on rows of a multiple of NC always takes 4 or 8).
template <int NC = MC_NC>
__host__ __device__ inline int mc_cluster_size(int md) {
  if (md <= 0 || md % NC) return 0;
  int s = MC_MAX_CLUSTER;
  while (md % (NC * s)) s >>= 1;
  return s >= MC_MIN_CLUSTER ? s : 0;
}

// The chunk of the three kernels for rows of D: MC_NC where D is a
// multiple of it, else MC_NC_NARROW where D is a multiple of that, at most
// MC_MAX_WIDTH wide; 0 otherwise.
__host__ __device__ inline int mc_chunk_of(int d) {
  if (d <= 0 || d > MC_MAX_WIDTH) return 0;
  return d % MC_NC == 0 ? MC_NC : d % MC_NC_NARROW == 0 ? MC_NC_NARROW : 0;
}

// The cluster size at rows of D and md hidden columns in D's chunks.
__host__ __device__ inline int mc_cluster_of(int d, int md) {
  const int nc = mc_chunk_of(d);
  return nc == MC_NC ? mc_cluster_size<MC_NC>(md)
                     : nc == MC_NC_NARROW ? mc_cluster_size<MC_NC_NARROW>(md) : 0;
}

// Rows [row0, row0 + rows) of a row-major [M, D] matrix of T into a shared
// tile of rows ld_bytes apart, with cp.async (16 bytes a copy, all
// threads); rows at or past M are zero-filled.
template <typename T>
__device__ __forceinline__ void mc_stage_rows(unsigned char* dst, int ld_bytes, const T* src,
                                              int row0, int rows, int M, int D) {
  const int per_row = D * (int)sizeof(T) / 16;
  for (int c = threadIdx.x; c < rows * per_row; c += MC_THREADS) {
    const int r = c / per_row, q = c % per_row;
    const bool in = row0 + r < M;
    const unsigned char* s =
        reinterpret_cast<const unsigned char*>(src) + (in ? ((size_t)(row0 + r) * D) * sizeof(T) + 16 * q : 0);
    cp_async16(smem_addr(dst + r * ld_bytes + 16 * q), s, in ? 16 : 0);
  }
}

// Sixteen consecutive values of T from p (16-byte aligned), as f32.
__device__ __forceinline__ void mc_load16(float v[16], const float* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void mc_load16(float v[16], const __nv_bfloat16* p) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int4 w = reinterpret_cast<const int4*>(p)[q];
    const uint32_t ws[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z, (uint32_t)w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ws[e]));
      v[8 * q + 2 * e] = f.x;
      v[8 * q + 2 * e + 1] = f.y;
    }
  }
}

// LayerNorm of one row of D values staged in shared memory (one warp):
// lane owns the 16-column units lane, lane + 32, ..., v[i][e] column 16
// (lane + 32 i) + e, read 16 bytes at a time (as are ln_s and ln_b).
// Two-pass f32 statistics (each lane sums its values in four interleaved
// chains, then the warp's butterfly); (x - mean) * rstd * ln_s + ln_b as explicitly
// rounded f32 operations, cast to T and back. Returns the number of units
// the lane owns.
template <typename T>
__device__ __forceinline__ int mc_ln_row(float v[MC_UNITS][16], const T* xs,
                                         const T* __restrict__ ln_s, const T* __restrict__ ln_b,
                                         int D, float eps, int lane) {
  const int units = D / 16;
  const int mine = (units - lane + 31) / 32;
  float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: column e into s[e % 4]
#pragma unroll
  for (int i = 0; i < MC_UNITS; ++i) {
    if (i < mine) {
      mc_load16(v[i], xs + 16 * (lane + 32 * i));
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e & 3] += v[i][e];
    }
  }
  const float mean = warp_sum((s[0] + s[1]) + (s[2] + s[3])) / (float)D;
  float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < MC_UNITS; ++i) {
    if (i < mine) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float dv = v[i][e] - mean;
        q[e & 3] += dv * dv;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum((q[0] + q[1]) + (q[2] + q[3])) / (float)D + eps);
#pragma unroll
  for (int i = 0; i < MC_UNITS; ++i) {
    if (i < mine) {
      const int k0 = 16 * (lane + 32 * i);
      float gs[16], gb[16];
      mc_load16(gs, ln_s + k0);
      mc_load16(gb, ln_b + k0);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float z = __fmul_rn(__fsub_rn(v[i][e], mean), rstd);
        v[i][e] = to_f(from_f<T>(__fadd_rn(__fmul_rn(z, gs[e]), gb[e])));
      }
    }
  }
  return mine;
}

// One stage of SB weight bytes: `rows` rows of a row-major matrix (rows
// ld_src_bytes apart), SB / rows bytes (a chunk's columns) from src, into a
// shared tile of rows of ld_dst bytes, with cp.async (16 bytes a copy, all
// threads).
template <int SB>
__device__ __forceinline__ void mc_load_stage(unsigned char* dst, const unsigned char* src,
                                              size_t ld_src_bytes, int rows, int ld_dst) {
  constexpr int CHUNKS = SB / 16;  // 16-byte copies a stage
  const int per_row = CHUNKS / rows;
  for (int c = threadIdx.x; c < CHUNKS; c += MC_THREADS) {
    const int r = c / per_row, q = c % per_row;
    cp_async16(smem_addr(dst + r * ld_dst + 16 * q), src + r * ld_src_bytes + 16 * q, 16);
  }
}

// The ring: `total` stages, load(it, slot) issuing stage it's copies into
// slot it % MC_STAGES and compute(it, slot) consuming it; MC_STAGES - 1
// stages in flight ahead of the one computed. mc_prologue issues the first
// MC_STAGES - 1 (one cp.async group each, which may go out early: before
// other work of the block), mc_loop the rest.
template <typename Load>
__device__ __forceinline__ void mc_prologue(int total, Load load) {
#pragma unroll
  for (int s = 0; s < MC_STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
}

template <typename Load, typename Compute>
__device__ __forceinline__ void mc_loop(int total, Load load, Compute compute) {
  for (int it = 0; it < total; ++it) {
    cp_async_wait<MC_STAGES - 2>();
    __syncthreads();  // stage it landed for all; slot (it - 1) % MC_STAGES is free
    const int nx = it + MC_STAGES - 1;
    if (nx < total) load(nx, nx % MC_STAGES);
    cp_async_commit();
    compute(it, it % MC_STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The 4-column groups of a chunk of NC that block `rank` sums: the chunk's
// columns [rank * NC / S, (rank + 1) * NC / S), all BM rows; thread
// item u (< McTile<BM, NC>::ITEMS) is group threadIdx.x + u * MC_THREADS, at
// row r and chunk column c. False past the last group.
template <int BM, int NC = MC_NC>
__device__ __forceinline__ bool mc_item(int S, int rank, int u, int& r, int& c) {
  const int w4 = NC / S / 4;
  const int e = threadIdx.x + u * MC_THREADS;
  if (e >= BM * w4) return false;
  r = e / w4;
  c = rank * (NC / S) + 4 * (e % w4);
  return true;
}

// The cluster barrier in two halves (barrier.cluster: every thread
// arrives, then waits, in turn; release / acquire order the shared-memory
// writes before the peers' reads): a block arrives once its partials are
// written and waits only before it reads the peers', so one chunk's products
// run while the barrier completes.
__device__ __forceinline__ void mc_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mc_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [q * rows, (q + 1) * rows) of every peer q != rank of a shared tile
// (rows ld bytes apart, row_bytes of each copied, a multiple of 16), read
// over DSMEM into the same rows here: after each block of the cluster has
// written its own rows and the cluster has synced, every block holds the
// whole tile.
__device__ __forceinline__ void mc_gather_rows(cg::cluster_group& cluster, unsigned char* tile,
                                               int ld, int row_bytes, int rows, int S, int rank) {
  const int per_row = row_bytes / 16, per_rank = rows * per_row;
#pragma unroll 4
  for (int e = threadIdx.x; e < (S - 1) * per_rank; e += MC_THREADS) {
    const int qi = e / per_rank, w = e % per_rank;
    const int q = qi < rank ? qi : qi + 1;
    const int r = q * rows + w / per_row;
    int4* p = reinterpret_cast<int4*>(tile + r * ld) + w % per_row;
    *p = *cluster.map_shared_rank(p, q);
  }
}

// The sum over ranks 0, 1, ..., S - 1, in that order, of the peers'
// partials at row r, chunk columns c .. c + 3 of pbuf (rows of
// McChunk<NC>::PLD words; V: int4 or float4; add(V&, V) adds in place).
template <typename V, int NC = MC_NC, typename Add>
__device__ __forceinline__ V mc_sum_ranks(cg::cluster_group& cluster, const uint32_t* pbuf, int S,
                                          int r, int c, Add add) {
  uint32_t* p = const_cast<uint32_t*>(pbuf) + r * McChunk<NC>::PLD + c;
  V w[MC_MAX_CLUSTER];  // every peer's load in flight before the first add
#pragma unroll
  for (int q = 0; q < MC_MAX_CLUSTER; ++q)
    if (q < S) w[q] = *reinterpret_cast<const V*>(cluster.map_shared_rank(p, q));
  V v = w[0];
#pragma unroll
  for (int q = 1; q < MC_MAX_CLUSTER; ++q)
    if (q < S) add(v, w[q]);
  return v;
}

// ---------------------------------------------------------------------------
// int8 products: mma.sync m16n8k32, s8 x s8 -> s32, exact.
//
// The B operand of an int8 mma is K-major (each thread's word holds four
// consecutive k of one column n), and ldmatrix .trans moves 16-bit
// elements only, so it cannot transpose a [k][n] int8 tile. The weights
// stay in the model's [D_in, D_out] row-major layout in device memory and
// in the shared tiles; each thread reads four 32-bit words, one from each
// of four k rows at its four consecutive columns, and transposes that 4 x 4
// block of bytes with __byte_perm (prmt) into four fragment words, one for
// each of four 8-column tiles. Two consequences, both absorbed by the
// order-free integer sums:
//   * columns: 8-column tile j of a warp's 32 holds columns 4 n + j (n the
//     tile's column 0..7), so a thread's four words serve four tiles, and a
//     thread's accumulators of the four tiles are 8 consecutive columns;
//   * depth: within each 16 k of a k32 step, mma index 4 t + i is k = t + 4 i,
//     so the four rows a thread reads are t, t + 4, t + 8, t + 12 (rows
//     MC_W8_LD = 160 bytes apart at chunks of 128: 40 words, so the four t
//     land on banks 8 apart and a warp's 32 loads on 32 banks; 96 bytes, 24
//     words, at chunks of 96 do the same); the A operand (the
//     activations, which the kernel writes into shared memory itself) is
//     stored with the same 4 x 4 transpose of each 16-byte group
//     (mc_pack16_mma), and ldmatrix reads it unchanged.

constexpr int MC_W8_LD = MC_NC + 32;  // a row of an int8 tile, bytes

// Sixteen int8 values q[0..15] of consecutive columns as one 16-byte word:
// in column order (a tap), and in the A operand's order, byte 4 w + i
// holding column w + 4 i (the 4 x 4 transpose above).
__device__ __forceinline__ int4 mc_pack16(const int q[16]) {
  return make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                   pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

__device__ __forceinline__ int4 mc_pack16_mma(const int q[16]) {
  return make_int4(pack4(q[0], q[4], q[8], q[12]), pack4(q[1], q[5], q[9], q[13]),
                   pack4(q[2], q[6], q[10], q[14]), pack4(q[3], q[7], q[11], q[15]));
}

// c += a b, s8 operands, s32 accumulators (not volatile: a register-only
// operation the compiler may schedule between the shared-memory loads)
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// b[j] = bytes j of the words at p, p + 4 ld, p + 8 ld, p + 12 ld (k rows
// t, t + 4, t + 8, t + 12 of the thread's four columns): the 4 x 4 byte
// transpose, eight prmt
__device__ __forceinline__ void mc_load_b_s8(uint32_t b[4], const unsigned char* p, int ld) {
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 4 * ld);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 12 * ld);
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
  b[0] = __byte_perm(lo01, lo23, 0x5410);
  b[1] = __byte_perm(lo01, lo23, 0x7632);
  b[2] = __byte_perm(hi01, hi23, 0x5410);
  b[3] = __byte_perm(hi01, hi23, 0x7632);
}

// A warp's int8 stage of KS k32 steps: acc[mt][j] += A[16 mt.., k32]
// B[k32, tile j] for its MT 16-row tiles (A rows a_row0.. of a
// [*][lda] int8 tile in the mc_pack16_mma order, k0 the stage's first k) and
// its four 8-column tiles (B: a weight stage at b, rows LDB bytes apart,
// its 32 columns from col0); every fragment of the stage is loaded before
// the first product.
template <int KS, int MT, int LDB = MC_W8_LD>
__device__ __forceinline__ void mc_mma_s8_stage(int acc[MT][4][4], const int8_t* a_tile, int lda,
                                                int a_row0, int k0, const unsigned char* b,
                                                int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KS][MT][4], b0[KS][4], b1[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[ks][mt], smem_addr(a_tile + (a_row0 + 16 * mt + (lane & 15)) * lda + k0 +
                                       32 * ks + (lane >> 4) * 16));
    const unsigned char* bp = b + 32 * ks * LDB + col0 + 4 * g;
    mc_load_b_s8(b0[ks], bp + t * LDB, LDB);
    mc_load_b_s8(b1[ks], bp + (16 + t) * LDB, LDB);
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a[ks][mt], b0[ks][j], b1[ks][j]);
}

// ---------------------------------------------------------------------------
// bf16 products: mma.sync m16n8k16 with ldmatrix (A) and ldmatrix .trans (B,
// a [k][n] tile), the accumulators in the usual layout (tile j of a warp's
// 32 columns holds columns 8 j .. 8 j + 7; of its 24 with chunks of 96).

constexpr int MC_BF_ROWS = MC_STAGE_BYTES / (2 * MC_NC);  // k rows of a bf16 stage (64)
constexpr int MC_BF_LD = MC_NC + 8;                       // a row of a bf16 tile, elements

// A bf16 weight stage at chunks of NC: its k rows (64 at 128, a 16 KB
// stage; 48 at 96, which divides both 96 and a slice of 96) and its row
// stride (NC + 8 elements: an odd number of 16-byte units, so ldmatrix's
// eight rows fall on distinct bank groups).
template <int NC>
struct McBf16Stage {
  static constexpr int ROWS = NC == MC_NC ? MC_BF_ROWS : 48;
  static constexpr int LD = NC == MC_NC ? MC_BF_LD : NC + 8;
  static constexpr int BYTES = ROWS * NC * 2;  // the weight bytes a stage holds
  static_assert((LD * 2 / 16) % 2 == 1, "ldmatrix rows conflict-free");
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a b, bf16 operands, f32 accumulators: mma_attention.cuh's mma_bf16,
// not volatile, so the compiler may schedule it between the shared-memory
// loads
__device__ __forceinline__ void mc_mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's bf16 stage of McBf16Stage<NC>::ROWS / 16 k16 steps for its MT
// 16-row tiles (A rows a_row0.. of a [*][lda] bf16 tile, k0 the stage's
// first k; B a weight stage at b, its McChunk<NC>::WN columns from col0:
// pairs of 8-column tiles by ldmatrix .x4 .trans, a last odd one (chunks of
// 96) by .x2); every fragment of the stage is loaded before the first
// product.
template <int MT, int NC = MC_NC>
__device__ __forceinline__ void mc_mma_bf16_stage(float acc[MT][McChunk<NC>::NT][4],
                                                  const __nv_bfloat16* a_tile, int lda, int a_row0,
                                                  int k0, const __nv_bfloat16* b, int col0,
                                                  int lane) {
  constexpr int KS = McBf16Stage<NC>::ROWS / 16, LD = McBf16Stage<NC>::LD;
  constexpr int NT = McChunk<NC>::NT, JP = NT / 2;
  uint32_t a[KS][MT][4], bb[KS][JP][4], bo[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[ks][mt], smem_addr(a_tile + (a_row0 + 16 * mt + (lane & 15)) * lda + k0 +
                                       16 * ks + (lane >> 4) * 8));
#pragma unroll
    for (int jp = 0; jp < JP; ++jp)
      ldmatrix_x4_trans(bb[ks][jp],
                        smem_addr(b + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  col0 + 16 * jp + (lane >> 4) * 8));
    if constexpr (NT % 2 == 1) {
      ldmatrix_x2_trans(bo[ks], smem_addr(b + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                          col0 + 16 * JP));
    }
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int jp = 0; jp < JP; ++jp)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mc_mma_bf16(acc[mt][2 * jp], a[ks][mt], bb[ks][jp][0], bb[ks][jp][1]);
        mc_mma_bf16(acc[mt][2 * jp + 1], a[ks][mt], bb[ks][jp][2], bb[ks][jp][3]);
      }
    if constexpr (NT % 2 == 1) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mc_mma_bf16(acc[mt][NT - 1], a[ks][mt], bo[ks][0], bo[ks][1]);
    }
  }
}

// Lets kernel take up to SMEM_LIMIT bytes of dynamic shared memory on the
// current device: once a device, before its first launch or occupancy
// query (the launch itself sets nothing).
template <typename Kernel>
cudaError_t mc_prepare(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_LIMIT);
}

// Launches kernel on a grid of (S, tiles of bm rows) blocks in clusters of
// (S, 1, 1), with `smem` bytes of dynamic shared memory, on the caller's
// stream (mc_prepare'd on its device).
template <typename Kernel, typename Args>
cudaError_t mc_launch(Kernel kernel, const Args& a, int S, int M, int bm, size_t smem,
                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (M + bm - 1) / bm, 1);
  cfg.blockDim = dim3(MC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of S blocks with `smem` bytes each that the card holds at once
// (cudaOccupancyMaxActiveClusters; kernel mc_prepare'd), or -1 on an error.
template <typename Kernel>
int mc_max_clusters(Kernel kernel, int S, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, 64, 1);
  cfg.blockDim = dim3(MC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace
