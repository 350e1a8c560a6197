// Fused MLP branch on Hopper's bf16 tensor cores (sm_90a):
//     y = x + fc2(gelu_tanh(fc1(LN2(x)))),
// both products bf16 x bf16 -> f32 with mma.sync m16n8k16, the hidden
// activations never written to device memory, and the hidden dimension
// split over the blocks of a thread-block cluster.
//
// Replaces, for bf16 operands it takes (rows a multiple of 128 or of 96
// wide and at most 1280, a hidden dimension of whole chunks of that width,
// 16-byte aligned), the Pallas TPU kernel
// interactive_vit_tpu/ops/fused_mlp.py::fused_mlp_block (_kernel); f32
// takes fused_mlp_block_tf32.cu (split TF32), other operands
// fused_mlp_block.cu (f32 FMA). The cast points are
// that kernel's: LayerNorm with f32 statistics, scaled and shifted in f32,
// cast to bf16 (the A operand of fc1); h = gelu_tanh(ln @ fc1_w accumulated
// in f32 + fc1_b) in f32, cast to bf16 (the A operand of fc2); y = (x in
// f32 + h @ fc2_w accumulated in f32) + fc2_b, cast to bf16. The f32 sums
// of the products run in the tensor cores' order, and fc2's sum is the sum
// of S partial sums (one a block of the cluster) added in rank order 0, 1,
// ..., S - 1, so two calls give the same bits.
//
// What bounds it on this card: at vit_b16 (197 x 768, hidden 3072, B = 1)
// the work is 1.86 GFLOP over 9.4 MB of bf16 weights: bound by bytes, 3.0
// us at 3.35 TB/s (1.9 us of operations at the bf16 tensor-core peak).
// fused_mlp_block.cu does both products with f32 FMA in 13 blocks of 16
// rows, each streaming every weight element from L2, and takes ~0.8 ms.
//
// Design (the layout of fused_mlp_w8a8_mma.cu; mlp_cluster.cuh). A cluster
// of S blocks (S = 8 at vit_b16, 4 at swin_t's stage 2) takes a tile of BM
// rows (32 for one image, 64 from about three images on: the caller's
// choice, ops/fused_mlp.py's row_tile), block `rank` the
// hidden slice [rank md / S, (rank + 1) md / S), so each block reads 1/S of
// each weight matrix (1.18 MB at vit_b16). Each block: LN2 of its BM / S
// rows (x staged by cp.async), the others' copied from its peers (DSMEM),
// into shared memory (bf16); fc1 + bias + GELU for its slice, 128 columns
// at a time, the fc1 tiles (64 x 128 bf16) streaming through a three-stage
// cp.async ring, B fragments by ldmatrix .trans, h (bf16) kept in shared
// memory; then its fc2 partials over its slice, 128 output columns at a
// time, summed over the cluster in rank order through DSMEM a chunk later
// by the block that owns each 128 / S columns, which writes y for them.
//
// Shared memory (dynamic): LN2's rows [BM][d + 8] bf16, whose space the
// fc2 partial buffers take over; h [BM][slice + 8] bf16; the ring of three
// 64 x 136 bf16 tiles. At vit_b16 with tiles of 64 201,728 bytes: one
// block an SM, 15 clusters at once.
//
// Where the time goes (block (0, 0) of vit_b16, B = 1, tiles of 32;
// kernel_variants' row6_time_phases, NVIDIA H100 80GB HBM3, 700 W): LN2 5.4
// us, fc1 + GELU 28.4, fc2 and the cluster sums 37.7. Each block streams
// 1.18 MB of weights and does 9,216 m16n8k16 products per 32 rows; the
// copies' issue and the products (mma.sync and its ldmatrix traffic) take
// turns in each warp.
//
// Chunks of 96 (mlp_cluster.cuh's narrow chunk: swin_t's stages 0 and 1,
// d = 96 and 192, hidden 384 and 768, clusters of 4 and 8 whose slice is
// one chunk): the same code at NC = 96 (mlp_mma96_kernel), a warp on 24
// columns (three n8 tiles, the third by ldmatrix .x2 .trans), weight stages
// of 48 k rows (96 + 8 elements a row). mlp_mma_kernel, at 128, is the code
// it was (kernel_variants --sass).
//
// Variants (tools/kernel_variants.py, device time at vit_b16, B = 1 / 8,
// NVIDIA H100 80GB HBM3, 700 W; ptxas: 124 registers with tiles of 32,
// 162 with 64, no spill): the source (the tile by M) 0.0741 / 0.1782 ms;
// tiles of 32 always 0.0741 / 0.2899; tiles of 64 always 0.0901 / 0.1785;
// 8 KB stages 0.0925 / 0.2253. The FMA kernel: 0.7927 / 0.8081. Rejected
// on the way: as for fused_mlp_w8a8_mma.cu.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "mlp_cluster.cuh"

namespace {

typedef __nv_bfloat16 bf16;

struct MlpMmaArgs {
  const bf16* x;
  const bf16* ln_s;
  const bf16* ln_b;
  const bf16* w1;  // [D, MD]
  const bf16* b1;  // [MD]
  const bf16* w2;  // [MD, D]
  const bf16* b2;  // [D]
  bf16* y;
  int M, D, MD;
  float eps;
};

// The byte layout of a block's dynamic shared memory.
struct BfLayout {
  size_t ln, h, ring, total;
  int lda, ldh;  // row strides, elements
};

template <int NC = MC_NC>
__host__ __device__ inline BfLayout bf_layout(int d, int md, int bm) {
  BfLayout L;
  const int slice = md / mc_cluster_size<NC>(md);
  L.lda = d + 8;  // d / 8 even: rows of an odd number of 16-byte units
  L.ldh = slice + 8;
  L.ln = 0;
  const size_t ln = (size_t)bm * L.lda * sizeof(bf16),
               pbuf = 2 * (size_t)bm * McChunk<NC>::PLD * 4;
  L.h = ln > pbuf ? ln : pbuf;
  L.ring = L.h + (size_t)bm * L.ldh * sizeof(bf16);
  L.total = L.ring + (size_t)MC_STAGES * McBf16Stage<NC>::ROWS * McBf16Stage<NC>::LD *
                         sizeof(bf16);  // 16 KB stages at 128
  return L;
}

// The kernel at tiles of BM rows and chunks of NC columns.
template <int BM, int NC>
__device__ __forceinline__ void mlp_mma_body(const MlpMmaArgs& a) {
  constexpr int MT = McTile<BM, NC>::MT, ITEMS = McTile<BM, NC>::ITEMS;
  constexpr int NT = McChunk<NC>::NT, WN = McChunk<NC>::WN, PLD = McChunk<NC>::PLD;
  constexpr int KR = McBf16Stage<NC>::ROWS, LD = McBf16Stage<NC>::LD;
  extern __shared__ int4 mlpm_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(mlpm_smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)gridDim.x, rank = (int)cluster.block_rank();  // grid x = cluster x
  const int D = a.D, MD = a.MD, slice = MD / S, hid0 = rank * slice;
  const BfLayout L = bf_layout<NC>(D, MD, BM);
  bf16* lns = reinterpret_cast<bf16*>(smem + L.ln);
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem + L.ln);  // after fc1
  bf16* hs = reinterpret_cast<bf16*>(smem + L.h);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  constexpr int STAGE = KR * LD;  // elements

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = (warp >> 2) * (BM / 2), wn = warp & 3;
  const int row0 = blockIdx.y * BM;

  const int ks1 = D / KR, total1 = (slice / NC) * ks1;
  auto load1 = [&](int it, int slot) {
    const int c = it / ks1, kt = it % ks1;
    mc_load_stage<McBf16Stage<NC>::BYTES>(reinterpret_cast<unsigned char*>(ring + slot * STAGE),
                  reinterpret_cast<const unsigned char*>(a.w1 + (size_t)kt * KR * MD +
                                                         hid0 + c * NC),
                  (size_t)MD * sizeof(bf16), KR, LD * (int)sizeof(bf16));
  };

  // LN2 in place, once a cluster: each block stages its BM / S rows of
  // x by cp.async (fc1's first weight stages behind them), normalizes them
  // (one warp a row, cast to bf16), and gathers the others from its peers
  const int rpr = BM / S;
  mc_stage_rows<bf16>(reinterpret_cast<unsigned char*>(lns + rank * rpr * L.lda),
                      L.lda * (int)sizeof(bf16), a.x, row0 + rank * rpr, rpr, a.M, D);
  cp_async_commit();
  mc_prologue(total1, load1);
  cp_async_wait<MC_STAGES - 1>();
  __syncthreads();
  for (int r = rank * rpr + warp; r < (rank + 1) * rpr; r += MC_WARPS) {
    bf16* lr = lns + r * L.lda;
    float v[MC_UNITS][16];
    const int mine = mc_ln_row<bf16>(v, lr, a.ln_s, a.ln_b, D, a.eps, lane);
#pragma unroll
    for (int u = 0; u < MC_UNITS; ++u) {
      if (u >= mine) break;
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = pack_bf16(v[u][2 * e], v[u][2 * e + 1]);  // exact
      int4* dst = reinterpret_cast<int4*>(lr + 16 * (lane + 32 * u));
      dst[0] = make_int4(w[0], w[1], w[2], w[3]);
      dst[1] = make_int4(w[4], w[5], w[6], w[7]);
    }
  }
  cluster.sync();  // every block's rows written
  mc_gather_rows(cluster, reinterpret_cast<unsigned char*>(lns), L.lda * (int)sizeof(bf16),
                 D * (int)sizeof(bf16), rpr, S, rank);
  mc_cluster_arrive();  // this block's gather done; waited for before the
                        // first fc2 partials reuse the space
  // (the ring's first __syncthreads orders these writes before fc1)

  float acc[MT][NT][4], b1p[2 * NT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  // fc1 + bias + GELU over the slice, NC hidden columns a chunk; each
  // chunk's b1 fetched into registers at its first stage
  mc_loop(total1, load1, [&](int it, int slot) {
    const int c = it / ks1, kt = it % ks1;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int hj = hid0 + c * NC + wn * WN + 8 * j + 2 * t;
        b1p[2 * j] = __bfloat162float(a.b1[hj]);
        b1p[2 * j + 1] = __bfloat162float(a.b1[hj + 1]);
      }
    }
    mc_mma_bf16_stage<MT, NC>(acc, lns, L.lda, wr0, kt * KR, ring + slot * STAGE, wn * WN, lane);
    if (kt != ks1 - 1) return;
    // tile j of the warp holds columns wn * WN + 8 j + 2 t, + 1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c * NC + wn * WN + 8 * j + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wr0 + 16 * mt + g + 8 * half;
          *reinterpret_cast<uint32_t*>(hs + r * L.ldh + col) =
              pack_bf16(gelu_tanh(acc[mt][j][2 * half] + b1p[2 * j]),
                        gelu_tanh(acc[mt][j][2 * half + 1] + b1p[2 * j + 1]));
          acc[mt][j][2 * half] = acc[mt][j][2 * half + 1] = 0.f;
        }
      }
  });

  // fc2 partials over the slice, NC output columns a chunk, summed over
  // the cluster in rank order; y for the owned columns
  const int ks2 = slice / KR, total2 = (D / NC) * ks2;
  auto load2 = [&](int it, int slot) {
    const int oc = it / ks2, kt = it % ks2;
    mc_load_stage<McBf16Stage<NC>::BYTES>(reinterpret_cast<unsigned char*>(ring + slot * STAGE),
                  reinterpret_cast<const unsigned char*>(
                      a.w2 + (size_t)(hid0 + kt * KR) * D + oc * NC),
                  (size_t)D * sizeof(bf16), KR, LD * (int)sizeof(bf16));
  };
  // y for the owned columns of chunk c from the partials of pbuf[c & 1],
  // x and b2 fetched into registers beforehand (xp, b2p)
  float xp[ITEMS][4], b2p[ITEMS][4];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      int r, cc;
      if (!mc_item<BM, NC>(S, rank, u, r, cc)) break;
      const int row = min(row0 + r, a.M - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c * NC + cc + i;
        xp[u][i] = __bfloat162float(a.x[(size_t)row * D + col]);
        b2p[u][i] = __bfloat162float(a.b2[col]);
      }
    }
  };
  auto reduce = [&](int c) {
    const uint32_t* pb = pbuf + (c & 1) * BM * PLD;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      int r, cc;
      if (!mc_item<BM, NC>(S, rank, u, r, cc)) break;
      const float4 v = mc_sum_ranks<float4, NC>(cluster, pb, S, r, cc, [](float4& v, const float4 w) {
        v.x = __fadd_rn(v.x, w.x);
        v.y = __fadd_rn(v.y, w.y);
        v.z = __fadd_rn(v.z, w.z);
        v.w = __fadd_rn(v.w, w.w);
      });
      const int row = row0 + r;
      if (row >= a.M) continue;
      const float vs[4] = {v.x, v.y, v.z, v.w};
      uint32_t w2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w2[i] = pack_bf16(__fadd_rn(__fadd_rn(xp[u][2 * i], vs[2 * i]), b2p[u][2 * i]),
                          __fadd_rn(__fadd_rn(xp[u][2 * i + 1], vs[2 * i + 1]), b2p[u][2 * i + 1]));
      *reinterpret_cast<uint2*>(a.y + (size_t)row * D + c * NC + cc) = make_uint2(w2[0], w2[1]);
    }
  };
  // chunk oc: its products; then the previous chunk's sums (its barrier
  // arrived a chunk ago), then its own partials, then this chunk's arrival
  mc_prologue(total2, load2);
  mc_loop(total2, load2, [&](int it, int slot) {
    const int oc = it / ks2, kt = it % ks2;
    if (kt == 0 && oc > 0) fetch(oc - 1);
    mc_mma_bf16_stage<MT, NC>(acc, hs, L.ldh, wr0, kt * KR, ring + slot * STAGE, wn * WN, lane);
    if (kt != ks2 - 1) return;
    mc_cluster_wait();  // chunk oc - 1's partials written (at chunk 0: the gathers done)
    if (oc > 0) reduce(oc - 1);
    float* pb = reinterpret_cast<float*>(pbuf + (oc & 1) * BM * PLD);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wr0 + 16 * mt + g + 8 * half;
          *reinterpret_cast<float2*>(pb + r * PLD + wn * WN + 8 * j + 2 * t) =
              make_float2(acc[mt][j][2 * half], acc[mt][j][2 * half + 1]);
          acc[mt][j][2 * half] = acc[mt][j][2 * half + 1] = 0.f;
        }
    mc_cluster_arrive();  // the chunk's partials written
  });
  fetch(D / NC - 1);
  mc_cluster_wait();
  reduce(D / NC - 1);
  cluster.sync();  // no block leaves while a peer may read its partials
}

template <int BM>
__global__ void __launch_bounds__(MC_THREADS) mlp_mma_kernel(const MlpMmaArgs a) {
  mlp_mma_body<BM, MC_NC>(a);
}

template <int BM>
__global__ void __launch_bounds__(MC_THREADS) mlp_mma96_kernel(const MlpMmaArgs a) {
  mlp_mma_body<BM, MC_NC_NARROW>(a);
}

// The instantiation for chunks of nc and tiles of bm rows (32 or 64), and
// its block's shared memory at (d, md).
struct MmaKernel {
  void (*fn)(const MlpMmaArgs);
  size_t smem;
};

inline MmaKernel mma_kernel(int nc, int bm, int d, int md) {
  if (nc == MC_NC)
    return {bm == 32 ? mlp_mma_kernel<32> : mlp_mma_kernel<64>, bf_layout<MC_NC>(d, md, bm).total};
  return {bm == 32 ? mlp_mma96_kernel<32> : mlp_mma96_kernel<64>,
          bf_layout<MC_NC_NARROW>(d, md, bm).total};
}

// Rows of d and md hidden columns the kernel takes: their chunk, else 0.
inline int mma_chunk(int d, int md) {
  return mc_cluster_of(d, md) == 0 ? 0 : mc_chunk_of(d);
}

}  // namespace

extern "C" {

// The largest tile's rows, the widest row and the wide chunk's columns;
// ops/fused_mlp.py holds the same numbers and checks them after the build.
int ivt_mlp_mma_rows() { return MC_ROWS; }
int ivt_mlp_mma_max_width() { return MC_MAX_WIDTH; }

// The chunk of rows of width d (128, 96, or 0: the route does not take d).
int ivt_mlp_mma_chunk(int d) { return mc_chunk_of(d); }

// The cluster size at rows of width d and md hidden columns (0: the route
// does not take them).
int ivt_mlp_mma_cluster(int d, int md) { return mc_cluster_of(d, md); }

// Dynamic shared memory a block of the largest tile takes for rows of width
// d and md hidden columns (0 where the route does not take them).
size_t ivt_mlp_mma_smem_bytes(int d, int md) {
  const int nc = mma_chunk(d, md);
  return nc == 0 ? 0 : mma_kernel(nc, MC_ROWS, d, md).smem;
}

// Lets the four instantiations take the shared memory they need on the
// current device: once a device, before its first launch or max_clusters.
// Returns a cudaError_t value.
int ivt_mlp_mma_prepare() {
  cudaError_t err = mc_prepare(mlp_mma_kernel<32>);
  if (err == cudaSuccess) err = mc_prepare(mlp_mma_kernel<64>);
  if (err == cudaSuccess) err = mc_prepare(mlp_mma96_kernel<32>);
  return (int)(err != cudaSuccess ? err : mc_prepare(mlp_mma96_kernel<64>));
}

// Clusters the card holds at once at (d, md) with tiles of bm (32 or 64)
// rows, or -1.
int ivt_mlp_mma_max_clusters(int d, int md, int bm) {
  const int nc = mma_chunk(d, md);
  if (nc == 0 || (bm != 32 && bm != 64)) return -1;
  const MmaKernel k = mma_kernel(nc, bm, d, md);
  return mc_max_clusters(k.fn, mc_cluster_of(d, md), k.smem);
}

// bf16 x, y [M, D] contiguous rows; ln_s, ln_b, b2 [D]; w1 [D, MD]; b1
// [MD]; w2 [MD, D]; x, y, ln_s, ln_b and the weights 16-byte aligned; tiles
// of bm (32 or 64) rows a cluster. Returns a cudaError_t value.
int ivt_fused_mlp_block_mma(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y, int M, int D,
                            int MD, int bm, float eps, void* stream) {
  const int nc = mma_chunk(D, MD);
  if (M <= 0 || nc == 0 || (bm != 32 && bm != 64)) return (int)cudaErrorInvalidValue;
  if (mma_kernel(nc, MC_ROWS, D, MD).smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const MlpMmaArgs a{static_cast<const bf16*>(x),  static_cast<const bf16*>(ln_s),
                     static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w1),
                     static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                     static_cast<const bf16*>(b2), static_cast<bf16*>(y),
                     M,
                     D,
                     MD,
                     eps};
  const MmaKernel k = mma_kernel(nc, bm, D, MD);
  return (int)mc_launch(k.fn, a, mc_cluster_of(D, MD), M, bm, k.smem, (cudaStream_t)stream);
}

}  // extern "C"
