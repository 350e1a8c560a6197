// Fused MLP branch in f32 on Hopper's tensor cores (sm_90a):
//     y = x + fc2(gelu_tanh(fc1(LN2(x)))),
// both products on mma.sync m16n8k8 TF32 with the 3xTF32 split of
// tf32_attention.cuh (three TF32 products a product), the hidden
// activations never written to device memory, and the hidden dimension
// split over the blocks of a thread-block cluster (mlp_cluster.cuh).
//
// Replaces, for f32 operands it takes (rows a multiple of 128 or of 96
// wide, a hidden dimension of whole chunks of that width, 16-byte aligned,
// the block of its smallest tile inside the card's shared memory), the Pallas TPU
// kernel interactive_vit_tpu/ops/fused_mlp.py::fused_mlp_block (_kernel);
// other f32 operands keep fused_mlp_block.cu (f32 FMA). The cast points are
// that kernel's in f32: LayerNorm with f32 statistics, scaled and shifted in
// f32; h = gelu_tanh(ln @ fc1_w + fc1_b) in f32 (the tanh form, as in every
// dtype of that kernel); y = (x + h @ fc2_w) + fc2_b in f32.
//
// The products. Plain TF32 keeps 10 mantissa bits and would miss the f32
// contract (1e-4), so each operand is split, hi = cvt.rna.tf32.f32(v), lo =
// cvt.rna.tf32.f32(v - hi), and a b ~= a_hi b_hi + (a_lo b_hi + a_hi b_lo).
// The tensor cores' f32 accumulation truncates, so the hi products and the
// correction terms sum in two accumulators over one weight stage (32 k)
// only, and fold into the running sums with round-to-nearest adds, as row
// 1's QKV (row1_qkv_tf32_kernel, attn_block_tf32.cuh) does. The depth index
// is permuted (k = t <-> 2t, t + 4 <-> 2t + 1), so a thread's A values are
// neighbours in a row (one 8-byte load) and its B values two rows of one
// column.
//
// What bounds it on this card: at vit_b16 (197 x 768, hidden 3072, B = 1)
// the work is 1.86 GFLOP, 5.6 GFLOP of TF32 products: 11.3 us at the TF32
// peak (495 TFLOP/s), against 6.0 us for its 20.1 MB of f32 bytes at 3.35
// TB/s; 27.7 us at the f32 FMA peak (67 TFLOP/s), the bound of the FMA
// kernel it replaces (~0.76 ms).
//
// Design (fused_mlp_block_mma.cu's, in f32): a cluster of S = 4 or 8
// blocks takes a tile of BM rows, block `rank` the hidden slice [rank md /
// S, (rank + 1) md / S). BM is the caller's choice (ops/fused_mlp.py's
// row_tile): the smallest of 16 (chunks of 128 only: the eight warps across
// the chunk, 16 columns each), 32 and 64 whose tiles fit the clusters the
// card holds at once, else the largest whose block fits. Each block: LN2 of its BM / S rows (x staged
// by cp.async), the others' copied from its peers (DSMEM), into shared
// memory (f32); fc1 + bias + GELU for its slice, NC columns at a time (128,
// or 96 for rows a multiple of 96 but not of 128: swin_t's stages 0 and 1),
// the fc1 tiles (32 x NC f32) streaming through a three-stage cp.async
// ring, h (f32) kept in shared memory; then its fc2 partials over its slice,
// NC output columns at a time, summed over the cluster in rank order
// through DSMEM a chunk later by the block that owns each NC / S columns,
// which writes y for them. Two calls give the same bits.
//
// Where the time goes: with two warps a scheduler at one image, the
// kernel runs at the rate its warps issue instructions, and the split
// costs more of them than the products (a warp of 16 x 32 splits 4 A and 8
// B values, 36 instructions, for 12 products a k8 step). So tiles of 16
// rows put the eight warps across the chunk (each B value split once, by
// one warp) and keep the A operands pre-split: LN2's rows and h are written
// once as hi and lo panels (tf_pair), where each of the warps across a chunk
// would split every value again. A deeper ring did not help (4 or 8 stages
// against 3: within 2%, tools/kernel_variants.py).
//
// Shared memory (dynamic): LN2's rows [BM][d + 8] f32 (at 16 rows two
// panels, hi and lo), whose space the fc2 partial buffers take over; h
// [BM][slice + 8] f32 (at 16 rows hi and lo); the ring of three 32 x (NC +
// 4) f32 tiles. At vit_b16 with tiles of 16: 200,192 bytes, with 32 the
// same, one block an SM (tiles of 64 do not fit). At vit_h14 (1280, hidden
// 5120) even 16 rows take 298,496 bytes: the route refuses it, and it
// keeps the FMA kernel. Row strides of d + 8 and slice + 8 floats (8 mod
// 32) keep the 8-byte A loads free of bank conflicts, NC + 4 (2 (NC + 4) =
// 8 mod 32) the B loads.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "mlp_cluster.cuh"
#include "tf32_attention.cuh"

namespace {

struct MlpTf32Args {
  const float* x;
  const float* ln_s;
  const float* ln_b;
  const float* w1;  // [D, MD]
  const float* b1;  // [MD]
  const float* w2;  // [MD, D]
  const float* b2;  // [D]
  float* y;
  int M, D, MD;
  float eps;
};

constexpr int TF_KR = 32;  // k rows of a weight stage

// A weight stage at chunks of NC: rows of NC + 4 floats.
template <int NC>
struct TfStage {
  static constexpr int LD = NC + 4;
  static constexpr int BYTES = TF_KR * NC * 4;  // the weight bytes a stage holds
  static_assert((2 * LD) % 32 == 8 || (2 * LD) % 32 == 24, "B loads conflict-free");
};

// Tiles of 16 rows keep the A operands (LN2's rows, h) split: hi and lo
// panels, written once, where every warp would split each value again.
__host__ __device__ constexpr bool tf_presplit(int bm) { return bm == 16; }

// The shapes of a tile of BM rows at chunks of NC: tiles of 16 rows (chunks
// of 128 only) put the 8 warps across the chunk, 16 columns each, on
// pre-split A panels; tiles of 32 and 64 two warps down and four across, as
// fused_mlp_block_mma.cu, splitting A as they read it.
template <int BM, int NC>
struct TfTile {
  static_assert(BM == 16 ? NC == MC_NC : (BM == 32 || BM == 64), "tiles of 16, 32 or 64 rows");
  static constexpr int WARP_ROWS = BM == 16 ? 1 : 2;  // warps down the tile
  static constexpr int WARP_COLS = MC_WARPS / WARP_ROWS;
  static constexpr int MT = BM / WARP_ROWS / 16;  // a warp's 16-row tiles
  static constexpr int WN = NC / WARP_COLS;       // a warp's columns of a chunk
  static constexpr int NT = WN / 8;               // and their 8-column tiles
  static constexpr bool PRE = tf_presplit(BM);
  // a thread's 4-column groups of a chunk's sums, at most
  static constexpr int ITEMS = (BM * NC / 4 / MC_MIN_CLUSTER + MC_THREADS - 1) / MC_THREADS;
};

// The byte layout of a block's dynamic shared memory: LN2's rows (their hi
// panel, then the lo one where A is pre-split), whose space the fc2 partial
// buffers take over; h (hi, then lo); the ring.
struct TfLayout {
  size_t ln, ln_lo, h, h_lo, ring, total;
  int lda, ldh;  // row strides, floats
};

template <int NC>
__host__ __device__ inline TfLayout tf_layout(int d, int md, int bm) {
  TfLayout L;
  const int slice = md / mc_cluster_size<NC>(md);
  const int panels = tf_presplit(bm) ? 2 : 1;
  L.lda = d + 8;  // d and slice multiples of 32: 8 (mod 32)
  L.ldh = slice + 8;
  L.ln = 0;
  L.ln_lo = (size_t)bm * L.lda * 4;
  const size_t ln = panels * L.ln_lo, pbuf = 2 * (size_t)bm * McChunk<NC>::PLD * 4;
  L.h = ln > pbuf ? ln : pbuf;
  L.h_lo = L.h + (size_t)bm * L.ldh * 4;
  L.ring = L.h + panels * (size_t)bm * L.ldh * 4;
  L.total = L.ring + (size_t)MC_STAGES * TF_KR * TfStage<NC>::LD * 4;
  return L;
}

// v split into a TF32 pair stored as f32 bit patterns
__device__ __forceinline__ float2 tf_pair(float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// c += a b, tf32 operands, f32 accumulators (not volatile, unlike
// tf32_attention.cuh's mma_tf32: a register-only operation the compiler may
// schedule between the shared-memory loads)
__device__ __forceinline__ void tf_mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's stage of TF_KR k for its MT 16-row tiles (A rows a_row0.. of a
// [*][lda] f32 tile, k0 the stage's first k; PRE: a_tile holds A's hi
// parts and a_lo its lo parts, else a_tile holds A and a_lo is unused) and
// its NT 8-column tiles (B a weight stage at b, rows of LD floats, its
// columns from col0): acc += A B, the hi products and the correction terms
// summed apart over the stage and folded in with round to nearest. Each B
// value is split once for the MT row tiles.
template <int MT, int NT, int LD, bool PRE>
__device__ __forceinline__ void tf_stage(float acc[MT][NT][4], const float* a_tile,
                                         const float* a_lo, int lda, int a_row0, int k0,
                                         const float* b, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float big[MT][NT][4], small[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      zero4(big[mt][j]);
      zero4(small[mt][j]);
    }
#pragma unroll
  for (int kc = 0; kc < TF_KR / 8; ++kc) {
    // A: rows g, g + 8 of each 16, columns 8 kc + 2t, + 1 (k = t, t + 4)
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int off = (a_row0 + 16 * mt + g) * lda + k0 + 8 * kc + 2 * t;
      const float2 top = *reinterpret_cast<const float2*>(a_tile + off);
      const float2 bot = *reinterpret_cast<const float2*>(a_tile + off + 8 * lda);
      if constexpr (PRE) {
        const float2 ltop = *reinterpret_cast<const float2*>(a_lo + off);
        const float2 lbot = *reinterpret_cast<const float2*>(a_lo + off + 8 * lda);
        ah[mt][0] = __float_as_uint(top.x);
        ah[mt][1] = __float_as_uint(bot.x);
        ah[mt][2] = __float_as_uint(top.y);
        ah[mt][3] = __float_as_uint(bot.y);
        al[mt][0] = __float_as_uint(ltop.x);
        al[mt][1] = __float_as_uint(lbot.x);
        al[mt][2] = __float_as_uint(ltop.y);
        al[mt][3] = __float_as_uint(lbot.y);
      } else {
        split(top.x, ah[mt][0], al[mt][0]);
        split(bot.x, ah[mt][1], al[mt][1]);
        split(top.y, ah[mt][2], al[mt][2]);
        split(bot.y, ah[mt][3], al[mt][3]);
      }
    }
    // B: weight rows 8 kc + 2t, + 1 at column g of each 8
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* wr = b + (8 * kc + 2 * t) * LD + col0 + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split(wr[0], bh0, bl0);
      split(wr[LD], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        tf_mma(small[mt][j], al[mt], bh0, bh1);
        tf_mma(small[mt][j], ah[mt], bl0, bl1);
        tf_mma(big[mt][j], ah[mt], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][j][e] = __fadd_rn(acc[mt][j][e], fold_rn(big[mt][j][e], small[mt][j][e]));
}

template <int BM, int NC>
__global__ void __launch_bounds__(MC_THREADS) mlp_tf32_kernel(const MlpTf32Args a) {
  using T = TfTile<BM, NC>;
  constexpr int MT = T::MT, NT = T::NT, WN = T::WN, ITEMS = T::ITEMS;
  constexpr bool PRE = T::PRE;
  constexpr int PLD = McChunk<NC>::PLD, LD = TfStage<NC>::LD;
  constexpr int STAGE = TF_KR * LD;  // floats
  extern __shared__ float4 mlpt_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(mlpt_smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)gridDim.x, rank = (int)cluster.block_rank();  // grid x = cluster x
  const int D = a.D, MD = a.MD, slice = MD / S, hid0 = rank * slice;
  const TfLayout L = tf_layout<NC>(D, MD, BM);
  float* lns = reinterpret_cast<float*>(smem + L.ln);  // LN2's rows (PRE: their hi parts)
  float* lnl = reinterpret_cast<float*>(smem + L.ln_lo);  // PRE: their lo parts
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem + L.ln);  // after fc1
  float* hs = reinterpret_cast<float*>(smem + L.h);
  float* hl = reinterpret_cast<float*>(smem + L.h_lo);
  float* ring = reinterpret_cast<float*>(smem + L.ring);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = (warp / T::WARP_COLS) * (BM / T::WARP_ROWS), wn = warp % T::WARP_COLS;
  const int row0 = blockIdx.y * BM;

  const int ks1 = D / TF_KR, total1 = (slice / NC) * ks1;
  auto load1 = [&](int it, int slot) {
    const int c = it / ks1, kt = it % ks1;
    mc_load_stage<TfStage<NC>::BYTES>(
        reinterpret_cast<unsigned char*>(ring + slot * STAGE),
        reinterpret_cast<const unsigned char*>(a.w1 + (size_t)kt * TF_KR * MD + hid0 + c * NC),
        (size_t)MD * 4, TF_KR, LD * 4);
  };

  // LN2 in place, once a cluster: each block stages its BM / S rows of x by
  // cp.async (fc1's first weight stages behind them), normalizes them (one
  // warp a row; PRE: into the hi and lo panels) and gathers the others from
  // its peers
  const int rpr = BM / S;
  mc_stage_rows<float>(reinterpret_cast<unsigned char*>(lns + rank * rpr * L.lda), L.lda * 4, a.x,
                       row0 + rank * rpr, rpr, a.M, D);
  cp_async_commit();
  mc_prologue(total1, load1);
  cp_async_wait<MC_STAGES - 1>();
  __syncthreads();
  for (int r = rank * rpr + warp; r < (rank + 1) * rpr; r += MC_WARPS) {
    float* lr = lns + r * L.lda;
    float v[MC_UNITS][16];
    const int mine = mc_ln_row<float>(v, lr, a.ln_s, a.ln_b, D, a.eps, lane);
#pragma unroll
    for (int u = 0; u < MC_UNITS; ++u) {
      if (u >= mine) break;
      const int k0 = 16 * (lane + 32 * u);
      float4* dst = reinterpret_cast<float4*>(lr + k0);
      float4* dlo = reinterpret_cast<float4*>(lnl + r * L.lda + k0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (PRE) {
          const float2 p0 = tf_pair(v[u][4 * q]), p1 = tf_pair(v[u][4 * q + 1]);
          const float2 p2 = tf_pair(v[u][4 * q + 2]), p3 = tf_pair(v[u][4 * q + 3]);
          dst[q] = make_float4(p0.x, p1.x, p2.x, p3.x);
          dlo[q] = make_float4(p0.y, p1.y, p2.y, p3.y);
        } else {
          dst[q] = make_float4(v[u][4 * q], v[u][4 * q + 1], v[u][4 * q + 2], v[u][4 * q + 3]);
        }
      }
    }
  }
  cluster.sync();  // every block's rows written
  mc_gather_rows(cluster, reinterpret_cast<unsigned char*>(lns), L.lda * 4, D * 4, rpr, S, rank);
  if constexpr (PRE)
    mc_gather_rows(cluster, reinterpret_cast<unsigned char*>(lnl), L.lda * 4, D * 4, rpr, S, rank);
  mc_cluster_arrive();  // this block's gather done; waited for before the
                        // first fc2 partials reuse the space
  // (the ring's first __syncthreads orders these writes before fc1)

  float acc[MT][NT][4], b1p[2 * NT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) zero4(acc[mt][j]);

  // fc1 + bias + GELU over the slice, NC hidden columns a chunk; each
  // chunk's b1 fetched into registers at its first stage
  mc_loop(total1, load1, [&](int it, int slot) {
    const int c = it / ks1, kt = it % ks1;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int hj = hid0 + c * NC + wn * WN + 8 * j + 2 * t;
        b1p[2 * j] = a.b1[hj];
        b1p[2 * j + 1] = a.b1[hj + 1];
      }
    }
    tf_stage<MT, NT, LD, PRE>(acc, lns, lnl, L.lda, wr0, kt * TF_KR, ring + slot * STAGE, wn * WN,
                              lane);
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
          const float h0 = gelu_tanh(__fadd_rn(acc[mt][j][2 * half], b1p[2 * j]));
          const float h1 = gelu_tanh(__fadd_rn(acc[mt][j][2 * half + 1], b1p[2 * j + 1]));
          if constexpr (PRE) {
            const float2 p0 = tf_pair(h0), p1 = tf_pair(h1);
            *reinterpret_cast<float2*>(hs + r * L.ldh + col) = make_float2(p0.x, p1.x);
            *reinterpret_cast<float2*>(hl + r * L.ldh + col) = make_float2(p0.y, p1.y);
          } else {
            *reinterpret_cast<float2*>(hs + r * L.ldh + col) = make_float2(h0, h1);
          }
          acc[mt][j][2 * half] = acc[mt][j][2 * half + 1] = 0.f;
        }
      }
  });

  // fc2 partials over the slice, NC output columns a chunk, summed over the
  // cluster in rank order; y for the owned columns
  const int ks2 = slice / TF_KR, total2 = (D / NC) * ks2;
  auto load2 = [&](int it, int slot) {
    const int oc = it / ks2, kt = it % ks2;
    mc_load_stage<TfStage<NC>::BYTES>(
        reinterpret_cast<unsigned char*>(ring + slot * STAGE),
        reinterpret_cast<const unsigned char*>(a.w2 + (size_t)(hid0 + kt * TF_KR) * D + oc * NC),
        (size_t)D * 4, TF_KR, LD * 4);
  };
  // y for the owned columns of chunk c from the partials of pbuf[c & 1],
  // x and b2 fetched into registers beforehand (xp, b2p)
  float4 xp[ITEMS], b2p[ITEMS];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      int r, cc;
      if (!mc_item<BM, NC>(S, rank, u, r, cc)) break;
      const int row = min(row0 + r, a.M - 1);
      const float* b2 = a.b2 + c * NC + cc;  // (b2 may sit off the 16-byte grid)
      xp[u] = *reinterpret_cast<const float4*>(a.x + (size_t)row * D + c * NC + cc);
      b2p[u] = make_float4(b2[0], b2[1], b2[2], b2[3]);
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
      *reinterpret_cast<float4*>(a.y + (size_t)row * D + c * NC + cc) =
          make_float4(__fadd_rn(__fadd_rn(xp[u].x, v.x), b2p[u].x),
                      __fadd_rn(__fadd_rn(xp[u].y, v.y), b2p[u].y),
                      __fadd_rn(__fadd_rn(xp[u].z, v.z), b2p[u].z),
                      __fadd_rn(__fadd_rn(xp[u].w, v.w), b2p[u].w));
    }
  };
  // chunk oc: its products; then the previous chunk's sums (its barrier
  // arrived a chunk ago), then its own partials, then this chunk's arrival
  mc_prologue(total2, load2);
  mc_loop(total2, load2, [&](int it, int slot) {
    const int oc = it / ks2, kt = it % ks2;
    if (kt == 0 && oc > 0) fetch(oc - 1);
    tf_stage<MT, NT, LD, PRE>(acc, hs, hl, L.ldh, wr0, kt * TF_KR, ring + slot * STAGE, wn * WN,
                              lane);
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

// The instantiation for chunks of nc and tiles of bm rows (32 or 64), and
// its block's shared memory at (d, md).
struct Tf32Kernel {
  void (*fn)(const MlpTf32Args);
  size_t smem;
};

inline Tf32Kernel tf32_kernel(int nc, int bm, int d, int md) {
  if (nc == MC_NC)
    return {bm == 16   ? mlp_tf32_kernel<16, MC_NC>
            : bm == 32 ? mlp_tf32_kernel<32, MC_NC>
                       : mlp_tf32_kernel<64, MC_NC>,
            tf_layout<MC_NC>(d, md, bm).total};
  return {bm == 32 ? mlp_tf32_kernel<32, MC_NC_NARROW> : mlp_tf32_kernel<64, MC_NC_NARROW>,
          tf_layout<MC_NC_NARROW>(d, md, bm).total};
}

// The chunk of rows of d and md hidden columns with tiles of bm rows, or 0
// where the kernel has no such tile (16 rows take chunks of 128 only).
inline int tf32_tile_chunk(int d, int md, int bm) {
  const int nc = mc_cluster_of(d, md) == 0 ? 0 : mc_chunk_of(d);
  if (nc == 0 || (bm != 16 && bm != 32 && bm != 64) || (bm == 16 && nc != MC_NC)) return 0;
  return nc;
}

// The same where that block also fits the card's shared memory.
inline int tf32_chunk(int d, int md, int bm) {
  const int nc = tf32_tile_chunk(d, md, bm);
  return nc != 0 && tf32_kernel(nc, bm, d, md).smem <= SMEM_LIMIT ? nc : 0;
}

}  // namespace

extern "C" {

// The largest tile's rows, the widest row and the wide chunk's columns;
// ops/fused_mlp.py holds the same numbers and checks them after the build.
int ivt_mlp_tf32_rows() { return MC_ROWS; }
int ivt_mlp_tf32_max_width() { return MC_MAX_WIDTH; }

// The chunk of rows of width d (128, 96, or 0: the route does not take d).
int ivt_mlp_tf32_chunk(int d) { return mc_chunk_of(d); }

// The cluster size at rows of width d and md hidden columns (0: the route
// does not take them).
int ivt_mlp_tf32_cluster(int d, int md) { return mc_cluster_of(d, md); }

// Dynamic shared memory a block with tiles of bm (16, 32 or 64) rows takes
// for rows of width d and md hidden columns (0 where the kernel has no such
// tile for the shape; a block over the card's shared memory is counted all
// the same: the route takes the shape where its smallest tile's block
// fits).
size_t ivt_mlp_tf32_smem_bytes(int d, int md, int bm) {
  const int nc = tf32_tile_chunk(d, md, bm);
  return nc == 0 ? 0 : tf32_kernel(nc, bm, d, md).smem;
}

// Lets the five instantiations take the shared memory they need on the
// current device: once a device, before its first launch or max_clusters.
// Returns a cudaError_t value.
int ivt_mlp_tf32_prepare() {
  cudaError_t err = mc_prepare(mlp_tf32_kernel<16, MC_NC>);
  if (err == cudaSuccess) err = mc_prepare(mlp_tf32_kernel<32, MC_NC>);
  if (err == cudaSuccess) err = mc_prepare(mlp_tf32_kernel<64, MC_NC>);
  if (err == cudaSuccess) err = mc_prepare(mlp_tf32_kernel<32, MC_NC_NARROW>);
  return (int)(err != cudaSuccess ? err : mc_prepare(mlp_tf32_kernel<64, MC_NC_NARROW>));
}

// Clusters the card holds at once at (d, md) with tiles of bm (16, 32 or
// 64) rows, or -1 (also where that block does not fit).
int ivt_mlp_tf32_max_clusters(int d, int md, int bm) {
  const int nc = tf32_chunk(d, md, bm);
  if (nc == 0) return -1;
  const Tf32Kernel k = tf32_kernel(nc, bm, d, md);
  return mc_max_clusters(k.fn, mc_cluster_of(d, md), k.smem);
}

// f32 x, y [M, D] contiguous rows; ln_s, ln_b, b2 [D]; w1 [D, MD]; b1
// [MD]; w2 [MD, D]; x, y, ln_s, ln_b and the weights 16-byte aligned; tiles
// of bm (16 at chunks of 128, 32 or 64) rows a cluster, whose block fits.
// Returns a cudaError_t value.
int ivt_fused_mlp_block_tf32x3(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* y, int M,
                               int D, int MD, int bm, float eps, void* stream) {
  const int nc = tf32_chunk(D, MD, bm);
  if (M <= 0 || nc == 0) return (int)cudaErrorInvalidValue;
  const MlpTf32Args a{static_cast<const float*>(x),  static_cast<const float*>(ln_s),
                      static_cast<const float*>(ln_b), static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), static_cast<float*>(y),
                      M,
                      D,
                      MD,
                      eps};
  const Tf32Kernel k = tf32_kernel(nc, bm, D, MD);
  return (int)mc_launch(k.fn, a, mc_cluster_of(D, MD), M, bm, k.smem, (cudaStream_t)stream);
}

}  // extern "C"
