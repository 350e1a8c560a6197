// Fused W8A8 MLP branch on Hopper's int8 tensor cores (sm_90a):
//     y = x + MLP_w8a8(LN2(x)),
// both products s8 x s8 -> s32 with mma.sync m16n8k32 (exact), the
// activations quantized per row inside the kernel, the hidden activations
// never written to device memory, and the hidden dimension split over the
// blocks of a thread-block cluster.
//
// Replaces, for operands it takes (activations bf16 or f32, rows a multiple
// of 128 or of 96 wide and at most 1280, a hidden dimension of whole
// chunks, 16-byte aligned), the Pallas TPU kernel
// interactive_vit_tpu/ops/fused_mlp.py::fused_mlp_w8a8_block
// (_w8a8_kernel); other operands keep fused_mlp_w8a8_block.cu (__dp4a).
// The cast points are that kernel's, in order, as fused_mlp_w8a8_block.cu
// lists them:
//   1. LayerNorm with f32 statistics, scaled and shifted in f32, cast to T
//      and back;
//   2. per-row quantization (quant_rows_mosaic: scale max|ln| / 127, round
//      half up, a true f32 division);
//   3. acc1 = q1 @ fc1_q, s8 x s8 -> s32;
//   4. h = acc1.f32 * (sx1 * s1) + b1;
//   5. h cast to T, tanh GELU, cast to T;
//   6. per-row requantization of h over all mlp_dim columns;
//   7. acc2 = q2 @ fc2_q, s8 x s8 -> s32;
//   8. y = x.f32 + acc2.f32 * (sx2 * s2) + b2, cast to T;
// each f32 step an explicitly rounded multiply or add (__fmul_rn,
// __fadd_rn) where the plain version has no fma.
//
// What bounds it on this card: at vit_b16 (197 x 768, hidden 3072, B = 1)
// the work is 1.86 G int8 operations over 4.7 MB of int8 weights: bound by
// bytes, 1.4 us at 3.35 TB/s (0.9 us of operations at the int8 peak).
// fused_mlp_w8a8_block.cu issues __dp4a in 25 blocks of 8 rows, each
// walking every weight byte from L2, and takes ~0.9 ms.
//
// Design. A cluster of S blocks (mlp_cluster.cuh; S = 8 at vit_b16) takes
// a tile of BM rows (32 for one image, 7 tiles; 64 from about three images
// on: the caller's choice, ops/fused_mlp.py's row_tile), and block `rank`
// the hidden slice [rank md / S, (rank + 1) md / S)
// (384 columns at vit_b16), so each block reads 1/S of each weight matrix
// (590 KB at vit_b16). Each block:
//   a. stages its BM / S rows of x, computes their LN2 and q1 (steps 1-2)
//      and writes their q1 tap, then copies the other rows' q1 and sx1
//      from its peers (DSMEM), fc1's first weight stages in flight meanwhile;
//   b. computes acc1 -> h -> GELU for its slice, 128 columns at a time, the
//      fc1 tiles streaming through the cp.async ring, keeps h (in T) in
//      shared memory and each row's local max |h|;
//   c. exchanges the rows' maxes over DSMEM after a cluster barrier, so
//      every block derives the same sx2 from the max over all md columns
//      (step 6), and quantizes its slice into q2;
//   d. computes its fc2 partials in s32 over its slice, 128 output columns
//      at a time, and sums, in rank order, the S partials of the 128 / S
//      columns of each chunk it owns, read over DSMEM a chunk later (an
//      integer sum: the same in any order);
//   e. writes y for those columns (step 8).
// int8 B operands are transposed in shared memory by prmt (mlp_cluster.cuh);
// the weights are never repacked in device memory.
//
// Chunks of 96 (mlp_cluster.cuh's narrow chunk: swin_t / swin_s stages 0
// and 1, d = 96 and 192, hidden 384 and 768, clusters of 4 and 8 whose
// slice is one chunk, so fc1's k is 3 or 6 steps of 32 and fc2's 3): the
// same code at NC = 96 (w8a8_mma96_kernel). The prmt transpose gives a
// warp 32 columns (a thread's four consecutive columns feed four n8
// tiles), so three of the four column warps take a chunk and the fourth
// has no products; it still copies, quantizes and sums with the others.
// Weight stages of 96 k rows of 96 bytes (24 words: a warp's four k rows t
// land on banks 24 t apart, all 32 distinct). w8a8_mma_kernel, at 128, is
// the code it was.
//
// Shared memory (dynamic): the row scales and maxes; q1 [BM][d + 16] int8,
// whose space the fc2 partial buffers take over; h [BM][slice + pad] in T
// (before it, the block's rows of x); q2 [BM][slice + 16]; the ring of
// three weight tiles of 160-byte rows, 128 rows with bf16 activations, 64
// with f32 (whose h takes the room). At vit_b16 with tiles of 64 206,592
// bytes in bf16, 225,024 in f32: one block an SM, 15 clusters at once.
//
// Where the time goes (block (0, 0) of vit_b16, B = 1, bf16, tiles of 32;
// kernel_variants' row7_time_phases, NVIDIA H100 80GB HBM3, 700 W): LN2 +
// q1 5.5 us, fc1 16.6, the max exchange and q2 4.2, fc2 and the cluster
// sums 25.3; the ring's per-stage cost is the copies' issue (cp.async,
// every warp) plus the products, which do not overlap.
//
// Variants (tools/kernel_variants.py, device time at vit_b16, B = 1 / 8,
// bf16, NVIDIA H100 80GB HBM3, 700 W; ptxas: 127-128 registers with tiles
// of 32, 162-163 with 64, no spill): the source (the tile by M) 0.0554 /
// 0.1434 ms; tiles of 32 always 0.0554 / 0.2154; tiles of 64 always
// 0.0718 / 0.1431; 8 KB stages 0.0650 / 0.1692. f32: 0.0636 / 0.1644.
// The __dp4a kernel: 0.8822 / 0.9487.
// Rejected on the way: a cluster of 4 (a 768-column slice: over the 227 KB
// at 16 KB stages; at 8 KB stages and tiles of 64, 1.6x slower at B = 1);
// LN2 in every block of the cluster (+18 us); one full cluster barrier per
// fc2 chunk (+6 us); a ninth warp issuing all the copies (+8 us: one warp
// cannot issue cp.async as fast as eight).
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "mlp_cluster.cuh"

namespace {

struct W8a8MmaArgs {
  const void* x;
  const void* ln_s;
  const void* ln_b;
  const int8_t* w1;  // [D, MD]
  const float* s1;   // [MD]
  const void* b1;    // [MD]
  const int8_t* w2;  // [MD, D]
  const float* s2;   // [D]
  const void* b2;    // [D]
  void* y;
  // optional taps of the integer stages, row-major [M, D] / [M, MD]
  int8_t* q1_out;
  int* acc1_out;
  int8_t* q2_out;
  int* acc2_out;
  int M, D, MD;
  float eps;
};

// The byte layout of a block's dynamic shared memory.
struct W8Layout {
  size_t scales, q1, h, q2, ring, total;
  int ldq1, ldh, ldq2;  // row strides: bytes, elements of T, bytes
};

// The shapes of an int8 weight stage at chunks of NC: its k rows for
// activations of esize bytes (at 128: 16 KB stages, 8 KB with f32
// activations; at 96: 96 rows, which divide d and every slice), its rows'
// stride in bytes, and the column warps with products (a warp takes 32
// columns of a chunk).
template <int NC>
struct W8Stage {
  static constexpr int LD = NC == MC_NC ? MC_W8_LD : NC;
  static constexpr int CW = NC / 32;
  static_assert((LD / 4) % 8 == 0 && (LD / 4 / 8) % 2 == 1, "k rows t on banks 8 apart");
};

template <int NC = MC_NC>
__host__ __device__ constexpr int w8_stage_rows(int esize) {
  return NC == MC_NC ? (esize == 2 ? MC_STAGE_BYTES : MC_STAGE_BYTES_F32) / MC_NC : NC;
}

template <int NC = MC_NC>
__host__ __device__ inline W8Layout w8_layout(int d, int md, int esize, int bm) {
  W8Layout L;
  const int slice = md / mc_cluster_size<NC>(md);
  L.ldq1 = d + 16;                  // d / 16 even: an odd number of 16-byte units
  L.ldh = slice + 16 / esize;       // one 16-byte unit of padding
  L.ldq2 = slice + 16;
  L.scales = 0;                     // sx1, sx2, the local max, its warp parts [4]
  L.q1 = 7 * bm * sizeof(float);
  const size_t q1 = (size_t)bm * L.ldq1, pbuf = 2 * (size_t)bm * McChunk<NC>::PLD * 4;
  L.h = L.q1 + (q1 > pbuf ? q1 : pbuf);
  // h, or before it the block's rows of x for LN2 (at most half the tile)
  const size_t hb = (size_t)bm * L.ldh * esize, xb = (size_t)(bm / 2) * d * esize;
  L.q2 = L.h + (hb > xb ? hb : xb);
  L.ring = L.q2 + (size_t)bm * L.ldq2;
  L.total = L.ring + (size_t)MC_STAGES * w8_stage_rows<NC>(esize) * W8Stage<NC>::LD;
  return L;
}

// The kernel at activations of T, tiles of BM rows and chunks of NC columns.
template <typename T, int BM, int NC>
__device__ __forceinline__ void w8a8_mma_body(const W8a8MmaArgs& a) {
  constexpr int MT = McTile<BM, NC>::MT, ITEMS = McTile<BM, NC>::ITEMS;
  constexpr int LD = W8Stage<NC>::LD, CW = W8Stage<NC>::CW, PLD = McChunk<NC>::PLD;
  extern __shared__ int4 w8m_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(w8m_smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)gridDim.x, rank = (int)cluster.block_rank();  // grid x = cluster x
  const int D = a.D, MD = a.MD, slice = MD / S, hid0 = rank * slice;
  const W8Layout L = w8_layout<NC>(D, MD, sizeof(T), BM);
  float* sx1 = reinterpret_cast<float*>(smem + L.scales);
  float* sx2 = sx1 + BM;
  float* rmax = sx2 + BM;      // this block's max |h| of each row
  float* rpart = rmax + BM;    // [4][BM]: each column warp's
  int8_t* q1s = reinterpret_cast<int8_t*>(smem + L.q1);
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem + L.q1);  // after fc1
  T* hs = reinterpret_cast<T*>(smem + L.h);
  T* xs = hs;                                                 // before fc1
  int8_t* q2s = reinterpret_cast<int8_t*>(smem + L.q2);
  unsigned char* ring = smem + L.ring;
  constexpr int W8_ROWS = w8_stage_rows<NC>(sizeof(T)), SB = W8_ROWS * NC;
  constexpr int STAGE = W8_ROWS * LD;

  const T* x = static_cast<const T*>(a.x);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* b2 = static_cast<const T*>(a.b2);
  T* y = static_cast<T*>(a.y);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = (warp >> 2) * (BM / 2), wn = warp & 3;
  const int row0 = blockIdx.y * BM;
  // the warp takes a chunk's columns wn * 32 ..: every warp at 128, three
  // of the four at 96
  const bool cols = CW == 4 || wn < CW;

  const int ks1 = D / W8_ROWS, total1 = (slice / NC) * ks1;
  auto load1 = [&](int it, int slot) {
    const int c = it / ks1, kt = it % ks1;
    mc_load_stage<SB>(ring + slot * STAGE,
                  reinterpret_cast<const unsigned char*>(a.w1) + (size_t)kt * W8_ROWS * MD +
                      hid0 + c * NC,
                  (size_t)MD, W8_ROWS, LD);
  };

  // a. LN2 + q1 (steps 1-2), once a cluster: each block stages its
  // BM / S rows of x by cp.async (fc1's first weight stages behind
  // them), normalizes and quantizes them (one warp a row; its q1 tap rows),
  // and gathers the other rows' q1 and sx1 from its peers
  const int rpr = BM / S;
  mc_stage_rows<T>(reinterpret_cast<unsigned char*>(xs), D * (int)sizeof(T), x, row0 + rank * rpr,
                   rpr, a.M, D);
  cp_async_commit();
  mc_prologue(total1, load1);
  cp_async_wait<MC_STAGES - 1>();
  __syncthreads();
  for (int i = warp; i < rpr; i += MC_WARPS) {
    const int r = rank * rpr + i, row = row0 + r;
    float v[MC_UNITS][16];
    const int mine = mc_ln_row<T>(v, xs + (size_t)i * D, static_cast<const T*>(a.ln_s),
                                  static_cast<const T*>(a.ln_b), D, a.eps, lane);
    float mx = 0.f;
#pragma unroll
    for (int u = 0; u < MC_UNITS; ++u) {
      if (u >= mine) break;
#pragma unroll
      for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(v[u][e]));
    }
    const float sx = quant_scale(warp_max(mx));
    if (lane == 0) sx1[r] = sx;
#pragma unroll
    for (int u = 0; u < MC_UNITS; ++u) {
      if (u >= mine) break;
      const int k0 = 16 * (lane + 32 * u);
      int q[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) q[e] = quant_half_up(v[u][e], sx);
      *reinterpret_cast<int4*>(q1s + r * L.ldq1 + k0) = mc_pack16_mma(q);
      if (a.q1_out != nullptr && row < a.M)
        *reinterpret_cast<int4*>(a.q1_out + (size_t)row * D + k0) = mc_pack16(q);
    }
  }
  cluster.sync();  // every block's rows written
  mc_gather_rows(cluster, reinterpret_cast<unsigned char*>(q1s), L.ldq1, D, rpr, S, rank);
  mc_gather_rows(cluster, reinterpret_cast<unsigned char*>(sx1), 16, 16, rpr / 4, S, rank);
  // (the max exchange's cluster barrier comes before the gathered space is
  // reused for fc2's partials)
  // (the ring's first __syncthreads orders these writes before fc1)

  // b. fc1 + GELU over the slice, NC hidden columns a chunk (steps 3-5);
  // each chunk's b1 and s1 are fetched into registers at its first stage
  int acc[MT][4][4];
  float hmax[MT][2], b1p[8], s1p[8];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    hmax[mt][0] = hmax[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0;
  }
  mc_loop(total1, load1, [&](int it, int slot) {
    if (!cols) return;
    const int c = it / ks1, kt = it % ks1;
    if (kt == 0) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int hj = hid0 + c * NC + wn * 32 + 8 * t + cc;
        b1p[cc] = to_f(b1[hj]);
        s1p[cc] = a.s1[hj];
      }
    }
    mc_mma_s8_stage<W8_ROWS / 32, MT, LD>(acc, q1s, L.ldq1, wr0, kt * W8_ROWS, ring + slot * STAGE,
                                          wn * 32, lane);
    if (kt != ks1 - 1) return;
    // the chunk's h: thread (g, t) holds rows g, g + 8 of each 16-row tile
    // at the chunk's columns wn * 32 + 8 t + cc, cc = 0..7
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr0 + 16 * mt + g + 8 * half, row = row0 + r;
        const float sxr = sx1[r];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int col = c * NC + wn * 32 + 8 * t + cc;
          const int v = acc[mt][cc & 3][(cc >> 2) + 2 * half];
          const float h = __fadd_rn(__fmul_rn((float)v, __fmul_rn(sxr, s1p[cc])), b1p[cc]);
          const T gv = from_f<T>(gelu_tanh(to_f(from_f<T>(h))));
          hs[r * L.ldh + col] = gv;
          hmax[mt][half] = fmaxf(hmax[mt][half], fabsf(to_f(gv)));
          if (a.acc1_out != nullptr && row < a.M)
            a.acc1_out[(size_t)row * MD + hid0 + col] = v;
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0;
  });

  // fc2's first weight stages go out now, behind the exchange and q2
  const int ks2 = slice / W8_ROWS, total2 = (D / NC) * ks2;
  auto load2 = [&](int it, int slot) {
    const int oc = it / ks2, kt = it % ks2;
    mc_load_stage<SB>(ring + slot * STAGE,
                  reinterpret_cast<const unsigned char*>(a.w2) +
                      (size_t)(hid0 + kt * W8_ROWS) * D + oc * NC,
                  (size_t)D, W8_ROWS, LD);
  };
  mc_prologue(total2, load2);

  // c. each row's max |h| over the slice, then over the cluster (step 6)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m = quad_max(hmax[mt][half]);
      if (t == 0) rpart[wn * BM + wr0 + 16 * mt + g + 8 * half] = m;
    }
  __syncthreads();
  if (tid < BM) {
    if constexpr (CW == 4)
      rmax[tid] = fmaxf(fmaxf(rpart[tid], rpart[BM + tid]),
                        fmaxf(rpart[2 * BM + tid], rpart[3 * BM + tid]));
    else
      rmax[tid] = fmaxf(fmaxf(rpart[tid], rpart[BM + tid]), rpart[2 * BM + tid]);
  }
  cluster.sync();  // every block's rmax written and visible
  if (tid < BM) {
    float m = 0.f;
    for (int q = 0; q < S; ++q) m = fmaxf(m, *cluster.map_shared_rank(rmax + tid, q));
    sx2[tid] = quant_scale(m);
  }
  __syncthreads();
  // q2 of the slice, 16 columns a thread-step, stored in the A operand's order
  const int kb16 = slice / 16;
  for (int e = tid; e < BM * kb16; e += MC_THREADS) {
    const int r = e / kb16, k0 = 16 * (e % kb16), row = row0 + r;
    const float s = sx2[r];
    int q[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = quant_half_up(to_f(hs[r * L.ldh + k0 + i]), s);
    *reinterpret_cast<int4*>(q2s + r * L.ldq2 + k0) = mc_pack16_mma(q);
    if (a.q2_out != nullptr && row < a.M)
      *reinterpret_cast<int4*>(a.q2_out + (size_t)row * MD + hid0 + k0) = mc_pack16(q);
  }
  // (the ring's first __syncthreads orders q2 before fc2)

  // d-e. fc2 partials over the slice, NC output columns a chunk; the
  // cluster sums each chunk's partials (step 7), then y (step 8)
  // y for the owned columns of chunk c from the partials of pbuf[c & 1],
  // x, b2 and s2 fetched into registers beforehand
  float xp[ITEMS][4], b2p[ITEMS][4], s2p[ITEMS][4];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      int r, cc;
      if (!mc_item<BM, NC>(S, rank, u, r, cc)) break;
      const int row = min(row0 + r, a.M - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c * NC + cc + i;
        xp[u][i] = to_f(x[(size_t)row * D + col]);
        b2p[u][i] = to_f(b2[col]);
        s2p[u][i] = a.s2[col];
      }
    }
  };
  auto reduce = [&](int c) {
    const uint32_t* pb = pbuf + (c & 1) * BM * PLD;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      int r, cc;
      if (!mc_item<BM, NC>(S, rank, u, r, cc)) break;
      const int4 v = mc_sum_ranks<int4, NC>(cluster, pb, S, r, cc, [](int4& v, const int4 w) {
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      });
      const int row = row0 + r;
      if (row >= a.M) continue;
      const int vs[4] = {v.x, v.y, v.z, v.w};
      const float sxr = sx2[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t idx = (size_t)row * D + c * NC + cc + i;
        const float tv = __fmul_rn((float)vs[i], __fmul_rn(sxr, s2p[u][i]));
        y[idx] = from_f<T>(__fadd_rn(__fadd_rn(xp[u][i], tv), b2p[u][i]));
        if (a.acc2_out != nullptr) a.acc2_out[idx] = vs[i];
      }
    }
  };
  // chunk oc: its products; then the previous chunk's sums (its barrier
  // arrived a chunk ago), then its own partials, then this chunk's arrival
  mc_loop(total2, load2, [&](int it, int slot) {
    const int oc = it / ks2, kt = it % ks2;
    if (kt == 0 && oc > 0) fetch(oc - 1);
    if (cols)
      mc_mma_s8_stage<W8_ROWS / 32, MT, LD>(acc, q2s, L.ldq2, wr0, kt * W8_ROWS,
                                            ring + slot * STAGE, wn * 32, lane);
    if (kt != ks2 - 1) return;
    if (oc > 0) {
      mc_cluster_wait();  // chunk oc - 1's partials written
      reduce(oc - 1);
    }
    uint32_t* pb = pbuf + (oc & 1) * BM * PLD;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!cols) break;
        int* p = reinterpret_cast<int*>(pb + (wr0 + 16 * mt + g + 8 * half) * PLD + wn * 32 +
                                        8 * t);
        const int e = 2 * half;
        *reinterpret_cast<int4*>(p) =
            make_int4(acc[mt][0][e], acc[mt][1][e], acc[mt][2][e], acc[mt][3][e]);
        *reinterpret_cast<int4*>(p + 4) =
            make_int4(acc[mt][0][e + 1], acc[mt][1][e + 1], acc[mt][2][e + 1], acc[mt][3][e + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][j][e] = acc[mt][j][e + 1] = 0;
      }
    mc_cluster_arrive();  // the chunk's partials written
  });
  fetch(D / NC - 1);
  mc_cluster_wait();
  reduce(D / NC - 1);
  cluster.sync();  // no block leaves while a peer may read its partials
}

template <typename T, int BM>
__global__ void __launch_bounds__(MC_THREADS) w8a8_mma_kernel(const W8a8MmaArgs a) {
  w8a8_mma_body<T, BM, MC_NC>(a);
}

template <typename T, int BM>
__global__ void __launch_bounds__(MC_THREADS) w8a8_mma96_kernel(const W8a8MmaArgs a) {
  w8a8_mma_body<T, BM, MC_NC_NARROW>(a);
}

// The instantiation for activations of T, chunks of nc and tiles of bm rows
// (32 or 64), and its block's shared memory at (d, md).
struct W8Kernel {
  void (*fn)(const W8a8MmaArgs);
  size_t smem;
};

template <typename T>
W8Kernel w8_kernel(int nc, int bm, int d, int md) {
  if (nc == MC_NC)
    return {bm == 32 ? w8a8_mma_kernel<T, 32> : w8a8_mma_kernel<T, 64>,
            w8_layout<MC_NC>(d, md, sizeof(T), bm).total};
  return {bm == 32 ? w8a8_mma96_kernel<T, 32> : w8a8_mma96_kernel<T, 64>,
          w8_layout<MC_NC_NARROW>(d, md, sizeof(T), bm).total};
}

// Rows of d and md hidden columns the kernel takes: their chunk, else 0.
inline int w8_chunk(int d, int md) { return mc_cluster_of(d, md) == 0 ? 0 : mc_chunk_of(d); }

// A block of the largest tile, bytes, at (d, md) and activations of esize
// bytes (0 where the kernel takes no such rows).
inline size_t w8_smem(int d, int md, int esize) {
  const int nc = w8_chunk(d, md);
  if (nc == 0) return 0;
  return nc == MC_NC ? w8_layout<MC_NC>(d, md, esize, MC_ROWS).total
                     : w8_layout<MC_NC_NARROW>(d, md, esize, MC_ROWS).total;
}

template <typename T>
int launch(const W8a8MmaArgs& a, int bm, cudaStream_t stream) {
  const int nc = w8_chunk(a.D, a.MD);
  if (a.M <= 0 || nc == 0 || (bm != 32 && bm != 64)) return (int)cudaErrorInvalidValue;
  if (w8_smem(a.D, a.MD, sizeof(T)) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const W8Kernel k = w8_kernel<T>(nc, bm, a.D, a.MD);
  return (int)mc_launch(k.fn, a, mc_cluster_of(a.D, a.MD), a.M, bm, k.smem, stream);
}

template <typename T>
cudaError_t prepare() {
  cudaError_t err = mc_prepare(w8a8_mma_kernel<T, 32>);
  if (err == cudaSuccess) err = mc_prepare(w8a8_mma_kernel<T, 64>);
  if (err == cudaSuccess) err = mc_prepare(w8a8_mma96_kernel<T, 32>);
  return err != cudaSuccess ? err : mc_prepare(w8a8_mma96_kernel<T, 64>);
}

template <typename T>
int max_clusters(int d, int md, int bm) {
  const int nc = w8_chunk(d, md);
  if (nc == 0 || (bm != 32 && bm != 64)) return -1;
  const W8Kernel k = w8_kernel<T>(nc, bm, d, md);
  return mc_max_clusters(k.fn, mc_cluster_of(d, md), k.smem);
}

}  // namespace

extern "C" {

// The largest tile's rows and the widest row; ops/fused_mlp.py holds the
// same numbers and checks them after the build.
int ivt_mlp_w8a8_mma_rows() { return MC_ROWS; }
int ivt_mlp_w8a8_mma_max_width() { return MC_MAX_WIDTH; }

// The chunk of rows of width d (128, 96, or 0: the route does not take d).
int ivt_mlp_w8a8_mma_chunk(int d) { return mc_chunk_of(d); }

// The cluster size at rows of width d and md hidden columns (0: the route
// does not take them).
int ivt_mlp_w8a8_mma_cluster(int d, int md) { return mc_cluster_of(d, md); }

// Dynamic shared memory a block of the largest tile takes for rows of width
// d, md hidden columns and an activation type of esize bytes (0 where the
// route does not take them).
size_t ivt_mlp_w8a8_mma_smem_bytes(int d, int md, int esize) { return w8_smem(d, md, esize); }

// Lets the eight instantiations take the shared memory they need on the
// current device: once a device, before its first launch or max_clusters.
// Returns a cudaError_t value.
int ivt_mlp_w8a8_mma_prepare() {
  const cudaError_t err = prepare<float>();
  return (int)(err != cudaSuccess ? err : prepare<__nv_bfloat16>());
}

// Clusters the card holds at once at (d, md) in the dtype (0 = float32, 1 =
// bfloat16) with tiles of bm (32 or 64) rows, or -1.
int ivt_mlp_w8a8_mma_max_clusters(int dtype, int d, int md, int bm) {
  if (dtype == 0) return max_clusters<float>(d, md, bm);
  if (dtype == 1) return max_clusters<__nv_bfloat16>(d, md, bm);
  return -1;
}

// The entry of fused_mlp_w8a8_block.cu and a tile of bm (32 or 64) rows a
// cluster, for the operands ops/fused_mlp.py routes here (dtype 0 =
// float32, 1 = bfloat16; x, y, ln_s, ln_b and the int8 weights 16-byte
// aligned). Returns a cudaError_t value.
int ivt_fused_mlp_w8a8_mma(int dtype, const void* x, const void* ln_s, const void* ln_b,
                           const void* w1, const void* s1, const void* b1, const void* w2,
                           const void* s2, const void* b2, void* y, void* q1_out, void* acc1_out,
                           void* q2_out, void* acc2_out, int M, int D, int MD, int bm, float eps,
                           void* stream) {
  W8a8MmaArgs a{x,
                ln_s,
                ln_b,
                static_cast<const int8_t*>(w1),
                static_cast<const float*>(s1),
                b1,
                static_cast<const int8_t*>(w2),
                static_cast<const float*>(s2),
                b2,
                y,
                static_cast<int8_t*>(q1_out),
                static_cast<int*>(acc1_out),
                static_cast<int8_t*>(q2_out),
                static_cast<int*>(acc2_out),
                M,
                D,
                MD,
                eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, bm, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, bm, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
