// The trainable attention's backward on Hopper's tensor cores in f32,
// heads 64 or 80 wide, through the 3xTF32 split: dq, dk, dv of o = softmax(q
// k^T * scale) v on f32 q, k, v, do [B, H, N, dh] given by element strides of
// image, head and token (the head dim contiguous, every pointer and stride
// 16-byte aligned), keys >= n_real masked out. As attention_bwd.cu and
// attention_train_mma.cu, one set of kernels serves both of the port's
// layouts: the [B, H, N, dh] views of attention_train and the head-major
// [B, N, 3D] qkv of attention_train_packed (64-wide head slabs at 256-byte
// offsets). Its forward is flash_attention_tf32.cu, which leaves each
// row's (m, l) for it.
//
// Replaces, for f32, the backward Pallas TPU kernels of
// interactive_vit_tpu/ops/attention_vjp.py: _bwd_call / _bwd_kernel
// (attention_train) and the backward half of _packed_call
// (_packed_bwd_kernel); both run _head_grads. Other f32 operands (other
// widths, or off the 16-byte grid) stay on attention_bwd.cu (f32 FMA). The
// numerics, all in f32:
//   probs = exp(s - m) / l, s = q k^T * scale recomputed (keys >= n_real at
//           mask_value), m and l the forward's row max and row sum;
//   dv    = probs^T do;
//   dP    = do v^T;
//   delta = rowsum(dP * probs), from dP and probs (not from o);
//   ds    = (probs * (dP - delta)) * scale;
//   dq    = ds k, dk = ds^T q.
// Masked keys get probs of exactly 0 (exp(mask_value - m) underflows), so
// their dk and dv are exactly 0. Ragged N (197 is not a multiple of 64):
// the rows of a tile past N are zero-filled by cp.async; as keys they are
// masked (N >= n_real), as queries they get m = +inf and so probs of 0;
// none of them is stored. The exponent is expf; the scale, subtraction,
// division and the delta and ds terms are explicitly rounded operations.
//
// The products: each is three TF32 tensor-core products on a hi / lo split
// (tf32_attention.cuh), the hi products and the correction terms in two
// accumulators, each over one short run only, then added with round to
// nearest: a score or dP element over the 8 steps of dh; a dq, dk or dv
// element over the 32 keys or queries of a streamed tile, folded into its
// running sum with a round-to-nearest add. That matters most for dk and
// dv, which sum over every query tile: the tensor cores' accumulation
// truncates, and one accumulator over N would drift.
//
// Design (attention_train_mma.cu's, in f32):
//   (a) dq: one block per (64-row query tile, head, image), 4 warps of 16
//       rows. Q and dO stay in shared memory for the whole block and are
//       split as their fragments are read (their split fragments held in
//       registers would not fit beside the accumulators). Two walks over the
//       key tiles: P and dP, giving delta; then P and dP again, ds, and dq
//       += ds K. It writes dq and delta (f32 workspace).
//   (b) dk, dv: one block per (64-key tile, head, image), 4 warps of 16
//       keys, K and V resident in shared memory. It walks the query tiles,
//       forms S^T = K Q^T and dP^T = V dO^T, P^T from the saved (m, l), and
//       accumulates dv += P^T dO and dk += dS^T Q in registers.
// The streamed operand comes in tiles of 32 keys (a) or queries (b) through
// a two-stage cp.async ring, each tile taken whole. On an H100 SXM the
// backward took 0.5122 ms at vit_t16's train shape and 1.9555 at
// vit_b16's (B = 64, N = 197), against 0.6880 / 2.8203 for tiles of 64 in
// halves of 32, 0.5740 / 2.2232 for tiles of 32 in halves of 16 and
// 0.5315 / 1.7812 for tiles of 16 (tools/kernel_variants.py): with 74,496
// bytes of shared memory (a) fits three blocks an SM at 165 registers, and
// (b) its accumulators in 254 registers without spilling (tiles of 64 in
// halves spilled at 255). Tiles of 16 win at vit_b16's head count and lose
// at vit_t16's; one size serves both. No atomics; every sum in a fixed
// order. Hazard: (a) forms S as Q K^T and
// (b) as K Q^T (and the forward as Q K^T in its own tiles), so an f32 score
// can differ between them in the last bits (the tensor cores' sum order
// over dh differs with the operand roles); where the FMA kernels share one
// instruction chain, these do not. The f32 bound absorbs that difference:
// it moves a probability by ~1e-7 of itself.
//
// What bounds it on this card: at vit_b16's train shape (B = 64, 12 heads,
// N = 197, dh = 64, f32) forward and backward are 14 N^2 dh a head, 26.7
// GFLOP over 426 MB: 0.127 ms for the bytes at 3.35 TB/s, 0.16 ms for the
// split's 3 x 26.7 GFLOP of TF32 products at 495 TFLOP/s, 0.40 ms at the
// f32 FMA peak. This version computes S and dP three times each in the
// backward (dq's two walks and dk/dv's one), on mma.sync (a fraction of
// the peak), with an expf per score each time; at N = 197 four 64-row
// tiles hold 256 rows, 77% of them real.
//
// Heads 80 wide (vit_h14): the kernels are templated on the width
// (TfDims<DH>: rows of 88 floats, ten 8-column tiles of an output row),
// one instantiation a width; the 64-wide ones compile as before. At 80 the
// 64-wide layout does not fit: dk/dv's running dk and dv are 80
// accumulators, and mma3_acc_by_cols holds the hi and correction sums of
// every 8-column tile of the product at once, 80 more. So the 80-wide
// instantiation takes mma3_acc_by_cols_dmajor, which sums the same
// products in the same order one 8-column tile at a time (8 accumulators
// beside the split P or dS fragments): the values do not change, and dk/dv
// keeps its sums in registers, and the streamed tiles are 16 wide. From
// tools/kernel_variants.py on an H100 SXM (the backward alone, at vit_h14's
// B = 2 / B = 8, 16 heads, N = 257): tiles of 16 one 8-column tile at a
// time, dk/dv in 177 registers and dq in 128 (4 bytes spilled), took
// 0.2953 / 0.6879 ms; tiles of 32 the same way, 255 and 168 registers
// without spilling, 0.2817 / 0.7512; the 64-wide layout widened spilled 16
// bytes in dk/dv (tiles of 32: 0.2792 / 0.7383; of 16: 0.2936 / 0.6720,
// dq spilling 20); tiles of 64, 0.4919 / 1.3708. Tiles of 16 lose 5% at
// B = 2 and win 9% at B = 8. The sums of dq, dk and dv fold into their
// running sums once a tile (16 products of each 3xTF32 run). Shared
// memory is 2 x 64 x 88 floats resident plus the two-stage ring of 16-row
// tiles, 67,968 bytes, three blocks an SM.
//
// Plain C interface, bound from Python with ctypes; launches go on the
// caller's stream and the entry returns the first CUDA error.

#include "tf32_attention.cuh"

namespace {

// A block's own rows (queries in (a), keys in (b)) and the tiles of the
// streamed operand (keys in (a), queries in (b)), taken in parts of
// TT_HALF (the whole tile).
constexpr int TT_ROWS = 64, TT_THREADS = 128, TT_KT = 32;
constexpr int TT_HALF = TT_KT;  // a part of a tile
// Heads 80 wide: the streamed tile (taken whole) and whether the products
// of P, dS by a streamed tile go one 8-column tile at a time
constexpr int TT_KT_80 = 16;
constexpr bool TT_D_MAJOR_80 = true;

// the head widths the kernels are built for
constexpr int TT_DHS[] = {64, 80};

// The shapes that follow from the head width DH.
template <int DH>
struct TrainTf32Cfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  static constexpr int DT = TfDims<DH>::DT, K_LD = TfDims<DH>::K_LD;
  static constexpr int KT = DH == 64 ? TT_KT : TT_KT_80;
  static constexpr int HALF = DH == 64 ? TT_HALF : KT, HNT = HALF / 8;
  static constexpr int RES = TT_ROWS * K_LD;  // one resident [64][K_LD] f32 tile
  static constexpr int TILE = KT * K_LD;      // one streamed [KT][K_LD] tile
  static constexpr int STATS = 3 * KT;        // (m, l, delta) of a query tile
  // resident: two tiles (Q + dO, or K + V); a stage of the ring: two tiles
  // (K + V, or Q + dO) and, in (b), the stats
  static constexpr int STAGE = 2 * TILE + STATS;
  static constexpr size_t SMEM = (2 * RES + 2 * STAGE) * sizeof(float);
  static constexpr bool D_MAJOR = DH == 64 ? false : TT_D_MAJOR_80;
};

// acc += A Y over a part of a streamed tile, in the width's order
template <int DH, int NT>
__device__ __forceinline__ void acc_by_cols(float acc[TfDims<DH>::DT][4], const float a[NT][4],
                                            const float* tile, int k0, int lane) {
  constexpr int K_LD = TfDims<DH>::K_LD;
  if constexpr (TrainTf32Cfg<DH>::D_MAJOR)
    mma3_acc_by_cols_dmajor<DH, NT>(acc, a, tile, K_LD, k0, lane);
  else
    mma3_acc_by_cols<DH, NT>(acc, a, tile, K_LD, k0, lane);
}

enum { Q_ = 0, K_, V_, DO_, DQ_, DK_, DV_ };

struct TrainTf32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  const float* stats;  // [2][B * H * N]: m, l (the forward's)
  float* delta;        // [B * H * N] (written by (a), read by (b))
  // element strides (image, head, token): q, k, v, do, dq, dk, dv
  long long st[7][3];
  int B, H, N, n_real;
  float scale, mask_value;
};

template <typename P>
__device__ __forceinline__ P* head_base(const TrainTf32Args& a, P* p, int which, int b, int h) {
  return p + b * a.st[which][0] + h * a.st[which][1];
}

// resident tile 0 or 1, at the start of shared memory
template <int DH>
__device__ __forceinline__ float* resident(float* smem, int which) {
  return smem + which * TrainTf32Cfg<DH>::RES;
}

// tile 0 or 1 of ring stage `stage`; its stats after both
template <int DH>
__device__ __forceinline__ float* stage_tile(float* smem, int stage, int which) {
  using C = TrainTf32Cfg<DH>;
  return smem + 2 * C::RES + stage * C::STAGE + which * C::TILE;
}

template <int DH>
__device__ __forceinline__ float* stage_stats(float* smem, int stage) {
  using C = TrainTf32Cfg<DH>;
  return smem + 2 * C::RES + stage * C::STAGE + 2 * C::TILE;
}

// a score from its dot product: scaled, or mask_value for a key >= n_real
__device__ __forceinline__ float score(float dot, bool live, const TrainTf32Args& a) {
  return live ? __fmul_rn(dot, a.scale) : a.mask_value;
}

__device__ __forceinline__ float prob(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// a warp's [16 x DH] f32 accumulators into rows of out (row stride sn)
// where the row is below `rows`; row0 is the warp's first row
template <int DH>
__device__ __forceinline__ void store_rows_f32(float* out, long long sn,
                                               const float acc[TfDims<DH>::DT][4], int row0,
                                               int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= rows) continue;
    float* o = out + (long long)r * sn + 2 * t;
#pragma unroll
    for (int n = 0; n < TfDims<DH>::DT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// (a) dq and delta: steps 0 .. T-1 form delta, T .. 2T-1 ds and dq.
template <int DH>
__global__ void __launch_bounds__(TT_THREADS) train_dq_tf32_kernel(const TrainTf32Args a) {
  using C = TrainTf32Cfg<DH>;
  constexpr int K_LD = C::K_LD, KT = C::KT, HNT = C::HNT;
  extern __shared__ float4 tt_smem4[];
  float* smem = reinterpret_cast<float*>(tt_smem4);
  const int q0 = blockIdx.x * TT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, n_tiles = (N + KT - 1) / KT, steps = 2 * n_tiles;
  const float* kb = head_base(a, a.k, K_, b, h);
  const float* vb = head_base(a, a.v, V_, b, h);

  // Q and dO resident, key tile 0 into stage 0
  load_rows_f32<DH>(resident<DH>(smem, 0), K_LD, head_base(a, a.q, Q_, b, h), a.st[Q_][2], q0,
                    TT_ROWS, N, TT_THREADS);
  load_rows_f32<DH>(resident<DH>(smem, 1), K_LD, head_base(a, a.dout, DO_, b, h), a.st[DO_][2], q0,
                    TT_ROWS, N, TT_THREADS);
  load_rows_f32<DH>(stage_tile<DH>(smem, 0, 0), K_LD, kb, a.st[K_][2], 0, KT, N, TT_THREADS);
  load_rows_f32<DH>(stage_tile<DH>(smem, 0, 1), K_LD, vb, a.st[V_][2], 0, KT, N, TT_THREADS);
  cp_async_commit();
  // the rows' saved statistics; rows past N get probs of 0
  const size_t plane = (size_t)a.B * a.H * N, row0 = ((size_t)b * a.H + h) * N + q0;
  float m[2], l[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 16 * warp + g + 8 * r;
    const bool in = q0 + i < N;
    m[r] = in ? a.stats[row0 + i] : INFINITY;
    l[r] = in ? a.stats[plane + row0 + i] : 1.f;
  }
  const float* Qw = resident<DH>(smem, 0) + 16 * warp * K_LD;
  const float* Ow = resident<DH>(smem, 1) + 16 * warp * K_LD;

  float dq[C::DT][4];
#pragma unroll
  for (int n = 0; n < C::DT; ++n) zero4(dq[n]);

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * KT;
      load_rows_f32<DH>(stage_tile<DH>(smem, nx & 1, 0), K_LD, kb, a.st[K_][2], j1, KT, N,
                        TT_THREADS);
      load_rows_f32<DH>(stage_tile<DH>(smem, nx & 1, 1), K_LD, vb, a.st[V_][2], j1, KT, N,
                        TT_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = it >= n_tiles;
    const int j0 = (it % n_tiles) * KT;
    const float* Ks = stage_tile<DH>(smem, it & 1, 0);
    const float* Vs = stage_tile<DH>(smem, it & 1, 1);
    // the keys in halves, in order
#pragma unroll
    for (int half = 0; half < KT / C::HALF; ++half) {
      const int c0 = C::HALF * half;
      float s[HNT][4], dp[HNT][4];
      mma3_rows_smem<DH, HNT>(s, Qw, Ks + c0 * K_LD, lane);
      mma3_rows_smem<DH, HNT>(dp, Ow, Vs + c0 * K_LD, lane);
#pragma unroll
      for (int n = 0; n < HNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = prob(score(s[n][e], j0 + c0 + 8 * n + 2 * t + (e & 1) < a.n_real, a),
                         m[e >> 1], l[e >> 1]);
      if (!pass2) {
#pragma unroll
        for (int n = 0; n < HNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            delta[e >> 1] = __fadd_rn(delta[e >> 1], __fmul_rn(s[n][e], dp[n][e]));
      } else {
#pragma unroll
        for (int n = 0; n < HNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = dscore(s[n][e], dp[n][e], delta[e >> 1], a.scale);
        acc_by_cols<DH, HNT>(dq, dp, Ks, c0, lane);
      }
    }
    if (it == n_tiles - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
    }
    __syncthreads();
  }

  store_rows_f32<DH>(head_base(a, a.dq, DQ_, b, h) + (long long)q0 * a.st[DQ_][2], a.st[DQ_][2], dq,
                     16 * warp, N - q0, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * warp + g + 8 * r;
      if (q0 + i < N) a.delta[row0 + i] = delta[r];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) dk and dv: each step one query tile of Q, dO and their (m, l, delta).
template <int DH>
__global__ void __launch_bounds__(TT_THREADS) train_dkdv_tf32_kernel(const TrainTf32Args a) {
  using C = TrainTf32Cfg<DH>;
  constexpr int K_LD = C::K_LD, KT = C::KT, HNT = C::HNT;
  extern __shared__ float4 tt_smem4[];
  float* smem = reinterpret_cast<float*>(tt_smem4);
  const int k0 = blockIdx.x * TT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, steps = (N + KT - 1) / KT;
  const float* qb = head_base(a, a.q, Q_, b, h);
  const float* ob = head_base(a, a.dout, DO_, b, h);
  const size_t plane = (size_t)a.B * a.H * N, row0 = ((size_t)b * a.H + h) * N;

  // K and V resident, query tile 0 into stage 0
  load_rows_f32<DH>(resident<DH>(smem, 0), K_LD, head_base(a, a.k, K_, b, h), a.st[K_][2], k0,
                    TT_ROWS, N, TT_THREADS);
  load_rows_f32<DH>(resident<DH>(smem, 1), K_LD, head_base(a, a.v, V_, b, h), a.st[V_][2], k0,
                    TT_ROWS, N, TT_THREADS);
  load_rows_f32<DH>(stage_tile<DH>(smem, 0, 0), K_LD, qb, a.st[Q_][2], 0, KT, N, TT_THREADS);
  load_rows_f32<DH>(stage_tile<DH>(smem, 0, 1), K_LD, ob, a.st[DO_][2], 0, KT, N, TT_THREADS);
  cp_async_commit();
  const float* Kw = resident<DH>(smem, 0) + 16 * warp * K_LD;
  const float* Vw = resident<DH>(smem, 1) + 16 * warp * K_LD;

  float dk[C::DT][4], dv[C::DT][4];
#pragma unroll
  for (int n = 0; n < C::DT; ++n) {
    zero4(dk[n]);
    zero4(dv[n]);
  }
  // the warp's keys g and g + 8 (rows of its accumulators)
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = k0 + 16 * warp + g + 8 * r < a.n_real;

  for (int it = 0; it < steps; ++it) {
    const int i0 = it * KT;
    if (it + 1 < steps) {
      load_rows_f32<DH>(stage_tile<DH>(smem, (it + 1) & 1, 0), K_LD, qb, a.st[Q_][2], i0 + KT, KT,
                        N, TT_THREADS);
      load_rows_f32<DH>(stage_tile<DH>(smem, (it + 1) & 1, 1), K_LD, ob, a.st[DO_][2], i0 + KT, KT,
                        N, TT_THREADS);
      cp_async_commit();
    }
    // this tile's (m, l, delta); queries past N get probs of 0
    float* st = stage_stats<DH>(smem, it & 1);
    if (threadIdx.x < KT) {
      const int i = threadIdx.x;
      const bool in = i0 + i < N;
      st[i] = in ? a.stats[row0 + i0 + i] : INFINITY;
      st[KT + i] = in ? a.stats[plane + row0 + i0 + i] : 1.f;
      st[2 * KT + i] = in ? a.delta[row0 + i0 + i] : 0.f;
    }
    if (it + 1 < steps) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qs = stage_tile<DH>(smem, it & 1, 0);
    const float* Os = stage_tile<DH>(smem, it & 1, 1);
    // the queries in halves, in order
#pragma unroll
    for (int half = 0; half < KT / C::HALF; ++half) {
      const int c0 = C::HALF * half;
      float s[HNT][4], dp[HNT][4];
      mma3_rows_smem<DH, HNT>(s, Kw, Qs + c0 * K_LD, lane);   // S^T: keys x queries
      mma3_rows_smem<DH, HNT>(dp, Vw, Os + c0 * K_LD, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < HNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c0 + 8 * n + 2 * t + (e & 1);  // the query, within the tile
          const float p = prob(score(s[n][e], live[e >> 1], a), st[i], st[KT + i]);
          s[n][e] = p;
          dp[n][e] = dscore(p, dp[n][e], st[2 * KT + i], a.scale);
        }
      }
      acc_by_cols<DH, HNT>(dv, s, Os, c0, lane);
      acc_by_cols<DH, HNT>(dk, dp, Qs, c0, lane);
    }
    __syncthreads();
  }

  store_rows_f32<DH>(head_base(a, a.dk, DK_, b, h) + (long long)k0 * a.st[DK_][2], a.st[DK_][2], dk,
                     16 * warp, N - k0, lane);
  store_rows_f32<DH>(head_base(a, a.dv, DV_, b, h) + (long long)k0 * a.st[DV_][2], a.st[DV_][2], dv,
                     16 * warp, N - k0, lane);
}

template <int DH, typename Kernel>
cudaError_t launch(Kernel kernel, const TrainTf32Args& a, cudaStream_t stream) {
  constexpr size_t smem = TrainTf32Cfg<DH>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.N + TT_ROWS - 1) / TT_ROWS, a.H, a.B), TT_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const TrainTf32Args& a, cudaStream_t s) {
  cudaError_t err = launch<DH>(train_dq_tf32_kernel<DH>, a, s);
  if (err != cudaSuccess) return err;
  return launch<DH>(train_dkdv_tf32_kernel<DH>, a, s);
}

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_train_tf32_dh(int i) {
  constexpr int n = sizeof(TT_DHS) / sizeof(TT_DHS[0]);
  return i >= 0 && i < n ? TT_DHS[i] : 0;
}

// Backward, heads dh wide (ivt_train_tf32_dh). strides: 21 element
// strides, (image, head, token) of q, k, v, do, dq, dk, dv. stats: the
// forward's (m, l), 2 * B * H * N floats (flash_attention_tf32.cu); delta:
// an f32 workspace of B * H * N floats. Returns a cudaError_t value.
int ivt_attention_train_bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, float* stats, float* delta,
                                 const long long* strides, int B, int H, int N, int dh, int n_real,
                                 float scale, float mask_value, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || (dh != 64 && dh != 80) || n_real <= 0 || n_real > N)
    return (int)cudaErrorInvalidValue;
  TrainTf32Args a{};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.stats = stats;
  a.delta = delta;
  a.B = B;
  a.H = H;
  a.N = N;
  a.n_real = n_real;
  a.scale = scale;
  a.mask_value = mask_value;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dh == 64 ? launch_bwd<64>(a, s) : launch_bwd<80>(a, s));
}

}  // extern "C"
