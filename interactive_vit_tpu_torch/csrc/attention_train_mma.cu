// The trainable attention on Hopper's tensor cores, bf16, heads 64 or 80
// wide: the forward o = softmax(q k^T * scale) v with its per-row (m, l),
// and the backward dq, dk, dv, on q, k, v, do [B, H, N, dh] given by element
// strides of image, head and token (the head dim contiguous, every pointer
// and stride 16-byte aligned). As attention_bwd.cu, one set of kernels
// serves both of the port's layouts: the [B, H, N, dh] views of
// attention_train and the head-major [B, N, 3D] qkv of
// attention_train_packed (64-wide head slabs at 128-byte offsets).
//
// Replaces, for bf16, the Pallas TPU kernels of
// interactive_vit_tpu/ops/attention_vjp.py: the forward of _bwd_call's
// pair (flash_attention's _rowfull_kernel) and _packed_fwd_kernel, and the
// backward _bwd_kernel / _packed_bwd_kernel (_head_grads). f32 stays on
// flash_attention.cu + attention_bwd.cu (f32 FMA). Numerics and cast points:
//   s     = q k^T * scale in f32 (bf16 products, f32 sums); keys >= n_real
//           at mask_value;
//   probs = exp(s - m) / l, m the row max and l = rowsum(exp(s - m)), a
//           division; the forward casts the normalised probs to bf16 before
//           PV (not the online form: no p is cast against a running max),
//           o accumulated in f32 and cast;
//   dv    = bf16(probs)^T do; dP = do v^T in f32;
//   delta = rowsum(dP * probs), from dP and probs (not from o);
//   ds    = bf16((probs * (dP - delta)) * scale);
//   dq    = ds k, dk = ds^T q, f32-accumulated; all three cast to bf16.
// Masked keys get probs of exactly 0 (exp(mask_value - m) underflows), so
// their dk and dv are exactly 0; padded query rows get their gradients
// like any other row. Ragged N (197 is not a multiple of 16 or 64): the
// rows of a tile past N are zero-filled by cp.async; as keys they are
// masked (N >= n_real), as queries the backward gives them m = +inf and so
// probs of 0; none of them is stored.
//
// The row statistics. The forward walks the key tiles twice: pass 1 forms
// (m, l) with the online update (m the exact row max; l = alpha l +
// rowsum(exp(s - m_next)), the rounding of a running sum), pass 2 forms the
// normalised probs from them. It writes (m, l) per row to an f32 buffer
// that the autograd Function saves beside q, k, v (an internal residual:
// the JAX kernels save q, k, v only; outputs and gradients are unchanged).
// The backward reads them instead of recomputing the row statistics:
//   (a) dq: one block per (64-row query tile, head, image), 4 warps of 16
//       rows, Q and dO fragments in registers. Two walks over the key
//       tiles: P and dP, giving delta; then P and dP again, ds, and
//       dq += ds K. It writes dq and delta (f32 workspace).
//   (b) dk, dv: one block per (64-key tile, head, image), 4 warps of 16
//       keys, K and V fragments in registers. It walks the query tiles,
//       forms S^T = K Q^T and dP^T = V dO^T, P^T from the saved (m, l),
//       and accumulates dv += bf16(P^T) dO and dk += dS^T Q in registers.
// No atomics; every sum in a fixed order. Hazard: (a) forms S as Q K^T and
// (b) as K Q^T (and the forward as Q K^T in its own tiles), so an f32 score
// can differ between them in the last bit (the tensor cores' sum order over
// dh differs with the operand roles); where FMA kernels share one
// instruction chain, these do not. The bf16 bounds absorb that difference:
// it moves a probability by ~1e-7 of itself, far inside a bf16 ulp.
//
// Every kernel is FlashAttention-2's mma.sync layout (mma_attention.cuh):
// tiles of 64 rows of the streamed operands in a two-stage cp.async ring
// (the next tile in flight while the current one computes), products on
// bf16 tensor cores, scores and probs in accumulator registers, which are
// reused as the A operand of the next product. The backward kernels take
// each 64-column tile in two halves of 32 (the same sums in the same
// order), so that they fit 168 registers and three blocks share an SM
// (whole tiles took 183 and 232, two blocks an SM). The exponent is expf and
// the scale, subtraction, division and delta terms are explicitly rounded
// operations (no contraction).
//
// Heads 80 wide (vit_h14): every kernel is templated on the width
// (MmaDims<DH>: shared rows of 88 bf16, five 16-deep steps over the head
// dim, ten 8-column tiles of an output row), one instantiation a width;
// the 64-wide ones compile to the same machine code as before. At 80 the
// backward's fragments and sums grow: dq holds Q and dO fragments of 5
// steps and dq[10][4] (16 registers more than at 64), dk/dv K and V
// fragments and dk, dv[10][4] (24 more). So the part of a tile the
// backward takes at a time and its minimum blocks an SM are functions of
// the width (TM_HALF_80, TM_DQ_BLOCKS_80, TM_DKDV_BLOCKS_80). From
// tools/kernel_variants.py on an H100 SXM (the backward alone, at vit_h14's
// B = 2 / B = 8, 16 heads, N = 257): halves of 32 at two blocks an SM
// fit dk/dv in 235 registers without spilling (0.1362 / 0.2586 ms); at
// three they spill 260 bytes (0.1444 / 0.2553); parts of 16 at three
// blocks spill 88 bytes in dk/dv, none in dq, and took 0.1385 / 0.2424 ms,
// the fastest at B = 8, the shape of the bf16 train step; whole tiles at
// two blocks took 0.1390 / 0.2687. So 80 wide takes parts of 16 at three
// blocks an SM. The sums are the same in any of these: each 16-deep step
// adds into the same accumulators in the same order. Shared memory at 80:
// two stages of 2 x 64 x 88 bf16 plus the stats, 46,592 bytes a block.
//
// What bounds it on this card: at vit_b16's train shape (B = 64, 12 heads,
// N = 197, dh = 64) forward and backward are 14 N^2 dh a head, 26.7 GFLOP
// over 213 MB: bound by bytes (~64 us) at the published rates. This version
// computes S and dP three times each in the backward (dq's two walks and
// dk/dv's one) and S twice in the forward, on mma.sync (a fraction of the
// wgmma rate), with an expf per score each time; at N = 197 four 64-row
// tiles hold 256 rows, 77% of them real.
//
// Plain C interface, bound from Python with ctypes; launches go on the
// caller's stream and each entry returns the first CUDA error.

#include "mma_attention.cuh"

namespace {

constexpr int TM_ROWS = 64, TM_WARPS = 4, TM_THREADS = 32 * TM_WARPS, TM_KT = 64;
constexpr int TM_NT = TM_KT / 8;             // 8-column tiles of a 64-wide tile
// The backward kernels take a tile's 64 columns in two halves of 32, so
// that a thread holds 16 score and 16 dP accumulators at a time, not 32
// each: with that they fit 168 registers and three blocks share an SM.
constexpr int TM_HALF = TM_KT / 2, TM_BWD_BLOCKS = 3;
// Heads 80 wide: the part of a tile the backward takes at a time, and the
// minimum blocks an SM of its dq and dk/dv kernels (at three, halves of 32
// spill; parts of 16 spill less and run faster at vit_h14's train shape)
constexpr int TM_HALF_80 = 16, TM_DQ_BLOCKS_80 = 3, TM_DKDV_BLOCKS_80 = 3;
constexpr int TM_STATS = 3 * TM_KT;          // (m, l, delta) of a query tile, f32

// the head widths the kernels are built for
constexpr int TM_DHS[] = {64, 80};

// The shapes that follow from the head width DH.
template <int DH>
struct TrainMmaCfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  static constexpr int LD = MmaDims<DH>::LD;  // padded row of a shared tile, bf16
  static constexpr int TILE = TM_KT * LD;     // one [64][LD] bf16 tile
  // a stage of the ring: two tiles (K + V, or Q + dO) and, in (b), the stats
  static constexpr size_t STAGE_BYTES =
      2 * TILE * sizeof(__nv_bfloat16) + TM_STATS * sizeof(float);
  static constexpr size_t SMEM = 2 * STAGE_BYTES;
  static constexpr int HALF = DH == 64 ? TM_HALF : TM_HALF_80, HNT = HALF / 8;
  static constexpr int DQ_BLOCKS = DH == 64 ? TM_BWD_BLOCKS : TM_DQ_BLOCKS_80;
  static constexpr int DKDV_BLOCKS = DH == 64 ? TM_BWD_BLOCKS : TM_DKDV_BLOCKS_80;
};

enum { Q_ = 0, K_, V_, DO_, DQ_, DK_, DV_ };

struct TrainMmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  __nv_bfloat16* o;  // forward
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;  // [2][B * H * N]: m, l (written by the forward, read by the backward)
  float* delta;  // [B * H * N] (written by (a), read by (b))
  // element strides (image, head, token): q, k, v, do, dq, dk, dv; the
  // forward's o takes the dq slot
  long long st[7][3];
  int B, H, N, n_real;
  float scale, mask_value;
};

template <typename P>
__device__ __forceinline__ P* head_base(const TrainMmaArgs& a, P* p, int which, int b, int h) {
  return p + b * a.st[which][0] + h * a.st[which][1];
}

template <int DH>
__device__ __forceinline__ __nv_bfloat16* stage_tile(unsigned char* smem, int stage, int which) {
  using C = TrainMmaCfg<DH>;
  return reinterpret_cast<__nv_bfloat16*>(smem + stage * C::STAGE_BYTES) + which * C::TILE;
}

template <int DH>
__device__ __forceinline__ float* stage_stats(unsigned char* smem, int stage) {
  using C = TrainMmaCfg<DH>;
  return reinterpret_cast<float*>(smem + stage * C::STAGE_BYTES +
                                  2 * C::TILE * sizeof(__nv_bfloat16));
}

// a score from its dot product: scaled, or mask_value for a key >= n_real
__device__ __forceinline__ float score(float dot, bool live, const TrainMmaArgs& a) {
  return live ? __fmul_rn(dot, a.scale) : a.mask_value;
}

__device__ __forceinline__ float prob(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

__device__ __forceinline__ float dscore(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// ---------------------------------------------------------------------------
// The forward: steps 0 .. T-1 are pass 1 (K tiles: m, l), T .. 2T-1 pass 2
// (K and V tiles: probs and PV), one ring across both.
template <int DH>
__global__ void __launch_bounds__(TM_THREADS) train_fwd_mma_kernel(const TrainMmaArgs a) {
  extern __shared__ float4 tm_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(tm_smem4);
  const int q0 = blockIdx.x * TM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, n_tiles = (N + TM_KT - 1) / TM_KT, steps = 2 * n_tiles;
  const __nv_bfloat16* kb = head_base(a, a.k, K_, b, h);
  const __nv_bfloat16* vb = head_base(a, a.v, V_, b, h);

  load_tile_async<DH>(stage_tile<DH>(smem, 1, 0), head_base(a, a.q, Q_, b, h), a.st[Q_][2], q0,
                      TM_ROWS, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 0, 0), kb, a.st[K_][2], 0, TM_KT, N, TM_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  load_a_frags<DH>(qf, stage_tile<DH>(smem, 1, 0), 16 * warp, lane);
  __syncthreads();

  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * TM_KT;
      load_tile_async<DH>(stage_tile<DH>(smem, nx & 1, 0), kb, a.st[K_][2], j1, TM_KT, N,
                          TM_THREADS);
      if (nx >= n_tiles)
        load_tile_async<DH>(stage_tile<DH>(smem, nx & 1, 1), vb, a.st[V_][2], j1, TM_KT, N,
                            TM_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = it >= n_tiles;
    const int j0 = (it % n_tiles) * TM_KT;
    float s[TM_NT][4];
    mma_rows<TM_NT, DH>(s, qf, stage_tile<DH>(smem, it & 1, 0), lane);
#pragma unroll
    for (int n = 0; n < TM_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = score(s[n][e], j0 + 8 * n + 2 * t + (e & 1) < a.n_real, a);

    if (!pass2) {
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, m_next[2];
#pragma unroll
      for (int n = 0; n < TM_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) m_next[r] = fmaxf(m_run[r], quad_max(mx[r]));
#pragma unroll
      for (int n = 0; n < TM_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[e >> 1] = __fadd_rn(sum[e >> 1], expf(__fsub_rn(s[n][e], m_next[e >> 1])));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = expf(__fsub_rn(m_run[r], m_next[r]));
        l_run[r] = __fadd_rn(__fmul_rn(alpha, l_run[r]), quad_sum(sum[r]));
        m_run[r] = m_next[r];
      }
    } else {
#pragma unroll
      for (int n = 0; n < TM_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = prob(s[n][e], m_run[e >> 1], l_run[e >> 1]);
      const __nv_bfloat16* Vs = stage_tile<DH>(smem, it & 1, 1);
#pragma unroll
      for (int kk = 0; kk < TM_KT / 16; ++kk) {
        uint32_t pa[4];
        a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
        mma_a_by_cols<DH>(oacc, pa, Vs, 16 * kk, lane);
      }
    }
    __syncthreads();
  }

  store_rows<DH>(head_base(a, a.o, DQ_, b, h) + (long long)q0 * a.st[DQ_][2], a.st[DQ_][2],
                 oacc, 16 * warp, N - q0, lane);
  if (t == 0) {
    const size_t plane = (size_t)a.B * a.H * N, row0 = ((size_t)b * a.H + h) * N + q0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * warp + g + 8 * r;
      if (q0 + i < N) {
        a.stats[row0 + i] = m_run[r];
        a.stats[plane + row0 + i] = l_run[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (a) dq and delta: steps 0 .. T-1 form delta, T .. 2T-1 ds and dq.
template <int DH>
__global__ void __launch_bounds__(TM_THREADS, TrainMmaCfg<DH>::DQ_BLOCKS)
    train_dq_mma_kernel(const TrainMmaArgs a) {
  using C = TrainMmaCfg<DH>;
  extern __shared__ float4 tm_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(tm_smem4);
  const int q0 = blockIdx.x * TM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, n_tiles = (N + TM_KT - 1) / TM_KT, steps = 2 * n_tiles;
  const __nv_bfloat16* kb = head_base(a, a.k, K_, b, h);
  const __nv_bfloat16* vb = head_base(a, a.v, V_, b, h);

  // Q and dO through stage 1, key tile 0 into stage 0
  load_tile_async<DH>(stage_tile<DH>(smem, 1, 0), head_base(a, a.q, Q_, b, h), a.st[Q_][2], q0,
                      TM_ROWS, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 1, 1), head_base(a, a.dout, DO_, b, h), a.st[DO_][2], q0,
                  TM_ROWS, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 0, 0), kb, a.st[K_][2], 0, TM_KT, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 0, 1), vb, a.st[V_][2], 0, TM_KT, N, TM_THREADS);
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
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4], of[DH / 16][4];
  load_a_frags<DH>(qf, stage_tile<DH>(smem, 1, 0), 16 * warp, lane);
  load_a_frags<DH>(of, stage_tile<DH>(smem, 1, 1), 16 * warp, lane);
  __syncthreads();

  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * TM_KT;
      load_tile_async<DH>(stage_tile<DH>(smem, nx & 1, 0), kb, a.st[K_][2], j1, TM_KT, N,
                          TM_THREADS);
      load_tile_async<DH>(stage_tile<DH>(smem, nx & 1, 1), vb, a.st[V_][2], j1, TM_KT, N,
                          TM_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = it >= n_tiles;
    const int j0 = (it % n_tiles) * TM_KT;
    const __nv_bfloat16* Ks = stage_tile<DH>(smem, it & 1, 0);
    const __nv_bfloat16* Vs = stage_tile<DH>(smem, it & 1, 1);
    // the keys in parts of C::HALF (at 64 wide two halves of 32), in order
#pragma unroll
    for (int half = 0; half < TM_KT / C::HALF; ++half) {
      const int c0 = C::HALF * half;
      float s[C::HNT][4], dp[C::HNT][4];
      mma_rows<C::HNT, DH>(s, qf, Ks + c0 * C::LD, lane);
      mma_rows<C::HNT, DH>(dp, of, Vs + c0 * C::LD, lane);
#pragma unroll
      for (int n = 0; n < C::HNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = prob(score(s[n][e], j0 + c0 + 8 * n + 2 * t + (e & 1) < a.n_real, a),
                         m[e >> 1], l[e >> 1]);
      if (!pass2) {
#pragma unroll
        for (int n = 0; n < C::HNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            delta[e >> 1] = __fadd_rn(delta[e >> 1], __fmul_rn(s[n][e], dp[n][e]));
      } else {
#pragma unroll
        for (int kk = 0; kk < C::HALF / 16; ++kk) {
          float lo[4], hi[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo[e] = dscore(s[2 * kk][e], dp[2 * kk][e], delta[e >> 1], a.scale);
            hi[e] = dscore(s[2 * kk + 1][e], dp[2 * kk + 1][e], delta[e >> 1], a.scale);
          }
          uint32_t da[4];
          a_from_acc(da, lo, hi);
          mma_a_by_cols<DH>(dq, da, Ks, c0 + 16 * kk, lane);
        }
      }
    }
    if (it == n_tiles - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
    }
    __syncthreads();
  }

  store_rows<DH>(head_base(a, a.dq, DQ_, b, h) + (long long)q0 * a.st[DQ_][2], a.st[DQ_][2], dq,
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
__global__ void __launch_bounds__(TM_THREADS, TrainMmaCfg<DH>::DKDV_BLOCKS)
    train_dkdv_mma_kernel(const TrainMmaArgs a) {
  using C = TrainMmaCfg<DH>;
  extern __shared__ float4 tm_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(tm_smem4);
  const int k0 = blockIdx.x * TM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, steps = (N + TM_KT - 1) / TM_KT;
  const __nv_bfloat16* qb = head_base(a, a.q, Q_, b, h);
  const __nv_bfloat16* ob = head_base(a, a.dout, DO_, b, h);
  const size_t plane = (size_t)a.B * a.H * N, row0 = ((size_t)b * a.H + h) * N;

  // K and V through stage 1, query tile 0 into stage 0
  load_tile_async<DH>(stage_tile<DH>(smem, 1, 0), head_base(a, a.k, K_, b, h), a.st[K_][2], k0,
                      TM_ROWS, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 1, 1), head_base(a, a.v, V_, b, h), a.st[V_][2], k0,
                      TM_ROWS, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 0, 0), qb, a.st[Q_][2], 0, TM_KT, N, TM_THREADS);
  load_tile_async<DH>(stage_tile<DH>(smem, 0, 1), ob, a.st[DO_][2], 0, TM_KT, N, TM_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  load_a_frags<DH>(kf, stage_tile<DH>(smem, 1, 0), 16 * warp, lane);
  load_a_frags<DH>(vf, stage_tile<DH>(smem, 1, 1), 16 * warp, lane);
  __syncthreads();

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  // the warp's keys g and g + 8 (rows of its accumulators)
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = k0 + 16 * warp + g + 8 * r < a.n_real;

  for (int it = 0; it < steps; ++it) {
    const int i0 = it * TM_KT;
    if (it + 1 < steps) {
      load_tile_async<DH>(stage_tile<DH>(smem, (it + 1) & 1, 0), qb, a.st[Q_][2], i0 + TM_KT, TM_KT,
                          N, TM_THREADS);
      load_tile_async<DH>(stage_tile<DH>(smem, (it + 1) & 1, 1), ob, a.st[DO_][2], i0 + TM_KT,
                          TM_KT, N, TM_THREADS);
      cp_async_commit();
    }
    // this tile's (m, l, delta); queries past N get probs of 0
    float* st = stage_stats<DH>(smem, it & 1);
    if (threadIdx.x < TM_KT) {
      const int i = threadIdx.x;
      const bool in = i0 + i < N;
      st[i] = in ? a.stats[row0 + i0 + i] : INFINITY;
      st[TM_KT + i] = in ? a.stats[plane + row0 + i0 + i] : 1.f;
      st[2 * TM_KT + i] = in ? a.delta[row0 + i0 + i] : 0.f;
    }
    if (it + 1 < steps) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qs = stage_tile<DH>(smem, it & 1, 0);
    const __nv_bfloat16* Os = stage_tile<DH>(smem, it & 1, 1);
    // the queries in parts of C::HALF (at 64 wide two halves of 32), in
    // order
#pragma unroll
    for (int half = 0; half < TM_KT / C::HALF; ++half) {
      const int c0 = C::HALF * half;
      float s[C::HNT][4], dp[C::HNT][4];
      mma_rows<C::HNT, DH>(s, kf, Qs + c0 * C::LD, lane);   // S^T: keys x queries
      mma_rows<C::HNT, DH>(dp, vf, Os + c0 * C::LD, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < C::HNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c0 + 8 * n + 2 * t + (e & 1);  // the query, within the tile
          const float p = prob(score(s[n][e], live[e >> 1], a), st[i], st[TM_KT + i]);
          s[n][e] = p;
          dp[n][e] = dscore(p, dp[n][e], st[2 * TM_KT + i], a.scale);
        }
      }
#pragma unroll
      for (int kk = 0; kk < C::HALF / 16; ++kk) {
        uint32_t pa[4], da[4];
        a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
        a_from_acc(da, dp[2 * kk], dp[2 * kk + 1]);
        mma_a_by_cols<DH>(dv, pa, Os, c0 + 16 * kk, lane);
        mma_a_by_cols<DH>(dk, da, Qs, c0 + 16 * kk, lane);
      }
    }
    __syncthreads();
  }

  store_rows<DH>(head_base(a, a.dk, DK_, b, h) + (long long)k0 * a.st[DK_][2], a.st[DK_][2], dk,
                 16 * warp, N - k0, lane);
  store_rows<DH>(head_base(a, a.dv, DV_, b, h) + (long long)k0 * a.st[DV_][2], a.st[DV_][2], dv,
                 16 * warp, N - k0, lane);
}

bool args_ok(int B, int H, int N, int dh, int n_real) {
  return B > 0 && H > 0 && N > 0 && (dh == 64 || dh == 80) && n_real > 0 && n_real <= N;
}

TrainMmaArgs make_args(const long long* strides, int n_sets, int B, int H, int N, int n_real,
                       float scale, float mask_value) {
  TrainMmaArgs a{};
  for (int i = 0; i < n_sets; ++i)
    for (int j = 0; j < 3; ++j) a.st[i][j] = strides[3 * i + j];
  a.B = B;
  a.H = H;
  a.N = N;
  a.n_real = n_real;
  a.scale = scale;
  a.mask_value = mask_value;
  return a;
}

template <int DH, typename Kernel>
cudaError_t launch(Kernel kernel, const TrainMmaArgs& a, cudaStream_t stream) {
  constexpr size_t smem = TrainMmaCfg<DH>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.N + TM_ROWS - 1) / TM_ROWS, a.H, a.B), TM_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const TrainMmaArgs& a, cudaStream_t s) {
  cudaError_t err = launch<DH>(train_dq_mma_kernel<DH>, a, s);
  if (err != cudaSuccess) return err;
  return launch<DH>(train_dkdv_mma_kernel<DH>, a, s);
}

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_train_mma_dh(int i) {
  constexpr int n = sizeof(TM_DHS) / sizeof(TM_DHS[0]);
  return i >= 0 && i < n ? TM_DHS[i] : 0;
}

// Forward, heads dh wide (ivt_train_mma_dh). strides: 12 element strides,
// (image, head, token) of q, k, v, o. stats: an f32 buffer of 2 * B * H * N
// floats, (m, l) per row on return. Returns a cudaError_t value.
int ivt_attention_train_fwd_mma(const void* q, const void* k, const void* v, void* o, float* stats,
                                const long long* strides, int B, int H, int N, int dh, int n_real,
                                float scale, float mask_value, void* stream) {
  if (!args_ok(B, H, N, dh, n_real)) return (int)cudaErrorInvalidValue;
  // o's strides take the dq slot
  long long st[21] = {};
  for (int i = 0; i < 9; ++i) st[i] = strides[i];
  for (int i = 0; i < 3; ++i) st[3 * DQ_ + i] = strides[9 + i];
  TrainMmaArgs a = make_args(st, 7, B, H, N, n_real, scale, mask_value);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.stats = stats;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dh == 64 ? launch<64>(train_fwd_mma_kernel<64>, a, s)
                        : launch<80>(train_fwd_mma_kernel<80>, a, s));
}

// Backward, heads dh wide. strides: 21 element strides, (image, head, token) of q, k, v,
// do, dq, dk, dv. stats: the forward's (m, l); delta: an f32 workspace of
// B * H * N floats. Returns a cudaError_t value.
int ivt_attention_train_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, float* stats, float* delta,
                                const long long* strides, int B, int H, int N, int dh, int n_real,
                                float scale, float mask_value, void* stream) {
  if (!args_ok(B, H, N, dh, n_real)) return (int)cudaErrorInvalidValue;
  TrainMmaArgs a = make_args(strides, 7, B, H, N, n_real, scale, mask_value);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.stats = stats;
  a.delta = delta;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dh == 64 ? launch_bwd<64>(a, s) : launch_bwd<80>(a, s));
}

}  // extern "C"
