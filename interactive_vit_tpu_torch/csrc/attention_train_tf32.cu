// The trainable attention's backward on Hopper's tensor cores in f32,
// heads 64 wide, through the 3xTF32 split: dq, dk, dv of o = softmax(q k^T
// * scale) v on f32 q, k, v, do [B, H, N, 64] given by element strides of
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
// (_packed_bwd_kernel); both run _head_grads. Other f32 operands stay on
// attention_bwd.cu (f32 FMA). The numerics, all in f32:
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
// at vit_t16's; one size serves both. No atomics; every sum in a fixed order. Hazard: (a) forms S as Q K^T and
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
// Plain C interface, bound from Python with ctypes; launches go on the
// caller's stream and the entry returns the first CUDA error.

#include "tf32_attention.cuh"

namespace {

// The head width these kernels take (heads 80 wide stay on attention_bwd.cu)
constexpr int TF_DH = 64;
constexpr int TF_DT = TfDims<TF_DH>::DT, K_LD = TfDims<TF_DH>::K_LD;

// A block's own rows (queries in (a), keys in (b)) and the tiles of the
// streamed operand (keys in (a), queries in (b)), taken in parts of
// TT_HALF (the whole tile).
constexpr int TT_ROWS = 64, TT_THREADS = 128, TT_KT = 32;
constexpr int TT_HALF = TT_KT, TT_HNT = TT_HALF / 8;  // a part of a tile, its 8-column tiles
constexpr int TT_RES = TT_ROWS * K_LD;                     // one resident [64][K_LD] f32 tile
constexpr int TT_TILE = TT_KT * K_LD;                      // one streamed [TT_KT][K_LD] tile
constexpr int TT_STATS = 3 * TT_KT;                        // (m, l, delta) of a query tile
// resident: two tiles (Q + dO, or K + V); a stage of the ring: two tiles
// (K + V, or Q + dO) and, in (b), the stats
constexpr int TT_STAGE = 2 * TT_TILE + TT_STATS;
constexpr size_t TT_SMEM = (2 * TT_RES + 2 * TT_STAGE) * sizeof(float);

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
__device__ __forceinline__ float* resident(float* smem, int which) { return smem + which * TT_RES; }

// tile 0 or 1 of ring stage `stage`; its stats after both
__device__ __forceinline__ float* stage_tile(float* smem, int stage, int which) {
  return smem + 2 * TT_RES + stage * TT_STAGE + which * TT_TILE;
}

__device__ __forceinline__ float* stage_stats(float* smem, int stage) {
  return smem + 2 * TT_RES + stage * TT_STAGE + 2 * TT_TILE;
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

// a warp's [16 x TF_DH] f32 accumulators into rows of out (row stride sn)
// where the row is below `rows`; row0 is the warp's first row
__device__ __forceinline__ void store_rows_f32(float* out, long long sn, const float acc[TF_DT][4],
                                               int row0, int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= rows) continue;
    float* o = out + (long long)r * sn + 2 * t;
#pragma unroll
    for (int n = 0; n < TF_DT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// (a) dq and delta: steps 0 .. T-1 form delta, T .. 2T-1 ds and dq.
__global__ void __launch_bounds__(TT_THREADS) train_dq_tf32_kernel(const TrainTf32Args a) {
  extern __shared__ float4 tt_smem4[];
  float* smem = reinterpret_cast<float*>(tt_smem4);
  const int q0 = blockIdx.x * TT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, n_tiles = (N + TT_KT - 1) / TT_KT, steps = 2 * n_tiles;
  const float* kb = head_base(a, a.k, K_, b, h);
  const float* vb = head_base(a, a.v, V_, b, h);

  // Q and dO resident, key tile 0 into stage 0
  load_rows_f32<TF_DH>(resident(smem, 0), K_LD, head_base(a, a.q, Q_, b, h), a.st[Q_][2], q0,
                       TT_ROWS, N, TT_THREADS);
  load_rows_f32<TF_DH>(resident(smem, 1), K_LD, head_base(a, a.dout, DO_, b, h), a.st[DO_][2], q0,
                       TT_ROWS, N, TT_THREADS);
  load_rows_f32<TF_DH>(stage_tile(smem, 0, 0), K_LD, kb, a.st[K_][2], 0, TT_KT, N, TT_THREADS);
  load_rows_f32<TF_DH>(stage_tile(smem, 0, 1), K_LD, vb, a.st[V_][2], 0, TT_KT, N, TT_THREADS);
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
  const float* Qw = resident(smem, 0) + 16 * warp * K_LD;
  const float* Ow = resident(smem, 1) + 16 * warp * K_LD;

  float dq[TF_DT][4];
#pragma unroll
  for (int n = 0; n < TF_DT; ++n) zero4(dq[n]);

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * TT_KT;
      load_rows_f32<TF_DH>(stage_tile(smem, nx & 1, 0), K_LD, kb, a.st[K_][2], j1, TT_KT, N,
                           TT_THREADS);
      load_rows_f32<TF_DH>(stage_tile(smem, nx & 1, 1), K_LD, vb, a.st[V_][2], j1, TT_KT, N,
                           TT_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = it >= n_tiles;
    const int j0 = (it % n_tiles) * TT_KT;
    const float* Ks = stage_tile(smem, it & 1, 0);
    const float* Vs = stage_tile(smem, it & 1, 1);
    // the keys in halves, in order
#pragma unroll
    for (int half = 0; half < TT_KT / TT_HALF; ++half) {
      const int c0 = TT_HALF * half;
      float s[TT_HNT][4], dp[TT_HNT][4];
      mma3_rows_smem<TF_DH, TT_HNT>(s, Qw, Ks + c0 * K_LD, lane);
      mma3_rows_smem<TF_DH, TT_HNT>(dp, Ow, Vs + c0 * K_LD, lane);
#pragma unroll
      for (int n = 0; n < TT_HNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = prob(score(s[n][e], j0 + c0 + 8 * n + 2 * t + (e & 1) < a.n_real, a),
                         m[e >> 1], l[e >> 1]);
      if (!pass2) {
#pragma unroll
        for (int n = 0; n < TT_HNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            delta[e >> 1] = __fadd_rn(delta[e >> 1], __fmul_rn(s[n][e], dp[n][e]));
      } else {
#pragma unroll
        for (int n = 0; n < TT_HNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = dscore(s[n][e], dp[n][e], delta[e >> 1], a.scale);
        mma3_acc_by_cols<TF_DH, TT_HNT>(dq, dp, Ks, K_LD, c0, lane);
      }
    }
    if (it == n_tiles - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) delta[r] = quad_sum(delta[r]);
    }
    __syncthreads();
  }

  store_rows_f32(head_base(a, a.dq, DQ_, b, h) + (long long)q0 * a.st[DQ_][2], a.st[DQ_][2], dq,
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
__global__ void __launch_bounds__(TT_THREADS) train_dkdv_tf32_kernel(const TrainTf32Args a) {
  extern __shared__ float4 tt_smem4[];
  float* smem = reinterpret_cast<float*>(tt_smem4);
  const int k0 = blockIdx.x * TT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, steps = (N + TT_KT - 1) / TT_KT;
  const float* qb = head_base(a, a.q, Q_, b, h);
  const float* ob = head_base(a, a.dout, DO_, b, h);
  const size_t plane = (size_t)a.B * a.H * N, row0 = ((size_t)b * a.H + h) * N;

  // K and V resident, query tile 0 into stage 0
  load_rows_f32<TF_DH>(resident(smem, 0), K_LD, head_base(a, a.k, K_, b, h), a.st[K_][2], k0,
                       TT_ROWS, N, TT_THREADS);
  load_rows_f32<TF_DH>(resident(smem, 1), K_LD, head_base(a, a.v, V_, b, h), a.st[V_][2], k0,
                       TT_ROWS, N, TT_THREADS);
  load_rows_f32<TF_DH>(stage_tile(smem, 0, 0), K_LD, qb, a.st[Q_][2], 0, TT_KT, N, TT_THREADS);
  load_rows_f32<TF_DH>(stage_tile(smem, 0, 1), K_LD, ob, a.st[DO_][2], 0, TT_KT, N, TT_THREADS);
  cp_async_commit();
  const float* Kw = resident(smem, 0) + 16 * warp * K_LD;
  const float* Vw = resident(smem, 1) + 16 * warp * K_LD;

  float dk[TF_DT][4], dv[TF_DT][4];
#pragma unroll
  for (int n = 0; n < TF_DT; ++n) {
    zero4(dk[n]);
    zero4(dv[n]);
  }
  // the warp's keys g and g + 8 (rows of its accumulators)
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = k0 + 16 * warp + g + 8 * r < a.n_real;

  for (int it = 0; it < steps; ++it) {
    const int i0 = it * TT_KT;
    if (it + 1 < steps) {
      load_rows_f32<TF_DH>(stage_tile(smem, (it + 1) & 1, 0), K_LD, qb, a.st[Q_][2], i0 + TT_KT,
                           TT_KT, N, TT_THREADS);
      load_rows_f32<TF_DH>(stage_tile(smem, (it + 1) & 1, 1), K_LD, ob, a.st[DO_][2], i0 + TT_KT,
                           TT_KT, N, TT_THREADS);
      cp_async_commit();
    }
    // this tile's (m, l, delta); queries past N get probs of 0
    float* st = stage_stats(smem, it & 1);
    if (threadIdx.x < TT_KT) {
      const int i = threadIdx.x;
      const bool in = i0 + i < N;
      st[i] = in ? a.stats[row0 + i0 + i] : INFINITY;
      st[TT_KT + i] = in ? a.stats[plane + row0 + i0 + i] : 1.f;
      st[2 * TT_KT + i] = in ? a.delta[row0 + i0 + i] : 0.f;
    }
    if (it + 1 < steps) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qs = stage_tile(smem, it & 1, 0);
    const float* Os = stage_tile(smem, it & 1, 1);
    // the queries in halves, in order
#pragma unroll
    for (int half = 0; half < TT_KT / TT_HALF; ++half) {
      const int c0 = TT_HALF * half;
      float s[TT_HNT][4], dp[TT_HNT][4];
      mma3_rows_smem<TF_DH, TT_HNT>(s, Kw, Qs + c0 * K_LD, lane);   // S^T: keys x queries
      mma3_rows_smem<TF_DH, TT_HNT>(dp, Vw, Os + c0 * K_LD, lane);  // dP^T
#pragma unroll
      for (int n = 0; n < TT_HNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c0 + 8 * n + 2 * t + (e & 1);  // the query, within the tile
          const float p = prob(score(s[n][e], live[e >> 1], a), st[i], st[TT_KT + i]);
          s[n][e] = p;
          dp[n][e] = dscore(p, dp[n][e], st[2 * TT_KT + i], a.scale);
        }
      }
      mma3_acc_by_cols<TF_DH, TT_HNT>(dv, s, Os, K_LD, c0, lane);
      mma3_acc_by_cols<TF_DH, TT_HNT>(dk, dp, Qs, K_LD, c0, lane);
    }
    __syncthreads();
  }

  store_rows_f32(head_base(a, a.dk, DK_, b, h) + (long long)k0 * a.st[DK_][2], a.st[DK_][2], dk,
                 16 * warp, N - k0, lane);
  store_rows_f32(head_base(a, a.dv, DV_, b, h) + (long long)k0 * a.st[DV_][2], a.st[DV_][2], dv,
                 16 * warp, N - k0, lane);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const TrainTf32Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TT_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.N + TT_ROWS - 1) / TT_ROWS, a.H, a.B), TT_THREADS, TT_SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The head width the kernels take.
int ivt_train_tf32_dh() { return TF_DH; }

// Backward. strides: 21 element strides, (image, head, token) of q, k, v,
// do, dq, dk, dv. stats: the forward's (m, l), 2 * B * H * N floats
// (flash_attention_tf32.cu); delta: an f32 workspace of B * H * N floats.
// Returns a cudaError_t value.
int ivt_attention_train_bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                                 void* dq, void* dk, void* dv, float* stats, float* delta,
                                 const long long* strides, int B, int H, int N, int dh, int n_real,
                                 float scale, float mask_value, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || dh != TF_DH || n_real <= 0 || n_real > N)
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
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch(train_dq_tf32_kernel, a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(train_dkdv_tf32_kernel, a, s);
}

}  // extern "C"
