// The split-TF32 tensor-core pieces of the attention blocks (rows 1 and 2)
// and of the window attention (row 5), shared by headwise_attn_block_tf32.cu
// (row 2, the headwise block), fused_attn_block_tf32.cu (row 1, the
// whole-image block) and fused_window_attn_tf32.cu (row 5): attend_head,
// one head's attention for 64 query rows read by strides from the
// untransposed qkv [B, N, 3D]; row1_qkv_tf32_kernel, the QKV product from a
// ready panel of rows (rows 1 and 5); and proj_tf32_kernel, the projection
// with the residual (rows 1, 2) or without (row 5); all in f32 on three
// TF32 products a product.
// headwise_attn_block_tf32.cu's notes give the design, the
// cast points and the measured choices (key tiles of 32 at 64 wide and 64
// at 80, the per-head workspace of the head-mean).
//
// Row 1's options: ToMe's key bias (attend_head's KB, add_key_bias in
// mma_attention.cuh) and an attn_heads subset of the
// probs tap (the caller's per-head copy of the arguments: see
// fused_attn_block_tf32.cu). Row 2's instantiations take neither, and their
// code is that of the source they came from.
//
// Everything lives in an anonymous namespace, as in common.cuh.

#pragma once

#include "common.cuh"
#include "tf32_attention.cuh"

namespace {

constexpr int HT_ROWS = 64;                 // query rows of a block
constexpr int HT_WARPS = 4, HT_THREADS = 32 * HT_WARPS;
// keys of a tile and PV's parts of o's columns at each head width
// (tools/kernel_variants.py)
constexpr int HT_KT_64 = 32, HT_PV_PARTS_64 = 1;
constexpr int HT_KT_80 = 64, HT_PV_PARTS_80 = 5;

// The attention block's shape at head width DH.
template <int DH>
struct HwTf32Cfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  using D = TfDims<DH>;
  static constexpr int KT = DH == 64 ? HT_KT_64 : HT_KT_80;  // keys of a tile
  static constexpr int PV_PARTS = DH == 64 ? HT_PV_PARTS_64 : HT_PV_PARTS_80;
  static constexpr int NT = KT / 8;
  static constexpr int STAGE = KT * (D::K_LD + D::V_LD);  // floats: K then V
  // Q through stage 1's K slot, or (a K slot too small) its own tile
  static constexpr bool Q_OWN = KT < HT_ROWS;
  static constexpr int Q_TILE = Q_OWN ? HT_ROWS * D::K_LD : 0;
  static constexpr int P_LD = KT + 8;  // the probs staging's rows, floats
  static constexpr int PSTAGE = HT_WARPS * 16 * P_LD;
  static constexpr size_t SMEM = (2 * STAGE + Q_TILE + PSTAGE) * sizeof(float);
  static_assert(D::DT % PV_PARTS == 0, "PV parts split o's columns evenly");
  static_assert(P_LD % 32 == 8 || P_LD % 32 == 24, "staging writes conflict-free");
};

struct HwArgs {
  const float* qkv;   // [B, N, 3D]
  float* o;           // [B, N, D]: the head outputs
  float* probs;       // [B, H, N, N], or null
  float* head_probs;  // [B, H, N, N] probs for the head-mean, or null
  int H, N, D, norm, fast;
  float scale;
};

// One head's attention for the block's 64 query rows; the steps as in
// headwise_attn_block_mma.cu. KB: ToMe's key bias, as in attn_block_mma.cuh.
template <int DH, int WALKS, bool KB = false, typename A = HwArgs>
__device__ __forceinline__ void attend_head(const A& a, float* smem, int q0, int h, int b) {
  using C = HwTf32Cfg<DH>;
  constexpr int KS = C::D::KS, DT = C::D::DT, K_LD = C::D::K_LD, V_LD = C::D::V_LD;
  constexpr int KT = C::KT, NT = C::NT, STAGE = C::STAGE, P_LD = C::P_LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, D = a.D, n_tiles = (N + KT - 1) / KT, steps = WALKS * n_tiles;
  const long long ld3 = 3LL * D;
  const float* qb = a.qkv + (long long)b * N * ld3 + h * DH;
  const float* kb = qb + D;
  const float* vb = qb + 2 * D;
  // with the key bias the scores come scaled and biased out of the product
  const float scale = KB ? 1.f : a.scale;
  float* pstage = smem + 2 * STAGE + C::Q_TILE;

  // Q, tile 0 into stage 0
  float* qs = smem + (C::Q_OWN ? 2 * STAGE : STAGE);
  load_rows_f32<DH>(qs, K_LD, qb, ld3, q0, HT_ROWS, N, HT_THREADS);
  load_rows_f32<DH>(smem, K_LD, kb, ld3, 0, KT, N, HT_THREADS);
  if (WALKS == 1) load_rows_f32<DH>(smem + KT * K_LD, V_LD, vb, ld3, 0, KT, N, HT_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* qw = qs + 16 * warp * K_LD;  // the warp's 16 rows of Q
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) load_a_rows<DH>(qh[kc], ql[kc], qw, kc, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) zero4(oacc[n]);
  // rows g and g + 8 of the warp's 16: the lane's share of each row sum;
  // the exact form's running max (every lane of a quad holds the same)
  float l_part[2] = {0.f, 0.f}, m_run[2] = {-INFINITY, -INFINITY}, r[2] = {0.f, 0.f};
  float* pst = pstage + warp * 16 * P_LD;
  const int row0 = q0 + 16 * warp;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * KT;
      float* nxt = smem + (nx & 1) * STAGE;
      load_rows_f32<DH>(nxt, K_LD, kb, ld3, j1, KT, N, HT_THREADS);
      if (nx >= (WALKS - 1) * n_tiles)
        load_rows_f32<DH>(nxt + KT * K_LD, V_LD, vb, ld3, j1, KT, N, HT_THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this step's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass1 = WALKS == 2 && it < n_tiles;
    const int j0 = (it % n_tiles) * KT;
    const float* Ks = smem + (it & 1) * STAGE;
    const float* Vs = Ks + KT * K_LD;

    // S = Q K^T: key tile n holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
    float s[NT][4];
    mma3_rows<DH, NT>(s, qh, ql, Ks, lane);
    if constexpr (KB) add_key_bias<NT>(s, a.kb + (long long)b * N, a.scale, j0, N, t);

    if (pass1) {
      if (a.fast) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * n + 2 * t + (e & 1) < N)
              l_part[e >> 1] =
                  __fadd_rn(l_part[e >> 1], expf(fminf(__fmul_rn(s[n][e], scale), 80.f)));
      } else {
        // the online update of (m, l): m the exact row max
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = j0 + 8 * n + 2 * t + (e & 1) < N ? __fmul_rn(s[n][e], scale) : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_next = fmaxf(m_run[i], quad_max(mx[i]));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            sum[i] = __fadd_rn(sum[i], expf(__fsub_rn(s[n][2 * i], m_next)));
            sum[i] = __fadd_rn(sum[i], expf(__fsub_rn(s[n][2 * i + 1], m_next)));
          }
          l_part[i] = __fadd_rn(__fmul_rn(expf(__fsub_rn(m_run[i], m_next)), l_part[i]), sum[i]);
          m_run[i] = m_next;
        }
      }
      if (it == n_tiles - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) r[i] = __fdiv_rn(1.f, quad_sum(l_part[i]));
      }
    } else {
      // p (maps off) or the probs (maps on) in the score registers
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = __fmul_rn(s[n][e], scale);
          float p = a.fast ? expf(fminf(sv, 80.f)) : expf(__fsub_rn(sv, m_run[e >> 1]));
          if (j0 + 8 * n + 2 * t + (e & 1) >= N) p = 0.f;
          if (WALKS == 1) l_part[e >> 1] = __fadd_rn(l_part[e >> 1], p);
          s[n][e] = a.norm ? __fmul_rn(p, r[e >> 1]) : p;
        }
      if (a.norm) {
        // the probs through the warp's staging rows, then row by row to the
        // tap and the head-mean's input
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<float2*>(pst + g * P_LD + 8 * n + 2 * t) = make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(pst + (g + 8) * P_LD + 8 * n + 2 * t) =
              make_float2(s[n][2], s[n][3]);
        }
        __syncwarp();
        for (int i = 0; i < 16 && row0 + i < N; ++i) {
          const long long prow = ((long long)(b * a.H + h) * N + row0 + i) * N + j0;
          for (int c = lane; c < KT && j0 + c < N; c += 32) {
            const float v = pst[i * P_LD + c];
            if (a.probs != nullptr) a.probs[prow + c] = v;
            if (a.head_probs != nullptr) a.head_probs[prow + c] = v;
          }
        }
        __syncwarp();
      }
      // o += p V (or probs V), in parts of o's columns: key tile n is the
      // 8-deep step, its accumulators the A fragment
#pragma unroll
      for (int part = 0; part < C::PV_PARTS; ++part) {
        constexpr int HT = DT / C::PV_PARTS;
        float big[HT][4], small[HT][4];
#pragma unroll
        for (int d = 0; d < HT; ++d) {
          zero4(big[d]);
          zero4(small[d]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t ph[4], pl[4];
          split_acc(ph, pl, s[n]);
          const float* vr = Vs + (8 * n + 2 * t) * V_LD + 8 * HT * part + g;
#pragma unroll
          for (int d = 0; d < HT; ++d)
            mma_3xtf32(big[d], small[d], ph, pl, vr[8 * d], vr[V_LD + 8 * d]);
        }
#pragma unroll
        for (int d = 0; d < HT; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[HT * part + d][e] = __fadd_rn(oacc[HT * part + d][e], fold_rn(big[d][e], small[d][e]));
      }
    }
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

  if (WALKS == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) r[i] = __fdiv_rn(1.f, quad_sum(l_part[i]));
  }
  float* ob = a.o + (long long)b * N * D + h * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= N) continue;
    float* orow = ob + (long long)row * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      float2 v = make_float2(oacc[dn][2 * i], oacc[dn][2 * i + 1]);
      if (!a.norm) v = make_float2(__fmul_rn(v.x, r[i]), __fmul_rn(v.y, r[i]));
      *reinterpret_cast<float2*>(orow + 8 * dn) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel A: qkv[M, 3D] = in @ qkv_w + qkv_b on split TF32 from a ready
// panel of rows in [M, D] (row 1: LN1's output; row 5,
// fused_window_attn_tf32.cu: the map's NHWC rows), all f32; D a multiple of
// 16, ragged edges zero-filled. A tile of 32 rows x 64 of the 3D columns a
// block of 4 warps (16 x 32 each). The block copies its 32 rows into an f32
// panel [32][D + 8] in shared memory with the first weight tiles; the
// weight k-tiles [32][64] (rows of 68 floats, as the projection's) stream
// through a three-stage cp.async ring; the hi products and the correction
// terms sum apart over a k-tile and fold with round-to-nearest adds; the
// epilogue adds qkv_b. Rows of D + 8 floats (8 or 24 mod 32) keep the
// panel's 8-byte fragment loads conflict-free.
constexpr int QT_BM = 32, QT_BN = 64, QT_BK = 32, QT_THREADS = 128, QT_STAGES = 3;
constexpr int QT_W_LD = QT_BN + 4;  // weight rows, read as columns: 2 x 68 = 8 (mod 32)
constexpr int QT_W_TILE = QT_BK * QT_W_LD;

__host__ __device__ inline size_t qkv_tf32_smem_bytes(int d) {
  return (size_t)QT_BM * (d + 8) * 4 + (size_t)QT_STAGES * QT_W_TILE * 4;
}

__device__ __forceinline__ void qkv_load_w(float* wt, const float* w, int col0, int kt, int K,
                                           int Nc) {
  const int k0 = kt * QT_BK;
  for (int c = threadIdx.x; c < QT_BK * (QT_BN / 4); c += QT_THREADS) {
    const int i = c / (QT_BN / 4), part = c % (QT_BN / 4);
    const int kr = k0 + i, col = col0 + part * 4;
    const bool in = kr < K && col < Nc;
    cp_async16(smem_addr(wt + i * QT_W_LD + part * 4), w + (in ? (long long)kr * Nc + col : 0),
               in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(QT_THREADS)
    row1_qkv_tf32_kernel(const float* __restrict__ ln, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ qkv, int M, int D) {
  extern __shared__ float4 qt_smem4[];
  float* panel = reinterpret_cast<float*>(qt_smem4);
  const int lda = D + 8, Nc = 3 * D;
  float* ring = panel + QT_BM * lda;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * QT_BM, col0 = blockIdx.x * QT_BN;
  const int wm = 16 * (warp & 1), wn = 32 * (warp >> 1);  // the warp's 16 x 32
  const int k_tiles = (D + QT_BK - 1) / QT_BK;

  // the panel (the block's rows of LN(x), rows past M zero-filled) in the
  // first group, with the first weight tile
  for (int c = tid; c < QT_BM * (D / 4); c += QT_THREADS) {
    const int i = c / (D / 4), part = c % (D / 4);
    const bool in = row0 + i < M;
    cp_async16(smem_addr(panel + i * lda + part * 4),
               ln + (in ? (long long)(row0 + i) * D + part * 4 : 0), in ? 16 : 0);
  }
#pragma unroll
  for (int s = 0; s < QT_STAGES - 1; ++s) {
    if (s < k_tiles) qkv_load_w(ring + s * QT_W_TILE, w, col0, s, D, Nc);
    cp_async_commit();
  }

  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) zero4(acc[ni]);

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<QT_STAGES - 2>();
    __syncthreads();  // tile kt (and the panel) landed for all; slot (kt - 1) % 3 is free
    const int nx = kt + QT_STAGES - 1;
    if (nx < k_tiles) qkv_load_w(ring + (nx % QT_STAGES) * QT_W_TILE, w, col0, nx, D, Nc);
    cp_async_commit();
    const float* wt = ring + (kt % QT_STAGES) * QT_W_TILE;
    const int k0 = kt * QT_BK;
    float big[4][4], small[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      zero4(big[ni]);
      zero4(small[ni]);
    }
#pragma unroll
    for (int kc = 0; kc < QT_BK / 8; ++kc) {
      if (k0 + 8 * kc >= D) break;  // D is a multiple of 16
      // A: rows g, g + 8, columns 8 kc + 2t, + 1 (k = t, t + 4)
      uint32_t ah[4], al[4];
      const float* p = panel + (wm + g) * lda + k0 + 8 * kc + 2 * t;
      const float2 top = *reinterpret_cast<const float2*>(p);
      const float2 bot = *reinterpret_cast<const float2*>(p + 8 * lda);
      split(top.x, ah[0], al[0]);
      split(bot.x, ah[1], al[1]);
      split(top.y, ah[2], al[2]);
      split(bot.y, ah[3], al[3]);
      // B: weight rows 8 kc + 2t, + 1 at column g of each 8
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* wr = wt + (8 * kc + 2 * t) * QT_W_LD + wn + 8 * ni + g;
        mma_3xtf32(big[ni], small[ni], ah, al, wr[0], wr[QT_W_LD]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = __fadd_rn(acc[ni][e], fold_rn(big[ni][e], small[ni][e]));
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + wm + g + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = col0 + wn + 8 * ni + 2 * t;
      if (col >= Nc) continue;
      const float2 bv = *reinterpret_cast<const float2*>(bias + col);
      *reinterpret_cast<float2*>(qkv + (long long)row * Nc + col) =
          make_float2(__fadd_rn(acc[ni][2 * half], bv.x), __fadd_rn(acc[ni][2 * half + 1], bv.y));
    }
  }
}

// Kernel A on in [M, D]
inline cudaError_t launch_qkv_tf32(const float* in, const float* w, const float* bias,
                                   float* qkv, int M, int D, cudaStream_t stream) {
  const size_t smem = qkv_tf32_smem_bytes(D);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(row1_qkv_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((3 * D + QT_BN - 1) / QT_BN, (M + QT_BM - 1) / QT_BM);
  row1_qkv_tf32_kernel<<<grid, QT_THREADS, smem, stream>>>(in, w, bias, qkv, M, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel C: y[M, Nc] = (x + o @ w) + bias, o [M, K], w [K, Nc] row-major,
// all f32, on split TF32; K and Nc multiples of 4 (rows of whole 16-byte
// chunks), ragged edges zero-filled. RES = false (row 5's projection): y =
// o @ w + bias, x unread (null).
constexpr int PT_BM = 64, PT_BN = 64, PT_BK = 32, PT_THREADS = 128;
constexpr int PT_A_LD = PT_BK + 8;  // o rows, read as 8-byte pairs: 40 = 8 (mod 32)
constexpr int PT_W_LD = PT_BN + 4;  // proj_w rows, read as columns: 2 x 68 = 8 (mod 32)
constexpr int PT_A_TILE = PT_BM * PT_A_LD, PT_W_TILE = PT_BK * PT_W_LD;
constexpr int PT_STAGE = PT_A_TILE + PT_W_TILE;
static_assert(PT_A_TILE % 4 == 0 && PT_STAGE % 4 == 0, "tiles 16-byte aligned");

// k-tile kt of the o rows row0.. and the w columns col0.. into a stage
__device__ __forceinline__ void proj_load(float* at, const float* o, const float* w, int row0,
                                          int col0, int kt, int M, int K, int Nc) {
  float* wt = at + PT_A_TILE;
  const int k0 = kt * PT_BK;
  for (int c = threadIdx.x; c < PT_BM * (PT_BK / 4); c += PT_THREADS) {
    const int i = c / (PT_BK / 4), part = c % (PT_BK / 4);
    const int row = row0 + i, k = k0 + part * 4;
    const bool in = row < M && k < K;
    cp_async16(smem_addr(at + i * PT_A_LD + part * 4), o + (in ? (long long)row * K + k : 0),
               in ? 16 : 0);
  }
  for (int c = threadIdx.x; c < PT_BK * (PT_BN / 4); c += PT_THREADS) {
    const int i = c / (PT_BN / 4), part = c % (PT_BN / 4);
    const int kr = k0 + i, col = col0 + part * 4;
    const bool in = kr < K && col < Nc;
    cp_async16(smem_addr(wt + i * PT_W_LD + part * 4), w + (in ? (long long)kr * Nc + col : 0),
               in ? 16 : 0);
  }
}

template <bool RES = true>
__global__ void __launch_bounds__(PT_THREADS)
    proj_tf32_kernel(const float* __restrict__ o, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ x,
                     float* __restrict__ y, int M, int K, int Nc) {
  __shared__ __align__(16) float sm[2 * PT_STAGE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * PT_BM, col0 = blockIdx.x * PT_BN;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);  // the warp's 32 x 32
  const int k_tiles = (K + PT_BK - 1) / PT_BK;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) zero4(acc[mi][ni]);

  proj_load(sm, o, w, row0, col0, 0, M, K, Nc);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      proj_load(sm + ((kt + 1) & 1) * PT_STAGE, o, w, row0, col0, kt + 1, M, K, Nc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* at = sm + (kt & 1) * PT_STAGE;
    const float* wt = at + PT_A_TILE;
    float big[2][4][4], small[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        zero4(big[mi][ni]);
        zero4(small[mi][ni]);
      }
#pragma unroll
    for (int kc = 0; kc < PT_BK / 8; ++kc) {
      // A: rows g, g + 8 of each 16, columns 8 kc + 2t, + 1 (k = t, t + 4)
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = at + (wm + 16 * mi + g) * PT_A_LD + 8 * kc + 2 * t;
        const float2 top = *reinterpret_cast<const float2*>(p);
        const float2 bot = *reinterpret_cast<const float2*>(p + 8 * PT_A_LD);
        split(top.x, ah[mi][0], al[mi][0]);
        split(bot.x, ah[mi][1], al[mi][1]);
        split(top.y, ah[mi][2], al[mi][2]);
        split(bot.y, ah[mi][3], al[mi][3]);
      }
      // B: proj_w rows 8 kc + 2t, + 1 at column g of each 8
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* wr = wt + (8 * kc + 2 * t) * PT_W_LD + wn + 8 * ni + g;
        uint32_t bh0, bl0, bh1, bl1;
        split(wr[0], bh0, bl0);
        split(wr[PT_W_LD], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(small[mi][ni], al[mi], bh0, bh1);
          mma_tf32(small[mi][ni], ah[mi], bl0, bl1);
          mma_tf32(big[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], fold_rn(big[mi][ni][e], small[mi][ni][e]));
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm + 16 * mi + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = col0 + wn + 8 * ni + 2 * t;
        if (col >= Nc) continue;
        const long long idx = (long long)row * Nc + col;
        if constexpr (RES) {
          const float2 xv = *reinterpret_cast<const float2*>(x + idx);
          const float2 bv = *reinterpret_cast<const float2*>(bias + col);
          *reinterpret_cast<float2*>(y + idx) =
              make_float2(__fadd_rn(__fadd_rn(xv.x, acc[mi][ni][2 * half]), bv.x),
                          __fadd_rn(__fadd_rn(xv.y, acc[mi][ni][2 * half + 1]), bv.y));
        } else {
          const float2 bv = *reinterpret_cast<const float2*>(bias + col);
          *reinterpret_cast<float2*>(y + idx) = make_float2(
              __fadd_rn(acc[mi][ni][2 * half], bv.x), __fadd_rn(acc[mi][ni][2 * half + 1], bv.y));
        }
      }
    }
}

}  // namespace
