// The bf16 tensor-core pieces of the attention blocks (rows 1 and 2) and
// of the window attention (row 5), shared by headwise_attn_block_mma.cu
// (row 2, the headwise block), fused_attn_block_mma.cu (row 1, the
// whole-image block) and fused_window_attn_mma.cu (row 5): attend_head,
// one head's attention for 64 query rows read by strides from the
// untransposed qkv [B, N, 3D]; row1_qkv_mma_kernel, the QKV product from
// a ready panel of rows (rows 1 and 5); and proj_mma_kernel, the
// projection with the residual (rows 1, 2) or without (row 5).
// headwise_attn_block_mma.cu's notes give the attention's design, the
// cast points and the measured choices (key tiles of 64, the f32 per-head
// workspace of the head-mean).
//
// Row 1's options: ToMe's key bias (attend_head's KB, which adds kb[b, j]
// to every scaled score with a rounded add before the softmax, as
// fused_attn_block.cu's FMA kernel does) and an attn_heads subset of the
// probs tap (the caller's per-head copy of the arguments: see
// fused_attn_block_mma.cu). Row 2's instantiations take neither, and their
// code is that of the source they came from.
//
// Everything lives in an anonymous namespace, as in common.cuh.

#pragma once

#include "common.cuh"
#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HM_ROWS = 64;                 // query rows of a block
constexpr int HM_WARPS = 4, HM_THREADS = 32 * HM_WARPS;
// keys of a tile (tools/kernel_variants.py)
constexpr int HM_KT = 64;

// The attention block's shape at head width DH.
template <int DH>
struct HwMmaCfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  using M = MmaDims<DH>;
  static constexpr int KT = HM_KT, NT = KT / 8;
  static constexpr int TILE = KT * M::LD;   // one K or V tile, bf16
  static constexpr int STAGE = 2 * TILE;    // K, then V
  static constexpr int P_LD = KT + 8;       // the probs staging's rows, floats
  static constexpr int PSTAGE = HM_WARPS * 16 * P_LD;
  static constexpr size_t SMEM = 2 * STAGE * sizeof(bf16) + PSTAGE * sizeof(float);
  static_assert(HM_ROWS <= KT, "Q goes through a K slot");
  static_assert(P_LD % 32 == 8 || P_LD % 32 == 24, "staging writes conflict-free");
  static_assert(2 * STAGE * sizeof(bf16) % 16 == 0, "staging 16-byte aligned");
};

struct HwArgs {
  const bf16* qkv;    // [B, N, 3D]
  bf16* o;            // [B, N, D]: the head outputs
  bf16* probs;        // [B, H, N, N], or null
  float* head_probs;  // [B, H, N, N] f32 probs for the head-mean, or null
  int H, N, D, norm, fast;
  float scale;
};

// One head's attention for the block's 64 query rows. Steps 0 .. T-1 are
// pass 1 when WALKS is 2 (K tiles: the row sums, and the exact form's
// max), then T steps of K and V tiles: p, the tap and PV. One ring across
// all steps. KB: ToMe's key bias, a.kb [B, N] f32 (an args type A that
// has it), added to each scaled score with a rounded add before the
// softmax (add_key_bias); the row-2 instantiations have none.
template <int DH, int WALKS, bool KB = false, typename A = HwArgs>
__device__ __forceinline__ void attend_head(const A& a, bf16* ring, float* pstage, int q0,
                                            int h, int b) {
  using C = HwMmaCfg<DH>;
  constexpr int KT = C::KT, NT = C::NT, P_LD = C::P_LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, D = a.D, n_tiles = (N + KT - 1) / KT, steps = WALKS * n_tiles;
  const long long ld3 = 3LL * D;
  const bf16* qb = a.qkv + (long long)b * N * ld3 + h * DH;
  const bf16* kb = qb + D;
  const bf16* vb = qb + 2 * D;
  // with the key bias the scores come scaled and biased out of the product
  const float scale = KB ? 1.f : a.scale;

  // Q through stage 1's K slot, tile 0 into stage 0
  load_tile_async<DH>(ring + C::STAGE, qb, ld3, q0, HM_ROWS, N, HM_THREADS);
  load_tile_async<DH>(ring, kb, ld3, 0, KT, N, HM_THREADS);
  if (WALKS == 1) load_tile_async<DH>(ring + C::TILE, vb, ld3, 0, KT, N, HM_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  load_a_frags<DH>(qf, ring + C::STAGE, 16 * warp, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: the lane's share of each row sum;
  // the exact form's running max (every lane of a quad holds the same)
  float l_part[2] = {0.f, 0.f}, m_run[2] = {-INFINITY, -INFINITY}, r[2] = {0.f, 0.f};
  float* pst = pstage + warp * 16 * P_LD;
  const int row0 = q0 + 16 * warp;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * KT;
      bf16* nxt = ring + (nx & 1) * C::STAGE;
      load_tile_async<DH>(nxt, kb, ld3, j1, KT, N, HM_THREADS);
      if (nx >= (WALKS - 1) * n_tiles)
        load_tile_async<DH>(nxt + C::TILE, vb, ld3, j1, KT, N, HM_THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this step's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass1 = WALKS == 2 && it < n_tiles;
    const int j0 = (it % n_tiles) * KT;
    const bf16* Ks = ring + (it & 1) * C::STAGE;
    float s[NT][4];
    mma_rows<NT, DH>(s, qf, Ks, lane);
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
        // the f32 probs through the warp's staging rows, then row by row:
        // the bf16 tap (the same cast as PV's operand) and the f32 input of
        // the head-mean
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
            if (a.probs != nullptr) a.probs[prow + c] = __float2bfloat16(v);
            if (a.head_probs != nullptr) a.head_probs[prow + c] = v;
          }
        }
        __syncwarp();
      }
      const bf16* Vs = ring + (it & 1) * C::STAGE + C::TILE;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t pa[4];
        a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
        mma_a_by_cols<DH>(oacc, pa, Vs, 16 * kk, lane);
      }
    }
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

  if (WALKS == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) r[i] = __fdiv_rn(1.f, quad_sum(l_part[i]));
  }
  if (!a.norm) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = __fmul_rn(oacc[n][e], r[e >> 1]);
  }
  store_rows<DH>(a.o + ((long long)b * N + q0) * D + h * DH, D, oacc, 16 * warp, N - q0, lane);
}

// ---------------------------------------------------------------------------
// Kernel A: qkv[M, 3D] = in @ qkv_w + qkv_b from a ready panel of rows in
// [M, D] (row 1: LN1's output; row 5, fused_window_attn_mma.cu: the map's
// NHWC rows), all bf16, f32 sums plus the f32 bias, cast; D a multiple of
// 16, ragged edges zero-filled. A tile of BM rows x 64 of the 3D columns a
// block of 4 warps: the block copies its BM rows into a bf16 panel [BM][D +
// 8] in shared memory with the first weight tiles; the weight k-tiles
// [64][64] then stream through a three-stage cp.async ring, and mma.sync
// m16n8k16 (ldmatrix for the panel, ldmatrix .trans for qkv_w's [k][n]
// rows) sums in f32. fused_attn_block_mma.cu's notes give the measured
// choice of BM.
constexpr int QK_BN = 64, QK_BK = 64, QK_THREADS = 128, QK_STAGES = 3;
constexpr int QK_W_LD = QK_BN + 8;  // weight tile rows, bf16: 144 bytes, ldmatrix conflict-free
constexpr int QK_W_TILE = QK_BK * QK_W_LD;
// rows up to which a block takes 32 rows, not 64 (tools/kernel_variants.py)
constexpr int QKV_SMALL_M = 512;

__host__ __device__ inline int qkv_rows(int m) { return m <= QKV_SMALL_M ? 32 : 64; }

// The panel [BM][D + 8] bf16 (rows of D / 8 + 1 16-byte units: odd for D a
// multiple of 16, so ldmatrix reads conflict-free) and the weight ring.
__host__ __device__ inline size_t qkv_smem_bytes(int d, int bm) {
  return (size_t)bm * (d + 8) * 2 + (size_t)QK_STAGES * QK_W_TILE * 2;
}

// k-tile kt of qkv_w's columns col0.. into a ring slot; rows past K and
// columns past Nc zero-filled
__device__ __forceinline__ void qkv_load_w(bf16* wt, const bf16* w, int col0, int kt, int K,
                                           int Nc) {
  const int k0 = kt * QK_BK;
  for (int c = threadIdx.x; c < QK_BK * (QK_BN / 8); c += QK_THREADS) {
    const int i = c >> 3, part = c & 7;
    const int kr = k0 + i, col = col0 + part * 8;
    const bool in = kr < K && col < Nc;
    cp_async16(smem_addr(wt + i * QK_W_LD + part * 8), w + (in ? (long long)kr * Nc + col : 0),
               in ? 16 : 0);
  }
}

template <int BM>
__global__ void __launch_bounds__(QK_THREADS)
    row1_qkv_mma_kernel(const bf16* __restrict__ ln, const bf16* __restrict__ w,
                        const bf16* __restrict__ bias, bf16* __restrict__ qkv, int M, int D) {
  constexpr int MT = BM / 32;  // a warp's 16-row tiles
  extern __shared__ float4 qk_smem4[];
  bf16* panel = reinterpret_cast<bf16*>(qk_smem4);
  const int lda = D + 8, Nc = 3 * D;
  bf16* ring = panel + BM * lda;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * QK_BN;
  const int wm = (BM / 2) * (warp & 1), wn = 32 * (warp >> 1);  // the warp's BM / 2 x 32
  const int k_tiles = (D + QK_BK - 1) / QK_BK;

  // the panel from LN1's pass (rows past M zero-filled), in the first group
  // with the first weight tile
  for (int c = tid; c < BM * (D / 8); c += QK_THREADS) {
    const int i = c / (D / 8), part = c % (D / 8);
    const bool in = row0 + i < M;
    cp_async16(smem_addr(panel + i * lda + part * 8),
               ln + (in ? (long long)(row0 + i) * D + part * 8 : 0), in ? 16 : 0);
  }
#pragma unroll
  for (int s = 0; s < QK_STAGES - 1; ++s) {
    if (s < k_tiles) qkv_load_w(ring + s * QK_W_TILE, w, col0, s, D, Nc);
    cp_async_commit();
  }

  float acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<QK_STAGES - 2>();
    __syncthreads();  // tile kt (and the panel) landed for all; slot (kt - 1) % 3 is free
    const int nx = kt + QK_STAGES - 1;
    if (nx < k_tiles) qkv_load_w(ring + (nx % QK_STAGES) * QK_W_TILE, w, col0, nx, D, Nc);
    cp_async_commit();
    const bf16* wt = ring + (kt % QK_STAGES) * QK_W_TILE;
    const int k0 = kt * QK_BK;
#pragma unroll
    for (int kk = 0; kk < QK_BK / 16; ++kk) {
      if (k0 + 16 * kk >= D) break;  // D is a multiple of 16
      uint32_t af[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldmatrix_x4(af[mi], smem_addr(panel + (wm + 16 * mi + (lane & 15)) * lda + k0 + kk * 16 +
                                      (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QK_W_LD +
                                         wn + 16 * np + (lane >> 4) * 8));
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm + 16 * mi + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = col0 + wn + 8 * ni + 2 * t;
        if (col >= Nc) continue;
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        *reinterpret_cast<__nv_bfloat162*>(qkv + (long long)row * Nc + col) = __floats2bfloat162_rn(
            __fadd_rn(acc[mi][ni][2 * half], __low2float(bv)),
            __fadd_rn(acc[mi][ni][2 * half + 1], __high2float(bv)));
      }
    }
}

template <int BM>
cudaError_t launch_qkv_bm(const bf16* ln, const bf16* w, const bf16* bias, bf16* qkv, int M,
                          int D, cudaStream_t stream) {
  const size_t smem = qkv_smem_bytes(D, BM);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(row1_qkv_mma_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((3 * D + QK_BN - 1) / QK_BN, (M + BM - 1) / BM);
  row1_qkv_mma_kernel<BM><<<grid, QK_THREADS, smem, stream>>>(ln, w, bias, qkv, M, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel C: y[M, Nc] = (x + o @ w) + bias, o [M, K], w [K, Nc] row-major,
// all bf16, f32 accumulators; K and Nc multiples of 8 (rows of whole
// 16-byte chunks), ragged edges zero-filled. RES = false (row 5's
// projection): y = o @ w + bias, x unread (null).
constexpr int PG_BM = 64, PG_BN = 64, PG_BK = 64, PG_THREADS = 128;
constexpr int PG_LD = 64 + 8;  // both tiles' rows, bf16: 144 bytes, ldmatrix conflict-free
constexpr int PG_TILE = 64 * PG_LD;
constexpr int PG_STAGE = 2 * PG_TILE;  // the o tile [BM][BK], then the w tile [BK][BN]

// k-tile kt of the o rows row0.. and the w columns col0.. into a stage
__device__ __forceinline__ void proj_load(bf16* at, const bf16* o, const bf16* w, int row0,
                                          int col0, int kt, int M, int K, int Nc) {
  bf16* wt = at + PG_TILE;
  const int k0 = kt * PG_BK;
  for (int c = threadIdx.x; c < 64 * 8; c += PG_THREADS) {
    const int i = c >> 3, part = c & 7;
    const int row = row0 + i, k = k0 + part * 8;
    const bool in = row < M && k < K;
    cp_async16(smem_addr(at + i * PG_LD + part * 8), o + (in ? (long long)row * K + k : 0),
               in ? 16 : 0);
    const int kr = k0 + i, col = col0 + part * 8;
    const bool win = kr < K && col < Nc;
    cp_async16(smem_addr(wt + i * PG_LD + part * 8), w + (win ? (long long)kr * Nc + col : 0),
               win ? 16 : 0);
  }
}

template <bool RES = true>
__global__ void __launch_bounds__(PG_THREADS)
    proj_mma_kernel(const bf16* __restrict__ o, const bf16* __restrict__ w,
                    const bf16* __restrict__ bias, const bf16* __restrict__ x, bf16* __restrict__ y,
                    int M, int K, int Nc) {
  __shared__ __align__(16) bf16 sm[2 * PG_STAGE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * PG_BM, col0 = blockIdx.x * PG_BN;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);  // the warp's 32 x 32
  const int k_tiles = (K + PG_BK - 1) / PG_BK;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  proj_load(sm, o, w, row0, col0, 0, M, K, Nc);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      proj_load(sm + ((kt + 1) & 1) * PG_STAGE, o, w, row0, col0, kt + 1, M, K, Nc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* at = sm + (kt & 1) * PG_STAGE;
    const bf16* wt = at + PG_TILE;
#pragma unroll
    for (int kk = 0; kk < PG_BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], smem_addr(at + (wm + 16 * mi + (lane & 15)) * PG_LD + kk * 16 +
                                      (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PG_LD +
                                         wn + 16 * np + (lane >> 4) * 8));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
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
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        float v0, v1;
        if constexpr (RES) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + idx);
          v0 = __fadd_rn(__fadd_rn(__low2float(xv), acc[mi][ni][2 * half]), __low2float(bv));
          v1 = __fadd_rn(__fadd_rn(__high2float(xv), acc[mi][ni][2 * half + 1]),
                         __high2float(bv));
        } else {
          v0 = __fadd_rn(acc[mi][ni][2 * half], __low2float(bv));
          v1 = __fadd_rn(acc[mi][ni][2 * half + 1], __high2float(bv));
        }
        *reinterpret_cast<__nv_bfloat162*>(y + idx) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

}  // namespace
