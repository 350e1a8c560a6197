// Headwise attention block on Hopper's tensor cores, bf16, heads 64 or 80
// wide (one instantiation each): from the untransposed qkv [B, N, 3D]
// (LN1 + QKV are computed before, by the caller),
//     y = x + proj(concat_h softmax(q_h k_h^T / sqrt(dh)) v_h),
// with optional per-head probs [B, H, N, N] and head-mean [B, N, N].
//
// Replaces, for bf16, the Pallas TPU kernel interactive_vit_tpu/ops/
// fused_block.py::headwise_attn_block (_headwise_kernel, _row_softmax);
// other operands stay on headwise_attn_block.cu (f32 FMA). The cast points
// are that kernel's:
//   s     = (q . k) * dh^-0.5 in f32 (bf16 products, f32 sums);
//   fast  p = exp(min(s, 80)), no max subtracted; exact p = exp(s - rowmax);
//   l     = rowsum(p) in f32, r = 1 / l;
//   maps and mean off: o = (bf16(p) v) * r, the product summed in f32;
//   maps or mean on:   probs = p * r in f32, cast once to bf16: that cast is
//                      the tap and the A operand of PV, o = bf16(probs) v;
//   the head-mean sums the f32 probs over the heads in head order, times
//   1 / H, then casts; head outputs are cast to bf16;
//   y = (x + o proj_w) + proj_b in f32, the product summed in f32, cast.
// The exponent is expf; the scale, the reciprocal, the products by r and
// the sums of p are explicitly rounded operations (no contraction). Only
// the order of the f32 sums differs from the plain version (the tensor
// cores' order over dh and over the keys of a tile), which the bf16
// bounds absorb. Keys and query rows past N come in as zero-filled rows
// of the shared tiles; the keys get p = 0 and the rows are never stored.
//
// Kernel A, the attention of one head (FlashAttention-2's mma.sync layout,
// mma_attention.cuh): one block of 4 warps per (64 query rows, head,
// image), each warp owning 16 query rows whose Q fragments stay in
// registers. q, k and v are read by strides straight from qkv (q at column
// h dh, k at D + h dh, v at 2D + h dh, token stride 3D). Key tiles stream
// through a two-stage cp.async ring; only a tile of keys sits in shared
// memory, never the N scores of a row. The fast softmax has no running max
// and so nothing to rescale: with maps and mean off the block walks the
// keys once, summing p and bf16(p) v. With maps or mean on (or the exact
// softmax) it walks them twice: the row sums (and the exact form's max, by
// the online update) first, then the probs, the tap and PV. The score
// accumulators are the A operand of PV as they stand, packed to bf16. The
// probs go to the tap (and, f32, to the head-mean workspace) through the
// warp's staging rows in shared memory, each row written as contiguous
// runs (the tap's row stride, N * 2 bytes, is off the 16-byte grid).
// Kernel D, the head-mean pass (common.cuh), reads the f32 per-head
// workspace in head order. The other design, one block per query tile
// walking the heads in order and summing the mean in f32 in place
// (tools/kernel_variants.py), leaves 10 blocks for 132 SMs at
// vit_l16@384, B=1: it
// took 2.1431 ms against 0.1063 with maps + mean there, 14.9110 against
// 1.2252 at vit_h14@742 (tools/kernel_variants.py, NVIDIA H100 80GB HBM3,
// 700.00 W).
// Key tiles of 64: tiles of 128 took 0.0929 against 0.1063 ms at
// vit_l16@384 with maps + mean but 0.0445 against 0.0415 with maps off
// (the served blocks' common case) and 0.7189 against 0.3666 at
// vit_h14@742 (162-167 registers).
// Kernel C, the projection with the residual: a 64 x 64 tile a block of 4
// warps (32 x 32 each), k-tiles of 64 through a two-stage cp.async ring,
// mma.sync m16n8k16 with f32 accumulators, ldmatrix (transposed for
// proj_w's [k][n] rows), (x + acc) + b in f32 in the epilogue.
//
// What bounds it on this card: at vit_l16@384 (N = 577, 16 heads 64 wide,
// B = 1) with maps and mean the work after QKV is 2.57 GFLOP (attention
// 1.36, projection 1.21) over 19.33 MB (the 10.6 MB probs tap dominates):
// bound by bytes, 0.00577 ms at 3.35 TB/s (0.0026 ms at 989 TFLOP/s). The
// f32 per-head workspace of the mean adds 21 MB written and read. With
// maps off the attention is bound by operations. mma.sync reaches a
// fraction of the wgmma rate, and every score costs an expf on the FMA
// pipes.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

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
// all steps.
template <int DH, int WALKS>
__device__ __forceinline__ void attend_head(const HwArgs& a, bf16* ring, float* pstage, int q0,
                                            int h, int b) {
  using C = HwMmaCfg<DH>;
  constexpr int KT = C::KT, NT = C::NT, P_LD = C::P_LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int N = a.N, D = a.D, n_tiles = (N + KT - 1) / KT, steps = WALKS * n_tiles;
  const long long ld3 = 3LL * D;
  const bf16* qb = a.qkv + (long long)b * N * ld3 + h * DH;
  const bf16* kb = qb + D;
  const bf16* vb = qb + 2 * D;

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

    if (pass1) {
      if (a.fast) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * n + 2 * t + (e & 1) < N)
              l_part[e >> 1] =
                  __fadd_rn(l_part[e >> 1], expf(fminf(__fmul_rn(s[n][e], a.scale), 80.f)));
      } else {
        // the online update of (m, l): m the exact row max
        float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = j0 + 8 * n + 2 * t + (e & 1) < N ? __fmul_rn(s[n][e], a.scale) : -INFINITY;
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
          const float sv = __fmul_rn(s[n][e], a.scale);
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

template <int DH, int WALKS>
__global__ void __launch_bounds__(HM_THREADS) headwise_mma_kernel(const HwArgs a) {
  extern __shared__ float4 hm_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(hm_smem4);
  float* pstage = reinterpret_cast<float*>(ring + 2 * HwMmaCfg<DH>::STAGE);
  attend_head<DH, WALKS>(a, ring, pstage, blockIdx.x * HM_ROWS, blockIdx.y, blockIdx.z);
}

template <int DH, int WALKS>
cudaError_t launch_attention(const HwArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = HwMmaCfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(headwise_mma_kernel<DH, WALKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + HM_ROWS - 1) / HM_ROWS, a.H, B);
  headwise_mma_kernel<DH, WALKS><<<grid, HM_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel C: y[M, Nc] = (x + o @ w) + bias, o [M, K], w [K, Nc] row-major,
// all bf16, f32 accumulators; K and Nc multiples of 8 (rows of whole
// 16-byte chunks), ragged edges zero-filled.
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
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + idx);
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
        const float v0 = __fadd_rn(__fadd_rn(__low2float(xv), acc[mi][ni][2 * half]), __low2float(bv));
        const float v1 = __fadd_rn(__fadd_rn(__high2float(xv), acc[mi][ni][2 * half + 1]),
                                   __high2float(bv));
        *reinterpret_cast<__nv_bfloat162*>(y + idx) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

// the head widths the kernels are built for
constexpr int HM_DHS[] = {64, 80};

template <int DH>
cudaError_t launch_dh(const HwArgs& a, int B, cudaStream_t s) {
  return (a.norm || !a.fast) ? launch_attention<DH, 2>(a, B, s) : launch_attention<DH, 1>(a, B, s);
}

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_headwise_mma_dh(int i) {
  constexpr int n = sizeof(HM_DHS) / sizeof(HM_DHS[0]);
  return i >= 0 && i < n ? HM_DHS[i] : 0;
}

// bf16 x, y [B, N, D]; qkv [B, N, 3D] with columns [3][H][dh], dh =
// D / H one of ivt_headwise_mma_dh; proj_w [D, D]; every pointer 16-byte
// aligned. Workspaces (allocated by the caller): o_ws [B, N, D] bf16,
// probs_ws [B, H, N, N] f32 (only read when mean is given). probs [B, H,
// N, N] / mean [B, N, N] may be null (taps off). Returns a cudaError_t
// value.
int ivt_headwise_attn_block_mma(const void* x, const void* qkv, const void* proj_w,
                                const void* proj_b, void* o_ws, void* probs_ws, void* y,
                                void* probs, void* mean, int B, int N, int D, int H, float scale,
                                float inv_heads, int fast, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh != 64 && dh != 80) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  HwArgs a{};
  a.qkv = static_cast<const bf16*>(qkv);
  a.o = static_cast<bf16*>(o_ws);
  a.probs = static_cast<bf16*>(probs);
  a.head_probs = mean != nullptr ? static_cast<float*>(probs_ws) : nullptr;
  a.H = H;
  a.N = N;
  a.D = D;
  a.norm = (probs != nullptr || mean != nullptr) ? 1 : 0;
  a.fast = fast ? 1 : 0;
  a.scale = scale;
  cudaError_t err = dh == 64 ? launch_dh<64>(a, B, s) : launch_dh<80>(a, B, s);
  if (err != cudaSuccess) return (int)err;
  if (mean != nullptr) {
    err = launch_head_mean<bf16>(a.head_probs, static_cast<bf16*>(mean), B, H, N, inv_heads, s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((D + PG_BN - 1) / PG_BN, (B * N + PG_BM - 1) / PG_BM);
  proj_mma_kernel<<<grid, PG_THREADS, 0, s>>>(static_cast<const bf16*>(o_ws),
                                              static_cast<const bf16*>(proj_w),
                                              static_cast<const bf16*>(proj_b),
                                              static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                              B * N, D, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
