// Fused Swin window-attention branch on Hopper's tensor cores, bf16, heads
// 32 wide, windows of at most 64 tokens: from the LayerNorm'd (and, for
// shifted blocks, already rolled) NHWC map y,
//     a = proj(concat_h softmax(q_h k_h^T * dh^-0.5 + bias_h [+ mask_w]) v_h),
// per window, with optional probs [B, nW, heads, T, T]. No LayerNorm, no
// roll, no residual: the caller (models/swin.py::block) owns them.
//
// Replaces, for bf16, the Pallas TPU kernel interactive_vit_tpu/ops/
// fused_window.py::fused_window_attn (_kernel, with fused_block.
// _row_softmax); other operands (f32: fused_window_attn_tf32.cu; off the
// 16-byte grid, other head widths, windows over 8: fused_window_attn.cu,
// FMA) keep their sources. The cast points are that kernel's: qkv summed
// in f32 plus the f32 bias, cast to bf16; scores q . k in f32, scaled
// AFTER the dot, plus the f32 relative-position bias, plus the f32 seam
// mask (0 / -100) of shifted blocks, each a rounded operation of its own
// (no fma contraction); fast softmax exp(min(s, 80)) with the
// normalisation deferred, or the exact max-subtracted form; maps on:
// probs = p * (1 / rowsum) cast to bf16 are the tap and PV's operand; maps
// off: the unnormalised p cast, multiplied by V in f32 and scaled by 1 /
// rowsum; head outputs cast; the projection summed in f32 plus the bias,
// cast.
//
//   Kernel A  row1_qkv_mma_kernel (attn_block_mma.cuh, row 1's)  qkv = y
//             qkv_w + qkv_b over the [B*H*W, C] NHWC rows as they stand:
//             QKV is row-local, so no window order and no padding.
//   Kernel B  window_attn_mma_kernel  one block of 4 warps per (window,
//             head, image). The window's T tokens of q, k and v for the
//             head are gathered from the NHWC qkv by cp.async into shared
//             tiles of 64 rows (token i at pixel (wy w + i / w, wx w + i %
//             w); a row of the head is 64 bytes, four 16-byte copies; rows
//             of MmaDims<32>::LD = 40 bf16, 80 bytes, five 16-byte units,
//             so ldmatrix reads are conflict-free); rows T..63 are
//             zero-filled (source size 0). Each warp takes 16 query rows:
//             S = Q K^T over 8 tiles of 8 keys and 2 steps of 16 (mma.sync
//             m16n8k16, ldmatrix), the scale, bias and mask; the softmax
//             on the registers (row max and sum by quad shuffles), keys at
//             or past T given p = 0 (a zero key scores 0, and exp(0) would
//             enter the sum); the probs tap by 2-byte stores (rows of T
//             bf16 are 98 bytes at T = 49, off the 4-byte grid); PV over 4
//             steps of 16 keys from the score registers (the
//             FlashAttention-2 register reuse), V by ldmatrix .trans; the
//             head output cast and written to its pixel's columns of the
//             o workspace [B, H, W, C]. Query rows T..63 are never stored.
//   Kernel C  proj_mma_kernel<false> (attn_block_mma.cuh)  a = o proj_w +
//             proj_b, no residual.
//
// The grid (tools/kernel_variants.py --only row5; NVIDIA H100 80GB HBM3,
// 700.00 W): one block per (window, head, image) against one per
// (window, image) taking the heads in turn (row5_mma_head_loop), kernel B's
// grid 48 against 4 blocks at swin_t stage 2, 24 against 1 at stage 3.
// The whole branch, B = 1, maps off, device time: stages 0-3 0.0201,
// 0.0200, 0.0225, 0.0279 ms by (window, head, image) against 0.0348,
// 0.0561, 0.1041, 0.1893 by (window, image): a block walking the heads
// pays each head's gather and softmax latency in turn (~7 us a head), so
// the grid by head won at every stage, B = 8 included (0.0365 against
// 0.1191 at stage 2); in f32 0.0310-0.0642 against 0.0498-0.2861. The FMA
// kernel this replaces took 0.0408, 0.0460, 0.0694, 0.1156 ms there.
//
// What bounds it on this card: at swin_t stage 2 (14 x 14, C = 384, 12
// heads, B = 1) the branch is 0.246 GFLOP over 1.60 MB (the map in and
// out, the weights, the bias): 0.00048 ms at 3.35 TB/s, 0.00025 ms at
// 989 TFLOP/s. Its time is three launches' latency and how few blocks one
// image gives the card (126 for QKV, 48 for the attention, 24 for the
// projection), not the tensor-core rate.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"
#include "mma_attention.cuh"
#include "attn_block_mma.cuh"

namespace {

constexpr int WA_DH = 32;                    // the head width
constexpr int WA_ROWS = 64;                  // a window's tokens, padded
constexpr int WA_WARPS = 4, WA_THREADS = 32 * WA_WARPS;
constexpr int WA_NT = WA_ROWS / 8;           // 8-key tiles of a score row
constexpr int WA_MAX_WIDTH = 1280;           // the widest map (channels)
using WaDims = MmaDims<WA_DH>;
constexpr int WA_TILE = WA_ROWS * WaDims::LD;  // one q, k or v tile, bf16

struct WinArgs {
  const bf16* qkv;    // [B, H, W, 3C]
  const float* bias;  // [heads, T, T]
  const float* mask;  // [nW, T, T], or null (unshifted)
  bf16* o;            // [B, H, W, C]: the head outputs
  bf16* probs;        // [B, nW, heads, T, T], or null (maps off)
  int H, W, C, heads, window, fast;
  float scale;
};

// the pixel (row of the NHWC map) of token i of window (wy, wx), image b
__device__ __forceinline__ long long win_pixel(const WinArgs& a, int b, int wy, int wx, int i) {
  return ((long long)b * a.H + wy * a.window + i / a.window) * a.W + wx * a.window +
         i % a.window;
}

// One (window, head, image) on the block's tiles [3][WA_ROWS][LD] (q, k, v).
__device__ __forceinline__ void window_head(const WinArgs& a, bf16* tiles, int win, int h,
                                            int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int T = a.window * a.window, nwx = a.W / a.window, wy = win / nwx, wx = win % nwx;
  const long long ld3 = 3LL * a.C;

  // gather q, k, v of the head: rows past T zero-filled without a read
  for (int c = threadIdx.x; c < 3 * WA_ROWS * WaDims::CHUNKS; c += WA_THREADS) {
    const int m = c / (WA_ROWS * WaDims::CHUNKS), r = c % (WA_ROWS * WaDims::CHUNKS);
    const int i = r / WaDims::CHUNKS, part = r % WaDims::CHUNKS;
    const bool in = i < T;
    const bf16* src =
        a.qkv + (in ? win_pixel(a, b, wy, wx, i) * ld3 + m * a.C + h * WA_DH + part * 8 : 0);
    cp_async16(smem_addr(tiles + m * WA_TILE + i * WaDims::LD + part * 8), src, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const bf16* Qs = tiles;
  const bf16* Ks = tiles + WA_TILE;
  const bf16* Vs = tiles + 2 * WA_TILE;

  // S = Q K^T for the warp's 16 rows: tile n holds keys 8n + 2t, + 1 of
  // rows g, g + 8
  uint32_t qf[WA_DH / 16][4];
  load_a_frags<WA_DH>(qf, Qs, 16 * warp, lane);
  float s[WA_NT][4];
  mma_rows<WA_NT, WA_DH>(s, qf, Ks, lane);

  // scale, then the bias, then the mask, each rounded on its own; the
  // exact form's row max over the real keys
  const float* bias_h = a.bias + (long long)h * T * T;
  const float* mask_w = a.mask != nullptr ? a.mask + (long long)win * T * T : nullptr;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < WA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * warp + g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
      float v = __fmul_rn(s[n][e], a.scale);
      if (j < T) {
        // (a padded query row, all zeros, scores 0: finite, never stored)
        if (i < T) {
          v = __fadd_rn(v, bias_h[i * T + j]);
          if (mask_w != nullptr) v = __fadd_rn(v, mask_w[i * T + j]);
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
      s[n][e] = v;
    }
  float m_row[2] = {0.f, 0.f};
  if (!a.fast) {
#pragma unroll
    for (int k = 0; k < 2; ++k) m_row[k] = quad_max(mx[k]);
  }

  // p, with keys at or past T at 0, and the row sums
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < WA_NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * n + 2 * t + (e & 1);
      float p = a.fast ? expf(fminf(s[n][e], 80.f)) : expf(__fsub_rn(s[n][e], m_row[e >> 1]));
      if (j >= T) p = 0.f;
      l[e >> 1] = __fadd_rn(l[e >> 1], p);
      s[n][e] = p;
    }
  float r[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) r[k] = __fdiv_rn(1.f, quad_sum(l[k]));

  if (a.probs != nullptr) {
    // probs = p / rowsum: the tap, and (cast the same way by a_from_acc)
    // PV's operand
    const int nw = gridDim.x;
    bf16* tap = a.probs + (((long long)b * nw + win) * a.heads + h) * T * T;
#pragma unroll
    for (int n = 0; n < WA_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * warp + g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        s[n][e] = __fmul_rn(s[n][e], r[e >> 1]);
        if (i < T && j < T) tap[i * T + j] = __float2bfloat16(s[n][e]);
      }
  }

  // o = P V: 4 steps of 16 keys, the score registers as A fragments
  float oacc[WA_DH / 8][4];
#pragma unroll
  for (int n = 0; n < WA_DH / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WA_NT / 2; ++kk) {
    uint32_t pa[4];
    a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
    mma_a_by_cols<WA_DH>(oacc, pa, Vs, 16 * kk, lane);
  }

  // the head output, to its pixel's columns h dh.. of o
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = 16 * warp + g + 8 * half;
    if (i >= T) continue;
    bf16* out = a.o + win_pixel(a, b, wy, wx, i) * a.C + h * WA_DH + 2 * t;
#pragma unroll
    for (int n = 0; n < WA_DH / 8; ++n) {
      float v0 = oacc[n][2 * half], v1 = oacc[n][2 * half + 1];
      if (a.probs == nullptr) {  // maps off: 1 / rowsum folded in here
        v0 = __fmul_rn(v0, r[half]);
        v1 = __fmul_rn(v1, r[half]);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// one block per (window, head, image)
__global__ void __launch_bounds__(WA_THREADS) window_attn_mma_kernel(const WinArgs a) {
  __shared__ __align__(16) bf16 tiles[3 * WA_TILE];
  window_head(a, tiles, blockIdx.x, blockIdx.y, blockIdx.z);
}

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_window_mma_dh(int i) { return i == 0 ? WA_DH : 0; }

// The most tokens a window may hold, and the widest map (channels).
int ivt_window_mma_max_tokens() { return WA_ROWS; }
int ivt_window_mma_max_width() { return WA_MAX_WIDTH; }

// Kernel A's tile rows for m rows, and its dynamic shared memory for rows
// d wide and that tile, in bytes.
int ivt_window_mma_qkv_rows(int m) { return qkv_rows(m); }
size_t ivt_window_mma_qkv_smem(int d, int bm) { return qkv_smem_bytes(d, bm); }

// bf16 y, a [B, H, W, C] contiguous, C = heads * 32 a multiple of 16 and at
// most ivt_window_mma_max_width, window^2 at most ivt_window_mma_max_tokens,
// H and W multiples of window; qkv_w [C, 3C] with columns [3][heads][32];
// proj_w [C, C]; bias [heads, T, T] f32; mask [nW, T, T] f32 or null;
// workspaces (allocated by the caller) qkv_ws [B, H, W, 3C] and o_ws [B, H,
// W, C]; probs [B, nW, heads, T, T] or null (maps off); y, the weights and
// the biases 16-byte aligned. Returns a cudaError_t value.
int ivt_fused_window_attn_mma(const void* y, const void* qkv_w, const void* qkv_b,
                              const void* proj_w, const void* proj_b, const void* bias,
                              const void* mask, void* qkv_ws, void* o_ws, void* a, void* probs,
                              int B, int H, int W, int C, int heads, int window, float scale,
                              int fast, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || heads <= 0 || window <= 0 || C != heads * WA_DH ||
      C % 16 != 0 || C > WA_MAX_WIDTH || window * window > WA_ROWS || H % window != 0 ||
      W % window != 0 || B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if ((M + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16* yb = static_cast<const bf16*>(y);
  bf16* qkv = static_cast<bf16*>(qkv_ws);
  cudaError_t err =
      qkv_rows((int)M) == 32
          ? launch_qkv_bm<32>(yb, static_cast<const bf16*>(qkv_w), static_cast<const bf16*>(qkv_b),
                              qkv, (int)M, C, s)
          : launch_qkv_bm<64>(yb, static_cast<const bf16*>(qkv_w), static_cast<const bf16*>(qkv_b),
                              qkv, (int)M, C, s);
  if (err != cudaSuccess) return (int)err;

  WinArgs wa{};
  wa.qkv = qkv;
  wa.bias = static_cast<const float*>(bias);
  wa.mask = static_cast<const float*>(mask);
  wa.o = static_cast<bf16*>(o_ws);
  wa.probs = static_cast<bf16*>(probs);
  wa.H = H;
  wa.W = W;
  wa.C = C;
  wa.heads = heads;
  wa.window = window;
  wa.fast = fast ? 1 : 0;
  wa.scale = scale;
  const dim3 grid((H / window) * (W / window), heads, B);
  window_attn_mma_kernel<<<grid, WA_THREADS, 0, s>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 pgrid((C + PG_BN - 1) / PG_BN, (unsigned)((M + PG_BM - 1) / PG_BM));
  proj_mma_kernel<false><<<pgrid, PG_THREADS, 0, s>>>(static_cast<const bf16*>(o_ws),
                                                      static_cast<const bf16*>(proj_w),
                                                      static_cast<const bf16*>(proj_b), nullptr,
                                                      static_cast<bf16*>(a), (int)M, C, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
