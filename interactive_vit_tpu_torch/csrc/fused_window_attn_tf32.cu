// Fused Swin window-attention branch on Hopper's tensor cores in f32, heads
// 32 wide, windows of at most 64 tokens, through the 3xTF32 split
// (tf32_attention.cuh): fused_window_attn_mma.cu's branch (its notes give
// the layout, the gather and the softmax) with every product a b taken as
// three TF32 products of a hi / lo split, the hi products and the
// correction terms summed apart over one short run and folded with
// round-to-nearest adds (rows 1-4's rule: the tensor cores' f32
// accumulation truncates).
//
// Replaces, for f32, the Pallas TPU kernel interactive_vit_tpu/ops/
// fused_window.py::fused_window_attn (_kernel, fused_block._row_softmax);
// other operands keep fused_window_attn.cu (FMA). The contract is that
// kernel's in f32 (every cast the identity): qkv = y qkv_w + qkv_b; s = (q
// . k) * scale, + bias, + mask, each rounded on its own; fast or exact
// softmax; maps on: probs = p * (1 / rowsum), the tap and PV's operand;
// maps off: (p V) * (1 / rowsum); a = o proj_w + proj_b.
//
//   Kernel A  row1_qkv_tf32_kernel (attn_block_tf32.cuh, row 1's)  qkv
//             over the [B*H*W, C] NHWC rows, k-tiles of 32.
//   Kernel B  window_attn_tf32_kernel  one block of 4 warps per (window,
//             head, image): q and k of the window's tokens gathered into
//             tiles [64][TfDims<32>::K_LD = 40] (rows read as 8-byte pairs,
//             40 = 8 mod 32: conflict-free), v into [64][V_LD = 36] (read
//             as 4-byte columns, 2 x 36 = 8 mod 32), rows T..63 zero-filled;
//             each warp's 16 query rows: S = Q K^T over 8 tiles of 8 keys,
//             4 steps of 8 head dims a tile (Q's split fragments in
//             registers), the hi and correction products folded a tile;
//             the softmax on the registers, keys at or past T at p = 0; PV
//             over 8 steps of 8 keys (one run, folded once: the whole
//             window is one key tile) from the score registers.
//   Kernel C  proj_tf32_kernel<false> (attn_block_tf32.cuh)  a = o proj_w
//             + proj_b, no residual.
// The grid as fused_window_attn_mma.cu's, measured in both dtypes
// (tools/kernel_variants.py --only row5; NVIDIA H100 80GB HBM3, 700.00 W):
// the whole branch at swin_t's stages 0-3, B = 1, maps off, device time,
// 0.0310, 0.0332, 0.0417, 0.0642 ms by (window, head, image) against
// 0.0498, 0.0823, 0.1497, 0.2861 by (window, image); the FMA kernel
// 0.0397, 0.0447, 0.0673, 0.1125.
//
// What bounds it on this card: at swin_t stage 2 (B = 1) the branch's
// 0.246 GFLOP are 0.738 G TF32 operations under the split, 0.00149 ms at
// 495 TFLOP/s (0.0037 ms at the f32 FMA peak); its 3.08 MB take 0.00092 ms.
// As in bf16 its time is three launches' latency and few blocks.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"
#include "tf32_attention.cuh"
#include "attn_block_tf32.cuh"

namespace {

constexpr int WT_DH = 32;                    // the head width
constexpr int WT_ROWS = 64;                  // a window's tokens, padded
constexpr int WT_WARPS = 4, WT_THREADS = 32 * WT_WARPS;
constexpr int WT_NT = WT_ROWS / 8;           // 8-key tiles of a score row
constexpr int WT_MAX_WIDTH = 1280;           // the widest map (channels)
using WtDims = TfDims<WT_DH>;
constexpr int WT_CHUNKS = WT_DH / 4;         // 16-byte chunks of a head's row
constexpr int WT_QK_TILE = WT_ROWS * WtDims::K_LD, WT_V_TILE = WT_ROWS * WtDims::V_LD;

struct WinArgs {
  const float* qkv;   // [B, H, W, 3C]
  const float* bias;  // [heads, T, T]
  const float* mask;  // [nW, T, T], or null (unshifted)
  float* o;           // [B, H, W, C]: the head outputs
  float* probs;       // [B, nW, heads, T, T], or null (maps off)
  int H, W, C, heads, window, fast;
  float scale;
};

__device__ __forceinline__ long long win_pixel(const WinArgs& a, int b, int wy, int wx, int i) {
  return ((long long)b * a.H + wy * a.window + i / a.window) * a.W + wx * a.window +
         i % a.window;
}

// One (window, head, image) on the block's tiles: Q, K [WT_ROWS][K_LD],
// then V [WT_ROWS][V_LD].
__device__ __forceinline__ void window_head(const WinArgs& a, float* tiles, int win, int h,
                                            int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int T = a.window * a.window, nwx = a.W / a.window, wy = win / nwx, wx = win % nwx;
  const long long ld3 = 3LL * a.C;
  float* Qs = tiles;
  float* Ks = tiles + WT_QK_TILE;
  float* Vs = tiles + 2 * WT_QK_TILE;

  for (int c = threadIdx.x; c < 3 * WT_ROWS * WT_CHUNKS; c += WT_THREADS) {
    const int m = c / (WT_ROWS * WT_CHUNKS), r = c % (WT_ROWS * WT_CHUNKS);
    const int i = r / WT_CHUNKS, part = r % WT_CHUNKS;
    const bool in = i < T;
    const float* src =
        a.qkv + (in ? win_pixel(a, b, wy, wx, i) * ld3 + m * a.C + h * WT_DH + part * 4 : 0);
    float* dst = m < 2 ? tiles + m * WT_QK_TILE + i * WtDims::K_LD : Vs + i * WtDims::V_LD;
    cp_async16(smem_addr(dst + part * 4), src, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S = Q K^T for the warp's 16 rows (Q's split fragments in registers)
  uint32_t qh[WtDims::KS][4], ql[WtDims::KS][4];
#pragma unroll
  for (int kc = 0; kc < WtDims::KS; ++kc)
    load_a_rows<WT_DH>(qh[kc], ql[kc], Qs + 16 * warp * WtDims::K_LD, kc, lane);
  float s[WT_NT][4];
  mma3_rows<WT_DH, WT_NT>(s, qh, ql, Ks, lane);

  // scale, bias, mask, each rounded on its own; the exact form's row max
  const float* bias_h = a.bias + (long long)h * T * T;
  const float* mask_w = a.mask != nullptr ? a.mask + (long long)win * T * T : nullptr;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < WT_NT; ++n)
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

  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < WT_NT; ++n)
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
    float* tap = a.probs + (((long long)b * gridDim.x + win) * a.heads + h) * T * T;
#pragma unroll
    for (int n = 0; n < WT_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * warp + g + 8 * (e >> 1), j = 8 * n + 2 * t + (e & 1);
        s[n][e] = __fmul_rn(s[n][e], r[e >> 1]);
        if (i < T && j < T) tap[i * T + j] = s[n][e];
      }
  }

  // o = P V over the window's 64 keys: 8 steps of 8, one run, folded once
  float oacc[WtDims::DT][4];
#pragma unroll
  for (int d = 0; d < WtDims::DT; ++d) zero4(oacc[d]);
  mma3_acc_by_cols<WT_DH, WT_NT>(oacc, s, Vs, WtDims::V_LD, 0, lane);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = 16 * warp + g + 8 * half;
    if (i >= T) continue;
    float* out = a.o + win_pixel(a, b, wy, wx, i) * a.C + h * WT_DH + 2 * t;
#pragma unroll
    for (int d = 0; d < WtDims::DT; ++d) {
      float2 v = make_float2(oacc[d][2 * half], oacc[d][2 * half + 1]);
      if (a.probs == nullptr)  // maps off: 1 / rowsum folded in here
        v = make_float2(__fmul_rn(v.x, r[half]), __fmul_rn(v.y, r[half]));
      *reinterpret_cast<float2*>(out + 8 * d) = v;
    }
  }
}

// one block per (window, head, image)
__global__ void __launch_bounds__(WT_THREADS) window_attn_tf32_kernel(const WinArgs a) {
  __shared__ __align__(16) float tiles[2 * WT_QK_TILE + WT_V_TILE];
  window_head(a, tiles, blockIdx.x, blockIdx.y, blockIdx.z);
}

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_window_tf32_dh(int i) { return i == 0 ? WT_DH : 0; }

// The most tokens a window may hold, and the widest map (channels).
int ivt_window_tf32_max_tokens() { return WT_ROWS; }
int ivt_window_tf32_max_width() { return WT_MAX_WIDTH; }

// Kernel A's dynamic shared memory for rows d wide, in bytes (a tile of
// 32 rows).
size_t ivt_window_tf32_qkv_smem(int d) { return qkv_tf32_smem_bytes(d); }

// f32 operands as ivt_fused_window_attn_mma's (bf16 there). Returns a
// cudaError_t value.
int ivt_fused_window_attn_tf32x3(const void* y, const void* qkv_w, const void* qkv_b,
                                 const void* proj_w, const void* proj_b, const void* bias,
                                 const void* mask, void* qkv_ws, void* o_ws, void* a,
                                 void* probs, int B, int H, int W, int C, int heads, int window,
                                 float scale, int fast, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || heads <= 0 || window <= 0 || C != heads * WT_DH ||
      C % 16 != 0 || C > WT_MAX_WIDTH || window * window > WT_ROWS || H % window != 0 ||
      W % window != 0 || B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if ((M + QT_BM - 1) / QT_BM > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* qkv = static_cast<float*>(qkv_ws);
  cudaError_t err = launch_qkv_tf32(static_cast<const float*>(y), static_cast<const float*>(qkv_w),
                                    static_cast<const float*>(qkv_b), qkv, (int)M, C, s);
  if (err != cudaSuccess) return (int)err;

  WinArgs wa{};
  wa.qkv = qkv;
  wa.bias = static_cast<const float*>(bias);
  wa.mask = static_cast<const float*>(mask);
  wa.o = static_cast<float*>(o_ws);
  wa.probs = static_cast<float*>(probs);
  wa.H = H;
  wa.W = W;
  wa.C = C;
  wa.heads = heads;
  wa.window = window;
  wa.fast = fast ? 1 : 0;
  wa.scale = scale;
  const dim3 grid((H / window) * (W / window), heads, B);
  window_attn_tf32_kernel<<<grid, WT_THREADS, 0, s>>>(wa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 pgrid((C + PT_BN - 1) / PT_BN, (unsigned)((M + PT_BM - 1) / PT_BM));
  proj_tf32_kernel<false><<<pgrid, PT_THREADS, 0, s>>>(static_cast<const float*>(o_ws),
                                                       static_cast<const float*>(proj_w),
                                                       static_cast<const float*>(proj_b),
                                                       nullptr, static_cast<float*>(a), (int)M,
                                                       C, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
