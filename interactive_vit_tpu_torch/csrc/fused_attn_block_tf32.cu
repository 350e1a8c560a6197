// Fused ViT attention block on Hopper's tensor cores in f32, heads 64 or 80
// wide (one instantiation each), through the 3xTF32 split
// (tf32_attention.cuh):
//     y = x + proj(MHSA(LN1(x))), with optional per-head probs (all heads
//     or an attn_heads subset), head-mean, ToMe's key bias and key metric,
//     and the s8 mode (int8 scores, int8 or dense PV).
//
// Replaces, for f32, the Pallas TPU kernel interactive_vit_tpu/ops/
// fused_block.py::fused_attn_block (_kernel, _row_softmax); other operands
// stay on fused_attn_block.cu (f32 FMA, __dp4a). The contract is that
// kernel's in f32 (every cast the identity): LN(x) with f32 statistics,
// qkv = LN(x) qkv_w + qkv_b, the attention as in attn_block_tf32.cuh
// (dense) or attn_block_s8.cuh (s8), y = (x + o proj_w) + proj_b. Every
// product a b is three TF32 products of a hi / lo split, the hi products and
// the correction terms summed apart over one short run (a k-tile of 32 in
// the two GEMMs) and folded with round-to-nearest adds.
//
//   Kernel L  row1_ln_tf32_kernel  LN1, one warp a row (mlp_cluster.cuh's
//             mc_ln_row), into the o workspace, as fused_attn_block_mma.cu's
//             pass (LN1 once a row tile in the product's prologue lost to it
//             there).
//   Kernel A  row1_qkv_tf32_kernel (attn_block_tf32.cuh, which row 5
//             shares)  QKV: a tile of 32 rows x 64 of the 3D
//             columns a block of 4 warps (16 x 32 each). The block copies its
//             32 rows of LN(x) into an f32 panel [32][D + 8] in shared memory
//             with the first weight tiles; the weight k-tiles [32][64] (rows
//             of 68 floats, as the projection's) stream through a
//             three-stage cp.async ring; the epilogue adds qkv_b. Rows of D +
//             8 floats (8 or 24 mod 32) keep the panel's 8-byte fragment
//             loads conflict-free.
//   Kernel E  key_mean (common.cuh)  ToMe's metric, when asked for.
//   Kernel B  row1_attn_tf32_kernel  dense: attend_head
//             (attn_block_tf32.cuh, row 2's) per (64 query rows, head,
//             image), ToMe's key bias a template option, the attn_heads
//             subset a per-head copy of its arguments (as in
//             fused_attn_block_mma.cu); or
//             row1_s8_mma_kernel     s8 (attn_block_s8.cuh).
//   Kernel D  head_mean (common.cuh)  the head-mean, when asked for.
//   Kernel C  proj_tf32_kernel (attn_block_tf32.cuh)  y = (x + o proj_w) +
//             proj_b.
//
// What bounds it on this card: at vit_b16 (N = 197, D = 768, B = 1) the
// block's 1.40 GFLOP are 4.19 G TF32 operations under the split, 0.0085 ms
// at 495 TFLOP/s (0.021 ms at the f32 FMA peak); the bytes, ~9 MB with maps
// and mean, take 0.0027 ms. mma.sync reaches a fraction of the TF32 rate.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"
#include "tf32_attention.cuh"
#include "mlp_cluster.cuh"
#include "attn_block_tf32.cuh"
#include "attn_block_s8.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernel A: qkv[M, 3D] = LN(x) @ qkv_w + qkv_b on split TF32: attn_block_tf32.cuh's
// row1_qkv_tf32_kernel on LN1's output.

// Kernel L: LN1 of one row a warp into ln [M, D].
__global__ void __launch_bounds__(QT_THREADS)
    row1_ln_tf32_kernel(const float* __restrict__ x, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, float* __restrict__ ln, int M, int D,
                        float eps) {
  const int row = blockIdx.x * (QT_THREADS / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  float v[MC_UNITS][16];
  const int mine = mc_ln_row<float>(v, x + (long long)row * D, ln_s, ln_b, D, eps, lane);
#pragma unroll
  for (int i = 0; i < MC_UNITS; ++i) {
    if (i < mine) {
      float4* o = reinterpret_cast<float4*>(ln + (long long)row * D + 16 * (lane + 32 * i));
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = make_float4(v[i][4 * q], v[i][4 * q + 1], v[i][4 * q + 2], v[i][4 * q + 3]);
    }
  }
}

// ln_ws: LN1's output [M, D] (the o workspace, which the attention writes
// only after QKV has read it)
cudaError_t launch_qkv(const float* x, const float* ln_s, const float* ln_b, const float* w,
                       const float* bias, float* qkv, float* ln_ws, int M, int D, float eps,
                       cudaStream_t stream) {
  const int per = QT_THREADS / 32;
  row1_ln_tf32_kernel<<<(M + per - 1) / per, QT_THREADS, 0, stream>>>(x, ln_s, ln_b, ln_ws, M, D,
                                                                      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_qkv_tf32(ln_ws, w, bias, qkv, M, D, stream);
}

// ---------------------------------------------------------------------------
// Kernel B, dense: attend_head per (64 query rows, head, image); the
// attn_heads subset as in fused_attn_block_mma.cu.
struct Row1Args : HwArgs {
  const float* kb;               // ToMe's key bias [B, N] f32, or null
  unsigned long long emit_mask;  // bit h: head h's probs are tapped
  int n_emit;                    // the tap's heads
};

template <int DH, int WALKS, bool KB>
__global__ void __launch_bounds__(HT_THREADS) row1_attn_tf32_kernel(const Row1Args a) {
  extern __shared__ float4 r1_smem4[];
  const int h = blockIdx.y, b = blockIdx.z;
  const bool emit = (a.emit_mask >> h) & 1ULL;
  const long long tap = __popcll(a.emit_mask & ((1ULL << h) - 1ULL));
  Row1Args ah = a;
  ah.norm = (emit || a.head_probs != nullptr) ? 1 : 0;
  ah.probs = emit ? a.probs + ((long long)b * (a.n_emit - a.H) + tap - h) * a.N * a.N : nullptr;
  attend_head<DH, WALKS, KB>(ah, reinterpret_cast<float*>(r1_smem4), blockIdx.x * HT_ROWS, h, b);
}

template <int DH, int WALKS, bool KB>
cudaError_t launch_attention(const Row1Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = HwTf32Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(row1_attn_tf32_kernel<DH, WALKS, KB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + HT_ROWS - 1) / HT_ROWS, a.H, B);
  row1_attn_tf32_kernel<DH, WALKS, KB><<<grid, HT_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, bool KB>
cudaError_t launch_walks(const Row1Args& a, int B, cudaStream_t s) {
  // one walk over the keys only for the fast softmax with no head normalised
  const bool two = a.n_emit > 0 || a.head_probs != nullptr || !a.fast;
  return two ? launch_attention<DH, 2, KB>(a, B, s) : launch_attention<DH, 1, KB>(a, B, s);
}

template <int DH>
cudaError_t launch_dense(const Row1Args& a, int B, cudaStream_t s) {
  return a.kb != nullptr ? launch_walks<DH, true>(a, B, s) : launch_walks<DH, false>(a, B, s);
}

// the head widths the kernels are built for
constexpr int R1_DHS[] = {64, 80};

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_fused_block_tf32_dh(int i) {
  constexpr int n = sizeof(R1_DHS) / sizeof(R1_DHS[0]);
  return i >= 0 && i < n ? R1_DHS[i] : 0;
}

// The widest row the LN1 + QKV kernel takes (mc_ln_row's registers).
int ivt_fused_block_tf32_max_width() { return MC_MAX_WIDTH; }

// Kernel A's dynamic shared memory for rows d wide, in bytes (a tile of
// 32 rows).
size_t ivt_fused_block_tf32_qkv_smem(int d) { return qkv_tf32_smem_bytes(d); }

// The s8 attention kernel's dynamic shared memory for n keys of heads dh
// wide, in bytes.
size_t ivt_fused_block_tf32_s8_smem(int n, int dh) { return s8_layout(n, dh, 4).total; }

// f32 x, y [B, N, D], D = H dh with dh one of ivt_fused_block_tf32_dh and
// D <= ivt_fused_block_tf32_max_width; every pointer 16-byte aligned. The
// workspaces and taps as ivt_fused_attn_block_mma's, in f32. Returns a
// cudaError_t value.
int ivt_fused_attn_block_tf32x3(const void* x, const void* ln_s, const void* ln_b,
                                const void* qkv_w, const void* qkv_b, const void* proj_w,
                                const void* proj_b, void* qkv_ws, void* o_ws, void* probs_ws,
                                void* y, void* probs, void* mean, const void* kb, void* metric,
                                int B, int N, int D, int H, float eps, float scale,
                                float inv_heads, int fast, unsigned long long emit_mask,
                                int n_emit, int int8_mode, const void* const* s8_parts, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || H > 64 || D % H != 0 || D > MC_MAX_WIDTH ||
      int8_mode < 0 || int8_mode > 2)
    return (int)cudaErrorInvalidValue;
  const int dh = D / H, M = B * N;
  if (dh != 64 && dh != 80) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_qkv(static_cast<const float*>(x), static_cast<const float*>(ln_s),
                               static_cast<const float*>(ln_b), static_cast<const float*>(qkv_w),
                               static_cast<const float*>(qkv_b), static_cast<float*>(qkv_ws),
                               static_cast<float*>(o_ws), M, D, eps, s);
  if (err != cudaSuccess) return (int)err;
  if (metric != nullptr) {
    err = launch_key_mean<float>(static_cast<const float*>(qkv_ws), static_cast<float*>(metric), M,
                                 D, H, inv_heads, s);
    if (err != cudaSuccess) return (int)err;
  }
  float* head_probs = mean != nullptr ? static_cast<float*>(probs_ws) : nullptr;
  if (int8_mode == 0) {
    Row1Args a{};
    a.qkv = static_cast<const float*>(qkv_ws);
    a.o = static_cast<float*>(o_ws);
    a.probs = static_cast<float*>(probs);
    a.head_probs = head_probs;
    a.H = H;
    a.N = N;
    a.D = D;
    a.fast = fast ? 1 : 0;
    a.scale = scale;
    a.kb = static_cast<const float*>(kb);
    a.emit_mask = probs != nullptr ? emit_mask : 0ULL;
    a.n_emit = probs != nullptr ? n_emit : 0;
    err = dh == 64 ? launch_dense<64>(a, B, s) : launch_dense<80>(a, B, s);
  } else {
    S8Args<float> a{};
    a.qkv = static_cast<const float*>(qkv_ws);
    a.o = static_cast<float*>(o_ws);
    a.probs = static_cast<float*>(probs);
    a.head_probs = head_probs;
    a.kb = static_cast<const float*>(kb);
    a.emit_mask = probs != nullptr ? emit_mask : 0ULL;
    a.n_emit = probs != nullptr ? n_emit : 0;
    a.N = N;
    a.D = D;
    a.H = H;
    a.fast = fast ? 1 : 0;
    a.pv8 = int8_mode == 2 ? 1 : 0;
    a.scale = scale;
    if (s8_parts != nullptr) {
      a.q8 = (int8_t*)s8_parts[0];
      a.k8 = (int8_t*)s8_parts[1];
      a.v8 = (int8_t*)s8_parts[2];
      a.p8 = (int8_t*)s8_parts[3];
      a.si = (int*)s8_parts[4];
      a.oi = (int*)s8_parts[5];
    }
    err = dh == 64 ? launch_s8<float, 64>(a, B, s) : launch_s8<float, 80>(a, B, s);
  }
  if (err != cudaSuccess) return (int)err;
  if (mean != nullptr) {
    err = launch_head_mean<float>(head_probs, static_cast<float*>(mean), B, H, N, inv_heads, s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((D + PT_BN - 1) / PT_BN, (M + PT_BM - 1) / PT_BM);
  proj_tf32_kernel<<<grid, PT_THREADS, 0, s>>>(static_cast<const float*>(o_ws),
                                               static_cast<const float*>(proj_w),
                                               static_cast<const float*>(proj_b),
                                               static_cast<const float*>(x), static_cast<float*>(y),
                                               M, D, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
