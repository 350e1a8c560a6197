// Fused ViT attention block on Hopper's tensor cores, bf16, heads 64 or 80
// wide (one instantiation each):
//     y = x + proj(MHSA(LN1(x))), with optional per-head probs (all heads
//     or an attn_heads subset), head-mean, ToMe's key bias and key metric,
//     and the s8 mode (int8 scores, int8 or dense PV).
//
// Replaces, for bf16, the Pallas TPU kernel interactive_vit_tpu/ops/
// fused_block.py::fused_attn_block (_kernel, _row_softmax); other operands
// stay on fused_attn_block.cu (f32 FMA, __dp4a). The cast points are that
// kernel's: f32 LayerNorm statistics, LN(x) cast to bf16, the QKV product
// summed in f32 plus the bias in f32, cast; the attention's as in
// attn_block_mma.cuh (dense) or attn_block_s8.cuh (s8); head outputs cast;
// y = (x + o proj_w) + proj_b in f32, cast.
//
//   Kernel L  row1_ln_mma_kernel   LN1, one warp a row (mlp_cluster.cuh's
//             mc_ln_row: two-pass f32 statistics, explicitly rounded), cast
//             to bf16, into the o workspace (which the attention writes only
//             after QKV has read it).
//   Kernel A  row1_qkv_mma_kernel (attn_block_mma.cuh, which row 5 shares)
//             QKV: a tile of BM rows x 64 of the 3D
//             columns a block of 4 warps. The block copies its BM rows of
//             LN(x) (kernel L's) into a bf16 panel [BM][D + 8] in shared
//             memory with the first weight tiles; the weight k-tiles [64][64] then stream
//             through a three-stage cp.async ring, and mma.sync m16n8k16
//             (ldmatrix for the panel, ldmatrix .trans for qkv_w's [k][n]
//             rows) sums in f32; the epilogue adds qkv_b in f32 and casts.
//             BM is 32 up to QKV_SMALL_M rows and 64 above (one image: 7 x 36
//             blocks of 32 rows against 4 x 36 = 144 of 64 rows, 12 of them
//             in a second wave of 132 SMs).
//   The measured choices (tools/kernel_variants.py, the whole block, maps
//   off, device time; NVIDIA H100 80GB HBM3, 700.00 W): at vit_b16, one
//   image, tiles of 32 rows 0.0374 ms against 0.0435 of 64; at eight
//   images 64 rows 0.1109 against 0.1144 of 32. LN1 once a row tile in
//   kernel A's prologue (each of the 36 column blocks normalising its
//   rows, one warp a row, while the weights fly) took 0.0428 ms against
//   0.0374 with the pass of its own at one image, 0.2325 against 0.1110 at
//   eight (the variant tool's row1_mma_ln_prologue, gone with that
//   prologue). Registers (ptxas, no spill): kernel A 48 (BM = 32) and 70 (64),
//   kernel L 80, the attention 124-145 at 64 wide and 128-164 at 80, the
//   s8 attention 48 (64 wide) and 64 (80), the projection 78.
//   Kernel E  key_mean (common.cuh)  ToMe's metric, when asked for.
//   Kernel B  row1_attn_mma_kernel   dense: attend_head (attn_block_mma.cuh,
//             row 2's) per (64 query rows, head, image), with ToMe's key
//             bias as a template option and the attn_heads subset as a
//             per-head copy of its arguments (below); or
//             row1_s8_mma_kernel     s8 (attn_block_s8.cuh).
//   Kernel D  head_mean (common.cuh)  the head-mean, when asked for.
//   Kernel C  proj_mma_kernel (attn_block_mma.cuh)  y = (x + o proj_w) +
//             proj_b.
//
// The attn_heads subset. attend_head writes head h's probs at tap row h of
// a [B, H, N, N] tap; row 1's tap holds only the emitted heads, head h at
// row popcount(mask & ((1 << h) - 1)) of [B, n_emit, N, N]. The kernel hands
// attend_head a copy of its arguments per head: probs moved so that
// attend_head's row (b, h) lands on row (b, tap), or null for a head not
// emitted (which then never writes N x N), and norm set for a head that is
// emitted or feeds the head-mean (the others fold 1 / l into the output).
//
// What bounds it on this card: at vit_b16 (N = 197, D = 768, 12 heads,
// B = 1) the block is 1.40 GFLOP (QKV 0.70, attention 0.12, projection
// 0.23) over ~4.5 MB with maps and mean (the weights 3.5 MB): 0.0014 ms at
// 989 TFLOP/s, 0.0013 ms at 3.35 TB/s. Its time is the three launches'
// latency and how few blocks one image gives the card (252 for QKV, 48
// for the attention, 48 for the projection): mma.sync reaches a fraction
// of the wgmma rate, and every score costs an expf on the FMA pipes.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"
#include "mma_attention.cuh"
#include "mlp_cluster.cuh"
#include "attn_block_mma.cuh"
#include "attn_block_s8.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernel A: qkv[M, 3D] = cast(LN(x)) @ qkv_w + qkv_b, attn_block_mma.cuh's
// row1_qkv_mma_kernel on LN1's output.

// One row of LN(x) as bf16 into dst (16 bytes at a time): one warp.
__device__ __forceinline__ void ln_row_bf16(bf16* dst, const bf16* x, const bf16* ln_s,
                                            const bf16* ln_b, int D, float eps, int lane) {
  float v[MC_UNITS][16];
  const int mine = mc_ln_row<bf16>(v, x, ln_s, ln_b, D, eps, lane);
#pragma unroll
  for (int i = 0; i < MC_UNITS; ++i) {
    if (i < mine) {
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = pack_bf16(v[i][2 * e], v[i][2 * e + 1]);
      int4* o = reinterpret_cast<int4*>(dst + 16 * (lane + 32 * i));
      o[0] = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
      o[1] = make_int4((int)w[4], (int)w[5], (int)w[6], (int)w[7]);
    }
  }
}

// Kernel L, LN1 as a pass of its own: one warp a row.
__global__ void __launch_bounds__(QK_THREADS)
    row1_ln_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_s,
                       const bf16* __restrict__ ln_b, bf16* __restrict__ ln, int M, int D,
                       float eps) {
  const int row = blockIdx.x * (QK_THREADS / 32) + (threadIdx.x >> 5);
  if (row < M)
    ln_row_bf16(ln + (long long)row * D, x + (long long)row * D, ln_s, ln_b, D, eps,
                threadIdx.x & 31);
}

// ln_ws: LN1's output [M, D] (the o workspace, which the attention writes
// only after QKV has read it)
cudaError_t launch_qkv(const bf16* x, const bf16* ln_s, const bf16* ln_b, const bf16* w,
                       const bf16* bias, bf16* qkv, bf16* ln_ws, int M, int D, float eps,
                       cudaStream_t stream) {
  const int per = QK_THREADS / 32;
  row1_ln_mma_kernel<<<(M + per - 1) / per, QK_THREADS, 0, stream>>>(x, ln_s, ln_b, ln_ws, M, D,
                                                                     eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return qkv_rows(M) == 32 ? launch_qkv_bm<32>(ln_ws, w, bias, qkv, M, D, stream)
                           : launch_qkv_bm<64>(ln_ws, w, bias, qkv, M, D, stream);
}

// ---------------------------------------------------------------------------
// Kernel B, dense: attend_head per (64 query rows, head, image).
struct Row1Args : HwArgs {
  const float* kb;               // ToMe's key bias [B, N] f32, or null
  unsigned long long emit_mask;  // bit h: head h's probs are tapped
  int n_emit;                    // the tap's heads
};

template <int DH, int WALKS, bool KB>
__global__ void __launch_bounds__(HM_THREADS) row1_attn_mma_kernel(const Row1Args a) {
  extern __shared__ float4 r1_smem4[];
  bf16* ring = reinterpret_cast<bf16*>(r1_smem4);
  float* pstage = reinterpret_cast<float*>(ring + 2 * HwMmaCfg<DH>::STAGE);
  const int h = blockIdx.y, b = blockIdx.z;
  const bool emit = (a.emit_mask >> h) & 1ULL;
  const long long tap = __popcll(a.emit_mask & ((1ULL << h) - 1ULL));
  Row1Args ah = a;
  ah.norm = (emit || a.head_probs != nullptr) ? 1 : 0;
  // attend_head's tap row (b, h) of [B, H, N, N] moved onto (b, tap) of
  // [B, n_emit, N, N]
  ah.probs = emit ? a.probs + ((long long)b * (a.n_emit - a.H) + tap - h) * a.N * a.N : nullptr;
  attend_head<DH, WALKS, KB>(ah, ring, pstage, blockIdx.x * HM_ROWS, h, b);
}

template <int DH, int WALKS, bool KB>
cudaError_t launch_attention(const Row1Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = HwMmaCfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(row1_attn_mma_kernel<DH, WALKS, KB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + HM_ROWS - 1) / HM_ROWS, a.H, B);
  row1_attn_mma_kernel<DH, WALKS, KB><<<grid, HM_THREADS, smem, stream>>>(a);
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
int ivt_fused_block_mma_dh(int i) {
  constexpr int n = sizeof(R1_DHS) / sizeof(R1_DHS[0]);
  return i >= 0 && i < n ? R1_DHS[i] : 0;
}

// The widest row the LN1 + QKV kernel takes (mc_ln_row's registers).
int ivt_fused_block_mma_max_width() { return MC_MAX_WIDTH; }

// The rows of kernel A's tile for m rows, and its dynamic shared memory
// for rows d wide and that tile, in bytes.
int ivt_fused_block_mma_qkv_rows(int m) { return qkv_rows(m); }
size_t ivt_fused_block_mma_qkv_smem(int d, int bm) { return qkv_smem_bytes(d, bm); }

// The s8 attention kernel's dynamic shared memory for n keys of heads dh
// wide, in bytes.
size_t ivt_fused_block_mma_s8_smem(int n, int dh) { return s8_layout(n, dh, 2).total; }

// bf16 x, y [B, N, D], D = H dh with dh one of ivt_fused_block_mma_dh and
// D <= ivt_fused_block_mma_max_width; every pointer 16-byte aligned.
// Workspaces (allocated by the caller): qkv_ws [B, N, 3D] and o_ws [B, N,
// D] bf16, probs_ws [B, H, N, N] f32 (only read when mean is given).
// probs [B, n_emit, N, N] / mean [B, N, N] may be null (taps off). ToMe: kb
// [B, N] f32 (null = no bias); metric [B, N, dh] f32 (null = not asked
// for). emit_mask: bit h set = head h's probs are written, to tap row
// popcount(emit_mask & ((1 << h) - 1)). int8_mode: 0 = dense, 1 = s8
// scores with a dense PV product, 2 = s8 scores and PV. s8_parts: null, or
// (a check of the s8 mode) a host array of six device pointers, q8, k8, v8,
// p8 int8 and si, oi s32 (attn_block_s8.cuh S8Args), each written where not
// null. Returns a cudaError_t value.
int ivt_fused_attn_block_mma(const void* x, const void* ln_s, const void* ln_b,
                             const void* qkv_w, const void* qkv_b, const void* proj_w,
                             const void* proj_b, void* qkv_ws, void* o_ws, void* probs_ws,
                             void* y, void* probs, void* mean, const void* kb, void* metric,
                             int B, int N, int D, int H, float eps, float scale, float inv_heads,
                             int fast, unsigned long long emit_mask, int n_emit, int int8_mode,
                             const void* const* s8_parts, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || H > 64 || D % H != 0 || D > MC_MAX_WIDTH ||
      int8_mode < 0 || int8_mode > 2)
    return (int)cudaErrorInvalidValue;
  const int dh = D / H, M = B * N;
  if (dh != 64 && dh != 80) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_qkv(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
                               static_cast<const bf16*>(ln_b), static_cast<const bf16*>(qkv_w),
                               static_cast<const bf16*>(qkv_b), static_cast<bf16*>(qkv_ws),
                               static_cast<bf16*>(o_ws), M, D, eps, s);
  if (err != cudaSuccess) return (int)err;
  if (metric != nullptr) {
    err = launch_key_mean<bf16>(static_cast<const bf16*>(qkv_ws), static_cast<float*>(metric), M,
                                D, H, inv_heads, s);
    if (err != cudaSuccess) return (int)err;
  }
  float* head_probs = mean != nullptr ? static_cast<float*>(probs_ws) : nullptr;
  if (int8_mode == 0) {
    Row1Args a{};
    a.qkv = static_cast<const bf16*>(qkv_ws);
    a.o = static_cast<bf16*>(o_ws);
    a.probs = static_cast<bf16*>(probs);
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
    S8Args<bf16> a{};
    a.qkv = static_cast<const bf16*>(qkv_ws);
    a.o = static_cast<bf16*>(o_ws);
    a.probs = static_cast<bf16*>(probs);
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
    err = dh == 64 ? launch_s8<bf16, 64>(a, B, s) : launch_s8<bf16, 80>(a, B, s);
  }
  if (err != cudaSuccess) return (int)err;
  if (mean != nullptr) {
    err = launch_head_mean<bf16>(head_probs, static_cast<bf16*>(mean), B, H, N, inv_heads, s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((D + PG_BN - 1) / PG_BN, (M + PG_BM - 1) / PG_BM);
  proj_mma_kernel<<<grid, PG_THREADS, 0, s>>>(static_cast<const bf16*>(o_ws),
                                              static_cast<const bf16*>(proj_w),
                                              static_cast<const bf16*>(proj_b),
                                              static_cast<const bf16*>(x), static_cast<bf16*>(y), M,
                                              D, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
