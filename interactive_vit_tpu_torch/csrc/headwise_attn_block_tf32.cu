// Headwise attention block on Hopper's tensor cores in f32, heads 64 or 80
// wide (one instantiation each), through the 3xTF32 split: from the
// untransposed qkv [B, N, 3D] (LN1 + QKV are computed before, by the
// caller),
//     y = x + proj(concat_h softmax(q_h k_h^T / sqrt(dh)) v_h),
// with optional per-head probs [B, H, N, N] and head-mean [B, N, N].
//
// Replaces, for f32, the Pallas TPU kernel interactive_vit_tpu/ops/
// fused_block.py::headwise_attn_block (_headwise_kernel, _row_softmax);
// other operands stay on headwise_attn_block.cu (f32 FMA). The contract is
// that kernel's, in f32 (every cast is the identity):
//   s     = (q . k) * dh^-0.5;
//   fast  p = exp(min(s, 80)), no max subtracted; exact p = exp(s - rowmax);
//   l     = rowsum(p), r = 1 / l;
//   maps and mean off: o = (p v) * r; maps or mean on: probs = p * r, the
//   tap, the head-mean's input and PV's operand, o = probs v;
//   the head-mean sums the probs over the heads in head order, times 1 / H;
//   y = (x + o proj_w) + proj_b.
// The exponent is expf; the scale, the reciprocal, the products by r and
// the sums of p are explicitly rounded operations (no contraction).
//
// The products: every product a b is taken as three TF32 tensor-core
// products on a hi / lo split of each operand (tf32_attention.cuh), the
// hi products and the correction terms in two accumulators, each over one
// short run only (the steps over dh of a score; the keys of a tile in PV;
// a k-tile of 32 in the projection), added and folded into the running
// sums with round-to-nearest f32 operations. The depth index is permuted
// (2t, 2t + 1), so the score accumulators are PV's A fragment as they
// stand.
//
// Kernel A, the attention of one head (row 4's split-TF32 design,
// flash_attention_online_tf32.cu): one block of 4 warps per (64 query
// rows, head, image), each warp owning 16 query rows whose split Q
// fragments stay in registers. q, k and v are read by strides straight
// from qkv (q at column h dh, k at D + h dh, v at 2D + h dh, token stride
// 3D). Key tiles (32 keys at 64 wide, 64 at 80, where split Q and the PV
// accumulators take 120 registers and PV runs in five parts of o's
// columns; 255 registers, no spill) stream through a two-stage cp.async
// ring (K rows of DH + 8 floats, V rows of DH + 4; rows past N
// zero-filled, their keys get p = 0). On an NVIDIA H100 80GB HBM3
// (700.00 W) the tiles were chosen by the served shapes
// (tools/kernel_variants.py, after QKV):
// at vit_l16@384 (B=1) 32 keys took 0.1334 ms maps off and 0.2082 maps +
// mean, 64 keys 0.1377 and 0.2179; at vit_h14@742 64 keys took 1.4334 and
// 2.5795, 32 keys 1.4942 and 2.6134 (at vit_h14@224, which the served
// path does not reach, 32 keys won: 0.0863 against 0.0869). The fast
// softmax has no running max and so nothing to rescale: with maps and mean
// off the block walks the keys once. With maps or mean on (or the exact
// softmax, whose max comes from the online update) it walks them twice:
// the row sums first, then the probs, the tap and PV; the probs go to the
// tap and the head-mean workspace through the warp's staging rows. Kernel
// D, the head-mean pass (common.cuh), reads the f32 per-head workspace in
// head order. The other design, one block per query tile walking the
// heads in order and summing the mean in place (tools/kernel_variants.py),
// leaves too few blocks for the card and spills: 3.2801 ms against 0.2179 at
// vit_l16@384 with maps + mean, 20.7830 against 2.6134 at vit_h14@742
// (tools/kernel_variants.py, NVIDIA H100 80GB HBM3, 700.00 W).
// Kernel C, the projection with the residual: a 64 x 64 tile a block of 4
// warps (32 x 32 each), k-tiles of 32 through a two-stage cp.async ring
// (o rows of 40 floats, proj_w rows of 68: the fragment loads
// conflict-free as in TfDims), the split products folded per k-tile, (x +
// acc) + b in the epilogue.
//
// What bounds it on this card: at vit_h14@742 (N = 2810, 16 heads 80
// wide, B = 1) the work after QKV is 49.64 GFLOP (attention 40.43,
// projection 9.21) over ~93 MB: 0.74 ms at the f32 FMA peak (67 TFLOP/s);
// the split issues three TF32 products a product, 148.9 GFLOP, 0.301 ms
// at the TF32 peak (495 TFLOP/s), on mma.sync (a fraction of it), with an
// expf per score on the FMA pipes.
//
// Kernels A and C (attend_head, proj_tf32_kernel) live in
// attn_block_tf32.cuh, which row 1's split-TF32 route
// (fused_attn_block_tf32.cu) shares.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"
#include "tf32_attention.cuh"
#include "attn_block_tf32.cuh"

namespace {

template <int DH, int WALKS>
__global__ void __launch_bounds__(HT_THREADS) headwise_tf32_kernel(const HwArgs a) {
  extern __shared__ float4 ht_smem4[];
  attend_head<DH, WALKS>(a, reinterpret_cast<float*>(ht_smem4), blockIdx.x * HT_ROWS, blockIdx.y,
                         blockIdx.z);
}

template <int DH, int WALKS>
cudaError_t launch_attention(const HwArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = HwTf32Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(headwise_tf32_kernel<DH, WALKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + HT_ROWS - 1) / HT_ROWS, a.H, B);
  headwise_tf32_kernel<DH, WALKS><<<grid, HT_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the head widths the kernels are built for
constexpr int HT_DHS[] = {64, 80};

template <int DH>
cudaError_t launch_dh(const HwArgs& a, int B, cudaStream_t s) {
  return (a.norm || !a.fast) ? launch_attention<DH, 2>(a, B, s) : launch_attention<DH, 1>(a, B, s);
}

}  // namespace

extern "C" {

// The i-th head width the kernels take, in increasing order; 0 past the
// last.
int ivt_headwise_tf32_dh(int i) {
  constexpr int n = sizeof(HT_DHS) / sizeof(HT_DHS[0]);
  return i >= 0 && i < n ? HT_DHS[i] : 0;
}

// The key tile of the attention kernel at head width dh; 0 for a width it
// does not take.
int ivt_headwise_tf32_block_k(int dh) {
  return dh == 64 ? HwTf32Cfg<64>::KT : dh == 80 ? HwTf32Cfg<80>::KT : 0;
}

// f32 x, y [B, N, D]; qkv [B, N, 3D] with columns [3][H][dh], dh = D / H
// one of ivt_headwise_tf32_dh; proj_w [D, D]; every pointer 16-byte
// aligned. Workspaces (allocated by the caller): o_ws [B, N, D] f32,
// probs_ws [B, H, N, N] f32 (only read when mean is given). probs [B, H,
// N, N] / mean [B, N, N] may be null (taps off). Returns a cudaError_t
// value.
int ivt_headwise_attn_block_tf32x3(const void* x, const void* qkv, const void* proj_w,
                                   const void* proj_b, void* o_ws, void* probs_ws, void* y,
                                   void* probs, void* mean, int B, int N, int D, int H, float scale,
                                   float inv_heads, int fast, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh != 64 && dh != 80) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  HwArgs a{};
  a.qkv = static_cast<const float*>(qkv);
  a.o = static_cast<float*>(o_ws);
  a.probs = static_cast<float*>(probs);
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
    err = launch_head_mean<float>(a.head_probs, static_cast<float*>(mean), B, H, N, inv_heads, s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((D + PT_BN - 1) / PT_BN, (B * N + PT_BM - 1) / PT_BM);
  proj_tf32_kernel<<<grid, PT_THREADS, 0, s>>>(static_cast<const float*>(o_ws),
                                               static_cast<const float*>(proj_w),
                                               static_cast<const float*>(proj_b),
                                               static_cast<const float*>(x), static_cast<float*>(y),
                                               B * N, D, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
