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
// Kernels A and C (attend_head, proj_mma_kernel) live in attn_block_mma.cuh,
// which row 1's tensor-core route (fused_attn_block_mma.cu) shares.
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"
#include "mma_attention.cuh"
#include "attn_block_mma.cuh"

namespace {

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
