// Headwise attention block for Hopper (sm_90a): from the untransposed
//     qkv [B, N, 3D] (LN1 + QKV are computed before, by the caller),
//     y = x + proj(concat_h softmax(q_h k_h^T / sqrt(dh)) v_h),
// with optional per-head probs [B, H, N, N] and head-mean [B, N, N].
//
// Replaces the Pallas TPU kernel interactive_vit_tpu/ops/fused_block.py::
// headwise_attn_block (_headwise_kernel, _row_softmax), which serves the
// blocks whose keys are too long for the whole-image block kernel
// (vit_l16 at 384 px: N=577, D=1024, 16 heads). Its numerics and cast
// points: scores in f32, fast softmax exp(min(s, 80)) with the
// normalisation deferred (or the exact max-subtracted form); with maps or
// the mean asked for, probs = p / rowsum cast to the activation dtype feed
// both the tap and PV; without, the unnormalised p is cast, multiplied by
// V and the f32 result scaled by 1 / rowsum; head outputs cast to the
// activation dtype; the projection f32-accumulated, plus the residual and
// the bias in f32, then cast. The head-mean sums the f32 probs over heads.
//
// What the TPU kernel's grid did and this one does not: head groups sized
// to VMEM, and the projection accumulated across a sequential group axis
// in scratch. Here every (query tile, head, image) is its own block of the
// key-tiled attention kernel (common.cuh), the head outputs go to an
// [B, N, D] workspace and one GEMM does the projection with the residual.
//
// What bounds it on this card: at vit_l16@384, B=1, bf16 with maps and
// mean the function's own work is 2.57 GFLOP (attention 1.36, projection
// 1.21) over ~19 MB (the 10.6 MB probs tap dominates), so at the card's
// published rates it would be bound by bytes (~6 us). This version does
// every product with f32 FMA from shared memory, no tensor cores, so it is
// bound by instruction issue far above that; the f32 per-head probs for the
// mean add 21 MB of workspace traffic per image. Tensor-core tiles are
// later work.
//
//   Kernel B  tiled_attention<T>  per (query tile, head, image) -> o workspace
//   Kernel D  head_mean<T>        only when the head-mean is asked for
//   Kernel C  gemm<T, LN=false>   y = (x + o @ proj_w) + proj_b
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* qkv, const void* proj_w, const void* proj_b, void* o_ws,
           void* probs_ws, void* y, void* probs, void* mean, int B, int N, int D, int H,
           float scale, float inv_heads, int fast, cudaStream_t stream) {
  const int dh = D / H;
  TiledAttnArgs a{};
  a.q = qkv;
  a.k = static_cast<const T*>(qkv) + D;
  a.v = static_cast<const T*>(qkv) + 2 * D;
  a.o = o_ws;
  a.q_sb = a.k_sb = a.v_sb = (long long)N * 3 * D;
  a.q_sh = a.k_sh = a.v_sh = dh;
  a.q_sn = a.k_sn = a.v_sn = 3 * D;
  a.o_sb = (long long)N * D;
  a.o_sh = dh;
  a.o_sn = D;
  a.probs = probs;
  a.head_probs = mean != nullptr ? static_cast<float*>(probs_ws) : nullptr;
  a.H = H;
  a.N = N;
  a.dh = dh;
  a.n_real = N;
  a.scale = scale;
  a.mask_value = 0.f;
  a.softmax = fast ? SOFTMAX_FAST : SOFTMAX_EXACT_MUL;
  a.norm = (probs != nullptr || mean != nullptr) ? 1 : 0;
  cudaError_t err = launch_tiled_attention<T>(a, B, stream);
  if (err != cudaSuccess) return (int)err;
  if (mean != nullptr) {
    err = launch_head_mean<T>((const float*)probs_ws, (T*)mean, B, H, N, inv_heads, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_proj_residual<T>((const T*)o_ws, (const T*)proj_w, (const T*)proj_b,
                                      (const T*)x, (T*)y, B * N, D, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, y [B, N, D]; qkv [B, N, 3D] with
// columns [3][H][dh]; proj_w [D, D]; workspaces (allocated by the caller):
// o_ws [B, N, D] in the dtype, probs_ws [B, H, N, N] f32 (only read when
// mean is given). probs [B, H, N, N] / mean [B, N, N] may be null (taps
// off). Returns a cudaError_t value.
int ivt_headwise_attn_block(int dtype, const void* x, const void* qkv, const void* proj_w,
                            const void* proj_b, void* o_ws, void* probs_ws, void* y, void* probs,
                            void* mean, int B, int N, int D, int H, float scale, float inv_heads,
                            int fast, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, qkv, proj_w, proj_b, o_ws, probs_ws, y, probs, mean, B, N, D, H,
                         scale, inv_heads, fast, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, qkv, proj_w, proj_b, o_ws, probs_ws, y, probs, mean, B, N,
                                 D, H, scale, inv_heads, fast, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
