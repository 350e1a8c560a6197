// Fused Swin window-attention branch for Hopper (sm_90a): from the
// LayerNorm'd (and, for shifted blocks, already rolled) NHWC map y,
//     a = proj(concat_h softmax(q_h k_h^T * dh^-0.5 + bias_h [+ mask_w]) v_h),
// per window of window x window tokens, with optional probs
// [B, nW, heads, T, T]. No LayerNorm, no roll, no residual: the caller
// (models/swin.py::block) owns them.
//
// Replaces the Pallas TPU kernel interactive_vit_tpu/ops/fused_window.py::
// fused_window_attn (_kernel, with fused_block._row_softmax). Its numerics
// and cast points: qkv f32-accumulated plus bias, cast to the activation
// dtype T; scores (q . k) in f32, scaled AFTER the dot, plus the f32
// relative-position bias, plus the f32 seam mask (0 / -100) of shifted
// blocks; fast softmax exp(min(s, 80)) with the normalisation deferred, or
// the exact max-subtracted form; with maps asked for, probs = p * (1 /
// rowsum) cast to T feed both the tap and PV; without, the unnormalised p is
// cast, multiplied by V and the f32 result scaled by 1 / rowsum; head
// outputs concatenated and cast to T; the projection f32-accumulated plus
// bias, cast.
//
// What the TPU kernel's shape did and this one does not: its grid was one
// program per (image, strip of windows) with the lane dimension padded to
// 128, a static unroll over windows and heads, and the whole strip's qkv
// resident in fast memory. QKV and the projection are row-local, so here
// they are two GEMMs over the [B*H*W, C] rows in NHWC order (no window
// order needed, no padding); the attention is one block per (window, head,
// image) that gathers its T tokens from the NHWC-ordered qkv by index
// arithmetic, so window partition and merge never exist in memory.
//
// What bounds it on this card: at swin_t (T=49, dh=32) one (window, head)
// is tiny -- 3 x 49 x 32 inputs, 49 x 49 scores, ~0.3 MFLOP -- and the whole
// branch is 0.24 (stage 3) to 0.29 (stage 0) GFLOP per image over 1.3 MB
// (stage 0: the map in and out; 2.2 MB with the probs tap) to 4.9 MB (stage
// 3: the weights), so at the card's published rates it is bound by bytes at
// every stage (0.4 to 1.5 us against 0.3 us of bf16 tensor-core time). This
// version does every product with f32 FMA from shared memory, no tensor
// cores, in three launches; at stage 3 (one window, 24 heads) the attention
// grid is 24 small blocks per image, so that stage is bound by launch and
// latency.
//
//   Kernel A  gemm<T, !LN, !RES>  qkv = y @ qkv_w + qkv_b -> workspace
//   Kernel B  window_attention<T> per (window, head, image): scores + bias
//                                 + mask, softmax, probs tap, o_h = P V ->
//                                 workspace [B, H, W, C]
//   Kernel C  gemm<T, !LN, !RES>  a = o @ proj_w + proj_b
//
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns the first CUDA error.

#include "common.cuh"

namespace {

constexpr int WIN_THREADS = 256;

__host__ __device__ inline size_t window_smem_floats(int t, int dh) {
  // Q [t][dh] + K [t][dh+4] + V [t][dh] + S [t][t] + 1/rowsum [t]; rows of
  // Q, K and V start on 16-byte boundaries (dh % 4 == 0) for float4 reads;
  // S is placed last so its odd row length disturbs no alignment
  return (size_t)t * dh + (size_t)t * (dh + 4) + (size_t)t * dh + (size_t)t * t + t;
}

template <typename T>
__global__ void __launch_bounds__(WIN_THREADS)
window_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ o,
                        T* __restrict__ probs, int H, int W, int C, int heads, int window,
                        float scale, int fast) {
  extern __shared__ float4 win_smem4[];
  const int t = window * window, dh = C / heads, nd4 = dh / 4, ks = dh + 4;
  float* Qs = reinterpret_cast<float*>(win_smem4);
  float* Ks = Qs + (size_t)t * dh;
  float* Vs = Ks + (size_t)t * ks;
  float* S = Vs + (size_t)t * dh;
  float* rinv = S + (size_t)t * t;

  const int nwx = W / window;
  const int win = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nwin = gridDim.x;
  const int wy = win / nwx, wx = win % nwx;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool emit = probs != nullptr;

  // token i of the window sits at pixel (wy*window + i/window, wx*window + i%window)
  const size_t pix0 = ((size_t)b * H + (size_t)wy * window) * W + (size_t)wx * window;
  const size_t ld = 3 * (size_t)C;
  for (int e = tid; e < t * dh; e += WIN_THREADS) {
    const int i = e / dh, d = e - i * dh;
    const size_t pix = pix0 + (size_t)(i / window) * W + (i % window);
    const T* r = qkv + pix * ld + (size_t)h * dh + d;
    Qs[e] = to_f(r[0]);
    Ks[i * ks + d] = to_f(r[C]);
    Vs[e] = to_f(r[2 * C]);
  }
  __syncthreads();

  // scores: one (query, key) pair per thread and step; a warp's pairs share
  // one or two query rows (broadcast reads) and walk consecutive padded K rows
  const float* bias_h = bias + (size_t)h * t * t;
  const float* mask_w = mask != nullptr ? mask + (size_t)win * t * t : nullptr;
  for (int e = tid; e < t * t; e += WIN_THREADS) {
    const int i = e / t, j = e - i * t;
    const float4* q4 = reinterpret_cast<const float4*>(Qs + (size_t)i * dh);
    const float4* k4 = reinterpret_cast<const float4*>(Ks + (size_t)j * ks);
    float acc = 0.f;
    for (int c = 0; c < nd4; ++c) {
      const float4 qv = q4[c], kv = k4[c];
      acc = fmaf(qv.x, kv.x, acc);
      acc = fmaf(qv.y, kv.y, acc);
      acc = fmaf(qv.z, kv.z, acc);
      acc = fmaf(qv.w, kv.w, acc);
    }
    // scale, then add: no contraction into one fma, as the plain version rounds
    float s = __fmul_rn(acc, scale) + bias_h[e];
    if (mask_w != nullptr) s += mask_w[e];
    S[e] = s;
  }
  __syncthreads();

  // softmax: one warp per query row
  for (int i = warp; i < t; i += WIN_THREADS / 32) {
    float* s = S + (size_t)i * t;
    float mx = 0.f;
    if (!fast) {
      mx = -INFINITY;
      for (int j = lane; j < t; j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
    }
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float p = fast ? expf(fminf(s[j], 80.f)) : expf(s[j] - mx);
      s[j] = p;
      sum += p;
    }
    const float r = 1.f / warp_sum(sum);
    if (lane == 0) rinv[i] = r;
    if (emit) {
      T* prow = probs + ((((size_t)b * nwin + win) * heads + h) * t + i) * t;
      for (int j = lane; j < t; j += 32) {
        const T pb = from_f<T>(s[j] * r);
        prow[j] = pb;
        s[j] = to_f(pb);  // PV consumes the cast probs
      }
    } else {
      for (int j = lane; j < t; j += 32) s[j] = to_f(from_f<T>(s[j]));
    }
  }
  __syncthreads();

  // o = P V: one (query row, 4 columns) per thread and step
  for (int e = tid; e < t * nd4; e += WIN_THREADS) {
    const int i = e / nd4, c = e - i * nd4;
    const float* s = S + (size_t)i * t;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < t; ++j) {
      const float p = s[j];
      const float4 v = reinterpret_cast<const float4*>(Vs + (size_t)j * dh)[c];
      acc.x = fmaf(p, v.x, acc.x);
      acc.y = fmaf(p, v.y, acc.y);
      acc.z = fmaf(p, v.z, acc.z);
      acc.w = fmaf(p, v.w, acc.w);
    }
    if (!emit) {
      const float r = rinv[i];
      acc.x *= r;
      acc.y *= r;
      acc.z *= r;
      acc.w *= r;
    }
    const size_t pix = pix0 + (size_t)(i / window) * W + (i % window);
    T* out = o + pix * C + (size_t)h * dh + 4 * c;
    out[0] = from_f<T>(acc.x);
    out[1] = from_f<T>(acc.y);
    out[2] = from_f<T>(acc.z);
    out[3] = from_f<T>(acc.w);
  }
}

template <typename T>
int launch(const void* y, const void* qkv_w, const void* qkv_b, const void* proj_w,
           const void* proj_b, const float* bias, const float* mask, void* qkv_ws, void* o_ws,
           void* a, void* probs, int B, int H, int W, int C, int heads, int window, float scale,
           int fast, cudaStream_t stream) {
  const int M = B * H * W;
  cudaError_t err = launch_linear<T>((const T*)y, (const T*)qkv_w, (const T*)qkv_b, (T*)qkv_ws,
                                     M, C, 3 * C, stream);
  if (err != cudaSuccess) return (int)err;

  const int t = window * window;
  const size_t smem = window_smem_floats(t, C / heads) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(window_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H / window) * (W / window), heads, B);
  window_attention_kernel<T><<<grid, WIN_THREADS, smem, stream>>>(
      (const T*)qkv_ws, bias, mask, (T*)o_ws, (T*)probs, H, W, C, heads, window, scale, fast);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return (int)launch_linear<T>((const T*)o_ws, (const T*)proj_w, (const T*)proj_b, (T*)a, M, C,
                               C, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the window attention kernel for windows of t
// tokens and heads of dh columns, in bytes; ops/fused_window.py holds the
// same formula for its dispatch envelope and checks it after the build.
size_t ivt_window_smem_bytes(int t, int dh) { return window_smem_floats(t, dh) * sizeof(float); }

// dtype: 0 = float32, 1 = bfloat16. y, a [B, H, W, C] contiguous; qkv_w
// [C, 3C] with columns [3][heads][dh]; proj_w [C, C]; bias [heads, T, T]
// f32; mask [nW, T, T] f32 or null (unshifted blocks); workspaces
// (allocated by the caller) qkv_ws [B, H, W, 3C] and o_ws [B, H, W, C] in
// the dtype; probs [B, nW, heads, T, T] in the dtype or null (taps off).
// H and W are multiples of window. Returns a cudaError_t value.
int ivt_fused_window_attn(int dtype, const void* y, const void* qkv_w, const void* qkv_b,
                          const void* proj_w, const void* proj_b, const void* bias,
                          const void* mask, void* qkv_ws, void* o_ws, void* a, void* probs, int B,
                          int H, int W, int C, int heads, int window, float scale, int fast,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(y, qkv_w, qkv_b, proj_w, proj_b, (const float*)bias,
                         (const float*)mask, qkv_ws, o_ws, a, probs, B, H, W, C, heads, window,
                         scale, fast, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(y, qkv_w, qkv_b, proj_w, proj_b, (const float*)bias,
                                 (const float*)mask, qkv_ws, o_ws, a, probs, B, H, W, C, heads,
                                 window, scale, fast, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
