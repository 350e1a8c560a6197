// Fused ViT attention block for Hopper (sm_90a):
//     y = x + proj(MHSA(LN1(x))), with optional per-head probs and head-mean.
//
// Replaces the Pallas TPU kernel interactive_vit_tpu/ops/fused_block.py::
// fused_attn_block (_kernel, _row_softmax). Numerics follow its cast points:
// f32 LayerNorm statistics, LN output cast to the activation dtype T, QKV
// f32-accumulated and cast to T, scores and softmax in f32 (fast form:
// exp(min(s, 80)) with the normalisation deferred), probs cast to T before
// the PV product when they are emitted, head outputs cast to T, and the
// projection f32-accumulated with the residual added in f32.
//
// What bounds it on this card: at the served shapes (N=197, D=768, B<=8)
// the three products are ~1.4 GFLOP per image and the bytes are small
// (weights 3.4 MB bf16, activations < 1 MB), so the kernel is bound by
// arithmetic issue and, at batch 1, by how many of the 132 SMs its grids
// fill -- not by HBM. This version does every product with f32 FMA from
// shared memory (no tensor cores), so it runs far below the card's bf16
// peak. What the design does about it: the N x N scores and probabilities
// stay in shared memory (only the requested probs taps and the head-mean
// inputs reach device memory); the attention grid spans query tiles x
// heads x images (84 blocks for one vit_b16 image) with register-tiled
// float4 inner loops; the head-mean is a separate pass that sums the heads
// in a fixed order, so it stays deterministic without atomics. Moving the
// products onto wgmma/mma tiles is later work.
//
// The s8 mode (the TPU kernel's int8_scores / int8_pv, --attn int8-scores)
// changes only kernel B: per head, q and k rows and (with int8_pv) the
// probs rows and v columns are quantized in shared memory with the half-up
// quantizer of ops/quant.py, packed four to a word, and the two products
// are s8 x s8 -> s32 __dp4a sums rescaled in f32 (attention_kernel's
// comment has the order). LN1 + QKV and proj stay the dense GEMMs. The s32
// sums are exact, so the kernel departs from its plain version only where
// a qkv element or a probability lands on the other side of a rounding
// boundary.
//
//   Kernel A  gemm<T, LN=true>   LN1 (f32 row stats in shared memory)
//                                + qkv = LN(x) @ qkv_w + qkv_b -> workspace
//   Kernel B  attention<T>       one block per (query-row tile, head,
//                                image): scores, softmax, probs taps, f32
//                                probs for the mean, o_h = P V -> workspace
//   Kernel D  head_mean<T>       mean over heads of the f32 probs (only
//                                when the head-mean is asked for)
//   Kernel C  gemm<T, LN=false>  y = (x + o @ proj_w) + proj_b
//
// Kernels A, C and D live in common.cuh, shared with the headwise block.
// Plain C interface, bound from Python with ctypes; every launch goes on
// the caller's stream and the entry returns cudaGetLastError().

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Kernel B: attention for one (query-row tile, head, image).
constexpr int QT = 32, ATT_THREADS = 256;

__host__ __device__ inline size_t attn_smem_floats(int n, int dh) {
  // K [n][dh+4] + V [n][dh] + Q [QT][dh] + S [QT][n]; rows of K, V and Q
  // start on 16-byte boundaries (dh % 4 == 0) for float4 reads
  return (size_t)n * (dh + 4) + (size_t)n * dh + (size_t)QT * dh + (size_t)QT * n;
}

// The s8 mode's word arrays: an odd stride puts the rows that 32 threads
// read at once on 32 distinct banks.
__host__ __device__ inline int odd_words(int words) { return words | 1; }

__host__ __device__ inline size_t attn_s8_extra_bytes(int n, int dh) {
  // q words [QT][dh/4], k words [n][odd(dh/4)], v words transposed
  // [dh][odd(ceil(n/4))], p words [QT][ceil(n/4)], and the f32 scales of q
  // rows, k rows, v columns and p rows
  const int nw = (n + 3) / 4;
  return 4 * ((size_t)QT * (dh / 4) + (size_t)n * odd_words(dh / 4) +
              (size_t)dh * odd_words(nw) + (size_t)QT * nw + QT + n + dh + QT);
}

// S8: the s8 mode of the TPU kernel (int8_scores): q and k quantized per
// row (ops/quant.py quant_rows_mosaic, half up), the score an s8 x s8 -> s32
// __dp4a sum rescaled as si.f32 * (qs * scale) * ks; with int8_pv the PV
// product too, on probs (maps on: normalised; off: the unnormalised fast p)
// quantized per row and v per column, rescaled as oi.f32 * ps * vs (maps
// off: oi.f32 * (ps * r) * vs). Without int8_pv the PV product is dense.
template <typename T, bool S8>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ o, T* __restrict__ probs,
                 float* __restrict__ head_probs, int N, int D, int H, float scale, int fast,
                 unsigned long long emit_mask, int n_emit, int int8_pv) {
  extern __shared__ float4 smem4[];
  __shared__ float rinv[QT];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dh = D / H, nd4 = dh / 4;
  const int ks = dh + 4;  // padded K rows: float4 reads of 8 keys hit distinct banks
  float* Ks = smem;
  float* Vs = Ks + (size_t)N * ks;
  float* Qs = Vs + (size_t)N * dh;
  float* S = Qs + (size_t)QT * dh;
  // s8 mode only: word arrays and scales after S
  const int kw = odd_words(nd4), nw = (N + 3) / 4, vw = odd_words(nw);
  int* Qw = reinterpret_cast<int*>(S + (size_t)QT * N);
  int* Kw = Qw + QT * nd4;
  int* Vw = Kw + (size_t)N * kw;
  int* Pw = Vw + (size_t)dh * vw;
  float* q_sc = reinterpret_cast<float*>(Pw + QT * nw);
  float* k_sc = q_sc + QT;
  float* v_sc = k_sc + N;
  float* p_sc = v_sc + dh;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(QT, N - q0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t ld = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * N * ld + (size_t)h * dh;
  const bool emit_h = (emit_mask >> h) & 1ULL;
  const bool want_mean = head_probs != nullptr;
  // heads whose probs are emitted (or feed the mean) are normalised before
  // PV; the others fold the reciprocal row sum into the [N, dh] output
  const bool norm_h = emit_h || want_mean;
  const bool pv8 = S8 && int8_pv;
  const int tap = __popcll(emit_mask & ((1ULL << h) - 1ULL));

  for (int e = tid; e < N * dh; e += ATT_THREADS) {
    const int j = e / dh, d = e % dh;
    const T* r = base + (size_t)j * ld + d;
    Ks[j * ks + d] = to_f(r[D]);
    Vs[e] = to_f(r[2 * D]);
  }
  for (int e = tid; e < QT * dh; e += ATT_THREADS) {
    const int i = e / dh, d = e % dh;
    Qs[e] = (i < rows) ? to_f(base[(size_t)(q0 + i) * ld + d]) : 0.f;
  }
  __syncthreads();

  if constexpr (S8) {
    // q rows (zero rows beyond the tile quantize to 0) and k rows, one warp
    // per row; v columns, one thread per column
    int8_t* Qb = reinterpret_cast<int8_t*>(Qw);
    int8_t* Kb = reinterpret_cast<int8_t*>(Kw);
    int8_t* Vb = reinterpret_cast<int8_t*>(Vw);
    for (int r = warp; r < QT + N; r += ATT_THREADS / 32) {
      const bool is_q = r < QT;
      const float* src = is_q ? Qs + r * dh : Ks + (size_t)(r - QT) * ks;
      float mx = 0.f;
      for (int d = lane; d < dh; d += 32) mx = fmaxf(mx, fabsf(src[d]));
      const float sc = quant_scale(warp_max(mx));
      int8_t* dst = is_q ? Qb + (size_t)r * dh : Kb + (size_t)(r - QT) * kw * 4;
      for (int d = lane; d < dh; d += 32) dst[d] = (int8_t)quant_half_up(src[d], sc);
      if (lane == 0) (is_q ? q_sc[r] : k_sc[r - QT]) = sc;
    }
    if (pv8) {
      for (int c = tid; c < dh; c += ATT_THREADS) {
        float mx = 0.f;
        for (int j = 0; j < N; ++j) mx = fmaxf(mx, fabsf(Vs[(size_t)j * dh + c]));
        const float sc = quant_scale(mx);
        v_sc[c] = sc;
        int8_t* dst = Vb + (size_t)c * vw * 4;
        for (int j = 0; j < 4 * nw; ++j)
          dst[j] = j < N ? (int8_t)quant_half_up(Vs[(size_t)j * dh + c], sc) : (int8_t)0;
      }
    }
    __syncthreads();

    // scores: one key per thread against all QT query rows (Q words broadcast)
    for (int j = tid; j < N; j += ATT_THREADS) {
      int acc[QT];
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] = 0;
      const int* kr = Kw + (size_t)j * kw;
      for (int c = 0; c < nd4; ++c) {
        const int kv = kr[c];
#pragma unroll
        for (int i = 0; i < QT; ++i) acc[i] = __dp4a(Qw[i * nd4 + c], kv, acc[i]);
      }
      const float ksj = k_sc[j];
#pragma unroll
      for (int i = 0; i < QT; ++i)
        if (i < rows) S[i * N + j] = __fmul_rn(__fmul_rn((float)acc[i], __fmul_rn(q_sc[i], scale)), ksj);
    }
  } else {
    // scores: one key per thread against all QT query rows (Q reads broadcast)
    for (int j = tid; j < N; j += ATT_THREADS) {
      float acc[QT];
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] = 0.f;
      const float4* k4 = reinterpret_cast<const float4*>(Ks + (size_t)j * ks);
      for (int c = 0; c < nd4; ++c) {
        const float4 kv = k4[c];
#pragma unroll
        for (int i = 0; i < QT; ++i) {
          const float4 qv = reinterpret_cast<const float4*>(Qs + i * dh)[c];
          acc[i] = fmaf(qv.x, kv.x, acc[i]);
          acc[i] = fmaf(qv.y, kv.y, acc[i]);
          acc[i] = fmaf(qv.z, kv.z, acc[i]);
          acc[i] = fmaf(qv.w, kv.w, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < QT; ++i)
        if (i < rows) S[i * N + j] = acc[i] * scale;
    }
  }
  __syncthreads();

  // softmax: one warp per query row
  for (int i = warp; i < rows; i += ATT_THREADS / 32) {
    float* s = S + i * N;
    float mx = 0.f;
    if (!fast) {
      mx = -INFINITY;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
    }
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = fast ? expf(fminf(s[j], 80.f)) : expf(s[j] - mx);
      s[j] = p;
      sum += p;
    }
    const float r = 1.f / warp_sum(sum);
    if (lane == 0) rinv[i] = r;
    if (norm_h) {
      T* prow = emit_h ? probs + (((size_t)b * n_emit + tap) * N + q0 + i) * N : nullptr;
      float* hrow = want_mean ? head_probs + (((size_t)b * H + h) * N + q0 + i) * N : nullptr;
      for (int j = lane; j < N; j += 32) {
        const float pr = s[j] * r;
        const T pb = from_f<T>(pr);
        if (emit_h) prow[j] = pb;
        if (want_mean) hrow[j] = pr;  // f32 probs, summed over heads by kernel D
        s[j] = pv8 ? pr : to_f(pb);   // PV consumes the cast probs (s8: the f32 ones)
      }
    } else if (!pv8) {
      for (int j = lane; j < N; j += 32) s[j] = to_f(from_f<T>(s[j]));
    }
    if (pv8) {
      // the row's probs (maps on) or unnormalised p (maps off), per row
      float pm = 0.f;
      for (int j = lane; j < N; j += 32) pm = fmaxf(pm, fabsf(s[j]));
      const float sc = quant_scale(warp_max(pm));
      if (lane == 0) p_sc[i] = sc;
      int8_t* dst = reinterpret_cast<int8_t*>(Pw + (size_t)i * nw);
      for (int j = lane; j < 4 * nw; j += 32)
        dst[j] = j < N ? (int8_t)quant_half_up(s[j], sc) : (int8_t)0;
    }
  }
  __syncthreads();

  if (pv8) {
    // o = P V in s8: one (query row, column) per thread
    for (int e = tid; e < rows * dh; e += ATT_THREADS) {
      const int i = e / dh, c = e % dh;
      const int* pr = Pw + (size_t)i * nw;
      const int* vr = Vw + (size_t)c * vw;
      int acc = 0;
      for (int w = 0; w < nw; ++w) acc = __dp4a(pr[w], vr[w], acc);
      const float ps = norm_h ? p_sc[i] : __fmul_rn(p_sc[i], rinv[i]);
      o[((size_t)b * N + q0 + i) * D + (size_t)h * dh + c] =
          from_f<T>(__fmul_rn(__fmul_rn((float)acc, ps), v_sc[c]));
    }
    return;
  }

  // o = P V: one (query row, 4 columns) per thread
  for (int e = tid; e < rows * nd4; e += ATT_THREADS) {
    const int i = e / nd4, c = e % nd4;
    const float* s = S + i * N;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < N; ++j) {
      const float p = s[j];
      const float4 v = reinterpret_cast<const float4*>(Vs + (size_t)j * dh)[c];
      acc.x = fmaf(p, v.x, acc.x);
      acc.y = fmaf(p, v.y, acc.y);
      acc.z = fmaf(p, v.z, acc.z);
      acc.w = fmaf(p, v.w, acc.w);
    }
    if (!norm_h) {
      const float r = rinv[i];
      acc.x *= r;
      acc.y *= r;
      acc.z *= r;
      acc.w *= r;
    }
    T* out = o + ((size_t)b * N + q0 + i) * D + (size_t)h * dh + 4 * c;
    out[0] = from_f<T>(acc.x);
    out[1] = from_f<T>(acc.y);
    out[2] = from_f<T>(acc.z);
    out[3] = from_f<T>(acc.w);
  }
}

template <typename T, bool S8>
cudaError_t launch_attention(const T* qkv_ws, T* o_ws, T* probs, float* head_probs, int B, int N,
                             int D, int H, float scale, int fast, unsigned long long emit_mask,
                             int n_emit, int int8_pv, cudaStream_t stream) {
  const int dh = D / H;
  const size_t smem = attn_smem_floats(N, dh) * sizeof(float) + (S8 ? attn_s8_extra_bytes(N, dh) : 0);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, S8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + QT - 1) / QT, H, B);
  attention_kernel<T, S8><<<grid, ATT_THREADS, smem, stream>>>(
      qkv_ws, o_ws, probs, head_probs, N, D, H, scale, fast, emit_mask, n_emit, int8_pv);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* ln_s, const void* ln_b, const void* qkv_w,
           const void* qkv_b, const void* proj_w, const void* proj_b, void* qkv_ws, void* o_ws,
           void* probs_ws, void* y, void* probs, void* mean, int B, int N, int D, int H,
           float eps, float scale, float inv_heads, int fast, unsigned long long emit_mask,
           int n_emit, int int8_mode, cudaStream_t stream) {
  const int M = B * N;
  const dim3 grid_a((3 * D + TN - 1) / TN, (M + TM - 1) / TM);
  gemm_kernel<T, true><<<grid_a, GEMM_THREADS, 0, stream>>>(
      (const T*)x, (const T*)qkv_w, (const T*)qkv_b, (const T*)ln_s, (const T*)ln_b, nullptr,
      (T*)qkv_ws, M, D, 3 * D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = int8_mode == 0
            ? launch_attention<T, false>((const T*)qkv_ws, (T*)o_ws, (T*)probs,
                                         mean ? (float*)probs_ws : nullptr, B, N, D, H, scale,
                                         fast, emit_mask, n_emit, 0, stream)
            : launch_attention<T, true>((const T*)qkv_ws, (T*)o_ws, (T*)probs,
                                        mean ? (float*)probs_ws : nullptr, B, N, D, H, scale,
                                        fast, emit_mask, n_emit, int8_mode == 2, stream);
  if (err != cudaSuccess) return (int)err;

  if (mean != nullptr) {
    err = launch_head_mean<T>((const float*)probs_ws, (T*)mean, B, H, N, inv_heads, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_proj_residual<T>((const T*)o_ws, (const T*)proj_w, (const T*)proj_b,
                                      (const T*)x, (T*)y, M, D, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the attention kernel, in bytes; the Python side
// holds the same formula for its dispatch envelope and checks it against
// this one after the build.
size_t ivt_attn_smem_bytes(int n, int dh) { return attn_smem_floats(n, dh) * sizeof(float); }

// What the s8 mode adds to it, in bytes.
size_t ivt_attn_s8_extra_bytes(int n, int dh) { return attn_s8_extra_bytes(n, dh); }

// dtype: 0 = float32, 1 = bfloat16. Workspaces (allocated by the caller):
// qkv_ws [B, N, 3D] and o_ws [B, N, D] in the dtype, probs_ws [B, H, N, N]
// f32 (only read when mean is given). probs / mean may be null (taps off).
// emit_mask: bit h set = head h's probs are written, to tap row
// popcount(emit_mask & ((1 << h) - 1)). int8_mode: 0 = dense, 1 = s8
// scores with a dense PV product, 2 = s8 scores and PV. Returns a
// cudaError_t value.
int ivt_fused_attn_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                         const void* qkv_w, const void* qkv_b, const void* proj_w,
                         const void* proj_b, void* qkv_ws, void* o_ws, void* probs_ws, void* y,
                         void* probs, void* mean, int B, int N, int D, int H, float eps,
                         float scale, float inv_heads, int fast, unsigned long long emit_mask,
                         int n_emit, int int8_mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (int8_mode < 0 || int8_mode > 2) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, qkv_ws, o_ws, probs_ws,
                         y, probs, mean, B, N, D, H, eps, scale, inv_heads, fast, emit_mask,
                         n_emit, int8_mode, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, qkv_ws, o_ws,
                                 probs_ws, y, probs, mean, B, N, D, H, eps, scale, inv_heads,
                                 fast, emit_mask, n_emit, int8_mode, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
