// Pieces shared by the hand-written attention kernels under csrc/:
// dtype conversion, warp reductions, the f32-FMA GEMM with the LN-prologue
// and residual-epilogue variants (and the plain one with only a bias), the
// deterministic head-mean pass, and a key-tiled attention kernel for
// sequences whose keys do not fit in shared memory. Each .cu file that
// includes this header builds into its own
// library (runtime/cuda_build.py hashes this header into every library
// name, so an edit here rebuilds them all).
//
// Everything lives in an anonymous namespace: each library gets its own
// copy and nothing is exported but the extern "C" entries of the .cu files.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// tanh GELU as torch's approximate="tanh" (and jax.nn.gelu(approximate=True))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// The in-kernel int8 quantizer of the W8A8 MLP and the s8 attention block
// (ops/quant.py quant_rows_mosaic / quant_cols_mosaic): the scale of a row
// or column is max|x| / 127 (1 where that is 0), and x rounds half up,
// floor(x / s + 0.5), with a true f32 division and no contraction, clipped
// to [-127, 127].
__device__ __forceinline__ float quant_scale(float absmax) {
  const float s = __fdiv_rn(absmax, 127.f);
  return s == 0.f ? 1.f : s;
}

__device__ __forceinline__ int quant_half_up(float x, float s) {
  const float q = floorf(__fadd_rn(__fdiv_rn(x, s), 0.5f));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// Four int8 values, k to k + 3, packed into one word for __dp4a (k in the
// low byte).
__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (int)((unsigned)(b0 & 0xff) | ((unsigned)(b1 & 0xff) << 8) |
               ((unsigned)(b2 & 0xff) << 16) | ((unsigned)(b3 & 0xff) << 24));
}

// Shared memory one block may use on an H100 (227 KB).
constexpr size_t SMEM_LIMIT = 232448;

// ---------------------------------------------------------------------------
// out[M, Nc] = A'[M, K] @ W[K, Nc] (+ epilogue).
// LN=true:   A' = cast_T(LN(A) * ln_s + ln_b) with f32 row statistics; else A' = A.
// RES=true:  out = (res + acc) + bias; else out = acc + bias. All in f32, then cast.
// The attention blocks use <LN, !RES> for QKV and <!LN, RES> for the
// projection; the window attention uses <!LN, !RES> for both.
// 64 x 64 output tile per block, 256 threads, 4 x 4 outputs per thread.
constexpr int TM = 64, TN = 64, TK = 16, GEMM_THREADS = 256;

template <typename T, bool LN, bool RES = !LN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W, const T* __restrict__ bias,
            const T* __restrict__ ln_s, const T* __restrict__ ln_b, const T* __restrict__ res,
            T* __restrict__ out, int M, int K, int Nc, float eps) {
  __shared__ float As[TK][TM + 4];
  __shared__ float Ws[TK][TN + 4];
  __shared__ float row_mean[TM];
  __shared__ float row_rstd[TM];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  if (LN) {
    // two-pass f32 statistics, one warp per row
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < TM; r += GEMM_THREADS / 32) {
      const int row = row0 + r;
      float mean = 0.f, rstd = 0.f;
      if (row < M) {
        const T* xr = A + (size_t)row * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += to_f(xr[k]);
        mean = warp_sum(s) / (float)K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = to_f(xr[k]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / (float)K + eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int i = 0; i < (TM * TK) / GEMM_THREADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int m = e / TK, kk = e % TK;
      const int row = row0 + m, k = k0 + kk;
      float v = 0.f;
      if (row < M && k < K) {
        v = to_f(A[(size_t)row * K + k]);
        if (LN) {
          // LN output is cast to the activation dtype before the product
          v = to_f(from_f<T>((v - row_mean[m]) * row_rstd[m] * to_f(ln_s[k]) + to_f(ln_b[k])));
        }
      }
      As[kk][m] = v;
    }
#pragma unroll
    for (int i = 0; i < (TK * TN) / GEMM_THREADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int kk = e / TN, n = e % TN;
      const int k = k0 + kk, col = col0 + n;
      Ws[kk][n] = (k < K && col < Nc) ? to_f(W[(size_t)k * Nc + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = Ws[kk][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx * 4 + c;
      if (col >= Nc) continue;
      const size_t idx = (size_t)row * Nc + col;
      float v = acc[r][c];
      if (RES) {
        v = (to_f(res[idx]) + v) + to_f(bias[col]);
      } else {
        v = v + to_f(bias[col]);
      }
      out[idx] = from_f<T>(v);
    }
  }
}

// y[B*N, D] = (x + o @ proj_w) + proj_b: the output projection with the
// residual, on the caller's stream.
template <typename T>
cudaError_t launch_proj_residual(const T* o, const T* proj_w, const T* proj_b, const T* x, T* y,
                                 int M, int D, cudaStream_t stream) {
  const dim3 grid((D + TN - 1) / TN, (M + TM - 1) / TM);
  gemm_kernel<T, false><<<grid, GEMM_THREADS, 0, stream>>>(o, proj_w, proj_b, nullptr, nullptr,
                                                           x, y, M, D, D, 0.f);
  return cudaGetLastError();
}

// out[M, Nc] = A[M, K] @ W[K, Nc] + bias: no LayerNorm, no residual.
template <typename T>
cudaError_t launch_linear(const T* a, const T* w, const T* bias, T* out, int M, int K, int Nc,
                          cudaStream_t stream) {
  const dim3 grid((Nc + TN - 1) / TN, (M + TM - 1) / TM);
  gemm_kernel<T, false, false><<<grid, GEMM_THREADS, 0, stream>>>(a, w, bias, nullptr, nullptr,
                                                                  nullptr, out, M, K, Nc, 0.f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head-mean of f32 per-head probs [B, H, N*N], summed in head order (the
// order of the JAX kernels' accumulators), times 1/H, cast to T. No atomics,
// so the result does not depend on the order blocks run in.
template <typename T>
__global__ void head_mean_kernel(const float* __restrict__ head_probs, T* __restrict__ mean,
                                 int B, int H, int NN, float inv_heads) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * NN) return;
  const size_t b = idx / NN, k = idx % NN;
  const float* p = head_probs + b * H * NN + k;
  float s = p[0];
  for (int h = 1; h < H; ++h) s += p[(size_t)h * NN];
  mean[idx] = from_f<T>(s * inv_heads);
}

template <typename T>
cudaError_t launch_head_mean(const float* head_probs, T* mean, int B, int H, int N, float inv_heads,
                             cudaStream_t stream) {
  const size_t total = (size_t)B * N * N;
  head_mean_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(head_probs, mean, B, H,
                                                                          N * N, inv_heads);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ToMe's key metric (the fused block's kernel E): the head-meaned keys of
// the qkv workspace [rows, 3D], metric[row, c] = (sum over heads 0..H-1 in
// order of k) * inv_heads in f32, each add and the product rounded on its
// own; one (row, column) of [rows, dh] per thread.
template <typename T>
__global__ void key_mean_kernel(const T* __restrict__ qkv, float* __restrict__ metric, int rows,
                                int D, int H, float inv_heads) {
  const int dh = D / H;
  const size_t total = (size_t)rows * dh;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const T* k = qkv + (e / dh) * 3 * (size_t)D + D + e % dh;
    float acc = to_f(k[0]);
    for (int h = 1; h < H; ++h) acc = __fadd_rn(acc, to_f(k[(size_t)h * dh]));
    metric[e] = __fmul_rn(acc, inv_heads);
  }
}

template <typename T>
cudaError_t launch_key_mean(const T* qkv, float* metric, int rows, int D, int H, float inv_heads,
                            cudaStream_t stream) {
  const size_t total = (size_t)rows * (D / H);
  key_mean_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(qkv, metric, rows, D,
                                                                          H, inv_heads);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Key-tiled attention: one block per (query tile of QTILE rows, head, image).
//
//   1. scores  S[QTILE][N] = scale * Q K^T in f32, K staged one tile of 64
//              keys at a time; keys >= n_real are set to mask_value
//   2. softmax one warp per row over the whole row in shared memory:
//              fast   p = exp(min(s, 80)), no max subtraction
//              exact  p = exp(s - rowmax)
//              then normalised-and-cast (norm) or only cast (!norm), the
//              probs tap and the f32 head-mean input written on the way
//   3. o = P V with V staged one tile of 64 keys at a time; the !norm form
//              multiplies the f32 sum by the reciprocal row sum at the end
//
// Only the score rows of the block's query tile stay resident (QTILE x N
// f32), so the shared memory grows with N and not with N^2 or with the keys'
// width; QTILE = 32 while that fits the card's 227 KB, else 16.
constexpr int KT = 64, TILED_THREADS = 256, TILED_MAX_ROWS = 4, TILED_MAX_DH = 128;
constexpr int SOFTMAX_FAST = 0;       // exp(min(s, 80)); probs = p * (1 / sum)
constexpr int SOFTMAX_EXACT_MUL = 1;  // exp(s - max);    probs = p * (1 / sum)
constexpr int SOFTMAX_EXACT_DIV = 2;  // exp(s - max);    probs = p / sum

struct TiledAttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of image, head and token; the head dim is contiguous
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  void* probs;         // [B, H, N, N] in T, or null
  float* head_probs;   // [B, H, N, N] f32 (the head-mean's input), or null
  int H, N, dh, n_real;
  float scale, mask_value;
  int softmax, norm;
};

__host__ __device__ inline size_t tiled_smem_floats(int n, int dh, int qt) {
  // S [qt][n] + Q [qt][dh] + one K or V tile [KT][dh + 4] + 1/rowsum [qt];
  // qt * n is a multiple of 16 floats, so Q and the tile start 16-byte aligned
  return (size_t)qt * n + (size_t)qt * dh + (size_t)KT * (dh + 4) + qt;
}

// The query tile the kernel uses for (n, dh), or 0 where it does not run.
__host__ __device__ inline int tiled_query_tile(int n, int dh) {
  if (n <= 0 || dh <= 0 || dh % 4 != 0 || dh > TILED_MAX_DH) return 0;
  if (tiled_smem_floats(n, dh, 32) * sizeof(float) <= SMEM_LIMIT) return 32;
  if (tiled_smem_floats(n, dh, 16) * sizeof(float) <= SMEM_LIMIT) return 16;
  return 0;
}

template <typename T, int QTILE>
__global__ void __launch_bounds__(TILED_THREADS) tiled_attention_kernel(const TiledAttnArgs a) {
  extern __shared__ float4 tiled_smem4[];
  const int N = a.N, dh = a.dh, nd4 = dh / 4, ks = dh + 4;
  float* S = reinterpret_cast<float*>(tiled_smem4);
  float* Qs = S + (size_t)QTILE * N;
  float* Ts = Qs + QTILE * dh;  // the K tile, then the V tile
  float* rinv = Ts + KT * ks;

  const int q0 = blockIdx.x * QTILE, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(QTILE, N - q0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  for (int e = tid; e < QTILE * dh; e += TILED_THREADS) {
    const int i = e / dh, d = e - i * dh;
    Qs[e] = (i < rows) ? to_f(qb[(q0 + i) * a.q_sn + d]) : 0.f;
  }

  // 1. scores: thread (jj, rg) takes key jj of the tile against RPT query
  // rows; a warp shares rg, so its Q reads broadcast, and the padded K rows
  // (dh + 4 floats) put 8 consecutive keys' float4 reads on distinct banks
  constexpr int RG = TILED_THREADS / KT, RPT = QTILE / RG;
  const int jj = tid % KT, rg = tid / KT;
  for (int j0 = 0; j0 < N; j0 += KT) {
    const int kn = min(KT, N - j0);
    __syncthreads();  // Q written / the previous tile consumed
    for (int e = tid; e < kn * dh; e += TILED_THREADS) {
      const int j = e / dh, d = e - j * dh;
      Ts[j * ks + d] = to_f(kb[(j0 + j) * a.k_sn + d]);
    }
    __syncthreads();
    if (jj < kn) {
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
      const float4* k4 = reinterpret_cast<const float4*>(Ts + jj * ks);
      for (int c = 0; c < nd4; ++c) {
        const float4 kv = k4[c];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 qv = reinterpret_cast<const float4*>(Qs + (rg * RPT + r) * dh)[c];
          acc[r] = fmaf(qv.x, kv.x, acc[r]);
          acc[r] = fmaf(qv.y, kv.y, acc[r]);
          acc[r] = fmaf(qv.z, kv.z, acc[r]);
          acc[r] = fmaf(qv.w, kv.w, acc[r]);
        }
      }
      const int j = j0 + jj;
      const bool live = j < a.n_real;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = rg * RPT + r;
        if (i < rows) S[(size_t)i * N + j] = live ? acc[r] * a.scale : a.mask_value;
      }
    }
  }
  __syncthreads();

  // 2. softmax, one warp per query row
  for (int i = warp; i < rows; i += TILED_THREADS / 32) {
    float* s = S + (size_t)i * N;
    float mx = 0.f;
    if (a.softmax != SOFTMAX_FAST) {
      mx = -INFINITY;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
    }
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = a.softmax == SOFTMAX_FAST ? expf(fminf(s[j], 80.f)) : expf(s[j] - mx);
      s[j] = p;
      sum += p;
    }
    const float l = warp_sum(sum);
    const float r = 1.f / l;
    if (lane == 0) rinv[i] = r;
    if (a.norm) {
      const size_t row = ((size_t)(b * a.H + h) * N + q0 + i) * N;
      T* prow = a.probs != nullptr ? static_cast<T*>(a.probs) + row : nullptr;
      float* hrow = a.head_probs != nullptr ? a.head_probs + row : nullptr;
      for (int j = lane; j < N; j += 32) {
        const float pr = a.softmax == SOFTMAX_EXACT_DIV ? s[j] / l : s[j] * r;
        const T pb = from_f<T>(pr);
        if (prow != nullptr) prow[j] = pb;
        if (hrow != nullptr) hrow[j] = pr;
        s[j] = to_f(pb);  // PV consumes the cast probs
      }
    } else {
      for (int j = lane; j < N; j += 32) s[j] = to_f(from_f<T>(s[j]));
    }
  }

  // 3. o = P V: thread takes column group c (4 columns) of query rows
  // i0, i0 + istep, ...; every V float4 it reads feeds all its rows
  const int istep = TILED_THREADS / nd4;
  const int c = tid % nd4, i0 = tid / nd4;
  const bool active = i0 < istep;  // idle threads when nd4 does not divide the block
  float4 acc[TILED_MAX_ROWS];
#pragma unroll
  for (int u = 0; u < TILED_MAX_ROWS; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < N; j0 += KT) {
    const int kn = min(KT, N - j0);
    __syncthreads();  // softmax done / the previous tile consumed
    for (int e = tid; e < kn * dh; e += TILED_THREADS) {
      const int j = e / dh, d = e - j * dh;
      Ts[j * ks + d] = to_f(vb[(j0 + j) * a.v_sn + d]);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < kn; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(Ts + j * ks)[c];
#pragma unroll
        for (int u = 0; u < TILED_MAX_ROWS; ++u) {
          const int i = i0 + u * istep;
          if (i < rows) {
            const float p = S[(size_t)i * N + j0 + j];
            acc[u].x = fmaf(p, vv.x, acc[u].x);
            acc[u].y = fmaf(p, vv.y, acc[u].y);
            acc[u].z = fmaf(p, vv.z, acc[u].z);
            acc[u].w = fmaf(p, vv.w, acc[u].w);
          }
        }
      }
    }
  }
  if (!active) return;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int u = 0; u < TILED_MAX_ROWS; ++u) {
    const int i = i0 + u * istep;
    if (i >= rows) continue;
    float4 v = acc[u];
    if (!a.norm) {
      const float r = rinv[i];
      v.x *= r;
      v.y *= r;
      v.z *= r;
      v.w *= r;
    }
    T* out = ob + (q0 + i) * a.o_sn + 4 * c;
    out[0] = from_f<T>(v.x);
    out[1] = from_f<T>(v.y);
    out[2] = from_f<T>(v.z);
    out[3] = from_f<T>(v.w);
  }
}

template <typename T>
cudaError_t launch_tiled_attention(const TiledAttnArgs& a, int B, cudaStream_t stream) {
  const int qt = tiled_query_tile(a.N, a.dh);
  if (qt == 0) return cudaErrorInvalidValue;
  const size_t smem = tiled_smem_floats(a.N, a.dh, qt) * sizeof(float);
  const dim3 grid((a.N + qt - 1) / qt, a.H, B);
  cudaError_t err;
  if (qt == 32) {
    err = cudaFuncSetAttribute(tiled_attention_kernel<T, 32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    tiled_attention_kernel<T, 32><<<grid, TILED_THREADS, smem, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(tiled_attention_kernel<T, 16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    tiled_attention_kernel<T, 16><<<grid, TILED_THREADS, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the key-tiled attention kernel for n keys of
// width dh, in bytes, or 0 where it does not run. ops/tiled_attention.py
// holds the same formula for the dispatch envelopes and checks it against
// this one after each build. (Every library is one translation unit, so
// each defines this entry once.)
extern "C" size_t ivt_tiled_smem_bytes(int n, int dh) {
  const int qt = tiled_query_tile(n, dh);
  return qt ? tiled_smem_floats(n, dh, qt) * sizeof(float) : 0;
}
