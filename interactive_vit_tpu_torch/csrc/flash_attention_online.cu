// Online-softmax flash attention for Hopper (sm_90a): o = softmax(q k^T /
// sqrt(dh)) v on q, k, v [B, H, N, dh] (any strides with a contiguous head
// dim), keys >= n_real masked out, no probs.
//
// Replaces the online branch of the Pallas TPU kernel
// interactive_vit_tpu/ops/flash_attention.py::flash_attention
// (_online_call, _online_kernel): the sequences above ROWFULL_MAX_N = 2048
// with maps off, where a row of scores per query no longer fits. Its
// numerics, per key tile of KT = 128 keys (the JAX kernel's block_k):
//   s = (q . k) * dh^-0.5 in f32; keys >= n_real set to -0.7 * f32 max and
//   their v rows zeroed;
//   m_next = max(m_prev, rowmax s), alpha = exp(m_prev - m_next), m from -inf;
//   p = exp(s - m_next), l = alpha * l + sum p;
//   acc = alpha * acc + p.to(T) @ v, accumulated in f32;
// and at the end o = acc / l, cast to T. In bf16 the result depends on the
// tile width through the cast of p against a running maximum, so the width
// is the JAX kernel's and the plain version takes it as a parameter. Every
// f32 update is an explicitly rounded multiply or add (no contraction).
//
// What differs from the row-resident kernel (common.cuh,
// tiled_attention_kernel): no [QT, N] score row is resident. A block keeps
// its 32 query rows, one K tile, one V tile, the tile's [32, 128] scores and
// the running (m, l, acc) in f32 -- so its shared memory does not grow with
// N (94 KB at dh = 64, two blocks per SM) and any N runs.
//
// What bounds it on this card: at dinov2_s14_reg@742 (N = 2814, 6 heads,
// dh = 64, B = 1, bf16) the work is 12.2 GFLOP over 8.6 MB, so at the
// card's published rates it is bound by operations (~12 us). This version
// does both products with f32 FMA from shared memory (no tensor cores), so
// it is bound by instruction issue far above that; one block per (query
// tile, head, image) gives 528 blocks, two waves of the 132 SMs at two
// blocks each. Tensor-core tiles are later work.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int OQT = 32, OKT = 128, O_THREADS = 256, O_WARPS = O_THREADS / 32, O_MAX_ROWS = 4,
              O_MAX_DH = 128;

__host__ __device__ inline size_t online_smem_floats(int dh) {
  // Q [OQT][dh] + K and V tiles [OKT][dh + 4] + S [OQT][OKT] + alpha, l [OQT]
  return (size_t)OQT * dh + 2 * (size_t)OKT * (dh + 4) + (size_t)OQT * OKT + 2 * OQT;
}

template <typename T>
__global__ void __launch_bounds__(O_THREADS) online_attention_kernel(const TiledAttnArgs a) {
  extern __shared__ float4 online_smem4[];
  const int N = a.N, dh = a.dh, nd4 = dh / 4, ks = dh + 4;
  float* Qs = reinterpret_cast<float*>(online_smem4);
  float* Ks = Qs + OQT * dh;
  float* Vs = Ks + OKT * ks;
  float* S = Vs + OKT * ks;
  float* alpha_s = S + OQT * OKT;
  float* l_s = alpha_s + OQT;

  const int q0 = blockIdx.x * OQT, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(OQT, N - q0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  for (int e = tid; e < OQT * dh; e += O_THREADS) {
    const int i = e / dh, d = e - i * dh;
    Qs[e] = (i < rows) ? to_f(qb[(q0 + i) * a.q_sn + d]) : 0.f;
  }

  // running row statistics: warp w owns rows w, w + 8, w + 16, w + 24, and
  // every lane holds the same value
  constexpr int RPW = OQT / O_WARPS;
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int u = 0; u < RPW; ++u) {
    m_run[u] = -INFINITY;
    l_run[u] = 0.f;
  }

  // the PV thread layout: column group c (4 columns) of rows i0, i0 + istep, ...
  const int istep = O_THREADS / nd4;
  const int c = tid % nd4, i0 = tid / nd4;
  const bool active = i0 < istep;  // idle threads when nd4 does not divide the block
  float4 acc[O_MAX_ROWS];
#pragma unroll
  for (int u = 0; u < O_MAX_ROWS; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the scores thread layout: key jj of the tile against RPT query rows; a
  // warp shares rg, so its Q reads broadcast, and the padded K rows put 8
  // consecutive keys' float4 reads on distinct banks
  constexpr int RG = O_THREADS / OKT, RPT = OQT / RG;
  const int jj = tid % OKT, rg = tid / OKT;

  for (int j0 = 0; j0 < N; j0 += OKT) {
    __syncthreads();  // Q written / the previous tile consumed
    for (int e = tid; e < OKT * dh; e += O_THREADS) {
      const int j = e / dh, d = e - j * dh, key = j0 + j;
      Ks[j * ks + d] = key < N ? to_f(kb[key * a.k_sn + d]) : 0.f;
      Vs[j * ks + d] = key < a.n_real ? to_f(vb[key * a.v_sn + d]) : 0.f;
    }
    __syncthreads();

    {
      float sacc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) sacc[r] = 0.f;
      const float4* k4 = reinterpret_cast<const float4*>(Ks + jj * ks);
      for (int cc = 0; cc < nd4; ++cc) {
        const float4 kv = k4[cc];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 qv = reinterpret_cast<const float4*>(Qs + (rg * RPT + r) * dh)[cc];
          sacc[r] = fmaf(qv.x, kv.x, sacc[r]);
          sacc[r] = fmaf(qv.y, kv.y, sacc[r]);
          sacc[r] = fmaf(qv.z, kv.z, sacc[r]);
          sacc[r] = fmaf(qv.w, kv.w, sacc[r]);
        }
      }
      const bool live = j0 + jj < a.n_real;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        S[(rg * RPT + r) * OKT + jj] = live ? __fmul_rn(sacc[r], a.scale) : a.mask_value;
    }
    __syncthreads();

    // the online softmax step, one warp per row
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const int i = warp + u * O_WARPS;
      float* s = S + i * OKT;
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < OKT / 32; ++t) mx = fmaxf(mx, s[lane + 32 * t]);
      const float m_next = fmaxf(m_run[u], warp_max(mx));
      const float alpha = expf(__fsub_rn(m_run[u], m_next));
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < OKT / 32; ++t) {
        const float p = expf(__fsub_rn(s[lane + 32 * t], m_next));
        sum += p;
        s[lane + 32 * t] = to_f(from_f<T>(p));  // PV consumes p cast to T
      }
      l_run[u] = __fadd_rn(__fmul_rn(alpha, l_run[u]), warp_sum(sum));
      m_run[u] = m_next;
      if (lane == 0) {
        alpha_s[i] = alpha;
        l_s[i] = l_run[u];
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ v for this tile
    if (active) {
      float4 t[O_MAX_ROWS];
#pragma unroll
      for (int u = 0; u < O_MAX_ROWS; ++u) t[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < OKT; ++j) {
        const float4 vv = reinterpret_cast<const float4*>(Vs + j * ks)[c];
#pragma unroll
        for (int u = 0; u < O_MAX_ROWS; ++u) {
          const int i = i0 + u * istep;
          if (i < OQT) {
            const float p = S[i * OKT + j];
            t[u].x = fmaf(p, vv.x, t[u].x);
            t[u].y = fmaf(p, vv.y, t[u].y);
            t[u].z = fmaf(p, vv.z, t[u].z);
            t[u].w = fmaf(p, vv.w, t[u].w);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < O_MAX_ROWS; ++u) {
        const int i = i0 + u * istep;
        if (i < OQT) {
          const float al = alpha_s[i];
          acc[u].x = __fadd_rn(__fmul_rn(acc[u].x, al), t[u].x);
          acc[u].y = __fadd_rn(__fmul_rn(acc[u].y, al), t[u].y);
          acc[u].z = __fadd_rn(__fmul_rn(acc[u].z, al), t[u].z);
          acc[u].w = __fadd_rn(__fmul_rn(acc[u].w, al), t[u].w);
        }
      }
    }
  }

  if (!active) return;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int u = 0; u < O_MAX_ROWS; ++u) {
    const int i = i0 + u * istep;
    if (i >= rows) continue;
    const float l = l_s[i];
    T* out = ob + (q0 + i) * a.o_sn + 4 * c;
    out[0] = from_f<T>(__fdiv_rn(acc[u].x, l));
    out[1] = from_f<T>(__fdiv_rn(acc[u].y, l));
    out[2] = from_f<T>(__fdiv_rn(acc[u].z, l));
    out[3] = from_f<T>(__fdiv_rn(acc[u].w, l));
  }
}

template <typename T>
cudaError_t launch_online(const TiledAttnArgs& a, int B, cudaStream_t stream) {
  if (a.N <= 0 || a.dh <= 0 || a.dh % 4 || a.dh > O_MAX_DH || a.n_real <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = online_smem_floats(a.dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(online_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + OQT - 1) / OQT, a.H, B);
  online_attention_kernel<T><<<grid, O_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory for heads of width dh, in bytes; the Python side
// holds the same formula for its envelope and checks it after the build.
size_t ivt_online_smem_bytes(int dh) { return online_smem_floats(dh) * sizeof(float); }

// The key tile width (the plain version runs at the same width on the card).
int ivt_online_block_k() { return OKT; }

// dtype: 0 = float32, 1 = bfloat16. Strides in elements (image, head,
// token) of q, k, v and o. Returns a cudaError_t value.
int ivt_flash_attention_online(int dtype, const void* q, const void* k, const void* v, void* o,
                               long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                               long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                               long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                               int B, int H, int N, int dh, int n_real, float scale,
                               float mask_value, void* stream) {
  TiledAttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.q_sn = q_sn;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_sn = k_sn;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.v_sn = v_sn;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.o_sn = o_sn;
  a.H = H;
  a.N = N;
  a.dh = dh;
  a.n_real = n_real;
  a.scale = scale;
  a.mask_value = mask_value;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_online<float>(a, B, s);
  if (dtype == 1) return (int)launch_online<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
