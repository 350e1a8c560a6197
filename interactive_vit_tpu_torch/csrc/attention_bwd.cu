// Attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q k^T * scale) v on q, k, v, do [B, H, N, dh] (any element
// strides of image, head and token, the head dim contiguous), keys >= n_real
// masked out. One pair of kernels serves both of the port's layouts: the
// [B, H, N, dh] views of attention_train and the head-major [B, N, 3D]
// activation of attention_train_packed (q, k, v at column offsets 0, dh,
// 2dh of each head's 3dh-column slab; dq, dk, dv written into a dqkv of the
// same layout).
//
// Replaces the backward Pallas TPU kernels of
// interactive_vit_tpu/ops/attention_vjp.py: _bwd_call / _bwd_kernel
// (attention_train) and the backward half of _packed_call
// (_packed_bwd_kernel); both run _head_grads. Its numerics and cast points:
//   probs = exp(s - rowmax) / rowsum in f32, s = scale * q k^T in f32, keys
//           >= n_real at mask_value;
//   dv    = probs.to(do.dtype)^T do, f32-accumulated;
//   dP    = do v^T in f32;
//   delta = rowsum(dP * probs) in f32 (from dP and probs, not from o);
//   ds    = ((probs * (dP - delta)) * scale).to(q.dtype);
//   dq    = ds k, dk = ds^T q, f32-accumulated; dq, dk, dv cast to q's dtype.
// Masked keys get probs of exactly 0, hence dk = dv = 0; padded query rows
// get their gradients like any other row.
//
// What the TPU kernel's grid did and this one does not: one program per
// (image, head) held the whole [N, N] of scores, dP and ds in VMEM. Here
// nothing N x N exists and shared memory does not depend on N:
//   (a) dq: one block per (32-row query tile, head, image). It walks the
//       64-key tiles four times: the row max, the row sum, delta (dP tile
//       by tile), then ds and dq. It writes dq and (m, l, delta) per row
//       to an f32 workspace.
//   (b) dk, dv: one block per (64-key tile, head, image). It walks the
//       32-row query tiles, recomputes P from the saved (m, l), and
//       accumulates dv and dk in registers.
// Deterministic: no atomics, every sum in a fixed order. (a) and (b) must
// form the same f32 P and dP: both compute a score or dP element with one
// device function (tile_dots: d = 0, 1, ... in one fmaf chain, the same
// thread layout) and P with another (probs_of: explicitly rounded
// multiply, subtract and divide, so the compiler contracts nothing).
//
// What bounds it on this card: at vit_b16's train shape (B=64, 12 heads,
// N=197, dh=64, bf16) the work is ~10 N^2 dh per head, 19 GFLOP over 136
// MB: bound by bytes (~40 us) at the published rates. This version
// recomputes the scores in four passes of (a) and once in (b) (~22 N^2 dh)
// with f32 FMA from shared memory, no tensor cores: each FMA chain reads
// its operands from shared memory, so it is bound by shared-memory traffic
// and FMA throughput far above both; tensor-core tiles are later work.
//
// Plain C interface, bound from Python with ctypes; both launches go on the
// caller's stream and the entry returns the first CUDA error.

#include "common.cuh"

namespace {

constexpr int BQ = 32, BK = 64, BWD_THREADS = 256, BWD_MAX_DH = 128;
constexpr int RG = BWD_THREADS / BK;  // row groups of a [BQ x BK] tile
constexpr int RPT = BQ / RG;          // rows per thread in a tile
constexpr int TS = BK + 4;            // row stride of a [BQ][BK] tile in smem
// dq rows (a) and dk / dv keys (b) a thread keeps: BQ and BK over the
// BWD_THREADS / (dh / 4) threads that share a column group. The kernels are
// instantiated for heads up to 64 wide (2 and 4) and up to 128 (4 and 8):
// fewer registers at dh <= 64 let (b) run two blocks per SM.
constexpr int units(int rows, int dh) { return (rows * (dh / 4) + BWD_THREADS - 1) / BWD_THREADS; }

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3][B * H * N]: row max, row sum, delta
  // element strides (image, head, token) of q, k, v, do, dq, dk, dv
  long long st[7][3];
  int H, N, dh, n_real;
  float scale, mask_value;
};

enum { Q_ = 0, K_, V_, DO_, DQ_, DK_, DV_ };

template <typename T>
__device__ __forceinline__ const T* base(const BwdArgs& a, const void* p, int which, int b, int h) {
  return static_cast<const T*>(p) + b * a.st[which][0] + h * a.st[which][1];
}

// rows [r0, r0 + rows) of a [*, dh] operand into smem rows of stride ks, as
// f32; rows beyond `rows` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long sn, int r0, int rows,
                                          int cap, int dh, int ks) {
  for (int e = threadIdx.x; e < cap * dh; e += BWD_THREADS) {
    const int i = e / dh, d = e - i * dh;
    dst[i * ks + d] = (i < rows) ? to_f(src[(r0 + i) * sn + d]) : 0.f;
  }
}

// One thread's share of a [BQ x BK] product tile: row group rg's RPT rows of
// A against row jj of B, each element one fmaf chain over d = 0, 1, ...
__device__ __forceinline__ void tile_dots(const float* __restrict__ A, const float* __restrict__ Bm,
                                          int ks, int nd4, int jj, int rg, float acc[RPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  const float4* b4 = reinterpret_cast<const float4*>(Bm + jj * ks);
  for (int c = 0; c < nd4; ++c) {
    const float4 bv = b4[c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 av = reinterpret_cast<const float4*>(A + (rg * RPT + r) * ks)[c];
      acc[r] = fmaf(av.x, bv.x, acc[r]);
      acc[r] = fmaf(av.y, bv.y, acc[r]);
      acc[r] = fmaf(av.z, bv.z, acc[r]);
      acc[r] = fmaf(av.w, bv.w, acc[r]);
    }
  }
}

__device__ __forceinline__ float score_of(float dot, bool live, float scale, float mask_value) {
  return live ? __fmul_rn(dot, scale) : mask_value;
}

__device__ __forceinline__ float probs_of(float s, float m, float l) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), l);
}

// ds in q's dtype (returned as the f32 of that value)
template <typename T>
__device__ __forceinline__ float ds_of(float p, float dp, float delta, float scale) {
  return to_f(from_f<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale)));
}

// (a): dq and the per-row (m, l, delta)
__host__ __device__ inline size_t dq_smem_floats(int dh) {
  const int ks = dh + 4;
  // Q, dO [BQ][ks]; K, V [BK][ks]; ds [BQ][TS]; two half-row partials and
  // (m, l, delta) per row
  return (size_t)2 * BQ * ks + (size_t)2 * BK * ks + BQ * TS + 2 * BQ + 3 * BQ;
}

// the partials of the two warps that share a row group -> one value a row
template <bool MAX>
__device__ __forceinline__ void reduce_rows(float run[RPT], float* red, float* out, int lane,
                                            int half, int rg) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float v = MAX ? warp_max(run[r]) : warp_sum(run[r]);
    if (lane == 0) red[half * BQ + rg * RPT + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < BQ) {
    const float x = red[threadIdx.x], y = red[BQ + threadIdx.x];
    out[threadIdx.x] = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();
}

template <typename T, int QU>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ float4 bwd_smem4[];
  const int N = a.N, dh = a.dh, ks = dh + 4, nd4 = dh / 4;
  float* Qs = reinterpret_cast<float*>(bwd_smem4);
  float* Os = Qs + BQ * ks;
  float* Ks = Os + BQ * ks;
  float* Vs = Ks + BK * ks;
  float* Ds = Vs + BK * ks;
  float* red = Ds + BQ * TS;
  float* row_m = red + 2 * BQ;
  float* row_l = row_m + BQ;
  float* row_d = row_l + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(BQ, N - q0);
  const int tid = threadIdx.x, lane = tid % 32, jj = tid % BK, rg = tid / BK, half = jj / 32;
  const T* kb = base<T>(a, a.k, K_, b, h);
  const T* vb = base<T>(a, a.v, V_, b, h);
  load_rows(Qs, base<T>(a, a.q, Q_, b, h), a.st[Q_][2], q0, rows, BQ, dh, ks);
  load_rows(Os, base<T>(a, a.dout, DO_, b, h), a.st[DO_][2], q0, rows, BQ, dh, ks);

  float run[RPT], acc[RPT], dpv[RPT];
  // passes 0 (row max), 1 (row sum) and 2 (delta) over the key tiles
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) run[r] = pass == 0 ? -INFINITY : 0.f;
    for (int k0 = 0; k0 < N; k0 += BK) {
      const int kn = min(BK, N - k0);
      __syncthreads();  // the previous tile consumed (and Q, dO written)
      load_rows(Ks, kb, a.st[K_][2], k0, kn, kn, dh, ks);
      if (pass == 2) load_rows(Vs, vb, a.st[V_][2], k0, kn, kn, dh, ks);
      __syncthreads();
      if (jj >= kn) continue;
      const bool live = k0 + jj < a.n_real;
      tile_dots(Qs, Ks, ks, nd4, jj, rg, acc);
      if (pass == 2) tile_dots(Os, Vs, ks, nd4, jj, rg, dpv);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = rg * RPT + r;
        const float s = score_of(acc[r], live, a.scale, a.mask_value);
        if (pass == 0) {
          run[r] = fmaxf(run[r], s);
        } else if (pass == 1) {
          run[r] += expf(__fsub_rn(s, row_m[i]));
        } else {
          run[r] += probs_of(s, row_m[i], row_l[i]) * dpv[r];
        }
      }
    }
    __syncthreads();
    if (pass == 0) reduce_rows<true>(run, red, row_m, lane, half, rg);
    if (pass == 1) reduce_rows<false>(run, red, row_l, lane, half, rg);
    if (pass == 2) reduce_rows<false>(run, red, row_d, lane, half, rg);
  }

  // pass 3: ds tile by tile, dq += ds K; thread (c, i0) keeps columns
  // 4c..4c+3 of rows i0, i0 + istep, ...
  const int istep = BWD_THREADS / nd4;
  const int c = tid % nd4, i0 = tid / nd4;
  float4 dq[QU];
#pragma unroll
  for (int u = 0; u < QU; ++u) dq[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < N; k0 += BK) {
    const int kn = min(BK, N - k0);
    __syncthreads();
    load_rows(Ks, kb, a.st[K_][2], k0, kn, kn, dh, ks);
    load_rows(Vs, vb, a.st[V_][2], k0, kn, kn, dh, ks);
    __syncthreads();
    if (jj < kn) {
      const bool live = k0 + jj < a.n_real;
      tile_dots(Qs, Ks, ks, nd4, jj, rg, acc);
      tile_dots(Os, Vs, ks, nd4, jj, rg, dpv);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = rg * RPT + r;
        const float p = probs_of(score_of(acc[r], live, a.scale, a.mask_value), row_m[i], row_l[i]);
        Ds[i * TS + jj] = ds_of<T>(p, dpv[r], row_d[i], a.scale);
      }
    }
    __syncthreads();
    if (i0 < istep) {
      for (int j = 0; j < kn; ++j) {
        const float4 kv = reinterpret_cast<const float4*>(Ks + j * ks)[c];
#pragma unroll
        for (int u = 0; u < QU; ++u) {
          const int i = i0 + u * istep;
          if (i < BQ) {
            const float w = Ds[i * TS + j];
            dq[u].x = fmaf(w, kv.x, dq[u].x);
            dq[u].y = fmaf(w, kv.y, dq[u].y);
            dq[u].z = fmaf(w, kv.z, dq[u].z);
            dq[u].w = fmaf(w, kv.w, dq[u].w);
          }
        }
      }
    }
  }
  if (tid < rows) {
    const size_t row = ((size_t)b * a.H + h) * N + q0 + tid;
    const size_t plane = (size_t)gridDim.z * a.H * N;
    a.stats[row] = row_m[tid];
    a.stats[plane + row] = row_l[tid];
    a.stats[2 * plane + row] = row_d[tid];
  }
  if (i0 >= istep) return;
  T* dqb = static_cast<T*>(a.dq) + b * a.st[DQ_][0] + h * a.st[DQ_][1];
#pragma unroll
  for (int u = 0; u < QU; ++u) {
    const int i = i0 + u * istep;
    if (i >= rows) continue;
    T* out = dqb + (q0 + i) * a.st[DQ_][2] + 4 * c;
    out[0] = from_f<T>(dq[u].x);
    out[1] = from_f<T>(dq[u].y);
    out[2] = from_f<T>(dq[u].z);
    out[3] = from_f<T>(dq[u].w);
  }
}

// (b): dk, dv
__host__ __device__ inline size_t dkdv_smem_floats(int dh) {
  const int ks = dh + 4;
  // K, V [BK][ks]; Q, dO [BQ][ks]; P and ds [BQ][TS]; (m, l, delta) per row
  return (size_t)2 * BK * ks + (size_t)2 * BQ * ks + (size_t)2 * BQ * TS + 3 * BQ;
}

template <typename T, int KU>
__global__ void __launch_bounds__(BWD_THREADS, KU <= 4 ? 2 : 1)
    attn_bwd_dkdv_kernel(const BwdArgs a) {
  extern __shared__ float4 bwd_smem4[];
  const int N = a.N, dh = a.dh, ks = dh + 4, nd4 = dh / 4;
  float* Ks = reinterpret_cast<float*>(bwd_smem4);
  float* Vs = Ks + BK * ks;
  float* Qs = Vs + BK * ks;
  float* Os = Qs + BQ * ks;
  float* Ps = Os + BQ * ks;
  float* Ds = Ps + BQ * TS;
  float* row_m = Ds + BQ * TS;
  float* row_l = row_m + BQ;
  float* row_d = row_l + BQ;

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int kn = min(BK, N - k0);
  const int tid = threadIdx.x, jj = tid % BK, rg = tid / BK;
  const bool live = k0 + jj < a.n_real;
  const T* qb = base<T>(a, a.q, Q_, b, h);
  const T* ob = base<T>(a, a.dout, DO_, b, h);
  load_rows(Ks, base<T>(a, a.k, K_, b, h), a.st[K_][2], k0, kn, BK, dh, ks);
  load_rows(Vs, base<T>(a, a.v, V_, b, h), a.st[V_][2], k0, kn, BK, dh, ks);
  const size_t plane = (size_t)gridDim.z * a.H * N;
  const float* st = a.stats + ((size_t)b * a.H + h) * N;

  // thread (c, j0) keeps columns 4c..4c+3 of keys j0, j0 + jstep, ...
  const int jstep = BWD_THREADS / nd4;
  const int c = tid % nd4, j0 = tid / nd4;
  float4 dk[KU], dv[KU];
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    dk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float acc[RPT], dpv[RPT];
  for (int q0 = 0; q0 < N; q0 += BQ) {
    const int rows = min(BQ, N - q0);
    __syncthreads();  // the previous query tile consumed
    load_rows(Qs, qb, a.st[Q_][2], q0, rows, BQ, dh, ks);
    load_rows(Os, ob, a.st[DO_][2], q0, rows, BQ, dh, ks);
    if (tid < BQ) {
      const bool in = tid < rows;
      row_m[tid] = in ? st[q0 + tid] : 0.f;
      row_l[tid] = in ? st[plane + q0 + tid] : 1.f;
      row_d[tid] = in ? st[2 * plane + q0 + tid] : 0.f;
    }
    __syncthreads();
    tile_dots(Qs, Ks, ks, nd4, jj, rg, acc);
    tile_dots(Os, Vs, ks, nd4, jj, rg, dpv);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = rg * RPT + r;
      const bool in = i < rows && jj < kn;
      const float p =
          probs_of(score_of(acc[r], live, a.scale, a.mask_value), row_m[i], row_l[i]);
      Ps[i * TS + jj] = in ? to_f(from_f<T>(p)) : 0.f;  // probs in do's dtype
      Ds[i * TS + jj] = in ? ds_of<T>(p, dpv[r], row_d[i], a.scale) : 0.f;
    }
    __syncthreads();
    if (j0 < jstep) {
      for (int i = 0; i < rows; ++i) {
        const float4 ov = reinterpret_cast<const float4*>(Os + i * ks)[c];
        const float4 qv = reinterpret_cast<const float4*>(Qs + i * ks)[c];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int j = j0 + u * jstep;
          if (j < BK) {
            const float p = Ps[i * TS + j], w = Ds[i * TS + j];
            dv[u].x = fmaf(p, ov.x, dv[u].x);
            dv[u].y = fmaf(p, ov.y, dv[u].y);
            dv[u].z = fmaf(p, ov.z, dv[u].z);
            dv[u].w = fmaf(p, ov.w, dv[u].w);
            dk[u].x = fmaf(w, qv.x, dk[u].x);
            dk[u].y = fmaf(w, qv.y, dk[u].y);
            dk[u].z = fmaf(w, qv.z, dk[u].z);
            dk[u].w = fmaf(w, qv.w, dk[u].w);
          }
        }
      }
    }
  }
  if (j0 >= jstep) return;
  T* dkb = static_cast<T*>(a.dk) + b * a.st[DK_][0] + h * a.st[DK_][1];
  T* dvb = static_cast<T*>(a.dv) + b * a.st[DV_][0] + h * a.st[DV_][1];
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    const int j = j0 + u * jstep;
    if (j >= kn) continue;
    T* ok = dkb + (k0 + j) * a.st[DK_][2] + 4 * c;
    T* ov = dvb + (k0 + j) * a.st[DV_][2] + 4 * c;
    ok[0] = from_f<T>(dk[u].x);
    ok[1] = from_f<T>(dk[u].y);
    ok[2] = from_f<T>(dk[u].z);
    ok[3] = from_f<T>(dk[u].w);
    ov[0] = from_f<T>(dv[u].x);
    ov[1] = from_f<T>(dv[u].y);
    ov[2] = from_f<T>(dv[u].z);
    ov[3] = from_f<T>(dv[u].w);
  }
}

template <typename T, int DH>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int QU = units(BQ, DH), KU = units(BK, DH);
  const size_t smem_a = dq_smem_floats(a.dh) * sizeof(float);
  const size_t smem_b = dkdv_smem_floats(a.dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, QU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, KU>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, QU><<<dim3((a.N + BQ - 1) / BQ, a.H, B), BWD_THREADS, smem_a, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, KU><<<dim3((a.N + BK - 1) / BK, a.H, B), BWD_THREADS, smem_b, stream>>>(
      a);
  return cudaGetLastError();
}

// heads up to 64 wide take the smaller instantiation
template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  return a.dh <= 64 ? launch_bwd<T, 64>(a, B, stream) : launch_bwd<T, BWD_MAX_DH>(a, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 21 element strides, (image,
// head, token) of q, k, v, do, dq, dk, dv in that order. stats: an f32
// workspace of 3 * B * H * N floats. Returns a cudaError_t value.
int ivt_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* dout,
                      void* dq, void* dk, void* dv, float* stats, const long long* strides, int B,
                      int H, int N, int dh, int n_real, float scale, float mask_value,
                      void* stream) {
  if (N <= 0 || dh <= 0 || dh % 4 != 0 || dh > BWD_MAX_DH || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = stats;
  for (int t = 0; t < 7; ++t)
    for (int s = 0; s < 3; ++s) a.st[t][s] = strides[3 * t + s];
  a.H = H;
  a.N = N;
  a.dh = dh;
  a.n_real = n_real;
  a.scale = scale;
  a.mask_value = mask_value;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_bwd<float>(a, B, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
