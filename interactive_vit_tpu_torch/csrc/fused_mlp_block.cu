// Fused MLP branch for Hopper (sm_90a):
//     y = x + fc2(gelu_tanh(fc1(LN2(x)))),
// with the hidden activations [rows, mlp_dim] never written to device
// memory.
//
// Replaces the Pallas TPU kernel interactive_vit_tpu/ops/fused_mlp.py::
// fused_mlp_block (_kernel). Its numerics and cast points: LayerNorm with
// f32 statistics, scaled and shifted in f32, cast to the activation dtype T;
// h = gelu_tanh(ln @ fc1_w accumulated in f32 + fc1_b) cast to T -- the tanh
// approximation in every dtype; y = (x in f32 + h @ fc2_w accumulated in
// f32) + fc2_b, cast to T.
//
// What the TPU kernel's shape did and this one does not: a 128-row strip
// per program with both weight matrices and the strip's whole [128, 4D]
// hidden block resident in fast memory. A block here has 227 KB, so it
// takes a strip of 16 rows and walks the hidden dimension in chunks of 256
// columns: it computes the chunk of h into shared memory (16 x 256 f32) and
// at once adds that chunk's share h_chunk @ fc2_w[chunk] into a [16, D] f32
// accumulator held in registers, so only a chunk of h ever exists.
//
// What bounds it on this card: at vit_b16 (D=768, hidden 3072) the weights
// are 9.4 MB in bf16 and the products 9.4 MFLOP per row, so at the card's
// published rates the function is bound by bytes (the weights) below ~300
// rows and by operations above. This version does both products with f32
// FMA (each thread owns one hidden column, then D/256 output columns, for
// all 16 rows; the LN'd strip and the h chunk are broadcast from shared
// memory; every weight element is read once per block, straight from L2
// after the first block), so it runs far below the tensor-core rate, and
// one image of 197 rows is only 13 blocks for 132 SMs. Tensor-core tiles and
// a split of the hidden dimension across blocks are later work.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int MLP_ROWS = 16, MLP_THREADS = 256, MLP_MAX_NC = 5;

__host__ __device__ inline size_t mlp_smem_floats(int d) {
  // LN'd strip [d][16] + one chunk of h [256][16]
  return (size_t)d * MLP_ROWS + (size_t)MLP_THREADS * MLP_ROWS;
}

// NC: output columns per thread, ceil(D / 256).
template <typename T, int NC>
__global__ void __launch_bounds__(MLP_THREADS)
mlp_kernel(const T* __restrict__ x, const T* __restrict__ ln_s, const T* __restrict__ ln_b,
           const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
           const T* __restrict__ b2, T* __restrict__ y, int M, int D, int MD, float eps) {
  extern __shared__ float4 mlp_smem4[];
  float* Xs = reinterpret_cast<float*>(mlp_smem4);  // [D][ROWS], row index fastest
  float* Hs = Xs + (size_t)D * MLP_ROWS;            // [THREADS][ROWS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * MLP_ROWS;

  // LN2 with two-pass f32 statistics, one warp per row; the result is cast
  // to the activation dtype before the product
  for (int r = warp; r < MLP_ROWS; r += MLP_THREADS / 32) {
    const int row = row0 + r;
    if (row < M) {
      const T* xr = x + (size_t)row * D;
      float s = 0.f;
      for (int k = lane; k < D; k += 32) s += to_f(xr[k]);
      const float mean = warp_sum(s) / (float)D;
      float v = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float d = to_f(xr[k]) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / (float)D + eps);
      for (int k = lane; k < D; k += 32)
        Xs[k * MLP_ROWS + r] =
            to_f(from_f<T>((to_f(xr[k]) - mean) * rstd * to_f(ln_s[k]) + to_f(ln_b[k])));
    } else {
      for (int k = lane; k < D; k += 32) Xs[k * MLP_ROWS + r] = 0.f;
    }
  }
  __syncthreads();

  float acc[NC][MLP_ROWS];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < MLP_ROWS; ++r) acc[c][r] = 0.f;

  for (int c0 = 0; c0 < MD; c0 += MLP_THREADS) {
    // fc1 + GELU for hidden column j of the chunk, all rows of the strip
    const int j = c0 + tid;
    if (j < MD) {
      float h[MLP_ROWS];
#pragma unroll
      for (int r = 0; r < MLP_ROWS; ++r) h[r] = 0.f;
      // every step waits on one weight load from L2, so the loop is bound by
      // that latency: 16 loads in flight (8 in the fc2 loop below) took the
      // vit_b16 block (197 x 768, bf16) from 1.96 to 0.80 ms on an H100
#pragma unroll 16
      for (int k = 0; k < D; ++k) {
        const float w = to_f(w1[(size_t)k * MD + j]);
        const float4* xr = reinterpret_cast<const float4*>(Xs + k * MLP_ROWS);
#pragma unroll
        for (int q = 0; q < MLP_ROWS / 4; ++q) {
          const float4 xv = xr[q];
          h[4 * q + 0] = fmaf(xv.x, w, h[4 * q + 0]);
          h[4 * q + 1] = fmaf(xv.y, w, h[4 * q + 1]);
          h[4 * q + 2] = fmaf(xv.z, w, h[4 * q + 2]);
          h[4 * q + 3] = fmaf(xv.w, w, h[4 * q + 3]);
        }
      }
      const float bj = to_f(b1[j]);
#pragma unroll
      for (int r = 0; r < MLP_ROWS; ++r)
        Hs[tid * MLP_ROWS + r] = to_f(from_f<T>(gelu_tanh(h[r] + bj)));
    }
    __syncthreads();

    // this chunk's share of fc2 into the accumulator
    const int kn = min(MLP_THREADS, MD - c0);
#pragma unroll 8
    for (int kk = 0; kk < kn; ++kk) {
      float hv[MLP_ROWS];
      const float4* hr = reinterpret_cast<const float4*>(Hs + kk * MLP_ROWS);
#pragma unroll
      for (int q = 0; q < MLP_ROWS / 4; ++q) {
        const float4 t4 = hr[q];
        hv[4 * q + 0] = t4.x;
        hv[4 * q + 1] = t4.y;
        hv[4 * q + 2] = t4.z;
        hv[4 * q + 3] = t4.w;
      }
      const T* w2r = w2 + (size_t)(c0 + kk) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tid + c * MLP_THREADS;
        if (col < D) {
          const float w = to_f(w2r[col]);
#pragma unroll
          for (int r = 0; r < MLP_ROWS; ++r) acc[c][r] = fmaf(hv[r], w, acc[c][r]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = tid + c * MLP_THREADS;
    if (col >= D) continue;
    const float bc = to_f(b2[col]);
#pragma unroll
    for (int r = 0; r < MLP_ROWS; ++r) {
      const int row = row0 + r;
      if (row >= M) continue;
      const size_t idx = (size_t)row * D + col;
      y[idx] = from_f<T>((to_f(x[idx]) + acc[c][r]) + bc);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* y, int M, int D, int MD,
                      float eps, cudaStream_t stream) {
  const size_t smem = mlp_smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlp_kernel<T, NC><<<(M + MLP_ROWS - 1) / MLP_ROWS, MLP_THREADS, smem, stream>>>(
      (const T*)x, (const T*)ln_s, (const T*)ln_b, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, (T*)y, M, D, MD, eps);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* y, int M, int D, int MD, float eps,
           cudaStream_t stream) {
  if (M <= 0 || D <= 0 || MD <= 0) return (int)cudaErrorInvalidValue;
  switch ((D + MLP_THREADS - 1) / MLP_THREADS) {
    case 1: return (int)launch_nc<T, 1>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, stream);
    case 2: return (int)launch_nc<T, 2>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, stream);
    case 3: return (int)launch_nc<T, 3>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, stream);
    case 4: return (int)launch_nc<T, 4>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, stream);
    case 5: return (int)launch_nc<T, 5>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The widest x the kernel takes (256 output columns per thread slot x 5);
// ops/fused_mlp.py holds the same number for its dispatch envelope and
// checks it after the build.
int ivt_mlp_max_width() { return MLP_THREADS * MLP_MAX_NC; }

// dtype: 0 = float32, 1 = bfloat16. x, y [M, D] contiguous rows; ln_s, ln_b,
// b2 [D]; w1 [D, MD]; b1 [MD]; w2 [MD, D]. Returns a cudaError_t value.
int ivt_fused_mlp_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2, const void* b2, void* y,
                        int M, int D, int MD, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ln_s, ln_b, w1, b1, w2, b2, y, M, D, MD, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
