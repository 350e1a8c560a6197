// Fused W8A8 MLP branch for Hopper (sm_90a):
//     y = x + MLP_w8a8(LN2(x)),
// both products s8 x s8 -> s32, the activations quantized per row inside
// the kernel, the hidden activations [rows, mlp_dim] never written to device
// memory.
//
// Replaces the Pallas TPU kernel interactive_vit_tpu/ops/fused_mlp.py::
// fused_mlp_w8a8_block (_w8a8_kernel). Its cast points, in order:
//   1. LayerNorm with f32 statistics, scaled and shifted in f32, cast to the
//      activation dtype T and back;
//   2. per-row quantization (quant_rows_mosaic: scale max|ln| / 127, round
//      half up, a true f32 division);
//   3. acc1 = q1 @ fc1_q, s8 x s8 -> s32 (exact);
//   4. h = acc1.f32 * (sx1 * s1) + b1;
//   5. h cast to T, tanh GELU, cast to T;
//   6. per-row requantization of h over all mlp_dim columns;
//   7. acc2 = q2 @ fc2_q, s8 x s8 -> s32;
//   8. y = x.f32 + acc2.f32 * (sx2 * s2) + b2, cast to T.
// Every f32 step is an explicitly rounded multiply or add (__fmul_rn,
// __fadd_rn), so the compiler contracts nothing into an fma that the plain
// version does not have.
//
// What the TPU kernel's shape did and this one does not: a 256-row strip per
// program with both int8 weight matrices resident in fast memory. Step 6
// needs the whole hidden row before fc2 can start, so PR 3's strip walk
// (fc2 accumulated chunk by chunk) does not carry over. A block here takes a
// strip of 8 rows, keeps that strip's whole hidden block in shared memory
// (h in T, then its int8 form: 8 x 3072 x 3 bytes in bf16 at vit_b16), and
// walks fc1 and then fc2 over it.
//
// Integer products: __dp4a multiplies four int8 pairs along the reduction
// dimension and adds them to an s32 accumulator. The activations are packed
// for it in shared memory as they are quantized (word k/4 of each row holds
// k..k+3). The weights stay in the [D_in, D_out] row-major int8 layout of
// the model's leaf-dicts: a thread reads its column's four consecutive-k
// bytes with four coalesced row loads and packs them into one word in
// registers, so nothing is repacked in memory.
//
// What bounds it on this card: at vit_b16 (197 x 768, hidden 3072) the work
// is 1.86 G int8 operations over 4.7 MB of int8 weights, so at the card's
// published rates it is bound by bytes (~1.5 us) below ~300 rows. This
// version issues __dp4a (not the int8 tensor cores) and one image is 25
// blocks for 132 SMs, each walking every weight byte from L2, so it runs
// far above that bound. Int8 wgmma tiles are later work.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int W8_ROWS = 8, W8_THREADS = 256, W8_MAX_NC = 5, W8_WARPS = W8_THREADS / 32;

__host__ __device__ inline size_t w8a8_smem_bytes(int d, int md, int esize) {
  // q1 words [d/4][ROWS] + h [md][ROWS] in T + q2 words [md/4][ROWS]
  return (size_t)d * W8_ROWS + (size_t)md * W8_ROWS * esize + (size_t)md * W8_ROWS;
}

struct W8a8Args {
  const void* x;
  const void* ln_s;
  const void* ln_b;
  const int8_t* w1;  // [D, MD]
  const float* s1;   // [MD]
  const void* b1;    // [MD]
  const int8_t* w2;  // [MD, D]
  const float* s2;   // [D]
  const void* b2;    // [D]
  void* y;
  // optional taps of the integer stages, row-major [M, D] / [M, MD]
  int8_t* q1_out;
  int* acc1_out;
  int8_t* q2_out;
  int* acc2_out;
  int M, D, MD;
  float eps;
};

// byte address of element (row r, column k) in a [cols/4][ROWS] word array
__device__ __forceinline__ int packed_byte(int k, int r) {
  return ((k >> 2) * W8_ROWS + r) * 4 + (k & 3);
}

// NC: output columns per thread in fc2, ceil(D / 256).
template <typename T, int NC>
__global__ void __launch_bounds__(W8_THREADS) w8a8_mlp_kernel(const W8a8Args a) {
  extern __shared__ int4 w8_smem4[];
  int* Xq = reinterpret_cast<int*>(w8_smem4);          // [D/4][ROWS] words
  T* Hs = reinterpret_cast<T*>(Xq + (a.D / 4) * W8_ROWS);  // [MD][ROWS]
  int* Hq = reinterpret_cast<int*>(Hs + (size_t)a.MD * W8_ROWS);  // [MD/4][ROWS]
  int8_t* Xq8 = reinterpret_cast<int8_t*>(Xq);
  int8_t* Hq8 = reinterpret_cast<int8_t*>(Hq);
  __shared__ float sx1[W8_ROWS], sx2[W8_ROWS], red[W8_WARPS][W8_ROWS];

  const T* x = static_cast<const T*>(a.x);
  const T* ln_s = static_cast<const T*>(a.ln_s);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  const int D = a.D, MD = a.MD;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * W8_ROWS;

  // 1-2. LN2 (two-pass f32 statistics, one warp per row), cast to T, then
  // quantized per row into Xq
  for (int r = warp; r < W8_ROWS; r += W8_WARPS) {
    const int row = row0 + r;
    if (row >= a.M) {
      for (int k = lane; k < D; k += 32) Xq8[packed_byte(k, r)] = 0;
      continue;
    }
    const T* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s += to_f(xr[k]);
    const float mean = warp_sum(s) / (float)D;
    float v = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float dv = to_f(xr[k]) - mean;
      v += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(v) / (float)D + a.eps);
    auto ln = [&](int k) {
      const float z = __fmul_rn(__fsub_rn(to_f(xr[k]), mean), rstd);
      return to_f(from_f<T>(__fadd_rn(__fmul_rn(z, to_f(ln_s[k])), to_f(ln_b[k]))));
    };
    float mx = 0.f;
    for (int k = lane; k < D; k += 32) mx = fmaxf(mx, fabsf(ln(k)));
    const float sx = quant_scale(warp_max(mx));
    if (lane == 0) sx1[r] = sx;
    for (int k = lane; k < D; k += 32) {
      const int q = quant_half_up(ln(k), sx);
      Xq8[packed_byte(k, r)] = (int8_t)q;
      if (a.q1_out != nullptr) a.q1_out[(size_t)row * D + k] = (int8_t)q;
    }
  }
  __syncthreads();

  // 3-5. fc1 + GELU: thread tid owns hidden columns tid, tid + 256, ...
  const T* b1 = static_cast<const T*>(a.b1);
  float hmax[W8_ROWS];
#pragma unroll
  for (int r = 0; r < W8_ROWS; ++r) hmax[r] = 0.f;
  for (int j = tid; j < MD; j += W8_THREADS) {
    int acc[W8_ROWS];
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) acc[r] = 0;
    const int8_t* wc = a.w1 + j;
#pragma unroll 4
    for (int k4 = 0; k4 < D / 4; ++k4) {
      const int8_t* wk = wc + (size_t)(4 * k4) * MD;
      const int w = pack4(wk[0], wk[MD], wk[2 * (size_t)MD], wk[3 * (size_t)MD]);
      const int4* xw = reinterpret_cast<const int4*>(Xq + k4 * W8_ROWS);
#pragma unroll
      for (int q = 0; q < W8_ROWS / 4; ++q) {
        const int4 xv = xw[q];
        acc[4 * q + 0] = __dp4a(xv.x, w, acc[4 * q + 0]);
        acc[4 * q + 1] = __dp4a(xv.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = __dp4a(xv.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = __dp4a(xv.w, w, acc[4 * q + 3]);
      }
    }
    const float s1j = a.s1[j], b1j = to_f(b1[j]);
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) {
      const float h = __fadd_rn(__fmul_rn((float)acc[r], __fmul_rn(sx1[r], s1j)), b1j);
      const T g = from_f<T>(gelu_tanh(to_f(from_f<T>(h))));
      Hs[j * W8_ROWS + r] = g;
      hmax[r] = fmaxf(hmax[r], fabsf(to_f(g)));
      const int row = row0 + r;
      if (a.acc1_out != nullptr && row < a.M) a.acc1_out[(size_t)row * MD + j] = acc[r];
    }
  }

  // 6. the rows' scales over all MD hidden columns, then q2 into Hq
#pragma unroll
  for (int r = 0; r < W8_ROWS; ++r) {
    const float m = warp_max(hmax[r]);
    if (lane == 0) red[warp][r] = m;
  }
  __syncthreads();
  if (tid < W8_ROWS) {
    float m = red[0][tid];
    for (int w = 1; w < W8_WARPS; ++w) m = fmaxf(m, red[w][tid]);
    sx2[tid] = quant_scale(m);
  }
  __syncthreads();
  for (int e = tid; e < MD * W8_ROWS; e += W8_THREADS) {
    const int j = e / W8_ROWS, r = e % W8_ROWS;
    const int q = quant_half_up(to_f(Hs[e]), sx2[r]);
    Hq8[packed_byte(j, r)] = (int8_t)q;
    const int row = row0 + r;
    if (a.q2_out != nullptr && row < a.M) a.q2_out[(size_t)row * MD + j] = (int8_t)q;
  }
  __syncthreads();

  // 7. fc2: thread tid owns output columns tid, tid + 256, ... (NC of them)
  int acc2[NC][W8_ROWS];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) acc2[c][r] = 0;
#pragma unroll 2
  for (int j4 = 0; j4 < MD / 4; ++j4) {
    int hw[W8_ROWS];
    const int4* hp = reinterpret_cast<const int4*>(Hq + j4 * W8_ROWS);
#pragma unroll
    for (int q = 0; q < W8_ROWS / 4; ++q) {
      const int4 hv = hp[q];
      hw[4 * q + 0] = hv.x;
      hw[4 * q + 1] = hv.y;
      hw[4 * q + 2] = hv.z;
      hw[4 * q + 3] = hv.w;
    }
    const int8_t* wk = a.w2 + (size_t)(4 * j4) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tid + c * W8_THREADS;
      if (col < D) {
        const int w = pack4(wk[col], wk[D + col], wk[2 * D + col], wk[3 * D + col]);
#pragma unroll
        for (int r = 0; r < W8_ROWS; ++r) acc2[c][r] = __dp4a(hw[r], w, acc2[c][r]);
      }
    }
  }

  // 8. y = x + acc2 * (sx2 * s2) + b2
  const T* b2 = static_cast<const T*>(a.b2);
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = tid + c * W8_THREADS;
    if (col >= D) continue;
    const float s2c = a.s2[col], b2c = to_f(b2[col]);
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r) {
      const int row = row0 + r;
      if (row >= a.M) continue;
      const size_t idx = (size_t)row * D + col;
      const float t = __fmul_rn((float)acc2[c][r], __fmul_rn(sx2[r], s2c));
      y[idx] = from_f<T>(__fadd_rn(__fadd_rn(to_f(x[idx]), t), b2c));
      if (a.acc2_out != nullptr) a.acc2_out[idx] = acc2[c][r];
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const W8a8Args& a, cudaStream_t stream) {
  const size_t smem = w8a8_smem_bytes(a.D, a.MD, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(w8a8_mlp_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  w8a8_mlp_kernel<T, NC><<<(a.M + W8_ROWS - 1) / W8_ROWS, W8_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const W8a8Args& a, cudaStream_t stream) {
  if (a.M <= 0 || a.D <= 0 || a.MD <= 0 || a.D % 4 || a.MD % 4 ||
      w8a8_smem_bytes(a.D, a.MD, sizeof(T)) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  switch ((a.D + W8_THREADS - 1) / W8_THREADS) {
    case 1: return (int)launch_nc<T, 1>(a, stream);
    case 2: return (int)launch_nc<T, 2>(a, stream);
    case 3: return (int)launch_nc<T, 3>(a, stream);
    case 4: return (int)launch_nc<T, 4>(a, stream);
    case 5: return (int)launch_nc<T, 5>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The widest x the kernel takes; ops/fused_mlp.py holds the same number.
int ivt_mlp_w8a8_max_width() { return W8_THREADS * W8_MAX_NC; }

// Dynamic shared memory for rows of width d, md hidden columns and an
// activation type of esize bytes; ops/fused_mlp.py holds the same formula
// for its envelope and checks it after the build.
size_t ivt_mlp_w8a8_smem_bytes(int d, int md, int esize) { return w8a8_smem_bytes(d, md, esize); }

// dtype: 0 = float32, 1 = bfloat16. x, y [M, D] contiguous rows; ln_s, ln_b,
// b2 [D] and b1 [MD] in the dtype; w1 int8 [D, MD], w2 int8 [MD, D]
// row-major; s1 [MD], s2 [D] f32 column scales. q1_out [M, D] int8,
// acc1_out [M, MD] int32, q2_out [M, MD] int8 and acc2_out [M, D] int32 may
// each be null. Returns a cudaError_t value.
int ivt_fused_mlp_w8a8_block(int dtype, const void* x, const void* ln_s, const void* ln_b,
                             const void* w1, const void* s1, const void* b1, const void* w2,
                             const void* s2, const void* b2, void* y, void* q1_out,
                             void* acc1_out, void* q2_out, void* acc2_out, int M, int D, int MD,
                             float eps, void* stream) {
  W8a8Args a{x,
             ln_s,
             ln_b,
             static_cast<const int8_t*>(w1),
             static_cast<const float*>(s1),
             b1,
             static_cast<const int8_t*>(w2),
             static_cast<const float*>(s2),
             b2,
             y,
             static_cast<int8_t*>(q1_out),
             static_cast<int*>(acc1_out),
             static_cast<int8_t*>(q2_out),
             static_cast<int*>(acc2_out),
             M,
             D,
             MD,
             eps};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
