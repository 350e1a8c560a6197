// Online-softmax flash attention on Hopper's tensor cores in f32, heads 64
// wide, through the 3xTF32 split: o = softmax(q k^T * scale) v on f32 q,
// k, v [B, H, N, 64] (any strides with a contiguous head dim, every
// pointer and stride 16-byte aligned), keys >= n_real masked out, no probs.
//
// Replaces, for f32, the online branch of the Pallas TPU kernel
// interactive_vit_tpu/ops/flash_attention.py::flash_attention
// (_online_call, _online_kernel); other f32 operands stay on
// flash_attention_online.cu (f32 FMA). The numerics are that kernel's, key
// tile by key tile:
//   s = (q . k) * dh^-0.5 in f32; keys >= n_real set to mask_value and
//   their v rows zeroed;
//   m_next = max(m_prev, rowmax s), alpha = exp(m_prev - m_next), m from -inf;
//   p = exp(s - m_next), l = alpha * l + rowsum(p), acc = alpha * acc + p v;
// and at the end o = acc / l, a division. In f32 p is not cast, so the key
// tile (64 here, 128 in the JAX kernel) changes only the rounding of the
// running sums. The exponent is expf; the scale, subtraction, alpha and l
// updates and the division are explicitly rounded operations.
//
// The products: every product a b is taken as three TF32 tensor-core
// products on a hi / lo split of each operand (tf32_attention.cuh), with
// the hi products and the correction terms in two accumulators, each over
// one key tile only (8 or 16 products), added, and folded into the running
// sums, with round-to-nearest f32 operations: s = big + small per score,
// and acc = alpha * acc + (big + small) per tile, the plain version's form.
// (On an H100, o accumulated over 2814 keys in one accumulator missed 1e-4:
// 1.1e-4.) Q is split once into registers; K, V and p are split in
// registers as each fragment is read. Splitting K and V into hi and lo
// tiles in shared memory once a tile instead (a third more shared memory,
// a barrier) was slower on an H100 SXM: 0.358 against 0.353 ms at two parts
// (tools/kernel_variants.py). The depth index is permuted (2t, 2t + 1), so
// Q and K load as 8-byte pairs and S's accumulators are PV's A fragment as
// they stand (tf32_attention.cuh); K rows of 72 floats, V rows of 68.
//
// Design: one block of 4 warps per (64 query rows, head, image); each warp
// owns 16 query rows, whose split Q fragments stay in registers. K and V
// tiles of 64 keys stream through a two-stage cp.async ring (71,680 bytes
// of dynamic shared memory), rows past N and masked V rows zero-filled.
//
// What bounds it on this card: at dinov2_s14_reg@742 (N = 2814, 6 heads,
// dh = 64, B = 1, f32) the work is 12.16 GFLOP over 17.3 MB: 0.18 ms at
// the f32 FMA peak (67 TFLOP/s); the split issues 3 x 12.16 GFLOP of TF32
// products, 0.074 ms at the TF32 peak (495 TFLOP/s), on mma.sync (a
// fraction of it), with an expf per score on the FMA pipes.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "tf32_attention.cuh"

namespace {

constexpr int TF_ROWS = 64, TF_KT = 64, TF_WARPS = 4, TF_THREADS = 32 * TF_WARPS;
constexpr int TF_NT = TF_KT / 8;      // 8-key tiles of a key tile
// PV in parts of o's columns (fewer live accumulators): on an H100 SXM
// one part (254 registers) took 0.341 ms at dinov2_s14_reg@742, two
// (which spill) 0.353, four 0.351 (tools/kernel_variants.py)
constexpr int TF_PV_PARTS = 1;
constexpr int TF_STAGE = TF_KT * (K_LD + V_LD);  // floats: K then V
constexpr size_t TF_SMEM = 2 * TF_STAGE * sizeof(float);
static_assert(TF_ROWS * K_LD <= TF_KT * K_LD, "Q fits a K slot");

struct OnlineTf32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  int H, N, n_real;
  float scale, mask_value;
};

__global__ void __launch_bounds__(TF_THREADS) online_tf32_kernel(const OnlineTf32Args a) {
  extern __shared__ float4 tf_smem4[];
  float* smem = reinterpret_cast<float*>(tf_smem4);  // stage s: K at s * TF_STAGE, V after it
  const int q0 = blockIdx.x * TF_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int N = a.N, n_tiles = (N + TF_KT - 1) / TF_KT;

  // Q through stage 1's K slot, tile 0 into stage 0
  load_rows_f32(smem + TF_STAGE, K_LD, a.q + b * a.q_sb + h * a.q_sh, a.q_sn, q0, TF_ROWS, N,
                TF_THREADS);
  load_rows_f32(smem, K_LD, kb, a.k_sn, 0, TF_KT, N, TF_THREADS);
  load_rows_f32(smem + TF_KT * K_LD, V_LD, vb, a.v_sn, 0, TF_KT, a.n_real, TF_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the warp's split Q fragments: step kc holds head dims 8 kc + 2t (a0,
  // a1) and 8 kc + 2t + 1 (a2, a3) of rows g and g + 8
  uint32_t qh[TF_KS][4], ql[TF_KS][4];
#pragma unroll
  for (int kc = 0; kc < TF_KS; ++kc)
    load_a_rows(qh[kc], ql[kc], smem + TF_STAGE + 16 * warp * K_LD, kc, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[TF_DT][4];
#pragma unroll
  for (int n = 0; n < TF_DT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: every lane of a quad holds the same
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * TF_KT;
    if (it + 1 < n_tiles) {
      float* nxt = smem + ((it + 1) & 1) * TF_STAGE;
      load_rows_f32(nxt, K_LD, kb, a.k_sn, j0 + TF_KT, TF_KT, N, TF_THREADS);
      load_rows_f32(nxt + TF_KT * K_LD, V_LD, vb, a.v_sn, j0 + TF_KT, TF_KT, a.n_real,
                    TF_THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = smem + (it & 1) * TF_STAGE;
    const float* Vs = Ks + TF_KT * K_LD;

    // S = Q K^T: key tile n holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
    float s[TF_NT][4];
#pragma unroll
    for (int n = 0; n < TF_NT; ++n) {
      float small[4] = {0.f, 0.f, 0.f, 0.f};
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const float* kr = Ks + (8 * n + g) * K_LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < TF_KS; ++kc) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * kc);
        mma_3xtf32(s[n], small, qh[kc], ql[kc], kv.x, kv.y);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fold_rn(s[n][e], small[e]);
    }

    // scale, mask, and the tile's row max (rows g: e = 0, 1; g + 8: e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < TF_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = key < a.n_real ? __fmul_rn(s[n][e], a.scale) : a.mask_value;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f}, m_next[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_next[r] = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = expf(__fsub_rn(m_run[r], m_next[r]));
      m_run[r] = m_next[r];
    }
#pragma unroll
    for (int n = 0; n < TF_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(__fsub_rn(s[n][e], m_next[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = __fadd_rn(__fmul_rn(alpha[r], l_run[r]), quad_sum(sum[r]));

    // acc = alpha acc + p V, in parts of o's columns: key tile n is the
    // 8-deep step, its accumulators the A fragment (keys 2t <-> k = t,
    // 2t + 1 <-> k = t + 4)
#pragma unroll
    for (int part = 0; part < TF_PV_PARTS; ++part) {
      constexpr int HT = TF_DT / TF_PV_PARTS;
      float big[HT][4], small[HT][4];
#pragma unroll
      for (int d = 0; d < HT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[d][e] = small[d][e] = 0.f;
#pragma unroll
      for (int n = 0; n < TF_NT; ++n) {
        uint32_t ph[4], pl[4];
        split(s[n][0], ph[0], pl[0]);
        split(s[n][2], ph[1], pl[1]);
        split(s[n][1], ph[2], pl[2]);
        split(s[n][3], ph[3], pl[3]);
        const float* vr = Vs + (8 * n + 2 * t) * V_LD + 8 * HT * part + g;
#pragma unroll
        for (int d = 0; d < HT; ++d)
          mma_3xtf32(big[d], small[d], ph, pl, vr[8 * d], vr[V_LD + 8 * d]);
      }
#pragma unroll
      for (int d = 0; d < HT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& o = oacc[HT * part + d][e];
          o = __fadd_rn(__fmul_rn(o, alpha[e >> 1]), fold_rn(big[d][e], small[d][e]));
        }
    }
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

  float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    float* orow = ob + (long long)row * a.o_sn + 2 * t;
#pragma unroll
    for (int dn = 0; dn < TF_DT; ++dn)
      *reinterpret_cast<float2*>(orow + 8 * dn) =
          make_float2(__fdiv_rn(oacc[dn][2 * r], l_run[r]), __fdiv_rn(oacc[dn][2 * r + 1], l_run[r]));
  }
}

}  // namespace

extern "C" {

// The key tile width and the head width the kernel takes.
int ivt_online_tf32_block_k() { return TF_KT; }
int ivt_online_tf32_dh() { return TF_DH; }

// f32 q, k, v, o with heads TF_DH wide; strides in elements (image, head,
// token), every pointer and stride 16-byte aligned. Returns a cudaError_t
// value.
int ivt_flash_attention_online_tf32x3(const void* q, const void* k, const void* v, void* o,
                                      long long q_sb, long long q_sh, long long q_sn,
                                      long long k_sb, long long k_sh, long long k_sn,
                                      long long v_sb, long long v_sh, long long v_sn,
                                      long long o_sb, long long o_sh, long long o_sn, int B, int H,
                                      int N, int dh, int n_real, float scale, float mask_value,
                                      void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || dh != TF_DH || n_real <= 0 || n_real > N)
    return (int)cudaErrorInvalidValue;
  OnlineTf32Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
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
  a.n_real = n_real;
  a.scale = scale;
  a.mask_value = mask_value;
  cudaError_t err = cudaFuncSetAttribute(online_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TF_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TF_ROWS - 1) / TF_ROWS, H, B);
  online_tf32_kernel<<<grid, TF_THREADS, TF_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
