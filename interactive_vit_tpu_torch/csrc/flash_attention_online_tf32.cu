// Online-softmax flash attention on Hopper's tensor cores in f32, heads 64
// or 80 wide (one instantiation each), through the 3xTF32 split: o =
// softmax(q k^T * scale) v on f32 q, k, v [B, H, N, dh] (any strides with
// a contiguous head dim, every pointer and stride 16-byte aligned), keys
// >= n_real masked out, no probs.
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
// tile (64 at 64 wide, 32 at 80; 128 in the JAX kernel) changes only the
// rounding of the running sums. The exponent is expf; the scale,
// subtraction, alpha and l updates and the division are explicitly rounded
// operations.
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
// they stand (tf32_attention.cuh); K rows of 72 floats, V rows of 68 (88
// and 84 at 80 wide).
//
// Design: one block of 4 warps per (64 query rows, head, image); each warp
// owns 16 query rows, whose split Q fragments stay in registers. K and V
// tiles stream through a two-stage cp.async ring, rows past N and masked V
// rows zero-filled: at 64 wide tiles of 64 keys (71,680 bytes of dynamic
// shared memory).
//
// Heads 80 wide (vit_h14: ten 8-deep steps, ten 8-column tiles of o): the
// split Q fragments take 80 registers and the PV accumulators 80, so the
// 64-wide layout (one PV part, 64-key tiles) spills 168 bytes at 255
// registers. The design: Q still in registers, key tiles of 32 (16 score
// registers; Q gets its own 22,528-byte tile, 66,560 bytes in all) and PV
// in five parts of 16 columns: 255 registers, no spill. On an H100 SXM at
// vit_h14@742 (16 heads, N = 2810, B = 1) it took 1.1637 ms, against
// 1.1782 for one PV part (48 bytes spilled), 1.2583 for Q kept in shared
// memory and split as read (182 registers), and at 64-key tiles 1.2219
// (one part, spilling), 1.2497 (five parts), 1.2968 / 1.2373 (Q in shared
// memory, one / two parts) (tools/kernel_variants.py). In one run of
// chip_smoke.py it took 1.1725 ms, the FMA kernel 7.7101 and SDPA in f32
// 1.4891.
//
// What bounds it on this card: at dinov2_s14_reg@742 (N = 2814, 6 heads,
// dh = 64, B = 1, f32) the work is 12.16 GFLOP over 17.3 MB: 0.18 ms at
// the f32 FMA peak (67 TFLOP/s); the split issues 3 x 12.16 GFLOP of TF32
// products, 0.074 ms at the TF32 peak (495 TFLOP/s), on mma.sync (a
// fraction of it), with an expf per score on the FMA pipes. At
// vit_h14@742 (dh = 80) 40.43 GFLOP over 57.5 MB: 0.603 ms at the f32
// FMA peak, 0.245 ms for the split's products at the TF32 peak.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "tf32_attention.cuh"

namespace {

constexpr int TF_ROWS = 64, TF_KT = 64, TF_WARPS = 4, TF_THREADS = 32 * TF_WARPS;
// PV in parts of o's columns (fewer live accumulators): on an H100 SXM
// one part (254 registers) took 0.341 ms at dinov2_s14_reg@742, two
// (which spill) 0.353, four 0.351 (tools/kernel_variants.py)
constexpr int TF_PV_PARTS = 1;
// Heads 80 wide: PV in TF_PV_PARTS_80 parts, key tiles of TF_KT_80
// (tools/kernel_variants.py)
constexpr int TF_PV_PARTS_80 = 5;
constexpr int TF_KT_80 = 32;

// The block's design at head width DH (64 or 80).
template <int DH>
struct OnlineTf32Cfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  using D = TfDims<DH>;
  static constexpr int PV_PARTS = DH == 64 ? TF_PV_PARTS : TF_PV_PARTS_80;
  static constexpr int KT = DH == 64 ? TF_KT : TF_KT_80;  // keys of a tile
  static constexpr int NT = KT / 8;                        // 8-key tiles of a key tile
  static constexpr int STAGE = KT * (D::K_LD + D::V_LD);   // floats: K then V
  // Q through stage 1's K slot, or (a K slot too small) its own tile
  // after the ring
  static constexpr bool Q_OWN = KT < TF_ROWS;
  static constexpr int Q_TILE = Q_OWN ? TF_ROWS * D::K_LD : 0;
  static constexpr size_t SMEM = (2 * STAGE + Q_TILE) * sizeof(float);
};

struct OnlineTf32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  int H, N, n_real;
  float scale, mask_value;
};

template <int DH>
__global__ void __launch_bounds__(TF_THREADS) online_tf32_kernel(const OnlineTf32Args a) {
  using C = OnlineTf32Cfg<DH>;
  constexpr int KS = C::D::KS, DT = C::D::DT, K_LD = C::D::K_LD, V_LD = C::D::V_LD;
  constexpr int KT = C::KT, NT = C::NT, STAGE = C::STAGE;
  extern __shared__ float4 tf_smem4[];
  float* smem = reinterpret_cast<float*>(tf_smem4);  // stage s: K at s * STAGE, V after it
  const int q0 = blockIdx.x * TF_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int N = a.N, n_tiles = (N + KT - 1) / KT;

  // Q, tile 0 into stage 0
  float* qs = smem + (C::Q_OWN ? 2 * STAGE : STAGE);
  load_rows_f32<DH>(qs, K_LD, a.q + b * a.q_sb + h * a.q_sh, a.q_sn, q0, TF_ROWS, N, TF_THREADS);
  load_rows_f32<DH>(smem, K_LD, kb, a.k_sn, 0, KT, N, TF_THREADS);
  load_rows_f32<DH>(smem + KT * K_LD, V_LD, vb, a.v_sn, 0, KT, a.n_real, TF_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* qw = qs + 16 * warp * K_LD;  // the warp's 16 rows of Q
  // the warp's split Q fragments: step kc holds head dims 8 kc + 2t (a0,
  // a1) and 8 kc + 2t + 1 (a2, a3) of rows g and g + 8
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) load_a_rows<DH>(qh[kc], ql[kc], qw, kc, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: every lane of a quad holds the same
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * KT;
    if (it + 1 < n_tiles) {
      float* nxt = smem + ((it + 1) & 1) * STAGE;
      load_rows_f32<DH>(nxt, K_LD, kb, a.k_sn, j0 + KT, KT, N, TF_THREADS);
      load_rows_f32<DH>(nxt + KT * K_LD, V_LD, vb, a.v_sn, j0 + KT, KT, a.n_real, TF_THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = smem + (it & 1) * STAGE;
    const float* Vs = Ks + KT * K_LD;

    // S = Q K^T: key tile n holds keys 8n + 2t, 8n + 2t + 1 of rows g, g + 8
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float small[4] = {0.f, 0.f, 0.f, 0.f};
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const float* kr = Ks + (8 * n + g) * K_LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KS; ++kc) {
        const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * kc);
        mma_3xtf32(s[n], small, qh[kc], ql[kc], kv.x, kv.y);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fold_rn(s[n][e], small[e]);
    }

    // scale, mask, and the tile's row max (rows g: e = 0, 1; g + 8: e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
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
    for (int n = 0; n < NT; ++n) {
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
    for (int part = 0; part < C::PV_PARTS; ++part) {
      constexpr int HT = DT / C::PV_PARTS;
      float big[HT][4], small[HT][4];
#pragma unroll
      for (int d = 0; d < HT; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[d][e] = small[d][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
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
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(orow + 8 * dn) =
          make_float2(__fdiv_rn(oacc[dn][2 * r], l_run[r]), __fdiv_rn(oacc[dn][2 * r + 1], l_run[r]));
  }
}

template <int DH>
cudaError_t launch(const OnlineTf32Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = OnlineTf32Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(online_tf32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + TF_ROWS - 1) / TF_ROWS, a.H, B);
  online_tf32_kernel<DH><<<grid, TF_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// the head widths the kernel is built for
constexpr int TF_DHS[] = {64, 80};

}  // namespace

extern "C" {

// The key tile width the kernel takes at head width dh; 0 for a width it
// does not take.
int ivt_online_tf32_block_k(int dh) {
  return dh == 64 ? OnlineTf32Cfg<64>::KT : dh == 80 ? OnlineTf32Cfg<80>::KT : 0;
}
// The i-th head width the kernel takes, in increasing order; 0 past the
// last.
int ivt_online_tf32_dh(int i) {
  constexpr int n = sizeof(TF_DHS) / sizeof(TF_DHS[0]);
  return i >= 0 && i < n ? TF_DHS[i] : 0;
}

// f32 q, k, v, o with heads dh wide (ivt_online_tf32_dh); strides in
// elements (image, head, token), every pointer and stride 16-byte aligned.
// Returns a cudaError_t value.
int ivt_flash_attention_online_tf32x3(const void* q, const void* k, const void* v, void* o,
                                      long long q_sb, long long q_sh, long long q_sn,
                                      long long k_sb, long long k_sh, long long k_sn,
                                      long long v_sb, long long v_sh, long long v_sn,
                                      long long o_sb, long long o_sh, long long o_sn, int B, int H,
                                      int N, int dh, int n_real, float scale, float mask_value,
                                      void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || (dh != 64 && dh != 80) || n_real <= 0 || n_real > N)
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
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dh == 64 ? launch<64>(a, B, s) : launch<80>(a, B, s));
}

}  // extern "C"
