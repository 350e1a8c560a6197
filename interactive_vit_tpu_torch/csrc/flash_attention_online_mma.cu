// Online-softmax flash attention on Hopper's tensor cores, bf16, heads 64
// or 80 wide (one instantiation each): o = softmax(q k^T / sqrt(dh)) v on
// q, k, v [B, H, N, dh] (any strides with a contiguous head dim, 16-byte
// aligned), keys >= n_real masked out, no probs.
//
// Replaces, for bf16, the online branch of the Pallas TPU kernel
// interactive_vit_tpu/ops/flash_attention.py::flash_attention
// (_online_call, _online_kernel); f32 stays on flash_attention_online.cu
// (f32 FMA), since TF32 would not keep the f32 contract. The numerics are
// that kernel's and the FMA kernel's, per key tile of KT = 128 keys (the
// JAX block_k, which the result depends on in bf16, at either width):
//   s = (q . k) * dh^-0.5 in f32 (bf16 products, f32 sums, on the tensor
//   cores); keys >= n_real set to -0.7 * f32 max and their v rows zeroed;
//   m_next = max(m_prev, rowmax s), alpha = exp(m_prev - m_next), m from -inf;
//   p = exp(s - m_next) in f32, l = alpha * l + rowsum(p), summed in f32
//   before any cast;
//   acc = alpha * acc + bf16(p) @ v, accumulated in f32;
// and at the end o = acc / l, a division, cast to bf16. The exponent is
// expf, as the FMA kernel's (scale * log2e is not folded into exp2f). The
// scale, subtraction, alpha and l updates and the division are explicitly
// rounded operations (no contraction). The products' f32 sums run in the
// tensor cores' order, not the plain version's: the bf16 bounds absorb it.
//
// Design (FlashAttention-2 on mma.sync): one block of 4 warps per (64 query
// rows, head, image); each warp owns 16 query rows, whose Q fragments stay
// in registers for the whole key loop. K and V tiles of 128 keys stream
// through a two-stage cp.async ring in dynamic shared memory (73,728
// bytes at 64 wide: three blocks fit an SM; 90,112 at 80 wide, rows of 88
// bf16: two), the next tile's copies in flight while the current one
// computes. A warp's 16 x 128 score tile is 64 f32 accumulators a thread;
// its row max and sum are quad shuffles, and the packed bf16 probabilities
// are the A operand of PV straight from the registers. Rows past N are
// zero-filled by cp.async and never stored. At 80 wide a thread holds 20
// Q, 40 o and 64 score registers (112 at 64 wide); the key tile stays at
// 128 whatever the width, since in bf16 the cast of p is made tile by
// tile.
//
// What bounds it on this card: at dinov2_s14_reg@742 (N = 2814, 6 heads,
// dh = 64, B = 1) the work is 12.2 GFLOP over 8.6 MB, bound by operations
// (12.3 us at 989 TFLOP/s); at vit_h14@742 (N = 2810, 16 heads, dh = 80)
// 40.4 GFLOP over 28.8 MB (40.9 us). 44 x 6 = 264 blocks are two per SM
// on 132 SMs (44 x 16 = 704 at vit_h14@742); mma.sync reaches a fraction
// of the card's wgmma rate, and each score costs an expf on the FMA pipes.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "mma_attention.cuh"

namespace {

constexpr int OM_ROWS = 64, OM_KT = 128, OM_WARPS = 4, OM_THREADS = 32 * OM_WARPS;
constexpr int OM_NT = OM_KT / 8;  // 8-key tiles of a key tile

// The shared tiles at head width DH.
template <int DH>
struct OnlineMmaCfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  static constexpr int TILE = OM_KT * MmaDims<DH>::LD;                // one K or V tile, bf16
  static constexpr size_t SMEM = 4 * TILE * sizeof(__nv_bfloat16);  // K, V x two stages
};

// the head widths the kernel is built for
constexpr int OM_DHS[] = {64, 80};

struct OnlineMmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  int H, N, n_real;
  float scale, mask_value;
};

template <int DH>
__global__ void __launch_bounds__(OM_THREADS) online_mma_kernel(const OnlineMmaArgs a) {
  constexpr int OM_TILE = OnlineMmaCfg<DH>::TILE;
  extern __shared__ float4 om_smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(om_smem4);
  // stage s: K at smem + 2 s OM_TILE, V right after it
  const int q0 = blockIdx.x * OM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const __nv_bfloat16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + h * a.v_sh;
  const int N = a.N, n_tiles = (N + OM_KT - 1) / OM_KT;

  // Q through stage 1's K slot, tile 0 into stage 0
  load_tile_async<DH>(smem + 2 * OM_TILE, qb, a.q_sn, q0, OM_ROWS, N, OM_THREADS);
  load_tile_async<DH>(smem, kb, a.k_sn, 0, OM_KT, N, OM_THREADS);
  load_tile_async<DH>(smem + OM_TILE, vb, a.v_sn, 0, OM_KT, a.n_real, OM_THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  load_a_frags<DH>(qf, smem + 2 * OM_TILE, 16 * warp, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: every lane of a quad holds the same
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * OM_KT;
    if (it + 1 < n_tiles) {
      __nv_bfloat16* nxt = smem + 2 * ((it + 1) & 1) * OM_TILE;
      load_tile_async<DH>(nxt, kb, a.k_sn, j0 + OM_KT, OM_KT, N, OM_THREADS);
      load_tile_async<DH>(nxt + OM_TILE, vb, a.v_sn, j0 + OM_KT, OM_KT, a.n_real, OM_THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ks = smem + 2 * (it & 1) * OM_TILE;
    const __nv_bfloat16* Vs = Ks + OM_TILE;

    float s[OM_NT][4];
    mma_rows<OM_NT, DH>(s, qf, Ks, lane);

    // scale, mask, and the tile's row max (rows g: e = 0, 1; g + 8: e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < OM_NT; ++n) {
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
    for (int n = 0; n < OM_NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(__fsub_rn(s[n][e], m_next[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = __fadd_rn(__fmul_rn(alpha[r], l_run[r]), quad_sum(sum[r]));
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      oacc[n][0] = __fmul_rn(oacc[n][0], alpha[0]);
      oacc[n][1] = __fmul_rn(oacc[n][1], alpha[0]);
      oacc[n][2] = __fmul_rn(oacc[n][2], alpha[1]);
      oacc[n][3] = __fmul_rn(oacc[n][3], alpha[1]);
    }
    // acc += bf16(p) V, p straight from the score accumulators
#pragma unroll
    for (int kk = 0; kk < OM_KT / 16; ++kk) {
      uint32_t pa[4];
      a_from_acc(pa, s[2 * kk], s[2 * kk + 1]);
      mma_a_by_cols<DH>(oacc, pa, Vs, 16 * kk, lane);
    }
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    oacc[n][0] = __fdiv_rn(oacc[n][0], l_run[0]);
    oacc[n][1] = __fdiv_rn(oacc[n][1], l_run[0]);
    oacc[n][2] = __fdiv_rn(oacc[n][2], l_run[1]);
    oacc[n][3] = __fdiv_rn(oacc[n][3], l_run[1]);
  }
  store_rows<DH>(a.o + b * a.o_sb + h * a.o_sh + (long long)q0 * a.o_sn, a.o_sn, oacc,
                 16 * warp, N - q0, lane);
}

template <int DH>
cudaError_t launch(const OnlineMmaArgs& a, int B, cudaStream_t stream) {
  using C = OnlineMmaCfg<DH>;
  cudaError_t err = cudaFuncSetAttribute(online_mma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + OM_ROWS - 1) / OM_ROWS, a.H, B);
  online_mma_kernel<DH><<<grid, OM_THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The key tile width (the plain version runs at the same width).
int ivt_online_mma_block_k() { return OM_KT; }

// The i-th head width the kernel takes, in increasing order; 0 past the
// last.
int ivt_online_mma_dh(int i) {
  constexpr int n = sizeof(OM_DHS) / sizeof(OM_DHS[0]);
  return i >= 0 && i < n ? OM_DHS[i] : 0;
}

// bf16 q, k, v, o with heads dh wide (ivt_online_mma_dh); strides in
// elements (image, head, token), every pointer and stride 16-byte aligned.
// Returns a cudaError_t value.
int ivt_flash_attention_online_mma(const void* q, const void* k, const void* v, void* o,
                                   long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                                   long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                                   long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                                   int B, int H, int N, int dh, int n_real, float scale,
                                   float mask_value, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || (dh != 64 && dh != 80) || n_real <= 0 || n_real > N)
    return (int)cudaErrorInvalidValue;
  OnlineMmaArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
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
