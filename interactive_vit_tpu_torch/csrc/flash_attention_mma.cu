// Row-resident attention on Hopper's tensor cores, bf16, heads 64 or 80
// wide (one instantiation each): o = softmax(q k^T * scale) v on q, k, v
// [B, H, N, dh] (any strides with a contiguous head dim, every pointer and
// stride 16-byte aligned), keys >= n_real masked out, with the optional
// exact probs tap [B, H, N, N].
//
// Replaces, for bf16, the row-resident branch of the Pallas TPU kernel
// interactive_vit_tpu/ops/flash_attention.py::flash_attention
// (_rowfull_call, _rowfull_kernel); f32 and other bf16 operands stay on
// flash_attention.cu (f32 FMA). The cast points are that kernel's:
//   s     = q k^T * scale in f32 (bf16 products, f32 sums); keys >= n_real
//           at mask_value;
//   m     = the exact row max; l = rowsum(exp(s - m));
//   probs = exp(s - m) / l, a division, then cast to bf16;
//   o     = bf16(probs) v, accumulated in f32 and cast;
// the tap is the same bf16(probs) that feeds PV. The exponent is expf;
// the scale, subtraction, division and the (m, l) updates are explicitly
// rounded operations (no contraction). Only the order of the f32 sums
// differs from the plain version (the tensor cores' order over dh, and l
// and o summed in key parts), which the bf16 bounds absorb. Masked
// keys and keys past N get probs of exactly 0 (exp(mask_value - m)
// underflows), so they add nothing to PV.
//
// Design (FlashAttention-2's mma.sync layout, mma_attention.cuh): one
// block per (64 query rows, head, image) of 4 x P warps. Warps w, w + 4,
// ... own the same 16 query rows, whose Q fragments stay in registers, and
// split each tile of 64 P keys of the stream into P parts of 64: that
// fills the card at B = 1 without moving a cast point, since the probs are
// normalised before PV. At 64 wide P is 4 when the grid has at most one
// block an SM (dinov2_s14_reg@518: 22 tiles x 6 heads = 132 blocks of 16
// warps), else 2 (two blocks of 8 warps an SM): on an H100 SXM, 4 parts
// took 0.061 ms against 2 parts' 0.071 at dinov2_s14_reg@518, and 2 parts
// were faster where the grid is larger (N = 577 x 16 heads, or B = 4;
// tools/kernel_variants.py). At 80 wide P is 2: at vit_h14@224 (5 x 16 =
// 80 blocks) 4 parts took 0.0279 ms against 2 parts' 0.0282 maps off and
// 0.0340 against 0.0343 maps on, and the 4-part kernel spills.
// So an image's f32 sums run in another order at B = 1 than in a larger
// batch, within the same bounds. K and V tiles stream through a two-stage
// cp.async ring (rows past N zero-filled). The block walks the keys twice:
// pass 1 forms each part's (m, l) by the online update, and the parts are
// combined through shared memory (m = max over the parts, l = sum of l_j
// exp(m_j - m), in part order in every warp); pass 2 forms the normalised
// probs in the score registers, which are the A operand of PV, and the
// parts' partial o are added at the end in part order (f32).
//
// The probs tap: its row stride (N * 2 bytes, 2748 at N = 1374, 1154 at
// N = 577) is off the 16-byte and, for odd N, the 4-byte grid, so a warp
// stages its 16 x 64 bf16 probs in shared memory (rows of 144 bytes
// whatever the head width: conflict-free bf16x2 writes from the
// fragments) and writes each row as 64 contiguous bf16, a lane's two
// 2-byte stores covering 64 contiguous bytes per instruction.
//
// Heads 80 wide: K and V rows of 88 bf16 (MmaDims<80>), a thread's Q
// fragments 20 registers and its o accumulators 40 (16 and 32 at 64 wide).
// The block's shared memory in two key parts is 109,568 bytes (two blocks
// an SM); four would take 219,136 (the ring 180,224, the probs staging
// 36,864, the (m, l) 2,048), still under the 232,448 a block may have.
//
// What bounds it on this card: at dinov2_s14_reg@518 (N = 1374, 6 heads,
// dh = 64, B = 1) the work is 2.90 GFLOP over 4.2 MB with maps off, bound
// by operations (~3 us at 989 TFLOP/s); with maps the 22.7 MB probs tap
// makes it bound by bytes (~7 us at 3.35 TB/s). The two walks issue 1.5x
// the products (~4.35 GFLOP of mma.sync, a fraction of the wgmma rate),
// with two expf and one division per score. At vit_h14@224 (N = 257, 16
// heads, dh = 80, B = 1) maps off: 0.338 GFLOP over 2.63 MB, bound by bytes
// (0.8 us).
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "mma_attention.cuh"

namespace {

constexpr int FM_ROWS = 64;   // query rows of a block
constexpr int FM_KW = 64;     // keys of a warp per tile
constexpr int FM_NT = FM_KW / 8;  // 8-key tiles of a warp
constexpr int FM_P_LD = FM_KW + 8;  // the probs staging's rows, bf16
constexpr size_t FM_MAX_SMEM = 232448;  // dynamic shared memory a block can have

// The block's shape for heads DH wide and SPLIT key parts: 4 x SPLIT
// warps, tiles of 64 x SPLIT keys.
template <int DH, int SPLIT>
struct RowCfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  static constexpr int LD = MmaDims<DH>::LD;         // a K or V row, bf16
  static constexpr int WARPS = 4 * SPLIT, THREADS = 32 * WARPS;
  static constexpr int KT = FM_KW * SPLIT;           // keys of a tile
  static constexpr int TILE = KT * LD;               // one K or V tile, bf16
  static constexpr int STAGE = 2 * TILE;             // K + V
  static constexpr int PROBS = WARPS * 16 * FM_P_LD;  // the warps' probs staging, bf16
  static constexpr size_t RING_BYTES = 2 * STAGE * sizeof(__nv_bfloat16);
  // (m, l) of each part for each row
  static constexpr size_t STATS_BYTES = SPLIT * FM_ROWS * 2 * sizeof(float);
  static constexpr size_t SMEM = RING_BYTES + PROBS * sizeof(__nv_bfloat16) + STATS_BYTES;
  static_assert(SMEM <= FM_MAX_SMEM, "the block's shared memory fits");
  // a lane's o accumulators, and one key part's partial o: [4 warps][VALS
  // values][32 lanes] f32; the later parts' go through the ring
  static constexpr int VALS = DH / 2, XPART = 4 * VALS * 32;
  static_assert((SPLIT - 1) * XPART * sizeof(float) <= RING_BYTES, "o exchange fits the ring");
};

struct RowMmaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  __nv_bfloat16* probs;  // [B, H, N, N] contiguous, or null
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  int H, N, n_real;
  float scale, mask_value;
};

// Steps 0 .. T-1 are pass 1 (K tiles: each part's m, l), T .. 2T-1 pass 2
// (K and V tiles: probs, the tap and PV), one ring across both.
template <int DH, int SPLIT>
__global__ void __launch_bounds__(RowCfg<DH, SPLIT>::THREADS)
    rowfull_mma_kernel(const RowMmaArgs a) {
  using C = RowCfg<DH, SPLIT>;
  extern __shared__ float4 fm_smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(fm_smem4);
  __nv_bfloat16* pstage = ring + 2 * C::STAGE;
  float* stats = reinterpret_cast<float*>(pstage + C::PROBS);  // [part][row][m, l]
  const int q0 = blockIdx.x * FM_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, part = warp >> 2;  // the warp's 16 rows and key part
  const int N = a.N, n_tiles = (N + C::KT - 1) / C::KT, steps = 2 * n_tiles;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + h * a.v_sh;

  // Q through stage 1's K slot, K tile 0 into stage 0
  load_tile_async<DH>(ring + C::STAGE, a.q + b * a.q_sb + h * a.q_sh, a.q_sn, q0, FM_ROWS, N,
                      C::THREADS);
  load_tile_async<DH>(ring, kb, a.k_sn, 0, C::KT, N, C::THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  load_a_frags<DH>(qf, ring + C::STAGE, 16 * rw, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: every lane of a quad holds the same
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  __nv_bfloat16* pst = pstage + warp * 16 * FM_P_LD;
  const long long prow0 = ((long long)b * a.H + h) * N;  // the head's first probs row

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * C::KT;
      __nv_bfloat16* nxt = ring + (nx & 1) * C::STAGE;
      load_tile_async<DH>(nxt, kb, a.k_sn, j1, C::KT, N, C::THREADS);
      if (nx >= n_tiles) load_tile_async<DH>(nxt + C::TILE, vb, a.v_sn, j1, C::KT, N, C::THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this step's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = it >= n_tiles;
    const int jw = (it % n_tiles) * C::KT + FM_KW * part;  // the warp's first key
    const __nv_bfloat16* Ks = ring + (it & 1) * C::STAGE + FM_KW * part * C::LD;
    float s[FM_NT][4];
    mma_rows<FM_NT, DH>(s, qf, Ks, lane);
#pragma unroll
    for (int n = 0; n < FM_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = jw + 8 * n + 2 * t + (e & 1) < a.n_real ? __fmul_rn(s[n][e], a.scale)
                                                          : a.mask_value;

    if (!pass2) {
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, m_next[2];
#pragma unroll
      for (int n = 0; n < FM_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) m_next[r] = fmaxf(m_run[r], quad_max(mx[r]));
#pragma unroll
      for (int n = 0; n < FM_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[e >> 1] = __fadd_rn(sum[e >> 1], expf(__fsub_rn(s[n][e], m_next[e >> 1])));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = expf(__fsub_rn(m_run[r], m_next[r]));
        l_run[r] = __fadd_rn(__fmul_rn(alpha, l_run[r]), quad_sum(sum[r]));
        m_run[r] = m_next[r];
      }
      if (it == n_tiles - 1) {
        // the parts' (m, l) -> the rows', in part order in every warp
        // (every part saw a finite score on every tile, so every m is
        // finite)
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* st = stats + (part * FM_ROWS + 16 * rw + g + 8 * r) * 2;
            st[0] = m_run[r];
            st[1] = l_run[r];
          }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* st = stats + (16 * rw + g + 8 * r) * 2;
          float m = st[0];
#pragma unroll
          for (int j = 1; j < SPLIT; ++j) m = fmaxf(m, st[j * FM_ROWS * 2]);
          float l = 0.f;
#pragma unroll
          for (int j = 0; j < SPLIT; ++j)
            l = __fadd_rn(l, __fmul_rn(st[j * FM_ROWS * 2 + 1],
                                       expf(__fsub_rn(st[j * FM_ROWS * 2], m))));
          l_run[r] = l;
          m_run[r] = m;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < FM_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fdiv_rn(expf(__fsub_rn(s[n][e], m_run[e >> 1])), l_run[e >> 1]);
      uint32_t pa[FM_NT / 2][4];
#pragma unroll
      for (int kk = 0; kk < FM_NT / 2; ++kk) a_from_acc(pa[kk], s[2 * kk], s[2 * kk + 1]);
      if (a.probs != nullptr) {
        // the bf16 probs (the PV operand's values) through the warp's
        // staging rows, then row by row to global memory
#pragma unroll
        for (int kk = 0; kk < FM_NT / 2; ++kk) {
          uint32_t* r0 = reinterpret_cast<uint32_t*>(pst + g * FM_P_LD + 16 * kk + 2 * t);
          uint32_t* r8 = reinterpret_cast<uint32_t*>(pst + (g + 8) * FM_P_LD + 16 * kk + 2 * t);
          r0[0] = pa[kk][0];
          r8[0] = pa[kk][1];
          r0[4] = pa[kk][2];
          r8[4] = pa[kk][3];
        }
        __syncwarp();
        const int row0 = q0 + 16 * rw;
        for (int r = 0; r < 16 && row0 + r < N; ++r) {
          __nv_bfloat16* dst = a.probs + (prow0 + row0 + r) * N + jw;
#pragma unroll
          for (int c = lane; c < FM_KW; c += 32)
            if (jw + c < N) dst[c] = pst[r * FM_P_LD + c];
        }
        __syncwarp();
      }
      const __nv_bfloat16* Vs = ring + (it & 1) * C::STAGE + C::TILE + FM_KW * part * C::LD;
#pragma unroll
      for (int kk = 0; kk < FM_NT / 2; ++kk) mma_a_by_cols<DH>(oacc, pa[kk], Vs, 16 * kk, lane);
    }
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

  // o = o0 + o1 + ...: the later parts' partial sums through the ring,
  // added in part order
  float* xch = reinterpret_cast<float*>(fm_smem4) + rw * C::VALS * 32;
  if (part > 0) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(part - 1) * C::XPART + (4 * n + e) * 32 + lane] = oacc[n][e];
  }
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int j = 1; j < SPLIT; ++j)
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          oacc[n][e] = __fadd_rn(oacc[n][e], xch[(j - 1) * C::XPART + (4 * n + e) * 32 + lane]);
    store_rows<DH>(a.o + b * a.o_sb + h * a.o_sh + (long long)q0 * a.o_sn, a.o_sn, oacc,
                   16 * rw, N - q0, lane);
  }
}

template <int DH, int SPLIT>
cudaError_t launch_rowfull(const RowMmaArgs& a, int B, cudaStream_t stream) {
  using C = RowCfg<DH, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(rowfull_mma_kernel<DH, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + FM_ROWS - 1) / FM_ROWS, a.H, B);
  rowfull_mma_kernel<DH, SPLIT><<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// The key parts of a tile for a grid of at most one block an SM: four at
// 64 wide (16 warps an SM); two at 80, where four took no less time at
// vit_h14@224 and spill at the 128 registers a thread that 512 threads
// leave (tools/kernel_variants.py). A larger grid takes two (two blocks of
// 8 warps an SM).
template <int DH>
constexpr int FM_FEW_BLOCKS_PARTS = DH == 64 ? 4 : 2;

template <int DH>
cudaError_t launch_dh(const RowMmaArgs& a, int B, int sms, cudaStream_t s) {
  const long long blocks = (long long)((a.N + FM_ROWS - 1) / FM_ROWS) * a.H * B;
  return blocks <= sms ? launch_rowfull<DH, FM_FEW_BLOCKS_PARTS<DH>>(a, B, s)
                       : launch_rowfull<DH, 2>(a, B, s);
}

// the head widths the kernel is built for
constexpr int FM_DHS[] = {64, 80};

}  // namespace

extern "C" {

// The i-th head width the kernel takes, in increasing order; 0 past the
// last.
int ivt_flash_mma_dh(int i) {
  constexpr int n = sizeof(FM_DHS) / sizeof(FM_DHS[0]);
  return i >= 0 && i < n ? FM_DHS[i] : 0;
}

// bf16 q, k, v, o with heads dh wide (ivt_flash_mma_dh); strides in
// elements (image, head, token), every pointer and stride 16-byte aligned;
// probs [B, H, N, N] contiguous, or null (maps off). Returns a cudaError_t
// value.
int ivt_flash_attention_mma(const void* q, const void* k, const void* v, void* o, void* probs,
                            long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                            long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                            long long v_sn, long long o_sb, long long o_sh, long long o_sn, int B,
                            int H, int N, int dh, int n_real, float scale, float mask_value,
                            void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || (dh != 64 && dh != 80) || n_real <= 0 || n_real > N)
    return (int)cudaErrorInvalidValue;
  RowMmaArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.probs = static_cast<__nv_bfloat16*>(probs);
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(dh == 64 ? launch_dh<64>(a, B, sms, s) : launch_dh<80>(a, B, sms, s));
}

}  // extern "C"
