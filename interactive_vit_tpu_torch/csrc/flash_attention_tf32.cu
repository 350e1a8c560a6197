// Row-resident attention on Hopper's tensor cores in f32, heads 64 or 80
// wide (one instantiation each), through the 3xTF32 split: o = softmax(q
// k^T * scale) v on f32 q, k, v [B, H, N, dh] (any strides with a
// contiguous head dim, every pointer and stride 16-byte aligned), keys >=
// n_real masked out, with the optional exact probs tap [B, H, N, N] and
// the optional per-row (m, l).
//
// Replaces, for f32, the row-resident branch of the Pallas TPU kernel
// interactive_vit_tpu/ops/flash_attention.py::flash_attention
// (_rowfull_call, _rowfull_kernel), and is the f32 forward of the
// trainable attention (interactive_vit_tpu/ops/attention_vjp.py:
// attention_train's and attention_train_packed's forward), where it also
// writes each row's (m, l) for the backward (attention_train_tf32.cu, 64
// wide only: heads 80 wide train on the FMA pair). Other f32 operands stay
// on flash_attention.cu (f32 FMA). The contract:
//   s     = (q . k) * dh^-0.5 in f32; keys >= n_real at mask_value;
//   m     = the exact row max; l = rowsum(exp(s - m));
//   probs = exp(s - m) / l, a division; o = probs v, accumulated in f32;
// the tap is the same f32 probs that feed PV. The exponent is expf; the
// scale, subtraction, division and the (m, l) updates are explicitly
// rounded operations (no contraction). Masked keys and keys past N get
// probs of exactly 0 (exp(mask_value - m) underflows).
//
// The products: each is three TF32 tensor-core products on a hi / lo split
// (tf32_attention.cuh), the hi products and the correction terms in two
// accumulators, each over one key tile only (the 8 steps over dh of a
// score; the 64 keys of a warp's PV), added and folded into the running
// sums with round-to-nearest f32 operations. The depth index is permuted
// (2t, 2t + 1), so S's accumulators are PV's A fragment as they stand.
//
// Design (flash_attention_mma.cu's, in f32): one block per (64 query rows,
// head, image) of 4 x P warps. Warps w, w + 4, ... own the same 16 query
// rows, whose split Q fragments stay in registers, and split each tile of
// 64 P keys into P parts of 64. K and V tiles stream through a two-stage
// cp.async ring (K rows of 72 floats, V rows of 68; rows past N
// zero-filled). With maps the block walks the keys twice: pass 1 forms
// each part's (m, l) by the online update, and the parts are combined
// through shared memory (m = max over the parts, l = sum of l_j exp(m_j -
// m), in part order in every warp); pass 2 forms the normalised probs in
// the score registers, and the parts' partial o are added at the end in
// part order; the tap is what fed PV. P is 2 when the grid has at most one
// block an SM (dinov2_s14_reg@518: 22 tiles x 6 heads = 132 blocks of 8
// warps), else 1 (blocks of 4 warps, two an SM): on an H100 SXM, at
// dinov2_s14_reg@518 two parts took 0.1440 ms against one part's 0.2208;
// at N = 577 x 16 heads, B = 4 or vit_t16's train shape one part was as
// fast or faster (tools/kernel_variants.py). Four parts do not fit: 16
// warps of ~240 registers exceed the SM's 65,536.
//
// Heads 80 wide (vit_h14@224: N = 257, 16 heads, 5 x 16 = 80 blocks at
// B = 1, under one an SM): the same design, Q's split fragments (80
// registers) in registers and PV in one part: 255 registers with 16-40
// bytes of stack (32-60 bytes spilled). Q kept in shared memory and split
// as read (196-221 registers, no spill) leaves two key parts' ring no room
// (236,544 bytes > 232,448), and in one part it took 0.0423 ms against
// 0.0333 at vit_h14@224 (maps off; 0.0753 against 0.0565 maps on). The
// key-parts rule holds at the main path: two parts at B = 1 (0.0333,
// against 0.0412 for one), one at B = 2 (160 blocks: 0.0561 against
// 0.0632 for two). At N = 1025 (272 blocks, two an SM, leave a second
// wave of 8) two parts took 0.2485 ms against the rule's 0.2542
// (tools/kernel_variants.py, an H100 SXM; 0.2493 against 0.2657 in an
// earlier call). In one run of chip_smoke.py it took 0.0322 ms at
// vit_h14@224, the FMA kernel 0.0816 and SDPA in f32 0.0327.
//
// The probs tap: its row stride (N * 4 bytes, 5496 at N = 1374) is off the
// 16-byte grid, so a warp stages its 16 x 64 f32 probs in shared memory
// (rows of FT_P_LD = 72 floats at either head width: conflict-free 8-byte
// writes from the fragments) and writes each row as 64 contiguous floats,
// two 128-byte stores.
//
// What bounds it on this card: at dinov2_s14_reg@518 (N = 1374, 6 heads,
// dh = 64, B = 1, f32) the work is 2.90 GFLOP over 8.4 MB: 0.043 ms at the
// f32 FMA peak (67 TFLOP/s); the split issues 3 x 2.90 GFLOP of TF32
// products, 0.0176 ms at the TF32 peak (495 TFLOP/s), on mma.sync (a
// fraction of the peak), with an expf per score on the FMA pipes; with
// maps the two walks issue 1.5x the products, with two expf and one
// division per score, and the 45.3 MB f32 tap adds 0.0135 ms at 3.35 TB/s.
// At vit_h14@224 (dh = 80) 0.338 GFLOP over 5.26 MB: 0.00505 ms at the
// f32 FMA peak, 0.00205 ms for the split's products at the TF32 peak; the
// 4.23 MB tap adds 0.0013 ms. A block walks only 2 to 3 key tiles there,
// so the ring's fill and the parts' combine are likely a large share of
// its 0.032 ms (not measured apart).
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns cudaGetLastError().

#include "tf32_attention.cuh"

namespace {

constexpr int FT_ROWS = 64;            // query rows of a block
constexpr int FT_KW = 64;              // keys of a warp per tile
constexpr int FT_NT = FT_KW / 8;       // 8-key tiles of a warp
constexpr int FT_P_LD = FT_KW + 8;     // the probs staging's rows, floats
constexpr size_t FT_MAX_SMEM = 232448;  // dynamic shared memory a block can have
// maps off in one online walk instead of two (tools/kernel_variants.py)
constexpr bool FT_ONE_WALK_MAPS_OFF = true;

// The block's shape for heads DH wide and SPLIT key parts: 4 x SPLIT
// warps, tiles of 64 x SPLIT keys.
template <int DH, int SPLIT>
struct RowTf32Cfg {
  static_assert(DH == 64 || DH == 80, "heads 64 or 80 wide");
  using D = TfDims<DH>;
  static constexpr int WARPS = 4 * SPLIT, THREADS = 32 * WARPS;
  static constexpr int KT = FT_KW * SPLIT;               // keys of a tile
  static constexpr int STAGE = KT * (D::K_LD + D::V_LD);  // floats: K then V
  static constexpr int PROBS = WARPS * 16 * FT_P_LD;     // the warps' probs staging
  // floats of one key part's partial o: [4 warps][4 DT values][32 lanes]
  static constexpr int XPART = 4 * 4 * D::DT * 32;
  static constexpr size_t RING_BYTES = 2 * STAGE * sizeof(float);
  // (m, l) of each part for each row
  static constexpr size_t STATS_BYTES = SPLIT * FT_ROWS * 2 * sizeof(float);
  static constexpr size_t SMEM = RING_BYTES + PROBS * sizeof(float) + STATS_BYTES;
  static_assert(SMEM <= FT_MAX_SMEM, "the block's shared memory fits");
  // the later parts' partial o go through the ring; Q goes through stage
  // 1's K slot
  static_assert((SPLIT - 1) * XPART * sizeof(float) <= RING_BYTES, "o exchange fits the ring");
  static_assert(FT_ROWS <= KT, "Q fits a K slot");
};

struct RowTf32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* probs;  // [B, H, N, N] contiguous, or null (maps off)
  float* stats;  // [2][B * H * N]: each row's m, l; or null
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  int B, H, N, n_real;
  float scale, mask_value;
};

// Two walks: steps 0 .. T-1 are pass 1 (K tiles: each part's m, l), T ..
// 2T-1 pass 2 (K and V tiles: probs, the tap and PV). One walk (maps off,
// ONE_WALK): steps 0 .. T-1, K and V tiles, the online update. One ring
// across all steps.
template <int DH, int SPLIT, bool ONE_WALK>
__global__ void __launch_bounds__(RowTf32Cfg<DH, SPLIT>::THREADS)
    rowfull_tf32_kernel(const RowTf32Args a) {
  using C = RowTf32Cfg<DH, SPLIT>;
  constexpr int KS = C::D::KS, DT = C::D::DT, K_LD = C::D::K_LD, V_LD = C::D::V_LD;
  extern __shared__ float4 ft_smem4[];
  float* ring = reinterpret_cast<float*>(ft_smem4);  // stage s: K at s * STAGE, V after it
  float* pstage = ring + 2 * C::STAGE;
  float* stats = pstage + C::PROBS;  // [part][row][m, l]
  const int q0 = blockIdx.x * FT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int rw = warp & 3, part = warp >> 2;  // the warp's 16 rows and key part
  const int N = a.N, n_tiles = (N + C::KT - 1) / C::KT, steps = (ONE_WALK ? 1 : 2) * n_tiles;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;

  // Q through stage 1's K slot, tile 0 into stage 0
  float* qs = ring + C::STAGE;
  load_rows_f32<DH>(qs, K_LD, a.q + b * a.q_sb + h * a.q_sh, a.q_sn, q0, FT_ROWS, N, C::THREADS);
  load_rows_f32<DH>(ring, K_LD, kb, a.k_sn, 0, C::KT, N, C::THREADS);
  if (ONE_WALK) load_rows_f32<DH>(ring + C::KT * K_LD, V_LD, vb, a.v_sn, 0, C::KT, N, C::THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* qw = qs + 16 * rw * K_LD;  // the warp's 16 rows of Q
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) load_a_rows<DH>(qh[kc], ql[kc], qw, kc, lane);
  __syncthreads();  // Q read before stage 1 is overwritten

  float oacc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) zero4(oacc[n]);
  // rows g and g + 8 of the warp's 16: every lane of a quad holds the same
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float* pst = pstage + warp * 16 * FT_P_LD;
  const long long prow0 = ((long long)b * a.H + h) * N;  // the head's first row

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      const int nx = it + 1, j1 = (nx % n_tiles) * C::KT;
      float* nxt = ring + (nx & 1) * C::STAGE;
      load_rows_f32<DH>(nxt, K_LD, kb, a.k_sn, j1, C::KT, N, C::THREADS);
      if (ONE_WALK || nx >= n_tiles)
        load_rows_f32<DH>(nxt + C::KT * K_LD, V_LD, vb, a.v_sn, j1, C::KT, N, C::THREADS);
      cp_async_commit();
      cp_async_wait<1>();  // this step's group has landed; the next one flies
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = !ONE_WALK && it >= n_tiles;
    const int jw = (it % n_tiles) * C::KT + FT_KW * part;  // the warp's first key
    const float* Ks = ring + (it & 1) * C::STAGE + FT_KW * part * K_LD;
    const float* Vs = ring + (it & 1) * C::STAGE + C::KT * K_LD + FT_KW * part * V_LD;
    float s[FT_NT][4];
    mma3_rows<DH, FT_NT>(s, qh, ql, Ks, lane);
#pragma unroll
    for (int n = 0; n < FT_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = jw + 8 * n + 2 * t + (e & 1) < a.n_real ? __fmul_rn(s[n][e], a.scale)
                                                          : a.mask_value;

    if (!pass2) {
      // the online update of the part's (m, l); in one walk also o
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, m_next[2], alpha[2];
#pragma unroll
      for (int n = 0; n < FT_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_next[r] = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = expf(__fsub_rn(m_run[r], m_next[r]));
      }
#pragma unroll
      for (int n = 0; n < FT_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(__fsub_rn(s[n][e], m_next[e >> 1]));
          sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
          if (ONE_WALK) s[n][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = __fadd_rn(__fmul_rn(alpha[r], l_run[r]), quad_sum(sum[r]));
        m_run[r] = m_next[r];
      }
      if (ONE_WALK) {
#pragma unroll
        for (int d = 0; d < DT; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) oacc[d][e] = __fmul_rn(oacc[d][e], alpha[e >> 1]);
        mma3_acc_by_cols<DH, FT_NT>(oacc, s, Vs, V_LD, 0, lane);
      } else if (it == n_tiles - 1) {
        // the parts' (m, l) -> the rows', in part order in every warp
        // (every part saw a finite score on every tile: masked keys score
        // mask_value, so every m is finite)
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* st = stats + (part * FT_ROWS + 16 * rw + g + 8 * r) * 2;
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
          for (int j = 1; j < SPLIT; ++j) m = fmaxf(m, st[j * FT_ROWS * 2]);
          float l = 0.f;
#pragma unroll
          for (int j = 0; j < SPLIT; ++j)
            l = __fadd_rn(l, __fmul_rn(st[j * FT_ROWS * 2 + 1],
                                       expf(__fsub_rn(st[j * FT_ROWS * 2], m))));
          l_run[r] = l;
          m_run[r] = m;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < FT_NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fdiv_rn(expf(__fsub_rn(s[n][e], m_run[e >> 1])), l_run[e >> 1]);
      if (a.probs != nullptr) {
        // the probs that feed PV through the warp's staging rows, then row
        // by row to global memory
#pragma unroll
        for (int n = 0; n < FT_NT; ++n) {
          *reinterpret_cast<float2*>(pst + g * FT_P_LD + 8 * n + 2 * t) =
              make_float2(s[n][0], s[n][1]);
          *reinterpret_cast<float2*>(pst + (g + 8) * FT_P_LD + 8 * n + 2 * t) =
              make_float2(s[n][2], s[n][3]);
        }
        __syncwarp();
        const int row0 = q0 + 16 * rw;
        for (int r = 0; r < 16 && row0 + r < N; ++r) {
          float* dst = a.probs + (prow0 + row0 + r) * N + jw;
#pragma unroll
          for (int c = lane; c < FT_KW; c += 32)
            if (jw + c < N) dst[c] = pst[r * FT_P_LD + c];
        }
        __syncwarp();
      }
      mma3_acc_by_cols<DH, FT_NT>(oacc, s, Vs, V_LD, 0, lane);
    }
    __syncthreads();  // this stage consumed before the next prefetch reuses it
  }

  // o = o0 + o1 + ... in part order: the later parts' partial sums through
  // the ring. In one walk each part's o and l are first scaled to the rows'
  // max: m = max m_j, l = sum l_j exp(m_j - m), o = sum o_j exp(m_j - m).
  float* xch = ring + rw * 4 * DT * 32;
  if (ONE_WALK && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* st = stats + (part * FT_ROWS + 16 * rw + g + 8 * r) * 2;
      st[0] = m_run[r];
      st[1] = l_run[r];
    }
  }
  if (part > 0) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(part - 1) * C::XPART + (4 * n + e) * 32 + lane] = oacc[n][e];
  }
  __syncthreads();
  if (part != 0) return;
  float c[SPLIT][2];  // each part's scale of its o, per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ONE_WALK) {
      const float* st = stats + (16 * rw + g + 8 * r) * 2;
      float m = st[0];
#pragma unroll
      for (int j = 1; j < SPLIT; ++j) m = fmaxf(m, st[j * FT_ROWS * 2]);
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < SPLIT; ++j) {
        c[j][r] = expf(__fsub_rn(st[j * FT_ROWS * 2], m));
        l = __fadd_rn(l, __fmul_rn(st[j * FT_ROWS * 2 + 1], c[j][r]));
      }
      m_run[r] = m;
      l_run[r] = l;
    } else {
#pragma unroll
      for (int j = 0; j < SPLIT; ++j) c[j][r] = 1.f;
    }
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float o = ONE_WALK ? __fmul_rn(oacc[n][e], c[0][e >> 1]) : oacc[n][e];
#pragma unroll
      for (int j = 1; j < SPLIT; ++j) {
        const float x = xch[(j - 1) * C::XPART + (4 * n + e) * 32 + lane];
        o = __fadd_rn(o, ONE_WALK ? __fmul_rn(x, c[j][e >> 1]) : x);
      }
      oacc[n][e] = ONE_WALK ? __fdiv_rn(o, l_run[e >> 1]) : o;
    }

  float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * rw + g + 8 * r;
    if (row >= N) continue;
    float* orow = ob + (long long)row * a.o_sn + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      *reinterpret_cast<float2*>(orow + 8 * dn) = make_float2(oacc[dn][2 * r], oacc[dn][2 * r + 1]);
    if (a.stats != nullptr && t == 0) {
      const long long plane = (long long)a.B * a.H * N;
      a.stats[prow0 + row] = m_run[r];
      a.stats[plane + prow0 + row] = l_run[r];
    }
  }
}

template <int DH, int SPLIT, bool ONE_WALK>
cudaError_t launch(const RowTf32Args& a, cudaStream_t stream) {
  using C = RowTf32Cfg<DH, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(rowfull_tf32_kernel<DH, SPLIT, ONE_WALK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + FT_ROWS - 1) / FT_ROWS, a.H, a.B);
  rowfull_tf32_kernel<DH, SPLIT, ONE_WALK><<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, int SPLIT>
cudaError_t launch_split(const RowTf32Args& a, cudaStream_t stream) {
  if constexpr (FT_ONE_WALK_MAPS_OFF) {
    if (a.probs == nullptr) return launch<DH, SPLIT, true>(a, stream);
  }
  return launch<DH, SPLIT, false>(a, stream);
}

// A grid of at most one block an SM takes each tile in two key parts (8
// warps an SM); a larger one in one (two blocks of 4 warps an SM).
template <int DH>
cudaError_t launch_dh(const RowTf32Args& a, int sms, cudaStream_t s) {
  const long long blocks = (long long)((a.N + FT_ROWS - 1) / FT_ROWS) * a.H * a.B;
  return blocks <= sms ? launch_split<DH, 2>(a, s) : launch_split<DH, 1>(a, s);
}

// the head widths the kernel is built for
constexpr int FT_DHS[] = {64, 80};

}  // namespace

extern "C" {

// The i-th head width the kernel takes, in increasing order; 0 past the
// last.
int ivt_flash_tf32_dh(int i) {
  constexpr int n = sizeof(FT_DHS) / sizeof(FT_DHS[0]);
  return i >= 0 && i < n ? FT_DHS[i] : 0;
}

// f32 q, k, v, o with heads dh wide (ivt_flash_tf32_dh); strides in
// elements (image, head, token), every pointer and stride 16-byte aligned;
// probs [B, H, N, N] contiguous, or null (maps off); stats [2][B * H * N]
// (each row's m, then each row's l), or null. Returns a cudaError_t value.
int ivt_flash_attention_tf32x3(const void* q, const void* k, const void* v, void* o, void* probs,
                               float* stats, long long q_sb, long long q_sh, long long q_sn,
                               long long k_sb, long long k_sh, long long k_sn, long long v_sb,
                               long long v_sh, long long v_sn, long long o_sb, long long o_sh,
                               long long o_sn, int B, int H, int N, int dh, int n_real, float scale,
                               float mask_value, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || (dh != 64 && dh != 80) || n_real <= 0 || n_real > N)
    return (int)cudaErrorInvalidValue;
  RowTf32Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.probs = static_cast<float*>(probs);
  a.stats = stats;
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
  a.B = B;
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
  return (int)(dh == 64 ? launch_dh<64>(a, sms, s) : launch_dh<80>(a, sms, s));
}

}  // extern "C"
