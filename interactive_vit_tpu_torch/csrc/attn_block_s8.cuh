// Row 1's s8 attention (the TPU kernel's int8_scores / int8_pv, the
// server's --attn int8-scores) on the int8 tensor cores, mma.sync
// m16n8k32 s8 x s8 -> s32, for one (32 query rows, head, image) a block:
// kernel B of fused_attn_block_mma.cu (bf16) and fused_attn_block_tf32.cu
// (f32), which instantiate it for their activation type T. It replaces
// fused_attn_block.cu's __dp4a attention_kernel<T, true> and computes what
// that kernel computes, in its order:
//   q and k quantized per row with the half-up quantizer (common.cuh
//   quant_scale / quant_half_up; ops/quant.py quant_rows_mosaic);
//   si = q8 k8^T exact in s32, s = si.f32 * (qs * scale) * ks, each
//   product rounded on its own; ToMe's key bias added after, rounded;
//   the softmax one warp a row over the row's scores in shared memory (fast:
//   exp(min(s, 80)) with the normalisation deferred; exact: exp(s - max));
//   heads whose probs are tapped or feed the head-mean normalise before PV
//   (probs = p * r), the others fold r into the output;
//   int8_pv: the probs (or the unnormalised fast p) quantized per row, v per
//   column, o = oi.f32 * ps * vs (maps off: oi.f32 * (ps * r) * vs), oi =
//   p8 v8 exact in s32; without it the PV product is dense: the probs (or
//   p) cast to T, then bf16 mma.sync m16n8k16 (T = bf16) or three TF32
//   products a product (T = f32), f32 sums, times r where not normalised.
// The s32 sums are exact, so on the same qkv the kernel's integer stages
// equal the __dp4a kernel's bit for bit; it departs from the plain version
// only where an f32 value that the two compute in another order lands on
// the other side of a rounding boundary (fused_attn_block.cu's notes).
//
// Row-resident, as the __dp4a kernel: fits(..., int8_scores=True) caps N
// (268 keys at heads 64 wide), so a block holds its 32 rows of scores for
// every key, each head's int8 k [NP][DHP] (keys padded to NP, a multiple of
// 32, the head dim to DHP, a multiple of 32, both zero-filled: an s8 k32
// step takes 32 of them) and, with int8_pv, v transposed as it is
// quantized, v8^T [DH][NP], which is the B operand of PV as it stands: K
// [NP][DHP] is the B operand of the scores. Each fragment is one 32-bit
// shared load; rows of QK_LD = DHP + 16 and PQ_LD = NP + 16 bytes put a
// warp's loads on 32 banks. v is staged in T by cp.async while q and k are
// quantized (their rows straight from qkv).
//
// Eight warps: q and k are quantized four rows a warp at a time (eight
// lanes a row); in the products warp w takes query rows 16 (w & 1) .. + 15
// and every fourth 8-key tile (scores) or 8-column tile of o (PV) from
// w >> 1.
//
// Everything lives in an anonymous namespace, as in common.cuh.

#pragma once

#include "common.cuh"
#include "mlp_cluster.cuh"
#include "mma_attention.cuh"
#include "tf32_attention.cuh"

namespace {

constexpr int S8_ROWS = 32;  // query rows of a block
constexpr int S8_THREADS = 256, S8_WARPS = S8_THREADS / 32;

// The head dim padded to whole k32 steps, and the int8 q / k rows (bytes).
__host__ __device__ inline int s8_dhp(int dh) { return (dh + 31) / 32 * 32; }
__host__ __device__ inline int s8_keys(int n) { return (n + 31) / 32 * 32; }

// Rows of the staged v in T (elements): bf16 rows for ldmatrix.trans, f32
// rows for the split's column loads (tf32_attention.cuh's V_LD).
__host__ __device__ inline int s8_v_ld(int dh, int esize) { return dh + (esize == 2 ? 8 : 4); }

__host__ __device__ inline size_t s8_up(size_t bytes) { return (bytes + 15) / 16 * 16; }

struct S8Layout {
  size_t s, v, q8, k8, p, vt, sc, total;  // byte offsets, and the size
};

// The block's shared memory for n keys of heads dh wide in activations of
// esize bytes, every region 16-byte aligned:
//   s   f32 scores, then probs or p   [32][NP + 8]
//   v   v in T                        [NP][s8_v_ld]
//   q8  int8 q                        [32][DHP + 16]
//   k8  int8 k                        [NP][DHP + 16]
//   p   int8 p [32][NP + 16], or (bf16, dense PV) bf16 p [32][NP + 8]
//   vt  int8 v^T                      [DH][NP + 16]
//   sc  f32 scales of q rows, k rows, v columns, p rows, and the rows' 1 / l
__host__ __device__ inline S8Layout s8_layout(int n, int dh, int esize) {
  const int np = s8_keys(n), dhp = s8_dhp(dh);
  S8Layout L;
  L.s = 0;
  L.v = L.s + s8_up((size_t)S8_ROWS * (np + 8) * 4);
  L.q8 = L.v + s8_up((size_t)np * s8_v_ld(dh, esize) * esize);
  L.k8 = L.q8 + s8_up((size_t)S8_ROWS * (dhp + 16));
  L.p = L.k8 + s8_up((size_t)np * (dhp + 16));
  const size_t p8 = (size_t)S8_ROWS * (np + 16);
  const size_t pb = esize == 2 ? (size_t)S8_ROWS * (np + 8) * 2 : 0;
  L.vt = L.p + s8_up(p8 > pb ? p8 : pb);
  L.sc = L.vt + s8_up((size_t)dh * (np + 16));
  L.total = L.sc + s8_up((size_t)(3 * S8_ROWS + np + dh) * 4);
  return L;
}

template <typename T>
struct S8Args {
  const T* qkv;        // [B, N, 3D]
  T* o;                // [B, N, D]: the head outputs
  T* probs;            // [B, n_emit, N, N], or null
  float* head_probs;   // [B, H, N, N] f32 probs for the head-mean, or null
  const float* kb;     // ToMe's key bias [B, N] f32, or null
  unsigned long long emit_mask;
  int n_emit, N, D, H, fast, pv8;
  float scale;
  // the integer stages, written where given (a check of the kernel):
  // q8, k8, v8 [B, H, N, DH] int8, si = q8 k8^T [B, H, N, N] s32, p8 [B,
  // H, N, N] int8 and oi = p8 v8 [B, H, N, DH] s32 (v8, p8, oi with pv8)
  int8_t *q8, *k8, *v8, *p8;
  int *si, *oi;
};

// One int8 row of DH values from src (T, contiguous; zeros where not live),
// quantized with its own scale, into dst (pad bytes up to DHP zero): eight
// lanes of a warp, `sub` 0..7 of them, each DH / 8 consecutive values; the
// row's max over the eight by three shuffles (every lane of the warp takes
// part).
template <typename T, int DH>
__device__ __forceinline__ float s8_quant_row(int8_t* dst, const T* src, bool live, int sub) {
  constexpr int PER = DH / 8, DHP = (DH + 31) / 32 * 32;
  float v[PER];
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = live ? to_f(src[sub * PER + i]) : 0.f;
    mx = fmaxf(mx, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float sc = quant_scale(mx);
#pragma unroll
  for (int i = 0; i < PER; ++i) dst[sub * PER + i] = (int8_t)quant_half_up(v[i], sc);
  for (int d = DH + sub; d < DHP; d += 8) dst[d] = 0;
  return sc;
}

template <typename T, int DH>
__global__ void __launch_bounds__(S8_THREADS) row1_s8_mma_kernel(const S8Args<T> a) {
  constexpr int DHP = (DH + 31) / 32 * 32, QK_LD = DHP + 16;
  constexpr int ESIZE = (int)sizeof(T);
  constexpr int V_LD = DH + (ESIZE == 2 ? 8 : 4);
  extern __shared__ float4 s8_smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(s8_smem4);
  const int N = a.N, D = a.D, NP = s8_keys(N);
  const S8Layout L = s8_layout(N, DH, ESIZE);
  const int S_LD = NP + 8, PQ_LD = NP + 16;
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  int8_t* Q8 = reinterpret_cast<int8_t*>(smem + L.q8);
  int8_t* K8 = reinterpret_cast<int8_t*>(smem + L.k8);
  int8_t* P8 = reinterpret_cast<int8_t*>(smem + L.p);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  int8_t* Vt = reinterpret_cast<int8_t*>(smem + L.vt);
  float* q_sc = reinterpret_cast<float*>(smem + L.sc);
  float* k_sc = q_sc + S8_ROWS;
  float* v_sc = k_sc + NP;
  float* p_sc = v_sc + DH;
  float* rinv = p_sc + S8_ROWS;

  const int q0 = blockIdx.x * S8_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(S8_ROWS, N - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long ld3 = 3LL * D;
  const T* qb = a.qkv + (long long)b * N * ld3 + h * DH;
  const T* kbase = qb + D;
  const T* vbase = qb + 2 * D;
  const bool emit_h = (a.emit_mask >> h) & 1ULL;
  const bool want_mean = a.head_probs != nullptr;
  const bool norm_h = emit_h || want_mean;
  const int tap = __popcll(a.emit_mask & ((1ULL << h) - 1ULL));
  const float* kbr = a.kb != nullptr ? a.kb + (long long)b * N : nullptr;
  const long long hb = ((long long)b * a.H + h) * N;  // the head's first row of a part

  // v in T, rows past N zero-filled; lands while q and k are quantized
  if constexpr (ESIZE == 2)
    load_tile_async<DH>(reinterpret_cast<__nv_bfloat16*>(Vs),
                        reinterpret_cast<const __nv_bfloat16*>(vbase), ld3, 0, NP, N, S8_THREADS);
  else
    load_rows_f32<DH>(reinterpret_cast<float*>(Vs), V_LD, reinterpret_cast<const float*>(vbase),
                      ld3, 0, NP, N, S8_THREADS);
  cp_async_commit();

  // q rows (rows past N quantize to 0) and k rows, four a warp at a time
  // (S8_ROWS + NP is a multiple of 32: every lane runs every iteration)
  const int sub = lane & 7;
  for (int r0 = 0; r0 < S8_ROWS + NP; r0 += 4 * S8_WARPS) {
    const int r = r0 + 4 * warp + (lane >> 3);
    if (r < S8_ROWS) {
      const float sc = s8_quant_row<T, DH>(Q8 + r * QK_LD, qb + (long long)(q0 + r) * ld3, r < rows, sub);
      if (sub == 0) q_sc[r] = sc;
      if (a.q8 != nullptr && r < rows)
        for (int d = sub; d < DH; d += 8) a.q8[(hb + q0 + r) * DH + d] = Q8[r * QK_LD + d];
    } else {
      const int j = r - S8_ROWS;
      const float sc = s8_quant_row<T, DH>(K8 + j * QK_LD, kbase + (long long)j * ld3, j < N, sub);
      if (sub == 0) k_sc[j] = sc;
      if (a.k8 != nullptr && blockIdx.x == 0 && j < N)
        for (int d = sub; d < DH; d += 8) a.k8[(hb + j) * DH + d] = K8[j * QK_LD + d];
    }
  }
  if (a.pv8) {
    for (int c = tid; c < DH; c += S8_THREADS) v_sc[c] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  if (a.pv8) {
    // v's column maxima (non-negative floats order as their bits), then v
    // per column, quantized and transposed: v8^T [DH][NP]
    constexpr int PARTS = S8_THREADS / DH > 0 ? S8_THREADS / DH : 1;
    if (tid < PARTS * DH) {
      const int c = tid % DH, part = tid / DH;
      float mx = 0.f;
      for (int j = part; j < N; j += PARTS) mx = fmaxf(mx, fabsf(to_f(Vs[j * V_LD + c])));
      atomicMax(reinterpret_cast<int*>(v_sc) + c, __float_as_int(mx));
    }
    __syncthreads();
    for (int c = tid; c < DH; c += S8_THREADS) v_sc[c] = quant_scale(v_sc[c]);
    __syncthreads();
    for (int e = tid; e < DH * (NP / 4); e += S8_THREADS) {
      const int c = e % DH, w = e / DH;
      const float sc = v_sc[c];
      int q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = quant_half_up(to_f(Vs[(4 * w + i) * V_LD + c]), sc);
      reinterpret_cast<int*>(Vt + c * PQ_LD)[w] = pack4(q[0], q[1], q[2], q[3]);
      if (a.v8 != nullptr && blockIdx.x == 0)
        for (int i = 0; i < 4 && 4 * w + i < N; ++i) a.v8[(hb + 4 * w + i) * DH + c] = (int8_t)q[i];
    }
  }

  // scores: warp w, rows 16 (w & 1) .., key tiles w >> 1, + 2, ...
  {
    const int rh = warp & 1;
    uint32_t aq[DHP / 32][4];
#pragma unroll
    for (int ks = 0; ks < DHP / 32; ++ks) {
      const int8_t* p = Q8 + (16 * rh + g) * QK_LD + 32 * ks + 4 * t;
      aq[ks][0] = *reinterpret_cast<const uint32_t*>(p);
      aq[ks][1] = *reinterpret_cast<const uint32_t*>(p + 8 * QK_LD);
      aq[ks][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      aq[ks][3] = *reinterpret_cast<const uint32_t*>(p + 8 * QK_LD + 16);
    }
    for (int nt = warp >> 1; nt < NP / 8; nt += S8_WARPS / 2) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < DHP / 32; ++ks) {
        const int8_t* kp = K8 + (8 * nt + g) * QK_LD + 32 * ks + 4 * t;
        mma_s8(acc, aq[ks], *reinterpret_cast<const uint32_t*>(kp),
               *reinterpret_cast<const uint32_t*>(kp + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * rh + g + 8 * (e >> 1), j = 8 * nt + 2 * t + (e & 1);
        if (i < rows && j < N) {
          if (a.si != nullptr) a.si[(hb + q0 + i) * N + j] = acc[e];
          const float sc = __fmul_rn(__fmul_rn((float)acc[e], __fmul_rn(q_sc[i], a.scale)), k_sc[j]);
          S[i * S_LD + j] = kbr != nullptr ? __fadd_rn(sc, kbr[j]) : sc;
        }
      }
    }
  }
  __syncthreads();

  // softmax: one warp a query row (fused_attn_block.cu's order); the row's
  // operand of PV written beside it, keys past N as zeros
  for (int i = warp; i < rows; i += S8_WARPS) {
    float* s = S + i * S_LD;
    float mx = 0.f;
    if (!a.fast) {
      mx = -INFINITY;
      for (int j = lane; j < N; j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
    }
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float p = a.fast ? expf(fminf(s[j], 80.f)) : expf(s[j] - mx);
      s[j] = p;
      sum += p;
    }
    const float r = 1.f / warp_sum(sum);
    if (lane == 0) rinv[i] = r;
    if (norm_h) {
      T* prow = emit_h ? a.probs + (((long long)b * a.n_emit + tap) * N + q0 + i) * N : nullptr;
      float* hrow = want_mean ? a.head_probs + (((long long)b * a.H + h) * N + q0 + i) * N : nullptr;
      for (int j = lane; j < N; j += 32) {
        const float pr = s[j] * r;
        const T pb = from_f<T>(pr);
        if (emit_h) prow[j] = pb;
        if (want_mean) hrow[j] = pr;  // f32 probs, summed over heads by kernel D
        s[j] = a.pv8 ? pr : to_f(pb);  // PV consumes the cast probs (s8: the f32 ones)
      }
    } else if (!a.pv8) {
      for (int j = lane; j < N; j += 32) s[j] = to_f(from_f<T>(s[j]));
    }
    for (int j = N + lane; j < NP; j += 32) s[j] = 0.f;
    __syncwarp();
    if (a.pv8) {
      // the row's probs (maps on) or unnormalised p (maps off), per row
      float pm = 0.f;
      for (int j = lane; j < N; j += 32) pm = fmaxf(pm, fabsf(s[j]));
      const float sc = quant_scale(warp_max(pm));
      if (lane == 0) p_sc[i] = sc;
      for (int w = lane; w < NP / 4; w += 32) {
        const float* sw = s + 4 * w;
        reinterpret_cast<int*>(P8 + i * PQ_LD)[w] =
            pack4(quant_half_up(sw[0], sc), quant_half_up(sw[1], sc), quant_half_up(sw[2], sc),
                  quant_half_up(sw[3], sc));
      }
      if (a.p8 != nullptr) {
        __syncwarp();
        for (int j = lane; j < N; j += 32) a.p8[(hb + q0 + i) * N + j] = P8[i * PQ_LD + j];
      }
    } else if constexpr (ESIZE == 2) {
      for (int j = lane; j < NP; j += 32) Pb[i * S_LD + j] = __float2bfloat16(s[j]);
    }
  }
  __syncthreads();

  const int rh = warp & 1;
  T* ob = a.o + ((long long)b * N + q0) * D + h * DH;
  if (a.pv8) {
    // o = P V in s8: column tiles w >> 1, + 2, ...
    uint32_t ap[4];
    for (int ct = warp >> 1; ct < DH / 8; ct += S8_WARPS / 2) {
      int acc[4] = {0, 0, 0, 0};
      for (int ks = 0; ks < NP / 32; ++ks) {
        const int8_t* pp = P8 + (16 * rh + g) * PQ_LD + 32 * ks + 4 * t;
        ap[0] = *reinterpret_cast<const uint32_t*>(pp);
        ap[1] = *reinterpret_cast<const uint32_t*>(pp + 8 * PQ_LD);
        ap[2] = *reinterpret_cast<const uint32_t*>(pp + 16);
        ap[3] = *reinterpret_cast<const uint32_t*>(pp + 8 * PQ_LD + 16);
        const int8_t* vp = Vt + (8 * ct + g) * PQ_LD + 32 * ks + 4 * t;
        mma_s8(acc, ap, *reinterpret_cast<const uint32_t*>(vp),
               *reinterpret_cast<const uint32_t*>(vp + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * rh + g + 8 * (e >> 1), c = 8 * ct + 2 * t + (e & 1);
        if (i >= rows) continue;
        if (a.oi != nullptr) a.oi[(hb + q0 + i) * DH + c] = acc[e];
        const float ps = norm_h ? p_sc[i] : __fmul_rn(p_sc[i], rinv[i]);
        ob[(long long)i * D + c] = from_f<T>(__fmul_rn(__fmul_rn((float)acc[e], ps), v_sc[c]));
      }
    }
    return;
  }

  if constexpr (ESIZE == 2) {
    // o = P V, bf16 operands, f32 sums: 16-column pairs w >> 1, + 2, ...
    const __nv_bfloat16* Vb = reinterpret_cast<const __nv_bfloat16*>(Vs);
    for (int dp = warp >> 1; dp < DH / 16; dp += S8_WARPS / 2) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < NP / 16; ++ks) {
        uint32_t pa[4], bv[4];
        ldmatrix_x4(pa, smem_addr(Pb + (16 * rh + (lane & 15)) * S_LD + 16 * ks + (lane >> 4) * 8));
        load_b_cols<DH>(bv, Vb, 16 * ks, 16 * dp, lane);
        mma_bf16(acc[0], pa, bv[0], bv[1]);
        mma_bf16(acc[1], pa, bv[2], bv[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * rh + g + 8 * half;
        if (i >= rows) continue;
        const float r = rinv[i];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v0 = acc[u][2 * half], v1 = acc[u][2 * half + 1];
          if (!norm_h) {
            v0 *= r;
            v1 *= r;
          }
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)i * D + 16 * dp + 8 * u + 2 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  } else {
    // o = P V on split TF32, the products of 32 keys folded at a time:
    // 8-column tiles w >> 1, + 2, ...
    const float* Vf = reinterpret_cast<const float*>(Vs);
    for (int ct = warp >> 1; ct < DH / 8; ct += S8_WARPS / 2) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < NP; k0 += 32) {
        float big[4], small[4];
        zero4(big);
        zero4(small);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const float* p = S + (16 * rh + g) * S_LD + k0 + 8 * kc + 2 * t;
          const float2 top = *reinterpret_cast<const float2*>(p);
          const float2 bot = *reinterpret_cast<const float2*>(p + 8 * S_LD);
          uint32_t ah[4], al[4];
          split(top.x, ah[0], al[0]);
          split(bot.x, ah[1], al[1]);
          split(top.y, ah[2], al[2]);
          split(bot.y, ah[3], al[3]);
          const float* vr = Vf + (k0 + 8 * kc + 2 * t) * V_LD + 8 * ct + g;
          mma_3xtf32(big, small, ah, al, vr[0], vr[V_LD]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], fold_rn(big[e], small[e]));
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * rh + g + 8 * half;
        if (i >= rows) continue;
        const float r = rinv[i];
        float v0 = acc[2 * half], v1 = acc[2 * half + 1];
        if (!norm_h) {
          v0 *= r;
          v1 *= r;
        }
        T* out = ob + (long long)i * D + 8 * ct + 2 * t;
        out[0] = from_f<T>(v0);
        out[1] = from_f<T>(v1);
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch_s8(const S8Args<T>& a, int B, cudaStream_t stream) {
  const size_t smem = s8_layout(a.N, DH, (int)sizeof(T)).total;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(row1_s8_mma_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + S8_ROWS - 1) / S8_ROWS, a.H, B);
  row1_s8_mma_kernel<T, DH><<<grid, S8_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
