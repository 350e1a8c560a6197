// Row-resident attention for Hopper (sm_90a): o = softmax(q k^T / sqrt(dh)) v
// on q, k, v [B, H, N, dh] (any strides with a contiguous head dim), with
// optional exact probs [B, H, N, N] and keys >= n_real masked out.
//
// Replaces the row-resident branch of the Pallas TPU kernel
// interactive_vit_tpu/ops/flash_attention.py::flash_attention
// (_rowfull_call, _rowfull_kernel): one query block against every key,
// the exact softmax of the whole row. Its numerics and cast points: scores
// in f32; padded keys set to -0.7 * f32 max; the row max subtracted; probs
// = p / rowsum (a division, not a reciprocal product); probs cast to the
// value dtype for PV and to the query dtype for the tap (the same dtype
// here); o f32-accumulated and cast. With maps off the cast points are the
// same: the whole row of scores is held, so normalised probs are formed
// before PV either way (an online softmax would cast unnormalised p).
//
// What the TPU kernel's grid did and this one does not: a query block of
// the whole (8-rounded) sequence, with K and V resident in VMEM. Here each
// (query tile of 32 or 16 rows, head, image) is one block of the key-tiled
// attention kernel (common.cuh): the tile's score rows stay in shared
// memory, K and V stream through in tiles of 64 keys.
//
// What bounds it on this card: at dinov2_s14_reg@518 (N=1374, 6 heads,
// dh=64, B=1, bf16) the work is 2.90 GFLOP over 4.2 MB with maps off, so at
// the card's published rates it is bound by operations (~3 us); with maps
// the 22.7 MB probs tap makes it bound by bytes (~8 us). This version does
// every product with f32 FMA from shared memory, no tensor cores, so it is
// bound by instruction issue far above both; tensor-core tiles are later
// work. Queries past the first N rows are never computed, keys past N never
// read, so ragged N needs no host-side padding.
//
// Plain C interface, bound from Python with ctypes; the launch goes on the
// caller's stream and the entry returns the first CUDA error.

#include "common.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides in elements (image, head,
// token) of q, k, v and o; probs [B, H, N, N] contiguous, or null (maps
// off). Returns a cudaError_t value.
int ivt_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                        void* probs, long long q_sb, long long q_sh, long long q_sn,
                        long long k_sb, long long k_sh, long long k_sn, long long v_sb,
                        long long v_sh, long long v_sn, long long o_sb, long long o_sh,
                        long long o_sn, int B, int H, int N, int dh, int n_real, float scale,
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
  a.probs = probs;
  a.head_probs = nullptr;
  a.H = H;
  a.N = N;
  a.dh = dh;
  a.n_real = n_real;
  a.scale = scale;
  a.mask_value = mask_value;
  a.softmax = SOFTMAX_EXACT_DIV;
  a.norm = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_tiled_attention<float>(a, B, s);
  if (dtype == 1) return (int)launch_tiled_attention<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
