"""Design variants of the tensor-core kernels, timed on the card.

    python -m interactive_vit_tpu_torch.tools.kernel_variants

Each variant is a kernel source under ``csrc/`` with a few exact text
replacements: a constant changed, or another way of doing one step. The
tool writes every variant to ``build/kernel_variants/``, builds them all
at once (one ``nvcc -Xptxas -v`` each, printing each kernel's registers
and spills), holds each against its plain version at the main paths'
shapes (the kernel's own bounds: bf16 o within 2^-6 of its scale and
probs within min(2^-7, 2^-5 |ref| + 1e-6), masked keys' probs exactly 0;
f32 within 1e-4), and times them with CUDA events, every variant twice, in
one order and then the reverse. It prints the card's name and power
limit first. The variants:

* ``flash_attention_mma.cu`` (row 3, bf16): the key parts of a tile as
  chosen by the grid (the source: at 64 wide 4 for a grid of at most one
  block an SM, else 2; at 80 wide 2), always 2, always 4; at heads 64 and
  80 wide;
* ``flash_attention_online_tf32.cu`` (row 4, f32 on split TF32): PV in
  one part of o's columns (the source), in 2 and in 4, and K and V split
  into hi and lo tiles in shared memory once a tile (PV in 2 parts, to
  compare with the register split at the same parts); heads 80 wide: Q's
  split fragments in registers, key tiles of 32 and PV in 5 parts (the
  source), and Q kept in shared memory (split as read), key tiles of 64,
  PV in 1 or 2 parts;
* ``flash_attention_tf32.cu`` (row 3, f32 on split TF32): the key parts of
  a tile as chosen by the grid and maps off in one online walk (the
  source), always 1 part, always 2, and maps off in two walks as maps on
  (parts by the grid); heads 80 wide: the key parts by the grid (the
  source), always 1, always 2, and Q kept in shared memory (in one key
  part: two parts' ring leaves it no room);
* ``headwise_attn_block_mma.cu`` and ``headwise_attn_block_tf32.cu``
  (row 2, the headwise block, bf16 on the tensor cores and f32 on split
  TF32): key tiles as in the sources (bf16 64 keys; f32 32 at 64 wide, 64
  at 80) and the head-mean through the f32 per-head workspace and the
  head-mean pass (the sources), against other key tiles (bf16 128; f32 64
  at 64 wide, 32 at 80) and against one block per query tile walking the
  heads in order,
  summing the mean in place; held against ``headwise_attn_block_reference``
  (y, maps, mean within the bounds above) and timed after QKV, maps off
  and maps + mean, at vit_l16@384 (heads 64 wide; B=1 and 4) and
  vit_h14@742 and @224 (heads 80 wide), with ``--baseline`` beside the
  other checkout's ``headwise_attn_block.cu`` (the FMA kernel the routes
  replace);
* ``attention_train_tf32.cu`` (rows 8-9's backward, f32 on split TF32):
  streamed tiles of 32 keys or queries taken whole (the source), tiles of
  64 in halves of 32, tiles of 32 in halves of 16, and tiles of 16 taken
  whole; heads 80 wide: tiles of 16 with the products by a streamed tile
  one 8-column tile at a time (``mma3_acc_by_cols_dmajor``, the source),
  the 64-wide layout widened (every 8-column tile's sums at once), tiles
  of 32 in either order and tiles of 64 one 8-column tile at a time;
* ``attention_train_mma.cu`` (rows 8-9's backward, bf16 on the tensor
  cores): heads 80 wide, parts of 16 at three blocks an SM for both
  kernels (the source), dk/dv at two, halves of 32 with dk/dv at two and
  three, whole tiles with dk/dv at two, and dq at two;
  each backward held against
  ``head_grads_reference`` (f32: dq, dk, dv within 1e-5 of each one's
  largest value; bf16: each element within 2^-6 of its plain value plus
  2^-8 of the largest) from the forward's own (m, l).

* ``fused_mlp_block_mma.cu`` and ``fused_mlp_w8a8_mma.cu`` (rows 6 and 7,
  the MLP branch on the tensor cores, on ``mlp_cluster.cuh``): the sources
  (the row tile ``fused_mlp.row_tile`` picks by the row count, 16 KB
  weight stages), tiles of 32 and of 64 rows always (the tile the entry is
  handed) and 8 KB stages (a copy of the header with its constant
  changed, written beside the variant's source), beside the
  FMA and ``__dp4a`` kernels they replace; row 6's f32 route
  ``fused_mlp_block_tf32.cu`` (split TF32) as it is, with tiles of 16 or
  32 rows always, and at 16 rows splitting A as it reads it; held against
  the plain versions
  (y within 2^-6 of its scale, two calls the same bits) and timed on
  device time alone (the stream held ~10 ms before the timed calls) at
  vit_b16 (B = 1 and 8, bf16 and f32) and swin_t's four stages (row 6;
  stages 0 and 1 on chunks of 96); and ``row6_time_phases`` /
  ``row7_time_phases``, timing only: block
  (0, 0) stamps %globaltimer between the kernels' phases (LN2, fc1, the
  max exchange, fc2 with the cluster sums) and reports them.

* ``fused_attn_block_mma.cu`` (row 1, the whole-image block, bf16 on the
  tensor cores): the QKV kernel's row tile by the row count (the source)
  and tiles of 32 or of 64 rows always (LN1 runs as a pass of its own
  before the product; once a row tile in the product's prologue it was
  slower, as the source's notes record);
  beside them the FMA kernel they replace (``row1_fma``, this checkout's
  ``fused_attn_block.cu``); held against ``fused_attn_block_reference``
  (y within 2^-6 of its scale, the maps and mean per element) and timed
  on device time alone, maps off and maps + mean, at vit_b16 (B = 1 and
  8) and vit_t16.

* ``fused_window_attn_mma.cu`` and ``fused_window_attn_tf32.cu`` (row 5,
  the window attention, bf16 on the tensor cores and f32 on split TF32):
  the attention kernel's grid, one block per (window, head, image) (the
  sources) against one per (window, image) taking the heads in turn
  (``row5_*_head_loop``); beside them the FMA kernel they replace
  (``row5_fma``, this checkout's ``fused_window_attn.cu``, in both
  dtypes); held against ``fused_window_attn_reference`` (a within 2^-6 of
  its scale in bf16, the maps per element; f32 within 1e-4) and timed on
  device time alone, maps off and on, unshifted, at swin_t's four stages
  (B = 1) and stage 2 at B = 8.

Heads 64 wide are timed at dinov2_s14_reg's and vit_b16's shapes, heads
80 wide (the variants whose names hold ``dh80``) at vit_h14's: N = 2810
(@742) for row 4, N = 257 (@224) and 1025 (@448) for row 3 (bf16 and
f32), and the train backward at train run (f)'s (B=2, 16 heads, N=257)
and run (g)'s (B=8) shapes.

    python -m interactive_vit_tpu_torch.tools.kernel_variants \
        --only dh80 row4_pv_1 --baseline DIR

``--only`` keeps the variants whose names hold one of the given parts;
``--baseline DIR`` adds, to each group of heads 64 wide, the source as it
stands in another checkout ``DIR`` (the variant ``baseline``), built and
timed in the same turns: the way to hold a source edit against its parent
on one card. A header edit that must leave other kernels as they were is
checked by their machine code instead:

    python -m interactive_vit_tpu_torch.tools.kernel_variants \
        --baseline DIR --sass attention_train_mma attention_train_tf32

compiles each named source here and in ``DIR`` and compares their SASS
(``cuobjdump -sass``) kernel by kernel, instruction by instruction
(addresses, encodings and the anonymous namespace's hash aside): every
kernel of ``DIR``'s source against its counterpart here, where a kernel
that has since been templated on the head width is its 64-wide
instantiation, and the kernels only here (other widths) listed as new; it
exits non-zero if any differs or has no counterpart.

Needs a CUDA card and ``nvcc``; it raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.ops import fused_block as fb
from interactive_vit_tpu_torch.ops import fused_mlp as fm
from interactive_vit_tpu_torch.ops import fused_window as fw
from interactive_vit_tpu_torch.ops import quant
from interactive_vit_tpu_torch.runtime import cuda_build

OUT_DIR = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "kernel_variants")

ROW_PARTS = ("  return blocks <= sms ? launch_rowfull<DH, "
             "FM_FEW_BLOCKS_PARTS<DH>>(a, B, s)\n"
             "                       : launch_rowfull<DH, 2>(a, B, s);")
PV_PARTS = "constexpr int TF_PV_PARTS = 1;"
ROW_TF32_PARTS = ("  return blocks <= sms ? launch_split<DH, 2>(a, s) : "
                  "launch_split<DH, 1>(a, s);")
ONE_WALK = "constexpr bool FT_ONE_WALK_MAPS_OFF = true;"
TRAIN_KT = "constexpr int TT_ROWS = 64, TT_THREADS = 128, TT_KT = 32;"
TRAIN_HALF = "constexpr int TT_HALF = TT_KT;"
# heads 80 wide: the f32 backward's streamed tile and product order, the
# bf16 backward's part of a tile and minimum blocks an SM
TRAIN_KT_80 = "constexpr int TT_KT_80 = 16;"
TRAIN_D_MAJOR_80 = "constexpr bool TT_D_MAJOR_80 = true;"
TRAIN_N_MAJOR_80 = (TRAIN_D_MAJOR_80, TRAIN_D_MAJOR_80.replace("true", "false"))
TRAIN_MMA_80 = ("constexpr int TM_HALF_80 = 16, TM_DQ_BLOCKS_80 = 3, "
                "TM_DKDV_BLOCKS_80 = 3;")


def _train_mma_80(half: int = 16, dq: int = 3, dkdv: int = 3):
    """The bf16 backward's 80-wide part of a tile and minimum blocks."""
    return [(TRAIN_MMA_80, f"constexpr int TM_HALF_80 = {half}, "
             f"TM_DQ_BLOCKS_80 = {dq}, TM_DKDV_BLOCKS_80 = {dkdv};")]


# Heads 80 wide: the online kernel's PV parts and key tile; Q kept in
# shared memory and split as each step is read (mma3_rows_smem) in place of
# its split fragments in registers, in either kernel (the row-resident one
# in one key part: two parts' ring leaves no room for the Q tile)
PV_PARTS_80 = "constexpr int TF_PV_PARTS_80 = 5;"
KT_80 = "constexpr int TF_KT_80 = 32;"
ONLINE_Q_SMEM = [
    ("  static constexpr bool Q_OWN = KT < TF_ROWS;",
     "  static constexpr bool Q_OWN = true;"),
    ("""  // the warp's split Q fragments: step kc holds head dims 8 kc + 2t (a0,
  // a1) and 8 kc + 2t + 1 (a2, a3) of rows g and g + 8
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) load_a_rows<DH>(qh[kc], ql[kc], qw, kc, lane);
  __syncthreads();  // Q read before stage 1 is overwritten
""", ""),
    ("""#pragma unroll
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
""", "    mma3_rows_smem<DH, NT>(s, qw, Ks, lane);\n"),
]
ROW_Q_SMEM = [
    ("  float* qs = ring + C::STAGE;",
     "  float* qs = stats + SPLIT * FT_ROWS * 2;"),
    ("  static constexpr size_t SMEM = RING_BYTES + PROBS * sizeof(float) + "
     "STATS_BYTES;",
     "  static constexpr size_t SMEM = RING_BYTES + PROBS * sizeof(float) + "
     "STATS_BYTES + FT_ROWS * D::K_LD * sizeof(float);"),
    ("""  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) load_a_rows<DH>(qh[kc], ql[kc], qw, kc, lane);
  __syncthreads();  // Q read before stage 1 is overwritten
""", ""),
    ("    mma3_rows<DH, FT_NT>(s, qh, ql, Ks, lane);",
     "    mma3_rows_smem<DH, FT_NT>(s, qw, Ks, lane);"),
    (ROW_TF32_PARTS, "  return launch_split<DH, 1>(a, s);"),
]

# K and V split into hi and lo in shared memory once a tile: hi overwrites
# the stage in place, lo goes to a third buffer; the products read both
# (heads 64 wide, Q in registers)
SMEM_SPLIT = [
    ("  static constexpr size_t SMEM = (2 * STAGE + Q_TILE) * sizeof(float);",
     "  static constexpr size_t SMEM = (3 * STAGE + Q_TILE) * sizeof(float);"),
    ("""    const float* Ks = smem + (it & 1) * STAGE;
    const float* Vs = Ks + KT * K_LD;
""", """    float* Kst = smem + (it & 1) * STAGE;
    float* lo = smem + 2 * STAGE + C::Q_TILE;
    for (int i = threadIdx.x; i < STAGE; i += TF_THREADS) {
      uint32_t hi, l;
      split(Kst[i], hi, l);
      Kst[i] = __uint_as_float(hi);
      lo[i] = __uint_as_float(l);
    }
    __syncthreads();
    const float* Ks = Kst;
    const float* Vs = Ks + KT * K_LD;
    const float* Kl = lo;
    const float* Vl = lo + KT * K_LD;
"""),
    ("""        const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * kc);
        mma_3xtf32(s[n], small, qh[kc], ql[kc], kv.x, kv.y);""",
     """        const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * kc);
        const float2 kl = *reinterpret_cast<const float2*>(kr - Ks + Kl + 8 * kc);
        mma_tf32(small, ql[kc], __float_as_uint(kv.x), __float_as_uint(kv.y));
        mma_tf32(small, qh[kc], __float_as_uint(kl.x), __float_as_uint(kl.y));
        mma_tf32(s[n], qh[kc], __float_as_uint(kv.x), __float_as_uint(kv.y));"""),
    ("""          mma_3xtf32(big[d], small[d], ph, pl, vr[8 * d], vr[V_LD + 8 * d]);""",
     """        {
          const float* vl = vr - Vs + Vl;
          mma_tf32(small[d], pl, __float_as_uint(vr[8 * d]), __float_as_uint(vr[V_LD + 8 * d]));
          mma_tf32(small[d], ph, __float_as_uint(vl[8 * d]), __float_as_uint(vl[V_LD + 8 * d]));
          mma_tf32(big[d], ph, __float_as_uint(vr[8 * d]), __float_as_uint(vr[V_LD + 8 * d]));
        }"""),
    (PV_PARTS, "constexpr int TF_PV_PARTS = 2;"),
]

# Row 2: the key tiles and the head-mean's design of the two tensor-core
# routes
ROW2_MMA_KT = "constexpr int HM_KT = 64;"
ROW2_TF32_KT = "constexpr int HT_KT_64 = 32, HT_PV_PARTS_64 = 1;"
ROW2_TF32_KT_80 = "constexpr int HT_KT_80 = 64, HT_PV_PARTS_80 = 5;"


def _head_walk(t: str, rows: str, cast: str, kernel_call: str,
               kernel_loop: str):
    """Row 2's rejected head-mean design as replacements of a route's
    source (element type ``t``, rows constant ``rows``, the cast ``cast``
    of an f32 value to ``t``): one block per query tile walks the heads in
    order, and each lane sums the f32 probs of the (row, key) pairs it owns
    in place in head order, casting the mean on the last head; no
    head-mean pass."""
    return [
        ("  int H, N, D, norm, fast;\n  float scale;\n};",
         f"  {t}* mean;\n  int H, N, D, norm, fast;\n"
         "  float scale, inv_heads;\n};"),
        ("            if (a.head_probs != nullptr) "
         "a.head_probs[prow + c] = v;",
         """            if (a.head_probs != nullptr) {
              const long long m = ((long long)b * N + row0 + i) * N + j0 + c;
              const float acc = h == 0 ? v : a.head_probs[m] + v;
              if (h + 1 < a.H) a.head_probs[m] = acc;
              else a.mean[m] = """ + cast.format("acc * a.inv_heads") + """;
            }"""),
        (kernel_call, kernel_loop),
        (f"  const dim3 grid((a.N + {rows} - 1) / {rows}, a.H, B);",
         f"  const dim3 grid((a.N + {rows} - 1) / {rows}, 1, B);"),
        ("  a.H = H;", f"  a.mean = static_cast<{t}*>(mean);\n"
                       "  a.inv_heads = inv_heads;\n  a.H = H;"),
        ("  if (mean != nullptr) {\n    err = launch_head_mean",
         "  if (false) {\n    err = launch_head_mean"),
    ]


ROW2_MMA_WALK = _head_walk(
    "bf16", "HM_ROWS", "__float2bfloat16({})",
    "  attend_head<DH, WALKS>(a, ring, pstage, blockIdx.x * HM_ROWS, "
    "blockIdx.y, blockIdx.z);",
    """  for (int h = 0; h < a.H; ++h) {
    attend_head<DH, WALKS>(a, ring, pstage, blockIdx.x * HM_ROWS, h, blockIdx.z);
    __syncthreads();
  }""")
ROW2_TF32_WALK = _head_walk(
    "float", "HT_ROWS", "{}",
    """  attend_head<DH, WALKS>(a, reinterpret_cast<float*>(ht_smem4), blockIdx.x * HT_ROWS, blockIdx.y,
                         blockIdx.z);""",
    """  for (int h = 0; h < a.H; ++h) {
    attend_head<DH, WALKS>(a, reinterpret_cast<float*>(ht_smem4), blockIdx.x * HT_ROWS, h,
                           blockIdx.z);
    __syncthreads();
  }""")

# Row 1 (bf16): the QKV kernel's row tile by the row count (the source)
ROW1_ROWS = ("__host__ __device__ inline int qkv_rows(int m) "
             "{ return m <= QKV_SMALL_M ? 32 : 64; }")

# row 6's split-TF32 A operands pre-split at tiles of 16 rows (the source)
ROW6_TF32_PRESPLIT = "return bm == 16;"

# row 5's attention grid by (window, image), the block walking the heads
ROW5_HEAD_LOOP = [
    ("  window_head(a, tiles, blockIdx.x, blockIdx.y, blockIdx.z);",
     "  for (int h = 0; h < a.heads; ++h) {\n"
     "    window_head(a, tiles, blockIdx.x, h, blockIdx.z);\n"
     "    __syncthreads();  // the tiles read before the next head's gather\n"
     "  }"),
    ("(H / window) * (W / window), heads, B);",
     "(H / window) * (W / window), 1, B);")]

# name -> (source, replacements)
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "row3_parts_by_grid": ("flash_attention_mma", []),
    "row3_parts_2": ("flash_attention_mma", [
        (ROW_PARTS, "  return launch_rowfull<DH, 2>(a, B, s);")]),
    "row3_parts_4": ("flash_attention_mma", [
        (ROW_PARTS, "  return launch_rowfull<DH, 4>(a, B, s);")]),
    "row4_pv_1": ("flash_attention_online_tf32", []),
    "row4_pv_2": ("flash_attention_online_tf32", [
        (PV_PARTS, "constexpr int TF_PV_PARTS = 2;")]),
    "row4_pv_4": ("flash_attention_online_tf32", [
        (PV_PARTS, "constexpr int TF_PV_PARTS = 4;")]),
    "row4_smem_split_pv_2": ("flash_attention_online_tf32", SMEM_SPLIT),
    "row3_f32_parts_by_grid": ("flash_attention_tf32", []),
    "row3_f32_parts_1": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return launch_split<DH, 1>(a, s);")]),
    "row3_f32_parts_2": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return launch_split<DH, 2>(a, s);")]),
    "row3_f32_two_walks": ("flash_attention_tf32", [
        (ONE_WALK, "constexpr bool FT_ONE_WALK_MAPS_OFF = false;")]),
    # heads 80 wide (the names hold "dh80"; timed at vit_h14's shapes)
    "row4_dh80_q_regs_kt_32_pv_5": ("flash_attention_online_tf32", []),
    "row4_dh80_q_regs_kt_32_pv_1": ("flash_attention_online_tf32", [
        (PV_PARTS_80, PV_PARTS_80.replace("5;", "1;"))]),
    "row4_dh80_q_smem_kt_32_pv_1": ("flash_attention_online_tf32", [
        *ONLINE_Q_SMEM, (PV_PARTS_80, PV_PARTS_80.replace("5;", "1;"))]),
    "row4_dh80_q_regs_kt_64_pv_1": ("flash_attention_online_tf32", [
        (KT_80, KT_80.replace("32", "64")),
        (PV_PARTS_80, PV_PARTS_80.replace("5;", "1;"))]),
    "row4_dh80_q_regs_kt_64_pv_2": ("flash_attention_online_tf32", [
        (KT_80, KT_80.replace("32", "64")),
        (PV_PARTS_80, PV_PARTS_80.replace("5;", "2;"))]),
    "row4_dh80_q_regs_kt_64_pv_5": ("flash_attention_online_tf32", [
        (KT_80, KT_80.replace("32", "64"))]),
    "row4_dh80_q_smem_kt_64_pv_1": ("flash_attention_online_tf32", [
        *ONLINE_Q_SMEM, (KT_80, KT_80.replace("32", "64")),
        (PV_PARTS_80, PV_PARTS_80.replace("5;", "1;"))]),
    "row4_dh80_q_smem_kt_64_pv_2": ("flash_attention_online_tf32", [
        *ONLINE_Q_SMEM, (KT_80, KT_80.replace("32", "64")),
        (PV_PARTS_80, PV_PARTS_80.replace("5;", "2;"))]),
    "row3_dh80_parts_by_grid": ("flash_attention_mma", []),
    "row3_dh80_parts_2": ("flash_attention_mma", [
        (ROW_PARTS, "  return launch_rowfull<DH, 2>(a, B, s);")]),
    "row3_dh80_parts_4": ("flash_attention_mma", [
        (ROW_PARTS, "  return launch_rowfull<DH, 4>(a, B, s);")]),
    "row3_f32_dh80_parts_by_grid": ("flash_attention_tf32", []),
    "row3_f32_dh80_parts_1": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return launch_split<DH, 1>(a, s);")]),
    "row3_f32_dh80_parts_2": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return launch_split<DH, 2>(a, s);")]),
    "row3_f32_dh80_q_smem_parts_1": ("flash_attention_tf32", ROW_Q_SMEM),
    "train_bwd_kt_32_whole": ("attention_train_tf32", []),
    "train_bwd_kt_64_halves": ("attention_train_tf32", [
        (TRAIN_KT, TRAIN_KT.replace("TT_KT = 32", "TT_KT = 64")),
        (TRAIN_HALF, "constexpr int TT_HALF = TT_KT / 2;")]),
    "train_bwd_kt_32_halves": ("attention_train_tf32", [
        (TRAIN_HALF, "constexpr int TT_HALF = TT_KT / 2;")]),
    "train_bwd_kt_16_whole": ("attention_train_tf32", [
        (TRAIN_KT, TRAIN_KT.replace("TT_KT = 32", "TT_KT = 16"))]),
    "train_bwd_dh80_kt_16_d_major": ("attention_train_tf32", []),
    "train_bwd_dh80_kt_16_n_major": ("attention_train_tf32",
                                     [TRAIN_N_MAJOR_80]),
    "train_bwd_dh80_kt_32_d_major": ("attention_train_tf32", [
        (TRAIN_KT_80, TRAIN_KT_80.replace("16", "32"))]),
    "train_bwd_dh80_kt_32_n_major": ("attention_train_tf32", [
        (TRAIN_KT_80, TRAIN_KT_80.replace("16", "32")), TRAIN_N_MAJOR_80]),
    "train_bwd_dh80_kt_64_d_major": ("attention_train_tf32", [
        (TRAIN_KT_80, TRAIN_KT_80.replace("16", "64"))]),
    "train_mma_halves_32": ("attention_train_mma", []),
    "train_mma_dh80_halves_16_dkdv_3": ("attention_train_mma", []),
    "train_mma_dh80_halves_16_dkdv_2": ("attention_train_mma",
                                        _train_mma_80(dkdv=2)),
    "train_mma_dh80_halves_32_dkdv_2": ("attention_train_mma",
                                        _train_mma_80(half=32, dkdv=2)),
    "train_mma_dh80_halves_32_dkdv_3": ("attention_train_mma",
                                        _train_mma_80(half=32)),
    "train_mma_dh80_whole_dkdv_2": ("attention_train_mma",
                                    _train_mma_80(half=64, dkdv=2)),
    "train_mma_dh80_halves_16_dq_2": ("attention_train_mma",
                                      _train_mma_80(dq=2)),
    "row2_mma_kt_64_workspace": ("headwise_attn_block_mma", []),
    "row2_mma_kt_128": ("headwise_attn_block_mma", [
        (ROW2_MMA_KT, ROW2_MMA_KT.replace("64", "128"))]),
    "row2_mma_head_walk": ("headwise_attn_block_mma", ROW2_MMA_WALK),
    "row2_tf32_kt_32_workspace": ("headwise_attn_block_tf32", []),
    "row2_tf32_kt_64": ("headwise_attn_block_tf32", [
        (ROW2_TF32_KT, ROW2_TF32_KT.replace("= 32", "= 64"))]),
    "row2_tf32_head_walk": ("headwise_attn_block_tf32", ROW2_TF32_WALK),
    "row2_mma_dh80_kt_64_workspace": ("headwise_attn_block_mma", []),
    "row2_mma_dh80_kt_128": ("headwise_attn_block_mma", [
        (ROW2_MMA_KT, ROW2_MMA_KT.replace("64", "128"))]),
    "row2_mma_dh80_head_walk": ("headwise_attn_block_mma", ROW2_MMA_WALK),
    "row2_tf32_dh80_kt_64_workspace": ("headwise_attn_block_tf32", []),
    "row2_tf32_dh80_kt_32": ("headwise_attn_block_tf32", [
        (ROW2_TF32_KT_80, ROW2_TF32_KT_80.replace("= 64", "= 32"))]),
    "row2_tf32_dh80_head_walk": ("headwise_attn_block_tf32",
                                 ROW2_TF32_WALK),
    # rows 6 and 7 (the MLP branch) on the tensor cores: the sources (a
    # cluster of up to 8 blocks on a tile of 64 rows, three stages), and
    # their header's other tilings; beside them the FMA and __dp4a kernels
    # they replace, built from this checkout
    "row6_mma": ("fused_mlp_block_mma", []),
    "row6_mma_tile32": ("fused_mlp_block_mma", []),
    "row6_mma_tile64": ("fused_mlp_block_mma", []),
    "row6_fma": ("fused_mlp_block", []),
    # row 6 in f32 on split TF32: the source (the tile by the row count;
    # at 16 rows the A operands pre-split into hi and lo panels), tiles of
    # 16 or 32 always, and tiles of 16 splitting A as they read it
    "row6_tf32": ("fused_mlp_block_tf32", []),
    "row6_tf32_tile16": ("fused_mlp_block_tf32", []),
    "row6_tf32_tile32": ("fused_mlp_block_tf32", []),
    "row6_tf32_split_tile16": ("fused_mlp_block_tf32", [
        (ROW6_TF32_PRESPLIT, "return false;")]),
    "row7_mma": ("fused_mlp_w8a8_mma", []),
    "row7_mma_tile32": ("fused_mlp_w8a8_mma", []),
    "row7_mma_tile64": ("fused_mlp_w8a8_mma", []),
    "row7_dp4a": ("fused_mlp_w8a8_block", []),
    "row6_mma_stage8k": ("fused_mlp_block_mma", []),
    "row7_mma_stage8k": ("fused_mlp_w8a8_mma", []),
    # row 1 on the tensor cores (bf16): QKV's row tile by the row count
    # (the source) and tiles of 32 or 64 rows always; beside them the FMA
    # kernel they replace
    "row1_mma_rows_by_m": ("fused_attn_block_mma", []),
    "row1_mma_rows_32": ("fused_attn_block_mma", [
        (ROW1_ROWS, ROW1_ROWS.replace("m <= QKV_SMALL_M ? 32 : 64", "32"))]),
    "row1_mma_rows_64": ("fused_attn_block_mma", [
        (ROW1_ROWS, ROW1_ROWS.replace("m <= QKV_SMALL_M ? 32 : 64", "64"))]),
    "row1_fma": ("fused_attn_block", []),
    # row 5 on the tensor cores: the attention grid by (window, head,
    # image) (the sources) or by (window, image) walking the heads; beside
    # them the FMA kernel they replace
    "row5_mma_head_grid": ("fused_window_attn_mma", []),
    "row5_mma_head_loop": ("fused_window_attn_mma", ROW5_HEAD_LOOP),
    "row5_tf32_head_grid": ("fused_window_attn_tf32", []),
    "row5_tf32_head_loop": ("fused_window_attn_tf32", ROW5_HEAD_LOOP),
    "row5_fma": ("fused_window_attn", []),
}


_LAST_BARRIER = ("  cluster.sync();  // no block leaves while a peer may read its "
                 "partials")


def _phases(source, marks):
    """A timing-only variant of ``source``: block (0, 0) stamps
    %globaltimer, after a block barrier, where each of ``marks`` begins (the
    last mark the kernel's final cluster barrier) and writes the
    nanoseconds between stamps into the first words of y."""
    gt = ("({ unsigned long long _t; asm volatile(\"mov.u64 %0, %globaltimer;\" "
          ": \"=l\"(_t)); _t; })")
    marks = list(marks) + [_LAST_BARRIER]
    reps = [(m, f"  __syncthreads();\n  const unsigned long long ph_t{i} = {gt};\n"
             + m) for i, m in enumerate(marks)]
    write = "".join(f"    ph[{i}] = (long long)(ph_t{i + 1} - ph_t{i});\n"
                    for i in range(len(marks) - 1))
    reps.append((_LAST_BARRIER, _LAST_BARRIER + "\n  if (blockIdx.x == 0 && "
                 "blockIdx.y == 0 && threadIdx.x == 0) {\n    long long* ph = "
                 "reinterpret_cast<long long*>(a.y);\n" + write + "  }"))
    return source, reps


# timing-only variants: name -> the phases block (0, 0) times
PHASES = {
    "row6_time_phases": ("LN2", "fc1 + GELU", "fc2 + cluster sums"),
    "row7_time_phases": ("LN2 + q1", "fc1 + GELU", "max exchange + q2",
                         "fc2 + cluster sums"),
}
VARIANTS["row6_time_phases"] = _phases("fused_mlp_block_mma", [
    "  // LN2 in place, once a cluster",
    "  // (the ring's first __syncthreads orders these writes before fc1)",
    "  // fc2 partials over the slice, NC output columns a chunk, summed "
    "over"])
VARIANTS["row7_time_phases"] = _phases("fused_mlp_w8a8_mma", [
    "  // a. LN2 + q1 (steps 1-2), once a cluster",
    "  // (the ring's first __syncthreads orders these writes before fc1)",
    "  // fc2's first weight stages go out now, behind the exchange and q2",
    "  // d-e. fc2 partials over the slice, NC output columns a chunk; "
    "the"])

# Variants of the MLP kernels that hand the entry a fixed row tile instead
# of the one ``fused_mlp.row_tile`` picks: name -> the tile
TILES = {"row6_mma_tile32": 32, "row6_mma_tile64": 64,
         "row7_mma_tile32": 32, "row7_mma_tile64": 64,
         "row6_tf32_tile16": 16, "row6_tf32_tile32": 32,
         "row6_tf32_split_tile16": 16}

# Variants that edit the MLP kernels' shared header csrc/mlp_cluster.cuh
# (written beside the variant's source, which includes it first): name ->
# replacements there
MC_STAGE_BYTES = "constexpr int MC_STAGE_BYTES = 16384"
HEADER_EDITS: Dict[str, List[Tuple[str, str]]] = {
    "row6_mma_stage8k": [(MC_STAGE_BYTES, MC_STAGE_BYTES.replace("16384", "8192"))],
    "row7_mma_stage8k": [(MC_STAGE_BYTES, MC_STAGE_BYTES.replace("16384", "8192"))],
}
HEADER = "mlp_cluster"


# source -> (C entry, its ctypes argtypes)
ENTRIES = {
    "flash_attention_mma": ("ivt_flash_attention_mma", fa.FLASH_MMA_ARGTYPES),
    "flash_attention_online_tf32": ("ivt_flash_attention_online_tf32x3",
                                    fa.ONLINE_TF32_ARGTYPES),
    "flash_attention_tf32": ("ivt_flash_attention_tf32x3",
                             fa.FLASH_TF32_ARGTYPES),
    "attention_train_tf32": ("ivt_attention_train_bwd_tf32",
                             av.TRAIN_TF32_BWD_ARGTYPES),
    "attention_train_mma": ("ivt_attention_train_bwd_mma",
                            av.TRAIN_MMA_BWD_ARGTYPES),
    "headwise_attn_block_mma": ("ivt_headwise_attn_block_mma",
                                fb.HEADWISE_TC_ARGTYPES),
    "headwise_attn_block_tf32": ("ivt_headwise_attn_block_tf32x3",
                                 fb.HEADWISE_TC_ARGTYPES),
    "headwise_attn_block": ("ivt_headwise_attn_block",
                            fb.HEADWISE_ARGTYPES),
    "fused_mlp_block_mma": ("ivt_fused_mlp_block_mma", fm.MLP_MMA_ARGTYPES),
    "fused_mlp_block": ("ivt_fused_mlp_block", fm.MLP_ARGTYPES),
    "fused_mlp_block_tf32": ("ivt_fused_mlp_block_tf32x3",
                             fm.MLP_MMA_ARGTYPES),
    "fused_mlp_w8a8_mma": ("ivt_fused_mlp_w8a8_mma", fm.W8A8_MMA_ARGTYPES),
    "fused_mlp_w8a8_block": ("ivt_fused_mlp_w8a8_block", fm.W8A8_ARGTYPES),
    "fused_attn_block_mma": ("ivt_fused_attn_block_mma",
                             fb.TC_ENTRY_ARGTYPES),
    "fused_attn_block": ("ivt_fused_attn_block", fb.ENTRY_ARGTYPES),
    "fused_window_attn_mma": ("ivt_fused_window_attn_mma",
                              fw.TC_ENTRY_ARGTYPES),
    "fused_window_attn_tf32": ("ivt_fused_window_attn_tf32x3",
                               fw.TC_ENTRY_ARGTYPES),
    "fused_window_attn": ("ivt_fused_window_attn", fw.ENTRY_ARGTYPES),
}

# A source's counterpart in the ``--baseline`` checkout: row 2's
# tensor-core routes stand beside the FMA kernel they replace
BASELINE_OF = {"headwise_attn_block_mma": "headwise_attn_block",
               "headwise_attn_block_tf32": "headwise_attn_block",
               "fused_mlp_block_mma": "fused_mlp_block",
               "fused_mlp_w8a8_mma": "fused_mlp_w8a8_block",
               "fused_attn_block_mma": "fused_attn_block",
               "fused_window_attn_mma": "fused_window_attn",
               "fused_window_attn_tf32": "fused_window_attn"}


def variant_dh(name: str) -> int:
    """The head width a variant is timed at."""
    return 80 if "dh80" in name else 64


# Headers that rows 1 and 2 share: a variant's source takes their text in
# place of its #include, so that one variant edits the header for its own
# build alone
INLINED_HEADERS = ("attn_block_mma", "attn_block_tf32")


def variant_source(source: str, replacements,
                   csrc: str = cuda_build.CSRC_DIR, ext: str = ".cu") -> str:
    """``<csrc>/<source><ext>`` with each replacement made; each must
    match exactly once (in the source or a header of INLINED_HEADERS it
    includes)."""
    with open(os.path.join(csrc, source + ext)) as f:
        text = f.read()
    for header in INLINED_HEADERS:
        include = f'#include "{header}.cuh"\n'
        if include in text:
            with open(os.path.join(csrc, header + ".cuh")) as f:
                body = f.read().replace("#pragma once\n", "")
            text = text.replace(include, body)
    for old, new in replacements:
        if text.count(old) != 1:
            raise ValueError(f"{source}{ext}: a variant's text matches "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(names, baseline=None) -> Dict[str, ctypes.CDLL]:
    """Write and build the named variants (all at once), and with
    ``baseline`` (another checkout) its sources of the same kernels as
    ``baseline:<source>``; prints ptxas's registers and spills and returns
    the loaded libraries."""
    os.makedirs(OUT_DIR, exist_ok=True)
    builds = {name: (VARIANTS[name][1], cuda_build.CSRC_DIR)
              for name in names}
    if baseline is not None:
        csrc = os.path.join(baseline, os.path.relpath(
            cuda_build.CSRC_DIR, os.path.dirname(os.path.dirname(
                cuda_build.CSRC_DIR))))
        for source in sorted({BASELINE_OF.get(VARIANTS[name][0],
                                              VARIANTS[name][0])
                              for name in names}):
            builds[f"baseline:{source}"] = ([], csrc)
    procs = {}
    for name, (replacements, csrc) in builds.items():
        source = _source_of(name)
        out = OUT_DIR
        if name in HEADER_EDITS:
            out = os.path.join(OUT_DIR, name)
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, HEADER + ".cuh"), "w") as f:
                f.write(variant_source(HEADER, HEADER_EDITS[name], csrc,
                                       ".cuh"))
        path = os.path.join(out, name.replace(":", "_") + ".cu")
        with open(path, "w") as f:
            f.write(variant_source(source, replacements, csrc))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", csrc,
             "-Xptxas", "-v", "-o", path[:-3] + ".so", path],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        info = [line.split("info    : ")[-1].strip()
                for line in err.splitlines() if "Used" in line or "spill" in line]
        print(f"{name}: {'; '.join(info)}", flush=True)
        lib = ctypes.CDLL(os.path.join(
            os.path.join(OUT_DIR, name) if name in HEADER_EDITS else OUT_DIR,
            name.replace(":", "_") + ".so"))
        entry, argtypes = ENTRIES[_source_of(name)]
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib
    return libs


def _sub_down(m) -> str:
    """A mangled substitution reference S<k>_ (k in base 36) one slot
    lower: S<k-1>_ for k >= 1; S0_ as it is."""
    k = int(m.group(1), 36)
    if k == 0:
        return m.group(0)
    digits, k, out = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ", k - 1, ""
    while True:
        out = digits[k % 36] + out
        k //= 36
        if not k:
            return f"S{out}_"


def untemplated(kernel: str) -> str:
    """A kernel's mangled name with a leading head-width template argument
    of 64, or a lone option of ``true``, taken out: the name the kernel had
    before it was templated on the width or given an option whose default
    is its old code (``f<64>`` -> ``f``, ``f<64, 4>`` -> ``f<4>``,
    ``f<true>`` -> ``f``)."""
    # f<64>: template arguments, the nested name's end and the return type
    # -> the nested name's end
    kernel = kernel.replace("ILi64EEEv", "E")
    if "ILb1EEEv" in kernel:
        # f<true>(...): the template's prefix took a substitution slot, so
        # the parameters' references S<k>_ (k >= 1) are one higher than
        # the untemplated name's
        kernel = re.sub(r"S([0-9A-Z]+)_", _sub_down,
                        kernel.replace("ILb1EEEv", "E"))
    return kernel.replace("ILi64ELi", "ILi")


def _sass(csrc: str, source: str, out: str) -> Dict[str, List[str]]:
    """kernel -> its SASS instructions, for ``<csrc>/<source>.cu``."""
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([cuda_build.nvcc_path(), *flags, "-cubin", "-I", csrc,
                    "-o", out, os.path.join(csrc, source + ".cu")],
                   check=True)
    text = subprocess.run(
        [os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump"),
         "-sass", out], check=True, capture_output=True, text=True).stdout
    kernels: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                         "ANON", m.group(1))
            kernels[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            kernels[cur].append(m.group(1))
    return kernels


def sass_diff(sources, baseline: str) -> int:
    """Each source's SASS against the same source in the ``baseline``
    checkout; prints a line a source and returns how many differ."""
    os.makedirs(OUT_DIR, exist_ok=True)
    csrc = os.path.join(baseline, os.path.relpath(
        cuda_build.CSRC_DIR, os.path.dirname(os.path.dirname(
            cuda_build.CSRC_DIR))))
    bad = 0
    for source in sources:
        here = _sass(cuda_build.CSRC_DIR, source,
                     os.path.join(OUT_DIR, source + ".cubin"))
        there = _sass(csrc, source,
                      os.path.join(OUT_DIR, "baseline_" + source + ".cubin"))
        # a baseline kernel's counterpart here: itself, or the 64-wide
        # instantiation (or the option's default) it has become
        ours = {k: k for k in here}
        ours.update({untemplated(k): k for k in here
                     if untemplated(k) not in here})
        differ = sorted(k for k, v in there.items()
                        if ours.get(k) not in here or here[ours[k]] != v)
        new = sorted(set(here) - {ours.get(k) for k in there})
        bad += bool(differ)
        print(f"{source}: baseline {len(there)} kernels, "
              f"{sum(map(len, there.values()))} instructions: "
              + ('identical SASS here' if not differ else
                 f"DIFFERENT: {', '.join(differ)}")
              + (f"; new here: {', '.join(new)} ("
                 f"{sum(len(here[k]) for k in new)} instructions)"
                 if new else ""), flush=True)
    return bad


def _source_of(name: str) -> str:
    """A variant's source (``baseline:<source>`` names their own)."""
    return (name.split(":", 1)[1] if name.startswith("baseline:")
            else VARIANTS[name][0])


def qkv_views(b: int, n: int, heads: int, dtype, seed: int, dh: int = 64):
    """q, k, v [B, H, N, dh] as ``qkv_proj`` makes them: views of one
    [B, N, 3D] tensor on the card."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, n, 3 * heads * dh), generator=g) * 2).to("cuda",
                                                                 dtype)
    return [x.reshape(b, n, 3, heads, dh)[:, :, i].transpose(1, 2)
            for i in range(3)]


def call(lib, name, q, k, v, maps=False, n_real=None):
    """One launch of a variant, as its wrapper launches the kernel."""
    b, h, n, dh = q.shape
    o = torch.empty((b, n, h, dh), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    probs = (torch.empty((b, h, n, n), dtype=q.dtype, device=q.device)
             if maps else None)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    tail = [b, h, n, dh, n if n_real is None else n_real, float(dh) ** -0.5,
            fa.MASK_VALUE, torch.cuda.current_stream().cuda_stream]
    source = _source_of(name)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if source != "flash_attention_online_tf32":
        ptrs.append(None if probs is None else probs.data_ptr())
    if source == "flash_attention_tf32":
        ptrs.append(None)  # no (m, l)
    err = getattr(lib, ENTRIES[source][0])(*ptrs, *strides, *tail)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    return o, probs


def call_bwd(lib, name, q, k, v, do, stats, n_real=None):
    """One launch of a backward variant on [B, H, N, dh] views, from the
    forward's (m, l) ``stats``: (dq, dk, dv)."""
    b, h, n, dh = q.shape
    grads = [torch.empty((b, n, h, dh), dtype=q.dtype,
                         device=q.device).transpose(1, 2) for _ in range(3)]
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    ts = (q, k, v, do, *grads)
    flat = (ctypes.c_longlong * 21)(*[s for t in ts for s in t.stride()[:3]])
    err = getattr(lib, ENTRIES[_source_of(name)][0])(
        *(t.data_ptr() for t in ts), stats.data_ptr(), delta.data_ptr(),
        ctypes.addressof(flat), b, h, n, dh, n if n_real is None else n_real,
        float(dh) ** -0.5, fa.MASK_VALUE,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"backward variant: launch failed, cudaError {err}")
    return grads


def call_headwise(lib, name, x, qkv, p, heads, maps=False, mean=False):
    """One launch of a row-2 variant after QKV (or of the baseline's FMA
    kernel), as ``fused_block.headwise_kernels`` launches it: (y, probs |
    None[, mean])."""
    b, n, d = x.shape
    o_ws = torch.empty_like(x)
    probs_ws = (torch.empty((b, heads, n, n), dtype=torch.float32,
                            device=x.device) if mean else None)
    y = torch.empty_like(x)
    probs = (torch.empty((b, heads, n, n), dtype=x.dtype, device=x.device)
             if maps else None)
    mn = (torch.empty((b, n, n), dtype=x.dtype, device=x.device)
          if mean else None)
    source = _source_of(name)
    lead = (() if source != "headwise_attn_block" else
            (0 if x.dtype == torch.float32 else 1,))
    err = getattr(lib, ENTRIES[source][0])(
        *lead, x.data_ptr(), qkv.data_ptr(), p["proj_w"].data_ptr(),
        p["proj_b"].data_ptr(), o_ws.data_ptr(),
        None if probs_ws is None else probs_ws.data_ptr(), y.data_ptr(),
        None if probs is None else probs.data_ptr(),
        None if mn is None else mn.data_ptr(), b, n, d, heads,
        float(d // heads) ** -0.5, 1.0 / heads, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    return (y, probs, mn) if mean else (y, probs)


def headwise_group(libs, names, dtype, shapes) -> None:
    """Row-2 variants against ``headwise_attn_block_reference`` and timed
    after QKV, maps off and maps + mean, in two orders."""
    for b, n, d, heads in shapes:
        g = torch.Generator().manual_seed(n + b)

        def rnd(*shape, std=1.0, mean=0.0):
            return (torch.randn(shape, generator=g) * std + mean).to(
                "cuda", dtype)

        p = {"ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
             "qkv_w": rnd(d, 3 * d, std=d ** -0.5),
             "qkv_b": rnd(3 * d, std=0.1),
             "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1)}
        x = rnd(b, n, d)
        qkv = fb._ln_qkv(x, p, 1e-6)
        for maps in (False, True):
            ref = fb.headwise_attn_block_reference(
                x, p, heads, 1e-6, want_attn=maps, want_mean=maps)
            for name in names:
                got = call_headwise(libs[name], name, x, qkv, p, heads, maps,
                                    maps)
                torch.cuda.synchronize()
                use = 0.0
                for i, (o, r) in enumerate(zip(got, ref)):
                    if r is None:  # maps off: no tap
                        continue
                    if dtype == torch.float32:
                        bound = 1e-4
                    elif i == 0:
                        bound = 2.0 ** -6 * max(1.0, r.abs().max().item())
                    else:
                        bound = (2.0 ** -5 * r.float().abs() + 1e-6).clamp(
                            max=2.0 ** -7)
                    use = max(use, ((o.float() - r.float()).abs() / bound)
                              .max().item())
                if use > 1.0:
                    raise AssertionError(f"{name}: {use:.2f} of its bound")
                print(f"  {name} {(b, n, d, heads)} maps+mean={maps}: "
                      f"{use:.2f} of the bound", flush=True)
            del ref
            times = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    times[name].append(time_ms(lambda: call_headwise(
                        libs[name], name, x, qkv, p, heads, maps, maps)))
            print(f"  headwise_attn_block {(b, n, d, heads)} "
                  f"{str(dtype)[6:]} maps + mean {'on' if maps else 'off'}"
                  f", after QKV: " + ", ".join(
                      f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                      f"{t[1]:.4f})" for name, t in times.items()),
                  flush=True)
            torch.cuda.empty_cache()


def call_row1(lib, name, x, p, heads, maps=False):
    """One launch of a row-1 variant (or of the FMA kernel it replaces),
    dense, as ``fused_block._launch_block`` launches it: (y, probs | None,
    mean | None); maps: every head's probs and the head-mean."""
    b, n, d = x.shape
    source = _source_of(name)

    def empty(*shape, dtype=x.dtype):
        return torch.empty(shape, dtype=dtype, device=x.device)

    qkv_ws, o_ws, y = empty(b, n, 3 * d), empty(b, n, d), empty(b, n, d)
    probs_ws = empty(b, heads, n, n, dtype=torch.float32) if maps else None
    probs = empty(b, heads, n, n) if maps else None
    mean = empty(b, n, n) if maps else None
    fma = source == "fused_attn_block"
    lead = (0 if x.dtype == torch.float32 else 1,) if fma else ()
    err = getattr(lib, ENTRIES[source][0])(
        *lead, *(t.data_ptr() for t in (
            x, p["ln1_s"], p["ln1_b"], p["qkv_w"], p["qkv_b"], p["proj_w"],
            p["proj_b"], qkv_ws, o_ws)),
        *(None if t is None else t.data_ptr() for t in (probs_ws,)),
        y.data_ptr(), *(None if t is None else t.data_ptr()
                        for t in (probs, mean)), None, None, b, n, d, heads,
        1e-6, float(d // heads) ** -0.5, 1.0 / heads, 1,
        (1 << heads) - 1 if maps else 0, heads if maps else 0, 0,
        *(() if fma else (None,)), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    return y, probs, mean


def row1_group(libs, names, shapes) -> None:
    """Row-1 variants (bf16) against ``fused_attn_block_reference`` (y
    within 2^-6 of its scale; the maps and mean per element within
    min(2^-7, 2^-5 |ref| + 1e-6)) and timed on device time alone, maps off
    and maps + mean, in two orders."""
    for b, n, d, heads in shapes:
        g = torch.Generator().manual_seed(n + b + d)

        def rnd(*shape, std=1.0, mean=0.0):
            return (torch.randn(shape, generator=g) * std + mean).to(
                "cuda", torch.bfloat16)

        p = {"ln1_s": rnd(d, std=0.1, mean=1.0), "ln1_b": rnd(d, std=0.1),
             "qkv_w": rnd(d, 3 * d, std=d ** -0.5),
             "qkv_b": rnd(3 * d, std=0.1),
             "proj_w": rnd(d, d, std=d ** -0.5), "proj_b": rnd(d, std=0.1)}
        x = rnd(b, n, d)
        for maps in (False, True):
            ref = fb.fused_attn_block_reference(
                x, p, heads, 1e-6, want_attn=maps, want_mean=maps)
            ref = (*ref, None) if not maps else ref
            for name in names:
                got = call_row1(libs[name], name, x, p, heads, maps)
                torch.cuda.synchronize()
                use = 0.0
                for i, (o, r) in enumerate(zip(got, ref)):
                    if r is None:
                        continue
                    bound = (2.0 ** -6 * max(1.0, r.abs().max().item())
                             if i == 0 else
                             (2.0 ** -5 * r.float().abs() + 1e-6).clamp(
                                 max=2.0 ** -7))
                    use = max(use, ((o.float() - r.float()).abs() / bound)
                              .max().item())
                if use > 1.0:
                    raise AssertionError(f"{name}: {use:.2f} of its bound")
            times = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    times[name].append(time_held_ms(lambda: call_row1(
                        libs[name], name, x, p, heads, maps)))
            print(f"  fused_attn_block {(b, n, d, heads)} bf16 maps + mean "
                  f"{'on' if maps else 'off'} (device time; every variant "
                  f"within its bounds): " + ", ".join(
                      f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                      f"{t[1]:.4f})" for name, t in times.items()),
                  flush=True)
            torch.cuda.empty_cache()


def call_row5(lib, name, y, p, heads, window, bias, maps=False):
    """One launch of a row-5 variant (or of the FMA kernel it replaces),
    unshifted, as ``fused_window._launch`` launches it: (a, probs |
    None)."""
    b, hres, wres, c = y.shape
    t, nw = window * window, (hres // window) * (wres // window)
    source = _source_of(name)
    qkv_ws = torch.empty((b, hres, wres, 3 * c), dtype=y.dtype,
                         device=y.device)
    o_ws, a = torch.empty_like(y), torch.empty_like(y)
    probs = (torch.empty((b, nw, heads, t, t), dtype=y.dtype, device=y.device)
             if maps else None)
    lead = ((0 if y.dtype == torch.float32 else 1,)
            if source == "fused_window_attn" else ())
    err = getattr(lib, ENTRIES[source][0])(
        *lead, *(t_.data_ptr() for t_ in (
            y, p["qkv_w"], p["qkv_b"], p["proj_w"], p["proj_b"], bias)),
        None, qkv_ws.data_ptr(), o_ws.data_ptr(), a.data_ptr(),
        None if probs is None else probs.data_ptr(), b, hres, wres, c, heads,
        window, float(c // heads) ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    return a, probs


def row5_group(libs, names, dtype, shapes) -> None:
    """Row-5 variants against ``fused_window_attn_reference`` (bf16: a
    within 2^-6 of its scale, the maps per element within min(2^-7, 2^-5
    |ref| + 1e-6); f32: 1e-4), timed on device time alone, maps off and
    on, in two orders; (B, map side, C, heads), window 7."""
    win = 7
    for b, res, c, heads in shapes:
        g = torch.Generator().manual_seed(res + c + b)

        def rnd(*shape, std=1.0):
            return (torch.randn(shape, generator=g) * std).to("cuda", dtype)

        p = {"qkv_w": rnd(c, 3 * c, std=c ** -0.5),
             "qkv_b": rnd(3 * c, std=0.1),
             "proj_w": rnd(c, c, std=c ** -0.5), "proj_b": rnd(c, std=0.1)}
        y = rnd(b, res, res, c)
        bias = rnd(heads, win * win, win * win, std=0.5).float()
        for maps in (False, True):
            ref = fw.fused_window_attn_reference(y, p, heads, win, bias,
                                                 want_attn=maps)
            for name in names:
                got = call_row5(libs[name], name, y, p, heads, win, bias,
                                maps)
                torch.cuda.synchronize()
                use = 0.0
                for i, (o, r) in enumerate(zip(got, ref)):
                    if r is None:
                        continue
                    bound = (1e-4 if dtype == torch.float32 else
                             2.0 ** -6 * max(1.0, r.abs().max().item())
                             if i == 0 else
                             (2.0 ** -5 * r.float().abs() + 1e-6).clamp(
                                 max=2.0 ** -7))
                    use = max(use, ((o.float() - r.float()).abs() / bound)
                              .max().item())
                if use > 1.0:
                    raise AssertionError(f"{name}: {use:.2f} of its bound")
            times = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    times[name].append(time_held_ms(lambda: call_row5(
                        libs[name], name, y, p, heads, win, bias, maps)))
            print(f"  fused_window_attn {(b, res, c, heads)} "
                  f"{str(dtype)[6:]} maps {'on' if maps else 'off'} (device "
                  f"time; every variant within its bounds): " + ", ".join(
                      f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                      f"{t[1]:.4f})" for name, t in times.items()),
                  flush=True)
            torch.cuda.empty_cache()


def call_mlp(lib, name, x, p):
    """One launch of a row-6 or row-7 variant (or of the kernel it
    replaces) on x [M, D], as ``ops/fused_mlp.py`` launches it: y."""
    source = _source_of(name)
    m, d = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    code = 0 if x.dtype == torch.float32 else 1
    w8a8 = source.startswith("fused_mlp_w8a8")
    md = (p["fc1_w"][quant.AQKEY] if w8a8 else p["fc1_w"]).shape[-1]
    tile = ()  # the tensor-core kernels' row tile, after MD
    if source.endswith(("_mma", "_tf32")):
        route = ("w8a8" if w8a8 else "tf32" if source.endswith("_tf32")
                 else "mma")
        fm.bind_mma_library(lib, route)
        # (library_tile also prepares the library on the card)
        picked = fm.library_tile(lib, route, m, d, md, x.dtype, x.device)
        tile = (TILES.get(name, picked),)
    if w8a8:
        w1, w2 = p["fc1_w"], p["fc2_w"]
        ptrs = [x, p["ln2_s"], p["ln2_b"], w1[quant.AQKEY], w1[quant.ASKEY],
                p["fc1_b"], w2[quant.AQKEY], w2[quant.ASKEY], p["fc2_b"], y]
        err = getattr(lib, ENTRIES[source][0])(
            code, *(t.data_ptr() for t in ptrs), None, None, None, None, m,
            d, md, *tile, 1e-6, stream)
    else:
        ptrs = [x, p["ln2_s"], p["ln2_b"], p["fc1_w"], p["fc1_b"],
                p["fc2_w"], p["fc2_b"], y]
        lead = () if tile else (code,)
        err = getattr(lib, ENTRIES[source][0])(
            *lead, *(t.data_ptr() for t in ptrs), m, d, md, *tile, 1e-6,
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    return y


def time_held_ms(fn, iters: int = 30) -> float:
    """Device time of ``fn`` alone: the stream spins ~10 ms first, so the
    host has issued every timed call before the card starts them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mlp_group(libs, names, w8a8: bool) -> None:
    """Row-6 or row-7 variants, in bf16 and f32 (row 6: the bf16 source in
    bf16, the split-TF32 one in f32, the FMA kernel in both), against the
    plain version (y within 2^-6 of its scale; two calls the same bits),
    timed on device time alone in two orders, at vit_b16 (197 rows a
    image, B = 1 and 8) and, for row 6, swin_t's four stages (B = 1)."""
    shapes = [(1, 197, 768), (8, 197, 768)]
    dtypes = [torch.bfloat16, torch.float32]
    if not w8a8:
        shapes += [(1, 3136, 96), (1, 784, 192), (1, 196, 384),
                   (1, 49, 768)]
    every = names
    for (b, n, d), dtype in ((s, t) for t in dtypes for s in shapes):
        # a source that takes only the other dtype sits this one out
        other = "_mma" if dtype == torch.float32 else "_tf32"
        names = [name for name in every
                 if w8a8 or not _source_of(name).endswith(other)]
        if not names:
            continue
        md = 4 * d
        g = torch.Generator().manual_seed(n + d + b)

        def rnd(*shape, std=1.0, mean=0.0):
            return (torch.randn(shape, generator=g) * std + mean).to(
                "cuda", dtype)

        p = {"ln2_s": rnd(d, std=0.1, mean=1.0), "ln2_b": rnd(d, std=0.1),
             "fc1_w": rnd(d, md, std=d ** -0.5), "fc1_b": rnd(md, std=0.1),
             "fc2_w": rnd(md, d, std=md ** -0.5), "fc2_b": rnd(d, std=0.1)}
        if w8a8:
            for k in ("fc1_w", "fc2_w"):
                p[k] = quant.quantize_weight(p[k], "w8a8")
            plain = fm.fused_mlp_w8a8_reference
        else:
            plain = fm.fused_mlp_block_reference
        x = rnd(b * n, d)
        ref = plain(x[None], p)[0].float()
        bound = 2.0 ** -6 * max(1.0, ref.abs().max().item())
        run = []
        for name in names:
            try:
                y = call_mlp(libs[name], name, x, p)
            except RuntimeError as e:  # a tiling over the card's shared memory
                print(f"  {name} {(b, n, d)} {str(dtype)[6:]}: {e}",
                      flush=True)
                continue
            run.append(name)
            if name in PHASES:
                continue
            again = call_mlp(libs[name], name, x, p)
            torch.cuda.synchronize()
            use = (y.float() - ref).abs().max().item() / bound
            if use > 1.0 or not torch.equal(y, again):
                raise AssertionError(f"{name} {(b, n, d)}: {use:.2f} of the "
                                     f"bound, same bits {torch.equal(y, again)}")
        for name in run:
            if name in PHASES:
                y = call_mlp(libs[name], name, x, p)
                torch.cuda.synchronize()
                ns = y.view(-1).view(torch.int64)[:len(PHASES[name])].tolist()
                print(f"  {name} {(b, n, d)} {str(dtype)[6:]}, block (0, 0) "
                      f"phases (globaltimer): " + ", ".join(
                          f"{k} {v / 1e3:.2f} us"
                          for k, v in zip(PHASES[name], ns)), flush=True)
        times = {name: [] for name in run}
        for order in (run, run[::-1]):
            for name in order:
                times[name].append(time_held_ms(
                    lambda: call_mlp(libs[name], name, x, p)))
        print(f"  {'row 7 W8A8' if w8a8 else 'row 6'} MLP {(b, n, d)} "
              f"{str(dtype)[6:]} (each within its bound, two calls the same "
              f"bits), device time: " + ", ".join(
                  f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
                  for name, t in times.items()), flush=True)


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name, got, ref, dtype, n_real=None) -> str:
    """Raises unless the variant's outputs are within the kernel's bounds."""
    o, probs = got
    ro, rp = ref
    if dtype == torch.float32:
        use = (o - ro).abs().max().item() / 1e-4
    else:
        use = ((o.float() - ro.float()).abs().max().item()
               / (2.0 ** -6 * max(1.0, ro.abs().max().item())))
    if probs is not None:
        bound = (1e-4 if dtype == torch.float32 else
                 (2.0 ** -5 * rp.float().abs() + 1e-6).clamp(max=2.0 ** -7))
        use = max(use, ((probs.float() - rp.float()).abs() / bound).max()
                  .item())
        if n_real is not None and not torch.all(probs[..., n_real:] == 0):
            raise AssertionError(f"{name}: masked keys got probs")
    if use > 1.0:
        raise AssertionError(f"{name}: {use:.2f} of its bound")
    return f"{use:.2f} of the bound"


def train_use(got, ref, dtype) -> float:
    """The largest share of the train bound over dq, dk, dv: f32 1e-5 of
    each one's largest value; bf16 each element 2^-6 of its plain value
    plus 2^-8 of the largest."""
    def one(x, r):
        x, r = x.float(), r.float()
        scale = r.abs().max()
        if dtype == torch.float32:
            return ((x - r).abs().max() / (1e-5 * scale)).item()
        return ((x - r).abs() / (2.0 ** -6 * r.abs() + 2.0 ** -8 * scale)
                ).max().item()
    return max(one(x, r) for x, r in zip(got, ref))


def train_group(libs, names, dtype, shapes, dh=64) -> None:
    """The backward variants against ``head_grads_reference`` and timed,
    from the tensor-core forward's own (m, l)."""
    for b, h, n, n_real in shapes:
        q, k, v = qkv_views(b, n, h, dtype, seed=n + h, dh=dh)
        g = torch.Generator().manual_seed(n)
        do = torch.randn((b, h, n, dh), generator=g).to("cuda", dtype)
        nr = n if n_real is None else n_real
        _, stats = av._fwd(q, k, v, nr)
        ref = av.head_grads_reference(q, k, v, do, n_real)
        for name in names:
            got = call_bwd(libs[name], name, q, k, v, do, stats, n_real)
            torch.cuda.synchronize()
            use = train_use(got, ref, dtype)
            if n_real is not None and not all(
                    torch.all(x[:, :, n_real:] == 0) for x in got[1:]):
                raise AssertionError(f"{name}: masked keys got dk or dv")
            if use > 1.0:
                raise AssertionError(f"{name}: {use:.2f} of its bound")
            print(f"  {name} {(b, h, n)} n_real={n_real}: {use:.2f} of the "
                  f"bound", flush=True)
        if n_real is not None:
            continue
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(time_ms(
                    lambda: call_bwd(libs[name], name, q, k, v, do, stats)))
        print(f"  {_source_of(names[0])} backward {(b, h, n, dh)} "
              f"{str(dtype)[6:]}: " + ", ".join(
            f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
            for name, t in times.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", default=None,
                    help="keep the variants whose names hold one of these")
    ap.add_argument("--baseline", default=None,
                    help="another checkout whose sources are timed beside")
    ap.add_argument("--sass", nargs="+", default=None,
                    help="only compare these sources' SASS with --baseline's")
    args = ap.parse_args(argv)
    if args.sass:
        if args.baseline is None:
            raise SystemExit("kernel_variants: --sass needs --baseline")
        return 1 if sass_diff(args.sass, args.baseline) else 0
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    names = [n for n in VARIANTS
             if args.only is None or any(p in n for p in args.only)]
    libs = build_variants(names, args.baseline)
    # (source, head width) -> (dtype, [(B, heads, N, n_real)])
    groups = {
        ("flash_attention_mma", 64): (torch.bfloat16, [
            (1, 6, 1374, None), (1, 6, 1408, 1374), (1, 16, 577, None),
            (4, 6, 1374, None), (2, 12, 197, None)]),
        # vit_h14@224 (80 blocks: under one an SM), its padded form,
        # vit_h14@448 (N=1025: 17 x 16 blocks) and B=2 at 224
        ("flash_attention_mma", 80): (torch.bfloat16, [
            (1, 16, 257, None), (1, 16, 320, 257), (1, 16, 1025, None),
            (2, 16, 257, None)]),
        ("flash_attention_online_tf32", 64): (torch.float32, [
            (1, 6, 2814, None), (1, 6, 2814, 2800), (8, 6, 2814, None)]),
        # vit_h14@742, and keys masked beyond 2800
        ("flash_attention_online_tf32", 80): (torch.float32, [
            (1, 16, 2810, None), (1, 16, 2810, 2800)]),
        # dinov2_s14_reg@518, its padded form, vit_l16@384, B=4, and the
        # trainable attention's forward at vit_t16's train shape
        ("flash_attention_tf32", 64): (torch.float32, [
            (1, 6, 1374, None), (1, 6, 1408, 1374), (1, 16, 577, None),
            (4, 6, 1374, None), (64, 3, 197, None)]),
        # vit_h14@224 (B=1, 5 x 16 blocks: under one an SM), its padded
        # form, vit_h14@448 (N=1025) and B=2 at 224
        ("flash_attention_tf32", 80): (torch.float32, [
            (1, 16, 257, None), (1, 16, 320, 257), (1, 16, 1025, None),
            (2, 16, 257, None)]),
        # vit_t16's and vit_b16's train shapes (B=64, 3 and 12 heads,
        # N=197), keys masked beyond 197 of 208
        ("attention_train_tf32", 64): (torch.float32, [
            (64, 3, 197, None), (64, 12, 197, None), (8, 2, 208, 197)]),
        ("attention_train_mma", 64): (torch.bfloat16, [
            (64, 3, 197, None), (64, 12, 197, None), (8, 2, 208, 197)]),
        # vit_h14's: train run (f) (B=2) and run (g) (B=8), 16 heads 80
        # wide, N=257; keys masked beyond 257 of 272
        ("attention_train_tf32", 80): (torch.float32, [
            (2, 16, 257, None), (8, 16, 257, None), (2, 4, 272, 257)]),
        ("attention_train_mma", 80): (torch.bfloat16, [
            (2, 16, 257, None), (8, 16, 257, None), (2, 4, 272, 257)]),
        # row 2: vit_l16@384 at B=1 and 4 (heads 64 wide); vit_h14@742 and
        # @224 (80 wide); (B, N, D, heads)
        ("headwise_attn_block_mma", 64): (torch.bfloat16, [
            (1, 577, 1024, 16), (4, 577, 1024, 16)]),
        ("headwise_attn_block_tf32", 64): (torch.float32, [
            (1, 577, 1024, 16), (4, 577, 1024, 16)]),
        ("headwise_attn_block_mma", 80): (torch.bfloat16, [
            (1, 2810, 1280, 16), (1, 257, 1280, 16)]),
        ("headwise_attn_block_tf32", 80): (torch.float32, [
            (1, 2810, 1280, 16), (1, 257, 1280, 16)]),
    }
    row1 = [n for n in names
            if VARIANTS[n][0] in ("fused_attn_block_mma", "fused_attn_block")]
    if row1:
        if args.baseline is not None:
            row1.append("baseline:fused_attn_block")
        # vit_b16 at one image (197 rows: the 32-row tile) and eight (1576:
        # the 64-row tile), vit_t16 at one; (B, N, D, heads)
        row1_group(libs, row1, [(1, 197, 768, 12), (8, 197, 768, 12),
                                (1, 197, 192, 3)])
    for dtype, source in ((torch.bfloat16, "fused_window_attn_mma"),
                          (torch.float32, "fused_window_attn_tf32")):
        group = [n for n in names
                 if VARIANTS[n][0] in (source, "fused_window_attn")]
        if any(VARIANTS[n][0] == source for n in group):
            if args.baseline is not None:
                group.append("baseline:fused_window_attn")
            # swin_t's four stages at one image, stage 2 at eight
            row5_group(libs, group, dtype, [
                (1, 56, 96, 3), (1, 28, 192, 6), (1, 14, 384, 12),
                (1, 7, 768, 24), (8, 14, 384, 12)])
    for w8a8, sources in ((False, ("fused_mlp_block_mma", "fused_mlp_block",
                                   "fused_mlp_block_tf32")),
                          (True, ("fused_mlp_w8a8_mma",
                                  "fused_mlp_w8a8_block"))):
        group = [n for n in names if VARIANTS[n][0] in sources]
        if group and args.baseline is not None:
            group.append(f"baseline:{sources[1]}")
        if group:
            mlp_group(libs, group, w8a8)
    for (source, dh), (dtype, shapes) in groups.items():
        group = [n for n in names
                 if VARIANTS[n][0] == source and variant_dh(n) == dh]
        if not group:
            continue
        if source in BASELINE_OF:
            if args.baseline is not None:
                group.append(f"baseline:{BASELINE_OF[source]}")
            headwise_group(libs, group, dtype, shapes)
            continue
        if args.baseline is not None and dh == 64:
            group.append(f"baseline:{source}")
        if source.startswith("attention_train"):
            train_group(libs, group, dtype, shapes, dh)
            continue
        row3 = source != "flash_attention_online_tf32"
        for b, h, n, n_real in shapes:
            q, k, v = qkv_views(b, n, h, dtype, seed=n + b, dh=dh)
            if row3:
                ref = fa.flash_attention_reference(q, k, v, True, n_real)
            else:
                ref = (fa.flash_attention_online_reference(q, k, v, n_real),
                       None)
            for name in group:
                got = call(libs[name], name, q, k, v, row3, n_real)
                torch.cuda.synchronize()
                print(f"  {name} {(b, h, n, dh)} n_real={n_real}: "
                      f"{check(name, got, ref, dtype, n_real)}", flush=True)
            if n_real is not None:
                continue
            for maps in ((False, True) if row3 else (False,)):
                times = {name: [] for name in group}
                for order in (group, group[::-1]):
                    for name in order:
                        times[name].append(time_ms(
                            lambda: call(libs[name], name, q, k, v, maps)))
                print(f"  {source} {(b, h, n, dh)} {str(dtype)[6:]}"
                      + (f" maps {'on' if maps else 'off'}" if row3 else "")
                      + ": " + ", ".join(
                          f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                          f"{t[1]:.4f})" for name, t in times.items()),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
