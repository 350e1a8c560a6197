"""Design variants of the tensor-core attention kernels, timed on the card.

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
  chosen by the grid (the source), always 2, always 4;
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
* ``attention_train_tf32.cu`` (rows 8-9's backward, f32 on split TF32):
  streamed tiles of 32 keys or queries taken whole (the source), tiles of
  64 in halves of 32, tiles of 32 in halves of 16, and tiles of 16 taken
  whole; held against
  ``head_grads_reference`` (dq, dk, dv within 1e-5 of each one's largest
  value) from the forward's own (m, l).

Heads 64 wide are timed at dinov2_s14_reg's and vit_b16's shapes, heads
80 wide (the variants whose names hold ``dh80``) at vit_h14's: N = 2810
(@742) for row 4, N = 257 (@224) and 1025 (@448) for row 3.

    python -m interactive_vit_tpu_torch.tools.kernel_variants \
        --only dh80 row4_pv_1 --baseline DIR

``--only`` keeps the variants whose names hold one of the given parts;
``--baseline DIR`` adds, to each group of heads 64 wide, the source as it
stands in another checkout ``DIR`` (the variant ``baseline``), built and
timed in the same turns: the way to hold a source edit against its parent
on one card.

Needs a CUDA card and ``nvcc``; it raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from interactive_vit_tpu_torch.ops import attention_vjp as av
from interactive_vit_tpu_torch.ops import flash_attention as fa
from interactive_vit_tpu_torch.runtime import cuda_build

OUT_DIR = os.path.join(os.path.dirname(cuda_build.BUILD_DIR), "kernel_variants")

ROW_PARTS = ("  return (int)(blocks <= sms ? launch_rowfull<4>(a, B, s) : "
             "launch_rowfull<2>(a, B, s));")
PV_PARTS = "constexpr int TF_PV_PARTS = 1;"
ROW_TF32_PARTS = ("  return blocks <= sms ? launch_split<DH, 2>(a, s) : "
                  "launch_split<DH, 1>(a, s);")
ONE_WALK = "constexpr bool FT_ONE_WALK_MAPS_OFF = true;"
TRAIN_KT = "constexpr int TT_ROWS = 64, TT_THREADS = 128, TT_KT = 32;"
TRAIN_HALF = "constexpr int TT_HALF = TT_KT,"

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

# name -> (source, replacements)
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "row3_parts_by_grid": ("flash_attention_mma", []),
    "row3_parts_2": ("flash_attention_mma", [
        (ROW_PARTS, "  return (int)launch_rowfull<2>(a, B, s);")]),
    "row3_parts_4": ("flash_attention_mma", [
        (ROW_PARTS, "  return (int)launch_rowfull<4>(a, B, s);")]),
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
    "row3_f32_dh80_parts_by_grid": ("flash_attention_tf32", []),
    "row3_f32_dh80_parts_1": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return launch_split<DH, 1>(a, s);")]),
    "row3_f32_dh80_parts_2": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return launch_split<DH, 2>(a, s);")]),
    "row3_f32_dh80_q_smem_parts_1": ("flash_attention_tf32", ROW_Q_SMEM),
    "train_bwd_kt_32_whole": ("attention_train_tf32", []),
    "train_bwd_kt_64_halves": ("attention_train_tf32", [
        (TRAIN_KT, TRAIN_KT.replace("TT_KT = 32", "TT_KT = 64")),
        (TRAIN_HALF, "constexpr int TT_HALF = TT_KT / 2,")]),
    "train_bwd_kt_32_halves": ("attention_train_tf32", [
        (TRAIN_HALF, "constexpr int TT_HALF = TT_KT / 2,")]),
    "train_bwd_kt_16_whole": ("attention_train_tf32", [
        (TRAIN_KT, TRAIN_KT.replace("TT_KT = 32", "TT_KT = 16"))]),
}


# source -> (C entry, its ctypes argtypes)
ENTRIES = {
    "flash_attention_mma": ("ivt_flash_attention_mma", fa.FLASH_MMA_ARGTYPES),
    "flash_attention_online_tf32": ("ivt_flash_attention_online_tf32x3",
                                    fa.ONLINE_TF32_ARGTYPES),
    "flash_attention_tf32": ("ivt_flash_attention_tf32x3",
                             fa.FLASH_TF32_ARGTYPES),
    "attention_train_tf32": ("ivt_attention_train_bwd_tf32",
                             av.TRAIN_TF32_BWD_ARGTYPES),
}


def variant_dh(name: str) -> int:
    """The head width a variant is timed at."""
    return 80 if "dh80" in name else 64


def variant_source(source: str, replacements,
                   csrc: str = cuda_build.CSRC_DIR) -> str:
    """``<csrc>/<source>.cu`` with each replacement made; each must match
    exactly once."""
    with open(os.path.join(csrc, source + ".cu")) as f:
        text = f.read()
    for old, new in replacements:
        if text.count(old) != 1:
            raise ValueError(f"{source}.cu: a variant's text matches "
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
        for source in sorted({VARIANTS[name][0] for name in names}):
            builds[f"baseline:{source}"] = ([], csrc)
    procs = {}
    for name, (replacements, csrc) in builds.items():
        source = _source_of(name)
        path = os.path.join(OUT_DIR, name.replace(":", "_") + ".cu")
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
        lib = ctypes.CDLL(os.path.join(OUT_DIR,
                                       name.replace(":", "_") + ".so"))
        entry, argtypes = ENTRIES[_source_of(name)]
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib
    return libs


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


def call_bwd(lib, q, k, v, do, stats, n_real=None):
    """One launch of a backward variant on [B, H, N, 64] views, from the
    forward's (m, l) ``stats``: (dq, dk, dv)."""
    b, h, n, dh = q.shape
    grads = [torch.empty((b, n, h, dh), dtype=q.dtype,
                         device=q.device).transpose(1, 2) for _ in range(3)]
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    ts = (q, k, v, do, *grads)
    flat = (ctypes.c_longlong * 21)(*[s for t in ts for s in t.stride()[:3]])
    err = lib.ivt_attention_train_bwd_tf32(
        *(t.data_ptr() for t in ts), stats.data_ptr(), delta.data_ptr(),
        ctypes.addressof(flat), b, h, n, dh, n if n_real is None else n_real,
        float(dh) ** -0.5, fa.MASK_VALUE,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"backward variant: launch failed, cudaError {err}")
    return grads


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


def train_group(libs, names, shapes) -> None:
    """The backward variants against ``head_grads_reference`` and timed,
    from the split-TF32 forward's own (m, l)."""
    for b, h, n, n_real in shapes:
        q, k, v = qkv_views(b, n, h, torch.float32, seed=n + h)
        g = torch.Generator().manual_seed(n)
        do = torch.randn((b, h, n, 64), generator=g).to("cuda")
        nr = n if n_real is None else n_real
        _, stats = av._fwd(q, k, v, nr)
        ref = av.head_grads_reference(q, k, v, do, n_real)
        for name in names:
            got = call_bwd(libs[name], q, k, v, do, stats, n_real)
            torch.cuda.synchronize()
            use = max(((x - r).abs().max() / (1e-5 * r.abs().max())).item()
                      for x, r in zip(got, ref))
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
                    lambda: call_bwd(libs[name], q, k, v, do, stats)))
        print(f"  attention_train_tf32 backward {(b, h, n)}: " + ", ".join(
            f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f})"
            for name, t in times.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", default=None,
                    help="keep the variants whose names hold one of these")
    ap.add_argument("--baseline", default=None,
                    help="another checkout whose sources are timed beside")
    args = ap.parse_args(argv)
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
    }
    for (source, dh), (dtype, shapes) in groups.items():
        group = [n for n in names
                 if VARIANTS[n][0] == source and variant_dh(n) == dh]
        if not group:
            continue
        if args.baseline is not None and dh == 64:
            group.append(f"baseline:{source}")
        if source == "attention_train_tf32":
            train_group(libs, group, shapes)
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
