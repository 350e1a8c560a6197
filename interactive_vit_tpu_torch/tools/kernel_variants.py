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
  compare with the register split at the same parts);
* ``flash_attention_tf32.cu`` (row 3, f32 on split TF32): the key parts of
  a tile as chosen by the grid and maps off in one online walk (the
  source), always 1 part, always 2, and maps off in two walks as maps on
  (parts by the grid);
* ``attention_train_tf32.cu`` (rows 8-9's backward, f32 on split TF32):
  streamed tiles of 32 keys or queries taken whole (the source), tiles of
  64 in halves of 32, tiles of 32 in halves of 16, and tiles of 16 taken
  whole; held against
  ``head_grads_reference`` (dq, dk, dv within 1e-5 of each one's largest
  value) from the forward's own (m, l).

Needs a CUDA card and ``nvcc``; it raises without them.
"""

from __future__ import annotations

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
ROW_TF32_PARTS = ("  return (int)(blocks <= sms ? launch_split<2>(a, s) : "
                  "launch_split<1>(a, s));")
ONE_WALK = "constexpr bool FT_ONE_WALK_MAPS_OFF = true;"
TRAIN_KT = "constexpr int TT_ROWS = 64, TT_THREADS = 128, TT_KT = 32;"
TRAIN_HALF = "constexpr int TT_HALF = TT_KT,"

# K and V split into hi and lo in shared memory once a tile: hi overwrites
# the stage in place, lo goes to a third buffer; the products read both
SMEM_SPLIT = [
    ("constexpr size_t TF_SMEM = 2 * TF_STAGE * sizeof(float);",
     "constexpr size_t TF_SMEM = 3 * TF_STAGE * sizeof(float);"),
    ("""    const float* Ks = smem + (it & 1) * TF_STAGE;
    const float* Vs = Ks + TF_KT * K_LD;
""", """    float* Kst = smem + (it & 1) * TF_STAGE;
    float* lo = smem + 2 * TF_STAGE;
    for (int i = threadIdx.x; i < TF_STAGE; i += TF_THREADS) {
      uint32_t hi, l;
      split(Kst[i], hi, l);
      Kst[i] = __uint_as_float(hi);
      lo[i] = __uint_as_float(l);
    }
    __syncthreads();
    const float* Ks = Kst;
    const float* Vs = Ks + TF_KT * K_LD;
    const float* Kl = lo;
    const float* Vl = lo + TF_KT * K_LD;
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
        (ROW_TF32_PARTS, "  return (int)launch_split<1>(a, s);")]),
    "row3_f32_parts_2": ("flash_attention_tf32", [
        (ROW_TF32_PARTS, "  return (int)launch_split<2>(a, s);")]),
    "row3_f32_two_walks": ("flash_attention_tf32", [
        (ONE_WALK, "constexpr bool FT_ONE_WALK_MAPS_OFF = false;")]),
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


def variant_source(source: str, replacements) -> str:
    """``csrc/<source>.cu`` with each replacement made; each must match
    exactly once."""
    with open(os.path.join(cuda_build.CSRC_DIR, source + ".cu")) as f:
        text = f.read()
    for old, new in replacements:
        if text.count(old) != 1:
            raise ValueError(f"{source}.cu: a variant's text matches "
                             f"{text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Write and build every variant (all at once); prints ptxas's
    registers and spills and returns the loaded libraries."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, (source, replacements) in VARIANTS.items():
        path = os.path.join(OUT_DIR, name + ".cu")
        with open(path, "w") as f:
            f.write(variant_source(source, replacements))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC_DIR, "-Xptxas", "-v", "-o",
             os.path.join(OUT_DIR, name + ".so"), path],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        info = [line.split("info    : ")[-1].strip()
                for line in err.splitlines() if "Used" in line or "spill" in line]
        print(f"{name}: {'; '.join(info)}", flush=True)
        lib = ctypes.CDLL(os.path.join(OUT_DIR, name + ".so"))
        entry, argtypes = ENTRIES[VARIANTS[name][0]]
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib
    return libs


def qkv_views(b: int, n: int, heads: int, dtype, seed: int):
    """q, k, v [B, H, N, 64] as ``qkv_proj`` makes them: views of one
    [B, N, 3D] tensor on the card."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, n, 3 * heads * 64), generator=g) * 2).to("cuda",
                                                                 dtype)
    return [x.reshape(b, n, 3, heads, 64)[:, :, i].transpose(1, 2)
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
    source = VARIANTS[name][0]
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants()
    groups = {
        "flash_attention_mma": (torch.bfloat16, [
            (1, 6, 1374, None), (1, 6, 1408, 1374), (1, 16, 577, None),
            (4, 6, 1374, None), (2, 12, 197, None)]),
        "flash_attention_online_tf32": (torch.float32, [
            (1, 6, 2814, None), (1, 6, 2814, 2800), (8, 6, 2814, None)]),
        # dinov2_s14_reg@518, its padded form, vit_l16@384, B=4, and the
        # trainable attention's forward at vit_t16's train shape
        "flash_attention_tf32": (torch.float32, [
            (1, 6, 1374, None), (1, 6, 1408, 1374), (1, 16, 577, None),
            (4, 6, 1374, None), (64, 3, 197, None)]),
        # vit_t16's and vit_b16's train shapes (B=64, 3 and 12 heads,
        # N=197), keys masked beyond 197 of 208
        "attention_train_tf32": (torch.float32, [
            (64, 3, 197, None), (64, 12, 197, None), (8, 2, 208, 197)]),
    }
    for source, (dtype, shapes) in groups.items():
        names = [n for n, (src, _) in VARIANTS.items() if src == source]
        if source == "attention_train_tf32":
            train_group(libs, names, shapes)
            continue
        row3 = source != "flash_attention_online_tf32"
        for b, h, n, n_real in shapes:
            q, k, v = qkv_views(b, n, h, dtype, seed=n + b)
            if row3:
                ref = fa.flash_attention_reference(q, k, v, True, n_real)
            else:
                ref = (fa.flash_attention_online_reference(q, k, v, n_real),
                       None)
            for name in names:
                got = call(libs[name], name, q, k, v, row3, n_real)
                torch.cuda.synchronize()
                print(f"  {name} {(b, h, n)} n_real={n_real}: "
                      f"{check(name, got, ref, dtype, n_real)}", flush=True)
            if n_real is not None:
                continue
            for maps in ((False, True) if row3 else (False,)):
                times = {name: [] for name in names}
                for order in (names, names[::-1]):
                    for name in order:
                        times[name].append(time_ms(
                            lambda: call(libs[name], name, q, k, v, maps)))
                print(f"  {source} {(b, h, n)} {str(dtype)[6:]}"
                      + (f" maps {'on' if maps else 'off'}" if row3 else "")
                      + ": " + ", ".join(
                          f"{name} {sum(t) / len(t):.4f} ms ({t[0]:.4f}, "
                          f"{t[1]:.4f})" for name, t in times.items()),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
