"""The window attention's (row 5's) tensor-core routes, on the CPU: the
route predicate, emulations of the kernels' arithmetic held against the
JAX package's Pallas ``fused_window_attn`` in interpret mode on shared
inputs, the bounds' refusal of an emulation that lets the padded keys into
the row sum, the C entries' ctypes signatures, the loaders' checks and the
wrappers' CPU path:

* bf16, ``csrc/fused_window_attn_mma.cu``: the cast points (qkv, the head
  outputs and a cast to bf16; maps on: probs = p / rowsum cast once, the
  tap and PV's operand; maps off: p cast before PV, the f32 result times
  1 / rowsum), the f32 sums of the QKV product and the projection over
  k-tiles of 64, the scores over the head dim, PV over one key tile of 64
  whose keys past the window's T are zero (p = 0 for them);
* f32, ``csrc/fused_window_attn_tf32.cu``: every product as three TF32
  products of a hi / lo split (the helpers of
  ``tests/test_torch_fused_block_tc.py``), the two GEMMs over k-tiles of
  32, a score over the head dim, PV over the one key tile of 64.

The kernels themselves run only on the card: their ``cuda``-marked tests
are in ``tests/test_torch_cuda_kernel.py``, and ``chip_smoke.py`` holds
them against the plain version at the served shapes.

Inputs and parameters are made with numpy from a seed and handed to both
packages; the JAX package runs its Pallas kernel in interpret mode,
unchanged. Windows of 7 (T = 49 tokens padded to 64), C = 64 (2 heads of
32) and 96 (3 heads), maps 14 x 14 (four windows) and 7 x 7 (one), shift 0
and 3 (the seam mask), maps on and off, fast and exact softmax: seven
geometries and modes that cover each value, in both dtypes.

Tolerances. f32: 1e-4 absolute on a and the maps, the contract's (the
split's products are within ~2^-21 of the f32 ones). bf16:
``chip_smoke.py``'s bounds: a within 2^-6 of max(1, its largest value),
each probs element within min(2^-7, 2^-5 of the JAX value + 1e-6).
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.ops import fused_window as jfw
from interactive_vit_tpu_torch.ops import fused_window as fw
from interactive_vit_tpu_torch.tools import kernel_variants
from tests.test_torch_fused_block_tc import (
    _entry_kinds, _read, _tiled, matmul_3xtf32, matmul_f32,
)

torch.set_num_threads(2)

F32 = torch.float32
BF16 = torch.bfloat16
F32_BOUND = 1e-4
BF16_Y_REL = 2.0 ** -6
BF16_P_REL, BF16_P_ABS, BF16_P_CAP = 2.0 ** -5, 1e-6, 2.0 ** -7
WIN = 7
# (C, map side, shift, maps, fast softmax)
CASES = [(64, 14, 0, False, True), (64, 14, 3, True, True),
         (64, 7, 0, True, False), (96, 14, 3, False, False),
         (96, 14, 3, True, False), (96, 7, 0, False, True),
         (96, 14, 0, True, True)]


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(jfw.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- the route ---------------------------------------------------------------------

# (dtype, window, dh, C, byte addresses, route)
ROUTE_CASES = [
    # swin_t's stages (C = 96 .. 768), swin_b's widest (1024)
    (BF16, 7, 32, 96, (0, 1 << 20, 1 << 21, 1 << 22, 1 << 23), "mma"),
    (F32, 7, 32, 96, (0, 4096), "tf32"),
    (BF16, 7, 32, 768, (0, 512), "mma"),
    (F32, 7, 32, 1024, (0, 512), "tf32"),
    (BF16, 8, 32, 384, (0, 512), "mma"),         # T = 64, one whole tile
    # window 12 (T = 144, the 384 px models): more than a tile
    (BF16, 12, 32, 128, (0, 512), "fma"),
    (F32, 9, 32, 128, (0, 512), "fma"),
    # other head widths, widths and dtypes keep the FMA kernel
    (BF16, 7, 16, 96, (0, 512), "fma"),
    (F32, 7, 64, 384, (0, 512), "fma"),
    (BF16, 7, 32, 1312, (0, 512), "fma"),       # wider than the panel takes
    (torch.float16, 7, 32, 96, (0, 512), "fma"),
    # an operand off the 16-byte grid: y, qkv_b, proj_w
    (BF16, 7, 32, 96, (2, 512), "fma"),
    (F32, 7, 32, 96, (0, 520), "fma"),
    (BF16, 7, 32, 96, (0, 512, 1032), "fma"),
]


@pytest.mark.parametrize("dtype,window,dh,c,addrs,route", ROUTE_CASES)
def test_window_route_by_dtype_shape_and_alignment(dtype, window, dh, c,
                                                   addrs, route):
    assert fw.window_route(dtype, window, dh, c, addrs) == route


def _operands(b, res, c, dtype, offsets=None):
    """y [B, res, res, C] and a branch's weights as contiguous CPU tensors,
    each starting ``offsets[name]`` elements into its storage."""
    offsets = offsets or {}

    def at(name, shape):
        size, off = int(np.prod(shape)), offsets.get(name, 0)
        return torch.zeros(size + off, dtype=dtype)[off:].view(shape)

    p = {k: at(k, s) for k, s in (("qkv_w", (c, 3 * c)), ("qkv_b", (3 * c,)),
                                  ("proj_w", (c, c)), ("proj_b", (c,)))}
    return at("y", (b, res, res, c)), p


@pytest.mark.parametrize("dtype,c,heads,offsets,route", [
    (BF16, 384, 12, {}, "mma"),        # swin_t stage 2
    (F32, 384, 12, {}, "tf32"),
    (BF16, 96, 3, {"y": 1}, "fma"),    # y 2 bytes off the grid
    (F32, 96, 3, {"y": 2}, "fma"),     # 8 bytes off
    (F32, 96, 3, {"y": 4}, "tf32"),    # 16 bytes off: on the grid
    (BF16, 96, 3, {"qkv_w": 1}, "fma"),
    (F32, 96, 3, {"qkv_b": 1}, "fma"),
    (BF16, 96, 3, {"proj_w": 4}, "fma"),
    (BF16, 96, 3, {"proj_b": 8}, "mma"),
    (BF16, 96, 6, {}, "fma"),          # heads 16 wide
])
def test_route_of_a_branchs_operands(dtype, c, heads, offsets, route):
    y, p = _operands(1, 14, c, dtype, offsets)
    assert fw._window_route_of(y, p, heads, WIN) == route


def test_tensor_core_envelope_is_inside_the_fma_one():
    """Every branch the tensor-core routes take also fits the FMA kernel
    (``fits``, which ``dispatch.default_window_impl`` reads): the routes
    never change which models the dispatch fuses."""
    for window in range(1, 9):
        for c in range(32, fw.WINDOW_TC_MAX_WIDTH + 1, 32):
            if fw.window_route(BF16, window, 32, c, (0,)) == "mma":
                assert fw.fits(2 * window, window, c, c // 32)


# -- the emulations -----------------------------------------------------------------

T_TILE = 64  # the kernels' key tile: a window's tokens, padded


def emulate(y, p, heads, window, bias, mask, route, want_attn=False,
            fast_softmax=True, wrong=None):
    """A route's arithmetic on CPU tensors of the activation dtype: (a,
    probs | None). ``wrong="padded_keys"``: the keys past T padded with
    zeros enter the row sum (p = exp(0) for the fast form), for the
    refusal test."""
    dt = y.dtype
    b, hres, wres, c = y.shape
    dh, t = c // heads, window * window
    mm = matmul_f32 if route == "mma" else matmul_3xtf32
    gemm_tile = 64 if route == "mma" else 32
    qkv = (_tiled(mm, y.float(), p["qkv_w"].float(), gemm_tile)
           + p["qkv_b"].float()).to(dt)
    qkv = fw.window_partition(qkv, window)
    nw = qkv.shape[1]
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, nw, t, heads, dh)
               .transpose(2, 3).float() for i in range(3))

    def pad(x):  # rows t..63 of a tile are zero
        return torch.cat([x, x.new_zeros(x.shape[:-2] + (T_TILE - t, dh))],
                         dim=-2)

    k, v = pad(k), pad(v)
    s = mm(q, k.transpose(-1, -2)) * (dh ** -0.5)
    real = s[..., :t] + bias.float()
    if mask is not None:
        real = real + torch.as_tensor(mask, dtype=F32)[None, :, None]
    s = torch.cat([real, s[..., t:]], dim=-1)
    if fast_softmax:
        pe = torch.exp(torch.clamp(s, max=fw.SOFTMAX_CLAMP))
    else:
        pe = torch.exp(s - real.amax(dim=-1, keepdim=True))
    if wrong != "padded_keys":
        pe = torch.cat([pe[..., :t], torch.zeros_like(pe[..., t:])], dim=-1)
    r = 1.0 / pe.sum(dim=-1, keepdim=True)
    probs = None
    if want_attn:
        pa = (pe * r).to(dt)
        probs = pa[..., :t]
        o = mm(pa.float(), v)
    else:
        o = mm(pe.to(dt).float(), v) * r
    o = fw.window_merge(o.transpose(2, 3).reshape(b, nw, t, c).to(dt),
                        window, hres, wres)
    a = (_tiled(mm, o.float(), p["proj_w"].float(), gemm_tile)
         + p["proj_b"].float()).to(dt)
    return a, probs


_JAX_CACHE = {}


def _case(c, res, shift, maps, fast, dtype):
    """(torch y, params, bias, mask, the wrapper's keywords, the JAX
    kernel's (a, probs) as f32 torch tensors); the JAX results computed
    once a case."""
    heads = c // 32
    rng = np.random.default_rng(c + res + shift)

    def rnd(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {"qkv_w": rnd(c, 3 * c, std=c ** -0.5), "qkv_b": rnd(3 * c, std=0.1),
         "proj_w": rnd(c, c, std=c ** -0.5), "proj_b": rnd(c, std=0.1)}
    y = rnd(2, res, res, c)
    bias = rnd(heads, WIN * WIN, WIN * WIN, std=0.5)
    mask = jswin.shift_attn_mask(res, WIN, shift)
    if dtype == BF16:  # the same bf16 values on both sides
        p = {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
             for k, v in p.items()}
        y = np.array(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    kw = dict(want_attn=maps, fast_softmax=fast)
    key = (c, res, shift, maps, fast, str(dtype))
    if key not in _JAX_CACHE:
        jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
        out = jfw.fused_window_attn(
            jnp.asarray(y, jdt), {k: jnp.asarray(v, jdt) for k, v in p.items()},
            heads, WIN, jnp.asarray(bias), mask, **kw)
        _JAX_CACHE[key] = [None if o is None else torch.from_numpy(
            np.array(o.astype(jnp.float32))) for o in out]
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
    return (torch.from_numpy(y).to(dtype), tp, torch.from_numpy(bias), mask,
            kw, _JAX_CACHE[key])


def _use(got, want, dtype):
    """The largest share of its bound any output of ``got`` takes against
    ``want`` (inf where a shape differs)."""
    uses = []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
            continue
        if tuple(g.shape) != tuple(w.shape):
            return float("inf")
        diff = (g.float() - w).abs()
        if dtype == F32:
            bound = F32_BOUND
        elif i == 0:
            bound = BF16_Y_REL * max(1.0, float(w.abs().max()))
        else:
            bound = (BF16_P_REL * w.abs() + BF16_P_ABS).clamp(max=BF16_P_CAP)
        uses.append(float((diff / bound).max()))
    return max(uses)


@pytest.mark.parametrize("dtype,route", [(F32, "tf32"), (BF16, "mma")])
@pytest.mark.parametrize("c,res,shift,maps,fast", CASES)
def test_route_emulation_matches_jax(c, res, shift, maps, fast, dtype,
                                     route):
    y, p, bias, mask, kw, want = _case(c, res, shift, maps, fast, dtype)
    got = emulate(y, p, c // 32, WIN, bias, mask, route, **kw)
    assert got[0].dtype == dtype and got[0].shape == y.shape
    assert _use(got, want, dtype) <= 1.0
    if maps:
        # the tap is the cast of the probs that fed PV: rows sum to 1
        assert float((got[1].float().sum(-1) - 1).abs().max()) <= 2.0 ** -7
        if mask is not None:
            blocked = torch.from_numpy(mask)[None, :, None] < 0
            seam = got[1].float()[blocked.expand_as(got[1])]
            # exp(-100): exactly 0 in bf16, a denormal in f32
            assert seam.numel() and bool((seam < 1e-37).all())
            if dtype == BF16:
                assert bool((seam == 0).all())
    # the plain version, which the kernels are held against on the card,
    # agrees with the emulation too
    ref = fw.fused_window_attn_reference(y, p, c // 32, WIN, bias, mask, **kw)
    assert _use(got, [r.float() if r is not None else None for r in ref],
                dtype) <= 1.0


@pytest.mark.parametrize("dtype,route", [(F32, "tf32"), (BF16, "mma")])
@pytest.mark.parametrize("c,res,shift,maps,fast", [CASES[1], CASES[3]])
def test_bounds_refuse_padded_keys_in_the_row_sum(c, res, shift, maps, fast,
                                                  dtype, route):
    """A zero-filled key scores 0; an emulation that forgets p = 0 for the
    15 padded keys of a 49-token window adds exp(0) (or exp(-max)) to every
    row sum, and the same bounds refuse it."""
    y, p, bias, mask, kw, want = _case(c, res, shift, maps, fast, dtype)
    good = emulate(y, p, c // 32, WIN, bias, mask, route, **kw)
    assert _use(good, want, dtype) <= 1.0
    bad = emulate(y, p, c // 32, WIN, bias, mask, route, wrong="padded_keys",
                  **kw)
    assert _use(bad, want, dtype) > 1.0


# -- the C entries, the instructions, the loaders ------------------------------------

@pytest.mark.parametrize("source,entry", [
    ("fused_window_attn_mma.cu", "ivt_fused_window_attn_mma"),
    ("fused_window_attn_tf32.cu", "ivt_fused_window_attn_tf32x3"),
])
def test_tc_entry_matches_its_ctypes_signature(source, entry):
    """Each tensor-core C entry's parameters, read from its source, against
    the argtypes the wrapper binds: the FMA entry's without the dtype."""
    kinds, names = _entry_kinds(source, entry)
    assert kinds == fw.TC_ENTRY_ARGTYPES
    fma_kinds, fma_names = _entry_kinds("fused_window_attn.cu",
                                        "ivt_fused_window_attn")
    assert fma_kinds == fw.ENTRY_ARGTYPES
    assert names == fma_names[1:]


@pytest.mark.parametrize("source,entry,args", [
    ("fused_window_attn_mma.cu", "ivt_window_mma_dh", [ctypes.c_int]),
    ("fused_window_attn_mma.cu", "ivt_window_mma_max_tokens", []),
    ("fused_window_attn_mma.cu", "ivt_window_mma_max_width", []),
    ("fused_window_attn_mma.cu", "ivt_window_mma_qkv_rows", [ctypes.c_int]),
    ("fused_window_attn_mma.cu", "ivt_window_mma_qkv_smem",
     [ctypes.c_int, ctypes.c_int]),
    ("fused_window_attn_tf32.cu", "ivt_window_tf32_dh", [ctypes.c_int]),
    ("fused_window_attn_tf32.cu", "ivt_window_tf32_max_tokens", []),
    ("fused_window_attn_tf32.cu", "ivt_window_tf32_max_width", []),
    ("fused_window_attn_tf32.cu", "ivt_window_tf32_qkv_smem", [ctypes.c_int]),
])
def test_shape_entries_take_ints(source, entry, args):
    assert _entry_kinds(source, entry)[0] == args


def test_sources_use_their_instructions():
    """bf16: mma.sync m16n8k16 (mma_attention.cuh) for the scores and PV,
    row 1's QKV kernel and the projection without its residual
    (attn_block_mma.cuh); f32: the split's m16n8k8 tf32 (tf32_attention.cuh)
    and the same two GEMMs of attn_block_tf32.cuh. No source holds asm of
    its own; the FMA source keeps its scalar loops."""
    mma, tf32 = _read("fused_window_attn_mma.cu"), _read("fused_window_attn_tf32.cu")
    assert '#include "attn_block_mma.cuh"' in mma
    assert "mma_rows<" in mma and "mma_a_by_cols<" in mma
    assert "launch_qkv_bm<" in mma and "proj_mma_kernel<false>" in mma
    assert '#include "attn_block_tf32.cuh"' in tf32
    assert "mma3_rows<" in tf32 and "mma3_acc_by_cols<" in tf32
    assert "launch_qkv_tf32(" in tf32 and "proj_tf32_kernel<false>" in tf32
    for src in (mma, tf32):
        assert "asm(" not in src and "asm volatile" not in src
    assert "__global__" in _read("attn_block_mma.cuh")
    assert "row1_qkv_mma_kernel" in _read("attn_block_mma.cuh")
    assert "row1_qkv_tf32_kernel" in _read("attn_block_tf32.cuh")
    assert "fmaf(" in _read("fused_window_attn.cu")


@pytest.mark.parametrize("here,parent", [
    # the projections' option (rows 1-2 take the default), as ptxas names
    # them here and in the parent, the anonymous namespace normalised
    ("_ZN56ANONproj_mma_kernelILb1EEEvPK13__nv_bfloat16S3_S3_S3_PS1_iii",
     "_ZN56ANONproj_mma_kernelEPK13__nv_bfloat16S2_S2_S2_PS0_iii"),
    ("_ZN57ANONproj_tf32_kernelILb1EEEvPKfS2_S2_S2_Pfiii",
     "_ZN57ANONproj_tf32_kernelEPKfS1_S1_S1_Pfiii"),
    # a kernel since templated on the head width, 64 the old one
    ("_ZN59ANONheadwise_mma_kernelILi64ELi1EEEvNS_6HwArgsE",
     "_ZN59ANONheadwise_mma_kernelILi1EEEvNS_6HwArgsE"),
])
def test_sass_check_maps_a_templated_kernel_onto_its_old_name(here, parent):
    """``kernel_variants --sass`` holds rows 1-2's kernels to the parent's:
    the projection given a ``RES`` option keeps its SASS only if its
    ``<true>`` instantiation is found under the old name."""
    assert kernel_variants.untemplated(here) == parent
    if "ILb1E" in here:
        # the option's other value is a new kernel, not the old one
        other = here.replace("ILb1E", "ILb0E")
        assert kernel_variants.untemplated(other) != parent


class _FakeLib:
    """A library's shape entries from tables, for the loader check."""

    def __init__(self, route, dhs=fw.WINDOW_TC_DHS,
                 tokens=fw.WINDOW_TC_MAX_TOKENS, width=fw.WINDOW_TC_MAX_WIDTH,
                 qkv_extra=0, small_m=512):
        from interactive_vit_tpu_torch.ops import fused_block as fb

        pre = fw._WINDOW_TC[route][2]
        setattr(self, pre + "dh",
                lambda i: dhs[i] if 0 <= i < len(dhs) else 0)
        setattr(self, pre + "max_tokens", lambda: tokens)
        setattr(self, pre + "max_width", lambda: width)
        self.ivt_window_mma_qkv_rows = lambda m: 32 if m <= small_m else 64
        self.ivt_window_mma_qkv_smem = (
            lambda d, bm: fb.row1_qkv_smem_bytes(d, 2, bm) + qkv_extra)
        self.ivt_window_tf32_qkv_smem = (
            lambda d: fb.row1_qkv_smem_bytes(d, 4, 32) + qkv_extra)


@pytest.mark.parametrize("route", ["mma", "tf32"])
@pytest.mark.parametrize("fault,ok", [
    ({}, True),
    ({"dhs": (32, 64)}, False),       # a library with another width
    ({"dhs": ()}, False),
    ({"tokens": 49}, False),
    ({"width": 1024}, False),
    ({"qkv_extra": 16}, False),       # another QKV panel or ring
])
def test_loader_refuses_a_library_that_disagrees(route, fault, ok):
    lib = _FakeLib(route, **fault)
    if ok:
        fw.check_window_library(lib, route)
        return
    with pytest.raises(RuntimeError, match="disagree"):
        fw.check_window_library(lib, route)


def test_mma_loader_refuses_another_qkv_tile_rule():
    with pytest.raises(RuntimeError, match="disagree"):
        fw.check_window_library(_FakeLib("mma", small_m=256), "mma")


# -- the wrappers on the CPU ------------------------------------------------------

def _counts():
    return {route: w.launches for route, w in fw._WINDOW_WRAPPERS.items()}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("want_attn", [False, True])
def test_route_wrappers_keep_the_plain_version_on_the_cpu(dtype, want_attn):
    """CPU tensors run the plain version whatever the route would be on a
    card; no launch is counted."""
    y, p, bias, mask, kw, _ = _case(64, 14, 3, want_attn, True, F32)
    y, p = y.to(dtype), {k: v.to(dtype) for k, v in p.items()}
    kw = dict(kw, want_attn=want_attn)
    before = _counts()
    ref = fw.fused_window_attn_reference(y, p, 2, WIN, bias, mask, **kw)
    for fn in fw._WINDOW_WRAPPERS.values():
        got = fn(y, p, 2, WIN, bias, mask, **kw)
        assert all((g is None and r is None) or torch.equal(g, r)
                   for g, r in zip(got, ref)), fn.__name__
    assert _counts() == before


@pytest.mark.parametrize("route", ["mma", "tf32"])
def test_route_wrappers_refuse_devices_they_have_no_path_for(route):
    y, p = _operands(1, 14, 64, F32)
    bias = torch.zeros((2, 49, 49))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fw._WINDOW_WRAPPERS[route](y.to("meta"), p, 2, WIN, bias)


@pytest.mark.parametrize("route", ["fma", "mma", "tf32"])
def test_each_launch_is_counted_once_in_its_routes_wrapper(monkeypatch,
                                                           route):
    """With the launch stubbed and y taken for a card's: the dispatching
    wrapper (and, off "fma", the route's own wrapper) launches once on the
    route and moves only that route's count; a route's own wrapper refuses
    operands that ``window_route`` sends elsewhere."""
    calls = []

    def launch(rt, y, p, heads, window, bias, mask, want_attn, fast):
        calls.append((rt, want_attn, fast))
        return torch.empty_like(y), None  # a launch's fresh output

    monkeypatch.setattr(fw, "_on_device", lambda y, name: True)
    monkeypatch.setattr(fw, "_window_route_of",
                        lambda y, p, heads, window: route)
    monkeypatch.setattr(fw, "_launch", launch)
    y, p = _operands(1, 14, 64, F32)
    bias = torch.zeros((2, 49, 49))
    fns = [fw.fused_window_attn] + (
        [fw._WINDOW_WRAPPERS[route]] if route != "fma" else [])
    for fn in fns:
        for want_attn, fast in ((False, True), (True, False)):
            before = _counts()
            fn(y, p, 2, WIN, bias, want_attn=want_attn, fast_softmax=fast)
            assert _counts() == dict(before, **{route: before[route] + 1})
            assert calls.pop() == (route, want_attn, fast)
    assert not calls
    for other in {"mma", "tf32"} - {route}:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fw._WINDOW_WRAPPERS[other](y, p, 2, WIN, bias)
