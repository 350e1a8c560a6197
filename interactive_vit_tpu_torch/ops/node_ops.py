"""Built-in graph node kinds.

Counterpart of ``interactive_vit_tpu/ops/node_ops.py``: every kind of the
JAX package. Each kind has the JAX kind's ``io``, ``dynamic_params`` and
``contents`` HTML, and each ``fn`` is capturable into a CUDA graph: no
read-back to the host, no upload from pageable memory, no Python indexing
by a tensor's value. A dynamic param rides as a 0-d (or, for conv2d's
matrix, a fixed-shape) capture, so an edit of it replays the executor's
cached program.

  cos       params A, b           -> cos(A*x + b); A and b are dynamic
  binop     op in {+,-,*,/}       elementwise a OP b, numpy broadcasting
  slice     fixed=[{dim,val}], free=[{in_dim,out_dim}]
  shuffle   free=[{in_dim,out_dim}] dimension permutation
  const     value (dynamic), dims  filled f32 tensor
  noise     dims, seed (dynamic)   uniform [0,1), jax.random's bits
  conv2d    matrix (dynamic, base64 f32), h, w   valid-pad 2-D conv
  resize    dims=[H,W]            bilinear resize of the trailing two dims
  pca_view  skip                  patch-PCA -> RGB (DINO dense-feature view)
  patch_sim row, col (dynamic), skip   token cosine-similarity heatmap
  similarity scale (dynamic)      scaled cosine-similarity logits
  saliency  target, class, mode, steps, sigma, seed, wrt, skip
                                  input-gradient attribution heatmap
  dream     target, class, steps, lr, clip_lo, clip_hi, wrt
                                  normalized gradient ascent on the leaf
  occlusion target, class, patch, stride, fill, wrt
                                  score drop under a sliding occluder
  img_src   identity; img_view / multi_view / category / attn_view /
            overlay: sinks that pass their inputs through for the taps

These kinds are XLA ops in the JAX package (no Pallas kernel), so here they
are plain PyTorch. The three gradient kinds (``grad_node``) are handed
their ancestor cone as a closed ``forward`` by the executor
(``graph/executor.py``); saliency and dream differentiate it with
``torch.autograd.grad`` (the cone's layers on their plain twins), occlusion
only runs it forward, in chunks of ``OCCLUSION_CHUNK`` masked copies.
"""

from __future__ import annotations

import base64
import html
import json
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.graph.registry import NodeKind, Registry


def _jparam(params: Dict[str, str], key: str, default):
    if key not in params:
        return default
    v = params[key]
    return json.loads(v) if isinstance(v, str) else v


def _num_input(name: str, value, step="any", title=None) -> str:
    """A labeled numeric input bound to a node param (the ``data-param``
    convention the frontend binds to the node's params dict)."""
    label = html.escape(title or name)
    return (
        f"<label>{label} <input data-param=\"{html.escape(name)}\" "
        f"type=\"number\" step=\"{step}\" value=\"{value}\"></label>"
    )


def _dims_input(dims) -> str:
    return (f"<label>dims <input data-param=\"dims\" type=\"text\" "
            f"value=\"{html.escape(json.dumps(dims))}\"></label>")


class CosNode(NodeKind):
    """Elementwise cos(A*x + b), the reference's demo server node. A and b
    are dynamic params: they ride as 0-d f32 captures, so an edit reuses
    the executor's cached program."""

    def __init__(self) -> None:
        super().__init__("cos")

    def decode_params(self, params: Dict[str, str]):
        return float(params.get("A", 1.0)), float(params.get("b", 0.0))

    def contents(self, params):
        a, b = self.decode_params(params)
        return (f"<p>cos(A&middot;x + b)</p>"
                f"{_num_input('A', a)} {_num_input('b', b)}")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"A", "b"})

    def captures(self, params):
        a, b = self.decode_params(params)
        return {"A": torch.tensor(a, dtype=torch.float32),
                "b": torch.tensor(b, dtype=torch.float32)}

    def fn(self, params):
        def run(ins, caps):
            x = ins["o"]
            # the captures cast to the stream's dtype, as the JAX kind
            # casts them: a bf16 stream stays bf16
            a = caps["A"].to(x.dtype)
            b = caps["b"].to(x.dtype)
            return {"o": torch.cos(a * x + b)}

        return run


class BinOpNode(NodeKind):
    """Elementwise a OP b; channels a, b -> c. numpy broadcasting and
    promotion (bf16 with f32 gives f32, integer division a float), as
    ``jnp``'s."""

    OPS = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div}

    def __init__(self) -> None:
        super().__init__("binop")

    def contents(self, params):
        cur = params.get("op", "+")
        opts = "".join(
            f"<option value=\"{o}\"{' selected' if o == cur else ''}>"
            f"a {o} b</option>" for o in self.OPS
        )
        return f"<select data-param=\"op\">{opts}</select>"

    def io(self, params):
        return {"ins": ["a", "b"], "outs": ["c"]}

    def fn(self, params):
        op = self.OPS[params.get("op", "+")]
        return lambda ins: {"c": op(ins["a"], ins["b"])}


class _IndexNode(NodeKind):
    """Shared slice / shuffle logic.

    fixed: list of {dim, val}: input dims pinned to an index.
    free:  list of {in_dim, out_dim}: surviving dims, re-ordered so output
           dim ``out_dim`` reads input dim ``in_dim``.
    """

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def contents(self, params):
        fixed = _jparam(params, "fixed", [])
        free = _jparam(params, "free", [])
        n = len(fixed) + len(free)
        spec = ["?"] * n
        for f in fixed:
            if int(f["dim"]) < n:
                spec[int(f["dim"])] = str(int(f["val"]))
        for f in free:
            if int(f["in_dim"]) < n:
                spec[int(f["in_dim"])] = f"d{int(f['out_dim'])}"
        expr = ", ".join(spec) if spec else ":"
        return f"<p>{self.name}</p><code>y = x[{expr}]</code>"

    def fn(self, params):
        fixed = _jparam(params, "fixed", [])
        free = _jparam(params, "free", [])

        def run(ins):
            x = ins["o"]
            idx = [slice(None)] * x.ndim
            for f in fixed:
                idx[int(f["dim"])] = int(f["val"])
            y = x[tuple(idx)]
            # surviving input dims, ascending, map to positions 0..k-1
            kept = sorted(int(f["in_dim"]) for f in free)
            pos = {d: i for i, d in enumerate(kept)}
            perm = [0] * len(free)
            for f in free:
                perm[int(f["out_dim"])] = pos[int(f["in_dim"])]
            return {"o": y.permute(perm) if perm else y}

        return run


class SliceNode(_IndexNode):
    def __init__(self) -> None:
        super().__init__("slice")


class ShuffleNode(_IndexNode):
    def __init__(self) -> None:
        super().__init__("shuffle")


class ConstNode(NodeKind):
    """An f32 tensor of ``dims`` filled with ``value``, a dynamic param.

    The value stays on the device: the 0-d capture is expanded to ``dims``
    and copied, where ``torch.full`` would need it as a Python number (a
    read-back that a capture refuses)."""

    def __init__(self) -> None:
        super().__init__("const")

    def contents(self, params):
        value = float(_jparam(params, "value", 0.0))
        dims = _jparam(params, "dims", [1])
        return (f"<p>const fill</p>{_num_input('value', value)} "
                f"{_dims_input(dims)}")

    def io(self, params):
        return {"ins": [], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"value"})

    def captures(self, params):
        return {"value": torch.tensor(float(_jparam(params, "value", 0.0)),
                                      dtype=torch.float32)}

    def fn(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [1])]
        return lambda ins, caps: {
            "o": caps["value"].to(torch.float32).expand(dims).contiguous()}


_U32 = 0xFFFFFFFF
# threefry2x32's rotation schedule (Salmon et al. 2011), as jax.random's
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _U32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block cipher of ``jax.random``'s default key (20
    rounds, five key injections) on 32-bit words held in int64 tensors
    (each add and shift masked back to 32 bits). ``k0``, ``k1``: the key
    words (ints or tensors); ``x0``, ``x1``: the counter words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _unit_floats(k0, k1, dims: List[int], device, n: Optional[int] = None
                 ) -> torch.Tensor:
    """``jax.random``'s [0, 1) floats of key (k0, k1), with
    ``jax_threefry_partitionable`` (the default since JAX 0.5): element
    i's counter is (i >> 32, i & 0xFFFFFFFF) in row-major order; its bits
    are the two output words XORed; the value is their top 23 bits as a
    mantissa of [1, 2), minus 1, which is exactly (bits >> 9) * 2^-23.
    ``n``: the element count of one key's draw, where the key words
    broadcast over several keys (default: the product of ``dims``)."""
    if n is None:
        n = int(np.prod(dims))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, idx >> 32, idx & _U32)
    bits = x0 ^ x1
    return ((bits >> 9).to(torch.float32) * 2.0 ** -23).reshape(dims)


def uniform_bits(seed: torch.Tensor, dims: List[int]) -> torch.Tensor:
    """``jax.random.uniform(jax.random.key(seed), dims, float32)`` bit for
    bit: the key is (0, seed). ``seed``: an int64 tensor in [0, 2^32) on
    the device the values are made on."""
    return _unit_floats(0, seed, dims, seed.device)


def uniform_key_bits(key, dims: List[int], device) -> torch.Tensor:
    """``jax.random.uniform(key, dims, float32)`` of a threefry key (k0, k1)
    (Python ints, as ``prng_key`` / ``fold_in`` make them on the host, or
    int64 tensors) bit for bit, made on ``device``."""
    return _unit_floats(key[0], key[1], dims, device)


def uniform_bits_stacked(seeds: torch.Tensor, dims: List[int]
                         ) -> torch.Tensor:
    """``uniform_bits`` of each seed of ``seeds`` ([K] int64), stacked:
    [K, *dims], row k bit for bit ``uniform_bits(seeds[k], dims)``, in one
    pass of the cipher for all K."""
    k = seeds.shape[0]
    return _unit_floats(0, seeds.reshape(k, 1), [-1], seeds.device,
                        n=int(np.prod(dims))).reshape(k, *dims)


def fold_in(key, data: int):
    """``jax.random.fold_in`` of a threefry key (k0, k1) and a u32
    ``data``: the key's threefry2x32 of the counter (0, data), bit for
    bit. The words are int64 tensors, or Python ints (a host key, whose
    fold is ints too)."""
    dev = next((k.device for k in key if isinstance(k, torch.Tensor)), None)
    if dev is None:
        return threefry2x32(key[0], key[1], 0, data & _U32)
    x0 = torch.zeros((), dtype=torch.int64, device=dev)
    return threefry2x32(key[0], key[1], x0, x0 + (data & _U32))


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"), the
# polynomial jax.random.normal's values go through: w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` formulation in torch ops: w = -log1p(-x^2),
    Giles' degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x;
    x times the largest f32 at |x| = 1. Its log1p is torch's, not XLA's, so
    a value may differ from ``jax.lax.erf_inv`` in its last bits
    (``tests/test_torch_grad_nodes.py`` states the bound)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


# jax.random.normal draws uniform on (lo, 1), lo = nextafter(-1, 0), as
# lo + u * (1 - lo) in f32, and scales erf_inv by f32 sqrt(2)
_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_NORMAL_SPAN = float(np.float32(1.0) - _NORMAL_LO)
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal_bits(key, dims: List[int]) -> torch.Tensor:
    """``jax.random.normal(key, dims, float32)`` of a threefry key (k0,
    k1): the uniform floats of ``_unit_floats`` (JAX's bit for bit) scaled
    to (nextafter(-1, 0), 1) as ``jax.random.uniform`` scales them, then
    sqrt(2) times ``_erf_inv_f32``. Scalars only: nothing is uploaded."""
    dev = next(k.device for k in key if isinstance(k, torch.Tensor))
    u = _unit_floats(key[0], key[1], dims, dev)
    lo = float(_NORMAL_LO)
    u = (u * _NORMAL_SPAN + lo).clamp_min(lo)
    return _erf_inv_f32(u) * _SQRT2


# -- host draws: the rest of jax.random's samplers that the training
# augmentations use (data/augment.py), for small draws on the host. A host
# key is a pair of Python ints holding u32 words; the cipher is
# threefry2x32 above on ints or on numpy uint64 arrays (its adds, shifts
# and masks are the same there). Each sampler follows
# jax_threefry_partitionable (the default since JAX 0.5), as _unit_floats
# does: under it split's key i is the cipher of the counter (0, i), which
# is fold_in(key, i), and element i of a draw ciphers (i >> 32,
# i & 0xFFFFFFFF). Values come out as numpy arrays.


def prng_key(seed: int):
    """``jax.random.key(seed)``'s threefry words (0, seed) for a seed in
    [0, 2^32), as a host key."""
    return 0, seed & _U32


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` as a list of ``num`` host keys (one
    cipher on ints a key: faster than numpy at a handful)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _bits32(key, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)`` as uint64 values."""
    if n == 1:  # one cipher on ints: faster than numpy
        x0, x1 = threefry2x32(key[0], key[1], 0, 0)
        return np.array([x0 ^ x1], dtype=np.uint64)
    idx = np.arange(n, dtype=np.uint64)
    x0, x1 = threefry2x32(key[0], key[1], idx >> 32, idx & _U32)
    return x0 ^ x1


def uniform(key, dims: List[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, dims, float32, minval, maxval)``: the
    unit floats ((bits >> 9) 2^-23) times the f32 span plus the f32
    minval, floored at it. XLA fuses the multiply and the add (one
    rounding); here both run in f64, where they are exact (a unit float
    has 23 bits, the span 24), and the sum is rounded once to f32."""
    n = int(np.prod(dims))
    u = (_bits32(key, n) >> 9).astype(np.float64) * 2.0 ** -23
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = (u * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, fused).reshape(dims)


def randint(key, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32 values, as
    int64): JAX's two-draw algorithm, the higher and the lower 32 bits of
    two split keys folded into the span by the multiplier 2^32 mod span,
    every product and sum wrapped to u32 as JAX's unsigned arithmetic
    wraps."""
    k1, k2 = split(key)
    higher, lower = _bits32(k1, n), _bits32(k2, n)
    span = (maxval - minval) & _U32 if maxval > minval else 1
    m = 2 ** 16 % span
    mult = np.uint64(((m * m) & _U32) % span)
    span = np.uint64(span)
    off = (((higher % span) * mult) & _U32) + lower % span
    return minval + ((off & _U32) % span).astype(np.int64)


def bernoulli(key, p: float, dims: List[int]) -> np.ndarray:
    """``jax.random.bernoulli(key, p, dims)``: f32 uniform below f32 p."""
    return uniform(key, dims) < np.float32(p)


def _normal_scalar(key) -> np.float32:
    """``jax.random.normal(key, ())``: ``uniform`` on (nextafter(-1, 0),
    1), then sqrt(2) times the f32 erf_inv (``_erf_inv_f32``)."""
    u = torch.from_numpy(uniform(key, [1], float(_NORMAL_LO)))
    return np.float32((_erf_inv_f32(u) * _SQRT2)[0].item())


def _loggamma(key, alpha: float):
    """``jax.random.loggamma(key, alpha)`` of a scalar f32 alpha, and the
    number of trips its rejection loop took: JAX's Marsaglia-Tsang sampler
    (``_gamma_one`` with ``log_space``), its key first split to the shape of
    alpha (one key), then split for the loop and the boost; the loop draws
    a normal until v = 1 + x c > 0, then a uniform U, and stops once U <
    1 - 0.0331 X^2 or log U < X / 2 + d (1 - V + log V); alpha < 1 is
    boosted to alpha + 1 and corrected by -Exponential / alpha. Every
    operation in f32, in JAX's order."""
    f32 = np.float32
    (key,) = split(key, 1)
    one, a = f32(1.0), f32(alpha)
    third = f32(1.0 / 3.0)
    boost = bool(a >= one)
    a_b = a if boost else a + one
    d = a_b - third
    c = third / np.sqrt(d)
    key, subkey = split(key)
    big_x, big_v, big_u = f32(0.0), one, f32(2.0)
    trips = 0
    while ((big_u >= one - f32(0.0331) * (big_x * big_x))
           and (np.log(big_u) >= big_x * f32(0.5)
                + d * ((one - big_v) + np.log(big_v)))):
        key, x_key, u_key = split(key, 3)
        v = f32(-1.0)
        while v <= 0:
            x_key, sub = split(x_key)
            x = _normal_scalar(sub)
            v = one + x * c
        big_x, big_v = x * x, (v * v) * v
        big_u = uniform(u_key, [1])[0]
        trips += 1
    # -Exponential = -(-log1p(-u))
    log_samples = np.log1p(-uniform(subkey, [1])[0])
    if boost or log_samples == 0:
        log_boost = f32(0.0)
    else:
        log_boost = log_samples * (one / a)
    return (np.log(d) + np.log(big_v)) + log_boost, trips


def beta(key, a: float, b: float, trips: Optional[list] = None
         ) -> np.float32:
    """``jax.random.beta(key, a, b)`` (an f32 scalar): two log-space
    gammas of split keys, exp of each minus their max, a over the sum.
    ``trips``: a list that receives the two rejection loops' trip
    counts."""
    key_a, key_b = split(key)
    la, ta = _loggamma(key_a, a)
    lb, tb = _loggamma(key_b, b)
    if trips is not None:
        trips.extend((ta, tb))
    m = max(la, lb)
    ga, gb = np.exp(la - m), np.exp(lb - m)
    return np.float32(ga / (ga + gb))


class NoiseNode(NodeKind):
    """Uniform [0, 1) tensor, the values of ``jax.random.uniform`` keyed by
    the ``seed`` param, bit for bit (``uniform_bits``). The seed is a
    dynamic param, masked to u32 and delivered as a 0-d int64 capture on
    the device: re-randomizing replays the cached program (a ``dims``
    change stages a new one), and a stacked run keys each row by its own
    seed. No ``torch.Generator`` is involved."""

    def __init__(self) -> None:
        super().__init__("noise")

    def contents(self, params):
        dims = _jparam(params, "dims", [1])
        seed = int(float(params.get("seed", 0)))
        return (f"<p>uniform[0,1) noise</p>"
                f"{_dims_input(dims)} "
                f"{_num_input('seed', seed, step='1')}")

    def io(self, params):
        return {"ins": [], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"seed"})

    def captures(self, params):
        # mask into u32 range: the UI's number input reaches -1 with one
        # down-click
        seed = int(float(params.get("seed", 0))) & _U32
        return {"seed": torch.tensor(seed, dtype=torch.int64)}

    def fn(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [1])]
        return lambda ins, caps: {"o": uniform_bits(caps["seed"], dims)}


class Conv2dNode(NodeKind):
    """Single-channel 2-D convolution (cross-correlation), valid padding.

    Input [C,H,W] or [H,W]; each channel convolved with the same k x k
    matrix; output spatial dims shrink by k - 1. The matrix travels
    base64-encoded f32 and is a dynamic param (a capture of shape (h, w),
    which stay in the signature). The input must be f32, as the JAX kind's
    (``lax.conv_general_dilated`` refuses a bf16 input against the f32
    matrix).

    Written as k*k shifted multiply-adds in f32 (``torch.addcmul``), not as
    a cuDNN convolution: exact f32 products whatever
    ``torch.backends.cudnn.allow_tf32`` says (the JAX kind is HIGHEST
    precision for f32), and no library state in a captured pass.
    """

    def __init__(self) -> None:
        super().__init__("conv2d")

    def contents(self, params):
        m = self._matrix(params)
        h, w = m.shape
        rows = "".join(
            "<tr>" + "".join(
                f"<td><input data-cell=\"{i},{j}\" type=\"number\" "
                f"step=\"any\" value=\"{m[i, j]:g}\"></td>"
                for j in range(w)
            ) + "</tr>"
            for i in range(h)
        )
        return (f"<p>conv2d {h}&times;{w} (valid)</p>"
                f"{_num_input('h', h, step='1')} "
                f"{_num_input('w', w, step='1')}"
                f"<table data-matrix data-h=\"{h}\" data-w=\"{w}\">"
                f"{rows}</table>")

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def _matrix(self, params) -> np.ndarray:
        h = int(float(params.get("h", 3)))
        w = int(float(params.get("w", 3)))
        if "matrix" in params:
            raw = base64.b64decode(params["matrix"])
            m = np.frombuffer(raw, dtype="<f4").reshape(h, w).copy()
        else:
            m = np.zeros((h, w), dtype=np.float32)
            m[h // 2, w // 2] = 1.0
        return m

    def dynamic_params(self):
        # a matrix edit (drag a cell) replays the cached program; an h / w
        # change (a shape) stages a new one
        return frozenset({"matrix"})

    def captures(self, params):
        return {"m": torch.from_numpy(self._matrix(params))}

    def fn(self, params):
        def run(ins, caps):
            m = caps["m"]
            x = ins["o"]
            if x.dtype != torch.float32:
                raise TypeError(
                    f"conv2d takes a float32 input (its matrix is float32; "
                    f"the kind does not promote), got "
                    f"{str(x.dtype).removeprefix('torch.')}")
            if x.ndim not in (2, 3):
                raise ValueError(f"conv2d takes [C,H,W] or [H,W], got "
                                 f"shape {tuple(x.shape)}")
            kh, kw = m.shape
            oh, ow = x.shape[-2] - kh + 1, x.shape[-1] - kw + 1
            if oh < 1 or ow < 1:
                raise ValueError(f"a {kh}x{kw} matrix does not fit in "
                                 f"{tuple(x.shape[-2:])}")
            acc = x[..., :oh, :ow] * m[0, 0]
            for i in range(kh):
                for j in range(kw):
                    if i or j:
                        acc = torch.addcmul(acc, x[..., i:i + oh, j:j + ow],
                                            m[i, j])
            return {"o": acc}

        return run


class ResizeNode(NodeKind):
    """Bilinear resize of the trailing two dims to dims=[H, W], whatever
    the rank (CHW, and the [B,C,H,W] maps of pca_view / patch_sim).

    ``jax.image.resize(..., "bilinear")`` antialiases when it shrinks: a
    triangle kernel widened by the scale, half-pixel centres, weights
    renormalized at the edges. ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=True)`` is that filter. A non-f32 input
    (bf16) is resized in f32 and rounded once to its dtype; the JAX kind
    computes in the input's dtype."""

    def __init__(self) -> None:
        super().__init__("resize")

    def contents(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [224, 224])]
        return f"<p>bilinear resize</p>{_dims_input(dims)}"

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        dims = [int(d) for d in _jparam(params, "dims", [224, 224])]

        def run(ins):
            x = ins["o"]
            planes = x.reshape(-1, 1, *x.shape[-2:]).to(torch.float32)
            y = F.interpolate(planes, size=(dims[0], dims[1]),
                              mode="bilinear", align_corners=False,
                              antialias=True)
            return {"o": y.reshape(*x.shape[:-2], dims[0], dims[1])
                    .to(x.dtype)}

        return run


def _token_grid(x, skip: int):
    """[B,N,D] (or [N,D]) tokens -> (patch tokens [B,P,D] in f32, side g).

    Drops the first ``skip`` tokens (CLS) and requires the rest to tile a
    square patch grid. Channels-last spatial features [B,H,W,C] (Swin stage
    outputs) flatten to their H*W tokens (no CLS, so ``skip`` does not
    apply). The shape checks run on shapes alone, before any device work.
    """
    if x.ndim == 2:
        x = x[None]
    if x.ndim == 4:
        b, h, w, c = x.shape
        if h != w or h < 2:
            raise ValueError(
                f"spatial features must be square [B,H,W,C], got "
                f"{tuple(x.shape)}"
            )
        return x.reshape(b, h * w, c).to(torch.float32), h
    if x.ndim != 3:
        raise ValueError(
            f"expected token sequence [B,N,D] or [N,D], got shape "
            f"{tuple(x.shape)}"
        )
    if not 0 <= skip < x.shape[1]:
        raise ValueError(
            f"skip={skip} out of range for {x.shape[1]} tokens"
        )
    p = x.shape[1] - skip
    g = int(round(p ** 0.5))
    if g * g != p or g < 2:
        raise ValueError(
            f"{p} patch tokens (after skipping {skip}) do not tile a "
            f"square grid — wire a ViT token sequence ('o' of a block or "
            f"norm node)"
        )
    return x[:, skip:].to(torch.float32), g


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    """``v`` over max(its L2 norm along the last dim, eps)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        eps)


def _pca_top3(cov: torch.Tensor, iters: int = 96, k: int = 6) -> torch.Tensor:
    """Top-3 eigenvectors of the batched SPD ``cov`` [B,D,D], PC1 first.

    The JAX kind's formulation exactly: simultaneous (subspace) iteration
    from the start basis q0[i, j] = cos(i (j+1) 0.573 + j) (k = 6
    columns), modified Gram-Schmidt after every one of the ``iters`` power
    steps, columns 0..2 of the result. Only matmuls and elementwise ops: no
    ``torch.linalg.eigh`` or ``qr``, which check their info on the host on
    CUDA (a capture refuses that) and choose other signs. Deferring the
    orthonormalization would amplify the eigen-spread past f32's range; the
    extra columns absorb slow convergence and eigenvalue clusters. About
    65 small launches a step, some 6,300 a view: the loop runs on the host,
    and a captured program replays every launch."""
    bsz, d, _ = cov.shape
    i = torch.arange(d, dtype=torch.float32, device=cov.device)[:, None]
    j = torch.arange(k, dtype=torch.float32, device=cov.device)[None, :]
    q0 = torch.cos(i * (j + 1.0) * 0.573 + j)  # [D,k], incoherent columns
    q = q0[None].expand(bsz, d, k).to(cov.dtype)

    def orthonormalize(q):
        cols = []
        for c in range(k):
            v = q[..., c]
            for u in cols:
                # v - u (u . v), the product and the difference one launch
                v = torch.addcmul(v, u, (u * v).sum(-1, keepdim=True),
                                  value=-1.0)
            v = _unit(v, 1e-12)
            cols.append(v)
        return torch.stack(cols, dim=-1)

    q = orthonormalize(q)
    for _ in range(iters):
        q = orthonormalize(torch.matmul(cov, q))
    return q[..., :3]


class PcaViewNode(NodeKind):
    """Patch-token PCA -> RGB image: the DINO / DINOv2 dense-feature view.

    Every patch token is projected onto the top-3 principal components of
    the image's own token cloud (``_pca_top3``), each component min-max
    scaled to [0, 1]. Input "o": tokens [B,N,D] (or [N,D]) from any block
    or norm node, or channels-last spatial features [B,H,W,C]. Output "o":
    [B,3,g,g] f32, viewable in ``img_view`` and resizable with ``resize``.
    Computed in f32 whatever the input's dtype."""

    def __init__(self) -> None:
        super().__init__("pca_view")

    def contents(self, params):
        skip = int(float(params.get("skip", 1)))
        return ("<p>patch-PCA &rarr; RGB (DINO-style)</p>"
                + _num_input("skip", skip, step="1",
                             title="tokens to skip (CLS)"))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def fn(self, params):
        skip = int(float(params.get("skip", 1)))

        def run(ins):
            t, g = _token_grid(ins["o"], skip)
            b, p, _ = t.shape
            t = t - t.mean(dim=1, keepdim=True)
            cov = torch.matmul(t.transpose(1, 2), t) / p
            top3 = _pca_top3(cov)  # [B,D,3], PC1 first
            proj = torch.matmul(t, top3)
            lo = proj.amin(dim=1, keepdim=True)
            hi = proj.amax(dim=1, keepdim=True)
            img = (proj - lo) / (hi - lo).clamp_min(1e-8)
            return {"o": img.transpose(1, 2).reshape(b, 3, g, g)}

        return run


class PatchSimNode(NodeKind):
    """Cosine similarity of one query token against every patch ->
    heatmap.

    Input "o": tokens [B,N,D], or channels-last spatial features [B,H,W,C]
    (no CLS; a negative row / col then falls back to patch (0, 0)).
    ``row`` / ``col`` select the query patch on the g x g grid, clamped to
    it; either negative (the default) queries token 0 (the CLS token when
    ``skip`` >= 1). They are dynamic params: 0-d int32 captures, clamped
    and gathered on the device (``index_select`` with a device index,
    ``torch.where`` for the token-0 fallback), so scrubbing the query
    replays the cached program; ``skip`` changes shapes and stages anew.
    Output "o": [B,3,g,g] f32, the similarity mapped from [-1, 1] to
    [0, 1] and repeated on 3 channels."""

    def __init__(self) -> None:
        super().__init__("patch_sim")

    def contents(self, params):
        row = int(float(params.get("row", -1)))
        col = int(float(params.get("col", -1)))
        skip = int(float(params.get("skip", 1)))
        return ("<p>token cosine-similarity heatmap</p>"
                + _num_input("row", row, step="1",
                             title="query row (-1 = token 0/CLS)")
                + " " + _num_input("col", col, step="1",
                                   title="query col (-1 = token 0/CLS)")
                + " " + _num_input("skip", skip, step="1",
                                   title="tokens to skip (CLS)"))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"row", "col"})

    def captures(self, params):
        return {"row": torch.tensor(int(float(params.get("row", -1))),
                                    dtype=torch.int32),
                "col": torch.tensor(int(float(params.get("col", -1))),
                                    dtype=torch.int32)}

    def fn(self, params):
        skip = int(float(params.get("skip", 1)))

        def run(ins, caps):
            x = ins["o"]
            if x.ndim == 2:
                x = x[None]
            if x.ndim == 4:
                # spatial features: no CLS token; "token 0" is patch (0, 0)
                t, g = _token_grid(x, 0)
                x = t
            else:
                t, g = _token_grid(x, skip)
            b = t.shape[0]
            row, col = caps["row"], caps["col"]
            idx = (row.clamp(0, g - 1) * g + col.clamp(0, g - 1)).long()
            q_patch = torch.index_select(t, 1, idx.reshape(1))[:, 0]
            q_tok0 = x[:, 0].to(torch.float32)
            use_tok0 = torch.logical_or(row < 0, col < 0)
            q = torch.where(use_tok0, q_tok0, q_patch)
            qn = _unit(q, 1e-8)
            tn = _unit(t, 1e-8)
            # a product and a sum over D, not a matvec: a stacked run
            # (vmap) then reduces each row in the same order as one run
            sim = (tn * qn[:, None, :]).sum(-1)
            img = ((sim + 1.0) * 0.5).reshape(b, 1, g, g)
            return {"o": img.expand(b, 3, g, g)}

        return run


class SimilarityNode(NodeKind):
    """Scaled cosine-similarity logits between two embedding sets: ``a``
    [B, D] (or [D]) against ``b`` [P, D] -> ``o`` [B, P] (squeezed to [P]
    for a 1-D ``a``). Both sides are L2-normalized in their own dtype (a
    zero embedding gives zero similarity, not NaN), the products are summed
    in f32 and scaled by ``scale`` (dynamic, default 100), and the logits
    take ``a``'s dtype."""

    def __init__(self) -> None:
        super().__init__("similarity")

    def contents(self, params):
        scale = float(params.get("scale", 100.0))
        return (f"<p>zero-shot similarity<br>"
                f"scale &middot; (a&#775; &middot; b&#775;&#7488;)</p>"
                f"{_num_input('scale', scale)}")

    def io(self, params):
        return {"ins": ["a", "b"], "outs": ["o"]}

    def dynamic_params(self):
        return frozenset({"scale"})

    def captures(self, params):
        return {"scale": torch.tensor(float(params.get("scale", 100.0)),
                                      dtype=torch.float32)}

    def fn(self, params):
        def run(ins, caps):
            a, b = ins["a"], ins["b"]
            squeeze = a.ndim == 1
            if squeeze:
                a = a[None]
            a = _unit(a, 1e-12)
            b = _unit(b, 1e-12)
            # a product and a sum over D (in f32), not a matmul: a stacked
            # run (vmap) then reduces each logit in the same order as one
            logits = (a.to(torch.float32)[:, None, :]
                      * b.to(torch.float32)[None, :, :]).sum(-1)
            logits = (logits * caps["scale"].to(torch.float32)).to(
                ins["a"].dtype)
            return {"o": logits[0] if squeeze else logits}

        return run


def grad_of(scalar, x: torch.Tensor) -> torch.Tensor:
    """d scalar(x) / d x, in x's dtype (``jax.grad(scalar)(x)``). The leaf
    alone is differentiated (``inputs=``): served weights keep
    ``requires_grad=False``. Where ``x`` already carries a graph (the node
    sits inside an outer differentiated replay) the gradient keeps its own
    graph, so the outer one differentiates through it."""
    nested = x.requires_grad
    with torch.enable_grad():
        xv = x if nested else x.detach().requires_grad_()
        (g,) = torch.autograd.grad(scalar(xv), xv, create_graph=nested)
    return g


def take_class(y: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """``jnp.take(y, clip(cls, 0, K - 1), axis=-1)`` with the 0-d class
    tensor on the device (no read-back)."""
    c = cls.clamp(0, y.shape[-1] - 1).reshape(1).long()
    return torch.index_select(y, -1, c).squeeze(-1)


class _GradNode(NodeKind):
    """Shared base of the gradient kinds (saliency, dream, occlusion): the
    wrt-leaf spec, the target check, the scalar objective and the HTML.

    The executor contract (``graph/executor._grad_specs``): a
    ``grad_node`` kind gets its ancestor cone as a closed ``forward`` and
    implements ``grad_fn(params) -> run(forward, x, caps)``."""

    grad_node = True
    autograd = True
    TARGETS = ("max", "sum", "class")

    def grad_wrt(self, params):
        """("input", k) or ("node", idx, channel)."""
        w = str(params.get("wrt", "0"))
        if w.startswith("node:"):
            parts = w.split(":")
            if len(parts) == 2:
                return ("node", int(parts[1]), "o")
            if len(parts) == 3:
                return ("node", int(parts[1]), parts[2])
            raise ValueError(f"bad wrt spec {w!r} (node:<i> or "
                             f"node:<i>:<ch>)")
        return ("input", int(float(w)))

    def _check_target(self, target: str) -> str:
        if target not in self.TARGETS:
            raise ValueError(f"target must be one of {self.TARGETS}, "
                             f"got {target!r}")
        return target

    @staticmethod
    def _scalar_fn(forward, target, caps):
        """The differentiated objective: the wired tensor reduced to one
        scalar (per sample, summed over the batch: samples independent)."""

        def scalar(xv):
            y = forward(xv).to(torch.float32)
            if target == "class":
                y = take_class(y, caps["class"])
            elif target == "max":
                y = y.amax(dim=-1)
            return y.sum()

        return scalar

    @staticmethod
    def _sel_html(name, options, cur):
        opts = "".join(
            f"<option value=\"{o}\"{' selected' if o == cur else ''}>"
            f"{o}</option>" for o in options)
        return (f"<label>{html.escape(name)} <select data-param="
                f"\"{html.escape(name)}\">{opts}</select></label>")

    @staticmethod
    def _wrt_html(params):
        wrt = html.escape(str(params.get("wrt", "0")))
        return ("<label>wrt <input data-param=\"wrt\" type=\"text\" "
                f"value=\"{wrt}\" size=\"9\" "
                "title=\"input index, or node:&lt;i&gt;[:&lt;ch&gt;] "
                "for an upstream activation\"></label>")

    @staticmethod
    def _class_cap(params):
        return torch.tensor(np.int32(int(float(params.get("class", 0)))))

    def fn(self, params):
        self._decode(params)  # param errors first, with node attribution
        raise NotImplementedError(
            f"{self.name} re-evaluates the WHOLE upstream graph -- it has "
            f"no per-node function; evaluate via the staged executor")

    def compute(self, params, inputs):
        self.fn(params)


class SaliencyNode(_GradNode):
    """Input-gradient saliency: d(scalar of the wired tensor)/d(leaf).

    Wiring: input "o" is any tensor downstream of the leaf, typically the
    classifier logits. Outputs: "o", the leaf-shaped normalized heatmap
    (``_heat``); "g", the raw attribution in f32 (an extra channel).

    Params (the JAX kind's): ``target`` max | sum | class; ``class``
    (dynamic); ``mode`` grad | gradxinput | ig (integrated gradients on
    the zero-baseline path) | smooth (SmoothGrad); ``steps`` (16, the
    IG / SmoothGrad count); ``sigma`` (0.15, dynamic) and ``seed`` (0,
    dynamic), SmoothGrad's noise scale relative to the input range and
    its key, drawn as ``jax.random.normal(fold_in(key(seed), i))``
    (``normal_bits``); ``wrt`` "0" | "node:<i>" | "node:<i>:<ch>" (a
    graph input, or an upstream node's output: the Grad-CAM case, whose
    token-shaped attribution renders on the patch grid, ``_token_cam``);
    ``skip`` (1), the leading tokens the grid render drops."""

    MODES = ("grad", "gradxinput", "ig", "smooth")

    def __init__(self) -> None:
        super().__init__("saliency")

    def contents(self, params):
        target = params.get("target", "max")
        mode = params.get("mode", "grad")
        sel = self._sel_html
        return ("<p>input-gradient saliency</p>"
                + sel("target", self.TARGETS, target) + " "
                + _num_input("class", int(float(params.get("class", 0))),
                             step="1", title="class (target=class)")
                + "<br>" + sel("mode", self.MODES, mode) + " "
                + _num_input("steps", int(float(params.get("steps", 16))),
                             step="1", title="IG / SmoothGrad steps")
                + " " + _num_input(
                    "sigma", float(params.get("sigma", 0.15)),
                    title="smooth noise (rel. to input range)")
                + "<br>" + self._wrt_html(params) + " "
                + _num_input("skip", int(float(params.get("skip", 1))),
                             step="1", title="CLS tokens to skip"))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "g"]}

    def extra_outs(self, params):
        return ["g"]

    def dynamic_params(self):
        return frozenset({"class", "sigma", "seed"})

    def captures(self, params):
        # the seed as JAX takes it (an int32, viewed as u32 by its key)
        seed = int(np.int32(int(float(params.get("seed", 0))))) & _U32
        return {"class": self._class_cap(params),
                "sigma": torch.tensor(np.float32(
                    float(params.get("sigma", 0.15)))),
                "seed": torch.tensor(seed, dtype=torch.int64)}

    def _decode(self, params):
        target = self._check_target(params.get("target", "max"))
        mode = params.get("mode", "grad")
        steps = int(float(params.get("steps", 16)))
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, "
                             f"got {mode!r}")
        if steps < 1:
            raise ValueError("steps must be >= 1")
        return target, mode, steps

    @staticmethod
    def _token_cam(attr, skip: int):
        """[B,N,D] token attribution -> [B,3,g,g] patch-grid heatmap: each
        token's L1 norm over D, per-sample max-normalized (the magnitude:
        a LayerNorm downstream makes the signed x . grad ~0)."""
        t, g = _token_grid(attr, skip)
        cam = t.abs().sum(dim=-1)
        cam = cam / cam.amax(dim=-1, keepdim=True).clamp_min(1e-12)
        return cam.reshape(cam.shape[0], 1, g, g).expand(
            cam.shape[0], 3, g, g)

    def _heat(self, attr, skip: int, node_wrt: bool = False):
        """The attribution rendered for img_view / overlay: a token stream
        whose N - skip tiles a square grid as a patch heatmap; a
        CHW-looking tensor |attr|, max over the channel axis, per-sample
        max-normalized, broadcast to 3 channels; anything else |attr|
        normalized in place (per sample at rank >= 3). ``node_wrt``: the
        leaf is an upstream node's output, batch-leading and never
        channel-planar."""
        if attr.ndim == 3:
            try:
                return self._token_cam(attr, skip)
            except ValueError:
                pass  # not a token grid: the image rules
        h = attr.abs()
        chw = (not node_wrt) and h.ndim >= 3 and h.shape[-3] in (1, 3)
        if chw:
            h = h.amax(dim=-3, keepdim=True)
        if h.ndim >= 3:
            m = h.amax(dim=tuple(range(1, h.ndim)), keepdim=True)
        else:
            m = h.amax()
        h = h / m.clamp_min(1e-12)
        if chw:
            h = h.expand(*h.shape[:-3], 3, *h.shape[-2:])
        return h

    def grad_fn(self, params):
        target, mode, steps = self._decode(params)
        skip = int(float(params.get("skip", 1)))
        node_wrt = self.grad_wrt(params)[0] == "node"

        def run(forward, x, caps):
            scalar = self._scalar_fn(forward, target, caps)
            xf = x.to(torch.float32)
            if mode == "ig":
                alphas = (torch.arange(steps, dtype=torch.float32,
                                       device=x.device) + 1.0) / steps
                tot = torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
                for i in range(steps):
                    g = grad_of(scalar, (xf * alphas[i]).to(x.dtype))
                    tot = tot + g.to(torch.float32)
                attr = (tot / steps) * xf
            elif mode == "smooth":
                # a per-sample input range where the batch axis is known
                # (node-wrt leaves, rank >= 4 inputs); a rank <= 3 graph
                # input is one unbatched image
                if node_wrt or xf.ndim >= 4:
                    axes = tuple(range(1, xf.ndim))
                    rng_ = (xf.amax(dim=axes, keepdim=True)
                            - xf.amin(dim=axes, keepdim=True))
                else:
                    rng_ = xf.amax() - xf.amin()
                scale = caps["sigma"].to(torch.float32) * rng_
                key = (0, caps["seed"])
                tot = torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
                for i in range(steps):
                    eps = normal_bits(fold_in(key, i), list(x.shape))
                    g = grad_of(scalar, (xf + scale * eps).to(x.dtype))
                    tot = tot + g.to(torch.float32)
                attr = tot / steps
            else:
                g = grad_of(scalar, x).to(torch.float32)
                attr = g * xf if mode == "gradxinput" else g
            return {"o": self._heat(attr, skip, node_wrt).to(x.dtype),
                    "g": attr}

        return run


class DreamNode(_GradNode):
    """Feature visualization by normalized gradient ascent on the leaf
    (default: the image), maximizing the scalar target of the wired
    tensor: ``steps`` ascent steps (static), each of ``lr`` (dynamic) input
    units along g / rms(g), clipped to [``clip_lo``, ``clip_hi``] (default
    0..1; "none" leaves a side open). Outputs: "o" the optimized leaf,
    "delta" (extra) the optimized minus the original in f32. ``target`` /
    ``class`` / ``wrt`` as saliency."""

    def __init__(self) -> None:
        super().__init__("dream")

    def contents(self, params):
        target = params.get("target", "class")
        return ("<p>gradient-ascent feature visualization</p>"
                + self._sel_html("target", self.TARGETS, target) + " "
                + _num_input("class", int(float(params.get("class", 0))),
                             step="1", title="class (target=class)")
                + "<br>" + _num_input(
                    "steps", int(float(params.get("steps", 32))),
                    step="1", title="ascent steps")
                + " " + _num_input("lr", float(params.get("lr", 0.05)),
                                   title="step size")
                + "<br>" + self._wrt_html(params))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "delta"]}

    def extra_outs(self, params):
        return ["delta"]

    def dynamic_params(self):
        return frozenset({"class", "lr"})

    def captures(self, params):
        return {"class": self._class_cap(params),
                "lr": torch.tensor(np.float32(float(params.get("lr",
                                                               0.05))))}

    def _decode(self, params):
        target = self._check_target(params.get("target", "class"))
        steps = int(float(params.get("steps", 32)))
        if steps < 1:
            raise ValueError("steps must be >= 1")

        def clip_of(key, default):
            v = str(params.get(key, default))
            return None if v == "none" else float(v)

        return target, steps, clip_of("clip_lo", "0"), clip_of("clip_hi", "1")

    def grad_fn(self, params):
        target, steps, clip_lo, clip_hi = self._decode(params)

        def run(forward, x, caps):
            scalar = self._scalar_fn(forward, target, caps)
            lr = caps["lr"].to(torch.float32)
            xv = x
            for _ in range(steps):
                g = grad_of(scalar, xv).to(torch.float32)
                norm = g.square().mean().sqrt() + 1e-12
                nxt = xv.to(torch.float32) + lr * g / norm
                if clip_lo is not None or clip_hi is not None:
                    nxt = nxt.clamp(clip_lo, clip_hi)
                xv = nxt.to(xv.dtype)
            return {"o": xv,
                    "delta": xv.to(torch.float32) - x.to(torch.float32)}

        return run


#: masked copies of the leaf that occlusion runs through its cone as one
#: batched pass (P = 169 positions at patch 32, stride 16 on a 224 image:
#: six passes)
OCCLUSION_CHUNK = 32


class OcclusionNode(_GradNode):
    """Occlusion sensitivity (Zeiler & Fergus): slide a ``patch`` x
    ``patch`` occluder of value ``fill`` (dynamic) over the image leaf at
    ``stride`` (default ``patch``; the last window of a row or column
    clamps to the edge), score each position with the wired scalar
    (``target`` / ``class`` as saliency, one score per leaf sample) and
    render the drop from the unoccluded score. Outputs: "o" the mean drop
    per pixel over the windows covering it, min-max normalized per sample
    and broadcast to 3 channels; "g" (extra) the raw signed drop grid
    ``[..., gh, gw]`` in f32.

    Forwards only (``differentiates = False``): the replay keeps each
    layer's kernel-backed ``fn``. The P masked leaves run through the cone
    ``OCCLUSION_CHUNK`` at a time as one batched pass
    (``forward.stacked``: each replayed node's ``stacked_fn``, as
    ``run_stacked`` folds a group)."""

    differentiates = False

    def __init__(self) -> None:
        super().__init__("occlusion")

    def contents(self, params):
        target = params.get("target", "max")
        return ("<p>occlusion sensitivity</p>"
                + self._sel_html("target", self.TARGETS, target) + " "
                + _num_input("class", int(float(params.get("class", 0))),
                             step="1", title="class (target=class)")
                + "<br>" + _num_input(
                    "patch", int(float(params.get("patch", 32))),
                    step="1", title="occluder size (px)")
                + " " + _num_input(
                    "stride",
                    int(float(params.get("stride",
                                         params.get("patch", 32)))),
                    step="1", title="slide step (px)")
                + " " + _num_input("fill", float(params.get("fill", 0.0)),
                                   title="occluder fill value")
                + "<br>" + self._wrt_html(params))

    def io(self, params):
        return {"ins": ["o"], "outs": ["o", "g"]}

    def extra_outs(self, params):
        return ["g"]

    def dynamic_params(self):
        return frozenset({"class", "fill"})

    def captures(self, params):
        return {"class": self._class_cap(params),
                "fill": torch.tensor(np.float32(float(params.get("fill",
                                                                 0.0))))}

    def _decode(self, params):
        target = self._check_target(params.get("target", "max"))
        patch = int(float(params.get("patch", 32)))
        stride = int(float(params.get("stride", patch)))
        if patch < 1:
            raise ValueError("patch must be >= 1")
        if stride < 1:
            raise ValueError("stride must be >= 1")
        return target, patch, stride

    def grad_fn(self, params):
        target, patch, stride = self._decode(params)

        def run(forward, x, caps):
            if x.ndim not in (3, 4) or x.shape[-3] not in (1, 3):
                raise ValueError(
                    "occlusion needs an image-shaped wrt leaf [C,H,W] or "
                    f"[B,C,H,W] with 1 or 3 channels; got {tuple(x.shape)}")
            H, W = int(x.shape[-2]), int(x.shape[-1])
            ph, pw = min(patch, H), min(patch, W)
            gh = 1 + -(-(H - ph) // stride)
            gw = 1 + -(-(W - pw) // stride)
            fill = caps["fill"].to(x.dtype)
            batched = x.ndim == 4
            B = int(x.shape[0]) if batched else None

            def reduce(y, lead):
                """Per-sample scores of a forward's output with ``lead``
                leading chunk axes: the target reduces the class axis,
                everything but the leaf's batch axis sums."""
                y = y.to(torch.float32)
                if target == "class":
                    y = take_class(y, caps["class"])
                elif target == "max":
                    y = y.amax(dim=-1)
                else:
                    y = y.sum(dim=-1)
                if batched and y.ndim > lead and y.shape[lead] == B:
                    rest = tuple(range(lead + 1, y.ndim))
                    return y.sum(dim=rest) if rest else y
                s = y.reshape(*y.shape[:lead], -1).sum(dim=-1)
                # a wired tensor with no matching batch axis: every
                # sample shares the score
                return s.unsqueeze(-1).expand(*s.shape, B) if batched else s

            base = reduce(forward(x), 0)
            rows = torch.arange(H, device=x.device)
            cols = torch.arange(W, device=x.device)
            n_pos = gh * gw
            canvas = torch.zeros((*base.shape, H * W), dtype=torch.float32,
                                 device=x.device)
            count = torch.zeros(H * W, dtype=torch.float32, device=x.device)
            drops = []
            for start in range(0, n_pos, OCCLUSION_CHUNK):
                p = torch.arange(start, min(start + OCCLUSION_CHUNK, n_pos),
                                 device=x.device)
                c = p.shape[0]
                py = ((p // gw) * stride).clamp_max(H - ph)[:, None, None]
                px = ((p % gw) * stride).clamp_max(W - pw)[:, None, None]
                m = ((rows[:, None] >= py) & (rows[:, None] < py + ph)
                     & (cols[None, :] >= px) & (cols[None, :] < px + pw))
                mb = m.reshape(c, *([1] * (x.ndim - 2)), H, W)
                d = base - reduce(forward.stacked(torch.where(mb, fill, x)),
                                  1)
                mf = m.reshape(c, H * W).to(torch.float32)
                canvas = canvas + torch.matmul(
                    d.reshape(c, -1).transpose(0, 1), mf).reshape(
                        canvas.shape)
                count = count + mf.sum(dim=0)
                drops.append(d)
            heat = (canvas / count.clamp_min(1.0)).reshape(*base.shape, H, W)
            hw = (base.ndim, base.ndim + 1)
            lo = heat.amin(dim=hw, keepdim=True)
            hi = heat.amax(dim=hw, keepdim=True)
            heat = (heat - lo) / (hi - lo).clamp_min(1e-12)
            heat = heat.unsqueeze(-3).expand(*base.shape, 3, H, W)
            g = torch.cat(drops).movedim(0, -1).reshape(*base.shape, gh, gw)
            return {"o": heat.to(x.dtype), "g": g}

        return run


class IdentityNode(NodeKind):
    """Pass-through for sources and sinks rendered client-side.

    ``optional=True``: viewer semantics, any subset of the declared inputs
    may be wired (the executor skips the missing-input check)."""

    def __init__(self, name: str, ins: List[str], outs: List[str],
                 optional: bool = False):
        super().__init__(name)
        self._ins = ins
        self._outs = outs
        if optional:
            self.optional_inputs = True

    def io(self, params):
        return {"ins": self._ins, "outs": self._outs}

    def fn(self, params):
        ins_names, outs_names = self._ins, self._outs

        def run(ins):
            if not outs_names:
                return {}
            if len(ins_names) == 1 and len(outs_names) == 1:
                return {outs_names[0]: ins[ins_names[0]]}
            return {ch: ins[ch] for ch in outs_names if ch in ins}

        return run


class ImgViewNode(NodeKind):
    """Viewer sink for R, G, B 2-D planes or an 'o' CHW image."""

    # viewers accept any subset of their inputs
    optional_inputs = True

    def __init__(self) -> None:
        super().__init__("img_view")

    def io(self, params):
        return {"ins": ["R", "G", "B", "o"], "outs": []}

    def fn(self, params):
        return lambda ins: {}


def instances():
    """The built-in kinds; ``register_builtin`` registers exactly these."""
    return [
        CosNode(),
        BinOpNode(),
        SliceNode(),
        ShuffleNode(),
        ConstNode(),
        NoiseNode(),
        Conv2dNode(),
        ResizeNode(),
        PcaViewNode(),
        PatchSimNode(),
        SimilarityNode(),
        SaliencyNode(),
        DreamNode(),
        OcclusionNode(),
        IdentityNode("img_src", ["o"], ["o"]),
        ImgViewNode(),
        IdentityNode("multi_view", ["o"], []),
        IdentityNode("category", ["o"], []),
        IdentityNode("attn_view", ["attn", "r"], [], optional=True),
        IdentityNode("overlay", ["o", "r"], [], optional=True),
    ]


def register_builtin(reg: Registry) -> None:
    """Register all built-in node kinds."""
    for kind in instances():
        kind.register(reg)
