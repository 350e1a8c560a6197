"""The port's augmentations (``data/augment.py``) and their host draws
(``ops/node_ops.py``: ``split``, ``randint``, ``bernoulli``, ``uniform``,
``beta``) against ``jax.random`` and the JAX package's
``data/augment.py``.

Bounds: the draws (keys, flips, crop offsets, box centres, jitter factors,
the mixup / cutmix switch) bit for bit over 60 (seed, step) pairs; the
Beta draws within ``LAMBDA_REL`` of ``jax.random.beta`` for alpha in {0.2,
0.8, 1.0} over 50 pairs, taking the same trips through the Marsaglia-Tsang
rejection loop (the JAX side's trips from that loop replayed with
``jax.random``'s own samplers), so cutmix's ``int(sqrt(1 - lam) * h)``
box sides are equal. Pixels: flips, crops, cutout and cutmix bit for bit;
color jitter and mixup, and the soft labels, within 1e-6 (the order of
the f32 sums and XLA's fused multiply-adds differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactive_vit_tpu.data import augment as JA
from interactive_vit_tpu_torch.data import augment as TA
from interactive_vit_tpu_torch.ops import node_ops as R

PAIRS = [(seed, step) for seed in range(6) for step in (0, 1, 7, 100, 4095,
                                                        2 ** 31 + 5,
                                                        12, 13, 14, 15)]


def _keys(seed, step):
    jk = jax.random.fold_in(jax.random.key(seed + 0x5EED), step)
    tk = R.fold_in(R.prng_key(seed + 0x5EED), step)
    return jk, tk


def _words(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_partitionable_threefry_is_what_the_draws_follow():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,step", PAIRS[:60])
def test_draws_bit_equal_jax(seed, step):
    jk, tk = _keys(seed, step)
    assert _words(jk) == tk
    js, ts = jax.random.split(jk, 6), R.split(tk, 6)
    assert [_words(k) for k in js] == ts
    for hi in (9, 32, 224):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(js[1], (64,), 0, hi)),
            R.randint(ts[1], 64, 0, hi))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(js[0], 0.5, (64,))),
        R.bernoulli(ts[0], 0.5, [64]))
    assert bool(jax.random.bernoulli(js[5], 0.5)) == bool(
        R.bernoulli(ts[5], 0.5, []))
    want = np.asarray(jax.random.uniform(js[2], (64, 1, 1, 1), jnp.float32,
                                         0.6, 1.4))
    assert want.tobytes() == R.uniform(ts[2], [64, 1, 1, 1], 0.6,
                                       1.4).tobytes()


def _jax_gamma_trips(key, alpha):
    """The trips of ``jax.random.loggamma``'s rejection loop for
    ``key``: JAX's ``_gamma_one`` loop (its split to the shape of alpha,
    then the loop's splits) replayed with ``jax.random``'s samplers."""
    f32 = jnp.float32
    (key,) = jax.random.split(key, 1)
    a = f32(alpha)
    a_b = a if alpha >= 1 else a + 1
    d = a_b - f32(1 / 3)
    c = f32(1 / 3) / jnp.sqrt(d)
    key, _ = jax.random.split(key)
    big_x, big_v, big_u = f32(0), f32(1), f32(2)
    trips = 0
    while bool((big_u >= 1 - f32(0.0331) * (big_x * big_x))
               & (jnp.log(big_u) >= big_x * f32(0.5)
                  + d * ((1 - big_v) + jnp.log(big_v)))):
        key, x_key, u_key = jax.random.split(key, 3)
        v = f32(-1)
        while bool(v <= 0):
            x_key, sub = jax.random.split(x_key)
            x = jax.random.normal(sub, ())
            v = 1 + x * c
        big_x, big_v = x * x, v * v * v
        big_u = jax.random.uniform(u_key, ())
        trips += 1
    return trips


# lambda = 1 / (1 + exp(lb - la)) of two f32 log-gammas, so its relative
# error is (1 - lambda) times the absolute error of la - lb: a few f32 ulps
# of log-gammas that reach |20| at alpha 0.2 (an ulp there is 1.9e-6), and
# XLA's log, log1p and exp are not correctly rounded (JAX's log-gammas sit
# up to ~11 ulps from the exact values of their own f32 inputs). So lambda
# is held to 1e-6 relative at alpha 0.8 and 1.0 and to 4e-6 at 0.2; the
# lambda the mixes use, max(lambda, 1 - lambda) in [0.5, 1], to 1e-6 at
# every alpha.
LAMBDA_REL = {0.2: 4e-6, 0.8: 1e-6, 1.0: 1e-6}


@pytest.mark.parametrize("alpha", [0.2, 0.8, 1.0])
def test_beta_within_bound_on_the_same_path(alpha):
    worst = worst_used = 0.0
    for seed, step in PAIRS[:50]:
        jk, tk = _keys(seed, step)
        want = float(jax.random.beta(jk, alpha, alpha, ()))
        trips = []
        got = float(R.beta(tk, alpha, alpha, trips))
        worst = max(worst, abs(got - want) / abs(want))
        used = max(want, 1 - want)
        worst_used = max(worst_used, abs(max(got, 1 - got) - used) / used)
        ka, kb = jax.random.split(jk)
        assert trips == [_jax_gamma_trips(ka, alpha),
                         _jax_gamma_trips(kb, alpha)], (seed, step)
    assert worst <= LAMBDA_REL[alpha], worst
    assert worst_used <= 1e-6, worst_used


def _cfg(name):
    return {"hflip": dict(hflip=True), "crop": dict(crop_pad=4),
            "color": dict(color_jitter=0.4), "cutout": dict(cutout=16),
            "mixup": dict(mixup_alpha=0.8), "cutmix": dict(cutmix_alpha=1.0),
            "all": dict(hflip=True, crop_pad=4, color_jitter=0.4, cutout=16,
                        mixup_alpha=0.8, cutmix_alpha=1.0)}[name]


# bit for bit where only values are moved; 1e-6 where f32 sums and
# products are formed in another order (XLA fuses multiply-adds)
BOUND = {"hflip": 0.0, "crop": 0.0, "cutout": 0.0, "cutmix": 0.0,
         "color": 1e-6, "mixup": 1e-6, "all": 1e-6}


@pytest.mark.parametrize("name", sorted(BOUND))
def test_augment_matches_jax(name):
    """Each of the six operations, and all together, on a [8, 3, 32, 32]
    batch through the port and through the JAX package at the same (seed,
    step), over 12 steps (so both branches of the switch run)."""
    rng = np.random.default_rng(1)
    x = rng.random((8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, 8)
    jcfg = JA.AugmentConfig(**_cfg(name))
    tcfg = TA.AugmentConfig(**_cfg(name))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jfn = JA.make_augment_fn(jcfg, 10, base_key=jax.random.key(3 + 0x5EED))
    tfn = TA.make_augment_fn(tcfg, 10, seed=3, device="cpu")
    mixes = set()
    for step in range(12):
        ji, jl = jfn(step, jnp.asarray(x), jnp.asarray(y))
        ti, tl = tfn(step, torch.from_numpy(x), torch.from_numpy(y))
        jl = np.asarray(jl)
        assert tl.shape == jl.shape and ti.dtype == torch.float32
        err = max(float(np.abs(np.asarray(ji) - ti.numpy()).max()),
                  float(np.abs(jl - tl.numpy()).max()))
        assert err <= BOUND[name], (step, err)
        if name == "all":
            _, _, h, w = x.shape
            key = R.fold_in(R.prng_key(3 + 0x5EED), step)
            mixes.add(TA.draw(key, tcfg, 8, h, w)["mix"])
    assert name != "all" or mixes == {"mixup", "cutmix"}


@pytest.mark.parametrize("seed,step", PAIRS[:12])
def test_box_draws_equal_jax_box_mask(seed, step):
    """The cutout box and cutmix's lambda-sized box: corners from the host
    draws give JAX's ``_box_mask`` mask and area exactly."""
    jk, tk = _keys(seed, step)
    want_mask, want_area = JA._box_mask(jk, 8, 32, 40, 16, 16)
    d = TA.draw_box(tk, 8, 32, 40, 16, 16)
    mask, area = TA.box_mask(32, 40, *(torch.from_numpy(d[k])
                                       for k in ("y0", "y1", "x0", "x1")))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(area.numpy(), np.asarray(want_area))
    # cutmix: the box sides from the same lambda
    kl, kb = jax.random.split(jk)
    lam = jax.random.beta(kl, 1.0, 1.0, ())
    lam = jnp.maximum(lam, 1.0 - lam)
    side = (jnp.sqrt(1.0 - lam) * 32).astype(jnp.int32)
    wm, _ = JA._box_mask(kb, 8, 32, 32, side, side)
    d = TA.draw_cutmix(tk, 8, 32, 32, 1.0)
    got, _ = TA.box_mask(32, 32, *(torch.from_numpy(d[k])
                                   for k in ("y0", "y1", "x0", "x1")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(wm))


def test_draws_go_to_the_device_in_one_copy(monkeypatch):
    """``to_device`` packs the numeric draws into one host vector: one
    ``Tensor.to`` call, whatever the recipe."""
    calls = []
    real = torch.Tensor.to

    def counting(self, *a, **k):
        calls.append(a)
        return real(self, *a, **k)

    key = R.fold_in(R.prng_key(9), 3)
    cfg = TA.AugmentConfig(**_cfg("all"))
    draws = TA.draw(key, cfg, 4, 16, 16)
    monkeypatch.setattr(torch.Tensor, "to", counting)
    dev = TA.to_device(draws, "cpu")
    assert len([c for c in calls if c and c[0] == "cpu"]) == 1
    for name, v in draws.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(dev[name].numpy(), v)


def test_off_recipe_gives_no_function():
    assert TA.make_augment_fn(TA.AugmentConfig(), 10) is None
    assert not TA.AugmentConfig().mixes
