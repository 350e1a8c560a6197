"""Training augmentations (flip / shift / color / cutout / mixup / cutmix)
on the batch's device.

The port of ``interactive_vit_tpu/data/augment.py``. Every random draw is
small (a bit per image, two offsets per image, three factors per image, a
box centre per image, one lambda and one switch per batch), so all of them
are drawn on the host, from ``fold_in(key(seed + 0x5EED), step)`` with the
port's threefry (``ops/node_ops.py``: ``split``, ``randint``,
``bernoulli``, ``uniform``, ``beta``), bit for bit the draws of
``jax.random`` under ``jax_threefry_partitionable``. They go to the device
as one small copy; the pixel work runs there as tensor ops. The choice
between mixup and cutmix is a Python branch on the host's draw (JAX's
``lax.cond``) and reads nothing back from the device. Augmentation is
deterministic per (seed, step), so a resumed run replays the stream.

Image layout is ``[B, 3, H, W]`` f32 (the trainer's batches; the draws are
those of ``jax.random`` for f32 images). Mixing ops return soft labels
``[B, C]``; ``parallel.train.cross_entropy`` takes int or soft labels.

- Per-image crops and cutout are index arithmetic on the whole batch: a
  gather for the crop, a box mask for cutout.
- Mixup and cutmix pair each image with the batch-reversed one (timm's
  "batch" mode).
- Cutmix's label weight is recomputed from the clipped box area (on the
  host, from the drawn box), so the labels match the pixels actually
  mixed.
- The per-image means of color jitter sum in f64 (then f32), so the card
  and the host give the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from interactive_vit_tpu_torch.ops import node_ops as rng


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Augmentation recipe; every field off (0/False) = identity.

    hflip: random horizontal flip per image (p=0.5).
    crop_pad: zero-pad each side by this many pixels, then take a random
        HxW crop (the CIFAR shift augmentation; 4 is the classic value).
    color_jitter: strength s -> per-image brightness/contrast/saturation
        factors drawn from U[1-s, 1+s] (applied in that fixed order;
        saturation interpolates with the channel-mean gray image).
    cutout: side (pixels) of a zero-filled square at a random position
        per image (random-erasing class; 0 = off).
    mixup_alpha: Beta(a, a) mixup over the batch-reversed pairing.
    cutmix_alpha: Beta(a, a) cutmix (box paste) over the same pairing.
    switch_prob: when BOTH mixup and cutmix are enabled, per-batch
        probability of choosing cutmix for this step.
    """

    hflip: bool = False
    crop_pad: int = 0
    color_jitter: float = 0.0
    cutout: int = 0
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    switch_prob: float = 0.5

    @property
    def enabled(self) -> bool:
        return bool(self.hflip or self.crop_pad or self.color_jitter
                    or self.cutout or self.mixup_alpha or self.cutmix_alpha)

    @property
    def mixes(self) -> bool:
        """Whether labels come out soft ([B, C])."""
        return bool(self.mixup_alpha or self.cutmix_alpha)


# -- the draws, on the host (numpy) -----------------------------------------


def draw_hflip(key, b: int) -> Dict[str, np.ndarray]:
    return {"flip": rng.bernoulli(key, 0.5, [b])}


def draw_shift_crop(key, b: int, pad: int) -> Dict[str, np.ndarray]:
    kh, kw = rng.split(key)
    return {"oy": rng.randint(kh, b, 0, 2 * pad + 1),
            "ox": rng.randint(kw, b, 0, 2 * pad + 1)}


def draw_color_jitter(key, b: int, s: float) -> Dict[str, np.ndarray]:
    kb, kc, ks = rng.split(key, 3)
    lo, hi = 1.0 - s, 1.0 + s
    return {"fb": rng.uniform(kb, [b], lo, hi),
            "fc": rng.uniform(kc, [b], lo, hi),
            "fs": rng.uniform(ks, [b], lo, hi)}


def draw_box(key, b: int, h: int, w: int, bh: int, bw: int
             ) -> Dict[str, np.ndarray]:
    """A box of ``bh x bw`` per image, its centre uniform over the image:
    the clipped corners ``y0, y1, x0, x1`` [B] (JAX's ``_box_mask``)."""
    kh, kw = rng.split(key)
    cy = rng.randint(kh, b, 0, h)
    cx = rng.randint(kw, b, 0, w)
    return {"y0": np.clip(cy - bh // 2, 0, h),
            "y1": np.clip(cy - bh // 2 + bh, 0, h),
            "x0": np.clip(cx - bw // 2, 0, w),
            "x1": np.clip(cx - bw // 2 + bw, 0, w)}


def draw_mixup(key, alpha: float) -> Dict[str, np.ndarray]:
    lam = rng.beta(key, alpha, alpha)
    # batch-reversed pairing; symmetric, so pin lam >= 0.5 to avoid the
    # degenerate "every image mostly its partner" half of the Beta
    return {"lam": np.array([max(lam, np.float32(1.0) - lam)], np.float32)}


def draw_cutmix(key, b: int, h: int, w: int, alpha: float
                ) -> Dict[str, np.ndarray]:
    kl, kb = rng.split(key)
    lam = rng.beta(kl, alpha, alpha)
    lam = max(lam, np.float32(1.0) - lam)
    ratio = np.sqrt(np.float32(1.0) - lam)          # box covers 1 - lam
    bh = int(ratio * np.float32(h))                 # int32 truncation
    bw = int(ratio * np.float32(w))
    box = draw_box(kb, b, h, w, bh, bw)
    # the label weight from the clipped box (it may hang off the edge):
    # per image, unlike the scalar lam; an f32 division on the host (the
    # card's divides by a scalar through its reciprocal)
    area = (box["y1"] - box["y0"]) * (box["x1"] - box["x0"])
    box["lam_adj"] = (np.float32(1.0) - area.astype(np.float32)
                      / np.float32(h * w))
    return box


def draw(key, cfg: AugmentConfig, b: int, h: int, w: int) -> Dict:
    """Every draw of ``augment(key, ...)`` for a ``[b, 3, h, w]`` batch:
    {name: numpy array}, and ``"mix"``: "mixup", "cutmix" or None."""
    k = dict(zip(("flip", "crop", "color", "cut", "mix", "switch"),
                 rng.split(key, 6)))
    out: Dict = {"mix": None}
    if cfg.hflip:
        out.update(draw_hflip(k["flip"], b))
    if cfg.crop_pad:
        out.update(draw_shift_crop(k["crop"], b, cfg.crop_pad))
    if cfg.color_jitter:
        out.update(draw_color_jitter(k["color"], b, cfg.color_jitter))
    if cfg.cutout:
        out.update({f"cut_{n}": v for n, v in draw_box(
            k["cut"], b, h, w, cfg.cutout, cfg.cutout).items()})
    if cfg.mixes:
        if cfg.mixup_alpha and cfg.cutmix_alpha:
            cutmix = bool(rng.bernoulli(k["switch"], cfg.switch_prob, []))
        else:
            cutmix = bool(cfg.cutmix_alpha)
        if cutmix:
            out["mix"] = "cutmix"
            out.update({f"mix_{n}": v for n, v in draw_cutmix(
                k["mix"], b, h, w, cfg.cutmix_alpha).items()})
        else:
            out["mix"] = "mixup"
            out.update(draw_mixup(k["mix"], cfg.mixup_alpha))
    return out


def to_device(draws: Dict, device) -> Dict:
    """The numeric draws on ``device`` in one copy: packed into one f64
    vector on the host (every draw is an f32, a small int or a bit, each
    exact in f64), copied, then sliced and cast back on the device."""
    names = [n for n, v in draws.items() if isinstance(v, np.ndarray)]
    out = {n: v for n, v in draws.items() if not isinstance(v, np.ndarray)}
    if not names:
        return out
    flat = torch.from_numpy(np.concatenate(
        [draws[n].astype(np.float64).reshape(-1) for n in names]))
    flat = flat.to(device)
    off = 0
    for n in names:
        v = draws[n]
        t = flat[off:off + v.size].reshape(v.shape)
        off += v.size
        if v.dtype == np.bool_:
            t = t != 0
        elif v.dtype == np.float32:
            t = t.to(torch.float32)
        else:
            t = t.to(torch.int64)
        out[n] = t
    return out


# -- the pixel work, on the batch's device ------------------------------------


def apply_hflip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], x.flip(-1), x)


def apply_shift_crop(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                     pad: int) -> torch.Tensor:
    """Output pixel (i, j) of image n reads the zero-padded image at
    (i + oy[n], j + ox[n]): two gathers over the spatial dims."""
    b, c, h, w = x.shape
    xp = F.pad(x, (pad, pad, pad, pad))
    rows = oy[:, None] + torch.arange(h, device=x.device)[None, :]  # [B, H]
    xp = xp.gather(2, rows[:, None, :, None].expand(b, c, h, w + 2 * pad))
    cols = ox[:, None] + torch.arange(w, device=x.device)[None, :]  # [B, W]
    return xp.gather(3, cols[:, None, None, :].expand(b, c, h, w))


def _mean(x: torch.Tensor, dims) -> torch.Tensor:
    return x.mean(dim=dims, keepdim=True, dtype=torch.float64).to(x.dtype)


def apply_color_jitter(x: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                       fs: torch.Tensor) -> torch.Tensor:
    fb, fc, fs = (f[:, None, None, None] for f in (fb, fc, fs))
    x = x * fb                                            # brightness
    mean = _mean(x, (1, 2, 3))
    x = (x - mean) * fc + mean                            # contrast
    gray = _mean(x, (1,))
    return (x - gray) * fs + gray                         # saturation


def box_mask(h: int, w: int, y0, y1, x0, x1):
    """[B, 1, H, W] bool, True inside each image's box, and the box's area
    [B] (int64)."""
    ys = torch.arange(h, device=y0.device)[None, :]
    xs = torch.arange(w, device=x0.device)[None, :]
    in_y = (ys >= y0[:, None]) & (ys < y1[:, None])       # [B, H]
    in_x = (xs >= x0[:, None]) & (xs < x1[:, None])       # [B, W]
    return in_y[:, None, :, None] & in_x[:, None, None, :], (y1 - y0) * (
        x1 - x0)


def apply_cutout(x: torch.Tensor, y0, y1, x0, x1) -> torch.Tensor:
    mask, _ = box_mask(x.shape[2], x.shape[3], y0, y1, x0, x1)
    return torch.where(mask, torch.zeros((), dtype=x.dtype,
                                         device=x.device), x)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    if labels.ndim == 2:
        return labels.to(torch.float32)
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def apply_mixup(x: torch.Tensor, y: torch.Tensor, lam: torch.Tensor):
    lam = lam.reshape(())
    xm = x * lam.to(x.dtype) + x.flip(0) * (1.0 - lam).to(x.dtype)
    ym = y * lam + y.flip(0) * (1.0 - lam)
    return xm, ym


def apply_cutmix(x: torch.Tensor, y: torch.Tensor, y0, y1, x0, x1,
                 lam_adj: torch.Tensor):
    mask, _ = box_mask(x.shape[2], x.shape[3], y0, y1, x0, x1)
    xm = torch.where(mask, x.flip(0), x)
    lam_adj = lam_adj[:, None]
    ym = y * lam_adj + y.flip(0) * (1.0 - lam_adj)
    return xm, ym


def apply(draws: Dict, cfg: AugmentConfig, images: torch.Tensor,
          labels: torch.Tensor, num_classes: int):
    """The pixel work of ``cfg`` given ``draws`` (``to_device``'s, on the
    batch's device), in JAX's order: flip, crop, color, cutout, mix."""
    d = draws
    if cfg.hflip:
        images = apply_hflip(images, d["flip"])
    if cfg.crop_pad:
        images = apply_shift_crop(images, d["oy"], d["ox"], cfg.crop_pad)
    if cfg.color_jitter:
        images = apply_color_jitter(images, d["fb"], d["fc"], d["fs"])
    if cfg.cutout:
        images = apply_cutout(images, d["cut_y0"], d["cut_y1"],
                              d["cut_x0"], d["cut_x1"])
    if d["mix"] == "cutmix":
        images, labels = apply_cutmix(
            images, one_hot(labels, num_classes), d["mix_y0"], d["mix_y1"],
            d["mix_x0"], d["mix_x1"], d["mix_lam_adj"])
    elif d["mix"] == "mixup":
        images, labels = apply_mixup(images, one_hot(labels, num_classes),
                                     d["lam"])
    return images, labels


def augment(key, images: torch.Tensor, labels: torch.Tensor,
            num_classes: int, cfg: AugmentConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ``cfg`` to one batch with the host key ``key``: the draws on
    the host, one copy of them to the batch's device, the pixel work
    there. Labels come back unchanged (int) when no mixing op is enabled,
    else soft ``[B, C]`` f32."""
    b, _, h, w = images.shape
    draws = to_device(draw(key, cfg, b, h, w), images.device)
    return apply(draws, cfg, images, labels, num_classes)


def make_augment_fn(cfg: AugmentConfig, num_classes: int, seed: int = 0,
                    device=None):
    """``(step, images, labels) -> (images, labels)`` on ``device`` (where
    given, the batch is moved there first), keyed by ``fold_in(key(seed +
    0x5EED), step)``: deterministic per (seed, step), so a resumed run
    replays the stream. None when ``cfg`` is all off, so callers skip the
    stage."""
    if not cfg.enabled:
        return None
    base = rng.prng_key(seed + 0x5EED)

    def fn(step: int, images: torch.Tensor, labels: torch.Tensor):
        if device is not None:
            images, labels = images.to(device), labels.to(device)
        return augment(rng.fold_in(base, step), images, labels,
                       num_classes, cfg)

    return fn
