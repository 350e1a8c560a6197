"""Masked autoencoder (MAE) on the ViT family, its serving part.

Counterpart of ``interactive_vit_tpu/models/mae.py`` (He et al. 2022):
the encoder is a plain ViT (``models/vit.py``, its tree under "enc", a
feature extractor with an empty head), the decoder a narrow ViT trunk
under "dec" (``embed``, ``mask_token``, ``pos_emb``, ``blocks``,
``norm``, ``pred``): the JAX package's layout, so a JAX tree converts by
``models/weights.from_jax`` and a native "/" file of the JAX package
serves here.

The mask is the JAX draw bit for bit: ``jax.random.uniform(jax.random.
key(seed), (B, L))`` is ``ops/node_ops.uniform_bits`` on the seed (a 0-d
int64 tensor on the device, so a seed edit replays a captured program),
and the two argsorts are stable, as ``jnp.argsort``. Pretraining draws
from a threefry key (k0, k1) folded on the host (``node_ops.fold_in``:
``key(seed + 0xAE)``, the step, a microbatch's index), through
``node_ops.uniform_key_bits``. Everything runs on the device and is
capturable into a CUDA graph; the blocks run ``vit.block``'s plain path
(no kernel of this package is on MAE's path). ``encode``, ``decode`` and
``forward_pretrain`` take the training hook ``block_wrapper``
(``parallel/train.remat_wrapper``); the pretraining step is
``parallel/train.make_mae_train_step``, its command line
``tools/pretrain.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.ops import layers as L
from interactive_vit_tpu_torch.ops.node_ops import (
    uniform_bits, uniform_key_bits,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    name: str
    encoder: str                # a plain-ViT variant name
    dec_width: int = 512
    dec_depth: int = 8
    dec_heads: int = 16
    mask_ratio: float = 0.75
    norm_pix: bool = True       # per-patch normalised targets
    # an encoder config given directly (the tests' narrow ones)
    enc_override: Optional[vit.ViTConfig] = None

    @property
    def enc_cfg(self) -> vit.ViTConfig:
        """The encoder's config: the named variant as a feature extractor.
        A plain ViT with one prefix token (CLS) only: the shuffle works on
        the patch tokens after it."""
        cfg = self.enc_override or vit.resolve_variant(self.encoder)
        if cfg.prefix_tokens != 1:
            raise ValueError(
                f"MAE encoder must be a plain ViT (one CLS prefix); "
                f"{self.encoder} has {cfg.prefix_tokens} prefix tokens")
        return dataclasses.replace(cfg, num_classes=0)

    @property
    def dec_cfg(self) -> vit.ViTConfig:
        """The decoder trunk as a ViTConfig, so that ``vit.block`` runs it."""
        e = self.enc_cfg
        return dataclasses.replace(
            e, name=self.name + ":dec", width=self.dec_width,
            depth=self.dec_depth, heads=self.dec_heads, num_classes=0)

    @property
    def grid(self) -> Tuple[int, int]:
        e = self.enc_cfg
        g = e.img_size // e.patch
        return g, g

    @property
    def num_patches(self) -> int:
        g, _ = self.grid
        return g * g

    def len_keep(self, mask_ratio: Optional[float] = None) -> int:
        """The visible-token count for a ratio (a shape: static)."""
        r = self.mask_ratio if mask_ratio is None else float(mask_ratio)
        if not 0.0 <= r < 1.0:
            raise ValueError(f"mask_ratio {r} must be in [0, 1)")
        keep = self.num_patches - int(round(self.num_patches * r))
        return max(1, keep)


VARIANTS: Dict[str, MAEConfig] = {
    "mae_t16": MAEConfig("mae_t16", "vit_t16", dec_width=128, dec_depth=4,
                         dec_heads=4),
    "mae_s16": MAEConfig("mae_s16", "vit_s16", dec_width=256, dec_depth=4,
                         dec_heads=8),
    "mae_b16": MAEConfig("mae_b16", "vit_b16", dec_width=512, dec_depth=8,
                         dec_heads=16),
}


def resolve_variant(name: str) -> MAEConfig:
    """``"mae_t16"`` or ``"mae_t16@<suffix>"`` (the encoder at the
    ``vit.resolve_variant`` geometry of that suffix)."""
    base, sep, suffix = name.partition("@")
    if base not in VARIANTS:
        raise ValueError(
            f"unknown MAE variant {base!r}; known: {sorted(VARIANTS)}")
    cfg = VARIANTS[base]
    if sep:
        cfg = dataclasses.replace(
            cfg, name=name, encoder=f"{cfg.encoder}@{suffix}")
        cfg.enc_cfg  # the suffix is checked here
    return cfg


def init_params(cfg: MAEConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """{"enc": ``vit.init_params(enc_cfg)``, "dec": {...}}, the JAX
    package's scales. Draws on the CPU from ``generator``."""
    e, d = cfg.enc_cfg, cfg.dec_cfg
    enc = vit.init_params(e, generator, dtype=dtype, device=device)
    trunk = vit.init_params(d, generator, dtype=dtype, device=device)
    patch_dim = e.in_chans * e.patch * e.patch

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(
            device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    dec = {
        "embed": {"w": normal((e.width, d.width), e.width ** -0.5),
                  "b": zeros(d.width)},
        "mask_token": zeros(1, 1, d.width),
        "pos_emb": normal((1, cfg.num_patches + 1, d.width), 0.02),
        "blocks": trunk["blocks"],
        "norm": trunk["norm"],
        "pred": {"w": normal((d.width, patch_dim), d.width ** -0.5),
                 "b": zeros(patch_dim)},
    }
    return {"enc": enc, "dec": dec}


def encoder_params(params: Params) -> Params:
    """The encoder as a plain-ViT tree (a feature extractor)."""
    return params["enc"]


def load_encoder_into(vit_params: Params, enc: Params,
                      cfg: Optional[vit.ViTConfig] = None) -> Params:
    """``vit_params`` with its trunk replaced by an MAE encoder's, its own
    head kept; with ``cfg``, adapted to that geometry
    (``vit.adapt_checkpoint``)."""
    out = dict(vit_params)
    for k in ("patch_embed", "cls_token", "pos_emb", "blocks", "norm"):
        out[k] = enc[k]
    if cfg is not None:
        out = vit.adapt_checkpoint(out, cfg)
    return out


# -- masking ------------------------------------------------------------------


def masking_from_noise(noise: torch.Tensor, len_keep: int):
    """``(ids_keep [B, K], mask [B, L] f32 (1 = masked), ids_restore [B,
    L])`` from per-patch noise [B, L]: the shuffle is the stable argsort of
    the noise, ``ids_restore`` its inverse (a patch's rank), and ``mask =
    ids_restore >= len_keep``. The ids are int64 (JAX's int32)."""
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = (ids_restore >= len_keep).float()
    return ids_keep, mask, ids_restore


def random_masking(seed, batch: int, length: int, len_keep: int,
                   device=None):
    """Per-image uniform random masking, the JAX function's draw bit for
    bit: ``seed`` a 0-d int64 tensor in [0, 2^32) on the device (the key
    ``jax.random.key(seed)``), or a threefry key (k0, k1) whose noise is
    made on ``device``."""
    return masking_from_noise(mask_noise(seed, batch, length, device),
                              len_keep)


def mask_noise(seed, batch: int, length: int, device=None) -> torch.Tensor:
    """The per-patch noise [batch, length] of ``random_masking``."""
    if isinstance(seed, tuple):
        return uniform_key_bits(seed, [batch, length], device)
    return uniform_bits(seed, [batch, length])


def _gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, ids[:, :, None], axis=1)`` on [B, L, D]."""
    return torch.gather(x, 1, ids.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


# -- forward ------------------------------------------------------------------


def _trunk(blocks, x: torch.Tensor, cfg: vit.ViTConfig,
           block_wrapper=None) -> torch.Tensor:
    """``vit.block``'s plain path over ``blocks``, each block one ``(p, x)
    -> y`` unit wrapped by ``block_wrapper`` when given."""
    def one(p, x):
        return vit.block(p, x, cfg)[0]

    if block_wrapper is not None:
        one = block_wrapper(one)
    for p in blocks:
        x = one(p, x)
    return x


def encode(params: Params, images: torch.Tensor, cfg: MAEConfig,
           ids_keep: Optional[torch.Tensor] = None,
           block_wrapper=None) -> torch.Tensor:
    """Patch-embed + position (the whole grid), the kept tokens gathered,
    the encoder trunk and its final norm: [B, C, H, W] -> [B, 1+K, D], CLS
    first. ``ids_keep=None`` keeps every token (the plain ViT features)."""
    e = cfg.enc_cfg
    enc = params["enc"]
    x = vit.embed(enc, images, e)
    if ids_keep is not None:
        x = torch.cat([x[:, :1], _gather_rows(x[:, 1:], ids_keep)], dim=1)
    x = _trunk(enc["blocks"], x, e, block_wrapper)
    return vit.final_norm(enc, x, e)


def decode(params: Params, x_enc: torch.Tensor, ids_restore: torch.Tensor,
           cfg: MAEConfig, block_wrapper=None) -> torch.Tensor:
    """The decoder: embed, the mask tokens put back at their grid positions
    (one gather), its position table, trunk and norm, the per-patch pixel
    prediction: [B, 1+K, D] -> [B, L, p*p*C]."""
    dec = params["dec"]
    d = cfg.dec_cfg
    x = L.linear(x_enc, dec["embed"]["w"], dec["embed"]["b"])
    b, n_vis, dd = x.shape
    length = ids_restore.shape[1]
    mask_tok = dec["mask_token"].to(x.dtype).expand(b, length - (n_vis - 1),
                                                    dd)
    # shuffled order (kept tokens, then mask tokens), restored to the grid
    x_ = _gather_rows(torch.cat([x[:, 1:], mask_tok], dim=1), ids_restore)
    x = torch.cat([x[:, :1], x_], dim=1) + dec["pos_emb"].to(x.dtype)
    x = _trunk(dec["blocks"], x, d, block_wrapper)
    x = L.layer_norm(x, dec["norm"]["s"], dec["norm"]["b"], d.ln_eps)
    return L.linear(x, dec["pred"]["w"], dec["pred"]["b"])[:, 1:]


def patch_targets(images: torch.Tensor, cfg: MAEConfig,
                  norm_pix: Optional[bool] = None):
    """Targets [B, L, p*p*C] in f32 and the per-patch (mean, rstd) of the
    normalisation (zeros and ones without ``norm_pix``)."""
    t = L.patchify(images, cfg.enc_cfg.patch).float()
    use_norm = cfg.norm_pix if norm_pix is None else norm_pix
    if not use_norm:
        z = torch.zeros(t.shape[:2] + (1,), device=t.device)
        return t, z, z + 1.0
    mean = t.mean(dim=-1, keepdim=True)
    var = (t - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + 1e-6)
    return (t - mean) * rstd, mean, rstd


def _act_dtype(params: Params) -> torch.dtype:
    return params["enc"]["patch_embed"]["w"].dtype


def forward_pretrain(params: Params, images: torch.Tensor, cfg: MAEConfig,
                     seed, mask_ratio: Optional[float] = None,
                     block_wrapper=None,
                     rows: Optional[Tuple[int, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """One masked-reconstruction pass: {"loss" (f32, the squared error over
    the masked patches), "pred" [B, L, p*p*C], "mask" [B, L]}, the mask
    drawn from ``seed`` (``random_masking``'s: a seed tensor or a threefry
    key). ``block_wrapper``: the training hook of both trunks. ``rows``:
    (first row, global batch) of a data-parallel rank's share: the noise is
    drawn for the global batch and the rank's rows of it kept, so each
    image is masked as in the one-device run."""
    keep = cfg.len_keep(mask_ratio)
    if keep >= cfg.num_patches:
        raise ValueError(
            f"mask_ratio leaves no masked patches to reconstruct "
            f"(len_keep {keep} of {cfg.num_patches})")
    images = images.to(_act_dtype(params))
    b = images.shape[0]
    lo, total = (0, b) if rows is None else rows
    noise = mask_noise(seed, total, cfg.num_patches, images.device)
    ids_keep, mask, ids_restore = masking_from_noise(noise[lo:lo + b], keep)
    z = encode(params, images, cfg, ids_keep, block_wrapper)
    pred = decode(params, z, ids_restore, cfg, block_wrapper)
    target, _, _ = patch_targets(images, cfg)
    per_patch = (pred.float() - target).square().mean(dim=-1)
    loss = (per_patch * mask).sum() / mask.sum()
    return {"loss": loss, "pred": pred, "mask": mask}


def unpatchify(patches: torch.Tensor, patch: int, grid: Tuple[int, int],
               chans: int = 3) -> torch.Tensor:
    """[B, L, C*p*p] -> [B, C, H, W], the inverse of ``L.patchify``."""
    b = patches.shape[0]
    gh, gw = grid
    x = patches.reshape(b, gh, gw, chans, patch, patch)
    x = x.permute(0, 3, 1, 4, 2, 5)  # [B, C, gh, ph, gw, pw]
    return x.reshape(b, chans, gh * patch, gw * patch)


def reconstruct(params: Params, images: torch.Tensor, cfg: MAEConfig,
                seed: Optional[torch.Tensor] = None,
                mask_ratio: Optional[float] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """The interactive demo: mask (from ``seed``, or ``noise`` [B, L]),
    reconstruct, compose the views:

      "o":      the visible patches of the input, the masked ones from the
                prediction [B, C, H, W]
      "masked": the input with its masked patches zeroed [B, C, H, W]
      "err":    the per-patch squared error on masked patches [B, gh, gw]
      "mask":   the patch mask [B, gh, gw] (1 = masked)

    With ``norm_pix`` the prediction is un-normalised with the target
    patches' statistics."""
    e = cfg.enc_cfg
    b = images.shape[0]
    keep = cfg.len_keep(mask_ratio)
    images = images.to(_act_dtype(params))
    ids_keep, mask, ids_restore = (
        random_masking(seed, b, cfg.num_patches, keep) if noise is None
        else masking_from_noise(noise, keep))
    z = encode(params, images, cfg, ids_keep)
    pred = decode(params, z, ids_restore, cfg).float()
    target, t_mean, t_rstd = patch_targets(images, cfg)
    pred_pix = pred / t_rstd + t_mean if cfg.norm_pix else pred
    raw = L.patchify(images, e.patch).float()
    m = mask[:, :, None]
    pasted = raw * (1.0 - m) + pred_pix * m
    per_patch = (pred - target).square().mean(dim=-1) * mask
    gh, gw = cfg.grid
    return {
        "o": unpatchify(pasted, e.patch, cfg.grid,
                        e.in_chans).to(images.dtype),
        "masked": unpatchify(raw * (1.0 - m), e.patch, cfg.grid,
                             e.in_chans).to(images.dtype),
        "err": per_patch.reshape(b, gh, gw),
        "mask": mask.reshape(b, gh, gw),
    }
