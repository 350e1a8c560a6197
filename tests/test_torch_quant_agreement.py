"""``tools/quant_agreement.py`` against the JAX package, on the CPU.

At toy ViT and Swin configs in f32, each of the tool's modes gives the
logits of JAX's forward on the same weights quantized by JAX's
``quantize_tree`` the same way, within 1e-4 (both quantize the weights
bit for bit alike; on the CPU both run the unfused path, whose activation
rounding is half to even on both sides; the frameworks differ only in the
order of f32 sums). The agreement rows: bf16 against itself agrees 1 with
difference 0, and the int8 modes move the logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interactive_vit_tpu.models import swin as jswin
from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.ops import quant as jq
from interactive_vit_tpu_torch.models import swin as tswin
from interactive_vit_tpu_torch.models import vit as tvit
from interactive_vit_tpu_torch.models.weights import from_jax
from interactive_vit_tpu_torch.tools import quant_agreement as qa

torch.set_num_threads(2)

ATOL = 1e-4
TOYS = {
    "vit": (jvit, tvit, "ViTConfig",
            dict(img_size=32, patch=16, width=64, depth=2, heads=4,
                 num_classes=10)),
    "swin": (jswin, tswin, "SwinConfig",
             dict(img_size=32, patch=4, embed_dim=16, depths=(2, 2),
                  heads=(2, 4), window=4, num_classes=10)),
}
JAX_TREES = {
    "bf16": lambda p: p,
    "int8_w8": lambda p: jq.quantize_tree(p, mode="w8"),
    "int8w8a8_mlp": lambda p: jq.quantize_tree(
        p, names=frozenset({"fc1_w", "fc2_w"}), mode="w8a8"),
}


def _toy(family):
    jmod, tmod, cls, geom = TOYS[family]
    jcfg = getattr(jmod, cls)(f"{family}_qa", **geom)
    tcfg = getattr(tmod, cls)(f"{family}_qa", **geom)
    jparams = jmod.init_params(jax.random.key(13), jcfg)
    return jmod, jcfg, tcfg, jparams


@pytest.mark.parametrize("family", sorted(TOYS))
def test_mode_logits_match_jax(family):
    jmod, jcfg, tcfg, jparams = _toy(family)
    modes = qa.build_modes(family, tcfg, from_jax(jax.tree.map(
        np.asarray, jparams)), torch.device("cpu"))
    assert sorted(modes) == sorted(JAX_TREES)
    (images,) = qa.seeded_images(1, 3, 32, torch.float32, "cpu")
    for mode, tree in JAX_TREES.items():
        want = np.asarray(jmod.forward(tree(jparams), jnp.asarray(
            images.numpy()), jcfg)["logits"])
        got = modes[mode](images).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=mode)


@pytest.mark.parametrize("family", sorted(TOYS))
def test_agreement_rows(family):
    _, _, tcfg, jparams = _toy(family)
    modes = qa.build_modes(family, tcfg, from_jax(jax.tree.map(
        np.asarray, jparams)), torch.device("cpu"))
    rows = {r["mode"]: r for r in qa.agreement(
        modes, qa.seeded_images(2, 4, 32, torch.float32, "cpu"))}
    assert rows["bf16"]["top1_agreement"] == 1.0
    assert rows["bf16"]["logit_mae"] == 0.0
    for mode in ("int8_w8", "int8w8a8_mlp"):
        assert 0.0 < rows[mode]["logit_mae"]
        assert 0.0 <= rows[mode]["top1_agreement"] <= 1.0
    # the spread: the bf16 logits' standard deviation averaged over rounds
    spread = np.mean([float(modes["bf16"](x).std()) for x in
                      qa.seeded_images(2, 4, 32, torch.float32, "cpu")])
    for mode in rows:
        assert rows[mode]["logit_mae_over_spread"] == pytest.approx(
            rows[mode]["logit_mae"] / spread, rel=1e-5)


def test_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qa.main(["--variant", "swin_t", "--rounds", "1", "--batch", "1"])
