"""The port's checkpoint directory (``utils/checkpoint.py``) and the
trainer's checkpoint flags (``tools/train.py``) on the CPU.

A train-state tree with empty containers, 0-d, bf16, int8 (``ops/quant``)
and Python-scalar leaves round-trips bit for bit; ``state_keys`` reads no
leaf data; an orbax directory of the JAX package is refused. The trainer's
``--output`` / ``--save-every`` / ``--resume`` / ``--init`` /
``--export-safetensors`` behave as the JAX trainer's: the export layout
unpermutes head-major qkv and casts the EMA to the param dtype, a resume
restores params, optimizer state, step and EMA and refuses another qkv
layout, ``--init`` merges the trunk as JAX's ``merge_pretrained`` does.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

from interactive_vit_tpu.models import vit as jvit
from interactive_vit_tpu.models import weights as jweights
from interactive_vit_tpu.utils.safetensors_io import load_file as jload
from interactive_vit_tpu_torch.models import vit
from interactive_vit_tpu_torch.models.weights import (
    from_jax, to_native_flat, to_torchvision,
)
from interactive_vit_tpu_torch.ops.quant import quantize_tree
from interactive_vit_tpu_torch.parallel import mesh
from interactive_vit_tpu_torch.parallel.train import tree_leaves_with_path
from interactive_vit_tpu_torch.tools import train as train_tool
from interactive_vit_tpu_torch.utils import checkpoint as ckpt
from interactive_vit_tpu_torch.utils.safetensors_io import (
    load_file, save_file,
)

torch.set_num_threads(2)

TINY = dict(img_size=32, patch=16, width=128, depth=1, heads=2,
            num_classes=4)


def _assert_bits(got, want):
    """The same tree: structure, types, dtypes and bytes."""
    ga, wa = tree_leaves_with_path(got), tree_leaves_with_path(want)
    assert [p for p, _ in ga] == [p for p, _ in wa]
    for (path, a), (_, b) in zip(ga, wa):
        assert type(a) is type(b), path
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), path
        else:
            assert a == b, path
    assert _shape(got) == _shape(want)


def _shape(tree):
    """The containers of a tree, leaves elided (empty ones kept)."""
    if isinstance(tree, dict):
        return {k: _shape(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shape(v) for v in tree)
    return None


def _state_tree():
    g = torch.Generator().manual_seed(0)
    cfg = vit.ViTConfig("vit_hl", **dict(TINY, num_classes=0))
    params = vit.init_params(cfg, g)
    return {
        "params": params,
        "bf16": vit.init_params(cfg, g, dtype=torch.bfloat16),
        "int8": quantize_tree(params, mode="w8a8"),
        "opt_state": {"count": 7, "mu": (torch.randn(3, generator=g),),
                      "lr": 0.5, "on": True},
        "step": torch.tensor(7),
        "qkv_head_major": torch.tensor(1),
        "empty": {"blocks": [], "head": {}},
    }


def test_tree_round_trips_bit_for_bit(tmp_path):
    tree = _state_tree()
    assert tree["params"]["head"] == {}
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, tree)
    assert sorted(os.listdir(path)) == [ckpt.LEAVES_FILE, ckpt.TREE_FILE]
    back = ckpt.load_params(path, device="cpu")
    _assert_bits(back, tree)
    # the leaves file in the native-flat naming, readable by the JAX
    # package's reader
    leaves = load_file(os.path.join(path, ckpt.LEAVES_FILE))
    assert sorted(leaves) == sorted(to_native_flat(tree))
    assert sorted(jload(os.path.join(path, ckpt.LEAVES_FILE))) == \
        sorted(leaves)
    assert back["int8"]["blocks"][0]["fc1_w"]["int8a8_q"].dtype == torch.int8


def test_like_places_and_casts(tmp_path):
    tree = {"w": torch.randn(2, 3), "n": 3, "b": torch.ones(2).bfloat16()}
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, tree)
    like = {"b": ckpt.LeafSpec((2,), torch.float32, torch.device("cpu")),
            "n": 0, "w": torch.zeros(2, 3, dtype=torch.float64)}
    back = ckpt.load_params(path, like=like)
    assert back["b"].dtype == torch.float32 and back["n"] == 3
    assert back["w"].dtype == torch.float64
    assert torch.equal(back["w"], tree["w"].double())


@pytest.mark.parametrize("like,match", [
    ({"w": torch.zeros(2, 3)}, "saved keys"),
    ({"w": torch.zeros(3, 2), "n": 0}, "shape"),
    ({"w": [torch.zeros(2, 3)], "n": 0}, "not match")])
def test_like_mismatch_raises(tmp_path, like, match):
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, {"w": torch.zeros(2, 3), "n": 1})
    with pytest.raises(ValueError, match=match):
        ckpt.load_params(path, like=like)


def test_state_keys_reads_no_data(tmp_path):
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, _state_tree())
    os.remove(os.path.join(path, ckpt.LEAVES_FILE))
    assert ckpt.state_keys(path) == set(_state_tree())
    with pytest.raises(FileNotFoundError):
        ckpt.load_params(path, device="cpu")


@pytest.mark.parametrize("marker", ["_CHECKPOINT_METADATA", "d", None])
def test_foreign_directories_are_refused(tmp_path, marker):
    from interactive_vit_tpu_torch.serving.server import load_model_params

    path = tmp_path / "foreign"
    path.mkdir()
    if marker == "d":
        (path / marker).mkdir()
    elif marker:
        (path / marker).write_text("{}")
    for fn in (lambda: ckpt.load_params(str(path), device="cpu"),
               lambda: ckpt.state_keys(str(path)),
               lambda: load_model_params("vit_b16", str(path),
                                         device="cpu")):
        with pytest.raises(ValueError, match="--export-safetensors") as exc:
            fn()
        assert ("orbax" in str(exc.value)) == (marker is not None)


def test_unknown_format_and_bad_keys_are_refused(tmp_path):
    path = tmp_path / "ckpt"
    ckpt.save_params(str(path), {"a": torch.zeros(1)})
    (path / ckpt.TREE_FILE).write_text(json.dumps({"format": "x"}))
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        ckpt.load_params(str(path), device="cpu")
    for bad in ({"a/b": torch.zeros(1)}, {3: torch.zeros(1)}):
        with pytest.raises(ValueError, match="keys"):
            ckpt.save_params(str(tmp_path / "bad"), bad)
    for leaf in (object(), np.zeros(2)):
        with pytest.raises(TypeError):
            ckpt.save_params(str(tmp_path / "bad"), {"a": leaf})


def test_save_replaces_an_existing_directory(tmp_path):
    path = str(tmp_path / "ckpt")
    ckpt.save_params(path, {"a": torch.zeros(2)})
    ckpt.save_params(path, {"b": torch.ones(3)})
    assert ckpt.state_keys(path) == {"b"}
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_async_saver_snapshots_and_serializes(tmp_path, monkeypatch):
    """The host copy is taken in the caller's thread (a later in-place
    update does not reach the file); a second save waits out the first;
    close drains; a failed write raises from the next call."""
    started, release = threading.Event(), threading.Event()
    real = ckpt._write

    def slow(path, spec, flat):
        started.set()
        release.wait(10)
        real(path, spec, flat)

    monkeypatch.setattr(ckpt, "_write", slow)
    saver = ckpt.AsyncSaver()
    t = torch.zeros(4)
    saver.save(str(tmp_path / "a"), {"t": t})
    assert started.wait(10)
    t.add_(1.0)  # the next step's update, while the write is in flight
    second = threading.Thread(
        target=lambda: saver.save(str(tmp_path / "b"), {"t": t}))
    second.start()
    second.join(0.2)
    assert second.is_alive()  # waiting for the first write
    release.set()
    second.join(10)
    saver.close()
    assert torch.equal(ckpt.load_params(str(tmp_path / "a"),
                                        device="cpu")["t"], torch.zeros(4))
    assert torch.equal(ckpt.load_params(str(tmp_path / "b"),
                                        device="cpu")["t"], torch.ones(4))
    monkeypatch.setattr(ckpt, "_write", real)
    (tmp_path / "file").write_text("x")
    saver.save(str(tmp_path / "file" / "c"), {"t": t})
    with pytest.raises(OSError):
        saver.wait()
    saver.close()


# -- the trainer -----------------------------------------------------------------


@pytest.fixture
def tiny(monkeypatch):
    """A 2-head ViT 128 wide: ``--attn flash_vjp`` trains it head-major."""
    cfg = vit.ViTConfig("vit_tiny_ck", **TINY)
    monkeypatch.setitem(vit.VARIANTS, "vit_tiny_ck", cfg)
    return cfg


def _args(out, *extra):
    return ["--device", "cpu", "--variant", "vit_tiny_ck", "--batch", "4",
            "--dtype", "mixed", "--log-every", "1", "--output", out, *extra]


@pytest.mark.parametrize("attn,head_major", [("flash_vjp", True),
                                             ("reference", False)])
def test_output_and_save_every(tmp_path, tiny, attn, head_major):
    out = str(tmp_path / "run")
    res = train_tool.main(_args(out, "--steps", "4", "--save-every", "2",
                                "--attn", attn))
    assert res["head_major"] == head_major
    assert [s for s, _ in res["saves"]] == [2, 4]
    assert sorted(os.listdir(out)) == ["params", "state"]
    # params/: the export layout (canonical qkv columns)
    _assert_bits(ckpt.load_params(os.path.join(out, "params"),
                                  device="cpu"), res["params"])
    st = ckpt.load_params(os.path.join(out, "state"), device="cpu")
    assert int(st.pop("step")) == 4
    assert int(st.pop("qkv_head_major")) == int(head_major)
    _assert_bits(st, {"params": res["state"]["params"],
                      "opt_state": res["state"]["opt_state"]})
    assert st["opt_state"]["count"] == 4
    trained = (mesh.permute_qkv_head_major(res["params"], tiny.heads)
               if head_major else res["params"])
    _assert_bits(st["params"], trained)


def test_resume_restores_the_state_and_continues(tmp_path, tiny):
    out = str(tmp_path / "run")
    first = train_tool.main(_args(out, "--steps", "4", "--save-every", "2",
                                  "--attn", "flash_vjp", "--ema-decay",
                                  "0.9"))
    p, o, step, ema = train_tool.load_state(
        os.path.join(out, "state"), first["state"]["params"],
        first["state"]["opt_state"], expect_head_major=True, want_ema=True)
    assert step == 4
    _assert_bits({"p": p, "o": o}, {"p": first["state"]["params"],
                                    "o": first["state"]["opt_state"]})
    assert ema["blocks"][0]["qkv_w"].dtype == torch.float32
    resumed = train_tool.main(_args(out, "--steps", "6", "--resume",
                                    "--attn", "flash_vjp", "--ema-decay",
                                    "0.9"))
    assert resumed["start_step"] == 4
    assert [s for s, _, _ in resumed["history"]] == [4, 5]
    assert resumed["state"]["opt_state"]["count"] == 6
    # the export: the EMA cast back to the param dtype, canonical columns
    exported = ckpt.load_params(os.path.join(out, "params"), device="cpu")
    _assert_bits(exported, resumed["params"])
    st = ckpt.load_params(os.path.join(out, "state"), device="cpu")
    assert int(st["step"]) == 6 and "ema" in st
    want = mesh.unpermute_qkv_head_major(st["ema"], tiny.heads)
    _assert_bits(exported, want)


def test_resume_under_another_layout_raises_jax_s_message(tmp_path, tiny):
    out = str(tmp_path / "run")
    train_tool.main(_args(out, "--steps", "2", "--attn", "flash_vjp"))
    with pytest.raises(ValueError, match="--resume layout mismatch: "
                       "checkpoint at .* stores qkv head-major columns but "
                       "this run resolves to torch-layout"):
        train_tool.main(_args(out, "--steps", "4", "--resume", "--attn",
                              "reference"))


def test_resume_without_ema_seeds_it(tmp_path, tiny, caplog):
    out = str(tmp_path / "run")
    train_tool.main(_args(out, "--steps", "2"))
    with caplog.at_level("INFO"):
        res = train_tool.main(_args(out, "--steps", "3", "--resume",
                                    "--ema-decay", "0.5"))
    assert "no EMA state" in caplog.text
    assert res["start_step"] == 2


def test_resume_state_in_bfloat16(tmp_path, tiny):
    out = str(tmp_path / "run")
    args = ["--device", "cpu", "--variant", "vit_tiny_ck", "--batch", "4",
            "--dtype", "bfloat16", "--output", out]
    first = train_tool.main(args + ["--steps", "2"])
    p, o, step = train_tool.load_state(
        os.path.join(out, "state"), first["state"]["params"],
        first["state"]["opt_state"])
    assert p["blocks"][0]["qkv_w"].dtype == torch.bfloat16
    _assert_bits({"p": p, "o": o}, {"p": first["state"]["params"],
                                    "o": first["state"]["opt_state"]})


@pytest.mark.parametrize("argv", [
    ["--resume"], ["--resume", "--output", "/nonexistent/run"],
    ["--init", "w.safetensors", "--resume", "--output", "x"]])
def test_parser_refusals(argv):
    with pytest.raises(SystemExit) as exc:
        train_tool.parse_args(["--device", "cpu", *argv])
    assert exc.value.code == 2


def test_export_safetensors_reads_in_jax(tmp_path, tiny):
    path = str(tmp_path / "w.safetensors")
    res = train_tool.main(["--device", "cpu", "--variant", "vit_tiny_ck",
                           "--batch", "4", "--steps", "2", "--attn",
                           "flash_vjp", "--export-safetensors", path])
    assert res["head_major"]
    tree = jweights.from_native_flat(jload(path))
    got = {p: v for p, v in tree_leaves_with_path(tree)}
    want = {p: v for p, v in tree_leaves_with_path(res["params"])}
    assert sorted(got) == sorted(want)
    for p, v in want.items():
        assert got[p].tobytes() == v.numpy().tobytes(), p


def _jax_merge(tp, tree, head_major):
    """JAX's ``merge_pretrained`` on the same params and tree."""
    from interactive_vit_tpu.tools.train import merge_pretrained

    jcfg = jvit.ViTConfig("vit_tiny_ck", **TINY)
    jp = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), tp)
    jt = jax.tree.map(lambda t: t.numpy(), tree)
    return merge_pretrained(jp, jt, jcfg, head_major=head_major)


@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("classes", [4, 9, 0])
def test_merge_pretrained_as_jax(tiny, head_major, classes):
    """A checkpoint of the same trunk with another head (another label
    space, or none) merges as JAX merges it: the same loaded and skipped
    keys and the same values."""
    tp = vit.init_params(tiny, torch.Generator().manual_seed(1))
    if head_major:
        tp = mesh.permute_qkv_head_major(tp, tiny.heads)
    src = vit.ViTConfig("vit_src", **dict(TINY, num_classes=classes))
    tree = vit.init_params(src, torch.Generator().manual_seed(2))
    merged, loaded, skipped = train_tool.merge_pretrained(
        tp, tree, tiny, head_major)
    jmerged, jloaded, jskipped = _jax_merge(tp, tree, head_major)
    # JAX's list follows its tree's key order, which jax.tree.map sorted
    assert (sorted(loaded), skipped) == (sorted(jloaded), jskipped)
    g = dict(tree_leaves_with_path(merged))
    w = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jmerged)))
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        assert g[k].numpy().tobytes() == v.tobytes(), k


def test_merge_pretrained_refuses_another_trunk(tiny):
    tp = vit.init_params(tiny, torch.Generator().manual_seed(1))
    deeper = vit.ViTConfig("vit_deep", **dict(TINY, depth=2))
    with pytest.raises(ValueError, match="block trunk failed to load"):
        train_tool.merge_pretrained(
            tp, vit.init_params(deeper, torch.Generator()), tiny)


def test_init_from_a_torchvision_file(tmp_path, tiny, caplog):
    """``--init`` loads the file's trunk (head-major in this run) and keeps
    the fresh head of another label space."""
    src = vit.ViTConfig("vit_src", **dict(TINY, num_classes=7))
    pre = vit.init_params(src, torch.Generator().manual_seed(3))
    path = str(tmp_path / "pre.safetensors")
    save_file(to_torchvision(pre, src), path)
    with caplog.at_level("INFO"):
        res = train_tool.main(["--device", "cpu", "--variant", "vit_tiny_ck",
                               "--batch", "4", "--steps", "1", "--lr", "0",
                               "--attn", "flash_vjp", "--init", path])
    assert "fresh ['head']" in caplog.text
    for k in ("pos_emb", "cls_token"):
        assert torch.equal(res["params"][k], pre[k])
    # lr 0: AdamW's update is 0, so the trunk is the file's
    assert torch.equal(res["params"]["blocks"][0]["qkv_w"],
                       pre["blocks"][0]["qkv_w"])
    assert res["params"]["head"]["w"].shape == (TINY["width"], 4)


def test_init_from_jax_export_and_from_jax_tree(tmp_path, tiny):
    """A file the JAX package exports (``to_native_flat`` + its
    ``save_file``) initializes the port's run as ``from_jax`` of the same
    tree would."""
    from interactive_vit_tpu.utils.safetensors_io import save_file as jsave

    jcfg = jvit.ViTConfig("vit_tiny_ck", **TINY)
    jp = jax.tree.map(np.asarray, jvit.init_params(jax.random.key(5), jcfg))
    path = str(tmp_path / "jax.safetensors")
    jsave(jweights.to_native_flat(jp), path)
    tp = vit.init_params(tiny, torch.Generator().manual_seed(0))
    merged, loaded, _ = train_tool.init_from_checkpoint(
        path, tp, tiny, "vit_tiny_ck", head_major=False)
    assert "blocks" in loaded and "head" in loaded
    want = from_jax(jp)
    for p, v in tree_leaves_with_path(want):
        got = dict(tree_leaves_with_path(merged))[p]
        assert torch.equal(got, v), p


def test_export_safetensors_keeps_bf16_tags(tmp_path, tiny):
    """A bf16 run's export is written as the JAX trainer writes it: BF16
    tags and the params' own 16-bit patterns (not F32 upcasts)."""
    import json
    import struct

    path = str(tmp_path / "w.safetensors")
    res = train_tool.main(["--device", "cpu", "--variant", "vit_tiny_ck",
                           "--batch", "4", "--steps", "1", "--dtype",
                           "bfloat16", "--export-safetensors", path])
    raw = open(path, "rb").read()
    n = struct.unpack("<Q", raw[:8])[0]
    header = json.loads(raw[8:8 + n])
    from interactive_vit_tpu_torch.models.weights import to_native_flat

    flat = to_native_flat(res["params"], keep_bf16=True)
    assert sorted(flat) == sorted(header)
    for key, v in flat.items():
        assert v.dtype == torch.bfloat16
        assert header[key]["dtype"] == "BF16", key
        lo, hi = header[key]["data_offsets"]
        assert raw[8 + n + lo:8 + n + hi] == v.view(torch.int16).numpy(
        ).astype("<i2").tobytes(), key
    # and it reads back as its exact f32 upcast
    back = load_file(path)
    for key, v in flat.items():
        assert back[key].tobytes() == v.float().numpy().tobytes(), key
