"""``chip_smoke.py``'s ``profiled`` on the CPU, with the profiler and the
count of launches by name stubbed: a trace short of the launch counters, or
one that holds no kernel at all, is taken again and recorded, and the run
fails when every try falls short, so a launch that is really missing cannot
pass."""

import contextlib
import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def smoke(monkeypatch):
    mod = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext())
    reported = []
    monkeypatch.setattr(mod, "ran_kernels", lambda prof: [(1.0, 1, "k")])
    monkeypatch.setattr(mod, "report_profile",
                        lambda prof, wall, what, expect: reported.append(what))
    mod.reported = reported
    return mod


def _traces(smoke, monkeypatch, seen):
    it = iter(seen)
    monkeypatch.setattr(smoke, "kernels_by_name", lambda prof, parts: next(it))


@pytest.mark.parametrize("tries_short", [0, 1, 2])
def test_a_short_trace_is_taken_again_and_recorded(smoke, monkeypatch,
                                                   tries_short):
    want = {"w8a8_mma_kernel": 12, "w8a8_mlp_kernel": 0}
    short = {"w8a8_mma_kernel": 11, "w8a8_mlp_kernel": 0}
    _traces(smoke, monkeypatch, [short] * tries_short + [want])
    smoke.profiled(lambda: 1.0, "served", want)
    assert smoke.reported == ["served"]
    assert len(smoke.PROFILE_RETRIES) == tries_short


def test_every_try_short_fails(smoke, monkeypatch):
    want = {"w8a8_mma_kernel": 12, "w8a8_mlp_kernel": 0}
    short = {"w8a8_mma_kernel": 11, "w8a8_mlp_kernel": 0}
    _traces(smoke, monkeypatch, [short] * 3)
    with pytest.raises(AssertionError, match="each of 3 traces"):
        smoke.profiled(lambda: 1.0, "served", want)
    assert smoke.reported == [] and len(smoke.PROFILE_RETRIES) == 3


@pytest.mark.parametrize("seen", [{"w8a8_mma_kernel": 13, "w8a8_mlp_kernel": 0},
                                  {"w8a8_mma_kernel": 11, "w8a8_mlp_kernel": 1}])
def test_a_trace_over_the_counters_is_not_taken_again(smoke, monkeypatch,
                                                      seen):
    """More launches than counted, or a kernel that must not run, go
    straight to ``report_profile`` (which fails them)."""
    _traces(smoke, monkeypatch, [seen])
    smoke.profiled(lambda: 1.0, "served",
                   {"w8a8_mma_kernel": 12, "w8a8_mlp_kernel": 0})
    assert smoke.reported == ["served"] and smoke.PROFILE_RETRIES == []


@pytest.mark.parametrize("tries_empty", [1, 2, 3])
def test_an_empty_trace_is_taken_again(smoke, monkeypatch, tries_empty):
    """A trace with no kernel cannot show that none of the port's ran: it
    is taken again, and three empty traces fail the run."""
    it = iter([[]] * tries_empty + [[(1.0, 1, "gemm")]])
    monkeypatch.setattr(smoke, "ran_kernels", lambda prof: next(it))
    none = {"w8a8_mma_kernel": 0, "w8a8_mlp_kernel": 0}
    _traces(smoke, monkeypatch, [none])
    if tries_empty == 3:
        with pytest.raises(AssertionError, match="each of 3 traces"):
            smoke.profiled(lambda: 1.0, "served", none)
        assert smoke.reported == []
    else:
        smoke.profiled(lambda: 1.0, "served", none)
        assert smoke.reported == ["served"]
    assert len(smoke.PROFILE_RETRIES) == tries_empty


def test_ran_kernels_leaves_out_copies_and_fills():
    smoke = _load()

    class Prof:
        ivt_kernels = [(0.1, 8, "Memcpy DtoD (Device -> Device)"),
                       (0.1, 1, "Memset (Device)")]

    assert smoke.ran_kernels(Prof()) == []
    Prof.ivt_kernels.append((0.2, 3, "gemm_kernel"))
    assert smoke.ran_kernels(Prof()) == [(0.2, 3, "gemm_kernel")]
