"""The kernel-library quarantine (``multidisttorch_tpu_torch/compile/
cache.py``) and the cold-start bench (``compile/coldstart.py``) on the CPU.

The sidecars are the JAX package's (``tests/test_compile_farm.py``): the
same files sealed and scanned by either package's functions give the same
verdicts. Scripted canary runners stand in for a broken library, as the
JAX tests' do; a real canary child needs a card for the ``.cu``
libraries, and checks the host gatherer here. A quarantined library is
rebuilt from its source by the builder (``g++`` builds the gatherer
here). The cold-start bench runs its three children on the CPU with one
epoch (a cut of the fixed sweep's eight): the losses are bit-identical
across the modes and no farm admission captures on the host loop.
"""

import json
import os
import zlib

import numpy as np
import pytest

from multidisttorch_tpu.compile import cache as jax_cache
from multidisttorch_tpu_torch.compile import cache
from multidisttorch_tpu_torch.compile.cache import (
    CANARY_CRASHED,
    CANARY_MISMATCH,
    CANARY_TIMEOUT,
    ENABLED,
    QUARANTINE_DIR,
    SIDECAR_SUFFIX,
    cache_probe,
    canary_quarantine,
    enable_quarantined_cache,
    scan_cache,
    seal_cache,
)
from multidisttorch_tpu_torch.ops import _build

ELBO = "libelbo_0123456789abcdef.so"
FLASH = "libflash_attention_fedcba9876543210.so"


def _plant(d, name, blob=b"x" * 64):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "wb") as f:
        f.write(blob)


def _left(d):
    return sorted(n for n in os.listdir(d) if not n.endswith(SIDECAR_SUFFIX) and n != QUARANTINE_DIR)


def _quarantined(d):
    q = os.path.join(d, QUARANTINE_DIR)
    return sorted(n for n in os.listdir(q) if not n.endswith(SIDECAR_SUFFIX)) if os.path.isdir(q) else []


def test_scan_rejects_corrupt_truncated_and_unsealed(tmp_path):
    d = str(tmp_path / "kernels")
    _plant(d, "good", b"a" * 100)
    _plant(d, "bitrot", b"b" * 100)
    _plant(d, "torn", b"c" * 100)
    _plant(d, "libelbo_x.so.123.tmp", b"half")  # a build in flight is not an entry
    seal_cache(d)
    _plant(d, "bitrot", b"B" + b"b" * 99)
    _plant(d, "torn", b"c" * 10)
    _plant(d, "stranger", b"s" * 20)
    report = scan_cache(d)
    assert {r["entry"]: r["reason"] for r in report["rejected"]} == {
        "bitrot": "crc_mismatch", "torn": "size_mismatch", "stranger": "unsealed"}
    assert report["ok"] == 1 and report["quarantined"] == 3
    assert _left(d) == ["good", "libelbo_x.so.123.tmp"]
    assert _quarantined(d) == ["bitrot", "stranger", "torn"]


def test_scan_classifies_malformed_but_parseable_sidecars(tmp_path):
    d = str(tmp_path / "kernels")
    for name, side in (("e_list", "[]"), ("e_zero", "0"), ("e_null", '{"crc32": 1, "nbytes": null}'),
                       ("e_str", '{"crc32": "xx", "nbytes": 2}')):
        _plant(d, name, b"xy")
        with open(os.path.join(d, name + SIDECAR_SUFFIX), "w") as f:
            f.write(side)
    report = scan_cache(d)
    assert report["ok"] == 0 and report["quarantined"] == 4
    assert {r["reason"] for r in report["rejected"]} == {"sidecar_unreadable"}


def test_seal_is_idempotent_and_refreshes(tmp_path):
    d = str(tmp_path / "kernels")
    _plant(d, "e1", b"v1")
    assert seal_cache(d)["sealed"] == 1
    assert seal_cache(d)["sealed"] == 0
    _plant(d, "e1", b"v2")
    assert seal_cache(d)["refreshed"] == 1
    assert scan_cache(d)["ok"] == 1


def test_crc_sidecar_format_is_plain_json(tmp_path):
    d = str(tmp_path / "kernels")
    _plant(d, "e", b"payload")
    seal_cache(d)
    with open(os.path.join(d, "e" + SIDECAR_SUFFIX)) as f:
        assert json.load(f) == {"crc32": zlib.crc32(b"payload"), "nbytes": 7}


@pytest.mark.parametrize("sealer,scanner", [("port", "jax"), ("jax", "port")])
def test_sidecars_give_both_packages_the_same_verdicts(tmp_path, sealer, scanner):
    mods = {"port": cache, "jax": jax_cache}
    reports = []
    for who in ("port", "jax"):
        d = str(tmp_path / who)
        for name, blob in (("good", b"g" * 50), ("rot", b"r" * 50), ("torn", b"t" * 50)):
            _plant(d, name, blob)
        mods[sealer].seal_cache(d)
        _plant(d, "rot", b"R" + b"r" * 49)
        _plant(d, "torn", b"t" * 5)
        _plant(d, "stranger", b"s")
        with open(os.path.join(d, "good" + SIDECAR_SUFFIX)) as f:
            side = f.read()
        rep = mods[scanner if who == "port" else sealer].scan_cache(d)
        reports.append((sorted((r["entry"], r["reason"]) for r in rep["rejected"]), rep["ok"], side, _left(d)))
    assert reports[0] == reports[1]
    assert reports[0][0] == [("rot", "crc_mismatch"), ("stranger", "unsealed"), ("torn", "size_mismatch")]


def _runner(script):
    """A canary child stand-in: ``script`` maps a library name to its record."""
    calls = []

    def run(path, name, timeout_s):
        calls.append(name)
        return dict(script[name])

    run.calls = calls
    return run


@pytest.mark.parametrize("bad,verdict", [
    ({"ok": True, "match": False, "max_err": 3.0}, CANARY_MISMATCH),
    ({"ok": False, "timeout": False, "rc": -11}, CANARY_CRASHED),
    ({"ok": False, "timeout": True}, CANARY_TIMEOUT),
])
def test_a_failed_canary_quarantines_only_that_library(tmp_path, bad, verdict):
    d = str(tmp_path / "kernels")
    _plant(d, ELBO)
    _plant(d, FLASH)
    seal_cache(d)
    run = _runner({"elbo": bad, "flash_attention": {"ok": True, "match": True, "max_err": 0.0}})
    out = canary_quarantine(d, runner=run)
    assert not out["passed"] and out["verdict"] == verdict and out["evicted"] == 1
    assert sorted(run.calls) == ["elbo", "flash_attention"]
    assert _left(d) == [FLASH] and _quarantined(d) == [ELBO]


def test_probe_moves_nothing_and_enable_points_the_builder(tmp_path, monkeypatch):
    d = str(tmp_path / "kernels")
    _plant(d, ELBO)
    _plant(d, "unsealed_stranger")
    seal_cache(d, only={ELBO})
    bad = _runner({"elbo": {"ok": True, "match": False, "max_err": 1.0}})
    probe = cache_probe(d, runner=bad)
    assert not probe["usable"] and probe["scan"]["quarantined"] == 0 and _quarantined(d) == []
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    good = _runner({"elbo": {"ok": True, "match": True, "max_err": 0.0}})
    out = enable_quarantined_cache(d, runner=good)
    assert out["enabled"] and out["verdict"] == ENABLED
    assert out["scan"]["rejected"] == [{"entry": "unsealed_stranger", "reason": "unsealed"}]
    assert str(_build.BUILD_DIR) == d and _left(d) == [ELBO]


def test_a_quarantined_library_is_rebuilt_from_source(tmp_path, monkeypatch):
    # The host gatherer, built by g++ into a scratch directory, sealed, torn:
    # the scan quarantines it, the builder rebuilds it, and a real canary
    # child loads the rebuilt one and holds it against numpy's indexing.
    d = tmp_path / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", d)
    monkeypatch.setattr(_build, "_loaded", {})
    path = _build.build("fastloader")
    assert cache.library_name(path.name) == "fastloader"
    seal_cache(str(d))
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    report = scan_cache(str(d))
    assert report["rejected"] == [{"entry": path.name, "reason": "size_mismatch"}] and not path.exists()
    rebuilt = _build.build("fastloader")
    assert rebuilt == path and path.stat().st_size == size
    seal_cache(str(d))
    out = canary_quarantine(str(d), timeout_s=120)
    assert out["passed"], out
    assert out["libraries"][path.name]["max_err"] == 0.0


def test_coldstart_modes_agree_on_the_cpu(tmp_path):
    from multidisttorch_tpu_torch.compile import coldstart

    rec = coldstart.run_coldstart_bench(str(tmp_path), device="cpu", epochs=1, timeout_s=300)
    for mode in coldstart.MODES:
        assert rec["modes"][mode]["ok"], rec["modes"][mode]
    assert rec["parity"] and not rec["parity_mismatches"]
    assert rec["admission_blocked_on_compile"] is False and rec["admission_blocked_on_compile_warm"] is False
    assert rec["passed"] and rec["cache_verdict"] == ENABLED
    cold = rec["modes"]["cold"]["books"]
    assert [a["outcome"] for a in cold["admissions"]] == ["inline"] * len(coldstart.COLDSTART_HIDDENS)
    assert rec["modes"]["farm"]["books"]["precompile"]["plan"] == 1
    assert all(v is not None for v in (rec["cold_mean_admission_s"], rec["precompiled_mean_admission_s"],
                                      rec["cache_warm_mean_admission_s"]))
    assert np.isfinite(float.fromhex(rec["modes"]["cold"]["trials"][0]["train_hex"]))
