"""The port's checkpoint data-plane drill (``service/ckpt_drill.py``) on the
CPU, at the JAX drill's sizes, and the runtime's join drain it compares the
snapshot drain against.

- v1↔v2 restore parity: the classic and stacked flavors bitwise, every leaf
  and dtype; the ZeRO and pipelined flavors name the ROADMAP items they
  wait for.
- The incremental delta: the head-only fine-tune's gate, and both cadences'
  per-save byte counts equal to the JAX drill's on the same sizes (both
  packages write the same v2 tree).
- The drain primitive in both modes, and the deadline drill under the
  snapshot drain: every gate the JAX drill demands.
- The join drain: ``tests/test_ckpt_v2.py::test_legacy_join_drain_mode_still_blocks``
  over the port's service.
"""

import os
import time

import numpy as np
import pytest

from multidisttorch_tpu_torch.service import ckpt_drill
from multidisttorch_tpu_torch.service import queue as squeue


def test_parity_phase_bitwise(tmp_path):
    r = ckpt_drill.run_parity_phase(str(tmp_path), device="cpu")
    assert r["ok"] and r["gated_flavors"] == ["classic", "stacked"]
    fl = r["flavors"]
    assert fl["zero"] == {"not_ported": "A.13"} and fl["pipelined"] == {"not_ported": "A.14"}
    assert len(fl["classic"]["checks"]) == 1 and len(fl["stacked"]["checks"]) == 2
    for flavor in ("classic", "stacked"):
        for c in fl[flavor]["checks"]:
            assert c["bit_identical"] and c["formats"] == ["v1", "v2"] and not c["diffs"], (flavor, c)
    # One epoch of 128 rows at batch 32, twice per flavor (two lanes stacked).
    assert r["steps"] == {"classic": 8, "stacked": 16}
    assert os.environ.get("MDT_CKPT_FORMAT") is None


def test_bitwise_equal_names_value_and_dtype_differences():
    a = {"params": {"w": np.zeros(3, np.float32)}, "step": np.int32(1), "opt": {"1": {}}}
    assert ckpt_drill._bitwise_equal(a, a) == (True, [])
    b = {"params": {"w": np.zeros(3, np.float64)}, "step": np.int32(1), "opt": {"1": {}}}
    assert ckpt_drill._bitwise_equal(a, b) == (False, ["params/w: dtype float32 vs float64"])
    c = {"params": {"w": np.array([0, 0, 1], np.float32)}, "step": np.int32(1), "opt": {"1": {}}}
    eq, diffs = ckpt_drill._bitwise_equal(a, c)
    assert not eq and diffs == ["params/w: values differ"]
    eq, diffs = ckpt_drill._bitwise_equal(a, {"params": a["params"], "step": a["step"]})
    assert not eq and diffs[0].startswith("leaf sets differ")


def test_delta_phase_gate_and_bytes_equal_jax(tmp_path):
    from multidisttorch_tpu.service import ckpt_drill as jax_drill

    r = ckpt_drill.run_delta_phase(str(tmp_path / "port"), device="cpu")
    assert r["ok"] and r["finetune"]["delta_ratio_mean"] < 0.5
    assert r["full_adam_contrast"]["delta_ratio_mean"] > 0.9
    assert r["steps"] == 40 and r["shape"] == {"hidden_dim": 64, "latent_dim": 8, "batch_size": 32}
    want = jax_drill.run_delta_phase(str(tmp_path / "jax"))
    for cadence in ("finetune", "full_adam_contrast"):
        got_b = [(s["total_bytes"], s["new_bytes"]) for s in r[cadence]["saves"]]
        want_b = [(s["total_bytes"], s["new_bytes"]) for s in want[cadence]["saves"]]
        assert got_b == want_b, cadence
        assert r[cadence]["model_bytes"] == want[cadence]["model_bytes"]
        assert r[cadence]["delta_ratio_mean"] == want[cadence]["delta_ratio_mean"]


def test_drain_primitive_phase_gates(tmp_path):
    r = ckpt_drill.run_drain_primitive_phase(str(tmp_path), device="cpu")
    snap, join = r["arms"]["snapshot_v2"], r["arms"]["join_v1"]
    assert snap["slices_freed"] and join["slices_freed"]
    assert r["snapshot_faster"] and r["snapshot_unblocked"] and r["ok"]
    # The join drain held the persist inline, so its books time the drain
    # and the persist as one; the snapshot drain's persist landed behind it.
    jb, sb = join["checkpoint_books"], snap["checkpoint_books"]
    assert jb["drain_snapshot"]["count"] == jb["drain_persist"]["count"] == 1
    assert jb["drain_snapshot"]["max_s"] == jb["drain_persist"]["max_s"]
    assert sb["drain_persist"]["max_s"] > sb["drain_snapshot"]["max_s"]
    assert snap["drain_to_persist_s"] > snap["drain_to_slices_freed_s"]
    assert snap["checkpoint_books"]["snapshot_drain"] is True and join["checkpoint_books"]["snapshot_drain"] is False
    assert snap["checkpoint_books"]["format"] == "v2" and join["checkpoint_books"]["format"] == "v1"
    assert os.environ.get(ckpt_drill.PERSIST_DELAY_ENV) is None


def test_deadline_phase_gates(tmp_path):
    from multidisttorch_tpu_torch import telemetry

    r = ckpt_drill.run_deadline_phase(str(tmp_path), device="cpu")
    assert r["deadline_status"] == "completed" and r["settle_latency_s"] < r["deadline_s"]
    h = r["honesty"]
    assert h["observed_pending"] and h["preempted_before_persist"] == 0 and h["slices_free_while_persisting"]
    assert r["preempted_records"] >= 2 and r["ram_restores"] >= 1 and r["trace_persist_spans"] >= 2
    assert r["all_completed"] and r["ok"]
    assert not telemetry.enabled()  # its own, turned off after


def test_ckpt_drill_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    for run in (ckpt_drill.run_parity_phase, ckpt_drill.run_delta_phase, ckpt_drill.run_drain_primitive_phase,
                ckpt_drill.run_deadline_phase, ckpt_drill.run_ckpt_bench):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(str(tmp_path / "drill"))
    assert not os.path.exists(tmp_path / "drill")


def test_legacy_join_drain_mode_still_blocks(tmp_path):
    """``snapshot_drain=False`` keeps the join drain's semantics: the drain
    joins the persist inline, records ``preempted`` at once and requeues
    before returning (the drill's comparison arm); ``MDT_SNAPSHOT_DRAIN=0``
    selects it, and the snapshot drain stays the default."""
    from multidisttorch_tpu_torch.service.runtime import SweepService

    d = str(tmp_path / "svc")
    os.makedirs(d)
    client = squeue.SweepClient(d, tenant="t")
    client.submit({"epochs": 3, "batch_size": 32, "latent_dim": 4, "hidden_dim": 16, "log_interval": 1000})
    svc = SweepService(d, n_slices=1, max_lanes=1, data_rows=128, defrag_enabled=False, snapshot_drain=False,
                       ckpt_format="v1", device="cpu")
    try:
        assert svc.books()["checkpoint"]["snapshot_drain"] is False
        t0 = time.time()
        ap = None
        while time.time() - t0 < 60:
            svc.tick()
            actives = list(svc.active.values())
            if actives and bool(actives[0].run.result.checkpoint):
                ap = actives[0]
                break
        assert ap is not None
        svc._checkpoint_drain(ap, reason="test preemption")
        # Everything happened inline: no pending persist, the ledger has the
        # record, the pool is free.
        assert not svc._pending_persists
        assert svc.pool.free_total == 1
        with open(svc.ledger.path) as f:
            assert '"preempted"' in f.read()
        svc._drain(reason="test end")
    finally:
        svc.close()
    os.environ["MDT_SNAPSHOT_DRAIN"] = "0"
    try:
        by_env = SweepService(str(tmp_path / "env"), n_slices=1, device="cpu")
    finally:
        del os.environ["MDT_SNAPSHOT_DRAIN"]
    by_env.close()
    assert by_env.snapshot_drain is False
    default = SweepService(str(tmp_path / "default"), n_slices=1, device="cpu")
    default.close()
    assert default.snapshot_drain is True and default.books()["checkpoint"]["snapshot_drain"] is True
