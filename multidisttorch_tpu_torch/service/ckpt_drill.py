"""The checkpoint data plane's acceptance drill; the port's counterpart of
the JAX package's ``service/ckpt_drill.py`` (its ``bench.py --ckpt``).

Four phases, each a gate (docs/RESILIENCE.md "Checkpoint format v2"):

1. **Restore parity** (:func:`run_parity_phase`): each trial flavor is
   trained TWICE from one seed through ``run_hpo``, once writing v1
   full-msgpack checkpoints and once writing v2 chunked manifests; the two
   files must decode to BITWISE-identical state, every leaf and dtype
   (training is bit-reproducible, so any drift is the format's fault). The
   port runs the classic and the stacked (2 lanes) flavors; the ZeRO
   flavor waits for sharding (ROADMAP A.13) and the pipelined one for
   pipeline placements (A.14). The report names both, and the gate is over
   the ported flavors.
2. **Incremental delta** (:func:`run_delta_phase`): a head-only fine-tune
   (only ``fc21``/``fc22``, the latent heads, get gradients; every other
   gradient is zeroed and Adam still steps every leaf, so the frozen
   leaves and their zero moments stay bitwise still) saved every epoch
   under v2: unchanged chunks are referenced, not rewritten. Gate: the
   mean written/total ratio per save after the first below 0.5. The
   full-Adam contrast (every leaf changes) is recorded, not gated. The
   steps go through the fused ELBO loss (the kernels on a card) and the
   port's Adam.
3. **The drain primitive** (:func:`run_drain_primitive_phase`): with a
   deterministic persist delay (:data:`PERSIST_DELAY_ENV`) making the
   write's cost visible, the drain is measured in both modes against a
   placement whose checkpoint write is IN FLIGHT: the snapshot drain frees
   the victim's slices without joining the write; the join drain blocks on
   the whole persist. Gate: the snapshot drain faster than the join drain
   and under half the persist delay.
4. **The deadline drill under the snapshot drain**
   (:func:`run_deadline_phase`): a size-2 deadline trial preempts both
   best-effort trials and places without waiting for their persists,
   completes inside its deadline; the ledger records ``preempted`` only
   after each victim's persist lands (checked live, between ticks); the
   victims resume from the RAM snapshot (same process) and complete, and
   each victim's trace carries a ``ckpt_persist`` span.

The drill runs on the card unless the caller asks for the CPU
(``device="cpu"``), and raises where CUDA is asked for and absent. On the
CPU its sizes are the JAX drill's; on the card the full-width 784-400-20
VAE at batch 128 (``service/drill.py``'s ``CARD_BASE``), its services'
trials in shape buckets of different ``fused_steps``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from typing import Optional

from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service.drill import CARD_BASE, CPU_BASE, _device

PERSIST_DELAY_ENV = "MDT_CKPT_PERSIST_DELAY_S"

# The JAX drill's flavors; the port's table of the ones it does not run yet.
FLAVORS = ("classic", "stacked", "zero", "pipelined")
NOT_PORTED = {"zero": "A.13", "pipelined": "A.14"}

# The services' shape buckets: two best-effort whales and the deadline
# whale. The CPU's are the JAX drill's widths; the card's differ in
# ``fused_steps`` at full width.
CPU_SHAPES = ({"hidden_dim": 16}, {"hidden_dim": 24}, {"hidden_dim": 40})
CARD_SHAPES = ({"fused_steps": 10}, {"fused_steps": 5}, {"fused_steps": 8})
# Rows of synthetic MNIST: the JAX drill's 128 on the CPU; 10 steps an
# epoch at batch 128 on the card (one graphed chunk).
CPU_ROWS = 128
CARD_ROWS = 1280
# The delta phase's model and data, (hidden, latent, batches, batch): the
# JAX drill's on the CPU, the full width on the card.
CPU_DELTA = (64, 8, 20, 32)
CARD_DELTA = (400, 20, 20, 128)


def _sizes(device: str) -> tuple[dict, tuple, int]:
    cpu = device == "cpu"
    return dict(CPU_BASE if cpu else CARD_BASE), (CPU_SHAPES if cpu else CARD_SHAPES), (CPU_ROWS if cpu else CARD_ROWS)


def _bitwise_equal(dict_a, dict_b) -> tuple[bool, list]:
    """Compare two nested state trees leaf by leaf: values AND dtypes."""
    import numpy as np

    from multidisttorch_tpu_torch.train.ckpt_store import _flatten_state_dict

    fa = dict(_flatten_state_dict(dict_a))
    fb = dict(_flatten_state_dict(dict_b))
    diffs = []
    if set(fa) != set(fb):
        diffs.append(f"leaf sets differ: {sorted(set(fa) ^ set(fb))[:4]}")
        return False, diffs
    for k in sorted(fa):
        a, b = fa[k], fb[k]
        if isinstance(a, dict) or isinstance(b, dict):
            if a != b:
                diffs.append(f"{k}: structure mismatch")
            continue
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype:
            diffs.append(f"{k}: dtype {a.dtype} vs {b.dtype}")
        elif not np.array_equal(a, b):
            diffs.append(f"{k}: values differ")
    return not diffs, diffs


def _decode_ckpt(path: str):
    """Format-sniffing decode of one checkpoint file to its raw state tree
    of host arrays and its format, ``"v1"`` or ``"v2"`` (no template: the
    parity comparison is over the bytes on disk)."""
    from multidisttorch_tpu_torch.train.checkpoint import _read_tree_format

    return _read_tree_format(path)


@contextlib.contextmanager
def _env(name: str, value: str):
    """``name`` set to ``value`` inside, and as it was after."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def _run_flavor(flavor: str, out_dir: str, fmt: str, device: str) -> tuple[list[str], int]:
    """Train one flavor writing ``fmt`` checkpoints; returns the checkpoint
    paths it wrote and the train steps it took. ``MDT_CKPT_FORMAT`` is read
    at save time, so it is set around the run and restored after."""
    from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
    from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups

    base, shapes, rows = _sizes(device)
    base = {**base, **shapes[0], "epochs": 1}
    train = synthetic_mnist(rows, seed=0)
    groups = setup_groups(1, devices=["cpu" if device == "cpu" else "cuda:0"])
    kw = dict(groups=groups, out_dir=out_dir, save_images=False, verbose=False)
    with _env("MDT_CKPT_FORMAT", fmt):
        if flavor == "classic":
            results = run_hpo([TrialConfig(trial_id=0, **base)], train, None, **kw)
        elif flavor == "stacked":
            cfgs = [TrialConfig(trial_id=i, **{**base, "seed": i}) for i in range(2)]
            results = run_hpo(cfgs, train, None, stack_trials=True, **kw)
        else:
            raise ValueError(flavor)
    for r in results:
        if r.status != "completed":
            raise RuntimeError(f"parity {flavor} {fmt}: trial {r.trial_id} {r.status}: {r.error}")
    paths = [os.path.join(out_dir, f"trial-{r.trial_id}", "state.msgpack") for r in results]
    return paths, sum(r.steps for r in results)


def run_parity_phase(work_dir: str, *, device: Optional[str] = None) -> dict:
    """v1↔v2 bitwise restore parity over every ported trial flavor; the
    others report the ROADMAP item they wait for."""
    device = _device(device)
    out: dict = {"device": device, "flavors": {}, "gated_flavors": [], "steps": {}}
    for flavor in FLAVORS:
        if flavor in NOT_PORTED:
            out["flavors"][flavor] = {"not_ported": NOT_PORTED[flavor]}
            continue
        d1 = os.path.join(work_dir, f"parity_{flavor}_v1")
        d2 = os.path.join(work_dir, f"parity_{flavor}_v2")
        for d in (d1, d2):
            shutil.rmtree(d, ignore_errors=True)
        paths1, steps1 = _run_flavor(flavor, d1, "v1", device)
        paths2, steps2 = _run_flavor(flavor, d2, "v2", device)
        checks = []
        for p1, p2 in zip(paths1, paths2):
            sd1, f1 = _decode_ckpt(p1)
            sd2, f2 = _decode_ckpt(p2)
            eq, diffs = _bitwise_equal(sd1, sd2)
            checks.append({"v1": p1, "v2": p2, "formats": [f1, f2], "bit_identical": eq, "diffs": diffs[:4]})
        ok = bool(checks) and all(c["bit_identical"] and c["formats"] == ["v1", "v2"] for c in checks)
        out["flavors"][flavor] = {"checks": checks, "ok": ok}
        out["gated_flavors"].append(flavor)
        out["steps"][flavor] = steps1 + steps2
    out["ok"] = all(out["flavors"][f]["ok"] for f in out["gated_flavors"])
    return out


def run_delta_phase(work_dir: str, *, epochs: int = 4, device: Optional[str] = None) -> dict:
    """Multi-epoch incremental saves: a head-only fine-tune (only
    ``fc21``/``fc22`` keep their gradients) checkpointed every epoch under
    v2 in 64 KiB chunks, and the full-Adam contrast, recorded, not gated.
    Each cadence takes ``epochs`` x 5 steps of the fused ELBO loss and the
    port's Adam."""
    import numpy as np
    import torch

    from multidisttorch_tpu_torch.models.vae import VAE
    from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum
    from multidisttorch_tpu_torch.parallel.mesh import setup_groups
    from multidisttorch_tpu_torch.train import checkpoint as ck
    from multidisttorch_tpu_torch.train.steps import create_train_state

    device = _device(device)
    hidden, latent, n_batches, batch = CPU_DELTA if device == "cpu" else CARD_DELTA
    group = setup_groups(1, devices=["cpu" if device == "cpu" else "cuda:0"])[0]
    data = torch.rand((n_batches, batch, 784), generator=torch.Generator().manual_seed(1)).to(group.device)

    def step(state, x, generator, train_keys: Optional[tuple]) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        recon, mu, logvar = state.model(x, generator=generator)
        fused_elbo_loss_sum(recon, x, mu, logvar).backward()
        if train_keys is not None:
            # Head-only fine-tune: the frozen leaves' gradients are zero,
            # and Adam with a zero gradient and zero moments leaves them
            # bitwise as they were.
            for name, p in state.model.named_parameters():
                if name.split(".")[0] not in train_keys:
                    p.grad.zero_()
        state.optimizer.step()
        state.step += 1

    def run_cadence(label: str, train_keys: Optional[tuple]) -> dict:
        d = os.path.join(work_dir, f"delta_{label}")
        shutil.rmtree(d, ignore_errors=True)
        path = os.path.join(d, "state.msgpack")
        state = create_train_state(group, VAE(hidden_dim=hidden, latent_dim=latent).init_params(0), 1e-3)
        generator = torch.Generator(device=group.device).manual_seed(0)
        saves = []
        for epoch in range(1, epochs + 1):
            for i in range(5):
                step(state, data[(epoch * 5 + i) % n_batches], generator, train_keys)
            stats: dict = {}
            ck.save_state(state, path, metadata={"step": state.step, "epoch": epoch}, keep_last=2, format="v2",
                          chunk_bytes=64 * 1024, stats_out=stats)
            saves.append(stats)
        ratios = [s["new_bytes"] / s["total_bytes"] for s in saves[1:]]
        return {
            "saves": saves,
            "steps": state.step,
            "model_bytes": saves[0]["total_bytes"],
            "delta_ratio_mean": round(float(np.mean(ratios)), 4),
            "delta_ratio_max": round(float(np.max(ratios)), 4),
        }

    finetune = run_cadence("finetune", ("fc21", "fc22"))
    full = run_cadence("full", None)
    return {
        "device": device,
        "epochs": epochs,
        "shape": {"hidden_dim": hidden, "latent_dim": latent, "batch_size": batch},
        "finetune": finetune,
        "full_adam_contrast": full,
        "steps": finetune["steps"] + full["steps"],
        "ok": finetune["delta_ratio_mean"] < 0.5,
    }


def _fill_pool(svc, client, *, base: dict, shapes: tuple, epochs: int = 20, timeout_s: float = 120.0) -> list:
    """Two distinct-bucket best-effort whales of ``epochs`` placed, each with
    a durable checkpoint (movable): the drain drills' fixture."""
    subs = [client.submit({**base, **shape, "epochs": epochs}) for shape in shapes[:2]]
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        svc.tick()
        if len(svc.active) == 2 and all(bool(ap.run.result.checkpoint) for ap in svc.active.values()):
            return subs
    raise TimeoutError("drain drill fixture never reached durable checkpoints")


def _wait_inflight(svc, *, timeout_s: float = 60.0):
    """Tick until some active placement has a checkpoint write IN FLIGHT
    (the persist delay makes the window wide)."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        svc.tick()
        for ap in svc.active.values():
            if not ap.run._ckpt_idle():
                return ap
    raise TimeoutError("no checkpoint write observed in flight")


def run_drain_primitive_phase(work_dir: str, *, persist_delay_s: float = 0.3, device: Optional[str] = None,
                              data_rows: Optional[int] = None) -> dict:
    """The drain primitive in both modes against an in-flight write: the
    drain-to-slices-freed wall time, the snapshot drain on v2 against the
    join drain on v1."""
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.service.runtime import SweepService

    device = _device(device)
    base, shapes, rows = _sizes(device)
    rows = rows if data_rows is None else data_rows
    arms = {}
    with _env(PERSIST_DELAY_ENV, str(persist_delay_s)):
        for label, snapshot_drain, fmt in (("snapshot_v2", True, "v2"), ("join_v1", False, "v1")):
            d = os.path.join(work_dir, f"drain_{label}")
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d, exist_ok=True)
            client = squeue.SweepClient(d, tenant="drill")
            svc = SweepService(d, n_slices=2, max_lanes=1, data_rows=rows, defrag_enabled=False,
                               snapshot_drain=snapshot_drain, ckpt_format=fmt, retry=RetryPolicy(max_retries=2),
                               device=device)
            try:
                _fill_pool(svc, client, base=base, shapes=shapes)
                ap = _wait_inflight(svc)
                free_before = svc.pool.free_total
                t0 = time.perf_counter()
                svc._checkpoint_drain(ap, reason="drain drill")
                freed_s = time.perf_counter() - t0
                freed_ok = svc.pool.free_total == free_before + ap.size
                # Land everything before tearing the service down.
                t1 = time.perf_counter()
                while svc._pending_persists and time.perf_counter() - t1 < 30:
                    svc.tick()
                persist_s = time.perf_counter() - t0 if snapshot_drain else freed_s
                svc._drain(reason="drill end")
                books = svc.books()
            finally:
                svc.close()
            arms[label] = {
                "snapshot_drain": snapshot_drain,
                "ckpt_format": fmt,
                "drain_to_slices_freed_s": round(freed_s, 4),
                "drain_to_persist_s": round(persist_s, 4),
                "slices_freed": freed_ok,
                "checkpoint_books": books.get("checkpoint"),
                "service_dir": d,
            }
    snap = arms["snapshot_v2"]["drain_to_slices_freed_s"]
    join = arms["join_v1"]["drain_to_slices_freed_s"]
    return {
        "device": device,
        "persist_delay_s": persist_delay_s,
        "arms": arms,
        "snapshot_faster": snap < join,
        "snapshot_unblocked": snap < persist_delay_s / 2,
        "speedup": round(join / snap, 1) if snap > 0 else None,
        "ok": bool(arms["snapshot_v2"]["slices_freed"] and arms["join_v1"]["slices_freed"] and snap < join
                   and snap < persist_delay_s / 2),
    }


def _preempted_before_persist(ledger_path: str, pending_tids: set) -> int:
    n = 0
    try:
        with open(ledger_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("status") == "preempted" and rec.get("trial_id") in pending_tids:
                    n += 1
    except OSError:
        pass
    return n


def run_deadline_phase(work_dir: str, *, persist_delay_s: float = 0.25, device: Optional[str] = None,
                       data_rows: Optional[int] = None, long_epochs: int = 20) -> dict:
    """The deadline drill under the snapshot drain: the whale preempts both
    best-effort trials (``long_epochs`` each, the JAX drill's 20 by
    default) and places without waiting for their persists; the ledger
    stays honest (``preempted`` only after the persist lands, checked live
    between ticks); the victims resume from the RAM snapshot (same
    process) and complete. Each epoch's checkpoint joins the previous
    one's delayed persist, so the victims' epochs cost the drill's wall
    time. Telemetry goes into the service directory when nothing
    configured it (and is turned off after); where it was on, it stays on,
    as found."""
    from multidisttorch_tpu_torch import telemetry
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy
    from multidisttorch_tpu_torch.service.runtime import SweepService
    from multidisttorch_tpu_torch.service.scheduler import PreemptionPolicy
    from multidisttorch_tpu_torch.telemetry import trace as ttrace
    from multidisttorch_tpu_torch.train import checkpoint as ck

    device = _device(device)
    base, shapes, rows = _sizes(device)
    rows = rows if data_rows is None else data_rows
    d = os.path.join(work_dir, "deadline")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    # Telemetry into the service dir: the trace renders the snapshot and
    # persist split inside the victims' attempt spans from these events.
    own_telemetry = not telemetry.enabled()
    if own_telemetry:
        telemetry.configure(os.path.join(d, "telemetry"))
    client = squeue.SweepClient(d, tenant="drill")
    policy = PreemptionPolicy(max_preemptions_per_trial=1, trial_cooldown_s=5.0, global_cooldown_s=0.05)
    svc = None
    ram0 = ck.ckpt_counters()["restores_ram"]
    honesty = {"observed_pending": False, "preempted_before_persist": 0, "slices_free_while_persisting": False}
    try:
        with _env(PERSIST_DELAY_ENV, str(persist_delay_s)):
            svc = SweepService(d, n_slices=2, max_lanes=1, data_rows=rows, defrag_enabled=False, preempt=policy,
                               snapshot_drain=True, ckpt_format="v2", retry=RetryPolicy(max_retries=2), device=device)
            subs = _fill_pool(svc, client, base=base, shapes=shapes, epochs=long_epochs)
            deadline_s = 120.0
            big = client.submit({**base, **shapes[2], "epochs": 1, "seed": 9}, size=2, deadline_s=deadline_s)
            submit_ts = time.time()
            placed_ts = None
            while time.time() - submit_ts < 150:
                svc.tick()
                whale_live = any(next(iter(ap.entries.values())).sub_id == big for ap in svc.active.values())
                if svc._pending_persists:
                    honesty["observed_pending"] = True
                    if svc.pool.free_total > 0 or whale_live:
                        # The snapshot drain's point: resources moved on while a
                        # victim's persist was still in flight.
                        honesty["slices_free_while_persisting"] = True
                    # While a victim's persist is in flight, its preempted
                    # record must not be in the ledger yet.
                    pending = {p.entry.trial_id for p in svc._pending_persists}
                    honesty["preempted_before_persist"] += _preempted_before_persist(svc.ledger.path, pending)
                if placed_ts is None and whale_live:
                    placed_ts = time.time()
                if svc.settled.get(big):
                    break
            big_status = svc.settled.get(big)
            big_settle_s = round(time.time() - submit_ts, 3)
            t0 = time.time()
            while len(svc.settled) < 3 and time.time() - t0 < 600:
                svc.tick()
            svc._drain(reason="drill end")
            books = svc.books()
    finally:
        if svc is not None:
            svc.close()
        if own_telemetry:
            telemetry.disable()
    # The offline trace must show the drain split: every victim's tree
    # carries a ckpt_persist SPAN (drain to durable) with real width.
    traces = ttrace.build_submission_traces(d)
    persist_spans = sum(
        1
        for sid in subs
        for s in (traces.get(sid) or {"spans": []})["spans"]
        if s["name"] == "ckpt_persist" and s["kind"] == "span" and s["end"] is not None
        and s["end"] - s["start"] > 0.01
    )
    ram_restores = ck.ckpt_counters()["restores_ram"] - ram0
    preempted_recs = 0
    try:
        with open(svc.ledger.path) as f:
            preempted_recs = sum(1 for line in f if '"preempted"' in line)
    except OSError:
        pass
    all_completed = len(svc.settled) == 3 and all(s == "completed" for s in svc.settled.values())
    return {
        "device": device,
        "persist_delay_s": persist_delay_s,
        "long_epochs": long_epochs,
        "deadline_submission": big,
        "deadline_s": deadline_s,
        "deadline_status": big_status,
        "settle_latency_s": big_settle_s,
        "whale_placed_after_s": round(placed_ts - submit_ts, 3) if placed_ts else None,
        "honesty": honesty,
        "preempted_records": preempted_recs,
        "ram_restores": ram_restores,
        "victims": subs,
        "all_completed": all_completed,
        "trace_persist_spans": persist_spans,
        "checkpoint_books": books.get("checkpoint") or {},
        "service_dir": d,
        "ok": bool(
            big_status == "completed"
            and big_settle_s < deadline_s
            and honesty["observed_pending"]
            and honesty["preempted_before_persist"] == 0
            and preempted_recs >= 2
            and ram_restores >= 1
            and persist_spans >= 2
            and all_completed
        ),
    }


def run_ckpt_bench(work_dir: str, *, device: Optional[str] = None) -> dict:
    """Every phase and its gate (the JAX ``bench.py --ckpt`` suite over the
    ported flavors)."""
    from multidisttorch_tpu_torch.train.checkpoint import reset_ckpt_counters

    device = _device(device)
    os.makedirs(work_dir, exist_ok=True)
    reset_ckpt_counters()
    parity = run_parity_phase(work_dir, device=device)
    delta = run_delta_phase(work_dir, device=device)
    primitive = run_drain_primitive_phase(work_dir, device=device)
    deadline = run_deadline_phase(work_dir, device=device)
    gates = {
        "restore_parity_ported_flavors": parity["ok"],
        "delta_ratio_below_half": delta["ok"],
        "snapshot_drain_faster_than_persist": primitive["ok"],
        "deadline_drill": deadline["ok"],
    }
    return {
        "kind": "ckpt_data_plane",
        "device": device,
        "parity": parity,
        "delta": delta,
        "drain_primitive": primitive,
        "deadline_drill": deadline,
        "not_ported": dict(NOT_PORTED),
        "gates": gates,
        "ok": all(gates.values()),
    }
