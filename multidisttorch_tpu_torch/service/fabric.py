"""The sharded service fabric: N daemon replicas, lease-fenced shards.

Counterpart of the JAX package's ``service/fabric.py``: sharding,
lease-fenced ownership, failover by adoption, and the elastic topology's
splits and work stealing. A :class:`~multidisttorch_tpu_torch.service.runtime.SweepService`
is a single controller, one process owning one host's slots; this module
distributes it while keeping the single-controller semantics *per shard*:

- **Sharding**: tenants map deterministically onto ``n_shards``
  submission shards (:func:`shard_of`, a stable CRC32, so every client and
  every replica agree with no coordination). Each shard is a complete
  service directory (``{service_dir}/shards/shard-k``: its own spool,
  ``queue.jsonl`` journal, ledger and checkpoints): the durable state IS
  the shard, and replicas are stateless movers. Routing goes through
  ``service/topology.py``, whose empty log is exactly this static routing.
- **Lease-fenced ownership**: a replica owns a shard by winning an
  epoch-numbered claim in the shard's append-only lease stream
  (``{service_dir}/fabric/shard-k.lease.jsonl``, the membership layer's
  torn-tail JSONL records, read by ``parallel/membership.py``'s
  ``read_lease`` and ``latest_lease``). Claims are lock-free: append
  ``epoch = max_seen + 1``, read back, the FIRST record at that epoch wins
  (``O_APPEND`` orders them). The epoch is a **fence token**: every
  journal and ledger append and every tick of the owning
  :class:`SweepService` first checks that no higher epoch exists, so a
  paused-and-resumed replica that lost its lease gets :class:`FenceLost`
  instead of double-placing work the new owner already re-homed.
- **Failover is adoption, not outage**: a replica renews its shard leases
  a few times a second; a SIGKILLed or wedged replica stops renewing, the
  lease goes stale past ``lease_deadline_s``, and a surviving replica
  claims the next epoch and ADOPTS the shard: a fresh ``SweepService``
  over the shard directory, whose journal fold replays every submission
  (settled stay settled; ever-placed re-enter ``resume_scan`` and restore
  from their durable checkpoints).
- **Elastic topology**: routing is ``fabric/topology.jsonl``
  (``service/topology.py``), an epoch-versioned split log. A hot shard
  SPLITS its tenant hash range in two (``split_begin``, then a fenced
  handoff of queued-but-unplaced submissions through
  :meth:`SweepService.extract_queued`, then ``split_commit``), the whole
  handoff fenced by the parent shard's lease: a replica killed mid-split
  leaves a *pending* split that the adopting replica completes
  idempotently or rolls back (``split_abort``, the child id burned). The
  child is not routable or adoptable until the commit, so no tenant is ever
  owned by two live shards; the splitting replica adopts the child at once.
  An idle shard's replica also WORK-STEALS queued submissions from a
  backlogged shard through a request and grant file
  (``fabric/shard-k.steal.jsonl``): the grant, naming the ids, is durable
  before the transfer, so an adopter carries out a grant that never ran. A
  stolen submission keeps its origin tenant, so the thief's fair-share
  scheduler charges the origin tenant. Splits and steals default off: a
  replica with neither option keeps the static topology.

**Renewal and long turns.** Leases are renewed only by the loop: at the
top of :meth:`FabricReplica.tick`, as in the JAX package, and also before
each shard service's tick (a deliberate divergence, ROADMAP "Deliberate
divergence"), so one turn over several shards holds no claim unrenewed
for all of them. Nothing renews while a turn is stuck, so a replica that
stops ticking, killed or wedged inside a turn, loses its shards within the
lease deadline plus the adopter's grace. On a card the seconds-long
starts (the context, the first allocation, the kernels' load, the lazy
imports of a trial's first step) happen in
:meth:`FabricReplica._warm_backend`, before any claim; the lease deadline
a deployment runs under is set above its longest measured turn (the
drill's ``CARD_LEASE_DEADLINE_S``). Each replica measures its longest
turn and its longest gap between renewals (``replica_turn`` events, the
serve report), so a turn that creeps towards the deadline shows; its
event carries the longest turn's seconds by part (adoption, split, steal,
each shard's placements and dispatches). A child shard born inside a turn
is renewed before its first tick like any other.

**The turn budget** (``turn_budget_s``; the CLI's default is a quarter of
the lease deadline, the class's None). A turn that built a shard's service
(an adoption, a split's child) ticks nothing more; any other turn ticks at
least one shard, and past the budget the rest of its shards' ticks and
their placements' dispatches wait for the next turn, which starts with
them (round robin). On a card one dispatch (a trial's first chunk, its
warm-up and capture, or its last, which joins the final checkpoint's
write) takes up to about a second, and a turn over three shards of two
placements each can hold several: the budget bounds a turn by about one.
It changes the order of dispatches, not what they compute.

No torch at module level: the fabric layer is file and lease logic (the
replica's ``SweepService``s and its warm-up import torch).
"""

from __future__ import annotations

import json
import os
import time
import zlib
from dataclasses import dataclass
from typing import Optional

from multidisttorch_tpu_torch.parallel.membership import latest_lease, read_lease
from multidisttorch_tpu_torch.service import queue as squeue
from multidisttorch_tpu_torch.service import topology as stopo
from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

FABRIC_DIRNAME = "fabric"
SHARDS_DIRNAME = "shards"
CONFIG_NAME = "fabric.json"

CLAIM = "claim"
RENEW = "renew"
RELEASE = "release"

# Transfer provenance kinds (Submission.moved_kind, the journal's
# ``moved`` record).
MOVE_SPLIT = "split"
MOVE_STEAL = "steal"


class FenceLost(RuntimeError):
    """This replica's shard lease was taken over (a higher fencing epoch
    exists): every further write to the shard is rejected. The replica
    drops the shard; the new owner's journal is now the truth."""


def _emit(kind: str, **data) -> None:
    from multidisttorch_tpu_torch.telemetry.events import get_bus

    bus = get_bus()
    if bus is not None:
        bus.emit(kind, **data)


def fabric_dir(service_dir: str) -> str:
    return os.path.join(service_dir, FABRIC_DIRNAME)


def shard_dir(service_dir: str, shard: int) -> str:
    return os.path.join(service_dir, SHARDS_DIRNAME, f"shard-{int(shard)}")


def lease_file(service_dir: str, shard: int) -> str:
    return os.path.join(fabric_dir(service_dir), f"shard-{int(shard)}.lease.jsonl")


def steal_file(service_dir: str, shard: int) -> str:
    """The shard's work-steal ledger: an append-only JSONL of thief
    ``request`` records and victim ``grant`` records (matched by ``seq``).
    The victim appends the grant, naming the exact submission ids, BEFORE it
    runs the transfer, so a victim killed mid-steal leaves a grant the
    adopting replica carries out (the split-completion pattern)."""
    return os.path.join(fabric_dir(service_dir), f"shard-{int(shard)}.steal.jsonl")


def _read_jsonl(path: str) -> list[dict]:
    """Decodable records in append order, a torn tail skipped: the queue
    layer's complete-lines reader, from offset 0."""
    return squeue.read_jsonl_from(path, 0)[0]


def shard_of(tenant: str, n_shards: int) -> int:
    """Deterministic tenant → shard assignment: stable across clients,
    replicas and restarts with zero coordination."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return zlib.crc32(str(tenant).encode()) % int(n_shards)


def ensure_fabric_config(service_dir: str, n_shards: int) -> dict:
    """Land (or read back) the fabric's shared config. First writer wins
    atomically; every later replica or client validates against it: two
    processes disagreeing about ``n_shards`` would route one tenant to two
    shards."""
    d = fabric_dir(service_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, CONFIG_NAME)
    if not os.path.exists(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"n_shards": int(n_shards)}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            # First writer wins: link fails if someone else already
            # landed the config.
            os.link(tmp, path)
        except FileExistsError:
            pass
        finally:
            os.unlink(tmp)
        squeue.fsync_dir(d)
    with open(path) as f:
        cfg = json.load(f)
    if int(cfg.get("n_shards", -1)) != int(n_shards):
        raise ValueError(
            f"fabric at {service_dir} is configured with {cfg.get('n_shards')} shards; this process asked for "
            f"{n_shards} — tenant routing would disagree"
        )
    return cfg


def read_fabric_config(service_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(fabric_dir(service_dir), CONFIG_NAME)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


# -- leases -----------------------------------------------------------


def _append_lease(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _max_epoch_tail(path: str) -> int:
    """Highest fencing epoch visible in the lease tail. O(1) per check:
    claims only ever append at the end, so the tail window always holds
    the newest epoch."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 8192))
            chunk = f.read().decode("utf-8", errors="replace")
    except OSError:
        return 0
    best = 0
    for line in chunk.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail, or the seek landed mid-line
        try:
            best = max(best, int(rec.get("epoch", 0)))
        except (TypeError, ValueError):
            continue
    return best


@dataclass
class ShardFence:
    """A won shard claim: ``(shard, epoch)`` is the fence token.

    :meth:`check` raises :class:`FenceLost` once any higher epoch exists in
    the lease stream; it is handed to the shard's ``SweepService`` (and
    through it the journal and the ledger) as their ``fence`` callable, so
    a stale replica cannot append one more record after losing the shard.
    Checks are throttled (``check_interval_s``), but a renewal always
    re-reads."""

    shard: int
    replica: int
    epoch: int
    path: str
    check_interval_s: float = 0.05

    _last_check: float = 0.0
    _lost: bool = False

    def holds(self, *, force: bool = False) -> bool:
        if self._lost:
            return False
        now = time.monotonic()
        if not force and now - self._last_check < self.check_interval_s:
            return True
        self._last_check = now
        if _max_epoch_tail(self.path) > self.epoch:
            self._lost = True
            return False
        return True

    def check(self) -> None:
        if not self.holds():
            raise FenceLost(
                f"shard {self.shard} lease lost by replica {self.replica}: a claim newer than epoch "
                f"{self.epoch} exists"
            )

    def renew(self) -> None:
        """Refresh the lease's staleness clock. A renewal is valid only
        while the fence still holds, checked with a forced re-read, so a
        paused replica's first renewal after resuming observes the takeover
        instead of overwriting it."""
        if not self.holds(force=True):
            raise FenceLost(f"shard {self.shard} lease lost by replica {self.replica} (discovered at renewal)")
        _append_lease(self.path, {"shard": self.shard, "replica": self.replica, "epoch": self.epoch,
                                  "status": RENEW, "ts": time.time()})

    def release(self) -> None:
        """Clean handback (graceful drain): the shard is claimable at once,
        with no staleness wait."""
        self._lost = True
        _append_lease(self.path, {"shard": self.shard, "replica": self.replica, "epoch": self.epoch,
                                  "status": RELEASE, "ts": time.time()})


def shard_owner(service_dir: str, shard: int) -> Optional[dict]:
    """Newest lease record of the shard (None = never claimed)."""
    return latest_lease(lease_file(service_dir, shard))


def shard_orphaned(service_dir: str, shard: int, *, lease_deadline_s: float, now: Optional[float] = None) -> bool:
    """Is this shard claimable? Never claimed, cleanly released, or its
    owner stopped renewing past the deadline (SIGKILL, wedge, partition:
    one verdict, like the membership layer's lost-host rule)."""
    rec = shard_owner(service_dir, shard)
    if rec is None:
        return True
    if rec.get("status") == RELEASE:
        return True
    t = time.time() if now is None else now
    return t - float(rec.get("ts", 0.0)) > lease_deadline_s


def try_claim(service_dir: str, shard: int, replica: int) -> Optional[ShardFence]:
    """One lock-free claim attempt: append ``max_epoch + 1``, read back,
    the first record at that epoch wins (``O_APPEND`` gives the total
    order). Returns the fence on a win, None on a lost race."""
    path = lease_file(service_dir, shard)
    epoch = _max_epoch_tail(path) + 1
    _append_lease(path, {"shard": int(shard), "replica": int(replica), "epoch": epoch, "status": CLAIM,
                         "ts": time.time()})
    # Read back the FULL stream for the winner-at-epoch verdict (claims
    # are rare; the hot-path holds() check stays tail-only).
    for rec in read_lease(path):
        try:
            rec_epoch = int(rec.get("epoch", 0))
        except (TypeError, ValueError):
            continue
        if rec_epoch == epoch and rec.get("status") == CLAIM:
            if int(rec.get("replica", -1)) == int(replica):
                return ShardFence(shard=int(shard), replica=int(replica), epoch=epoch, path=path)
            return None  # someone else's claim landed first
        if rec_epoch > epoch:
            return None  # already outbid while we were reading
    return None  # our own append did not land (fs error): no claim


# -- client -----------------------------------------------------------


class FabricClient:
    """Tenant-side API over a sharded fabric: routes each submission to
    its tenant's current owner under the topology (an empty log routes
    exactly like :func:`shard_of`) and folds status and wait across every
    live shard. The per-shard transport is the service's
    :class:`~multidisttorch_tpu_torch.service.queue.SweepClient`, durable
    at the rename, with no daemon connection.

    Wrong-shard self-healing: routing is read at submit time, so a
    topology change between a client's spool write and the daemon's
    intake drain lands the submission on a shard that no longer owns the
    tenant. The daemon rejects it with the ``rejected_wrong_shard``
    verdict and the client re-reads the topology and resubmits the SAME
    submission id to the current owner, bounded to ONE retry per id."""

    def __init__(self, service_dir: str, *, tenant: str = "default", n_shards: Optional[int] = None):
        self.service_dir = service_dir
        self.tenant = tenant
        if n_shards is None:
            cfg = read_fabric_config(service_dir)
            if cfg is None:
                raise ValueError(f"no fabric config under {service_dir} — pass n_shards or start a replica first")
            n_shards = int(cfg["n_shards"])
        self.n_shards = int(n_shards)
        self.topology = stopo.load_topology(service_dir, n_base=self.n_shards)
        # sub_id -> the shard it was resubmitted to (one retry each).
        self._wrong_shard_retries: dict[str, int] = {}

    def _reload_topology(self) -> None:
        self.topology = stopo.load_topology(self.service_dir, n_base=self.n_shards)

    def _shard_client(self, tenant: str) -> squeue.SweepClient:
        return squeue.SweepClient(shard_dir(self.service_dir, self.topology.route(tenant)), tenant=tenant)

    def shard_for(self, tenant: Optional[str] = None) -> int:
        return self.topology.route(self.tenant if tenant is None else tenant)

    def submit(self, config: dict, *, tenant: Optional[str] = None, **kw):
        ten = self.tenant if tenant is None else tenant
        c = self._shard_client(ten)
        sid = c.submit(config, tenant=ten, **kw)
        self.last_submission = c.last_submission  # the full receipt
        return sid

    @staticmethod
    def _superseded(rec: dict) -> bool:
        """True when another shard's journal owns the live story for this
        id: ``moved`` at the origin and wrong-shard rejections are terminal
        only AT THAT SHARD."""
        if rec["state"] == squeue.MOVED:
            return True
        return rec["state"] == squeue.REJECTED and rec.get("status") == squeue.REJECT_WRONG_SHARD

    def _folds(self) -> dict[str, dict]:
        """Merged fold across every live shard. An id in two journals: the
        destination's live record wins over the origin's terminal
        ``moved`` or wrong-shard record."""
        out: dict[str, dict] = {}
        for k in self.topology.live_shards():
            for sid, rec in squeue.fold_queue(squeue.load_queue(shard_dir(self.service_dir, k))).items():
                rec["shard"] = k
                cur = out.get(sid)
                if cur is None:
                    out[sid] = rec
                elif self._superseded(cur) and not self._superseded(rec):
                    out[sid] = rec
                elif self._superseded(cur) and self._superseded(rec) and self._wrong_shard_retries.get(sid) == k:
                    # Both terminal: the retry destination's verdict is
                    # the authoritative one (the bounded-retry stop).
                    out[sid] = rec
        return out

    def _retry_wrong_shard(self, folded: dict[str, dict]) -> bool:
        """The ONE bounded resubmit: for each freshly observed wrong-shard
        rejection, re-read the topology and spool the SAME submission id to
        the tenant's current owner. Returns whether anything was
        resubmitted."""
        resubmitted = False
        for sid, rec in folded.items():
            if rec["state"] != squeue.REJECTED or rec.get("status") != squeue.REJECT_WRONG_SHARD:
                continue
            if sid in self._wrong_shard_retries:
                continue
            self._reload_topology()
            owner = self.topology.route(rec.get("tenant", "default"))
            self._wrong_shard_retries[sid] = owner
            sub = squeue.Submission(
                submission_id=sid,
                tenant=rec.get("tenant", "default"),
                config=dict(rec.get("config") or {}),
                priority=int(rec.get("priority", 1)),
                size=int(rec.get("size", 1)),
                deadline_s=rec.get("deadline_s"),
                submit_ts=float(rec.get("submit_ts", 0.0)),
                trace_id=rec.get("trace_id", ""),
            )
            squeue.spool_submission(shard_dir(self.service_dir, owner), sub)
            _emit("wrong_shard_resubmit", sub_id=sid, tenant=sub.tenant, to_shard=int(owner),
                  from_shard=rec.get("shard"), trace=sub.trace_id)
            resubmitted = True
        return resubmitted

    def _terminal(self, sid: str, rec: dict) -> bool:
        if rec["state"] == squeue.SETTLED:
            return True
        if rec["state"] != squeue.REJECTED:
            return False  # PENDING/ADMITTED/PLACED/MOVED: in flight
        if rec.get("status") != squeue.REJECT_WRONG_SHARD:
            return True
        dest = self._wrong_shard_retries.get(sid)
        if dest is None:
            return False  # retry not attempted yet this poll
        # Terminal only when the RETRY itself was rejected (the one-retry
        # bound); the origin's stale record just means the destination
        # has not drained its spool yet.
        return rec.get("shard") == dest

    def status(self, submission_id: str) -> Optional[dict]:
        # The spool check BEFORE the journal folds (SweepClient.status's
        # order): a daemon draining the spool appends the durable record
        # first, then unlinks; checking the journals first leaves a window
        # where a committed submission reads as unknown.
        self._reload_topology()
        spooled = any(
            os.path.exists(os.path.join(squeue.intake_dir(shard_dir(self.service_dir, k)), submission_id + ".json"))
            for k in self.topology.live_shards()
        )
        folded = self._folds()
        self._retry_wrong_shard({submission_id: folded[submission_id]} if submission_id in folded else {})
        rec = folded.get(submission_id)
        if rec is not None:
            return rec
        if spooled:
            return {"state": squeue.PENDING, "submission_id": submission_id}
        return None

    def wait(self, submission_ids, *, timeout_s: float = 300.0, poll_s: float = 0.25) -> dict[str, dict]:
        ids = list(submission_ids)
        deadline = time.time() + timeout_s
        reloaded = 0.0
        while True:
            now = time.time()
            if now - reloaded > 1.0:
                self._reload_topology()
                reloaded = now
            folded = self._folds()
            out = {s: folded.get(s, {"state": squeue.PENDING, "submission_id": s}) for s in ids}
            self._retry_wrong_shard(out)
            if all(self._terminal(s, r) for s, r in out.items()):
                return out
            if time.time() > deadline:
                return out
            time.sleep(poll_s)


# -- replica ----------------------------------------------------------


class FabricReplica:
    """One fabric daemon: claims shards, runs one fenced
    :class:`SweepService` per owned shard, renews leases, and adopts
    orphaned shards (see module docstring). ``svc_kwargs`` pass through to
    every shard service (slots, lanes, policies, retry, preemption
    policy, ``device``...).

    ``injector`` (a :class:`~multidisttorch_tpu_torch.faults.inject.
    FaultInjector` armed with ``host_slot=replica``) rides the replica's
    cumulative dispatch clock, so the ``daemon_lost`` fault kind can
    SIGKILL a named replica mid-service."""

    def __init__(
        self,
        service_dir: str,
        *,
        replica: int,
        n_shards: int,
        lease_deadline_s: float = 3.0,
        renew_every_s: float = 0.5,
        adopt_scan_every_s: float = 0.5,
        prefer: Optional[set] = None,
        nonpreferred_grace_s: Optional[float] = None,
        injector=None,
        idle_sleep_s: float = 0.02,
        split_queue_depth: Optional[int] = None,
        split_trigger=None,
        split_min_interval_s: float = 2.0,
        steal_threshold: Optional[int] = None,
        steal_batch: int = 2,
        steal_scan_every_s: float = 0.5,
        turn_budget_s: Optional[float] = None,
        **svc_kwargs,
    ):
        self.service_dir = service_dir
        self.replica = int(replica)
        ensure_fabric_config(service_dir, n_shards)
        self.n_shards = int(n_shards)
        self.lease_deadline_s = float(lease_deadline_s)
        self.renew_every_s = float(renew_every_s)
        self.adopt_scan_every_s = float(adopt_scan_every_s)
        # Home-shard bias: a replica claims its PREFERRED shards the moment
        # they are orphaned, but waits an extra grace on anyone else's, so a
        # healthy fleet converges to one shard per replica without
        # coordination while a dead replica's shard still gets adopted.
        self.prefer: set = (
            set(prefer) if prefer is not None else ({self.replica} if self.replica < self.n_shards else set())
        )
        # Default grace = 3 leases: a cold peer's first claim is only a few
        # seconds behind (process start and the card's warm-up).
        self.nonpreferred_grace_s = float(
            nonpreferred_grace_s if nonpreferred_grace_s is not None else 3.0 * lease_deadline_s
        )
        self._orphan_seen: dict[int, float] = {}
        self.injector = injector
        self.idle_sleep_s = float(idle_sleep_s)
        self.svc_kwargs = dict(svc_kwargs)
        self.services: dict[int, object] = {}  # shard -> SweepService
        self.fences: dict[int, ShardFence] = {}
        # Terminal statuses of shards this replica served and then drained
        # or lost: the drain path pops services, so the final report must
        # not read only the (then empty) live map.
        self.settled_accum: dict[str, str] = {}
        self.adoptions = 0
        self.fences_lost = 0
        self._stop = False
        self._warm = False
        self._last_renew = 0.0
        self._last_scan = 0.0
        # Per-shard dispatch high-water marks: the fault clock must be
        # MONOTONIC across shard drops and adoptions.
        self._dispatch_seen: dict[int, int] = {}
        self.topology = stopo.load_topology(service_dir, n_base=self.n_shards)
        self._last_topo_load = 0.0
        # The elastic topology's options, all off by default (module
        # docstring). ``split_trigger(shard, svc) -> bool`` is an optional
        # richer trigger than the queue depth (an SLO burn verdict, say).
        self.split_queue_depth = None if split_queue_depth is None else int(split_queue_depth)
        self.split_trigger = split_trigger
        self.split_min_interval_s = float(split_min_interval_s)
        self.steal_threshold = None if steal_threshold is None else int(steal_threshold)
        self.steal_batch = int(steal_batch)
        self.steal_scan_every_s = float(steal_scan_every_s)
        # The turn budget (module docstring, "Renewal and long turns"):
        # None ticks every shard in every turn, as the JAX replica does.
        self.turn_budget_s = None if not turn_budget_s else float(turn_budget_s)
        self._tick_from = 0  # the shard a budgeted turn ticks first
        self._last_split = 0.0
        self._last_steal_scan = 0.0
        self._last_steal_req: dict[int, float] = {}  # victim -> ts
        self.splits = 0
        self.steals_granted = 0
        # What the loop measures of itself (module docstring).
        self._last_renew_pass: Optional[float] = None  # monotonic, while holding a fence
        self.turns = 0
        self.longest_turn_s = 0.0
        self.longest_unrenewed_s = 0.0
        # Where the current turn's seconds went, by part (``_lap``); the
        # longest turn's parts ride its ``replica_turn`` event.
        self._parts: dict[str, float] = {}

    # -- shard lifecycle ---------------------------------------------

    def _warm_backend(self) -> None:
        """Start the card BEFORE any claim is held: its context and first
        allocation on every slot's device, the ELBO kernels' library (built
        from the checkout or loaded), one product (cuBLAS's handle), and the
        import a trial's first optimizer step would make. On a fresh process
        these take seconds, which inside the claim→renew window would cost
        the shard to a peer."""
        if self._warm:
            return
        import torch
        # A trial's first optimizer step imports torch._dynamo lazily
        # (torch.optim's dynamo guard): seconds in a fresh process.
        import torch._dynamo  # noqa: F401

        from multidisttorch_tpu_torch.service.runtime import slots_for

        kw = self.svc_kwargs
        devs = sorted({str(d) for d in slots_for(kw.get("devices"), kw.get("n_slices"), kw.get("device"))})
        if any(d.startswith("cuda") for d in devs):
            from multidisttorch_tpu_torch.ops import elbo

            elbo._kernels()
            for dev in devs:
                x = torch.ones(8, 8, device=dev)
                (x @ x).sum().item()
        self._warm = True

    def _adopt(self, shard: int, fence: ShardFence) -> None:
        from multidisttorch_tpu_torch.service.runtime import SweepService
        from multidisttorch_tpu_torch.train.checkpoint import snapshot_cache

        d = shard_dir(self.service_dir, shard)
        os.makedirs(d, exist_ok=True)
        # RAM checkpoint snapshots are valid only under CONTINUOUS ownership
        # of their paths: if this process served the shard before, lost the
        # lease, and another replica wrote newer checkpoints, our cached
        # snapshots are stale. Adoption re-homing therefore always reads the
        # durable manifests, never our RAM.
        snapshot_cache().drop_under(d)
        t0 = time.perf_counter()
        t_claim = time.monotonic()

        def _route_check(tenant: str, _shard: int = shard) -> Optional[int]:
            # The daemon-side wrong-shard guard: reject a fresh intake
            # submission whose tenant routes elsewhere under the CURRENT
            # topology (the client resubmits to the owner). Moved-in
            # submissions bypass it in _admit: stolen work sits at a
            # non-owning shard on purpose.
            owner = self.topology.route(tenant)
            return owner if owner != _shard else None

        # fence_epoch stamps every journal and ledger record this
        # incarnation writes: the traces' evidence that a failover's span
        # tree is contiguous across the takeover.
        svc = SweepService(d, fence=fence.check, fence_epoch=fence.epoch, route_check=_route_check,
                           **self.svc_kwargs)
        self._lap(f"build{shard}", t_claim)
        try:
            # Construction (journal replay, dataset build) consumed lease
            # time: refresh it before the first tick, or drop the shard NOW
            # if someone outbid us mid-replay.
            fence.renew()
        except FenceLost as e:
            self.fences_lost += 1
            _emit("shard_fence_lost", shard=shard, replica=self.replica, reason=f"outbid during adoption replay: {e}")
            self._shutdown_service(svc)
            return
        now = time.monotonic()
        self.longest_unrenewed_s = max(self.longest_unrenewed_s, now - t_claim)
        if self._last_renew_pass is None:
            self._last_renew_pass = now
        self.services[shard] = svc
        self.fences[shard] = fence
        _emit(
            "shard_adopted",
            shard=shard,
            replica=self.replica,
            epoch=fence.epoch,
            replayed_submissions=len(svc.entries),
            settled_on_adoption=len(svc.settled),
            replay_s=round(time.perf_counter() - t0, 4),
        )
        # Unfinished business BEFORE the first tick places anything: a
        # predecessor killed mid-split left a pending topology record, one
        # killed mid-steal a grant without its transfer. Both complete (or
        # roll back) idempotently here, so the seam a crash opened is closed
        # while the shard's queue is still exactly as the journal replayed.
        t = time.monotonic()
        try:
            self._resolve_pending_split(shard)
            self._recover_steal_grants(shard)
        except FenceLost as e:
            self._drop(shard, reason=str(e))
        self._lap(f"resolve{shard}", t)

    @staticmethod
    def _shutdown_service(svc) -> None:
        """Release a SweepService's background resources (the dataset
        store's pool, the precapture farm) without writing under the shard:
        shared by every lose-the-shard path, so a replica that keeps losing
        races cannot leak worker threads. ``SweepService.close`` is not it:
        it lands pending persists, whose ledger records the fence would
        reject."""
        try:
            svc.store.shutdown(wait=True)
        except Exception:  # noqa: BLE001 — teardown must go on
            pass
        if svc._farm is not None:
            try:
                svc._farm.shutdown(wait=True)
            except Exception:  # noqa: BLE001
                pass
            svc._farm = None

    def _drop(self, shard: int, *, reason: str) -> None:
        """Lose a shard WITHOUT journaling: the new owner's recovery already
        wrote the truth (``unplaced`` for ever-placed work); one more record
        from us would interleave a stale story, which is what the fence
        exists to prevent. Local generators are closed (their graphs and
        device state go with them), in-flight checkpoint writes are joined
        (they land in the shared shard dir and can only help the adopter's
        scan-back restore)."""
        self.fences_lost += 1
        self.fences.pop(shard, None)
        svc = self.services.pop(shard, None)
        self._dispatch_seen.pop(shard, None)
        _emit("shard_fence_lost", shard=shard, replica=self.replica, reason=reason)
        if svc is None:
            return
        self.settled_accum.update(svc.settled)
        for ap in list(svc.active.values()):
            try:
                ap.gen.close()
            except Exception:  # noqa: BLE001 — teardown must go on
                pass
            try:
                ap.run._join_ckpt()
            except Exception:  # noqa: BLE001
                pass
        svc.active.clear()
        # Snapshot-drained victims' background persists land in the shared
        # shard dir, but their ledger bookkeeping must NOT run: the fence is
        # lost. Join the writes, drop the bookkeeping.
        for pend in list(svc._pending_persists):
            try:
                pend.ap.run._join_ckpt()
            except Exception:  # noqa: BLE001
                pass
        svc._pending_persists.clear()
        # Our RAM snapshots of this shard's trials die with the lease.
        from multidisttorch_tpu_torch.train.checkpoint import snapshot_cache

        snapshot_cache().drop_under(shard_dir(self.service_dir, shard))
        self._shutdown_service(svc)

    def _renew_leases(self, now: float) -> None:
        """Renew every held fence, at most once per ``renew_every_s``, and
        drop each shard whose fence a higher epoch has taken."""
        if now - self._last_renew < self.renew_every_s:
            return
        t = time.monotonic()
        if self.fences and self._last_renew_pass is not None:
            self.longest_unrenewed_s = max(self.longest_unrenewed_s, t - self._last_renew_pass)
        self._last_renew_pass = t if self.fences else None
        self._last_renew = now
        for fence in list(self.fences.values()):
            try:
                fence.renew()
            except FenceLost:
                pass
        lost = [shard for shard, fence in self.fences.items() if not fence.holds()]
        for shard in lost:
            self._drop(shard, reason=f"shard {shard} lease lost by replica {self.replica} (discovered at renewal)")

    def _scan_orphans(self, now: float) -> None:
        if now - self._last_scan < self.adopt_scan_every_s:
            return
        self._last_scan = now
        for shard in self.topology.live_shards():
            if shard in self.services:
                continue
            if not shard_orphaned(self.service_dir, shard, lease_deadline_s=self.lease_deadline_s, now=now):
                self._orphan_seen.pop(shard, None)
                continue
            if shard not in self.prefer:
                seen = self._orphan_seen.setdefault(shard, now)
                if now - seen < self.nonpreferred_grace_s:
                    continue  # give the home replica its head start
            fence = try_claim(self.service_dir, shard, self.replica)
            self._orphan_seen.pop(shard, None)
            if fence is None:
                continue  # lost the race: someone else adopted
            _emit("shard_claimed", shard=shard, replica=self.replica, epoch=fence.epoch)
            self.adoptions += 1
            self._adopt(shard, fence)

    def _reload_topology(self, now: Optional[float] = None, *, force: bool = False) -> None:
        if not force and now is not None and now - self._last_topo_load < self.adopt_scan_every_s:
            return
        self._last_topo_load = time.time() if now is None else now
        self.topology = stopo.load_topology(self.service_dir, n_base=self.n_shards)

    # -- elastic topology: splits ------------------------------------

    def _maybe_split(self, now: float) -> None:
        """The split trigger's scan. A shard is HOT when its queue depth
        reaches ``split_queue_depth`` or ``split_trigger(shard, svc)`` says
        so; at most one split per ``split_min_interval_s``: splitting is load
        shedding, not a reflex."""
        # Close any mid-split seam on shards we own first (adoption resolves
        # most; a topology reload can surface one later).
        for shard in list(self.services):
            if self.topology.pending_for(shard) is not None:
                try:
                    self._resolve_pending_split(shard)
                except FenceLost as e:
                    self._drop(shard, reason=str(e))
        if self.split_queue_depth is None and self.split_trigger is None:
            return
        if now - self._last_split < self.split_min_interval_s:
            return
        for shard in sorted(self.services):
            svc = self.services[shard]
            hot = self.split_queue_depth is not None and svc.sched.pending_count() >= self.split_queue_depth
            if not hot and self.split_trigger is not None:
                try:
                    hot = bool(self.split_trigger(shard, svc))
                except Exception:  # noqa: BLE001 — a broken trigger must
                    hot = False  # not take the replica down
            if not hot:
                continue
            self._last_split = now
            try:
                self._execute_split(shard)
            except FenceLost as e:
                self._drop(shard, reason=str(e))
            break  # one split per interval

    def _execute_split(self, shard: int) -> None:
        """Begin and complete one split of ``shard``'s tenant hash range.
        Both topology appends are first-writer-wins epoch races; the handoff
        between them is fenced by the parent's lease, and every step is
        crash-safe (:meth:`_resolve_pending_split` is the recovery half)."""
        self._reload_topology(force=True)
        if self.topology.pending_for(shard) is not None:
            self._resolve_pending_split(shard)
            return
        if shard not in self.topology.leaves:
            return  # a stale trigger: the shard is no longer live
        self.fences[shard].check()
        child = self.topology.next_shard_id()
        won, epoch, topo = stopo.append_topology_event(
            self.service_dir, {"event": stopo.SPLIT_BEGIN, "parent": int(shard), "child": int(child),
                               "replica": self.replica})
        self.topology = topo
        if not won:
            return  # lost the epoch race: re-evaluate at the next trigger
        self.splits += 1
        _emit("shard_split_begin", shard=int(shard), child=int(child), replica=self.replica, epoch=epoch)
        pend = topo.pending_for(shard)
        if pend is not None:
            self._complete_split(shard, pend)

    def _complete_split(self, shard: int, pend: stopo.PendingSplit) -> None:
        """The handoff and commit half: move every queued-but-unplaced
        submission whose tenant hashes into the child's half (the spool
        write, then the parent journal's ``moved`` record), then append
        ``split_commit``. The injector's split-handoff clock ticks once per
        handoff record: where ``shard_split_lost`` SIGKILLs the replica."""
        svc = self.services[shard]
        fence = self.fences[shard]
        topo = self.topology
        parent, child = pend.parent, pend.child
        _keep, give = topo.split_halves(parent, child)

        def pred(entry) -> bool:
            return give.matches(stopo.tenant_hash(entry.tenant), topo.n_base)

        on_moved = None
        if self.injector is not None:
            on_moved = lambda _sid: self.injector.split_step(1)  # noqa: E731
        move = dict(dest_dir=shard_dir(self.service_dir, child), dest_shard=child, from_shard=parent,
                    kind=MOVE_SPLIT, on_moved=on_moved)
        moved = svc.extract_queued(pred, **move)
        fence.check()
        committed = False
        for _ in range(8):
            won, _epoch, topo2 = stopo.append_topology_event(
                self.service_dir, {"event": stopo.SPLIT_COMMIT, "parent": int(parent), "child": int(child),
                                   "replica": self.replica})
            self.topology = topo2
            if won:
                committed = True
                break
            if topo2.pending_for(parent) is None:
                # Resolved concurrently (an adopter beat us to it):
                # committed iff the child is live.
                committed = child in topo2.leaves
                break
        if not committed:
            return
        _emit("shard_split_commit", shard=int(parent), child=int(child), replica=self.replica,
              epoch=self.topology.epoch, moved=len(moved))
        # Stragglers admitted between the transfer pass and the commit: one
        # more idempotent pass (they now route to the child, and left here
        # they would sit at a non-owner until a steal found them).
        svc.extract_queued(pred, **move)
        # The splitting replica births the child's service at once (the
        # orphan scan would get there only after the non-preferred grace).
        self._try_adopt(child)

    def _resolve_pending_split(self, shard: int) -> None:
        """Close a predecessor's mid-split seam, idempotently: if the crashed
        owner moved ANYTHING (journal ``moved`` records toward the child,
        spool files in the child's intake) or queued work still matches the
        child's half, re-run the transfer and commit; a split that moved
        nothing rolls back with ``split_abort`` (its child id is burned,
        never recycled)."""
        self._reload_topology(force=True)
        pend = self.topology.pending_for(shard)
        if pend is None:
            return
        svc = self.services.get(shard)
        if svc is None:
            return
        parent, child = pend.parent, pend.child
        svc._advance_folds()
        evidence = any(rec.get("state") == squeue.MOVED and rec.get("moved_to") == child
                       for rec in svc._qfold.values())
        if not evidence:
            try:
                evidence = any(n.endswith(".json")
                               for n in os.listdir(squeue.intake_dir(shard_dir(self.service_dir, child))))
            except OSError:
                pass
        if not evidence:
            _keep, give = self.topology.split_halves(parent, child)
            evidence = any(not e.resume_scan and e.pinned_start is None
                           and give.matches(stopo.tenant_hash(e.tenant), self.topology.n_base)
                           for e in svc.sched.pending_entries())
        if evidence:
            self._complete_split(shard, pend)
            # An adopter closing a PREDECESSOR's mid-split seam: a torn
            # split, distinct from both the normal commit and the no-op
            # abort.
            _emit("shard_split_resolved", shard=int(parent), child=int(child), replica=self.replica,
                  action="commit")
            return
        for _ in range(8):
            won, _epoch, topo2 = stopo.append_topology_event(
                self.service_dir, {"event": stopo.SPLIT_ABORT, "parent": int(parent), "child": int(child),
                                   "replica": self.replica})
            self.topology = topo2
            if won or topo2.pending_for(parent) is None:
                break
        _emit("shard_split_abort", shard=int(parent), child=int(child), replica=self.replica,
              epoch=self.topology.epoch)
        _emit("shard_split_resolved", shard=int(parent), child=int(child), replica=self.replica, action="abort")

    def _try_adopt(self, shard: int) -> None:
        if shard in self.services:
            return
        fence = try_claim(self.service_dir, shard, self.replica)
        if fence is None:
            return
        _emit("shard_claimed", shard=int(shard), replica=self.replica, epoch=fence.epoch)
        self.adoptions += 1
        self._adopt(shard, fence)

    # -- elastic topology: work stealing ------------------------------

    def _steal_tick(self, now: float) -> None:
        """Both halves of the steal protocol, one throttled pass. VICTIM:
        answer every unanswered request on shards we own (the grant first,
        then the fenced transfer). THIEF: when one of our shards is idle with
        a free slot, append a request to another live shard's steal file."""
        if self.steal_threshold is None:
            return
        if now - self._last_steal_scan < self.steal_scan_every_s:
            return
        self._last_steal_scan = now
        for shard in list(self.services):
            try:
                self._serve_steals(shard)
            except FenceLost as e:
                self._drop(shard, reason=str(e))
        idle_shards = [k for k, svc in self.services.items()
                       if not svc.active and svc.sched.pending_count() == 0 and svc.pool.free_total > 0]
        if not idle_shards:
            return
        thief = min(idle_shards)
        for victim in self.topology.live_shards():
            if victim == thief:
                continue
            if now - self._last_steal_req.get(victim, 0.0) < 4.0 * self.steal_scan_every_s:
                continue
            path = steal_file(self.service_dir, victim)
            recs = _read_jsonl(path)
            answered = {r.get("seq") for r in recs if r.get("kind") == "grant"}
            if any(r.get("kind") == "request" and int(r.get("thief_replica", -1)) == self.replica
                   and r.get("seq") not in answered for r in recs):
                continue  # one outstanding request per victim
            seq = os.urandom(6).hex()
            _append_lease(path, {"kind": "request", "seq": seq, "thief_shard": int(thief),
                                 "thief_replica": self.replica, "max_n": self.steal_batch, "ts": time.time()})
            self._last_steal_req[victim] = now
            _emit("steal_request", victim_shard=int(victim), thief_shard=int(thief), replica=self.replica, seq=seq)
            break  # one request per pass

    def _serve_steals(self, shard: int) -> None:
        """Victim side: answer the unanswered requests on an owned shard. The
        grant, naming the exact submission ids, is appended BEFORE the
        transfer runs, so a crash mid-steal leaves a durable intent the
        adopter carries out (:meth:`_recover_steal_grants`). A victim whose
        queue is under the threshold answers with an empty grant (a refusal
        the thief's backoff respects)."""
        svc = self.services.get(shard)
        fence = self.fences.get(shard)
        if svc is None or fence is None:
            return
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        path = steal_file(self.service_dir, shard)
        recs = _read_jsonl(path)
        if not recs:
            if prof is not None:
                prof.note("steal_grant", _t)
            return
        scanned = len(recs)
        granted = 0
        answered = {r.get("seq") for r in recs if r.get("kind") == "grant"}
        for r in recs:
            if r.get("kind") != "request" or r.get("seq") in answered:
                continue
            sub_ids: list[str] = []
            if svc.sched.pending_count() >= self.steal_threshold:
                max_n = max(1, min(int(r.get("max_n", 1)), self.steal_batch))
                # Steal from the queue's TAIL (newest first): the oldest
                # entries are closest to placement here.
                for e in reversed(svc.sched.pending_entries()):
                    scanned += 1
                    if e.resume_scan or e.pinned_start is not None:
                        continue
                    sub_ids.append(e.sub_id)
                    if len(sub_ids) >= max_n:
                        break
            fence.check()
            thief_shard = int(r.get("thief_shard", -1))
            _append_lease(path, {"kind": "grant", "seq": r.get("seq"), "sub_ids": sub_ids,
                                 "thief_shard": thief_shard, "thief_replica": r.get("thief_replica"),
                                 "epoch": fence.epoch, "ts": time.time()})
            answered.add(r.get("seq"))
            _emit("steal_grant", victim_shard=int(shard), thief_shard=thief_shard, replica=self.replica,
                  seq=r.get("seq"), n=len(sub_ids))
            if sub_ids:
                moved = self._execute_grant(shard, svc, thief_shard=thief_shard, sub_ids=sub_ids)
                self.steals_granted += len(moved)
                granted += len(moved)
        if prof is not None:
            # examined = steal-file records and the queue entries scanned for
            # grantable work; mutated = submissions actually moved.
            prof.note("steal_grant", _t, examined=scanned, mutated=granted)

    def _execute_grant(self, shard: int, svc, *, thief_shard: int, sub_ids: list) -> list:
        wanted = set(sub_ids)
        moved = svc.extract_queued(lambda e: e.sub_id in wanted, dest_dir=shard_dir(self.service_dir, thief_shard),
                                   dest_shard=int(thief_shard), from_shard=int(shard), kind=MOVE_STEAL)
        if moved:
            _emit("steal_executed", victim_shard=int(shard), thief_shard=int(thief_shard), replica=self.replica,
                  sub_ids=moved)
        return moved

    def _recover_steal_grants(self, shard: int) -> None:
        """The adoption half of the steal protocol: a grant whose named
        submissions are STILL queued here never got its transfer (the victim
        died between intent and execution): run it now. A transferred id has
        a terminal ``moved`` record, so recovery dropped it from the
        scheduler and this pass skips it: an exactly-once handoff from an
        at-least-once replay."""
        svc = self.services.get(shard)
        if svc is None:
            return
        for r in _read_jsonl(steal_file(self.service_dir, shard)):
            if r.get("kind") != "grant" or not r.get("sub_ids"):
                continue
            queued = {e.sub_id for e in svc.sched.pending_entries()}
            still = [s for s in r["sub_ids"] if s in queued]
            if still:
                moved = self._execute_grant(shard, svc, thief_shard=int(r.get("thief_shard", -1)), sub_ids=still)
                self.steals_granted += len(moved)

    # -- the loop -----------------------------------------------------

    def _lap(self, part: str, t0: float) -> float:
        """Add the seconds since ``t0`` to this turn's ``part``; returns now.
        Nested parts (a shard's build inside ``adopt``) are counted in both."""
        t = time.monotonic()
        self._parts[part] = self._parts.get(part, 0.0) + t - t0
        return t

    def tick(self) -> bool:
        t0 = time.monotonic()
        self._parts = {}
        try:
            return self._turn()
        finally:
            self.turns += 1
            dt = time.monotonic() - t0
            if dt > self.longest_turn_s:
                self.longest_turn_s = dt
                _emit("replica_turn", replica=self.replica, longest_turn_s=round(dt, 4),
                      longest_unrenewed_s=round(self.longest_unrenewed_s, 4),
                      lease_deadline_s=self.lease_deadline_s, turn=self.turns,
                      parts={k: round(v, 4) for k, v in self._parts.items()})

    def _turn(self) -> bool:
        now = time.time()
        t = t_turn = time.monotonic()
        self._renew_leases(now)
        self._reload_topology(now)
        t = self._lap("renew", t)
        held = set(self.services)
        self._scan_orphans(now)
        t = self._lap("adopt", t)
        self._maybe_split(now)
        t = self._lap("split", t)
        self._steal_tick(now)
        t = self._lap("steal", t)
        progressed = False
        shards = list(self.services)
        deadline = None
        if self.turn_budget_s is not None:
            if set(self.services) - held:
                # A turn that built a shard's service (an adoption, a
                # split's child) ticks nothing more: the shards' first
                # ticks, which place and warm up trials, start the next.
                return True
            deadline = t_turn + self.turn_budget_s
            shards = [k for k in shards if k >= self._tick_from] + [k for k in shards if k < self._tick_from]
        for i, shard in enumerate(shards):
            svc = self.services.get(shard)
            if svc is None:
                continue
            if deadline is not None:
                # At least one shard's tick per turn; past the budget the
                # rest wait for the next turn, which starts with them.
                if i > 0 and time.monotonic() >= deadline:
                    break
                self._tick_from = shard + 1
            # A renewal before each shard's tick as well: one turn over
            # several shards holds no claim unrenewed for all of them.
            self._renew_leases(time.time())
            if shard not in self.services:
                continue
            t = time.monotonic()
            try:
                if svc.tick() if deadline is None else svc.tick(deadline):
                    progressed = True
            except FenceLost as e:
                self._drop(shard, reason=str(e))
            self._lap(f"tick{shard}", t)
            for part, sec in getattr(svc, "tick_parts", {}).items():
                self._parts[f"{part}{shard}"] = self._parts.get(f"{part}{shard}", 0.0) + sec
        if self.injector is not None:
            # The replica's cumulative dispatch clock feeds the daemon_lost
            # fault kind (a SIGKILL: no cleanup, leases go stale, survivors
            # adopt). Per-shard high-water deltas keep it monotonic across
            # drops and adoptions.
            delta = 0
            for shard, svc in self.services.items():
                cur = int(getattr(svc, "dispatches", 0))
                prev = self._dispatch_seen.get(shard, 0)
                if cur > prev:
                    delta += cur - prev
                    self._dispatch_seen[shard] = cur
            if delta > 0:
                self.injector.host_step(delta)
        return progressed

    def stop(self) -> None:
        self._stop = True

    def idle(self) -> bool:
        """Nothing running or claimable anywhere: every owned shard is idle
        AND every unowned shard is quiescent (no spool files, no
        non-terminal journal state): a survivor must adopt and finish an
        orphan's backlog before idling out."""
        for svc in self.services.values():
            if not svc.idle():
                return False
        if self.topology.pending:
            # A pending split is unfinished business: this replica, on its
            # next tick, or an adopter must complete or roll it back first.
            return False
        for shard in self.topology.live_shards():
            if shard in self.services:
                continue
            d = shard_dir(self.service_dir, shard)
            try:
                if any(n.endswith(".json") for n in os.listdir(squeue.intake_dir(d))):
                    return False
            except OSError:
                pass
            folded = squeue.fold_queue(squeue.load_queue(d))
            if any(r["state"] not in (squeue.SETTLED, squeue.REJECTED) for r in folded.values()):
                return False
        return True

    def drain(self, *, reason: str) -> None:
        """Drain every owned shard's service and release its lease, renewing
        before each shard's drain as a turn renews before each shard's
        tick."""
        for shard in list(self.services):
            self._renew_leases(time.time())
            svc = self.services.get(shard)
            if svc is None:
                continue
            self.settled_accum.update(svc.settled)
            try:
                svc._drain(reason=reason)
            except FenceLost as e:
                self._drop(shard, reason=str(e))
                continue
            fence = self.fences.pop(shard, None)
            if fence is not None:
                try:
                    fence.release()
                    _emit("shard_released", shard=shard, replica=self.replica, epoch=fence.epoch)
                except FenceLost:
                    pass
            self.services.pop(shard, None)
            self._dispatch_seen.pop(shard, None)
            self._shutdown_service(svc)

    def serve(self, *, max_wall_s: Optional[float] = None, exit_when_drained: bool = False,
              idle_grace_s: float = 1.0) -> dict:
        t0 = time.time()
        idle_since: Optional[float] = None
        self._warm_backend()
        _emit("replica_start", replica=self.replica, n_shards=self.n_shards)
        outcome = "drained"
        try:
            while True:
                if self._stop:
                    self.drain(reason="graceful drain (stop requested)")
                    outcome = "preempted"
                    break
                if max_wall_s is not None and time.time() - t0 > max_wall_s:
                    self.drain(reason="wall budget exhausted")
                    outcome = "wall_budget"
                    break
                progressed = self.tick()
                if exit_when_drained and self.idle():
                    if idle_since is None:
                        idle_since = time.time()
                    elif time.time() - idle_since >= idle_grace_s:
                        outcome = "idle"
                        break
                else:
                    idle_since = None
                if not progressed:
                    time.sleep(self.idle_sleep_s)
        except BaseException as exc:
            try:
                self.drain(reason=f"replica exception: {type(exc).__name__}: {exc}")
            except Exception:  # noqa: BLE001
                pass
            raise
        settled = dict(self.settled_accum)
        for svc in self.services.values():
            settled.update(svc.settled)
        wall_s = round(time.time() - t0, 3)
        _emit("replica_end", replica=self.replica, outcome=outcome, adoptions=self.adoptions,
              fences_lost=self.fences_lost, splits=self.splits, steals_granted=self.steals_granted,
              longest_turn_s=round(self.longest_turn_s, 4),
              longest_unrenewed_s=round(self.longest_unrenewed_s, 4), wall_s=wall_s)
        return {
            "outcome": outcome,
            "replica": self.replica,
            "adoptions": self.adoptions,
            "fences_lost": self.fences_lost,
            "splits": self.splits,
            "steals_granted": self.steals_granted,
            "topology_epoch": self.topology.epoch,
            "turns": self.turns,
            "longest_turn_s": round(self.longest_turn_s, 4),
            "longest_unrenewed_s": round(self.longest_unrenewed_s, 4),
            "lease_deadline_s": self.lease_deadline_s,
            "wall_s": wall_s,
            "settled": settled,
        }


def fabric_health(service_dir: str, *, lease_deadline_s: float = 3.0) -> dict:
    """One health snapshot for the console and the books: per-shard owner,
    fencing epoch, lease age and verdict (``alive``/``stale``/
    ``released``/``unclaimed``)."""
    cfg = read_fabric_config(service_dir)
    if cfg is None:
        return {"n_shards": 0, "shards": {}}
    topo = stopo.load_topology(service_dir, n_base=int(cfg["n_shards"]))
    now = time.time()
    shards = {}
    for k in topo.live_shards():
        rec = shard_owner(service_dir, k)
        if rec is None:
            shards[k] = {"state": "unclaimed"}
            continue
        age = now - float(rec.get("ts", 0.0))
        if rec.get("status") == RELEASE:
            state = "released"
        elif age > lease_deadline_s:
            state = "stale"
        else:
            state = "alive"
        shards[k] = {"state": state, "replica": rec.get("replica"), "epoch": rec.get("epoch"),
                     "lease_age_s": round(age, 3)}
    return {"n_shards": int(cfg["n_shards"]), "shards": shards, "topology": topo.describe()}
