"""Elastic shard topology: an epoch-versioned split/merge log.

Counterpart of the JAX package's ``service/topology.py``, the same file
with the imports renamed (held to it by ``tests/test_torch_fabric.py``).
The port's fabric routes every client and replica through it, and a
replica's shard split appends its events here (``split_begin``, then
``split_commit`` or ``split_abort``: ``service/fabric.py``); a fabric
that never splits keeps an empty log, which routes as static routing does.

Static routing fixes tenant→shard at ``fabric.json`` creation time
(CRC over a fixed ``n_shards``), and a hot shard could never shed
load. This module makes the
topology itself a durable, replayable artifact: an append-only JSONL
log (``{service_dir}/fabric/topology.jsonl``) of split/merge events,
folded with the queue journal's torn-tail contract into a routing
table every client and replica agrees on.

Routing model (extendible hashing over the CRC the fabric already
uses): ``h = crc32(tenant)`` picks a BASE CELL ``b = h % n_base``
(``n_base`` is the original ``fabric.json`` shard count, so an empty
log routes exactly like the static fabric — old directories keep
working byte-identically). Within a cell, the remaining hash bits
``q = h // n_base`` are refined by a binary trie: each *leaf*
``(base, depth, bits)`` owns the tenants whose low ``depth`` bits of
``q`` equal ``bits``, and each leaf maps to exactly one shard id.
Splitting a leaf at depth ``d`` creates two children at depth
``d + 1``: the parent shard keeps the ``bit d == 0`` half and a fresh
shard id takes the ``bit d == 1`` half. A merge is the exact inverse
(the child leaf folds back into its sibling parent). Leaves partition
each cell's suffix space by construction, so **every tenant routes to
exactly one live shard at every epoch** — the property test's
invariant (the JAX package's tests/test_topology.py).

Epoch discipline (the lease file's first-writer-wins pattern): every
record carries ``epoch = <max epoch in log> + 1``; writers append
under ``O_APPEND`` and read back — the FIRST record at an epoch wins
and the fold ignores any record whose epoch does not strictly
increase, so two racing writers can never both commit. Split commits
are two-phase (``split_begin`` → transfer → ``split_commit``) with
the transfer itself fenced by the parent shard's lease: a replica
killed mid-split leaves a *pending* split in the log, and whoever
adopts the parent shard either completes it idempotently or appends
``split_abort`` (docs/SERVICE.md "Shard topology").

Crash model: appends land whole or tear the final line; the fold
skips undecodable lines, so a torn tail costs at most the *last
event* — routing falls back to the previous epoch, never to garbage.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from dataclasses import dataclass
from typing import Optional

from multidisttorch_tpu_torch.service.queue import fsync_dir
from multidisttorch_tpu_torch.telemetry import ctlprof as _ctlprof

TOPOLOGY_NAME = "topology.jsonl"

# Event kinds. ``split_begin`` opens a PENDING split (the child shard
# is NOT yet live/routable — no replica may claim it, which is what
# makes double-ownership structurally impossible); ``split_commit``
# makes it live; ``split_abort`` rolls it back; ``merge`` folds a
# child leaf back into its sibling parent in one committed event (a
# merge moves work toward an already-owned shard, so it needs no
# pending phase).
SPLIT_BEGIN = "split_begin"
SPLIT_COMMIT = "split_commit"
SPLIT_ABORT = "split_abort"
MERGE = "merge"


def tenant_hash(tenant: str) -> int:
    """The ONE tenant hash (identical to ``fabric.shard_of``'s CRC)."""
    return zlib.crc32(str(tenant).encode("utf-8"))


def topology_path(service_dir: str) -> str:
    from multidisttorch_tpu_torch.service.fabric import fabric_dir

    return os.path.join(fabric_dir(service_dir), TOPOLOGY_NAME)


@dataclass(frozen=True)
class Leaf:
    """One routing leaf: shard ``shard`` owns the tenants of base cell
    ``base`` whose low ``depth`` bits of ``h // n_base`` equal
    ``bits``."""

    shard: int
    base: int
    depth: int
    bits: int

    def matches(self, h: int, n_base: int) -> bool:
        if h % n_base != self.base:
            return False
        q = h // n_base
        return (q & ((1 << self.depth) - 1)) == self.bits

    def children(self, child_shard: int) -> tuple["Leaf", "Leaf"]:
        """The two leaves a split of this leaf produces: the parent
        shard keeps the 0-bit half, ``child_shard`` takes the 1-bit
        half."""
        d = self.depth
        keep = Leaf(self.shard, self.base, d + 1, self.bits)
        give = Leaf(child_shard, self.base, d + 1, self.bits | (1 << d))
        return keep, give


@dataclass(frozen=True)
class PendingSplit:
    """A ``split_begin`` without its commit/abort yet: the handoff the
    parent's (current or adopting) owner must finish or roll back."""

    parent: int
    child: int
    epoch: int
    replica: int


class Topology:
    """The folded routing state at some epoch (immutable by
    convention: replicas re-load rather than mutate)."""

    def __init__(self, n_base: int):
        if n_base < 1:
            raise ValueError(f"n_base must be >= 1, got {n_base}")
        self.n_base = int(n_base)
        # shard id -> Leaf (committed, live, routable).
        self.leaves: dict[int, Leaf] = {
            k: Leaf(k, k, 0, 0) for k in range(self.n_base)
        }
        self.pending: list[PendingSplit] = []
        self.epoch = 0
        self._ever: set[int] = set(self.leaves)

    # -- routing ------------------------------------------------------

    def route(self, tenant: str) -> int:
        """The ONE live shard this tenant routes to (committed events
        only — a pending split changes nothing until its commit)."""
        return self.route_hash(tenant_hash(tenant))

    def route_hash(self, h: int) -> int:
        prof = _ctlprof.get_ctlprof()
        if prof is not None:
            _t = prof.t0()
        b = h % self.n_base
        q = h // self.n_base
        # Deepest-match walk: exactly one leaf matches because leaves
        # partition each cell's suffix space (split/merge preserve it).
        # O(leaves) per route — ctlprof's ``topo_route`` examined count
        # is the evidence a per-base leaf index would erase.
        best: Optional[Leaf] = None
        for leaf in self.leaves.values():
            if leaf.base != b:
                continue
            if (q & ((1 << leaf.depth) - 1)) == leaf.bits:
                if best is None or leaf.depth > best.depth:
                    best = leaf
        if prof is not None:
            prof.note("topo_route", _t, examined=len(self.leaves), mutated=1)
        if best is None:  # unreachable unless the log was corrupted
            return b
        return best.shard

    def live_shards(self) -> list[int]:
        return sorted(self.leaves)

    def next_shard_id(self) -> int:
        """A shard id never used before (committed, pending, or
        aborted — aborted ids are burned, not recycled, so a stale
        replica's references can never alias a new shard)."""
        return max(self._ever) + 1

    def pending_for(self, parent: int) -> Optional[PendingSplit]:
        for p in self.pending:
            if p.parent == parent:
                return p
        return None

    def split_halves(
        self, parent: int, child: int
    ) -> tuple[Leaf, Leaf]:
        """The (keep, give) leaves a split of ``parent``'s current leaf
        would produce — the handoff predicate: a queued submission
        moves iff ``give.matches(tenant_hash(t), n_base)``."""
        return self.leaves[parent].children(child)

    # -- fold ---------------------------------------------------------

    def apply(self, ev: dict) -> bool:
        """Fold one log record; returns True if it applied. Records
        whose epoch does not strictly increase LOST the append race
        (or replay an already-applied event) and are ignored, as are
        structurally invalid events — the fold never corrupts routing
        on a bad record, it just skips it."""
        try:
            epoch = int(ev.get("epoch", -1))
            kind = ev.get("event")
        except (TypeError, ValueError):
            return False
        if epoch <= self.epoch:
            return False
        if kind == SPLIT_BEGIN:
            parent = int(ev["parent"])
            child = int(ev["child"])
            if parent not in self.leaves or child in self._ever:
                return False
            if self.pending_for(parent) is not None:
                return False
            self.pending.append(
                PendingSplit(
                    parent=parent,
                    child=child,
                    epoch=epoch,
                    replica=int(ev.get("replica", -1)),
                )
            )
            self._ever.add(child)
            self.epoch = epoch
            return True
        if kind in (SPLIT_COMMIT, SPLIT_ABORT):
            parent = int(ev["parent"])
            child = int(ev["child"])
            pend = self.pending_for(parent)
            if pend is None or pend.child != child:
                return False
            self.pending.remove(pend)
            if kind == SPLIT_COMMIT:
                keep, give = self.leaves[parent].children(child)
                self.leaves[parent] = keep
                self.leaves[child] = give
            self.epoch = epoch
            return True
        if kind == MERGE:
            parent = int(ev["parent"])
            child = int(ev["child"])
            pl = self.leaves.get(parent)
            cl = self.leaves.get(child)
            if pl is None or cl is None:
                return False
            # Only true siblings merge: same cell, same depth, and the
            # child is the parent's 1-bit half.
            if (
                pl.base != cl.base
                or pl.depth != cl.depth
                or pl.depth < 1
                or cl.bits != (pl.bits | (1 << (pl.depth - 1)))
                or pl.bits & (1 << (pl.depth - 1))
            ):
                return False
            if self.pending_for(parent) or self.pending_for(child):
                return False
            del self.leaves[child]
            self.leaves[parent] = Leaf(
                parent, pl.base, pl.depth - 1, pl.bits
            )
            self.epoch = epoch
            return True
        return False

    def describe(self) -> dict:
        """Books/bench view of the routing table."""
        return {
            "epoch": self.epoch,
            "n_base": self.n_base,
            "shards": {
                str(k): {
                    "base": leaf.base,
                    "depth": leaf.depth,
                    "bits": leaf.bits,
                }
                for k, leaf in sorted(self.leaves.items())
            },
            "pending_splits": [
                {"parent": p.parent, "child": p.child, "epoch": p.epoch}
                for p in self.pending
            ],
        }


def fold_topology(n_base: int, events: list[dict]) -> Topology:
    topo = Topology(n_base)
    for ev in events:
        if isinstance(ev, dict):
            topo.apply(ev)
    return topo


def load_topology_events(service_dir: str) -> list[dict]:
    """All decodable log records in append order, torn tail skipped
    (the queue journal's read contract)."""
    path = topology_path(service_dir)
    events: list[dict] = []
    try:
        f = open(path)
    except OSError:
        return events
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict):
                events.append(ev)
    return events


def load_topology(service_dir: str, n_base: Optional[int] = None) -> Topology:
    """The current topology: the log folded over the ``fabric.json``
    base shard count. With no log (pre-split fabric, or a plain
    static-era directory) this is the identity topology — routing is
    byte-identical to the static ``shard_of``."""
    if n_base is None:
        from multidisttorch_tpu_torch.service.fabric import read_fabric_config

        n_base = int(read_fabric_config(service_dir)["n_shards"])
    return fold_topology(n_base, load_topology_events(service_dir))


def append_topology_event(
    service_dir: str, record: dict
) -> tuple[bool, int, Topology]:
    """Append one event with ``epoch = max + 1`` and read back.

    The lease file's first-writer-wins protocol: the append lands under
    ``O_APPEND`` (atomic whole-line ordering), then the full log is
    re-read — if OUR record is the first at its epoch we won; a racing
    writer's record at the same epoch is ignored by every fold.
    Returns ``(won, epoch, topology_after)`` where ``topology_after``
    is the folded state including the winning record."""
    path = topology_path(service_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    events = load_topology_events(service_dir)
    epoch = max((int(e.get("epoch", 0)) for e in events), default=0) + 1
    nonce = os.urandom(8).hex()
    rec = {**record, "epoch": epoch, "nonce": nonce, "ts": time.time()}
    line = json.dumps(rec, default=str)
    created = not os.path.exists(path)
    # Terminate a torn tail (a writer died mid-line) BEFORE appending:
    # gluing onto half a record would garble OUR line too — the queue
    # journal's discipline.
    lead = ""
    if not created:
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        lead = "\n"
        except OSError:
            pass
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, (lead + line + "\n").encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    if created:
        fsync_dir(os.path.dirname(path))
    after = load_topology_events(service_dir)
    won = False
    for e in after:
        if int(e.get("epoch", 0)) == epoch:
            won = e.get("nonce") == nonce
            break
    from multidisttorch_tpu_torch.service.fabric import read_fabric_config

    n_base = int(read_fabric_config(service_dir)["n_shards"])
    return won, epoch, fold_topology(n_base, after)
