"""Content-addressed host-side dataset cache + per-submission refs.

The service dataset was fixed at daemon start (docs/SERVICE.md's old
"limits" section); the production data plane lets every submission name
its own dataset with a **dataset reference** string carried on
``TrialConfig.dataset`` (docs/DATA.md):

- ``""`` — the caller's shared default dataset (the pre-ref behavior).
- ``builtin:<provider>?k=v&...`` — a registered deterministic provider
  (``synthetic-mnist``, ``synthetic-cifar10``), materialized on demand.
  The scheme prefix is optional when the name has no ``/`` or ``:``.
- ``file:<path>`` (or any spec containing ``/``) — a local ``.npz``
  holding ``images`` (N, D) float32 and optionally ``labels`` (N,); the
  content digest is the sha256 of the file bytes.
- ``cas:<sha256hex>`` / ``<name>@sha256:<hex>`` — an entry already in
  the store, addressed purely by content.

Two layers, by lifetime:

1. A process-wide **RAM memo** (:func:`resolve_dataset`): the same spec
   always returns the SAME :class:`Dataset` object, so co-packed lanes
   sharing a spec keep the stacked gather's single-array fast path, and
   a long sweep never re-materializes a dataset it already holds.
2. :class:`DatasetStore` — the on-disk content-addressed cache the
   sweep service mounts under ``{service_dir}/dataset_cache``:
   digest-keyed ``.npz`` entries with CRC32 sidecars (the compile
   cache's torn/bit-rot discipline: an entry failing its sidecar is
   MOVED to ``quarantine/`` and treated as a miss, never loaded), an
   LRU byte budget, and a background **prefetch pool** (the precapture farm
   pattern) so the service warms a submission's dataset at ADMISSION
   and placement never blocks on a load.

Crash model: entries land via tmp + fsync + rename (sidecar sealed
before the rename), so a torn write is an unsealed ``.tmp`` the scan
ignores — the same commit-point discipline as the checkpoint layer.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional
from urllib.parse import parse_qsl

import numpy as np

from multidisttorch_tpu_torch.data.datasets import (
    Dataset,
    synthetic_cifar10,
    synthetic_mnist,
)

QUARANTINE_DIR = "quarantine"

# Prefetch lifecycle states (the service's ``can_start`` veto reads
# these: LOADING defers placement, FAILED lets placement fail through
# the normal setup-retry path with the real exception).
UNKNOWN = "unknown"
LOADING = "loading"
READY = "ready"
FAILED = "failed"


# -- providers ---------------------------------------------------------

def _mnist_provider(params: dict) -> Dataset:
    return synthetic_mnist(
        int(params.get("rows", 512)), seed=int(params.get("seed", 0))
    )


def _mnist_probe(params: dict) -> tuple[int, int]:
    return 28 * 28, int(params.get("rows", 512))


def _cifar_provider(params: dict) -> Dataset:
    return synthetic_cifar10(
        int(params.get("rows", 512)), seed=int(params.get("seed", 0))
    )


def _cifar_probe(params: dict) -> tuple[int, int]:
    return 32 * 32 * 3, int(params.get("rows", 512))


# name -> (build(params) -> Dataset, probe(params) -> (dim, rows)|None).
# A None probe means shape is unknown without materializing — admission
# paths that need the shape must prefetch first (the service rejects
# probe-less providers rather than block its loop).
_PROVIDERS: dict[str, tuple[Callable, Optional[Callable]]] = {
    "synthetic-mnist": (_mnist_provider, _mnist_probe),
    "synthetic-cifar10": (_cifar_provider, _cifar_probe),
}


def register_provider(
    name: str, build: Callable[[dict], Dataset],
    probe: Optional[Callable[[dict], tuple[int, int]]] = None,
) -> None:
    """Register a builtin dataset provider (tests register slow/odd
    providers to drill the admission path)."""
    _PROVIDERS[name] = (build, probe)


# -- refs --------------------------------------------------------------

def _check_digest(digest: str) -> str:
    """A cas digest must be exactly 64 hex chars — it is joined into
    store paths, and anything else (``cas:../../etc``) would be a
    tenant-supplied path-traversal primitive out of the store root."""
    import re

    digest = digest.lower()
    if not re.fullmatch(r"[0-9a-f]{64}", digest):
        raise ValueError(
            "cas digest must be 64 lowercase hex characters, got "
            f"{digest[:80]!r}"
        )
    return digest


def parse_ref(spec: str) -> dict:
    """Parse a dataset reference into ``{"kind", "name", "params",
    "path", "digest"}``. Raises ``ValueError`` on an empty or
    unparseable spec — admission turns that into ``rejected_invalid``.
    """
    spec = (spec or "").strip()
    if not spec:
        raise ValueError("empty dataset reference")
    if spec.startswith("cas:"):
        return {"kind": "cas", "digest": _check_digest(spec[4:]), "name": spec}
    if "@sha256:" in spec:
        name, digest = spec.split("@sha256:", 1)
        return {"kind": "cas", "digest": _check_digest(digest), "name": name}
    if spec.startswith("file:"):
        return {"kind": "file", "path": spec[5:], "name": spec[5:]}
    if spec.startswith("builtin:"):
        spec = spec[len("builtin:"):]
    elif "/" in spec or os.sep in spec:
        return {"kind": "file", "path": spec, "name": spec}
    name, _, query = spec.partition("?")
    if not name:
        raise ValueError(f"dataset reference names no provider: {spec!r}")
    return {"kind": "builtin", "name": name, "params": dict(parse_qsl(query))}


def _npz_header_shape(path: str, member: str = "images") -> tuple:
    """Read one array's shape out of an ``.npz`` WITHOUT loading its
    data: zip central directory + the npy format header only — the
    cheap admission-time probe."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        with z.open(member + ".npy") as f:
            version = np.lib.format.read_magic(f)
            if version >= (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            return shape


def probe_ref(spec: str, *, store: Optional["DatasetStore"] = None) -> tuple[int, int]:
    """``(feature_dim, rows)`` of the referenced dataset, WITHOUT a full
    load: builtins answer analytically, files read the npz header, cas
    refs read the store's meta sidecar. Raises on anything that cannot
    be probed — the admission path's explicit-verdict contract."""
    ref = parse_ref(spec)
    if ref["kind"] == "builtin":
        entry = _PROVIDERS.get(ref["name"])
        if entry is None:
            raise ValueError(f"unknown dataset provider {ref['name']!r}")
        _, probe = entry
        if probe is None:
            raise ValueError(
                f"provider {ref['name']!r} has no shape probe; admission "
                "cannot schedule it without materializing"
            )
        dim, rows = probe(ref["params"])
        return int(dim), int(rows)
    if ref["kind"] == "file":
        shape = _npz_header_shape(ref["path"])
        if len(shape) != 2:
            raise ValueError(
                f"{ref['path']}: images must be (N, D), got {shape}"
            )
        return int(shape[1]), int(shape[0])
    # cas
    if store is None:
        raise ValueError("cas: refs need a DatasetStore to probe")
    meta = store.entry_meta(ref["digest"])
    if meta is None:
        raise ValueError(f"cas entry {ref['digest'][:12]}… not in store")
    return int(meta["dim"]), int(meta["rows"])


def _materialize(ref: dict) -> Dataset:
    """Build the referenced dataset from its SOURCE (provider or file)
    — the cache-miss path."""
    if ref["kind"] == "builtin":
        entry = _PROVIDERS.get(ref["name"])
        if entry is None:
            raise ValueError(f"unknown dataset provider {ref['name']!r}")
        return entry[0](ref["params"])
    if ref["kind"] == "file":
        with np.load(ref["path"]) as z:
            images = np.ascontiguousarray(z["images"], np.float32)
            labels = (
                np.ascontiguousarray(z["labels"], np.int32)
                if "labels" in z.files
                else np.zeros((images.shape[0],), np.int32)
            )
        return Dataset(
            images=images, labels=labels,
            name=os.path.basename(ref["path"]),
        )
    raise ValueError(f"cas ref {ref['name']!r} has no source to rebuild")


# Process-wide RAM memo: same spec -> same Dataset OBJECT. Object
# identity is load-bearing — the stacked gather's homogeneous fast
# path keys on it (data/sampler.py).
_memo: dict[str, Dataset] = {}
_memo_lock = threading.Lock()


def resolve_dataset(spec: str, *, store: Optional["DatasetStore"] = None) -> Dataset:
    """Resolve a dataset reference to a host-resident :class:`Dataset`.

    With a ``store``, the load goes straight through the content-
    addressed disk cache (its own bounded RAM LRU, hit/miss/quarantine
    accounting, and ``file:`` revalidation). Without one (the
    ``run_hpo`` batch path), results memoize process-wide so twin specs
    share ONE object — with ``file:`` memo entries keyed by the
    source's (mtime, size), so a file regenerated between sweeps
    re-reads instead of silently serving stale arrays."""
    key = (spec or "").strip()
    ref = parse_ref(key)
    if store is not None:
        return store.get(key)
    memo_key = key
    if ref["kind"] == "file":
        memo_key = f"{key}|{DatasetStore._file_stat(ref['path'])}"
    with _memo_lock:
        ds = _memo.get(memo_key)
    if ds is not None:
        return ds
    ds = _materialize(ref)
    with _memo_lock:
        # First resolver wins: a racing thread's duplicate load is
        # dropped so every caller shares ONE object.
        ds = _memo.setdefault(memo_key, ds)
    return ds


def clear_memo() -> None:
    """Test hook: forget RAM-memoized datasets."""
    with _memo_lock:
        _memo.clear()


# -- the on-disk store -------------------------------------------------

def _dataset_bytes(ds: Dataset) -> bytes:
    """Canonical npz serialization (deterministic member order, no
    compression timestamps) — what the content digest addresses."""
    buf = io.BytesIO()
    np.savez(buf, images=ds.images, labels=ds.labels)
    return buf.getvalue()


class DatasetStore:
    """Digest-keyed on-disk dataset cache with CRC sidecars, an LRU
    byte budget, and a background prefetch pool (module docstring)."""

    def __init__(
        self,
        root: str,
        *,
        byte_budget: Optional[int] = None,
        prefetch_workers: int = 2,
        ram_entries: int = 8,
    ):
        self.root = root
        self.byte_budget = byte_budget
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._workers = max(1, int(prefetch_workers))
        self._jobs: dict[str, Future] = {}
        # spec -> digest index, rebuilt from meta sidecars at init so a
        # restarted daemon reuses its predecessor's entries.
        self._spec_digest: dict[str, str] = {}
        # Small RAM LRU of loaded datasets (insertion-ordered dict).
        self._ram: dict[str, Dataset] = {}
        self._ram_entries = max(1, int(ram_entries))
        self.counters = {
            "hits": 0, "misses": 0, "evictions": 0, "quarantined": 0,
            "prefetches": 0, "prefetch_failures": 0,
        }
        if os.path.isdir(root):
            for name in os.listdir(root):
                if not name.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(root, name)) as f:
                        meta = json.load(f)
                    digest = name[:-len(".json")]
                    for spec in (meta.get("sources") or {}):
                        self._spec_digest[spec] = digest
                    if meta.get("source_spec"):
                        self._spec_digest[meta["source_spec"]] = digest
                except (OSError, json.JSONDecodeError):
                    continue

    # -- paths / meta --------------------------------------------------

    def _paths(self, digest: str) -> tuple[str, str, str]:
        base = os.path.join(self.root, digest)
        return base + ".npz", base + ".crc", base + ".json"

    def entry_meta(self, digest: str) -> Optional[dict]:
        _, _, meta_p = self._paths(digest)
        try:
            with open(meta_p) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def entries(self) -> list[dict]:
        out = []
        if not os.path.isdir(self.root):
            return out
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".json"):
                meta = self.entry_meta(name[:-len(".json")])
                if meta is not None:
                    out.append(meta)
        return out

    def total_bytes(self) -> int:
        total = 0
        if not os.path.isdir(self.root):
            return 0
        for name in os.listdir(self.root):
            if name.endswith(".npz"):
                try:
                    total += os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    pass
        return total

    # -- write side ----------------------------------------------------

    def put_dataset(
        self,
        ds: Dataset,
        *,
        source_spec: str = "",
        source_stat: Optional[tuple] = None,
    ) -> str:
        """Serialize ``ds`` into the store; returns the content digest.
        Idempotent: an existing entry with the same digest is kept.

        The fsync'd payload writes happen OUTSIDE the store lock — the
        daemon's scheduler pass polls ``state()`` under that lock, and
        a multi-hundred-MB landing must not stall placements for every
        tenant. Concurrent same-digest writers are safe: identical
        bytes, unique tmp names, atomic replace."""
        payload = _dataset_bytes(ds)
        digest = hashlib.sha256(payload).hexdigest()
        npz_p, crc_p, meta_p = self._paths(digest)
        sources = (
            {source_spec: list(source_stat) if source_stat else None}
            if source_spec
            else {}
        )
        # Sidecars land FIRST, payload rename LAST (the commit point):
        # a crash mid-put leaves orphan sidecars a later put simply
        # overwrites — never a payload without its CRC, which nothing
        # would ever repair. Checking all three also re-seals an entry
        # whose sidecars a previous crash took.
        if not all(os.path.exists(q) for q in (npz_p, crc_p, meta_p)):
            os.makedirs(self.root, exist_ok=True)
            self._write_atomic(
                crc_p,
                f"{zlib.crc32(payload):08x} {len(payload)}\n".encode(),
            )
            self._write_atomic(
                meta_p,
                json.dumps(
                    {
                        "digest": digest,
                        "name": ds.name,
                        "synthetic": ds.synthetic,
                        "bytes": len(payload),
                        "dim": int(ds.images.shape[1]),
                        "rows": int(ds.images.shape[0]),
                        "source_spec": source_spec,
                        "sources": sources,
                        "created_ts": time.time(),
                    }
                ).encode(),
            )
            self._write_atomic(npz_p, payload)
        elif source_spec:
            # Same content, new/changed source (a file touched without
            # content change, or a second path to identical bytes):
            # MERGE this source's stat into the meta so the next get()
            # revalidates as a hit — skipping this would leave a stale
            # stat and a permanent re-hash-the-whole-file miss loop.
            # The read-modify-write holds the lock: two workers landing
            # the same digest from different sources must not drop each
            # other's stat (the meta json is ~300 bytes — the write is
            # nothing like the payload fsyncs kept out of the lock).
            with self._lock:
                meta = self.entry_meta(digest) or {}
                known = dict(meta.get("sources") or {})
                if known.get(source_spec) != sources.get(source_spec):
                    known.update(sources)
                    meta["sources"] = known
                    meta.setdefault("source_spec", source_spec)
                    self._write_atomic(meta_p, json.dumps(meta).encode())
        with self._lock:
            if source_spec:
                self._spec_digest[source_spec] = digest
        self._evict_over_budget(keep=digest)
        return digest

    @staticmethod
    def _write_atomic(path: str, payload: bytes) -> None:
        # Unique tmp per writer: two threads landing the same digest
        # must not interleave into one tmp file.
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _file_stat(path: str) -> Optional[tuple]:
        try:
            st = os.stat(path)
            return (int(st.st_mtime_ns), int(st.st_size))
        except OSError:
            return None

    def ingest_file(self, path: str) -> str:
        """Content-hash a local ``.npz`` into the store; returns its
        digest (the ``cas:`` ref another tenant can then submit)."""
        ref = {"kind": "file", "path": path, "name": path}
        stat = self._file_stat(path)
        ds = _materialize(ref)
        return self.put_dataset(
            ds, source_spec=f"file:{path}", source_stat=stat
        )

    def _evict_over_budget(self, keep: Optional[str] = None) -> None:
        """LRU eviction (oldest access mtime first) down to the byte
        budget. The directory sweep and the unlinks run OUTSIDE the
        store lock (the daemon's scheduler pass polls ``state()`` under
        it — a disk sweep must not stall every tenant's placements);
        only the shared-index purge takes it.

        ``keep`` exempts the digest the CALLING put just landed: a
        dataset larger than the whole budget must still become READY
        and place (the budget is soft-exceeded by at most that one
        entry until the next landing) — evicting it immediately would
        livelock its submission in a prefetch→evict→re-prefetch loop
        with no verdict ever."""
        if self.byte_budget is None:
            return
        entries = []
        for name in os.listdir(self.root) if os.path.isdir(self.root) else []:
            if not name.endswith(".npz"):
                continue
            p = os.path.join(self.root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, name[:-len(".npz")]))
        total = sum(s for _, s, _ in entries)
        for _, size, digest in sorted(entries):
            if total <= self.byte_budget:
                break
            if digest == keep:
                continue
            for p in self._paths(digest):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            with self._lock:
                self._spec_digest = {
                    k: v
                    for k, v in self._spec_digest.items()
                    if v != digest
                }
                self._ram.pop(digest, None)
                self.counters["evictions"] += 1
            total -= size

    # -- read side -----------------------------------------------------

    def _quarantine(self, digest: str, reason: str) -> None:
        qdir = os.path.join(self.root, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        for p in self._paths(digest):
            if os.path.exists(p):
                try:
                    os.replace(p, os.path.join(qdir, os.path.basename(p)))
                except OSError:
                    pass
        with open(os.path.join(qdir, digest + ".reason"), "w") as f:
            f.write(reason + "\n")
        # Shared-state mutations under the lock: prefetch workers and
        # the daemon thread read/write _spec_digest concurrently, and
        # an unlocked rebind here could drop a racing put_dataset's
        # just-landed spec→digest mapping.
        with self._lock:
            self._spec_digest = {
                k: v for k, v in self._spec_digest.items() if v != digest
            }
            self._ram.pop(digest, None)
            self.counters["quarantined"] += 1

    def _load_entry(self, digest: str) -> Optional[Dataset]:
        """Load + verify one cached entry; a failed sidecar quarantines
        the entry and reports a miss (None) — a garbled blob must never
        reach a trial's training data."""
        npz_p, crc_p, _ = self._paths(digest)
        try:
            with open(npz_p, "rb") as f:
                payload = f.read()
            with open(crc_p) as f:
                crc_hex, nbytes = f.read().split()
        except OSError:
            return None
        if len(payload) != int(nbytes) or zlib.crc32(payload) != int(crc_hex, 16):
            self._quarantine(digest, "crc sidecar mismatch")
            return None
        meta = self.entry_meta(digest) or {}
        with np.load(io.BytesIO(payload)) as z:
            ds = Dataset(
                images=np.ascontiguousarray(z["images"], np.float32),
                labels=np.ascontiguousarray(z["labels"], np.int32),
                name=meta.get("name", digest[:12]),
                synthetic=bool(meta.get("synthetic", False)),
            )
        now = time.time()
        for p in (npz_p,):  # LRU touch: access refreshes eviction order
            try:
                os.utime(p, (now, now))
            except OSError:
                pass
        return ds

    def _touch(self, digest: str) -> None:
        """Refresh the entry's LRU clock (eviction orders by mtime) —
        a RAM-cache hit must count as use, or the byte budget evicts
        the HOTTEST dataset first."""
        npz_p, _, _ = self._paths(digest)
        now = time.time()
        try:
            os.utime(npz_p, (now, now))
        except OSError:
            pass

    def get(self, spec: str) -> Dataset:
        """Resolve a ref through the cache: RAM LRU → verified disk
        entry → rebuild from source (and cache it). Raises when the
        source is gone (a pure ``cas:`` ref whose entry was evicted or
        quarantined). ``file:`` refs revalidate the source's
        (mtime, size) against the cached entry's recorded stat, so a
        file changed behind its path is a MISS re-ingested under its
        new content — never stale bytes served under an old digest."""
        ref = parse_ref(spec)
        digest = ref.get("digest") or self._spec_digest.get(spec)
        source_stat = None
        if ref["kind"] == "file":
            source_stat = self._file_stat(ref["path"])
            if digest is not None:
                meta = self.entry_meta(digest) or {}
                cached_stat = (meta.get("sources") or {}).get(spec)
                if (
                    source_stat is None
                    or cached_stat is None
                    or list(source_stat) != list(cached_stat)
                ):
                    digest = None  # source changed (or gone): reload
        if digest is not None:
            with self._lock:
                ds = self._ram.get(digest)
                if ds is not None:
                    self._ram.pop(digest)
                    self._ram[digest] = ds  # LRU refresh
                    self.counters["hits"] += 1
            if ds is not None:
                self._touch(digest)
                return ds
            ds = self._load_entry(digest)
            if ds is not None:
                with self._lock:
                    self.counters["hits"] += 1
                self._ram_put(digest, ds)
                return ds
        with self._lock:
            self.counters["misses"] += 1
        ds = _materialize(ref)  # raises for cas refs with no source
        digest = self.put_dataset(
            ds, source_spec=spec, source_stat=source_stat
        )
        self._ram_put(digest, ds)
        return ds

    def _ram_put(self, digest: str, ds: Dataset) -> None:
        with self._lock:
            self._ram[digest] = ds
            while len(self._ram) > self._ram_entries:
                self._ram.pop(next(iter(self._ram)))

    # -- prefetch (the farm pattern) ----------------------------------

    def prefetch(self, spec: str) -> None:
        """Queue a background load of ``spec`` (idempotent while a job
        is in flight). Admission calls this; placement polls
        :meth:`state` and never blocks on the load itself."""
        with self._lock:
            job = self._jobs.get(spec)
            if job is not None and not job.done():
                return
            if job is not None and job.exception() is None:
                return  # already loaded
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix="mdt-dataset-prefetch",
                )
            self.counters["prefetches"] += 1
            # Straight through the store — NOT resolve_dataset's
            # process memo: the memo never evicts, and a long-lived
            # daemon prefetching many tenants' datasets must stay
            # bounded by the store's RAM LRU (+ the disk budget). The
            # job DISCARDS the Dataset (placement re-reads through the
            # RAM LRU): a Future holding the result would pin one full
            # dataset per lifetime spec, unevictably.
            self._jobs[spec] = self._pool.submit(self._prefetch_job, spec)

    def _ram_resident(self, spec: str) -> bool:
        """Whether the ref is warm in the RAM LRU — what READY means:
        placement takes a RAM-warm dataset, never a disk parse on the
        daemon loop."""
        try:
            ref = parse_ref(spec)
        except ValueError:
            return False
        with self._lock:
            digest = ref.get("digest") or self._spec_digest.get(spec)
            return digest is not None and digest in self._ram

    def state(self, spec: str) -> str:
        """Prefetch lifecycle verdict for ``spec``: ``ready`` /
        ``loading`` / ``failed`` / ``unknown`` (never prefetched).

        READY means the bytes are RAM-warm, not just that a prefetch
        once finished: an entry the RAM LRU (or the disk budget) has
        since evicted reports ``unknown`` again (the completed job is
        dropped), so the scheduler re-prefetches — a background disk
        re-read into RAM — instead of placement parsing a whole
        dataset inline on the daemon loop."""
        with self._lock:
            job = self._jobs.get(spec)
        if job is None:
            return UNKNOWN
        if not job.done():
            return LOADING
        if job.exception() is not None:
            return FAILED
        if self._ram_resident(spec):
            return READY
        with self._lock:
            if self._jobs.get(spec) is job:
                self._jobs.pop(spec, None)
        return UNKNOWN

    def _prefetch_job(self, spec: str) -> None:
        # dataset_prefetch_end closes the trace span the runtime's
        # dataset_prefetch_queued instant opened (telemetry/trace.py);
        # emitted from the worker thread — the bus is thread-safe, and
        # with telemetry off no object is ever constructed.
        from multidisttorch_tpu_torch.telemetry.events import get_bus

        t0 = time.perf_counter()
        try:
            self.get(spec)  # lands in the RAM LRU + disk; result dropped
        except BaseException:
            # Counted before the job's future completes: a caller that sees
            # the FAILED state sees the count too (a done-callback runs
            # after the future is marked done).
            with self._lock:
                self.counters["prefetch_failures"] += 1
            bus = get_bus()
            if bus is not None:
                bus.emit(
                    "dataset_prefetch_end",
                    spec=spec,
                    ok=False,
                    wall_s=round(time.perf_counter() - t0, 4),
                )
            raise
        bus = get_bus()
        if bus is not None:
            bus.emit(
                "dataset_prefetch_end",
                spec=spec,
                ok=True,
                wall_s=round(time.perf_counter() - t0, 4),
            )

    def prefetch_error(self, spec: str) -> Optional[BaseException]:
        with self._lock:
            job = self._jobs.get(spec)
        if job is None or not job.done():
            return None
        return job.exception()

    def clear_job(self, spec: str) -> None:
        """Forget a completed prefetch job (a consumed FAILED verdict
        → state back to ``unknown``, so the next scheduler pass
        re-prefetches in the background instead of anyone reloading
        inline)."""
        with self._lock:
            job = self._jobs.get(spec)
            if job is not None and job.done():
                self._jobs.pop(spec, None)

    def shutdown(self, wait: bool = False) -> None:
        """Stop the prefetch pool, cancelling queued loads; ``wait`` also
        waits for a load in flight."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=True)

    def stats(self) -> dict:
        return {
            **self.counters,
            "entries": sum(
                1
                for n in (
                    os.listdir(self.root) if os.path.isdir(self.root) else []
                )
                if n.endswith(".npz")
            ),
            "bytes": self.total_bytes(),
            "byte_budget": self.byte_budget,
        }
