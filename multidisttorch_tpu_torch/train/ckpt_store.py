"""Checkpoint format v2: a content-addressed chunk store + manifests.

A copy of ``multidisttorch_tpu/train/ckpt_store.py``: the same chunks,
refcounts and manifests, so either package restores the other's
checkpoints. :func:`build_manifest` takes the state-dict tree itself
(``train.checkpoint.train_state_to_tree``) where the JAX package derives
it with flax's ``to_state_dict``; the manifest has no sharding record
(ROADMAP A.13). The GC emits the JAX package's ``ckpt_gc`` bus event.

The v1 checkpoint (``train/checkpoint.py``) rewrites the FULL model as
one msgpack blob per save and retains keep-last-K history as full
COPIES — at the scale the pjit/TPUv4 LM paper targets that gather+
rewrite is the dominant term in drain latency and restart tax. v2
splits the data plane from the metadata plane (docs/RESILIENCE.md
"Checkpoint format v2"):

- **Chunks**: every state leaf is serialized as raw bytes and split
  into fixed-size chunks, each landed in a content-addressed store
  under ``{ckpt_dir}/chunks/`` keyed by its sha256 — the
  ``DatasetStore`` landing discipline (tmp + fsync + rename, CRC32
  sidecar sealed BEFORE the payload rename, unique per-writer tmp
  names), so a torn write is an invisible ``.tmp`` and a rotted chunk
  is a CRC mismatch, never a garbled restore.
- **Manifest**: a small fsync'd JSON file at the checkpoint path
  itself (where v1 put the msgpack blob) listing each leaf's dtype/
  shape/chunk digests plus the caller's metadata and the state's
  ``NamedSharding`` layout. The v1 sidecar machinery (``path + .json``
  with ``_integrity`` over the manifest bytes, ``.v{step}`` retained
  versions, scan-back, the cross-host restore agreement) applies
  UNCHANGED — a v2 checkpoint is just a v1 checkpoint whose primary
  file happens to be tiny.
- **Incremental saves**: a chunk whose digest already exists in the
  store is referenced, not rewritten — optimizer-stable leaves and
  frozen params stop costing full-model bytes every cadence. The save
  stats record written-vs-reused bytes (the bench's delta ratio).
- **Refcounted GC**: ``refs.json`` counts how many manifest FILES
  reference each chunk; retention version copies increment, pruned
  versions decrement, zero unlinks. Every mutation is ordered so a
  crash can only LEAK a count (reconciled by the orphan sweep —
  ``tools/ckpt_gc.py``), never free a chunk a live manifest still
  references.

Crash model: chunks land before the manifest referencing them; refs
increment before the manifest replace and decrement after the old
manifest is gone. A kill at any instant leaves the previous manifest
fully restorable and at worst some unreferenced chunks/counts for the
sweep.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib
from typing import Any, Iterable, Optional

import numpy as np

MANIFEST_FORMAT = "mdt-ckpt-v2"
CHUNKS_DIRNAME = "chunks"
REFS_NAME = "refs.json"
DEFAULT_CHUNK_BYTES = 1 << 20  # 1 MiB
_SNIFF_BYTES = 64


def _fsync_dir(path: str) -> None:
    """Durably record a directory entry (the rename itself). One copy
    for the whole checkpoint layer — ``train/checkpoint.py`` imports
    this and :func:`write_atomic` rather than carrying twins that
    could drift. Best-effort: some filesystems refuse O_RDONLY dir
    fsync."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_atomic(path: str, blob: bytes, *, fsync: bool = True) -> None:
    """Atomic (+ durable with ``fsync``) publish with a WRITER-UNIQUE
    tmp name: overlapped writers on one path (a drained victim's
    background persist vs its successor's save; two threads landing
    one chunk digest) must not interleave into a shared tmp that the
    rename then publishes torn."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)


def chunk_dir_for(ckpt_path: str) -> str:
    """The chunk store serving a checkpoint path: ``chunks/`` next to
    the manifest, shared by every retained version (and, for pipelined
    trials, by every stage manifest in the trial dir)."""
    return os.path.join(os.path.dirname(ckpt_path) or ".", CHUNKS_DIRNAME)


def is_manifest_blob(blob: bytes) -> bool:
    """Sniff a checkpoint file: v2 manifests are JSON whose first key
    is the format marker; v1 blobs are msgpack (first byte is a map/
    bin marker, never ``{``)."""
    head = blob[:_SNIFF_BYTES]
    return head.lstrip()[:1] == b"{" and MANIFEST_FORMAT.encode() in head


def is_manifest_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return is_manifest_blob(f.read(_SNIFF_BYTES * 2))
    except OSError:
        return False


class ChunkStore:
    """Content-addressed chunks under ``root`` with CRC32 sidecars and
    a refcount ledger.

    Concurrency model: every mutation of the {refcounts, chunk
    liveness} pair — incr/decr (including the zero-count unlinks),
    put's has-check + commit rename, and the sweep's whole
    mark/rebuild/unlink pass — runs under ONE exclusive ``refs.lock``
    ``flock`` (the ledger's locking discipline), so a GC running
    against a LIVE directory serializes against in-flight saves
    instead of clobbering a concurrent increment (which could drive a
    still-referenced chunk to zero — corruption, not a leak). The
    in-process ``threading.Lock`` additionally serializes threads of
    one process sharing a store instance; large payload writes happen
    OUTSIDE both locks (only the rename commit is held)."""

    def __init__(self, root: str, *, fsync: bool = True):
        self.root = root
        self.fsync = bool(fsync)
        self._lock = threading.Lock()

    def _locked(self):
        """Exclusive cross-process + in-process critical section over
        the refcount/liveness state."""
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def cm():
            with self._lock:
                os.makedirs(self.root, exist_ok=True)
                fd = os.open(
                    os.path.join(self.root, "refs.lock"),
                    os.O_CREAT | os.O_RDWR,
                )
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                    yield
                finally:
                    try:
                        fcntl.flock(fd, fcntl.LOCK_UN)
                    finally:
                        os.close(fd)

        return cm()

    # -- paths --------------------------------------------------------

    def chunk_path(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], digest + ".chunk")

    def crc_path(self, digest: str) -> str:
        return os.path.join(self.root, digest[:2], digest + ".crc")

    def refs_path(self) -> str:
        return os.path.join(self.root, REFS_NAME)

    # -- landing (the DatasetStore discipline) ------------------------

    def has(self, digest: str) -> bool:
        return os.path.exists(self.chunk_path(digest)) and os.path.exists(
            self.crc_path(digest)
        )

    def _write_atomic(self, path: str, blob: bytes) -> None:
        write_atomic(path, blob, fsync=self.fsync)

    def put(self, blob: bytes) -> tuple[str, int]:
        """Land one chunk; returns ``(digest, bytes_written)`` where
        written is 0 on a dedup hit (the incremental-save currency).
        The CRC sidecar is sealed BEFORE the payload rename — the
        commit point — so a crash can orphan a sidecar but never
        strand a CRC-less payload nothing would verify. The dedup
        has-check and the commit run under the store lock: a dedup hit
        must not race a concurrent decr/sweep unlinking that digest
        (the save's incr, also locked, follows before any manifest
        references it)."""
        digest = hashlib.sha256(blob).hexdigest()
        with self._locked():
            if self.has(digest):
                # Refresh the grace clock: this chunk may be a leaked
                # orphan (count 0) being re-referenced — a live GC
                # must see it young until the referencing manifest
                # lands, or the sweep unlinks it mid-save.
                try:
                    os.utime(self.chunk_path(digest))
                except OSError:
                    pass
                return digest, 0
            os.makedirs(
                os.path.dirname(self.chunk_path(digest)), exist_ok=True
            )
            self._write_atomic(
                self.crc_path(digest),
                f"{zlib.crc32(blob):08x} {len(blob)}\n".encode(),
            )
            self._write_atomic(self.chunk_path(digest), blob)
        return digest, len(blob)

    def verify(self, digest: str, nbytes: Optional[int] = None):
        """``(ok, reason)`` for one chunk: present, sidecar parses,
        size and CRC32 match (and the recorded size matches the
        manifest's expectation when given)."""
        cp, sp = self.chunk_path(digest), self.crc_path(digest)
        if not os.path.exists(cp):
            return False, f"chunk {digest[:12]} missing"
        try:
            with open(sp) as f:
                crc_hex, rec_n = f.read().split()
        except (OSError, ValueError) as e:
            return False, f"chunk {digest[:12]} sidecar unreadable: {e}"
        try:
            with open(cp, "rb") as f:
                blob = f.read()
        except OSError as e:
            return False, f"chunk {digest[:12]} unreadable: {e}"
        if len(blob) != int(rec_n) or (
            nbytes is not None and len(blob) != int(nbytes)
        ):
            return False, (
                f"chunk {digest[:12]} size mismatch ({len(blob)} vs "
                f"recorded {rec_n}) — torn write"
            )
        if zlib.crc32(blob) != int(crc_hex, 16):
            return False, f"chunk {digest[:12]} crc32 mismatch — corrupt"
        return True, "ok"

    def read(self, digest: str, *, verify: bool = True) -> bytes:
        with open(self.chunk_path(digest), "rb") as f:
            blob = f.read()
        if verify:
            try:
                with open(self.crc_path(digest)) as f:
                    crc_hex, rec_n = f.read().split()
            except (OSError, ValueError) as e:
                raise IOError(
                    f"chunk {digest[:12]} sidecar unreadable: {e}"
                ) from e
            if len(blob) != int(rec_n) or zlib.crc32(blob) != int(
                crc_hex, 16
            ):
                raise IOError(
                    f"chunk {digest[:12]} failed CRC verification"
                )
        return blob

    # -- refcounts ----------------------------------------------------

    def _load_refs(self) -> dict[str, int]:
        try:
            with open(self.refs_path()) as f:
                return {str(k): int(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            return {}

    def _store_refs(self, refs: dict[str, int]) -> None:
        os.makedirs(self.root, exist_ok=True)
        self._write_atomic(
            self.refs_path(),
            json.dumps({k: v for k, v in refs.items() if v > 0}).encode(),
        )

    def refcounts(self) -> dict[str, int]:
        with self._locked():
            return self._load_refs()

    def locked(self):
        """Public critical section for compound mutations: the save
        path holds this across {incr + manifest replace} so a
        concurrent sweep's refs rebuild can never land between the
        increment and the manifest becoming visible (the rebuild would
        drop the counts, and a LATER save's decr could then drive a
        still-referenced shared chunk to zero)."""
        return self._locked()

    def _incr_unlocked(self, digests: Iterable[str]) -> None:
        refs = self._load_refs()
        for d in set(digests):
            refs[d] = refs.get(d, 0) + 1
        self._store_refs(refs)

    def incr(self, digests: Iterable[str]) -> None:
        """Count one more manifest FILE referencing each digest (set
        semantics per manifest — callers pass the manifest's distinct
        digest set). Ordered BEFORE the manifest lands, so a crash
        leaks a count the sweep reconciles, never undercounts."""
        ds = set(digests)
        if not ds:
            return
        with self._locked():
            self._incr_unlocked(ds)

    def decr(self, digests: Iterable[str]) -> int:
        """Drop one manifest's references; unlink chunks whose count
        reaches zero. Returns bytes freed. Ordered AFTER the manifest
        file is gone — a crash in between leaks, never corrupts. The
        unlinks happen INSIDE the critical section: between a count
        hitting zero and the file vanishing, a concurrent put must not
        dedup-hit the doomed chunk."""
        ds = set(digests)
        if not ds:
            return 0
        freed = 0
        with self._locked():
            refs = self._load_refs()
            dead = []
            for d in ds:
                n = refs.get(d, 0) - 1
                if n > 0:
                    refs[d] = n
                else:
                    refs.pop(d, None)
                    dead.append(d)
            self._store_refs(refs)
            for d in dead:
                freed += self._unlink_chunk(d)
        return freed

    def _unlink_chunk(self, digest: str) -> int:
        freed = 0
        for p in (self.chunk_path(digest), self.crc_path(digest)):
            try:
                freed += os.path.getsize(p)
                os.remove(p)
            except OSError:
                pass
        return freed

    # -- enumeration / sweep ------------------------------------------

    def all_chunks(self) -> dict[str, float]:
        """``{digest: mtime}`` of every payload chunk on disk."""
        out: dict[str, float] = {}
        try:
            prefixes = os.listdir(self.root)
        except OSError:
            return out
        for pre in prefixes:
            d = os.path.join(self.root, pre)
            if not os.path.isdir(d):
                continue
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if not name.endswith(".chunk"):
                    continue
                try:
                    out[name[: -len(".chunk")]] = os.path.getmtime(
                        os.path.join(d, name)
                    )
                except OSError:
                    pass
        return out

    def sweep(
        self,
        live,
        *,
        grace_s: float = 0.0,
        now: Optional[float] = None,
    ) -> dict:
        """Mark-and-sweep reconciliation: rebuild ``refs.json`` from
        the LIVE manifest digest sets (leaked counts from crashed saves
        drop out) and unlink chunks no live manifest references, aged
        past ``grace_s`` (protects a save whose chunks landed but whose
        manifest hasn't — those are younger than any sane grace).

        ``live`` is a list of per-manifest digest sets, a single set,
        or a ZERO-ARG CALLABLE resolved INSIDE the critical section —
        the live-directory safety hinge: the manifest list must be
        read under the same lock that rebuilds the refs, or a save
        landing between the read and the rebuild loses its increments
        (and a later decr could unlink a chunk its new manifest still
        references — corruption, not a leak). ``sweep_ckpt_dir``
        always passes the callable form."""
        now = time.time() if now is None else now
        removed = 0
        freed = 0
        kept_young = 0
        with self._locked():
            if callable(live):
                live = live()
            on_disk = self.all_chunks()
            refs = self._load_refs()
            live_counts: dict[str, int] = {}
            for dset in live if isinstance(live, list) else [live]:
                for d in set(dset):
                    live_counts[d] = live_counts.get(d, 0) + 1
            leaked_refs = {
                d: n
                for d, n in refs.items()
                if live_counts.get(d, 0) != n
            }
            self._store_refs(live_counts)
            for digest, mtime in on_disk.items():
                if digest in live_counts:
                    continue
                if now - mtime < grace_s:
                    kept_young += 1
                    continue
                freed += self._unlink_chunk(digest)
                removed += 1
        return {
            "chunks_on_disk": len(on_disk),
            "live_chunks": len(live_counts),
            "orphans_removed": removed,
            "orphan_bytes_freed": freed,
            "kept_in_grace": kept_young,
            "leaked_refs_reconciled": len(leaked_refs),
        }


# --------------------------------------------------------------------
# pytree <-> flat leaves
# --------------------------------------------------------------------


_EMPTY = object()  # marker leaf for empty dicts (optax EmptyState)


def _flatten_state_dict(sd: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(sd, dict):
        if not sd:
            # Structure-preserving: optax's EmptyState serializes to
            # {}; dropping it would desync flax's list restoration.
            return [(prefix[:-1] if prefix else "", _EMPTY)]
        out: list[tuple[str, Any]] = []
        for k in sorted(sd, key=str):
            out.extend(
                _flatten_state_dict(sd[k], f"{prefix}{k}/")
            )
        return out
    return [(prefix[:-1] if prefix else "", sd)]


def _unflatten_state_dict(flat: dict[str, Any]) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/") if key else [""]
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


# --------------------------------------------------------------------
# manifests
# --------------------------------------------------------------------


def build_manifest(
    host_state: Any,
    store: ChunkStore,
    *,
    metadata: Optional[dict] = None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> tuple[dict, dict]:
    """Chunk every leaf of the state-dict tree ``host_state`` (nested
    dicts of numpy arrays, ``{}`` for an empty subtree) into ``store`` and
    return ``(manifest, stats)``. Chunks already present (bit-identical to
    a previous save's) are referenced, not rewritten: the incremental-save
    mechanism; ``stats`` records the written/reused split.
    """
    chunk_bytes = max(1, int(chunk_bytes))
    flat = _flatten_state_dict(host_state)
    leaves = []
    new_bytes = 0
    reused_bytes = 0
    chunks_written = 0
    chunks_total = 0
    for key, val in flat:
        if val is _EMPTY:
            leaves.append({"key": key, "kind": "empty"})
            continue
        arr = np.asarray(val)
        blob = np.ascontiguousarray(arr).tobytes()
        entry: dict[str, Any] = {
            "key": key,
            "dtype": str(arr.dtype),
            "shape": [int(s) for s in arr.shape],
            "nbytes": len(blob),
            "chunks": [],
        }
        for off in range(0, len(blob), chunk_bytes) or [0]:
            piece = blob[off : off + chunk_bytes]
            if not piece and len(blob) > 0:
                continue
            digest, written = store.put(piece)
            chunks_total += 1
            if written:
                chunks_written += 1
                new_bytes += written
            else:
                reused_bytes += len(piece)
            entry["chunks"].append({"d": digest, "n": len(piece)})
        leaves.append(entry)
    manifest = {
        "format": MANIFEST_FORMAT,
        "chunk_bytes": chunk_bytes,
        "meta": dict(metadata) if metadata is not None else {},
        "leaves": leaves,
    }
    total = new_bytes + reused_bytes
    stats = {
        "format": "v2",
        "total_bytes": total,
        "new_bytes": new_bytes,
        "reused_bytes": reused_bytes,
        "chunks": chunks_total,
        "chunks_written": chunks_written,
        "delta_ratio": round(new_bytes / total, 6) if total else 0.0,
    }
    return manifest, stats


def manifest_bytes(manifest: dict) -> bytes:
    # The format marker is the FIRST key (insertion order) — the sniff
    # contract of is_manifest_blob.
    return json.dumps(manifest).encode()


def load_manifest(blob: bytes) -> dict:
    m = json.loads(blob.decode())
    if m.get("format") != MANIFEST_FORMAT:
        raise ValueError(
            f"not a {MANIFEST_FORMAT} manifest (format="
            f"{m.get('format')!r})"
        )
    return m


def manifest_digests(manifest: dict) -> set:
    return {
        c["d"]
        for leaf in manifest.get("leaves", [])
        for c in leaf.get("chunks", [])
    }


def read_manifest_file(path: str) -> Optional[dict]:
    """Parse ``path`` as a manifest, or None (absent / not v2 /
    undecodable)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if not is_manifest_blob(blob):
        return None
    try:
        return load_manifest(blob)
    except (ValueError, UnicodeDecodeError):
        return None


def verify_manifest_chunks(manifest: dict, store: ChunkStore):
    """Chunk-complete verification: every referenced chunk present,
    sized, and CRC-clean — the v2 extension of the sidecar CRC gate, so
    a missing or rotted chunk disqualifies the candidate exactly like a
    torn v1 state file (scan-back degrades to the previous step)."""
    for leaf in manifest.get("leaves", []):
        for c in leaf.get("chunks", []):
            ok, reason = store.verify(c["d"], nbytes=c["n"])
            if not ok:
                return False, f"leaf {leaf['key']}: {reason}"
    return True, "ok"


def restore_arrays(
    manifest: dict,
    store: ChunkStore,
    *,
    read_threads: Optional[int] = None,
    verify: bool = True,
) -> Any:
    """Reassemble the manifest's state_dict with a parallel per-chunk
    read pool (``MDT_CKPT_READ_THREADS``, default up to 8) — restore
    bandwidth scales with the store's chunk fan-out instead of one
    sequential blob read."""
    from concurrent.futures import ThreadPoolExecutor

    jobs: list[tuple[str, dict]] = []
    for leaf in manifest.get("leaves", []):
        for c in leaf.get("chunks", []):
            jobs.append((c["d"], c))
    if read_threads is None:
        read_threads = int(os.environ.get("MDT_CKPT_READ_THREADS", "8"))
    n_workers = max(1, min(int(read_threads), len(jobs) or 1))
    blobs: dict[int, bytes] = {}
    if n_workers > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            for i, blob in enumerate(
                pool.map(
                    lambda j: store.read(j[0], verify=verify), jobs
                )
            ):
                blobs[i] = blob
    else:
        for i, (digest, _) in enumerate(jobs):
            blobs[i] = store.read(digest, verify=verify)
    flat: dict[str, Any] = {}
    cursor = 0
    for leaf in manifest.get("leaves", []):
        if leaf.get("kind") == "empty":
            flat[leaf["key"]] = {}
            continue
        parts = []
        for c in leaf["chunks"]:
            parts.append(blobs[cursor])
            cursor += 1
        blob = b"".join(parts)
        arr = np.frombuffer(blob, dtype=np.dtype(leaf["dtype"]))
        flat[leaf["key"]] = arr.reshape(leaf["shape"]).copy()
    return _unflatten_state_dict(flat)


# --------------------------------------------------------------------
# GC over a checkpoint directory
# --------------------------------------------------------------------


def live_manifest_files(ckpt_dir: str) -> list[str]:
    """Every file in ``ckpt_dir`` that sniffs as a v2 manifest — the
    primary checkpoint(s), retained ``.v{step}`` versions, and (for
    pipelined trials) every stage's family share one chunk store."""
    out = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return out
    for name in names:
        if name == CHUNKS_DIRNAME or name.endswith((".json", ".tmp")):
            continue
        p = os.path.join(ckpt_dir, name)
        if os.path.isfile(p) and is_manifest_file(p):
            out.append(p)
    return sorted(out)


def sweep_ckpt_dir(
    ckpt_dir: str, *, grace_s: float = 300.0, now: Optional[float] = None
) -> Optional[dict]:
    """Reconcile + orphan-sweep one checkpoint directory's chunk store
    against its live manifests. Returns the sweep report, or None when
    the directory has no chunk store. Safe on a LIVE directory: chunks
    younger than ``grace_s`` are kept (an in-flight save's chunks land
    before its manifest), and refs are rebuilt from the manifests that
    exist — a crashed save's leaked counts drop out."""
    store_dir = os.path.join(ckpt_dir, CHUNKS_DIRNAME)
    if not os.path.isdir(store_dir):
        return None
    store = ChunkStore(store_dir)
    counts = {"manifests": 0, "unreadable": 0}

    def live_under_lock() -> list:
        # Resolved inside the store's critical section (see
        # ChunkStore.sweep): a save racing this GC either fully lands
        # before the manifest read — and is marked live — or fully
        # after the rebuild, when its (locked) increments apply to the
        # reconciled refs.
        live_sets = []
        manifests = live_manifest_files(ckpt_dir)
        counts["manifests"] = len(manifests)
        for p in manifests:
            m = read_manifest_file(p)
            if m is None:
                counts["unreadable"] += 1
                continue
            live_sets.append(manifest_digests(m))
        return live_sets

    report = store.sweep(live_under_lock, grace_s=grace_s, now=now)
    report["dir"] = ckpt_dir
    report["manifests"] = counts["manifests"]
    report["manifests_unreadable"] = counts["unreadable"]
    from multidisttorch_tpu_torch.telemetry.events import get_bus

    bus = get_bus()
    if bus is not None:
        bus.emit(
            "ckpt_gc",
            dir=ckpt_dir,
            orphans_removed=report["orphans_removed"],
            bytes_freed=report["orphan_bytes_freed"],
            leaked_refs_reconciled=report["leaked_refs_reconciled"],
        )
    return report
