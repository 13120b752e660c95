"""Trial-state checkpoint and resume with crash-safe durability.

Counterpart of ``multidisttorch_tpu/train/checkpoint.py``, with the same
files on disk, so either package restores the other's checkpoints:

- **The state tree.** A checkpoint holds the JAX package's ``TrainState``
  state dict: ``params`` (the model's flax tree: for the VAE
  ``{fc1..fc4}/{bias,kernel}``, a flax ``kernel`` being a torch ``weight``
  transposed), ``opt_state/0/{count,mu,nu}`` (optax's Adam state:
  ``count`` int32, ``mu``/``nu`` torch Adam's ``exp_avg``/``exp_avg_sq``
  in the parameters' tree and layout), ``opt_state/1`` (optax's empty
  state, an empty map) and ``step`` (int32). The model family converts
  its own tree: ``model.params_to_flax`` / ``model.params_from_flax``
  (``models/vae.py``, and ``models/_flax.py`` for the conv β-VAE, the MoE
  VAE and ResNet), for the parameters and Adam's moments alike.
  :func:`train_state_to_tree` builds it from a live port
  :class:`~multidisttorch_tpu_torch.train.steps.TrainState`, as host
  copies; :func:`load_train_state_tree` writes one into a live state in
  place.
- **v1** is the whole tree as one flax msgpack blob (``train/_msgpack.py``
  writes flax's bytes); **v2** is a manifest over the content-addressed
  chunk store (``train/ckpt_store.py``).
- **Atomic + durable writes**: tmp file, ``fsync``, ``os.replace``,
  directory ``fsync``. The metadata sidecar (``path + ".json"``) records
  the state file's CRC32 and size (``_integrity``), so a reader tells a
  valid checkpoint from a torn or rotted one, and "state newer than
  sidecar" from a healthy pair.
- **Keep-last-K retention**: each save also keeps ``{path}.v{step}``
  (an independent copy; for v2 only the manifest, its chunks shared) and
  prunes beyond K, so a torn latest still has history behind it;
  :func:`restore_latest_valid` scans back through it.

Restores copy into the live state's own tensors and never replace them:
a CUDA graph captured over a trial's parameters and Adam state keeps their
addresses (``train/steps.py::GraphedMultiStep``).

Telemetry: the JAX package's checkpoint events ride the bus when it is on
(``ckpt_save`` once a save has landed, ``ckpt_restore``, the restore scan's
``ckpt_scan_reject`` with its reason, ``ckpt_scan_restore`` and
``ckpt_scan_none``; ``ckpt_store.sweep_ckpt_dir`` emits ``ckpt_gc``).

Not ported here: the JAX package's RAM snapshot cache (ROADMAP A.12's
drain) and its coordination-service ``agreed_restore_step`` (A.11); a
multi-rank group agrees on its restore step over its own process group
(``hpo/driver.py``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch

from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.train import _msgpack, ckpt_store
from multidisttorch_tpu_torch.train.steps import TrainState

_VERSION_RE = re.compile(r"\.v(\d+)$")


def default_format() -> str:
    """The checkpoint format new saves use: ``MDT_CKPT_FORMAT`` env
    (``v1`` = full-msgpack, ``v2`` = chunked manifests, the default).
    Restore sniffs each file, so a v1 history under a v2 primary scans
    back fine."""
    fmt = os.environ.get("MDT_CKPT_FORMAT", "v2")
    return "v1" if fmt == "v1" else "v2"


# Process-wide checkpoint counters (plain ints, always on).
_CKPT_LOCK = threading.Lock()
_CKPT_COUNTERS = {
    "saves": 0,
    "saves_v1": 0,
    "bytes_total": 0,
    "bytes_written": 0,
    "bytes_reused": 0,
    "chunks_written": 0,
    "restores": 0,
}


def ckpt_counters() -> dict:
    with _CKPT_LOCK:
        return dict(_CKPT_COUNTERS)


def reset_ckpt_counters() -> None:
    with _CKPT_LOCK:
        for k in _CKPT_COUNTERS:
            _CKPT_COUNTERS[k] = 0


def _count(**kw) -> None:
    with _CKPT_LOCK:
        for k, v in kw.items():
            _CKPT_COUNTERS[k] += v


# --------------------------------------------------------------------
# the state tree
# --------------------------------------------------------------------


def train_state_to_tree(state: TrainState) -> dict:
    """The JAX package's ``TrainState`` state dict for ``state``, as host
    copies (numpy arrays that no later step changes). A fresh optimizer
    with no Adam state yet gives zero moments, as ``optax.adam``'s init."""
    model = state.model
    named = dict(model.named_parameters())
    opt_state = state.optimizer.state
    moments = {}
    for key, optax_key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        moments[optax_key] = model.params_to_flax(
            {n: opt_state[p][key] if opt_state.get(p) else torch.zeros_like(p) for n, p in named.items()}
        )
    step = np.array(state.step, dtype=np.int32)
    return {
        "params": model.params_to_flax(model.state_dict()),
        "opt_state": {"0": {"count": step.copy(), "mu": moments["mu"], "nu": moments["nu"]}, "1": {}},
        "step": step,
    }


def _adam_state(optimizer: torch.optim.Adam, p: torch.Tensor) -> dict:
    """``optimizer.state[p]``, created first (as ``Adam._init_group``
    would at the first step) when the optimizer has not stepped yet."""
    st = optimizer.state[p]
    if not st:
        group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
        if group["amsgrad"]:
            raise NotImplementedError("amsgrad has no optax counterpart in the checkpoint tree")
        on_device = group["capturable"] or group["fused"]
        st["step"] = torch.zeros((), dtype=torch.float32, device=p.device if on_device else "cpu")
        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return st


def load_train_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Write a state tree into the live ``state`` in place: parameters,
    Adam's ``exp_avg``/``exp_avg_sq``/``step`` (created first on a fresh
    optimizer) and ``state.step``. Every tensor keeps its storage; nothing
    is reassigned and ``load_state_dict`` is never called. Every leaf is
    checked before the first copy, so a tree that does not fit raises
    with the state untouched."""
    adam = tree["opt_state"]["0"]
    if tree["opt_state"]["1"] != {}:
        raise ValueError("opt_state/1 must be optax's empty state")
    from_flax = state.model.params_from_flax
    parts = {"param": from_flax(tree["params"]), "exp_avg": from_flax(adam["mu"]), "exp_avg_sq": from_flax(adam["nu"])}
    named = dict(state.model.named_parameters())
    for what, values in parts.items():
        for n, p in named.items():
            if n not in values:
                raise ValueError(f"{what} {n}: not in the checkpoint")
            if values[n].shape != p.shape:
                raise ValueError(f"{what} {n}: checkpoint shape {tuple(values[n].shape)}, state {tuple(p.shape)}")
    count = int(np.asarray(adam["count"]))
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(parts["param"][n])
            st = _adam_state(state.optimizer, p)
            st["exp_avg"].copy_(parts["exp_avg"][n])
            st["exp_avg_sq"].copy_(parts["exp_avg_sq"][n])
            st["step"].fill_(count)
    state.step = int(np.asarray(tree["step"]))
    return state


# --------------------------------------------------------------------
# save
# --------------------------------------------------------------------

_write_atomic = ckpt_store.write_atomic


def _copy_replace(src: str, dst: str) -> None:
    """Atomically make ``dst`` an independent COPY of ``src``. A hard link
    would share the inode, and in-place corruption of the primary would
    garble its newest retained version with it."""
    tmp = f"{dst}.{os.getpid()}.{threading.get_ident()}.tmp"
    shutil.copy2(src, tmp)
    os.replace(tmp, dst)


def save_state(
    state: Union[TrainState, dict],
    path: str,
    *,
    metadata: Optional[dict] = None,
    keep_last: int = 1,
    fsync: bool = True,
    format: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    stats_out: Optional[dict] = None,
) -> str:
    """Write ``state`` (a :class:`TrainState`, or its
    :func:`train_state_to_tree`) to ``path``.

    Writes are atomic and durable (tmp file + ``fsync`` + ``os.replace`` +
    directory ``fsync``). The state file lands before the metadata
    sidecar, which carries the state's CRC32 (``_integrity``).
    ``keep_last=K`` (K > 1) also retains the K newest checkpoints as
    ``{path}.v{step}`` (version = ``metadata['step']`` when present, else
    a counter). ``fsync=False`` skips the durability syncs.

    ``format`` is ``"v1"`` (the default here, for direct callers; the
    driver passes :func:`default_format`) or ``"v2"``. ``stats_out``
    receives the save's written/reused byte split.
    """
    fmt = format if format is not None else "v1"
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = state if isinstance(state, dict) else train_state_to_tree(state)
    # Test seam: a bounded persist delay makes the snapshot-vs-persist
    # split observable on states whose serialize+fsync takes microseconds.
    delay = float(os.environ.get("MDT_CKPT_PERSIST_DELAY_S", "0") or 0)
    if delay > 0:
        time.sleep(delay)
    if fmt == "v2":
        stats = _save_state_v2(tree, path, metadata=metadata, keep_last=keep_last,
                               fsync=fsync, chunk_bytes=chunk_bytes)
    else:
        blob = _msgpack.packb(tree)
        _write_atomic(path, blob, fsync=fsync)
        meta = dict(metadata) if metadata is not None else {}
        meta["_integrity"] = {"crc32": zlib.crc32(blob), "nbytes": len(blob)}
        _write_atomic(path + ".json", json.dumps(meta, indent=2, default=str).encode(), fsync=fsync)
        if keep_last > 1:
            _retain_version(path, meta, keep_last)
        stats = {
            "format": "v1",
            "total_bytes": len(blob),
            "new_bytes": len(blob),
            "reused_bytes": 0,
            "chunks": 0,
            "chunks_written": 0,
            "delta_ratio": 1.0,
        }
        _count(saves_v1=1)
    _count(
        saves=1,
        bytes_total=stats["total_bytes"],
        bytes_written=stats["new_bytes"],
        bytes_reused=stats["reused_bytes"],
        chunks_written=stats["chunks_written"],
    )
    if stats_out is not None:
        stats_out.update(stats)
    bus = get_bus()
    if bus is not None:
        # Emitted once the whole save (state, CRC sidecar, retention) has
        # landed, so wall_s covers the full checkpoint cost. Runs on the
        # driver's background writer thread; the bus is locked.
        meta_src = metadata if metadata is not None else {}
        bus.emit(
            "ckpt_save",
            step=meta_src.get("step"),
            path=path,
            nbytes=stats["total_bytes"],
            epoch=meta_src.get("completed_epochs"),
            wall_s=round(time.perf_counter() - t0, 6),
            format=stats["format"],
            new_bytes=stats["new_bytes"],
            reused_bytes=stats["reused_bytes"],
        )
    return path


def _save_state_v2(tree: dict, path: str, *, metadata, keep_last, fsync, chunk_bytes) -> dict:
    """The v2 save: chunks first, refcounts second, manifest third,
    old-manifest decrement last. A crash at any instant leaves the previous
    candidate restorable and at worst leaks chunks for the orphan sweep
    (``ckpt_store.sweep_ckpt_dir``), never corrupts."""
    store = ckpt_store.ChunkStore(ckpt_store.chunk_dir_for(path), fsync=fsync)
    manifest, stats = ckpt_store.build_manifest(
        tree,
        store,
        metadata=metadata,
        chunk_bytes=(
            int(chunk_bytes)
            if chunk_bytes
            else int(os.environ.get("MDT_CKPT_CHUNK_BYTES", ckpt_store.DEFAULT_CHUNK_BYTES))
        ),
    )
    new_digests = ckpt_store.manifest_digests(manifest)
    blob = ckpt_store.manifest_bytes(manifest)
    new_step = (metadata or {}).get("step")
    # Increment + manifest replace are ONE critical section: a GC's refs
    # rebuild must never land between them. The displaced manifest is
    # identified inside it, and a save only moves the primary FORWARD (a
    # late persist of an older step never replaces newer work).
    with store.locked():
        displaced = ckpt_store.read_manifest_file(path)
        if displaced is not None and new_step is not None:
            try:
                cur_step = int((displaced.get("meta") or {}).get("step"))
            except (TypeError, ValueError):
                cur_step = None
            if cur_step is not None and cur_step > int(new_step):
                stats["superseded_by_step"] = cur_step
                return stats
        displaced_digests = ckpt_store.manifest_digests(displaced) if displaced else set()
        store._incr_unlocked(new_digests)
        _write_atomic(path, blob, fsync=fsync)
        # The sidecar inside the same section: {manifest, sidecar} publish
        # as a pair.
        meta = dict(metadata) if metadata is not None else {}
        meta["_integrity"] = {"crc32": zlib.crc32(blob), "nbytes": len(blob)}
        meta["_format"] = "v2"
        _write_atomic(path + ".json", json.dumps(meta, indent=2, default=str).encode(), fsync=fsync)
    if keep_last > 1:
        _retain_version(path, meta, keep_last, store=store)
    store.decr(displaced_digests)
    return stats


def _versions(path: str) -> list[tuple[int, str]]:
    """Existing ``{path}.v{N}`` siblings, newest first."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if not name.startswith(base + ".v") or name.endswith((".json", ".tmp")):
            continue
        m = _VERSION_RE.search(name)
        if m:
            out.append((int(m.group(1)), os.path.join(d, name)))
    out.sort(reverse=True)
    return out


def _retain_version(path: str, meta: dict, keep_last: int, *, store=None) -> None:
    """Retain ``{path}.v{step}`` and prune beyond K. v1 copies the whole
    state file; v2 copies only the manifest and keeps the refcounts exact
    (+1 before the copy lands, -1 after a pruned version is gone), so
    pruning never drops a chunk a retained manifest references."""
    step = meta.get("step")
    if step is None:
        existing = _versions(path)
        step = (existing[0][0] + 1) if existing else 1
    ver = f"{path}.v{int(step):010d}"
    if store is not None:
        with store.locked():
            displaced = ckpt_store.read_manifest_file(ver)
            m = ckpt_store.read_manifest_file(path)
            if m is not None:
                store._incr_unlocked(ckpt_store.manifest_digests(m))
            _copy_replace(path, ver)
            _copy_replace(path + ".json", ver + ".json")
        if displaced is not None:
            store.decr(ckpt_store.manifest_digests(displaced))
    else:
        _copy_replace(path, ver)
        _copy_replace(path + ".json", ver + ".json")
    for _, old in _versions(path)[keep_last:]:
        old_m = ckpt_store.read_manifest_file(old) if store is not None else None
        removed_manifest = False
        for p in (old, old + ".json"):
            try:
                os.remove(p)
                removed_manifest = removed_manifest or p == old
            except OSError:
                pass
        if store is not None and old_m is not None and removed_manifest:
            # Only the writer that removed the file decrements.
            store.decr(ckpt_store.manifest_digests(old_m))


# --------------------------------------------------------------------
# verify and restore
# --------------------------------------------------------------------


def checkpoint_candidates(path: str) -> list[str]:
    """Restore candidates, newest first: the primary path, then retained
    versions in descending version order."""
    return [path] + [p for _, p in _versions(path)]


def verify_checkpoint(path: str) -> tuple[bool, Optional[dict], str]:
    """``(ok, metadata, reason)`` for one candidate file.

    Valid when the sidecar parses and the state bytes match its
    CRC32/length, and, for a v2 manifest, every referenced chunk is
    present, sized and CRC-clean. A checkpoint without ``_integrity`` (or
    without a sidecar) falls back to a structural decode.
    """
    if not os.path.exists(path):
        return False, None, "missing"
    meta: Optional[dict] = None
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            return False, None, f"sidecar unreadable: {e}"
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        return False, meta, f"state unreadable: {e}"
    integ = (meta or {}).get("_integrity")
    if integ is not None:
        if len(blob) != int(integ.get("nbytes", -1)):
            return False, meta, (
                f"size mismatch ({len(blob)} vs recorded {integ.get('nbytes')}) — torn write"
            )
        if zlib.crc32(blob) != int(integ.get("crc32", -1)):
            return False, meta, "crc32 mismatch — corrupt or torn state"
        return _verify_chunks_if_v2(path, blob, meta)
    if ckpt_store.is_manifest_blob(blob):
        return _verify_chunks_if_v2(path, blob, meta)
    try:  # no CRC recorded: structural check only
        _msgpack.unpackb(blob)
    except Exception as e:  # noqa: BLE001 — any decode failure disqualifies
        return False, meta, f"msgpack undecodable: {e}"
    return True, meta, "ok"


def _verify_chunks_if_v2(path: str, blob: bytes, meta: Optional[dict]):
    if not ckpt_store.is_manifest_blob(blob):
        return True, meta, "ok"
    try:
        manifest = ckpt_store.load_manifest(blob)
    except Exception as e:  # noqa: BLE001 — undecodable manifest = torn
        return False, meta, f"manifest undecodable: {e}"
    store = ckpt_store.ChunkStore(ckpt_store.chunk_dir_for(path))
    ok, reason = ckpt_store.verify_manifest_chunks(manifest, store)
    if not ok:
        return False, meta, f"chunk-incomplete: {reason}"
    return True, meta, "ok"


def valid_candidates_by_step(
    path: str, *, accept_meta: Optional[Callable[[dict], bool]] = None
) -> dict[int, tuple[str, dict]]:
    """Verifiable restore candidates keyed by their recorded optimizer
    step, ``{step: (candidate_path, metadata)}``, the newest candidate
    winning a step collision. Candidates that fail ``accept_meta`` or
    record no ``step`` are left out. The read side of a multi-rank
    group's restore agreement."""
    bus = get_bus()
    out: dict[int, tuple[str, dict]] = {}
    for cand in checkpoint_candidates(path):
        ok, meta, reason = verify_checkpoint(cand)
        if not ok:
            if bus is not None and reason != "missing":
                bus.emit("ckpt_scan_reject", path=cand, reason=reason)
            continue
        meta = meta or {}
        if accept_meta is not None and not accept_meta(meta):
            if bus is not None:
                bus.emit("ckpt_scan_reject", path=cand, reason="meta rejected")
            continue
        if "step" not in meta:
            continue
        out.setdefault(int(meta["step"]), (cand, meta))
    return out


def _read_tree(path: str) -> dict:
    return _read_tree_format(path)[0]


def _read_tree_format(path: str) -> tuple[dict, str]:
    """The state tree at ``path`` and its format, ``"v1"`` or ``"v2"``."""
    with open(path, "rb") as f:
        blob = f.read()
    if ckpt_store.is_manifest_blob(blob):
        manifest = ckpt_store.load_manifest(blob)
        return ckpt_store.restore_arrays(manifest, ckpt_store.ChunkStore(ckpt_store.chunk_dir_for(path))), "v2"
    return _msgpack.unpackb(blob), "v1"


def restore_state(state: TrainState, path: str, *, group_id: Optional[int] = None) -> TrainState:
    """Restore the checkpoint at ``path`` (v1 or v2, either package's)
    into the live ``state`` in place (:func:`load_train_state_tree`) and
    return it. Strict single-file semantics: a torn or corrupt ``path``
    raises; :func:`restore_latest_valid` is the scan-back sibling.
    ``group_id`` tags the ``ckpt_restore`` event."""
    tree, fmt = _read_tree_format(path)
    load_train_state_tree(state, tree)
    _count(restores=1)
    bus = get_bus()
    if bus is not None:
        bus.emit("ckpt_restore", group_id=group_id, path=path, format=fmt)
    return state


def restore_latest_valid(
    state: TrainState,
    path: str,
    *,
    accept_meta: Optional[Callable[[dict], bool]] = None,
    group_id: Optional[int] = None,
) -> Optional[tuple[TrainState, dict, str]]:
    """Restore the newest checkpoint that verifies, scanning back past
    torn or corrupt candidates (the latest file, then ``keep_last``
    history). ``accept_meta`` gates candidates on their sidecar; rejected
    ones are skipped like corrupt ones. Returns ``(state, metadata,
    used_path)``, or None when nothing valid remains (a supervisor then
    retries from scratch: recovery degrades, never wedges). Every rejected
    candidate is a ``ckpt_scan_reject`` bus event with its reason."""
    bus = get_bus()
    for cand in checkpoint_candidates(path):
        ok, meta, reason = verify_checkpoint(cand)
        if not ok:
            if bus is not None:
                bus.emit("ckpt_scan_reject", path=cand, reason=reason)
            continue
        meta = meta or {}
        if accept_meta is not None and not accept_meta(meta):
            if bus is not None:
                bus.emit("ckpt_scan_reject", path=cand, reason="meta rejected")
            continue
        try:
            restore_state(state, cand, group_id=group_id)
        except Exception as e:  # noqa: BLE001 — scan on (CRC can't catch all)
            if bus is not None:
                bus.emit("ckpt_scan_reject", path=cand, reason=f"restore failed: {type(e).__name__}")
            continue
        if bus is not None:
            bus.emit("ckpt_scan_restore", step=meta.get("step"), path=cand, epoch=meta.get("completed_epochs"))
        return state, meta, cand
    if bus is not None:
        bus.emit("ckpt_scan_none", path=path)
    return None
