"""Chunk-store GC: refcount reconciliation + orphan sweep over v2
checkpoint directories (docs/RESILIENCE.md "Checkpoint format v2").

    python -m multidisttorch_tpu_torch.tools.ckpt_gc <run-or-service-dir>            # sweep all
    python -m multidisttorch_tpu_torch.tools.ckpt_gc <dir> --dry-run                 # report only
    python -m multidisttorch_tpu_torch.tools.ckpt_gc <dir> --grace 60 --json

Walks every ``chunks/`` store under the given tree (one per trial
directory; pipelined stage manifests share their trial's store),
rebuilds each store's ``refs.json`` from the manifests that actually
exist — a save crashed between its chunk writes and its manifest
replace leaks counts, never corrupts — and unlinks chunks no live
manifest references. ``--grace`` (seconds, default 300) protects an
IN-FLIGHT save on a live directory: its chunks land before its
manifest, so anything younger than the grace is kept. Safe to run
against a live service; destructive only to unreferenced chunks.

The port's counterpart of the JAX package's ``tools/ckpt_gc.py``: the same walk, reports and ``--json``, over the v2
checkpoint stores either package writes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from multidisttorch_tpu_torch.train import ckpt_store


def find_ckpt_dirs(root: str) -> list[str]:
    """Every directory under ``root`` holding a ``chunks/`` store."""
    out = []
    for dirpath, dirnames, _ in os.walk(root):
        if ckpt_store.CHUNKS_DIRNAME in dirnames:
            out.append(dirpath)
        # Never descend INTO a chunk store (thousands of fanout dirs).
        dirnames[:] = [
            d for d in dirnames if d != ckpt_store.CHUNKS_DIRNAME
        ]
    return sorted(out)


def sweep_tree(
    root: str, *, grace_s: float = 300.0, dry_run: bool = False
) -> dict:
    reports = []
    totals = {
        "dirs": 0,
        "orphans_removed": 0,
        "orphan_bytes_freed": 0,
        "leaked_refs_reconciled": 0,
        "kept_in_grace": 0,
    }
    for d in find_ckpt_dirs(root):
        if dry_run:
            store = ckpt_store.ChunkStore(
                os.path.join(d, ckpt_store.CHUNKS_DIRNAME)
            )
            live: set = set()
            for p in ckpt_store.live_manifest_files(d):
                m = ckpt_store.read_manifest_file(p)
                if m is not None:
                    live |= ckpt_store.manifest_digests(m)
            on_disk = store.all_chunks()
            rep = {
                "dir": d,
                "chunks_on_disk": len(on_disk),
                "live_chunks": len(live),
                "orphans_removed": 0,
                "orphans_found": len(set(on_disk) - live),
                "orphan_bytes_freed": 0,
                "kept_in_grace": 0,
                "leaked_refs_reconciled": 0,
                "dry_run": True,
            }
        else:
            rep = ckpt_store.sweep_ckpt_dir(d, grace_s=grace_s)
            if rep is None:
                continue
        reports.append(rep)
        totals["dirs"] += 1
        for k in (
            "orphans_removed",
            "orphan_bytes_freed",
            "leaked_refs_reconciled",
            "kept_in_grace",
        ):
            totals[k] += rep.get(k, 0)
    return {"root": root, "totals": totals, "reports": reports}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="v2 checkpoint chunk-store GC "
        "(docs/RESILIENCE.md)"
    )
    parser.add_argument("root", help="run/service/trial directory")
    parser.add_argument(
        "--grace",
        type=float,
        default=300.0,
        help="keep unreferenced chunks younger than this many seconds "
        "(in-flight save protection; default 300)",
    )
    parser.add_argument(
        "--dry-run", action="store_true",
        help="report orphans without removing anything",
    )
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    out = sweep_tree(args.root, grace_s=args.grace, dry_run=args.dry_run)
    if args.json:
        print(json.dumps(out, indent=1))
    else:
        t = out["totals"]
        print(
            f"ckpt-gc {args.root}: {t['dirs']} chunk stores, "
            f"{t['orphans_removed']} orphan chunks removed "
            f"({t['orphan_bytes_freed']} bytes), "
            f"{t['leaked_refs_reconciled']} leaked refs reconciled, "
            f"{t['kept_in_grace']} kept in grace"
            + ("  [dry run]" if args.dry_run else "")
        )
        for rep in out["reports"]:
            extra = (
                f"  orphans_found {rep['orphans_found']}"
                if rep.get("dry_run")
                else f"  removed {rep['orphans_removed']}"
            )
            print(
                f"  {rep['dir']}: {rep['chunks_on_disk']} chunks, "
                f"{rep['live_chunks']} live, {rep['manifests'] if 'manifests' in rep else '?'} "
                f"manifests{extra}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
