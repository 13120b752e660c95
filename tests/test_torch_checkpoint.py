"""The port's checkpoints (``train/checkpoint.py``, ``train/ckpt_store.py``,
``train/_msgpack.py``) against the JAX package's.

- Cross-restore in both directions, v1 and v2: a file either package
  writes restores in the other with bit-identical parameters, Adam moments
  and step.
- The msgpack codec writes flax's bytes and reads them.
- Mirrors of ``tests/test_checkpoint_durability.py`` and
  ``tests/test_ckpt_v2.py`` on port states (hidden 16, latent 4): CRC
  sidecars, torn and corrupt files, keep-last scan-back, chunk sharing and
  GC.
- The state tree's layout, the in-place load (tensors keep their storage,
  Adam's lazy state is created where torch would create it) and that a
  loaded state trains on exactly as the saved one does.
"""

import json
import os
import signal
import subprocess
import sys
import time
import zlib

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multidisttorch_tpu.faults.inject import corrupt_file
from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import checkpoint as jax_ck
from multidisttorch_tpu.train.steps import build_train_state
from multidisttorch_tpu.train.steps import create_train_state as jax_create_train_state
from multidisttorch_tpu.train.steps import make_train_step as jax_make_train_step
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import _msgpack
from multidisttorch_tpu_torch.train import checkpoint as ck
from multidisttorch_tpu_torch.train import ckpt_store as cs
from multidisttorch_tpu_torch.train.steps import create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, LATENT = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group():
    return setup_groups(1, devices=["cpu"])[0]


def _state(step=0, seed=0, *, capturable=None):
    """A port state with seed-dependent weights and Adam moments at
    ``step`` (moments drawn, not trained, so every leaf differs by seed)."""
    model = init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), seed)
    state = create_train_state(_group(), model, 1e-3, capturable=capturable)
    if step:
        rng = np.random.default_rng(seed + 100)
        for p in state.model.parameters():
            st = ck._adam_state(state.optimizer, p)
            st["exp_avg"].copy_(torch.from_numpy(rng.normal(0, 1e-3, p.shape).astype(np.float32)))
            st["exp_avg_sq"].copy_(torch.from_numpy(rng.uniform(0, 1e-6, p.shape).astype(np.float32)))
            st["step"].fill_(step)
        state.step = step
    return state


def _trained(steps=3, seed=0):
    """A port state after ``steps`` real Adam steps."""
    state = _state(seed=seed)
    step = make_train_step(_group())
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = torch.from_numpy(rng.uniform(0, 1, (8, 784)).astype(np.float32))
        eps = torch.from_numpy(rng.normal(0, 1, (8, LATENT)).astype(np.float32))
        state, _ = step(state, batch, eps=eps)
    return state


def _jax_state(step=0, seed=0):
    """A JAX TrainState with random params and moments, ``count`` = ``step``."""
    s = jax.device_get(
        build_train_state(JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT), optax.adam(1e-3), jax.random.key(seed))
    )
    sd = serialization.to_state_dict(s)
    rng = np.random.default_rng(seed + 7)
    for key in ("mu", "nu"):
        sd["opt_state"]["0"][key] = jax.tree.map(
            lambda x: np.abs(rng.normal(0, 1e-3, x.shape)).astype(np.float32), sd["opt_state"]["0"][key]
        )
    sd["opt_state"]["0"]["count"] = np.asarray(step, np.int32)
    sd["step"] = np.asarray(step, np.int32)
    return serialization.from_state_dict(s, sd)


def _jax_trained(steps=3, seed=0):
    """A JAX TrainState after ``steps`` real optax Adam steps."""
    (g,) = jax_setup_groups(1, devices=jax.devices()[:1])
    model, tx = JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT), optax.adam(1e-3)
    state = jax_create_train_state(g, model, tx, jax.random.key(seed))
    step = jax_make_train_step(g, model, tx)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        state, _ = step(state, rng.uniform(0, 1, (8, 784)).astype(np.float32), jax.random.key(i))
    return jax.device_get(state)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        if not tree:
            return {prefix: "{}"}
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        if isinstance(fa[k], str):
            assert fa[k] == fb[k], k
            continue
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k]), k


def _tree(state):
    return ck.train_state_to_tree(state)


# --- the state tree -------------------------------------------------------


def test_state_tree_has_the_jax_layout_key_order_and_dtypes():
    jax_sd = serialization.to_state_dict(_jax_state())
    port = ck.train_state_to_tree(_state())
    fj, fp = _flat(jax_sd), _flat(port)
    assert list(fp) == list(fj)  # insertion order too: v1 bytes follow it
    for k in fj:
        if isinstance(fj[k], str):
            assert fp[k] == "{}"
        else:
            assert (fp[k].dtype, fp[k].shape) == (fj[k].dtype, fj[k].shape), k


def test_tree_is_a_copy_and_load_keeps_every_tensors_storage():
    src = _trained(3, seed=1)
    tree = _tree(src)
    before = tree["params"]["fc1"]["kernel"].copy()
    with torch.no_grad():
        src.model.fc1.weight.add_(1.0)
    assert np.array_equal(tree["params"]["fc1"]["kernel"], before)

    dst = _trained(2, seed=2)
    ptrs = {n: p.data_ptr() for n, p in dst.model.named_parameters()}
    adam = {n: {k: v.data_ptr() for k, v in dst.optimizer.state[p].items()}
            for n, p in dst.model.named_parameters()}
    ck.load_train_state_tree(dst, tree)
    assert {n: p.data_ptr() for n, p in dst.model.named_parameters()} == ptrs
    assert {n: {k: v.data_ptr() for k, v in dst.optimizer.state[p].items()}
            for n, p in dst.model.named_parameters()} == adam
    _assert_trees_equal(_tree(dst), tree)
    assert dst.step == 3


@pytest.mark.parametrize("capturable", [False, True])
def test_load_into_a_fresh_optimizer_creates_adams_state_where_torch_would(capturable):
    state = _state(capturable=capturable)
    assert not state.optimizer.state
    ck.load_train_state_tree(state, _tree(_trained(3, seed=1)))
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert list(st) == ["step", "exp_avg", "exp_avg_sq"]
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 3.0
        assert st["step"].device == (p.device if capturable else torch.device("cpu"))
        assert st["exp_avg"].shape == p.shape


def test_a_loaded_state_trains_on_bit_identically():
    # The resume contract at the step level: a fresh state loaded from a
    # tree takes the same next steps, bit for bit, as the state saved.
    a = _trained(3, seed=1)
    b = _state(seed=5)
    ck.load_train_state_tree(b, _tree(a))
    step = make_train_step(_group())
    rng = np.random.default_rng(9)
    for _ in range(2):
        batch = torch.from_numpy(rng.uniform(0, 1, (8, 784)).astype(np.float32))
        eps = torch.from_numpy(rng.normal(0, 1, (8, LATENT)).astype(np.float32))
        a, la = step(a, batch, eps=eps)
        b, lb = step(b, batch, eps=eps)
        assert float(la["loss_sum"]) == float(lb["loss_sum"])
    _assert_trees_equal(_tree(a), _tree(b))


def test_a_mismatched_tree_raises_and_leaves_the_state_untouched():
    state = _trained(2, seed=1)
    before = _tree(state)
    other = ck.train_state_to_tree(create_train_state(_group(), VAE(hidden_dim=8, latent_dim=LATENT), 1e-3))
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.load_train_state_tree(state, other)
    _assert_trees_equal(_tree(state), before)


# --- cross-restore --------------------------------------------------------


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_a_jax_checkpoint_restores_in_the_port_exactly(tmp_path, fmt):
    path = str(tmp_path / "state.msgpack")
    js = _jax_trained(steps=3, seed=3)
    jax_ck.save_state(js, path, metadata={"step": 3, "completed_epochs": 1}, format=fmt)
    state = _state(seed=0)
    ck.restore_state(state, path)
    _assert_trees_equal(_tree(state), serialization.to_state_dict(js))
    assert state.step == 3
    for p in state.model.parameters():
        assert float(state.optimizer.state[p]["step"]) == 3.0
    # And through the scan-back.
    state2 = _state(seed=0)
    got = ck.restore_latest_valid(state2, path)
    assert got is not None and got[2] == path
    _assert_trees_equal(_tree(state2), serialization.to_state_dict(js))


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_a_port_checkpoint_restores_in_jax_exactly(tmp_path, fmt):
    path = str(tmp_path / "state.msgpack")
    state = _trained(3, seed=2)
    ck.save_state(state, path, metadata={"step": 3, "completed_epochs": 1}, format=fmt, keep_last=2)
    template = _jax_state(seed=0)
    restored = jax_ck.restore_state(template, path)
    _assert_trees_equal(serialization.to_state_dict(jax.device_get(restored)), _tree(state))
    (g,) = jax_setup_groups(1, devices=jax.devices()[:1])
    got = jax_ck.restore_latest_valid(template, path, g)
    assert got is not None and int(got[1]["step"]) == 3
    _assert_trees_equal(serialization.to_state_dict(jax.device_get(got[0])), _tree(state))
    ok, meta, reason = jax_ck.verify_checkpoint(path + ".v0000000003")
    assert ok, reason


def test_a_port_v1_file_is_the_bytes_jax_writes(tmp_path):
    state = _trained(3, seed=4)
    ck.save_state(state, str(tmp_path / "port"), metadata={"step": 3})
    restored = jax_ck.restore_state(_jax_state(), str(tmp_path / "port"))
    jax_ck.save_state(restored, str(tmp_path / "jax"), metadata={"step": 3})
    for suffix in ("", ".json"):
        with open(str(tmp_path / "port") + suffix, "rb") as a, open(str(tmp_path / "jax") + suffix, "rb") as b:
            assert a.read() == b.read()


# --- the msgpack codec ----------------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "a": rng.normal(size=(3, 300)).astype(np.float32),
        "b_scalar": np.float32(2.5),
        "c_int": np.int64(-3),
        "d_empty": {},
        "e": {"b": np.array([True, False]), "k" * 40: np.arange(70000, dtype=np.uint8), "z": np.zeros((0, 3))},
        "f_many": {f"{i:02d}": np.array(i, np.int32) for i in range(20)},
        "g_high_rank": np.zeros((1,) * 17, np.float64),
        "h": np.zeros((200, 300, 1), np.int16),
        "i_f16": np.ones(5, np.float16),
    }


def test_msgpack_writes_flaxs_bytes():
    tree = _mixed_tree()
    # Sorted keys: msgpack_serialize's own copy sorts a dict's keys.
    assert _msgpack.packb(tree) == serialization.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == serialization.msgpack_serialize(tree, in_place=True)
    js = _jax_state(step=5, seed=1)
    assert _msgpack.packb(serialization.to_state_dict(js)) == serialization.to_bytes(js)


def test_msgpack_reads_flaxs_bytes():
    blob = serialization.msgpack_serialize(_mixed_tree())
    ours, theirs = _msgpack.unpackb(blob), serialization.msgpack_restore(blob)
    fo, ft = _flat(ours), _flat(theirs)
    assert list(fo) == list(ft)
    for k in fo:
        assert type(fo[k]) is type(ft[k])
        if not isinstance(fo[k], str):
            assert fo[k].dtype == ft[k].dtype and np.array_equal(fo[k], ft[k]), k
    assert type(ours["b_scalar"]) is np.float32 and ours["b_scalar"] == np.float32(2.5)


def test_msgpack_refuses_what_flax_would_chunk_or_cannot_read(monkeypatch):
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 1000)
    with pytest.raises(ValueError, match="MAX_CHUNK_SIZE"):
        _msgpack.packb({"a": np.zeros(1000, np.float32)})
    with pytest.raises(TypeError):
        _msgpack.packb({"a": [1, 2]})
    with pytest.raises(TypeError):
        _msgpack.packb({1: np.zeros(1)})
    blob = _msgpack.packb({"a": np.zeros(4, np.float32)})
    for bad in (blob[:-3], blob + b"\x00", b"\xc0"):
        with pytest.raises(ValueError):
            _msgpack.unpackb(bad)


# --- durability (tests/test_checkpoint_durability.py) --------------------


def test_crc_sidecar_written_and_verified(tmp_path):
    path = str(tmp_path / "state.msgpack")
    ck.save_state(_state(3), path, metadata={"step": 3})
    ok, meta, reason = ck.verify_checkpoint(path)
    assert ok, reason
    with open(path, "rb") as f:
        assert meta["_integrity"]["crc32"] == zlib.crc32(f.read())
    assert meta["_integrity"]["nbytes"] == os.path.getsize(path)
    corrupt_file(path)
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "crc32 mismatch" in reason


def test_verify_rejects_torn_size_and_unreadable_sidecar(tmp_path):
    path = str(tmp_path / "state.msgpack")
    ck.save_state(_state(1), path, metadata={"step": 1})
    with open(path, "ab") as f:
        f.write(b"xx")
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "size mismatch" in reason
    ck.save_state(_state(1), path, metadata={"step": 1})
    with open(path + ".json", "w") as f:
        f.write("{not json")
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "sidecar unreadable" in reason


def test_legacy_checkpoint_without_integrity_still_accepted(tmp_path):
    path = str(tmp_path / "state.msgpack")
    ck.save_state(_state(2), path, metadata={"step": 2})
    with open(path + ".json") as f:
        meta = json.load(f)
    del meta["_integrity"]
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    ok, _, reason = ck.verify_checkpoint(path)
    assert ok, reason
    os.remove(path + ".json")
    ok, _, reason = ck.verify_checkpoint(path)
    assert ok, reason
    with open(path, "r+b") as f:  # undecodable without a CRC to judge by
        f.truncate(os.path.getsize(path) // 2)
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "msgpack undecodable" in reason


def test_keep_last_retention_prunes_old_versions(tmp_path):
    path = str(tmp_path / "state.msgpack")
    for step in (8, 16, 24, 32):
        ck.save_state(_state(step), path, metadata={"step": step}, keep_last=2)
    cands = ck.checkpoint_candidates(path)
    assert cands[0] == path
    assert [os.path.basename(c) for c in cands[1:]] == ["state.msgpack.v0000000032", "state.msgpack.v0000000024"]
    assert not os.path.exists(path + ".v0000000008")
    for c in cands:
        ok, _, reason = ck.verify_checkpoint(c)
        assert ok, (c, reason)


def test_restore_latest_valid_scans_past_corruption(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s16, s24 = _state(16, seed=1), _state(24, seed=2)
    ck.save_state(s16, path, metadata={"step": 16, "completed_epochs": 2}, keep_last=2)
    ck.save_state(s24, path, metadata={"step": 24, "completed_epochs": 3}, keep_last=2)
    corrupt_file(path)
    restored, meta, used = ck.restore_latest_valid(_state(), path)
    assert int(meta["step"]) == 24 and used.endswith(".v0000000024")
    _assert_trees_equal(_tree(restored), _tree(s24))
    corrupt_file(path + ".v0000000024")
    restored, meta, used = ck.restore_latest_valid(_state(), path)
    assert int(meta["step"]) == 16 and used.endswith(".v0000000016") and restored.step == 16
    _assert_trees_equal(_tree(restored), _tree(s16))


def test_torn_write_between_state_and_sidecar_falls_back(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s8 = _state(8, seed=1)
    ck.save_state(s8, path, metadata={"step": 8, "completed_epochs": 1}, keep_last=2)
    tmp = path + ".tmp"  # a save that died after its first replace
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(_tree(_state(16, seed=9))))
    os.replace(tmp, path)
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "crc32 mismatch" in reason
    restored, meta, _ = ck.restore_latest_valid(_state(), path)
    assert int(meta["step"]) == 8
    _assert_trees_equal(_tree(restored), _tree(s8))


def test_restore_latest_valid_none_when_nothing_survives(tmp_path):
    path = str(tmp_path / "state.msgpack")
    ck.save_state(_state(8), path, metadata={"step": 8})
    corrupt_file(path)
    assert ck.restore_latest_valid(_state(), path) is None
    assert ck.restore_latest_valid(_state(), str(tmp_path / "absent")) is None


def test_restore_latest_valid_honors_accept_meta(tmp_path):
    path = str(tmp_path / "state.msgpack")
    ck.save_state(_state(8), path, metadata={"step": 8, "lr": 1e-3}, keep_last=2)
    ck.save_state(_state(16), path, metadata={"step": 16, "lr": 5e-2}, keep_last=2)
    got = ck.restore_latest_valid(_state(), path, accept_meta=lambda m: m.get("lr") == 1e-3)
    assert got is not None and int(got[1]["step"]) == 8
    assert sorted(ck.valid_candidates_by_step(path)) == [8, 16]
    assert sorted(ck.valid_candidates_by_step(path, accept_meta=lambda m: m.get("lr") == 1e-3)) == [8]


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_save_state_fsyncs_before_replace(tmp_path, monkeypatch, fmt):
    events = []
    real_replace = os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: events.append("fsync"))
    monkeypatch.setattr(os, "replace", lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    ck.save_state(_state(1), str(tmp_path / "s.msgpack"), metadata={"step": 1}, format=fmt)
    assert events.index("fsync") < events.index("replace")
    assert events.count("fsync") >= 2
    events.clear()
    ck.save_state(_state(2), str(tmp_path / "s.msgpack"), metadata={"step": 2}, fsync=False, format=fmt)
    assert "fsync" not in events


# --- format v2 (tests/test_ckpt_v2.py) ------------------------------------


def _save_v2(state, path, step, *, keep_last=1, chunk=4096, stats=None):
    return ck.save_state(state, path, metadata={"step": step, "completed_epochs": max(1, step // 8)},
                         keep_last=keep_last, format="v2", chunk_bytes=chunk, stats_out=stats)


def test_chunk_store_roundtrip_dedup_crc(tmp_path):
    store = cs.ChunkStore(str(tmp_path / "chunks"))
    blob = os.urandom(10_000)
    digest, written = store.put(blob)
    assert written == len(blob)
    digest2, written2 = store.put(blob)
    assert digest2 == digest and written2 == 0
    assert store.read(digest) == blob
    ok, reason = store.verify(digest, nbytes=len(blob))
    assert ok, reason
    with open(store.chunk_path(digest), "r+b") as f:
        f.seek(100)
        f.write(b"\xff" * 8)
    ok, reason = store.verify(digest)
    assert not ok and "crc32 mismatch" in reason
    with pytest.raises(IOError):
        store.read(digest)


def test_v2_save_restore_bitwise_and_sidecar(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s = _state(3, seed=1)
    stats = {}
    _save_v2(s, path, 3, stats=stats)
    assert stats["format"] == "v2" and stats["total_bytes"] > 0
    assert os.path.getsize(path) < stats["total_bytes"] // 10
    assert cs.is_manifest_file(path)
    ok, meta, reason = ck.verify_checkpoint(path)
    assert ok, reason
    assert meta["_format"] == "v2"
    _assert_trees_equal(_tree(ck.restore_state(_state(), path)), _tree(s))
    # The same manifest leaves, keys and order as the JAX package writes
    # for the same state.
    jpath = str(tmp_path / "jax" / "state.msgpack")
    jax_ck.save_state(jax_ck.restore_state(_jax_state(), path), jpath,
                      metadata={"step": 3, "completed_epochs": 1}, format="v2", chunk_bytes=4096)
    with open(path) as a, open(jpath) as b:
        assert json.load(a)["leaves"] == json.load(b)["leaves"]


def test_incremental_resave_references_unchanged_chunks(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s = _state(8, seed=2)
    _save_v2(s, path, 8)
    stats = {}
    _save_v2(s, path, 8, stats=stats)
    assert stats["new_bytes"] == 0 and stats["reused_bytes"] == stats["total_bytes"]
    with torch.no_grad():
        s.model.fc21.weight.add_(1.0)
        s.model.fc21.bias.add_(1.0)
    stats2 = {}
    _save_v2(s, path, 9, stats=stats2)
    fc21_bytes = (s.model.fc21.weight.numel() + s.model.fc21.bias.numel()) * 4
    assert 0 < stats2["new_bytes"] <= fc21_bytes + 2 * 4096
    _assert_trees_equal(_tree(ck.restore_state(_state(), path)), _tree(s))


def test_torn_manifest_scans_back(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s8, s16 = _state(8, seed=1), _state(16, seed=2)
    _save_v2(s8, path, 8, keep_last=2)
    _save_v2(s16, path, 16, keep_last=2)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "size mismatch" in reason
    restored, meta, used = ck.restore_latest_valid(_state(), path)
    assert int(meta["step"]) == 16 and used.endswith(".v0000000016")
    _assert_trees_equal(_tree(restored), _tree(s16))


def test_missing_chunk_scans_back_to_previous_step(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s8, s16 = _state(8, seed=1), _state(16, seed=2)
    _save_v2(s8, path, 8, keep_last=2)
    _save_v2(s16, path, 16, keep_last=2)
    store = cs.ChunkStore(cs.chunk_dir_for(path))
    unique = cs.manifest_digests(cs.read_manifest_file(path)) - cs.manifest_digests(
        cs.read_manifest_file(path + ".v0000000008"))
    assert unique
    os.remove(store.chunk_path(next(iter(unique))))
    ok, _, reason = ck.verify_checkpoint(path)
    assert not ok and "chunk-incomplete" in reason
    restored, meta, _ = ck.restore_latest_valid(_state(), path)
    assert int(meta["step"]) == 8
    _assert_trees_equal(_tree(restored), _tree(s8))


def _stable_and_moving(step, moving):
    s = _state(step, seed=0)
    with torch.no_grad():
        s.model.fc4.weight.add_(float(moving))
        s.model.fc4.bias.add_(float(moving))
    return s


def test_retention_shares_chunks_and_never_drops_referenced(tmp_path):
    path = str(tmp_path / "state.msgpack")
    store = cs.ChunkStore(cs.chunk_dir_for(path))
    for i, step in enumerate((8, 16, 24)):
        _save_v2(_stable_and_moving(step, i), path, step, keep_last=2)
    assert not os.path.exists(path + ".v0000000008")
    m24 = cs.read_manifest_file(path)
    m16 = cs.read_manifest_file(path + ".v0000000016")
    shared = cs.manifest_digests(m24) & cs.manifest_digests(m16)
    assert shared
    for cand in ck.checkpoint_candidates(path):
        ok, _, reason = ck.verify_checkpoint(cand)
        assert ok, (cand, reason)
    refs = store.refcounts()
    assert all(refs.get(d, 0) >= 2 for d in shared)
    assert set(store.all_chunks()) == cs.manifest_digests(m24) | cs.manifest_digests(m16)


def test_gc_reconciles_and_sweeps_orphans(tmp_path):
    path = str(tmp_path / "state.msgpack")
    s = _state(8, seed=3)
    _save_v2(s, path, 8)
    store = cs.ChunkStore(cs.chunk_dir_for(path))
    orphan, _ = store.put(os.urandom(5000))
    store.incr({orphan})
    rep = cs.sweep_ckpt_dir(str(tmp_path), grace_s=3600.0)
    assert rep["orphans_removed"] == 0 and rep["kept_in_grace"] == 1
    assert rep["leaked_refs_reconciled"] >= 1
    rep = cs.sweep_ckpt_dir(str(tmp_path), grace_s=0.0)
    assert rep["orphans_removed"] == 1 and not os.path.exists(store.chunk_path(orphan))
    os.remove(store.refs_path())
    rep = cs.sweep_ckpt_dir(str(tmp_path), grace_s=0.0)
    assert rep["orphans_removed"] == 0
    ok, _, reason = ck.verify_checkpoint(path)
    assert ok, reason
    _assert_trees_equal(_tree(ck.restore_state(_state(), path)), _tree(s))


_KILL_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[2])
os.environ["MDT_CKPT_PERSIST_DELAY_S"] = "0.15"
import torch
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import checkpoint as ck
from multidisttorch_tpu_torch.train.steps import create_train_state

g = setup_groups(1, devices=["cpu"])[0]
s = create_train_state(g, init_vae_params(VAE(hidden_dim=16, latent_dim=4), 0), 1e-3)
step = 0
while True:
    step += 8
    s.step = step
    ck.save_state(s, sys.argv[1], metadata={"step": step, "completed_epochs": step // 8},
                  keep_last=2, format="v2", chunk_bytes=2048)
    print("SAVED %d" % step, flush=True)
"""


def test_kill_mid_save_leaves_previous_step_restorable(tmp_path):
    path = str(tmp_path / "state.msgpack")
    proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, path, REPO], stdout=subprocess.PIPE,
                            text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    saved = 0
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("SAVED"):
                saved = int(line.split()[1])
                if saved >= 16:
                    break
        assert saved >= 16, "child never reached two durable saves"
        time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=30)
    restored, meta, _ = ck.restore_latest_valid(_state(), path)
    assert int(meta["step"]) >= saved - 8 and restored.step == int(meta["step"])
    cs.sweep_ckpt_dir(str(tmp_path), grace_s=0.0)
    got2 = ck.restore_latest_valid(_state(), path)
    assert got2 is not None and int(got2[1]["step"]) == int(meta["step"])
    _save_v2(_state(99), path, 99)
    ok, _, reason = ck.verify_checkpoint(path)
    assert ok, reason


def test_counters_count_saves_bytes_and_restores(tmp_path):
    ck.reset_ckpt_counters()
    path = str(tmp_path / "state.msgpack")
    s = _state(8, seed=1)
    _save_v2(s, path, 8)
    _save_v2(s, path, 8)
    ck.save_state(s, str(tmp_path / "v1.msgpack"), metadata={"step": 8})
    ck.restore_state(_state(), path)
    c = ck.ckpt_counters()
    assert c["saves"] == 3 and c["saves_v1"] == 1 and c["restores"] == 1
    assert c["bytes_reused"] == c["bytes_total"] - c["bytes_written"] > 0
    assert ck.default_format() == "v2"
