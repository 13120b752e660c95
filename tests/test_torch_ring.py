"""Ring attention, ring-flash and the sequence-parallel LM step: the port's
rings over gloo worlds of 2 and 4 ranks against the JAX package's rings over
2 and 4 of the 8 virtual CPU devices, and against the dense reference.

Each world runs ``tests/torch_ring_worker.py`` once per rank (bounded by
``test_torch_groups._launch``'s timeout); every rank holds its ``T/k``
positions, and the ranks' chunks, concatenated, are the port's result.
Inputs come from numpy seeds; the LM's weights are flax's, carried across
with ``lm_params_from_flax``. The JAX flash kernels run in interpret mode.

Tolerances (f32): attention outputs rtol 2e-5 / atol 2e-6 and gradients
rtol 5e-5 / atol 5e-6 against JAX's ring (the same math, summed in another
order; JAX's own ring-vs-dense test allows the same); ring-flash outputs
rtol 2e-4 / atol 2e-5 and gradients rtol 5e-4 / atol 5e-5 against dense (the
JAX package's ring-flash tests' bounds); extreme logits rtol 1e-4 / atol
1e-5; the LM's loss rel 1e-5 and gradients rtol 1e-3 / atol 1e-6 against
JAX's dense and ring models (JAX holds its ring to dense at rtol 5e-3).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multidisttorch_tpu.models.transformer import TransformerLM as JaxLM
from multidisttorch_tpu.ops.pallas_attention import make_ring_flash_attention as jax_ring_flash
from multidisttorch_tpu.ops.ring_attention import dense_attention_reference as jax_dense
from multidisttorch_tpu.ops.ring_attention import make_ring_attention as jax_ring
from multidisttorch_tpu.parallel.mesh import DATA_AXIS
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import lm as jax_lm
from multidisttorch_tpu_torch.models.transformer import TransformerLM, init_lm_params, lm_params_from_flax
from multidisttorch_tpu_torch.ops import attention as A
from multidisttorch_tpu_torch.ops.ring_attention import dense_attention_reference, make_ring_attention
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.lm import create_lm_state, make_lm_eval_step, make_lm_train_step

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ring_worker.py")
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)
FLASH_OUT_TOL = dict(rtol=2e-4, atol=2e-5)
FLASH_GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
LM_GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
LM_DIMS = dict(vocab_size=17, d_model=32, num_heads=2, num_layers=2, max_len=64)
B, T, H, D = 2, 32, 2, 8
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed=0, b=B, t=T, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _lm_tokens():
    return np.random.default_rng(1).integers(0, LM_DIMS["vocab_size"], (2, T)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_lm():
    params = JaxLM(**LM_DIMS).init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    return jax.device_get(params)


@pytest.fixture(scope="module")
def worlds(flax_lm, tmp_path_factory):
    """Each world's per-rank results: ``{k: [rank 0's, rank 1's, ...]}``."""
    from test_torch_groups import _launch

    tmp = tmp_path_factory.mktemp("ring")
    inp = str(tmp / "in.pt")
    torch.save({
        "jobs": ["ring", "extreme", "lm"],
        "qkv": [torch.from_numpy(a) for a in _qkv()],
        "lm": {"dims": LM_DIMS, "weights": lm_params_from_flax(flax_lm), "attentions": ["ring", "ring_flash"],
               "tokens": torch.from_numpy(_lm_tokens()).long()},
    }, inp)
    got = {}
    for k in WORLDS:
        outs = [str(tmp / f"w{k}-rank{r}.pt") for r in range(k)]
        _launch(lambda r: [sys.executable, WORKER, inp, outs[r]], k, timeout=240)
        got[k] = [torch.load(o) for o in outs]
    return got


def _cat(ranks, get):
    return np.concatenate([get(r).detach().numpy() for r in ranks], axis=1)


def _jax_trial(k):
    return jax_setup_groups(8 // k)[0]


def _jax_attention_and_grads(fn, q, k, v):
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    out = fn(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_and_dense(worlds, k, causal):
    ranks = [r["ring"][("ring", causal)] for r in worlds[k]]
    trial = _jax_trial(k)
    assert trial.size == k
    ref, ref_grads = _jax_attention_and_grads(jax_ring(trial, causal=causal), *_qkv())
    np.testing.assert_allclose(_cat(ranks, lambda r: r["out"]), ref, **OUT_TOL)
    dense = np.asarray(jax_dense(*(jnp.asarray(a) for a in _qkv()), causal=causal))
    np.testing.assert_allclose(_cat(ranks, lambda r: r["out"]), dense, **OUT_TOL)
    for i, g in enumerate(ref_grads):
        np.testing.assert_allclose(_cat(ranks, lambda r: r["grads"][i]), g, **GRAD_TOL)


@pytest.mark.parametrize("k", WORLDS)
def test_extreme_logits_stable(worlds, k):
    # large scores: the online softmax must not overflow
    got = _cat([r["extreme"] for r in worlds[k]], lambda r: r["out"])
    q, kk, v = (jnp.asarray(a) for a in _qkv())
    ref = np.asarray(jax_ring(_jax_trial(k))(q * 40.0, kk, v))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_dense(q * 40.0, kk, v)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_jax_and_dense(worlds, k, causal):
    ranks = [r["ring"][("ring_flash", causal)] for r in worlds[k]]
    trial = _jax_trial(k)
    sh = trial.sharding(None, DATA_AXIS)
    q, kk, v = (jax.device_put(jnp.asarray(a), sh) for a in _qkv())
    ref = np.asarray(jax_ring_flash(trial, causal=causal)(q, kk, v))
    got = _cat(ranks, lambda r: r["out"])
    np.testing.assert_allclose(got, ref, **FLASH_OUT_TOL)
    dense, dense_grads = _jax_attention_and_grads(lambda q, k, v: jax_dense(q, k, v, causal=causal), *_qkv())
    np.testing.assert_allclose(got, dense, **FLASH_OUT_TOL)
    # Gradients flow through the hop combination into the kernels' backward,
    # the lse cotangent included.
    for i, g in enumerate(dense_grads):
        np.testing.assert_allclose(_cat(ranks, lambda r: r["grads"][i]), g, **FLASH_GRAD_TOL)


def _jax_lm_loss_and_grads(params, model, tokens):
    def loss(p):
        return jax_lm.lm_loss_mean(model.apply({"params": p}, tokens), tokens)

    val, grads = jax.value_and_grad(loss)(params)
    return float(val), lm_params_from_flax(jax.device_get(grads))


@pytest.fixture(scope="module")
def jax_dense_lm(flax_lm):
    tokens = jnp.asarray(_lm_tokens())
    return _jax_lm_loss_and_grads(flax_lm, JaxLM(**LM_DIMS), tokens)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_sequence_parallel_lm_grads_match_jax(worlds, flax_lm, jax_dense_lm, k, attention):
    # The step at lr 0: each rank's loss share and gradients, summed over
    # the ring, are JAX's dense loss and gradients on the whole rows.
    loss, grads = jax_dense_lm
    for r in worlds[k]:
        got = r["lm"][attention]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        assert set(got["grads"]) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), err_msg=name, **LM_GRAD_TOL)


@pytest.mark.parametrize("k", WORLDS)
def test_sequence_parallel_lm_grads_match_jax_ring(worlds, flax_lm, k):
    trial = _jax_trial(k)
    tokens = jax.device_put(jnp.asarray(_lm_tokens()), trial.sharding(None, DATA_AXIS))
    ring = JaxLM(**LM_DIMS, attention=jax_ring(trial, causal=True))
    loss, grads = _jax_lm_loss_and_grads(flax_lm, ring, tokens)
    got = worlds[k][0]["lm"]["ring"]
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), err_msg=name, **LM_GRAD_TOL)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_sequence_parallel_eval_matches_train_objective(worlds, jax_dense_lm, k, attention):
    # at lr 0 the step leaves the weights, so the eval is the step's loss
    for r in worlds[k]:
        got = r["lm"][attention]
        assert got["eval"] == pytest.approx(got["loss"], rel=1e-6)
        assert got["eval"] == pytest.approx(jax_dense_lm[0], rel=1e-5)
        assert got["perplexity"] == pytest.approx(float(np.exp(got["eval"])), rel=1e-5)


# --- one process -----------------------------------------------------------


def _one():
    return setup_groups(1, devices=["cpu"])[0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("make", [make_ring_attention, A.make_ring_flash_attention])
def test_ring_of_one_is_one_hop_with_no_communication(causal, make):
    # No process group: a ring of one rank sends nothing.
    q, k, v = (torch.from_numpy(a) for a in _qkv(2))
    fn = make(_one(), causal=causal)
    assert fn.carries_collectives and not fn.head_sharded
    np.testing.assert_allclose(fn(q, k, v).numpy(), dense_attention_reference(q, k, v, causal=causal).numpy(),
                               **OUT_TOL)


def test_head_sharding_and_multi_slot_groups_raise():
    for make in (make_ring_attention, A.make_ring_flash_attention):
        with pytest.raises(NotImplementedError, match="A.13.*A.15g"):
            make(_one(), causal=True, shard_heads=True)
        with pytest.raises(NotImplementedError, match="one process per device"):
            make(setup_groups(1, devices=["cpu", "cpu"])[0])


def test_hop_modes():
    assert [A.ring_hop_mode(2, s, True) for s in range(4)] == ["full", "full", "diag", "skip"]
    assert {A.ring_hop_mode(2, s, False) for s in range(4)} == {"full"}
    with pytest.raises(ValueError, match="not one of"):
        A.ring_flash_hop(*(torch.zeros(1, 1, 1),) * 3, *A.ring_flash_init(torch.zeros(1, 1, 1)), "half", 1.0)


@pytest.mark.parametrize("members", [1, 2, 4])
def test_hop_function_drives_a_ring_in_one_process(members):
    # What chip_smoke drives on the card: each member's hops in ring order
    # through the factored hop function, every mode occurring; the chunks
    # and their gradients are dense attention's.
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(3, b=1, t=64, h=2))
    t = 64 // members
    scale = 1.0 / D**0.5

    def flat(x):
        return x.transpose(1, 2).reshape(2, x.shape[1], D).contiguous()

    outs, modes = [], set()
    for r in range(members):
        qf = flat(q[:, r * t : (r + 1) * t])
        m, l, acc = A.ring_flash_init(qf)
        for s in range(members):
            src = (r - s) % members
            mode = A.ring_hop_mode(r, src, True)
            modes.add(mode)
            m, l, acc = A.ring_flash_hop(qf, flat(k[:, src * t : (src + 1) * t]), flat(v[:, src * t : (src + 1) * t]),
                                         m, l, acc, mode, scale)
        outs.append(A.ring_flash_finish(l, acc, q.dtype).reshape(1, 2, t, D).transpose(1, 2))
    out = torch.cat(outs, dim=1)
    ref = dense_attention_reference(q, k, v, causal=True)
    assert modes == ({"diag"} if members == 1 else {"full", "diag", "skip"})
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **FLASH_OUT_TOL)
    got = torch.autograd.grad((out**2).sum(), (q, k, v))
    want = torch.autograd.grad((ref**2).sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FLASH_GRAD_TOL)


def test_layout_mismatch_raises():
    # A ring model needs sequence_parallel=True on a group of several ranks,
    # and sequence_parallel=True a ring over the step's group.
    from types import SimpleNamespace

    from multidisttorch_tpu_torch.train import lm as port_lm

    pair = SimpleNamespace(size=2)
    with pytest.raises(ValueError, match="needs a model whose attention is a ring"):
        port_lm._check_layout(pair, SimpleNamespace(sequence_group=None), True)
    with pytest.raises(ValueError, match="pass sequence_parallel=True"):
        port_lm._check_layout(pair, SimpleNamespace(sequence_group=pair), False)
    port_lm._check_layout(pair, SimpleNamespace(sequence_group=pair), True)


def test_sequence_parallel_step_on_one_rank_is_the_plain_step():
    g = _one()
    tokens = torch.from_numpy(_lm_tokens()).long()
    losses = []
    for sp, attention in ((False, None), (True, make_ring_attention(g, causal=True))):
        model = init_lm_params(TransformerLM(**LM_DIMS, attention=attention), 3)
        state = create_lm_state(g, model, 3e-3)
        step = make_lm_train_step(g, sequence_parallel=sp)
        losses.append([float(step(state, tokens)[1]["loss"]) for _ in range(3)])
        ev = make_lm_eval_step(g, sequence_parallel=sp)(state, tokens)
        losses[-1].append(float(ev["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
