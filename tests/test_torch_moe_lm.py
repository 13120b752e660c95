"""The port's MoE LM (``models/transformer.py::MoETransformerLM`` over
``ops/moe.py::MoEMLP``) against the JAX package's, in one process and on
gloo worlds of 2 and 4 ranks (``tests/torch_ring_worker.py``).

Weights are flax's, carried across with ``lm_params_from_flax`` (the
router's kernel transposed). The capacity factor 0.5 serves at most half of
the tokens (``C = ceil(N·0.5/E)`` of each expert's queue, E = 2), so the
order of the queues decides which tokens drop: under sequence parallelism
the JAX package queues the *global* ``(B, T)`` tokens b-major, and the
port's ranks, each holding ``T/k`` columns, must drop the same ones.

Tolerances (f32): logits and aux rtol 1e-5 / atol 1e-6; a step's loss rel
1e-5; gradients rtol 1e-3 / atol 1e-6 (two layers, sums in another order);
K fused steps against K single steps exactly (the same loop), and against
the JAX package's scanned steps rel 1e-4.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.models.transformer import MoETransformerLM as JaxMoELM
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import lm as jax_lm
from multidisttorch_tpu_torch.models.transformer import (
    MoETransformerLM,
    init_lm_params,
    lm_params_from_flax,
    lm_params_to_flax,
    moe_lm_ep_shardings,
)
from multidisttorch_tpu_torch.ops.attention import make_flash_attention
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.lm import create_lm_state, make_lm_multi_step, make_lm_train_step

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ring_worker.py")
T = 32
DIMS = dict(vocab_size=16, d_model=16, num_heads=2, num_layers=2, num_experts=2, capacity_factor=0.5, max_len=T)
AUX_W = 1e-2
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
WORLDS = (2, 4)
STEPS, LR = 25, 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens():
    # the JAX package's SP test pattern, four rows so that 4 ranks split them
    base = np.tile(np.arange(8), T // 8 + 1)[:T]
    return np.stack([base, (base + 3) % 16, (base + 5) % 16, (base + 7) % 16]).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    p = JaxMoELM(**DIMS).init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    return jax.device_get(p)


def _carried(params, **kw):
    model = MoETransformerLM(**DIMS, **kw)
    model.load_state_dict(lm_params_from_flax(params))
    return model


def _jax_loss_and_grads(params, tokens):
    model = JaxMoELM(**DIMS)

    def loss(p):
        logits, aux = model.apply({"params": p}, tokens)
        return jax_lm.lm_loss_mean(logits, tokens) + AUX_W * aux

    val, grads = jax.value_and_grad(loss)(params)
    return float(val), lm_params_from_flax(jax.device_get(grads))


@pytest.fixture(scope="module")
def jax_step(flax_params):
    return _jax_loss_and_grads(flax_params, jnp.asarray(_tokens()))


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), err_msg=name, **GRAD_TOL)


def test_capacity_drops_tokens():
    n = _tokens().size
    cap = max(1, math.ceil(n * DIMS["capacity_factor"] / DIMS["num_experts"]))
    assert DIMS["num_experts"] * cap < n  # some tokens must drop, whatever the routing


def test_logits_and_aux_match_flax(flax_params):
    tokens = _tokens()
    ref_logits, ref_aux = JaxMoELM(**DIMS).apply({"params": flax_params}, jnp.asarray(tokens))
    logits, aux = _carried(flax_params)(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
    assert aux.item() == pytest.approx(float(ref_aux), rel=1e-5)


def test_flash_attention_gives_the_same_logits(flax_params):
    tokens = torch.from_numpy(_tokens()).long()
    dense = _carried(flax_params)(tokens)[0]
    flash = _carried(flax_params, attention=make_flash_attention(causal=True))(tokens)[0]
    np.testing.assert_allclose(flash.detach().numpy(), dense.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_params_round_trip_with_flax_names(flax_params):
    model = _carried(flax_params)
    back = lm_params_to_flax(model.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(flax_params)
    for path, leaf in flat_ref:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))
    assert len(jax.tree_util.tree_leaves(back)) == len(flat_ref)


def test_init_matches_flax_distributions(flax_params):
    model = init_lm_params(MoETransformerLM(**{**DIMS, "d_model": 64, "num_experts": 4}), 0)
    ref = jax.device_get(JaxMoELM(**{**DIMS, "d_model": 64, "num_experts": 4}).init(
        jax.random.key(1), jnp.zeros((1, T), jnp.int32))["params"])
    mine = lm_params_from_flax(lm_params_to_flax(model.state_dict()))
    for name, want in lm_params_from_flax(ref).items():
        got = mine[name]
        assert got.shape == want.shape, name
        # std within 15 % (a few thousand draws per tensor); zeros and ones exactly
        if float(want.std()) == 0.0:
            np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=name)
        else:
            assert float(got.std()) == pytest.approx(float(want.std()), rel=0.15), name


def test_one_step_matches_jax(flax_params, jax_step):
    g = setup_groups(1, devices=["cpu"])[0]
    state = create_lm_state(g, _carried(flax_params), 0.0)
    state, m = make_lm_train_step(g)(state, torch.from_numpy(_tokens()).long())
    loss, grads = jax_step
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    _assert_grads({k: p.grad for k, p in state.model.named_parameters()}, grads)


def test_multi_step_matches_sequential_and_jax(flax_params):
    # The fused (K, B, T) chunk is a loop of the single step: the same
    # losses; the aux term flows through both. JAX's scanned steps agree.
    g = setup_groups(1, devices=["cpu"])[0]
    chunks = np.random.default_rng(4).integers(0, 16, (3, 4, T)).astype(np.int32)
    seq = create_lm_state(g, _carried(flax_params), LR)
    step = make_lm_train_step(g)
    seq_losses = [float(step(seq, torch.from_numpy(c).long())[1]["loss"]) for c in chunks]
    fused = create_lm_state(g, _carried(flax_params), LR)
    fused, m = make_lm_multi_step(g)(fused, torch.from_numpy(chunks).long())
    assert m["loss"].tolist() == seq_losses and fused.step == seq.step == 3

    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    jmodel = JaxMoELM(**DIMS)
    tx = optax.adam(LR)
    from multidisttorch_tpu.train.steps import TrainState

    jstate = TrainState(params=jax.tree_util.tree_map(jnp.asarray, flax_params),
                        opt_state=tx.init(flax_params), step=jnp.zeros((), jnp.int32))
    _, jm = jax_lm.make_lm_multi_step(jtrial, jmodel, tx)(jstate, jnp.asarray(chunks))
    np.testing.assert_allclose(seq_losses, np.asarray(jm["loss"]), rtol=1e-4)


def test_remat_gives_the_same_gradients(flax_params, jax_step):
    # per-block checkpointing re-runs each block's forward, routing included
    g = setup_groups(1, devices=["cpu"])[0]
    state = create_lm_state(g, _carried(flax_params, remat=True), 0.0)
    state, m = make_lm_train_step(g)(state, torch.from_numpy(_tokens()).long())
    loss, grads = jax_step
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    _assert_grads({k: p.grad for k, p in state.model.named_parameters()}, grads)


def test_expert_parallel_shardings_raise():
    with pytest.raises(NotImplementedError, match="A.13"):
        moe_lm_ep_shardings(setup_groups(1, devices=["cpu"])[0], MoETransformerLM(**DIMS))


# --- gloo worlds -------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(flax_params, tmp_path_factory):
    from test_torch_groups import _launch

    tmp = tmp_path_factory.mktemp("moe_lm")
    inp = str(tmp / "in.pt")
    torch.save({
        "jobs": ["moe_lm", "moe_lm_dp"],
        "moe_lm": {"dims": DIMS, "weights": lm_params_from_flax(flax_params), "attentions": ["ring", "ring_flash"],
                   "tokens": torch.from_numpy(_tokens()).long(), "steps": STEPS, "lr": LR},
    }, inp)
    got = {}
    for k in WORLDS:
        outs = [str(tmp / f"w{k}-rank{r}.pt") for r in range(k)]
        _launch(lambda r: [sys.executable, WORKER, inp, outs[r]], k, timeout=240)
        got[k] = [torch.load(o) for o in outs]
    return got


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_sequence_parallel_routing_and_aux_match_jax(worlds, jax_step, k, attention):
    # Each rank's T/k columns queue behind every rank's earlier rows and the
    # lower ranks' share of its own row: the group drops JAX's tokens, its
    # aux is the group's, and the summed gradients are JAX's.
    loss, grads = jax_step
    for r in worlds[k]:
        got = r["moe_lm"][attention]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        _assert_grads(got["grads"], grads)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_moe_lm_trains_with_sequence_parallelism(worlds, k, attention):
    losses = [r["moe_lm"][attention]["losses"] for r in worlds[k]]
    assert all(x == losses[0] for x in losses)  # the group's loss on every rank
    assert losses[0][-1] < 0.5 * losses[0][0], losses[0]


@pytest.mark.parametrize("k", WORLDS)
def test_data_parallel_moe_lm_routes_the_group_batch(worlds, jax_step, k):
    # Rows over the ranks (DDP): the group's batch routed as one, the aux
    # the group's, DDP's mean the JAX gradient.
    loss, grads = jax_step
    for r in worlds[k]:
        got = r["moe_lm_dp"]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        _assert_grads(got["grads"], grads)
