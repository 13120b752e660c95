"""The port's MoE MLP and MoE VAE (``ops/moe.py``, ``models/moe_vae.py``)
against the JAX package's, and their runs through ``run_hpo`` and
per-group ``run_pbt`` with ``model_builder``.

Weights are flax's, carried across with ``MoEVAE.params_from_flax``; the
reparameterisation noise is injected. Tolerances: forward outputs and the
router's auxiliary loss rtol/atol 1e-5 in f32; one train step's loss rel
1e-5 and parameters rtol 1e-4 / atol 1e-6 (the VAE's); ``run_hpo``'s test
losses at lr 0 rel 1e-5.

- **Capacity on a multi-rank group.** The JAX package routes a group's
  whole batch as one batch; a port rank holds only its share, so the
  router offsets its queue positions by the lower ranks' counts and sizes
  the capacity from the group's batch (``MoEMLP.bind_group``). A
  two-process gloo group, each rank holding half the rows, must give the
  JAX package's full-batch outputs, loss and updated parameters, where the
  halves routed alone would not.
- **PBT decisions.** With the lrs at 1e-30 the weights cannot move in
  f32, so the scores are the carried weights' and the noise, which torch
  cannot draw as JAX does (ROADMAP C.14), does not enter: the per-group
  port run, in one process and across two, must take the JAX package's
  exploit decisions, orders and lrs exactly.
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multidisttorch_tpu.hpo import pbt as jax_pbt
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.models.moe_vae import MoEVAE as JaxMoEVAE
from multidisttorch_tpu.ops.losses import elbo_loss_sum as jax_elbo_loss_sum
from multidisttorch_tpu.ops.moe import MoEMLP as JaxMoEMLP
from multidisttorch_tpu.ops.pallas_elbo import fused_elbo_loss_sum as jax_fused
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import checkpoint as jax_ck
from multidisttorch_tpu.train.steps import build_train_state
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.models import MoEVAE, moe_vae_params_from_flax, moe_vae_params_to_flax
from multidisttorch_tpu_torch.ops.moe import MoEMLP
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import checkpoint as ck
from multidisttorch_tpu_torch.train.steps import create_train_state, make_multi_step, make_train_step
from test_torch_checkpoint import _assert_trees_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIMS = dict(hidden_dim=16, latent_dim=4, num_experts=4, capacity_factor=1.0)
LR = 1e-3
ROWS = 16


def _jax_params(model, seed: int):
    return jax.device_get(build_train_state(model, optax.adam(LR), jax.random.key(seed)).params)


def _port_model(params, **dims):
    model = MoEVAE(**(dims or DIMS))
    model.load_state_dict(model.params_from_flax(params))
    return model


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxMoEVAE(**DIMS)
    params = _jax_params(jmodel, 0)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (ROWS, 784)).astype(np.float32)
    eps = rng.normal(0, 1, (ROWS, DIMS["latent_dim"])).astype(np.float32)
    return jmodel, params, _port_model(params), x, eps


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref), rtol=rtol, atol=atol)


# --- the MoE MLP ------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 2.0])
def test_moe_mlp_matches_flax_with_drops(cf):
    rng = np.random.default_rng(int(cf * 10))
    x = rng.normal(size=(24, 6)).astype(np.float32)
    jm = JaxMoEMLP(num_experts=4, hidden_dim=8, out_dim=5, capacity_factor=cf)
    p = jax.device_get(jm.init(jax.random.key(2), x)["params"])
    y_ref, aux_ref = jm.apply({"params": p}, x)
    mine = MoEMLP(6, 4, 8, 5, cf)
    mine.load_state_dict({k.removeprefix("moe."): v for k, v in moe_vae_params_from_flax({"moe": p}).items()})
    y, aux = mine(torch.from_numpy(x))
    _close(y, y_ref)
    _close(aux, aux_ref)
    assert mine.capacity(24) == max(1, math.ceil(24 * cf / 4))
    if cf == 0.5:  # capacity 3 for 24 tokens over 4 experts: some rows are dropped
        assert int((np.abs(np.asarray(y_ref)).sum(1) == 0).sum()) > 0


def test_moe_vae_forward_matches_flax(pair):
    jmodel, params, tmodel, x, eps = pair
    mu, logvar = jmodel.apply({"params": params}, x, method=JaxMoEVAE.encode)
    z = mu + eps * jnp.exp(0.5 * logvar)
    refs = (jmodel.apply({"params": params}, z, method=JaxMoEVAE.decode), mu, logvar)
    for got, ref in zip(tmodel(torch.from_numpy(x), eps=torch.from_numpy(eps)), refs):
        _close(got, ref)
    _close(tmodel.decode_probs(torch.from_numpy(eps)), jmodel.apply({"params": params}, eps,
                                                                    method=JaxMoEVAE.decode_probs))


def test_bf16_compute_matches_flax(pair):
    # dtype=bfloat16: the Dense layers and the experts' einsums in bf16 with
    # f32 parameters, the router in f32, as flax's; bf16 storage precision
    # (2e-2), as the VAE's.
    _, params, _, x, eps = pair
    jmodel = JaxMoEVAE(**DIMS, dtype=jnp.bfloat16)
    tmodel = MoEVAE(**DIMS, dtype=torch.bfloat16)
    tmodel.load_state_dict(tmodel.params_from_flax(params))
    refs = (*jmodel.apply({"params": params}, x, method=JaxMoEVAE.encode),
            jmodel.apply({"params": params}, eps, method=JaxMoEVAE.decode))
    gots = (*tmodel.encode(torch.from_numpy(x)), tmodel.decode(torch.from_numpy(eps)))
    f32 = _port_model(params)
    for got, ref, full in zip(gots, refs, (*f32.encode(torch.from_numpy(x)), f32.decode(torch.from_numpy(eps)))):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        _close(got.float(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)
        assert not torch.equal(got.float(), full)  # the bf16 path ran


def test_flax_round_trip(pair):
    _, params, tmodel, _, _ = pair
    back = moe_vae_params_to_flax(moe_vae_params_from_flax(params))
    assert list(back) == sorted(params) and list(back["moe"]) == sorted(params["moe"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_init_matches_flax_distribution():
    # An expert kernel (E, d, h) has flax's fan-in d*E (the expert axis
    # counts as receptive field), not d: std within 3 % at full width.
    jparams = _jax_params(JaxMoEVAE(), 0)
    model = MoEVAE().init_params(0)
    tree = model.params_to_flax(model.state_dict())
    for path in (("moe", "w1"), ("moe", "w2"), ("fc1", "kernel"), ("fc4", "kernel")):
        mine, ref = tree[path[0]][path[1]], jparams[path[0]][path[1]]
        assert float(np.std(mine)) == pytest.approx(float(np.std(ref)), rel=0.03), path
    assert float(np.std(tree["moe"]["w1"])) == pytest.approx(math.sqrt(1 / (20 * 4)), rel=0.03)
    for leaf in ("b1", "b2"):
        assert float(np.abs(tree["moe"][leaf]).max()) == 0.0


# --- train steps ------------------------------------------------------------------


def _jax_step(jmodel, params, x, eps, fused, beta=1.0):
    loss_impl = jax_fused if fused else jax_elbo_loss_sum
    m = x.shape[0]

    def loss_fn(p):
        mu, logvar = jmodel.apply({"params": p}, x, method=JaxMoEVAE.encode)
        z = mu + eps * jnp.exp(0.5 * logvar)
        logits = jmodel.apply({"params": p}, z, method=JaxMoEVAE.decode)
        return loss_impl(logits, x, mu, logvar, beta) / m

    tx = optax.adam(LR)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss) * m, jax.device_get(optax.apply_updates(params, updates))


def _assert_params_close(state_dict, jparams, rtol=1e-4, atol=1e-6):
    for k, v in moe_vae_params_from_flax(jparams).items():
        got = state_dict[k]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
        np.testing.assert_allclose(got, v.numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
def test_one_train_step_matches_jax(pair, fused):
    jmodel, params, _, x, eps = pair
    jloss, jparams = _jax_step(jmodel, params, x, eps, fused)
    group = setup_groups(1, devices=["cpu"])[0]
    state = create_train_state(group, _port_model(params), LR)
    state, m = make_train_step(group, use_fused_loss=fused)(state, torch.from_numpy(x), eps=torch.from_numpy(eps))
    assert float(m["loss_sum"]) == pytest.approx(jloss, rel=1e-5)
    _assert_params_close(state.model.state_dict(), jparams)


def test_multi_step_equals_single_steps(pair):
    _, params, _, _, _ = pair
    group = setup_groups(1, devices=["cpu"])[0]
    rng = np.random.default_rng(8)
    batches = torch.from_numpy(rng.uniform(0, 1, (3, ROWS, 784)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(0, 1, (3, ROWS, 4)).astype(np.float32))
    s1, m1 = make_multi_step(group)(create_train_state(group, _port_model(params), LR), batches, eps=noise)
    s2, step = create_train_state(group, _port_model(params), LR), make_train_step(group)
    singles = []
    for k in range(3):
        s2, m = step(s2, batches[k], eps=noise[k])
        singles.append(m["loss_sum"])
    assert torch.equal(m1["loss_sum"], torch.stack(singles)) and s1.step == s2.step == 3
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, s2.model.state_dict()[k])


# --- run_hpo and checkpoints -----------------------------------------------------


@pytest.fixture
def carried(monkeypatch):
    """MoE trials and members start from the JAX package's initial weights."""
    cache = {}

    def init_from_jax(self, seed):
        key = (seed, self.hidden_dim, self.latent_dim, self.num_experts)
        if key not in cache:
            jm = JaxMoEVAE(hidden_dim=self.hidden_dim, latent_dim=self.latent_dim, num_experts=self.num_experts,
                           capacity_factor=self.moe.capacity_factor)
            cache[key] = moe_vae_params_from_flax(_jax_params(jm, seed))
        self.load_state_dict(cache[key])
        return self

    monkeypatch.setattr(MoEVAE, "init_params", init_from_jax)


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)


def test_run_hpo_at_lr0_gives_jaxs_test_losses(data, tmp_path, carried):
    train, test = data
    configs = [dict(trial_id=i, epochs=2, batch_size=32, lr=0.0, seed=i, hidden_dim=16, latent_dim=4, fused_steps=4)
               for i in range(2)]
    experts = {0: 2, 1: 4}
    jres = jax_run_hpo([JaxTrialConfig(**c) for c in configs], train, test,
                       groups=jax_setup_groups(2, devices=jax.devices()[:2]), out_dir=str(tmp_path / "jax"),
                       save_checkpoints=False, ledger=False, save_images=False, verbose=False,
                       model_builder=lambda cfg: JaxMoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim,
                                                           num_experts=experts[cfg.trial_id]))
    pres = run_hpo([TrialConfig(**c) for c in configs], train, test, groups=setup_groups(2, devices=["cpu"] * 2),
                   out_dir=str(tmp_path / "port"), save_images=False, verbose=False,
                   model_builder=lambda cfg: MoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim,
                                                    num_experts=experts[cfg.trial_id]))
    for p, j in zip(pres, jres):
        assert p.status == "completed" and p.steps == j.steps == 16
        for hp, hj in zip(p.history, j.history):
            assert hp["test_loss"] == pytest.approx(hj["test_loss"], rel=1e-5)


def _jax_state_with_drawn_moments(jmodel, seed, step):
    template = build_train_state(jmodel, optax.adam(LR), jax.random.key(seed))
    sd = serialization.to_state_dict(jax.device_get(template))
    rng = np.random.default_rng(seed + 7)
    for key in ("mu", "nu"):
        sd["opt_state"]["0"][key] = jax.tree.map(
            lambda a: np.abs(rng.normal(0, 1e-3, a.shape)).astype(np.float32), sd["opt_state"]["0"][key])
    sd["opt_state"]["0"]["count"] = np.asarray(step, np.int32)
    sd["step"] = np.asarray(step, np.int32)
    return template, sd


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_v1_checkpoints_cross_with_equal_bytes(pair, tmp_path, direction):
    jmodel, params, _, x, eps = pair
    group = setup_groups(1, devices=["cpu"])[0]
    template, sd = _jax_state_with_drawn_moments(jmodel, 3, 5)
    if direction == "port_to_jax":
        state = create_train_state(group, _port_model(params), LR)
        step = make_train_step(group)
        for _ in range(2):
            state, _ = step(state, torch.from_numpy(x), eps=torch.from_numpy(eps))
        ck.save_state(state, str(tmp_path / "a"), metadata={"step": 2})
        restored = jax_ck.restore_state(template, str(tmp_path / "a"))
        _assert_trees_equal(serialization.to_state_dict(jax.device_get(restored)), ck.train_state_to_tree(state))
        jax_ck.save_state(restored, str(tmp_path / "b"), metadata={"step": 2})
    else:
        jax_ck.save_state(serialization.from_state_dict(template, sd), str(tmp_path / "b"), metadata={"step": 5})
        state = create_train_state(group, MoEVAE(**DIMS).init_params(9), LR)
        ck.restore_state(state, str(tmp_path / "b"))
        _assert_trees_equal(ck.train_state_to_tree(state), sd)
        assert state.step == 5
        ck.save_state(state, str(tmp_path / "a"), metadata={"step": 5})
    for suffix in ("", ".json"):
        with open(str(tmp_path / "a") + suffix, "rb") as fa, open(str(tmp_path / "b") + suffix, "rb") as fb:
            assert fa.read() == fb.read()


# --- per-group PBT ---------------------------------------------------------------

PBT_CFG = dict(population=2, generations=3, steps_per_generation=3, batch_size=16, hidden_dim=16, latent_dim=4,
               exploit_fraction=0.5, lr_min=1e-30, lr_max=2e-30, seed=0)
PBT_DIMS = dict(num_experts=4, capacity_factor=2.0)


def _pbt_summary(res) -> dict:
    """What the decisions are: orders, exploits and lrs, through JSON as
    the ranks' are; and the members' final parameters."""
    hist = json.loads(json.dumps(res.history))
    return {"orders": [h["order"] for h in hist], "exploits": [h["exploits"] for h in hist],
            "lrs": [h["lrs"] for h in hist], "scores": [h["scores"] for h in hist], "final_lrs": res.final_lrs}


def _assert_decisions_equal(port: dict, ref: dict):
    assert port["orders"] == ref["orders"]
    assert port["exploits"] == ref["exploits"]
    assert port["lrs"] == ref["lrs"] and port["final_lrs"] == ref["final_lrs"]
    for sp, sr in zip(port["scores"], ref["scores"]):
        assert sp.keys() == sr.keys()
        for k in sp:
            assert sp[k] == pytest.approx(sr[k], rel=1e-5)


@pytest.fixture(scope="module")
def jax_pbt_run(data):
    train, test = data
    res = jax_pbt.run_pbt(jax_pbt.PBTConfig(**PBT_CFG), train, test,
                          groups=jax_setup_groups(2, devices=jax.devices()[:2]), verbose=False, return_states=True,
                          model_builder=lambda cfg: JaxMoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim,
                                                              **PBT_DIMS))
    return _pbt_summary(res), res.final_states


def test_per_group_pbt_takes_jaxs_decisions(data, jax_pbt_run, carried):
    ref, ref_states = jax_pbt_run
    assert sum(len(e) for e in ref["exploits"]) >= 1
    train, test = data
    res = run_pbt(PBTConfig(**PBT_CFG), train, test, groups=setup_groups(2, devices=["cpu"] * 2), verbose=False,
                  return_states=True,
                  model_builder=lambda cfg: MoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim, **PBT_DIMS))
    assert res.mode == "submesh" and res.dispatch_book["device_copies"] == sum(len(e) for e in ref["exploits"])
    _assert_decisions_equal(_pbt_summary(res), ref)
    for mine, theirs in zip(res.final_states, ref_states):
        _assert_params_close(mine["params"], jax.device_get(theirs.params), rtol=1e-5, atol=1e-6)
        assert mine["count"] == float(theirs.opt_state[0].count) == 9.0


def test_fused_pbt_with_a_model_family_is_not_ported(data):
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.16b"):
        run_pbt(PBTConfig(**PBT_CFG), *data, fused=True, device="cpu",
                model_builder=lambda cfg: MoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim))


# --- two processes: the capacity rule and cross-process PBT ----------------------

_RANK_MAIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.models import MoEVAE
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.steps import create_train_state, make_train_step

W = torch.load(sys.argv[1])
world, rank = cluster.initialize_runtime(device="cpu")
got = {"world": world, "rank": rank}
# One group of both ranks, each holding its half of the rows (DDP).
(pair,) = setup_groups(1, device="cpu")
model = MoEVAE(**W["dims"])
model.load_state_dict(W["weights"])
state = create_train_state(pair, model, W["lr"])
half = W["x"].shape[0] // 2
rows = slice(rank * half, (rank + 1) * half)
y, _ = state.model.moe(W["z"][rows])
got["moe_y"] = y.tolist()
state, m = make_train_step(pair)(state, W["x"][rows], eps=W["eps"][rows])
got["loss_sum"] = float(m["loss_sum"])
got["params"] = {k: v.tolist() for k, v in state.model.state_dict().items()}
# Per-group PBT, one member per process, from the JAX weights.
MoEVAE.init_params = lambda self, seed: (self.load_state_dict(W["pbt_weights"][seed]), self)[1]
res = run_pbt(PBTConfig(**W["pbt_cfg"]), synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1),
              groups=setup_groups(2, device="cpu"), verbose=False,
              model_builder=lambda cfg: MoEVAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim, **W["pbt_dims"]))
got["pbt"] = {"history": res.history, "final_lrs": res.final_lrs,
              "host_transfers": res.dispatch_book["host_transfers"]}
with open(sys.argv[2], "w") as f:
    json.dump(got, f)
cluster.shutdown_runtime()
"""


def test_two_ranks_route_as_jax_routes_the_group_batch(pair, data, jax_pbt_run, tmp_path):
    from test_torch_groups import _launch

    jmodel, params, _, x, eps = pair
    z = np.random.default_rng(4).normal(size=(ROWS, DIMS["latent_dim"])).astype(np.float32)
    pbt_weights = {s: moe_vae_params_from_flax(_jax_params(
        JaxMoEVAE(hidden_dim=16, latent_dim=4, **PBT_DIMS), s)) for s in range(2)}
    torch.save({"dims": DIMS, "weights": moe_vae_params_from_flax(params), "lr": LR, "x": torch.from_numpy(x),
                "eps": torch.from_numpy(eps), "z": torch.from_numpy(z), "pbt_cfg": PBT_CFG, "pbt_dims": PBT_DIMS,
                "pbt_weights": pbt_weights}, tmp_path / "w.pt")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _RANK_MAIN, str(tmp_path / "w.pt"), outs[r]], 2, timeout=180)
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    assert [g["world"] for g in got] == [2, 2] and [g["rank"] for g in got] == [0, 1]

    # The MoE layer: the halves, concatenated, are JAX's full-batch output,
    # where each half routed alone would differ (capacity 4 of 16 tokens,
    # not 2 of 8, and the second half queued behind the first).
    y_ref = np.asarray(JaxMoEMLP(num_experts=4, hidden_dim=16, out_dim=16, capacity_factor=1.0).apply(
        {"params": params["moe"]}, z)[0])
    y = np.concatenate([np.asarray(g["moe_y"], np.float32) for g in got])
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
    alone = MoEMLP(4, 4, 16, 16, 1.0)
    alone.load_state_dict({k.removeprefix("moe."): v for k, v in moe_vae_params_from_flax(params).items()
                           if k.startswith("moe.")})
    y_alone = torch.cat([alone(torch.from_numpy(z[:8]))[0], alone(torch.from_numpy(z[8:]))[0]]).detach().numpy()
    assert not np.allclose(y_alone, y_ref, rtol=1e-3, atol=1e-3)

    # One DDP step: the group's loss and the updated weights are JAX's step
    # on the whole batch.
    jloss, jparams = _jax_step(jmodel, params, x, eps, fused=True)
    for g in got:
        assert g["loss_sum"] == pytest.approx(jloss, rel=1e-5)
        _assert_params_close(g["params"], jparams)

    # Per-group PBT across the two processes: JAX's decisions, both ranks
    # alike, each exploit one broadcast.
    ref, _ = jax_pbt_run
    for g in got:
        res = g["pbt"]
        summary = {"orders": [h["order"] for h in res["history"]], "exploits": [h["exploits"] for h in res["history"]],
                   "lrs": [h["lrs"] for h in res["history"]], "scores": [h["scores"] for h in res["history"]],
                   "final_lrs": res["final_lrs"]}
        _assert_decisions_equal(summary, ref)
        assert res["host_transfers"] == sum(len(e) for e in ref["exploits"])


# --- the example -------------------------------------------------------------------


def test_example_cli_runs_on_cpu(tmp_path, capsys):
    from multidisttorch_tpu_torch.examples import moe_vae_hpo

    results = moe_vae_hpo.main(["--device", "cpu", "--ngroups", "2", "--epochs", "1", "--synthetic-size", "256",
                                "--batch-size", "32", "--out-dir", str(tmp_path)])
    assert [r.steps for r in results] == [8, 8] and all(r.status == "completed" for r in results)
    assert "trial 1 (4 experts): train loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.13"):
        moe_vae_hpo.main(["--device", "cpu", "--model-parallel", "2"])
