"""Fused PBT over a model family: the conv β-VAE and the MoE VAE as the lanes
of one stacked state (``models/vae.py::LaneStacked``,
``models/conv_vae.py::StackedConvVAE``, ``models/moe_vae.py::StackedMoEVAE``
over ``ops/moe.py::StackedMoEMLP`` and the lane layers of
``models/layers.py``), through ``run_pbt(fused=True, model_builder=...)``.

On the CPU at small widths (conv: base channels 4, latent 4, 32x32x3 rows;
MoE: 784-16-4, 4 experts, capacity factor 2.0), each tolerance stated where
it is checked:

- **(a) the lane forms against the models run alone**, K 3, each lane on its
  own parameters, rows and injected noise. The MLP VAE's lanes compute the
  unstacked ops and are bit-identical; so are the MoE VAE's encoder outputs.
  Elsewhere the products differ (grouped against single convolutions, which
  take other CPU algorithms at 3-4 channels; the experts' batched einsums):
  forward outputs and the per-lane ELBO within rel 1e-6 (the norm of the
  difference over the norm of the value, per lane) in f32; gradients within
  rel 1e-6 in f32 for the MoE VAE, and for the conv VAE with the layers
  computing in f64 (its f32 gradients of the first layers gather the
  convolutions' rounding to ~1.2e-6). A MoE lane whose expert overflows its
  capacity sits beside one whose experts do not.
- **(b) against the JAX package's fused run**, the JAX lanes' weights
  carried across (``stack_params_from_flax``), lrs at 1e-30 so that the
  weights cannot move in f32 and the noise (ROADMAP C.14) does not enter the
  posterior-mean scores: orders, exploits and lrs equal, scores rel 1e-5.
- **(c) the port's fused run against its per-group run** at a real lr, the
  same seeds, data and noise: decisions equal, eval sums rel 1e-5.
- **(d) the exchange**: an exploit gives a family lane its source's
  parameters, both moments and count, bit for bit; ``_read_lane`` and
  ``_write_lane`` round-trip a family lane exactly.
- **(f) two gloo ranks, the MoE family fused**: each lane routes over the
  group's batch (queue offsets from one ``all_gather`` of the ``(K, E)``
  counts, the group's capacity), matching one rank holding the whole batch:
  the MoE layer's outputs rtol 1e-5, the run's decisions equal and scores rel
  1e-5 (lr 1e-30, as in (b): each rank draws its own noise).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from multidisttorch_tpu.hpo import pbt as jax_pbt
from multidisttorch_tpu.models.conv_vae import ConvVAE as JaxConvVAE
from multidisttorch_tpu.models.moe_vae import MoEVAE as JaxMoEVAE
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import steps as jax_steps
from multidisttorch_tpu_torch.data.datasets import synthetic_cifar10, synthetic_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.models import ConvVAE, MoEVAE, VAE
from multidisttorch_tpu_torch.models.conv_vae import StackedConvVAE
from multidisttorch_tpu_torch.models.moe_vae import StackedMoEVAE
from multidisttorch_tpu_torch.models.vae import lane_params, stack_params, stack_params_from_flax
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum, fused_elbo_loss_sum_lanes
from multidisttorch_tpu_torch.ops.moe import MoEMLP, StackedMoEMLP
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.steps import (
    TrainState,
    TrialHypers,
    _read_lane,
    _write_lane,
    create_stacked_train_state,
    pbt_exchange,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONV = dict(latent_dim=4, base_channels=4)  # 32x32x3 rows of synthetic_cifar10
MOE = dict(hidden_dim=16, latent_dim=4, num_experts=4, capacity_factor=2.0)
FAMILIES = {
    "conv": (ConvVAE, JaxConvVAE, CONV, synthetic_cifar10),
    "moe": (MoEVAE, JaxMoEVAE, MOE, synthetic_mnist),
}
REL = 1e-6


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``‖a - b‖ / ‖b‖`` (0 for two zero tensors)."""
    a, b = a.detach().double(), b.detach().double()
    n = float(b.norm())
    return float((a - b).norm()) / n if n else float((a - b).norm())


def _builder(name: str):
    cls, _, dims, _ = FAMILIES[name]
    return lambda cfg: cls(**dims)


def _data(name: str):
    make = FAMILIES[name][3]
    return make(192, seed=0), make(40, seed=1)


def _cfg(**kw):
    base = dict(population=4, generations=3, steps_per_generation=3, batch_size=16, exploit_fraction=0.5,
                lr_min=1e-4, lr_max=1e-1, seed=0)
    base.update(kw)
    return base


# --- (a) the lane forms against the models run alone -----------------------------


def _lanes_and_alone(name: str, dtype=torch.float32, k: int = 3, rows: int = 16):
    """K models of the family from seeds 0..K-1, their stacked form on the
    same weights, K lanes of rows and noise, and each lane's ELBO (beta per
    lane) backward through both."""
    models = {"conv": lambda: ConvVAE(**CONV, dtype=dtype), "moe": lambda: MoEVAE(**MOE, dtype=dtype),
              "vae": lambda: VAE(hidden_dim=16, latent_dim=4, dtype=dtype)}[name]
    alone = [models().init_params(s) for s in range(k)]
    stacked = alone[0].stacked(k)
    stacked.load_state_dict(stack_params(alone))
    gen = torch.Generator().manual_seed(7)
    x = torch.rand(k, rows, alone[0].input_dim, generator=gen)
    eps = torch.randn(k, rows, alone[0].latent_dim, generator=gen)
    beta = torch.tensor([1.0, 0.5, 2.0][:k])
    outs = stacked(x, eps=eps)
    loss = fused_elbo_loss_sum_lanes(*(t.float() for t in (outs[0], x, outs[1], outs[2])), beta)
    loss.sum().backward()
    lanes = []
    for j, m in enumerate(alone):
        o = m(x[j], eps=eps[j])
        ls = fused_elbo_loss_sum(o[0].float(), x[j], o[1].float(), o[2].float(), float(beta[j]))
        ls.backward()
        lanes.append((o, ls, m))
    return stacked, outs, loss, lanes


@pytest.mark.parametrize("name", ["vae", "conv", "moe"])
def test_lane_forms_match_the_models_run_alone(name):
    stacked, (logits, mu, logvar), loss, lanes = _lanes_and_alone(name)
    assert logits.is_contiguous() and logits.shape == (3, 16, stacked.input_dim)
    for j, ((lo, m, lv), ls, model) in enumerate(lanes):
        if name == "vae":
            assert torch.equal(logits[j], lo) and torch.equal(mu[j], m) and torch.equal(logvar[j], lv)
            assert torch.equal(loss[j], ls)
        else:
            for got, want in ((logits[j], lo), (mu[j], m), (logvar[j], lv), (loss[j], ls)):
                assert _rel(got, want) <= REL, (name, j)
        if name == "moe":  # the encoder is the MLP VAE's: the same ops
            assert torch.equal(mu[j], m) and torch.equal(logvar[j], lv)
        grads = {n: p.grad[j] for n, p in stacked.named_parameters()}
        for n, p in model.named_parameters():
            if name == "vae":
                assert torch.equal(grads[n], p.grad), n
            elif name == "moe":
                assert _rel(grads[n], p.grad) <= REL, (n, _rel(grads[n], p.grad))
    if name == "conv":
        # The gradients with the layers computing in f64 (parameters f32).
        stacked, _, _, lanes = _lanes_and_alone(name, dtype=torch.float64)
        for j, (_, _, model) in enumerate(lanes):
            grads = {n: p.grad[j] for n, p in stacked.named_parameters()}
            for n, p in model.named_parameters():
                assert _rel(grads[n], p.grad) <= REL, (n, _rel(grads[n], p.grad))


def test_moe_lanes_route_their_own_rows():
    # Lane 0's router sends every row to expert 0, past its capacity (8 of 16
    # rows at capacity factor 2.0 over 4 experts); lane 1's rows stay within
    # every expert's capacity. Each lane drops exactly what its model alone
    # drops.
    k, rows, d = 2, 16, 4
    alone = [MoEMLP(d, 4, 8, 6, 2.0) for _ in range(k)]
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in alone:
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        alone[0].gate.bias.copy_(torch.tensor([50.0, 0.0, 0.0, 0.0]))
    stacked = StackedMoEMLP(k, d, 4, 8, 6, 2.0)
    stacked.load_state_dict(stack_params(alone))
    x = torch.randn(k, rows, d, generator=gen)
    y, aux = stacked(x)
    cap = alone[0].capacity(rows)
    assert cap == stacked.capacity(rows) == 8
    for j, m in enumerate(alone):
        want, want_aux = m(x[j])
        assert _rel(y[j], want) <= REL and _rel(aux[j], want_aux) <= REL
        counts = np.bincount(torch.argmax(m.gate(x[j]), -1).numpy(), minlength=4)
        dropped = int((want.abs().sum(1) == 0).sum())
        if j == 0:
            assert counts[0] == rows and dropped == rows - cap
        else:
            assert counts.max() <= cap and dropped == 0
        assert int((y[j].abs().sum(1) == 0).sum()) == dropped


# --- (b) against the JAX package's fused run -------------------------------------

FROZEN = dict(lr_min=1e-30, lr_max=2e-30)


def _summary(res) -> dict:
    hist = json.loads(json.dumps(res.history))
    return {"orders": [h["order"] for h in hist], "exploits": [h["exploits"] for h in hist],
            "lrs": [h["lrs"] for h in hist], "scores": [h["scores"] for h in hist], "final_lrs": res.final_lrs}


def _assert_decisions_equal(port: dict, ref: dict, rel: float = 1e-5):
    assert port["orders"] == ref["orders"]
    assert port["exploits"] == ref["exploits"]
    assert port["lrs"] == ref["lrs"] and port["final_lrs"] == ref["final_lrs"]
    for sp, sr in zip(port["scores"], ref["scores"]):
        assert sp.keys() == sr.keys()
        for key in sp:
            assert sp[key] == pytest.approx(sr[key], rel=rel)


@pytest.mark.parametrize("name", ["conv", "moe"])
def test_fused_family_takes_jaxs_decisions(name, monkeypatch):
    cls, jcls, dims, _ = FAMILIES[name]
    cfg = _cfg(**FROZEN)
    seeds = [cfg["seed"] + k for k in range(cfg["population"])]
    jmodel = jcls(**dims)
    jax_state = jax_steps.build_stacked_train_state(jmodel, seeds)
    trees = [jax.tree.map(lambda a, k=k: np.asarray(a[k]), jax.device_get(jax_state.params)) for k in range(len(seeds))]
    carried = stack_params_from_flax(cls(**dims), trees)
    monkeypatch.setattr(cls, "init_params", lambda self, seed: (
        self.load_state_dict({key: v[seed - cfg["seed"]] for key, v in carried.items()}), self)[1])

    train, test = _data(name)
    ref = jax_pbt.run_pbt(jax_pbt.PBTConfig(**cfg), train, test, fused=True, verbose=False, return_states=True,
                          groups=jax_setup_groups(1, devices=jax.devices()[:1]), model_builder=lambda c: jcls(**dims))
    port = run_pbt(PBTConfig(**cfg), train, test, fused=True, device="cpu", verbose=False, return_states=True,
                   model_builder=_builder(name))
    assert port.mode == ref.mode == "fused"
    assert sum(len(h["exploits"]) for h in ref.history) >= 1
    _assert_decisions_equal(_summary(port), _summary(ref))
    # Each lane's final weights are the JAX lane's: the carried bits, moved
    # by the exploits' copies alone.
    for mine, theirs in zip(port.final_states, ref.final_states):
        want = cls(**dims).params_from_flax(jax.device_get(theirs.params))
        for key, v in want.items():
            np.testing.assert_allclose(mine["params"][key].numpy(), v.numpy(), rtol=1e-6, atol=1e-20)
        assert mine["count"] == cfg["generations"] * cfg["steps_per_generation"]


# --- (c) the port's fused run against its per-group run ---------------------------


@pytest.mark.parametrize("name", ["conv", "moe"])
def test_fused_family_matches_its_per_group_run(name):
    cfg = PBTConfig(**_cfg(lr_min=1e-3, lr_max=1e-2))
    train, test = _data(name)
    fused = run_pbt(cfg, train, test, fused=True, device="cpu", verbose=False, return_states=True,
                    model_builder=_builder(name))
    per = run_pbt(cfg, train, test, groups=setup_groups(cfg.population, devices=["cpu"] * cfg.population),
                  verbose=False, return_states=True, model_builder=_builder(name))
    assert fused.mode == "fused" and per.mode == "submesh"
    assert sum(len(h["exploits"]) for h in fused.history) >= 1
    _assert_decisions_equal(_summary(fused), _summary(per))
    for hf, hp in zip(fused.history, per.history):
        np.testing.assert_allclose(hf["loss_sums"], hp["loss_sums"], rtol=1e-5, atol=0)
    for a, b in zip(fused.final_states, per.final_states):
        assert a["count"] == b["count"]
        for key in b["params"]:
            assert _rel(a["params"][key], b["params"][key]) <= 1e-5, key


# --- (d) the exchange ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["conv", "moe"])
def test_exchange_and_lane_surgery_copy_family_lanes_bit_for_bit(name):
    cls, _, dims, _ = FAMILIES[name]
    group = setup_groups(1, devices=["cpu"])[0]
    k = 4
    state = create_stacked_train_state(group, [cls(**dims).init_params(s) for s in range(k)])
    assert isinstance(state.model, {"conv": StackedConvVAE, "moe": StackedMoEVAE}[name])
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in state.exp_avg + state.exp_avg_sq:
            t.copy_(torch.rand(t.shape, generator=gen))
        state.count.copy_(torch.arange(k, dtype=torch.float32) + 3)
    tensors = lambda: [*state.model.parameters(), *state.exp_avg, *state.exp_avg_sq, state.count]  # noqa: E731
    before = [t.detach().clone() for t in tensors()]
    hypers = TrialHypers.stack([1e-3, 2e-3, 3e-3, 4e-3], [1.0] * k)
    books = pbt_exchange(state, hypers, torch.tensor([4.0, 1.0, 3.0, 2.0]), torch.tensor([0.8, 1.25, 0.8, 1.25]),
                         n_exploit=2, lr_min=1e-4, lr_max=1e-1)
    src, exploited = books["src"].tolist(), books["exploited"].tolist()
    assert src == [3, 1, 1, 3] and exploited == [True, False, True, False]
    for t0, t1 in zip(before, tensors()):
        for lane in range(k):
            assert torch.equal(t1[lane], t0[src[lane]])

    # Read lane 1 out as a trial of the family, write it into lane 2.
    trial = _read_lane(state, 1)
    assert isinstance(trial, TrainState) and type(trial.model) is cls and trial.step == 4
    for key, v in lane_params(state.model, 1).items():
        assert torch.equal(trial.model.state_dict()[key], v)
    _write_lane(state, trial, 2)
    for t in tensors():
        assert torch.equal(t[2], t[1])
    again = _read_lane(state, 2)
    for p, q in zip(again.model.parameters(), trial.model.parameters()):
        assert torch.equal(p, q)
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again.optimizer.state[p][m], trial.optimizer.state[q][m])


# --- (f) two gloo ranks, the MoE family fused -----------------------------------------

PAIR_CFG = _cfg(population=2, generations=3, exploit_fraction=0.5, **FROZEN)

_RANK_MAIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.models import MoEVAE
from multidisttorch_tpu_torch.ops.moe import StackedMoEMLP
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups

W = torch.load(sys.argv[1])
world, rank = cluster.initialize_runtime(device="cpu")
(pair,) = setup_groups(1, device="cpu")
moe = StackedMoEMLP(*W["moe_args"])
moe.load_state_dict(W["moe_weights"])
moe.bind_group(pair.pg, pair.size, pair.local_rank)
half = W["z"].shape[1] // 2
y, _ = moe(W["z"][:, rank * half:(rank + 1) * half])
res = run_pbt(PBTConfig(**W["cfg"]), synthetic_mnist(192, seed=0), synthetic_mnist(40, seed=1), fused=True,
              device="cpu", verbose=False, model_builder=lambda cfg: MoEVAE(**W["dims"]))
with open(sys.argv[2], "w") as f:
    json.dump({"rank": rank, "y": y.tolist(), "history": res.history, "final_lrs": res.final_lrs}, f)
cluster.shutdown_runtime()
"""


def test_two_ranks_route_each_lane_over_the_group_batch(tmp_path):
    from test_torch_groups import _launch

    k, rows, d = 2, 16, 4
    alone = [MoEMLP(d, 4, 8, 6, 1.0) for _ in range(k)]
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in alone:
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    stacked = StackedMoEMLP(k, d, 4, 8, 6, 1.0)
    stacked.load_state_dict(stack_params(alone))
    z = torch.randn(k, rows, d, generator=gen)
    torch.save({"moe_args": (k, d, 4, 8, 6, 1.0), "moe_weights": stacked.state_dict(), "z": z, "cfg": PAIR_CFG,
                "dims": MOE}, tmp_path / "w.pt")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _RANK_MAIN, str(tmp_path / "w.pt"), outs[r]], 2, timeout=180)
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))

    # The MoE layer: each lane's halves, concatenated, are the lane's
    # whole-batch routing, where the halves routed alone differ.
    y = torch.cat([torch.tensor(g["y"]) for g in got], dim=1)
    want, _ = stacked(z)
    np.testing.assert_allclose(y.numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-6)
    halves = torch.cat([stacked(z[:, :8])[0], stacked(z[:, 8:])[0]], dim=1).detach()
    assert not np.allclose(halves.numpy(), want.detach().numpy(), rtol=1e-3, atol=1e-3)

    # The fused run over the pair: one process's decisions and scores.
    one = run_pbt(PBTConfig(**PAIR_CFG), synthetic_mnist(192, seed=0), synthetic_mnist(40, seed=1), fused=True,
                  device="cpu", verbose=False, model_builder=lambda cfg: MoEVAE(**MOE))
    for g in got:
        summary = {"orders": [h["order"] for h in g["history"]], "exploits": [h["exploits"] for h in g["history"]],
                   "lrs": [h["lrs"] for h in g["history"]], "scores": [h["scores"] for h in g["history"]],
                   "final_lrs": g["final_lrs"]}
        _assert_decisions_equal(summary, _summary(one))
