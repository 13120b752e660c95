"""Population-based training in the port against the JAX package's.

On the CPU at hidden 16, latent 4, batch 16, population 4 and 3-4 steps a
generation:

- the explore draw (``hpo/_threefry.py``, a numpy threefry) against
  ``jax.random`` through the JAX package's ``pbt_explore_key`` and
  ``pbt_perturb_factor``, seeds 0, 1, 7 and 12345, generations and lanes
  0-15, tables of 2 and 3 entries: exact;
- ``n_exploit_for``, ``_init_lrs`` and ``_rank``: exact;
- ``pbt_exchange`` on the same stacked parameters, moments, counts, eval
  sums and lrs (the JAX state carried across): every state leaf, the
  books and the new lrs exact, with the NaN, all-NaN, tie and
  ``n_exploit == 0`` cases of ``tests/test_pbt_fused.py``;
- a generation's eval sums at carried weights against JAX's
  ``make_stacked_eval_scan``: rel 1e-6;
- the port's fused and per-group modes on one config: histories, lrs and
  final states bit-identical;
- a whole run against the JAX package's ``run_pbt``, the JAX initial
  weights carried across: the best final eval loss within the JAX
  package's own spread over seeds 0-2, capped at 5 % (the noise streams
  differ, ROADMAP C.14);
- ``_set_lr`` and the graphs it drops, ``stream_chunks`` across rounds and
  ``host_batches``, the example CLI, and what is not ported.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.data.sampler import EvalDataIterator as JaxEvalIterator
from multidisttorch_tpu.hpo import pbt as jax_pbt
from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import steps as jax_steps
from multidisttorch_tpu_torch.data.sampler import EvalDataIterator, StackedTrialDataIterator
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.hpo import _threefry
from multidisttorch_tpu_torch.hpo import pbt
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params, vae_params_from_flax
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.steps import (
    GraphedMultiStep,
    StackedTrainState,
    TrialHypers,
    _build_stacked_body,
    create_stacked_train_state,
    create_train_state,
    fetch_pbt_books,
    make_multi_step,
    make_pbt_generation_step,
    make_stacked_eval_scan,
    pbt_exchange,
    pbt_train_eval,
)

HIDDEN, LATENT = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group():
    return setup_groups(1, devices=["cpu"])[0]


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)


def _cfg(**kw):
    base = dict(population=4, generations=3, steps_per_generation=3, batch_size=16, hidden_dim=HIDDEN,
                latent_dim=LATENT, exploit_fraction=0.5, lr_min=1e-4, lr_max=1e-1, seed=0)
    base.update(kw)
    return base


def _states_equal(a: dict, b: dict) -> bool:
    return (a["params"].keys() == b["params"].keys()
            and all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
            and all(torch.equal(x, y) for x, y in zip(a["exp_avg"] + a["exp_avg_sq"], b["exp_avg"] + b["exp_avg_sq"]))
            and a["count"] == b["count"])


# --- the explore draw ------------------------------------------------------


@pytest.mark.parametrize("table", [(0.8, 1.25), (0.5, 1.0, 2.0)])
@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_explore_draw_matches_jax_exactly(seed, table):
    jkey = jax_steps.pbt_explore_key(seed)
    assert tuple(int(v) for v in jax.random.key_data(jkey)) == _threefry.pbt_explore_key(seed)
    gens, lanes = jnp.arange(16, dtype=jnp.int32), jnp.arange(16, dtype=jnp.int32)
    want = np.asarray(jax.vmap(lambda g: jax.vmap(
        lambda lane: jax_steps.pbt_perturb_factor(jkey, g, lane, table))(lanes))(gens))
    pkey = _threefry.pbt_explore_key(seed)
    got = np.stack([_threefry.pbt_perturb_factors(pkey, g, 16, table) for g in range(16)])
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    # Eager JAX calls with Python ints draw the same.
    for g, lane in ((0, 0), (3, 5), (15, 15)):
        assert float(jax_steps.pbt_perturb_factor(jkey, g, lane, table)) == float(
            _threefry.pbt_perturb_factor(pkey, g, lane, table))


def test_threefry_pieces_match_jax_random():
    k = jax.random.key(42)
    assert tuple(int(v) for v in jax.random.key_data(k)) == _threefry.key(42)
    f = jax.random.fold_in(k, 0x9E3779B9)
    assert tuple(int(v) for v in jax.random.key_data(f)) == _threefry.fold_in(_threefry.key(42), 0x9E3779B9)
    want = [tuple(int(v) for v in jax.random.key_data(s)) for s in jax.random.split(f)]
    assert want == _threefry.split(_threefry.fold_in(_threefry.key(42), 0x9E3779B9))
    assert int(jax.random.bits(f, (), jnp.uint32)) == _threefry.random_bits32(
        _threefry.fold_in(_threefry.key(42), 0x9E3779B9))
    for n in (1, 2, 3, 5, 7):
        assert int(jax.random.randint(f, (), 0, n)) == _threefry.randint(
            _threefry.fold_in(_threefry.key(42), 0x9E3779B9), 0, n)


# --- host books --------------------------------------------------------------


@pytest.mark.parametrize("population,fraction", [(1, 0.25), (2, 0.9), (4, 0.5), (8, 0.25), (5, 0.25), (9, 0.5)])
def test_n_exploit_and_init_lrs_match_jax(population, fraction):
    kw = _cfg(population=population, exploit_fraction=fraction, seed=population)
    port, ref = PBTConfig(**kw), jax_pbt.PBTConfig(**kw)
    assert pbt.n_exploit_for(port) == jax_pbt.n_exploit_for(ref)
    got, want = pbt._init_lrs(port), jax_pbt._init_lrs(ref)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("sums", [
    [1.0, np.nan, 0.5, 2.0], [np.nan] * 4, [1.5, 1.5, 1.5, 1.5], [3.0, 1.0, 3.0, np.inf, 0.25, 1.0],
])
def test_rank_matches_jax(sums):
    sums = np.array(sums, np.float32)
    (po, ps), (jo, js) = pbt._rank(sums), jax_pbt._rank(sums)
    assert np.array_equal(po, jo) and np.array_equal(ps, js)


def test_pbt_config_mirrors_jax():
    from dataclasses import fields

    assert [(f.name, f.default) for f in fields(PBTConfig)] == [(f.name, f.default) for f in fields(jax_pbt.PBTConfig)]
    assert [f.name for f in fields(pbt.PBTResult)] == [f.name for f in fields(jax_pbt.PBTResult)]


# --- the exchange against the JAX package's ----------------------------------


def _carried_states(k: int, seed: int = 3):
    """A JAX stacked state with non-zero moments and distinct step counts,
    and the port's stacked state carrying the same values."""
    rng = np.random.default_rng(seed)
    jstate = jax_steps.build_stacked_train_state(JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT), list(range(k)))
    adam, rest = jstate.opt_state[0], jstate.opt_state[1:]
    noisy = lambda t: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(rng.uniform(0.0, 1.0, a.shape).astype(np.float32)), t)
    counts = jnp.arange(k, dtype=jnp.int32) + 5
    adam = adam._replace(count=counts, mu=noisy(adam.mu), nu=noisy(adam.nu))
    jstate = jax_steps.TrainState(params=jstate.params, opt_state=(adam, *rest), step=counts)
    model_sd = vae_params_from_flax(jax.device_get(jstate.params))
    mu_sd, nu_sd = vae_params_from_flax(jax.device_get(adam.mu)), vae_params_from_flax(jax.device_get(adam.nu))
    state = create_stacked_train_state(setup_groups(1, devices=["cpu"])[0],
                                       [init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0)] * k)
    names = [n for n, _ in state.model.named_parameters()]
    with torch.no_grad():
        state.model.load_state_dict(model_sd)
        for n, m, v in zip(names, state.exp_avg, state.exp_avg_sq):
            m.copy_(mu_sd[n])
            v.copy_(nu_sd[n])
        state.count.copy_(torch.tensor(np.asarray(counts), dtype=torch.float32))
    return jstate, state, names


def _port_leaves(state: StackedTrainState, names) -> dict:
    out = {f"params.{n}": p.detach().numpy() for n, p in state.model.named_parameters()}
    out.update({f"mu.{n}": t.numpy() for n, t in zip(names, state.exp_avg)})
    out.update({f"nu.{n}": t.numpy() for n, t in zip(names, state.exp_avg_sq)})
    out["count"] = state.count.numpy()
    return out


def _jax_leaves(jstate) -> dict:
    adam = jstate.opt_state[0]
    out = {f"params.{n}": v.numpy() for n, v in vae_params_from_flax(jax.device_get(jstate.params)).items()}
    out.update({f"mu.{n}": v.numpy() for n, v in vae_params_from_flax(jax.device_get(adam.mu)).items()})
    out.update({f"nu.{n}": v.numpy() for n, v in vae_params_from_flax(jax.device_get(adam.nu)).items()})
    out["count"] = np.asarray(adam.count).astype(np.float32)
    out["step"] = np.asarray(jstate.step).astype(np.float32)
    return out


@pytest.mark.parametrize("sums,n_exploit,gen", [
    ([1.0, np.nan, 0.5, 2.0], 2, 0),   # NaN ranks last, is exploited, never a source
    ([1.0, np.nan, 0.5, 2.0], 2, 3),
    ([np.nan] * 4, 2, 1),               # all diverged: no winner, identity
    ([1.5, 1.5, 1.5, 1.5], 2, 0),       # a tie: no exploit
    ([3.0, 1.0, 2.0, 0.5], 1, 2),
    ([4.0, 3.0, 2.0, 1.0], 2, 5),
    ([3.0, 1.0, 2.0, 0.5], 0, 0),       # n_exploit 0: identity
])
def test_exchange_matches_jax_exactly(sums, n_exploit, gen):
    k, seed, factors_table = 4, 11, (0.8, 1.25)
    jstate, state, names = _carried_states(k)
    lrs = pbt._init_lrs(PBTConfig(**_cfg(population=k, seed=seed)))
    jhypers = jax_steps.TrialHypers.stack(lrs, [1.0] * k)
    hypers = TrialHypers.stack([float(v) for v in lrs], [1.0] * k)
    eval_sums = np.array(sums, np.float32)
    jnew, jhyp, jstats = jax_steps.pbt_exchange(
        jstate, jhypers, jnp.asarray(eval_sums), gen, jax_steps.pbt_explore_key(seed), n_exploit=n_exploit,
        perturb_factors=factors_table, lr_min=1e-4, lr_max=1e-2)
    factors = torch.from_numpy(_threefry.pbt_perturb_factors(_threefry.pbt_explore_key(seed), gen, k, factors_table))
    books = pbt_exchange(state, hypers, torch.from_numpy(eval_sums), factors, n_exploit=n_exploit,
                         lr_min=1e-4, lr_max=1e-2)
    for name in ("order", "src", "exploited"):
        assert np.array_equal(books[name].numpy(), np.asarray(jstats[name])), name
    assert books["new_lr"].dtype == torch.float32
    assert np.array_equal(books["new_lr"].numpy(), np.asarray(jstats["new_lr"]))
    assert np.array_equal(hypers.lr.numpy(), np.asarray(jhyp.lr).astype(np.float64))
    got, want = _port_leaves(state, names), _jax_leaves(jnew)
    assert np.array_equal(got["count"], want["step"])
    for name, v in got.items():
        assert np.array_equal(v, want[name]), name
    if np.isnan(eval_sums).any() and not np.isnan(eval_sums).all():
        nan_lane = int(np.flatnonzero(np.isnan(eval_sums))[0])
        assert books["order"][-1] == nan_lane and bool(books["exploited"][nan_lane])
        assert nan_lane not in books["src"][books["exploited"]].tolist()


def test_exchange_rejects_overlapping_slices(group):
    state = create_stacked_train_state(group, [init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), s)
                                               for s in range(3)])
    with pytest.raises(ValueError, match="n_exploit 2"):
        pbt_exchange(state, TrialHypers.stack([1e-3] * 3, [1.0] * 3), torch.zeros(3), torch.ones(3),
                     n_exploit=2, lr_min=1e-4, lr_max=1e-2)


# --- one generation ------------------------------------------------------------


def _eval_set(group, test, batch_size=16):
    imgs, w, rows = pbt._stage_eval_host(test, group, batch_size)
    return imgs, w, rows, pbt._place_eval(group, imgs, w)


def test_generation_eval_sums_match_jax_eval_scan(group, data):
    # At fixed weights carried across, the generation's eval phase against
    # the JAX package's scanned stacked eval: rel 1e-6.
    _, test = data
    k = 4
    jstate, state, _ = _carried_states(k)
    imgs, w, rows, (eval_b, eval_w) = _eval_set(group, test)
    assert imgs.shape == (3, 16, 784) and rows == 40 and w[-1, 8:].sum() == 0
    betas = [1.0, 2.0, 0.5, 4.0]
    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    jeval = jax_steps.make_stacked_eval_scan(jtrial, JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT))
    want = np.asarray(jeval(jstate, jax_steps.TrialHypers.stack([1e-3] * k, betas), imgs, w)["loss_sum"])
    hypers = TrialHypers.stack([1e-3] * k, betas)
    got = make_stacked_eval_scan(group)(state, hypers, eval_b, eval_w)["loss_sum"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_generation_step_is_train_eval_then_exchange(group, data):
    # The eager generation step packs what its parts compute; one fetch
    # unpacks it.
    train, test = data
    k, s = 4, 3
    cfg = PBTConfig(**_cfg())
    _, _, _, (eval_b, eval_w) = _eval_set(group, test)
    chunk = next(StackedTrialDataIterator(train, group, 16, list(range(k))).stream_chunks(s))
    factors = torch.from_numpy(_threefry.pbt_perturb_factors(_threefry.pbt_explore_key(0), 0, k, (0.8, 1.25)))
    runs = []
    for split in (False, True):
        state = create_stacked_train_state(group, [pbt._init_model(cfg, j) for j in range(k)])
        hypers = TrialHypers.stack([float(v) for v in pbt._init_lrs(cfg)], [1.0] * k)
        gens = [torch.Generator().manual_seed(j + 1) for j in range(k)]
        if split:
            tr, ev = pbt_train_eval(_build_stacked_body(group, True, 1), make_stacked_eval_scan(group), state, hypers,
                                    chunk, eval_b, eval_w, gens)
            books = pbt_exchange(state, hypers, ev, factors, n_exploit=2, lr_min=1e-4, lr_max=1e-1)
            host = {"order": books["order"].numpy(), "exploited": books["exploited"].numpy(),
                    "src": books["src"].numpy(), "new_lr": books["new_lr"].numpy(),
                    "eval_loss_sum": ev.numpy(), "train_loss_sum": tr.numpy()}
        else:
            step = make_pbt_generation_step(group, n_exploit=2, lr_min=1e-4, lr_max=1e-1)
            assert not step.graphed and step.replays == 0
            host = fetch_pbt_books(step(state, hypers, chunk, eval_b, eval_w, factors, gens), k)
        runs.append((host, pbt._lane_state(state, 1), hypers.lr.clone()))
    (a, sa, la), (b, sb, lb) = runs
    assert a["train_loss_sum"].shape == (s, k) and a["eval_loss_sum"].shape == (k,)
    for name in a:
        assert np.array_equal(a[name], b[name]), name
    assert _states_equal(sa, sb) and torch.equal(la, lb)


# --- whole runs ------------------------------------------------------------------


def test_fused_and_per_group_are_bit_identical(data, tmp_path):
    train, test = data
    cfg = PBTConfig(**_cfg(generations=3, steps_per_generation=4, exploit_fraction=0.25))
    fused = run_pbt(cfg, train, test, fused=True, device="cpu", return_states=True, verbose=False,
                    out_dir=str(tmp_path / "fused"))
    per = run_pbt(cfg, train, test, device="cpu", return_states=True, verbose=False, out_dir=str(tmp_path / "per"))
    assert fused.mode == "fused" and per.mode == "submesh"
    assert fused.history == per.history
    assert fused.final_lrs == per.final_lrs
    assert fused.best_member == per.best_member and fused.best_eval_loss == per.best_eval_loss
    assert any(h["exploits"] for h in fused.history)
    for a, b in zip(fused.final_states, per.final_states):
        assert _states_equal(a, b)
    fb, pb = fused.dispatch_book, per.dispatch_book
    assert fb["program_calls"] == 3 and fb["host_fetches"] == 3 and fb["graph_replays"] == 0
    assert pb["program_calls"] == 2 * 4 * 3 and pb["device_copies"] == sum(len(h["exploits"]) for h in per.history)
    for sub, res in (("fused", fused), ("per", per)):
        with open(tmp_path / sub / "pbt.json") as f:
            report = json.load(f)
        assert set(report) == {"mode", "best_member", "best_eval_loss", "final_lrs", "history", "wall_s",
                               "dispatch_book"}
        assert report["final_lrs"] == res.final_lrs


def test_exploited_lane_takes_source_lr_times_the_drawn_factor(data):
    train, test = data
    cfg = PBTConfig(**_cfg(generations=2))
    res = run_pbt(cfg, train, test, fused=True, device="cpu", verbose=False)
    key = _threefry.pbt_explore_key(cfg.seed)
    for h in res.history:
        for e in h["exploits"]:
            factor = _threefry.pbt_perturb_factor(key, h["generation"], e["to"], cfg.perturb_factors)
            want = np.clip(np.float32(h["lrs"][e["from"]]) * factor, np.float32(cfg.lr_min), np.float32(cfg.lr_max))
            assert e["new_lr"] == float(np.float32(want))
            assert h["loss_sums"][e["to"]] > h["loss_sums"][e["from"]]


def test_one_member_population_never_exchanges(data):
    train, test = data
    res = run_pbt(PBTConfig(**_cfg(population=1, generations=2)), train, test, fused=True, device="cpu",
                  verbose=False)
    assert all(not h["exploits"] for h in res.history) and len(res.final_lrs) == 1


def _jax_lane_params(seed: int):
    state = jax_steps.build_lane_state(JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT), seed)
    return vae_params_from_flax(jax.device_get(state.params))


def test_whole_run_within_jax_seed_spread(data, monkeypatch):
    # The JAX initial weights carried across; the noise streams differ
    # (ROADMAP C.14), so the best final eval loss is held to the JAX
    # package's own spread over seeds 0-2, capped at 5 %.
    train, test = data
    kw = _cfg(generations=3, steps_per_generation=4, exploit_fraction=0.25, lr_max=1e-2)
    trial = jax_setup_groups(1, devices=jax.devices()[:1])
    finals = []
    for seed in range(3):
        finals.append(jax_pbt.run_pbt(jax_pbt.PBTConfig(**dict(kw, seed=seed)), train, test, groups=trial,
                                      fused=True, verbose=False))
    best = np.array([r.best_eval_loss for r in finals])
    tol = min(0.05, float((best.max() - best.min()) / best.mean()))
    assert tol > 0

    def carried(model, seed):
        model.load_state_dict(_jax_lane_params(seed))
        return model

    monkeypatch.setattr(pbt, "init_vae_params", carried)
    port = run_pbt(PBTConfig(**kw), train, test, fused=True, device="cpu", verbose=False)
    ref = finals[0]
    assert abs(port.best_eval_loss - ref.best_eval_loss) / ref.best_eval_loss <= tol
    assert port.history[0]["lrs"] == ref.history[0]["lrs"]  # the same f32 initial lrs
    assert port.history[-1]["scores"][port.history[-1]["order"][0]] < max(port.history[0]["scores"].values())


# --- graphs and data ---------------------------------------------------------------


def test_set_lr_drops_the_state_graphs(group):
    # The ground rule on graph state: an lr baked into a captured Adam
    # update must not outlive a change. _set_lr sets the optimizer's lr
    # and drops that optimizer's graphs (and only those); the next chunk
    # is captured anew. The graph table is filled by hand here (no card).
    state = create_train_state(group, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0), 1e-3)
    other = create_train_state(group, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 1), 1e-3)
    multi = object.__new__(GraphedMultiStep)
    multi._graphs = {(id(state.optimizer), 10): "a", (id(state.optimizer), 8): "b", (id(other.optimizer), 10): "c"}
    multi._warm = {id(state.optimizer), id(other.optimizer)}
    assert pbt._set_lr(state, 4e-3, multi) is state
    assert all(g["lr"] == 4e-3 for g in state.optimizer.param_groups)
    assert multi._graphs == {(id(other.optimizer), 10): "c"}
    assert id(state.optimizer) in multi._warm  # captured again, not warmed again
    # The eager loop holds nothing: its lr is read at each step.
    eager = make_multi_step(group)
    assert not eager.graphed and pbt._set_lr(state, 2e-3, eager) is state
    assert state.optimizer.param_groups[0]["lr"] == 2e-3


def test_stream_chunks_cross_rounds(group, data):
    train, _ = data  # 16 batches of 16 a round
    seeds = [3, 9]
    # The default feed and the synchronous numpy one.
    for feed in ({}, {"use_native": False, "prefetch": False}):
        it = StackedTrialDataIterator(train, group, 16, seeds, **feed)
        chunks = it.stream_chunks(5)
        got = torch.cat([next(chunks) for _ in range(7)])  # 35 steps: two rounds and 3 steps
        assert got.shape == (35, 2, 16, 784)
        for k, seed in enumerate(seeds):
            one = StackedTrialDataIterator(train, group, 16, [seed])
            want = torch.stack([b for _ in range(3) for b in one.round_batches()])[:35]
            assert torch.equal(got[:, k], want[:, 0])
        # Two rounds finished, the third under way; the pipeline may have
        # gathered up to depth + 1 = 3 chunks (15 steps) more, into round 4.
        assert it._lanes[0]["epoch"] in ((3,) if feed else (3, 4))
        chunks.close()


def test_stream_chunks_rejects_empty_chunks(group, data):
    with pytest.raises(ValueError, match="chunk size"):
        StackedTrialDataIterator(data[0], group, 16, [0]).stream_chunks(0)


def test_eval_host_batches_match_jax(group, data):
    _, test = data
    port = list(EvalDataIterator(test, group, 16).host_batches())
    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    ref = list(JaxEvalIterator(test, jtrial, 16).host_batches())
    assert len(port) == len(ref) == 3
    for (pi, pw), (ji, _labels, jw) in zip(port, ref):
        assert np.array_equal(pi, ji) and np.array_equal(pw, jw)
    on_device = list(EvalDataIterator(test, group, 16).batches())
    assert all(torch.equal(b, torch.from_numpy(i)) and torch.equal(w, torch.from_numpy(pw))
               for (b, w), (i, pw) in zip(on_device, port))


# --- entry points --------------------------------------------------------------------


def test_unported_arguments_raise(data):
    # A model family runs per group (tests/test_torch_moe.py); the fused
    # lanes are StackedVAE's only.
    with pytest.raises(NotImplementedError, match=r"A\.16b"):
        run_pbt(PBTConfig(**_cfg()), *data, model_builder=lambda cfg: None, fused=True, device="cpu")


def test_fused_needs_one_group(data):
    with pytest.raises(ValueError, match="one group"):
        run_pbt(PBTConfig(**_cfg()), *data, fused=True, groups=setup_groups(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="population 4 but 2"):
        run_pbt(PBTConfig(**_cfg()), *data, groups=setup_groups(2, devices=["cpu"] * 2))


def test_example_cli_runs_on_cpu(tmp_path, capsys):
    from multidisttorch_tpu_torch.examples import pbt_vae

    for fused in (False, True):
        out = tmp_path / ("fused" if fused else "per")
        argv = ["--device", "cpu", "--population", "2", "--generations", "2", "--steps-per-generation", "3",
                "--batch-size", "16", "--synthetic-size", "256",
                "--out-dir", str(out)] + (["--fused"] if fused else [])
        res = pbt_vae.main(argv)
        assert res.mode == ("fused" if fused else "submesh") and len(res.history) == 2
        assert os.path.exists(out / "pbt.json")
    assert "best member" in capsys.readouterr().out
