"""Trial stacking in the port against the JAX package's.

Mirrors of ``tests/test_stacking.py`` on the port, on the CPU at hidden 16,
latent 4, 128 rows and batch 16 (8 steps an epoch): the stacked steps, the
stacked data gatherer, mask-and-refill lane surgery and the driver's
buckets. On the CPU the port's stacked trial trains to its unstacked twin's
bits (the same batched products per lane, the same noise from a generator
seeded alike, torch's single-tensor Adam arithmetic per lane), so those
mirrors hold at exact equality, as the JAX tests do.

Against the JAX package, with its weights carried across and the noise
injected (ROADMAP C.2):

- the stacked step against a vmapped JAX step built from ``VAE.apply``,
  ``elbo_loss_sum`` and ``optax.chain(scale_by_adam, scale(-lr))``, three
  steps with one lane masked after the first: losses rel 1e-5, parameters
  rtol 1e-4 / atol 1e-5 (f32 gradients summed in another order; Adam's
  normalised step turns a near-zero gradient's rounding into up to about
  1e-3 of lr, here up to 3e-3, per step);
- ``StackedTrialDataIterator`` index for index (exact);
- the lane-batched plain ELBO against ``pallas_elbo`` per lane in interpret
  mode: value rel 1e-5, f32 gradients rtol 1e-5 / atol 1e-6, bf16 within
  one bf16 ulp (ROADMAP C.3).

Also: the lane kernels' wrappers against a stand-in library (launch
counts, capture scopes, one workspace per lane count), a stacked lane's
checkpoint extended unstacked, a lane that diverges alone, and a two-rank
gloo bucket against the same configs run unstacked under DDP (rel 1e-5:
the group averages the stacked gradients in another order than DDP), and
a bucket split between two processes' groups.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_mnist
from multidisttorch_tpu.data.sampler import StackedTrialDataIterator as JaxStackedIterator
from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.models.vae import init_vae_params as jax_init_vae_params
from multidisttorch_tpu.ops.losses import elbo_loss_sum as jax_elbo_loss_sum
from multidisttorch_tpu.ops.pallas_elbo import fused_elbo_loss_sum as jax_fused
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu_torch.data.sampler import StackedTrialDataIterator, TrialDataIterator
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, config_is_stackable, run_hpo, stack_bucket_key
from multidisttorch_tpu_torch.models.vae import (
    VAE,
    StackedVAE,
    init_vae_params,
    lane_params,
    stack_vae_params,
    vae_params_from_flax,
    write_lane_params,
)
from multidisttorch_tpu_torch.ops import elbo as port_elbo
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum_lanes
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.steps import (
    TrialHypers,
    create_stacked_train_state,
    create_train_state,
    make_eval_step,
    make_lane_ops,
    make_stacked_eval_scan,
    make_stacked_eval_step,
    make_stacked_multi_step,
    make_stacked_train_step,
    make_train_step,
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


def _vae(seed):
    return init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), seed)


def _inputs(seed, *lead, rows=16):
    rng = np.random.default_rng(seed)
    batches = torch.tensor(rng.uniform(0, 1, (*lead, rows, 784)).astype(np.float32))
    eps = torch.tensor(rng.normal(0, 1, (*lead, rows, LATENT)).astype(np.float32))
    return batches, eps


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _lane(state, k):
    return {n: v.detach()[k].clone() for n, v in state.params.items()}


# --- the stacked model ---------------------------------------------------


def test_stacked_vae_lanes_are_the_unstacked_vaes():
    # Lane k of a StackedVAE computes what a VAE with lane k's weights
    # computes (exactly, on the CPU): given noise, noise from lane k's
    # generator, and one shared batch for every lane's encoder.
    vaes = [_vae(s) for s in (0, 1, 2)]
    stacked = StackedVAE(3, hidden_dim=HIDDEN, latent_dim=LATENT)
    stacked.load_state_dict(stack_vae_params(vaes))
    x, eps = _inputs(7, 3, rows=8)
    recon, mu, logvar = stacked(x, eps=eps)
    drawn = stacked(x, generators=[torch.Generator().manual_seed(10 + k) for k in range(3)])[0]
    shared_mu, _ = stacked.encode(x[0])
    for k, vae in enumerate(vaes):
        r, m, lv = vae(x[k], eps=eps[k])
        assert torch.equal(recon[k], r) and torch.equal(mu[k], m) and torch.equal(logvar[k], lv)
        assert torch.equal(drawn[k], vae(x[k], generator=torch.Generator().manual_seed(10 + k))[0])
        assert torch.equal(shared_mu[k], vae.encode(x[0])[0])
    assert _same(lane_params(stacked, 1), vaes[1].state_dict())
    write_lane_params(stacked, 1, vaes[2].state_dict())
    assert _same(lane_params(stacked, 1), vaes[2].state_dict())


# --- the stacked steps ---------------------------------------------------


def test_stacked_step_bitwise_parity_with_unstacked(group):
    # K trials advanced by the stacked step end bit-identical to the same
    # configs run through make_train_step one at a time: the same weights,
    # batches and noise; different lr, beta and seed per lane on purpose.
    K, steps = 3, 3
    seeds, lrs, betas = [0, 5, 9], [1e-3, 3e-3, 2e-3], [1.0, 4.0, 1.0]
    batches, eps = _inputs(0, steps, K)
    state = create_stacked_train_state(group, [_vae(s) for s in seeds])
    hypers = TrialHypers.stack(lrs, betas)
    sstep = make_stacked_train_step(group)
    for i in range(steps):
        state, metrics = sstep(state, hypers, batches[i], eps=eps[i])
    assert metrics["loss_sum"].shape == (K,)
    read, _ = make_lane_ops(group)
    for k in range(K):
        su = create_train_state(group, _vae(seeds[k]), lrs[k])
        ustep = make_train_step(group, beta=betas[k])
        for i in range(steps):
            su, m = ustep(su, batches[i, k], eps=eps[i, k])
        assert torch.equal(m["loss_sum"], metrics["loss_sum"][k])
        lane = read(state, k)
        assert _same(lane.model.state_dict(), su.model.state_dict()), f"lane {k} diverged"
        assert lane.step == su.step == steps
        for p, q in zip(lane.model.parameters(), su.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(lane.optimizer.state[p][key], su.optimizer.state[q][key]), f"lane {k} {key}"


def test_stacked_multi_step_matches_per_step(group):
    K, S = 2, 4
    batches, eps = _inputs(1, S, K)
    hypers = TrialHypers.stack([1e-3] * K, [1.0] * K)
    s_multi = create_stacked_train_state(group, [_vae(1), _vae(2)])
    s_multi, m = make_stacked_multi_step(group)(s_multi, hypers, batches, eps=eps)
    assert m["loss_sum"].shape == (S, K)
    s_step = create_stacked_train_state(group, [_vae(1), _vae(2)])
    sstep = make_stacked_train_step(group)
    for i in range(S):
        s_step, mi = sstep(s_step, hypers, batches[i], eps=eps[i])
        assert torch.equal(mi["loss_sum"], m["loss_sum"][i])
    assert _same(s_multi.params, s_step.params)


@pytest.mark.parametrize("kw", [{"grad_accum": 2}, {"use_fused_loss": False}], ids=["grad_accum", "plain-loss"])
def test_stacked_step_options_match_unstacked(group, kw):
    # grad_accum's microbatch loop and the plain loss, per lane, against
    # the unstacked step with the same options; with generators, each
    # lane's noise is its twin's.
    K = 2
    batches, _ = _inputs(2, K)
    gens = [torch.Generator().manual_seed(40 + k) for k in range(K)]
    state = create_stacked_train_state(group, [_vae(3), _vae(4)])
    state, m = make_stacked_train_step(group, **kw)(state, TrialHypers.stack([2e-3] * K, [1.0, 3.0]), batches,
                                                    generators=gens)
    for k, (seed, beta) in enumerate(((3, 1.0), (4, 3.0))):
        su = create_train_state(group, _vae(seed), 2e-3)
        su, mu = make_train_step(group, beta=beta, **kw)(su, batches[k], generator=torch.Generator().manual_seed(40 + k))
        assert torch.equal(mu["loss_sum"], m["loss_sum"][k])
        assert _same(_lane(state, k), su.model.state_dict())


def test_active_mask_freezes_lane(group):
    # active=0 freezes a lane exactly (parameters, moments, step count)
    # while live lanes go on, through the same step object.
    K = 2
    batch, eps = _inputs(2, K)
    sstep = make_stacked_train_step(group)
    state = create_stacked_train_state(group, [_vae(3), _vae(4)])
    frozen_before = _lane(state, 1)
    hypers = TrialHypers.stack([1e-3] * K, [1.0] * K)
    state, _ = sstep(state, hypers, batch, eps=eps)
    after_one = _lane(state, 1)
    moments = [m[1].clone() for m in state.exp_avg + state.exp_avg_sq]
    hypers.set_lane(1, 1e-3, 1.0, 0.0)
    live0 = _lane(state, 0)
    state, _ = sstep(state, hypers, batch, eps=eps)
    assert _same(_lane(state, 1), after_one)  # frozen at its step-1 values
    assert not _same(after_one, frozen_before)  # it did train before the mask
    assert all(torch.equal(m[1], b) for m, b in zip(state.exp_avg + state.exp_avg_sq, moments))
    assert state.count.tolist() == [2.0, 1.0]
    assert not _same(_lane(state, 0), live0)


def test_lane_ops_read_write_in_place(group):
    K = 4
    read, write = make_lane_ops(group)
    state = create_stacked_train_state(group, [_vae(s) for s in range(K)])
    ptrs = [t.data_ptr() for t in list(state.params.values()) + state.exp_avg + state.exp_avg_sq + [state.count]]
    before0 = _lane(state, 0)
    # A trained lane state goes in whole: weights, moments and step count.
    trained = create_train_state(group, _vae(99), 1e-3)
    b, e = _inputs(3)
    trained, _ = make_train_step(group)(trained, b, eps=e)
    state = write(state, trained, 2)
    assert _same(_lane(state, 2), trained.model.state_dict())
    assert _same(_lane(state, 0), before0)
    lane = read(state, 2)
    assert _same(lane.model.state_dict(), trained.model.state_dict()) and lane.step == 1
    for p, q in zip(lane.model.parameters(), trained.model.parameters()):
        assert torch.equal(lane.optimizer.state[p]["exp_avg_sq"], trained.optimizer.state[q]["exp_avg_sq"])
    # A fresh VAE zeroes the lane's moments and count; nothing is rebound.
    for k in (0, 2, 3):
        state = write(state, _vae(50 + k), k)
    assert state.count.tolist() == [0.0] * K and float(state.exp_avg_sq[0][2].abs().sum()) == 0.0
    assert _same(_lane(state, 3), _vae(53).state_dict())
    now = [t.data_ptr() for t in list(state.params.values()) + state.exp_avg + state.exp_avg_sq + [state.count]]
    assert now == ptrs


def test_stacked_eval_step_matches_unstacked(group):
    # Tolerance rel 1e-6 (the JAX package asserts exact equality here and
    # fails it, ROADMAP C.1); on this CPU the sums agree exactly.
    K = 2
    betas = [1.0, 4.0]
    state = create_stacked_train_state(group, [_vae(0), _vae(7)])
    batch, _ = _inputs(3)
    weights = torch.tensor(np.r_[np.ones(10), np.zeros(6)].astype(np.float32))
    out = make_stacked_eval_step(group)(state, TrialHypers.stack([1e-3] * K, betas), batch, weights)
    assert out["loss_sum"].shape == (K,)
    for k, seed in enumerate((0, 7)):
        su = create_train_state(group, _vae(seed), 1e-3)
        ref = make_eval_step(group, beta=betas[k], with_recon=False)(su, batch, weights)
        assert float(out["loss_sum"][k]) == pytest.approx(float(ref["loss_sum"]), rel=1e-6)


def test_stacked_eval_scan_is_the_sum_of_eval_steps(group):
    state = create_stacked_train_state(group, [_vae(0), _vae(7)])
    hypers = TrialHypers.stack([1e-3] * 2, [1.0, 4.0])
    batches, _ = _inputs(5, 3)
    weights = torch.ones(3, 16)
    weights[2, 9:] = 0.0
    got = make_stacked_eval_scan(group)(state, hypers, batches, weights)["loss_sum"]
    step = make_stacked_eval_step(group)
    want = torch.zeros(2)
    for b, w in zip(batches, weights):
        want = want + step(state, hypers, b, w)["loss_sum"]
    assert torch.equal(got, want)


# --- against the JAX package ---------------------------------------------


def _jax_stacked_steps(jmodel, params, batches, eps, lrs, betas, actives):
    """The JAX package's stacked step body (train/steps.py
    ``_stacked_lane_body``) with the noise given: vmapped over lanes,
    ``chain(scale_by_adam, scale(-lr))``, retirement as a select."""
    m = batches.shape[2]

    def lane_step(p, opt_state, batch, e, lr, beta, active):
        def loss_fn(q):
            mu, logvar = jmodel.apply({"params": q}, batch, method=JaxVAE.encode)
            z = mu + e * jnp.exp(0.5 * logvar)
            logits = jmodel.apply({"params": q}, z, method=JaxVAE.decode)
            return jax_elbo_loss_sum(logits, batch, mu, logvar, beta) / m

        loss, grads = jax.value_and_grad(loss_fn)(p)
        tx = optax.chain(optax.scale_by_adam(), optax.scale(-lr))
        updates, new_opt = tx.update(grads, opt_state, p)
        new = (optax.apply_updates(p, updates), new_opt)
        p, opt_state = jax.tree.map(lambda n, o: jnp.where(active > 0.5, n, o), new, (p, opt_state))
        return p, opt_state, loss * m

    vstep = jax.vmap(lane_step)
    opt_state = jax.vmap(optax.chain(optax.scale_by_adam(), optax.scale(-1.0)).init)(params)
    losses = []
    for i in range(batches.shape[0]):
        params, opt_state, loss = vstep(params, opt_state, batches[i], eps[i], lrs, betas, actives[i])
        losses.append(np.asarray(loss))
    return np.stack(losses), jax.device_get(params)


def test_stacked_step_matches_jax_vmapped_reference(group):
    K, S = 3, 3
    jmodel = JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    lanes = [jax.device_get(jax_init_vae_params(jax.random.key(s), jmodel)["params"]) for s in (1, 2, 3)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *lanes)
    batches, eps = _inputs(4, S, K)
    lrs, betas = [1e-3, 3e-3, 2e-3], [1.0, 4.0, 2.0]
    actives = [[1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 0.0, 1.0]]  # lane 1 retires after step 1
    jl, jp = _jax_stacked_steps(
        jmodel, jax.tree.map(jnp.asarray, stacked), jnp.asarray(batches.numpy()), jnp.asarray(eps.numpy()),
        jnp.asarray(lrs, jnp.float32), jnp.asarray(betas, jnp.float32), jnp.asarray(actives, jnp.float32),
    )

    model = StackedVAE(K, hidden_dim=HIDDEN, latent_dim=LATENT)
    model.load_state_dict(vae_params_from_flax(stacked))
    state = create_stacked_train_state(group, [VAE(hidden_dim=HIDDEN, latent_dim=LATENT)] * K)
    with torch.no_grad():
        for name, v in model.state_dict().items():
            state.params[name].copy_(v)
    hypers = TrialHypers.stack(lrs, betas)
    step = make_stacked_train_step(group)
    for i in range(S):
        for k in range(K):
            hypers.active[k] = actives[i][k]
        state, m = step(state, hypers, batches[i], eps=eps[i])
        np.testing.assert_allclose(m["loss_sum"].numpy(), jl[i], rtol=1e-5)
    for name, ref in vae_params_from_flax(jp).items():
        np.testing.assert_allclose(state.params[name].detach().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert state.count.tolist() == [3.0, 1.0, 3.0]


def test_stacked_iterator_matches_jax_index_for_index():
    data = synthetic_mnist(96, seed=0)
    data.images[:, 0] = np.arange(len(data), dtype=np.float32)  # each row names its index
    seeds, B = [0, 11, 5], 16
    port = StackedTrialDataIterator(data, setup_groups(1, devices=["cpu"])[0], B, seeds)
    ref = JaxStackedIterator(data, jax_setup_groups(1)[0], B, seeds, use_native=False, prefetch=False)
    for _ in range(2):  # two rounds: every lane's epochs 1 and 2
        got = [b.numpy() for b in port.round_batches()]
        want = [np.asarray(b) for b in ref.round_batches()]
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[..., 0], w[..., 0])
    port.set_lane(1, seed=42)
    ref.set_lane(1, seed=42)
    for (gs, g), (ws, w) in zip(port.round_chunks(4), ref.round_chunks(4)):
        assert gs == ws
        np.testing.assert_array_equal(g.numpy()[..., 0], np.asarray(w)[..., 0])


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_lane_elbo_plain_matches_pallas_per_lane(act):
    K, B, D, L = 3, 16, 784, 20
    rng = np.random.default_rng(21)
    logits = rng.normal(0, 2, (K, B, D)).astype(np.float32)
    x = rng.uniform(0, 1, (K, B, D)).astype(np.float32)
    mu = rng.normal(0, 1, (K, B, L)).astype(np.float32)
    logvar = rng.normal(0, 0.5, (K, B, L)).astype(np.float32)
    betas = [1.0, 2.5, 4.0]
    tdt, jdt = (torch.float32, jnp.float32) if act == "float32" else (torch.bfloat16, jnp.bfloat16)
    tl, tm, tv = (torch.tensor(a).to(tdt).requires_grad_() for a in (logits, mu, logvar))
    scale = 1.0 / B  # the per-sample mean's cotangent, exact in bf16
    value = fused_elbo_loss_sum_lanes(tl, torch.tensor(x), tm, tv, torch.tensor(betas)) * scale
    value.sum().backward()
    assert value.shape == (K,) and value.dtype == torch.float32
    for k in range(K):
        jl, jm, jv = (jnp.asarray(a[k]).astype(jdt) for a in (logits, mu, logvar))
        jval, jgrads = jax.value_and_grad(
            lambda l, m, lv: jax_fused(l, jnp.asarray(x[k]), m, lv, betas[k]) * scale, argnums=(0, 1, 2)
        )(jl, jm, jv)
        assert float(value[k].detach()) == pytest.approx(float(jval), rel=1e-5)
        for got, ref in zip((tl.grad[k], tm.grad[k], tv.grad[k]), jgrads):
            assert got.dtype == tdt
            ref32 = np.asarray(ref, dtype=np.float32)
            diff = np.abs(got.float().numpy() - ref32)
            if act == "float32":
                np.testing.assert_allclose(got.numpy(), ref32, rtol=1e-5, atol=1e-6)
            else:
                _, e = np.frexp(np.maximum(np.abs(ref32), 2.0**-126))
                assert np.all(diff <= np.ldexp(np.float32(1.0), e - 8)), float(diff.max())


def test_lane_elbo_plain_is_the_single_trial_function_per_lane():
    # The value exactly; the cotangents within one f32 ulp of sigmoid's
    # range times g (1.2e-7): torch's CPU sigmoid rounds its vector loop
    # and its scalar tail differently, and a (K, 8, 30) tensor and its
    # (8, 30) slices split at other places.
    K, B = 4, 8
    rng = np.random.default_rng(3)
    t = [torch.tensor(rng.normal(0, 1, (K, B, n)).astype(np.float32)) for n in (30, 30, 6, 6)]
    beta, g = torch.tensor([0.5, 1.0, 2.0, 3.0]), torch.tensor([0.25, 0.5, 1.0, 2.0])
    v = port_elbo.elbo_fwd_lanes_plain(*t, beta)
    cts = port_elbo.elbo_bwd_lanes_plain(*t, beta, g)
    for k in range(K):
        lane = [a[k] for a in t]
        assert torch.equal(v[k], port_elbo.elbo_fwd_plain(*lane, float(beta[k])))
        for a, b in zip(cts, port_elbo.elbo_bwd_plain(*lane, float(beta[k]), g[k])):
            torch.testing.assert_close(a[k], b, rtol=0, atol=1.2e-7)


# --- the lane kernels' wrappers --------------------------------------------


def test_lane_kernel_wrappers_launch_count_and_workspaces(monkeypatch):
    from test_torch_elbo import _stand_in_kernels

    K = 8
    meta = [torch.empty(K, 4, 8, device="meta"), torch.empty(K, 4, 8, device="meta"),
            torch.empty(K, 4, 2, device="meta"), torch.empty(K, 4, 2, device="meta")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_elbo_loss_sum_lanes(*meta, torch.ones(K, device="meta"))
    with pytest.raises(ValueError, match="one per lane"):
        fused_elbo_loss_sum_lanes(*(torch.zeros(K, 4, n) for n in (8, 8, 2, 2)), torch.ones(K + 1))

    ops = [torch.zeros(K, 128, 784), torch.zeros(K, 128, 784), torch.zeros(K, 128, 20), torch.zeros(K, 128, 20)]
    beta, g = torch.ones(K), torch.full((K,), 1.0 / 128)
    counts = {k: 0 for k in port_elbo.LAUNCHES}
    with _stand_in_kernels(monkeypatch) as (lib, now), monkeypatch.context() as mp:
        mp.setattr(port_elbo, "LAUNCHES", counts)
        out = port_elbo.elbo_fwd_lanes_cuda(*ops, beta)
        port_elbo.elbo_bwd_lanes_cuda(*ops, beta, g)
        assert out.shape == (K,) and lib.calls == ["mdt_elbo_fwd_lanes", "mdt_elbo_bwd_lanes"]
        fwd_args, bwd_args = lib.args
        # Per-lane element counts, K lanes, each lane's single-trial grid.
        assert fwd_args[5:8] == (128 * 784, 128 * 20, K) and fwd_args[10] == 101
        assert bwd_args[5:8] == (128 * 784, 128 * 20, K) and bwd_args[14] == 51
        # One workspace of K counters and K x grid partials per stream.
        (ws,) = port_elbo._workspaces.values()
        assert ws.numel() == K * (1 + 101) and fwd_args[11] == ws.data_ptr()
        assert port_elbo.LAUNCHES == {"elbo_fwd": 0, "elbo_bwd": 0, "elbo_fwd_lanes": 1, "elbo_bwd_lanes": 1}
        # Captured launches count per replay, in a workspace of the scope's.
        now.capturing = True
        with port_elbo.capture_scope() as scope:
            port_elbo.elbo_fwd_lanes_cuda(*ops, beta)
            port_elbo.elbo_bwd_lanes_cuda(*ops, beta, g)
        assert scope.launches == {"elbo_fwd": 0, "elbo_bwd": 0, "elbo_fwd_lanes": 1, "elbo_bwd_lanes": 1}
        assert len(scope.workspaces) == 1 and len(port_elbo._workspaces) == 1
        port_elbo.count_replay(scope)
        port_elbo.count_replay(scope)
        assert port_elbo.LAUNCHES["elbo_fwd_lanes"] == 3 and port_elbo.LAUNCHES["elbo_bwd_lanes"] == 3
        with pytest.raises(RuntimeError, match="outside elbo.capture_scope"):
            port_elbo.elbo_fwd_lanes_cuda(*ops, beta)
        now.capturing = False
        lib.err = 700
        with pytest.raises(RuntimeError, match="elbo_fwd_lanes launch failed with CUDA error 700"):
            port_elbo.elbo_fwd_lanes_cuda(*ops, beta)
        assert port_elbo.LAUNCHES["elbo_fwd_lanes"] == 3


# --- the stacked data feed -------------------------------------------------


def test_stacked_iterator_matches_trial_iterator(group):
    data = synthetic_mnist(96, seed=0)
    seeds, B = [0, 11, 5], 16
    stacked = StackedTrialDataIterator(data, group, B, seeds)
    singles = [TrialDataIterator(data, group, B, seed=s) for s in seeds]
    for epoch in (1, 2):  # two lockstep rounds: each lane's epochs 1 and 2
        per_lane = [list(it.epoch(epoch)) for it in singles]
        for b, got in enumerate(stacked.round_batches()):
            assert got.shape == (len(seeds), B, 784)
            for k in range(len(seeds)):
                assert torch.equal(got[k], per_lane[k][b])


def test_stacked_iterator_set_lane_refill_stream(group):
    data = synthetic_mnist(64, seed=0)
    stacked = StackedTrialDataIterator(data, group, 16, [0, 3])
    list(stacked.round_batches())  # both lanes consume epoch 1
    stacked.set_lane(1, seed=42)  # refill lane 1
    fresh = list(TrialDataIterator(data, group, 16, seed=42).epoch(1))  # restarts at epoch 1
    lane0 = list(TrialDataIterator(data, group, 16, seed=0).epoch(2))  # the neighbour goes on
    for b, got in enumerate(stacked.round_batches()):
        assert torch.equal(got[0], lane0[b]) and torch.equal(got[1], fresh[b])


def test_stacked_iterator_round_chunks_tail(group):
    data = synthetic_mnist(80, seed=1)  # 5 batches of 16: chunks 2 + 2 + 1
    chunks = list(StackedTrialDataIterator(data, group, 16, [0, 1]).round_chunks(2))
    assert [c[0] for c in chunks] == [0, 2, 4]
    assert [c[1].shape[0] for c in chunks] == [2, 2, 1]
    assert chunks[0][1].shape[1:] == (2, 16, 784)
    steps = torch.stack(list(StackedTrialDataIterator(data, group, 16, [0, 1]).round_batches()))
    assert torch.equal(torch.cat([c[1] for c in chunks]), steps)
    with pytest.raises(ValueError, match="chunk size"):
        StackedTrialDataIterator(data, group, 16, [0]).round_chunks(0)


# --- the driver's buckets --------------------------------------------------


def test_bucket_key_and_stackability():
    base = dict(trial_id=0, epochs=1, batch_size=16, hidden_dim=32, latent_dim=8)
    a = TrialConfig(**base)
    assert stack_bucket_key(a) == stack_bucket_key(
        TrialConfig(**{**base, "trial_id": 1, "lr": 9e-3, "beta": 7.0, "seed": 4, "epochs": 5, "log_interval": 3})
    )
    assert stack_bucket_key(a) != stack_bucket_key(TrialConfig(**{**base, "hidden_dim": 64}))
    assert stack_bucket_key(a) != stack_bucket_key(TrialConfig(**{**base, "batch_size": 32}))
    assert config_is_stackable(a)
    assert not config_is_stackable(TrialConfig(**{**base, "eval_sampled": True}))


def _small_cfg(i, **kw):
    return TrialConfig(**{**dict(trial_id=i, epochs=1, batch_size=16, hidden_dim=HIDDEN, latent_dim=LATENT,
                                 log_interval=100), **kw})


@pytest.fixture(scope="module")
def data():
    return synthetic_mnist(128, seed=0), synthetic_mnist(32, seed=1)


def _run(configs, data, out_dir, ngroups=1, test=True, **kw):
    train, test_data = data
    kw.setdefault("verbose", False)
    kw.setdefault("save_images", False)
    return run_hpo(configs, train, test_data if test else None, groups=setup_groups(ngroups, devices=["cpu"] * ngroups),
                   out_dir=str(out_dir), **kw)


def test_run_hpo_stacked_end_to_end(tmp_path, data):
    # 5 same-shape configs on 2 groups: the bucket splits so no group
    # idles; unequal epoch targets drive mask-and-refill mid-bucket.
    configs = [_small_cfg(0), _small_cfg(1, lr=3e-3), _small_cfg(2, epochs=2, beta=4.0), _small_cfg(3, seed=7),
               _small_cfg(4, epochs=3)]
    results = _run(configs, data, tmp_path, ngroups=2, stack_trials=True)
    assert [r.trial_id for r in results] == [0, 1, 2, 3, 4]
    assert {r.group_id for r in results} == {0, 1}
    for r in results:
        assert r.status == "completed" and r.stacked
        assert r.steps == 8 * r.config.epochs and len(r.history) == r.config.epochs
        assert np.isfinite(r.final_train_loss) and np.isfinite(r.final_test_loss)
        assert r.checkpoint and os.path.exists(r.checkpoint)
        with open(os.path.join(r.out_dir, "metrics.json")) as f:
            metrics = json.load(f)
        assert metrics["trial_id"] == r.trial_id and metrics["stacked"] is True
        assert metrics["dataset"] == "synthetic-mnist"
    assert results[0].final_train_loss != results[1].final_train_loss
    with open(tmp_path / "sweep_ledger.jsonl") as f:
        ends = [json.loads(ln) for ln in f if '"attempt_end"' in ln]
    assert sorted(e["trial_id"] for e in ends if e["status"] == "completed") == [0, 1, 2, 3, 4]
    assert all(e["summary"]["stacked"] for e in ends)


def test_run_hpo_stacked_parity_with_unstacked(tmp_path, data):
    # Every stacked trial's losses equal the same config run unstacked,
    # exactly, after two epochs.
    configs = [_small_cfg(0, epochs=2), _small_cfg(1, lr=3e-3, epochs=2), _small_cfg(2, beta=2.0, seed=5, epochs=2)]
    stacked = _run(configs, data, tmp_path / "s", stack_trials=True, save_checkpoints=False)
    assert all(r.stacked for r in stacked)
    for i, cfg in enumerate(configs):
        (un,) = _run([cfg], data, tmp_path / f"u{i}", save_checkpoints=False)
        assert not un.stacked
        assert stacked[i].history == un.history
        assert stacked[i].final_train_loss == un.final_train_loss
        assert stacked[i].final_test_loss == un.final_test_loss


def test_run_hpo_stacked_checkpoint_resumes_unstacked(tmp_path, data):
    # A retired lane's checkpoint has the unstacked trial's tree and
    # metadata: an unstacked resume finds the trial complete.
    cfgs = [_small_cfg(0), _small_cfg(1, lr=2e-3)]
    _run(cfgs, data, tmp_path, test=False, stack_trials=True)
    (r,) = _run([cfgs[0]], data, tmp_path, test=False, resume=True)
    assert r.status == "resumed_complete" and r.steps == 8


def test_stacked_checkpoint_extends_unstacked_bitwise(tmp_path, data):
    # Resumed unstacked with one epoch more, a stacked trial's checkpoint
    # (weights, moments, step, history and the lane's generator state) ends
    # where the straight unstacked run ends, bit for bit.
    cfgs = [_small_cfg(0, lr=2e-3), _small_cfg(1, seed=3)]
    _run(cfgs, data, tmp_path / "s", stack_trials=True)
    (ext,) = _run([_small_cfg(1, seed=3, epochs=2)], data, tmp_path / "s", resume=True)
    (straight,) = _run([_small_cfg(1, seed=3, epochs=2)], data, tmp_path / "u")
    assert ext.status == "completed" and ext.resumed_from_step == 8
    assert ext.history == straight.history


def test_run_hpo_stacked_mixed_with_unstackable(tmp_path, data):
    configs = [_small_cfg(0), _small_cfg(1, lr=3e-3), _small_cfg(2, seed=2), _small_cfg(3, eval_sampled=True)]
    results = _run(configs, data, tmp_path, ngroups=2, stack_trials=True)
    assert [r.trial_id for r in results] == [0, 1, 2, 3]
    assert all(r.status == "completed" for r in results)
    assert [r.stacked for r in results] == [True, True, True, False]


def test_run_hpo_stacked_falls_back_when_groups_suffice(tmp_path, data):
    results = _run([_small_cfg(0), _small_cfg(1)], data, tmp_path, ngroups=2, test=False,
                   save_checkpoints=False, stack_trials=True)
    assert all(not r.stacked for r in results)
    assert all(r.status == "completed" for r in results)


def test_run_hpo_stacked_rejects_contradictory_modes(tmp_path, data):
    cfgs = [_small_cfg(0), _small_cfg(1)]
    with pytest.raises(ValueError, match="resume"):
        _run(cfgs, data, tmp_path, stack_trials=True, resume=True)
    with pytest.raises(ValueError, match="shard_across_trials"):
        _run(cfgs, data, tmp_path, stack_trials=True, shard_across_trials=True)
    with pytest.raises(ValueError, match="model_builder"):
        _run(cfgs, data, tmp_path, stack_trials=True, model_builder=lambda cfg: VAE())
    with pytest.raises(ValueError, match="stack_max_lanes"):
        _run(cfgs, data, tmp_path, stack_trials=True, stack_max_lanes=0)


def test_run_hpo_stacked_fused_steps_bucket(tmp_path, data):
    # fused_steps 3 over 8 batches: chunks of 3, 3 and a tail of 2 run one
    # step at a time; counts and history as the contract says, and the
    # same numbers as fused_steps 1.
    configs = [_small_cfg(i, fused_steps=3, epochs=2) for i in range(3)]
    results = _run(configs, data, tmp_path / "f", test=False, stack_trials=True)
    assert all(r.stacked and r.steps == 16 and len(r.history) == 2 for r in results)
    ones = _run([_small_cfg(i, epochs=2) for i in range(3)], data, tmp_path / "o", test=False, stack_trials=True)
    for a, b in zip(results, ones):
        assert a.final_train_loss == pytest.approx(b.final_train_loss, rel=1e-6)


def test_run_hpo_stacked_host_syncs_o1(tmp_path, data):
    # The bucket pays two fetches per round for all lanes together.
    results = _run([_small_cfg(i, epochs=2) for i in range(4)], data, tmp_path, stack_trials=True)
    assert all(r.host_syncs == 2 * 2 for r in results)


def test_stack_max_lanes_bounds_the_stacked_state(tmp_path, data, monkeypatch):
    lanes = []
    real = driver.create_stacked_train_state

    def spy(group, models):
        lanes.append(len(models))
        return real(group, models)

    monkeypatch.setattr(driver, "create_stacked_train_state", spy)
    results = _run([_small_cfg(i, epochs=1 + i % 2) for i in range(5)], data, tmp_path, test=False,
                   stack_trials=True, stack_max_lanes=2)
    assert lanes == [2]
    assert all(r.stacked and r.status == "completed" for r in results)


def test_a_lane_that_diverges_is_recorded_and_the_others_go_on(tmp_path, data):
    configs = [_small_cfg(0, epochs=2), _small_cfg(1, lr=float("nan"), epochs=2), _small_cfg(2, epochs=2)]
    results = _run(configs, data, tmp_path, stack_trials=True)
    assert [r.status for r in results] == ["completed", "diverged", "completed"]
    assert "non-finite" in results[1].error and results[1].steps == 8
    (un,) = _run([configs[2]], data, tmp_path / "u")
    assert results[2].final_train_loss == un.final_train_loss


def test_a_bucket_setup_fault_is_retried_or_recorded(tmp_path, data, monkeypatch):
    from multidisttorch_tpu_torch.hpo.supervision import RetryPolicy

    real, fired = driver.StackedTrialDataIterator, []

    def flaky(*a, **k):
        if not fired:
            fired.append(1)
            raise OSError("injected data-path fault at bucket setup")
        return real(*a, **k)

    monkeypatch.setattr(driver, "StackedTrialDataIterator", flaky)
    cfgs = [_small_cfg(0), _small_cfg(1, lr=2e-3)]
    results = _run(cfgs, data, tmp_path / "retry", test=False, stack_trials=True,
                   retry=RetryPolicy(max_retries=1, backoff_base_s=0.01))
    assert fired and all(r.status == "completed" and r.stacked for r in results)
    fired.clear()
    results = _run(cfgs, data, tmp_path / "resilient", test=False, stack_trials=True, resilient=True)
    assert [r.status for r in results] == ["failed", "failed"] and "injected" in results[0].error
    with open(tmp_path / "resilient" / "sweep_ledger.jsonl") as f:
        events = [json.loads(ln)["event"] for ln in f]
    assert events == ["attempt_start", "attempt_end"] * 2
    fired.clear()
    with pytest.raises(OSError, match="injected"):
        _run(cfgs, data, tmp_path / "raises", test=False, stack_trials=True)


# --- a two-rank group ------------------------------------------------------

_RANK_MAIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import driver
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups

out_dir, result_path = sys.argv[1:3]
world, rank = cluster.initialize_runtime(device="cpu")
group = setup_groups(1, device="cpu")[0]
train, test = synthetic_mnist(128, seed=0), synthetic_mnist(32, seed=1)
small = dict(epochs=2, batch_size=16, hidden_dim=16, latent_dim=4, log_interval=100)
configs = [driver.TrialConfig(trial_id=i, seed=i, lr=(1e-3, 3e-3, 2e-3)[i], beta=(1.0, 2.0, 4.0)[i], **small)
           for i in range(3)]
got = {}
res = driver.run_hpo(configs, train, test, groups=[group], out_dir=out_dir + "/s", save_images=False,
                     verbose=False, stack_trials=True)
got["stacked"] = [[r.status, r.stacked, r.steps, r.host_syncs, r.final_train_loss, r.final_test_loss] for r in res]
got["unstacked"] = []
for i, cfg in enumerate(configs):
    (r,) = driver.run_hpo([cfg], train, test, groups=[group], out_dir=f"{out_dir}/u{i}", save_images=False,
                          verbose=False, save_checkpoints=False)
    got["unstacked"].append([r.final_train_loss, r.final_test_loss])
# Two one-rank groups, one per process: the bucket of five splits in two,
# and each process runs the half the shared schedule gives its group.
res = driver.run_hpo([driver.TrialConfig(trial_id=i, seed=i, **small) for i in range(5)], train, None,
                     groups=setup_groups(2, device="cpu"), out_dir=out_dir + "/split", save_images=False,
                     verbose=False, stack_trials=True)
got["split"] = [[r.trial_id, r.group_id, r.status, r.stacked] for r in res]
with open(result_path, "w") as f:
    json.dump(got, f)
cluster.shutdown_runtime()
"""


def test_two_rank_gloo_stacked_bucket_matches_ddp_trials(tmp_path):
    # Also: two one-rank groups in two processes split one bucket between
    # them by the schedule every process computes alike.
    from test_torch_groups import _launch

    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _RANK_MAIN, str(tmp_path / "out"), outs[r]], 2, timeout=150)
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    for key in ("stacked", "unstacked"):
        assert got[0][key] == got[1][key]  # both ranks see the group's numbers
    for (status, stacked, steps, syncs, train, test), (utrain, utest) in zip(got[0]["stacked"], got[0]["unstacked"]):
        assert status == "completed" and stacked and steps == 16 and syncs == 4
        assert train == pytest.approx(utrain, rel=1e-5) and test == pytest.approx(utest, rel=1e-5)
    assert os.path.exists(tmp_path / "out" / "s" / "trial-2" / "state.msgpack")
    split = sorted(got[0]["split"] + got[1]["split"])
    assert split == [[0, 0, "completed", True], [1, 0, "completed", True], [2, 1, "completed", True],
                     [3, 1, "completed", True], [4, 1, "completed", True]]
