"""Remat (``TrialConfig.remat``; ``remat=`` on ``make_train_step`` and
the other step makers) in the port: the model's forward under
``torch.utils.checkpoint``, the noise drawn before it.

On the CPU remat on and off give the same bits (losses, parameters, Adam's
state, the generators' states) for single and stacked steps, for
``grad_accum`` 1 and 2, per step and through the multi-steps, in
``run_hpo`` and in a two-process gloo group. Against the JAX package's
remat step (``jax.checkpoint`` of the forward, the same weights and
injected noise) the tolerances are the slice's (``test_torch_train.py``):
loss rel 1e-5, params rtol 1e-4 / atol 1e-6.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.models.vae import init_vae_params as jax_init_vae_params
from multidisttorch_tpu.ops.losses import elbo_loss_sum as jax_elbo_loss_sum
from multidisttorch_tpu.ops.pallas_elbo import fused_elbo_loss_sum as jax_fused
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params, vae_params_from_flax
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.steps import (
    TrialHypers,
    create_stacked_train_state,
    create_train_state,
    make_multi_step,
    make_stacked_multi_step,
    make_stacked_train_step,
    make_train_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HIDDEN, LATENT, LR, LANES = 16, 4, 1e-3, 3


@pytest.fixture(scope="module")
def group():
    return setup_groups(1, devices=["cpu"])[0]


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    return torch.tensor(rng.uniform(0, 1, (3, LANES, 16, 784)).astype(np.float32))


def _single(group):
    return create_train_state(group, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0), LR)


def _stacked(group):
    lanes = [init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), s) for s in range(LANES)]
    return create_stacked_train_state(group, lanes), TrialHypers.stack([1e-3, 3e-3, 2e-3], [1.0, 2.0, 0.5])


def _gens(n):
    return [torch.Generator().manual_seed(100 + j) for j in range(n)]


def _train(group, stacked: bool, how: str, grad_accum: int, remat: bool, batches) -> dict:
    """Three steps from fixed weights, noise from seeded generators; every
    tensor the steps leave behind."""
    if stacked:
        state, hypers = _stacked(group)
        gens = _gens(LANES)
        if how == "step":
            step = make_stacked_train_step(group, grad_accum=grad_accum, remat=remat)
            losses = [step(state, hypers, b, generators=gens)[1]["loss_sum"] for b in batches]
        else:
            multi = make_stacked_multi_step(group, grad_accum=grad_accum, remat=remat)
            losses = [multi(state, hypers, batches, generators=gens)[1]["loss_sum"]]
        out = {f"param {k}": v.detach().clone() for k, v in state.params.items()}
        out.update({f"moment {i}": t.clone() for i, t in enumerate(state.exp_avg + state.exp_avg_sq)})
        out["count"] = state.count.clone()
    else:
        state, gens = _single(group), _gens(1)
        if how == "step":
            step = make_train_step(group, grad_accum=grad_accum, remat=remat)
            losses = [step(state, b[0], generator=gens[0])[1]["loss_sum"] for b in batches]
        else:
            multi = make_multi_step(group, grad_accum=grad_accum, remat=remat)
            losses = [multi(state, batches[:, 0], generator=gens[0])[1]["loss_sum"]]
        out = {f"param {k}": v.detach().clone() for k, v in state.params.items()}
        for i, st in enumerate(state.optimizer.state.values()):
            out.update({f"adam {i} {k}": v.clone() for k, v in st.items()})
    out["losses"] = torch.stack([torch.as_tensor(x).reshape(-1) for x in losses]).reshape(-1)
    out.update({f"generator {j}": g.get_state() for j, g in enumerate(gens)})
    return out


@pytest.mark.parametrize("how", ["step", "multi"])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("stacked", [False, True])
def test_remat_gives_the_bits_of_remat_off(group, batches, stacked, grad_accum, how):
    off = _train(group, stacked, how, grad_accum, False, batches)
    on = _train(group, stacked, how, grad_accum, True, batches)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert bool(torch.isfinite(on["losses"]).all())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_the_generator_advances_one_draw_per_microbatch(group, batches, remat, grad_accum):
    gen = torch.Generator().manual_seed(7)
    make_train_step(group, grad_accum=grad_accum, remat=remat)(_single(group), batches[0, 0], generator=gen)
    ref = torch.Generator().manual_seed(7)
    for _ in range(grad_accum):
        torch.randn((16 // grad_accum, LATENT), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    # Stacked: one draw per lane per microbatch, from each lane's generator.
    state, hypers = _stacked(group)
    gens, refs = _gens(LANES), _gens(LANES)
    make_stacked_train_step(group, grad_accum=grad_accum, remat=remat)(state, hypers, batches[0], generators=gens)
    for _ in range(grad_accum):
        for r in refs:
            torch.randn((16 // grad_accum, LATENT), generator=r)
    assert all(torch.equal(g.get_state(), r.get_state()) for g, r in zip(gens, refs))


def _jax_remat_step(jmodel, params, batch, eps, fused):
    """The JAX package's remat step at fixed params with injected noise: its
    ``VAE`` encode/decode under ``jax.checkpoint`` (``train/steps.py``'s
    ``forward = jax.checkpoint(forward)``), its loss outside, optax's Adam."""
    loss_impl = jax_fused if fused else jax_elbo_loss_sum
    m = batch.shape[0]

    def forward(p, x, e):
        mu, logvar = jmodel.apply({"params": p}, x, method=JaxVAE.encode)
        z = mu + e * jnp.exp(0.5 * logvar)
        return jmodel.apply({"params": p}, z, method=JaxVAE.decode), mu, logvar

    forward = jax.checkpoint(forward)

    def loss_fn(p):
        logits, mu, logvar = forward(p, batch, eps)
        return loss_impl(logits, batch, mu, logvar, 1.0) / m

    tx = optax.adam(LR)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss) * m, jax.device_get(optax.apply_updates(params, updates))


@pytest.mark.parametrize("fused", [True, False])
def test_the_remat_step_matches_the_jax_remat_step(group, fused):
    jmodel = JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    params = jax.device_get(jax_init_vae_params(jax.random.key(1), jmodel)["params"])
    rng = np.random.default_rng(5)
    batch = rng.uniform(0, 1, (16, 784)).astype(np.float32)
    eps = rng.normal(0, 1, (16, LATENT)).astype(np.float32)
    jloss, jparams = _jax_remat_step(jmodel, params, jnp.asarray(batch), jnp.asarray(eps), fused)
    model = VAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    model.load_state_dict(vae_params_from_flax(params))
    state = create_train_state(group, model, LR)
    state, metrics = make_train_step(group, use_fused_loss=fused, remat=True)(
        state, torch.tensor(batch), eps=torch.tensor(eps))
    assert float(metrics["loss_sum"]) == pytest.approx(jloss, rel=1e-5)
    got = state.model.state_dict()
    for k, v in vae_params_from_flax(jparams).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stack", [False, True])
def test_run_hpo_with_remat_equals_remat_off(tmp_path, stack):
    train, test = synthetic_mnist(96, seed=0), synthetic_mnist(40, seed=1)
    results = {}
    for remat in (False, True):
        configs = [TrialConfig(trial_id=i, epochs=2, batch_size=16, seed=i, lr=(1e-3, 3e-3)[i], hidden_dim=HIDDEN,
                               latent_dim=LATENT, fused_steps=4, grad_accum=1 + i, remat=remat) for i in range(2)]
        if stack:  # a stacked bucket shares its grad_accum
            configs = [TrialConfig(**{**c.__dict__, "grad_accum": 1}) for c in configs]
        results[remat] = run_hpo(configs, train, test, groups=setup_groups(1, devices=["cpu"]),
                                 out_dir=str(tmp_path / str(remat)), save_images=False, verbose=False,
                                 stack_trials=stack)
    for a, b in zip(results[False], results[True], strict=True):
        assert b.status == "completed" and b.config.remat and b.stacked == stack
        assert (a.steps, a.history, a.final_train_loss, a.final_test_loss) == (
            b.steps, b.history, b.final_train_loss, b.final_test_loss)


def _gloo_remat_rank(out_path: str) -> None:
    """One rank of a two-process gloo world: a two-rank (DDP) group trains 3
    steps, remat off and on, from the same weights, rows and generators."""
    cluster.initialize_runtime(device="cpu")
    pair = setup_groups(1, device="cpu")[0]
    rng = np.random.default_rng(13)
    batches = torch.tensor(rng.uniform(0, 1, (3, 16, 784)).astype(np.float32))
    rows = slice(8 * pair.local_rank, 8 * pair.local_rank + 8)
    runs = []
    for remat in (False, True):
        state = create_train_state(pair, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0), LR)
        gen = torch.Generator().manual_seed(50 + pair.local_rank)
        multi = make_multi_step(pair, grad_accum=2, remat=remat)
        state, m = multi(state, batches[:, rows], generator=gen)
        runs.append((m["loss_sum"], state.model.state_dict()))
    (l0, p0), (l1, p1) = runs
    got = {
        "losses_equal": bool(torch.equal(l0, l1)),
        "params_equal": all(torch.equal(v, p1[k]) for k, v in p0.items()),
        "finite": bool(torch.isfinite(l1).all()),
    }
    with open(out_path, "w") as f:
        json.dump(got, f)
    cluster.shutdown_runtime()


def test_remat_trains_in_a_two_process_gloo_group(tmp_path):
    from test_torch_groups import _launch

    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, __file__, outs[r]], 2, timeout=120)
    for out in outs:
        with open(out) as f:
            assert json.load(f) == {"losses_equal": True, "params_equal": True, "finite": True}


if __name__ == "__main__":
    _gloo_remat_rank(sys.argv[1])
