"""The port's train, eval and sample steps against the JAX package's.

Both start from identical weights (a flax init carried across), the same
batch and the same injected noise. The JAX reference step is built from
the JAX package's own functions: ``VAE.apply`` encode/decode with the
noise given explicitly, its ``fused_elbo_loss_sum`` (Pallas, interpret
mode on the CPU) or ``elbo_loss_sum``, and ``optax.adam`` — the JAX ``VAE``
draws its own noise from flax's ``'reparam'`` stream, which torch cannot
reproduce (ROADMAP C.2).

Tolerances: loss rel 1e-5 and params rtol 1e-4 / atol 1e-6, the JAX
package's own for fused against plain training (test_pallas_elbo.py:
201-234): one Adam step moves each weight by about lr, so f32 rounding
differences in the gradients show at the 1e-4 level.
"""

import gc
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
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train.steps import create_train_state as jax_create_train_state
from multidisttorch_tpu.train.steps import make_eval_step as jax_make_eval_step
from multidisttorch_tpu_torch.models.vae import VAE, init_vae_params, vae_params_from_flax
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, setup_groups
from multidisttorch_tpu_torch.train.steps import (
    GraphedMultiStep,
    create_train_state,
    eager_reason,
    make_eval_step,
    make_multi_step,
    make_sample_step,
    make_train_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HIDDEN, LATENT, LR = 16, 4, 1e-3


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    params = jax.device_get(jax_init_vae_params(jax.random.key(1), jmodel)["params"])
    rng = np.random.default_rng(5)
    batch = rng.uniform(0, 1, (16, 784)).astype(np.float32)
    eps = rng.normal(0, 1, (16, LATENT)).astype(np.float32)
    group = setup_groups(1, devices=["cpu"])[0]
    return jmodel, params, batch, eps, group


def _port_state(params, group, lr=LR):
    model = VAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    model.load_state_dict(vae_params_from_flax(params))
    return create_train_state(group, model, lr)


def _jax_step(jmodel, params, batch, eps, beta, fused):
    loss_impl = jax_fused if fused else jax_elbo_loss_sum
    m = batch.shape[0]

    def loss_fn(p):
        mu, logvar = jmodel.apply({"params": p}, batch, method=JaxVAE.encode)
        z = mu + eps * jnp.exp(0.5 * logvar)
        logits = jmodel.apply({"params": p}, z, method=JaxVAE.decode)
        return loss_impl(logits, batch, mu, logvar, beta) / m

    tx = optax.adam(LR)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return float(loss) * m, jax.device_get(optax.apply_updates(params, updates))


def _assert_params_close(state, jparams, rtol=1e-4, atol=1e-6):
    got = state.model.state_dict()
    for k, v in vae_params_from_flax(jparams).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("beta", [1.0, 2.0])
@pytest.mark.parametrize("fused", [True, False])
def test_one_train_step_matches_jax(setup, fused, beta):
    jmodel, params, batch, eps, group = setup
    jloss, jparams = _jax_step(
        jmodel, params, jnp.asarray(batch), jnp.asarray(eps), beta, fused
    )
    state = _port_state(params, group)
    state, metrics = make_train_step(group, beta=beta, use_fused_loss=fused)(
        state, torch.tensor(batch), eps=torch.tensor(eps)
    )
    assert state.step == 1
    assert metrics["loss_sum"].dtype == torch.float32 and metrics["loss_sum"].dim() == 0
    assert float(metrics["loss_sum"]) == pytest.approx(jloss, rel=1e-5)
    _assert_params_close(state, jparams)


def test_multi_step_equals_single_steps(setup):
    _, params, batch, eps, group = setup
    rng = np.random.default_rng(8)
    batches = torch.tensor(rng.uniform(0, 1, (4, 16, 784)).astype(np.float32))
    noise = torch.tensor(rng.normal(0, 1, (4, 16, LATENT)).astype(np.float32))
    s1 = _port_state(params, group)
    s1, m1 = make_multi_step(group)(s1, batches, eps=noise)
    s2 = _port_state(params, group)
    step = make_train_step(group)
    singles = []
    for k in range(4):
        s2, m = step(s2, batches[k], eps=noise[k])
        singles.append(m["loss_sum"])
    assert m1["loss_sum"].shape == (4,)
    assert torch.equal(m1["loss_sum"], torch.stack(singles))
    assert s1.step == s2.step == 4
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, s2.model.state_dict()[k])


@pytest.mark.parametrize(
    "kw", [{}, {"grad_accum": 2}, {"use_fused_loss": False}], ids=["cpu", "grad_accum", "plain-loss"]
)
def test_multi_step_keeps_the_eager_loop_by_rule(setup, kw):
    # On the CPU, with grad_accum > 1 or with the plain loss, the multi-step
    # is the eager loop, and it is K single steps to the last bit.
    _, params, _, _, group = setup
    rng = np.random.default_rng(4)
    batches = torch.tensor(rng.uniform(0, 1, (3, 16, 784)).astype(np.float32))
    noise = torch.tensor(rng.normal(0, 1, (3, 16, LATENT)).astype(np.float32))
    multi = make_multi_step(group, **kw)
    assert not multi.graphed and multi.replays == 0
    assert eager_reason(group, **kw) is not None
    s1, m1 = multi(_port_state(params, group), batches, eps=noise)
    s2, step = _port_state(params, group), make_train_step(group, **kw)
    singles = []
    for k in range(3):
        s2, m = step(s2, batches[k], eps=noise[k])
        singles.append(m["loss_sum"])
    assert torch.equal(m1["loss_sum"], torch.stack(singles))
    assert s1.step == s2.step == 3
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, s2.model.state_dict()[k])


def _group(size: int, device: str) -> TrialGroup:
    return TrialGroup(group_id=0, global_ranks=tuple(range(size)), device=torch.device(device),
                      is_local_member=True, local_rank=0, owner_process=0, pg=object())


@pytest.mark.parametrize(
    "size, device, kw, reason",
    [
        (1, "cuda:0", {}, None),
        (1, "cpu", {}, "not a CUDA device"),
        (2, "cuda:0", {}, "2 ranks"),
        (1, "cuda:0", {"grad_accum": 4}, "grad_accum=4"),
        (1, "cuda:0", {"use_fused_loss": False}, "use_fused_loss=False"),
    ],
)
def test_which_multi_steps_run_as_cuda_graphs(size, device, kw, reason):
    # Decided from the group's size and device and the arguments alone.
    got = eager_reason(_group(size, device), **kw)
    if reason is None:
        assert got is None
    else:
        assert reason in got


def test_asking_for_cuda_graphs_without_cuda_raises(monkeypatch):
    # The rule picks CUDA graphs for a one-rank group on a card. Where there
    # is no CUDA that raises: it never quietly runs the eager loop.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    group = _group(1, "cuda:0")
    assert eager_reason(group) is None
    with pytest.raises(RuntimeError, match="CUDA-graph capture needs a CUDA device"):
        make_multi_step(group)
    with pytest.raises(RuntimeError, match="needs a CUDA device, got cpu"):
        GraphedMultiStep(lambda *args: None, torch.device("cpu"))


def test_cpu_optimizer_is_torchs_default_adam(setup):
    # The CPU keeps the optimizer the tests hold to optax.adam; only a card
    # gets the capturable one.
    _, params, _, _, group = setup
    state = _port_state(params, group)
    assert state.optimizer.defaults["capturable"] is False


def _gloo_multi_step_rank(out_path: str) -> None:
    """One rank of a two-process gloo world: from the same weights, a
    two-rank group's multi-step of 3 steps and 3 single DDP steps."""
    cluster.initialize_runtime(device="cpu")
    pair = setup_groups(1, device="cpu")[0]
    rng = np.random.default_rng(13)
    batches = torch.tensor(rng.uniform(0, 1, (3, 16, 784)).astype(np.float32))
    noise = torch.tensor(rng.normal(0, 1, (3, 16, LATENT)).astype(np.float32))
    rows = slice(8 * pair.local_rank, 8 * pair.local_rank + 8)
    multi = make_multi_step(pair)
    new_state = lambda: create_train_state(
        pair, init_vae_params(VAE(hidden_dim=HIDDEN, latent_dim=LATENT), 0), LR
    )
    s1, m1 = multi(new_state(), batches[:, rows], eps=noise[:, rows])
    s2, step, singles = new_state(), make_train_step(pair), []
    for k in range(3):
        s2, m = step(s2, batches[k, rows], eps=noise[k, rows])
        singles.append(m["loss_sum"])
    got = {
        "graphed": multi.graphed,
        "losses_equal": bool(torch.equal(m1["loss_sum"], torch.stack(singles))),
        "params_equal": all(
            torch.equal(v, s2.model.state_dict()[k]) for k, v in s1.model.state_dict().items()
        ),
        "steps": [s1.step, s2.step],
    }
    with open(out_path, "w") as f:
        json.dump(got, f)
    # Free the DDP states while the group is alive: left to the frame's
    # end, their teardown hung now and then after the rank had written its
    # result (likely a reducer holding the gloo group's last reference and
    # joining gloo's threads with the GIL held).
    del multi, s1, s2
    gc.collect()
    cluster.shutdown_runtime()


def test_multi_rank_multi_step_keeps_the_eager_loop(tmp_path):
    from test_torch_groups import _launch

    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, __file__, outs[r]], 2, timeout=120)
    for out in outs:
        with open(out) as f:
            got = json.load(f)
        assert got == {"graphed": False, "losses_equal": True, "params_equal": True, "steps": [3, 3]}


def test_grad_accum_matches_full_batch(setup):
    # Two equal microbatches of the per-sample mean average to the full
    # batch's gradient; f32 sums in another order (same tolerances).
    _, params, batch, eps, group = setup
    s1, m1 = make_train_step(group)(_port_state(params, group), torch.tensor(batch), eps=torch.tensor(eps))
    s2, m2 = make_train_step(group, grad_accum=2)(
        _port_state(params, group), torch.tensor(batch), eps=torch.tensor(eps)
    )
    assert float(m2["loss_sum"]) == pytest.approx(float(m1["loss_sum"]), rel=1e-5)
    for k, v in s1.model.state_dict().items():
        np.testing.assert_allclose(s2.model.state_dict()[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(group, grad_accum=0)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(group, grad_accum=3)(_port_state(params, group), torch.tensor(batch))


@pytest.mark.parametrize("beta", [1.0, 4.0])
def test_masked_eval_matches_jax_on_padded_batch(setup, beta):
    # 20 rows at batch 16: the second batch is 4 real rows + 12 zero rows
    # with weight 0. Posterior-mean eval is deterministic: rel 1e-5.
    jmodel, params, _, _, group = setup
    rows = np.random.default_rng(9).uniform(0, 1, (20, 784)).astype(np.float32)
    padded = np.zeros((32, 784), np.float32)
    padded[:20] = rows
    weights = np.zeros(32, np.float32)
    weights[:20] = 1.0

    trial = jax_setup_groups(8)[0]
    jstate = jax_create_train_state(trial, jmodel, optax.adam(LR), jax.random.key(0))
    jstate = jstate.replace(params=trial.device_put(params))
    jeval = jax_make_eval_step(trial, jmodel, beta=beta, masked=True)
    peval = make_eval_step(group, beta=beta)
    state = _port_state(params, group)
    for b in range(2):
        sl = slice(16 * b, 16 * (b + 1))
        jout = jeval(jstate, jnp.asarray(padded[sl]), jnp.asarray(weights[sl]))
        pout = peval(state, torch.tensor(padded[sl]), torch.tensor(weights[sl]))
        assert float(pout["loss_sum"]) == pytest.approx(float(jout["loss_sum"]), rel=1e-5)
        np.testing.assert_allclose(
            pout["recon"].numpy(), np.asarray(jout["recon"]), rtol=1e-5, atol=1e-5
        )


def test_sampled_eval_with_zero_noise_is_the_posterior_mean(setup):
    _, params, batch, _, group = setup
    state = _port_state(params, group)
    mean = make_eval_step(group, with_recon=False)(state, torch.tensor(batch))
    sampled = make_eval_step(group, with_recon=False)(
        state, torch.tensor(batch), eps=torch.zeros(16, LATENT)
    )
    assert float(sampled["loss_sum"]) == pytest.approx(float(mean["loss_sum"]), rel=1e-6)
    assert "recon" not in mean


def test_sample_step_decodes_prior_draws(setup):
    _, params, _, _, group = setup
    state = _port_state(params, group)
    sample = make_sample_step(group, num_samples=10)
    a = sample(state, torch.Generator().manual_seed(0))
    b = sample(state, torch.Generator().manual_seed(0))
    assert a.shape == (10, 784) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


if __name__ == "__main__":
    _gloo_multi_step_rank(sys.argv[1])
