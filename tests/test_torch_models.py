"""The port's VAE against the JAX package's, from the same weights.

The JAX VAE is initialised with flax and its parameters are carried
across with ``vae_params_from_flax``. The reparameterisation noise is
injected into both (the JAX VAE's own ``'reparam'`` stream cannot be
reproduced in torch). Tolerance atol 1e-5 (rtol 1e-5) in f32: the same
products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multidisttorch_tpu.models.vae import VAE as JaxVAE
from multidisttorch_tpu.models.vae import init_vae_params as jax_init_vae_params
from multidisttorch_tpu_torch.models.vae import (
    VAE,
    init_vae_params,
    vae_params_from_flax,
    vae_params_to_flax,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HIDDEN, LATENT = 16, 4


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    params = jax.device_get(jax_init_vae_params(jax.random.key(0), jmodel)["params"])
    tmodel = VAE(hidden_dim=HIDDEN, latent_dim=LATENT)
    tmodel.load_state_dict(vae_params_from_flax(params))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (8, 784)).astype(np.float32)
    eps = rng.normal(0, 1, (8, LATENT)).astype(np.float32)
    return jmodel, params, tmodel, x, eps


def _close(got: torch.Tensor, ref) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_encode_matches_jax(pair):
    jmodel, params, tmodel, x, _ = pair
    jmu, jlv = jmodel.apply({"params": params}, jnp.asarray(x), method=JaxVAE.encode)
    mu, lv = tmodel.encode(torch.tensor(x))
    _close(mu, jmu)
    _close(lv, jlv)


@pytest.mark.parametrize("method", ["decode", "decode_probs"])
def test_decode_matches_jax(pair, method):
    jmodel, params, tmodel, _, eps = pair
    ref = jmodel.apply({"params": params}, jnp.asarray(eps), method=getattr(JaxVAE, method))
    _close(getattr(tmodel, method)(torch.tensor(eps)), ref)


def test_forward_with_injected_eps_matches_jax(pair):
    jmodel, params, tmodel, x, eps = pair

    def jax_forward(p, xb, e):
        mu, logvar = jmodel.apply({"params": p}, xb, method=JaxVAE.encode)
        z = mu + e * jnp.exp(0.5 * logvar)
        return jmodel.apply({"params": p}, z, method=JaxVAE.decode), mu, logvar

    refs = jax_forward(params, jnp.asarray(x), jnp.asarray(eps))
    for got, ref in zip(tmodel(torch.tensor(x), eps=torch.tensor(eps)), refs):
        _close(got, ref)


def test_reparameterize_draws_from_the_generator(pair):
    _, _, tmodel, x, _ = pair
    mu, lv = tmodel.encode(torch.tensor(x))
    a = tmodel.reparameterize(mu, lv, generator=torch.Generator().manual_seed(1))
    b = tmodel.reparameterize(mu, lv, generator=torch.Generator().manual_seed(1))
    c = tmodel.reparameterize(mu, lv, eps=torch.zeros_like(mu))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, mu)


def test_flax_round_trip(pair):
    _, params, tmodel, _, _ = pair
    back = vae_params_to_flax(vae_params_from_flax(params))
    for name in params:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[name][leaf], np.asarray(params[name][leaf]))
    again = vae_params_from_flax(vae_params_to_flax(tmodel.state_dict()))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(again[k], v)
    # a flax tree under "params" carries across too
    assert torch.equal(
        vae_params_from_flax({"params": params})["fc1.weight"], tmodel.fc1.weight.detach()
    )


def test_init_matches_flax_distribution():
    # Same distributions as flax's Dense defaults (not the same bits):
    # truncated LeCun-normal kernels, zero biases. At full width the
    # sample std of fc1 (313,600 draws) agrees within 2 %.
    jparams = jax.device_get(jax_init_vae_params(jax.random.key(0), JaxVAE())["params"])
    model = init_vae_params(VAE(), seed=0)
    for name in ("fc1", "fc4"):
        jstd = float(np.std(jparams[name]["kernel"]))
        tstd = float(getattr(model, name).weight.detach().std())
        assert tstd == pytest.approx(jstd, rel=0.02)
        assert float(getattr(model, name).bias.detach().abs().max()) == 0.0
    again = init_vae_params(VAE(), seed=0)
    assert torch.equal(again.fc1.weight, model.fc1.weight)


def test_bf16_compute_matches_jax(pair):
    # dtype=bfloat16 runs the matmuls in bf16 with f32 parameters, as
    # flax's Dense(dtype=bf16) does; bf16 storage precision (2e-2).
    _, params, _, x, _ = pair
    jmodel = JaxVAE(hidden_dim=HIDDEN, latent_dim=LATENT, dtype=jnp.bfloat16)
    tmodel = VAE(hidden_dim=HIDDEN, latent_dim=LATENT, dtype=torch.bfloat16)
    tmodel.load_state_dict(vae_params_from_flax(params))
    jmu, _ = jmodel.apply({"params": params}, jnp.asarray(x), method=JaxVAE.encode)
    mu, _ = tmodel.encode(torch.tensor(x))
    assert mu.dtype == torch.bfloat16
    np.testing.assert_allclose(
        mu.float().detach().numpy(), np.asarray(jmu, dtype=np.float32), rtol=2e-2, atol=2e-2
    )
