"""The port's fused ELBO loss against the JAX package's.

Inputs come from numpy with a seed. On the CPU the port's
``fused_elbo_loss_sum`` runs its plain version; the JAX side runs the Pallas
kernel in interpret mode, as ``tests/test_pallas_elbo.py`` does. The CUDA
kernels themselves are held against the plain version on the card by
``chip_smoke.py``.

Tolerances: rel 1e-5 on the value and rtol 1e-5 / atol 1e-6 on f32
gradients, the JAX package's own for its kernel against its plain loss
(f32 sums taken in another order). bf16 gradients within one bf16 ulp: the
JAX backward rounds ``sigmoid(l) - x`` to bf16 before scaling by the
cotangent and rounds again, the port scales first and rounds once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multidisttorch_tpu.ops import pallas_elbo
from multidisttorch_tpu.ops.losses import elbo_loss_sum as jax_elbo_loss_sum
from multidisttorch_tpu.ops.pallas_elbo import fused_elbo_loss_sum as jax_fused
from multidisttorch_tpu_torch.ops import elbo as port_elbo
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum
from multidisttorch_tpu_torch.ops.losses import elbo_loss_sum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(batch: int, seed: int, d: int = 784, lat: int = 20):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 2, (batch, d)).astype(np.float32),
        rng.uniform(0, 1, (batch, d)).astype(np.float32),
        rng.normal(0, 1, (batch, lat)).astype(np.float32),
        rng.normal(0, 0.5, (batch, lat)).astype(np.float32),
    )


def _torch_grads(fn, logits, x, mu, logvar, beta, scale=1.0):
    """Value and grads of ``scale * fn(...)`` w.r.t. logits, x, mu, logvar."""
    ts = [torch.tensor(a, requires_grad=True) for a in (logits, x, mu, logvar)]
    value = fn(*ts, beta) * scale
    value.backward()
    return float(value.detach()), [t.grad for t in ts]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(v.astype(np.float32)), 2.0**-126))
    return np.ldexp(np.float32(1.0), e - 8)


@pytest.mark.parametrize("beta", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("batch", [16, 96])
def test_value_and_grads_match_jax(batch, beta, monkeypatch):
    if batch == 96:
        # The JAX kernel's multi-block grid (test_pallas_elbo.py:52-80).
        monkeypatch.setattr(pallas_elbo, "_VMEM_BUDGET_BYTES", 64 * 1024)
    logits, x, mu, logvar = _arrays(batch, seed=batch + int(beta))
    j = tuple(jnp.asarray(a) for a in (logits, x, mu, logvar))
    if batch == 96:
        assert pallas_elbo._block_rows(*j) < batch

    for jax_fn, port_fn in (
        (jax_fused, fused_elbo_loss_sum),
        (jax_elbo_loss_sum, elbo_loss_sum),
    ):
        jv, jg = jax.value_and_grad(
            lambda l, xx, m, lv: jax_fn(l, xx, m, lv, beta), argnums=(0, 1, 2, 3)
        )(*j)
        tv, tg = _torch_grads(port_fn, logits, x, mu, logvar, beta)
        assert tv == pytest.approx(float(jv), rel=1e-5)
        for got, ref in zip(tg, jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_fused_matches_plain_loss_in_port():
    logits, x, mu, logvar = _arrays(32, seed=3)
    fv, fg = _torch_grads(fused_elbo_loss_sum, logits, x, mu, logvar, 2.0)
    pv, pg = _torch_grads(elbo_loss_sum, logits, x, mu, logvar, 2.0)
    assert fv == pytest.approx(pv, rel=1e-5)
    for a, b in zip(fg, pg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_activations_with_f32_targets_match_jax():
    # The mixed case the JAX package's TPU train path feeds: bf16 logits,
    # mu and logvar, f32 x. Math is f32; cotangents come back in bf16.
    logits, x, mu, logvar = _arrays(16, seed=11)
    jl, jm, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (logits, mu, logvar))
    jx = jnp.asarray(x)
    scale = 1.0 / 16  # the per-sample mean's cotangent, exact in bf16
    jval, jgrads = jax.value_and_grad(
        lambda l, m, lv: jax_fused(l, jx, m, lv, 1.0) * scale, argnums=(0, 1, 2)
    )(jl, jm, jv)

    tl, tm, tv = (
        torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in (logits, mu, logvar)
    )
    value = fused_elbo_loss_sum(tl, torch.tensor(x), tm, tv, 1.0) * scale
    value.backward()
    assert value.dtype == torch.float32
    assert float(value) == pytest.approx(float(jval), rel=1e-5)
    for got, ref, primal in zip((tl.grad, tm.grad, tv.grad), jgrads, (tl, tm, tv)):
        assert got.dtype == primal.dtype == torch.bfloat16
        ref32 = np.asarray(ref, dtype=np.float32)
        diff = np.abs(got.float().numpy() - ref32)
        assert np.all(diff <= _bf16_ulp(ref32)), float(diff.max())


def test_plain_versions_are_the_kernels_function():
    # The plain forward and backward the CPU path runs, against the loss
    # they fuse: the backward is the loss's gradient scaled by g.
    logits, x, mu, logvar = _arrays(8, seed=5, d=30, lat=6)
    t = [torch.tensor(a) for a in (logits, x, mu, logvar)]
    v = port_elbo.elbo_fwd_plain(*t, 3.0)
    assert v.dtype == torch.float32 and v.dim() == 0
    assert float(v) == pytest.approx(float(elbo_loss_sum(*t, 3.0)), rel=1e-5)
    g = torch.tensor(0.25)
    _, ref = _torch_grads(elbo_loss_sum, logits, x, mu, logvar, 3.0, scale=0.25)
    got = port_elbo.elbo_bwd_plain(*t, 3.0, g)
    for a, b in zip(got, (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_x_gradient_only_when_asked():
    logits, x, mu, logvar = _arrays(4, seed=9, d=12, lat=3)
    tl = torch.tensor(logits, requires_grad=True)
    tx = torch.tensor(x)  # data: no gradient asked
    fused_elbo_loss_sum(tl, tx, torch.tensor(mu), torch.tensor(logvar)).backward()
    assert tx.grad is None and tl.grad is not None


def test_non_cpu_tensors_launch_the_kernel_or_raise():
    # A tensor that is not on the CPU never takes the plain version: on this
    # machine (no CUDA) the kernel path raises instead of falling back.
    before = dict(port_elbo.LAUNCHES)
    meta = [torch.empty(4, 8, device="meta"), torch.empty(4, 8, device="meta"),
            torch.empty(4, 2, device="meta"), torch.empty(4, 2, device="meta")]
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_elbo_loss_sum(*meta)
    cpu = [torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(4, 2), torch.zeros(4, 2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_elbo.elbo_fwd_cuda(*cpu, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_elbo.elbo_bwd_cuda(*cpu, 1.0, torch.tensor(1.0))
    assert port_elbo.LAUNCHES == before


@pytest.mark.parametrize(
    "bad, match",
    [
        ((torch.zeros(4, 8), torch.zeros(4, 7), torch.zeros(4, 2), torch.zeros(4, 2)), "shape"),
        ((torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(3, 2), torch.zeros(3, 2)), "shape"),
        ((torch.zeros(8), torch.zeros(8), torch.zeros(2), torch.zeros(2)), "2-D"),
    ],
)
def test_mis_shaped_operands_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        fused_elbo_loss_sum(*bad)
