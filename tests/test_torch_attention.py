"""The port's flash attention against the JAX package's.

Inputs come from numpy with a seed. On the CPU the port runs the kernels'
plain versions (``flash_fwd_plain``, ``flash_bwd_plain``); the JAX side runs
its Pallas kernels in interpret mode, as ``tests/test_pallas_attention.py``
does. The CUDA kernels themselves are held against the plain versions on
the card by ``chip_smoke.py``.

Tolerances are the JAX tests' own for its kernels against the dense
reference (``test_pallas_attention.py``): o and lse at rtol 2e-5 / atol
2e-6, gradients at rtol 5e-5 / atol 5e-6 (f32 sums in another order and
blocking). bf16: within one bf16 ulp of the JAX value plus the f32 atol
(both round an f32 result once; the f32 results differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multidisttorch_tpu.ops.pallas_attention as jax_pa
from multidisttorch_tpu.ops.ring_attention import dense_attention_reference as jax_dense
from multidisttorch_tpu_torch.ops import attention as port_attn
from multidisttorch_tpu_torch.ops.attention import (
    flash_attention,
    flash_flat_lse,
    make_flash_attention,
)
from multidisttorch_tpu_torch.ops.ring_attention import dense_attention_reference

F32_FWD = dict(rtol=2e-5, atol=2e-6)
F32_BWD = dict(rtol=5e-5, atol=5e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # Small shapes gain nothing from intra-op threads; one thread keeps the
    # parallel test workers from oversubscribing the cores.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(n)]


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(v.astype(np.float32)), 2.0**-126))
    return np.ldexp(np.float32(1.0), e - 8)


def _flash_both(q, k, v, causal, cot):
    """Value and (q, k, v) gradients of ``sum(out * cot)`` for the JAX and
    the port's ``flash_attention`` on the same numpy inputs."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo, vjp = jax.vjp(lambda a, b, c: jax_pa.flash_attention(a, b, c, causal=causal), jq, jk, jv)
    jg = vjp(jnp.asarray(cot))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = flash_attention(tq, tk, tv, causal=causal)
    to.backward(torch.tensor(cot))
    return (np.asarray(jo), [np.asarray(g) for g in jg]), (to.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "b, t, h, d",
    [(2, 64, 2, 16), (1, 256, 1, 8), (1, 96, 2, 20)],
    ids=["single-block-T64", "multi-block-T256", "T96-D20"],
)
def test_flash_attention_value_and_grads_match_jax(b, t, h, d, causal):
    q, k, v, cot = _arrays((b, t, h, d), seed=t + d + causal, n=4)
    (jo, jg), (to, tg) = _flash_both(q, k, v, causal, cot)
    assert to.shape == (b, t, h, d)
    np.testing.assert_allclose(to, jo, **F32_FWD)
    for got, ref in zip(tg, jg):
        np.testing.assert_allclose(got, ref, **F32_BWD)


@pytest.mark.parametrize("causal", [False, True])
def test_flat_lse_and_its_cotangent_match_jax(causal):
    # (o, lse) over the flat layout, differentiated through both outputs:
    # the lse cotangent is the term the ring-flash hop combination needs.
    q, k, v, g_o = _arrays((3, 256, 8), seed=21 + causal, n=4)
    g_lse = np.random.default_rng(5).normal(0, 1, (3, 256)).astype(np.float32)
    scale = 1.0 / np.sqrt(8.0)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    (jo, jl), vjp = jax.vjp(lambda a, b, c: jax_pa._flash_flat_lse(a, b, c, scale, causal), jq, jk, jv)
    jg = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to, tl = flash_flat_lse(tq, tk, tv, scale, causal)
    assert tl.dtype == torch.float32 and tl.shape == (3, 256)
    torch.autograd.backward([to, tl], [torch.tensor(g_o), torch.tensor(g_lse)])
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **F32_FWD)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **F32_FWD)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_BWD)


def test_large_nondivisible_causal_pads_like_jax(monkeypatch):
    # T=200 above a shrunken whole-block limit takes the pad-to-128 path on
    # both sides (test_pallas_attention.py:87-111).
    monkeypatch.setattr(jax_pa, "_MAX_WHOLE_BLOCK", 64)
    monkeypatch.setattr(port_attn, "_MAX_WHOLE_BLOCK", 64)
    q, k, v, cot = _arrays((1, 200, 1, 8), seed=3, n=4)
    (jo, jg), (to, tg) = _flash_both(q, k, v, True, cot)
    assert to.shape == q.shape
    np.testing.assert_allclose(to, jo, **F32_FWD)
    for got, ref in zip(tg, jg):
        np.testing.assert_allclose(got, ref, **F32_BWD)


def test_large_nondivisible_noncausal_raises_like_jax(monkeypatch):
    monkeypatch.setattr(jax_pa, "_MAX_WHOLE_BLOCK", 64)
    monkeypatch.setattr(port_attn, "_MAX_WHOLE_BLOCK", 64)
    q, k, v = _arrays((1, 200, 1, 8), seed=4)
    with pytest.raises(ValueError, match="multiple of 128") as port_err:
        flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal=False)
    with pytest.raises(ValueError, match="multiple of 128") as jax_err:
        jax_pa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    assert str(port_err.value) == str(jax_err.value)


def test_bf16_matches_jax_within_one_ulp():
    q, k, v, cot = _arrays((2, 64, 2, 16), seed=7, n=4)
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    q, k, v, cot = (bf(a) for a in (q, k, v, cot))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jo, vjp = jax.vjp(lambda a, b, c: jax_pa.flash_attention(a, b, c, causal=True), jq, jk, jv)
    jg = vjp(jnp.asarray(cot).astype(jnp.bfloat16))

    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    to = flash_attention(tq, tk, tv, causal=True)
    assert to.dtype == torch.bfloat16
    to.backward(torch.tensor(cot).to(torch.bfloat16))
    for got, ref in [(to, jo)] + list(zip((tq.grad, tk.grad, tv.grad), jg)):
        assert got.dtype == torch.bfloat16
        ref32 = np.asarray(ref, dtype=np.float32)
        diff = np.abs(got.detach().float().numpy() - ref32)
        assert np.all(diff <= _bf16_ulp(ref32) + F32_BWD["atol"]), float(diff.max())


@pytest.mark.parametrize("causal", [False, True])
def test_dense_reference_matches_jax(causal):
    q, k, v = _arrays((2, 24, 2, 8), seed=11)
    ref = jax_dense(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = dense_attention_reference(*(torch.tensor(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_plain_versions_agree_with_the_dense_reference():
    # The plain forward and backward are attention and its gradient.
    q, k, v, cot = _arrays((1, 40, 2, 8), seed=13, n=4)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    dq, dk, dv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    flash_attention(tq, tk, tv, causal=True).backward(torch.tensor(cot))
    dense_attention_reference(dq, dk, dv, causal=True).backward(torch.tensor(cot))
    for a, b in ((tq, dq), (tk, dk), (tv, dv)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **F32_BWD)


def test_make_flash_attention_attributes():
    attn = make_flash_attention(causal=True)
    jattn = jax_pa.make_flash_attention(causal=True)
    assert (attn.head_sharded, attn.carries_collectives) == (jattn.head_sharded, jattn.carries_collectives) == (False, False)
    q, k, v = _arrays((1, 16, 2, 8), seed=1)
    got = attn(*(torch.tensor(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn(*(jnp.asarray(a) for a in (q, k, v)))), **F32_FWD)


def test_non_cpu_tensors_launch_the_kernel_or_raise():
    # A tensor that is not on the CPU never takes the plain version: on this
    # machine (no CUDA) the kernel path raises instead of falling back.
    before = dict(port_attn.LAUNCHES)
    meta = [torch.empty(1, 8, 2, 4, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(*meta, causal=True)
    cpu = [torch.zeros(2, 8, 4) for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn.flash_fwd_cuda(*cpu, 0.5, True)
    rows = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_attn.flash_bwd_cuda(*cpu, cpu[0], rows, rows, 0.5, True)
    assert port_attn.LAUNCHES == before


def test_head_dim_beyond_the_kernels_raises():
    wide = [torch.zeros(1, 8, 320) for _ in range(3)]
    with pytest.raises(ValueError, match="up to 256"):
        port_attn.flash_fwd_cuda(*wide, 0.1, True)


@pytest.mark.parametrize(
    "shapes, dtypes, match",
    [
        (((2, 8, 4), (2, 8, 4), (2, 9, 4)), (torch.float32,) * 3, "shape"),
        (((8, 4), (8, 4), (8, 4)), (torch.float32,) * 3, "shape"),
        (((2, 8, 4),) * 3, (torch.float32, torch.bfloat16, torch.float32), "dtype"),
    ],
)
def test_mis_shaped_operands_raise(shapes, dtypes, match):
    ops = [torch.zeros(s, dtype=dt) for s, dt in zip(shapes, dtypes)]
    with pytest.raises((ValueError, TypeError), match=match):
        flash_flat_lse(*ops, 0.5, True)
