"""int8 weight-only quantization (``train/lm_quant.py``) against the JAX
package's: the same int8 bits and scales on the same weights, the
reconstruction bound, the structural contract, and decode accuracy on a
trained model.

Tolerances: ``q`` bit-equal; ``scale`` rel 1e-7 (f32 ``amax / 127``, one
rounding in both); the dequantized kernel within half a scale of the f32
one; int8 greedy decode agrees with f32 on at least 95 % of generated
tokens (the JAX package's bound), and with the JAX package's int8 decode on
the same weights token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multidisttorch_tpu.models.transformer import TransformerLM as JaxLM
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train.lm_decode import make_cached_lm_sample as jax_cached_sample
from multidisttorch_tpu.train.lm_quant import dequantize_lm_params as jax_dequantize
from multidisttorch_tpu.train.lm_quant import quantize_lm_params as jax_quantize
from multidisttorch_tpu.train.steps import TrainState as JaxTrainState
from multidisttorch_tpu_torch.data.datasets import synthetic_corpus
from multidisttorch_tpu_torch.models.transformer import (
    Dense,
    Embed,
    LayerNorm,
    TransformerLM,
    init_lm_params,
    lm_params_from_flax,
    lm_params_to_flax,
)
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.lm import create_lm_state, make_lm_sample, make_lm_train_step
from multidisttorch_tpu_torch.train.lm_decode import make_cached_lm_sample
from multidisttorch_tpu_torch.train.lm_quant import QuantDense, dequantize_lm_params, quantize_lm_params
from multidisttorch_tpu_torch.train.steps import TrainState

DENSE_NAMES = ("q", "k", "v", "proj", "up", "down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _OneLayer(nn.Module):
    def __init__(self, w: np.ndarray):
        super().__init__()
        self.layer = Dense(*w.shape)
        with torch.no_grad():
            self.layer.kernel.copy_(torch.from_numpy(w))


def _assert_same_quantization(got: dict, want: dict, path: str = "") -> None:
    """``got`` (the port's tree) has ``want``'s (the JAX tree's) leaves: int8
    bits equal, scales rel 1e-7, everything else equal."""
    assert set(got) == set(want), path
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_same_quantization(got[key], w, f"{path}/{key}")
            continue
        w = np.asarray(w)
        assert got[key].dtype == w.dtype, f"{path}/{key}"
        if key == "scale":
            np.testing.assert_allclose(got[key], w, rtol=1e-7, atol=0, err_msg=f"{path}/{key}")
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=f"{path}/{key}")


@pytest.mark.parametrize("seed, zero_column", [(0, False), (1, True)])
def test_quantize_roundtrip_error_bound(seed, zero_column):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, (64, 32)).astype(np.float32)
    if zero_column:
        w[:, 5] = 0.0  # scale 1, q 0
    q = quantize_lm_params(_OneLayer(w))
    assert isinstance(q.layer, QuantDense) and q.layer.q.dtype == torch.int8
    assert q.layer.scale.shape == (32,) and not hasattr(q.layer, "kernel")
    deq = dequantize_lm_params(q)
    assert isinstance(deq.layer, Dense)
    # symmetric rounding: per-element error <= scale/2 of its column
    err = np.abs(deq.layer.kernel.detach().numpy() - w)
    assert (err <= q.layer.scale.numpy()[None, :] / 2 + 1e-8).all()
    # the JAX package's bits on the same kernel
    ref = jax_quantize({"layer": {"kernel": jnp.asarray(w), "bias": jnp.zeros((32,))}})
    _assert_same_quantization(lm_params_to_flax(q.state_dict()), jax.device_get(ref))
    np.testing.assert_array_equal(deq.layer.kernel.detach().numpy(),
                                  np.asarray(jax_dequantize(ref)["layer"]["kernel"]))


def test_quantize_leaves_non_kernels_alone():
    params = JaxLM(vocab_size=32, d_model=32, num_heads=4, num_layers=1, max_len=16).init(
        jax.random.key(0), jnp.zeros((1, 16), jnp.int32))["params"]
    model = TransformerLM(vocab_size=32, d_model=32, num_heads=4, num_layers=1, max_len=16)
    model.load_state_dict(lm_params_from_flax(jax.device_get(params)))
    q = quantize_lm_params(model)
    # embeddings + norms untouched, every dense kernel rewritten
    assert isinstance(q.tok_embed, Embed) and q.tok_embed.embedding.dtype == torch.float32
    assert isinstance(q.ln_out, LayerNorm) and q.ln_out.scale.dtype == torch.float32
    for name in DENSE_NAMES:
        assert getattr(q.block_0, name).q.dtype == torch.int8
    assert q.head.q.dtype == torch.int8 and q.head.bias.dtype == torch.float32
    assert torch.equal(q.tok_embed.embedding, model.tok_embed.embedding)
    # the model itself is not changed
    assert isinstance(model.head, Dense)
    _assert_same_quantization(lm_params_to_flax(q.state_dict()), jax.device_get(jax_quantize(params)))


@pytest.fixture(scope="module")
def trained():
    """The JAX test's model trained 300 steps by the port."""
    g = setup_groups(1, devices=["cpu"])[0]
    t = 32
    corpus = synthetic_corpus(n=4096, vocab_size=16)
    model = TransformerLM(vocab_size=16, d_model=32, num_heads=2, num_layers=2, max_len=t)
    state = create_lm_state(g, init_lm_params(model, 0), 5e-3)
    step = make_lm_train_step(g)
    rng = np.random.default_rng(0)
    for _ in range(300):
        state, _ = step(state, torch.from_numpy(corpus.batch(rng, 8, t)))
    buf = torch.from_numpy(corpus.batch(np.random.default_rng(42), 8, t))
    return g, model, state, buf


def test_quantized_decode_agrees_with_f32(trained):
    g, model, state, buf = trained
    sample = make_cached_lm_sample(g, model)
    out_f32 = sample(state, buf, 16).numpy()
    qstate = TrainState(model=quantize_lm_params(state.model), optimizer=None)
    out_q = sample(qstate, buf, 16).numpy()
    agreement = (out_q == out_f32).mean()
    assert agreement >= 0.95, agreement
    assert out_q.min() >= 0 and out_q.max() < 16
    # the quantized model's own forward (the full-recompute sampler) decodes alike
    np.testing.assert_array_equal(make_lm_sample(g, model)(qstate, buf, 16).numpy(), out_q)


def test_quantized_decode_matches_jax_on_the_same_weights(trained):
    _, model, state, buf = trained
    qstate = TrainState(model=quantize_lm_params(state.model), optimizer=None)
    got = make_cached_lm_sample(setup_groups(1, devices=["cpu"])[0], model)(qstate, buf, 16).numpy()
    jparams = jax.tree_util.tree_map(jnp.asarray, lm_params_to_flax(state.model.state_dict()))
    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    jmodel = JaxLM(vocab_size=16, d_model=32, num_heads=2, num_layers=2, max_len=32)
    jstate = JaxTrainState(params=jax_quantize(jparams), opt_state=None, step=0)
    ref = np.asarray(jax_cached_sample(jtrial, jmodel)(jstate, jnp.asarray(buf.numpy()), 16, jax.random.key(1)))
    np.testing.assert_array_equal(got, ref)
