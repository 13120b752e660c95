"""The port's TransformerLM slice against the JAX package's: corpora, the
model, the train/eval steps, the samplers and the example CLI.

Weights come from flax's init and are carried across with
``lm_params_from_flax``; tokens come from numpy with a seed. The JAX side
runs its flash kernels in interpret mode on the CPU, as its own tests do;
the port runs the kernels' plain versions. Every test states its tolerance:
f32 results differ from XLA's in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import multidisttorch_tpu.data.datasets as jax_data
from multidisttorch_tpu.models.transformer import TransformerLM as JaxLM
from multidisttorch_tpu.ops.pallas_attention import make_flash_attention as jax_make_flash
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import lm as jax_lm
from multidisttorch_tpu.train.lm_decode import make_cached_lm_sample as jax_cached_sample
from multidisttorch_tpu_torch.data import datasets as port_data
from multidisttorch_tpu_torch.models.transformer import (
    LayerNorm,
    TransformerLM,
    init_lm_params,
    lm_params_from_flax,
    lm_params_to_flax,
)
from multidisttorch_tpu_torch.ops import attention as port_attn
from multidisttorch_tpu_torch.ops.attention import make_flash_attention
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import lm as port_lm
from multidisttorch_tpu_torch.train.lm import (
    create_lm_state,
    lm_loss_mean,
    make_lm_eval_step,
    make_lm_multi_step,
    make_lm_sample,
    make_lm_train_step,
)
from multidisttorch_tpu_torch.train.lm_decode import make_cached_lm_sample

VOCAB, D, HEADS, LAYERS, T = 32, 64, 4, 2, 32
# f32 through a 2-layer stack, sums in another order than XLA's.
LOGITS_TOL = dict(rtol=1e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(flash: bool, **kw):
    return JaxLM(vocab_size=VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS, max_len=T,
                 attention=jax_make_flash(causal=True) if flash else None, **kw)


def _port_model(flash: bool, **kw):
    return TransformerLM(vocab_size=VOCAB, d_model=D, num_heads=HEADS, num_layers=LAYERS, max_len=T,
                         attention=make_flash_attention(causal=True) if flash else None, **kw)


def _flax_params(seed=0):
    return _jax_model(False).init(jax.random.key(seed), jnp.zeros((1, T), jnp.int32))["params"]


def _carried(params, flash: bool, **kw):
    model = _port_model(flash, **kw)
    model.load_state_dict(lm_params_from_flax(jax.device_get(params)))
    return model


def _tokens(b=2, t=T, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


# --- corpora ---------------------------------------------------------------


@pytest.mark.parametrize("n, vocab, period, seed", [(65536, 32, 16, 0), (1000, 32768, 16, 3), (517, 7, 5, 1)])
def test_synthetic_corpus_and_batches_match_jax(n, vocab, period, seed):
    a = port_data.synthetic_corpus(n, vocab_size=vocab, period=period, seed=seed)
    b = jax_data.synthetic_corpus(n, vocab_size=vocab, period=period, seed=seed)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.vocab_size, a.name, a.synthetic, len(a)) == (b.vocab_size, b.name, b.synthetic, len(b))
    got = a.batch(np.random.default_rng(9), 4, 64)
    ref = b.batch(np.random.default_rng(9), 4, 64)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_byte_corpus_matches_jax(tmp_path):
    path = tmp_path / "text.bin"
    path.write_bytes(bytes(range(256)) * 3 + b"tail")
    a, b = port_data.byte_corpus(str(path)), jax_data.byte_corpus(str(path))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.vocab_size, a.name) == (b.vocab_size, b.name) == (256, "text.bin")
    with pytest.raises(ValueError, match="cannot fill"):
        a.batch(np.random.default_rng(0), 1, len(a) + 1)


# --- the model -------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_logits_loss_and_grads_match_flax(flash):
    params = _flax_params()
    tokens = _tokens()
    jmodel = _jax_model(flash)

    def jloss(p):
        return jax_lm.lm_loss_mean(jmodel.apply({"params": p}, jnp.asarray(tokens)), jnp.asarray(tokens))

    jlogits = jmodel.apply({"params": params}, jnp.asarray(tokens))
    jval, jgrads = jax.value_and_grad(jloss)(params)

    model = _carried(params, flash)
    logits = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and logits.shape == (2, T, VOCAB)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **LOGITS_TOL)
    loss = lm_loss_mean(logits, torch.from_numpy(tokens))
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    loss.backward()
    ref = lm_params_from_flax(jax.device_get(jgrads))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    for name, g in ref.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(), err_msg=name, **GRAD_TOL)


def test_remat_gives_the_same_gradients():
    params = _flax_params(1)
    tokens = torch.from_numpy(_tokens(seed=1))
    grads = []
    for remat in (False, True):
        model = _carried(params, True, remat=remat)
        lm_loss_mean(model(tokens), tokens).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0, msg=k)


def test_remat_recomputes_the_flash_forward():
    model = _port_model(True, remat=True)
    init_lm_params(model, 0)
    tokens = torch.from_numpy(_tokens())
    calls = []
    orig = port_attn.FlashFlatLse.forward

    def counting(ctx, *a):
        calls.append(1)
        return orig(ctx, *a)

    port_attn.FlashFlatLse.forward = staticmethod(counting)
    try:
        lm_loss_mean(model(tokens), tokens).backward()
    finally:
        port_attn.FlashFlatLse.forward = staticmethod(orig)
    assert len(calls) == 2 * LAYERS  # forward, then once more per block in the backward


def test_bf16_compute_matches_flax():
    # Under bf16, flax casts Dense inputs, kernels and biases and the
    # embeddings to bf16; LayerNorm keeps f32 statistics and rounds once;
    # the head stays f32. bf16 rounds at other places in the two
    # frameworks (XLA's elementwise bf16 ops against torch's f32-internal
    # ones), so the tolerance is four bf16 ulps at the logits' size (up to
    # about 4, where one ulp is 1.6e-2).
    params = _flax_params(2)
    tokens = _tokens(seed=2)
    jlogits = _jax_model(False, dtype=jnp.bfloat16).apply({"params": params}, jnp.asarray(tokens))
    model = _carried(params, False, dtype=torch.bfloat16)
    logits = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=6e-2)


@pytest.mark.parametrize("dtype, jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_layernorm_is_flax_eps_and_cast(dtype, jdtype):
    # A small-variance input, where eps 1e-6 (flax) and 1e-5 (torch's
    # default) differ by far more than the tolerance.
    import flax.linen as fnn

    x = np.random.default_rng(4).normal(0, 3e-3, (3, 16)).astype(np.float32)
    ln = fnn.LayerNorm(dtype=jdtype, param_dtype=jnp.float32)
    p = ln.init(jax.random.key(0), jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: a + 0.25, p)
    ref = ln.apply(p, jnp.asarray(x).astype(jdtype))
    port = LayerNorm(16, dtype)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p["params"].items()})
    got = port(torch.tensor(x).to(dtype))
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 8e-3  # bf16: one rounding of the same f32 value
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)
    torch_default = torch.nn.functional.layer_norm(torch.tensor(x), (16,)) * 1.25 + 0.25
    assert not np.allclose(torch_default.numpy(), np.asarray(ref, np.float32), atol=1e-2)


def test_overlong_sequence_raises_like_flax():
    model = _port_model(False)
    with pytest.raises(ValueError, match="exceeds max_len"):
        model(torch.zeros(1, T + 1, dtype=torch.int64))
    with pytest.raises(ValueError, match="exceeds max_len"):
        _jax_model(False).init(jax.random.key(0), jnp.zeros((1, T + 1), jnp.int32))


def test_params_roundtrip_and_names_match_flax():
    params = jax.device_get(_flax_params())
    sd = lm_params_from_flax({"params": params})
    model = _port_model(False)
    assert set(sd) == set(model.state_dict())
    back = lm_params_to_flax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))


def test_init_distributions_match_flax():
    # Same distributions, not the same bits (ROADMAP C.8): stds within 3 %
    # at widths where a std estimate is that tight.
    v, d = 2048, 128
    jm = JaxLM(vocab_size=v, d_model=d, num_heads=4, num_layers=1, max_len=512)
    jp = jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"])
    pm = init_lm_params(TransformerLM(vocab_size=v, d_model=d, num_heads=4, num_layers=1, max_len=512), 7)
    port = {k: p.detach() for k, p in pm.named_parameters()}
    ref = lm_params_from_flax(jp)
    for name in ("tok_embed.embedding", "pos_embed.embedding", "block_0.q.kernel",
                 "block_0.up.kernel", "block_0.down.kernel", "head.kernel"):
        a, b = float(port[name].std()), float(ref[name].std())
        assert a == pytest.approx(b, rel=0.03), name
        assert float(port[name].abs().max()) <= float(ref[name].abs().max()) * 1.5 or "embed" in name
    for name in ("block_0.q.bias", "block_0.ln_attn.bias", "ln_out.bias"):
        assert float(port[name].abs().max()) == 0.0
    assert bool(torch.all(port["block_0.ln_mlp.scale"] == 1.0))
    again = init_lm_params(TransformerLM(vocab_size=v, d_model=d, num_heads=4, num_layers=1, max_len=512), 7)
    assert torch.equal(again.head.kernel, pm.head.kernel)


# --- train and eval steps ---------------------------------------------------


def _jax_state(jmodel, params, lr):
    from multidisttorch_tpu.train.steps import TrainState as JaxTrainState

    tx = optax.adam(lr)
    return JaxTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32)), tx


def test_multi_step_losses_match_jax():
    k_steps, lr = 4, 3e-3
    params = _flax_params(3)
    chunks = np.stack([_tokens(seed=10 + i) for i in range(k_steps)])
    group = setup_groups(1, devices=["cpu"])[0]
    state = create_lm_state(group, _carried(params, True), lr)
    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    jmodel = _jax_model(True)
    jstate, tx = _jax_state(jmodel, params, lr)
    # (the JAX step donates its state, params included)
    jstate, jm = jax_lm.make_lm_multi_step(jtrial, jmodel, tx)(jstate, jnp.asarray(chunks))
    state, m = make_lm_multi_step(group)(state, torch.from_numpy(chunks))
    assert m["loss"].shape == (k_steps,) and state.step == k_steps
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
    # The parameters after K Adam steps: Adam normalises each update, so
    # f32 gradient noise moves a weight by up to ~lr where its gradient is
    # near zero; hold them at 0.1 lr.
    # The key bias is left out: its true gradient is zero (q . b_k is the
    # same for every key, and softmax ignores a per-row constant), so both
    # frameworks' Adam steps follow the sign of rounding noise.
    ref = lm_params_from_flax(jax.device_get(jstate.params))
    for name, p in state.model.named_parameters():
        if name.endswith(".k.bias"):
            continue
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=0.1 * lr, err_msg=name)


def test_train_step_matches_multi_step_and_eval_matches_the_objective():
    params = _flax_params(4)
    chunks = np.stack([_tokens(seed=20 + i) for i in range(2)])
    group = setup_groups(1, devices=["cpu"])[0]
    s1 = create_lm_state(group, _carried(params, True), 1e-3)
    ev = make_lm_eval_step(group)(s1, torch.from_numpy(chunks[0]))
    step = make_lm_train_step(group)
    s1, m0 = step(s1, torch.from_numpy(chunks[0]))
    s1, m1 = step(s1, torch.from_numpy(chunks[1]))
    s2 = create_lm_state(group, _carried(params, True), 1e-3)
    s2, mm = make_lm_multi_step(group)(s2, torch.from_numpy(chunks))
    assert torch.equal(torch.stack([m0["loss"], m1["loss"]]), mm["loss"])
    # eval is the train objective without the update
    assert torch.equal(ev["loss"], m0["loss"])
    assert float(ev["perplexity"]) == pytest.approx(float(np.exp(float(ev["loss"]))), rel=1e-6)

    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    jmodel = _jax_model(True)
    jstate, _ = _jax_state(jmodel, params, 1e-3)
    jev = jax_lm.make_lm_eval_step(jtrial, jmodel)(jstate, jnp.asarray(chunks[0]))
    assert float(ev["loss"]) == pytest.approx(float(jev["loss"]), rel=1e-5)
    assert float(ev["perplexity"]) == pytest.approx(float(jev["perplexity"]), rel=1e-5)


def test_sequence_parallel_is_not_ported_yet():
    group = setup_groups(1, devices=["cpu"])[0]
    for factory in (make_lm_train_step, make_lm_multi_step, make_lm_eval_step):
        with pytest.raises(NotImplementedError, match="ROADMAP A.15a"):
            factory(group, sequence_parallel=True)


def test_loss_masks_the_last_position_like_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (3, 9, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, (3, 9)).astype(np.int32)
    ref = jax_lm.lm_loss_mean(jnp.asarray(logits), jnp.asarray(tokens))
    got = lm_loss_mean(torch.tensor(logits), torch.tensor(tokens))
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    # the last position's logits never reach the loss
    logits[:, -1] += 100.0
    assert float(lm_loss_mean(torch.tensor(logits), torch.tensor(tokens))) == pytest.approx(float(got), rel=1e-6)


# --- samplers --------------------------------------------------------------


def _trained_pair(steps=15):
    """A briefly trained port state and the same weights as a JAX state:
    trained weights give the greedy decode clear margins."""
    params = _flax_params(5)
    corpus = port_data.synthetic_corpus(4096, vocab_size=VOCAB, period=16)
    group = setup_groups(1, devices=["cpu"])[0]
    state = create_lm_state(group, _carried(params, False), 3e-3)
    step = make_lm_train_step(group)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        state, _ = step(state, torch.from_numpy(corpus.batch(rng, 4, T)))
    from multidisttorch_tpu.train.steps import TrainState as JaxTrainState

    jparams = jax.tree_util.tree_map(jnp.asarray, lm_params_to_flax(state.model.state_dict()))
    return group, state, JaxTrainState(params=jparams, opt_state=None, step=0), corpus


@pytest.mark.parametrize("prompt_len", [0, 1, 12])
def test_cached_greedy_decode_matches_jax_and_the_full_recompute_sampler(prompt_len):
    group, state, jstate, corpus = _trained_pair()
    buf = corpus.batch(np.random.default_rng(1), 2, T)
    buf[1, 5:] = np.random.default_rng(2).integers(0, VOCAB, T - 5)  # one row off the pattern
    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    jmodel = _jax_model(True)
    ref = np.asarray(jax_cached_sample(jtrial, jmodel)(jstate, jnp.asarray(buf), prompt_len, jax.random.key(0)))

    model = _port_model(True)  # the prefill's attention: the flash callable
    got = make_cached_lm_sample(group, model)(state, torch.from_numpy(buf), prompt_len)
    full = make_lm_sample(group, model)(state, torch.from_numpy(buf), prompt_len)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(full.numpy(), ref)
    start = max(prompt_len, 1)
    np.testing.assert_array_equal(got.numpy()[:, :start], buf[:, :start])


def test_cached_sampled_decode_matches_the_full_recompute_sampler():
    # Sampling draws from a torch generator (not JAX's stream): the two
    # port samplers make the same draws on the same logits.
    group, state, _, corpus = _trained_pair()
    buf = torch.from_numpy(corpus.batch(np.random.default_rng(3), 2, T))
    model = _port_model(False)
    kw = dict(temperature=0.8, top_k=8, top_p=0.9)
    a = make_cached_lm_sample(group, model, **kw)(state, buf, 4, torch.Generator().manual_seed(1))
    b = make_lm_sample(group, model, **kw)(state, buf, 4, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize(
    "top_k, top_p",
    [(None, None), (1, None), (3, None), (None, 0.5), (None, 1.0), (4, 0.6), (32, 0.999)],
)
def test_filter_logits_matches_jax_with_ties(top_k, top_p):
    rng = np.random.default_rng(8)
    logits = np.concatenate([
        rng.normal(0, 1, (2, 32)),
        np.zeros((1, 32)),  # all tied
        rng.integers(0, 3, (2, 32)),  # heavy ties
    ]).astype(np.float32)
    ref = np.asarray(jax_lm._filter_logits(jnp.asarray(logits), top_k, top_p))
    got = port_lm._filter_logits(torch.tensor(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_array_equal(got[~np.isneginf(got)], ref[~np.isneginf(ref)])


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(top_k=0), "top_k"),
        (dict(temperature=1.0, top_k=VOCAB + 1), "exceeds"),
        (dict(temperature=1.0, top_p=0.0), "top_p"),
        (dict(temperature=1.0, top_p=1.5), "top_p"),
        (dict(temperature=0.0, top_k=3), "temperature > 0"),
        (dict(temperature=0.0, top_p=0.9), "temperature > 0"),
    ],
)
def test_sampler_refusals_match_jax(kw, match):
    group = setup_groups(1, devices=["cpu"])[0]
    jtrial = jax_setup_groups(1, devices=jax.devices()[:1])[0]
    for port_factory, jax_factory in ((make_lm_sample, jax_lm.make_lm_sample),
                                      (make_cached_lm_sample, jax_cached_sample)):
        with pytest.raises(ValueError, match=match):
            port_factory(group, _port_model(False), **kw)
        with pytest.raises(ValueError, match=match):
            jax_factory(jtrial, _jax_model(False), **kw)


def test_cached_sampler_refuses_bf16_moe_and_overlong_buffers():
    group = setup_groups(1, devices=["cpu"])[0]
    with pytest.raises(ValueError, match="float32"):
        make_cached_lm_sample(group, _port_model(False, dtype=torch.bfloat16))
    moe = _port_model(False)
    moe.num_experts = 4
    with pytest.raises(ValueError, match="dense-block"):
        make_cached_lm_sample(group, moe)
    model = init_lm_params(_port_model(False), 0)
    state = create_lm_state(group, model, 1e-3)
    with pytest.raises(ValueError, match="exceeds max_len"):
        make_cached_lm_sample(group, model)(state, torch.zeros(1, T + 1, dtype=torch.int64), 1)


# --- the example -----------------------------------------------------------


def test_example_cli_flash_runs_on_cpu(capsys):
    from multidisttorch_tpu_torch.examples import lm_long_context

    loss, match = lm_long_context.main(
        ["--flash", "--device", "cpu", "--seq-len", "64", "--steps", "30", "--batch-size", "4"]
    )
    out = capsys.readouterr().out
    assert "step   29" in out and "greedy decode matches" in out
    assert loss < np.log(32) and 0.0 <= match <= 1.0


@pytest.mark.parametrize("argv, item", [([], "A.15a"), (["--ring-flash"], "A.15b")])
def test_example_cli_ring_modes_are_not_ported_yet(argv, item):
    from multidisttorch_tpu_torch.examples import lm_long_context

    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        lm_long_context.main(argv + ["--device", "cpu"])
