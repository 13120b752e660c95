"""The port's ResNet and classifier steps (``models/resnet.py``,
``train/classifier.py``, ``ops/losses.py::softmax_cross_entropy_mean``)
against the JAX package's, the labelled data feed, and the ``resnet_hpo``
example.

The JAX weights are carried across with ``resnet_params_from_flax``; the
classifier has no noise, so the JAX package's own step builders are the
reference. Tolerances in f32: logits and losses rtol/atol 1e-5 (GroupNorm
statistics and conv sums in another order); a step's gradients rtol 1e-4
with atol 1e-5 of the tensor's largest gradient; the parameters after one
Adam step rtol 1e-4 / atol 1e-6 (the VAE's) plus what the gradient's
difference moves Adam's first update by, ``lr·|Δg|/(|g| + eps)``: the
update is ``lr·g/(|g| + eps)``, so a gradient near zero turns a rounding
difference into a visible step; accuracies and correct counts exact.
``Δg`` is taken against the gradient the JAX step itself applied (read
through a transform that keeps it, ``_jax_step_grads``): XLA's program
for the step and a separate ``jax.grad`` round a gradient near zero
differently (on an AVX-512 host, 1.027e-8 against 9.108e-9 in
``BasicBlock_7.Conv_0.weight``, 8.96e-6 of the tensor's largest
gradient), and only the first moved the JAX parameters.
Labelled batches and chunks are the JAX package's bytes for the same seed.
A two-process gloo group, each rank holding half the batch, must give the
JAX package's whole-batch step.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multidisttorch_tpu.data.datasets import synthetic_cifar10 as jax_synthetic_cifar10
from multidisttorch_tpu.data.sampler import TrialDataIterator as JaxTrialDataIterator
from multidisttorch_tpu.models.resnet import ResNet18 as JaxResNet18
from multidisttorch_tpu.ops.losses import softmax_cross_entropy_mean as jax_xent
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import classifier as jax_cls
from multidisttorch_tpu_torch.data.datasets import synthetic_cifar10
from multidisttorch_tpu_torch.data.sampler import TrialDataIterator
from multidisttorch_tpu_torch.models import ResNet18, resnet_params_from_flax, resnet_params_to_flax
from multidisttorch_tpu_torch.ops.losses import softmax_cross_entropy_mean
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, setup_groups
from multidisttorch_tpu_torch.train.classifier import (
    create_classifier_state,
    make_classifier_eval_step,
    make_classifier_multi_step,
    make_classifier_train_step,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(num_classes=10, base_channels=8, image_hw=16)  # rows of 16*16*3 = 768
LR = 1e-3
ROWS = 8


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxResNet18(**SMALL)
    (trial,) = jax_setup_groups(1, devices=jax.devices()[:1])
    jstate = jax_cls.create_classifier_state(trial, jmodel, optax.adam(LR), jax.random.key(0))
    params = jax.device_get(jstate.params)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (ROWS, 768)).astype(np.float32)
    y = rng.integers(0, 10, ROWS).astype(np.int32)
    return jmodel, trial, jstate, params, x, y


def _port_state(params, lr=LR, group=None):
    model = ResNet18(**SMALL)
    model.load_state_dict(model.params_from_flax(params))
    return create_classifier_state(group or setup_groups(1, devices=["cpu"])[0], model, lr)


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _jax_grads(jmodel, params, x, y):
    """The whole batch's gradient of the mean cross-entropy, as a torch
    state dict."""
    g = jax.grad(lambda p: jax_xent(jmodel.apply({"params": p}, x), y))(params)
    return resnet_params_from_flax(jax.device_get(g))


def _jax_step_grads(jmodel, trial, x, y, grad_accum=1):
    """The gradient JAX's train step applies, as a torch state dict: the
    same step builder with a transform that keeps the gradient as its
    state and leaves the parameters where they are."""
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))
    js = jax_cls.create_classifier_state(trial, jmodel, keep, jax.random.key(0))
    js, _ = jax_cls.make_classifier_train_step(trial, jmodel, keep, grad_accum=grad_accum)(js, x, y)
    return resnet_params_from_flax(jax.device_get(js.opt_state))


def _assert_step_close(params, grads, jparams, jgrads, jstep_grads):
    """A step's gradients and updated parameters against JAX's (module
    docstring)."""
    for k, ref in resnet_params_from_flax(jparams).items():
        g, jg, sg = _np(grads[k]), jgrads[k].numpy(), jstep_grads[k].numpy()
        np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-5 * float(np.abs(jg).max()), err_msg=f"grad {k}")
        slack = LR * np.abs(g - sg) / (np.abs(sg) + 1e-8)
        diff = np.abs(_np(params[k]) - ref.numpy())
        assert np.all(diff <= 1e-6 + 1e-4 * np.abs(ref.numpy()) + slack), (k, float(diff.max()))


def _grads(state) -> dict:
    return {k: p.grad for k, p in state.model.named_parameters()}


# --- loss, model, parameters ----------------------------------------------------


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(32, 10)) * 4).astype(np.float32)
    labels = rng.integers(0, 10, 32).astype(np.int32)
    ref = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = softmax_cross_entropy_mean(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and float(got) == pytest.approx(ref, rel=1e-6)
    # bf16 logits: the log-softmax runs in f32.
    got16 = softmax_cross_entropy_mean(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got16.dtype == torch.float32


def test_resnet_logits_match_flax(setup):
    jmodel, _, _, params, x, _ = setup
    ref = jmodel.apply({"params": params}, x)
    model = ResNet18(**SMALL)
    model.load_state_dict(model.params_from_flax(params))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (ROWS, 10)
    _close(got, ref)
    _close(model(torch.from_numpy(x).reshape(ROWS, 16, 16, 3)), ref)  # image-shaped rows alike


def test_bf16_logits_match_flax(setup):
    # dtype=bfloat16: convs in bf16 with f32 parameters, GroupNorm's
    # statistics in f32, the head in f32, as flax's; bf16 storage precision
    # (2e-2), as the VAE's.
    _, _, _, params, x, _ = setup
    ref = JaxResNet18(**SMALL, dtype=jnp.bfloat16).apply({"params": params}, x)
    model = ResNet18(**SMALL, dtype=torch.bfloat16)
    model.load_state_dict(model.params_from_flax(params))
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, rtol=2e-2, atol=2e-2)
    full = ResNet18(**SMALL)
    full.load_state_dict(model.state_dict())
    assert not torch.equal(got, full(torch.from_numpy(x)))  # the bf16 path ran


def test_parameter_tree_is_flaxs_names_and_order(setup):
    _, _, _, params, _, _ = setup
    model = ResNet18(**SMALL)
    tree = model.params_to_flax(model.state_dict())

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(np.shape(v)) for k, v in t.items()}

    assert shapes(tree) == shapes(params)
    assert list(tree) == sorted(params) and list(tree["BasicBlock_2"]) == sorted(params["BasicBlock_2"])
    back = resnet_params_to_flax(resnet_params_from_flax(params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_full_width_parameter_count_is_jaxs():
    shapes = jax.eval_shape(JaxResNet18().init, jax.random.key(0), jnp.zeros((1, 3072)))["params"]
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in ResNet18().parameters()) == jax_count == 11_173_962


def test_init_matches_flax_distribution():
    jmodel = JaxResNet18(base_channels=32)
    jparams = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, 3072)))["params"])
    model = ResNet18(base_channels=32).init_params(0)
    tree = model.params_to_flax(model.state_dict())
    for block, conv in (("BasicBlock_3", "Conv_1"), ("BasicBlock_6", "Conv_0"), ("BasicBlock_7", "Conv_1")):
        assert float(np.std(tree[block][conv]["kernel"])) == pytest.approx(
            float(np.std(jparams[block][conv]["kernel"])), rel=0.03)
    assert float(np.abs(tree["GroupNorm_0"]["scale"] - 1).max()) == 0.0
    assert float(np.abs(tree["BasicBlock_0"]["GroupNorm_1"]["bias"]).max()) == 0.0
    assert float(np.abs(tree["head"]["bias"]).max()) == 0.0


# --- the steps -------------------------------------------------------------------


def test_one_train_step_matches_jax(setup):
    jmodel, trial, _, params, x, y = setup
    jstate = jax_cls.create_classifier_state(trial, jmodel, optax.adam(LR), jax.random.key(0))
    jstate, jm = jax_cls.make_classifier_train_step(trial, jmodel, optax.adam(LR))(jstate, x, y)
    group = setup_groups(1, devices=["cpu"])[0]
    state, m = make_classifier_train_step(group)(_port_state(params), torch.from_numpy(x), torch.from_numpy(y))
    assert state.step == 1 and m["loss"].dim() == 0
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    _assert_step_close(state.model.state_dict(), _grads(state), jax.device_get(jstate.params),
                       _jax_grads(jmodel, params, x, y), _jax_step_grads(jmodel, trial, x, y))


def test_grad_accum_matches_jax(setup):
    jmodel, trial, _, params, x, y = setup
    tx = optax.adam(LR)
    jstate = jax_cls.create_classifier_state(trial, jmodel, tx, jax.random.key(0))
    jstate, jm = jax_cls.make_classifier_train_step(trial, jmodel, tx, grad_accum=2)(jstate, x, y)
    group = setup_groups(1, devices=["cpu"])[0]
    state, m = make_classifier_train_step(group, grad_accum=2)(
        _port_state(params), torch.from_numpy(x), torch.from_numpy(y))
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["accuracy"]) == float(jm["accuracy"])
    # The microbatches' mean gradient is the whole batch's, up to order.
    _assert_step_close(state.model.state_dict(), _grads(state), jax.device_get(jstate.params),
                       _jax_grads(jmodel, params, x, y), _jax_step_grads(jmodel, trial, x, y, grad_accum=2))


def test_multi_step_is_jaxs_scan_and_k_single_steps(setup):
    jmodel, trial, _, params, _, _ = setup
    rng = np.random.default_rng(3)
    xs = rng.uniform(0, 1, (3, ROWS, 768)).astype(np.float32)
    ys = rng.integers(0, 10, (3, ROWS)).astype(np.int32)
    tx = optax.adam(LR)
    jstate = jax_cls.create_classifier_state(trial, jmodel, tx, jax.random.key(0))
    jstate, jm = jax_cls.make_classifier_multi_step(trial, jmodel, tx)(jstate, xs, ys)
    group = setup_groups(1, devices=["cpu"])[0]
    multi = make_classifier_multi_step(group)
    assert not multi.graphed and multi.replays == 0
    s1, m1 = multi(_port_state(params), torch.from_numpy(xs), torch.from_numpy(ys))
    assert m1["loss"].shape == m1["accuracy"].shape == (3,) and s1.step == 3
    _close(m1["loss"], jm["loss"])
    np.testing.assert_array_equal(m1["accuracy"].numpy(), np.asarray(jm["accuracy"]))
    s2, step = _port_state(params), make_classifier_train_step(group)
    singles = []
    for k in range(3):
        s2, m = step(s2, torch.from_numpy(xs[k]), torch.from_numpy(ys[k]))
        singles.append(m["loss"])
    assert torch.equal(m1["loss"], torch.stack(singles))
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, s2.model.state_dict()[k])


def test_eval_step_matches_jax(setup):
    jmodel, trial, jstate, params, x, y = setup
    ref = jax_cls.make_classifier_eval_step(trial, jmodel)(jstate, x, y)
    got = make_classifier_eval_step(setup_groups(1, devices=["cpu"])[0])(
        _port_state(params), torch.from_numpy(x), torch.from_numpy(y))
    assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    assert float(got["correct"]) == float(ref["correct"])


def test_multi_step_on_a_card_group_takes_cuda_graphs_or_raises():
    # The rule picks CUDA graphs for a one-rank group on a card; without
    # CUDA that raises rather than running the eager loop.
    card = TrialGroup(group_id=0, global_ranks=(0,), device=torch.device("cuda:0"), is_local_member=True,
                      local_rank=0, owner_process=0, pg=object())
    with pytest.raises(RuntimeError, match="CUDA-graph capture needs a CUDA device"):
        make_classifier_multi_step(card)
    pair = TrialGroup(group_id=0, global_ranks=(0, 1), device=torch.device("cuda:0"), is_local_member=True,
                      local_rank=0, owner_process=0, pg=object())
    assert not make_classifier_multi_step(pair).graphed
    assert not make_classifier_multi_step(card, grad_accum=2).graphed


# --- the labelled feed ------------------------------------------------------------


@pytest.mark.parametrize("use_native", [False, True])
def test_labelled_batches_and_chunks_are_jaxs(use_native):
    data = synthetic_cifar10(100, seed=2)
    jdata = jax_synthetic_cifar10(100, seed=2)
    (trial,) = jax_setup_groups(1, devices=jax.devices()[:1])
    group = setup_groups(1, devices=["cpu"])[0]
    mine = TrialDataIterator(data, group, 16, seed=3, with_labels=True, use_native=use_native)
    ref = JaxTrialDataIterator(jdata, trial, 16, seed=3, with_labels=True, use_native=False)
    batches = list(mine.epoch(1))
    jbatches = list(ref.epoch(1))
    assert len(batches) == len(jbatches) == 6
    for (xi, yi), (jx, jy) in zip(batches, jbatches):
        assert yi.dtype == torch.int64 and tuple(yi.shape) == (16,)
        np.testing.assert_array_equal(xi.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(yi.numpy(), np.asarray(jy))
    chunks, jchunks = list(mine.epoch_chunks(2, 4)), list(ref.epoch_chunks(2, 4))
    assert [c[0] for c in chunks] == [c[0] for c in jchunks] == [0, 4]
    for (start, xi, yi), (_, jx, jy) in zip(chunks, jchunks):
        assert tuple(yi.shape) == (xi.shape[0], 16) and yi.dtype == torch.int64
        np.testing.assert_array_equal(xi.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(yi.numpy(), np.asarray(jy))
    # The labels are each row's own.
    rows = {tuple(r): int(label) for r, label in zip(data.images, data.labels)}
    for xi, yi in batches:
        assert [rows[tuple(r)] for r in xi.numpy()] == yi.tolist()
    # Without labels the iterator yields what it always did.
    plain = TrialDataIterator(data, group, 16, seed=3, use_native=use_native)
    assert all(torch.equal(a, b) for a, (b, _) in zip(plain.epoch(1), batches))
    assert [len(c) for c in plain.epoch_chunks(2, 4)] == [2, 2]


# --- two ranks -----------------------------------------------------------------

_RANK_MAIN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from multidisttorch_tpu_torch.models import ResNet18
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.classifier import (
    create_classifier_state, make_classifier_eval_step, make_classifier_train_step)

W = torch.load(sys.argv[1])
world, rank = cluster.initialize_runtime(device="cpu")
(pair,) = setup_groups(1, device="cpu")
model = ResNet18(**W["dims"])
model.load_state_dict(W["weights"])
state = create_classifier_state(pair, model, W["lr"])
half = W["x"].shape[0] // 2
rows = slice(rank * half, (rank + 1) * half)
ev = make_classifier_eval_step(pair)(state, W["x"][rows], W["y"][rows])
state, m = make_classifier_train_step(pair)(state, W["x"][rows], W["y"][rows])
got = {"world": world, "rank": rank, "loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
       "eval_loss": float(ev["loss"]), "correct": float(ev["correct"]),
       "params": {k: v.tolist() for k, v in state.model.state_dict().items()},
       "grads": {k: p.grad.tolist() for k, p in state.model.named_parameters()}}
with open(sys.argv[2], "w") as f:
    json.dump(got, f)
cluster.shutdown_runtime()
"""


def test_two_ranks_step_as_jax_steps_the_group_batch(setup, tmp_path):
    from test_torch_groups import _launch

    jmodel, trial, _, params, x, y = setup
    torch.save({"dims": SMALL, "weights": resnet_params_from_flax(params), "lr": LR, "x": torch.from_numpy(x),
                "y": torch.from_numpy(y.astype(np.int64))}, tmp_path / "w.pt")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _RANK_MAIN, str(tmp_path / "w.pt"), outs[r]], 2, timeout=120)
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    tx = optax.adam(LR)
    jstate = jax_cls.create_classifier_state(trial, jmodel, tx, jax.random.key(0))
    jev = jax_cls.make_classifier_eval_step(trial, jmodel)(jstate, x, y)
    jstate, jm = jax_cls.make_classifier_train_step(trial, jmodel, tx)(jstate, x, y)
    jgrads, jstep_grads = _jax_grads(jmodel, params, x, y), _jax_step_grads(jmodel, trial, x, y)
    for g in got:
        assert g["world"] == 2
        assert g["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert g["accuracy"] == float(jm["accuracy"])
        assert g["eval_loss"] == pytest.approx(float(jev["loss"]), rel=1e-5) and g["correct"] == float(jev["correct"])
        _assert_step_close(g["params"], g["grads"], jax.device_get(jstate.params), jgrads, jstep_grads)


# --- the example -------------------------------------------------------------------


def test_example_cli_runs_on_cpu():
    from multidisttorch_tpu_torch.examples import resnet_hpo

    out = resnet_hpo.main(["--device", "cpu", "--ngroups", "2", "--epochs", "1", "--base-channels", "4",
                           "--synthetic-size", "320", "--batch-size", "32", "--fused-steps", "4"])
    # 10 batches an epoch: two chunks of 4, then the tail of 2 step by step.
    assert [o["trial"] for o in out] == [0, 1] and [o["lr"] for o in out] == [1e-3, 2e-3]
    assert all(o["steps"] == 10 and 0.0 <= o["test_accuracy"] <= 1.0 for o in out)
