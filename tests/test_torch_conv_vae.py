"""The port's conv β-VAE (``models/conv_vae.py`` over ``models/layers.py``
and ``models/_flax.py``) against the JAX package's, and the slice through
``run_hpo(model_builder=ConvVAE)``.

Both packages start from the same weights (a flax init carried across
with ``ConvVAE.params_from_flax``), the same rows and the same injected
noise. Tolerances: forward outputs rtol/atol 1e-5 in f32 (the same
products summed in another order, in NCHW here and NHWC there); one train
step's loss rel 1e-5 and parameters rtol 1e-4 / atol 1e-6 (the VAE's, one
Adam step moving each weight by about lr); the test loss of a whole
``run_hpo`` at lr 0 rel 1e-5. Checkpoints cross between the packages in
both directions with every leaf equal and v1 bytes equal. Also: flax's
'SAME' padding and transposed convolutions layer by layer at odd and even
sizes, the init distributions, ``synthetic_cifar10`` and ``load_cifar10``
against the JAX package's, the refusals, and the example CLI.
"""

import os
import pickle
import re
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multidisttorch_tpu.data import datasets as jax_datasets
from multidisttorch_tpu.hpo.driver import TrialConfig as JaxTrialConfig
from multidisttorch_tpu.hpo.driver import run_hpo as jax_run_hpo
from multidisttorch_tpu.models.conv_vae import ConvVAE as JaxConvVAE
from multidisttorch_tpu.ops.losses import elbo_loss_sum as jax_elbo_loss_sum
from multidisttorch_tpu.ops.pallas_elbo import fused_elbo_loss_sum as jax_fused
from multidisttorch_tpu.parallel.mesh import setup_groups as jax_setup_groups
from multidisttorch_tpu.train import checkpoint as jax_ck
from multidisttorch_tpu.train.steps import build_train_state
from multidisttorch_tpu_torch.data import datasets
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, run_hpo
from multidisttorch_tpu_torch.models import ConvVAE, conv_vae_params_from_flax, conv_vae_params_to_flax
from multidisttorch_tpu_torch.models.layers import Conv, ConvTranspose, GroupNorm, same_pads
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train import checkpoint as ck
from multidisttorch_tpu_torch.train.steps import create_train_state, make_multi_step, make_train_step
from test_torch_checkpoint import _assert_trees_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(latent_dim=4, base_channels=4, image_hw=8)  # rows of 8*8*3 = 192
LR = 1e-3


def _jax_params(model, seed: int):
    """What a JAX trial starts from: ``build_train_state``'s init with
    ``jax.random.key(seed)``."""
    return jax.device_get(build_train_state(model, optax.adam(LR), jax.random.key(seed)).params)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxConvVAE(**SMALL)
    params = _jax_params(jmodel, 0)
    tmodel = ConvVAE(**SMALL)
    tmodel.load_state_dict(tmodel.params_from_flax(params))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (6, 192)).astype(np.float32)
    eps = rng.normal(0, 1, (6, SMALL["latent_dim"])).astype(np.float32)
    return jmodel, params, tmodel, x, eps


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(ref),
                               rtol=rtol, atol=atol)


# --- layers ---------------------------------------------------------------------


@pytest.mark.parametrize("n, k, s", [(8, 3, 2), (7, 3, 2), (8, 3, 1), (7, 1, 2), (8, 1, 2), (9, 3, 3)])
def test_conv_same_padding_matches_flax(n, k, s):
    rng = np.random.default_rng(n * 10 + k + s)
    x = rng.normal(size=(2, n, n, 5)).astype(np.float32)
    conv = fnn.Conv(7, (k, k), strides=(s, s))
    p = conv.init(jax.random.key(0), x)["params"]
    ref = conv.apply({"params": p}, x)
    mine = Conv(5, 7, k, s)
    mine.load_state_dict({"weight": torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(np.array(p["bias"]))})
    got = mine(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)
    # flax pads the larger half after: a stride-2 3x3 conv on an even size
    # pads (0, 1), never torch's symmetric 1.
    assert same_pads(8, 3, 2) == (0, 1) and same_pads(8, 3, 1) == (1, 1) and same_pads(8, 1, 2) == (0, 0)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_conv_transpose_matches_flax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n, n, 5)).astype(np.float32)
    deconv = fnn.ConvTranspose(7, (3, 3), strides=(2, 2))
    p = deconv.init(jax.random.key(1), x)["params"]
    ref = deconv.apply({"params": p}, x)
    mine = ConvTranspose(5, 7, 3, 2)
    sd = conv_vae_params_from_flax({"out": p})  # a name in ConvVAE's transposed set
    mine.load_state_dict({"weight": sd["out.weight"], "bias": sd["out.bias"]})
    got = mine(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape == (2, 2 * n, 2 * n, 7)
    _close(got, ref)


@pytest.mark.parametrize("channels", [8, 64])
def test_group_norm_matches_flax(channels):
    x = np.random.default_rng(channels).normal(size=(3, 4, 4, channels)).astype(np.float32) * 3 + 1
    gn = fnn.GroupNorm(num_groups=min(32, channels))
    p = gn.init(jax.random.key(0), x)["params"]
    p = {"scale": np.linspace(0.5, 1.5, channels, dtype=np.float32),
         "bias": np.linspace(-1, 1, channels, dtype=np.float32)}
    ref = gn.apply({"params": p}, x)
    mine = GroupNorm(channels)
    mine.load_state_dict({"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"])})
    _close(mine(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), ref)


# --- the model ------------------------------------------------------------------


def test_encode_matches_flax(pair):
    jmodel, params, tmodel, x, _ = pair
    jmu, jlv = jmodel.apply({"params": params}, x, method=JaxConvVAE.encode)
    mu, lv = tmodel.encode(torch.from_numpy(x))
    _close(mu, jmu)
    _close(lv, jlv)


@pytest.mark.parametrize("method", ["decode", "decode_probs"])
def test_decode_matches_flax_in_hwc_order(pair, method):
    # Element for element against flax's flattened NHWC logits: a decoder
    # that flattened NCHW, or read proj's output as NCHW, fails here.
    jmodel, params, tmodel, _, eps = pair
    ref = jmodel.apply({"params": params}, eps, method=getattr(JaxConvVAE, method))
    got = getattr(tmodel, method)(torch.from_numpy(eps))
    assert tuple(got.shape) == ref.shape == (6, 192)
    _close(got, ref)


def test_forward_with_injected_eps_matches_flax(pair):
    jmodel, params, tmodel, x, eps = pair
    mu, logvar = jmodel.apply({"params": params}, x, method=JaxConvVAE.encode)
    z = mu + eps * jnp.exp(0.5 * logvar)
    refs = (jmodel.apply({"params": params}, z, method=JaxConvVAE.decode), mu, logvar)
    for got, ref in zip(tmodel(torch.from_numpy(x), eps=torch.from_numpy(eps)), refs):
        _close(got, ref)
    # The image-shaped input is the same rows.
    got = tmodel(torch.from_numpy(x).reshape(6, 8, 8, 3), eps=torch.from_numpy(eps))[0]
    _close(got, refs[0])


def test_bf16_compute_matches_flax(pair):
    # dtype=bfloat16 casts inputs and weights for the convs and Dense
    # layers, f32 parameters kept, as flax's dtype=bf16 with
    # param_dtype=f32 does; bf16 storage precision (2e-2), as the VAE's.
    _, params, _, x, eps = pair
    jmodel = JaxConvVAE(**SMALL, dtype=jnp.bfloat16)
    tmodel = ConvVAE(**SMALL, dtype=torch.bfloat16)
    tmodel.load_state_dict(tmodel.params_from_flax(params))
    refs = (*jmodel.apply({"params": params}, x, method=JaxConvVAE.encode),
            jmodel.apply({"params": params}, eps, method=JaxConvVAE.decode))
    gots = (*tmodel.encode(torch.from_numpy(x)), tmodel.decode(torch.from_numpy(eps)))
    f32 = ConvVAE(**SMALL)
    f32.load_state_dict(tmodel.state_dict())
    for got, ref, full in zip(gots, refs, (*f32.encode(torch.from_numpy(x)), f32.decode(torch.from_numpy(eps)))):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        _close(got.float(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)
        assert not torch.equal(got.float(), full)  # the bf16 path ran


def test_flax_round_trip_keeps_flaxs_tree_and_order(pair):
    _, params, tmodel, _, _ = pair
    back = conv_vae_params_to_flax(conv_vae_params_from_flax(params))
    assert list(back) == sorted(params)
    for name in params:
        assert list(back[name]) == sorted(params[name])
        for leaf in params[name]:
            np.testing.assert_array_equal(back[name][leaf], np.asarray(params[name][leaf]))
    again = tmodel.params_from_flax(tmodel.params_to_flax(tmodel.state_dict()))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(again[k], v)


def test_init_matches_flax_distribution():
    # flax's defaults (not its bits): truncated LeCun normal with the
    # kernel's fan-in (kh*kw*in for a conv or transposed conv), zero
    # biases. At full width the stds agree within 3 %.
    jparams = _jax_params(JaxConvVAE(), 0)
    model = ConvVAE().init_params(0)
    tree = model.params_to_flax(model.state_dict())
    for name in ("enc1", "enc2", "mu", "proj", "dec0", "dec1"):
        assert float(np.std(tree[name]["kernel"])) == pytest.approx(float(np.std(jparams[name]["kernel"])), rel=0.03)
        assert float(np.abs(tree[name]["bias"]).max()) == 0.0
    again = ConvVAE().init_params(0)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))
    assert not torch.equal(ConvVAE().init_params(1).enc0.weight, model.enc0.weight)


# --- train steps ----------------------------------------------------------------


def _port_state(params, lr=LR):
    model = ConvVAE(**SMALL)
    model.load_state_dict(model.params_from_flax(params))
    return create_train_state(setup_groups(1, devices=["cpu"])[0], model, lr)


@pytest.mark.parametrize("fused", [True, False])
def test_one_train_step_matches_jax(pair, fused):
    jmodel, params, _, x, eps = pair
    beta, m = 0.5, x.shape[0]
    loss_impl = jax_fused if fused else jax_elbo_loss_sum

    def loss_fn(p):
        mu, logvar = jmodel.apply({"params": p}, x, method=JaxConvVAE.encode)
        z = mu + eps * jnp.exp(0.5 * logvar)
        logits = jmodel.apply({"params": p}, z, method=JaxConvVAE.decode)
        return loss_impl(logits, x, mu, logvar, beta) / m

    tx = optax.adam(LR)
    jloss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    jparams = jax.device_get(optax.apply_updates(params, updates))

    group = setup_groups(1, devices=["cpu"])[0]
    state = _port_state(params)
    state, metrics = make_train_step(group, beta=beta, use_fused_loss=fused)(
        state, torch.from_numpy(x), eps=torch.from_numpy(eps))
    assert float(metrics["loss_sum"]) == pytest.approx(float(jloss) * m, rel=1e-5)
    got = state.model.state_dict()
    for k, v in conv_vae_params_from_flax(jparams).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_multi_step_equals_single_steps(pair):
    _, params, _, _, _ = pair
    group = setup_groups(1, devices=["cpu"])[0]
    rng = np.random.default_rng(8)
    batches = torch.from_numpy(rng.uniform(0, 1, (3, 6, 192)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(0, 1, (3, 6, 4)).astype(np.float32))
    s1, m1 = make_multi_step(group, beta=2.0)(_port_state(params), batches, eps=noise)
    s2, step = _port_state(params), make_train_step(group, beta=2.0)
    singles = []
    for k in range(3):
        s2, m = step(s2, batches[k], eps=noise[k])
        singles.append(m["loss_sum"])
    assert torch.equal(m1["loss_sum"], torch.stack(singles)) and s1.step == s2.step == 3
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, s2.model.state_dict()[k])


# --- the slice: run_hpo(model_builder=ConvVAE) ---------------------------------

HPO_MODEL = dict(latent_dim=4, base_channels=4)  # 32x32x3 rows of synthetic_cifar10


@pytest.fixture
def carried(monkeypatch):
    """ConvVAE trials start from the JAX trial's initial weights."""
    cache = {}

    def init_from_jax(self, seed):
        if seed not in cache:
            cache[seed] = conv_vae_params_from_flax(_jax_params(JaxConvVAE(**HPO_MODEL), seed))
        self.load_state_dict(cache[seed])
        return self

    monkeypatch.setattr(ConvVAE, "init_params", init_from_jax)


def test_run_hpo_at_lr0_gives_jaxs_test_losses(tmp_path, carried):
    train, test = datasets.synthetic_cifar10(128, seed=0), datasets.synthetic_cifar10(40, seed=1)
    configs = [dict(trial_id=i, epochs=2, batch_size=32, lr=0.0, beta=b, seed=i, log_interval=2)
               for i, b in enumerate((0.5, 1.0))]
    jres = jax_run_hpo([JaxTrialConfig(**c) for c in configs], train, test,
                       groups=jax_setup_groups(2, devices=jax.devices()[:2]), out_dir=str(tmp_path / "jax"),
                       save_checkpoints=False, ledger=False, save_images=False, verbose=False,
                       model_builder=lambda cfg: JaxConvVAE(**HPO_MODEL))
    pres = run_hpo([TrialConfig(**c) for c in configs], train, test, groups=setup_groups(2, devices=["cpu"] * 2),
                   out_dir=str(tmp_path / "port"), save_images=True, verbose=False,
                   model_builder=lambda cfg: ConvVAE(**HPO_MODEL))
    for p, j in zip(pres, jres):
        assert p.status == "completed" and p.steps == j.steps == 8
        assert [h["epoch"] for h in p.history] == [1, 2]
        for hp, hj in zip(p.history, j.history):
            assert hp["test_loss"] == pytest.approx(hj["test_loss"], rel=1e-5)
        # Each trial wrote its checkpoint (the default) and its image grids.
        trial_dir = tmp_path / "port" / f"trial-{p.trial_id}"
        assert (trial_dir / "state.msgpack").exists() and (trial_dir / "sample_2.png").exists()


def test_run_hpo_refuses_what_jax_refuses(tmp_path):
    train = datasets.synthetic_cifar10(64, seed=0)
    cfgs = [TrialConfig(trial_id=i, epochs=1, batch_size=32) for i in range(3)]
    groups = setup_groups(1, devices=["cpu"])
    for kw in ({"model_builder": lambda cfg: ConvVAE(**HPO_MODEL)}, {"param_shardings_builder": lambda g, m: None},
               {"model_parallel": 2}):
        with pytest.raises(ValueError, match="stack_trials supports the default VAE family"):
            run_hpo(cfgs, train, groups=groups, out_dir=str(tmp_path), stack_trials=True, **kw)
    with pytest.raises(NotImplementedError, match=re.escape("ROADMAP A.13")):
        run_hpo(cfgs, train, groups=groups, out_dir=str(tmp_path), param_shardings_builder=lambda g, m: None)


# --- checkpoints across the packages --------------------------------------------


def _trained_port_state(params, steps=2):
    group = setup_groups(1, devices=["cpu"])[0]
    state = _port_state(params)
    rng = np.random.default_rng(3)
    step = make_train_step(group)
    for _ in range(steps):
        x = torch.from_numpy(rng.uniform(0, 1, (6, 192)).astype(np.float32))
        state, _ = step(state, x, eps=torch.from_numpy(rng.normal(0, 1, (6, 4)).astype(np.float32)))
    return state


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_checkpoints_cross_between_the_packages(pair, tmp_path, fmt):
    jmodel, params, _, _, _ = pair
    template = build_train_state(jmodel, optax.adam(LR), jax.random.key(5))
    # Port -> JAX.
    state = _trained_port_state(params)
    path = str(tmp_path / "port.msgpack")
    ck.save_state(state, path, metadata={"step": state.step}, format=fmt)
    restored = jax.device_get(jax_ck.restore_state(template, path))
    _assert_trees_equal(serialization.to_state_dict(restored), ck.train_state_to_tree(state))
    # JAX -> port: a JAX state with every leaf drawn, into a fresh port state.
    sd = serialization.to_state_dict(jax.device_get(template))
    rng = np.random.default_rng(9)
    for key in ("mu", "nu"):
        sd["opt_state"]["0"][key] = jax.tree.map(
            lambda a: np.abs(rng.normal(0, 1e-3, a.shape)).astype(np.float32), sd["opt_state"]["0"][key])
    sd["opt_state"]["0"]["count"] = np.asarray(4, np.int32)
    sd["step"] = np.asarray(4, np.int32)
    jpath = str(tmp_path / "jax.msgpack")
    jax_ck.save_state(serialization.from_state_dict(template, sd), jpath, metadata={"step": 4}, format=fmt)
    fresh = _port_state(params)
    ck.restore_state(fresh, jpath)
    _assert_trees_equal(ck.train_state_to_tree(fresh), sd)
    assert fresh.step == 4
    if fmt == "v1":  # the port writes the restored state back as JAX's bytes
        ck.save_state(fresh, str(tmp_path / "again.msgpack"), metadata={"step": 4}, format="v1")
        for suffix in ("", ".json"):
            with open(jpath + suffix, "rb") as a, open(str(tmp_path / "again.msgpack") + suffix, "rb") as b:
                assert a.read() == b.read()


def test_a_port_v1_file_is_the_bytes_jax_writes(pair, tmp_path):
    jmodel, params, _, _, _ = pair
    state = _trained_port_state(params, steps=3)
    ck.save_state(state, str(tmp_path / "port"), metadata={"step": 3})
    template = build_train_state(jmodel, optax.adam(LR), jax.random.key(5))
    restored = jax_ck.restore_state(template, str(tmp_path / "port"))
    jax_ck.save_state(restored, str(tmp_path / "jax"), metadata={"step": 3})
    for suffix in ("", ".json"):
        with open(str(tmp_path / "port") + suffix, "rb") as a, open(str(tmp_path / "jax") + suffix, "rb") as b:
            assert a.read() == b.read()


# --- data -----------------------------------------------------------------------


@pytest.mark.parametrize("n, seed", [(1, 0), (37, 0), (200, 3)])
def test_synthetic_cifar10_is_the_jax_packages(n, seed):
    mine, ref = datasets.synthetic_cifar10(n, seed), jax_datasets.synthetic_cifar10(n, seed)
    assert mine.images.tobytes() == ref.images.tobytes() and mine.labels.tobytes() == ref.labels.tobytes()
    assert mine.images.shape == (n, 3072) and mine.name == ref.name and mine.synthetic


def _write_cifar_pickles(root, rng):
    batch_dir = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(batch_dir)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = int(rng.integers(2, 5))
        with open(os.path.join(batch_dir, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, n)]}, f)


@pytest.mark.parametrize("train", [True, False])
def test_load_cifar10_reads_the_pickles_as_jax_does(tmp_path, train):
    _write_cifar_pickles(str(tmp_path), np.random.default_rng(1))
    mine = datasets.load_cifar10(train=train, data_dir=str(tmp_path), allow_synthetic=False)
    ref = jax_datasets.load_cifar10(train=train, data_dir=str(tmp_path), allow_download=False, allow_synthetic=False)
    assert mine.name == ref.name == "cifar10" and not mine.synthetic
    assert mine.images.tobytes() == ref.images.tobytes() and mine.labels.tobytes() == ref.labels.tobytes()
    # Rows are NHWC: pixel (0, 0)'s three channels first, each from its
    # own plane of the pickled NCHW bytes.
    with open(tmp_path / "cifar-10-batches-py" / ("data_batch_1" if train else "test_batch"), "rb") as f:
        raw = pickle.load(f, encoding="bytes")[b"data"][0]
    np.testing.assert_array_equal(mine.images[0, :3] * 255.0, raw[[0, 1024, 2048]].astype(np.float32))


def test_load_cifar10_falls_back_to_synthetic_and_never_downloads(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ds = datasets.load_cifar10(train=False, data_dir=str(tmp_path), synthetic_size=12)
    assert ds.synthetic and len(ds) == 12 and not os.listdir(tmp_path)
    assert ds.images.tobytes() == jax_datasets.synthetic_cifar10(12, seed=1).images.tobytes()
    with pytest.raises(FileNotFoundError):
        datasets.load_cifar10(data_dir=str(tmp_path), allow_synthetic=False)


# --- the example ----------------------------------------------------------------


def test_example_cli_runs_on_cpu(tmp_path, capsys):
    from multidisttorch_tpu_torch.examples import beta_vae_cifar

    results = beta_vae_cifar.main(["--device", "cpu", "--ngroups", "2", "--epochs", "1", "--synthetic-size", "128",
                                   "--batch-size", "32", "--base-channels", "4", "--latent-dim", "4",
                                   "--out-dir", str(tmp_path)])
    assert [r.config.beta for r in results] == [0.5, 1.0] and [r.steps for r in results] == [4, 4]
    assert all(r.status == "completed" and np.isfinite(r.final_test_loss) for r in results)
    assert "trial 1 (beta=1.0): test loss" in capsys.readouterr().out
