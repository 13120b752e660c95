"""The LM train step on a group of two gloo ranks against the one-process
step on the same rows.

Run as a script, this file is one rank of the two-process world
(``WORLD_SIZE``/``RANK``/``MASTER_*`` from the environment); it imports
only the port.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from multidisttorch_tpu_torch.models.transformer import TransformerLM, init_lm_params
from multidisttorch_tpu_torch.ops.attention import make_flash_attention
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.lm import create_lm_state, make_lm_eval_step, make_lm_train_step

VOCAB, T, ROWS, STEPS = 32, 16, 8, 2


def _model():
    model = TransformerLM(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2, max_len=T,
                          attention=make_flash_attention(causal=True))
    return init_lm_params(model, 0)


def _batches():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, VOCAB, (STEPS, ROWS, T)).astype(np.int64))


def _train(group, rows: slice):
    state = create_lm_state(group, _model(), 3e-3)
    step = make_lm_train_step(group)
    losses = []
    for batch in _batches():
        state, m = step(state, batch[rows])
        losses.append(float(m["loss"]))
    ev = make_lm_eval_step(group)(state, _batches()[0][rows])
    return state, losses, float(ev["loss"])


def _gloo_rank(out_path: str) -> None:
    cluster.initialize_runtime(device="cpu")
    pair = setup_groups(1, device="cpu")[0]
    half = ROWS // 2
    state, losses, ev = _train(pair, slice(half * pair.local_rank, half * (pair.local_rank + 1)))
    np.savez(out_path, **{k: v.detach().numpy() for k, v in state.model.state_dict().items()})
    with open(out_path + ".json", "w") as f:
        json.dump({"losses": losses, "eval": ev}, f)
    cluster.shutdown_runtime()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_lm_train_step_matches_one_process(tmp_path):
    from tests.test_torch_groups import _launch

    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    _launch(lambda r: [sys.executable, os.path.abspath(__file__), outs[r]], 2, timeout=120)
    one = setup_groups(1, devices=["cpu"])[0]
    state, losses, ev = _train(one, slice(0, ROWS))
    # DDP's average of the two ranks' gradients is the gradient of the
    # 8-row mean; f32 sums in another order (rel 1e-5 on the losses).
    for out in outs:
        with open(out + ".json") as f:
            got = json.load(f)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert got["eval"] == pytest.approx(ev, rel=1e-5)
        params = np.load(out + ".npz")
        for k, v in state.model.state_dict().items():
            # The key bias's true gradient is zero (softmax ignores a
            # per-row constant): Adam follows the sign of rounding noise.
            if k.endswith(".k.bias"):
                continue
            np.testing.assert_allclose(params[k], v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    # Both ranks hold the same weights.
    a, b = (np.load(o + ".npz") for o in outs)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


if __name__ == "__main__":
    _gloo_rank(sys.argv[1])
