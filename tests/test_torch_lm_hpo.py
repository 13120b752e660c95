"""The port's LM sweep CLI (``multidisttorch_tpu_torch/examples/lm_hpo.py``)
as the JAX package's example tests run theirs (``tests/test_examples.py``),
on four gloo ranks (two rings of two, bounded by
``test_torch_groups._launch``'s timeout) and in one process, and the flags
that wait for later items.

A trial's weights come from ``init_lm_params(model, group id)`` and its
windows from seed ``group id`` on every layout, so the four-rank run's two
rings train the one-process run's trials: their printed final losses agree
to the printed 4 decimals, within 2e-4 (f32 sums in another order).
"""

import re
import sys

import numpy as np
import pytest
import torch

from multidisttorch_tpu_torch.examples import lm_hpo

ARGS = ["--device", "cpu", "--ngroups", "2", "--seq-len", "64", "--steps", "12"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _finals(text: str) -> dict:
    return {float(lr): float(loss) for lr, loss in re.findall(r"lr=(\S+): final loss (\S+),", text)}


@pytest.mark.parametrize("fused", [[], ["--fused-steps", "4"]])
def test_cli_on_four_gloo_ranks_prints_each_trials_perplexity(fused):
    from test_torch_groups import _launch

    outs = _launch(lambda r: [sys.executable, "-m", "multidisttorch_tpu_torch.examples.lm_hpo", *ARGS, *fused], 4,
                   timeout=240)
    text = "".join(outs)
    assert text.count("perplexity") == 2, text
    assert "2 concurrent ring trials; 64 tokens (32/rank inside each 2-rank ring)" in text
    finals = _finals(text)
    assert sorted(finals) == [1e-3, 3e-3]
    # the same trials in one process, each a ring of one
    one = {r["lr"]: r["loss"] for r in lm_hpo.main(ARGS + fused)}
    for lr, loss in finals.items():
        assert loss == pytest.approx(one[lr], abs=2e-4)
    assert all(loss < np.log(32) for loss in finals.values())


@pytest.mark.parametrize("extra", [["--ring-flash"], ["--moe", "4"], ["--moe", "2", "--ring-flash", "--fused-steps", "3"]])
def test_cli_one_process_modes_learn(capsys, extra):
    res = lm_hpo.main(ARGS + extra)
    out = capsys.readouterr().out
    assert out.count("perplexity") == 2 and ("ring-flash" in out) == ("--ring-flash" in extra)
    assert [r["lr"] for r in res] == [1e-3, 3e-3]
    for r in res:
        assert r["loss"] < np.log(32) and r["perplexity"] == pytest.approx(np.exp(r["loss"]), rel=1e-5)


@pytest.mark.parametrize("argv, item", [(["--model-parallel", "2"], "A.13.*A.15g"), (["--pipeline"], "A.14"),
                                        (["--pipeline", "--dry-run"], "A.14")])
def test_unported_layouts_raise(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        lm_hpo.main(ARGS + argv)


def test_fused_steps_must_divide_the_steps():
    with pytest.raises(SystemExit):
        lm_hpo.main(ARGS + ["--fused-steps", "5"])
