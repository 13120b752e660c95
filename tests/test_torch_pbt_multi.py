"""Per-group PBT across processes: a two-process gloo world, one member per
process, against the same population run in one process.

Each process builds only the member of the group it holds. The scores are
gathered with one ``all_gather`` per generation (``+inf`` where a process
holds no member) and reduced on the host with numpy, so a NaN stays NaN and
a diverged member ranks last in every process; an exploit whose target is
in another process than its source moves the winner's state with one
``broadcast``. Both ranks must record the same history, and it, the final
lrs and each member's final state must equal the one-process run's
exactly.
"""

import json
import sys

import numpy as np
import pytest
import torch

from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.hpo import pbt
from multidisttorch_tpu_torch.parallel.mesh import setup_groups

CFG = dict(population=2, generations=3, steps_per_generation=3, batch_size=16, hidden_dim=16, latent_dim=4,
           exploit_fraction=0.5, lr_min=1e-4, lr_max=1e-1, seed=0)


def _diverge_member_1_at_generation_1(monkeypatch_setattr):
    """Make member 1's score NaN in its second generation (a diverged
    member), through the member's eval."""
    real = pbt._Member.eval_loss_sum
    calls = {}

    def eval_loss_sum(self, book):
        value = real(self, book)
        n = calls[id(self)] = calls.get(id(self), 0) + 1
        return np.float32("nan") if n == 2 and self.member_id == 1 else value

    monkeypatch_setattr(pbt._Member, "eval_loss_sum", eval_loss_sum)


_RANK_MAIN = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, "tests")
from multidisttorch_tpu_torch.data.datasets import synthetic_mnist
from multidisttorch_tpu_torch.hpo import PBTConfig, run_pbt
from multidisttorch_tpu_torch.hpo import pbt
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from test_torch_pbt_multi import CFG, _diverge_member_1_at_generation_1, _summary

out_path = sys.argv[1]
world, rank = cluster.initialize_runtime(device="cpu")
train, test = synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)
got = {"world": world, "rank": rank}
groups = setup_groups(2, device="cpu")
got["plain"] = _summary(run_pbt(PBTConfig(**CFG), train, test, groups=groups, return_states=True, verbose=False))
_diverge_member_1_at_generation_1(setattr)
got["nan"] = _summary(run_pbt(PBTConfig(**CFG), train, test, groups=groups, return_states=True, verbose=False))
with open(out_path, "w") as f:
    json.dump(got, f)
cluster.shutdown_runtime()
"""


def _summary(res) -> dict:
    """What the test compares, JSON-ready: the history, final lrs, books
    and each held member's final state as nested lists. The history goes
    through JSON as the ranks' does, so a NaN in it is json's one NaN
    object and compares equal."""
    states = [None if s is None else {
        "params": {k: v.tolist() for k, v in s["params"].items()},
        "moments": [t.tolist() for t in s["exp_avg"] + s["exp_avg_sq"]],
        "count": s["count"],
    } for s in res.final_states]
    book = {k: v for k, v in res.dispatch_book.items() if k != "generation_s"}
    return {"history": json.loads(json.dumps(res.history)), "final_lrs": res.final_lrs, "book": book,
            "states": states, "best": [res.best_member, res.best_eval_loss]}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_process_per_group_pbt_matches_one_process(tmp_path, monkeypatch):
    from test_torch_groups import _launch

    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    _launch(lambda r: [sys.executable, "-c", _RANK_MAIN, outs[r]], 2, timeout=180)
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    assert [g["world"] for g in got] == [2, 2] and [g["rank"] for g in got] == [0, 1]

    train, test = synthetic_mnist(256, seed=0), synthetic_mnist(40, seed=1)
    one = {"plain": _summary(run_pbt(PBTConfig(**CFG), train, test, groups=setup_groups(2, devices=["cpu"] * 2),
                                     return_states=True, verbose=False))}
    _diverge_member_1_at_generation_1(monkeypatch.setattr)
    one["nan"] = _summary(run_pbt(PBTConfig(**CFG), train, test, groups=setup_groups(2, devices=["cpu"] * 2),
                                  return_states=True, verbose=False))

    for case in ("plain", "nan"):
        a, b, ref = got[0][case], got[1][case], one[case]
        # Both ranks record the same history, and it is the one-process run's.
        assert a["history"] == b["history"] == ref["history"], case
        assert a["final_lrs"] == b["final_lrs"] == ref["final_lrs"], case
        assert a["best"] == b["best"] == ref["best"], case
        # Each process holds its own member, with the one-process run's bits.
        assert a["states"][1] is None and b["states"][0] is None
        assert a["states"][0] == ref["states"][0] and b["states"][1] == ref["states"][1], case
        exploits = sum(len(h["exploits"]) for h in ref["history"])
        assert exploits >= 1, case
        # Each exploit crossed processes: one broadcast each, in both ranks.
        assert a["book"]["host_transfers"] == b["book"]["host_transfers"] == exploits, case
        assert ref["book"]["host_transfers"] == 0 and ref["book"]["device_copies"] == exploits, case

    # The diverged member ranks last everywhere and is replaced by the other.
    h = got[0]["nan"]["history"][1]
    assert np.isnan(h["loss_sums"][1]) and h["order"] == [0, 1]
    assert h["exploits"] == [{"from": 0, "to": 1, "new_lr": h["exploits"][0]["new_lr"]}]
    assert all(np.isfinite(s) for s in got[1]["nan"]["history"][2]["loss_sums"])

