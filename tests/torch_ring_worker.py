"""One rank of a gloo world that runs the port's sequence-parallel paths.

``python tests/torch_ring_worker.py IN OUT``: ``IN`` is a ``torch.save`` of
the inputs and the jobs to run (keys of ``JOBS``); the rank joins the world
from ``WORLD_SIZE``/``RANK``/``MASTER_*``, carves one group of every rank,
runs each job on its share and saves ``{job: result}`` to ``OUT``. It
imports only the port. The tests that launch it (``test_torch_ring.py``,
``test_torch_moe_lm.py``) hold the results to the JAX package's.
"""

import os
import sys

import torch

from multidisttorch_tpu_torch.models.transformer import MoETransformerLM, TransformerLM
from multidisttorch_tpu_torch.ops.attention import make_ring_flash_attention
from multidisttorch_tpu_torch.ops.ring_attention import make_ring_attention
from multidisttorch_tpu_torch.parallel import cluster
from multidisttorch_tpu_torch.parallel.mesh import setup_groups
from multidisttorch_tpu_torch.train.lm import (
    create_lm_state,
    lm_chunk_sharding,
    make_lm_eval_step,
    make_lm_multi_step,
    make_lm_train_step,
)

RINGS = {"ring": make_ring_attention, "ring_flash": make_ring_flash_attention}


def _chunk(group, x):
    t = x.shape[1] // group.size
    return x[:, group.local_rank * t : (group.local_rank + 1) * t]


def _attention(group, W, name, causal, scale=1.0):
    """This rank's output chunk and its gradients of ``sum(out**2)`` summed
    over the ranks, for its q, k and v chunks."""
    q, k, v = (_chunk(group, W["qkv"][i]).clone().requires_grad_(True) for i in range(3))
    out = RINGS[name](group, causal=causal)(q * scale, k, v)
    (out**2).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in (q, k, v)]}


def _ring_job(group, W):
    return {(name, causal): _attention(group, W, name, causal)
            for name in RINGS for causal in (False, True)}


def _extreme_job(group, W):
    return _attention(group, W, "ring", False, scale=40.0)


def _grads(state):
    return {k: p.grad.clone() for k, p in state.model.named_parameters()}


def _lm(group, W, key, model_cls, **kw):
    """One sequence-parallel step at lr 0 (the gradients, summed over the
    ranks, and the loss), the eval on the same rows, then ``W[key]["steps"]``
    steps at ``W[key]["lr"]``."""
    cfg = W[key]
    out = {}
    for name in cfg["attentions"]:
        model = model_cls(**cfg["dims"], attention=RINGS[name](group, causal=True), **kw)
        model.load_state_dict(cfg["weights"])
        state = create_lm_state(group, model, 0.0)
        place = lm_chunk_sharding(group, sequence_parallel=True)
        tokens = place(cfg["tokens"])
        state, m = make_lm_train_step(group, sequence_parallel=True)(state, tokens)
        ev = make_lm_eval_step(group, sequence_parallel=True)(state, tokens)
        res = {"loss": float(m["loss"]), "grads": _grads(state), "eval": float(ev["loss"]),
               "perplexity": float(ev["perplexity"])}
        if cfg.get("steps"):
            for group_ in state.optimizer.param_groups:
                group_["lr"] = cfg["lr"]
            chunks = place(cfg["tokens"].expand(cfg["steps"], *cfg["tokens"].shape).contiguous())
            state, m = make_lm_multi_step(group, sequence_parallel=True)(state, chunks)
            res["losses"] = m["loss"].tolist()
        out[name] = res
        del state
    return out


def _lm_job(group, W):
    return _lm(group, W, "lm", TransformerLM)


def _moe_lm_job(group, W):
    return _lm(group, W, "moe_lm", MoETransformerLM)


def _moe_lm_dp_job(group, W):
    """The MoE LM data parallel (each rank its rows, DDP, the router bound to
    the group): one step at lr 0."""
    cfg = W["moe_lm"]
    model = MoETransformerLM(**cfg["dims"])
    model.load_state_dict(cfg["weights"])
    state = create_lm_state(group, model, 0.0)
    tokens = lm_chunk_sharding(group)(cfg["tokens"])
    state, m = make_lm_train_step(group)(state, tokens)
    out = {"loss": float(m["loss"]), "grads": _grads(state)}
    del state
    return out


JOBS = {"ring": _ring_job, "extreme": _extreme_job, "lm": _lm_job, "moe_lm": _moe_lm_job,
        "moe_lm_dp": _moe_lm_dp_job}


def main(inp: str, out: str) -> None:
    torch.set_num_threads(1)
    cluster.initialize_runtime(device="cpu")
    (group,) = setup_groups(1, device="cpu")
    W = torch.load(inp)
    res = {job: JOBS[job](group, W) for job in W["jobs"]}
    torch.save(res, out + ".tmp")
    os.replace(out + ".tmp", out)
    cluster.shutdown_runtime()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
