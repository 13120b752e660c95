"""Language-model train, eval and sample steps.

Counterpart of ``multidisttorch_tpu/train/lm.py`` for the TransformerLM
(``models/transformer.py``). The next-token objective keeps shapes static:
the model sees all ``T`` tokens, targets are the input rolled left by one,
and the last position is masked out of the loss.

A step is eager PyTorch on the group's device; ``state`` is the
:class:`train.steps.TrainState` of :func:`create_lm_state` (the model, its
Adam optimizer, ``optax.adam``'s defaults). ``sequence_parallel=False`` is
plain data parallelism: each rank passes its own rows of the batch, and on
a multi-rank group DDP averages the gradients over the group's subgroup,
which is the gradient of the group's mean loss when the ranks hold equal
rows; the logged loss is the group's mean. ``sequence_parallel=True``
(the sequence over the group, ring attention) is not ported yet and
raises. ``make_lm_multi_step`` runs K steps in a Python loop.

Sampling draws from an explicit ``torch.Generator`` on the group's device;
torch cannot reproduce JAX's threefry stream, so sampled tokens differ from
the JAX package's, while greedy decoding (``temperature=0``) is the same
function.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from multidisttorch_tpu_torch.parallel.mesh import TrialGroup
from multidisttorch_tpu_torch.train.steps import TrainState, _require_trainable, create_train_state

_SEQUENCE_PARALLEL = (
    "sequence_parallel=True (the sequence sharded over the group, with ring "
    "attention) is not ported yet: ROADMAP A.15a (ring attention)"
)


def _filter_logits(logits: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """Top-k / nucleus filtering of ``(B, vocab)`` logits; filtered entries
    become ``-inf``. Rank-based: one stable descending sort (ties in index
    order, so rank 0 is the argmax), masks built in sorted space and
    scattered back, so counts are exact on tied logits."""
    b, v = logits.shape
    if top_k is not None and not 1 <= top_k <= v:
        raise ValueError(f"top_k={top_k} must be in [1, vocab={v}]")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, idx)
    keep = torch.ones(b, v, dtype=torch.bool, device=logits.device)
    if top_k is not None:
        keep &= torch.arange(v, device=logits.device)[None, :] < top_k
    if top_p is not None:
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest prefix with mass >= p; the top token always stays
        first = torch.ones(b, 1, dtype=torch.bool, device=logits.device)
        keep &= torch.cat([first, cum[:, :-1] < top_p], dim=-1)
    keep_vocab = torch.zeros_like(keep).scatter(-1, idx, keep)
    return torch.where(keep_vocab, logits, torch.full_like(logits, float("-inf")))


def _validate_sampling(temperature, top_k, top_p, vocab_size=None) -> None:
    """Construction-time validation shared by both sampler factories."""
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k={top_k} must be >= 1")
    if top_k is not None and vocab_size is not None and top_k > vocab_size:
        raise ValueError(f"top_k={top_k} exceeds the model's vocab_size={vocab_size}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} must be in (0, 1]")
    if temperature <= 0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature > 0 (greedy sampling "
            "ignores filters; refusing to drop them silently)"
        )


def _sample_token(logits, generator: Optional[torch.Generator], temperature, top_k, top_p):
    """One draw per row shared by both samplers: the argmax at temperature
    0, else (optionally filtered) softmax-temperature sampling from
    ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k is not None or top_p is not None:
        logits = _filter_logits(logits, top_k, top_p)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]


def lm_loss_mean(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in f32; the last position is masked
    (its target would wrap around the roll)."""
    targets = torch.roll(tokens, -1, dims=1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    t = tokens.shape[1]
    w = (torch.arange(t, device=tokens.device) < t - 1).float()[None, :]
    return (nll * w).sum() / w.sum() / tokens.shape[0]


def _group_mean(group: TrialGroup, value: torch.Tensor) -> torch.Tensor:
    if group.size > 1:
        dist.all_reduce(value, group=group.pg)
        value = value / group.size
    return value


def create_lm_state(group: TrialGroup, model: torch.nn.Module, lr: float) -> TrainState:
    """Place ``model`` (already initialised, e.g. by
    :func:`models.transformer.init_lm_params`) on the group's device with
    an Adam optimizer; on a multi-rank group, wrap it in DDP. The LM's
    steps stay eager, so its optimizer is torch's default (not capturable)
    on every device."""
    return create_train_state(group, model, lr, capturable=False)


def _build_lm_step_fn(group: TrialGroup, sequence_parallel: bool) -> Callable:
    if sequence_parallel:
        raise NotImplementedError(_SEQUENCE_PARALLEL)
    _require_trainable(group)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        loss = lm_loss_mean(state.module(tokens), tokens)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": _group_mean(group, loss.detach().float())}

    return step_fn


def make_lm_train_step(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """``step(state, tokens) -> (state, {"loss"})``; ``tokens`` is this
    rank's ``(rows, T)`` int batch. ``loss`` is a 0-d f32 tensor left on the
    device: the group's mean loss before the update."""
    return _build_lm_step_fn(group, sequence_parallel)


def make_lm_multi_step(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """K chained LM steps: ``multi(state, token_chunks)`` with
    ``token_chunks`` ``(K, rows, T)``; ``metrics["loss"]`` is ``(K,)``. A
    Python loop over :func:`make_lm_train_step`'s body."""
    step_fn = _build_lm_step_fn(group, sequence_parallel)

    def multi_fn(state: TrainState, token_chunks: torch.Tensor):
        losses = []
        for k in range(token_chunks.shape[0]):
            state, metrics = step_fn(state, token_chunks[k])
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return multi_fn


def make_lm_eval_step(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """``eval(state, tokens) -> {"loss", "perplexity"}``: the train
    objective with no gradient, averaged over the group."""
    if sequence_parallel:
        raise NotImplementedError(_SEQUENCE_PARALLEL)
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def eval_fn(state: TrainState, tokens: torch.Tensor) -> dict:
        with torch.no_grad():
            loss = lm_loss_mean(state.model(tokens), tokens).float()
        loss = _group_mean(group, loss)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return eval_fn


def make_lm_sample(
    group: TrialGroup,
    model: Any,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> Callable:
    """Autoregressive sampling with the full prefix recomputed per token.

    ``sample(state, tokens, prompt_len, generator=None) -> (B, T)``: the
    buffer holds the prompt in its first ``prompt_len`` positions (clamped
    to >= 1: position 0 always comes from the buffer); positions
    ``prompt_len..T-1`` are filled in turn. Greedy at ``temperature=0``,
    else softmax-temperature sampling from ``generator`` (on the buffer's
    device). Each rank samples its own rows.
    """
    _validate_sampling(temperature, top_k, top_p, getattr(model, "vocab_size", None))
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def sample_fn(state: TrainState, tokens: torch.Tensor, prompt_len: int, generator=None):
        buf = tokens.clone()
        with torch.no_grad():
            for i in range(max(int(prompt_len), 1), buf.shape[1]):
                logits = state.model(buf)[:, i - 1]
                buf[:, i] = _sample_token(logits, generator, temperature, top_k, top_p).to(buf.dtype)
        return buf

    return sample_fn
