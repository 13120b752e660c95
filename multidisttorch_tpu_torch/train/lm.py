"""Language-model train, eval and sample steps.

Counterpart of ``multidisttorch_tpu/train/lm.py`` for the TransformerLM
(``models/transformer.py``). The next-token objective keeps shapes static:
the model sees all ``T`` tokens, targets are the input rolled left by one,
and the last position is masked out of the loss.

A step is eager PyTorch on the group's device; ``state`` is the
:class:`train.steps.TrainState` of :func:`create_lm_state` (the model, its
Adam optimizer, ``optax.adam``'s defaults). ``make_lm_multi_step`` runs K
steps in a Python loop. A model that returns ``(logits, aux)`` (the MoE
LM) trains on ``lm_loss + AUX_LOSS_WEIGHT * aux``, the JAX package's
default ``aux_loss_weight``;
``aux`` is the group's (``ops/moe.py``).

- ``sequence_parallel=False`` is plain data parallelism: each rank passes
  its own rows of the batch, and on a multi-rank group DDP averages the
  gradients over the group's subgroup, which is the gradient of the
  group's mean loss when the ranks hold equal rows; the logged loss is the
  group's mean.
- ``sequence_parallel=True`` splits the sequence over the group: the model's
  attention is a ring over the same group (``ops/ring_attention.py``,
  ``ops/attention.py::make_ring_flash_attention``). **Every rank is given
  the whole ``(B, T)`` rows** and feeds the model its own ``T/k``
  columns; it takes each column's target from the row it holds, so the
  target of its last column (the next rank's first token) needs no
  exchange. Its loss is its masked sum of next-token losses over the
  group's count ``B·(T-1)`` (the JAX package masks only the global last
  position), so the ranks' losses sum to the group's; the replicated
  parameters' gradients are **summed** over the group (one ``all_reduce``
  after the backward; DDP's mean would be ``k`` times too small), and the
  logged loss is the sum. :func:`lm_chunk_sharding` is the placement rule.

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

AUX_LOSS_WEIGHT = 1e-2  # the MoE LM's aux loss in the objective


def _logits(out):
    """Model outputs are logits, or (logits, aux) from the MoE LM."""
    return out[0] if isinstance(out, tuple) else out


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
    return lm_loss_share(logits, tokens, slice(0, tokens.shape[1]))


def _group_sum(group: TrialGroup, value: torch.Tensor) -> torch.Tensor:
    if group.size > 1:
        dist.all_reduce(value, group=group.pg)
    return value


def _group_mean(group: TrialGroup, value: torch.Tensor) -> torch.Tensor:
    return _group_sum(group, value) / group.size


def _sequence_columns(group: TrialGroup, tokens: torch.Tensor) -> slice:
    """This rank's columns of the whole ``(B, T)`` rows."""
    t = tokens.shape[1]
    if t % group.size:
        raise ValueError(f"sequence length {t} does not divide over the group's {group.size} ranks")
    n = t // group.size
    return slice(group.local_rank * n, (group.local_rank + 1) * n)


def lm_loss_share(logits: torch.Tensor, tokens: torch.Tensor, cols: slice) -> torch.Tensor:
    """This rank's share of :func:`lm_loss_mean` under sequence parallelism:
    ``logits`` of columns ``cols`` of the whole ``(B, T)`` rows ``tokens``;
    the masked next-token losses summed over the group's count, so the
    ranks' shares sum to the group's mean (:func:`lm_loss_mean` is the
    share of all columns)."""
    b, t = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)[:, cols].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    w = (torch.arange(cols.start, cols.stop, device=tokens.device) < t - 1).float()[None, :]
    return (nll * w).sum() / (t - 1) / b


def _check_layout(group: TrialGroup, model, sequence_parallel: bool) -> None:
    """A ring model splits the sequence over its group; the step's flag must
    say the same wherever the group has more than one rank."""
    ring = getattr(model, "sequence_group", None)
    if group.size == 1 and (ring is None or ring.size == 1):
        return
    if sequence_parallel and ring is not group:
        raise ValueError(
            "sequence_parallel=True needs a model whose attention is a ring over this group "
            "(make_ring_attention or make_ring_flash_attention)"
        )
    if not sequence_parallel and ring is not None:
        raise ValueError("a ring attention splits the sequence over its group: pass sequence_parallel=True")


def _sum_grads(group: TrialGroup, model: torch.nn.Module) -> None:
    """Sum the replicated parameters' gradients over the group, in one
    ``all_reduce``."""
    if group.size == 1:
        return
    params = list(model.parameters())
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in params])
    dist.all_reduce(flat, group=group.pg)
    i = 0
    for p in params:
        n = p.numel()
        p.grad = flat[i : i + n].view_as(p).clone()
        i += n


def lm_chunk_sharding(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """The placement rule for the LM steps' token inputs: ``place(tokens)``
    takes the group's whole ``(..., B, T)`` batch (a ``(K, B, T)`` chunk
    for :func:`make_lm_multi_step`) and returns what this rank's step is
    given, on the group's device: the whole rows under sequence
    parallelism (the step reads its columns), else this rank's rows."""

    def place(tokens: torch.Tensor) -> torch.Tensor:
        if not sequence_parallel:
            b = tokens.shape[-2]
            if b % group.size:
                raise ValueError(f"batch {b} does not divide over the group's {group.size} ranks")
            n = b // group.size
            tokens = tokens[..., group.local_rank * n : (group.local_rank + 1) * n, :]
        return tokens.to(group.device)

    return place


def create_lm_state(group: TrialGroup, model: torch.nn.Module, lr: float) -> TrainState:
    """Place ``model`` (already initialised, e.g. by
    :func:`models.transformer.init_lm_params`) on the group's device with
    an Adam optimizer; on a multi-rank group, wrap it in DDP. The LM's
    steps stay eager, so its optimizer is torch's default (not capturable)
    on every device."""
    return create_train_state(group, model, lr, capturable=False)


def _build_lm_step_fn(group: TrialGroup, sequence_parallel: bool) -> Callable:
    """The one copy of the LM optimizer step shared by the single-step and
    multi-step factories."""
    _require_trainable(group)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        _check_layout(group, state.model, sequence_parallel)
        state.optimizer.zero_grad(set_to_none=True)
        if sequence_parallel:
            # Not through DDP: the gradients are summed below.
            cols = _sequence_columns(group, tokens)
            out = state.model(tokens[:, cols])
            lm = lm_loss_share(_logits(out), tokens, cols)
            aux_scale = 1
        else:
            out = state.module(tokens)
            lm = lm_loss_mean(_logits(out), tokens)
            # DDP averages; the aux's gradient flows through this rank's gates only.
            aux_scale = group.size
        loss = lm
        if isinstance(out, tuple):
            loss = loss + AUX_LOSS_WEIGHT * aux_scale * out[1]
        loss.backward()
        if sequence_parallel:
            _sum_grads(group, state.model)
        state.optimizer.step()
        state.step += 1
        lm = lm.detach().float()
        logged = _group_sum(group, lm) if sequence_parallel else _group_mean(group, lm)
        if isinstance(out, tuple):
            logged = logged + AUX_LOSS_WEIGHT * out[1].detach()
        return state, {"loss": logged}

    return step_fn


def make_lm_train_step(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """``step(state, tokens) -> (state, {"loss"})``. ``tokens`` is this
    rank's ``(rows, T)`` int batch, or under ``sequence_parallel`` the
    group's whole ``(B, T)`` rows (:func:`lm_chunk_sharding`). ``loss`` is
    a 0-d f32 tensor left on the device: the group's loss before the
    update (with ``AUX_LOSS_WEIGHT`` times the MoE LM's aux)."""
    return _build_lm_step_fn(group, sequence_parallel)


def make_lm_multi_step(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """K chained LM steps: ``multi(state, token_chunks)`` with
    ``token_chunks`` ``(K, rows, T)`` (``(K, B, T)`` under
    ``sequence_parallel``); ``metrics["loss"]`` is ``(K,)``. A Python loop
    over :func:`make_lm_train_step`'s body."""
    step_fn = _build_lm_step_fn(group, sequence_parallel)

    def multi_fn(state: TrainState, token_chunks: torch.Tensor):
        losses = []
        for k in range(token_chunks.shape[0]):
            state, metrics = step_fn(state, token_chunks[k])
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return multi_fn


def make_lm_eval_step(group: TrialGroup, *, sequence_parallel: bool = False) -> Callable:
    """``eval(state, tokens) -> {"loss", "perplexity"}``: the next-token
    objective with no gradient (no aux), the group's mean; ``tokens`` as
    for :func:`make_lm_train_step`."""
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")

    def eval_fn(state: TrainState, tokens: torch.Tensor) -> dict:
        _check_layout(group, state.model, sequence_parallel)
        with torch.no_grad():
            if sequence_parallel:
                cols = _sequence_columns(group, tokens)
                loss = _group_sum(group, lm_loss_share(_logits(state.model(tokens[:, cols])), tokens, cols).float())
            else:
                loss = _group_mean(group, lm_loss_mean(_logits(state.model(tokens)), tokens).float())
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
                logits = _logits(state.model(buf))[:, i - 1]
                buf[:, i] = _sample_token(logits, generator, temperature, top_k, top_p).to(buf.dtype)
        return buf

    return sample_fn
