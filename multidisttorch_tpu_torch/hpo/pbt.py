"""Population-based training of VAEs and their families: per group and
fused over lanes.

Counterpart of ``multidisttorch_tpu/hpo/pbt.py`` (its ``docs/PBT.md``
holds the protocol). ``run_pbt(cfg, train, eval)`` runs synchronous
generations of ``steps_per_generation`` train steps; after each, every
member scores the whole eval set, the bottom ``n_exploit_for(cfg)``
members copy the top ones' weights, Adam moments and step counts when
strictly worse, and take the source's lr times a factor from
``cfg.perturb_factors``.

**Per group** (``fused=False``): one member per trial group, each a
one-lane stacked state (the stacked step and eval of ``train/steps.py`` at
width 1, a CUDA graph per member on a card). The exchange is decided on
the host. With one process per device, each process builds the members
of the groups it holds; the scores are gathered with one ``all_gather``
per generation, and an exploit whose target's owners do not own the
source moves the winner's state with one ``broadcast`` of a flat buffer.

**Fused** (``fused=True``): the population is the lane axis of one stacked
state on one group, and a generation (S train steps, the eval, the
exchange) is one replay of one CUDA graph on a card
(``train/steps.py::make_pbt_generation_step``), with one host fetch of
the books per generation.

Both modes follow one seeding contract, so on the CPU they give the same
bits for the VAE (a family's fused lanes run other products than its
per-group members, grouped convolutions and batched einsums, and round
differently):

- member/lane k's weights: ``init_vae_params(seed + k)`` (a family's
  ``init_params(seed + k)``);
- its noise: a ``torch.Generator`` seeded ``seed + k + 1`` (on group rank
  ``r`` of a multi-rank group, ``seed + k + 1 + r * 2**32``); the JAX
  package folds ``key(seed + k + 1)`` with the step, which torch cannot
  reproduce (ROADMAP C.14);
- its data order: ``epoch_permutation(seed + k, epoch)``, as the JAX
  package's;
- the initial lrs: log-uniform from ``np.random.default_rng(seed)``, f32;
- the explore factor for (generation, lane): the JAX package's threefry
  draw, written out in numpy (``hpo/_threefry.py``), so the factors, and
  the lrs wherever the scores rank alike, are the JAX package's bits.

``model_builder(cfg)`` swaps the model family, as in the JAX package. Per
group, each member is then the family's model in an unstacked
``TrainState`` (:class:`_FamilyMember`: ``make_multi_step``, a CUDA graph
on a one-rank card group, and ``make_eval_step`` over the staged eval set);
fused, the lanes are the family's stacked form
(``models/vae.py::LaneStacked``, built by ``create_stacked_train_state``
from the first lane's family), through the same generation step and lane
ELBO kernels as the VAE's. Member/lane k is initialised by the family's
``init_params(seed + k)``, with the same noise, data and lr contract. A
family's fused program bypasses the compile registry, as in the JAX
package (the registry's keys name only the VAE's widths), and is captured
at its first generation.

Not ported here, left out as named: the compile registry's ``pbt_gen``
admission (A.9: the graph table is per generation step).

Telemetry: each generation emits the JAX package's ``pbt_gen`` (population
statistics) and one ``pbt_exploit`` per exchange edge, which
``telemetry/export.py::SweepFold`` folds into its population view. The
fused mode reads them from the generation's one host fetch
(``fetch_pbt_books``), adding no sync.

Both modes take their chunks from ``StackedTrialDataIterator.stream_chunks``
with the feed's defaults (``data/sampler.py``): the native gatherer and the
prefetch thread, which gathers and copies the next chunks while the card
runs.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multidisttorch_tpu_torch import telemetry as _telemetry
from multidisttorch_tpu_torch.data.datasets import Dataset
from multidisttorch_tpu_torch.data.sampler import EvalDataIterator, StackedTrialDataIterator, _local_rows, _to_device
from multidisttorch_tpu_torch.hpo._threefry import pbt_explore_key, pbt_perturb_factor, pbt_perturb_factors
from multidisttorch_tpu_torch.models.vae import VAE, StackedVAE, init_vae_params
from multidisttorch_tpu_torch.parallel.cluster import process_world
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, default_groups, setup_groups
from multidisttorch_tpu_torch.telemetry.events import get_bus
from multidisttorch_tpu_torch.train.checkpoint import _adam_state
from multidisttorch_tpu_torch.train.steps import (
    StackedTrainState,
    TrainState,
    TrialHypers,
    create_stacked_train_state,
    create_train_state,
    fetch_pbt_books,
    make_eval_step,
    make_multi_step,
    make_pbt_generation_step,
    make_stacked_eval_scan,
    make_stacked_multi_step,
)
from multidisttorch_tpu_torch.utils.logging import log0


@dataclass(frozen=True)
class PBTConfig:
    population: int = 4
    generations: int = 5
    steps_per_generation: int = 30
    batch_size: int = 64
    lr_min: float = 1e-4
    lr_max: float = 1e-2
    beta: float = 1.0
    exploit_fraction: float = 0.25  # bottom q exploits top q
    perturb_factors: tuple[float, float] = (0.8, 1.25)
    seed: int = 0
    hidden_dim: int = 400
    latent_dim: int = 20


@dataclass
class PBTResult:
    best_member: int
    best_eval_loss: float
    history: list = field(default_factory=list)  # per-generation dicts
    final_lrs: list = field(default_factory=list)
    wall_s: float = 0.0
    mode: str = "submesh"
    # program_calls: graph replays and eager calls; host_transfers: states
    # moved by a broadcast between processes; device_copies: states copied
    # between groups of this process; host_fetches: device-to-host syncs;
    # generation_s: each generation's wall time.
    dispatch_book: dict = field(default_factory=dict)
    # Per-member final states (``_lane_state``) when
    # run_pbt(return_states=True); None for a member another process holds.
    final_states: Optional[list] = None


def n_exploit_for(cfg: PBTConfig) -> int:
    """The exploit slot count: ``floor(exploit_fraction * K)`` floored at
    1, clamped to ``K // 2`` so that the top and bottom slices never
    overlap; K=1 clamps to 0, no exchange."""
    n = max(1, int(np.floor(cfg.exploit_fraction * cfg.population)))
    return min(n, cfg.population // 2)


def _set_lr(state: TrainState, lr: float, multi_step=None) -> TrainState:
    """Set an unstacked trial's optimizer lr. A CUDA graph of Adam's
    ``capturable`` update holds the Python-float lr it was captured with,
    so the state's graphs in ``multi_step`` (a ``GraphedMultiStep``) are
    dropped and its next chunk is captured anew."""
    for g in state.optimizer.param_groups:
        g["lr"] = float(lr)
    if multi_step is not None and multi_step.graphed:
        multi_step.drop(state.optimizer)
    return state


def _init_lrs(cfg: PBTConfig) -> np.ndarray:
    """The population's initial log-uniform lrs, f32, from
    ``np.random.default_rng(seed)``: the JAX package's draw."""
    rng = np.random.default_rng(cfg.seed)
    return np.exp(rng.uniform(np.log(cfg.lr_min), np.log(cfg.lr_max), cfg.population)).astype(np.float32)


def _rank(sums: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The host ranking, the device exchange's to the bit: NaN as +inf, a
    stable ascending argsort (ties by lane). Returns ``(order,
    sanitized)``."""
    sanitized = np.asarray(sums, np.float32).copy()
    sanitized[np.isnan(sanitized)] = np.inf
    return np.argsort(sanitized, kind="stable"), sanitized


def _emit_generation(mode: str, gen: int, scores: np.ndarray, order: np.ndarray, lrs: np.ndarray, exploits: list,
                     prev_order: Optional[np.ndarray], global_step: int) -> None:
    """The ``pbt_*`` telemetry seam (nothing when off), as in the JAX
    package: one ``pbt_gen`` per generation with the population's
    statistics (best/median loss, exploit count, rank churn, lr quantiles),
    one ``pbt_exploit`` per exchange edge."""
    bus = get_bus()
    if bus is None:
        return
    k = len(order)
    finite = scores[np.isfinite(scores)]
    data = dict(
        generation=gen,
        mode=mode,
        population=k,
        best_lane=int(order[0]),
        best_loss=float(scores[order[0]]),
        median_loss=float(np.median(finite)) if finite.size else None,
        exploit_count=len(exploits),
        lr_min=float(np.min(lrs)),
        lr_median=float(np.median(lrs)),
        lr_max=float(np.max(lrs)),
    )
    if prev_order is not None:
        # Rank churn: the fraction of lanes whose rank position changed.
        data["rank_churn"] = round(float(np.mean(order != prev_order)), 4)
    bus.emit("pbt_gen", step=global_step, **data)
    for e in exploits:
        bus.emit("pbt_exploit", step=global_step, lane=e["to"], generation=gen, mode=mode, src=e["from"],
                 dst=e["to"], new_lr=e["new_lr"], src_loss=float(scores[e["from"]]),
                 dst_loss=float(scores[e["to"]]))


def _noise_seed(seed: int, member: int, local_rank: int) -> int:
    """Member ``member``'s noise generator seed on group rank
    ``local_rank``: ``seed + member + 1`` on rank 0, and a stream of its
    own on each other rank."""
    return seed + member + 1 + (local_rank << 32)


def _init_model(cfg: PBTConfig, seed: int, model_builder=None):
    """Member ``seed - cfg.seed``'s initial model: the VAE, or
    ``model_builder``'s family initialised by its ``init_params(seed)``."""
    if model_builder is None:
        return init_vae_params(VAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim), seed)
    return model_builder(cfg).init_params(seed)


def _stage_eval_host(eval_data: Dataset, group: TrialGroup, batch_size: int) -> tuple[np.ndarray, np.ndarray, int]:
    """The full pad-and-mask eval set, host-side, once: ``(E, B, ...)``
    images, ``(E, B)`` weights and the real row count."""
    it = EvalDataIterator(eval_data, group, batch_size)
    imgs, weights = zip(*it.host_batches())
    return np.stack(imgs).astype(np.float32, copy=False), np.stack(weights), it.num_rows


def _place_eval(group: TrialGroup, stacked: np.ndarray, w: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of a staged eval set on the group's device, once:
    every generation scores it there."""
    return (_to_device(_local_rows(stacked, group, axis=1), group.device),
            _to_device(_local_rows(w, group, axis=1), group.device))


def _state_tensors(state: StackedTrainState) -> list[torch.Tensor]:
    """What an exploit copies: every stacked parameter, both Adam moments
    and the step count."""
    return [*state.model.parameters(), *state.exp_avg, *state.exp_avg_sq, state.count]


def _lane_state(state: StackedTrainState, k: int) -> dict:
    """Lane ``k``'s state as host copies: ``params`` (a state dict of the
    lanes' family),
    ``exp_avg``, ``exp_avg_sq`` (lists) and ``count``."""
    return {
        "params": {name: v.detach()[k].cpu().clone() for name, v in state.model.state_dict().items()},
        "exp_avg": [t[k].cpu().clone() for t in state.exp_avg],
        "exp_avg_sq": [t[k].cpu().clone() for t in state.exp_avg_sq],
        "count": float(state.count[k]),
    }


def _new_book() -> dict:
    return {"program_calls": 0, "graph_replays": 0, "host_transfers": 0, "device_copies": 0, "host_fetches": 0,
            "generation_s": []}


class _Member:
    """One per-group population member: a one-lane stacked state, trained
    by the stacked multi-step (a CUDA graph on a one-rank card group) and
    scored by the stacked eval, as the fused lanes are."""

    def __init__(self, group: TrialGroup, member_id: int, cfg: PBTConfig, train_data: Dataset,
                 eval_host: tuple[np.ndarray, np.ndarray], lr: float):
        self.group = group
        self.member_id = member_id
        seed = cfg.seed + member_id
        dev = group.device
        self.state = create_stacked_train_state(group, [_init_model(cfg, seed)])
        self.hypers = TrialHypers.stack([lr], [cfg.beta], device=dev)
        self.generators = [torch.Generator(device=dev).manual_seed(_noise_seed(cfg.seed, member_id, group.local_rank))]
        self.multi_step = make_stacked_multi_step(group)
        self.eval_scan = make_stacked_eval_scan(group)
        self._chunks = StackedTrialDataIterator(train_data, group, cfg.batch_size, [seed]).stream_chunks(
            cfg.steps_per_generation)
        self.eval_batches, self.eval_weights = _place_eval(group, *eval_host)

    def run_generation(self, book: dict) -> None:
        """One generation's S train steps on the member's next chunk."""
        replays = self.multi_step.replays
        self.state, _ = self.multi_step(self.state, self.hypers, next(self._chunks), generators=self.generators)
        book["program_calls"] += 1
        book["graph_replays"] += self.multi_step.replays - replays

    def eval_loss_sum(self, book: dict) -> np.float32:
        """The summed masked eval loss over the whole eval set (f32, the
        rank statistic): one eval call, one host fetch."""
        out = self.eval_scan(self.state, self.hypers, self.eval_batches, self.eval_weights)["loss_sum"]
        book["program_calls"] += 1
        book["host_fetches"] += 1
        return np.float32(out.cpu().numpy()[0])

    def set_lr(self, lr: np.float32) -> None:
        self.hypers.lr[0] = float(lr)  # in place: the member's graph reads it

    def copy_from(self, other: "_Member") -> None:
        with torch.no_grad():
            for dst, src in zip(_state_tensors(self.state), _state_tensors(other.state)):
                dst.copy_(src)

    def flat(self) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1) for t in _state_tensors(self.state)])

    def load_flat(self, buf: torch.Tensor) -> None:
        _load_flat(_state_tensors(self.state), buf)

    def final_state(self) -> dict:
        return _lane_state(self.state, 0)


def _load_flat(tensors: list, buf: torch.Tensor) -> None:
    with torch.no_grad():
        i = 0
        for t in tensors:
            t.copy_(buf[i : i + t.numel()].view_as(t))
            i += t.numel()


class _FamilyMember:
    """One per-group member of a ``model_builder`` family: the family's
    model in an unstacked ``TrainState``, trained by ``make_multi_step`` (a
    CUDA graph on a one-rank card group) on lane 0 of a one-lane stacked
    stream (the VAE member's data), and scored by ``make_eval_step`` over the
    staged eval set, the batch sums added in order in f32 as the stacked
    eval adds them. An exploit copies the parameters, Adam's moments and
    step counts in place, and an lr change drops the member's graphs
    (:func:`_set_lr`)."""

    def __init__(self, group: TrialGroup, member_id: int, cfg: PBTConfig, model_builder, train_data: Dataset,
                 eval_host: tuple[np.ndarray, np.ndarray], lr: float):
        self.group = group
        self.member_id = member_id
        seed = cfg.seed + member_id
        self.state = create_train_state(group, _init_model(cfg, seed, model_builder), lr)
        self.generator = torch.Generator(device=group.device).manual_seed(
            _noise_seed(cfg.seed, member_id, group.local_rank))
        self.multi_step = make_multi_step(group, beta=cfg.beta)
        self.eval_step = make_eval_step(group, beta=cfg.beta, with_recon=False)
        self._chunks = StackedTrialDataIterator(train_data, group, cfg.batch_size, [seed]).stream_chunks(
            cfg.steps_per_generation)
        self.eval_batches, self.eval_weights = _place_eval(group, *eval_host)

    def run_generation(self, book: dict) -> None:
        replays = self.multi_step.replays
        self.state, _ = self.multi_step(self.state, next(self._chunks)[:, 0], generator=self.generator)
        book["program_calls"] += 1
        book["graph_replays"] += self.multi_step.replays - replays

    def eval_loss_sum(self, book: dict) -> np.float32:
        total = None
        for batch, weights in zip(self.eval_batches, self.eval_weights):
            s = self.eval_step(self.state, batch, weights)["loss_sum"]
            total = s if total is None else total + s
        book["program_calls"] += len(self.eval_batches)
        book["host_fetches"] += 1
        return np.float32(total.cpu().numpy())

    def set_lr(self, lr: np.float32) -> None:
        _set_lr(self.state, float(lr), self.multi_step)

    def _tensors(self) -> list[torch.Tensor]:
        params = list(self.state.model.parameters())
        adam = [_adam_state(self.state.optimizer, p) for p in params]
        return [*params, *(st["exp_avg"] for st in adam), *(st["exp_avg_sq"] for st in adam),
                *(st["step"] for st in adam)]

    @staticmethod
    def flat_size(model: torch.nn.Module) -> int:
        """Floats in a member's flat state: parameters, two moments, a step
        count per parameter."""
        return sum(3 * p.numel() + 1 for p in model.parameters())

    def copy_from(self, other: "_FamilyMember") -> None:
        with torch.no_grad():
            for dst, src in zip(self._tensors(), other._tensors()):
                dst.copy_(src)
        self.state.step = other.state.step

    def flat(self) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1).to(self.group.device) for t in self._tensors()])

    def load_flat(self, buf: torch.Tensor) -> None:
        _load_flat(self._tensors(), buf)

    def final_state(self) -> dict:
        params = list(self.state.model.parameters())
        adam = [_adam_state(self.state.optimizer, p) for p in params]
        return {
            "params": {k: v.detach().cpu().clone() for k, v in self.state.model.state_dict().items()},
            "exp_avg": [st["exp_avg"].cpu().clone() for st in adam],
            "exp_avg_sq": [st["exp_avg_sq"].cpu().clone() for st in adam],
            "count": float(adam[0]["step"]),
        }


def _flat_size(cfg: PBTConfig, input_dim: int) -> int:
    """Floats in one member's flat state: parameters, two moments, count."""
    return 3 * sum(p.numel() for p in StackedVAE(1, input_dim, cfg.hidden_dim, cfg.latent_dim).parameters()) + 1


def _world_device() -> torch.device:
    """Where a world collective's tensors live: the CPU under gloo, this
    process's card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather_sums(local: np.ndarray) -> np.ndarray:
    """Every process's ``(K,)`` sums (``+inf`` where it holds no member)
    gathered, and the minimum taken on the host with numpy, where a NaN
    stays NaN: a diverged member ranks last in every process. (A MIN
    all-reduce does not reliably carry NaN.)"""
    world, _ = process_world()
    t = torch.from_numpy(local).to(_world_device())
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts]).min(axis=0)


def run_pbt(
    cfg: PBTConfig,
    train_data: Dataset,
    eval_data: Dataset,
    *,
    groups: Optional[Sequence[TrialGroup]] = None,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    model_builder=None,
    fused: bool = False,
    return_states: bool = False,
    device=None,
) -> PBTResult:
    """Run synchronous-generation PBT.

    ``fused=False``: one member per group of ``groups`` (default: one per
    rank block in a multi-process world, else ``population`` slots on
    ``device``), the exchange decided on the host; every process tracks
    every member's score and lr, so the decisions are the same everywhere.
    ``fused=True``: the population as K lanes of one stacked state on the
    one group of ``groups`` (default: ``setup_groups(1, device=device)``),
    one graph replay per generation on a card. ``device`` is the card
    unless ``"cpu"`` is asked for. ``return_states=True`` attaches each
    member's final state (the parity surface). ``model_builder(cfg)``
    swaps the model family, in both modes (module docstring).
    """
    _telemetry.configure_from_env()
    if fused:
        return _run_pbt_fused(cfg, train_data, eval_data, groups=groups, out_dir=out_dir, verbose=verbose,
                              model_builder=model_builder, return_states=return_states, device=device)
    world, rank = process_world()
    if groups is None:
        groups = default_groups(cfg.population, device)
    if len(groups) != cfg.population:
        raise ValueError(f"population {cfg.population} but {len(groups)} trial groups")
    K = cfg.population
    lrs = _init_lrs(cfg)  # every process draws the same
    eval_imgs, eval_w, num_rows = _stage_eval_host(eval_data, groups[0], cfg.batch_size)
    members = {i: (_Member(g, i, cfg, train_data, (eval_imgs, eval_w), float(lrs[i])) if model_builder is None
                   else _FamilyMember(g, i, cfg, model_builder, train_data, (eval_imgs, eval_w), float(lrs[i])))
               for i, g in enumerate(groups) if g.is_local_member}
    n_flat = 0
    if world > 1:
        n_flat = (_flat_size(cfg, int(train_data.images.shape[1])) if model_builder is None
                  else _FamilyMember.flat_size(model_builder(cfg)))
    n_exploit = n_exploit_for(cfg)
    explore_key = pbt_explore_key(cfg.seed)
    book = _new_book()
    # "submesh": the JAX package's name for this mode, kept so that both
    # packages' pbt.json read alike.
    result = PBTResult(best_member=-1, best_eval_loss=float("inf"), mode="submesh")
    t0 = time.time()
    prev_order = None

    for gen in range(cfg.generations):
        tg = time.perf_counter()
        for m in members.values():
            m.run_generation(book)
        local = np.full(K, np.inf, np.float32)
        for i, m in members.items():
            local[i] = m.eval_loss_sum(book)
        sums = _gather_sums(local) if world > 1 else local
        scores = sums.astype(np.float64) / num_rows
        order, sanitized = _rank(sums)
        lrs_before = lrs.copy()
        exploits = []
        # Bottom slot i copies top slot i iff strictly worse; decisions
        # come from the gathered scores and the factors from the pure
        # (seed, generation, lane) draw, so every process decides alike.
        top = order[:n_exploit]
        bottom = order[K - n_exploit:] if n_exploit else []
        for i, bad_id in enumerate(bottom):
            bad_id, good_id = int(bad_id), int(top[i])
            if not sanitized[bad_id] > sanitized[good_id]:
                continue
            factor = pbt_perturb_factor(explore_key, gen, bad_id, cfg.perturb_factors)
            new_lr = np.float32(np.clip(np.float32(lrs[good_id]) * factor, np.float32(cfg.lr_min),
                                        np.float32(cfg.lr_max)))
            good, bad = groups[good_id], groups[bad_id]
            if world > 1 and not set(bad.global_ranks) <= set(good.global_ranks):
                # The target's owners do not all hold the source: its first
                # rank broadcasts the state to the world.
                src_rank = good.global_ranks[0]
                buf = (members[good_id].flat().to(_world_device()) if rank == src_rank
                       else torch.empty(n_flat, dtype=torch.float32, device=_world_device()))
                dist.broadcast(buf, src=src_rank)
                book["host_transfers"] += 1
                if bad_id in members:
                    members[bad_id].load_flat(buf.to(bad.device))
            elif bad_id in members:
                members[bad_id].copy_from(members[good_id])
                book["device_copies"] += 1
            if bad_id in members:
                members[bad_id].set_lr(new_lr)
            lrs[bad_id] = new_lr
            exploits.append({"from": good_id, "to": bad_id, "new_lr": float(new_lr)})
            if verbose and bad_id in members:
                log0(f"PBT gen {gen}: member {bad_id} (loss {scores[bad_id]:.2f}) exploits {good_id} "
                     f"(loss {scores[good_id]:.2f}), lr -> {float(new_lr):.2e}", trial=bad)
        book["generation_s"].append(time.perf_counter() - tg)
        _emit_generation("submesh", gen, scores, order, lrs, exploits, prev_order,
                         (gen + 1) * cfg.steps_per_generation)
        prev_order = order
        _record_generation(result, gen, sums, scores, order, lrs_before, exploits)

    final_states = ([members[i].final_state() if i in members else None for i in range(K)]
                    if return_states else None)
    _finish_run(result, cfg, book, lrs, t0, out_dir, final_states)
    return result


def _admit_fused_program(group: TrialGroup, cfg: PBTConfig, n_exploit: int, eval_batches: int, owner,
                         family: bool = False):
    """The fused generation's program from the process's registry
    (``compile/registry.py``; the JAX package's ``_admit_fused_program``):
    a slot of the population's key, taken (``cache_hit``) or captured
    inline on its first admission (one capture per program in the
    process). Returns ``(slot, key)``; ``(None, None)`` outside the
    registry's envelope (a ``model_builder`` family, whose widths the key
    does not name, as the JAX package's policy; a multi-rank group,
    several processes, ``MDT_AOT_ADMISSION=0``) or when the key is
    ``FAILED``, where the run builds its own generation step (captured at
    its first call on a card; a failed capture raises). The third value
    says whether this call captured the slot."""
    from multidisttorch_tpu_torch.compile import programs as _cprog
    from multidisttorch_tpu_torch.compile.registry import READY, get_executable_registry

    if (family or group.size != 1 or process_world()[0] != 1
            or os.environ.get("MDT_AOT_ADMISSION", "1") == "0"):
        return None, None, False
    key = _cprog.pbt_gen_key(group, _cprog.bucket_key_of(cfg), lanes=cfg.population,
                             steps_per_generation=cfg.steps_per_generation, eval_batches=eval_batches,
                             n_exploit=n_exploit, perturb_factors=cfg.perturb_factors, lr_min=cfg.lr_min,
                             lr_max=cfg.lr_max)
    reg = get_executable_registry()
    slot, captured = reg.take(key, owner), False
    if slot is None and reg.claim(key):
        e = reg.compile_now(key, lambda: _cprog.build_pbt_slot(group, cfg, key, eval_batches=eval_batches,
                                                                n_exploit=n_exploit, ahead=False), owner=owner)
        if e.status == READY and e.owner is owner:
            slot, captured = e.compiled, True
    return (slot, key, captured) if slot is not None else (None, None, False)


def _take_fused_again(key: Optional[tuple], owner) -> None:
    """Generation 2 onward: take the run's slot again, so that the books
    (the hit count, ``cache_hit``) show every generation reusing the one
    captured program."""
    if key is not None:
        from multidisttorch_tpu_torch.compile.registry import get_executable_registry

        get_executable_registry().take(key, owner)


def _run_pbt_fused(
    cfg: PBTConfig,
    train_data: Dataset,
    eval_data: Dataset,
    *,
    groups: Optional[Sequence[TrialGroup]] = None,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    model_builder=None,
    return_states: bool = False,
    device=None,
) -> PBTResult:
    """The fused mode's body (call it through ``run_pbt(fused=True)``)."""
    if groups is None:
        groups = setup_groups(1, device=device)
    if len(groups) != 1:
        raise ValueError(
            f"fused PBT runs the whole population as lanes of one group; got {len(groups)} groups "
            "(carve one, e.g. setup_groups(1))")
    group = groups[0]
    K, S = cfg.population, cfg.steps_per_generation
    dev = group.device
    n_exploit = n_exploit_for(cfg)
    seeds = [cfg.seed + k for k in range(K)]
    lrs = _init_lrs(cfg)
    state = create_stacked_train_state(group, [_init_model(cfg, s, model_builder) for s in seeds])
    hypers = TrialHypers.stack([float(v) for v in lrs], [cfg.beta] * K, device=dev)
    generators = [torch.Generator(device=dev).manual_seed(_noise_seed(cfg.seed, k, group.local_rank))
                  for k in range(K)]
    chunks = StackedTrialDataIterator(train_data, group, cfg.batch_size, seeds).stream_chunks(S)
    eval_imgs, eval_w, num_rows = _stage_eval_host(eval_data, group, cfg.batch_size)
    eval_batches, eval_weights = _place_eval(group, eval_imgs, eval_w)
    owner = object()
    slot, prog_key, captured = _admit_fused_program(group, cfg, n_exploit, eval_batches.shape[0], owner,
                                                    family=model_builder is not None)
    # This run's captures: the slot's own when it captured it here.
    captures0 = 0 if slot is None or captured else slot.step.captures
    if slot is not None:
        # The population, by value, in the slot's tensors: its graph holds them.
        slot.bind(state, hypers, generators, eval_batches, eval_weights)
        state, hypers, generators = slot.state, slot.hypers, slot.generators
        eval_batches, eval_weights, factors, gen_step = slot.eval_batches, slot.eval_weights, slot.factors, slot.step
    else:
        gen_step = make_pbt_generation_step(group, n_exploit=n_exploit, lr_min=cfg.lr_min, lr_max=cfg.lr_max)
        factors = torch.empty(K, dtype=torch.float32, device=dev)
    try:
        return _fused_generations(cfg, group, state, hypers, generators, chunks, eval_batches, eval_weights,
                                  num_rows, factors, gen_step, n_exploit, lrs, captures0, prog_key, owner, out_dir,
                                  verbose, return_states)
    finally:
        if slot is not None:
            from multidisttorch_tpu_torch.compile.registry import get_executable_registry

            get_executable_registry().give_back(prog_key, owner)


def _fused_generations(cfg, group, state, hypers, generators, chunks, eval_batches, eval_weights, num_rows, factors,
                       gen_step, n_exploit, lrs, captures0, prog_key, owner, out_dir, verbose,
                       return_states) -> PBTResult:
    """The fused mode's generations, through ``gen_step``."""
    K, S = cfg.population, cfg.steps_per_generation
    explore_key = pbt_explore_key(cfg.seed)
    book = _new_book()
    result = PBTResult(best_member=-1, best_eval_loss=float("inf"), mode="fused")
    t0 = time.time()
    prev_order = None

    batches = next(chunks)
    for gen in range(cfg.generations):
        tg = time.perf_counter()
        if gen > 0:
            _take_fused_again(prog_key, owner)
        factors.copy_(torch.from_numpy(pbt_perturb_factors(explore_key, gen, K, cfg.perturb_factors)))
        lrs_before = lrs.copy()
        replays = gen_step.replays
        # One call: S train steps of K lanes, the eval and the exchange.
        packed = gen_step(state, hypers, batches, eval_batches, eval_weights, factors, generators)
        book["program_calls"] += 1
        book["graph_replays"] += gen_step.replays - replays
        if gen + 1 < cfg.generations:
            batches = next(chunks)  # gathered and copied ahead by the feed's thread
        host = fetch_pbt_books(packed, K)  # the generation's one host fetch
        book["host_fetches"] += 1
        sums, order, exploited, src = host["eval_loss_sum"], host["order"], host["exploited"], host["src"]
        lrs = host["new_lr"]
        scores = sums.astype(np.float64) / num_rows
        exploits = [
            {"from": int(src[lane]), "to": int(lane), "new_lr": float(lrs[lane])}
            # bottom slots in rank order: the per-group mode's order
            for lane in (order[K - n_exploit:] if n_exploit else [])
            if exploited[lane]
        ]
        if verbose:
            for e in exploits:
                log0(f"PBT gen {gen}: lane {e['to']} (loss {scores[e['to']]:.2f}) exploits {e['from']} "
                     f"(loss {scores[e['from']]:.2f}), lr -> {e['new_lr']:.2e}", trial=group)
        book["generation_s"].append(time.perf_counter() - tg)
        _emit_generation("fused", gen, scores, order, lrs, exploits, prev_order, (gen + 1) * S)
        prev_order = order
        _record_generation(result, gen, sums, scores, order, lrs_before, exploits)

    book["captures"] = gen_step.captures - captures0
    final_states = [_lane_state(state, k) for k in range(K)] if return_states else None
    _finish_run(result, cfg, book, lrs, t0, out_dir, final_states)
    return result


def _record_generation(result: PBTResult, gen: int, sums: np.ndarray, scores: np.ndarray, order: np.ndarray,
                       lrs_before: np.ndarray, exploits: list) -> None:
    """Append generation ``gen``'s record (the lrs it trained with) and
    keep the best member: both modes' books, so that their results match."""
    result.history.append({
        "generation": gen,
        "scores": {int(i): float(scores[i]) for i in order},
        "loss_sums": [float(s) for s in sums],
        "order": [int(i) for i in order],
        "lrs": {i: float(v) for i, v in enumerate(lrs_before)},
        "exploits": exploits,
    })
    best = int(order[0])
    if scores[best] < result.best_eval_loss:
        result.best_eval_loss = float(scores[best])
        result.best_member = best


def _finish_run(result: PBTResult, cfg: PBTConfig, book: dict, lrs: np.ndarray, t0: float,
                out_dir: Optional[str], final_states: Optional[list]) -> None:
    """Both modes' tail: wall time, final lrs, the books (``program_calls``
    counts graph replays and eager calls), the states and ``pbt.json``."""
    result.wall_s = time.time() - t0
    result.final_lrs = [float(v) for v in lrs]
    gens = max(1, cfg.generations)
    result.dispatch_book = dict(
        book,
        generations=cfg.generations,
        dispatches_per_generation=round(book["program_calls"] / gens, 3),
        transfers_per_generation=round(book["host_transfers"] / gens, 3),
    )
    result.final_states = final_states
    _write_report(result, out_dir)


def _write_report(result: PBTResult, out_dir: Optional[str]) -> None:
    """``{out_dir}/pbt.json``, the JAX package's keys, from process 0."""
    if not out_dir or process_world()[1] != 0:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "pbt.json"), "w") as f:
        json.dump(
            {
                "mode": result.mode,
                "best_member": result.best_member,
                "best_eval_loss": result.best_eval_loss,
                "final_lrs": result.final_lrs,
                "history": result.history,
                "wall_s": result.wall_s,
                "dispatch_book": result.dispatch_book,
            },
            f,
            indent=2,
        )
