"""Program keys and program slots: which captured step is this.

Counterpart of ``multidisttorch_tpu/compile/programs.py``. The JAX package
compiles a train program into an executable that holds no addresses, so
one executable serves any state of its shapes. A CUDA graph holds the
address of everything it touches: the parameters, the gradients (in its
private pool), the capturable optimizer's moments and device step count,
its static inputs and its registered generators
(``train/steps.py::_GraphedChunks``). So the port's registry entry is a
**program slot**: a state of the key's shapes (a model and a capturable
:class:`~multidisttorch_tpu_torch.train.adam.Adam`, or a stacked state
and its hypers), the generators the graphs draw from, and the step object
that holds the graphs, one per chunk length. A trial that takes a slot
is rebound to it **by value** (:meth:`SingleSlot.bind`): the slot copies
the trial's parameters, moments, step count and generator states into
its own tensors, and the trial trains through the slot's state from then
on. At the trial's end, or on its failure, the slot goes back to the
registry for the next trial with the same key.

The key vocabulary is the JAX package's:

- its **key** (:func:`single_train_key` and the others): the shape
  bucket, the scalar hypers a graph bakes in (the unstacked Adam's
  Python-float lr, and beta), and the group's fingerprint
  (:func:`mesh_fingerprint`: the group id, its ranks and the device), so
  twins on two groups never share a slot and a slot never serves two
  trials at once. Stacked keys carry the lane count instead of the
  hypers (``TrialHypers`` are device tensors, so one slot serves every
  bucket of that shape on that group);
- its **shape signature** (:func:`state_signature`, the JAX package's
  avals): the shapes and dtypes of the state a slot was built for, which
  :func:`avals_match` holds against a trial's state before the slot is
  taken;
- its **builder** (:func:`build_single_steps` and the others): the same
  step factories the driver calls.

``SINGLE_INIT`` names the JAX package's state-init program and has no
program here: the port's initial weights are eager host-side draws
(``models/vae.py::init_vae_params``, ROADMAP C.4), so nothing is captured
or compiled for them. The pipeline programs (``PIPE_*``) wait for ROADMAP
A.14.
"""

from __future__ import annotations

from typing import Any

import torch

from multidisttorch_tpu_torch.models.vae import VAE
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup
from multidisttorch_tpu_torch.train.steps import (
    StackedTrainState,
    TrainState,
    TrialHypers,
    create_stacked_train_state,
    create_train_state,
    make_multi_step,
    make_pbt_generation_step,
    make_stacked_multi_step,
)

# Program kinds: the first element of every key, and the ``program_kind``
# on every compile_* event.
SINGLE_TRAIN = "train"
SINGLE_MULTI = "multi"
SINGLE_INIT = "init"  # no program in the port (module docstring)
STACKED_TRAIN = "stacked_train"
STACKED_MULTI = "stacked_multi"
# One whole PBT generation (train chunk, eval and lane exchange).
PBT_GEN = "pbt_gen"

# The rows of the VAE's input (MNIST-shaped): every slot's batch width.
INPUT_DIM = 784


def mesh_fingerprint(group: TrialGroup) -> tuple:
    """What a slot is pinned to: the group's id, its global ranks and its
    device (the CUDA index on a card). Two groups of one shape on one card
    still differ: a slot's state is one trial's at a time."""
    dev = group.device
    return (int(group.group_id), tuple(int(r) for r in group.global_ranks),
            dev.type if dev.index is None else int(dev.index))


def single_train_key(group: TrialGroup, cfg, bucket_key: tuple) -> tuple:
    return (SINGLE_TRAIN, bucket_key, (float(cfg.lr), float(cfg.beta)), mesh_fingerprint(group))


def single_multi_key(group: TrialGroup, cfg, bucket_key: tuple) -> tuple:
    return (SINGLE_MULTI, bucket_key, (float(cfg.lr), float(cfg.beta)), mesh_fingerprint(group))


def single_key(group: TrialGroup, cfg, bucket_key: tuple) -> tuple:
    """The program a trial's first dispatch needs, as the JAX package
    picks its primary: the multi-step when ``fused_steps > 1``, else the
    train step (here a chunk of one)."""
    return (single_multi_key if cfg.fused_steps > 1 else single_train_key)(group, cfg, bucket_key)


def stacked_train_key(group: TrialGroup, bucket_key: tuple, lanes: int) -> tuple:
    return (STACKED_TRAIN, bucket_key, int(lanes), mesh_fingerprint(group))


def stacked_multi_key(group: TrialGroup, bucket_key: tuple, lanes: int) -> tuple:
    return (STACKED_MULTI, bucket_key, int(lanes), mesh_fingerprint(group))


def stacked_key(group: TrialGroup, template, bucket_key: tuple, lanes: int) -> tuple:
    """A stacked bucket's primary program (:func:`single_key`'s rule)."""
    return (stacked_multi_key if template.fused_steps > 1 else stacked_train_key)(group, bucket_key, lanes)


def pbt_gen_key(group: TrialGroup, bucket_key: tuple, *, lanes: int, steps_per_generation: int,
                eval_batches: int, n_exploit: int, perturb_factors, lr_min: float, lr_max: float) -> tuple:
    """The fused PBT generation's key: the population's protocol (lanes,
    steps, eval batches, exploit slots, the explore table and lr bounds),
    as the JAX package keys it; per-lane lr and beta stay out."""
    return (
        PBT_GEN,
        bucket_key,
        (int(lanes), int(steps_per_generation), int(eval_batches), int(n_exploit),
         tuple(float(f) for f in perturb_factors), float(lr_min), float(lr_max)),
        mesh_fingerprint(group),
    )


def program_label(key: tuple) -> str:
    """A short name for events, books and the console (e.g.
    ``stacked_multi:bs128-h400-z20-f10-K4@g0``): the bucket, the lane count
    or hypers, and the group. Never raises (an odd key gives its repr)."""
    try:
        return _program_label(key)
    except Exception:  # noqa: BLE001 — a label must never raise
        return repr(key)


def _program_label(key: tuple) -> str:
    kind, bucket, extra, mesh = key
    bs, hidden, latent, fused, grad_accum, remat = bucket
    sig = f"bs{bs}-h{hidden}-z{latent}-f{fused}"
    if grad_accum and grad_accum != 1:
        sig += f"-ga{grad_accum}"
    if remat:
        sig += "-rm"
    if kind in (STACKED_TRAIN, STACKED_MULTI):
        sig += f"-K{extra}"
    elif kind == PBT_GEN:
        lanes, spg, ebatches, n_exploit = extra[:4]
        sig += f"-K{lanes}-S{spg}-E{ebatches}-x{n_exploit}"
    else:
        lr, beta = extra
        sig += f"-lr{lr:g}"
        if beta != 1.0:
            sig += f"-b{beta:g}"
    return f"{kind}:{sig}@g{mesh[0]}"


def state_signature(state: Any) -> tuple:
    """The shapes and dtypes of a state's tensors (parameters, then Adam's
    moments): the port's avals."""
    if isinstance(state, StackedTrainState):
        tensors = [*state.model.parameters(), *state.exp_avg, *state.exp_avg_sq, state.count]
    else:
        tensors = list(state.model.parameters())
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def avals_match(signature: Any, state: Any) -> bool:
    """Whether ``state`` has the shapes a slot was built for. Never raises:
    a mismatch sends the trial down its own per-trial path."""
    try:
        return signature == state_signature(state)
    except Exception:  # noqa: BLE001 — a guard must never raise
        return False


# -- builders: the driver's own factory calls --------------------------------


def default_model(cfg) -> VAE:
    """The family the registry covers (a ``model_builder`` family keeps
    its per-trial graphs)."""
    return VAE(hidden_dim=cfg.hidden_dim, latent_dim=cfg.latent_dim)


def build_single_steps(group: TrialGroup, cfg) -> dict:
    """The unstacked trial's train chunks: the ``make_multi_step`` call
    ``hpo/driver.py::_TrialRun`` makes."""
    return {"multi": make_multi_step(group, beta=cfg.beta, grad_accum=cfg.grad_accum, remat=cfg.remat)}


def build_stacked_steps(group: TrialGroup, template) -> dict:
    """The stacked bucket's chunks: the ``make_stacked_multi_step`` call
    ``hpo/driver.py::_StackedBucketRun`` makes."""
    return {"multi": make_stacked_multi_step(group, grad_accum=template.grad_accum, remat=template.remat)}


def build_pbt_generation(group: TrialGroup, *, n_exploit: int, lr_min: float, lr_max: float):
    """The fused PBT generation: the call ``hpo/pbt.py``'s fused mode makes."""
    return make_pbt_generation_step(group, n_exploit=int(n_exploit), lr_min=float(lr_min), lr_max=float(lr_max))


# -- slots --------------------------------------------------------------------


def _copy_generator(dst: torch.Generator, src: torch.Generator) -> None:
    """``dst`` takes ``src``'s state (seed and offset on a card) in place:
    the object a graph registered keeps its identity."""
    dst.set_state(src.get_state())


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class _Slot:
    """What every slot has: its label, the step that holds its graphs, and
    what freeing it does."""

    label: str = ""
    step: Any = None

    @property
    def graphed(self) -> bool:
        return bool(getattr(self.step, "graphed", False))

    def free(self) -> None:
        """Release the graphs and their pools (an evicted or reset slot)."""
        free = getattr(self.step, "free", None)
        if free is not None:
            free()


class SingleSlot(_Slot):
    """One unstacked trial's program: a model and capturable Adam of the
    key's shapes and lr, a generator, and ``make_multi_step``'s step
    (:func:`build_single_steps`), whose graphs hold them."""

    def __init__(self, group: TrialGroup, cfg, label: str = ""):
        self.label = label
        self.group = group
        self.chunk = int(cfg.fused_steps)
        self.batch_size = int(cfg.batch_size)
        self.state = create_train_state(group, default_model(cfg), cfg.lr)
        self.state.optimizer.init_state()
        self.generator = torch.Generator(device=group.device)
        self.step = build_single_steps(group, cfg)["multi"]
        if self.graphed:
            self.step.program = label

    def capture_ahead(self) -> None:
        """Capture the chunk the trial's first dispatch runs, on scratch
        state (no step of any trial is trained); a no-op where the step is
        eager."""
        if self.graphed:
            batches = torch.full((self.chunk, self.batch_size, INPUT_DIM), 0.5, device=self.group.device)
            self.step.prepare(self.state, batches, generator=self.generator)

    def signature(self) -> tuple:
        return state_signature(self.state)

    def nbytes(self) -> int:
        """The bytes of the slot's state (parameters and Adam's state)."""
        opt = self.state.optimizer.state
        return _tensor_bytes(self.state.model.parameters()) + sum(
            _tensor_bytes(st.values()) for st in opt.values())

    def bind(self, state: TrainState, generator: torch.Generator) -> TrainState:
        """The trial's state, by value, in the slot's tensors: its
        parameters, Adam's moments and step counts (zero where it has no
        optimizer state yet, as a fresh optimizer), and ``generator``'s
        state in the slot's generator. Returns a :class:`TrainState` over
        the slot's model and optimizer at the trial's step."""
        src_opt = state.optimizer.state
        with torch.no_grad():
            for p, q in zip(self.state.model.parameters(), state.model.parameters()):
                p.copy_(q)
                p.grad = None
                dst = self.state.optimizer.state[p]
                src = src_opt.get(q)
                for name in ("exp_avg", "exp_avg_sq", "step"):
                    if src:
                        dst[name].copy_(src[name])
                    else:
                        dst[name].zero_()
        _copy_generator(self.generator, generator)
        return TrainState(model=self.state.model, optimizer=self.state.optimizer, step=state.step)


class StackedSlot(_Slot):
    """A stacked bucket's program on one group: a stacked state of K lanes,
    its hypers, K generators and ``make_stacked_multi_step``'s step."""

    def __init__(self, group: TrialGroup, template, lanes: int, label: str = ""):
        self.label = label
        self.group = group
        self.chunk = int(template.fused_steps)
        self.batch_size = int(template.batch_size)
        self.lanes = int(lanes)
        dev = group.device
        self.state = create_stacked_train_state(group, [default_model(template) for _ in range(lanes)])
        self.hypers = TrialHypers.stack([template.lr] * lanes, [template.beta] * lanes, device=dev)
        self.generators = [torch.Generator(device=dev) for _ in range(lanes)]
        self.step = build_stacked_steps(group, template)["multi"]
        if self.graphed:
            self.step.program = label

    def capture_ahead(self) -> None:
        if self.graphed:
            batches = torch.full((self.chunk, self.lanes, self.batch_size, INPUT_DIM), 0.5,
                                 device=self.group.device)
            self.step.prepare(self.state, self.hypers, batches, generators=self.generators)

    def signature(self) -> tuple:
        return state_signature(self.state)

    def bind(self, state: StackedTrainState, hypers: TrialHypers, generators) -> None:
        """A bucket's lanes, hypers and generator states, by value, in the
        slot's tensors; the bucket then trains through :attr:`state`,
        :attr:`hypers` and :attr:`generators`."""
        _copy_stacked(self.state, self.hypers, state, hypers)
        for dst, src in zip(self.generators, generators):
            _copy_generator(dst, src)


def _copy_stacked(dst: StackedTrainState, dhypers: TrialHypers, src: StackedTrainState,
                  shypers: TrialHypers) -> None:
    with torch.no_grad():
        for p, q in zip(dst.model.parameters(), src.model.parameters()):
            p.copy_(q)
            p.grad = None
        for a, b in zip(dst.exp_avg + dst.exp_avg_sq, src.exp_avg + src.exp_avg_sq):
            a.copy_(b)
        dst.count.copy_(src.count)
        dhypers.lr.copy_(shypers.lr)
        dhypers.beta.copy_(shypers.beta)
        dhypers.active.copy_(shypers.active)


class PBTSlot(_Slot):
    """The fused PBT generation's program: a stacked state of the
    population, its hypers and generators, the eval set's static tensors,
    the explore factors' and :func:`build_pbt_generation`'s step."""

    def __init__(self, group: TrialGroup, cfg, *, eval_batches: int, n_exploit: int, label: str = ""):
        self.label = label
        self.group = group
        K, dev = cfg.population, group.device
        self.shape = (cfg.steps_per_generation, K, cfg.batch_size, INPUT_DIM)
        self.state = create_stacked_train_state(group, [default_model(cfg) for _ in range(K)])
        self.hypers = TrialHypers.stack([cfg.lr_min] * K, [cfg.beta] * K, device=dev)
        self.generators = [torch.Generator(device=dev) for _ in range(K)]
        rows = cfg.batch_size // group.size
        self.eval_batches = torch.zeros((eval_batches, rows, INPUT_DIM), device=dev)
        self.eval_weights = torch.zeros((eval_batches, rows), device=dev)
        self.factors = torch.ones(K, dtype=torch.float32, device=dev)
        self.step = build_pbt_generation(group, n_exploit=n_exploit, lr_min=cfg.lr_min, lr_max=cfg.lr_max)
        if self.graphed:
            self.step.program = label

    def capture_ahead(self) -> None:
        if self.graphed:
            batches = torch.full(self.shape, 0.5, device=self.group.device)
            self.step.prepare(self.state, self.hypers, batches, self.eval_batches, self.eval_weights, self.factors,
                              self.generators)

    def signature(self) -> tuple:
        return state_signature(self.state)

    def bind(self, state: StackedTrainState, hypers: TrialHypers, generators, eval_batches: torch.Tensor,
             eval_weights: torch.Tensor) -> None:
        """A population's lanes, hypers, generator states and eval set, by
        value, in the slot's tensors."""
        _copy_stacked(self.state, self.hypers, state, hypers)
        for dst, src in zip(self.generators, generators):
            _copy_generator(dst, src)
        self.eval_batches.copy_(eval_batches)
        self.eval_weights.copy_(eval_weights)


def build_single_slot(group: TrialGroup, cfg, key: tuple, *, ahead: bool = True) -> SingleSlot:
    """A :class:`SingleSlot` for ``key``. ``ahead`` (the farm's builds)
    captures its first chunk now, on scratch state; without it (an inline
    admission) the first trial's first chunk is the warm-up and the
    capture, as a per-trial step's is (``train/steps.py::_GraphedChunks``),
    and the graphs stay in the slot for every later trial."""
    slot = SingleSlot(group, cfg, program_label(key))
    if ahead:
        slot.capture_ahead()
    return slot


def build_stacked_slot(group: TrialGroup, template, lanes: int, key: tuple, *, ahead: bool = True) -> StackedSlot:
    slot = StackedSlot(group, template, lanes, program_label(key))
    if ahead:
        slot.capture_ahead()
    return slot


def build_pbt_slot(group: TrialGroup, cfg, key: tuple, *, eval_batches: int, n_exploit: int,
                   ahead: bool = True) -> PBTSlot:
    slot = PBTSlot(group, cfg, eval_batches=eval_batches, n_exploit=n_exploit, label=program_label(key))
    if ahead:
        slot.capture_ahead()
    return slot


def bucket_key_of(cfg) -> tuple:
    """The shape bucket of a config (``hpo/driver.py::stack_bucket_key``'s
    fields), for the programs of a trial, a bucket or a PBT population."""
    return (int(cfg.batch_size), int(cfg.hidden_dim), int(cfg.latent_dim), int(getattr(cfg, "fused_steps", 1)),
            int(getattr(cfg, "grad_accum", 1)), bool(getattr(cfg, "remat", False)))

