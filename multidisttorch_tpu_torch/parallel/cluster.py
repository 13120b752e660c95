"""Cluster-environment detection and ``torch.distributed`` bring-up.

Counterpart of ``multidisttorch_tpu/parallel/cluster.py``.
:class:`ProcessEnv`, :func:`detect_process_env`,
:func:`parse_slurm_nodelist` and :func:`coordinator_address` are copies of
the JAX package's jax-free functions; the one addition is torchrun's own
coordinates (``WORLD_SIZE``/``RANK``), checked first. The JAX package's
``initialize_runtime`` becomes ``torch.distributed.init_process_group``:
NCCL for CUDA devices, gloo for the CPU, over a TCP rendezvous at the
elected coordinator. A single process with no launcher environment
initialises nothing, as the JAX package does.

:func:`default_device` is the port's one rule for where work runs: CUDA
unless the caller asks for the CPU, and an error naming what is missing
when CUDA is absent.

:class:`AgreementTimeout`, :class:`WedgedCollective`,
:data:`PREEMPTION_EXIT_CODE` and :func:`call_with_timeout` are copies of
the JAX package's deadline machinery: a collective over a trial group
that a dead peer would block forever becomes a named error instead.
"""

from __future__ import annotations

import gc
import os
import re
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ProcessEnv:
    """Launcher-provided process coordinates, before runtime init:
    ``(1, 0)`` when no launcher env is present. ``source`` records which
    detector won."""

    num_processes: int
    process_id: int
    source: str  # "torch" | "openmpi" | "slurm" | "tpu" | "jax" | "local"


def detect_process_env(environ: Optional[dict] = None) -> ProcessEnv:
    """Detect world size / rank from the launcher environment.

    Priority: torchrun (``WORLD_SIZE``/``RANK``) → OpenMPI
    (``OMPI_COMM_WORLD_*``) → SLURM (``SLURM_NPROCS``/``SLURM_PROCID``) →
    Cloud TPU (``TPU_WORKER_ID`` + ``TPU_WORKER_HOSTNAMES``) → JAX
    (``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``) → local ``(1, 0)``.
    """
    env = os.environ if environ is None else environ

    if env.get("WORLD_SIZE") and env.get("RANK"):
        return ProcessEnv(int(env["WORLD_SIZE"]), int(env["RANK"]), "torch")
    if env.get("OMPI_COMM_WORLD_SIZE") and env.get("OMPI_COMM_WORLD_RANK"):
        return ProcessEnv(
            int(env["OMPI_COMM_WORLD_SIZE"]),
            int(env["OMPI_COMM_WORLD_RANK"]),
            "openmpi",
        )
    if env.get("SLURM_NPROCS") and env.get("SLURM_PROCID"):
        return ProcessEnv(int(env["SLURM_NPROCS"]), int(env["SLURM_PROCID"]), "slurm")
    if env.get("TPU_WORKER_ID") and env.get("TPU_WORKER_HOSTNAMES"):
        hostnames = [h for h in env["TPU_WORKER_HOSTNAMES"].split(",") if h]
        return ProcessEnv(len(hostnames), int(env["TPU_WORKER_ID"]), "tpu")
    if env.get("JAX_NUM_PROCESSES") and env.get("JAX_PROCESS_ID"):
        return ProcessEnv(int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"]), "jax")
    return ProcessEnv(1, 0, "local")


_BLOCK_RE = re.compile(r"([\w-]+(?:\[[\d,\-]+\])?)")
_BRACKET_RE = re.compile(r"^(?P<prefix>[\w\-]+)\[(?P<indices>[\d,\-]+)\]$")
_RANGE_RE = re.compile(r"^(\d+)-(\d+)$")


def parse_slurm_nodelist(nodelist: str) -> list[str]:
    """Expand a SLURM compressed nodelist into an explicit host list, e.g.
    ``"g[05,07-08]"`` → ``["g05", "g07", "g08"]`` (zero padding kept)."""
    hosts: list[str] = []
    for block in _BLOCK_RE.findall(nodelist):
        m = _BRACKET_RE.match(block)
        if m is None:
            hosts.append(block)
            continue
        prefix = m.group("prefix")
        for piece in m.group("indices").split(","):
            rng = _RANGE_RE.match(piece)
            if rng is None:
                hosts.append(prefix + piece)
            else:
                lo, hi = rng.groups()
                width = len(lo)
                hosts.extend(f"{prefix}{i:0{width}d}" for i in range(int(lo), int(hi) + 1))
    return hosts


def coordinator_address(environ: Optional[dict] = None, port: Optional[int] = None) -> str:
    """Elect the rendezvous ``host:port``: ``LSB_HOSTS`` token [1] →
    ``LSB_MCPU_HOSTS`` token [2] → first host of ``SLURM_NODELIST`` →
    ``MASTER_ADDR`` → ``127.0.0.1``; port from ``port``, then
    ``MASTER_PORT``, then 8889."""
    env = os.environ if environ is None else environ

    if env.get("LSB_HOSTS") is not None:
        host = env["LSB_HOSTS"].split()[1]
    elif env.get("LSB_MCPU_HOSTS") is not None:
        host = env["LSB_MCPU_HOSTS"].split()[2]
    elif env.get("SLURM_NODELIST"):
        nodes = parse_slurm_nodelist(env["SLURM_NODELIST"])
        if not nodes:
            raise ValueError(
                f"SLURM_NODELIST={env['SLURM_NODELIST']!r} parsed to an empty host list"
            )
        host = nodes[0]
    else:
        host = env.get("MASTER_ADDR", "127.0.0.1")

    resolved_port = port if port is not None else int(env.get("MASTER_PORT", "8889"))
    return f"{host}:{resolved_port}"


def local_rank(environ: Optional[dict] = None) -> int:
    """This process's index on its host: ``LOCAL_RANK``, then OpenMPI's
    and SLURM's local ids, else the global rank."""
    env = os.environ if environ is None else environ
    for key in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID"):
        if env.get(key):
            return int(env[key])
    return detect_process_env(env).process_id


def default_device(device=None) -> torch.device:
    """The device the port's entry points run on.

    ``None`` or ``"cuda"`` means this process's CUDA device (its local rank
    modulo the visible cards); an explicit ``"cpu"`` or ``"cuda:i"`` is
    taken as given. Raises when CUDA is asked for and absent: the port
    never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA is not available (torch {torch.__version__}, built for "
                f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible "
                "devices); pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def initialize_runtime(
    device=None,
    coordinator: Optional[str] = None,
    environ: Optional[dict] = None,
) -> tuple[int, int]:
    """Bring up ``torch.distributed``; returns ``(num_processes, process_id)``.

    NCCL when this process runs on a CUDA device, gloo on the CPU. A
    single process with no launcher environment initialises nothing.
    Safe to call more than once.
    """
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    penv = detect_process_env(environ)
    if penv.num_processes > 1:
        dev = default_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coordinator or coordinator_address(environ)}",
            world_size=penv.num_processes,
            rank=penv.process_id,
        )
    return penv.num_processes, penv.process_id


def shutdown_runtime() -> None:
    """Tear down the ``torch.distributed`` world, if one was brought up.

    Collects garbage first: a DDP reducer that nothing references any more
    but a reference cycle can hold a process group's last reference, and
    its destructor then joins gloo's threads inside
    ``destroy_process_group``, where a rank has been seen to hang at exit
    (ROADMAP C.17). Callers drop their trial states before calling this."""
    if dist.is_available() and dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()


def process_world() -> tuple[int, int]:
    """Process count and index, ``(size, rank)``: the initialised
    ``torch.distributed`` world, else ``(1, 0)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class AgreementTimeout(TimeoutError):
    """A deadline-bounded cross-process coordination call expired.

    A dedicated subclass, not a bare ``TimeoutError``: on Python >= 3.10
    ``socket.timeout`` is ``TimeoutError``, so supervision matching the
    builtin would misclassify any transient network or NFS timeout inside
    a trial as a lost peer and kill the whole sweep. Only this type means
    "the distributed state can no longer be trusted; restart against the
    ledger" (``hpo/supervision.py`` classifies it like preemption).
    """


class WedgedCollective(AgreementTimeout):
    """A collective over a trial group (a health or restore agreement)
    wedged past its deadline: a peer stopped calling (wedged, preempted,
    dead NIC) and this process waits on a result that will never come.
    Subclasses :class:`AgreementTimeout`, so supervision classifies it as
    preemption (die, restart against the ledger); a supervised worker
    catching it exits with :data:`PREEMPTION_EXIT_CODE`. A Python thread
    cannot cancel a wedged NCCL or gloo call, so an in-place retry on the
    same group is never right."""


# The exit-code contract: a supervised worker that dies because the
# *world* failed around it (host preemption, a wedged collective) exits
# with this code (BSD EX_TEMPFAIL: "try again"); any other non-zero exit
# marks the host itself as lost.
PREEMPTION_EXIT_CODE = 75


def call_with_timeout(
    fn,
    timeout_s: Optional[float],
    what: str,
    *,
    error_cls: type = AgreementTimeout,
):
    """Run ``fn()`` with a wall-clock deadline; raise ``error_cls`` (an
    :class:`AgreementTimeout` by default) naming ``what`` instead of
    hanging forever.

    A dead or hung peer leaves a collective over its group blocked with no
    error, the reference's steady state on a lost rank. A blocked C-level
    collective cannot be interrupted from Python, so the deadline runs
    ``fn`` on a watchdog thread and abandons it on expiry. The thread must
    be a daemon: a non-daemon leak would make interpreter shutdown join a
    thread that never returns. ``timeout_s`` None or <= 0 means no
    deadline (a direct call).
    """
    if timeout_s is None or timeout_s <= 0:
        return fn()
    import threading

    box: dict = {}

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=runner, daemon=True, name=f"watchdog:{what}")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise error_cls(
            f"{what} did not complete within {timeout_s:g}s — a "
            "participating process is likely dead, preempted, or hung. "
            "The blocked collective was abandoned on a daemon thread; "
            "treat this process's distributed state as unusable and "
            "restart the job (the sweep ledger makes the restart cheap)."
        )
    if "error" in box:
        raise box["error"]
    return box.get("value")


def env_timeout(env_var: str, default: Optional[float]) -> Optional[float]:
    """A deadline in seconds from ``env_var``, else ``default``."""
    raw = os.environ.get(env_var)
    if raw is None or raw == "":
        return default
    return float(raw)
