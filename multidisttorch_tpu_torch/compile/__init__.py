"""Compile and dispatch: one capture per program.

Counterpart of the JAX package's ``compile/`` (ROADMAP A.9). The port's
counterpart of an XLA compile is the warm-up and CUDA-graph capture of a
train program; these modules make it once per program:

- :mod:`~multidisttorch_tpu_torch.compile.programs` and
  :mod:`~multidisttorch_tpu_torch.compile.registry`: the program keys and
  the process-lifetime registry of **program slots** (a state, its
  generators and its captured graphs per key), taken by every later trial
  of the key, coalesced, timed and booked;
- :mod:`~multidisttorch_tpu_torch.compile.farm`: the **precapture farm**
  (``run_hpo(precompile=True)`` or ``MDT_PRECOMPILE=1``), which captures
  a sweep's programs on worker threads before their trials are admitted;
- :mod:`~multidisttorch_tpu_torch.compile.cache`: the **kernel-library
  quarantine**: CRC32 sidecars over the libraries ``ops/_build.py``
  builds, a scan that moves torn or corrupt ones aside, and a subprocess
  canary that holds each library's kernels against their plain versions
  before a trial process loads them; a quarantined library is rebuilt
  from its source;
- :mod:`~multidisttorch_tpu_torch.compile.coldstart`: the **cold-start
  bench** (cold, precompiled and cache-warm admission in fresh child
  processes, with the JAX package's gates).
"""

from multidisttorch_tpu_torch.compile import programs  # noqa: F401
from multidisttorch_tpu_torch.compile.farm import PrecompilePool  # noqa: F401
from multidisttorch_tpu_torch.compile.registry import ExecutableRegistry, get_executable_registry  # noqa: F401
