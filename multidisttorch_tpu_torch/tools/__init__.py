"""The operator consoles over a sweep's durable files: the port's
counterparts of the JAX package's ``tools/`` scripts, one module each,
run as ``python -m multidisttorch_tpu_torch.tools.<name>``:

- :mod:`.sweep_top`: the live console (run, population, fleet and
  service views, the incident panel);
- :mod:`.ledger_view`: the sweep ledger's attempt history, or the
  service's submission queue (``--queue``);
- :mod:`.sweep_trace`: per-submission span trees and latency breakdowns;
- :mod:`.ckpt_gc`: the v2 checkpoint chunk-store GC;
- :mod:`.incident`: the incident ledger (list, show, report, resolve,
  sweep).

They read files only: none initialises CUDA, so each can run beside a
live sweep on the card. Each prints the same text and ``--json`` as its
JAX tool on the same input.
"""
