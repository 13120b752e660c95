"""The HPO driver and population-based training."""

from multidisttorch_tpu_torch.hpo.pbt import PBTConfig, PBTResult, run_pbt

__all__ = ["PBTConfig", "PBTResult", "run_pbt"]
