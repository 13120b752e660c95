"""PyTorch/CUDA port of the multidisttorch_tpu package.

Carves one job into N trial groups and trains one VAE trial per group,
concurrently, with the fused ELBO loss as hand-written CUDA kernels
(``ops/csrc/elbo.cu``). Trains and decodes the TransformerLM
(``models/transformer.py``, ``train/lm.py``, ``train/lm_decode.py``) with
flash attention as hand-written CUDA kernels
(``ops/csrc/flash_attention.cu``). Imports torch and never jax: the JAX package
``multidisttorch_tpu`` stays in the repository as the reference. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

from multidisttorch_tpu_torch.data.datasets import Dataset, load_mnist, synthetic_mnist
from multidisttorch_tpu_torch.hpo.driver import TrialConfig, TrialResult, run_hpo
from multidisttorch_tpu_torch.models.vae import VAE
from multidisttorch_tpu_torch.ops.elbo import fused_elbo_loss_sum
from multidisttorch_tpu_torch.parallel.cluster import (
    default_device,
    initialize_runtime,
    process_world,
)
from multidisttorch_tpu_torch.parallel.collectives import (
    group_all_gather,
    group_pmean,
    group_psum,
)
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup, setup_groups
from multidisttorch_tpu_torch.utils.logging import log0

__all__ = [
    "Dataset",
    "TrialConfig",
    "TrialGroup",
    "TrialResult",
    "VAE",
    "default_device",
    "fused_elbo_loss_sum",
    "group_all_gather",
    "group_pmean",
    "group_psum",
    "initialize_runtime",
    "load_mnist",
    "log0",
    "process_world",
    "run_hpo",
    "setup_groups",
    "synthetic_mnist",
]
