"""The model families: the MLP VAE (and its stacked form), the conv β-VAE,
the MoE VAE, ResNet and the TransformerLM. The JAX package's sharding
helpers (``*_tp_shardings``, ``*_ep_shardings``) wait for ROADMAP A.13."""

from multidisttorch_tpu_torch.models.conv_vae import (
    ConvVAE,
    conv_vae_params_from_flax,
    conv_vae_params_to_flax,
    init_conv_vae_params,
)
from multidisttorch_tpu_torch.models.moe_vae import (
    MoEVAE,
    init_moe_vae_params,
    moe_vae_params_from_flax,
    moe_vae_params_to_flax,
)
from multidisttorch_tpu_torch.models.resnet import (
    BasicBlock,
    ResNet,
    ResNet18,
    init_resnet_params,
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from multidisttorch_tpu_torch.models.transformer import TransformerLM
from multidisttorch_tpu_torch.models.vae import VAE, StackedVAE, init_vae_params
