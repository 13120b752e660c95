"""MoE-VAE: the MLP VAE with a mixture-of-experts decoder hidden layer.

Counterpart of ``multidisttorch_tpu/models/moe_vae.py``: encoder
input→hidden→(latent mu, latent logvar) as the VAE's, decoder
``MoEMLP(latent→hidden→hidden)`` (``ops/moe.py``) then ``fc4`` to logits,
with the VAE's method contract (``models/vae.py``). As in the JAX package
the router's auxiliary loss is not folded into the ELBO: the step's loss
is the reference's. Its expert-parallel shardings wait for ROADMAP A.13.

:class:`StackedMoEVAE` is K MoE VAEs of one shape on a leading lane axis
(``models/vae.py::LaneStacked``): batched Dense products and the lane-stacked
MoE (``ops/moe.py::StackedMoEMLP``), each lane routing its own rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multidisttorch_tpu_torch.models._flax import FlaxParams
from multidisttorch_tpu_torch.models.layers import Dense
from multidisttorch_tpu_torch.models.vae import LaneStacked, VAEMethods
from multidisttorch_tpu_torch.ops.lanes import StackedLinear
from multidisttorch_tpu_torch.ops.moe import MoEMLP, StackedMoEMLP


class MoEVAE(FlaxParams, VAEMethods, nn.Module):
    """``input_dim``-``hidden_dim``-``latent_dim`` MLP encoder; MoE-MLP
    decoder hidden layer of ``num_experts`` experts."""

    def __init__(
        self,
        input_dim: int = 784,
        hidden_dim: int = 400,
        latent_dim: int = 20,
        num_experts: int = 4,
        capacity_factor: float = 2.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.num_experts = num_experts
        self.dtype = dtype
        self.fc1 = Dense(input_dim, hidden_dim, dtype=dtype)
        self.fc21 = Dense(hidden_dim, latent_dim, dtype=dtype)
        self.fc22 = Dense(hidden_dim, latent_dim, dtype=dtype)
        self.moe = MoEMLP(latent_dim, num_experts, hidden_dim, hidden_dim, capacity_factor, dtype)
        self.fc4 = Dense(hidden_dim, input_dim, dtype=dtype)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        h1 = F.relu(self.fc1(x))
        return self.fc21(h1), self.fc22(h1)

    def bind_group(self, pg, size: int, rank: int) -> None:
        """Route the decoder's experts over a multi-rank group's batch as
        one (``ops/moe.py``); ``train/steps.py::create_train_state`` calls
        it on such a group."""
        self.moe.bind_group(pg, size, rank)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode to logits over pixels (the router's aux loss dropped)."""
        h, _aux = self.moe(z.to(self.dtype))
        return self.fc4(F.relu(h))

    def stacked(self, lanes: int) -> "StackedMoEVAE":
        """The stacked form of ``lanes`` MoE VAEs of this one's widths."""
        return StackedMoEVAE(lanes, self.input_dim, self.hidden_dim, self.latent_dim, self.num_experts,
                             self.moe.capacity_factor, self.dtype)


class StackedMoEVAE(LaneStacked, nn.Module):
    """K :class:`MoEVAE` s of one shape on a leading lane axis (module
    docstring): lane k computes what a MoEVAE with lane k's parameters
    computes on lane k's rows."""

    def __init__(
        self,
        lanes: int,
        input_dim: int = 784,
        hidden_dim: int = 400,
        latent_dim: int = 20,
        num_experts: int = 4,
        capacity_factor: float = 2.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.lanes = lanes
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.fc1 = StackedLinear(lanes, input_dim, hidden_dim)
        self.fc21 = StackedLinear(lanes, hidden_dim, latent_dim)
        self.fc22 = StackedLinear(lanes, hidden_dim, latent_dim)
        self.moe = StackedMoEMLP(lanes, latent_dim, num_experts, hidden_dim, hidden_dim, capacity_factor, dtype)
        self.fc4 = StackedLinear(lanes, hidden_dim, input_dim)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, rows, ...)``, or one ``(rows, features)`` batch that every
        lane scores, to ``(mu, logvar)``, each ``(K, rows, latent)``."""
        if x.dim() == 2:
            x = x.unsqueeze(0).expand(self.lanes, -1, -1)
        x = x.reshape(self.lanes, x.shape[1], -1).to(self.dtype)
        h1 = F.relu(self.fc1(x, self.dtype))
        return self.fc21(h1, self.dtype), self.fc22(h1, self.dtype)

    def bind_group(self, pg, size: int, rank: int) -> None:
        """Route every lane's experts over a multi-rank group's batch
        (``ops/moe.py``); ``train/steps.py::create_stacked_train_state``
        calls it on such a group."""
        self.moe.bind_group(pg, size, rank)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``(K, rows, latent)`` to logits ``(K, rows, input_dim)`` (the
        router's aux loss dropped)."""
        h, _aux = self.moe(z.to(self.dtype))
        return self.fc4(F.relu(h), self.dtype)

    def lane_model(self) -> MoEVAE:
        """An unstacked MoE VAE of these widths, bound to this one's group."""
        model = MoEVAE(self.input_dim, self.hidden_dim, self.latent_dim, self.num_experts, self.capacity_factor,
                       self.dtype)
        model.bind_group(self.moe._pg, self.moe._group_size, self.moe._group_rank)
        return model


# The JAX package's named functions, as the class's own (``models/_flax.py``).
init_moe_vae_params = MoEVAE.init_params
moe_vae_params_from_flax = MoEVAE.params_from_flax
moe_vae_params_to_flax = MoEVAE.params_to_flax
