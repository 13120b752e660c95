"""MLP VAE for MNIST — the reference's flagship workload model.

Counterpart of ``multidisttorch_tpu/models/vae.py``: encoder
784→400→(20 mu, 20 logvar), decoder 20→400→784, the same field names and
methods. The decoder returns logits (the sigmoid lives in the stable loss;
:meth:`VAE.decode_probs` gives pixel probabilities). ``dtype`` runs the
matmuls in that type while the parameters stay float32, as flax's
``Dense(dtype=..., param_dtype=float32)`` does.

Reparameterisation noise is explicit: :meth:`VAE.reparameterize` takes
``eps`` or draws it from a ``torch.Generator``. The JAX package draws it
from flax's ``'reparam'`` stream, which torch cannot reproduce, so parity
tests inject the same ``eps`` into both.

:func:`vae_params_from_flax` carries a flax parameter tree across (flax's
``kernel`` is (in, out), torch's ``weight`` is (out, in));
:func:`vae_params_to_flax` is its inverse.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAYERS = ("fc1", "fc21", "fc22", "fc3", "fc4")


class VAE(nn.Module):
    """MLP VAE: input-hidden-(latent) encoder, (latent)-hidden-input decoder.
    Defaults are the reference's (784, 400, 20)."""

    def __init__(
        self,
        input_dim: int = 784,
        hidden_dim: int = 400,
        latent_dim: int = 20,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.dtype = dtype
        self.fc1 = nn.Linear(input_dim, hidden_dim)
        self.fc21 = nn.Linear(hidden_dim, latent_dim)
        self.fc22 = nn.Linear(hidden_dim, latent_dim)
        self.fc3 = nn.Linear(latent_dim, hidden_dim)
        self.fc4 = nn.Linear(hidden_dim, input_dim)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return layer(x)
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Flatten and encode to ``(mu, logvar)``."""
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        h1 = F.relu(self._dense(self.fc1, x))
        return self._dense(self.fc21, h1), self._dense(self.fc22, h1)

    def reparameterize(
        self,
        mu: torch.Tensor,
        logvar: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``z = mu + eps * exp(0.5*logvar)``, with ``eps`` given or drawn
        N(0, I) in float32 from ``generator``."""
        if eps is None:
            eps = torch.randn(
                mu.shape, generator=generator, device=mu.device, dtype=torch.float32
            )
        return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode to logits over pixels."""
        h3 = F.relu(self._dense(self.fc3, z.to(self.dtype)))
        return self._dense(self.fc4, h3)

    def decode_probs(self, z: torch.Tensor) -> torch.Tensor:
        """Decode to pixel probabilities (the reference's decode output)."""
        return torch.sigmoid(self.decode(z))

    def forward(
        self,
        x: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns ``(recon_logits, mu, logvar)``."""
        mu, logvar = self.encode(x)
        z = self.reparameterize(mu, logvar, eps=eps, generator=generator)
        return self.decode(z), mu, logvar


def init_vae_params(model: VAE, seed: int) -> VAE:
    """Initialise ``model``'s parameters in place from ``seed`` and return it.

    The same distributions as flax's ``Dense`` defaults: kernels from a
    LeCun normal truncated at two standard deviations, biases zero. The
    draws come from a CPU generator, so a seed gives the same weights on
    every device (not the JAX package's bits: its threefry stream differs).
    """
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    with torch.no_grad():
        for name in LAYERS:
            layer = getattr(model, name)
            fan_in = layer.weight.shape[1]
            # Truncated-normal variance correction, as in flax's lecun_normal.
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(layer.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
            layer.weight.copy_(w)
            layer.bias.zero_()
    return model


def vae_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """A flax VAE parameter tree (``{fc1: {kernel, bias}, ...}``, optionally
    under ``"params"``) as a torch ``state_dict``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for name in LAYERS:
        kernel = np.asarray(tree[name]["kernel"], dtype=np.float32)
        bias = np.asarray(tree[name]["bias"], dtype=np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        out[f"{name}.bias"] = torch.from_numpy(bias.copy())
    return out


def vae_params_to_flax(state_dict) -> dict[str, dict[str, np.ndarray]]:
    """A torch VAE ``state_dict`` as a flax parameter tree of numpy arrays
    (host copies), keys in flax's order: a v1 checkpoint's bytes follow
    it (``train/checkpoint.py``)."""
    return {
        name: {
            "bias": state_dict[f"{name}.bias"].detach().cpu().float().numpy().copy(),
            "kernel": state_dict[f"{name}.weight"].detach().cpu().float().numpy().T.copy(),
        }
        for name in LAYERS
    }
