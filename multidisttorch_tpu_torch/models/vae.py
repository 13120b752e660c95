"""MLP VAE for MNIST — the reference's flagship workload model.

Counterpart of ``multidisttorch_tpu/models/vae.py``: encoder
784→400→(20 mu, 20 logvar), decoder 20→400→784, the same field names and
methods. The decoder returns logits (the sigmoid lives in the stable loss;
:meth:`VAE.decode_probs` gives pixel probabilities). ``dtype`` runs the
matmuls in that type while the parameters stay float32, as flax's
``Dense(dtype=..., param_dtype=float32)`` does.

Reparameterisation noise is explicit: :meth:`VAE.reparameterize` takes
``eps`` or draws it from a ``torch.Generator`` (:meth:`VAE.noise`). The JAX
package draws it from flax's ``'reparam'`` stream, which torch cannot
reproduce, so parity tests inject the same ``eps`` into both.

``forward(..., remat=True)`` is the JAX package's ``jax.checkpoint`` of the
forward (``TrialConfig.remat``): ``torch.utils.checkpoint`` keeps no
activations and recomputes them in the backward pass. The noise is drawn
before the recomputed region, with the draw the forward makes without
remat: ``checkpoint`` restores only the default generators' states, so a
draw inside would give the recomputation other noise from an explicit
generator. Nothing inside draws, so no RNG state is stashed
(``preserve_rng_state=False``), which also keeps it out of a CUDA graph.

:func:`vae_params_from_flax` carries a flax parameter tree across (flax's
``kernel`` is (in, out), torch's ``weight`` is (out, in));
:func:`vae_params_to_flax` is its inverse. Both take a stacked tree too.

:class:`StackedVAE` is K same-shape VAEs with their parameters stacked on
a leading lane axis (weights ``(K, out, in)``, biases ``(K, out)``): the
JAX package's ``vmap`` of ``VAE`` over stacked parameters
(``train/steps.py`` trial stacking) written out, each layer one batched
product over the lanes. :func:`stack_vae_params` stacks K VAEs' weights,
:func:`lane_params` and :func:`write_lane_params` read and write one lane.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multidisttorch_tpu_torch.models.layers import Dense

LAYERS = ("fc1", "fc21", "fc22", "fc3", "fc4")


class VAEMethods:
    """The VAE method contract, which the train, eval and sample steps call
    and every VAE family shares (``ConvVAE``, ``MoEVAE``): a family gives
    ``encode``, ``decode`` and ``latent_dim``; these give the rest."""

    def noise(self, rows: int, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(rows, latent)`` draws of N(0, I) in float32 from ``generator``
        (the default generator when None)."""
        return torch.randn((rows, self.latent_dim), generator=generator, device=device, dtype=torch.float32)

    def reparameterize(
        self,
        mu: torch.Tensor,
        logvar: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``z = mu + eps * exp(0.5*logvar)``, with ``eps`` given or drawn
        by :meth:`noise` from ``generator``."""
        if eps is None:
            eps = self.noise(mu.shape[0], mu.device, generator)
        return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)

    def decode_probs(self, z: torch.Tensor) -> torch.Tensor:
        """Decode to pixel probabilities (the reference's decode output)."""
        return torch.sigmoid(self.decode(z))

    def forward(
        self,
        x: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ):
        """Returns ``(recon_logits, mu, logvar)``; ``remat`` recomputes the
        activations in the backward pass (module docstring)."""
        if not remat:
            return self._forward(x, eps, generator)
        if eps is None:
            eps = self.noise(x.shape[0], x.device, generator)
        return checkpoint(self._forward, x, eps, None, use_reentrant=False, preserve_rng_state=False)

    def _forward(self, x, eps, generator):
        mu, logvar = self.encode(x)
        z = self.reparameterize(mu, logvar, eps=eps, generator=generator)
        return self.decode(z), mu, logvar


class VAE(VAEMethods, nn.Module):
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
        self.fc1 = Dense(input_dim, hidden_dim, dtype=dtype)
        self.fc21 = Dense(hidden_dim, latent_dim, dtype=dtype)
        self.fc22 = Dense(hidden_dim, latent_dim, dtype=dtype)
        self.fc3 = Dense(latent_dim, hidden_dim, dtype=dtype)
        self.fc4 = Dense(hidden_dim, input_dim, dtype=dtype)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Flatten and encode to ``(mu, logvar)``."""
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        h1 = F.relu(self.fc1(x))
        return self.fc21(h1), self.fc22(h1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Decode to logits over pixels."""
        h3 = F.relu(self.fc3(z.to(self.dtype)))
        return self.fc4(h3)

    # What `hpo/driver.py` and the checkpoints ask of every model family
    # (``models/_flax.py::FlaxParams`` for the others).
    def init_params(self, seed: int) -> "VAE":
        return init_vae_params(self, seed)

    def params_to_flax(self, state_dict) -> dict:
        return vae_params_to_flax(state_dict)

    def params_from_flax(self, tree) -> dict[str, torch.Tensor]:
        return vae_params_from_flax(tree)


class _LaneLinear(torch.autograd.Function):
    """``baddbmm(b, x, wᵀ)`` with the backward that ``F.linear`` takes per
    lane: the weight's gradient is ``dyᵀ·x`` in the weight's own layout
    (``mm_mat2_backward``'s product for a transposed weight), where
    baddbmm's own backward forms ``xᵀ·dy`` and transposes it. The two
    products round differently for some shapes on a CPU BLAS (an AVX-512
    host: 9.5e-7 apart at rows 16, 16 to 4 features), and a lane must
    round as its trial run alone."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return torch.baddbmm(b.unsqueeze(1), x, w.transpose(1, 2))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        gx = torch.bmm(dy, w) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(dy.transpose(1, 2), x) if ctx.needs_input_grad[1] else None
        gb = dy.sum(1) if ctx.needs_input_grad[2] else None
        return gx, gw, gb


class StackedLinear(nn.Module):
    """K ``nn.Linear`` layers of one shape, stacked: ``weight`` ``(K, out,
    in)``, ``bias`` ``(K, out)``; ``(K, rows, in)`` to ``(K, rows, out)`` in
    one ``torch.baddbmm`` (:class:`_LaneLinear`)."""

    def __init__(self, lanes: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(lanes, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(lanes, out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        w, b = self.weight, self.bias
        if dtype != torch.float32:
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        return _LaneLinear.apply(x, w, b)


class StackedVAE(nn.Module):
    """K same-shape :class:`VAE` s on a leading lane axis: lane k computes
    what a :class:`VAE` with lane k's parameters computes on lane k's rows.

    Inputs are ``(K, rows, ...)``; :meth:`encode` also takes one
    ``(rows, features)`` batch that every lane scores (the stacked eval). Noise
    is ``eps`` ``(K, rows, latent)`` or drawn per lane, lane k from
    ``generators[k]`` with the unstacked :meth:`VAE.reparameterize`'s draw,
    so a lane given its unstacked twin's generator draws the twin's noise.
    """

    def __init__(
        self,
        lanes: int,
        input_dim: int = 784,
        hidden_dim: int = 400,
        latent_dim: int = 20,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.lanes = lanes
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.latent_dim = latent_dim
        self.dtype = dtype
        self.fc1 = StackedLinear(lanes, input_dim, hidden_dim)
        self.fc21 = StackedLinear(lanes, hidden_dim, latent_dim)
        self.fc22 = StackedLinear(lanes, hidden_dim, latent_dim)
        self.fc3 = StackedLinear(lanes, latent_dim, hidden_dim)
        self.fc4 = StackedLinear(lanes, hidden_dim, input_dim)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(K, rows, ...)``, or one ``(rows, features)`` batch that every
        lane scores, to ``(mu, logvar)``, each ``(K, rows, latent)``."""
        if x.dim() == 2:
            x = x.unsqueeze(0).expand(self.lanes, -1, -1)
        x = x.reshape(self.lanes, x.shape[1], -1).to(self.dtype)
        h1 = F.relu(self.fc1(x, self.dtype))
        return self.fc21(h1, self.dtype), self.fc22(h1, self.dtype)

    def noise(self, rows: int, device, generators=None) -> torch.Tensor:
        """``(K, rows, latent)`` draws of N(0, I) in float32, lane k's from
        ``generators[k]`` (all from the default generator when None)."""
        shape = (rows, self.latent_dim)
        if generators is None:
            return torch.randn((self.lanes, *shape), device=device, dtype=torch.float32)
        return torch.stack([torch.randn(shape, generator=g, device=device, dtype=torch.float32) for g in generators])

    def reparameterize(
        self,
        mu: torch.Tensor,
        logvar: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generators=None,
    ) -> torch.Tensor:
        """``z = mu + eps * exp(0.5*logvar)``; ``eps`` given, or drawn by
        :meth:`noise`."""
        if eps is None:
            eps = self.noise(mu.shape[1], mu.device, generators)
        return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``(K, rows, latent)`` to logits ``(K, rows, input_dim)``."""
        h3 = F.relu(self.fc3(z.to(self.dtype), self.dtype))
        return self.fc4(h3, self.dtype)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None, generators=None, remat: bool = False):
        """``(K, rows, ...)`` to ``(recon_logits, mu, logvar)``; ``remat`` as
        for :meth:`VAE.forward`."""
        if not remat:
            return self._forward(x, eps, generators)
        if eps is None:
            eps = self.noise(x.shape[1], x.device, generators)
        return checkpoint(self._forward, x, eps, None, use_reentrant=False, preserve_rng_state=False)

    def _forward(self, x, eps, generators):
        mu, logvar = self.encode(x)
        z = self.reparameterize(mu, logvar, eps=eps, generators=generators)
        return self.decode(z), mu, logvar


def stack_vae_params(models) -> dict[str, torch.Tensor]:
    """K :class:`VAE` s (or their ``state_dict`` s) as one
    :class:`StackedVAE` ``state_dict``, lane k the k-th."""
    dicts = [m.state_dict() if isinstance(m, nn.Module) else m for m in models]
    return {key: torch.stack([d[key].detach() for d in dicts]) for key in dicts[0]}


def lane_params(stacked: StackedVAE, k: int) -> dict[str, torch.Tensor]:
    """Lane ``k`` of ``stacked`` as a :class:`VAE` ``state_dict`` (copies)."""
    return {key: v[k].detach().clone() for key, v in stacked.state_dict().items()}


def write_lane_params(stacked: StackedVAE, k: int, state_dict) -> None:
    """Copy a :class:`VAE` ``state_dict`` into lane ``k`` of ``stacked``, in
    place: a CUDA graph that holds the stacked parameters keeps their
    addresses."""
    with torch.no_grad():
        for key, v in stacked.state_dict().items():
            v[k].copy_(state_dict[key])


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
    under ``"params"``) as a torch ``state_dict``; a stacked tree (a leading
    lane axis on every leaf) gives a :class:`StackedVAE` ``state_dict``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for name in LAYERS:
        kernel = np.asarray(tree[name]["kernel"], dtype=np.float32)
        bias = np.asarray(tree[name]["bias"], dtype=np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.swapaxes(kernel, -1, -2)))
        out[f"{name}.bias"] = torch.from_numpy(bias.copy())
    return out


def vae_params_to_flax(state_dict) -> dict[str, dict[str, np.ndarray]]:
    """A torch VAE ``state_dict`` as a flax parameter tree of numpy arrays
    (host copies), keys in flax's order: a v1 checkpoint's bytes follow
    it (``train/checkpoint.py``). A stacked ``state_dict`` gives a stacked
    tree."""
    return {
        name: {
            "bias": state_dict[f"{name}.bias"].detach().cpu().float().numpy().copy(),
            "kernel": np.swapaxes(state_dict[f"{name}.weight"].detach().cpu().float().numpy(), -1, -2).copy(),
        }
        for name in LAYERS
    }
