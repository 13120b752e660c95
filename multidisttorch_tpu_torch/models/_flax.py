"""flax parameter trees, torch state dicts and flax's initialisers for the
model families (``ConvVAE``, ``MoEVAE``, ``ResNet``).

A family's torch modules carry flax's names (the explicit ones and flax's
auto-names ``Conv_0``, ``GroupNorm_1``, ``BasicBlock_3``), so a state-dict
key is the flax path joined by dots, then a torch leaf:

- a 2-D ``kernel`` (Dense, ``(in, out)``) is ``weight`` ``(out, in)``;
- a 4-D ``kernel`` (Conv, ``(kh, kw, in, out)``) is ``weight`` ``(out, in,
  kh, kw)``; a ConvTranspose's, named in ``deconv``, is ``weight`` ``(in,
  out, kh, kw)`` with both spatial axes flipped (``models/layers.py``);
- GroupNorm's ``scale`` is ``weight``;
- every other leaf (``bias``, the MoE's ``w1``/``b1``/``w2``/``b2``) is
  the same array.

Trees come out with their keys sorted at every level, which is the order
of the JAX package's states and so of a v1 checkpoint's bytes
(``train/checkpoint.py``). Adam's moments have the parameters' tree, so
the same functions carry them.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

# flax's lecun_normal truncates at two standard deviations; this is the
# std of a unit normal so truncated, which its draw divides by.
_TRUNC_STD = 0.87962566103423978


def flax_to_state_dict(tree: Mapping, deconv=()) -> dict[str, torch.Tensor]:
    """A flax parameter tree (optionally under ``"params"``) as a torch
    state dict; ``deconv`` names the ConvTranspose modules' paths."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node: Mapping, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, (*path, key))
                continue
            a = np.asarray(value, dtype=np.float32)
            prefix = ".".join(path)
            name = key
            if key == "kernel":
                name = "weight"
                if a.ndim == 2:
                    a = a.T
                elif prefix in deconv:
                    a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                else:
                    a = a.transpose(3, 2, 0, 1)
            elif key == "scale":
                name = "weight"
            out[f"{prefix}.{name}" if prefix else name] = torch.from_numpy(np.array(a, order="C"))

    walk(tree, ())
    return out


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def state_dict_to_flax(state_dict: Mapping, deconv=()) -> dict:
    """A torch state dict as a flax parameter tree of numpy arrays (host
    copies), keys sorted; the inverse of :func:`flax_to_state_dict`."""
    tree: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = t.detach().cpu().float().numpy()
        prefix = ".".join(path)
        name = leaf
        if leaf == "weight":
            if a.ndim == 1:
                name = "scale"
            elif a.ndim == 2:
                name, a = "kernel", a.T
            elif prefix in deconv:
                name, a = "kernel", a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                name, a = "kernel", a.transpose(2, 3, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.array(a, dtype=np.float32, order="C")
    return _sorted(tree)


def init_like_flax(model: nn.Module, seed: int, deconv=()) -> nn.Module:
    """Initialise ``model`` in place from ``seed`` with flax's defaults and
    return it: kernels (and the MoE's ``w1``/``w2``) from a LeCun normal
    truncated at two standard deviations, with flax's fan-in (every axis
    but the last: ``in`` for a Dense, ``kh·kw·in`` for a conv, ``E·d`` for
    an expert kernel ``(E, d, h)``); biases zero; GroupNorm scales one. The
    draws come from a CPU generator in the tree's sorted order, so a seed
    gives the same weights on every device (not the JAX package's bits:
    its threefry stream differs)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def fill(node: dict) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                fill(value)
            elif key in ("kernel", "w1", "w2"):
                std = math.sqrt(1.0 / math.prod(value.shape[:-1])) / _TRUNC_STD
                w = torch.empty(value.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                node[key] = w.numpy()
            else:
                node[key] = (np.ones if key == "scale" else np.zeros)(value.shape, np.float32)

    tree = state_dict_to_flax(model.state_dict(), deconv)
    fill(tree)
    with torch.no_grad():
        for key, v in flax_to_state_dict(tree, deconv).items():
            model.get_parameter(key).copy_(v)
    return model


class FlaxParams:
    """What `hpo/driver.py` and the checkpoints ask of a model family: its
    initialisation from a seed and its flax tree, both ways. A family names
    its ConvTranspose modules in ``_deconv``. The JAX package's named
    functions (``init_conv_vae_params``, ``conv_vae_params_from_flax``, ...)
    are these methods under its names."""

    _deconv: tuple = ()

    def init_params(self, seed: int):
        return init_like_flax(self, seed, self._deconv)

    @classmethod
    def params_to_flax(cls, state_dict: Mapping) -> dict:
        return state_dict_to_flax(state_dict, cls._deconv)

    @classmethod
    def params_from_flax(cls, tree: Mapping) -> dict[str, torch.Tensor]:
        return flax_to_state_dict(tree, cls._deconv)
