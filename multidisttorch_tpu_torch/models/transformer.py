"""Causal transformer LM with pluggable attention.

Counterpart of ``multidisttorch_tpu/models/transformer.py`` (dense blocks;
the MoE LM and the tensor-parallel shardings are ROADMAP A.15d and A.15g).
A pre-LN decoder stack: learned token and position embeddings, per block an
attention half (separate q/k/v projections, injected attention over
``(B, T, H, Dh)``, output projection) and a 4x tanh-GELU MLP, both residual;
a final LayerNorm and an f32 vocab head. ``attention=None`` runs the dense
causal reference; :func:`ops.attention.make_flash_attention` runs the flash
kernels.

The layers mirror flax's, so a flax parameter tree carries across by name
(:func:`lm_params_from_flax`, :func:`lm_params_to_flax`):

- ``Dense`` keeps flax's ``kernel`` as ``(in, out)``; under ``dtype`` it
  casts its input, kernel and bias to ``dtype`` (flax's ``promote_dtype``)
  and returns ``dtype``. The vocab head is an f32 Dense.
- ``Embed`` casts its table to ``dtype`` before the gather.
- ``LayerNorm`` computes its statistics in f32 with flax's fast variance
  ``E[x^2] - E[x]^2`` (clipped at 0) and eps **1e-6** (torch's default is
  1e-5), applies scale and bias in f32 and rounds once to ``dtype``.
- flax's ``nn.gelu`` is the tanh approximation.

Parameters are f32 whatever ``dtype`` is. ``remat=True`` checkpoints each
block with ``torch.utils.checkpoint`` (the placement of flax's per-block
``nn.remat``): only the block boundaries are kept for the backward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multidisttorch_tpu_torch.ops.ring_attention import dense_attention_reference

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel`` ``(in, out)``,
    computed in ``dtype`` from f32 parameters."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype)) + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table, cast to ``dtype``, gathered by index."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-6, fast variance, f32 statistics),
    rounded once to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        mu2 = (xf * xf).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.scale
        return ((xf - mu) * mul + self.bias).to(self.dtype)


class Block(nn.Module):
    """Pre-LN decoder block: attention + 4x GELU MLP, both residual."""

    def __init__(self, d_model: int, num_heads: int, attention: Callable, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attention = attention
        self.ln_attn = LayerNorm(d_model, dtype)
        self.q = Dense(d_model, d_model, dtype)
        self.k = Dense(d_model, d_model, dtype)
        self.v = Dense(d_model, d_model, dtype)
        self.proj = Dense(d_model, d_model, dtype)
        self.ln_mlp = LayerNorm(d_model, dtype)
        self.up = Dense(d_model, 4 * d_model, dtype)
        self.down = Dense(4 * d_model, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        y = self.ln_attn(x)
        q = self.q(y).reshape(b, t, h, d // h)
        k = self.k(y).reshape(b, t, h, d // h)
        v = self.v(y).reshape(b, t, h, d // h)
        x = x + self.proj(self.attention(q, k, v).reshape(b, t, d))
        y = F.gelu(self.up(self.ln_mlp(x)), approximate="tanh")
        return x + self.down(y)


def _dense_causal(q, k, v):
    return dense_attention_reference(q, k, v, causal=True)


class TransformerLM(nn.Module):
    """Decoder-only LM: ``(B, T) int tokens -> (B, T, vocab) f32 logits``.

    ``attention`` must be causal; ``None`` uses the dense reference.
    Parameters are named as the flax module's (``tok_embed.embedding``,
    ``block_0.q.kernel``, ..., ``head.bias``).
    """

    def __init__(
        self,
        vocab_size: int,
        d_model: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        max_len: int = 256,
        attention: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_len = max_len
        self.attention = attention
        self.dtype = dtype
        self.remat = remat
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)
        attn = _dense_causal if attention is None else attention
        for i in range(num_layers):
            self.add_module(f"block_{i}", Block(d_model, num_heads, attn, dtype))
        self.ln_out = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, vocab_size, torch.float32)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len={self.max_len}")
        x = self.tok_embed(tokens) + self.pos_embed(torch.arange(t, device=tokens.device))[None]
        for block in self.blocks():
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.head(self.ln_out(x))


def init_lm_params(model: TransformerLM, seed: int) -> TransformerLM:
    """Initialise ``model``'s parameters in place from ``seed`` and return it.

    flax's distributions: Dense kernels LeCun normal truncated at two
    standard deviations, biases zero; embeddings normal with variance
    ``1/features`` (``nn.Embed``'s variance scaling); LayerNorm scale 1,
    bias 0. Drawn from a CPU ``torch.Generator``, so a seed gives the same
    weights on every device, but not the JAX package's bits.
    """
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Dense):
                fan_in = module.kernel.shape[0]
                # Truncated-normal variance correction, as in flax's lecun_normal.
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(module.kernel.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                module.kernel.copy_(w)
                module.bias.zero_()
            elif isinstance(module, Embed):
                features = module.embedding.shape[1]
                w = torch.randn(module.embedding.shape, generator=gen) * math.sqrt(1.0 / features)
                module.embedding.copy_(w)
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
    return model


def lm_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """A flax TransformerLM parameter tree (optionally under ``"params"``)
    as a torch ``state_dict``: nested names joined with dots, f32."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = torch.from_numpy(np.array(val, dtype=np.float32))

    walk(tree, "")
    return out


def lm_params_to_flax(state_dict) -> dict:
    """A torch TransformerLM ``state_dict`` as a nested flax parameter tree of
    numpy arrays."""
    tree: dict = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val.detach().cpu().float().numpy().copy()
    return tree
