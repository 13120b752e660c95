"""Causal transformer LMs with pluggable attention: dense blocks and MoE.

Counterpart of ``multidisttorch_tpu/models/transformer.py`` (the
tensor-parallel shardings are ROADMAP A.15g, the MoE LM's expert-parallel
ones A.13). A pre-LN decoder stack: learned token and position embeddings,
per block an attention half (separate q/k/v projections, injected attention
over ``(B, T, H, Dh)``, output projection) and a 4x tanh-GELU MLP
(:class:`Block`) or a top-1-routed expert MLP (:class:`MoEBlock`, over
``ops/moe.py::MoEMLP``), both residual; a final LayerNorm and an f32 vocab
head. ``attention=None`` runs the dense causal reference;
:func:`ops.attention.make_flash_attention` runs the flash kernels.

**Sequence parallelism.** An attention from ``make_ring_attention`` or
``make_ring_flash_attention`` splits the sequence over its group
(``sequence_group``): each rank calls the model with its ``T/k`` positions
of every row, and the model adds the position embeddings at the rank's
global offset ``rank·T/k``. The MoE LM routes over the group too: its
experts' queues follow the JAX package's b-major order over the *global*
sequence, and its auxiliary loss is the group's (``ops/moe.py``).

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
- The MoE router ``moe.gate`` is a ``torch.nn.Linear`` (``weight`` ``(E,
  in)``, flax's ``kernel`` transposed); the experts' ``w1``/``b1``/``w2``/
  ``b2`` are flax's arrays.

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

from multidisttorch_tpu_torch.ops.moe import MoEMLP
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


class _AttentionBlock(nn.Module):
    """The attention half and the MLP's norm, shared by both block kinds,
    in flax's parameter order."""

    def __init__(self, d_model: int, num_heads: int, attention: Callable, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.attention = attention
        self.ln_attn = LayerNorm(d_model, dtype)
        self.q = Dense(d_model, d_model, dtype)
        self.k = Dense(d_model, d_model, dtype)
        self.v = Dense(d_model, d_model, dtype)
        self.proj = Dense(d_model, d_model, dtype)
        self.ln_mlp = LayerNorm(d_model, dtype)

    def attention_residual(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        y = self.ln_attn(x)
        q = self.q(y).reshape(b, t, h, d // h)
        k = self.k(y).reshape(b, t, h, d // h)
        v = self.v(y).reshape(b, t, h, d // h)
        return x + self.proj(self.attention(q, k, v).reshape(b, t, d))


class Block(_AttentionBlock):
    """Pre-LN decoder block: attention + 4x GELU MLP, both residual."""

    def __init__(self, d_model: int, num_heads: int, attention: Callable, dtype: torch.dtype = torch.float32):
        super().__init__(d_model, num_heads, attention, dtype)
        self.up = Dense(d_model, 4 * d_model, dtype)
        self.down = Dense(4 * d_model, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attention_residual(x)
        y = F.gelu(self.up(self.ln_mlp(x)), approximate="tanh")
        return x + self.down(y)


class MoEBlock(_AttentionBlock):
    """Pre-LN decoder block whose MLP is a top-1-routed expert mixture
    (4x hidden width, ``moe``); same attention half as :class:`Block`.
    Returns ``(x, aux)``, the Switch load-balancing loss beside."""

    def __init__(self, d_model: int, num_heads: int, attention: Callable, num_experts: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__(d_model, num_heads, attention, dtype)
        self.moe = MoEMLP(d_model, num_experts, 4 * d_model, d_model, capacity_factor, dtype)
        # Rows under sequence parallelism: the MoE routes the group's b-major order.
        self.sequence_parallel = _sequence_group(attention) is not None

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.attention_residual(x)
        b, t, d = x.shape
        y, aux = self.moe(self.ln_mlp(x).reshape(b * t, d), seq_rows=b if self.sequence_parallel else None)
        return x + y.reshape(b, t, d), aux


def _dense_causal(q, k, v):
    return dense_attention_reference(q, k, v, causal=True)


def _sequence_group(attention):
    """The group a ring attention splits the sequence over, else None."""
    return getattr(attention, "sequence_group", None)


class _DecoderStack(nn.Module):
    """What both LMs share: the embeddings, ``num_layers`` blocks from
    ``make_block(attention)``, the final LayerNorm and the f32 vocab head,
    in flax's parameter order."""

    def __init__(self, vocab_size: int, d_model: int, num_heads: int, num_layers: int, max_len: int,
                 attention: Optional[Callable], dtype: torch.dtype, remat: bool, make_block: Callable):
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
            self.add_module(f"block_{i}", make_block(attn))
        self.ln_out = LayerNorm(d_model, dtype)
        self.head = Dense(d_model, vocab_size, torch.float32)

    def blocks(self) -> list[nn.Module]:
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    @property
    def sequence_group(self):
        """The group the sequence is split over (a ring attention's), else None."""
        return _sequence_group(self.attention)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token and position embeddings of this rank's ``t`` positions, at
        its global offset under sequence parallelism; the global length is
        held to ``max_len`` as flax's trace-time check does."""
        t = tokens.shape[1]
        group = self.sequence_group
        offset, length = (0, t) if group is None else (group.local_rank * t, group.size * t)
        if length > self.max_len:
            raise ValueError(f"sequence length {length} exceeds max_len={self.max_len}")
        pos = torch.arange(offset, offset + t, device=tokens.device)
        return self.tok_embed(tokens) + self.pos_embed(pos)[None]

    def run_block(self, block: nn.Module, x: torch.Tensor):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)


class TransformerLM(_DecoderStack):
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
        super().__init__(vocab_size, d_model, num_heads, num_layers, max_len, attention, dtype, remat,
                         lambda attn: Block(d_model, num_heads, attn, dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        for block in self.blocks():
            x = self.run_block(block, x)
        return self.head(self.ln_out(x))


class MoETransformerLM(_DecoderStack):
    """Decoder-only LM with MoE MLPs in every block: ``(B, T) int tokens ->
    ((B, T, vocab) f32 logits, aux)``, ``aux`` the mean Switch loss over
    blocks. Parameters named as the flax module's (``block_0.moe.w1``, ...,
    ``block_0.moe.gate.weight``). Under a ring attention over a group of
    several ranks the experts route over that group; on a data-parallel
    group :func:`train.steps.create_train_state` binds them
    (:meth:`bind_group`)."""

    def __init__(
        self,
        vocab_size: int,
        d_model: int = 64,
        num_heads: int = 4,
        num_layers: int = 2,
        num_experts: int = 4,
        capacity_factor: float = 1.25,
        max_len: int = 256,
        attention: Optional[Callable] = None,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__(vocab_size, d_model, num_heads, num_layers, max_len, attention, dtype, remat,
                         lambda attn: MoEBlock(d_model, num_heads, attn, num_experts, capacity_factor, dtype))
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        group = self.sequence_group
        if group is not None and group.size > 1:
            self.bind_group(group.pg, group.size, group.local_rank)

    def bind_group(self, pg, size: int, rank: int) -> None:
        """Route every block's experts over the ``size`` ranks of ``pg``
        (``ops/moe.py::MoEMLP.bind_group``)."""
        for block in self.blocks():
            block.moe.bind_group(pg, size, rank)

    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.embed(tokens)
        aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for block in self.blocks():
            x, aux = self.run_block(block, x)
            aux_total = aux_total + aux
        return self.head(self.ln_out(x)), aux_total / self.num_layers


def moe_lm_ep_shardings(group, model: MoETransformerLM):
    """The JAX package's expert-parallel placement of the MoE LM's experts
    over a model axis: not ported (the port's groups have no model axis)."""
    raise NotImplementedError(
        "moe_lm_ep_shardings (expert parallelism over a model axis) is not ported yet: ROADMAP A.13 (sharding)"
    )


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    # Truncated-normal variance correction, as in flax's lecun_normal.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    return w


def init_lm_params(model: nn.Module, seed: int) -> nn.Module:
    """Initialise ``model``'s parameters (a :class:`TransformerLM` or a
    :class:`MoETransformerLM`) in place from ``seed`` and return it.

    flax's distributions: Dense kernels (the MoE router's too) LeCun normal
    truncated at two standard deviations, biases zero; expert kernels ``(E,
    in, out)`` the same with flax's fan-in ``E·in``; embeddings normal with
    variance ``1/features`` (``nn.Embed``'s variance scaling); LayerNorm
    scale 1, bias 0. Drawn from a CPU ``torch.Generator``, so a seed gives
    the same weights on every device, but not the JAX package's bits.
    """
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Dense):
                module.kernel.copy_(_lecun_normal(module.kernel.shape, module.kernel.shape[0], gen))
                module.bias.zero_()
            elif isinstance(module, MoEMLP):
                for w in (module.w1, module.w2):
                    w.copy_(_lecun_normal(w.shape, w.shape[0] * w.shape[1], gen))
                for b in (module.b1, module.b2, module.gate.bias):
                    b.zero_()
                # the router's flax kernel is (in, E): fan-in is in
                module.gate.weight.copy_(_lecun_normal(module.gate.weight.shape, module.gate.weight.shape[1], gen))
            elif isinstance(module, Embed):
                features = module.embedding.shape[1]
                w = torch.randn(module.embedding.shape, generator=gen) * math.sqrt(1.0 / features)
                module.embedding.copy_(w)
            elif isinstance(module, LayerNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
    return model


def lm_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """A flax TransformerLM or MoETransformerLM parameter tree (optionally
    under ``"params"``) as a torch ``state_dict``: nested names joined with
    dots, f32; the MoE router's ``gate.kernel`` becomes ``gate.weight``,
    transposed."""
    if "params" in tree:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(val, f"{prefix}{key}.")
            elif prefix.endswith("moe.gate.") and key == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(np.array(val, dtype=np.float32).T.copy())
            else:
                out[f"{prefix}{key}"] = torch.from_numpy(np.array(val, dtype=np.float32))

    walk(tree, "")
    return out


def lm_params_to_flax(state_dict) -> dict:
    """A torch TransformerLM or MoETransformerLM ``state_dict`` as a nested
    flax parameter tree of numpy arrays (the inverse of
    :func:`lm_params_from_flax`)."""
    tree: dict = {}
    for name, val in state_dict.items():
        *path, leaf = name.split(".")
        t = val.detach().cpu()
        a = (t.float() if t.is_floating_point() else t).numpy()
        if path[-2:] == ["moe", "gate"] and leaf == "weight":
            leaf, a = "kernel", a.T
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a.copy()
    return tree
