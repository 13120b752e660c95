"""KV-cache autoregressive decoding for the TransformerLM.

Counterpart of ``multidisttorch_tpu/train/lm_decode.py``. Where
``train.lm.make_lm_sample`` recomputes the whole prefix for every token,
this keeps each block's K and V in one preallocated ``(L, 2, B, T, H, Dh)``
cache tensor, written in place. A prefill runs one batched causal forward
over the whole buffer through the model's own attention callable (the flash
kernels when the model has them), filling every layer's cache; then each
generated position costs one cache-masked attention in plain torch, as it is
plain XLA in the JAX package.

The per-position math re-implements ``models.transformer.Block``'s forward
(the JAX package's does the same, with its own two-pass LayerNorm); the
parity tests pin it to the model and to the JAX decoder. Scope: dense-block
float32 TransformerLM; bf16 and MoE models are refused, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from multidisttorch_tpu_torch.ops.ring_attention import dense_attention_reference
from multidisttorch_tpu_torch.parallel.mesh import TrialGroup
from multidisttorch_tpu_torch.train.lm import _sample_token, _validate_sampling
from multidisttorch_tpu_torch.train.steps import TrainState

_LN_EPS = 1e-6  # flax nn.LayerNorm default, which the model uses


def _layernorm(ln, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * ln.scale + ln.bias


def _dense(layer, x):
    return x @ layer.kernel + layer.bias


def _mlp(block, x):
    y = _layernorm(block.ln_mlp, x)
    return x + _dense(block.down, F.gelu(_dense(block.up, y), approximate="tanh"))


def make_cached_lm_sample(
    group: TrialGroup,
    model: Any,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> Callable:
    """KV-cached ``sample(state, tokens, prompt_len, generator=None) -> (B, T)``.

    Same contract as :func:`train.lm.make_lm_sample`; the weights come from
    ``state.model`` and the prefill's attention from ``model.attention``
    (the dense causal reference when it is None).
    """
    _validate_sampling(temperature, top_k, top_p, getattr(model, "vocab_size", None))
    if model.dtype != torch.float32:
        raise ValueError(
            "make_cached_lm_sample implements float32 compute; for a "
            f"{model.dtype} model use make_lm_sample (flax's exact "
            "cast placement is the model's business)"
        )
    if getattr(model, "num_experts", None) is not None:
        raise ValueError(
            "make_cached_lm_sample supports dense-block TransformerLM "
            "only; MoE routing per decoded token is a different "
            "schedule: use make_lm_sample"
        )
    if not group.is_local_member:
        raise ValueError(f"this process is not a member of {group!r}")
    num_heads, num_layers, max_len = model.num_heads, model.num_layers, model.max_len
    if model.attention is not None:
        prefill_attn = model.attention
    else:
        def prefill_attn(q, k, v):
            return dense_attention_reference(q, k, v, causal=True)

    def process_position(m, buf, caches, i):
        """Run position ``i`` through the stack, writing its K/V into every
        layer's cache; returns the ``(B, vocab)`` logits at ``i``."""
        b, t = buf.shape
        x = m.tok_embed.embedding[buf[:, i]] + m.pos_embed.embedding[i]
        d = x.shape[-1]
        dh = d // num_heads
        visible = (torch.arange(t, device=buf.device) <= i)[None, None, :]
        for layer, bp in enumerate(m.blocks()):
            y = _layernorm(bp.ln_attn, x)
            q = _dense(bp.q, y).reshape(b, num_heads, dh)
            caches[layer, 0, :, i] = _dense(bp.k, y).reshape(b, num_heads, dh)
            caches[layer, 1, :, i] = _dense(bp.v, y).reshape(b, num_heads, dh)
            s = torch.einsum("bhd,bthd->bht", q, caches[layer, 0]) / math.sqrt(dh)
            w = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
            attn = torch.einsum("bht,bthd->bhd", w, caches[layer, 1]).reshape(b, d)
            x = _mlp(bp, x + _dense(bp.proj, attn))
        return _dense(m.head, _layernorm(m.ln_out, x))

    def sample_fn(state: TrainState, tokens: torch.Tensor, prompt_len: int, generator=None):
        m = state.model
        b, t = tokens.shape
        if t > max_len:
            raise ValueError(f"sequence length {t} exceeds max_len={max_len}")
        d = m.tok_embed.embedding.shape[1]
        dh = d // num_heads
        buf = tokens.clone()
        caches = torch.empty(num_layers, 2, b, t, num_heads, dh, dtype=torch.float32, device=buf.device)
        with torch.no_grad():
            # Prefill: one batched causal forward over the whole buffer fills
            # every layer's cache. Slots >= start-1 hold buffer-derived values
            # here, but the generation loop rewrites slot i-1 before reading it.
            x = m.tok_embed.embedding[buf] + m.pos_embed.embedding[:t][None]
            for layer, bp in enumerate(m.blocks()):
                y = _layernorm(bp.ln_attn, x)
                q = _dense(bp.q, y).reshape(b, t, num_heads, dh)
                k = _dense(bp.k, y).reshape(b, t, num_heads, dh)
                v = _dense(bp.v, y).reshape(b, t, num_heads, dh)
                caches[layer, 0].copy_(k)
                caches[layer, 1].copy_(v)
                attn = prefill_attn(q, k, v)
                x = _mlp(bp, x + _dense(bp.proj, attn.reshape(b, t, d)))
            # Generate: position i-1's logits choose the token at i.
            for i in range(max(int(prompt_len), 1), t):
                logits = process_position(m, buf, caches, i - 1)
                buf[:, i] = _sample_token(logits, generator, temperature, top_k, top_p).to(buf.dtype)
        return buf

    return sample_fn
