"""Post-training int8 weight-only quantization for LM decoding.

Counterpart of ``multidisttorch_tpu/train/lm_quant.py``. KV-cached decode
(``train/lm_decode.py``) streams every weight matrix once per generated
token; symmetric per-output-channel int8 cuts that traffic 4x against f32.

The quantized tree is a module swap: :func:`quantize_lm_params` returns a
copy of the model in which every :class:`models.transformer.Dense` with a
2-D kernel (q, k, v, proj, the MLP pair and the f32 vocab head) is a
:class:`QuantDense` holding ``q`` (int8, ``(in, out)``), ``scale`` (f32,
``(out,)``) and the untouched ``bias``, so its ``state_dict`` has the JAX
package's leaves (``block_0.q.q``, ``block_0.q.scale``, ...). Embeddings,
norms, biases and the MoE's expert tensors are left alone, as the JAX
package leaves every leaf not named ``kernel``.
``train/lm_decode.py::_dense`` takes both layer forms, as the JAX
package's ``_dense`` takes both trees. The int8 x f32 product is a plain
``torch.matmul`` on the dequantized weight, a product the JAX package
leaves to XLA.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from multidisttorch_tpu_torch.models.transformer import Dense


def _quantize_kernel(w: torch.Tensor) -> dict:
    """Symmetric per-output-channel int8: ``w ≈ q * scale``; ``round`` half
    to even, clipped at ±127, scale 1 where a column is all zeros."""
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


class QuantDense(nn.Module):
    """A :class:`models.transformer.Dense` with an int8 kernel: ``x @ (q *
    scale) + bias``, computed as ``(x @ q) * scale + bias`` in f32 (the JAX
    package's decode ``_dense``). ``q`` and ``scale`` are buffers, ``bias``
    the f32 parameter."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bias = nn.Parameter(bias.detach().clone(), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.float(), self.q.float()) * self.scale + self.bias


def _swap(model: nn.Module, make) -> nn.Module:
    out = copy.deepcopy(model)
    for name, module in list(out.named_modules()):
        new = make(module)
        if new is not None:
            parent_name, _, leaf = name.rpartition(".")
            setattr(out.get_submodule(parent_name) if parent_name else out, leaf, new)
    return out


def quantize_lm_params(model: nn.Module) -> nn.Module:
    """A copy of the LM ``model`` with every 2-D Dense kernel quantized to
    int8 (:class:`QuantDense`); everything else untouched and copied."""

    def make(module):
        if isinstance(module, Dense) and module.kernel.dim() == 2:
            with torch.no_grad():
                return QuantDense(**_quantize_kernel(module.kernel.detach().float()), bias=module.bias)
        return None

    return _swap(model, make)


def dequantize_lm_params(model: nn.Module) -> nn.Module:
    """A copy of a quantized ``model`` with f32 Dense kernels ``q * scale``
    again (for comparison and inspection)."""

    def make(module):
        if isinstance(module, QuantDense):
            d = Dense(*module.q.shape)
            with torch.no_grad():
                d.kernel.copy_(module.q.float() * module.scale)
                d.bias.copy_(module.bias)
            return d.to(module.q.device)
        return None

    return _swap(model, make)
