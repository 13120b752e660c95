"""Loss functions: the summed Bernoulli reconstruction error from logits
plus the analytic Gaussian KL, as plain PyTorch.

Counterpart of ``multidisttorch_tpu/ops/losses.py`` (same names, same
math). The reconstruction term is computed from logits,
``max(l,0) - l*x + log1p(exp(-|l|))``, which equals the reference's
``binary_cross_entropy(sigmoid(l), x, reduction="sum")`` without the
``log`` of a saturated sigmoid. ``beta`` weights the KL (beta-VAE);
``beta=1`` is the reference's ``loss_function``.
"""

from __future__ import annotations

import torch


def bernoulli_recon_per_sample(recon_logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sample binary cross-entropy from logits, shape ``(n,)``."""
    l = recon_logits
    per_elem = torch.clamp_min(l, 0.0) - l * x + torch.log1p(torch.exp(-torch.abs(l)))
    return per_elem.reshape(per_elem.shape[0], -1).sum(dim=1)


def gaussian_kl_per_sample(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample ``-0.5 * sum(1 + logvar - mu^2 - exp(logvar))``, shape ``(n,)``."""
    return -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=1)


def elbo_loss_sum(
    recon_logits: torch.Tensor,
    x: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    beta: float = 1.0,
) -> torch.Tensor:
    """Negative ELBO summed over the batch: ``BCE + beta * KLD``.

    The sum (not the mean) is the reference's contract; per-sample figures
    come from dividing by the row count at the logging sites.
    """
    bce = bernoulli_recon_per_sample(recon_logits, x).sum()
    return bce + beta * gaussian_kl_per_sample(mu, logvar).sum()


def elbo_loss_weighted_sum(
    recon_logits: torch.Tensor,
    x: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    weights: torch.Tensor,
    beta: float = 1.0,
) -> torch.Tensor:
    """Per-sample negative ELBO dotted with a weight vector.

    ``weights`` is 1.0 for real rows and 0.0 for padding, so a zero-padded
    final eval batch contributes exactly its real rows.
    """
    per_sample = bernoulli_recon_per_sample(recon_logits, x) + beta * gaussian_kl_per_sample(
        mu, logvar
    )
    return torch.dot(per_sample, weights.to(per_sample.dtype))
