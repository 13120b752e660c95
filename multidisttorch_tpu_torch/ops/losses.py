"""Loss functions: the summed Bernoulli reconstruction error from logits
plus the analytic Gaussian KL, as plain PyTorch.

Counterpart of ``multidisttorch_tpu/ops/losses.py`` (same names, same
math). The reconstruction term is computed from logits,
``max(l,0) - l*x + log1p(exp(-|l|))``, which equals the reference's
``binary_cross_entropy(sigmoid(l), x, reduction="sum")`` without the
``log`` of a saturated sigmoid. ``beta`` weights the KL (beta-VAE);
``beta=1`` is the reference's ``loss_function``. The ``_lanes`` forms take
K stacked trials on a leading lane axis and a ``(K,)`` beta, and return one
sum per lane: lane k's value is the single-trial function's.
:func:`softmax_cross_entropy_mean` is the classifiers' loss.
"""

from __future__ import annotations

import torch


def bernoulli_recon_per_sample(recon_logits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-sample binary cross-entropy from logits, shape ``(n,)``."""
    l = recon_logits
    # relu, not clamp_min: at a logit of exactly 0 (a decoder whose hidden
    # row is all zeros, say) their gradients differ, and relu's with
    # abs's is the JAX package's (``-x`` there).
    per_elem = torch.relu(l) - l * x + torch.log1p(torch.exp(-torch.abs(l)))
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


def _per_sample_lanes(recon_logits, x, mu, logvar) -> tuple[torch.Tensor, torch.Tensor]:
    """``(K, rows)`` per-sample reconstruction and KL terms; ``x`` is ``(K,
    rows, D)`` or one ``(rows, D)`` batch shared by every lane."""
    k, n = recon_logits.shape[:2]
    x = x.reshape(-1, n, recon_logits[0, 0].numel()).expand(k, -1, -1)
    bce = bernoulli_recon_per_sample(recon_logits.reshape(k * n, -1), x.reshape(k * n, -1)).reshape(k, n)
    kl = gaussian_kl_per_sample(mu.reshape(k * n, -1), logvar.reshape(k * n, -1)).reshape(k, n)
    return bce, kl


def elbo_loss_sum_lanes(recon_logits, x, mu, logvar, beta: torch.Tensor) -> torch.Tensor:
    """:func:`elbo_loss_sum` of each of K lanes, with ``beta[k]``: ``(K,)``."""
    bce, kl = _per_sample_lanes(recon_logits, x, mu, logvar)
    return bce.sum(1) + beta * kl.sum(1)


def elbo_loss_weighted_sum_lanes(recon_logits, x, mu, logvar, weights, beta: torch.Tensor) -> torch.Tensor:
    """:func:`elbo_loss_weighted_sum` of each of K lanes, with ``beta[k]``
    and one ``(rows,)`` weight vector for every lane: ``(K,)``."""
    bce, kl = _per_sample_lanes(recon_logits, x, mu, logvar)
    per_sample = bce + beta.reshape(-1, 1) * kl
    w = weights.to(per_sample.dtype)
    # One dot per lane, as the single-trial function takes it: a batched
    # product would sum the rows in another order.
    return torch.stack([torch.dot(row, w) for row in per_sample])


def softmax_cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (classifier HPO,
    BASELINE.md config 4): log-softmax in f32, then the mean negative
    log-likelihood of each row's label."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long().reshape(-1, 1)).mean()
