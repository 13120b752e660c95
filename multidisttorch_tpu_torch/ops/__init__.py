"""Losses and the fused ELBO kernels."""
