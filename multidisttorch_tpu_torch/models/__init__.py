"""The VAE model."""
