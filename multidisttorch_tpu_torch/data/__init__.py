"""Datasets and trial-aware samplers."""
