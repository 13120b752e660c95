"""Logging and image-grid helpers."""
