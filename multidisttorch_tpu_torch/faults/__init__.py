"""Fault classes that the trial supervisor classifies."""
