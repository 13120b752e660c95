"""The HPO driver."""
