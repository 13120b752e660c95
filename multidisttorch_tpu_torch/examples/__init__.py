"""Command-line examples, run as ``python -m multidisttorch_tpu_torch.examples.<name>``."""
