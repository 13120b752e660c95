"""Train, eval and sample steps."""
