"""Runtime bring-up, trial groups and group collectives."""
