"""Probes of the port's kernels on the card, one script a kernel family."""
