"""Inverse rendering: losses, the fit loop, checkpoints."""
