"""Logging and metrics (counterpart of ``vxtpu/obs``)."""
