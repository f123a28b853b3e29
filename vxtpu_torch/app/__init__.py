"""Configs and the command line."""
