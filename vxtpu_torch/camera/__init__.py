"""Pinhole camera and ray generation."""
