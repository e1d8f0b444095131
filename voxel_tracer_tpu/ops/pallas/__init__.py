"""Pallas kernels (Triton route) for the hot traversal path."""
