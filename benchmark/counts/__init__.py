"""Frozen analytic counts of the benchmark (`flops.py`)."""
