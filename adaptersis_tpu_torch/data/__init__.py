"""Validation preprocessing and the synthetic dataset."""
