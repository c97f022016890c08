"""Analytic counts of the port (FLOPs of the train step)."""
