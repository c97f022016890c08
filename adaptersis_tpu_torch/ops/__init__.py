"""Kernel wrappers with their plain PyTorch versions, and resizes."""
