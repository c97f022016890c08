"""PyTorch + CUDA port of adaptersis_tpu for NVIDIA Hopper GPUs.

The segmentors of `train.py` (the adapter model with its three decoders and
the eval scripts' models), their losses, data, training and evaluation
entry points, and the DINOv2 SSL step, with the kernels of their paths
(CUDA C++ in `csrc/`, built with nvcc at first use). Importing the package
builds nothing and never imports jax.
"""
