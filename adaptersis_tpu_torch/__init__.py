"""PyTorch + CUDA port of adaptersis_tpu for NVIDIA Hopper GPUs.

The serving path of the AdapterSegmentor (the eval step behind
`train.py --evaluate`): models, the deformable-attention and forward-only
attention kernels (CUDA C++ in `csrc/`, built with nvcc at first use),
losses, synthetic data and the `evaluate` entry point. Importing the package
builds nothing and never imports jax.
"""
