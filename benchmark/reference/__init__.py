"""The plain fp32 reference of the benchmark: model, augmentation, steps and precisions."""
