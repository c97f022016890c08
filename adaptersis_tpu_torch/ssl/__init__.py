"""DINOv2 SSL pretraining (counterpart of the JAX package's `ssl/`)."""
