"""The data path: the segmentation and classification datasets, the
samplers, the threaded loader, augmentation and the native decoder."""
