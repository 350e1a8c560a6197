"""Data tier: the native prefetching batch loader (and its Python
backend) and the training augmentations."""
