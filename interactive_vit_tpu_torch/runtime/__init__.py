"""Build and load the hand-written CUDA kernels and the host library."""
