"""Build and load the port's hand-written CUDA kernels (``csrc/``)."""
