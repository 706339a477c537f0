"""Device ops: segment reductions, pooling, and the CUDA kernels."""
