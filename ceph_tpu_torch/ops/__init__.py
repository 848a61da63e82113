"""Device operations: the GF(2) bit-matmul kernels and the torch backend."""
