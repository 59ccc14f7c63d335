"""Hand-written CUDA kernels (``ops``), their plain versions (``ref``) and
their build (``build``)."""
