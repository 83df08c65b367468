"""Ops of the port: rope, the plain paged-attention oracles, sampling, and
the CUDA attention kernels (``ops/kernels/``)."""
