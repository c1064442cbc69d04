"""Spectral convolutions and the fused FNO-2D step (CUDA kernels in ``csrc``)."""
