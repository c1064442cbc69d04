"""Spectral convolutions, the fused FNO-2D step, attention, the fused dft2
layer and the probe (CUDA kernels in ``csrc``)."""
