"""Ops of the port: plain PyTorch tensor functions with a leading batch
axis, plus the wrappers of the CUDA kernels (`groupnorm`, `gaussian`)."""
