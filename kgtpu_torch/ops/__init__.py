"""Inference ops of the port: plain PyTorch tensor functions with a leading
batch axis, plus the GroupNorm kernel's wrapper (`groupnorm`)."""
