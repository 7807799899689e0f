"""kgtpu_torch — the PyTorch/CUDA port of kgtpu (keypoint-graph cell instance
segmentation), for NVIDIA Hopper GPUs.

The JAX package `kgtpu` is the reference; this package imports nothing of it.
Ported so far: single-scale two-stage inference with hourglass backbones
(`infer.build_infer_fn`, `predictor.Predictor`), whose GroupNorm(+ReLU) runs
through a hand-written CUDA kernel (`ops/groupnorm.py`, `csrc/groupnorm.cu`).

Layout mirrors kgtpu/:
  config     — the inference config dataclasses
  models/    — hourglass backbone, heads, mask head, KGNet
  ops/       — preprocess, decode, group, nms, roi, groupnorm (kernel)
  infer      — batched two-stage inference
  predictor  — serving API (image in, instances out)
  convert    — flax param tree (numpy) -> state_dict
"""

__version__ = "0.1.0"
