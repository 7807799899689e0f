"""kgtpu_torch — the PyTorch/CUDA port of kgtpu (keypoint-graph cell instance
segmentation), for NVIDIA Hopper GPUs.

The JAX package `kgtpu` is the reference; this package imports nothing of it.
Ported so far: single-scale two-stage inference with hourglass backbones
(`infer.build_infer_fn`, `predictor.Predictor`), whose GroupNorm(+ReLU) runs
through a hand-written CUDA kernel (`ops/groupnorm.py`, `csrc/groupnorm.cu`),
and the train step (`train_lib`), whose Gaussian heatmap targets render
through a second one (`ops/gaussian.py`, `csrc/gaussian.cu`).

Layout mirrors kgtpu/:
  config     — the inference and train-step config dataclasses
  models/    — hourglass backbone, heads, mask head, KGNet
  ops/       — preprocess, decode, group, nms, roi, targets, groupnorm and
               gaussian (kernel wrappers), _cuda (nvcc build + ctypes load)
  losses     — focal, offset, wh and mask losses
  train_lib  — optimizer, train state, loss_fn, train step
  data/      — label map -> instance slots (NumPy)
  infer      — batched two-stage inference
  predictor  — serving API (image in, instances out)
  convert    — flax param tree (numpy) -> state_dict
"""

__version__ = "0.1.0"
