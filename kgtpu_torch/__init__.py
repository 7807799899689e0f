"""kgtpu_torch — the PyTorch/CUDA port of kgtpu (keypoint-graph cell instance
segmentation), for NVIDIA Hopper GPUs.

The JAX package `kgtpu` is the reference; this package imports nothing of it.
Ported so far: two-stage inference with every backbone (the hourglass
family, unet, resnet_fpn), norm (GroupNorm, BatchNorm) and decoder
(keypoint graph, centernet) of kgtpu, single-scale
(`infer.build_infer_fn`, `predictor.Predictor`), with multi-scale and flip
TTA and checkpoint ensembles (`build_multiscale_fn`, `build_ensemble_fn`)
and over whole slides (`build_tiled_infer_fn`), whose GroupNorm(+ReLU) runs
through a hand-written CUDA kernel (`ops/groupnorm.py`, `csrc/groupnorm.cu`),
the train step (`train_lib`), whose Gaussian heatmap targets render through
a second one (`ops/gaussian.py`, `csrc/gaussian.cu`), checkpoints in the
port's own format, the cv2-free host data path (synthetic datasets,
augmentation, batch iterator), and the train, test, eval and bench CLIs
(`cli/`).

Layout mirrors kgtpu/:
  config     — the config dataclasses, their JSON, the train/test/eval flags
  models/    — hourglass, unet and resnet_fpn backbones, norms, heads,
               mask head, KGNet
  ops/       — preprocess, decode, group, nms (and the TTA merge), roi,
               tiling, targets, groupnorm and gaussian (kernel wrappers),
               _cuda (nvcc build + ctypes load)
  losses     — focal, offset, wh and mask losses
  train_lib  — optimizer, train state, loss_fn, train step
  data/      — PNG codec, dataset readers, the synthetic generator and its
               cv2-exact drawing ops (draw), warps and augmentation
               (transforms), sample prep and the batch iterator (loader)
  infer      — batched two-stage inference, TTA, ensembles, tiling
  predictor  — serving API (image in, instances out), from_checkpoint
  checkpoint — model_<epoch> save / restore / resolve / prune
  evaluate   — DSB mAP, COCO AP, AJI, PQ; coco_export — COCO results JSON
  cli/       — train, test, eval and bench entry points
  convert    — flax param tree (numpy) -> state_dict
"""

__version__ = "0.1.0"
