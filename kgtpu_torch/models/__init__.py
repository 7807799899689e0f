"""Model zoo of the port: KGNet over the hourglass, unet and resnet_fpn
backbones (NCHW channels-last inside, NHWC at its edges)."""

from kgtpu_torch.models.kgnet import KGNet, build_model, init_weights

__all__ = ["KGNet", "build_model", "init_weights"]
