from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .swin import SwinTransformer, swin_b, swin_l, swin_s, swin_t

__all__ = ["SwinTransformer", "swin_t", "swin_s", "swin_b", "swin_l",
           "ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
           "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
           "wide_resnet101_2"]
