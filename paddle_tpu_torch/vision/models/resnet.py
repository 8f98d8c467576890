"""The ResNet family in PyTorch (the port of
paddle_tpu/vision/models/resnet.py): BasicBlock, BottleneckBlock, ResNet
and the thirteen constructors, resnet18 through wide_resnet101_2.

Parameter and buffer names mirror the JAX package (``conv1.weight``,
``bn1.weight``, ``bn1._mean``, ``bn1._variance``,
``layer{i}.{j}.conv{k}.weight``, ``layer{i}.0.downsample.0.weight`` and
``.downsample.1.*``, ``fc.weight``), so
`paddle_tpu_torch.convert.model_state_from_paddle` carries a JAX state
dict across by name (``fc.weight`` transposed to ``nn.Linear``'s
``[out, in]``; the 4-D conv weights as they are).

Every conv-BN(-ReLU) triple goes through `nn.functional.fused_conv_bn_act`
as in the JAX blocks, the residual add and the last ReLU in the block's
last call; the projection shortcut is the Conv2D + BatchNorm2D pair, fused
the same way. Under FLAGS_conv_channels_last the trunk runs in
channels-last memory from the stem to the pool: `nn.functional.conv2d`
puts every convolution's input there, and the batch norms and pools keep
it; the trunk's output leaves it (`nn.layout`). In train()
mode every forward updates the running statistics (Paddle's rule); the
model starts in train() mode, as the JAX package's does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from ...nn import functional as F
from ...nn import layout as _layout
from ...nn.layers import AdaptiveAvgPool2D, BatchNorm2D, Conv2D, MaxPool2D

__all__ = [
    "ResNet", "BasicBlock", "BottleneckBlock", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_64x4d",
    "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
    "wide_resnet101_2",
]


def _fused_cba(x, conv, bn, act=None, residual=None):
    """act(bn(conv(x)) [+ residual]) as one `fused_conv_bn_act` call."""
    return F.fused_conv_bn_act(
        x, conv.weight, conv.bias, bn._mean, bn._variance, bn.weight,
        bn.bias, stride=conv._stride, padding=conv._padding,
        dilation=conv._dilation, groups=conv._groups,
        data_format=conv._data_format, training=bn.training,
        momentum=bn._momentum, epsilon=bn._epsilon,
        use_global_stats=bn._use_global_stats, act=act, residual=residual)


def _shortcut(ds, x):
    return x if ds is None else _fused_cba(x, ds[0], ds[1])


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 dtype=None):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and "
                             "base_width=64")
        if norm_layer not in (None, BatchNorm2D):
            raise NotImplementedError("norm_layer: the port's blocks fuse "
                                      "BatchNorm2D only")
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                            bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(planes, **kw)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = BatchNorm2D(planes, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = _fused_cba(x, self.conv1, self.bn1, act="relu")
        return _fused_cba(out, self.conv2, self.bn2, act="relu",
                          residual=_shortcut(self.downsample, x))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, device=None,
                 dtype=None):
        super().__init__()
        if norm_layer not in (None, BatchNorm2D):
            raise NotImplementedError("norm_layer: the port's blocks fuse "
                                      "BatchNorm2D only")
        kw = dict(device=device, dtype=dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(width, **kw)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **kw)
        self.bn2 = BatchNorm2D(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **kw)
        self.bn3 = BatchNorm2D(planes * self.expansion, **kw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = _fused_cba(x, self.conv1, self.bn1, act="relu")
        out = _fused_cba(out, self.conv2, self.bn2, act="relu")
        return _fused_cba(out, self.conv3, self.bn3, act="relu",
                          residual=_shortcut(self.downsample, x))


class ResNet(nn.Module):
    """ResNet of `depth` 18, 34, 50, 101 or 152 with `block`; `width` and
    `groups` give the wide and ResNeXt variants; `with_pool=False` keeps
    the last feature map, `num_classes=0` drops the head. ``device``
    defaults to CUDA (raising without a card). Parameters are drawn from
    ``seed`` with the JAX package's distributions: conv weights
    Uniform(+-1 / sqrt(fan_in)), the head's weight Xavier-uniform and bias
    zero, BN scales one and shifts zero; the buffers start at mean 0 and
    variance 1. ``dtype`` casts parameters and buffers alike (the JAX
    package's `model.to(dtype=...)` does both)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        self._kw = dict(device=dev, dtype=dtype)
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = BatchNorm2D(self.inplanes, **self._kw)
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                **self._kw)
        self.reset_parameters(torch.Generator(device=dev).manual_seed(seed))

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                BatchNorm2D(planes * block.expansion, **self._kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **self._kw))
        return nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if isinstance(m, Conv2D):
                m.reset_parameters(generator)
            elif isinstance(m, BatchNorm2D):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                m._mean.fill_(0.0)
                m._variance.fill_(1.0)
        if self.num_classes > 0:
            fan_out, fan_in = self.fc.weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.fill_(0.0)

    def forward(self, x):
        x = self.maxpool(_fused_cba(x, self.conv1, self.bn1, act="relu"))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        x = _layout.to_nchw(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights require network "
                                  "access; load a local state_dict instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kw):
    return _resnet(BasicBlock, 18, pretrained, **kw)


def resnet34(pretrained=False, **kw):
    return _resnet(BasicBlock, 34, pretrained, **kw)


def resnet50(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 50, pretrained, **kw)


def resnet101(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 101, pretrained, **kw)


def resnet152(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 152, pretrained, **kw)


def resnext50_32x4d(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 50, pretrained, groups=32, width=4, **kw)


def resnext50_64x4d(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 50, pretrained, groups=64, width=4, **kw)


def resnext101_32x4d(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 101, pretrained, groups=32, width=4,
                   **kw)


def resnext101_64x4d(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 101, pretrained, groups=64, width=4,
                   **kw)


def resnext152_32x4d(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 152, pretrained, groups=32, width=4,
                   **kw)


def resnext152_64x4d(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 152, pretrained, groups=64, width=4,
                   **kw)


def wide_resnet50_2(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kw)


def wide_resnet101_2(pretrained=False, **kw):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kw)
