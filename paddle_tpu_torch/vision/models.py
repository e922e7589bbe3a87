"""Vision model zoo.

Port of ``paddle_tpu/vision/models.py`` (ref:
python/paddle/vision/models/: lenet.py, resnet.py, vgg.py,
mobilenetv1.py, mobilenetv2.py). Architectures and structured names
match the JAX package's (ResNet-50 = bottleneck [3,4,6,3] etc.), so its
weights and BN statistics carry across by name
(``paddle_tpu_torch/convert.py``). NCHW layout at the API surface;
ResNet also runs NHWC.
"""
from __future__ import annotations

from .. import nn
from ..nn import functional as F


class LeNet(nn.Layer):
    """ref: python/paddle/vision/models/lenet.py."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Linear(400, 120), nn.Linear(120, 84),
            nn.Linear(84, num_classes))
        self.flatten = nn.Flatten()

    def forward(self, x):
        x = self.features(x)
        return self.fc(self.flatten(x))


def _norm_for(norm_layer, data_format):
    """Bind data_format into a norm-layer factory exactly once (blocks can
    be built directly, or via ResNet which may have already bound it)."""
    import functools
    if data_format == "NCHW":
        return norm_layer
    if isinstance(norm_layer, functools.partial) and \
            "data_format" in norm_layer.keywords:
        return norm_layer
    return functools.partial(norm_layer, data_format=data_format)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=nn.BatchNorm2D, data_format="NCHW"):
        super().__init__()
        norm_layer = _norm_for(norm_layer, data_format)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=data_format)
        self.bn1 = norm_layer(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=data_format)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=nn.BatchNorm2D, data_format="NCHW"):
        super().__init__()
        norm_layer = _norm_for(norm_layer, data_format)
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False,
                               data_format=data_format)
        self.bn1 = norm_layer(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=data_format)
        self.bn2 = norm_layer(planes)
        self.conv3 = nn.Conv2D(planes, planes * 4, 1, bias_attr=False,
                               data_format=data_format)
        self.bn3 = norm_layer(planes * 4)
        self.downsample = downsample
        self.relu = nn.ReLU()

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ref: python/paddle/vision/models/resnet.py ResNet."""

    cfg = {18: (BasicBlock, [2, 2, 2, 2]),
           34: (BasicBlock, [3, 4, 6, 3]),
           50: (BottleneckBlock, [3, 4, 6, 3]),
           101: (BottleneckBlock, [3, 4, 23, 3]),
           152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, depth=50, num_classes=1000, with_pool=True,
                 norm_layer=nn.BatchNorm2D, data_format="NCHW"):
        super().__init__()
        block, layers = self.cfg[depth]
        self.inplanes = 64
        # channels-last path: every layer takes NHWC tensors, and torch's
        # kernels read them as channels_last views, with no activation
        # transposes
        norm_layer = _norm_for(norm_layer, data_format)
        if data_format == "NHWC" and not with_pool and num_classes > 0:
            import warnings
            warnings.warn(
                "ResNet(with_pool=False, data_format='NHWC'): flatten "
                "order is HWC, so fc weights are NOT interchangeable "
                "with an NCHW checkpoint", stacklevel=2)
        self._norm_layer = norm_layer
        self._data_format = data_format
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                               bias_attr=False, data_format=data_format)
        self.bn1 = norm_layer(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, 2, 1, data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2)
        self.layer3 = self._make_layer(block, 256, layers[2], 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.flatten = nn.Flatten()

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          data_format=self._data_format),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        norm_layer, data_format=self._data_format)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes,
                                norm_layer=norm_layer,
                                data_format=self._data_format))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def resnet18(**kw):
    return ResNet(18, **kw)


def resnet34(**kw):
    return ResNet(34, **kw)


def resnet50(**kw):
    return ResNet(50, **kw)


def resnet101(**kw):
    return ResNet(101, **kw)


def resnet152(**kw):
    return ResNet(152, **kw)


class VGG(nn.Layer):
    """ref: python/paddle/vision/models/vgg.py."""

    cfgs = {
        11: [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
        13: [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
             512, 512, "M"],
        16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
             "M", 512, 512, 512, "M"],
        19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
    }

    def __init__(self, depth=16, num_classes=1000, batch_norm=False):
        super().__init__()
        layers = []
        in_c = 3
        for v in self.cfgs[depth]:
            if v == "M":
                layers.append(nn.MaxPool2D(2, 2))
            else:
                layers.append(nn.Conv2D(in_c, v, 3, padding=1))
                if batch_norm:
                    layers.append(nn.BatchNorm2D(v))
                layers.append(nn.ReLU())
                in_c = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.flatten = nn.Flatten()
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(self.flatten(x))


def vgg11(**kw):
    return VGG(11, **kw)


def vgg13(**kw):
    return VGG(13, **kw)


def vgg16(**kw):
    return VGG(16, **kw)


def vgg19(**kw):
    return VGG(19, **kw)


class _ConvBNReLU(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, relu6=True):
        super().__init__()
        pad = (k - 1) // 2
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=pad,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU6() if relu6 else nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class MobileNetV1(nn.Layer):
    """ref: python/paddle/vision/models/mobilenetv1.py."""

    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        s = lambda c: max(int(c * scale), 8)
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_ConvBNReLU(3, s(32), 3, stride=2, relu6=False)]
        for in_c, out_c, stride in cfg:
            layers.append(_ConvBNReLU(s(in_c), s(in_c), 3, stride=stride,
                                      groups=s(in_c), relu6=False))
            layers.append(_ConvBNReLU(s(in_c), s(out_c), 1, relu6=False))
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        return self.fc(self.flatten(self.pool(self.features(x))))


class _InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand):
        super().__init__()
        hidden = int(round(in_c * expand))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1))
        layers += [
            _ConvBNReLU(hidden, hidden, 3, stride=stride, groups=hidden),
            nn.Conv2D(hidden, out_c, 1, bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """ref: python/paddle/vision/models/mobilenetv2.py."""

    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = max(int(32 * scale), 8)
        layers = [_ConvBNReLU(3, in_c, 3, stride=2)]
        for t, c, n, s in cfg:
            out_c = max(int(c * scale), 8)
            for i in range(n):
                layers.append(_InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        last = max(int(1280 * scale), 1280)
        layers.append(_ConvBNReLU(in_c, last, 1))
        self.features = nn.Sequential(*layers)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.flatten = nn.Flatten()
        self.classifier = nn.Sequential(nn.Dropout(0.2),
                                        nn.Linear(last, num_classes))

    def forward(self, x):
        return self.classifier(self.flatten(self.pool(self.features(x))))


def mobilenet_v1(**kw):
    return MobileNetV1(**kw)


def mobilenet_v2(**kw):
    return MobileNetV2(**kw)
