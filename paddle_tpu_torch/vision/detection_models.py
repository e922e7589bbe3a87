"""Detection model zoo: DarkNet-53 and YOLOv3.

Port of ``paddle_tpu/vision/detection_models.py`` (BASELINE config 5,
the YOLOv3 inference leg of bench.py). Architecture and structured names
match the JAX package's (``backbone.stage0.…``, ``block0``, ``head0``,
``route0``), so its ``state_dict()``, BN buffers included, loads with
``paddle_tpu_torch.convert.load_state_dict``; the Python lists
``stages`` / ``blocks`` / ``heads`` / ``routes`` hold the same layers and
register no name of their own. ``predict`` is the network, ``decode``
(three ``yolo_box`` + concat) and ``multiclass_nms``, all on the
model's device, returning device tensors; run it as
``model.eval()`` under ``paddle_tpu_torch.dygraph.no_grad()``.
"""
from __future__ import annotations

from .. import nn
from ..dygraph.tracer import trace_op
from ..nn import functional as F

__all__ = ["DarkNet53", "YOLOv3", "darknet53", "yolov3"]

# anchor set of the reference YOLOv3-608 config
_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
            59, 119, 116, 90, 156, 198, 373, 326]
_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, k=3, stride=1, padding=None):
        super().__init__()
        if padding is None:
            padding = (k - 1) // 2
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class DarkBlock(nn.Layer):
    def __init__(self, c):
        super().__init__()
        self.conv1 = ConvBNLayer(c, c // 2, k=1)
        self.conv2 = ConvBNLayer(c // 2, c, k=3)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet53(nn.Layer):
    """Backbone returning C3/C4/C5 feature maps (stride 8/16/32)."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBNLayer(3, 32, 3)
        self.stages = []
        chans = [(32, 64, 1), (64, 128, 2), (128, 256, 8),
                 (256, 512, 8), (512, 1024, 4)]
        for i, (in_c, out_c, n) in enumerate(chans):
            stage = nn.Sequential(
                ConvBNLayer(in_c, out_c, 3, stride=2),
                *[DarkBlock(out_c) for _ in range(n)])
            self.stages.append(stage)
            setattr(self, f"stage{i}", stage)

    def forward(self, x):
        x = self.conv0(x)
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats[2], feats[3], feats[4]      # C3, C4, C5


class YoloDetBlock(nn.Layer):
    """5-conv detection block + 3x3 route to the head."""

    def __init__(self, in_c, c):
        super().__init__()
        self.body = nn.Sequential(
            ConvBNLayer(in_c, c, 1), ConvBNLayer(c, c * 2, 3),
            ConvBNLayer(c * 2, c, 1), ConvBNLayer(c, c * 2, 3),
            ConvBNLayer(c * 2, c, 1))
        self.tip = ConvBNLayer(c, c * 2, 3)

    def forward(self, x):
        route = self.body(x)
        return route, self.tip(route)


class YOLOv3(nn.Layer):
    """YOLOv3 with DarkNet-53. ``forward`` returns the three raw head
    outputs (training); ``predict(img, img_size)`` decodes + NMS into
    [N, keep_top_k, 6] padded detections + counts (inference)."""

    def __init__(self, num_classes=80, anchors=None, anchor_masks=None,
                 conf_thresh=0.005, nms_thresh=0.45, nms_top_k=400,
                 keep_top_k=100):
        super().__init__()
        self.num_classes = num_classes
        self.anchors = anchors or _ANCHORS
        self.anchor_masks = anchor_masks or _ANCHOR_MASKS
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.nms_top_k = nms_top_k
        self.keep_top_k = keep_top_k
        self.backbone = DarkNet53()

        out_per_anchor = 5 + num_classes
        self.blocks, self.heads, self.routes = [], [], []
        in_chans = [1024, 768, 384]
        chans = [512, 256, 128]
        for i, (in_c, c) in enumerate(zip(in_chans, chans)):
            blk = YoloDetBlock(in_c, c)
            head = nn.Conv2D(c * 2, len(self.anchor_masks[i])
                             * out_per_anchor, 1)
            self.blocks.append(blk)
            self.heads.append(head)
            setattr(self, f"block{i}", blk)
            setattr(self, f"head{i}", head)
            if i < 2:
                route = ConvBNLayer(c, c // 2, 1)
                self.routes.append(route)
                setattr(self, f"route{i}", route)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        outs, feats = [], [c5, c4, c3]
        route = None
        for i in range(3):
            f = feats[i]
            if route is not None:
                route = F.interpolate(route, scale_factor=2, mode="nearest")
                f = trace_op("concat", {"X": [route, f]}, {"axis": 1},
                             out_slots=["Out"])[0]
            route_i, tip = self.blocks[i](f)
            outs.append(self.heads[i](tip))
            if i < 2:
                route = self.routes[i](route_i)
        return outs

    def decode(self, head_outs, img_size):
        """yolo_box over each scale + concat: boxes [N, M, 4], scores
        [N, M, C]."""
        boxes_all, scores_all = [], []
        downs = [32, 16, 8]
        for i, out in enumerate(head_outs):
            anchors = [self.anchors[2 * a + off]
                       for a in self.anchor_masks[i] for off in (0, 1)]
            b, s = trace_op(
                "yolo_box", {"X": [out], "ImgSize": [img_size]},
                {"anchors": anchors, "class_num": self.num_classes,
                 "conf_thresh": self.conf_thresh,
                 "downsample_ratio": downs[i], "clip_bbox": True,
                 "scale_x_y": 1.0}, out_slots=("Boxes", "Scores"))
            boxes_all.append(b)
            scores_all.append(s)
        boxes = trace_op("concat", {"X": boxes_all}, {"axis": 1},
                         out_slots=["Out"])[0]
        scores = trace_op("concat", {"X": scores_all}, {"axis": 1},
                          out_slots=["Out"])[0]
        return boxes, scores

    def predict(self, x, img_size):
        """Full inference: heads -> decode -> NMS. Returns (dets
        [N, keep_top_k, 6] rows (label, score, x1, y1, x2, y2) padded
        with -1, counts [N])."""
        outs = self.forward(x)
        boxes, scores = self.decode(outs, img_size)
        # multiclass_nms wants [N, C, M]
        scores_t = trace_op("transpose2", {"X": [scores]},
                            {"axis": [0, 2, 1]}, out_slots=["Out"])[0]
        dets, num = trace_op(
            "multiclass_nms",
            {"BBoxes": [boxes], "Scores": [scores_t]},
            {"background_label": -1,
             "score_threshold": self.conf_thresh,
             "nms_threshold": self.nms_thresh,
             "nms_top_k": self.nms_top_k, "keep_top_k": self.keep_top_k,
             "normalized": False},
            out_slots=("Out", "NmsedNum"))
        return dets, num


def darknet53(**kw):
    return DarkNet53(**kw)


def yolov3(num_classes=80, **kw):
    return YOLOv3(num_classes=num_classes, **kw)
