"""Vision models (ref: python/paddle/vision/): the classification zoo
and the detection models. The JAX package's transforms and datasets are
not ported yet."""
from . import detection_models, models  # noqa: F401
from .detection_models import DarkNet53, YOLOv3, darknet53, yolov3  # noqa: F401
