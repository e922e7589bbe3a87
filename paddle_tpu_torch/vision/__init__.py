"""Vision (ref: python/paddle/vision/): the classification zoo, the
detection models, the numpy transforms and the datasets."""
from . import models  # noqa: F401
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import detection_models  # noqa: F401
from .detection_models import DarkNet53, YOLOv3, darknet53, yolov3  # noqa: F401
