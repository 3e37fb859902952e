from .model import FRCNNConfig, FasterRCNN
from . import anchors, boxes, roi_head, rpn

__all__ = ["FasterRCNN", "FRCNNConfig", "anchors", "boxes", "roi_head", "rpn"]
