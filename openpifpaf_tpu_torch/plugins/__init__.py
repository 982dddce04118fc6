"""Dataset plugins (the port carries the COCO keypoint constants only)."""
