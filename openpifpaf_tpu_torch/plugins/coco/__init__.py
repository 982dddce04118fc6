"""COCO keypoint plugin: constants only."""
