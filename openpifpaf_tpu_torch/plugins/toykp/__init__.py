"""Synthetic keypoint plugin: the toykp data module."""

from .datamodule import ToyKp, ToyKpDataset, coco_head_metas

__all__ = ['ToyKp', 'ToyKpDataset', 'coco_head_metas']
