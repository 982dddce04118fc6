"""Synthetic keypoint plugin: the toykp data module and its crowd and
WholeBody variants."""

from .crowd import ToyCrowd, ToyCrowdDataset
from .datamodule import ToyKp, ToyKpDataset, coco_head_metas, dense_head_meta
from .toywb import TOYWB_POSE, TOYWB_SIGMAS, ToyWb, ToyWbDataset, toywb_pose

__all__ = ['ToyCrowd', 'ToyCrowdDataset', 'ToyKp', 'ToyKpDataset', 'ToyWb',
           'ToyWbDataset', 'TOYWB_POSE', 'TOYWB_SIGMAS', 'coco_head_metas',
           'dense_head_meta', 'toywb_pose']
