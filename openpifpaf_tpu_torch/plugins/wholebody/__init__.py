"""COCO WholeBody plugin: 133-keypoint pose estimation.

Port of ``openpifpaf_tpu/plugins/wholebody``: the ``wholebody`` data
module over COCO images with WholeBody annotation files (body, feet,
face and hands), and the constants, which the synthetic ``toywb`` module
also renders.
"""

from . import constants
from ..generic_kp import GenericKpDataModule


class WholeBody(GenericKpDataModule):
    name = 'wholebody'
    keypoints = constants.KEYPOINTS
    sigmas = constants.SIGMAS
    skeleton = constants.SKELETON
    hflip = constants.HFLIP
    upright_pose = constants.UPRIGHT_POSE

    train_annotations = ('data-mscoco/annotations/'
                         'coco_wholebody_train_v1.0.json')
    val_annotations = 'data-mscoco/annotations/coco_wholebody_val_v1.0.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-mscoco/images/train2017/'
    val_image_dir = 'data-mscoco/images/val2017/'
    eval_image_dir = val_image_dir


__all__ = ['WholeBody', 'constants']
