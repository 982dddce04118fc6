"""CrowdPose plugin: 14-keypoint pose estimation in crowded scenes.

Port of ``openpifpaf_tpu/plugins/crowdpose``: a CocoKp-shaped data module
over the CrowdPose COCO-format annotations.  Its metric follows the
crowdposetools protocol: with the annotation file at hand, AP by the
per-image crowd-index band (easy < 0.1 <= medium < 0.8 <= hard) instead
of by instance area.
"""

from . import constants
from ..generic_kp import GenericKpDataModule
from ... import metric


class CrowdPose(GenericKpDataModule):
    name = 'crowdpose'
    keypoints = constants.KEYPOINTS
    sigmas = constants.SIGMAS
    skeleton = constants.SKELETON
    hflip = constants.HFLIP
    upright_pose = constants.UPRIGHT_POSE

    train_annotations = 'data-crowdpose/json/crowdpose_train.json'
    val_annotations = 'data-crowdpose/json/crowdpose_val.json'
    eval_annotations = 'data-crowdpose/json/crowdpose_test.json'
    train_image_dir = 'data-crowdpose/images/'
    val_image_dir = 'data-crowdpose/images/'
    eval_image_dir = 'data-crowdpose/images/'

    def metrics(self):
        ann_file = self._ann_file()
        return [metric.Coco(
            ann_file=ann_file,
            ground_truth_from_loader=ann_file is None,
            iou_type='keypoints',
            keypoint_oks_sigmas=self.sigmas,
            # the bands need each image's crowdIndex from the file
            crowd_index_groups=ann_file is not None)]


__all__ = ['CrowdPose', 'constants']
