"""The tracking head set and the frame-pair eval adapter.

Port of ``tracking_head_metas`` and ``_PairEval`` of
``openpifpaf_tpu/plugins/posetrack/cocokpst.py`` (``:26-52``).
"""

from __future__ import annotations

from ... import headmeta


def tracking_head_metas(dataset_name: str, *, keypoints, sigmas, pose,
                        skeleton, score_weights=None):
    """The standard tracking head set: single-frame CIF and CAF, and TCAF."""
    cif = headmeta.Cif('cif', dataset_name,
                       keypoints=keypoints, sigmas=sigmas, pose=pose,
                       draw_skeleton=skeleton, score_weights=score_weights)
    caf = headmeta.Caf('caf', dataset_name,
                       keypoints=keypoints, sigmas=sigmas, pose=pose,
                       skeleton=skeleton)
    tcaf = headmeta.Tcaf('tcaf', dataset_name,
                         keypoints_single_frame=keypoints,
                         sigmas_single_frame=sigmas,
                         pose_single_frame=pose,
                         draw_skeleton_single_frame=skeleton,
                         keypoints=list(keypoints) + list(keypoints),
                         sigmas=list(sigmas) + list(sigmas))
    return [cif, caf, tcaf]


class PairEval:
    """Eval adapter: make a pair, keep the current frame's ground truth."""

    def __init__(self, pair_transform):
        self.pair_transform = pair_transform

    def __call__(self, image, anns, meta):
        images, anns_pair, meta = self.pair_transform(image, anns, meta)
        return images, anns_pair[1], meta
