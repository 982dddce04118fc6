"""ApolloCar3D plugin: 66-keypoint car pose estimation.

Port of ``openpifpaf_tpu/plugins/apollocar3d``: 66 car keypoints (wheels,
lights, windows, roof, mirrors, ...) over COCO-format annotations; the
keypoint tables are the JAX package's, copied.
"""

import numpy as np

from ..generic_kp import GenericKpDataModule

# 66 keypoints grouped by car part; names generated per part with
# left/right symmetry (part_i indexes run front-to-back)
_PARTS = [
    ('wheel', 2),           # per side: front, back
    ('fender', 4),
    ('door_handle', 2),
    ('headlight', 4),
    ('taillight', 4),
    ('mirror', 1),
    ('window_corner', 8),
    ('roof_corner', 2),
    ('bumper', 6),          # shared front/back corners per side
]

KEYPOINTS = []
for side in ('left', 'right'):
    for part, count in _PARTS:
        for i in range(count):
            KEYPOINTS.append(f'{side}_{part}_{i}')
assert len(KEYPOINTS) == 66

SIGMAS = []
for side in ('left', 'right'):
    for part, count in _PARTS:
        base = {'wheel': 0.07, 'fender': 0.06, 'door_handle': 0.04,
                'headlight': 0.04, 'taillight': 0.04, 'mirror': 0.035,
                'window_corner': 0.05, 'roof_corner': 0.06,
                'bumper': 0.06}[part]
        SIGMAS += [base] * count

_N_SIDE = 33


def _side_skeleton(offset: int):
    edges = []
    idx = {}
    i = offset + 1
    for part, count in _PARTS:
        idx[part] = list(range(i, i + count))
        i += count
    for part, chain in idx.items():
        edges += list(zip(chain, chain[1:]))          # chain within a part
    edges += [
        (idx['wheel'][0], idx['fender'][0]),
        (idx['wheel'][1], idx['fender'][-1]),
        (idx['fender'][1], idx['door_handle'][0]),
        (idx['headlight'][0], idx['fender'][0]),
        (idx['taillight'][0], idx['fender'][-1]),
        (idx['mirror'][0], idx['window_corner'][0]),
        (idx['window_corner'][0], idx['roof_corner'][0]),
        (idx['window_corner'][-1], idx['roof_corner'][-1]),
        (idx['headlight'][0], idx['bumper'][0]),
        (idx['taillight'][-1], idx['bumper'][-1]),
    ]
    return edges


SKELETON = (
    _side_skeleton(0) + _side_skeleton(_N_SIDE)
    # cross-car links (left i <-> right i): wheels (1, 2), roof corners
    # (26, 27 within a side), bumper ends (28, 33 within a side)
    + [(1, 1 + _N_SIDE), (2, 2 + _N_SIDE),
       (26, 26 + _N_SIDE), (27, 27 + _N_SIDE),
       (28, 28 + _N_SIDE), (33, 33 + _N_SIDE)]
)

HFLIP = {}
for i, name in enumerate(KEYPOINTS[:_N_SIDE]):
    HFLIP[name] = KEYPOINTS[i + _N_SIDE]
    HFLIP[KEYPOINTS[i + _N_SIDE]] = name

UPRIGHT_POSE = np.zeros((66, 3), np.float32)
UPRIGHT_POSE[:, 0] = np.concatenate([
    np.linspace(-2.0, 2.0, _N_SIDE), np.linspace(-2.0, 2.0, _N_SIDE)])
UPRIGHT_POSE[:_N_SIDE, 1] = 1.0
UPRIGHT_POSE[_N_SIDE:, 1] = -1.0
UPRIGHT_POSE[:, 2] = 2.0


class ApolloCar3D(GenericKpDataModule):
    name = 'apollo'
    keypoints = KEYPOINTS
    sigmas = SIGMAS
    skeleton = SKELETON
    hflip = HFLIP
    upright_pose = UPRIGHT_POSE

    train_annotations = 'data-apollocar3d/annotations/apollo_keypoints_66_train.json'
    val_annotations = 'data-apollocar3d/annotations/apollo_keypoints_66_val.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-apollocar3d/images/'
    val_image_dir = 'data-apollocar3d/images/'
    eval_image_dir = val_image_dir
