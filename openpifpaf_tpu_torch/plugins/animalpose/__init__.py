"""AnimalPose plugin: 20-keypoint animal pose estimation.

Port of ``openpifpaf_tpu/plugins/animalpose``: quadruped keypoints (eyes,
ears, nose, throat, withers, tail base, elbows, knees, paws) over
COCO-format annotations; the keypoint tables are the JAX package's, copied.
"""

import numpy as np

from ..generic_kp import GenericKpDataModule

KEYPOINTS = [
    'left_eye',        # 1
    'right_eye',       # 2
    'left_ear',        # 3
    'right_ear',       # 4
    'nose',            # 5
    'throat',          # 6
    'tail_base',       # 7
    'withers',         # 8
    'left_front_elbow',   # 9
    'right_front_elbow',  # 10
    'left_back_elbow',    # 11
    'right_back_elbow',   # 12
    'left_front_knee',    # 13
    'right_front_knee',   # 14
    'left_back_knee',     # 15
    'right_back_knee',    # 16
    'left_front_paw',     # 17
    'right_front_paw',    # 18
    'left_back_paw',      # 19
    'right_back_paw',     # 20
]

SIGMAS = [
    0.025, 0.025,       # eyes
    0.035, 0.035,       # ears
    0.026,              # nose
    0.079,              # throat
    0.107,              # tail base
    0.079,              # withers
    0.072, 0.072,       # front elbows
    0.072, 0.072,       # back elbows
    0.087, 0.087,       # front knees
    0.087, 0.087,       # back knees
    0.089, 0.089,       # front paws
    0.089, 0.089,       # back paws
]

SKELETON = [
    (1, 2), (1, 5), (2, 5),            # face triangle
    (1, 3), (2, 4),                    # eyes - ears
    (5, 6),                            # nose - throat
    (6, 8), (8, 7),                    # throat - withers - tail
    (6, 9), (6, 10),                   # throat - front elbows
    (9, 13), (13, 17),                 # left front leg
    (10, 14), (14, 18),                # right front leg
    (7, 11), (7, 12),                  # tail base - back elbows
    (11, 15), (15, 19),                # left back leg
    (12, 16), (16, 20),                # right back leg
]

HFLIP = {
    'left_eye': 'right_eye', 'right_eye': 'left_eye',
    'left_ear': 'right_ear', 'right_ear': 'left_ear',
    'left_front_elbow': 'right_front_elbow',
    'right_front_elbow': 'left_front_elbow',
    'left_back_elbow': 'right_back_elbow',
    'right_back_elbow': 'left_back_elbow',
    'left_front_knee': 'right_front_knee',
    'right_front_knee': 'left_front_knee',
    'left_back_knee': 'right_back_knee',
    'right_back_knee': 'left_back_knee',
    'left_front_paw': 'right_front_paw',
    'right_front_paw': 'left_front_paw',
    'left_back_paw': 'right_back_paw',
    'right_back_paw': 'left_back_paw',
}

UPRIGHT_POSE = np.array([
    [-0.3, 6.2, 2.0], [0.3, 6.2, 2.0],     # eyes
    [-0.5, 6.5, 2.0], [0.5, 6.5, 2.0],     # ears
    [0.0, 5.8, 2.0],                       # nose
    [0.0, 5.2, 2.0],                       # throat
    [4.0, 5.0, 2.0],                       # tail base
    [1.2, 5.5, 2.0],                       # withers
    [0.2, 3.5, 2.0], [0.6, 3.5, 2.0],      # front elbows
    [3.6, 3.5, 2.0], [4.0, 3.5, 2.0],      # back elbows
    [0.2, 2.0, 2.0], [0.6, 2.0, 2.0],      # front knees
    [3.6, 2.0, 2.0], [4.0, 2.0, 2.0],      # back knees
    [0.2, 0.1, 2.0], [0.6, 0.1, 2.0],      # front paws
    [3.6, 0.1, 2.0], [4.0, 0.1, 2.0],      # back paws
], dtype=np.float32)


class AnimalPose(GenericKpDataModule):
    name = 'animal'
    keypoints = KEYPOINTS
    sigmas = SIGMAS
    skeleton = SKELETON
    hflip = HFLIP
    upright_pose = UPRIGHT_POSE

    train_annotations = 'data-animalpose/annotations/animal_keypoints_20_train.json'
    val_annotations = 'data-animalpose/annotations/animal_keypoints_20_val.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-animalpose/images/'
    val_image_dir = 'data-animalpose/images/'
    eval_image_dir = val_image_dir
