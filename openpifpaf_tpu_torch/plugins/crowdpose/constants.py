"""CrowdPose keypoint constants.

Port copy of ``openpifpaf_tpu/plugins/crowdpose/constants.py`` (reference
``src/openpifpaf/plugins/crowdpose/constants.py``): the
14 CrowdPose keypoints (no facial keypoints; head_top and neck instead),
sigmas, skeleton and hflip pairs.
"""

import numpy as np

KEYPOINTS = [
    'left_shoulder',   # 1
    'right_shoulder',  # 2
    'left_elbow',      # 3
    'right_elbow',     # 4
    'left_wrist',      # 5
    'right_wrist',     # 6
    'left_hip',        # 7
    'right_hip',       # 8
    'left_knee',       # 9
    'right_knee',      # 10
    'left_ankle',      # 11
    'right_ankle',     # 12
    'head_top',        # 13
    'neck',            # 14
]

SIGMAS = [
    0.079, 0.079,      # shoulders
    0.072, 0.072,      # elbows
    0.062, 0.062,      # wrists
    0.107, 0.107,      # hips
    0.087, 0.087,      # knees
    0.089, 0.089,      # ankles
    0.079,             # head top
    0.079,             # neck
]

SKELETON = [
    (13, 14),                      # head - neck
    (14, 1), (14, 2),              # neck - shoulders
    (1, 2),                        # shoulder span
    (1, 3), (3, 5),                # left arm
    (2, 4), (4, 6),                # right arm
    (1, 7), (2, 8),                # torso sides
    (7, 8),                        # hip span
    (7, 9), (9, 11),               # left leg
    (8, 10), (10, 12),             # right leg
]

HFLIP = {
    'left_shoulder': 'right_shoulder',
    'right_shoulder': 'left_shoulder',
    'left_elbow': 'right_elbow',
    'right_elbow': 'left_elbow',
    'left_wrist': 'right_wrist',
    'right_wrist': 'left_wrist',
    'left_hip': 'right_hip',
    'right_hip': 'left_hip',
    'left_knee': 'right_knee',
    'right_knee': 'left_knee',
    'left_ankle': 'right_ankle',
    'right_ankle': 'left_ankle',
}

UPRIGHT_POSE = np.array([
    [-0.79, 8.0, 2.0],   # left_shoulder
    [0.79, 8.0, 2.0],    # right_shoulder
    [-1.3, 6.5, 2.0],    # left_elbow
    [1.3, 6.5, 2.0],     # right_elbow
    [-1.4, 5.0, 2.0],    # left_wrist
    [1.4, 5.0, 2.0],     # right_wrist
    [-0.6, 4.5, 2.0],    # left_hip
    [0.6, 4.5, 2.0],     # right_hip
    [-0.75, 2.4, 2.0],   # left_knee
    [0.75, 2.4, 2.0],    # right_knee
    [-0.86, 0.1, 2.0],   # left_ankle
    [0.86, 0.1, 2.0],    # right_ankle
    [0.0, 10.0, 2.0],    # head_top
    [0.0, 8.6, 2.0],     # neck
], dtype=np.float32)
