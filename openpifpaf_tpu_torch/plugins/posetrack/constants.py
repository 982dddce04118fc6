"""PoseTrack keypoint constants.

A copy of ``openpifpaf_tpu/plugins/posetrack/constants.py``: the 17
PoseTrack2018 keypoint names (COCO's with ``head_bottom`` and ``head_top``
in place of the eyes), their sigmas, the skeleton, the hflip pairs and the
upright pose.
"""

import numpy as np

KEYPOINTS = [
    'nose',            # 1
    'head_bottom',     # 2
    'head_top',        # 3
    'left_ear',        # 4
    'right_ear',       # 5
    'left_shoulder',   # 6
    'right_shoulder',  # 7
    'left_elbow',      # 8
    'right_elbow',     # 9
    'left_wrist',      # 10
    'right_wrist',     # 11
    'left_hip',        # 12
    'right_hip',       # 13
    'left_knee',       # 14
    'right_knee',      # 15
    'left_ankle',      # 16
    'right_ankle',     # 17
]

SIGMAS = [
    0.026,  # nose
    0.08,   # head_bottom
    0.06,   # head_top
    0.035,  # ears
    0.035,
    0.079,  # shoulders
    0.079,
    0.072,  # elbows
    0.072,
    0.062,  # wrists
    0.062,
    0.107,  # hips
    0.107,
    0.087,  # knees
    0.087,
    0.089,  # ankles
    0.089,
]

SKELETON = [
    (1, 2), (2, 3), (1, 4), (1, 5), (4, 6), (5, 7), (2, 6), (2, 7),
    (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (6, 12), (7, 13), (12, 13),
    (12, 14), (13, 15), (14, 16), (15, 17),
]

HFLIP = {
    'left_ear': 'right_ear',
    'right_ear': 'left_ear',
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
    [0.0, 9.3, 2.0],    # nose
    [0.0, 8.6, 2.0],    # head_bottom
    [0.0, 10.0, 2.0],   # head_top
    [-0.35, 9.4, 2.0],  # left_ear
    [0.35, 9.4, 2.0],   # right_ear
    [-0.79, 8.0, 2.0],  # left_shoulder
    [0.79, 8.0, 2.0],   # right_shoulder
    [-1.3, 6.5, 2.0],   # left_elbow
    [1.3, 6.5, 2.0],    # right_elbow
    [-1.4, 5.0, 2.0],   # left_wrist
    [1.4, 5.0, 2.0],    # right_wrist
    [-0.6, 4.5, 2.0],   # left_hip
    [0.6, 4.5, 2.0],    # right_hip
    [-0.75, 2.4, 2.0],  # left_knee
    [0.75, 2.4, 2.0],   # right_knee
    [-0.86, 0.1, 2.0],  # left_ankle
    [0.86, 0.1, 2.0],   # right_ankle
], dtype=np.float32)
