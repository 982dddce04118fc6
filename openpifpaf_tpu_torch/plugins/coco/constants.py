"""COCO person keypoint constants.

Reference parity: ``src/openpifpaf/plugins/coco/constants.py:~20`` — the 17
COCO keypoint names, the 19-edge openpifpaf person skeleton, per-keypoint
OKS sigmas, an upright canonical pose, horizontal-flip swap pairs and a
denser auxiliary connection set.  Keypoints/sigmas/skeleton are standard
COCO dataset constants; the dense connection list is an approximation of the
reference's (could not be byte-checked against the tree, see SURVEY.md
provenance caveat) and only feeds the optional ``--dense-connections``
decoding mode at reduced confidence.

Port copy of ``openpifpaf_tpu/plugins/coco/constants.py``.
"""

import numpy as np

COCO_CATEGORIES = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush',
]

COCO_KEYPOINTS = [
    'nose',            # 1
    'left_eye',        # 2
    'right_eye',       # 3
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

# openpifpaf 19-edge person skeleton (1-based indices)
COCO_PERSON_SKELETON = [
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13),
    (6, 12), (7, 13), (6, 7), (6, 8), (7, 9),
    (8, 10), (9, 11), (2, 3), (1, 2), (1, 3),
    (2, 4), (3, 5), (4, 6), (5, 7),
]

KINEMATIC_TREE_SKELETON = [
    (1, 2), (2, 4),          # left head
    (1, 3), (3, 5),          # right head
    (1, 6), (6, 8), (8, 10),  # left arm
    (1, 7), (7, 9), (9, 11),  # right arm
    (6, 12), (12, 14), (14, 16),  # left side
    (7, 13), (13, 15), (15, 17),  # right side
]

COCO_PERSON_SIGMAS = [
    0.026, 0.025, 0.025, 0.035, 0.035,
    0.079, 0.079, 0.072, 0.072, 0.062,
    0.062, 0.107, 0.107, 0.087, 0.087,
    0.089, 0.089,
]

COCO_PERSON_SCORE_WEIGHTS = [3.0] * 3 + [1.0] * (len(COCO_KEYPOINTS) - 3)

COCO_UPRIGHT_POSE = np.array([
    [0.0, 9.3, 2.0],    # nose
    [-0.35, 9.7, 2.0],  # left_eye
    [0.35, 9.7, 2.0],   # right_eye
    [-0.7, 9.5, 2.0],   # left_ear
    [0.7, 9.5, 2.0],    # right_ear
    [-1.4, 8.0, 2.0],   # left_shoulder
    [1.4, 8.0, 2.0],    # right_shoulder
    [-1.75, 6.0, 2.0],  # left_elbow
    [1.75, 6.2, 2.0],   # right_elbow
    [-1.75, 4.0, 2.0],  # left_wrist
    [1.75, 4.2, 2.0],   # right_wrist
    [-1.26, 4.0, 2.0],  # left_hip
    [1.26, 4.0, 2.0],   # right_hip
    [-1.4, 2.0, 2.0],   # left_knee
    [1.4, 2.1, 2.0],    # right_knee
    [-1.4, 0.0, 2.0],   # left_ankle
    [1.4, 0.1, 2.0],    # right_ankle
], dtype=np.float32)

HFLIP = {
    'left_eye': 'right_eye',
    'right_eye': 'left_eye',
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

# Auxiliary shortcut connections for --dense-connections decoding
# (approximation of the reference's DENSER_COCO_PERSON_CONNECTIONS).
DENSER_COCO_PERSON_CONNECTIONS = [
    (1, 6), (1, 7),      # nose - shoulders
    (2, 5), (3, 4),      # crossed eye - ear
    (6, 10), (7, 11),    # shoulder - wrist
    (6, 13), (7, 12),    # crossed shoulder - hip
    (12, 16), (13, 17),  # hip - ankle
    (8, 12), (9, 13),    # elbow - hip
    (10, 12), (11, 13),  # wrist - hip
    (4, 7), (5, 6),      # crossed ear - shoulder
    (14, 17), (15, 16),  # crossed knee - ankle
]


def draw_skeletons():  # pragma: no cover - documentation helper
    """Print the skeleton with names for inspection."""
    for j1, j2 in COCO_PERSON_SKELETON:
        print(f'{COCO_KEYPOINTS[j1 - 1]:>16} -- {COCO_KEYPOINTS[j2 - 1]}')
