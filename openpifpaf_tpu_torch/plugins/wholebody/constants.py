"""COCO WholeBody constants: 133 keypoints (body + feet + face + hands).

Reference parity: ``src/openpifpaf/plugins/wholebody/constants.py`` — the
reference spells out all 133 names, per-part sigmas (from the COCO
WholeBody paper) and a dense skeleton.  Face/hand landmark names, sigmas
and chain skeletons are generated programmatically here (they are regular
grids of numbered landmarks); body/foot values follow the published COCO
WholeBody sigmas.

Port copy of ``openpifpaf_tpu/plugins/wholebody/constants.py``: it reads
the port's own COCO constants.
"""

import numpy as np

from ..coco import constants as coco

BODY_KEYPOINTS = list(coco.COCO_KEYPOINTS)                   # 17
FOOT_KEYPOINTS = [
    'left_big_toe', 'left_small_toe', 'left_heel',
    'right_big_toe', 'right_small_toe', 'right_heel',
]                                                            # 6
FACE_KEYPOINTS = [f'face_{i}' for i in range(68)]            # 68
LEFT_HAND_KEYPOINTS = [f'left_hand_{i}' for i in range(21)]  # 21
RIGHT_HAND_KEYPOINTS = [f'right_hand_{i}' for i in range(21)]  # 21

KEYPOINTS = (BODY_KEYPOINTS + FOOT_KEYPOINTS + FACE_KEYPOINTS
             + LEFT_HAND_KEYPOINTS + RIGHT_HAND_KEYPOINTS)   # 133

# sigmas: body from COCO; feet/face/hands from the COCO WholeBody paper's
# per-part magnitudes (feet ~0.07, face ~0.01-0.05, hands ~0.02-0.04)
SIGMAS = (
    list(coco.COCO_PERSON_SIGMAS)
    + [0.068, 0.066, 0.066, 0.068, 0.066, 0.066]     # feet
    + [0.025] * 17 + [0.020] * 10 + [0.015] * 14     # face: jaw/brow/nose+eyes
    + [0.030] * 27                                   # face: mouth region
    + [0.029, 0.022, 0.035, 0.037, 0.047,            # left hand (wrist->thumb)
       0.026, 0.025, 0.024, 0.035,                   # index
       0.018, 0.024, 0.022, 0.026,                   # middle
       0.017, 0.021, 0.021, 0.032,                   # ring
       0.020, 0.018, 0.019, 0.022]                   # pinky
    + [0.029, 0.022, 0.035, 0.037, 0.047,
       0.026, 0.025, 0.024, 0.035,
       0.018, 0.024, 0.022, 0.026,
       0.017, 0.021, 0.021, 0.032,
       0.020, 0.018, 0.019, 0.022]
)
assert len(SIGMAS) == len(KEYPOINTS) == 133


def _chain(indices):
    """Consecutive-link skeleton over 1-based keypoint indices."""
    return [(a, b) for a, b in zip(indices, indices[1:])]


def _hand_skeleton(wrist: int, base: int):
    """21-landmark hand: wrist + 4 joints per finger, MediaPipe layout."""
    edges = []
    for finger in range(5):
        first = base + 1 + finger * 4
        edges.append((wrist, first))
        edges += _chain(list(range(first, first + 4)))
    return edges


_FOOT_BASE = 17        # feet are keypoints 18..23 (1-based)
_FACE_BASE = 23        # face 24..91
_LHAND_BASE = 91       # left hand 92..112
_RHAND_BASE = 112      # right hand 113..133

SKELETON = (
    list(coco.COCO_PERSON_SKELETON)
    # feet: ankle -> heel -> toes
    + [(16, _FOOT_BASE + 3), (_FOOT_BASE + 3, _FOOT_BASE + 1),
       (_FOOT_BASE + 3, _FOOT_BASE + 2),
       (17, _FOOT_BASE + 6), (_FOOT_BASE + 6, _FOOT_BASE + 4),
       (_FOOT_BASE + 6, _FOOT_BASE + 5)]
    # face: jaw line 0..16, brows 17..26, nose 27..35, eyes 36..47,
    # outer mouth 48..59, inner mouth 60..67 (iBUG-68 layout)
    + _chain([_FACE_BASE + i for i in range(1, 18)])
    + _chain([_FACE_BASE + i for i in range(18, 23)])
    + _chain([_FACE_BASE + i for i in range(23, 28)])
    + _chain([_FACE_BASE + i for i in range(28, 37)])
    + _chain([_FACE_BASE + i for i in range(37, 43)]) \
    + [(_FACE_BASE + 42, _FACE_BASE + 37)]
    + _chain([_FACE_BASE + i for i in range(43, 49)]) \
    + [(_FACE_BASE + 48, _FACE_BASE + 43)]
    + _chain([_FACE_BASE + i for i in range(49, 61)]) \
    + [(_FACE_BASE + 60, _FACE_BASE + 49)]
    + _chain([_FACE_BASE + i for i in range(61, 69)]) \
    + [(_FACE_BASE + 68, _FACE_BASE + 61)]
    # hands, attached at the wrists (body kp 10 = left wrist, 11 = right)
    + _hand_skeleton(10, _LHAND_BASE)
    + _hand_skeleton(11, _RHAND_BASE)
)

HFLIP = dict(coco.HFLIP)
HFLIP.update({
    'left_big_toe': 'right_big_toe', 'right_big_toe': 'left_big_toe',
    'left_small_toe': 'right_small_toe', 'right_small_toe': 'left_small_toe',
    'left_heel': 'right_heel', 'right_heel': 'left_heel',
})
HFLIP.update({f'left_hand_{i}': f'right_hand_{i}' for i in range(21)})
HFLIP.update({f'right_hand_{i}': f'left_hand_{i}' for i in range(21)})
# face: iBUG-68 left-right mirror pairs
_FACE_MIRROR = (
    list(zip(range(0, 8), range(16, 8, -1)))         # jaw
    + list(zip(range(17, 22), range(26, 21, -1)))    # brows
    + [(31, 35), (32, 34)]                           # nostrils
    + [(36, 45), (37, 44), (38, 43), (39, 42), (40, 47), (41, 46)]  # eyes
    + [(48, 54), (49, 53), (50, 52), (59, 55), (58, 56),            # mouth
       (60, 64), (61, 63), (67, 65)]
)
for _a, _b in _FACE_MIRROR:
    HFLIP[f'face_{_a}'] = f'face_{_b}'
    HFLIP[f'face_{_b}'] = f'face_{_a}'


def _upright_pose():
    pose = np.zeros((133, 3), np.float32)
    pose[:17] = coco.COCO_UPRIGHT_POSE
    pose[:, 2] = 2.0
    # feet near the ankles
    la, ra = coco.COCO_UPRIGHT_POSE[15, :2], coco.COCO_UPRIGHT_POSE[16, :2]
    pose[17:20, :2] = la + np.array([[-0.1, -0.1], [-0.2, -0.1], [0.1, 0.0]])
    pose[20:23, :2] = ra + np.array([[0.1, -0.1], [0.2, -0.1], [-0.1, 0.0]])
    # face landmarks in a small ellipse around the nose
    nose = coco.COCO_UPRIGHT_POSE[0, :2]
    angles = np.linspace(0.0, 2 * np.pi, 68, endpoint=False)
    pose[23:91, 0] = nose[0] + 0.25 * np.cos(angles)
    pose[23:91, 1] = nose[1] + 0.35 * np.sin(angles)
    # hands fanned below the wrists
    lw, rw = coco.COCO_UPRIGHT_POSE[9, :2], coco.COCO_UPRIGHT_POSE[10, :2]
    spread = np.linspace(-0.2, 0.2, 21)
    pose[91:112, 0] = lw[0] + spread
    pose[91:112, 1] = lw[1] - 0.3 - 0.1 * np.abs(spread)
    pose[112:133, 0] = rw[0] + spread
    pose[112:133, 1] = rw[1] - 0.3 - 0.1 * np.abs(spread)
    return pose


UPRIGHT_POSE = _upright_pose()
