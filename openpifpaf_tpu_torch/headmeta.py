"""Head metadata: the lingua franca between datasets, networks and decoders.

Reference parity: ``src/openpifpaf/headmeta.py`` — dataclasses ``Cif``
(``:~20``) and ``Caf`` (``:~60``).  A head meta describes *what* a composite-field head predicts:
which keypoints/categories, how many confidence/vector/scale components per
field, the skeleton for association fields, sigmas for OKS-style scoring and
the feature-map stride.

These objects are pure data; every subsystem (encoders that paint training
targets, network heads that size their conv channels, decoders that grow
skeletons, visualizers) reads them.

Port copy of ``openpifpaf_tpu/headmeta.py``: the PyTorch package keeps its
own copy so that it imports nothing of the JAX package.  It holds the
metas of the ported CifCaf path, ``Caf.concatenate`` (the sparse and dense
skeletons of ``--dense-connections``) included, and ``Tcaf``, the temporal
association head of the tracking models, and ``CifDet``, the detection
head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, List, Optional, Tuple


@dataclasses.dataclass
class Base:
    """Common head metadata.

    :param name: head name, e.g. ``'cif'``; combined with ``dataset`` it
        uniquely identifies a head (``'cocokp.cif'``).
    :param dataset: dataset slug, e.g. ``'cocokp'``.
    """

    name: str
    dataset: str

    # set by the network factory once the head is attached to a backbone
    head_index: Optional[int] = dataclasses.field(default=None, compare=False)
    base_stride: Optional[int] = dataclasses.field(default=None, compare=False)
    upsample_stride: int = dataclasses.field(default=1, compare=False)

    @property
    def stride(self) -> int:
        """Effective output stride of this head (backbone stride / upsample)."""
        if self.base_stride is None:
            raise ValueError(f'head meta {self.name}: base_stride not set')
        return self.base_stride // self.upsample_stride

    # channel layout ----------------------------------------------------
    @property
    def n_fields(self) -> int:
        raise NotImplementedError

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 0
    n_scales: ClassVar[int] = 0

    @property
    def n_components(self) -> int:
        """Channels per field: confidences + 3 per vector (x, y, spread b) + scales."""
        return self.n_confidences + 3 * self.n_vectors + self.n_scales


@dataclasses.dataclass
class Cif(Base):
    """Composite Intensity Field metadata (keypoint detection).

    Reference: ``headmeta.py:~20``.  Each feature cell predicts, per keypoint
    type: (confidence, offset x, offset y, spread b, keypoint scale sigma).
    """

    keypoints: List[str] = None
    sigmas: List[float] = None
    pose: Any = None
    draw_skeleton: Optional[List[Tuple[int, int]]] = None
    score_weights: Optional[List[float]] = None

    training_weights: Optional[List[float]] = None

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 1
    n_scales: ClassVar[int] = 1

    vector_offsets = [True]
    decoder_min_scale = 0.0
    decoder_seed_mask: Optional[List[int]] = None

    @property
    def n_fields(self) -> int:
        return len(self.keypoints)


@dataclasses.dataclass
class Caf(Base):
    """Composite Association Field metadata (skeleton edges).

    Reference: ``headmeta.py:~60``.  Each feature cell predicts, per skeleton
    edge: (confidence, offset1 x/y, offset2 x/y, spread b1, spread b2,
    scale1, scale2).
    """

    keypoints: List[str] = None
    sigmas: List[float] = None
    skeleton: List[Tuple[int, int]] = None  # 1-based keypoint indices
    pose: Any = None
    sparse_skeleton: Optional[List[Tuple[int, int]]] = None
    dense_to_sparse_radius: float = 2.0
    only_in_field_of_view: bool = False

    training_weights: Optional[List[float]] = None

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 2
    n_scales: ClassVar[int] = 2

    vector_offsets = [True, True]
    decoder_min_distance = 0.0
    decoder_max_distance = float('inf')
    decoder_confidence_scales: Optional[List[float]] = None

    @property
    def n_fields(self) -> int:
        return len(self.skeleton)

    @staticmethod
    def concatenate(metas: List['Caf']) -> 'Caf':
        """Merge several CAF metas into one (the sparse and dense skeletons
        of ``--dense-connections``).  Reference: ``headmeta.py``
        ``Caf.concatenate``.  The skeletons are joined in order, the strides
        and the head index are the first meta's, and a meta without
        ``decoder_confidence_scales`` contributes 1.0 per edge."""
        concatenated = Caf(
            name='_'.join(m.name for m in metas),
            dataset=metas[0].dataset,
            keypoints=metas[0].keypoints,
            sigmas=metas[0].sigmas,
            pose=metas[0].pose,
            skeleton=[s for meta in metas for s in meta.skeleton],
            sparse_skeleton=metas[0].sparse_skeleton,
            only_in_field_of_view=metas[0].only_in_field_of_view,
        )
        concatenated.head_index = metas[0].head_index
        concatenated.base_stride = metas[0].base_stride
        concatenated.upsample_stride = metas[0].upsample_stride
        concatenated.decoder_confidence_scales = [
            w for meta in metas
            for w in (meta.decoder_confidence_scales
                      if meta.decoder_confidence_scales is not None
                      else [1.0] * len(meta.skeleton))]
        return concatenated


@dataclasses.dataclass
class CifDet(Base):
    """Composite detection field metadata (object detection variant).

    Reference: ``headmeta.py:~110``.  Each cell predicts, per category:
    (confidence, center offset x/y, box width and height as a second
    vector), 1 + 3 * 2 = 7 components.
    """

    categories: List[str] = None

    training_weights: Optional[List[float]] = None

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 2   # center offset + (w, h) as a second vector
    n_scales: ClassVar[int] = 0

    vector_offsets = [True, False]
    decoder_min_scale = 0.0

    @property
    def n_fields(self) -> int:
        return len(self.categories)


@dataclasses.dataclass
class Tcaf(Base):
    """Temporal Composite Association Field metadata (tracking across frames).

    Reference: ``headmeta.py:~150``.  Associates the same keypoint type
    between two consecutive frames: per keypoint, (confidence, offset in
    frame 1, offset in frame 2, two spreads, two scales), 1 + 2 * 2 + 2 + 2
    = 9 components.
    """

    keypoints_single_frame: List[str] = None
    sigmas_single_frame: List[float] = None
    pose_single_frame: Any = None
    draw_skeleton_single_frame: Optional[List[Tuple[int, int]]] = None
    keypoints: List[str] = None
    sigmas: List[float] = None
    pose: Any = None
    draw_skeleton: Optional[List[Tuple[int, int]]] = None

    only_in_field_of_view: bool = False
    training_weights: Optional[List[float]] = None

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 2
    n_scales: ClassVar[int] = 2

    vector_offsets = [True, True]

    @property
    def skeleton(self):
        """The temporal 'skeleton': keypoint k in frame t-1 <-> keypoint k
        in frame t (1-based, the second frame's keypoints after the
        first's)."""
        n = len(self.keypoints_single_frame)
        return [(i + 1, i + 1 + n) for i in range(n)]

    @property
    def n_fields(self) -> int:
        return len(self.keypoints_single_frame)
