"""CifCaf decoder wrapper: batched decode -> Annotation objects.

Port of ``openpifpaf_tpu/decoder/cifcaf.py``.  Reference parity:
``src/openpifpaf/decoder/cifcaf.py:~40``.  The class-level thresholds are
the JAX package's defaults (``cifcaf.py:28-46``) with the same CLI flags
(``cifcaf.py:66-123``); ``config_for`` builds the same ``CifCafConfig`` as
``cifcaf.py:153-193``, force-complete included.  With a dense CAF head and
``--dense-connections``, the decode runs over the concatenated sparse and
dense skeletons, the dense edges' confidences scaled by the flag's value
(``cifcaf.py:49-60, 131-149``); with the flag at 0 the dense head is
ignored.  The single-image ``__call__`` renders the debug views of
``--debug-indices`` first (``cifcaf.py:234-295``); ``batch_fields``, the
path of ``Predictor``, renders none, as in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Tuple

import numpy as np
import torch

from .decoder import Decoder
from .. import headmeta, visualizer
from ..annotation import Annotation
from ..device import resolve_device
from ..models.heads import split_fields
from ..ops import CifCafConfig, make_batch_decoder
from ..ops import caf_scored, cif_hr, common, growth, nms, pipeline, seeds

LOG = logging.getLogger(__name__)


class CifCaf(Decoder):
    # class-level configuration (reference static thresholds)
    seed_threshold = 0.2
    keypoint_threshold = 0.15
    keypoint_threshold_rel = 0.5
    instance_threshold = 0.15
    caf_score_th = 0.2
    cif_hr_v_threshold = 0.1
    force_complete = False
    force_complete_caf_th = 0.001  # relaxed CAF threshold in that mode
    reverse_match = True
    connection_blend = True
    dense_connections = 0.0
    max_poses = 96
    max_seeds = 512
    max_caf_candidates = 256
    cif_hr_max_active = 1024
    hr_spacing = 2

    def __init__(self, cif_meta: headmeta.Cif, caf_meta: headmeta.Caf,
                 dense_caf_meta: headmeta.Caf = None, *, device=None):
        self.cif_meta = cif_meta
        self.base_caf_meta = caf_meta
        self.dense_caf_meta = dense_caf_meta
        # decided once: the flag is a class attribute that a later
        # configure may change
        self.uses_dense = dense_caf_meta is not None and bool(
            self.dense_connections)
        if self.uses_dense:
            # decode over the concatenated sparse + dense skeleton, the
            # dense edges' confidence scaled (reference --dense-connections)
            dense = dataclasses.replace(dense_caf_meta)
            dense.decoder_confidence_scales = \
                [self.dense_connections] * len(dense.skeleton)
            self.caf_meta = headmeta.Caf.concatenate([caf_meta, dense])
        else:
            self.caf_meta = caf_meta
        self.device = resolve_device(device)
        self._decoders = {}  # image_hw -> batched decode

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('CifCaf decoder')
        group.add_argument('--seed-threshold', default=cls.seed_threshold,
                           type=float, help='minimum seed value')
        group.add_argument('--keypoint-threshold',
                           default=cls.keypoint_threshold, type=float,
                           help='minimum grown keypoint score')
        group.add_argument('--keypoint-threshold-rel',
                           default=cls.keypoint_threshold_rel, type=float,
                           help='min keypoint score relative to source joint')
        group.add_argument('--instance-threshold',
                           default=cls.instance_threshold, type=float,
                           help='minimum pose score')
        group.add_argument('--caf-score-th', default=cls.caf_score_th,
                           type=float, help='CAF candidate threshold')
        group.add_argument('--force-complete-pose', dest='force_complete',
                           default=cls.force_complete, action='store_true',
                           help='relaxed second growth pass to fill poses')
        group.add_argument('--force-complete-caf-th',
                           default=cls.force_complete_caf_th, type=float,
                           help='CAF candidate threshold used with '
                                '--force-complete-pose')
        group.add_argument('--no-reverse-match', dest='reverse_match',
                           default=cls.reverse_match, action='store_false',
                           help='disable reverse-match confirmation')
        group.add_argument('--connection-method',
                           default='blend' if cls.connection_blend else 'max',
                           choices=('blend', 'max'),
                           help='association candidate combination')
        group.add_argument('--dense-connections', nargs='?',
                           type=float, default=cls.dense_connections,
                           const=1.0,
                           help='use dense skeleton connections at this '
                                'confidence scale')
        group.add_argument('--decoder-max-poses', default=cls.max_poses,
                           type=int, help='static pose budget per image')
        group.add_argument('--decoder-max-seeds', default=cls.max_seeds,
                           type=int, help='static seed budget per image')
        group.add_argument('--cifhr-max-active', default=cls.cif_hr_max_active,
                           type=int,
                           help='CifHr active-cell compaction budget per '
                                'field (0 = exact dense splat)')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.seed_threshold = args.seed_threshold
        cls.keypoint_threshold = args.keypoint_threshold
        cls.keypoint_threshold_rel = args.keypoint_threshold_rel
        cls.instance_threshold = args.instance_threshold
        cls.caf_score_th = args.caf_score_th
        cls.force_complete = args.force_complete
        cls.force_complete_caf_th = args.force_complete_caf_th
        cls.reverse_match = args.reverse_match
        cls.connection_blend = args.connection_method == 'blend'
        cls.dense_connections = args.dense_connections
        cls.max_poses = args.decoder_max_poses
        cls.max_seeds = args.decoder_max_seeds
        cls.cif_hr_max_active = args.cifhr_max_active

    @classmethod
    def match(cls, head_metas) -> bool:
        return (len(head_metas) >= 2
                and isinstance(head_metas[0], headmeta.Cif)
                and isinstance(head_metas[1], headmeta.Caf))

    @classmethod
    def factory(cls, head_metas, *, device=None) -> List['CifCaf']:
        if not cls.match(head_metas):
            return []
        dense = None
        if len(head_metas) >= 3 and isinstance(head_metas[2], headmeta.Caf):
            dense = head_metas[2]
        return [cls(head_metas[0], head_metas[1], dense_caf_meta=dense,
                    device=device)]

    def caf_fields(self, fields):
        """The CAF fields the decode takes, batched: the sparse head's, with
        the dense head's concatenated along the edge axis under
        ``--dense-connections``."""
        base = fields[self.base_caf_meta.head_index]
        if not self.uses_dense:
            return base
        dense = fields[self.dense_caf_meta.head_index]
        return torch.cat([torch.as_tensor(base), torch.as_tensor(dense)],
                         dim=1)

    def config_for(self, image_hw: Tuple[int, int]) -> CifCafConfig:
        """The decode configuration; on the card the CifHr profiles are
        f32 (the kernel's), on the CPU bf16-rounded as in the JAX default
        unless ``--cifhr-f32-profiles``."""
        return CifCafConfig(
            stride=self.cif_meta.stride,
            image_hw=tuple(image_hw),
            cifhr=cif_hr.CifHrConfig(
                v_threshold=self.cif_hr_v_threshold,
                spacing=self.hr_spacing,
                min_scale=self.cif_meta.decoder_min_scale,
                max_active=self.cif_hr_max_active,
                profile_bf16=self.profile_bf16(self.device)),
            seeds=seeds.SeedsConfig(
                threshold=self.seed_threshold,
                max_seeds=self.max_seeds),
            # the first growth pass always takes candidates at the normal
            # threshold: relaxed ones would evict the strong ones from the
            # fixed top-C budget
            caf=caf_scored.CafScoredConfig(
                score_th=self.caf_score_th,
                max_candidates=self.max_caf_candidates),
            # --force-complete-pose: a separately thresholded candidate set
            # with twice the budget, taken only by the second pass
            caf_fc=(caf_scored.CafScoredConfig(
                score_th=self.force_complete_caf_th,
                max_candidates=2 * self.max_caf_candidates)
                if self.force_complete else None),
            growth=growth.GrowthConfig(
                keypoint_threshold=self.keypoint_threshold,
                keypoint_threshold_rel=self.keypoint_threshold_rel,
                reverse_match=self.reverse_match,
                connection_blend=self.connection_blend,
                max_poses=self.max_poses,
                force_complete=self.force_complete),
            nms=nms.NMSConfig(
                instance_threshold=self.instance_threshold,
                # force-complete implies keypoint_threshold 0.0 at NMS, or
                # the joints the relaxed second pass placed are zeroed again
                keypoint_threshold=(0.0 if self.force_complete
                                    else self.keypoint_threshold)),
        )

    def _decoder_for(self, image_hw: Tuple[int, int]):
        key = tuple(image_hw)
        if key not in self._decoders:
            LOG.info('building the decoder for image size %s', key)
            self._decoders[key] = make_batch_decoder(
                cif_meta=self.cif_meta, caf_meta=self.caf_meta,
                config=self.config_for(key), device=self.device)
        return self._decoders[key]

    def decoded_to_annotations(self, decoded_i) -> List[Annotation]:
        """Convert one image's numpy DecodedPoses slice to Annotations,
        in descending score order."""
        annotations = []
        for p in np.argsort(-decoded_i.scores):
            if not decoded_i.valid[p]:
                continue
            ann = Annotation(self.cif_meta.keypoints, self.caf_meta.skeleton,
                             sigmas=self.cif_meta.sigmas,
                             score_weights=self.cif_meta.score_weights)
            ann.data[:] = decoded_i.xyv[p]
            ann.joint_scales[:] = decoded_i.joint_scales[p]
            ann.fixed_score = float(decoded_i.scores[p])
            annotations.append(ann)
        return annotations

    def batch_decoded(self, fields):
        """Batched decode on the device: ``DecodedPoses`` of tensors."""
        cif_fields = fields[self.cif_meta.head_index]
        caf_fields = self.caf_fields(fields)
        h, w = cif_fields.shape[-2:]
        stride = self.cif_meta.stride
        image_hw = ((h - 1) * stride + 1, (w - 1) * stride + 1)
        return self._decoder_for(image_hw)(cif_fields, caf_fields)

    def batch_fields(self, fields, metas=None) -> List[List[Annotation]]:
        return self.annotations_from_decoded(self.batch_decoded(fields))

    def annotations_from_decoded(self, decoded) -> List[List[Annotation]]:
        """``batch_decoded``'s tensors -> per image the annotations."""
        # one device->host transfer for the whole batch, then slice
        decoded_np = type(decoded)(*[x.cpu().numpy() for x in decoded])
        return [self.decoded_to_annotations(
                    type(decoded_np)(*[x[i] for x in decoded_np]))
                for i in range(decoded_np.valid.shape[0])]

    def __call__(self, fields) -> List[Annotation]:
        """Decode one image: fields = [cif (F,5,H,W), caf (E,9,H,W)],
        tensors on any device or arrays."""
        batched = [(f if isinstance(f, torch.Tensor)
                    else torch.as_tensor(np.asarray(f)))[None] for f in fields]
        self._debug_visualize(batched)
        return self.batch_fields(batched)[0]

    @torch.no_grad()
    def _debug_visualize(self, fields) -> None:
        """The debug views of ``--debug-indices`` for one image's batched
        fields (JAX ``cifcaf.py:240-295``): the activated CIF and CAF
        fields, the CifHr map (K1 on the card) and the seeds, computed on
        the decoder's device and read back once per array handed to a
        visualizer (``common.read_back``).  With no index set it returns
        before it touches a tensor: no launch, no host sync."""
        if not visualizer.Base.all_indices:
            return
        cif_fields = torch.as_tensor(fields[self.cif_meta.head_index],
                                     dtype=torch.float32, device=self.device)
        caf_fields = torch.as_tensor(self.caf_fields(fields),
                                     dtype=torch.float32, device=self.device)
        h, w = cif_fields.shape[-2:]
        stride = self.cif_meta.stride
        config = self.config_for(((h - 1) * stride + 1, (w - 1) * stride + 1))

        cif = split_fields(cif_fields, self.cif_meta)
        x_px, y_px, scale_px = pipeline.cif_positions(cif, stride)
        visualizer.Cif(self.cif_meta).predicted(common.read_back(torch.stack([
            cif.conf[0], cif.vec[0, :, 0, 0], cif.vec[0, :, 0, 1],
            cif.spread[0, :, 0], cif.scale[0, :, 0]], dim=1)))

        caf = split_fields(caf_fields, self.caf_meta)
        visualizer.Caf(self.caf_meta).predicted(common.read_back(torch.stack([
            caf.conf[0], caf.vec[0, :, 0, 0], caf.vec[0, :, 0, 1],
            caf.vec[0, :, 1, 0], caf.vec[0, :, 1, 1],
            caf.spread[0, :, 0], caf.spread[0, :, 1],
            caf.scale[0, :, 0], caf.scale[0, :, 1]], dim=1)))

        hr = cif_hr.accumulate(cif.conf, x_px, y_px, scale_px,
                               out_hw=config.hr_hw, config=config.cifhr)
        visualizer.CifHr(self.cif_meta).predicted(
            common.read_back(hr[0]), spacing=config.cifhr.spacing)

        sds = seeds.select(cif.conf, x_px, y_px, scale_px, hr,
                           hr_spacing=config.cifhr.spacing,
                           config=config.seeds)
        visualizer.Seeds(field_names=self.cif_meta.keypoints).predicted(
            common.read_back(torch.stack([
                sds.v[0], sds.f[0].float(), sds.x[0], sds.y[0], sds.s[0]],
                dim=-1)))
