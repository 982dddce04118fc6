"""Predictor: batched inference API — preprocess, forward, decode.

Port of ``openpifpaf_tpu/predictor.py``.  Reference parity:
``src/openpifpaf/predictor.py:~60``.  ``batch`` and ``numpy_images`` take
NHWC numpy arrays (``(H, W, 3)`` uint8 each), rescale and centre pad them
to one square size, run the model (NCHW inside) and the batched CifCaf
decode on the same device, and map the annotations back to the original
image coordinates.  ``dataset``/``dataset_loader`` do the same for a data
module's eval batches (images already preprocessed by
``preprocess_factory``'s transforms), and ``merge_annotations`` with
``multiscale_variants`` make the multi-scale eval.  ``images(paths)`` and
``image(path)`` read image files (``datasets.ImageList``: PNG, JPEG and
BMP, without PIL) through the same eval transforms, at one
scale or, with ``multi_scale``, at several (``images_multiscale``).
With ``data_parallel`` (``--dp-eval``) in a process group of more than
one rank, each eval batch is padded to a multiple of the group's size
with copies of its last image, and each rank runs the forward (K2) and the
decode (K1) on its contiguous slice, on its own card; the static-shaped
decoded tensors are gathered (``parallel.all_gather``), the padding
dropped, and every rank builds the whole batch's annotations (the JAX
``predictor.py:63-104,141-163``).  A decoder without ``batch_decoded``
runs undistributed, with JAX's warning; at a world of one the flag changes
nothing.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from . import datasets, decoder as decoder_mod, models, parallel, transforms
from .decoder.pose_similarity import oks_matrix
from .device import resolve_device
from .profiler import Profiler

LOG = logging.getLogger(__name__)


class Predictor:
    batch_size = 1
    long_edge = 641
    loader_workers: Optional[int] = None
    # multi-scale prediction: decode at several long edges (and their
    # hflips) and merge with OKS suppression
    multi_scale = False
    multi_scale_hflip = True
    multi_scale_factors = (0.75, 1.0, 1.25)
    # shard eval batches over the ranks of the process group (--dp-eval)
    data_parallel = False

    def __init__(self, *, checkpoint: Optional[str] = None,
                 model: Optional[models.Model] = None,
                 base_name: Optional[str] = None, head_metas=None,
                 json_data: bool = False, device=None, bf16: bool = True,
                 seed: int = 0, norm: str = 'batchnorm', **network):
        """``device=None`` means the card (raises without CUDA).  The model
        is ``model``, else a JAX-package ``checkpoint`` npz (its heads
        grafted onto ``head_metas`` where they differ), else a fresh
        ``base_name`` model with weights from ``seed``; ``norm`` is the
        backbone's normalization (``--basenet-norm``), ``network`` the head
        options (``models.network_options``)."""
        self.device = resolve_device(device)
        if model is None:
            model = models.factory(base_name, head_metas,
                                   checkpoint=checkpoint, bf16=bf16,
                                   device=self.device, seed=seed, norm=norm,
                                   **network)
        elif model.device != self.device:
            raise ValueError(f'model on {model.device}, predictor on '
                             f'{self.device}')
        self.model = model
        self.decoder = decoder_mod.factory(model.head_metas,
                                           device=self.device)
        self.json_data = json_data
        self.last_preprocess_time = 0.0
        self.last_nn_time = 0.0
        self.last_decoder_time = 0.0
        self.total_nn_time = 0.0
        self.total_decoder_time = 0.0
        self.total_images = 0
        self.group = None
        if self.data_parallel and parallel.world() > 1:
            self._join_group()

    def _join_group(self) -> None:
        if not hasattr(self.decoder, 'batch_decoded'):
            LOG.warning('%s has no batch_decoded tensor path; multi-process '
                        '--dp-eval disabled', type(self.decoder).__name__)
            return
        self.group = parallel.data_group()
        n = parallel.world(self.group)
        parallel.replicate(self.model.module, self.group)
        self.model.refold()
        LOG.info('multi-process data-parallel eval: %d processes', n)
        if self.batch_size < n:
            LOG.warning('batch size %d < %d processes: batches are padded '
                        'with copies and the extra decodes discarded: set '
                        '--predictor-batch-size >= %d for actual speedup',
                        self.batch_size, n, n)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group('Predictor')
        group.add_argument('--long-edge', default=cls.long_edge, type=int,
                           help='rescale the long side and pad to this size')
        group.add_argument('--predictor-batch-size',
                           dest='predictor_batch_size',
                           default=cls.batch_size, type=int,
                           help='prediction batch size')
        group.add_argument('--dp-eval', dest='predictor_data_parallel',
                           default=cls.data_parallel, action='store_true',
                           help='shard prediction batches over the ranks of '
                                'the process group (eval: one process per '
                                'card, started by torchrun)')
        group.add_argument('--multi-scale', dest='predictor_multi_scale',
                           default=cls.multi_scale, action='store_true',
                           help='predict at multiple scales and merge')
        group.add_argument('--no-multi-scale-hflip',
                           dest='predictor_multi_scale_hflip',
                           default=cls.multi_scale_hflip,
                           action='store_false',
                           help='skip the hflipped variants in --multi-scale')
        group.add_argument('--multi-scale-factors', nargs='+', type=float,
                           dest='predictor_multi_scale_factors',
                           default=list(cls.multi_scale_factors),
                           help='long-edge factors for --multi-scale')

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        cls.long_edge = args.long_edge
        cls.batch_size = args.predictor_batch_size
        cls.data_parallel = args.predictor_data_parallel
        cls.multi_scale = args.predictor_multi_scale
        cls.multi_scale_hflip = args.predictor_multi_scale_hflip
        cls.multi_scale_factors = tuple(args.predictor_multi_scale_factors)

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def preprocess(self, images: Sequence[np.ndarray]):
        """NHWC images -> ((B, 3, S, S) float32 on the device, metas)."""
        out = [transforms.preprocess(im, self.long_edge, self.device)
               for im in images]
        return torch.stack([t for t, _ in out]), [m for _, m in out]

    def batch(self, images: Sequence[np.ndarray]) -> List[Tuple[List, dict]]:
        """Predict one batch: a list of (annotations, meta) per image, the
        annotations in original image coordinates (json dicts with
        ``json_data``).  Times each stage, synchronizing the card."""
        start = time.perf_counter()
        x, metas = self.preprocess(images)
        self._sync()
        self.last_preprocess_time = time.perf_counter() - start

        start = time.perf_counter()
        fields = self.model(x)
        self._sync()
        self.last_nn_time = time.perf_counter() - start

        start = time.perf_counter()
        pred_batch = self.decode(fields, metas)
        self.last_decoder_time = time.perf_counter() - start

        results = []
        for preds, meta in zip(pred_batch, metas):
            preds = [ann.inverse_transform(meta) for ann in preds]
            if self.json_data:
                preds = [ann.json_data() for ann in preds]
            results.append((preds, meta))
        return results

    def decode(self, fields, metas) -> List[List]:
        """The decoder on a batch's fields; under ``Profiler`` with
        ``--profile-decoder`` (``Decoder.profile``, the file of its
        cProfile stats), as the JAX ``Predictor`` does."""
        if decoder_mod.Decoder.profile:
            with Profiler(out_name=decoder_mod.Decoder.profile)():
                return self.decoder.batch_fields(fields, metas=metas)
        return self.decoder.batch_fields(fields, metas=metas)

    # ------------------------------------------------------------------
    def preprocess_factory(self, *, long_edge: Optional[int] = None,
                           hflip: bool = False) -> transforms.Preprocess:
        """The eval transforms: annotations normalized, the image mirrored
        with ``hflip``, rescaled and centre padded to ``long_edge``
        (default ``self.long_edge``), then normalized to a tensor."""
        long_edge = long_edge or self.long_edge
        meta0 = self.model.head_metas[0]
        keypoints = getattr(meta0, 'keypoints', []) or []
        steps = [transforms.NormalizeAnnotations(
            keypoints=keypoints,
            skeleton=getattr(meta0, 'draw_skeleton', []) or [])]
        if hflip:
            steps.append(transforms.HFlip(
                keypoints, transforms.hflip_map_from_keypoints(keypoints)))
        steps += [
            transforms.RescaleAbsolute(long_edge),
            transforms.CenterPad(long_edge),
            transforms.EVAL_TRANSFORM,
        ]
        return transforms.Compose(steps)

    def dataset(self, data, *, json_data: Optional[bool] = None
                ) -> Iterator[Tuple[List, List, dict]]:
        """Iterate (pred, gt_anns, meta) over a dataset or a loader of
        eval batches."""
        loader = data
        if not isinstance(data, DataLoader):
            loader = DataLoader(
                data, batch_size=self.batch_size, shuffle=False,
                collate_fn=datasets.collate_images_anns_meta,
                num_workers=self.loader_workers or 0, drop_last=False)
        yield from self.dataset_loader(loader, json_data=json_data)

    def dataset_loader(self, loader, *, json_data: Optional[bool] = None
                       ) -> Iterator[Tuple[List, List, dict]]:
        """Iterate (pred, gt_anns, meta) over eval batches ``(images (B, 3,
        H, W), anns, metas)``: each batch moves to ``self.device``, runs
        the model and the batched decode; predictions and ground truth are
        mapped back to the original image coordinates.  The card is
        synchronized before every clock read, so ``total_nn_time`` and
        ``total_decoder_time`` hold the work, not its launches."""
        if json_data is None:
            json_data = self.json_data
        for images, gt_batch, meta_batch in loader:
            self._sync()
            start = time.perf_counter()
            n = images.shape[0]
            if self.group is not None:
                images = self._shard(images)
            fields = self.model(images.to(self.device))
            self._sync()
            self.last_nn_time = time.perf_counter() - start
            self.total_nn_time += self.last_nn_time

            start = time.perf_counter()
            if self.group is not None:
                decoded = self.decoder.batch_decoded(fields)
                pred_batch = self.decoder.annotations_from_decoded(
                    type(decoded)(*[parallel.all_gather(t, self.group)[:n]
                                    for t in decoded]))
            else:
                pred_batch = self.decode(fields, meta_batch)
            self._sync()
            self.last_decoder_time = time.perf_counter() - start
            self.total_decoder_time += self.last_decoder_time
            self.total_images += len(meta_batch)

            for preds, gts, meta in zip(pred_batch, gt_batch, meta_batch):
                preds = [ann.inverse_transform(meta) for ann in preds]
                gts = [ann.inverse_transform(meta) for ann in gts]
                if json_data:
                    preds = [ann.json_data() for ann in preds]
                yield preds, gts, meta

    def _shard(self, images: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a batch padded to a multiple of the group's
        size with copies of its last image (the JAX ``_place_batch``)."""
        pad = (-images.shape[0]) % parallel.world(self.group)
        if pad:
            images = torch.cat([images, images[-1:].expand(
                pad, *images.shape[1:])])
        return parallel.shard_batch(images, self.group)

    # -- multi-scale ----------------------------------------------------
    @staticmethod
    def merge_annotations(annotation_lists, *, sigmas=None,
                          oks_threshold: float = 0.7,
                          reference_index: int = 0):
        """Merge per-scale annotation sets (already in original image
        coordinates): greedy score-ordered OKS suppression.  The sort is
        Python's stable sort over the variants in their order, so ties
        keep the earlier variant's pose."""
        # OKS merging is keypoint-only; box-only annotations pass through
        # from the reference variant unmerged
        passthrough = [a for a in (annotation_lists[reference_index]
                                   if annotation_lists else [])
                       if getattr(a, 'data', None) is None]
        annotation_lists = [[a for a in anns
                             if getattr(a, 'data', None) is not None]
                            for anns in annotation_lists]

        merged = []
        candidates = sorted((a for anns in annotation_lists for a in anns),
                            key=lambda a: -a.score)
        for ann in candidates:
            if sigmas is None:
                sig = np.full(ann.data.shape[0], 0.05, np.float32)
            else:
                sig = np.asarray(sigmas, np.float32)
            if any(oks_matrix(kept.data[None], ann.data[None], sig)[0, 0]
                   > oks_threshold for kept in merged):
                continue
            merged.append(ann)
        return merged + passthrough

    def multiscale_variants(self, base_long_edge: Optional[int] = None):
        """(variant (long_edge, hflip) keys, reference variant index).

        Long edges are rounded to the stride grid (16 k + 1); the reference
        variant — meta, ground truth and box passthrough come from it — is
        the largest non-flipped scale."""
        base = base_long_edge or self.long_edge
        long_edges = sorted({
            max(2, int(round(base * f / 16))) * 16 + 1
            for f in self.multi_scale_factors})
        hflips = (False, True) if self.multi_scale_hflip else (False,)
        variant_keys = [(long_edge, hflip) for long_edge in long_edges
                        for hflip in hflips]
        return variant_keys, variant_keys.index((max(long_edges), False))

    def images(self, paths: Sequence[str]) -> Iterator[Tuple[List, List, dict]]:
        """Yields ``(predictions, ground_truth=[], meta)`` per image file,
        in ``predictor_batch_size`` batches; multi-scale when
        ``multi_scale`` is set."""
        if self.multi_scale:
            yield from self.images_multiscale(paths)
            return
        yield from self.dataset(datasets.ImageList(paths,
                                                   self.preprocess_factory()))

    def image(self, path: str):
        return next(iter(self.images([path])))

    def images_multiscale(self, paths: Sequence[str],
                          long_edges: Optional[Sequence[int]] = None
                          ) -> Iterator[Tuple[List, List, dict]]:
        """Predict each image at several scales (and hflips) and merge.

        Yields ``(merged_predictions, gt, meta_of_reference_scale)`` per
        image.  The variants are ``multiscale_variants``'s, or
        ``long_edges`` with their hflips; each variant's predictions are in
        the original image coordinates before the OKS merge
        (``merged_variants``)."""
        if long_edges is not None:
            hflips = (False, True) if self.multi_scale_hflip else (False,)
            variant_keys = [(le, hf) for le in sorted(long_edges)
                            for hf in hflips]
            reference_index = variant_keys.index((max(long_edges), False))
        else:
            variant_keys, reference_index = self.multiscale_variants()

        yield from self.merged_variants(
            [self.dataset(datasets.ImageList(
                paths, self.preprocess_factory(long_edge=long_edge,
                                               hflip=hflip)),
                json_data=False)
             for long_edge, hflip in variant_keys],
            reference_index, json_data=self.json_data)

    def merged_variants(self, iterators, reference_index: int, *,
                        json_data: bool = False
                        ) -> Iterator[Tuple[List, List, dict]]:
        """Zip per-variant ``(predictions, gt, meta)`` iterators (each
        variant's annotations in the original image coordinates) and yield
        per image the merged predictions with the reference variant's
        ground truth and meta.  Results stream image by image: each
        variant buffers at most one decoded batch."""
        sigmas = getattr(self.model.head_metas[0], 'sigmas', None)
        for results in zip(*iterators):
            _, gt, meta = results[reference_index]
            merged = self.merge_annotations(
                [r[0] for r in results], sigmas=sigmas,
                reference_index=reference_index)
            if json_data:
                merged = [ann.json_data() for ann in merged]
            yield merged, gt, meta

    def numpy_images(self, images) -> Iterator[Tuple[List, List, dict]]:
        """Yields ``(predictions, ground_truth=[], meta)`` per image, as
        the JAX ``Predictor.numpy_images`` does."""
        images = list(images)
        for i in range(0, len(images), self.batch_size):
            for preds, meta in self.batch(images[i:i + self.batch_size]):
                yield preds, [], meta

    def numpy_image(self, image):
        return next(iter(self.numpy_images([image])))
