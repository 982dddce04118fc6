"""Video CLI of the PyTorch port: stream frames through the tracking (or
pose) pipeline.

Port of ``openpifpaf_tpu/video.py`` (``:36-236``).  Reference parity:
``src/openpifpaf/video.py:~30`` — frames in, tracked poses out, with
``--start-frame`` / ``--skip-frames``.  Frames come from a directory or a
glob of ``.jpg``, ``.jpeg``, ``.png`` and ``.bmp`` files, as the JAX
version's, read by ``image_io`` (by content, without PIL),
or from a video file or a camera through OpenCV, where it is
installed.  With a tracking model the previous frame's backbone features are
cached: the backbone (K2 on the card) runs on the new frame only, the
heads on the cached pair, and ``TrackingPose`` decodes and associates
(K1 on the card).  The first frame pairs with itself.  A model without a
TCAF head is tracked by ``PoseSimilarity``.  Runs on the card unless
``--device cpu`` is given; without CUDA it raises.  ``--video-output``
writes each frame with its annotations drawn (``show``, matplotlib) as
``NNNNNN.jpg`` (JAX ``video.py:200-227``); without matplotlib it and
``--debug-indices`` raise before the first frame.  ``--show`` is parsed
and has no effect, as in the JAX package (``video.py:171``, which
``main`` never reads).

Usage::

    python -m openpifpaf_tpu_torch.video --source frames_dir/ \\
        --checkpoint tracking.npz --json-output out.jsonl
"""

from __future__ import annotations

import argparse
import glob as glob_mod
import json
import logging
import os
import sys
import time

import torch

from . import decoder as decoder_mod
from . import headmeta, logger, models, show, transforms, visualizer
from .decoder.pose_similarity import PoseSimilarity
from .decoder.tracking_pose import TrackingPose
from .image_io import read_image

LOG = logging.getLogger(__name__)

# the frame files a folder or glob admits: the JAX version's fixed four
# (``video.py:52-53``), whatever else ``read_image`` reads
FRAME_SUFFIXES = ('.jpg', '.jpeg', '.png', '.bmp')


class FrameReader:
    """Frames as ``(index, name, (H, W, 3) uint8 RGB)``: from a directory
    or a glob of image files, in name order; else from a video file or a
    camera (a number) through OpenCV, imported only here (the JAX
    version's ``video.py:63-85``), with names ``frame_NNNNNN``."""

    def __init__(self, source: str, start_frame: int = 0,
                 skip_frames: int = 1, max_frames: int = None):
        self.source = source
        self.start_frame = start_frame
        self.skip_frames = max(1, skip_frames)
        self.max_frames = max_frames

    def __iter__(self):
        if not (os.path.isdir(self.source)
                or any(c in self.source for c in '*?[')):
            yield from self._capture()
            return
        pattern = (os.path.join(self.source, '*')
                   if os.path.isdir(self.source) else self.source)
        paths = sorted(p for p in glob_mod.glob(pattern)
                       if p.lower().endswith(FRAME_SUFFIXES))
        paths = paths[self.start_frame::self.skip_frames]
        if self.max_frames:
            paths = paths[:self.max_frames]
        for i, path in enumerate(paths):
            yield i, path, read_image(path)

    def _capture(self):
        try:
            import cv2  # pylint: disable=import-outside-toplevel
        except ImportError as e:
            raise ValueError(
                f'source {self.source!r} is not an image directory/glob and '
                'OpenCV is not available for video decoding') from e
        capture = cv2.VideoCapture(
            int(self.source) if self.source.isdigit() else self.source)
        frame_i = -1
        produced = 0
        try:
            while True:
                ret, frame = capture.read()
                if not ret:
                    break
                frame_i += 1
                if frame_i < self.start_frame \
                        or (frame_i - self.start_frame) % self.skip_frames:
                    continue
                if self.max_frames and produced >= self.max_frames:
                    break
                produced += 1
                # OpenCV decodes BGR
                yield frame_i, f'frame_{frame_i:06d}', frame[:, :, ::-1]
        finally:
            capture.release()


class VideoProcessor:
    """Preprocess, forward and track, one frame at a time.  ``last_times``
    holds the last frame's seconds per stage (the card synchronized before
    each clock read)."""

    def __init__(self, model, *, long_edge: int = 321):
        self.model = model
        self.device = model.device
        self.long_edge = long_edge
        self.tracking = any(isinstance(m, headmeta.Tcaf)
                            for m in model.head_metas)
        if self.tracking:
            self.decoder = decoder_mod.factory(model.head_metas,
                                               device=self.device)
            if not isinstance(self.decoder, TrackingPose):
                raise ValueError(f'tracking heads decoded by '
                                 f'{type(self.decoder).__name__}')
        else:
            self.decoder = PoseSimilarity(model.head_metas[0],
                                          model.head_metas[1],
                                          device=self.device)
        self.prev_features = None
        self.last_times = {}

    def _clock(self) -> float:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def process(self, frame_rgb):
        """(H, W, 3) uint8 frame -> (annotations in the frame's
        coordinates, meta)."""
        start = self._clock()
        x, meta = transforms.preprocess(frame_rgb, self.long_edge,
                                        self.device)
        times = {'preprocess': self._clock() - start}
        if self.tracking:
            start = self._clock()
            curr = self.model.backbone_features(x[None])
            times['backbone'] = self._clock() - start
            prev = self.prev_features if self.prev_features is not None \
                else curr
            fields = self.model.heads_from_features(torch.cat([prev, curr]))
            times['heads'] = self._clock() - start - times['backbone']
            start = time.perf_counter()
            preds = self.decoder([fields[0], fields[1], fields[2][0]])
            self.prev_features = curr
        else:
            start = self._clock()
            fields = self.model(x[None])
            times['forward'] = self._clock() - start
            start = time.perf_counter()
            preds = self.decoder([f[0] for f in fields])
        times['decoder'] = time.perf_counter() - start
        self.last_times = times
        preds = [ann.inverse_transform(meta) for ann in preds]
        return preds, meta


def cli(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.video', description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--source', required=True,
                        help='image directory or glob of frames')
    parser.add_argument('--video-output', default=None, nargs='?', const=True,
                        help='directory for annotated output frames')
    parser.add_argument('--json-output', default=None, nargs='?', const=True,
                        help='json-lines output file')
    parser.add_argument('--start-frame', default=0, type=int)
    parser.add_argument('--skip-frames', default=1, type=int)
    parser.add_argument('--max-frames', default=None, type=int)
    parser.add_argument('--long-edge', default=321, type=int)
    parser.add_argument('--show', default=False, action='store_true',
                        help='parsed as by the JAX video CLI; no effect')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    parser.add_argument('--seed', default=0, type=int,
                        help='seeds the weights of a fresh --basenet model')
    logger.cli(parser)
    group = parser.add_argument_group('network configuration')
    group.add_argument('--checkpoint', default=None,
                       help='npz checkpoint (the JAX package\'s format)')
    group.add_argument('--basenet', default=None,
                       help='base network of a fresh model with seeded '
                            'weights and the toykpst tracking heads, when '
                            'no checkpoint is given')
    models.norm_cli(group)
    models.network_cli(group)
    group.add_argument('--no-bf16', dest='bf16', default=True,
                       action='store_false',
                       help='compute in float32 instead of bfloat16')
    decoder_mod.cli(parser)
    show.cli(parser)
    visualizer.cli(parser)
    args = parser.parse_args(argv)

    if not args.checkpoint and not args.basenet:
        parser.error('either --checkpoint or --basenet must be given')
    logger.configure(args)
    decoder_mod.configure(args)
    show.configure(args)
    visualizer.configure(args)
    if args.show:
        LOG.warning('--show has no effect: no live display (as in the JAX '
                 'video CLI)')
    return args


def main(argv=None) -> int:
    args = cli(argv)
    painter = None
    if args.video_output is not None:
        show.require_matplotlib()
        painter = show.AnnotationPainter()
    head_metas = None
    if not args.checkpoint:
        from .plugins.posetrack import ToyKpSt  # pylint: disable=import-outside-toplevel
        head_metas = ToyKpSt().head_metas
    model = models.factory(args.basenet, head_metas,
                           checkpoint=args.checkpoint, bf16=args.bf16,
                           device=args.device, seed=args.seed,
                           norm=args.basenet_norm,
                           **models.network_options(args))
    processor = VideoProcessor(model, long_edge=args.long_edge)
    LOG.info('tracking mode: %s, on %s', processor.tracking, model.device)

    json_file = None
    if args.json_output is not None:
        json_name = args.json_output if args.json_output is not True \
            else str(args.source).rstrip('/*') + '.predictions.jsonl'
        json_file = open(json_name, 'w')  # pylint: disable=consider-using-with
        LOG.info('json output: %s', json_name)

    out_dir = None
    if painter is not None:
        out_dir = args.video_output if args.video_output is not True \
            else str(args.source).rstrip('/*') + '.predictions'
        os.makedirs(out_dir, exist_ok=True)
        LOG.info('video output: %s', out_dir)

    n_frames = 0
    try:
        for frame_i, _, frame in FrameReader(args.source, args.start_frame,
                                             args.skip_frames,
                                             args.max_frames):
            preds, _ = processor.process(frame)
            n_frames += 1
            LOG.info('frame %d: %d poses, ids %s', frame_i, len(preds),
                     [a.id_ for a in preds])
            if json_file is not None:
                json_file.write(json.dumps({
                    'frame': frame_i,
                    'predictions': [ann.json_data() for ann in preds],
                }) + '\n')
            if out_dir is not None:
                with show.image_canvas(frame, os.path.join(
                        out_dir, f'{frame_i:06d}.jpg')) as ax:
                    painter.annotations(ax, preds)
    finally:
        if json_file is not None:
            json_file.close()
    LOG.info('processed %d frames', n_frames)
    return 0 if n_frames else 1


if __name__ == '__main__':
    sys.exit(main())
