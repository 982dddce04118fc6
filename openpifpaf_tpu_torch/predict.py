"""Predict CLI of the PyTorch port: image files -> annotations as json.

Port of ``openpifpaf_tpu/predict.py:25-96``.  Reference parity:
``src/openpifpaf/predict.py:~30``: glob the images, run the ``Predictor``
and write one ``<image>.predictions.json`` per image, poses and boxes
mixed, with ``--json-output`` (a file, a directory, or beside the image
when given without a value), and with ``-o/--image-output`` the image with
its annotations drawn (``show``, matplotlib) as ``<image>.predictions.jpg``
(JAX ``predict.py:72-93``).  Images are read by ``image_io``: PNG, JPEG
and BMP, without PIL.  Prediction runs on the card unless
``--device cpu`` is given; without CUDA it raises.  Without matplotlib,
``-o`` and ``--debug-indices`` raise before any prediction.  As in the JAX
package, ``--debug-indices`` renders no decoder view here: ``Predictor``
decodes through ``batch_fields``, which has no hook.  ``--batch-size``
sets the predictor's batch (as ``--predictor-batch-size``); the JAX
CLI's ``--batch-size`` is its data modules' flag, which it never
configures, so there it changes nothing.

Usage::

    python -m openpifpaf_tpu_torch.predict image.png \\
        --checkpoint outputs/model.npz --json-output out/ -o out/
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys

from . import decoder, logger, models, show, visualizer
from .image_io import read_image
from .predictor import Predictor

LOG = logging.getLogger(__name__)


def cli(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.predict',
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('images', nargs='*', help='input images')
    parser.add_argument('--glob', default=None,
                        help='glob expression for input images')
    parser.add_argument('-o', '--image-output', default=None, nargs='?',
                        const=True, help='annotated image output')
    parser.add_argument('--json-output', default=None, nargs='?',
                        const=True, help='json output file or directory')
    parser.add_argument('--batch-size', dest='predictor_batch_size',
                        default=Predictor.batch_size, type=int,
                        help='prediction batch size')
    parser.add_argument('--device', default=None,
                        help='torch device (default: the card; raises '
                             'without CUDA)')
    logger.cli(parser)
    group = parser.add_argument_group('network configuration')
    group.add_argument('--checkpoint', default=None,
                       help='npz checkpoint (the JAX package\'s format)')
    models.norm_cli(group)
    models.network_cli(group)
    group.add_argument('--no-bf16', dest='bf16', default=True,
                       action='store_false',
                       help='compute in float32 instead of bfloat16')
    decoder.cli(parser)
    Predictor.cli(parser)
    show.cli(parser)
    visualizer.cli(parser)
    args = parser.parse_args(argv)

    if not args.checkpoint:
        parser.error('--checkpoint must be given')
    logger.configure(args)
    decoder.configure(args)
    Predictor.configure(args)
    show.configure(args)
    visualizer.configure(args)
    return args


def out_name(arg, in_name: str, default_extension: str) -> str:
    if arg is True:
        return in_name + default_extension
    if os.path.isdir(arg):
        return os.path.join(arg, os.path.basename(in_name)) + default_extension
    return arg


def main(argv=None) -> int:
    args = cli(argv)
    image_paths = list(args.images)
    if args.glob:
        image_paths += sorted(glob.glob(args.glob))
    if not image_paths:
        LOG.error('no image files given')
        return 1

    annotation_painter = None
    if args.image_output is not None:
        show.require_matplotlib()
        annotation_painter = show.AnnotationPainter()

    predictor = Predictor(checkpoint=args.checkpoint, device=args.device,
                          bf16=args.bf16, norm=args.basenet_norm,
                          **models.network_options(args))
    for pred, _, meta in predictor.images(image_paths):
        LOG.info('%s: %d annotations', meta['file_name'], len(pred))
        if args.json_output is not None:
            json_out_name = out_name(args.json_output, meta['file_name'],
                                     '.predictions.json')
            with open(json_out_name, 'w') as f:
                json.dump([ann.json_data() for ann in pred], f)
            LOG.info('json output = %s', json_out_name)
        if annotation_painter is not None:
            image_out_name = out_name(args.image_output, meta['file_name'],
                                      '.predictions.jpg')
            with show.image_canvas(read_image(meta['file_name']),
                                   image_out_name) as ax:
                annotation_painter.annotations(ax, pred)
            LOG.info('image output = %s', image_out_name)
    return 0


if __name__ == '__main__':
    sys.exit(main())
