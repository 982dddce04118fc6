"""Migrate CLI: bring npz checkpoints to the current format, and convert
upstream openpifpaf torch state dicts.

Port of ``openpifpaf_tpu/migrate.py``: the same flags and the same npz
files, which both packages read.

Usage::

    # bring checkpoints to the current format version, in place
    python -m openpifpaf_tpu_torch.migrate model1.npz model2.npz

    # convert an upstream torch state dict (see models/converter.py)
    python -m openpifpaf_tpu_torch.migrate --from-torch sk16.pt \\
        --basenet shufflenetv2k16 --dataset cocokp --output sk16.npz
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from . import datasets, logger, plugins
from .models import checkpoint as checkpoint_mod
from .models import converter, model_migration
from .models.base import BASE_FACTORIES

LOG = logging.getLogger(__name__)


def migrate_npz(path: str, output: str = None) -> str:
    """Write ``path`` migrated to the current format version to ``output``
    (default: ``path`` itself); a current file is left alone."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    header = json.loads(bytes(flat.pop('__meta__')).decode('utf-8'))
    version = header.get('format_version', 0)
    if version >= model_migration.CURRENT_FORMAT_VERSION:
        LOG.info('%s already at format v%d', path, version)
        return path
    flat, header = model_migration.migrate(flat, header)
    output = output or path
    flat['__meta__'] = np.frombuffer(
        json.dumps(header).encode('utf-8'), dtype=np.uint8).copy()
    np.savez(output, **flat)
    LOG.info('migrated %s -> %s (v%d)', path, output,
             header['format_version'])
    return output


def convert_torch(path: str, *, basenet: str, dataset: str,
                  output: str) -> str:
    """An upstream torch state dict with the heads of ``dataset`` -> an
    npz checkpoint whose header names the source (``converted_from``)."""
    state_dict = converter.load_torch_checkpoint(path)
    plugins.register()
    head_metas = datasets.factory(dataset).head_metas
    resolved = basenet[1:] if basenet.startswith('t') \
        and basenet[1:] in BASE_FACTORIES else basenet
    spec = BASE_FACTORIES[resolved]
    for i, meta in enumerate(head_metas):
        meta.head_index = i
        meta.base_stride = spec.stride
    variables = converter.convert_state_dict(state_dict,
                                             basenet_name=resolved)
    checkpoint_mod.save(output, variables=variables, head_metas=head_metas,
                        basenet_name=basenet, base_stride=spec.stride,
                        extra_meta={'converted_from': path})
    LOG.info('converted %s -> %s', path, output)
    return output


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m openpifpaf_tpu_torch.migrate', description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    logger.cli(parser)
    parser.add_argument('checkpoints', nargs='*',
                        help='npz checkpoints to migrate in place')
    parser.add_argument('--output', default=None)
    parser.add_argument('--from-torch', default=None,
                        help='torch state-dict file to convert')
    parser.add_argument('--basenet', default='shufflenetv2k16',
                        help='[--from-torch] trunk of the torch checkpoint')
    parser.add_argument('--dataset', default='cocokp',
                        help='[--from-torch] datamodule providing head metas')
    args = parser.parse_args(argv)
    logger.configure(args)

    if args.from_torch:
        out = args.output or args.from_torch.rsplit('.', 1)[0] + '.npz'
        convert_torch(args.from_torch, basenet=args.basenet,
                      dataset=args.dataset, output=out)
        print(out)
        return 0

    if not args.checkpoints:
        parser.error('no checkpoints given')
    for path in args.checkpoints:
        print(migrate_npz(path, args.output))
    return 0


if __name__ == '__main__':
    sys.exit(main())
