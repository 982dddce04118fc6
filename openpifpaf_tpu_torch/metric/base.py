"""Metric base class.

Port copy of ``openpifpaf_tpu/metric/base.py`` (numpy and the standard
library only).  Reference parity: ``src/openpifpaf/metric/base.py:~10`` —
``accumulate``, ``stats``, ``write_predictions`` (``<name>.pred.json`` and
``<name>.zip``).
"""

from __future__ import annotations

import json
import logging
import zipfile

LOG = logging.getLogger(__name__)


class Base:
    text_labels = []

    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        raise NotImplementedError

    def stats(self) -> dict:
        raise NotImplementedError

    def write_predictions(self, filename: str, *, additional_data=None):
        mid = getattr(self, 'predictions_json', None)
        predictions = mid() if callable(mid) else []
        with open(filename + '.pred.json', 'w') as f:
            json.dump(predictions, f)
        LOG.info('wrote %s.pred.json', filename)
        with zipfile.ZipFile(filename + '.zip', 'w') as myzip:
            myzip.write(filename + '.pred.json', arcname='predictions.json')
        if additional_data:
            with open(filename + '.pred_meta.json', 'w') as f:
                json.dump(additional_data, f)
