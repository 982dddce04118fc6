"""Why ``chip_smoke.py`` jitters its painted scenes.

Exactly painted fields tie: the cells along an edge give candidates of one
score, and which of them the decode takes is decided by the last ulp of the
CifHr sums.  The card's K1 and the CPU's plain splat sum in other orders, so
``hold_card_to_cpu`` on exactly painted scenes would hold rounding, not the
decode.  Here the port's CPU decode of the painted dense scenes (19 + 18
edges at ``--dense-connections 1.0``) runs twice: once as is and once with
every CifHr value moved by one part in 1e7 (N(0, 1) draws, one ulp or so).
Unjittered, the move carries poses beyond the card hold's tolerances (xyv
1e-3, score 1e-4); with the jitter the card run uses, every draw of it stays
within them.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from openpifpaf_tpu_torch import decoder, headmeta
from openpifpaf_tpu_torch.ops import cif_hr, pipeline
from openpifpaf_tpu_torch.plugins.coco import constants

from test_torch_port_decode import metas
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_dense import dense_meta

DRAWS = 3


def decode(dec, fields, monkeypatch, draw=None):
    """The dense decode of ``fields``; with ``draw``, every CifHr value
    times 1 + 1e-7 N(0, 1) from that torch seed."""
    accumulate = cif_hr.accumulate

    def moved(*args, **kwargs):
        hr, overflow = accumulate(*args, **kwargs)
        noise = torch.randn(hr.shape,
                            generator=torch.Generator().manual_seed(draw))
        return hr * (1.0 + 1e-7 * noise), overflow

    with monkeypatch.context() as patch:
        if draw is not None:
            patch.setattr(pipeline.cif_hr, 'accumulate', moved)
        out = dec.batch_decoded([torch.from_numpy(np.ascontiguousarray(f))
                                 for f in fields])
    return [t.numpy() for t in out]


@pytest.mark.parametrize('seed', [None] + list(chip_smoke.JITTER_SEEDS))
def test_painted_dense_scenes_cifhr_tie(seed, monkeypatch):
    jitter = dict(jitter=0.0) if seed is None else dict(seed=seed)
    fields = chip_smoke.painted_dense_scenes(constants, **jitter)
    monkeypatch.setattr(decoder.CifCaf, 'dense_connections', 1.0)
    dec = decoder.CifCaf(*metas(headmeta), dense_caf_meta=dense_meta(headmeta),
                         device='cpu')
    assert dec.caf_meta.n_fields == 37

    base = decode(dec, fields, monkeypatch)
    assert base[3].sum(axis=1).tolist() == [1, 2, 9]
    moves = []
    for draw in range(DRAWS):
        same_count, dxyv, dscore = chip_smoke.pose_difference(
            decode(dec, fields, monkeypatch, draw), base)
        assert same_count
        moves.append((dxyv, dscore))
    beyond = [dxyv > 1e-3 or dscore > 1e-4 for dxyv, dscore in moves]
    if seed is None:
        # every draw carries a pose beyond the hold (measured: xyv 1.7e-2
        # to 3.3e-2, score 6.3e-4 to 1.9e-3)
        assert all(beyond), moves
    else:
        assert not any(beyond), moves
