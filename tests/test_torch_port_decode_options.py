"""The port's decode options against ``openpifpaf_tpu``'s decode.

``placements_per_round`` 2 and 3 (the top-m frontier joints per growth
round), with and without ``--force-complete-pose``, and ``seed_dedup``
on (the radius dedup of ``compact_seeds``; off is every other case here
and the default of ``test_torch_port_decode``) run through both packages'
batched decoders on the painted COCO scenes of ``test_torch_port_decode``,
held within ``xyv`` atol 1e-3 and ``scores`` atol 1e-4 with identical
``valid`` sets and overflow counters.  m > 1 is a scheduling relaxation,
so it is held to the JAX decode at the same m, never to m = 1; each m > 1
case also shows that JAX's decode at m = 1 lies beyond those tolerances on
the same fields, so the hold tells the options apart.
The golden fields and the legacy single-wave decode are in
``test_torch_port_decode_options_golden``, ``compact_seeds`` and
``init_poses`` in ``test_torch_port_seed_options`` (each file stays well
under a minute: a JAX decode compiles in ~5 s).
"""

import dataclasses

import numpy as np
import pytest

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import ops as jax_ops
from openpifpaf_tpu_torch import headmeta, ops

from test_torch_port_decode import (assert_same_decode, decoder_configs,
                                    metas, painted_scenes)
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)

PAINTED_HW = (21 * 16, 21 * 16)

# (placements_per_round, force_complete, seed_dedup)
OPTIONS = [(2, False, False), (3, False, False), (2, True, False),
           (3, True, False), (1, False, True)]


def option_configs(image_hw, m, force_complete, seed_dedup):
    """Both packages' ``CifCaf.config_for(image_hw)`` with the options set
    on the growth configuration."""
    return [dataclasses.replace(config, growth=dataclasses.replace(
        config.growth, placements_per_round=m, seed_dedup=seed_dedup))
        for config in decoder_configs(image_hw, force_complete)]


def jax_decode(cif, caf, jax_config):
    return [np.asarray(x) for x in jax_ops.make_batch_decoder(
        cif_meta=metas(jax_headmeta)[0], caf_meta=metas(jax_headmeta)[1],
        config=jax_config)(cif, caf)]


def decode_both(cif, caf, configs):
    jax_config, config = configs
    got = ops.make_batch_decoder(
        cif_meta=metas(headmeta)[0], caf_meta=metas(headmeta)[1],
        config=config, device='cpu')(cif, caf)
    return jax_decode(cif, caf, jax_config), [x.numpy() for x in got]


_AT_M1 = {}


def jax_at_m1(scene: str, cif, caf, image_hw, force_complete):
    """JAX's decode of ``scene``'s fields with one placement per round and
    no seed dedup (once per scene and force-complete setting)."""
    if (scene, force_complete) not in _AT_M1:
        _AT_M1[scene, force_complete] = jax_decode(cif, caf, option_configs(
            image_hw, 1, force_complete, False)[0])
    return _AT_M1[scene, force_complete]


def beyond_tolerance(a, b):
    """Whether two decodes differ where ``assert_same_decode`` looks: the
    valid sets, ``xyv`` beyond 1e-3 or ``scores`` beyond 1e-4."""
    return (not np.array_equal(a[3], b[3])
            or np.abs(a[0] - b[0]).max() > 1e-3
            or np.abs(a[2] - b[2]).max() > 1e-4)


@pytest.mark.parametrize('m,force_complete,seed_dedup', OPTIONS)
def test_painted_scenes_options_match_jax(m, force_complete, seed_dedup):
    cif, caf = painted_scenes()
    want, got = decode_both(cif, caf, option_configs(
        PAINTED_HW, m, force_complete, seed_dedup))
    assert_same_decode(want, got)
    assert got[3].sum(axis=1).tolist() == [1, 2, 9, 0, 1]
    if m > 1:
        # the scenes separate m from m = 1: a port that ignored the option
        # would fail the hold above
        assert beyond_tolerance(want, jax_at_m1(
            'painted', cif, caf, PAINTED_HW, force_complete))
