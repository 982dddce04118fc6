"""The weight bridge at full width, both ways, for Swin (Dense kernels,
LayerNorms, relative position bias tables), BoTNet (``rel_h``, ``rel_w``)
and XCiT-S12 (temperatures, layer scales).  The harness is
``test_torch_port_backbones_weights.py``'s."""

import pytest

from test_torch_port_backbones_weights import NAMES, hold_round_trip


@pytest.mark.parametrize('name', NAMES['swin'])
def test_round_trip(name):
    hold_round_trip(name)
