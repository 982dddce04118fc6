"""The weight bridge at full width, both ways, for HRFormer and XCiT-M24.
The harness is ``test_torch_port_backbones_weights.py``'s."""

import pytest

from test_torch_port_backbones_weights import NAMES, hold_round_trip


@pytest.mark.parametrize('name', NAMES['hrformer'])
def test_round_trip(name):
    hold_round_trip(name)
