"""Debug views of fields and of the decoder's internals.

Port of ``openpifpaf_tpu/visualizer/``: ``--debug-indices`` selects the
wanted fields (``cif:5 caf:3:confidence seeds``), each visualizer renders
one kind of field (CIF, CAF, TCAF and CifDet targets and predictions, the
CifHr map, seeds, occupancy) as matplotlib figures, shown or written with
``--save-all``.  The visualizers take numpy arrays; the decoders' hooks
(``decoder/cifcaf.py``, ``decoder/tracking_pose.py``) read their device
tensors back only when an index is set.
"""

from .base import Base
from .caf import Caf
from .cif import Cif
from .cifdet import CifDet
from .cifhr import CifHr
from .occupancy import Occupancy
from .seeds import Seeds
from .tcaf import Tcaf

__all__ = ['Base', 'Caf', 'Cif', 'CifDet', 'CifHr', 'Occupancy', 'Seeds',
           'Tcaf', 'cli', 'configure']


def cli(parser):
    Base.cli(parser)


def configure(args):
    Base.configure(args)
