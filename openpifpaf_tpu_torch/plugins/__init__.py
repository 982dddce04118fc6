"""Dataset plugins: the COCO keypoint constants and the toykp data module."""


def register() -> None:
    """Fill ``datasets.DATAMODULES`` with the port's data modules."""
    from ..datasets import DATAMODULES  # pylint: disable=import-outside-toplevel
    from .toykp import ToyKp  # pylint: disable=import-outside-toplevel
    DATAMODULES['toykp'] = ToyKp
