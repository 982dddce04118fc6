"""Dataset plugins: the COCO and WholeBody keypoint constants and the
synthetic data modules (toykp, toycrowd, toywb)."""


def register() -> None:
    """Fill ``datasets.DATAMODULES`` with the port's data modules."""
    from ..datasets import DATAMODULES  # pylint: disable=import-outside-toplevel
    from .toykp import ToyCrowd, ToyKp, ToyWb  # pylint: disable=import-outside-toplevel
    DATAMODULES['toykp'] = ToyKp
    DATAMODULES['toycrowd'] = ToyCrowd
    DATAMODULES['toywb'] = ToyWb
