"""Dataset plugins: the COCO and WholeBody keypoint constants and the
synthetic data modules (toykp, toycrowd, toywb, toykpst, frame pairs for
tracking, and cifar10, detection)."""


def register() -> None:
    """Fill ``datasets.DATAMODULES`` with the port's data modules."""
    from ..datasets import DATAMODULES  # pylint: disable=import-outside-toplevel
    from .cifar10 import Cifar10  # pylint: disable=import-outside-toplevel
    from .posetrack import ToyKpSt  # pylint: disable=import-outside-toplevel
    from .toykp import ToyCrowd, ToyKp, ToyWb  # pylint: disable=import-outside-toplevel
    DATAMODULES['toykp'] = ToyKp
    DATAMODULES['toycrowd'] = ToyCrowd
    DATAMODULES['toywb'] = ToyWb
    DATAMODULES['toykpst'] = ToyKpSt
    DATAMODULES['cifar10'] = Cifar10
