"""Dataset plugins: the COCO-format data modules (cocokp, cocodet and,
on ``generic_kp``, crowdpose, wholebody, animal and apollo) and the
synthetic ones (toykp, toycrowd, toywb, toykpst with frame pairs for
tracking, and cifar10, detection)."""


def register() -> None:
    """Fill ``datasets.DATAMODULES`` with the port's data modules."""
    # pylint: disable=import-outside-toplevel
    from ..datasets import DATAMODULES
    from .animalpose import AnimalPose
    from .apollocar3d import ApolloCar3D
    from .cifar10 import Cifar10
    from .coco import CocoDet, CocoKp
    from .crowdpose import CrowdPose
    from .posetrack import ToyKpSt
    from .toykp import ToyCrowd, ToyKp, ToyWb
    from .wholebody import WholeBody
    DATAMODULES['cocokp'] = CocoKp
    DATAMODULES['cocodet'] = CocoDet
    DATAMODULES['crowdpose'] = CrowdPose
    DATAMODULES['wholebody'] = WholeBody
    DATAMODULES['animal'] = AnimalPose
    DATAMODULES['apollo'] = ApolloCar3D
    DATAMODULES['toykp'] = ToyKp
    DATAMODULES['toycrowd'] = ToyCrowd
    DATAMODULES['toywb'] = ToyWb
    DATAMODULES['toykpst'] = ToyKpSt
    DATAMODULES['cifar10'] = Cifar10
