"""Dataset plugins: the COCO-format data modules (cocokp, cocodet and,
on ``generic_kp``, crowdpose, wholebody, animal and apollo), the frame
pair modules that read files (cocokpst and posetrack2018), and the
synthetic ones (toykp, toycrowd, toywb, toykpst with frame pairs for tracking, and
cifar10, detection)."""


def register() -> None:
    """Fill ``datasets.DATAMODULES`` with the port's data modules."""
    # pylint: disable=import-outside-toplevel
    from ..datasets import DATAMODULES
    from .animalpose import AnimalPose
    from .apollocar3d import ApolloCar3D
    from .cifar10 import Cifar10
    from .coco import CocoDet, CocoKp
    from .crowdpose import CrowdPose
    from .posetrack import CocoKpSt, PoseTrack2018, ToyKpSt
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
    DATAMODULES['cocokpst'] = CocoKpSt
    DATAMODULES['posetrack2018'] = PoseTrack2018
    DATAMODULES['toykpst'] = ToyKpSt
    DATAMODULES['cifar10'] = Cifar10
