"""Rank bodies for the port's multi-process tests (gloo on the CPU).

``openpifpaf_tpu_torch.parallel.run_group`` starts each rank with the
``spawn`` method, which imports the body's module by name: this module
imports the port and torch only, so that a rank starts without JAX.
"""

import torch

from openpifpaf_tpu_torch import eval as port_eval
from openpifpaf_tpu_torch import headmeta, losses, models, parallel
from openpifpaf_tpu_torch.models import base, shufflenetv2k
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

# test_torch_port_models.NARROW, registered under a test name
NARROW = ((1, 2, 1), (8, 16, 32, 64, 64))
NARROW_NAME = 'shufflenetv2k-narrow-dist-test'
STEPS_PER_EPOCH = 2
SGD = dict(lr=0.05, momentum=0.9, clip_grad_norm=0.5, weight_decay=1e-3)


def register_narrow() -> None:
    base.register_basenet(base.BaseNetworkSpec(
        NARROW_NAME, shufflenetv2k._make(*NARROW),  # pylint: disable=protected-access
        stride=16, out_features=64))


def narrow_model(state_dict) -> models.Model:
    """``test_torch_port_models.port_narrow``: the narrow ShuffleNetV2K
    with COCO's CIF and CAF heads, f32, on the CPU."""
    metas = [
        headmeta.Cif('cif', 'port', keypoints=constants.COCO_KEYPOINTS,
                     sigmas=constants.COCO_PERSON_SIGMAS,
                     pose=constants.COCO_UPRIGHT_POSE,
                     draw_skeleton=constants.COCO_PERSON_SKELETON,
                     score_weights=constants.COCO_PERSON_SCORE_WEIGHTS),
        headmeta.Caf('caf', 'port', keypoints=constants.COCO_KEYPOINTS,
                     sigmas=constants.COCO_PERSON_SIGMAS,
                     pose=constants.COCO_UPRIGHT_POSE,
                     skeleton=constants.COCO_PERSON_SKELETON)]
    for m in metas:
        m.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in metas])
    shell.load_state_dict(state_dict, strict=True)
    return models.Model(shell, metas, base_stride=16,
                        device=torch.device('cpu'), bf16=False)


def sgd_steps(device, state_dict, runs):  # pylint: disable=unused-argument
    """For each run ``(images, targets, ablate)``: two SGD-nesterov steps
    (``test_torch_port_train_default``'s settings) on this rank's
    contiguous shard of the global batch, from ``state_dict``.  ``ablate``
    turns off one part of the data-parallel step: ``'batch_norm'``
    (per-rank BatchNorm statistics) or ``'loss_means'`` (per-rank loss
    means).  Returns per run the losses, the state dict and the EMA."""
    out = []
    for images, targets, ablate in runs:
        model = narrow_model(state_dict)
        factory = OptimizeFactory()
        factory.lr_warm_up_factor = 0.1
        factory.lr_warm_up_epochs = 1
        for key, value in SGD.items():
            setattr(factory, key, value)
        trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                          factory, '/dev/null')
        if ablate == 'batch_norm':
            for m in model.module.modules():
                if isinstance(m, base.BatchNorm):
                    m.process_group = None
        elif ablate == 'loss_means':
            for loss in trainer.loss_fn.losses:
                loss.process_group = None
        trainer.ema_decay = 0.9
        trainer.setup(STEPS_PER_EPOCH)
        images, targets = parallel.shard_batch((images, targets))
        totals = [float(trainer.train_step(images, targets)[0])
                  for _ in range(2)]
        names = [n for n, _ in model.module.named_parameters()]
        out.append((totals, model.module.state_dict(),
                    dict(zip(names, trainer.ema))))
    return out


def eval_cli(device, argv):  # pylint: disable=unused-argument
    """The port's eval CLI with the narrow backbone registered."""
    register_narrow()
    return port_eval.main(argv)


def spatial_bands(device, fields, overflow_fields, batch):  # pylint: disable=unused-argument
    """This rank's part of the banded CifHr and seeds (halo 24 px, 64
    seeds) on ``fields``; the overflow counter at halo 16 px on
    ``overflow_fields``; the errors of field rows that do not divide and
    of a halo taller than a band; ``batch``'s shard and the predictor's
    padded shard of its first 3 images."""
    from openpifpaf_tpu_torch.ops import cif_hr, seeds  # pylint: disable=import-outside-toplevel
    from openpifpaf_tpu_torch.predictor import Predictor  # pylint: disable=import-outside-toplevel

    config = cif_hr.CifHrConfig()
    banded = parallel.sharded_cif_hr(
        *fields, out_hw=(64, 48), config=config,
        spatial=parallel.SpatialConfig(halo_px=24.0))
    selected = parallel.sharded_seeds(
        *fields, banded.hr, hr_spacing=float(config.spacing),
        config=seeds.SeedsConfig(max_seeds=64),
        spatial=parallel.SpatialConfig(halo_px=24.0))
    overflow = parallel.sharded_cif_hr(
        *overflow_fields, out_hw=(64, 48), config=config,
        spatial=parallel.SpatialConfig(halo_px=16.0)).halo_overflow
    errors = []
    for rows, out_hw, halo_px in ((15, (63, 48), 24.0),
                                  (16, (64, 48), 200.0)):
        try:
            parallel.sharded_cif_hr(
                *(f[:, :rows] for f in fields), out_hw=out_hw,
                config=config, spatial=parallel.SpatialConfig(halo_px))
        except ValueError as e:
            errors.append(str(e))
    predictor = Predictor.__new__(Predictor)
    predictor.group = parallel.data_group()
    return (banded.hr, int(banded.halo_overflow), selected, int(overflow),
            errors, parallel.shard_batch(batch),
            predictor._shard(batch[:3]),  # pylint: disable=protected-access
            undistributed_decoder())


class _Heads:
    """A model stub with toykp's and cifar10's heads (``Multi`` decodes
    them; it has no ``batch_decoded``)."""

    device = torch.device('cpu')

    def __init__(self):
        from openpifpaf_tpu_torch.plugins import cifar10, toykp  # pylint: disable=import-outside-toplevel
        self.head_metas = toykp.ToyKp().head_metas + cifar10.Cifar10().head_metas
        for i, meta in enumerate(self.head_metas):
            meta.head_index, meta.base_stride = i, 16


def undistributed_decoder():
    """``--dp-eval``'s predictor with a decoder that has no
    ``batch_decoded``: whether it left the group, and its warnings."""
    import logging  # pylint: disable=import-outside-toplevel
    from openpifpaf_tpu_torch.predictor import Predictor  # pylint: disable=import-outside-toplevel

    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logger = logging.getLogger('openpifpaf_tpu_torch.predictor')
    logger.addHandler(handler)
    Predictor.data_parallel = True
    try:
        predictor = Predictor(model=_Heads(), device='cpu')
    finally:
        Predictor.data_parallel = False
        logger.removeHandler(handler)
    return (type(predictor.decoder).__name__, predictor.group is None,
            warnings)
