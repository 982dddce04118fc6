"""One training step of a new backbone against the JAX trainer.

One SGD step (nesterov, clipped, weight decay) of a narrow Swin with
cocokp's CIF and CAF heads on a toykp batch at 65 px, the port's
``Trainer`` against the JAX ``Trainer._train_step``, with the harness and
bounds of ``test_torch_port_train.py``: the loss within 1e-5 relative,
each parameter's change within 1e-4 of its largest change plus 2 ulps of
the parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import swin as jax_swin
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import headmeta, losses, models
from openpifpaf_tpu_torch.models import swin
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_backbones_predict import LONG_EDGE, shell_variables
from test_torch_port_backbones_weights import NARROW_SWIN
from test_torch_port_losses import toykp_batch
from test_torch_port_models import coco_metas
from test_torch_port_train import F32_EPS, OPTIMIZERS, configured


def test_swin_sgd_step_matches_jax(tmp_path):
    settings = OPTIMIZERS['sgd_nesterov_clip_norm']
    images, targets = toykp_batch(LONG_EDGE)
    module, variables, metas = shell_variables(jax_swin.Swin(**NARROW_SWIN),
                                               128)
    flat = jax_checkpoint.flatten_tree(variables)

    model = jax_models.Model(module, metas, base_stride=16,
                             basenet_name='swin-narrow-test',
                             variables=jax.tree.map(jnp.copy, variables))
    trainer = JaxTrainer(model, jax_losses.Factory().factory(metas),
                         configured(JaxOptimizeFactory(), settings),
                         '/dev/null', ema_decay=0.9)
    state = trainer.init_state(2)
    trainer._build_steps()  # pylint: disable=protected-access
    trainer.n_devices = 1
    x, t = trainer._place(  # pylint: disable=protected-access
        images.permute(0, 2, 3, 1).numpy(),
        [{k: v.numpy() for k, v in d.items()} for d in targets])
    state, want_total, _ = trainer._train_step(state, x, t)  # pylint: disable=protected-access
    want = models.from_jax_variables(
        jax_checkpoint.flatten_tree({'params': state.params}))

    port_metas = coco_metas(headmeta)
    shell = models.Shell(swin.Swin(**NARROW_SWIN),
                         [models.CompositeField4(m, 128) for m in port_metas])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    port_model = models.Model(shell, port_metas, base_stride=16,
                              device=torch.device('cpu'), bf16=False)
    before = {k: v.clone() for k, v in shell.state_dict().items()}
    port_trainer = Trainer(port_model,
                           losses.Factory().factory(port_model.head_metas),
                           configured(OptimizeFactory(), settings),
                           str(tmp_path / 'model'))
    port_trainer.setup(2)
    total, _ = port_trainer.train_step(images, targets)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)

    state_dict = shell.state_dict()
    assert set(want) == set(state_dict)
    assert any(k.endswith('relative_position_bias_table') for k in want)
    for key, value in want.items():
        delta, want_delta = state_dict[key] - before[key], value - before[key]
        scale = float(want_delta.abs().max())
        assert scale > 0, key
        ulps = 2 * F32_EPS * float(before[key].abs().max())
        assert float((delta - want_delta).abs().max()) <= \
            1e-4 * scale + ulps, key
