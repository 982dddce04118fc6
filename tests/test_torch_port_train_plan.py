"""The port's folded-routing training plans against the JAX package's.

``fused_shufflenet.shell_apply_train`` of the port (the pair plan where the
stage half-widths are even, the r3 plan otherwise) against JAX's
``fused_shufflenet.shell_apply_train`` on the same weights and images, f32,
with JAX's own tolerances (``tests/test_fused_shufflenet.py:100-284``,
``TestTrainPlan`` and ``TestTrackingTrainPlan``): the fields within atol
2e-4, rtol 1e-4; the updated running statistics within 1e-5; the
gradients of ``sum(field ** 2)`` by relative L2, per leaf within 5e-2
(leaves whose norm is below 1e-8 of the global one are analytically zero
and gated by the global figure) and globally within 2e-2.  On the port's
side the plan is also held to the port's canonical graph with the same
bounds, and its gates (``supports_train``, ``Trainer.uses_train_plan``
with ``fused_train`` set; the port's default is the canonical graph) to
JAX's conditions.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import fused_shufflenet as jax_fused
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu_torch import headmeta, losses, models
from openpifpaf_tpu_torch.models import fused_shufflenet
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_models import coco_metas, random_variables
from test_torch_port_tracking_model import (flax_narrow_tracking,
                                            port_narrow_tracking)

REPEATS = (1, 2, 1)
WIDTHS = {
    'pair': (8, 16, 32, 64, 64),     # half-widths 8, 16, 32: the pair plan
    'r3': (8, 14, 28, 52, 64),       # half-width 7: the r3 plan only
}


def flax_shell(widths):
    metas = coco_metas(jax_headmeta)
    for m in metas:
        m.base_stride = 16
    module = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(REPEATS, widths),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=widths[-1])
                   for m in metas])
    return module, random_variables(module, seed=2)


def port_shell(widths, flat):
    metas = coco_metas(headmeta)
    for m in metas:
        m.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(REPEATS, widths),
                         [models.CompositeField4(m, widths[-1])
                          for m in metas])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return shell


def jax_plan(module, variables, x):
    """JAX's plan: fields, new statistics and the gradients of
    ``sum(field ** 2)`` over the parameters, as flat dicts."""
    model = types.SimpleNamespace(module=module)

    def run(params):
        fields, mutated = jax_fused.shell_apply_train(
            model, {'params': params,
                    'batch_stats': variables['batch_stats']}, x)
        return sum(jnp.sum(f ** 2) for f in fields), (fields,
                                                      mutated['batch_stats'])

    (_, (fields, stats)), grads = jax.jit(jax.value_and_grad(
        run, has_aux=True))(variables['params'])
    state = models.from_jax_variables(jax_checkpoint.flatten_tree(
        {'params': grads, 'batch_stats': stats}))
    return [np.asarray(f) for f in fields], state


def port_step(shell, x, plan: bool):
    """The port's train forward (the plan, or ``shell(x)``): fields, the
    gradients of ``sum(field ** 2)`` and the state after it."""
    shell.train()
    images = torch.from_numpy(x.transpose(0, 3, 1, 2))
    fields = (fused_shufflenet.shell_apply_train(shell, images) if plan
              else shell(images))
    sum(f.pow(2).sum() for f in fields).backward()
    grads = {n: p.grad for n, p in shell.named_parameters()}
    return [f.detach().numpy() for f in fields], grads, shell.state_dict()


def assert_fields(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-4)


def assert_stats(want, got):
    keys = [k for k in got if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=key)


def assert_grads(want, got):
    """Relative L2 per leaf (5e-2) and over all of them (2e-2), as
    ``TestTrainPlan``."""
    assert set(want) == set(got)
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    num = 0.0
    for name, w in want.items():
        d2 = float(((got[name].double() - w.double()) ** 2).sum())
        n2 = float((w.double() ** 2).sum())
        num += d2
        if n2 > 1e-8 * den:
            assert (d2 / n2) ** 0.5 <= 5e-2, \
                f'{name}: rel L2 {(d2 / n2) ** 0.5:.2e}'
    assert (num / den) ** 0.5 <= 2e-2, (num / den) ** 0.5


@pytest.mark.parametrize('plan', list(WIDTHS))
def test_plan_against_jax(plan):
    widths = WIDTHS[plan]
    module, variables = flax_shell(widths)
    assert jax_fused.supports_pair(module.basenet) == (plan == 'pair')
    flat = jax_checkpoint.flatten_tree(variables)
    shell = port_shell(widths, flat)
    assert fused_shufflenet.supports_pair_train(shell.basenet) == \
        (plan == 'pair')
    x = np.random.default_rng(0).normal(size=(2, 65, 65, 3)).astype(
        np.float32)

    want_fields, want = jax_plan(module, variables, x)
    fields, grads, state = port_step(shell, x, plan=True)
    assert_fields(want_fields, fields)
    assert_stats(want, state)
    assert_grads({n: want[n] for n in grads}, grads)


@pytest.mark.parametrize('plan', list(WIDTHS))
def test_plan_against_the_canonical_graph(plan):
    """The same bounds between the port's plan and its canonical graph;
    the zero-padded and parity-split kernels leave no gradient
    unaccounted (every parameter's gradient is there and finite)."""
    module, variables = flax_shell(WIDTHS[plan])
    del module
    shell = port_shell(WIDTHS[plan], jax_checkpoint.flatten_tree(variables))
    other = copy.deepcopy(shell)
    x = np.random.default_rng(1).normal(size=(2, 49, 65, 3)).astype(
        np.float32)
    want_fields, want_grads, want_state = port_step(shell, x, plan=False)
    fields, grads, state = port_step(other, x, plan=True)
    assert_fields(want_fields, fields)
    assert_stats(want_state, state)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert_grads(want_grads, grads)


def test_tracking_plan_against_jax():
    """A tracking shell: the TCAF head sees the channel-concatenated pair
    features (``TestTrackingTrainPlan``)."""
    module, variables, _ = flax_narrow_tracking()
    model = port_narrow_tracking(jax_checkpoint.flatten_tree(variables))
    assert fused_shufflenet.supports_train(model.module)
    x = np.random.default_rng(2).normal(size=(4, 65, 65, 3)).astype(
        np.float32)
    want_fields, want = jax_plan(module, variables, x)
    fields, grads, state = port_step(model.module, x, plan=True)
    assert [f.shape[0] for f in fields] == [4, 4, 2]
    assert_fields(want_fields, fields)
    assert_stats(want, state)
    assert_grads({n: want[n] for n in grads}, grads)


def narrow_model(**kwargs):
    norm = kwargs.pop('norm', 'batchnorm')
    metas = coco_metas(headmeta)
    for m in metas:
        m.base_stride = 16
    # 32 groups divide every width of a group norm
    widths = WIDTHS['pair'] if norm == 'batchnorm' else (32, 64, 128, 256, 64)
    shell = models.Shell(
        models.ShuffleNetV2K(REPEATS, widths, norm=norm),
        [models.CompositeField4(m, 64,
                                dropout_rate=kwargs.get('dropout', 0.0))
         for m in metas], cross_talk=kwargs.get('cross_talk', 0.0))
    return models.Model(shell, metas, base_stride=16,
                        device=torch.device('cpu'), bf16=False)


@pytest.mark.parametrize('case, takes_plan', [
    ('default', False), ('fused_train_on', True), ('cross_talk', False),
    ('dropout', False), ('fix_batch_norm', False), ('groupnorm', False),
    ('instancenorm', False), ('fused_train_off', False), ('resnet', False)])
def test_plan_gates(case, takes_plan):
    """With ``fused_train`` on, the trainer takes the plan exactly when
    JAX's does (``trainer.py:163-170``, ``supports_train``, and
    ``--fix-batch-norm``'s eval-mode forward at ``:190``); the port's
    default (``fused_train`` off) is the canonical graph."""
    if case == 'resnet':
        model = models.factory('resnet50', coco_metas(headmeta),
                               device='cpu', bf16=False)
    elif case in ('groupnorm', 'instancenorm'):
        model = narrow_model(norm=case)
    else:
        model = narrow_model(cross_talk=0.2 if case == 'cross_talk' else 0.0,
                             dropout=0.1 if case == 'dropout' else 0.0)
    assert not model.fused_train
    if case not in ('default', 'fused_train_off'):
        model.fused_train = True
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      OptimizeFactory(), '/dev/null')
    trainer.fix_batch_norm = case == 'fix_batch_norm'
    assert trainer.uses_train_plan() == takes_plan
    assert fused_shufflenet.supports_train(model.module) == (
        case in ('default', 'fused_train_on', 'fix_batch_norm',
                 'fused_train_off'))
