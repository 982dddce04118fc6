"""The port's losses and their gradients against the JAX package.

Seeded numpy fields and encoder targets go through the JAX loss and the
port's; the loss values must agree within 1e-5 relative in f32.
``F.softplus`` returns ``x`` above 20 where ``jax.nn.softplus`` keeps
``log1p(exp(-x))``, a term below f32 resolution there, so the raw fields
include such values under the same tolerance.  The gradients of the total
loss through a narrow ShuffleNetV2K (``test_torch_port_models.
port_narrow``, weights carried by ``from_jax_variables``) must agree within
``max|Δ| / max|g_jax| <= 1e-4`` per parameter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu.losses import components as jax_components
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import losses, models
from openpifpaf_tpu_torch.datasets import collate_images_targets_meta
from openpifpaf_tpu_torch.losses import components
from openpifpaf_tpu_torch.plugins.toykp import ToyKp, ToyKpDataset

from test_torch_port_models import coco_metas, flax_narrow, port_narrow

RTOL = 1e-5


def assert_close(want, got, rtol=RTOL):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    assert np.abs(want - got).max() <= rtol * max(1.0, np.abs(want).max()), \
        (want, got)


def toykp_batch(size, n=2, seed=0):
    """Encoder targets for ``n`` toykp images at ``size`` px (no
    augmentation): NCHW images and per-head target dicts, as tensors."""
    dm = ToyKp()
    dm.augmentation = False
    dm.image_size = size
    for m in dm.head_metas:
        m.base_stride = 16
    ds = ToyKpDataset(n, size, dm.preprocess(np.random.default_rng(0)),
                      seed=seed)
    images, targets, _ = collate_images_targets_meta([ds[i] for i in range(n)])
    return images, targets


def random_fields(targets, seed=0):
    """Raw head outputs shaped like the CIF and CAF heads over ``targets``,
    from N(0, 3) so that some spreads and scales pass softplus's 20."""
    rng = np.random.default_rng(seed)
    out = []
    for t, nc in zip(targets, (5, 9)):
        b, f, h, w = t['conf'].shape
        field = rng.normal(0.0, 3.0, (b, f, nc, h, w)).astype(np.float32)
        field[0, 0, -1, 0, :] = 25.0
        out.append(field)
    return out


def jax_targets(targets):
    return [{k: jnp.asarray(v.numpy()) for k, v in t.items()}
            for t in targets]


@pytest.mark.parametrize('name', ['focal_bce', 'focal_bce_background',
                                  'laplace', 'laplace_clip', 'smoothl1',
                                  'smoothl1_r', 'scale'])
def test_component(name):
    rng = np.random.default_rng(3)
    raw = rng.normal(0.0, 8.0, (4, 50)).astype(np.float32)
    raw[0, :5] = (21.0, 30.0, -30.0, 5.0, -5.0)
    vec = rng.normal(0.0, 2.0, (4, 50, 2)).astype(np.float32)
    vec_t = rng.normal(0.0, 2.0, (4, 50, 2)).astype(np.float32)
    target = (rng.random((4, 50)) > 0.7).astype(np.float32)
    scale_t = rng.uniform(0.0, 5.0, (4, 50)).astype(np.float32)
    t = torch.from_numpy
    cases = {
        'focal_bce': ('focal_bce', 'BceConfig', {}, (raw, target)),
        'focal_bce_background': ('focal_bce', 'BceConfig', dict(
            background_weight=0.3, min_bce=0.05, focal_gamma=2.0),
            (raw, target)),
        'laplace': ('laplace_regression', 'LaplaceConfig', {},
                    (vec, raw, vec_t)),
        'laplace_clip': ('laplace_regression', 'LaplaceConfig',
                         dict(b_min=0.2, norm_clip=2.0), (vec, raw, vec_t)),
        'smoothl1': ('smooth_l1_regression', 'SmoothL1Config', {},
                     (vec, vec_t)),
        'smoothl1_r': ('smooth_l1_regression', 'SmoothL1Config',
                       dict(r_smooth=1.5), (vec, vec_t)),
        'scale': ('scale_loss', 'ScaleConfig', {}, (raw, scale_t)),
    }
    fn, config, kw, args = cases[name]
    want = getattr(jax_components, fn)(
        *[jnp.asarray(a) for a in args], getattr(jax_components, config)(**kw))
    got = getattr(components, fn)(*[t(a) for a in args],
                                  getattr(components, config)(**kw))
    assert_close(want, got.numpy())


@pytest.mark.parametrize('regression', ['laplace', 'smoothl1'])
@pytest.mark.parametrize('mtl', [False, True], ids=['lambdas', 'log_sigmas'])
def test_multi_head_loss(regression, mtl):
    """The composite losses of CIF and CAF on toykp targets and the total,
    with lambdas, or with Kendall log-sigmas."""
    images, targets = toykp_batch(65)
    fields = random_fields(targets)
    kw = dict(regression_loss=regression, r_smooth=0.7, background_weight=0.5,
              b_min=0.2)
    lambdas = [1.0, 2.0, 0.5, 1.5, 1.0, 0.25]
    jax_factory = jax_losses.Factory()
    port_factory = losses.Factory()
    for f in (jax_factory, port_factory):
        for key, value in kw.items():
            setattr(f, key, value)
        f.lambdas = lambdas
    want_fn = jax_factory.factory(coco_metas(jax_headmeta))
    got_fn = port_factory.factory(coco_metas())
    assert want_fn.field_names == got_fn.field_names
    log_sigmas = np.linspace(-0.5, 0.7, 6).astype(np.float32) if mtl else None
    want_total, want_comps = want_fn(
        [jnp.asarray(f) for f in fields], jax_targets(targets),
        log_sigmas=None if log_sigmas is None else jnp.asarray(log_sigmas))
    got_total, got_comps = got_fn(
        [torch.from_numpy(f) for f in fields], targets,
        log_sigmas=None if log_sigmas is None else torch.from_numpy(log_sigmas))
    assert_close(want_total, float(got_total))
    assert_close(np.stack(want_comps),
                 torch.stack(got_comps).numpy())


def test_lambdas_count_checked():
    with pytest.raises(ValueError, match='lambdas'):
        losses.MultiHeadLoss(losses.Factory().factory(coco_metas()).losses,
                             [1.0, 2.0])


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads():
    """The JAX side of the gradient test, jitted once: the total loss of
    the narrow model in train mode on a 65 px toykp batch and its gradients
    with respect to the parameters and the log-sigmas (zeros make the
    Kendall weighting the identity)."""
    module, variables, metas = flax_narrow()
    images, targets = toykp_batch(65)
    jax_loss = jax_losses.Factory().factory(metas)

    def loss_of(params, sigmas, x, targets):
        fields, _ = module.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, x,
            train=True, mutable=['batch_stats'])
        return jax_loss(fields, targets, log_sigmas=sigmas)[0]

    fn = jax.jit(jax.value_and_grad(loss_of, argnums=(0, 1)))
    x = images.permute(0, 2, 3, 1).numpy()
    return {mtl: fn(variables['params'], jnp.asarray(log_sigmas(mtl)), x,
                    jax_targets(targets)) for mtl in (False, True)}


def log_sigmas(mtl):
    return (np.linspace(-0.3, 0.4, 6) if mtl else np.zeros(6)).astype(
        np.float32)


@pytest.mark.parametrize('mtl', [False, True], ids=['plain', 'log_sigmas'])
def test_gradients_through_narrow_model(mtl):
    """Per-parameter gradients of the total loss through the narrow
    ShuffleNetV2K at 65 px, train-mode batch norm, f32:
    max|Δ| / max|g_jax| <= 1e-4; the loss within 1e-5 relative.  A
    BatchNorm bias followed by a 1x1 conv and another BatchNorm has
    gradient 0 in exact arithmetic (the second norm removes the shift), so
    its |g| is rounding noise (~1e-8 of the largest, 0.6): the denominator
    is at least 1e-2 of the model's largest gradient."""
    want_total, (want_grads, want_sigma_grad) = jax_loss_and_grads()[mtl]
    want = models.from_jax_variables(
        jax_checkpoint.flatten_tree({'params': want_grads}))
    floor = 1e-2 * max(float(np.abs(g.numpy()).max()) for g in want.values())

    _, variables, _ = flax_narrow()
    shell = port_narrow(jax_checkpoint.flatten_tree(variables)).module.train()
    images, targets = toykp_batch(65)
    sigmas = torch.nn.Parameter(torch.from_numpy(log_sigmas(True))) \
        if mtl else None
    total, _ = losses.Factory().factory(coco_metas())(
        shell(images), targets, log_sigmas=sigmas)
    total.backward()
    assert_close(want_total, total.item())
    grads = dict(shell.named_parameters())
    assert set(grads) == set(want)
    for name, g in want.items():
        g = g.numpy()
        scale = max(np.abs(g).max(), floor)
        assert np.abs(grads[name].grad.numpy() - g).max() <= 1e-4 * scale, name
    if mtl:
        assert_close(want_sigma_grad, sigmas.grad.numpy())
