"""Dense connections and the third (``caf25``) head in the port, against
``openpifpaf_tpu``.

- ``headmeta.Caf.concatenate``: the merged skeleton, confidence scales,
  head index and strides as the JAX package's.
- The CifCaf decode with a dense CAF head (the painted scenes of
  ``tests/test_decoder.py:245-291``: sparse 19 edges, dense 18) at
  ``--dense-connections`` 1.0 and 0.5, and with the flag at 0 (the dense
  head ignored): the concatenated 37-edge skeleton, the candidate sets per
  edge and direction (count, and scores within 1e-4, so the scaled dense
  edges are ranked into the budget as JAX ranks them), and the decode within
  ``xyv`` 1e-3 and ``scores`` 1e-4 with the same valid set.
- toykp with ``--toykp-with-dense``: three-head training samples and
  targets as the JAX pipeline's (images within 1 grey level, masks bit for
  bit, float targets within 1e-6).
- A JAX-written checkpoint with three heads: its header and variables load
  into the port (the same fields within 1e-5), and the port's save loads
  back into the JAX package with the same variables.
- One SGD step of the port's trainer with three heads against the JAX
  ``Trainer._train_step`` (the tolerances of ``test_torch_port_train.py``).

The train and eval CLIs on ``--toykp-with-dense`` are in
``test_torch_port_toy_cli.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.ops import pipeline as jax_pipeline
from openpifpaf_tpu.plugins.toykp.datamodule import ToyKp as JaxToyKp
from openpifpaf_tpu.plugins.toykp.datamodule import \
    ToyKpDataset as JaxToyKpDataset
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import datasets, decoder, headmeta, losses, models
from openpifpaf_tpu_torch.ops import pipeline
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.toykp import ToyKp, ToyKpDataset
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_decoder import build_fields, paint_caf, synthetic_pose
from test_torch_port_decode import assert_same_decode, metas
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_encoder import assert_targets_equal
from test_torch_port_encoder import numpy_painters  # noqa: F401  (fixture)
from test_torch_port_models import NARROW, random_variables
from test_torch_port_train import F32_EPS, OPTIMIZERS, configured

DENSE = constants.DENSER_COCO_PERSON_CONNECTIONS
SIZE = 97


def dense_meta(hm):
    meta = hm.Caf('caf25', 'toykp', keypoints=constants.COCO_KEYPOINTS,
                  sigmas=constants.COCO_PERSON_SIGMAS,
                  pose=constants.COCO_UPRIGHT_POSE, skeleton=DENSE,
                  sparse_skeleton=constants.COCO_PERSON_SKELETON,
                  only_in_field_of_view=True)
    meta.head_index, meta.base_stride = 2, 16
    return meta


@pytest.mark.parametrize('scales', [None, 0.5])
def test_caf_concatenate_matches_jax(scales):
    merged = []
    for hm in (jax_headmeta, headmeta):
        _, caf = metas(hm)
        caf.upsample_stride = 2
        dense = dense_meta(hm)
        if scales is not None:
            dense.decoder_confidence_scales = [scales] * len(DENSE)
        merged.append(hm.Caf.concatenate([caf, dense]))
    want, got = merged
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ('head_index', 'base_stride', 'upsample_stride'):
        assert getattr(got, name) == getattr(want, name), name
    assert got.name == 'caf_caf25' and got.n_fields == 19 + len(DENSE) == 37
    assert got.decoder_confidence_scales == \
        [1.0] * 19 + [1.0 if scales is None else scales] * len(DENSE)
    assert got.head_index == 1 and got.stride == 8


def dense_scenes():
    """A person, two people and a 3x3 crowd, painted on the sparse and the
    dense skeleton: (cif, caf, dense) batches."""
    people = [[synthetic_pose()],
              [synthetic_pose(offset_px=(-70.0, 0.0)),
               synthetic_pose(offset_px=(75.0, 10.0))],
              [synthetic_pose(offset_px=(dx, dy), scale=8.0)
               for dy in (0.0, 110.0, 220.0) for dx in (-110.0, 0.0, 110.0)]]
    cifs, cafs, denses = [], [], []
    for poses in people:
        cif, caf = build_fields(poses)
        dense = np.zeros((len(DENSE), 9, 21, 21), np.float32)
        dense[:, 0] = -10.0
        for kp, scales in poses:
            paint_caf(dense, kp, scales, DENSE, 16)
        cifs.append(cif)
        cafs.append(caf)
        denses.append(dense)
    return [np.stack(a) for a in (cifs, cafs, denses)]


def dense_decoders(value, monkeypatch):
    """Both packages' CifCaf with a dense head at ``--dense-connections
    value`` (the class attribute stays set for the test: the JAX decoder
    reads it at every decode)."""
    out = []
    for cls, hm, kw in ((jax_decoder.CifCaf, jax_headmeta, {}),
                        (decoder.CifCaf, headmeta, {'device': 'cpu'})):
        monkeypatch.setattr(cls, 'dense_connections', value)
        out.append(cls(*metas(hm), dense_caf_meta=dense_meta(hm), **kw))
    return out


def candidate_sets(cands, image):
    """Per (edge, direction): the number of valid candidates and their
    sorted scores."""
    score, valid = (np.asarray(a)[image] if np.asarray(a).ndim == 4
                    else np.asarray(a) for a in (cands.score, cands.valid))
    return [[(int(valid[e, d].sum()), np.sort(score[e, d][valid[e, d]]))
             for d in range(2)] for e in range(score.shape[0])]


@pytest.mark.parametrize('value', [1.0, 0.5, 0.0])
def test_dense_decode_matches_jax(value, monkeypatch):
    cif, caf, dense = dense_scenes()
    jax_dec, dec = dense_decoders(value, monkeypatch)
    n_edges = 37 if value else 19
    assert len(dec.caf_meta.skeleton) == len(jax_dec.caf_meta.skeleton) \
        == n_edges
    assert dec.caf_meta.decoder_confidence_scales == \
        jax_dec.caf_meta.decoder_confidence_scales
    want = jax_dec.batch_decoded([cif, caf, dense])
    got = dec.batch_decoded([torch.from_numpy(a) for a in (cif, caf, dense)])
    assert_same_decode([np.asarray(x) for x in want],
                       [x.numpy() for x in got])
    assert got.valid.sum(dim=1).tolist() == [1, 2, 9]

    anns = dec.batch_fields([torch.from_numpy(a) for a in (cif, caf, dense)])
    assert [len(a) for a in anns] == [1, 2, 9]
    assert len(anns[0][0].skeleton) == n_edges
    if not value:
        return

    # the candidates, scaled by the dense edges' confidence scales
    caf_all = dec.caf_fields([torch.from_numpy(a) for a in (cif, caf, dense)])
    assert caf_all.shape[1] == n_edges
    config = dec.config_for((21 * 16, 21 * 16))
    fe = pipeline.decode_front_end(torch.from_numpy(cif), caf_all,
                                   cif_meta=dec.cif_meta,
                                   caf_meta=dec.caf_meta, config=config)
    jax_config = jax_dec.config_for((21 * 16, 21 * 16))
    front = jax.jit(lambda c, a: jax_pipeline.decode_front_end(
        c, a, cif_meta=jax_dec.cif_meta, caf_meta=jax_dec.caf_meta,
        config=jax_config))
    for i in range(cif.shape[0]):
        jfe = front(cif[i], caf_all[i].numpy())
        for w_edge, g_edge in zip(candidate_sets(jfe.cands, None),
                                  candidate_sets(fe.cands, i)):
            for (wn, ws), (gn, gs) in zip(w_edge, g_edge):
                assert wn == gn
                np.testing.assert_allclose(gs, ws, atol=1e-4, rtol=0)
    # the dense edges' scores carry the flag's scale
    dense_max = float(fe.cands.score[:, 19:].max())
    assert 0.0 < dense_max <= value + 1e-6


def dense_toykp_sample(index, rng, augmentation):
    """The JAX ToyKp (``with_dense``) training sample with its random
    transforms on ``rng`` and the numpy encoders of its three heads."""
    old = JaxToyKp.with_dense
    try:
        JaxToyKp.with_dense = True
        dm = JaxToyKp()
    finally:
        JaxToyKp.with_dense = old
    for m in dm.head_metas:
        m.base_stride = 16
    flip = jax_transforms.HFlip(constants.COCO_KEYPOINTS, constants.HFLIP)
    steps = [dm._normalize()]  # pylint: disable=protected-access
    if augmentation:
        steps += [jax_transforms.RandomApply(flip, 0.5, rng=rng),
                  jax_transforms.RescaleRelative((0.8, 1.25), rng=rng),
                  jax_transforms.Crop(SIZE, rng=rng),
                  jax_transforms.CenterPad(SIZE)]
    else:
        steps += [jax_transforms.RescaleAbsolute(SIZE),
                  jax_transforms.CenterPad(SIZE)]
    steps += [jax_transforms.TRAIN_TRANSFORM, jax_encoder.Encoders(
        [jax_encoder.CifEncoder(dm.head_metas[0], use_native=False)]
        + [jax_encoder.CafEncoder(m, use_native=False)
           for m in dm.head_metas[1:]])]
    ds = JaxToyKpDataset(4, SIZE, jax_transforms.Compose(steps), seed=0)
    return ds[index]


def dense_toykp(monkeypatch, augmentation, size=SIZE):
    monkeypatch.setattr(ToyKp, 'image_size', size)
    monkeypatch.setattr(ToyKp, 'augmentation', augmentation)
    monkeypatch.setattr(ToyKp, 'with_dense', True)
    dm = ToyKp()
    for m in dm.head_metas:
        m.base_stride = 16
    return dm


@pytest.mark.parametrize('augmentation', [True, False])
def test_dense_toykp_samples_match_jax(augmentation, monkeypatch):
    dm = dense_toykp(monkeypatch, augmentation)
    assert [m.name for m in dm.head_metas] == ['cif', 'caf', 'caf25']
    assert dm.head_metas[2].only_in_field_of_view
    rng, jax_rng = np.random.default_rng(11), np.random.default_rng(11)
    ds = ToyKpDataset(3, SIZE, dm.preprocess(rng), seed=0, rng=rng)
    samples = [ds[i] for i in range(3)]
    for i, (image, targets, _) in enumerate(samples):
        want_image, want_targets, _ = dense_toykp_sample(i, jax_rng,
                                                         augmentation)
        diff = np.abs(image.permute(1, 2, 0).numpy() - want_image).max()
        assert diff <= 1.0 / (255 * 0.224) + 1e-6
        assert len(targets) == len(want_targets) == 3
        for want, got in zip(want_targets, targets):
            assert_targets_equal(want, got)
    _, targets, _ = datasets.collate_images_targets_meta(samples)
    assert targets[2]['vec'].shape == (3, len(DENSE), 2, 2, 7, 7)
    assert bool(targets[2]['conf_mask'].any())


def three_head_metas(hm):
    cif, caf = metas(hm)
    for m in (cif, caf):
        m.head_index = None
    out = [cif, caf, dense_meta(hm)]
    for m in out:
        m.base_stride = 16
    return out


def flax_three_heads(seed=0):
    module = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW, dtype=jnp.float32),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64,
                                             dtype=jnp.float32)
                   for m in three_head_metas(jax_headmeta)])
    return module, random_variables(module, seed)


def port_three_heads(flat, head_metas):
    for m in head_metas:
        m.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in head_metas])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return models.Model(shell, head_metas, base_stride=16,
                        device=torch.device('cpu'), bf16=False)


def test_three_head_checkpoint_both_ways(tmp_path):
    module, variables = flax_three_heads()
    path = str(tmp_path / 'jax.npz')
    jax_checkpoint.save(path, variables=variables,
                        head_metas=three_head_metas(jax_headmeta),
                        basenet_name='shufflenetv2k16', base_stride=16,
                        epoch=3)
    header, flat = models.checkpoint.load(path)
    assert [(type(m).__name__, m.name) for m in header['head_metas']] == \
        [('Cif', 'cif'), ('Caf', 'caf'), ('Caf', 'caf25')]
    caf25 = header['head_metas'][2]
    assert [tuple(e) for e in caf25.skeleton] == [tuple(e) for e in DENSE]
    assert [tuple(e) for e in caf25.sparse_skeleton] == \
        [tuple(e) for e in constants.COCO_PERSON_SKELETON]
    assert caf25.only_in_field_of_view and header['epoch'] == 3
    model = port_three_heads(flat, header['head_metas'])
    x = np.random.default_rng(0).normal(size=(2, 33, 33, 3)).astype(np.float32)
    want = module.apply(variables, x, train=False)
    got = model.apply(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert [tuple(g.shape) for g in got] == [
        (2, 17, 5, 3, 3), (2, 19, 9, 3, 3), (2, len(DENSE), 9, 3, 3)]
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g.numpy()).max() <= 1e-5

    back = str(tmp_path / 'port.npz')
    models.checkpoint.save(
        back, variables=models.to_jax_variables(model.module.state_dict()),
        head_metas=model.head_metas, basenet_name='shufflenetv2k16',
        base_stride=16, epoch=3)
    jax_header, jax_vars = jax_checkpoint.load(back)
    assert [m.name for m in jax_header['head_metas']] == \
        ['cif', 'caf', 'caf25']
    want_flat = jax_checkpoint.flatten_tree(variables)
    got_flat = jax_checkpoint.flatten_tree(jax_vars)
    assert set(got_flat) == set(want_flat)
    assert any('head_nets_2' in k for k in got_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], value, err_msg=key)


def test_three_head_train_step_matches_jax(monkeypatch):
    """One SGD (nesterov, norm clip, weight decay) step on a three-head
    toykp batch: the losses of all 9 components within 1e-5 relative, the
    parameter change within 1e-4 of its largest value per parameter (plus
    2 ulps), the BatchNorm statistics within 1e-5 relative."""
    settings = OPTIMIZERS['sgd_nesterov_clip_norm']
    dm = dense_toykp(monkeypatch, False, size=65)
    ds = ToyKpDataset(2, 65, dm.preprocess(np.random.default_rng(0)), seed=0)
    images, targets, _ = datasets.collate_images_targets_meta(
        [ds[i] for i in range(2)])
    assert len(targets) == 3

    module, variables = flax_three_heads()
    jax_metas = three_head_metas(jax_headmeta)
    jax_model = jax_models.Model(module, jax_metas, base_stride=16,
                                 basenet_name='shufflenetv2k16',
                                 variables=jax.tree.map(jnp.copy, variables))
    jax_model.fused_train = False
    jax_trainer = JaxTrainer(
        jax_model, jax_losses.Factory().factory(jax_metas),
        configured(JaxOptimizeFactory(), settings), '/dev/null',
        ema_decay=0.9)
    state = jax_trainer.init_state(2)
    jax_trainer._build_steps()  # pylint: disable=protected-access
    jax_trainer.n_devices = 1
    x, t = jax_trainer._place(  # pylint: disable=protected-access
        images.permute(0, 2, 3, 1).numpy(),
        [{k: v.numpy() for k, v in d.items()} for d in targets])
    state, want_total, want_comps = jax_trainer._train_step(  # pylint: disable=protected-access
        state, x, t)
    want = models.from_jax_variables(jax_checkpoint.flatten_tree(
        {'params': state.params, 'batch_stats': state.batch_stats}))

    model = port_three_heads(jax_checkpoint.flatten_tree(variables),
                             three_head_metas(headmeta))
    model.fused_train = False   # canonical against canonical, as JAX's
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      configured(OptimizeFactory(), settings), '/dev/null')
    trainer.setup(2)
    total, comps = trainer.train_step(images, targets)
    assert comps.shape == (9,)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(want_comps),
                               rtol=1e-5, atol=1e-7)
    state_dict = model.module.state_dict()
    for key, value in want.items():
        if key.endswith('num_batches_tracked'):
            continue
        if key.endswith(('running_mean', 'running_var')):
            scale = max(1.0, float(value.abs().max()))
            assert float((state_dict[key] - value).abs().max()) \
                <= 1e-5 * scale, key
            continue
        delta, want_delta = state_dict[key] - before[key], value - before[key]
        ulps = 2 * F32_EPS * float(before[key].abs().max())
        assert float((delta - want_delta).abs().max()) <= \
            1e-4 * float(want_delta.abs().max()) + ulps, key
    assert float((state_dict['head_nets.2.conv.weight']
                  - before['head_nets.2.conv.weight']).abs().max()) > 0
