"""The port's ``parallel`` package against the JAX package's.

- ``sharded_cif_hr`` and ``sharded_seeds`` in gloo groups of 2 and 4
  processes on the CPU (``parallel.run_group``; the rank body is
  ``torch_port_dist.spatial_bands``) against JAX's ``parallel.spatial`` on
  a 2- and 4-device virtual mesh, at ``tests/test_parallel.py``'s shapes
  and tolerances (F 3, 16 x 12 cells at stride 8, hires (64, 48), halo
  24 px, 64 seeds); both against the unsharded ``cif_hr.accumulate`` and
  ``seeds.select``;
- the overflow counter on a blob that no halo holds, and the errors of
  rows that do not divide and of a halo taller than a band;
- ``shard_batch`` and ``Predictor``'s padded shard (each rank's
  contiguous slice), and ``DataModule.distributed_sampler`` against the
  JAX ``Loader.shard`` rule;
- ``--dp-eval`` with a decoder that has no ``batch_decoded``: JAX's
  warning, and no group.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils.data import DataLoader

from openpifpaf_tpu.datasets.loader import Loader
from openpifpaf_tpu.ops import cif_hr as jax_cif_hr
from openpifpaf_tpu.ops import seeds as jax_seeds
from openpifpaf_tpu.parallel import spatial as jax_spatial
from openpifpaf_tpu_torch import datasets, parallel
from openpifpaf_tpu_torch.ops import cif_hr, seeds

import torch_port_dist as dist_bodies

OUT_HW = (64, 48)


def fields(f=3, h=16, w=12, stride=8, seed=0):
    """``tests/test_parallel.py``'s fields: targets near the cell centres."""
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, (f, h, w)).astype(np.float32)
    jj, ii = np.mgrid[0:h, 0:w].astype(np.float32)
    x_px = (ii[None] + rng.uniform(-1, 1, (f, h, w))) * stride
    y_px = (jj[None] + rng.uniform(-1, 1, (f, h, w))) * stride
    scale_px = rng.uniform(2.0, 8.0, (f, h, w)).astype(np.float32)
    return (conf, x_px.astype(np.float32), y_px.astype(np.float32),
            scale_px)


def overflow_fields():
    conf, x_px, y_px, scale_px = fields()
    scale_px[0, 8, 5] = 500.0
    conf[0, 8, 5] = 0.9
    return conf, x_px, y_px, scale_px


def mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ('spatial',))


@pytest.fixture(scope='module', params=[2, 4], ids=['2_ranks', '4_ranks'])
def bands(request):
    """(n, the ranks' results, JAX's banded hr, seeds and overflow)."""
    n = request.param
    batch = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    ranks = parallel.run_group(dist_bodies.spatial_bands, n, (
        [torch.from_numpy(a) for a in fields()],
        [torch.from_numpy(a) for a in overflow_fields()], batch),
        timeout=240)
    # jitted: outside jit shard_map runs (and compiles) op by op
    args = [jnp.asarray(a) for a in fields()]
    config = jax_cif_hr.CifHrConfig()
    sharded = jax.jit(functools.partial(
        jax_spatial.sharded_cif_hr, mesh=mesh(n), out_hw=OUT_HW,
        config=config, spatial=jax_spatial.SpatialConfig(halo_px=24.0)))(
            *args)
    sharded_seeds = jax.jit(functools.partial(
        jax_spatial.sharded_seeds, mesh=mesh(n),
        hr_spacing=float(config.spacing),
        config=jax_seeds.SeedsConfig(max_seeds=64),
        spatial=jax_spatial.SpatialConfig(halo_px=24.0)))(*args, sharded.hr)
    overflow = jax.jit(functools.partial(
        jax_spatial.sharded_cif_hr, mesh=mesh(4), out_hw=OUT_HW,
        config=config, spatial=jax_spatial.SpatialConfig(halo_px=16.0)))(
            *[jnp.asarray(a) for a in overflow_fields()]).halo_overflow
    return n, batch, ranks, (np.asarray(sharded.hr), sharded_seeds,
                             int(overflow))


def test_sharded_cif_hr_matches_jax(bands):
    _, _, ranks, (want_hr, _, _) = bands
    hr = torch.cat([r[0] for r in ranks], dim=1).numpy()
    assert [r[1] for r in ranks] == [0] * len(ranks)
    np.testing.assert_allclose(hr, want_hr, rtol=1e-5, atol=1e-5)
    # and the unsharded call, as K1 is held on the card
    dense = cif_hr.accumulate(*[torch.from_numpy(a) for a in fields()],
                              out_hw=OUT_HW, config=cif_hr.CifHrConfig())
    np.testing.assert_allclose(hr, dense.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_seeds_match_jax(bands):
    _, _, ranks, (_, want, _) = bands
    args = [torch.from_numpy(a)[None] for a in fields()]
    dense = cif_hr.accumulate(*args, out_hw=OUT_HW,
                              config=cif_hr.CifHrConfig())
    oracle = seeds.select(*args, dense, hr_spacing=2.0,
                          config=seeds.SeedsConfig(max_seeds=64))
    n_valid = int(np.sum(np.asarray(want.valid)))
    assert n_valid > 0
    for got in (r[2] for r in ranks):     # the same seeds on every rank
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      oracle.valid[0].numpy())
        for name in ('v', 'f', 'x', 'y', 's'):
            got_v = getattr(got, name)[:n_valid].numpy()
            np.testing.assert_allclose(
                got_v, np.asarray(getattr(want, name))[:n_valid],
                rtol=1e-5, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(
                got_v, getattr(oracle, name)[0, :n_valid].numpy(),
                rtol=1e-5, atol=1e-5, err_msg=name)


def test_overflow_counter_and_errors(bands):
    n, _, ranks, (_, _, want_overflow) = bands
    assert want_overflow >= 1
    overflow = [r[3] for r in ranks]
    assert overflow == [overflow[0]] * n and overflow[0] >= 1
    if n == 4:
        assert overflow[0] == want_overflow
    for errors in (r[4] for r in ranks):
        assert len(errors) == 2
        assert 'must divide' in errors[0]
        assert 'exceeds the band height' in errors[1]


def test_shard_batch(bands):
    """Each rank's contiguous slice; the predictor pads 3 images with
    copies of the last to a multiple of the group first."""
    n, batch, ranks, _ = bands
    assert torch.equal(torch.cat([r[5] for r in ranks]), batch)
    per = -(-3 // n)
    padded = torch.cat([batch[:3]] + [batch[2:3]] * (per * n - 3))
    for r, rank in enumerate(ranks):
        assert torch.equal(rank[6], padded[r * per:(r + 1) * per])


def test_dp_eval_without_batch_decoded(bands):
    """A decoder without ``batch_decoded`` (``Multi``) runs undistributed,
    with the JAX package's warning (``predictor.py:79-87``)."""
    for rank in bands[2]:
        name, left_group, warnings = rank[7]
        assert name == 'Multi' and left_group
        assert warnings == ['Multi has no batch_decoded tensor path; '
                            'multi-process --dp-eval disabled']


class Indices(torch.utils.data.Dataset):
    def __len__(self):
        return 11

    def __getitem__(self, index):
        return index


@pytest.mark.parametrize('n_hosts', [1, 2, 3])
def test_distributed_sampler_follows_loader_shard(n_hosts):
    """Unshuffled, the batches of JAX's ``Loader.shard`` exactly; shuffled,
    each rank's contiguous part of the one order that the seed gives."""
    module = datasets.DataModule()
    module.batch_size = 2

    def batches(loader):
        return [b.tolist() for b in loader]

    for host_id in range(n_hosts):
        want = list(Loader(Indices(), batch_size=2).shard(
            host_id, n_hosts)._batched_indices())
        got = batches(module.distributed_sampler(
            DataLoader(Indices(), batch_size=2, drop_last=True),
            host_id=host_id, n_hosts=n_hosts))
        assert got == [list(b) for b in want]

        order = [int(i) for i in DataLoader(
            Indices(), shuffle=True,
            generator=torch.Generator().manual_seed(3))]
        per = 11 // n_hosts
        got = batches(module.distributed_sampler(
            module.loader(Indices(), shuffle=True, seed=3,
                          collate_fn=torch.tensor),
            host_id=host_id, n_hosts=n_hosts))
        part = order[host_id * per:(host_id + 1) * per]
        assert got == [part[i:i + 2] for i in range(0, per - 1, 2)]
