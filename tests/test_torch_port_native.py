"""The port's native (C++) target painters, ``csrc/encoders.cpp`` bound by
``encoder/native.py``, against the numpy painters of both packages and
against the JAX package's native library.

The same annotations go through the port's encoders with ``use_native``
(the default) and without, and through the JAX package's with
``use_native=False`` (its numpy path) and ``True`` (its prebuilt
``csrc/libencoders.so``), for COCO's CIF (17) and CAF (19 edges), the
dense CAF (``DENSER_COCO_PERSON_CONNECTIONS``) and WholeBody's CIF (133)
and CAF (129 edges).  Bounds, JAX's (``tests/test_native_encoders.py:60-90``):
at most 0.1% of the float elements beyond atol 1e-4 and at most 0.1% of
the mask elements different (CAF: at most 4 when the maps are smaller than
4000); the numpy painters compute in float64 where the library computes in
float32.

The port's C++ source is the JAX package's but for one line: the CIF
painter places its square with ``std::lrint`` (ties to even, as numpy's
``np.round`` in both packages' ``cif.py``) where the JAX package's calls
``std::lround`` (ties away from zero).  A keypoint whose cell coordinate
less the square's offset is a half integer (``border``: a keypoint on the
image's last pixel row, ``(97 - 1) / 16 - 1.5 = 4.5``) gets its square one
cell apart in the JAX library, and 0.5% of the vector targets differ from
numpy, beyond JAX's own bound.  So the two libraries are held bit for bit
on every field without such a tie, and on the fields with one the JAX
library is shown to differ where the port's agrees with numpy.

A failing compiler raises with its output, and nothing falls back to
numpy.
"""

import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.encoder import native as jax_native
from openpifpaf_tpu.plugins.toykp import toywb as jax_toywb
from openpifpaf_tpu_torch import encoder, headmeta, kernels
from openpifpaf_tpu_torch.encoder import AnnRescaler, native
from openpifpaf_tpu_torch.plugins.toykp import toywb

from test_torch_port_dense import dense_meta
from test_torch_port_encoder import SIZE, annotated, metas_pair

WB_SIZE = 193


def wholebody_annotated(seed: int):
    """ToyWb's people (133 keypoints) as both packages' annotations."""
    gt = toywb.ToyWbDataset(1, WB_SIZE, None, seed=seed).ground_truth(0)

    def raw():
        return [{'keypoints': kp.copy(), 'iscrowd': 0, 'category_id': 1,
                 'bbox': [float(kp[:, 0].min()), float(kp[:, 1].min()),
                          20.0, 40.0]} for kp in gt]

    image = np.zeros((WB_SIZE, WB_SIZE, 3), np.uint8)
    _, jax_anns, _ = jax_toywb.ToyWb()._normalize()(  # pylint: disable=protected-access
        PIL.Image.fromarray(image), raw(), None)
    _, anns, _ = toywb.ToyWb()._normalize()(  # pylint: disable=protected-access
        torch.zeros(3, WB_SIZE, WB_SIZE), raw(), None)
    return image, jax_anns, anns


def wholebody_metas():
    ours, theirs = toywb.ToyWb().head_metas, jax_toywb.ToyWb().head_metas
    for m in ours + theirs:
        m.base_stride = 16
    return theirs, ours


def cases():
    """(label, jax meta, port meta, annotations of both packages)."""
    (jax_cif, jax_caf), (cif, caf) = metas_pair()
    jax_dense, dense = dense_meta(jax_headmeta), dense_meta(headmeta)
    for m in (jax_dense, dense):
        m.base_stride = 16
    for case in ('toykp', 'crowd', 'border'):
        inputs = annotated(case)
        yield f'coco cif {case}', jax_cif, cif, inputs
        yield f'coco caf {case}', jax_caf, caf, inputs
        yield f'dense caf {case}', jax_dense, dense, inputs
    (jax_wb_cif, jax_wb_caf), (wb_cif, wb_caf) = wholebody_metas()
    for seed in (0, 1):
        inputs = wholebody_annotated(seed)
        yield f'wholebody cif {seed}', jax_wb_cif, wb_cif, inputs
        yield f'wholebody caf {seed}', jax_wb_caf, wb_caf, inputs


CASES = {label: (jax_meta, meta, inputs)
         for label, jax_meta, meta, inputs in cases()}


def paint(jax_meta, meta, inputs):
    """Targets by (package, painter)."""
    image, jax_anns, anns = inputs
    jax_cls = (jax_encoder.CifEncoder if isinstance(jax_meta,
                                                    jax_headmeta.Cif)
               else jax_encoder.CafEncoder)
    cls = (encoder.CifEncoder if isinstance(meta, headmeta.Cif)
           else encoder.CafEncoder)
    tensor = torch.zeros(3, *image.shape[:2])
    return {
        ('port', 'native'): cls(meta)(tensor, anns, None),
        ('port', 'numpy'): cls(meta, use_native=False)(tensor, anns, None),
        ('jax', 'numpy'): jax_cls(jax_meta, use_native=False)(image,
                                                             jax_anns, None),
        ('jax', 'native'): jax_cls(jax_meta, use_native=True)(image,
                                                             jax_anns, None),
    }


def tie_fields(meta, anns) -> set:
    """The CIF fields with a visible keypoint whose square's corner is a
    half integer (``x - offset``, ``y - offset``)."""
    if not isinstance(meta, headmeta.Cif):
        return set()
    offset = (encoder.CifEncoder.side_length - 1) / 2.0
    ties = set()
    for kps in AnnRescaler(meta.stride, meta.pose).keypoint_sets(anns):
        for field, (x, y, v) in enumerate(kps):
            if v > 0 and 0.5 in (float(x - offset) % 1.0,
                                 float(y - offset) % 1.0):
                ties.add(field)
    return ties


def assert_within_bounds(want, got, caf: bool):
    assert set(want) == set(got)
    for key, w in want.items():
        g = np.asarray(got[key])
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if w.dtype == bool:
            allowed = max(4, w.size * 0.001) if caf else w.size * 0.001
            assert int(np.sum(g != w)) <= allowed, key
        else:
            close = np.isclose(g, w, atol=1e-4, rtol=0)
            assert close.mean() >= 0.999, (key, 1 - close.mean())


@pytest.mark.parametrize('label', list(CASES))
def test_native_painters(label):
    jax_meta, meta, inputs = CASES[label]
    before = native.PAINTS
    targets = paint(jax_meta, meta, inputs)
    assert native.PAINTS == before + 1
    got = targets[('port', 'native')]
    assert got['vec_mask'].any()
    caf = 'caf' in label
    # the numpy painters: the port's and the JAX package's
    assert_within_bounds(targets[('port', 'numpy')], got, caf)
    assert_within_bounds(targets[('jax', 'numpy')], got, caf)
    # the JAX package's library: bit for bit but for its ties
    assert jax_native.load() is not None
    jax_got = targets[('jax', 'native')]
    ties = tie_fields(meta, inputs[2])
    assert bool(ties) == (label == 'coco cif border'), ties
    others = [f for f in range(meta.n_fields) if f not in ties]
    for key, want in jax_got.items():
        np.testing.assert_array_equal(got[key][others], want[others],
                                      err_msg=key)
    if ties:
        ties = sorted(ties)
        numpy_vec = targets[('port', 'numpy')]['vec'][ties]
        assert not np.array_equal(jax_got['vec'][ties], got['vec'][ties])
        assert np.isclose(got['vec'][ties], numpy_vec, atol=1e-4).all()
        assert not np.isclose(jax_got['vec'][ties], numpy_vec,
                              atol=1e-4).all()


def test_source_is_the_jax_packages():
    """The port's copy is the JAX package's source but for its header
    comment and the rounding of the CIF square's corner."""
    def body(path):
        text = path.read_text()
        return text[text.index('#include <cmath>'):]

    jax_source = native.SOURCE.parents[2] / 'openpifpaf_tpu' / 'csrc' / \
        'encoders.cpp'
    ours = body(native.SOURCE)
    rounding = ('            // ties to even, as numpy\'s np.round in cif.py '
                '(std::lround,\n'
                '            // which the JAX package\'s copy calls, rounds '
                'them away from 0)\n'
                '            const long i0 = std::lrint(x - offset);\n'
                '            const long j0 = std::lrint(y - offset);')
    assert rounding in ours
    assert body(jax_source) == ours.replace(rounding, (
        '            const long i0 = std::lround(x - offset);\n'
        '            const long j0 = std::lround(y - offset);'))
    assert native.library_path().parent == kernels.BUILD_DIR


@pytest.mark.parametrize('cxx', ['false', '/nonexistent/c++'])
def test_failed_build_raises(cxx, monkeypatch):
    """A compiler that fails (or is missing) raises from the encoder; no
    numpy painting happens behind it."""
    monkeypatch.setenv('CXX', cxx)
    monkeypatch.setattr(native, '_LIB', None)
    assert not native.library_path().exists()
    jax_meta, meta, inputs = CASES['coco cif toykp']
    del jax_meta
    before = native.PAINTS
    with pytest.raises(RuntimeError, match='native painters'):
        encoder.CifEncoder(meta)(torch.zeros(3, SIZE, SIZE), inputs[2], None)
    assert native.PAINTS == before
    assert not native.library_path().exists()
    assert not list(native.library_path().parent.glob(
        native.library_path().stem + '*'))


def test_numpy_painters_need_no_library(monkeypatch):
    """``use_native=False`` neither builds nor loads the library."""
    monkeypatch.setenv('CXX', 'false')
    monkeypatch.setattr(native, '_LIB', None)
    _, meta, inputs = CASES['coco caf toykp']
    targets = encoder.CafEncoder(meta, use_native=False)(
        torch.zeros(3, SIZE, SIZE), inputs[2], None)
    assert targets['conf'].any() and native._LIB is None  # pylint: disable=protected-access
