"""The port's JPEG decoder and encoder against the JAX package's read path.

The JAX package reads every image through PIL (``Image.open(path)
.convert('RGB')``) and round-trips ``JpegCompression`` through PIL's
``save(buf, 'JPEG', quality=q)``.  The port does both without PIL: the
library ``csrc/jpeg.cpp`` (``openpifpaf_tpu_torch.jpeg``, behind
``image_io.read_image``) and its plain version ``jpeg_plain``.  On files
PIL writes from seeded images (smooth gradients and noise) in
``tmp_path``:

- decode: the library's and the plain version's output equal PIL's, max
  |delta| 0, at 1x1, 17x9, 33x47 and 97x61 px, quality 10, 50, 75, 95 and
  100, 4:4:4, 4:2:2, 4:2:0 and greyscale, and on progressive, optimised
  (``optimize=True``), restart-marker and custom-table files.  PIL writes
  ``subsampling='4:1:1'`` as 4:2:0, so the other sampling factors (luma
  4x1, 1x2, 1x4, chroma above luma) come from PIL's files with the frame
  header rewritten to the same blocks per MCU and MCU count, decoded by
  PIL as the reference, and so do component ids 'R', 'G', 'B' with and
  without the JFIF marker;
- encode: the library's and the plain version's bytes equal PIL's
  ``save`` (headers, tables and entropy-coded data), RGB and greyscale;
- ``JpegCompression``: the port's equals JAX's for the same seed;
- ``CocoDataset``: JAX's and the port's read a 3-image JPEG tree alike;
- each refusal raises the ``ValueError`` that names its feature, from the
  library and from the plain version; a failed build raises.
"""

import base64
import io
import json
import os
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest

from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.plugins.coco.dataset import CocoDataset as JaxCocoDataset
from openpifpaf_tpu_torch import image_io, jpeg, jpeg_plain, transforms
from openpifpaf_tpu_torch.plugins.coco import CocoDataset

import chip_smoke

SIZES = ((1, 1), (17, 9), (33, 47), (97, 61))   # (width, height)
QUALITIES = (10, 50, 75, 95, 100)
SAMPLINGS = ('4:4:4', '4:2:2', '4:2:0', 'grey')


def seeded_image(width, height, seed, grey=False):
    """Smooth gradients with noise: (H, W, 3) uint8, or (H, W)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    base = np.stack([xx * 255 / max(width - 1, 1),
                     yy * 255 / max(height - 1, 1),
                     128 + 100 * np.sin(xx / 5.0 + yy / 7.0)], -1)
    image = np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(
        np.uint8)
    return image[:, :, 0] if grey else image


def pil_jpeg(image, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(image).save(buf, 'JPEG', **kw)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    with PIL.Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert('RGB'))


def segment_at(data: bytes, markers) -> int:
    """The offset of the first segment whose marker is in ``markers``."""
    pos = 2
    while data[pos + 1] not in markers:
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], 'big')
    return pos


def with_frame(data: bytes, width=None, height=None, factors=None,
               marker=None, precision=None, ids=None) -> bytes:
    """``data`` with its frame header rewritten."""
    out = bytearray(data)
    pos = segment_at(data, (0xC0, 0xC1, 0xC2))
    if marker is not None:
        out[pos + 1] = marker
    if precision is not None:
        out[pos + 4] = precision
    if height is not None:
        out[pos + 5:pos + 7] = height.to_bytes(2, 'big')
    if width is not None:
        out[pos + 7:pos + 9] = width.to_bytes(2, 'big')
    for c, hv in enumerate(factors or ()):
        out[pos + 11 + 3 * c] = hv
    for c, ident in enumerate(ids or ()):
        out[pos + 10 + 3 * c] = ident
    return bytes(out)


def with_scan(data: bytes, ids=None, tables=None) -> bytes:
    """``data`` with its (first) scan header's component selectors or
    table selectors rewritten."""
    out = bytearray(data)
    pos = segment_at(data, (0xDA,))
    for c, ident in enumerate(ids or ()):
        out[pos + 5 + 2 * c] = ident
    for c, selector in enumerate(tables or ()):
        out[pos + 6 + 2 * c] = selector
    return bytes(out)


def assert_decodes_as_pil(data: bytes, tmp_path, name='x.jpg'):
    """The library (through ``image_io.read_image``) and the plain version
    decode ``data`` exactly as PIL does."""
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        f.write(data)
    with PIL.Image.open(path) as im:
        want = np.asarray(im.convert('RGB'))
    before = jpeg.DECODES
    got = image_io.read_image(path)
    assert jpeg.DECODES == before + 1
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jpeg_plain.decode(data), want)


@pytest.mark.parametrize('sampling', SAMPLINGS)
@pytest.mark.parametrize('quality', QUALITIES)
@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_decode_equals_pil(size, quality, sampling, tmp_path):
    grey = sampling == 'grey'
    image = seeded_image(*size, seed=quality + size[0], grey=grey)
    kw = {} if grey else dict(subsampling=sampling)
    assert_decodes_as_pil(pil_jpeg(image, quality=quality, **kw), tmp_path)


OPTIONS = {
    'progressive 4:2:0': dict(progressive=True),
    'progressive 4:4:4': dict(progressive=True, subsampling='4:4:4'),
    'progressive grey': dict(progressive=True, grey=True),
    'optimize 4:2:0': dict(optimize=True),
    'optimize 4:2:2': dict(optimize=True, subsampling='4:2:2'),
    'restart rows': dict(restart_marker_rows=1),
    'restart blocks 4:2:2': dict(restart_marker_blocks=3,
                                 subsampling='4:2:2'),
    'restart progressive': dict(restart_marker_rows=1, progressive=True),
    'custom tables': dict(qtables=[list(range(1, 65)),
                                   [(7 * i) % 255 + 1 for i in range(64)]]),
    '16-bit tables': dict(qtables=[list(range(250, 314)), [300] * 64]),
}


@pytest.mark.parametrize('quality', (50, 95))
@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('option', OPTIONS)
def test_decode_options_equal_pil(option, size, quality, tmp_path):
    kw = dict(OPTIONS[option])
    image = seeded_image(*size, seed=quality, grey=kw.pop('grey', False))
    if 'qtables' not in kw:
        kw['quality'] = quality
    data = pil_jpeg(image, **kw)
    if 'qtables' in kw and option.startswith('16'):
        assert data[segment_at(data, (0xDB,)) + 4] >> 4 == 1
    if option.startswith('progressive'):
        assert data[segment_at(data, (0xC0, 0xC1, 0xC2)) + 1] == 0xC2
    assert_decodes_as_pil(data, tmp_path)


# (PIL's subsampling, the factors written instead, the new frame size as a
# function of PIL's MCU count (mx, my)): the same blocks per MCU and MCUs;
# where a component's blocks move in the MCU, Cb codes with luma's tables
# so that each block keeps the tables it was coded with
REWRITTEN = {
    'luma 4x1 (4:1:1)': ('4:2:0', (0x41, 0x11, 0x11),
                         lambda mx, my: (32 * mx - 15, 8 * my - 3)),
    'luma 1x2 (4:4:0)': ('4:2:2', (0x12, 0x11, 0x11),
                         lambda mx, my: (8 * mx - 3, 16 * my - 7)),
    'luma 1x4': ('4:2:0', (0x14, 0x11, 0x11),
                 lambda mx, my: (8 * mx - 1, 32 * my - 9)),
    'Cr 2x1 above luma': ('4:2:2', (0x11, 0x11, 0x21),
                          lambda mx, my: (16 * mx - 5, 8 * my - 1)),
    'Cr 1x2 above luma': ('4:2:2', (0x11, 0x11, 0x12),
                          lambda mx, my: (8 * mx - 1, 16 * my - 3)),
}


@pytest.mark.parametrize('size', ((33, 47), (97, 61)),
                         ids=lambda s: f'{s[0]}x{s[1]}')
@pytest.mark.parametrize('case', REWRITTEN)
def test_decode_sampling_factors_equal_pil(case, size, tmp_path):
    subsampling, factors, frame = REWRITTEN[case]
    width, height = size
    data = pil_jpeg(seeded_image(width, height, 5), quality=85,
                    subsampling=subsampling)
    mx = -(-width // 16)
    my = -(-height // (16 if subsampling == '4:2:0' else 8))
    w2, h2 = frame(mx, my)
    data = with_frame(data, width=w2, height=h2, factors=factors)
    if case.startswith('Cr'):
        data = with_scan(data, tables=(0x00, 0x00, 0x11))
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize('jfif', [False, True], ids=['no JFIF', 'JFIF'])
def test_decode_rgb_component_ids(jfif, tmp_path):
    """Ids 'R', 'G', 'B': without a JFIF marker the components are RGB and
    are not converted, with one they are YCbCr (libjpeg's guess)."""
    data = pil_jpeg(seeded_image(33, 17, 6), quality=85, subsampling='4:4:4')
    if not jfif:
        app0 = segment_at(data, (0xE0,))
        data = data[:app0] + data[app0 + 18:]
    rgb = (82, 71, 66)
    assert_decodes_as_pil(with_scan(with_frame(data, ids=rgb), ids=rgb),
                          tmp_path)


@pytest.mark.parametrize('grey', [False, True], ids=['rgb', 'grey'])
@pytest.mark.parametrize('quality', QUALITIES)
@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_encode_equals_pil(size, quality, grey):
    image = seeded_image(*size, seed=3 * quality, grey=grey)
    want = pil_jpeg(image, quality=quality)
    assert jpeg.encode(image, quality) == want
    assert jpeg_plain.encode(image, quality) == want
    if grey:
        assert jpeg.encode(image[:, :, None], quality) == want


@pytest.mark.parametrize('seed', range(4))
def test_jpeg_compression_equals_jax(seed):
    image = seeded_image(47, 33, seed)
    jax_t = jax_transforms.JpegCompression(rng=np.random.default_rng(seed))
    port_t = transforms.JpegCompression(rng=np.random.default_rng(seed))
    want, _, _ = jax_t(PIL.Image.fromarray(image), [], {})
    import torch  # pylint: disable=import-outside-toplevel
    got, _, _ = port_t(torch.from_numpy(image).permute(2, 0, 1).float(),
                       [], {})
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(),
                                  np.asarray(want, np.float32))


def test_coco_dataset_reads_jpeg_as_jax(tmp_path):
    """A 3-image COCO tree of PIL-written JPEG files (4:2:0, progressive
    4:4:4, greyscale): the same samples from both packages."""
    tree = chip_smoke.write_coco_tree(str(tmp_path), sizes=(
        (97, 61), (61, 97), (33, 47)), seed=2)
    with open(tree['person_keypoints']) as f:
        data = json.load(f)
    options = (dict(quality=90), dict(quality=80, progressive=True,
                                      subsampling='4:4:4'),
               dict(quality=70))
    for entry, kw in zip(data['images'], options):
        old = os.path.join(tree['images'], entry['file_name'])
        image = image_io.read_image(old)
        os.remove(old)
        entry['file_name'] = os.path.splitext(entry['file_name'])[0] + '.jpg'
        if kw is options[2]:
            image = image[:, :, 0]
        with open(os.path.join(tree['images'], entry['file_name']),
                  'wb') as f:
            f.write(pil_jpeg(image, **kw))
    with open(tree['person_keypoints'], 'w') as f:
        json.dump(data, f)
    want = JaxCocoDataset(tree['images'], tree['person_keypoints'])
    got = CocoDataset(tree['images'], tree['person_keypoints'])
    assert got.ids == want.ids and len(got) == 3
    for index in range(3):
        want_image, want_anns, want_meta = want[index]
        image, anns, meta = got[index]
        np.testing.assert_array_equal(image.permute(1, 2, 0).numpy(),
                                      np.asarray(want_image, np.float32))
        assert anns == want_anns and meta == want_meta


def truncated(data):
    return data[:len(data) // 2]


def marker_in_scan(data):
    pos = segment_at(data, (0xDA,))
    start = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], 'big')
    middle = (start + len(data)) // 2
    return data[:middle] + b'\xff\xd3' + data[middle:]


def incomplete_progression(data):
    """A progressive file cut after its first two scans (DC, then the
    first luma AC band at Al 2), closed by EOI: libjpeg smooths it."""
    pos, scans = 2, 0
    while True:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], 'big')
        if marker == 0xDA:
            scans += 1
            if scans == 3:
                return data[:pos] + b'\xff\xd9'
            pos = data.index(b'\xff', pos + 2 + length)
            while data[pos + 1] in (0x00, 0xFF) or \
                    0xD0 <= data[pos + 1] <= 0xD7:
                pos = data.index(b'\xff', pos + 1)
            continue
        pos += 2 + length


REFUSALS = {
    'arithmetic': (lambda d: with_frame(d, marker=0xC9), 'arithmetic'),
    '12-bit': (lambda d: with_frame(d, marker=0xC1, precision=12), '12-bit'),
    'lossless': (lambda d: with_frame(d, marker=0xC3), 'lossless'),
    'hierarchical': (lambda d: with_frame(d, marker=0xC5), 'hierarchical'),
    'DNL': (lambda d: with_frame(d, height=0), 'DNL'),
    'truncated': (truncated, 'truncated'),
    'corrupt': (marker_in_scan, 'truncated or corrupt'),
    'smoothing': (incomplete_progression, 'block smoothing'),
    'not a JPEG': (lambda d: b'\x89PNG' + d[4:], 'not a JPEG'),
}


@pytest.mark.parametrize('case', REFUSALS)
def test_refusals_name_the_feature(case):
    change, match = REFUSALS[case]
    data = change(pil_jpeg(seeded_image(33, 47, 1), quality=75,
                           progressive=case == 'smoothing'))
    for decode in (jpeg.decode, jpeg_plain.decode):
        with pytest.raises(ValueError, match=match):
            decode(data)


def test_cmyk_is_refused():
    """Once refused, a CMYK file (and the same bytes marked YCCK by
    Adobe's transform 2) now decodes in both decoders as PIL reads it
    (more cases: ``test_torch_port_image_formats.py``)."""
    buf = io.BytesIO()
    PIL.Image.fromarray(seeded_image(17, 9, 0)).convert('CMYK').save(
        buf, 'JPEG')
    data = buf.getvalue()
    at = data.index(b'Adobe')
    ycck = data[:at + 11] + b'\x02' + data[at + 12:]
    for variant in (data, ycck):
        for decode in (jpeg.decode, jpeg_plain.decode):
            np.testing.assert_array_equal(decode(variant),
                                          pil_decode(variant))


def test_progressive_sample_of_the_chip_check():
    """``chip_smoke.py`` carries a PIL-written progressive file and the
    hash of PIL's decode of it: both hold here."""
    data = base64.b64decode(chip_smoke.PROGRESSIVE_JPEG)
    got = jpeg.decode(data)
    np.testing.assert_array_equal(got, pil_decode(data))
    np.testing.assert_array_equal(jpeg_plain.decode(data), got)
    import hashlib  # pylint: disable=import-outside-toplevel
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        chip_smoke.PROGRESSIVE_PIL_SHA256


@pytest.mark.parametrize('cxx', ['false', '/nonexistent/c++'])
def test_failed_build_raises(cxx, monkeypatch):
    """A compiler that fails (or is missing) raises from the reader; no
    other decoder stands behind it."""
    monkeypatch.setenv('CXX', cxx)
    monkeypatch.setattr(jpeg, '_LIB', None)
    data = pil_jpeg(seeded_image(9, 9, 0))
    with pytest.raises(RuntimeError, match='JPEG'):
        jpeg.decode(data)
    with pytest.raises(RuntimeError, match='JPEG'):
        jpeg.encode(seeded_image(9, 9, 0))


BUILD_ONE = """
import sys
from pathlib import Path
from openpifpaf_tpu_torch import host_library
host_library.BUILD_DIR = Path(sys.argv[1])
print(host_library.build(Path(sys.argv[2]), 'probe', 'probe library'))
"""


def test_concurrent_builds(tmp_path):
    """Six processes build one new library at once (as data loader workers
    may): each gets the same complete file, and no partial file is left."""
    source = tmp_path / 'probe.cpp'
    source.write_text('extern "C" int probe() { return 17; }\n')
    build_dir = tmp_path / 'build'
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(
        [sys.executable, '-c', BUILD_ONE, str(build_dir), str(source)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [proc.communicate(timeout=120) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in build_dir.iterdir()] == \
        [os.path.basename(paths.pop())]
    import ctypes  # pylint: disable=import-outside-toplevel
    assert ctypes.CDLL(str(next(build_dir.iterdir()))).probe() == 17
