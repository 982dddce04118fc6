"""The port's PNG and BMP readers (``openpifpaf_tpu_torch.image_io``)
against PIL's ``Image.open(path).convert('RGB')``, the JAX package's read
path, exactly.

- PNG: every colour type at every bit depth the specification allows
  (greyscale 1, 2, 4, 8, 16; RGB, grey with alpha and RGBA 8 and 16;
  palette 1, 2, 4, 8), each without and with Adam7 interlacing.  PIL
  writes the 8-bit files and palette files at ``bits`` 1, 2 and 4 (with
  and without ``optimize``); it writes neither interlaced files nor grey
  at 2 and 4 bits nor colour at 16 bits, so those are written here (every
  row filter in turn) and read by PIL as the reference.  16-bit files are
  read as PIL reads them, not refused: colour keeps each sample's high
  byte, greyscale (PIL's ``I;16``) clips at 255 in ``convert('RGB')``.
- BMP: PIL's 24-bit, 32-bit and 8-bit palette (``P`` and ``L``) files,
  and files written here: top-down rows, ``BI_BITFIELDS`` 32-bit with the
  40-, 52-, 56-, 108- and 124-byte headers, PIL's 1-bit files.  Embedded
  JPEG or PNG and bit fields Pillow does not read raise a ``ValueError``
  naming what is not read.
"""

import io
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from openpifpaf_tpu_torch import image_io

IMAGE = np.random.default_rng(0).integers(0, 256, (13, 19, 3), np.uint8)
IMAGE[4:9, 3:11] = (200, 40, 90)     # a flat block for the row filters


def pil_rgb(path):
    with PIL.Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def assert_reads_as_pil(data: bytes, tmp_path, suffix: str):
    path = str(tmp_path / f'x{suffix}')
    with open(path, 'wb') as f:
        f.write(data)
    want = pil_rgb(path)
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pil_png(image, mode, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(image).convert(mode).save(buf, 'PNG', **kw)
    return buf.getvalue()


@pytest.mark.parametrize('optimize', [False, True])
@pytest.mark.parametrize('mode,bits', [
    ('L', None), ('LA', None), ('RGB', None), ('RGBA', None), ('1', None),
    ('P', None), ('P', 1), ('P', 2), ('P', 4)])
def test_pil_png_files(mode, bits, optimize, tmp_path):
    if mode == 'P':
        image = PIL.Image.fromarray(IMAGE).convert(
            'P', palette=PIL.Image.Palette.ADAPTIVE, colors=2 ** (bits or 8))
        buf = io.BytesIO()
        image.save(buf, 'PNG', optimize=optimize,
                   **({'bits': bits} if bits else {}))
        data = buf.getvalue()
    else:
        data = pil_png(IMAGE, mode, optimize=optimize)
    assert_reads_as_pil(data, tmp_path, '.png')


def pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) bytes of ``depth`` bits each."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        return flat.astype('>u2').view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat << shifts).sum(-1).astype(np.uint8)


def png_file(samples, depth, colour, interlace, palette=None) -> bytes:
    """A PNG of ``samples`` (h, w, c), each row filtered with the next of
    the five filters; Adam7 passes when ``interlace``."""
    height, width = samples.shape[:2]
    bpp = max(1, samples.shape[2] * depth // 8)
    passes = image_io.ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, kind = [], 0
    for r0, c0, rs, cs in passes:
        sub = samples[r0::rs, c0::cs]
        if not sub.size:
            continue
        for row in pack(sub, depth):
            raw.append(bytes([kind]) + image_io._filter_rows(  # pylint: disable=protected-access
                row[None], bpp, kind).tobytes())
            kind = (kind + 1) % 5

    def chunk(name, body):
        return (struct.pack('>I', len(body)) + name + body
                + struct.pack('>I', zlib.crc32(name + body)))

    chunks = [chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth,
                                         colour, 0, 0, interlace))]
    if palette is not None:
        chunks.append(chunk(b'PLTE', palette.tobytes()))
    chunks.append(chunk(b'IDAT', zlib.compress(b''.join(raw))))
    return image_io.SIGNATURE + b''.join(chunks) + chunk(b'IEND', b'')


# (colour type, bit depth): every combination the specification allows
COMBINATIONS = [(colour, depth) for colour, depths in image_io.DEPTHS.items()
                for depth in depths]


@pytest.mark.parametrize('interlace', [0, 1], ids=['plain', 'adam7'])
@pytest.mark.parametrize('colour,depth', COMBINATIONS,
                         ids=[f'type{c}-{d}bit' for c, d in COMBINATIONS])
def test_written_png_files(colour, depth, interlace, tmp_path):
    channels = image_io.CHANNELS[colour]
    rng = np.random.default_rng(colour * 100 + depth)
    top = 2 ** depth
    if colour == 3:
        top = min(top, 200)   # a palette shorter than the depth allows
    samples = rng.integers(0, top, (13, 19, channels))
    samples[4:9, 3:11] = top - 1
    palette = (rng.integers(0, 256, (200 if depth == 8 else 2 ** depth, 3))
               .astype(np.uint8) if colour == 3 else None)
    assert_reads_as_pil(png_file(samples, depth, colour, interlace, palette),
                        tmp_path, '.png')


def test_png_indices_past_the_palette(tmp_path):
    """Indices past a short palette read black, as in PIL."""
    samples = np.arange(12).reshape(1, 12, 1)
    palette = np.array([[10, 20, 30], [40, 50, 60], [70, 80, 90]], np.uint8)
    data = png_file(samples, 8, 3, 0, palette)
    assert_reads_as_pil(data, tmp_path, '.png')
    assert not image_io.read_image(str(tmp_path / 'x.png'))[0, 3:].any()


def test_png_refusals():
    data = png_file(np.zeros((2, 2, 3), np.int64), 4, 2, 0)
    with pytest.raises(ValueError, match='bit depth 4, colour type 2'):
        image_io.read_png(data)
    data = png_file(np.zeros((2, 2, 1), np.int64), 8, 3, 0)
    with pytest.raises(ValueError, match='PLTE'):
        image_io.read_png(data)


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'P', 'L'])
def test_pil_bmp_files(mode, tmp_path):
    image = PIL.Image.fromarray(IMAGE).convert(mode)
    buf = io.BytesIO()
    image.save(buf, 'BMP')
    assert_reads_as_pil(buf.getvalue(), tmp_path, '.bmp')


def bmp_file(pixels, bpp, compression, header=40, masks=None,
             top_down=False) -> bytes:
    """A BMP of (h, w, bpp // 8) pixel bytes in file order."""
    h, w = pixels.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    rows = pixels if top_down else pixels[::-1]
    data = b''.join(r.tobytes().ljust(stride, b'\0') for r in rows)
    info = struct.pack('<IiiHHIIiiII', header, w, -h if top_down else h, 1,
                       bpp, compression, len(data), 2835, 2835, 0, 0)
    extra = b''
    if masks and header > 40:
        info += struct.pack('<IIII', *masks)[:header - 40]
    elif masks:
        extra = struct.pack('<III', *masks[:3])
    info = info.ljust(header, b'\0')
    offset = 14 + len(info) + len(extra)
    return (b'BM' + struct.pack('<IHHI', offset + len(data), 0, 0, offset)
            + info + extra + data)


BGRA = np.concatenate([IMAGE[:, :, ::-1], np.full((13, 19, 1), 7, np.uint8)],
                      2)
XBGR = np.concatenate([np.full((13, 19, 1), 7, np.uint8), IMAGE[:, :, ::-1]],
                      2)
BITFIELDS = {
    'bgra': (BGRA, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    'bgrx': (BGRA, (0xFF0000, 0xFF00, 0xFF, 0)),
    'xbgr': (XBGR, (0xFF000000, 0xFF0000, 0xFF00, 0)),
}


@pytest.mark.parametrize('top_down', [False, True],
                         ids=['bottom-up', 'top-down'])
@pytest.mark.parametrize('header', [40, 52, 56, 108, 124])
@pytest.mark.parametrize('layout', BITFIELDS)
def test_written_bmp_bitfields(layout, header, top_down, tmp_path):
    pixels, masks = BITFIELDS[layout]
    data = bmp_file(pixels, 32, 3, header, masks, top_down)
    assert_reads_as_pil(data, tmp_path, '.bmp')
    np.testing.assert_array_equal(image_io.read_bmp(data), IMAGE)


@pytest.mark.parametrize('bpp', [24, 32])
def test_written_bmp_top_down(bpp, tmp_path):
    pixels = IMAGE[:, :, ::-1] if bpp == 24 else BGRA
    assert_reads_as_pil(bmp_file(np.ascontiguousarray(pixels), bpp, 0,
                                 top_down=True), tmp_path, '.bmp')


def test_bmp_refusals(tmp_path):
    """1-bit files, once refused, read as PIL reads them (the other 1-, 4-
    and 16-bit and RLE files: ``test_torch_port_image_formats.py``); an
    embedded JPEG or PNG and bit fields Pillow does not read still raise."""
    buf = io.BytesIO()
    PIL.Image.fromarray(IMAGE).convert('1').save(buf, 'BMP')
    assert_reads_as_pil(buf.getvalue(), tmp_path, '.bmp')
    for compression, name in ((4, 'embedded JPEG'), (5, 'embedded PNG')):
        with pytest.raises(ValueError, match=name):
            image_io.read_bmp(bmp_file(BGRA, 32, compression))
    masks = (0x7C00, 0x3E0, 0x1F, 0)
    with pytest.raises(ValueError, match='masks 0x7c00'):
        image_io.read_bmp(bmp_file(BGRA, 32, 3, 108, masks))
