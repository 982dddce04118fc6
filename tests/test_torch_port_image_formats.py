"""The port's image files by content (``image_io.read_image``: WebP, GIF,
TIFF, PNM, the rest of BMP, CMYK JPEG) against PIL's
``np.asarray(Image.open(path).convert('RGB'))``, the JAX package's read
path, with max|delta| 0.

- WebP written by PIL: lossy at quality 0/50/80/100 x method 0/4/6,
  lossless at method 0/6 and with 2, 4, 16 and 200 colours (colour
  indexing with 8, 4, 2 and 1 pixels per byte), RGBA lossy (VP8X with
  ALPH) and lossless (alpha in VP8L), two-frame animations; sizes 1x1, 17x9, 33x47 and
  97x61.
- GIF written by PIL (palette, greyscale, interlaced at 16 px and up,
  transparency) and written here: interlaced, a local colour table, a
  transparent index, a first frame smaller than the screen, one that
  overflows it, a grey ramp table, no table, indices past the table.
- TIFF written by PIL in every compression read (none, PackBits, LZW with
  and without predictor 2, Deflate 8 and 32946), in RGB, RGBA, L, P and
  1, and written here: tiles, WhiteIsZero, associated alpha.
- PNM P1-P6 with comments, maxval 15, 255 and 65535.
- BMP at 1, 4 and 16 bits and RLE4/RLE8 with their escapes (PIL writes
  none of these but 1 bit: the bytes are built here).
- The format by content: a JPEG named ``.png``, a PNG named ``.jpg``, no
  suffix, ``.jfif``; every refusal with its message.
- ``ImageList`` and ``CocoDataset`` of both packages on a mixed tree, both
  video ``FrameReader``s on a folder that also holds WebP and GIF files,
  and the port's predict CLI giving one JSON for a file and its PNG twin.
"""

import base64
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import video as jax_video
from openpifpaf_tpu.datasets.loader import ImageList as JaxImageList
from openpifpaf_tpu.plugins.coco.dataset import CocoDataset as JaxCocoDataset
from openpifpaf_tpu_torch import (decoder, debug_checks, image_formats,
                                  image_io, jpeg, jpeg_plain, video)
from openpifpaf_tpu_torch import models as port_models
from openpifpaf_tpu_torch import predict as port_predict
from openpifpaf_tpu_torch.datasets.image_list import ImageList
from openpifpaf_tpu_torch.models import base, checkpoint, shufflenetv2k
from openpifpaf_tpu_torch.plugins.coco.dataset import CocoDataset
from openpifpaf_tpu_torch.predictor import Predictor

import chip_smoke
from test_torch_port_image_io import bmp_file
from test_torch_port_models import NARROW, coco_metas
from test_torch_port_predict import (NARROW_NAME, keep_configuration,
                                     narrow_spec)

SIZES = ((1, 1), (9, 17), (47, 33), (61, 97))   # (h, w)


def seeded(h, w, seed, smooth=False):
    return chip_smoke.small_image(h, w, seed) if not smooth else np.clip(
        np.mgrid[0:h, 0:w].sum(0)[:, :, None] * 3 + np.arange(3) * 40, 0,
        255).astype(np.uint8)


def pil_bytes(image, fmt, mode=None, **kw) -> bytes:
    im = image if isinstance(image, PIL.Image.Image) else \
        PIL.Image.fromarray(image)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    with PIL.Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert('RGB'))


def assert_as_pil(data: bytes, tmp_path=None, name='x'):
    want = pil_rgb(data)
    if tmp_path is None:
        got = image_io.decode(data)
    else:
        path = tmp_path / name
        path.write_bytes(data)
        got = image_io.read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ WebP

@pytest.mark.parametrize('method', [0, 4, 6])
@pytest.mark.parametrize('quality', [0, 50, 80, 100])
def test_webp_lossy(quality, method):
    for i, (h, w) in enumerate(SIZES):
        for smooth in (False, True):
            assert_as_pil(pil_bytes(seeded(h, w, i, smooth), 'WEBP',
                                    quality=quality, method=method))


@pytest.mark.parametrize('method', [0, 6])
def test_webp_lossless(method):
    for i, (h, w) in enumerate(SIZES):
        assert_as_pil(pil_bytes(seeded(h, w, i), 'WEBP', lossless=True,
                                method=method))


@pytest.mark.parametrize('colours', [2, 4, 16, 200])
def test_webp_lossless_colour_indexing(colours):
    rng = np.random.default_rng(colours)
    table = rng.integers(0, 256, (colours, 3), np.uint8)
    for h, w in SIZES[1:]:
        indices = (np.arange(h * w).reshape(h, w) // 3 + rng.integers(
            0, 2, (h, w))) % colours
        assert_as_pil(pil_bytes(table[indices], 'WEBP', lossless=True))


@pytest.mark.parametrize('options', [
    dict(lossless=True), dict(lossless=True, exact=True), dict(quality=60),
    dict(quality=90, alpha_quality=40)], ids=['lossless', 'exact', 'lossy',
                                              'lossy-alpha-q40'])
def test_webp_with_alpha(options):
    for i, (h, w) in enumerate(SIZES):
        alpha = (np.arange(h * w).reshape(h, w) * 7 % 256).astype(np.uint8)
        data = pil_bytes(np.dstack([seeded(h, w, i), alpha]), 'WEBP',
                         **options)
        # lossy alpha is an ALPH chunk beside VP8 in VP8X; lossless alpha
        # lies inside the VP8L bitstream
        assert data[12:16] == (b'VP8L' if options.get('lossless') else
                               b'VP8X')
        assert_as_pil(data)


@pytest.mark.parametrize('options', [dict(lossless=True), dict(quality=70)])
def test_webp_animation_first_frame(options):
    for i, (h, w) in enumerate(SIZES[1:]):
        frames = [PIL.Image.fromarray(seeded(h, w, i + k)) for k in (0, 5)]
        data = pil_bytes(frames[0], 'WEBP', save_all=True,
                         append_images=frames[1:], duration=100, **options)
        assert b'ANMF' in data
        assert_as_pil(data)


def riff_chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack('<I', len(body)) + body + b'\0' * (len(body) % 2)


def test_webp_extended_chunks_and_frame_offset():
    """ICCP and EXIF chunks are skipped (``convert('RGB')`` applies no
    profile); an animation's first frame at an offset lands on the zeroed
    canvas, as Pillow's animation decoder puts it."""
    data = pil_bytes(seeded(20, 30, 1), 'WEBP', quality=80,
                     exif=b'Exif\0\0MM\0*\0\0\0\x08\0\0',
                     icc_profile=b'\0' * 200)
    assert b'ICCP' in data and b'EXIF' in data
    assert_as_pil(data)
    for options in (dict(lossless=True), dict(quality=70)):
        still = pil_bytes(seeded(9, 11, 2), 'WEBP', **options)
        frame = still[12:]   # the VP8L or VP8 chunk
        body = b'WEBP' + riff_chunk(
            b'VP8X', bytes([0x02, 0, 0, 0]) + (19).to_bytes(3, 'little')
            + (15).to_bytes(3, 'little')) + riff_chunk(
                b'ANIM', struct.pack('<IH', 0xFF336699, 0)) + riff_chunk(
                    b'ANMF', b''.join(v.to_bytes(3, 'little')
                                      for v in (1, 3, 10, 8, 100))
                    + b'\0' + frame)
        assert_as_pil(b'RIFF' + struct.pack('<I', len(body)) + body)


def test_webp_counts_its_decodes():
    data = pil_bytes(seeded(9, 17, 0), 'WEBP')
    before = image_formats.WEBP_DECODES
    image_io.decode(data)
    assert image_formats.WEBP_DECODES == before + 1


# ------------------------------------------------------------------- GIF

def gif_lzw(indices: np.ndarray, min_size: int) -> bytes:
    """GIF image data of ``indices``, every code a literal: a clear code
    before the table would widen, so every code has the root width + 1."""
    clear = 1 << min_size
    width = min_size + 1
    codes = []
    for k, value in enumerate(indices.reshape(-1)):
        if k % (clear - 2) == 0:
            codes.append(clear)
        codes.append(int(value))
    codes.append(clear + 1)
    bits = ''.join(format(c, f'0{width}b')[::-1] for c in codes)
    bits += '0' * (-len(bits) % 8)
    raw = bytes(int(bits[i:i + 8][::-1], 2) for i in range(0, len(bits), 8))
    blocks = b''.join(bytes([len(raw[i:i + 255])]) + raw[i:i + 255]
                      for i in range(0, len(raw), 255))
    return bytes([min_size]) + blocks + b'\x00'


def gif_file(indices, screen, global_table=None, local_table=None,
             offset=(0, 0), interlace=False, transparency=None,
             min_size=None) -> bytes:
    """A one-frame GIF of (h, w) ``indices`` at ``offset`` on a ``screen``
    (w, h), tables (N, 3) with N a power of two."""
    h, w = indices.shape

    def table_bits(table):
        return int(np.log2(len(table))) - 1
    flags = 0x80 | 0x70 | table_bits(global_table) if global_table is not \
        None else 0
    out = b'GIF89a' + struct.pack('<HHBBB', *screen, flags, 0, 0)
    if global_table is not None:
        out += np.asarray(global_table, np.uint8).tobytes()
    if transparency is not None:
        out += b'\x21\xf9\x04\x01\x00\x00' + bytes([transparency]) + b'\x00'
    fflags = (0x40 if interlace else 0) | (
        0x80 | table_bits(local_table) if local_table is not None else 0)
    out += b'\x2c' + struct.pack('<HHHHB', *offset, w, h, fflags)
    if local_table is not None:
        out += np.asarray(local_table, np.uint8).tobytes()
    if interlace:
        rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                               np.arange(2, h, 4), np.arange(1, h, 2)])
        indices = indices[rows]
    return out + gif_lzw(indices, min_size or 8) + b'\x3b'


PALETTE = np.random.default_rng(5).integers(0, 256, (16, 3), np.uint8)


@pytest.mark.parametrize('mode', ['P', 'L', 'RGB', '1'])
def test_gif_from_pil(mode):
    for i, (h, w) in enumerate(SIZES[1:] + ((40, 50),)):
        image = seeded(h, w, i)
        if mode == 'P':
            im = PIL.Image.fromarray(image).quantize(7)
        else:
            im = PIL.Image.fromarray(image).convert(mode)
        assert_as_pil(pil_bytes(im, 'GIF'))
        if mode == 'P':
            assert_as_pil(pil_bytes(im, 'GIF', transparency=3))
            assert_as_pil(pil_bytes(im, 'GIF', interlace=False))


def test_gif_written_here():
    rng = np.random.default_rng(0)
    indices = rng.integers(0, 16, (21, 13), np.uint8)
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    cases = {
        'global': gif_file(indices, (13, 21), PALETTE),
        'interlaced': gif_file(indices, (13, 21), PALETTE, interlace=True),
        'local table': gif_file(indices, (13, 21), PALETTE,
                                local_table=PALETTE[::-1]),
        'local table only': gif_file(indices, (13, 21),
                                     local_table=PALETTE),
        'transparent': gif_file(indices, (13, 21), PALETTE, transparency=5),
        'smaller frame': gif_file(indices, (30, 40), PALETTE,
                                  offset=(4, 7)),
        'smaller transparent': gif_file(indices, (30, 40), PALETTE,
                                        offset=(4, 7), transparency=9),
        'overflowing frame': gif_file(indices, (10, 10), PALETTE,
                                      offset=(3, 2)),
        'grey ramp': gif_file(indices, (13, 21), ramp),
        'grey ramp transparent': gif_file(indices, (30, 40), ramp,
                                          offset=(1, 1), transparency=4),
        'no table': gif_file(indices, (13, 21)),
        'past the table': gif_file(indices, (13, 21), PALETTE[:4]),
        'code size 4': gif_file(indices, (13, 21), PALETTE, min_size=4),
    }
    for name, data in cases.items():
        try:
            assert_as_pil(data)
        except AssertionError as e:
            raise AssertionError(name) from e


# ------------------------------------------------------------------ TIFF

# predictor 2 is defined for 8-bit samples, not for 1-bit ones
TIFF_CASES = [(mode, compression, predictor)
              for mode in ('RGB', 'RGBA', 'L', 'P', '1')
              for compression, predictor in (
                  (None, 1), ('packbits', 1), ('tiff_lzw', 1),
                  ('tiff_lzw', 2), ('tiff_adobe_deflate', 1),
                  ('tiff_adobe_deflate', 2), ('tiff_deflate', 1))
              if not (mode == '1' and predictor == 2)]


@pytest.mark.parametrize('mode,compression,predictor', TIFF_CASES)
def test_tiff_from_pil(mode, compression, predictor):
    tiffinfo = {317: predictor} if predictor != 1 else {}
    for i, (h, w) in enumerate(SIZES):
        im = PIL.Image.fromarray(seeded(h, w, i))
        im = im.quantize(11) if mode == 'P' else im.convert(mode)
        data = pil_bytes(im, 'TIFF', compression=compression,
                         tiffinfo=tiffinfo)
        assert_as_pil(data)
    # several strips
    im = PIL.Image.fromarray(seeded(61, 97, 1)).convert(
        mode if mode != 'P' else 'RGB')
    assert_as_pil(pil_bytes(im, 'TIFF', compression=compression,
                            tiffinfo=tiffinfo, strip_size=1000))


def tiff_file(samples, photometric, compression=1, tile=None, extra=(),
              predictor=1, colormap=None, order='<') -> bytes:
    """A TIFF of (h, w, spp) uint8 ``samples`` (or (h, w) bits for
    ``photometric`` 0/1 with ``bits`` 1 when bool), in strips of 5 rows or
    ``tile`` (w, h) tiles, uncompressed or Deflate."""
    bilevel = samples.dtype == bool
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, spp = samples.shape
    tw, th = tile or (w, 5)
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw if tile else w):
            block = np.zeros((th, tw, spp), samples.dtype)
            part = samples[y:y + th, x:x + tw]
            block[:part.shape[0], :part.shape[1]] = part
            if not tile:
                block = block[:part.shape[0]]
            if bilevel:
                raw = np.packbits(block[:, :, 0], axis=1).tobytes()
            else:
                if predictor == 2:
                    block = np.diff(block, axis=1, prepend=0).astype(np.uint8)
                raw = block.tobytes()
            chunks.append(zlib.compress(raw) if compression == 8 else raw)
    bits = (1,) if bilevel else (8,) * spp
    entries = [(256, 4, (w,)), (257, 4, (h,)), (258, 3, bits),
               (259, 3, (compression,)), (262, 3, (photometric,)),
               (277, 3, (spp,)), (284, 3, (1,)), (317, 3, (predictor,))]
    if tile:
        entries += [(322, 3, (tw,)), (323, 3, (th,)),
                    (324, 4, None), (325, 4, tuple(map(len, chunks)))]
    else:
        entries += [(273, 4, None), (278, 3, (th,)),
                    (279, 4, tuple(map(len, chunks)))]
    if extra:
        entries.append((338, 3, tuple(extra)))
    if colormap is not None:
        entries.append((320, 3, tuple(int(v) for v in colormap)))
    entries.sort()
    head = 8
    ifd_size = 2 + 12 * len(entries) + 4
    data_at = head + ifd_size
    payload = b''
    offsets = []
    for c in chunks:
        offsets.append(data_at + len(payload))
        payload += c
    extra_at = data_at + len(payload)
    ifd, blobs = struct.pack(order + 'H', len(entries)), b''
    for tag, kind, values in entries:
        if values is None:
            values = tuple(offsets)
        code = 'H' if kind == 3 else 'I'
        body = struct.pack(order + code * len(values), *values)
        if len(body) <= 4:
            ifd += struct.pack(order + 'HHI', tag, kind, len(values)) + \
                body.ljust(4, b'\0')
        else:
            ifd += struct.pack(order + 'HHII', tag, kind, len(values),
                               extra_at + len(blobs))
            blobs += body
    ifd += b'\0\0\0\0'
    magic = b'II*\x00' if order == '<' else b'MM\x00*'
    return magic + struct.pack(order + 'I', head) + ifd + payload + blobs


def test_tiff_written_here():
    rgb = seeded(23, 37, 3)
    alpha = (np.arange(23 * 37).reshape(23, 37) * 11 % 256).astype(np.uint8)
    grey = rgb[:, :, 0]
    bilevel = grey > 128
    colours = np.random.default_rng(1).integers(0, 65536, (3, 256))
    cases = {
        'tiles': tiff_file(rgb, 2, tile=(16, 16)),
        'tiles deflate predictor': tiff_file(rgb, 2, 8, (16, 16),
                                             predictor=2),
        'big-endian strips': tiff_file(rgb, 2, order='>'),
        'white is zero': tiff_file(grey, 0),
        'white is zero bilevel': tiff_file(bilevel, 0),
        'bilevel tiles': tiff_file(bilevel, 1, tile=(16, 16)),
        'unassociated alpha': tiff_file(np.dstack([rgb, alpha]), 2,
                                        extra=(2,)),
        'associated alpha': tiff_file(np.dstack([rgb, alpha]), 2,
                                      extra=(1,)),
        'unspecified extra': tiff_file(np.dstack([rgb, alpha]), 2,
                                       extra=(0,)),
        'palette': tiff_file(grey, 3, colormap=colours.reshape(-1)),
        'grey with alpha': tiff_file(np.dstack([grey, alpha]), 1,
                                     extra=(2,)),
    }
    for name, data in cases.items():
        try:
            assert_as_pil(data)
        except AssertionError as e:
            raise AssertionError(name) from e


@pytest.mark.parametrize('kind,match', [
    ('jpeg', 'JPEG-in-TIFF'), ('group4', 'CCITT Group 4'),
    ('float', 'float samples'), ('16-bit', '16-bit samples'),
    ('planar', 'planar configuration 2'), ('bigtiff', 'BigTIFF')])
def test_tiff_refusals(kind, match):
    """What the port once refused (``match`` names it) it now reads as PIL
    does."""
    del match
    image = seeded(17, 9, 0)
    if kind == 'jpeg':
        data = pil_bytes(image, 'TIFF', compression='jpeg')
    elif kind == 'group4':
        data = pil_bytes(image, 'TIFF', mode='1', compression='group4')
    elif kind == 'float':
        data = pil_bytes(image, 'TIFF', mode='F')
    elif kind == '16-bit':
        data = pil_bytes(PIL.Image.fromarray(
            image[:, :, 0].astype(np.uint16) * 200), 'TIFF')
    elif kind == 'planar':   # too few strips for three planes: PIL reads
        data = tiff_file(image, 2).replace(   # what there is, as the port
            struct.pack('<HHIHH', 284, 3, 1, 1, 0),
            struct.pack('<HHIHH', 284, 3, 1, 2, 0))
    else:
        data = pil_bytes(image, 'TIFF', big_tiff=True)
    assert_as_pil(data)


# ------------------------------------------------------------------- PNM

def plain_pnm(kind: int, values: np.ndarray, maxval=None) -> bytes:
    h, w = values.shape[:2]
    head = f'P{kind}\n# a comment\n{w} {h}\n'
    if maxval is not None:
        head += f'{maxval}  # maxval\n'
    rows = [' '.join(str(int(v)) for v in row.reshape(-1))
            for row in values]
    return (head + '\n'.join(rows) + '\n').encode()


def binary_pnm(kind: int, values: np.ndarray, maxval: int) -> bytes:
    h, w = values.shape[:2]
    dtype = '>u2' if maxval > 255 else np.uint8
    return (f'P{kind}\n# comment\n{w} {h}\n{maxval}\n'.encode()
            + values.astype(dtype).tobytes())


@pytest.mark.parametrize('maxval', [15, 255, 65535])
@pytest.mark.parametrize('kind', [2, 3, 5, 6])
def test_pnm_grey_and_colour(kind, maxval):
    rng = np.random.default_rng(kind)
    shape = (13, 9, 3) if kind in (3, 6) else (13, 9)
    values = rng.integers(0, maxval + 1, shape)
    values.reshape(-1)[:3] = (0, maxval, maxval // 2)
    if kind in (2, 3):
        data = plain_pnm(kind, values, maxval)
    else:
        data = binary_pnm(kind, values, maxval)
    assert_as_pil(data)


def test_pnm_comments_in_the_data():
    values = np.random.default_rng(1).integers(0, 16, (5, 7, 3))
    data = plain_pnm(3, values, 15).replace(b'\n', b' # note\n', 3)
    assert data.count(b'#') > 2
    assert_as_pil(data)


def test_pnm_bilevel_and_pil_files():
    bits = np.random.default_rng(0).integers(0, 2, (11, 13))
    assert_as_pil(plain_pnm(1, bits))
    assert_as_pil(b'P1\n3 2\n010\n110\n')   # no whitespace between tokens
    assert_as_pil(b'P4\n13 11\n' + np.packbits(bits, axis=1).tobytes())
    image = seeded(11, 13, 0)
    for mode in ('1', 'L', 'RGB', 'I;16'):
        im = PIL.Image.fromarray(image).convert(
            mode if mode != 'I;16' else 'L')
        if mode == 'I;16':
            im = PIL.Image.fromarray(image[:, :, 0].astype(np.uint16) * 257)
        assert_as_pil(pil_bytes(im, 'PPM'))


# ------------------------------------------------------------------- BMP

def palette_bmp(indices, bpp, table, compression=0, rle=None,
                top_down=False, colours=None) -> bytes:
    """A palette BMP (1, 4 or 8 bits) of (h, w) ``indices``, or of RLE
    bytes ``rle``."""
    h, w = indices.shape
    table = np.asarray(table, np.uint8)
    pal = np.concatenate([table[:, ::-1], np.zeros((len(table), 1),
                                                   np.uint8)], 1).tobytes()
    if rle is None:
        stride = (w * bpp + 31) // 32 * 4
        rows = indices if top_down else indices[::-1]
        if bpp < 8:
            per = 8 // bpp
            padded = np.zeros((h, -(-w // per) * per), np.uint8)
            padded[:, :w] = rows
            shifts = np.arange(8 - bpp, -1, -bpp)
            packed = (padded.reshape(h, -1, per) << shifts).sum(2).astype(
                np.uint8)
        else:
            packed = rows.astype(np.uint8)
        data = b''.join(r.tobytes().ljust(stride, b'\0') for r in packed)
    else:
        data = rle
    info = struct.pack('<IiiHHIIiiII', 40, w, -h if top_down else h, 1, bpp,
                       compression, len(data), 2835, 2835,
                       colours or len(table), 0)
    offset = 14 + 40 + len(pal)
    return (b'BM' + struct.pack('<IHHI', offset + len(data), 0, 0, offset)
            + info + pal + data)


@pytest.mark.parametrize('top_down', [False, True])
@pytest.mark.parametrize('bpp', [1, 4, 8])
def test_bmp_palettes(bpp, top_down):
    rng = np.random.default_rng(bpp)
    n = 1 << bpp
    indices = rng.integers(0, n, (11, 13), np.uint8)
    table = rng.integers(0, 256, (n, 3), np.uint8)
    assert_as_pil(palette_bmp(indices, bpp, table, top_down=top_down))
    # a short table: indices past it
    assert_as_pil(palette_bmp(indices, bpp, table[:max(1, n // 2)],
                              top_down=top_down))
    if bpp == 1:
        bw = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
        assert_as_pil(palette_bmp(indices, 1, bw, top_down=top_down))
        assert_as_pil(pil_bytes(seeded(11, 13, 0), 'BMP', mode='1'))


@pytest.mark.parametrize('bpp', [8, 24])
def test_bmp_os2_header(bpp):
    """The 12-byte OS/2 header: 16-bit sizes, 3-byte palette entries."""
    rng = np.random.default_rng(bpp)
    h, w = 7, 9
    if bpp == 8:
        table = rng.integers(0, 256, (256, 3), np.uint8)[:, ::-1].tobytes()
        rows = rng.integers(0, 256, (h, w), np.uint8)
    else:
        table = b''
        rows = rng.integers(0, 256, (h, w * 3), np.uint8)
    stride = (w * bpp + 31) // 32 * 4
    pixels = b''.join(r.tobytes().ljust(stride, b'\0') for r in rows)
    info = struct.pack('<IHHHH', 12, w, h, 1, bpp)
    offset = 14 + 12 + len(table)
    data = (b'BM' + struct.pack('<IHHI', offset + len(pixels), 0, 0, offset)
            + info + table + pixels)
    assert_as_pil(data)


@pytest.mark.parametrize('layout', ['555', '555 bitfields', '565 bitfields'])
def test_bmp_16_bits(layout):
    pixels = np.random.default_rng(2).integers(0, 65536, (11, 13)).astype(
        '<u2')
    if layout == '555':
        data = bmp_file(pixels.view(np.uint8).reshape(11, 13, 2), 16, 0)
    else:
        masks = (0x7C00, 0x3E0, 0x1F, 0) if layout.startswith('555') else \
            (0xF800, 0x7E0, 0x1F, 0)
        data = bmp_file(pixels.view(np.uint8).reshape(11, 13, 2), 16, 3,
                        masks=masks)
    assert_as_pil(data)


def rle8(rows, delta=False):
    """RLE8 of rows (bottom row first), runs and absolute runs mixed, an
    end of line per row; ``delta`` adds a delta escape."""
    out = bytearray()
    for r, row in enumerate(rows):
        row = list(row)
        out += bytes([3, row[0]])          # a run of 3
        absolute = row[3:8]
        out += bytes([0, len(absolute)]) + bytes(absolute)
        out += b'\0' * (len(absolute) % 2)
        out += bytes([1, row[8]])
        if delta and r == 1:
            out += bytes([0, 2, 2, 0, 3, 1])
        out += b'\x00\x00'
    return bytes(out + b'\x00\x01')


def rle4(rows):
    out = bytearray()
    for row in rows:
        out += bytes([4, (row[0] << 4) | row[1]])
        out += bytes([0, 5]) + bytes([(row[4] << 4) | row[5],
                                      (row[6] << 4) | row[7], row[8] << 4])
        out += b'\0'
        out += bytes([3, (row[9] << 4) | row[10]])
        out += b'\x00\x00'
    return bytes(out + b'\x00\x01')


@pytest.mark.parametrize('case', ['rle8', 'rle8 delta', 'rle8 top-down',
                                  'rle8 grey', 'rle4', 'rle4 short'])
def test_bmp_rle(case):
    rng = np.random.default_rng(3)
    w, h = 12, 6
    rows = rng.integers(0, 16, (h, w), np.uint8)
    table = rng.integers(0, 256, (16, 3), np.uint8)
    if case.startswith('rle8'):
        table = rng.integers(0, 256, (256, 3), np.uint8)
        if case == 'rle8 grey':
            table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        data = palette_bmp(rows, 8, table, 1, rle8(rows, 'delta' in case),
                           top_down='top-down' in case)
    else:
        data = palette_bmp(rows, 4, table, 2, rle4(rows),
                           colours=8 if 'short' in case else None)
    assert_as_pil(data)


@pytest.mark.parametrize('kind,match', [
    (4, 'embedded JPEG'), (5, 'embedded PNG'), ('masks', 'masks'),
    ('grey ramp', 'grey ramp')])
def test_bmp_still_refused(kind, match):
    pixels = np.zeros((3, 5, 4), np.uint8)
    if kind == 'grey ramp':   # PIL fails on it as well
        ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
        data = palette_bmp(pixels[:, :, 0], 4, ramp)
        with pytest.raises(OSError):
            pil_rgb(data)
    elif kind == 'masks':
        data = bmp_file(pixels[:, :, :2].copy(), 16, 3,
                        masks=(0xF00, 0xF0, 0xF, 0))
    else:
        data = bmp_file(pixels, 32, kind)
    with pytest.raises(ValueError, match=match):
        image_io.decode(data)


# ---------------------------------------------------------- CMYK JPEG

def test_cmyk_and_ycck_jpeg():
    """Four-component files in both JPEG decoders: CMYK under Adobe's
    transform 0, YCCK under transform 2 (the marker's byte rewritten), CMYK
    with no Adobe marker and progressive CMYK, 4:4:4 and 4:2:0, as PIL
    reads them."""
    for h, w in ((1, 1), (9, 17), (61, 97)):
        cmyk = np.dstack([seeded(h, w, 1), seeded(h, w, 2)[:, :, :1]])
        for sub in (0, 2):
            data = pil_bytes(PIL.Image.frombytes('CMYK', (w, h),
                                                 cmyk.tobytes()),
                             'JPEG', quality=85, subsampling=sub)
            at = data.index(b'Adobe')
            ycck = bytearray(data)
            ycck[at + 11] = 2
            length = int.from_bytes(data[at - 2:at], 'big')
            bare = data[:at - 4] + data[at - 2 + length:]
            progressive = pil_bytes(PIL.Image.frombytes(
                'CMYK', (w, h), cmyk.tobytes()), 'JPEG', quality=85,
                subsampling=sub, progressive=True)
            for variant in (data, bytes(ycck), bare, progressive):
                want = pil_rgb(variant)
                np.testing.assert_array_equal(jpeg.decode(variant), want)
                np.testing.assert_array_equal(jpeg_plain.decode(variant),
                                              want)


# -------------------------------------------------- the format by content

def test_format_by_content(tmp_path):
    image = seeded(17, 23, 4)
    jpg = pil_bytes(image, 'JPEG', quality=80)
    png = pil_bytes(image, 'PNG')
    for data, name in ((jpg, 'x.png'), (png, 'y.jpg'), (jpg, 'noext'),
                       (png, 'z'), (jpg, 'a.jfif'), (jpg, 'b.jpe'),
                       (pil_bytes(image, 'WEBP'), 'c.png'),
                       (pil_bytes(image, 'GIF'), 'd.bmp'),
                       (pil_bytes(image, 'TIFF'), 'e'),
                       (pil_bytes(image, 'PPM'), 'f.jpg'),
                       (pil_bytes(image, 'BMP'), 'g.gif')):
        assert_as_pil(data, tmp_path, name)


@pytest.mark.parametrize('data,match', [
    (b'', 'empty file'),
    (b'\x00\x00\x01\x00' + b'\0' * 20, 'ICO'),
    (b'\x00\x00\x00\x0cjP  \r\n\x87\n' + b'\0' * 20, 'JPEG 2000'),
    (b'\x00\x00\x00\x1cftypavif' + b'\0' * 20, 'AVIF'),
    (b'8BPS' + b'\0' * 30, 'Photoshop'),
    (b'Pf\n1 1\n-1.0\n\0\0\0\0', 'PNM variant'),
    (b'hello, this is text', 'unknown image format'),
    (b'RIFF\x10\x00\x00\x00WEBPVP8 \x04\x00\x00\x00abcd', 'WebP lossy'),
    (b'GIF89a\x01\x00\x01\x00\x00\x00\x00;', 'no image'),
    (b'GIF89a\x02\x00\x02\x00\x00\x00\x00,\x00\x00\x00\x00\x02\x00'
     b'\x02\x00\x00\x08\x02\x00\x01\x00;', 'truncated'),
])
def test_refusals_name_the_format(data, match, tmp_path):
    path = tmp_path / 'x.png'
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        image_io.read_image(str(path))


def test_webp_truncated_and_non_key_frame():
    data = pil_bytes(seeded(33, 47, 0), 'WEBP', quality=80)
    with pytest.raises(ValueError, match='truncated'):
        image_io.decode(data[:len(data) // 2])
    inter = bytearray(data)
    inter[20] |= 1   # the frame tag's key-frame bit
    with pytest.raises(ValueError, match='not a key frame'):
        image_io.decode(bytes(inter))
    lossless = bytearray(pil_bytes(seeded(33, 47, 0), 'WEBP',
                                   lossless=True))
    lossless[24] |= 0xE0  # VP8L version bits
    with pytest.raises(ValueError, match='version'):
        image_io.decode(bytes(lossless))


@pytest.mark.parametrize('name', chip_smoke.IMAGE_SAMPLES)
def test_chip_samples_hash_as_pil(name):
    """``chip_smoke.py`` carries small files and the hash of PIL's decode
    of each: both hold here, so the card's machine (no PIL) can hold the
    port to PIL by the hash alone."""
    h, w, sha, text = chip_smoke.IMAGE_SAMPLES[name]
    data = base64.b64decode(text)
    for image in (pil_rgb(data), image_io.decode(data)):
        assert image.shape == (h, w, 3)
        assert hashlib.sha256(image.tobytes()).hexdigest() == sha


# ------------------------------------------------- datasets, video, predict

def mixed_tree(root) -> list:
    """Files of every format read, some under a wrong suffix: (name, bytes)."""
    items = []
    for i, (fmt, name, kw) in enumerate((
            ('WEBP', 'a.webp', dict(quality=80)),
            ('WEBP', 'b.webp', dict(lossless=True)),
            ('GIF', 'c.gif', {}), ('TIFF', 'd.tif', dict(compression='tiff_lzw')),
            ('PPM', 'e.ppm', {}), ('JPEG', 'f.png', dict(quality=90)),
            ('PNG', 'g.jpg', {}), ('BMP', 'h', {}))):
        data = pil_bytes(seeded(29 + 4 * i, 37 - 2 * i, i), fmt, **kw)
        (root / name).write_bytes(data)
        items.append((name, data))
    return items


def test_image_list_and_coco_dataset_as_jax(tmp_path):
    items = mixed_tree(tmp_path)
    paths = [str(tmp_path / name) for name, _ in items]
    want = JaxImageList(paths, lambda image, anns, meta: (image, anns, meta))
    got = ImageList(paths, lambda image, anns, meta: (image, anns, meta))
    for index, path in enumerate(paths):
        w, _, wmeta = want[index]
        g, _, gmeta = got[index]
        np.testing.assert_array_equal(g.permute(1, 2, 0).numpy(),
                                      np.asarray(w, np.float32))
        assert gmeta['file_name'] == wmeta['file_name'] == path
    annotations = tmp_path / 'ann.json'
    annotations.write_text(json.dumps({
        'images': [{'id': i + 1, 'file_name': name,
                    'height': 1, 'width': 1}
                   for i, (name, _) in enumerate(items)],
        'annotations': [{'id': i + 1, 'image_id': i + 1, 'category_id': 1,
                         'iscrowd': 0, 'bbox': [1, 1, 5, 5], 'area': 25,
                         'num_keypoints': 1,
                         'keypoints': [3, 3, 2] + [0, 0, 0] * 16}
                        for i in range(len(items))],
        'categories': [{'id': 1, 'name': 'person'}]}))
    want = JaxCocoDataset(str(tmp_path), str(annotations))
    got = CocoDataset(str(tmp_path), str(annotations))
    assert got.ids == want.ids and len(got) == len(items)
    for index in range(len(items)):
        w_image, w_anns, w_meta = want[index]
        g_image, g_anns, g_meta = got[index]
        np.testing.assert_array_equal(g_image.permute(1, 2, 0).numpy(),
                                      np.asarray(w_image, np.float32))
        assert g_anns == w_anns and g_meta == w_meta


def test_frame_readers_skip_other_formats(tmp_path):
    """Both packages admit only .jpg, .jpeg, .png and .bmp frames: the
    .webp, .gif and .tif files in the folder are skipped by both."""
    for i in range(3):
        image = seeded(15, 21, i)
        (tmp_path / f'{i:02d}.png').write_bytes(pil_bytes(image, 'PNG'))
        (tmp_path / f'{i:02d}a.webp').write_bytes(pil_bytes(image, 'WEBP'))
        (tmp_path / f'{i:02d}b.gif').write_bytes(pil_bytes(image, 'GIF'))
        (tmp_path / f'{i:02d}c.tif').write_bytes(pil_bytes(image, 'TIFF'))
    (tmp_path / '03.bmp').write_bytes(pil_bytes(seeded(15, 21, 3), 'BMP'))
    (tmp_path / '04.JPG').write_bytes(pil_bytes(seeded(15, 21, 4), 'JPEG'))
    want = list(jax_video.FrameReader(str(tmp_path)))
    got = list(video.FrameReader(str(tmp_path)))
    assert [p for _, p, _ in got] == [p for _, p, _ in want]
    assert [os.path.basename(p) for _, p, _ in got] == [
        '00.png', '01.png', '02.png', '03.bmp', '04.JPG']
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert video.FRAME_SUFFIXES == ('.jpg', '.jpeg', '.png', '.bmp')


def test_predict_cli_same_json_as_png_twin(tmp_path, monkeypatch):
    """The port's predict CLI on the CPU (one thread): a WebP, a GIF, a
    TIFF and a PNM file give the JSON of their PNG twins (written from
    the decoded arrays), so the file's format changes nothing past the
    reader."""
    torch.manual_seed(0)
    metas = coco_metas()
    for meta in metas:
        meta.base_stride = 16
    shell = port_models.Shell(port_models.ShuffleNetV2K(*NARROW),
                              [port_models.CompositeField4(m, 64)
                               for m in metas])
    with torch.no_grad():
        for head, meta in zip(shell.head_nets, metas):
            bias = head.conv.bias.view(meta.n_fields, meta.n_components)
            bias[:, 0] = 2.0
            bias[:, meta.n_components - meta.n_scales:] = 3.0
    model_path = str(tmp_path / 'model.npz')
    checkpoint.save(model_path, variables=port_models.to_jax_variables(
        shell.state_dict()), head_metas=metas, basenet_name=NARROW_NAME,
        base_stride=16)
    images = tmp_path / 'images'
    images.mkdir()
    sources = {'a.webp': pil_bytes(seeded(49, 65, 0), 'WEBP', quality=75),
               'b.gif': pil_bytes(seeded(65, 49, 1), 'GIF'),
               'c.tif': pil_bytes(seeded(49, 65, 2), 'TIFF',
                                  compression='tiff_adobe_deflate'),
               'd': pil_bytes(seeded(49, 65, 3), 'PPM')}
    paths = []
    for name, data in sources.items():
        (images / name).write_bytes(data)
        twin = str(images / f'{name}.twin.png')
        image_io.write_png(twin, image_io.decode(data))
        paths += [str(images / name), twin]
    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_NAME,
                        narrow_spec(base, shufflenetv2k))
    keep_configuration(monkeypatch, Predictor, decoder.Decoder,
                       debug_checks, *decoder.DECODERS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path / 'out'
    out.mkdir()
    try:
        assert port_predict.main([*paths, f'--checkpoint={model_path}',
                                  '--device=cpu', '--no-bf16',
                                  '--long-edge=65', '-q',
                                  f'--json-output={out}']) == 0
    finally:
        torch.set_num_threads(threads)
    for name in sources:
        with open(out / f'{name}.predictions.json') as f:
            got = json.load(f)
        with open(out / f'{name}.twin.png.predictions.json') as f:
            want = json.load(f)
        assert got == want and len(got) > 0
