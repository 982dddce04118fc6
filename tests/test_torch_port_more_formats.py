"""The rest of what PIL reads, through the port's ``image_io.read_image``,
against PIL's ``np.asarray(Image.open(path).convert('RGB'))`` (the JAX
package's read path) with max|delta| 0.

- TIFF written by PIL: JPEG-in-TIFF (RGB and greyscale, strips and
  tiles), CCITT Modified Huffman, Group 3 (one- and two-dimensional, with
  fill bits) and Group 4, float, 16-bit and 32-bit samples, BigTIFF; and
  written here: planar configuration 2, 2-, 4-, 12-, 16- and 32-bit
  samples, signed and float samples with predictors 2 and 3, YCbCr with
  subsampling, CMYK at 8 and 16 bits, fill order 2, old-style LZW,
  old-style JPEG and palettes at 2 and 4 bits.
- JPEG 2000 written by PIL (openjpeg): reversible 5/3 and irreversible
  9/7, JP2 and raw codestreams, tiles, quality layers, the five
  progression orders, code-block and precinct sizes, greyscale, and
  components subsampled here by splicing codestreams.
- ICO (PNG and BMP payloads), CUR, TGA, QOI, PSD, SGI and PCX.
- ``ImageList`` and ``CocoDataset`` of both packages on a tree of the
  new formats.
"""

import io
import json
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from openpifpaf_tpu.datasets.loader import ImageList as JaxImageList
from openpifpaf_tpu.plugins.coco.dataset import CocoDataset as JaxCocoDataset
from openpifpaf_tpu_torch import image_io, jpeg
from openpifpaf_tpu_torch.datasets.image_list import ImageList
from openpifpaf_tpu_torch.plugins.coco.dataset import CocoDataset

import chip_smoke

from test_torch_port_image_formats import assert_as_pil, pil_bytes, seeded

TIFF_CODES = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 8: 'h',
              9: 'i', 11: 'f', 12: 'd', 16: 'Q'}


def tiff_bytes(width, height, chunks, tags, order='<', tiles=None,
               big=False) -> bytes:
    """A one-page TIFF (or BigTIFF) of ``chunks`` (the strips, or with
    ``tiles`` = (w, h) the tiles, each already compressed) and ``tags``
    [(tag, type, values)]; offsets and counts are filled in."""
    offset_tag, count_tag = (324, 325) if tiles else (273, 279)
    long_type = 16 if big else 4
    entries = list(tags) + [(256, 4, (width,)), (257, 4, (height,)),
                            (offset_tag, long_type, None),
                            (count_tag, long_type, tuple(map(len, chunks)))]
    if tiles:
        entries += [(322, 3, (tiles[0],)), (323, 3, (tiles[1],))]
    entries.sort(key=lambda e: e[0])
    entry_size, slot = (20, 8) if big else (12, 4)
    head = 16 if big else 8
    data_at = head + (8 if big else 2) + entry_size * len(entries) + slot
    offsets, payload = [], b''
    for chunk in chunks:
        offsets.append(data_at + len(payload))
        payload += chunk
    blobs_at = data_at + len(payload)
    ifd, blobs = struct.pack(order + ('Q' if big else 'H'), len(entries)), b''
    for tag, kind, values in entries:
        values = tuple(offsets) if values is None else values
        code = 'I' if kind == 5 else TIFF_CODES[kind]
        body = struct.pack(order + code * len(values), *values)
        n = len(values) // 2 if kind == 5 else len(values)
        count = struct.pack(order + ('Q' if big else 'I'), n)
        if len(body) <= slot:
            ifd += struct.pack(order + 'HH', tag, kind) + count + body.ljust(
                slot, b'\0')
        else:
            ifd += struct.pack(order + 'HH', tag, kind) + count + struct.pack(
                order + ('Q' if big else 'I'), blobs_at + len(blobs))
            blobs += body + b'\0' * (len(body) % 2)
    ifd += b'\0' * slot
    magic = b'II' if order == '<' else b'MM'
    header = magic + (struct.pack(order + 'HHHQ', 43, 8, 0, 16) if big
                      else struct.pack(order + 'HI', 42, 8))
    return header + ifd + payload + blobs


def planar_tiff(image, rows=5, compression=1) -> bytes:
    """(h, w, c) uint8 as planar configuration 2, strips of ``rows``."""
    h, w, c = image.shape
    chunks = []
    for plane in range(c):
        for y in range(0, h, rows):
            raw = image[y:y + rows, :, plane].tobytes()
            chunks.append(zlib.compress(raw) if compression == 8 else raw)
    return tiff_bytes(w, h, chunks, [
        (258, 3, (8,) * c), (259, 3, (compression,)),
        (262, 3, (2 if c >= 3 else 1,)), (277, 3, (c,)), (278, 3, (rows,)),
        (284, 3, (2,))] + ([(338, 3, (2,))] if c in (2, 4) else []))


def strips(samples: np.ndarray, rows: int, pack=None, compress=None):
    """(h, w, spp) samples -> strips of ``rows`` rows (``pack`` turns each
    into bytes, ``compress`` compresses them)."""
    out = []
    for y in range(0, samples.shape[0], rows):
        raw = pack(samples[y:y + rows]) if pack else samples[
            y:y + rows].tobytes()
        out.append(compress(raw) if compress else raw)
    return out


def pack_bits(values: np.ndarray, depth: int) -> bytes:
    """(rows, w, spp) samples of ``depth`` bits, rows padded to bytes."""
    rows = values.reshape(values.shape[0], -1).astype(np.uint64)
    n = rows.shape[1]
    out = []
    for row in rows:
        bits = ''.join(format(int(v), f'0{depth}b') for v in row)
        bits += '0' * (-len(bits) % 8)
        out.append(int(bits, 2).to_bytes(len(bits) // 8, 'big') if n else b'')
    return b''.join(out)


def old_lzw(data: bytes) -> bytes:
    """libtiff's pre-6.0 LZW: GIF's codes (least significant bit first)
    with 8-bit roots, a clear code first and the end code last."""
    table = {bytes([i]): i for i in range(256)}
    codes, width, next_code, word = [256], 9, 258, b''
    widths = [9]
    for byte in data:
        candidate = word + bytes([byte])
        if candidate in table:
            word = candidate
            continue
        codes.append(table[word])
        widths.append(width)
        if next_code < 4094:
            table[candidate] = next_code
            next_code += 1
            if next_code >= 1 << width and width < 12:
                width += 1
        word = bytes([byte])
    codes += [table[word], 257]
    widths += [width, width]
    acc = nbits = 0
    out = bytearray()
    for code, w in zip(codes, widths[1:] + [width]):
        acc |= code << nbits
        nbits += w
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


# ------------------------------------------------------------------ TIFF

@pytest.mark.parametrize('mode', ['RGB', 'L'])
@pytest.mark.parametrize('tile', [None, (16, 16)])
@pytest.mark.parametrize('quality', [50, 95])
def test_tiff_jpeg(mode, tile, quality):
    """JPEG-in-TIFF as PIL writes it: each strip or tile a datastream
    behind the JPEGTables; RGB stored without colour transform."""
    image = seeded(45, 37, 1)
    kw = dict(compression='jpeg', quality=quality)
    if tile:
        kw.update(tile=tile)
    assert_as_pil(pil_bytes(image, 'TIFF', mode=mode, **kw))


def test_tiff_jpeg_ycbcr_and_strips():
    """Photometric YCbCr JPEG strips at 4:2:0 (libtiff's JPEGCOLORMODE_RGB:
    upsampled and converted per strip), written here from the port's own
    JPEG encoder, eight rows a strip."""
    image = seeded(21, 30, 2)
    chunks = [jpeg.encode(image[y:y + 8], 85) for y in range(0, 21, 8)]
    data = tiff_bytes(30, 21, chunks, [
        (258, 3, (8, 8, 8)), (259, 3, (7,)), (262, 3, (6,)),
        (277, 3, (3,)), (278, 3, (8,)), (530, 3, (2, 2))])
    assert_as_pil(data)


@pytest.mark.parametrize('compression,options', [
    ('tiff_ccitt', None), ('group3', None), ('group3', 1), ('group3', 5),
    ('group4', None)])
@pytest.mark.parametrize('size', [(37, 29), (12, 2700)])
def test_tiff_ccitt(compression, options, size):
    """Modified Huffman, T.4 (1D, 2D, with fill bits) and T.6 written by
    PIL's libtiff, on noise beside stripes of every run length; 2700
    pixels wide reaches the extended make-up codes."""
    h, w = size
    rng = np.random.default_rng(w)
    image = rng.random((h, w)) < 0.5
    image[:, w // 3:] = (np.arange(w - w // 3)[None]
                         // (1 + np.arange(h)[:, None] * 7)) % 2 == 0
    kw = dict(compression=compression)
    if options is not None:
        kw.update(tiffinfo={292: options})
    data = pil_bytes(PIL.Image.fromarray(image.astype(np.uint8) * 255
                                         ).convert('1'), 'TIFF', **kw)
    assert_as_pil(data)


def test_tiff_ccitt_fill_order_and_white_is_zero():
    image = np.random.default_rng(3).random((9, 40)) < 0.3
    data = pil_bytes(PIL.Image.fromarray(image.astype(np.uint8) * 255
                                         ).convert('1'), 'TIFF',
                     compression='group4')
    with PIL.Image.open(io.BytesIO(data)) as im:
        offset, count = im.tag_v2[273][0], im.tag_v2[279][0]
    raw = data[offset:offset + count]
    for photometric in (0, 1):
        for fill in (1, 2):
            body = raw if fill == 1 else bytes(
                int(f'{b:08b}'[::-1], 2) for b in raw)
            assert_as_pil(tiff_bytes(40, 9, [body], [
                (258, 3, (1,)), (259, 3, (4,)), (262, 3, (photometric,)),
                (266, 3, (fill,)), (278, 3, (9,))]))


@pytest.mark.parametrize('mode', ['F', 'I;16', 'I', 'CMYK', 'LA', 'PA',
                                  'I;16B'])
@pytest.mark.parametrize('compression', [None, 'tiff_lzw',
                                         'tiff_adobe_deflate'])
def test_tiff_pil_modes(mode, compression):
    rng = np.random.default_rng(4)
    if mode in ('F', 'I'):
        values = rng.normal(120, 150, (23, 19))
        image = PIL.Image.fromarray(values.astype(
            np.float32 if mode == 'F' else np.int32), mode)
    elif mode.startswith('I;16'):
        image = PIL.Image.fromarray(rng.integers(0, 700, (23, 19)).astype(
            np.uint16)).convert(mode) if mode == 'I;16' else \
            PIL.Image.frombytes(mode, (19, 23), rng.integers(
                0, 400, (23, 19)).astype('>u2').tobytes())
    else:
        image = PIL.Image.fromarray(seeded(23, 19, 5)).convert(mode)
    kw = {'compression': compression} if compression else {}
    assert_as_pil(pil_bytes(image, 'TIFF', **kw))


@pytest.mark.parametrize('order', ['<', '>'])
@pytest.mark.parametrize('compression', [1, 8])
def test_tiff_wide_and_signed_samples(order, compression):
    """16- and 32-bit, signed and float samples with predictors 2 and 3
    (libtiff's horAcc and fpAcc), 12-bit samples, both byte orders."""
    rng = np.random.default_rng(6)
    h, w = 11, 13
    compress = zlib.compress if compression == 8 else None
    cases = []
    layouts = ((16, 1), (16, 2), (32, 2), (32, 3)) + (
        ((32, 1),) if order == '<' else ())   # PIL's layouts
    for depth, fmt in layouts:
        kind = {1: 'u', 2: 'i', 3: 'f'}[fmt]
        dtype = np.dtype(f'{kind}{depth // 8}').newbyteorder(order)
        if fmt == 3:
            values = rng.normal(100, 120, (h, w, 1)).astype(dtype)
        else:
            values = rng.integers(-300 if fmt == 2 else 0, 600,
                                  (h, w, 1)).astype(dtype)
        predictors = [1] if compression == 1 else [1, 2] + (
            [3] if fmt == 3 else [])
        for predictor in predictors:
            if predictor == 2:
                wrap = np.dtype(f'u{depth // 8}')
                body = np.diff(values.view(dtype).astype(dtype.newbyteorder(
                    '=')).view(wrap), axis=1, prepend=0).astype(wrap)
                raw_values = body.astype(wrap.newbyteorder(order))
            elif predictor == 3:
                planes = values.astype('>f4').view(np.uint8).reshape(
                    h, w, 4).transpose(0, 2, 1).reshape(h, -1)
                raw_values = np.diff(planes, axis=1, prepend=0).astype(
                    np.uint8)
            else:
                raw_values = values
            cases.append(tiff_bytes(w, h, strips(raw_values, 4,
                                                 compress=compress), [
                (258, 3, (depth,)), (259, 3, (compression,)),
                (262, 3, (1,)), (278, 3, (4,)), (317, 3, (predictor,)),
                (339, 3, (fmt,))], order=order))
    if order == '<':
        twelve = rng.integers(0, 300, (h, w, 1))
        cases.append(tiff_bytes(w, h, strips(
            twelve, 4, lambda s: pack_bits(s, 12), compress), [
            (258, 3, (12,)), (259, 3, (compression,)), (262, 3, (1,)),
            (278, 3, (4,))]))
    for data in cases:
        assert_as_pil(data)


@pytest.mark.parametrize('depth', [2, 4])
@pytest.mark.parametrize('photometric', [0, 1, 3])
def test_tiff_2_and_4_bit(depth, photometric):
    rng = np.random.default_rng(depth + photometric)
    values = rng.integers(0, 1 << depth, (9, 13, 1))
    tags = [(258, 3, (depth,)), (259, 3, (1,)), (262, 3, (photometric,)),
            (278, 3, (4,))]
    if photometric == 3:
        tags.append((320, 3, tuple(int(v) for v in rng.integers(
            0, 65536, 3 << depth))))
    assert_as_pil(tiff_bytes(13, 9, strips(values, 4, lambda s: pack_bits(
        s, depth)), tags))


def test_tiff_ycbcr_subsampled():
    """YCbCr without JPEG: libtiff's RGBA interface (Cb and Cr repeated
    over each unit, its fixed-point conversion), at 1x1, 2x1 and 2x2,
    with the default and a written ReferenceBlackWhite."""
    rng = np.random.default_rng(7)
    h, w = 10, 14
    for sub in ((1, 1), (2, 1), (2, 2), (4, 2)):
        sh, sv = sub
        units = []
        for _ in range(-(-h // sv) * -(-w // sh)):
            units.append(rng.integers(0, 256, sh * sv + 2))
        raw = np.concatenate(units).astype(np.uint8).tobytes()
        for reference in (None, (16, 235, 128, 240, 128, 240)):
            tags = [(258, 3, (8, 8, 8)), (259, 3, (8,)), (262, 3, (6,)),
                    (277, 3, (3,)), (278, 3, (h,)), (530, 3, sub)]
            if reference:
                tags.append((532, 5, tuple(v for r in reference
                                           for v in (r, 1))))
            assert_as_pil(tiff_bytes(w, h, [zlib.compress(raw)], tags))


def test_tiff_planar_cmyk_fill_order_old_lzw():
    rng = np.random.default_rng(8)
    image = seeded(19, 15, 9)
    rgba = np.dstack([image, rng.integers(0, 256, (19, 15), np.uint8)])
    cases = [planar_tiff(image), planar_tiff(image, 7, 8),
             planar_tiff(rgba, 4, 8), planar_tiff(image[:, :, :1], 3)]
    cmyk = rng.integers(0, 256, (19, 15, 4)).astype(np.uint8)
    cases.append(tiff_bytes(15, 19, strips(cmyk, 5), [
        (258, 3, (8,) * 4), (262, 3, (5,)), (277, 3, (4,)), (278, 3, (5,))]))
    cmyk16 = rng.integers(0, 65536, (19, 15, 4)).astype('>u2')
    cases.append(tiff_bytes(15, 19, strips(cmyk16, 5, compress=zlib.compress),
                            [(258, 3, (16,) * 4), (259, 3, (8,)),
                             (262, 3, (5,)), (277, 3, (4,)), (278, 3, (5,))],
                            order='>'))
    rgb16 = rng.integers(0, 65536, (19, 15, 4)).astype('<u2')
    for extra in ((), (0,), (1,), (2,)):
        cases.append(tiff_bytes(15, 19, strips(rgb16, 5), [
            (258, 3, (16,) * 4), (262, 3, (2,)), (277, 3, (4,)),
            (278, 3, (5,))] + ([(338, 3, extra)] if extra else [])))
    reverse = np.array([int(f'{i:08b}'[::-1], 2) for i in range(256)],
                       np.uint8)
    for compression, compress in ((1, None), (8, zlib.compress),
                                  (5, old_lzw)):
        chunks = [reverse[np.frombuffer(c, np.uint8)].tobytes()
                  for c in strips(image, 5, compress=compress)]
        cases.append(tiff_bytes(15, 19, chunks, [
            (258, 3, (8, 8, 8)), (259, 3, (compression,)), (262, 3, (2,)),
            (266, 3, (2,)), (277, 3, (3,)), (278, 3, (5,))]))
    cases.append(tiff_bytes(15, 19, strips(image, 5, compress=old_lzw), [
        (258, 3, (8, 8, 8)), (259, 3, (5,)), (262, 3, (2,)),
        (277, 3, (3,)), (278, 3, (5,))]))
    for data in cases:
        assert_as_pil(data)


@pytest.mark.parametrize('mode', ['RGB', 'L', '1', 'I;16', 'F'])
def test_bigtiff(mode):
    image = PIL.Image.fromarray(seeded(21, 17, 10)).convert(mode)
    assert_as_pil(pil_bytes(image, 'TIFF', big_tiff=True))
    assert_as_pil(pil_bytes(image, 'TIFF', big_tiff=True,
                            compression='tiff_lzw'))


@pytest.mark.parametrize('subsampling', ['4:2:0', '4:2:2', '4:4:4'])
@pytest.mark.parametrize('size', [(32, 48), (37, 45)])
def test_tiff_old_style_jpeg(subsampling, size):
    """Old-style JPEG (compression 6), the stream one strip or where
    JPEGInterchangeFormat points, with the default and a written
    ReferenceBlackWhite: libtiff's raw components and RGBA conversion."""
    h, w = size
    stream = pil_bytes(seeded(h, w, 34), 'JPEG', quality=90,
                       subsampling=subsampling)
    for reference in (None, (16, 235, 128, 240, 128, 240)):
        tags = [(258, 3, (8, 8, 8)), (259, 3, (6,)), (262, 3, (6,)),
                (277, 3, (3,)), (278, 3, (h,)), (530, 3, (2, 2))]
        if reference:
            tags.append((532, 5, tuple(v for r in reference
                                       for v in (r, 1))))
        assert_as_pil(tiff_bytes(w, h, [stream], tags))
        # the interchange format tags add an entry: the strip moves by 24
        probe = tiff_bytes(w, h, [stream], tags + [(513, 4, (0,)),
                                                   (514, 4, (0,))])
        with PIL.Image.open(io.BytesIO(probe)) as im:
            at = im.tag_v2[273][0]
        assert_as_pil(tiff_bytes(w, h, [stream], tags + [
            (513, 4, (at,)), (514, 4, (len(stream),))]))


def test_tiff_refusals_that_stay():
    image = seeded(9, 7, 0)
    for compression, match in ((6, 'old-style JPEG'), (34925, 'LZMA')):
        data = tiff_bytes(7, 9, [image.tobytes()], [
            (258, 3, (8, 8, 8)), (259, 3, (compression,)), (262, 3, (2,)),
            (277, 3, (3,)), (278, 3, (9,))])
        with pytest.raises(ValueError, match=match):
            image_io.decode(data)
    data = tiff_bytes(7, 9, [image.tobytes()], [
        (258, 3, (8, 8, 8)), (262, 3, (6,)), (277, 3, (3,)), (278, 3, (9,))])
    with pytest.raises(ValueError, match='uncompressed YCbCr'):
        image_io.decode(data)
    with pytest.raises(Exception):
        pil_rgb_of(data)


def pil_rgb_of(data):
    with PIL.Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert('RGB'))


# ------------------------------------------------------------ JPEG 2000

def pil_j2k(image, mode=None, **kw) -> bytes:
    return pil_bytes(image, 'JPEG2000', mode=mode, **kw)


@pytest.mark.parametrize('irreversible', [False, True])
@pytest.mark.parametrize('options', [
    {}, dict(no_jp2=True), dict(tile_size=(32, 32)),
    dict(tile_size=(24, 40), tile_offset=(2, 1), offset=(5, 3)),
    dict(quality_mode='rates', quality_layers=[40, 10, 2]),
    dict(quality_mode='dB', quality_layers=[30, 45]),
    dict(codeblock_size=(16, 8)), dict(codeblock_size=(64, 32)),
    dict(precinct_size=(32, 32)), dict(num_resolutions=2),
    dict(num_resolutions=7), dict(mct=0)])
def test_jpeg2000(irreversible, options):
    """JP2 and J2K as PIL writes them (openjpeg): the 5/3 wavelet and RCT,
    the 9/7 and ICT in openjpeg's float order, tiles, offsets, layers,
    code-blocks and precincts; RGB and greyscale, 70x90."""
    image = seeded(70, 90, 11)
    for mode in (None, 'L'):
        assert_as_pil(pil_j2k(image, mode, irreversible=irreversible,
                              **options))


@pytest.mark.parametrize('progression', ['LRCP', 'RLCP', 'RPCL', 'PCRL',
                                         'CPRL'])
def test_jpeg2000_progressions(progression):
    image = seeded(61, 83, 12)
    for tiles in (None, (32, 48)):
        kw = dict(tile_size=tiles) if tiles else {}
        assert_as_pil(pil_j2k(image, progression=progression,
                              precinct_size=(32, 32), codeblock_size=(8, 8),
                              quality_mode='rates', quality_layers=[20, 6],
                              **kw))


@pytest.mark.parametrize('size', [(1, 1), (2, 3), (17, 9), (480, 640)])
def test_jpeg2000_sizes_and_modes(size):
    """Small and odd sizes, a 640x480 9/7 file, RGBA, LA and 16-bit
    greyscale (PIL's I;16, clipped at 255 by its conversion)."""
    h, w = size
    image = seeded(h, w, 13)
    kw = dict(num_resolutions=1) if h * w < 8 else {}
    assert_as_pil(pil_j2k(image, irreversible=True, **kw))
    if h * w > 100:
        assert_as_pil(pil_j2k(np.dstack([image, image[:, :, 1]])))
        assert_as_pil(pil_j2k(image, 'LA'))
        wide = PIL.Image.fromarray(image[:, :, 0].astype(np.uint16) * 3
                                   ).convert('I;16')
        assert_as_pil(pil_bytes(wide, 'JPEG2000'))


def j2k_segments(stream: bytes):
    """A one-tile codestream -> its main header segments {marker: body}
    and the tile's packet data."""
    pos, segments = 2, {}
    while True:
        marker, = struct.unpack('>H', stream[pos:pos + 2])
        if marker == 0xFF90:
            break
        length, = struct.unpack('>H', stream[pos + 2:pos + 4])
        segments[marker] = stream[pos + 4:pos + 2 + length]
        pos += 2 + length
    psot, = struct.unpack('>I', stream[pos + 6:pos + 10])
    body = pos + 12
    while stream[body:body + 2] != b'\xff\x93':
        body += 2 + struct.unpack('>H', stream[body + 2:body + 4])[0]
    end = pos + psot if psot else len(stream) - 2
    return segments, stream[body + 2:end]


def subsampled_j2k(image, sub, **kw) -> bytes:
    """(h, w, 3) as a J2K codestream whose components 1 and 2 are every
    ``sub``-th sample: three greyscale codestreams PIL wrote, spliced into
    one (CPRL order, so each component's packets follow one another; COC
    and QCC carry each component's own coding)."""
    sx, sy = sub
    planes = [image[:, :, 0], image[::sy, ::sx, 1], image[::sy, ::sx, 2]]
    parts = [j2k_segments(pil_j2k(np.ascontiguousarray(p), no_jp2=True, **kw))
             for p in planes]
    head = parts[0][0]
    siz = head[0xFF51][:34] + struct.pack('>H', 3) + bytes(
        [7, 1, 1, 7, sx, sy, 7, sx, sy])
    cod = bytearray(head[0xFF52])
    cod[1], cod[4] = 4, 0   # CPRL, no component transform

    def segment(marker, body):
        return struct.pack('>HH', marker, len(body) + 2) + body

    out = b'\xff\x4f' + segment(0xFF51, siz) + segment(0xFF52, bytes(cod)) \
        + segment(0xFF5C, head[0xFF5C])
    for c in (1, 2):
        own = parts[c][0]
        out += segment(0xFF53, bytes([c, own[0xFF52][0] & 1])
                       + own[0xFF52][5:])
        out += segment(0xFF5D, bytes([c]) + own[0xFF5C])
    body = b''.join(p[1] for p in parts)
    return out + struct.pack('>HHHIBB', 0xFF90, 10, 0, 14 + len(body), 0,
                             1) + b'\xff\x93' + body + b'\xff\xd9'


@pytest.mark.parametrize('sub', [(2, 2), (2, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize('size', [(32, 48), (33, 65), (17, 9)])
def test_jpeg2000_subsampled(sub, size):
    """Subsampled chroma: Pillow reads three unspecified components with
    subsampling as sYCC (its own YCbCr tables) and reads each tile's
    components at (w // dx) samples a row, odd sizes included."""
    image = seeded(*size, 14)
    for kw in ({}, dict(irreversible=True), dict(num_resolutions=2)):
        data = subsampled_j2k(image, sub, **kw)
        try:
            pil_rgb_of(data)
        except OSError:   # openjpeg refuses some 9/7 splices at 17x9
            continue
        assert_as_pil(data)


def test_jpeg2000_refusals():
    image = seeded(16, 16, 15)
    data = pil_j2k(image, no_jp2=True)
    segments, _ = j2k_segments(data)
    for name, bad in (('truncated', data[:len(data) // 2]),
                      ('BYPASS', data.replace(
                          segments[0xFF52], segments[0xFF52][:8] + bytes(
                              [segments[0xFF52][8] | 1])
                          + segments[0xFF52][9:], 1))):
        with pytest.raises(ValueError, match=name):
            image_io.decode(bad)


# ------------------------------------------------- the small raster formats

def packbits(row: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes, literals of up to 128."""
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        j = i
        while j < len(row) and j - i < 128 and not (
                j + 2 < len(row) and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def sgi_rle(row: np.ndarray) -> bytes:
    """One row of SGI RLE (8- or 16-bit words): runs and copies of up to
    127, a zero count last."""
    words, out, i = [int(v) for v in row], [], 0
    while i < len(words):
        j = i
        while j < len(words) and j - i < 127 and words[j] == words[i]:
            j += 1
        if j - i >= 2:
            out += [j - i, words[i]]
        else:
            j = i
            while j < len(words) and j - i < 127 and not (
                    j + 1 < len(words) and words[j] == words[j + 1]):
                j += 1
            out += [0x80 | (j - i)] + words[i:j]
        i = j
    out.append(0)
    dtype = '>u2' if row.dtype.itemsize == 2 else np.uint8
    return np.array(out, dtype).tobytes()


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA', 'P', '1'])
@pytest.mark.parametrize('rle', [False, True])
@pytest.mark.parametrize('orientation', [1, -1])
def test_tga_as_pil_writes(mode, rle, orientation):
    if mode == '1' and rle:
        return   # PIL fails to read its own 1-bit RLE files
    image = seeded(37, 45, 20)
    im = PIL.Image.fromarray(image).quantize(20) if mode == 'P' else \
        PIL.Image.fromarray(np.dstack([image, image[:, :, 0]])).convert(mode)
    assert_as_pil(pil_bytes(im, 'TGA', rle=rle, orientation=orientation))


def tga_file(kind, depth, pixels: bytes, width, height, flags=0,
             colormap=None, map_depth=0, start=0, ident=b'') -> bytes:
    entries = 0 if colormap is None else len(colormap) // (map_depth // 8)
    head = struct.pack('<BBBHHBHHHHBB', len(ident), colormap is not None,
                       kind, start, entries, map_depth, 0, 0, width, height,
                       depth, flags)
    return head + ident + (colormap or b'') + pixels


def test_tga_written_here():
    """16-bit true colour (5-5-5), 16- and 24-bit colour maps with a first
    index, an ID field, right-to-left origins, and RLE literals that cross
    rows."""
    rng = np.random.default_rng(21)
    w, h = 13, 7
    cases = []
    for flags in (0, 0x10, 0x20, 0x30):
        words = rng.integers(0, 65536, w * h).astype('<u2').tobytes()
        cases.append(tga_file(2, 16, words, w, h, flags, ident=b'abc'))
    indices = rng.integers(0, 40, w * h).astype(np.uint8).tobytes()
    for map_depth in (16, 24):
        colours = rng.integers(0, 256, 30 * map_depth // 8).astype(
            np.uint8).tobytes()
        cases.append(tga_file(1, 8, indices, w, h, 0x20, colours, map_depth,
                              start=10))
    # RLE: a run of a row, literals across one and across several rows
    packets = bytes([0x80 | 12]) + b'\x10\x20\x30' + bytes([19]) + \
        rng.integers(0, 256, 60).astype(np.uint8).tobytes() + bytes(
            [w * h - 34]) + rng.integers(0, 256, (w * h - 33) * 3).astype(
                np.uint8).tobytes()
    cases.append(tga_file(10, 24, packets, w, h, 0x20))
    for data in cases:
        assert_as_pil(data)
    # PIL fails on a run across rows and on a map before true colour
    colours = rng.integers(0, 256, 12).astype(np.uint8).tobytes()
    rgb = rng.integers(0, 256, w * h * 3).astype(np.uint8).tobytes()
    across = bytes([0x80 | 19]) + b'\x10\x20\x30' + bytes([w * h - 21]) + \
        rng.integers(0, 256, (w * h - 20) * 3).astype(np.uint8).tobytes()
    for data, match in ((tga_file(2, 24, rgb, w, h, 0, colours, 24),
                         'TGA of image type 2'),
                        (tga_file(10, 24, across, w, h), 'across rows')):
        with pytest.raises(ValueError, match=match):
            image_io.decode(data)
        with pytest.raises((ValueError, OSError)):
            pil_rgb_of(data)


@pytest.mark.parametrize('mode', ['RGB', 'RGBA'])
@pytest.mark.parametrize('size', [(1, 1), (37, 45), (64, 3)])
def test_qoi(mode, size):
    image = seeded(*size, 22)
    image[:, : size[1] // 2] //= 32   # runs, diffs and index hits
    rgba = np.dstack([image, (image[:, :, 0] > 100) * 255])
    assert_as_pil(pil_bytes(rgba.astype(np.uint8), 'QOI', mode=mode))


def test_qoi_index_never_seen():
    """Pillow reads an index op on an empty slot as (0, 0, 0, 0)."""
    data = b'qoif' + struct.pack('>IIBB', 3, 1, 3, 0) + bytes(
        [0xFE, 9, 8, 7, 5, 0xC0]) + b'\0' * 7 + b'\1'
    assert_as_pil(data)


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L'])
def test_sgi_as_pil_writes(mode):
    image = seeded(23, 31, 23)
    assert_as_pil(pil_bytes(np.dstack([image, image[:, :, 2]]), 'SGI',
                            mode=mode))


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('bpc', [1, 2])
@pytest.mark.parametrize('rle', [False, True])
def test_sgi_written_here(channels, bpc, rle):
    rng = np.random.default_rng(channels + 10 * bpc)
    w, h = 19, 11
    values = rng.integers(0, 256 ** bpc, (channels, h, w))
    values[:, :, :8] = values[:, :, :1]   # runs
    dtype = np.dtype('>u2' if bpc == 2 else np.uint8)
    planes = values.astype(dtype)
    head = struct.pack('>HBBHHHH', 474, int(rle), bpc,
                       1 if channels == 1 and h == 1 else (
                           2 if channels == 1 else 3), w, h, channels)
    head = head.ljust(512, b'\0')
    if not rle:
        return assert_as_pil(head + planes.tobytes())
    rows = [sgi_rle(planes[c, y]) for c in range(channels) for y in range(h)]
    table_end = 512 + 8 * len(rows)
    starts, at = [], table_end
    for row in rows:
        starts.append(at)
        at += len(row)
    body = np.array(starts, '>u4').tobytes() + np.array(
        [len(r) for r in rows], '>u4').tobytes()
    assert_as_pil(head + body + b''.join(rows))


@pytest.mark.parametrize('mode', ['RGB', 'L', 'P', '1'])
@pytest.mark.parametrize('width', [45, 46, 8])
def test_pcx_as_pil_writes(mode, width):
    image = seeded(21, width, 24)
    im = PIL.Image.fromarray(image).quantize(30) if mode == 'P' else \
        PIL.Image.fromarray(image).convert(mode)
    assert_as_pil(pil_bytes(im, 'PCX'))


def pcx_file(version, bits, planes, lines, width, height, stride,
             palette=b'', trailer=b'') -> bytes:
    head = struct.pack('<BBBBHHHHHH', 10, version, 1, bits, 0, 0, width - 1,
                       height - 1, 72, 72)
    head += palette.ljust(48, b'\0') + bytes([0, planes]) + struct.pack(
        '<HH', stride, 1)
    body = b''
    for line in lines:
        for b in line:
            body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return head.ljust(128, b'\0') + body + trailer


def test_pcx_written_here():
    """Every version PIL takes (0, 2, 3, 5): 1 bit in 1, 2 and 4 planes
    with the header's colours, a stride the header gets wrong, 8-bit grey
    with and without a 769-byte trailer."""
    rng = np.random.default_rng(25)
    w, h = 21, 6
    palette = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    cases = []
    for version in (0, 2, 3, 5):
        for planes in (1, 2, 4):
            for stride in (3, 4, 5):
                lines = [rng.integers(0, 256, planes * (
                    stride + stride % 2 if stride != 3 else 3)).astype(
                        np.uint8).tobytes() for _ in range(h)]
                cases.append(pcx_file(version, 1, planes, lines, w, h, stride,
                                      palette))
    grey = [rng.integers(0, 256, 22).astype(np.uint8).tobytes()
            for _ in range(h)]
    ramp = b'\x0c' + bytes(np.repeat(np.arange(256), 3).astype(np.uint8))
    table = b'\x0c' + rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    for trailer in (b'', ramp, table):
        cases.append(pcx_file(5, 8, 1, grey, w, h, 22, trailer=trailer))
    for data in cases:
        assert_as_pil(data)


def test_pcx_versions_sniffed():
    """PCX by PIL's test (10, then version 0, 2, 3 or 5), not 10, 5 only."""
    image = seeded(9, 16, 26)
    data = pil_bytes(PIL.Image.fromarray(image).convert('1'), 'PCX')
    for version in (0, 2, 3, 5):
        variant = data[:1] + bytes([version]) + data[2:]
        assert image_io.sniff(variant) == 'pcx'
        assert_as_pil(variant)


def psd_file(mode, depth, planes: np.ndarray, compression=0,
             colour_data=b'', resources=b'') -> bytes:
    """A PSD of (channels, h, w) ``planes`` (bits packed for depth 1)."""
    channels, h, w = planes.shape[0], planes.shape[1], (
        planes.shape[2] * 8 if depth == 1 else planes.shape[2])
    head = b'8BPS' + struct.pack('>H6xHIIHH', 1, channels, h, w, depth, mode)
    head += struct.pack('>I', len(colour_data)) + colour_data
    head += struct.pack('>I', len(resources)) + resources
    head += struct.pack('>I', 0)
    if compression == 0:
        return head + b'\0\0' + planes.tobytes()
    rows = [packbits(planes[c, y].tobytes()) for c in range(channels)
            for y in range(h)]
    return head + b'\0\1' + np.array([len(r) for r in rows],
                                     '>u2').tobytes() + b''.join(rows)


@pytest.mark.parametrize('compression', [0, 1])
def test_psd(compression):
    """The merged image in every colour mode PIL reads at 8 bits, and
    bitmaps, raw and PackBits (PIL writes no PSD)."""
    rng = np.random.default_rng(27)
    h, w = 9, 14
    planes = rng.integers(0, 256, (5, h, w)).astype(np.uint8)
    planes[:, :, :6] = 7   # runs for PackBits
    resource = b'8BIM' + struct.pack('>H', 1005) + b'\x03abc' + struct.pack(
        '>I', 3) + b'xyz\0'
    palette = rng.integers(0, 256, 768).astype(np.uint8).tobytes()
    cases = [psd_file(1, 8, planes[:1], compression, resources=resource),
             psd_file(0, 8, planes[:1], compression),
             psd_file(8, 8, planes[:1], compression, b'duotone data'),
             psd_file(7, 8, planes[:2], compression),
             psd_file(2, 8, planes[:1], compression, palette),
             psd_file(3, 8, planes[:3], compression),
             psd_file(3, 8, planes[:4], compression),
             psd_file(3, 8, planes[:5], compression),
             psd_file(4, 8, planes[:4], compression),
             psd_file(4, 8, planes[:5], compression),
             psd_file(0, 1, planes[:1, :, :2], compression)]
    for data in cases:
        assert_as_pil(data)


@pytest.mark.parametrize('payload', ['png', 'bmp'])
@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'P', 'L', '1'])
def test_ico(payload, mode):
    """ICO as PIL writes it, several sizes (the largest is read), PNG or
    BMP payloads (a DIB at twice the height, with its AND mask)."""
    image = seeded(64, 64, 28)
    im = PIL.Image.fromarray(image).quantize(12) if mode == 'P' else \
        PIL.Image.fromarray(np.dstack([image, image[:, :, 0]])).convert(mode)
    assert_as_pil(pil_bytes(im, 'ICO', bitmap_format=payload,
                            sizes=[(16, 16), (48, 48), (32, 32)]))


def test_cur_and_ico_choice():
    """CUR (PIL writes none): its first entry, or one wider and taller;
    ICO: the largest, the fewest bits first among equals."""
    def dib(image):
        raw = pil_bytes(image, 'DIB')
        h = image.size[1]
        and_mask = bytes((image.size[0] + 31) // 32 * 4 * h)
        return raw[:8] + struct.pack('<i', 2 * h) + raw[12:] + and_mask

    small = PIL.Image.fromarray(seeded(16, 16, 29))
    large = PIL.Image.fromarray(seeded(32, 24, 30)).quantize(16)
    payloads = [dib(small), dib(large)]
    for magic in (b'\0\0\2\0', b'\0\0\1\0'):
        for order in ((0, 1), (1, 0)):
            head = magic + struct.pack('<H', 2)
            at = 6 + 32
            entries, body = b'', b''
            for i in order:
                im = (small, large)[i]
                entries += struct.pack('<BBBBHHII', im.size[0] % 256,
                                       im.size[1] % 256, 0, 0, 1,
                                       (24, 4)[i], len(payloads[i]),
                                       at + len(body))
                body += payloads[i]
            assert_as_pil(head + entries + body)


def test_chip_smoke_jpeg_tiff_as_pil():
    """The JPEG-in-TIFF ``chip_smoke.py`` builds on the card's machine
    (strips from the port's encoder) reads here as PIL reads it."""
    image = seeded(40, 30, 33)
    strips = [jpeg.encode(image[y:y + 16], 75) for y in range(0, 40, 16)]
    assert_as_pil(chip_smoke.jpeg_tiff(strips, 30, 40, 16))


# ------------------------------------------------------- detection, parity

def test_signatures_that_fall_through_to_tga():
    """A TGA whose first bytes read as a CUR, ICO or PCX signature: PIL's
    plugin gives up on the header and goes on to TGA, as the port does."""
    image = seeded(5, 7, 31)
    data = tga_file(2, 24, image.tobytes(), 7, 5)   # 00 00 02 00: CUR's
    assert image_io.sniff(data) == 'cur'
    assert_as_pil(data)
    # 00 00 01 00, ICO's: a colour-mapped TGA without a map, which PIL
    # fails to read after it gives up on ICO
    data = tga_file(1, 8, image[:, :, 0].tobytes(), 7, 5)
    with pytest.raises(ValueError, match='TGA of image type 1'):
        image_io.decode(data)
    with pytest.raises(ValueError):
        pil_rgb_of(data)
    # 0a 00: PCX's; a bad PCX size (the map's first index, 0x500, read as
    # its left edge) sends PIL on to TGA
    pcx_like = tga_file(2, 24, image.tobytes(), 7, 5, start=0x500,
                        ident=b'0123456789')
    assert image_io.sniff(pcx_like) == 'pcx'
    assert_as_pil(pcx_like)
    with pytest.raises(ValueError, match='CUR: no cursors'):
        image_io.decode(b'\0\0\2\0' + bytes(20))


def new_format_tree(root) -> list:
    """One file of each new format, some under a wrong suffix."""
    image = seeded(40, 52, 32)
    files = {
        'a.jp2': pil_j2k(image, irreversible=True),
        'b.j2k': pil_j2k(image, no_jp2=True),
        'c.tif': pil_bytes(image, 'TIFF', compression='jpeg'),
        'd.png': pil_bytes(PIL.Image.fromarray(image).convert('1'), 'TIFF',
                           compression='group4'),
        'e.tga': pil_bytes(image, 'TGA', rle=True),
        'f.qoi': pil_bytes(image, 'QOI'),
        'g': pil_bytes(image, 'ICO', sizes=[(32, 32)]),
        'h.sgi': pil_bytes(image, 'SGI'),
        'i.pcx': pil_bytes(image, 'PCX'),
        'j.psd': psd_file(3, 8, np.ascontiguousarray(
            image.transpose(2, 0, 1)), 1),
        'k.tif': pil_bytes(PIL.Image.fromarray(image[:, :, 0]).convert('F'),
                           'TIFF', big_tiff=True)}
    for name, data in files.items():
        (root / name).write_bytes(data)
    return list(files)


def test_image_list_and_coco_dataset_as_jax_new_formats(tmp_path):
    names = new_format_tree(tmp_path)
    paths = [str(tmp_path / name) for name in names]
    want = JaxImageList(paths, lambda image, anns, meta: (image, anns, meta))
    got = ImageList(paths, lambda image, anns, meta: (image, anns, meta))
    for index in range(len(paths)):
        np.testing.assert_array_equal(got[index][0].permute(1, 2, 0).numpy(),
                                      np.asarray(want[index][0], np.float32))
    annotations = tmp_path / 'ann.json'
    annotations.write_text(json.dumps({
        'images': [{'id': i + 1, 'file_name': name, 'height': 1, 'width': 1}
                   for i, name in enumerate(names)],
        'annotations': [{'id': i + 1, 'image_id': i + 1, 'category_id': 1,
                         'iscrowd': 0, 'bbox': [1, 1, 5, 5], 'area': 25,
                         'num_keypoints': 1,
                         'keypoints': [3, 3, 2] + [0, 0, 0] * 16}
                        for i in range(len(names))],
        'categories': [{'id': 1, 'name': 'person'}]}))
    want = JaxCocoDataset(str(tmp_path), str(annotations))
    got = CocoDataset(str(tmp_path), str(annotations))
    assert got.ids == want.ids and len(got) == len(names)
    for index in range(len(names)):
        w_image, w_anns, w_meta = want[index]
        g_image, g_anns, g_meta = got[index]
        np.testing.assert_array_equal(g_image.permute(1, 2, 0).numpy(),
                                      np.asarray(w_image, np.float32))
        assert g_anns == w_anns and g_meta == w_meta
