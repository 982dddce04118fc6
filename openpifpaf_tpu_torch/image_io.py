"""Image files without PIL: the format by content, PNG and BMP readers,
a PNG writer.

The machine with the card has no PIL, so the port reads its images
itself.  ``read_image`` gives (H, W, 3) uint8 RGB, what the JAX package
gets from PIL's ``Image.open(path).convert('RGB')``.  As PIL does, it
picks the reader from the file's leading bytes (``sniff``), never from
its name, and raises a ``ValueError`` naming any other format:

- PNG (``zlib`` and numpy): every colour type (greyscale, RGB, palette,
  greyscale with alpha, RGBA) at every bit depth the specification allows
  (1, 2, 4, 8 and 16), with or without Adam7 interlacing, all five row
  filters (PNG specification sections 7-9).  Grey is replicated, alpha
  and ``tRNS`` dropped, a palette looked up, depths below 8 scaled to 8
  bits as PIL scales them (x255, x85, x17); at 16 bits colour samples
  keep their high byte, and greyscale clips at 255, as PIL's ``I;16`` ->
  RGB conversion does;
- BMP (``read_bmp``): 1-, 4- and 8-bit palettes, 16-, 24- and 32-bit
  files, ``BI_BITFIELDS`` in the layouts Pillow reads, RLE8 and RLE4;
  embedded JPEG or PNG raise;
- JPEG: ``jpeg.decode`` (``csrc/jpeg.cpp``), CMYK and YCCK included;
- WebP, GIF, TIFF, PNM and JPEG 2000: ``image_formats``;
- ICO, CUR, TGA, QOI, PSD, SGI and PCX: ``raster_formats``.

``write_png`` writes 8-bit PNG files with a chosen row filter (the tests
read them back, and ``chip_smoke.py`` writes its video frames with it).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import image_formats, jpeg, raster_formats

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG colour type -> channels
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# bit depths the PNG specification allows for each colour type
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
FILTERS = ('none', 'sub', 'up', 'average', 'paeth')


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f'PNG chunk {kind!r}: CRC mismatch')
        yield kind, body
        pos += 12 + length
        if kind == b'IEND':
            return
    raise ValueError('PNG ends without an IEND chunk')


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Reverse the per-row filters: ``raw`` holds, per row, the filter
    type byte and ``stride`` filtered bytes."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            recon = line.copy()
        elif kind == 1:   # Sub: a running sum per byte position mod bpp
            recon = np.cumsum(line.reshape(-1, bpp), axis=0,
                              dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            recon = line + prior
        elif kind in (3, 4):   # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            recon = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f'PNG row filter {kind} is not defined')
        out[y] = recon
        prior = out[y]
    return out


def _unpack(rows: np.ndarray, width: int, channels: int,
            depth: int) -> np.ndarray:
    """Unfiltered rows (H, stride) -> (H, W, C) samples (uint8, or uint16
    at depth 16)."""
    height = rows.shape[0]
    if depth == 16:
        return rows.view('>u2').astype(np.uint16).reshape(
            height, width, channels)
    if depth == 8:
        return rows.reshape(height, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(height, -1)[:, :width * channels].reshape(
        height, width, channels)


def _image_data(raw: np.ndarray, width: int, height: int, channels: int,
                depth: int, interlace: int) -> np.ndarray:
    """The decompressed IDAT stream -> (H, W, C) samples."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    if not interlace:
        stride = (width * bits + 7) // 8
        if raw.size != height * (stride + 1):
            raise ValueError('PNG image data has the wrong size')
        return _unpack(_unfilter(raw, height, stride, bpp), width, channels,
                       depth)
    out = np.zeros((height, width, channels),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for r0, c0, rs, cs in ADAM7:
        h, w = -(-(height - r0) // rs), -(-(width - c0) // cs)
        if h <= 0 or w <= 0:
            continue
        stride = (w * bits + 7) // 8
        size = h * (stride + 1)
        if pos + size > raw.size:
            raise ValueError('PNG image data has the wrong size')
        rows = _unfilter(raw[pos:pos + size], h, stride, bpp)
        out[r0::rs, c0::cs] = _unpack(rows, w, channels, depth)
        pos += size
    if pos != raw.size:
        raise ValueError('PNG image data has the wrong size')
    return out


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C the file's channels (1 grey, 2 grey
    and alpha, 3 RGB, 4 RGBA; a palette image gives its colours, 3), the
    samples at 8 bits as PIL's ``convert('RGB')`` reads them (see the
    module's docstring)."""
    if not data.startswith(SIGNATURE):
        raise ValueError('not a PNG file')
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG without an IHDR chunk')
    width, height, depth, colour, _, _, interlace = header
    if colour not in DEPTHS or depth not in DEPTHS[colour] or interlace > 1:
        raise ValueError(
            f'PNG with bit depth {depth}, colour type {colour}, interlace '
            f'{interlace}: not a valid combination')
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    samples = _image_data(raw, width, height, CHANNELS[colour], depth,
                          interlace)
    if colour == 3:
        if palette is None:
            raise ValueError('PNG palette image without a PLTE chunk')
        return image_formats.lookup(samples[:, :, 0], palette)
    if depth == 16:
        if colour == 0:
            return np.minimum(samples, 255).astype(np.uint8)
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return samples


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3): grey replicated, alpha dropped."""
    if image.shape[2] in (1, 2):
        return np.repeat(image[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(image[:, :, :3])


BMP_COMPRESSIONS = {0: 'BI_RGB', 1: 'RLE8', 2: 'RLE4', 3: 'BI_BITFIELDS',
                    4: 'an embedded JPEG', 5: 'an embedded PNG',
                    6: 'BI_ALPHABITFIELDS'}
# Pillow's BI_BITFIELDS layouts: bits -> (R, G, B[, A]) masks it reads
BMP_MASKS = {
    32: ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)),
    24: ((0xFF0000, 0xFF00, 0xFF),),
    16: ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F))}


def _bmp_rle(data: bytes, offset: int, width: int, height: int,
             rle4: bool) -> np.ndarray:
    """Pillow 12's ``BmpRleDecoder``, quirks kept: a delta reads two bytes
    more than it uses, an odd absolute run of RLE4 drops its last pixel, and
    absolute runs align on the file's (not the bitmap's) 16-bit words; rows
    come out bottom-up as written."""
    out = bytearray()
    x, pos, total = 0, offset, width * height
    while len(out) < total:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded run
            count_in_row = max(0, width - x) if x + count > width else count
            if rle4:
                pair = (byte >> 4, byte & 0x0F)
                out += bytes(pair[i % 2] for i in range(count_in_row))
            else:
                out += bytes([byte]) * count_in_row
            x += count_in_row
        elif byte == 0:  # end of line
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                raise ValueError('BMP: truncated RLE delta')
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:  # absolute run
            n = byte // 2 if rle4 else byte
            run = data[pos:pos + n]
            pos += len(run)
            if rle4:
                out += bytes(v for b in run for v in (b >> 4, b & 0x0F))
            else:
                out += run
            if len(run) < n:
                break
            x += byte
            pos += pos % 2
    if len(out) < total:
        raise ValueError('BMP: not enough RLE image data')
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, width)


def read_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB, what Pillow 12 reads: the 12-byte
    OS/2 header and the Windows ones; 1-, 4- and 8-bit palettes (a grey
    ramp is read as grey, as Pillow does), 16-bit 5-5-5 and, under
    ``BI_BITFIELDS``, 5-6-5 or 5-5-5, 24- and 32-bit with Pillow's masks,
    RLE8 and RLE4; bottom-up or top-down.  Other bit fields and embedded
    JPEG or PNG raise."""
    if data[:2] != b'BM' or len(data) < 26:
        raise ValueError('not a BMP file')
    offset, header = struct.unpack('<II', data[10:18])
    masks = ()
    if header == 12:
        width, height, _, bpp = struct.unpack('<HHHH', data[18:26])
        compression, colours, padding, top_down = 0, 0, 3, False
    elif header in (40, 52, 56, 64, 108, 124) and len(data) >= 14 + header:
        width, height, _, bpp, compression = struct.unpack('<IIHHI',
                                                           data[18:34])
        colours, = struct.unpack('<I', data[46:50])
        top_down = data[25] == 0xFF
        if top_down:
            height = 2 ** 32 - height
        padding = 4
        if compression == 3:
            masks = struct.unpack('<IIII' if header >= 56 else '<III',
                                  data[54:70 if header >= 56 else 66])
            if header == 40 or header == 52:
                masks = masks[:3] + (0,)
    else:
        raise ValueError(f'BMP with a {header}-byte header is not supported')
    if not 0 < width < 2 ** 31 or not 0 < height < 2 ** 31:
        raise ValueError('BMP with a bad size')
    colours = colours or (1 << bpp if bpp <= 16 else 0)
    if offset == 14 + header and bpp <= 8:
        offset += 4 * colours
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f'BMP with {bpp} bits per pixel is not supported')
    name = BMP_COMPRESSIONS.get(compression, f'compression {compression}')
    if compression not in (0, 1, 2, 3):
        raise ValueError(f'BMP with {name} is not supported')
    if compression == 3 and (masks if bpp == 32 else masks[:3]) not in \
            BMP_MASKS.get(bpp, ()):
        raise ValueError('BMP with bit field masks '
                         f'{", ".join(f"0x{m:x}" for m in masks)} at {bpp} '
                         'bits is not supported (Pillow reads only its '
                         'fixed layouts)')
    table = None
    if bpp <= 8:
        if not 0 < colours <= 65536:
            raise ValueError(f'BMP with a palette of {colours} colours')
        raw = data[14 + header:14 + header + padding * colours]
        grey = all(raw[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate((0, 255) if colours == 2
                                         else range(colours)))
        if grey and compression == 0 and bpp < 8 and colours != 2:
            raise ValueError(f'BMP at {bpp} bits with a grey ramp palette '
                             'is not supported (Pillow fails on it too)')
        if grey and compression and colours == 2:
            raise ValueError('BMP with RLE and a black and white palette is '
                             'not supported')
        if not grey:
            table = np.frombuffer(raw[:len(raw) // padding * padding],
                                  np.uint8).reshape(-1, padding)[:, 2::-1]
    if compression in (1, 2):
        indices = _bmp_rle(data, offset, width, height, compression == 2)
        if not top_down:
            indices = indices[::-1]
    else:
        stride = (width * bpp + 31) // 32 * 4
        if offset + stride * height > len(data):
            raise ValueError('BMP pixel data is truncated')
        rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(
            height, stride)
        if not top_down:
            rows = rows[::-1]
        if bpp < 8:
            shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
            indices = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)
                       ).reshape(height, -1)[:, :width]
        elif bpp == 8:
            indices = rows[:, :width]
    if bpp <= 8:
        if table is None:  # a grey ramp: the indices (black and white: 0, 1)
            scale = 255 if colours == 2 else 1
            return np.repeat((indices * scale).astype(np.uint8)[:, :, None],
                             3, 2)
        return image_formats.lookup(indices, table)
    if bpp == 16:
        pixel = (rows[:, 0:width * 2:2].astype(np.int64)
                 | rows[:, 1:width * 2:2].astype(np.int64) << 8)
        if masks[:3] == (0xF800, 0x7E0, 0x1F):
            fields = ((11, 31), (5, 63), (0, 31))
        else:
            fields = ((10, 31), (5, 31), (0, 31))
        return np.stack([((pixel >> s) & m) * 255 // m for s, m in fields],
                        2).astype(np.uint8)
    pixels = rows[:, :width * bpp // 8].reshape(height, width, bpp // 8)
    if compression == 0 or not any(masks):
        return np.ascontiguousarray(pixels[:, :, 2::-1])
    value = np.zeros((height, width), np.uint32)
    for i in range(bpp // 8):
        value |= pixels[:, :, i].astype(np.uint32) << (8 * i)
    out = np.empty((height, width, 3), np.uint8)
    for c, mask in enumerate(masks[:3]):
        shift = (mask & -mask).bit_length() - 1
        out[:, :, c] = (value >> shift) & 0xFF
    return out


# other formats PIL reads, by their leading bytes, for the refusal
OTHER_SIGNATURES = (
    (4, b'ftypavif', 'an AVIF file'), (4, b'ftypavis', 'an AVIF file'),
    (4, b'ftypheic', 'a HEIF file'), (4, b'ftypmif1', 'a HEIF file'),
    (0, b'DDS ', 'a DDS file'), (0, b'icns', 'an ICNS icon'),
    (0, b'\x76\x2f\x31\x01', 'an OpenEXR file'),
    (0, b'%PDF', 'a PDF document'))
# the formats with a signature that PIL's Image.open tries after the ones
# it preloads (BMP, DIB, GIF, JPEG, PPM, PNG), in its registry's order
SIGNED = (('cur', b'\0\0\2\0'), ('jpeg2000', image_formats.J2K_SIGNATURE),
          ('jpeg2000', image_formats.JP2_SIGNATURE), ('ico', b'\0\0\1\0'),
          ('psd', b'8BPS'), ('qoi', b'qoif'), ('sgi', b'\x01\xda'))


def sniff(data: bytes) -> str:
    """The image format of ``data`` by its leading bytes, as PIL's
    ``Image.open`` picks its plugin: 'jpeg', 'png', 'bmp', 'gif', 'webp',
    'tiff', 'pnm', 'jpeg2000', 'ico', 'cur', 'psd', 'qoi', 'sgi', 'pcx'
    or, for bytes that no signature claims but that make a valid Targa
    header, 'tga' (PIL tries TGA last but for WebP and a few others);
    raises a ``ValueError`` naming what the bytes look like otherwise."""
    if data[:3] == b'\xff\xd8\xff':
        return 'jpeg'
    if data.startswith(SIGNATURE):
        return 'png'
    if data[:2] == b'BM':
        return 'bmp'
    if data[:6] in (b'GIF87a', b'GIF89a'):
        return 'gif'
    if data[:4] == b'RIFF' and data[8:12] == b'WEBP':
        return 'webp'
    if data[:4] in (b'II*\x00', b'MM\x00*', b'II+\x00', b'MM\x00+'):
        return 'tiff'
    if data[:1] == b'P' and data[1:2] and data[1:2] in b'0123456fy':
        return 'pnm'
    for kind, magic in SIGNED:
        if data.startswith(magic):
            return kind
    if raster_formats.pcx_accepts(data):
        return 'pcx'
    for at, magic, name in OTHER_SIGNATURES:
        if data[at:at + len(magic)] == magic:
            raise ValueError(f'no reader for {name}')
    if raster_formats.tga_header(data) is not None:
        return 'tga'
    if not data:
        raise ValueError('no reader for an empty file')
    raise ValueError('no reader for an unknown image format (leading bytes '
                     f'{data[:12].hex(" ")})')


READERS = {
    'png': lambda data: to_rgb(read_png(data)), 'bmp': read_bmp,
    'jpeg': jpeg.decode, 'webp': image_formats.webp_decode,
    'gif': image_formats.read_gif, 'tiff': image_formats.read_tiff,
    'pnm': image_formats.read_pnm, 'jpeg2000': image_formats.read_jpeg2000,
    'ico': raster_formats.read_ico, 'cur': raster_formats.read_cur,
    'tga': raster_formats.read_tga, 'qoi': raster_formats.read_qoi,
    'psd': raster_formats.read_psd, 'sgi': raster_formats.read_sgi,
    'pcx': raster_formats.read_pcx}


def decode(data: bytes) -> np.ndarray:
    """Image file bytes -> (H, W, 3) uint8 RGB, the format by content;
    corrupt or truncated data raises a ``ValueError`` too.  Bytes whose
    signature claims a format but whose header Pillow then gives up on go
    on to TGA, as in Pillow, when they make a TGA header."""
    kind = sniff(data)
    try:
        try:
            return READERS[kind](data)
        except raster_formats.Fallthrough:
            if raster_formats.tga_header(data) is None:
                raise
            kind = 'tga'
            return READERS[kind](data)
    except (struct.error, IndexError, zlib.error) as e:
        raise ValueError(f'{kind.upper()}: corrupt or truncated data ({e})'
                         ) from e


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB; the format is read from the
    file's bytes, whatever its name."""
    with open(path, 'rb') as f:
        data = f.read()
    try:
        return decode(data)
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from e


def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """Apply row filter ``kind`` to every row of ``rows`` (H, stride)."""
    x = rows.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.zeros_like(x)
        upleft[:, bpp:] = up[:, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    return ((x - pred) & 0xFF).astype(np.uint8)


def png_bytes(image: np.ndarray, row_filter: str = 'up') -> bytes:
    """(H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) uint8 -> PNG
    bytes, every row filtered with ``row_filter`` (one of ``FILTERS``)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f'PNG writer takes uint8, not {image.dtype}')
    if image.ndim == 2:
        image = image[:, :, None]
    height, width, channels = image.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    kind = FILTERS.index(row_filter)
    rows = _filter_rows(image.reshape(height, width * channels), channels,
                        kind)
    raw = np.concatenate([np.full((height, 1), kind, np.uint8), rows], 1)

    def chunk(name: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + name + body
                + struct.pack('>I', zlib.crc32(name + body)))

    return (SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                         colour, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw.tobytes()))
            + chunk(b'IEND', b''))


def write_png(path: str, image: np.ndarray, row_filter: str = 'up') -> None:
    with open(path, 'wb') as f:
        f.write(png_bytes(image, row_filter))
