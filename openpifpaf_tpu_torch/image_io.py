"""Image files without PIL: PNG, BMP and JPEG readers, a PNG writer.

The machine with the card has no PIL, so the port reads its images
itself.  ``read_image`` gives (H, W, 3) uint8 RGB, what the JAX package
gets from PIL's ``Image.open(path).convert('RGB')``, for:

- PNG (``zlib`` and numpy): every colour type (greyscale, RGB, palette,
  greyscale with alpha, RGBA) at every bit depth the specification allows
  (1, 2, 4, 8 and 16), with or without Adam7 interlacing, all five row
  filters (PNG specification sections 7-9).  Grey is replicated, alpha
  and ``tRNS`` dropped, a palette looked up, depths below 8 scaled to 8
  bits as PIL scales them (x255, x85, x17); at 16 bits colour samples
  keep their high byte, and greyscale clips at 255, as PIL's ``I;16`` ->
  RGB conversion does;
- BMP: uncompressed 24- and 32-bit ``BI_RGB`` and ``BI_BITFIELDS`` (8-bit
  masks) files and 8-bit palette files, bottom-up or top-down; other
  variants (1, 4 and 16 bits, RLE, embedded JPEG or PNG) raise;
- JPEG: ``jpeg.decode`` (``csrc/jpeg.cpp``).

``write_png`` writes 8-bit PNG files with a chosen row filter (the tests
read them back, and ``chip_smoke.py`` writes its video frames with it).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from . import jpeg

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
PNG_SUFFIXES = ('.png',)
BMP_SUFFIXES = ('.bmp',)
SUFFIXES = PNG_SUFFIXES + BMP_SUFFIXES + jpeg.SUFFIXES


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
        # indices past the palette read black
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[samples[:, :, 0]]
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


def read_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB: uncompressed 24- and 32-bit
    ``BI_RGB`` and ``BI_BITFIELDS`` (8-bit masks) and 8-bit palette
    files, bottom-up or top-down."""
    if data[:2] != b'BM' or len(data) < 26:
        raise ValueError('not a BMP file')
    offset, = struct.unpack('<I', data[10:14])
    header, = struct.unpack('<I', data[14:18])
    if header not in (40, 52, 56, 108, 124) or len(data) < 14 + header:
        raise ValueError(f'BMP with a {header}-byte header is not supported')
    width, height, _, bpp, compression = struct.unpack('<iiHHI', data[18:34])
    colours, = struct.unpack('<I', data[46:50])
    top_down = height < 0
    height = abs(height)
    if compression not in (0, 3) or bpp not in (8, 24, 32) or (
            compression == 3 and bpp == 8):
        raise ValueError(
            f'BMP with {bpp} bits per pixel and compression {compression} '
            'is not supported: only uncompressed 24- and 32-bit (BI_RGB, '
            'BI_BITFIELDS) and 8-bit palette files are read')
    stride = (width * bpp + 31) // 32 * 4
    if width <= 0 or offset + stride * height > len(data):
        raise ValueError('BMP pixel data is truncated')
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(
        height, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        start = 14 + header
        n = colours or 256
        table = np.frombuffer(data[start:start + n * 4], np.uint8)
        palette = np.zeros((256, 3), np.uint8)
        table = table[:table.size // 4 * 4].reshape(-1, 4)[:256]
        palette[:len(table)] = table[:, 2::-1]
        return palette[rows[:, :width]]
    pixels = rows[:, :width * bpp // 8].reshape(height, width, bpp // 8)
    if compression == 0:
        return np.ascontiguousarray(pixels[:, :, 2::-1])
    masks = struct.unpack('<III', data[54:66])
    value = np.zeros((height, width), np.uint32)
    for i in range(bpp // 8):
        value |= pixels[:, :, i].astype(np.uint32) << (8 * i)
    out = np.empty((height, width, 3), np.uint8)
    for c, mask in enumerate(masks):
        shift = (mask & -mask).bit_length() - 1
        if mask == 0 or mask >> shift != 0xFF:
            raise ValueError(f'BMP bit field mask 0x{mask:08x} is not '
                             'supported: only 8-bit channels are read')
        out[:, :, c] = (value >> shift) & 0xFF
    return out


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    suffix = os.path.splitext(path)[1].lower()
    if suffix not in SUFFIXES:
        raise ValueError(f'{path}: no reader for {suffix!r} files')
    with open(path, 'rb') as f:
        data = f.read()
    if suffix in PNG_SUFFIXES:
        return to_rgb(read_png(data))
    if suffix in BMP_SUFFIXES:
        return read_bmp(data)
    return jpeg.decode(data)


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
