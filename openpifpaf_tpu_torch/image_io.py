"""Image files without PIL: a PNG reader and writer on ``zlib`` and numpy.

The machine with the card has no PIL, so the port reads its frames itself:
8-bit greyscale, greyscale with alpha, RGB and RGBA PNG files, not
interlaced, with all five row filters (None, Sub, Up, Average, Paeth, PNG
specification section 9).  ``read_image`` gives (H, W, 3) uint8 RGB, as
PIL's ``convert('RGB')`` does: grey replicated, alpha dropped.  JPEG and
BMP files go through PIL when it is importable and raise a ``ValueError``
naming the missing decoder otherwise.  ``write_png`` writes such files
with a chosen row filter (the tests read them back, and ``chip_smoke.py``
writes its video frames with it).
"""

from __future__ import annotations

import importlib
import os
import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG colour type -> channels (8-bit samples)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FILTERS = ('none', 'sub', 'up', 'average', 'paeth')
PNG_SUFFIXES = ('.png',)
PIL_SUFFIXES = ('.jpg', '.jpeg', '.bmp')
SUFFIXES = PNG_SUFFIXES + PIL_SUFFIXES


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


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C the file's channels (1, 2, 3, 4)."""
    if not data.startswith(SIGNATURE):
        raise ValueError('not a PNG file')
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError('PNG without an IHDR chunk')
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in CHANNELS or interlace:
        raise ValueError(
            f'PNG with bit depth {depth}, colour type {colour}, interlace '
            f'{interlace}: only 8-bit greyscale, grey+alpha, RGB and RGBA '
            'without interlacing are read')
    channels = CHANNELS[colour]
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError('PNG image data has the wrong size')
    return _unfilter(raw, height, stride, channels).reshape(
        height, width, channels)


def to_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3): grey replicated, alpha dropped."""
    if image.shape[2] in (1, 2):
        return np.repeat(image[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(image[:, :, :3])


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    suffix = os.path.splitext(path)[1].lower()
    if suffix in PNG_SUFFIXES:
        with open(path, 'rb') as f:
            return to_rgb(read_png(f.read()))
    if suffix in PIL_SUFFIXES:
        try:
            pil_image = importlib.import_module('PIL.Image')
        except ImportError as e:
            raise ValueError(
                f'{path}: {suffix} needs the PIL decoder, which is not '
                'installed; convert the frames to PNG') from e
        with pil_image.open(path) as im:
            return np.asarray(im.convert('RGB'))
    raise ValueError(f'{path}: no reader for {suffix!r} files')


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
    colour = {c: t for t, c in CHANNELS.items()}[channels]
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
