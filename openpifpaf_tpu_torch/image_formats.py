"""PNM, GIF and TIFF readers without PIL, and the WebP and LZW libraries.

Each reader gives (H, W, 3) uint8 RGB, what the JAX package gets from
PIL's ``np.asarray(Image.open(path).convert('RGB'))`` (Pillow 12):

- PNM (numpy): P1-P6 with ``#`` comments; P1/P4 bilevel (1 is black);
  a maxval other than 255 scaled as Pillow's PPM decoders scale it
  (``round(v / maxval * 255)``, Python's rounding), greyscale above 255
  read into Pillow's 32-bit ``I`` mode (``* 65535``) and clipped at 255
  by its RGB conversion;
- GIF, the first frame: the LZW data (``csrc/lzw.cpp``), global and local
  colour tables, interlacing, on a canvas of the logical screen (grown to
  hold the frame, as Pillow grows it) that starts as the transparent index
  or 0; a table that is the identity grey ramp, or none, reads the indices
  as grey (Pillow's ``L``), any other is looked up (a transparent index
  shows its colour), indices past the table reading black;
- TIFF, baseline, the first page: compression none, PackBits, LZW (with
  or without predictor 2) and Deflate (8 and 32946), strips and tiles,
  photometric WhiteIsZero, BlackIsZero, RGB and palette at 8 bits
  (Pillow's ``ExtraSamples`` table: unspecified and unassociated alpha
  dropped, associated alpha divided out as Pillow's ``RGBa`` unpacker
  does) and bilevel at 1 bit;  JPEG-in-TIFF, CCITT and the other
  compressions, float and 16-bit samples, planar configuration 2, fill
  order 2 and BigTIFF raise a ``ValueError`` naming them;
- WebP: ``webp_decode`` (``csrc/webp.cpp``, see its header).

The two C++ libraries are host libraries (``host_library.build``: built
at first use, never at import; a failed build raises, nothing falls back).
``WEBP_DECODES`` counts the WebP library's decodes in this process.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from . import host_library

WEBP_SOURCE = host_library.CSRC / 'webp.cpp'
LZW_SOURCE = host_library.CSRC / 'lzw.cpp'
WEBP_DECODES = 0

_LIBS = {}
_ERR = 256
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library(name: str) -> ctypes.CDLL:
    """The loaded ``webp`` or ``lzw`` library, built on first use."""
    if name not in _LIBS:
        source = WEBP_SOURCE if name == 'webp' else LZW_SOURCE
        lib = ctypes.CDLL(str(host_library.build(source, name,
                                                 name.upper())))
        long_ = ctypes.c_long
        if name == 'webp':
            lib.webp_info.argtypes = [_U8P, long_, ctypes.POINTER(long_),
                                      ctypes.c_char_p, long_]
            lib.webp_info.restype = ctypes.c_int
            lib.webp_decode.argtypes = [_U8P, long_, _U8P, ctypes.c_char_p,
                                        long_]
            lib.webp_decode.restype = ctypes.c_int
        else:
            lib.lzw_decode.argtypes = [_U8P, long_, ctypes.c_int, _U8P,
                                       long_, ctypes.c_char_p, long_]
            lib.lzw_decode.restype = long_
        _LIBS[name] = lib
    return _LIBS[name]


def _ptr(array: np.ndarray):
    return array.ctypes.data_as(_U8P)


def webp_decode(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 RGB."""
    global WEBP_DECODES  # pylint: disable=global-statement
    lib = library('webp')
    buf = np.frombuffer(bytes(data), np.uint8)
    dims = (ctypes.c_long * 2)()
    err = ctypes.create_string_buffer(_ERR)
    if lib.webp_info(_ptr(buf), buf.size, dims, err, _ERR) != 0:
        raise ValueError(err.value.decode())
    out = np.empty((dims[0], dims[1], 3), np.uint8)
    WEBP_DECODES += 1
    if lib.webp_decode(_ptr(buf), buf.size, _ptr(out), err, _ERR) != 0:
        raise ValueError(err.value.decode())
    return out


def lzw_decode(data: bytes, size: int, min_code_size: int = 0) -> np.ndarray:
    """LZW data -> up to ``size`` bytes (fewer if the data ends first):
    GIF's codes for ``min_code_size`` 1..11, TIFF's for 0."""
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    n = library('lzw').lzw_decode(_ptr(buf), buf.size, min_code_size,
                                  _ptr(out), size, err, _ERR)
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:n]


def grey_rgb(grey: np.ndarray) -> np.ndarray:
    return np.repeat(grey.astype(np.uint8)[:, :, None], 3, 2)


def lookup(indices: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Palette lookup as Pillow's P -> RGB: indices past ``table`` (N, 3)
    read black."""
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(table), 256)] = table[:256]
    return full[indices]


# ------------------------------------------------------------------- PNM

PNM_WHITESPACE = b' \t\n\x0b\x0c\r'


def _pnm_token(data: bytes, pos: int):
    """Pillow's ``_read_token``: the next header token, skipping
    whitespace and comments; returns it and the position after the one
    whitespace byte that ends it."""
    token = b''
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in PNM_WHITESPACE:
            if not token:
                continue
            break
        if c == b'#':
            while pos < len(data) and data[pos:pos + 1] not in b'\r\n':
                pos += 1
            pos += 1
            continue
        token += c
    if not token or len(token) > 10:
        raise ValueError('PNM: bad header')
    return token, pos


def _plain_tokens(body: bytes) -> list:
    """The data tokens of a plain PNM file, comments removed."""
    out = []
    for line in body.replace(b'\r', b'\n').split(b'\n'):
        out.extend(line.split(b'#', 1)[0].split())
    return out


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``round(value / maxval * out_max)``, half to even."""
    return np.round(values.astype(np.float64) / maxval * out_max)


def read_pnm(data: bytes) -> np.ndarray:
    """PBM, PGM or PPM bytes (P1-P6) -> (H, W, 3) uint8 RGB."""
    magic = data[:2]
    if magic not in (b'P1', b'P2', b'P3', b'P4', b'P5', b'P6') or (
            len(data) > 2 and data[2:3] not in PNM_WHITESPACE):
        raise ValueError(f'PNM variant {data[:3]!r} is not supported: only '
                         'P1-P6 are read')
    kind = int(magic[1:])
    pos = 3
    token, pos = _pnm_token(data, pos)
    width = int(token)
    token, pos = _pnm_token(data, pos)
    height = int(token)
    bands = 3 if kind in (3, 6) else 1
    n = width * height * bands
    if kind in (1, 4):
        if kind == 1:
            bits = b''.join(_plain_tokens(data[pos:]))
            if bits.translate(None, b'01'):
                raise ValueError('PBM: a data token other than 0 and 1')
            if len(bits) < n:
                raise ValueError('PNM image data is truncated')
            ones = np.frombuffer(bits[:n], np.uint8) == ord('1')
        else:
            stride = (width + 7) // 8
            raw = np.frombuffer(data[pos:], np.uint8)
            if raw.size < stride * height:
                raise ValueError('PNM image data is truncated')
            ones = np.unpackbits(raw[:stride * height].reshape(height, stride),
                                 axis=1)[:, :width] == 1
        return grey_rgb(np.where(ones, 0, 255).reshape(height, width))
    token, pos = _pnm_token(data, pos)
    maxval = int(token)
    if not 0 < maxval < 65536:
        raise ValueError('PNM: maxval must be greater than 0 and less than '
                         '65536')
    # Pillow reads greyscale above 255 into its 32-bit mode, which its RGB
    # conversion clips at 255
    out_max = 65535 if bands == 1 and maxval > 255 else 255
    if kind in (2, 3):
        tokens = _plain_tokens(data[pos:])[:n]
        if len(tokens) < n:
            raise ValueError('PNM image data is truncated')
        values = np.array([int(t) for t in tokens], np.int64)
        if (values > maxval).any():
            raise ValueError('PNM: a channel value above maxval')
        values = _scale(values, maxval, out_max)
    else:
        dtype = np.dtype(np.uint8 if maxval < 256 else '>u2')
        raw = np.frombuffer(data[pos:pos + n * dtype.itemsize], dtype)
        if raw.size < n:
            raise ValueError('PNM image data is truncated')
        # Pillow's raw decoder for maxval 255 and for 16-bit greyscale,
        # its PPM decoder (values above maxval clipped) for the rest
        values = raw.copy()   # writable, as every reader's output
        if maxval != 255 and not (maxval == 65535 and bands == 1):
            values = np.minimum(_scale(raw, maxval, out_max), out_max)
    if values.dtype != np.uint8:
        values = np.minimum(values, 255).astype(np.uint8)
    if bands == 1:
        return grey_rgb(values.reshape(height, width))
    return values.reshape(height, width, 3)


# ------------------------------------------------------------------- GIF

def _gif_blocks(data: bytes, pos: int):
    """Data sub-blocks from ``pos``: their bytes and the position after
    the terminator."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        parts.append(data[pos:pos + n])
        pos += n
    return b''.join(parts), pos


def _is_ramp(table: bytes) -> bool:
    """Pillow's ``_is_palette_needed``, negated: entry i is (i, i, i)."""
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return bool((t == np.arange(len(t))[:, None]).all())


def read_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> (H, W, 3) uint8 RGB of the first frame."""
    if data[:6] not in (b'GIF87a', b'GIF89a') or len(data) < 13:
        raise ValueError('not a GIF file')
    width, height, flags = struct.unpack('<HHB', data[6:11])
    pos = 13
    palette = None  # None: grey indices
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        table = data[pos:pos + size]
        pos += size
        if not _is_ramp(table):
            palette = np.frombuffer(table, np.uint8).reshape(-1, 3)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError('GIF: no image in the file')
        kind = data[pos]
        if kind == 0x21:  # extension
            label = data[pos + 1]
            _, after = _gif_blocks(data, pos + 2)
            if label == 0xF9 and data[pos + 2] >= 4 and data[pos + 3] & 1:
                transparency = data[pos + 6]
            pos = after
            continue
        if kind != 0x2C:
            pos += 1  # Pillow skips stray bytes between blocks
            continue
        x0, y0, w, h, fflags = struct.unpack('<HHHHB', data[pos + 1:pos + 10])
        pos += 10
        if fflags & 0x80:
            size = 3 << ((fflags & 7) + 1)
            table = data[pos:pos + size]
            pos += size
            palette = None if _is_ramp(table) else np.frombuffer(
                table, np.uint8).reshape(-1, 3)
        interlace = bool(fflags & 0x40)
        min_code_size = data[pos]
        lzw, _ = _gif_blocks(data, pos + 1)
        break
    # Pillow grows the canvas to hold the frame
    width, height = max(width, x0 + w), max(height, y0 + h)
    pixels = lzw_decode(lzw, w * h, min_code_size)
    if pixels.size < w * h:   # PIL raises too
        raise ValueError('GIF: truncated image data')
    frame = pixels.reshape(h, w)
    if interlace:
        rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                               np.arange(2, h, 4), np.arange(1, h, 2)])
        deinterlaced = np.empty_like(frame)
        deinterlaced[rows] = frame
        frame = deinterlaced
    canvas = np.full((height, width), transparency or 0, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = frame
    if palette is None:
        return grey_rgb(canvas)
    return lookup(canvas, palette)


# ------------------------------------------------------------------ TIFF

TIFF_COMPRESSIONS = {
    1: 'none', 2: 'CCITT RLE', 3: 'CCITT Group 3 fax', 4: 'CCITT Group 4 fax',
    5: 'LZW', 6: 'old-style JPEG-in-TIFF', 7: 'JPEG-in-TIFF',
    8: 'Deflate', 32771: 'RLE-word', 32773: 'PackBits',
    32809: 'ThunderScan', 32946: 'Deflate', 34676: 'SGILog',
    34677: 'SGILog24', 34925: 'LZMA', 50000: 'Zstandard', 50001: 'WebP'}
TIFF_READ = (1, 5, 8, 32773, 32946)
# field type -> struct code
TIFF_TYPES = {1: 'B', 2: 'B', 3: 'H', 4: 'I', 5: 'II', 6: 'b', 7: 'B',
              8: 'h', 9: 'i', 10: 'ii', 11: 'f', 12: 'd'}


def _tiff_tags(data: bytes, order: str) -> dict:
    """The first IFD's tags: tag -> tuple of values."""
    offset, = struct.unpack(order + 'I', data[4:8])
    if offset + 2 > len(data):
        raise ValueError('TIFF: truncated directory')
    count, = struct.unpack(order + 'H', data[offset:offset + 2])
    tags = {}
    for i in range(count):
        entry = data[offset + 2 + 12 * i:offset + 14 + 12 * i]
        if len(entry) < 12:
            raise ValueError('TIFF: truncated directory')
        tag, kind, n = struct.unpack(order + 'HHI', entry[:8])
        if kind not in TIFF_TYPES:
            continue
        code = TIFF_TYPES[kind]
        size = struct.calcsize(order + code) * n
        body = entry[8:8 + size] if size <= 4 else data[
            struct.unpack(order + 'I', entry[8:12])[0]:][:size]
        if len(body) < size:
            raise ValueError('TIFF: truncated tag data')
        tags[tag] = struct.unpack(order + code * n, body)
    return tags


def _packbits(data: bytes, size: int) -> np.ndarray:
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos < len(data):
                out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return np.frombuffer(bytes(out[:size]), np.uint8)


def _tiff_chunk(raw: bytes, compression: int, size: int) -> np.ndarray:
    """One strip's or tile's bytes, decompressed and padded to ``size``."""
    if compression == 1:
        out = np.frombuffer(raw[:size], np.uint8)
    elif compression == 5:
        if raw[:2] == b'\x00\x01':
            raise ValueError('TIFF with old-style (LSB-first) LZW is not '
                             'supported')
        out = lzw_decode(raw, size)
    elif compression in (8, 32946):
        out = np.frombuffer(zlib.decompressobj().decompress(raw, size),
                            np.uint8)
    else:
        out = _packbits(raw, size)
    full = np.zeros(size, np.uint8)
    full[:out.size] = out
    return full


def read_tiff(data: bytes) -> np.ndarray:
    """Baseline TIFF bytes -> (H, W, 3) uint8 RGB of the first page."""
    if data[:4] in (b'II+\x00', b'MM\x00+'):
        raise ValueError('BigTIFF is not supported')
    if data[:4] not in (b'II*\x00', b'MM\x00*'):
        raise ValueError('not a TIFF file')
    order = '<' if data[:2] == b'II' else '>'
    tags = _tiff_tags(data, order)

    def tag(number, default=None):
        value = tags.get(number)
        if value is None:
            if default is None:
                raise ValueError(f'TIFF without tag {number}')
            return default
        return value

    width, height = tag(256)[0], tag(257)[0]
    compression = tag(259, (1,))[0]
    photometric = tag(262)[0]
    spp = tag(277, (1,))[0]
    bits = tag(258, (1,) * spp)
    sample_format = tag(339, (1,))[0]
    extra = tag(338, ())
    predictor = tag(317, (1,))[0]
    if compression not in TIFF_READ:
        name = TIFF_COMPRESSIONS.get(compression, f'compression {compression}')
        raise ValueError(f'TIFF with {name} compression is not supported')
    if sample_format != 1:
        kind = {2: 'signed integer', 3: 'float'}.get(sample_format,
                                                    f'format {sample_format}')
        raise ValueError(f'TIFF with {kind} samples is not supported')
    if tag(284, (1,))[0] != 1:
        raise ValueError('TIFF with planar configuration 2 (separate '
                         'planes) is not supported')
    if tag(266, (1,))[0] != 1:
        raise ValueError('TIFF with fill order 2 is not supported')
    if set(bits) - {8} and not (bits == (1,) and photometric in (0, 1)):
        raise ValueError(f'TIFF with {"/".join(map(str, bits))}-bit samples '
                         f'(photometric {photometric}) is not supported')
    # Pillow's modes for 8-bit samples: base channels, extra samples
    base = {0: 1, 1: 1, 2: 3, 3: 1}.get(photometric)
    if base is None:
        raise ValueError(f'TIFF with photometric interpretation {photometric}'
                         ' is not supported')
    if spp < base or (spp > base and len(extra) != spp - base and not (
            photometric == 2 and spp == 4 and not extra)):
        raise ValueError(f'TIFF with {spp} samples per pixel for photometric '
                         f'{photometric} is not supported')
    if predictor not in (1, 2) or (predictor == 2 and bits == (1,)):
        raise ValueError(f'TIFF with predictor {predictor} is not supported')

    depth = bits[0]
    if 322 in tags:  # tiles
        tw, th = tag(322)[0], tag(323)[0]
        offsets, counts = tag(324), tag(325)
        chunk_w, chunk_h = tw, th
        across = -(-width // tw)
        places = [((i // across) * th, (i % across) * tw)
                  for i in range(len(offsets))]
    else:
        rows = min(tag(278, (2 ** 32 - 1,))[0], height)
        offsets, counts = tag(273), tag(279)
        chunk_w, chunk_h = width, rows
        places = [(i * rows, 0) for i in range(len(offsets))]
    stride = (chunk_w * spp * depth + 7) // 8
    samples = np.zeros((height + chunk_h, width + chunk_w, spp), np.uint8)
    for (y, x), offset, count in zip(places, offsets, counts):
        if y >= height:
            continue
        raw = _tiff_chunk(data[offset:offset + count], compression,
                          stride * chunk_h).reshape(chunk_h, stride)
        if depth == 1:
            chunk = np.unpackbits(raw, axis=1)[:, :chunk_w, None]
        else:
            chunk = raw.reshape(chunk_h, chunk_w, spp)
            if predictor == 2:
                chunk = np.cumsum(chunk, axis=1, dtype=np.uint8)
        samples[y:y + chunk_h, x:x + chunk_w] = chunk
    samples = samples[:height, :width]
    if depth == 1:
        ones = samples[:, :, 0] == 1
        return grey_rgb(np.where(ones == (photometric == 1), 255, 0))
    if photometric == 0:
        return grey_rgb(255 - samples[:, :, 0])
    if photometric == 1:
        return grey_rgb(samples[:, :, 0])
    if photometric == 3:
        colours = np.array(tag(320), np.int64).reshape(3, -1).T // 256
        return lookup(samples[:, :, 0], colours.astype(np.uint8))
    rgb = samples[:, :, :3]
    if extra[:1] == (1,):  # associated alpha: Pillow's RGBa unpacker
        alpha = samples[:, :, 3:4].astype(np.int64)
        divided = np.minimum(rgb.astype(np.int64) * 255 // np.maximum(alpha, 1),
                             255)
        rgb = np.where(alpha == 0, 0, divided).astype(np.uint8)
    return np.ascontiguousarray(rgb)
