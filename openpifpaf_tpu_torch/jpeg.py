"""JPEG files without PIL: ctypes binding of ``csrc/jpeg.cpp``.

The machine with the card has no PIL, so the port decodes and encodes
JPEG itself.  ``decode`` gives, pixel for pixel, what the JAX package gets
from ``np.asarray(PIL.Image.open(path).convert('RGB'))``: the library
reproduces libjpeg-turbo's default decompression (islow IDCT, fancy
upsampling, table-based YCbCr->RGB; greyscale replicated).  It reads
baseline, extended and progressive Huffman files with 1, 3 or 4
components (CMYK, and YCCK by libjpeg's conversion, then Pillow's
inverted ``CMYK;I`` and its CMYK->RGB), any integral sampling factors up
to 4, restart intervals and custom tables, and skips APPn and COM
segments; it does not apply EXIF orientation (PIL's ``open`` does not
either).  It raises a ``ValueError`` naming the feature for arithmetic
coding, 12-bit, lossless and hierarchical files, DNL, a progressive file
whose scans leave coefficients approximate (libjpeg smooths those), and
truncated or corrupt data.

``encode`` writes what Pillow's ``save(buf, 'JPEG', quality=q)`` writes
with its defaults: JFIF, 4:2:0 (one component for a greyscale image), the
islow FDCT, the standard tables scaled by quality with baseline forced,
and the standard Huffman tables.

The library is a host library like the native painters
(``host_library.build``: at first use, never at import).  A failed build
or load raises with the compiler's output; nothing falls back to PIL or to
the plain version, ``jpeg_plain.py``, which the tests and ``chip_smoke.py``
hold the library to.  ``DECODES`` counts the library's decodes in this
process.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import host_library

SOURCE = host_library.CSRC / 'jpeg.cpp'

DECODES = 0

_LIB = None
_ERR = 256


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB  # pylint: disable=global-statement
    if _LIB is None:
        lib = ctypes.CDLL(str(host_library.build(SOURCE, 'jpeg', 'JPEG')))
        u8 = ctypes.POINTER(ctypes.c_uint8)
        long_ = ctypes.c_long
        lib.jpeg_info.argtypes = [u8, long_, ctypes.POINTER(long_),
                                  ctypes.c_char_p, long_]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [u8, long_, u8, ctypes.c_int,
                                    ctypes.c_char_p, long_]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [u8, long_, long_, ctypes.c_int,
                                    ctypes.c_int, u8, long_, ctypes.c_char_p,
                                    long_]
        lib.jpeg_encode.restype = long_
        _LIB = lib
    return _LIB


def _ptr(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ``decode``'s colour handling: as the file's markers say; the components
# as they are; YCbCr -> RGB whatever the markers say; the components as
# they are, each downsampled one repeated over its block
COLOURS = ('file', 'components', 'ycbcr', 'blocks')


def decode(data: bytes, colour: str = 'file') -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W, components) for
    ``colour='components'`` (libjpeg's ``JCS_UNKNOWN``, as libtiff reads
    JPEG-in-TIFF other than YCbCr; ``'ycbcr'`` is its
    ``JPEGCOLORMODE_RGB``) and ``'blocks'`` (libtiff's old-style JPEG,
    raw data through its RGBA interface)."""
    global DECODES  # pylint: disable=global-statement
    lib = library()
    buf = np.frombuffer(bytes(data), np.uint8)
    dims = (ctypes.c_long * 3)()
    err = ctypes.create_string_buffer(_ERR)
    if lib.jpeg_info(_ptr(buf), buf.size, dims, err, _ERR) != 0:
        raise ValueError(err.value.decode())
    channels = dims[2] if colour in ('components', 'blocks') else 3
    out = np.empty((dims[0], dims[1], channels), np.uint8)
    DECODES += 1
    if lib.jpeg_decode(_ptr(buf), buf.size, _ptr(out), COLOURS.index(colour),
                       err, _ERR) != 0:
        raise ValueError(err.value.decode())
    return out


def encode(image: np.ndarray, quality: int = 75) -> bytes:
    """(H, W, 3) RGB or (H, W) / (H, W, 1) greyscale uint8 -> JPEG bytes
    at ``quality`` (1..100)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] not in (1, 3)):
        raise ValueError('JPEG encoder: (H, W), (H, W, 1) or (H, W, 3) '
                         f'uint8 expected, not {image.dtype} {image.shape}')
    lib = library()
    image = np.ascontiguousarray(image)
    height, width = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    err = ctypes.create_string_buffer(_ERR)
    cap = 2 * image.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(_ptr(image), height, width, channels,
                            int(quality), _ptr(out), cap, err, _ERR)
        if n == -1:
            raise ValueError(err.value.decode())
        if n >= 0:
            return out[:n].tobytes()
        cap = -n
