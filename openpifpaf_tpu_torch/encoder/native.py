"""ctypes binding of the native (C++) target painters.

Port of ``openpifpaf_tpu/encoder/native.py``: the CIF and CAF painting loops
of ``cif.py`` and ``caf.py`` in ``csrc/encoders.cpp``, a shared library with
a plain C interface (no Python or PyTorch headers), bound with ctypes.  It
is built at first use, never at import, with the host's C++ compiler
(``$CXX``, else ``c++``) and the JAX package's flags, by
``host_library.build``.

Unlike the JAX package, which falls back to numpy when the build fails
(``native.py:40-52``), a failed build or load raises with the compiler's
output: ``use_native=False`` on an encoder is the way to choose the numpy
painters.  ``PAINTS`` counts the images painted here, per process.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import host_library

SOURCE = host_library.CSRC / 'encoders.cpp'

PAINTS = 0   # images painted by the native library in this process

_LIB = None


def library_path():
    return host_library.library_path(SOURCE, 'encoders')


def build():
    """Compile ``csrc/encoders.cpp`` unless it is built; raises with the
    compiler's output when it fails."""
    return host_library.build(
        SOURCE, 'encoders', 'native painters',
        '; pass use_native=False for the numpy painters')


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB  # pylint: disable=global-statement
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32 = ctypes.POINTER(ctypes.c_float)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        size = [ctypes.c_long] * 4
        outputs = [f32, u8, f32, u8, f32, u8, f32]
        lib.paint_cif.argtypes = [f32, f32, f32, *size, ctypes.c_long,
                                  ctypes.c_float, *outputs]
        lib.paint_cif.restype = None
        lib.paint_caf.argtypes = [f32, f32, f32, i32, *size, ctypes.c_long,
                                  ctypes.c_float, ctypes.c_float, *outputs]
        lib.paint_caf.restype = None
        _LIB = lib
    return _LIB


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def _check_outputs(n_fields: int, h: int, w: int, conf, conf_mask, vec,
                   vec_mask, scale, scale_mask) -> None:
    """The library writes through raw pointers: each target must be a
    C-contiguous array of the layout ``encoders.cpp`` indexes."""
    n_vec = vec.shape[1]
    expected = ((conf, np.float32, (n_fields, h, w)),
                (conf_mask, np.bool_, (n_fields, h, w)),
                (vec, np.float32, (n_fields, n_vec, 2, h, w)),
                (vec_mask, np.bool_, (n_fields, n_vec, h, w)),
                (scale, np.float32, (n_fields, n_vec, h, w)),
                (scale_mask, np.bool_, (n_fields, n_vec, h, w)))
    for array, dtype, shape in expected:
        if (array.dtype != dtype or array.shape != shape
                or not array.flags.c_contiguous):
            raise ValueError(f'native painters: a target of {array.dtype} '
                             f'{array.shape} where C-contiguous {dtype} '
                             f'{shape} was expected')


def _outputs(conf, conf_mask, vec, vec_mask, scale, scale_mask, closest):
    return (_ptr(conf, ctypes.c_float),
            _ptr(conf_mask.view(np.uint8), ctypes.c_uint8),
            _ptr(vec, ctypes.c_float),
            _ptr(vec_mask.view(np.uint8), ctypes.c_uint8),
            _ptr(scale, ctypes.c_float),
            _ptr(scale_mask.view(np.uint8), ctypes.c_uint8),
            _ptr(closest, ctypes.c_float))


def paint_cif(kp_sets, inst_scales, sigmas, *, h, w, side_length,
              v_threshold, conf, conf_mask, vec, vec_mask, scale,
              scale_mask) -> None:
    """CIF painting of one image into the given targets, in place."""
    global PAINTS  # pylint: disable=global-statement
    lib = library()
    k = len(sigmas)
    _check_outputs(k, h, w, conf, conf_mask, vec, vec_mask, scale,
                   scale_mask)
    PAINTS += 1
    if not kp_sets:
        return
    kps = np.ascontiguousarray(np.stack(kp_sets), np.float32)
    inst = np.ascontiguousarray(inst_scales, np.float32)
    sig = np.ascontiguousarray(sigmas, np.float32)
    if kps.shape[1:] != (k, 3) or inst.shape != (kps.shape[0],):
        raise ValueError(f'native painters: keypoints {kps.shape} and '
                         f'scales {inst.shape} for {k} fields')
    closest = np.full((k, h, w), np.inf, np.float32)
    lib.paint_cif(
        _ptr(kps, ctypes.c_float), _ptr(inst, ctypes.c_float),
        _ptr(sig, ctypes.c_float), kps.shape[0], k, h, w, side_length,
        v_threshold, *_outputs(conf, conf_mask, vec, vec_mask, scale,
                               scale_mask, closest))


def paint_caf(kp_sets, inst_scales, sigmas, skeleton, *, h, w, min_size,
              v_threshold, conf, conf_mask, vec, vec_mask, scale,
              scale_mask) -> None:
    """CAF painting of one image into the given targets, in place;
    ``skeleton`` (E, 2) holds 0-based keypoint indices."""
    global PAINTS  # pylint: disable=global-statement
    lib = library()
    skel = np.ascontiguousarray(skeleton, np.int32).reshape(-1, 2)
    e = skel.shape[0]
    _check_outputs(e, h, w, conf, conf_mask, vec, vec_mask, scale,
                   scale_mask)
    PAINTS += 1
    if not kp_sets:
        return
    kps = np.ascontiguousarray(np.stack(kp_sets), np.float32)
    inst = np.ascontiguousarray(inst_scales, np.float32)
    sig = np.ascontiguousarray(sigmas, np.float32)
    k = kps.shape[1]
    if (kps.shape[2] != 3 or inst.shape != (kps.shape[0],)
            or sig.shape != (k,) or (e and not 0 <= skel.min() <= skel.max()
                                     < k)):
        raise ValueError(f'native painters: keypoints {kps.shape}, scales '
                         f'{inst.shape}, sigmas {sig.shape} and a skeleton '
                         f'over {k} keypoints')
    closest = np.full((e, h, w), np.inf, np.float32)
    lib.paint_caf(
        _ptr(kps, ctypes.c_float), _ptr(inst, ctypes.c_float),
        _ptr(sig, ctypes.c_float), _ptr(skel, ctypes.c_int32),
        kps.shape[0], k, e, h, w, float(min_size), v_threshold,
        *_outputs(conf, conf_mask, vec, vec_mask, scale, scale_mask,
                  closest))
