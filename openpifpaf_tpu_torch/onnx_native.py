"""Native ONNX serialization of the port's models: no onnx dependency.

Port of ``openpifpaf_tpu/onnx_native.py``.  Reference parity:
``src/openpifpaf/export_onnx.py:~30`` exports the network to ONNX via
torch.  ``torch.onnx.export`` needs the ``onnx`` and ``onnxscript``
packages, so this module carries the JAX package's first-hand pieces:

- a minimal protobuf **wire-format encoder** emitting ``ModelProto`` per
  the canonical ``onnx.proto`` field numbers, and a matching **reader**
  (:func:`parse_model`), copied as they are (numpy only);
- a graph **builder** (``GraphBuilder`` and one emitter per backbone
  family, copied with JAX's layout arithmetic) that maps the port's
  modules onto standard NCHW ONNX ops.  ``build_model_graph`` reads the
  weights through ``models.to_jax_variables`` (flax's names and HWIO
  layouts, the ones the emitters index) and each backbone's configuration
  from the port's modules (``_configuration``), where the JAX emitters read
  the flax module's attributes;
- an **interpreter** (:func:`execute_model`) on torch, on any device, with
  the JAX interpreter's semantics op for op; ``export_onnx --verify`` runs
  the written file with it against the port's forward.
"""

from __future__ import annotations

import logging
import struct
from types import SimpleNamespace
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LOG = logging.getLogger(__name__)

OPSET_VERSION = 13
IR_VERSION = 8

# TensorProto.DataType
FLOAT = 1
INT64 = 7

# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS, _AT_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    if value < 0:  # int64 two's complement (10 bytes)
        value += 1 << 64
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def f_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def f_string(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode('utf-8'))


def f_packed_varints(field: int, values) -> bytes:
    return f_bytes(field, b''.join(_varint(int(v)) for v in values))


def f_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack('<f', value)


# ---------------------------------------------------------------------------
# ONNX message builders (canonical onnx.proto field numbers)
# ---------------------------------------------------------------------------

def tensor_proto(name: str, array: np.ndarray) -> bytes:
    array = np.asarray(array)
    if array.dtype == np.int64 or array.dtype == np.int32:
        array = array.astype(np.int64)
        dtype = INT64
    else:
        array = array.astype(np.float32)
        dtype = FLOAT
    return (f_packed_varints(1, array.shape)        # dims
            + f_varint(2, dtype)                    # data_type
            + f_string(8, name)                     # name
            + f_bytes(9, array.tobytes()))          # raw_data (little-endian)


def _attr(name: str, atype: int, payload: bytes) -> bytes:
    return f_string(1, name) + payload + f_varint(20, atype)


def attr_int(name: str, value: int) -> bytes:
    return _attr(name, _AT_INT, f_varint(3, value))


def attr_float(name: str, value: float) -> bytes:
    return _attr(name, _AT_FLOAT, f_float(2, value))


def attr_string(name: str, value: str) -> bytes:
    return _attr(name, _AT_STRING, f_bytes(4, value.encode('utf-8')))


def attr_ints(name: str, values) -> bytes:
    # AttributeProto.ints: not packed in onnx.proto (proto3 with explicit
    # field encoding in the official file) — emit one varint per entry
    payload = b''.join(f_varint(8, int(v)) for v in values)
    return f_string(1, name) + payload + f_varint(20, _AT_INTS)


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = '', *attributes: bytes) -> bytes:
    out = b''.join(f_string(1, i) for i in inputs)
    out += b''.join(f_string(2, o) for o in outputs)
    out += f_string(3, name or f'{op_type}_{outputs[0]}')
    out += f_string(4, op_type)
    out += b''.join(f_bytes(5, a) for a in attributes)
    return out


def value_info(name: str, shape: Sequence[int], elem_type: int = FLOAT) -> bytes:
    dims = b''.join(f_bytes(1, f_varint(1, int(d))) for d in shape)
    shape_proto = dims
    tensor_type = f_varint(1, elem_type) + f_bytes(2, shape_proto)
    type_proto = f_bytes(1, tensor_type)
    return f_string(1, name) + f_bytes(2, type_proto)


def graph_proto(name: str, nodes: List[bytes], initializers: List[bytes],
                inputs: List[bytes], outputs: List[bytes]) -> bytes:
    out = b''.join(f_bytes(1, n) for n in nodes)
    out += f_string(2, name)
    out += b''.join(f_bytes(5, t) for t in initializers)
    out += b''.join(f_bytes(11, i) for i in inputs)
    out += b''.join(f_bytes(12, o) for o in outputs)
    return out


def model_proto(graph: bytes, *, producer: str = 'openpifpaf_tpu_torch',
                opset: int = OPSET_VERSION) -> bytes:
    opset_id = f_string(1, '') + f_varint(2, opset)
    return (f_varint(1, IR_VERSION)
            + f_string(2, producer)
            + f_bytes(7, graph)
            + f_bytes(8, opset_id))


# ---------------------------------------------------------------------------
# wire-format reader (inspection + the test interpreter)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    shift = result = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _walk(buf: bytes):
    """Yield (field, wire, value) over one message's fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack('<f', buf[pos:pos + 4])[0]
            pos += 4
        else:  # pragma: no cover - wire types we never emit
            raise ValueError(f'unsupported wire type {wire}')
        yield field, wire, value


def _parse_tensor(buf: bytes) -> Dict:
    dims, dtype, name, raw = [], FLOAT, '', b''
    for field, wire, value in _walk(buf):
        if field == 1:
            if wire == 2:   # packed
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    dims.append(v)
            else:
                dims.append(value)
        elif field == 2:
            dtype = value
        elif field == 8:
            name = value.decode('utf-8')
        elif field == 9:
            raw = value
    np_dtype = np.float32 if dtype == FLOAT else np.int64
    array = np.frombuffer(raw, np_dtype).reshape(dims)
    return {'name': name, 'array': array}


def _parse_attr(buf: bytes) -> Dict:
    out = {'name': '', 'ints': []}
    for field, _, value in _walk(buf):
        if field == 1:
            out['name'] = value.decode('utf-8')
        elif field == 2:
            out['f'] = value
        elif field == 3:
            out['i'] = value
        elif field == 4:
            out['s'] = value.decode('utf-8')
        elif field == 8:
            out['ints'].append(value)
    return out


def _parse_node(buf: bytes) -> Dict:
    out = {'inputs': [], 'outputs': [], 'op_type': '', 'attrs': {}}
    for field, _, value in _walk(buf):
        if field == 1:
            out['inputs'].append(value.decode('utf-8'))
        elif field == 2:
            out['outputs'].append(value.decode('utf-8'))
        elif field == 4:
            out['op_type'] = value.decode('utf-8')
        elif field == 5:
            attr = _parse_attr(value)
            out['attrs'][attr['name']] = attr
    return out


def _parse_value_info(buf: bytes) -> Dict:
    name, shape = '', []
    for field, _, value in _walk(buf):
        if field == 1:
            name = value.decode('utf-8')
        elif field == 2:
            for f2, _, tensor_type in _walk(value):
                if f2 != 1:
                    continue
                for f3, _, shape_buf in _walk(tensor_type):
                    if f3 != 2:
                        continue
                    for f4, _, dim_buf in _walk(shape_buf):
                        if f4 != 1:
                            continue
                        for f5, _, dim_value in _walk(dim_buf):
                            if f5 == 1:
                                shape.append(dim_value)
    return {'name': name, 'shape': shape}


def parse_model(data: bytes) -> Dict:
    """Parse an emitted ONNX file back into plain dicts."""
    out = {'nodes': [], 'initializers': {}, 'inputs': [], 'outputs': [],
           'opset': None, 'ir_version': None}
    for field, _, value in _walk(data):
        if field == 1:
            out['ir_version'] = value
        elif field == 8:
            for f2, _, v2 in _walk(value):
                if f2 == 2:
                    out['opset'] = v2
        elif field == 7:
            for f2, _, v2 in _walk(value):
                if f2 == 1:
                    out['nodes'].append(_parse_node(v2))
                elif f2 == 5:
                    t = _parse_tensor(v2)
                    out['initializers'][t['name']] = t['array']
                elif f2 == 11:
                    out['inputs'].append(_parse_value_info(v2))
                elif f2 == 12:
                    out['outputs'].append(_parse_value_info(v2))
    return out


# ---------------------------------------------------------------------------
# graph builder: the port's model -> ONNX
# ---------------------------------------------------------------------------

class GraphBuilder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._counter = 0

    def name(self, hint: str) -> str:
        self._counter += 1
        return f'{hint}_{self._counter}'

    def init_tensor(self, name: str, array: np.ndarray) -> str:
        self.initializers.append(tensor_proto(name, array))
        return name

    def conv(self, x: str, kernel_hwio: np.ndarray, name: str, *,
             strides=1, pads=0, groups=1, dilations=1,
             bias: np.ndarray = None) -> str:
        # flax HWIO -> ONNX OIHW.  Depthwise flax kernels are
        # (kh, kw, 1, C) with feature_group_count=C -> ONNX (C, 1, kh, kw)
        w = np.transpose(np.asarray(kernel_hwio), (3, 2, 0, 1))
        kh, kw = w.shape[2], w.shape[3]
        inputs = [x, self.init_tensor(f'{name}.weight', w)]
        if bias is not None:
            inputs.append(self.init_tensor(f'{name}.bias', np.asarray(bias)))
        out = self.name(name)
        s = strides if isinstance(strides, (list, tuple)) else (strides,) * 2
        p = pads if isinstance(pads, (list, tuple)) else (pads,) * 4
        d = dilations if isinstance(dilations, (list, tuple)) \
            else (dilations,) * 2
        self.nodes.append(node(
            'Conv', inputs, [out], name,
            attr_ints('kernel_shape', (kh, kw)),
            attr_ints('strides', s),
            attr_ints('pads', p),
            attr_ints('dilations', d),
            attr_int('group', groups)))
        return out

    def add(self, a: str, b: str) -> str:
        out = self.name('add')
        self.nodes.append(node('Add', [a, b], [out]))
        return out

    def max_pool(self, x: str, kernel: int, strides: int, pads: int) -> str:
        out = self.name('maxpool')
        self.nodes.append(node(
            'MaxPool', [x], [out], '',
            attr_ints('kernel_shape', (kernel,) * 2),
            attr_ints('strides', (strides,) * 2),
            attr_ints('pads', (pads,) * 4)))
        return out

    def batchnorm(self, x: str, params: Dict, stats: Dict, name: str,
                  epsilon: float = 1e-5) -> str:
        inputs = [
            x,
            self.init_tensor(f'{name}.scale', params['scale']),
            self.init_tensor(f'{name}.bias', params['bias']),
            self.init_tensor(f'{name}.mean', stats['mean']),
            self.init_tensor(f'{name}.var', stats['var']),
        ]
        out = self.name(name)
        self.nodes.append(node('BatchNormalization', inputs, [out], name,
                               attr_float('epsilon', epsilon)))
        return out

    def relu(self, x: str) -> str:
        out = self.name('relu')
        self.nodes.append(node('Relu', [x], [out]))
        return out

    def slice_channels(self, x: str, start: int, end: int) -> str:
        out = self.name('slice')
        pre = out + '.'
        self.nodes.append(node('Slice', [
            x,
            self.init_tensor(pre + 'starts', np.asarray([start], np.int64)),
            self.init_tensor(pre + 'ends', np.asarray([end], np.int64)),
            self.init_tensor(pre + 'axes', np.asarray([1], np.int64)),
        ], [out]))
        return out

    def slice_spatial(self, x: str, cut: int) -> str:
        """x[:, :, cut:H-cut+1, cut:W-cut+1] (upsample margin crop; ends
        use INT64_MAX - (cut-1) so the shape stays symbolic)."""
        out = self.name('crop')
        pre = out + '.'
        end = np.iinfo(np.int64).max if cut == 1 else -(cut - 1)
        self.nodes.append(node('Slice', [
            x,
            self.init_tensor(pre + 'starts',
                             np.asarray([cut, cut], np.int64)),
            self.init_tensor(pre + 'ends', np.asarray([end, end], np.int64)),
            self.init_tensor(pre + 'axes', np.asarray([2, 3], np.int64)),
        ], [out]))
        return out

    def concat_channels(self, xs: Sequence[str]) -> str:
        out = self.name('concat')
        self.nodes.append(node('Concat', list(xs), [out], '',
                               attr_int('axis', 1)))
        return out

    def reshape(self, x: str, shape: Sequence[int], out: str = None) -> str:
        out = out or self.name('reshape')
        shape_t = self.init_tensor(out + '.shape',
                                   np.asarray(shape, np.int64))
        self.nodes.append(node('Reshape', [x, shape_t], [out]))
        return out

    def transpose(self, x: str, perm: Sequence[int]) -> str:
        out = self.name('transpose')
        self.nodes.append(node('Transpose', [x], [out],
                               '', attr_ints('perm', perm)))
        return out

    def channel_shuffle(self, x: str, channels: int, h: int, w: int,
                        groups: int = 2) -> str:
        """torch/flax channel_shuffle: view C as (g, C/g), swap, flatten."""
        y = self.reshape(x, (1, groups, channels // groups, h, w))
        y = self.transpose(y, (0, 2, 1, 3, 4))
        return self.reshape(y, (1, channels, h, w))

    def depth_to_space_crd(self, x: str, blocksize: int) -> str:
        out = self.name('d2s')
        self.nodes.append(node('DepthToSpace', [x], [out], '',
                               attr_int('blocksize', blocksize),
                               attr_string('mode', 'CRD')))
        return out

    def clip(self, x: str, lo: float, hi: float) -> str:
        """Clip-13: min/max as inputs (relu6 = Clip(0, 6))."""
        out = self.name('clip')
        pre = out + '.'
        self.nodes.append(node('Clip', [
            x,
            self.init_tensor(pre + 'min', np.float32(lo)),
            self.init_tensor(pre + 'max', np.float32(hi)),
        ], [out]))
        return out

    def mul(self, a: str, b: str) -> str:
        out = self.name('mul')
        self.nodes.append(node('Mul', [a, b], [out]))
        return out

    def add_const(self, x: str, value: float) -> str:
        out = self.name('addc')
        c = self.init_tensor(out + '.c', np.float32(value))
        self.nodes.append(node('Add', [x, c], [out]))
        return out

    def mul_const(self, x: str, value: float) -> str:
        out = self.name('mulc')
        c = self.init_tensor(out + '.c', np.float32(value))
        self.nodes.append(node('Mul', [x, c], [out]))
        return out

    def sigmoid(self, x: str) -> str:
        out = self.name('sigmoid')
        self.nodes.append(node('Sigmoid', [x], [out]))
        return out

    def global_avg_pool(self, x: str) -> str:
        out = self.name('gap')
        self.nodes.append(node('GlobalAveragePool', [x], [out]))
        return out

    def sub(self, a: str, b: str) -> str:
        out = self.name('sub')
        self.nodes.append(node('Sub', [a, b], [out]))
        return out

    def div(self, a: str, b: str) -> str:
        out = self.name('div')
        self.nodes.append(node('Div', [a, b], [out]))
        return out

    def sqrt(self, x: str) -> str:
        out = self.name('sqrt')
        self.nodes.append(node('Sqrt', [x], [out]))
        return out

    def tanh(self, x: str) -> str:
        out = self.name('tanh')
        self.nodes.append(node('Tanh', [x], [out]))
        return out

    def erf(self, x: str) -> str:
        out = self.name('erf')
        self.nodes.append(node('Erf', [x], [out]))
        return out

    def reduce_mean(self, x: str, axes: Sequence[int]) -> str:
        out = self.name('rmean')
        self.nodes.append(node('ReduceMean', [x], [out], '',
                               attr_ints('axes', axes),
                               attr_int('keepdims', 1)))
        return out

    def reduce_sum(self, x: str, axes: Sequence[int]) -> str:
        """ReduceSum-13: axes as a second input tensor."""
        out = self.name('rsum')
        ax = self.init_tensor(out + '.axes', np.asarray(axes, np.int64))
        self.nodes.append(node('ReduceSum', [x, ax], [out], '',
                               attr_int('keepdims', 1)))
        return out

    def gather(self, x: str, indices, axis: int) -> str:
        out = self.name('gather')
        idx = self.init_tensor(out + '.idx',
                               np.asarray(indices, np.int64))
        self.nodes.append(node('Gather', [x, idx], [out], '',
                               attr_int('axis', axis)))
        return out

    def pad_zeros(self, x: str, pads: Sequence[int]) -> str:
        """Pad-13: ``pads`` is the full ONNX list (begins then ends)."""
        out = self.name('pad')
        p = self.init_tensor(out + '.pads', np.asarray(pads, np.int64))
        self.nodes.append(node('Pad', [x, p], [out], '',
                               attr_string('mode', 'constant')))
        return out

    def slice_axes(self, x: str, starts, ends, axes, steps=None) -> str:
        out = self.name('slicex')
        pre = out + '.'
        inputs = [
            x,
            self.init_tensor(pre + 'starts', np.asarray(starts, np.int64)),
            self.init_tensor(pre + 'ends', np.asarray(ends, np.int64)),
            self.init_tensor(pre + 'axes', np.asarray(axes, np.int64)),
        ]
        if steps is not None:
            inputs.append(self.init_tensor(pre + 'steps',
                                           np.asarray(steps, np.int64)))
        self.nodes.append(node('Slice', inputs, [out]))
        return out

    def concat(self, xs: Sequence[str], axis: int) -> str:
        out = self.name('concat')
        self.nodes.append(node('Concat', list(xs), [out], '',
                               attr_int('axis', axis)))
        return out

    def dense(self, x: str, p: Dict, name: str) -> str:
        """flax ``nn.Dense``: x @ kernel (+ bias), contracting the last
        axis (ONNX MatMul ND x 2D broadcast)."""
        w = self.init_tensor(f'{name}.weight',
                             np.asarray(p['kernel'], np.float32))
        y = self.matmul(x, w)
        if 'bias' in p:
            y = self.add(y, self.init_tensor(
                f'{name}.bias', np.asarray(p['bias'], np.float32)))
        return y

    def matmul(self, a: str, b: str) -> str:
        out = self.name('matmul')
        self.nodes.append(node('MatMul', [a, b], [out]))
        return out

    def softmax(self, x: str, axis: int) -> str:
        out = self.name('softmax')
        self.nodes.append(node('Softmax', [x], [out], '',
                               attr_int('axis', axis)))
        return out

    def avg_pool(self, x: str, kernel: int, strides: int,
                 pads4: Sequence[int]) -> str:
        """AveragePool with count_include_pad=1 (flax ``nn.avg_pool``
        divides by the full window size including padding)."""
        out = self.name('avgpool')
        self.nodes.append(node(
            'AveragePool', [x], [out], '',
            attr_ints('kernel_shape', (kernel,) * 2),
            attr_ints('strides', (strides,) * 2),
            attr_ints('pads', pads4),
            attr_int('count_include_pad', 1)))
        return out

    def hard_sigmoid(self, x: str) -> str:
        """relu6(x + 3) / 6 — same composition as
        ``models/mobilenet.py::hard_sigmoid`` so numerics match exactly."""
        return self.mul_const(self.clip(self.add_const(x, 3.0), 0.0, 6.0),
                              1.0 / 6.0)

    def hard_swish(self, x: str) -> str:
        return self.mul(x, self.hard_sigmoid(x))

    def silu(self, x: str) -> str:
        return self.mul(x, self.sigmoid(x))




def _ints(t) -> List[int]:
    return [int(v) for v in t.reshape(-1).tolist()]


def execute_model(model_dict: Dict, inputs: Dict, device='cpu') -> Dict:
    """Re-execute a parsed model (``parse_model`` output) on ``device``.

    The interpreter of ``openpifpaf_tpu/onnx_native.py:597-730`` on torch,
    for exactly the op set this exporter emits, with the same semantics op
    for op: asymmetric ``pads`` padded first, ``AveragePool`` dividing by
    the whole window (``count_include_pad`` 1), ``MaxPool`` padding with
    -inf, ``Sigmoid`` in float64, ``DepthToSpace`` in CRD order; every
    result is stored in float32.  ``inputs``: name -> array or tensor;
    returns output name -> float32 tensor on ``device``.
    """
    device = torch.device(device)

    def tensor(value):
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        return value.to(device)

    env = {name: tensor(value)
           for name, value in model_dict['initializers'].items()}
    env.update({name: tensor(value).float() for name, value in inputs.items()})

    def pad4(x, pads, value=0.0):
        """ONNX (top, left, bottom, right) spatial pads."""
        top, left, bottom, right = pads
        if not any(pads):
            return x
        return F.pad(x, (left, right, top, bottom), value=value)

    for n in model_dict['nodes']:
        op = n['op_type']
        ins = [env[i] if i else None for i in n['inputs']]
        a = n['attrs']
        if op == 'Conv':
            pads = a['pads']['ints']
            dil = tuple(a['dilations']['ints']) if 'dilations' in a \
                else (1, 1)
            out = F.conv2d(pad4(ins[0], pads), ins[1],
                           ins[2] if len(ins) > 2 else None,
                           stride=tuple(a['strides']['ints']), dilation=dil,
                           groups=int(a['group']['i']))
        elif op == 'BatchNormalization':
            x, scale, bias, mean, var = ins
            eps = a['epsilon']['f']
            out = ((x - mean[None, :, None, None])
                   / torch.sqrt(var[None, :, None, None] + eps)
                   * scale[None, :, None, None]
                   + bias[None, :, None, None])
        elif op == 'Relu':
            out = torch.relu(ins[0])
        elif op == 'Sigmoid':
            out = 1.0 / (1.0 + torch.exp(-ins[0].double()))
        elif op == 'Mul':
            out = ins[0] * ins[1]
        elif op == 'GlobalAveragePool':
            out = ins[0].mean(dim=(2, 3), keepdim=True)
        elif op == 'MatMul':
            out = torch.matmul(ins[0], ins[1])
        elif op == 'Softmax':
            ax = int(a['axis']['i'])
            e = torch.exp(ins[0] - ins[0].amax(dim=ax, keepdim=True))
            out = e / e.sum(dim=ax, keepdim=True)
        elif op == 'AveragePool':
            assert int(a['count_include_pad']['i']) == 1
            k = tuple(a['kernel_shape']['ints'])
            summed = F.avg_pool2d(pad4(ins[0], a['pads']['ints']), k,
                                  tuple(a['strides']['ints']),
                                  divisor_override=1)
            out = summed / float(k[0] * k[1])
        elif op == 'Clip':
            out = torch.clamp(ins[0], ins[1], ins[2])
        elif op == 'Add':
            out = ins[0] + ins[1]
        elif op == 'MaxPool':
            out = F.max_pool2d(
                pad4(ins[0], a['pads']['ints'], -float('inf')),
                tuple(a['kernel_shape']['ints']),
                tuple(a['strides']['ints']))
        elif op == 'Concat':
            out = torch.cat(ins, dim=int(a['axis']['i']))
        elif op == 'Slice':
            x = ins[0]
            starts, ends, axes = (_ints(t) for t in ins[1:4])
            steps = _ints(ins[4]) if len(ins) > 4 else [1] * len(starts)
            slices = [slice(None)] * x.dim()
            for s, e, ax, st in zip(starts, ends, axes, steps):
                e = None if e == np.iinfo(np.int64).max else e
                slices[ax] = slice(s, e, st)
            out = x[tuple(slices)]
        elif op == 'Sub':
            out = ins[0] - ins[1]
        elif op == 'Div':
            out = ins[0] / ins[1]
        elif op == 'Sqrt':
            out = torch.sqrt(ins[0])
        elif op == 'Tanh':
            out = torch.tanh(ins[0])
        elif op == 'Erf':
            out = torch.erf(ins[0])
        elif op == 'ReduceSum':
            out = ins[0].sum(dim=tuple(_ints(ins[1])),
                             keepdim=bool(a['keepdims']['i']))
        elif op == 'Gather':
            out = torch.index_select(ins[0], int(a['axis']['i']),
                                     ins[1].reshape(-1))
        elif op == 'ReduceMean':
            out = ins[0].mean(dim=tuple(a['axes']['ints']),
                              keepdim=bool(a['keepdims']['i']))
        elif op == 'Pad':
            assert a['mode']['s'] == 'constant'
            pads, r = _ints(ins[1]), ins[0].dim()
            out = F.pad(ins[0], [p for i in reversed(range(r))
                                 for p in (pads[i], pads[i + r])])
        elif op == 'Reshape':
            out = ins[0].reshape(_ints(ins[1]))
        elif op == 'Transpose':
            out = ins[0].permute(*a['perm']['ints'])
        elif op == 'DepthToSpace':
            assert a['mode']['s'] == 'CRD'
            b_ = int(a['blocksize']['i'])
            n_, c, h, w = ins[0].shape
            out = ins[0].reshape(n_, c // (b_ * b_), b_, b_, h, w)
            out = out.permute(0, 1, 4, 2, 5, 3)
            out = out.reshape(n_, c // (b_ * b_), h * b_, w * b_)
        else:
            raise NotImplementedError(op)
        env[n['outputs'][0]] = out.float()

    return {o['name']: env[o['name']] for o in model_dict['outputs']}


def _require(condition, message):
    if not condition:
        raise NotImplementedError(message)


def _conv_hw(size, k, p, s, d=1):
    return (size + 2 * p - (d * (k - 1) + 1)) // s + 1


def _emit_shufflenet(g: GraphBuilder, basenet, params, stats, input_hw):
    """ShuffleNetV2/V2K backbone -> (feature tensor name, h, w)."""
    ks = basenet.kernel_size
    pad = ks // 2
    conv_hw = _conv_hw

    def bn_relu(x, prefix):
        if basenet.norm == 'batchnorm':
            x = g.batchnorm(x, params[f'{prefix}_norm'],
                            stats[f'{prefix}_norm'],
                            f'basenet.{prefix}_norm')
        return g.relu(x)

    def block_bn(x, block, leaf):
        if basenet.norm == 'batchnorm':
            x = g.batchnorm(x, params[block][leaf], stats[block][leaf],
                            f'basenet.{block}.{leaf}')
        return x

    h, w = input_hw
    x = g.conv('input', params['conv1']['kernel'], 'basenet.conv1',
               strides=2, pads=1)
    h, w = conv_hw(h, 3, 1, 2), conv_hw(w, 3, 1, 2)
    x = bn_relu(x, 'conv1')

    channels_in = basenet.stages_out_channels[0]
    for stage_i, (repeats, out_ch) in enumerate(
            zip(basenet.stages_repeats, basenet.stages_out_channels[1:4]),
            start=2):
        for block_i in range(repeats):
            block = f'stage{stage_i}_{block_i}'
            p = params[block]
            branch_features = out_ch // 2
            if block_i == 0:    # stride-2 block
                b1 = g.conv(x, p['branch1_dwconv']['kernel'],
                            f'basenet.{block}.branch1_dwconv',
                            strides=2, pads=pad, groups=channels_in)
                b1 = block_bn(b1, block, 'branch1_dwnorm')
                b1 = g.conv(b1, p['branch1_conv']['kernel'],
                            f'basenet.{block}.branch1_conv')
                b1 = block_bn(b1, block, 'branch1_norm')
                b1 = g.relu(b1)
                x2 = x
                stride = 2
            else:               # stride-1 block: split channels
                b1 = g.slice_channels(x, 0, out_ch // 2)
                x2 = g.slice_channels(x, out_ch // 2, out_ch)
                stride = 1
            b2 = g.conv(x2, p['branch2_conv1']['kernel'],
                        f'basenet.{block}.branch2_conv1')
            b2 = block_bn(b2, block, 'branch2_norm1')
            b2 = g.relu(b2)
            b2 = g.conv(b2, p['branch2_dwconv']['kernel'],
                        f'basenet.{block}.branch2_dwconv',
                        strides=stride, pads=pad, groups=branch_features)
            b2 = block_bn(b2, block, 'branch2_dwnorm')
            b2 = g.conv(b2, p['branch2_conv2']['kernel'],
                        f'basenet.{block}.branch2_conv2')
            b2 = block_bn(b2, block, 'branch2_norm2')
            b2 = g.relu(b2)
            if stride == 2:
                h, w = conv_hw(h, ks, pad, 2), conv_hw(w, ks, pad, 2)
            x = g.concat_channels([b1, b2])
            x = g.channel_shuffle(x, out_ch, h, w)
        channels_in = out_ch

    x = g.conv(x, params['conv5']['kernel'], 'basenet.conv5')
    x = bn_relu(x, 'conv5')
    return x, h, w


def _emit_resnet(g: GraphBuilder, basenet, params, stats, input_hw):
    """ResNet-{50,101,152} trunk -> (feature tensor name, h, w)."""
    conv_hw = _conv_hw

    def bn(x, prefix, block=None):
        if basenet.norm != 'batchnorm':
            return x
        p = params[block][prefix] if block else params[prefix]
        s = stats[block][prefix] if block else stats[prefix]
        name = f'basenet.{block}.{prefix}' if block else f'basenet.{prefix}'
        return g.batchnorm(x, p, s, name)

    h, w = input_hw
    s0 = basenet.input_conv_stride
    x = g.conv('input', params['conv1']['kernel'], 'basenet.conv1',
               strides=s0, pads=3)
    h, w = conv_hw(h, 7, 3, s0), conv_hw(w, 7, 3, s0)
    x = g.relu(bn(x, 'bn1'))
    if basenet.pool0_stride > 1:
        x = g.max_pool(x, 3, basenet.pool0_stride, 1)
        h = conv_hw(h, 3, 1, basenet.pool0_stride)
        w = conv_hw(w, 3, 1, basenet.pool0_stride)

    channels = (256, 512, 1024, 2048)
    strides = (1, 2, 2, 2 if basenet.block5_dilation == 1 else 1)
    dilations = (1, 1, 1, basenet.block5_dilation)
    for stage_i, (n_blocks, stride, dil) in enumerate(
            zip(basenet.layers, strides, dilations), start=1):
        for block_i in range(n_blocks):
            block = f'layer{stage_i}_{block_i}'
            p = params[block]
            s = stride if block_i == 0 else 1
            y = g.conv(x, p['conv1']['kernel'], f'basenet.{block}.conv1')
            y = g.relu(bn(y, 'bn1', block))
            y = g.conv(y, p['conv2']['kernel'], f'basenet.{block}.conv2',
                       strides=s, pads=dil, dilations=dil)
            y = g.relu(bn(y, 'bn2', block))
            y = g.conv(y, p['conv3']['kernel'], f'basenet.{block}.conv3')
            y = bn(y, 'bn3', block)
            if 'downsample_conv' in p:
                residual = g.conv(x, p['downsample_conv']['kernel'],
                                  f'basenet.{block}.downsample_conv',
                                  strides=s)
                residual = bn(residual, 'downsample_bn', block)
            else:
                residual = x
            x = g.relu(g.add(y, residual))
            if block_i == 0:
                h = conv_hw(h, 3, dil, s, dil)
                w = conv_hw(w, 3, dil, s, dil)
    return x, h, w


def _emit_mhsa(g: GraphBuilder, x: str, p: Dict, name: str, *,
               dim: int, h: int, w: int) -> str:
    """BoTNet all2all attention (``models/botnet.py::MHSA2D``) at a static
    export shape: the relative position embeddings are resized to the
    feature map with the port module's linear resize matrix (that of
    ``jax.image.resize(..., 'linear')``), then baked as initializers, so
    the emitted graph needs only MatMul/Softmax/Add/Reshape/Transpose."""
    from .models.botnet import linear_resize_matrix

    # head count from the checkpoint itself (rel_h is (num_heads, head_dim,
    # base)); a hardcoded default would silently mis-export a BotNet variant
    # configured with a different num_heads.
    num_heads = int(np.asarray(p['rel_h']).shape[0])
    head_dim = dim // num_heads
    n = h * w
    scale = float(head_dim) ** -0.5

    def heads(t):   # (1, dim, h, w) -> (num_heads, n, head_dim)
        t = g.reshape(t, (num_heads, head_dim, n))
        return g.transpose(t, (0, 2, 1))

    # q is pre-scaled once: both the content logits and the position
    # logits carry the same head_dim**-0.5 factor in the flax module.
    q = heads(g.conv(x, p['q']['kernel'], f'{name}.q'))
    q = g.mul_const(q, scale)
    k = heads(g.conv(x, p['k']['kernel'], f'{name}.k'))
    v = heads(g.conv(x, p['v']['kernel'], f'{name}.v'))

    logits = g.matmul(q, g.transpose(k, (0, 2, 1)))     # (heads, n, n)

    rel = {}
    for axis_name, size in (('rel_h', h), ('rel_w', w)):
        table = np.asarray(p[axis_name], np.float32)
        baked = table @ linear_resize_matrix(table.shape[-1], size)
        rel[axis_name] = g.init_tensor(f'{name}.{axis_name}_resized', baked)
    ph = g.matmul(q, rel['rel_h'])                      # (heads, n, h)
    pw = g.matmul(q, rel['rel_w'])                      # (heads, n, w)
    pos = g.add(g.reshape(ph, (num_heads, n, h, 1)),
                g.reshape(pw, (num_heads, n, 1, w)))
    pos = g.reshape(pos, (num_heads, n, n))

    attn = g.softmax(g.add(logits, pos), axis=2)
    y = g.matmul(attn, v)                               # (heads, n, head_dim)
    y = g.transpose(y, (0, 2, 1))
    return g.reshape(y, (1, dim, h, w))


def _emit_ln(g: GraphBuilder, x: str, p: Dict, name: str, axis: int,
             eps: float = 1e-6) -> str:
    """flax ``nn.LayerNorm`` over the given axis (epsilon 1e-6, the flax
    default; the Swin path passes 1e-5 — microsoft/reference parity),
    decomposed to opset-13 ops (LayerNormalization is opset >= 17)."""
    mean = g.reduce_mean(x, (axis,))
    d = g.sub(x, mean)
    var = g.reduce_mean(g.mul(d, d), (axis,))
    y = g.div(d, g.sqrt(g.add_const(var, eps)))
    y = g.mul(y, g.init_tensor(f'{name}.scale',
                               np.asarray(p['scale'], np.float32)))
    return g.add(y, g.init_tensor(f'{name}.bias',
                                  np.asarray(p['bias'], np.float32)))


def _emit_gelu(g: GraphBuilder, x: str) -> str:
    """Exact (erf) GELU — reference transformer parity (the microsoft/timm
    implementations the reference vendors use ``nn.GELU()`` = erf form;
    the flax models pass ``approximate=False`` to match, r5)."""
    e = g.erf(g.mul_const(x, 0.7071067811865476))        # 1/sqrt(2)
    return g.mul(g.mul_const(x, 0.5), g.add_const(e, 1.0))


def _emit_roll(g: GraphBuilder, x: str, s: int, axis: int, size: int) -> str:
    """jnp.roll(x, -s, axis) == concat(x[s:], x[:s]); pass size-s for +s."""
    s = s % size
    if s == 0:
        return x
    hi = g.slice_axes(x, (s,), (size,), (axis,))
    lo = g.slice_axes(x, (0,), (s,), (axis,))
    return g.concat([hi, lo], axis=axis)


def _emit_swin_attn(g: GraphBuilder, x: str, p: Dict, name: str, *,
                    dim: int, heads: int, win: int, n_windows: int,
                    mask: np.ndarray) -> str:
    """Window attention (``models/swin.py::WindowAttention``): relative
    position bias and the shift mask are static, baked as initializers."""
    from .models.swin import relative_position_index

    l = win * win
    hd = dim // heads
    qkv = g.dense(x, p['qkv'], f'{name}.qkv')            # (nW, l, 3*dim)
    qkv = g.reshape(qkv, (n_windows, l, 3, heads, hd))

    def pick(i):
        t = g.slice_axes(qkv, (i,), (i + 1,), (2,))
        t = g.reshape(t, (n_windows, l, heads, hd))
        return g.transpose(t, (0, 2, 1, 3))              # (nW, heads, l, hd)

    q = g.mul_const(pick(0), float(hd) ** -0.5)
    k, v = pick(1), pick(2)

    attn = g.matmul(q, g.transpose(k, (0, 1, 3, 2)))     # (nW, heads, l, l)
    table = np.asarray(p['relative_position_bias_table'], np.float32)
    idx = relative_position_index(win).reshape(-1)
    bias = table[idx].reshape(l, l, heads).transpose(2, 0, 1)[None]
    attn = g.add(attn, g.init_tensor(f'{name}.rel_bias', bias))
    if mask is not None:
        attn = g.add(attn, g.init_tensor(
            f'{name}.shift_mask',
            np.asarray(mask, np.float32)[:, None]))      # (nW, 1, l, l)
    attn = g.softmax(attn, axis=3)

    y = g.matmul(attn, v)                                # (nW, heads, l, hd)
    y = g.reshape(g.transpose(y, (0, 2, 1, 3)), (n_windows, l, dim))
    return g.dense(y, p['proj'], f'{name}.proj')


def _emit_swin_block(g: GraphBuilder, x: str, p: Dict, name: str, *,
                     h: int, w: int, dim: int, heads: int, win: int,
                     shift: int) -> str:
    """One SwinBlock on a (1, h, w, dim) channels-last tensor."""
    from .models.swin import shift_mask

    shortcut = x
    x = _emit_ln(g, x, p['norm1'], f'{name}.norm1', axis=3, eps=1e-5)

    pad_h = (win - h % win) % win
    pad_w = (win - w % win) % win
    if pad_h or pad_w:
        x = g.pad_zeros(x, (0, 0, 0, 0, 0, pad_h, pad_w, 0))
    hp, wp = h + pad_h, w + pad_w

    mask = None
    if shift > 0:
        x = _emit_roll(g, x, shift, 1, hp)
        x = _emit_roll(g, x, shift, 2, wp)
        mask = shift_mask(hp, wp, win, shift)

    nh, nw = hp // win, wp // win
    x = g.reshape(x, (1, nh, win, nw, win, dim))
    x = g.transpose(x, (0, 1, 3, 2, 4, 5))
    x = g.reshape(x, (nh * nw, win * win, dim))
    x = _emit_swin_attn(g, x, p['attn'], f'{name}.attn', dim=dim,
                        heads=heads, win=win, n_windows=nh * nw, mask=mask)
    x = g.reshape(x, (1, nh, nw, win, win, dim))
    x = g.transpose(x, (0, 1, 3, 2, 4, 5))
    x = g.reshape(x, (1, hp, wp, dim))

    if shift > 0:
        x = _emit_roll(g, x, hp - shift, 1, hp)
        x = _emit_roll(g, x, wp - shift, 2, wp)
    if pad_h or pad_w:
        x = g.slice_axes(x, (0, 0), (h, w), (1, 2))
    x = g.add(shortcut, x)

    y = _emit_ln(g, x, p['norm2'], f'{name}.norm2', axis=3, eps=1e-5)
    y = g.dense(y, p['mlp_fc1'], f'{name}.mlp_fc1')
    y = _emit_gelu(g, y)
    y = g.dense(y, p['mlp_fc2'], f'{name}.mlp_fc2')
    return g.add(x, y)


def _emit_swin(g: GraphBuilder, basenet, params, stats, input_hw):
    """Swin trunk (``models/swin.py``) at a static export shape.  The
    whole trunk runs channels-last inside the graph (pure Reshape/
    Transpose/MatMul ops) and transposes back to NCHW for the heads."""
    h0, w0 = input_hw
    # flax nn.Conv default 'SAME' padding at stride 4
    h, w = -(-h0 // 4), -(-w0 // 4)
    tot_h = max(0, (h - 1) * 4 + 4 - h0)
    tot_w = max(0, (w - 1) * 4 + 4 - w0)
    x = g.conv('input', params['patch_embed']['kernel'],
               'basenet.patch_embed', strides=4,
               pads=(tot_h // 2, tot_w // 2,
                     tot_h - tot_h // 2, tot_w - tot_w // 2),
               bias=params['patch_embed']['bias'])
    x = g.transpose(x, (0, 2, 3, 1))                    # (1, h, w, C)
    x = _emit_ln(g, x, params['patch_norm'], 'basenet.patch_norm', axis=3,
                 eps=1e-5)

    for stage_i, (depth, heads) in enumerate(
            zip(basenet.depths, basenet.num_heads)):
        dim = basenet.embed_dim * (2 ** min(stage_i, 3))
        if stage_i > 0:
            if stage_i < 3:
                # PatchMerging: 2x2 neighborhood concat -> LN -> reduce
                mname = f'merge{stage_i}'
                mp = params[mname]
                pad_h, pad_w = h % 2, w % 2
                if pad_h or pad_w:
                    x = g.pad_zeros(x, (0, 0, 0, 0, 0, pad_h, pad_w, 0))
                hp, wp = h + pad_h, w + pad_w
                parts = [
                    g.slice_axes(x, (sh, sw), (hp, wp), (1, 2), (2, 2))
                    for sh, sw in ((0, 0), (1, 0), (0, 1), (1, 1))]
                x = g.concat(parts, axis=3)
                x = _emit_ln(g, x, mp['norm'], f'basenet.{mname}.norm',
                             axis=3, eps=1e-5)
                x = g.dense(x, mp['reduction'], f'basenet.{mname}.reduction')
                h, w = hp // 2, wp // 2
            else:
                x = g.dense(x, params[f'merge{stage_i}_proj'],
                            f'basenet.merge{stage_i}_proj')
        for block_i in range(depth):
            bname = f'stage{stage_i}_block{block_i}'
            x = _emit_swin_block(
                g, x, params[bname], f'basenet.{bname}', h=h, w=w, dim=dim,
                heads=heads, win=basenet.window,
                shift=0 if block_i % 2 == 0 else basenet.window // 2)

    x = _emit_ln(g, x, params['norm_out'], 'basenet.norm_out', axis=3,
                 eps=1e-5)
    return g.transpose(x, (0, 3, 1, 2)), h, w


def _nearest_resize_idx(src: int, dst: int) -> np.ndarray:
    """Static nearest-neighbor index map with the semantics of
    ``jax.image.resize(..., 'nearest')`` (the port module's rule)."""
    from .models.hrformer import nearest_index

    return nearest_index(src, dst)


def _emit_hrformer(g: GraphBuilder, basenet, params, stats, input_hw):
    """HRFormer trunk (``models/hrformer.py``): conv stem + bottleneck
    stage 1, then multi-resolution branches of window-attention blocks
    with cross-resolution fusion; all branches gathered to stride 16.
    Nearest upsampling is emitted as static Gather index maps."""
    c = basenet.base_channels
    win = basenet.window

    def bn(x, leaf):
        if basenet.norm != 'batchnorm':
            return x
        return g.batchnorm(x, params[leaf], stats[leaf], f'basenet.{leaf}')

    def bnb(x, block, leaf):
        if basenet.norm != 'batchnorm':
            return x
        return g.batchnorm(x, params[block][leaf], stats[block][leaf],
                           f'basenet.{block}.{leaf}')

    def nearest(x, sh, sw, th, tw):
        if sh != th:
            x = g.gather(x, _nearest_resize_idx(sh, th), axis=2)
        if sw != tw:
            x = g.gather(x, _nearest_resize_idx(sw, tw), axis=3)
        return x

    def hrblock(x, hh, ww, dim, heads, p, name):
        """One HRFormerBlock on an NCHW branch tensor."""
        xs = g.transpose(x, (0, 2, 3, 1))               # NHWC
        y = _emit_ln(g, xs, p['norm1'], f'{name}.norm1', axis=3)
        pad_h = (win - hh % win) % win
        pad_w = (win - ww % win) % win
        if pad_h or pad_w:
            y = g.pad_zeros(y, (0, 0, 0, 0, 0, pad_h, pad_w, 0))
        hp, wp = hh + pad_h, ww + pad_w
        nh, nw = hp // win, wp // win
        y = g.reshape(y, (1, nh, win, nw, win, dim))
        y = g.transpose(y, (0, 1, 3, 2, 4, 5))
        y = g.reshape(y, (nh * nw, win * win, dim))
        y = _emit_swin_attn(g, y, p['attn'], f'{name}.attn', dim=dim,
                            heads=heads, win=win, n_windows=nh * nw,
                            mask=None)
        y = g.reshape(y, (1, nh, nw, win, win, dim))
        y = g.transpose(y, (0, 1, 3, 2, 4, 5))
        y = g.reshape(y, (1, hp, wp, dim))
        if pad_h or pad_w:
            y = g.slice_axes(y, (0, 0), (hh, ww), (1, 2))
        xs = g.add(xs, y)

        # conv-MLP: 1x1 expand -> depthwise 3x3 -> 1x1 project
        hidden = int(dim * basenet.mlp_ratio)
        y = _emit_ln(g, xs, p['norm2'], f'{name}.norm2', axis=3)
        y = g.transpose(y, (0, 3, 1, 2))
        y = g.conv(y, p['mlp_fc1']['kernel'], f'{name}.mlp_fc1',
                   bias=p['mlp_fc1']['bias'])
        y = _emit_gelu(g, y)
        y = g.conv(y, p['mlp_dwconv']['kernel'], f'{name}.mlp_dwconv',
                   pads=1, groups=hidden, bias=p['mlp_dwconv']['bias'])
        y = _emit_gelu(g, y)
        y = g.conv(y, p['mlp_fc2']['kernel'], f'{name}.mlp_fc2',
                   bias=p['mlp_fc2']['bias'])
        return g.add(g.transpose(xs, (0, 3, 1, 2)), y)

    def fuse(branches, chans, fname):
        fp = params[fname]
        fs = stats.get(fname, {})

        def fbn(x, leaf):
            if basenet.norm != 'batchnorm':
                return x
            return g.batchnorm(x, fp[leaf], fs[leaf],
                               f'basenet.{fname}.{leaf}')

        outs = []
        for i, ci in enumerate(chans):
            acc, hi, wi, _ = branches[i]
            for j, (xj, hj, wj, _) in enumerate(branches):
                if j == i:
                    continue
                y, hh, ww = xj, hj, wj
                if j < i:                   # downsample with strided convs
                    for step in range(i - j):
                        leaf = f'down{j}to{i}_{step}'
                        y = g.conv(y, fp[leaf]['kernel'],
                                   f'basenet.{fname}.{leaf}',
                                   strides=2, pads=1)
                        hh, ww = _conv_hw(hh, 3, 1, 2), _conv_hw(ww, 3, 1, 2)
                        y = fbn(y, f'{leaf}_norm')
                        if step != i - j - 1:
                            y = g.relu(y)
                else:                       # 1x1 project + nearest upsample
                    leaf = f'up{j}to{i}'
                    y = g.conv(y, fp[leaf]['kernel'],
                               f'basenet.{fname}.{leaf}')
                    y = fbn(y, f'{leaf}_norm')
                    y = nearest(y, hh, ww, hi, wi)
                acc = g.add(acc, y)
            outs.append((g.relu(acc), hi, wi, ci))
        return outs

    # stem to stride 4
    h, w = input_hw
    x = g.conv('input', params['stem1']['kernel'], 'basenet.stem1',
               strides=2, pads=1)
    h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
    x = g.relu(bn(x, 'stem1_norm'))
    x = g.conv(x, params['stem2']['kernel'], 'basenet.stem2',
               strides=2, pads=1)
    h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
    x = g.relu(bn(x, 'stem2_norm'))

    # stage 1: conv bottlenecks
    for block_i in range(2):
        block = f'stage1_block{block_i}'
        p = params[block]
        y = g.conv(x, p['conv1']['kernel'], f'basenet.{block}.conv1')
        y = g.relu(bnb(y, block, 'norm1'))
        y = g.conv(y, p['conv2']['kernel'], f'basenet.{block}.conv2', pads=1)
        y = g.relu(bnb(y, block, 'norm2'))
        y = g.conv(y, p['conv3']['kernel'], f'basenet.{block}.conv3')
        y = bnb(y, block, 'norm3')
        if 'down' in p:
            x = g.conv(x, p['down']['kernel'], f'basenet.{block}.down')
            x = bnb(x, block, 'down_norm')
        x = g.relu(g.add(x, y))

    branches = [(x, h, w, 256)]
    for stage_i, n_modules in enumerate(basenet.num_modules, start=2):
        n_branches = stage_i
        chans = [c * (2 ** i) for i in range(n_branches)]
        new_branches = []
        for i, ch in enumerate(chans):
            if i < len(branches):
                y, hh, ww, chb = branches[i]
                if chb != ch:
                    leaf = f't{stage_i}_proj{i}'
                    y = g.conv(y, params[leaf]['kernel'],
                               f'basenet.{leaf}', pads=1)
                    y = g.relu(bn(y, f'{leaf}_norm'))
            else:
                yb, hb, wb, _ = branches[-1]
                leaf = f't{stage_i}_new{i}'
                y = g.conv(yb, params[leaf]['kernel'], f'basenet.{leaf}',
                           strides=2, pads=1)
                hh, ww = _conv_hw(hb, 3, 1, 2), _conv_hw(wb, 3, 1, 2)
                y = g.relu(bn(y, f'{leaf}_norm'))
            new_branches.append((y, hh, ww, ch))
        branches = new_branches

        for module_i in range(n_modules):
            run = []
            for i, (y, hh, ww, ch) in enumerate(branches):
                for block_i in range(basenet.blocks_per_module):
                    bname = (f's{stage_i}_m{module_i}_b{i}_blk{block_i}')
                    y = hrblock(y, hh, ww, ch, basenet.num_heads[i],
                                params[bname], f'basenet.{bname}')
                run.append((y, hh, ww, ch))
            branches = fuse(run, chans, f's{stage_i}_m{module_i}_fuse')

    # gather to stride 16 (branch 2) and concatenate
    _, h16, w16, _ = branches[2]
    outs = []
    for i, (y, hh, ww, ch) in enumerate(branches):
        if i < 2:
            for step in range(2 - i):
                leaf = f'out_down{i}_{step}'
                y = g.conv(y, params[leaf]['kernel'], f'basenet.{leaf}',
                           strides=2, pads=1)
                hh, ww = _conv_hw(hh, 3, 1, 2), _conv_hw(ww, 3, 1, 2)
                y = g.relu(bn(y, f'{leaf}_norm'))
        elif i > 2:
            y = nearest(y, hh, ww, h16, w16)
        outs.append(y)
    return g.concat(outs, axis=1), h16, w16


def _emit_xcit(g: GraphBuilder, basenet, params, stats, input_hw):
    """XCiT trunk (``models/xcit.py``): conv stem to stride 16, Fourier
    positional encoding, then XCA (channel cross-covariance attention) +
    LPI + MLP blocks, each LayerScale-gated.  The XCA attention matrix is
    (head_dim, head_dim) — image-size independent.  The positional map
    depends only on the static export shape, so grid, projection and bias
    are folded into one baked initializer."""
    from .models.xcit import _fourier_grid

    dim = basenet.embed_dim
    heads = basenet.num_heads
    hd = dim // heads

    def bn(x, block, leaf):
        if basenet.norm != 'batchnorm':
            return x
        return g.batchnorm(x, params[block][leaf], stats[block][leaf],
                           f'basenet.{block}.{leaf}')

    # conv stem: four 3x3 stride-2 convs (gelu between, none after last)
    h, w = input_hw
    x = 'input'
    sp = params['stem']
    for i in range(4):
        x = g.conv(x, sp[f'conv{i}']['kernel'], f'basenet.stem.conv{i}',
                   strides=2, pads=1)
        h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
        x = bn(x, 'stem', f'norm{i}')
        if i < 3:
            x = _emit_gelu(g, x)
    n = h * w

    def xca(tokens, p, name):
        qkv = g.dense(tokens, p['qkv'], f'{name}.qkv')    # (1, n, 3*dim)
        qkv = g.reshape(qkv, (1, n, 3, heads, hd))

        def pick(i):
            t = g.slice_axes(qkv, (i,), (i + 1,), (2,))
            t = g.reshape(t, (1, n, heads, hd))
            return g.transpose(t, (0, 2, 3, 1))           # (1, heads, hd, n)

        def l2norm(t):
            # F.normalize semantics: clamp the norm, not add-epsilon
            nrm = g.sqrt(g.reduce_sum(g.mul(t, t), (3,)))
            return g.div(t, g.clip(nrm, 1e-12, 3.0e38))

        q, k, v = l2norm(pick(0)), l2norm(pick(1)), pick(2)
        attn = g.matmul(q, g.transpose(k, (0, 1, 3, 2)))  # (1,heads,hd,hd)
        attn = g.mul(attn, g.init_tensor(
            f'{name}.temperature',
            np.asarray(p['temperature'], np.float32)))
        attn = g.softmax(attn, axis=3)
        y = g.matmul(attn, v)                             # (1, heads, hd, n)
        y = g.reshape(g.transpose(y, (0, 3, 1, 2)), (1, n, dim))
        return g.dense(y, p['proj'], f'{name}.proj')

    def gamma_mul(y, p, leaf, name):
        return g.mul(y, g.init_tensor(
            f'{name}.{leaf}', np.asarray(p[leaf], np.float32)))

    # to channels-last tokens, + baked fourier positional map
    x = g.reshape(g.transpose(x, (0, 2, 3, 1)), (1, n, dim))
    pe = params['pos_embed']['token_projection']
    pos = (_fourier_grid(h, w, 32, 10000.0).reshape(n, 64)
           @ np.asarray(pe['kernel'], np.float32).reshape(64, dim)
           + np.asarray(pe['bias'], np.float32))
    x = g.add(x, g.init_tensor('basenet.pos_embed',
                               pos[None].astype(np.float32)))
    for i in range(basenet.depth):
        block = f'block{i}'
        p = params[block]
        name = f'basenet.{block}'
        # XCA (reference slot norm1 / gamma1)
        y = _emit_ln(g, x, p['norm1'], f'{name}.norm1', axis=2)
        y = xca(y, p['xca'], f'{name}.xca')
        x = g.add(x, gamma_mul(y, p, 'gamma1', name))

        # LPI (slot norm3 / gamma3): depthwise convs need the NCHW layout
        y = _emit_ln(g, x, p['norm3'], f'{name}.norm3', axis=2)
        y = g.transpose(g.reshape(y, (1, h, w, dim)), (0, 3, 1, 2))
        y = g.conv(y, p['lpi_conv1']['kernel'], f'{name}.lpi_conv1',
                   pads=1, groups=dim, bias=p['lpi_conv1']['bias'])
        y = _emit_gelu(g, y)
        y = bn(y, block, 'lpi_bn')
        y = g.conv(y, p['lpi_conv2']['kernel'], f'{name}.lpi_conv2',
                   pads=1, groups=dim, bias=p['lpi_conv2']['bias'])
        y = g.reshape(g.transpose(y, (0, 2, 3, 1)), (1, n, dim))
        x = g.add(x, gamma_mul(y, p, 'gamma3', name))

        # MLP (slot norm2 / gamma2)
        y = _emit_ln(g, x, p['norm2'], f'{name}.norm2', axis=2)
        y = g.dense(y, p['mlp_fc1'], f'{name}.mlp_fc1')
        y = _emit_gelu(g, y)
        y = g.dense(y, p['mlp_fc2'], f'{name}.mlp_fc2')
        x = g.add(x, gamma_mul(y, p, 'gamma2', name))

    x = _emit_ln(g, x, params['norm_out'], 'basenet.norm_out', axis=2)
    return g.transpose(g.reshape(x, (1, h, w, dim)), (0, 3, 1, 2)), h, w


def _emit_botnet(g: GraphBuilder, basenet, params, stats, input_hw):
    """BotNet trunk (``models/botnet.py``): ResNet-50 stages 1-3, then a
    2x2 average pool and BoT blocks with MHSA in place of the 3x3 conv."""

    def bn(x, prefix, block=None):
        if basenet.norm != 'batchnorm':
            return x
        p = params[block][prefix] if block else params[prefix]
        s = stats[block][prefix] if block else stats[prefix]
        name = f'basenet.{block}.{prefix}' if block else f'basenet.{prefix}'
        return g.batchnorm(x, p, s, name)

    def bottleneck_tail(x, y, p, block, s=1):
        if 'downsample_conv' in p:
            residual = g.conv(x, p['downsample_conv']['kernel'],
                              f'basenet.{block}.downsample_conv', strides=s)
            residual = bn(residual, 'downsample_bn', block)
        else:
            residual = x
        return g.relu(g.add(y, residual))

    h, w = input_hw
    x = g.conv('input', params['conv1']['kernel'], 'basenet.conv1',
               strides=2, pads=3)
    h, w = _conv_hw(h, 7, 3, 2), _conv_hw(w, 7, 3, 2)
    x = g.relu(bn(x, 'bn1'))

    channels = (256, 512, 1024)
    strides = (1, 2, 2)
    for stage_i, (n_blocks, _, stride) in enumerate(
            zip(basenet.layers[:3], channels, strides), start=1):
        for block_i in range(n_blocks):
            block = f'layer{stage_i}_{block_i}'
            p = params[block]
            s = stride if block_i == 0 else 1
            y = g.conv(x, p['conv1']['kernel'], f'basenet.{block}.conv1')
            y = g.relu(bn(y, 'bn1', block))
            y = g.conv(y, p['conv2']['kernel'], f'basenet.{block}.conv2',
                       strides=s, pads=1)
            y = g.relu(bn(y, 'bn2', block))
            y = g.conv(y, p['conv3']['kernel'], f'basenet.{block}.conv3')
            y = bn(y, 'bn3', block)
            x = bottleneck_tail(x, y, p, block, s)
            if block_i == 0:
                h, w = _conv_hw(h, 3, 1, s), _conv_hw(w, 3, 1, s)

    # stage-4 entry: 2x2/2 avg pool, asymmetric (0, 1) padding
    x = g.avg_pool(x, 2, 2, (0, 0, 1, 1))
    h, w = (h + 1 - 2) // 2 + 1, (w + 1 - 2) // 2 + 1
    for block_i in range(basenet.layers[3]):
        block = f'layer4_{block_i}'
        p = params[block]
        y = g.conv(x, p['conv1']['kernel'], f'basenet.{block}.conv1')
        y = g.relu(bn(y, 'bn1', block))
        y = _emit_mhsa(g, y, p['mhsa'], f'basenet.{block}.mhsa',
                       dim=512, h=h, w=w)
        y = g.relu(bn(y, 'bn2', block))
        y = g.conv(y, p['conv3']['kernel'], f'basenet.{block}.conv3')
        y = bn(y, 'bn3', block)
        x = bottleneck_tail(x, y, p, block)
    return x, h, w


def _emit_mobilenetv2(g: GraphBuilder, basenet, params, stats, input_hw):
    """MobileNetV2 trunk (``models/mobilenet.py``) -> (tensor, h, w)."""

    def bn(x, p, s, name):
        if basenet.norm == 'batchnorm':
            x = g.batchnorm(x, p, s, name)
        return x

    h, w = input_hw
    x = g.conv('input', params['conv_stem']['kernel'], 'basenet.conv_stem',
               strides=2, pads=1)
    h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
    x = g.clip(bn(x, params['stem_norm'], stats['stem_norm'],
                  'basenet.stem_norm'), 0.0, 6.0)

    channels_in = 32
    block_i = 0
    for t, c, n, s in basenet.config:
        for i in range(n):
            block = f'block{block_i}'
            p = params[block]
            st = stats.get(block, {})
            stride = s if i == 0 else 1
            y = x
            if 'expand' in p:
                y = g.conv(y, p['expand']['kernel'],
                           f'basenet.{block}.expand')
                y = g.clip(bn(y, p['expand_norm'], st.get('expand_norm'),
                              f'basenet.{block}.expand_norm'), 0.0, 6.0)
            expand_ch = t * channels_in
            y = g.conv(y, p['dwconv']['kernel'], f'basenet.{block}.dwconv',
                       strides=stride, pads=1, groups=expand_ch)
            y = g.clip(bn(y, p['dw_norm'], st.get('dw_norm'),
                          f'basenet.{block}.dw_norm'), 0.0, 6.0)
            y = g.conv(y, p['project']['kernel'],
                       f'basenet.{block}.project')
            y = bn(y, p['project_norm'], st.get('project_norm'),
                   f'basenet.{block}.project_norm')
            if stride == 1 and channels_in == c:
                y = g.add(y, x)
            else:
                h, w = _conv_hw(h, 3, 1, stride), _conv_hw(w, 3, 1, stride)
            x = y
            channels_in = c
            block_i += 1

    x = g.conv(x, params['conv_head']['kernel'], 'basenet.conv_head')
    x = g.clip(bn(x, params['head_norm'], stats['head_norm'],
                  'basenet.head_norm'), 0.0, 6.0)
    return x, h, w


def _emit_se(g: GraphBuilder, y: str, p: Dict, name: str) -> str:
    """Squeeze-excitation (``models/mobilenet.py::SqueezeExcite``):
    global mean -> 1x1 fc1 -> relu -> 1x1 fc2 -> hard_sigmoid gate."""
    s = g.global_avg_pool(y)
    s = g.conv(s, p['fc1']['kernel'], f'{name}.fc1', bias=p['fc1']['bias'])
    s = g.relu(s)
    s = g.conv(s, p['fc2']['kernel'], f'{name}.fc2', bias=p['fc2']['bias'])
    return g.mul(y, g.hard_sigmoid(s))


def _emit_mobilenetv3(g: GraphBuilder, basenet, params, stats, input_hw):
    """MobileNetV3-Large trunk (``models/mobilenet.py::MobileNetV3``,
    reference ``src/openpifpaf/network/basenetworks.py:~420``)."""

    def bn(x, p, s, name):
        if basenet.norm == 'batchnorm':
            x = g.batchnorm(x, p, s, name)
        return x

    def act(x, kind):
        return g.hard_swish(x) if kind == 'hardswish' \
            else g.clip(x, 0.0, 6.0)

    h, w = input_hw
    x = g.conv('input', params['conv_stem']['kernel'], 'basenet.conv_stem',
               strides=2, pads=1)
    h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
    x = g.hard_swish(bn(x, params['stem_norm'], stats['stem_norm'],
                        'basenet.stem_norm'))

    channels_in = 16
    for block_i, (k, e, c, se, a, s) in enumerate(basenet.config):
        block = f'block{block_i}'
        p = params[block]
        st = stats.get(block, {})
        y = x
        if 'expand' in p:   # absent when expand_channels == in channels
            y = g.conv(y, p['expand']['kernel'], f'basenet.{block}.expand')
            y = act(bn(y, p['expand_norm'], st.get('expand_norm'),
                       f'basenet.{block}.expand_norm'), a)
        y = g.conv(y, p['dwconv']['kernel'], f'basenet.{block}.dwconv',
                   strides=s, pads=k // 2, groups=e)
        y = act(bn(y, p['dw_norm'], st.get('dw_norm'),
                   f'basenet.{block}.dw_norm'), a)
        if se:
            y = _emit_se(g, y, p['se'], f'basenet.{block}.se')
        y = g.conv(y, p['project']['kernel'], f'basenet.{block}.project')
        y = bn(y, p['project_norm'], st.get('project_norm'),
               f'basenet.{block}.project_norm')
        if s == 1 and channels_in == c:
            y = g.add(y, x)
        else:
            h, w = _conv_hw(h, k, k // 2, s), _conv_hw(w, k, k // 2, s)
        x = y
        channels_in = c

    x = g.conv(x, params['conv_head']['kernel'], 'basenet.conv_head')
    x = g.hard_swish(bn(x, params['head_norm'], stats['head_norm'],
                        'basenet.head_norm'))
    return x, h, w


def _emit_effnetv2(g: GraphBuilder, basenet, params, stats, input_hw):
    """EfficientNetV2 trunk (``models/effnetv2.py``, reference
    ``src/openpifpaf/network/basenetworks.py:~540``): fused-MBConv early
    stages, MBConv+SE later stages, SiLU throughout."""

    def bn(x, p, s, name):
        if basenet.norm == 'batchnorm':
            x = g.batchnorm(x, p, s, name)
        return x

    h, w = input_hw
    x = g.conv('input', params['conv_stem']['kernel'], 'basenet.conv_stem',
               strides=2, pads=1)
    h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
    x = g.silu(bn(x, params['stem_norm'], stats['stem_norm'],
                  'basenet.stem_norm'))

    channels_in = 24
    block_i = 0
    for kind, e, c, n, s0 in basenet.config:
        for i in range(n):
            block = f'block{block_i}'
            p = params[block]
            st = stats.get(block, {})
            stride = s0 if i == 0 else 1
            y = x
            if kind == 'fused':
                y = g.conv(y, p['expand']['kernel'],
                           f'basenet.{block}.expand', strides=stride, pads=1)
                y = g.silu(bn(y, p['expand_norm'], st.get('expand_norm'),
                              f'basenet.{block}.expand_norm'))
                if 'project' in p:   # absent when expand_ratio == 1
                    y = g.conv(y, p['project']['kernel'],
                               f'basenet.{block}.project')
                    y = bn(y, p['project_norm'], st.get('project_norm'),
                           f'basenet.{block}.project_norm')
            else:
                y = g.conv(y, p['expand']['kernel'],
                           f'basenet.{block}.expand')
                y = g.silu(bn(y, p['expand_norm'], st.get('expand_norm'),
                              f'basenet.{block}.expand_norm'))
                y = g.conv(y, p['dwconv']['kernel'],
                           f'basenet.{block}.dwconv', strides=stride,
                           pads=1, groups=e * channels_in)
                y = g.silu(bn(y, p['dw_norm'], st.get('dw_norm'),
                              f'basenet.{block}.dw_norm'))
                y = _emit_se(g, y, p['se'], f'basenet.{block}.se')
                y = g.conv(y, p['project']['kernel'],
                           f'basenet.{block}.project')
                y = bn(y, p['project_norm'], st.get('project_norm'),
                       f'basenet.{block}.project_norm')
            if stride == 1 and channels_in == c:
                y = g.add(y, x)
            else:
                h, w = _conv_hw(h, 3, 1, stride), _conv_hw(w, 3, 1, stride)
            x = y
            channels_in = c
            block_i += 1

    x = g.conv(x, params['conv_head']['kernel'], 'basenet.conv_head')
    x = g.silu(bn(x, params['head_norm'], stats['head_norm'],
                  'basenet.head_norm'))
    return x, h, w


def _emit_squeezenet(g: GraphBuilder, basenet, params, stats, input_hw):
    """SqueezeNet 1.1 trunk (``models/squeezenet.py``) -> (tensor, h, w)."""
    h, w = input_hw

    def pool(x, h, w):
        return (g.max_pool(x, 3, 2, 1),
                _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2))

    def fire(x, name):
        p = params[name]
        s = g.relu(g.conv(x, p['squeeze']['kernel'],
                          f'basenet.{name}.squeeze',
                          bias=p['squeeze']['bias']))
        e1 = g.relu(g.conv(s, p['expand1x1']['kernel'],
                           f'basenet.{name}.expand1x1',
                           bias=p['expand1x1']['bias']))
        e3 = g.relu(g.conv(s, p['expand3x3']['kernel'],
                           f'basenet.{name}.expand3x3', pads=1,
                           bias=p['expand3x3']['bias']))
        out = g.concat_channels([e1, e3])
        if basenet.norm == 'batchnorm':
            out = g.batchnorm(out, p['norm'], stats[name]['norm'],
                              f'basenet.{name}.norm')
        return out

    x = g.conv('input', params['conv1']['kernel'], 'basenet.conv1',
               strides=2, pads=1, bias=params['conv1']['bias'])
    h, w = _conv_hw(h, 3, 1, 2), _conv_hw(w, 3, 1, 2)
    x = g.relu(x)
    x, h, w = pool(x, h, w)
    x = fire(x, 'fire2')
    x = fire(x, 'fire3')
    x, h, w = pool(x, h, w)
    x = fire(x, 'fire4')
    x = fire(x, 'fire5')
    x, h, w = pool(x, h, w)
    for name in ('fire6', 'fire7', 'fire8', 'fire9'):
        x = fire(x, name)
    return x, h, w




# ---------------------------------------------------------------------------
# the port's modules -> the configuration the emitters read
# ---------------------------------------------------------------------------

def _norm_kind(module) -> str:
    """The ``--basenet-norm`` a port backbone was built with, from its
    first normalization layer (a checkpoint does not record it)."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            return 'batchnorm'
        if isinstance(m, nn.GroupNorm):
            return 'instancenorm' if m.num_groups == m.num_channels \
                else 'groupnorm'
    return 'none'


def _blocks(net, prefix: str = 'block'):
    """A trunk's numbered blocks, ``block0``, ``block1``, ..."""
    return [getattr(net, f'{prefix}{i}') for i in range(net.n_blocks)]


def _stage_counts(names, stages):
    return tuple(sum(name.startswith(f'layer{i}_') for name in names)
                 for i in stages)


def _shufflenet_config(net):
    return dict(kernel_size=net.kernel_size,
                stages_repeats=net.stages_repeats,
                stages_out_channels=net.stages_out_channels)


def _resnet_config(net):
    return dict(input_conv_stride=net.conv1.stride[0],
                pool0_stride=net.pool0_stride,
                block5_dilation=net.layer4_0.conv2.dilation[0],
                layers=_stage_counts(net.block_names, range(1, 5)))


def _botnet_config(net):
    return dict(layers=_stage_counts(net.block_names, range(1, 4))
                + (len(net.bot_names),))


def _mobilenetv2_config(net):
    """One ``(t, c, n, s)`` row per block, n = 1."""
    rows = []
    for block in _blocks(net):
        cin = block.expand.in_channels if block.expand_on \
            else block.dwconv.in_channels
        rows.append((block.dwconv.out_channels // cin,
                     block.project.out_channels, 1, block.dwconv.stride[0]))
    return dict(config=tuple(rows))


def _mobilenetv3_config(net):
    """The ``(kernel, expand, out, se, activation, stride)`` rows."""
    from .models.mobilenet import ACTIVATIONS

    def activation(fn):
        return next(name for name, f in ACTIVATIONS.items() if f is fn)
    return dict(config=tuple(
        (block.dwconv.kernel_size[0], block.dwconv.out_channels,
         block.project.out_channels, hasattr(block, 'se'),
         activation(block.act), block.dwconv.stride[0])
        for block in _blocks(net)))


def _effnetv2_config(net):
    """One ``(block, expand, c, n, s)`` row per block, n = 1."""
    from .models.effnetv2 import FusedMBConv

    rows = []
    for block in _blocks(net):
        fused = isinstance(block, FusedMBConv)
        strided = block.expand if fused else block.dwconv
        # the emitter (as JAX's) takes a block's configured width for its
        # output width, which a fused block of expansion 1 keeps at its
        # input's
        _require(not fused or block.project_on or block.residual
                 or strided.stride[0] != 1,
                 'ONNX export: a fused EffNetV2 block of expansion 1 whose '
                 'configured width differs from its input\'s')
        rows.append(('fused' if fused else 'mbconv',
                     block.expand.out_channels // block.expand.in_channels,
                     block.out_channels, 1, strided.stride[0]))
    return dict(config=tuple(rows))


def _swin_config(net):
    stages = range(len(net.depths))
    return dict(depths=net.depths, embed_dim=net.patch_embed.out_channels,
                num_heads=tuple(getattr(net, f'stage{i}_block0').attn.num_heads
                                for i in stages),
                window=net.stage0_block0.window)


def _xcit_config(net):
    return dict(embed_dim=net.block0.xca.dim, num_heads=net.block0.xca.num_heads,
                depth=net.depth)


def _hrformer_config(net):
    """Branch i first runs in stage max(2, i + 1)."""
    first = net.s2_m0_b0_blk0
    dim = first.norm1.normalized_shape[0]
    return dict(base_channels=dim, window=first.window,
                mlp_ratio=first.mlp_fc1.out_channels / dim,
                num_modules=net.num_modules,
                blocks_per_module=net.blocks_per_module,
                num_heads=tuple(
                    getattr(net, f's{max(2, i + 1)}_m0_b{i}_blk0').attn.num_heads
                    for i in range(len(net.num_modules) + 1)))


def _configuration(basenet):
    """(emitter, configuration) of a port backbone: the attributes that the
    JAX emitters read of the flax module, by the same names, taken from the
    port's module."""
    from .models.botnet import BotNet
    from .models.effnetv2 import EffNetV2
    from .models.hrformer import HRFormer
    from .models.mobilenet import MobileNetV2, MobileNetV3
    from .models.resnet import ResNet
    from .models.shufflenetv2k import ShuffleNetV2K
    from .models.squeezenet import SqueezeNet
    from .models.swin import Swin
    from .models.xcit import XCiT

    families = ((ShuffleNetV2K, _emit_shufflenet, _shufflenet_config),
                (BotNet, _emit_botnet, _botnet_config),
                (ResNet, _emit_resnet, _resnet_config),
                (MobileNetV2, _emit_mobilenetv2, _mobilenetv2_config),
                (MobileNetV3, _emit_mobilenetv3, _mobilenetv3_config),
                (EffNetV2, _emit_effnetv2, _effnetv2_config),
                (SqueezeNet, _emit_squeezenet, lambda net: {}),
                (Swin, _emit_swin, _swin_config),
                (XCiT, _emit_xcit, _xcit_config),
                (HRFormer, _emit_hrformer, _hrformer_config))
    for cls, emit, config in families:
        if isinstance(basenet, cls):
            return emit, SimpleNamespace(norm=_norm_kind(basenet),
                                         **config(basenet))
    return None, None


def _variables(state_dict) -> Dict:
    """A Shell's state dict as flax's nested variables
    (``variables['params']['basenet'][...]``), numpy float32."""
    from .models.from_jax import to_jax_variables

    tree: Dict = {}
    for key, value in to_jax_variables(state_dict).items():
        node = tree
        *parents, leaf = key.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def build_model_graph(model, *, input_hw=(641, 641)) -> bytes:
    """Serialize a port Model (any registered basenet family +
    CompositeField4 heads) to ONNX bytes.  Input 'input': (1, 3, H, W)
    NCHW float32; one output per head named after its meta, shaped
    (1, F, C, H', W') like the port's forward.  The weights go out in
    float32 whatever the model computes in."""
    basenet = model.module.basenet
    emit, config = _configuration(basenet)
    _require(emit is not None,
             f'ONNX export supports the ShuffleNetV2/V2K, ResNet, BotNet, '
             f'MobileNetV2/V3, EffNetV2, SqueezeNet, Swin, XCiT and '
             f'HRFormer families — every registered basenet; got '
             f'{type(basenet).__name__}. Use export_program for the '
             f'portable native artifact.')
    _require(config.norm in ('batchnorm', 'none'),
             f'ONNX export supports batchnorm/none, got {config.norm!r}')

    variables = _variables(model.module.state_dict())
    params = variables['params']['basenet']
    stats = variables.get('batch_stats', {}).get('basenet', {})
    g = GraphBuilder()
    x, h, w = emit(g, config, params, stats, input_hw)

    # heads
    output_infos = []
    for i, meta in enumerate(model.head_metas):
        hp = variables['params'][f'head_nets_{i}']['conv']
        name = f'head_nets.{i}.conv'
        y = g.conv(x, hp['kernel'], name, bias=hp['bias'])
        u = meta.upsample_stride
        hh, ww = h, w
        if u > 1:
            y = g.depth_to_space_crd(y, u)
            cut = u // 2
            y = g.slice_spatial(y, cut)
            hh = h * u - 2 * cut + 1
            ww = w * u - 2 * cut + 1
        out_name = f'{meta.dataset}_{meta.name}'.replace('/', '_')
        shape = (1, meta.n_fields, meta.n_components, hh, ww)
        g.reshape(y, shape, out=out_name)
        output_infos.append(value_info(out_name, shape))

    graph = graph_proto(
        'openpifpaf_tpu_torch', g.nodes, g.initializers,
        [value_info('input', (1, 3, *input_hw))], output_infos)
    return model_proto(graph)
