"""Self-contained ONNX protobuf serialization (no `onnx` dependency); the
port's own copy of ``sovits_tpu/export/onnx_proto.py``, host code only.

The reference ships real ONNX artifacts for the MoeSS/MoeVoiceStudio
ecosystem (onnx_export.py:11-137, onnxexport/); this environment has no
`onnx`/`onnxruntime`/`onnxscript` packages, so emission is implemented
directly against the ONNX protobuf wire format (onnx.proto3 is stable and
versioned; field numbers below follow IR version 8 / opset 16). Both a
writer and a reader are provided: the reader backs the in-repo torch
runtime (onnx_run.py) used for load-and-run verification, and any external
onnxruntime can consume the emitted bytes unchanged.

Only the message subset needed for inference graphs is implemented:
ModelProto, GraphProto, NodeProto, AttributeProto, TensorProto,
ValueInfoProto/TypeProto/TensorShapeProto, OperatorSetIdProto.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_num: int, wire_type: int) -> bytes:
    return _varint((field_num << 3) | wire_type)


def w_varint(field_num: int, v: int) -> bytes:
    return _tag(field_num, 0) + _varint(v)


def w_bytes(field_num: int, data: bytes) -> bytes:
    return _tag(field_num, 2) + _varint(len(data)) + data


def w_string(field_num: int, s: str) -> bytes:
    return w_bytes(field_num, s.encode("utf-8"))


def w_packed_i64(field_num: int, vals) -> bytes:
    body = b"".join(_varint(int(v)) for v in vals)
    return w_bytes(field_num, body)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def varint(self) -> int:
        shift = 0
        result = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def signed(self) -> int:
        v = self.varint()
        return v - (1 << 64) if v >= 1 << 63 else v

    def tag(self) -> tuple[int, int]:
        t = self.varint()
        return t >> 3, t & 7

    def bytes_(self) -> bytes:
        n = self.varint()
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self.pos += 8
        elif wire_type == 2:
            self.bytes_()
        elif wire_type == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")


# ---------------------------------------------------------------------------
# ONNX schema subset
# ---------------------------------------------------------------------------

DT_FLOAT = 1
DT_INT32 = 6
DT_INT64 = 7
DT_BOOL = 9
DT_DOUBLE = 11

_NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.bool_): DT_BOOL,
    np.dtype(np.float64): DT_DOUBLE,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}

ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_DT[arr.dtype]
    out = w_packed_i64(1, arr.shape)
    out += w_varint(2, dt)
    out += w_string(8, name)
    out += w_bytes(9, arr.tobytes())
    return out


def _f32_bits(v: float) -> int:
    return int(np.frombuffer(np.float32(v).tobytes(), np.uint32)[0])


def attribute_proto(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    out = w_string(1, name)
    if isinstance(value, bool):
        out += w_varint(3, int(value)) + w_varint(20, ATTR_INT)
    elif isinstance(value, int):
        out += w_varint(3, value) + w_varint(20, ATTR_INT)
    elif isinstance(value, float):
        out += _tag(2, 5) + np.float32(value).tobytes() + w_varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        out += w_bytes(4, value.encode()) + w_varint(20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        out += w_bytes(5, tensor_proto("", value)) + w_varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += w_packed_i64(8, value) + w_varint(20, ATTR_INTS)
        elif all(isinstance(v, (float, np.floating)) for v in value):
            body = b"".join(np.float32(v).tobytes() for v in value)
            out += w_bytes(7, body) + w_varint(20, ATTR_FLOATS)
        elif all(isinstance(v, str) for v in value):
            for v in value:
                out += w_bytes(9, v.encode())
            out += w_varint(20, ATTR_STRINGS)
        else:
            raise TypeError(f"mixed attribute list: {value!r}")
    else:
        raise TypeError(f"unsupported attribute: {value!r}")
    return out


def node_proto(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b""
    for i in inputs:
        out += w_string(1, i)
    for o in outputs:
        out += w_string(2, o)
    if name:
        out += w_string(3, name)
    out += w_string(4, op_type)
    for k, v in attrs.items():
        if v is not None:
            out += w_bytes(5, attribute_proto(k, v))
    return out


def value_info(name: str, elem_type: int, shape) -> bytes:
    """ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
    Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1};
    Dimension{dim_value=1 | dim_param=3}."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += w_bytes(1, w_string(3, d))
        else:
            dims += w_bytes(1, w_varint(1, int(d)))
    tensor = w_varint(1, elem_type) + w_bytes(2, dims)
    typ = w_bytes(1, tensor)
    return w_string(1, name) + w_bytes(2, typ)


def graph_proto(
    name: str,
    nodes: list[bytes],
    inputs: list[bytes],
    outputs: list[bytes],
    initializers: list[bytes],
) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(w_bytes(1, n) for n in nodes)
    out += w_string(2, name)
    out += b"".join(w_bytes(5, t) for t in initializers)
    out += b"".join(w_bytes(11, i) for i in inputs)
    out += b"".join(w_bytes(12, o) for o in outputs)
    return out


def model_proto(graph: bytes, opset_version: int = 16, producer: str = "sovits_tpu_torch") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8."""
    opset = w_string(1, "") + w_varint(2, opset_version)
    out = w_varint(1, 8)  # IR version 8
    out += w_string(2, producer)
    out += w_bytes(7, graph)
    out += w_bytes(8, opset)
    return out


# ---------------------------------------------------------------------------
# reader (for the torch runtime + round-trip tests)
# ---------------------------------------------------------------------------


@dataclass
class Attr:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: "Tensor | None" = None
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)
    strings: list = field(default_factory=list)

    @property
    def value(self):
        if self.type == ATTR_FLOAT:
            return self.f
        if self.type == ATTR_INT:
            return self.i
        if self.type == ATTR_STRING:
            return self.s.decode()
        if self.type == ATTR_TENSOR:
            return self.t.array
        if self.type == ATTR_FLOATS:
            return list(self.floats)
        if self.type == ATTR_INTS:
            return list(self.ints)
        if self.type == ATTR_STRINGS:
            return [s.decode() for s in self.strings]
        raise ValueError(f"attr type {self.type}")


@dataclass
class Tensor:
    name: str = ""
    dims: list = field(default_factory=list)
    data_type: int = 0
    raw: bytes = b""

    @property
    def array(self) -> np.ndarray:
        dt = _DT_TO_NP[self.data_type]
        return np.frombuffer(self.raw, dt).reshape(self.dims).copy()


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class Graph:
    name: str = ""
    nodes: list = field(default_factory=list)
    inputs: list = field(default_factory=list)  # (name, elem_type, dims)
    outputs: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)  # name -> np.ndarray


@dataclass
class Model:
    ir_version: int = 0
    producer: str = ""
    opset: int = 0
    graph: Graph | None = None


def _parse_tensor(data: bytes) -> Tensor:
    r = _Reader(data)
    t = Tensor()
    while not r.eof():
        f, wt = r.tag()
        if f == 1 and wt == 2:  # packed dims
            rr = _Reader(r.bytes_())
            while not rr.eof():
                t.dims.append(rr.signed())
        elif f == 1 and wt == 0:
            t.dims.append(r.signed())
        elif f == 2:
            t.data_type = r.varint()
        elif f == 8:
            t.name = r.bytes_().decode()
        elif f == 9:
            t.raw = r.bytes_()
        else:
            r.skip(wt)
    return t


def _parse_attr(data: bytes) -> Attr:
    r = _Reader(data)
    a = Attr()
    while not r.eof():
        f, wt = r.tag()
        if f == 1:
            a.name = r.bytes_().decode()
        elif f == 2:
            a.f = float(np.frombuffer(r.data[r.pos : r.pos + 4], np.float32)[0])
            r.pos += 4
        elif f == 3:
            a.i = r.signed()
        elif f == 4:
            a.s = r.bytes_()
        elif f == 5:
            a.t = _parse_tensor(r.bytes_())
        elif f == 7:
            buf = r.bytes_()
            a.floats.extend(np.frombuffer(buf, np.float32).tolist())
        elif f == 8:
            if wt == 2:
                rr = _Reader(r.bytes_())
                while not rr.eof():
                    a.ints.append(rr.signed())
            else:
                a.ints.append(r.signed())
        elif f == 9:
            a.strings.append(r.bytes_())
        elif f == 20:
            a.type = r.varint()
        else:
            r.skip(wt)
    return a


def _parse_node(data: bytes) -> Node:
    r = _Reader(data)
    n = Node()
    while not r.eof():
        f, wt = r.tag()
        if f == 1:
            n.inputs.append(r.bytes_().decode())
        elif f == 2:
            n.outputs.append(r.bytes_().decode())
        elif f == 3:
            n.name = r.bytes_().decode()
        elif f == 4:
            n.op_type = r.bytes_().decode()
        elif f == 5:
            a = _parse_attr(r.bytes_())
            n.attrs[a.name] = a.value
        else:
            r.skip(wt)
    return n


def _parse_value_info(data: bytes):
    r = _Reader(data)
    name, elem, dims = "", 0, []
    while not r.eof():
        f, wt = r.tag()
        if f == 1:
            name = r.bytes_().decode()
        elif f == 2:
            rt = _Reader(r.bytes_())
            while not rt.eof():
                tf, twt = rt.tag()
                if tf == 1:  # tensor_type
                    rtt = _Reader(rt.bytes_())
                    while not rtt.eof():
                        ttf, ttwt = rtt.tag()
                        if ttf == 1:
                            elem = rtt.varint()
                        elif ttf == 2:  # shape
                            rs = _Reader(rtt.bytes_())
                            while not rs.eof():
                                sf, swt = rs.tag()
                                if sf == 1:
                                    rd = _Reader(rs.bytes_())
                                    dim = None
                                    while not rd.eof():
                                        df, dwt = rd.tag()
                                        if df == 1:
                                            dim = rd.signed()
                                        elif df == 3:
                                            dim = rd.bytes_().decode()
                                        else:
                                            rd.skip(dwt)
                                    dims.append(dim)
                                else:
                                    rs.skip(swt)
                        else:
                            rtt.skip(ttwt)
                else:
                    rt.skip(twt)
        else:
            r.skip(wt)
    return name, elem, dims


def _parse_graph(data: bytes) -> Graph:
    r = _Reader(data)
    g = Graph()
    while not r.eof():
        f, wt = r.tag()
        if f == 1:
            g.nodes.append(_parse_node(r.bytes_()))
        elif f == 2:
            g.name = r.bytes_().decode()
        elif f == 5:
            t = _parse_tensor(r.bytes_())
            g.initializers[t.name] = t.array
        elif f == 11:
            g.inputs.append(_parse_value_info(r.bytes_()))
        elif f == 12:
            g.outputs.append(_parse_value_info(r.bytes_()))
        else:
            r.skip(wt)
    return g


def parse_model(data: bytes) -> Model:
    r = _Reader(data)
    m = Model()
    while not r.eof():
        f, wt = r.tag()
        if f == 1:
            m.ir_version = r.varint()
        elif f == 2:
            m.producer = r.bytes_().decode()
        elif f == 7:
            m.graph = _parse_graph(r.bytes_())
        elif f == 8:
            ro = _Reader(r.bytes_())
            while not ro.eof():
                of, owt = ro.tag()
                if of == 2:
                    m.opset = ro.varint()
                else:
                    ro.skip(owt)
        else:
            r.skip(wt)
    return m
