"""TF framework proto messages: GraphDef / NodeDef / AttrValue / TensorProto.

A copy of ``tensorframes_tpu/graphdef/proto.py``, kept in the port so that it
never imports the JAX package; bfloat16 tensors, which numpy cannot hold
here, decode to a CPU ``torch.bfloat16`` tensor, and such a tensor encodes
to the bit patterns the JAX package writes through ml_dtypes.

Schema-directed decode/encode over the ``wire`` codec, covering the subset of
the public TF wire format the framework interchanges (field numbers are fixed
by the public .proto definitions the reference vendors — SURVEY.md §2.5:
``graph.proto``, ``attr_value.proto``, ``tensor.proto``,
``tensor_shape.proto``, ``types.proto``).  Both directions are implemented so
tests can round-trip golden graphs without TensorFlow installed (replacing
the reference's python-TF subprocess diffing, ``dsl/ExtractNodes.scala``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .. import dtypes as dt
from ..shape import Shape, UNKNOWN
from . import wire


# -- TensorShapeProto (tensor_shape.proto: dim=2{size=1,name=2}, unknown_rank=3)


def parse_shape(buf: bytes) -> Optional[Shape]:
    dims: List[int] = []
    unknown_rank = False
    for field, wt, v in wire.fields(buf):
        if field == 2 and wt == wire.WIRE_LEN:
            size = 0
            for f2, _, v2 in wire.fields(v):
                if f2 == 1:
                    size = wire.decode_signed_varint(v2)
            dims.append(size)
        elif field == 3:
            unknown_rank = bool(v)
    return None if unknown_rank else Shape(dims)


def encode_shape(shape: Shape) -> bytes:
    out = bytearray()
    for d in shape:
        dim = bytearray()
        if d != 0:
            wire.write_varint_field(dim, 1, d)
        wire.write_len_field(out, 2, bytes(dim))
    return bytes(out)


# -- TensorProto (tensor.proto) ---------------------------------------------

_TYPED_FIELDS = {
    # field -> (tf enum, struct fmt for packed / None for varint, np dtype)
    5: (dt.TF_FLOAT, "<f", np.float32),
    6: (dt.TF_DOUBLE, "<d", np.float64),
    7: (dt.TF_INT32, None, np.int32),
    10: (dt.TF_INT64, None, np.int64),
    11: (dt.TF_BOOL, None, np.bool_),
    13: (dt.TF_BFLOAT16, None, np.int32),  # half_val: bf16 bit patterns
}


@dataclasses.dataclass
class TensorProto:
    dtype: int
    shape: Shape
    value: np.ndarray  # decoded host value (object array for strings)

    @staticmethod
    def parse(buf: bytes) -> "TensorProto":
        dtype = 0
        shape = Shape(())
        content = b""
        typed: Dict[int, List] = {}
        strings: List[bytes] = []
        for field, wt, v in wire.fields(buf):
            if field == 1:
                dtype = int(v)
            elif field == 2 and wt == wire.WIRE_LEN:
                s = parse_shape(v)
                shape = s if s is not None else Shape(())
            elif field == 4 and wt == wire.WIRE_LEN:
                content = v
            elif field == 8 and wt == wire.WIRE_LEN:
                strings.append(v)
            elif field in _TYPED_FIELDS:
                _, fmt, _npd = _TYPED_FIELDS[field]
                if wt == wire.WIRE_LEN and fmt:
                    typed.setdefault(field, []).extend(
                        wire.unpack_packed(v, fmt)
                    )
                elif wt == wire.WIRE_LEN and fmt is None:
                    typed.setdefault(field, []).extend(
                        wire.unpack_packed_varints(v)
                    )
                elif wt == wire.WIRE_VARINT:
                    typed.setdefault(field, []).append(
                        wire.decode_signed_varint(v)
                    )
                elif wt == wire.WIRE_FIXED32:
                    typed.setdefault(field, []).append(
                        struct.unpack("<f", v)[0]
                    )
                elif wt == wire.WIRE_FIXED64:
                    typed.setdefault(field, []).append(
                        struct.unpack("<d", v)[0]
                    )
        n = shape.num_elements()
        if dtype == dt.TF_STRING:
            arr = np.empty(len(strings), dtype=object)
            for i, s in enumerate(strings):
                arr[i] = s
            if n is not None and n != len(strings) and len(strings) == 1:
                arr = np.full(tuple(shape), strings[0], dtype=object)
            elif n is not None:
                arr = arr.reshape(tuple(shape))
            return TensorProto(dtype, shape, arr)
        st = dt.from_tf_enum(dtype)
        npd = st.np_dtype
        if npd is None:  # bfloat16: no numpy dtype here
            return _bf16_tensor(dtype, shape, content, typed)
        if content:
            arr = np.frombuffer(content, dtype=npd.newbyteorder("<")).astype(
                npd
            )
        else:
            vals = None
            for field, (en, _f, _npd) in _TYPED_FIELDS.items():
                if en == dtype and field in typed:
                    vals = typed[field]
            if vals is None:
                vals = next(iter(typed.values())) if typed else []
            arr = np.asarray(vals, dtype=npd)
        if n is not None:
            if arr.size == n:
                arr = arr.reshape(tuple(shape))
            elif arr.size == 1:
                # proto scalar-broadcast convention: one value fills the shape
                arr = np.full(tuple(shape), arr.reshape(())[()], dtype=npd)
            elif arr.size == 0:
                arr = np.zeros(tuple(shape), dtype=npd)
            else:
                raise wire.WireError(
                    f"TensorProto has {arr.size} values for shape {shape}"
                )
        return TensorProto(dtype, shape, arr)

    @staticmethod
    def from_numpy(arr) -> "TensorProto":
        """A TensorProto of a numpy value, or of a ``torch.bfloat16`` tensor
        (held as a CPU tensor: numpy has no bfloat16 here)."""
        if _is_bf16(arr):
            return TensorProto(dt.TF_BFLOAT16, Shape(tuple(arr.shape)),
                               arr.detach().cpu())
        arr = np.asarray(arr)
        st = dt.from_numpy(arr.dtype)
        return TensorProto(st.tf_enum, Shape(arr.shape), arr)

    def encode(self) -> bytes:
        out = bytearray()
        wire.write_varint_field(out, 1, self.dtype)
        wire.write_len_field(out, 2, encode_shape(self.shape))
        if self.dtype == dt.TF_BFLOAT16:
            # tensor_content: the raw little-endian bit patterns, as the JAX
            # package's ml_dtypes array writes them
            wire.write_len_field(out, 4, _bf16_bits(self.value))
            return bytes(out)
        arr = np.asarray(self.value)
        if self.dtype == dt.TF_STRING:
            for s in arr.reshape(-1):
                wire.write_len_field(
                    out, 8, s if isinstance(s, bytes) else str(s).encode()
                )
        else:
            st = dt.from_tf_enum(self.dtype)
            # tensor_content: raw little-endian — the layout DenseTensor.scala
            # (reference L73-115) writes
            wire.write_len_field(
                out,
                4,
                arr.astype(st.np_dtype.newbyteorder("<"), copy=False).tobytes(),
            )
        return bytes(out)


def _is_bf16(value) -> bool:
    import torch

    return isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16


def _bf16_bits(value) -> bytes:
    """A ``torch.bfloat16`` tensor's 16-bit patterns, little-endian."""
    import torch

    bits = value.detach().cpu().contiguous().view(torch.int16).numpy()
    return bits.astype("<i2", copy=False).tobytes()


def _bf16_tensor(dtype, shape, content, typed) -> "TensorProto":
    """A bfloat16 TensorProto's value as a CPU ``torch.bfloat16`` tensor:
    the raw little-endian 16-bit patterns of ``tensor_content``, or the
    ``half_val`` field's (one value fills the shape, as for other types)."""
    import torch

    if content:
        bits = np.frombuffer(content, dtype="<u2").astype(np.uint16)
    else:
        bits = np.asarray(typed.get(13, []), dtype=np.uint16)
    n = shape.num_elements()
    if n is not None:
        if bits.size == 1 and n != 1:
            bits = np.full(n, bits[0], dtype=np.uint16)
        elif bits.size == 0:
            bits = np.zeros(n, dtype=np.uint16)
        elif bits.size != n:
            raise wire.WireError(
                f"TensorProto has {bits.size} values for shape {shape}"
            )
        bits = bits.reshape(tuple(shape))
    value = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return TensorProto(dtype, shape, value)


# -- AttrValue (attr_value.proto) -------------------------------------------

AttrVal = Union[bytes, int, float, bool, Shape, TensorProto, list, None]


@dataclasses.dataclass
class AttrValue:
    kind: str  # 's','i','f','b','type','shape','tensor','list',
    #            'type_list','func','none'
    value: AttrVal

    @staticmethod
    def parse(buf: bytes) -> "AttrValue":
        for field, wt, v in wire.fields(buf):
            if field == 2:
                return AttrValue("s", v)
            if field == 3:
                return AttrValue("i", wire.decode_signed_varint(v))
            if field == 4:
                return AttrValue("f", struct.unpack("<f", v)[0])
            if field == 5:
                return AttrValue("b", bool(v))
            if field == 6:
                return AttrValue("type", int(v))
            if field == 7:
                return AttrValue("shape", parse_shape(v))
            if field == 8:
                return AttrValue("tensor", TensorProto.parse(v))
            if field == 10:  # NameAttrList — branch functions of If/While
                fname = ""
                fattrs: Dict[str, "AttrValue"] = {}
                for f2, _, v2 in wire.fields(v):
                    if f2 == 1:
                        fname = v2.decode()
                    elif f2 == 2:
                        k2 = ""
                        av2 = AttrValue("none", None)
                        for f3, _, v3 in wire.fields(v2):
                            if f3 == 1:
                                k2 = v3.decode()
                            elif f3 == 2:
                                av2 = AttrValue.parse(v3)
                        fattrs[k2] = av2
                return AttrValue("func", (fname, fattrs))
            if field == 1:  # ListValue
                items: List = []
                kind = "list"
                for f2, wt2, v2 in wire.fields(v):
                    if f2 == 2:
                        items.append(v2)
                    elif f2 == 3:
                        if wt2 == wire.WIRE_LEN:
                            items.extend(wire.unpack_packed_varints(v2))
                        else:
                            items.append(wire.decode_signed_varint(v2))
                    elif f2 == 4:
                        if wt2 == wire.WIRE_LEN:
                            items.extend(wire.unpack_packed(v2, "<f"))
                        else:
                            items.append(struct.unpack("<f", v2)[0])
                    elif f2 == 5:
                        # `repeated bool b = 5 [packed = true]` — TF writers
                        # emit one length-delimited blob of 0/1 varints
                        if wt2 == wire.WIRE_LEN:
                            items.extend(
                                bool(b)
                                for b in wire.unpack_packed_varints(
                                    v2, signed=False
                                )
                            )
                        else:
                            items.append(bool(v2))
                    elif f2 == 6:
                        # list(type) — distinct from list(int): TF's op
                        # validation rejects the wrong list arm, so the
                        # kind must survive a parse->encode round trip
                        kind = "type_list"
                        if wt2 == wire.WIRE_LEN:
                            items.extend(
                                wire.unpack_packed_varints(v2, signed=False)
                            )
                        else:
                            items.append(int(v2))
                    elif f2 == 7:
                        items.append(parse_shape(v2))
                    elif f2 == 8:
                        items.append(TensorProto.parse(v2))
                return AttrValue(kind, items)
        return AttrValue("none", None)

    def encode(self) -> bytes:
        out = bytearray()
        if self.kind == "s":
            wire.write_len_field(out, 2, self.value)
        elif self.kind == "i":
            wire.write_varint_field(out, 3, self.value)
        elif self.kind == "f":
            wire.write_fixed32_field(out, 4, struct.pack("<f", self.value))
        elif self.kind == "b":
            wire.write_varint_field(out, 5, int(self.value))
        elif self.kind == "type":
            wire.write_varint_field(out, 6, self.value)
        elif self.kind == "shape":
            wire.write_len_field(out, 7, encode_shape(self.value))
        elif self.kind == "tensor":
            wire.write_len_field(out, 8, self.value.encode())
        elif self.kind == "list":
            lst = bytearray()
            for it in self.value:
                if isinstance(it, bool):
                    wire.write_varint_field(lst, 5, int(it))
                elif isinstance(it, int):
                    wire.write_varint_field(lst, 3, it)
                elif isinstance(it, float):
                    wire.write_fixed32_field(lst, 4, struct.pack("<f", it))
                elif isinstance(it, bytes):
                    wire.write_len_field(lst, 2, it)
                elif isinstance(it, Shape):
                    wire.write_len_field(lst, 7, encode_shape(it))
                elif isinstance(it, TensorProto):
                    wire.write_len_field(lst, 8, it.encode())
                else:
                    raise wire.WireError(
                        f"cannot encode list attr item {type(it).__name__}"
                    )
            wire.write_len_field(out, 1, bytes(lst))
        elif self.kind == "func":
            fname, fattrs = self.value
            msg = bytearray()
            wire.write_len_field(msg, 1, fname.encode())
            for k in sorted(fattrs):
                entry = bytearray()
                wire.write_len_field(entry, 1, k.encode())
                wire.write_len_field(entry, 2, fattrs[k].encode())
                wire.write_len_field(msg, 2, bytes(entry))
            wire.write_len_field(out, 10, bytes(msg))
        elif self.kind == "type_list":
            # ListValue.type: `repeated DataType type = 6 [packed = true]`
            packed = bytearray()
            for en in self.value:
                wire.write_varint(packed, int(en))
            lst = bytearray()
            wire.write_len_field(lst, 6, bytes(packed))
            wire.write_len_field(out, 1, bytes(lst))
        elif self.kind == "none":
            pass
        else:
            raise wire.WireError(f"unknown attr kind {self.kind!r}")
        return bytes(out)


# -- NodeDef / GraphDef (graph.proto) ---------------------------------------


@dataclasses.dataclass
class NodeDef:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict[str, AttrValue]
    device: str = ""

    @staticmethod
    def parse(buf: bytes) -> "NodeDef":
        name = op = device = ""
        inputs: List[str] = []
        attrs: Dict[str, AttrValue] = {}
        for field, wt, v in wire.fields(buf):
            if field == 1:
                name = v.decode()
            elif field == 2:
                op = v.decode()
            elif field == 3:
                inputs.append(v.decode())
            elif field == 4:
                device = v.decode()
            elif field == 5:
                k = ""
                av = AttrValue("none", None)
                for f2, _, v2 in wire.fields(v):
                    if f2 == 1:
                        k = v2.decode()
                    elif f2 == 2:
                        av = AttrValue.parse(v2)
                attrs[k] = av
        return NodeDef(name, op, inputs, attrs, device)

    def encode(self) -> bytes:
        out = bytearray()
        wire.write_len_field(out, 1, self.name.encode())
        wire.write_len_field(out, 2, self.op.encode())
        for i in self.inputs:
            wire.write_len_field(out, 3, i.encode())
        if self.device:
            wire.write_len_field(out, 4, self.device.encode())
        for k in sorted(self.attrs):
            entry = bytearray()
            wire.write_len_field(entry, 1, k.encode())
            wire.write_len_field(entry, 2, self.attrs[k].encode())
            wire.write_len_field(out, 5, bytes(entry))
        return bytes(out)


@dataclasses.dataclass
class FunctionDef:
    """A library function (function.proto) — the body TF2 control flow
    (``StatelessIf``/``If``/``While``) calls by name.

    ``input_args``/``output_args`` are the signature's ArgDef names in
    declaration order (with TF dtype enums where declared); body node
    inputs use the function-ref grammar ``node:out_arg:idx`` for node
    outputs and bare names for input args; ``ret`` maps each output arg
    to such a ref."""

    name: str
    input_args: List[Tuple[str, int]]
    output_args: List[Tuple[str, int]]
    nodes: List[NodeDef]
    ret: Dict[str, str]

    @staticmethod
    def parse(buf: bytes) -> "FunctionDef":
        name = ""
        input_args: List[Tuple[str, int]] = []
        output_args: List[Tuple[str, int]] = []
        nodes: List[NodeDef] = []
        ret: Dict[str, str] = {}
        for field, wt, v in wire.fields(buf):
            if field == 1 and wt == wire.WIRE_LEN:  # signature: OpDef
                for f2, _, v2 in wire.fields(v):
                    if f2 == 1:
                        name = v2.decode()
                    elif f2 in (2, 3):  # input_arg / output_arg: ArgDef
                        an, at = "", 0
                        for f3, _, v3 in wire.fields(v2):
                            if f3 == 1:
                                an = v3.decode()
                            elif f3 == 3:
                                at = int(v3)
                        (input_args if f2 == 2 else output_args).append(
                            (an, at)
                        )
            elif field == 3 and wt == wire.WIRE_LEN:
                nodes.append(NodeDef.parse(v))
            elif field == 4 and wt == wire.WIRE_LEN:  # ret map entry
                k = rv = ""
                for f2, _, v2 in wire.fields(v):
                    if f2 == 1:
                        k = v2.decode()
                    elif f2 == 2:
                        rv = v2.decode()
                ret[k] = rv
        return FunctionDef(name, input_args, output_args, nodes, ret)

    def encode(self) -> bytes:
        sig = bytearray()
        wire.write_len_field(sig, 1, self.name.encode())
        for f2, args in ((2, self.input_args), (3, self.output_args)):
            for an, at in args:
                arg = bytearray()
                wire.write_len_field(arg, 1, an.encode())
                if at:
                    wire.write_varint_field(arg, 3, at)
                wire.write_len_field(sig, f2, bytes(arg))
        out = bytearray()
        wire.write_len_field(out, 1, bytes(sig))
        for n in self.nodes:
            wire.write_len_field(out, 3, n.encode())
        for k in sorted(self.ret):
            entry = bytearray()
            wire.write_len_field(entry, 1, k.encode())
            wire.write_len_field(entry, 2, self.ret[k].encode())
            wire.write_len_field(out, 4, bytes(entry))
        return bytes(out)


@dataclasses.dataclass
class GraphDef:
    nodes: List[NodeDef]
    functions: Dict[str, FunctionDef] = dataclasses.field(
        default_factory=dict
    )

    @staticmethod
    def parse(buf: bytes) -> "GraphDef":
        nodes = []
        functions: Dict[str, FunctionDef] = {}
        for field, wt, v in wire.fields(buf):
            if field == 1 and wt == wire.WIRE_LEN:
                nodes.append(NodeDef.parse(v))
            elif field == 2 and wt == wire.WIRE_LEN:  # FunctionDefLibrary
                for f2, wt2, v2 in wire.fields(v):
                    if f2 == 1 and wt2 == wire.WIRE_LEN:
                        fd = FunctionDef.parse(v2)
                        functions[fd.name] = fd
        return GraphDef(nodes, functions)

    def encode(self) -> bytes:
        out = bytearray()
        for n in self.nodes:
            wire.write_len_field(out, 1, n.encode())
        if self.functions:
            lib = bytearray()
            for fname in sorted(self.functions):
                wire.write_len_field(lib, 1, self.functions[fname].encode())
            wire.write_len_field(out, 2, bytes(lib))
        return bytes(out)

    def node_map(self) -> Dict[str, NodeDef]:
        return {n.name: n for n in self.nodes}


def parse_graphdef(data: bytes) -> GraphDef:
    return GraphDef.parse(data)
