"""A PyTorch evaluator for the ONNX op subset the port's writer emits.

The counterpart of `basic_pitch_tpu/models/onnx_eval.py`, the JAX package's
numpy evaluator. onnxruntime is not a dependency, but an export without an
executor is unverifiable: `OnnxGraph` parses a ModelProto with the port's
wire-format walker (`data/proto.py`) exactly as the JAX evaluator does, and
`OnnxGraph.run` executes its nodes in file order as torch ops on one device.
The op table `_OPS` is the JAX evaluator's op set at opset 15: Conv 1D/2D
(`F.conv1d` / `F.conv2d` on the graph's explicit pads), Gather, Slice,
Concat, Pad, elementwise math, reductions, Where, Transpose,
Squeeze/Unsqueeze and Reshape.

It holds the writer (`models/onnx_export.py`): the tests and `chip_smoke.py`
run exported graphs through it against the port's `NMP`. Nothing on the
transcription path uses it. Convolutions run in float32 with TF32 off.
"""

from __future__ import annotations

import pathlib
import struct
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from basic_pitch_torch.data import proto
from basic_pitch_torch.models import nmp

# TensorProto.DataType
_FLOAT = 1
_INT64 = 7

Attrs = Dict[str, object]


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype = None
    name = ""
    raw = b""
    for field, wire, value in proto.iter_fields(buf):
        if field == 1 and wire == 0:
            dims.append(int(value))
        elif field == 2 and wire == 0:
            dtype = int(value)
        elif field == 8:
            name = value.decode()
        elif field == 9:
            raw += value
    if dtype == _FLOAT:
        arr = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif dtype == _INT64:
        arr = np.frombuffer(raw, dtype="<i8").astype(np.int64)
    else:
        raise ValueError(f"evaluator: unsupported tensor dtype {dtype}")
    return name, arr.reshape(dims)


def _parse_attrs(buf_list: List[bytes]) -> Attrs:
    attrs: Attrs = {}
    for buf in buf_list:
        name = ""
        value: object = None
        for field, wire, v in proto.iter_fields(buf):
            if field == 1:
                name = v.decode()
            elif field == 2:  # f
                value = struct.unpack("<f", v)[0]
            elif field == 3:  # i
                value = proto._from_signed_varint(v)
            elif field == 4:  # s
                value = v.decode()
            elif field == 8:  # ints (packed or repeated)
                ints = list(attrs.get(name, [])) if isinstance(attrs.get(name), list) else []
                if wire == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = proto.decode_varint(v, pos)
                        ints.append(proto._from_signed_varint(x))
                else:
                    ints.append(proto._from_signed_varint(v))
                value = ints
        attrs[name] = value
    return attrs


class Node:
    def __init__(self, op: str, inputs: List[str], outputs: List[str], attrs: Attrs):
        self.op = op
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs


class OnnxGraph:
    """Parsed ModelProto: nodes in topological (file) order + initializers
    (host numpy arrays, moved to the device by `run`)."""

    def __init__(self, path: "str | pathlib.Path"):
        data = pathlib.Path(path).read_bytes()
        graph = None
        for field, _w, value in proto.iter_fields(data):
            if field == 7:
                graph = value
        if graph is None:
            raise ValueError(f"{path}: no graph in ModelProto")
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self.input_names: List[str] = []
        self.output_names: List[str] = []
        for field, _w, value in proto.iter_fields(graph):
            if field == 5:
                name, arr = _parse_tensor(value)
                self.initializers[name] = arr
            elif field == 1:
                op, ins, outs, attr_bufs = "", [], [], []
                for f2, _w2, v2 in proto.iter_fields(value):
                    if f2 == 1:
                        ins.append(v2.decode())
                    elif f2 == 2:
                        outs.append(v2.decode())
                    elif f2 == 4:
                        op = v2.decode()
                    elif f2 == 5:
                        attr_bufs.append(v2)
                self.nodes.append(Node(op, ins, outs, _parse_attrs(attr_bufs)))
            elif field in (11, 12):
                for f2, _w2, v2 in proto.iter_fields(value):
                    if f2 == 1:
                        (self.input_names if field == 11 else self.output_names).append(v2.decode())

    def run(
        self, feeds: Dict[str, Union[np.ndarray, torch.Tensor]], device: "str | torch.device" = "cpu"
    ) -> Dict[str, torch.Tensor]:
        """Execute the graph on ``device``; returns the graph outputs there.
        The initializers go up once per device and are reused."""
        dev = torch.device(device)
        if dev not in self._on_device:
            self._on_device[dev] = {k: torch.as_tensor(v, device=dev) for k, v in self.initializers.items()}
        env = dict(self._on_device[dev])
        env.update({k: torch.as_tensor(v, device=dev) for k, v in feeds.items()})
        for node in self.nodes:
            args = [env[i] for i in node.inputs]
            env[node.outputs[0]] = _OPS[node.op](args, node.attrs)
        return {name: env[name] for name in self.output_names}


# --- op kernels ---------------------------------------------------------------


def _ints(t: torch.Tensor) -> List[int]:
    """An int64 operand (axes, pads, starts) as Python ints."""
    return [int(v) for v in t.reshape(-1).tolist()]


def _conv(args: Sequence[torch.Tensor], attrs: Attrs) -> torch.Tensor:
    x, w = args[0], args[1]
    bias = args[2] if len(args) > 2 else None
    n_sp = x.ndim - 2
    strides = attrs.get("strides") or [1] * n_sp
    pads = attrs.get("pads") or [0] * (2 * n_sp)
    # ONNX pads are [begin per axis..., end per axis...]; F.pad takes the
    # last axis first, (begin, end) each
    pad = []
    for i in reversed(range(n_sp)):
        pad += [pads[i], pads[i + n_sp]]
    xp = F.pad(x, pad)
    if n_sp == 1:
        return F.conv1d(xp, w, bias, stride=strides)
    if n_sp == 2:
        return F.conv2d(xp, w, bias, stride=strides)
    raise ValueError("evaluator Conv supports 1D/2D only")


def _gather(args: Sequence[torch.Tensor], attrs: Attrs) -> torch.Tensor:
    data, idx = args[0], args[1]
    axis = int(attrs.get("axis", 0)) % data.ndim
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)  # np.take's wrap
    out = torch.index_select(data, axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1 :])


def _slice(args: Sequence[torch.Tensor], _attrs: Attrs) -> torch.Tensor:
    data = args[0]
    starts, ends = _ints(args[1]), _ints(args[2])
    axes = _ints(args[3]) if len(args) > 3 else list(range(len(starts)))
    steps = _ints(args[4]) if len(args) > 4 else [1] * len(starts)
    slices = [slice(None)] * data.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        if st <= 0:
            raise ValueError("evaluator Slice supports positive steps only")
        slices[a] = slice(s, e, st)
    return data[tuple(slices)]


_PAD_MODES = {"constant": "constant", "reflect": "reflect", "edge": "replicate"}


def _pad(args: Sequence[torch.Tensor], attrs: Attrs) -> torch.Tensor:
    data, pads = args[0], _ints(args[1])
    mode = attrs.get("mode", "constant")
    n = data.ndim
    pad = []
    for i in reversed(range(n)):
        pad += [pads[i], pads[i + n]]
    return F.pad(data, pad, mode=_PAD_MODES[mode])


def _safe_div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Division whose 0/0 (the normalized log of a silent window) is masked
    by a downstream Where: the NaN stays, as in the JAX evaluator, and torch
    warns about nothing."""
    return x / y


def _reduce(fn: Callable[..., torch.Tensor]) -> Callable[[Sequence[torch.Tensor], Attrs], torch.Tensor]:
    def run(args: Sequence[torch.Tensor], attrs: Attrs) -> torch.Tensor:
        axes = tuple(attrs.get("axes") or range(args[0].ndim))
        keep = bool(attrs.get("keepdims", 1))
        return fn(args[0], dim=axes, keepdim=keep)

    return run


def _unsqueeze(args: Sequence[torch.Tensor], _attrs: Attrs) -> torch.Tensor:
    out = args[0]
    rank = out.ndim + len(_ints(args[1]))
    for axis in sorted(a % rank for a in _ints(args[1])):
        out = out.unsqueeze(axis)
    return out


_OPS: Dict[str, Callable[[Sequence[torch.Tensor], Attrs], torch.Tensor]] = {
    "Conv": _conv,
    "Gather": _gather,
    "Slice": _slice,
    "Pad": _pad,
    "Concat": lambda a, at: torch.cat(list(a), dim=int(at["axis"])),
    "Transpose": lambda a, at: a[0].permute(*at["perm"]),
    "Reshape": lambda a, at: a[0].reshape(_ints(a[1])),
    "Unsqueeze": _unsqueeze,
    "Squeeze": lambda a, at: a[0].squeeze(tuple(_ints(a[1]))),
    "Mul": lambda a, at: a[0] * a[1],
    "Add": lambda a, at: a[0] + a[1],
    "Sub": lambda a, at: a[0] - a[1],
    "Div": lambda a, at: _safe_div(a[0], a[1]),
    "Sqrt": lambda a, at: torch.sqrt(a[0]),
    "Log": lambda a, at: torch.log(a[0]),
    "Relu": lambda a, at: torch.relu(a[0]),
    "Sigmoid": lambda a, at: torch.sigmoid(a[0]),
    "Greater": lambda a, at: a[0] > a[1],
    "Where": lambda a, at: torch.where(a[0], a[1], a[2]),
    "ReduceMin": _reduce(torch.amin),
    "ReduceMax": _reduce(torch.amax),
}


def run_model(
    path: "str | pathlib.Path | OnnxGraph",
    audio: "np.ndarray | torch.Tensor",
    device: "str | torch.device | None" = None,
) -> Dict[str, torch.Tensor]:
    """Execute an exported nmp.onnx (a path, or a graph parsed once) on
    (batch, 43844) or (batch, 43844, 1) audio on ``device`` (``cuda`` unless
    the caller asks for the CPU); returns {"note", "onset", "contour"}
    posteriorgrams on that device."""
    from basic_pitch_torch import pipeline
    from basic_pitch_torch.models import onnx_export

    dev = pipeline.resolve_device(device)
    graph = path if isinstance(path, OnnxGraph) else OnnxGraph(path)
    x = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    if x.ndim == 2:
        x = x[..., None]
    with torch.inference_mode(), nmp.precision_scope("highest"):
        out = graph.run({onnx_export.INPUT_NAME: x}, dev)
    return {head: out[name] for head, name in onnx_export.OUTPUT_NAMES.items()}
