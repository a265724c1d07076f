"""Load-and-run ONNX runtime for the emitted models, in torch (counterpart
of ``sovits_tpu/export/onnx_run.py``, whose numpy runtime it follows op for
op). No onnxruntime exists here; external consumers run the same bytes
with a real runtime.

Implements exactly the op subset the builders emit (onnx_synth.py,
onnx_diffusion.py), with ONNX semantics (Conv/ConvTranspose NCW, Pad's
[begins..., ends...] layout, Reshape's 0/-1 rules, Gather with negative
indices, GatherElements, Einsum, CumSum), each op a torch function on an
explicit device, in float32 with TF32 off. Nodes execute in graph order:
the builder emits them topologically. Attribute-like inputs (shapes, pads,
axes) are read back to the host, so a run on the card synchronises at those
nodes: this runtime verifies artifacts, it does not serve them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from . import onnx_proto as P
from .onnx_proto import parse_model

_DT_TO_TORCH = {P.DT_FLOAT: torch.float32, P.DT_INT32: torch.int32, P.DT_INT64: torch.int64,
                P.DT_BOOL: torch.bool, P.DT_DOUBLE: torch.float64}


@contextlib.contextmanager
def _tf32_off():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _ints(x) -> list[int]:
    return [int(v) for v in x.reshape(-1).tolist()]


def _conv1d(x, w, b, pads, stride, dilation, group):
    x = F.pad(x, (int(pads[0]), int(pads[1])))
    return F.conv1d(x, w, b, stride=int(stride), dilation=int(dilation), groups=int(group))


def _conv_transpose1d(x, w, b, pads, stride):
    lo, hi = int(pads[0]), int(pads[1])
    if lo == hi:
        return F.conv_transpose1d(x, w, b, stride=int(stride), padding=lo)
    out = F.conv_transpose1d(x, w, None, stride=int(stride))
    out = out[:, :, lo : out.shape[2] - hi]
    return out if b is None else out + b[None, :, None]


def _reshape(x, shape):
    return x.reshape([x.shape[i] if s == 0 else s for i, s in enumerate(_ints(shape))])


def _pad(x, pads, value):
    n = x.dim()
    p = _ints(pads)
    widths = []
    for i in reversed(range(n)):  # F.pad takes the last dim first
        widths += [p[i], p[n + i]]
    return F.pad(x, widths, value=float(value))


def _slice(x, starts, ends, axes, steps=None):
    starts, ends, axes = _ints(starts), _ints(ends), _ints(axes)
    steps = _ints(steps) if steps is not None else [1] * len(starts)
    sl = [slice(None)] * x.dim()
    big = np.iinfo(np.int32).max
    for s, e, a, st in zip(starts, ends, axes, steps):
        sl[a % x.dim()] = slice(s, None if e >= big else e, st)
    return x[tuple(sl)]


def _gather(data, idx, axis):
    axis %= data.dim()
    idx = idx.long()
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(data.shape[:axis] + idx.shape + data.shape[axis + 1:])


def _float(x):
    return x.float() if x.dtype == torch.float64 else x


class Session:
    """A parsed model with its initializers on ``device``; calling it with
    feeds runs the graph and returns its outputs as numpy arrays. Load once,
    run many times (the PLMS loop calls the denoiser at every step). It runs
    on the CUDA card unless ``device`` names another."""

    def __init__(self, model_bytes: bytes, device: torch.device | str = "cuda"):
        self.graph = parse_model(model_bytes).graph
        self.device = torch.device(device)
        self.initializers = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                             for k, v in self.graph.initializers.items()}

    def __call__(self, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        env = dict(self.initializers)
        for name, elem, _dims in self.graph.inputs:
            if name not in feeds:
                raise KeyError(f"missing input {name}")
            env[name] = torch.as_tensor(np.asarray(feeds[name]), device=self.device,
                                        dtype=_DT_TO_TORCH.get(elem, torch.float32))
        with _tf32_off(), torch.no_grad():
            for node in self.graph.nodes:
                _run_node(node, env)
        return {name: env[name].cpu().numpy() for name, _e, _d in self.graph.outputs}


def run_model(model_bytes: bytes, feeds: dict[str, np.ndarray],
              device: torch.device | str = "cuda") -> dict[str, np.ndarray]:
    """Load the model on ``device`` (the card by default) and run it once;
    returns its outputs as numpy arrays."""
    return Session(model_bytes, device)(feeds)


def _run_node(node, env: dict) -> None:
    i = [env[x] if x else None for x in node.inputs]
    a = node.attrs
    op = node.op_type
    if op == "Conv":
        r = _conv1d(i[0], i[1], i[2] if len(i) > 2 else None, a.get("pads", [0, 0]),
                    a.get("strides", [1])[0], a.get("dilations", [1])[0], a.get("group", 1))
    elif op == "ConvTranspose":
        r = _conv_transpose1d(i[0], i[1], i[2] if len(i) > 2 else None, a.get("pads", [0, 0]),
                              a.get("strides", [1])[0])
    elif op == "MatMul":
        r = torch.matmul(i[0].float(), i[1].float())
    elif op == "Gemm":
        r = i[0] @ (i[1].t() if a.get("transB") else i[1])
        if len(i) > 2:
            r = r + i[2]
    elif op in _BINARY:
        r = _BINARY[op](i[0], i[1])
    elif op in _UNARY:
        r = _UNARY[op](i[0])
    elif op == "LeakyRelu":
        r = F.leaky_relu(i[0], a.get("alpha", 0.01))
    elif op == "Softmax":
        r = torch.softmax(i[0], dim=a.get("axis", -1))
    elif op == "Transpose":
        r = i[0].permute(*a["perm"])
    elif op == "Reshape":
        r = _reshape(i[0], i[1])
    elif op == "Concat":
        r = torch.cat(i, dim=a["axis"])
    elif op == "Split":
        for out_name, part in zip(node.outputs, torch.split(i[0], _ints(i[1]), dim=a["axis"])):
            env[out_name] = part
        return
    elif op == "Slice":
        r = _slice(i[0], i[1], i[2], i[3], i[4] if len(i) > 4 else None)
    elif op == "Pad":
        r = _pad(i[0], i[1], i[2].item() if len(i) > 2 else 0.0)
    elif op == "Unsqueeze":
        r = i[0]
        for ax in sorted(_ints(i[1])):
            r = r.unsqueeze(ax)
    elif op == "Squeeze":
        axes = [ax % i[0].dim() for ax in _ints(i[1])]
        r = i[0]
        for ax in sorted(axes, reverse=True):
            r = r.squeeze(ax)
    elif op == "Cast":
        r = i[0].to(_DT_TO_TORCH[a["to"]])
    elif op == "Gather":
        r = _gather(i[0], i[1], a.get("axis", 0))
    elif op == "GatherElements":
        r = torch.gather(i[0], a.get("axis", 0), i[1].long())
    elif op == "Shape":
        r = torch.tensor(i[0].shape, dtype=torch.int64, device=i[0].device)
    elif op == "Range":
        r = torch.arange(int(i[0]), int(i[1]), int(i[2]), dtype=torch.int64, device=i[0].device)
    elif op == "Einsum":
        r = torch.einsum(a["equation"], *[x.float() for x in i])
    elif op == "CumSum":
        r = torch.cumsum(i[0], dim=_ints(i[1])[0])
    elif op in ("ReduceMean", "ReduceSum"):
        axes = a.get("axes")
        if axes is None and len(i) > 1 and i[1] is not None:
            axes = _ints(i[1])
        fn = torch.mean if op == "ReduceMean" else torch.sum
        r = fn(i[0], dim=tuple(axes), keepdim=bool(a.get("keepdims", 1)))
    elif op == "Where":
        r = torch.where(i[0], i[1], i[2])
    elif op == "Clip":
        lo = i[1] if len(i) > 1 and i[1] is not None else None
        hi = i[2] if len(i) > 2 and i[2] is not None else None
        r = torch.clamp(i[0], lo, hi)
    elif op == "Expand":
        shape = torch.broadcast_shapes(i[0].shape, tuple(_ints(i[1])))
        r = i[0].expand(shape).clone()
    elif op == "Identity":
        r = i[0]
    else:
        raise NotImplementedError(f"op {op}")
    env[node.outputs[0]] = _float(r)


_BINARY = {
    "Add": torch.add, "Sub": torch.sub, "Mul": torch.mul, "Div": torch.div, "Pow": torch.pow,
    "Greater": torch.gt, "Less": torch.lt, "Equal": torch.eq, "Min": torch.minimum,
    "Max": torch.maximum,
}
_UNARY = {
    "Sqrt": torch.sqrt, "Exp": torch.exp, "Log": torch.log, "Neg": torch.neg, "Abs": torch.abs,
    "Floor": torch.floor, "Round": torch.round, "Tanh": torch.tanh, "Sigmoid": torch.sigmoid,
    "Relu": torch.relu, "Softplus": lambda x: torch.logaddexp(torch.zeros_like(x), x),
    "Sin": torch.sin, "Cos": torch.cos, "Not": torch.logical_not,
}
