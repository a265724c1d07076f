"""ONNX graph builder: tiny op-emission API over onnx_proto (the port's
copy of ``sovits_tpu/export/onnx_graph.py``).

Used by onnx_synth.py to assemble the SynthesizerTrn inference graph with
the reference's MoeSS io contract (onnx_export.py:24-110). Nodes are
emitted in execution order, so the graph is its own topological sort
(onnx_run.py executes it directly).
"""

from __future__ import annotations

import numpy as np

from . import onnx_proto as P


class GraphBuilder:
    def __init__(self, name: str):
        self.name = name
        self._nodes: list[bytes] = []
        self._inits: list[bytes] = []
        self._inputs: list[bytes] = []
        self._outputs: list[bytes] = []
        self._counter = 0

    # -- naming ---------------------------------------------------------
    def _fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    # -- graph io -------------------------------------------------------
    def input(self, name: str, shape, elem_type: int = P.DT_FLOAT) -> str:
        self._inputs.append(P.value_info(name, elem_type, shape))
        return name

    def output(self, name: str, shape, elem_type: int = P.DT_FLOAT) -> None:
        self._outputs.append(P.value_info(name, elem_type, shape))

    def init(self, arr: np.ndarray, hint: str = "w") -> str:
        name = self._fresh(hint)
        self._inits.append(P.tensor_proto(name, np.ascontiguousarray(arr)))
        return name

    def const_i64(self, vals, hint: str = "c") -> str:
        return self.init(np.asarray(vals, np.int64), hint)

    def const_f32(self, vals, hint: str = "c") -> str:
        return self.init(np.asarray(vals, np.float32), hint)

    # -- node emission --------------------------------------------------
    def n(self, op_type: str, inputs, n_out: int = 1, hint: str | None = None, **attrs):
        hint = hint or op_type.lower()
        outs = [self._fresh(hint) for _ in range(n_out)]
        self._nodes.append(P.node_proto(op_type, list(inputs), outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def n_named(self, op_type: str, inputs, outputs, **attrs) -> None:
        """Emit with explicit output names (for graph outputs)."""
        self._nodes.append(P.node_proto(op_type, list(inputs), list(outputs), **attrs))

    # -- common op sugar ------------------------------------------------
    def add(self, a, b):
        return self.n("Add", [a, b])

    def sub(self, a, b):
        return self.n("Sub", [a, b])

    def mul(self, a, b):
        return self.n("Mul", [a, b])

    def div(self, a, b):
        return self.n("Div", [a, b])

    def matmul(self, a, b):
        return self.n("MatMul", [a, b])

    def tanh(self, x):
        return self.n("Tanh", [x])

    def sigmoid(self, x):
        return self.n("Sigmoid", [x])

    def exp(self, x):
        return self.n("Exp", [x])

    def relu(self, x):
        return self.n("Relu", [x])

    def leaky_relu(self, x, alpha: float):
        return self.n("LeakyRelu", [x], alpha=float(alpha))

    def transpose(self, x, perm):
        return self.n("Transpose", [x], perm=list(perm))

    def reshape(self, x, shape_vals=None, shape_name=None):
        s = shape_name if shape_name is not None else self.const_i64(shape_vals, "shape")
        return self.n("Reshape", [x, s])

    def concat(self, xs, axis: int):
        return self.n("Concat", list(xs), axis=axis)

    def split(self, x, axis: int, sizes):
        return self.n(
            "Split", [x, self.const_i64(sizes, "split")], n_out=len(sizes), axis=axis
        )

    def slice_(self, x, starts, ends, axes, steps=None):
        ins = [x, self.const_i64(starts), self.const_i64(ends), self.const_i64(axes)]
        if steps is not None:
            ins.append(self.const_i64(steps))
        return self.n("Slice", ins)

    def pad(self, x, pads, value: float = 0.0):
        """pads: ONNX layout [b0, b1, ..., e0, e1, ...]."""
        return self.n(
            "Pad", [x, self.const_i64(pads, "pads"), self.const_f32(value, "padv")]
        )

    def unsqueeze(self, x, axes):
        return self.n("Unsqueeze", [x, self.const_i64(axes, "axes")])

    def squeeze(self, x, axes):
        return self.n("Squeeze", [x, self.const_i64(axes, "axes")])

    def cast(self, x, to: int):
        return self.n("Cast", [x], to=to)

    def gather(self, data, indices, axis: int = 0):
        return self.n("Gather", [data, indices], axis=axis)

    def shape_dim(self, x, dim: int) -> str:
        """Shape(x)[dim] as a 1-element int64 tensor."""
        s = self.n("Shape", [x])
        return self.n("Gather", [s, self.const_i64([dim], "dim")], axis=0)

    def einsum(self, equation: str, xs):
        return self.n("Einsum", list(xs), equation=equation)

    def softmax(self, x, axis: int):
        return self.n("Softmax", [x], axis=axis)

    def cumsum(self, x, axis: int):
        # axis is a 0-d int tensor per the CumSum spec
        return self.n("CumSum", [x, self.init(np.asarray(axis, np.int64), "axis")])

    def conv1d(
        self, x, w: np.ndarray, b: np.ndarray | None, pads=(0, 0), stride=1,
        dilation=1, group=1, hint="conv",
    ):
        """x [B, C, T]; w numpy [Co, Ci/g, k]."""
        ins = [x, self.init(np.asarray(w, np.float32), hint + "_w")]
        if b is not None:
            ins.append(self.init(np.asarray(b, np.float32), hint + "_b"))
        return self.n(
            "Conv", ins, hint=hint,
            dilations=[int(dilation)], group=int(group),
            kernel_shape=[int(w.shape[-1])], pads=[int(pads[0]), int(pads[1])],
            strides=[int(stride)],
        )

    def conv_transpose1d(
        self, x, w: np.ndarray, b: np.ndarray | None, stride: int, padding: int,
        hint="convt",
    ):
        """x [B, C, T]; w numpy [Ci, Co, k] (torch ConvTranspose layout)."""
        ins = [x, self.init(np.asarray(w, np.float32), hint + "_w")]
        if b is not None:
            ins.append(self.init(np.asarray(b, np.float32), hint + "_b"))
        return self.n(
            "ConvTranspose", ins, hint=hint,
            kernel_shape=[int(w.shape[-1])], pads=[int(padding), int(padding)],
            strides=[int(stride)],
        )

    # -- serialization --------------------------------------------------
    def model_bytes(self, opset: int = 16) -> bytes:
        g = P.graph_proto(
            self.name, self._nodes, self._inputs, self._outputs, self._inits
        )
        return P.model_proto(g, opset_version=opset)
