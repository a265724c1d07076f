"""K2, the relative-attention backward, as a share of its roofline, in %:
the sum over the window's launches of each launch's bound time over the
device time of its kernels (named ``bwd_q_*`` and ``bwd_kv_*``).

K2 is called through ctypes from an autograd backward and has no range of
its own in the trace, so each launch's shapes come from the step: per step
the ContentEncoder's ``n_layers`` launches (Shaw window, key mask), the F0
decoder's ``n_layers`` and, in a transformer-flow model, the flow's
``n_flow_layer x n_layers_trans_flow`` (causal), each over batch x heads
rows of head size hidden / heads, with a dropout keep mask. The count is
checked against the kernels in the trace. What a launch needs is counted
from the rows' real lengths (the window's batches): every (query, key)
pair of real frames, or of real frames with the key not after the query
when causal. Per pair, the backward's five products of d (recomputed
scores, dP, dV, dQ, dK) at 2 d each; per query and window offset the same
five for the Shaw tables. Bytes: q, k, v, out, dout, dq, dk, dv (d each per
row and frame), the log-sum-exp and key mask (one each), the keep mask (one
per pair counted), and the tables and their gradients."""

from portbench import peaks

ITEM = 4  # float32


def launch_cost(lengths, heads: int, d: int, window: int | None, causal: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch over rows of these real lengths."""
    flops = nbytes = 0.0
    for n in lengths:
        pairs = n * (n + 1) / 2 if causal else n * n
        flops += heads * 10.0 * d * pairs
        nbytes += heads * ITEM * (8 * n * d + 2 * n + pairs)
        if window is not None:
            flops += heads * 10.0 * d * n * (2 * window + 1)
    if window is not None:
        nbytes += ITEM * 4 * (2 * window + 1) * d
    return flops, nbytes


def read(run):
    events, per_step = run.trace_events, run.layer.get("lengths")
    if not events or not per_step:
        return None
    m = run.cfg["model"]
    heads, d = m["n_heads"], m["hidden_channels"] // m["n_heads"]
    kinds = [(m["n_layers"], 4, False), (m["n_layers"], None, True)]
    if m.get("use_transformer_flow"):
        kinds.append((m["n_flow_layer"] * m["n_layers_trans_flow"], None, True))
    kernels = [e for e in events if e.get("cat") == "kernel" and ("bwd_q_" in e["name"] or "bwd_kv_" in e["name"])]
    launches = sum(n for n, _, _ in kinds) * len(per_step)
    if len([k for k in kernels if "bwd_q_" in k["name"]]) != launches:
        return None
    frames = run.layer["frames"]
    bound = 0.0
    for lengths in per_step:
        lengths = [min(int(n), frames) for n in lengths]
        for count, window, causal in kinds:
            flops, nbytes = launch_cost(lengths, heads, d, window, causal)
            bound += count * peaks.bound_s(flops, nbytes, run.cfg["precision"])
    device = sum(k["dur"] for k in kernels) * 1e-6
    return 100.0 * bound / device if device else None
