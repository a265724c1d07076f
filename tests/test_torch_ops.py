"""Port kernels' plain versions vs the JAX package's Pallas kernels (CPU).

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's wrappers, given CPU tensors, run their plain PyTorch versions.
The attention backward is held against ``jax.grad`` through the Pallas
kernel's custom VJP (its ``_bwd_kernel``), fp32, atol 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.ops.attention import fused_attention as jax_fused_attention  # noqa: E402
from sovits_tpu.ops.fused_stage import fused_resblock_trio as jax_trio  # noqa: E402
from sovits_tpu_torch.ops.attention import (  # noqa: E402
    fused_attention,
    fused_attention_bwd,
    fused_attention_bwd_plain,
)
from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio  # noqa: E402
from tests.test_attention_kernel import _jnp_reference  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

T = torch.from_numpy


def _attn_inputs(window, masked, seed=0, t=48):
    rng = np.random.default_rng(seed)
    bh, d = 4, 24
    q, k = (rng.standard_normal((2, bh, t, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((bh, t, d)) * 0.5).astype(np.float32)
    win = 2 * window + 1 if window else 1
    rel_k, rel_v = (rng.standard_normal((2, win, d)) * 0.2).astype(np.float32)
    km = None
    if masked:
        km = np.ones((bh, t), np.float32)
        km[:, -7:] = 0.0
    return q, k, v, rel_k, rel_v, km


@pytest.mark.parametrize(
    "window,causal,masked,t",
    [(4, False, True, 48), (4, False, False, 48), (None, True, False, 48), (4, False, False, 3)],
    ids=["window4-keymask", "window4", "causal", "window4-shorter-than-band"],
)
def test_attention_plain_matches_jax(window, causal, masked, t):
    q, k, v, rel_k, rel_v, km = _attn_inputs(window, masked, t=t)
    rk, rv = (rel_k, rel_v) if window else (None, None)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    ref_kernel = jax_fused_attention(
        j(q), j(k), j(v), j(rk), j(rv), key_mask=j(km), window=window, causal=causal,
        interpret=True,
    )
    tt = lambda x: None if x is None else T(x)  # noqa: E731
    got = fused_attention(tt(q), tt(k), tt(v), tt(rk), tt(rv), tt(km), window=window, causal=causal)
    # tolerance of tests/test_attention_kernel.py: fp32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), rtol=2e-5, atol=2e-5)
    if window is None or t > window:  # the modules' dense reference needs T > window
        ref_jnp = _jnp_reference(j(q), j(k), j(v), j(rel_k), j(rel_v), j(km), None, window, causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_jnp), rtol=2e-5, atol=2e-5)


BWD_CASES = [(4, False, True, True, 48), (None, True, False, True, 48), (4, False, True, False, 48),
             (None, True, False, False, 48), (4, False, False, True, 3)]
BWD_IDS = ["window4-keymask-dropout", "causal-dropout", "window4-keymask", "causal",
           "window4-dropout-shorter-than-band"]


def _bwd_inputs(window, masked, dropout, seed=3, t=48):
    q, k, v, rel_k, rel_v, km = _attn_inputs(window, masked, seed, t)
    rng = np.random.default_rng(seed + 1)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    dm = None
    if dropout:  # keep/(1-rate) with rate 0.1, as the attention modules draw it
        dm = ((rng.random((q.shape[0], q.shape[1], q.shape[1])) > 0.1) / 0.9).astype(np.float32)
    rk, rv = (rel_k, rel_v) if window else (None, None)
    return q, k, v, rk, rv, km, dm, dout


def _jax_grads(q, k, v, rk, rv, km, dm, dout, window, causal):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731

    def loss(q, k, v, rk, rv):
        out = jax_fused_attention(q, k, v, rk, rv, key_mask=j(km), drop_mask=j(dm),
                                  window=window, causal=causal, interpret=True)
        return jnp.sum(out * j(dout))

    argnums = (0, 1, 2, 3, 4) if window else (0, 1, 2)
    return jax.grad(loss, argnums=argnums)(j(q), j(k), j(v), j(rk), j(rv))


@pytest.mark.parametrize("window,causal,masked,dropout,t", BWD_CASES, ids=BWD_IDS)
def test_attention_backward_matches_jax(window, causal, masked, dropout, t):
    q, k, v, rk, rv, km, dm, dout = _bwd_inputs(window, masked, dropout, t=t)
    ref = _jax_grads(q, k, v, rk, rv, km, dm, dout, window, causal)
    t = lambda x: None if x is None else T(x)  # noqa: E731
    plain = fused_attention_bwd_plain(t(q), t(k), t(v), t(rk), t(rv), t(km), t(dm), t(dout),
                                      window=window, causal=causal)
    # autograd through FusedAttention: on the CPU its forward and backward are the plain versions
    leaves = [t(x).requires_grad_() if x is not None else None for x in (q, k, v, rk, rv)]
    out = fused_attention(*leaves, t(km), t(dm), window=window, causal=causal)
    (out * T(dout)).sum().backward()
    n = 5 if window else 3
    for got_plain, leaf, want in zip(plain[:n], leaves[:n], ref):
        np.testing.assert_allclose(got_plain.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if not window:
        assert plain[3] is None and plain[4] is None


def test_backward_wrapper_dispatch_on_cpu():
    fused_attention_bwd.launches = 0
    q, k, v, rk, rv, km, dm, dout = _bwd_inputs(4, True, True)
    args = [None if x is None else T(x) for x in (q, k, v, rk, rv, km, dm)]
    got = fused_attention_bwd(*args, None, None, T(dout), window=4)
    want = fused_attention_bwd_plain(*args, T(dout), window=4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_attention_bwd.launches == 0


def _trio_inputs(c, t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, t, c)) * 0.3).astype(np.float32)
    kernels = [(rng.standard_normal((k, c, c)) * 0.05).astype(np.float32)
               for k in (3, 7, 11) for _ in range(6)]
    biases = [(rng.standard_normal(c) * 0.01).astype(np.float32) for _ in range(18)]
    return x, kernels, biases


@pytest.mark.parametrize("c,t", [(16, 96), (32, 72)])
def test_trio_plain_matches_jax(c, t):
    x, kernels, biases = _trio_inputs(c, t, seed=c)
    ref = jax_trio(jnp.asarray(x), [jnp.asarray(w) for w in kernels],
                   [jnp.asarray(b) for b in biases], interpret=True)
    got = fused_resblock_trio(T(x), [T(w) for w in kernels], [T(b) for b in biases])
    # tolerance of tests/test_folded.py's trio check
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    fused_attention.launches = 0
    fused_resblock_trio.launches = 0
    q, k, v, rel_k, rel_v, km = _attn_inputs(4, True)
    fused_attention(T(q), T(k), T(v), T(rel_k), T(rel_v), T(km), window=4)
    x, kernels, biases = _trio_inputs(16, 32, seed=1)
    fused_resblock_trio(T(x), [T(w) for w in kernels], [T(b) for b in biases])
    assert fused_attention.launches == 0
    assert fused_resblock_trio.launches == 0


def test_wrappers_reject_malformed_arguments():
    q, k, v, rel_k, rel_v, _ = _attn_inputs(4, False)
    with pytest.raises(ValueError):
        fused_attention(T(q), T(k), T(v), T(rel_k), None, window=4)
    x, kernels, biases = _trio_inputs(16, 32, seed=2)
    with pytest.raises(ValueError):
        fused_resblock_trio(T(x), [T(w) for w in kernels[:-1]], [T(b) for b in biases])


# --------------------------------------------------- K3's custom VJP (FusedTrio)
@pytest.mark.parametrize("ks,dils,c,t", [((3, 7), ((1, 3), (1, 3)), 32, 96),
                                         ((3, 7, 11), ((1, 3, 5),) * 3, 16, 96)],
                         ids=["test_folded-plan", "default-plan"])
def test_trio_grads_match_jax_trio_folded(ks, dils, c, t):
    """The port's trio under autograd (FusedTrio: the forward, then a
    recomputed plain backward) against jax.grad through trio_folded (the
    Pallas forward in interpret mode and its custom VJP), for x, every
    kernel and every bias; tests/test_folded.py's tolerance."""
    from sovits_tpu.ops.fused_stage import trio_folded

    rng = np.random.default_rng(5)
    p = 128 // c
    n_conv = sum(2 * len(d) for d in dils)
    x = (rng.standard_normal((2, t, c)) * 0.3).astype(np.float32)
    kernels = [(rng.standard_normal((k, c, c)) * 0.05).astype(np.float32)
               for k, d in zip(ks, dils) for _ in range(2 * len(d))]
    biases = [(rng.standard_normal(c) * 0.01).astype(np.float32) for _ in range(n_conv)]
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss(args):
        xf, kern, bias = args
        out = trio_folded(xf, kern, bias, p, ks, dils)
        return jnp.sum(out * jnp.asarray(g).reshape(out.shape))

    ref = jax.grad(loss)((jnp.asarray(x).reshape(2, t // p, p * c),
                          tuple(map(jnp.asarray, kernels)), tuple(map(jnp.asarray, biases))))
    leaves = [T(a).requires_grad_() for a in (x, *kernels, *biases)]
    out = fused_resblock_trio(leaves[0], leaves[1:n_conv + 1], leaves[n_conv + 1:], ks, dils)
    (out * T(g)).sum().backward()
    want = [np.asarray(ref[0]).reshape(x.shape), *map(np.asarray, ref[1]), *map(np.asarray, ref[2])]
    assert len(want) == len(leaves) == 1 + 2 * n_conv
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=2e-4, atol=2e-5)


def test_trio_function_saves_inputs_and_recomputes():
    """FusedTrio keeps no activations: its graph holds x, the kernels and the
    biases, and a second backward through a fresh forward gives the same grads."""
    from sovits_tpu_torch.ops.fused_stage import FusedTrio

    x, kernels, biases = _trio_inputs(16, 48, seed=4)
    grads = []
    for _ in range(2):
        leaves = [T(a).requires_grad_() for a in (x, *kernels, *biases)]
        out = fused_resblock_trio(leaves[0], leaves[1:19], leaves[19:])
        assert isinstance(out.grad_fn, FusedTrio._backward_cls)
        assert len(out.grad_fn.saved_tensors) == 37
        out.square().sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------- K4 (trio staging bench)
def _jnp_trio_shift(xp, mats, mode):
    """tools/profile_trio_shift.py:make_kernel's body transcribed to jnp:
    per 1024-row block, the concat-rotate ('concat') or margin-scratch
    ('fp32in') staging, 12 rounds, rows [16, 16 + 1024) written."""
    block, halo, shifts = 1024, 16, (-1, 0, 1)
    q = xp.shape[1] - 2 * halo
    r_rows = block + 2 * halo
    outs = []
    for qi in range(q // block):
        x = xp[0, qi * block : qi * block + r_rows]
        for ci in range(12):
            x = jnp.maximum(x, 0.1 * x)
            acc = None
            if mode == "concat":
                for j, s in enumerate(shifts):
                    a = (-s) % r_rows
                    xs = jnp.concatenate([x[r_rows - a:], x[:r_rows - a]], axis=0) if s else x
                    term = jnp.dot(xs, mats[ci * 3 + j], preferred_element_type=jnp.float32)
                    acc = term if acc is None else acc + term
                x = acc.astype(jnp.bfloat16)
            else:
                sbuf = jnp.zeros((r_rows + 2 * halo, x.shape[1]), jnp.float32)
                sbuf = sbuf.at[halo:halo + r_rows].set(x.astype(jnp.float32))
                for j, s in enumerate(shifts):
                    xs = sbuf[halo + s:halo + s + r_rows]
                    term = jnp.dot(xs, mats[ci * 3 + j], preferred_element_type=jnp.float32)
                    acc = term if acc is None else acc + term
                x = acc
        outs.append(x[halo:halo + block].astype(jnp.bfloat16))
    return jnp.concatenate(outs, axis=0)[None]


@pytest.mark.parametrize("variant,mode", [("bf16", "concat"), ("fp32", "fp32in")])
def test_trio_shift_plain_matches_jnp_transcription(variant, mode):
    """K4's plain version (12 F.conv1d) against the TPU tool's kernel body,
    on 2 blocks plus a ragged tail that the tool leaves unwritten. Tolerance
    2e-2 x max|ref|: bf16 intermediates rounded after sums in other orders."""
    from sovits_tpu_torch.tools.profile_trio_shift import make_inputs, trio_shift

    xp, mats = make_inputs(128, 2 * 1024 + 200, seed=3)
    ref = _jnp_trio_shift(jnp.asarray(xp.float().numpy(), jnp.bfloat16),
                          jnp.asarray(mats.float().numpy(), jnp.bfloat16), mode)
    got = trio_shift(xp, mats, variant)
    assert got.shape == ref.shape == (1, 2048, 128) and got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


# --------------------------------------------------------------- dropout
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_dropout_matches_flax(dtype):
    """nn.dropout.dropout is flax's nn.Dropout body, select(keep, x / (1 - p),
    0) in x's type, bit for bit for the same keep mask: JAX rounds 1 - p to
    x's type (0.8984375 in bf16) before it divides."""
    from jax import lax

    from sovits_tpu_torch.nn.dropout import dropout

    x = np.random.default_rng(8).standard_normal(100_000).astype(np.float32)
    xt = T(x).to(dtype)
    got = dropout(xt, 0.1, torch.Generator().manual_seed(9))
    keep = (torch.rand(xt.shape, generator=torch.Generator().manual_seed(9)) >= 0.1).numpy()
    xj = jnp.asarray(x, {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype])
    want = lax.select(jnp.asarray(keep), xj / (1.0 - 0.1), jnp.zeros_like(xj))
    assert got.dtype == dtype and 0.85 < keep.mean() < 0.95
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_attention_keep_mask_takes_jax_values(dtype):
    """The attention's mask holds keep.astype(q's type) / (1 - p), as the JAX
    attention builds it: 0 and 1.109375 in bf16, 0 and float32's 1/0.9 in
    float32; stored float32."""
    from sovits_tpu_torch.nn.dropout import keep_mask

    m = keep_mask((4, 16, 16), 0.1, torch.Generator().manual_seed(2), "cpu", dtype)
    keep = torch.rand(4, 16, 16, generator=torch.Generator().manual_seed(2)) >= 0.1
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    want = jnp.asarray(keep.numpy()).astype(jdt) / (1.0 - 0.1)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), np.asarray(want, np.float32))
    kept = 1.109375 if dtype == torch.bfloat16 else np.float32(1.0) / np.float32(0.9)
    assert sorted(torch.unique(m).tolist()) == [0.0, float(kept)]
