"""Port kernels' plain versions vs the JAX package's Pallas kernels (CPU).

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's wrappers, given CPU tensors, run their plain PyTorch versions.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sovits_tpu.ops.attention import fused_attention as jax_fused_attention  # noqa: E402
from sovits_tpu.ops.fused_stage import fused_resblock_trio as jax_trio  # noqa: E402
from sovits_tpu_torch.ops.attention import fused_attention  # noqa: E402
from sovits_tpu_torch.ops.fused_stage import fused_resblock_trio  # noqa: E402
from tests.test_attention_kernel import _jnp_reference  # noqa: E402

T = torch.from_numpy


def _attn_inputs(window, masked, seed=0):
    rng = np.random.default_rng(seed)
    bh, t, d = 4, 48, 24
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
    "window,causal,masked",
    [(4, False, True), (4, False, False), (None, True, False)],
    ids=["window4-keymask", "window4", "causal"],
)
def test_attention_plain_matches_jax(window, causal, masked):
    q, k, v, rel_k, rel_v, km = _attn_inputs(window, masked)
    rk, rv = (rel_k, rel_v) if window else (None, None)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    ref_kernel = jax_fused_attention(
        j(q), j(k), j(v), j(rk), j(rv), key_mask=j(km), window=window, causal=causal,
        interpret=True,
    )
    ref_jnp = _jnp_reference(j(q), j(k), j(v), j(rel_k), j(rel_v), j(km), None, window, causal)
    t = lambda x: None if x is None else T(x)  # noqa: E731
    got = fused_attention(t(q), t(k), t(v), t(rk), t(rv), t(km), window=window, causal=causal)
    # tolerance of tests/test_attention_kernel.py: fp32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_kernel), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_jnp), rtol=2e-5, atol=2e-5)


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
