"""The attention backward kernel's tile plan (``ops/attention.py::bwd_plan``),
on the CPU: the numbers the wrapper hands to ``csrc/rel_attention_bwd.cu``,
whose entry point checks them again before it launches."""

import pytest
import torch

from sovits_tpu_torch.ops.attention import SMEM_LIMIT, bwd_plan, bwd_scratch

DTYPES = [torch.float32, torch.bfloat16]


def _id(dtype):
    return str(dtype).split(".")[1]


@pytest.mark.parametrize("window", [4, None], ids=["w4", "causal"])
@pytest.mark.parametrize("dtype", DTYPES, ids=_id)
def test_both_passes_fit_shared_memory_at_every_width(dtype, window):
    for d in range(1, 129):
        plan = bwd_plan(d, window, dtype)
        assert 0 < plan.smem_q <= SMEM_LIMIT and 0 < plan.smem_kv <= SMEM_LIMIT, (d, plan)


@pytest.mark.parametrize("window", [4, None], ids=["w4", "causal"])
def test_bf16_rows_suit_ldmatrix_and_cp_async(window):
    """bf16 tiles: every row starts on a 16-byte boundary (cp.async and
    ldmatrix need it) and spans an odd number of 16-byte chunks, so the 8
    rows an ldmatrix phase reads hit 8 different bank groups; both passes
    within a block's shared memory at every width."""
    for d in range(1, 129):
        plan = bwd_plan(d, window, torch.bfloat16)
        for row in plan.row_bytes:
            assert row % 16 == 0 and (row // 16) % 2 == 1, (d, row)
            assert row >= 2 * d
        assert 0 < plan.smem_q <= SMEM_LIMIT and 0 < plan.smem_kv <= SMEM_LIMIT, (d, plan)
        assert plan.smem_kv % 16 == 0 and plan.smem_q >= plan.smem_kv


@pytest.mark.parametrize("dtype", DTYPES, ids=_id)
def test_blocks_cover_t(dtype):
    for d in (1, 33, 96, 128):
        plan = bwd_plan(d, 4, dtype)
        for t in range(1, 2049):
            nq, nkv = plan.blocks(t)
            assert nq * plan.q_rows >= t > (nq - 1) * plan.q_rows
            assert nkv * plan.kv_keys >= t > (nkv - 1) * plan.kv_keys


@pytest.mark.parametrize("dtype", DTYPES, ids=_id)
@pytest.mark.parametrize("bh,t,d", [(12, 800, 96), (3, 9, 33), (2, 1000, 128), (1, 1, 1)])
def test_partials_follow_the_plan(dtype, bh, t, d):
    """One rel-table partial per pass-(a) block and head, as the kernel
    writes them; no band or partials without a window."""
    plan = bwd_plan(d, 4, dtype)
    dvec, band, part = bwd_scratch(plan, bh, t, d, 4, "cpu")
    assert dvec.shape == (bh, t) and band.shape == (bh, t, 18)
    assert part.shape == (plan.blocks(t)[0] * bh, 2, 9, d)
    assert all(x.dtype == torch.float32 for x in (dvec, band, part))
    assert bwd_scratch(bwd_plan(d, None, dtype), bh, t, d, None, "cpu")[1:] == (None, None)


def test_plan_rejects_what_the_kernel_does_not_take():
    for d in (0, 129):
        with pytest.raises(ValueError):
            bwd_plan(d, 4, torch.float32)
    with pytest.raises(ValueError):
        bwd_plan(96, 4, torch.float16)
    with pytest.raises(ValueError):  # a band table that leaves no room for the tiles
        bwd_plan(128, 200, torch.float32)
