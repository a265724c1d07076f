"""The trio staging microbench kernel's tile plan
(``sovits_tpu_torch/tools/profile_trio_shift.py::trio_shift_plan``), on the
CPU: the numbers the wrapper hands to ``csrc/trio_shift.cu``, whose entry
point checks them again before it launches."""

import pytest

from sovits_tpu_torch.tools.profile_trio_shift import (
    N_CONV,
    PASS_ROWS,
    SMEM_LIMIT,
    TAP_BYTES,
    VARIANTS,
    trio_shift_plan,
)

# written rows: one 1024-row block, the ragged 4396-row input's 4096, the
# TPU tool's defaults (T 55104); SM counts: a small card and an H100
CASES = [(variant, rows, sms) for variant in VARIANTS for rows in (1024, 4096, 54272) for sms in (8, 132)]


@pytest.mark.parametrize("variant,rows,sms", CASES, ids=lambda v: str(v))
def test_plan_fits_covers_and_fills_whole_waves(variant, rows, sms):
    plan = trio_shift_plan(rows, variant, sms)
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem == 2 * TAP_BYTES + plan.window * plan.window_stride
    assert plan.window >= plan.tt + 2 * N_CONV and plan.window <= PASS_ROWS
    # block b owns rows [b tt, min((b + 1) tt, rows)): every row exactly once
    assert plan.tt >= 1 and plan.blocks * plan.tt >= rows > (plan.blocks - 1) * plan.tt
    # whole waves of one block per SM: no more waves than the largest window
    # needs, and no shorter tile would fill them
    waves = -(-plan.blocks // sms)
    assert waves == -(-rows // (sms * (PASS_ROWS - 2 * N_CONV)))
    assert (plan.tt - 1) * sms * waves < rows


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_row_strides_suit_ldmatrix_and_cp_async(variant):
    """Staged matrices (cp.async in 16-byte pieces, ldmatrix.trans) and the
    bf16 window (ldmatrix): 16-byte aligned rows of an odd number of 16-byte
    chunks, so ldmatrix's eight rows fall on every bank once. The fp32
    window is read as 8-byte pairs, 16 lanes at a time (rows g 0..3, pairs
    tq 0..3): every bank once too."""
    plan = trio_shift_plan(54272, variant, 132)
    ldmatrix = [plan.tap_stride] + ([plan.window_stride] if variant == "bf16" else [])
    for stride in ldmatrix:
        assert stride % 16 == 0 and (stride // 16) % 2 == 1
        assert len({(r * stride // 4 + w) % 32 for r in range(8) for w in range(4)}) == 32
    if variant == "fp32":
        assert plan.window_stride % 16 == 0
        banks = {(g * plan.window_stride // 4 + 2 * tq + w) % 32 for g in range(4) for tq in range(4) for w in range(2)}
        assert len(banks) == 32


def test_plan_at_the_defaults_is_two_waves_on_an_h100():
    """54272 rows on 132 SMs: 264 blocks of 206 rows in both variants (the fp32
    window, 544-byte rows, still fits 256 rows beside two staged matrices)."""
    for variant in VARIANTS:
        plan = trio_shift_plan(54272, variant, 132)
        assert (plan.tt, plan.window, plan.blocks) == (206, 230, 264)


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        trio_shift_plan(1024, "fp16", 132)
    with pytest.raises(ValueError):
        trio_shift_plan(0, "bf16", 132)
    with pytest.raises(ValueError):
        trio_shift_plan(1024, "bf16", 0)
