"""The fused trio kernel's tile plan (``ops/fused_stage.py::trio_plan``), on
the CPU: the numbers the wrapper hands to ``csrc/resblock_trio.cu``, whose
entry point checks them again before it launches."""

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from sovits_tpu.ops.fused_stage import _trio_plan as jax_trio_plan  # noqa: E402
from sovits_tpu_torch.ops.fused_stage import SMEM_LIMIT, TRIO_CHANNELS, trio_plan  # noqa: E402

KS, DS = (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 5))
DTYPES = [torch.float32, torch.bfloat16]
PLANS = [(c, dtype) for c in TRIO_CHANNELS for dtype in DTYPES]


def _id(case):
    c, dtype = case
    return f"c{c}-{str(dtype).split('.')[1]}"


@pytest.mark.parametrize("case", PLANS, ids=_id)
def test_plan_fits_the_card_and_the_halos(case):
    c, dtype = case
    plan = trio_plan(c, dtype, KS, DS)
    assert plan.smem <= SMEM_LIMIT
    assert plan.tt >= 16
    assert plan.rows >= plan.tt + 2 * max(plan.halos)
    # each chain's halo is the sum of its six convs' reaches: (k-1)/2 * d, then (k-1)/2
    for k, dils, halo in zip(KS, DS, plan.halos):
        assert halo == sum((k - 1) // 2 * d + (k - 1) // 2 for d in dils)
    assert max(plan.halos) == jax_trio_plan(KS, DS, 1)[1]


@pytest.mark.parametrize("case", PLANS, ids=_id)
def test_plan_grid_covers_t(case):
    c, dtype = case
    plan = trio_plan(c, dtype)
    for t in (1, 5, 61, plan.tt, plan.tt + 1, 861 * 64):
        nx, nb = plan.grid(3, t)
        assert nb == 3
        assert nx * plan.tt >= t > (nx - 1) * plan.tt


@pytest.mark.parametrize("case", PLANS, ids=_id)
def test_balanced_plan_fills_whole_waves(case):
    """The wrapper's plan for [B, T] on 132 SMs: the same window, a tile no
    larger and no smaller than 16 rows, a grid that covers T and uses no more
    waves of blocks than the largest tile needs."""
    c, dtype = case
    plan = trio_plan(c, dtype)
    for b, t in ((1, 1), (1, 61), (1, plan.tt + 1), (1, 129), (6, 1000), (6, 10240), (1, 861 * 64 * 128 // c)):
        got = plan.balanced(b, t, 132)
        assert (got.rows, got.smem, got.halos) == (plan.rows, plan.smem, plan.halos)
        assert 16 <= got.tt <= plan.tt
        nx, nb = got.grid(b, t)
        assert nb == b and nx * got.tt >= t > (nx - 1) * got.tt
        assert -(-nx * b // 132) == -(-plan.grid(b, t)[0] * b // 132)  # one block an SM


@pytest.mark.parametrize("ks,ds", [((3, 7), ((1, 3), (1, 3))), ((3,), ((1,),))], ids=["two-chains", "one-conv-pair"])
def test_plan_of_other_chains_matches_jax_halo(ks, ds):
    for c in TRIO_CHANNELS:
        plan = trio_plan(c, torch.bfloat16, ks, ds)
        assert len(plan.halos) == len(ks)
        assert max(plan.halos) == jax_trio_plan(ks, ds, 1)[1]
        assert plan.rows - plan.tt == 2 * max(plan.halos)


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        trio_plan(24, torch.bfloat16)
    with pytest.raises(ValueError):
        trio_plan(16, torch.float16)
    with pytest.raises(ValueError):  # halos so wide that a block would own under 16 rows
        trio_plan(128, torch.bfloat16, (41,), ((5, 5, 5),))
