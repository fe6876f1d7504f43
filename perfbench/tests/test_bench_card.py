"""On the card: the program meets the limits and the control (the
reference one rung lower), judged against the same limits, does not, on
three seeds of each tiny cell.  ``perfbench/control.py`` takes the same
readings at the cells' own sizes."""
from __future__ import annotations

import time

import pytest

from perfbench.harness import cell


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ladder_fused_b64_tiny.bulk_tiny",
                                      "ladder_chain_b64_tiny.bulk_tiny"])
def test_control_fails_where_the_program_passes(card, bench_copy, workload):
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = cell.run(bench_copy, workload, seed, 0.5, False, "cuda",
                       time.perf_counter(), log=lambda m: None, control=True)
        assert out["correct"], out["checks"]
        assert out["control_correct"] is False, out["control"]
