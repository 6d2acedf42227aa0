"""The readers of the program's own spans and counters (`Pipeline.timing`
deltas over the window): their arithmetic, and None where the program
records nothing (a program without the tracer, or tracing off)."""

import types

import pytest

from metrics import (class_occupancy_pct, consumer_ms_per_block,
                     counts_wait_ms_per_round, queue_ms_per_block,
                     round_dev_ms_per_kburst, step_dev_ms_per_block)

READERS = (step_dev_ms_per_block, round_dev_ms_per_kburst,
           class_occupancy_pct, counts_wait_ms_per_round,
           consumer_ms_per_block, queue_ms_per_block)


def ctx(timing, blocks=4, detected=500):
    return types.SimpleNamespace(trace=None, timing=timing, blocks=blocks,
                                 detected=detected, groups=1)


def test_program_span_metrics():
    c = ctx(dict(step_dev=0.024, round_dev=0.003, rows_live=500,
                 rows_run=2000, counts_wait=0.03, n_groups=1,
                 n_overflow_rounds=2, consumer=0.02, queue_wait=1.2))
    assert step_dev_ms_per_block.read(c) == pytest.approx(6.0)
    assert round_dev_ms_per_kburst.read(c) == pytest.approx(6.0)
    assert class_occupancy_pct.read(c) == pytest.approx(25.0)
    assert counts_wait_ms_per_round.read(c) == pytest.approx(10.0)
    assert consumer_ms_per_block.read(c) == pytest.approx(5.0)
    assert queue_ms_per_block.read(c) == pytest.approx(300.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__)
def test_nothing_recorded_reads_none(reader):
    assert reader.read(ctx({})) is None
    assert reader.read(ctx(dict(n_groups=3, n_blocks=4), blocks=0,
                           detected=0)) is None
