"""The readers the ont-audt cell adds: each reads its value from the
numbers of run_audit's `[VERBOSE] stages` line, and nothing from a
program that does not print its tokens (the parent of the change that
added them)."""
import pytest

# the numbers a program before walk_ops, walked_mb and pool_tail printed
BEFORE = {"records": 2800.0, "fetch+pack": 12.0, "extract": 2.5,
          "inflate": 1.3, "inflated_mb": 12000.0, "card_inflated_mb": 12000.0}
NEW = {"walk_ops": 1.0e9, "walked_mb": 2400.0, "workers": 4.0,
       "pool_tail": 1.2}
# (reader, its value over two passes of 3 s with BEFORE and NEW each)
READS = {"walk_ns_per_op": 2.5, "stage_used_pct": 20.0,
         "pool_tail_pct": 10.0}


def _run(*stats):
    import harness

    return harness.Run({}, {}, {}, 1.0, [harness.Pass(3.0, 2800, [], dict(s))
                                         for s in stats])


@pytest.mark.parametrize("stem", sorted(READS))
def test_ont_reader_reads_its_value_from_the_stages_line(stem):
    import harness

    stats = dict(BEFORE, **NEW)
    value = harness.metric_reader(stem).read(_run(stats, stats))
    assert value == pytest.approx(READS[stem])


@pytest.mark.parametrize("stem", sorted(READS))
def test_ont_reader_reads_nothing_without_its_tokens(stem):
    import harness

    assert harness.metric_reader(stem).read(_run(BEFORE, BEFORE)) is None


def test_walk_with_no_op_reads_zero():
    """--extract device: the C extract walks nothing and takes no time."""
    import harness

    stats = dict(BEFORE, extract=0.0, walk_ops=0.0)
    assert harness.metric_reader("walk_ns_per_op").read(_run(stats)) == 0.0
