"""The device's busy time is the union of its intervals, not their sum."""
import devtrace


def test_union_not_sum():
    # a kernel on a side stream overlaps one on the main stream, and a
    # copy overlaps both
    iv = [(0, 100), (50, 150), (140, 160), (300, 400)]
    assert devtrace.union_ns(iv, 0, 1000) == 260
    assert sum(b - a for a, b in iv) == 320


def test_union_clipped_to_window():
    assert devtrace.union_ns([(0, 100), (90, 300)], 50, 200) == 150


def test_gaps():
    assert devtrace.gaps_ns([(10, 20), (15, 30), (50, 60)], 0, 100) == [
        (0, 10), (30, 50), (60, 100)]


def test_trace_metrics():
    t = devtrace.Trace(window=(0, 1_000_000_000), device=[
        (0, 200_000_000, "(anonymous namespace)::consensus_pos_kernel(int*)"),
        (100_000_000, 300_000_000, "Memcpy HtoD (Pageable -> Device)"),
    ], host=[(0, 1_000_000_000, "portbench.pass"),
             (400_000_000, 900_000_000, "aten::copy_")])
    assert t.busy_s() == 0.3
    assert t.window_s == 1.0
    assert t.kernel_s("consensus_pos_kernel") == 0.2
    assert t.kernel_s("poa_traceback_kernel") is None
    b = t.breakdown()
    assert b["device_ops"][0] == [
        "(anonymous namespace)::consensus_pos_kernel", 0.2]
    assert b["device_ops"][1][0] == "Memcpy HtoD"
    assert b["idle_gaps"] == [["pass: aten::copy_", 0.7]]


def test_idle_metric_reads_nothing_without_a_trace():
    import harness

    reader = harness.metric_reader("device_idle_pct.audt")
    run = harness.Run({}, {}, {}, 1.0, [], trace=None)
    assert reader.read(run) is None
