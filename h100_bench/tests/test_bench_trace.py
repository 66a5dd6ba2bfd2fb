"""The traced run records the card's operations and the ``bench.*`` spans,
and no host operator besides, so that the profiler's own cost stays out of
the idle share and the mfu."""
import torch

from harness import core, trace


def test_profile_holds_only_the_bench_spans_on_the_host():
    with trace.profiled(True) as prof:
        with trace.span(trace.WINDOW):
            for _ in range(3):
                with trace.span("bench.step"):
                    torch.ones(64).add_(1).mul_(2).sum()
    host = [e.name() for e in prof.events if str(e.device_type()).endswith("CPU")]
    assert sorted(set(host)) == ["bench.step", "bench.window"]
    s = trace.summarize(prof)
    assert len(s.spans["bench.step"]) == 3 and s.window_s > 0


def test_traced_run_reports_per_layer_metrics(tiny_bench):
    import run as bench_run

    cell = core.Cell(core.load_manifest(tiny_bench.parent), "pose-b-int8-64", bench=tiny_bench)
    line = bench_run.run_cell(cell, 2 ** 31 + 5, 0.3, True, "cpu")
    got = set(line["metrics"])
    # no kernel of the card runs here, so its roofline is left out, not 0
    assert "k2_roofline.pose" not in got
    assert {"pose_mfu.pose", "enqueue_ms.pose", "idle_share.pose"} <= got
    assert line["device"]["window_s"] > 0 and "breakdown" in line
