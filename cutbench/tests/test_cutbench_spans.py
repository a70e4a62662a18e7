"""The program-span reduction (``harness/spans.py``) on synthetic
profiler events, with hand-computed answers: attribution of device time
through the launch's correlation id (also from a second thread), idle
time split over time between spans, the p95 and per-batch means, and
the readings; and ``trace.summarise`` unmoved by the program's spans."""

from __future__ import annotations

import math
import statistics

import pytest

from cutbench.harness import spans, trace


class Ev:
    """The part of a profiler event the reductions read."""

    def __init__(self, name, start, end, *, device=False, annotation=False,
                 corr=0, tid=1):
        self._name, self._start, self._end = name, start, end
        self._device, self._annotation = device, annotation
        self._corr, self._tid = corr, tid

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def span(name, s, e, tid=1):
    return [Ev(name, s, e, annotation=True, tid=tid),
            Ev(name, s, e, device=True, annotation=True)]


def kernel(name, s, e, corr, launch_at, tid=1):
    return [Ev("cudaLaunchKernel", launch_at, launch_at + 5, corr=corr,
               tid=tid),
            Ev(name, s, e, device=True, corr=corr)]


def window(lo, hi):
    return [Ev(trace.WINDOW, lo, hi, annotation=True)]


def train_events(program_spans: bool = True):
    """One step in a [0, 1000] ns window; the backward's kernel launched
    from a second thread; a host op whose own id collides with a kernel's
    correlation id; a span on another thread."""
    ev = window(0, 1000)
    ev += kernel("Memcpy HtoD (Pageable -> Device)", 150, 250, 11, 120)
    ev += kernel("fwd_conv", 300, 380, 12, 250)
    ev += kernel("wgrad", 450, 600, 13, 420, tid=2)
    ev += kernel("adamw", 750, 800, 14, 710)
    ev += kernel("tail", 950, 1100, 15, 920)
    ev.append(Ev("aten::mm", 40, 60, corr=12))
    ev.append(Ev("aten::add", 610, 740))
    if program_spans:
        for name, s, e in (("step", 100, 900), ("upload", 100, 200),
                           ("forward", 200, 400), ("backward", 400, 700),
                           ("update", 700, 850)):
            ev += span(f"cutdet.train.{name}", s, e)
        ev += span("cutdet.train.forward", 0, 1000, tid=3)
    return ev


def test_train_step_attribution_and_idle_split():
    out = spans.reduce(train_events())
    host = {"step": 800, "upload": 100, "forward": 200, "backward": 300,
            "update": 150}
    device = {"upload": 100, "forward": 80, "backward": 150, "update": 50,
              "step": 0}
    # Gaps [0,150] [250,300] [380,450] [600,750] [800,950]; the third
    # crosses forward -> backward, the fourth backward -> update, the
    # last update -> step -> none.
    idle = {"upload": 50, "forward": 70, "backward": 150, "update": 100,
            "step": 50}
    for name in host:
        got = out[f"cutdet.train.{name}"]
        assert got["count"] == 1
        assert got["host_s"] == pytest.approx(host[name] * 1e-9)
        assert got["host_p95_ms"] == pytest.approx(host[name] * 1e-6)
        assert got["device_s"] == pytest.approx(device[name] * 1e-9)
        assert got["idle_s"] == pytest.approx(idle[name] * 1e-9)
    assert out[spans.NONE]["idle_s"] == pytest.approx(150e-9)
    assert out[spans.NONE]["device_s"] == pytest.approx(50e-9)
    summary = trace.summarise(train_events())
    idle_sum = sum(v["idle_s"] for v in out.values())
    assert math.isclose(idle_sum, summary["window_s"] - summary["busy_s"],
                        abs_tol=1e-15)
    summary["spans"] = out
    want = {"train.upload_host_ms": 100e-6, "train.launch_ms": 650e-6,
            "train.idle_upload_pct": 5.0, "train.idle_forward_pct": 7.0,
            "train.idle_backward_pct": 15.0, "train.idle_update_pct": 10.0}
    for name, value in want.items():
        assert spans.reading(name, summary) == pytest.approx(value), name
    for name in spans.READINGS:
        if name.startswith("classify."):
            assert spans.reading(name, summary) is None, name


def classify_events():
    """20 batches 500 ns apart, each ``next`` 50, ``upload`` 40, ``step``
    60 and ``store`` to 200 + 10 k ns, one kernel launched in the step;
    a last batch still open when the window closes."""
    ev = window(0, 10_000)
    for k in range(20):
        s, d = 500 * k, 200 + 10 * k
        ev += span("cutdet.classify.batch", s, s + d)
        ev += span("cutdet.classify.next", s, s + 50)
        ev += span("cutdet.classify.upload", s + 50, s + 90)
        ev += span("cutdet.classify.step", s + 90, s + 150)
        ev += span("cutdet.classify.store", s + 150, s + d)
        ev += kernel("block", s + 120, s + 320, 100 + k, s + 110)
    ev += span("cutdet.classify.batch", 9_900, 10_000)
    ev += span("cutdet.classify.next", 9_900, 10_000)
    return ev


def test_classify_counts_p95_means_and_idle():
    out = spans.reduce(classify_events())
    batch = out["cutdet.classify.batch"]
    assert batch["count"] == 20  # the open one is not counted
    durations = [200 + 10 * k for k in range(20)]
    # The exclusive method's 19th cut of 20 lies 0.95 of the way from the
    # 19th smallest to the 20th.
    assert statistics.quantiles(durations, n=20)[18] == pytest.approx(389.5)
    assert batch["host_p95_ms"] == pytest.approx(389.5e-6)
    assert out["cutdet.classify.step"]["device_s"] == pytest.approx(4000e-9)
    # Each gap between kernels ([s + 320, s + 620]) holds the store's
    # tail (k >= 13), none, then the next batch's next 50, upload 40 and
    # step 30; the first gap [0, 120] the same; the last, [9820, 10000],
    # store 70, none 10 and the open batch's next 100.
    idle = {"upload": 800, "step": 600, "next": 1100, "store": 280,
            "batch": 0}
    for name, ns in idle.items():
        assert out[f"cutdet.classify.{name}"]["idle_s"] == pytest.approx(
            ns * 1e-9), name
    assert out[spans.NONE]["idle_s"] == pytest.approx(3220e-9)
    summary = trace.summarise(classify_events())
    assert summary["busy_s"] == pytest.approx(4000e-9)
    assert math.isclose(sum(v["idle_s"] for v in out.values()),
                        summary["window_s"] - summary["busy_s"],
                        abs_tol=1e-15)
    summary["spans"] = out
    want = {"classify.upload_host_ms": 40e-6, "classify.launch_ms": 60e-6,
            "classify.batch_span_p95_ms": 389.5e-6,
            "classify.idle_upload_pct": 8.0, "classify.idle_launch_pct": 6.0}
    for name, value in want.items():
        assert spans.reading(name, summary) == pytest.approx(value), name


@pytest.mark.parametrize("events", [train_events, classify_events])
def test_readings_none_without_spans(events):
    summary = trace.summarise(events())
    for name in spans.READINGS:
        assert spans.reading(name, summary) is None
        assert spans.reading(name, None) is None


def test_summarise_unmoved_by_program_spans():
    """Every number ``trace.summarise`` gives reads the same with the
    program's spans (and their device-side mirrors) in the events; an
    idle gap's label can only name a span where no other host event was
    open at its middle."""
    without = trace.summarise(train_events(program_spans=False))
    with_ = trace.summarise(train_events())
    for key in ("window_s", "busy_s", "kernel_s", "htod_s", "device_events",
                "device_ops"):
        assert with_[key] == without[key], key
    assert [d for _, d in with_["idle_gaps"]] == [
        d for _, d in without["idle_gaps"]]
    for (a, _), (b, _) in zip(with_["idle_gaps"], without["idle_gaps"]):
        assert a == b or (b == "host (untraced)"
                          and a.startswith(spans.PREFIX))
    assert with_["kernel_s"] == pytest.approx(330e-9)  # copies apart
    assert with_["htod_s"] == pytest.approx(100e-9)


@pytest.mark.parametrize("name", ["prod_net.game_u8chain",
                                  "prod_net.train_sup"])
def test_tool_reduces_the_programs_own_spans(name):
    """``tools/spans.py`` on the CPU at a small size: the profiler's own
    events of the program's spans reach the reduction, the batch or step
    spans count the hand-offs within one, and the idle split adds up to
    the slice's idle time (all of it, with no card)."""
    from cutbench.tests import small
    from cutbench.tools import spans as tool

    _, traffic = small.cell_and_traffic(name)
    result = tool.run(name, 2 ** 31 + 5, 0.5, small.CPU, traffic)
    layer = "classify" if name.endswith("u8chain") else "train"
    per = spans.BATCH if layer == "classify" else spans.STEP
    assert abs(result["spans"][per]["count"] - result["handoffs"]) <= 1
    assert result["idle_pct_summed"] == pytest.approx(
        result["device_idle_pct"])
    assert result["failed"] == 0
    mine = {k: v for k, v in result["readings"].items()
            if k.startswith(layer + ".")}
    assert len(mine) == (5 if layer == "classify" else 6)
    assert all(v is not None for v in mine.values()), mine
