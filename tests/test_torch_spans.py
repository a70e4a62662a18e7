"""The port's ``cutdet.*`` spans (``utils/profiling.span``) on the CPU.

Under a CPU profiler: the classify loop (unsharded and over a two-row
mesh), the supervised step and the contrastive step each record every
span of theirs, the right number of times, each child inside its parent.
With no profiler running, the helper enters no ``record_function`` at
all; if torch stopped setting the flag the helper reads, the spans would
vanish from every trace, and the profiled tests fail instead.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cut_detection_tpu_torch.config import ContrastiveConfig, TrainConfig
from cut_detection_tpu_torch.models.assembly import load_default_net
from cut_detection_tpu_torch.parallel.mesh import make_mesh
from cut_detection_tpu_torch.pipeline import classify_batches
from cut_detection_tpu_torch.train import contrastive, supervised

CPU = torch.device("cpu")
B = 4
TINY = dict(conv_layers=2, conv_hidden_channels=8, linear_layers=2,
            linear_size=8, batch_size=B)
CLASSIFY = {"batch": None, "next": "batch", "upload": "batch",
            "step": "batch", "store": "batch", "fetch": None}
TRAIN = {"step": None, "upload": "step", "augment": "step",
         "forward": "step", "backward": "step", "update": "step"}


@pytest.fixture(scope="module")
def net():
    return load_default_net(CPU)[0]


def _batches(n: int):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, (B, 36, 64, 3), dtype=np.uint8), B)
            for _ in range(n)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("cutdet.")]


def _check_nesting(spans, layer: str, parents: dict) -> None:
    """Every span of ``layer`` lies inside one of its parent's, and a span
    without a parent inside none of the layer's."""
    by = collections.defaultdict(list)
    for name, s, e in spans:
        by[name.removeprefix(f"cutdet.{layer}.")].append((s, e))
    for child, parent in parents.items():
        for s, e in by[child]:
            holders = [p for other, ps in by.items() if other != child
                       for p in ps if p[0] <= s and e <= p[1]]
            if parent is None:
                assert not holders, (child, holders)
            else:
                assert any(p[0] <= s and e <= p[1] for p in by[parent]), (
                    child, parent)


@pytest.mark.parametrize("frame_limit,batches", [(None, 3), (5, 2)])
def test_classify_loop_spans(net, frame_limit, batches):
    """One ``batch`` span a batch (one more, holding only its ``next``,
    where the source runs out), one upload, step and store a batch, and
    one fetch; ``length`` 1 makes the score buffers double, inside
    ``store``."""
    out = []
    spans = _profiled(lambda: out.append(classify_batches(
        iter(_batches(3)), net, batch_size=B, length=1,
        frame_limit=frame_limit, print_every=0)))
    counts = collections.Counter(n for n, _, _ in spans)
    ran_out = frame_limit is None
    assert out[0][2].batches == batches
    assert counts == {"cutdet.classify.batch": batches + ran_out,
                      "cutdet.classify.next": batches + ran_out,
                      "cutdet.classify.upload": batches,
                      "cutdet.classify.step": batches,
                      "cutdet.classify.store": batches,
                      "cutdet.classify.fetch": 1}
    _check_nesting(spans, "classify", CLASSIFY)


def test_sharded_upload_span(net):
    """Under a mesh each batch's shards are uploaded inside the step, in
    one ``cutdet.classify.upload`` span."""
    mesh = make_mesh([CPU, CPU])
    spans = _profiled(lambda: classify_batches(
        iter(_batches(2)), net, batch_size=B, length=2 * B, print_every=0,
        mesh=mesh))
    uploads = [(s, e) for n, s, e in spans if n == "cutdet.classify.upload"]
    steps = [(s, e) for n, s, e in spans if n == "cutdet.classify.step"]
    assert len(uploads) == len(steps) == 2
    for (us, ue), (ss, se) in zip(uploads, steps):
        assert ss <= us and ue <= se


def _supervised_step():
    cfg = TrainConfig(**TINY, avg_pool_size=2, output_size=3)
    state = supervised.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, CPU)
    x, _ = _batches(1)[0]
    y = np.arange(B) % 3
    step = supervised.make_train_step(cfg)
    return lambda: step(state, x, y)


def _contrastive_step():
    cfg = ContrastiveConfig(**TINY, output_size=8)
    state = contrastive.init_contrastive_state(
        torch.Generator().manual_seed(0), cfg, CPU)
    x, _ = _batches(1)[0]
    step = contrastive.make_contrastive_step(cfg)
    return lambda: step(state, torch.Generator().manual_seed(1), x)


@pytest.mark.parametrize("make,phases", [
    (_supervised_step, ("step", "upload", "forward", "backward", "update")),
    (_contrastive_step, ("step", "upload", "augment", "forward", "backward",
                         "update"))], ids=["supervised", "contrastive"])
def test_train_step_spans(make, phases):
    call = make()
    spans = _profiled(call)
    assert collections.Counter(n for n, _, _ in spans) == {
        f"cutdet.train.{p}": 1 for p in phases}
    _check_nesting(spans, "train", {p: TRAIN[p] for p in phases})


def test_span_enters_no_record_function_without_a_profiler(net,
                                                           monkeypatch):
    """With no profiler running the helper returns its no-op: no
    ``cutdet`` name reaches ``record_function``'s entry op.  The same
    hook sees them once a profiler runs, so it does watch the entry."""
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(name, *args):
        if name.startswith("cutdet."):
            entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting)
    train = _supervised_step()

    def run():
        classify_batches(iter(_batches(2)), net, batch_size=B, length=2 * B,
                         print_every=0)
        train()

    run()
    assert entered == []
    _profiled(run)
    assert "cutdet.classify.batch" in entered
    assert "cutdet.train.backward" in entered
