"""The port's ``doctor``, ``bench_pipeline`` and ``utils.device.
bounded_call`` on the CPU, against the JAX package's.

The doctor runs ``tests/test_doctor.py``'s four scenarios under
``--cpu``, and its check names and JSON schema are the JAX doctor's; a
run without ``--cpu`` on a machine with no card must fail
``backend-init`` and exit 1.  ``bench_pipeline``'s lines carry the JAX
CLI's keys on a 30-frame clip, with ``classify`` run through the
function at batch 8 for 0.2 s.  Without a card and without ``--cpu``
each new device entry point stops with "pass --cpu".
"""

import json
import time

import pytest
import torch

from cut_detection_tpu.cli import bench_pipeline as jax_bench
from cut_detection_tpu.cli import doctor as jax_doctor
from cut_detection_tpu.utils.platform import bounded_call as jax_bounded
from cut_detection_tpu_torch.cli import (
    bench_pipeline,
    doctor,
    embed_frames,
    export_model,
)
from cut_detection_tpu_torch.utils.device import bounded_call
from test_torch_copies import clip30  # noqa: F401 (a fixture)

CPU = torch.device("cpu")


def _doctor(args, capsys, mod=doctor):
    with pytest.raises(SystemExit) as ei:
        mod.main(args)
    return ei.value.code, capsys.readouterr().out


def test_doctor_healthy_json_matches_jax_schema(capsys):
    code, out = _doctor(["--json", "--cpu"], capsys)
    assert code == 0
    payload = json.loads(out.strip())
    assert payload["healthy"] is True
    names = [c["check"] for c in payload["checks"]]
    assert names[:2] == ["backend-init", "device-compute"]
    assert "decode-cv2" in names and "kernels-build" not in names
    for c in payload["checks"]:
        if c["required"]:
            assert c["ok"], c
    assert payload["checks"][0]["detail"]["platform"] == "cpu"
    jax_code, jax_out = _doctor(["--json", "--cpu"], capsys, jax_doctor)
    theirs = json.loads(jax_out.strip())
    assert jax_code == code
    assert list(theirs) == list(payload)
    assert [c["check"] for c in theirs["checks"]] == names
    assert [list(c) for c in theirs["checks"]] == [
        list(c) for c in payload["checks"]]


def test_doctor_full_runs_classify_step(capsys):
    code, out = _doctor(["--json", "--full", "--cpu"], capsys)
    assert code == 0
    payload = json.loads(out.strip())
    step = [c for c in payload["checks"] if c["check"] == "classify-step"]
    assert step and step[0]["ok"]
    # The CPU runs the plain versions: no kernel launch.
    assert step[0]["detail"] == {"params": 67971, "launches": {}}


def test_doctor_hung_backend_reports_fail(monkeypatch, capsys):
    """A backend probe that hangs is a FAILED check and exit 1, never a
    hung doctor; the device checks are skipped and the host checks run."""
    monkeypatch.setattr(doctor, "_probe_backend",
                        lambda cpu: time.sleep(30))
    code, out = _doctor(["--json", "--timeout", "0.2", "--cpu"], capsys)
    assert code == 1
    payload = json.loads(out.strip())
    assert payload["healthy"] is False
    init = payload["checks"][0]
    assert init["check"] == "backend-init" and not init["ok"]
    assert "did not complete" in init["error"]
    names = [c["check"] for c in payload["checks"]]
    assert "device-compute" not in names
    assert "decode-cv2" in names


def test_doctor_human_output(capsys):
    code, out = _doctor(["--cpu"], capsys)
    assert code == 0
    assert "[ok  ] backend-init" in out
    assert out.strip().endswith("healthy")


def test_doctor_without_a_card_fails_backend_init(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code, out = _doctor(["--json"], capsys)
    assert code == 1
    payload = json.loads(out.strip())
    init = payload["checks"][0]
    assert init["check"] == "backend-init" and not init["ok"]
    assert "pass --cpu" in init["error"]
    assert payload["healthy"] is False


def test_doctor_rejects_nonpositive_timeout(capsys):
    with pytest.raises(SystemExit) as ei:
        doctor.main(["--timeout", "0", "--cpu"])
    assert ei.value.code == 2


def test_bounded_call_returns_raises_and_times_out():
    assert bounded_call(lambda: 7, 5.0, "x") == 7 == jax_bounded(
        lambda: 7, 5.0, "x")
    assert bounded_call(lambda: None, 5.0, "x") is None

    def fail():
        raise KeyError("boom")

    for fn in (bounded_call, jax_bounded):
        with pytest.raises(KeyError, match="boom"):
            fn(fail, 5.0, "x")
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError,
                       match=r"^probe did not complete within 0\.2 s$"):
        bounded_call(lambda: time.sleep(30), 0.2, "probe")
    assert time.perf_counter() - t0 < 5


def test_bench_pipeline_lines_carry_the_jax_keys(clip30, capsys):
    flags = [clip30, "--stages", "decode", "e2e", "--batch-size", "8",
             "--decode-workers", "2", "--frame-limit", "24"]
    ours = bench_pipeline.main([*flags, "--cpu"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == ours
    theirs = jax_bench.bench_decode(clip30, 2, 24)
    theirs.append(jax_bench.bench_e2e(clip30, 2, 8, 24, "float32"))
    assert [(r["metric"], sorted(r), r["unit"]) for r in ours] == [
        (r["metric"], sorted(r), r["unit"]) for r in theirs]
    assert ours[-1]["frames"] == theirs[-1]["frames"]
    line = bench_pipeline.bench_classify(1, "float32", 0.0, device=CPU)
    assert sorted(line) == ["metric", "unit", "value"]
    assert line["metric"] == "classify_device (float32)"
    assert line["unit"] == "frames/sec" and line["value"] > 0


@pytest.mark.parametrize("name,argv", [
    ("bench_pipeline", ["v.mp4"]), ("doctor", []),
    ("embed_frames", ["v.mp4", "--model-dir", "m"]),
    ("split_video", ["v.mp4", "out"])])
def test_parsers_match_jax(name, argv):
    """The JAX parser's flags, defaults and ``fromfile_prefix_chars``;
    ``--cpu`` means the CPU in both (``export_model``'s parser, which adds
    ``--cpu`` and drops the XLA formats, is held in
    ``test_torch_embed_export.py``)."""
    import importlib

    ours = importlib.import_module(
        f"cut_detection_tpu_torch.cli.{name}").build_parser()
    theirs = importlib.import_module(
        f"cut_detection_tpu.cli.{name}").build_parser()
    assert vars(ours.parse_args(argv)) == vars(theirs.parse_args(argv))
    assert ours.fromfile_prefix_chars == theirs.fromfile_prefix_chars
    assert sorted(ours._option_string_actions) == sorted(
        theirs._option_string_actions)


@pytest.mark.parametrize("cli,args", [
    (embed_frames, ["v.mp4", "--model-dir", "m"]),
    (export_model, ["--use-default-net"]),
    (bench_pipeline, ["v.mp4"]),
])
def test_device_clis_without_cuda_need_cpu_flag(cli, args, capsys,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli.main(args)
    assert exc.value.code == 2
    assert "pass --cpu" in capsys.readouterr().err
