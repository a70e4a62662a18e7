"""The port's serving daemon (``cut_detection_tpu_torch.cli.serve``) on
the CPU: the scenarios of ``tests/test_serve.py`` that need no mesh, on
one module-scoped port server, with the CSVs it writes held to the
golden reference CSVs and to the JAX pipeline's ``segment_video_file`` on
the synthetic clip (float32, ``transfer: "bgr"``, byte for byte).  No JAX
daemon runs beside it; the JAX package is used only to write the CSVs
and the checkpoint triplets the port's daemon is compared with and
loads.
"""

import json
import os
import shutil
import ssl
import subprocess
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import jax
import pytest
import torch

from cut_detection_tpu.config import TrainConfig
from cut_detection_tpu.pipeline import segment_video_file as jax_segment
from cut_detection_tpu.train.checkpointing import save_model_triplet
from cut_detection_tpu.train.supervised import init_train_state
from cut_detection_tpu_torch.cli import serve
from cut_detection_tpu_torch.data import native_video
from cut_detection_tpu_torch.pipeline import classify_video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CPU = torch.device("cpu")
SMALL = TrainConfig(conv_layers=2, conv_hidden_channels=8, avg_pool_size=2,
                    linear_layers=2, linear_size=8, output_size=3,
                    batch_size=8, epochs=1)


def _start(**kw):
    srv, state = serve.make_server("127.0.0.1", 0, device=CPU, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, state, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    srv, state, base = _start()
    yield base, state
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_csv(synthetic_video, tmp_path_factory):
    """The JAX pipeline's CSV bytes of the synthetic clip (float32, bgr)."""
    out = str(tmp_path_factory.mktemp("jax") / "jax.csv")
    jax_segment(synthetic_video, out, print_every=0, transfer="bgr",
                decode_process=False)
    with open(out, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def triplets(tmp_path_factory):
    """Small trained-model triplets written by the JAX trainer: ``small``,
    ``swap`` and ``alt``, and ``broken`` (its head from a wider net)."""
    d = tmp_path_factory.mktemp("triplets")
    for seed, name in enumerate(("small", "swap", "alt")):
        save_model_triplet(str(d), name,
                           init_train_state(jax.random.PRNGKey(seed), SMALL),
                           SMALL)
    big = TrainConfig(conv_layers=2, conv_hidden_channels=16,
                      avg_pool_size=2, linear_layers=2, linear_size=8,
                      output_size=3, batch_size=8, epochs=1)
    save_model_triplet(str(d), "broken",
                       init_train_state(jax.random.PRNGKey(0), SMALL), SMALL)
    save_model_triplet(str(d), "donor",
                       init_train_state(jax.random.PRNGKey(1), big), big)
    shutil.copy(os.path.join(d, "donor_classifier_linear.npz"),
                os.path.join(d, "broken_classifier_linear.npz"))
    return str(d)


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, token=None):
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", "Bearer " + token)
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_healthz(server):
    status, data = _get(server[0] + "/healthz")
    assert status == 200 and data["status"] == "ok"
    assert data["models"] == ["default"] and data["device"] is None


def test_segment_request_equals_the_jax_pipeline(server, synthetic_video,
                                                 jax_csv, tmp_path):
    base, state = server
    out = str(tmp_path / "served.csv")
    status, data = _post(base + "/segment", {
        "input_path": synthetic_video, "output_path": out,
        "batch_size": 64, "transfer": "bgr"})
    assert status == 200, data
    assert data["output_path"] == out
    assert data["stats"]["frames"] == 240 and data["stats"]["batches"] == 4
    assert all(lab in ("a22", "ez", "b") for _, lab in data["segments"])
    assert _read(out) == jax_csv
    assert state.requests_served >= 1


@pytest.mark.parametrize("clip,ref", [("clip.mp4", "ref_segments.csv"),
                                      ("clip_odd.mp4",
                                       "ref_segments_odd.csv")])
def test_segment_golden_clips(server, clip, ref, tmp_path):
    out = str(tmp_path / "golden.csv")
    status, data = _post(server[0] + "/segment", {
        "input_path": os.path.join(GOLDEN, clip), "output_path": out,
        "transfer": "bgr"})
    assert status == 200, data
    assert _read(out) == _read(os.path.join(GOLDEN, ref))


def test_segment_bad_requests(server):
    base, _ = server
    assert _post(base + "/segment", {})[0] == 400
    status, data = _post(base + "/segment", {"input_path": "/no/such.mp4"})
    assert status == 400 and "does not exist" in data["error"]
    assert _post(base + "/nope", {})[0] == 404
    assert _get(base + "/nope")[0] == 404
    assert _get(base + "/healthz")[0] == 200  # alive after errors


def test_concurrent_requests_serialize_with_unchanged_csvs(
        server, synthetic_video, jax_csv, tmp_path):
    """Two requests at once both succeed (the device lock serializes them,
    the second's decode running ahead), and their CSVs are the JAX
    pipeline's."""
    results = []

    def hit(tag):
        out = str(tmp_path / f"c{tag}.csv")
        status, _ = _post(server[0] + "/segment", {
            "input_path": synthetic_video, "output_path": out})
        results.append((status, out))

    ts = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert len(results) == 2
    for status, out in results:
        assert status == 200 and _read(out) == jax_csv
    assert "lock_wait_p50_s" in _get(server[0] + "/metrics")[1]


def test_serve_custom_model_dir(triplets, synthetic_video, tmp_path):
    srv, state, base = _start(model_dir=triplets, model_name="small")
    try:
        assert state.net.num_params() < 67971
        status, data = _post(base + "/segment", {
            "input_path": synthetic_video, "batch_size": 64,
            "frame_limit": 64, "output_path": str(tmp_path / "c.csv")})
        assert status == 200 and data["stats"]["frames"] == 128
    finally:
        srv.shutdown()
        srv.server_close()


def test_metrics_endpoint(server, synthetic_video, tmp_path):
    base, _ = server
    status, _ = _post(base + "/segment", {
        "input_path": synthetic_video, "output_path": str(tmp_path / "m.csv"),
        "batch_size": 64, "frame_limit": 64})
    assert status == 200
    m = _get(base + "/metrics")[1]
    assert m["requests_served"] >= 1 and m["frames_total"] >= 64
    assert m["latency_p50_s"] > 0 and m["queue_depth"] == 0
    assert m["precision"] == "float32"
    _post(base + "/segment", {"input_path": "/no/such.mp4"})
    assert _get(base + "/metrics")[1]["requests_failed"] >= 1


def test_upload_then_segment(server, synthetic_video, tmp_path):
    base, state = server
    raw = _read(synthetic_video)
    name = urllib.parse.quote("../evil dir/ga me.mp4")
    req = urllib.request.Request(base + "/upload?name=" + name, data=raw,
                                 method="POST")
    with urllib.request.urlopen(req) as resp:
        up = json.loads(resp.read())
    assert up["bytes"] == len(raw)
    assert up["input_path"].startswith(state.spool_dir)
    assert "/evil" not in up["input_path"] and " " not in up["input_path"]
    status, data = _post(base + "/segment", {
        "input_path": up["input_path"], "batch_size": 64,
        "frame_limit": 64, "output_path": str(tmp_path / "u.csv")})
    assert status == 200 and data["stats"]["frames"] == 128


def test_upload_size_cap_and_spool_ttl(server):
    base, state = server
    old = state.max_upload_bytes, state.spool_ttl_s
    state.max_upload_bytes = 10
    try:
        req = urllib.request.Request(base + "/upload", data=b"x" * 100,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 413
        state.spool_ttl_s = 0.05

        def upload(name, body):
            req = urllib.request.Request(base + "/upload?name=" + name,
                                         data=body, method="POST")
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read())["input_path"]

        first = upload("a.bin", b"abc")
        assert os.path.exists(first)
        time.sleep(0.2)
        second = upload("b.bin", b"def")
        assert not os.path.exists(first) and os.path.exists(second)
    finally:
        state.max_upload_bytes, state.spool_ttl_s = old


def test_segment_batch_equals_the_references(server, synthetic_video,
                                             jax_csv, tmp_path):
    """/segment_batch over the golden clips and the synthetic clip writes
    each CSV next to its video (the reference's naming), byte-equal to
    the golden CSVs and the JAX pipeline's, and isolates a failing
    video."""
    base, _ = server
    clips = [shutil.copy(os.path.join(GOLDEN, c), str(tmp_path / c))
             for c in ("clip.mp4", "clip_odd.mp4")]
    status, data = _post(base + "/segment_batch", {
        "input_paths": [*clips, synthetic_video, "/no/such.mp4"],
        "transfer": "bgr"})
    assert status == 200
    *ok, bad = data["results"]
    assert "error" in bad
    refs = [_read(os.path.join(GOLDEN, r))
            for r in ("ref_segments.csv", "ref_segments_odd.csv")]
    for result, want in zip(ok, refs + [jax_csv]):
        assert _read(result["output_path"]) == want
    assert _post(base + "/segment_batch", {"input_paths": []})[0] == 400
    status, data = _post(base + "/segment_batch", {
        "input_paths": [synthetic_video], "output_path": "/tmp/x.csv"})
    assert status == 400 and "output_path" in data["error"]


def test_segment_batch_pipelines_decode_ahead(server, synthetic_video,
                                              tmp_path):
    base, state = server
    assert state.decode_ahead is True
    copy = str(tmp_path / "copy.mp4")
    shutil.copy(synthetic_video, copy)
    status, data = _post(base + "/segment_batch", {
        "input_paths": [synthetic_video, copy, synthetic_video],
        "batch_size": 64})
    assert status == 200
    r = data["results"]
    assert len(r) == 3 and all("segments" in x for x in r)
    assert r[0]["segments"] == r[1]["segments"] == r[2]["segments"]
    status, one = _post(base + "/segment", {
        "input_path": synthetic_video, "batch_size": 64,
        "output_path": str(tmp_path / "one.csv")})
    assert status == 200 and one["segments"] == r[0]["segments"]
    # A bad model name must not wedge the pipelined producer.
    status, data = _post(base + "/segment_batch", {
        "input_paths": [synthetic_video], "model": "nope"})
    assert status == 200 and "error" in data["results"][0]
    assert state.active_prefetch == 0


def test_reload_every_precision_and_triplets(server, triplets,
                                             synthetic_video, tmp_path):
    """/reload takes every precision and a user triplet, serves on it,
    rejects a bad precision, a missing dir and a mismatched triplet
    without disturbing the served model, and returns to the prod net."""
    base, state = server
    for precision in ("uint8_chain", "int8_mxu", "float32"):
        status, data = _post(base + "/reload", {"precision": precision})
        assert status == 200 and data["precision"] == precision, data
    assert _post(base + "/reload", {"precision": "nope"})[0] == 400
    status, data = _post(base + "/reload", {"model_dir": triplets,
                                            "model_name": "swap"})
    assert status == 200 and data["status"] == "reloaded"
    small = data["params"]
    status, _ = _post(base + "/segment", {
        "input_path": synthetic_video, "batch_size": 64, "frame_limit": 64,
        "output_path": str(tmp_path / "s.csv")})
    assert status == 200
    for bad in ({"model_dir": "/no/such/dir", "model_name": "x"},
                {"model_dir": triplets, "model_name": "broken"}):
        assert _post(base + "/reload", bad)[0] == 400
        assert state.net.num_params() == small
    status, data = _post(base + "/reload", {})
    assert status == 200 and data["params"] == 67971


def test_tls_and_mtls(tmp_path):
    d = tmp_path

    def ossl(*args):
        subprocess.run(["openssl", *args], check=True, cwd=d,
                       capture_output=True)

    ossl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "2",
         "-keyout", "server.key", "-out", "server.crt", "-subj",
         "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1")
    ossl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "2",
         "-keyout", "ca.key", "-out", "ca.crt", "-subj", "/CN=testca")
    ossl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", "client.key",
         "-out", "client.csr", "-subj", "/CN=client")
    ossl("x509", "-req", "-in", "client.csr", "-CA", "ca.crt", "-CAkey",
         "ca.key", "-CAcreateserial", "-days", "2", "-out", "client.crt")
    srv, _, base = _start(certfile=str(d / "server.crt"),
                          keyfile=str(d / "server.key"),
                          client_ca=str(d / "ca.crt"))
    base = base.replace("http:", "https:")
    try:
        trust = ssl.create_default_context(cafile=str(d / "server.crt"))
        with pytest.raises(Exception):
            urllib.request.urlopen(base + "/healthz", context=trust,
                                   timeout=10)
        ctx = ssl.create_default_context(cafile=str(d / "server.crt"))
        ctx.load_cert_chain(str(d / "client.crt"), str(d / "client.key"))
        with urllib.request.urlopen(base + "/healthz", context=ctx,
                                    timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        srv.shutdown()
        srv.server_close()
    with pytest.raises(ValueError, match="client-ca requires"):
        serve.make_server("127.0.0.1", 0, client_ca="/tmp/nope.crt",
                          device=CPU)


def test_multi_model_routing(server, triplets, synthetic_video, tmp_path):
    assert serve._parse_model_flags(["a=/d", "b=/e:custom"]) == {
        "a": ("/d", "init_model"), "b": ("/e", "custom")}
    with pytest.raises(ValueError, match="reserved"):
        serve._parse_model_flags(["default=/d"])
    with pytest.raises(ValueError, match="twice"):
        serve._parse_model_flags(["a=/d", "a=/e"])
    base, state = server
    status, data = _post(base + "/reload", {
        "model": "alt", "model_dir": triplets, "model_name": "alt"})
    assert status == 200 and data["model"] == "alt"
    assert _get(base + "/healthz")[1]["models"] == ["default", "alt"]
    status, data = _post(base + "/segment", {
        "input_path": synthetic_video, "model": "alt", "batch_size": 64,
        "frame_limit": 64, "output_path": str(tmp_path / "alt.csv")})
    assert status == 200 and data["stats"]["frames"] == 128
    status, data = _post(base + "/segment", {
        "input_path": synthetic_video, "model": "nope"})
    assert status == 400 and "unknown model" in data["error"]
    assert state.net.num_params() == 67971
    state.nets.pop("alt")


@pytest.mark.parametrize("token", ["sekrit", "sécret"])
def test_auth_token_gate(server, token):
    """Everything but /healthz needs the bearer token; a non-ASCII token
    gets a clean 401, not a dead handler thread."""
    base, state = server
    state.auth_token = token
    try:
        assert _get(base + "/healthz")[0] == 200
        assert _get(base + "/metrics")[0] == 401
        assert _get(base + "/metrics", "wrong")[0] == 401
        assert _get(base + "/metrics", token)[0] == 200
        assert _post(base + "/segment", {"input_path": "/x.mp4"})[0] == 401
    finally:
        state.auth_token = None


def test_segment_threshold_passthrough(server, synthetic_video, tmp_path):
    """Request thresholds reach the glue: the CSV equals the JAX
    pipeline's at the same non-default thresholds."""
    direct = str(tmp_path / "direct.csv")
    _, seg, _ = jax_segment(synthetic_video, direct, base_threshold=8,
                            blank_threshold=4, print_every=0,
                            transfer="bgr", decode_process=False)
    served = str(tmp_path / "served.csv")
    status, data = _post(server[0] + "/segment", {
        "input_path": synthetic_video, "output_path": served,
        "base_threshold": 8, "blank_threshold": 4})
    assert status == 200
    assert [sf for sf, _ in data["segments"]] == [
        int(s) for s in seg.te["start_frames"]]
    assert _read(served) == _read(direct)


def test_prefetch_slot_accounting(synthetic_video):
    state = serve._State()
    state.prefetch_slots = 1
    h1 = serve._try_prefetch(state, synthetic_video, 32, 1)
    assert h1 is not None and state.active_prefetch == 1
    assert serve._try_prefetch(state, synthetic_video, 32, 1) is None
    h1[1].close()
    assert state.active_prefetch == 0
    h1[1].close()  # the slot is released exactly once
    assert state.active_prefetch == 0
    h2 = serve._try_prefetch(state, synthetic_video, 32, 1)
    assert h2 is not None and state.active_prefetch == 1
    h2[1].close()
    state.decode_ahead = False
    assert serve._try_prefetch(state, synthetic_video, 32, 1) is None
    state.decode_ahead = True
    assert serve._try_prefetch(state, "/nonexistent.mp4", 32, 1) is None
    assert state.active_prefetch == 0


def test_prefetch_slot_released_on_drain(synthetic_video):
    state = serve._State()
    h = serve._try_prefetch(state, synthetic_video, 32, 1)
    assert h is not None and state.active_prefetch == 1
    classify_video(synthetic_video, device=CPU, batch_size=32,
                   print_every=0, preloaded=h)
    assert state.active_prefetch == 0


def test_decode_ahead_starts_while_device_busy(server, synthetic_video,
                                               tmp_path):
    base, state = server
    results = []

    def hit():
        results.append(_post(base + "/segment", {
            "input_path": synthetic_video,
            "output_path": str(tmp_path / "o.csv")}))

    state.lock.acquire()  # an in-flight request holding the device
    try:
        t = threading.Thread(target=hit)
        t.start()
        deadline = time.time() + 30
        while state.active_prefetch == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert state.active_prefetch > 0
    finally:
        state.lock.release()
    t.join(timeout=120)
    assert results and results[0][0] == 200
    assert state.active_prefetch == 0


def test_warmup_server_and_reload(synthetic_video, tmp_path, monkeypatch):
    """warmup=True runs the serving-shape step of every transfer that can
    run (``_warmup_net`` each time) and still serves; /reload follows the
    server's policy and its request flag overrides it."""
    calls = []
    real = serve._warmup_net
    monkeypatch.setattr(serve, "_warmup_net",
                        lambda net, **kw: calls.append(kw) or real(net, **kw))
    srv, state, base = _start(warmup=True)
    try:
        modes = serve._warmup_modes(state)
        assert [c["transfer"] for c in calls] == modes
        status, data = _post(base + "/segment", {
            "input_path": synthetic_video, "batch_size": 64,
            "frame_limit": 64, "output_path": str(tmp_path / "w.csv")})
        assert status == 200 and data["stats"]["frames"] == 128
        state.warmup_default = False
        assert _post(base + "/reload", {})[0] == 200
        assert len(calls) == len(modes)
        assert _post(base + "/reload", {"warmup": True})[0] == 200
        assert len(calls) == 2 * len(modes)
    finally:
        srv.shutdown()
        srv.server_close()
    assert serve._warmup_net(state.net) >= 0.0  # on the port's step


def test_parser_flags_and_refusals(capsys):
    p = serve.build_parser()
    assert p.parse_args([]).no_warmup is False
    assert p.parse_args(["--no-warmup"]).no_warmup is True
    assert p.parse_args([]).transfer == "auto"
    assert p.parse_args(["--transfer", "yuv420"]).transfer == "yuv420"
    with pytest.raises(SystemExit):
        serve.main(["--data-parallel", "--cpu"])
    assert "Queue 1 item 5" in capsys.readouterr().err


def test_device_heartbeat_healthz():
    srv, state, base = _start(heartbeat_interval=0.1)
    try:
        deadline = time.time() + 10
        data = None
        while time.time() < deadline:
            data = _get(base + "/healthz")[1]
            if data["device"] and data["device"]["ok_age_s"] < 5:
                break
            time.sleep(0.2)
        assert data["status"] == "ok" and data["device"]["stuck"] is False
        assert data["device"]["last_error"] is None
        state.heartbeat.stop()
        with state.heartbeat._meta:
            state.heartbeat._last_ok = (
                time.monotonic() - state.heartbeat.stale_after - 1)
        status, data = _get(base + "/healthz")
        assert status == 503 and data["status"] == "stuck"
        state.record(0.0, 0.1, 10)  # a served request proves the device
        assert _get(base + "/healthz")[1]["status"] == "ok"
    finally:
        srv.shutdown()
        srv.server_close()


def test_device_heartbeat_probe_cap_and_relaunch():
    hb = serve._DeviceHeartbeat(interval=3600, device=CPU)
    with hb._meta:
        hb._outstanding = hb._MAX_OUTSTANDING
    hb._probe()  # the probe runs on the device and marks the clock
    assert hb.status()["stuck"] is False
    assert hb.status()["outstanding_probes"] == hb._MAX_OUTSTANDING - 1
    assert hb.status()["last_error"] is None
    with hb._meta:
        hb._outstanding = hb._MAX_OUTSTANDING
        hb._last_launch = time.monotonic() - hb.stale_after - 1
    assert (time.monotonic() - hb._last_launch) >= hb.stale_after
    broken = serve._DeviceHeartbeat(interval=3600, device="meta")
    with broken._meta:
        broken._outstanding = 1
    broken._probe()  # a device that cannot answer is a liveness miss
    assert broken.status()["last_error"] is not None
    assert broken.status()["outstanding_probes"] == 0


def test_healthz_redacts_error_detail_when_authed():
    srv, state, base = _start(auth_token="sekrit", heartbeat_interval=3600)
    with state.heartbeat._meta:
        state.heartbeat._last_err = "RuntimeError: internal /host/path"
        state.heartbeat._last_ok = time.monotonic()
    try:
        h = _get(base + "/healthz")[1]
        assert h["device"] is not None and "last_error" not in h["device"]
        m = _get(base + "/metrics", "sekrit")[1]
        assert m["device"]["last_error"] == \
            "RuntimeError: internal /host/path"
    finally:
        state.heartbeat.stop()
        srv.shutdown()
        srv.server_close()


def test_segment_request_transfers(server, synthetic_video, tmp_path,
                                   monkeypatch):
    """A per-request transfer: "auto" resolves (bgr on the CPU) and
    serves; an unknown one is a 400; yuv420 runs where the native YUV
    decoder is built (deterministic, no BGR decode-ahead left claiming a
    slot) and is a 501 capability gap where it is not."""
    base, state = server
    status, data = _post(base + "/segment", {
        "input_path": synthetic_video, "batch_size": 64, "transfer": "auto",
        "output_path": str(tmp_path / "auto.csv")})
    assert status == 200 and data["stats"]["frames"] == 240
    status, data = _post(base + "/segment", {
        "input_path": synthetic_video, "transfer": "rgb565"})
    assert status == 400 and "transfer" in data["error"]
    if native_video.yuv_available():
        outs = []
        for tag in ("a", "b"):
            out = str(tmp_path / f"yuv_{tag}.csv")
            status, data = _post(base + "/segment", {
                "input_path": synthetic_video, "output_path": out,
                "batch_size": 64, "transfer": "yuv420"})
            assert status == 200 and data["stats"]["frames"] == 240
            outs.append(_read(out))
        assert outs[0] == outs[1]
        assert state.active_prefetch == 0
    monkeypatch.setattr(native_video, "yuv_available", lambda: False)
    status, data = _post(base + "/segment", {
        "input_path": synthetic_video, "transfer": "yuv420"})
    assert status == 501 and "unavailable on this server" in data["error"]


def test_server_transfer_default(synthetic_video, tmp_path):
    """make_server resolves "auto" to a concrete default (bgr on the
    CPU); a yuv420 server uses it for requests that name none, and a
    request's "bgr" overrides it."""
    srv, state = serve.make_server("127.0.0.1", 0, transfer="auto",
                                   device=CPU)
    srv.server_close()
    assert state.transfer == "bgr"
    assert serve._warmup_modes(state) == (
        ["bgr", "yuv420"] if native_video.yuv_available() else ["bgr"])
    if not native_video.yuv_available():
        with pytest.raises(ValueError, match="yuv420 needs"):
            serve.make_server("127.0.0.1", 0, transfer="yuv420", device=CPU)
        return
    srv, state, base = _start(transfer="yuv420")
    try:
        assert state.transfer == "yuv420"
        assert serve._warmup_modes(state) == ["yuv420", "bgr"]
        for transfer in (None, "bgr"):
            req = {"input_path": synthetic_video, "batch_size": 64,
                   "frame_limit": 64,
                   "output_path": str(tmp_path / f"{transfer}.csv")}
            if transfer:
                req["transfer"] = transfer
            status, data = _post(base + "/segment", req)
            assert status == 200 and data["stats"]["frames"] == 128
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_needs_a_device_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --cpu"):
        serve.make_server("127.0.0.1", 0)
    with pytest.raises(SystemExit):
        serve.main(["--port", "0"])
    assert "--cpu" in capsys.readouterr().err
