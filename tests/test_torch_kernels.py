"""The port's block kernels: plain versions against the JAX package on the
CPU.  The CUDA kernels themselves are held to these plain versions on the
card by ``tests/test_torch_cuda.py``.

The JAX side runs the Pallas kernels as the JAX tests do: K2
(``conv1_pool_fused``) under ``pltpu.force_tpu_interpret_mode()``, K3
(``fused_conv_block_pm``) with ``interpret=True``.  Tolerances are the
JAX tests' own: 1e-4 for layer 1, 1e-5 for the f32 mid-stack block
against ``apply_conv_block``, 2e-5 per bf16 block and 5e-5 chained.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cut_detection_tpu.models.assembly import (
    fold_preprocess as jax_fold_preprocess,
)
from cut_detection_tpu.models.assembly import load_default_net as jax_default
from cut_detection_tpu.models.layers import apply_conv_block
from cut_detection_tpu.ops.nn import BN_EPS
from cut_detection_tpu.ops.pallas.conv1_kernel import conv1_pool_fused
from cut_detection_tpu.ops.pallas.fused_block_pm import fused_conv_block_pm
from cut_detection_tpu_torch.ops.kernels import _build
from cut_detection_tpu_torch.ops.kernels.conv1_block import (
    conv1_block,
    conv1_block_plain,
)
from cut_detection_tpu_torch.ops.kernels.conv_block import (
    conv_block,
    conv_block_plain,
)
from cut_detection_tpu_torch.ops.nn import bn_scale_offset

T = torch.from_numpy


@pytest.fixture(scope="module")
def layer1():
    """The prod net's preprocess-folded layer 1, as numpy."""
    net, _ = jax_default()
    fb = jax_fold_preprocess(jax.device_get(net.bundle))
    p = {k: np.array(v) for k, v in fb["conv"]["params"][0].items()}
    s = {k: np.array(v) for k, v in fb["conv"]["state"][0].items()}
    return p, s


def _port_args(p, s):
    scale, offset = bn_scale_offset(T(s["mean"]), T(s["var"]),
                                    T(p["gamma"]), T(p["beta"]))
    return T(p["kernel"].copy()), T(p["bias"]), scale, offset


def _block_params(rng, cin, cout):
    p = {"kernel": rng.normal(0, 0.1, (3, 3, cin, cout)),
         "bias": rng.normal(0, 0.1, cout),
         "gamma": rng.normal(1, 0.1, cout),
         "beta": rng.normal(0, 0.1, cout)}
    s = {"mean": rng.normal(0, 0.5, cout), "var": rng.uniform(0.5, 2, cout)}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return f32(p), f32(s)


@pytest.mark.parametrize("b,h,w", [(1, 144, 256), (2, 36, 64), (2, 37, 64)])
def test_conv1_block_plain_matches_jax(layer1, b, h, w):
    """Layer 1 from raw uint8 against K2 and against the XLA block;
    (37, 64) takes floor pooling over an H that 3 does not divide."""
    p, s = layer1
    x = np.random.default_rng(h).integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)
    with pltpu.force_tpu_interpret_mode():
        k2 = np.asarray(conv1_pool_fused(
            jnp.asarray(x), p["kernel"], p["bias"], s["mean"], s["var"],
            p["gamma"], p["beta"]))
    xla, _ = apply_conv_block(p, s, jnp.asarray(x, jnp.float32), train=False)
    got = conv1_block_plain(T(x), *_port_args(p, s)).numpy()
    assert got.shape == k2.shape == (b, h // 3, (w - 3) // 3 + 1, 48)
    np.testing.assert_allclose(got, k2, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 48, 85, 48, 48),   # prod layer 2
    (2, 16, 28, 48, 48),   # prod layer 3 (H % 3 != 0)
    (1, 10, 9, 8, 8),
    (1, 12, 20, 3, 16),    # unfolded layer 1 on float frames
])
def test_conv_block_f32_matches_apply_conv_block(b, h, w, cin, cout):
    rng = np.random.default_rng(hash((b, h, w, cin)) % 2**31)
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    p, s = _block_params(rng, cin, cout)
    want, _ = apply_conv_block(p, s, jnp.asarray(x), train=False)
    got = conv_block_plain(T(x), *_port_args(p, s))
    assert tuple(got.shape) == (b, h // 3, (w - 3) // 3 + 1, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _pm_scale_offset(p, s):
    """K3's BN affine: gamma / sqrt(var + eps) (fused_block_pm.py:136)."""
    scale = T(p["gamma"]) / torch.sqrt(T(s["var"]) + BN_EPS)
    return scale, T(p["beta"]) - T(s["mean"]) * scale


def _k3(x, p, s):
    return fused_conv_block_pm(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in ("kernel", "bias",
                                                      "gamma", "beta")),
        jnp.asarray(s["mean"]), jnp.asarray(s["var"]),
        out_dtype=jnp.float32, interpret=True)


def _port_bf16(x, p, s):
    return conv_block_plain(T(np.asarray(x)), T(p["kernel"]), T(p["bias"]),
                            *_pm_scale_offset(p, s),
                            compute_dtype="bfloat16_full")


def _bf16_input(rng, shape):
    x = rng.normal(0, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _assert_k3_close(got, want, offset, tol):
    """``rtol = atol = tol`` — except where the two f32 summation orders
    (oneDNN here, XLA's dot in the Pallas interpreter) put a value on two
    sides of a bf16 rounding boundary.  Such a crossing moves the pooled
    activation ``m`` (``y = m*s + t``) by one bf16 ulp, at most
    ``2^-7 |m*s|``; those elements must stay within that bound and be
    rare (at most 0.1%)."""
    assert got.shape == want.shape
    diff = np.abs(got - want)
    close = diff <= tol + tol * np.abs(want)
    one_ulp = diff <= 2.0 ** -7 * np.abs(want - offset) * 1.001 + tol
    assert one_ulp.all(), f"max diff {diff.max()} beyond one bf16 ulp"
    crossings = int(np.count_nonzero(~close))
    assert crossings <= 1e-3 * want.size, (
        f"{crossings} of {want.size} elements outside {tol}")


@pytest.mark.parametrize("h,w", [(48, 85), (16, 28)])
def test_conv_block_bf16_matches_k3(h, w):
    rng = np.random.default_rng(h)
    x = _bf16_input(rng, (2, h, w, 48))
    p, s = _block_params(rng, 48, 48)
    want = np.asarray(_k3(x, p, s))
    got = _port_bf16(x, p, s).numpy()
    _assert_k3_close(got, want, _pm_scale_offset(p, s)[1].numpy(), 2e-5)


def test_conv_block_bf16_chained_prod_shapes():
    rng = np.random.default_rng(7)
    x = _bf16_input(rng, (2, 48, 85, 48))
    p2, s2 = _block_params(rng, 48, 48)
    p3, s3 = _block_params(rng, 48, 48)
    want = np.asarray(_k3(_k3(x, p2, s2), p3, s3))
    got = _port_bf16(_port_bf16(x, p2, s2).numpy(), p3, s3).numpy()
    assert got.shape == (2, 5, 9, 48)
    _assert_k3_close(got, want, _pm_scale_offset(p3, s3)[1].numpy(), 5e-5)


def test_wrappers_on_cpu_take_the_plain_version(layer1):
    """A CPU tensor runs the plain version and launches nothing."""
    p, s = layer1
    rng = np.random.default_rng(3)
    x = T(rng.integers(0, 256, (1, 9, 12, 3), dtype=np.uint8))
    args = _port_args(p, s)
    before = (conv1_block.launches, conv_block.launches)
    torch.testing.assert_close(conv1_block(x, *args),
                               conv1_block_plain(x, *args), rtol=0, atol=0)
    xf = T(rng.normal(0, 1, (1, 9, 12, 3)).astype(np.float32))
    kf = args[0] * 255.0
    torch.testing.assert_close(conv_block(xf, kf, *args[1:]),
                               conv_block_plain(xf, kf, *args[1:]),
                               rtol=0, atol=0)
    assert (conv1_block.launches, conv_block.launches) == before == (0, 0)


def test_expect_rejects_bad_arguments():
    t = torch.zeros(2, 3)
    cpu = torch.device("cpu")
    _build.expect(t, "t", torch.float32, (2, 3), cpu)
    with pytest.raises(TypeError):
        _build.expect(t, "t", torch.uint8, (2, 3), cpu)
    with pytest.raises(ValueError):
        _build.expect(t, "t", torch.float32, (3, 2), cpu)
    with pytest.raises(ValueError):
        _build.expect(t.t(), "t", torch.float32, (3, 2), cpu)


@pytest.mark.parametrize("stamp", ["current", "stale", "missing"])
def test_build_recompiles_only_a_stale_library(monkeypatch, tmp_path, stamp):
    """``build()`` loads a library stamped with the sources' hash as it is
    and hands anything else to ``rebuild()``."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    lib = tmp_path / _build.LIB_NAME
    lib.write_bytes(b"")
    if stamp != "missing":
        digest = _build._source_hash() if stamp == "current" else "0" * 64
        (tmp_path / (_build.LIB_NAME + ".sha256")).write_text(digest + "\n")
    calls = []
    monkeypatch.setattr(_build, "rebuild",
                        lambda: calls.append(1) or "rebuilt")
    got = _build.build()
    assert (got, calls) == ((str(lib), []) if stamp == "current"
                            else ("rebuilt", [1]))


def _fake_nvcc(monkeypatch, tmp_path, fail: str = "") -> None:
    """An ``nvcc`` on PATH that writes its ``-o`` file and prints one line
    per call, and fails on a source named ``fail``."""
    script = tmp_path / "bin" / "nvcc"
    script.parent.mkdir()
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "out = args[args.index('-o') + 1]\n"
        f"if {fail!r} and any(a.endswith({fail!r}) for a in args):\n"
        "    print('error in', args[-1]); sys.exit(2)\n"
        "open(out, 'w').close()\n"
        "print('built', out.rsplit('/', 1)[-1].split('.')[0])\n")
    script.chmod(0o755)
    monkeypatch.setenv("PATH", f"{script.parent}{os.pathsep}"
                               f"{os.environ['PATH']}")


def test_rebuild_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One compile per source, then one link: the library and its stamp
    are written, the objects removed, and every call's output kept."""
    _fake_nvcc(monkeypatch, tmp_path)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    path = _build.rebuild()
    assert path == str(build_dir / _build.LIB_NAME)
    assert sorted(os.listdir(build_dir)) == [_build.LIB_NAME,
                                             _build.LIB_NAME + ".sha256"]
    stems = [os.path.basename(s).split(".")[0] for s in _build._sources()
             if s.endswith(".cu")]
    assert _build.BuildInfo.log.split() == (
        [w for s in stems for w in ("built", s)]
        + ["built", "libcutdet_kernels"])


def test_rebuild_raises_on_a_failed_compile(monkeypatch, tmp_path):
    """A source that fails to compile raises with nvcc's output, writes no
    library and leaves no object behind."""
    _fake_nvcc(monkeypatch, tmp_path, fail="conv_block.cu")
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    with pytest.raises(RuntimeError, match="error in .*conv_block.cu"):
        _build.rebuild()
    assert os.listdir(build_dir) == []


def test_run_all_stops_the_others_when_one_fails(monkeypatch, tmp_path):
    """Every command starts at once; when one fails, those still running
    are stopped before the error is raised."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    started = []
    popen = subprocess.Popen

    def track(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(_build.subprocess, "Popen", track)
    fail = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    slow = [sys.executable, "-c", "import time; time.sleep(60)"]
    with pytest.raises(RuntimeError, match="boom"):
        _build._run_all([fail, slow])
    assert len(started) == 2
    assert all(p.poll() is not None for p in started)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
