"""The stage-bisection microbenchmark of layer 1, ``conv1_stages``, held to
the TPU kernel it ports (``_kernel`` of ``scripts/profile_fused_conv1.py``)
at batch 1 on the script's seeded inputs, and the port's entry point
``cut_detection_tpu_torch.scripts.profile_fused_conv1`` on the CPU.

The TPU kernel's output starts uninitialised (NaN in interpret mode), so
it runs here through a pallas_call of its own with ``interpret=True`` and
an ``out_ref`` zero-filled before the kernel body; the port defines those
zeros.  ``cast``, ``taps``, ``dotn`` and ``dott`` run that way.  ``tpose``
and ``full`` do not: XLA:CPU has no BF16 x BF16 = F32 dot for the
interpreter ("Unsupported element type for DotThunk").  They are held to a
numpy transcription of the kernel's code (its im2col scratch, its
transpose, its strided phase maxes and row loop), whose accumulator is
first held to the TPU kernel's ``dotn`` output.

Tolerances: ``cast`` exact (a byte's bf16 is exact); ``taps`` and
``dott`` leave zeros; ``dotn``'s f32 sums of exact bf16 products differ
from the plain version's (float64, rounded once) by their rounding error,
at most (27 + 12) * 2^-24 of the sum of the terms' magnitudes; we allow
2^-18 of it.  ``tpose`` and ``full`` add bf16-rounded values: they are
held by ``conv1_stages.check_stage``, which allows a term to differ only
where its accumulator lies within ``CARD_SUM_TOL`` of a bf16 rounding
boundary, and which rejects the plain version without the rounding.
The sinks the port adds (``taps``: the packed tiles' checksum; ``dott``:
a position- and channel-weighted sum of the accumulators) are held to
numpy derivations from their definitions.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cut_detection_tpu_torch.ops.kernels import conv1_stages as cs
from cut_detection_tpu_torch.scripts import profile_fused_conv1 as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tpu_module(monkeypatch_module):
    """``scripts/profile_fused_conv1.py`` loaded by path, with JAX's
    persistent compile cache (which its import enables) switched off."""
    monkeypatch_module.setenv("CUTDET_NO_COMPILE_CACHE", "1")
    spec = importlib.util.spec_from_file_location(
        "tpu_profile_fused_conv1",
        os.path.join(REPO, "scripts", "profile_fused_conv1.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def inputs():
    x, w = prof.seeded_inputs(1, "cpu")
    return x, w


def tpu_stage(mod, stage, x, w):
    """The TPU kernel at ``stage`` in interpret mode, ``out`` zeroed
    first; the scratch shapes of the script's ``build``."""
    h, w_, ws, strip_rows = cs.H, cs.W, cs.WS, cs.STRIP_ROWS
    m, flat = strip_rows * ws, (h + 2) * ws
    kern = functools.partial(mod._kernel, h=h, w=w_, ws=ws,
                             strip_rows=strip_rows, out_w=cs.OUT_W,
                             stage=stage)

    def zeroed(x_ref, w_ref, out_ref, *scratch):
        out_ref[...] = jnp.zeros(out_ref.shape, jnp.float32)
        kern(x_ref, w_ref, out_ref, *scratch)

    b = x.shape[0]
    out = pl.pallas_call(
        zeroed,
        grid=(b,),
        in_specs=[pl.BlockSpec((1, 3, flat), lambda i: (i, 0, 0)),
                  pl.BlockSpec((48, 32), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 128, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 128, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((3, flat + 2), jnp.bfloat16),
                        pltpu.VMEM((32, m), jnp.bfloat16),
                        pltpu.VMEM((m, 48), jnp.float32),
                        pltpu.VMEM((m // 3, 48), jnp.float32)],
        interpret=True,
    )(jnp.asarray(x.numpy()),
      jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
    return np.asarray(out)


def numpy_stages(x, w):
    """A numpy transcription of the TPU kernel's code for one image, f64
    dots: (``dotn``'s out, ``tpose``'s, ``full``'s, the im2col values of
    every strip, every strip's accumulator)."""
    h, ws, sr = cs.H, cs.WS, cs.STRIP_ROWS
    m, flat, out_w = sr * ws, (h + 2) * ws, cs.OUT_W
    xbf = np.zeros((3, flat + 2), np.float64)
    xbf[:, 1:flat + 1] = x[0].numpy()
    wt = w.float().numpy().astype(np.float64)
    bf16 = jnp.bfloat16
    outs = {k: np.zeros((128, 128), np.float32)
            for k in ("dotn", "tpose", "full")}
    taps, accs = [], []
    for s in range(h // sr):
        base = s * sr * ws
        a = np.zeros((32, m), np.float64)
        for dy in range(3):
            for dx in range(3):
                for c in range(3):
                    start = base + dy * ws + dx
                    a[(dy * 3 + dx) * 3 + c] = xbf[c, start:start + m]
        taps.append(a[:27])
        acc = (wt @ a).astype(np.float32)  # [48, m]
        accs.append(acc)
        outs["dotn"][0:48] += acc[:, 0:128]
        z = np.maximum(acc.T, 0).astype(bf16).astype(np.float32)  # [m, 48]
        outs["tpose"][0:48] += z[0:128].T
        v = np.maximum(np.maximum(z[0::3], z[1::3]), z[2::3])
        ws3 = ws // 3
        for t in range(sr // 3):
            r0 = 3 * t * ws3
            row = np.maximum(np.maximum(v[r0:r0 + ws3],
                                        v[r0 + ws3:r0 + 2 * ws3]),
                             v[r0 + 2 * ws3:r0 + 3 * ws3])
            outs["full"][0:out_w, 0:48] += row[:out_w]
    return outs, np.stack(taps), np.stack(accs)


def strip_abs_sum(x, w):
    """Per out element of ``dotn``: the sum over the strips of
    ``|W| @ |A|``, the scale of its rounding error."""
    a = cs.im2col(x).double().abs()
    acc = torch.einsum("ok,bkp->bop", w[:, :27].double().abs(), a)
    total = torch.zeros((48, 128), dtype=torch.float64)
    for s in range(cs.N_STRIPS):
        total += acc[0, :, s * cs.M:s * cs.M + 128]
    return total.numpy()


@pytest.mark.parametrize("stage", ["cast", "taps", "dotn", "dott"])
def test_stage_matches_the_tpu_kernel(tpu_module, inputs, stage):
    x, w = inputs
    theirs = tpu_stage(tpu_module, stage, x, w)
    ours, _ = cs.conv1_stages(x, w, stage)
    ours = ours.numpy()
    assert ours.shape == theirs.shape == (1, 128, 128)
    assert np.isfinite(theirs).all()
    if stage == "dotn":
        bound = 2.0 ** -18 * strip_abs_sum(x, w)
        diff = np.abs(ours[0, :48] - theirs[0, :48])
        assert (diff <= bound).all(), diff.max()
        assert np.abs(theirs[0, :48]).max() > 100.0  # real sums
        np.testing.assert_array_equal(ours[0, 48:], theirs[0, 48:])
    else:
        np.testing.assert_array_equal(ours, theirs)
    if stage in ("taps", "dott"):
        assert not theirs.any()  # the TPU kernel leaves nothing in out


def numpy_taps_sink(x):
    """The taps checksum from its definition: each of the 48 x 11 tiles
    laid out byte by byte as ``pack_tile`` writes it (column col of staged
    row sr at byte (sr * 3 + u // 2) * 256 + ((wl >> 1) * 2 + u % 2) * 16,
    wl = col // 3, u = 3 * (wl % 2) + col % 3: taps k = dx * 3 + c 0-7 as
    bf16 there, tap 8 128 bytes on), its 32-bit words times 2 * their
    index + 1, summed mod 2^32."""
    flat = cs.FLAT
    xbf = np.zeros((3, flat + 300), np.float32)
    xbf[:, 1:flat + 1] = x[0].numpy()
    bits = (xbf.view(np.uint32) >> 16).astype(np.uint16)
    sr, col = np.divmod(np.arange(120), 24)
    wl = col // 3
    u = 3 * (wl % 2) + col % 3
    at = (sr * 3 + u // 2) * 256 + ((wl >> 1) * 2 + u % 2) * 16
    mult = 2 * np.arange(960, dtype=np.uint64) + 1
    total = 0
    for r in range(48):
        for j in range(11):
            half = np.zeros(1920, np.uint16)
            for k in range(9):
                dx, c = divmod(k, 3)
                v = bits[c, (3 * r + sr) * cs.WS + 24 * j + col + dx]
                half[(at + (2 * k if k < 8 else 128)) // 2] = v
            total += int((half.view(np.uint32).astype(np.uint64)
                          * mult).sum())
    return total % 2 ** 32


def test_tpose_and_full_against_the_kernels_code(tpu_module, inputs):
    """``tpose`` and ``full``, and both checksums, against the numpy
    transcription; its accumulator held first to the TPU kernel's
    ``dotn``."""
    x, w = inputs
    ref, taps, accs = numpy_stages(x, w)
    theirs = tpu_stage(tpu_module, "dotn", x, w)[0]
    bound = 2.0 ** -18 * strip_abs_sum(x, w)
    assert (np.abs(ref["dotn"][:48] - theirs[:48]) <= bound).all()
    zero = torch.zeros(1)
    for stage in ("tpose", "full"):
        ours = cs.conv1_stages(x, w, stage)
        want = torch.from_numpy(ref[stage])[None]
        cs.check_stage(stage, x, w, ours, (want, zero))
        assert float(want.max()) > 10.0
    sink = cs.conv1_stages(x, w, "taps")[1].view(torch.int32)
    assert int(sink[0]) % 2 ** 32 == numpy_taps_sink(x)
    got = float(cs.conv1_stages(x, w, "dott")[1][0])
    acc = accs.transpose(1, 0, 2).reshape(48, -1).astype(np.float64)
    wgt = ((np.arange(48) % 5 + 1)[:, None]
           * (np.arange(acc.shape[1]) % 7 + 1)[None, :])
    want = float((acc * wgt).sum())
    assert abs(got - want) <= 2.0 ** -20 * float(np.abs(acc * wgt).sum())


@pytest.mark.parametrize("stage", ["tpose", "full"])
def test_check_rejects_the_sums_without_bf16_rounding(inputs, monkeypatch,
                                                      stage):
    """The epilogue that ``tpose`` times is the bf16 rounding: the plain
    version with the rounding left out must fail ``check_stage``."""
    x, w = inputs
    want = cs.conv1_stages_plain(x, w, stage)
    monkeypatch.setattr(cs, "_bf16_relu", torch.relu)
    unrounded = cs.conv1_stages_plain(x, w, stage)
    monkeypatch.undo()
    cs.check_stage(stage, x, w, want, want)
    with pytest.raises(AssertionError, match=stage):
        cs.check_stage(stage, x, w, unrounded, want)


@pytest.mark.parametrize("swap", ["channels", "positions"])
def test_check_rejects_a_dott_of_another_orientation(inputs, swap):
    """``dott``'s sink weighs every accumulator by its channel and its
    position, so accumulators with channels or positions permuted (an
    operand fragment in the wrong order) fail ``check_stage``."""
    x, w = inputs
    want = cs.conv1_stages_plain(x, w, "dott")
    acc = cs.conv_acc(x, w)
    moved = acc.roll(1, dims=1 if swap == "channels" else 2)
    with pytest.raises(AssertionError, match="dott: sink"):
        cs.check_stage("dott", x, w, (want[0], cs.dott_sink(moved)), want)


def test_plain_version_refuses_bad_inputs(inputs):
    x, w = inputs
    with pytest.raises(ValueError, match="unknown stage"):
        cs.conv1_stages(x, w, "pool")
    with pytest.raises(ValueError, match="x must be"):
        cs.conv1_stages(x[:, :, :-1], w, "cast")
    with pytest.raises(TypeError, match="dtype"):
        cs.conv1_stages(x.float(), w, "cast")
    with pytest.raises(ValueError, match="w2t must be"):
        cs.conv1_stages(x, w.float(), "cast")
    assert cs._strip_rows_for(144, cap=12) == 12
    assert (cs.M, cs.FLAT, cs.OUT_W) == (3096, 37668, 85)


def test_entry_point_arguments_and_json(capsys):
    assert prof.parse([]) == (128, 30, list(cs.STAGES), False)
    assert prof.parse(["64", "5", "dotn", "full", "--cpu"]) == (
        64, 5, ["dotn", "full"], True)
    with pytest.raises(SystemExit, match="unknown stage"):
        prof.parse(["2", "1", "v_cast"])
    out = prof.main(["1", "1", "cast", "dott", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert [json.loads(line) for line in lines[:-1]] == [
        {"cast": out["cast_us_per_img"]}, {"dott": out["dott_us_per_img"]}]
    assert set(out) == {"batch", "device", "cast_us_per_img", "cast_fps",
                        "dott_us_per_img", "dott_fps"}
    assert out["batch"] == 1 and out["device"] == "cpu"
    assert out["cast_fps"] > 0 and out["dott_us_per_img"] > 0
