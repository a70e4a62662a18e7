"""The port's training path against the JAX package's, on the CPU.

The same numpy-seeded frames and labels, and the same initial weights
(JAX's init, carried across with ``checkpoint.convert.params_from_jax``),
go through the JAX package's functions and the port's at a small size: 2
conv layers of 8 channels, 36x64 frames, batches of 8-16.

Tolerances, measured on the CPU and stated here:

- ``batch_norm_train``: y within 1e-6 (f32; 4.8e-7 measured), the new
  statistics within 1e-6; on bf16 input the bf16 outputs equal; a batch of
  one row gives y = beta and the running variance moved by zero;
- the losses: ``rtol`` 1e-6;
- one conv block's train forward and the gradients of a seeded
  projection of it: within 1e-5;
- the optimizers alone on 10 identical gradients: within 1e-6 of optax;
- the supervised step at float32, three steps on each package's own
  trajectory with SGD (which does not amplify gradient noise): each
  step's loss within ``rtol`` 1e-5 (2.4e-6 measured), each gradient leaf
  within 1e-3 in relative norm (1.2e-4 measured, a conv bias, whose sum
  cancels), the parameters within 1e-5 (1.9e-6 measured) and the BN
  statistics within 1e-5; with AdamW, the first step's loss within
  ``rtol`` 1e-5 and its BN statistics within 1e-5, the next losses
  within ``rtol`` 2e-4 (4.2e-5 measured: Adam's first step moves every
  parameter by ``lr * sign(g)``, so a gradient near zero whose sign
  differs moves by ``2 lr``; the optimizer is held alone instead, on
  identical gradients);
- the bf16 step, each of three from JAX's state of that step: the loss
  within ``rtol`` 2e-4 (7.4e-5 measured: a bf16 rounding of a conv sum
  summed in another order flips), each gradient leaf within 1e-2 of JAX's
  in relative norm (4.7e-3 measured) but the two conv biases, which may
  instead be nearer the float32 gradient than JAX's (JAX's conv VJP sums
  bf16 cotangents, torch's autograd through the bf16 casts sums f32 ones;
  measured 0.09 and 0.015 from float32 where JAX's are 0.21 and 1.29), the
  BN statistics within 1e-4; a float32 step fails the 1e-2 bar on most
  leaves (JAX's float32 gradients are 0.02 to 0.36 from its bf16 ones on
  the kernels, gammas and betas);
- ``remat``: the same loss, parameters and statistics as the plain step,
  bit for bit, with the conv forward run twice and the statistics moved
  once;
- the eval step's per-class counts: equal, the loss within ``rtol`` 1e-5;
- the contrastive step on JAX's views: the first loss within ``rtol``
  1e-5 and its BN statistics within 1e-5, the second loss within
  ``rtol`` 2e-4 (9.1e-5 measured, AdamW);
- ``train_supervised`` over 2 epochs: each epoch's mean train loss within
  ``rtol`` 1e-3 and validation loss within ``rtol`` 5e-3 (AdamW's noise
  amplification over 8 steps), the per-class accuracies within 0.1.

Max-pool gradient ties: torch's ``max_pool2d`` backward and XLA's
select-and-scatter each route a window's gradient to one maximum.  On the
seeded noise frames here a tie is a ReLU zero, whose gradient is zero in
both.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cut_detection_tpu.config import ContrastiveConfig as JaxContrastiveConfig
from cut_detection_tpu.config import TrainConfig as JaxTrainConfig
from cut_detection_tpu.models import layers as jax_layers
from cut_detection_tpu.models.frame_conv import (
    apply_frame_conv,
    apply_frame_linear,
)
from cut_detection_tpu.ops import nn as jax_nn
from cut_detection_tpu.train import augment as jax_augment
from cut_detection_tpu.train import contrastive as jax_contrastive
from cut_detection_tpu.train import losses as jax_losses
from cut_detection_tpu.train import supervised as jax_supervised
from cut_detection_tpu_torch.checkpoint.convert import (
    bundle_from_state_dict,
    params_from_jax,
)
from cut_detection_tpu_torch.config import ContrastiveConfig, TrainConfig
from cut_detection_tpu_torch.models.layers import ConvBlock
from cut_detection_tpu_torch.ops import nn as port_nn
from cut_detection_tpu_torch.train import contrastive, losses, supervised

TINY = dict(conv_layers=2, conv_hidden_channels=8, avg_pool_size=2,
            linear_layers=2, linear_size=8, output_size=3, batch_size=16,
            epochs=1, learning_rate=3e-3)
H, W = 36, 64


def _cfgs(**kw):
    return JaxTrainConfig(**{**TINY, **kw}), TrainConfig(**{**TINY, **kw})


def _batch(seed, b=16, h=H, w=W):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    return x, rng.integers(0, 3, b).astype(np.int64)


def _bundle(jstate):
    return {p: {"params": jax.device_get(jstate["params"][p]),
                "state": jax.device_get(jstate["bn_state"][p])}
            for p in ("conv", "linear")}


def _port_state(jstate, init, cfg):
    """The port's state at JAX's initial weights."""
    state = init(torch.Generator().manual_seed(0), cfg, "cpu")
    state.net.load_state_dict(params_from_jax(_bundle(jstate)))
    return state


def _grad_bundle(net):
    """The port's gradients in the bundle's layout."""
    sd = dict(net.state_dict())
    for name, p in net.named_parameters():
        sd[name] = p.grad
    return bundle_from_state_dict(sd)


def _leaves(tree):
    return [np.asarray(leaf, np.float32)
            for leaf in jax.tree_util.tree_leaves(tree)]


def _close(a, b, atol, rtol=0.0, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=atol, rtol=rtol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(compute_dtype):
    """jit of the loss and gradients of JAX's train forward (the JAX
    package's own functions, composed as its ``make_train_step`` composes
    them) at ``TINY``."""
    jcfg = JaxTrainConfig(**TINY, compute_dtype=compute_dtype)
    _, (conv_cfg, lin_cfg) = jax_supervised.make_train_step(jcfg)
    cd = jax_supervised._train_compute_dtype(jcfg)

    def loss_fn(params, bn_state, x_u8, y):
        x = x_u8.astype(jnp.float32) / 255.0
        feats, _ = apply_frame_conv(params["conv"], bn_state["conv"], x,
                                    conv_cfg, train=True, compute_dtype=cd)
        logits, _ = apply_frame_linear(params["linear"], bn_state["linear"],
                                       feats, lin_cfg, train=True,
                                       compute_dtype=cd)
        return jax_losses.cross_entropy_sum(logits, y)

    return jax.jit(jax.value_and_grad(loss_fn))


def _jax_loss_grads(jcfg, jstate, x_u8, y):
    return _jax_value_and_grad(jcfg.compute_dtype)(
        jstate["params"], jstate["bn_state"], x_u8, y)


def _as_jax_tree(grads):
    return {"conv": grads["conv"]["params"],
            "linear": grads["linear"]["params"]}


# --- batch_norm_train -------------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16", "one_row"])
def test_batch_norm_train_matches(case):
    rng = np.random.default_rng(0)
    shape = (1, 5) if case == "one_row" else (8, 6, 10, 8)
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    c = shape[-1]
    m, v, g, b = (rng.standard_normal(c).astype(np.float32) for _ in range(4))
    v = np.abs(v) + 0.5
    if case == "bf16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jy, jm, jv = jax_nn.batch_norm_train(jx, m, v, g, b)
    ty, tm, tv = port_nn.batch_norm_train(tx, *map(torch.from_numpy,
                                                   (m, v, g, b)))
    assert ty.dtype == tx.dtype and not tm.requires_grad
    jy = np.asarray(jy.astype(jnp.float32))
    if case == "bf16":
        np.testing.assert_array_equal(ty.float().numpy(), jy)
    else:
        np.testing.assert_allclose(ty.numpy(), jy, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    if case == "one_row":
        # One row: zero batch variance, the output is beta; the running
        # variance decays by the momentum alone (count / max(count-1, 1)).
        np.testing.assert_allclose(ty.numpy(), np.broadcast_to(b, shape),
                                   atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), 0.9 * v, rtol=1e-6)


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("h_norm,temperature", [(True, 1.0), (False, 1.0),
                                                (True, 0.5)])
def test_losses_match(h_norm, temperature):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((12, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, 12)
    np.testing.assert_allclose(
        float(losses.cross_entropy_sum(torch.from_numpy(logits),
                                       torch.from_numpy(labels))),
        float(jax_losses.cross_entropy_sum(logits, labels)), rtol=1e-6)
    proj = rng.standard_normal((16, 8)).astype(np.float32)
    ours = losses.ntxent_loss(torch.from_numpy(proj), h_norm=h_norm,
                              temperature=temperature)
    theirs = jax_losses.ntxent_loss(proj, h_norm=h_norm,
                                    temperature=temperature)
    np.testing.assert_allclose(float(ours[0]), float(theirs[0]), rtol=1e-6)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    facade = losses.ContrastiveLoss(batch_size=8, h_norm=h_norm,
                                    temperature=temperature)
    np.testing.assert_allclose(float(facade(torch.from_numpy(proj))[0]),
                               float(theirs[0]), rtol=1e-6)
    with pytest.raises(ValueError, match="2\\*batch_size"):
        losses.ContrastiveLoss(batch_size=4)(torch.from_numpy(proj))


# --- one conv block ---------------------------------------------------------

def _scaled(a, b, what="", tol=1e-5):
    """Within ``tol`` of the largest magnitude of ``b``."""
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, atol=tol * float(np.abs(b).max()),
                               rtol=0, err_msg=what)


def test_conv_block_train_forward_and_grads_match():
    """``ConvBlock.forward_train`` and its gradients (input and every
    parameter) against ``apply_conv_block(train=True)`` and ``jax.grad``
    of the same seeded projection of the output."""
    rng = np.random.default_rng(2)
    params, state = jax_layers.init_conv_block(jax.random.PRNGKey(3), 3, 8)
    state = {"mean": np.full(8, 0.2, np.float32),
             "var": np.full(8, 1.5, np.float32)}
    x = rng.standard_normal((4, H, W, 3)).astype(np.float32)
    r = rng.standard_normal((4, H // 3, W // 3, 8)).astype(np.float32)

    def jax_loss(p, xx):
        y, _ = jax_layers.apply_conv_block(p, state, xx, train=True)
        return jnp.sum(y * r)

    jgrads, jgx = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(params, x)
    jy, jstate = jax.jit(functools.partial(
        jax_layers.apply_conv_block, train=True))(params, state, x)

    block = ConvBlock(3, 8)
    sd = params_from_jax({"conv": {"params": [params], "state": [state]},
                          "linear": {"params": [], "state": []}})
    block.load_state_dict({k[len("conv.conv_layers.0."):]: v
                           for k, v in sd.items()})
    block.train().requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, (tm, tv) = block.forward_train(tx)
    (ty * torch.from_numpy(r)).sum().backward()
    _scaled(ty.detach().numpy(), jy)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jstate["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jstate["var"]),
                               atol=1e-5)
    _scaled(tx.grad.numpy(), jgx)
    ours = {"kernel": block.conv.weight.grad.permute(2, 3, 1, 0),
            "bias": block.conv.bias.grad, "gamma": block.bn.weight.grad,
            "beta": block.bn.bias.grad}
    for k, v in ours.items():
        _scaled(v.numpy(), jgrads[k], k)
    # The block writes no running statistic itself.
    np.testing.assert_array_equal(block.bn.running_mean.numpy(),
                                  state["mean"])


def test_init_weights_bounds_and_seed():
    """``GluedNet.init_weights``: U(+-1/sqrt(fan_in)) weights and biases
    (JAX's ``init_conv_block`` / ``init_fc_block`` bounds), BN at gamma 1,
    beta 0, mean 0, var 1; one generator seed, one net."""
    cfg = TrainConfig(**TINY)
    nets = [supervised.init_train_state(torch.Generator().manual_seed(s),
                                        cfg, "cpu").net for s in (0, 0, 1)]
    sd = nets[0].state_dict()
    for i, fan_in in enumerate((3 * 9, 8 * 9)):
        for k in ("conv.weight", "conv.bias"):
            t = sd[f"conv.conv_layers.{i}.{k}"]
            assert t.abs().max() <= fan_in ** -0.5
            assert t.abs().max() > 0.8 * fan_in ** -0.5
    for i, fan_in in enumerate((8 * 2 * 2, 8)):
        t = sd[f"linear.layers.{i}.linear.weight"]
        assert t.abs().max() <= fan_in ** -0.5
    for k, v in sd.items():
        if k.endswith(("bn.weight", "bn.running_var")):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith(("bn.bias", "bn.running_mean")):
            assert torch.equal(v, torch.zeros_like(v)), k
    for k in sd:
        assert torch.equal(sd[k], nets[1].state_dict()[k]), k
    key = "conv.conv_layers.0.conv.weight"
    assert not torch.equal(sd[key], nets[2].state_dict()[key])
    assert nets[0].training and all(p.requires_grad
                                    for p in nets[0].parameters())


def test_frozen_block_refuses_train_forward():
    block = ConvBlock(3, 8)
    block.freeze()
    with pytest.raises(RuntimeError, match="frozen"):
        block.forward_train(torch.zeros(1, 9, 9, 3))
    with pytest.raises(ValueError, match="trains at"):
        ConvBlock(3, 8, "uint8_pool").forward_train(torch.zeros(1, 9, 9, 3))


# --- the optimizers ---------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax(name):
    """10 steps on identical gradients (a seeded sequence, the same for
    both), from the same parameters."""
    rng = np.random.default_rng(4)
    shapes = [(3, 3, 3, 8), (8,), (32, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -k
              for s in shapes] for k in range(10)]
    cfg = TrainConfig(optimizer=name, learning_rate=3e-3, weight_decay=0.05)
    jopt = jax_supervised.make_optimizer(JaxTrainConfig(
        optimizer=name, learning_rate=3e-3, weight_decay=0.05))
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)

    @jax.jit
    def jax_step(g, opt_state, ps):
        updates, opt_state = jopt.update(g, opt_state, ps)
        return optax.apply_updates(ps, updates), opt_state

    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    topt = supervised.make_optimizer(cfg, tparams)
    for g in grads:
        jparams, jstate = jax_step([jnp.asarray(x) for x in g], jstate,
                                   jparams)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)


def test_unported_optimizer_raises():
    with pytest.raises(ValueError, match="ROADMAP"):
        supervised.make_optimizer(TrainConfig(optimizer="lamb"), [])
    with pytest.raises(ValueError, match="compute_dtype"):
        supervised.make_train_step(TrainConfig(compute_dtype="bfloat16_full"))


# --- the supervised step ----------------------------------------------------

def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _sync(state, jstate):
    state.net.load_state_dict(params_from_jax(_bundle(jstate)))


def test_three_supervised_steps_match_f32():
    """Three float32 steps with SGD, each package on its own trajectory:
    each step's loss and gradients, then the parameters and BN
    statistics."""
    jcfg, cfg = _cfgs(optimizer="sgd")
    jstate = jax_supervised.init_train_state(jax.random.PRNGKey(0), jcfg)
    state = _port_state(jstate, supervised.init_train_state, cfg)
    jstep = jax.jit(jax_supervised.make_train_step(jcfg)[0])
    step = supervised.make_train_step(cfg)
    for k in range(3):
        x, y = _batch(10 + k)
        jloss, jgrads = _jax_loss_grads(jcfg, jstate, x, y)
        jstate, jm = jstep(jstate, x, y)
        state, m = step(state, x, y)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(jloss), float(jm["loss"]),
                                   rtol=1e-6)
        assert int(m["correct"]) == int(jm["correct"])
        ours = _leaves(_as_jax_tree(_grad_bundle(state.net)))
        for a, b in zip(ours, _leaves(jgrads)):
            assert _rel(a, b) <= 1e-3, (k, _rel(a, b))
        bundle = state.net.bundle()
        _close(_as_jax_tree(bundle), jstate["params"], atol=1e-5,
               what=f"params {k}")
        _close([bundle[p]["state"] for p in ("conv", "linear")],
               [jstate["bn_state"][p] for p in ("conv", "linear")],
               atol=1e-5, what=f"BN {k}")
    for leaf in _leaves(_as_jax_tree(state.net.bundle())):
        assert leaf.dtype == np.float32
    assert state.step == 3


# The gradient leaves whose sums cancel, where a bf16 cotangent's rounding
# noise exceeds the gradient itself.
CONV_BIAS_LEAVES = ("['conv'][0]['bias']", "['conv'][1]['bias']")


def test_three_supervised_steps_match_bf16():
    """Three bf16 mixed-precision steps, each from JAX's state of that
    step: the loss, the gradients and the new BN statistics.  Every
    gradient leaf is within 1e-2 of JAX's bf16 one (relative norm) but the
    conv biases, which may instead be nearer the float32 gradient than
    JAX's own bf16 one is: JAX's conv VJP sums bf16 cotangents, and where
    a leaf's sum cancels its rounding noise exceeds the gradient."""
    jcfg, cfg = _cfgs(optimizer="sgd", compute_dtype="bfloat16")
    jcfg32 = JaxTrainConfig(**{**TINY, "optimizer": "sgd"})
    jstate = jax_supervised.init_train_state(jax.random.PRNGKey(0), jcfg)
    state = _port_state(jstate, supervised.init_train_state, cfg)
    assert state.net.precision == "bfloat16_full"
    jstep = jax.jit(jax_supervised.make_train_step(jcfg)[0])
    step = supervised.make_train_step(cfg)
    for k in range(3):
        x, y = _batch(10 + k)
        _sync(state, jstate)
        _, jgrads = _jax_loss_grads(jcfg, jstate, x, y)
        _, jgrads32 = _jax_loss_grads(jcfg32, jstate, x, y)
        jstate, jm = jstep(jstate, x, y)
        state, m = step(state, x, y)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-4)
        ours = _leaves(_as_jax_tree(_grad_bundle(state.net)))
        named = jax.tree_util.tree_flatten_with_path(jgrads)[0]
        assert len(ours) == len(named) == len(_leaves(jgrads32))
        for a, (path, b), f in zip(ours, named, _leaves(jgrads32)):
            name = jax.tree_util.keystr(path)
            b = np.asarray(b, np.float32)
            if name in CONV_BIAS_LEAVES:
                assert _rel(a, b) <= 1e-2 or _rel(a, f) <= _rel(b, f), (
                    k, name, _rel(a, b), _rel(a, f), _rel(b, f))
            else:
                assert _rel(a, b) <= 1e-2, (k, name, _rel(a, b))
        bundle = state.net.bundle()
        _close([bundle[p]["state"] for p in ("conv", "linear")],
               [jstate["bn_state"][p] for p in ("conv", "linear")],
               atol=1e-4, what=f"BN {k}")
    for leaf in _leaves(_as_jax_tree(state.net.bundle())):
        assert leaf.dtype == np.float32


def test_adamw_steps_match():
    """AdamW, the default: three losses and the first step's BN
    statistics (which the step-1 forward alone sets)."""
    jcfg, cfg = _cfgs()
    jstate = jax_supervised.init_train_state(jax.random.PRNGKey(1), jcfg)
    state = _port_state(jstate, supervised.init_train_state, cfg)
    jstep = jax.jit(jax_supervised.make_train_step(jcfg)[0])
    step = supervised.make_train_step(cfg)
    for k in range(3):
        x, y = _batch(20 + k)
        jstate, jm = jstep(jstate, x, y)
        state, m = step(state, x, y)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if k == 0 else 2e-4)
        if k == 0:
            bundle = state.net.bundle()
            _close([bundle[p]["state"] for p in ("conv", "linear")],
                   [jstate["bn_state"][p] for p in ("conv", "linear")],
                   atol=1e-5)
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == len(list(state.net.parameters()))
    assert all(float(s["step"]) == 3 for s in opt.values())


def test_remat_matches_plain_and_moves_bn_once(monkeypatch):
    """``remat`` recomputes the conv forward in the backward (each conv
    block runs twice a step) and gives the plain step's loss, parameters
    and BN statistics bit for bit: the statistics move once."""
    calls = []
    original = ConvBlock.forward_train

    def counted(self, x):
        calls.append(1)
        return original(self, x)

    monkeypatch.setattr(ConvBlock, "forward_train", counted)
    jcfg, _ = _cfgs()
    jstate = jax_supervised.init_train_state(jax.random.PRNGKey(2), jcfg)
    results = {}
    for remat in (False, True):
        cfg = TrainConfig(**TINY, remat=remat)
        state = _port_state(jstate, supervised.init_train_state, cfg)
        step = supervised.make_train_step(cfg)
        calls.clear()
        for k in range(2):
            state, m = step(state, *_batch(30 + k))
        results[remat] = (float(m["loss"]), state.net.state_dict(),
                          len(calls))
    assert results[False][2] == 2 * 2 and results[True][2] == 2 * 2 * 2
    assert results[False][0] == results[True][0]
    for k, v in results[False][1].items():
        torch.testing.assert_close(results[True][1][k], v, rtol=0, atol=0,
                                   msg=k)


def test_train_step_after_inference_mode():
    """A training step after an inference in the same process (the
    classify step runs under ``torch.inference_mode``) can save the
    adaptive pool's cached matrices for its backward."""
    port_nn._pool_matrix_on.cache_clear()
    with torch.inference_mode():
        port_nn.adaptive_avg_pool(torch.zeros(1, H // 9, W // 9, 8), 2)
    cfg = TrainConfig(**TINY)
    state = supervised.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, "cpu")
    state, m = supervised.make_train_step(cfg)(state, *_batch(70))
    assert np.isfinite(float(m["loss"]))


def test_eval_step_per_class_counts_match():
    jcfg, cfg = _cfgs()
    jstate = jax_supervised.init_train_state(jax.random.PRNGKey(3), jcfg)
    state = _port_state(jstate, supervised.init_train_state, cfg)
    jstep = jax.jit(jax_supervised.make_train_step(jcfg)[0])
    step = supervised.make_train_step(cfg)
    x, y = _batch(40, b=32)
    for _ in range(5):  # move the BN statistics off their init
        jstate, _ = jstep(jstate, x[:16], y[:16])
        state, _ = step(state, x[:16], y[:16])
    # Evaluate the port's trained weights in both packages.
    bundle = state.net.bundle()
    jstate = dict(jstate, params={p: bundle[p]["params"]
                                  for p in ("conv", "linear")},
                  bn_state={p: bundle[p]["state"]
                            for p in ("conv", "linear")})
    jm = jax.jit(jax_supervised.make_eval_step(jcfg))(jstate, x, y)
    m = supervised.make_eval_step(cfg)(state, x, y)
    assert not state.net.training
    np.testing.assert_array_equal(m["correct"].numpy(),
                                  np.asarray(jm["correct"]))
    np.testing.assert_array_equal(m["total"].numpy(),
                                  np.asarray(jm["total"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)


# --- the contrastive step ---------------------------------------------------

CTINY = dict(conv_layers=2, conv_hidden_channels=8, linear_layers=2,
             linear_size=8, output_size=4, batch_size=4, epochs=1)


@pytest.mark.parametrize("fast", [False, True])
def test_contrastive_step_on_jax_views_matches(fast, monkeypatch):
    """Two steps of the port's update and of JAX's contrastive step on the
    same views, made by JAX's ``simclr_two_views`` or
    ``fast_simclr_two_views`` at 36x64."""
    jcfg = JaxContrastiveConfig(**CTINY, fast_augment=fast)
    cfg = ContrastiveConfig(**CTINY, fast_augment=fast)
    two_views = (jax_augment.fast_simclr_two_views if fast
                 else jax_augment.simclr_two_views)
    x, _ = _batch(50, b=4, h=48, w=80)
    views = [two_views(jax.random.PRNGKey(k), jnp.asarray(x), (H, W))
             for k in range(2)]
    # JAX's step takes the views in place of the frames it would augment.
    name = "fast_simclr_two_views" if fast else "simclr_two_views"
    monkeypatch.setattr(jax_contrastive, name, lambda key, v, size: v)
    jstate = jax_contrastive.init_contrastive_state(jax.random.PRNGKey(4),
                                                    jcfg)
    state = _port_state(jstate, contrastive.init_contrastive_state, cfg)
    jstep = jax.jit(jax_contrastive.make_contrastive_step(
        jcfg, view_size=(H, W))[0])
    update = contrastive.make_contrastive_update(cfg)
    for k, v in enumerate(views):
        jstate, jm = jstep(jstate, jax.random.PRNGKey(9), v)
        state, m = update(state, torch.from_numpy(np.array(v)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if k == 0 else 2e-4)
        assert float(m["align_acc"]) == pytest.approx(float(jm["align_acc"]))
        if k == 0:
            bundle = state.net.bundle()
            _close([bundle[p]["state"] for p in ("conv", "linear")],
                   [jstate["bn_state"][p] for p in ("conv", "linear")],
                   atol=1e-5)
    assert state.net.conv.cfg.average_pool_size == 1


# --- train_supervised -------------------------------------------------------

@dataclasses.dataclass
class ArrayDataset:
    """A ``SupervisedFrameDataset``-like over arrays in memory."""

    x: np.ndarray
    y: np.ndarray

    def __getitem__(self, idx):
        return {"x": self.x[idx], "y": np.int64(self.y[idx])}

    def __len__(self):
        return len(self.x)


def test_train_supervised_two_epochs_match():
    """Both loops over 2 epochs from JAX's initial weights: the same split
    and batch order (the seed), each epoch's losses and accuracies."""
    x, y = _batch(60, b=44)
    datasets = [ArrayDataset(x[:30], y[:30]), ArrayDataset(x[30:], y[30:])]
    jcfg, cfg = _cfgs(epochs=2, batch_size=8)
    jstate = jax_supervised.init_train_state(jax.random.PRNGKey(5), jcfg)
    state = _port_state(jstate, supervised.init_train_state, cfg)
    theirs = jax_supervised.train_supervised(jcfg, datasets, num_workers=0,
                                             state=jstate)["history"]
    ours = supervised.train_supervised(cfg, datasets, num_workers=0,
                                       state=state)["history"]
    assert [h["epoch"] for h in ours] == [h["epoch"] for h in theirs] == [0, 1]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-3)
        np.testing.assert_allclose(a["valid_loss"], b["valid_loss"],
                                   rtol=5e-3)
        np.testing.assert_allclose(a["valid_acc_per_class"],
                                   b["valid_acc_per_class"], atol=0.1)
    assert state.step == 2 * 5  # 33 training frames: 4 batches of 8 + 1


@pytest.mark.parametrize("entry", ["init_train_state", "init_contrastive_state",
                                   "train_supervised", "train_contrastive"])
def test_entry_points_need_a_card_unless_given_a_device(entry, monkeypatch):
    """Without ``device`` the training entry points take the CUDA device,
    as the inference entry points do, and raise where there is none: they
    never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    x, y = _batch(80, b=8)
    calls = {
        "init_train_state": lambda: supervised.init_train_state(
            gen, TrainConfig(**TINY)),
        "init_contrastive_state": lambda: contrastive.init_contrastive_state(
            gen, ContrastiveConfig(**CTINY)),
        "train_supervised": lambda: supervised.train_supervised(
            TrainConfig(**TINY), [ArrayDataset(x, y)], num_workers=0),
        "train_contrastive": lambda: contrastive.train_contrastive(
            ContrastiveConfig(**CTINY), ArrayDataset(x, y), num_workers=0),
    }
    with pytest.raises(RuntimeError, match="pass --cpu"):
        calls[entry]()
