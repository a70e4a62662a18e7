"""The port's process group (``parallel.distributed``, ``local_cluster``)
against the single-process port and the JAX package's sharded training,
on the CPU.

One 2-rank gloo group, spawned once for the module
(``local_cluster.spawn_cluster``), runs a collective on per-rank data,
the data-parallel supervised and contrastive steps and a data-parallel
``train_supervised`` with tails, and saves each rank's results; the
tests here hold them to:

- the same step in one process on the whole batch, from the same weights
  and (contrastive) the same views: the loss within ``rtol`` 1e-5, every
  gradient leaf (each rank's, all-reduced, as the optimizer took it)
  within ``GRAD_RTOL`` of the leaf's norm, the parameters within 2e-3 (a
  first AdamW step moves a parameter by about ``lr * sign(g)``, so a
  near-zero gradient summed in another order may move it ``2 lr`` away,
  as ``tests/test_parallel.py:163-168`` bounds it; the gradients carry
  the check, as a first Adam step passes any gradient within ``2 lr``),
  the BN running statistics within 1e-5 (pure global-batch moments);
- JAX's sharded step over the 8 virtual devices from the same weights,
  with the same bars: ``jit_steps(cfg, mesh)``, and the contrastive step
  jitted as ``train_contrastive(mesh=...)`` jits it, on the port's views;
  an optimizer that keeps the gradients in its state reads JAX's;
- the tail run: both ranks equal; the train tail dropped (4 steps an
  epoch, not 5); the validation loss and accuracies those of the final
  weights evaluated in one process over the whole split (the tail of 3,
  which does not divide over 2 ranks, counted once); and each epoch
  against JAX's ``train_supervised`` over its mesh: the train and
  validation losses within ``rtol`` 1e-5 (1.1e-6 measured), the
  accuracies equal.  The run trains with SGD, which carries the sums'
  order noise through its 8 steps as it is; AdamW turns a near-zero
  gradient's sign into ``2 lr`` a step and reached 1.5e-3 there.

The spawn takes about 10 s here (two interpreters importing torch); it
runs on a thread while the tests compute their references.
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from cut_detection_tpu.config import ContrastiveConfig as JaxContrastiveConfig
from cut_detection_tpu.config import TrainConfig as JaxTrainConfig
from cut_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cut_detection_tpu.parallel.sharding import replicate, shard_batch
from cut_detection_tpu.train import contrastive as jax_contrastive
from cut_detection_tpu.train import supervised as jax_supervised
from cut_detection_tpu_torch.checkpoint.convert import bundle_from_state_dict
from cut_detection_tpu_torch.data.frames import ConcatDataset
from cut_detection_tpu_torch.parallel import distributed, local_cluster
from cut_detection_tpu_torch.train import contrastive, supervised

CPU = torch.device("cpu")
# Each gradient leaf against the reference's, relative to the leaf's
# norm: float32 sums in another order reach 3.9e-5 here (JAX's
# contrastive step); a gradient missing the other rank's terms, halved or
# of the wrong sign is off by 1e-2 or more.
GRAD_RTOL = 1e-4
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)


def test_initialize_single_process_noop(no_torchrun):
    assert distributed.initialize() == 0
    assert distributed.initialize() == 0  # idempotent
    assert not torch.distributed.is_initialized()


def test_partition_inputs_round_robin():
    items = list(range(10))
    shards = [distributed.partition_inputs(items, process_id=p,
                                           num_processes=3)
              for p in range(3)]
    assert shards == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
    assert sorted(x for s in shards for x in s) == items


def test_partition_inputs_defaults_to_local():
    assert distributed.partition_inputs(["a", "b"]) == ["a", "b"]


def test_backend_is_chosen_not_switched(monkeypatch):
    """gloo without a card; NCCL for ranks that share a card raises and
    names gloo, rather than falling back to it."""
    assert distributed._backend(None, 1) == "gloo"
    assert distributed._backend("gloo", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed._backend("nccl", 2)
    assert distributed._backend("nccl", 1) == "nccl"


@pytest.mark.parametrize("env,args,want", [
    ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, (None, None, None),
     (1, 4)),
    ({}, ("localhost:9911", 2, 1), (1, 2)),
    ({}, ("tcp://127.0.0.1:9911", 3, 2), (2, 3)),
    ({}, ("node7:9911", 2, 1), (0, 1)),
])
def test_local_layout(monkeypatch, no_torchrun, env, args, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed._local_layout(*args) == want


@pytest.mark.parametrize("lr,lws,n,want", [
    (0, 1, 4, [0, 1, 2, 3]), (1, 4, 4, [1]), (1, 2, 4, [1, 3]),
    (1, 2, 1, [0]), (0, 1, 0, None)])
def test_local_devices(monkeypatch, lr, lws, n, want):
    monkeypatch.setattr(distributed, "_LOCAL", (lr, lws))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    got = distributed.local_devices()
    assert got == ([CPU] if want is None
                   else [torch.device("cuda", i) for i in want])


# --- the 2-rank group --------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks()``: both ranks' results, from the group started when the
    fixture is first requested."""
    out = tmp_path_factory.mktemp("ranks")

    def run():
        outs = local_cluster.spawn_cluster(2, out=str(out), timeout=300)
        assert len(outs) == 2 and all("WORKER-OK" in o for o in outs)
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(run)
        yield future.result


def _state_dict(res, prefix):
    return {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in res.items()
            if k.startswith(prefix + "/")}


def _close(a, b, atol, what):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), atol=atol,
                                   err_msg=what)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_step_matches(bundle, loss, grads, ref_bundle, ref_loss,
                         ref_grads, what):
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, err_msg=what)
    for part in ("conv", "linear"):
        la = jax.tree_util.tree_leaves(grads[part])
        lb = jax.tree_util.tree_leaves(ref_grads[part])
        assert len(la) == len(lb) > 0, what
        worst = max(_rel(a, b) for a, b in zip(la, lb))
        assert worst <= GRAD_RTOL, f"{what}: {part} gradients off by {worst}"
        _close(bundle[part]["params"], ref_bundle[part]["params"], 2e-3,
               f"{what}: {part} params")
        _close(bundle[part]["state"], ref_bundle[part]["state"], 1e-5,
               f"{what}: {part} BN statistics")


def _grad_bundle(grads, sd):
    """Gradients by parameter name in the bundle layout (``sd``, a state
    dict, supplies the BN statistics the layout carries)."""
    bundle = bundle_from_state_dict({**sd, **grads})
    return {p: bundle[p]["params"] for p in ("conv", "linear")}


def _rank_result(res, prefix):
    """A rank's step: its bundle, loss and gradients (bundle layout)."""
    sd = _state_dict(res, prefix)
    return (bundle_from_state_dict(sd), float(res[prefix[:3] + "_loss"]),
            _grad_bundle(_state_dict(res, prefix + "_grad"), sd))


def _port_result(state, m):
    sd = state.net.state_dict()
    grads = {k: p.grad for k, p in state.net.named_parameters()}
    return state.net.bundle(), float(m["loss"]), _grad_bundle(grads, sd)


def _recording(optimizer):
    """``optimizer`` after a transformation that keeps the step's
    gradients in its state: ``opt_state[0]`` after a step."""
    record = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(record, optimizer)


def _jax_result(jstate, jm):
    return ({p: {"params": jax.device_get(jstate["params"][p]),
                 "state": jax.device_get(jstate["bn_state"][p])}
             for p in ("conv", "linear")}, float(jm["loss"]),
            jax.device_get(jstate["opt_state"][0]))


def _jax_cfg(cfg, cls=JaxTrainConfig):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items()
                  if k in fields})


def _jax_state(init, jcfg, bundle, optimizer=None):
    """JAX's train state from ``init`` at the port's initial weights."""
    state = init(jax.random.PRNGKey(0), jcfg, optimizer)
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa
    state["params"] = as_jax({p: bundle[p]["params"]
                              for p in ("conv", "linear")})
    state["bn_state"] = as_jax({p: bundle[p]["state"]
                                for p in ("conv", "linear")})
    return state


def _init_bundle(cfg, init=supervised.init_train_state):
    return init(torch.Generator().manual_seed(0), cfg, CPU).net.bundle()


def test_supervised_step_matches_one_process_and_jax(ranks):
    cfg, x, y = local_cluster.supervised_case()
    jcfg = _jax_cfg(cfg)
    mesh = jax_make_mesh(jax.devices()[:8])
    opt = _recording(jax_supervised.make_optimizer(jcfg))
    train_sharded, _, _ = jax_supervised.jit_steps(jcfg, mesh, opt)
    jstate = replicate(mesh, _jax_state(jax_supervised.init_train_state,
                                        jcfg, _init_bundle(cfg), opt))
    jstate, jm = train_sharded(jstate, shard_batch(mesh, x),
                               shard_batch(mesh, y))
    state, m = local_cluster.supervised_step(cfg, x, y, CPU)

    res = ranks()[0]
    assert int(res["sup_n"]) == len(x)
    assert int(res["sup_correct"]) == int(m["correct"])
    ours = _rank_result(res, "sup")
    _assert_step_matches(*ours, *_port_result(state, m), "one process")
    _assert_step_matches(*ours, *_jax_result(jstate, jm),
                         "JAX over 8 devices")


def test_collective_and_ranks_agree(ranks):
    """The per-rank all-reduce summed to 8 * (1 + 2) on both ranks, and
    every result the ranks share is equal on both."""
    r0, r1 = ranks()
    assert r0["collective"] == r1["collective"] == 24.0
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_contrastive_step_matches_one_process(ranks, monkeypatch):
    """The same views (the global batch's draws, each rank keeping its
    rows) and NT-Xent over the gathered projections: the single-process
    step on the whole batch, and JAX's contrastive step sharded as
    ``train_contrastive(mesh=...)`` shards it, on those views."""
    cfg, x = local_cluster.contrastive_case()
    state, m = local_cluster.contrastive_step(cfg, x, CPU)
    views = contrastive.two_views(cfg, torch.Generator().manual_seed(7),
                                  torch.from_numpy(x), len(x),
                                  slice(0, len(x)))
    jcfg = _jax_cfg(cfg, JaxContrastiveConfig)
    # JAX's step takes the views in place of the frames it would augment.
    name = "fast_simclr_two_views" if cfg.fast_augment else "simclr_two_views"
    monkeypatch.setattr(jax_contrastive, name, lambda key, v, size: v)
    opt = _recording(jax_contrastive.make_optimizer(jcfg))
    mesh = jax_make_mesh(jax.devices()[:8])
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    jstep = jax.jit(jax_contrastive.make_contrastive_step(jcfg, opt)[0],
                    in_shardings=(repl, repl, data),
                    out_shardings=(repl, repl))
    jstate = replicate(mesh, _jax_state(
        jax_contrastive.init_contrastive_state, jcfg,
        _init_bundle(cfg, contrastive.init_contrastive_state), opt))
    jstate, jm = jstep(jstate, jax.random.PRNGKey(0),
                       jax.device_put(views.numpy(), data))

    res = ranks()[0]
    assert float(res["con_acc"]) == pytest.approx(float(m["align_acc"]))
    assert float(jm["align_acc"]) == pytest.approx(float(m["align_acc"]))
    ours = _rank_result(res, "con")
    _assert_step_matches(*ours, *_port_result(state, m), "one process")
    _assert_step_matches(*ours, *_jax_result(jstate, jm),
                         "JAX over 8 devices")


def test_tail_run_drops_the_train_tail_and_counts_the_valid_tail_once(ranks):
    cfg, datasets = local_cluster.tail_case()
    jcfg = _jax_cfg(cfg)
    theirs = jax_supervised.train_supervised(
        jcfg, datasets, mesh=jax_make_mesh(jax.devices()[:8]),
        num_workers=0, state=_jax_state(jax_supervised.init_train_state,
                                        jcfg, _init_bundle(cfg)))["history"]
    res = ranks()[0]
    history = json.loads(str(res["tail_history"]))
    assert int(res["tail_steps"]) == cfg.epochs * 4  # 33 // 8

    # The final weights over the whole validation split in one process.
    ds = ConcatDataset(datasets)
    perm = np.random.default_rng(cfg.seed).permutation(len(ds))
    valid = perm[int(np.floor(len(ds) * (1 - cfg.valid_fraction))):]
    assert len(valid) % cfg.batch_size % 2 == 1  # a tail of 3
    state = supervised.init_train_state(torch.Generator(), cfg, CPU)
    state.net.load_state_dict(_state_dict(res, "tail"))
    xs = np.stack([ds[int(i)]["x"] for i in valid])
    ys = np.array([ds[int(i)]["y"] for i in valid])
    m = supervised.make_eval_step(cfg)(state, xs, ys)
    np.testing.assert_allclose(history[-1]["valid_loss"],
                               float(m["loss"]) / len(valid), rtol=1e-5)
    np.testing.assert_allclose(
        history[-1]["valid_acc_per_class"],
        (m["correct"] / m["total"].clamp(min=1)).numpy(), atol=1e-12)
    assert [h["epoch"] for h in history] == [h["epoch"] for h in theirs]
    for a, b in zip(history, theirs):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(a["valid_loss"], b["valid_loss"],
                                   rtol=1e-5)
        assert a["train_acc"] == b["train_acc"]
        assert a["valid_acc_per_class"] == b["valid_acc_per_class"]


@pytest.mark.slow
def test_local_cluster_spawn_cli(capsys):
    """``python -m cut_detection_tpu_torch.parallel.local_cluster --spawn
    2`` as a user runs it (``tests/test_distributed.py:30``'s mirror)."""
    local_cluster.main(["--spawn", "2"])
    assert capsys.readouterr().out.count("WORKER-OK") == 2
