"""Data-parallel training and evaluation of the PyTorch port over N gloo
ranks on the CPU (``brainmagick_tpu_torch.parallel``,
``Solver.set_group``): the mirror of tests/test_parallel.py and
tests/mp_worker.py. The port's ranks are held to the JAX package's
sharded step on conftest's virtual CPU devices (``set_mesh``) and to the
port's own one-rank runs.

Each test spawns its ranks with torch.multiprocessing (spawn) over a
FileStore in tmp_path, so that no two tests share a port, each rank on one
thread. The process group's timeout is RANK_TIMEOUT, the parent waits at
most DEADLINE for the ranks, a rank that fails stops the others, and a
rank still running then is killed and fails its test. The rank bodies
(``_case_*``) import torch and the port only; this module imports the
JAX package inside the parent's functions.

The tolerances are those of tests/test_torch_train.py: losses rtol 1e-5,
the first step's gradients atol 1e-5, the parameters after the steps
within 0.01 lr (the noise-driven entries within Adam's 2 lr a step). The
parity runs set merger_dropout=0: a rank's disks come from its own
generator stream (``parallel.rank_seed``), which no JAX key matches.
"""

import copy
import datetime
import itertools
import json
import os
import pickle
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
#: the process group's timeout: its initialization and every collective
RANK_TIMEOUT = datetime.timedelta(seconds=60)
#: how long the parent waits for all the ranks of a test (a bound on a
#: hang: the ranks of a test take about 20 s on an idle CPU)
DEADLINE = 150.
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
#: the tiny SimpleConv of tests/test_solver.py's tiny_args, fused, as
#: overrides (tests/test_torch_epochs.py's TINY)
BASE = ["simpleconv.merger_dropout=0.0", "simpleconv.fused_conv_bn=True"]
#: a small DeepMel (tests/test_torch_deepmel.py's cell): its gradient
#: flows back through the gathered or ring-passed candidate rows
DEEPMEL = ["preset=deep_mel", "feature_model_params.n_hidden_channels=16",
           "feature_model_params.n_hidden_layers=3",
           "feature_model_params.n_out_channels=24"]
#: the DeepMel held to the JAX package has no BatchNorm: on the 4-row
#: shards of these batches the JAX package's fp32 gradients of a
#: BatchNorm'd DeepMel's layers lie farther from float64's than GRAD_ATOL,
#: where the port's do not; the BatchNorm'd DeepMel is held to the port's
#: own gathered layout (ring_negatives, below)
JAX_DEEPMEL = DEEPMEL + ["feature_model_params.batch_norm=False"]
#: without BatchNorm, whose per-rank batch statistics (as under the JAX
#: step's shard_map) make a train step depend on the number of ranks
NO_BN = ["simpleconv.merger_dropout=0.0", "simpleconv.batch_norm=False"]
_RUNS = itertools.count()


# -- the ranks ----------------------------------------------------------------

def _rank_main(case: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    result = (False, "no result")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world, timeout=RANK_TIMEOUT)
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            data = pickle.load(f)
        result = (True, globals()[case](rank, world, data))
    except BaseException:  # noqa: BLE001 - sent to the parent
        result = (False, traceback.format_exc())
    with open(os.path.join(tmp, f"result.{rank}.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(tmp, f"result.{rank}.tmp"),
               os.path.join(tmp, f"result.{rank}"))
    if dist.is_initialized() and result[0]:
        dist.destroy_process_group()


def run_ranks(case: str, world: int, data: dict, tmp_path: Path) -> list:
    """`case` on `world` spawned gloo ranks; each rank's result, or the
    test fails with the first failing rank's traceback."""
    tmp = tmp_path / f"ranks{next(_RUNS)}_{case}_{world}"
    tmp.mkdir()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(data, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(case, r, world, str(tmp)),
                         daemon=True) for r in range(world)]
    for proc in procs:
        proc.start()
    end = time.monotonic() + DEADLINE
    results: dict = {}
    try:
        while len(results) < world and time.monotonic() < end:
            for r in range(world):
                path = tmp / f"result.{r}"
                if r not in results and path.exists():
                    with open(path, "rb") as f:
                        results[r] = pickle.load(f)
                    if not results[r][0]:
                        pytest.fail(f"rank {r} of {world} in {case}:\n"
                                    f"{results[r][1]}")
            if any(not p.is_alive() and p.exitcode for p in procs):
                break
            time.sleep(0.05)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()
                and r not in results]
        for proc in procs:
            proc.join(timeout=5 if len(results) == world else 0)
            if proc.is_alive():
                proc.kill()
                proc.join()
    missing = [r for r in range(world) if r not in results]
    if missing:
        pytest.fail(f"{case}: ranks {missing} of {world} gave no result "
                    f"(exit codes {[p.exitcode for p in procs]}, still "
                    f"running at the deadline {hung})")
    return [results[r][1] for r in range(world)]


def _local(batch: dict, rank: int, world: int) -> types.SimpleNamespace:
    from brainmagick_tpu_torch.parallel import slice_global_batch
    arrays, _ = slice_global_batch(batch, np.ones(len(batch["meg"])), rank,
                                   world)
    return types.SimpleNamespace(**arrays)


def _grads(trainer) -> dict:
    return {f"{name}.{k}": p.grad.numpy().copy()
            for name, module in _modules(trainer)
            for k, p in module.named_parameters() if p.grad is not None}


def _modules(trainer) -> list:
    return [(name, m) for name, m in (("model", trainer.model),
                                      ("fm", trainer.feature_model))
            if m is not None]


def _drive(trainer, batches: list, ops: list, rank: int, world: int
           ) -> dict:
    """`ops` on this rank's rows of `batches`: ("eval", i) an eval-mode
    step, ("train", i) a train step, ("grad", i) the eval-mode loss's
    gradient (``Solver.loss_and_grad``). Returns each op's metrics, the
    gradients after the first train or grad op, and the final state."""
    from brainmagick_tpu_torch.dataset import to_device
    out: dict = {"metrics": [], "grads": None}
    for kind, i in ops:
        local = _local(batches[i], rank, world)
        if kind == "grad":
            arrays = to_device(local, "cpu")
            metrics = trainer.solver.loss_and_grad(
                arrays, torch.ones(len(local.meg)), train=False)
        else:
            metrics = trainer.step(local, train=kind == "train")
        out["metrics"].append({k: v.item() for k, v in metrics.items()})
        if kind != "eval" and out["grads"] is None:
            out["grads"] = _grads(trainer)
    out["state"] = {f"{name}.{k}": v.numpy().copy()
                    for name, module in _modules(trainer)
                    for k, v in module.state_dict().items()}
    return out


def _case_trainer(rank: int, world: int, data: dict) -> dict:
    """Each of `data["runs"]`: a Trainer on the given weights (the port's
    seeded ones when None), a rank of the launch's group when there is
    one, driven by its ops."""
    from brainmagick_tpu_torch import parallel
    from brainmagick_tpu_torch.train import Trainer
    out = {}
    for name, run in data["runs"].items():
        trainer = Trainer(run["args"], *run["widths"], run.get("params"),
                          run.get("stats"), data["norm_arrays"],
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
        if dist.is_initialized():
            trainer.solver.set_group(parallel.DataGroup())
        out[name] = _drive(trainer, data["batches"], run["ops"], rank,
                           world)
    return out


def _case_negative_pool(rank: int, world: int, data: dict) -> dict:
    """STEPS train steps with ``optim.negatives``: each step tops its
    candidates up from the train pool (``Solver._sample_negatives``, the
    sampling RNG seeded alike on every rank), trains on this rank's rows,
    and folds its targets into the pool (``_update_negative_pool``: every
    rank's rows gathered in rank order). Returns the negatives drawn and
    the pool after each step."""
    from brainmagick_tpu_torch import parallel
    from brainmagick_tpu_torch.dataset import to_device
    from brainmagick_tpu_torch.train import Trainer
    args = data["args"]
    trainer = Trainer(args, *data["widths"], None, None,
                      data["norm_arrays"], device="cpu",
                      generator=torch.Generator().manual_seed(0))
    solver = trainer.solver
    solver.set_group(parallel.DataGroup())
    solver._neg_rng = np.random.RandomState(7)
    out: dict = {"negatives": [], "pools": []}
    for batch in data["batches"]:
        local = _local(batch, rank, world)
        arrays = to_device(local, "cpu")
        negatives, weight = solver._sample_negatives(
            "train", arrays["features"].shape, args.optim.negatives,
            solver._effective_candidates(len(local.meg)))
        metrics = solver.step(arrays, torch.ones(len(local.meg)), True,
                              negatives, weight, return_output=True)
        solver._update_negative_pool("train", metrics["output"])
        out["negatives"].append(negatives.numpy())
        out["pools"].append(solver.negative_pool["train"].copy())
    return out


# -- the parent's side ------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX package's tiny_args solver (BASE) with Adam and its initial
    state, STEPS batches of 8 rows (4 from each training recording), and
    the port's overrides of BASE, of BASE with the small DeepMel with and
    without BatchNorm, and of NO_BN. ``jax_solver`` adds the JAX
    package's JAX_DEEPMEL solver."""
    import jax
    from test_solver import tiny_args
    from test_torch_epochs import TINY

    from brainmagick_tpu import train as jtrain
    from brainmagick_tpu.dataset import SegmentBatch
    from brainmagick_tpu.env import env as jenv
    from brainmagick_tpu_torch import train

    tmp = tmp_path_factory.mktemp("parallel")
    cache = tmp / "fake_cache"
    cache.mkdir()
    with jenv.temporary(cache=cache):
        args = jtrain.parse_overrides(BASE, tiny_args(cache, tmp / "base"))
        solver = jtrain.get_solver(args, training=True)
    solvers = {"base": (solver, jax.device_get(solver.state))}
    dsets = solver.datasets.train.datasets
    batches = [SegmentBatch.collate([d[i] for d in dsets
                                     for i in range(4 * s, 4 * s + 4)])
               for s in range(STEPS)]
    port_args = {name: train.parse_overrides(
        TINY + ["device=cpu", f"cache={cache}", f"out_dir={tmp / name}",
                *extra])
        for name, extra in (("base", BASE), ("deepmel", BASE + JAX_DEEPMEL),
                            ("deepmel_bn", BASE + DEEPMEL),
                            ("no_bn", NO_BN))}
    yield types.SimpleNamespace(
        solvers=solvers, batches=batches, args=port_args, cache=cache,
        tmp=tmp, norm_arrays={k: np.asarray(v) for k, v in
                              solver.norm_arrays.items()},
        arrays=[{name: np.asarray(getattr(b, name))
                 for name in SegmentBatch.ARRAY_FIELDS} for b in batches])


def jax_solver(setup, name: str):
    """The JAX package's solver `name` of ``setup.solvers`` ("deepmel":
    JAX_DEEPMEL, built at first use) and its initial state."""
    if name not in setup.solvers:
        import jax
        from test_solver import tiny_args

        from brainmagick_tpu import train as jtrain
        from brainmagick_tpu.env import env as jenv
        with jenv.temporary(cache=setup.cache):
            args = jtrain.parse_overrides(BASE + JAX_DEEPMEL, tiny_args(
                setup.cache, setup.tmp / name))
            solver = jtrain.get_solver(args, training=True)
        setup.solvers[name] = (solver, jax.device_get(solver.state))
    return setup.solvers[name]


def _widths(solver) -> tuple:
    model = solver.model
    chout = solver.feature_model.n_in_channels \
        if solver.feature_model is not None else model.out_channels
    return model.in_channels["meg"], chout, model.n_subjects


def _with(args, **parallel):
    args = copy.deepcopy(args)
    for key, value in parallel.items():
        setattr(args.parallel, key, value)
    return args


def _jax_mesh(setup, name: str, n: int, k: int, ring: bool) -> dict:
    """The JAX solver `name` on an n-device mesh with groups of k and
    ``ring_negatives``: the eval step's loss on batch 0, jax.grad of the
    sharded train step's pmean'd loss on batch 0 (as the step builds it),
    STEPS train steps from the initial state, and the state after them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from brainmagick_tpu.dataset import SegmentBatch
    from brainmagick_tpu.parallel import make_mesh

    solver, state0 = jax_solver(setup, name)
    solver.args.parallel.negatives_group_size = k
    solver.args.parallel.ring_negatives = ring
    solver.set_mesh(make_mesh(n))
    mesh = solver.mesh
    axis = mesh.axis_names[0]
    kk = solver._negatives_group_size()
    gather_axis = axis if kk > 1 else None
    groups = None if kk in (1, n) else [list(range(g * kk, (g + 1) * kk))
                                        for g in range(n // kk)]
    state = jax.tree_util.tree_map(jnp.array, state0)
    rng = jax.random.PRNGKey(0)
    pad = jnp.ones(len(setup.batches[0]), jnp.float32)
    arrays = [b.to_device() for b in setup.batches]
    _, evaluated = solver._build_step(False, False, False)(
        state, arrays[0], solver.norm_arrays, pad, None, None, rng)
    spec = {f: P(axis) for f in SegmentBatch.ARRAY_FIELDS}

    def local(params, stats, arrays, na, pw, rngs):
        loss, _ = solver._loss_and_aux(
            params, stats, arrays, na, pw, None, None, rngs[0], True, False,
            gather_axis=gather_axis, gather_groups=groups)
        return jax.lax.pmean(loss, axis)

    def loss_of(params):
        return jax.shard_map(
            local, mesh=mesh, in_specs=(P(), P(), spec, P(), P(axis),
                                        P(axis)),
            out_specs=P(), check_vma=False)(
            params, state["batch_stats"], arrays[0], solver.norm_arrays,
            pad, jax.random.split(rng, n))

    grads = jax.device_get(jax.jit(jax.grad(loss_of))(state["params"]))
    step = solver._build_step(True, False, False)
    metrics = [{"loss": float(evaluated["loss"]),
                "keep": float(evaluated["keep"]),
                "count": float(evaluated["count"])}]
    for a in arrays:
        state, m = step(state, a, solver.norm_arrays, pad, None, None, rng)
        metrics.append({key: float(m[key]) for key in ("loss", "keep",
                                                       "count")})
    return dict(metrics=metrics, grads=grads, state=jax.device_get(state))


def _rules(trainer) -> list:
    from brainmagick_tpu_torch import convert
    rules = [("model", trainer.model, convert.simpleconv_rules(trainer.model))]
    if trainer.feature_model is not None:
        rules.append(("fm", trainer.feature_model,
                      convert.deepmel_rules(trainer.feature_model)))
    return rules


def _noise_mask(module, tkey):
    from test_torch_deepmel import _noise_driven
    return _noise_driven(module, tkey)


def _port_trainer(args, widths, norm_arrays, params=None, stats=None):
    from brainmagick_tpu_torch.train import Trainer
    return Trainer(args, *widths, params, stats, norm_arrays, device="cpu",
                   generator=torch.Generator().manual_seed(0))


def _check_params(got: dict, want: dict, trainer, lr: float,
                  fused: bool) -> None:
    """Parameters within 0.01 lr (noise-driven entries 2 STEPS lr),
    running variances rtol 1e-5, running means atol 1e-5 in a fused model
    and within the noise-driven biases' drift otherwise; `got` and `want`
    keyed by "model." / "fm." and the port's names."""
    for prefix, module, rules in _rules(trainer):
        for tkey, _, _, coll in rules:
            key = f"{prefix}.{tkey}"
            if coll == "params":
                atol = np.where(_noise_mask(module, tkey), 2 * STEPS * lr,
                                0.01 * lr)
                assert (np.abs(got[key] - want[key]) <= atol).all(), key
            elif tkey.endswith("running_var"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           err_msg=key)
            else:
                atol = 1e-5 if fused and prefix == "model" \
                    else 2 * STEPS * lr * (1 - 0.99 ** STEPS)
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=atol, err_msg=key)


def _jax_as_port(trainer, tree: dict, grads: bool = False) -> dict:
    """A JAX {"params", "batch_stats"} state (or a gradient tree) in the
    port's names and layouts."""
    from test_torch_train import _leaf

    from brainmagick_tpu.convert import _untransform
    out = {}
    for prefix, _, rules in _rules(trainer):
        for tkey, fpath, kind, coll in rules:
            if grads and coll != "params":
                continue
            src = tree if grads else tree[coll]
            out[f"{prefix}.{tkey}"] = _untransform(kind, _leaf(src, fpath))
    return out


def _compare(got: dict, want: dict, trainer, lr: float, fused: bool,
             params: bool = True) -> None:
    """Two drives of the same ops: every metric (losses rtol LOSS_RTOL,
    keep and count exactly), the gradients atol GRAD_ATOL and (`params`)
    the final state (``_check_params``)."""
    assert len(got["metrics"]) == len(want["metrics"])
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert (g["keep"], g["count"]) == (w["keep"], w["count"])
    if want["grads"] is not None:
        assert set(got["grads"]) == set(want["grads"])
        for key, value in want["grads"].items():
            np.testing.assert_allclose(got["grads"][key], value, rtol=0,
                                       atol=GRAD_ATOL, err_msg=key)
    if params:
        _check_params(got["state"], want["state"], trainer, lr, fused)


def _same_on_every_rank(results: list, run: str) -> None:
    """The ranks end with the same state (one run, not N)."""
    for other in results[1:]:
        for key, value in results[0][run]["state"].items():
            np.testing.assert_array_equal(other[run]["state"][key], value,
                                          err_msg=key)


TRAIN_OPS = [("eval", 0)] + [("train", i) for i in range(STEPS)]

#: (a): negatives_group_size, ring_negatives, the model and the ranks of
#: each case
SHARDED = {"local": (1, False, "base", 2),
           "gathered": (0, False, "deepmel", 2),
           "ring": (0, True, "deepmel", 2),
           "ring_groups_on_4": (2, True, "deepmel", 4)}


@pytest.mark.parametrize("case", list(SHARDED))
def test_ranks_match_the_jax_sharded_step(setup, tmp_path, case):
    """(a) N ranks against the JAX package's step on an N-device mesh,
    from the same weights on the same batches: the eval step's loss, the
    gradient of the first train step's mean loss over the ranks against
    jax.grad of the sharded step's pmean'd loss, STEPS train steps' losses
    and the weights and running statistics after them. On 2 ranks,
    per-rank pools (k=1), and one pool of both ranks' rows gathered or
    passed around the ring (k=0); on 4, groups of 2 around their rings;
    the last three with a DeepMel (JAX_DEEPMEL) whose gradient flows back
    through the other ranks' rows."""
    k, ring, name, world = SHARDED[case]
    solver, state0 = jax_solver(setup, name)
    args = _with(setup.args[name], negatives_group_size=k,
                 ring_negatives=ring)
    widths = _widths(solver)
    data = dict(batches=setup.arrays, norm_arrays=setup.norm_arrays,
                runs={case: dict(args=args, widths=widths,
                                 params=state0["params"],
                                 stats=state0["batch_stats"],
                                 ops=TRAIN_OPS)})
    results = run_ranks("_case_trainer", world, data, tmp_path)
    want = _jax_mesh(setup, name, world, k, ring)
    trainer = _port_trainer(args, widths, setup.norm_arrays)
    want = dict(metrics=want["metrics"],
                grads=_jax_as_port(trainer, want["grads"], grads=True),
                state=_jax_as_port(trainer, want["state"]))
    _compare(results[0][case], want, trainer, args.optim.lr, fused=True)
    _same_on_every_rank(results, case)


def _one_rank(setup, runs: dict) -> dict:
    """`runs` driven in this process, alone."""
    return _case_trainer(0, 1, dict(batches=setup.arrays,
                                    norm_arrays=setup.norm_arrays,
                                    runs=runs))


def _rank_runs(setup, **parallel) -> dict:
    """The BatchNorm'd model's eval-mode gradient and STEPS train steps of
    the model without BatchNorm, both from the port's seeded weights."""
    widths = _widths(setup.solvers["base"][0])
    return {"bn": dict(args=_with(setup.args["base"], **parallel),
                       widths=widths, ops=[("eval", 0), ("grad", 1)]),
            "no_bn": dict(args=_with(setup.args["no_bn"], **parallel),
                          widths=widths,
                          ops=[("train", i) for i in range(STEPS)])}


def _compare_rank_runs(setup, got: dict, want: dict) -> None:
    args = setup.args["no_bn"]
    widths = _widths(setup.solvers["base"][0])
    _compare(got["bn"], want["bn"], None, 0., False, params=False)
    _compare(got["no_bn"], want["no_bn"],
             _port_trainer(args, widths, setup.norm_arrays), args.optim.lr,
             fused=False)


def test_global_pool_matches_one_rank(setup, tmp_path):
    """(b) negatives_group_size=0 over 2 ranks gives one rank's loss on the
    global batch: the eval-mode loss and its gradient with BatchNorm, and
    STEPS train steps without it (losses, gradients, weights)."""
    results = run_ranks("_case_trainer", 2, dict(
        batches=setup.arrays, norm_arrays=setup.norm_arrays,
        runs=_rank_runs(setup, negatives_group_size=0)), tmp_path)
    _compare_rank_runs(setup, results[0], _one_rank(setup, _rank_runs(
        setup)))
    _same_on_every_rank(results, "no_bn")


def test_negative_pool_is_the_same_on_every_rank(setup, tmp_path):
    """``optim.negatives`` over 2 ranks: after each step both ranks hold the
    same pool (the global batch's targets, newest first), equal to one
    rank's on the global batch, and draw the same negatives."""
    from brainmagick_tpu_torch import train
    args = train.parse_overrides(["optim.negatives=12"],
                                 copy.deepcopy(setup.args["no_bn"]))
    data = dict(args=args, widths=_widths(setup.solvers["base"][0]),
                norm_arrays=setup.norm_arrays, batches=setup.arrays)
    two = run_ranks("_case_negative_pool", 2, data, tmp_path)
    one = run_ranks("_case_negative_pool", 1, data, tmp_path)
    for step in range(STEPS):
        np.testing.assert_array_equal(two[0]["pools"][step],
                                      two[1]["pools"][step])
        np.testing.assert_array_equal(two[0]["negatives"][step],
                                      two[1]["negatives"][step])
        np.testing.assert_array_equal(two[0]["pools"][step],
                                      one[0]["pools"][step])
    assert len(two[0]["pools"][-1]) == min(24, 8 * STEPS)
    # the second step draws from the first step's 8 targets
    assert two[0]["negatives"][1].any()


def test_groups_of_two_on_four_ranks_match_two_ranks(setup, tmp_path):
    """(c) Groups of 2 on 4 ranks rebuild the per-rank pools of 2 ranks
    (the same rows in each pool): the eval-mode loss and gradient with
    BatchNorm, STEPS train steps without; a group size that does not
    divide the ranks is refused."""
    four = run_ranks("_case_trainer", 4, dict(
        batches=setup.arrays, norm_arrays=setup.norm_arrays,
        runs=_rank_runs(setup, negatives_group_size=2)), tmp_path)
    two = run_ranks("_case_trainer", 2, dict(
        batches=setup.arrays, norm_arrays=setup.norm_arrays,
        runs=_rank_runs(setup, negatives_group_size=1)), tmp_path)
    _compare_rank_runs(setup, four[0], two[0])
    _same_on_every_rank(four, "no_bn")
    bad = dict(batches=setup.arrays, norm_arrays=setup.norm_arrays,
               runs=_rank_runs(setup, negatives_group_size=3))
    with pytest.raises(pytest.fail.Exception,
                       match="negatives_group_size=3 must divide"):
        run_ranks("_case_trainer", 4, bad, tmp_path)


def _clip_loss(estimate: torch.Tensor, output: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
    """The solver's CLIP loss (no projection, pooling, centering or trim)
    in the inputs' own type: ``ClipLoss`` casts its operands to fp32."""
    from brainmagick_tpu_torch.losses import ClipLoss
    e = estimate.reshape(len(estimate), -1)
    c = output.reshape(len(output), -1)
    inv = 1 / (1e-8 + torch.sqrt((c * c).sum(dim=1)))
    return ClipLoss.loss_from_scores((e @ c.T) * inv[None, :], keep, keep)


def deepmel_bn_gradients(trainer, local) -> tuple:
    """The train-mode loss's gradient of the feature model's (a
    BatchNorm'd DeepMel's) parameters on one rank's rows `local` of a
    local pool (k=1): in fp32 by ``Solver.loss_and_grad``, and in float64
    from the same fp32-wired inputs (the estimate, the keep weights and
    the DeepMel's input), the DeepMel and the loss in float64. Returns
    ({name: fp32 gradient}, {name: float64 gradient}) in the port's
    names."""
    from brainmagick_tpu_torch.dataset import to_device
    from brainmagick_tpu_torch.models.common import ConvSequence

    solver, fm = trainer.solver, trainer.feature_model
    arrays = to_device(local, "cpu")
    weight = torch.ones(len(local.meg))
    seen = {}
    hook = fm.register_forward_pre_hook(
        lambda module, inputs: seen.setdefault("targets",
                                               inputs[0].detach().clone()))
    solver.loss_and_grad(arrays, weight, train=True)
    hook.remove()
    fp32 = {k: p.grad.clone() for k, p in fm.named_parameters()}
    with torch.no_grad():
        estimate, output, _, keep, _ = solver._forward(arrays, weight,
                                                       train=True)
    # the float64 loss in fp32 is the solver's loss
    torch.testing.assert_close(
        _clip_loss(estimate, output, keep),
        solver._loss_value(estimate, output, None, keep, True))
    fm64 = copy.deepcopy(fm).double().train()
    # DeepMel.forward returns fp32; its ConvSequence keeps float64
    out64 = ConvSequence.forward(fm64, seen["targets"].double())
    _clip_loss(estimate.double(), out64, keep.double()).backward()
    return fp32, {k: p.grad for k, p in fm64.named_parameters()}


def test_port_deepmel_bn_gradients_match_float64(setup):
    """The claim behind JAX_DEEPMEL, for the port: on the 4-row shards of
    the first batch (the rows a rank of 2 gets), a local pool each, the
    port's fp32 gradients of every layer of the BatchNorm'd DeepMel, over
    the shards as the ranks average them, lie within GRAD_ATOL of
    float64's (``scripts/torch_deepmel_bn_float64.py`` prints both
    packages' distances)."""
    widths = _widths(setup.solvers["base"][0])
    trainer = _port_trainer(setup.args["deepmel_bn"], widths,
                            setup.norm_arrays)
    assert any(isinstance(m, torch.nn.BatchNorm1d)
               for m in trainer.feature_model.modules())
    sums = [{}, {}]
    for rank in range(2):
        for total, grads in zip(sums, deepmel_bn_gradients(
                trainer, _local(setup.arrays[0], rank, 2))):
            for key, value in grads.items():
                total[key] = total.get(key, 0) + value / 2
    fp32, f64 = sums
    assert set(fp32) == set(f64) and len(fp32) >= 6
    worst = {k: float((fp32[k].double() - f64[k]).abs().max())
             for k in f64}
    assert max(worst.values()) <= GRAD_ATOL, worst
    assert max(float(g.abs().max()) for g in f64.values()) > 100 * GRAD_ATOL


def test_ring_negatives_match_gathered(setup, tmp_path):
    """(d) ring_negatives against the gathered pool on 4 ranks, groups of
    2 and of all 4, with the small BatchNorm'd DeepMel (whose gradient
    flows back around the ring), from the port's seeded weights: STEPS
    train steps' losses and every rank's first gradient and final
    weights."""
    args = setup.args["deepmel_bn"]
    widths = _widths(setup.solvers["base"][0])
    runs = {f"{k}_{ring}": dict(
        args=_with(args, negatives_group_size=k, ring_negatives=ring),
        widths=widths, ops=TRAIN_OPS)
        for k in (2, 0) for ring in (False, True)}
    results = run_ranks("_case_trainer", 4, dict(
        batches=setup.arrays, norm_arrays=setup.norm_arrays, runs=runs),
        tmp_path)
    trainer = _port_trainer(args, widths, setup.norm_arrays)
    for result in results:
        for k in (2, 0):
            _compare(result[f"{k}_True"], result[f"{k}_False"], trainer,
                     args.optim.lr, fused=True)
    # groups of 2 and one pool of 4 are different losses
    assert results[0]["2_False"]["metrics"][0]["loss"] \
        != results[0]["0_False"]["metrics"][0]["loss"]


def test_v5e8_paper_pool_rule(setup, tmp_path):
    """(e) clip_conv_v5e8_paper's pool rule at tiny width on 4 ranks: its
    negatives_group_size (4) and ring_negatives make one pool of the
    global batch passed around the ring, which is one rank's loss on the
    global batch (eval-mode loss and gradient with BatchNorm, STEPS train
    steps without); the presets' fields are the JAX package's."""
    from brainmagick_tpu import config as jconfig
    from brainmagick_tpu_torch import config

    paper = config.apply_preset(config.MainConfig(), "clip_conv_v5e8_paper")
    weak = config.apply_preset(config.MainConfig(), "clip_conv_v5e8")
    assert (paper.optim.batch_size, paper.parallel.negatives_group_size,
            paper.parallel.ring_negatives) == (256, 4, True)
    assert (weak.optim.batch_size, weak.parallel.negatives_group_size) \
        == (2048, 1)
    for name in ("clip_conv_v5e8", "clip_conv_v5e8_paper"):
        want = jconfig.apply_preset(jconfig.MainConfig(), name)
        assert config.apply_preset(config.MainConfig(), name).sig == want.sig
    rule = dict(negatives_group_size=paper.parallel.negatives_group_size,
                ring_negatives=paper.parallel.ring_negatives)
    results = run_ranks("_case_trainer", 4, dict(
        batches=setup.arrays, norm_arrays=setup.norm_arrays,
        runs=_rank_runs(setup, **rule)), tmp_path)
    _compare_rank_runs(setup, results[0], _one_rank(setup,
                                                    _rank_runs(setup)))


# -- the test stage -------------------------------------------------------

#: ragged ring_scores operands: neither 13 rows nor 21 candidates divide
#: over 2 ranks
RING_SHAPES = ((13, 4, 6), (21, 4, 6))


def _test_stage(solver, mse_solver) -> dict:
    """The test stage's and the offline evaluation's results of `solver`
    (a rank of a group, or alone): get_wer, load_test_data and
    build_probs, the streaming metrics (get_test_metrics) of `mse_solver`
    (an MSE decoder: its test features hold no word hash), then get_wer
    and build_probs again with
    ring_scoring; with a group also ring_scores at RING_SHAPES and the
    dispatch of maybe_ring_scores; the merger's train-mode weights from
    the epoch-1 dropout seed, drawn twice."""
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import losses, play, wer
    out = {"wer": wer.get_wer(solver, wer.test_batches(solver))}
    data = port_eval.load_test_data(solver)
    out["data"] = {k: data[k] for k in ("preds", "trues", "segment_hashes")}
    out["probs"] = port_eval.build_probs(solver, data["preds"],
                                         data["trues"])
    out["metrics"] = play.get_test_metrics(mse_solver)
    solver.args.parallel.ring_scoring = True
    out["wer_ring"] = wer.get_wer(solver, wer.test_batches(solver))
    out["probs_ring"] = port_eval.build_probs(solver, data["preds"],
                                              data["trues"])
    group = solver.group
    if group is not None:
        rng = np.random.RandomState(0)
        est, pool = (rng.randn(*s).astype(np.float32) for s in RING_SHAPES)
        for name in (None, "bfloat16"):
            out[f"ring_{name}"] = losses.ring_scores(
                group, est, pool,
                None if name is None else torch.bfloat16, solver.device)
        trimmed = losses.ClipLoss(tmin=0.0, dset_tmin=-0.2)
        out["dispatch"] = [
            losses.maybe_ring_scores(solver, solver.clip, est, pool)
            is not None,
            losses.maybe_ring_scores(solver, trimmed, est, pool) is None,
            losses.maybe_ring_scores(solver, solver.clip, est, pool,
                                     budget_bytes=1) is None]
    solver.args.parallel.ring_scoring = False
    merger = solver.model.merger
    merger.train()
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(solver.dropout_seed(True))
        draws.append(merger.attention(solver.norm_arrays["rec_positions"],
                                      generator=gen).detach().numpy())
    merger.eval()
    out["merger"] = draws
    return out


def _case_test_stage(rank: int, world: int, data: dict) -> dict:
    from brainmagick_tpu_torch import parallel, train
    from brainmagick_tpu_torch.env import env
    with env.temporary(cache=data["cache"]):
        solver, mse_solver = (train.get_solver(
            data[key], training=False, group=parallel.DataGroup())
            for key in ("args", "mse_args"))
        solver.epoch = 1
        return _test_stage(solver, mse_solver)


@pytest.fixture(scope="module")
def test_stages(setup, tmp_path_factory):
    """The port's untrained tiny solver (merger dropout on) on the fake
    study: ``_test_stage`` alone in this process (which fills the port's
    cache), and on each of 2 ranks."""
    from brainmagick_tpu_torch import train
    from brainmagick_tpu_torch.env import env
    args = train.parse_overrides(["simpleconv.merger_dropout=0.3"],
                                 copy.deepcopy(setup.args["base"]))
    mse_args = train.parse_overrides(["optim.loss=mse"],
                                     copy.deepcopy(setup.args["base"]))
    with env.temporary(cache=setup.cache):
        solver, mse_solver = (train.get_solver(a, training=False)
                              for a in (args, mse_args))
        solver.epoch = 1
        alone = _test_stage(solver, mse_solver)
    ranks = run_ranks("_case_test_stage", 2,
                      dict(args=args, mse_args=mse_args, cache=setup.cache),
                      tmp_path_factory.mktemp("test_stage"))
    return alone, ranks, solver


def test_test_stage_matches_one_rank(test_stages):
    """(f) The test stage over 2 ranks (each batch's forward split over the
    ranks, the retrieval scores too) gives every rank the one-rank WER,
    predictions, candidates, probabilities and streaming metrics."""
    alone, ranks, _ = test_stages
    for got in ranks:
        assert set(got["wer"]) == {"wer", "wer_vocab", "wer_n_vocab"}
        for key, value in alone["wer"].items():
            np.testing.assert_allclose(got["wer"][key], value, atol=1e-6,
                                       err_msg=key)
        for key, value in alone["data"].items():
            np.testing.assert_allclose(got["data"][key], value, rtol=0,
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["probs"], alone["probs"], rtol=1e-5,
                                   atol=1e-6)
        assert set(got["metrics"]) == set(alone["metrics"])
        for key, value in alone["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], value,
                                       rtol=1e-5, atol=1e-6, err_msg=key)


def test_ring_scoring_matches_streamed(test_stages):
    """(g) ring_scores at ragged shapes (rows and pool padded) against
    retrieval_scores in fp32 and bf16; ring-scored WER and probabilities
    against the streamed ones; maybe_ring_scores engages only for the
    fast-path clip within its budget (and never alone)."""
    from brainmagick_tpu_torch import losses
    alone, ranks, solver = test_stages
    rng = np.random.RandomState(0)
    est, pool = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in RING_SHAPES)
    for name, dtype in ((None, None), ("bfloat16", torch.bfloat16)):
        clip = losses.ClipLoss(compute_dtype=name)
        want = losses.retrieval_scores(clip, est, pool).numpy()
        for got in ranks:
            assert got[f"ring_{name}"].shape == want.shape
            np.testing.assert_allclose(got[f"ring_{name}"], want, rtol=1e-5,
                                       atol=1e-5)
    for got in ranks + [alone]:
        for key, value in got["wer"].items():
            np.testing.assert_allclose(got["wer_ring"][key], value,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got["probs_ring"], got["probs"],
                                   rtol=1e-5, atol=1e-6)
    assert all(got["dispatch"] == [True, True, True] for got in ranks)
    solver.args.parallel.ring_scoring = True
    try:
        assert losses.maybe_ring_scores(solver, solver.clip, est, pool) \
            is None
    finally:
        solver.args.parallel.ring_scoring = False


def test_merger_dropout_per_rank(test_stages):
    """(h) Each rank draws its merger dropout from its own stream: the
    ranks' disks differ, each repeats from the seed, and rank 0 draws what
    a run alone draws."""
    alone, ranks, _ = test_stages
    for got in ranks:
        np.testing.assert_array_equal(got["merger"][0], got["merger"][1])
    assert not np.array_equal(ranks[0]["merger"][0], ranks[1]["merger"][0])
    np.testing.assert_array_equal(ranks[0]["merger"][0], alone["merger"][0])
    # the disk drops sensors: some weights are exactly 0
    assert (ranks[1]["merger"][0] == 0).any()


# -- the XP folder ---------------------------------------------------------

def _case_cli(rank: int, world: int, data: dict) -> dict:
    """``train.main`` for one epoch, then a second run that continues it
    (continue_sig, continue_best=False) for one more, recording every
    write of the solver module and every restore."""
    from brainmagick_tpu_torch import solver as solver_module
    from brainmagick_tpu_torch import train
    writes, restores = [], []
    write = solver_module.write_and_rename
    restore = solver_module.Solver.restore

    def spy_write(path, *args, **kwargs):
        writes.append(str(path))
        return write(path, *args, **kwargs)

    def spy_restore(solver):
        found = restore(solver)
        restores.append(dict(found=found, epoch=solver.epoch,
                             history=list(solver.history)))
        return found

    solver_module.write_and_rename = spy_write
    solver_module.Solver.restore = spy_restore
    first = train.parse_overrides(data["tokens"] + ["optim.epochs=1"])
    best = [train.main(data["tokens"] + ["optim.epochs=1"]),
            train.main(data["tokens"] + [
                "optim.epochs=2", f"continue_sig={first.sig}",
                "continue_best=False"])]
    return dict(writes=writes, restores=restores, best=best)


def test_rank_zero_writes_and_every_rank_resumes(setup, tmp_path):
    """(i) Two ranks of ``train.main`` (the launcher's environment, a group
    made by the caller): rank 0 alone writes the XP folder (checkpoint,
    history and done files), the other rank writes nothing; the second
    run restores the first XP's state on every rank and trains its
    second epoch; the ranks report the same best loss."""
    from test_torch_epochs import TINY

    from brainmagick_tpu_torch.cache import tagged
    from brainmagick_tpu_torch.train import parse_overrides
    out_dir = tmp_path / "outputs"
    tokens = TINY + ["device=cpu", f"cache={setup.cache}",
                     f"out_dir={out_dir}", *BASE]
    results = run_ranks("_case_cli", 2, dict(tokens=tokens), tmp_path)
    lead, other = results
    assert other["writes"] == []
    names = {Path(p).name for p in lead["writes"]}
    assert {tagged(n) for n in ("checkpoint.pt", "history.json",
                                "done.json")} <= names
    assert lead["best"] == other["best"]
    first = parse_overrides(tokens + ["optim.epochs=1"])
    second = parse_overrides(tokens + [
        "optim.epochs=2", f"continue_sig={first.sig}", "continue_best=False"])
    for result in results:
        _, resumed = result["restores"]
        assert resumed["epoch"] == 2 and len(resumed["history"]) == 1
    history = (out_dir / "xps" / second.sig / tagged("history.json"))
    assert history.exists() and len(json.loads(history.read_text())) == 2


def test_cli_under_the_launcher(setup, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node=2 -m
    brainmagick_tpu_torch.train preset=tiny device=cpu ...`` trains, tests
    and writes one XP folder; the log names the run's two ranks."""
    from test_torch_epochs import TINY

    from brainmagick_tpu_torch.cache import tagged
    from brainmagick_tpu_torch.train import parse_overrides
    tokens = TINY + ["device=cpu", f"cache={setup.cache}",
                     f"out_dir={tmp_path}", "optim.epochs=1", *BASE]
    env_vars = {k: v for k, v in os.environ.items()
                if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE",
                             "LOCAL_RANK")}
    env_vars.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "brainmagick_tpu_torch.train",
         *tokens], cwd=tmp_path, env=env_vars, capture_output=True,
        text=True, timeout=DEADLINE)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Data-parallel run over 2 rank(s) (gloo)" in proc.stderr
    folder = Path(parse_overrides(tokens).xp_folder)
    history = json.loads((folder / tagged("history.json")).read_text())
    assert len(history) == 1 and "test" in history[0]
    assert (folder / tagged("done.json")).exists()
    assert sorted(p.name for p in folder.iterdir()) == sorted(
        tagged(n) for n in ("checkpoint.pt", "history.json", "done.json"))
