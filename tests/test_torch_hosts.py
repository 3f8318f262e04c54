"""Ranks on several hosts (``brainmagick_tpu_torch.parallel``'s host
layer), held to the JAX package's processes.

The reference is the JAX package's real two-process run:
tests/mp_worker.py's code, unchanged, run as tests/test_multiprocess.py
runs it (two jax.distributed processes of two CPU devices each, the cache
built first in this process), with one change to its config: the
merger's dropout is off, because its disks come from JAX's key in the
JAX package and from each rank's generator in the port, which no seed
makes alike (tests/test_torch_parallel.py's parity runs turn it off for
the same reason). Beside it the port's train CLI runs under
``python -m torch.distributed.run --nnodes=2 --nproc_per_node=2`` as two
launcher processes on localhost over gloo, once with a static rendezvous
and once with c10d, from the JAX run's initial weights (the JAX package's
checkpoint.pkl, which the port resumes): its train loss and its test
stage's WER, averaged over the hosts, are the JAX run's at
tests/test_torch_parallel.py's tolerances.

In-process cases hold ``HostLayout.host_rows`` to the JAX package's
``process_rows``, refuse layouts that are not node by node, and run 2
hosts x 2 ranks spawned here (a two-node launcher's environment, a
FileStore) for ``average_metrics_across_processes``, ``lead_first``'s
per-host caches and the test stage: each host's WER, streaming metrics
and evaluation are the port's one-process functions on that host's rows,
and the reported metrics their mean."""

import datetime
import json
import os
import pickle
import re
import socket
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
from test_multiprocess import _child_env, _free_port
from test_torch_epochs import TINY

REPO = Path(__file__).resolve().parents[1]
#: tests/test_torch_parallel.py's tolerances: losses relative, test
#: metrics absolute
LOSS_RTOL = 1e-5
METRIC_ATOL = 1e-6
#: how long a launch (or the JAX run) may take, and a spawned case
DEADLINE = 240.
RANK_TIMEOUT = datetime.timedelta(seconds=60)
#: mp_worker.py's main with its config's merger dropout off
JAX_CHILD = """
import sys
import mp_worker
build = mp_worker.build_args
def build_args(*args, **kwargs):
    config = build(*args, **kwargs)
    config.simpleconv["merger_dropout"] = 0.0
    return config
mp_worker.build_args = build_args
sys.argv = [mp_worker.__file__] + sys.argv[1:]
mp_worker.main()
"""
#: mp_worker.build_args as the port's overrides, the dropout off
PORT_ARGS = [t for t in TINY if not t.startswith(("optim.lr=", "dset.f"))] \
    + ['dset.features=["MelSpectrum"]',
       'dset.features_params={"MelSpectrum": {"n_mels": 8}}',
       "optim.epochs=1", "optim.max_batches=3",
       "simpleconv.merger_dropout=0.0", "device=cpu"]


def _env(**extra) -> dict:
    environ = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE", "GROUP_RANK", "MASTER_ADDR",
                            "MASTER_PORT")}
    environ.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    return environ


def _jax_value(log: str, key: str) -> float:
    match = re.search(rf"{key} ([0-9.eE+-]+)", log)
    assert match, log[-3000:]
    return float(match.group(1))


def _launch(out_dir: Path, rendezvous: str) -> list:
    """The port's train CLI as 2 launcher processes of 2 ranks each, one a
    host, each host with its own cache; returns their Popen objects."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for host in range(2):
        cache = out_dir / f"host{host}" / "fake_cache"
        cache.mkdir(parents=True)
        launch = ([f"--node_rank={host}", "--master_addr=127.0.0.1",
                   f"--master_port={port}"] if rendezvous == "static" else
                  ["--rdzv_backend=c10d",
                   f"--rdzv_endpoint=127.0.0.1:{port}", "--rdzv_id=hosts"])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes=2",
             "--nproc_per_node=2", *launch, "-m",
             "brainmagick_tpu_torch.train", *PORT_ARGS,
             f"out_dir={out_dir}", f"cache={cache}"],
            cwd=out_dir, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs: list) -> list:
    end = time.monotonic() + DEADLINE
    logs = []
    try:
        for proc in procs:
            log, _ = proc.communicate(timeout=max(1., end - time.monotonic()))
            logs.append(log)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-4000:]
    return logs


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    """The JAX package's two-process run and the port's two-host launches
    (static and c10d rendezvous), all at once."""
    import mp_worker

    from brainmagick_tpu import train as jtrain
    from brainmagick_tpu.env import env as jenv
    from brainmagick_tpu_torch.train import parse_overrides

    tmp = tmp_path_factory.mktemp("hosts")
    cache = tmp / "fake_cache"
    cache.mkdir()
    args = mp_worker.build_args(str(cache), str(tmp / "pre"))
    args.simpleconv["merger_dropout"] = 0.0
    port_args = parse_overrides(PORT_ARGS)
    assert port_args.sig == args.sig
    with jenv.temporary(cache=cache):
        jsolver = jtrain.get_solver(args)
    # the initial state as the JAX package's checkpoint.pkl at epoch 1,
    # which each launch resumes (an epoch of 0 commits as 1)
    runs = {}
    for name in ("static", "c10d"):
        out = tmp / name
        jsolver.folder = out / "xps" / args.sig
        jsolver.checkpoint_path = jsolver.folder / "checkpoint.pkl"
        jsolver.folder.mkdir(parents=True)
        jsolver.epoch = 0
        jsolver.commit(block=True)
        runs[name] = out
    port = _free_port()
    env = _child_env(2)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "tests"),
                                         env["PYTHONPATH"]])
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, str(i), "2", str(port),
         str(cache), str(tmp / "jax")], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    launches = {name: _launch(out, name) for name, out in runs.items()}
    jax_logs = _wait(jax_procs)
    logs = {name: _wait(procs) for name, procs in launches.items()}
    histories = {name: json.loads((out / "xps" / args.sig
                                   / "history-torch.json").read_text())
                 for name, out in runs.items()}
    return types.SimpleNamespace(jax_logs=jax_logs, logs=logs,
                                 histories=histories, runs=runs,
                                 sig=args.sig)


def test_two_host_launch_matches_the_jax_two_process_run(two_hosts):
    """The port's two hosts of two ranks train the JAX package's two
    processes of two devices: the epoch's train loss within LOSS_RTOL,
    and the test stage's WER (each host's rows against its own pool, the
    mean over the hosts) within METRIC_ATOL; both JAX processes report
    the same numbers, as do both rendezvous."""
    jax = [{key: _jax_value(log, key) for key in ("TRAIN_LOSS", "WER")}
           for log in two_hosts.jax_logs]
    assert jax[0] == jax[1]
    for log in two_hosts.jax_logs:
        assert "FWD_ROWS 4 " in log
    history = two_hosts.histories["static"]
    assert len(history) == 1
    np.testing.assert_allclose(history[0]["train"]["loss"],
                               jax[0]["TRAIN_LOSS"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(history[0]["test"]["wer"], jax[0]["WER"],
                               rtol=0, atol=METRIC_ATOL)
    assert two_hosts.histories["c10d"] == history


def test_two_host_launch_layout_and_files(two_hosts):
    """Every rank logs 4 ranks on 2 hosts; rank 0 alone wrote the XP
    folder; each host's first rank filled that host's cache."""
    for name, logs in two_hosts.logs.items():
        text = "".join(logs)
        for rank in range(4):
            assert f"[rank {rank}] __main__: Data-parallel run over 4 " \
                   f"rank(s) (gloo) on 2 host(s)" in text, name
        folder = two_hosts.runs[name] / "xps" / two_hosts.sig
        names = sorted(p.name for p in folder.iterdir())
        # the JAX package's initial checkpoint and history, and the port's
        assert names == ["checkpoint-torch.pt", "checkpoint.pkl",
                         "done-torch.json", "history-torch.json",
                         "history.json"], names
        for host in range(2):
            cache = two_hosts.runs[name] / f"host{host}" / "fake_cache"
            assert any(cache.iterdir()), (name, host)


# -- the layout, in this process ----------------------------------------

@pytest.mark.parametrize("hosts,per_host,batch",
                         [(1, 2, 8), (2, 2, 8), (2, 1, 6), (3, 2, 12),
                          (4, 2, 16), (2, 4, 256)])
def test_host_rows_are_the_jax_process_rows(monkeypatch, hosts, per_host,
                                            batch):
    """``HostLayout.host_rows`` of host h is the JAX package's
    ``process_rows`` of process h of as many processes, and each rank's
    rows lie in its host's."""
    import jax

    from brainmagick_tpu.parallel import process_rows as jax_rows
    from brainmagick_tpu_torch.parallel import HostLayout, process_rows

    nodes = [(h, per_host) for h in range(hosts) for _ in range(per_host)]
    layout = HostLayout.from_ranks(nodes)
    assert layout.size == hosts
    monkeypatch.setattr(jax, "process_count", lambda: hosts)
    for rank in range(hosts * per_host):
        host = layout.host_of(rank)
        assert host == rank // per_host
        monkeypatch.setattr(jax, "process_index", lambda: host)
        rows = layout.host_rows(batch, host)
        assert rows == jax_rows(batch)
        mine = process_rows(batch, rank, hosts * per_host)
        assert rows.start <= mine.start and mine.stop <= rows.stop


@pytest.mark.parametrize("nodes,match", [
    ([(0, 2), (1, 2), (0, 2), (1, 2)], "adjacent"),
    ([(1, 2), (0, 2), (1, 2), (0, 2)], "adjacent"),
    ([(0, -1), (0, -1), (1, -1)], "unequal"),
    ([(0, 3), (0, 3), (1, 3), (1, 3)], "LOCAL_WORLD_SIZE")])
def test_layouts_not_node_by_node_raise(nodes, match):
    from brainmagick_tpu_torch.parallel import HostLayout
    with pytest.raises(ValueError, match=match):
        HostLayout.from_ranks(nodes)


def test_a_batch_that_does_not_divide_over_hosts_raises():
    from brainmagick_tpu_torch.parallel import HostLayout
    layout = HostLayout.from_ranks([(0, 1), (1, 1), (2, 1)])
    with pytest.raises(ValueError, match="divide"):
        layout.host_rows(8, 0)


# -- spawned hosts ----------------------------------------------------------

def _host_main(case: str, rank: int, hosts: int, per_host: int,
               tmp: str) -> None:
    torch.set_num_threads(1)
    world = hosts * per_host
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % per_host),
                      LOCAL_WORLD_SIZE=str(per_host),
                      GROUP_RANK=str(rank // per_host))
    result = (False, "no result")
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world, timeout=RANK_TIMEOUT)
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            data = pickle.load(f)
        result = (True, globals()[case](rank, data))
    except BaseException:  # noqa: BLE001 - sent to the parent
        result = (False, traceback.format_exc())
    with open(os.path.join(tmp, f"result.{rank}.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(tmp, f"result.{rank}.tmp"),
               os.path.join(tmp, f"result.{rank}"))
    if dist.is_initialized() and result[0]:
        dist.destroy_process_group()


def run_hosts(case: str, hosts: int, per_host: int, data: dict,
              tmp: Path) -> list:
    """`case` on `hosts` x `per_host` spawned gloo ranks with a launcher's
    node-by-node environment; each rank's result, or the test fails with
    the first failing rank's traceback."""
    tmp.mkdir()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(data, f)
    world = hosts * per_host
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_host_main,
                         args=(case, r, hosts, per_host, str(tmp)),
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
                        pytest.fail(f"rank {r} of {case}:\n{results[r][1]}")
            if any(not p.is_alive() and p.exitcode for p in procs):
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            proc.join(timeout=5 if len(results) == world else 0)
            if proc.is_alive():
                proc.kill()
                proc.join()
    missing = [r for r in range(world) if r not in results]
    if missing:
        pytest.fail(f"{case}: ranks {missing} gave no result (exit codes "
                    f"{[p.exitcode for p in procs]})")
    return [results[r][1] for r in range(world)]


def _case_layout(rank: int, data: dict) -> dict:
    """The group's hosts, averaged metrics, and ``lead_first`` into each
    host's cache folder (a marker file filled once a host)."""
    from brainmagick_tpu_torch import parallel
    group = parallel.DataGroup()
    metrics = {"b": float(rank), "a": 10. * group.host_index + 0.5}
    averaged = parallel.average_metrics_across_processes(metrics, group)
    alone = parallel.average_metrics_across_processes(metrics, None)
    from brainmagick_tpu_torch.solver import Solver
    refused = None
    try:
        # a resume from per-host XP folders: each host restored its own
        Solver._check_same_restore(types.SimpleNamespace(
            epoch=1 + group.host_index, history=[]), group)
    except RuntimeError as error:
        refused = str(error)
    Solver._check_same_restore(types.SimpleNamespace(epoch=2, history=[{}]),
                               group)
    marker = Path(data["caches"][group.host_index]) / "filled"
    with parallel.lead_first(group):
        found = marker.exists()
        if not found:
            time.sleep(0.5)
            marker.write_text(str(rank))
    return dict(n_hosts=group.n_hosts, host=group.host_index,
                host_size=group.host.size, host_rank=group.host.rank,
                host_rows=group.host_rows(16), rows=group.rows(16),
                averaged=averaged, keys=list(averaged), metrics=metrics,
                alone_is_metrics=alone is metrics, found=found,
                filler=marker.read_text(), refused=refused)


@pytest.mark.parametrize("hosts,per_host", [(2, 2), (1, 4)])
def test_hosts_average_and_fill_their_caches(tmp_path, hosts, per_host):
    """On 2 hosts x 2 ranks each rank knows its host, the host's group and
    rows; ``average_metrics_across_processes`` gives every rank the mean
    over the hosts in float64, keys sorted, and is the identity on one
    host; ``lead_first`` lets each host's first rank fill that host's
    cache, which its other ranks then find filled; ranks that restored
    different epochs (an XP folder that the hosts do not share) are
    refused on every rank."""
    caches = [str(tmp_path / f"cache{h}") for h in range(hosts)]
    for cache in caches:
        os.makedirs(cache)
    results = run_hosts("_case_layout", hosts, per_host,
                        dict(caches=caches), tmp_path / "ranks")
    for rank, got in enumerate(results):
        host = rank // per_host
        assert (got["n_hosts"], got["host"]) == (hosts, host)
        assert (got["host_size"], got["host_rank"]) \
            == (per_host, rank % per_host)
        assert got["host_rows"] == slice(16 // hosts * host,
                                         16 // hosts * (host + 1))
        assert got["found"] == (rank % per_host != 0)
        assert got["filler"] == str(host * per_host)
        assert got["alone_is_metrics"]
        assert (got["refused"] is None) == (hosts == 1)
        if hosts > 1:
            assert "must be one folder" in got["refused"]
        if hosts == 1:
            assert got["averaged"] == got["metrics"]
            continue
        leads = [results[h * per_host]["metrics"] for h in range(hosts)]
        want = {k: float(np.mean(np.array([m[k] for m in leads],
                                          dtype=np.float64)))
                for k in sorted(got["metrics"])}
        assert got["averaged"] == want and got["keys"] == sorted(want)


def _test_stage(solver, mse_solver) -> dict:
    """get_wer (its metrics before the hosts' mean too), load_test_data
    and build_probs, and get_test_metrics of the MSE decoder."""
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import play, wer
    seen = []
    average = wer.average_metrics_across_processes

    def spy(metrics, group):
        seen.append(dict(metrics))
        return average(metrics, group)

    wer.average_metrics_across_processes = spy
    try:
        out = {"wer": wer.get_wer(solver, wer.test_batches(solver))}
    finally:
        wer.average_metrics_across_processes = average
    out["host_wer"] = seen[0]
    data = port_eval.load_test_data(solver)
    out["data"] = {k: data[k] for k in ("preds", "trues", "segment_hashes",
                                        "word_hashes", "subject_id")}
    out["probs"] = port_eval.build_probs(solver, data["preds"],
                                         data["trues"])
    out["metrics"] = play.get_test_metrics(mse_solver)
    out["per_recording"] = play.get_test_metrics(mse_solver, reduce=False)
    return out


def _case_test_stage(rank: int, data: dict) -> dict:
    from brainmagick_tpu_torch import parallel, train
    from brainmagick_tpu_torch.env import env
    with env.temporary(cache=data["cache"]):
        group = parallel.DataGroup()
        solver, mse_solver = (train.get_solver(
            data[key], training=False, group=group)
            for key in ("args", "mse_args"))
        out = _test_stage(solver, mse_solver)
    out["host"] = group.host_index
    return out


class HostRows:
    """A solver seen as one host of `hosts` sees its batches: each batch
    that divides over the ranks cut to the host's block of rows, which
    the solver then forwards alone (no group)."""

    def __init__(self, solver, host: int, hosts: int, world: int) -> None:
        self.solver, self.host, self.hosts, self.world = (solver, host,
                                                          hosts, world)

    def __getattr__(self, name):
        return getattr(self.solver, name)

    def cut(self, batch, pad_weight=None):
        from brainmagick_tpu_torch.dataset import ARRAY_FIELDS
        from brainmagick_tpu_torch.parallel import process_rows
        n = len(batch.meg)
        if n % self.world:
            return batch, pad_weight
        rows = process_rows(n, self.host, self.hosts)
        fields = {name: getattr(batch, name)[rows] for name in ARRAY_FIELDS}
        for name in ("word_hash", "pad_weight"):
            value = getattr(batch, name, None)
            if value is not None:
                fields[name] = value[rows]
        if hasattr(batch, "event_lists"):
            fields["event_lists"] = batch.event_lists[rows]
            fields["study"] = batch.study
        return (types.SimpleNamespace(**fields),
                None if pad_weight is None else pad_weight[rows])

    def make_loader(self, dataset, **kwargs):
        return [self.cut(b, w) for b, w in self.solver.make_loader(
            dataset, **kwargs)]

    def batches(self, batches):
        return [self.cut(b)[0] for b in batches]


@pytest.fixture(scope="module")
def host_stages(tmp_path_factory):
    """The port's tiny solver and its MSE decoder on the fake study: the
    test stage on 2 hosts x 2 spawned ranks, and the one-process
    functions on each host's rows."""
    from brainmagick_tpu_torch import eval as port_eval
    from brainmagick_tpu_torch import play, train, wer
    from brainmagick_tpu_torch.env import env
    tmp = tmp_path_factory.mktemp("stages")
    cache = tmp / "fake_cache"
    cache.mkdir()
    tokens = TINY + ["device=cpu", f"cache={cache}", f"out_dir={tmp}",
                     "simpleconv.merger_dropout=0.0"]
    args = train.parse_overrides(tokens)
    mse_args = train.parse_overrides(tokens + ["optim.loss=mse"])
    alone = {}
    with env.temporary(cache=cache):
        solver, mse_solver = (train.get_solver(a, training=False)
                              for a in (args, mse_args))
        for host in range(2):
            view = HostRows(solver, host, 2, 4)
            mse_view = HostRows(mse_solver, host, 2, 4)
            out = {"wer": wer.get_wer(solver, view.batches(
                wer.test_batches(solver)))}
            data = port_eval.load_test_data(
                solver, view.batches(port_eval.solver_batches(solver)))
            out["data"] = data
            out["probs"] = port_eval.build_probs(solver, data["preds"],
                                                 data["trues"])
            out["metrics"] = play.get_test_metrics(mse_view)
            out["per_recording"] = play.get_test_metrics(mse_view,
                                                         reduce=False)
            alone[host] = out
    ranks = run_hosts("_case_test_stage", 2, 2,
                      dict(args=args, mse_args=mse_args, cache=cache),
                      tmp / "ranks")
    return alone, ranks


def test_each_host_scores_its_own_rows(host_stages):
    """Each host's WER, evaluation (predictions, candidates, metadata and
    probabilities) and per-recording streaming metrics are the port's
    one-process functions on that host's rows of every batch; the hosts
    differ."""
    alone, ranks = host_stages
    for got in ranks:
        want = alone[got["host"]]
        for key, value in want["wer"].items():
            np.testing.assert_allclose(got["host_wer"][key], value, rtol=0,
                                       atol=METRIC_ATOL, err_msg=key)
        for key, value in got["data"].items():
            np.testing.assert_allclose(value, want["data"][key], rtol=0,
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-5,
                                   atol=1e-6)
        assert set(got["per_recording"]) == set(want["per_recording"])
        for key, value in want["per_recording"].items():
            np.testing.assert_allclose(got["per_recording"][key], value,
                                       rtol=1e-5, atol=METRIC_ATOL,
                                       err_msg=key)
    assert len(alone[0]["data"]["preds"]) > 0
    assert len(alone[1]["data"]["preds"]) > 0
    assert not np.array_equal(alone[0]["data"]["segment_hashes"],
                              alone[1]["data"]["segment_hashes"])


def test_reported_metrics_are_the_hosts_mean(host_stages):
    """Every rank reports the mean over the two hosts of the WER and of
    each reduced streaming metric (``average_metrics_across_processes``),
    as the JAX package's processes do."""
    alone, ranks = host_stages
    for got in ranks:
        for key in alone[0]["wer"]:
            want = np.mean([alone[h]["wer"][key] for h in range(2)])
            np.testing.assert_allclose(got["wer"][key], want, rtol=0,
                                       atol=METRIC_ATOL, err_msg=key)
        assert set(got["metrics"]) == set(alone[0]["metrics"])
        for key in alone[0]["metrics"]:
            want = np.mean([alone[h]["metrics"][key] for h in range(2)])
            np.testing.assert_allclose(got["metrics"][key], want,
                                       rtol=1e-5, atol=METRIC_ATOL,
                                       err_msg=key)
    for other in ranks[1:]:
        assert other["wer"] == ranks[0]["wer"]
