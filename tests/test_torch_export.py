"""The port's serving export (``brainmagick_tpu_torch.serve``) against the
JAX package: one ``torch.export`` artifact of a tiny solver's forward at
two batch sizes against the port's Solver.forward_batch and the JAX
solver's, the scorer artifact at two (rows, candidates) shapes against
the JAX ClipLoss (the fast route through nt_matmul, and clip.linear's
projection), the CLI, the registered ops' fake shapes under a symbolic
batch, and a fresh process that serves an artifact without the port's
model code."""

import copy
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args
from test_torch_epochs import TINY

from brainmagick_tpu import train as bm_train
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu_torch import (convert, dataset, losses, ops, play,
                                   serve, train)
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.ops import matmul, norm
from brainmagick_tpu_torch.solver import Solver, build_clip_loss

REPO = Path(__file__).resolve().parent.parent
#: the artifact's forward against the port's eager forward (the same ops)
PORT_TOL = dict(rtol=1e-6, atol=1e-6)
#: against the JAX solver (tests/test_torch_serve.py's)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
#: the scorer against the JAX ClipLoss (the JAX CLI's self-check)
PROBS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def jax_solver(tmp_path_factory):
    """An untrained tiny_args JAX solver whose BatchNorm running stats are
    seeded values (so BatchNorm is not the identity)."""
    tmp = tmp_path_factory.mktemp("export")
    cache = tmp / "fake_cache"
    cache.mkdir()
    with jenv.temporary(cache=cache):
        solver = bm_train.get_solver(tiny_args(cache, tmp), training=False)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        if path[-1].key == "mean":
            return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(
        draw, jax.device_get(solver.state["batch_stats"]))
    solver.state = {**solver.state, "batch_stats": jax.device_put(stats)}
    return solver


@pytest.fixture(scope="module")
def server(jax_solver):
    return serve.Server(
        jax_solver.args, jax_solver.model.in_channels["meg"],
        jax_solver.model.out_channels, jax_solver.model.n_subjects,
        jax.device_get(jax_solver.state["params"]),
        jax.device_get(jax_solver.state["batch_stats"]),
        {k: np.asarray(v) for k, v in jax_solver.norm_arrays.items()},
        device="cpu")


@pytest.fixture(scope="module")
def batch(jax_solver):
    """Items of both training recordings (both subjects)."""
    items = [d[i] for d in jax_solver.datasets.train.datasets
             for i in range(3)]
    return SegmentBatch.collate(items)


def _rows(batch, n):
    """`n` rows of `batch`, cycled, as a namespace of numpy arrays."""
    index = np.arange(n) % len(batch.meg)
    return types.SimpleNamespace(**{
        name: np.asarray(getattr(batch, name))[index]
        for name in serve.ARG_FIELDS})


def test_arg_fields_are_the_datasets():
    assert serve.ARG_FIELDS == dataset.ARRAY_FIELDS


def test_exported_forward_matches_solver_and_jax(tmp_path, server, batch,
                                                 jax_solver):
    """One artifact (symbolic batch, saved and reloaded) at batches 2 and
    5: within PORT_TOL of the port's Solver.forward_batch and within
    JAX_TOL of the JAX solver's forward; it keeps the normalize op."""
    exported = serve.export_forward(server.solver, example=batch)
    targets = {node.target for node in exported.graph.nodes}
    assert torch.ops.brainmagick.normalize_clamp_peak.default in targets
    path = serve.save_exported(exported, tmp_path / "model.pt2")
    module = serve.load_exported(path).module()
    for n in (2, 5):
        rows = _rows(batch, n)
        got = serve.call_exported(module, rows)
        port = server.solver.forward_batch(rows)
        want = jax_solver.forward_batch(SegmentBatch(**vars(rows)))
        assert got[0].shape[0] == n
        for name, g, p, w in zip(("estimate", "output"), got, port, want):
            np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name,
                                       **PORT_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, **JAX_TOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _linear_solver(server, jax_solver, width, length):
    """The server's model under a CLIP loss with clip.linear=`width`, its
    projection's weights seeded numpy draws in the flax tree's shapes;
    returns (the port solver, the flax ClipLoss, its params)."""
    args = copy.deepcopy(jax_solver.args)
    args.clip.linear = width
    jclip = jax_solver.clip_loss.clone(linear=width)
    e = jnp.zeros((2, server.model.out_channels, length))
    shapes = jax.eval_shape(
        lambda key: jclip.init(key, e, e, method=jclip.get_scores),
        jax.random.PRNGKey(0))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.2).astype(np.float32), shapes)
    clip = build_clip_loss(args, "cpu", length)
    convert.load_by_rules(clip, convert.clip_loss_rules(clip),
                          {"loss": params}, {})
    solver = Solver(args, server.model, server.solver.norm_arrays,
                    clip_loss=clip)
    return solver, jclip, params


@pytest.mark.parametrize("route", ["fast", "linear"])
def test_exported_scorer_matches_jax(server, batch, jax_solver, route):
    """The scorer artifact (both dimensions symbolic) at (rows,
    candidates) (2, 5) and (3, 7) on seeded estimates and candidates,
    against the JAX ClipLoss's get_probabilities: the fast route keeps
    nt_matmul; clip.linear scores through ClipLoss.get_scores."""
    est, out, _, _ = server.solver.forward_batch(_rows(batch, 2))
    features, length = est.shape[1:]
    if route == "fast":
        solver, jclip = server.solver, jax_solver.clip_loss
        params = jax.device_get(jax_solver.state["params"])["loss"]
        assert losses.int8_retrieval_ok(solver.clip_loss)
    else:
        solver, jclip, params = _linear_solver(server, jax_solver, 8, length)
    exported = serve.export_scores(solver, example=batch)
    targets = {node.target for node in exported.graph.nodes}
    for op in (torch.ops.brainmagick.nt_matmul.default,
               torch.ops.brainmagick.inv_norms.default):
        assert (op in targets) == (route == "fast")
    rng = np.random.RandomState(5)
    for rows, n in ((2, 5), (3, 7)):
        e = rng.randn(rows, features, length).astype(np.float32)
        c = rng.randn(n, features, length).astype(np.float32)
        got = serve.call_exported(exported, e, c)
        want = jclip.apply({"params": params}, jnp.asarray(e),
                           jnp.asarray(c), method=jclip.get_probabilities)
        assert got.shape == (rows, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **PROBS_TOL)


def test_custom_ops_fake_shapes_under_a_symbolic_batch():
    """Exported with Dim("b"), Dim("m"), Dim("n"), the two registered ops
    keep their places in the graph with symbolic output shapes in fp32,
    and the artifact equals the wrappers at other sizes; under a
    FakeTensorMode the wrappers give the shapes and types."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Ops(torch.nn.Module):
        def forward(self, meg, center, scale, rec, a, b):
            out, peak = norm.normalize_clamp_peak(meg, center, scale, 2.5,
                                                  rec=rec)
            return out, peak, matmul.nt_matmul(a, b)

    rng = np.random.RandomState(0)

    def inputs(b, m, n):
        return (torch.from_numpy(rng.randn(b, 5, 7).astype(np.float32) * 3),
                torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
                torch.from_numpy(rng.uniform(1, 2, (3, 5)).astype(
                    np.float32)),
                torch.from_numpy(rng.randint(0, 3, b)),
                torch.from_numpy(rng.randn(m, 9).astype(np.float32)),
                torch.from_numpy(rng.randn(n, 9).astype(np.float32)))

    dims = {name: torch.export.Dim(name, min=1) for name in "bmn"}
    exported = torch.export.export(
        Ops(), inputs(2, 3, 4), strict=False,
        dynamic_shapes=({0: dims["b"]}, None, None, {0: dims["b"]},
                        {0: dims["m"]}, {0: dims["n"]}))
    ops = {node.target: node.meta["val"] for node in exported.graph.nodes
           if node.op == "call_function" and "brainmagick" in str(node.target)}
    out, peak = ops[torch.ops.brainmagick.normalize_clamp_peak.default]
    scores = ops[torch.ops.brainmagick.nt_matmul.default]
    assert isinstance(out.shape[0], torch.SymInt) and out.shape[1:] == (5, 7)
    assert peak.shape[0] is out.shape[0] or str(peak.shape[0]) == str(
        out.shape[0])
    assert all(isinstance(d, torch.SymInt) for d in scores.shape)
    assert {out.dtype, peak.dtype, scores.dtype} == {torch.float32}
    for sizes in ((1, 1, 6), (4, 3, 2)):
        args = inputs(*sizes)
        got = exported.module()(*args)
        want = Ops()(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(t) for t in inputs(6, 2, 3)]
        out, peak, scores = Ops()(fakes[0].to(torch.bfloat16), *fakes[1:])
    assert (out.shape, peak.shape, scores.shape) == ((6, 5, 7), (6,), (2, 3))
    assert {out.dtype, peak.dtype, scores.dtype} == {torch.float32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_inv_norms_fake_shape_under_a_symbolic_batch(dtype):
    """The inv_norms op keeps its place in a graph exported with Dim("n")
    with a symbolic [n] fp32 output, the artifact equals the wrapper at
    other sizes, and under a FakeTensorMode the wrapper gives [N] fp32."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Norms(torch.nn.Module):
        def forward(self, block):
            return ops.inv_norms(block)

    rng = np.random.RandomState(1)

    def block(n):
        return torch.from_numpy(rng.randn(n, 5, 7).astype(np.float32) * 9
                                ).to(dtype)

    exported = torch.export.export(
        Norms(), (block(3),), strict=False,
        dynamic_shapes=({0: torch.export.Dim("n", min=1)},))
    found = [node.meta["val"] for node in exported.graph.nodes
             if node.target == torch.ops.brainmagick.inv_norms.default]
    assert len(found) == 1
    assert isinstance(found[0].shape[0], torch.SymInt)
    assert found[0].dtype == torch.float32
    for n in (1, 4):
        x = block(n)
        torch.testing.assert_close(exported.module()(x), Norms()(x), rtol=0,
                                   atol=0)
    with FakeTensorMode() as mode:
        got = ops.inv_norms(mode.from_tensor(block(6)))
    assert got.shape == (6,) and got.dtype == torch.float32


@pytest.fixture(scope="module")
def port_xp(tmp_path_factory):
    """One tiny XP trained by the port's CLI on the CPU (one batch)."""
    tmp = tmp_path_factory.mktemp("export_cli")
    tokens = [*TINY, "optim.epochs=1", "optim.max_batches=1",
              f"cache={tmp / 'fake_cache'}", f"out_dir={tmp / 'outputs'}"]
    (tmp / "fake_cache").mkdir()
    train.main(tokens + ["device=cpu"])
    return dict(sig=train.parse_overrides(tokens).sig,
                out_dir=str(tmp / "outputs"), cache=str(tmp / "fake_cache"))


def test_cli_writes_reloads_and_selfchecks(tmp_path, port_xp):
    """``serve.main`` writes the forward and the scorer beside the XP's
    checkpoint (symbolic batch; its self-check at B=2 and 5 passes), and
    with out=, batch_size= and scores=false one static artifact; it
    refuses platforms= and, without a CUDA device, device=cuda."""
    common = [f"sig={port_xp['sig']}", f"out_dir={port_xp['out_dir']}",
              "device=cpu", "compilation_cache=false"]
    with env.temporary(cache=port_xp["cache"]):
        result = serve.main(common)
        folder = Path(port_xp["out_dir"]) / "xps" / port_xp["sig"]
        assert result["forward"] == folder / "model-torch.pt2"
        assert result["scores"] == folder / "model-torch_scores.pt2"
        assert result["forward"].exists() and result["scores"].exists()
        assert set(result["seconds"]) == {"export", "export_scores", "load"}
        static = serve.main(common + [f"out={tmp_path / 'b3.pt2'}",
                                      "batch_size=3", "scores=false"])
        assert static["scores"] is None
        assert not (tmp_path / "b3_scores.pt2").exists()
        solver = play.get_solver_from_sig(
            port_xp["sig"], out_dir=port_xp["out_dir"],
            override_args={"device": "cpu"})
    module = serve.load_exported(static["forward"]).module()
    got = serve.call_exported(module, serve.example_batch(solver, 3))
    want = solver.forward_batch(serve.example_batch(solver, 3))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    with pytest.raises(Exception):
        serve.call_exported(module, serve.example_batch(solver, 2))
    with pytest.raises(ValueError, match="device="):
        serve.main(common + ["platforms=tpu,cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            serve.main([f"sig={port_xp['sig']}",
                        f"out_dir={port_xp['out_dir']}"])
    assert serve.main([]) is None


#: a fresh process: load the artifacts, call them on the batch file, and
#: report which of the port's modules it imported
SERVING_HOST = """
import json, sys, types
import numpy as np
from brainmagick_tpu_torch import serve
forward, scores, batch_path, out_path = sys.argv[1:]
data = np.load(batch_path)
batch = types.SimpleNamespace(**{k: data[k] for k in data.files})
est, out, mask, keep = serve.call_exported(serve.load_exported(forward),
                                           batch)
probs = serve.call_exported(serve.load_exported(scores), est, out)
np.savez(out_path, estimate=est.numpy(), probs=probs.numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("brainmagick_tpu"))))
"""


def test_fresh_process_serves_without_model_code(tmp_path, port_xp):
    """A fresh process loads and calls the CLI's artifacts with neither
    ``brainmagick_tpu_torch.models`` nor ``.solver`` (nor the JAX
    package) imported, and gets the solver's estimate and
    probabilities."""
    with env.temporary(cache=port_xp["cache"]):
        result = serve.main([f"sig={port_xp['sig']}",
                             f"out_dir={port_xp['out_dir']}", "device=cpu",
                             "selfcheck=false"])
        solver = play.get_solver_from_sig(
            port_xp["sig"], out_dir=port_xp["out_dir"],
            override_args={"device": "cpu"})
    batch = serve.example_batch(solver, 4)
    np.savez(tmp_path / "batch.npz", **{
        name: np.asarray(getattr(batch, name)) for name in serve.ARG_FIELDS})
    proc = subprocess.run(
        [sys.executable, "-c", SERVING_HOST, str(result["forward"]),
         str(result["scores"]), str(tmp_path / "batch.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imported = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "brainmagick_tpu_torch.serve" in imported
    assert not [m for m in imported if m.startswith(
        ("brainmagick_tpu_torch.models", "brainmagick_tpu_torch.solver",
         "brainmagick_tpu."))], imported
    got = np.load(tmp_path / "out.npz")
    est, out, _, _ = solver.forward_batch(batch)
    probs = serve.Server.probabilities(
        types.SimpleNamespace(clip=solver.clip_loss, device=solver.device),
        est, out)
    np.testing.assert_allclose(got["estimate"], est.numpy(), **PORT_TOL)
    np.testing.assert_allclose(got["probs"], probs.numpy(), **PROBS_TOL)
