"""The port's spans and counters (``brainmagick_tpu_torch.tracing``): off
without a profiler; under a CPU ``torch.profiler`` the train step's and a
request's ``bm.*`` ranges, nested as the layers are and on the clock of
the profiler's other events; none in an exported graph; the counters
beside the kernels' launches in ``ops.launch_counts()``; and the
benchmark's readers of them on a hand-built trace."""

import re
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from brainmagick_tpu_torch import config, ops, serve, solver, tracing
from brainmagick_tpu_torch.train import Trainer

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import cell, spec  # noqa: E402
from benchmark.harness import trace as bench_trace  # noqa: E402

C, F, T, B = 6, 3, 40, 2
TRAIN_SPANS = ("forward", "loss", "backward", "optimizer")
SCORING_SPANS = ("inv_norms", "nt_matmul", "softmax")


@pytest.fixture(autouse=True)
def _fresh_counters():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _setup():
    args = config.apply_preset(config.MainConfig(), "clip_conv")
    args.simpleconv.update(hidden=8, depth=1, merger_channels=4,
                           merger_pos_dim=8, initial_linear=4)
    rng = np.random.RandomState(0)
    na = dict(meg_center=rng.randn(2, C).astype(np.float32),
              meg_scale=np.ones((2, C), np.float32),
              feat_center=np.zeros(F, np.float32),
              feat_scale=np.ones(F, np.float32),
              rec_positions=rng.rand(2, C, 2).astype(np.float32))
    batch = types.SimpleNamespace(
        meg=rng.randn(B, C, T).astype(np.float32),
        features=rng.randn(B, F, T).astype(np.float32),
        features_mask=np.ones((B, 1, T), bool),
        subject_index=np.zeros(B, np.int32),
        recording_index=np.arange(B, dtype=np.int32),
        positions=na["rec_positions"][np.arange(B)])
    return args, na, batch


def _traced(fn):
    """`fn()` inside ``record_function("bench.window")`` under a CPU
    profiler -> (its result, the window's ``Trace``, the host clock's
    ns before and after)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(bench_trace.WINDOW):
            t0 = time.time_ns()
            out = fn()
            t1 = time.time_ns()
    return out, bench_trace.reduce(prof), (t0, t1)


def _spans(trace):
    """{name: [(start, end)]} of the trace's ``bm.*`` ranges."""
    out = {}
    for lo, hi, name in trace.host:
        if name.startswith(tracing.PREFIX):
            out.setdefault(name[len(tracing.PREFIX):], []).append((lo, hi))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_is_off_without_a_profiler(monkeypatch):
    """No profiler: a span enters no ``record_function``, records no CUDA
    event and leaves no counter, as a context manager, as a decorator and
    through a whole train step."""
    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler running")
    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()

    @tracing.span("decorated")
    def double(x):
        return 2 * x
    with tracing.span("plain"):
        assert double(3) == 6
    args, na, batch = _setup()
    trainer = Trainer(args, C, F, 1, None, None, na, "cpu",
                      generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(trainer.step(batch)["loss"])
    assert tracing.counters() == {}
    assert not tracing._pending and not tracing._open.spans


def test_train_step_spans_nest_in_order():
    """``Solver.step`` under a CPU profiler: ``bm.step`` holds
    ``bm.forward``, ``bm.loss``, ``bm.backward`` and ``bm.optimizer``, one
    each, in that order, all inside the window's range."""
    args, na, batch = _setup()
    trainer = Trainer(args, C, F, 1, None, None, na, "cpu",
                      generator=torch.Generator().manual_seed(0))
    trainer.step(batch)
    _, trace, _ = _traced(lambda: trainer.step(batch))
    spans = _spans(trace)
    assert sorted(spans) == sorted(("step",) + TRAIN_SPANS)
    assert all(len(v) == 1 for v in spans.values())
    step = spans["step"][0]
    assert _inside(step, (trace.start, trace.end))
    parts = [spans[name][0] for name in TRAIN_SPANS]
    assert all(_inside(p, step) for p in parts)
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
    # no CUDA on this host: no device time, no event left pending
    assert not any(k.startswith("device_us.") for k in tracing.counters())
    assert not tracing._pending


def test_request_spans_and_the_profilers_clock():
    """``Server.forward_batch`` gives ``bm.forward`` and
    ``Server.probabilities`` ``bm.scoring``, which holds ``bm.inv_norms``,
    ``bm.nt_matmul`` and ``bm.softmax`` in that order; each span brackets
    the aten ops it runs, and the spans are stamped on the clock the
    host's ``time.time_ns()`` reads (the profiler's, which stamps the
    device's activities on a card too)."""
    args, na, batch = _setup()
    server = serve.Server(args, C, F, 1, None, None, na, "cpu")
    estimate = server.forward_batch(batch)[0]
    bank = torch.randn(5, *estimate.shape[1:])

    def request():
        est = server.forward_batch(batch)[0]
        return server.probabilities(est, bank)
    probs, trace, (t0, t1) = _traced(request)
    assert probs.shape == (B, 5)
    spans = _spans(trace)
    assert sorted(spans) == sorted(("forward", "scoring") + SCORING_SPANS)
    scoring = spans["scoring"][0]
    parts = [spans[name][0] for name in SCORING_SPANS]
    assert all(_inside(p, scoring) for p in parts)
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
    assert spans["forward"][0][1] <= scoring[0]
    for name, op in (("softmax", "aten::softmax"),
                     ("nt_matmul", "aten::mul"),
                     ("inv_norms", "aten::sum"),
                     ("forward", "aten::conv1d")):
        found = [(lo, hi) for lo, hi, n in trace.host if n == op
                 and _inside((lo, hi), spans[name][0])]
        assert found, (name, op)
    # Unix-epoch ns, as time.time_ns(): the window read between them
    # (within the profiler's own 10 ms of rounding and set-up)
    assert t0 - 10 ** 7 <= trace.start <= trace.end <= t1 + 10 ** 7
    assert _inside(spans["forward"][0], (trace.start, trace.end))


def test_exported_graphs_hold_no_profiler_op(monkeypatch):
    """``export_forward`` and ``export_scores`` traced while a profiler
    runs: no span opens while torch traces, and their graphs call no
    profiler op."""
    args, na, batch = _setup()
    server = serve.Server(args, C, F, 1, None, None, na, "cpu")
    opened = []

    def recording(label):
        opened.append(label)
        return record_function(label)
    monkeypatch.setattr(tracing, "record_function", recording)
    with profile(activities=[ProfilerActivity.CPU]):
        graphs = [serve.export_forward(server.solver, example=batch)]
        assert opened == []
        graphs.append(serve.export_scores(server.solver, example=batch))
        # the eager forward it runs for the estimate's dtype is no trace
        assert opened == ["bm.forward"]
    for exported in graphs:
        targets = [str(node.target) for node in exported.graph.nodes
                   if node.op == "call_function"]
        assert targets
        assert not [t for t in targets if "profiler" in t
                    or "record_function" in t], targets


def test_launch_counts_keep_the_kernels_and_add_the_counters():
    kernels = {k.__name__ for k in ops.KERNELS}
    assert ops.launch_counts() == dict.fromkeys(kernels, 0)
    tracing.count("h2d.bytes", 1024)
    tracing.count("h2d.copies")
    tracing.count("h2d.copies")
    list(solver._waited(iter(range(3))))
    counts = ops.launch_counts()
    assert {k for k in counts if "." not in k} == kernels
    assert counts["h2d.bytes"] == 1024 and counts["h2d.copies"] == 2
    assert counts["loader.wait_us"] >= 0
    ops.nt_matmul.launches += 1
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(kernels, 0)


def test_cpu_transfer_counts_no_copy_to_the_card():
    from brainmagick_tpu_torch.utils import transfer
    out = transfer(np.ones((2, 3), np.float32), torch.device("cpu"),
                   torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert tracing.counters() == {}


# -- the benchmark's readers of the spans and counters -----------------------

def _record(workload, host, launches, units=2):
    """A `Record` of `workload` over a hand-built window [0, 1000] ns."""
    c = spec.load_cell(REPO, workload)
    trace = bench_trace.Trace(0, 1000, [], sorted(host))
    return cell.Record(c, trace, units, 4, {}, {}, launches)


#: two train steps; the second's backward launches from autograd's thread
#: (a launch that lies in no op of the main thread), the harness's own
#: synchronize after the window's last step, outside every span
TRAIN_HOST = [
    (0, 1000, "bench.window"),
    (10, 410, "bench.step"), (20, 400, "bm.step"),
    (30, 130, "bm.forward"), (40, 50, "aten::conv1d"),
    (41, 43, "cudaLaunchKernel"), (60, 61, "cuLaunchKernel"),
    (140, 170, "bm.loss"), (150, 152, "cudaLaunchKernelExC"),
    (180, 330, "bm.backward"), (200, 202, "cudaLaunchKernel"),
    (210, 215, "cudaStreamSynchronize"),
    (340, 390, "bm.optimizer"), (350, 351, "cudaLaunchKernel"),
    (450, 850, "bench.step"), (460, 840, "bm.step"),
    (470, 570, "bm.forward"), (575, 605, "bm.loss"),
    (610, 760, "bm.backward"),
    (620, 622, "cudaLaunchKernel"), (625, 627, "cuLaunchKernelEx"),
    (780, 830, "bm.optimizer"), (790, 800, "cudaMemcpy"),
    (795, 796, "cudaMemcpyAsync"),
    (860, 862, "cudaLaunchKernel"), (900, 950, "cudaDeviceSynchronize"),
]
TRAIN_COUNTERS = {"nt_matmul": 0, "device_us.forward": 3000.,
                  "device_us.backward": 9000., "device_us.step": 14000.}
#: two requests: forward, then scoring with its parts; each request's
#: closing synchronize is the harness's
RETRIEVAL_HOST = [
    (0, 1000, "bench.window"),
    (10, 60, "bm.forward"), (20, 22, "cudaLaunchKernel"),
    (70, 170, "bm.scoring"), (80, 100, "bm.inv_norms"),
    (85, 86, "cudaLaunchKernel"), (110, 140, "bm.nt_matmul"),
    (115, 116, "cuLaunchKernel"), (150, 160, "bm.softmax"),
    (180, 300, "cudaDeviceSynchronize"),
    (400, 500, "bm.forward"), (420, 421, "cudaLaunchKernel"),
    (510, 570, "bm.scoring"), (520, 521, "cudaLaunchKernel"),
    (600, 700, "cudaDeviceSynchronize"),
]
RETRIEVAL_COUNTERS = {"device_us.forward": 30000., "device_us.scoring":
                      11000., "device_us.inv_norms": 8000.}


@pytest.mark.parametrize("metric, want", [
    # ns to ms: (380 + 380) / 2 steps
    ("step_host_ms.train", 380 / 1e6),
    ("forward_host_ms.train", 100 / 1e6),
    ("backward_host_ms.train", 150 / 1e6),
    ("optimizer_host_ms.train", 50 / 1e6),
    ("forward_device_ms.train", 1.5),
    ("backward_device_ms.train", 4.5),
    # 5 in step 1, 2 in step 2 (from autograd's thread)
    ("launches.train", 7 / 2),
    ("host_syncs.train", 2 / 2),
    ("forward_host_ms.retrieval", (50 + 100) / 2 / 1e6),
    ("scoring_host_ms.retrieval", (100 + 60) / 2 / 1e6),
    ("forward_device_ms.retrieval", 15.),
    ("scoring_device_ms.retrieval", 5.5),
    ("inv_norms_device_ms.retrieval", 4.),
    ("launches.retrieval", 5 / 2),
    ("host_syncs.retrieval", 0.),
])
def test_span_readers_on_a_hand_built_trace(metric, want):
    """Each new reader's value by hand; without the program's spans and
    counters (a program that has none) each reads None, not zero."""
    train = metric.endswith(".train")
    workload = ("simpleconv_recipe.train" if train
                else "simpleconv_recipe.retrieval")
    host = TRAIN_HOST if train else RETRIEVAL_HOST
    counters = TRAIN_COUNTERS if train else RETRIEVAL_COUNTERS
    names = [m["name"] for m in spec.load_cell(REPO, workload).per_layer]
    assert metric in names
    reader = spec.reader(metric)
    assert reader.read(_record(workload, host, counters)) \
        == pytest.approx(want, rel=1e-12, abs=1e-15)
    bare = [h for h in host if not h[2].startswith("bm.")]
    assert reader.read(_record(workload, bare, {"nt_matmul": 0})) is None


def test_epoch_log_reads_the_counters(caplog):
    """``Solver.train``'s epoch line ends with the epoch's loader wait and
    its bytes to the card, from the counters' change over the epoch."""
    import logging

    class Stub(solver.Solver):
        def __init__(self):
            self.args = types.SimpleNamespace(
                optim=types.SimpleNamespace(epochs=1),
                early_stop_patience=0, eval_every=1)
            self.history, self.stage_seconds = [], []
            self.epoch, self.best_epoch, self.last_test_epoch = 1, 0, 0
            self.best_loss = 1.
            self._seen = self._rejected = 0
            self.metric_sinks = types.SimpleNamespace(log=lambda *a: None)
            self.group, self.folder = None, None

        def _run_one_epoch(self, training):
            tracing.count("loader.wait_us", 2.5e6 if training else 0.5e6)
            tracing.count("h2d.bytes", 1.5e9)
            return {"loss": 1.}

        def commit(self):
            pass

        @property
        def lead(self):
            return False
    tracing.count("loader.wait_us", 9e6)
    with caplog.at_level(logging.INFO, logger=solver.logger.name):
        Stub().train()
    line, = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Epoch 1 |")]
    assert re.search(r"\| loader wait 3\.0s \| h2d 3\.000 GB$", line), line
