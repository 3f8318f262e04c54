"""The yardstick's arithmetic at known shapes: the FLOPs that
``FlopCounterMode`` counts over the reference against a count by hand,
and the rooflines' bytes and operations against the paper shapes'."""

from __future__ import annotations

import json
import types

import pytest

from benchmark.harness import peaks, spec
from benchmark.reference import model as ref
from conftest import REPO, TINY_MODEL


def _unit_flops(loop: str, m: dict, rows: int, candidates: int = 0) -> int:
    """The loop's FLOPs of one unit, for the model section `m`."""
    c = types.SimpleNamespace(
        config={"model": dict(m, batch_size=rows)},
        traffic={"rows": rows, "candidates": candidates},
        reference=spec.module("reference", "model"))
    return spec.module("loops", loop).unit_flops(c)


def _model(name: str, **widths) -> dict:
    config = json.loads((REPO / "benchmark" / "configs"
                         / f"{name}.json").read_text())
    m = config["model"]
    m.update(widths)
    return m


def _conv(b, cout, cin, k, t):
    return 2 * b * cout * cin * k * t


def _forward(m: dict, b: int) -> tuple:
    """(FLOPs of the forward's contractions, of those whose first operand
    carries no gradient in training: the merger's scores and mix, and
    DeepMel's first conv)."""
    t = m["window_samples"] - m["offset_samples"]
    c, o, i, h = (m["sensors"], m["merger_channels"], m["initial_linear"],
                  m["hidden"])
    out = m["deep_mel"]["out"] if m.get("deep_mel") else m["features"]
    no_input_grad = (2 * m["recordings"] * c * m["merger_pos_dim"] * o
                     + 2 * b * o * c * t)
    total = no_input_grad + _conv(b, i, o, 1, t) + 2 * b * i * i * t
    chans = ref.encoder_channels(m)
    for k, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        total += _conv(b, cout, cin, m["kernel"], t)
        if (k + 1) % m["glu"] == 0:
            total += _conv(b, 2 * cout, cout, 3, t)
    total += _conv(b, 2 * h, h, 1, t) + _conv(b, out, 2 * h, 1, t)
    if m.get("deep_mel"):
        chans = ref.deepmel_channels(m)
        first = _conv(b, chans[1], chans[0], 3, t)
        no_input_grad += first
        total += first
        for k, (cin, cout) in enumerate(zip(chans[1:-1], chans[2:]), 1):
            total += _conv(b, cout, cin, 3, t)
        for k, cout in enumerate(chans[1:]):
            if (k + 1) % 2 == 0:
                total += _conv(b, 2 * cout, cout, 3, t)
    return total, no_input_grad


@pytest.mark.parametrize("name", ["simpleconv_recipe", "deepmel_fp32"])
def test_train_flops_by_hand(name):
    m = _model(name, **TINY_MODEL)
    b = m["batch_size"]
    if m.get("deep_mel"):
        m.update(features=10, deep_mel={"hidden": 16, "layers": 4, "out": 20})
    fwd, one_grad = _forward(m, b)
    t = m["window_samples"] - m["offset_samples"]
    out = m["deep_mel"]["out"] if m.get("deep_mel") else m["features"]
    scores = 2 * b * b * out * t
    # the targets carry a gradient only through DeepMel
    want = 3 * fwd - one_grad + (3 if m.get("deep_mel") else 2) * scores
    assert _unit_flops("train", m, b) == want


def test_retrieval_flops_by_hand():
    m = _model("simpleconv_recipe")
    fwd, _ = _forward(m, 256)
    k = m["features"] * (m["window_samples"] - m["offset_samples"])
    assert _unit_flops("retrieval", m, 256, 2048) == \
        fwd + 2 * 256 * 2048 * k
    # the paper shapes: about 1.25 TFLOP of forward, 0.37 of scores
    assert 1.2e12 < fwd < 1.3e12


def test_normalize_roofline_bytes():
    reader = spec.reader("normalize_clamp_peak_roofline.train")
    n = reader.call_bytes(256, 273, 361, 27, 2)
    assert n == 256 * 273 * 361 * 6 + 2 * 27 * 273 * 4 + 256 * 12
    # 0.0452 ms for the recipe's bf16 wire, 0.0603 for fp32's
    assert n / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0452, abs=1e-4)
    n32 = reader.call_bytes(256, 273, 361, 27, 4)
    assert n32 / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0603,
                                                             abs=1e-4)


def test_nt_matmul_roofline_bound():
    reader = spec.reader("nt_matmul_roofline.retrieval")
    least, by = reader.least_seconds(256, 2048, 351_232, "bfloat16")
    assert by == "bytes" and least * 1e3 == pytest.approx(0.484, abs=1e-3)
    least, by = reader.least_seconds(2048, 2048, 351_232, "bfloat16")
    assert by == "operations" and least * 1e3 == pytest.approx(2.979,
                                                              abs=1e-3)
    least, by = reader.least_seconds(256, 2048, 351_232, "float32")
    assert by == "operations" and least * 1e3 == pytest.approx(2.232,
                                                              abs=1e-3)


@pytest.mark.parametrize("workload", ["simpleconv_recipe.train",
                                      "simpleconv_recipe.retrieval"])
def test_mfu_reads_the_window_s_flops(workload):
    """``mfu``: without ``Record.flops`` one unit's FLOPs at the cell's
    shapes times the units, as before the loops could sum them; with it,
    the units' own sum (requests of different lengths)."""
    from benchmark.harness import cell
    from benchmark.harness import trace as tracing

    c = spec.load_cell(REPO, workload)
    window = tracing.Trace(0, 2_500_000_000, [], [])
    peak = peaks.FLOPS[c.config["peak"]]
    rec = cell.Record(c, window, 7, 256, {}, {}, {})
    assert rec.flops is None and rec.shapes is None
    per_unit = c.loop.unit_flops(c)
    reader = spec.reader(f"mfu.{workload.split('.')[1]}")
    assert reader.read(rec) == 100 * per_unit * 7 / 2.5 / peak
    shapes = [{"frames": t} for t in (1500, 4000, 9000)]
    flops = [3 * 10 ** 12, 9 * 10 ** 12, 14 * 10 ** 12]
    rec = cell.Record(c, window, 3, 1, {}, {}, {}, sum(flops), shapes)
    assert reader.read(rec) == pytest.approx(100 * 26e12 / 2.5 / peak,
                                             rel=1e-15)
    assert reader.read(cell.Record(c, window, 0, 1, {}, {}, {})) is None
