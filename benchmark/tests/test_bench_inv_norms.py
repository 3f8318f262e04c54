"""The ``inv_norms_roofline`` reader: its least time by hand, and nothing
to read where the program launched no such kernel (the port before the
kernel)."""

import types

import pytest

from benchmark.harness import spec


def test_inv_norms_roofline_bound():
    reader = spec.reader("inv_norms_roofline.retrieval")
    least = reader.least_seconds(2048, 351_232, "bfloat16")
    assert least == pytest.approx((2048 * 351_232 * 2 + 2048 * 4) / 3.35e12)
    assert least * 1e3 == pytest.approx(0.4294, abs=1e-4)
    assert reader.least_seconds(2048, 351_232, "float32") == pytest.approx(
        2 * least, rel=1e-5)


@pytest.mark.parametrize("launches,names", [
    ({}, ["nt_matmul_tiles"]), ({"inv_norms": 0}, ["inv_norms_rows"]),
    ({"inv_norms": 3}, ["reduce_kernel"])])
def test_inv_norms_roofline_reads_nothing_without_the_kernel(launches, names):
    trace = types.SimpleNamespace(device_seconds=lambda match: sum(
        1e-3 for name in names if match(types.SimpleNamespace(name=name))))
    rec = types.SimpleNamespace(launches=launches, trace=trace)
    assert spec.reader("inv_norms_roofline.retrieval").read(rec) is None


def test_inv_norms_roofline_share():
    cell = spec.load_cell(spec.BENCH_DIR.parent, "simpleconv_recipe.retrieval")
    trace = types.SimpleNamespace(device_seconds=lambda match: sum(
        0.5e-3 for name in ("void inv_norms_rows<1>(...)",
                            "void inv_norms_splits(...)", "sum_splits")
        if match(types.SimpleNamespace(name=name))))
    rec = types.SimpleNamespace(launches={"inv_norms": 2}, trace=trace,
                                cell=cell, model=cell.config["model"])
    share = spec.reader("inv_norms_roofline.retrieval").read(rec)
    assert share == pytest.approx(100 * 0.4294 / 0.5, abs=0.02)
