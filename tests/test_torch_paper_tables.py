"""The port's paper tables (``brainmagick_tpu_torch.paper_tables``, no
pandas or PyYAML) against ``scripts/paper_tables.py`` over the same
fabricated evaluations of a real grid's XPs, written as ``eval/<sig>``
(with solver_config.yaml) for the script and ``eval/<sig>-torch`` for the
port: the tables and p-values to 1e-12, their CSV text byte for byte,
the per-sample hits and the McNemar p-value; the variant and dataset
names of every grid job."""

import dataclasses
import importlib.util
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from brainmagick_tpu.grids import get_grid as jget_grid
from brainmagick_tpu.grids import list_grids as jlist_grids
from brainmagick_tpu_torch import paper_tables
from brainmagick_tpu_torch.cache import tagged
from brainmagick_tpu_torch.grids import get_grid

spec = importlib.util.spec_from_file_location(
    "paper_tables_script",
    Path(__file__).parent.parent / "scripts" / "paper_tables.py")
pt = importlib.util.module_from_spec(spec)
sys.modules["paper_tables_script"] = pt
spec.loader.exec_module(pt)

TOL = 1e-12
GRID = "nmi.ablation_final"


def _write_eval(folder: Path, hits: np.ndarray, seed: int,
                config: dict = None) -> None:
    """One XP's eval artifacts with a given per-sample top-1 correctness
    (tests/test_paper_tables.py's fabrication)."""
    rng = np.random.RandomState(seed)
    n, n_vocab = len(hits), 20
    vocab = np.arange(n_vocab, dtype=np.int64) + 1000
    true_hashes = vocab[rng.randint(0, n_vocab, n)]
    probs = rng.rand(n, n_vocab).astype(np.float32) * 0.1
    for i in range(n):
        true_col = int(np.flatnonzero(vocab == true_hashes[i])[0])
        probs[i, true_col if hits[i] else (true_col + 1) % n_vocab] = 1.0
    probs /= probs.sum(axis=1, keepdims=True)
    folder.mkdir(parents=True)
    np.save(folder / "probs_segment.npy", probs)
    np.save(folder / "vocab_segment.npy", vocab)
    pd.DataFrame({"segment_hashes": true_hashes,
                  "study": ["x"] * n}).to_csv(folder / "metadata.csv")
    pd.DataFrame([dict(topk=k, acc_segment=float(min(
        1.0, hits.mean() + (k > 1) * rng.rand() / 7)))
        for k in (1, 5, 10)]).to_csv(folder / "acc.csv", index=False)
    if config is not None:
        with open(folder / "solver_config.yaml", "w") as f:
            yaml.safe_dump(config, f)


@pytest.fixture(scope="module")
def grid_evals(tmp_path_factory):
    """Evaluations of most XPs of nmi.ablation_final on two datasets: some
    variants over three seeds, some over one, the base of one dataset
    missing a seed, one XP of another length than its base's; each in
    both packages' folders."""
    out = tmp_path_factory.mktemp("paper_tables")
    rng = np.random.RandomState(0)
    _, jobs = jget_grid(GRID)
    base_hits = {}
    written = 0
    for k, job in enumerate(jobs):
        cfg = job.to_config()
        dataset = cfg.dset.selections[0]
        if dataset not in ("gwilliams2022", "audio_mous"):
            continue
        variant = pt.variant_name(dataclasses.asdict(cfg))
        if k % 5 == 4 or (variant == "no_gelu" and cfg.seed != 2036) or (
                dataset == "audio_mous" and cfg.seed == 2038
                and variant == "base"):
            continue
        n = 300 if k % 11 else 280
        key = (dataset, cfg.seed)
        if key not in base_hits:
            base_hits[key] = rng.rand(n) < 0.41
        base = base_hits[key]
        if len(base) >= n:
            hits = base[:n] & (rng.rand(n) > rng.rand() * 0.4)
        else:
            hits = rng.rand(n) < 0.3
        config = dataclasses.asdict(cfg)
        _write_eval(out / "eval" / cfg.sig, hits, k, config)
        shutil.copytree(out / "eval" / cfg.sig,
                        out / "eval" / tagged(cfg.sig))
        (out / "eval" / tagged(cfg.sig) / "solver_config.yaml").unlink()
        written += 1
    assert written > 40
    return out


def _assert_rows_equal(got, want: pd.DataFrame):
    want = want.to_dict("records")
    assert len(got) == len(want)
    for row, ref in zip(got, want):
        assert list(row) == list(ref)
        for key, value in ref.items():
            if isinstance(value, float):
                assert (math.isnan(value) and math.isnan(row[key])) or \
                    abs(row[key] - value) <= TOL, key
            else:
                assert row[key] == value, key


@pytest.mark.parametrize("topk", [1, 5])
def test_build_table_matches_the_script(grid_evals, topk):
    got = paper_tables.build_table(GRID, str(grid_evals), topk=topk)
    want = pt.build_table(GRID, str(grid_evals), topk=topk)
    _assert_rows_equal(got, want)
    counts = {row["count"] for row in got}
    assert 1 in counts and 3 in counts


@pytest.mark.parametrize("baseline", ["base", "no_glu"])
def test_build_pvalues_matches_the_script(grid_evals, baseline):
    got = paper_tables.build_pvalues(GRID, str(grid_evals), baseline)
    want = pt.build_pvalues(GRID, str(grid_evals), baseline)
    _assert_rows_equal(got, want)
    assert got and {row["n_seeds"] for row in got} >= {1, 2}


@pytest.mark.parametrize("argv", [["table"], ["table", "topk=10"],
                                  ["pvalues"], ["pvalues", "baseline=x"]],
                         ids=" ".join)
def test_csv_text_matches_the_script(grid_evals, argv):
    """Each CLI's CSV file, as pandas' to_csv writes the script's (an empty
    p-value table too)."""
    tokens = [argv[0], f"grid={GRID}", f"out_dir={grid_evals}", *argv[1:]]
    dest = grid_evals / f"{argv[0]}_{GRID}.csv"
    pt.main(tokens)
    want = dest.read_text()
    dest.unlink()
    assert paper_tables.main(tokens) == dest
    assert dest.read_text() == want
    assert (want == "\n") == (argv[-1] == "baseline=x")


def test_per_sample_hits_and_pvalue(grid_evals):
    checked = 0
    for job in get_grid(GRID)[1]:
        config = dataclasses.asdict(job.to_config())
        sig = job.sig
        if not (grid_evals / "eval" / sig).exists():
            continue
        got = paper_tables.per_sample_hits(
            paper_tables.load_eval(sig, config, str(grid_evals)))
        want = pt.per_sample_hits(pt.load_eval(sig, str(grid_evals)))
        np.testing.assert_array_equal(got, want)
        checked += 1
    assert checked > 40
    rng = np.random.RandomState(1)
    for n, flip in ((500, 0.05), (400, 0.3), (7, 0.5), (100, 0.0)):
        a = rng.rand(n) < 0.4
        b = np.where(rng.rand(n) < flip, ~a, a)
        assert abs(paper_tables.paired_pvalue(a, b)
                   - pt.paired_pvalue(a, b)) <= TOL
    assert paper_tables.paired_pvalue(a, a) == 1.0


def test_reads_only_the_ports_folders(tmp_path, grid_evals):
    """The JAX package's eval/<sig> alone is not an evaluation for the
    port."""
    shutil.copytree(grid_evals / "eval", tmp_path / "eval",
                    ignore=shutil.ignore_patterns("*-torch"))
    with pytest.raises(SystemExit, match="no evaluated XPs"):
        paper_tables.build_table(GRID, str(tmp_path))
    assert paper_tables.build_pvalues(GRID, str(tmp_path)) == []


@pytest.mark.parametrize("name", jlist_grids() + ["rehearsal"])
def test_names_agree_for_every_grid_job(name):
    """variant_name and dataset_name of each job's config, the port's
    against the script's on the JAX package's config."""
    _, jobs = get_grid(name)
    _, jjobs = jget_grid(name)
    for job, jjob in zip(jobs, jjobs):
        config = dataclasses.asdict(job.to_config())
        jconfig = yaml.safe_load(yaml.safe_dump(
            dataclasses.asdict(jjob.to_config())))
        assert paper_tables.variant_name(config) == pt.variant_name(jconfig)
        assert paper_tables.dataset_name(config) == pt.dataset_name(jconfig)
