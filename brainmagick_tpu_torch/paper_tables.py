"""Paper-table analysis over the port's offline evaluations.

Port of ``scripts/paper_tables.py`` without pandas or PyYAML: load each
XP's eval artifacts (``eval/<sig>-torch``: probs_segment, vocab_segment,
metadata, acc), aggregate the top-k segment accuracy per (dataset,
variant) across seeds (Table 2), and compute the paired significance of
every variant against a baseline (Table 4's p-values). Each XP's config
is its grid job's ``Job.to_config()``: the signature names the folder, so
it is the config the XP trained with, and no solver_config.yaml is read.
The aggregation is pandas' (``groupby`` order, a compensated mean, the
std with ddof 1 by Welford's update, NaN filled to 0 for one seed,
``round(2)``), and the CSV files are written as pandas' ``to_csv`` writes
them.

Usage:
    python -m brainmagick_tpu_torch.paper_tables table grid=nmi.main_table \
        [out_dir=./outputs] [topk=1]
    python -m brainmagick_tpu_torch.paper_tables pvalues \
        grid=nmi.ablation_final [baseline=<variant>] [out_dir=./outputs]
"""

from __future__ import annotations

import dataclasses
import math
import sys
import typing as tp
from pathlib import Path

import numpy as np

from .cache import tagged
from .studies.utils import read_csv
from .utils import records_csv, write_and_rename

Rows = tp.List[tp.Dict[str, tp.Any]]


def load_eval(sig: str, config: tp.Mapping[str, tp.Any],
              out_dir: str = "./outputs") -> tp.Dict[str, tp.Any]:
    """One XP's eval artifacts (written by ``brainmagick_tpu_torch.eval``
    into ``eval/<sig>-torch``) and its `config` (``dataclasses.asdict`` of
    the XP's config): {"sig", "probs", "vocab", "segment_hashes" (the
    metadata's column), "acc" ({topk: acc_segment}), "config"}."""
    eval_dir = Path(out_dir) / "eval" / tagged(sig)
    metadata = read_csv(eval_dir / "metadata.csv")
    acc = read_csv(eval_dir / "acc.csv")
    return {
        "sig": sig,
        "probs": np.load(eval_dir / "probs_segment.npy"),
        "vocab": np.load(eval_dir / "vocab_segment.npy"),
        "segment_hashes": np.array([row["segment_hashes"]
                                    for row in metadata]),
        "acc": {row["topk"]: row["acc_segment"] for row in acc},
        "config": config,
    }


def variant_name(config: tp.Mapping[str, tp.Any]) -> str:
    """Short human label of the XP variant (the notebooks' `name`
    column): which toggles differ from the paper base."""
    simple = config.get("simpleconv", {})
    flags = []
    for key, base in (("merger", True), ("glu", 2),
                      ("initial_linear", 270), ("gelu", True),
                      ("skip", True), ("complex_out", True),
                      ("subject_layers", True)):
        if simple.get(key, base) in (False, 0, None):
            flags.append(f"no_{key}")
    if config.get("norm", {}).get("clip") is False:
        flags.append("no_clamp")
    loss = config.get("optim", {}).get("loss")
    if loss and loss != "clip":
        flags.append(loss)
    feats = config.get("dset", {}).get("features") or []
    main_feats = [f for f in feats if f != "WordHash"]
    if main_feats and main_feats != ["Wav2VecTransformer"]:
        flags.append("+".join(main_feats))
    if config.get("feature_model_name"):
        flags.append(str(config["feature_model_name"]))
    return "base" if not flags else ",".join(flags)


def dataset_name(config: tp.Mapping[str, tp.Any]) -> str:
    sels = config.get("dset", {}).get("selections") or []
    return "-".join(s.get("study", str(s)) if isinstance(s, dict) else
                    str(s) for s in sels)


def _evaluated(grid: str, out_dir: str
               ) -> tp.List[tp.Tuple[str, tp.Dict[str, tp.Any]]]:
    """(sig, config as a dict) of each job of `grid` whose evaluation is
    in ``eval/<sig>-torch``, in the grid's order."""
    from .grids import get_grid

    _, jobs = get_grid(grid)
    out = []
    for job in jobs:
        config = job.to_config()
        folder = Path(out_dir) / "eval" / tagged(config.sig)
        if (folder / "acc.csv").exists():
            out.append((config.sig, dataclasses.asdict(config)))
    return out


def _mean(values: tp.Sequence[float]) -> float:
    """pandas' groupby mean: a Kahan-compensated sum over the count."""
    total = compensation = 0.0
    for value in values:
        y = value - compensation
        t = total + y
        compensation = t - total - y
        total = t
    return total / len(values)


def _std(values: tp.Sequence[float]) -> float:
    """pandas' groupby std (ddof 1): Welford's update, NaN for one
    value."""
    mean = m2 = 0.0
    for n, value in enumerate(values, 1):
        old = mean
        mean += (value - old) / n
        m2 += (value - mean) * (value - old)
    return math.sqrt(m2 / (len(values) - 1)) if len(values) > 1 \
        else math.nan


def build_table(grid: str, out_dir: str = "./outputs",
                topk: int = 1) -> Rows:
    """Mean and std of the top-k segment accuracy per (dataset, variant)
    across seeds, the NMI paper's Table 1/2 aggregation: the rows of
    ``df.groupby(["dataset", "variant"]).acc.agg(["mean", "std",
    "count"]).reset_index()`` with acc_pct and std_pct (percent, rounded
    to 2 decimals, a single seed's std as 0)."""
    groups: tp.Dict[tp.Tuple[str, str], tp.List[float]] = {}
    for sig, config in _evaluated(grid, out_dir):
        data = load_eval(sig, config, out_dir)
        key = (dataset_name(config), variant_name(config))
        groups.setdefault(key, []).append(float(data["acc"][topk]))
    if not groups:
        raise SystemExit(f"no evaluated XPs for grid {grid} under "
                         f"{out_dir}/eval: run brainmagick_tpu_torch.eval "
                         f"grid={grid} first")
    keys = sorted(groups)
    means = np.array([_mean(groups[key]) for key in keys])
    stds = np.array([_std(groups[key]) for key in keys])
    acc_pct = np.round(100 * means, 2)
    std_pct = np.round(100 * np.nan_to_num(stds, nan=0.0), 2)
    return [dict(dataset=dataset, variant=variant, mean=float(means[k]),
                 std=float(stds[k]), count=len(groups[dataset, variant]),
                 acc_pct=float(acc_pct[k]), std_pct=float(std_pct[k]))
            for k, (dataset, variant) in enumerate(keys)]


def per_sample_hits(data: tp.Mapping[str, tp.Any]) -> np.ndarray:
    """[N] bool: the top-1 prediction is the true segment."""
    pred = data["vocab"][np.argmax(data["probs"], axis=1)]
    return pred == data["segment_hashes"]


def paired_pvalue(hits_a: np.ndarray, hits_b: np.ndarray) -> float:
    """Two-sided McNemar exact test on paired per-sample correctness
    (the discordant pairs' binomial test)."""
    from scipy import stats

    assert hits_a.shape == hits_b.shape
    n01 = int((~hits_a & hits_b).sum())
    n10 = int((hits_a & ~hits_b).sum())
    n = n01 + n10
    if n == 0:
        return 1.0
    return float(stats.binomtest(min(n01, n10), n, 0.5,
                                 alternative="two-sided").pvalue * 1.0)


def build_pvalues(grid: str, out_dir: str = "./outputs",
                  baseline: str = "base") -> Rows:
    """Per-dataset paired significance of every variant against the
    baseline variant, samples matched by (seed, sample order): the
    Table 4 p-values."""
    evals: tp.Dict[tp.Tuple[str, str, tp.Any], np.ndarray] = {}
    for sig, config in _evaluated(grid, out_dir):
        data = load_eval(sig, config, out_dir)
        key = (dataset_name(config), variant_name(config),
               config.get("seed"))
        evals[key] = per_sample_hits(data)

    rows = []
    datasets = {k[0] for k in evals}
    variants = {k[1] for k in evals}
    for dataset in sorted(datasets):
        for variant in sorted(variants - {baseline}):
            pairs = []
            for (ds, var, seed), hits in evals.items():
                base_key = (ds, baseline, seed)
                if ds == dataset and var == variant and base_key in evals:
                    base_hits = evals[base_key]
                    if len(base_hits) == len(hits):
                        pairs.append((base_hits, hits))
            if not pairs:
                continue
            base_all = np.concatenate([p[0] for p in pairs])
            var_all = np.concatenate([p[1] for p in pairs])
            rows.append(dict(
                dataset=dataset, variant=variant,
                acc_base=float(base_all.mean()),
                acc_variant=float(var_all.mean()),
                delta=float(var_all.mean() - base_all.mean()),
                p_value=paired_pvalue(base_all, var_all),
                n_samples=len(base_all), n_seeds=len(pairs)))
    return rows


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Optional[Path]:
    """The command line; returns the CSV file it wrote."""
    argv = list(argv if argv is not None else sys.argv[1:])
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    mode = argv[0]
    kw = dict(t.split("=", 1) for t in argv[1:])
    out_dir = kw.get("out_dir", "./outputs")
    if mode == "table":
        rows = build_table(kw["grid"], out_dir, topk=int(kw.get("topk", 1)))
    elif mode == "pvalues":
        rows = build_pvalues(kw["grid"], out_dir,
                             baseline=kw.get("baseline", "base"))
    else:
        raise SystemExit(f"unknown mode {mode!r} (table | pvalues)")
    text = records_csv(rows)
    print(text, end="")
    dest = Path(out_dir) / f"{mode}_{kw['grid']}.csv"
    with write_and_rename(dest, "w") as f:
        f.write(text)
    print(f"wrote {dest}")
    return dest


if __name__ == "__main__":
    main()
