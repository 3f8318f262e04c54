"""Offline segment-retrieval evaluation: the paper's top-k segment accuracy.

Port of ``brainmagick_tpu/eval.py`` on one device. The predictions come
from a trained solver's test split (``train.get_solver`` or
``play.get_solver_from_sig``; ``solver_batches`` reads its loader), or
from batches the caller gives to a ``serve.Server`` or a solver. Each
batch carries the ``dataset.ARRAY_FIELDS`` arrays, ``event_lists`` (per
row, the events of its segment, the first of which marks the segment's
start; each has ``kind``, ``start`` and ``duration``, a word also
``word``, ``word_index`` and ``word_sequence``), a ``study`` name, and
optionally ``word_hash`` [B, T] and ``pad_weight`` [B]:

    data = load_test_data(solver)            # or (server, batches)
    probs = build_probs(solver, data["preds"], data["trues"])
    acc = accuracy_from_probs(probs, data["segment_hashes"],
                              data["trues_segment_hashes"], topk=1)
    run_eval(solver, None, output_dir)       # all of it, to files

The command line evaluates a trained XP by its signature, or every
trained XP of a grid (``brainmagick_tpu_torch.grids``):

    python -m brainmagick_tpu_torch.eval sig=<sig> [out_dir=./outputs]
        [n_negatives=20000] [output=<dir>] [test_study=<study>]
        [device=cpu]
    python -m brainmagick_tpu_torch.eval grid=<grid> [workers=N] [...]

It reads the port's checkpoint in ``<out_dir>/xps/<sig>/`` and writes
into ``<out_dir>/eval/<sig>-torch`` unless ``output`` says otherwise (the
JAX package writes ``eval/<sig>``; the file names are the same, so the
two evaluations of one XP compare file by file). It runs on the card
unless ``device=cpu``.

The forwards run through ``forward_batch`` and the scoring through
``losses.pool_scores`` (``nt_matmul`` on a CUDA device; int8 pools
with ``test.pool_int8``), inside ``precision.exact_fp32``. The
probabilities are a softmax on the host, as
in the JAX package. Under ``python -m torch.distributed.run
--nproc_per_node=N``, ``eval sig=`` runs as N ranks of the solver's group
(``Solver.set_group``): the forwards and the scoring split over the
ranks, every rank gets every row, and rank 0 writes the files. Under a
launch over several hosts (``--nnodes``), each host evaluates its own rows
and its first rank writes that host's files (``run_eval``).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import gc
import hashlib
import logging
import os
import sys
import types
import typing as tp
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .cache import tagged
from .dataset import ARRAY_FIELDS, ConcatDataset
from .losses import ClipLoss, pool_scores
from .precision import exact_fp32
from .utils import dump_yaml

logger = logging.getLogger(__name__)


def _stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "little",
                          signed=True)


def stable_word_hash(word: str) -> int:
    """A copy of ``brainmagick_tpu.features.basic.stable_word_hash``
    (that module imports jax)."""
    norm = word.lower().strip(".")
    return int.from_bytes(
        hashlib.sha1(norm.encode()).digest()[:8], "little", signed=True)


def _get_extra_info(batch: tp.Any, sample_rate: float):
    """Per-sample word index and sequence hash tracks [B, 2, T], word
    strings [B, T] and segment strings [B], from the batch's event lists
    (``event_lists[k][0].start`` is row k's segment start)."""
    B, _, n_times = batch.features.shape
    data = np.full((B, 2, n_times), -1.0, dtype=np.float64)
    words = np.full((B, n_times), "", dtype="<U30")
    word_segs = []
    if B != len(batch.event_lists):
        raise ValueError(f"{len(batch.event_lists)} event lists for {B} "
                         f"rows")
    for k, events in enumerate(batch.event_lists):
        segment = ""
        start = events[0].start
        for event in events:
            if event.kind == "word":
                estart = max(0, int(sample_rate * (event.start - start)))
                estop = min(n_times, int(sample_rate * (event.start - start)
                                         + sample_rate * event.duration))
                data[k, 0, estart:estop] = event.word_index
                if not event.word_sequence:
                    raise RuntimeError("Could not get the word sequence.")
                data[k, 1, estart:estop] = _stable_hash(event.word_sequence)
                if estop > estart:
                    words[k, estart:estop] = event.word
                    segment += " " + event.word
        word_segs.append(segment.strip())
    return data, words, np.array(word_segs)


def check_index(args: tp.Any) -> int:
    """The sample of the segment's event: 2 past -tmin (``dset.test.tmin``,
    else ``dset.tmin``)."""
    tmin = args.dset.test.tmin
    if tmin is None:
        tmin = args.dset.tmin
    return int((-tmin) * args.dset.sample_rate) + 2


def host_array(t: torch.Tensor) -> np.ndarray:
    """`t` as a host numpy array; bf16, which numpy lacks, upcast to fp32
    (exactly: the scoring casts back to its compute dtype)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def solver_batches(solver: tp.Any, n_recordings: tp.Optional[int] = None,
                   shuffle: bool = False,
                   test_study: tp.Optional[str] = None,
                   with_events: bool = True
                   ) -> tp.Iterator[types.SimpleNamespace]:
    """A solver's test split as ``load_test_data`` and ``wer.get_wer``
    take it: the test recordings (of `test_study` when given, the first
    `n_recordings` when given) through ``solver.make_loader`` (shuffled
    with the config's seed when `shuffle`), each batch with the features
    the model is trained on, the ``WordHash`` track as ``word_hash`` when
    the test features hold it, its events (`with_events`), the study
    name and the loader's pad weights."""
    datasets = solver.datasets.test.datasets
    if test_study is not None:
        datasets = [d for d in datasets
                    if d.recording.study_name() == test_study]
    if n_recordings is not None:
        datasets = datasets[:n_recordings]
    test_features = solver.datasets.test.datasets[0].features
    hash_slice = test_features.get_slice("WordHash") \
        if "WordHash" in test_features else None
    used_names = list(solver.used_features.keys())
    for batch, pad_weight in solver.make_loader(
            ConcatDataset(datasets), shuffle=shuffle,
            with_events=with_events):
        arrays = {name: getattr(batch, name) for name in ARRAY_FIELDS}
        arrays["features"] = test_features.extract_features(
            batch.features, used_names)
        yield types.SimpleNamespace(
            **arrays, event_lists=batch._event_lists,
            study="-".join(sorted({r.study_name()
                                   for r in batch._recordings})),
            word_hash=None if hash_slice is None
            else batch.features[:, hash_slice][:, 0],
            pad_weight=pad_weight)


@torch.no_grad()
def load_test_data(server: tp.Any,
                   batches: tp.Optional[tp.Iterable[tp.Any]] = None,
                   n_recordings: tp.Optional[int] = None,
                   test_study: tp.Optional[str] = None
                   ) -> tp.Dict[str, np.ndarray]:
    """Predictions, the candidates deduplicated on their segment hash (the
    hash of the sequence hash and the word index), and per-prediction
    metadata, as numpy arrays. Without `batches`, `server` is a solver
    and the batches are its test split's (``solver_batches``, which
    takes the other arguments). A solver on several hosts gives its
    host's rows (``Solver.local_rows``), and so its host's predictions and
    candidates, as the JAX package gives a process's."""
    if batches is None:
        batches = solver_batches(server, n_recordings,
                                 test_study=test_study)
    args = server.args
    check_at = check_index(args)
    outs: tp.Dict[str, list] = defaultdict(list)
    seen_segment_hashes: set = set()
    local_rows = getattr(server, "local_rows", None)
    for batch in batches:
        extra_info, word_str, word_segs_str = _get_extra_info(
            batch, args.dset.sample_rate)
        # forward_batch returns this host's rows: align the metadata
        rows = slice(None) if local_rows is None \
            else local_rows(len(batch.meg))
        extra_info, word_str = extra_info[rows], word_str[rows]
        word_segs_str = word_segs_str[rows]
        preds, trues, _, keep_t = server.forward_batch(
            batch, getattr(batch, "pad_weight", None))
        keep = host_array(keep_t)
        if not keep.any():
            continue
        if getattr(batch, "word_hash", None) is not None:
            word_hash = np.asarray(batch.word_hash)[rows]
        else:
            word_hash = np.vectorize(stable_word_hash)(word_str)
        word_hash = word_hash[keep]
        wh = word_hash[:, check_at]
        if check_at > 0:
            wh = np.where(wh == 0, word_hash[:, check_at - 1], wh)
        wh = np.where(wh == 0, word_hash[:, check_at + 1], wh)
        wi = extra_info[keep, 0][:, check_at]
        si = extra_info[keep, 1][:, check_at]
        ws = word_str[keep][:, check_at]
        wseg = word_segs_str[keep]

        segment_hashes = np.array([
            _stable_hash(f"{int(s)}_{int(w)}")
            for s, w in zip(si, wi)], dtype=np.int64)
        # a candidate per segment: its first prediction's output
        mask = []
        for h in segment_hashes:
            if h in seen_segment_hashes:
                mask.append(False)
            else:
                seen_segment_hashes.add(h)
                mask.append(True)
        mask = np.array(mask, dtype=bool)

        outs["preds"].append(host_array(preds[keep_t]))
        outs["segment_hashes"].append(segment_hashes)
        outs["trues"].append(host_array(
            trues[keep_t][torch.from_numpy(mask).to(trues.device)]))
        outs["trues_segment_hashes"].append(segment_hashes[mask])
        outs["word_hashes"].append(wh.astype(np.int64))
        outs["word_indices"].append(wi.astype(np.int64))
        outs["seq_indices"].append(si.astype(np.int64))
        outs["word_strings"].append(ws)
        outs["word_segment_strings"].append(wseg)
        outs["subject_id"].append(
            np.asarray(batch.subject_index)[rows][keep].astype(np.int64))
        outs["recording_id"].append(
            np.asarray(batch.recording_index)[rows][keep].astype(np.int64))
        outs["study"].append(np.array([batch.study] * int(keep.sum())))
    return {k: np.concatenate(v, 0) for k, v in outs.items()}


@torch.no_grad()
@exact_fp32()
def build_probs(server: tp.Any, preds: np.ndarray, trues: np.ndarray,
                batch_size: int = 2048, tmin: tp.Optional[float] = None,
                tmax: tp.Optional[float] = None,
                stats: tp.Optional[tp.Dict[str, int]] = None) -> np.ndarray:
    """[N_pred, N_true] probabilities: the CLIP scores of each prediction
    against every candidate, streamed through the server's device in
    chunks of `batch_size` predictions and candidate blocks of 2048
    (``losses.pool_scores``: split over the ranks of a solver's group;
    ``streamed_scores`` fills `stats`; in int8 with ``test.pool_int8`` on
    a fast-path configuration), then a softmax over each row on the
    host. `tmin`/`tmax` trim both sides to that window
    (seconds relative to the event)."""
    dset_args = server.args.dset
    trim_min = trim_max = None
    if tmin is not None:
        trim_min = int((tmin - dset_args.tmin) * dset_args.sample_rate)
    if tmax is not None:
        trim_max = int((tmax - dset_args.tmin) * dset_args.sample_rate)
    preds = preds[..., trim_min:trim_max]
    trues = trues[..., trim_min:trim_max]

    clip = server.clip
    if clip is None:
        clip = ClipLoss(dset_tmin=dset_args.tmin,
                        dset_sample_rate=dset_args.sample_rate)
    scores = pool_scores(server, clip, preds, trues, chunk=batch_size,
                         stats=stats)
    scores -= scores.max(axis=1, keepdims=True)
    np.exp(scores, out=scores)
    scores /= scores.sum(axis=1, keepdims=True)
    return scores


def accuracy_from_probs(probs: np.ndarray, target_labels: np.ndarray,
                        vocab_labels: np.ndarray, topk: int = 10) -> float:
    """Top-k accuracy of label retrieval."""
    assert len(target_labels) == len(probs)
    assert len(vocab_labels) == probs.shape[1]
    k = min(topk, probs.shape[1])
    idx = np.argpartition(probs, -k, axis=1)[:, -k:]
    labels = vocab_labels[idx]
    return float((labels == target_labels[:, None]).any(axis=1).mean())


@contextlib.contextmanager
def _write_and_rename(path: Path, mode: str = "wb"):
    """Write to a temporary name beside `path`, then rename onto it."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, mode, newline=None if "b" in mode else "") as f:
        yield f
    os.replace(tmp, path)


def _write_csv(path: Path, header: tp.Sequence[str],
               rows: tp.Iterable[tp.Sequence[tp.Any]]) -> None:
    """A CSV file as pandas' ``to_csv`` writes it."""
    with _write_and_rename(path, "w") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


METADATA_KEYS = ("segment_hashes", "word_hashes", "word_indices",
                 "seq_indices", "word_segment_strings", "word_strings",
                 "subject_id", "recording_id", "study")


@exact_fp32()
def run_eval(server: tp.Any, batches: tp.Optional[tp.Iterable[tp.Any]],
             output_dir: tp.Union[str, Path], n_negatives: int = 20_000,
             probs_batch_size: int = 2048,
             stats: tp.Optional[tp.Dict[str, int]] = None,
             n_recordings: tp.Optional[int] = None,
             test_study: tp.Optional[str] = None) -> tp.Dict[int, float]:
    """The whole offline evaluation, of `batches` or (None) of the solver
    `server`'s test split (``load_test_data``). Writes
    solver_config.yaml (``dataclasses.asdict`` of the config, as
    ``yaml.safe_dump`` writes it), then probs_segment.npy,
    vocab_segment.npy, metadata.csv, acc.csv and negative_stats.csv into
    `output_dir` (the CSV files as the JAX package's pandas writes them)
    and returns the top-1, 5 and 10 segment accuracies. A solver in a
    group computes on every rank; rank 0 writes while the others wait.
    On several hosts each host evaluates its own rows against its own
    candidates, as each of the JAX package's processes does, and each
    host's first rank writes that host's files into `output_dir`, as each
    process does there: one folder a host, or, in a folder the hosts
    share, the files of the host that wrote last."""
    output_dir = Path(output_dir)
    group = getattr(server, "group", None)
    lead = group is None or group.host.lead
    if lead:
        output_dir.mkdir(exist_ok=True, parents=True)
        with _write_and_rename(output_dir / "solver_config.yaml", "w") as f:
            dump_yaml(dataclasses.asdict(server.args), f)
    data = load_test_data(server, batches, n_recordings=n_recordings,
                          test_study=test_study)
    logger.info("Loaded %d predictions, %d candidate segments",
                len(data["preds"]), len(data["trues"]))
    probs_segment = build_probs(server, data["preds"], data["trues"],
                                batch_size=probs_batch_size, stats=stats)
    vocab_segment = data["trues_segment_hashes"]
    segment_hashes = data["segment_hashes"]

    if lead:
        with _write_and_rename(output_dir / "probs_segment.npy") as f:
            np.save(f, probs_segment)
        with _write_and_rename(output_dir / "vocab_segment.npy") as f:
            np.save(f, vocab_segment)
        _write_csv(output_dir / "metadata.csv", ("",) + METADATA_KEYS,
                   ([i] + [data[k][i] for k in METADATA_KEYS]
                    for i in range(len(segment_hashes))))

    acc = {}
    for k in (1, 5, 10):
        acc[k] = accuracy_from_probs(probs_segment, segment_hashes,
                                     vocab_segment, topk=k)
        logger.info("Top-%d segment acc: %.2f%%", k, 100 * acc[k])
    if lead:
        _write_csv(output_dir / "acc.csv", ("topk", "acc_segment"),
                   acc.items())

    stats_rows = {
        "n_test_samples": len(data["word_hashes"]),
        "n_test_vocab": len(np.unique(data["word_hashes"])),
        "n_test_segments": len(np.unique(segment_hashes)),
        "n_neg_samples": len(data["word_hashes"][:n_negatives]),
        "n_neg_segments": len(np.unique(segment_hashes[:n_negatives])),
    }
    for key, val in stats_rows.items():
        logger.info("%s: %d", key, val)
    if lead:
        _write_csv(output_dir / "negative_stats.csv", ("", "0"),
                   stats_rows.items())
    if group is not None:
        group.barrier()
    return acc


#: the command line's tokens (``main``)
TOKENS = ("sig", "out_dir", "n_negatives", "output", "test_study", "device",
          "compilation_cache", "parallel.compilation_cache", "grid",
          "workers")


def _eval_sig(sig: str, tokens: tp.Mapping[str, str], out_dir: str,
              output: tp.Optional[str] = None) -> tp.Dict[int, float]:
    """``run_eval`` of the XP `sig` into `output` (``<out_dir>/eval/<sig>
    -torch`` when None); under a launcher, as the ranks of one group."""
    from .play import get_solver_from_sig
    from .train import join_launcher, parse_overrides

    output = output or str(Path(out_dir) / "eval" / tagged(sig))
    overrides = {"device": tokens["device"]} if "device" in tokens else {}
    group = join_launcher(parse_overrides(
        [f"device={tokens['device']}"] if "device" in tokens else []),
        check_batch=False)
    solver = get_solver_from_sig(sig, out_dir=out_dir,
                                 override_args=overrides, training=False,
                                 group=group)
    return run_eval(solver, None, output,
                    n_negatives=int(tokens.get("n_negatives", 20_000)),
                    test_study=tokens.get("test_study"))


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> dict:
    """The command line. ``sig=<xp>``: that XP evaluated by ``run_eval``
    into ``output`` (``<out_dir>/eval/<sig>-torch`` by default); returns
    its accuracies. ``grid=<name>``: every XP of the grid that holds a
    checkpoint-torch.pt, each into ``eval/<sig>-torch``, one after the
    other in this process (returns {sig: accuracies}), or with
    ``workers=N`` as N subprocesses of ``python -m brainmagick_tpu_torch.eval
    sig=<sig>`` at once, each logging to ``<out_dir>/eval/logs/<sig>.log``
    and seeing this process's data paths (returns {sig: return code}, and
    exits non-zero when one failed). ``compilation_cache`` (XLA's, in the
    JAX package) is accepted and read nowhere."""
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    tokens = {}
    for token in argv if argv is not None else sys.argv[1:]:
        key, sep, value = token.partition("=")
        if not sep or key not in TOKENS:
            raise ValueError(f"Expected one of {', '.join(TOKENS)} as "
                             f"key=value, got {token!r}")
        tokens[key] = value
    out_dir = tokens.get("out_dir", "./outputs")
    if "grid" not in tokens:
        if "workers" in tokens:
            raise ValueError("workers= fans out the XPs of a grid=")
        if "sig" not in tokens:
            raise ValueError("sig=<xp signature> or grid=<name> is required")
        return _eval_sig(tokens["sig"], tokens, out_dir,
                         tokens.get("output"))
    if "sig" in tokens or "output" in tokens:
        raise ValueError("grid= evaluates each XP into eval/<sig>-torch; it "
                         "takes no sig= or output=")
    from .grids import get_grid
    from .grids.runner import build_kernels, run_commands_with_logs

    _, jobs = get_grid(tokens["grid"])
    xps = Path(out_dir) / "xps"
    sigs = [sig for sig in (job.sig for job in jobs)
            if (xps / sig / tagged("checkpoint.pt")).exists()]
    logger.info("Evaluating %d trained XPs of grid %s", len(sigs),
                tokens["grid"])
    workers = int(tokens.get("workers", 1))
    if workers <= 1:
        results = {}
        for sig in sigs:
            results[sig] = _eval_sig(sig, tokens, out_dir)
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        return results
    build_kernels([tokens.get("device", "cuda")])
    passed = [f"n_negatives={tokens.get('n_negatives', 20_000)}"] + [
        f"{key}={tokens[key]}" for key in ("test_study", "device")
        if key in tokens]
    commands = [(sig, [sys.executable, "-m", "brainmagick_tpu_torch.eval",
                       f"sig={sig}", f"out_dir={out_dir}", *passed])
                for sig in sigs]
    codes = run_commands_with_logs(commands, Path(out_dir) / "eval" / "logs",
                                   workers)
    failed = {sig: rc for sig, rc in codes.items() if rc}
    if failed:
        raise SystemExit(f"eval grid={tokens['grid']}: {len(failed)} of "
                         f"{len(codes)} XPs failed: {failed}")
    return codes


if __name__ == "__main__":
    main()
