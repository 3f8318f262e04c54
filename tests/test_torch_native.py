"""The port's native batch gather (brainmagick_tpu_torch/native) against
the JAX package's (brainmagick_tpu.native) and against its plain version
in dataset.py, bit for bit in float32 and bfloat16; the bounds checks in
Python and in the library; the build: several processes building at once,
a failed build that leaves no file behind, an edited source that never
loads the library of the old one, and a failed build on the loader's path
that raises; and the datasets' and the loader's batches assembled by it."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from brainmagick_tpu import native as jnative
from brainmagick_tpu_torch import dataset, loader, train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.native import gather

REPO = Path(__file__).resolve().parent.parent
#: the fake study's shape, cut to two recordings (tests/test_torch_data.py)
OVERRIDES = ['dset.selections=["fake"]', "dset.n_recordings=2",
             'dset.features=["MelSpectrum", "WordLength"]',
             'dset.features_params={"MelSpectrum": {"n_mels": 8}}',
             "dset.condition=1.0", "dset.tmin=-0.2", "dset.tmax=1.0",
             "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
             "dset.min_n_blocks_per_split=1", "optim.loss=clip",
             "optim.batch_size=8", "seed=1234", "num_workers=2",
             "device=cpu"]


def _bits(x) -> np.ndarray:
    """The bits of a float32 array or of a bfloat16 (tensor or ml_dtypes
    array)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _recording(rng, n_channels=13, total=2000, special=True):
    """A recording whose channels sit at different offsets and scales, the
    last two holding inf and NaN (with them, every row of those channels
    is inf or NaN after a baseline)."""
    raw = (rng.randn(n_channels, total) * 10 ** rng.uniform(-13, -11, (
        n_channels, 1)) + rng.randn(n_channels, 1) * 1e-11).astype(np.float32)
    if special:
        raw[-2, 100:1900:7] = np.inf
        raw[-1, 50:1950:5] = np.nan
    return raw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("baseline_len,out_channels", [(0, 13), (61, 13),
                                                       (1, 16), (37, 20)])
def test_epochs_equal_the_jax_native_gather(dtype, baseline_len,
                                            out_channels):
    """Epochs at ragged starts, with and without a baseline, padded or
    not: the same bits as the JAX package's native gather (its C++ build,
    not its numpy fallback), and as the plain version (in bfloat16, its
    float32 epochs rounded to nearest even by torch; NaN where it has
    NaN)."""
    assert jnative.is_available()
    rng = np.random.RandomState(baseline_len)
    raw = _recording(rng)
    starts = rng.randint(0, raw.shape[1] - 61, 37)
    got = gather.gather_epochs(raw, starts, 61, out_channels, baseline_len,
                               dtype=dtype)
    want = jnative.batch_gather_epochs(raw, starts, 61, out_channels,
                                       baseline_len, dtype=dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with np.errstate(invalid="ignore"):                 # inf - inf
        plain = dataset.gather_epochs(raw, starts, 61, out_channels,
                                      baseline_len)
    if dtype == "float32":
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(plain))
    else:
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        rounded = torch.from_numpy(plain).to(torch.bfloat16)
        nan = torch.isnan(rounded)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int16),
                           rounded[~nan].view(torch.int16))
    assert (_bits(got)[:, 13:] == 0).all()
    assert np.isfinite(plain[:, :11]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_track_windows_equal_the_jax_native_gather(dtype):
    rng = np.random.RandomState(3)
    track = _recording(rng, n_channels=9, total=700)
    starts = rng.randint(0, 700 - 48, 21)
    got = gather.gather_track(track, starts, 48, dtype=dtype)
    want = jnative.batch_gather_track(track, starts, 48, dtype=dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    plain = dataset.gather_track(track, starts, 48)
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(got), _bits(plain))
    else:
        rounded = torch.from_numpy(plain).to(torch.bfloat16)
        nan = torch.isnan(rounded)
        assert torch.equal(got[~nan].view(torch.int16),
                           rounded[~nan].view(torch.int16))


def test_bounds_are_checked_in_python_and_in_the_library():
    """A window that leaves the recording raises IndexError in the
    wrappers and in the plain versions; the library itself refuses such a
    window, a baseline longer than the window and fewer output channels
    than the recording's, writing nothing."""
    rng = np.random.RandomState(0)
    raw = _recording(rng, special=False)
    for starts in ([0, -1], [0, raw.shape[1] - 60]):
        starts = np.array(starts)
        for fn in (gather.gather_epochs, dataset.gather_epochs):
            with pytest.raises(IndexError, match="outside"):
                fn(raw, starts, 61, 13)
        for fn in (gather.gather_track, dataset.gather_track):
            with pytest.raises(IndexError, match="outside"):
                fn(raw, starts, 61)
    with pytest.raises(ValueError, match="float16"):
        gather.gather_epochs(raw, np.array([0]), 61, 13, dtype="float16")

    lib = gather.library()
    out = np.full((2, 13, 61), 7., dtype=np.float32)

    def call(starts, out_channels=13, baseline_len=0, n_times=61):
        starts = np.asarray(starts, dtype=np.int64)
        return lib.gather_epochs(raw.ctypes.data, 13, raw.shape[1],
                                 starts.ctypes.data, len(starts), n_times,
                                 out_channels, baseline_len,
                                 out.ctypes.data, 2)
    assert call([0, -1]) == -1
    assert call([0, raw.shape[1] - 60]) == -1
    assert call([0, 5], baseline_len=62) == -1
    assert call([0, 5], out_channels=12) == -1
    assert (out == 7.).all()
    assert call([0, raw.shape[1] - 61], baseline_len=61) == 0
    np.testing.assert_array_equal(out, dataset.gather_epochs(
        raw, np.array([0, raw.shape[1] - 61]), 61, 13, 61))


def _source_copy(folder: Path, extra: str = "") -> Path:
    folder.mkdir(parents=True, exist_ok=True)
    source = folder / "gather.cpp"
    source.write_text(gather.SOURCE.read_text() + extra)
    return source


#: a process whose four threads build the library of argv[1] into argv[2]
#: at once; it prints the float32 sum of a batch gathered with it
BUILD_CHILD = """
import sys
from concurrent import futures
import numpy as np
from brainmagick_tpu_torch.native import gather
with futures.ThreadPoolExecutor(4) as pool:
    libs = [job.result(timeout=300) for job in [
        pool.submit(gather.library, sys.argv[1], sys.argv[2])
        for _ in range(4)]]
assert all(lib is libs[0] for lib in libs)
lib = libs[0]
raw = np.arange(5 * 300, dtype=np.float32).reshape(5, 300)
starts = np.array([0, 17, 200], dtype=np.int64)
out = np.empty((3, 5, 40), dtype=np.float32)
assert lib.gather_epochs(raw.ctypes.data, 5, 300, starts.ctypes.data, 3, 40,
                         5, 10, out.ctypes.data, 2) == 0
print(float(out.sum()))
"""


def test_concurrent_builds_across_processes(tmp_path):
    """Four processes of four threads each build one source into one
    empty folder at once: each loads a whole library (one a process) and
    gets the same batch, one library is left, and no build's file."""
    source = _source_copy(tmp_path / "src", "// concurrent\n")
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_CHILD, str(source), str(build_dir)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [proc.communicate(timeout=300) for proc in procs]
    assert [proc.returncode for proc in procs] == [0] * 4, outs
    assert len({out.strip() for out, _ in outs}) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == [
        gather.library_path(source, build_dir).name]


def test_failed_build_leaves_no_tmp_file(tmp_path):
    """A source g++ refuses: GatherBuildError with g++'s message, and the
    build folder holds nothing, no ``*.so.tmp*`` file of the build
    included; a timed-out build also raises and leaves nothing."""
    build_dir = tmp_path / "build"
    broken = _source_copy(tmp_path / "broken", "int broken( {\n")
    with pytest.raises(gather.GatherBuildError, match="broken"):
        gather.build(broken, build_dir)
    assert list(build_dir.iterdir()) == []
    with pytest.raises(gather.GatherBuildError):
        gather.library(broken, build_dir)
    assert list(build_dir.iterdir()) == []


def test_failed_build_times_out_cleanly(tmp_path, monkeypatch):
    """A build past BUILD_TIMEOUT: g++ and what it started are killed,
    GatherBuildError, and nothing is left in the build folder."""
    monkeypatch.setattr(gather, "BUILD_TIMEOUT", 0.001)
    build_dir = tmp_path / "build"
    source = _source_copy(tmp_path / "src", "// timeout\n")
    with pytest.raises(gather.GatherBuildError, match="took over"):
        gather.build(source, build_dir)
    assert list(build_dir.iterdir()) == []


def test_edited_source_never_loads_the_old_library(tmp_path):
    """The library of a source, then the same file edited: a library of
    its own, built from the edit (its new entry point answers), beside the
    old one; edited again so that g++ refuses it, it raises rather than
    load either library."""
    build_dir = tmp_path / "build"
    source = _source_copy(tmp_path / "src")
    old = gather.library(source, build_dir)
    assert not hasattr(old, "gather_probe")
    old_path = gather.library_path(source, build_dir)
    source.write_text(source.read_text()
                      + 'extern "C" int gather_probe() { return 7; }\n')
    new_path = gather.library_path(source, build_dir)
    assert new_path != old_path
    new = gather.library(source, build_dir)
    assert new.gather_probe() == 7
    assert sorted(build_dir.iterdir()) == sorted([old_path, new_path])
    source.write_text(source.read_text() + "int broken( {\n")
    with pytest.raises(gather.GatherBuildError):
        gather.library(source, build_dir)
    assert sorted(build_dir.iterdir()) == sorted([old_path, new_path])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    folder = root / "fake_cache"
    folder.mkdir()
    args = train.parse_overrides(OVERRIDES + [f"cache={folder}",
                                              f"out_dir={root / 'out'}"])
    with env.temporary(cache=folder):
        yield train.build_datasets(args)


def test_dataset_batches_come_from_the_native_gather(datasets):
    """``get_batch`` of one recording and of the train split across both
    recordings: meg and features the plain versions' bits in float32, and
    in bfloat16 CPU tensors of their rounding (the split's rows scattered
    in the order asked); the rest of the batch the same either way."""
    train_split = datasets.train
    one = train_split.datasets[0]
    n0 = len(one)
    indices = np.array([3, n0 + 2, 0, n0 + 5, 1, n0])
    for ds, idx in ((one, np.array([4, 0, 2])), (train_split, indices)):
        fp32 = ds.get_batch(idx)
        bf16 = ds.get_batch(idx, dtype="bfloat16")
        assert isinstance(fp32.meg, np.ndarray)
        for name in ("meg", "features"):
            assert getattr(bf16, name).dtype == torch.bfloat16
            assert torch.equal(
                getattr(bf16, name).view(torch.int16),
                torch.from_numpy(getattr(fp32, name)).to(
                    torch.bfloat16).view(torch.int16)), name
        for name in ("features_mask", "subject_index", "recording_index",
                     "positions"):
            np.testing.assert_array_equal(getattr(bf16, name),
                                          getattr(fp32, name))
    for pos, i in enumerate(indices):
        d = int(i >= n0)
        sub = train_split.datasets[d]
        local = int(i) - d * n0
        starts = sub.event_samples[[local]] + sub._start_offset
        baseline = sub.sample_rate.to_ind(sub.baseline[1] - sub.tmin) + 1
        want = dataset.gather_epochs(
            sub.raw.data, starts, sub._n_times,
            sub.meg_dimension or sub.raw.n_channels, baseline)
        np.testing.assert_array_equal(_bits(fp32.meg[pos]), _bits(want[0]))


def test_loader_sends_what_the_gather_assembled(datasets):
    """The device loader (here the CPU) in bfloat16 yields the bfloat16
    batch the dataset assembled, bit for bit, with nothing cast on the
    way; the host loader stays float32."""
    kwargs = dict(batch_size=8, shuffle=True, seed=1234, num_workers=2)
    host = loader.Loader(datasets.train, **kwargs)
    card = loader.Loader(datasets.train, device="cpu",
                         assemble_dtype="bfloat16", **kwargs)
    n = 0
    for (want, _), (got, _) in zip(host, card):
        assert isinstance(want.meg, np.ndarray)
        for name in ("meg", "features"):
            assert torch.equal(getattr(got, name), torch.from_numpy(
                getattr(want, name)).to(torch.bfloat16)), name
        n += 1
    assert n == len(host) >= 2


def test_failed_build_raises_on_the_loaders_path(datasets, tmp_path,
                                                 monkeypatch):
    """No g++ and no library for the source: ``get_batch`` (and so the
    loader) raises GatherBuildError instead of gathering another way."""
    monkeypatch.setattr(gather, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(gather.shutil, "which", lambda name: None)
    gather._package_library.cache_clear()
    try:
        with pytest.raises(gather.GatherBuildError, match="g\\+\\+"):
            datasets.train.get_batch(np.arange(4))
        with pytest.raises(gather.GatherBuildError):
            next(iter(loader.Loader(datasets.train, batch_size=4)))
    finally:
        gather._package_library.cache_clear()
