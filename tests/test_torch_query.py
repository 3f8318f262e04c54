"""``EventTable.query`` (the port's pandas-free event query) against
pandas' ``DataFrame.query`` on the fake study's events: fixed queries and
queries that hypothesis builds from the subset's grammar select the same
rows, every construct outside the subset raises NotImplementedError, and
the two users of the query, a string ``dset.condition`` and
schoffelen2019's ``events_filter``, select what the JAX package's do."""

import types

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_data import OVERRIDES
from test_torch_studies import _both, assert_events_equal, write_mous_fixture

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.studies import fake as jfake
from brainmagick_tpu_torch import train
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.events import EventTable

#: the fake study's events (words, phonemes, blocks; NaN where a field
#: does not apply) as pandas holds them, and as the port does
FRAME = jfake.make_fake_events(total_duration=200, seed=1234)
FRAME = FRAME.assign(row=np.arange(len(FRAME)))
TABLE = EventTable.from_records(FRAME.to_dict("records"))

FIXED = (
    "kind == 'word'", "kind=='word' & word_index==0",
    "kind == 'word' and duration > 0.1", "kind != 'word'",
    "word == 'de' | word == 'Toen'", "word != 'de'",
    "not kind == 'phoneme'", "~(kind == 'phoneme') & start < 20",
    "0.5 < start < 10", "1 <= word_index <= 4 and modality == 'audio'",
    "word in ['de', 'Toen', None]", "word not in ['de']",
    "word_index in [0, 2, 4]", "word_index not in (0, 1)",
    "phoneme_id in [None, 0]", "kind == ['word', 'block']",
    "kind != ['word', 'phoneme']", "start > -1", "word < 'de'",
    "word >= 'barkeeper'", "(kind == 'word' or kind == 'block') and "
    "(start < 5 or start > 100)", "kind == 'word' & (modality == 'visual' "
    "| word_index > 10)", "word_index == 2.0", "phoneme_id != 3",
    "language == 'nl' and condition == 'sentence'", "duration < start",
    "word == None", "word != None", "uid == None", "kind == \"word\"")

#: constructs outside the subset, each of which must raise
REFUSED = ("kind.str.startswith('w')", "len(word) > 2", "word_index == @n",
           "word_index + 1 > 2", "start * 2 < 1", "-start < 1",
           "`kind` == 'word'", "kind == 'word' &", "1 == 1",
           "kind == 'word' == True", "'word' in kind", "kind in 'word'",
           "kind is None", "word[0] == 'd'", "kind == {'word'}",
           "start if kind else duration", "lambda: kind", "kind == b'word'",
           "word_index", "'word'", "kind == ['word', [1]]",
           "kind == ['word', start]", "(kind == 'word') < 1")


def _rows(query: str) -> tuple:
    """(pandas' rows, the port's rows) of `query`, as row numbers."""
    want = FRAME.query(query)["row"].tolist()
    got = TABLE.query(query)["row"].tolist()
    return want, got


@pytest.mark.parametrize("query", FIXED)
def test_fixed_queries_select_pandas_rows(query):
    want, got = _rows(query)
    assert got == want


def test_fixed_queries_are_not_trivial():
    """The fixed queries select some rows and not all of them, but for the
    missing-value cases that select every row or none, and the columns
    hold missing values."""
    trivial = {"start > -1", "word == None", "word != None", "uid == None"}
    for query in FIXED:
        n = len(_rows(query)[0])
        assert (0 < n < len(FRAME)) != (query in trivial), query
    assert FRAME["word"].isna().any() and FRAME["word_index"].isna().any()


@pytest.mark.parametrize("query", REFUSED)
def test_constructs_outside_the_subset_raise(query):
    with pytest.raises(NotImplementedError, match="query"):
        TABLE.query(query)


def test_an_unknown_column_raises_key_error():
    with pytest.raises(KeyError, match="no_such"):
        TABLE.query("no_such == 1")


# -- queries built from the grammar --------------------------------------

def _values(name: str) -> list:
    return sorted({v for v in FRAME[name].tolist() if isinstance(v, str)})


TEXT = {name: _values(name) for name in ("kind", "word", "modality",
                                         "condition")}
NUMBERS = {"start": (0., 200.), "duration": (0., 0.3),
           "word_index": (0., 30.), "phoneme_id": (0., 50.)}


@st.composite
def _literal_number(draw, name: str) -> str:
    lo, hi = NUMBERS[name]
    value = draw(st.one_of(
        st.integers(int(lo) - 1, int(hi) + 1),
        st.floats(lo - 1, hi + 1, allow_nan=False).map(lambda v: round(v, 3))))
    return repr(value)


@st.composite
def _comparison(draw) -> str:
    """A comparison over one column: text against a string (or None),
    numbers against numbers, chained, or a column in a list."""
    if draw(st.booleans()):
        name = draw(st.sampled_from(sorted(TEXT)))
        literal = st.one_of(st.sampled_from(TEXT[name]).map(repr),
                            st.just("'zz'"), st.just("None"))
        form = draw(st.sampled_from(["cmp", "in", "list_eq"]))
        if form == "cmp":
            op = draw(st.sampled_from(["==", "!=", "<", ">=", "==", "!="]))
            value = draw(literal)
            if value == "None" and op not in ("==", "!="):
                op = "=="
            return f"{name} {op} {value}"
        items = draw(st.lists(literal, min_size=1, max_size=4))
        op = draw(st.sampled_from(["in", "not in"] if form == "in"
                                  else ["==", "!="]))
        return f"{name} {op} [{', '.join(items)}]"
    name = draw(st.sampled_from(sorted(NUMBERS)))
    form = draw(st.sampled_from(["cmp", "chain", "in", "columns"]))
    ops = ["==", "!=", "<", "<=", ">", ">="]
    if form == "cmp":
        return f"{name} {draw(st.sampled_from(ops))} " \
               f"{draw(_literal_number(name))}"
    if form == "chain":
        lo, hi = sorted([draw(_literal_number(name)) for _ in range(2)],
                        key=float)
        return f"{lo} {draw(st.sampled_from(['<', '<=']))} {name} " \
               f"{draw(st.sampled_from(['<', '<=']))} {hi}"
    if form == "in":
        items = draw(st.lists(st.one_of(_literal_number(name),
                                        st.just("None")),
                              min_size=1, max_size=4))
        op = draw(st.sampled_from(["in", "not in"]))
        return f"{name} {op} ({', '.join(items)},)"
    other = draw(st.sampled_from(sorted(NUMBERS)))
    return f"{name} {draw(st.sampled_from(ops))} {other}"


def _expression(depth: int = 2):
    if depth == 0:
        return _comparison()

    @st.composite
    def build(draw) -> str:
        kind = draw(st.sampled_from(["leaf", "and", "or", "not"]))
        if kind == "leaf":
            return draw(_comparison())
        if kind == "not":
            inner = draw(_expression(depth - 1))
            return draw(st.sampled_from([f"~({inner})", f"not ({inner})"]))
        left, right = draw(_expression(depth - 1)), draw(_expression(
            depth - 1))
        word = draw(st.sampled_from(["&", "and"] if kind == "and"
                                    else ["|", "or"]))
        return draw(st.sampled_from([f"{left} {word} {right}",
                                     f"({left}) {word} ({right})"]))
    return build()


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_expression())
def test_generated_queries_select_pandas_rows(query):
    """Column names, literals, NaN rows, ``in`` lists with None, mixed
    ``&``/``and`` and ``|``/``or``, ``not``/``~`` and chained comparisons:
    the port selects pandas' rows."""
    want, got = _rows(query)
    assert got == want, query


# -- the query's users ---------------------------------------------------

#: compound conditions of a dset.condition string
CONDITIONS = ("kind=='word' and duration > 0.1",
              "kind == 'word' & (word_index < 5 | modality == 'visual')")


@pytest.fixture(scope="module")
def condition_datasets(tmp_path_factory):
    """Both packages' datasets of test_torch_data's OVERRIDES with each of
    CONDITIONS as dset.condition, in one cache folder."""
    root = tmp_path_factory.mktemp("query")
    folder = root / "fake_cache"
    folder.mkdir()
    out = {}
    with jenv.temporary(cache=folder), env.temporary(cache=folder):
        for condition in CONDITIONS:
            cli = OVERRIDES + [f"cache={folder}", f"out_dir={root / 'o'}",
                               f"dset.condition={condition}"]
            out[condition] = types.SimpleNamespace(
                jax=jtrain.build_datasets(jtrain.parse_overrides(cli)),
                port=train.build_datasets(train.parse_overrides(
                    cli + ["device=cpu"])))
    return out


@pytest.mark.parametrize("condition", CONDITIONS)
@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_dset_condition_selects_the_jax_packages_segments(
        condition_datasets, condition, split):
    """A compound ``dset.condition`` (a pandas query in the JAX package,
    ``brainmagick_tpu/dataset.py:442-445``) gives each split the JAX
    package's segments: the same recordings and event samples."""
    built = condition_datasets[condition]
    jsets = getattr(built.jax, split).datasets
    psets = getattr(built.port, split).datasets
    assert len(jsets) == len(psets) > 0
    assert len(getattr(built.port, split)) == len(getattr(built.jax, split))
    for jset, pset in zip(jsets, psets):
        assert pset.recording.recording_uid == jset.recording.recording_uid
        np.testing.assert_array_equal(pset.event_samples,
                                      jset.event_samples)


def test_compound_conditions_select_fewer_segments(condition_datasets):
    """Each compound condition keeps fewer segments than words alone."""
    for condition in CONDITIONS:
        port = condition_datasets[condition].port
        for dset in port.test.datasets:
            words = dset.recording.events().query("kind == 'word'")
            assert 0 < len(dset.event_samples) < len(words)


#: schoffelen2019's events_filter: the audio_mous_wl selection's and
#: compound filters
FILTERS = ('condition == "word_list"',
           'condition == "word_list" and kind != "phoneme"',
           'condition in ["sentence"] | kind == "block"')


@pytest.mark.parametrize("events_filter", FILTERS)
def test_schoffelen_events_filter_is_the_jax_selection(tmp_path,
                                                       events_filter):
    """schoffelen2019's ``events(clean=True)`` under `events_filter` keeps
    the JAX adapter's rows (tests/test_torch_studies.py's MOUS fixture)."""
    root = tmp_path / "mous"
    write_mous_fixture(root)
    jrecs, recs = _both("schoffelen2019", root, tmp_path, modality="audio",
                        events_filter=events_filter)
    with jenv.temporary(studies={"schoffelen2019": root}):
        want = jrecs[0].events(clean=True)
    got = recs[0].events(clean=True)
    assert_events_equal(want.reset_index(drop=True), got)
    assert 0 < len(got) < len(recs[0].events())
    assert isinstance(want, pd.DataFrame)


def test_the_card_phase_query_count(tmp_path):
    """chip_smoke.py phase 20's compound dset.condition (HOSTS_QUERY, the
    test split too) on phase 9's gwilliams2022 tree, built here: the test
    split holds HOSTS_QUERY_SEGMENTS segments, the count the card's
    machine must give without pandas, fewer than 'word' gives."""
    import chip_smoke as cs

    cs.write_gwilliams_tree(tmp_path / cs.KEPT_STUDY,
                            np.random.RandomState(cs.SEED + 9))
    common = [*cs.STUDY_ARGS, f"dset.selections=[{cs.KEPT_STUDY!r}]",
              f"cache={tmp_path}/cache", "device=cpu"]
    sizes = {}
    with env.temporary(studies={cs.KEPT_STUDY: tmp_path / cs.KEPT_STUDY}):
        for name, condition in (("query", cs.HOSTS_QUERY), ("word", "word")):
            args = train.parse_overrides(
                common + [f"dset.condition={condition}",
                          "dset.test.condition=None"])
            with env.temporary_from_args(args):
                sizes[name] = len(train.build_datasets(args).test)
    assert sizes["query"] == cs.HOSTS_QUERY_SEGMENTS < sizes["word"]
