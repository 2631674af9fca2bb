"""Config loading of the port (gdkvm_tpu_torch.config) against the JAX
package's and against PyYAML: the YAML subset reader and writer, the
dataclass tree with its top-level aliases, and dotted overrides.
"""

import dataclasses
import glob
import math
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import gdkvm_tpu_torch
from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu_torch.config import schema, yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _path(name):
    return os.path.join(REPO, "configs", name)


def test_there_are_nine_configs():
    assert len(CONFIGS) == 9, CONFIGS


# ------------------------------------------------------------ load_config


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_jax(name):
    """Every file of configs/ loads to the values the JAX package's
    load_config reads, field by field (every section and alias; the port
    has every field of JAX's)."""
    want = dataclasses.asdict(jschema.load_config(_path(name)))
    got = dataclasses.asdict(schema.load_config(_path(name)))
    assert got == want
    assert gdkvm_tpu_torch.load_config(_path(name)) == schema.load_config(_path(name))


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_equals_pyyaml_on_configs(name):
    """The reader equals yaml.safe_load on the file as written, and on
    what JAX's save_config writes for it (block sequences, '' and null)."""
    text = open(_path(name)).read()
    assert yaml_subset.load(text) == yaml.safe_load(text)
    dumped = yaml.safe_dump(jschema.to_dict(jschema.load_config(_path(name))),
                            sort_keys=False)
    assert "data_path: " in dumped and "\n  - " in dumped
    assert yaml_subset.load(dumped) == yaml.safe_load(dumped)


@pytest.mark.parametrize("name", CONFIGS)
def test_save_config_round_trips(name, tmp_path):
    """save_config's file reads back to the same Config through the port
    and through the JAX package (PyYAML), and yaml.safe_load of it equals
    to_dict with tuples as lists."""
    cfg = schema.load_config(_path(name))
    out = str(tmp_path / "config.yaml")
    schema.save_config(cfg, out)
    assert schema.load_config(out) == cfg
    assert dataclasses.asdict(jschema.load_config(out)) == dataclasses.asdict(cfg)
    as_lists = yaml.safe_load(yaml.safe_dump(schema.to_dict(cfg)))     # tuples → lists
    assert yaml.safe_load(open(out).read()) == as_lists


def test_defaults_and_jax_written_defaults(tmp_path):
    """No file → the defaults, equal to JAX's; a config.yaml a JAX run
    writes at the defaults (data_path: '', aliases null) loads."""
    assert dataclasses.asdict(schema.load_config()) == dataclasses.asdict(jschema.load_config())
    out = str(tmp_path / "config.yaml")
    jschema.save_config(jschema.load_config(), out)
    text = open(out).read()
    assert "data_path: ''" in text and "data_path: null" in text
    assert schema.load_config(out) == schema.Config()
    empty = tmp_path / "empty.yaml"
    empty.write_text("# nothing\n")
    assert schema.load_config(str(empty)) == schema.Config()


@pytest.mark.parametrize("preset,name", [(schema.ts8_112, "gdkvm_ts8_112.yaml"),
                                         (schema.ts8_256, "gdkvm_ts8_256.yaml")])
def test_presets_equal_their_files(preset, name):
    """ts8_112() / ts8_256() hold their file's values in every section (the
    file sets them through the top-level aliases, the preset directly)."""
    got, want = preset(), schema.load_config(_path(name))
    for section in ("model", "data", "train", "eval_stage", "parallel", "runtime"):
        assert getattr(got, section) == getattr(want, section), section


OVERRIDES = [
    ["model.enc_channels=[16,32,48,64]", "model.kpff_channels=(8, 8)"],
    ["data.augment=false", "train.remat=True", "runtime.resume=1"],
    ["batch_size=3", "learning_rate=3e-4", "num_iterations=7", "data_path=/x/y"],
    # An alias set in the file wins over a nested override of its field.
    ["train.batch_size=5", "train.learning_rate=1"],
    ["train.batch_size=2.5", "model.gdr_impl=chunked", "data.synth_difficulty=1"],
    ["model.enc_blocks=[]", "runtime.run_dir=a=b"],
]


@pytest.mark.parametrize("overrides", OVERRIDES)
@pytest.mark.parametrize("name", [None, "gdkvm_ts8_256.yaml"])
def test_overrides_match_jax(name, overrides):
    path = name and _path(name)
    want = dataclasses.asdict(jschema.load_config(path, overrides))
    got = dataclasses.asdict(schema.load_config(path, overrides))
    assert got == want


def test_alias_in_file_overrides_a_nested_override():
    """apply_overrides runs __post_init__ again: gdkvm_ts8_256.yaml sets
    batch_size: 8 at the top level, so train.batch_size=5 does not stick,
    as in the JAX package; the alias itself does."""
    cfg = schema.load_config(_path("gdkvm_ts8_256.yaml"), ["train.batch_size=5"])
    assert cfg.train.batch_size == 8
    assert schema.load_config(_path("gdkvm_ts8_256.yaml"), ["batch_size=5"]).train.batch_size == 5
    assert schema.load_config(None, ["train.batch_size=5"]).train.batch_size == 5
    int_to_float = schema.load_config(None, ["train.batch_size=2.5"])
    assert int_to_float.train.batch_size == 2.5       # the int field falls through to float


@pytest.mark.parametrize("overrides,exc", [
    (["model.nope=1"], KeyError), (["nope.x=1"], KeyError),
    (["model.num_heads"], ValueError), (["train.learning_rate=abc"], ValueError)])
def test_bad_overrides_raise_as_in_jax(overrides, exc):
    for mod in (schema, jschema):
        with pytest.raises(exc):
            mod.load_config(None, overrides)


def test_unknown_yaml_key_names_the_valid_ones(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("model:\n  widht: 3\n")
    for mod in (schema, jschema):
        with pytest.raises(KeyError, match="valid keys.*num_heads"):
            mod.load_config(str(bad))
    bad.write_text("modle:\n  num_heads: 3\n")
    with pytest.raises(KeyError, match="Unknown config key 'modle' for Config"):
        schema.load_config(str(bad))


def test_port_has_every_jax_field():
    """Section by section the port's dataclasses have JAX's fields with
    JAX's defaults."""
    for name in ("ModelConfig", "DataConfig", "TrainConfig", "EvalStageConfig",
                 "ParallelConfig", "RuntimeConfig"):
        want = dataclasses.asdict(getattr(jschema, name)())
        got = dataclasses.asdict(getattr(schema, name)())
        assert got == want, name
    assert [f.name for f in dataclasses.fields(schema.Config)] == \
        [f.name for f in dataclasses.fields(jschema.Config)]


# ------------------------------------------------------------ the reader

SUBSET_CASES = [
    "a: -1\nb:\n- 1\n- -2\nc:\n  - x\n  - 'y'\n",
    "a: ''\nb: null\nc: ~\nd:\ne: Null\n",
    "a: 'x # y'  # c\nb: \"q\\\"#\\t\\u00e9\" # z\nc: 'it''s'\n",
    "a: [1, 'b, c', 2.5, true, null]  # c\r\nb: it's # c\r\n",
    "num_classes: 4          # BG, LV endo, ...\nkpff_channels: [128, 96]   # two scales\n",
    "k: 1.\nj: .5\ni: -.inf\nh: +1\ng: 1.0e-4\nf: -0.0\ne: 1.5E+3\n",
    "a: [ ]\nb: [1,2,]\nc: [ a b , c ]\n",
    "'q k': 1\n\"z\": [a]\n1: one\n",
    "a: foo bar  \nb: a:b\nc: -x\nd: /data/camus_png256x256_10f_20250709\ne: outputs/run\n",
    "# only a comment\n", "", "\n\n",
    "a:\n  b:\n    c: [x]\n    d:\n    - 1\n  e: 1\nf:\n- 1\n",
    "a: True\nb: FALSE\nc: NULL\n",
    "- 1\n- a\n- [x, y]\n",
]


@pytest.mark.parametrize("text", SUBSET_CASES)
def test_reader_equals_pyyaml_on_the_subset(text):
    got, want = yaml_subset.load(text), yaml.safe_load(text)
    assert got == want and repr(got) == repr(want)      # the types too: 1 is not True


REFUSED = [
    ("a: 1\nb: 1e-4\n", 2),                 # a string in YAML 1.1
    ("lr: 1.0e4\n", 1),                     # a string too: no exponent sign
    ("a: -.5\n", 1),
    ("a: yes\n", 1), ("x: 1\na: Off\n", 2), ("a: [on]\n", 1),
    ("a: 010\n", 1), ("a: 1_000\n", 1), ("a: 0x10\n", 1), ("a: 1:30\n", 1),
    ("a: 2024-01-01\n", 1),
    ("a:\n\tb: 1\n", 2), ("a:\t1\n", 1),
    ("a: &x 1\n", 1), ("a: 1\nb: *x\n", 2), ("a: !!int 3\n", 1),
    ("a: |\n  x\n", 1), ("a: >-\n  x\n", 1),
    ("a: {b: 1}\n", 1), ("a: [b: 1]\n", 1), ("a: [[1]]\n", 1),
    ("a: 1\n---\nb: 2\n", 2), ("---\na: 1\n", 1), ("%YAML 1.1\n", 1),
    ("a: [1,\n  2]\n", 1), ("a:\n- b: 1\n", 2), ("- - 1\n", 1),
    ("a: 1\na: 2\n", 2), ("a: x\n  y\n", 2), ("a: 'x\n  y'\n", 1),
    ("? a\n: b\n", 1), ("x\n", 1), ("a: b: c\n", 1), ("a: 'x' y\n", 1),
    ("a: \"\\q\"\n", 1), ("a: [1 2, , 3]\n", 1), ("  a: 1\n", 1),
    ("a:\n    b: 1\n  c: 2\n", 3),
]


@pytest.mark.parametrize("text,line", REFUSED)
def test_reader_refuses_with_the_line_number(text, line):
    with pytest.raises(ValueError, match=rf"^line {line}: "):
        yaml_subset.load(text)


def test_refused_forms_read_differently_in_pyyaml():
    """Why they are refused: PyYAML 6 reads each as something other than
    the number or string its writer most likely meant."""
    assert yaml.safe_load("a: 1e-4") == {"a": "1e-4"}
    assert yaml.safe_load("a: 1.0e4") == {"a": "1.0e4"}
    assert yaml.safe_load("a: yes") == {"a": True}
    assert yaml.safe_load("a: 010") == {"a": 8}
    assert yaml.safe_load("a: 1_000") == {"a": 1000}
    assert yaml.safe_load("a: 1:30") == {"a": 90}


_LINE_BREAKS = "\n\r\x85\u2028\u2029"


def _python_only_number(s: str) -> bool:
    """Python reads it as a number, YAML 1.1 as a string (1e5, 0e0, -.5):
    PyYAML dumps it plain, the reader refuses it on purpose."""
    tag = yaml.resolver.Resolver().resolve(yaml.ScalarNode, s, (True, False))
    if not any(c.isdigit() for c in s) or tag != "tag:yaml.org,2002:str":
        return False
    for parse in (float, lambda t: int(t, 0)):
        try:
            parse(s.replace("_", ""))
            return True
        except ValueError:
            pass
    return False


_text = st.text(st.characters(blacklist_categories=("Cs",), blacklist_characters=_LINE_BREAKS),
                max_size=24).filter(lambda s: not _python_only_number(s.strip()))
_scalars = st.one_of(st.none(), st.booleans(), st.integers(-10**12, 10**12),
                     st.floats(allow_nan=False), _text)
_keys = st.one_of(st.text("abcdefghij_-. 0123456789#:'\"", min_size=1, max_size=12)
                  .filter(lambda s: not _python_only_number(s.strip())),
                  st.integers(0, 99))
_lists = st.lists(_scalars, max_size=5)


def _mappings(children):
    # Every mapping holds a list: yaml.safe_dump(default_flow_style=None)
    # writes a mapping of scalars alone as a flow mapping, which is refused.
    return st.builds(lambda d, items: {**d, "zz_list": items},
                     st.dictionaries(_keys, children, max_size=4), _lists)


_docs = st.recursive(_mappings(st.one_of(_scalars, _lists)),
                     lambda inner: _mappings(st.one_of(_scalars, _lists, inner)),
                     max_leaves=12)


@settings(max_examples=200, deadline=None, derandomize=True, database=None,
          suppress_health_check=list(HealthCheck))
@given(doc=_docs, flow=st.sampled_from([False, None]))
def test_reader_equals_pyyaml_on_generated_documents(doc, flow):
    """Nested mappings of scalars and lists of scalars, dumped by
    yaml.safe_dump in block style and with flow-style leaf lists (lines
    unfolded: width large; strings without line breaks, which PyYAML folds
    over lines, and none that only Python reads as a number, which the
    reader refuses)."""
    text = yaml.safe_dump(doc, default_flow_style=flow, sort_keys=False, width=10**6)
    want = yaml.safe_load(text)
    got = yaml_subset.load(text)
    assert got == want and repr(got) == repr(want), text


@settings(max_examples=200, deadline=None, derandomize=True, database=None,
          suppress_health_check=list(HealthCheck))
@given(doc=_docs)
def test_writer_round_trips_through_pyyaml(doc):
    text = yaml_subset.dump(doc)
    assert yaml.safe_load(text) == doc, text
    assert yaml_subset.load(text) == doc, text


def test_writer_scalars_and_refusals():
    text = yaml_subset.dump({"a": 1e-5, "b": 1e20, "c": math.inf, "d": "1e-4", "e": "yes",
                             "f": "", "g": "x: y", "h": (1, 2), "i": [], "j": -0.5,
                             "k": "plain/path_1.0", "l": None, "m": True, "n": "é\t"})
    assert "a: 1.0e-05" in text and "b: 1.0e+20" in text and "c: .inf" in text
    assert "d: '1e-4'" in text and "e: 'yes'" in text and "f: ''" in text
    assert "k: plain/path_1.0" in text and "l: null" in text and "i: []" in text
    back = yaml.safe_load(text)
    assert back["h"] == [1, 2] and back["n"] == "é\t" and back["g"] == "x: y"
    assert math.isnan(yaml_subset.load(yaml_subset.dump({"x": math.nan}))["x"])
    for bad in ({"a": {}}, {"a": object()}, {"a": [[1]]}, [1]):
        with pytest.raises(ValueError):
            yaml_subset.dump(bad)
