"""maed_tpu_torch.core.config against maed_tpu.core.config and pyyaml.

- the defaults are equal as plain dicts, and so is ``update_cfg`` of both
  configs in ``configs/``;
- the port's YAML reader equals ``yaml.safe_load`` on both configs and on
  strings covering the subset (YAML 1.1 typing: ``5e-5`` is a string), and
  raises on what is outside it where pyyaml would read something;
- ``dump`` writes the text JAX's ``dump`` (``yaml.safe_dump``) writes, and
  it reads back equal with both readers;
- ``merge_from_list`` and ``parse_args`` take and refuse the same overrides
  as JAX's, with the same exception types.
"""

import math
from pathlib import Path

import pytest
import yaml

from maed_tpu.core import config as J
from maed_tpu_torch.core import config as C

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p) for p in (REPO / "configs").glob("*.yaml"))


def plain(d):
    return {k: plain(v) if isinstance(v, dict) else v for k, v in d.items()}


def same(a, b):
    """Equal, with NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def test_defaults_equal_jax():
    assert plain(C.get_cfg_defaults()) == plain(J.get_cfg_defaults())
    assert C.get_cfg_defaults().dump() == J.get_cfg_defaults().dump()


@pytest.mark.parametrize("path", CONFIGS)
def test_update_cfg_equals_jax(path):
    got, want = C.update_cfg(path), J.update_cfg(path)
    assert same(plain(got), plain(want))
    with open(path) as f:
        text = f.read()
    assert same(C.safe_load(text), yaml.safe_load(text))


SUBSET = [
    "a: 5e-5", "a: 1.0e-4", "a: 1e+4", "a: 1.5", "a: .5", "a: -3", "a: 017", "a: 08",
    "a: 0x1F", "a: 0b101", "a: 1_000", "a: 1:30", "a: 1:30.5", "a: +1", "a: -0", "a: 1.",
    "a: .inf", "a: -.Inf", "a: .NaN", "a: yes", "a: No", "a: on", "a: OFF", "a: True",
    "a: ~", "a: null", "a:", "a: ''", "a: \"x\\ty\"", "a: 'it''s'", "a: it's",
    "a: \"q\\\"q\"", "a: 'a # b'", "a: b # c", "a: 3dpw", "a: results/", "a: 'multi word'",
    "a: [60, 90]", "a: []", "a: [ ]", "a: {}", "a: ['x', \"y\", 3, 1.5, true]", "a: [a, ]",
    "a:\n  - x\n  - 'y'", "a:\n- x\n- y\nb: 2", "a:\n  b:\n    c: 1\n  d: [1]\ne: f",
    "# top\na: 1 # c\n\nb: 2", "---\na: 1", "1: a", "5e-5", "[1, 2]", "true", "hello world",
    "-1.5e-3", "0.0001", "1.0e-05",
]


@pytest.mark.parametrize("text", SUBSET)
def test_yaml_subset_equals_safe_load(text):
    assert same(C.safe_load(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: {b: 1}", "a: [[1]]",
    "a: 2001-12-14", "<<: 1", "a:\n  - b: 1", "a: x: y", "a: - b",
])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(C.YamlSubsetError):
        C.safe_load(text)


@pytest.mark.parametrize("path", [None] + CONFIGS)
def test_dump_round_trips(path):
    cfg = C.get_cfg_defaults() if path is None else C.update_cfg(path)
    text = cfg.dump()
    assert text == (J.get_cfg_defaults() if path is None else J.update_cfg(path)).dump()
    assert same(C.safe_load(text), plain(cfg))
    assert same(yaml.safe_load(text), plain(cfg))


def test_dump_quotes_what_would_read_back_as_another_type():
    data = {"a": "5e-5", "b": "true", "c": "1", "d": "", "e": "x: y", "f": "- z", "g": "null",
            "h": 1e-5, "i": float("inf"), "j": [], "k": {}, "l": ["3", 3], "m": None,
            "n": "it's", "o": " pad"}
    text = C.safe_dump(data)
    assert text == yaml.safe_dump(data, sort_keys=False)
    assert same(yaml.safe_load(text), data) and same(C.safe_load(text), data)


GOOD = [
    ["TRAIN.OPTIM.LR", "1e-4"], ["TRAIN.OPTIM.LR", "0.001"], ["TRAIN.END_EPOCH", "60"],
    ["TRAIN.OPTIM.MILESTONES", "[60, 90]"], ["TRAIN.RESUME", "auto"], ["DEBUG", "false"],
    ["TRAIN.DATASETS_2D", "[insta, posetrack]"], ["EXP_NAME", "x y"], ["DATASET.ROT_JITTER", "0"],
    ["TRAIN.OPTIM.WD", "0"], ["DEVICE", "cpu"], ["TRAIN.RESUME", "results/run/preempt.pth.tar"],
]
BAD = [
    ["TRAIN.END_EPOCH", "sixty"], ["TRAIN.END_EPOCH", "1.5"], ["DEBUG", "1"],
    ["TRAIN.OPTIM.MILESTONES", "60"], ["TRAIN.NOPE", "1"], ["NOPE.X", "1"], ["TRAIN.END_EPOCH"],
    ["TRAIN.OPTIM.LR", "fast"], ["TRAIN.OPTIM.LR", "true"],
]


@pytest.mark.parametrize("opts", GOOD + BAD, ids=lambda o: " ".join(o))
def test_merge_from_list_matches_jax(opts):
    got, want = C.get_cfg_defaults(), J.get_cfg_defaults()
    outcomes = []
    for cfg in (got, want):
        try:
            cfg.merge_from_list(list(opts))
            outcomes.append(None)
        except (KeyError, ValueError, AssertionError) as e:
            outcomes.append(type(e))
    assert outcomes[0] is outcomes[1]
    assert (outcomes[0] is None) == (opts in GOOD)
    assert same(plain(got), plain(want))


@pytest.mark.parametrize("argv", [
    ["--cfg", CONFIGS[-1], "--allow_synthetic_smpl", "TRAIN.END_EPOCH", "3"],
    ["--checkpoint", "x.pth.tar", "--eval_ds", "h36m", "--eval_set", "val",
     "--output_path", "out", "EVAL.BATCH_SIZE", "4"],
    ["--cfg", "missing.yaml"],
    ["TRAIN.END_EPOCH", "sixty"],
    ["TRAIN.NOPE", "1"],
])
def test_parse_args_matches_jax(argv):
    results = []
    for mod in (C, J):
        try:
            args, cfg, cfg_file = mod.parse_args(list(argv))
            results.append((vars(args), plain(cfg), cfg_file))
        except SystemExit as e:
            results.append(("exit", e.code))
    assert results[0] == results[1]
