"""The port's config composition against the JAX package's, on the CPU.

- The port's YAML subset parser gives what ``yaml.safe_load`` gives on
  every file under ``conf/`` and on scalars and flow collections of the
  subset (YAML 1.1 resolution: ``1e-3`` and ``inf`` stay strings), and
  raises outside the subset.
- ``compose`` equals the JAX ``compose`` for every experiment in
  ``conf/experiment/`` (``base`` raises in both: it selects no model),
  bare and with ``tests/test_e2e.py``'s overrides.
- The builders give the port's dataclasses field for field the JAX
  package's (``DecoderConfig`` without ``num_pre_nms``, which the port
  drops).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from range_view_3d_detection_torch.training import builders as tbuild
from range_view_3d_detection_torch.utils import config as tconfig
from range_view_3d_detection_torch.utils.yaml_subset import YamlSubsetError, load
from range_view_3d_detection_tpu.training import builders as jbuild
from range_view_3d_detection_tpu.utils import config as jconfig

REPO = Path(__file__).resolve().parent.parent
CONF = REPO / "conf"
FILES = sorted(str(p.relative_to(CONF)) for p in CONF.rglob("*.yaml"))
EXPERIMENTS = sorted(p.stem for p in (CONF / "experiment").glob("*.yaml"))
E2E_OVERRIDES = [
    "dataset.root_dir=/data/sensor",
    "dataset._train_dataset.range_view_config.height=8",
    "dataset._train_dataset.range_view_config.width=56",
    "model.max_boxes=16",
    "model._backbone.layers=[8,8,8,8,8]",
    "model._head.fpn={1: 16}",
    "model._head.classification_head_channels=8",
    "model._head.regression_head_channels=8",
    "model._head.num_classification_blocks=1",
    "model._head.num_regression_blocks=1",
    "model.post_processing_config.nms_cap=128",
    "model.post_processing_config.min_confidence=0.01",
    "trainer.max_epochs=2",
    "trainer.devices=1",
    "model.train_log_freq=1",
    "trainer.zero1=true",
    "++run_dir=/tmp/run",
]


@pytest.mark.parametrize("name", FILES)
def test_loader_equals_safe_load_on_conf(name):
    text = (CONF / name).read_text()
    assert load(text) == yaml.safe_load(text)


SCALARS = ["null", "~", "", "true", "False", "yes", "Off", "1", "-2", "+3", "1_000", "0",
           "0.5", "1e-3", "1.0e-3", "1.5e+3", ".inf", "-.inf", "inf", ".5", "3.", "-0.0",
           "abc", "/tmp/x y", "${a.b}", "${oc.env:HOME}/data", "???", "'it''s'", '"a\\tb"',
           "[1, 2, .inf]", "{a: 1, b: [x, 'y']}", "[]", "{}", "[a, b,]", "[1, [2, 3]]",
           "{1: 16}", "- a\n- b", "k:\n- 1\n- 2\nj: 3", 'x: "#not" # comment',
           "a: [1,\n  2, # c\n  3]", "a:\n  [x,\n   y]\nb: null"]


@pytest.mark.parametrize("text", SCALARS)
def test_loader_equals_safe_load_on_the_subset(text):
    got, want = load(text), yaml.safe_load(text)
    assert got == want and type(got) is type(want)
    assert tconfig.parse_value(text) == want


def test_nan_resolves_as_in_pyyaml():
    assert math.isnan(load(".nan")) and math.isnan(yaml.safe_load(".nan"))


@pytest.mark.parametrize("text", ["0x1f", "010", "0b101", "1:30", "2001-12-14", "&a x", "*a",
                                  "!!str x", "a: |\n  x", "a: b\n  c", "---\na: 1", "[1, 2"])
def test_loader_raises_outside_the_subset(text):
    with pytest.raises(YamlSubsetError):
        load(text)


@pytest.mark.parametrize("experiment", EXPERIMENTS)
@pytest.mark.parametrize("overrides", [[], E2E_OVERRIDES], ids=["bare", "e2e"])
def test_compose_equals_jax(experiment, overrides):
    if experiment == "base":
        for compose in (jconfig.compose, tconfig.compose):
            with pytest.raises(KeyError, match="requires a selection"):
                compose(CONF, experiment, overrides)
        return
    want = jconfig.compose(CONF, experiment, overrides)
    assert tconfig.compose(CONF, experiment, overrides) == want
    assert tconfig.flatten(want) == jconfig.flatten(want)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in _fields(x).items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("experiment", [e for e in EXPERIMENTS if e != "base"])
def test_builders_give_the_jax_dataclasses(experiment):
    cfg = jconfig.compose(CONF, experiment, ["++model.remat=true"])
    assert _plain(tbuild.build_detector_config(cfg)) == _plain(jbuild.build_detector_config(cfg))
    jdec = _plain(jbuild.build_decoder_config(cfg))
    assert jdec.pop("num_pre_nms") == 50000
    assert _plain(tbuild.build_decoder_config(cfg)) == jdec
    for split in ("train", "val", "test"):
        assert _plain(tbuild.build_dataset_config(cfg, split)) == _plain(
            jbuild.build_dataset_config(cfg, split))
