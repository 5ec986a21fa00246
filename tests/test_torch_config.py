"""The port's Config (zutis_tpu_torch/core/config.py) against the JAX
package's (zutis_tpu/core/config.py, on PyYAML): every shipped
configs/*.yaml and a `yaml.safe_dump` of tests/fixture_helpers.py's tiny CLI
config load to the same fields, extras included, the same
experiment_name, checkpoint_dir and to_json bytes; the YAML wins over the
keyword overrides as in the JAX package; the parser equals yaml.safe_load
on those files and raises on YAML outside its subset. The port's copies of
data/category_lists.py and data/label_maps.py equal the JAX ones."""
import dataclasses
from pathlib import Path

import pytest
import yaml

from fixture_helpers import base_cli_cfg, dump_cfg
from zutis_tpu.core import config as jconfig
from zutis_tpu.data import category_lists as jcategories
from zutis_tpu.data import label_maps as jlabel_maps
from zutis_tpu_torch.core import config
from zutis_tpu_torch.data import category_lists, label_maps

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def _same(got: config.Config, want: jconfig.Config, tmp_path) -> None:
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.experiment_name(got) == jconfig.experiment_name(want)
    assert config.checkpoint_dir(got) == jconfig.checkpoint_dir(want)
    got.to_json(str(tmp_path / "port.json"))
    want.to_json(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "jax.json").read_bytes()


def test_every_shipped_config_is_here():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_parser_equals_safe_load_on_shipped_configs(path):
    text = path.read_text()
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_shipped_config_loads_as_in_jax(path, tmp_path):
    _same(config.Config.load(str(path)), jconfig.Config.load(str(path)),
          tmp_path)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_yaml_wins_over_overrides_as_in_jax(path, tmp_path):
    over = dict(seed=3, n_iters=6, skip_pretrained=True, suffix="x")
    got = config.Config.load(str(path), **over)
    _same(got, jconfig.Config.load(str(path), **over), tmp_path)
    assert got.n_iters != 6 and got.extras["skip_pretrained"] is True


def _cli_cfg(tmp_path, **overrides):
    root = tmp_path / "data"
    return base_cli_cfg(["background", "square", "blob"],
                        root / "cache" / "category_to_p_images.json",
                        root / "archive", root / "coco", root / "emb.npz",
                        tmp_path / "ckpt", **overrides)


@pytest.mark.parametrize("overrides", [
    {},
    {"mesh_axes": {"data": 8, "model": 1}, "compute_dtype": "bfloat16",
     "checkpoint_every": 2, "seed": 7, "suffix": "'quoted'"},
    {"dataset_name": "imagenet-s", "n_categories": 920, "debug": True,
     "scale_range": [0.25, 1.0], "weight_ce_loss": 1.0e-5,
     "decoder_image_n_dims": None, "notes": ["yes", "1.0", "a: b", "#x", ""]},
], ids=["base", "mesh", "imagenet-s"])
def test_dumped_cli_config_loads_as_in_jax(tmp_path, overrides):
    path = dump_cfg(_cli_cfg(tmp_path, **overrides), tmp_path / "cfg.yaml")
    text = Path(path).read_text()
    assert config.parse_yaml(text) == yaml.safe_load(text)
    _same(config.Config.load(path), jconfig.Config.load(path), tmp_path)


def test_parser_reads_flow_collections_and_quoting():
    text = ('a: [0.1, 1.0, "x, y", \'it\'\'s\', [1, {b: 2}]]  # comment\n'
            'm: {data: 8, model: 1}\n'
            'e: {}\nl: []\nn: ~\ns: "tab\\there"\nh: "#not a comment"\n'
            'f: 1.5e-3\ng: 1e-3\ni: -0\nt: yes\nk: ViT-B/16\n')
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",          # anchors and aliases
    "a: !!str 1\n",               # tags
    "a: |\n  block\n",            # block scalars
    "a: >\n  folded\n",
    "- a: 1\n- b: 2\n",           # mappings inside sequences
    "a: b: c\n",
    "a: [1, 2\n",                 # unterminated flow collection
    "a: [1,\n  2]\n",             # multi-line flow collection
    "a: plain\n  continued\n",    # multi-line plain scalar
    "---\na: 1\n",                # documents
    "? a\n: 1\n",                 # complex keys
    "a: 0x1f\n",                  # hex, octal, sexagesimal: not plain ints
    "a: 017\n",
    "a: 1:30\n",
    "a: 2020-01-01\n",            # dates
    "1: a\n",                     # keys that are not strings
    "a:\n\t- 1\n",                # tabs
    "a: [1, , 2]\n",
    "a: 1\n  b: 2\n",             # indentation that opens nothing
], ids=lambda t: t.split("\n")[0][:14])
def test_parser_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


def test_category_presets_equal_jax():
    assert list(category_lists.CATEGORY_PRESETS) == list(
        jcategories.CATEGORY_PRESETS)
    for name, names in jcategories.CATEGORY_PRESETS.items():
        assert category_lists.CATEGORY_PRESETS[name] == names, name
    assert [len(v) for v in category_lists.CATEGORY_PRESETS.values()] == [
        81, 81, 920]


def test_label_maps_equal_jax():
    assert (label_maps.new_label_id_to_old_label_id
            == jlabel_maps.new_label_id_to_old_label_id)
    assert (label_maps.old_label_id_to_new_label_id
            == jlabel_maps.old_label_id_to_new_label_id)
    assert (label_maps.get_palette(81) == jlabel_maps.get_palette(81)).all()
