"""The port's category text embeddings (retrieval/text_embeddings.py) and
the training CLI's text-embedding cache against the JAX package's, on a
tiny text tower carried across by the weights bridge, in f32 at
rtol 2e-4, atol 2e-5:

  * plain_category_embeddings: unit rows equal to JAX's;
  * prompt_engineered_embeddings over the 85 templates, a few and one
    (whose embedding stays unnormalised), with batches that split a
    category's prompts; the pickles hold the same keys in the same order,
    float32 arrays of the same shapes, equal values;
  * cli/main.py::build_text_embeddings computes the plain embeddings from
    a synthetic OpenAI-layout checkpoint and merges file and writes the
    JAX CLI's cache file, which the JAX CLI reads; the JAX CLI's own cache
    file is read back by the port's; a missing merges file raises with
    the JAX message.
"""
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chip_smoke import synthetic_merges, write_merges
from fixture_helpers import base_cli_cfg, dump_cfg, write_cli_fixture
from test_torch_text import synthetic_clip_pt
from zutis_tpu.cli import main as jax_main
from zutis_tpu.core.config import Config as JaxConfig
from zutis_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from zutis_tpu.models import factory as jax_factory
from zutis_tpu.models.text import CLIPTextEncoder as JaxText
from zutis_tpu.retrieval import text_embeddings as jte
from zutis_tpu_torch.cli import main as port_main
from zutis_tpu_torch.core.config import Config
from zutis_tpu_torch.data.tokenizer import CLIPTokenizer
from zutis_tpu_torch.models import factory
from zutis_tpu_torch.models.text import CLIPTextEncoder
from zutis_tpu_torch.models.weights import text_params_from_jax
from zutis_tpu_torch.retrieval import text_embeddings as te
from zutis_tpu_torch.retrieval.prompts import PROMPT_TEMPLATES

RTOL, ATOL = 2e-4, 2e-5
CATEGORIES = ["cat", "dog", "hot dog", "great_white_shark", "café"]


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    fp = str(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    write_merges(fp, synthetic_merges(CATEGORIES + PROMPT_TEMPLATES, 800))
    jtok = JaxTokenizer.from_file(fp, 800)
    tok = CLIPTokenizer.from_file(fp, 800)
    cfg = dict(vocab_size=len(tok.encoder), width=32, layers=2, heads=2,
               embed_dim=16)
    jm = JaxText(**cfg)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 77), jnp.int32))["params"])
    ours = CLIPTextEncoder(**cfg, device="cpu")
    ours.load_state_dict(text_params_from_jax(params), strict=True)
    return (jm, params, jtok), (ours, tok)


def test_plain_category_embeddings_equal_jax(towers):
    (jm, params, jtok), (ours, tok) = towers
    want = jte.plain_category_embeddings(jm, params, jtok, CATEGORIES)
    got = te.plain_category_embeddings(ours, tok, CATEGORIES)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def _load(fp):
    with open(fp, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("n_templates", [85, 3, 1])
def test_prompt_engineered_pickles_equal_jax(towers, tmp_path, n_templates):
    (jm, params, jtok), (ours, tok) = towers
    templates = PROMPT_TEMPLATES[:n_templates]
    fps = [str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")]
    jte.prompt_engineered_embeddings(jm, params, jtok, CATEGORIES,
                                     templates=templates, fp=fps[0])
    te.prompt_engineered_embeddings(ours, tok, CATEGORIES,
                                    templates=templates, fp=fps[1])
    want, got = [_load(fp) for fp in fps]
    assert list(got) == list(want) == CATEGORIES
    for c in CATEGORIES:
        assert got[c].dtype == want[c].dtype == np.float32
        assert got[c].shape == want[c].shape == (16,)
        np.testing.assert_allclose(got[c], want[c], rtol=RTOL, atol=ATOL)
    norms = [np.linalg.norm(got[c]) for c in CATEGORIES]
    if n_templates == 1:  # the raw embedding, as the JAX package keeps it
        assert not np.allclose(norms, 1.0)
    else:
        np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_batches_do_not_change_the_embeddings(towers):
    _, (ours, tok) = towers
    texts = [t.format(c) for c in CATEGORIES for t in PROMPT_TEMPLATES]
    whole = te.encode_texts(ours, tok, texts, batch_size=len(texts))
    np.testing.assert_allclose(te.encode_texts(ours, tok, texts,
                                               batch_size=37),
                               whole, rtol=1e-5, atol=1e-6)


# ------------------------------------------ the CLI's text-embedding cache

TINY_TEXT = (32, 2, 2, 16)  # width, layers, heads, embed_dim


@pytest.fixture()
def assets(tmp_path, monkeypatch):
    """A config without text_embeddings_npz whose clip_assets_dir holds a
    synthetic ViT-B/16 checkpoint (text tower at TINY_TEXT's widths, which
    both packages' _TEXT_SPECS are patched to) and merges file."""
    monkeypatch.setitem(factory._TEXT_SPECS, "ViT-B/16", TINY_TEXT)
    monkeypatch.setitem(jax_factory._TEXT_SPECS, "ViT-B/16", TINY_TEXT)
    parts = write_cli_fixture(tmp_path, n_val_images=1)
    dir_assets = tmp_path / "assets"
    dir_assets.mkdir()
    width, layers, heads, embed = TINY_TEXT
    synthetic_clip_pt(dir_assets / "ViT-B-16.pt", width, layers, heads, embed)
    cfg = base_cli_cfg(*parts, tmp_path / "ckpt",
                       clip_assets_dir=str(dir_assets))
    cfg.pop("text_embeddings_npz")
    fp = dump_cfg(cfg, tmp_path / "cfg.yaml")
    return Config.load(fp), JaxConfig.load(fp), dir_assets


def test_cli_cache_missing_merges_raises(assets):
    cfg, _, _ = assets
    with pytest.raises(FileNotFoundError, match="BPE merges file not found"):
        port_main.build_text_embeddings(cfg, "cpu")


def test_cli_cache_written_by_the_port_reads_in_jax(assets):
    cfg, jcfg, dir_assets = assets
    write_merges(str(dir_assets / "bpe_simple_vocab_16e6.txt.gz"),
                 synthetic_merges(cfg.categories + PROMPT_TEMPLATES))
    cache = port_main.text_embeddings_cache_path(cfg)
    assert not os.path.exists(cache)
    got = port_main.build_text_embeddings(cfg, "cpu")
    assert got.shape == (len(cfg.categories), TINY_TEXT[3])
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    with np.load(cache, allow_pickle=True) as f:
        assert list(f["categories"]) == cfg.categories
        np.testing.assert_array_equal(f["embeddings"], got)
    # the JAX CLI reads the port's file as its own
    np.testing.assert_array_equal(
        np.asarray(jax_main.build_text_embeddings(jcfg)), got)
    # and computes the same embeddings from the same assets
    os.remove(cache)
    want = np.asarray(jax_main.build_text_embeddings(jcfg))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the port reads the JAX CLI's file as its own
    with np.load(cache, allow_pickle=True) as f:
        jax_written = np.asarray(f["embeddings"])
    np.testing.assert_array_equal(port_main.build_text_embeddings(cfg, "cpu"),
                                  jax_written)


def test_cli_cache_of_another_category_list_is_recomputed(assets):
    cfg, _, dir_assets = assets
    write_merges(str(dir_assets / "bpe_simple_vocab_16e6.txt.gz"),
                 synthetic_merges(cfg.categories, 500))
    cache = port_main.text_embeddings_cache_path(cfg)
    stale = np.zeros((len(cfg.categories), TINY_TEXT[3]), np.float32)
    np.savez(cache, embeddings=stale,
             categories=np.array(["x"] * len(cfg.categories), dtype=object))
    got = port_main.build_text_embeddings(cfg, "cpu")
    assert not np.array_equal(got, stale)
    with np.load(cache, allow_pickle=True) as f:
        assert list(f["categories"]) == cfg.categories
