"""The port's CLIP tokenizer (zutis_tpu_torch/data/tokenizer.py) against
zutis_tpu/data/tokenizer.py: token ids equal, on the synthetic merge tables
of tests/test_tokenizer.py and on generated ones (chip_smoke's
`synthetic_merges`, which the card run writes at CLIP's size), over the 85
templates x category names with digits, underscores, apostrophes, HTML
entities and non-ASCII text. No real merges file is in the repository, so
the ids are CLIP's only given `bpe_simple_vocab_16e6.txt.gz`."""
import gzip

import numpy as np
import pytest

from chip_smoke import CLIP_MERGES, CLIP_VOCAB, synthetic_merges, write_merges
from zutis_tpu.data import tokenizer as jtok
from zutis_tpu.retrieval.prompts import PROMPT_TEMPLATES as JAX_TEMPLATES
from zutis_tpu_torch.data import tokenizer as ttok
from zutis_tpu_torch.retrieval.prompts import PROMPT_TEMPLATES

CATEGORIES = [
    "dog", "great_white_shark", "Jack-o'-lantern", "rock &amp; roll",
    "&amp;amp; twice escaped", "café crème", "Ölkanne", "東京タワー",
    "7up can", "4x4 truck", "  spaced\tout\nname ", "it's", "they'll've",
    "ROCK'N'ROLL", "A_B_C 123", "emoji 🐶", "<|endoftext|>", "a" * 120,
]
TOY_TABLES = {
    "cat": [("c", "a"), ("ca", "t</w>"), ("d", "o")],
    "one": [("c", "a")],
    "none": [],
}


def _texts():
    return [t.format(c) for c in CATEGORIES for t in PROMPT_TEMPLATES]


def test_templates_are_the_jax_packages():
    assert PROMPT_TEMPLATES == JAX_TEMPLATES
    assert len(PROMPT_TEMPLATES) == 85


def test_helpers_equal_jax():
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    assert ttok._PAT.pattern == jtok._PAT.pattern
    assert ttok._PAT.flags == jtok._PAT.flags
    for text in CATEGORIES + ["&amp;lt;b&amp;gt;", "a b c"]:
        assert ttok.basic_clean(text) == jtok.basic_clean(text)
        assert ttok.whitespace_clean(text) == jtok.whitespace_clean(text)


@pytest.mark.parametrize("table", sorted(TOY_TABLES))
def test_toy_tables_give_the_jax_ids(table):
    ours = ttok.CLIPTokenizer(TOY_TABLES[table])
    theirs = jtok.CLIPTokenizer(TOY_TABLES[table])
    assert ours.encoder == theirs.encoder
    assert (ours.sot_id, ours.eot_id) == (theirs.sot_id, theirs.eot_id)
    texts = _texts()
    np.testing.assert_array_equal(ours.tokenize(texts), theirs.tokenize(texts))
    for n in (5, 77):
        np.testing.assert_array_equal(
            ours.tokenize(texts, context_length=n),
            theirs.tokenize(texts, context_length=n))
    with pytest.raises(ValueError, match="too long"):
        ours.tokenize(["cat " * 80], truncate=False)


@pytest.mark.parametrize("n_merges", [300, 3000])
def test_generated_tables_give_the_jax_ids(tmp_path, n_merges):
    merges = synthetic_merges(CATEGORIES + PROMPT_TEMPLATES, n_merges)
    assert len(merges) == n_merges == len(set(merges))
    fp = str(tmp_path / "merges.txt.gz")
    write_merges(fp, merges)
    ours = ttok.CLIPTokenizer.from_file(fp, n_merges=n_merges)
    theirs = jtok.CLIPTokenizer.from_file(fp, n_merges=n_merges)
    assert ours.bpe_ranks == theirs.bpe_ranks
    texts = _texts()
    got = ours.tokenize(texts)
    np.testing.assert_array_equal(got, theirs.tokenize(texts))
    # every framed text ends in EOT, truncated ones included
    last = (got > 0).sum(axis=1) - 1
    assert (got[np.arange(len(got)), last] == ours.eot_id).all()
    assert (got[:, 0] == ours.sot_id).all()


def test_clip_sized_table_has_clips_vocabulary(tmp_path):
    """The card run's table: 48,894 merges, a vocabulary of 49,408 whose
    EOT is the highest id and fits the text tower's embedding rows."""
    fp = str(tmp_path / "bpe.txt.gz")
    write_merges(fp, synthetic_merges(PROMPT_TEMPLATES + ["dog", "cat"]))
    with gzip.open(fp, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    assert lines[0].startswith("#version") and len(lines) == CLIP_MERGES + 2
    tok = ttok.CLIPTokenizer.from_file(fp)
    assert len(tok.encoder) == CLIP_VOCAB
    assert (tok.sot_id, tok.eot_id) == (CLIP_VOCAB - 2, CLIP_VOCAB - 1)
    ids = tok.tokenize(_texts())
    assert ids.max() == CLIP_VOCAB - 1
    np.testing.assert_array_equal(
        ids, jtok.CLIPTokenizer.from_file(fp).tokenize(_texts()))
