"""CLIP's byte-level BPE tokenizer (the port's copy of
zutis_tpu/data/tokenizer.py, pure Python and numpy).

The reference calls `clip.tokenize` (OpenAI package) for category prompts
(reference networks/zutis.py:36, utils/extract_text_embeddings.py:107). That
tokenizer is byte-level BPE over a 49,408-entry vocabulary built entirely
from the `bpe_simple_vocab_16e6.txt.gz` merges file:
  vocab = 256 byte-units + 256 byte-units+'</w>' + one token per merge
          + <|startoftext|> + <|endoftext|>.
Given that merges file (plain text or .gz), the token ids are CLIP's.

Text is html-unescaped twice, whitespace-collapsed, lower-cased, and split by
CLIP's regex (contractions | letter runs | single digits | other-symbol runs,
underscore included); each piece is byte-mapped to printable unicode and
merged greedily by rank with a '</w>' word terminal. `tokenize` frames each
text as SOT ... EOT in 77 zero-padded ids, truncating to end in EOT.
"""
from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

# python `re` lacks \p{L}/\p{N}; [^\W\d_] == unicode letter, \d == digit.
# The symbol-run alternative must INCLUDE '_' (CLIP's [^\s\p{L}\p{N}]+
# counts underscore as a symbol, but \w covers it, so a bare [^\s\w]+
# would silently drop underscores from e.g. wnid-derived names like
# "great_white_shark" and diverge from clip.tokenize).
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Invertible byte -> printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, merges: Sequence[Tuple[str, str]]):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = list(merges)
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([self.SOT, self.EOT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        self.sot_id = self.encoder[self.SOT]
        self.eot_id = self.encoder[self.EOT]

    @classmethod
    def from_file(cls, path: str, n_merges: int = 48894) -> "CLIPTokenizer":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # first line is a version header; CLIP uses merges [1 : 49152-256-2+1]
        merges = [tuple(line.split()) for line in lines[1:n_merges + 1]]
        return cls(merges)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def tokenize(
        self, texts: Sequence[str] | str, context_length: int = 77,
        truncate: bool = True,
    ) -> np.ndarray:
        """-> [n, context_length] int32, SOT ... EOT zero-padded (clip.tokenize
        semantics)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"text too long: {text!r}")
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, :len(ids)] = ids
        return out
