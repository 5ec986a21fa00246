"""Category text embeddings with prompt engineering (the port of
zutis_tpu/retrieval/text_embeddings.py).

Behavioural contract (reference utils/extract_text_embeddings.py:98-141):
for each category, embed all 85 templated prompts with the CLIP text
encoder, L2-normalise each, average, L2-normalise the mean -> one float32
embedding per category, optionally pickled as {category: embedding}.
`plain_category_embeddings` gives the ZUTIS classifier head's plain
(template-free) embeddings: the raw category names, one prompt each,
normalised (reference networks/zutis.py:35-38).

Tokenization is host-side BPE (data/tokenizer.py); the tower runs on its
own device in batches of 256 prompts, every category's prompts in one
stream. The reductions run in numpy on the host, as the JAX package's do.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from zutis_tpu_torch.data.tokenizer import CLIPTokenizer
from zutis_tpu_torch.retrieval.prompts import PROMPT_TEMPLATES


def encode_texts(text_encoder, tokenizer: CLIPTokenizer, texts: List[str],
                 batch_size: int = 256) -> np.ndarray:
    """-> [n, embed_dim] float32, the unnormalised CLIP text embeddings of
    `texts` from the port's `CLIPTextEncoder`, `batch_size` prompts a
    forward."""
    tokens = torch.from_numpy(tokenizer.tokenize(texts))
    outs = []
    with torch.no_grad():
        for i in range(0, len(tokens), batch_size):
            outs.append(text_encoder(tokens[i:i + batch_size]).float().cpu())
    return torch.cat(outs).numpy().astype(np.float32)


def plain_category_embeddings(text_encoder, tokenizer: CLIPTokenizer,
                              categories: List[str]) -> np.ndarray:
    """ZUTIS classifier-head embeddings: raw category names, unit-norm
    (reference networks/zutis.py:35-38)."""
    emb = encode_texts(text_encoder, tokenizer, categories)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def prompt_engineered_embeddings(
    text_encoder, tokenizer: CLIPTokenizer, categories: List[str],
    templates: Optional[List[str]] = None, fp: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Retrieval embeddings: the 85-template mean (reference
    extract_text_embeddings.py:98-141); a single template gives its
    unnormalised embedding. Optionally pickles to `fp` in the reference's
    {category: np.ndarray} format."""
    templates = PROMPT_TEMPLATES if templates is None else templates
    texts = [t.format(c) for c in categories for t in templates]
    emb_all = encode_texts(text_encoder, tokenizer, texts)
    out: Dict[str, np.ndarray] = {}
    n = len(templates)
    for i, category in enumerate(categories):
        emb = emb_all[i * n:(i + 1) * n]
        if n == 1:
            out[category] = emb[0].copy()
        else:
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
            avg = emb.mean(axis=0)
            out[category] = (avg / np.linalg.norm(avg)).astype(np.float32)
    if fp is not None:
        with open(fp, "wb") as f:
            pickle.dump(out, f)
    return out
