"""Inference post-processing: semantic argmax maps and query classification
(the port of `predict_semantic` and `classify_proposals` in
zutis_tpu/postproc/instance.py).
"""
from __future__ import annotations

import torch


def predict_semantic(
    patch_tokens: torch.Tensor,  # [b, h, w, text_dim]
    text_embeddings: torch.Tensor,  # [n_cat, text_dim]
) -> torch.Tensor:
    """-> [b, h, w] argmax category ids (int64) at the token grid."""
    logits = torch.einsum("nc,bhwc->bnhw", text_embeddings.float(),
                          patch_tokens.float())
    return logits.argmax(dim=1)


def classify_proposals(
    proposals: torch.Tensor,  # [b, Q, h, w] in [0, 1]
    binary: torch.Tensor,  # [b, Q, h, w] bool
    patch_tokens: torch.Tensor,  # [b, h, w, text_dim]
    text_embeddings: torch.Tensor,  # [n_cat, text_dim]
    temperature: float = 5.0,
):
    """Mask confidence = mean in-mask proposal probability; each query is
    classified by its L2-normalised masked-average patch token against the
    text embeddings through sigmoid(sim * temperature); final confidence =
    mask confidence * max category probability.
    -> (confidence [b, Q] f32, category_ids [b, Q] int64)."""
    sizes = binary.sum(dim=(-2, -1)).float()
    confidence = (proposals * binary).sum(dim=(-2, -1)) / (sizes + 1e-7)
    avg_tokens = torch.einsum(
        "bhwc,bqhw->bqc", patch_tokens.float(), binary.float()
    ) / (sizes[..., None] + 1e-7)
    avg_tokens = avg_tokens / (
        torch.linalg.vector_norm(avg_tokens, dim=-1, keepdim=True) + 1e-7)
    cat_probs = torch.sigmoid(
        torch.einsum("nc,bqc->bqn", text_embeddings.float(), avg_tokens)
        * temperature)
    category_ids = cat_probs.argmax(dim=-1)
    confidence = confidence * cat_probs.max(dim=-1).values
    return confidence, category_ids
