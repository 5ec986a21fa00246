"""Plain ZUTIS training loss: the pixel-wise cross-entropy of the text
logits, and a Hungarian-matched dice + binary cross-entropy mask loss over
every decoder layer (networks/zutis.py's criterion in NoelShin/zutis,
after Mask2Former's matcher).

  * CE: the text-space tokens resized bilinearly to the label size, logits
    = text . token, `F.cross_entropy` with `ignore_index`;
  * mask loss, each decoder layer: the proposals resized bilinearly to the
    label size (clipped to [0, 1] with the gradient passed straight
    through), cost[n, q] = dice + mean-pixel BCE (logs clamped at -100),
    the valid instances matched to queries by scipy's
    `linear_sum_assignment`, the matched costs summed over layers and
    instances, an image whose instances hold no pixel adding nothing, over
    the batch size.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment


def pair_costs(proposals, gt):
    """proposals [b, Q, H, W] in [0, 1], gt [b, N, H, W] {0, 1} ->
    dice + BCE [b, N, Q]."""
    hw = proposals.shape[-2] * proposals.shape[-1]
    inter = torch.einsum("bnhw,bqhw->bnq", gt, proposals)
    dice = 1.0 - (2.0 * inter + 1.0) / (
        proposals.sum((-2, -1))[:, None, :] + gt.sum((-2, -1))[:, :, None]
        + 1.0)
    log_d = torch.log(proposals).clamp(min=-100.0)
    log_1md = torch.log1p(-proposals).clamp(min=-100.0)
    bce = -(torch.einsum("bnhw,bqhw->bnq", gt, log_d - log_1md)
            + log_1md.sum((-2, -1))[:, None, :]) / hw
    return dice + bce


def match(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """cost [N, Q], valid [N] -> the query of each valid row (-1 else)."""
    cols = np.full(cost.shape[0], -1)
    rows = np.flatnonzero(valid)
    c = np.nan_to_num(cost[rows], nan=1e6, posinf=1e6, neginf=-1e6)
    r, q = linear_sum_assignment(c)
    cols[rows[r]] = q
    return cols


def losses(out, batch, text, ignore_index: int):
    """-> {"loss", "ce_loss", "mask_loss"} and the assignment [L, b, N]."""
    labels = batch["semantic_mask"].long()
    H, W = labels.shape[-2:]
    tokens = F.interpolate(out["patch_tokens"].permute(0, 3, 1, 2), size=(H, W),
                           mode="bilinear", align_corners=False)
    logits = torch.einsum("nc,bchw->bnhw", text, tokens)
    ce = F.cross_entropy(logits, labels, ignore_index=ignore_index)
    del logits, tokens

    gt = batch["instance_masks"].float()
    valid = batch["instance_valid"].bool()
    props = out["mask_proposals"]
    b, L = props.shape[:2]
    costs = []
    for layer in range(L):
        up = F.interpolate(props[:, layer], size=(H, W), mode="bilinear",
                           align_corners=False)
        up = up + (up.detach().clamp(0.0, 1.0) - up.detach())
        costs.append(pair_costs(up, gt))
    costs = torch.stack(costs)  # [L, b, N, Q]
    host = costs.detach().cpu().numpy()
    valid_h = valid.cpu().numpy()
    cols = np.stack([[match(host[l, i], valid_h[i]) for i in range(b)]
                     for l in range(L)])
    idx = torch.as_tensor(np.maximum(cols, 0), device=costs.device)
    matched = torch.gather(costs, -1, idx[..., None])[..., 0]
    matched = torch.where(valid[None], matched, 0.0).sum(-1).sum(0)  # [b]
    has_pixels = (gt * valid[..., None, None]).sum((1, 2, 3)) > 0
    mask_loss = torch.where(has_pixels, matched, 0.0).sum() / b
    return {"loss": mask_loss + ce, "ce_loss": ce, "mask_loss": mask_loss}, cols
