"""Training criterion (the port of zutis_tpu/losses/criterion.py): pixel-wise
text-embedding cross-entropy plus a Hungarian-matched dice + BCE mask loss
over every decoder layer.

  * CE: the text-space patch tokens are resized bilinearly to the label
    size, logits are `text_embeddings . tokens` with the class axis last,
    and the max-free bounded cross-entropy ignores `ignore_index`; the
    argmax of the same logits is the step's semantic prediction.
  * Mask loss: per decoder layer, a [b, N, Q] cost of dice (at feature
    resolution, against the GT projected down by the resize's transpose
    W_h^T gt W_w) plus mean-pixel BCE (at full resolution, proposals clipped
    to [0, 1] straight through); each layer's cost under activation
    checkpointing. Padded rows cost 0, non-finite costs are replaced before
    matching, and ONE matcher call solves all L * b problems; the matched,
    unguarded costs are summed over layers and valid rows, an image whose
    GT holds no pixel adds nothing, and the sum is divided by b. The costs
    through the matcher and the gather are the `train.matcher` span
    (core/profiling.py).

On a mesh (parallel/mesh.py) each data rank holds a slice of the batch:
the CE's count of valid pixels is summed over the data group before it
divides, and the mask loss divides by the global batch, so the data ranks'
losses, and their gradients, sum to the one-device ones.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from zutis_tpu_torch.core.device import to_device
from zutis_tpu_torch.core.profiling import span
from zutis_tpu_torch.ops.hungarian import batched_hungarian
from zutis_tpu_torch.ops.resize import _resize_matrix, resize_2d


def dice_cost(dt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """dt [..., Q, HW] in [0, 1], gt [..., N, HW] in {0, 1} -> [..., N, Q]."""
    numerator = 2.0 * torch.einsum("...nc,...qc->...nq", gt.float(), dt.float())
    denominator = dt.sum(-1)[..., None, :] + gt.sum(-1)[..., :, None]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def bce_cost(dt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pairwise mean-pixel binary cross-entropy -> [..., N, Q], as two
    products: (-(log d - log(1 - d)) . g - sum(log(1 - d))) / HW, each log
    clamped at -100 as torch's BCE does."""
    hw = dt.shape[-1]
    log_d = torch.clamp(torch.log(dt), min=-100.0)
    log_1md = torch.clamp(torch.log1p(-dt), min=-100.0)
    term_g = torch.einsum("...nc,...qc->...nq", gt.float(), log_d - log_1md)
    term_const = log_1md.sum(-1)[..., None, :]
    return -(term_g + term_const) / hw


def dice_cost_2d(dt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """dice_cost on unflattened dt [b, Q, H, W] and gt [b, N, H, W]."""
    numerator = 2.0 * torch.einsum("bnhw,bqhw->bnq", gt.float(), dt.float())
    denominator = (dt.sum((-2, -1))[:, None, :] + gt.sum((-2, -1))[:, :, None])
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def bce_cost_2d(dt: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """bce_cost on unflattened [b, ., H, W] tensors."""
    hw = dt.shape[-2] * dt.shape[-1]
    log_d = torch.clamp(torch.log(dt), min=-100.0)
    log_1md = torch.clamp(torch.log1p(-dt), min=-100.0)
    term_g = torch.einsum("bnhw,bqhw->bnq", gt.float(), log_d - log_1md)
    term_const = log_1md.sum((-2, -1))[:, None, :]
    return -(term_g + term_const) / hw


def cross_entropy_ignore(
    logits: torch.Tensor,  # [b, n_cat, H, W], or [b, H, W, n_cat] channels_last
    labels: torch.Tensor,  # [b, H, W] int
    ignore_index: int,
    channels_last: bool = False,
    bounded: bool = False,
    group=None,
) -> torch.Tensor:
    """Mean cross-entropy over the pixels whose label is not `ignore_index`;
    with a process `group`, the pixels of its ranks' batches: this rank's
    sum over the group's count.

    bounded=True asserts |logits| is small (unit-norm tokens against
    unit-norm text give |x| <= 1) and takes the max-free log(sum exp(x)) -
    x_label, with exp's input clamped at 30 straight through: exact in
    bound, finite out of it, and no stored clamp predicate for the
    backward."""
    axis = -1 if channels_last else 1
    x = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long().unsqueeze(axis)
    count = valid.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    count = count.clamp(min=1)
    if bounded:
        xc = x + (x.detach().clamp(max=30.0) - x.detach())
        sumexp = torch.exp(xc).sum(dim=axis)
        picked = torch.gather(x, axis, safe).squeeze(axis)
        losses = torch.where(valid, torch.log(sumexp) - picked, 0.0)
        return losses.sum() / count
    picked = torch.gather(torch.log_softmax(x, dim=axis), axis, safe).squeeze(axis)
    return torch.where(valid, -picked, 0.0).sum() / count


class Criterion:
    """Callable with the reference Criterion's interface."""

    def __init__(self, text_embeddings: torch.Tensor,
                 weight_ce_loss: float = 1.0, weight_mask_loss: float = 1.0,
                 weight_dice_loss: float = 1.0, weight_bce_loss: float = 1.0,
                 ignore_index: int = 255):
        self.text_embeddings = text_embeddings
        self.weight_ce_loss = weight_ce_loss
        self.weight_mask_loss = weight_mask_loss
        self.weight_dice_loss = weight_dice_loss
        self.weight_bce_loss = weight_bce_loss
        self.ignore_index = ignore_index

    def __call__(self, mask_proposals, gt_instance_masks, instance_valid,
                 patch_tokens, gt_semantic_masks) -> Dict[str, torch.Tensor]:
        return criterion_loss(
            mask_proposals, gt_instance_masks, instance_valid, patch_tokens,
            gt_semantic_masks, self.text_embeddings,
            weight_ce_loss=self.weight_ce_loss,
            weight_mask_loss=self.weight_mask_loss,
            weight_dice_loss=self.weight_dice_loss,
            weight_bce_loss=self.weight_bce_loss,
            ignore_index=self.ignore_index,
        )


def criterion_loss(
    mask_proposals: torch.Tensor,  # [b, L, Q, h, w] in [0, 1]
    gt_instance_masks: torch.Tensor,  # [b, N_max, H, W] float {0, 1}
    instance_valid: torch.Tensor,  # [b, N_max] bool
    patch_tokens: torch.Tensor,  # [b, h, w, text_dim]
    gt_semantic_masks: torch.Tensor,  # [b, H, W] int
    text_embeddings: torch.Tensor,  # [n_cat, text_dim]
    weight_ce_loss: float = 1.0,
    weight_mask_loss: float = 1.0,
    weight_dice_loss: float = 1.0,
    weight_bce_loss: float = 1.0,
    ignore_index: int = 255,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """-> {"loss", "ce_loss", "mask_loss"} scalars, "sem_pred" [b, H, W]
    int32 (no gradient) and "query_indices" [L, b, N] int32, the query
    matched to each instance. On a `mesh` the batch is this data rank's
    slice and the losses its share of the global batch's."""
    b, L, Q = mask_proposals.shape[:3]
    n_max = gt_instance_masks.shape[1]
    H, W = gt_instance_masks.shape[-2:]
    if n_max > Q:
        raise ValueError(
            f"more instances ({n_max}) than queries ({Q}): each instance is "
            "matched to a distinct query")
    dev = mask_proposals.device

    # ===== cross-entropy =====
    tokens = resize_2d(patch_tokens.permute(0, 3, 1, 2), (H, W), mode="linear")
    logits = torch.einsum("nc,bchw->bhwn", text_embeddings.float(), tokens.float())
    del tokens
    ce = cross_entropy_ignore(logits, gt_semantic_masks, ignore_index,
                              channels_last=True, bounded=True,
                              group=None if mesh is None else mesh.data_group)
    # argmax(resize(einsum)) == argmax(einsum(resize)): the resize is
    # linear per channel, so the CE's logits give the semantic prediction
    sem_pred = logits.detach().argmax(dim=-1).to(torch.int32)
    del logits

    # ===== mask loss =====
    gt4 = gt_instance_masks.float()
    hf, wf = mask_proposals.shape[-2:]
    wh = to_device(torch.from_numpy(_resize_matrix(hf, H, "linear")), dev)
    ww = to_device(torch.from_numpy(_resize_matrix(wf, W, "linear")), dev)
    # the transpose of resize_2d: gt projected down to the feature grid once
    gt_t = torch.einsum("ow,bnho->bnhw", ww, gt4)
    gt_t = torch.einsum("oh,bnow->bnhw", wh, gt_t)  # [b, N, hf, wf]
    ones_t = wh.sum(0)[:, None] * ww.sum(0)[None, :]  # [hf, wf]
    gt_area = gt4.sum((-2, -1))  # [b, N]

    def dice_cost_projected(p_l: torch.Tensor) -> torch.Tensor:
        """dice_cost_2d(resize(p_l), gt4) at feature resolution: <gt,
        resize(P)> == <resize^T(gt), P>."""
        numerator = 2.0 * torch.einsum("bnij,bqij->bnq", gt_t, p_l)
        sum_up = torch.einsum("bqij,ij->bq", p_l, ones_t)
        denominator = sum_up[:, None, :] + gt_area[:, :, None]
        return 1.0 - (numerator + 1.0) / (denominator + 1.0)

    def cost_layer(proposals_l: torch.Tensor) -> torch.Tensor:
        """proposals_l [b, Q, h, w] -> dice + BCE cost [b, N, Q]."""
        up = resize_2d(proposals_l, (H, W), mode="linear")
        # guard the logs against resize rounding outside [0, 1], with an
        # identity gradient
        up = up + (up.detach().clamp(0.0, 1.0) - up.detach())
        return (weight_dice_loss * dice_cost_projected(proposals_l)
                + weight_bce_loss * bce_cost_2d(up, gt4))

    # the per-layer costs through the matcher and the gather
    with span("train.matcher", device=dev.type == "cuda"):
        # each layer's full-resolution proposals are recomputed in the
        # backward instead of being kept ([L, b, Q, H, W] f32 would be ~13 GB)
        costs = torch.stack([
            checkpoint(cost_layer, mask_proposals[:, layer],
                       use_reentrant=False,
                       # the layer cost draws no random numbers
                       preserve_rng_state=False)
            for layer in range(L)])  # [L, b, N, Q]

        # padded rows cost a constant (0) and do not move the real rows'
        # matching; non-finite costs would stall the matcher, so they are
        # replaced for matching only and still reach the loss
        valid = instance_valid.bool()
        cost_for_match = torch.where(valid[None, :, :, None], costs.detach(),
                                     0.0)
        cost_for_match = torch.nan_to_num(cost_for_match, nan=1e6,
                                          posinf=1e6, neginf=-1e6)
        col4rows = batched_hungarian(
            cost_for_match.reshape(L * b, n_max, Q)).reshape(L, b, n_max)
        matched = torch.gather(costs, -1, col4rows[..., None].long())[..., 0]
    matched = torch.where(valid[None], matched, 0.0)
    per_image_layers = matched.sum(-1)  # [L, b]
    # an image whose valid GT masks hold no pixel adds nothing
    gt_pixels = (gt4 * valid[..., None, None]).sum(dim=(1, 2, 3))
    per_image = torch.where(gt_pixels > 0, per_image_layers.sum(0), 0.0)
    mask_loss = per_image.sum() / (b if mesh is None else b * mesh.data_size)

    loss = weight_mask_loss * mask_loss + weight_ce_loss * ce
    return {"loss": loss, "ce_loss": ce, "mask_loss": mask_loss,
            "sem_pred": sem_pred, "query_indices": col4rows}
