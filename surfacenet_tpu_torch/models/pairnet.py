"""The 2D patch-embedding net that scores view pairs (the pair net).

Port of ``surfacenet_tpu/models/pairnet.py``.  Trained with a triplet loss
so that patches of one surface point seen from different views embed close
together; the embedding similarity of two views at a point says whether
they photograph it the same way (an occluded or specular view does not).

The net computes in float32 on NHWC patches, as the reference does: three
3x3 SAME convolutions, each with ReLU and 2x2 max pooling, then a dense
layer on the map flattened in (H, W, C) order, then L2 normalisation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surfacenet_tpu_torch.config import PairNetConfig


class PairNet(nn.Module):
    """Patches (B, P, P, 3) in [0, 1] -> L2-normalised embeddings (B, E)."""

    def __init__(self, cfg: PairNetConfig = PairNetConfig()):
        super().__init__()
        self.cfg = cfg
        chans = (3,) + tuple(cfg.channels)
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 3, padding=1) for a, b in zip(chans, chans[1:])
        )
        side = cfg.patch_size // 2 ** len(cfg.channels)
        self.dense = nn.Linear(side * side * chans[-1], cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2)
        # channels last before the flatten: the dense kernel's rows are in
        # the reference's (H, W, C) order
        x = self.dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))
        return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-8)


def init_pairnet(cfg: PairNetConfig, generator: torch.Generator) -> PairNet:
    """A ``PairNet`` with flax's default initialisation drawn from
    ``generator``: LeCun-normal kernels (truncated at two deviations) and
    zero biases.  The values are not flax's; only the distribution is."""
    model = PairNet(cfg)
    with torch.no_grad():
        for layer in (*model.convs, model.dense):
            w = layer.weight
            std = (1.0 / w[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            layer.bias.zero_()
    return model


def embed(model: PairNet, patches: torch.Tensor,
          chunk: int = 4096) -> torch.Tensor:
    """Embeddings of (..., P, P, 3) patches, ``chunk`` patches a forward
    (bounds the activations' memory; each patch's embedding does not
    depend on the chunk).  No gradients."""
    lead = patches.shape[:-3]
    flat = patches.reshape((-1,) + patches.shape[-3:])
    with torch.no_grad():
        out = [model(flat[i: i + chunk]) for i in range(0, len(flat), chunk)]
    emb = (torch.cat(out) if out else
           flat.new_zeros((0, model.cfg.embed_dim)))
    return emb.reshape(lead + (emb.shape[-1],))


def triplet_loss(anchor, positive, negative, margin: float):
    """Margin triplet loss on L2-normalised embeddings."""
    d_pos = torch.sum((anchor - positive) ** 2, dim=-1)
    d_neg = torch.sum((anchor - negative) ** 2, dim=-1)
    return torch.mean(torch.clamp(d_pos - d_neg + margin, min=0.0))


def embedding_similarity(ea, eb):
    """Cosine similarity mapped to [0, 1]; ea, eb (..., E) normalised."""
    return 0.5 * (1.0 + torch.sum(ea * eb, dim=-1))


def view_similarity_matrix(model: PairNet, patches: torch.Tensor,
                           valid: torch.Tensor | None = None,
                           chunk: int = 4096) -> torch.Tensor:
    """Learned (V, V) view similarity, aggregated over probes.

    ``patches[v, k]`` (V, K, P, P, 3) is probe k's patch in view v; views a
    and b score the mean over probes of their embeddings' similarity at the
    same probe.  With ``valid`` (V, K) bool only probes valid in both views
    count; a pair sharing none (and the diagonal, when no probe is valid in
    its view) reports a neutral 1.0.
    """
    emb = embed(model, patches, chunk)  # (V, K, E)
    sims = 0.5 * (1.0 + torch.einsum("ake,bke->abk", emb, emb))
    if valid is None:
        return sims.mean(dim=-1)
    w = (valid[:, None, :] & valid[None, :, :]).float()
    denom = w.sum(dim=-1)
    return torch.where(denom > 0,
                       (sims * w).sum(dim=-1) / torch.clamp(denom, min=1.0),
                       1.0)
