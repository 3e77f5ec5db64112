"""View-pair selection (geometric and learned) and gather deduplication.

Port of ``surfacenet_tpu/ops/view_pairs.py``.  Every candidate pair is
scored densely per cube (both cameras must see the cube; the weight peaks
at a preferred triangulation angle), optionally times a learned pair
similarity, and the top Nv are kept.  Ties keep the lower pair index first,
as ``lax.top_k`` does.

The learned scores come from the pair net (``models/pairnet.py``): a
scene-global (V, V) view similarity (``view_similarity_from_scene``,
``select_pairs_learned``), or per cube (``select_pairs_learned_local``, the
``reconstruct --pairnet`` selector): each view's photometric consensus at
the cube centre with the other views, turned into gates that exclude
confident outliers (occluded or specular views) at exactly the cubes they
corrupt.  Patches are cut and embedded on the device, in chunks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from surfacenet_tpu_torch.device import resolve_device
from surfacenet_tpu_torch.geometry.camera import (
    camera_center, cube_visible, project_crop,
)
from surfacenet_tpu_torch.models.pairnet import embed, view_similarity_matrix
from surfacenet_tpu_torch.train.train_pair import extract_patches


def candidate_pairs(n_views: int) -> np.ndarray:
    """All unordered view pairs, (P, 2) int32."""
    a, b = np.triu_indices(n_views, k=1)
    return np.stack([a, b], axis=-1).astype(np.int32)


def pair_angle_weight(cos_angle, preferred_deg: float = 20.0,
                      sigma_deg: float = 15.0):
    """Gaussian weight on the pair's triangulation angle at the cube."""
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos_angle, -1.0, 1.0)))
    return torch.exp(-0.5 * ((ang - preferred_deg) / sigma_deg) ** 2)


def select_pairs_scored(
    Ps: np.ndarray,
    origins: np.ndarray,
    n_pairs: int,
    image_hw: Tuple[int, int],
    extent_mm: float,
    pair_sim=None,
    dist_sigma_frac: float = 0.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Score every candidate pair per cube, then keep the top Nv.

    The score is the geometric weight (both cameras see the cube; a
    Gaussian in the triangulation angle; with ``dist_sigma_frac`` > 0 a
    proximity factor), times ``pair_sim`` clipped to [0, 1] when given:
    (P,) for every cube or (N, P) per cube.  The similarity multiplies
    BEFORE the cut, so a pair it scores low leaves the selection, and with
    it the pooling vote.  Scores are float32 on ``device``.

    Returns (pair_idx (N, Nv, 2) int32, weights (N, Nv) float32), numpy.
    """
    dev = resolve_device(device)
    Ps = torch.as_tensor(np.asarray(Ps), dtype=torch.float32, device=dev)
    origins = torch.as_tensor(
        np.asarray(origins), dtype=torch.float32, device=dev
    )
    pairs = torch.as_tensor(candidate_pairs(Ps.shape[0]), device=dev).long()

    vis = cube_visible(Ps, origins, float(extent_mm), image_hw)  # (N, V)
    centers = origins + float(extent_mm) / 2.0
    cams = camera_center(Ps)  # (V, 3)
    va = cams[pairs[:, 0]][None] - centers[:, None]  # (N, P, 3)
    vb = cams[pairs[:, 1]][None] - centers[:, None]
    da = torch.linalg.norm(va, dim=-1)
    db = torch.linalg.norm(vb, dim=-1)
    va = va / (da[..., None] + 1e-8)
    vb = vb / (db[..., None] + 1e-8)
    w = pair_angle_weight(torch.sum(va * vb, dim=-1))  # (N, P)
    if dist_sigma_frac > 0:
        d_view = torch.linalg.norm(cams[None] - centers[:, None], dim=-1)
        d_ref = torch.where(vis, d_view, torch.inf).amin(dim=1, keepdim=True)
        d_ref = torch.where(torch.isfinite(d_ref), d_ref, 1.0)
        w = w * torch.exp(
            -(((da + db) / 2 - d_ref) / (dist_sigma_frac * d_ref)) ** 2
        )
    both_vis = vis[:, pairs[:, 0]] & vis[:, pairs[:, 1]]
    w = torch.where(both_vis, w, 0.0)
    if pair_sim is not None:
        sim = torch.as_tensor(np.array(pair_sim, np.float32), device=dev)
        w = w * torch.clamp(sim.reshape(-1, sim.shape[-1]), 0.0, 1.0)

    top_w, top_i = torch.sort(w, dim=1, descending=True, stable=True)
    top_w, top_i = top_w[:, :n_pairs].clone(), top_i[:, :n_pairs]
    sel = pairs[top_i].to(torch.int32)  # (N, n_pairs, 2)
    # fewer visible pairs than n_pairs: weights are 0 and fusion's
    # denominator handles it; the best pair keeps a tiny floor
    top_w[:, 0] = torch.clamp(top_w[:, 0], min=1e-3)
    return sel.cpu().numpy(), top_w.cpu().numpy()


def select_pairs_geometric(
    Ps: np.ndarray,
    origins: np.ndarray,
    n_pairs: int,
    image_hw: Tuple[int, int],
    extent_mm: Optional[float] = None,
    dist_sigma_frac: float = 0.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Geometric top-Nv pair selection: ``select_pairs_scored`` without a
    learned similarity."""
    if extent_mm is None:
        raise ValueError("extent_mm required")
    return select_pairs_scored(Ps, origins, n_pairs, image_hw, extent_mm,
                               dist_sigma_frac=dist_sigma_frac, device=device)


def dedup_view_slots(
    pair_idx: np.ndarray, k: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cube unique-view table + per-pair-half slot indices.

    The gather runs once per (cube, distinct view); pairs index into it.

    Args:
      pair_idx: (N, P, 2) int view indices per cube pair.
      k: table width; defaults to the batch max unique count.

    Returns:
      (uniq (N, K) int32 ascending unique views, -1 padded at the end;
       slots (N, P, 2) int32 with uniq[n, slots[n,p,h]] == pair_idx[n,p,h]).
    """
    pi = np.asarray(pair_idx)
    N = pi.shape[0]
    flat = pi.reshape(N, -1).astype(np.int64)
    order = np.argsort(flat, axis=1, kind="stable")
    sf = np.take_along_axis(flat, order, axis=1)
    new = np.ones_like(sf, bool)
    new[:, 1:] = sf[:, 1:] != sf[:, :-1]
    rank = np.cumsum(new, axis=1) - 1
    n_uniq = rank[:, -1] + 1
    kk = int(n_uniq.max()) if k is None else int(k)
    if (n_uniq > kk).any():
        raise ValueError(
            f"dedup_view_slots: k={kk} < max unique views {n_uniq.max()}"
        )
    uniq = np.full((N, kk), -1, np.int32)
    rows = np.repeat(np.arange(N), flat.shape[1])
    uniq[rows, rank.reshape(-1)] = sf.reshape(-1).astype(np.int32)
    slots = np.empty_like(flat, dtype=np.int32)
    np.put_along_axis(slots, order, rank.astype(np.int32), axis=1)
    return uniq, slots.reshape(pi.shape).astype(np.int32)


def crop_centers(Ps, points, image_hw: Tuple[int, int], patch_size: int,
                 device="cuda"):
    """Where each view crops each point's patch.

    Returns uv (V, N, 2) float32, the crop centres (points behind a camera
    moved to -1e6, off the image, so their patch is all zero), and valid
    (V, N) bool: in front of the camera with the whole patch on the image.
    Tensors on ``device``.
    """
    dev = resolve_device(device)
    Ps = torch.as_tensor(np.asarray(Ps), dtype=torch.float32, device=dev)
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32,
                          device=dev)
    H, W = image_hw
    half = patch_size / 2
    uvs, valids = [], []
    for v in range(Ps.shape[0]):
        uv, w = project_crop(Ps[v], pts)
        uv = torch.where(w[:, None] > 0, uv, -1e6)
        valids.append((w > 0) & (uv[:, 0] >= half) & (uv[:, 0] < W - half)
                      & (uv[:, 1] >= half) & (uv[:, 1] < H - half))
        uvs.append(uv)
    return torch.stack(uvs), torch.stack(valids)


def _embed_crops(images, uv, model, patch_size: int, chunk: int):
    """Embeddings (V, N, E) of every view's crops at ``uv`` (V, N, 2), cut
    and embedded ``chunk`` crops at a time."""
    V, N = uv.shape[:2]
    views = torch.arange(V, device=uv.device).repeat_interleave(N)
    flat = uv.reshape(V * N, 2)
    out = [
        embed(model, extract_patches(images, views[i: i + chunk],
                                     flat[i: i + chunk], patch_size))
        for i in range(0, V * N, chunk)
    ]
    return torch.cat(out).reshape(V, N, -1)


def view_similarity_from_scene(images, Ps, bbox_min, bbox_max, model,
                               patch_size: int, n_points: int = 16,
                               seed: int = 0, device="cuda") -> np.ndarray:
    """The scene-global (V, V) learned view similarity.

    ``n_points`` probes drawn uniformly in the bbox (``np.random`` with
    ``seed``, as the reference) are cropped in every view and embedded;
    pairs score their mean per-probe similarity over probes valid in both
    (``models/pairnet.py::view_similarity_matrix``).  ``model`` is a
    ``PairNet`` on ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(np.asarray(bbox_min, np.float64),
                      np.asarray(bbox_max, np.float64), size=(n_points, 3))
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                           device=dev)
    uv, valid = crop_centers(Ps, pts, imgs.shape[1:3], patch_size, dev)
    V = uv.shape[0]
    views = torch.arange(V, device=dev).repeat_interleave(n_points)
    patches = extract_patches(imgs, views, uv.reshape(-1, 2), patch_size)
    sim = view_similarity_matrix(
        model, patches.reshape((V, n_points) + patches.shape[1:]), valid)
    return sim.cpu().numpy()


def select_pairs_learned(Ps, origins, n_pairs: int,
                         image_hw: Tuple[int, int], extent_mm: float,
                         similarity, device="cuda"):
    """Scene-global learned selection: the geometric score times the
    (V, V) learned view similarity of each pair (in [0, 1]), before the
    top-Nv cut."""
    pairs = candidate_pairs(np.asarray(Ps).shape[0])
    sim = np.asarray(similarity, np.float32)
    return select_pairs_scored(Ps, origins, n_pairs, image_hw, extent_mm,
                               pair_sim=sim[pairs[:, 0], pairs[:, 1]],
                               device=device)


def cube_view_consensus(images, Ps, centers, model, patch_size: int,
                        device="cuda", chunk: int = 2048):
    """Per (cube, view) learned photometric consensus.

    Each view crops the patch around the cube centre's projection; view v's
    consensus at a cube is its mean embedding similarity to every OTHER
    view whose crop is valid there (0 with none).  A view whose sight of
    the cube is blocked or specular photographs something else and scores
    low at exactly that cube.  ``model`` is a ``PairNet`` on ``device``;
    crops are cut and embedded ``chunk`` at a time (the result does not
    depend on it).

    Returns consensus (N, V) float32 in [0, 1] and valid (N, V) bool, numpy.
    """
    dev = resolve_device(device)
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                           device=dev)
    uv, valid = crop_centers(Ps, centers, imgs.shape[1:3], patch_size, dev)
    emb = _embed_crops(imgs, uv, model, patch_size, chunk)  # (V, N, E)
    sim = 0.5 * (1.0 + torch.einsum("vne,wne->vwn", emb, emb))  # (V, V, N)
    pm = valid[:, None, :] & valid[None, :, :]
    pm &= ~torch.eye(pm.shape[0], dtype=torch.bool, device=dev)[..., None]
    cnt = pm.sum(dim=1)  # (V, N)
    consensus = (sim * pm).sum(dim=1) / torch.clamp(cnt, min=1)
    consensus = torch.where(cnt > 0, consensus, 0.0)
    return consensus.T.cpu().numpy(), valid.T.cpu().numpy()


def consensus_gates(
    consensus: np.ndarray,
    valid: np.ndarray,
    z_clip: float = 4.0,
    mad_floor: float = 0.02,
    z_dead: float = 2.0,
    sharpness: float = 2.0,
) -> np.ndarray:
    """Per-cube view gates in (0, 1] from consensus scores (host numpy).

    Within each cube each view's consensus is z-scored against the median
    and MAD (floored at ``mad_floor``) of the cube's valid views.  Views at
    z >= -z_dead keep gate exactly 1, so a cube with no confident outlier
    ranks its pairs by geometry alone; below it the gate decays over a
    ``z_clip``-wide band toward 0.  Invalid views carry no evidence and
    keep gate 1.  The medians are numpy's (the mean of the two middle
    values at an even count).
    """
    c = np.where(valid, consensus, np.nan)
    all_invalid = ~valid.any(axis=1, keepdims=True)
    # an all-invalid cube gets gate 1 below; a finite row keeps nanmedian
    # from warning on it
    c = np.where(all_invalid, 0.0, c)
    mu = np.nanmedian(c, axis=1, keepdims=True)
    mad = np.nanmedian(np.abs(c - mu), axis=1, keepdims=True) * 1.4826
    z = (consensus - mu) / np.maximum(mad, mad_floor)
    arg = sharpness * np.clip(z + z_dead, -z_clip, 0.0)
    gate = 2.0 / (1.0 + np.exp(-arg))
    return np.where(valid, gate, 1.0).astype(np.float32)


def select_pairs_learned_local(Ps, origins, n_pairs: int,
                               image_hw: Tuple[int, int], extent_mm: float,
                               images, model, patch_size: int,
                               device="cuda"):
    """Cube-local learned pair selection (the ``reconstruct --pairnet``
    selector): each candidate pair scores its geometric weight times
    ``gate[cube, a] * gate[cube, b]`` (``consensus_gates`` of
    ``cube_view_consensus`` at the cube centres), so an occluded view
    leaves fusion and the pooling vote at the cubes it corrupts while the
    rest of the scene keeps the geometric ranking.  ``model`` is a
    ``PairNet`` on ``device``.
    """
    centers = np.asarray(origins, np.float64) + float(extent_mm) / 2.0
    consensus, valid = cube_view_consensus(images, Ps, centers, model,
                                           patch_size, device)
    gates = consensus_gates(consensus, valid)  # (N, V)
    pairs = candidate_pairs(np.asarray(Ps).shape[0])
    pair_sim = gates[:, pairs[:, 0]] * gates[:, pairs[:, 1]]  # (N, P)
    return select_pairs_scored(Ps, origins, n_pairs, image_hw, extent_mm,
                               pair_sim=pair_sim, device=device)
