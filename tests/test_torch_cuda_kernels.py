"""CUDA kernels of the port against their plain PyTorch versions.

Needs an NVIDIA card (sm_90a) and nvcc; each test skips with a reason where
there is none.  This file imports neither JAX nor the JAX package, so it
also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
from surfacenet_tpu_torch.ops.cuda.affine_vote import affine_vote
from surfacenet_tpu_torch.ops.cuda.warp_gather import warp_gather
from surfacenet_tpu_torch.ops.cvc import build_cvc_views
from surfacenet_tpu_torch.ops.ray_pooling import (
    ray_vote_affine_plain, vote_params,
)

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(n_views=4, hw=(96, 128))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_warp_gather_kernel_matches_plain(cuda, scene, dtype):
    rng = np.random.default_rng(0)
    D, s, B = 32, 1.5, 7
    images = torch.as_tensor(scene.images, device=cuda).to(dtype).contiguous()
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=cuda)
    views = torch.as_tensor(rng.integers(0, 4, B), dtype=torch.int32,
                            device=cuda)
    origins = torch.as_tensor(rng.uniform(-40, 0, (B, 3)),
                              dtype=torch.float32, device=cuda)
    before = warp_gather.launches
    ck, vk = warp_gather(images, Ps, views, origins, D=D, s=s)
    cp, vp = build_cvc_views(images, Ps, views, origins, D, s)
    torch.cuda.synchronize()
    assert warp_gather.launches == before + 1
    assert (vk == vp).float().mean().item() >= 0.9999
    both = vk & vp
    assert (ck - cp).abs()[both].max().item() <= 1e-3
    assert (ck[~vk] == 0).all()


@pytest.mark.parametrize("window", [0, 2])
def test_affine_vote_kernel_matches_plain(cuda, scene, window):
    rng = np.random.default_rng(1)
    D, s, N, K = 32, 1.5, 5, 4
    fused = torch.as_tensor(rng.uniform(size=(N, D, D, D)),
                            dtype=torch.float32, device=cuda)
    origins = torch.as_tensor(rng.uniform(-40, 0, (N, 3)),
                              dtype=torch.float32, device=cuda)
    Ps_pool = torch.as_tensor(scene.Ps[rng.integers(0, 4, (N, K))],
                              dtype=torch.float32, device=cuda)
    mask = torch.ones((N, K), dtype=torch.bool, device=cuda)
    mask[0, 3] = False
    axis, slopes = vote_params(origins, s, Ps_pool, mask, D)
    before = affine_vote.launches
    vk = affine_vote(fused, axis, slopes, window)
    vp = ray_vote_affine_plain(fused, axis, slopes, window)
    torch.cuda.synchronize()
    assert affine_vote.launches == before + 1
    assert (vk == vp).float().mean().item() >= 0.9999


def test_kernels_reject_bad_inputs(cuda):
    images = torch.zeros((2, 8, 8, 3), dtype=torch.float16, device=cuda)
    Ps = torch.zeros((2, 3, 4), device=cuda)
    with pytest.raises(TypeError):
        warp_gather(images, Ps, torch.zeros(1, dtype=torch.int32,
                                            device=cuda),
                    torch.zeros((1, 3), device=cuda), D=4, s=1.0)
    fused = torch.zeros((1, 4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        affine_vote(fused, torch.zeros((1, 2), dtype=torch.int64,
                                       device=cuda),
                    torch.zeros((1, 2, 2), device=cuda))
