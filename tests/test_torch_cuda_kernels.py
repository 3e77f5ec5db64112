"""CUDA kernels of the port against their plain PyTorch versions.

Needs an NVIDIA card (sm_90a) and nvcc; each test skips with a reason where
there is none.  This file imports neither JAX nor the JAX package, so it
also runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from surfacenet_tpu_torch.config import (
    Config, ModelConfig, VoxelConfig, baseline_config,
)
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
from surfacenet_tpu_torch.models.surfacenet import (
    fused_infer_apply, fused_params, init_surfacenet, make_predictor,
)
from surfacenet_tpu_torch.ops.conv3d import conv3d_plain
from surfacenet_tpu_torch.ops.cuda.affine_pool import (
    affine_pool, ray_max_mask_affine_cuda,
)
from surfacenet_tpu_torch.ops.cuda.affine_vote import affine_route, affine_vote
from surfacenet_tpu_torch.ops.cuda.conv3d import (
    HALO_MAX_DIL, _kernel_fn, _run, conv3d, conv3d_route,
)
from surfacenet_tpu_torch.ops.cuda.warp_gather import (
    build_cvc_batch_cuda, warp_gather,
)
from surfacenet_tpu_torch.ops.cvc import build_cvc_batch, build_cvc_views
from surfacenet_tpu_torch.ops.ray_pooling import (
    ray_max_mask_affine_batch, ray_max_mask_affine_plain,
    ray_vote_affine_plain, vote_params,
)
from surfacenet_tpu_torch.pipeline.sweep import gather_images
from surfacenet_tpu_torch.train import train_surface

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene():
    return make_sphere_scene(n_views=4, hw=(96, 128))


@pytest.mark.parametrize("D", [32, 16, 17, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_warp_gather_kernel_matches_plain(cuda, scene, dtype, D):
    """On the sweep's RGBx copy; D 17 ends every run of k in a ragged tail
    and stores voxel by voxel; the cube spans 48 mm at every D."""
    rng = np.random.default_rng(0)
    s, B = 48.0 / D, 7
    images = gather_images(torch.as_tensor(scene.images, device=cuda), dtype)
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
    if dtype == torch.int8:  # integer sums, --fmad=false: bitwise
        assert torch.equal(ck, cp) and torch.equal(vk, vp)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_warp_gather_repeat_launch_is_bitwise(cuda, scene, dtype):
    """Two launches on the same inputs give the same bits, and three-channel
    images (which the wrapper copies to RGBx) the same bits as the sweep's
    RGBx copy."""
    rng = np.random.default_rng(2)
    D, s, B = 64, 0.75, 5
    rgbx = gather_images(torch.as_tensor(scene.images, device=cuda), dtype)
    assert rgbx.shape == scene.images.shape[:3] + (4,)
    assert (rgbx[..., 3] == 0).all()
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=cuda)
    views = torch.as_tensor(rng.integers(0, 4, B), dtype=torch.int32,
                            device=cuda)
    origins = torch.as_tensor(rng.uniform(-40, 0, (B, 3)),
                              dtype=torch.float32, device=cuda)
    before = warp_gather.launches
    first = warp_gather(rgbx, Ps, views, origins, D=D, s=s)
    second = warp_gather(rgbx, Ps, views, origins, D=D, s=s)
    three = warp_gather(rgbx[..., :3].contiguous(), Ps, views, origins, D=D,
                        s=s)
    torch.cuda.synchronize()
    assert warp_gather.launches == before + 3
    assert first[1].any()
    for other in (second, three):
        assert torch.equal(first[0], other[0])
        assert torch.equal(first[1], other[1])


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
    routes = dict(affine_vote.route_launches)
    vk = affine_vote(fused, axis, slopes, window)
    vp = ray_vote_affine_plain(fused, axis, slopes, window)
    torch.cuda.synchronize()
    assert affine_vote.launches == before + 1
    route = "tile" if window else "segment"
    assert affine_vote.route_launches[route] == routes[route] + 1
    assert torch.equal(vk, vp)


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


def within_one_bf16_ulp(got, ref):
    """|kernel - plain| <= 2^-7 |plain| + 1e-3 rms(plain), elementwise."""
    got, ref = got.float(), ref.float()
    rms = ref.pow(2).mean().sqrt()
    return (got - ref).abs() <= 2.0**-7 * ref.abs() + 1e-3 * rms


def conv_inputs(device, B, R, cin, cout, seed):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((B, R, R, R, cin), generator=g, device=device).to(
        torch.bfloat16)
    w = (torch.randn((27 * cin, cout), generator=g, device=device)
         / (27 * cin) ** 0.5).to(torch.bfloat16)
    b = torch.randn((cout,), generator=g, device=device) * 0.1
    return x, w, b


@pytest.mark.parametrize("cin,cout,dil,R,relu", [
    (6, 32, 1, 16, True), (32, 128, 1, 8, True), (128, 128, 2, 8, True),
    (128, 256, 2, 8, True),
    (32, 8, 1, 8, True), (128, 72, 1, 8, True),  # narrow and ragged N tiles
    # the wgmma route (Cin % 8 == 0): K = 216 and 432 end in a ragged
    # tail of a 64-wide chunk (24 and 48 wide), K = 864 in a half chunk
    (8, 32, 1, 8, True), (16, 64, 1, 8, True), (32, 32, 1, 8, True),
    # dilated taps past every face of an 8^3 volume
    (256, 256, 2, 8, True),
    (8, 8, 1, 8, True), (16, 72, 2, 8, True),  # ragged N on short K
    # the halo route (Cin < 8): every channel count's word alignment (odd
    # Cin straddles voxels), wider halos, volumes no tile divides, one and
    # several weight chunks, and no ReLU
    (1, 32, 1, 16, True), (3, 32, 1, 16, True), (7, 32, 1, 16, True),
    (6, 32, 2, 16, True), (6, 32, 3, 16, True),
    (6, 32, 1, 5, True), (6, 32, 1, 13, True),
    (6, 8, 1, 16, True), (6, 72, 1, 16, True), (6, 128, 1, 16, True),
    (6, 32, 1, 16, False),
    # the padded route (wgmma_padded): Cin > 8 not a multiple of 8 (tiny's
    # and the paper width's), Cout not a multiple of 8, the paper width's
    # block 3 at the reference's own width, and Cin 6 at a dilation above
    # the halo route's cap
    (12, 16, 1, 8, True), (300, 16, 2, 8, True),
    (12, 5, 1, 8, True), (300, 300, 2, 8, True), (6, 32, 8, 16, True),
])
def test_conv3d_kernel_matches_plain(cuda, cin, cout, dil, R, relu):
    x, w, b = conv_inputs(cuda, 3, R, cin, cout, cin + cout + dil)
    before = conv3d.launches
    got = conv3d(x, w, b, dil=dil, relu=relu)
    ref = conv3d_plain(x, w, b, dil, relu)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert within_one_bf16_ulp(got, ref).float().mean().item() >= 0.9999
    if relu:
        assert (ref > 0).any() and (ref == 0).any()
    else:
        assert (ref < 0).any()


def test_conv3d_kernel_ragged_m_and_no_relu(cuda):
    """M = 2 * 5^3 = 250 voxels: the second M tile runs past the end."""
    g = torch.Generator(cuda).manual_seed(9)
    x = torch.randn((2, 5, 5, 5, 16), generator=g, device=cuda).to(
        torch.bfloat16)
    w = (torch.randn((27 * 16, 16), generator=g, device=cuda) * 0.05).to(
        torch.bfloat16)
    b = torch.randn((16,), generator=g, device=cuda)
    got = conv3d(x, w, b, dil=1, relu=False)
    ref = conv3d_plain(x, w, b, 1, False)
    torch.cuda.synchronize()
    assert (ref < 0).any()
    assert within_one_bf16_ulp(got, ref).all()


def test_conv3d_halo_route_refuses_a_halo_too_wide(cuda):
    """At dil 8, above the halo route's cap (even one row of its tile would
    not fit in shared memory), the halo route refuses the shape, and the
    wrapper computes it through ``wgmma_padded`` (Cin padded to 8), one
    launch, within one bf16 ulp of the plain version."""
    x, w, b = conv_inputs(cuda, 1, 16, 6, 32, 5)
    assert conv3d_route(6, 32, 8) == "wgmma_padded"
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(_kernel_fn(), x, w, b, 8, True, "halo_mma")
    before, routes = conv3d.launches, dict(conv3d.route_launches)
    got = conv3d(x, w, b, dil=8)
    ref = conv3d_plain(x, w, b, 8, True)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 1
    assert conv3d.route_launches["wgmma_padded"] == routes["wgmma_padded"] + 1
    assert within_one_bf16_ulp(got, ref).float().mean().item() >= 0.9999


@pytest.mark.parametrize("cin", range(1, 8))
@pytest.mark.parametrize("cout", [8, 64])
def test_conv3d_halo_route_takes_dilations_up_to_its_cap(cuda, cin, cout):
    """The C entry and ``conv3d_route`` share one cap, ``HALO_MAX_DIL``: at
    the cap the halo route's launch runs (its tile fits in shared memory
    at every Cin and Cout) and agrees with the plain version; one above it
    the launch is refused."""
    assert conv3d_route(cin, cout, HALO_MAX_DIL) == "halo_mma"
    assert conv3d_route(cin, cout, HALO_MAX_DIL + 1) == "wgmma_padded"
    x, w, b = conv_inputs(cuda, 1, 12, cin, cout, cin)
    got = _run(_kernel_fn(), x, w, b, HALO_MAX_DIL, True, "halo_mma")
    ref = conv3d_plain(x, w, b, HALO_MAX_DIL, True)
    torch.cuda.synchronize()
    assert within_one_bf16_ulp(got, ref).float().mean().item() >= 0.9999
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(_kernel_fn(), x, w, b, HALO_MAX_DIL + 1, True, "halo_mma")


@pytest.mark.parametrize("cin,cout,dil,offset", [
    (6, 32, 1, 0), (6, 32, 6, 0), (16, 32, 1, 0), (12, 16, 1, 0),
    (16, 5, 1, 0), (6, 5, 1, 0),
    # x two bytes past a 16-byte boundary: copied once by the padded route
    (16, 32, 1, 2), (6, 32, 1, 2),
])
def test_conv3d_route_predicted_is_the_route_launched(cuda, cin, cout, dil,
                                                      offset):
    """The route ``conv3d_route`` names for a shape is the one whose count
    ``route_launches`` raises, and the call agrees with the plain version
    (a misaligned x lies at a byte offset into a larger buffer)."""
    x, w, b = conv_inputs(cuda, 2, 8, cin, cout, cin + cout + dil)
    if offset:
        buf = torch.empty(x.numel() + 8, dtype=torch.bfloat16, device=cuda)
        x = buf[offset // 2:offset // 2 + x.numel()].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == offset
    route = conv3d_route(cin, cout, dil, aligned=x.data_ptr() % 16 == 0)
    before = dict(conv3d.route_launches)
    got = conv3d(x, w, b, dil=dil)
    ref = conv3d_plain(x, w, b, dil, True)
    torch.cuda.synchronize()
    ran = {r: conv3d.route_launches[r] - before[r] for r in before}
    assert ran == {r: int(r == route) for r in before}
    assert got.shape == ref.shape and got.is_contiguous()
    assert within_one_bf16_ulp(got, ref).float().mean().item() >= 0.9999


@pytest.mark.parametrize("cin,cout,dil,R,B", [
    (128, 128, 1, 16, 8), (256, 256, 2, 16, 4), (16, 72, 1, 9, 3),
    (6, 32, 1, 64, 2),  # the halo route at the first layer's shape
])
def test_conv3d_kernel_repeat_launch_is_bitwise(cuda, cin, cout, dil, R, B):
    """The same inputs twice give the same bits: a missing proxy fence or
    barrier in a shared-memory ring or halo would show as a run-to-run
    change."""
    x, w, b = conv_inputs(cuda, B, R, cin, cout, 11)
    before = conv3d.launches
    first = conv3d(x, w, b, dil=dil, relu=True)
    second = conv3d(x, w, b, dil=dil, relu=True)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 2
    assert torch.equal(first, second)
    ref = conv3d_plain(x, w, b, dil, True)
    assert within_one_bf16_ulp(first, ref).float().mean().item() >= 0.9999


def test_paper_width_fused_forward_takes_no_scalar_route(cuda):
    """ModelConfig() (block_channels (32, 80, 160, 300)) with fused
    inference: the 12 convs run on the wgmma and halo routes (block 3 padded
    to 304 channels once, by ``fused_params``), never on ``wgmma_padded``,
    which would pad every call, and the forward agrees with
    its plain route within 1e-2 (bf16 roundings of sums taken in another
    order)."""
    cfg = dataclasses.replace(ModelConfig(), fused_inference=True)
    gen = torch.Generator().manual_seed(0)
    net = init_surfacenet(cfg, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    predictor = make_predictor(net, cfg, cuda)
    x = torch.randn((2, 16, 16, 16, 6), generator=torch.Generator(
        cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    before = dict(conv3d.route_launches)
    got = predictor(x, None)
    torch.cuda.synchronize()
    ran = {r: conv3d.route_launches[r] - before[r] for r in before}
    assert ran == {"wgmma": 11, "halo_mma": 1, "wgmma_padded": 0}
    with torch.inference_mode():
        ref = fused_infer_apply(cfg, fused_params(net.state_dict(), cfg,
                                                  cuda), x,
                                conv=conv3d_plain)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-2


@pytest.mark.parametrize("cin,cout,dil,R", [
    # the fast64 forward's seven layers (two share a shape), 64^3 cubes
    (6, 32, 1, 64), (32, 128, 1, 32), (128, 128, 1, 32), (128, 128, 1, 16),
    (128, 256, 2, 16), (256, 256, 2, 16),
])
def test_registered_conv_op_is_bitwise_the_kernel(cuda, cin, cout, dil, R):
    """``torch.ops.surfacenet_tpu_torch.conv3d`` on CUDA tensors is the
    kernel's direct launch, bit for bit, one launch a call."""
    from surfacenet_tpu_torch.ops.cuda.conv3d import _launch

    x, w, b = conv_inputs(cuda, 2, R, cin, cout, cin + cout)
    before = conv3d.launches
    got = torch.ops.surfacenet_tpu_torch.conv3d(x, w, b, dil, True)
    direct = _launch(x, w, b, dil, True)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 2
    assert torch.equal(got, direct)


@pytest.mark.parametrize("cin", [6, 8])
def test_registered_conv_op_passes_opcheck_on_cuda(cuda, cin):
    from surfacenet_tpu_torch.ops.cuda.conv3d import conv3d_op

    x, w, b = conv_inputs(cuda, 2, 8, cin, 16, 3)
    torch.library.opcheck(conv3d_op, (x, w, b, 1, True))


def test_fused_export_on_the_card_matches_the_predictor(cuda, tmp_path):
    """``cli export`` of a fused forward (tiny widths, padded to 16) on the
    card: the loaded program launches the conv kernel and is within 1e-5
    of the direct fused predictor (the self-check's bound)."""
    from surfacenet_tpu_torch.cli import _apply_overrides, main
    from surfacenet_tpu_torch.models.convert import load_surfacenet, save_npz

    ckpt, out = str(tmp_path / "tiny.npz"), str(tmp_path / "fused.pt2")
    save_npz(init_surfacenet(ModelConfig.tiny(), torch.Generator()
                             .manual_seed(0)).state_dict(), ckpt)
    tiny = ["--set", "voxel.cube_size=16",
            "--set", "model.block_channels=[8,12,16,16]",
            "--set", "model.convs_per_block=[1,1,1,1]",
            "--set", "model.side_channels=4",
            "--set", "model.fused_inference=true"]
    r = main(["export", "--checkpoint", ckpt, "--out", out, "--batch", "2",
              "--selfcheck", *tiny])
    assert r["selfcheck_err"] <= 1e-5
    cfg = _apply_overrides(Config(), tiny[1::2]).model
    predictor = make_predictor(load_surfacenet(ckpt, cfg), cfg, cuda)
    x = torch.rand((2, 16, 16, 16, 6), device=cuda) - 0.5
    prog = torch.export.load(out).module()
    before = conv3d.launches
    with torch.inference_mode():
        got = prog(x)
    torch.cuda.synchronize()
    assert conv3d.launches == before + 4
    assert (got - predictor(x)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("window", [0, 2])
def test_affine_pool_kernel_matches_plain_and_sums_to_votes(cuda, scene,
                                                            window):
    rng = np.random.default_rng(3)
    D, s, N, K = 32, 1.5, 5, 4
    probs = torch.as_tensor(rng.uniform(size=(N, D, D, D)),
                            dtype=torch.float32, device=cuda)
    origins = torch.as_tensor(rng.uniform(-40, 0, (N, 3)),
                              dtype=torch.float32, device=cuda)
    Ps_pool = torch.as_tensor(scene.Ps[rng.integers(0, 4, (N, K))],
                              dtype=torch.float32, device=cuda)
    before = affine_pool.launches
    items = probs.repeat_interleave(K, dim=0)
    item_orig = origins.repeat_interleave(K, dim=0)
    mk = ray_max_mask_affine_cuda(items, item_orig, s,
                                  Ps_pool.reshape(-1, 3, 4), window)
    mp = ray_max_mask_affine_batch(items, item_orig, s,
                                   Ps_pool.reshape(-1, 3, 4), window)
    torch.cuda.synchronize()
    assert affine_pool.launches == before + 1
    assert mk.dtype == torch.bool
    assert torch.equal(mk, mp)
    # summed over the views of each cube, the masks are the votes
    active = torch.ones((N, K), dtype=torch.bool, device=cuda)
    axis, slopes = vote_params(origins, s, Ps_pool, active, D)
    votes = affine_vote(probs, axis, slopes, window)
    sums = mk.reshape(N, K, D, D, D).sum(dim=1, dtype=torch.int32)
    torch.cuda.synchronize()
    assert torch.equal(sums, votes)


def test_new_kernels_reject_bad_inputs(cuda):
    x = torch.zeros((1, 4, 4, 4, 8), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((27 * 8, 16), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(16, device=cuda)
    for bad in (dict(x=x.float()), dict(w=w[:, :12].contiguous()),
                dict(b=b.cpu()), dict(x=x.cpu()), dict(x=x.transpose(1, 3))):
        with pytest.raises(ValueError):
            conv3d(**(dict(x=x, w=w, b=b) | bad))
    probs = torch.zeros((2, 4, 4, 4), device=cuda)
    axis = torch.zeros(2, dtype=torch.int32, device=cuda)
    slopes = torch.zeros((2, 2), device=cuda)
    for bad in (dict(probs=probs.half()), dict(axis=axis.cpu()),
                dict(slopes=slopes[:1])):
        with pytest.raises(ValueError):
            affine_pool(**(dict(probs=probs, axis=axis, slopes=slopes)
                           | bad))


def affine_inputs(device, seed, N, K, D):
    """Volumes with many ties (values on a grid of 1/8: the 1e-6 margin and
    equal maxima matter), axes drawn from {-1, 0, 1, 2} and slopes uniform
    in [-1, 1] with exact -1, 1 and 0 among them."""
    rng = np.random.default_rng(seed)
    vol = np.round(rng.uniform(size=(N, D, D, D)) * 8) / 8
    axis = rng.integers(-1, 3, (N, K))
    axis[0, :3] = (0, 1, 2)
    slopes = rng.uniform(-1, 1, (N, K, 2))
    slopes[0, 0] = (1.0, -1.0)
    slopes[0, 1] = (-1.0, 0.0)
    slopes[0, 2] = (0.0, 1.0)
    return (torch.as_tensor(vol, dtype=torch.float32, device=device),
            torch.as_tensor(axis, dtype=torch.int32, device=device),
            torch.as_tensor(slopes, dtype=torch.float32, device=device))


@pytest.mark.parametrize("D", [17, 64])
@pytest.mark.parametrize("window", [0, 1, 2, 3, "D-1"])
def test_affine_kernels_match_plain_on_every_route(cuda, D, window):
    """The vote (3 cubes x 6 views) and the mask (its 18 items) bitwise
    equal to their plain versions, on the route ``affine_route`` names:
    tile for windows 1-3, segment for 0 and D - 1 (the same taps); D 17
    leaves ragged tiles and rows."""
    window = D - 1 if window == "D-1" else window
    N, K = 3, 6
    vol, axis, slopes = affine_inputs(cuda, D + window, N, K, D)
    route = "segment" if window in (0, D - 1) else "tile"
    assert affine_route(D, K, window) == affine_route(D, 1, window) == route
    v_routes = dict(affine_vote.route_launches)
    p_routes = dict(affine_pool.route_launches)
    votes = affine_vote(vol, axis, slopes, window)
    items = vol.repeat_interleave(K, dim=0)
    mask = affine_pool(items, axis.reshape(-1), slopes.reshape(-1, 2),
                       window)
    torch.cuda.synchronize()
    assert affine_vote.route_launches[route] == v_routes[route] + 1
    assert affine_pool.route_launches[route] == p_routes[route] + 1
    assert torch.equal(votes, ray_vote_affine_plain(vol, axis, slopes,
                                                    window))
    assert torch.equal(mask, ray_max_mask_affine_plain(
        items, axis.reshape(-1), slopes.reshape(-1, 2), window))
    assert not mask.reshape(N, K, D, D, D)[axis < 0].any()
    assert 0 < votes.max().item() <= K


@pytest.mark.parametrize("window", [0, 2, 5])
def test_affine_kernels_repeat_launch_is_bitwise(cuda, window):
    """Two launches on the same inputs give the same bits on each route
    (segment, tile, direct at D 32), equal to the plain versions."""
    D, N, K = 32, 4, 6
    vol, axis, slopes = affine_inputs(cuda, 7, N, K, D)
    route = affine_route(D, K, window)
    assert route == {0: "segment", 2: "tile", 5: "direct"}[window]
    first = affine_vote(vol, axis, slopes, window)
    second = affine_vote(vol, axis, slopes, window)
    items = vol.repeat_interleave(K, dim=0)
    m1 = affine_pool(items, axis.reshape(-1), slopes.reshape(-1, 2), window)
    m2 = affine_pool(items, axis.reshape(-1), slopes.reshape(-1, 2), window)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(m1, m2)
    assert torch.equal(first, ray_vote_affine_plain(vol, axis, slopes,
                                                    window))
    assert torch.equal(m1.reshape(N, K, D, D, D).sum(1, dtype=torch.int32),
                       first)


_BAD_SLOPE = """
import sys, torch
from surfacenet_tpu_torch.ops.cuda.affine_pool import affine_pool
from surfacenet_tpu_torch.ops.cuda.affine_vote import affine_vote
kernel, window = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
vol = torch.rand((2, 32, 32, 32), device=dev)
axis = torch.zeros((2, 1), dtype=torch.int32, device=dev)
slopes = torch.zeros((2, 1, 2), device=dev)
slopes[1, 0, 1] = 1.5
if kernel == "vote":
    out = affine_vote(vol, axis, slopes, window)
else:
    out = affine_pool(vol, axis[:, 0].contiguous(), slopes[:, 0].contiguous(),
                      window)
torch.cuda.synchronize()
print("OUTPUT", int(out.sum()))
"""


@pytest.mark.parametrize("kernel,window", [
    ("vote", 2), ("vote", 0), ("vote", 5), ("mask", 2)])
def test_affine_kernels_refuse_a_slope_above_one(cuda, kernel, window):
    """A slope of 1.5 (outside vote_params' clamp) traps on every route: a
    CUDA error, no output.  In a child process, since a trap leaves the
    CUDA context unusable."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    run = subprocess.run([sys.executable, "-c", _BAD_SLOPE, kernel,
                          str(window)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "OUTPUT" not in run.stdout
    assert "CUDA" in run.stderr or "cuda" in run.stderr


def test_training_gather_matches_plain_at_the_training_shape(cuda):
    """``build_cvc_batch_cuda`` on one ``dtu9_full`` training batch of the
    device sampler (32 pairs: 64 items of 64^3, 8 views of 240x320, bf16
    RGBx images) against ``build_cvc_batch`` on the same images, with
    chip_smoke.py's training gates: validity agreement >= 0.9999 and
    |x diff| <= 2e-3 where both are valid (twice the gather's 1e-3:
    centring subtracts two means that each carry it)."""
    cfg = baseline_config("dtu9_full")
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    sphere = make_sphere_scene(n_views=8, hw=(240, 320))
    sampler = train_surface.make_device_sampler(sphere, cfg, n_candidates=256,
                                                device=cuda)
    origins, pairs, _ = train_surface.sample_device_batch(
        sampler, torch.Generator(cuda).manual_seed(0),
        batch=cfg.train.batch_size, D=D, s=s)
    images = train_surface.gather_copy(sphere.images, cfg, cuda)
    assert images.dtype == torch.bfloat16
    Ps = torch.as_tensor(sphere.Ps, dtype=torch.float32, device=cuda)
    before = warp_gather.entry_launches["warp_gather_bf16"]
    x_k, v_k = build_cvc_batch_cuda(images, Ps, pairs, origins, D=D, s=s)
    assert warp_gather.entry_launches["warp_gather_bf16"] == before + 1
    x_p, v_p = build_cvc_batch(images, Ps, pairs, origins, D, s)
    torch.cuda.synchronize()
    assert x_k.shape == (32, D, D, D, 6) and images.shape[-1] == 4
    assert (v_k == v_p).float().mean().item() >= 0.9999
    assert (x_k - x_p).abs()[v_k & v_p].max().item() <= 2e-3
    assert v_k.float().mean().item() > 0.2


def test_train_step_on_the_card(cuda):
    """One ``train_step`` through the gather kernel, bf16 compute on
    float32 master weights: a finite loss, every parameter moved, the
    BatchNorm running statistics updated."""
    cfg = baseline_config("dtu9_full")
    cfg = cfg.replace(
        voxel=dataclasses.replace(cfg.voxel, cube_size=32),
        model=dataclasses.replace(ModelConfig.tiny(), dtype="bfloat16"),
        train=dataclasses.replace(cfg.train, batch_size=4))
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    sphere = make_sphere_scene(n_views=8, hw=(240, 320))
    sampler = train_surface.make_device_sampler(sphere, cfg, n_candidates=64,
                                                device=cuda)
    origins, pairs, labels = train_surface.sample_device_batch(
        sampler, torch.Generator(cuda).manual_seed(1), batch=4, D=D, s=s)
    state = train_surface.create_train_state(cfg, device=cuda)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    launches = warp_gather.launches
    loss = train_surface.train_step(
        state, train_surface.gather_copy(sphere.images, cfg, cuda),
        torch.as_tensor(sphere.Ps, dtype=torch.float32, device=cuda),
        origins, pairs, labels, D=D, s=s, balanced=True, center_colors=True)
    assert np.isfinite(loss.item()) and state.step == 1
    assert warp_gather.launches == launches + 1
    after = state.model.state_dict()
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moved = [k for k, p in state.model.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(list(state.model.parameters()))
    assert not torch.equal(after["blocks.0.bns.0.running_mean"],
                           before["blocks.0.bns.0.running_mean"])


def test_training_without_the_preset_gathers_through_the_kernel(cuda):
    """``Config()`` leaves ``sweep.use_pallas_gather`` off: training on the
    card still gathers through the kernel, on float32 RGBx images (its
    f32 entry), once a step on the scan path and the host loop."""
    cfg = Config(voxel=VoxelConfig(voxel_size_mm=2.0, cube_size=16,
                                   overlap=4),
                 model=dataclasses.replace(ModelConfig.tiny(),
                                           dtype="float32"))
    assert not cfg.sweep.use_pallas_gather
    sphere = make_sphere_scene(n_views=4, hw=(90, 120))
    images = train_surface.gather_copy(sphere.images, cfg, cuda)
    assert images.dtype == torch.float32 and images.shape[-1] == 4
    for chunk in (3, 0):
        tc = dataclasses.replace(cfg.train, batch_size=4, scan_chunk=chunk)
        before = dict(warp_gather.entry_launches)
        state, log = train_surface.train_surfacenet(
            sphere, cfg.replace(train=tc), n_steps=6, device=cuda)
        assert state.step == 6 and np.isfinite(log.losses).all()
        launched = {k: v - before[k]
                    for k, v in warp_gather.entry_launches.items()}
        assert launched == {"warp_gather_bf16": 0, "warp_gather_f32": 6,
                            "warp_gather_int8": 0}, (chunk, launched)


def test_reconstruct_all_on_the_card_matches_the_cpu(cuda, tmp_path):
    """cli reconstruct-all over two small scans (the sphere and the tori,
    SampleSet layout, 4 views of 90x120) on the card, through the gather
    and the vote kernels, against the same on the CPU: voxel agreement
    >= 0.99 a scan, and both reports score every scan."""
    from surfacenet_tpu_torch.cli import main
    from surfacenet_tpu_torch.data.dtu import write_scan_sampleset
    from surfacenet_tpu_torch.data.synthetic import make_tori_scene
    from surfacenet_tpu_torch.utils.metrics import voxel_set_agreement
    from surfacenet_tpu_torch.utils.ply import read_ply, write_ply

    dirs = []
    os.makedirs(tmp_path / "gt")
    for i, (name, make) in enumerate((("scan1", make_sphere_scene),
                                      ("scan4", make_tori_scene))):
        sc = make(n_views=4, hw=(90, 120))
        dirs.append(write_scan_sampleset(str(tmp_path / f"set{i}"), name,
                                         sc.images, sc.Ps))
        write_ply(str(tmp_path / "gt" / f"{name}.ply"),
                  sc.surface_points(3000))
    args = ["reconstruct-all", "--scans", *dirs, "--gt-dir",
            str(tmp_path / "gt"), "--protocol", "dtu", "--min-component",
            "5", "--set", "voxel.cube_size=16",
            "--set", "voxel.voxel_size_mm=2.0", "--set", "voxel.overlap=4",
            "--set", "fusion.n_view_pairs=2", "--set", "fusion.tau=0.25",
            "--set", "sweep.cube_batch=8", "--set",
            "fusion.ray_pool_mode=affine_pallas",
            "--set", "sweep.use_pallas_gather=true"]
    before = (warp_gather.launches, affine_vote.launches)
    card, _ = main(args + ["--out-dir", str(tmp_path / "card")])
    assert warp_gather.launches > before[0]
    assert affine_vote.launches > before[1]
    cpu, _ = main(args + ["--out-dir", str(tmp_path / "cpu"), "--device",
                          "cpu"])
    for name in ("scan1", "scan4"):
        pc = read_ply(str(tmp_path / "card" / f"{name}.ply"))[0]
        ph = read_ply(str(tmp_path / "cpu" / f"{name}.ply"))[0]
        assert len(pc) > 50
        assert voxel_set_agreement(pc, ph) >= 0.99
        assert "dtu" in card[name] and "dtu" in cpu[name]
    assert card.keys() == cpu.keys()
