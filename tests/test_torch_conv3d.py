"""Port parity: the conv kernel's plain version, fold_bn and the fused forward.

Against the reference's Pallas conv in interpret mode: every output within
one bf16 ulp, |port - ref| <= 2^-7 |ref| + 1e-3 rms(ref) (both sum exact
bf16 products in float32, in different orders, then round to bf16; the
second term covers outputs near zero).  ``fold_bn`` on the converted state
dict: within one float32 ulp of the reference's on the flax params.  The
fused forward against the reference's ``fused_infer_apply`` (interpret
mode) at ``ModelConfig.tiny()`` and at the paper width ``ModelConfig()``:
probabilities within 1e-2, because conv outputs whose float32 sums differ
in order can round to neighbouring bf16 values.  ``fused_params`` pads
every conv's channels to a multiple of 8 (zero weights and biases): every
model width then takes a fast route of the conv kernel, the padded and
unpadded parameters give the same probabilities, and aligned widths come
out unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu.config import ModelConfig as JModel
from surfacenet_tpu.models.surfacenet import SurfaceNet as JSurfaceNet
from surfacenet_tpu.models.surfacenet import fold_bn as j_fold_bn
from surfacenet_tpu.models.surfacenet import fused_infer_apply as j_fused
from surfacenet_tpu.ops.pallas.conv3d import conv3d_pallas
from surfacenet_tpu_torch.config import ModelConfig as TModel
from surfacenet_tpu_torch.models.convert import params_from_jax
from surfacenet_tpu_torch.models.surfacenet import (
    DTYPES, SurfaceNet, fold_bn, fused_infer_apply, fused_params,
    init_surfacenet, make_predictor,
)
from surfacenet_tpu_torch.ops.conv3d import conv3d_plain, pack_conv_weight
from surfacenet_tpu_torch.ops.cuda.conv3d import (
    conv3d, conv3d_route, pad_operands,
)

torch.set_num_threads(2)

D = 8


def within_one_bf16_ulp(got, ref):
    rms = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    return np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + 1e-3 * rms


@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("cin,cout", [(6, 8), (8, 16), (3, 8), (7, 16),
                                      (12, 5), (300, 300)])
def test_conv3d_plain_matches_pallas_interpret(dil, cin, cout):
    rng = np.random.default_rng(dil * 100 + cin)
    B = 1 if cin * cout > 1000 else 2  # the 300-wide case: one volume
    x = rng.standard_normal((B, D, D, D, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    ref = np.asarray(conv3d_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        dil=dil, relu=True, interpret=True,
    ), np.float32)
    wt = torch.tensor(w).permute(4, 3, 0, 1, 2)  # torch (out, in, 3, 3, 3)
    got = conv3d(torch.tensor(x).to(torch.bfloat16),
                 pack_conv_weight(wt).to(torch.bfloat16).contiguous(),
                 torch.tensor(b), dil=dil, relu=True)
    assert got.dtype == torch.bfloat16 and got.shape == (B, D, D, D, cout)
    assert got.is_contiguous()
    assert within_one_bf16_ulp(got.float().numpy(), ref).all()
    assert (ref > 0).any() and (ref == 0).any()  # ReLU did cut


@pytest.mark.parametrize("cin,cout,dil,aligned,route", [
    (6, 32, 1, True, "halo_mma"), (1, 32, 1, True, "halo_mma"),
    (7, 32, 1, True, "halo_mma"), (8, 32, 1, True, "wgmma"),
    (128, 128, 2, True, "wgmma"), (12, 16, 1, True, "wgmma_padded"),
    (300, 304, 2, True, "wgmma_padded"),
    # Cout not a multiple of 8, on both kernel routes' Cin
    (8, 5, 1, True, "wgmma_padded"), (6, 5, 1, True, "wgmma_padded"),
    # the halo route's cap, HALO_MAX_DIL 5, at every Cin below 8 and Cout
    (6, 32, 5, True, "halo_mma"), (6, 32, 6, True, "wgmma_padded"),
    (6, 32, 8, True, "wgmma_padded"), (1, 8, 5, True, "halo_mma"),
    (1, 8, 6, True, "wgmma_padded"),
    # x off a 16-byte boundary: copied by the padded route
    (6, 32, 1, False, "wgmma_padded"), (8, 32, 1, False, "wgmma_padded"),
    (128, 32, 1, False, "wgmma_padded"),
])
def test_conv3d_route_by_cin(cin, cout, dil, aligned, route):
    assert conv3d_route(cin, cout, dil, aligned) == route


@pytest.mark.parametrize("cin,cout,dil", [(12, 5, 1), (300, 300, 2),
                                          (6, 8, 8), (8, 5, 1)])
def test_pad_operands_give_the_same_conv(cin, cout, dil):
    """``wgmma_padded``'s padding is the same function: the plain conv on
    the padded operands, sliced back to Cout, equals the plain conv on the
    originals bit for bit (zero channels add exact zeros).  The values are
    small multiples of 1/64, so every float32 partial sum is exact (at most
    27 * 300 * 24 units of 1/64 < 2^24): the comparison sees the padding
    alone, not the order in which the CPU's conv adds, which changes with
    the channel count."""
    rng = np.random.default_rng(cin + cout)
    x = torch.tensor(rng.integers(-3, 4, (1, D, D, D, cin)),
                     dtype=torch.bfloat16)
    w = torch.tensor(rng.integers(-8, 9, (27 * cin, cout)) / 64,
                     dtype=torch.bfloat16)
    b = torch.tensor(rng.integers(-64, 65, cout) / 64, dtype=torch.float32)
    xp, wp, bp = pad_operands(x, w, b)
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    assert xp.shape == (1, D, D, D, cin8) and xp.is_contiguous()
    assert wp.shape == (27 * cin8, cout8) and bp.shape == (cout8,)
    assert xp.data_ptr() % 16 == 0
    assert (xp.data_ptr() == x.data_ptr()) == (cin == cin8)  # no copy
    assert not xp[..., cin:].any() and not bp[cout:].any()
    assert not wp.view(27, cin8, cout8)[:, cin:].any()
    assert not wp[:, cout:].any()
    got = conv3d_plain(xp, wp, bp, dil)[..., :cout]
    want = conv3d_plain(x, w, b, dil)
    assert (want > 0).any() and (want == 0).any()
    assert torch.equal(got, want)


def test_pack_conv_weight_is_the_dhwio_reshape():
    w = np.random.default_rng(0).standard_normal((3, 3, 3, 5, 7))
    packed = pack_conv_weight(torch.tensor(w).permute(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(packed.numpy(), w.reshape(27 * 5, 7))


def test_conv3d_without_relu_and_bad_inputs():
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((1, 4, 4, 4, 8))).to(torch.bfloat16)
    w = torch.tensor(rng.standard_normal((27 * 8, 16)) * 0.1).to(
        torch.bfloat16)
    b = torch.zeros(16)
    y = conv3d(x, w, b, dil=1, relu=False)
    assert (y < 0).any()
    np.testing.assert_array_equal(y.float().numpy(),
                                  conv3d_plain(x, w, b, 1, False).float()
                                  .numpy())
    for bad in (dict(x=x.float()), dict(w=w.float()), dict(b=b.double()),
                dict(w=w[:-1]), dict(b=b[:8]), dict(x=x[:, :, :3]),
                dict(x=x.transpose(1, 2)), dict(dil=0)):
        args = dict(x=x, w=w, b=b, dil=1) | bad
        with pytest.raises(ValueError):
            conv3d(**args)


@pytest.fixture(scope="module")
def tiny_variables():
    """flax tiny SurfaceNet variables as numpy (parameters are float32
    whatever the compute dtype, so one init serves every case)."""
    net = JSurfaceNet(JModel.tiny())
    v = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, D, D, D, 6)))
    return jax.tree_util.tree_map(np.asarray, v)


def _with_bn_stats(v, seed):
    """Seeded non-identity BatchNorm statistics (as
    tests/test_conv3d_pallas.py); ``seed`` None keeps the identity ones."""
    if seed is None:
        return v
    rng = np.random.default_rng(seed)

    def stat(a):
        return (np.abs(rng.standard_normal(a.shape)) * 0.5 + 0.5).astype(
            np.float32)

    return {"params": v["params"],
            "batch_stats": jax.tree_util.tree_map(stat, v["batch_stats"])}


def test_fold_bn_matches_reference_on_converted_weights(tiny_variables):
    cfg = JModel.tiny()
    v = _with_bn_stats(tiny_variables, 2)
    sd = params_from_jax(v)
    for b in range(len(cfg.block_channels)):
        for conv, bn, p, st in (
            (f"blocks.{b}.convs.0.", f"blocks.{b}.bns.0.",
             v["params"][f"ConvBlock_{b}"], v["batch_stats"][f"ConvBlock_{b}"]),
            (f"sides.{b}.conv.", f"sides.{b}.bn.",
             v["params"][f"SideLayer_{b}"], v["batch_stats"][f"SideLayer_{b}"]),
        ):
            wj, bj = j_fold_bn(p["Conv_0"]["kernel"], p["BatchNorm_0"]["scale"],
                               p["BatchNorm_0"]["bias"],
                               st["BatchNorm_0"]["mean"],
                               st["BatchNorm_0"]["var"])
            wt, bt = fold_bn(sd[conv + "weight"], sd[bn + "weight"],
                             sd[bn + "bias"], sd[bn + "running_mean"],
                             sd[bn + "running_var"])
            assert wt.dtype == bt.dtype == torch.float32
            wt = wt.permute(2, 3, 4, 1, 0).numpy()  # back to DHWIO
            ulp = np.spacing(np.abs(np.asarray(wj, np.float32)))
            assert (np.abs(wt - np.asarray(wj)) <= ulp).all()
            ulp = np.spacing(np.abs(np.asarray(bj, np.float32)))
            assert (np.abs(bt.numpy() - np.asarray(bj)) <= ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bn_seed", [None, 2])
def test_fused_infer_apply_matches_reference(tiny_variables, dtype, bn_seed):
    jcfg = dataclasses.replace(JModel.tiny(), dtype=dtype)
    tcfg = dataclasses.replace(TModel.tiny(), dtype=dtype,
                               fused_inference=True)
    v = _with_bn_stats(tiny_variables, bn_seed)
    x = np.random.default_rng(1).standard_normal((2, D, D, D, 6)).astype(
        np.float32)
    ref = np.asarray(j_fused(jcfg, v, jnp.asarray(x), interpret=True))
    net = SurfaceNet(tcfg)
    net.load_state_dict(params_from_jax(v))
    pred = make_predictor(net, tcfg, "cpu")
    assert pred.in_dtype == dtype
    got = pred(torch.tensor(x).to(getattr(torch, dtype)), None)
    assert got.dtype == torch.float32 and got.shape == (2, D, D, D)
    # bf16 rounding of conv outputs whose float32 sums differ in order
    assert np.abs(got.numpy() - ref).max() <= 1e-2


def test_fused_route_only_for_resize_side_layers():
    tcfg = dataclasses.replace(TModel.tiny(), fused_inference=True,
                               upsample_mode="deconv")
    net = SurfaceNet(tcfg).eval()
    x = torch.randn((1, D, D, D, 6), generator=torch.Generator().manual_seed(0))
    # make_predictor falls to SurfaceNet.forward for deconv, as the
    # reference's does; fused_infer_apply itself refuses deconv
    with torch.no_grad():
        np.testing.assert_array_equal(make_predictor(net, tcfg, "cpu")(x)
                                      .numpy(), net(x).numpy())
    with pytest.raises(NotImplementedError):
        fused_infer_apply(tcfg, fused_params(net.state_dict(), tcfg, "cpu"),
                          x)


FACTORIES = {"paper": TModel, "mxu_aligned": TModel.mxu_aligned,
             "fast": TModel.fast, "fast64": TModel.fast64,
             "tiny": TModel.tiny}


def _unpadded_params(state_dict, cfg):
    """``fused_params`` without the channel padding: each 3^3 kernel packed
    at its own width."""
    sd = {k: v.detach().float() for k, v in state_dict.items()}
    dt = DTYPES[cfg.dtype]

    def folded(conv, bn):
        return fold_bn(sd[conv + "weight"], sd[bn + "weight"],
                       sd[bn + "bias"], sd[bn + "running_mean"],
                       sd[bn + "running_var"])

    blocks = []
    for b, (n_convs, dil) in enumerate(zip(cfg.convs_per_block,
                                           cfg.dilations)):
        convs = []
        for i in range(n_convs):
            w, bias = folded(f"blocks.{b}.convs.{i}.", f"blocks.{b}.bns.{i}.")
            convs.append((pack_conv_weight(w).to(torch.bfloat16).contiguous(),
                          bias.contiguous(), dil))
        sw, sb = folded(f"sides.{b}.conv.", f"sides.{b}.bn.")
        blocks.append({"convs": convs,
                       "side_w": sw[:, :, 0, 0, 0].t().to(dt).contiguous(),
                       "side_b": sb.to(dt)})
    return {"blocks": blocks,
            "head_w": sd["head.weight"][:, :, 0, 0, 0].t().to(dt).contiguous(),
            "head_b": sd["head.bias"].to(dt)}


def _seeded_net(cfg, seed):
    """A SurfaceNet of seeded weights and non-identity BatchNorm
    statistics."""
    gen = torch.Generator().manual_seed(seed)
    net = init_surfacenet(cfg, gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return net


@pytest.mark.parametrize("name", list(FACTORIES))
def test_fused_params_send_every_conv_to_a_fast_route(name):
    cfg = FACTORIES[name]()
    params = fused_params(init_surfacenet(cfg, torch.Generator().manual_seed(
        0)).state_dict(), cfg, "cpu")
    cin = cfg.in_channels
    for blk, ch, n_convs in zip(params["blocks"], cfg.block_channels,
                                cfg.convs_per_block):
        assert len(blk["convs"]) == n_convs
        for w, b, dil in blk["convs"]:
            assert w.shape == (27 * cin, -(-ch // 8) * 8) and b.shape == (
                w.shape[1],)
            assert conv3d_route(cin, w.shape[1], dil) in ("wgmma", "halo_mma")
            cin = w.shape[1]
        assert blk["side_w"].shape == (cin, cfg.side_channels)
    # the paper width's 300 becomes 304, tiny's 12 becomes 16
    widths = [w.shape[1] for blk in params["blocks"] for w, _, _ in
              blk["convs"]]
    assert {"paper": 304 in widths and 300 not in widths,
            "tiny": 16 in widths and 12 not in widths}.get(name, True)


@pytest.mark.parametrize("name", ["fast64", "mxu_aligned", "fast"])
def test_fused_params_leave_aligned_widths_unchanged(name):
    cfg = FACTORIES[name]()
    sd = _seeded_net(cfg, 4).state_dict()
    got, want = fused_params(sd, cfg, "cpu"), _unpadded_params(sd, cfg)
    for g, w in zip(got["blocks"], want["blocks"]):
        for (gw, gb, gd), (ww, wb, wd) in zip(g["convs"], w["convs"]):
            assert torch.equal(gw, ww) and torch.equal(gb, wb) and gd == wd
        assert torch.equal(g["side_w"], w["side_w"])
        assert torch.equal(g["side_b"], w["side_b"])
    assert torch.equal(got["head_w"], want["head_w"])
    assert torch.equal(got["head_b"], want["head_b"])


@pytest.mark.parametrize("name", ["tiny", "paper"])
def test_padded_fused_params_give_the_same_probabilities(name):
    """Zero channels add nothing: the padded parameters and a packing at
    the model's own widths give the same forward through the plain conv."""
    cfg = dataclasses.replace(FACTORIES[name](), fused_inference=True)
    sd = _seeded_net(cfg, 5).state_dict()
    x = torch.tensor(np.random.default_rng(6).standard_normal(
        (1, D, D, D, 6)).astype(np.float32)).to(DTYPES[cfg.dtype])
    with torch.inference_mode():
        got = fused_infer_apply(cfg, fused_params(sd, cfg, "cpu"), x,
                                conv=conv3d_plain)
        want = fused_infer_apply(cfg, _unpadded_params(sd, cfg), x,
                                 conv=conv3d_plain)
    assert got.shape == (1, D, D, D) and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def paper_variables():
    """flax paper-width SurfaceNet variables as numpy, with seeded
    non-identity BatchNorm statistics."""
    net = JSurfaceNet(JModel())
    v = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, D, D, D, 6)))
    return _with_bn_stats(jax.tree_util.tree_map(np.asarray, v), 3)


def test_fused_infer_apply_matches_reference_at_the_paper_width(
        paper_variables):
    """ModelConfig() (block_channels (32, 80, 160, 300), bf16): the port
    pads block 3 to 304 channels; the reference runs 300."""
    jcfg = JModel()
    tcfg = dataclasses.replace(TModel(), fused_inference=True)
    x = np.random.default_rng(7).standard_normal((1, D, D, D, 6)).astype(
        np.float32)
    ref = np.asarray(j_fused(jcfg, paper_variables, jnp.asarray(x),
                             interpret=True))
    net = SurfaceNet(tcfg)
    net.load_state_dict(params_from_jax(paper_variables))
    got = make_predictor(net, tcfg, "cpu")(
        torch.tensor(x).to(torch.bfloat16), None)
    assert got.dtype == torch.float32 and got.shape == (1, D, D, D)
    # bf16 rounding of conv outputs whose float32 sums differ in order
    assert np.abs(got.numpy() - ref).max() <= 1e-2
