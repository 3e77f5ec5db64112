"""Port parity: the warp gather (plain version of the CUDA kernel).

Bars from tests/test_pallas.py: validity agreement >= 0.999, colour error
<= 1e-4 in float32 against the XLA oracle, and <= 1e-2 in bfloat16 against
the Pallas kernel run in interpret mode (its windows cover the footprint
here, so its window term does not bite).  The int8 mode against the
Pallas kernel's int8 mode: the bounds stated in its test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenet_tpu.ops.cvc import build_cvc_views as j_views
from surfacenet_tpu_torch.ops.cuda.warp_gather import warp_gather
from surfacenet_tpu_torch.ops.cvc import (
    bilinear_sample, build_cvc, build_cvc_views, center_cvc, quantize_int8,
)

torch.set_num_threads(2)

D, S = 16, 2.0
ORIGINS = np.array(
    [[-16.0, -16.0, -16.0], [0.0, -8.0, -16.0], [-8.0, 0.0, 0.0],
     [-40.0, -40.0, -40.0], [20.0, -30.0, 5.0]], np.float32,
)
VIEWS = np.array([0, 1, 2, 3, 1], np.int32)


@pytest.fixture(scope="module")
def scene():
    from surfacenet_tpu.data.synthetic import make_sphere_scene

    return make_sphere_scene(n_views=4, hw=(90, 120))


def _port(scene, dtype=torch.float32):
    return warp_gather(
        torch.tensor(scene.images).to(dtype).contiguous(),
        torch.tensor(scene.Ps, dtype=torch.float32),
        torch.tensor(VIEWS), torch.tensor(ORIGINS), D=D, s=S,
    )


def test_gather_matches_xla_oracle_f32(scene):
    c_j, v_j = j_views(jnp.asarray(scene.images),
                       jnp.asarray(scene.Ps, jnp.float32),
                       jnp.asarray(VIEWS), jnp.asarray(ORIGINS), D, S)
    c_t, v_t = _port(scene)
    c_j, v_j = np.asarray(c_j), np.asarray(v_j)
    c_t, v_t = c_t.numpy(), v_t.numpy()
    assert c_t.shape == (5, D, D, D, 3) and v_t.shape == (5, D, D, D)
    assert (v_t == v_j).mean() >= 0.999
    both = v_t & v_j
    assert np.abs(c_t[both] - c_j[both]).max() <= 1e-4
    assert (c_t[~v_t] == 0).all()
    assert 0.2 < v_t.mean() < 1.0  # the cases cover inside and outside


def test_gather_bf16_matches_pallas_interpret(scene):
    from surfacenet_tpu.ops.pallas.warp_gather import warp_gather_tiled

    H, W = scene.images.shape[1:3]
    c_p, v_p = warp_gather_tiled(
        jnp.asarray(scene.images), jnp.asarray(scene.Ps, jnp.float32),
        jnp.asarray(VIEWS), jnp.asarray(ORIGINS), D=D, s=S, CH=H, CW=W,
        interpret=True, in_dtype=jnp.bfloat16,
    )
    c_t, v_t = _port(scene, torch.bfloat16)
    c_p, v_p = np.asarray(c_p), np.asarray(v_p)
    c_t, v_t = c_t.numpy(), v_t.numpy()
    assert (v_t == v_p).mean() >= 0.999
    both = v_t & v_p
    assert np.abs(c_t[both] - c_p[both]).max() <= 1e-2


def test_gather_int8_matches_pallas_interpret(scene):
    """The int8 mode: the same int8 image (round(x * 127)) and 7-bit
    vertical weights on both sides, crops covering the whole image.  The
    reference's reciprocal-plus-Newton and the port's division may differ
    by an ulp in u or v: colours agree within 1e-5 on >= 0.999 of the valid
    voxels, and within 8e-3 (one 7-bit weight step) everywhere."""
    from surfacenet_tpu.ops.pallas.warp_gather import warp_gather_pallas

    H, W = scene.images.shape[1:3]
    c_p, v_p = warp_gather_pallas(
        jnp.asarray(scene.images), jnp.asarray(scene.Ps, jnp.float32),
        jnp.asarray(VIEWS), jnp.asarray(ORIGINS), D=D, s=S, CH=H, CW=W,
        PC=512, interpret=True, in_dtype=jnp.int8,
    )
    q = quantize_int8(torch.tensor(scene.images))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(
        q.numpy(), np.round(scene.images * np.float32(127)).astype(np.int8))
    c_t, v_t = warp_gather(q, torch.tensor(scene.Ps, dtype=torch.float32),
                           torch.tensor(VIEWS), torch.tensor(ORIGINS), D=D,
                           s=S)
    c_p, v_p = np.asarray(c_p), np.asarray(v_p)
    c_t, v_t = c_t.numpy(), v_t.numpy()
    assert (v_t == v_p).mean() >= 0.999
    both = v_t & v_p
    err = np.abs(c_t[both] - c_p[both]).max(axis=-1)
    assert (err <= 1e-5).mean() >= 0.999
    assert err.max() <= 8e-3
    assert (c_t[~v_t] == 0).all()
    # the error class of the mode against the float32 oracle
    c_f, v_f = _port(scene)
    assert np.abs(c_t[v_t] - c_f.numpy()[v_t]).max() <= 1.5e-2


def test_bf16_gather_samples_the_rounded_image_exactly(scene):
    """bf16 images are sampled in float32: the same as sampling the
    float32 copy of the rounded image."""
    rounded = torch.tensor(scene.images).to(torch.bfloat16)
    a = warp_gather(rounded.contiguous(),
                    torch.tensor(scene.Ps, dtype=torch.float32),
                    torch.tensor(VIEWS), torch.tensor(ORIGINS), D=D, s=S)
    b = build_cvc_views(rounded.float(),
                        torch.tensor(scene.Ps, dtype=torch.float32),
                        torch.tensor(VIEWS), torch.tensor(ORIGINS), D, S)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_gather_reads_rgbx_images_as_rgb(scene, dtype):
    """RGBx images, as the sweep's copy (``gather_images``) is on a card:
    channel 3 is not read, so (V, H, W, 4) images give the three-channel
    output bitwise.  On the CPU the sweep keeps three channels."""
    import torch.nn.functional as F

    from surfacenet_tpu_torch.pipeline.sweep import gather_images

    rgb = gather_images(torch.tensor(scene.images), dtype)
    assert rgb.shape == scene.images.shape and rgb.dtype == dtype
    assert rgb.is_contiguous()
    rgbx = F.pad(rgb, (0, 1)).contiguous()
    # a fourth channel that must not leak into the colours
    noisy = rgbx.clone()
    noisy[..., 3] = 1
    args = (torch.tensor(scene.Ps, dtype=torch.float32), torch.tensor(VIEWS),
            torch.tensor(ORIGINS))
    three = warp_gather(rgb, *args, D=D, s=S)
    for images in (rgbx, noisy):
        four = warp_gather(images, *args, D=D, s=S)
        assert torch.equal(four[0], three[0]) and torch.equal(four[1],
                                                              three[1])
    assert three[1].any()


def test_build_cvc_center_and_bilinear_match_reference(scene):
    from surfacenet_tpu.ops.cvc import bilinear_sample as j_bil
    from surfacenet_tpu.ops.cvc import build_cvc as j_cvc
    from surfacenet_tpu.ops.cvc import center_cvc as j_center

    img = scene.images[1]
    P = scene.Ps[1].astype(np.float32)
    c_j, v_j = j_cvc(jnp.asarray(img), jnp.asarray(P),
                     jnp.asarray(ORIGINS[0]), D, S)
    c_t, v_t = build_cvc(torch.tensor(img), torch.tensor(P),
                         torch.tensor(ORIGINS[0]), D, S)
    assert (v_t.numpy() == np.asarray(v_j)).mean() >= 0.999
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)

    rng = np.random.default_rng(0)
    cols = rng.uniform(size=(2, 4, 4, 4, 3)).astype(np.float32)
    val = rng.uniform(size=(2, 4, 4, 4)) > 0.3
    np.testing.assert_allclose(
        center_cvc(torch.tensor(cols), torch.tensor(val)).numpy(),
        np.asarray(j_center(jnp.asarray(cols), jnp.asarray(val))),
        atol=1e-6,
    )
    uv = rng.uniform(-5, 125, (200, 2)).astype(np.float32)
    o_j, m_j = j_bil(jnp.asarray(img), jnp.asarray(uv))
    o_t, m_t = bilinear_sample(torch.tensor(img), torch.tensor(uv))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)


def test_wrapper_checks_inputs(scene):
    images = torch.tensor(scene.images)
    Ps = torch.tensor(scene.Ps, dtype=torch.float32)
    with pytest.raises(ValueError):  # int64 view indices
        warp_gather(images, Ps, torch.tensor(VIEWS).long(),
                    torch.tensor(ORIGINS), D=D, s=S)
    with pytest.raises(TypeError):  # half images
        warp_gather(images.half(), Ps, torch.tensor(VIEWS),
                    torch.tensor(ORIGINS), D=D, s=S)
    with pytest.raises(ValueError):  # non-contiguous
        warp_gather(images.transpose(1, 2), Ps, torch.tensor(VIEWS),
                    torch.tensor(ORIGINS), D=D, s=S)
