"""Time variants of the port's affine vote and mask kernels
(``csrc/affine_vote.cu`` and ``csrc/affine_pool.cu`` on the shared
``csrc/affine_ray.cuh``).

    python3 scripts/torch_affine_variants.py [--parent DIR]

Each variant is the shipped source with a few lines of ``affine_ray.cuh``
replaced, built with the port's own ``nvcc`` flags into a temporary
directory and called through the same C entries, on a route the variant
names:

- ``shipped``: the routes ``affine_route`` chooses (``tile`` at the sweep's
  window 2, ``segment`` at window 0);
- ``direct``: the first design, one thread a voxel that re-rounds two
  offsets and tests its bounds at every tap, forced at windows 2 and 0
  through the entries' ``direct`` route;
- the tile route's output tile: 16^3 (the first tile design, 256
  threads), 8^3 (64 threads) and z 16 x y 16 x x 32 (512 threads),
  against the shipped z 16 x y 8 x x 32 (256 threads);
- only the halo that the block's views read staged (w along a ray axis,
  floor(|s| w + 1) along a sheared one, from the slopes), against the
  shipped whole w + 1 halo; registers capped so that 1024 threads an SM
  fit (64 a thread), against the compiler's choice;
- the tile staged with plain 16-byte loads (each a round trip before the
  next) instead of ``cp.async``;
- the tile route's stores packed: a warp's 32 results of a slab collected
  by a ballot and stored 16 bytes a lane (the mask; the vote's stores stay),
  against the shipped byte a lane;
- with ``--parent DIR``: the sources of the tree at DIR (a ``git
  archive`` of an earlier commit) as they are, through their own entries.

Every variant is first held bitwise (``torch.equal``) against the plain
versions (``ops/ray_pooling.py::ray_vote_affine_plain`` and
``ray_max_mask_affine_plain``) on the inputs it is timed on.  Diagnostics
that leave out part of the work (the segment route's pass 1 alone or pass
2 alone; the tile route's staging alone, no taps) are timed, never
checked: their output is wrong.

The inputs are ``chip_smoke.py``'s: the smoke scene (12 views of 600x800,
``dtu9_full``, its first batch of 24 cubes of 64^3 through a fast64
SurfaceNet of seed-0 random weights, unrefined cameras), the vote on the 24
cubes x 6 pooling views, the mask on their 144 (cube, view) items.  Times
are device milliseconds from a CUDA graph of 20 calls (``graph_ms``),
variants in turns (forwards, then backwards; the mean is reported), with
the eager time of 20 back-to-back calls beside them and the bound.  Prints
the card's name and power limit, ``ptxas`` register and spill counts, and
one JSON line a measurement.  Needs an NVIDIA Hopper card; PyTorch only.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import bound, cuda_ms, graph_ms  # noqa: E402
from surfacenet_tpu_torch.config import baseline_config  # noqa: E402
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402
from surfacenet_tpu_torch.models.surfacenet import (  # noqa: E402
    init_surfacenet, make_predictor,
)
from surfacenet_tpu_torch.ops.cuda import _build  # noqa: E402
from surfacenet_tpu_torch.ops.cuda.affine_vote import (  # noqa: E402
    ROUTES, affine_route,
)
from surfacenet_tpu_torch.ops.ray_pooling import (  # noqa: E402
    item_params, ray_max_mask_affine_plain, ray_vote_affine_plain,
    vote_params,
)
from surfacenet_tpu_torch.pipeline.sweep import (  # noqa: E402
    cube_batch_step, gather_images, plan_sweep, pool_views_for,
    resolve_pool_window,
)

HEADER = "affine_ray.cuh"
SOURCES = ("affine_vote", "affine_pool")
_TILE = "constexpr int TILE_Z = 16, TILE_Y = 8, TILE_X = 32;"
_CP_ASYNC = """      if (in_cube(z, D) && in_cube(y, D) && in_cube(x, D))
        cp_async16(dst, p + ((size_t)z * D + y) * D + x);
      else
        *dst = make_float4(AFFINE_RAY_NEG, AFFINE_RAY_NEG, AFFINE_RAY_NEG,
                           AFFINE_RAY_NEG);
"""
_LOADS = """      float4 v = make_float4(AFFINE_RAY_NEG, AFFINE_RAY_NEG, AFFINE_RAY_NEG,
                             AFFINE_RAY_NEG);
      if (in_cube(z, D) && in_cube(y, D) && in_cube(x, D))
        v = __ldg(reinterpret_cast<const float4*>(
            p + ((size_t)z * D + y) * D + x));
      *dst = v;
"""
_STORE_START = "  // a warp's stores are one run of 32 counts (or bytes) along x\n"
_STORE_END = "template <bool MASK, int W>\ncudaError_t launch_tile_w"
_PACKED = """  const bool in_yx = gy < D && gx < D;
  if (!MASK) {
    int32_t* votes = reinterpret_cast<int32_t*>(out) + n * n_vox;
#pragma unroll
    for (int j = 0; j < TILE_Z; ++j) {
      const int gz = org[0] + j;
      if (in_yx && gz < D)
        votes[((size_t)gz * D + gy) * D + gx] =
            (cnt[j >> 2] >> (8 * (j & 3))) & 0xffu;
    }
  } else {
    // a warp's 32 voxels of slab j are 32 / CB runs of CB bytes along x
    constexpr int CB = TILE_X < 16 ? TILE_X : 16;
    uint8_t* mask = reinterpret_cast<uint8_t*>(out) + n * n_vox;
    const int lane = threadIdx.x & 31;
    const int run = threadIdx.x - lane + lane * CB;  // lanes < 32 / CB store
    const int ry = org[1] + run / TILE_X, rx = org[2] + run % TILE_X;
#pragma unroll
    for (int j = 0; j < TILE_Z; ++j) {
      const uint32_t bits = __ballot_sync(
          0xffffffffu, ((cnt[j >> 2] >> (8 * (j & 3))) & 0xffu) > 0);
      const int gz = org[0] + j;
      if (lane >= 32 / CB || gz >= D || ry >= D) continue;
      const uint32_t mine = (bits >> (lane * CB)) & ((1ull << CB) - 1);
      uint8_t* dst = mask + ((size_t)gz * D + ry) * D + rx;
      if (D % 16 == 0 && rx + CB <= D) {
        uint32_t w[CB / 4];
#pragma unroll
        for (int q = 0; q < CB / 4; ++q) {
          const uint32_t b = mine >> (4 * q);  // 4 bits -> 4 bytes of 0 / 1
          w[q] = (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) |
                 ((b & 8u) << 21);
        }
        if constexpr (CB == 16)
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        else if constexpr (CB == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = w[0];
      } else {
        for (int q = 0; q < CB && rx + q < D; ++q) dst[q] = (mine >> q) & 1u;
      }
    }
  }
}

"""
_VIEWS = "  for (int k = 0; k < K; ++k) {\n    const int* rows"
_BOUNDS = "__global__ void __launch_bounds__(TILE_THREADS)\naffine_tile_kernel"
_STAGE_START = "// Stage the tile at (oz, oy, ox)"
_STAGE_END = "// Table rows of the block's K views"
_STAGE_CALL = ("  stage_tile<W>(tile, vol + n * n_vox, D, org[0], org[1], org[2], "
               "vec);\n")
# the halo that the block's views read, from their slopes, and a stage_tile
# that copies only that part of the w + 1 box
_TRIMMED = """// The halo (hz, hy, hx) that the block's active views read: w along a
// view's ray axis, and along its o1 / o2 axes the most that a tap's shear
// offset moves, |oi(t) - oi(t + d)| <= floor(|s| w + 1) for |d| <= w (w + 1
// at most; the 0.001 covers the float products' rounding; a slope outside
// [-1, 1] gets w + 1, and build_table traps on it).  The taps read nothing
// outside it, so the rest of the staged box is neither copied nor filled.
template <int W>
__device__ __forceinline__ void tile_halo(const int32_t* __restrict__ axis,
                                          const float* __restrict__ slopes,
                                          int K, int& hz, int& hy, int& hx) {
  constexpr int CHUNK = 4;  // views whose loads are issued together
  hz = hy = hx = 0;
  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    int a[CHUNK];
    float2 sl[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const bool live = k0 + i < K;
      a[i] = live ? __ldg(axis + k0 + i) : -1;
      sl[i] = live ? __ldg(reinterpret_cast<const float2*>(slopes) + k0 + i)
                   : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (a[i] < 0 || a[i] > 2) continue;
      const float s0 = fabsf(sl[i].x), s1 = fabsf(sl[i].y);
      const int h0 = s0 <= 1.0f ? min(W + 1, (int)(s0 * W + 1.001f)) : W + 1;
      const int h1 = s1 <= 1.0f ? min(W + 1, (int)(s1 * W + 1.001f)) : W + 1;
      // (o1, o2, a) = (y, x, z), (z, x, y), (z, y, x) for a = 0, 1, 2
      hz = max(hz, a[i] == 0 ? W : h0);
      hy = max(hy, a[i] == 0 ? h0 : (a[i] == 1 ? W : h1));
      hx = max(hx, a[i] == 2 ? W : h1);
    }
  }
}

template <int W>
__device__ __forceinline__ void stage_tile(float* __restrict__ tile,
                                           const float* __restrict__ p, int D,
                                           int oz, int oy, int ox, int hz,
                                           int hy, int hx, bool vec) {
  using G = TileGeom<W>;
  const int z0 = oz - G::H, y0 = oy - G::H, x0 = ox - G::HX;
  const int zlo = G::H - hz, zhi = G::H + TILE_Z + hz;
  const int ylo = G::H - hy, yhi = G::H + TILE_Y + hy;
  if (vec) {
    constexpr int QX = G::SX / 4;
    const int qlo = G::HX / 4 - (hx + 3) / 4;
    const int qhi = (G::HX + TILE_X) / 4 + (hx + 3) / 4;
    float4* t4 = reinterpret_cast<float4*>(tile);
    for (int q = threadIdx.x; q < G::SZ * G::SY * QX; q += TILE_THREADS) {
      const int xq = q % QX, r = q / QX;
      const int zz = r / G::SY, yy = r % G::SY;
      if (zz < zlo || zz >= zhi || yy < ylo || yy >= yhi || xq < qlo ||
          xq >= qhi)
        continue;
      const int z = z0 + zz, y = y0 + yy, x = x0 + 4 * xq;
      float4* dst = t4 + q;
      if (in_cube(z, D) && in_cube(y, D) && in_cube(x, D))
        cp_async16(dst, p + ((size_t)z * D + y) * D + x);
      else
        *dst = make_float4(AFFINE_RAY_NEG, AFFINE_RAY_NEG, AFFINE_RAY_NEG,
                           AFFINE_RAY_NEG);
    }
  } else {
    for (int q = threadIdx.x; q < G::FLOATS; q += TILE_THREADS) {
      const int xx = q % G::SX, r = q / G::SX;
      const int zz = r / G::SY, yy = r % G::SY;
      if (zz < zlo || zz >= zhi || yy < ylo || yy >= yhi ||
          xx < G::HX - hx || xx >= G::HX + TILE_X + hx)
        continue;
      const int z = z0 + zz, y = y0 + yy, x = x0 + xx;
      tile[q] = (in_cube(z, D) && in_cube(y, D) && in_cube(x, D))
                    ? __ldg(p + ((size_t)z * D + y) * D + x)
                    : AFFINE_RAY_NEG;
    }
  }
}

"""
_TRIMMED_CALL = """  int hz, hy, hx;
  tile_halo<W>(ax, sl, K, hz, hy, hx);
  stage_tile<W>(tile, vol + n * n_vox, D, org[0], org[1], org[2], hz, hy, hx,
                vec);
"""
_PASS1 = "  if (blocks1 > 0) {"
_PASS2 = "  // ordered after pass 1 on the same stream\n  affine_segment_compare"


def replace(old, new):
    def step(text):
        if text.count(old) != 1:
            raise RuntimeError(f"variant anchor not found once: {old[:60]!r}")
        return text.replace(old, new)
    return step


def cut(start, end, new):
    """A step replacing the text from ``start`` up to ``end`` (kept)."""
    def step(text):
        i = text.index(start)
        return text[:i] + new + text[text.index(end, i):]
    return step


def tile(z, y, x):
    return replace(_TILE, f"constexpr int TILE_Z = {z}, TILE_Y = {y}, "
                          f"TILE_X = {x};")


# name -> (edits of affine_ray.cuh, [(kernel, window, route)], checked)
VARIANTS = {
    "shipped": ([], [("vote", 2, None), ("vote", 0, None),
                     ("mask", 2, None), ("mask", 0, None)], True),
    "direct": ([], [("vote", 2, "direct"), ("vote", 0, "direct"),
                    ("mask", 2, "direct"), ("mask", 0, "direct")], True),
    "tile_16x16x16": ([tile(16, 16, 16)],
                      [("vote", 2, None), ("mask", 2, None)], True),
    "tile_8x8x8": ([tile(8, 8, 8)], [("vote", 2, None), ("mask", 2, None)],
                   True),
    "tile_z16_y16_x32": ([tile(16, 16, 32)],
                         [("vote", 2, None), ("mask", 2, None)], True),
    "trimmed_halo": ([cut(_STAGE_START, _STAGE_END, _TRIMMED),
                      replace(_STAGE_CALL, _TRIMMED_CALL)],
                  [("vote", 2, None), ("mask", 2, None)], True),
    "registers_capped": ([replace(_BOUNDS, _BOUNDS.replace(
        "(TILE_THREADS)", "(TILE_THREADS, 1024 / TILE_THREADS)"))],
        [("vote", 2, None), ("mask", 2, None)], True),
    "plain_loads": ([replace(_CP_ASYNC, _LOADS)],
                    [("vote", 2, None), ("mask", 2, None)], True),
    "packed_mask_stores": ([cut(_STORE_START, _STORE_END, _PACKED)],
                           [("mask", 2, None)], True),
    "diag_segment_pass1": ([replace(_PASS2, _PASS2.replace(
        "  affine_segment_compare", "  if (false) affine_segment_compare"))],
        [("vote", 0, None), ("mask", 0, None)], False),
    "diag_segment_pass2": ([replace(_PASS1, "  if (false) {")],
                           [("vote", 0, None), ("mask", 0, None)], False),
    "diag_tile_staging": ([replace(_VIEWS, _VIEWS.replace("k < K", "k < 0"))],
                          [("vote", 2, None), ("mask", 2, None)], False),
}

_VOTE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_POOL_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the parent's entries (no plane scratch, no route)
_PARENT_VOTE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_PARENT_POOL_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def build(variants, parent, tmp):
    """Build every variant's two libraries, all ``nvcc`` in parallel.
    Returns {name: {source: CDLL path}} and the compiler logs."""
    nvcc = _build.nvcc_path()
    jobs = []
    for name, (edits, _, _) in variants.items():
        src = os.path.join(tmp, name)
        os.makedirs(src)
        for f in os.listdir(_build.SRC_DIR):
            shutil.copy(os.path.join(_build.SRC_DIR, f), src)
        with open(os.path.join(src, HEADER)) as f:
            text = f.read()
        for step in edits:
            text = step(text)
        with open(os.path.join(src, HEADER), "w") as f:
            f.write(text)
        jobs.append((name, src))
    if parent:
        jobs.append(("parent", os.path.join(parent, "surfacenet_tpu_torch",
                                            "csrc")))
    procs = []
    for name, src in jobs:
        for s in SOURCES:
            out = os.path.join(tmp, f"{name}-{s}.so")
            procs.append((name, s, out, subprocess.Popen(
                [nvcc, *_build.FLAGS, "-o", out, os.path.join(src, f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for name, s, out, proc in procs:
        text, _ = proc.communicate()
        logs[(name, s)] = text
        if proc.returncode:
            raise RuntimeError(f"build of {name}/{s} failed:\n{text}")
        libs.setdefault(name, {})[s] = out
    return libs, logs


class Entries:
    """A variant's two C entries, called as the wrappers call them, on a
    forced route (None: ``affine_route``'s)."""

    def __init__(self, paths, parent=False):
        self.parent = parent
        self.vote = ctypes.CDLL(paths["affine_vote"]).affine_vote
        self.pool = ctypes.CDLL(paths["affine_pool"]).affine_pool
        self.vote.argtypes = _PARENT_VOTE_ARGS if parent else _VOTE_ARGS
        self.pool.argtypes = _PARENT_POOL_ARGS if parent else _POOL_ARGS
        self.vote.restype = self.pool.restype = ctypes.c_int

    def __call__(self, kernel, x, axis, slopes, window, route):
        N, D = x.shape[0], x.shape[1]
        K = axis.shape[1] if kernel == "vote" else 1
        route = route or affine_route(D, K, window)
        out = torch.empty((N, D, D, D), device=x.device,
                          dtype=torch.int32 if kernel == "vote" else torch.bool)
        stream = torch.cuda.current_stream().cuda_stream
        head = (x.data_ptr(), axis.data_ptr(), slopes.data_ptr(),
                out.data_ptr())
        sizes = (N, K, D) if kernel == "vote" else (N, D)
        fn = self.vote if kernel == "vote" else self.pool
        if self.parent:
            err = fn(*head, *sizes, window, stream)
        else:
            planes = (torch.empty((N * K, D, D), device=x.device)
                      if route == "segment" else None)
            err = fn(*head, planes.data_ptr() if planes is not None else None,
                     *sizes, window, ROUTES.index(route), stream)
        if err:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
        return out


def smoke_inputs(dev):
    """chip_smoke.py's first batch: the vote's cubes and the mask's items."""
    cfg = baseline_config("dtu9_full")
    D, s = cfg.voxel.cube_size, cfg.voxel.voxel_size_mm
    scene = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
                              focal=1000.0)
    Ps = torch.as_tensor(scene.Ps, dtype=torch.float32, device=dev)
    plan = plan_sweep(scene.Ps, scene.bbox_min, scene.bbox_max,
                      scene.images.shape[1:3], cfg, dev)
    batch = plan.batch(slice(0, cfg.sweep.cube_batch), dev)
    origins, uniq = batch[0], batch[3]
    images = gather_images(torch.as_tensor(scene.images, device=dev),
                           torch.bfloat16)
    model = init_surfacenet(cfg.model, torch.Generator().manual_seed(0))
    window = resolve_pool_window(cfg)
    with torch.inference_mode():
        _, fused, _ = cube_batch_step(
            images, Ps, *batch, D=D, s=s, n_pairs=cfg.fusion.n_view_pairs,
            tau=cfg.fusion.tau, gamma=cfg.fusion.gamma, adaptive=False,
            center_colors=cfg.voxel.center_colors,
            predict=make_predictor(model, cfg.model, dev),
            n_pool_views=cfg.fusion.n_pool_views, pool_window=window,
            ray_pool_mode="affine")
    pool_views, view_mask = pool_views_for(uniq, cfg.fusion.n_pool_views,
                                           cfg.fusion.n_view_pairs)
    fused = fused.contiguous()
    axis, slopes = vote_params(origins, s, Ps[pool_views.long()], view_mask,
                               D)
    K = pool_views.shape[1]
    items = fused.repeat_interleave(K, dim=0).contiguous()
    axis_i, slopes_i = item_params(origins.repeat_interleave(K, dim=0), s,
                                   Ps[pool_views.reshape(-1).long()], D)
    return {"vote": (fused, axis, slopes), "mask": (items, axis_i, slopes_i)}


def bound_of(kernel, x, axis, slopes, window):
    D = x.shape[1]
    n_vox = x.numel()
    max_ops = (D - 1) / D if window <= 0 else 2 * window
    if kernel == "vote":
        active = int((axis >= 0).sum().item())
        n_bytes = n_vox * 8 + axis.numel() * 4 + slopes.numel() * 4
        return bound(n_bytes, active * D**3 * (max_ops + 2))
    n_bytes = n_vox * 5 + axis.numel() * 4 + slopes.numel() * 4
    return bound(n_bytes, n_vox * (max_ops + 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a tree of an earlier commit whose "
                    "affine sources are timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_affine_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        libs, logs = build(VARIANTS, args.parent, tmp)
        for (name, s), text in sorted(logs.items()):
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}/{s}: {line.strip()}")
        entries = {name: Entries(paths, parent=(name == "parent"))
                   for name, paths in libs.items()}
        inputs = smoke_inputs(dev)
        plain = {
            ("vote", w): ray_vote_affine_plain(*inputs["vote"], w)
            for w in (0, 2)}
        plain.update({
            ("mask", w): ray_max_mask_affine_plain(*inputs["mask"], w)
            for w in (0, 2)})
        runs = [(name, kernel, window, route)
                for name, (_, cases, _) in VARIANTS.items()
                for kernel, window, route in cases]
        if args.parent:
            runs += [("parent", k, w, None) for k in ("vote", "mask")
                     for w in (2, 0)]
        # check first: every variant that computes the function, bitwise;
        # one that does not launch is reported and left out
        for run in list(runs):
            name, kernel, window, route = run
            try:
                got = entries[name](kernel, *inputs[kernel], window, route)
            except RuntimeError as e:
                print(json.dumps({"variant": name, "kernel": kernel,
                                  "window": window, "failed": str(e)}))
                runs.remove(run)
                continue
            torch.cuda.synchronize()
            if (name not in VARIANTS or VARIANTS[name][2]) and not \
                    torch.equal(got, plain[(kernel, window)]):
                raise RuntimeError(f"{name} {kernel} window {window} differs "
                                   f"from its plain version")
            del got
        print(f"{len(runs)} runs built and checked", flush=True)
        times = {}
        for order in (runs, runs[::-1]):
            for run in order:
                name, kernel, window, route = run

                def call():
                    return entries[name](kernel, *inputs[kernel], window,
                                         route)
                times.setdefault(run, []).append(
                    (graph_ms(call, iters=20), cuda_ms(call, iters=20)))
        for run in runs:
            name, kernel, window, route = run
            x, axis, slopes = inputs[kernel]
            b_ms, b_by = bound_of(kernel, x, axis, slopes, window)
            t = times[run]
            ms = sum(g for g, _ in t) / len(t)
            print(json.dumps({
                "variant": name, "kernel": kernel, "window": window,
                "route": "first design" if name == "parent" else (
                    route or affine_route(
                        x.shape[1], axis.shape[1] if kernel == "vote" else 1,
                        window)),
                "checked": name == "parent" or VARIANTS[name][2],
                "ms": ms, "turns_ms": [g for g, _ in t],
                "eager_ms": sum(e for _, e in t) / len(t),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / ms, "items": x.shape[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
