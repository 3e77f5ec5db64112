"""Both packages' SurfaceNet training side by side over long runs on the
reference's own draws, beside each package's own one-ulp envelope.

    JAX_PLATFORMS=cpu python3 scripts/train_horizon_parity.py \
        [--cells reduced,full] [--jobs 2] [--work _scratch/horizon] \
        [--out results/train_horizon_parity.json] [--phase27 results]

A cell is a recipe at a size and a precision.  In each, both packages
start from the same weights and train on the same draws: the JAX
package's (the reference's) ``train_surfacenet`` scan path makes one key
a step (``scripts/aug_replay_inputs.py::step_keys``), and from it the
candidate, the jitter, the pair and the augmentation's N(0, 1) offsets;
the reference runs its own step (``_train_step_impl``) on those keys, one
jitted step at a time, with the sampling of ``train_steps_scan``'s body;
the port runs ``train_surface.train_steps_scan`` on the reference's
sampler tables, fed the same draws (``chip_smoke.fed``, as
``scripts/torch_aug_replay.py`` feeds the card).  Each package also runs
from the start nudged up by one float32 ulp in every parameter
(``np.nextafter``): its own float-order envelope.

Recipes (``RECIPES``):
  ft_lr1e-4  scripts/calib_finetune_eval.py:71-79 at lr 1e-4, sigma 1 px
             annealed over the run, seed 7, from weights/golden_sphere_30k
             (the port from weights_torch/golden_sphere_30k.npz)
  ft_lr3e-4  the same at lr 3e-4 (the arm that agrees on the card)
  aug_clean  robustness_aug_r04.json's clean arm (scripts/calib_aug_eval.py:
             lr 1e-3, no augmentation, seed 0), from the reference's
             create_train_state(cfg, PRNGKey(0)) variables (the port's
             through models/convert.py::params_from_jax)
Sizes (``SIZES``): "reduced", paper widths at 16^3 cubes of 2 mm, batch 2,
the record's sphere (12 views, radius 30) at 120x160, 400 steps with the
cosine schedule and the anneal over those 400, chunks of 25 (the record's
clean arm chunks by 250: at this size each chunk is a stream of its own
either way); "full", the record's own size (32^3 cubes of 0.5 mm, batch
16, 600x800 views), the first 50 steps of the real 6,000-step schedule
(the record's own draws), ft_lr1e-4 in float32 only, no nudged port run.

Recorded per cell: each run's loss at every step; at each checkpoint the
largest relative difference (max |a - b| / max |b| over a tensor, the
largest over the tensors of a group) between the port and the reference,
and between each package and its nudged run, in the parameters, the
BatchNorm running statistics and the momentum buffers; and the verdict:
the step is sound over the run if at every checkpoint every group's
port-vs-reference difference lies within ``ENVELOPE_FACTOR`` times the
larger of the two envelopes, else it is a fault (the losses' largest
relative difference so far is recorded beside its own bound, not
judged: the first step's differs by the forward's float order alone).

``--phase27 DIR`` also writes what ``chip_smoke.py`` phase 27 holds the
card to: ``train_parity_draws.npz`` (the full cell's 50 steps of draws
and the reference's sampler tables) and ``train_parity_ref.json`` (the
reference's loss at every step and, at ``chip_smoke.TRAIN_PARITY_STEPS``,
each tensor's change from the start as ``chip_smoke.change_summary``
gives it; the nudged reference's and the port's on the CPU beside it).

Each run is a child process (``--run NAME``) with its own threads; runs
already in ``--work`` are reused.  Times on 8 cores at ``--jobs 2``:
~0.5 s a reduced step in the reference and ~0.3 s in the port, a full
one ~13-19 s and ~5.7 s.  CPU only; imports both packages, as the parity
tests do.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

WEIGHTS = os.path.join(ROOT, "weights", "golden_sphere_30k")
NPZ = os.path.join(ROOT, "weights_torch", "golden_sphere_30k.npz")
RECIPES = {
    "ft_lr1e-4": dict(lr=1e-4, sigma=1.0, seed=7, start="trained"),
    "ft_lr3e-4": dict(lr=3e-4, sigma=1.0, seed=7, start="trained"),
    "aug_clean": dict(lr=1e-3, sigma=0.0, seed=0, start="init"),
}
SIZES = {
    "reduced": dict(D=16, s=2.0, batch=2, hw=(120, 160), steps=400,
                    schedule=400, checkpoints=(25, 50, 100, 200, 300, 400)),
    "full": dict(D=32, s=0.5, batch=16, hw=(600, 800), steps=50,
                 schedule=6000, checkpoints=(10, 25, 50)),
}
CHUNK = 25
# the cells: (recipe, size, dtype); the full cell's port runs once
CELLS = {
    "reduced": [(r, "reduced", "float32") for r in RECIPES]
    + [("ft_lr1e-4", "reduced", "bfloat16")],
    "full": [("ft_lr1e-4", "full", "float32")],
}
ENVELOPE_FACTOR = 3.0
GROUPS = ("params", "batch_stats", "momentum")


def configs(recipe, size, dtype):
    """The cell's config in both packages (the port's from the
    reference's JSON)."""
    from surfacenet_tpu.config import (
        Config, FusionConfig, ModelConfig, SweepConfig, TrainConfig,
        VoxelConfig,
    )
    from surfacenet_tpu_torch.config import Config as TConfig

    r, z = RECIPES[recipe], SIZES[size]
    jc = Config(
        voxel=VoxelConfig(voxel_size_mm=z["s"], cube_size=z["D"],
                          overlap=8 if size == "full" else 4),
        model=dataclasses.replace(ModelConfig(), dtype=dtype),
        sweep=SweepConfig(cube_batch=32),
        fusion=FusionConfig(n_view_pairs=4, tau=0.7, gamma=0.7,
                            ray_pool_mode="affine", n_pool_views=6),
        train=TrainConfig(
            batch_size=z["batch"], lr=r["lr"], seed=r["seed"],
            n_steps=z["schedule"], lr_decay="cosine", scan_chunk=CHUNK,
            aug_calib_sigma_px=r["sigma"],
            aug_calib_anneal_steps=z["schedule"] if r["sigma"] else 0))
    return jc, TConfig.from_json(jc.to_json())


def scene_kw(size):
    return dict(n_views=12, hw=SIZES[size]["hw"], radius=30.0, focal=200.0)


def reference_inputs(recipe, size, dtype):
    """The reference's scene, sampler, start variables, step keys and
    their draws for the cell."""
    import jax

    import aug_replay_inputs as inputs
    from surfacenet_tpu.data.synthetic import make_sphere_scene
    from surfacenet_tpu.train.train_surface import (
        create_train_state, load_pretrained, make_device_sampler,
    )

    jc, _ = configs(recipe, size, dtype)
    scene = make_sphere_scene(**scene_kw(size))
    sampler = make_device_sampler(scene, jc, seed=jc.train.seed)
    _, state = create_train_state(jc, jax.random.PRNGKey(jc.train.seed))
    if RECIPES[recipe]["start"] == "trained":
        _, variables = load_pretrained(WEIGHTS, jc)
        state = state.replace(params=variables["params"],
                              batch_stats=variables["batch_stats"])
    n = SIZES[size]["steps"]
    keys = inputs.step_keys(jc.train, n)
    idx, unit, choice, normal = inputs.recipe_draws(
        jc.train, n, n_cand=sampler[0].shape[0],
        n_pairs=sampler[1].shape[1], n_views=scene.Ps.shape[0])
    draws = dict(idx=idx, unit=unit, choice=choice, normal=normal,
                 cand_pts=np.asarray(sampler[0]),
                 cand_pairs=np.asarray(sampler[1]))
    return jc, scene, sampler, state, keys, draws


def jax_step(surf_fn, *, batch, D, s, sigma, anneal):
    """One step of the reference's ``train_steps_scan`` body from its step
    key: the same sampling, then ``_train_step_impl`` (jitted alone, so
    the state can be read after any step)."""
    import jax
    import jax.numpy as jnp

    from surfacenet_tpu.train.train_surface import _train_step_impl

    r = (jnp.arange(D, dtype=jnp.float32) + 0.5) * s
    local = jnp.stack(jnp.meshgrid(r, r, r, indexing="ij"), axis=-1)
    half_diag = s * float(np.sqrt(3)) / 2.0

    @jax.jit
    def step(state, images, Ps, cand_pts, cand_pairs, surf_params, k):
        k1, k2, k3, k_aug = jax.random.split(k, 4)
        # the body's default dtypes, named: the same bits with 64-bit
        # types enabled (the "exact" variant)
        idx = jax.random.randint(k1, (batch,), 0, cand_pts.shape[0],
                                 dtype=jnp.int32)
        jitter = jax.random.uniform(
            k2, (batch, 3), jnp.float32, minval=-0.25, maxval=0.25) * (D * s)
        origins = cand_pts[idx] - D * s / 2.0 + jitter
        centers = origins[:, None, None, None, :] + local
        labels = (surf_fn(surf_params, centers) <= half_diag).astype(
            jnp.float32)
        choice = jax.random.randint(k3, (batch,), 0, cand_pairs.shape[1],
                                    dtype=jnp.int32)
        return _train_step_impl(
            state, images, Ps, origins, cand_pairs[idx, choice], labels,
            k_aug, D=D, s=s, balanced=True, center_colors=True,
            aug_sigma_px=sigma, aug_anneal_steps=anneal)

    return step


def nudge(a):
    return np.nextafter(np.asarray(a, np.float32), np.float32(np.inf))


def is_param(name):
    return name.endswith(("weight", "bias"))


def jax_snapshot(state):
    """The reference's state in the port's names: parameters and running
    statistics, and "momentum.<name>" for each parameter's trace."""
    import jax
    import optax

    from surfacenet_tpu_torch.models.convert import params_from_jax

    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    stats = as_np(state.batch_stats)
    out = {k: v.numpy() for k, v in params_from_jax(
        {"params": as_np(state.params), "batch_stats": stats}).items()
        if "num_batches" not in k}
    traces = [t for t in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(t, optax.TraceState)]
    mom = params_from_jax({"params": as_np(traces[0].trace),
                           "batch_stats": stats})
    out.update({f"momentum.{k}": v.numpy() for k, v in mom.items()
                if is_param(k)})
    return out


def port_snapshot(state):
    out = {k: v.detach().cpu().float().numpy().copy()
           for k, v in state.model.state_dict().items()
           if "num_batches" not in k}
    names = {p: n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.state.items():
        out[f"momentum.{names[p]}"] = (
            st["momentum_buffer"].detach().cpu().numpy().copy())
    return out


def exact_bce(logits, labels, valid=None, balanced=True, eps=1e-6):
    """The reference's ``class_balanced_bce`` with its four sums in float64
    (under ``jax.enable_x64``), the per-voxel terms and the weights in
    float32 as there."""
    import jax.numpy as jnp
    import optax

    def total(a):
        return jnp.sum(a.astype(jnp.float64))

    labels = labels.astype(jnp.float32)
    per_vox = optax.sigmoid_binary_cross_entropy(logits, labels)
    valid_f = (jnp.ones_like(labels) if valid is None
               else valid.astype(jnp.float32))
    n = jnp.maximum(total(valid_f), 1.0)
    if balanced:
        n_pos = total(labels * valid_f)
        w = jnp.where(labels > 0.5, ((n - n_pos) / n).astype(jnp.float32),
                      (n_pos / n).astype(jnp.float32)) * valid_f
    else:
        w = valid_f
    return (total(per_vox * w) / jnp.maximum(total(w), eps)).astype(
        jnp.float32)


def exact_stats(x, axes, dtype=None, **_):
    """flax's BatchNorm statistics (``_compute_stats``: the mean and
    E[x^2] - mean^2, clamped at 0) with the means in float64."""
    import jax.numpy as jnp

    x = x.astype(jnp.float64)
    mean, mean2 = jnp.mean(x, axes), jnp.mean(x * x, axes)
    return (mean.astype(jnp.float32),
            jnp.maximum(0.0, mean2 - mean * mean).astype(jnp.float32))


@contextlib.contextmanager
def exact_reductions():
    """Within the block the reference sums its BatchNorm statistics and its
    loss in float64 (``exact_stats``, ``exact_bce``), the rest of its step
    as it is: the reference at another float order of its own step.  XLA's
    CPU reductions of these sums lose up to ~1e-4 relative at 8,192 voxels
    (a loss weight sum of two values repeated thousands of times, a
    channel mean of 8,192 voxels); torch's are exact to float32 (the
    port's float32 run stays within ~5e-6 of its float64 run over 40
    steps)."""
    import flax.linen.normalization as flax_norm
    import jax

    import surfacenet_tpu.train.train_surface as reference

    real = (reference.class_balanced_bce, flax_norm._compute_stats)
    reference.class_balanced_bce = exact_bce
    flax_norm._compute_stats = exact_stats
    try:
        with jax.enable_x64(True):
            yield
    finally:
        reference.class_balanced_bce, flax_norm._compute_stats = real


def train_jax(jc, scene, sampler, state, keys, checkpoints, variant=None):
    """The reference's run of ``len(keys)`` steps from ``state`` (variant
    "nudged": every parameter one ulp up; "exact": under
    ``exact_reductions``): (losses, {0 and each checkpoint: snapshot})."""
    import jax
    import jax.numpy as jnp

    if variant == "nudged":
        state = state.replace(params=jax.tree_util.tree_map(
            lambda a: jnp.asarray(nudge(a)), state.params))
    tc = jc.train
    step = jax_step(sampler[2], batch=tc.batch_size, D=jc.voxel.cube_size,
                    s=jc.voxel.voxel_size_mm, sigma=tc.aug_calib_sigma_px,
                    anneal=tc.aug_calib_anneal_steps)
    images = jnp.asarray(scene.images, jnp.float32)
    Ps = jnp.asarray(scene.Ps, jnp.float32)
    snaps, losses = {0: jax_snapshot(state)}, []
    with (exact_reductions() if variant == "exact"
          else contextlib.nullcontext()):
        for i, k in enumerate(keys):
            state, loss = step(state, images, Ps, sampler[0], sampler[1],
                               sampler[3], k)
            losses.append(float(loss))
            if i + 1 in checkpoints:
                snaps[i + 1] = jax_snapshot(state)
    return np.asarray(losses), snaps


def train_port(tc, scene, start, draws, checkpoints, variant=None):
    """The port's run on the CPU from state dict ``start`` (variant
    "nudged": every parameter one ulp up), ``train_steps_scan`` on the
    reference's sampler tables fed its draws, to the last checkpoint:
    (losses, {0 and each checkpoint: snapshot})."""
    import torch

    from chip_smoke import fed
    from surfacenet_tpu_torch.train import train_surface as tt

    if variant == "nudged":
        start = {k: torch.from_numpy(nudge(v.numpy())) if is_param(k) else v
                 for k, v in start.items()}
    state = tt.create_train_state(tc, device="cpu")
    state.model.load_state_dict(start)
    sampler = tt.make_device_sampler(scene, tc, seed=tc.train.seed,
                                     device="cpu")
    sampler = (torch.tensor(draws["cand_pts"]),
               torch.tensor(draws["cand_pairs"])) + sampler[2:]
    images = tt.gather_copy(scene.images, tc, "cpu")
    Ps = torch.tensor(scene.Ps, dtype=torch.float32)
    kw = dict(D=tc.voxel.cube_size, s=tc.voxel.voxel_size_mm,
              balanced=tc.train.class_balance,
              center_colors=tc.voxel.center_colors,
              aug_sigma_px=tc.train.aug_calib_sigma_px,
              aug_anneal_steps=tc.train.aug_calib_anneal_steps)
    snaps, losses, done = {0: port_snapshot(state)}, [], 0
    with fed(draws, "cpu", tc.train.aug_calib_sigma_px > 0) as st:
        for c in checkpoints:
            losses += tt.train_steps_scan(
                state, images, Ps, sampler, torch.Generator(), K=c - done,
                batch=tc.train.batch_size, **kw).tolist()
            done = c
            snaps[c] = port_snapshot(state)
    assert st["step"] == done and state.step == done
    return np.asarray(losses), snaps


def run_jax(recipe, size, dtype, variant):
    jc, scene, sampler, state, keys, _ = reference_inputs(recipe, size,
                                                          dtype)
    return train_jax(jc, scene, sampler, state, keys,
                     SIZES[size]["checkpoints"], variant)


def run_port(recipe, size, dtype, variant):
    from surfacenet_tpu_torch.data.synthetic import make_sphere_scene
    from surfacenet_tpu_torch.models.convert import load_npz, params_from_jax

    _, tc = configs(recipe, size, dtype)
    _, _, _, jstate, _, draws = reference_inputs(recipe, size, dtype)
    if RECIPES[recipe]["start"] == "trained":
        start = load_npz(NPZ)
    else:
        start = params_from_jax({
            "params": jax_tree_np(jstate.params),
            "batch_stats": jax_tree_np(jstate.batch_stats)})
    return train_port(tc, make_sphere_scene(**scene_kw(size)), start, draws,
                      SIZES[size]["checkpoints"], variant)


def jax_tree_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def run_name(recipe, size, dtype, package, variant=None):
    return f"{recipe}.{size}.{dtype}.{package}" + (f".{variant}" if variant
                                                   else "")


def run_one(name, work):
    """Child process: one run, written to ``work/<name>.npz``."""
    recipe, size, dtype, package, *rest = name.split(".")
    t0 = time.perf_counter()
    fn = run_jax if package == "jax" else run_port
    losses, snaps = fn(recipe, size, dtype, rest[0] if rest else None)
    arrays = {"losses": losses, "seconds": time.perf_counter() - t0}
    for c, snap in snaps.items():
        arrays.update({f"{c}/{k}": v for k, v in snap.items()})
    np.savez(os.path.join(work, name + ".npz"), **arrays)
    print(f"{name}: {len(losses)} steps in {arrays['seconds']:.1f} s, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)


def load_run(work, name):
    z = np.load(os.path.join(work, name + ".npz"))
    snaps = {}
    for k in z.files:
        if "/" in k:
            c, key = k.split("/", 1)
            snaps.setdefault(int(c), {})[key] = z[k]
    return dict(losses=z["losses"], seconds=float(z["seconds"]),
                snaps=snaps)


def group_of(key):
    if key.startswith("momentum."):
        return "momentum"
    return "batch_stats" if "running_" in key else "params"


def rel_diffs(a, b):
    """{group: (largest relative difference, its tensor)} of snapshot a
    against b."""
    out = {}
    for k, ref in b.items():
        d = float(np.abs(a[k].astype(np.float64) - ref).max()
                  / max(float(np.abs(ref).max()), 1e-30))
        g = group_of(k)
        if g not in out or d > out[g][0]:
            out[g] = (d, k)
    return out


def loss_diff(a, b, upto):
    return float(np.max(np.abs(a[:upto] - b[:upto]) / np.abs(b[:upto])))


# each cell's runs: (package, variant); the full cell runs no nudged port
RUNS = (("jax", None), ("jax", "nudged"), ("jax", "exact"), ("port", None),
        ("port", "nudged"))
# the envelopes of each verdict: one-ulp start nudges, then with the
# reference at another float order of its own step (its sums exact)
ENVELOPES = {"verdict": ("ref_envelope", "port_envelope"),
             "verdict_float_order": ("ref_envelope", "port_envelope",
                                     "ref_exact")}


def cell_runs(size):
    return [r for r in RUNS if not (size == "full" and r == ("port",
                                                             "nudged"))]


def compare(work, recipe, size, dtype):
    """The cell's record: losses, differences at each checkpoint, the
    verdicts."""
    runs = {}
    for p, v in cell_runs(size):
        name = run_name(recipe, size, dtype, p, v)
        if os.path.exists(os.path.join(work, name + ".npz")):
            runs[(p, v)] = load_run(work, name)
    ref, port = runs[("jax", None)], runs[("port", None)]
    pairs = {"port_vs_ref": (port, ref),
             "ref_envelope": (runs.get(("jax", "nudged")), ref),
             "port_envelope": (runs.get(("port", "nudged")), port),
             "ref_exact": (runs.get(("jax", "exact")), ref)}
    pairs = {k: v for k, v in pairs.items() if v[0] is not None}
    checkpoints, fails = [], {k: [] for k in ENVELOPES}
    present = {v: [k for k in labels if k in pairs]
               for v, labels in ENVELOPES.items()}
    for c in SIZES[size]["checkpoints"]:
        row = {"step": c}
        for label, (a, b) in pairs.items():
            d = rel_diffs(a["snaps"][c], b["snaps"][c])
            row[label] = {g: d[g][0] for g in GROUPS}
            row[label]["worst"] = {g: d[g][1] for g in GROUPS}
            row[label]["loss"] = loss_diff(a["losses"], b["losses"], c)
        for verdict, labels in present.items():
            envs = [row[k] for k in labels]
            bound = {g: ENVELOPE_FACTOR * max(e[g] for e in envs)
                     for g in (*GROUPS, "loss")}
            within = {g: row["port_vs_ref"][g] <= bound[g] for g in GROUPS}
            row[verdict] = {"bound": bound, "within": within}
            fails[verdict] += [f"{g} at step {c}"
                               for g, ok in within.items() if not ok]
        checkpoints.append(row)
    out = {"recipe": recipe, "size": size, "dtype": dtype,
           "steps": SIZES[size]["steps"],
           "losses": {p + (f"_{v}" if v else ""):
                      [round(float(x), 7) for x in r["losses"]]
                      for (p, v), r in runs.items()},
           "seconds": {p + (f"_{v}" if v else ""): r["seconds"]
                       for (p, v), r in runs.items()},
           "checkpoints": checkpoints}
    for verdict, labels in present.items():
        out[verdict] = (
            f"sound: the port within {ENVELOPE_FACTOR:g}x the larger of "
            f"{', '.join(labels)} at every checkpoint"
            if not fails[verdict] else
            f"fault: the port leaves {ENVELOPE_FACTOR:g}x the larger of "
            f"{', '.join(labels)}: " + ", ".join(fails[verdict]))
    return out


def phase27_files(work, out_dir):
    """``chip_smoke.py`` phase 27's draws and reference trajectory from the
    full cell's runs."""
    import chip_smoke

    recipe, size, dtype = CELLS["full"][0]
    jc, _, _, _, _, draws = reference_inputs(recipe, size, dtype)
    np.savez_compressed(
        os.path.join(out_dir, "train_parity_draws.npz"), **draws,
        seed=np.int64(jc.train.seed), recipe="finetune")
    runs = {label: load_run(work, run_name(recipe, size, dtype, p, v))
            for label, p, v in (("ref", "jax", None),
                                ("ref_nudged", "jax", "nudged"),
                                ("ref_exact", "jax", "exact"),
                                ("port_cpu", "port", None))}
    traj = {
        "recipe": "scripts/calib_finetune_eval.py at lr 1e-4, sigma 1 "
                  "annealed over 6,000 steps, seed 7, chunks of 25, batch "
                  "16, 32^3 cubes of 0.5 mm, float32, from "
                  "weights/golden_sphere_30k; the first "
                  f"{SIZES[size]['steps']} steps",
        "steps": SIZES[size]["steps"],
        "summary_steps": list(chip_smoke.TRAIN_PARITY_STEPS),
        "direction_seed": chip_smoke.TRAIN_PARITY_DIRECTION_SEED,
    }
    steps = chip_smoke.TRAIN_PARITY_STEPS
    for label, r in runs.items():
        keep = [k for k in r["snaps"][0] if group_of(k) != "momentum"]
        start = {k: r["snaps"][0][k] for k in keep}
        traj[label] = {
            "losses": [float(x) for x in r["losses"]],
            "changes": {str(c): chip_smoke.change_summary(
                start, {k: r["snaps"][c][k] for k in keep}) for c in steps},
        }
    # each run's readings against the reference, as phase 27 reads the
    # card's: the CPU envelope its bounds come from
    diffs = {label: chip_smoke.parity_diffs(traj[label], traj["ref"])
             for label in runs if label != "ref"}
    traj["envelope"] = {str(c): {label: d[str(c)] for label, d in
                                 diffs.items()} for c in steps}
    with open(os.path.join(out_dir, "train_parity_ref.json"), "w") as f:
        json.dump(traj, f, indent=1)
        f.write("\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="reduced,full")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--work", default=os.path.join(ROOT, "_scratch",
                                                   "horizon"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "results", "train_horizon_parity.json"))
    ap.add_argument("--phase27", default=None, metavar="DIR")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.makedirs(args.work, exist_ok=True)
    if args.run:
        import torch

        torch.set_num_threads(int(os.environ.get("HORIZON_THREADS", "4")))
        run_one(args.run, args.work)
        return 0
    cells = [c for name in args.cells.split(",") for c in CELLS[name]]
    todo = [name for recipe, size, dtype in cells
            for name in (run_name(recipe, size, dtype, p, v)
                         for p, v in cell_runs(size))
            if not os.path.exists(os.path.join(args.work, name + ".npz"))]
    threads = max(1, (os.cpu_count() or 8) // args.jobs)
    env = dict(os.environ, HORIZON_THREADS=str(threads),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_cpu_multi_thread_eigen=true"
               f" intra_op_parallelism_threads={threads}")

    def child(name):
        return subprocess.run(
            [sys.executable, __file__, "--run", name, "--work", args.work],
            env=env, check=True)

    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(child, todo))
    record = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            record = json.load(f)
    record.setdefault("cells", {})
    for cell in cells:
        rec = compare(args.work, *cell)
        record["cells"][".".join(cell)] = rec
        print(json.dumps({".".join(cell): {k: rec[k] for k in ENVELOPES}}),
              flush=True)
    record["envelope_factor"] = ENVELOPE_FACTOR
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    if args.phase27:
        phase27_files(args.work, args.phase27)
    return 0


if __name__ == "__main__":
    sys.exit(main())
