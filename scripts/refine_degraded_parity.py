"""Both packages' calibration prepass on the miscalibrated op-point spheres.

    JAX_PLATFORMS=cpu python3 scripts/refine_degraded_parity.py [--out FILE]
        [--sigmas 0,0.5,1,2]

The scenes of ``results/robustness_r05.json`` (``scripts/robustness_refine_
eval.py``): the op-point sphere ``make_sphere_scene(n_views=12, hw=(600,
800), radius=30.0, focal=200.0)`` in memory, float32, clean and through
``degrade_scene(clean, calib_sigma_px=sigma, seed=1)`` at sigma 0.5, 1 and
2 px.  Each package builds the scenes itself (they must be bitwise equal)
and runs its own ``refine_calibration_auto`` on the CPU at the presets'
schedule (80 Adam steps a level and phase, 2048 probes) on the scene's
bbox, as ``run_sweep`` calls it; the JAX package runs a second time from
matrices nudged up by one float32 ulp, the reference's own sensitivity to
float order (ROADMAP C4).

Per sigma it records each package's passes, pass kinds, largest shift and
per-view shifts (px), the JAX run's refined matrices, the largest
per-view difference between the packages, the JAX package's one-ulp
spread, and each run's RMS residual against the injected shifts (the
mean over the views removed: the prepass centres its shifts).  Prints one JSON line a sigma and writes the whole
record to ``--out`` (``chip_smoke.py`` phase 24 holds the card's prepass
to it).  Runs on the CPU only; imports both packages, as the parity tests
do.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import surfacenet_tpu.geometry.refine as J  # noqa: E402
import surfacenet_tpu_torch.geometry.refine as T  # noqa: E402
from surfacenet_tpu.data import synthetic as jsyn  # noqa: E402
from surfacenet_tpu_torch.data import synthetic as tsyn  # noqa: E402

KW = dict(steps_per_level=80, n_probes=2048)  # the presets' prepass
SCENE = dict(n_views=12, hw=(600, 800), radius=30.0, focal=200.0)


def injected_shifts(Ps, clean_Ps):
    """(V, 2) pixel shifts du, dv that ``degrade_scene`` added:
    P[r] = clean[r] + d_r * clean[2] for rows r 0 and 1."""
    row2 = clean_Ps[:, 2]
    return np.stack([((Ps[:, r] - clean_Ps[:, r]) * row2).sum(1)
                     / (row2 * row2).sum(1) for r in (0, 1)], axis=1)


def rms_residual(duv, true):
    """RMS over views and axes of the correction plus the injected shift,
    the common shift removed (the prepass cannot see it)."""
    r = np.asarray(duv, np.float64) + true
    return float(np.sqrt(((r - r.mean(0)) ** 2).mean()))


def reading(info, s, true):
    return {"passes": int(info["passes"]),
            "pass_kinds": list(info.get("pass_kinds", ["default"])),
            "max_shift_px": float(info["max_shift_px"]),
            "duv_px": np.asarray(info["duv_px"], np.float64).round(4).tolist(),
            "rms_residual_px": rms_residual(info["duv_px"], true),
            "s": s}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--sigmas", default="0,0.5,1,2")
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    clean_j = jsyn.make_sphere_scene(**SCENE)
    clean_t = tsyn.make_sphere_scene(**SCENE)
    out = {"scene": "make_sphere_scene(n_views=12, hw=(600, 800), "
                    "radius=30.0, focal=200.0), in memory; degrade_scene("
                    "clean, calib_sigma_px=sigma, seed=1)",
           **KW, "sigmas": {}}
    for sigma in (float(x) for x in args.sigmas.split(",")):
        if sigma:
            sj = jsyn.degrade_scene(clean_j, calib_sigma_px=sigma, seed=1)
            st = tsyn.degrade_scene(clean_t, calib_sigma_px=sigma, seed=1)
        else:
            sj, st = clean_j, clean_t
        if not (np.array_equal(sj.images, st.images)
                and np.array_equal(sj.Ps, st.Ps)):
            raise SystemExit(f"sigma {sigma}: the packages' scenes differ")
        true = injected_shifts(np.asarray(sj.Ps, np.float64),
                               np.asarray(clean_j.Ps, np.float64))
        box = (sj.bbox_min, sj.bbox_max)
        t0 = time.perf_counter()
        P_j, i_j = J.refine_calibration_auto(sj.images, sj.Ps, *box, **KW)
        r_j = reading(i_j, time.perf_counter() - t0, true)
        # the refined matrices (float32, exact in JSON) for a sweep of the
        # reference's prepass on the card
        r_j["Ps_refined"] = np.asarray(P_j, np.float32).tolist()
        nudged = np.nextafter(np.asarray(sj.Ps, np.float32),
                              np.float32(np.inf)).astype(sj.Ps.dtype)
        t0 = time.perf_counter()
        _, i_n = J.refine_calibration_auto(sj.images, nudged, *box, **KW)
        r_n = reading(i_n, time.perf_counter() - t0, true)
        t0 = time.perf_counter()
        _, i_t = T.refine_calibration_auto(st.images, st.Ps, *box,
                                           device="cpu", **KW)
        r_t = reading(i_t, time.perf_counter() - t0, true)
        dj, dn, dt = (np.asarray(i["duv_px"], np.float64)
                      for i in (i_j, i_n, i_t))
        row = {
            "injected_px": true.round(4).tolist(),
            "injected_rms_px": rms_residual(np.zeros_like(true), true),
            "jax": r_j, "jax_nudged": r_n, "port": r_t,
            "max_view_diff_px": float(np.abs(dt - dj).max()),
            "jax_one_ulp_spread_px": float(np.abs(dn - dj).max()),
            "rms_residual_diff_px": abs(r_t["rms_residual_px"]
                                        - r_j["rms_residual_px"]),
        }
        out["sigmas"][str(sigma)] = row
        print(json.dumps({"sigma": sigma, **row}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
