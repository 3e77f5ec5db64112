"""Both packages' calibration prepass on the op-point sphere, read from PNG.

    JAX_PLATFORMS=cpu python3 scripts/refine_op_sphere_parity.py [--out FILE]

Renders the op-point sphere of ``scripts/op_point_qualify.py``
(``make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
focal=200.0)``), writes it as 12 PNGs with the port's ``write_scan`` and
reads it back twice: with the port's ``load_scan`` (its own PNG decoder)
and with the JAX package's (PIL).  Each package then runs its own
``refine_calibration_auto`` on the CPU at the presets' schedule (80 Adam
steps a level and phase, 2048 probes), as ``run_sweep`` calls it; the JAX
package runs a second time from matrices nudged up by one float32 ulp, the
reference's own sensitivity to float order (ROADMAP C4).

Prints one JSON line (and writes it to ``--out``): each package's passes,
largest shift and per-view shifts (px), the largest per-view difference
between the packages, the JAX package's one-ulp spread, the views whose
shifts differ in sign on an axis where both exceed 0.03 px, and seconds.
Runs on the CPU only; imports both packages, as the parity tests do.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import surfacenet_tpu.geometry.refine as J  # noqa: E402
import surfacenet_tpu_torch.geometry.refine as T  # noqa: E402
from surfacenet_tpu.data.dtu import load_scan as j_load_scan  # noqa: E402
from surfacenet_tpu_torch.data.dtu import (  # noqa: E402
    load_scan as t_load_scan, write_scan,
)
from surfacenet_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402

KW = dict(steps_per_level=80, n_probes=2048)  # dtu9_paper's prepass


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    torch.set_num_threads(4)
    sc = make_sphere_scene(n_views=12, hw=(600, 800), radius=30.0,
                           focal=200.0)
    with tempfile.TemporaryDirectory() as tmp:
        write_scan(tmp, sc.images, sc.Ps, sc.bbox_min, sc.bbox_max)
        ts, js = t_load_scan(tmp), j_load_scan(tmp)
    if not (np.array_equal(ts.images, js.images)
            and np.array_equal(ts.Ps, js.Ps)):
        raise SystemExit("the two loaders read different scans")
    box = (js.bbox_min, js.bbox_max)
    out = {"scene": "make_sphere_scene(n_views=12, hw=(600, 800), "
                    "radius=30.0, focal=200.0), PNG round trip",
           **KW}
    t0 = time.perf_counter()
    _, i_j = J.refine_calibration_auto(js.images, js.Ps, *box, **KW)
    out["jax_s"] = time.perf_counter() - t0
    nudged = np.nextafter(np.asarray(js.Ps, np.float32), np.float32(np.inf))
    _, i_n = J.refine_calibration_auto(js.images, nudged.astype(js.Ps.dtype),
                                       *box, **KW)
    t0 = time.perf_counter()
    _, i_t = T.refine_calibration_auto(ts.images, ts.Ps, *box, device="cpu",
                                       **KW)
    out["port_s"] = time.perf_counter() - t0
    dj, dn, dt = (np.asarray(i["duv_px"], np.float64)
                  for i in (i_j, i_n, i_t))
    both = (np.abs(dj) > 0.03) & (np.abs(dt) > 0.03)
    out.update({
        "jax": {"passes": i_j["passes"],
                "max_shift_px": float(i_j["max_shift_px"]),
                "duv_px": dj.round(4).tolist()},
        "port": {"passes": i_t["passes"],
                 "max_shift_px": float(i_t["max_shift_px"]),
                 "duv_px": dt.round(4).tolist()},
        "max_view_diff_px": float(np.abs(dt - dj).max()),
        "jax_one_ulp_spread_px": float(np.abs(dn - dj).max()),
        "sign_differs_views": np.flatnonzero(
            (both & (np.sign(dj) != np.sign(dt))).any(axis=1)).tolist(),
    })
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
