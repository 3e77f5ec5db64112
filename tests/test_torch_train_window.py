"""The JAX package's TPU training gather loses no voxel to its windows on
the training recipes the port is held to.

``chip_smoke.py`` phases 25 and 26 hold nets the port trains to records
that the JAX package trained on a TPU, whose training gather
(``build_cvc_batch_pallas``) reads each item's pixels from crop and
chunk windows that ``train_surfacenet`` sizes once from the scene's box;
a voxel projecting outside its window comes back invalid.  The port's
gather, like the JAX package's oracle (``ops/cvc.py::build_cvc_batch``),
has no window (ROADMAP's north star).  So the two trainings would see
other CVCs if a window cut off a voxel the oracle keeps.
``scripts/train_gather_window.py`` counts such voxels on a recipe's own
batches, the kernel in Pallas interpret mode on the CPU: none in the
first 250 steps of robustness_aug_r04's recipe at sigma 0 and 0.7, nor
in the first 25 of robustness_ft_r05's at sigma 0 and 1 (ROADMAP C11).
Here the first two steps of each, which every later step resembles:
32^3 cubes of 0.5 mm drawn within a quarter cube of the surface.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "train_gather_window", os.path.join(ROOT, "scripts",
                                        "train_gather_window.py"))
window = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(window)


@pytest.mark.parametrize("recipe,sigma", [("aug", 0.7), ("finetune", 1.0)])
def test_training_windows_lose_no_voxel(recipe, sigma):
    out = window.count(recipe, steps=2, sigmas=(0.0, sigma))
    for got in out["sigmas"].values():
        tot = got["total"]
        assert tot["oracle_valid"] > 0 and tot["surface_valid"] > 0
        assert tot["window_lost"] == 0, got["per_step"]
        assert tot["kernel_only_valid"] == 0, got["per_step"]
