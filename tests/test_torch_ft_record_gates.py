"""``chip_smoke.py`` phase 26's gates, held to their own record.

Phase 26 fine-tunes the shipped paper-width sphere net on the card as
``results/robustness_ft_r05.json`` did and holds each arm's sweeps with
``ft_misses``: the control arm's rows within 5% of the record (sigma 2's
points 10%) and its clean overall within 2% of the start net's sweep
(the record's "harmless"); each sigma 1 arm's rows within 25% of the
record, or within the port's own runs widened by 10% where
``FT_SEED_SPREAD`` names the reading, and the record's verdict: the clean
overall at least 3x the start net's, every row's overall at least 1.5x
the start net's at its sigma, the clean accuracy at least 3x.  The
record must pass its own gates, and a copy with one reading moved past
one gate must fail exactly that gate.  Nothing here needs a card.
"""

import copy
import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SIGMA1 = ("arm_sigma1_lr3e-4_3k", "arm_sigma1_lr1e-4_6k")


@pytest.fixture(scope="module")
def record():
    return smoke.ft_record()


def test_record_passes_its_own_gates(record):
    ft, orig = record
    assert sorted(ft) == sorted(smoke.FT_ARMS)
    assert set(smoke.FT_FULL_ARMS) <= set(ft)
    assert all(sorted(r) == list(smoke.AUG_SIGMAS) for r in ft.values())
    assert sorted(orig) == list(smoke.AUG_SIGMAS)
    claims, misses = smoke.ft_misses(ft, orig, ft)
    assert misses == []
    c = claims[smoke.FT_CONTROL]["overall_over_orig"]
    assert c["0.0"] == pytest.approx(0.6052 / 0.605)
    a3, a6 = (claims[a] for a in SIGMA1)
    assert a3["overall_over_orig"]["0.0"] == pytest.approx(4.1586 / 0.605)
    assert a6["overall_over_orig"]["0.0"] == pytest.approx(2.6572 / 0.605)
    assert a3["clean_acc_over_orig"] == pytest.approx(7.6827 / 0.6813)
    assert a6["clean_acc_over_orig"] == pytest.approx(4.6782 / 0.6813)
    least = min(r for a in (a3, a6) for r in a["overall_over_orig"].values())
    assert least == pytest.approx(10.2788 / 5.4646)


def test_start_rows_are_robustness_r04s(record):
    """The record's start net ("orig") is robustness_r04's net on the same
    scenes: phase 24 sweeps those rows, and phase 26 reads them there."""
    with open(os.path.join(ROOT, "results", "robustness_r04.json")) as f:
        r04 = {r["label"]: r for r in json.load(f)["rows"]}
    for sigma, row in record[1].items():
        label = "clean" if sigma == 0.0 else f"calib_sigma_px={sigma}"
        for key in ("acc_mm", "comp_mm", "overall_mm", "n_pts"):
            assert row[key] == r04[label][key], (sigma, key)


# each copy moves one reading of the record past one gate, held to itself
# (so no band moves with it): (arm, sigma, key, factor of the start
# net's reading or of the record's), the words of that gate's miss
CLAIM_BREAKS = {
    # the control's clean overall 2.5% above the start net's
    "harmless": ((smoke.FT_CONTROL, 0.0, "overall_mm", 1.025, "orig"),
                 "start net's (within 2%)"),
    "clean_3x": (("arm_sigma1_lr3e-4_3k", 0.0, "overall_mm", 2.9, "orig"),
                 "clean overall is"),
    "row_1.5x": (("arm_sigma1_lr1e-4_6k", 2.0, "overall_mm", 1.45, "orig"),
                 "sigma 2.0: the overall is"),
    "acc_3x": (("arm_sigma1_lr1e-4_6k", 0.0, "acc_mm", 2.9, "orig"),
               "clean accuracy is"),
}


@pytest.mark.parametrize("name", sorted(CLAIM_BREAKS))
def test_a_broken_claim_fails(record, name):
    (arm, sigma, key, factor, _), words = CLAIM_BREAKS[name]
    ft, orig = record
    rows = copy.deepcopy(ft)
    rows[arm][sigma][key] = factor * orig[sigma][key]
    _, misses = smoke.ft_misses(rows, orig, rows, spread={})
    assert len(misses) == 1 and words in misses[0], misses
    assert misses[0].startswith(arm), misses


@pytest.mark.parametrize("sigma", smoke.AUG_SIGMAS)
@pytest.mark.parametrize("key", ["overall_mm", "n_pts"])
@pytest.mark.parametrize("factor", [1.06, 0.94, 1.04, 0.96, 1.11, 0.89])
def test_a_control_row_moved_past_its_band_fails(record, sigma, key, factor):
    """One control row moved against the record: beyond 5% it misses its
    band (sigma 2's points: beyond 10%); the clean overall moved also
    leaves the start net's 2%."""
    ft, orig = record
    arm = smoke.FT_CONTROL
    rows = copy.deepcopy(ft)
    rows[arm][sigma][key] *= factor
    _, misses = smoke.ft_misses(rows, orig, ft, spread={})
    band = (smoke.FT_CONTROL_SIGMA2_PTS if (sigma, key) == (2.0, "n_pts")
            else smoke.FT_CONTROL_BAND)
    row = [m for m in misses if m.startswith(f"{arm} sigma {sigma}: {key}")]
    assert len(row) == (abs(factor - 1.0) > band), misses
    harmless = sigma == 0.0 and key == "overall_mm"
    assert len(misses) == len(row) + harmless, misses


@pytest.mark.parametrize("arm", SIGMA1)
@pytest.mark.parametrize("key", ["overall_mm", "n_pts"])
@pytest.mark.parametrize("factor", [1.26, 0.74, 1.24, 0.76])
def test_a_sigma1_row_moved_past_its_band_fails(record, arm, key, factor):
    """The sigma 0.5 row of a sigma 1 arm moved by the factor: 26% fails
    its band, 24% passes it; no claim moves (its overall stays >= 1.5x
    the start net's)."""
    ft, orig = record
    rows = copy.deepcopy(ft)
    rows[arm][0.5][key] *= factor
    _, misses = smoke.ft_misses(rows, orig, ft, spread={})
    if abs(factor - 1.0) > smoke.AUG_BAND:
        assert len(misses) == 1 and misses[0].startswith(
            f"{arm} sigma 0.5: {key}"), misses
    else:
        assert misses == []


@pytest.mark.parametrize("factor", [3.0, 0.5])
def test_a_named_reading_is_held_to_its_runs(record, factor):
    """A reading a seed spread names is held, with the record, to its
    runs' range widened by 10%, not to the band; a spread whose runs miss
    the record, or that names a row the record has not, fails."""
    ft, orig = record
    arm = "arm_sigma1_lr3e-4_3k"
    runs = (3.0, 4.0, 9.0)
    spread = {(arm, 0.0): {"overall_mm": runs}}
    rows = copy.deepcopy(ft)
    rows[arm][0.0]["overall_mm"] *= factor
    _, misses = smoke.ft_misses(rows, orig, ft, spread=spread)
    got = rows[arm][0.0]["overall_mm"]
    outside = not 0.9 * min(runs) <= got <= 1.1 * max(runs)
    row = [m for m in misses if m.startswith(f"{arm} sigma 0.0: ")]
    assert len(row) == outside, misses
    assert not outside or "outside the port's runs widened" in row[0]
    rows = copy.deepcopy(ft)
    rows[arm][0.0]["overall_mm"] = 5.5
    _, misses = smoke.ft_misses(rows, orig, ft, spread={
        (arm, 0.0): {"overall_mm": (5.0, 6.0)}})
    assert len(misses) == 1 and "not training noise" in misses[0], misses
    _, misses = smoke.ft_misses(ft, orig, ft, spread={
        (arm, 3.0): {"n_pts": (1, 2)}})
    assert len(misses) == 1 and "no row of the record" in misses[0], misses


def test_seed_spread_names_only_noise_readings(record):
    """Every reading ``FT_SEED_SPREAD`` names is a sigma 1 arm's row of the
    record, left the band in one of its runs at least, and has the record
    within its runs' range widened by 10%."""
    ft, orig = record
    for (arm, sigma), keys in smoke.FT_SEED_SPREAD.items():
        assert arm in SIGMA1 and sigma in ft[arm], (arm, sigma)
        for key, runs in keys.items():
            assert key in ("overall_mm", "n_pts") and len(runs) >= 5
            want = ft[arm][sigma][key]
            assert any(not smoke.within(r, want, smoke.AUG_BAND)
                       for r in runs), (arm, sigma, key)
            assert 0.9 * min(runs) <= want <= 1.1 * max(runs), (arm, sigma)
    _, misses = smoke.ft_misses(ft, orig, ft)
    assert misses == []
