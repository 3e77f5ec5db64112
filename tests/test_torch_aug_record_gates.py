"""``chip_smoke.py`` phase 25's gates, held to their own record.

Phase 25 trains both arms of ``results/robustness_aug_r04.json`` on the
card and holds each net's sweeps with ``aug_misses``: every row's overall
mean and points within 25% of the record, but the readings that
``AUG_SEED_SPREAD`` names (they left the band in one of the port's own
trainings), which must lie, as the record must, within those trainings'
range widened by 10%; and the record's five claims.  The record must
pass its own gates, and a copy with one claim's ratio or order moved
past its bound, one row moved by 26%, or one named reading moved out of
its runs' widened range must fail exactly that gate.  Nothing here needs
a card.
"""

import copy
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def record():
    rows, losses = smoke.aug_record()
    return rows, losses


def test_record_passes_its_own_gates(record):
    rows, losses = record
    assert sorted(rows) == sorted(smoke.AUG_ARMS)
    assert all(sorted(r) == list(smoke.AUG_SIGMAS) for r in rows.values())
    assert losses == {"clean_trained": 0.4027, "aug_trained": 0.538}
    claims, misses = smoke.aug_misses(rows, rows)
    assert misses == []
    assert claims["aug_over_clean_sigma0"] == pytest.approx(2.1441 / 0.9389)
    assert claims["clean_sigma2_over_sigma0"] == pytest.approx(3.162 / 0.9389)
    assert claims["aug_degradation_over_clean"] == pytest.approx(
        (2.9207 / 2.1441) / (3.162 / 0.9389))
    assert claims["clean_points_by_sigma"] == [11637, 9936, 6263, 2025]
    assert claims["sigma2_points_aug_clean"] == [6638, 2025]


# each copy scales readings ((arm, sigmas, key, factor), ...) so that one
# claim's ratio or order passes its bound and no other claim moves; the
# words of that claim's miss
CLAIM_BREAKS = {
    # the augmented arm's overall means, 0.6x: 1.37x the clean arm's at
    # sigma 0 (its degradation ratio unchanged)
    "aug_over_clean": ((("aug_trained", (0.0, 0.5, 1.0, 2.0), "overall_mm",
                         0.6),), "clean overall"),
    # both arms' sigma 2 overall to 1.9x the clean arm's sigma 0 (the
    # ratio of the two arms' degradations unchanged)
    "clean_degradation": (tuple((arm, (2.0,), "overall_mm",
                                 1.9 * 0.9389 / 3.162)
                                for arm in ("clean_trained", "aug_trained")),
                          "sigma 2 overall"),
    # the augmented arm's sigma 2 overall: 0.65x the clean arm's ratio
    "aug_degradation": ((("aug_trained", (2.0,), "overall_mm",
                          0.65 * (3.162 / 0.9389) * 2.1441 / 2.9207),),
                        "degrades"),
    # the clean arm's sigma 1 points above its sigma 0.5
    "clean_points_fall": ((("clean_trained", (1.0,), "n_pts",
                            10000 / 6263),), "do not fall"),
    # the augmented arm's sigma 2 points below the clean arm's
    "sigma2_points": ((("aug_trained", (2.0,), "n_pts", 2000 / 6638),),
                      "keeps"),
}


@pytest.mark.parametrize("name", sorted(CLAIM_BREAKS))
def test_a_broken_claim_fails(record, name):
    """The moved copy held to itself: every row is within its band, so
    the one miss is the claim's."""
    moves, words = CLAIM_BREAKS[name]
    rows = copy.deepcopy(record[0])
    for arm, sigmas, key, factor in moves:
        for sigma in sigmas:
            rows[arm][sigma][key] *= factor
    _, misses = smoke.aug_misses(rows, rows, spread={})
    assert len(misses) == 1 and words in misses[0], misses


@pytest.mark.parametrize("arm", sorted(smoke.AUG_ARMS))
@pytest.mark.parametrize("key", ["overall_mm", "n_pts"])
@pytest.mark.parametrize("factor", [1.26, 0.74, 1.24, 0.76])
def test_a_row_moved_past_its_band_fails(record, arm, key, factor):
    """The sigma 0.5 row moved by the factor: 26% fails its band, 24%
    passes it (the clean arm's points moved up also break the claim that
    they fall with sigma)."""
    rows = copy.deepcopy(record[0])
    rows[arm][0.5][key] *= factor
    _, misses = smoke.aug_misses(rows, record[0], spread={})
    band = [m for m in misses if m.startswith(f"{arm} sigma 0.5: ")]
    if abs(factor - 1.0) > smoke.AUG_BAND:
        assert len(band) == 1 and band[0].startswith(
            f"{arm} sigma 0.5: {key}"), misses
    else:
        assert band == []
    breaks_order = arm == "clean_trained" and key == "n_pts" and factor > 1
    assert len(misses) == len(band) + breaks_order, misses


def test_seed_spread_names_only_noise_readings(record):
    """Every reading ``AUG_SEED_SPREAD`` names is a row of the record, left
    the band in one of its runs at least, and has the record within its
    runs' range widened by 10%."""
    rows = record[0]
    assert smoke.AUG_SEED_SPREAD
    for (arm, sigma), keys in smoke.AUG_SEED_SPREAD.items():
        for key, runs in keys.items():
            assert key in ("overall_mm", "n_pts")
            want = rows[arm][sigma][key]
            assert any(not smoke.within(r, want, smoke.AUG_BAND)
                       for r in runs), (arm, sigma, key)
            assert 0.9 * min(runs) <= want <= 1.1 * max(runs), (arm, sigma)
    _, misses = smoke.aug_misses(rows, rows)
    assert misses == []


@pytest.mark.parametrize("arm,sigma,key", [
    (arm, sigma, key) for (arm, sigma), keys in smoke.AUG_SEED_SPREAD.items()
    for key in keys])
@pytest.mark.parametrize("factor", [3.0, 0.3])
def test_a_named_reading_is_not_held_to_the_band(record, arm, sigma, key,
                                                 factor):
    """A reading the table names, moved by the factor, is held to its
    runs' range widened by 10%, not to the band: it misses exactly when
    it leaves that range; an unnamed one of the same row misses the
    band."""
    runs = smoke.AUG_SEED_SPREAD[arm, sigma][key]
    rows = copy.deepcopy(record[0])
    rows[arm][sigma][key] *= factor
    _, misses = smoke.aug_misses(rows, record[0])
    row = [m for m in misses if m.startswith(f"{arm} sigma {sigma}: ")]
    outside = not 0.9 * min(runs) <= rows[arm][sigma][key] <= 1.1 * max(runs)
    assert len(row) == outside, misses
    assert not outside or "outside the port's runs widened" in row[0]
    other = "n_pts" if key == "overall_mm" else "overall_mm"
    if other not in smoke.AUG_SEED_SPREAD[arm, sigma]:
        rows = copy.deepcopy(record[0])
        rows[arm][sigma][other] *= factor
        _, misses = smoke.aug_misses(rows, record[0])
        assert any(m.startswith(f"{arm} sigma {sigma}: {other}")
                   for m in misses), misses


def test_a_table_naming_a_reading_outside_its_seeds_fails(record):
    """A reading whose runs, widened by 10%, miss the record is not
    training noise: the table may not name it (nor a row the record has
    not)."""
    rows = record[0]
    spread = dict(smoke.AUG_SEED_SPREAD)
    spread["clean_trained", 0.0] = {"overall_mm": (0.5, 0.6, 0.7)}
    rows_got = copy.deepcopy(rows)
    rows_got["clean_trained"][0.0]["overall_mm"] = 0.6
    _, misses = smoke.aug_misses(rows_got, rows, spread=spread)
    assert len(misses) == 1 and "not training noise" in misses[0], misses
    spread = {("clean_trained", 3.0): {"n_pts": (1, 2, 3)}}
    _, misses = smoke.aug_misses(rows, rows, spread=spread)
    assert len(misses) == 1 and "no row of the record" in misses[0], misses
