"""``drivers/ab_trees.py`` on the CPU: the ``headline`` and ``production``
measurements run as processes of their own from a checkout's root, at
4×4 and 2 chains (the ``BENCH_*`` and ``PROF_*`` knobs), each giving its
traj/s and the digest of its segments' dH bits; ``sigma_cap`` at small
shapes (``AB_SIGMA_SHAPES``) gives σ's digest and no time on the CPU.  The
same checkout as A and B gives the same digest in every run of the A B B A
order."""

import os

import pytest

from dwavehmc_tpu_torch.drivers import ab_trees

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = dict(OMP_NUM_THREADS="1", BENCH_L="4", BENCH_BATCH="2",
           BENCH_THERM="1", BENCH_SWEEPS="2", BENCH_REPS="1", PROF_L="4",
           PROF_BATCH="2")


@pytest.fixture
def cut(monkeypatch):
    for k, v in CUT.items():
        monkeypatch.setenv(k, v)


def test_headline_digests_agree_in_every_run(cut, tmp_path):
    out = ab_trees.ab(REPO, ["headline"], str(tmp_path), "cpu")
    runs = [r["result"] for r in out["runs"]]
    assert [r["side"] for r in out["runs"]] == list("ABBA")
    assert len({r["dH_digest"] for r in runs}) == 1
    # the therm, the warm-up and one timed segment
    assert all(r["segments"] == 3 and r["traj_per_sec"] > 0 for r in runs)
    assert set(out["summary"]["headline"]) == {"A", "B"}


def test_production_reports_its_digest(cut, tmp_path):
    res = ab_trees._run(REPO, "production", str(tmp_path), "A0", "cpu")
    assert res["traj_per_sec"] > 0 and len(res["dH_digest"]) == 64
    # the therm, the warm, the plain and the traced segment
    assert res["segments"] == 4
    assert (tmp_path / "profile_A0.json").exists()


def test_sigma_cap_reports_its_shapes_and_digests(monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("AB_SIGMA_SHAPES", "2x40:float32,1x70:float64")
    out = ab_trees.main(["--base", REPO, "--what", "sigma_cap", "--out",
                         str(tmp_path / "ab.json"), "--device", "cpu"])
    assert (tmp_path / "ab.json").exists()
    runs = [r["result"]["sigma_cap"] for r in out["runs"]]
    assert [r["side"] for r in out["runs"]] == list("ABBA")
    for rows in runs:
        assert [(r["shape"], r["dtype"]) for r in rows] == [
            ([2, 40], "float32"), ([1, 70], "float64")]
        assert all(set(r) == {"shape", "dtype", "ms", "ms_median", "plan",
                              "bit_equal_plain", "sigma_digest"}
                   for r in rows)
        # no device time and no launch plan on the CPU
        assert all(r["ms"] is None and r["plan"] is None
                   and r["bit_equal_plain"] for r in rows)
    assert len({tuple(r["sigma_digest"] for r in rows) for rows in runs}) == 1
    shapes = [v[0] for v in out["summary"]["sigma_cap"]["A"][0]]
    assert shapes == [[2, 40], [1, 70]]
    assert ab_trees.SIGMA_SHAPES.count(",") == 6
