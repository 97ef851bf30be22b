"""``drivers/ab_trees.py`` on the CPU: the ``headline`` and ``production``
measurements run as processes of their own from a checkout's root, at
4×4 and 2 chains (the ``BENCH_*`` and ``PROF_*`` knobs), each giving its
traj/s and the digest of its segments' dH bits.  The same checkout as A
and B gives the same digest in every run of the A B B A order."""

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
