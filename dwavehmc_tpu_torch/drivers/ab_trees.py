"""Time one measurement in two checkouts of this repository on the same
card, in the order A, B, B, A, each run a process of its own started from
its checkout's root.

    python -m dwavehmc_tpu_torch.drivers.ab_trees --base DIR
        [--what ph_anchor,production,headline,sigma_cap]
        [--out runs/ab_trees.json]

A is this checkout, B the one at ``--base`` (for example the parent commit
unpacked with ``git archive``).  Measurements:

- ``ph_anchor``: the guarded PH anchor (``ops/ph_eigh.
  diagonalize_embedding_ph_guarded``) at 8 × 2304 on ``chip_smoke.py``'s
  seeded ``anchor.ph_draws`` batches (seeds 1001…1008): per batch whether
  it fell back, the chains it rescued (0 where the checkout has no
  rescue) and the median device ms of 3 calls after a warm-up;
- ``production``: ``drivers/profile_production`` at the cut
  ``chip_smoke.py`` runs (64 × 24×24, 1 therm sweep, 2-sweep segments):
  the timed plain segment's traj/s;
- ``headline``: ``drivers/bench.bench`` with its ``tracked_fast`` mode
  alone at the defaults (16×16, 8 chains, 10 therm sweeps, a warm-up and
  3 timed segments of 20 sweeps; no ``eigh`` figures, no legs): its
  traj/s;
- ``sigma_cap``: K5 (``ops/kernels.spectral_norm_est``) at the σ-cap's
  seven shapes (``AB_SIGMA_SHAPES``, default ``SIGMA_SHAPES``) on
  ``chip_smoke.py``'s seeded S: the milliseconds of a call in 5 replays
  of a CUDA graph of 20 calls (none on the CPU), the plan, whether σ
  equals the plain version's bits, and a digest of σ's bits.

``production`` and ``headline`` also give a digest (SHA-256) of the dH
bits of every segment the run made, in order, so that an A/B shows
whether anything but time moved: the checkout's ``run_segment_tracked``
is wrapped where the measured module looks it up.  Each run's JSON is
kept whole; the summary gives each measurement per checkout in run
order.  Any run that fails makes the command exit nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the PH anchor on chip_smoke's seeded batches, run inside a checkout
PH_ANCHOR = r"""
import json, numpy as np, torch
import chip_smoke as cs
from dwavehmc_tpu_torch.ops import ph_eigh
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
rows = []
for i in range(cs.PH_DRAW_BATCHES):
    g = torch.Generator(device=dev).manual_seed(1001 + i)
    M = cs._anchor_batch(dev, g)
    ph_eigh.reset_guard()
    fb = ph_eigh.diagonalize_embedding_ph_guarded(M)[3]
    guard = dict(ph_eigh.GUARD)
    ms = cs.event_ms(lambda: ph_eigh.diagonalize_embedding_ph_guarded(M))
    rows.append({"seed": 1001 + i, "fell_back": fb,
                 "rescued": guard.get("rescued", 0), "ms": ms,
                 "ms_median": float(np.median(ms))})
    del M
print(json.dumps({"ph_anchor": rows}))
"""

#: every segment's dH bits, in call order, from a driver module's
#: ``run_segment_tracked``
RECORDER = r"""
import hashlib, json, os, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
DEVICE = os.environ.get("AB_DEVICE", "cuda")

def record(module):
    real, seen = module.run_segment_tracked, []

    def wrapped(*args, **kwargs):
        states, seg = real(*args, **kwargs)
        seen.append(seg.dH.detach().cpu().numpy().tobytes())
        return states, seg

    module.run_segment_tracked = wrapped
    return seen

def digest(seen):
    h = hashlib.sha256()
    for b in seen:
        h.update(b)
    return h.hexdigest()
"""

#: profile_production at chip_smoke's cut; the report goes to argv[1]
PRODUCTION = RECORDER + r"""
os.environ.update(PROF_THERM="1", PROF_SWEEPS="2")
from dwavehmc_tpu_torch.drivers import profile_production as pp
seen = record(pp)
out = pp.profile(pp.knobs(), DEVICE, sys.argv[2])
with open(sys.argv[1], "w") as f:
    json.dump(out, f, indent=1)
print(json.dumps({"traj_per_sec": out["traj_per_sec"],
                  "acceptance": out["acceptance"],
                  "trace_ok": out["trace_error"] is None,
                  "dH_digest": digest(seen), "segments": len(seen)}))
"""

#: the bench's tracked_fast mode alone at its defaults
HEADLINE = RECORDER + r"""
from dwavehmc_tpu_torch.drivers import bench
seen = record(bench)
kn = bench.knobs(dict(os.environ, BENCH_MODES="tracked_fast",
                       BENCH_SKIP_EIGH="1", BENCH_PRODUCTION="0",
                       BENCH_CAPACITY="0"))
line, errors = bench.bench(kn, DEVICE)
if errors:
    raise SystemExit(f"bench failed: {errors}")
mode = line["modes"]["tracked_fast"]
print(json.dumps({"traj_per_sec": mode["traj_per_sec"],
                  "acceptance": mode["acceptance"],
                  "times_s": line["times_s"],
                  "dH_digest": digest(seen), "segments": len(seen)}))
"""


#: K5's shapes: the 16×16/b8 headline, the main path, the scan's 24
#: chains, the 24×24/b64 leg, config 5 at 2 chains, 46×46 and float64 8464
SIGMA_SHAPES = ("8x512:float32,8x1152:float32,24x1152:float32,"
                "64x1152:float32,2x2048:float32,2x4232:float32,"
                "1x8464:float64")

#: K5 at AB_SIGMA_SHAPES, timed by CUDA-graph replay, inside a checkout
SIGMA_CAP = r"""
import hashlib, json, os, statistics, torch
from dwavehmc_tpu_torch.ops import kernels
dev = torch.device(os.environ.get("AB_DEVICE", "cuda"))

def replay_ms(fn, calls=20, reps=5):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / calls)
    return out

gen = torch.Generator(device=dev).manual_seed(5)
rows = []
for item in os.environ["AB_SIGMA_SHAPES"].split(","):
    shape, dtype = item.split(":")
    B, n = (int(x) for x in shape.split("x"))
    dt = getattr(torch, dtype)
    a = torch.randn(B, n, n, generator=gen, device=dev, dtype=dt)
    sr = (a - a.mT) * 0.01
    a = torch.randn(B, n, n, generator=gen, device=dev, dtype=dt)
    si = (a + a.mT) * 0.01
    del a
    got = kernels.spectral_norm_est(sr, si)
    ms = (replay_ms(lambda: kernels.spectral_norm_est(sr, si))
          if dev.type == "cuda" else None)
    plan = (kernels._sigma_cap_plan(B, n, dt)._asdict()
            if dev.type == "cuda" else None)
    rows.append({"shape": [B, n], "dtype": dtype, "ms": ms,
                 "ms_median": ms and statistics.median(ms), "plan": plan,
                 "bit_equal_plain": bool(torch.equal(
                     got, kernels.spectral_norm_est_plain(sr, si))),
                 "sigma_digest": hashlib.sha256(
                     got.cpu().numpy().tobytes()).hexdigest()})
    del sr, si
    if dev.type == "cuda":
        torch.cuda.empty_cache()
print(json.dumps({"sigma_cap": rows}))
"""


def _run(tree: str, what: str, out_dir: str, tag: str,
         device: str = "cuda") -> dict:
    env = dict(os.environ, PYTHONPATH=tree, SKIP_QUICK_TESTS="1",
               AB_DEVICE=device)
    env.setdefault("AB_SIGMA_SHAPES", SIGMA_SHAPES)
    if what == "ph_anchor":
        cmd = [sys.executable, "-c", PH_ANCHOR]
    elif what == "headline":
        cmd = [sys.executable, "-c", HEADLINE]
    elif what == "sigma_cap":
        cmd = [sys.executable, "-c", SIGMA_CAP]
    else:
        # the trace (hundreds of MB at 64 chains) stays under build/
        cmd = [sys.executable, "-c", PRODUCTION,
               os.path.join(out_dir, f"profile_{tag}.json"),
               os.path.join(REPO, "build", "ab_trees", f"trace_{tag}")]
    p = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                       text=True, timeout=1800)
    if p.returncode != 0:
        raise RuntimeError(f"{what} in {tree} exited {p.returncode}:\n"
                           f"{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def ab(base: str, whats: list, out_dir: str, device: str = "cuda") -> dict:
    trees = {"A": REPO, "B": os.path.abspath(base)}
    out = {"trees": trees, "order": "ABBA", "runs": [], "summary": {}}
    for what in whats:
        for i, side in enumerate("ABBA"):
            res = _run(trees[side], what, out_dir, f"{side}{i}", device)
            out["runs"].append({"what": what, "side": side, "result": res})
            if what == "ph_anchor":
                val = [(r["seed"], r["fell_back"], r["rescued"],
                        r["ms_median"]) for r in res["ph_anchor"]]
            elif what == "sigma_cap":
                val = [(r["shape"], r["ms_median"], r["bit_equal_plain"],
                        r["sigma_digest"]) for r in res["sigma_cap"]]
            else:
                val = (res["traj_per_sec"], res["dH_digest"])
            out["summary"].setdefault(what, {}).setdefault(side, []).append(
                val)
            print(f"[ab_trees] {what} {side}: {val}", file=sys.stderr,
                  flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base", required=True)
    p.add_argument("--what",
                   default="ph_anchor,production,headline,sigma_cap")
    p.add_argument("--out", default=os.path.join("runs", "ab_trees.json"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="production, headline and sigma_cap (ph_anchor: "
                   "the card)")
    ns = p.parse_args(argv)
    out_dir = os.path.dirname(os.path.abspath(ns.out))
    os.makedirs(out_dir, exist_ok=True)
    out = ab(ns.base, ns.what.split(","), out_dir, ns.device)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["summary"]))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
