"""Time K5 (``csrc/sigma_cap.cu``) built with other constants against
this checkout's own build, on one card, in one process.

    python -m dwavehmc_tpu_torch.drivers.sigma_cap_variants
        [--variants float:32:8,8:4 double:16:4,4:1 ...]
        [--shapes 8x512:float32,...] [--out runs/sigma_cap_variants.json]

A variant is ``type:warps:sparse,dense:slots``, the ``Cfg<type>``
constants of the source: a CTA's warps, the leaves a lane loads at once
for each row flavor, and the sparse flavor's partner slots (the
checkout's are in ``csrc/sigma_cap.cu``).  Each variant's source goes to
``build/sigma_cap_variants/<name>/``, is compiled with the other kernels'
sources and ``ops/kernels.NVCC_FLAGS`` into a library of its own, and is
loaded in place of the checkout's build for its turn.  At every shape
(``ab_trees.SIGMA_SHAPES`` by default, on ``chip_smoke.py``'s seeded S)
the checkout's build runs first and last, the variants between: the
milliseconds of a call in 5 replays of a CUDA graph of 20 calls, whether
σ equals the plain version's bits, and the plan's registers, spilled bytes
and warps an SM.  Exits nonzero if a variant differs from the plain
version.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import torch

from ..ops import kernels
from .ab_trees import SIGMA_SHAPES

VARIANTS = ("float:32:8,8:4", "float:16:32,32:4", "float:16:16,16:16",
            "double:16:4,4:1")
BUILD = os.path.join(os.path.dirname(kernels.BUILD_DIR), "sigma_cap_variants")


def variant_source(source: str, variant: str) -> str:
    """``source`` with the ``Cfg<type>`` constants of ``variant``
    (``type:warps:sparse,dense:slots``)."""
    parts = variant.split(":")
    if len(parts) != 4 or parts[0] not in ("float", "double") \
            or len(parts[2].split(",")) != 2:
        raise ValueError("a variant is type:warps:sparse,dense:slots, "
                         f"got {variant}")
    t, warps, g, slots = parts
    cfg = re.compile(r"(struct Cfg<" + t + r"> \{\n  static constexpr int "
                     r"kWarps = )\d+, kSlots = \d+;\n  static constexpr int "
                     r"kGOf\[2\] = \{\d+, \d+\};")
    found = cfg.search(source)
    if found is None:
        raise ValueError(f"Cfg<{t}> not found in sigma_cap.cu")
    g = ", ".join(str(int(x)) for x in g.split(","))
    new = (f"{found.group(1)}{int(warps)}, kSlots = {int(slots)};\n  static "
           f"constexpr int kGOf[2] = {{{g}}};")
    return source[:found.start()] + new + source[found.end():]


def build_variant(variant: str):
    """Compile every kernel source, ``sigma_cap.cu`` as ``variant``, into
    one library under ``BUILD`` and load it."""
    name = re.sub(r"[:,]", "_", variant)
    out = os.path.join(BUILD, name)
    os.makedirs(out, exist_ok=True)
    src = (kernels.CSRC_DIR / "sigma_cap.cu").read_text()
    with open(os.path.join(out, "sigma_cap.cu"), "w") as f:
        f.write(variant_source(src, variant))
    procs = []
    for s in kernels.SOURCES:
        path = (os.path.join(out, s) if s == "sigma_cap.cu"
                else str(kernels.CSRC_DIR / s))
        obj = os.path.join(out, s + ".o")
        # sigma_cap_f64.cu includes sigma_cap.cu from its own directory
        if s == "sigma_cap_f64.cu":
            path = os.path.join(out, s)
            with open(path, "w") as f:
                f.write((kernels.CSRC_DIR / s).read_text())
        procs.append((obj, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.CSRC_DIR), "-c", path, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errs = [(p, p.communicate()[1]) for _o, p in procs]
    for p, err in errs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {variant}:\n{err}")
    lib = os.path.join(out, f"lib{name}.so")
    subprocess.run([kernels._nvcc(), "-shared", "-o", lib,
                    *(o for o, _p in procs)], check=True)
    return kernels._load(lib)


def replay_ms(fn, calls: int = 20, reps: int = 5) -> list:
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


def compare(variants: list, shapes: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("sigma_cap_variants: needs a CUDA device")
    kernels.build()
    libs = {"checkout": kernels._lib}
    libs.update((v, build_variant(v)) for v in variants)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for item in shapes.split(","):
        shape, dtype = item.split(":")
        B, n = (int(x) for x in shape.split("x"))
        dt = getattr(torch, dtype)
        a = torch.randn(B, n, n, generator=gen, device=dev, dtype=dt)
        sr = (a - a.mT) * 0.01
        a = torch.randn(B, n, n, generator=gen, device=dev, dtype=dt)
        si = (a + a.mT) * 0.01
        del a
        want = kernels.spectral_norm_est_plain(sr, si)
        row = {"shape": [B, n], "dtype": dtype, "runs": []}
        for name in ["checkout", *variants, "checkout"]:
            kernels._lib = libs[name]
            kernels._sigma_cap_plan.cache_clear()
            plan = kernels._sigma_cap_plan(B, n, dt)
            ms = replay_ms(lambda: kernels.spectral_norm_est(sr, si))
            info = kernels.sigma_cap_info(n, dt, plan)
            row["runs"].append({
                "build": name, "ms": ms, "ms_median": statistics.median(ms),
                "bit_equal_plain": bool(torch.equal(
                    kernels.spectral_norm_est(sr, si), want)),
                **{k: info[k] for k in ("mode", "rows", "registers",
                                        "spill_bytes", "warps_per_sm")}})
        kernels._lib = libs["checkout"]
        kernels._sigma_cap_plan.cache_clear()
        rows.append(row)
        print(json.dumps({"shape": row["shape"], "ms": [
            (r["build"], round(r["ms_median"], 5), r["bit_equal_plain"])
            for r in row["runs"]]}), file=sys.stderr, flush=True)
        del sr, si
        torch.cuda.empty_cache()
    return {"gpu": torch.cuda.get_device_name(0), "variants": variants,
            "rows": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS))
    p.add_argument("--shapes", default=SIGMA_SHAPES)
    p.add_argument("--out", default=os.path.join("runs",
                                                 "sigma_cap_variants.json"))
    ns = p.parse_args(argv)
    variants = ns.variants
    for v in variants:
        variant_source((kernels.CSRC_DIR / "sigma_cap.cu").read_text(), v)
    out = compare(variants, ns.shapes)
    os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    if not all(r["bit_equal_plain"] for row in out["rows"]
               for r in row["runs"]):
        raise SystemExit("sigma_cap_variants: a build differs from the "
                         "plain version")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
