"""Run-directory IO: timestamped tee logger, flushed CSV writers, and the
spectra-bin store (port of ``dwavehmc_tpu/utils/io.py``, numpy only).

Every file written here is byte-identical to what the JAX package's module
writes for the same inputs, so either package's post-processing reads
either package's run directories.  Per run directory: ``*.log`` (append,
timestamped, tee'd to stdout), ``observables.csv`` (one row per sweep,
flushed), ``transport.csv``, and ``spectra_bins.npz`` (keys
``sweep_<i>_{opt_cond,dos,dos_AN,A_k0,count}`` and ``meta_*``).
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np

#: exact reference CSV headers (src/Simulation.jl:71-73)
OBS_HEADER = ("Sweep,Accepted,dH,Energy,Delta_Amp,Delta_Loc,Delta_Glob,"
              "S_Delta,Hole_p,Delta_Diff,Delta_Pair,Delta_LocalPair")
TRANS_HEADER = "Sweep,Superfluid_Stiffness,DC_Conductivity"


class TeeLogger:
    """Timestamped log lines to ``simulation.log`` (append) + stdout
    (src/Simulation.jl:59-67)."""

    def __init__(self, path: str, verbose: bool = True):
        self.f = open(path, "a")
        self.verbose = verbose

    def __call__(self, msg: str):
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{ts}] {msg}"
        self.f.write(line + "\n")
        self.f.flush()
        if self.verbose:
            print(line, flush=True)

    def close(self):
        self.f.close()


class CsvWriter:
    """Per-row-flushed CSV (src/Simulation.jl:55-56,166).

    Fresh runs truncate like the reference.  A resumed run passes
    ``resume_at`` = the checkpoint's sweep counter: rows already flushed
    up to (and including) that sweep are preserved, rows beyond it (from
    after the last checkpoint) are dropped so the resumed chain doesn't
    duplicate them — the reference never loses flushed data
    (src/Simulation.jl:166,206-215) and neither does this.
    """

    def __init__(self, path: str, header: str, resume_at: int | None = None):
        kept: list[str] = []
        if resume_at is not None and os.path.exists(path):
            with open(path) as f:
                lines = f.read().splitlines()
            if lines and lines[0] == header:
                for line in lines[1:]:
                    try:
                        sweep = int(float(line.split(",", 1)[0]))
                    except (ValueError, IndexError):
                        continue
                    if sweep <= resume_at:
                        kept.append(line)
        self.f = open(path, "w")
        self.f.write(header + "\n")
        for line in kept:
            self.f.write(line + "\n")
        self.f.flush()

    def row(self, *values):
        out = []
        for v in values:
            if isinstance(v, bool):
                out.append(str(int(v)))
            elif isinstance(v, (int, np.integer)):
                out.append(str(int(v)))
            else:
                out.append(f"{float(v):.6g}")
        self.f.write(",".join(out) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


class SpectraBinStore:
    """Binned spectra accumulator persisted to one .npz file.

    Equivalent of the reference's incremental JLD2 groups
    (src/Simulation.jl:181-220): arrays accumulate for ``bin_size`` heavy
    measurements, then the bin average is appended under ``sweep_<i>_*``
    keys and the file is atomically rewritten (npz has no append).
    Metadata (params dict + omega grids) is stored once at creation, like
    the reference's jldsave seed (src/Simulation.jl:89).
    """

    def __init__(self, path: str, bin_size: int, meta: dict | None = None,
                 resume_at: int | None = None):
        self.path = path
        self.bin_size = bin_size
        self.count = 0
        self.accum: dict[str, np.ndarray] = {}
        self.saved: dict[str, np.ndarray] = {}
        if resume_at is not None and os.path.exists(path):
            # a resumed run must keep every bin flushed before the
            # checkpoint (the reference's JLD2 appends survive anything,
            # src/Simulation.jl:206-215); bins from after the checkpoint
            # are dropped so the re-run sweeps don't double-count
            with np.load(path) as z:
                for k in z.files:
                    if k.startswith("sweep_"):
                        idx = int(k[len("sweep_"):].split("_", 1)[0])
                        if idx > resume_at:
                            continue
                    self.saved[k] = z[k]
        if meta:
            for k, v in meta.items():
                self.saved[f"meta_{k}"] = np.asarray(v)
        self._flush()

    # --- partial-bin persistence (checkpoint 'extra' payload) ---

    def state_dict(self) -> dict[str, np.ndarray]:
        """Partial-bin accumulator as flat arrays for checkpointing."""
        out = {"bin_count": np.asarray(self.count)}
        for k, v in self.accum.items():
            out[f"bin_accum_{k}"] = v
        return out

    def load_state(self, extra: dict[str, np.ndarray]):
        """Restore a partial bin saved by ``state_dict``."""
        if "bin_count" not in extra:
            return
        self.count = int(extra["bin_count"])
        self.accum = {k[len("bin_accum_"):]: np.asarray(v).copy()
                      for k, v in extra.items()
                      if k.startswith("bin_accum_")}

    def _flush(self):
        tmp = self.path + ".tmp.npz"   # .npz suffix: savez won't re-append
        np.savez(tmp, **self.saved)
        os.replace(tmp, self.path)

    def add(self, sweep_idx: int, arrays: dict[str, np.ndarray]):
        """Accumulate one heavy measurement; write the bin when full.
        Returns True if a bin was flushed at this sweep."""
        for k, v in arrays.items():
            v = np.asarray(v)
            if self.count == 0:
                self.accum[k] = v.copy()
            else:
                self.accum[k] += v
        self.count += 1
        if self.count >= self.bin_size:
            for k, v in self.accum.items():
                self.saved[f"sweep_{sweep_idx}_{k}"] = v / self.count
            self.saved[f"sweep_{sweep_idx}_count"] = np.asarray(self.count)
            self._flush()
            self.count = 0
            self.accum = {}
            return True
        return False

    # --- read side (post-processing) ---

    @staticmethod
    def load_bins(path: str) -> tuple[dict, dict[int, dict[str, np.ndarray]]]:
        """Returns (meta, {sweep_idx: {field: array}})."""
        with np.load(path) as z:
            meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
            bins: dict[int, dict[str, np.ndarray]] = {}
            for k in z.files:
                if not k.startswith("sweep_"):
                    continue
                rest = k[len("sweep_"):]
                idx_str, field = rest.split("_", 1)
                bins.setdefault(int(idx_str), {})[field] = z[k]
        return meta, bins


def write_json(path: str, obj: dict):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)
