"""Run configuration: one dataclass + CLI parser (port of
``dwavehmc_tpu/utils/config.py``).

``RunConfig`` has the JAX package's field names, order and defaults, so a
``scan_config.json`` written by either package names the same settings.
What differs in the port:

* ``torch_dtype()``/``rot_torch_dtype()`` replace ``jax_dtype()``/
  ``rot_jax_dtype()``, and ``params(device=)`` places the couplings on a
  device;
* ``resolved_path()`` returns ``"real"`` for ``path="auto"``: the JAX
  package resolves "auto" to the real-pair path on its production
  accelerator and to the complex path elsewhere, and the port's production
  accelerator is the GPU.  ``path="complex"`` selects the complex path;
* ``use_pallas_s`` is accepted and ignored: a CUDA tensor always goes to the
  hand-written kernel, a CPU tensor to its plain version.

``validate()`` applies the JAX package's rules, among them that
``metropolis_readout="host"`` needs ``eigh_mode="tracked"`` on the real
path.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..models.lattice import LatticeSpec
from ..models.params import ModelParams, SpectralSpec, make_params


@dataclasses.dataclass
class RunConfig:
    # lattice
    Lx: int = 24
    Ly: int = 24
    # physics
    t: float = 1.0
    tp: float = -0.35
    mu: float = -1.08
    W: float = 1.0
    n_imp: float = 0.05
    beta: float = 10.0
    J: float = 0.8
    mass: float = 1.0
    # spectral grid (η = 8/N convention)
    eta: float | None = None        # None → 8 / (Lx·Ly)
    domega: float | None = None     # None → 0.2·η
    omega_max: float = 4.0
    # HMC schedule
    n_therm: int = 100
    n_measure: int = 500
    Nt_therm_init: int = 10
    Nt_measure: int = 5
    measure_transport_freq: int = 1
    bin_size: int = 5
    # ensemble / numerics
    n_chains: int = 1
    seed: int = 0
    dtype: str = "float32"          # "float32" | "float64"
    path: str = "auto"              # "auto" → "real" | "real" | "complex"
    eigh_mode: str = "exact"        # "exact" | "tracked"
    tracked_iters: int = 6          # refinement rotations per leapfrog step
    anchor_every: int = 1           # exact anchor every K sweeps
    refine_iters: int = 6           # fast endpoint refinement (cheap anchors)
    polish_iters: int = 3           # full-precision endpoint polish rotations
    polish_precision: str = "highest"  # precision of the polish rotations
    #                                 ("high": three TF32 passes on the
    #                                 card; the readout stays "highest")
    polish_correction: bool = False  # second-order Rayleigh correction on
    #                                 the cheap-anchor eigenvalue readout
    exact_solver: str = "ph"        # anchor/init eigensolver: "ph" (PH-split
    #                                 half-dimension solver behind the floor
    #                                 guard, ops/ph_eigh.py) | "qdwh"
    #                                 (torch.linalg.eigh of the embedding)
    rot_dtype: str = "float32"      # "float32" | "bfloat16": storage dtype of
    #                                 the in-trajectory tracked rotations
    rot_scheme: str = "exp2"        # "exp2" | "ns" tracked rotation scheme
    use_pallas_s: bool | None = None  # accepted, ignored (routing by device)
    metropolis_readout: str = "device"  # "device" | "host" (float64 ΔH on
    #                                 the host; tracked real path only)
    Nt_escalate: bool = True        # vectorized scan: per-point Nt buckets
    #                                 after the probe window
    anneal_stages: int = 0          # vectorized scan: β-ladder warm start
    #                                 stages (0 = off)
    anneal_sweeps: int = 5          # sweeps per annealing stage
    anneal_start_beta: float = 100.0  # ramp origin; chains with β ≤ this
    #                                 run their target β throughout
    meas_probe_sweeps: int = 10     # vectorized scan: shrink-only dt probe
    #                                 at the measurement Nt (0 = off)
    # io
    out_dir: str = "runs/run"
    verbose: bool = True
    checkpoint_freq: int = 50
    resume: bool = False
    profile_dir: str | None = None   # torch.profiler trace of
    #                                 run_simulation's measurement phase

    def lattice(self) -> LatticeSpec:
        return LatticeSpec(self.Lx, self.Ly)

    def spectral(self) -> SpectralSpec:
        eta = self.eta if self.eta is not None else 8.0 / (self.Lx * self.Ly)
        domega = self.domega if self.domega is not None else 0.2 * eta
        return SpectralSpec(eta=eta, domega=domega, omega_max=self.omega_max)

    def params(self, device="cuda") -> ModelParams:
        return make_params(t=self.t, tp=self.tp, mu=self.mu, W=self.W,
                           n_imp=self.n_imp, beta=self.beta, J=self.J,
                           mass=self.mass, dtype=self.torch_dtype(),
                           device=device)

    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    def rot_torch_dtype(self):
        """None (= carry dtype) unless bf16 rotations are requested."""
        return torch.bfloat16 if self.rot_dtype == "bfloat16" else None

    def resolved_ns_steps(self) -> int:
        """Newton–Schulz steps per in-trajectory rotation: one under the
        exp2 scheme (Gram error S⁴/4 to start from), two under ns."""
        return 1 if self.rot_scheme == "exp2" else 2

    def resolved_path(self) -> str:
        """"real" for "auto" and "real", "complex" for "complex"."""
        if self.path in ("auto", "real"):
            return "real"
        if self.path == "complex":
            return "complex"
        raise ValueError(f"path={self.path!r}: expected 'auto', 'real' or "
                         "'complex'")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def validate(self) -> None:
        """Reject unsupported combinations at driver entry.

        ``metropolis_readout='host'`` is wired through the tracked real-path
        segment runner only (``parallel/ensemble.run_segment_hostacc``);
        anywhere else it would silently fall back to the float32 device ΔH,
        in the regime where exactness was asked for."""
        if self.metropolis_readout not in ("device", "host"):
            raise ValueError(
                f"metropolis_readout={self.metropolis_readout!r}: expected "
                "'device' or 'host'")
        if self.rot_scheme not in ("ns", "exp2"):
            raise ValueError(f"rot_scheme={self.rot_scheme!r}: expected "
                             "'ns' or 'exp2'")
        if self.exact_solver not in ("qdwh", "ph"):
            raise ValueError(f"exact_solver={self.exact_solver!r}: expected "
                             "'qdwh' or 'ph'")
        path = self.resolved_path()
        if self.metropolis_readout == "host" and (
                self.eigh_mode != "tracked" or path != "real"):
            raise ValueError(
                "metropolis_readout='host' requires eigh_mode='tracked' "
                "and the real compute path (got eigh_mode="
                f"{self.eigh_mode!r}, path={path!r}); the exact host "
                "float64 readout is wired through the tracked real-path "
                "runner only — see parallel/ensemble.run_segment_hostacc")


def add_cli_args(parser: argparse.ArgumentParser,
                 defaults: RunConfig | None = None):
    d = defaults or RunConfig()
    for f in dataclasses.fields(RunConfig):
        val = getattr(d, f.name)
        if f.type == "bool | None":      # tri-state: auto/None, true, false
            parser.add_argument(
                f"--{f.name}",
                type=lambda s: (None if s.lower() in ("none", "auto")
                                else s.lower() in ("1", "true", "yes")),
                default=val)
        elif f.type == "bool" or isinstance(val, bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=val)
        elif val is None:
            parser.add_argument(f"--{f.name}", type=float, default=None)
        else:
            parser.add_argument(f"--{f.name}", type=type(val), default=val)
    return parser


def from_namespace(ns: argparse.Namespace) -> RunConfig:
    names = {f.name for f in dataclasses.fields(RunConfig)}
    return RunConfig(**{k: v for k, v in vars(ns).items() if k in names})
