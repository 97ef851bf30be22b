"""K6 (``ops/kernels.bdg_hop``) on the CPU: its table, its plain version
and where the tracked eigensolver takes it.

* the table (``models/bdg_real.hamiltonian_columns``) scattered back
  reproduces ``assemble_parts``' Hr and Hi bit for bit, and H is zero off
  it, from 2×2 (neighbours coincide) to 24×24, at the production
  couplings with random disorder, Δ up to 1e30 and Δ NaN-zeroed;
* the launch plan (``kernels.hop_plan``): every row in one block, and each
  column a row reads in its block's halo at ``lidx``;
* the plain version against the float64 dense product, within float32's
  rounding of its 13 terms;
* ``tracked_eigh_nofallback`` with and without the table at 16×16: with
  float32 rotations each spectrum within 1e-5 of the spectral radius of
  the exact one; with bf16 rotations the same basis to the bit (only the
  float32 readout takes K6); the two spectra within 1e-5 of the radius
  and forces that agree;
* the dispatch rule: K6 for float32 operands at ``None`` and "highest"
  with a table; bf16, float64, "high", "default" and callers without the
  table take the dense product, and only the card counts the dense ones;
* ``hu_stencil_pct``'s reader on hand-made counts.

The kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from dwavehmc_tpu_torch.models.bdg import static_hamiltonian
from dwavehmc_tpu_torch.models.bdg_real import (
    assemble_parts,
    hamiltonian_columns,
)
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import kernels
from dwavehmc_tpu_torch.ops import tracked_eigh as tte
from dwavehmc_tpu_torch.ops.forces_real import hmc_forces_real
from dwavehmc_tpu_torch.sampler import hmc_real
from dwavehmc_tpu_torch.sampler.hmc import _finite_or_zero
from hmc_bench import harness

torch.set_num_threads(2)

PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, J=0.8, mass=1.0)


@dataclasses.dataclass(frozen=True)
class Torus:
    """A periodic lattice without ``LatticeSpec``'s L ≥ 3 rule: on 2×2 the
    ±x (±y) neighbours and all four next-nearest ones coincide."""

    Lx: int
    Ly: int

    @property
    def n_sites(self) -> int:
        return self.Lx * self.Ly

    @property
    def dim(self) -> int:
        return 2 * self.n_sites


def _lattice(L):
    return Torus(L, L) if L < 3 else LatticeSpec(L, L)


def _parts(lat, B, scale, seed, nan=False, dtype=torch.float32):
    """(hr, hi, Δ_re, Δ_im, disorder) of B chains at the production
    couplings, one impurity site in five at W = 1, Δ uniform in ±scale/2
    (``nan``: some entries NaN or inf, zeroed as the leapfrog zeroes
    them)."""
    g = torch.Generator().manual_seed(seed)
    N = lat.n_sites
    p = make_params(beta=10.0, device="cpu", dtype=dtype, **PHYS)
    dis = (torch.rand(B, N, generator=g) < 0.2).to(dtype)
    dre = (torch.rand(B, N, 2, generator=g, dtype=dtype) - 0.5) * scale
    dim = (torch.rand(B, N, 2, generator=g, dtype=dtype) - 0.5) * scale
    if nan:
        dre[0, 0, 0] = float("nan")
        dim[-1, -1, 1] = float("inf")
        dre, dim = _finite_or_zero(dre), _finite_or_zero(dim)
    Hs = static_hamiltonian(lat, p.t, p.tp, p.mu, dis)
    hr, hi = assemble_parts(lat, Hs, dre, dim)
    return hr, hi, dre, dim, dis


def _mask(cols, nnz):
    n = cols.shape[0]
    m = torch.zeros((n, n), dtype=torch.bool)
    for r in range(n):
        m[r, torch.as_tensor(cols[r, :nnz[r]], dtype=torch.long)] = True
    return m


@pytest.mark.parametrize("L", [2, 3, 4, 16, 24])
@pytest.mark.parametrize("scale,nan", [(0.1, False), (1e30, False),
                                       (1.0, True)])
def test_the_table_scattered_back_is_h(L, scale, nan):
    lat = _lattice(L)
    hr, hi, *_ = _parts(lat, 2, scale, seed=L, nan=nan)
    cols, nnz = hamiltonian_columns(lat)
    n = lat.dim
    assert cols.shape == (n, kernels.BDG_HOP_K) and cols.dtype == np.int32
    assert (nnz <= 13).all() and (nnz >= 1).all()
    for r in range(n):
        row = cols[r, :nnz[r]]
        assert (np.diff(row) > 0).all()
        assert (cols[r, nnz[r]:] == row[-1]).all()
    if L >= 3:
        assert (nnz == 13).all()
    c = torch.as_tensor(cols, dtype=torch.long)
    rows = torch.arange(n)[:, None].expand_as(c)
    live = torch.arange(13)[None, :] < torch.as_tensor(nnz)[:, None]
    for h in (hr, hi):
        back = torch.zeros_like(h)
        back[:, rows[live], c[live]] = h[:, rows[live], c[live]]
        assert torch.equal(back, h)
        assert not bool(h[:, ~_mask(cols, nnz)].any())


@pytest.mark.parametrize("L,smem", [(2, None), (3, None), (4, None),
                                    (16, None), (24, None), (46, None),
                                    (24, 516 * 24)])
def test_the_plan_holds_every_column_a_block_reads(monkeypatch, L, smem):
    """The plan at ``BDG_HOP_ROWS`` rows a block, and at 24×24 under a
    shared memory too small for that block's halo of 60 rows, where the
    block is halved until its halo fits."""
    if smem is not None:
        monkeypatch.setattr(kernels, "BDG_HOP_SMEM_MAX", smem)
    cols, nnz = hamiltonian_columns(_lattice(L))
    plan = kernels.hop_plan(cols, nnz)
    rows, halo, lidx = plan["rows"], plan["halo"], plan["lidx"]
    n = cols.shape[0]
    assert (512 + 4) * halo.shape[1] <= kernels.BDG_HOP_SMEM_MAX
    if smem is None:
        assert rows.shape[1] == kernels.BDG_HOP_ROWS
    else:
        assert rows.shape[1] < kernels.BDG_HOP_ROWS
    listed = np.sort(rows[rows >= 0])
    assert np.array_equal(listed, np.arange(n))
    for blk, h in zip(rows, halo):
        h_live = h[h >= 0]
        assert (np.diff(h_live) > 0).all() and (h[len(h_live):] == -1).all()
        for r in blk[blk >= 0]:
            assert np.array_equal(h[lidx[r]], cols[r])
            # a site's particle and hole rows share the block
            partner = (r + n // 2) % n
            assert partner in blk


@pytest.mark.parametrize("L", [2, 3, 4, 16])
@pytest.mark.parametrize("scale", [0.1, 1e30])
def test_plain_k6_matches_the_float64_dense_product(L, scale):
    """Each float32 entry within 4e-6 of Σ|h||u| over its terms (13 fused
    terms of float32 rounding, 6e-8 each, ~8e-7, with room); in float64
    the same to 1e-14."""
    lat = _lattice(L)
    hr, hi, *_ = _parts(lat, 3, scale, seed=10 + L)
    g = torch.Generator().manual_seed(L)
    n = lat.dim
    ur, ui = (torch.randn(3, n, n, generator=g) for _ in range(2))
    H = torch.complex(hr.double(), hi.double())
    U = torch.complex(ur.double(), ui.double())
    want = H @ U
    size = H.abs() @ U.abs()
    table = tte.hop_table(lat, torch.device("cpu"))
    wr, wi = kernels.bdg_hop(hr, hi, table, ur, ui)
    for got, ref in ((wr, want.real), (wi, want.imag)):
        assert got.dtype == torch.float32
        assert bool(((got.double() - ref).abs() <= 4e-6 * size).all())
    wr, wi = kernels.bdg_hop(hr.double(), hi.double(), table, ur.double(),
                             ui.double())
    assert bool(((wr - want.real).abs() <= 1e-14 * size).all())
    assert bool(((wi - want.imag).abs() <= 1e-14 * size).all())


def _tracked_problem(L=16, B=2):
    """A leapfrog step's problem: H at Δ₀ + δ, where U₀ is H(Δ₀)'s exact
    eigenbasis (float64, cast to float32), δ ~ 1e-3."""
    lat = LatticeSpec(L, L)
    hr0, hi0, dre, dim, dis = _parts(lat, B, 0.1, seed=5)
    _, U0 = torch.linalg.eigh(torch.complex(hr0.double(), hi0.double()))
    g = torch.Generator().manual_seed(6)
    dre = dre + 1e-3 * torch.randn(dre.shape, generator=g)
    dim = dim + 1e-3 * torch.randn(dim.shape, generator=g)
    p = make_params(beta=10.0, device="cpu", **PHYS)
    Hs = static_hamiltonian(lat, p.t, p.tp, p.mu, dis)
    hr, hi = assemble_parts(lat, Hs, dre, dim)
    return (lat, p, hr, hi, dre, dim, U0.real.float().contiguous(),
            U0.imag.float().contiguous())


@pytest.mark.parametrize("precision,rot_dtype", [(None, None),
                                                 ("highest", None),
                                                 (None, torch.bfloat16)])
def test_tracked_eigh_with_and_without_the_table(precision, rot_dtype):
    lat, p, hr, hi, dre, dim, ur0, ui0 = _tracked_problem()
    exact = torch.linalg.eigvalsh(torch.complex(hr.double(), hi.double()))
    radius = exact.abs().amax(-1, keepdim=True)
    kw = dict(n_iter=6, precision=precision, rot_dtype=rot_dtype,
              ns_steps=1 if rot_dtype is not None else 2)
    table = tte.hop_table(lat, torch.device("cpu"))
    d0, X0, Y0, r0 = tte.tracked_eigh_nofallback(hr, hi, ur0, ui0, **kw)
    d1, X1, Y1, r1 = tte.tracked_eigh_nofallback(hr, hi, ur0, ui0, hop=table,
                                                 **kw)
    if rot_dtype is None:
        for d in (d0, d1):
            gap = (torch.sort(d.double(), -1).values - exact).abs() / radius
            assert float(gap.max()) <= 1e-5
    else:
        assert torch.equal(X0, X1) and torch.equal(Y0, Y1)
    assert float(((d1 - d0).abs() / radius).max()) <= 1e-5
    F0 = hmc_forces_real(lat, dre, dim, d0, X0, Y0, p.beta, p.J)[:2]
    F1 = hmc_forces_real(lat, dre, dim, d1, X1, Y1, p.beta, p.J)[:2]
    scale = max(float(F0[0].abs().max()), float(F0[1].abs().max()))
    for a, b in zip(F0, F1):
        assert float((a - b).abs().max()) <= 1e-4 * scale


def _count_k6(monkeypatch):
    calls = []
    real = tte.bdg_hop

    def counted(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(tte, "bdg_hop", counted)
    return calls


@pytest.mark.parametrize("dtype,precision,with_table,k6", [
    (torch.float32, None, True, True),
    (torch.float32, "highest", True, True),
    (torch.float32, "high", True, False),
    (torch.float32, "default", True, False),
    (torch.bfloat16, None, True, False),
    (torch.float64, None, True, False),
    (torch.float32, None, False, False),
    (torch.float32, "highest", False, False)])
def test_the_dispatch_rule(monkeypatch, dtype, precision, with_table, k6):
    calls = _count_k6(monkeypatch)
    lat = LatticeSpec(4, 4)
    hr, hi, *_ = _parts(lat, 2, 0.1, seed=1)
    g = torch.Generator().manual_seed(2)
    ur, ui = (torch.randn(2, lat.dim, lat.dim, generator=g) for _ in range(2))
    hr, hi, ur, ui = (x.to(dtype) for x in (hr, hi, ur, ui))
    table = tte.hop_table(lat, torch.device("cpu")) if with_table else None
    kernels.reset_launches()
    wr, wi = tte._h_times(hr, hi, ur, ui, precision, table)
    assert len(calls) == int(k6)
    want = tte.cmm(hr, hi, ur, ui, precision)
    tol = 0.1 if dtype == torch.bfloat16 else 1e-5
    assert float((wr - want[0]).abs().max()) <= tol
    assert float((wi - want[1]).abs().max()) <= tol
    # the CPU counts neither K6 nor the dense products
    assert kernels.LAUNCHES["bdg_hop"] == kernels.LAUNCHES["hu_dense"] == 0


def test_the_leapfrog_takes_k6_for_every_float32_product_by_h(monkeypatch):
    """A cheap sweep of the fast mix: the Nt readouts after the bf16
    rotations, the refine's rotations and readout and the polish's at
    "highest": Nt + (refine + 1) + (polish + 1) products by H, each K6;
    the bf16 rotations' products stay dense.  The untracked sweep and
    ``tracked_eigh`` pass no table."""
    calls = _count_k6(monkeypatch)
    lat = LatticeSpec(4, 4)
    p = make_params(beta=10.0, device="cpu", **PHYS)
    g = torch.Generator().manual_seed(4)
    s = hmc_real.init_chain_state_real(lat, p, 2, generator=g, device="cpu")
    hmc_real.tracked_leapfrog(lat, p, s, 3, 0.05, 2, 2, 1, 1,
                              torch.bfloat16, "highest", rot_scheme="exp2",
                              generator=g)
    assert len(calls) == 3 + (2 + 1) + (1 + 1)
    assert set(calls) == {torch.float32}
    del calls[:]
    hmc_real.tracked_leapfrog(lat, p, s, 2, 0.05, 2, 0, 1, 1, None, "high",
                              generator=g)
    # float32 rotations at None: 2 steps × (2 + 1); the polish at "high":
    # its readout only
    assert len(calls) == 2 * 3 + 1
    del calls[:]
    hmc_real.hmc_sweep_real(lat, p, s, 2, 0.05, "tracked", 2, generator=g)
    hr, hi, *_ = _parts(lat, 2, 0.1, seed=3)
    tte.tracked_eigh(hr, hi, s.X, s.Y)
    assert calls == []


@pytest.mark.parametrize("launches,traj,want", [
    ({"bdg_hop": 159, "hu_dense": 0}, 80, 100.0),
    ({"bdg_hop": 3, "hu_dense": 1}, 80, 75.0),
    ({"bdg_hop": 0, "hu_dense": 4}, 80, 0.0),
    ({"bdg_hop": 0, "hu_dense": 0}, 80, None),
    ({"bdg_hop": 5, "hu_dense": 0}, 0, None),
    # a program without the counts (the parent of this metric)
    ({"rotation_s_parts": 5, "sigma_cap": 5}, 80, None)])
def test_the_hu_stencil_pct_reader(launches, traj, want):
    ctx = types.SimpleNamespace(traced_traj=traj,
                                counters={"launches": launches})
    assert harness.reader("hu_stencil_pct")(ctx) == want
