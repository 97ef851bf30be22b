"""K7 (``ops/kernels.herm_dag``) on the CPU: its plain version and where the
tracked eigensolver takes it.

* both complex forms (Karatsuba at ``None``, four multiplications at
  "highest") against the port's and the JAX package's dense ``cmm_dag``
  within float32 rounding, for a Gram matrix U†U and a projection U†(HU);
* the output Hermitian to the bit: cr = crᵀ, and ci = −ciᵀ off the
  diagonal, whose entries stay as computed (the dense product's own);
* a chain alone gets the bits it gets inside its batch;
* the dispatch rule: K7 for float32 operands at ``None`` and "highest";
  bf16, float64, "high" and "default" take ``cmm_dag``; operands that are
  not square matrices of one shape take ``cmm_dag`` too, and only the card
  counts them (``LAUNCHES["herm_dense"]``);
* ``_project_T`` and ``_newton_schulz`` in float32 against the JAX
  package's, and the leapfrog's count of Hermitian products a sweep;
* ``herm_dag_pct``'s reader on hand-made counts.

The kernel itself is held against float64 and the dense product on the
card in ``tests/test_torch_cuda.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.ops import tracked_eigh as jte
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import kernels
from dwavehmc_tpu_torch.ops import tracked_eigh as tte
from dwavehmc_tpu_torch.sampler import hmc_real
from hmc_bench import harness

torch.set_num_threads(2)

PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, J=0.8, mass=1.0)
SHAPES = [(3, 50), (2, 96), (4, 128)]


def _operands(B, n, gram, seed=0, dtype=torch.float32):
    """(ar, ai, br, bi): a random U and either U itself (A†B = U†U) or
    W = H·U for a random Hermitian H (A†B = U†HU), W rounded from float64."""
    g = torch.Generator().manual_seed(seed)
    ur, ui = (torch.randn(B, n, n, generator=g, dtype=torch.float64)
              for _ in range(2))
    if gram:
        wr, wi = ur, ui
    else:
        hr, hi = (torch.randn(B, n, n, generator=g, dtype=torch.float64)
                  for _ in range(2))
        hr, hi = (hr + hr.mT) / 2, (hi - hi.mT) / 2
        wr, wi = hr @ ur - hi @ ui, hr @ ui + hi @ ur
    return tuple(x.to(dtype) for x in (ur, ui, wr, wi))


def _offdiag(x):
    return x - torch.diag_embed(x.diagonal(dim1=-2, dim2=-1))


@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("gram", [True, False])
@pytest.mark.parametrize("precision", [None, "highest"])
def test_both_forms_match_cmm_dag_in_float32(B, n, gram, precision):
    """Within 2e-6 of Σ|a||b| (n float32 terms, ~n·6e-8 at worst) of the
    port's and the JAX package's dense product: the lower triangle is the
    dense one's own arithmetic, the upper its mirror, which for U†(HU)
    differs from the dense upper by W's rounding (a few float32 units)."""
    A = _operands(B, n, gram, seed=n)
    cr, ci = kernels.herm_dag(*A, karatsuba=precision is None)
    dr, di = tte.cmm_dag(*A, precision)
    jr, ji = jax.vmap(lambda *x: jte.cmm_dag(*x, precision=precision))(
        *(jnp.asarray(x.numpy()) for x in A))
    a = torch.complex(A[0].double(), A[1].double()).abs()
    b = torch.complex(A[2].double(), A[3].double()).abs()
    size = a.mT @ b
    for got, dense, jx in ((cr, dr, jr), (ci, di, ji)):
        assert got.dtype == torch.float32 and got.shape == (B, n, n)
        for want in (dense, torch.as_tensor(np.array(jx))):
            err = (got.double() - want.double()).abs() / size
            assert float(err.max()) <= 2e-6
    # the lower triangle, the diagonal with it, is the dense product's
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    assert torch.equal(cr[..., lower], dr[..., lower])
    assert torch.equal(ci[..., lower], di[..., lower])


@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("karatsuba", [True, False])
def test_the_output_is_hermitian_to_the_bit(B, n, karatsuba):
    for gram in (True, False):
        cr, ci = kernels.herm_dag(*_operands(B, n, gram, seed=B),
                                  karatsuba=karatsuba)
        assert torch.equal(cr, cr.mT)
        assert torch.equal(_offdiag(ci), -_offdiag(ci).mT)


@pytest.mark.parametrize("karatsuba", [True, False])
def test_a_chain_alone_gets_its_bits_in_the_batch(karatsuba):
    A = _operands(4, 96, False, seed=7)
    cr, ci = kernels.herm_dag(*A, karatsuba=karatsuba)
    for b in (0, 3):
        lr, li = kernels.herm_dag(*(x[b:b + 1] for x in A),
                                  karatsuba=karatsuba)
        assert torch.equal(lr[0], cr[b]) and torch.equal(li[0], ci[b])


def _count_k7(monkeypatch):
    calls = []
    real = tte.herm_dag

    def counted(*a, karatsuba=True, **k):
        calls.append((a[0].dtype, karatsuba))
        return real(*a, karatsuba=karatsuba, **k)

    monkeypatch.setattr(tte, "herm_dag", counted)
    return calls


@pytest.mark.parametrize("dtype,precision,k7", [
    (torch.float32, None, True),
    (torch.float32, "highest", True),
    (torch.float32, "high", False),
    (torch.float32, "default", False),
    (torch.bfloat16, None, False),
    (torch.bfloat16, "highest", False),
    (torch.float64, None, False),
    (torch.float64, "highest", False)])
def test_the_dispatch_rule(monkeypatch, dtype, precision, k7):
    calls = _count_k7(monkeypatch)
    A = _operands(2, 24, False, seed=3, dtype=dtype)
    kernels.reset_launches()
    got = tte._herm_dag(*A, precision)
    assert calls == ([(torch.float32, precision is None)] if k7 else [])
    want = tte.cmm_dag(*A, precision)
    tol = 0.5 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert float((g.double() - w.double()).abs().max()) <= tol
    if not k7:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the CPU counts neither K7 nor the dense products
    assert kernels.LAUNCHES["herm_dag"] == kernels.LAUNCHES["herm_dense"] == 0


def test_operands_not_square_of_one_shape_take_cmm_dag(monkeypatch):
    calls = _count_k7(monkeypatch)
    g = torch.Generator().manual_seed(5)
    ar, ai = (torch.randn(2, 30, 20, generator=g) for _ in range(2))
    kernels.reset_launches()
    got = tte._herm_dag(ar, ai, ar, ai)
    want = tte.cmm_dag(ar, ai, ar, ai)
    assert calls == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES["herm_dense"] == 0


@pytest.fixture(scope="module")
def problem32():
    """(hr, hi, ur, ui) float32: H one step away from U's exact basis at
    12×12 (n = 288), two chains."""
    from dwavehmc_tpu_torch.models.bdg import static_hamiltonian
    from dwavehmc_tpu_torch.models.bdg_real import assemble_parts

    lat = LatticeSpec(12, 12)
    g = torch.Generator().manual_seed(11)
    p = make_params(beta=10.0, device="cpu", dtype=torch.float64, **PHYS)
    N = lat.n_sites
    dis = (torch.rand(2, N, generator=g) < 0.2).double()
    dre, dim = ((torch.rand(2, N, 2, generator=g, dtype=torch.float64) - 0.5)
                * 0.2 for _ in range(2))
    Hs = static_hamiltonian(lat, p.t, p.tp, p.mu, dis)
    hr, hi = assemble_parts(lat, Hs, dre, dim)
    _, U = torch.linalg.eigh(torch.complex(hr, hi))
    hr1, hi1 = assemble_parts(lat, Hs, dre + 1e-3, dim - 1e-3)
    return tuple(x.float().contiguous()
                 for x in (hr1, hi1, U.real, U.imag))


@pytest.mark.parametrize("precision", [None, "highest"])
def test_projection_and_newton_schulz_match_jax_in_float32(problem32,
                                                           precision):
    """Through K7's plain version, T = U†HU within 1e-5 of max|T| of the
    JAX package's float32 projection, its diagonal likewise, and a
    Newton–Schulz step within 1e-5 of the JAX package's."""
    hr, hi, ur, ui = problem32
    jx = [jnp.asarray(x.numpy()) for x in problem32]
    want = jax.vmap(lambda *x: jte._project_T(*x, precision=precision))(*jx)
    got = tte._project_T(hr, hi, ur, ui, precision)
    scale = float(np.abs(np.asarray(want[0])).max())
    for g, w in zip(got, want[:3]):
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-5 * scale
    want_u = jax.vmap(lambda a, b: jte._newton_schulz(a, b, precision))(
        jx[2] * 1.01, jx[3])
    got_u = tte._newton_schulz(ur * 1.01, ui, precision)
    for g, w in zip(got_u, want_u):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-5


def test_the_leapfrog_takes_k7_for_every_float32_hermitian_product(
        monkeypatch):
    """A cheap sweep of the fast mix: the Nt readouts after the bf16
    rotations, the refine's rotations (a projection and two Newton–Schulz
    steps each) and readout at ``None``, the polish's at "highest": Nt +
    (3·refine + 1) Karatsuba and 3·polish + 1 four-form products, each K7;
    the bf16 rotations' products stay dense.  With float32 rotations each
    step's rotations (a projection and ``ns_steps`` steps each) are K7
    too, and a polish at "high" keeps only its "highest" readout."""
    calls = _count_k7(monkeypatch)
    lat = LatticeSpec(4, 4)
    p = make_params(beta=10.0, device="cpu", **PHYS)
    g = torch.Generator().manual_seed(4)
    s = hmc_real.init_chain_state_real(lat, p, 2, generator=g, device="cpu")
    hmc_real.tracked_leapfrog(lat, p, s, 3, 0.05, 2, 2, 1, 1,
                              torch.bfloat16, "highest", rot_scheme="exp2",
                              generator=g)
    assert calls.count((torch.float32, True)) == 3 + (3 * 2 + 1)
    assert calls.count((torch.float32, False)) == 3 * 1 + 1
    assert len(calls) == 3 + 7 + 4
    del calls[:]
    hmc_real.tracked_leapfrog(lat, p, s, 2, 0.05, 2, 0, 1, 1, None, "high",
                              generator=g)
    assert calls == ([(torch.float32, True)] * (2 * (2 * 2 + 1))
                     + [(torch.float32, False)])


@pytest.mark.parametrize("launches,traj,want", [
    ({"herm_dag": 321, "herm_dense": 0}, 80, 100.0),
    ({"herm_dag": 3, "herm_dense": 1}, 80, 75.0),
    ({"herm_dag": 0, "herm_dense": 4}, 80, 0.0),
    ({"herm_dag": 0, "herm_dense": 0}, 80, None),
    ({"herm_dag": 5, "herm_dense": 0}, 0, None),
    # a program without the counts (the parent of this metric)
    ({"bdg_hop": 5, "hu_dense": 0}, 80, None)])
def test_the_herm_dag_pct_reader(launches, traj, want):
    ctx = types.SimpleNamespace(traced_traj=traj,
                                counters={"launches": launches})
    assert harness.reader("herm_dag_pct")(ctx) == want
