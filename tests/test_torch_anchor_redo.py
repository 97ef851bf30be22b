"""A diverged chain at the exact anchor (ROADMAP fault F8), on the CPU.

A chain whose trajectory diverged reaches the guarded PH anchor with
finite levels of ~1e35: it fails the guard, and on the card the fallback's
float32 ``eigh`` at the embedding's dimension then does not converge and
raised, which ended the run.  ``models/bdg_real.symmetric_eigh`` now
solves such a batch chain by chain and redoes in float64 only the chains
that fail alone (``ops/ph_eigh.GUARD["redone"]``); the Metropolis step
rejects the chain on its ΔH, as the JAX package's does after its QDWH
eigh, and the other chains go on.

CPU LAPACK converges on such a matrix, so these tests make the float32
``eigh`` raise on the diverged chain (a mocked ``bdg_real._eigh``), as
cuSOLVER's did, and hold:

* a healthy guarded solve to its one host read (``ph_guard``) besides the
  Ritz step's ``eigh``, and a fallback whose ``eigh`` converges to its one
  call and its bits;
* a fallback or Ritz ``eigh`` that does not converge to a redo of that
  chain alone, the others bit-equal to the unmocked solve;
* the anchored sweep to rejecting the chain on its own ΔH, reported as
  the anchor computed it, with its Δ and spectrum the pre-trajectory ones
  and every other chain bit-equal to the unmocked sweep; a chain that
  fails in float64 too gets NaN levels and is rejected;
* the other chains' accept decisions to the plain float64 reference's
  (``hmc_bench/reference/physics.py``) on the harness's seeded draws.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dwavehmc_tpu_torch.models import bdg_real as tbdg
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import ph_eigh as tph
from dwavehmc_tpu_torch.parallel import ensemble
from dwavehmc_tpu_torch.sampler.hmc_real import tracked_leapfrog
from dwavehmc_tpu_torch.utils import profiling
from hmc_bench import harness
from hmc_bench.reference import physics as ref

torch.set_num_threads(2)

PHYS = dict(t=1.0, tp=-0.35, mu=-1.08, W=1.0, n_imp=0.05, J=0.8, mass=1.0)
L, BETA, NT = 4, 10.0, 6
LAT = LatticeSpec(L, L)
N = LAT.n_sites
#: the seed of the run in which the fault was found (24×24, 64 chains)
SEED = 3500000012
#: a matrix with an entry this large counts as the diverged chain's
HUGE = 1e10


@pytest.fixture(autouse=True)
def clean_counters():
    tph.reset_guard()
    profiling.reset_spans()
    yield
    tph.reset_guard()
    profiling.reset_spans()


def _params():
    return make_params(beta=BETA, device="cpu", dtype=torch.float32, **PHYS)


def _proposal(B=6, bad=2):
    """(params, state, proposal, normals, uniforms, disorder) of one
    anchored sweep from the harness's seeded inputs; chain ``bad``'s
    proposal (if any) has one bond's Δ at 1e17, finite, as a diverged
    trajectory leaves it."""
    p = _params()
    inputs = harness.Inputs(SEED, B, N, "cpu")
    dis, d0re, d0im = inputs.initial(PHYS["W"], PHYS["n_imp"])
    s = ensemble.init_ensemble_real(
        LAT, p, None, B, n_imp=PHYS["n_imp"], exact_solver="ph",
        disorder=dis, delta0_re=d0re, delta0_im=d0im, device="cpu")
    nrm, u = inputs.draws(1)
    prop = tracked_leapfrog(LAT, p, s, NT, _dt(), 6, 0, 0, 1, None,
                            normals=nrm[0], uniforms=u[0])
    if bad is not None:
        dre = prop.delta_re.clone()
        dre[bad, 3, 0] = 1e17
        prop = prop._replace(delta_re=dre)
    return p, s, prop, nrm[0], u[0], dis


def _dt():
    return harness.optimal_dt(BETA, PHYS["J"], PHYS["mass"], NT)


def _no_convergence(monkeypatch, dim, dtypes=(torch.float32,)):
    """``bdg_real._eigh`` raises, as cuSOLVER's float32 solver did, on any
    call of dimension ``dim`` in one of ``dtypes`` that holds a matrix
    with an entry above ``HUGE``."""
    real = tbdg._eigh

    def flaky(A, site="eigh_info"):
        if (A.dtype in dtypes and A.shape[-1] == dim
                and bool((A.abs().flatten(-2).amax(-1) > HUGE).any())):
            raise torch.linalg.LinAlgError("did not converge")
        return real(A, site)

    monkeypatch.setattr(tbdg, "_eigh", flaky)


def _embedding(bad=None):
    """The (3, 4N, 4N) float32 embeddings of three seeded chains; chain
    ``bad`` diverged as in ``_proposal``."""
    p, s, prop, *_ = _proposal(B=3, bad=bad)
    return ensemble.proposal_embedding(LAT, p, s, prop)


def _syncs():
    return {k: v[0] for k, v in profiling.SPANS.items()
            if k.startswith(profiling.SYNC_PREFIX)}


def test_a_healthy_guarded_solve_reads_the_host_once():
    M = _embedding()
    with profile(activities=[ProfilerActivity.CPU]):
        *_, fb = tph.diagonalize_embedding_ph_guarded(M)
    assert fb is False
    assert _syncs() == {"dwavehmc.sync.ph_guard": 1,
                        "dwavehmc.sync.eigh_info": 1}
    assert tph.GUARD["redone"] == 0


def test_a_converging_fallback_keeps_its_one_call_and_its_bits():
    M = _embedding(bad=1)
    with profile(activities=[ProfilerActivity.CPU]):
        w, X, Y, fb = tph.diagonalize_embedding_ph_guarded(M)
    assert fb is True
    assert _syncs() == {"dwavehmc.sync.ph_guard": 1,
                        "dwavehmc.sync.ph_fallback_counts": 1,
                        "dwavehmc.sync.eigh_info": 2}
    assert tph.GUARD["redone"] == 0
    lam, V = torch.linalg.eigh(M)
    d = M.shape[-1] // 2
    assert torch.equal(w, lam[..., ::2])
    assert torch.equal(X, V[..., :d, ::2]) and torch.equal(Y, V[..., d:, ::2])


@pytest.mark.parametrize("where,dim", [("fallback", 4 * N), ("ritz", 2 * N)])
def test_an_eigh_that_does_not_converge_is_redone_for_that_chain_alone(
        monkeypatch, where, dim):
    """The float32 ``eigh`` raises on the batch holding the diverged chain
    1, in the fallback (dimension 4N) or the Ritz step (2N): the batch is
    solved chain by chain, chain 1 alone in float64; chains 0 and 2 keep
    the unmocked solve's bits, and chain 1's levels are float64's."""
    M = _embedding(bad=1)
    want = tph.diagonalize_embedding_ph_guarded(M)
    tph.reset_guard()
    _no_convergence(monkeypatch, dim)
    with profile(activities=[ProfilerActivity.CPU]):
        got = tph.diagonalize_embedding_ph_guarded(M)
    assert got[3] is True and tph.GUARD["fallbacks"] == 1
    assert tph.GUARD["redone"] == 1
    # chains 0 and 2 alone, chain 1 in float64 (the mock raises before
    # the span of chain 1's float32 solve opens)
    assert _syncs()["dwavehmc.sync.fallback_redo"] == 3
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.float32
        assert torch.equal(a[[0, 2]], b[[0, 2]])
    w64 = torch.linalg.eigvalsh(M[1].double())[::2]
    scale = float(M[1].abs().sum(-1).amax())
    assert float((got[0][1].double() - w64).abs().max()) <= 1e-6 * scale


def _anchored(monkeypatch=None, dtypes=(torch.float32,), B=6, bad=2):
    p, s, prop, nrm, u, dis = _proposal(B, bad)
    if monkeypatch is not None:
        _no_convergence(monkeypatch, 4 * N, dtypes)
    tph.reset_guard()
    new, info = ensemble.tracked_accept_exact(LAT, p, s, prop, "ph")
    return s, new, info, dict(tph.GUARD), nrm, u, dis


def test_the_anchor_rejects_the_diverged_chain_and_the_others_go_on(
        monkeypatch):
    _, want, want_info, guard, *_ = _anchored()
    assert guard["fallbacks"] == 1 and guard["redone"] == 0
    s, new, info, guard, *_ = _anchored(monkeypatch)
    assert guard["fallbacks"] == 1 and guard["redone"] == 1
    bad, rest = 2, [0, 1, 3, 4, 5]
    # rejected on its own ΔH, which is reported as the anchor computed it:
    # the bosonic term of a Δ of 1e17
    assert not bool(info.accepted[bad])
    assert float(info.dH[bad]) >= 1e30
    for f in ("delta_re", "delta_im", "evals", "X", "Y"):
        assert torch.equal(getattr(new, f)[bad], getattr(s, f)[bad]), f
    # π is the trajectory's end momentum, as in the JAX package, whatever
    # the decision (each sweep refreshes it)
    for f in new._fields:
        assert torch.equal(getattr(new, f)[rest], getattr(want, f)[rest]), f
    assert torch.equal(new.pi_re, want.pi_re)
    assert torch.equal(info.dH[rest], want_info.dH[rest])
    assert torch.equal(info.accepted, want_info.accepted)


def test_a_chain_that_fails_in_float64_too_gets_nan_levels_and_is_rejected(
        monkeypatch):
    s, new, info, guard, *_ = _anchored(
        monkeypatch, dtypes=(torch.float32, torch.float64))
    bad = 2
    assert guard["redone"] == 1
    assert not bool(torch.isfinite(info.dH[bad]))
    assert not bool(info.accepted[bad])
    for f in ("delta_re", "delta_im", "evals", "X", "Y"):
        assert torch.equal(getattr(new, f)[bad], getattr(s, f)[bad]), f
    assert bool(torch.isfinite(new.evals).all())


def test_the_other_chains_decide_as_the_float64_reference(monkeypatch):
    """The reference replays each healthy chain's trajectory from the same
    start on the same normals; its ΔH is within 5e-3 of the port's float32
    one and its decision on the same uniform is the port's."""
    s, new, info, guard, nrm, u, dis = _anchored(monkeypatch)
    assert guard["redone"] == 1
    rest = torch.tensor([0, 1, 3, 4, 5])
    c = dict(PHYS, beta=BETA)
    d = torch.complex(s.delta_re[rest].double(), s.delta_im[rest].double())
    dis = dis[rest].double()
    E, U = ref.eigh(ref.hamiltonian(L, L, c, dis, d))
    pi0, d1, pi1, E1, _ = ref.leapfrog(L, L, c, dis, d, E, U,
                                        nrm[rest].double(), NT, _dt())
    dH = ref.delta_H(c, pi0, pi1, d, d1, E, E1)
    assert float((info.dH[rest].double() - dH).abs().max()) <= 5e-3
    assert torch.equal(info.accepted[rest],
                       ref.accepts(dH, u[rest].double()))
