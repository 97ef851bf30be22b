"""Port parity for the matmul precision modes below "highest", on the CPU:
the PH solver's ``lift_precision`` and the tracked endpoint's
``polish_precision`` against the JAX package at ``Precision.HIGH`` and
``"high"``, where both are IEEE products, as on the card they are not.

Tolerances as ``ROADMAP.md`` sets them: float64 deterministic pieces to
1e-10 (1e-9 for a tracked trajectory, as ``tests/test_torch_hmc_real.py``),
float32 eigenvalues to 1e-5·‖M‖∞.  Then the scope itself
(``utils/precision.matmul_precision``): TF32 on inside it for a CUDA
device only, the caller's flag back after it, also after a raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLat
from dwavehmc_tpu.models.params import make_params as jmake_params
from dwavehmc_tpu.ops import ph_eigh as jph
from dwavehmc_tpu.parallel.ensemble import init_ensemble_real as jinit_ens
from dwavehmc_tpu.sampler import hmc_real as jhmc
from dwavehmc_tpu.sampler.hmc import calc_optimal_dt
from dwavehmc_tpu_torch.models import bdg_real as tbdg
from dwavehmc_tpu_torch.models.lattice import LatticeSpec as TLat
from dwavehmc_tpu_torch.models.params import make_params
from dwavehmc_tpu_torch.ops import ph_eigh as tph
from dwavehmc_tpu_torch.sampler import hmc_real as thmc
from dwavehmc_tpu_torch.utils.carry import params_from_numpy, state_from_numpy
from dwavehmc_tpu_torch.utils.precision import matmul_precision

torch.set_num_threads(2)

JAX_PREC = {"default": jax.lax.Precision.DEFAULT,
            "high": jax.lax.Precision.HIGH,
            "highest": jax.lax.Precision.HIGHEST}


def _np(x):
    return x.detach().cpu().numpy()


def _embedding(L, seed, dtype=torch.float64):
    """(1, 4N, 4N) embedding of a disordered random-Δ lattice (a
    non-degenerate spectrum) from seeded numpy draws."""
    rng = np.random.default_rng(seed)
    N = L * L
    dis = torch.as_tensor(rng.uniform(-0.5, 0.5, (1, N)))
    dre = torch.as_tensor(rng.standard_normal((1, N, 2)) * 0.05 + 0.04)
    dim = torch.as_tensor(rng.standard_normal((1, N, 2)) * 0.05)
    p = make_params(dtype=torch.float64, device="cpu")
    lat = TLat(L, L)
    M = tbdg.assemble_embedding(
        lat, tbdg.static_embedding(lat, p.t, p.tp, p.mu, dis), dre, dim)
    return M.to(dtype)


def _projector(X, Y):
    """Real part of the negative-level density matrix, gauge-free."""
    n = X.shape[-1] // 2
    return X[..., :n] @ X[..., :n].T + Y[..., :n] @ Y[..., :n].T


@pytest.mark.parametrize("prec", ["default", "high"])
def test_sign_and_ph_solve_match_jax_at_lower_lift_precision(prec):
    M = _embedding(4, 3)
    jM = jnp.asarray(_np(M)[0])
    sgn = tph.sign_embedding(M, lift_precision=prec)
    jsgn = jph.sign_embedding(jM, lift_precision=JAX_PREC[prec])
    np.testing.assert_allclose(_np(sgn)[0], np.asarray(jsgn), atol=1e-10)

    w, X, Y, fb = tph.diagonalize_embedding_ph_guarded(M,
                                                       lift_precision=prec)
    jw, jX, jY, jfb = jph.diagonalize_embedding_ph_guarded(
        jM[None], lift_precision=JAX_PREC[prec])
    assert fb is False and not bool(jfb)
    np.testing.assert_allclose(_np(w), np.asarray(jw), atol=1e-10)
    np.testing.assert_allclose(_projector(_np(X)[0], _np(Y)[0]),
                               _projector(np.asarray(jX)[0],
                                          np.asarray(jY)[0]), atol=1e-10)


def test_float32_lift_at_high_matches_jax():
    """float32, the anchor's dtype: the port's "high" lift against JAX's
    ``Precision.HIGH`` and against float64 ``eigh``."""
    M = _embedding(6, 5, torch.float32)
    norm = float(M.abs().sum(-1).max())
    w, _, _ = tph.diagonalize_embedding_ph(M, lift_precision="high")
    jw, _, _ = jph.diagonalize_embedding_ph(
        jnp.asarray(_np(M)[0], jnp.float32), lift_precision=JAX_PREC["high"])
    ref = torch.linalg.eigvalsh(M.double())[0, ::2]
    np.testing.assert_allclose(_np(w)[0], np.asarray(jw), atol=1e-5 * norm)
    np.testing.assert_allclose(_np(w)[0], _np(ref), atol=1e-5 * norm)


L = 4
N = L * L
NT = 3
BETA = 10.0


@pytest.fixture(scope="module")
def ensemble():
    jp = jmake_params(W=0.5, n_imp=0.25, beta=BETA, J=1.0, dtype=jnp.float64)
    js = jinit_ens(JLat(L, L), jp, jax.random.PRNGKey(5), 2,
                   dtype=jnp.float64, n_imp=0.25)
    as_np = lambda nt: {k: np.asarray(v) for k, v in nt._asdict().items()}  # noqa: E731
    return (jp, js, params_from_numpy(as_np(jp), device="cpu"),
            state_from_numpy(as_np(js), device="cpu"))


@pytest.mark.parametrize("correction", [False, True])
def test_tracked_leapfrog_with_the_polish_at_high_matches_jax(ensemble,
                                                              correction):
    """The endpoint refine 6 / polish 3 with ``polish_precision="high"``:
    the proposal, its endpoint spectrum and residual, and both accepts'
    dH, against the JAX package's on the JAX draws."""
    jp, js, tp, ts = ensemble
    dt = calc_optimal_dt(BETA, 1.0, 1.0, NT)
    kw = dict(tracked_iters=6, refine_iters=6, polish_iters=3, ns_steps=1,
              polish_precision="high", polish_correction=correction,
              rot_scheme="exp2")
    fn = functools.partial(jhmc.tracked_leapfrog, JLat(L, L), jp, Nt=NT,
                           dt=dt, **kw)
    jprop = jax.vmap(lambda s: fn(state=s))(js)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(js.key)
    normals = np.array(jax.vmap(lambda k: jax.random.normal(
        k, (2, N, 2), jnp.float64))(ks[:, 1]))
    u = np.array(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32))(ks[:, 2]))
    tprop = thmc.tracked_leapfrog(TLat(L, L), tp, ts, NT, dt, normals=normals,
                                  uniforms=u, **kw)
    for got, want in ((tprop.delta_re, jprop[0]), (tprop.pi_re, jprop[2]),
                      (tprop.evals, jprop[9]), (tprop.res_end, jprop[12])):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-9)

    _, jinfo = jax.vmap(lambda s, p: jhmc.tracked_accept_cheap(
        JLat(L, L), jp, s, p))(js, jprop)
    _, tinfo = thmc.tracked_accept_cheap(TLat(L, L), tp, ts, tprop)
    np.testing.assert_array_equal(_np(tinfo.accepted),
                                  np.asarray(jinfo.accepted))
    np.testing.assert_allclose(_np(tinfo.dH), np.asarray(jinfo.dH),
                               atol=1e-8)


def test_polish_at_high_equals_highest_on_the_cpu(ensemble):
    """On the CPU "high" is the IEEE product, so the two polishes agree bit
    for bit."""
    _, _, tp, ts = ensemble
    dt = calc_optimal_dt(BETA, 1.0, 1.0, NT)
    g = torch.Generator().manual_seed(1)
    normals = torch.randn((2, 2, N, 2), generator=g, dtype=torch.float64)
    u = torch.rand((2,), generator=g)
    props = [thmc.tracked_leapfrog(
        TLat(L, L), tp, ts, NT, dt, 6, 6, 3, 1, None, prec, False, "exp2",
        normals=normals, uniforms=u) for prec in ("highest", "high")]
    for a, b in zip(*props):
        assert torch.equal(a, b)


@pytest.fixture
def tf32_off():
    flags = torch.backends.cuda.matmul
    prior = flags.allow_tf32
    flags.allow_tf32 = False
    yield flags
    flags.allow_tf32 = prior


@pytest.mark.parametrize("prec", ["default", "high"])
def test_tf32_scope_restores_the_flag_after_a_raise(tf32_off, prec):
    """A CUDA device turns TF32 on inside the scope (no card is needed to
    set the flag); the flag is off again after, also when the body raises;
    "highest", None and a CPU device leave it alone."""
    with matmul_precision(prec, torch.device("cuda")):
        assert tf32_off.allow_tf32
    assert not tf32_off.allow_tf32
    with pytest.raises(ZeroDivisionError):
        with matmul_precision(prec, "cuda:0"):
            assert tf32_off.allow_tf32
            1 / 0
    assert not tf32_off.allow_tf32
    for p, dev in (("highest", "cuda"), (None, "cuda"), (prec, "cpu")):
        with matmul_precision(p, dev):
            assert not tf32_off.allow_tf32
    # a caller that had TF32 on keeps it
    tf32_off.allow_tf32 = True
    with pytest.raises(ValueError):
        with matmul_precision(prec, "cuda"):
            raise ValueError
    assert tf32_off.allow_tf32


def test_unknown_precision_raises():
    with pytest.raises(ValueError):
        with matmul_precision("fast", "cpu"):
            pass
    with pytest.raises(ValueError):
        tph.sign_embedding(_embedding(2, 0), lift_precision="tf32")


def test_tf32_head_and_the_three_pass_product():
    """``tf32_head`` rounds to the nearest value with 10 explicit mantissa
    bits (ties away from zero), so head + remainder is exact; on the CPU the
    three-pass product is a float32 product to within a few float32 units,
    and ``product`` leaves CPU tensors to ``torch.matmul``."""
    from dwavehmc_tpu_torch.utils.precision import (
        product, tf32_head, tf32x3_matmul)

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12,
                      -(1.0 + 3 * 2**-11), 3.0e-30, 0.0])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10,
                         -(1.0 + 2 * 2**-10)])
    head = tf32_head(x)
    np.testing.assert_array_equal(_np(head[:4]), _np(want[:4]))
    assert bool(((head.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(head + (x - head), x)
    g = torch.Generator().manual_seed(2)
    a, b = (torch.randn(64, 64, generator=g) for _ in range(2))
    ref = a.double() @ b.double()
    err3 = float((tf32x3_matmul(a, b).double() - ref).abs().max())
    err1 = float(((a @ b).double() - ref).abs().max())
    assert err3 <= 4.0 * err1 + 1e-6
    assert product("high")(a, b).equal(a @ b)
    assert product("highest") is torch.matmul
