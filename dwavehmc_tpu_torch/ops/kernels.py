"""The port's hand-written Hopper kernels, their bindings and their plain
PyTorch versions.

=====  ==========================  ==========================================
K1     ``rotation_s_parts``        ``csrc/rotation_s.cu``; replaces
                                   ``dwavehmc_tpu/ops/pallas_kernels.py::
                                   rotation_s_parts``
K2     ``weighted_lorentzian_sum`` ``csrc/lorentzian.cu``; replaces
                                   ``dwavehmc_tpu/ops/pallas_kernels.py::
                                   weighted_lorentzian_sum``
K3     ``chain_sum``               ``csrc/chain_sum.cu``; the per-chain sums
                                   of the HMC energies in a fixed order (no
                                   TPU kernel: XLA's ``jnp.sum``)
K4     retired                     no caller since K5 took the σ-cap's product
K5     ``spectral_norm_est``       ``csrc/sigma_cap.cu``; the σ-cap's power
       (launches: ``sigma_cap``)   iteration in one launch (no TPU kernel:
                                   XLA's ``matmul`` and ``jnp.sum``)
K6     ``bdg_hop``                 ``csrc/bdg_hop.cu``; W = H·U through the
                                   columns where a row of the BdG H can be
                                   nonzero (no TPU kernel: XLA's dense
                                   ``matmul``, which multiplies H's zeros)
K7     ``herm_dag``                ``csrc/herm_dag.cu``; C = A†B where C is
                                   Hermitian, over the lower triangle's
                                   tiles, every real product and combine of
                                   the complex form in one launch (no TPU
                                   kernel: XLA's dense ``matmul``s and adds)
=====  ==========================  ==========================================

K3 and K5 exist so that a chain's sweep gives the same bits whatever batch
it runs in (ROADMAP fault F6): PyTorch's CUDA reduction and cuBLAS's
batched matrix-vector product pick their order of addition by the batch's
size.  K3 adds in one halving tree (``csrc/chain_sum.cu``), and its plain
version runs the same tree, so kernel and plain version agree to the bit.
K5 runs the σ-cap of a tracked rotation (3 power iterations and a last
product) in those trees in one launch, each tree folded past the levels
that add only padding, and σ bit-equal to its plain version, the
composition of ``chain_matvec_plain`` and K3's plain version
(``csrc/sigma_cap.cu``: why the fold keeps σ's bits; its float64 entries
are ``sigma_cap_f64.cu``, the same file compiled for double).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use into one
shared library under ``build/kernels/`` beside the package (one ``nvcc -c``
per source, all started together, then one link) and loaded with ``ctypes``:
plain C entry points, pointers as ``c_void_p``, launched on PyTorch's current
stream.  Each C entry returns ``cudaGetLastError()``; a nonzero value raises.
Object files and the unlinked library carry the process id, and the library
is renamed into place, so ranks that build a fresh checkout at once do not
write each other's files.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises.  There is no fallback between the two.  Each
kernel launch adds one to ``LAUNCHES[name]``; nothing else touches the count.
Two entries count no kernel: ``LAUNCHES["hu_dense"]`` counts the float32
IEEE products by H on the card that ``ops/tracked_eigh._project_T`` left to
the dense product (its caller gave no K6 table), so that K6's launches over
both are the share of those products K6 took; ``LAUNCHES["herm_dense"]``
likewise counts the float32 IEEE Hermitian products A†B on the card that
``ops/tracked_eigh._herm_dag`` left to the dense ``cmm_dag`` (operands that
are not square matrices of one shape), beside K7's ``herm_dag``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rotation_s.cu", "lorentzian.cu", "chain_sum.cu", "sigma_cap.cu",
           "sigma_cap_f64.cu", "bdg_hop.cu", "herm_dag.cu")
#: headers the sources include (part of the build's key)
HEADERS = ("halving_tree.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches since the last ``reset_launches()``, by kernel name
LAUNCHES = {"rotation_s_parts": 0, "weighted_lorentzian_sum": 0,
            "chain_sum": 0, "sigma_cap": 0,
            "bdg_hop": 0, "hu_dense": 0, "herm_dag": 0, "herm_dense": 0}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- build and load ---------------------------------------------------------

def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels cannot be built")
    return nvcc


def _source_tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC_DIR / src).read_bytes())
    return h.hexdigest()[:16]


def _object_path(lib_path: Path, src: str) -> Path:
    """This process's object file of ``src`` for ``lib_path``."""
    return lib_path.with_name(f"{Path(src).stem}_{lib_path.stem}."
                              f"{os.getpid()}.o")


def build(force: bool = False) -> dict:
    """Compile the kernels (unless an up-to-date library exists and
    ``force`` is false) and load them.  Returns ``{"seconds", "library",
    "ptxas"}`` with ptxas's register and shared-memory report."""
    global _lib
    lib_path = BUILD_DIR / f"libdwavehmc_kernels_{_source_tag()}.so"
    if lib_path.exists() and not force:
        _lib = _load(lib_path)
        return {"seconds": 0.0, "library": str(lib_path), "ptxas": []}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in SOURCES:
            obj = _object_path(lib_path, src)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o",
                   str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # wait for every compiler before judging any, so none is left
        # running
        results = [(src, p, p.communicate()[1]) for src, _obj, p in jobs]
        ptxas = []
        for src, proc, err in results:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{err}")
            ptxas += [f"{src}: {line.strip()}" for line in err.splitlines()
                      if "registers" in line or "Compiling entry" in line]
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(obj) for _s, obj, _p in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for _src, obj, _p in jobs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    _lib = _load(lib_path)
    return {"seconds": seconds, "library": str(lib_path), "ptxas": ptxas}


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dwh_rotation_s_parts.argtypes = [p, p, p, p, p, i, i, f, p]
    lib.dwh_rotation_s_parts.restype = i
    lib.dwh_weighted_lorentzian_sum.argtypes = [p, p, p, p, p, i, i, i, i,
                                                i, i, i, i, i, f, p]
    lib.dwh_weighted_lorentzian_sum.restype = i
    for name in ("dwh_chain_sum_f32", "dwh_chain_sum_f64"):
        getattr(lib, name).argtypes = [p, p, i, ctypes.c_longlong, p]
        getattr(lib, name).restype = i
    for name in ("dwh_sigma_cap_f32", "dwh_sigma_cap_f64"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                       p]
        getattr(lib, name).restype = i
    for name in ("dwh_sigma_cap_resident_f32", "dwh_sigma_cap_resident_f64"):
        getattr(lib, name).argtypes = [i, i, i]
        getattr(lib, name).restype = i
    for name in ("dwh_sigma_cap_attrs_f32", "dwh_sigma_cap_attrs_f64"):
        getattr(lib, name).argtypes = [i, i, i, p]
        getattr(lib, name).restype = i
    lib.dwh_bdg_hop.argtypes = [p] * 11 + [i] * 6 + [p]
    lib.dwh_bdg_hop.restype = i
    lib.dwh_herm_dag.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.dwh_herm_dag.restype = i
    lib.dwh_herm_dag_attrs.argtypes = [i, p]
    lib.dwh_herm_dag_attrs.restype = i
    return lib


def _library():
    if _lib is None:
        build()
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device} (CUDA), "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --- K1: rotation generator -------------------------------------------------

def rotation_s_parts_plain(tr, ti, d, smax: float):
    """Plain PyTorch K1: the elementwise path of
    ``ops/tracked_eigh.rotation_matrix_parts`` in the JAX package.
    tr/ti (B, n, n), d (B, n) → (sr, si)."""
    n = d.shape[-1]
    gap = d[..., None, :] - d[..., :, None]
    mag = torch.sqrt(tr * tr + ti * ti)
    theta = 0.5 * torch.atan2(2.0 * mag, torch.abs(gap))   # [0, π/4]
    theta = torch.clamp(theta, max=smax)
    ok = mag > 1e-30
    den = torch.clamp(mag, min=1e-30)
    phase_r = torch.where(ok, tr / den, 0.0)
    phase_i = torch.where(ok, ti / den, 0.0)
    sgn = torch.sign(gap + 1e-30)
    mask = 1.0 - torch.eye(n, dtype=tr.dtype, device=tr.device)
    return phase_r * theta * sgn * mask, phase_i * theta * sgn * mask


def rotation_s_parts_cuda(tr, ti, d, smax: float):
    """Launch K1 on float32 CUDA tensors tr/ti (B, n, n), d (B, n)."""
    B, n = d.shape
    dev = d.device
    _check("tr", tr, (B, n, n), dev)
    _check("ti", ti, (B, n, n), dev)
    _check("d", d, (B, n), dev)
    sr = torch.empty_like(tr)
    si = torch.empty_like(ti)
    if B == 0 or n == 0:
        return sr, si
    err = _library().dwh_rotation_s_parts(
        tr.data_ptr(), ti.data_ptr(), d.data_ptr(), sr.data_ptr(),
        si.data_ptr(), B, n, float(smax), _stream(dev))
    _raise_on(err, "rotation_s_parts")
    LAUNCHES["rotation_s_parts"] += 1
    return sr, si


def rotation_s_parts(tr, ti, d, smax: float):
    """K1 dispatch: CPU tensors → plain version in their dtype; CUDA
    tensors → the kernel in float32 (cast as the TPU wrapper casts), its
    result in the inputs' dtype (as JAX promotes the kernel's float32
    output where a float64 carry uses it)."""
    if tr.device.type == "cpu":
        return rotation_s_parts_plain(tr, ti, d, smax)
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    sr, si = rotation_s_parts_cuda(f32(tr), f32(ti), f32(d), smax)
    return sr.to(tr.dtype), si.to(tr.dtype)


# --- K2: weighted Lorentzian sum --------------------------------------------

def lorentzian(x, eta):
    """(1/π)·η/(x²+η²)."""
    return (eta / math.pi) / (x * x + eta * eta)


def weighted_lorentzian_sum_plain(omega, de, w2, eta, chunk: int = 16):
    """Plain PyTorch K2: S[b, k] = Σ_i w2[b, i]·L(ω[b, k] − de[b, i]; η) for
    omega (B, n_ω), de/w2 (B, M).  Chunked over ω, so at most a
    (B, chunk, M) Lorentzian block is live."""
    outs = []
    for s in range(0, omega.shape[-1], chunk):
        om = omega[:, s:s + chunk]
        L = lorentzian(om[:, :, None] - de[:, None, :], eta)
        outs.append(torch.matmul(L, w2[:, :, None])[..., 0])
    return torch.cat(outs, dim=-1)


#: pairs a K2 block stages in shared memory (32 KB as float4 pairs)
LORENTZ_CHUNK = 4096
#: frequencies a K2 thread keeps in registers on the wide (σ(ω)) geometry
LORENTZ_R = (4, 5, 6, 7, 8)


class LorentzianLaunch(NamedTuple):
    """K2's launch geometry.  Frequency w of tile t is computed by lane
    ``w % tile_w`` of the block's frequency lanes as register
    ``r = (w - t·tile_w·R) // tile_w``; the pairs of chunk c,
    ``[c·chunk, (c+1)·chunk)``, are read as float4 doubles, double j by
    pair lane ``j % pair_lanes``."""

    tile_w: int        # frequency lanes per block
    R: int             # frequencies per thread, in registers
    pair_lanes: int    # threads splitting a chunk's pairs (a power of two)
    chunk: int         # pairs per block
    n_chunks: int
    n_tiles: int       # frequency tiles (grid y)

    @property
    def threads(self) -> int:
        return self.tile_w * self.pair_lanes

    @property
    def columns(self) -> int:
        """Frequency columns computed, padding included."""
        return self.n_tiles * self.tile_w * self.R

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: the float4 pairs, the tree over pair lanes
        (if any) and 32 floats of range check, as ``csrc/lorentzian.cu``
        lays it out."""
        tree = self.R * self.threads if self.pair_lanes > 1 else 0
        return 8 * self.chunk + 4 * (tree + 32)


@functools.lru_cache(maxsize=64)
def _lorentzian_launch(n_w: int, M: int) -> LorentzianLaunch:
    """Geometry of one K2 call on (·, n_w) frequencies and M pairs.

    Wide calls (n_w ≥ 128, the σ(ω) grid) use one pair lane and R ≥ 4
    frequencies per thread, with the (R, warps) that computes the fewest
    columns (1436 → 9 warps × 5 = 1440; ties go to fewer tiles, then to the
    larger R).  Narrow calls (the DC call at one frequency) keep one
    frequency per thread and split each chunk's pairs over 256 / tile_w
    lanes, so the card fills with n_chunks × B blocks.  Blocks are whole
    warps of at most 512 threads."""
    n_chunks = max(1, -(-M // LORENTZ_CHUNK))
    if n_w < 128:
        tile_w = 1 << max(0, n_w - 1).bit_length()
        return LorentzianLaunch(tile_w, 1, 256 // tile_w, LORENTZ_CHUNK,
                                n_chunks, 1)
    wide = (LorentzianLaunch(32 * warps, R, 1, LORENTZ_CHUNK, n_chunks,
                             -(-n_w // (32 * warps * R)))
            for R in LORENTZ_R for warps in range(1, 17))
    return min(wide, key=lambda g: (g.columns, g.n_tiles, -g.R))


def weighted_lorentzian_sum_cuda(omega, de, w2, eta: float):
    """Launch K2 on float32 CUDA tensors omega (B, n_ω), de/w2 (B, M)."""
    B, n_w = omega.shape
    M = de.shape[-1]
    dev = omega.device
    _check("omega", omega, (B, n_w), dev)
    _check("de", de, (B, M), dev)
    _check("w2", w2, (B, M), dev)
    out = torch.empty((B, n_w), dtype=torch.float32, device=dev)
    if B == 0 or n_w == 0:
        return out
    lib = _library()
    g = _lorentzian_launch(n_w, M)
    partial = torch.empty((B, g.n_chunks, n_w), dtype=torch.float32,
                          device=dev)
    err = lib.dwh_weighted_lorentzian_sum(
        omega.data_ptr(), de.data_ptr(), w2.data_ptr(), partial.data_ptr(),
        out.data_ptr(), B, n_w, M, g.tile_w, g.R, g.pair_lanes, g.chunk,
        g.n_chunks, g.smem_bytes, float(eta), _stream(dev))
    _raise_on(err, "weighted_lorentzian_sum")
    LAUNCHES["weighted_lorentzian_sum"] += 1
    return out


def weighted_lorentzian_sum(omega, de, w2, eta: float):
    """K2 dispatch: CPU tensors → plain version in their dtype; CUDA
    tensors → the kernel in float32 (cast as the TPU wrapper casts; the
    caller casts the result back)."""
    if omega.device.type == "cpu":
        return weighted_lorentzian_sum_plain(omega, de, w2, eta)
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    return weighted_lorentzian_sum_cuda(f32(omega), f32(de), f32(w2), eta)


# --- K3: per-chain sums in a fixed order -------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def tree_length(m: int) -> int:
    """The halving tree's padded length: the least power of two ≥ max(m,
    256) (``csrc/chain_sum.cu``)."""
    p = 256
    while p < m:
        p *= 2
    return p


def chain_sum_plain(x):
    """Plain PyTorch K3: Σ over the last axis of x (…, m), any leading shape
    and float dtype, in the kernel's order: zero-padded to
    ``tree_length(m)``, then x[i] + x[i + h] for h = P/2, …, 1.  The
    kernel runs this tree at any length: a row longer than one block's
    registers hold has its upper levels folded as it is loaded."""
    m = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, tree_length(m) - m))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _suffix(dtype: torch.dtype) -> str:
    """The C entry's dtype suffix; K3 and K5 take float32 and float64."""
    if dtype not in _SUFFIX:
        raise TypeError(f"expected float32 or float64, got {dtype}")
    return _SUFFIX[dtype]


def chain_sum_cuda(x):
    """Launch K3 on a contiguous float32 or float64 CUDA tensor x (…, m),
    rows of any length."""
    m = x.shape[-1]
    suffix = _suffix(x.dtype)
    lead = x.shape[:-1]
    rows = math.prod(lead)
    _check("x", x, x.shape, x.device, x.dtype)
    out = torch.empty(lead, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    err = getattr(_library(), f"dwh_chain_sum_{suffix}")(
        x.data_ptr(), out.data_ptr(), rows, m, _stream(x.device))
    _raise_on(err, "chain_sum")
    LAUNCHES["chain_sum"] += 1
    return out


def chain_sum(x):
    """K3 dispatch: Σ over the last axis, in one order whatever the batch.
    CPU tensors → plain version; CUDA tensors → the kernel, in their dtype
    (float32 or float64; any other raises)."""
    if x.device.type == "cpu":
        return chain_sum_plain(x)
    return chain_sum_cuda(x.contiguous())


def chain_matvec_plain(ar, ai, vr, vi):
    """w = (ar + i·ai)(vr + i·vi) for ar/ai (B, n, n) and vr/vi (B, n), each
    of ar·vr, ai·vi, ar·vi, ai·vr its own halving tree: (ar·vr − ai·vi,
    ar·vi + ai·vr), each (B, n); the product of K5's plain version."""
    r, i = vr[:, None, :], vi[:, None, :]
    return (chain_sum_plain(ar * r) - chain_sum_plain(ai * i),
            chain_sum_plain(ar * i) + chain_sum_plain(ai * r))


# --- K5: the σ-cap's power iteration in one launch ----------------------------

def spectral_norm_est_plain(sr, si, iters: int = 3):
    """Plain PyTorch K5: the power-iteration estimate of σ_max(S) per chain
    for S = sr + i·si (B, n, n), (B,), as the JAX package's
    ``_spectral_norm_est`` (S normal, so |λ| = σ): v = (1/√n, 0); ``iters``
    times w = S·v (``chain_matvec_plain``), v = w / (√Σ|w|² + 1e-30) (the
    sum ``chain_sum_plain``); then √Σ|S·v|².  v0's √n is taken on the
    tensors' device, so the call makes no host copy."""
    B, n = sr.shape[0], sr.shape[-1]
    root_n = torch.sqrt(torch.full((), float(n), dtype=sr.dtype,
                                   device=sr.device))
    vr = torch.full((B, n), 1.0, dtype=sr.dtype, device=sr.device) / root_n
    vi = torch.zeros_like(vr)
    for _ in range(iters):
        wr, wi = chain_matvec_plain(sr, si, vr, vi)
        nrm = torch.sqrt(chain_sum_plain(wr * wr + wi * wi))[:, None] + 1e-30
        vr, vi = wr / nrm, wi / nrm
    wr, wi = chain_matvec_plain(sr, si, vr, vi)
    return torch.sqrt(chain_sum_plain(wr * wr + wi * wi))


#: shared memory a block may use on Hopper (``csrc/sigma_cap.cu``)
SIGMA_CAP_SMEM_MAX = 232448
#: K5's modes, most preferred first, and their numbers in
#: ``csrc/sigma_cap.cu``: ``on_chip`` keeps a CTA's rows of S in its shared
#: memory after pass 0 (every chain at once); ``stream`` reads S from device
#: memory every pass, v in shared memory; ``v_in_l2`` streams S and reads v
#: from L2 (rows too long for v in shared memory)
SIGMA_CAP_MODES = {"on_chip": 1, "stream": 0, "v_in_l2": 2}
#: the longest rows each mode's kernels are built for: log2 of a lane's
#: leaves (``sigma_cap_lq``)
SIGMA_CAP_MAX_LQ = {"on_chip": 5, "stream": 10, "v_in_l2": 10}
#: a K5 CTA's warps (128 registers a thread, one CTA an SM)
SIGMA_CAP_WARPS = 16
#: rows a warp streams a pass from which each row is first streamed into L2
#: in one bulk copy (fewer rows: the copies of all warps' rows at once
#: overrun L2; ``chip_smoke.py`` ``kernel.sigma_cap``'s ``plans_ms``)
SIGMA_CAP_PREFETCH_ROWS = 8


def fold_length(n: int, least: int) -> int:
    """The largest power of two ≤ n, and at least ``least``: the length of
    the halving tree after its levels that add only padding and its one
    partial level (``csrc/sigma_cap.cu``)."""
    h = least
    while 2 * h <= n:
        h *= 2
    return h


def sigma_cap_lq(n: int) -> int:
    """log2 of the leaves each lane walks in a row of n: the row's folded
    tree has ``fold_length(n, 32)`` leaves over 32 lanes."""
    return (fold_length(n, 32) // 32).bit_length() - 1


def sigma_cap_smem(n: int, ctas: int, itemsize: int, mode: str) -> int:
    """A CTA's shared memory: v as pairs (2n values, unless ``v_in_l2``),
    the norm's ``fold_length(n, 64) / 2`` values and one to broadcast it,
    and ``on_chip``'s ⌈n / ctas⌉ rows of sr and of si."""
    values = (0 if mode == "v_in_l2" else 2 * n) + fold_length(n, 64) // 2 + 1
    if mode == "on_chip":
        values += 2 * -(-n // ctas) * n
    return itemsize * values


class SigmaCapPlan(NamedTuple):
    """K5's launch: one cooperative launch of ``ctas`` CTAs per chain,
    ``at_once`` chains at a time (the others in turn), in ``mode`` (a key
    of ``SIGMA_CAP_MODES``), with ``smem_bytes`` of dynamic shared memory a
    CTA, as ``csrc/sigma_cap.cu`` lays it out; ``prefetch`` streams each
    row into L2 in one bulk copy as a warp starts it."""

    ctas: int
    mode: str
    smem_bytes: int
    at_once: int
    prefetch: bool = False


def sigma_cap_prefetch(n: int, ctas: int, mode: str) -> bool:
    """Whether a warp streams enough rows a pass for the L2 prefetch
    (``SIGMA_CAP_PREFETCH_ROWS``); the on-chip mode reads S once."""
    rows = -(-n // ctas)
    return (mode != "on_chip"
            and -(-rows // SIGMA_CAP_WARPS) >= SIGMA_CAP_PREFETCH_ROWS)


def choose_sigma_cap_plan(B: int, n: int, itemsize: int, resident,
                          modes=tuple(SIGMA_CAP_MODES)) -> SigmaCapPlan:
    """K5's launch.  ``resident(mode, smem)`` is the number of CTAs the card
    holds at once.  ``on_chip`` where every chain fits at once with its
    rows in the CTAs' shared memory, at the most CTAs a chain that does;
    else ``stream`` (``v_in_l2`` where v does not fit) at the most CTAs a
    chain, at most n, with which the batch fits at once, or one CTA a chain
    and the chains in turns; the L2 prefetch where a warp streams enough
    rows (``sigma_cap_prefetch``).  ``modes`` narrows the choice (the
    card's comparisons of the modes).  A CTA's warps per SM come from the
    residency (``sigma_cap_info``)."""
    lq = sigma_cap_lq(n)
    for mode in modes:
        if lq > SIGMA_CAP_MAX_LQ[mode]:
            continue

        def fit(ctas, mode=mode):
            smem = sigma_cap_smem(n, ctas, itemsize, mode)
            room = resident(mode, smem) if smem <= SIGMA_CAP_SMEM_MAX else 0
            return smem, room

        if mode == "on_chip":
            # more CTAs a chain take fewer rows each: start where one row a
            # CTA would fit
            ctas = min(n, fit(n)[1] // B)
            while ctas >= 1:
                smem, room = fit(ctas)
                if smem > SIGMA_CAP_SMEM_MAX:
                    break
                if B * ctas <= room:
                    return SigmaCapPlan(ctas, mode, smem, B, False)
                ctas -= 1
            continue
        smem, room = fit(1)
        if room >= 1:
            ctas = max(1, min(n, room // B))
            return SigmaCapPlan(ctas, mode, smem, min(B, room // ctas),
                                sigma_cap_prefetch(n, ctas, mode))
    raise ValueError(f"sigma_cap: no launch fits n = {n} "
                     f"({itemsize}-byte values)")


def _resident_query(dtype: torch.dtype, n: int):
    query = getattr(_library(), f"dwh_sigma_cap_resident_{_suffix(dtype)}")
    return lambda mode, smem: query(n, smem, SIGMA_CAP_MODES[mode])


@functools.lru_cache(maxsize=64)
def _sigma_cap_plan(B: int, n: int, dtype: torch.dtype) -> SigmaCapPlan:
    return choose_sigma_cap_plan(B, n, dtype.itemsize,
                                 _resident_query(dtype, n))


def sigma_cap_info(n: int, dtype: torch.dtype, plan: SigmaCapPlan) -> dict:
    """The card's figures for ``plan``'s kernel at n: the rows' flavor
    (``sparse``: the partial level's partners in a few slots of a load, or
    none; ``dense``: anywhere), registers and spilled bytes a thread,
    threads a CTA, CTAs and warps an SM at its shared memory, and the
    card's SMs."""
    out = (ctypes.c_int * 6)()
    err = getattr(_library(), f"dwh_sigma_cap_attrs_{_suffix(dtype)}")(
        n, plan.smem_bytes, SIGMA_CAP_MODES[plan.mode], out)
    _raise_on(err, "sigma_cap attributes")
    regs, spill, threads, per_sm, sms, flavor = out
    return {"mode": plan.mode, "prefetch": plan.prefetch,
            "rows": ("sparse", "dense")[flavor],
            "registers": regs, "spill_bytes": spill,
            "smem_bytes": plan.smem_bytes, "threads": threads,
            "ctas_per_sm": per_sm, "warps_per_sm": per_sm * threads // 32,
            "sms": sms}


#: each device's barrier counters: zeros, which every launch leaves zero
_SIGMA_CAP_COUNTERS: dict = {}
#: counters outgrown by a larger batch, kept: a captured CUDA graph holds
#: their address (``parallel/cheap_graph.py``)
_OUTGROWN_COUNTERS: list = []


def _sigma_cap_counters(dev: torch.device, B: int) -> torch.Tensor:
    """B zeroed counters (one a chain) on ``dev``, made once and grown as
    needed, so a call launches nothing but K5.  Calls on one device share
    them, so they run in one stream's order."""
    bar = _SIGMA_CAP_COUNTERS.get(dev)
    if bar is None or bar.numel() < B:
        if bar is not None:
            _OUTGROWN_COUNTERS.append(bar)
        bar = torch.zeros((B,), dtype=torch.int32, device=dev)
        _SIGMA_CAP_COUNTERS[dev] = bar
    return bar


def spectral_norm_est_cuda(sr, si, iters: int = 3, plan=None):
    """Launch K5 on float32 or float64 CUDA tensors sr/si (B, n, n), n up
    to 65535: σ (B,).  ``plan`` (a ``SigmaCapPlan``) overrides the chosen
    one."""
    B, n = sr.shape[0], sr.shape[-1]
    dev, dt = sr.device, sr.dtype
    suffix = _suffix(dt)
    for name, t in (("sr", sr), ("si", si)):
        _check(name, t, (B, n, n), dev, dt)
    if B == 0 or n == 0:
        return torch.zeros((B,), dtype=dt, device=dev)
    plan = plan or _sigma_cap_plan(B, n, dt)
    sigma = torch.empty((B,), dtype=dt, device=dev)
    wbuf = torch.empty((2, B, 2, n), dtype=dt, device=dev)
    err = getattr(_library(), f"dwh_sigma_cap_{suffix}")(
        sr.data_ptr(), si.data_ptr(), sigma.data_ptr(), wbuf.data_ptr(),
        _sigma_cap_counters(dev, B).data_ptr(), B, n, plan.ctas,
        plan.at_once, int(iters), plan.smem_bytes,
        SIGMA_CAP_MODES[plan.mode], int(plan.prefetch), _stream(dev))
    _raise_on(err, "sigma_cap")
    LAUNCHES["sigma_cap"] += 1
    return sigma


def spectral_norm_est(sr, si, iters: int = 3):
    """K5 dispatch: σ_max(sr + i·si) per chain by power iteration, in one
    order whatever the batch.  CPU tensors → plain version; CUDA tensors →
    the kernel in their dtype (float32 or float64)."""
    if sr.device.type == "cpu":
        return spectral_norm_est_plain(sr, si, iters)
    return spectral_norm_est_cuda(sr.contiguous(), si.contiguous(), iters)


# --- K6: W = H·U through H's own entries --------------------------------------

#: the table's width: the most columns a row of the BdG H holds (the
#: diagonal, 4 nearest and 4 next-nearest neighbours in its Nambu block, 4
#: bond partners in the other); ``csrc/bdg_hop.cu``'s ``kK``
BDG_HOP_K = 13
#: rows a K6 CTA produces (the particle and hole rows of half as many
#: sites), at most 64: a CTA is 8 threads a row.  16 was the fastest of 16,
#: 32 and 64 on an H100 at (64, 1152) and (2, 4232) (PERF.md, K6's tuning);
#: ``hop_plan`` halves it where a block's halo outgrows shared memory
BDG_HOP_ROWS = 16
#: shared memory a K6 CTA may use: two chunks of its halo's 32 columns, real
#: and imaginary, 512 bytes a halo row, and the halo's rows, 4 bytes each
BDG_HOP_SMEM_MAX = 232448


class HopTable(NamedTuple):
    """K6's table of one lattice on one device, int32 throughout.  Row r of
    H (n = 2N rows) can be nonzero at ``cols[r, :nnz[r]]`` only (distinct,
    ascending); the rest of the row's entries repeat its last column and
    weigh zero.  The launch plan: CTA row block j produces rows
    ``rows[j]`` (sites s and their partners N + s; -1 past the last) and
    reads the rows ``halo[j]`` of U (-1 past the last), where
    ``lidx[r, k]`` is the place of ``cols[r, k]`` in its block's halo."""

    cols: torch.Tensor     # (n, K)
    nnz: torch.Tensor      # (n,)
    rows: torch.Tensor     # (blocks, R)
    halo: torch.Tensor     # (blocks, hmax)
    lidx: torch.Tensor     # (n, K)


def hop_plan(cols: np.ndarray, nnz: np.ndarray) -> dict:
    """K6's row blocks for the table (cols, nnz) of an H of n = 2N rows:
    block j holds sites [j·R/2, (j+1)·R/2) of the particle block and their
    partners in the hole block, which read the same sites; its halo is the
    distinct columns its rows hold.  R is ``BDG_HOP_ROWS``, halved until the
    largest halo fits a CTA's shared memory.  numpy arrays ``rows`` (the
    block's sites in its first half, their partners in its second, each
    half padded with -1), ``halo``, ``lidx``."""
    n = cols.shape[0]
    if n % 2:
        raise ValueError(f"bdg_hop: n = {n} rows, must be even")
    half, R = n // 2, BDG_HOP_ROWS
    while True:
        blocks, halos = [], []
        for s0 in range(0, half, R // 2):
            sites = np.arange(s0, min(s0 + R // 2, half))
            rows = np.concatenate([sites, sites + half])
            blocks.append(rows)
            halos.append(np.unique(np.concatenate(
                [cols[r, :nnz[r]] for r in rows])))
        hmax = max(len(h) for h in halos)
        if (512 + 4) * hmax <= BDG_HOP_SMEM_MAX or R == 2:
            break
        R //= 2
    rows = np.full((len(blocks), R), -1, dtype=np.int32)
    halo = np.full((len(blocks), hmax), -1, dtype=np.int32)
    lidx = np.zeros(cols.shape, dtype=np.int32)
    for j, (r, h) in enumerate(zip(blocks, halos)):
        k = len(r) // 2
        rows[j, :k], rows[j, R // 2:R // 2 + k] = r[:k], r[k:]
        halo[j, :len(h)] = h
        lidx[r] = np.searchsorted(h, cols[r])
    return {"rows": rows, "halo": halo, "lidx": lidx}


def bdg_hop_table(cols: np.ndarray, nnz: np.ndarray, device) -> HopTable:
    """The ``HopTable`` of (cols (n, K), nnz (n,)) on ``device``, with its
    launch plan (``hop_plan``).  The copies from host memory wait for the
    device: build it once a lattice and device, outside a graph capture."""
    if cols.shape[1] != BDG_HOP_K:
        raise ValueError(f"bdg_hop: a table of {cols.shape[1]} columns a "
                         f"row, expected {BDG_HOP_K}")
    plan = hop_plan(cols, nnz)
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                    dtype=torch.int32, device=device)
    return HopTable(i32(cols), i32(nnz), i32(plan["rows"]),
                    i32(plan["halo"]), i32(plan["lidx"]))


def bdg_hop_plain(hr, hi, table: HopTable, ur, ui):
    """Plain PyTorch K6: W = (hr + i·hi)(ur + i·ui) for (B, n, n) tensors,
    from the coefficients of H at the table's columns (gathered, the padded
    ones zero) and the rows of U they multiply, summed term by term in the
    table's order, each term in the 4-multiplication form:
    (wr + a·u) − c·v and (wi + a·v) + c·u."""
    cols = table.cols.long()
    n, K = cols.shape
    r = torch.arange(n, device=hr.device)[:, None]
    live = (torch.arange(K, device=hr.device)[None, :]
            < table.nnz.long()[:, None])
    cr = torch.where(live, hr[:, r, cols], 0.0)
    ci = torch.where(live, hi[:, r, cols], 0.0)
    wr = torch.zeros_like(ur)
    wi = torch.zeros_like(ui)
    for k in range(K):
        a, c = cr[..., k, None], ci[..., k, None]
        u, v = ur[:, cols[:, k]], ui[:, cols[:, k]]
        wr = (wr + a * u) - c * v
        wi = (wi + a * v) + c * u
    return wr, wi


def bdg_hop_cuda(hr, hi, table: HopTable, ur, ui):
    """Launch K6 on float32 CUDA tensors hr/hi/ur/ui (B, n, n) with a
    ``HopTable`` of n rows on their device."""
    B, n = ur.shape[0], ur.shape[-1]
    dev = ur.device
    for name, t in (("hr", hr), ("hi", hi), ("ur", ur), ("ui", ui)):
        _check(name, t, (B, n, n), dev)
    blocks, R = table.rows.shape
    hmax = table.halo.shape[1]
    for name, t, shape in (("cols", table.cols, (n, BDG_HOP_K)),
                           ("nnz", table.nnz, (n,)),
                           ("rows", table.rows, (blocks, R)),
                           ("halo", table.halo, (blocks, hmax)),
                           ("lidx", table.lidx, (n, BDG_HOP_K))):
        _check(name, t, shape, dev, torch.int32)
    wr = torch.empty_like(ur)
    wi = torch.empty_like(ui)
    if B == 0 or n == 0:
        return wr, wi
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (hr, hi, ur, ui, wr, wi))
    err = _library().dwh_bdg_hop(
        hr.data_ptr(), hi.data_ptr(), ur.data_ptr(), ui.data_ptr(),
        wr.data_ptr(), wi.data_ptr(), table.cols.data_ptr(),
        table.nnz.data_ptr(), table.rows.data_ptr(), table.halo.data_ptr(),
        table.lidx.data_ptr(), B, n, blocks, R, hmax, int(vec), _stream(dev))
    _raise_on(err, "bdg_hop")
    LAUNCHES["bdg_hop"] += 1
    return wr, wi


def bdg_hop(hr, hi, table: HopTable, ur, ui):
    """K6 dispatch: H·U for the BdG H = hr + i·hi whose nonzeros lie in
    ``table``'s columns.  CPU tensors → plain version in their dtype; CUDA
    tensors → the kernel (float32; any other raises)."""
    if ur.device.type == "cpu":
        return bdg_hop_plain(hr, hi, table, ur, ui)
    c = lambda x: x.contiguous()  # noqa: E731
    return bdg_hop_cuda(c(hr), c(hi), table, c(ur), c(ui))


# --- K7: the Hermitian product A†B over the lower triangle -------------------

def herm_dag_plain(ar, ai, br, bi, karatsuba: bool = True):
    """Plain PyTorch K7: C = (ar + i·ai)†(br + i·bi) for (…, n, n) tensors,
    dense in ``ops/tracked_eigh.cmm_dag``'s forms (``karatsuba``: m1 = arᵀbr,
    m2 = aiᵀbi, m3 = (ar − ai)ᵀ(br + bi), (m1 + m2, (m3 − m1) + m2); else
    (arᵀbr + aiᵀbi, arᵀbi − aiᵀbr)), then each entry above the diagonal
    replaced by its mirror's, cr[j, i] = cr[i, j] and ci[j, i] = −ci[i, j]:
    Hermitian to the bit, the diagonal as computed."""
    if karatsuba:
        m1 = torch.matmul(ar.mT, br)
        m2 = torch.matmul(ai.mT, bi)
        m3 = torch.matmul((ar - ai).mT, br + bi)
        cr, ci = m1 + m2, m3 - m1 + m2
    else:
        cr = torch.matmul(ar.mT, br) + torch.matmul(ai.mT, bi)
        ci = torch.matmul(ar.mT, bi) - torch.matmul(ai.mT, br)
    n = cr.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=cr.device).tril()
    return torch.where(lower, cr, cr.mT), torch.where(lower, ci, -ci.mT)


def herm_dag_info(karatsuba: bool) -> dict:
    """The card's figures for K7's kernel of one form: registers and
    spilled bytes a thread, threads and shared memory a CTA, CTAs an SM."""
    out = (ctypes.c_int * 5)()
    err = _library().dwh_herm_dag_attrs(int(karatsuba), out)
    _raise_on(err, "herm_dag attributes")
    regs, spill, threads, smem, per_sm = out
    return {"karatsuba": karatsuba, "registers": regs, "spill_bytes": spill,
            "threads": threads, "smem_bytes": smem, "ctas_per_sm": per_sm}


def herm_dag_cuda(ar, ai, br, bi, karatsuba: bool = True):
    """Launch K7 on float32 CUDA tensors ar/ai/br/bi (…, n, n) of one
    shape: (cr, ci) of that shape."""
    shape = tuple(ar.shape)
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"herm_dag: expected (..., n, n), got {shape}")
    dev = ar.device
    for name, t in (("ar", ar), ("ai", ai), ("br", br), ("bi", bi)):
        _check(name, t, shape, dev)
    cr = torch.empty_like(ar)
    ci = torch.empty_like(ar)
    n = shape[-1]
    B = math.prod(shape[:-2])
    if B == 0 or n == 0:
        return cr, ci
    vec = n % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (ar, ai, br, bi, cr, ci))
    err = _library().dwh_herm_dag(
        ar.data_ptr(), ai.data_ptr(), br.data_ptr(), bi.data_ptr(),
        cr.data_ptr(), ci.data_ptr(), B, n, int(karatsuba), int(vec),
        _stream(dev))
    _raise_on(err, "herm_dag")
    LAUNCHES["herm_dag"] += 1
    return cr, ci


def herm_dag(ar, ai, br, bi, karatsuba: bool = True):
    """K7 dispatch: A†B for complex A = ar + i·ai and B = br + i·bi where
    the caller knows it is Hermitian.  CPU tensors → plain version in
    their dtype; CUDA tensors → the kernel (float32; any other raises)."""
    if ar.device.type == "cpu":
        return herm_dag_plain(ar, ai, br, bi, karatsuba)
    c = lambda x: x.contiguous()  # noqa: E731
    return herm_dag_cuda(c(ar), c(ai), c(br), c(bi), karatsuba)
