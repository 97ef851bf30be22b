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
K4     ``chain_matvec``            ``csrc/chain_sum.cu``; the σ-cap's complex
                                   matrix-vector product in a fixed order (no
                                   TPU kernel: XLA's ``matmul``)
=====  ==========================  ==========================================

K3 and K4 exist so that a chain's sweep gives the same bits whatever batch
it runs in (ROADMAP fault F6): PyTorch's CUDA reduction and cuBLAS's
batched matrix-vector product pick their order of addition by the batch's
size.  Both add in one halving tree (``csrc/chain_sum.cu``), and their plain
versions run the same tree, so kernel and plain version agree to the bit.

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

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rotation_s.cu", "lorentzian.cu", "chain_sum.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches since the last ``reset_launches()``, by kernel name
LAUNCHES = {"rotation_s_parts": 0, "weighted_lorentzian_sum": 0,
            "chain_sum": 0, "chain_matvec": 0}

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
    for src in SOURCES:
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
    for name in ("dwh_chain_matvec_f32", "dwh_chain_matvec_f64"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, i, i, p]
        getattr(lib, name).restype = i
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


# --- K3, K4: per-chain sums in a fixed order --------------------------------

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
    """The C entry's dtype suffix; K3 and K4 take float32 and float64."""
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
    """Plain PyTorch K4: w = (ar + i·ai)(vr + i·vi) for ar/ai (B, n, n) and
    vr/vi (B, n), each of ar·vr, ai·vi, ar·vi, ai·vr its own halving tree:
    (ar·vr − ai·vi, ar·vi + ai·vr), each (B, n)."""
    r, i = vr[:, None, :], vi[:, None, :]
    return (chain_sum_plain(ar * r) - chain_sum_plain(ai * i),
            chain_sum_plain(ar * i) + chain_sum_plain(ai * r))


def chain_matvec_cuda(ar, ai, vr, vi):
    """Launch K4 on float32 or float64 CUDA tensors ar/ai (B, n, n), vr/vi
    (B, n), any n."""
    B, n = vr.shape
    dev, dt = vr.device, vr.dtype
    suffix = _suffix(dt)
    for name, t, shape in (("ar", ar, (B, n, n)), ("ai", ai, (B, n, n)),
                           ("vr", vr, (B, n)), ("vi", vi, (B, n))):
        _check(name, t, shape, dev, dt)
    wr = torch.empty_like(vr)
    wi = torch.empty_like(vi)
    if B == 0 or n == 0:
        return wr, wi
    err = getattr(_library(), f"dwh_chain_matvec_{suffix}")(
        ar.data_ptr(), ai.data_ptr(), vr.data_ptr(), vi.data_ptr(),
        wr.data_ptr(), wi.data_ptr(), B, n, _stream(dev))
    _raise_on(err, "chain_matvec")
    LAUNCHES["chain_matvec"] += 1
    return wr, wi


def chain_matvec(ar, ai, vr, vi):
    """K4 dispatch: the complex product (ar + i·ai)(vr + i·vi) per chain, in
    one order whatever the batch.  CPU tensors → plain version; CUDA
    tensors → the kernel in their dtype (float32 or float64)."""
    if vr.device.type == "cpu":
        return chain_matvec_plain(ar, ai, vr, vi)
    c = lambda x: x.contiguous()  # noqa: E731
    return chain_matvec_cuda(c(ar), c(ai), c(vr), c(vi))
