"""The port's two hand-written Hopper kernels, their bindings and their plain
PyTorch versions.

=====  ==========================  ==========================================
K1     ``rotation_s_parts``        ``csrc/rotation_s.cu``; replaces
                                   ``dwavehmc_tpu/ops/pallas_kernels.py::
                                   rotation_s_parts``
K2     ``weighted_lorentzian_sum`` ``csrc/lorentzian.cu``; replaces
                                   ``dwavehmc_tpu/ops/pallas_kernels.py::
                                   weighted_lorentzian_sum``
=====  ==========================  ==========================================

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use into one
shared library under ``build/kernels/`` beside the package (one ``nvcc -c``
per source, all started together, then one link) and loaded with ``ctypes``:
plain C entry points, pointers as ``c_void_p``, launched on PyTorch's current
stream.  Each C entry returns ``cudaGetLastError()``; a nonzero value raises.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises.  There is no fallback between the two.  Each
kernel launch adds one to ``LAUNCHES[name]``; nothing else touches the count.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("rotation_s.cu", "lorentzian.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches since the last ``reset_launches()``, by kernel name
LAUNCHES = {"rotation_s_parts": 0, "weighted_lorentzian_sum": 0}

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
    for src in SOURCES:
        obj = lib_path.with_name(f"{Path(src).stem}_{lib_path.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # wait for every compiler before judging any, so none is left running
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
    seconds = time.perf_counter() - t0
    _lib = _load(lib_path)
    return {"seconds": seconds, "library": str(lib_path), "ptxas": ptxas}


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dwh_rotation_s_parts.argtypes = [p, p, p, p, p, i, i, f, p]
    lib.dwh_rotation_s_parts.restype = i
    lib.dwh_weighted_lorentzian_sum.argtypes = [p, p, p, p, p, i, i, i, i, f,
                                                p]
    lib.dwh_weighted_lorentzian_sum.restype = i
    lib.dwh_lorentzian_chunk_size.argtypes = []
    lib.dwh_lorentzian_chunk_size.restype = i
    return lib


def _library():
    if _lib is None:
        build()
    return _lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device} (CUDA), "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
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
    tensors → the kernel in float32 (cast as the TPU wrapper casts)."""
    if tr.device.type == "cpu":
        return rotation_s_parts_plain(tr, ti, d, smax)
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    return rotation_s_parts_cuda(f32(tr), f32(ti), f32(d), smax)


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
    n_chunks = max(1, -(-M // lib.dwh_lorentzian_chunk_size()))
    partial = torch.empty((B, n_chunks, n_w), dtype=torch.float32,
                          device=dev)
    err = lib.dwh_weighted_lorentzian_sum(
        omega.data_ptr(), de.data_ptr(), w2.data_ptr(), partial.data_ptr(),
        out.data_ptr(), B, n_w, M, n_chunks, float(eta), _stream(dev))
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
