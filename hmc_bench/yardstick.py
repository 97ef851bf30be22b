"""The yardstick the per-layer metrics divide by: the model FLOPs of a
tracked segment, the H100's data-sheet peaks, and the least bytes or
operations of the port's kernels.

Frozen copies, so that a later change to the program cannot move them:
``tracked_model_flops`` is ``dwavehmc_tpu_torch/utils/flops.py``'s (a
stated convention that counts only the (2N)³ rotation products), and the
kernel bounds are those of the port's kernel table: 16n² + 4n bytes a
chain for K1 (the two n×n float32 inputs and outputs and the n-vector),
and the two float32 n×n parts of S read once and σ written once for K5.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at its 700 W limit
BF16_DENSE_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def tracked_model_flops(L: int, Nt: int, batch: int, n_sweeps: int,
                        tracked_iters: int, anchor_every: int,
                        refine_iters: int, polish_iters: int = 0,
                        ns_steps: int = 2, scheme: str = "ns") -> float:
    """Model FLOPs of the tracked-rotation products of one segment of
    ``n_sweeps`` sweeps: per tracked step, project 6 + apply (3 for "ns",
    6 for "exp2") + 6·``ns_steps`` Newton–Schulz products of 2n³ flops
    (n = 2L²); the cheap sweeps' endpoint refine (6 + apply + 12) and
    polish (8 + 8 or 4 + 16) on top."""
    n = 2 * L * L
    mm = 2.0 * n**3
    apply_fast = 6 if scheme == "exp2" else 3
    per_step = (6 + apply_fast + 6 * ns_steps) * mm * tracked_iters
    refine_per = 6 + apply_fast + 12
    polish_per = 8 + (8 if scheme == "exp2" else 4) + 16
    cheap_extra = (refine_per * refine_iters + polish_per * polish_iters) * mm
    n_anchor = n_sweeps // anchor_every if anchor_every > 1 else n_sweeps
    n_cheap = n_sweeps - n_anchor
    return batch * (n_sweeps * Nt * per_step + n_cheap * cheap_extra)


def k1_seconds(chains: int, n: int) -> float:
    """K1 at (chains, n, n) float32: its bytes over HBM bandwidth."""
    return chains * (16 * n * n + 4 * n) / HBM_BYTES_PER_S


def k5_seconds(chains: int, n: int) -> float:
    """K5 at (chains, n, n) float32: S's two parts read once, σ written
    once."""
    return chains * (8 * n * n + 4) / HBM_BYTES_PER_S
