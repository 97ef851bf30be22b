"""Model FLOPs of the fast tracked configuration, and the H100 peaks the
measurement drivers divide them by (a copy of ``bench.tracked_model_flops``;
the port imports nothing of the JAX repository).

The peaks are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W power limit, dense (no sparsity): they are not measurements.  A
utilization computed against one of them names it (``BF16_PEAK``).
"""

from __future__ import annotations

#: H100 SXM dense BF16 tensor-core peak (data sheet), TFLOP/s: the
#: denominator of a model-FLOP utilization of the bf16-rotation segment
H100_BF16_DENSE_PEAK_TFLOPS = 989.0
#: H100 SXM FP32 peak outside the tensor cores (data sheet), TFLOP/s: the
#: rate of the float32 kernels' operations in a roofline bound
H100_FP32_PEAK_TFLOPS = 67.0
#: H100 SXM HBM3 bandwidth (data sheet), bytes/s
H100_HBM_BYTES_PER_S = 3.35e12
#: the peak a utilization is taken against, as its JSON names it
BF16_PEAK = {"name": "H100_BF16_DENSE_PEAK_TFLOPS",
             "tflops": H100_BF16_DENSE_PEAK_TFLOPS,
             "source": "NVIDIA H100 SXM data sheet, dense, 700 W"}


def tracked_model_flops(L: int, Nt: int, batch: int, n_sweeps: int,
                        tracked_iters: int, anchor_every: int,
                        refine_iters: int, polish_iters: int = 0,
                        ns_steps: int = 2, scheme: str = "ns") -> float:
    """Model FLOPs of the tracked-rotation matmul pipeline per segment
    (counts only the (2N)³ rotation matmuls — forces, eighs and
    elementwise work excluded, so the resulting utilization slightly
    understates the true one).

    Per tracked_step with the 3-mult complex algebra: project_T 6 +
    apply (U·S 3 for "ns"; S² + U·V = 6 for "exp2") + 6·ns_steps
    Newton–Schulz matmuls of 2n³ flops (n = 2L²), with ``ns_steps``
    applying to the in-trajectory rotations only — the endpoint refine
    phase always re-unitarizes at ns=2, and the polish runs 4-mult
    "highest" precision (8 project + 4/8 apply + 16 NS).
    """
    n = 2 * L * L
    mm = 2.0 * n**3
    apply_fast = 6 if scheme == "exp2" else 3
    per_iter = 6 + apply_fast + 6 * ns_steps
    per_step = per_iter * mm * tracked_iters
    refine_per = 6 + apply_fast + 12
    polish_per = 8 + (8 if scheme == "exp2" else 4) + 16
    cheap_extra = (refine_per * refine_iters
                   + polish_per * polish_iters) * mm
    n_anchor = (n_sweeps // anchor_every if anchor_every > 1 else n_sweeps)
    n_cheap = n_sweeps - n_anchor
    return batch * (n_sweeps * Nt * per_step + n_cheap * cheap_extra)
