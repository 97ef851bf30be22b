"""dwavehmc_tpu_torch — PyTorch/CUDA port of dwavehmc_tpu for NVIDIA Hopper.

Same physics and the same module layout as the JAX package
(``models/``, ``ops/``, ``sampler/``, ``parallel/``, ``utils/``), in
PyTorch's idiom: plain functions on tensors with an explicit leading chain
dimension in place of ``vmap``, Python loops in place of
``lax.scan``/``fori_loop``, and an explicit ``device``.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises.

The TPU's two Pallas kernels are hand-written CUDA C++ kernels for sm_90a
(``csrc/``, bound in ``ops/kernels.py``).  A CUDA tensor goes to the kernel;
a CPU tensor goes to the kernel's plain PyTorch version.

Precision: float32 matmuls run in full IEEE float32.  TF32 is switched off
here for matmuls and cuDNN alike, so both JAX ``precision=None`` and
``"highest"`` map to IEEE fp32 products.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
