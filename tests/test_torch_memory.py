"""Port parity of the memory estimate (``dwavehmc_tpu_torch/utils/memory.py``
against ``dwavehmc_tpu/utils/memory.py``): the same byte formula, so the
same estimate for the same lattice, chain count and dtype."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from dwavehmc_tpu.models.lattice import LatticeSpec as JLattice
from dwavehmc_tpu.utils import memory as jmem
from dwavehmc_tpu_torch.models.lattice import LatticeSpec
from dwavehmc_tpu_torch.utils import memory as tmem


@pytest.mark.parametrize("L,n,dtypes,transport", [
    (24, 8, (torch.float32, jnp.float32), True),
    (12, 3, (torch.float64, jnp.float64), False),
    (6, 1, (torch.float32, jnp.float32), False)])
def test_estimate_equals_jax(L, n, dtypes, transport):
    t = tmem.estimate_memory(LatticeSpec(L, L), n, dtypes[0], transport)
    j = jmem.estimate_memory(JLattice(L, L), n, dtypes[1], transport)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert str(t) == str(j)
    hbm = 16 * 2**30
    assert t.fits(hbm) == j.fits(hbm)
    assert tmem.max_chains(LatticeSpec(L, L), dtypes[0], hbm,
                           with_transport=transport) == \
        jmem.max_chains(JLattice(L, L), dtypes[1], hbm,
                        with_transport=transport)


def test_capacity_defaults_to_the_card():
    """Without a card the default capacity cannot be read: it raises, it
    does not assume a size."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tmem.estimate_memory(LatticeSpec(4, 4), 1).fits()
