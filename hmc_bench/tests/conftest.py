"""Shared pieces of the benchmark's tests: the repository root on the
path, few threads, and tiny CPU versions of the cells (the cells' own
files with a 6×6 lattice, 4 chains, one thermalization sweep and 3-sweep
anchor periods), whose every chain and period the check samples."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(2)


def tiny_cell(name: str, L: int = 6, chains: int = 4, K: int = 3):
    """The tiny version of the cell ``name`` of ``BENCHMARK.json``."""
    from hmc_bench import harness

    cell = harness.load_cell(name)
    config = dict(cell.config, Lx=L, Ly=L, n_chains=chains, n_therm=1,
                  Nt_therm_init=3)
    traffic = dict(cell.traffic)
    if traffic["anchor_every"] > 1:
        traffic["anchor_every"] = K
    limits = dict(cell.limits, sample={"chains": chains, "periods": 8})
    return cell._replace(config=config, traffic=traffic, limits=limits)


@pytest.fixture
def tiny():
    return tiny_cell
