"""A run with the timed path broken underneath comes out not correct.

Each cell's tiny CPU version (every chain and period compared, the
cell's own limits) runs once sound, which must pass, and once with each
fault a cell on one chip can have planted in ``seg_fn``: a step that
returns its state unchanged, half of the batch left out with the mean of
the rest in its place, and one answer (an accept decision) altered where
it is produced.  A cell on one chip has no exchange between chips to
leave out.  The look for a chip is ``hmc_bench.run``'s and is skipped."""

import pytest
import torch

from hmc_bench import check, harness

SEED = 2**31 + 11


def unchanged(seg_fn):
    def step(p, s, n, *a, **k):
        return s, seg_fn(p, s, n, *a, **k)[1]
    return step


def half_batch(seg_fn):
    def step(p, s, n, *a, normals, uniforms, **k):
        h = s.delta_re.shape[0] // 2
        s1, res = seg_fn(p, type(s)(*(x[:h] for x in s)), n, *a,
                         normals=normals[:, :h], uniforms=uniforms[:, :h],
                         **k)

        def fill(x):        # the left-out rows take the mean of the rest
            m = x.float().mean(1, keepdim=True)
            m = (m > 0.5) if x.dtype == torch.bool else m.to(x.dtype)
            return torch.cat([x, m.expand(-1, s.delta_re.shape[0] - h)], 1)

        return (type(s)(*(torch.cat([a, b[h:]]) for a, b in zip(s1, s))),
                res._replace(accepted=fill(res.accepted), dH=fill(res.dH)))
    return step


def altered(seg_fn):
    def step(p, s, n, *a, **k):
        s1, res = seg_fn(p, s, n, *a, **k)
        acc = res.accepted.clone()
        acc[-1, 0] = ~acc[-1, 0]
        return s1, res._replace(accepted=acc)
    return step


CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, unchanged, half_batch, altered])
def test_fault_comes_out_not_correct(tiny, cell, fault):
    c = tiny(cell)
    run = harness.run_cell(c, SEED, 0.5, False, "cpu", wrap_seg=fault)
    ok, table = check.judge(check.readings(c, run, SEED, "cpu"),
                            c.limits["limits"])
    assert ok is (fault is None), table
