"""Frozen work model of a FAS V-cycle (``models/spectral_vmg.make_v_cycle``
of the program), in the terms of ``work.py``, which it uses unchanged.

A V-cycle over a ladder of orders, fine to coarse, does:

- the smoothing sweeps: NU1 + NU2 RK4 steps in two sweeps at every order
  above the coarsest, NU_COARSE steps in one sweep at the coarsest; each
  sweep is ``work.steps_work`` with one quadrature pass (a sweep returns
  the metrics of its last step) and moves its own state, forcing and
  operators;
- at each pair of orders (fine n, coarse nc): the fine defect and the
  coarse defect, each the products of one RK stage (``work.sg_work``); the
  state injection, the defect restriction and the prolongation, each a
  sandwich A X A^T of the two velocity fields on the full grids and of
  the pressure on the inner grids.

Elementwise work (the masks, the BCs, tau's sums, the finite check) is
left out, which only lowers a bound.
"""

from __future__ import annotations

from . import work

# the smoothing steps of the published scheme (the program's VMGSolver)
NU1, NU2, NU_COARSE = 2, 2, 30


def sandwich(a: int, b: int) -> int:
    """Operations of A X A^T with A (a x b) or (b x a) and X square: two
    products of 2 a b^2 and 2 a^2 b operations (the order is immaterial)."""
    return 2 * a * b * b + 2 * a * a * b


def sweeps_work(nf: int, dtype: str, steps: int, sweeps: int):
    """(operations, bytes) of ``steps`` smoothing steps at ``nf`` points a
    side, over ``sweeps`` sweeps: a quadrature pass and the sweep's own
    inputs and outputs each sweep."""
    flops, nbytes = work.steps_work(nf, dtype, steps, sweeps)
    return flops, sweeps * nbytes


def transfer_work(nf: int, nc: int, dtype: str):
    """(operations, bytes) of one cycle's pass between ``nf`` and ``nc``
    points a side: the two defects and the three transfers of (u, v, p).
    Bytes: the operators of the two defects, the six transfer matrices,
    the fine state read and its correction written, the coarse state, its
    forcing and the coarse result."""
    e = work.ITEM_BYTES[dtype]
    ni, nci = nf - 2, nc - 2
    stage = lambda n: work.sg_work(n, dtype)["stage"][0]  # noqa: E731
    flops = stage(nf) + stage(nc) + 3 * (2 * sandwich(nc, nf)
                                         + sandwich(nci, ni))
    ops_bytes = e * (8 * (nf * nf + nc * nc) + 4 * (nf * ni + nc * nci))
    moved = e * (3 * (nf * nc + ni * nci) + 2 * (2 * nf * nf + ni * ni)
                 + 3 * (2 * nc * nc + nci * nci))
    return flops, ops_bytes + moved


def vcycle_work(steps: dict, cycles: int, dtype: str):
    """(operations, bytes) of ``cycles`` V-cycles whose smoothing steps, by
    order N, are ``steps`` (the program's smoother counter, or NU1 + NU2
    and NU_COARSE a cycle)."""
    orders = sorted(steps, reverse=True)
    flops = nbytes = 0
    for i, n in enumerate(orders):
        coarsest = i == len(orders) - 1
        f, b = sweeps_work(n + 1, dtype, steps[n],
                           cycles * (1 if coarsest else 2))
        flops, nbytes = flops + f, nbytes + b
        if not coarsest:
            f, b = transfer_work(n + 1, orders[i + 1] + 1, dtype)
            flops, nbytes = flops + cycles * f, nbytes + cycles * b
    return flops, nbytes


def vcycle_bound(steps: dict, cycles: int, dtype: str):
    """(seconds, what bounds it) of :func:`vcycle_work`."""
    return work.bound(*vcycle_work(steps, cycles, dtype), dtype)
