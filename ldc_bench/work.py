"""Frozen work models: the operations and bytes the solvers' work needs,
counted from the shapes, and the least time one H100 could take for it.

Copied from ``chip_smoke.py`` (``bound``, ``sg_work``, ``steps_bound``,
``fv_work`` and the data-sheet peaks) and kept here, apart from the
program, so that a change of the program cannot change the yardstick. A
product of (m x k) by (k x n) is 2mkn operations; elementwise work is left
out, which only lowers a bound.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# float32 outside the tensor cores, float64 on its FP64 tensor cores, and
# HBM bytes/s
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
ITEM_BYTES = {"float32": 4, "float64": 8}
# the quadrature cadence of the reported history (one pass every 16 steps)
QUAD_EVERY = 16
# the fixed BiCGSTAB iterations of one FV-SIMPLE momentum solve
FV_K = 16


def bound(flops: float, nbytes: float, dtype: str):
    """(seconds, what bounds it): the least time the card could take for
    work that does ``flops`` operations in ``dtype`` and must move
    ``nbytes`` (each input read once, each output written once)."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def sg_work(nf: int, dtype: str) -> dict:
    """(operations, bytes) of one SG RK stage and one quadrature pass at
    order nf - 1, one lane.

    - stage: the 8 full-grid products of the residuals (Dx, Dxx from the
      left and DyT, DyyT from the right on u and v) and the two
      pressure-gradient chains Gx p IyT, Ix p GyT; it reads the stage and
      base states, 8 operators and the BCs, writes a state;
    - dt: reads u and v;
    - quad: omega = Dx v - u DyT, then Dx omega and omega DyT; reads u, v,
      Dx, DyT and the weights.
    """
    ni, e = nf - 2, ITEM_BYTES[dtype]
    full, inner = nf * nf, ni * ni
    return {
        "stage": (16 * nf ** 3 + 4 * nf * ni * ni + 4 * nf * nf * ni,
                  e * (12 * full + 3 * inner + 4 * nf * ni)),
        "dt": (0, e * 2 * full),
        "quad": (8 * nf ** 3, e * 5 * full),
    }


def steps_work(nf: int, dtype: str, n_steps: int, n_quad: int):
    """(operations, bytes) of ``n_steps`` RK4 steps (four stages each) with
    ``n_quad`` quadrature passes, the input state, forcing and operators
    read once and the output state written once."""
    ni, e = nf - 2, ITEM_BYTES[dtype]
    work = sg_work(nf, dtype)
    flops = 4 * n_steps * work["stage"][0] + n_quad * work["quad"][0]
    return flops, e * (13 * nf * nf + 3 * ni * ni + 4 * nf * ni)


def steps_bound(nf: int, dtype: str, n_steps: int, n_quad: int):
    """The bound of :func:`steps_work`: (seconds, what bounds it)."""
    return bound(*steps_work(nf, dtype, n_steps, n_quad), dtype)


def fv_work(ny: int, nx: int, dtype: str, n_refine: int) -> dict:
    """(operations, bytes) of one SIMPLE iteration at ny x nx cells (c of
    them), by its two halves; arithmetic not counted only lowers the bound.

    - momentum: the assembly (~60 operations a cell), then FV_K BiCGSTAB
      iterations on the two momentum systems, each two 5-point
      applications with the Jacobi scaling (11 operations a cell), four
      dots and six axpys (2 each): 40 operations a cell a system an
      iteration. It reads the state (u, v, p and the two face fluxes) and
      the boundary statics (7 c) and writes the five coefficient arrays,
      the pressure gradient, Du and the two solutions (10 c);
    - pressure: 4 (1 + n_refine) products of the separable pressure solve,
      2 ny^2 nx or 2 ny nx^2 each, ~80 operations a cell for Rhie-Chow,
      the refinement residual, the corrections and the metrics, and ~4 for
      the control's norms; it reads the two eigenvector bases and the
      eigenvalue inverses, the momentum solution, Du, the pressure
      gradient, p, u and v (ny^2 + nx^2 + 9 c) and writes the new state
      (5 c) and a history row.
    """
    c, e = ny * nx, ITEM_BYTES[dtype]
    solves = 1 + int(n_refine)
    return {
        "momentum": (60 * c + FV_K * 2 * 40 * c, e * 17 * c),
        "pressure": (solves * (4 * ny * ny * nx + 4 * ny * nx * nx)
                     + 84 * c, e * (ny * ny + nx * nx + 14 * c + 7)),
    }


def fv_iterations_bound(ny: int, nx: int, dtype: str, n_refine: int,
                        iterations: int):
    """(seconds, what bounds it) of ``iterations`` SIMPLE iterations, each
    moving its own inputs and outputs."""
    halves = fv_work(ny, nx, dtype, n_refine).values()
    flops = iterations * sum(f for f, _ in halves)
    nbytes = iterations * sum(b for _, b in halves)
    return bound(flops, nbytes, dtype)
