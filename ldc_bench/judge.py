"""The comparison that decides ``correct``: each lane's answer, judged by
the plain reference of its configuration, against the cell's limits.

The numbers (each the worst over the run's lanes):

- spectral configurations: ``uv_step`` and ``p_step``, the relative change
  of (u, v) and of p that one step of the reference's march makes to the
  final state (``reference/spectral.py``); ``wall``, the largest distance
  of the wall values from the configuration's;
- FV configurations: ``mom``, the relative residual of the discrete
  momentum equations at the final state; ``flux``, the distance of its
  face fluxes from the Rhie-Chow fluxes of its (u, p); ``mass``, its
  continuity (``reference/fv.py``);
- both: ``l2_u`` and ``l2_v``, the relative L2 distances of the final
  (u, v) from the stored FV truth of the lane's Re, as the reference works
  them out; ``l2_gap``, the largest distance between the validation
  numbers the program reported and those the reference works out from
  the same state; ``unconverged``, the lanes the program did not report
  converged.

The configuration's ``reference`` names the module that works out its
numbers, ``reference/<name>.py`` (``spec.reference``). A cell's limits
file names the numbers that are compared.
"""

from __future__ import annotations

import math
from pathlib import Path

from . import spec
from .reference import validation as ref_val


def lane_numbers(root: Path, config: dict, lane, state=None,
                 reported=None) -> dict:
    """The judged numbers of one lane; ``state`` and ``reported`` stand in
    for the lane's own (the controls hand their answers in here)."""
    state = lane.state if state is None else state
    reported = lane.validation if reported is None else reported
    p = lane.params
    ref = spec.reference(config["reference"], root)
    nums = ref.lane_numbers(p, lane.n, state)
    worked = ref_val.l2_errors(root, p, ref.lane_evaluator(p, lane.n, state))
    nums["l2_u"] = worked.get("u_L2_error", float("nan"))
    nums["l2_v"] = worked.get("v_L2_error", float("nan"))
    nums["l2_gap"] = ref_val.gap(reported, worked)
    nums["unconverged"] = 0.0 if lane.converged else 1.0
    return nums


def over(nums: dict, limits: dict) -> bool:
    """True where a number lies beyond its limit (NaN included)."""
    return any(not (nums[k] <= lim) for k, lim in limits.items())


def verdict(per_lane: list, limits: dict):
    """(correct, failed lanes, checks): checks maps each limited number to
    {value: the worst over the lanes (the count for ``unconverged``),
    limit}."""
    checks = {}
    for key, lim in limits.items():
        vals = [n[key] for n in per_lane]
        if key == "unconverged":
            val = float(sum(vals))
        else:
            val = max(vals, key=lambda x: (math.isnan(x), x))
        checks[key] = {"value": val, "limit": lim}
    failed = sum(over(n, limits) for n in per_lane)
    correct = bool(per_lane) and failed == 0
    return correct, failed, checks
