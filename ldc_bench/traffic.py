"""The one generator of the benchmark's jobs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) holds:

- ``kind``: ``"solve"`` (one solver's ``solve()`` a job) or ``"round"``
  (the lanes of a job solved together by ``parallel.batched.run_batched``);
- ``N``: the order or cells per side of every lane;
- ``params``: solver parameters that override the configuration's;
- ``lanes``: one dict of parameter overrides per lane of a job;
- ``perturb`` (optional): ``{"key": name, "ulps": k}``: each lane's value
  of ``name`` moves by a whole number of float32 spacings in [-k, k],
  drawn from the seed, so that every job is a distinct solve of the same
  deployment at the size of float32 rounding;
- ``permute`` (optional): the lanes of each job in an order drawn from the
  seed;
- ``trace_steps``: the cap on every level of the job that a ``--trace 1``
  run traces whole (a whole number of chunks at each level, so that it
  runs the timed jobs' chunk runners and no other).

Job ``k`` of seed ``s`` is the same for every run: the draws come from
``SeedSequence([s mod 2^64, k])``.
"""

from __future__ import annotations

import numpy as np


def lane_params(config: dict, traffic: dict) -> list:
    """The parameters of each lane before any draw."""
    n = int(traffic["N"])
    base = dict(config["params"], **traffic.get("params", {}), nx=n, ny=n)
    return [dict(base, **lane) for lane in traffic["lanes"]]


def job(config: dict, traffic: dict, seed: int, k: int) -> list:
    """The lanes of job ``k`` under ``seed``: a list of parameter dicts."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, int(k)]))
    lanes = lane_params(config, traffic)
    pert = traffic.get("perturb")
    for lane in lanes:
        if pert:
            key, ulps = pert["key"], int(pert["ulps"])
            value = np.float32(lane[key])
            step = int(rng.integers(-ulps, ulps + 1))
            lane[key] = float(value + np.float32(step) * np.spacing(value))
    if traffic.get("permute"):
        lanes = [lanes[i] for i in rng.permutation(len(lanes))]
    return lanes
