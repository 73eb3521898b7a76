"""Hyper-parameter optimization: a compact TPE-style ask/tell sampler.

The port's own copy of ``anap3_tpu/utils/optimize.py`` (standard library
only): for the same space, seed and tells it asks the same parameters. It
drives the corner-smoothing study of ``conf/experiment/optimization/
corner_smoothing.yaml``. Continuous parameters come from ``interval(lo,
hi)`` config values, categorical ones from comma lists. The sampler is a
faithful-in-spirit Tree-structured Parzen Estimator:

- ``n_startup_trials`` quasi-random startup (scrambled Halton-like stratified
  samples);
- afterwards, observations are split into good/bad by the gamma quantile;
  candidates are drawn from a Gaussian KDE over the good set and scored by
  the density ratio l(x)/g(x); categorical dimensions use smoothed frequency
  ratios.

Deterministic given ``seed``. No external dependency.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

__all__ = ["TPESampler"]


class TPESampler:
    def __init__(self, space: Dict[str, object], n_startup_trials: int = 5,
                 gamma: float = 0.25, n_candidates: int = 24, seed: int = 0,
                 direction: str = "minimize"):
        """``space``: name -> Interval (continuous) or list (categorical)."""
        self.space = space
        self.n_startup = int(n_startup_trials)
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self.direction = direction
        self.trials: List[Tuple[dict, float]] = []

    # -- public API ------------------------------------------------------

    def ask(self) -> dict:
        if len(self.trials) < self.n_startup:
            return self._stratified_sample(len(self.trials))
        return self._tpe_sample()

    def ask_batch(self, k: int) -> List[dict]:
        """K candidates for one vmapped trial batch (ask-and-tell form).

        Startup samples stay stratified across the batch (each candidate
        takes the next startup bin); TPE-phase candidates are independent
        draws from the current good/bad split.
        """
        n0 = len(self.trials)
        out = []
        for i in range(int(k)):
            if n0 + i < self.n_startup:
                out.append(self._stratified_sample(n0 + i))
            else:
                out.append(self._tpe_sample())
        return out

    def tell(self, params: dict, value: float) -> None:
        if value is None or not math.isfinite(value):
            value = float("inf") if self.direction == "minimize" else float("-inf")
        self.trials.append((dict(params), float(value)))

    @property
    def best(self) -> Tuple[dict, float]:
        key = (min if self.direction == "minimize" else max)
        return key(self.trials, key=lambda t: t[1])

    # -- sampling --------------------------------------------------------

    def _stratified_sample(self, idx: int) -> dict:
        out = {}
        for name, spec in self.space.items():
            if isinstance(spec, list):
                out[name] = spec[idx % len(spec)]
            else:
                # stratified startup: bin center + jitter
                frac = (idx + self.rng.random()) / max(self.n_startup, 1)
                out[name] = spec.lo + frac * (spec.hi - spec.lo)
        return out

    def _split(self):
        finite = [t for t in self.trials if math.isfinite(t[1])]
        if not finite:
            return [], [t for t in self.trials]
        reverse = self.direction != "minimize"
        ordered = sorted(self.trials, key=lambda t: t[1], reverse=reverse)
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        return ordered[:n_good], ordered[n_good:]

    def _tpe_sample(self) -> dict:
        good, bad = self._split()
        out = {}
        for name, spec in self.space.items():
            if isinstance(spec, list):
                out[name] = self._categorical(name, spec, good, bad)
            else:
                out[name] = self._continuous(name, spec, good, bad)
        return out

    def _continuous(self, name, spec, good, bad) -> float:
        lo, hi = spec.lo, spec.hi
        good_x = [t[0][name] for t in good if name in t[0]]
        bad_x = [t[0][name] for t in bad if name in t[0]]
        if not good_x:
            return lo + self.rng.random() * (hi - lo)
        width = (hi - lo) / max(len(good_x), 1) + 1e-12

        def kde(x, pts):
            return sum(
                math.exp(-0.5 * ((x - p) / width) ** 2) for p in pts
            ) / (len(pts) * width) + 1e-12

        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            center = self.rng.choice(good_x)
            x = min(hi, max(lo, self.rng.gauss(center, width)))
            score = math.log(kde(x, good_x))
            if bad_x:
                score -= math.log(kde(x, bad_x))
            if score > best_score:
                best_x, best_score = x, score
        return best_x

    def _categorical(self, name, choices, good, bad):
        def weights(trials):
            counts = {c: 1.0 for c in choices}  # add-one smoothing
            for t in trials:
                v = t[0].get(name)
                if v in counts:
                    counts[v] += 1.0
            total = sum(counts.values())
            return {c: counts[c] / total for c in choices}

        wg = weights(good)
        wb = weights(bad) if bad else {c: 1.0 / len(choices) for c in choices}
        scores = {c: wg[c] / wb[c] for c in choices}
        total = sum(scores.values())
        r = self.rng.random() * total
        acc = 0.0
        for c in choices:
            acc += scores[c]
            if r <= acc:
                return c
        return choices[-1]
