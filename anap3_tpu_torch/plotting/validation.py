"""Ghia centerline comparison and L2-convergence plots (reference
validation.py:25-441); the port's own copy of
``anap3_tpu/plotting/validation.py``.

Behavior carried over:
- centerlines extracted at the PHYSICAL center (x=0.5), not the middle index
  (critical on non-uniform Chebyshev grids; validation.py:301-306);
- spectral interpolation for spectral solvers, linear for FV
  (validation.py:311-322);
- method label map fv -> FV-TVD etc. (validation.py:189-208);
- L2 convergence log-log with O(N^-2)/O(N^-4) guide lines.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..ops.basis import spectral_interpolate
from .data_loading import load_fields_from_vts, restructure_fields
from .style import pyplot
from .tracking_utils import artifact_dir_for_run

log = logging.getLogger(__name__)

__all__ = ["plot_ghia_comparison", "plot_l2_convergence", "method_label"]

_LABELS = {
    "fv": "FV-TVD",
    "spectral": "Spectral",
    "spectral_fsg": "Spectral-FSG",
    "spectral_fmg": "Spectral-FMG",
}

AVAILABLE_GHIA_RE = (100, 400, 1000, 3200, 5000, 7500, 10000)


def method_label(sibling: dict) -> str:
    solver = sibling.get("solver", "unknown")
    return _LABELS.get(solver, solver.replace("_", "-").title())


def _ghia_dir(data_dir) -> Path:
    return Path(data_dir) / "validation" / "ghia"


def plot_ghia_comparison(siblings, tracking_uri, output_dir,
                         data_dir="data") -> Path | None:
    import pandas as pd

    finished = [s for s in siblings if s.get("status", "FINISHED") == "FINISHED"]
    if not finished:
        return None
    Re = finished[0]["Re"]
    if int(Re) not in AVAILABLE_GHIA_RE:
        log.warning("Ghia data not available for Re=%s", Re)
        return None
    gd = _ghia_dir(data_dir)
    ghia_u = pd.read_csv(gd / f"ghia_Re{int(Re)}_u_centerline.csv")
    ghia_v = pd.read_csv(gd / f"ghia_Re{int(Re)}_v_centerline.csv")

    seen = set()
    unique = []
    for s in finished:
        combo = (method_label(s), s["N"])
        if combo not in seen:
            seen.add(combo)
            unique.append(s)

    u_records, v_records = [], []
    for s in unique:
        try:
            fields = load_fields_from_vts(
                artifact_dir_for_run(s["run_id"], tracking_uri))
            x_u, y_u, U, V, _ = restructure_fields(fields)
        except Exception as exc:
            log.warning("Failed to load fields for %s: %s", s["run_id"][:8], exc)
            continue
        n_pts = 200
        y_line = np.linspace(y_u.min(), y_u.max(), n_pts)
        x_line = np.linspace(x_u.min(), x_u.max(), n_pts)
        # physical center, not middle index (non-uniform grids)
        xc = np.argmin(np.abs(x_u - 0.5 * (x_u.min() + x_u.max())))
        yc = np.argmin(np.abs(y_u - 0.5 * (y_u.min() + y_u.max())))
        if str(s.get("solver", "")).lower().startswith("fv"):
            u_sim = np.interp(y_line, y_u, U[:, xc])
            v_sim = np.interp(x_line, x_u, V[yc, :])
        else:
            u_sim = spectral_interpolate(y_u, U[:, xc], y_line, basis="legendre")
            v_sim = spectral_interpolate(x_u, V[yc, :], x_line, basis="legendre")
        label = f"{method_label(s)}, $N={s['N']}$"
        u_records += [{"y": y, "u": u, "Method": label}
                      for y, u in zip(y_line, u_sim)]
        v_records += [{"x": x, "v": v, "Method": label}
                      for x, v in zip(x_line, v_sim)]

    if not u_records:
        return None
    import seaborn as sns

    plt = pyplot()
    fig, (ax_u, ax_v) = plt.subplots(1, 2, figsize=(12, 5))
    sns.lineplot(data=pd.DataFrame(u_records), x="u", y="y", hue="Method",
                 ax=ax_u, linewidth=1.2)
    ax_u.scatter(ghia_u["u"], ghia_u["y"], marker="o", facecolors="none",
                 edgecolors="k", s=40, label="Ghia et al. (1982)", zorder=5)
    ax_u.set_title(f"$u$ along $x=0.5$, $Re={Re:g}$")
    ax_u.legend(fontsize=8)
    sns.lineplot(data=pd.DataFrame(v_records), x="x", y="v", hue="Method",
                 ax=ax_v, linewidth=1.2, legend=False)
    ax_v.scatter(ghia_v["x"], ghia_v["v"], marker="o", facecolors="none",
                 edgecolors="k", s=40, zorder=5)
    ax_v.set_title(f"$v$ along $y=0.5$, $Re={Re:g}$")
    out = Path(output_dir) / "ghia_comparison.pdf"
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_l2_convergence(siblings, tracking_uri, output_dir) -> list:
    import pandas as pd

    finished = [s for s in siblings if s.get("status", "FINISHED") == "FINISHED"]
    if len(finished) < 2:
        log.info("Need >= 2 finished runs for convergence plot")
        return []
    records = []
    for s in finished:
        m = s.get("metrics", {})
        if m.get("u_L2_error") is None and m.get("v_L2_error") is None:
            continue
        records.append({
            "N": s["N"], "Method": method_label(s),
            "u_L2_error": m.get("u_L2_error"),
            "v_L2_error": m.get("v_L2_error"),
            "u_L2_error_regu": m.get("u_L2_error_regu"),
            "v_L2_error_regu": m.get("v_L2_error_regu"),
        })
    if not records:
        log.warning("No L2 error metrics found in sibling runs")
        return []
    df = pd.DataFrame(records)
    plt = pyplot()

    configs = [
        ("u_L2_error", r"$u$ L2 Error", "l2_convergence_u.pdf"),
        ("v_L2_error", r"$v$ L2 Error", "l2_convergence_v.pdf"),
        ("u_L2_error_regu", r"$u$ L2 Error (regularized ref)",
         "l2_convergence_u_regu.pdf"),
        ("v_L2_error_regu", r"$v$ L2 Error (regularized ref)",
         "l2_convergence_v_regu.pdf"),
    ]
    outputs = []
    for col, ylabel, fname in configs:
        sub = df[df[col].notna()]
        if sub.empty or sub[col].le(0).all():
            continue
        fig, ax = plt.subplots(figsize=(6.5, 5))
        for method, grp in sub.groupby("Method"):
            grp = grp.sort_values("N")
            ax.loglog(grp["N"], grp[col], "o-", label=method)
        Ns = np.array(sorted(sub["N"].unique()), dtype=float)
        ref0 = sub[col].max()
        ax.loglog(Ns, ref0 * (Ns / Ns.min()) ** -2.0, "k--", alpha=0.5,
                  label=r"$O(N^{-2})$")
        ax.loglog(Ns, ref0 * (Ns / Ns.min()) ** -4.0, "k:", alpha=0.5,
                  label=r"$O(N^{-4})$")
        ax.set_xlabel("$N$")
        ax.set_ylabel(ylabel)
        ax.legend(fontsize=8)
        out = Path(output_dir) / fname
        fig.savefig(out)
        plt.close(fig)
        outputs.append(out)
    return outputs
