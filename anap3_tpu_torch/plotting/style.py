"""Shared plot styling (reference style.py:15-29, minus LaTeX).

The port's own copy of ``anap3_tpu/plotting/style.py``. There, importing
the module applies the style; here ``pyplot()`` applies it on the first
plot and returns ``matplotlib.pyplot``, so that every module of the
package imports without matplotlib or seaborn. Math text is rendered with
matplotlib's built-in mathtext instead of an external LaTeX toolchain.
"""

_STYLED = []


def pyplot():
    """``matplotlib.pyplot`` (Agg backend) with the shared style."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import seaborn as sns

    if not _STYLED:
        sns.set_theme(style="darkgrid", context="paper", font_scale=1.2)
        plt.rcParams.update({
            "text.usetex": False,
            "mathtext.fontset": "cm",
            "figure.dpi": 110,
            "savefig.bbox": "tight",
        })
        _STYLED.append(True)
    return plt
