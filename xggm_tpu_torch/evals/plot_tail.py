"""Tail-size accuracy plot (a copy of `xggm_tpu/evals/plot_tail.py`): a
log-x line plot of accuracy against 1 + alpha, saved as a PDF. matplotlib
is imported when a plot is drawn, so only `cli.evaluate gqa-tail --plot`
needs it.
"""
from __future__ import annotations

from typing import Sequence


def plot_tail(alpha: Sequence[float], accuracy: Sequence[float],
              model_name: str = "default", out_path: str = None) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_path = out_path or f"tail_plot_{model_name}.pdf"
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(alpha, accuracy, marker="o", label=model_name)
    ax.set_xscale("log")
    ax.set_xlabel("1 + alpha (tail size threshold)")
    ax.set_ylabel("Accuracy (%)")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
