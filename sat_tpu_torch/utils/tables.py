"""Parameter-count tables (reference utils.py:109-119), without the
prettytable dependency: the ASCII table of sat_tpu/utils/tables.py, with
the same two columns."""

from __future__ import annotations

import numpy as np


def _render_table(rows, headers):
    widths = [max(len(str(r[i])) for r in rows + [headers])
              for i in range(len(headers))]

    def line(ch="-", joint="+"):
        return joint + joint.join(ch * (w + 2) for w in widths) + joint

    def fmt(row):
        return "| " + " | ".join(str(c).ljust(w)
                                 for c, w in zip(row, widths)) + " |"

    return "\n".join([line(), fmt(headers), line()]
                     + [fmt(r) for r in rows] + [line()])


def count_parameters(params: dict, trainable_filter=None,
                     print_fn=print) -> int:
    """Print a table of the parameters and the trainable total; return the
    total.

    `params` maps sat_tpu's flat names (`/`-joined, as in its `.npz`
    archives) to arrays or tensors. The rows come in the order of
    sat_tpu's tree, its names' parts sorted, and are named with `.` as
    sat_tpu names them; `trainable_filter(name) -> bool` leaves out frozen
    parameters (the reference skips those without requires_grad,
    utils.py:113)."""
    rows, total = [], 0
    for key in sorted(params, key=lambda k: k.split("/")):
        name = key.replace("/", ".")
        if trainable_filter is not None and not trainable_filter(name):
            continue
        n = int(np.prod(tuple(params[key].shape)))
        rows.append((name, n))
        total += n
    print_fn(_render_table(rows, ("Modules", "Parameters")))
    print_fn(f"Total Trainable Params: {total}")
    return total
