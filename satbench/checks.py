"""The numbers that decide `correct`, each computed from the program's
outputs and the plain reference's, and held to the cell's limit
(satbench/workloads/<cell>.json). Every number is a gap: 0 is perfect
agreement, and a run is correct when no number exceeds its limit."""

from __future__ import annotations

import statistics

import torch


def caption(out: dict, grid, w: dict, beam: int, stop_ids, start: int,
            reference) -> dict:
    """A batch of beam captions against the reference, over the same
    images' grid as the reference encodes it:

      score_gap  the worst image: 1 where the program's found flag is not
                 the reference beam's (a caption where the reference
                 completes none, or none where it completes one), else
                 the relative gap between a found caption's score and the
                 reference's sum of logits along its tokens
      alpha_gap  the largest gap between a found caption's attention
                 weights and the reference's along its tokens

    and, not compared, `beam_mismatch`, the share of images whose caption
    is not the reference beam's own (a near tie can flip one in either
    precision), the found shares and the steps the reference ran.
    """
    ref_beam = reference.beam_search(w, grid, beam, stop_ids, start)
    found = out["found"].bool()
    flags = found != ref_beam["found"]
    T = out["tokens"].shape[1]
    cols = torch.arange(T, device=grid.device)
    upto = cols[None] <= out["length"][:, None]
    same = ((out["tokens"] == ref_beam["tokens"]) | ~upto).all(dim=1)
    differs = flags | (found & ~(same & (out["length"]
                                         == ref_beam["length"])))
    nums = {"score_gap": 1.0 if bool(flags.any()) else 0.0,
            "alpha_gap": 0.0,
            "beam_mismatch": float(differs.float().mean())}
    idx = found.nonzero()[:, 0]
    if len(idx):
        score, alphas = reference.replay(w, grid[idx], out["tokens"][idx],
                                         out["length"][idx])
        got = out["score"][idx]
        nums["score_gap"] = max(nums["score_gap"], float(
            ((got - score).abs() / score.abs().clamp_min(1e-30)).max()))
        nums["alpha_gap"] = float((out["alphas"][idx].float()
                                   - alphas).abs().max())
    nums["found_share"] = float(found.float().mean())
    nums["ref_found_share"] = float(ref_beam["found"].float().mean())
    nums["ref_steps"] = ref_beam["steps"]
    return nums


def worst(batches: list) -> dict:
    """The numbers of several batches: the largest gap, the mean share,
    the fewest steps."""
    out = {}
    for k in batches[0]:
        vals = [b[k] for b in batches]
        if k.endswith("share") or k == "beam_mismatch":
            out[k] = statistics.fmean(vals)
        else:
            out[k] = min(vals) if k == "ref_steps" else max(vals)
    return out


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _leaf_gaps(got: dict, want: dict, counted) -> dict:
    """Each counted leaf's |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's norm."""
    norms = {k: _norm(want[k]) for k in counted}
    floor = statistics.median(norms.values())
    return {k: abs(_norm(got[k]) - norms[k]) / max(norms[k], floor)
            for k in counted}


def training(losses, ref_losses, grads, ref_grads, deltas,
             ref_deltas) -> dict:
    """The first steps of training against the reference's:

      loss_gap    largest relative gap of a step's loss
      grad_gap    worst leaf's gap of the first gradient's norm
      update_gap  the median leaf's gap of the norm of the parameters'
                  change over the checked steps

    and, not compared, the worst leaf's update gap and the leaves that
    set the worst gaps. The worst leaf's update is not compared because
    its gap is the noise of one small gradient: Adam divides each element
    by its own magnitude, so a leaf whose gradient is small beside the
    rounding of the sums that make it (init_h's, through all the steps'
    recurrence) moves by steps of about lr whose sizes follow that
    rounding (PERF.md, Findings).

    Leaves whose reference gradient is nought to rounding (below a
    thousandth of the median leaf's norm, as the score bias's under the
    softmax) or missing (a head the configuration does not use) are not
    counted: Adam turns their rounding noise into steps of about lr."""
    present = {k: _norm(g) for k, g in ref_grads.items() if g is not None}
    floor = statistics.median(present.values())
    counted = [k for k, n in present.items() if n >= 1e-3 * floor]
    grad = _leaf_gaps(grads, ref_grads, counted)
    update = _leaf_gaps(deltas, ref_deltas, counted)
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": max(grad.values()),
            "update_gap": statistics.median(update.values()),
            "update_worst": max(update.values()),
            "grad_leaf": max(grad, key=grad.get),
            "update_leaf": max(update, key=update.get),
            "leaves_counted": len(counted),
            "update_by_leaf": update}
