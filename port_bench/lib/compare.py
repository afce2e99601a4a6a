"""The numbers that decide ``correct``, each against the plain reference.

Serving (``serve_numbers``), over the window's sampled calls:

* ``decode_flips``: ordinal-decode pixels that differ from the
  reference's, not counting pixels where one of the reference's ordinal
  pairs lies within ``NEAR`` of flipping (its raw B within 4e-4 of
  max(raw A, the clamp's floor 1e-8): there the logits' last bits decide
  the count either way; ``near_flips`` counts those).
* ``map_gap``: the widest relative L2 gap of an image's fused 128x128 log
  map, over the images whose decode agrees everywhere (a decode that
  differs by one count moves the whole map, and is ``decode_flips``' to
  judge).  A non-finite value where the reference is finite reads inf, and
  so does a sample with no image to judge.
* ``map_left_out``: the share of the sampled images that ``map_gap``
  leaves out, so that near flips cannot take the map out of the check.

Training.  Set-up drives the program through three steps: the first
eager, the second captured (and replayed), the third replayed.  Each
per-leaf gap is the gap between the two sides' norms of a leaf, over the
larger of the reference leaf's norm and the median leaf's, and the number
is the widest such gap.  ``train_numbers``, against the reference's three
steps from the same seeded state:

* ``loss_gap``: the widest relative gap of a logged loss term;
  ``first_loss_gap`` the same over the first step alone.
* ``grad_gap``: the first step's gradient, as the optimizer got it:
  AdamW's first moment after one step, over 1 - beta1.
* ``change_gap``: each leaf's change over the three steps, leaving out
  leaves whose reference gradient is under a thousandth of the median
  leaf's (rounding noise, which Adam turns into full-size steps);
  ``median_change_gap`` the median leaf's gap.
* ``bn_change_gap``: each BatchNorm running mean's and running
  variance's change over the three steps.

The later steps' gradients are not compared with the reference's three:
one step of Adam (lr times the sign of each gradient) and the ordinal
decodes near a flip make the two trajectories' second and third
gradients differ by a tenth or more.  ``replay_numbers`` compares the
third step, a replay, with the reference's step from the program's own
state before it (its parameters, BatchNorm statistics and moments):

* ``replay_loss_gap``: its logged loss terms;
* ``replay_grad_gap``: its gradient, (m_3 - beta1 m_2) / (1 - beta1);
* ``replay_change_gap``: each leaf's change in the step;
* ``replay_moment2_gap``: each leaf's second-moment increment,
  v_3 - beta2 v_2.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

NEAR = 4e-4
TINY_GRAD = 1e-3


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    got, want = got.astype(np.float64), want.astype(np.float64)
    if not np.isfinite(got).all() and np.isfinite(want).all():
        return float("inf")
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def serve_numbers(maps: Sequence[np.ndarray], decodes: Sequence[np.ndarray],
                  ref_maps: Sequence[np.ndarray],
                  ref_decodes: Sequence[np.ndarray],
                  ref_margins: Sequence[np.ndarray]) -> Dict[str, float]:
    """Per-image arrays: maps (1, 128, 128), decodes (1, 8, 8), margins
    (ordinal pairs, 8, 8)."""
    flips, near_flips, gaps = 0, 0, []
    for m, d, rm, rd, rg in zip(maps, decodes, ref_maps, ref_decodes,
                                ref_margins):
        near = (rg < NEAR).any(axis=0, keepdims=True)
        differ = d != rd
        flips += int((differ & ~near).sum())
        near_flips += int((differ & near).sum())
        if not differ.any():
            gaps.append(_rel(m, rm))
    images = len(maps)
    return {"decode_flips": float(flips),
            "map_gap": max(gaps) if gaps else float("inf"),
            "map_left_out": (images - len(gaps)) / max(images, 1),
            "near_flips": float(near_flips),
            "images_in_map_gap": float(len(gaps))}


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keys: Sequence[str], median: bool = False) -> float:
    """The widest (or, with ``median``, the median leaf's) |got - want|
    over max(want, the median of want)."""
    med = float(np.median([want[k] for k in want]))
    gaps = []
    for k in keys:
        g = got.get(k, 0.0)
        if not np.isfinite(g):
            return float("inf")
        gaps.append(abs(g - want[k]) / max(want[k], med, 1e-30))
    return float(np.median(gaps) if median else max(gaps))


def _loss_gap(steps) -> float:
    worst = 0.0
    for got, want in steps:
        for k, w in want.items():
            g = got[k]
            worst = (float("inf") if not np.isfinite(g) else
                     max(worst, abs(g - w) / max(abs(w), 1e-30)))
    return worst


def train_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """``got`` and ``want``, the program's and the reference's readings:
    ``losses`` (a dict of logged terms per step), ``grads`` (per step, a
    norm per leaf), ``changes`` (a norm per leaf) and ``bn_changes`` (a
    norm per BatchNorm statistic)."""
    ref_grads = want["grads"][0]
    med = float(np.median(list(ref_grads.values())))
    moving = [k for k in want["changes"] if ref_grads[k] >= TINY_GRAD * med]
    pairs = list(zip(got["losses"], want["losses"]))
    return {"loss_gap": _loss_gap(pairs),
            "first_loss_gap": _loss_gap(pairs[:1]),
            "grad_gap": leaf_gap(got["grads"][0], ref_grads, list(ref_grads)),
            "change_gap": leaf_gap(got["changes"], want["changes"], moving),
            "median_change_gap": leaf_gap(got["changes"], want["changes"],
                                          moving, median=True),
            "bn_change_gap": leaf_gap(got["bn_changes"], want["bn_changes"],
                                      list(want["bn_changes"])),
            "leaves_in_change_gap": float(len(moving))}


def replay_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """One step from the same state: ``losses`` (one dict of logged
    terms), ``grads``, ``changes`` and ``moment2`` (a norm per leaf)."""
    out = {"replay_loss_gap": _loss_gap(zip(got["losses"], want["losses"]))}
    for key in ("grads", "changes", "moment2"):
        name = {"grads": "grad", "changes": "change"}.get(key, key)
        out[f"replay_{name}_gap"] = leaf_gap(got[key], want[key],
                                             list(want[key]))
    return out
