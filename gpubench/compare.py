"""The numbers that decide ``correct``, each held against its limit.

Training: the relative gap of each first step's loss and the worst of
them; and, by
the worst leaf, the gap between the program's norm and the reference's
of the first gradient (as the optimizer got it) and of the weights'
change after the first steps, each measured against the reference's
norm of that leaf or of the median leaf, whichever is larger; and the
median leaf's gap of each, which is steadier from seed to seed. Leaves
whose reference gradient is under a thousandth of the median leaf's
(a key's bias under softmax) move by round-off alone and are left out.

Serving: the widest gap by which a served token's logit lies below the
reference's best at that position.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the leaf comparisons
NEGLIGIBLE_GRAD = 1e-3


def _leaf_gaps(prog: Optional[Dict[str, float]], ref: Dict[str, float],
               counted) -> Dict[str, float]:
    """Each counted leaf's gap (a NaN reads as infinite)."""
    med = statistics.median(ref[n] for n in counted)
    out = {}
    for n in counted:
        p = math.nan if prog is None else prog.get(n, math.nan)
        gap = abs(p - ref[n]) / max(ref[n], med)
        out[n] = gap if gap == gap else math.inf
    return out


def worst_leaf(prog: dict, ref: dict, key: str) -> str:
    """The leaf whose ``key`` (``grad_norms``, ``delta_norms``) gap is
    the widest."""
    gaps = _leaf_gaps(prog.get(key), ref[key], _counted(ref))
    return max(gaps, key=gaps.get)


def _counted(ref: dict) -> List[str]:
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return [n for n, v in g.items() if v >= NEGLIGIBLE_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The program's readings against the reference's (``losses``,
    ``grad_norms``, ``delta_norms`` each): ``loss_gap``, the worst
    relative gap of the steps' losses, and ``loss<k>_gap`` of step k
    alone; ``grad_gap`` and ``delta_gap`` by the worst leaf, and
    ``grad_median_gap`` and ``delta_median_gap`` by the median leaf's
    gap. A cell's limits name the ones it compares."""
    counted = _counted(ref)
    losses = prog.get("losses") or []
    out = {}
    for k, r in enumerate(ref["losses"], 1):
        p = losses[k - 1] if k <= len(losses) else math.nan
        gap = abs(p - r) / abs(r)
        out[f"loss{k}_gap"] = gap if gap == gap else math.inf
    out["loss_gap"] = max(out.values())
    for name, key in (("grad", "grad_norms"), ("delta", "delta_norms")):
        gaps = list(_leaf_gaps(prog.get(key), ref[key], counted).values())
        out[f"{name}_gap"] = max(gaps)
        out[f"{name}_median_gap"] = statistics.median(gaps)
    return out


def served_gap(ref_logits, tokens: List[int]) -> float:
    """The widest gap of ``tokens`` (one a row of ``ref_logits [n, V]``)
    below each row's best logit."""
    import torch

    t = torch.as_tensor(tokens, device=ref_logits.device).long()
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, t[:, None])[:, 0]
    return float((best - got).max()) if len(tokens) else 0.0


def judge(numbers: Dict[str, float], limits: Dict[str, dict]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """``(correct, [(name, value, limit)])`` over the cell's limits: every
    limited number at or under its limit. A cell without limits, or a
    limit whose number is missing, fails; a number without a limit is
    not compared."""
    rows, ok = [], bool(limits)
    for name in sorted(limits):
        value = numbers.get(name, math.inf)
        limit = limits[name]["limit"]
        rows.append((name, value, limit))
        if not value <= limit:
            ok = False
    return ok, rows
