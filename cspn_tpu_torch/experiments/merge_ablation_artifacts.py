"""Merge the parts of a completion-ablation sweep resumed with
`--seed-base` (counterpart of scripts/merge_ablation_artifacts.py).

The per_seed lists are joined in the parts' order, and the means and the
paired per-seed deltas (ddof=1 sample std, n reported) recomputed.

    python -m cspn_tpu_torch.experiments.merge_ablation_artifacts out.json part1.json part2.json ...
"""

from __future__ import annotations

import json
import sys

from cspn_tpu_torch.experiments import write_json
from cspn_tpu_torch.experiments.completion_refinement_ablation import arm_means, paired_deltas


def merge(out_path: str, parts: list[str]) -> dict:
    """Write the merged artifact of `parts` to `out_path` and return it."""
    arts = []
    for p in parts:
        with open(p) as f:
            arts.append(json.load(f))
    base = arts[0]
    per_seed = {arm: [] for arm in base["per_seed"]}
    for art in arts:
        for arm, rs in art["per_seed"].items():
            per_seed[arm].extend(rs)
    n_seeds = len(per_seed["no_cspn"])
    assert all(len(rs) == n_seeds for rs in per_seed.values()), {
        a: len(r) for a, r in per_seed.items()}
    rec = dict(base)
    rec["config"] = dict(base["config"], seeds=n_seeds)
    rec["paired_improvement_vs_no_cspn"] = paired_deltas(per_seed)
    rec["means"] = arm_means(per_seed)
    rec["per_seed"] = per_seed
    write_json(out_path, rec)
    return rec


def main(argv=None) -> dict:
    out_path, *parts = sys.argv[1:] if argv is None else argv
    if not parts:
        raise SystemExit("usage: merge_ablation_artifacts OUT.json PART.json [PART.json ...]")
    rec = merge(out_path, parts)
    print(json.dumps({"seeds": rec["config"]["seeds"], "means": rec["means"],
                      "paired": rec["paired_improvement_vs_no_cspn"]}))
    return rec


if __name__ == "__main__":
    main()
