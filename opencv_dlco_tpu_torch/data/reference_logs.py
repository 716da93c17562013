"""Parser for the reference's pr-learn training logs.

Port of ``opencv_dlco_tpu/data/reference_logs.py`` (pure Python, copied).
The reference ships the complete per-(mu, gamma) training logs of its
real-Brown PR runs (`workspace/pr-learn/logging/<ds>-<mu>-<gamma>-pr.log`,
768 files) — the stdout of src/pr-learn.cpp:369-425: one `Best:`/`Step:`
line per 100k RDA iterations carrying Loss/Regul/Obj/NNZ, and a `Stat:`
line per saved model carrying nPR/Dim/AUC/FPR95 (printed by
ComputePRStats, src/misc.cpp:171-264). They are the only record of the
solver's behaviour on real Brown data, the convergence-surface oracle of
the PR solver.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: the logs' directory, relative to the root of a reference checkout
REFERENCE_PR_LOGS = os.path.join("workspace", "pr-learn", "logging")

_STEP_RE = re.compile(
    r"^(Best|Step): (\d+)\s+Loss: ([\d.eE+-]+) Regul: ([\d.eE+-]+) "
    r"Obj: ([\d.eE+-]+) \(([\d.eE+-]+)\)\s+NNZ: (\d+) \((\d+)\)")
_STAT_RE = re.compile(
    r"^Stat: nPR #(\d+) \(#(\d+)\) Dim/MaxDim \[(\d+)/(\d+)\] "
    r"AUC: ([\d.eE+-]+) FPR95: ([\d.eE+-]+)")
_NAME_RE = re.compile(r"^(\w+)-([\d.]+)-([\d.]+)-pr\.log$")


@dataclass
class PRLogRun:
    """One parsed pr-learn log: the solver's trajectory on real Brown."""

    dataset: str
    mu: float
    gamma: float
    #: (t, loss, regul, obj, best_obj, nnz, best_nnz) per 100k-iter line
    steps: List[Tuple[int, float, float, float, float, int, int]] = \
        field(default_factory=list)
    #: (n_pr_unique, n_pr_with_dups, dim, max_dim, auc, fpr95) per save
    stats: List[Tuple[int, int, int, int, float, float]] = \
        field(default_factory=list)

    @property
    def final_best_obj(self) -> Optional[float]:
        return self.steps[-1][4] if self.steps else None

    @property
    def final_best_nnz(self) -> Optional[int]:
        """NNZ of the best-objective model at the end of the run — the
        model `06-pr-top.sh` ranks (the parenthesised NNZ of the last
        Step/Best line)."""
        return self.steps[-1][6] if self.steps else None

    @property
    def final_stat(self):
        """Last saved model's (nPR, dim, auc, fpr95)."""
        if not self.stats:
            return None
        n_pr, _, dim, _, auc, fpr95 = self.stats[-1]
        return n_pr, dim, auc, fpr95

    @property
    def completed(self) -> bool:
        return bool(self.steps) and self.steps[-1][0] >= 50_000_000


def parse_pr_learn_log(path: str) -> PRLogRun:
    name = _NAME_RE.match(os.path.basename(path))
    if not name:
        raise ValueError(f"not a pr-learn log name: {path}")
    run = PRLogRun(dataset=name.group(1), mu=float(name.group(2)),
                   gamma=float(name.group(3)))
    with open(path) as fh:
        for line in fh:
            m = _STEP_RE.match(line)
            if m:
                run.steps.append((int(m.group(2)), float(m.group(3)),
                                  float(m.group(4)), float(m.group(5)),
                                  float(m.group(6)), int(m.group(7)),
                                  int(m.group(8))))
                continue
            m = _STAT_RE.match(line)
            if m:
                run.stats.append((int(m.group(1)), int(m.group(2)),
                                  int(m.group(3)), int(m.group(4)),
                                  float(m.group(5)), float(m.group(6))))
    return run


def pr_log_grid(dataset: str,
                logging_dir: str = REFERENCE_PR_LOGS,
                ) -> Dict[Tuple[float, float], PRLogRun]:
    """All parsed runs of one dataset, keyed by (mu, gamma)."""
    out: Dict[Tuple[float, float], PRLogRun] = {}
    for path in sorted(glob.glob(
            os.path.join(logging_dir, f"{dataset}-*-pr.log"))):
        run = parse_pr_learn_log(path)
        out[(run.mu, run.gamma)] = run
    return out
