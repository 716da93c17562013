"""Structured metric logging.

The reference's printf lines (``Best:``/``Step:``/``Stat:``/``ModelStat:``/
``BestModel:``) are a machine interface — the bash layer greps them for model
selection (reference: workspace/06-pr-top.sh:20-46, 09-pjstats.sh,
src/pr-learn.cpp:369-425). We keep the same human-readable line formats AND
emit every record as JSONL so selection is programmatic, not sed/awk.
"""

from __future__ import annotations

import json
import os
import sys
from typing import IO, Optional


class MetricLogger:
    """Writes human log lines to a stream and structured records to JSONL."""

    def __init__(self, text_stream: Optional[IO] = None,
                 jsonl_path: Optional[str] = None):
        self._text = text_stream if text_stream is not None else sys.stdout
        self._jsonl: Optional[IO] = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._jsonl = open(jsonl_path, "a")

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def record(self, kind: str, text: str, **fields) -> None:
        self._text.write(text + "\n")
        self._text.flush()
        if self._jsonl:
            rec = {"kind": kind, **fields}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    # -- reference-parity line formats ------------------------------------

    def pr_step(self, *, best: bool, t: int, loss: float, regul: float,
                obj: float, obj_best: float, nnz: int, nnz_best: int,
                ttime: float, vtime: float) -> None:
        """reference: src/pr-learn.cpp:369-372 / :421-424."""
        tag = "Best" if best else "Step"
        self.record(
            "pr_step",
            f"{tag}: {t}  Loss: {loss:.6f} Regul: {regul:.6f} "
            f"Obj: {obj:.6f} ({obj_best:.6f})  NNZ: {nnz} ({nnz_best})  "
            f"Ttime: {ttime:.4f} Vtime: {vtime:.4f}",
            best=best, t=t, loss=loss, regul=regul, obj=obj,
            obj_best=obj_best, nnz=nnz, nnz_best=nnz_best,
            ttime=ttime, vtime=vtime,
        )

    def pr_stat(self, *, n_pr: int, nz_dim: int, dim: int, max_dim: int,
                auc: float, fpr95: float, saved: bool) -> None:
        """reference: src/pr-learn.cpp:413-418."""
        suffix = " [saved]" if saved else ""
        self.record(
            "pr_stat",
            f"Stat: nPR #{n_pr} (#{nz_dim}) Dim/MaxDim [{dim}/{max_dim}] "
            f"AUC: {auc:.6f} FPR95: {fpr95 * 100:.2f}{suffix}",
            n_pr=n_pr, nz_dim=nz_dim, dim=dim, max_dim=max_dim,
            auc=auc, fpr95=fpr95, saved=saved,
        )

    def pj_step(self, *, best: bool, t: int, loss: float, regul: float,
                obj: float, obj_best: float, rank: int, rank_best: int,
                ttime: float, vtime: float) -> None:
        """reference: src/pj-learn.cpp:538-541 / :577-580."""
        tag = "Best" if best else "Step"
        self.record(
            "pj_step",
            f"{tag}: {t}  Loss: {loss:.6f} Regul: {regul:.6f} "
            f"Obj: {obj:.6f} ({obj_best:.6f}) Rank: {rank} ({rank_best}) "
            f"Ttime: {ttime:.4f} Vtime: {vtime:.4f}",
            best=best, t=t, loss=loss, regul=regul, obj=obj,
            obj_best=obj_best, rank=rank, rank_best=rank_best,
            ttime=ttime, vtime=vtime,
        )

    def pj_stat(self, *, dim: int, auc: float, auc_best: float,
                fpr95: float, fpr95_best: float, saved: bool) -> None:
        """reference: src/pj-learn.cpp:569-574."""
        suffix = " [saved]" if saved else ""
        self.record(
            "pj_stat",
            f"Stat: Dim [{dim}] AUC: {auc:.6f} ({auc_best:.6f}) "
            f"FPR95: {fpr95 * 100:.2f} ({fpr95_best * 100:.2f}){suffix}",
            dim=dim, auc=auc, auc_best=auc_best,
            fpr95=fpr95, fpr95_best=fpr95_best, saved=saved,
        )

    def model_stat(self, *, model: str, row: int, dataset: str, dim: int,
                   fpr95: float, auc: float) -> None:
        """reference: src/pr-stats.cpp:257-266 ModelStat lines."""
        self.record(
            "model_stat",
            f"ModelStat: FPR95: {fpr95 * 100:.2f} AUC: {auc:.6f} "
            f"Dim: {dim} DS: [{dataset}] [{model}#{row}]",
            model=model, row=row, dataset=dataset, dim=dim,
            fpr95=fpr95, auc=auc,
        )
