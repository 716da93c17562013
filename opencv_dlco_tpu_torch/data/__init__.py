"""HDF5 artifact store, Brown ingestion, synthetic data."""
from .synthetic import synth_pr_dataset, synth_pj_dataset, synth_patch_pairs

__all__ = [
    "synth_pr_dataset",
    "synth_pj_dataset",
    "synth_patch_pairs",
]
