"""Stage-1 stand-in: synthetic Brown-shaped patch datasets.

Port of the numpy route of ``opencv_dlco_tpu/pipeline/e2e.py::
generate_synthetic_dataset``. No Brown raw data ships with the repo, so
datasets are drawn from the calibrated hard pair distribution
(data/synthetic.HARD_PAIR_PARAMS) at the published shape (64x64 uint8,
50% matched, the m50 index layout). Chunks draw from independent numpy
substreams seeded (seed, chunk start), exactly as the JAX package's numpy
route, so both packages write the same dataset for the same seed.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.store import ArtifactStore, remove_artifact
from ..data.synthetic import HARD_PAIR_PARAMS, synth_patch_pairs

#: Brown-published pair-set scale (m50_500000_500000_0.txt)
REFERENCE_N_PAIRS = 500_000


def generate_synthetic_dataset(ws, name: str, seed: int,
                               n_pairs: int = REFERENCE_N_PAIRS,
                               chunk: int = 4096) -> str:
    """dataset/{name}.h5 with Indices (N x 4 int32) + Patches (2N x 64 x 64
    uint8): pair i references patches (i, N+i); positives share a 3D-point
    id, negatives don't (the pair_labels contract). Idempotent: a complete
    dataset of this size is kept."""
    out = ws.path("dataset", f"{name}.h5")
    if os.path.exists(out):
        try:
            with ArtifactStore(out, "r") as st:
                if (st.exists("Patches")
                        and st.shape("Patches") == (2 * n_pairs, 64, 64)
                        and st.get_meta("complete", False)):
                    return out
        except OSError:
            # a run killed mid-write leaves a truncated HDF5; regenerate
            pass
        remove_artifact(out)

    indices = np.zeros((n_pairs, 4), np.int32)
    indices[:, 0] = np.arange(n_pairs)
    indices[:, 2] = np.arange(n_pairs) + n_pairs
    with ArtifactStore(out, "w") as st:
        st.create("Patches", (2 * n_pairs, 64, 64), np.uint8,
                  chunk_rows=chunk, compression=0)
        for s in range(0, n_pairs, chunk):
            e = min(s + chunk, n_pairs)
            rng = np.random.default_rng((seed, s))
            p1, p2, labels = synth_patch_pairs(rng, n_pairs=e - s,
                                               **HARD_PAIR_PARAMS)
            st.write_rows("Patches", s, p1)
            st.write_rows("Patches", n_pairs + s, p2)
            indices[s:e, 1] = indices[s:e, 0]
            indices[s:e, 3] = np.where(labels == 1, indices[s:e, 0],
                                       indices[s:e, 2])
        st.write("Indices", indices)
        st.set_meta("synthetic", True)
        st.set_meta("generator", {"seed": seed, "chunk": chunk,
                                  **HARD_PAIR_PARAMS})
        st.set_meta("complete", True)
    return out
