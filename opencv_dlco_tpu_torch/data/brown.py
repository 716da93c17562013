"""Brown patchdata ingestion (liberty / notredame / yosemite).

Re-design of conv-impatches (reference: src/conv-impatches.cpp:103-235):
parses the `m50_500000_500000_0.txt` pair index and crops the 16x16 grids
of 64x64 patches out of `patchesNNNN.bmp` sheets into the `Indices` /
`Patches` datasets of the artifact store.

Sheets decode through the native BMP decoder (``native.py``; cv2, then
PIL, without it or for other formats); patches land in one (N, 64, 64)
uint8 array,
chunked on disk exactly like the reference's schema, so the artifact is
the one the JAX package writes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .store import ArtifactStore
from ..utils.progress import TermProgress

PATCH = 64
GRID = 16  # 16 x 16 patches per sheet
SHEET = PATCH * GRID


def parse_pair_index(path: str) -> np.ndarray:
    """m50 index file -> (N, 4) int32 [patch1, point1, patch2, point2].

    Line format: `id1 point1 unused id2 point2 unused [...]`
    (reference: src/conv-impatches.cpp:146-154).
    """
    cols = np.loadtxt(path, dtype=np.int64)
    out = np.stack([cols[:, 0], cols[:, 1], cols[:, 3], cols[:, 4]], axis=1)
    return out.astype(np.int32)


def crop_patch_grid(sheet: np.ndarray, n_keep: int = GRID * GRID) -> np.ndarray:
    """One (1024, 1024) sheet -> (n_keep, 64, 64) row-major patch grid."""
    h, w = sheet.shape
    g = sheet.reshape(h // PATCH, PATCH, w // PATCH, PATCH)
    patches = g.transpose(0, 2, 1, 3).reshape(-1, PATCH, PATCH)
    return patches[:n_keep]


def _load_sheet(path: str) -> np.ndarray:
    from ..native import load_gray

    return load_gray(path)


def convert_brown_patches(patch_dir: str, out_path: str,
                          index_name: str = "m50_500000_500000_0.txt",
                          max_pairs: Optional[int] = None,
                          progress: bool = True) -> Tuple[int, int]:
    """Brown dataset directory -> artifact file with Indices + Patches.

    Returns (n_pairs, n_patches). Idempotent: skips when output exists with
    both datasets (the stage-resume contract, workspace/01-export.sh:12).
    """
    if os.path.exists(out_path):
        with ArtifactStore(out_path, "r") as st:
            if st.exists("Indices") and st.exists("Patches"):
                return st.shape("Indices")[0], st.shape("Patches")[0]

    indices = parse_pair_index(os.path.join(patch_dir, index_name))
    if max_pairs is not None:
        indices = indices[:max_pairs]
    n_patches = int(indices[:, [0, 2]].max()) + 1

    bar = TermProgress() if progress else None
    with ArtifactStore(out_path, "w") as st:
        st.write("Indices", indices)
        st.create("Patches", (n_patches, PATCH, PATCH), np.uint8,
                  chunk_rows=256)
        n_sheets = (n_patches + GRID * GRID - 1) // (GRID * GRID)
        written = 0
        for i in range(n_sheets):
            sheet_path = os.path.join(patch_dir, f"patches{i:04d}.bmp")
            sheet = _load_sheet(sheet_path)
            if sheet is None:
                raise FileNotFoundError(sheet_path)
            keep = min(GRID * GRID, n_patches - written)
            st.write_rows("Patches", written, crop_patch_grid(sheet, keep))
            written += keep
            if bar:
                bar.update(written / n_patches)
        if bar:
            bar.done()
        st.set_meta("source", {"patch_dir": patch_dir, "index": index_name})
    return indices.shape[0], n_patches


def pair_labels(indices: np.ndarray) -> np.ndarray:
    """(N, 4) index rows -> (N,) uint8 labels: 1 iff same 3D point id
    (reference: src/comp-fulldists.cpp:246-251)."""
    return (indices[:, 1] == indices[:, 3]).astype(np.uint8)
