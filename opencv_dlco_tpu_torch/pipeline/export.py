"""OpenCV VGG-descriptor header export (the deployment artifact).

A copy of ``opencv_dlco_tpu/pipeline/export.py`` (numpy only): the same
emitter, byte for byte, so both packages write the same ``.i`` for the
same (PR filters, PJ matrix).

Re-design of export-opencv (reference: src/export-opencv.cpp:206-391): the
selected pooling filters and the learned projection are emitted as a C
header of run-length-encoded sparse arrays (`PRidx`/`PR`/`PJidx`/`PJ`,
float bits as hex) consumed by OpenCV contrib's VGG descriptor. The format
is matched byte-for-byte (golden round-trip tests parse the reference's
published vgg_generated_*.i files and re-emit them identically).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from ..models.select import select_pr_filters
from ..data.store import ArtifactStore, parse_model_ref


def _rle_blocks(mat: np.ndarray):
    """Yield (start, count) runs of consecutive nonzeros in row-major order
    (reference: src/export-opencv.cpp:229-271)."""
    flat = mat.reshape(-1)
    nz = flat != 0.0
    idx = np.flatnonzero(nz)
    if idx.size == 0:
        return
    # boundaries where consecutive indices are not adjacent
    breaks = np.flatnonzero(np.diff(idx) != 1)
    starts = np.concatenate([[idx[0]], idx[breaks + 1]])
    ends = np.concatenate([idx[breaks], [idx[-1]]])
    for s, e in zip(starts, ends):
        yield int(s), int(e - s + 1)


def _emit_idx_array(out, name: str, mat: np.ndarray) -> None:
    out.append(f"// {name} indexes & len")
    out.append(f"static const unsigned int {name}idx[] =")
    parts = [f"0x{s:x},0x{c:X}" for s, c in _rle_blocks(mat)]
    lines = ["{"]
    row = " "
    for i, p in enumerate(parts):
        row += p
        if i != len(parts) - 1:
            row += ","
            if (i + 1) % 8 == 0:
                lines.append(row)
                row = " "
    lines.append(row)
    out.append("\n".join(lines) + "\n};")
    out.append("")


def _emit_val_array(out, name: str, mat: np.ndarray) -> None:
    out.append(f"// {name} {'matrix' if name == 'PR' else 'sparse elements'}")
    out.append(f"static const unsigned int {name}[] =")
    flat = mat.reshape(-1)
    vals = flat[flat != 0.0].astype(np.float32)
    bits = vals.view(np.uint32)
    parts = [f"0x{b:08x}" for b in bits]
    lines = ["{"]
    row = " "
    for i, p in enumerate(parts):
        row += p
        if i != len(parts) - 1:
            row += ","
            if (i + 1) % 8 == 0:
                lines.append(row)
                row = " "
    lines.append(row)
    out.append("\n".join(lines) + "\n};")
    out.append("")


def emit_vgg_header(pr_filters: np.ndarray, pj: np.ndarray,
                    pr_source: str = "", pj_source: str = "",
                    pr_row: int = 0) -> str:
    """Render the full .i header text for (selected PR filters, PJ matrix)."""
    if pj.shape[1] != pr_filters.shape[0] * 8:
        raise ValueError(
            f"PJ cols {pj.shape[1]} disagree with 8 * PR rows "
            f"{pr_filters.shape[0] * 8}"
        )
    out = []
    out.append("// generated VGG pooling region filters & projection parameters")
    out.append("")
    out.append(f"// PR: [{pr_source}]#{pr_row}")
    out.append(f"// PJ: [{pj_source}]")
    out.append("")
    out.append("")
    out.append("// PR orig rows")
    out.append(f"static const int PRrows = {pr_filters.shape[0]};")
    out.append("")
    out.append("// PR orig cols")
    out.append(f"static const int PRcols = {pr_filters.shape[1]};")
    out.append("")
    _emit_idx_array(out, "PR", pr_filters)
    _emit_val_array(out, "PR", pr_filters)
    out.append("")
    out.append("// PJ orig rows")
    out.append(f"static const int PJrows = {pj.shape[0]};")
    out.append("")
    out.append("// PJ orig cols")
    out.append(f"static const int PJcols = {pj.shape[1]};")
    out.append("")
    _emit_idx_array(out, "PJ", pj)
    _emit_val_array(out, "PJ", pj)
    return "\n".join(out)


def parse_vgg_header(text: str) -> Dict[str, np.ndarray]:
    """Parse a vgg_generated_*.i header back into dense PR / PJ matrices.

    Accepts both the reference's exported format (``static const``) and
    the author's original MATLAB-era headers
    (workspace/opencv/original/vgg_generated_{46,63,77}.i), which drop
    the ``static`` qualifier.
    """
    dims = {
        m.group(1): int(m.group(2))
        for m in re.finditer(r"(?:static\s+)?const int (\w+) = (\d+);",
                             text)
    }
    arrays = {}
    for m in re.finditer(
        r"(?:static\s+)?const unsigned int (\w+)\[\] =\s*\{([^}]*)\};",
        text, re.S,
    ):
        name = m.group(1)
        vals = [int(v, 16) for v in re.findall(r"0x[0-9a-fA-F]+", m.group(2))]
        arrays[name] = np.array(vals, dtype=np.uint64)

    def densify(prefix: str) -> np.ndarray:
        rows, cols = dims[f"{prefix}rows"], dims[f"{prefix}cols"]
        dense = np.zeros(rows * cols, dtype=np.float32)
        idx = arrays[f"{prefix}idx"].reshape(-1, 2)
        vals = arrays[prefix].astype(np.uint32).view(np.float32)
        p = 0
        for start, count in idx:
            dense[int(start):int(start) + int(count)] = vals[p:p + int(count)]
            p += int(count)
        if p != vals.shape[0]:
            raise ValueError(f"{prefix}: {vals.shape[0]} values, runs cover {p}")
        return dense.reshape(rows, cols)

    return {"PR": densify("PR"), "PJ": densify("PJ")}


def export_opencv(filters_path: str, pr_ref: str, pj_path: str,
                  out_path: str, n_symmetries: int = 8) -> str:
    """Full export stage: load bank + learned w + learned W, emit header.

    ``pr_ref`` uses the `file.h5#row` convention
    (reference: workspace/11-opencv-export.sh:8-26).
    """
    with ArtifactStore(filters_path, "r") as st:
        filters = st.read("PRFilters")
    filters = filters.reshape(filters.shape[0], -1)

    pr_path, row = parse_model_ref(pr_ref)
    with ArtifactStore(pr_path, "r") as st:
        hist = st.read("w")
        w = hist[row if row >= 0 else hist.shape[0] - 1]
        row = row if row >= 0 else hist.shape[0] - 1

    with ArtifactStore(pj_path, "r") as st:
        pj = st.read("W")
    # drop zero rows (the reference's W_Save keeps only nonzero rows,
    # ours stores the static-shape matrix)
    pj = pj[np.any(pj != 0.0, axis=1)]

    sel = select_pr_filters(filters, w, n_symmetries)
    text = emit_vgg_header(sel, pj, pr_source=pr_path, pj_source=pj_path,
                           pr_row=row)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path
