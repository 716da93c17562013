"""The port's native binding (native.py) against the JAX package's: the
same BMP decodes, patch-sheet crops and m50 parses on files the test
writes, through the library the port builds with g++ into its own build
directory (``native/`` is only read). Where g++ is missing these tests
fail: the card host's loaders rely on the library. Also the Brown and
KITTI loaders of the port on BMPs, and chip_smoke.py's BMP writer."""

import os

import numpy as np
import pytest

from opencv_dlco_tpu import native as jax_native
from opencv_dlco_tpu.data.brown import (
    convert_brown_patches as jax_convert)
from opencv_dlco_tpu.data.store import ArtifactStore as JaxStore

import chip_smoke
from opencv_dlco_tpu_torch import native
from opencv_dlco_tpu_torch.data import kitti
from opencv_dlco_tpu_torch.data.brown import (
    convert_brown_patches, crop_patch_grid)
from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.ops.cuda_build import BUILD_DIR


def _imwrite(path, img):
    import cv2

    assert cv2.imwrite(str(path), img)
    return str(path)


def test_library_builds_into_the_port_build_dir():
    assert native.available(), native.error
    path = native.lib_path()
    assert os.path.dirname(path) == BUILD_DIR and os.path.exists(path)
    assert native._load().dlco_version() == 10
    assert jax_native.available()


@pytest.mark.parametrize("shape", [(96, 128), (37, 61), (64, 64, 3)],
                         ids=["gray", "odd-width", "color"])
def test_bmp_decode_equal_to_jax(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    p = _imwrite(tmp_path / "img.bmp", img)
    ours = native.bmp_load_gray(p)
    np.testing.assert_array_equal(ours, jax_native.bmp_load_gray(p))
    if len(shape) == 2:
        np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(native.load_gray(p), ours)


def test_chip_smoke_bmp_writer_round_trips(tmp_path):
    import cv2

    img = np.random.default_rng(2).integers(0, 256, (45, 77)).astype(
        np.uint8)
    p = str(tmp_path / "w.bmp")
    chip_smoke.write_bmp_gray(p, img)
    np.testing.assert_array_equal(native.bmp_load_gray(p), img)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), img)


def test_load_gray_other_formats_and_errors(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (20, 30)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        native.load_gray(_imwrite(tmp_path / "a.png", img)), img)
    with pytest.raises(FileNotFoundError):
        native.load_gray(str(tmp_path / "missing.bmp"))
    bad = tmp_path / "bad.bmp"
    bad.write_bytes(b"not a bitmap")
    with pytest.raises(IOError):
        native.load_gray(str(bad))


def test_load_gray_without_any_decoder_names_the_build_error(
        tmp_path, monkeypatch):
    """No library, no cv2, no PIL (the card host's case when g++ fails):
    the ImportError carries the compiler's message."""
    import sys

    p = _imwrite(tmp_path / "a.bmp", np.zeros((4, 4), np.uint8))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "error", "g++ exit 1: boom")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="g\\+\\+ exit 1: boom"):
        native.load_gray(p)


def test_load_patch_sheets_equal_to_jax(tmp_path):
    sheets = np.random.default_rng(4).integers(
        0, 256, (3, 1024, 1024)).astype(np.uint8)
    paths = [_imwrite(tmp_path / f"patches{i:04d}.bmp", s)
             for i, s in enumerate(sheets)]
    ours = native.load_patch_sheets(paths, n_threads=2)
    assert ours.shape == (3 * 256, 64, 64)
    np.testing.assert_array_equal(
        ours, jax_native.load_patch_sheets(paths, n_threads=2))
    np.testing.assert_array_equal(
        ours, np.concatenate([crop_patch_grid(s) for s in sheets]))


def test_parse_m50_equal_to_jax(tmp_path):
    rows = np.random.default_rng(5).integers(0, 100000, size=(500, 4))
    p = tmp_path / "m50_500000_500000_0.txt"
    p.write_text("\n".join(f"{r[0]} {r[1]} 0 {r[2]} {r[3]} 0 0"
                           for r in rows))
    ours = native.parse_m50(str(p))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, jax_native.parse_m50(str(p)))
    np.testing.assert_array_equal(ours, rows.astype(np.int32))
    np.testing.assert_array_equal(native.parse_m50(str(p), max_rows=7),
                                  rows[:7].astype(np.int32))


def test_brown_convert_through_native_equal_to_jax(tmp_path):
    """convert_brown_patches decodes its sheets with the native decoder in
    both packages: the same Indices and Patches."""
    rng = np.random.default_rng(6)
    d = tmp_path / "liberty"
    d.mkdir()
    for i in range(2):
        _imwrite(d / f"patches{i:04d}.bmp",
                 rng.integers(0, 256, (1024, 1024)).astype(np.uint8))
    pts = rng.integers(0, 50, (300, 2))
    ids = rng.integers(0, 400, (300, 2))
    (d / "m50_500000_500000_0.txt").write_text("\n".join(
        f"{a} {pa} 0 {b} {pb} 0 0"
        for (a, b), (pa, pb) in zip(ids, pts)))
    out_p = str(tmp_path / "port.h5")
    out_j = str(tmp_path / "jax.h5")
    assert (convert_brown_patches(str(d), out_p, progress=False)
            == jax_convert(str(d), out_j, progress=False))
    with ArtifactStore(out_p, "r") as sp, JaxStore(out_j, "r") as sj:
        for name in ("Indices", "Patches"):
            np.testing.assert_array_equal(sp.read(name), sj.read(name))


def test_kitti_frames_decode_bmp_natively(tmp_path):
    img = np.random.default_rng(7).integers(0, 256, (48, 64)).astype(
        np.uint8)
    p = str(tmp_path / "000000.bmp")
    chip_smoke.write_bmp_gray(p, img)
    np.testing.assert_array_equal(kitti.load_image_gray(p), img)
