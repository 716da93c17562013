"""The trainer's bf16-opted stage-3 route on the CPU, at toy size.

A user opts in with ``Workspace(desc_cfg=DescriptorConfig(
matmul_precision="default"))``: stage 3 then takes kernel A
(``ring_distances_fused``, bf16 operands, f32 accumulation; its plain
version on a CPU tensor) where the bank fits its tiles, and stage 7 rounds
its products' operands to bf16. The bank here is 1,024 filters x 4,096
pixels (128 rings), a multiple of both packages' kernel tiles.

The JAX package computes "default" in f32 on the CPU and takes its Pallas
kernel only on a TPU, so the port's bf16 rows are held to JAX's kernel
run in interpret mode with ``bf16=True`` (as tests/test_pallas_fused.py
runs it), and stage 7's to JAX's ``unprojected_diffs`` on operands cast
to bf16 first, never to JAX's f32 results. Tolerances:

- ``ROW_TOL``: stage 3's rows, those of tests/test_pallas_fused.py's
  f32 check: both sides round the same operands to bf16 and sum in f32,
  in different orders.
- ``UNPROJ_TOL``: stage 7's diffs, f32 sums of the same bf16 operands.
- The toy chain on the bf16 route against the port's own f32 chain, by
  the tolerances of tests/test_torch_e2e_artifact.py (0.5 pp for the best
  PR row's mean FPR95, 1.0 pp for each PJ winner), every export ok.

Both JAX sides take the port's patch transforms (``batch_patch_transform``
of the same patches, as the Workspace computes them): the two packages'
transforms agree to f32 rounding except where a pixel's gradient lies on
an orientation-bin boundary and lands in the neighbouring bin (2 of 6.3M
values on 192 of these pairs), which moves a pooled value by up to ~0.02;
tests/test_torch_ops.py holds the transforms themselves.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from opencv_dlco_tpu.ops.pair_distance import (
    unprojected_diffs as jax_unprojected_diffs)
from opencv_dlco_tpu.ops.pair_distance_pallas import (
    ring_distances_fused as jax_ring_distances_fused)
from opencv_dlco_tpu.models.select import (
    select_pr_filters as jax_select_pr_filters)

from opencv_dlco_tpu_torch.data.store import ArtifactStore
from opencv_dlco_tpu_torch.ops.pair_distance_fused import TP
from opencv_dlco_tpu_torch.ops.patch_transform import batch_patch_transform
from opencv_dlco_tpu_torch.pipeline import stages
from opencv_dlco_tpu_torch.pipeline.e2e import (generate_synthetic_dataset,
                                                run_reference_scale)
from opencv_dlco_tpu_torch.pipeline.stages import Workspace
from opencv_dlco_tpu_torch.utils import configs as pcfg

from test_torch_e2e import _kw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: 128 rings = 1,024 filters: kernel A's tiles (128 filters, 64 pixels) and
#: the JAX kernel's (1,024 filters, 512 pixels)
BANK = pcfg.PoolRegionConfig(nr=16, nphi=2, nsigma=4)
#: 70 pairs in blocks of 40: both blocks' pair counts (40, 30) are not
#: multiples of kernel A's 16-pair tile
N_PAIRS, PAIR_BLOCK = 70, 40
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
UNPROJ_TOL = dict(rtol=1e-5, atol=1e-6)
#: tests/test_torch_e2e_artifact.py's
BEST_PR_FPR95_TOL = 0.005
PJ_FPR95_TOL = 0.010


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain_kw(root):
    """tests/test_torch_e2e.py's toy e2e shape at BANK, its PR grid's mu
    and a 512-D cap keeping the winner's diffs narrow (a few hundred
    wide), so the PJ stage stays cheap."""
    kw = _kw(pcfg, root)
    kw.update(pool_cfg=BANK,
              pr_grid=pcfg.PRSweepGrid(mus=(0.6,), gammas=(0.05, 1.0)),
              pr_overrides=dict(kw["pr_overrides"], max_dim=512))
    return kw


def _pt(patches):
    """The port's patch transform, as a JAX array."""
    return jnp.asarray(batch_patch_transform(
        torch.from_numpy(patches)).numpy())


def test_compdist_rows_equal_jax_kernel_a_in_bf16(tmp_path):
    ws = Workspace(str(tmp_path), pool_cfg=BANK, pair_block=PAIR_BLOCK,
                   desc_cfg=pcfg.DescriptorConfig(matmul_precision="default"),
                   progress=False, device="cpu")
    assert N_PAIRS % PAIR_BLOCK % TP and PAIR_BLOCK % TP
    generate_synthetic_dataset(ws, "tiny", seed=3, n_pairs=N_PAIRS)
    assert ws._stage3_bank()[1] == "kernel_A", \
        "the bank must take kernel A's bf16 route"
    with ArtifactStore(ws.compdist("tiny"), "r") as st:
        got = st.read("Distance")
    with ArtifactStore(ws.path("dataset", "tiny.h5"), "r") as st:
        idx = st.read("Indices")
        patches = st.read("Patches")
    want = np.asarray(jax_ring_distances_fused(
        jnp.asarray(ws.load_filters()), _pt(patches[idx[:, 0]]),
        _pt(patches[idx[:, 2]]), bf16=True, interpret=True))
    assert got.shape == want.shape == (N_PAIRS, BANK.n_rings)
    np.testing.assert_allclose(got, want, **ROW_TOL)
    # the bf16 rows are not the f32 route's
    ws_f32 = Workspace(str(tmp_path), pool_cfg=BANK, pair_block=PAIR_BLOCK,
                       progress=False, device="cpu")
    f32 = torch.from_numpy(ws_f32.load_filters())
    pt = [batch_patch_transform(torch.from_numpy(patches[idx[:, c]]))
          for c in (0, 2)]
    assert not np.array_equal(
        got, stages.ring_distances(f32, *pt).numpy())


@pytest.mark.parametrize("precision,shape,cuda,route", [
    ("highest", (40960, 4096), True, "kernel_A_f32"),
    ("highest", (1024, 4096), True, "kernel_A_f32"),
    ("highest", (40960, 4096), False, "f32"),  # no f32 kernel off the card
    ("highest", (1000, 4096), True, "f32"),    # filters off the 128 tile
    ("highest", (1024, 4000), True, "f32"),    # pixels off the 64 stage
    ("default", (40960, 4096), True, "kernel_A"),
    ("default", (40960, 4096), False, "kernel_A"),
    ("default", (1000, 4096), True, "f32"),
    ("default", (1024, 4000), True, "f32"),
])
def test_stage3_route_choice(precision, shape, cuda, route):
    assert stages.stage3_route(precision, shape, cuda) == route


def test_f32_route_on_the_cpu_is_the_plain_product(tmp_path):
    """At "highest" stage 3 on the CPU takes ops/pair_distance's f32
    product (``stages.ring_distances``, the JAX parity route), its bank an
    f32 matrix; kernel A's f32 mode off the card gives the same rows bit
    for bit."""
    ws = Workspace(str(tmp_path), pool_cfg=BANK, progress=False,
                   device="cpu")
    filters, route = ws._stage3_bank()
    assert route == "f32"
    assert filters.dtype == torch.float32 and filters.shape == (1024, 4096)
    rng = np.random.default_rng(0)
    patches = rng.integers(0, 256, (2 * 21, 64, 64), dtype=np.uint8)
    pt = batch_patch_transform(torch.from_numpy(patches))
    want = stages.ring_distances(filters, pt[:21], pt[21:])
    assert torch.equal(stages.ring_distances_fused(filters, pt[:21],
                                                   pt[21:], bf16=False), want)
    for r in (route, "kernel_A_f32"):
        assert torch.equal(stages.stage3_distances(filters, r, pt[:21],
                                                   pt[21:]), want), r


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The toy e2e chain at BANK on the f32 route and, through
    tools/e2e_memory_run.py's Workspace swap, on the bf16 route."""
    tool = _tool("e2e_memory_run")
    out = {}
    for prec in ("highest", "default"):
        root = str(tmp_path_factory.mktemp(f"chain_{prec}"))
        kw = chain_kw(root)
        with tool.stage3_precision(prec), tool.stage3_route() as calls:
            res = run_reference_scale(root, device="cpu", **kw)
        out[prec] = dict(root=root, res=res, calls=dict(calls))
    return out


def test_chains_take_their_routes(chains):
    n_ds = len(chains["default"]["res"]["datasets"])
    assert chains["default"]["calls"] == {"kernel_A": n_ds,
                                          "kernel_A_f32": 0, "f32": 0}
    assert chains["highest"]["calls"] == {"kernel_A": 0,
                                          "kernel_A_f32": 0, "f32": n_ds}
    assert stages.Workspace is Workspace


def test_bf16_chain_is_within_the_f32_chains_gates(chains):
    got, want = chains["default"]["res"], chains["highest"]["res"]
    assert abs(got["best_pr"]["mean_fpr95"]
               - want["best_pr"]["mean_fpr95"]) <= BEST_PR_FPR95_TOL
    assert sorted(got["pj_winners"]) == sorted(want["pj_winners"])
    for cap, w in got["pj_winners"].items():
        assert abs(w["mean_fpr95"] - want["pj_winners"][cap]["mean_fpr95"]) \
            <= PJ_FPR95_TOL, cap
    for cap, rec in got["exports"].items():
        assert rec["ok"] and 0 < rec["dim"] <= cap, cap


def test_stage7_diffs_equal_jax_on_bf16_operands(chains):
    run = chains["default"]
    root, res = run["root"], run["res"]
    ws = Workspace(root, pool_cfg=BANK, progress=False, device="cpu")
    name, row = res["pr_ref"].rsplit("#", 1)  # the model's base name
    pr_path, row = os.path.join(root, "pr-learn", name), int(row)
    pr_label = os.path.basename(pr_path).replace(".h5", "")
    with ArtifactStore(pr_path, "r") as st:
        w = st.read("w")[row]
    sel = np.asarray(jax_select_pr_filters(ws.load_filters(), w))
    q = (lambda x: jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
         .astype(jnp.float32))
    for ds in res["datasets"]:
        path = ws.path("distances", f"{ds}-{pr_label}#{row}-unproj.h5")
        with ArtifactStore(path, "r") as st:
            got = st.read("Distance")
        with ArtifactStore(ws.path("dataset", f"{ds}.h5"), "r") as st:
            idx = st.read("Indices")
            patches = st.read("Patches")
        want = np.asarray(jax_unprojected_diffs(
            q(sel), q(_pt(patches[idx[:, 0]])),
            q(_pt(patches[idx[:, 2]]))))
        assert got.shape == want.shape, ds
        np.testing.assert_allclose(got, want, **UNPROJ_TOL, err_msg=ds)
