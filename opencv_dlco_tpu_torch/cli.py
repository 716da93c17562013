"""Command-line interface of the port: stages 1-11 over a Workspace directory.

The subcommands and flags of ``opencv_dlco_tpu.cli`` for the stages the
port carries; each stage is idempotent (resume-safe). Runs on the CUDA
device; ``sfm``, ``slam`` and ``bench`` take ``--device cpu`` for the plain
PyTorch path.

Usage examples:
    python -m opencv_dlco_tpu_torch.cli convert  -w ws --dataset liberty --patch-dir /data/liberty
    python -m opencv_dlco_tpu_torch.cli genpr    -w ws
    python -m opencv_dlco_tpu_torch.cli compdist -w ws --dataset liberty
    python -m opencv_dlco_tpu_torch.cli prlearn  -w ws --dataset liberty --mu 0.025 --gamma 0.1
    python -m opencv_dlco_tpu_torch.cli prsweep  -w ws --dataset liberty
    python -m opencv_dlco_tpu_torch.cli prstats  -w ws --datasets liberty,notredame
    python -m opencv_dlco_tpu_torch.cli compunproj -w ws --dataset liberty --pr ws/pr-learn/...-pr.h5#7
    python -m opencv_dlco_tpu_torch.cli pjlearn  -w ws --unproj ws/distances/...-unproj.h5
    python -m opencv_dlco_tpu_torch.cli pjsweep  -w ws --unproj ws/distances/...-unproj.h5
    python -m opencv_dlco_tpu_torch.cli pjstats  -w ws --max-dim 80
    python -m opencv_dlco_tpu_torch.cli export   -w ws --pr ...-pr.h5#7 --pj ...-pj.h5 --out vgg_generated_64.i
    python -m opencv_dlco_tpu_torch.cli workflow -w ws --datasets liberty,notredame
    python -m opencv_dlco_tpu_torch.cli e2e      -w ws
    python -m opencv_dlco_tpu_torch.cli sfm      --image1 a.bmp --image2 b.bmp --model vgg_generated_64.i --intrinsics 300,300,160,160
    python -m opencv_dlco_tpu_torch.cli slam     --root kitti --sequence 07 --model vgg_generated_64.i
    python -m opencv_dlco_tpu_torch.cli bench    --suite hinge
    python -m opencv_dlco_tpu_torch.cli bench    --suite slam_xl --header vgg_generated_64.i
    python -m opencv_dlco_tpu_torch.cli dist-info

Several processes (one rank each): set DLCO_COORDINATOR=host:port,
DLCO_NUM_PROCESSES and DLCO_PROCESS_ID on every process and pass
``--distributed`` (DLCO_NUM_PROCESSES alone also joins the group; see
parallel/distributed.py); ``slam --mesh dp[,mp]`` then distributes the
SLAM back end over the ranks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def _ws(args):
    from .pipeline.stages import Workspace
    from .utils.configs import PoolRegionConfig

    pool = PoolRegionConfig()
    if args.small_bank:
        pool = PoolRegionConfig(nr=6, nphi=2, nsigma=3)
    return Workspace(args.workspace, pool_cfg=pool,
                     pair_block=args.pair_block)


def cmd_convert(args):
    out = _ws(args).convert(args.patch_dir, args.dataset,
                            max_pairs=args.max_pairs)
    print(f"dataset ready: {out}")


def cmd_genpr(args):
    print(f"filter bank ready: {_ws(args).genpr()}")


def cmd_compdist(args):
    print(f"distances ready: {_ws(args).compdist(args.dataset)}")


def cmd_prlearn(args):
    from .utils.configs import PRLearnConfig

    cfg = PRLearnConfig(mu=args.mu, gamma=args.gamma, n_iter=args.iters,
                        log_step=args.log_step, batch=args.batch,
                        max_dim=args.max_dim)
    print(f"pr model: {_ws(args).prlearn(args.dataset, cfg)}")


def cmd_prsweep(args):
    from .parallel.sweep import run_pr_sweep
    from .utils.configs import PRLearnConfig, PRSweepGrid

    base = PRLearnConfig(n_iter=args.iters, log_step=args.log_step,
                         batch=args.batch, max_dim=args.max_dim)
    results = run_pr_sweep(_ws(args), args.dataset, PRSweepGrid(), base)
    print(json.dumps(results[:10], indent=2))


def cmd_prstats(args):
    from .pipeline.stages import Workspace

    ws = _ws(args)
    models = sorted(glob.glob(os.path.join(args.workspace, "pr-learn",
                                           "*-pr.h5")))
    dists = {ds: ws.path("distances", f"{ds}-dist.h5")
             for ds in args.datasets.split(",")}
    recs = ws.prstats(models, dists, jsonl_path=ws.path("pr-select.jsonl"))
    for r in Workspace.pr_rank(recs):
        print(json.dumps(r))


def cmd_compunproj(args):
    print(f"unproj ready: {_ws(args).compunproj(args.dataset, args.pr)}")


def cmd_pjlearn(args):
    from .utils.configs import PJLearnConfig

    cfg = PJLearnConfig(mu=args.mu, gamma=args.gamma, n_iter=args.iters,
                        log_step=args.log_step, batch=args.batch,
                        eigh_mode=args.eigh_mode)
    print(f"pj model: {_ws(args).pjlearn(args.unproj, cfg)}")


def cmd_pjsweep(args):
    from .parallel.sweep import run_pj_sweep
    from .utils.configs import PJLearnConfig, PJSweepGrid

    base = PJLearnConfig(n_iter=args.iters, log_step=args.log_step,
                         batch=args.batch, eigh_mode=args.eigh_mode)
    results = run_pj_sweep(_ws(args), args.unproj, PJSweepGrid(), base)
    print(json.dumps(results[:10], indent=2))


def cmd_pjstats(args):
    from .pipeline.stages import Workspace

    models = sorted(glob.glob(os.path.join(args.workspace, "pj-learn",
                                           "*-pj.h5")))
    for r in Workspace.pj_rank(models, max_dim=args.max_dim):
        print(json.dumps(r))


def cmd_export(args):
    print(f"exported: {_ws(args).export(args.pr, args.pj, args.out)}")


def cmd_workflow(args):
    from .utils.configs import PJLearnConfig, PRLearnConfig

    out = _ws(args).run_full(
        args.datasets.split(","),
        pr_cfg=PRLearnConfig(n_iter=args.pr_iters, log_step=args.pr_log_step,
                             batch=args.batch, max_dim=args.max_dim),
        pj_cfg=PJLearnConfig(n_iter=args.pj_iters,
                             log_step=args.pj_log_step),
    )
    print(json.dumps({"best_pr": out["best_pr"], "exports": out["exports"]},
                     indent=2, default=str))


def cmd_e2e(args):
    from .pipeline.e2e import run_reference_scale

    summary = run_reference_scale(
        args.workspace, n_pairs=args.n_pairs, pr_iters=args.pr_iters,
        pj_iters=args.pj_iters, out_json=args.out_json)
    print(json.dumps(summary, indent=1, sort_keys=True, default=str))


def cmd_sfm(args):
    """Two-view SfM on an image pair (images decode through
    ``native.load_gray``)."""
    from .models.vgg import VGGDescriptor
    from .native import load_gray
    from .pipeline.sfm import two_view_sfm

    img1 = load_gray(args.image1)
    img2 = load_gray(args.image2)
    with open(args.model) as f:
        model = VGGDescriptor.from_header(f.read(), device=args.device)
    fx, fy, cx, cy = (float(v) for v in args.intrinsics.split(","))
    res = two_view_sfm(img1, img2, (fx, fy, cx, cy), model,
                       n_keypoints=args.keypoints)
    print(json.dumps({
        "n_matches": res.n_matches,
        "n_inliers": res.n_inliers,
        "rms_reproj": res.rms_reproj,
        "rotation": res.rotation.tolist(),
        "translation": res.translation.tolist(),
        "n_points": int(res.points3d.shape[0]),
    }, indent=2))


def cmd_slam(args):
    """Full monocular SLAM over a KITTI odometry-format sequence."""
    from .data.kitti import evaluate_against_gt, load_sequence
    from .models.vgg import VGGDescriptor
    from .pipeline.slam import SlamConfig, run_slam

    seq = load_sequence(args.root, args.sequence, camera=args.camera,
                        max_frames=args.max_frames)
    frames = [seq.load_frame(i) for i in range(len(seq))]
    with open(args.model) as f:
        model = VGGDescriptor.from_header(f.read(), device=args.device)
    cfg = SlamConfig(n_keypoints=args.keypoints,
                     ba_window=args.ba_window,
                     loop_gap=args.loop_gap)
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        dp, _, mp = args.mesh.partition(",")
        mesh = make_mesh(dp=int(dp), mp=int(mp) if mp else 1,
                         device=args.device)
    res = run_slam(frames, seq.intrinsics, model, cfg, mesh=mesh)
    out = {
        "n_frames": len(seq),
        "n_keyframes": int(res.keyframes.shape[0]),
        "n_loop_closures": len(res.loop_edges),
        "trajectory": res.translations.tolist(),
    }
    if seq.poses is not None:
        out["eval"] = evaluate_against_gt(res, seq)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        del out["trajectory"]
        out["trajectory_file"] = args.out
    else:
        del out["trajectory"]
    print(json.dumps(out, indent=2))


def cmd_bench(args):
    from . import bench

    bench.run(suite=args.suite, out_path=args.out or bench.DEFAULT_OUT,
              device=args.device, header=args.header)


def cmd_dist_info(args):
    from .parallel.distributed import distributed_init, host_info

    multi = distributed_init(device=args.device)
    print(json.dumps({"multi_process": multi, **host_info(args.device)},
                     indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m opencv_dlco_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("-w", "--workspace", required=True)
        sp.add_argument("--pair-block", type=int, default=256)
        sp.add_argument("--small-bank", action="store_true",
                        help="6x2x3 ring grid for smoke tests")

    sp = sub.add_parser("convert", help="Brown patch dir -> dataset h5")
    common(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--patch-dir", required=True)
    sp.add_argument("--max-pairs", type=int, default=None)
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("genpr", help="generate pooling-region filter bank")
    common(sp)
    sp.set_defaults(fn=cmd_genpr)

    sp = sub.add_parser("compdist", help="full ring-distance precompute")
    common(sp)
    sp.add_argument("--dataset", required=True)
    sp.set_defaults(fn=cmd_compdist)

    sp = sub.add_parser("prlearn", help="PR RDA learner (one run)")
    common(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--mu", type=float, default=0.025)
    sp.add_argument("--gamma", type=float, default=0.10)
    sp.add_argument("--iters", type=int, default=50_000_000)
    sp.add_argument("--log-step", type=int, default=100_000)
    sp.add_argument("--batch", type=int, default=1024)
    sp.add_argument("--max-dim", type=int, default=640)
    sp.set_defaults(fn=cmd_prlearn)

    sp = sub.add_parser("prsweep", help="PR hyperparameter grid, one loop")
    common(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--iters", type=int, default=50_000_000)
    sp.add_argument("--log-step", type=int, default=100_000)
    sp.add_argument("--batch", type=int, default=1024)
    sp.add_argument("--max-dim", type=int, default=640)
    sp.set_defaults(fn=cmd_prsweep)

    sp = sub.add_parser("prstats", help="cross-dataset PR model selection")
    common(sp)
    sp.add_argument("--datasets", required=True,
                    help="comma-separated dataset names")
    sp.set_defaults(fn=cmd_prstats)

    sp = sub.add_parser("compunproj", help="unprojected diff vectors")
    common(sp)
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--pr", required=True, help="pr model ref file.h5#row")
    sp.set_defaults(fn=cmd_compunproj)

    sp = sub.add_parser("pjlearn", help="PJ RDA learner (one run)")
    common(sp)
    sp.add_argument("--unproj", required=True)
    sp.add_argument("--mu", type=float, default=0.001)
    sp.add_argument("--gamma", type=float, default=0.5)
    sp.add_argument("--iters", type=int, default=50_000)
    sp.add_argument("--log-step", type=int, default=100)
    sp.add_argument("--batch", type=int, default=200)
    sp.add_argument("--eigh-mode", default="exact",
                    choices=["exact", "subspace", "psd_ns"])
    sp.set_defaults(fn=cmd_pjlearn)

    sp = sub.add_parser("pjsweep", help="PJ hyperparameter grid, one loop")
    common(sp)
    sp.add_argument("--unproj", required=True)
    sp.add_argument("--iters", type=int, default=50_000)
    sp.add_argument("--log-step", type=int, default=100)
    sp.add_argument("--batch", type=int, default=200)
    sp.add_argument("--eigh-mode", default="psd_ns",
                    choices=["exact", "subspace", "psd_ns"],
                    help="psd_ns (grid default) = Newton-Schulz PSD "
                         "projection with an exact eigh at log "
                         "boundaries; exact = reference semantics "
                         "(per-step batched eigh)")
    sp.set_defaults(fn=cmd_pjsweep)

    sp = sub.add_parser("pjstats", help="PJ model ranking")
    common(sp)
    sp.add_argument("--max-dim", type=int, default=80)
    sp.set_defaults(fn=cmd_pjstats)

    sp = sub.add_parser("export", help="emit OpenCV VGG .i header")
    common(sp)
    sp.add_argument("--pr", required=True)
    sp.add_argument("--pj", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("workflow", help="full stages 2-11 with automatic "
                                         "model selection")
    common(sp)
    sp.add_argument("--datasets", required=True)
    sp.add_argument("--pr-iters", type=int, default=50_000_000)
    sp.add_argument("--pr-log-step", type=int, default=1_000_000)
    sp.add_argument("--pj-iters", type=int, default=50_000)
    sp.add_argument("--pj-log-step", type=int, default=100)
    sp.add_argument("--batch", type=int, default=4096)
    sp.add_argument("--max-dim", type=int, default=640)
    sp.set_defaults(fn=cmd_workflow)

    sp = sub.add_parser("e2e", help="reference-scale end-to-end run: "
                                    "3 synthetic Brown-shaped datasets at "
                                    "500k x 5120, full PR/PJ grids at "
                                    "reference budgets, export + summary")
    common(sp)
    sp.add_argument("--n-pairs", type=int, default=500_000)
    sp.add_argument("--pr-iters", type=int, default=50_000_000)
    sp.add_argument("--pj-iters", type=int, default=50_000)
    sp.add_argument("--out-json", default=None)
    sp.set_defaults(fn=cmd_e2e)

    sp = sub.add_parser("sfm", help="two-view SfM on an image pair")
    sp.add_argument("--image1", required=True)
    sp.add_argument("--image2", required=True)
    sp.add_argument("--model", required=True, help="vgg_generated .i header")
    sp.add_argument("--intrinsics", required=True, help="fx,fy,cx,cy")
    sp.add_argument("--keypoints", type=int, default=512)
    sp.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sp.set_defaults(fn=cmd_sfm)

    sp = sub.add_parser("slam", help="monocular SLAM over a KITTI "
                                     "odometry-format sequence")
    sp.add_argument("--root", required=True,
                    help="KITTI root (sequences/<seq>/, poses/)")
    sp.add_argument("--sequence", required=True, help="e.g. 07")
    sp.add_argument("--camera", default="image_0")
    sp.add_argument("--model", required=True, help="vgg_generated .i header")
    sp.add_argument("--keypoints", type=int, default=384)
    sp.add_argument("--ba-window", type=int, default=6)
    sp.add_argument("--loop-gap", type=int, default=12)
    sp.add_argument("--max-frames", type=int, default=None)
    sp.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sp.add_argument("--mesh", default=None,
                    help="distribute the back end over a dp[,mp] mesh of "
                         "the process group's ranks: BA windows over dp, "
                         "the pose graph's edge-sharded normal equations "
                         "summed by all_reduce")
    sp.add_argument("--out", default=None,
                    help="write trajectory + eval JSON here")
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("bench", help="run benchmark suite")
    sp.add_argument("--suite", default="all",
                    help="all, headline, pr, sweep, brown, hinge, stage3, "
                         "pj, pj_soak, precision, slam, slam_long, slam_xl "
                         "or matching")
    sp.add_argument("--out", default=None,
                    help="the details file (JSON; default "
                         "bench_details_torch.json)")
    sp.add_argument("--header", default=None,
                    help="the VGG header (.i) the SLAM suites describe "
                         "with; they are skipped without one")
    sp.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("dist-info", help="show the process topology "
                                          "(after distributed init)")
    sp.add_argument("--device", default="cuda",
                    help="cuda (nccl) or cpu (gloo)")
    sp.set_defaults(fn=cmd_dist_info)

    p.add_argument("--distributed", action="store_true",
                   help="join the process group from DLCO_COORDINATOR/"
                        "DLCO_NUM_PROCESSES/DLCO_PROCESS_ID, or from a "
                        "launcher's WORLD_SIZE/RANK/LOCAL_RANK/MASTER_ADDR/"
                        "MASTER_PORT (torchrun), before running the command "
                        "(DLCO_NUM_PROCESSES alone also joins)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.distributed or os.environ.get("DLCO_NUM_PROCESSES"):
        from .parallel.distributed import distributed_init

        distributed_init(device=getattr(args, "device", "cuda"),
                         detect=args.distributed)
    args.fn(args)


if __name__ == "__main__":
    main()
