"""Command-line interface of the port: stages 1-6 over a Workspace directory.

The subcommands and flags of ``opencv_dlco_tpu.cli`` for the stages the
port carries; each stage is idempotent (resume-safe). Runs on the CUDA
device.

Usage examples:
    python -m opencv_dlco_tpu_torch.cli convert  -w ws --dataset liberty --patch-dir /data/liberty
    python -m opencv_dlco_tpu_torch.cli genpr    -w ws
    python -m opencv_dlco_tpu_torch.cli compdist -w ws --dataset liberty
    python -m opencv_dlco_tpu_torch.cli prlearn  -w ws --dataset liberty --mu 0.025 --gamma 0.1
    python -m opencv_dlco_tpu_torch.cli prsweep  -w ws --dataset liberty
    python -m opencv_dlco_tpu_torch.cli prstats  -w ws --datasets liberty,notredame
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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
