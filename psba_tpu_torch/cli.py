"""Command-line entry point (the port's counterpart of psba_tpu.cli).

    python -m psba_tpu_torch.cli --cams CAMS.txt --pts PTS.txt [options]

The flags of psba_tpu.cli plus --device (default cuda; --device cpu runs
the plain PyTorch versions). --mesh N splits the points over N processes
(parallel.shard.solve_sharded): N cards over NCCL, or with --device cpu N
CPU processes over gloo. The default precision is float64, which takes
the XLA form (torch ops: cuBLAS DGEMM and cuSOLVER on the card); --f32 runs
the float32 kernel path, and --polish N appends N float64 LM iterations.
Prints the reference program's report block (wall clock, initial / final
error sqrt(L2)/n2Dprojs, iterations, flag and phases) or, with --json, one
JSON line with the reference CLI's keys. The problem summary and the
reader that parsed the input (native or numpy) go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="psba_tpu_torch",
        description="parallel sparse bundle adjustment on PyTorch / CUDA",
    )
    p.add_argument("--cams", help="camera text file")
    p.add_argument("--pts", help="points text file (omit with --synth-pts)")
    p.add_argument("--dataset",
                   help="registered dataset name (see "
                        "psba_tpu_torch.datasets; cams-only BAL sets get "
                        "synthesized points)")
    p.add_argument("--bal", action="store_true",
                   help="treat --cams as a raw BAL problem file")
    p.add_argument("--shared-K", type=float, nargs=5, default=None,
                   metavar=("FU", "U0", "V0", "AR", "S"),
                   help="shared intrinsics for 7-column camera files")
    p.add_argument("--synth-pts", type=int, default=None, metavar="N",
                   help="synthesize N points for a cams-only dataset")
    p.add_argument("--solver", choices=["hybrid", "lm", "tr"],
                   default="hybrid")
    p.add_argument("--max-iters", type=int, default=50)
    p.add_argument("--tau", type=float, default=1e-3)
    p.add_argument("--f32", action="store_true",
                   help="run the float32 kernel path (default float64)")
    p.add_argument("--polish", type=int, default=0, metavar="N",
                   help="append N float64 LM refinement iterations after "
                        "the main run (mixed-precision strategy)")
    p.add_argument("--clamp-quat", action="store_true",
                   help="guard sqrt(1-||v||^2) against NaN")
    p.add_argument("--damping", choices=["auto", "additive", "marquardt"],
                   default="auto",
                   help="LM damping model: additive mu*I (reference "
                        "semantics), multiplicative mu*diag(H), or auto "
                        "(additive unless the Hessian diagonal's range "
                        "would erase its smallest entry in the working "
                        "precision)")
    p.add_argument("--s-precision", choices=["highest", "high"],
                   default="highest",
                   help="precision of the dense Schur products; 'high' "
                        "(the reference's 3-pass products) runs in full "
                        "float32 here, as 'highest' does")
    p.add_argument("--mesh", type=int, default=1,
                   help="shard the points over N processes, one device "
                        "each (N cards over NCCL; with --device cpu, N CPU "
                        "processes over gloo)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the solve (default cuda; cpu runs "
                        "the plain PyTorch versions)")
    p.add_argument("--out-cams", help="write optimized cameras (varK format)")
    p.add_argument("--out-pts", help="write optimized points")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line")
    p.add_argument("--checkpoint",
                   help="checkpoint directory (save / resume)")
    p.add_argument("--verbose", action="store_true",
                   help="print per-iteration progress lines and the phase "
                        "timing report")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh > 1 and (args.checkpoint or args.polish):
        sys.exit("error: --mesh > 1 takes neither --checkpoint nor --polish "
                 "(the sharded solve has no checkpoints and no float64 "
                 "polish)")

    import numpy as np
    import torch

    from psba_tpu_torch.utils.debug import env_nan_checks

    env_nan_checks()  # PSBA_DEBUG_NANS=1: finite checks at every boundary
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("error: --device cuda but torch sees no CUDA device; pass "
                 "--device cpu to run on the CPU")

    from psba_tpu_torch.io import bal_to_problem, load_problem, native
    from psba_tpu_torch.io.synthetic import synthesize_points_for_cams
    from psba_tpu_torch.parallel.shard import solve_sharded
    from psba_tpu_torch.solvers import SolverConfig
    from psba_tpu_torch.solvers.hybrid import solve

    if args.dataset:
        from psba_tpu_torch import datasets

        prob = datasets.load(args.dataset)
    elif not args.cams:
        sys.exit("error: --cams or --dataset required")
    elif args.bal:
        prob = bal_to_problem(args.cams)
    elif args.synth_pts:
        prob = synthesize_points_for_cams(args.cams, n_pts=args.synth_pts)
    else:
        if not args.pts:
            sys.exit("error: --pts required (or use --synth-pts / --bal)")
        prob = load_problem(args.cams, args.pts, shared_K=args.shared_K)
    print(prob.summary(), file=sys.stderr)
    print(f"reader: {native.reader()}", file=sys.stderr)

    dt = torch.float32 if args.f32 else torch.float64
    cfg = SolverConfig.for_dtype(
        dt,
        tau=args.tau,
        max_iters=args.max_iters,
        clamp_quat=args.clamp_quat,
        lm_switch_count=(
            1000 if args.solver == "lm" or args.damping == "marquardt"
            else 5
        ),
        damping=args.damping,
        s_precision=args.s_precision,
        record_history=args.verbose,
    )
    dtype = torch.float32 if args.f32 else None
    if args.mesh > 1:
        # as the reference's CLI: the sharded solve starts in LM whatever
        # --solver says (there it only sets lm_switch_count)
        res = solve_sharded(prob, cfg, n_devices=args.mesh, dtype=dtype,
                            device=args.device)
    else:
        res = solve(prob, cfg, dtype=dtype, device=args.device,
                    start="tr" if args.solver == "tr" else "lm",
                    checkpoint_dir=args.checkpoint, polish_iters=args.polish)
    if args.verbose:
        print(res.format_history(), file=sys.stderr)
        if res.phase_report:
            print(res.phase_report, file=sys.stderr)

    if args.out_cams:
        from psba_tpu_torch.io.sba_text import write_cams

        write_cams(args.out_cams, prob.K, prob.q0, res.cams)
    if args.out_pts:
        np.savetxt(args.out_pts, res.pts, fmt="%.9f")

    if args.json:
        print(json.dumps({
            "initial_error": res.initial_error,
            "final_error": res.final_error,
            "initial_l2": res.initial_l2,
            "final_l2": res.final_l2,
            "rms_px": float(np.sqrt(res.final_l2 / prob.n_obs)),
            "iterations": res.iterations,
            "flag": res.flag_name,
            "wall_s": res.wall_s,
            "phases": res.phases,
        }))
    else:
        # the reference program's report block
        print(f"time eclipse {res.wall_s:.6f} s")
        print(f"initial error: {res.initial_error:.15E}")
        print(f"final error: {res.final_error:.15E}")
        print(f"total iteration: {res.iterations}")
        print(f"flag: {res.flag_name}   phases: {res.phases}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
