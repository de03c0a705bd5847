#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload ladybug138.lm \
        --seeds 11,12,13 --seconds 2 [--control-seeds 11,12,13]

For each seed, in one process: the cell's inputs, the program set up and
driven for a short window as a run drives it, then the numbers compared
for its answers against the float64 reference (the lower readings), and
two numbers that are printed and not compared: step_err (the answer's
distance from the reference's in the parameters, worst of cameras and
points, over the reference's step) and l2_gap (|L2(p) - L2(p_ref)| /
L2(p_ref)). For each control seed also the control, the reference computed
in float32 with TF32 products put in the program's place, and the
reference in float32 with exact products (for comparison). One JSON line
per seed on standard output.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def unjudged(check, a: dict) -> dict:
    """step_err and l2_gap of the answer `a` against the check's
    reference."""
    import torch

    f64 = torch.float64
    c = torch.as_tensor(a["cams"], dtype=f64, device=check.device)
    p = torch.as_tensor(a["pts"], dtype=f64, device=check.device)
    cost = lambda cams, pts: float((check.r64.residual(cams, pts) ** 2)
                                   .sum())
    step = max(float(torch.linalg.norm(c - check.cams))
               / float(torch.linalg.norm(check.cams - check.cams0)),
               float(torch.linalg.norm(p - check.pts))
               / float(torch.linalg.norm(check.pts - check.pts0)))
    l2 = cost(check.cams, check.pts)
    return dict(step_err=step, l2_gap=abs(cost(c, p) - l2) / l2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.gen.ring import ring_problem

    spec = harness.cell(args.workload)
    config, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    drv = harness.driver(spec)
    cuda = args.device == "cuda"
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        arrays = ring_problem(config["n_cams"], config["n_pts"],
                              config["n_obs"], seed, args.device,
                              config["assumed"])
        prog = drv.Program(arrays, config, traffic, args.device)
        prog.step()
        window_s, iters, repeats, kept = harness.run_window(
            prog, drv.SPAN, args.seconds, seed, False, cuda)
        answers = [prog.answer(k) for k in kept.values()]
        del kept, prog
        if cuda:
            torch.cuda.empty_cache()
        check = drv.Check(arrays, config, traffic, args.device)
        nums = [dict(check.numbers(a), **unjudged(check, a))
                for a in answers]
        line = dict(seed=seed, O=len(arrays["obs"]),
                    ms_per_iter=1e3 * window_s / iters,
                    answers=len(answers),
                    reference=check.summary,
                    program={k: max(n[k] for n in nums) for k in nums[0]},
                    correct=harness.judge(check, answers, limits)[1] == 0)
        if seed in control:
            for name, mm in (("control_tf32", "tf32"),
                             ("float32_exact", "exact")):
                other = drv.Check(arrays, config, traffic, args.device,
                                  matmul=mm, dtype="float32")
                a = other.as_answer()
                line[name] = dict(check.numbers(a), **unjudged(check, a))
                line[name + "_tries"] = other.summary["tries"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
