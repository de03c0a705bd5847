"""Speed-of-light (roofline) model of the dense3 LM iteration on the card
(PyTorch counterpart of psba_tpu.utils.roofline).

Per-stage operation and device-memory byte counts as closed-form functions
of the problem shape (C cameras, P points, O observed cells), evaluated
against a card's peak rates, so that a measured stage or iteration time
can be stated as a share of its bound and classed as bound by memory
bytes, by matrix products or by the rest of the arithmetic.

Counting conventions
  - bytes: each array a stage's kernels or torch ops read or write, once
    per read and once per write; the port's torch ops run one kernel each,
    so an intermediate that one op writes and the next reads counts twice
    (ZY3, the S accumulator), while what one of the
    hand-written kernels keeps on chip counts once. The dense arrays have
    the port's layout: [C, P] observation tables, planar [6C, Pp] ZW planes
    and [3, 3, Pp] / [3, Pp] point arrays, Pp = P padded to the 128-point
    tile (ops.linearize_dense.padded_points).
  - flops_matmul: the S matrix products (cuBLAS), at the float32 rate of
    the CUDA cores under either s_precision: the port runs "high" in full
    float32 too (core.schur), so `precision` takes both names and both
    give the same counts and rates.
  - flops_elem: everything else, one per float32 operation, at the same
    rate: the kernels' per-cell counts (below, counted from csrc/), the
    elementwise torch ops and the matrix-vector products.

The reference counts the same stages on a TPU; its operation counts are
kept where the work is the same (its P is the planar width here, Pp).
"""

from __future__ import annotations

from dataclasses import dataclass, field

PTILE = 128  # ops.linearize_dense.PTILE: the planar point tile

# float32 operations per observed cell or observation, counted from
# csrc/cell_model.cuh and each kernel's own arithmetic: residual and forward
# model 86, Jacobian rows 211 (cell_linearize about 300 in all)
CELL_LINEARIZE_FLOPS = 300
CELL_RESIDUAL_FLOPS = 86
# the dense grid: W = A^T B (54), V (24), gb (12), U (84), ga (24)
LINEARIZE_DENSE_FLOPS = CELL_LINEARIZE_FLOPS + 198
LINEARIZE_DENSE_U_FLOPS = 84 + 24
# two residuals and the factored gain / new_l2 sums
GAIN_DENSE_FLOPS = 2 * CELL_RESIDUAL_FLOPS + 8
# the stream with the TR flags: mask (20), U (84), ga (24), l2 (4)
LINEARIZE_STREAM_FLOPS = CELL_LINEARIZE_FLOPS + 132
# the trial-step residual and its masked square (4); with the old residual
# also the masked factored gain (eo - en)(eo + en) summed over two rows (9)
RESIDUAL_L2_FLOPS = CELL_RESIDUAL_FLOPS + 4
RESIDUAL_L2_GAIN_FLOPS = RESIDUAL_L2_FLOPS + 9
# the stream with the pair path's flags: W = A^T B (54), B^T B (27),
# B^T ex (12), the mask of B (6)
PAIR_STREAM_FLOPS = LINEARIZE_STREAM_FLOPS + 99

@dataclass(frozen=True)
class ChipPeaks:
    """Peak rates of one card."""

    name: str
    hbm_gbps: float       # device memory bandwidth, GB/s
    f32_tflops: float     # float32 on the CUDA cores (no tensor cores)

    def matmul_tflops(self, precision: str = "highest") -> float:
        """The rate of the S products at an s_precision: float32 on the
        CUDA cores for both "highest" and "high" (module docstring)."""
        if precision not in ("highest", "high"):
            raise ValueError(f"precision {precision!r}: 'highest' or 'high'")
        return self.f32_tflops


# NVIDIA H100 SXM5 80GB HBM3 (NVIDIA's data sheet, dense rates, at the
# 700 W power limit): HBM3 3.35 TB/s, float32 67 TFLOP/s
H100 = ChipPeaks(name="NVIDIA H100 SXM5 80GB HBM3", hbm_gbps=3350.0,
                 f32_tflops=67.0)


@dataclass
class StageCost:
    """Operations and device-memory bytes of one stage at a fixed shape."""

    name: str
    bytes: float = 0.0
    flops_matmul: float = 0.0
    flops_elem: float = 0.0
    # data-dependent sequential steps the stage cannot avoid (the
    # Cholesky's columns): a latency floor no roofline term captures
    seq_steps: int = 0

    def terms(self, peaks: ChipPeaks = H100,
              precision: str = "highest") -> dict:
        """Seconds of each hardware term."""
        return {
            "hbm": self.bytes / (peaks.hbm_gbps * 1e9),
            "matmul": self.flops_matmul / (peaks.matmul_tflops(precision)
                                           * 1e12),
            "elementwise": self.flops_elem / (peaks.f32_tflops * 1e12),
        }

    def ms(self, peaks: ChipPeaks = H100, precision: str = "highest") -> float:
        """Speed-of-light time: the largest of the three terms."""
        return max(self.terms(peaks, precision).values()) * 1e3

    def bound(self, peaks: ChipPeaks = H100,
              precision: str = "highest") -> str:
        terms = self.terms(peaks, precision)
        return max(terms, key=terms.get)


def padded_points(P: int) -> int:
    return -(-P // PTILE) * PTILE


def lm_stage_costs(C: int, P: int, O: int,
                   itemsize: int = 4) -> dict[str, StageCost]:
    """Per-stage costs of one LM iteration of the dense3 float32 path
    (solvers.lm.lm_run's kernel branch on the dense encoding), plus the
    pair path's two stream kernels, which the dense aggregate leaves out.
    The same under either s_precision (module docstring)."""
    b = itemsize
    Pp = padded_points(P)
    cam_rows = 15 * C            # K | q0 | cams
    costs: dict[str, StageCost] = {}

    # csrc/linearize_dense.cu, grid kernel + finishing kernel: reads the
    # camera rows, the points and the three [C, P] observation tables;
    # writes the planar ZW [3, 6C, Pp], V [3, 3, Pp], gb [3, Pp], U, ga
    costs["linearize_dense"] = StageCost(
        "linearize_dense",
        bytes=(cam_rows + 3 * P + 3 * C * P + 18 * C * Pp + 12 * Pp
               + 42 * C) * b,
        flops_elem=LINEARIZE_DENSE_FLOPS * O,
    )
    # the reference's separate U / ga lane reduction: the port's finishing
    # kernel sums U / ga inside the linearize_dense launch, counted there
    costs["u_ga_reduce"] = StageCost("u_ga_reduce")
    # --- per try -----------------------------------------------------------
    # U + mu I, Vp + mu I: torch ops, read and write each
    costs["damp_uv"] = StageCost(
        "damp_uv", bytes=(2 * (36 * C + 9 * Pp)) * b,
        flops_elem=6 * C + 3 * Pp,
    )
    # core.schur.inv3x3_planar3: the six upper-triangle planes in, the
    # nine planes of the inverse out (the pivoted fallback only runs for
    # blocks that need it, none in the steady state)
    costs["inv3x3"] = StageCost(
        "inv3x3", bytes=(6 * Pp + 9 * Pp) * b, flops_elem=60.0 * Pp,
    )
    # core.schur.schur_S_dense3: ZY_j = sum_m ZW_m * Vinv[m, j] (torch
    # FMAs: ZW3 and Vinv in, ZY3 out), the products ZY_j @ ZW_j^T (cuBLAS:
    # ZY3 and ZW3 in, the [6C, 6C] accumulator out, then in and out again
    # for each further product), S = -off + blockdiag(U) (in, out)
    costs["schur_S_dense"] = StageCost(
        "schur_S_dense",
        bytes=(18 * C * Pp + 9 * Pp + 18 * C * Pp      # ZY3
               + 2 * 18 * C * Pp                        # the operands
               + 5 * 36 * C * C                         # the accumulator
               + 2 * 36 * C * C + 36 * C) * b,          # S
        flops_matmul=2.0 * (6 * C) * (6 * C) * (3 * Pp),
        flops_elem=2.0 * 27 * C * Pp,
    )
    # core.schur.reduced_rhs_dense3: three float32 gemvs (ZY3 and gbp in)
    costs["reduced_rhs_dense"] = StageCost(
        "reduced_rhs_dense", bytes=(18 * C * Pp + 3 * Pp + 6 * C) * b,
        flops_elem=36.0 * C * Pp,
    )
    # csrc/cholesky.cu: S and b in, x and the ok flag out; 6C columns in
    # sequence
    costs["spd_solve"] = StageCost(
        "spd_solve", bytes=(36 * C * C + 12 * C + 1) * b,
        flops_elem=(6 * C) ** 3 / 3.0 + 2.0 * (6 * C) ** 2,
        seq_steps=6 * C,
    )
    # core.schur.back_substitute_dense3: three gemvs dpa^T ZW_j (ZW3 in),
    # eb_j = gbp_j - ... (out, then in), dpb = Vinv eb (Vinv in, dpb out)
    costs["back_substitute"] = StageCost(
        "back_substitute",
        bytes=(18 * C * Pp + 6 * C + 3 * Pp + 2 * 3 * Pp + 9 * Pp
               + 3 * Pp) * b,
        flops_elem=36.0 * C * Pp + 18.0 * Pp,
    )
    # csrc/gain_dense.cu: old and new camera rows and points, the three
    # observation tables in; gain and new L2 out
    costs["gain_dense"] = StageCost(
        "gain_dense",
        bytes=(cam_rows + 6 * C + 6 * P + 3 * C * P + 2) * b,
        flops_elem=GAIN_DENSE_FLOPS * O,
    )
    # new parameters, the dots of the acceptance test (torch ops)
    costs["accept_bookkeeping"] = StageCost(
        "accept_bookkeeping", bytes=(6 * (6 * C + 3 * P)) * b,
        flops_elem=12.0 * (C + P),
    )
    # the pair path's kernels (not in the dense aggregate): csrc/
    # linearize_stream.cu with the pair flags (camera rows, points, obs,
    # the index streams in; ex, A, B, W and the point sums out) and
    # csrc/residual_l2.cu with the gain (camera rows, points, obs, indices
    # and the old residual in; the residual out)
    costs["linearize_stream"] = StageCost(
        "linearize_stream",
        bytes=(cam_rows + 3 * P + O * (2 + 1 + 1 + 2 + 18) + 12 * P) * b,
        flops_elem=PAIR_STREAM_FLOPS * O,
    )
    costs["residual_l2"] = StageCost(
        "residual_l2",
        bytes=(cam_rows + 3 * P + O * (2 + 1 + 1 + 2 + 2)) * b,
        flops_elem=RESIDUAL_L2_GAIN_FLOPS * O,
    )
    return costs


# stages that run once per outer iteration vs once per damping try (the
# dense3 path: one grid linearization, no observation stream)
OUTER_STAGES = ("linearize_dense", "u_ga_reduce")
RETRY_STAGES = (
    "damp_uv", "inv3x3", "schur_S_dense", "reduced_rhs_dense", "spd_solve",
    "back_substitute", "gain_dense", "accept_bookkeeping",
)


@dataclass
class IterRoofline:
    """Speed-of-light summary of one LM iteration."""

    stage_ms: dict
    total_ms: float
    bytes: float
    flops_matmul: float
    flops_elem: float
    bound: str
    seq_steps: int
    peaks: ChipPeaks = field(default=None)


def lm_iter_roofline(C: int, P: int, O: int, peaks: ChipPeaks = H100,
                     retries: float = 1.0, itemsize: int = 4,
                     precision: str = "highest") -> IterRoofline:
    """Roofline of one LM iteration = the outer stages + `retries` x the
    try chain (1 = the accepted-step steady state), each stage at its own
    bound, summed."""
    costs = lm_stage_costs(C, P, O, itemsize=itemsize)
    stage_ms = {}
    tot_b = tot_m = tot_e = 0.0
    seq = 0
    for name in OUTER_STAGES + RETRY_STAGES:
        c = costs[name]
        k = 1.0 if name in OUTER_STAGES else retries
        stage_ms[name] = k * c.ms(peaks, precision)
        tot_b += k * c.bytes
        tot_m += k * c.flops_matmul
        tot_e += k * c.flops_elem
        seq += int(k * c.seq_steps)
    agg = StageCost("iter", bytes=tot_b, flops_matmul=tot_m,
                    flops_elem=tot_e)
    return IterRoofline(
        stage_ms=stage_ms, total_ms=sum(stage_ms.values()), bytes=tot_b,
        flops_matmul=tot_m, flops_elem=tot_e,
        bound=agg.bound(peaks, precision), seq_steps=seq, peaks=peaks,
    )


def summarize(C: int, P: int, O: int, measured_iter_ms: float,
              peaks: ChipPeaks = H100, retries: float = 1.0,
              precision: str = "highest") -> dict:
    """A measured iteration time against the roofline.

    mfu        : the S products' operations over the time, as a share of
                 the matrix-product peak at `precision` (the name of the
                 LLM convention; small here, since a BA iteration is not
                 product-bound)
    hbm_frac   : achieved device-memory bandwidth / peak
    sol_frac   : roofline_ms / measured_ms. Can exceed 1: the model sums
                 the stages' bounds, while the card may overlap stages
    bound      : the term that binds the roofline ("hbm", "matmul",
                 "elementwise"), or "latency" where the measured time is
                 above twice the roofline

    Raises ValueError on a non-positive measurement: such a time is a
    broken measurement, and fractions derived from it are noise with a
    sign."""
    if not measured_iter_ms > 0.0:
        raise ValueError(
            f"measured_iter_ms={measured_iter_ms!r} is not positive: the "
            "measurement is invalid; refuse it rather than derive negative "
            "mfu / hbm_frac from it"
        )
    r = lm_iter_roofline(C, P, O, peaks=peaks, retries=retries,
                         precision=precision)
    t = measured_iter_ms * 1e-3
    sol = r.total_ms / measured_iter_ms
    return {
        "roofline_iter_ms": round(r.total_ms, 4),
        "sol_frac": round(sol, 4),
        "mfu": round(r.flops_matmul / t
                     / (peaks.matmul_tflops(precision) * 1e12), 6),
        "hbm_frac": round(r.bytes / t / (peaks.hbm_gbps * 1e9), 4),
        "bound": r.bound if sol > 0.5 else "latency",
        "seq_steps_per_iter": r.seq_steps,
        "chip": peaks.name,
    }
