"""LM loop: the host's own time per LM iteration, in ms: lm_run's host
time less its wait in the host reads (Python, dispatch and launches), over
its iterations. The program keeps the totals (psba_tpu_torch.utils.timing.
LM) only while a profiler records, so they cover the traced windows alone;
a program without them gives nothing."""


def read(rec: dict):
    from psba_tpu_torch.utils import timing

    lm = getattr(timing, "LM", None)
    if lm is None or not lm.iters:
        return None
    return 1e-6 * (lm.run_ns - lm.wait_ns) / lm.iters
