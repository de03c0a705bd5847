"""LM loop: the host's wait on the card per LM iteration, in ms: the time
lm_run spent inside its host reads over its iterations. The program keeps
both totals (psba_tpu_torch.utils.timing.LM) only while a profiler
records, so they cover the traced windows alone; a program without them
gives nothing."""


def read(rec: dict):
    from psba_tpu_torch.utils import timing

    lm = getattr(timing, "LM", None)
    if lm is None or not lm.iters:
        return None
    return 1e-6 * lm.wait_ns / lm.iters
