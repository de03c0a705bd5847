"""LM loop: host reads per LM iteration, each a wait for the card: the
reads lm_run made through its one read helper over its iterations. The
program keeps the totals (psba_tpu_torch.utils.timing.LM) only while a
profiler records, so they cover the traced windows alone; a program
without them gives nothing."""


def read(rec: dict):
    from psba_tpu_torch.utils import timing

    lm = getattr(timing, "LM", None)
    if lm is None or not lm.iters:
        return None
    return lm.reads / lm.iters
