"""Model: the whole step's share of the card's peak, %: the least time of
each untraced step of the window (the larger of its FLOPs at the bf16
tensor peak and its bytes at the HBM rate, ``yardstick.step_work``) over
the steps' measured time."""

from bench.yardstick import BF16_OPS_PER_S, bound, step_work


def read(run):
    least = spent = 0.0
    by = {}
    for s in run.steps:
        if s.profiled:
            continue
        taken = None
        if run.picked is not None and s.segment == 0 \
                and s.position < run.picked.shape[0]:
            taken = run.picked[s.position].tolist()
        b, f, _ = step_work(run.m, run.B, s.position, taken)
        ms, which = bound(b, f, BF16_OPS_PER_S)
        by[which] = by.get(which, 0) + 1
        least += ms
        spent += s.ms
    run.mfu_bound_by = by
    return 100.0 * least / spent if spent else None
