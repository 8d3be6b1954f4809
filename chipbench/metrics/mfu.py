"""mfu (%): the frozen training FLOPs of all rounds in the window, over
the window's host-clock time, over the configuration's peak."""


def read(rec):
    if not rec.round_ms or rec.window_s <= 0:
        return None
    return 100.0 * rec.train_flops_per_round * rec.rounds / \
        rec.window_s / rec.peak_flops
