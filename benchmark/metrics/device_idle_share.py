"""Share of the traced window in which no kernel, copy or fill ran on the
card. Moves ``train_examples_per_s``."""


def read(run):
    if run.window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
