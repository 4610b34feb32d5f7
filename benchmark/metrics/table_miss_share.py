"""Share of a step's distinct keys that the table did not hold, from the
port's own counter (``utils.metrics.lookup_hit_rate``), averaged over
the traced steps. Moves ``train_examples_per_s``."""


def read(run):
    if not run.hit_share:
        return None
    return 100.0 * (1.0 - sum(run.hit_share) / len(run.hit_share))
