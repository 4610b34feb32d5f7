"""Device ms per step outside the table's two ranges: the dense forward
and backward, the loss, the dense optimizer and the keys' tagging. Moves
``train_examples_per_s``."""


def read(run):
    if not run.steps or run.busy_s <= 0:
        return None
    table = sum(run.range_device_s.values())
    rest = sum(run.device_ops.values()) - table
    return rest / run.steps * 1e3 if rest > 0 else None
