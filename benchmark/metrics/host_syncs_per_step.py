"""Synchronizing CUDA calls of one training step (torch.cuda's sync debug
mode, over a few steps after the traced ones): each is a point where the
host waits for the card. Moves ``train_examples_per_s``."""


def read(run):
    return run.syncs_per_step
