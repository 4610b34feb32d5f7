"""How the harness builds the system under test for a configuration's
``family``: ``benchmark/systems/<family>.py`` defines ``build(cfg,
device)``, returning the port's model object for that configuration."""

import importlib


def load(family: str):
    return importlib.import_module(f"benchmark.systems.{family}")
