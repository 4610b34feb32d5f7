"""The port's counterparts of the JAX package's ``examples/*.py``: the
same command lines and result lines, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions). Each module has
``main(argv) -> int`` and runs as a script:

    python -m recommenders_addons_tpu_torch.examples.dlrm_train --data day.tsv
    python -m recommenders_addons_tpu_torch.examples.movielens_train --device cpu
"""
