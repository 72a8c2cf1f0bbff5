"""The benchmark of ``fhe_precompiles_tpu_torch`` (see ``run.py``)."""
