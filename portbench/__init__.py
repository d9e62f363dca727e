"""The benchmark of gcn_tpu_torch (``python3 portbench/run.py``)."""
