"""Tiered memory: device -> host -> disk spill (port of
``spark_rapids_tpu/mem/``)."""
