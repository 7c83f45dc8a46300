"""File sources of the port: discovery, Arrow conversion, the decode pool
and the two scan execs (port of ``spark_rapids_tpu/io/``, writers not
ported)."""
