"""SQL front end: lexer and recursive-descent parser producing the port's
DataFrames (port of ``spark_rapids_tpu/sql``)."""
