"""Path expansion, Hive partition discovery and schema inference for file
sources (port of ``spark_rapids_tpu/io/discovery.py``)."""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List

from spark_rapids_tpu_torch import types as T

_EXTS = {"parquet": (".parquet", ".parq"), "csv": (".csv",),
         "orc": (".orc",)}


def expand_paths(paths: List[str], fmt: str) -> List[str]:
    """Files under ``paths``: a directory is walked (names starting with
    ``_`` or ``.`` skipped, the format's extensions kept), a glob
    expanded, a file kept as given."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for n in sorted(names):
                    if n.startswith(("_", ".")):
                        continue
                    if n.endswith(_EXTS.get(fmt, ())):
                        files.append(os.path.join(root, n))
        elif any(ch in p for ch in "*?["):
            files.extend(sorted(glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no {fmt} files found in {paths}")
    return files


HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def discover_partitions(paths: List[str], files: List[str]):
    """Hive-layout partition discovery: ``key=value`` directory components
    under the scan roots become partition columns.

    Returns (partition_schema, {file: [typed values...]}) or None when the
    layout is not a consistent key=value tree.  A key whose values all
    parse as ints is LONG, else as floats DOUBLE, else STRING;
    ``__HIVE_DEFAULT_PARTITION__`` is NULL.
    """
    roots = [os.path.abspath(p) for p in paths if os.path.isdir(p)]
    if not roots:
        return None
    keys_order: List[str] = None
    raw: Dict[str, List[str]] = {}
    for f in files:
        af = os.path.abspath(f)
        comps = None
        for r in roots:
            if af.startswith(r + os.sep):
                rel = os.path.relpath(os.path.dirname(af), r)
                comps = [] if rel == "." else rel.split(os.sep)
                break
        if comps is None:
            return None
        kv = []
        for c in comps:
            if "=" not in c:
                return None
            k, _, v = c.partition("=")
            kv.append((k, v))
        ks = [k for k, _ in kv]
        if keys_order is None:
            keys_order = ks
        elif keys_order != ks:
            return None
        raw[f] = [v for _, v in kv]
    if not keys_order:
        return None

    def typed(values: List[str]):
        non_null = [v for v in values if v != HIVE_DEFAULT_PARTITION]
        for dtype, conv in ((T.LONG, int), (T.DOUBLE, float)):
            try:
                [conv(v) for v in non_null]
            except ValueError:
                continue
            return dtype, (lambda v, c=conv: None
                           if v == HIVE_DEFAULT_PARTITION else c(v))
        return T.STRING, (lambda v: None if v == HIVE_DEFAULT_PARTITION
                          else v)

    fields, convs = [], []
    for i, k in enumerate(keys_order):
        dt, conv = typed([raw[f][i] for f in files])
        fields.append(T.Field(k, dt))
        convs.append(conv)
    file_values = {
        f: [conv(v) for conv, v in zip(convs, raw[f])] for f in files}
    return T.Schema(fields), file_values


def infer_schema(fmt: str, files: List[str],
                 options: Dict[str, Any]) -> T.Schema:
    """The first file's schema (a CSV file is read whole to infer it)."""
    from spark_rapids_tpu_torch.io.arrow_convert import schema_from_arrow
    if fmt == "parquet":
        import pyarrow.parquet as pq
        return schema_from_arrow(pq.read_schema(files[0]))
    if fmt == "orc":
        import pyarrow.orc as orc
        return schema_from_arrow(orc.ORCFile(files[0]).schema)
    if fmt == "csv":
        import pyarrow.csv as pacsv
        read_opts, parse_opts, conv_opts = csv_options(options)
        tb = pacsv.read_csv(files[0], read_options=read_opts,
                            parse_options=parse_opts,
                            convert_options=conv_opts)
        return schema_from_arrow(tb.schema)
    raise ValueError(f"unknown format {fmt}")


def csv_options(options: Dict[str, Any]):
    """pyarrow's (read, parse, convert) options from the reader's
    ``header``, ``sep``/``delimiter`` and ``nullValue``."""
    import pyarrow.csv as pacsv
    header = str(options.get("header", "true")).lower() == "true"
    sep = options.get("sep", options.get("delimiter", ","))
    read_opts = pacsv.ReadOptions(autogenerate_column_names=not header)
    parse_opts = pacsv.ParseOptions(delimiter=sep)
    conv_opts = pacsv.ConvertOptions(
        null_values=[options.get("nullValue", "")],
        strings_can_be_null=True)
    return read_opts, parse_opts, conv_opts
