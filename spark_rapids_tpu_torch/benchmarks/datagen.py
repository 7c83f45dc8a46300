"""TPC-H-shaped table generators (port of the lineitem and part generators
of ``spark_rapids_tpu/benchmarks/datagen.py``).

Rows = ``int(sf * base_rows)``; every table is deterministic per seed.  The
same ``sf`` and seed give the same arrays as the JAX package: the
``RandomState`` draws are the same, made in the same order.  Columns that
the JAX package builds with a Python loop per row (``p_name``,
``p_mfgr``) are built here by indexing a table of the possible values,
which gives the same strings as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import types as T

FLAGS = ["A", "N", "R"]
STATUSES = ["F", "O", "P"]
MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
TYPES = [f"{a} {b} {c}"
         for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                   "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                   "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}"
              for a in ("SM", "MED", "LG", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                        "CAN", "DRUM")]
PART_NOUNS = ["forest", "green", "lemon", "navy", "slate", "rose",
              "royal", "steel", "midnight", "linen"]

_EPOCH_1992 = 8035   # days 1970->1992-01-01
_EPOCH_1999 = 10592  # days 1970->1998-12-31


def gen_lineitem(sf: float, seed: int = 11) -> Dict:
    n = max(1, int(sf * 60_000))
    r = np.random.RandomState(seed)
    qty = r.randint(1, 51, n)
    price = (r.rand(n) * 90000 + 900).round(2)
    disc = (r.randint(0, 11, n) / 100.0)
    tax = (r.randint(0, 9, n) / 100.0)
    return {
        "l_orderkey": (T.LONG, r.randint(1, int(sf * 15_000) + 2, n)),
        "l_partkey": (T.LONG, r.randint(1, int(sf * 2_000) + 2, n)),
        "l_suppkey": (T.LONG, r.randint(1, int(sf * 100) + 2, n)),
        "l_quantity": (T.DOUBLE, qty.astype(np.float64)),
        "l_extendedprice": (T.DOUBLE, price),
        "l_discount": (T.DOUBLE, disc),
        "l_tax": (T.DOUBLE, tax),
        "l_returnflag": (T.STRING, r.choice(FLAGS, n)),
        "l_linestatus": (T.STRING, r.choice(STATUSES, n)),
        "l_shipdate": (T.DATE,
                       r.randint(_EPOCH_1992, _EPOCH_1999, n)),
        "l_commitdate": (T.DATE,
                         r.randint(_EPOCH_1992, _EPOCH_1999, n)),
        "l_receiptdate": (T.DATE,
                          r.randint(_EPOCH_1992, _EPOCH_1999, n)),
        "l_shipmode": (T.STRING, r.choice(MODES, n)),
    }


def gen_part(sf: float, seed: int = 15) -> Dict:
    n = max(1, int(sf * 2_000))
    r = np.random.RandomState(seed)
    idx = r.randint(0, len(PART_NOUNS), (n, 3))
    names = np.array([f"{a} {b} {c}" for a in PART_NOUNS
                      for b in PART_NOUNS for c in PART_NOUNS])
    k = len(PART_NOUNS)
    mfgrs = np.array([f"Manufacturer#{i + 1}" for i in range(5)])
    return {
        "p_partkey": (T.LONG, np.arange(1, n + 1)),
        "p_name": (T.STRING, names[(idx[:, 0] * k + idx[:, 1]) * k
                                   + idx[:, 2]]),
        "p_mfgr": (T.STRING, mfgrs[np.arange(n) % 5]),
        "p_brand": (T.STRING, r.choice(BRANDS, n)),
        "p_type": (T.STRING, r.choice(TYPES, n)),
        "p_size": (T.INT, r.randint(1, 51, n).astype(np.int32)),
        "p_container": (T.STRING, r.choice(CONTAINERS, n)),
        "p_retailprice": (T.DOUBLE, (r.rand(n) * 2000 + 900).round(2)),
    }
