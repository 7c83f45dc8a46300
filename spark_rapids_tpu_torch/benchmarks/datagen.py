"""TPC-H-shaped table generators (port of the lineitem, orders, customer
and part generators of ``spark_rapids_tpu/benchmarks/datagen.py``).

Rows = ``int(sf * base_rows)``; every table is deterministic per seed.  The
same ``sf`` and seed give the same arrays as the JAX package: the
``RandomState`` draws are the same, made in the same order.  Columns that
the JAX package builds with a Python loop per row (``p_name``,
``p_mfgr``, ``c_name``, ``c_phone``) are built here with numpy, which
gives the same strings as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import types as T

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
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
NATIONS = ["ALGERIA", "BRAZIL", "CANADA", "EGYPT", "FRANCE", "GERMANY",
           "INDIA", "JAPAN", "KENYA", "PERU", "CHINA", "ROMANIA"]
PART_NOUNS = ["forest", "green", "lemon", "navy", "slate", "rose",
              "royal", "steel", "midnight", "linen"]
PHONE_CODES = ["13", "17", "18", "23", "29", "30", "31", "32", "33"]

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


def gen_orders(sf: float, seed: int = 12) -> Dict:
    n = max(1, int(sf * 15_000))
    r = np.random.RandomState(seed)
    return {
        "o_orderkey": (T.LONG, np.arange(1, n + 1)),
        "o_custkey": (T.LONG, r.randint(1, int(sf * 1_500) + 2, n)),
        "o_orderstatus": (T.STRING, r.choice(STATUSES, n)),
        "o_totalprice": (T.DOUBLE, (r.rand(n) * 500000).round(2)),
        "o_orderdate": (T.DATE, r.randint(_EPOCH_1992, _EPOCH_1999, n)),
        "o_orderpriority": (T.STRING, r.choice(PRIORITIES, n)),
        "o_shippriority": (T.INT, np.zeros(n, dtype=np.int32)),
    }


def gen_customer(sf: float, seed: int = 13) -> Dict:
    n = max(1, int(sf * 1_500))
    r = np.random.RandomState(seed)
    return {
        "c_custkey": (T.LONG, np.arange(1, n + 1)),
        "c_name": (T.STRING, np.char.add(
            "Customer#", np.char.zfill(np.arange(1, n + 1).astype(str), 9))),
        "c_nationkey": (T.INT, r.randint(0, len(NATIONS), n)),
        "c_mktsegment": (T.STRING, r.choice(SEGMENTS, n)),
        "c_acctbal": (T.DOUBLE, (r.rand(n) * 10000 - 1000).round(2)),
        "c_phone": (T.STRING, _gen_phones(r, n)),
    }


def _gen_phones(r, n):
    """``CC-AAA-BBB-CCCC`` phone numbers, drawn as the JAX package draws
    them and joined by numpy."""
    code = r.randint(0, len(PHONE_CODES), n)
    parts = [np.asarray(PHONE_CODES)[code], r.randint(100, 999, n),
             r.randint(100, 999, n), r.randint(1000, 9999, n)]
    out = parts[0]
    for p in parts[1:]:
        out = np.char.add(np.char.add(out, "-"), p.astype(str))
    return out


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
