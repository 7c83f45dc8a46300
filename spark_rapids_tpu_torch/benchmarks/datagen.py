"""TPC-H-shaped table generators (port of
``spark_rapids_tpu/benchmarks/datagen.py``: lineitem, orders, customer,
supplier, part, partsupp, region and nation, and ``register_tpch``).

Rows = ``int(sf * base_rows)``; every table is deterministic per seed.  The
same ``sf`` and seed give the same arrays as the JAX package: the
``RandomState`` draws are the same, made in the same order.  Columns that
the JAX package builds with a Python loop per row (``p_name``,
``p_mfgr``, ``c_name``, ``c_phone``, ``s_name``) are built here with
numpy, which gives the same strings as numpy arrays.
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
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
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
        "c_name": (T.STRING, _numbered("Customer#", n)),
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


def _numbered(prefix: str, n: int):
    """``prefix`` followed by 1..n zero-padded to nine digits."""
    return np.char.add(prefix,
                       np.char.zfill(np.arange(1, n + 1).astype(str), 9))


def gen_supplier(sf: float, seed: int = 14) -> Dict:
    n = max(1, int(sf * 100))
    r = np.random.RandomState(seed)
    return {
        "s_suppkey": (T.LONG, np.arange(1, n + 1)),
        "s_name": (T.STRING, _numbered("Supplier#", n)),
        "s_nationkey": (T.INT, r.randint(0, len(NATIONS), n)),
        "s_acctbal": (T.DOUBLE, (r.rand(n) * 11000 - 1000).round(2)),
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


def gen_partsupp(sf: float, seed: int = 16) -> Dict:
    n_part = max(1, int(sf * 2_000))
    n_supp = max(1, int(sf * 100))
    # 4 distinct suppliers per part, the TPC-H shape ((partkey, suppkey)
    # is the table's primary key)
    pk = np.repeat(np.arange(1, n_part + 1), 4)
    offset = np.tile(np.arange(4), n_part)
    sk = (pk * 7 + offset * max(1, n_supp // 4)) % n_supp + 1
    r = np.random.RandomState(seed)
    n = len(pk)
    return {
        "ps_partkey": (T.LONG, pk),
        "ps_suppkey": (T.LONG, sk),
        "ps_availqty": (T.INT, r.randint(1, 10_000, n).astype(np.int32)),
        "ps_supplycost": (T.DOUBLE, (r.rand(n) * 1000 + 1).round(2)),
    }


def gen_region() -> Dict:
    n = len(REGIONS)
    return {
        "r_regionkey": (T.INT, np.arange(n, dtype=np.int32)),
        "r_name": (T.STRING, np.array(REGIONS)),
    }


def gen_nation() -> Dict:
    n = len(NATIONS)
    return {
        "n_nationkey": (T.INT, np.arange(n, dtype=np.int32)),
        "n_name": (T.STRING, np.array(NATIONS)),
        "n_regionkey": (T.INT, (np.arange(n) % 5).astype(np.int32)),
    }


def register_tpch(session, sf: float = 0.01, num_partitions: int = 4):
    """Create every TPC-H-like table and register it as a temp view."""
    for name, data in [
        ("lineitem", gen_lineitem(sf)),
        ("orders", gen_orders(sf)),
        ("customer", gen_customer(sf)),
        ("supplier", gen_supplier(sf)),
        ("nation", gen_nation()),
        ("part", gen_part(sf)),
        ("partsupp", gen_partsupp(sf)),
        ("region", gen_region()),
    ]:
        df = session.create_dataframe(data, num_partitions=num_partitions)
        df.create_or_replace_temp_view(name)
