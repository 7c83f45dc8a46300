"""TPC-DS-like tables and queries the port runs as SQL text: a copy of
``spark_rapids_tpu/benchmarks/tpcds_like.py`` (its generators, which give
the same arrays for the same sf, ``build_tables``, and all 105 texts: the
reference's 103-query list plus ``q14`` and ``ss_max``), with
``register_tpcds`` over the port's session.  The reference's description:

TPC-DS-like star-schema benchmark: synthetic store_sales fact + item /
date_dim / customer / store dimensions, and query definitions shaped like
the TPC-DS reporting set (TpcdsLikeSpark analogue,
integration_tests/.../TpcdsLikeSpark.scala — adapted to the engine's
type/op envelope the same way TpchLike is).

Query shapes covered: dimension-filtered fact scans with multi-way joins,
group-by + order-by + limit reporting rollups (q3/q42/q52/q55 family),
multi-aggregate demographic profiles (q7), two-level aggregation with a
HAVING-style post-filter (q65 family), windowed category shares
(q53/q89/q98), year-over-year self joins (q2/q59), rollup-via-union
(q22), three-branch channel unions (q14/q33), running cumulative windows
(q51), semi-join frequent-buyer selection (q34), premium-vs-average
subquery joins (q92), return-adjusted left joins (q93), and INTERSECT/
EXCEPT customer-overlap counts (q38/q87).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import types as T

BRANDS = [f"brand#{i}" for i in range(1, 21)]
CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Men", "Music",
              "Shoes", "Sports", "Toys", "Women"]
STATES = ["CA", "GA", "IL", "NY", "TX", "WA"]
EDU = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree"]
CLASSES = [f"class#{i}" for i in range(1, 9)]
CITIES = ["Midway", "Fairview", "Oakland", "Salem", "Georgetown",
          "Greenville", "Springdale", "Riverside"]
COUNTIES = [f"{c} County" for c in
            ["Orange", "Walker", "Daviess", "Ziebach", "Barrow", "Luce"]]

# date_dim spans 1998-1999 weekly granularity style: d_date_sk is a dense key


def gen_date_dim() -> Dict:
    n = 730  # two years of days
    sk = np.arange(1, n + 1)
    year = np.where(sk <= 365, 1998, 1999)
    doy = np.where(sk <= 365, sk, sk - 365)
    moy = np.minimum((doy - 1) // 30 + 1, 12)
    return {
        "d_date_sk": (T.LONG, sk),
        "d_year": (T.INT, year.astype(np.int32)),
        "d_moy": (T.INT, moy.astype(np.int32)),
        "d_dom": (T.INT, ((doy - 1) % 30 + 1).astype(np.int32)),
        "d_qoy": (T.INT, ((moy - 1) // 3 + 1).astype(np.int32)),
        "d_week_seq": (T.INT, ((sk - 1) // 7 + 1).astype(np.int32)),
    }


def gen_item(sf: float, seed: int = 21) -> Dict:
    n = max(10, int(sf * 2_000))
    r = np.random.RandomState(seed)
    return {
        "i_item_sk": (T.LONG, np.arange(1, n + 1)),
        "i_brand": (T.STRING, r.choice(BRANDS, n)),
        "i_category": (T.STRING, r.choice(CATEGORIES, n)),
        "i_class": (T.STRING, r.choice(CLASSES, n)),
        "i_manufact_id": (T.INT, r.randint(1, 100, n).astype(np.int32)),
        "i_current_price": (T.DOUBLE, (r.rand(n) * 99 + 1).round(2)),
    }


def gen_customer(sf: float, seed: int = 22) -> Dict:
    n = max(10, int(sf * 1_000))
    r = np.random.RandomState(seed)
    return {
        "c_customer_sk": (T.LONG, np.arange(1, n + 1)),
        "c_birth_year": (T.INT, r.randint(1924, 1992, n).astype(np.int32)),
        "c_education": (T.STRING, r.choice(EDU, n)),
        "c_state": (T.STRING, r.choice(STATES, n)),
        "c_current_addr_sk": (T.LONG, r.randint(1, _n_addr(sf) + 1, n)),
        "c_current_hdemo_sk": (T.LONG, r.randint(1, 21, n)),
        "c_first_name": (T.STRING,
                         np.array([f"name_{i % 97}" for i in range(n)])),
    }


def _n_addr(sf: float) -> int:
    return max(10, int(sf * 500))


def gen_customer_address(sf: float, seed: int = 27) -> Dict:
    n = _n_addr(sf)
    r = np.random.RandomState(seed)
    return {
        "ca_address_sk": (T.LONG, np.arange(1, n + 1)),
        "ca_state": (T.STRING, r.choice(STATES, n)),
        "ca_city": (T.STRING, r.choice(CITIES, n)),
        "ca_county": (T.STRING, r.choice(COUNTIES, n)),
        "ca_gmt_offset": (T.INT, r.choice([-8, -7, -6, -5], n)
                          .astype(np.int32)),
    }


def gen_household_demographics(seed: int = 28) -> Dict:
    n = 20
    r = np.random.RandomState(seed)
    return {
        "hd_demo_sk": (T.LONG, np.arange(1, n + 1)),
        "hd_dep_count": (T.INT, r.randint(0, 10, n).astype(np.int32)),
        "hd_buy_potential": (T.STRING,
                             r.choice(["0-500", "501-1000", "1001-5000",
                                       ">10000", "Unknown"], n)),
        "hd_vehicle_count": (T.INT, r.randint(0, 5, n).astype(np.int32)),
    }


def gen_store(seed: int = 23) -> Dict:
    n = 12
    r = np.random.RandomState(seed)
    return {
        "s_store_sk": (T.LONG, np.arange(1, n + 1)),
        "s_state": (T.STRING, r.choice(STATES, n)),
        "s_city": (T.STRING, r.choice(CITIES, n)),
        "s_county": (T.STRING, r.choice(COUNTIES, n)),
    }


def gen_promotion(seed: int = 25) -> Dict:
    n = 30
    r = np.random.RandomState(seed)
    return {
        "p_promo_sk": (T.LONG, np.arange(1, n + 1)),
        "p_channel_email": (T.STRING, r.choice(["Y", "N"], n)),
        "p_channel_event": (T.STRING, r.choice(["Y", "N"], n)),
    }


def _with_nulls(r, vals, frac: float):
    """Python list with ~frac of entries NULL (nullable foreign keys —
    the q76/q97 family counts rows by which key is missing)."""
    mask = r.rand(len(vals)) < frac
    return [None if m else int(v) for m, v in zip(mask, vals)]


def gen_store_sales(sf: float, seed: int = 24) -> Dict:
    n = max(100, int(sf * 100_000))
    r = np.random.RandomState(seed)
    n_item = max(10, int(sf * 2_000))
    n_cust = max(10, int(sf * 1_000))
    price = (r.rand(n) * 200 + 1).round(2)
    qty = r.randint(1, 101, n)
    return {
        "ss_sold_date_sk": (T.LONG, r.randint(1, 731, n)),
        "ss_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "ss_customer_sk": (T.LONG,
                           _with_nulls(r, r.randint(1, n_cust + 1, n),
                                       0.03)),
        "ss_store_sk": (T.LONG, r.randint(1, 13, n)),
        "ss_promo_sk": (T.LONG,
                        _with_nulls(r, r.randint(1, 31, n), 0.05)),
        "ss_ticket_number": (T.LONG, r.randint(1, n // 3 + 2, n)),
        "ss_quantity": (T.INT, qty.astype(np.int32)),
        "ss_sales_price": (T.DOUBLE, price),
        "ss_ext_sales_price": (T.DOUBLE, (price * qty).round(2)),
        "ss_ext_discount_amt": (T.DOUBLE, (r.rand(n) * 100).round(2)),
        "ss_net_profit": (T.DOUBLE, ((r.rand(n) - 0.3) * 500).round(2)),
    }


def gen_store_returns(sf: float, seed: int = 26, sales: Dict = None) -> Dict:
    """Returns SAMPLE real store_sales rows (same ticket/item/customer/
    store keys, later return date, quantity <= sold quantity) so the
    sale<->return joins in the q17/q50/q64 class actually match lines —
    like dsdgen's coupled fact generation.  Pass ``sales`` to reuse an
    already-generated fact (must come from gen_store_sales(sf))."""
    n = max(20, int(sf * 10_000))
    r = np.random.RandomState(seed)
    ss = sales if sales is not None else gen_store_sales(sf)
    n_ss = len(ss["ss_ticket_number"][1])
    pick = r.randint(0, n_ss, n)
    sold_date = np.asarray(ss["ss_sold_date_sk"][1])[pick]
    lag = r.randint(1, 120, n)
    cust = ss["ss_customer_sk"][1]
    return {
        "sr_returned_date_sk": (T.LONG,
                                np.minimum(sold_date + lag, 730)),
        "sr_item_sk": (T.LONG, np.asarray(ss["ss_item_sk"][1])[pick]),
        "sr_customer_sk": (T.LONG, [cust[i] for i in pick]),
        "sr_store_sk": (T.LONG, np.asarray(ss["ss_store_sk"][1])[pick]),
        "sr_ticket_number": (T.LONG,
                             np.asarray(ss["ss_ticket_number"][1])[pick]),
        "sr_return_quantity": (
            T.INT, np.maximum(
                1, np.asarray(ss["ss_quantity"][1])[pick] // 2)
            .astype(np.int32)),
        "sr_return_amt": (T.DOUBLE, (r.rand(n) * 300).round(2)),
    }


def gen_catalog_sales(sf: float, seed: int = 29) -> Dict:
    """Catalog channel fact — ~40% the store fact's size, same key
    space (TPC-DS catalog_sales role)."""
    n = max(60, int(sf * 40_000))
    r = np.random.RandomState(seed)
    n_item = max(10, int(sf * 2_000))
    n_cust = max(10, int(sf * 1_000))
    price = (r.rand(n) * 250 + 1).round(2)
    qty = r.randint(1, 101, n)
    return {
        "cs_sold_date_sk": (T.LONG, r.randint(1, 731, n)),
        "cs_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "cs_bill_customer_sk": (T.LONG,
                                _with_nulls(r, r.randint(1, n_cust + 1, n),
                                            0.02)),
        "cs_promo_sk": (T.LONG, r.randint(1, 31, n)),
        "cs_order_number": (T.LONG, r.randint(1, n // 2 + 2, n)),
        "cs_quantity": (T.INT, qty.astype(np.int32)),
        "cs_sales_price": (T.DOUBLE, price),
        "cs_ext_sales_price": (T.DOUBLE, (price * qty).round(2)),
        "cs_ext_discount_amt": (T.DOUBLE, (r.rand(n) * 120).round(2)),
        "cs_net_profit": (T.DOUBLE, ((r.rand(n) - 0.3) * 600).round(2)),
        # drawn LAST so earlier columns keep their values across versions;
        # some orders genuinely ship from several warehouses (q16's
        # multi-warehouse EXISTS shape)
        "cs_warehouse_sk": (T.LONG, r.randint(1, 7, n)),
    }


def gen_web_sales(sf: float, seed: int = 30) -> Dict:
    """Web channel fact — ~20% the store fact's size (web_sales role)."""
    n = max(40, int(sf * 20_000))
    r = np.random.RandomState(seed)
    n_item = max(10, int(sf * 2_000))
    n_cust = max(10, int(sf * 1_000))
    price = (r.rand(n) * 180 + 1).round(2)
    qty = r.randint(1, 101, n)
    return {
        "ws_sold_date_sk": (T.LONG, r.randint(1, 731, n)),
        "ws_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "ws_bill_customer_sk": (T.LONG,
                                _with_nulls(r, r.randint(1, n_cust + 1, n),
                                            0.02)),
        "ws_order_number": (T.LONG, r.randint(1, n // 2 + 2, n)),
        "ws_quantity": (T.INT, qty.astype(np.int32)),
        "ws_sales_price": (T.DOUBLE, price),
        "ws_ext_sales_price": (T.DOUBLE, (price * qty).round(2)),
        "ws_net_profit": (T.DOUBLE, ((r.rand(n) - 0.25) * 400).round(2)),
        # drawn last (see cs_warehouse_sk); q95's multi-warehouse orders
        "ws_warehouse_sk": (T.LONG, r.randint(1, 7, n)),
    }


def gen_web_returns(sf: float, seed: int = 31, sales: Dict = None) -> Dict:
    """Samples web_sales lines (coupled keys, like gen_store_returns)."""
    n = max(10, int(sf * 2_000))
    r = np.random.RandomState(seed)
    ws = sales if sales is not None else gen_web_sales(sf)
    n_ws = len(ws["ws_order_number"][1])
    pick = r.randint(0, n_ws, n)
    sold = np.asarray(ws["ws_sold_date_sk"][1])[pick]
    cust = ws["ws_bill_customer_sk"][1]
    return {
        "wr_returned_date_sk": (T.LONG,
                                np.minimum(sold + r.randint(1, 90, n), 730)),
        "wr_item_sk": (T.LONG, np.asarray(ws["ws_item_sk"][1])[pick]),
        "wr_refunded_customer_sk": (T.LONG, [cust[i] for i in pick]),
        "wr_order_number": (T.LONG,
                            np.asarray(ws["ws_order_number"][1])[pick]),
        "wr_return_quantity": (
            T.INT, np.maximum(
                1, np.asarray(ws["ws_quantity"][1])[pick] // 3)
            .astype(np.int32)),
        "wr_return_amt": (T.DOUBLE, (r.rand(n) * 200).round(2)),
    }


def gen_catalog_returns(sf: float, seed: int = 32, sales: Dict = None) -> Dict:
    """Samples catalog_sales lines (coupled keys)."""
    n = max(15, int(sf * 4_000))
    r = np.random.RandomState(seed)
    cs = sales if sales is not None else gen_catalog_sales(sf)
    n_cs = len(cs["cs_order_number"][1])
    pick = r.randint(0, n_cs, n)
    sold = np.asarray(cs["cs_sold_date_sk"][1])[pick]
    cust = cs["cs_bill_customer_sk"][1]
    return {
        "cr_returned_date_sk": (T.LONG,
                                np.minimum(sold + r.randint(1, 100, n),
                                           730)),
        "cr_item_sk": (T.LONG, np.asarray(cs["cs_item_sk"][1])[pick]),
        "cr_refunded_customer_sk": (T.LONG, [cust[i] for i in pick]),
        "cr_order_number": (T.LONG,
                            np.asarray(cs["cs_order_number"][1])[pick]),
        "cr_return_quantity": (
            T.INT, np.maximum(
                1, np.asarray(cs["cs_quantity"][1])[pick] // 4)
            .astype(np.int32)),
        "cr_return_amount": (T.DOUBLE, (r.rand(n) * 250).round(2)),
    }


def gen_warehouse(seed: int = 33) -> Dict:
    n = 6
    r = np.random.RandomState(seed)
    return {
        "w_warehouse_sk": (T.LONG, np.arange(1, n + 1)),
        "w_warehouse_name": (T.STRING,
                             np.array([f"Warehouse#{i}"
                                       for i in range(1, n + 1)])),
        "w_state": (T.STRING, r.choice(STATES, n)),
    }


def gen_inventory(sf: float, seed: int = 34) -> Dict:
    """Weekly stock snapshots (inventory role): random (date, item,
    warehouse) observations rather than the full cross product, sized to
    stay proportional to the fact tables."""
    n = max(200, int(sf * 30_000))
    r = np.random.RandomState(seed)
    n_item = max(10, int(sf * 2_000))
    # snapshot dates on week boundaries across both years
    dates = np.arange(7, 731, 7)
    return {
        "inv_date_sk": (T.LONG, r.choice(dates, n)),
        "inv_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "inv_warehouse_sk": (T.LONG, r.randint(1, 7, n)),
        "inv_quantity_on_hand": (T.INT,
                                 r.randint(0, 1000, n).astype(np.int32)),
    }


def build_tables(sf: float) -> Dict[str, Dict]:
    """All tables at one scale; the sales facts are generated once and
    fed to their returns generators (they sample sale lines)."""
    ss = gen_store_sales(sf)
    cs = gen_catalog_sales(sf)
    ws = gen_web_sales(sf)
    return {
        "store_sales": ss,
        "store_returns": gen_store_returns(sf, sales=ss),
        "catalog_sales": cs,
        "catalog_returns": gen_catalog_returns(sf, sales=cs),
        "web_sales": ws,
        "web_returns": gen_web_returns(sf, sales=ws),
        "item": gen_item(sf),
        "customer": gen_customer(sf),
        "customer_address": gen_customer_address(sf),
        "household_demographics": gen_household_demographics(),
        "date_dim": gen_date_dim(),
        "store": gen_store(),
        "promotion": gen_promotion(),
        "warehouse": gen_warehouse(),
        "inventory": gen_inventory(sf),
    }


def register_tpcds(session, sf: float = 0.1, num_partitions: int = 4):
    """Create every TPC-DS-like table at ``sf`` and register it as a temp
    view of the port's session."""
    for name, data in build_tables(sf).items():
        df = session.create_dataframe(data, num_partitions=num_partitions)
        df.create_or_replace_temp_view(name)


# -- queries (TpcdsLikeSpark adaptation) ------------------------------------

Q3 = """
SELECT d_year, i_brand, sum(ss_ext_sales_price) AS sum_agg
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN item ON i_item_sk = ss_item_sk
WHERE i_manufact_id = 52 AND d_moy = 11
GROUP BY d_year, i_brand
ORDER BY d_year, sum_agg DESC, i_brand
LIMIT 100
"""

Q7 = """
SELECT i_category,
       avg(ss_quantity) AS agg1,
       avg(ss_sales_price) AS agg2,
       avg(ss_ext_sales_price) AS agg3,
       avg(ss_ext_discount_amt) AS agg4
FROM store_sales
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN item ON i_item_sk = ss_item_sk
WHERE c_education = 'College' AND c_birth_year < 1970
GROUP BY i_category
ORDER BY i_category
"""

Q42 = """
SELECT d_year, i_category, sum(ss_ext_sales_price) AS total
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN item ON i_item_sk = ss_item_sk
WHERE d_moy = 12 AND i_current_price > 50
GROUP BY d_year, i_category
ORDER BY total DESC, d_year, i_category
LIMIT 100
"""

Q52 = """
SELECT d_year, i_brand, sum(ss_ext_sales_price) AS ext_price
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN item ON i_item_sk = ss_item_sk
WHERE d_moy = 11 AND d_year = 1998
GROUP BY d_year, i_brand
ORDER BY d_year, ext_price DESC, i_brand
LIMIT 100
"""

Q55 = """
SELECT i_brand, sum(ss_ext_sales_price) AS ext_price
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN item ON i_item_sk = ss_item_sk
WHERE d_moy = 6 AND d_year = 1999
GROUP BY i_brand
ORDER BY ext_price DESC, i_brand
LIMIT 100
"""

Q65 = """
SELECT s_state, i_category, sum(ss_net_profit) AS profit
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN item ON i_item_sk = ss_item_sk
GROUP BY s_state, i_category
HAVING sum(ss_net_profit) > 0
ORDER BY s_state, profit DESC
"""

Q13 = """
SELECT avg(ss_quantity) AS avg_qty,
       avg(ss_ext_sales_price) AS avg_price,
       sum(ss_ext_discount_amt) AS total_disc
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN customer ON c_customer_sk = ss_customer_sk
WHERE s_state IN ('CA', 'TX')
  AND c_education IN ('College', '4 yr Degree')
  AND ss_sales_price BETWEEN 50 AND 150
"""

Q19 = """
SELECT i_brand, i_manufact_id, sum(ss_ext_sales_price) AS ext_price
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN item ON i_item_sk = ss_item_sk
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN store ON s_store_sk = ss_store_sk
WHERE d_moy = 11 AND d_year = 1998 AND i_manufact_id < 40
  AND c_state <> s_state
GROUP BY i_brand, i_manufact_id
ORDER BY ext_price DESC, i_brand, i_manufact_id
LIMIT 100
"""

Q26 = """
SELECT i_category,
       avg(ss_quantity) AS agg1,
       avg(ss_sales_price) AS agg2
FROM store_sales
JOIN promotion ON p_promo_sk = ss_promo_sk
JOIN item ON i_item_sk = ss_item_sk
WHERE p_channel_email = 'N' OR p_channel_event = 'N'
GROUP BY i_category
ORDER BY i_category
"""

Q29 = """
SELECT i_category,
       sum(ss_quantity) AS sold,
       sum(sr_return_quantity) AS returned
FROM store_sales
JOIN store_returns ON sr_item_sk = ss_item_sk
  AND sr_customer_sk = ss_customer_sk
JOIN item ON i_item_sk = ss_item_sk
GROUP BY i_category
ORDER BY i_category
"""

Q36 = """
SELECT i_category, profit,
       rank() OVER (ORDER BY profit DESC) AS rk
FROM (
  SELECT i_category, sum(ss_net_profit) AS profit
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  GROUP BY i_category
)
ORDER BY rk, i_category
"""

Q43 = """
SELECT s_state, d_moy, sum(ss_ext_sales_price) AS total
FROM store_sales
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN store ON s_store_sk = ss_store_sk
WHERE d_year = 1998
GROUP BY s_state, d_moy
ORDER BY s_state, d_moy
"""

Q48 = """
SELECT sum(CASE WHEN ss_quantity BETWEEN 1 AND 20 THEN 1 ELSE 0 END)
         AS bucket1,
       sum(CASE WHEN ss_quantity BETWEEN 21 AND 40 THEN 1 ELSE 0 END)
         AS bucket2,
       sum(CASE WHEN ss_quantity BETWEEN 41 AND 100 THEN 1 ELSE 0 END)
         AS bucket3
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
WHERE s_state IN ('CA', 'NY', 'TX')
"""

Q53 = """
SELECT i_manufact_id, d_moy, sum_sales,
       avg(sum_sales) OVER (PARTITION BY i_manufact_id)
         AS avg_manufact_sales
FROM (
  SELECT i_manufact_id, d_moy, sum(ss_sales_price) AS sum_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1999 AND i_manufact_id < 20
  GROUP BY i_manufact_id, d_moy
)
ORDER BY i_manufact_id, d_moy
"""

Q59 = """
SELECT y1.s_state, y1.total AS sales_1998, y2.total AS sales_1999
FROM (
  SELECT s_state, sum(ss_ext_sales_price) AS total
  FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  JOIN store ON s_store_sk = ss_store_sk
  WHERE d_year = 1998
  GROUP BY s_state
) y1
JOIN (
  SELECT s_state, sum(ss_ext_sales_price) AS total
  FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  JOIN store ON s_store_sk = ss_store_sk
  WHERE d_year = 1999
  GROUP BY s_state
) y2 ON y1.s_state = y2.s_state
ORDER BY y1.s_state
"""

Q61 = """
SELECT p.s_state, p.promo_sales, t.total_sales
FROM (
  SELECT s_state, sum(ss_ext_sales_price) AS promo_sales
  FROM store_sales
  JOIN store ON s_store_sk = ss_store_sk
  JOIN promotion ON p_promo_sk = ss_promo_sk
  WHERE p_channel_email = 'Y' OR p_channel_event = 'Y'
  GROUP BY s_state
) p
JOIN (
  SELECT s_state, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales
  JOIN store ON s_store_sk = ss_store_sk
  GROUP BY s_state
) t ON p.s_state = t.s_state
ORDER BY p.s_state
"""

Q68 = """
SELECT ss_ticket_number, ss_customer_sk,
       sum(ss_ext_sales_price) AS amt,
       sum(ss_net_profit) AS profit
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
WHERE s_state = 'CA'
GROUP BY ss_ticket_number, ss_customer_sk
HAVING sum(ss_ext_sales_price) > 500
ORDER BY ss_ticket_number, ss_customer_sk
LIMIT 100
"""

Q73 = """
SELECT c_state, count(DISTINCT ss_customer_sk) AS buyers,
       count(*) AS line_items
FROM store_sales
JOIN customer ON c_customer_sk = ss_customer_sk
GROUP BY c_state
ORDER BY c_state
"""

Q79 = """
SELECT s_state, ss_customer_sk, sum(ss_net_profit) AS profit
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN date_dim ON d_date_sk = ss_sold_date_sk
WHERE d_moy BETWEEN 1 AND 3
GROUP BY s_state, ss_customer_sk
HAVING sum(ss_net_profit) > 300
ORDER BY s_state, profit DESC, ss_customer_sk
LIMIT 100
"""

Q89 = """
SELECT i_category, d_moy, sum_sales, avg_monthly_sales
FROM (
  SELECT i_category, d_moy, sum_sales,
         avg(sum_sales) OVER (PARTITION BY i_category)
           AS avg_monthly_sales
  FROM (
    SELECT i_category, d_moy, sum(ss_sales_price) AS sum_sales
    FROM store_sales
    JOIN item ON i_item_sk = ss_item_sk
    JOIN date_dim ON d_date_sk = ss_sold_date_sk
    WHERE d_year = 1998
    GROUP BY i_category, d_moy
  )
)
WHERE sum_sales > avg_monthly_sales
ORDER BY i_category, d_moy
"""

Q98 = """
SELECT i_category, i_brand, itemrevenue,
       itemrevenue * 100.0 / cat_rev AS revenueratio
FROM (
  SELECT i_category, i_brand, itemrevenue,
         sum(itemrevenue) OVER (PARTITION BY i_category) AS cat_rev
  FROM (
    SELECT i_category, i_brand, sum(ss_ext_sales_price) AS itemrevenue
    FROM store_sales
    JOIN item ON i_item_sk = ss_item_sk
    JOIN date_dim ON d_date_sk = ss_sold_date_sk
    WHERE d_year = 1999
    GROUP BY i_category, i_brand
  )
)
ORDER BY i_category, i_brand
"""

Q14 = """
SELECT channel, i_category, sum(sales) AS total_sales,
       count(*) AS groups_n
FROM (
  SELECT 'first_half' AS channel, i_category,
         sum(ss_ext_sales_price) AS sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy BETWEEN 1 AND 6
  GROUP BY i_category
  UNION ALL
  SELECT 'second_half' AS channel, i_category,
         sum(ss_ext_sales_price) AS sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy BETWEEN 7 AND 12
  GROUP BY i_category
)
GROUP BY channel, i_category
ORDER BY channel, i_category
"""

Q2 = """
SELECT m1.d_moy, m1.total AS total_1998, m2.total AS total_1999,
       m2.total / m1.total AS growth
FROM (
  SELECT d_moy, sum(ss_ext_sales_price) AS total
  FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  GROUP BY d_moy
) m1
JOIN (
  SELECT d_moy, sum(ss_ext_sales_price) AS total
  FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1999
  GROUP BY d_moy
) m2 ON m1.d_moy = m2.d_moy
ORDER BY m1.d_moy
"""

Q22 = """
SELECT i_category, i_brand, avg(ss_quantity) AS qoh
FROM store_sales
JOIN item ON i_item_sk = ss_item_sk
GROUP BY i_category, i_brand
UNION ALL
SELECT i_category, 'ALL' AS i_brand, avg(ss_quantity) AS qoh
FROM store_sales
JOIN item ON i_item_sk = ss_item_sk
GROUP BY i_category
ORDER BY i_category, i_brand, qoh
"""

Q25 = """
SELECT i_category, s_state,
       sum(ss_net_profit) AS profit,
       min(ss_net_profit) AS min_profit,
       max(ss_net_profit) AS max_profit
FROM store_sales
JOIN item ON i_item_sk = ss_item_sk
JOIN store ON s_store_sk = ss_store_sk
WHERE ss_quantity > 10
GROUP BY i_category, s_state
ORDER BY i_category, s_state
"""

Q33 = """
SELECT i_manufact_id, sum(total_sales) AS total_sales
FROM (
  SELECT i_manufact_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy = 1
  GROUP BY i_manufact_id
  UNION ALL
  SELECT i_manufact_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy = 2
  GROUP BY i_manufact_id
  UNION ALL
  SELECT i_manufact_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy = 3
  GROUP BY i_manufact_id
)
GROUP BY i_manufact_id
ORDER BY total_sales DESC, i_manufact_id
LIMIT 100
"""

Q34 = """
SELECT c_state, count(*) AS frequent_buyers
FROM customer
LEFT SEMI JOIN (
  SELECT ss_customer_sk
  FROM store_sales
  GROUP BY ss_customer_sk
  HAVING count(*) > 15
) f ON c_customer_sk = ss_customer_sk
GROUP BY c_state
ORDER BY c_state
"""

Q51 = """
SELECT i_category, d_moy, sum_sales,
       sum(sum_sales) OVER (PARTITION BY i_category ORDER BY d_moy
                            ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)
         AS cume_sales
FROM (
  SELECT i_category, d_moy, sum(ss_sales_price) AS sum_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  GROUP BY i_category, d_moy
)
ORDER BY i_category, d_moy
"""

Q92 = """
SELECT i_category, count(*) AS premium_items
FROM item
JOIN (
  SELECT i_category AS cat, avg(i_current_price) AS avg_price
  FROM item
  GROUP BY i_category
) a ON i_category = cat
WHERE i_current_price > avg_price * 1.2
GROUP BY i_category
ORDER BY i_category
"""

Q93 = """
SELECT ss_customer_sk, sum(act_sales) AS sumsales
FROM (
  SELECT ss_customer_sk,
         CASE WHEN sr_return_quantity IS NOT NULL
              THEN (ss_quantity - sr_return_quantity) * ss_sales_price
              ELSE ss_quantity * ss_sales_price END AS act_sales
  FROM store_sales
  LEFT JOIN store_returns ON sr_item_sk = ss_item_sk
    AND sr_customer_sk = ss_customer_sk
)
GROUP BY ss_customer_sk
ORDER BY sumsales DESC, ss_customer_sk
LIMIT 100
"""

Q38 = """
SELECT count(*) AS common_customers
FROM (
  SELECT ss_customer_sk FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy BETWEEN 1 AND 6
  INTERSECT
  SELECT ss_customer_sk FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy BETWEEN 7 AND 12
)
"""

Q87 = """
SELECT count(*) AS never_returned
FROM (
  SELECT ss_customer_sk FROM store_sales
  EXCEPT
  SELECT sr_customer_sk FROM store_returns
)
"""

Q67 = """
SELECT i_category, i_brand, s_state, sum(ss_ext_sales_price) AS sales
FROM store_sales
JOIN item ON i_item_sk = ss_item_sk
JOIN store ON s_store_sk = ss_store_sk
GROUP BY ROLLUP(i_category, i_brand, s_state)
ORDER BY i_category, i_brand, s_state, sales
LIMIT 200
"""

# -- round-5 additions: toward the reference's full 103-query list ----------
# (tpcds_test.py:21-50; TpcdsLikeSpark.scala query classes, adapted to the
# synthetic star schema the same way the round-4 set was)

Q1 = """
WITH ctr AS (
  SELECT sr_customer_sk AS ctr_customer_sk, sr_store_sk AS ctr_store_sk,
         sum(sr_return_amt) AS ctr_total_return
  FROM store_returns
  JOIN date_dim ON d_date_sk = sr_returned_date_sk
  WHERE d_year = 1998
  GROUP BY sr_customer_sk, sr_store_sk),
avg_ctr AS (
  SELECT ctr_store_sk AS av_store_sk,
         avg(ctr_total_return) * 1.2 AS threshold
  FROM ctr GROUP BY ctr_store_sk)
SELECT c_customer_sk
FROM ctr
JOIN avg_ctr ON ctr_store_sk = av_store_sk
JOIN customer ON c_customer_sk = ctr_customer_sk
JOIN store ON s_store_sk = ctr_store_sk
WHERE ctr_total_return > threshold AND s_state = 'TX'
ORDER BY c_customer_sk
LIMIT 100
"""

Q4 = """
WITH year_total AS (
  SELECT ss_customer_sk AS customer_sk, d_year AS dyear,
         sum(ss_ext_sales_price - ss_ext_discount_amt) AS year_total,
         's' AS sale_type
  FROM store_sales JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE ss_customer_sk IS NOT NULL
  GROUP BY ss_customer_sk, d_year
  UNION ALL
  SELECT ws_bill_customer_sk AS customer_sk, d_year AS dyear,
         sum(ws_ext_sales_price) AS year_total, 'w' AS sale_type
  FROM web_sales JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE ws_bill_customer_sk IS NOT NULL
  GROUP BY ws_bill_customer_sk, d_year)
SELECT s1_cust
FROM (SELECT customer_sk AS s1_cust, year_total AS s1_tot FROM year_total
      WHERE sale_type = 's' AND dyear = 1998) s1
JOIN (SELECT customer_sk AS s2_cust, year_total AS s2_tot FROM year_total
      WHERE sale_type = 's' AND dyear = 1999) s2 ON s1_cust = s2_cust
JOIN (SELECT customer_sk AS w1_cust, year_total AS w1_tot FROM year_total
      WHERE sale_type = 'w' AND dyear = 1998) w1 ON s1_cust = w1_cust
JOIN (SELECT customer_sk AS w2_cust, year_total AS w2_tot FROM year_total
      WHERE sale_type = 'w' AND dyear = 1999) w2 ON s1_cust = w2_cust
WHERE s1_tot > 0 AND w1_tot > 0
  AND w2_tot / w1_tot > s2_tot / s1_tot
ORDER BY s1_cust
LIMIT 100
"""

Q5 = """
SELECT channel, sum(sales) AS sales, sum(returns_amt) AS returns_amt,
       sum(profit) AS profit
FROM (
  SELECT 'store channel' AS channel, ss_ext_sales_price AS sales,
         0.0 AS returns_amt, ss_net_profit AS profit
  FROM store_sales JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  UNION ALL
  SELECT 'store channel' AS channel, 0.0 AS sales,
         sr_return_amt AS returns_amt, 0.0 AS profit
  FROM store_returns JOIN date_dim ON d_date_sk = sr_returned_date_sk
  WHERE d_year = 1998
  UNION ALL
  SELECT 'catalog channel' AS channel, cs_ext_sales_price AS sales,
         0.0 AS returns_amt, cs_net_profit AS profit
  FROM catalog_sales JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_year = 1998
  UNION ALL
  SELECT 'catalog channel' AS channel, 0.0 AS sales,
         cr_return_amount AS returns_amt, 0.0 AS profit
  FROM catalog_returns JOIN date_dim ON d_date_sk = cr_returned_date_sk
  WHERE d_year = 1998
  UNION ALL
  SELECT 'web channel' AS channel, ws_ext_sales_price AS sales,
         0.0 AS returns_amt, ws_net_profit AS profit
  FROM web_sales JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_year = 1998
  UNION ALL
  SELECT 'web channel' AS channel, 0.0 AS sales,
         wr_return_amt AS returns_amt, 0.0 AS profit
  FROM web_returns JOIN date_dim ON d_date_sk = wr_returned_date_sk
  WHERE d_year = 1998
)
GROUP BY ROLLUP(channel)
ORDER BY channel, sales
"""

Q8 = """
SELECT s_store_sk, sum(ss_net_profit) AS net_profit
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN customer_address ON ca_address_sk = c_current_addr_sk
WHERE ca_county IN ('Orange County', 'Walker County', 'Barrow County')
GROUP BY s_store_sk
ORDER BY s_store_sk
"""

Q9 = """
SELECT count(CASE WHEN ss_quantity BETWEEN 1 AND 20 THEN 1 END) AS cnt1,
       avg(CASE WHEN ss_quantity BETWEEN 1 AND 20
                THEN ss_ext_sales_price END) AS avg1,
       count(CASE WHEN ss_quantity BETWEEN 21 AND 40 THEN 1 END) AS cnt2,
       avg(CASE WHEN ss_quantity BETWEEN 21 AND 40
                THEN ss_ext_sales_price END) AS avg2,
       count(CASE WHEN ss_quantity BETWEEN 41 AND 60 THEN 1 END) AS cnt3,
       avg(CASE WHEN ss_quantity BETWEEN 41 AND 60
                THEN ss_ext_sales_price END) AS avg3,
       count(CASE WHEN ss_quantity BETWEEN 61 AND 80 THEN 1 END) AS cnt4,
       avg(CASE WHEN ss_quantity BETWEEN 61 AND 80
                THEN ss_ext_sales_price END) AS avg4,
       count(CASE WHEN ss_quantity BETWEEN 81 AND 100 THEN 1 END) AS cnt5,
       avg(CASE WHEN ss_quantity BETWEEN 81 AND 100
                THEN ss_ext_sales_price END) AS avg5
FROM store_sales
"""

Q10 = """
SELECT c_state, c_education, count(*) AS cnt,
       min(c_birth_year) AS min_year, max(c_birth_year) AS max_year
FROM customer
LEFT SEMI JOIN store_sales ON ss_customer_sk = c_customer_sk
LEFT SEMI JOIN web_sales ON ws_bill_customer_sk = c_customer_sk
GROUP BY c_state, c_education
ORDER BY c_state, c_education
"""

Q11 = """
WITH year_total AS (
  SELECT ss_customer_sk AS customer_sk, d_year AS dyear,
         sum(ss_ext_sales_price) AS year_total, 's' AS sale_type
  FROM store_sales JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE ss_customer_sk IS NOT NULL
  GROUP BY ss_customer_sk, d_year
  UNION ALL
  SELECT ws_bill_customer_sk AS customer_sk, d_year AS dyear,
         sum(ws_ext_sales_price) AS year_total, 'w' AS sale_type
  FROM web_sales JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE ws_bill_customer_sk IS NOT NULL
  GROUP BY ws_bill_customer_sk, d_year)
SELECT c_customer_sk, c_first_name
FROM (SELECT customer_sk AS s1_cust, year_total AS s1_tot FROM year_total
      WHERE sale_type = 's' AND dyear = 1998) s1
JOIN (SELECT customer_sk AS s2_cust, year_total AS s2_tot FROM year_total
      WHERE sale_type = 's' AND dyear = 1999) s2 ON s1_cust = s2_cust
JOIN (SELECT customer_sk AS w1_cust, year_total AS w1_tot FROM year_total
      WHERE sale_type = 'w' AND dyear = 1998) w1 ON s1_cust = w1_cust
JOIN (SELECT customer_sk AS w2_cust, year_total AS w2_tot FROM year_total
      WHERE sale_type = 'w' AND dyear = 1999) w2 ON s1_cust = w2_cust
JOIN customer ON c_customer_sk = s1_cust
WHERE s1_tot > 0 AND w1_tot > 0 AND w2_tot / w1_tot > s2_tot / s1_tot
ORDER BY c_customer_sk
LIMIT 100
"""

Q12 = """
WITH rev AS (
  SELECT i_class, i_category, sum(ws_ext_sales_price) AS itemrevenue
  FROM web_sales
  JOIN item ON i_item_sk = ws_item_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE i_category IN ('Books', 'Home', 'Sports') AND d_moy BETWEEN 2 AND 3
  GROUP BY i_class, i_category)
SELECT i_class, i_category, itemrevenue,
       itemrevenue * 100.0 /
         sum(itemrevenue) OVER (PARTITION BY i_category) AS revenueratio
FROM rev
ORDER BY i_category, i_class, revenueratio
"""

Q15 = """
SELECT ca_state, d_qoy, sum(cs_sales_price) AS total_sales
FROM catalog_sales
JOIN customer ON c_customer_sk = cs_bill_customer_sk
JOIN customer_address ON ca_address_sk = c_current_addr_sk
JOIN date_dim ON d_date_sk = cs_sold_date_sk
WHERE d_year = 1998 AND cs_sales_price > 100
GROUP BY ca_state, d_qoy
ORDER BY ca_state, d_qoy
"""

Q17 = """
SELECT i_brand, s_state,
       count(ss_quantity) AS store_sales_cnt,
       avg(ss_quantity) AS store_sales_avg,
       stddev(ss_quantity) AS store_sales_sd,
       count(sr_return_quantity) AS store_ret_cnt,
       avg(sr_return_quantity) AS store_ret_avg,
       count(cs_quantity) AS catalog_cnt,
       avg(cs_quantity) AS catalog_avg
FROM store_sales
JOIN store_returns ON sr_ticket_number = ss_ticket_number
                  AND sr_item_sk = ss_item_sk
JOIN catalog_sales ON cs_bill_customer_sk = sr_customer_sk
                  AND cs_item_sk = sr_item_sk
JOIN item ON i_item_sk = ss_item_sk
JOIN store ON s_store_sk = ss_store_sk
GROUP BY i_brand, s_state
ORDER BY i_brand, s_state
LIMIT 100
"""

Q20 = """
WITH rev AS (
  SELECT i_class, i_category, sum(cs_ext_sales_price) AS itemrevenue
  FROM catalog_sales
  JOIN item ON i_item_sk = cs_item_sk
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE i_category IN ('Electronics', 'Jewelry', 'Toys')
    AND d_moy BETWEEN 2 AND 3
  GROUP BY i_class, i_category)
SELECT i_class, i_category, itemrevenue,
       itemrevenue * 100.0 /
         sum(itemrevenue) OVER (PARTITION BY i_category) AS revenueratio
FROM rev
ORDER BY i_category, i_class, revenueratio
"""

Q23A = """
WITH frequent_items AS (
  SELECT ss_item_sk AS fi_item_sk
  FROM store_sales JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  GROUP BY ss_item_sk
  HAVING count(*) > 4),
per_cust AS (
  SELECT ss_customer_sk AS pc_cust,
         sum(ss_quantity * ss_sales_price) AS spend
  FROM store_sales
  WHERE ss_customer_sk IS NOT NULL
  GROUP BY ss_customer_sk),
best_customers AS (
  SELECT pc_cust AS bc_cust
  FROM per_cust
  CROSS JOIN (SELECT max(spend) * 0.5 AS thr FROM per_cust) m
  WHERE spend > thr)
SELECT sum(sales) AS total_sales
FROM (
  SELECT cs_quantity * cs_sales_price AS sales
  FROM catalog_sales
  LEFT SEMI JOIN frequent_items ON fi_item_sk = cs_item_sk
  LEFT SEMI JOIN best_customers ON bc_cust = cs_bill_customer_sk
  UNION ALL
  SELECT ws_quantity * ws_sales_price AS sales
  FROM web_sales
  LEFT SEMI JOIN frequent_items ON fi_item_sk = ws_item_sk
  LEFT SEMI JOIN best_customers ON bc_cust = ws_bill_customer_sk
)
"""

Q23B = """
WITH frequent_items AS (
  SELECT ss_item_sk AS fi_item_sk
  FROM store_sales JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  GROUP BY ss_item_sk
  HAVING count(*) > 4),
per_cust AS (
  SELECT ss_customer_sk AS pc_cust,
         sum(ss_quantity * ss_sales_price) AS spend
  FROM store_sales
  WHERE ss_customer_sk IS NOT NULL
  GROUP BY ss_customer_sk),
best_customers AS (
  SELECT pc_cust AS bc_cust
  FROM per_cust
  CROSS JOIN (SELECT max(spend) * 0.5 AS thr FROM per_cust) m
  WHERE spend > thr)
SELECT cust, sum(sales) AS total_sales
FROM (
  SELECT cs_bill_customer_sk AS cust, cs_quantity * cs_sales_price AS sales
  FROM catalog_sales
  LEFT SEMI JOIN frequent_items ON fi_item_sk = cs_item_sk
  LEFT SEMI JOIN best_customers ON bc_cust = cs_bill_customer_sk
  UNION ALL
  SELECT ws_bill_customer_sk AS cust, ws_quantity * ws_sales_price AS sales
  FROM web_sales
  LEFT SEMI JOIN frequent_items ON fi_item_sk = ws_item_sk
  LEFT SEMI JOIN best_customers ON bc_cust = ws_bill_customer_sk
)
GROUP BY cust
ORDER BY total_sales DESC, cust
LIMIT 100
"""

Q27 = """
SELECT s_state, i_category,
       avg(ss_quantity) AS agg1,
       avg(ss_sales_price) AS agg2,
       avg(ss_ext_sales_price) AS agg3
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN item ON i_item_sk = ss_item_sk
JOIN customer ON c_customer_sk = ss_customer_sk
WHERE c_education = 'College'
GROUP BY ROLLUP(s_state, i_category)
ORDER BY s_state, i_category
"""

Q28 = """
SELECT b1_avg, b1_cnt, b2_avg, b2_cnt, b3_avg, b3_cnt,
       b4_avg, b4_cnt, b5_avg, b5_cnt, b6_avg, b6_cnt
FROM (SELECT avg(ss_sales_price) AS b1_avg, count(ss_sales_price) AS b1_cnt
      FROM store_sales WHERE ss_quantity BETWEEN 0 AND 5) t1
CROSS JOIN
     (SELECT avg(ss_sales_price) AS b2_avg, count(ss_sales_price) AS b2_cnt
      FROM store_sales WHERE ss_quantity BETWEEN 6 AND 10) t2
CROSS JOIN
     (SELECT avg(ss_sales_price) AS b3_avg, count(ss_sales_price) AS b3_cnt
      FROM store_sales WHERE ss_quantity BETWEEN 11 AND 15) t3
CROSS JOIN
     (SELECT avg(ss_sales_price) AS b4_avg, count(ss_sales_price) AS b4_cnt
      FROM store_sales WHERE ss_quantity BETWEEN 16 AND 20) t4
CROSS JOIN
     (SELECT avg(ss_sales_price) AS b5_avg, count(ss_sales_price) AS b5_cnt
      FROM store_sales WHERE ss_quantity BETWEEN 21 AND 25) t5
CROSS JOIN
     (SELECT avg(ss_sales_price) AS b6_avg, count(ss_sales_price) AS b6_cnt
      FROM store_sales WHERE ss_quantity BETWEEN 26 AND 30) t6
"""

Q30 = """
WITH wr_total AS (
  SELECT wr_refunded_customer_sk AS wrt_cust, c_state AS wrt_state,
         sum(wr_return_amt) AS wrt_total
  FROM web_returns
  JOIN customer ON c_customer_sk = wr_refunded_customer_sk
  JOIN date_dim ON d_date_sk = wr_returned_date_sk
  WHERE d_year = 1998
  GROUP BY wr_refunded_customer_sk, c_state),
state_avg AS (
  SELECT wrt_state AS sa_state, avg(wrt_total) * 1.2 AS threshold
  FROM wr_total GROUP BY wrt_state)
SELECT wrt_cust, wrt_total
FROM wr_total
JOIN state_avg ON wrt_state = sa_state
WHERE wrt_total > threshold
ORDER BY wrt_cust
LIMIT 100
"""

Q31 = """
WITH ss_cty AS (
  SELECT ca_county AS county, d_qoy AS qoy,
         sum(ss_ext_sales_price) AS store_sales_tot
  FROM store_sales
  JOIN customer ON c_customer_sk = ss_customer_sk
  JOIN customer_address ON ca_address_sk = c_current_addr_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  GROUP BY ca_county, d_qoy),
ws_cty AS (
  SELECT ca_county AS county, d_qoy AS qoy,
         sum(ws_ext_sales_price) AS web_sales_tot
  FROM web_sales
  JOIN customer ON c_customer_sk = ws_bill_customer_sk
  JOIN customer_address ON ca_address_sk = c_current_addr_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_year = 1998
  GROUP BY ca_county, d_qoy)
SELECT ss1_county, ws2_tot / ws1_tot AS web_growth,
       ss2_tot / ss1_tot AS store_growth
FROM (SELECT county AS ss1_county, store_sales_tot AS ss1_tot
      FROM ss_cty WHERE qoy = 1) ss1
JOIN (SELECT county AS ss2_county, store_sales_tot AS ss2_tot
      FROM ss_cty WHERE qoy = 2) ss2 ON ss1_county = ss2_county
JOIN (SELECT county AS ws1_county, web_sales_tot AS ws1_tot
      FROM ws_cty WHERE qoy = 1) ws1 ON ss1_county = ws1_county
JOIN (SELECT county AS ws2_county, web_sales_tot AS ws2_tot
      FROM ws_cty WHERE qoy = 2) ws2 ON ss1_county = ws2_county
WHERE ss1_tot > 0 AND ws1_tot > 0
  AND ws2_tot / ws1_tot > ss2_tot / ss1_tot
ORDER BY ss1_county
"""


Q35 = """
SELECT c_state, c_education, count(*) AS cnt,
       avg(c_birth_year) AS avg_year,
       max(c_birth_year) AS max_year,
       sum(c_birth_year) AS sum_year
FROM customer
LEFT SEMI JOIN store_sales ON ss_customer_sk = c_customer_sk
GROUP BY c_state, c_education
ORDER BY c_state, c_education
"""

Q37 = """
SELECT i_item_sk, i_brand, i_current_price
FROM item
LEFT SEMI JOIN catalog_sales ON cs_item_sk = i_item_sk
WHERE i_current_price BETWEEN 20 AND 40
ORDER BY i_item_sk
LIMIT 100
"""

Q39A = """
SELECT item_sk, moy, qavg, qsd / qavg AS cov
FROM (
  SELECT cs_item_sk AS item_sk, d_moy AS moy,
         stddev(cs_quantity) AS qsd, avg(cs_quantity) AS qavg
  FROM catalog_sales
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_year = 1998
  GROUP BY cs_item_sk, d_moy)
WHERE qavg > 0 AND qsd / qavg > 0.5
ORDER BY item_sk, moy
LIMIT 100
"""

Q39B = """
WITH iv AS (
  SELECT cs_item_sk AS item_sk, d_moy AS moy,
         stddev(cs_quantity) AS qsd, avg(cs_quantity) AS qavg
  FROM catalog_sales
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_year = 1998
  GROUP BY cs_item_sk, d_moy)
SELECT i1, moy1, cov1, moy2, cov2
FROM (SELECT item_sk AS i1, moy AS moy1, qsd / qavg AS cov1 FROM iv
      WHERE qavg > 0 AND qsd / qavg > 0.5) v1
JOIN (SELECT item_sk AS i2, moy AS moy2, qsd / qavg AS cov2 FROM iv
      WHERE qavg > 0 AND qsd / qavg > 0.5) v2
  ON i1 = i2 AND moy1 + 1 = moy2
ORDER BY i1, moy1
LIMIT 100
"""

Q40 = """
SELECT i_category,
       sum(CASE WHEN d_dom < 15
                THEN cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                ELSE 0.0 END) AS sales_before,
       sum(CASE WHEN d_dom >= 15
                THEN cs_ext_sales_price - coalesce(cr_return_amount, 0.0)
                ELSE 0.0 END) AS sales_after
FROM catalog_sales
LEFT JOIN catalog_returns ON cr_order_number = cs_order_number
                         AND cr_item_sk = cs_item_sk
JOIN item ON i_item_sk = cs_item_sk
JOIN date_dim ON d_date_sk = cs_sold_date_sk
WHERE d_moy = 4
GROUP BY i_category
ORDER BY i_category
"""

Q41 = """
SELECT DISTINCT i_class, i_category
FROM item
WHERE i_current_price BETWEEN 30 AND 50
  AND i_category IN ('Books', 'Music', 'Home')
ORDER BY i_class, i_category
LIMIT 100
"""

Q44 = """
WITH perf AS (
  SELECT ss_item_sk AS item_sk, avg(ss_net_profit) AS rank_col
  FROM store_sales
  GROUP BY ss_item_sk),
asc_rank AS (
  SELECT item_sk AS best_sk, rank() OVER (ORDER BY rank_col DESC) AS rnk_up
  FROM perf),
desc_rank AS (
  SELECT item_sk AS worst_sk, rank() OVER (ORDER BY rank_col ASC)
           AS rnk_down
  FROM perf)
SELECT rnk_up, best_brand, worst_brand
FROM (SELECT rnk_up, i_brand AS best_brand FROM asc_rank
      JOIN item ON i_item_sk = best_sk WHERE rnk_up <= 10) b
JOIN (SELECT rnk_down, i_brand AS worst_brand FROM desc_rank
      JOIN item ON i_item_sk = worst_sk WHERE rnk_down <= 10) w
  ON rnk_up = rnk_down
ORDER BY rnk_up
"""

Q45 = """
SELECT ca_city, sum(ws_ext_sales_price) AS total_sales
FROM web_sales
JOIN customer ON c_customer_sk = ws_bill_customer_sk
JOIN customer_address ON ca_address_sk = c_current_addr_sk
JOIN item ON i_item_sk = ws_item_sk
WHERE i_manufact_id IN (5, 17, 33, 61, 85)
GROUP BY ca_city
ORDER BY ca_city
"""

Q46 = """
SELECT ss_ticket_number, c_customer_sk, ca_city, s_city,
       sum(ss_net_profit) AS profit
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN customer_address ON ca_address_sk = c_current_addr_sk
WHERE ca_city <> s_city
GROUP BY ss_ticket_number, c_customer_sk, ca_city, s_city
ORDER BY c_customer_sk, ss_ticket_number
LIMIT 100
"""

Q47 = """
WITH mb AS (
  SELECT i_brand, d_year, d_moy, sum(ss_ext_sales_price) AS sum_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  GROUP BY i_brand, d_year, d_moy),
v2 AS (
  SELECT i_brand, d_year, d_moy, sum_sales,
         avg(sum_sales) OVER (PARTITION BY i_brand, d_year)
           AS avg_monthly_sales,
         lag(sum_sales, 1) OVER (PARTITION BY i_brand
                                 ORDER BY d_year, d_moy) AS psum,
         lead(sum_sales, 1) OVER (PARTITION BY i_brand
                                  ORDER BY d_year, d_moy) AS nsum
  FROM mb)
SELECT i_brand, d_year, d_moy, sum_sales, avg_monthly_sales, psum, nsum
FROM v2
WHERE d_year = 1999 AND avg_monthly_sales > 0
  AND sum_sales - avg_monthly_sales > 0.1 * avg_monthly_sales
ORDER BY i_brand, d_moy
LIMIT 100
"""

Q49 = """
WITH in_web AS (
  SELECT ws_item_sk AS w_item,
         sum(coalesce(wr_return_quantity, 0)) AS w_ret,
         sum(ws_quantity) AS w_qty
  FROM web_sales
  LEFT JOIN web_returns ON wr_order_number = ws_order_number
                       AND wr_item_sk = ws_item_sk
  GROUP BY ws_item_sk),
in_cat AS (
  SELECT cs_item_sk AS c_item,
         sum(coalesce(cr_return_quantity, 0)) AS c_ret,
         sum(cs_quantity) AS c_qty
  FROM catalog_sales
  LEFT JOIN catalog_returns ON cr_order_number = cs_order_number
                           AND cr_item_sk = cs_item_sk
  GROUP BY cs_item_sk)
SELECT channel, item_sk, ret_ratio,
       rank() OVER (PARTITION BY channel ORDER BY ret_ratio DESC)
         AS ret_rank
FROM (
  SELECT 'web' AS channel, w_item AS item_sk,
         w_ret * 1.0 / w_qty AS ret_ratio
  FROM in_web WHERE w_qty > 0
  UNION ALL
  SELECT 'catalog' AS channel, c_item AS item_sk,
         c_ret * 1.0 / c_qty AS ret_ratio
  FROM in_cat WHERE c_qty > 0)
ORDER BY channel, ret_rank, item_sk
LIMIT 100
"""

Q50 = """
SELECT s_state, s_city,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS d30,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 30
                 AND sr_returned_date_sk - ss_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS d60,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 60
                 AND sr_returned_date_sk - ss_sold_date_sk <= 90
                THEN 1 ELSE 0 END) AS d90,
       sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 90
                THEN 1 ELSE 0 END) AS d120
FROM store_sales
JOIN store_returns ON sr_ticket_number = ss_ticket_number
                  AND sr_item_sk = ss_item_sk
JOIN store ON s_store_sk = ss_store_sk
GROUP BY s_state, s_city
ORDER BY s_state, s_city
"""

Q54 = """
WITH my_customers AS (
  SELECT DISTINCT cs_bill_customer_sk AS mc_sk
  FROM catalog_sales
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_moy = 3 AND d_year = 1998 AND cs_bill_customer_sk IS NOT NULL),
rev AS (
  SELECT mc_sk, sum(ss_ext_sales_price) AS revenue
  FROM store_sales
  JOIN my_customers ON ss_customer_sk = mc_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy BETWEEN 4 AND 6 AND d_year = 1998
  GROUP BY mc_sk)
SELECT cast(revenue / 1000 AS int) AS segment, count(*) AS num_customers
FROM rev
GROUP BY cast(revenue / 1000 AS int)
ORDER BY segment
LIMIT 100
"""

Q56 = """
SELECT i_class, sum(total_sales) AS total_sales
FROM (
  SELECT i_class, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy = 2 GROUP BY i_class
  UNION ALL
  SELECT i_class, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales JOIN item ON i_item_sk = cs_item_sk
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_moy = 2 GROUP BY i_class
  UNION ALL
  SELECT i_class, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales JOIN item ON i_item_sk = ws_item_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_moy = 2 GROUP BY i_class
)
GROUP BY i_class
ORDER BY total_sales, i_class
LIMIT 100
"""

Q57 = """
WITH mb AS (
  SELECT i_category, d_year, d_moy, sum(cs_ext_sales_price) AS sum_sales
  FROM catalog_sales
  JOIN item ON i_item_sk = cs_item_sk
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  GROUP BY i_category, d_year, d_moy),
v2 AS (
  SELECT i_category, d_year, d_moy, sum_sales,
         avg(sum_sales) OVER (PARTITION BY i_category, d_year)
           AS avg_monthly_sales,
         lag(sum_sales, 1) OVER (PARTITION BY i_category
                                 ORDER BY d_year, d_moy) AS psum,
         lead(sum_sales, 1) OVER (PARTITION BY i_category
                                  ORDER BY d_year, d_moy) AS nsum
  FROM mb)
SELECT i_category, d_year, d_moy, sum_sales, avg_monthly_sales, psum, nsum
FROM v2
WHERE d_year = 1999 AND avg_monthly_sales > 0
  AND sum_sales - avg_monthly_sales > 0.1 * avg_monthly_sales
ORDER BY i_category, d_moy
LIMIT 100
"""

Q60 = """
SELECT i_category, sum(total_sales) AS total_sales
FROM (
  SELECT i_category, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy = 9 GROUP BY i_category
  UNION ALL
  SELECT i_category, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales JOIN item ON i_item_sk = cs_item_sk
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_moy = 9 GROUP BY i_category
  UNION ALL
  SELECT i_category, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales JOIN item ON i_item_sk = ws_item_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_moy = 9 GROUP BY i_category
)
GROUP BY i_category
ORDER BY i_category, total_sales
"""

Q62 = """
SELECT d_moy,
       sum(CASE WHEN wr_returned_date_sk - ws_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS d30,
       sum(CASE WHEN wr_returned_date_sk - ws_sold_date_sk > 30
                 AND wr_returned_date_sk - ws_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS d60,
       sum(CASE WHEN wr_returned_date_sk - ws_sold_date_sk > 60
                THEN 1 ELSE 0 END) AS d90
FROM web_sales
JOIN web_returns ON wr_order_number = ws_order_number
                AND wr_item_sk = ws_item_sk
JOIN date_dim ON d_date_sk = ws_sold_date_sk
GROUP BY d_moy
ORDER BY d_moy
"""

Q63 = """
WITH sm AS (
  SELECT s_store_sk, d_moy, sum(ss_ext_sales_price) AS sum_sales
  FROM store_sales
  JOIN store ON s_store_sk = ss_store_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998
  GROUP BY s_store_sk, d_moy)
SELECT s_store_sk, d_moy, sum_sales, avg_monthly
FROM (
  SELECT s_store_sk, d_moy, sum_sales,
         avg(sum_sales) OVER (PARTITION BY s_store_sk) AS avg_monthly
  FROM sm)
WHERE avg_monthly > 0 AND sum_sales > 1.1 * avg_monthly
ORDER BY s_store_sk, d_moy
LIMIT 100
"""

Q64 = """
WITH cs AS (
  SELECT i_item_sk AS item_sk, s_store_sk AS store_sk,
         c_customer_sk AS cust_sk, ca_city AS city, d_year AS syear,
         sum(ss_ext_sales_price) AS sales,
         sum(sr_return_amt) AS refunds,
         count(*) AS cnt
  FROM store_sales
  JOIN store_returns ON sr_item_sk = ss_item_sk
                    AND sr_ticket_number = ss_ticket_number
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  JOIN item ON i_item_sk = ss_item_sk
  JOIN customer ON c_customer_sk = ss_customer_sk
  JOIN customer_address ON ca_address_sk = c_current_addr_sk
  JOIN store ON s_store_sk = ss_store_sk
  WHERE i_current_price BETWEEN 5 AND 80
  GROUP BY i_item_sk, s_store_sk, c_customer_sk, ca_city, d_year)
SELECT i1, cu1, city1, sales1, sales2
FROM (SELECT item_sk AS i1, cust_sk AS cu1, city AS city1,
             sales AS sales1, cnt AS cnt1 FROM cs WHERE syear = 1998) cs1
JOIN (SELECT item_sk AS i2, cust_sk AS cu2, city AS city2,
             sales AS sales2, cnt AS cnt2 FROM cs WHERE syear = 1999) cs2
  ON i1 = i2 AND cu1 = cu2
WHERE sales2 > sales1
ORDER BY i1, cu1, city1, sales2
LIMIT 100
"""

Q66 = """
SELECT s_city, s_state, d_year,
       sum(CASE WHEN d_moy = 1 THEN ss_ext_sales_price ELSE 0.0 END)
         AS jan_sales,
       sum(CASE WHEN d_moy = 2 THEN ss_ext_sales_price ELSE 0.0 END)
         AS feb_sales,
       sum(CASE WHEN d_moy = 3 THEN ss_ext_sales_price ELSE 0.0 END)
         AS mar_sales,
       sum(CASE WHEN d_moy = 4 THEN ss_ext_sales_price ELSE 0.0 END)
         AS apr_sales,
       sum(CASE WHEN d_moy = 5 THEN ss_ext_sales_price ELSE 0.0 END)
         AS may_sales,
       sum(CASE WHEN d_moy = 6 THEN ss_ext_sales_price ELSE 0.0 END)
         AS jun_sales,
       sum(CASE WHEN d_moy >= 7 THEN ss_ext_sales_price ELSE 0.0 END)
         AS h2_sales
FROM store_sales
JOIN store ON s_store_sk = ss_store_sk
JOIN date_dim ON d_date_sk = ss_sold_date_sk
GROUP BY s_city, s_state, d_year
ORDER BY s_city, s_state, d_year
"""

Q69 = """
SELECT c_state, c_education, count(*) AS cnt
FROM customer
LEFT SEMI JOIN store_sales ON ss_customer_sk = c_customer_sk
LEFT ANTI JOIN web_sales ON ws_bill_customer_sk = c_customer_sk
GROUP BY c_state, c_education
ORDER BY c_state, c_education
"""

Q71 = """
SELECT i_brand, d_dom, sum(ext_price) AS ext_price
FROM (
  SELECT ss_item_sk AS sold_item_sk, ss_sold_date_sk AS time_sk,
         ss_ext_sales_price AS ext_price
  FROM store_sales
  UNION ALL
  SELECT cs_item_sk AS sold_item_sk, cs_sold_date_sk AS time_sk,
         cs_ext_sales_price AS ext_price
  FROM catalog_sales
  UNION ALL
  SELECT ws_item_sk AS sold_item_sk, ws_sold_date_sk AS time_sk,
         ws_ext_sales_price AS ext_price
  FROM web_sales
)
JOIN item ON i_item_sk = sold_item_sk
JOIN date_dim ON d_date_sk = time_sk
WHERE d_moy = 11 AND i_manufact_id BETWEEN 1 AND 40
GROUP BY i_brand, d_dom
ORDER BY i_brand, d_dom
LIMIT 100
"""

Q74 = """
WITH year_total AS (
  SELECT ss_customer_sk AS customer_sk, d_year AS dyear,
         max(ss_ext_sales_price) AS year_max, 's' AS sale_type
  FROM store_sales JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE ss_customer_sk IS NOT NULL
  GROUP BY ss_customer_sk, d_year
  UNION ALL
  SELECT ws_bill_customer_sk AS customer_sk, d_year AS dyear,
         max(ws_ext_sales_price) AS year_max, 'w' AS sale_type
  FROM web_sales JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE ws_bill_customer_sk IS NOT NULL
  GROUP BY ws_bill_customer_sk, d_year)
SELECT s1_cust
FROM (SELECT customer_sk AS s1_cust, year_max AS s1_tot FROM year_total
      WHERE sale_type = 's' AND dyear = 1998) s1
JOIN (SELECT customer_sk AS s2_cust, year_max AS s2_tot FROM year_total
      WHERE sale_type = 's' AND dyear = 1999) s2 ON s1_cust = s2_cust
JOIN (SELECT customer_sk AS w1_cust, year_max AS w1_tot FROM year_total
      WHERE sale_type = 'w' AND dyear = 1998) w1 ON s1_cust = w1_cust
JOIN (SELECT customer_sk AS w2_cust, year_max AS w2_tot FROM year_total
      WHERE sale_type = 'w' AND dyear = 1999) w2 ON s1_cust = w2_cust
WHERE s1_tot > 0 AND w1_tot > 0 AND w2_tot / w1_tot > s2_tot / s1_tot
ORDER BY s1_cust
LIMIT 100
"""

Q75 = """
WITH all_sales AS (
  SELECT d_year AS yr, i_brand AS brand, sum(sales_cnt) AS sales_cnt
  FROM (
    SELECT d_year, i_brand, ss_quantity AS sales_cnt
    FROM store_sales JOIN item ON i_item_sk = ss_item_sk
    JOIN date_dim ON d_date_sk = ss_sold_date_sk
    UNION ALL
    SELECT d_year, i_brand, cs_quantity AS sales_cnt
    FROM catalog_sales JOIN item ON i_item_sk = cs_item_sk
    JOIN date_dim ON d_date_sk = cs_sold_date_sk
    UNION ALL
    SELECT d_year, i_brand, ws_quantity AS sales_cnt
    FROM web_sales JOIN item ON i_item_sk = ws_item_sk
    JOIN date_dim ON d_date_sk = ws_sold_date_sk
  )
  GROUP BY d_year, i_brand)
SELECT cy_brand, py_cnt, cy_cnt, cy_cnt - py_cnt AS sales_cnt_diff
FROM (SELECT brand AS cy_brand, sales_cnt AS cy_cnt FROM all_sales
      WHERE yr = 1999) cy
JOIN (SELECT brand AS py_brand, sales_cnt AS py_cnt FROM all_sales
      WHERE yr = 1998) py ON cy_brand = py_brand
WHERE cy_cnt < py_cnt
ORDER BY sales_cnt_diff, cy_brand
LIMIT 100
"""

Q76 = """
SELECT channel, col_name, d_year, d_qoy, i_category,
       count(*) AS sales_cnt, sum(ext_sales_price) AS sales_amt
FROM (
  SELECT 'store' AS channel, 'ss_customer_sk' AS col_name, d_year, d_qoy,
         i_category, ss_ext_sales_price AS ext_sales_price
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE ss_customer_sk IS NULL
  UNION ALL
  SELECT 'catalog' AS channel, 'cs_bill_customer_sk' AS col_name, d_year,
         d_qoy, i_category, cs_ext_sales_price AS ext_sales_price
  FROM catalog_sales
  JOIN item ON i_item_sk = cs_item_sk
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE cs_bill_customer_sk IS NULL
  UNION ALL
  SELECT 'web' AS channel, 'ws_bill_customer_sk' AS col_name, d_year,
         d_qoy, i_category, ws_ext_sales_price AS ext_sales_price
  FROM web_sales
  JOIN item ON i_item_sk = ws_item_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE ws_bill_customer_sk IS NULL
)
GROUP BY channel, col_name, d_year, d_qoy, i_category
ORDER BY channel, col_name, d_year, d_qoy, i_category
LIMIT 100
"""

Q78 = """
WITH ss_noret AS (
  SELECT d_year AS ss_year, ss_item_sk AS ss_item,
         ss_customer_sk AS ss_cust,
         sum(ss_quantity) AS ss_qty, sum(ss_sales_price) AS ss_amt
  FROM store_sales
  LEFT JOIN store_returns ON sr_ticket_number = ss_ticket_number
                         AND sr_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE sr_ticket_number IS NULL AND ss_customer_sk IS NOT NULL
  GROUP BY d_year, ss_item_sk, ss_customer_sk),
ws_noret AS (
  SELECT d_year AS ws_year, ws_item_sk AS ws_item,
         ws_bill_customer_sk AS ws_cust,
         sum(ws_quantity) AS ws_qty, sum(ws_sales_price) AS ws_amt
  FROM web_sales
  LEFT JOIN web_returns ON wr_order_number = ws_order_number
                       AND wr_item_sk = ws_item_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE wr_order_number IS NULL AND ws_bill_customer_sk IS NOT NULL
  GROUP BY d_year, ws_item_sk, ws_bill_customer_sk)
SELECT ss_year, ss_item, ss_cust, ss_qty, ws_qty
FROM ss_noret
JOIN ws_noret ON ws_year = ss_year AND ws_item = ss_item
             AND ws_cust = ss_cust
WHERE ws_qty > 0
ORDER BY ss_year, ss_item, ss_cust
LIMIT 100
"""

Q81 = """
WITH cr_total AS (
  SELECT cr_refunded_customer_sk AS crt_cust, c_state AS crt_state,
         sum(cr_return_amount) AS crt_total
  FROM catalog_returns
  JOIN customer ON c_customer_sk = cr_refunded_customer_sk
  JOIN date_dim ON d_date_sk = cr_returned_date_sk
  WHERE d_year = 1998
  GROUP BY cr_refunded_customer_sk, c_state),
state_avg AS (
  SELECT crt_state AS sa_state, avg(crt_total) * 1.2 AS threshold
  FROM cr_total GROUP BY crt_state)
SELECT crt_cust, crt_total
FROM cr_total
JOIN state_avg ON crt_state = sa_state
WHERE crt_total > threshold
ORDER BY crt_cust
LIMIT 100
"""

Q82 = """
SELECT i_item_sk, i_brand, i_current_price
FROM item
LEFT SEMI JOIN store_sales ON ss_item_sk = i_item_sk
WHERE i_current_price BETWEEN 50 AND 70
ORDER BY i_item_sk
LIMIT 100
"""

Q85 = """
SELECT hd_buy_potential,
       avg(wr_return_quantity) AS avg_ret_qty,
       avg(wr_return_amt) AS avg_ret_amt,
       count(*) AS cnt
FROM web_returns
JOIN customer ON c_customer_sk = wr_refunded_customer_sk
JOIN household_demographics ON hd_demo_sk = c_current_hdemo_sk
GROUP BY hd_buy_potential
ORDER BY hd_buy_potential
"""

Q88 = """
SELECT c1, c2, c3, c4
FROM (SELECT count(*) AS c1 FROM store_sales
      JOIN date_dim ON d_date_sk = ss_sold_date_sk
      WHERE d_dom BETWEEN 1 AND 7) t1
CROSS JOIN
     (SELECT count(*) AS c2 FROM store_sales
      JOIN date_dim ON d_date_sk = ss_sold_date_sk
      WHERE d_dom BETWEEN 8 AND 14) t2
CROSS JOIN
     (SELECT count(*) AS c3 FROM store_sales
      JOIN date_dim ON d_date_sk = ss_sold_date_sk
      WHERE d_dom BETWEEN 15 AND 21) t3
CROSS JOIN
     (SELECT count(*) AS c4 FROM store_sales
      JOIN date_dim ON d_date_sk = ss_sold_date_sk
      WHERE d_dom BETWEEN 22 AND 30) t4
"""

Q90 = """
SELECT am_cnt * 1.0 / pm_cnt AS am_pm_ratio
FROM (SELECT count(*) AS am_cnt FROM web_sales
      JOIN date_dim ON d_date_sk = ws_sold_date_sk
      WHERE d_dom < 15) am
CROSS JOIN
     (SELECT count(*) AS pm_cnt FROM web_sales
      JOIN date_dim ON d_date_sk = ws_sold_date_sk
      WHERE d_dom >= 15) pm
"""

Q91 = """
SELECT c_education, d_moy,
       sum(sr_return_amt) AS returns_loss
FROM store_returns
JOIN customer ON c_customer_sk = sr_customer_sk
JOIN date_dim ON d_date_sk = sr_returned_date_sk
WHERE d_year = 1998
GROUP BY c_education, d_moy
ORDER BY c_education, d_moy
"""

Q94 = """
SELECT count(DISTINCT ws_order_number) AS order_count,
       sum(ws_ext_sales_price) AS total_shipping_cost,
       sum(ws_net_profit) AS total_net_profit
FROM web_sales
LEFT ANTI JOIN web_returns ON wr_order_number = ws_order_number
JOIN date_dim ON d_date_sk = ws_sold_date_sk
WHERE d_year = 1998
"""

Q96 = """
SELECT count(*) AS cnt
FROM store_sales
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN household_demographics ON hd_demo_sk = c_current_hdemo_sk
JOIN store ON s_store_sk = ss_store_sk
WHERE hd_dep_count = 5 AND s_state = 'CA'
"""

Q97 = """
WITH ssci AS (
  SELECT ss_customer_sk AS s_cust, ss_item_sk AS s_item
  FROM store_sales
  WHERE ss_customer_sk IS NOT NULL
  GROUP BY ss_customer_sk, ss_item_sk),
csci AS (
  SELECT cs_bill_customer_sk AS c_cust, cs_item_sk AS c_item
  FROM catalog_sales
  WHERE cs_bill_customer_sk IS NOT NULL
  GROUP BY cs_bill_customer_sk, cs_item_sk)
SELECT sum(CASE WHEN s_cust IS NOT NULL AND c_cust IS NULL
                THEN 1 ELSE 0 END) AS store_only,
       sum(CASE WHEN s_cust IS NULL AND c_cust IS NOT NULL
                THEN 1 ELSE 0 END) AS catalog_only,
       sum(CASE WHEN s_cust IS NOT NULL AND c_cust IS NOT NULL
                THEN 1 ELSE 0 END) AS store_and_catalog
FROM ssci
FULL JOIN csci ON s_cust = c_cust AND s_item = c_item
"""

Q99 = """
SELECT d_moy,
       sum(CASE WHEN cr_returned_date_sk - cs_sold_date_sk <= 30
                THEN 1 ELSE 0 END) AS d30,
       sum(CASE WHEN cr_returned_date_sk - cs_sold_date_sk > 30
                 AND cr_returned_date_sk - cs_sold_date_sk <= 60
                THEN 1 ELSE 0 END) AS d60,
       sum(CASE WHEN cr_returned_date_sk - cs_sold_date_sk > 60
                THEN 1 ELSE 0 END) AS d90plus
FROM catalog_sales
JOIN catalog_returns ON cr_order_number = cs_order_number
                    AND cr_item_sk = cs_item_sk
JOIN date_dim ON d_date_sk = cs_sold_date_sk
GROUP BY d_moy
ORDER BY d_moy
"""

SS_MAX = """
SELECT count(*) AS total,
       count(ss_sold_date_sk) AS cnt_date,
       max(ss_sold_date_sk) AS max_date,
       max(ss_item_sk) AS max_item,
       max(ss_customer_sk) AS max_cust,
       max(ss_quantity) AS max_qty,
       max(ss_ext_sales_price) AS max_price
FROM store_sales
"""


# -- round-5 wave 2: the 18 queries closing the reference's 103-query list
# (tpcds_test.py:21-50) -------------------------------------------------

Q6 = """
SELECT c_state, count(*) AS cnt
FROM store_sales
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN item ON i_item_sk = ss_item_sk
JOIN date_dim ON d_date_sk = ss_sold_date_sk
JOIN (
  SELECT i_category AS cat, avg(i_current_price) AS avg_price
  FROM item GROUP BY i_category
) a ON i_category = cat
WHERE d_year = 1998 AND d_moy = 1 AND i_current_price > 1.2 * avg_price
GROUP BY c_state
HAVING count(*) >= 10
ORDER BY cnt, c_state
LIMIT 100
"""

Q14A = """
WITH cross_items AS (
  SELECT ss_item_sk AS ci_item_sk FROM store_sales
  INTERSECT
  SELECT cs_item_sk FROM catalog_sales
  INTERSECT
  SELECT ws_item_sk FROM web_sales),
avg_sales AS (
  SELECT avg(q * p) AS average_sales FROM (
    SELECT ss_quantity AS q, ss_sales_price AS p FROM store_sales
    UNION ALL
    SELECT cs_quantity, cs_sales_price FROM catalog_sales
    UNION ALL
    SELECT ws_quantity, ws_sales_price FROM web_sales))
SELECT channel, i_brand, sum_sales
FROM (
  SELECT channel, i_brand, sum(sales) AS sum_sales
  FROM (
    SELECT 'store' AS channel, i_brand,
           ss_quantity * ss_sales_price AS sales
    FROM store_sales
    JOIN item ON i_item_sk = ss_item_sk
    LEFT SEMI JOIN cross_items ON ci_item_sk = ss_item_sk
    UNION ALL
    SELECT 'catalog' AS channel, i_brand,
           cs_quantity * cs_sales_price AS sales
    FROM catalog_sales
    JOIN item ON i_item_sk = cs_item_sk
    LEFT SEMI JOIN cross_items ON ci_item_sk = cs_item_sk
    UNION ALL
    SELECT 'web' AS channel, i_brand,
           ws_quantity * ws_sales_price AS sales
    FROM web_sales
    JOIN item ON i_item_sk = ws_item_sk
    LEFT SEMI JOIN cross_items ON ci_item_sk = ws_item_sk
  )
  GROUP BY channel, i_brand
) CROSS JOIN avg_sales
WHERE sum_sales > average_sales
ORDER BY channel, i_brand
LIMIT 100
"""

Q14B = """
WITH cross_items AS (
  SELECT ss_item_sk AS ci_item_sk FROM store_sales
  INTERSECT
  SELECT cs_item_sk FROM catalog_sales
  INTERSECT
  SELECT ws_item_sk FROM web_sales)
SELECT ty.i_brand, ty_sales, ly_sales, ty_sales / ly_sales AS growth
FROM (
  SELECT i_brand, sum(ss_quantity * ss_sales_price) AS ty_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  LEFT SEMI JOIN cross_items ON ci_item_sk = ss_item_sk
  WHERE d_year = 1999
  GROUP BY i_brand
) ty
JOIN (
  SELECT i_brand AS ly_brand,
         sum(ss_quantity * ss_sales_price) AS ly_sales
  FROM store_sales
  JOIN item ON i_item_sk = ss_item_sk
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  LEFT SEMI JOIN cross_items ON ci_item_sk = ss_item_sk
  WHERE d_year = 1998
  GROUP BY i_brand
) ly ON ly_brand = ty.i_brand
WHERE ly_sales > 0
ORDER BY ty.i_brand
LIMIT 100
"""

Q16 = """
SELECT count(DISTINCT cs_order_number) AS order_count,
       sum(cs_ext_sales_price) AS total_shipping_cost,
       sum(cs_net_profit) AS total_net_profit
FROM catalog_sales
LEFT ANTI JOIN catalog_returns ON cr_order_number = cs_order_number
LEFT SEMI JOIN (
  SELECT multi_wh_order FROM (
    SELECT cs_order_number AS multi_wh_order, cs_warehouse_sk
    FROM catalog_sales
    GROUP BY cs_order_number, cs_warehouse_sk
  )
  GROUP BY multi_wh_order
  HAVING count(*) > 1
) mw ON multi_wh_order = cs_order_number
JOIN date_dim ON d_date_sk = cs_sold_date_sk
WHERE d_year = 1998 AND d_moy BETWEEN 2 AND 4
"""

Q18 = """
SELECT i_category, c_state,
       avg(cs_quantity) AS agg1,
       avg(cs_sales_price) AS agg2,
       avg(cs_ext_sales_price) AS agg3,
       avg(cs_net_profit) AS agg4
FROM catalog_sales
JOIN item ON i_item_sk = cs_item_sk
JOIN customer ON c_customer_sk = cs_bill_customer_sk
JOIN date_dim ON d_date_sk = cs_sold_date_sk
WHERE d_year = 1998
GROUP BY ROLLUP(i_category, c_state)
ORDER BY i_category, c_state
LIMIT 100
"""

Q21 = """
SELECT *
FROM (
  SELECT w_warehouse_name, inv_item_sk,
         sum(CASE WHEN d_date_sk < 365
                  THEN inv_quantity_on_hand ELSE 0 END) AS inv_before,
         sum(CASE WHEN d_date_sk >= 365
                  THEN inv_quantity_on_hand ELSE 0 END) AS inv_after
  FROM inventory
  JOIN warehouse ON w_warehouse_sk = inv_warehouse_sk
  JOIN date_dim ON d_date_sk = inv_date_sk
  GROUP BY w_warehouse_name, inv_item_sk
)
WHERE inv_before > 0
  AND inv_after / inv_before >= 0.666
  AND inv_after / inv_before <= 1.5
ORDER BY w_warehouse_name, inv_item_sk
LIMIT 100
"""

Q24A = """
WITH ssales AS (
  SELECT c_customer_sk AS cust, s_store_sk AS store_sk,
         i_item_sk AS item_sk, sum(ss_sales_price) AS netpaid
  FROM store_sales
  JOIN store ON s_store_sk = ss_store_sk
  JOIN item ON i_item_sk = ss_item_sk
  JOIN customer ON c_customer_sk = ss_customer_sk
  WHERE i_category = 'Jewelry'
  GROUP BY c_customer_sk, s_store_sk, i_item_sk)
SELECT cust, paid
FROM (
  SELECT cust, sum(netpaid) AS paid FROM ssales GROUP BY cust
) CROSS JOIN (
  SELECT 0.05 * avg(netpaid) AS thr FROM ssales
) t
WHERE paid > thr
ORDER BY cust
LIMIT 100
"""

Q24B = """
WITH ssales AS (
  SELECT c_customer_sk AS cust, s_store_sk AS store_sk,
         i_item_sk AS item_sk, sum(ss_sales_price) AS netpaid
  FROM store_sales
  JOIN store ON s_store_sk = ss_store_sk
  JOIN item ON i_item_sk = ss_item_sk
  JOIN customer ON c_customer_sk = ss_customer_sk
  WHERE i_category = 'Electronics'
  GROUP BY c_customer_sk, s_store_sk, i_item_sk)
SELECT cust, paid
FROM (
  SELECT cust, sum(netpaid) AS paid FROM ssales GROUP BY cust
) CROSS JOIN (
  SELECT 0.05 * avg(netpaid) AS thr FROM ssales
) t
WHERE paid > thr
ORDER BY cust
LIMIT 100
"""

Q32 = """
WITH avg_disc AS (
  SELECT cs_item_sk AS ad_item,
         1.3 * avg(cs_ext_discount_amt) AS thr
  FROM catalog_sales
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_year = 1998
  GROUP BY cs_item_sk)
SELECT sum(cs_ext_discount_amt) AS excess_discount
FROM catalog_sales
JOIN avg_disc ON ad_item = cs_item_sk
JOIN date_dim ON d_date_sk = cs_sold_date_sk
WHERE d_year = 1998 AND cs_ext_discount_amt > thr
"""

Q58 = """
WITH ss_items AS (
  SELECT ss_item_sk AS s_item, sum(ss_ext_sales_price) AS ss_rev
  FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_moy = 3 GROUP BY ss_item_sk),
cs_items AS (
  SELECT cs_item_sk AS c_item, sum(cs_ext_sales_price) AS cs_rev
  FROM catalog_sales
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_moy = 3 GROUP BY cs_item_sk),
ws_items AS (
  SELECT ws_item_sk AS w_item, sum(ws_ext_sales_price) AS ws_rev
  FROM web_sales
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_moy = 3 GROUP BY ws_item_sk)
SELECT s_item, ss_rev, cs_rev, ws_rev,
       (ss_rev + cs_rev + ws_rev) / 3 AS average
FROM ss_items
JOIN cs_items ON c_item = s_item
JOIN ws_items ON w_item = s_item
WHERE ss_rev >= 0.9 * cs_rev AND ss_rev <= 1.1 * cs_rev
  AND ss_rev >= 0.9 * ws_rev AND ss_rev <= 1.1 * ws_rev
ORDER BY s_item
LIMIT 100
"""

Q70 = """
SELECT total_sum, s_state, ranking
FROM (
  SELECT s_state, total_sum,
         rank() OVER (ORDER BY total_sum DESC) AS ranking
  FROM (
    SELECT s_state, sum(ss_net_profit) AS total_sum
    FROM store_sales
    JOIN store ON s_store_sk = ss_store_sk
    JOIN date_dim ON d_date_sk = ss_sold_date_sk
    WHERE d_year = 1998
    GROUP BY s_state
  )
)
ORDER BY ranking, s_state
"""

Q72 = """
SELECT i_item_sk AS item_sk, w_warehouse_name, d_week_seq,
       count(*) AS low_stock_cnt
FROM catalog_sales
JOIN inventory ON inv_item_sk = cs_item_sk
JOIN warehouse ON w_warehouse_sk = inv_warehouse_sk
JOIN item ON i_item_sk = cs_item_sk
JOIN date_dim ON d_date_sk = cs_sold_date_sk
WHERE inv_quantity_on_hand < cs_quantity AND d_year = 1998
GROUP BY i_item_sk, w_warehouse_name, d_week_seq
ORDER BY low_stock_cnt DESC, i_item_sk, w_warehouse_name, d_week_seq
LIMIT 100
"""

Q77 = """
WITH ss AS (
  SELECT ss_store_sk AS store_id, sum(ss_ext_sales_price) AS sales,
         sum(ss_net_profit) AS profit
  FROM store_sales
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  WHERE d_year = 1998 GROUP BY ss_store_sk),
sr AS (
  SELECT sr_store_sk AS ret_store_id, sum(sr_return_amt) AS ret
  FROM store_returns GROUP BY sr_store_sk),
cs AS (
  SELECT sum(cs_ext_sales_price) AS sales, sum(cs_net_profit) AS profit
  FROM catalog_sales
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_year = 1998),
cr AS (
  SELECT sum(cr_return_amount) AS ret FROM catalog_returns),
ws AS (
  SELECT ws_warehouse_sk AS wh_id, sum(ws_ext_sales_price) AS sales,
         sum(ws_net_profit) AS profit
  FROM web_sales
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_year = 1998 GROUP BY ws_warehouse_sk),
wr AS (
  SELECT ws_warehouse_sk AS ret_wh_id, sum(wr_return_amt) AS ret
  FROM web_returns
  JOIN web_sales ON ws_order_number = wr_order_number
                AND ws_item_sk = wr_item_sk
  GROUP BY ws_warehouse_sk)
SELECT channel, id, sum(sales) AS sales, sum(ret) AS ret,
       sum(profit) AS profit
FROM (
  SELECT 'store channel' AS channel, store_id AS id, sales,
         coalesce(ret, 0.0) AS ret, profit
  FROM ss LEFT JOIN sr ON ret_store_id = store_id
  UNION ALL
  SELECT 'catalog channel' AS channel, 0 AS id, sales, ret, profit
  FROM cs CROSS JOIN cr
  UNION ALL
  SELECT 'web channel' AS channel, wh_id AS id, sales,
         coalesce(ret, 0.0) AS ret, profit
  FROM ws LEFT JOIN wr ON ret_wh_id = wh_id
)
GROUP BY ROLLUP(channel, id)
ORDER BY channel, id
LIMIT 100
"""

Q80 = """
WITH ssr AS (
  SELECT s_store_sk AS id, sum(ss_ext_sales_price) AS sales,
         sum(coalesce(sr_return_amt, 0.0)) AS ret,
         sum(ss_net_profit) AS profit
  FROM store_sales
  LEFT JOIN store_returns ON sr_item_sk = ss_item_sk
                         AND sr_ticket_number = ss_ticket_number
  JOIN date_dim ON d_date_sk = ss_sold_date_sk
  JOIN store ON s_store_sk = ss_store_sk
  WHERE d_year = 1998
  GROUP BY s_store_sk),
csr AS (
  SELECT cs_warehouse_sk AS id, sum(cs_ext_sales_price) AS sales,
         sum(coalesce(cr_return_amount, 0.0)) AS ret,
         sum(cs_net_profit) AS profit
  FROM catalog_sales
  LEFT JOIN catalog_returns ON cr_item_sk = cs_item_sk
                           AND cr_order_number = cs_order_number
  JOIN date_dim ON d_date_sk = cs_sold_date_sk
  WHERE d_year = 1998
  GROUP BY cs_warehouse_sk),
wsr AS (
  SELECT ws_warehouse_sk AS id, sum(ws_ext_sales_price) AS sales,
         sum(coalesce(wr_return_amt, 0.0)) AS ret,
         sum(ws_net_profit) AS profit
  FROM web_sales
  LEFT JOIN web_returns ON wr_item_sk = ws_item_sk
                       AND wr_order_number = ws_order_number
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_year = 1998
  GROUP BY ws_warehouse_sk)
SELECT channel, id, sum(sales) AS sales, sum(ret) AS ret,
       sum(profit) AS profit
FROM (
  SELECT 'store channel' AS channel, id, sales, ret, profit FROM ssr
  UNION ALL
  SELECT 'catalog channel' AS channel, id, sales, ret, profit FROM csr
  UNION ALL
  SELECT 'web channel' AS channel, id, sales, ret, profit FROM wsr
)
GROUP BY ROLLUP(channel, id)
ORDER BY channel, id
LIMIT 100
"""

Q83 = """
WITH sr AS (
  SELECT sr_item_sk AS s_item, sum(sr_return_quantity) AS sr_qty
  FROM store_returns
  JOIN date_dim ON d_date_sk = sr_returned_date_sk
  WHERE d_moy BETWEEN 6 AND 8 GROUP BY sr_item_sk),
cr AS (
  SELECT cr_item_sk AS c_item, sum(cr_return_quantity) AS cr_qty
  FROM catalog_returns
  JOIN date_dim ON d_date_sk = cr_returned_date_sk
  WHERE d_moy BETWEEN 6 AND 8 GROUP BY cr_item_sk),
wr AS (
  SELECT wr_item_sk AS w_item, sum(wr_return_quantity) AS wr_qty
  FROM web_returns
  JOIN date_dim ON d_date_sk = wr_returned_date_sk
  WHERE d_moy BETWEEN 6 AND 8 GROUP BY wr_item_sk)
SELECT s_item, sr_qty, cr_qty, wr_qty,
       sr_qty + cr_qty + wr_qty AS total_qty
FROM sr
JOIN cr ON c_item = s_item
JOIN wr ON w_item = s_item
ORDER BY s_item
LIMIT 100
"""

Q84 = """
SELECT c_customer_sk, c_first_name, count(*) AS cnt
FROM store_returns
JOIN customer ON c_customer_sk = sr_customer_sk
JOIN customer_address ON ca_address_sk = c_current_addr_sk
JOIN household_demographics ON hd_demo_sk = c_current_hdemo_sk
WHERE ca_city = 'Midway' AND hd_dep_count >= 3
GROUP BY c_customer_sk, c_first_name
ORDER BY c_customer_sk
LIMIT 100
"""

Q86 = """
SELECT i_category, i_class, total_sum,
       rank() OVER (PARTITION BY i_category
                    ORDER BY total_sum DESC) AS rank_within
FROM (
  SELECT i_category, i_class, sum(ws_net_profit) AS total_sum
  FROM web_sales
  JOIN item ON i_item_sk = ws_item_sk
  JOIN date_dim ON d_date_sk = ws_sold_date_sk
  WHERE d_year = 1998
  GROUP BY ROLLUP(i_category, i_class)
)
ORDER BY i_category, i_class, rank_within
LIMIT 100
"""

Q95 = """
WITH ws_wh AS (
  SELECT wh_order FROM (
    SELECT ws_order_number AS wh_order, ws_warehouse_sk
    FROM web_sales
    GROUP BY ws_order_number, ws_warehouse_sk
  )
  GROUP BY wh_order
  HAVING count(*) > 1)
SELECT count(DISTINCT ws_order_number) AS order_count,
       sum(ws_ext_sales_price) AS total_shipping_cost,
       sum(ws_net_profit) AS total_net_profit
FROM web_sales
LEFT SEMI JOIN ws_wh ON wh_order = ws_order_number
LEFT SEMI JOIN web_returns ON wr_order_number = ws_order_number
JOIN date_dim ON d_date_sk = ws_sold_date_sk
WHERE d_year = 1998
"""

QUERIES = {"q3": Q3, "q7": Q7, "q13": Q13, "q14": Q14, "q19": Q19,
           "q26": Q26, "q29": Q29, "q36": Q36, "q42": Q42, "q43": Q43,
           "q48": Q48, "q52": Q52, "q53": Q53, "q55": Q55, "q59": Q59,
           "q61": Q61, "q65": Q65, "q68": Q68, "q73": Q73, "q79": Q79,
           "q89": Q89, "q98": Q98,
           "q2": Q2, "q22": Q22, "q25": Q25, "q33": Q33,
           "q34": Q34, "q51": Q51, "q92": Q92, "q93": Q93,
           "q38": Q38, "q87": Q87, "q67": Q67,
           # round-5 additions
           "q1": Q1, "q4": Q4, "q5": Q5, "q8": Q8, "q9": Q9,
           "q10": Q10, "q11": Q11, "q12": Q12, "q15": Q15, "q17": Q17,
           "q20": Q20, "q23a": Q23A, "q23b": Q23B, "q27": Q27,
           "q28": Q28, "q30": Q30, "q31": Q31,
           "q35": Q35, "q37": Q37, "q39a": Q39A, "q39b": Q39B,
           "q40": Q40, "q41": Q41, "q44": Q44, "q45": Q45, "q46": Q46,
           "q47": Q47, "q49": Q49, "q50": Q50, "q54": Q54, "q56": Q56,
           "q57": Q57, "q60": Q60, "q62": Q62, "q63": Q63, "q64": Q64,
           "q66": Q66, "q69": Q69, "q71": Q71, "q74": Q74, "q75": Q75,
           "q76": Q76, "q78": Q78, "q81": Q81, "q82": Q82, "q85": Q85,
           "q88": Q88, "q90": Q90, "q91": Q91, "q94": Q94, "q96": Q96,
           "q97": Q97, "q99": Q99, "ss_max": SS_MAX,
           # round-5 wave 2: the final 18 of the reference's 103-query list
           "q6": Q6, "q14a": Q14A, "q14b": Q14B, "q16": Q16, "q18": Q18,
           "q21": Q21, "q24a": Q24A, "q24b": Q24B, "q32": Q32,
           "q58": Q58, "q70": Q70, "q72": Q72, "q77": Q77, "q80": Q80,
           "q83": Q83, "q84": Q84, "q86": Q86, "q95": Q95}
