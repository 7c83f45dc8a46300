"""The port's copy of ``spark_rapids_tpu/benchmarks/tpcxbb_like.py``: the
same generators (the same arrays for the same sf and seeds) and the same
eight texts, with ``register_tpcxbb`` over the port's session
(``build_tables`` gives its tables by name).  The reference's
description:

TPCxBB-like benchmark: clickstream + multi-channel retail schema and
the machine-generated-analytics query shapes of the reference's
TpcxbbLikeSpark (integration_tests/.../tpcxbb/TpcxbbLikeSpark.scala,
tpcxbb_test.py) — the reference's second query family next to TPC-DS.

Queries follow the reference's *supported* subset (its own q1-q4/q8 etc.
throw UnsupportedOperationException for UDTF/python): the ML feature
build (q5), premium-item geography (q7), multi-dimension filter sum
(q9), before/after price-change pivot (q16), promotion ratio (q17),
return-segmentation ratios (q20), cross-channel re-purchase (q21) and
inventory stability (q22).  Adapted to the engine dialect: explicit
JOINs, LEFT SEMI JOIN instead of IN-subqueries, date_dim surrogate-key
windows instead of unix_timestamp string math, and post-aggregate
arithmetic expressed through nested subqueries.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import types as T

CATEGORIES = ["Books", "Electronics", "Home", "Jewelry", "Music",
              "Shoes", "Sports", "Toys"]
STATES = ["CA", "GA", "IL", "NY", "TX", "WA", None]
EDU = ["Advanced Degree", "College", "4 yr Degree", "2 yr Degree",
       "Secondary", "Primary"]


def _n(sf: float, base: int, floor: int = 20) -> int:
    return max(floor, int(sf * base))


def gen_item(sf: float, seed: int = 41) -> Dict:
    n = _n(sf, 2_000)
    r = np.random.RandomState(seed)
    return {
        "i_item_sk": (T.LONG, np.arange(1, n + 1)),
        "i_item_id": (T.STRING,
                      np.array([f"ITEM{i:06d}" for i in range(1, n + 1)],
                               dtype=object)),
        "i_item_desc": (T.STRING,
                        np.array([f"desc {i % 97}" for i in range(n)],
                                 dtype=object)),
        "i_category": (T.STRING, r.choice(CATEGORIES, n)),
        "i_category_id": (T.INT,
                          r.randint(1, 9, n).astype(np.int32)),
        "i_current_price": (T.DOUBLE, (r.rand(n) * 99 + 1).round(2)),
    }


def gen_customer(sf: float, seed: int = 42) -> Dict:
    n = _n(sf, 1_000)
    r = np.random.RandomState(seed)
    return {
        "c_customer_sk": (T.LONG, np.arange(1, n + 1)),
        "c_current_cdemo_sk": (T.LONG, r.randint(1, 101, n)),
        "c_current_addr_sk": (T.LONG, r.randint(1, 201, n)),
    }


def gen_customer_demographics(seed: int = 43) -> Dict:
    n = 100
    r = np.random.RandomState(seed)
    return {
        "cd_demo_sk": (T.LONG, np.arange(1, n + 1)),
        "cd_gender": (T.STRING, r.choice(["M", "F"], n)),
        "cd_education_status": (T.STRING, r.choice(EDU, n)),
    }


def gen_customer_address(seed: int = 44) -> Dict:
    n = 200
    r = np.random.RandomState(seed)
    state = r.choice(np.array(STATES, dtype=object), n)
    return {
        "ca_address_sk": (T.LONG, np.arange(1, n + 1)),
        "ca_state": (T.STRING, state),
        "ca_gmt_offset": (T.INT,
                          r.choice([-8, -6, -5], n).astype(np.int32)),
    }


def gen_store(seed: int = 45) -> Dict:
    n = 12
    r = np.random.RandomState(seed)
    return {
        "s_store_sk": (T.LONG, np.arange(1, n + 1)),
        "s_store_id": (T.STRING,
                       np.array([f"S{i:03d}" for i in range(1, n + 1)],
                                dtype=object)),
        "s_store_name": (T.STRING,
                         np.array([f"store {i}" for i in range(1, n + 1)],
                                  dtype=object)),
        "s_gmt_offset": (T.INT, r.choice([-8, -5], n).astype(np.int32)),
    }


def gen_warehouse(seed: int = 46) -> Dict:
    n = 6
    r = np.random.RandomState(seed)
    return {
        "w_warehouse_sk": (T.LONG, np.arange(1, n + 1)),
        "w_state": (T.STRING,
                    r.choice([s for s in STATES if s], n)),
    }


def gen_date_dim() -> Dict:
    n = 730
    sk = np.arange(1, n + 1)
    year = np.where(sk <= 365, 2001, 2004)
    doy = np.where(sk <= 365, sk, sk - 365)
    return {
        "d_date_sk": (T.LONG, sk),
        "d_year": (T.INT, year.astype(np.int32)),
        "d_moy": (T.INT,
                  np.minimum((doy - 1) // 30 + 1, 12).astype(np.int32)),
    }


def gen_promotion(seed: int = 47) -> Dict:
    n = 30
    r = np.random.RandomState(seed)
    return {
        "p_promo_sk": (T.LONG, np.arange(1, n + 1)),
        "p_channel_email": (T.STRING, r.choice(["Y", "N"], n)),
        "p_channel_dmail": (T.STRING, r.choice(["Y", "N"], n)),
        "p_channel_tv": (T.STRING, r.choice(["Y", "N"], n)),
    }


def gen_web_clickstreams(sf: float, seed: int = 48) -> Dict:
    n = _n(sf, 100_000, floor=200)
    r = np.random.RandomState(seed)
    n_item, n_cust = _n(sf, 2_000), _n(sf, 1_000)
    user = r.randint(1, n_cust + 1, n)
    null_mask = r.rand(n) < 0.1  # anonymous clicks -> NULL user
    users = [None if m else int(u) for u, m in zip(user, null_mask)]
    return {
        "wcs_user_sk": (T.LONG, users),
        "wcs_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
    }


def gen_store_sales(sf: float, seed: int = 49) -> Dict:
    n = _n(sf, 100_000, floor=200)
    r = np.random.RandomState(seed)
    n_item, n_cust = _n(sf, 2_000), _n(sf, 1_000)
    qty = r.randint(1, 101, n)
    price = (r.rand(n) * 200 + 1).round(2)
    return {
        "ss_sold_date_sk": (T.LONG, r.randint(1, 731, n)),
        "ss_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "ss_customer_sk": (T.LONG, r.randint(1, n_cust + 1, n)),
        "ss_cdemo_sk": (T.LONG, r.randint(1, 101, n)),
        "ss_addr_sk": (T.LONG, r.randint(1, 201, n)),
        "ss_store_sk": (T.LONG, r.randint(1, 13, n)),
        "ss_promo_sk": (T.LONG, r.randint(1, 31, n)),
        "ss_ticket_number": (T.LONG, r.randint(1, n // 3 + 2, n)),
        "ss_quantity": (T.INT, qty.astype(np.int32)),
        "ss_net_paid": (T.DOUBLE, (price * qty).round(2)),
        "ss_ext_sales_price": (T.DOUBLE, (price * qty).round(2)),
    }


def gen_store_returns(sf: float, seed: int = 50) -> Dict:
    n = _n(sf, 10_000, floor=40)
    r = np.random.RandomState(seed)
    n_item, n_cust = _n(sf, 2_000), _n(sf, 1_000)
    return {
        "sr_returned_date_sk": (T.LONG, r.randint(1, 731, n)),
        "sr_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "sr_customer_sk": (T.LONG, r.randint(1, n_cust + 1, n)),
        "sr_ticket_number": (T.LONG, r.randint(1, n // 2 + 2, n)),
        "sr_return_quantity": (T.INT,
                               r.randint(1, 30, n).astype(np.int32)),
        "sr_return_amt": (T.DOUBLE, (r.rand(n) * 300).round(2)),
    }


def gen_web_sales(sf: float, seed: int = 51) -> Dict:
    n = _n(sf, 50_000, floor=100)
    r = np.random.RandomState(seed)
    n_item, n_cust = _n(sf, 2_000), _n(sf, 1_000)
    return {
        "ws_sold_date_sk": (T.LONG, r.randint(1, 731, n)),
        "ws_order_number": (T.LONG, r.randint(1, n // 2 + 2, n)),
        "ws_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "ws_warehouse_sk": (T.LONG, r.randint(1, 7, n)),
        "ws_bill_customer_sk": (T.LONG, r.randint(1, n_cust + 1, n)),
        "ws_quantity": (T.INT, r.randint(1, 50, n).astype(np.int32)),
        "ws_sales_price": (T.DOUBLE, (r.rand(n) * 150 + 1).round(2)),
    }


def gen_web_returns(sf: float, seed: int = 52) -> Dict:
    n = _n(sf, 5_000, floor=20)
    r = np.random.RandomState(seed)
    n_item = _n(sf, 2_000)
    return {
        "wr_returned_date_sk": (T.LONG, r.randint(1, 731, n)),
        "wr_order_number": (T.LONG, r.randint(1, n + 2, n)),
        "wr_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "wr_refunded_cash": (T.DOUBLE, (r.rand(n) * 100).round(2)),
    }


def gen_inventory(sf: float, seed: int = 53) -> Dict:
    n = _n(sf, 40_000, floor=100)
    r = np.random.RandomState(seed)
    n_item = _n(sf, 2_000)
    return {
        "inv_date_sk": (T.LONG, r.randint(1, 731, n)),
        "inv_item_sk": (T.LONG, r.randint(1, n_item + 1, n)),
        "inv_warehouse_sk": (T.LONG, r.randint(1, 7, n)),
        "inv_quantity_on_hand": (T.INT,
                                 r.randint(0, 500, n).astype(np.int32)),
    }


def build_tables(sf: float) -> Dict[str, Dict]:
    """Every table at one scale, by name (``register_tpcxbb``'s tables)."""
    return {
        "item": gen_item(sf),
        "customer": gen_customer(sf),
        "customer_demographics": gen_customer_demographics(),
        "customer_address": gen_customer_address(),
        "store": gen_store(),
        "warehouse": gen_warehouse(),
        "date_dim": gen_date_dim(),
        "promotion": gen_promotion(),
        "web_clickstreams": gen_web_clickstreams(sf),
        "store_sales": gen_store_sales(sf),
        "store_returns": gen_store_returns(sf),
        "web_sales": gen_web_sales(sf),
        "web_returns": gen_web_returns(sf),
        "inventory": gen_inventory(sf),
    }


def register_tpcxbb(session, sf: float = 0.1, num_partitions: int = 3):
    for name, data in build_tables(sf).items():
        df = session.create_dataframe(data, num_partitions=num_partitions)
        session.register_view(name, df)


# -- queries (TpcxbbLikeSpark adaptation) ------------------------------------

Q5 = """
SELECT wcs_user_sk, clicks_in_category,
       CASE WHEN cd_education_status IN ('Advanced Degree', 'College',
                                         '4 yr Degree', '2 yr Degree')
            THEN 1 ELSE 0 END AS college_education,
       CASE WHEN cd_gender = 'M' THEN 1 ELSE 0 END AS male,
       clicks_in_1, clicks_in_2, clicks_in_3
FROM (
  SELECT wcs_user_sk,
         sum(CASE WHEN i_category = 'Books' THEN 1 ELSE 0 END)
           AS clicks_in_category,
         sum(CASE WHEN i_category_id = 1 THEN 1 ELSE 0 END) AS clicks_in_1,
         sum(CASE WHEN i_category_id = 2 THEN 1 ELSE 0 END) AS clicks_in_2,
         sum(CASE WHEN i_category_id = 3 THEN 1 ELSE 0 END) AS clicks_in_3
  FROM web_clickstreams
  JOIN item ON wcs_item_sk = i_item_sk AND wcs_user_sk IS NOT NULL
  GROUP BY wcs_user_sk
)
JOIN customer ON wcs_user_sk = c_customer_sk
JOIN customer_demographics ON c_current_cdemo_sk = cd_demo_sk
ORDER BY wcs_user_sk
"""

Q7 = """
SELECT ca_state, count(*) AS cnt
FROM store_sales
JOIN item ON ss_item_sk = i_item_sk
JOIN (
  SELECT i_category AS cat, avg(i_current_price) AS avg_price
  FROM item
  GROUP BY i_category
) ap ON i_category = cat
JOIN customer ON c_customer_sk = ss_customer_sk
JOIN customer_address ON ca_address_sk = c_current_addr_sk
LEFT SEMI JOIN (
  SELECT d_date_sk FROM date_dim WHERE d_year = 2004 AND d_moy = 7
) dd ON ss_sold_date_sk = d_date_sk
WHERE i_current_price > avg_price * 1.2 AND ca_state IS NOT NULL
GROUP BY ca_state
HAVING count(*) >= 2
ORDER BY cnt DESC, ca_state
LIMIT 10
"""

Q9 = """
SELECT sum(ss_quantity) AS total_quantity
FROM store_sales
JOIN date_dim ON ss_sold_date_sk = d_date_sk AND d_year = 2001
JOIN customer_demographics ON cd_demo_sk = ss_cdemo_sk
JOIN customer_address ON ca_address_sk = ss_addr_sk
WHERE ((cd_education_status = 'College'
          AND ss_quantity BETWEEN 1 AND 60)
    OR (cd_education_status = 'Advanced Degree'
          AND ss_quantity BETWEEN 40 AND 100))
  AND ((ca_state IN ('CA', 'TX') AND ss_net_paid BETWEEN 50 AND 12000)
    OR (ca_state IN ('NY', 'WA') AND ss_net_paid BETWEEN 150 AND 20000))
"""

Q16 = """
SELECT w_state, i_item_id,
       sum(CASE WHEN d_date_sk < 400
                THEN ws_sales_price - wr_cash ELSE 0.0 END)
         AS sales_before,
       sum(CASE WHEN d_date_sk >= 400
                THEN ws_sales_price - wr_cash ELSE 0.0 END)
         AS sales_after
FROM (
  SELECT ws_item_sk, ws_warehouse_sk, ws_sold_date_sk, ws_sales_price,
         coalesce(wr_refunded_cash, 0.0) AS wr_cash
  FROM web_sales
  LEFT JOIN web_returns ON ws_order_number = wr_order_number
    AND ws_item_sk = wr_item_sk
)
JOIN item ON ws_item_sk = i_item_sk
JOIN warehouse ON ws_warehouse_sk = w_warehouse_sk
JOIN date_dim ON ws_sold_date_sk = d_date_sk
  AND d_date_sk BETWEEN 370 AND 430
GROUP BY w_state, i_item_id
ORDER BY w_state, i_item_id
LIMIT 100
"""

Q17 = """
SELECT promotional, total,
       CASE WHEN total > 0 THEN 100.0 * promotional / total
            ELSE 0.0 END AS promo_percent
FROM (
  SELECT sum(promotional) AS promotional, sum(total) AS total
  FROM (
    SELECT CASE WHEN p_channel_dmail = 'Y' OR p_channel_email = 'Y'
                     OR p_channel_tv = 'Y'
                THEN sales ELSE 0.0 END AS promotional,
           sales AS total
    FROM (
      SELECT p_channel_email, p_channel_dmail, p_channel_tv,
             sum(ss_ext_sales_price) AS sales
      FROM store_sales
      LEFT SEMI JOIN (
        SELECT d_date_sk FROM date_dim WHERE d_year = 2001 AND d_moy = 12
      ) dd ON ss_sold_date_sk = d_date_sk
      LEFT SEMI JOIN (
        SELECT i_item_sk FROM item
        WHERE i_category IN ('Books', 'Music')
      ) it ON ss_item_sk = i_item_sk
      LEFT SEMI JOIN (
        SELECT s_store_sk FROM store WHERE s_gmt_offset = -5
      ) st ON ss_store_sk = s_store_sk
      JOIN promotion ON ss_promo_sk = p_promo_sk
      GROUP BY p_channel_email, p_channel_dmail, p_channel_tv
    )
  )
)
ORDER BY promotional, total
"""

# The reference wraps each ratio in round(x, 7); rounding to a fixed
# decimal place puts exact decimal-tie values one f64-emulation ULP from
# flipping, so the "like" adaptation compares the raw ratios instead
# (Round itself is covered by the expression suites).
Q20 = """
SELECT user_sk,
       CASE WHEN returns_count IS NULL OR orders_count IS NULL
            THEN 0.0
            ELSE returns_count / orders_count END AS orderratio,
       CASE WHEN returns_items IS NULL OR orders_items IS NULL
            THEN 0.0
            ELSE returns_items / orders_items END AS itemsratio,
       CASE WHEN returns_money IS NULL OR orders_money IS NULL
            THEN 0.0
            ELSE returns_money / orders_money END AS monetaryratio,
       round(CASE WHEN returns_count IS NULL THEN 0.0
                  ELSE returns_count END, 0) AS frequency
FROM (
  SELECT ss_customer_sk AS user_sk,
         orders_count, orders_items, orders_money,
         returns_count, returns_items, returns_money
  FROM (
    SELECT ss_customer_sk,
           count(DISTINCT ss_ticket_number) AS orders_count,
           count(ss_item_sk) AS orders_items,
           sum(ss_net_paid) AS orders_money
    FROM store_sales
    GROUP BY ss_customer_sk
  ) orders
  LEFT JOIN (
    SELECT sr_customer_sk,
           count(DISTINCT sr_ticket_number) AS returns_count,
           count(sr_item_sk) AS returns_items,
           sum(sr_return_amt) AS returns_money
    FROM store_returns
    GROUP BY sr_customer_sk
  ) returned ON ss_customer_sk = sr_customer_sk
)
ORDER BY user_sk
"""

Q21 = """
SELECT i_item_id, s_store_id,
       sum(ss_quantity) AS store_sales_quantity,
       sum(sr_return_quantity) AS store_returns_quantity
FROM store_sales
JOIN store_returns ON sr_customer_sk = ss_customer_sk
  AND sr_item_sk = ss_item_sk
  AND sr_returned_date_sk >= ss_sold_date_sk
JOIN item ON i_item_sk = ss_item_sk
JOIN store ON s_store_sk = ss_store_sk
LEFT SEMI JOIN (
  SELECT d_date_sk FROM date_dim WHERE d_year = 2001
) dd ON ss_sold_date_sk = d_date_sk
GROUP BY i_item_id, s_store_id
ORDER BY i_item_id, s_store_id
LIMIT 100
"""

Q22 = """
SELECT w_state, i_item_id, inv_before, inv_after
FROM (
  SELECT w_state, i_item_id,
         sum(CASE WHEN inv_date_sk < 400 THEN inv_quantity_on_hand
                  ELSE 0 END) AS inv_before,
         sum(CASE WHEN inv_date_sk >= 400 THEN inv_quantity_on_hand
                  ELSE 0 END) AS inv_after
  FROM inventory
  JOIN warehouse ON inv_warehouse_sk = w_warehouse_sk
  JOIN item ON inv_item_sk = i_item_sk
  WHERE i_current_price BETWEEN 10 AND 90
    AND inv_date_sk BETWEEN 370 AND 430
  GROUP BY w_state, i_item_id
)
WHERE inv_before > 0 AND inv_after >= inv_before * 0.666
  AND inv_after <= inv_before * 1.5
ORDER BY w_state, i_item_id
LIMIT 100
"""

QUERIES = {"q5": Q5, "q7": Q7, "q9": Q9, "q16": Q16, "q17": Q17,
           "q20": Q20, "q21": Q21, "q22": Q22}
