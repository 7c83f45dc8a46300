"""TPC-H-like queries the port runs as SQL text: Q1, Q3, Q5, Q6, Q10, Q12
and Q14, copied verbatim from ``spark_rapids_tpu/benchmarks/tpch_like.py``
(adapted there to the engine's envelope: date literals as days since the
epoch).  The other fifteen need residual join conditions, conditioned semi
joins, ``year()``, CASE over strings or subqueries the port lacks."""

from __future__ import annotations

# date literals as days-since-epoch: 1994-01-01 = 8766, 1995-01-01 = 9131,
# 1998-09-02 = 10471, 1995-03-15 = 9204
Q1 = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= 10471
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

Q3 = """
SELECT o_orderkey, o_orderdate, o_shippriority,
       sum(l_extendedprice) AS revenue
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON l_orderkey = o_orderkey
WHERE c_mktsegment = 'BUILDING'
  AND o_orderdate < 9204
  AND l_shipdate > 9204
GROUP BY o_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
"""

Q5 = """
SELECT n_name, sum(l_extendedprice) AS revenue
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON l_orderkey = o_orderkey
JOIN supplier ON l_suppkey = s_suppkey
JOIN nation ON s_nationkey = n_nationkey
WHERE o_orderdate >= 8766 AND o_orderdate < 9131
GROUP BY n_name
ORDER BY revenue DESC
"""

Q6 = """
SELECT sum(l_extendedprice) AS revenue
FROM lineitem
WHERE l_shipdate >= 8766 AND l_shipdate < 9131
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""

Q10 = """
SELECT c_custkey, c_name, sum(l_extendedprice) AS revenue, c_acctbal
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON l_orderkey = o_orderkey
WHERE o_orderdate >= 8766 AND o_orderdate < 8766 + 90
  AND l_returnflag = 'R'
GROUP BY c_custkey, c_name, c_acctbal
ORDER BY revenue DESC
LIMIT 20
"""

Q12 = """
SELECT l_shipmode, count(*) AS mode_count
FROM orders
JOIN lineitem ON o_orderkey = l_orderkey
WHERE l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate
  AND l_shipdate < l_commitdate
  AND l_receiptdate >= 8766 AND l_receiptdate < 9131
GROUP BY l_shipmode
ORDER BY l_shipmode
"""

Q14 = """
SELECT sum(l_extendedprice) AS promo_revenue
FROM lineitem
WHERE l_shipdate >= 9131 AND l_shipdate < 9161 AND l_discount > 0.02
"""

QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5, "q6": Q6, "q10": Q10, "q12": Q12,
           "q14": Q14}
