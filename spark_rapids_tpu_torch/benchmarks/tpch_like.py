"""TPC-H-like queries the port runs as SQL text: all 22, copied verbatim
from ``spark_rapids_tpu/benchmarks/tpch_like.py`` (adapted there to the
engine's envelope: date literals as days since the epoch, correlated,
EXISTS and IN subqueries decorrelated by hand into joins against
aggregated subqueries or LEFT SEMI / LEFT ANTI joins, scalar subqueries as
a CROSS JOIN of a one-row aggregate, arithmetic after an aggregation
through nested subqueries)."""

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

Q2 = """
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr
FROM part
JOIN partsupp ON p_partkey = ps_partkey
JOIN supplier ON s_suppkey = ps_suppkey
JOIN nation ON s_nationkey = n_nationkey
JOIN region ON n_regionkey = r_regionkey
JOIN (
  SELECT ps_partkey AS mpk, min(ps_supplycost) AS min_cost
  FROM partsupp
  JOIN supplier ON s_suppkey = ps_suppkey
  JOIN nation ON s_nationkey = n_nationkey
  JOIN region ON n_regionkey = r_regionkey
  WHERE r_name = 'EUROPE'
  GROUP BY ps_partkey
) mc ON p_partkey = mpk AND ps_supplycost = min_cost
WHERE p_size = 15 AND r_name = 'EUROPE'
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100
"""

Q4 = """
SELECT o_orderpriority, count(*) AS order_count
FROM orders
LEFT SEMI JOIN lineitem ON l_orderkey = o_orderkey
  AND l_commitdate < l_receiptdate
WHERE o_orderdate >= 8582 AND o_orderdate < 8674
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""

Q7 = """
SELECT supp_nation, cust_nation, year(l_shipdate) AS l_year,
       sum(l_extendedprice) AS revenue
FROM lineitem
JOIN supplier ON s_suppkey = l_suppkey
JOIN orders ON o_orderkey = l_orderkey
JOIN customer ON c_custkey = o_custkey
JOIN (SELECT n_nationkey AS snk, n_name AS supp_nation FROM nation) nx
  ON s_nationkey = snk
JOIN (SELECT n_nationkey AS cnk, n_name AS cust_nation FROM nation) ny
  ON c_nationkey = cnk
WHERE ((supp_nation = 'FRANCE' AND cust_nation = 'GERMANY')
    OR (supp_nation = 'GERMANY' AND cust_nation = 'FRANCE'))
  AND l_shipdate BETWEEN 9131 AND 9861
GROUP BY supp_nation, cust_nation, year(l_shipdate)
ORDER BY supp_nation, cust_nation, l_year
"""

Q8 = """
SELECT o_year, brazil_rev / total_rev AS mkt_share
FROM (
  SELECT o_year,
         sum(brazil_volume) AS brazil_rev,
         sum(volume) AS total_rev
  FROM (
    SELECT year(o_orderdate) AS o_year,
           l_extendedprice AS volume,
           CASE WHEN n2name = 'BRAZIL' THEN l_extendedprice
                ELSE 0.0 END AS brazil_volume
    FROM lineitem
    JOIN part ON p_partkey = l_partkey
    JOIN supplier ON s_suppkey = l_suppkey
    JOIN orders ON o_orderkey = l_orderkey
    JOIN customer ON c_custkey = o_custkey
    JOIN (SELECT n_nationkey AS cnk, n_regionkey AS crk FROM nation) n1
      ON c_nationkey = cnk
    JOIN region ON crk = r_regionkey
    JOIN (SELECT n_nationkey AS snk, n_name AS n2name FROM nation) n2
      ON s_nationkey = snk
    WHERE r_name = 'AMERICA'
      AND o_orderdate BETWEEN 9131 AND 9861
      AND p_size < 30
  )
  GROUP BY o_year
)
ORDER BY o_year
"""

Q9 = """
SELECT n_name, year(o_orderdate) AS o_year,
       sum(l_extendedprice * (1 - l_discount)
           - ps_supplycost * l_quantity) AS profit
FROM lineitem
JOIN supplier ON s_suppkey = l_suppkey
JOIN partsupp ON ps_suppkey = l_suppkey AND ps_partkey = l_partkey
JOIN part ON p_partkey = l_partkey
JOIN orders ON o_orderkey = l_orderkey
JOIN nation ON s_nationkey = n_nationkey
WHERE p_name LIKE '%green%'
GROUP BY n_name, year(o_orderdate)
ORDER BY n_name, o_year DESC
"""

Q11 = """
SELECT ps_partkey, value
FROM (
  SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
  FROM partsupp
  JOIN supplier ON s_suppkey = ps_suppkey
  JOIN nation ON s_nationkey = n_nationkey
  WHERE n_name = 'GERMANY'
  GROUP BY ps_partkey
)
CROSS JOIN (
  SELECT sum(ps_supplycost * ps_availqty) AS total
  FROM partsupp
  JOIN supplier ON s_suppkey = ps_suppkey
  JOIN nation ON s_nationkey = n_nationkey
  WHERE n_name = 'GERMANY'
)
WHERE value > total * 0.0001
ORDER BY value DESC, ps_partkey
"""

Q13 = """
SELECT c_count, count(*) AS custdist
FROM (
  SELECT c_custkey, count(o_orderkey) AS c_count
  FROM customer
  LEFT JOIN orders ON c_custkey = o_custkey
    AND o_orderpriority <> '1-URGENT'
  GROUP BY c_custkey
)
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
"""

Q15 = """
SELECT s_suppkey, s_name, total_revenue
FROM supplier
JOIN (
  SELECT l_suppkey AS rsk, sum(l_extendedprice) AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= 9496 AND l_shipdate < 9587
  GROUP BY l_suppkey
) r ON s_suppkey = rsk
CROSS JOIN (
  SELECT max(total_revenue) AS max_rev
  FROM (
    SELECT sum(l_extendedprice) AS total_revenue
    FROM lineitem
    WHERE l_shipdate >= 9496 AND l_shipdate < 9587
    GROUP BY l_suppkey
  )
)
WHERE abs(total_revenue - max_rev) <= max_rev * 0.000001
ORDER BY s_suppkey
"""

Q16 = """
SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp
JOIN part ON p_partkey = ps_partkey
LEFT ANTI JOIN (
  SELECT s_suppkey FROM supplier WHERE s_name LIKE '%0000009%'
) bad ON ps_suppkey = s_suppkey
WHERE p_brand <> 'Brand#45' AND p_size IN (1, 4, 7, 10, 15)
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
LIMIT 100
"""

Q17 = """
SELECT total / 7.0 AS avg_yearly
FROM (
  SELECT sum(l_extendedprice) AS total
  FROM lineitem
  JOIN part ON p_partkey = l_partkey
  JOIN (
    SELECT l_partkey AS apk, avg(l_quantity) AS avg_qty
    FROM lineitem
    GROUP BY l_partkey
  ) a ON l_partkey = apk
  WHERE p_brand = 'Brand#23' AND l_quantity < avg_qty * 0.5
)
"""

Q18 = """
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) AS total_qty
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON o_orderkey = l_orderkey
LEFT SEMI JOIN (
  SELECT l_orderkey AS bok
  FROM lineitem
  GROUP BY l_orderkey
  HAVING sum(l_quantity) > 150
) big ON o_orderkey = bok
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate, o_orderkey
LIMIT 100
"""

Q19 = """
SELECT sum(l_extendedprice) AS revenue
FROM lineitem
JOIN part ON p_partkey = l_partkey
WHERE (p_brand = 'Brand#12'
       AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       AND l_quantity BETWEEN 1 AND 11 AND p_size BETWEEN 1 AND 5
       AND l_shipmode IN ('AIR', 'REG AIR'))
   OR (p_brand = 'Brand#23'
       AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       AND l_quantity BETWEEN 10 AND 20 AND p_size BETWEEN 1 AND 10)
   OR (p_brand = 'Brand#34'
       AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       AND l_quantity BETWEEN 20 AND 30 AND p_size BETWEEN 1 AND 15)
"""

Q20 = """
SELECT s_name
FROM supplier
JOIN nation ON s_nationkey = n_nationkey
LEFT SEMI JOIN (
  SELECT ps_suppkey
  FROM partsupp
  LEFT SEMI JOIN (
    SELECT p_partkey FROM part WHERE p_name LIKE 'forest%'
  ) fp ON ps_partkey = p_partkey
  JOIN (
    SELECT l_partkey AS hpk, l_suppkey AS hsk,
           sum(l_quantity) AS period_qty
    FROM lineitem
    WHERE l_shipdate >= 8766 AND l_shipdate < 9131
    GROUP BY l_partkey, l_suppkey
  ) h ON ps_partkey = hpk AND ps_suppkey = hsk
  WHERE ps_availqty > period_qty * 0.5
) ok ON s_suppkey = ps_suppkey
WHERE n_name = 'CANADA'
ORDER BY s_name
"""

Q21 = """
SELECT s_name, count(*) AS numwait
FROM lineitem
JOIN orders ON o_orderkey = l_orderkey AND o_orderstatus = 'F'
JOIN supplier ON s_suppkey = l_suppkey
JOIN nation ON s_nationkey = n_nationkey
LEFT SEMI JOIN (
  SELECT l_orderkey AS ok2, l_suppkey AS sk2 FROM lineitem
) l2 ON ok2 = l_orderkey AND sk2 <> l_suppkey
LEFT ANTI JOIN (
  SELECT l_orderkey AS ok3, l_suppkey AS sk3 FROM lineitem
  WHERE l_receiptdate > l_commitdate
) l3 ON ok3 = l_orderkey AND sk3 <> l_suppkey
WHERE l_receiptdate > l_commitdate AND n_name = 'GERMANY'
GROUP BY s_name
ORDER BY numwait DESC, s_name
LIMIT 100
"""

Q22 = """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (
  SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal, c_custkey
  FROM customer
  CROSS JOIN (
    SELECT avg(c_acctbal) AS avg_bal FROM customer WHERE c_acctbal > 0.0
  )
  WHERE c_acctbal > avg_bal
    AND substring(c_phone, 1, 2) IN ('13', '31', '23', '29', '30', '18',
                                     '17')
)
LEFT ANTI JOIN orders ON o_custkey = c_custkey
GROUP BY cntrycode
ORDER BY cntrycode
"""

QUERIES = {f"q{i}": q for i, q in enumerate(
    [Q1, Q2, Q3, Q4, Q5, Q6, Q7, Q8, Q9, Q10, Q11, Q12, Q13, Q14, Q15,
     Q16, Q17, Q18, Q19, Q20, Q21, Q22], start=1)}
