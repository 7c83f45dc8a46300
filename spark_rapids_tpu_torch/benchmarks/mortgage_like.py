"""The port's copy of ``spark_rapids_tpu/benchmarks/mortgage_like.py``:
the same generators (the same arrays for the same sf and seeds) and the
same four entry points, over the port's ``types`` and ``functions``.  The
reference's description:

Mortgage-like ETL benchmark: the reference's third benchmark family
(integration_tests/.../mortgage/MortgageSpark.scala, mortgage_test.py) —
a loan-performance + acquisition pipeline rather than a star-schema query
set.  Rebuilt to the engine's API with the same stage shapes:

* file-driven entry (the Run.csv analogue lives in
  tests/test_torch_mortgage.py: datagen written to CSV, read back through
  the engine's CSV scan; cf. ReadPerformanceCsv / ReadAcquisitionCsv,
  MortgageSpark.scala:35-119)
* date-string decomposition into year/month columns
* conditional delinquency flags + two-level groupby with min/max
  (CreatePerformanceDelinquency, MortgageSpark.scala:218-247)
* a 12-month explode over a literal array with floor/pmod bucket math
  (the "josh_mody" expansion, MortgageSpark.scala:269-297)
* broadcast name-mapping join normalizing messy seller strings
  (NameMapping, MortgageSpark.scala:120-215; CreateAcquisition coalesce)
* the CleanAcquisitionPrime inner join + a reporting aggregate
* the SimpleAggregates and AggregatesWithJoin query variants
  (MortgageSpark.scala:350-420)

Synthetic datagen, seeded; ``sf`` scales rows like the TPC-alike suites.
"""

from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import types as T

SELLERS_RAW = [
    "WELLS FARGO BANK, N.A.", "WELLS FARGO BANK, NA",
    "JPMORGAN CHASE BANK, NA", "JP MORGAN CHASE BANK, NA",
    "BANK OF AMERICA, N.A.", "QUICKEN LOANS INC.", "USAA FEDERAL BANK",
    "PENNYMAC CORP.", "FLAGSTAR BANK, FSB", "OTHER",
]
SELLER_MAP = [
    ("WELLS FARGO BANK, N.A.", "Wells Fargo"),
    ("WELLS FARGO BANK, NA", "Wells Fargo"),
    ("JPMORGAN CHASE BANK, NA", "JP Morgan Chase"),
    ("JP MORGAN CHASE BANK, NA", "JP Morgan Chase"),
    ("BANK OF AMERICA, N.A.", "Bank of America"),
    ("QUICKEN LOANS INC.", "Quicken Loans"),
    ("PENNYMAC CORP.", "PennyMac"),
    ("FLAGSTAR BANK, FSB", "Flagstar Bank"),
]
PURPOSES = ["P", "C", "R", "U"]
PROP_TYPES = ["SF", "CO", "CP", "MH", "PU"]
OCC = ["P", "S", "I"]
STATES = ["CA", "TX", "NY", "FL", "IL", "WA", "GA", "OH"]


def n_loans(sf: float) -> int:
    return max(20, int(sf * 5_000))


def gen_performance(sf: float, seed: int = 31):
    """Monthly loan-performance rows: ~24 months per loan."""
    loans = n_loans(sf)
    r = np.random.RandomState(seed)
    months_per = 24
    n = loans * months_per
    loan_id = np.repeat(np.arange(1, loans + 1), months_per)
    # months 2000-01 .. 2001-12
    seq = np.tile(np.arange(months_per), loans)
    year = 2000 + seq // 12
    month = seq % 12 + 1
    period = np.array([f"{y:04d}-{m:02d}-01" for y, m in zip(year, month)],
                      dtype=object)
    # delinquency bursts: mostly 0, occasionally escalating
    status = np.maximum(r.randint(-8, 10, n), 0).astype(np.int32)
    upb = (r.rand(n) * 300_000).round(2)
    upb[r.rand(n) < 0.02] = 0.0
    return {
        "loan_id": (T.LONG, loan_id),
        "monthly_reporting_period": (T.STRING, period),
        "servicer": (T.STRING, r.choice(SELLERS_RAW, n)),
        "interest_rate": (T.DOUBLE, (r.rand(n) * 5 + 2).round(3)),
        "current_actual_upb": (T.DOUBLE, upb),
        "loan_age": (T.DOUBLE, seq.astype(np.float64)),
        "current_loan_delinquency_status": (T.INT, status),
    }


def gen_acquisition(sf: float, seed: int = 32):
    loans = n_loans(sf)
    r = np.random.RandomState(seed)
    return {
        "loan_id": (T.LONG, np.arange(1, loans + 1)),
        "seller_name": (T.STRING, r.choice(SELLERS_RAW, loans)),
        "orig_interest_rate": (T.DOUBLE, (r.rand(loans) * 5 + 2).round(3)),
        "orig_upb": (T.INT, r.randint(50_000, 500_000, loans)
                     .astype(np.int32)),
        "orig_loan_term": (T.INT, r.choice([180, 240, 360], loans)
                           .astype(np.int32)),
        "orig_ltv": (T.DOUBLE, (r.rand(loans) * 60 + 30).round(1)),
        "dti": (T.DOUBLE, (r.rand(loans) * 40 + 5).round(1)),
        "borrower_credit_score": (T.DOUBLE, r.randint(450, 850, loans)
                                  .astype(np.float64)),
        "first_home_buyer": (T.STRING, r.choice(["Y", "N", "U"], loans)),
        "loan_purpose": (T.STRING, r.choice(PURPOSES, loans)),
        "property_type": (T.STRING, r.choice(PROP_TYPES, loans)),
        "occupancy_status": (T.STRING, r.choice(OCC, loans)),
        "property_state": (T.STRING, r.choice(STATES, loans)),
        "zip": (T.INT, r.randint(10_000, 99_999, loans).astype(np.int32)),
    }


def register_mortgage(session, sf: float = 0.1, num_partitions: int = 3):
    for name, data in (("perf_raw", gen_performance(sf)),
                       ("acq_raw", gen_acquisition(sf))):
        df = session.create_dataframe(data, num_partitions=num_partitions)
        session.register_view(name, df)


def _perf_prepared(perf):
    """Date decomposition (CreatePerformanceDelinquency.prepare, which
    runs to_date + year/month/dayofmonth over the period string)."""
    from spark_rapids_tpu_torch import functions as F
    d = F.to_date(perf["monthly_reporting_period"])
    return (perf
            .with_column("timestamp_year", F.year(d))
            .with_column("timestamp_month", F.month(d)))


def delinquency_frame(perf):
    """Per-loan ever-30/90/180 flags (MortgageSpark.scala:232-260)."""
    from spark_rapids_tpu_torch import functions as F
    month_idx = perf["timestamp_year"] * 12 + perf["timestamp_month"]
    status = perf["current_loan_delinquency_status"]
    flagged = (perf
               .with_column("month_idx", month_idx)
               .with_column("d30", F.when(status >= 1, month_idx)
                            .otherwise(None))
               .with_column("d90", F.when(status >= 3, month_idx)
                            .otherwise(None))
               .with_column("d180", F.when(status >= 6, month_idx)
                            .otherwise(None)))
    agg = (flagged.group_by("loan_id")
           .agg(F.max("current_loan_delinquency_status").alias("worst"),
                F.min("d30").alias("delinquency_30"),
                F.min("d90").alias("delinquency_90"),
                F.min("d180").alias("delinquency_180")))
    return (agg
            .with_column("ever_30", agg["worst"] >= 1)
            .with_column("ever_90", agg["worst"] >= 3)
            .with_column("ever_180", agg["worst"] >= 6)
            .drop("worst"))


def twelve_month_expansion(perf_joined):
    """Explode a 12-entry literal month array and re-bucket with
    floor/pmod month math (MortgageSpark.scala:269-297)."""
    from spark_rapids_tpu_torch import functions as F
    df = perf_joined.with_column(
        "month_y", F.array(*[F.lit(i) for i in range(12)]))
    df = df.explode("month_y", alias="month_y")
    base = df["timestamp_year"] * 12 + df["timestamp_month"] - 24000
    df = df.with_column("bucket",
                        F.floor((base - df["month_y"]) / F.lit(12.0))
                        .cast(T.LONG))
    agg = (df.group_by("loan_id", "bucket", "month_y")
           .agg(F.max("current_loan_delinquency_status")
                .alias("delinquency_12"),
                F.min("current_actual_upb").alias("upb_12")))
    months_total = F.lit(24000) + agg["bucket"] * 12 + agg["month_y"]
    tmp = months_total % 12
    return (agg
            .with_column("timestamp_year",
                         F.floor((months_total + F.lit(-1)) / F.lit(12.0))
                         .cast(T.INT))
            .with_column("timestamp_month",
                         F.when(tmp == 0, 12).otherwise(tmp).cast(T.INT))
            .with_column("delinquency_12",
                         (agg["delinquency_12"] > 3).cast(T.INT)
                         + (agg["upb_12"] == 0).cast(T.INT))
            .drop("bucket", "month_y"))


def _seller_mapping(session):
    data = {
        "from_seller_name": (T.STRING,
                             np.array([a for a, _ in SELLER_MAP],
                                      dtype=object)),
        "to_seller_name": (T.STRING,
                           np.array([b for _, b in SELLER_MAP],
                                    dtype=object)),
    }
    return session.create_dataframe(data, num_partitions=1)


def clean_acquisition(session, acq):
    """Broadcast name normalization (CreateAcquisition,
    MortgageSpark.scala:300-315): left-join the mapping, coalesce to the
    original name when unmapped."""
    from spark_rapids_tpu_torch import functions as F
    mapping = F.broadcast(_seller_mapping(session))
    acq = acq.join(mapping, on=acq["seller_name"]
                   == mapping["from_seller_name"], how="left")
    return (acq.with_column("seller",
                            F.coalesce(acq["to_seller_name"],
                                       acq["seller_name"]))
            .drop("from_seller_name", "to_seller_name", "seller_name"))


def run_mortgage(session):
    """Full ETL (the reference's Run.csv/parquet pipeline,
    MortgageSpark.scala:325-347): delinquency expansion joined back to
    performance, inner-joined to the cleaned acquisition frame, reduced
    to a deterministic reporting aggregate.  Consumes the registered
    ``perf_raw``/``acq_raw`` views (see :func:`register_mortgage`)."""
    perf = _perf_prepared(session.table("perf_raw"))
    delinq = delinquency_frame(perf)
    joined = perf.join(delinq, on="loan_id", how="left")
    twelve = twelve_month_expansion(joined)
    perf_final = perf.join(
        twelve, on=["loan_id", "timestamp_year", "timestamp_month"],
        how="left")
    acq = clean_acquisition(session, session.table("acq_raw"))
    full = perf_final.join(acq, on="loan_id", how="inner")
    from spark_rapids_tpu_torch import functions as F
    out = (full.group_by("property_state", "seller")
           .agg(F.count("loan_id").alias("rows_n"),
                F.sum("delinquency_12").alias("delinq_12_sum"),
                F.avg("interest_rate").alias("avg_rate"),
                F.avg("borrower_credit_score").alias("avg_score"),
                F.max("current_actual_upb").alias("max_upb"))
           .order_by("property_state", "seller"))
    return out


def simple_aggregates(session):
    """SimpleAggregates (MortgageSpark.scala:350-366): per-loan monthly
    max rate, joined to acquisition, min-of-max by (zip, month)."""
    from spark_rapids_tpu_torch import functions as F
    perf = _perf_prepared(session.table("perf_raw"))
    max_rate = (perf.group_by("timestamp_month", "loan_id")
                .agg(F.max("interest_rate").alias("max_monthly_rate")))
    acq = session.table("acq_raw")
    joined = max_rate.join(acq, on="loan_id", how="inner")
    return (joined.group_by("zip", "timestamp_month")
            .agg(F.min("max_monthly_rate").alias("min_max_monthly_rate"))
            .order_by("zip", "timestamp_month"))


def aggregates_with_join(session):
    """AggregatesWithJoin (MortgageSpark.scala:393-420): anonymize the
    loan key through the engine's murmur3 hash, pre-aggregate each side,
    left join the aggregates."""
    from spark_rapids_tpu_torch import functions as F
    perf = session.table("perf_raw")
    acq = session.table("acq_raw")
    perf_a = (perf.with_column("loan_id_hash", F.hash(perf["loan_id"]))
              .group_by("loan_id_hash")
              .agg(F.min("interest_rate").alias("min_int_rate")))
    acq_a = (acq.with_column("loan_id_hash", F.hash(acq["loan_id"]))
             .group_by("loan_id_hash")
             .agg(F.first("orig_interest_rate", ignore_nulls=True)
                  .alias("first_int_rate"),
                  F.max("dti").alias("max_dti")))
    out = perf_a.join(acq_a, on="loan_id_hash", how="left")
    return (out.with_column("max_dti",
                            F.coalesce(out["max_dti"], F.lit(0.0)))
            .order_by("loan_id_hash"))


def aggregates_with_percentiles(session):
    """AggregatesWithPercentiles (MortgageSpark.scala:368-390): per
    anonymized loan, min/max/avg plus the 50/75/90/99th exact
    percentiles of the monthly interest rate.  The reference wraps each
    output in round(x, 4); the "like" adaptation compares raw doubles
    (fixed-decimal rounding sits one emulation ULP from a tie)."""
    from spark_rapids_tpu_torch import functions as F
    perf = session.table("perf_raw")
    anon = perf.with_column("loan_id_hash", F.hash(perf["loan_id"]))
    return (anon.group_by("loan_id_hash")
            .agg(F.min("interest_rate").alias("interest_rate_min"),
                 F.max("interest_rate").alias("interest_rate_max"),
                 F.avg("interest_rate").alias("interest_rate_avg"),
                 F.percentile("interest_rate", 0.5)
                 .alias("interest_rate_50p"),
                 F.percentile("interest_rate", 0.75)
                 .alias("interest_rate_75p"),
                 F.percentile("interest_rate", 0.9)
                 .alias("interest_rate_90p"),
                 F.percentile("interest_rate", 0.99)
                 .alias("interest_rate_99p"))
            .order_by("loan_id_hash"))
