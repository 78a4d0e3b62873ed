"""The port's Spark ingest adapter (``distkeras_torch/data/
spark_adapter.py``) against the JAX package's, on the duck-typed doubles
``tests/test_spark_adapter.py`` uses (pyspark is absent): the same fake
RDDs and DataFrames give the same partitions, columns and values, and
the same errors."""

import numpy as np
import pytest

from distkeras_tpu.data import spark_adapter as jsa
from distkeras_torch import data as tdata
from distkeras_torch.data import spark_adapter as tsa
from torch_spawn_util import one_thread  # noqa: E402,F401


class FakeVector:
    def __init__(self, values):
        self._values = np.asarray(values, dtype=np.float64)

    def toArray(self):
        return self._values


class FakeRow:
    def __init__(self, **kw):
        self._d = kw

    def asDict(self):
        return dict(self._d)


class FakeRDD:
    def __init__(self, partitions):
        self._partitions = [list(p) for p in partitions]

    def glom(self):
        parts = self._partitions

        class Glommed:
            def collect(self):
                return [list(p) for p in parts]

        return Glommed()

    def getNumPartitions(self):
        return len(self._partitions)

    def repartition(self, n):
        rows = [r for p in self._partitions for r in p]
        bounds = np.linspace(0, len(rows), n + 1).astype(int)
        return FakeRDD([rows[bounds[i]:bounds[i + 1]] for i in range(n)])


class FakeDataFrame:
    def __init__(self, rdd, columns):
        self.rdd = rdd
        self.columns = columns


def _row_rdd(n=21, parts=4, seed=0):
    rng = np.random.default_rng(seed)
    rows = [FakeRow(features=FakeVector(rng.normal(size=3)),
                    label=int(rng.integers(0, 5))) for _ in range(n)]
    bounds = np.linspace(0, n, parts + 1).astype(int)
    return FakeRDD([rows[bounds[i]:bounds[i + 1]] for i in range(parts)])


def _tuple_df():
    rows = [(np.float32(i), i % 2) for i in range(8)]
    return FakeDataFrame(FakeRDD([rows[:3], [], rows[3:]]), ["x", "y"])


def _same(a, b):
    assert a.columns == b.columns and a.num_partitions == b.num_partitions
    for i in range(a.num_partitions):
        for c in a.columns:
            x, y = a.partition(i)[c], b.partition(i)[c]
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["rows", "repartition", "tuple_df",
                                  "columns"])
def test_dataset_from_spark_matches_jax(case):
    src, kw = {"rows": (_row_rdd(), {}),
               "repartition": (_row_rdd(24, 2), {"num_partitions": 6}),
               "tuple_df": (_tuple_df(), {}),
               "columns": (FakeRDD([[(1.0, 2), (3.0, 4)]]),
                           {"columns": ["a", "b"]})}[case]
    _same(tsa.dataset_from_spark(src, **kw), jsa.dataset_from_spark(src, **kw))


def test_session_reader_matches_jax():
    rows = [FakeRow(x=float(i)) for i in range(5)]

    class Reader:
        def format(self, fmt):
            self.fmt = fmt
            return self

        def load(self, path):
            return FakeDataFrame(FakeRDD([rows[:2], rows[2:]]), ["x"])

    class Session:
        read = Reader()

    _same(tsa.dataset_from_spark_session(Session(), "p"),
          jsa.dataset_from_spark_session(Session(), "p"))


@pytest.mark.parametrize("bad,err,match", [
    (FakeRDD([[(1.0, 2)]]), TypeError, "columns"),
    (FakeRDD([[], []]), ValueError, "no rows"),
    ([1, 2, 3], TypeError, "DataFrame or RDD")])
def test_errors_match_jax(bad, err, match):
    for mod in (tsa, jsa):
        with pytest.raises(err, match=match):
            mod.dataset_from_spark(bad)


def test_exports_and_availability_match_jax():
    from distkeras_tpu import data as jdata

    names = ["dataset_from_spark", "dataset_from_spark_session",
             "spark_available", "ShardedDataset", "write_shards",
             "PartitionedDataset"]
    for n in names:
        assert hasattr(tdata, n) and hasattr(jdata, n)
    assert tdata.spark_available() == jdata.spark_available()
