"""The port's Table/SQL front end (``flink_tpu_torch/table``) against the
reference's, on the same seeded inputs: the cases of
``tests/test_table_sql.py``, the SQL cases of ``tests/test_changelog.py``
and the table cases of ``tests/test_global_agg.py``. Each query runs in
both packages; the rows must be equal, in order, and every check the
reference test makes holds on the port's rows. Lanes are like with
like: both packages take their default (C key table) lanes.

Integers, window ends and f32 max/min compare exactly. The f32 sums are
held to 0 ulps: the windowed sums here add integer-valued prices (exact
in f32 in any order), and the unwindowed ones fold on the host in both
packages with the same numpy reduction.

The planners are compared directly too: the same SQL text lowers to the
same transformation graph in both packages (node kinds in order, the
window assigner, the aggregate's result fields, the top-n), and a
second query in one environment does not fire the first one's sink."""
import types

import numpy as np
import pytest

from test_torch_ckpt_pkgs import JAX, PORT
from test_torch_threads import capped_torch_threads  # noqa: F401


def _pkg(base, name):
    """``base``'s surface (test_torch_ckpt_pkgs) and the package's
    Table/SQL modules."""
    import importlib

    return types.SimpleNamespace(
        table=importlib.import_module(f"{name}.table"),
        sql=importlib.import_module(f"{name}.table.sql"),
        sinks=base.sinks, Env=base.Env, Conf=base.Conf, agg=base.agg,
        gen=base.gen, WM=base.WM, kw=base.kw, run=base.execute)


REF = _pkg(JAX, "flink_tpu")
TORCH = _pkg(PORT, "flink_tpu_torch")


def _value(v):
    v = v.item() if hasattr(v, "item") else v
    return float(v) if isinstance(v, (int, float)) else v


def rows_of(rows):
    """Rows as tuples of (column, Python value), in order."""
    return [tuple(sorted((k, _value(v)) for k, v in r.items()))
            for r in rows]


def both(fn):
    """``fn(S)`` in the port and in the reference; the port's result
    after asserting the two equal (row lists compare in order)."""
    port, ref = fn(TORCH), fn(REF)
    assert _norm(port) == _norm(ref)
    return port


def _norm(x):
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return rows_of(x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return _value(x)


def _exec(S, table, name="table-query"):
    return table.execute(name, **S.kw)


def _bids(S, env, n=4000, keys=30, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 20_000, n)).astype(np.int64)
    data = {
        "auction": rng.integers(0, keys, n).astype(np.int64),
        "price": rng.integers(1, 500, n).astype(np.float32),
        "ts": ts,
    }
    return env.from_collection(data, ts, batch_size=1000), data


def _fresh(S):
    env = S.Env(S.Conf({
        "state.num-key-shards": 8, "state.slots-per-shard": 32}))
    return env, S.table.TableEnvironment.create(env)


def _bids_view(S, n=4000, seed=0, name="bids"):
    env, t_env = _fresh(S)
    stream, data = _bids(S, env, n=n, seed=seed)
    t_env.create_temporary_view(
        name, stream, schema=["auction", "price", "ts"], time_attr="ts")
    return env, t_env, data


def _rowset(rows, fields):
    return sorted(
        tuple(round(float(r[f]), 4) for f in fields) for r in rows)


# ---------------------------------------------------------------------------
# tests/test_table_sql.py
# ---------------------------------------------------------------------------

class TestParser:
    def test_basic_shapes(self):
        def run(S):
            q = S.sql.parse("SELECT a, COUNT(*) AS c FROM t GROUP BY a")
            return [q.group_by, list(q.items[1].agg), q.items[1].alias]
        assert both(run) == [["a"], ["count", None], "c"]

    def test_hop_tvf(self):
        def run(S):
            q = S.sql.parse(
                "SELECT COUNT(*) FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts),"
                " INTERVAL '1' SECOND, INTERVAL '10' SECOND))")
            return [q.source.kind, q.source.intervals]
        assert both(run) == ["hop", [1000, 10_000]]

    def test_where_expr_precedence(self):
        def run(S):
            q = S.sql.parse("SELECT a FROM t WHERE a + 1 * 2 > 3 AND b = 'x'")
            return [q.where.eval({"a": np.array(a), "b": np.array(b)}).tolist()
                    for a, b in (([0, 2], ["x", "y"]), ([2, 9], ["x", "y"]))]
        assert both(run) == [[False, False], [True, False]]

    @pytest.mark.parametrize("sql", [
        "SELECT FROM t", "SELECT a FROM t; DROP TABLE t",
        "SELECT SUM(*) FROM t"])
    def test_errors(self, sql):
        def run(S):
            with pytest.raises(S.sql.SqlError) as e:
                S.sql.parse(sql)
            return str(e.value)
        both(run)

    def test_having_without_aggregate_rejected_at_plan_time(self):
        def run(S):
            q = S.sql.parse("SELECT a FROM t HAVING a > 1")
            assert q.having is not None
            env, t_env = _fresh(S)
            stream, _ = _bids(S, env)
            t_env.create_temporary_view(
                "t", stream, schema=["a", "price", "ts"], time_attr="ts")
            with pytest.raises(S.sql.SqlError, match="HAVING") as e:
                t_env.sql_query("SELECT a FROM t HAVING a > 1")
            return str(e.value)
        both(run)


HOP_Q5 = ("SELECT auction, window_end, COUNT(*) AS bid_count "
          "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
          "INTERVAL '1' SECOND, INTERVAL '4' SECOND)) "
          "GROUP BY auction, window_start, window_end")


class TestSqlVsDataStream:
    def test_q5_sql_matches_datastream(self):
        def run(S):
            env, t_env, _ = _bids_view(S)
            return _exec(S, t_env.sql_query(HOP_Q5)).rows
        rows = both(run)
        env2 = PORT.Env(PORT.Conf({
            "state.num-key-shards": 8, "state.slots-per-shard": 32}))
        stream2, _ = _bids(TORCH, env2)
        sink = PORT.sinks.CollectSink()
        (stream2.key_by("auction")
         .window(PORT.Sliding.of(4000, 1000)).count().add_sink(sink))
        PORT.execute(env2, "ds")
        assert (_rowset(rows, ("auction", "window_end", "bid_count"))
                == _rowset(sink.rows, ("key", "window_end", "count")))
        assert len(rows) > 0

    def test_sql_topn_matches_datastream_top(self):
        def run(S):
            env, t_env, _ = _bids_view(S, seed=3)
            return _exec(S, t_env.sql_query(
                "SELECT auction, window_end, COUNT(*) AS c "
                "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
                "INTERVAL '1' SECOND, INTERVAL '4' SECOND)) "
                "GROUP BY auction, window_start, window_end "
                "ORDER BY c DESC LIMIT 2")).rows
        rows = both(run)
        env2 = PORT.Env(PORT.Conf({
            "state.num-key-shards": 8, "state.slots-per-shard": 32}))
        stream2, _ = _bids(TORCH, env2, seed=3)
        sink = PORT.sinks.CollectSink()
        (stream2.key_by("auction")
         .window(PORT.Sliding.of(4000, 1000))
         .count().top(2, by="count").add_sink(sink))
        PORT.execute(env2, "ds-top")
        assert (_rowset(rows, ("auction", "window_end", "c"))
                == _rowset(sink.rows, ("key", "window_end", "count")))
        assert len(rows) > 0

    def test_where_and_sum_tumble(self):
        data = {}

        def run(S):
            env, t_env, data["d"] = _bids_view(S, seed=5)
            return _exec(S, t_env.sql_query(
                "SELECT auction, window_end, SUM(price) AS total, "
                "MAX(price) AS hi "
                "FROM TABLE(TUMBLE(TABLE bids, DESCRIPTOR(ts), "
                "INTERVAL '2' SECOND)) "
                "WHERE price > 250 "
                "GROUP BY auction, window_start, window_end")).rows
        rows = both(run)
        d = data["d"]
        m = d["price"] > 250
        golden = {}
        for a, p, t in zip(d["auction"][m], d["price"][m], d["ts"][m]):
            key = (int(a), (int(t) // 2000 + 1) * 2000)
            s, h = golden.get(key, (0.0, -np.inf))
            golden[key] = (s + float(p), max(h, float(p)))
        got = sorted((int(r["auction"]), int(r["window_end"]),
                      round(float(r["total"]), 2), float(r["hi"]))
                     for r in rows)
        assert got == sorted((a, we, round(s, 2), h)
                             for (a, we), (s, h) in golden.items())


class TestTableApi:
    def test_fluent_matches_sql(self):
        def fluent(S):
            env, t_env = _fresh(S)
            stream, _ = _bids(S, env, seed=7)
            t = t_env.from_data_stream(
                stream, schema=["auction", "price", "ts"], time_attr="ts")
            return _exec(S, t.filter(S.table.col("price") > 100)
                         .window(S.table.Hop.of_ms(4000, 1000))
                         .group_by("auction")
                         .aggregate(S.table.AggCall("count", None, "c"))).rows

        def sql(S):
            env, t_env, _ = _bids_view(S, seed=7)
            return _exec(S, t_env.sql_query(
                "SELECT auction, window_end, COUNT(*) AS c "
                "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
                "INTERVAL '1' SECOND, INTERVAL '4' SECOND)) "
                "WHERE price > 100 "
                "GROUP BY auction, window_start, window_end")).rows
        a, b = both(fluent), both(sql)
        f = ("auction", "window_end", "c")
        assert _rowset(a, f) == _rowset(b, f) and a

    def test_projection_only_query(self):
        data = {}

        def run(S):
            env, t_env, data["d"] = _bids_view(S, n=500, seed=9)
            return _exec(S, t_env.sql_query(
                "SELECT auction, price * 2 AS dbl FROM bids "
                "WHERE auction < 5")).rows
        rows = both(run)
        d = data["d"]
        m = d["auction"] < 5
        assert len(rows) == int(m.sum())
        assert (sorted(round(float(r["dbl"]), 2) for r in rows)
                == sorted(np.round(d["price"][m] * 2, 2).tolist()))

    def test_global_windowed_aggregate(self):
        data = {}

        def run(S):
            env, t_env, data["d"] = _bids_view(S, n=1000, seed=11)
            return _exec(S, t_env.sql_query(
                "SELECT window_end, MAX(price) AS hi "
                "FROM TABLE(TUMBLE(TABLE bids, DESCRIPTOR(ts), "
                "INTERVAL '5' SECOND)) "
                "GROUP BY window_start, window_end")).rows
        rows = both(run)
        golden = {}
        for p, t in zip(data["d"]["price"], data["d"]["ts"]):
            we = (int(t) // 5000 + 1) * 5000
            golden[we] = max(golden.get(we, -np.inf), float(p))
        assert (sorted((int(r["window_end"]), float(r["hi"])) for r in rows)
                == sorted(golden.items()))

    def test_plan_errors(self):
        def run(S):
            env, t_env, _ = _bids_view(S, n=100)
            t = t_env.sql_query(
                "SELECT auction, COUNT(*) AS c FROM bids GROUP BY auction")
            out = [list(t.schema.columns)]
            for sql, err, match in (
                    ("SELECT COUNT(*) FROM TABLE(TUMBLE(TABLE bids, "
                     "DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
                     "GROUP BY auction, price", S.sql.SqlError,
                     "one non-window"),
                    ("SELECT a FROM nope", KeyError, "nope"),
                    ("SELECT auction, COUNT(*) AS c FROM TABLE(TUMBLE(TABLE "
                     "bids, DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
                     "GROUP BY auction, window_end ORDER BY c LIMIT 2",
                     S.sql.SqlError, "DESC")):
                with pytest.raises(err, match=match) as e:
                    t_env.sql_query(sql)
                out.append(str(e.value))
            return out
        assert both(run)[0] == ["auction", "c"]


class TestReviewRegressions:
    def test_second_query_does_not_refire_first_sink(self):
        data = {}

        def run(S):
            env, t_env, data["d"] = _bids_view(S, n=500, seed=13)
            r1 = _exec(S, t_env.sql_query(
                "SELECT auction FROM bids WHERE price > 400"))
            n1 = len(r1.rows)
            r2 = _exec(S, t_env.sql_query(
                "SELECT auction FROM bids WHERE price > 100"))
            return [n1, len(r1.rows), len(r2.rows)]
        n1, after, n2 = both(run)
        assert n1 == after == int((data["d"]["price"] > 400).sum())
        assert n2 == int((data["d"]["price"] > 100).sum())

    def test_duplicate_aggregates_fan_out(self):
        def run(S):
            env, t_env, _ = _bids_view(S, n=800, seed=15)
            return _exec(S, t_env.sql_query(
                "SELECT auction, SUM(price) AS a, SUM(price) AS b, "
                "COUNT(*) AS c "
                "FROM TABLE(TUMBLE(TABLE bids, DESCRIPTOR(ts), "
                "INTERVAL '5' SECOND)) "
                "GROUP BY auction, window_start, window_end")).rows
        rows = both(run)
        assert rows and all(r["a"] == r["b"] for r in rows)

    def test_select_literal_column(self):
        def run(S):
            env, t_env, _ = _bids_view(S, n=200, seed=17)
            return _exec(S, t_env.sql_query(
                "SELECT auction, 1 AS one FROM bids")).rows
        rows = both(run)
        assert len(rows) == 200 and all(int(r["one"]) == 1 for r in rows)

    def _refused(self, sql, match, n=100):
        def run(S):
            env, t_env, _ = _bids_view(S, n=n)
            with pytest.raises(S.sql.SqlError, match=match) as e:
                t_env.sql_query(sql)
            return str(e.value)
        both(run)

    def test_window_tvf_without_aggregates_rejected(self):
        self._refused(
            "SELECT * FROM TABLE(TUMBLE(TABLE bids, DESCRIPTOR(ts), "
            "INTERVAL '2' SECOND))", "aggregate")

    def test_global_topn_rejected(self):
        self._refused(
            "SELECT window_end, COUNT(*) AS c FROM TABLE(TUMBLE("
            "TABLE bids, DESCRIPTOR(ts), INTERVAL '2' SECOND)) "
            "GROUP BY window_start, window_end "
            "ORDER BY c DESC LIMIT 1", "grouping column")

    def test_fractional_limit_rejected(self):
        def run(S):
            with pytest.raises(S.sql.SqlError, match="integer") as e:
                S.sql.parse(
                    "SELECT auction, COUNT(*) AS c FROM TABLE(TUMBLE("
                    "TABLE bids, DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
                    "GROUP BY auction ORDER BY c DESC LIMIT 2.5")
            return str(e.value)
        both(run)

    def test_topn_output_pruned_to_select_list(self):
        def run(S):
            env, t_env, _ = _bids_view(S, seed=19)
            return _exec(S, t_env.sql_query(
                "SELECT auction, window_end, COUNT(*) AS c "
                "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
                "INTERVAL '1' SECOND, INTERVAL '4' SECOND)) "
                "GROUP BY auction, window_start, window_end "
                "ORDER BY c DESC LIMIT 1")).rows
        rows = both(run)
        assert rows and set(rows[0]) == {"auction", "window_end", "c"}

    def test_session_topn_rejected(self):
        self._refused(
            "SELECT auction, COUNT(*) AS c FROM TABLE(SESSION("
            "TABLE bids, DESCRIPTOR(ts), INTERVAL '2' SECOND)) "
            "GROUP BY auction ORDER BY c DESC LIMIT 2", "SESSION")

    def test_limit_zero_on_projection_rejected(self):
        self._refused("SELECT auction FROM bids LIMIT 0", "windowed")

    def test_avg_runtime_field_tracks_aggregates_module(self):
        def run(S):
            field = S.table.AggCall("avg", "price", "x").runtime_field
            assert field == S.agg.result_fields(S.agg.avg_of("price"))[0]
            return field
        both(run)


class TestSqlJoin:
    """The SQL windowed equi-join lowering onto ops/join.py (Q8's
    shape), equal to the reference and to the DataStream pipeline."""

    def _streams(self, env, n=3000, seed=3):
        rng = np.random.default_rng(seed)
        ts_p = np.sort(rng.integers(0, 12_000, n)).astype(np.int64)
        persons = {"person": rng.integers(0, 50, n).astype(np.int64),
                   "state_id": rng.integers(0, 5, n).astype(np.int64),
                   "ts": ts_p}
        ts_a = np.sort(rng.integers(0, 12_000, n)).astype(np.int64)
        auctions = {"seller": rng.integers(0, 50, n).astype(np.int64),
                    "reserve": rng.integers(1, 100, n).astype(np.int64),
                    "ts2": ts_a}
        p = env.from_collection(persons, ts_p, batch_size=500)
        a = env.from_collection(auctions, ts_a, batch_size=500)
        return p, a

    def _views(self, S, n=3000):
        env, te = _fresh(S)
        p, a = self._streams(env, n=n)
        te.create_temporary_view("P", p, ["person", "state_id", "ts"])
        te.create_temporary_view("A", a, ["seller", "reserve", "ts2"])
        return te

    def test_join_golden_vs_datastream(self):
        def run(S):
            t = self._views(S).sql_query(
                "SELECT P.person AS who, window_end, P.state_id, A.reserve "
                "FROM TABLE(TUMBLE(TABLE P, DESCRIPTOR(ts), "
                "INTERVAL '1' SECOND)) "
                "JOIN TABLE(TUMBLE(TABLE A, DESCRIPTOR(ts2), "
                "INTERVAL '1' SECOND)) "
                "ON P.person = A.seller")
            return _exec(S, t, "sql-join").collect()
        rows = both(run)
        got = _rowset(rows, ("who", "window_end", "state_id", "reserve"))
        env2 = PORT.Env(PORT.Conf({
            "state.num-key-shards": 8, "state.slots-per-shard": 32}))
        p2, a2 = self._streams(env2)
        sink = PORT.sinks.CollectSink()
        (p2.join(a2).where("person").equal_to("seller")
         .window(PORT.Tumbling.of(1000))
         .apply(left_fields=("state_id",), right_fields=("reserve",))
         .add_sink(sink))
        PORT.execute(env2, "ds-join")
        want = _rowset(sink.rows, ("key", "window_end", "left_state_id",
                                   "right_reserve"))
        assert len(got) > 0 and got == want

    def test_join_where_on_output(self):
        def run(S):
            t = self._views(S, n=800).sql_query(
                "SELECT P.person AS who, A.reserve "
                "FROM TABLE(TUMBLE(TABLE P, DESCRIPTOR(ts), "
                "INTERVAL '1' SECOND)) "
                "JOIN TABLE(TUMBLE(TABLE A, DESCRIPTOR(ts2), "
                "INTERVAL '1' SECOND)) "
                "ON P.person = A.seller WHERE reserve > 50")
            return _exec(S, t, "sql-join-where").collect()
        rows = both(run)
        assert rows and all(float(r["reserve"]) > 50 for r in rows)

    def test_window_equalities_accepted(self):
        def run(S):
            q = S.sql.parse(
                "SELECT P.person FROM TABLE(TUMBLE(TABLE P, DESCRIPTOR(ts),"
                " INTERVAL '1' SECOND)) JOIN TABLE(TUMBLE(TABLE A,"
                " DESCRIPTOR(ts2), INTERVAL '1' SECOND)) ON"
                " P.person = A.seller AND window_start = window_start"
                " AND window_end = window_end")
            return [list(map(list, c)) for c in q.source.conds]
        assert len(both(run)) == 3

    @pytest.mark.parametrize("sql,msg", [
        ("SELECT x FROM a JOIN b ON a.x = b.y",
         "window TVF on BOTH sides"),
        ("SELECT x FROM TABLE(TUMBLE(TABLE a, DESCRIPTOR(ts), INTERVAL"
         " '1' SECOND)) JOIN TABLE(TUMBLE(TABLE b, DESCRIPTOR(ts),"
         " INTERVAL '2' SECOND)) ON a.x = b.y",
         "share one window spec"),
        ("SELECT x FROM TABLE(SESSION(TABLE a, DESCRIPTOR(ts), INTERVAL"
         " '1' SECOND)) JOIN TABLE(SESSION(TABLE b, DESCRIPTOR(ts),"
         " INTERVAL '1' SECOND)) ON a.x = b.y",
         "SESSION window JOIN"),
        ("SELECT COUNT(*) FROM TABLE(TUMBLE(TABLE a, DESCRIPTOR(ts),"
         " INTERVAL '1' SECOND)) JOIN TABLE(TUMBLE(TABLE b,"
         " DESCRIPTOR(ts), INTERVAL '1' SECOND)) ON a.x = b.y",
         "aggregation over a JOIN"),
        ("SELECT x FROM TABLE(TUMBLE(TABLE a, DESCRIPTOR(ts), INTERVAL"
         " '1' SECOND)) JOIN TABLE(TUMBLE(TABLE b, DESCRIPTOR(ts),"
         " INTERVAL '1' SECOND)) ON a.x = b.y AND a.z = b.w",
         "exactly one cross-side key equality"),
    ])
    def test_unsupported_join_shapes_raise(self, sql, msg):
        def run(S):
            env, te = _fresh(S)
            s1, s2 = self._streams(env, n=50)
            te.create_temporary_view("a", s1, ["x", "z", "ts"])
            te.create_temporary_view("b", s2, ["y", "w", "ts"])
            with pytest.raises(S.sql.SqlError, match=msg) as e:
                te.sql_query(sql)
            return str(e.value)
        both(run)


def test_where_over_a_device_made_source():
    """A WHERE over bids made on the device: the reference evaluates the
    predicate on the host's copy of the batch (it has no device path for
    expressions), and so does the port; the rows are equal."""
    def run(S):
        env = S.Env(S.Conf({"state.num-key-shards": 8,
                            "state.slots-per-shard": 128,
                            "pipeline.microbatch-size": 4096}))
        t_env = S.table.TableEnvironment.create(env)
        src = S.gen.bid_stream_device(S.gen.NexmarkConfig(
            batch_size=4096, n_batches=3, events_per_ms=4,
            num_active_auctions=500, hot_ratio=4))
        t_env.create_temporary_view(
            "bids", env.from_source(src, S.WM.for_bounded_out_of_orderness(100)),
            schema=["auction", "bidder", "price"], time_attr="ts")
        return _exec(S, t_env.sql_query(
            "SELECT auction, window_end, COUNT(*) AS c FROM TABLE(TUMBLE("
            "TABLE bids, DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
            "WHERE auction < 100 GROUP BY auction, window_start, window_end"
        )).rows
    rows = both(run)
    assert rows and all(int(r["auction"]) < 100 for r in rows)


# ---------------------------------------------------------------------------
# tests/test_changelog.py TestSqlChangelogShapes and tests/test_global_agg.py
# TestSqlUnwindowed
# ---------------------------------------------------------------------------

def _cl_env(S, extra=None):
    return S.Env(S.Conf({
        "state.num-key-shards": 8, "state.slots-per-shard": 64,
        "pipeline.microbatch-size": 100, **(extra or {})}))


def _cl_data(n=600, nk=8, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nk, n).astype(np.int64),
            rng.random(n).astype(np.float32),
            np.arange(n, dtype=np.int64))


def _oracle(k, v):
    out = {}
    for kk, vv in zip(k, v):
        c, s, mx = out.get(int(kk), (0, 0.0, -np.inf))
        out[int(kk)] = (c + 1, s + float(vv), max(mx, float(vv)))
    return out


def _kv_view(S, k, v, ts):
    env = _cl_env(S)
    t_env = S.table.TableEnvironment.create(env)
    stream = env.from_collection({"k": k, "v": v}, ts, batch_size=100)
    t_env.create_temporary_view(
        "t", stream, schema=["k", "v", "ts"], time_attr="ts")
    return env, t_env


class TestSqlChangelogShapes:
    def test_unwindowed_group_by_sql_equals_datastream(self):
        k, v, ts = _cl_data(seed=23)

        def run(S):
            env, t_env = _kv_view(S, k, v, ts)
            sink = S.sinks.UpsertSink(key_fields=("k",))
            t_env.sql_query(
                "SELECT k, COUNT(*) AS c, SUM(v) AS sv FROM t GROUP BY k"
            ).stream.add_sink(sink)
            S.run(env, "sql-running")
            return sink.view()
        got_sql = {int(r["k"]): (int(r["c"]), float(r["sv"]))
                   for r in both(run)}
        env2 = _cl_env(TORCH)
        ds_sink = PORT.sinks.UpsertSink(key_fields=("key",))
        (env2.from_collection({"k": k, "v": v}, ts, batch_size=100)
             .key_by("k")
             .running_aggregate(PORT.agg.multi(
                 PORT.agg.count(), PORT.agg.sum_of("v")), retract=True)
             .add_sink(ds_sink))
        PORT.execute(env2, "ds-running")
        got_ds = {int(r["key"]): (int(r["count"]), float(r["sum_v"]))
                  for r in ds_sink.view()}
        assert set(got_sql) == set(got_ds) == set(_oracle(k, v))
        assert got_sql == got_ds

    def test_having_over_unwindowed_agg(self):
        k, v, ts = _cl_data(seed=31)
        views = []
        for sink_cls in ("RetractSink", "UpsertSink"):
            def run(S):
                env, t_env = _kv_view(S, k, v, ts)
                sink = getattr(S.sinks, sink_cls)(key_fields=("k",))
                t_env.sql_query(
                    "SELECT k, COUNT(*) AS c FROM t GROUP BY k HAVING c > 50"
                ).stream.add_sink(sink)
                S.run(env, "sql-having")
                return sink.view()
            views.append({int(r["k"]): int(r["c"]) for r in both(run)})
        want = {kk: c for kk, (c, _, _) in _oracle(k, v).items() if c > 50}
        assert want and views[0] == views[1] == want

    def test_agg_over_join_sql_vs_oracle(self):
        rng = np.random.default_rng(5)
        n = 300
        ts_p = np.sort(rng.integers(0, 6000, n)).astype(np.int64)
        persons = {"person": rng.integers(0, 8, n).astype(np.int64),
                   "ts": ts_p}
        ts_a = np.sort(rng.integers(0, 6000, n)).astype(np.int64)
        auctions = {"seller": rng.integers(0, 8, n).astype(np.int64),
                    "reserve": rng.integers(1, 100, n).astype(np.int64),
                    "ts2": ts_a}

        def run(S):
            env = _cl_env(S)
            t_env = S.table.TableEnvironment.create(env)
            p = env.from_collection(persons, ts_p, batch_size=100)
            a = env.from_collection(auctions, ts_a, batch_size=100)
            t_env.create_temporary_view("P", p, ["person", "ts"])
            t_env.create_temporary_view("A", a, ["seller", "reserve", "ts2"])
            t = t_env.sql_query(
                "SELECT P.person, window_start, COUNT(*) AS c, "
                "SUM(A.reserve) AS sr "
                "FROM TABLE(TUMBLE(TABLE P, DESCRIPTOR(ts), "
                "INTERVAL '1' SECOND)) "
                "JOIN TABLE(TUMBLE(TABLE A, DESCRIPTOR(ts2), "
                "INTERVAL '1' SECOND)) "
                "ON P.person = A.seller "
                "GROUP BY person, window_start")
            return _exec(S, t, "sql-join-agg").collect()
        rows = both(run)
        want = {}
        for i in range(n):
            for j in range(n):
                if (persons["person"][i] == auctions["seller"][j]
                        and ts_p[i] // 1000 == ts_a[j] // 1000):
                    key = (int(persons["person"][i]),
                           int(ts_p[i]) // 1000 * 1000)
                    c, s = want.get(key, (0, 0))
                    want[key] = (c + 1, s + int(auctions["reserve"][j]))
        got = {(int(r["person"]), int(r["window_start"])):
               (int(r["c"]), int(round(float(r["sr"])))) for r in rows}
        assert got and got == want


class TestSqlUnwindowed:
    def test_group_by_without_window_upserts(self):
        k, v, ts = _cl_data(n=1000, nk=20, seed=0)

        def run(S):
            env, t_env = _kv_view(S, k, v, ts)
            sink = S.sinks.UpsertSink(key_fields=("k",))
            t_env.sql_query(
                "SELECT k, COUNT(*) AS c, SUM(v) AS sv, MAX(v) AS mv "
                "FROM t GROUP BY k").stream.add_sink(sink)
            S.run(env, "running-sql")
            return sink.view()
        want = _oracle(k, v)
        got = {int(r["k"]): (int(r["c"]), float(r["sv"]), float(r["mv"]))
               for r in both(run)}
        assert set(got) == set(want)
        for kk in want:
            assert got[kk][0] == want[kk][0]
            assert got[kk][1] == pytest.approx(want[kk][1], rel=1e-3)
            assert got[kk][2] == pytest.approx(want[kk][2], rel=1e-5)

    def test_upsert_stream_supersedes(self):
        k, v, ts = _cl_data(n=1000, nk=20, seed=0)

        def run(S):
            env, t_env = _kv_view(S, k, v, ts)
            batches = []
            t_env.sql_query("SELECT k, COUNT(*) AS c FROM t GROUP BY k"
                            ).stream.add_sink(S.sinks.FnSink(batches.append))
            S.run(env, "upserts")
            return [S.sinks.rows_of(b) for b in batches]
        batches = both(run)
        seen, total = {}, 0
        for rows in batches:
            for r in rows:
                seen[int(r["k"])] = int(r["c"])
                total += 1
        want = _oracle(k, v)
        assert total > len(want)  # genuinely a changelog
        assert seen == {kk: c for kk, (c, _, _) in want.items()}

    def test_refusals(self):
        k, v, ts = _cl_data(n=1000, nk=20, seed=0)

        def run(S):
            env, t_env = _kv_view(S, k, v, ts)
            t_env.sql_query(
                "SELECT k, COUNT(*) AS c FROM t GROUP BY k HAVING c > 2")
            with pytest.raises(S.sql.SqlError, match="ORDER BY") as e:
                t_env.sql_query(
                    "SELECT k, COUNT(*) AS c FROM t GROUP BY k "
                    "ORDER BY c DESC LIMIT 3")
            return str(e.value)
        both(run)


# ---------------------------------------------------------------------------
# the planners: one SQL text, one operator graph
# ---------------------------------------------------------------------------

def _graph(S, table):
    """The lineage of ``table``'s stream as (node kind, name, window
    assigner, aggregate result fields, top-n, key field) in registration
    order."""
    keep, stack = set(), [table.stream.transform]
    while stack:
        t = stack.pop()
        if id(t) not in keep:
            keep.add(id(t))
            stack.extend(t.inputs)
    return _nodes(S, [t for t in table.t_env.env._transforms
                      if id(t) in keep])


def _nodes(S, transforms):
    out = []
    for t in transforms:
        a = getattr(t, "assigner", None)
        agg = getattr(t, "aggregate", None)
        out.append((
            type(t).__name__, t.name,
            None if a is None else (type(a).__name__, sorted(
                (k, v) for k, v in vars(a).items()
                if isinstance(v, (int, float, str)))),
            None if agg is None else list(S.agg.result_fields(agg)),
            getattr(t, "top_n", None),
            getattr(t, "key_field", None)))
    return out


PLAN_QUERIES = {
    "q5_hop_top1": HOP_Q5 + " ORDER BY bid_count DESC LIMIT 1",
    "tumble_where_lanes": (
        "SELECT auction, window_end, COUNT(*) AS c, SUM(price) AS s, "
        "MAX(price) AS mx, MIN(price) AS mn FROM TABLE(TUMBLE(TABLE bids, "
        "DESCRIPTOR(ts), INTERVAL '1' SECOND)) WHERE price > 250 "
        "GROUP BY auction, window_start, window_end"),
    "session_avg": (
        "SELECT auction, AVG(price) AS ap FROM TABLE(SESSION(TABLE bids, "
        "DESCRIPTOR(ts), INTERVAL '2' SECOND)) GROUP BY auction"),
    "window_all_max": (
        "SELECT window_end, MAX(price) AS hi FROM TABLE(TUMBLE(TABLE bids, "
        "DESCRIPTOR(ts), INTERVAL '5' SECOND)) "
        "GROUP BY window_start, window_end"),
    "running_having": (
        "SELECT auction, COUNT(*) AS c FROM bids GROUP BY auction "
        "HAVING c > 2"),
    "expr_arg_projection": (
        "SELECT auction, SUM(price * 2) AS dbl FROM TABLE(TUMBLE(TABLE "
        "bids, DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
        "GROUP BY auction, window_start, window_end"),
}


@pytest.mark.parametrize("name", sorted(PLAN_QUERIES))
def test_same_sql_same_operator_graph(name):
    def run(S):
        env, t_env, _ = _bids_view(S, n=100)
        return _graph(S, t_env.sql_query(PLAN_QUERIES[name]))
    graph = both(run)
    assert graph and graph[0][0] == "SourceTransformation"


def test_same_join_sql_same_operator_graph():
    def run(S):
        te = TestSqlJoin()._views(S, n=50)
        return _graph(S, te.sql_query(
            "SELECT P.person, window_start, COUNT(*) AS c "
            "FROM TABLE(TUMBLE(TABLE P, DESCRIPTOR(ts), INTERVAL '1' SECOND)) "
            "JOIN TABLE(TUMBLE(TABLE A, DESCRIPTOR(ts2), INTERVAL '1' SECOND)) "
            "ON P.person = A.seller GROUP BY person, window_start"))
    assert len(both(run)) > 4


def test_sql_q5_lowers_to_the_datastream_q5_graph():
    """SQL Q5 lowers to exactly ``nexmark.queries.q5_hot_items``' graph
    (the projection's map aside), so on the same batches it launches
    what the DataStream job launches."""
    env, t_env, _ = _bids_view(TORCH, n=100)
    sql = _graph(TORCH, t_env.sql_query(
        HOP_Q5.replace("'4' SECOND", "'10' SECOND")
        + " ORDER BY bid_count DESC LIMIT 1"))
    env2 = PORT.Env(PORT.Conf({}))
    PORT.q5(env2, PORT.GeneratorSource(lambda s, i: None),
            PORT.sinks.CollectSink(), window_ms=10_000, slide_ms=1_000)
    ds = _nodes(TORCH, env2._transforms)
    assert ds[-1][0] == "SinkTransformation"

    def shape(nodes):  # the maps' names differ (q5_rename, sql_agg_project)
        return [(k, a, f, top, key) for k, _, a, f, top, key in nodes]
    assert shape(sql) == shape(ds[:-1])
    assert sql[2][4] == ("count", 1)


def test_execute_defaults_to_the_card():
    """``Table.execute()`` with no device asks for CUDA: it raises where
    there is none, and does not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env, t_env, _ = _bids_view(TORCH, n=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_env.sql_query("SELECT auction FROM bids").execute()
