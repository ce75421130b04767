"""Table & SQL API over the DataStream runtime (SURVEY §3.8).

Two equivalent frontends, one lowering:

    t_env = TableEnvironment.create(env)
    t_env.create_temporary_view("bids", stream, schema=[...], time_attr="ts")
    t_env.sql_query('''
        SELECT auction, window_end, COUNT(*) AS bid_count
        FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts),
                       INTERVAL '1' SECOND, INTERVAL '10' SECOND))
        GROUP BY auction, window_start, window_end
        ORDER BY bid_count DESC LIMIT 1
    ''').execute()

or the fluent Table API: ``table.window(Hop.of_ms(10_000, 1_000))
.group_by("auction").aggregate(AggCall("count", None, "bid_count"))``.
"""
from flink_tpu_torch.table.api import (
    AggCall,
    Hop,
    Session,
    Table,
    TableEnvironment,
    TableResult,
    TableSchema,
    Tumble,
)
from flink_tpu_torch.table.expressions import col, lit
from flink_tpu_torch.table.sql import SqlError

__all__ = [
    "AggCall", "Hop", "Session", "Table", "TableEnvironment",
    "TableResult", "TableSchema", "Tumble", "col", "lit", "SqlError",
]
