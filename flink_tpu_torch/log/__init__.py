"""Durable log exchange — embedded replayable topics + 2PC connectors
for exactly-once job chaining (log/topic.py has the protocol), plus
the message-bus tier on top: key compaction, retention, fenced
per-partition writer leases, and consumer groups (log/bus.py)."""
from flink_tpu_torch.log.bus import (
    Compactor,
    ConsumerGroups,
    LeaseError,
    LeaseManager,
    Retention,
    TopicMaintenance,
)
from flink_tpu_torch.log.cleaner import (
    CleanerLease,
    LogCleaner,
    check_manual_maintenance,
    cleaner_status,
    live_cleaner_owner,
)
from flink_tpu_torch.log.connectors import LogSink, LogSource
from flink_tpu_torch.log.topic import (
    LogError,
    TopicAppender,
    TopicReader,
    create_topic,
    describe_topic,
    list_group_offsets,
    list_leases,
    topic_key_field,
    topic_partitions,
)

__all__ = ["LogError", "LogSink", "LogSource", "TopicAppender",
           "TopicReader", "create_topic", "describe_topic",
           "topic_partitions", "topic_key_field", "list_leases",
           "list_group_offsets", "Compactor", "ConsumerGroups",
           "LeaseError", "LeaseManager", "Retention",
           "TopicMaintenance", "LogCleaner", "CleanerLease",
           "cleaner_status", "live_cleaner_owner",
           "check_manual_maintenance"]
