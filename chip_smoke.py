#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``flink_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (or
another sm_90a card), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``build``   — compiles ``flink_tpu_torch/kernels/csrc/*.cu`` with nvcc
   (one process per source, started together) into
   ``flink_tpu_torch/_build/``, and the host codec
   ``flink_tpu_torch/native/codec.cc`` with g++ beside them.
2. ``kernels`` — each kernel against its plain PyTorch version on the
   card (integers and max/min exactly, and sums where both add in one
   fixed order; the plain ``scatter_lanes`` adds with atomics on the
   card, so there its sums are held to the bound of another order, and
   the kernel's lanes must equal the plain version's on the CPU, which
   adds in record order, bit for bit), then its time (CUDA
   events, warmed, many launches), the plain version's time, the time of
   one PyTorch library call computing the same function where there is
   one, and the least time the card could take (bytes over 3.35 TB/s or
   operations over 67 T/s, whichever is larger). The four window
   kernels at the host-fed Q5 shapes (128 x 256 key slots + 1 dump row,
   a 32-column pane ring, 11 windows of 10 panes, ~110k host-combined
   pairs); ``nexmark_bids`` and ``devgen_ingest`` at the headline shapes
   (a 2^20-bid sub-batch, 32,769 x 64 state, 10,000 auctions, hot ratio
   4), plus a ``devgen_ingest`` case with out-of-domain and late
   records that compares the stats vector and re-fire bitmap too, and
   ``devgen_ingest``'s Nexmark form (the bids made in registers, the
   devgen path's one launch a sub-batch; its row's time) steady and with
   late and re-fire records against ``nexmark_bids_plain`` then
   ``devgen_ingest_plain`` (no path launches ``nexmark_bids`` itself:
   its count over every path must stay 0); the
   lane kernels at this slice's shapes: ``fire_pack`` on WordCount
   state (65,537 x 16, 4-window chunks, ~28k words per window) and on
   bid-aggregate state (32,769 x 32 x 1 sum + 1 max + 1 min lane, and
   1 sum lane alone, job (b)'s layout), ``scatter_lanes`` on a 2^20-bid
   batch and on the same batch with 2^18 of its records in one cell (each
   bit for bit against its plain version on the CPU, with its kernels'
   device time by name, ``index_add_`` and a stable ``torch.sort`` of the
   cells beside), ``scatter_pair_lanes`` on its ~110k host-combined pairs
   (in the C combine's first-seen order, and ascending beside it),
   ``ring_columns`` over an f32 lane and over a whole four-lane state
   block in one launch (the purge of a cleared run that wraps past the
   ring's end, and a growth 32 -> 64; NaN payloads, -NaN and -0.0 in
   kept cells moved bit for bit), both kernels beside their library calls
   as loop ms, device ms and host µs a call; and the count-lane kernels in
   WordCount's forms: ``scatter_counts`` per record on a 2^20-word batch
   into 65,537 x 16 state, ``ring_columns`` growing 6 to 16 columns; the
   native lane's kernels at the host-fed Q5 shapes: ``apply_pairs_u32``
   on ~110k pair words into 32,769 x 32, ``apply_pairs_u16`` with pair
   counts of 4095 and more, and ``fused_step`` (one upload: header + the
   pair words; apply, fire of 1 or 11 window ends with top-1, purge) with
   the fire gate on and off; the count window's ``count_fire`` on
   WindowWordCount's state (65,537 rows, each word's count after one real
   2^20-word batch, one sum lane) and with a sum, a max and a min lane,
   each timed on a fresh copy of the state; ``split_cells`` on a
   2^20-bid batch's 3-byte upload into 32,769 x 32 (the decode alone,
   which no path launches: every kernel that reads the upload decodes it
   itself), and ``scatter_split_counts`` (the count lane's decode and
   count in one launch) on the same upload; ``scatter_lanes`` on job
   (a)'s batch as flat cells and as its split upload's bytes (the form
   its path runs); the top-n lane
   kernels at job T's shapes: ``window_lanes`` (32,769 x 32, 11 windows
   of 10 panes, a sum and a max lane) and ``topn_select_lanes`` (top-1
   by the max, two result columns), each bit for bit; the element path's
   ``segment_lanes`` at job E's fire (~10,000 segments, each auction's
   last 100 of a window's 2^20 bids, ~750k elements, the lanes of
   ``multi(count(), avg_of(price), max_of(price))``) and on an edge case
   (planted +/-NaN with payloads, +/-inf, +/-0, one-element segments, a
   5,000-element one), bit for bit.
3. ``q5``      — Nexmark Q5 hot items, host-fed, through the port's
   ``StreamExecutionEnvironment.execute()`` at the conf of
   ``confs/bench_q5_host_fed.conf`` on 16 batches of 2^20 bids, through
   the native lane (the C scan, then one ``fused_step`` per batch after
   the first); then 4 batches on the numpy lane (the numpy key table,
   ``scatter_counts``), 4 batches of hot-key bids (1,000 auctions, half
   the bids on 10 of them: pair counts past 0xFFF, ``apply_pairs_u16``),
   and a ``torch.profiler`` run of 4 native-lane batches, in which each
   ``fused_step`` call is a profiler range: its device time per step is
   the kernels inside the range, not every kernel that shares a name.
4. ``q5_devgen`` — the headline path: Q5 with bids made on the card, at
   ``confs/bench_q5_headline.conf`` (2^22-bid logical batches in 4
   sub-batches, 128 x 256 key slots) on 16 logical batches (67,108,864
   bids): one short warm-up run, then five timed runs, each checked in
   full (one ``devgen_ingest`` launch a sub-batch, its bids made inside
   it, and no ``nexmark_bids``); the median run's numbers are printed
   beside every run's rate. Then 4 logical batches at 1 and at 4
   sub-batches (the first with a 64-column pane ring), whose rows must
   agree window by window.
5. ``wordcount`` — BASELINE.json config #0 (``bench.py:441-478``) at
   ``confs/bench_wordcount.conf``: 2^20-word batches, 128 x 512 slots,
   a 1 s tumbling count fired through ``fire_pack``. One warm-up run of
   4 batches, then three timed runs of 24 batches, each checked in full
   against a numpy golden of per-(word, window) counts.
6. ``bid_aggs`` — on the host-fed Q5 bids and conf, keyed by auction,
   sliding 10 s / 1 s: job (a) count + sum + max + min of price (per
   record, ``scatter_lanes``) and job (b) count + avg (host-combined,
   ``scatter_pair_lanes``), 16 batches of 2^20 bids each, checked
   against a numpy golden: counts, max and min exactly, sums and avgs
   within ``agg_rel_bound``. Job (a) uploads 3 bytes a record, decoded
   inside ``scatter_lanes`` (no ``split_cells`` launch).
7. ``window_wordcount`` — the upstream WindowWordCount example
   (``keyBy(word).countWindow(250, 150).sum(1)``; the port's count
   windows tumble, so the slide is dropped) as
   ``count_window(250).sum("n")`` on the WordCount stream and state:
   one warm-up run of 4 batches, three timed runs of 24 batches of 2^20
   words (``scatter_lanes`` + ``count_fire`` a batch), every emitted
   batch checked against a numpy golden as (key, count, sum) sorted by
   key; then a ``count()`` job on 4 batches (``scatter_counts``).
8. ``topn_lanes`` — job T: the host-fed Q5 bids and conf keyed by
   auction, sliding 10 s / 1 s, ``multi(max_of("price"),
   avg_of("price"))`` then ``.top(1, by="max_price")`` on 16 batches of
   2^20 bids (per record through ``scatter_lanes``' split form;
   each fire ``window_counts``, ``window_lanes``, the finalize in torch
   and ``topn_select_lanes``), then the same stream with ``.top(3,
   by="avg_price")``; the rows against a numpy golden (by max exactly;
   by average under the margin rule: where a window's 3rd and 4th
   averages lie further apart than their bounds the winners must equal
   the golden's, else lie among the rows tied within the bounds).
9. ``changelog`` — job C: the same bids as a changelog feed (an int8
   ``__op__`` column from the seed: 70 % +I, 10 % +U, 10 % -U, 10 %
   -D), 10 s tumbling windows by auction,
   ``multi(changelog_count("net"), changelog_sum_of("price"),
   changelog_avg_of("price"))`` on 16 batches of 2^20 records, against a
   numpy golden (counts and signed counts exactly, signed sums within
   the bound of their absolute terms).
10. ``q5_spill`` — job S: Q5 hot items host-fed with ``state.backend:
   spill`` at 128 x 256 key slots and 100,000 auctions (about 3 x the
   slots), 8 batches of 2^20 bids: the keys past the slots aggregate in
   the host spill store and re-rank with the device's winners at every
   fire; rows against Q5's numpy golden, ``records_spilled`` printed.
   Its batches go per record as the 3-byte split upload, each decoded
   and counted in one ``scatter_split_counts`` launch.
11. ``element_window`` — the element path on the host-fed bids, keyed
   by auction, 10 s tumbling windows: job E
   ``.evictor(CountEvictor.of(100)).aggregate(multi(count(),
   avg_of(price), max_of(price)))`` on 4 batches of 2^20 bids (each fire
   ~10,000 windows, ~750k survivors, one ``segment_lanes``), and job E2
   ``.trigger(CountTrigger.of(1000)).aggregate(multi(count(),
   sum_of(price), min_of(price)))`` on 2 batches (mid-window fires of
   growing prefixes, reduced per batch); each against a numpy golden
   (each window's last 100 bids in arrival order; each prefix at every
   1,000th bid): counts, max and min exactly, averages and sums within
   ``agg_rel_bound``; ``segment_lanes``' share of device time printed.
12. ``proc_time`` — job P: Q5's count by auction over
   ``TumblingProcessingTimeWindows.of(1 s)`` on 16 batches of 2^20
   host-fed bids (the native lane; every record of a batch takes the
   clock's pane): each auction's counts add up to its bids, each
   (auction, window) fires once, and the path's kernels launched.

In the pipeline phases every kernel's launch counter is zeroed just
before the run and read just after; each kernel of the path must have
launched, the committed rows must equal the phase's numpy golden, and
the phase prints events/s and the device's idle share (CUDA events
around each launch group; a ``torch.profiler`` run beside gives kernel
time by name, and ``fire_pack``'s and ``topn_select_lanes``' device
kernels a call, which must be one, and two at top-1 or one (five where
the radix select does not fit the card at once) at top-n; likewise two
a ``topn_select_append`` call at top-1 on the devgen path, five a
``fused_step`` on the native lane (the first the apply's header form,
whose profiled name is checked) and one a ``topn_select_given`` on the
mesh).

13. ``mesh`` — the key-sharded window operator on a mesh of four blocks
   on ``cuda:0`` (``env.execute(mesh_plan=...)``): job M1 Q5 hot items
   at confs/bench_q5_host_fed.conf on 16 x 2^20 bids (rows against the
   golden and the ``q5`` phase's single-block rows), M2 the
   bid-aggregate job (a) per record (4 batches), M3 1,000 hot auctions
   under ``pipeline.exchange-capacity: 16384`` (the host splitter, no
   overflow), M4 the ring exchange (4 batches); each with its rate, idle
   share, launches and exchange bytes (M1's and M4's against the bytes
   their layout moves between blocks). The profiled M1 run must show one
   kernel a ``bucket_records`` and a top-1 ``topn_candidates`` call, no
   device-to-device copy (on one card each source block's buckets go
   straight into the owners' receive rows) and no gather kernel (no
   ``topn_global_threshold`` and no cat: the blocks' candidates land in
   one buffer and each select works the global k-th out itself). The
   ``kernels`` phase holds
   the path's ``bucket_records``, ``hash_keys``, one chunk's exchange
   and the distributed top-n modes bit for bit against their plain
   versions at M1's shapes.

14. ``big_cells`` — a count + sum job on pane state past 2^31 cells:
   1088 x 65,536 key slots + 1 dump row and a 32-column ring (2.28 G
   cells, uploaded as int64 cells where the JAX package switches), four
   2^20-bid batches with half the keys on rows past 2^26 (every cell of
   theirs past 2^31), a fire of window ends 1..12 s with its purge, a
   batch 40 s ahead that grows the ring to 64 columns (``ring_columns``
   a block of rows a launch), then the end-of-input fire; every row
   against a numpy golden, with its rows, ring, the bytes it held on the
   card and its events/s.

15. ``checkpoint`` — exactly-once checkpoints: Q5 with bids made on the
   card at the headline shape (16 x 2^22, 4 sub-batches), Q5 host-fed
   (16 x 2^20, native lane) and WindowWordCount (8 x 2^20), each into a
   ``TransactionalCollectSink`` without checkpoints, with one at every
   batch boundary once the last is durable (interval 1 ms), under
   faults (``faults.inject`` fails the third checkpoint write, a sink
   fails its attempt at a third of the rows; ``run_with_recovery``,
   fixed delay), then without and with again (the warm pair gives the
   rates): every run's rows equal the golden, the chaos run's equal the
   fault-free run's in commit order, and a retained devgen checkpoint
   must hold a position in the middle of a logical batch. Printed: the
   completed checkpoints, the loop thread's ms a checkpoint (the fire
   drain and the freeze, p50 and max), the executor's persist ms (p50
   and max), bytes a checkpoint, and events/s with checkpoints beside
   without (smoke figures, not a benchmark). Since slice 21 a fourth
   job: session windows (phase 16's job, 4 batches) at
   ``host.parallelism`` 4, whose chaos run also fails a host pool task
   (``CKPT_POOL_FAULT``); its committed sessions against the
   brute-force sessionizer.
16. ``sessions`` — BASELINE config #4 (``bench.py:683-726``,
   ``confs/bench_sessions.conf``): 50,000 users, 12 batches of 2^20
   clicks in 1 s bursts, 2 % of them up to 3 s late, session gap 500 ms,
   allowed lateness 5 s, out of order 1 s, ``count()``, at
   ``host.parallelism`` 1 and 4: the two runs' rows byte-identical, each
   session's final row against a brute-force sessionizer, the late drops
   against its count, no kernel launched (the lift and finalize are
   torch on the CPU by design); beside it, one batch's columns copied to
   the card and back.
17. ``q8`` — BASELINE config #3 (``bench.py:408-438``,
   ``confs/bench_q8.conf``): 100,000 active people, 24 batches of 2^18
   events on each input, 1 s tumbling windows, out of order 1 s; the
   join in ``pairs`` mode (host row buffers) against every person ⋈
   seller pair of each window, and in ``aggregate`` mode (two device
   window operators: ``scatter_lanes``, ``fire_pack``, ``ring_columns``)
   against each (key, window)'s counts and maxima.
18. ``q7`` — BASELINE config #2 (``bench.py:385-405``,
   ``confs/bench_q7.conf``): 10,000 auctions, hot ratio 4, 24 batches
   of 2^18 bids, 10 s tumbling windows, out of order 1 s; windowAll's
   host pane fold against each window's max price and bid count.
19. ``emit_defer`` — Q5 host-fed (8 x 2^20 bids) at
   ``pipeline.emit-defer`` 0 and 500 ms: the same rows in the same
   order, the emit latency of each.
20. ``hybrid`` — one job across two processes on the one card: this
   script started twice with ``--hybrid-worker`` (``sys.executable``),
   each process on ``make_hybrid_mesh_plan(128, 256, 2, pid, ["cuda:0",
   "cuda:0"])`` through ``execute(mesh_plan=...)``, connected on
   loopback with ``cluster.dcn-secret`` set. The job is Q5's count stage
   (sliding 10 s / 1 s COUNT per auction, no top-n) on bench.py:206-208's
   bids at confs/bench_q5_host_fed.conf's widths, 16 x 2^20 bids in two
   splits (a split a process), into a ``FileTransactionalSink`` with a
   checkpoint every 1 ms. The union of the two processes' committed rows
   must equal the single-process run on the card and the numpy golden;
   a ``torch.profiler`` run in each process must find every X1
   (``bucket_records``) kernel inside ``intra_slice_exchange``'s ranges;
   then process 1 dies after a checkpoint, both restart with the
   negotiated restore, and the union is again the golden's. Printed:
   events/s a process and for the fleet, each process's device idle share
   by CUDA-event spans, X1's launches, loop ms, device ms and bound on
   this path, the bytes each process sent over the exchange and its
   ``cross_slice_fraction``, and the rendezvous wait p50 and p99. Every
   worker's exit code is checked. The ``kernels`` line's
   ``bucket_records`` row carries the hybrid figures (``hybrid``) and its
   launches there (``launches_by_path``).

21. ``state_tiers`` — job S's shapes (Q5 host-fed over 100,000
   auctions against 128 x 256 key slots, 8 batches of 2^20 bids) through
   the state tiers and the host operators of this slice, each against a
   numpy golden: S-LSM (job S with ``state.backend: lsm``, a 1 MiB
   delta budget, so a run seals about every batch, and
   ``state.lsm.compact-min-runs: 2``: at Q5's 10 s window over 10.5 s
   batches the purge drops a run about a batch after it seals, so no
   more than two runs are ever live) whose rows must equal job S's
   spill run in commit order, with its seals, compactions, bytes on disk
   and rows; S-LSM crashed (a storage write fault and a poisoned sink,
   through ``run_with_recovery``) and resumed, its committed rows the
   fault-free rows, with the run files each retained checkpoint
   hardlinked; the debloater on job S at ``pipeline.emit-defer: 20ms``
   (without it each fire is delivered in the pass that fired it, p99
   under the key's 1 ms resolution) with ``pipeline.target-latency`` set
   to half the fire-to-sink p99 the same job reads without a target (the
   p99 printed first): rows as the golden, the ``debloat_chunk`` gauge
   ending below the source batch, more pushes than batches; ``running_aggregate`` of count, sum
   and max of price by auction in upsert and retract mode (final views
   against a numpy golden, sums bit for bit: the golden folds in the
   operator's order); and a ``KeyedProcessFunction`` (an idle timeout on
   a ``ValueState`` and event-time timers) against a numpy golden of
   its alerts. The last three keep their keys in 128 x 1024 slots.
22. ``host_patterns`` — bench.py:206-208's bids at
   confs/bench_q5_host_fed.conf through the host operators of CEP,
   async I/O and broadcast state,
   each against a numpy golden: CEP on 4 x 2^20 bids keyed by bidder (a
   low bid, under the 20th percentile of price, followed by a high one,
   over the 99th, within 10 s) run with one partial a key, as NO_SKIP
   with ``max_partials`` set from the data, and with a trailing absence
   window (no bid over the 99.9th percentile within 10 s of the low one),
   each held to a plain per-key automaton written here; async I/O on 8 x
   2^20 bids (auction to one of 64 categories from a numpy table, 2 ms a
   batch, capacity 8), ordered and unordered, into a keyed 1 s tumbling
   count on the card; and broadcast state (per-category thresholds in
   the control stream's one batch) into the same window. Printed a job:
   events/s, the device idle share by CUDA-event spans, the kernels it
   launched, and for async the mean batches in flight (submit to release
   over the job's wall time).
23. ``rescale`` — the hybrid phase's job (16 x 2^20 bids a split, two
   splits, into ``FileTransactionalSink``s) through two cuts, this
   script started as ``--rescale-worker`` processes: 2 -> 1 (two
   processes on their hybrid plans checkpoint every step in lockstep and
   stop after batch 8; one process restores both checkpoints through
   ``cluster.rescale-from`` on mesh M1's four blocks of cuda:0 and runs
   batches 9-16) and 1 -> 2 (one process on M1's blocks stops after a
   synchronous checkpoint at batch 8; two restore their spans of it).
   Each old sink first commits the epochs its cut staged. Checked: the
   union of committed rows against the golden, each (auction, window)
   once, and the resumed half's ``bucket_records`` and window kernels
   launched. Printed: the restore's load, merge and re-block plus upload
   seconds, the resumed half's events/s and idle share.
24. ``sql`` — Table/SQL on the card, the bids of ``bench.py:206-208``.
   SQL Q5 (HOP 1 s / 10 s, ``COUNT(*)``, ``ORDER BY bid_count DESC
   LIMIT 1``) host-fed at ``confs/bench_q5_host_fed.conf`` on 16 x 2^20
   bids beside ``nexmark.queries.q5_hot_items`` on the same batches: the
   same rows in commit order, the same ``LAUNCHES``, and the golden's
   rows; the same SQL over ``bid_stream_device`` at
   ``confs/bench_q5_headline.conf`` (4 logical batches of 2^22 at 4
   sub-batches) beside the DataStream devgen job: the same rows and
   launches, one ``devgen_ingest`` a sub-batch and no ``nexmark_bids``;
   a TUMBLE 1 s COUNT / SUM / MAX / MIN of price per auction with
   ``WHERE price > <the bids' median>`` on 8 x 2^20 bids against a numpy
   golden (counts, max and min exact, sums within the bound of
   ``agg_rel_bound``); SQL Q5 on 8 x 2^20 bids checkpointing at every
   batch boundary into ``crash://`` (``fs_crash.install``, a journaled
   run for each of seeds 0 and 1), 3 crash images a seed restored on
   the card with ``restore: latest`` into the transactional sink as the
   cut left it (each the golden's rows once, or a loud failure; at
   least half recovered); and the same job with ``plugins.modules:
   flink_tpu_torch.fs_objstore`` checkpointing to ``objstore://``,
   crashed once by the storage fault and resumed to the golden. Printed:
   events/s, idle share and parse-plus-plan ms a query, each image's
   cut, restored checkpoint and outcome, the launches of each job.

25. ``log`` — the durable log tier feeding Q5, ``bench.py``
   ``run_q5_backfill``'s shape at ``confs/bench_q5_backfill.conf``
   (128 x 256 key slots, 2^18-record batches and reads, group fsync,
   zero-copy reads with one batch of readahead, a consumer group): the
   port's ``LogSink`` commits 8 history batches of 2^18 bids
   (``bench.py:564-575``: 10,000 auctions, ``ts = event_id // 100``) into
   two 2-partition topics, ``Compactor`` compacts one keyed on
   ``event_id``, and Q5 (sliding 10 s / 1 s) reads each topic through
   ``LogSource`` in its group on the card; then 4 live batches land and
   the same groups read on past their committed offsets. Checked in
   both phases: the compacted topic's rows equal the never-compacted
   topic's and ``q5_golden`` over the same bids, ``records_in`` equals
   the bids produced, and a fire and a top-n kernel launched. Then a
   crash run: Q5 over the whole compacted topic in a fresh group,
   checkpointing at every batch boundary, its output into a ``LogSink``
   topic, under ``run_with_recovery`` with a ``log.prefetch.read`` and a
   ``log.txn.commit`` fault armed: the output topic holds each golden
   row once, after one or two recoveries. The port's ``fsck_path`` then
   checks the crash run's output topic and checkpoint directory: no
   finding of error severity, and the findings' counts by rule are
   printed. Printed: the phase line (bids/s
   and idle share a phase, the host seconds split into the wait for the
   topic's read and decode, the push into the operator and the rest,
   the read and decode alone, the launches, the crash run's figures)
   and a compact ``log_summary`` line. ``--log`` runs it alone.

26. ``batch`` — bounded WordCount from files in streaming and batch mode
   (``execution.runtime-mode``), BASELINE #0's words (``bench.py:441-478``:
   2^20 a batch, ``floor(u^2 * 30,000)``, ``ts = index // 100``) at
   ``confs/bench_wordcount.conf``'s shape (128 x 512 key slots, one step
   in flight). Setup, timed apart: the port's ``FileSink`` writes 16
   batches (``word``, ``ts``, int64) as ``ColumnarFormat`` parts, one a
   batch. Then ``FileSource(ColumnarFormat)`` -> ``key_by("word")`` ->
   1 s tumbling ``count()`` -> ``FileSink(CsvFormat)`` runs in streaming
   mode, in batch mode at ``execution.batch.shuffle-partitions`` 1 and at
   4; and 2 batches written as CSV parts run in batch mode through the C
   parser. Checked in each run: the committed CSV rows, sorted, equal
   across the runs and the numpy golden, ``records_in`` equals the words,
   a batch run reports 2 waves and spools every word, and
   ``apply_pairs_u32`` or ``scatter_counts``, ``fire_pack`` and
   ``ring_columns`` launched. Printed: the phase line and a compact
   ``batch_summary`` line (words/s a run, idle share, batch mode's wall
   split into wave 0, wave 1's replay and push, the one fire and the
   commit, the shuffle's bytes, the launches). ``--batch`` runs it alone.

Every line the script prints also goes to
``chiprun_out/chip_smoke_phases.jsonl``, with the kernels' per-path
detail (``kernels_detail``) that the printed ``kernels`` line leaves out.

In the default run, for the script's time budget, phase 22's CEP takes
2 batches and phase 23 8 batches a split, cut after batch 4 (each JSON
line lists its cut); ``--host-patterns`` and ``--rescale`` run the sizes
above. Before the card line the default run prints each phase's seconds
(``phase_seconds``).

Each of 16-26 prints its events/s and wall time beside the card's name
and power limit.

With ``--scatter-lanes`` it builds ``lane_kernels`` alone and runs only
the two ``scatter_lanes`` cases above (one JSON line).

With ``--window-lanes`` it builds ``topn_lanes_kernels`` alone and times
``window_lanes`` at job T's shape beside ``sums @ colmask`` (the sum
lane, and both lanes as one batched matmul, TF32 off), each as loop ms,
device ms and host µs a call (one JSON line).

With ``--launch-path`` it builds the kernels and prints every wrapper's
host µs a call at a main-path shape and the loop ms of ``SPEED_ROWS``
(one JSON line); run beside a parent tree to compare.

With ``--big-cells`` it builds the kernels and runs only phase 14.

With ``--cases NAME[,NAME...]`` it runs rows of one case table
(``KERNEL_CASES``): each row builds only the sources it needs and prints
one JSON line of its kernels held bit for bit against their plain
versions, then timed as loop ms (CUDA events, 50 calls), device ms and
device entries a call (``torch.profiler``, 10 calls) and host µs a call
(1,000 calls without a sync) beside their bounds and library calls. To
compare with a parent, unpack it under ``_archive/`` with this file
copied in and run both in one call, in turns. The rows:

- ``ring_pairs`` (also ``--ring-pairs``): ``scatter_pair_lanes`` and
  ``ring_columns`` beside their library calls;
- ``fire_kernels`` (``--fire-kernels``): ``fire_pack`` (the three
  ``kernels`` cases) and ``topn_select_lanes`` (job T's top-1 and the
  planted top-3);
- ``count_topn`` (``--count-topn``): ``topn_select_append`` (top-1 and a
  planted top-3), ``fused_step`` (the fire of 11 ends, gate on),
  ``topn_select_given`` (job M1's first block);
- ``count_lane`` (``--count-lane``): the count lane's ``window_counts``
  (the Q5 fire and one pass of 64 ends), the fused step's fire of 11
  ends, and ``scatter_counts`` on Q5's pairs, per record on WordCount's
  words and on the split upload's bytes;
- ``mesh_kernels`` (``--mesh-kernels``): the key-sharded path's
  ``bucket_records`` (M1's source block count only, with M2's three
  lanes, M3's 1,000 hot auctions at capacity 16,384, and int64 cells),
  one chunk's whole exchange (``keyby_exchange`` over four blocks of
  ``cuda:0``) and ``topn_candidates`` at M1's fire (top-1 and top-3);
- ``count_fire``: ``count_fire`` at WindowWordCount's fire, the ``sum``
  and ``lanes`` shapes, held purging and not, timed apart from the
  state's restore;
- ``devgen_ingest``: a headline sub-batch's make and ingest, without
  and with stats: the pair (``nexmark_bids`` then ``devgen_ingest``),
  the memory form alone and the Nexmark form (one launch);
- ``apply_threshold``: ``apply_pairs_u32`` at Q5 host-fed's and
  WordCount's batches on the real and the padded words, the fused
  step's fire of 11 ends on both uploads, and one sharded top-n chunk
  at M1's fire (4 blocks of ``cuda:0``, top-1 and top-3) through the
  tree's own ``_topn_sharded``, then each of its pieces alone (window
  counts, candidates, the parent's cat, ``topn_global_threshold``
  beside ``torch.topk``, ``topn_select_given``);
- ``split_segment``: ``split_cells`` folded into its readers, at job
  (a)'s batch (``split_cells``, ``scatter_lanes`` on flat cells, the two
  in turn, and ``scatter_lanes``' split form where the tree has it) and
  on one source block of a mesh chunk (the same with ``bucket_records``,
  count only and with M2's lanes) and the chunk's whole exchange; and
  ``segment_lanes`` at job E's fire, on the edge case and at job E2's
  largest fire, in each group form the tree has;
- ``checkpoint_cost``: the headline devgen job (16 x 2^22, K = 4) in
  turns without checkpoints, with them, and with the checkpoint
  executor's steps swapped out one at a time (the JAX package's byte
  assembly of the blobs, no fsync, 256 KiB writes, a sleep for the
  write, no write, no encode, no fetch): wall seconds, checkpoints and
  the final checkpoint's seconds a run, rows against the golden;
- ``mesh_m1``: job M1 of the mesh phase three times in one process, its
  events/s a run (a tree beside its parent, in turns).

With ``--checkpoint`` it builds the kernels and runs only phase 15.
With ``--state-tiers`` it builds the kernels and runs only phase 21,
with ``--host-patterns`` phase 22, with ``--rescale`` phase 23 and with
``--sql`` phase 24.

With ``--host-operators`` it builds the kernels and runs only phases
16-19. With ``--hybrid`` it builds the kernels and runs only phase 20.

With ``--mesh-cards`` it builds the kernels and runs only Q5 over a mesh
of one block per visible card (16 x 2^20 bids, then 4 batches with the
ring exchange), checked against the golden: the exchange's copies
between cards.

Then the card's name and power limit (nvidia-smi), the kernel table as
one JSON object, and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero without that last line; so does a machine with
no CUDA device, and a directory without the package.
"""
import collections
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT_OPS_PER_S = 67e12          # non-tensor-core rate (fp32 table entry)
Q5_BATCH = 1 << 20
Q5_BATCHES = 16
DEVGEN_BATCH = 1 << 22          # confs/bench_q5_headline.conf
DEVGEN_BATCHES = 16
DEVGEN_SUB = 4
DEVGEN_K_BATCHES = 4            # the K = 1 / K = 4 comparison
DEVGEN_RUNS = 5                 # timed headline runs, after one warm-up
SEED = 20261017
WC_BATCH = 1 << 20              # confs/bench_wordcount.conf
WC_BATCHES = 24                 # bench.py:737-738: warm-up 4, timed 24
WC_WARMUP_BATCHES = 4
WC_RUNS = 3
WC_VOCAB = 30_000
AGG_BATCHES = 16                # the bid-aggregate jobs, 2^20 bids each
CW_SIZE = 250                   # WindowWordCount.java countWindow(250, 150)
BIG_SHARDS, BIG_SPD = 1088, 65_536  # --big-cells: 71,303,169 rows x 32 columns
BIG_BATCH, BIG_BATCHES = 1 << 20, 4
BIG_KEYS = 1 << 16
KERNEL_SOURCES = ("window_kernels", "devgen_kernels", "lane_kernels",
                  "fused_kernels", "count_window_kernels", "topn_lanes_kernels",
                  "element_kernels", "exchange_kernels")
TOPN_BATCHES = 16               # job T, 2^20 bids each
CHANGELOG_BATCHES = 16          # job C
SPILL_BATCHES = 8               # job S
SPILL_AUCTIONS = 100_000        # job S's key domain, ~3 x the 32,768 slots
SIDE_BATCHES = 4                # the profiled runs of jobs T, C and S
ELEMENT_BATCHES = 4             # job E (evictor), 2^20 bids each
ELEMENT_TRIGGER_BATCHES = 2     # job E2 (count trigger)
ELEMENT_SIDE_BATCHES = 2        # the profiled runs of jobs E and E2
PROC_BATCHES = 16               # job P (processing time)
E_KEEP = 100                    # job E's CountEvictor.of(100)
E2_EVERY = 1000                 # job E2's CountTrigger.of(1000)
Q5_SIDE_BATCHES = 4             # the numpy-lane, hot-key and profiled runs
MESH_BLOCKS = 4                 # the mesh phase's device blocks, on cuda:0
MESH_SIDE_BATCHES = 4           # jobs M2, M3, M4 and the profiled M1 run
MESH_XCAP = 16_384              # job M3's pipeline.exchange-capacity
# the kernels the key-sharded path adds; their per-call device time comes
# from the mesh phase's profiled run only
MESH_KERNELS = ("bucket_records", "topn_candidates", "topn_select_given")
# wrapper -> its CUDA kernels' names, to read the profiler's table
PROFILED_KERNELS = {
    # host-combined pairs (a thread an entry), per record (a block's chunk
    # in a shared histogram)
    "scatter_counts": ("scatter_counts_kernel", "count_records_kernel"),
    "scatter_split_counts": ("split_counts_kernel",),
    "window_counts": ("window_counts_kernel",),
    # the top-1 max, or the top-n radix select (one cooperative launch, or
    # a launch a pass), then the selection; the fused step launches them too
    "topn_select_append": ("topn_max_kernel", "topn_radix_all_kernel",
                           "topn_radix_kernel", "topn_select_kernel"),
    "ring_columns": ("ring_columns_kernel",),
    "nexmark_bids": ("nexmark_bids_kernel",),
    # devgen_ingest_kernel<true> (the Nexmark form, the bids made in
    # registers: the devgen path) or <false> (records from memory)
    "devgen_ingest": ("devgen_ingest_kernel",),
    "fire_pack": ("fire_pack_kernel",),
    "scatter_lanes": ("lanes_hist_kernel", "lanes_sort_kernel",
                      "lanes_fold_kernel"),
    "scatter_pair_lanes": ("pair_lanes_kernel", "pair_lanes_any_kernel"),
    # the plain forms; the fused step's header forms (<true>) are its own
    "apply_pairs_u32": ("apply_pairs_u32_kernel<false>",),
    "apply_pairs_u16": ("apply_pairs_u16_kernel<false>",),
    "split_cells": ("split_cells_kernel",),
    "count_fire": ("count_fire_kernel",),
    # the register form (rings up to 64 columns) or the staged-tile form
    "window_lanes": ("window_lanes_reg_kernel", "window_lanes_kernel"),
    # the top-1 max, or the top-n radix select (one cooperative launch, or
    # a launch a pass), then the selection
    "topn_select_lanes": ("lanes_max_kernel", "lanes_radix_all_kernel",
                          "lanes_radix_kernel", "lanes_select_kernel"),
    "segment_lanes": ("segment_lanes_kernel",),
    "bucket_records": ("bucket_records_kernel",),
    "hash_keys": ("hash_keys_kernel",),
    # the top-1 max (its last block writes the output), or the radix
    # select with the collect and sort (one cooperative launch, or six)
    "topn_candidates": ("cand_max_kernel", "cand_radix_all_kernel",
                        "cand_radix_kernel", "cand_collect_kernel",
                        "cand_sort_kernel"),
    "topn_global_threshold": ("topn_global_threshold_kernel",),
    "topn_select_given": ("topn_given_kernel",),
}
# kernels that no path may launch (each held to its plain version in the
# kernels phase): hash_keys no path of either package (the reference's
# tests only), nexmark_bids none since the devgen path's ingest makes its
# bids itself, topn_global_threshold none since the sharded top-n's
# select works out the global k-th itself, split_cells none since
# scatter_lanes, scatter_split_counts and bucket_records decode the split
# upload where they read it (it stays for a shuffle registered through
# the exchange SPI, which takes flat cells)
UNLAUNCHED = ("hash_keys", "nexmark_bids", "topn_global_threshold",
              "split_cells")
# the wrappers whose device kernels a call the profiled runs count against
# their launch counts (no other wrapper launches their kernels;
# topn_select_append shares its with the fused step, so the devgen profile,
# where no fused step runs, counts it by itself)
ONE_CALL_WRAPPERS = ("fire_pack", "topn_select_lanes", "topn_select_given",
                     "bucket_records", "topn_candidates", "count_fire")
# wrappers whose kernels are shared with other wrappers (the fused step's
# chain reuses window_counts, top-n and ring_columns): the profiled runs
# wrap each call in a profiler range and charge it only the device
# kernels launched inside that range
RANGED_WRAPPERS = ("fused_step",)
# the CUDA kernels of which one wrapper call launches exactly one: the
# profile's count of wrapper calls (scatter_lanes runs its sort kernel
# once a digit pass)
CALL_KERNELS = {
    "topn_select_append": ("topn_select_kernel", "topn_radix_all_kernel"),
    "ring_columns": ("ring_columns_kernel",),
    "fire_pack": ("fire_pack_kernel",),
    "scatter_lanes": ("lanes_hist_kernel",),
    # the header form of the apply, words or triples: its block 0
    # decodes the header
    "fused_step": ("apply_pairs_u32_kernel<true>",
                   "apply_pairs_u16_kernel<true>"),
    "count_fire": ("count_fire_kernel",),
    "topn_select_lanes": ("lanes_select_kernel", "lanes_radix_all_kernel"),
    "bucket_records": ("bucket_records_kernel",),
    "topn_candidates": ("cand_max_kernel", "cand_radix_all_kernel",
                        "cand_sort_kernel"),
    "topn_select_given": ("topn_given_kernel",),
}


# (phase, the time its line was printed): the default run prints each
# phase's seconds from them (its budget)
PHASE_ENDS = [("start", time.perf_counter())]
# every line printed, and the kernels' per-path detail, one JSON object
# a line, for a reader that keeps only the tail of the output
PHASES_FILE = os.path.join(ROOT, "chiprun_out", "chip_smoke_phases.jsonl")
# the keys of a kernel's entry in the printed kernels line; the rest of
# its row (launches by path, device ms by path, the hybrid path's X1)
# goes to PHASES_FILE
KERNEL_LINE_KEYS = ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "launches_path", "pipeline_device_ms")


def record_line(obj) -> None:
    os.makedirs(os.path.dirname(PHASES_FILE), exist_ok=True)
    with open(PHASES_FILE, "a") as f:
        f.write(json.dumps(obj) + "\n")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    record_line(obj)
    if "phase" in obj:
        PHASE_ENDS.append((obj["phase"], time.perf_counter()))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from flink_tpu_torch import native_codec
    from flink_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    t1 = time.perf_counter()
    out["host_codec"] = {"library": os.path.relpath(native_codec.build(), ROOT),
                         "seconds": time.perf_counter() - t1}
    for name in KERNEL_SOURCES:
        log = build.BUILD_LOG[name]
        out[name] = {
            "cmd": " ".join(log["cmd"] or []), "cached": log["cached"],
            "seconds": log["seconds"],
            "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit(out)


def q5_kernel_state(torch, np, dev):
    """The ``kernels`` phase's Q5 state: 128 x 256 key slots + 1 dump
    row, a 32-column ring with 21 live panes, 10,000 keys at Poisson 9.5
    a pane (the first 100 of them 26x), one batch's host-combined pairs
    (every key x its 11 newest panes) and 11 window ends of 10 panes."""
    rng = np.random.default_rng(SEED)
    slots, ring, ppw, W, n_keys = 128 * 256, 32, 10, 11, 10_000
    rows = slots + 1
    pane_lo, pane_hi = 1000, 1020            # 21 live panes of the 32
    used_np = np.zeros(rows, bool)
    key_rows = rng.choice(slots, n_keys, replace=False)
    used_np[key_rows] = True
    counts_np = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts_np[key_rows, p % ring] = rng.poisson(9.5, n_keys)
    counts_np[key_rows[:100], :] *= 26       # the hot auctions
    batch_panes = np.arange(pane_hi - 10, pane_hi + 1)
    pairs = (key_rows[:, None] * ring + batch_panes[None, :] % ring).reshape(-1)
    idx_np = rng.permutation(pairs).astype(np.int32)
    cnt_np = (rng.poisson(9.5, len(idx_np)) + 1).astype(np.int32)
    return {"slots": slots, "ring": ring, "ppw": ppw, "W": W,
            "pane_lo": pane_lo, "pane_hi": pane_hi,
            "counts": torch.from_numpy(counts_np).to(dev),
            "idx": torch.from_numpy(idx_np).to(dev),
            "cnt": torch.from_numpy(cnt_np).to(dev),
            "used": torch.from_numpy(used_np).to(dev),
            "ends": torch.arange(pane_hi - W + 2, pane_hi + 2,
                                 dtype=torch.int64, device=dev),
            "w_valid": torch.ones(W, dtype=torch.bool, device=dev)}


def phase_kernels(torch, np):
    """Each kernel against its plain version at the Q5 shapes."""
    from flink_tpu_torch.kernels import window_kernels as wk

    dev = torch.device("cuda")
    q = q5_kernel_state(torch, np, dev)
    slots, ring, ppw, W = q["slots"], q["ring"], q["ppw"], q["W"]
    rows, pane_lo, pane_hi = slots + 1, q["pane_lo"], q["pane_hi"]
    counts, idx, cnt, used = q["counts"], q["idx"], q["cnt"], q["used"]
    ends, w_valid = q["ends"], q["w_valid"]
    emit_ring = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    n_top, sel_cap, anchor = 1, 256, pane_lo
    out = []

    def record(name, replaces, err, ms, plain, lib, nbytes, nops,
               source="window_kernels.cu"):
        b, by = bound_ms(nbytes, nops)
        out.append({"name": name, "route": "cuda",
                    "source": "flink_tpu_torch/kernels/csrc/" + source,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": lib})

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    # K1: scatter_counts
    a, b = counts.clone(), counts.clone()
    wk.scatter_counts(a, idx, cnt)
    wk.scatter_counts_plain(b, idx, cnt)
    torch.cuda.synchronize()
    err = max_err(a, b)
    check(err == 0, f"scatter_counts differs from its plain version by {err}")
    idx_long = idx.long()
    scratch = counts.clone()
    n = idx.numel()
    record("scatter_counts", "flink_tpu/ops/window.py:190", err,
           time_ms(torch, lambda: wk.scatter_counts(scratch, idx, cnt)),
           time_ms(torch, lambda: wk.scatter_counts_plain(scratch, idx, cnt)),
           time_ms(torch, lambda: scratch.view(-1).index_add_(0, idx_long, cnt)),
           16 * n, n)

    # K2: window_counts
    wc = wk.window_counts(a, ends, w_valid, pane_lo, pane_hi, ppw)
    wc_plain = wk.window_counts_plain(a, ends, w_valid, pane_lo, pane_hi, ppw)
    torch.cuda.synchronize()
    err = max_err(wc, wc_plain)
    check(err == 0, f"window_counts differs from its plain version by {err}")
    # the bound reads only the ring columns some window sums: the union
    # of the windows' live panes, each column once per row
    hi_cap = min(pane_hi, pane_lo + ring - 1)
    spans = [range(max(e - ppw, pane_lo), min(e - 1, hi_cap) + 1)
             for e, ok in zip(ends.tolist(), w_valid.tolist()) if ok]
    live = sum(len(sp) for sp in spans)
    live_cols = len({p % ring for sp in spans for p in sp})
    # the library yardstick: one f32 matmul of the counts by the (ring, W)
    # column mask, TF32 off; exact while every window count is below 2^24
    colmask = torch.zeros((ring, W), dtype=torch.float32, device=dev)
    for w, sp in enumerate(spans):
        colmask[[p % ring for p in sp], w] = 1.0
    check(int(wc.max()) < 2 ** 24, "window counts beyond f32's exact range")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a_f = a.float()
        mm = a_f @ colmask
        torch.cuda.synchronize()
        check(torch.equal(mm.to(torch.int32), wc),
              "the matmul yardstick differs from window_counts")
        lib_ms = time_ms(torch, lambda: a_f @ colmask)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # timed as the operator's fire calls it: into its reused buffer
    wc_out = torch.empty_like(wc)
    record("window_counts", "flink_tpu/ops/window.py:286", err,
           time_ms(torch, lambda: wk.window_counts(a, ends, w_valid, pane_lo,
                                                   pane_hi, ppw, wc_out)),
           time_ms(torch, lambda: wk.window_counts_plain(a, ends, w_valid,
                                                         pane_lo, pane_hi, ppw)),
           lib_ms, rows * live_cols * 4 + rows * W * 4 + W * 9, rows * live)
    out[-1]["library_call"] = "counts.float() @ colmask (TF32 off)"
    out[-1]["call"] = "into a reused (rows, W) buffer, as the operator's fire"

    # K3: topn_select_append
    r1, r2 = emit_ring.clone(), emit_ring.clone()
    wk.topn_select_append(wc, used, ends, w_valid, anchor, n_top, sel_cap, r1)
    wk.topn_select_append_plain(wc, used, ends, w_valid, anchor, n_top,
                                sel_cap, r2)
    torch.cuda.synchronize()
    err = max_err(r1[:-1], r2[:-1])
    check(err == 0, f"topn_select_append differs from its plain version by {err}")
    written = int(r1[0, 0])
    check(written >= W and int(r1[0, 1]) == 0, f"ring head {r1[0].tolist()}")
    r3, r4 = emit_ring.clone(), emit_ring.clone()
    wct = wc.T.contiguous()
    record("topn_select_append", "flink_tpu/ops/window.py:547", err,
           time_ms(torch, lambda: wk.topn_select_append(
               wc, used, ends, w_valid, anchor, n_top, sel_cap, r3)),
           time_ms(torch, lambda: wk.topn_select_append_plain(
               wc, used, ends, w_valid, anchor, n_top, sel_cap, r4)),
           time_ms(torch, lambda: torch.topk(wct, n_top, dim=1)),
           rows * W * 4 + rows + W * 9 + written * 12 + 8,
           rows * W * (2 * n_top + 2))
    out[-1]["library_call"] = "torch.topk(wcounts.T, n), the threshold only"

    # K4: ring_columns — the per-advance purge (11 dead columns), and a
    # ring growth 16 -> 32 checked for equality
    keep_np = np.ones(ring, bool)
    keep_np[np.arange(pane_lo - 11, pane_lo) % ring] = False
    keep = torch.from_numpy(keep_np).to(dev)
    ident = torch.arange(ring, dtype=torch.int32, device=dev)
    x, y = a.clone(), a.clone()
    wk.ring_columns(x, x, ident, keep)
    wk.ring_columns_plain(y, y, ident, keep)
    small = a[:, :16].contiguous()
    cmap = np.full(32, -1, np.int64)
    ps = np.arange(1003, 1003 + 14)
    cmap[ps % 32] = ps % 16
    src_col = torch.from_numpy(np.maximum(cmap, 0).astype(np.int32)).to(dev)
    keep_g = torch.from_numpy(cmap >= 0).to(dev)
    g1 = torch.empty((rows, 32), dtype=torch.int32, device=dev)
    g2 = torch.empty_like(g1)
    wk.ring_columns(small, g1, src_col, keep_g)
    wk.ring_columns_plain(small, g2, src_col, keep_g)
    torch.cuda.synchronize()
    err = max(max_err(x, y), max_err(g1, g2))
    check(err == 0, f"ring_columns differs from its plain version by {err}")
    cleared = torch.from_numpy(np.flatnonzero(~keep_np)).to(dev)
    n_cleared = int((~keep_np).sum())
    record("ring_columns", "flink_tpu/ops/window.py:825", err,
           time_ms(torch, lambda: wk.ring_columns(x, x, ident, keep)),
           time_ms(torch, lambda: wk.ring_columns_plain(y, y, ident, keep)),
           time_ms(torch, lambda: y.index_fill_(1, cleared, 0)),
           rows * n_cleared * 4 + ring * 5, 0)
    wk.check_errors(dev)
    extra = devgen_kernel_cases(torch, np, dev, record)
    wk.check_errors(dev)
    extra.update(lane_kernel_cases(torch, np, dev, record, out))
    wk.check_errors(dev)
    extra.update(fused_kernel_cases(torch, np, dev, record))
    wk.check_errors(dev)
    extra.update(count_window_kernel_cases(torch, np, dev, record, out))
    wk.check_errors(dev)
    extra.update(topn_lanes_kernel_cases(torch, np, dev, record, out))
    wk.check_errors(dev)
    extra.update(element_kernel_cases(torch, np, dev, record, out))
    wk.check_errors(dev)
    extra.update(mesh_kernel_cases(torch, np, dev, record, out, wc, used,
                                   ends))
    wk.check_errors(dev)
    # K4 and L3 beside their library calls as loop ms, device ms and host
    # µs a call: the block-wide purge and growth, L3 on both row orders
    split = ring_pair_cases(torch, np, dev)
    row = next(r for r in out if r["name"] == "ring_columns")
    row["split"] = {k: v for k, v in split.items()
                    if k.startswith("ring_columns")}
    row = next(r for r in out if r["name"] == "scatter_pair_lanes")
    row["split"] = {k: v for k, v in split.items()
                    if k.startswith("scatter_pair_lanes")}
    emit({"phase": "kernels", **extra, "kernels": [
        {k: v for k, v in r.items() if k != "launches"} for r in out]})
    return out


def devgen_kernel_cases(torch, np, dev, record):
    """K5 and K6 at the headline shapes: sub-batch 1 of logical batch 5
    (2^20 bids of a 2^22 batch, 100 bids/ms, 10,000 auctions, hot ratio
    4) into 32,769 x 64 state."""
    from flink_tpu_torch.kernels import devgen_kernels as dk

    n, total, epm, hot_ratio, n_auctions = 1 << 20, 1 << 22, 100, 4, 10_000
    n_hot = n_auctions // 100
    rows, ring, key_domain = 128 * 256 + 1, 64, n_auctions
    args = (5, n, n, total, epm, hot_ratio, n_hot, n_auctions)

    # K5: nexmark_bids
    keys, ts = dk.nexmark_bids(*args, dev)
    pk, pt = dk.nexmark_bids_plain(*args, dev)
    torch.cuda.synchronize()
    err = max(int((keys - pk).abs().max()), int((ts - pt).abs().max()))
    check(err == 0, f"nexmark_bids differs from its plain version by {err}")
    record("nexmark_bids", "flink_tpu/nexmark/generator.py:125", err,
           time_ms(torch, lambda: dk.nexmark_bids(*args, dev)),
           time_ms(torch, lambda: dk.nexmark_bids_plain(*args, dev)),
           None, 16 * n, 22 * n, source="devgen_kernels.cu")

    # K6: devgen_ingest, steady state (every key in the domain, nothing
    # late, no re-fire) with and without the stats vector (the headline
    # path runs without), then a case with out-of-domain and late records
    pane_lo = int(ts.min()) // 1000
    kw = dict(key_domain=key_domain, pane_ms=1000, offset_ms=0,
              dead_below=pane_lo - 1, refire_below=-(2 ** 63),
              dump_row=rows - 1)

    def ingest_pair(k, t, kw, with_stats=True):
        a = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
        b = a.clone()
        sa = dk.devgen_ingest(a, k, t, with_stats=with_stats, **kw)
        sb = dk.devgen_ingest_plain(b, k, t, kw["key_domain"], kw["pane_ms"],
                                    kw["offset_ms"], kw["dead_below"],
                                    kw["refire_below"], kw["dump_row"],
                                    torch.zeros_like(sa) if with_stats
                                    else None)
        torch.cuda.synchronize()
        err = int((a - b).abs().max())
        if with_stats:
            err = max(err, int((sa - sb).abs().max()))
        return err, a, sa

    err, state, stats = ingest_pair(keys, ts, kw)
    check(err == 0, f"devgen_ingest differs from its plain version by {err}")
    check(int(stats[0]) == n and int(state.sum()) == n,
          f"devgen_ingest stats {stats[:8].tolist()}")
    err0, state0, _ = ingest_pair(keys, ts, kw, with_stats=False)
    check(err0 == 0 and torch.equal(state0, state),
          f"devgen_ingest without stats differs by {err0}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    odd = keys.clone()
    pick = torch.rand(n, generator=gen, device=dev)
    odd[pick < 0.03] += key_domain             # out of the domain
    odd[pick > 0.99] = -7                      # negative keys
    kw_late = dict(kw, dead_below=pane_lo + 3, refire_below=pane_lo + 6)
    err2, _, stats2 = ingest_pair(odd, ts, kw_late)
    check(err2 == 0, "devgen_ingest (out-of-domain and late records) "
          f"differs from its plain version by {err2}")
    head = stats2[:8].tolist()
    check(head[1] > 0 and head[2] > 0 and head[4] > 0
          and int(stats2[8:].sum()) > 0, f"edge case stats {head}")
    # the Nexmark form (the devgen path's: the bids made in registers),
    # steady and with late and re-fire records, against nexmark_bids_plain
    # then devgen_ingest_plain
    for kw_n, with_stats in ((kw, False), (kw, True), (kw_late, True)):
        a = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
        b = a.clone()
        sa = dk.devgen_ingest_nexmark(a, args, with_stats=with_stats, **kw_n)
        sb = dk.devgen_ingest_nexmark_plain(
            b, args, kw_n["key_domain"], kw_n["pane_ms"], kw_n["offset_ms"],
            kw_n["dead_below"], kw_n["refire_below"], kw_n["dump_row"],
            torch.zeros_like(sa) if with_stats else None)
        torch.cuda.synchronize()
        err3 = int((a - b).abs().max())
        if with_stats:
            err3 = max(err3, int((sa - sb).abs().max()))
        check(err3 == 0 and (kw_n is kw_late or torch.equal(a, state)),
              f"devgen_ingest's Nexmark form (stats {with_stats}, late "
              f"{kw_n is kw_late}) differs from its plain version by {err3}")
        if kw_n is kw_late:
            check(int(sa[1]) > 0 and int(sa[4]) > 0,
                  f"Nexmark form edge case stats {sa[:8].tolist()}")
    # the cells the steady batch adds into (every record valid here)
    flat = torch.where(keys < key_domain, keys * ring + torch.remainder(
        torch.div(ts, 1000, rounding_mode="floor"), ring), kw["dump_row"] * ring)
    n_cells = int(torch.unique(flat).numel())
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
    plain_scratch = scratch.clone()
    # timed in the headline path's form: the Nexmark form without the
    # stats vector. The bound reads and writes each distinct cell once
    # (the ~1e5 cells' atomics meet in L2, where the whole 8.4 MB state
    # fits) and counts the generator's and the ingest's integer work; the
    # plain version is nexmark_bids_plain then devgen_ingest_plain
    record("devgen_ingest", "flink_tpu/ops/window.py:712",
           max(err, err0, err2, err3),
           time_ms(torch, lambda: dk.devgen_ingest_nexmark(
               scratch, args, with_stats=False, **kw)),
           time_ms(torch, lambda: dk.devgen_ingest_nexmark_plain(
               plain_scratch, args, kw["key_domain"], kw["pane_ms"],
               kw["offset_ms"], kw["dead_below"], kw["refire_below"],
               kw["dump_row"], None)),
           time_ms(torch, lambda: scratch.view(-1).index_add_(0, flat, ones)),
           8 * n_cells, 37 * n, source="devgen_kernels.cu")
    return {"devgen_ingest_distinct_cells": n_cells}


def same_bits(torch, a, b) -> bool:
    """Equal tensors, NaN-aware, signed zeros distinct."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
            a[~nan].view(torch.int32), b[~nan].view(torch.int32)))
    return bool(torch.equal(a, b))


def lane_state(np, rng, rows, ring, pane_lo, pane_hi, keys, widths, hot=0):
    """Pane state at a main-path shape: ``keys`` registered rows with
    Poisson counts (the first ``hot`` of them 26x) and positive lanes in
    the live panes' columns, identities elsewhere."""
    sw, mw, nw = widths
    counts = np.zeros((rows, ring), np.int32)
    sums = np.zeros((rows, ring, sw), np.float32)
    maxs = np.full((rows, ring, mw), -np.inf, np.float32)
    mins = np.full((rows, ring, nw), np.inf, np.float32)
    for p in range(pane_lo, pane_hi + 1):
        c = p % ring
        counts[keys, c] = rng.poisson(9.5, len(keys))
        counts[keys[:hot], c] *= 26
        v = (rng.random((len(keys), max(sw, mw, nw, 1))) * 900 + 50
             ).astype(np.float32)
        sums[keys, c] = v[:, :sw] * counts[keys, c][:, None]
        maxs[keys, c] = v[:, :mw] * 3
        mins[keys, c] = v[:, :nw] / 3
    return counts, sums, maxs, mins


def colmask_matmul_fn(torch, lk, lane, ends, ring, pane_lo, pane_hi, ppw):
    """One f32 ``(rows, ring) @ (ring, W)`` column-mask matmul, the
    reference's form of a fire's window sums, as a call (time it under
    ``tf32_off``)."""
    colmask = lk._live_columns(ends, ring, pane_lo, pane_hi, ppw).T.float()
    return lambda: lane @ colmask


def tf32_off(torch, fn):
    """``fn()`` with TF32 matmuls off, as the reference's f32 product."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def fire_pack_cases(torch, np, dev):
    """The ``kernels`` phase's three ``fire_pack`` inputs, each with its
    library call and its bound's byte and operation counts as a function
    of the rows it fires: WordCount's form (65,537 x 16 count lane after
    its first growth, packed2, 4 windows of 1 pane, ~28k words a window,
    cap 2^17), the bid-aggregate job (a)'s (32,769 x 32, count + sum +
    max + min, 4 windows of 10 panes, cap 2^16) and job (b)'s (one sum
    lane). Also the bid-aggregate state, for the kernels that follow."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(SEED + 3)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # WordCount: count only, packed2, 4 windows of 1 pane; ~28k words fire
    # per window
    rows, ring, W, ppw, cap = 65_537, 16, 4, 1, 1 << 17
    pane_lo, pane_hi = 7, 17
    keys = rng.choice(rows - 1, 30_000, replace=False)
    counts, _, _, _ = lane_state(np, rng, rows, ring, pane_lo, pane_hi, keys,
                                 (0, 0, 0))
    counts[keys, :] *= rng.random((len(keys), 1)) < 0.94   # ~28k fire
    used_np = np.zeros(rows, bool)
    used_np[keys] = True
    c_t = t(counts)
    ends = torch.arange(pane_lo + 1, pane_lo + 1 + W, dtype=torch.int64,
                        device=dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    cases = [{
        "name": "wordcount",
        "args": (c_t, None, None, None, ends, valid, t(used_np), pane_lo,
                 pane_hi, ppw, cap, True),
        # the lane (here the count lane, as f32) times the (ring, W)
        # column mask in one matmul
        "library": colmask_matmul_fn(torch, lk, c_t.float(), ends, ring,
                                     pane_lo, pane_hi, ppw),
        "library_call": ("counts.float() @ colmask (TF32 off): the "
                         "WordCount form's one lane"),
        # reads: the count lane's live columns once, the used mask; writes
        # the head and n 2-column rows
        "bytes_ops": lambda n, rows=rows, W=W, ppw=ppw: (
            rows * W * 4 + rows + W * 9 + (n + 1) * 8, rows * W * (ppw + 2))}]

    # the bid-aggregate state: count + sum + max + min lanes, 4 windows of
    # 10 panes
    rows, ring, ppw = 32_769, 32, 10
    pane_lo, pane_hi = 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    st = lane_state(np, rng, rows, ring, pane_lo, pane_hi, keys, (1, 1, 1),
                    hot=100)
    used_np = np.zeros(rows, bool)
    used_np[keys] = True
    lanes = [t(x) for x in st]
    ends = torch.arange(pane_hi - 2, pane_hi + 2, dtype=torch.int64,
                        device=dev)
    cap = 1 << 16
    spans = [range(max(e - ppw, pane_lo), min(e - 1, pane_hi) + 1)
             for e in ends.tolist()]
    live = sum(len(sp) for sp in spans)
    live_cols = len({p % ring for sp in spans for p in sp})
    sum_lib = colmask_matmul_fn(torch, lk, lanes[1][:, :, 0].contiguous(),
                                ends, ring, pane_lo, pane_hi, ppw)
    nk = len(keys)
    cases.append({
        "name": "bid_aggs_a",
        "args": (*lanes, ends, valid, t(used_np), pane_lo, pane_hi, ppw,
                 cap, False),
        "library": sum_lib, "live_panes": live,
        "library_call": "sums @ colmask (TF32 off), the sum lane",
        # reads: the count lane's live columns and the used mask once;
        # each firing row's sum lane whole (every column times its mask
        # bit) and its max/min lanes' live columns; writes the head, n
        # rows of 3 and n rows of lanes
        "bytes_ops": lambda n: (
            rows * live_cols * 4 + rows + nk * (ring + 2 * live_cols) * 4
            + (n + 1) * 12 + n * 12,
            rows * live + n * (ring + 2 * live // W))})
    cases.append({
        "name": "bid_aggs_b",
        "args": (lanes[0], lanes[1], None, None, ends, valid, t(used_np),
                 pane_lo, pane_hi, ppw, cap, False),
        "library": sum_lib, "live_panes": live,
        "library_call": "sums @ colmask (TF32 off), the sum lane",
        "bytes_ops": lambda n: (
            rows * live_cols * 4 + rows + nk * ring * 4 + (n + 1) * 12
            + n * 4, rows * live + n * ring)})
    return {"cases": cases, "state": st, "rows": rows, "ring": ring,
            "pane_lo": pane_lo, "pane_hi": pane_hi}


def scatter_lanes_batch(np, ring):
    """One 2^20-bid batch of the bid-aggregate job (a): 10,000 auctions,
    hot ratio 4, 100 bids/ms, keyed into 128 x 256 slots; its flat cells
    ``slot * ring + pane % ring``."""
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_batch
    from flink_tpu_torch.state.keyed import KeyDirectory

    cfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=1, events_per_ms=100,
                        num_active_auctions=10_000, hot_ratio=4)
    data, ts = bid_batch(cfg, 0, 5)
    slots = KeyDirectory(128, 256).assign(data["auction"])
    idx_np = (slots * ring + (ts // 1000) % ring).astype(np.int32)
    return data, ts, slots, idx_np


def split_bytes(np, cells, ring):
    """The split upload's (B, 3) bytes of flat int32 cells ``slot * ring +
    col`` (-1, an invalid record: slot 0xFFFF), as the operator encodes
    them."""
    from flink_tpu_torch.ops.window import split_encode

    ok = cells >= 0
    return split_encode(np.where(ok, cells // ring, 0),
                        np.where(ok, cells % ring, 0).astype(np.uint8), ok)


def kernel_stages(torch, fn, calls: int = 10):
    """``torch.profiler`` over ``calls`` calls of ``fn`` (after one
    warm-up): each device entry's time and count per call, by name (a
    kernel's name without its namespace and arguments; memsets and
    copies as the profiler names them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    stages = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        if name.startswith("void "):
            name = name[5:]
        depth = 0
        for i, ch in enumerate(name):
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0 and i > 0:
                name = name[:i]
                break
        row = stages.setdefault(name, {"ms_per_call": 0.0, "per_call": 0.0})
        row["ms_per_call"] += us / 1e3 / calls
        row["per_call"] += e.count / calls
    return stages


def scatter_lanes_cases(torch, np, dev, st, idx_np, price_np):
    """``scatter_lanes`` on the bid-aggregate state ``st`` (32,769 x 32 x
    one sum, max and min lane) with the batch's cells ``idx_np`` and
    prices as every lane: the uniform case (the batch as it is: ~110k
    distinct cells, the hottest ~250 records) and the hot-cell case (2^18
    of its records, at seeded positions, moved into one cell). Each: two
    kernel runs bit-equal; counts, max and min equal to the plain version
    on the card; every lane bit-equal to the plain version on the CPU
    (record order); sums against the plain version on the card within
    the bound of another order (its index_add_ adds in no fixed order
    there). Then the times: the kernel, the plain version, ``index_add_``
    on the sum lane, ``scatter_reduce_`` amax on the max lane and a
    stable ``torch.sort`` of the cells (a yardstick for the sort stage
    alone; the port never calls it), and the kernels of one call by name
    from ``torch.profiler``."""
    from flink_tpu_torch.kernels import lane_kernels as lk

    rng = np.random.default_rng(SEED + 9)
    hot_idx = idx_np.copy()
    hot_idx[rng.choice(len(idx_np), 1 << 18, replace=False)] = idx_np[0]
    out = {}
    for case, cells_np in (("uniform", idx_np), ("hot_cell", hot_idx)):
        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        idx = t(cells_np)
        n = idx.numel()
        price = t(price_np)[:, None].contiguous()
        state = [t(x) for x in st]
        runs = []
        for fn in (lk.scatter_lanes, lk.scatter_lanes, lk.scatter_lanes_plain):
            s_ = [x.clone() for x in state]
            fn(*s_, idx, price, price, price)
            runs.append(s_)
        torch.cuda.synchronize()
        check(all(same_bits(torch, x, y) for x, y in zip(runs[0], runs[1])),
              f"scatter_lanes ({case}): two runs differ")
        check(all(same_bits(torch, runs[0][k], runs[2][k]) for k in (0, 2, 3)),
              f"scatter_lanes ({case}): counts or max/min differ from the "
              "plain version")
        cpu_state = [torch.from_numpy(x.copy()) for x in st]
        price_cpu = torch.from_numpy(price_np[:, None].copy())
        lk.scatter_lanes_plain(*cpu_state, torch.from_numpy(cells_np),
                               price_cpu, price_cpu, price_cpu)
        check(all(same_bits(torch, x, y) for x, y in zip(runs[0], cpu_state)),
              f"scatter_lanes ({case}) differs from the plain version's "
              "record order (the plain version on the CPU)")
        n_cell = torch.zeros(runs[0][0].numel(), dtype=torch.float64,
                             device=dev)
        n_cell.index_add_(0, idx.long(), torch.ones(n, dtype=torch.float64,
                                                    device=dev))
        got = runs[0][1].reshape(-1).double()
        want = runs[2][1].reshape(-1).double()
        err = float((got - want).abs().max())
        check(bool(((got - want).abs()
                    <= 2 * (n_cell + 1) * 2.0 ** -24 * want.abs()).all()),
              f"scatter_lanes ({case}) sums differ from the plain version "
              f"by {err}")
        cells = int(torch.unique(idx).numel())
        scratch = [x.clone() for x in state]
        plain_scratch = [x.clone() for x in state]
        sum_flat = scratch[1].view(-1, 1)
        max_flat = scratch[2].view(-1)
        idx_long = idx.long()
        p1 = price.view(-1)
        # reads: idx and the three lanes once; each touched cell's count
        # and lanes read and written once
        nbytes, nops = n * (4 + 12) + cells * 16 * 2, n * 4
        b, by = bound_ms(nbytes, nops)
        out[case] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: lk.scatter_lanes(
                *scratch, idx, price, price, price)),
            "plain_ms": time_ms(torch, lambda: lk.scatter_lanes_plain(
                *plain_scratch, idx, price, price, price), iters=10),
            "library_ms": time_ms(torch, lambda: sum_flat.index_add_(
                0, idx_long, price)),
            "library_call": "index_add_ (the sum lane)",
            "library_amax_ms": time_ms(torch, lambda: max_flat.scatter_reduce_(
                0, idx_long, p1, "amax")),
            "library_sort_ms": time_ms(torch, lambda: torch.sort(
                idx, stable=True)),
            "bound_ms": b, "bound_by": by, "bytes": nbytes, "ops": nops,
            "records": n, "distinct_cells": cells,
            "largest_cell": int(torch.bincount(idx_long).max()),
            "stages": kernel_stages(torch, lambda: lk.scatter_lanes(
                *scratch, idx, price, price, price))}
        stages = out[case]["stages"]
        out[case]["device_ms_per_call"] = sum(v["ms_per_call"]
                                              for v in stages.values())
        out[case]["device_ops_per_call"] = sum(v["per_call"]
                                               for v in stages.values())
    return out


def phase_scatter_lanes(torch, np):
    """``--scatter-lanes``: build ``lane_kernels`` alone and run
    ``scatter_lanes_cases`` at the bid-aggregate shape: the quick check
    and stage profile of that one kernel."""
    from flink_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(("lane_kernels",))
    log = build.BUILD_LOG["lane_kernels"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    rows, ring, pane_lo, pane_hi = 32_769, 32, 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    st = lane_state(np, rng, rows, ring, pane_lo, pane_hi, keys, (1, 1, 1),
                    hot=100)
    data, _, _, idx_np = scatter_lanes_batch(np, ring)
    emit({"phase": "scatter_lanes", "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln],
          **scatter_lanes_cases(torch, np, dev, st, idx_np, data["price"]),
          "card": card_line()})


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host µs a call: the host clock around ``calls`` calls with no
    synchronise between them (the enqueue cost, while the card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def split_times(torch, fn) -> dict:
    """A call's loop ms (CUDA events around 50 back-to-back calls),
    device ms (``torch.profiler`` over 10 calls: the device entries a
    call, by name) and host µs a call."""
    stages = kernel_stages(torch, fn)
    return {"loop_ms": time_ms(torch, fn),
            "device_ms": sum(v["ms_per_call"] for v in stages.values()),
            "device_ops": sum(v["per_call"] for v in stages.values()),
            "host_us": host_us(torch, fn), "stages": stages}


# the identity fills of a state block's lanes, in PaneState order
BLOCK_FILLS = (0.0, -float("inf"), float("inf"), 0)


def ring_block_fn(wk, src, dst, src_col, keep):
    """One purge or growth of every lane of a state block: the block
    entry where the tree has one, else one ``ring_columns`` call a lane
    (the parent's form)."""
    if hasattr(wk, "ring_columns_block"):
        return lambda: wk.ring_columns_block(src, dst, src_col, keep)
    return lambda: [wk.ring_columns(s, d, src_col, keep, f)
                    for s, d, f in zip(src, dst, BLOCK_FILLS)]


def pair_rows(np, slots, ts, price, ring, order):
    """Job (b)'s host-combined upload of one batch: ``[pair, count, f32
    sum]`` rows ascending (the numpy lane's ``np.unique``) or in the
    order each pair is first seen (the C combine's)."""
    from flink_tpu_torch.ops.window import preagg_combine, preagg_encode_i32

    cols = (ts // 1000) % ring
    pairs, cnts, lanes = preagg_combine(slots, cols, np.ones(len(ts), bool),
                                        ring, {"price": price}, ("price",))
    buf = preagg_encode_i32(pairs, cnts, lanes)
    if order == "first_seen":
        pk = (slots * ring + cols).astype(np.int32)
        _, first = np.unique(pk, return_index=True)
        buf = buf[np.argsort(first, kind="stable")]
    return np.ascontiguousarray(buf)


def ring_pair_cases(torch, np, dev):
    """``scatter_pair_lanes`` and ``ring_columns`` beside their library
    calls at the ``kernels`` phase's shapes, each as loop ms, device ms
    and host µs a call (``split_times``): L3 on one bid-aggregate batch's
    ~110k host-combined pairs in both row orders against ``index_add_``
    on the sum lane; K4's count-lane purge (32,769 x 32, 11 columns
    cleared in a run that wraps) against ``index_fill_``; the purge of a
    four-lane state block (count, sum, max, min) against four
    ``index_fill_`` calls; the count-lane growth 6 -> 16 at 65,537 rows
    and a four-lane growth 32 -> 64. Each result is first held bit for
    bit against the plain version, with NaN payloads, -NaN and -0.0 in
    kept cells of the f32 lanes."""
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import window_kernels as wk

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng = np.random.default_rng(SEED + 3)
    rows, ring, pane_lo, pane_hi = 32_769, 32, 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    st = lane_state(np, rng, rows, ring, pane_lo, pane_hi, keys, (1, 1, 1),
                    hot=100)
    data, ts, slots, _ = scatter_lanes_batch(np, ring)
    out = {"kernel_api": ("block" if hasattr(wk, "ring_columns_block")
                          else "per_lane")}
    # kept cells (live panes 1000..1020, columns 8..28) that must move bit
    # for bit: NaNs with payloads, -NaN, -0.0
    specials = [st[i].copy() for i in range(1, 4)]
    live_cols = np.arange(pane_lo, pane_hi + 1) % ring
    nan_bits = np.array([0x7FC01234, 0xFFC00001, 0x7F800001], np.uint32)
    for lane in specials:
        lane[keys[:3, None], live_cols[None, ::7], 0] = nan_bits.view(
            np.float32)[:, None]
        lane[keys[3:6], live_cols[1], 0] = -0.0
    block_np = (*specials, st[0])                        # PaneState order

    for order in ("first_seen", "ascending"):
        buf = t(pair_rows(np, slots, ts, data["price"], ring, order))
        P = buf.shape[0]
        pstate = [t(st[0]), t(st[1])]
        a_ = [x.clone() for x in pstate]
        b_ = [x.clone() for x in pstate]
        lk.scatter_pair_lanes(*a_, buf)
        lk.scatter_pair_lanes_plain(*b_, buf)
        torch.cuda.synchronize()
        check(same_bits(torch, a_[0], b_[0]) and same_bits(torch, a_[1], b_[1]),
              f"scatter_pair_lanes ({order}) differs from its plain version")
        ps = [x.clone() for x in pstate]
        pair_long = buf[:, 0].long()
        pair_sums = buf[:, 2:].contiguous().view(torch.float32)
        psum_flat = ps[1].view(-1, 1)
        b, by = bound_ms(P * 12 + P * 8 * 2, P * 2)
        out[f"scatter_pair_lanes_{order}"] = {
            "pairs": P, "bound_ms": b, "bound_by": by,
            "kernel": split_times(torch, lambda: lk.scatter_pair_lanes(*ps, buf)),
            "library": split_times(torch, lambda: psum_flat.index_add_(
                0, pair_long, pair_sums)),
            "library_call": "index_add_ (the sum lane)"}

    # the purge of an advance: 11 dead columns, a run that wraps past the
    # ring's end (columns 29..31, 0..7)
    keep_np = np.ones(ring, bool)
    keep_np[np.arange(pane_lo - 11, pane_lo) % ring] = False
    keep, ident = t(keep_np), torch.arange(ring, dtype=torch.int32, device=dev)
    cleared = t(np.flatnonzero(~keep_np).astype(np.int64))
    n_cleared = int((~keep_np).sum())
    block = [t(x) for x in block_np]
    x, y = block[3].clone(), block[3].clone()
    wk.ring_columns(x, x, ident, keep)
    wk.ring_columns_plain(y, y, ident, keep)
    xs = [v.clone() for v in block]
    ys = [v.clone() for v in block]
    ring_block_fn(wk, xs, xs, ident, keep)()
    for v, f in zip(ys, BLOCK_FILLS):
        wk.ring_columns_plain(v, v, ident, keep, f)
    torch.cuda.synchronize()
    payload = int(np.array(0x7FC01234, np.uint32).view(np.int32))
    check(exact_bits(torch, x, y) and all(exact_bits(torch, p, q)
                                          for p, q in zip(xs, ys))
          and int((xs[1].view(torch.int32) == payload).sum()) == 3,
          "ring_columns (purge) differs from its plain version")
    b, by = bound_ms(rows * n_cleared * 4 + ring * 5, 0)
    out["ring_columns_count_purge"] = {
        "shape": [rows, ring], "cleared": n_cleared, "bound_ms": b,
        "bound_by": by,
        "kernel": split_times(torch, lambda: wk.ring_columns(x, x, ident, keep)),
        "library": split_times(torch, lambda: y.index_fill_(1, cleared, 0)),
        "library_call": "index_fill_"}
    b, by = bound_ms(4 * rows * n_cleared * 4 + ring * 5, 0)
    out["ring_columns_block_purge"] = {
        "lanes": 4, "shape": [rows, ring, 1], "cleared": n_cleared,
        "bound_ms": b, "bound_by": by,
        "kernel": split_times(torch, ring_block_fn(wk, xs, xs, ident, keep)),
        "library": split_times(torch, lambda: [
            v.index_fill_(1, cleared, f) for v, f in zip(ys, BLOCK_FILLS)]),
        "library_call": "index_fill_ a lane"}

    # growths: the count lane 6 -> 16 at WordCount's 65,537 rows (panes
    # 3..8 applied), and the four-lane block 32 -> 64 (panes 1000..1020)
    old = t(np.random.default_rng(SEED + 5).integers(0, 40, (65_537, 6),
                                                      dtype=np.int32))
    cmap = np.full(16, -1, np.int64)
    cmap[np.arange(3, 9) % 16] = np.arange(3, 9) % 6
    g_src, g_keep = t(np.maximum(cmap, 0).astype(np.int32)), t(cmap >= 0)
    g1 = torch.empty((65_537, 16), dtype=torch.int32, device=dev)
    g2 = torch.empty_like(g1)
    wk.ring_columns(old, g1, g_src, g_keep)
    wk.ring_columns_plain(old, g2, g_src, g_keep)
    cmap = np.full(64, -1, np.int64)
    live = np.arange(pane_lo, pane_hi + 1)
    cmap[live % 64] = live % ring
    b_src, b_keep = t(np.maximum(cmap, 0).astype(np.int32)), t(cmap >= 0)
    d1 = [torch.empty((rows, 64) + tuple(v.shape[2:]), dtype=v.dtype,
                      device=dev) for v in block]
    d2 = [torch.empty_like(v) for v in d1]
    ring_block_fn(wk, block, d1, b_src, b_keep)()
    for s_, d_, f in zip(block, d2, BLOCK_FILLS):
        wk.ring_columns_plain(s_, d_, b_src, b_keep, f)
    torch.cuda.synchronize()
    check(torch.equal(g1, g2) and all(exact_bits(torch, p, q)
                                      for p, q in zip(d1, d2))
          and int((d1[1].view(torch.int32) == payload).sum()) == 3,
          "ring_columns (growth) differs from its plain version")
    b, by = bound_ms(65_537 * 6 * 4 + 65_537 * 16 * 4 + 16 * 5, 0)
    out["ring_columns_count_growth"] = {
        "shape": [65_537, 6, 16], "kept": 6, "bound_ms": b, "bound_by": by,
        "kernel": split_times(torch, lambda: wk.ring_columns(old, g1, g_src,
                                                             g_keep))}
    b, by = bound_ms(4 * rows * len(live) * 4 + 4 * rows * 64 * 4 + 64 * 5, 0)
    out["ring_columns_block_growth"] = {
        "lanes": 4, "shape": [rows, ring, 64], "kept": len(live),
        "bound_ms": b, "bound_by": by,
        "kernel": split_times(torch, ring_block_fn(wk, block, d1, b_src,
                                                   b_keep))}
    wk.check_errors(dev)
    return out


def window_lane_cases(torch, np, dev):
    """``window_lanes`` at job T's shape (32,769 rows, a 32-column ring,
    11 windows of 10 panes, one sum and one max lane) beside its library
    calls, each as loop ms, device ms and host µs a call
    (``split_times``): the sum lane times the (ring, W) column mask in
    one f32 matmul, and the same product over both lanes the kernel
    computes (one batched matmul), TF32 off. The kernel's lanes are
    first held bit for bit against the plain version."""
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk

    rng = np.random.default_rng(SEED + 6)
    rows, ring, ppw, W = 32_769, 32, 10, 11
    pane_lo, pane_hi = 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    _, sums, maxs, _ = lane_state(np, rng, rows, ring, pane_lo, pane_hi,
                                  keys, (1, 1, 0), hot=100)
    s_t = torch.from_numpy(sums).to(dev)
    m_t = torch.from_numpy(maxs).to(dev)
    ends = torch.arange(pane_hi - W + 2, pane_hi + 2, dtype=torch.int64,
                        device=dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    args = (s_t, m_t, None, ends, valid, pane_lo, pane_hi, ppw, rows)
    a = tk.window_lanes(*args)
    b = tk.window_lanes_plain(*args)
    torch.cuda.synchronize()
    check(all(x.shape == y.shape and same_bits(torch, x, y)
              for x, y in zip(a, b)),
          "window_lanes differs from its plain version")
    colmask = lk._live_columns(ends, ring, pane_lo, pane_hi, ppw).T.float()
    s2 = s_t[:, :, 0].contiguous()
    both = torch.stack([s2, m_t[:, :, 0]]).contiguous()     # (2, rows, ring)
    live_cols = int((colmask.sum(dim=1) > 0).sum())
    b_live, by = bound_ms(rows * live_cols * 4 * 2 + rows * W * 4 * 2 + W * 9,
                          0)
    b_all, _ = bound_ms(rows * ring * 4 * 2 + rows * W * 4 * 2 + W * 9, 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {"shape": [rows, ring, W], "lanes": 2,
               "bound_ms": b_live, "bound_ms_every_column": b_all,
               "bound_by": by,
               "kernel": split_times(torch, lambda: tk.window_lanes(*args)),
               "library_sum_lane": split_times(torch, lambda: s2 @ colmask),
               "library_both_lanes": split_times(torch,
                                                 lambda: both @ colmask),
               "library_call": "sums @ colmask (TF32 off); both lanes as "
                               "one batched matmul"}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def fire_kernel_cases(torch, np, dev):
    """``fire_pack`` and ``topn_select_lanes`` at the ``kernels`` phase's
    shapes beside their library calls, each as loop ms, device ms and
    host µs a call (``split_times``), after a bit-for-bit check against
    the plain version: fire_pack's three cases (``fire_pack_cases``)
    against the count or sum lane's column-mask matmul (TF32 off), and
    topn_select_lanes top-1 by max_price and the planted top-3 by
    avg_price at job T's fire (``topn_select_cases``) against
    ``torch.topk(v.T, n)``. The bound's byte counts are the kernels
    phase's."""
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk
    from flink_tpu_torch.kernels import window_kernels as wk

    out = {}
    for case in fire_pack_cases(torch, np, dev)["cases"]:
        args = case["args"]
        a_buf, a_lanes = lk.fire_pack(*args)
        b_buf, b_lanes = lk.fire_pack_plain(*args)
        torch.cuda.synchronize()
        n = int(b_buf[0, 0])
        check(int(a_buf[0, 0]) == n
              and torch.equal(a_buf[:n + 1], b_buf[:n + 1])
              and (a_lanes is None or same_bits(torch, a_lanes[:n],
                                                b_lanes[:n])),
              f"fire_pack ({case['name']}) differs from its plain version")
        b, by = bound_ms(*case["bytes_ops"](n))
        out["fire_pack_" + case["name"]] = {
            "rows": n, "bound_ms": b, "bound_by": by,
            "kernel": split_times(torch, lambda: lk.fire_pack(*args)),
            "library": tf32_off(torch, lambda: split_times(torch,
                                                           case["library"])),
            "library_call": case["library_call"]}
    inp = topn_lanes_inputs(torch, np, dev)
    rows, W = inp["rows"], inp["W"]
    lanes = tk.window_lanes(*inp["lane_args"])
    wc = wk.window_counts_plain(inp["counts"], inp["ends"], inp["valid"],
                                inp["pane_lo"], inp["pane_hi"], inp["ppw"])
    sel = topn_select_cases(torch, np, dev, inp, lanes, wc)
    emit_ring = torch.zeros((2048 + 2, 5), dtype=torch.int32, device=dev)
    for name, n, v in (("top1", 1, sel["v"]), ("top3", 3, sel["v3"])):
        args = sel[name]
        r1, r2, r3 = (emit_ring.clone() for _ in range(3))
        tk.topn_select_lanes(*args, r1)
        tk.topn_select_lanes_plain(*args, r2)
        torch.cuda.synchronize()
        check(torch.equal(r1[:-1], r2[:-1]),
              f"topn_select_lanes ({name}) differs from its plain version")
        written = int(r1[0, 0])
        if name == "top3":
            check_top3_plants(np, r1, sel["plant"],
                              inp["pane_lo"] - int(inp["ends"][0]))
        vt = v.T.contiguous()
        b, by = bound_ms(*topn_select_bytes_ops(rows, W, n, written))
        out["topn_select_lanes_" + name] = {
            "rows": written, "bound_ms": b, "bound_by": by,
            "kernel": split_times(torch, lambda: tk.topn_select_lanes(
                *args, r3)),
            "library": split_times(torch, lambda: torch.topk(vt, n, dim=1)),
            "library_call": "torch.topk(v.T, n), the threshold only"}
    wk.check_errors(dev)
    return out


def count_topn_cases(torch, np, dev):
    """The count-form top-n beside its library calls, each as loop ms, device ms and host µs a call
    (``split_times``), after a bit-for-bit check against the plain
    version: ``topn_select_append`` top-1 on the ``kernels`` phase's
    grid (32,769 x 11 windows) and top-3 on it with four rows planted a
    window (the third and fourth tied), against ``torch.topk(wcounts.T,
    n)`` (the threshold only); ``fused_step`` with the fire of 11 ends,
    gate on (``fused_inputs``); ``topn_select_given`` on job M1's first
    block (8,193 rows) against the global top-1."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.kernels import window_kernels as wk

    q = q5_kernel_state(torch, np, dev)
    W, rows = q["W"], q["slots"] + 1
    used, ends, w_valid, anchor = q["used"], q["ends"], q["w_valid"], 1000
    state = q["counts"].clone()
    wk.scatter_counts_plain(state, q["idx"], q["cnt"])
    wc = wk.window_counts_plain(state, ends, w_valid, q["pane_lo"],
                                q["pane_hi"], q["ppw"])
    rng = np.random.default_rng(SEED + 13)
    planted = wc.clone()
    plant = {}
    for w in range(W):
        r = rng.choice(np.flatnonzero(used.cpu().numpy()), 4, replace=False)
        planted[torch.from_numpy(r).to(dev), w] = torch.tensor(
            [5_000_000, 4_000_000, 3_000_000, 3_000_000], dtype=torch.int32,
            device=dev)
        plant[w] = set(r.tolist())
    ring0 = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    out = {}
    for name, grid, n in (("top1", wc, 1), ("top3", planted, 3)):
        args = (grid, used, ends, w_valid, anchor, n, 256)
        r1, r2, r3 = (ring0.clone() for _ in range(3))
        wk.topn_select_append(*args, r1)
        wk.topn_select_append_plain(*args, r2)
        torch.cuda.synchronize()
        check(torch.equal(r1[:-1], r2[:-1]),
              f"topn_select_append ({name}) differs from its plain version")
        written = int(r1[0, 0])
        if name == "top3":
            got = {}
            for r, e, _ in r1[1:1 + written].tolist():
                got.setdefault(e + anchor - int(ends[0]), set()).add(r)
            check(got == plant, "topn_select_append (top3): the rows are "
                  "not the planted ones")
        gt = grid.T.contiguous()
        b, by = bound_ms(rows * W * 4 + rows + W * 9 + written * 12 + 8,
                         rows * W * (2 * n + 2))
        out["topn_select_append_" + name] = {
            "rows": written, "bound_ms": b, "bound_by": by,
            "kernel": split_times(torch, lambda: wk.topn_select_append(
                *args, r3)),
            "library": split_times(torch, lambda: torch.topk(gt, n, dim=1)),
            "library_call": "torch.topk(wcounts.T, n), the threshold only"}

    f = fused_inputs(torch, np, dev)
    buf = f["upload"](11)
    kw = dict(ppw=f["ppw"], n=1, sel_cap=256, dump_row=f["slots"],
              fire_gate=True, fire_pad=16)
    st = [f["base"].clone() for _ in range(3)]
    er = [ring0.clone() for _ in range(3)]
    fk.fused_step(st[0], er[0], buf, f["used"], **kw)
    fk.fused_step_plain(st[1], er[1], buf, f["used"], **kw)
    torch.cuda.synchronize()
    check(torch.equal(st[0], st[1]) and torch.equal(er[0][:-1], er[1][:-1]),
          "fused_step (11 ends, gate on) differs from its plain version")
    out["fused_step_ends11_gate_on"] = {
        "rows": int(er[0][0, 0]),
        "kernel": split_times(torch, lambda: fk.fused_step(
            st[2], er[2], buf, f["used"], **kw)),
        "library": None, "library_call": "none: no single call"}

    # job M1's first block of the grid, against the global top-1
    spd = (rows - 1) // MESH_BLOCKS
    blocks = [(torch.cat([wc[b * spd:(b + 1) * spd], wc[-1:] * 0]),
               torch.cat([used[b * spd:(b + 1) * spd], used[-1:] & False]))
              for b in range(MESH_BLOCKS)]
    gathered = torch.cat(
        [wk.topn_candidates_plain(w, u, w_valid, 1) for w, u in blocks],
        dim=1)
    args = (*blocks[0], ends, w_valid, anchor, gathered, 1, 0, 256)
    r1, r2, r3 = (ring0.clone() for _ in range(3))
    wk.topn_select_given(*args, r1)
    wk.topn_select_given_plain(*args, r2)
    torch.cuda.synchronize()
    check(torch.equal(r1[:-1], r2[:-1]),
          "topn_select_given differs from its plain version")
    written = int(r1[0, 0])
    # the grid, the used mask, the ends, the gathered candidates read once
    b, by = bound_ms((spd + 1) * W * 4 + spd + 1 + W * 9 + gathered.numel() * 4
                     + written * 12 + 8,
                     (spd + 1) * W * 2 + gathered.numel() * 2)
    out["topn_select_given_m1_block"] = {
        "rows": written, "bound_ms": b, "bound_by": by,
        "kernel": split_times(torch, lambda: wk.topn_select_given(*args, r3)),
        "library": None, "library_call": "none: no single call"}

    wk.check_errors(dev)
    return out


def count_lane_cases(torch, np, dev):
    """The count lane's ``window_counts`` (K2) and ``scatter_counts`` (K1)
    in the forms the main paths give them, beside their library calls,
    each as loop ms, device ms and host µs a call (``split_times``),
    after a bit-for-bit check against the plain version:

    - K2 as the host launches it: the ``kernels`` phase's Q5 state
      (32,769 x 32, 21 live panes, 11 windows of 10 panes), beside
      ``counts.float() @ colmask`` (TF32 off); where the wrapper takes an
      ``out`` tensor (the operator's reused buffer), that call too;
    - K2 in one pass of 64 ends, as ``_fire_ends`` runs it after a
      devgen batch (32,769 x 64, 52 live panes), beside the same matmul;
    - F2's fused step with the fire of 11 ends, gate on (kernels a
      call, and the window counts' share of its device time);
    - K1 on Q5's ~110k host-combined pairs, beside ``index_add_``;
    - K1 per record on WordCount's first 2^20 words into 65,537 x 16,
      beside ``index_add_`` with a ones vector;
    - the per-record split upload of a 2^20-bid batch into 32,769 x 32
      as (B, 3) bytes: ``split_cells`` + ``scatter_counts`` (two
      launches) in a tree without the one-launch entry, else
      ``scatter_split_counts``; beside ``index_add_`` on the cells
      computed in advance and beside ``split_cells_plain`` +
      ``index_add_``."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_batch
    from flink_tpu_torch.ops.window import split_encode
    from flink_tpu_torch.state.keyed import KeyDirectory

    takes_out = "out" in inspect.signature(wk.window_counts).parameters
    one_launch = hasattr(wk, "scatter_split_counts")
    out = {"window_counts_takes_out": takes_out,
           "split_upload_one_launch": one_launch}

    def k2_case(name, counts, ends, w_valid, lo, hi, ppw):
        rows, ring = counts.shape
        W = ends.numel()
        got = wk.window_counts(counts, ends, w_valid, lo, hi, ppw)
        want = wk.window_counts_plain(counts, ends, w_valid, lo, hi, ppw)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"window_counts ({name}) differs from its plain version")
        hi_cap = min(hi, lo + ring - 1)
        spans = [range(max(e - ppw, lo), min(e - 1, hi_cap) + 1)
                 for e, ok in zip(ends.tolist(), w_valid.tolist()) if ok]
        live_cols = len({p % ring for sp in spans for p in sp})
        b, by = bound_ms(rows * live_cols * 4 + rows * W * 4 + W * 9,
                         rows * sum(len(sp) for sp in spans))
        counts_f = counts.float()
        mm = colmask_matmul_fn(torch, lk, counts_f, ends, ring, lo, hi, ppw)
        check(int(got.max()) < 2 ** 24
              and torch.equal(tf32_off(torch, mm).to(torch.int32), got),
              f"window_counts ({name}): the matmul yardstick differs")
        row = {"shape": [rows, ring, W], "bound_ms": b, "bound_by": by,
               "kernel": split_times(torch, lambda: wk.window_counts(
                   counts, ends, w_valid, lo, hi, ppw)),
               "library": tf32_off(torch, lambda: split_times(torch, mm)),
               "library_call": "counts.float() @ colmask (TF32 off)"}
        if takes_out:
            buf = torch.empty((rows, W), dtype=torch.int32, device=dev)
            row["kernel_out"] = split_times(torch, lambda: wk.window_counts(
                counts, ends, w_valid, lo, hi, ppw, out=buf))
        out["window_counts_" + name] = row

    q = q5_kernel_state(torch, np, dev)
    state = q["counts"].clone()
    wk.scatter_counts_plain(state, q["idx"], q["cnt"])
    k2_case("q5_w11", state, q["ends"], q["w_valid"], q["pane_lo"],
            q["pane_hi"], q["ppw"])
    # after a devgen batch: a 64-column ring, 52 live panes, 64 ends
    rng = np.random.default_rng(SEED + 17)
    rows, ring, lo, hi = q["slots"] + 1, 64, 1000, 1051
    keys = rng.choice(rows - 1, 10_000, replace=False)
    c64 = lane_state(np, rng, rows, ring, lo, hi, keys, (0, 0, 0), hot=100)[0]
    ends = torch.arange(lo + 1, lo + 65, dtype=torch.int64, device=dev)
    k2_case("devgen_w64", torch.from_numpy(c64).to(dev), ends,
            torch.ones(64, dtype=torch.bool, device=dev), lo, hi, q["ppw"])

    f = fused_inputs(torch, np, dev)
    buf = f["upload"](11)
    kw = dict(ppw=f["ppw"], n=1, sel_cap=256, dump_row=f["slots"],
              fire_gate=True, fire_pad=16)
    ring0 = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    st = [f["base"].clone() for _ in range(3)]
    er = [ring0.clone() for _ in range(3)]
    fk.fused_step(st[0], er[0], buf, f["used"], **kw)
    fk.fused_step_plain(st[1], er[1], buf, f["used"], **kw)
    torch.cuda.synchronize()
    check(torch.equal(st[0], st[1]) and torch.equal(er[0][:-1], er[1][:-1]),
          "fused_step (11 ends, gate on) differs from its plain version")
    t = split_times(torch, lambda: fk.fused_step(st[2], er[2], buf, f["used"],
                                                 **kw))
    out["fused_step_ends11_gate_on"] = {
        "kernel": t, "window_counts_device_ms": sum(
            v["ms_per_call"] for k, v in t["stages"].items()
            if k.startswith("window_counts"))}

    # K1, pairs: Q5's host-combined pairs with their counts
    idx, cnt = q["idx"], q["cnt"]
    a, b = q["counts"].clone(), q["counts"].clone()
    wk.scatter_counts(a, idx, cnt)
    wk.scatter_counts_plain(b, idx, cnt)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "scatter_counts (pairs) differs from its plain "
          "version")
    n = idx.numel()
    idx_long = idx.long()
    b_ms, by = bound_ms(16 * n, n)
    # the wrapper's host µs in parts: its checks, the launch context, the
    # packed C entry with the kernel's launch, and a bare ctypes call
    specs = ((a, torch.int32, 2), (idx, torch.int32, 1), (cnt, torch.int32, 1))
    err_ptr, stream = wk.launch_context(0)
    rows_a, ring_a = a.shape
    # the parent's packed block had the cell count where this one has the
    # rows and the ring
    words = ((a.data_ptr(), a.numel(), idx.data_ptr(), 4, cnt.data_ptr(), n,
              0, err_ptr) if wk._SCATTER_COUNTS._struct.size == 64 else
             (a.data_ptr(), rows_a, ring_a, idx.data_ptr(), 4, cnt.data_ptr(),
              n, 0, err_ptr))
    lib = wk._lib()
    out["scatter_counts_pairs"] = {
        "entries": n, "bound_ms": b_ms, "bound_by": by,
        "kernel": split_times(torch, lambda: wk.scatter_counts(a, idx, cnt)),
        "library": split_times(torch, lambda: b.view(-1).index_add_(
            0, idx_long, cnt)),
        "library_call": "index_add_",
        "host_us_parts": {
            "fast_index": host_us(torch, lambda: wk.fast_index(*specs)),
            "launch_context": host_us(torch, lambda: wk.launch_context(0)),
            "entry_and_launch": host_us(torch, lambda: wk._SCATTER_COUNTS(
                stream, *words)),
            "bare_ctypes_call": host_us(torch, lambda: lib.fk_error_string(0))}}

    # K1, per record: WordCount's first 2^20 words into 65,537 x 16
    rows, ring = 128 * 512 + 1, 16
    _, gen = wordcount_source(np, 1)
    data, ts = gen("0", 0)
    slots = KeyDirectory(128, 512).assign(data["word"])
    idx = torch.from_numpy((slots * ring + (ts // 1000) % ring).astype(
        np.int32)).to(dev)
    base = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
    a, b = base.clone(), base.clone()
    wk.scatter_counts(a, idx, None)
    wk.scatter_counts_plain(b, idx, None)
    torch.cuda.synchronize()
    check(torch.equal(a, b) and int(a.sum()) == WC_BATCH,
          "scatter_counts (per record) differs from its plain version")
    idx_long = idx.long()
    ones = torch.ones(WC_BATCH, dtype=torch.int32, device=dev)
    cells = int(torch.unique(idx).numel())
    b_ms, by = bound_ms(WC_BATCH * 4 + cells * 8, WC_BATCH)
    out["scatter_counts_per_record"] = {
        "records": WC_BATCH, "distinct_cells": cells,
        "distinct_share_a_chunk": chunk_distinct_share(np, idx.cpu().numpy()),
        "largest_cell": int(torch.bincount(idx_long).max()),
        "bound_ms": b_ms, "bound_by": by,
        "kernel": split_times(torch, lambda: wk.scatter_counts(a, idx, None)),
        "library": split_times(torch, lambda: b.view(-1).index_add_(
            0, idx_long, ones)),
        "library_call": "index_add_ with a ones vector"}

    # the per-record split upload: a 2^20-bid batch of job (a)'s stream
    cfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=1, events_per_ms=100,
                        num_active_auctions=10_000, hot_ratio=4)
    data, ts = bid_batch(cfg, 0, 5)
    slots = KeyDirectory(128, 256).assign(data["auction"])
    ring, dump_row = 32, 128 * 256
    cols = ((ts // 1000) % ring).astype(np.uint8)
    sc = torch.from_numpy(split_encode(slots, cols, np.ones(len(ts), bool))
                          ).to(dev)
    base = torch.zeros((dump_row + 1, ring), dtype=torch.int32, device=dev)
    if one_launch:
        def split_fn(c):
            return wk.scatter_split_counts(c, sc, dump_row)
    else:
        def split_fn(c):
            return wk.scatter_counts(c, wk.split_cells(sc, ring, dump_row),
                                     None)
    a, b = base.clone(), base.clone()
    split_fn(a)
    wk.scatter_counts_plain(b, wk.split_cells_plain(sc, ring, dump_row), None)
    torch.cuda.synchronize()
    check(torch.equal(a, b) and int(a.sum()) == Q5_BATCH,
          "the split upload's scatter differs from its plain version")
    flat = torch.from_numpy((slots * ring + cols).astype(np.int64)).to(dev)
    ones = torch.ones(Q5_BATCH, dtype=torch.int32, device=dev)
    cells = int(torch.unique(flat).numel())
    b_ms, by = bound_ms(Q5_BATCH * 3 + cells * 8, Q5_BATCH * 4)
    out["split_upload_per_record"] = {
        "records": Q5_BATCH, "distinct_cells": cells,
        "distinct_share_a_chunk": chunk_distinct_share(
            np, flat.cpu().numpy()),
        "largest_cell": int(torch.bincount(flat).max()),
        "bound_ms": b_ms, "bound_by": by,
        "kernel": split_times(torch, lambda: split_fn(a)),
        "library": split_times(torch, lambda: b.view(-1).index_add_(
            0, flat, ones)),
        "library_call": "index_add_ on the cells computed in advance",
        "plain_decode_then_library": split_times(
            torch, lambda: b.view(-1).index_add_(0, wk.split_cells_plain(
                sc, ring, dump_row).long(), ones))}
    wk.check_errors(dev)
    return out


def chunk_distinct_share(np, cells, chunk: int = 8192) -> float:
    """The share of a batch's records that stay distinct cells within
    each block's chunk (the per-record count's global atomics over its
    records, at the plan's 8,192-record chunk of a 2^20 batch)."""
    kept = sum(len(np.unique(cells[k:k + chunk]))
               for k in range(0, len(cells), chunk))
    return kept / len(cells)


def phase_window_lanes(torch, np):
    """``--window-lanes``: build ``topn_lanes_kernels`` alone and run
    ``window_lane_cases`` (one JSON line)."""
    from flink_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all(("topn_lanes_kernels",))
    log = build.BUILD_LOG["topn_lanes_kernels"]
    emit({"phase": "window_lanes", "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln],
          **window_lane_cases(torch, np, torch.device("cuda")),
          "card": card_line()})


def launch_path_cases(torch, np, dev):
    """Every kernel wrapper at a main-path shape, as a call that launches
    it once: 32,769 x 32 Q5 state with 11 windows of 10 panes, ~110k
    host-combined pairs, 2^20-record batches."""
    from flink_tpu_torch.kernels import count_window_kernels as cw
    from flink_tpu_torch.kernels import devgen_kernels as dk
    from flink_tpu_torch.kernels import element_kernels as ek
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk
    from flink_tpu_torch.kernels import window_kernels as wk

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng = np.random.default_rng(SEED + 9)
    rows, ring, ppw, W, lo, hi = 32_769, 32, 10, 11, 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    c_np, s_np, m_np, n_np = lane_state(np, rng, rows, ring, lo, hi, keys,
                                        (1, 1, 1), hot=100)
    counts, sums, maxs, mins = t(c_np), t(s_np), t(m_np), t(n_np)
    ends = torch.arange(hi - W + 2, hi + 2, dtype=torch.int64, device=dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    used_np = np.zeros(rows, bool)
    used_np[keys] = True
    used = t(used_np)
    P, B = 110_000, 1 << 20
    pairs = rng.choice((rows - 1) * ring, P, replace=False)
    cnt = rng.integers(1, 4000, P)
    idx, cnt_t = t(pairs.astype(np.int32)), t(cnt.astype(np.int32))
    words = t(((pairs << 12) | cnt).astype(np.uint32).view(np.int32))
    tri = np.empty((P, 3), np.uint16)
    tri[:, 0], tri[:, 1], tri[:, 2] = pairs & 0xFFFF, pairs >> 16, cnt
    tri = t(tri)
    rec_cells = t(rng.integers(0, (rows - 1) * ring, B).astype(np.int32))
    rec = t(rng.random((B, 1)).astype(np.float32))
    sc = np.zeros((B, 3), np.uint8)
    slots = rng.integers(0, rows - 1, B)
    sc[:, 0], sc[:, 1], sc[:, 2] = slots & 0xFF, slots >> 8, slots % ring
    sc = t(sc)
    wc = wk.window_counts(counts, ends, valid, lo, hi, ppw)
    ring0 = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    ring5 = torch.zeros((2048 + 2, 5), dtype=torch.int32, device=dev)
    cands = wk.topn_candidates(wc, used, valid, 1)
    v = t(rng.random((rows, W)).astype(np.float32))
    cols = t(rng.integers(-9, 9, (rows, W, 2)).astype(np.int32))
    hdr = np.zeros(fk.FUSED_HDR, np.int32)
    hdr[:6] = np.array([lo, hi, lo], np.int64).view(np.int32)
    deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
    deltas[:W] = np.arange(hi - W + 2, hi + 2) - lo
    hdr[8:8 + fk.MIN_FIRE_PAD] = deltas
    fbuf = torch.cat([t(hdr), words])
    bkeys = t(rng.integers(0, 10_000, B).astype(np.int64))
    bts = t(rng.integers(lo * 1000, (hi + 1) * 1000, B).astype(np.int64))
    dg_counts = torch.zeros((rows, 64), dtype=torch.int32, device=dev)
    offsets = t(np.linspace(0, 1 << 18, 4097).astype(np.int64))
    el = [t(rng.random((1 << 18, 1)).astype(np.float32)) for _ in range(3)]
    cw_counts = t(rng.integers(0, 300, 65_537).astype(np.int32))
    cw_sums = t(rng.random((65_537, 1)).astype(np.float32))
    xcells = t(rng.integers(0, 4 * 8192 * ring, 1 << 18).astype(np.int32))
    xpay = t(rng.random((1 << 18, 3)).astype(np.float32))
    pbuf = np.empty((P, 3), np.int32)
    pbuf[:, 0], pbuf[:, 1] = pairs, cnt
    pbuf[:, 2] = rng.random(P).astype(np.float32).view(np.int32)
    pbuf = t(pbuf)
    keep = torch.ones(ring, dtype=torch.bool, device=dev)
    keep[:11] = False
    ident = torch.arange(ring, dtype=torch.int32, device=dev)
    block = (sums, maxs, mins, counts)
    return {
        "scatter_counts": lambda: wk.scatter_counts(counts, idx, cnt_t),
        "apply_pairs_u16": lambda: fk.apply_pairs_u16(counts, tri),
        "topn_global_threshold": lambda: wk.topn_global_threshold(cands, 1),
        "fire_pack": lambda: lk.fire_pack(counts, sums, None, None, ends[:4],
                                          valid[:4], used, lo, hi, ppw,
                                          1 << 16, False),
        "topn_select_lanes": lambda: tk.topn_select_lanes(
            wc, v, cols, used, ends, valid, lo, 1, 256, ring5),
        "window_counts": lambda: wk.window_counts(counts, ends, valid, lo, hi,
                                                  ppw),
        "apply_pairs_u32": lambda: fk.apply_pairs_u32(counts, words, rows - 1),
        "topn_select_append": lambda: wk.topn_select_append(
            wc, used, ends, valid, lo, 1, 256, ring0),
        "topn_candidates": lambda: wk.topn_candidates(wc, used, valid, 1),
        "topn_select_given": lambda: wk.topn_select_given(
            wc, used, ends, valid, lo, cands, 1, 0, 256, ring0),
        "split_cells": lambda: wk.split_cells(sc, ring, rows - 1),
        "scatter_split_counts": lambda: wk.scatter_split_counts(counts, sc,
                                                                rows - 1),
        "scatter_lanes": lambda: lk.scatter_lanes(
            counts, sums, None, None, rec_cells, rec, rec[:, :0], rec[:, :0]),
        "scatter_pair_lanes": lambda: lk.scatter_pair_lanes(counts, sums, pbuf),
        "ring_columns": lambda: wk.ring_columns_block(block, block, ident,
                                                      keep),
        "window_lanes": lambda: tk.window_lanes(sums, maxs, None, ends, valid,
                                                lo, hi, ppw, rows),
        "fused_step": lambda: fk.fused_step(counts, ring0, fbuf, used, ppw=ppw,
                                            n=1, sel_cap=256,
                                            dump_row=rows - 1, fire_gate=True,
                                            fire_pad=16),
        "nexmark_bids": lambda: dk.nexmark_bids(3, 0, B, B, 100, 4, 100,
                                                10_000, dev),
        "devgen_ingest": lambda: dk.devgen_ingest(
            dg_counts, bkeys, bts, key_domain=10_000, pane_ms=1000,
            offset_ms=0, dead_below=lo, refire_below=lo, dump_row=rows - 1),
        "devgen_ingest_nexmark": lambda: dk.devgen_ingest_nexmark(
            dg_counts, (3, 0, B, B, 100, 4, 100, 10_000), key_domain=10_000,
            pane_ms=1000, offset_ms=0, dead_below=lo, refire_below=lo,
            dump_row=rows - 1),
        "count_fire": lambda: cw.count_fire(cw_counts, None, cw_sums, None,
                                            None, 250, 1 << 16),
        "segment_lanes": lambda: ek.segment_lanes(offsets, *el),
        "bucket_records": lambda: xk.bucket_records(xcells, xpay, 4, 1 << 17,
                                                    8192, ring),
        "hash_keys": lambda: xk.hash_keys(bkeys),
    }


# the kernels slower than their library call that a host path might
# explain (ROADMAP.md's speed table as the launch path found it)
SPEED_ROWS = ("scatter_counts", "apply_pairs_u16", "topn_global_threshold",
              "fire_pack", "topn_select_lanes", "window_counts",
              "apply_pairs_u32")


def phase_launch_path(torch, np):
    """``--launch-path``: build the kernels and print each wrapper's host
    µs a call (1,000 calls without a sync), and the loop ms (CUDA events
    around 50 calls) of ``SPEED_ROWS`` (one JSON line)."""
    phase_build()
    cases = launch_path_cases(torch, np, torch.device("cuda"))
    out = {}
    for name, fn in cases.items():
        row = {"host_us": host_us(torch, fn)}
        if name in SPEED_ROWS:
            row["loop_ms"] = time_ms(torch, fn)
        out[name] = row
    emit({"phase": "launch_path", "wrappers": out, "card": card_line()})


def big_cells_keys(np):
    """BIG_KEYS keys, half of them hashed into shards 1024 and up, whose
    slots (2^26 and up) put every cell of theirs past 2^31."""
    from flink_tpu_torch.records import hash_keys_numpy

    cand = np.arange(1, 24 * BIG_KEYS, dtype=np.int64)
    shard = hash_keys_numpy(cand) % BIG_SHARDS
    high = cand[shard >= 1024][:BIG_KEYS // 2]
    check(len(high) == BIG_KEYS // 2, "too few keys in the high shards")
    return np.concatenate([cand[shard < 1024][:BIG_KEYS // 2], high])


def big_cells_batches(np, keys):
    """BIG_BATCHES batches of 2^20 bids over ``keys``: three over event
    time [0, 9 s), then one over [12 s, 15 s) with an eighth of it 40 s
    ahead (the ring grows 32 -> 64); prices in whole cents."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for i in range(BIG_BATCHES):
        k = keys[rng.integers(0, len(keys), BIG_BATCH)]
        last = i == BIG_BATCHES - 1
        ts = (12_000 if last else 3_000 * i) + rng.integers(0, 3_000, BIG_BATCH)
        if last:
            ts[:BIG_BATCH // 8] += 40_000
        price = (rng.integers(100, 100_000, BIG_BATCH) / 100).astype(np.float32)
        out.append((k, ts.astype(np.int64), price))
    return out


def big_cells_golden(np, batches):
    """Per (window end, key) of the 10 s / 1 s windows: the bid count
    and the f64 price sum, ordered by (end, key)."""
    k = np.concatenate([b[0] for b in batches])
    pane = np.concatenate([b[1] for b in batches]) // 1000
    price = np.concatenate([b[2] for b in batches]).astype(np.float64)
    kp, inv = np.unique(k * 4096 + pane, return_inverse=True)
    cnt = np.bincount(inv).astype(np.int64)
    tot = np.bincount(inv, weights=price)
    key, pane = kp // 4096, kp % 4096
    ends = (pane[:, None] + np.arange(1, 11)[None, :]).reshape(-1)
    ke, inv = np.unique(ends * (1 << 40) + np.repeat(key, 10),
                        return_inverse=True)
    return (ke >> 40, ke & ((1 << 40) - 1),
            np.bincount(inv, weights=np.repeat(cnt, 10)).astype(np.int64),
            np.bincount(inv, weights=np.repeat(tot, 10)))


def run_big_cells(torch, np):
    """The count + sum job on a state past 2^31 cells (BIG_SHARDS x
    BIG_SPD slots + 1 dump row, a 32-column ring): four 2^20-bid batches,
    a fire of window ends 1..12 s with the purge of panes 0..2, a ring
    growth 32 -> 64, then the end-of-input fire; rows against a numpy
    golden (counts exactly, sums within agg_rel_bound). Prints its rows,
    ring, the bytes it held on the card and its events/s."""
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.window import WindowOperator

    keys = big_cells_keys(np)
    batches = big_cells_batches(np, keys)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    op = WindowOperator(SlidingEventTimeWindows.of(10_000, 1_000),
                        ta.multi(ta.count(), ta.sum_of("price")),
                        num_shards=BIG_SHARDS, slots_per_shard=BIG_SPD,
                        max_out_of_orderness_ms=17_000, device="cuda")
    rows, ring0 = op.layout.rows, op.plan.ring
    cell_dtype = op._cell_dtype().__name__
    check(rows * ring0 >= 2 ** 31 and cell_dtype == "int64",
          f"big-cells state {rows} x {ring0} cells as {cell_dtype}")
    fired = []
    t1 = time.perf_counter()
    for i, (k, ts, price) in enumerate(batches):
        op.process_batch(k, ts, {"price": price})
        if i == BIG_BATCHES - 2:
            fired.append(dict(op.advance_watermark(12_000)))
    fired.append(dict(op.advance_watermark(op.final_watermark())))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(wk.LAUNCHES)
    held = torch.cuda.max_memory_allocated()
    ring1 = op.plan.ring
    del op
    torch.cuda.empty_cache()
    got = {f: np.concatenate([np.asarray(d[f]) for d in fired])
           for f in ("window_end", "key", "count", "sum_price")}
    order = np.lexsort((got["key"], got["window_end"]))
    g_end, g_key, g_cnt, g_sum = big_cells_golden(np, batches)
    check(len(order) == len(g_end)
          and np.array_equal(got["window_end"][order], g_end * 1000)
          and np.array_equal(got["key"][order], g_key)
          and np.array_equal(got["count"][order], g_cnt),
          "big-cells rows differ from the golden")
    err = np.abs(got["sum_price"][order].astype(np.float64) - g_sum)
    check(bool((err <= agg_rel_bound(g_cnt) * np.abs(g_sum)).all()),
          "big-cells sums outside their bound")
    check(ring0 == 32 and ring1 == 64 and launches["ring_columns"] >= 3,
          f"big-cells ring {ring0} -> {ring1}, ring_columns "
          f"{launches['ring_columns']}")
    n = BIG_BATCH * BIG_BATCHES
    return {"rows": rows, "ring": [ring0, ring1], "cells": rows * ring1,
            "cell_dtype": cell_dtype, "state_bytes_after_growth":
            rows * ring1 * 8, "max_memory_allocated": held,
            "events": n, "fired_rows": int(len(order)), "wall_s": wall,
            "setup_s": t1 - t0, "events_per_s": n / wall,
            "launches": {k: v for k, v in launches.items() if v}}


def phase_big_cells(torch, np):
    """``--big-cells``: build the kernels and run ``run_big_cells`` (one
    JSON line)."""
    phase_build()
    emit({"phase": "big_cells", **run_big_cells(torch, np),
          "card": card_line()})


def lane_kernel_cases(torch, np, dev, record, out):
    """fire_pack, scatter_lanes, scatter_pair_lanes and the f32-lane
    ring_columns against their plain versions at this slice's shapes:
    WordCount state (65,537 x 16 after its first growth, 4-window chunks,
    ~28k keys) and the bid-aggregate state (32,769 x 32 x (1 sum, 1 max,
    1 min), 10,000 auctions, 2^20 bids, ~110k host-combined pairs).
    Integers and max/min exactly; sums too where kernel and plain version
    add in one fixed order (fire_pack, scatter_pair_lanes, and
    scatter_lanes against its plain version on the CPU), else to the
    bound of another order (scatter_lanes against its plain version on
    the card)."""
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import window_kernels as wk

    extra = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # L1 fire_pack at WordCount's shape and the bid-aggregate job (a)'s;
    # job (b)'s layout after the bid-aggregate kernels below
    fp = fire_pack_cases(torch, np, dev)
    for case in fp["cases"][:2]:
        args = case["args"]
        a_buf, a_lanes = lk.fire_pack(*args)
        b_buf, b_lanes = lk.fire_pack_plain(*args)
        torch.cuda.synchronize()
        n = int(b_buf[0, 0])
        check(int(a_buf[0, 0]) == n
              and torch.equal(a_buf[:n + 1], b_buf[:n + 1])
              and (a_lanes is None or same_bits(torch, a_lanes[:n],
                                                b_lanes[:n])),
              f"fire_pack ({case['name']}) differs from its plain version")
        nbytes, nops = case["bytes_ops"](n)
        ms = time_ms(torch, lambda: lk.fire_pack(*args))
        plain = time_ms(torch, lambda: lk.fire_pack_plain(*args), iters=10)
        lib_ms = tf32_off(torch, lambda: time_ms(torch, case["library"]))
        if case["name"] == "wordcount":
            record("fire_pack", "flink_tpu/ops/window.py:384", 0, ms, plain,
                   lib_ms, nbytes, nops, source="lane_kernels.cu")
            out[-1]["rows_per_fire"] = n
            out[-1]["library_call"] = case["library_call"]
            extra["fire_pack_wordcount_rows"] = n
        else:
            b, by = bound_ms(nbytes, nops)
            extra["fire_pack_lanes"] = {
                "rows": n, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                "bound_ms": b, "bound_by": by,
                "live_panes": case["live_panes"], "library_ms": lib_ms,
                "library_call": case["library_call"]}
    st, rows, ring = fp["state"], fp["rows"], fp["ring"]
    pane_lo, pane_hi = fp["pane_lo"], fp["pane_hi"]

    # L2 scatter_lanes: one 2^20-bid batch of the bid-aggregate job (a)
    # into its state, then the same batch with 2^18 records in one cell
    data, ts, slots, idx_np = scatter_lanes_batch(np, ring)
    state = [t(x) for x in st]
    cases = scatter_lanes_cases(torch, np, dev, st, idx_np, data["price"])
    u = cases["uniform"]
    # the form job (a)'s path launches: the batch's split upload, decoded
    # inside the launches, bit for bit against the kernel on the flat
    # cells and the plain version on the CPU; max_abs_err against the
    # plain version on the card (its index_add_ adds in no fixed order)
    dump_row = st[0].shape[0] - 1
    sc_np = split_bytes(np, idx_np, ring)
    sc, price = t(sc_np), t(data["price"][:, None])
    runs = [[t(x.copy()) for x in st] for _ in range(3)]
    lk.scatter_lanes(*runs[0], sc, price, price, price, dump_row=dump_row)
    lk.scatter_lanes(*runs[1], t(idx_np), price, price, price)
    lk.scatter_lanes_plain(*runs[2], wk.split_cells_plain(sc, ring, dump_row),
                           price, price, price)
    cpu = [torch.from_numpy(x.copy()) for x in st]
    pc = torch.from_numpy(data["price"][:, None].copy())
    lk.scatter_lanes(*cpu, torch.from_numpy(sc_np), pc, pc, pc,
                     dump_row=dump_row)
    torch.cuda.synchronize()
    check(all(same_bits(torch, a, b) and same_bits(torch, a, c)
              for a, b, c in zip(runs[0], runs[1], cpu)),
          "scatter_lanes' split form differs from the flat form or from "
          "its plain version on the CPU")
    err = float((runs[0][1] - runs[2][1]).abs().max())
    scratch = [t(x.copy()) for x in st]
    plain_scratch = [t(x.copy()) for x in st]
    n = len(idx_np)
    record("scatter_lanes", "flink_tpu/ops/window.py:62", err,
           time_ms(torch, lambda: lk.scatter_lanes(
               *scratch, sc, price, price, price, dump_row=dump_row)),
           time_ms(torch, lambda: lk.scatter_lanes_plain(
               *plain_scratch, wk.split_cells_plain(sc, ring, dump_row),
               price, price, price), iters=10),
           u["library_ms"], n * (3 + 12) + u["distinct_cells"] * 16 * 2,
           u["ops"], source="lane_kernels.cu")
    out[-1].update({k: v for k, v in u.items()
                    if k not in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                 "bound_ms", "bound_by", "bytes", "ops",
                                 "stages", "device_ms_per_call",
                                 "device_ops_per_call")})
    out[-1]["form"] = "the split upload's (B, 3) bytes, dump row %d" % dump_row
    out[-1]["flat_cells"] = {k: u[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "stages",
        "device_ms_per_call", "device_ops_per_call")}
    out[-1]["hot_cell"] = cases["hot_cell"]

    # L3 scatter_pair_lanes: the same batch host-combined (job (b)'s
    # upload: one [pair, count, f32 sum] row per distinct cell, in the
    # order the C combine emits them, first seen first)
    buf = t(pair_rows(np, slots, ts, data["price"], ring, "first_seen"))
    P = buf.shape[0]
    pstate = [t(st[0]), t(st[1])]
    a_ = [x.clone() for x in pstate]
    b_ = [x.clone() for x in pstate]
    lk.scatter_pair_lanes(*a_, buf)
    lk.scatter_pair_lanes_plain(*b_, buf)
    torch.cuda.synchronize()
    check(same_bits(torch, a_[0], b_[0]) and same_bits(torch, a_[1], b_[1]),
          "scatter_pair_lanes differs from its plain version")
    ps = [x.clone() for x in pstate]
    pp = [x.clone() for x in pstate]
    pair_long = buf[:, 0].long()
    pair_sums = buf[:, 2:].contiguous().view(torch.float32)
    psum_flat = ps[1].view(-1, 1)
    record("scatter_pair_lanes", "flink_tpu/ops/window.py:205", 0.0,
           time_ms(torch, lambda: lk.scatter_pair_lanes(*ps, buf)),
           time_ms(torch, lambda: lk.scatter_pair_lanes_plain(*pp, buf)),
           time_ms(torch, lambda: psum_flat.index_add_(0, pair_long,
                                                       pair_sums)),
           P * 12 + P * 8 * 2, P * 2, source="lane_kernels.cu")
    out[-1]["library_call"] = "index_add_ (the sum lane)"
    out[-1]["pairs"] = P
    out[-1]["row_order"] = "first_seen"
    extra["scatter_pair_lanes_pairs"] = P

    # K4 over the f32 lanes: the purge of 11 dead columns of each
    ident = torch.arange(ring, dtype=torch.int32, device=dev)
    keep_np = np.ones(ring, bool)
    keep_np[np.arange(pane_lo - 11, pane_lo) % ring] = False
    keep = t(keep_np)
    ok = True
    for lane, fill in zip(state[1:], (0.0, -float("inf"), float("inf"))):
        x1, x2 = lane.clone(), lane.clone()
        wk.ring_columns(x1, x1, ident, keep, fill)
        wk.ring_columns_plain(x2, x2, ident, keep, fill)
        ok = ok and same_bits(torch, x1, x2)
    cmap = np.full(64, -1, np.int64)
    ps_ = np.arange(pane_lo, pane_hi + 1)
    cmap[ps_ % 64] = ps_ % ring
    g1 = torch.empty((rows, 64, 1), device=dev)
    g2 = torch.empty_like(g1)
    src_col, keep_g = t(np.maximum(cmap, 0).astype(np.int32)), t(cmap >= 0)
    wk.ring_columns(state[1], g1, src_col, keep_g, 0.0)
    wk.ring_columns_plain(state[1], g2, src_col, keep_g, 0.0)
    torch.cuda.synchronize()
    check(ok and same_bits(torch, g1, g2),
          "ring_columns (f32 lanes) differs from its plain version")
    x1 = state[2].clone()
    n_cleared = int((~keep_np).sum())
    b, by = bound_ms(rows * n_cleared * 4 + ring * 5, 0)
    row = next(r for r in out if r["name"] == "ring_columns")
    row["f32_lanes"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: wk.ring_columns(x1, x1, ident, keep,
                                                     -float("inf"))),
        "plain_ms": time_ms(torch, lambda: wk.ring_columns_plain(
            x1, x1, ident, keep, -float("inf"))),
        "bound_ms": b, "bound_by": by, "shape": [rows, ring, 1]}

    # L1 fire_pack in job (b)'s layout: one sum lane, no max or min lane
    case = fp["cases"][2]
    sum_args = case["args"]
    a_buf, a_lanes = lk.fire_pack(*sum_args)
    b_buf, b_lanes = lk.fire_pack_plain(*sum_args)
    torch.cuda.synchronize()
    n = int(b_buf[0, 0])
    check(n > 0 and int(a_buf[0, 0]) == n
          and torch.equal(a_buf[:n + 1], b_buf[:n + 1])
          and tuple(a_lanes.shape) == (sum_args[10], 1)
          and same_bits(torch, a_lanes[:n], b_lanes[:n]),
          "fire_pack (one sum lane) differs from its plain version")
    b, by = bound_ms(*case["bytes_ops"](n))
    extra["fire_pack_sum_lane"] = {
        "rows": n, "max_abs_err": 0.0, "widths": [1, 0, 0],
        "ms": time_ms(torch, lambda: lk.fire_pack(*sum_args)),
        "plain_ms": time_ms(torch, lambda: lk.fire_pack_plain(*sum_args),
                            iters=10),
        "bound_ms": b, "bound_by": by}
    extra.update(wordcount_kernel_cases(torch, np, dev, out))
    return extra


def wordcount_kernel_cases(torch, np, dev, out):
    """The count-lane kernels in the forms the WordCount path gives them:
    ``scatter_counts`` per record (no counts: += 1 a word) on batch 0's
    2^20 words into 65,537 x 16 state, and the ``ring_columns`` growth
    of the count lane from 6 to 16 columns at 65,537 rows. Both exact."""
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.state.keyed import KeyDirectory

    rows, ring = 128 * 512 + 1, 16
    _, gen = wordcount_source(np, 1)
    data, ts = gen("0", 0)
    slots = KeyDirectory(128, 512).assign(data["word"])
    idx_np = (slots * ring + (ts // 1000) % ring).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    base = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
    a, b = base.clone(), base.clone()
    wk.scatter_counts(a, idx, None)
    wk.scatter_counts_plain(b, idx, None)
    torch.cuda.synchronize()
    err = int((a.long() - b.long()).abs().max())
    check(err == 0 and int(a.sum()) == WC_BATCH,
          f"scatter_counts (per record) differs from its plain version by {err}")
    cells = int(torch.unique(idx).numel())
    scratch, plain_scratch = base.clone(), base.clone()
    idx_long = idx.long()
    ones = torch.ones(WC_BATCH, dtype=torch.int32, device=dev)
    b_ms, by = bound_ms(WC_BATCH * 4 + cells * 8, WC_BATCH)
    row = next(r for r in out if r["name"] == "scatter_counts")
    row["per_record"] = {
        "shape": [rows, ring], "records": WC_BATCH, "distinct_cells": cells,
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: wk.scatter_counts(scratch, idx, None)),
        "plain_ms": time_ms(torch, lambda: wk.scatter_counts_plain(
            plain_scratch, idx, None)),
        "library_ms": time_ms(torch, lambda: scratch.view(-1).index_add_(
            0, idx_long, ones)),
        "bound_ms": b_ms, "bound_by": by}

    # the growth 6 -> 16: as the first batch makes it (nothing applied
    # yet, every column cleared) and with panes 3..8 applied (each moves
    # from column p % 6 to p % 16)
    old = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, 40, (rows, 6), dtype=np.int32)).to(dev)
    maps = []
    for applied in (np.arange(0), np.arange(3, 9)):
        cmap = np.full(ring, -1, np.int64)
        cmap[applied % ring] = applied % 6
        maps.append((torch.from_numpy(np.maximum(cmap, 0).astype(np.int32)).to(dev),
                     torch.from_numpy(cmap >= 0).to(dev), len(applied)))
    ok = True
    for src_col, keep, _ in maps:
        g1 = torch.empty((rows, ring), dtype=torch.int32, device=dev)
        g2 = torch.empty_like(g1)
        wk.ring_columns(old, g1, src_col, keep)
        wk.ring_columns_plain(old, g2, src_col, keep)
        torch.cuda.synchronize()
        ok = ok and torch.equal(g1, g2)
    check(ok, "ring_columns (count-lane growth 6 -> 16) differs from its "
          "plain version")
    src_col, keep, kept = maps[1]
    g = torch.empty((rows, ring), dtype=torch.int32, device=dev)
    b_ms, by = bound_ms(rows * kept * 4 + rows * ring * 4 + ring * 5, 0)
    row = next(r for r in out if r["name"] == "ring_columns")
    row["count_growth"] = {
        "shape": [rows, 6, ring], "kept_columns": kept, "max_abs_err": 0,
        "ms": time_ms(torch, lambda: wk.ring_columns(old, g, src_col, keep)),
        "plain_ms": time_ms(torch, lambda: wk.ring_columns_plain(
            old, g, src_col, keep)),
        "bound_ms": b_ms, "bound_by": by}
    return {"wordcount_scatter_distinct_cells": cells}


def count_fire_state(np):
    """WindowWordCount's count-window state at a fire: 65,537 rows (128 x
    512 key slots + the dump row) holding each word's count after one
    real 2^20-word batch, the operator's output cap, and two lane shapes:
    ``sum`` (one sum lane holding the counts, as ``count_window(250)
    .sum("n")`` leaves it) and ``lanes`` (a sum, a max and a min lane)."""
    from flink_tpu_torch.state.keyed import KeyDirectory

    rows = 128 * 512 + 1
    _, gen = wordcount_source(np, 1)
    words, _ = gen("0", 0)
    directory = KeyDirectory(128, 512)
    slots = directory.assign(words["word"])
    counts = np.bincount(slots, minlength=rows).astype(np.int32)
    cap = 1 << (directory.num_keys() - 1).bit_length()   # the operator's
    rng = np.random.default_rng(SEED + 7)
    price = (rng.random(rows) * 900 + 50).astype(np.float32)
    shapes = {"sum": (counts.astype(np.float32)[:, None], None, None),
              "lanes": ((counts * price)[:, None], (price * 3)[:, None],
                        (price / 3)[:, None])}
    return rows, counts, cap, shapes


def count_fire_tensors(torch, np, dev, counts, lanes, base=None):
    """``[counts, base, sums, maxs, mins]`` on ``dev`` (None where a lane
    or the base is absent) and a function that copies that state back in
    (a fire resets the rows it packs)."""
    saved = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             if x is not None else None
             for x in (counts, base, *[None if x is None else
                                       x.astype(np.float32) for x in lanes])]
    state = [None if x is None else x.clone() for x in saved]

    def restore():
        for x, y in zip(state, saved):
            if x is not None:
                x.copy_(y)
    return state, restore


def count_fire_bytes(rows, n, L, base=False):
    """count_fire's bytes: the counts (and base) read once, each fired
    row's lanes read once, the head and n rows of 2 + L words written,
    then each fired row reset (its count and lanes, or its base)."""
    reset = n * 4 if base else n * (1 + L) * 4
    return (rows * (8 if base else 4) + n * L * 4 + (n + 1) * (2 + L) * 4
            + reset)


def count_window_kernel_cases(torch, np, dev, record, out):
    """``count_fire`` on WindowWordCount's state (``count_fire_state``:
    the ``sum`` and the ``lanes`` shape); ``split_cells`` on a 2^20-bid
    batch of the bid-aggregate job (a) into 32,769 x 32. Both exact:
    count_fire copies lanes as bits."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_batch
    from flink_tpu_torch.ops.window import split_encode
    from flink_tpu_torch.state.keyed import KeyDirectory

    extra = {}
    rows, counts_np, cap, shapes = count_fire_state(np)
    for name, lanes in shapes.items():
        kern, restore = count_fire_tensors(torch, np, dev, counts_np, lanes)
        plain, restore_plain = count_fire_tensors(torch, np, dev, counts_np,
                                                  lanes)
        a = cwk.count_fire(*kern, CW_SIZE, cap)
        b = cwk.count_fire_plain(*plain, CW_SIZE, cap)
        torch.cuda.synchronize()
        n = int(b[0, 0])
        check(n > 0 and int(a[0, 0]) == n
              and same_bits(torch, a[:n + 1], b[:n + 1])
              and all(x is None or same_bits(torch, x, y)
                      for x, y in zip(kern, plain)),
              f"count_fire ({name}) differs from its plain version")
        # each timed call fires on a fresh copy of the state (a fire
        # resets its rows); the copy loop alone is timed and subtracted
        copy_ms = time_ms(torch, restore)
        ms = time_ms(torch, lambda: (restore(), cwk.count_fire(
            *kern, CW_SIZE, cap))) - copy_ms
        plain_ms = time_ms(torch, lambda: (restore_plain(),
                                           cwk.count_fire_plain(
                                               *plain, CW_SIZE, cap)),
                           iters=10) - copy_ms
        L = sum(1 for x in lanes if x is not None)
        nbytes = count_fire_bytes(rows, n, L)
        if name == "sum":
            record("count_fire", "flink_tpu/ops/count_window.py:106", 0, ms,
                   plain_ms, None, nbytes, rows,
                   source="count_window_kernels.cu")
            out[-1].update({"rows": rows, "fired_rows": n, "out_cap": cap,
                            "copy_ms_subtracted": copy_ms,
                            "library_call": "none (no single torch call "
                                            "fires, packs and resets)"})
        else:
            b_ms, by = bound_ms(nbytes, rows)
            extra["count_fire_lanes"] = {
                "widths": [1, 1, 1], "fired_rows": n, "max_abs_err": 0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "copy_ms_subtracted": copy_ms}

    # split_cells: one batch of job (a)'s per-record upload
    cfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=1, events_per_ms=100,
                        num_active_auctions=10_000, hot_ratio=4)
    data, ts = bid_batch(cfg, 0, 5)
    slots = KeyDirectory(128, 256).assign(data["auction"])
    ring, dump_row = 32, 128 * 256
    cols = ((ts // 1000) % ring).astype(np.uint8)
    sc = torch.from_numpy(split_encode(slots, cols, np.ones(len(ts), bool))
                          ).to(dev)
    a = wk.split_cells(sc, ring, dump_row)
    b = wk.split_cells_plain(sc, ring, dump_row)
    torch.cuda.synchronize()
    want = torch.from_numpy((slots * ring + cols).astype(np.int32)).to(dev)
    check(torch.equal(a, b) and torch.equal(a, want),
          "split_cells differs from its plain version")
    record("split_cells", "flink_tpu/ops/window.py:101", 0,
           time_ms(torch, lambda: wk.split_cells(sc, ring, dump_row)),
           time_ms(torch, lambda: wk.split_cells_plain(sc, ring, dump_row)),
           None, Q5_BATCH * (3 + 4), Q5_BATCH * 4)
    out[-1].update({"records": Q5_BATCH, "shape": [dump_row + 1, ring],
                    "library_call": "none (no single torch call decodes "
                                    "the 3-byte records)"})

    # the count lane's split upload: decode and count in one launch
    base = torch.zeros((dump_row + 1, ring), dtype=torch.int32, device=dev)
    a, b = base.clone(), base.clone()
    wk.scatter_split_counts(a, sc, dump_row)
    wk.scatter_split_counts_plain(b, sc, dump_row)
    torch.cuda.synchronize()
    check(torch.equal(a, b) and int(a.sum()) == Q5_BATCH,
          "scatter_split_counts differs from its plain version")
    flat = want.long()
    ones = torch.ones(Q5_BATCH, dtype=torch.int32, device=dev)
    cells = int(torch.unique(flat).numel())
    record("scatter_split_counts", "flink_tpu/ops/window.py:122", 0,
           time_ms(torch, lambda: wk.scatter_split_counts(a, sc, dump_row)),
           time_ms(torch, lambda: wk.scatter_split_counts_plain(b, sc,
                                                                dump_row)),
           time_ms(torch, lambda: b.view(-1).index_add_(0, flat, ones)),
           Q5_BATCH * 3 + cells * 8, Q5_BATCH * 4)
    out[-1].update({"records": Q5_BATCH, "distinct_cells": cells,
                    "shape": [dump_row + 1, ring],
                    "library_call": "index_add_ on the cells computed in "
                                    "advance"})
    return extra


def fused_inputs(torch, np, dev):
    """The native lane's state and batch at the host-fed Q5 shapes (128
    x 256 key slots + 1 dump row, a 32-column ring with 21 live panes,
    10,000 auctions, the first 100 of them 26x; the batch's pairs: every
    key x its 11 newest panes, host-combined, in no order of cells as the
    C scan appends them, a word each, and the same padded to 2^17 words
    as the reference pads them), and
    ``upload(n_ends, padded=False)``: the fused step's header (the fire
    of the ``n_ends`` newest window ends, the purge of one column) + the
    words."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.ops.window import preagg_encode_u32

    rng = np.random.default_rng(SEED + 7)
    slots, ring, ppw, n_keys = 128 * 256, 32, 10, 10_000
    rows = slots + 1
    pane_lo, pane_hi = 1000, 1020            # 21 live panes of the 32
    key_rows = rng.choice(slots, n_keys, replace=False)
    used = torch.zeros(rows, dtype=torch.bool, device=dev)
    used[torch.from_numpy(key_rows).to(dev)] = True
    counts_np = np.zeros((rows, ring), np.int32)
    for p in range(pane_lo, pane_hi + 1):
        counts_np[key_rows, p % ring] = rng.poisson(9.5, n_keys)
    counts_np[key_rows[:100], :] *= 26
    batch_panes = np.arange(pane_hi - 10, pane_hi + 1)
    # in no order of cells, as the C scan hands them over (first seen)
    pairs = rng.permutation((key_rows[:, None] * ring
                             + batch_panes[None, :] % ring).reshape(-1))
    cnts = rng.poisson(9.5, len(pairs)) + 1
    cap = 1 << 17
    words = torch.from_numpy(preagg_encode_u32(pairs, cnts, len(pairs))).to(
        dev)
    padded_words = torch.from_numpy(preagg_encode_u32(pairs, cnts, cap)).to(
        dev)

    def upload(n_ends, padded=False):
        hdr = np.zeros(fk.FUSED_HDR, np.int32)
        hdr[:6] = np.array([pane_lo, pane_hi, pane_lo], np.int64).view(np.int32)
        cw = np.array([1 << ((pane_lo - 1) % ring)], np.uint64).view(np.int32)
        hdr[7], hdr[6] = cw[0], cw[1]
        deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
        deltas[:n_ends] = np.arange(pane_hi + 2 - n_ends, pane_hi + 2) - pane_lo
        hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
        return torch.cat([torch.from_numpy(hdr).to(dev),
                          padded_words if padded else words])

    return {"slots": slots, "ring": ring, "ppw": ppw,
            "pane_lo": pane_lo, "pane_hi": pane_hi, "used": used,
            "base": torch.from_numpy(counts_np).to(dev), "pairs": pairs,
            "cnts": cnts, "cap": cap, "words": words,
            "padded_words": padded_words, "upload": upload}


def fused_kernel_cases(torch, np, dev, record):
    """The native lane's kernels at the host-fed Q5 shapes (128 x 256 key
    slots + 1 dump row, a 32-column ring, 10,000 auctions, one batch's
    ~110k host-combined pairs, a word each as the native lane launches
    them): ``apply_pairs_u32`` (and on the words padded to 2^17, checked
    only);
    ``apply_pairs_u16`` on the same pairs with every 50th count raised
    past 0xFFF, the real triples as the native lane launches them;
    ``fused_step`` on the header + words upload with 1 and with 11
    window ends, the fire gate on and off, and on the header + those
    triples (the hot-key form). All exact."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.ops.window import preagg_encode_u16

    f = fused_inputs(torch, np, dev)
    slots, ring, ppw = f["slots"], f["ring"], f["ppw"]
    rows, pane_lo, pane_hi = slots + 1, f["pane_lo"], f["pane_hi"]
    used, base, pairs, cnts = f["used"], f["base"], f["pairs"], f["cnts"]
    cap, words, upload = f["cap"], f["words"], f["upload"]

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max())

    def pair_case(name, apply, plain, buf, cnt_values, nbytes, replaces):
        a, b = base.clone(), base.clone()
        apply(a, buf)
        plain(b, buf)
        torch.cuda.synchronize()
        err = max_err(a, b)
        check(err == 0, f"{name} differs from its plain version by {err}")
        s1, s2, s3 = base.clone(), base.clone(), base.clone()
        idx = torch.from_numpy(pairs).to(dev)
        add = torch.from_numpy(cnt_values.astype(np.int32)).to(dev)
        record(name, replaces, err,
               time_ms(torch, lambda: apply(s1, buf)),
               time_ms(torch, lambda: plain(s2, buf)),
               time_ms(torch, lambda: s3.view(-1).index_add_(0, idx, add)),
               nbytes, buf.shape[0], source="fused_kernels.cu")

    # F1, on the real words; the padding words skipped as the plain
    # version skips them
    a, b = base.clone(), base.clone()
    fk.apply_pairs_u32(a, f["padded_words"], slots)
    fk.apply_pairs_u32_plain(b, f["padded_words"], slots)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "apply_pairs_u32 on padded words differs from "
          "its plain version")
    pair_case("apply_pairs_u32",
              lambda c, b: fk.apply_pairs_u32(c, b, slots),
              lambda c, b: fk.apply_pairs_u32_plain(c, b, slots), words, cnts,
              12 * len(pairs), "flink_tpu/ops/window.py:190")
    # F3: every 50th pair past 0xFFF, as a hot key's, the real triples
    cnts_used = cnts.copy()
    cnts_used[::50] += 4095
    triples = torch.from_numpy(preagg_encode_u16(
        pairs, cnts_used, len(pairs))).to(dev)
    pair_case("apply_pairs_u16", fk.apply_pairs_u16, fk.apply_pairs_u16_plain,
              triples, cnts_used, 14 * len(pairs),
              "flink_tpu/ops/window.py:145")

    # F2: one upload of header + words (``upload``); the purge clears
    # one column
    cases = {}
    for n_ends in (11, 1):
        buf = upload(n_ends)
        for gate in (True, False):
            pad = min(fk.MIN_FIRE_PAD, 1 << (n_ends - 1).bit_length()) \
                if gate else fk.MIN_FIRE_PAD
            kw = dict(ppw=ppw, n=1, sel_cap=256, dump_row=slots,
                      fire_gate=gate, fire_pad=pad)
            st = [base.clone(), base.clone()]
            er = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
                  for _ in range(2)]
            fk.fused_step(st[0], er[0], buf, used, **kw)
            fk.fused_step_plain(st[1], er[1], buf, used, **kw)
            torch.cuda.synchronize()
            err = max(max_err(st[0], st[1]), max_err(er[0][:-1], er[1][:-1]))
            check(err == 0, f"fused_step ({n_ends} ends, gate {gate}) "
                  f"differs from its plain version by {err}")
            written = int(er[0][0, 0])
            check(written >= n_ends, f"fused_step ring head {er[0][0].tolist()}")
            s1, r1 = base.clone(), er[0].clone()
            s2, r2 = base.clone(), er[1].clone()
            ms = time_ms(torch, lambda: fk.fused_step(s1, r1, buf, used, **kw))
            plain_ms = time_ms(torch, lambda: fk.fused_step_plain(
                s2, r2, buf, used, **kw), iters=10, warmup=2)
            # the bound moves the upload once, each pair's cell read and
            # written once, the live columns the fire sums (each window's
            # span of the 21 live panes), the used mask, the appended rows
            # and the purged column; operations: one add a word and a pane
            spans = [range(max(e - ppw, pane_lo), min(e - 1, pane_hi) + 1)
                     for e in range(pane_hi + 2 - n_ends, pane_hi + 2)]
            live_cols = len({p % ring for sp in spans for p in sp})
            live = sum(len(sp) for sp in spans)
            nbytes = (4 * buf.numel() + 8 * len(pairs) + 4 * rows * live_cols
                      + rows + 12 * written + 8 + 4 * rows)
            nops = buf.numel() + rows * live + rows * n_ends * 4
            b_ms, by = bound_ms(nbytes, nops)
            cases[f"ends{n_ends}_gate_{'on' if gate else 'off'}"] = {
                "fire_pad": pad, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                "rows_appended": written}
            if n_ends == 11 and gate:
                record("fused_step", "flink_tpu/ops/window.py:587", err, ms,
                       plain_ms, None, nbytes, nops, source="fused_kernels.cu")
    # F2 in the triple form: the header of 11 ends + the hot triples
    hdr = upload(11)[:fk.FUSED_HDR]
    n = len(pairs)
    t = torch.full((2 * ((6 * n + 3) // 4),), 0xFFFF, dtype=torch.uint16,
                   device=dev)
    t[:3 * n] = triples.reshape(-1)
    tbuf = torch.cat([hdr, t.view(torch.int32)])
    kw = dict(ppw=ppw, n=1, sel_cap=256, dump_row=slots, fire_gate=True,
              fire_pad=16, form=fk.FORM_TRIPLES)
    st = [base.clone(), base.clone()]
    er = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
          for _ in range(2)]
    fk.fused_step(st[0], er[0], tbuf, used, **kw)
    fk.fused_step_plain(st[1], er[1], tbuf, used, **kw)
    torch.cuda.synchronize()
    err = max(max_err(st[0], st[1]), max_err(er[0][:-1], er[1][:-1]))
    check(err == 0, f"fused_step (triples) differs from its plain version by "
          f"{err}")
    s1, r1 = base.clone(), er[0].clone()
    cases["ends11_gate_on_triples"] = {
        "fire_pad": 16, "max_abs_err": err, "rows_appended": int(er[0][0, 0]),
        "ms": time_ms(torch, lambda: fk.fused_step(s1, r1, tbuf, used, **kw))}
    return {"fused_step_cases": cases,
            "fused_step_kernels_per_step": fk.FUSED_STEP_KERNELS,
            "native_lane_pairs": len(pairs)}


def q5_golden(np, parts, n_auctions: int, window_panes: int, pane_ms: int):
    """(auction, window_end, count) rows: every window's max-count
    auctions, from per-(auction, pane) counts summed over the window.
    ``parts`` yields (auction, ts) arrays."""
    parts_a, parts_p = [], []
    for a, ts in parts:
        parts_a.append(a)
        parts_p.append(ts // pane_ms)
    auction = np.concatenate(parts_a)
    pane = np.concatenate(parts_p)
    n_a, n_p = n_auctions, int(pane.max()) + 1
    per_pane = np.bincount(auction * n_p + pane,
                           minlength=n_a * n_p).reshape(n_a, n_p)
    cs = np.concatenate([np.zeros((n_a, 1), np.int64),
                         np.cumsum(per_pane, axis=1)], axis=1)
    expect = set()
    for e in range(1, n_p + window_panes):
        win = cs[:, min(e, n_p)] - cs[:, max(e - window_panes, 0)]
        best = int(win.max())
        if best > 0:
            for a in np.flatnonzero(win == best):
                expect.add((int(a), e * pane_ms, best))
    return expect


def run_q5_host_fed(torch, np, cfg, label, numpy_lane=False, backend=None,
                    mesh=None, conf_extra=None, envs=None):
    """Q5 on host-made bids through ``env.execute()`` at
    confs/bench_q5_host_fed.conf: (rows in commit order, launches,
    JobResult, wall seconds). ``numpy_lane`` runs it with the numpy key
    table (``NativeHashTable.create`` returning None, as the tests select
    it), so no native lane; ``backend`` sets ``state.backend``; ``mesh``
    runs the window over that mesh of device blocks; ``conf_extra`` sets
    further options; ``envs``, a list, receives the environment."""
    from flink_tpu_torch import native_codec
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    if backend is not None:
        conf.set("state.backend", backend)
    for k, v in (conf_extra or {}).items():
        conf.set(k, v)
    parts = []
    env = StreamExecutionEnvironment(conf)
    if envs is not None:
        envs.append(env)
    q5_hot_items(env, bid_stream(cfg), FnSink(
        lambda b: parts.append({k: np.asarray(v).copy() for k, v in b.items()})),
        window_ms=10_000, slide_ms=1_000, out_of_orderness_ms=1_000)
    create = native_codec.NativeHashTable.__dict__["create"]
    if numpy_lane:
        native_codec.NativeHashTable.create = classmethod(
            lambda cls, capacity_hint=1024: None)
    try:
        torch.cuda.synchronize()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = env.execute(label, device="cuda", mesh_plan=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        native_codec.NativeHashTable.create = create
    rows = [(int(a), int(w), int(c)) for p in parts
            for a, w, c in zip(p["auction"], p["window_end"], p["bid_count"])]
    return rows, dict(wk.LAUNCHES), res, wall


def check_q5_rows(np, rows, cfg, label):
    from flink_tpu_torch.nexmark.generator import bid_batch

    expect = q5_golden(
        np, ((d["auction"], t) for d, t in
             (bid_batch(cfg, 0, i) for i in range(cfg.n_batches))),
        cfg.num_active_auctions, window_panes=10, pane_ms=1000)
    check(len(rows) == len(set(rows)), f"{label}: duplicate committed rows")
    got = set(rows)
    check(got == expect,
          f"{label}: rows differ from the golden: {len(got - expect)} extra, "
          f"{len(expect - got)} missing of {len(expect)}")


def q5_run_summary(rows, launches, res, wall, n_batches):
    busy, host = busy_and_host(res)
    events = Q5_BATCH * n_batches
    return {"events": events, "batches": n_batches, "wall_s": wall,
            "events_per_s": events / wall, "rows": len(rows),
            "windows": len({w for _, w, _ in rows}), "launches": launches,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
            "host_profile_s": host,
            "host_ms_per_batch": {k: v * 1e3 / n_batches
                                  for k, v in host.items()}}


def run_q5_count_only(torch, np, cfg, label):
    """Q5's count per auction without the top-n (sliding 10 s / 1 s,
    ``key_by(auction).window(...).count()``) through ``env.execute()`` at
    confs/bench_q5_host_fed.conf: an operator the fused step does not
    take, so a hot key's pairs fold in by ``apply_pairs_u16`` at once.
    (rows as (auction, window_end, count), launches, JobResult, wall s)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    parts = []
    env = StreamExecutionEnvironment(conf)
    (env.from_source(bid_stream(cfg),
                     WatermarkStrategy.for_bounded_out_of_orderness(1_000))
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(10_000, 1_000)).count()
        .add_sink(FnSink(lambda b: parts.append(
            {k: np.asarray(v).copy() for k, v in b.items()}))))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(int(a), int(w), int(c)) for p in parts
            for a, w, c in zip(p["key"], p["window_end"], p["count"])]
    return rows, dict(wk.LAUNCHES), res, wall


def check_q5_counts(np, rows, cfg, label):
    """Every (auction, window end) of the 10 s / 1 s windows with a bid,
    once, with its bid count (over every split of ``cfg``)."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    parts = [bid_batch(cfg, s, i) for i in range(cfg.n_batches)
             for s in range(cfg.n_splits)]
    auction = np.concatenate([d["auction"] for d, _ in parts])
    pane = np.concatenate([t for _, t in parts]) // 1000
    n_a, n_p = cfg.num_active_auctions, int(pane.max()) + 1
    per_pane = np.bincount(auction * n_p + pane,
                           minlength=n_a * n_p).reshape(n_a, n_p)
    cs = np.concatenate([np.zeros((n_a, 1), np.int64),
                         np.cumsum(per_pane, axis=1)], axis=1)
    ends = np.arange(1, n_p + 10)
    win = (cs[:, np.minimum(ends, n_p)]
           - cs[:, np.maximum(ends - 10, 0)])          # (auctions, ends)
    a_ix, e_ix = np.nonzero(win)
    expect = set(zip(a_ix.tolist(), (ends[e_ix] * 1000).tolist(),
                     win[a_ix, e_ix].tolist()))
    check(len(rows) == len(set(rows)), f"{label}: duplicate committed rows")
    got = set(rows)
    check(got == expect,
          f"{label}: rows differ from the golden: {len(got - expect)} extra, "
          f"{len(expect - got)} missing of {len(expect)}")


def phase_q5(torch, np):
    """Q5 host-fed at full width through the native lane (16 batches),
    then 4 batches each on the numpy lane and on hot-key bids (one fused
    step a batch on the triples, no apply_pairs_u16), the hot bids through
    a count-only window without top-n (apply_pairs_u16), and 4 logical
    batches at pipeline.sub-batches 1 and 4 (Q5's bids and the hot
    ones), and profiled runs; every run checked against its golden."""
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig

    cfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=Q5_BATCHES,
                        events_per_ms=100, num_active_auctions=10_000,
                        hot_ratio=4)
    rows, launches, res, wall = run_q5_host_fed(torch, np, cfg,
                                                "nexmark-q5-host-fed")
    on_path = ("fused_step", "apply_pairs_u32", "window_counts",
               "topn_select_append", "ring_columns")
    missing = [k for k in on_path if launches[k] == 0]
    check(not missing, f"kernels not launched on the native lane: {missing}")
    check(launches["fused_step"] == Q5_BATCHES - 1,
          f"{launches['fused_step']} fused steps for {Q5_BATCHES} batches "
          "(one per batch after the first expected)")
    side = dataclasses.replace(cfg, n_batches=Q5_SIDE_BATCHES)
    n_rows, n_launches, n_res, n_wall = run_q5_host_fed(
        torch, np, side, "q5-host-fed-numpy-lane", numpy_lane=True)
    check(n_launches["scatter_counts"] > 0 and n_launches["fused_step"] == 0,
          f"the numpy lane's launches {n_launches}")
    # 1,000 auctions, half the bids on 10 of them: ~5,000 bids a pane, so
    # pair counts past 0xFFF: the triples ride each batch's fused step
    hot = dataclasses.replace(side, num_active_auctions=1_000, hot_ratio=2)
    h_rows, h_launches, h_res, h_wall = run_q5_host_fed(torch, np, hot,
                                                        "q5-hot-keys")
    check(h_launches["fused_step"] >= Q5_SIDE_BATCHES - 1
          and h_launches["apply_pairs_u16"] == 0,
          f"hot keys: one fused step a batch after the first and no "
          f"apply_pairs_u16 expected: {h_launches}")
    # the hot bids without the top-n: no fused step, apply_pairs_u16
    c_rows, c_launches, c_res, c_wall = run_q5_count_only(
        torch, np, hot, "q5-hot-keys-count-only")
    check(c_launches["apply_pairs_u16"] > 0 and c_launches["fused_step"] == 0,
          f"count-only hot keys: apply_pairs_u16 expected: {c_launches}")
    # host-plane sub-batches: 4 logical batches at K = 1 and K = 4
    sub = {}
    for name, c in (("q5", side), ("hot_keys", hot)):
        for k in (1, 4):
            r = run_q5_host_fed(torch, np, c, f"q5-{name}-sub-batches-{k}",
                                conf_extra={"pipeline.sub-batches": k})
            check(r[2].metrics["exchange_overflow"] == 0
                  and r[2].metrics["batches"] == k * Q5_SIDE_BATCHES,
                  f"{name} at K = {k}: overflow or batches {r[2].metrics}")
            sub[(name, k)] = r
    prof = profile_run(torch, lambda: run_q5_host_fed(
        torch, np, side, "q5-host-fed-profiled")[3])
    h_prof = profile_run(torch, lambda: run_q5_host_fed(
        torch, np, hot, "q5-hot-keys-profiled")[3])
    c_prof = profile_run(torch, lambda: run_q5_count_only(
        torch, np, hot, "q5-hot-keys-count-only-profiled")[3])
    # the goldens' numpy work comes after the timed runs
    check_q5_rows(np, rows, cfg, "Q5 native lane")
    check_q5_rows(np, n_rows, side, "Q5 numpy lane")
    check_q5_rows(np, h_rows, hot, "Q5 hot keys")
    check_q5_counts(np, c_rows, hot, "Q5 hot keys, count only")
    for (name, k), r in sub.items():
        check_q5_rows(np, r[0], side if name == "q5" else hot,
                      f"Q5 {name} at K = {k}")
        check(by_window(r[0]) == by_window(sub[(name, 1)][0]),
              f"Q5 {name} at K = {k}: rows differ from the K = 1 run's")
    out = {"phase": "q5", "conf": "confs/bench_q5_host_fed.conf",
           **q5_run_summary(rows, launches, res, wall, Q5_BATCHES),
           "fused_steps_per_batch": launches["fused_step"] / Q5_BATCHES,
           "fused_step_kernels_per_step": fk.FUSED_STEP_KERNELS,
           "numpy_lane": q5_run_summary(n_rows, n_launches, n_res, n_wall,
                                        Q5_SIDE_BATCHES),
           "hot_keys": {"auctions": hot.num_active_auctions,
                        "hot_ratio": hot.hot_ratio,
                        **q5_run_summary(h_rows, h_launches, h_res, h_wall,
                                         Q5_SIDE_BATCHES)},
           "hot_keys_count_only": {
               "job": "key_by(auction).window(10 s / 1 s sliding).count()",
               **q5_run_summary(c_rows, c_launches, c_res, c_wall,
                                Q5_SIDE_BATCHES)},
           "sub_batches": {
               f"{name}_k{k}": {
                   "sub_batches": k,
                   "fused_steps": r[1]["fused_step"],
                   "late_records": r[2].metrics["late_records"],
                   "exchange_overflow": r[2].metrics["exchange_overflow"],
                   **q5_run_summary(r[0], r[1], r[2], r[3], Q5_SIDE_BATCHES)}
               for (name, k), r in sub.items()},
           "profiled": {"batches": Q5_SIDE_BATCHES, **prof},
           "hot_keys_profiled": {"batches": Q5_SIDE_BATCHES, **h_prof},
           "hot_keys_count_only_profiled": {"batches": Q5_SIDE_BATCHES,
                                            **c_prof},
           "card": card_line()}
    emit(out)
    per_call = dict(c_prof["device_ms_per_call"])
    per_call.update(h_prof["device_ms_per_call"])
    per_call.update(prof["device_ms_per_call"])
    # the fused step's own kernels only: the profiler links each step's
    # launches to its range
    ranged = prof["ranged_per_call"].get("fused_step")
    check(ranged is not None
          and ranged["kernels_per_call"] == fk.FUSED_STEP_KERNELS,
          f"q5: fused_step kernels a step {ranged}")
    h_ranged = h_prof["ranged_per_call"].get("fused_step")
    check(h_ranged is not None
          and h_ranged["kernels_per_call"] == fk.FUSED_STEP_KERNELS,
          f"q5 hot keys: fused_step kernels a step {h_ranged}")
    # the profiler's name of the header form: one a step
    for p_, r_ in ((prof, ranged), (h_prof, h_ranged)):
        check(p_["call_kernel_counts"]["fused_step"] == r_["calls"],
              f"q5: {CALL_KERNELS['fused_step']} launches "
              f"{p_['call_kernel_counts']['fused_step']} for {r_['calls']} "
              "fused steps")
    per_call["fused_step"] = ranged["device_ms"]
    return launches, n_launches, h_launches, c_launches, per_call, rows


def run_devgen_q5(torch, np, conf, cfg, label):
    """Q5 on bids made on the card through ``env.execute()``: (rows in
    commit order, launches, JobResult, wall seconds)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_stream_device
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    parts = []
    env = StreamExecutionEnvironment(conf)
    q5_hot_items(env, bid_stream_device(cfg), FnSink(
        lambda b: parts.append({k: np.asarray(v).copy() for k, v in b.items()})),
        window_ms=10_000, slide_ms=1_000, out_of_orderness_ms=1_000)
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(wk.LAUNCHES)
    rows = [(int(a), int(w), int(c)) for p in parts
            for a, w, c in zip(p["auction"], p["window_end"], p["bid_count"])]
    return rows, launches, res, wall


def profile_run(torch, run, own=(), names=False):
    """Kernel time by name from ``torch.profiler`` over ``run()`` (which
    returns its wall seconds): the device's busy share without the launch
    gaps that CUDA event spans count as busy. The profiler slows the
    host, so the run's wall (and idle share) is an upper bound. Each
    call of a ``RANGED_WRAPPERS`` wrapper runs inside a profiler range,
    and its device time per call is the sum of the kernels the profiler
    links to that range (launched inside it), over the calls. With
    ``names``, every device entry's name too."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from flink_tpu_torch.kernels import fused_kernels as fk

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(RANGE_PREFIX + name):
                return fn(*a, **k)
        return call

    with contextlib.ExitStack() as undo:
        for name in RANGED_WRAPPERS:
            fn = getattr(fk, name)
            setattr(fk, name, ranged(name, fn))
            undo.callback(setattr, fk, name, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run()
    # device-side entries only (kernels, memcpy, memset): a host op such
    # as aten::copy_ also carries its kernels' time, which would count
    # twice
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(RANGE_PREFIX)):
            by_name[e.key] = {"device_ms": us / 1e3, "count": e.count}
    busy_ms = sum(v["device_ms"] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["device_ms"])[:12]
    copies = {k: v for k, v in by_name.items() if k.startswith("Memcpy")}
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / (wall * 1e3)
                                  if busy_ms > 0 else "not measured"),
            "device_ms_per_call": device_ms_per_call(by_name),
            "device_ms_by_wrapper": device_ms_by_wrapper(by_name),
            "kernels_per_call": kernels_per_call(by_name, own),
            "ranged_per_call": ranged_per_call(torch, prof.events()),
            "call_kernel_counts": {
                w: sum(v["count"] for v in kernel_hits(by_name, names))
                for w, names in CALL_KERNELS.items()},
            **({"kernel_names": sorted(by_name)} if names else {}),
            "copies": copies, "top_device_ms": dict(top)}


RANGE_PREFIX = "chip_smoke:"


def ranged_per_call(torch, events):
    """{wrapper: {"calls", "kernels_per_call", "device_ms", "span_ms"}}
    over the profiler ranges of ``profile_run``. The profiler marks each
    range on the device's timeline too, from the first to the last
    kernel launched inside it; every launch is on one stream, so the
    kernels within that mark are the range's own. ``device_ms`` is their
    summed time per call, ``span_ms`` the mark's length per call (idle
    gaps between the kernels included)."""
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(RANGE_PREFIX)
               and not e.name.startswith(("Memcpy", "Memset"))]
    out = {}
    for m in dev:
        if not m.name.startswith(RANGE_PREFIX):
            continue
        lo, hi = m.time_range.start, m.time_range.end
        inside = [k for k in kernels
                  if k.time_range.start >= lo and k.time_range.end <= hi]
        row = out.setdefault(m.name[len(RANGE_PREFIX):],
                             {"calls": 0, "kernels": 0, "device_us": 0.0,
                              "span_us": 0.0})
        row["calls"] += 1
        row["kernels"] += len(inside)
        row["device_us"] += sum(k.time_range.end - k.time_range.start
                                for k in inside)
        row["span_us"] += hi - lo
    return {name: {"calls": r["calls"],
                   "kernels_per_call": r["kernels"] / r["calls"],
                   "device_ms": r["device_us"] / 1e3 / r["calls"],
                   "span_ms": r["span_us"] / 1e3 / r["calls"]}
            for name, r in out.items()}


def profile_devgen(torch, np, conf_path, cfg):
    """``profile_run`` over a devgen Q5 run of ``cfg`` at the headline
    conf."""
    from flink_tpu_torch.config import Configuration

    out = profile_run(torch, lambda: run_devgen_q5(
        torch, np, Configuration.from_file(conf_path), cfg,
        "q5-devgen-profiled")[3], own=("topn_select_append", "devgen_ingest"))
    return {"logical_batches": cfg.n_batches, **out}


def kernel_hits(by_name, names):
    """The profiler's entries of the CUDA kernels ``names``."""
    return [v for k, v in by_name.items()
            if any(f"::{kn}(" in k or f"::{kn}<" in k
                   or k.startswith(kn + "(") for kn in names)]


def device_ms_by_wrapper(by_name):
    """Each wrapper's CUDA kernels' device ms over the profiled run."""
    out = {}
    for name, kernels in PROFILED_KERNELS.items():
        ms = sum(v["device_ms"] for v in kernel_hits(by_name, kernels))
        if ms:
            out[name] = ms
    return out


def kernels_per_call(by_name, own=()):
    """Device kernels a wrapper call over the profiled run, for the
    wrappers whose kernels no other wrapper launches (and ``own``, whose
    kernels no other wrapper launches on this run): their profiled count
    over the run's ``window_kernels.LAUNCHES`` (one a wrapper call; every
    run zeroes them at its start)."""
    from flink_tpu_torch.kernels import window_kernels as wk

    out = {}
    for name in ONE_CALL_WRAPPERS + tuple(own):
        calls = wk.LAUNCHES[name]
        if calls:
            out[name] = sum(v["count"] for v in kernel_hits(
                by_name, PROFILED_KERNELS[name])) / calls
    return out


def device_ms_per_call(by_name):
    """Device ms per wrapper call: its CUDA kernels' total over the calls
    (topn_select_append and topn_select_lanes launch several a call)."""
    per_call = {}
    for name, kernels in PROFILED_KERNELS.items():
        calls = sum(v["count"] for v in kernel_hits(
            by_name, CALL_KERNELS.get(name, kernels)))
        if calls:
            per_call[name] = sum(v["device_ms"] for v in kernel_hits(
                by_name, kernels)) / calls
    return per_call


def phase_q5_devgen(torch, np):
    from flink_tpu_torch.config import Configuration, PipelineOptions
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig

    path = os.path.join(ROOT, "confs", "bench_q5_headline.conf")
    conf = Configuration.from_file(path)
    check(int(conf.get(PipelineOptions.MICROBATCH_SIZE)) == DEVGEN_BATCH
          and int(conf.get(PipelineOptions.SUB_BATCHES)) == DEVGEN_SUB,
          "confs/bench_q5_headline.conf is not the headline shape")
    cfg = NexmarkConfig(batch_size=DEVGEN_BATCH, n_batches=DEVGEN_BATCHES,
                        events_per_ms=100, num_active_auctions=10_000,
                        hot_ratio=4)

    def golden(n_logical):
        return devgen_golden(np, dataclasses.replace(cfg, n_batches=n_logical))

    # one short warm-up run at the same shapes (first-use allocations:
    # pinned buffers, the emit ring, the caching allocator's blocks),
    # then DEVGEN_RUNS timed runs, each checked in full
    run_devgen_q5(torch, np, conf,
                  dataclasses.replace(cfg, n_batches=2), "q5-devgen-warmup")
    n_steps = DEVGEN_BATCHES * DEVGEN_SUB
    events = DEVGEN_BATCH * DEVGEN_BATCHES
    on_path = ("devgen_ingest", "window_counts", "topn_select_append",
               "ring_columns")
    runs = []
    for i in range(DEVGEN_RUNS):
        rows, launches, res, wall = run_devgen_q5(torch, np, conf, cfg,
                                                  f"nexmark-q5-devgen-{i}")
        missing = [k for k in on_path if launches[k] == 0]
        check(not missing,
              f"kernels not launched on the devgen path: {missing}")
        # a sub-batch's bids made inside its ingest: one launch
        check(launches["devgen_ingest"] == n_steps
              and launches["nexmark_bids"] == 0,
              f"expected {n_steps} launches of devgen_ingest and none of "
              f"nexmark_bids, got {launches}")
        check(res.metrics["devgen_host_batches"] == 0,
              f"{res.metrics['devgen_host_batches']} batches went to the host")
        check(res.metrics["records_in"] == events,
              f"records_in {res.metrics['records_in']} != {events}")
        check(len(rows) == len(set(rows)), "duplicate committed rows")
        runs.append((wall, rows, launches, res))
    # the golden's numpy work (GBs of temporaries) comes after the timed
    # runs, so that it cannot slow them
    expect = golden(DEVGEN_BATCHES)
    for i, (_, rows, _, _) in enumerate(runs):
        got = set(rows)
        check(got == expect,
              f"devgen Q5 run {i}: rows differ from the golden: "
              f"{len(got - expect)} extra, {len(expect - got)} missing of "
              f"{len(expect)}")
    rates = [events / r[0] for r in runs]
    wall, rows, launches, res = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    busy = {k.split(".")[-1]: v for k, v in res.metrics.items()
            if k.startswith("device_busy_ms.")}
    host = {k.split(".", 2)[-1]: v for k, v in res.metrics.items()
            if k.startswith("profile.")}
    out = {"phase": "q5_devgen", "conf": "confs/bench_q5_headline.conf",
           "events": events, "logical_batches": DEVGEN_BATCHES,
           "sub_batches": DEVGEN_SUB, "runs": DEVGEN_RUNS,
           "events_per_s_runs": rates,
           "events_per_s": events / wall, "wall_s": wall,
           "wall_ms_per_step": wall * 1e3 / n_steps, "rows": len(rows),
           "windows": len({w for _, w, _ in rows}), "launches": launches,
           "devgen_host_batches": res.metrics["devgen_host_batches"],
           "device_busy_ms": busy,
           "device_busy_ms_per_step": {k: v / n_steps for k, v in busy.items()},
           "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
           "host_profile_s": host,
           "host_ms_per_step": {k: v * 1e3 / n_steps for k, v in host.items()}}

    # the same 4 logical batches at K = 1 (a 64-column pane ring) and
    # K = 4: equal to the golden, and window by window in the same order
    short = dataclasses.replace(cfg, n_batches=DEVGEN_K_BATCHES)
    by_k = {}
    for k in (1, DEVGEN_SUB):
        ck = Configuration.from_file(path).set(PipelineOptions.SUB_BATCHES, k)
        r, l, rk, w = run_devgen_q5(torch, np, ck, short, f"q5-devgen-k{k}")
        check(rk.metrics["devgen_host_batches"] == 0,
              f"K={k}: {rk.metrics['devgen_host_batches']} host batches")
        check(l["devgen_ingest"] == DEVGEN_K_BATCHES * k
              and l["nexmark_bids"] == 0,
              f"K={k}: {l['devgen_ingest']} devgen_ingest and "
              f"{l['nexmark_bids']} nexmark_bids launches")
        by_k[k] = (r, w)
    expect4 = golden(DEVGEN_K_BATCHES)
    r1, r4 = by_k[1][0], by_k[DEVGEN_SUB][0]
    check(set(r1) == expect4 and len(r1) == len(expect4),
          "K=1 rows differ from the golden")
    check(set(r4) == expect4 and len(r4) == len(expect4),
          "K=4 rows differ from the golden")
    # a fire appends rows row-major over all its window ends, so a K = 1
    # advance (~40 ends) and four K = 4 advances (~10 ends each) commit
    # the same rows in another interleave; each window's rows keep one
    # order
    per_window = (sorted(r1, key=lambda r: r[1])
                  == sorted(r4, key=lambda r: r[1]))
    check(per_window, "K=1 and K=4 rows differ window by window")
    out["profiled"] = profile_devgen(torch, np, path, short)
    # the whole-card top-1: its max and its selection, two kernels a call
    per = out["profiled"]["kernels_per_call"].get("topn_select_append")
    check(per == wk.topn_plan(128 * 256 + 1, 11, 1).kernels,
          f"q5_devgen: topn_select_append kernels a call {per}")
    # the ingest makes its bids: one kernel a sub-batch, no generator's
    per = out["profiled"]["kernels_per_call"].get("devgen_ingest")
    gen = out["profiled"]["device_ms_by_wrapper"].get("nexmark_bids")
    check(per == 1 and gen is None,
          f"q5_devgen: devgen_ingest kernels a call {per}, "
          f"nexmark_bids_kernel device ms {gen}")
    out["k_compare"] = {
        "logical_batches": DEVGEN_K_BATCHES, "rows": len(r1),
        "equal_window_by_window": per_window,
        "equal_in_commit_order": r1 == r4,
        "events_per_s": {str(k): DEVGEN_BATCH * DEVGEN_K_BATCHES / w
                         for k, (_, w) in by_k.items()}}
    emit(out)
    return launches, out["profiled"]["device_ms_per_call"]


CKPT_DEVGEN_BATCHES = 16        # the checkpoint phase: headline logical batches
CKPT_HOST_BATCHES = 16          # Q5 host-fed, 2^20 bids each
CKPT_WW_BATCHES = 8             # WindowWordCount, 2^20 words each
CKPT_FAULT = "checkpoint.storage.write=raise x1 +2"
_DEVGEN_GOLDEN = {}


def devgen_golden(np, cfg):
    """Q5's golden rows over ``cfg``'s device-made bids (kept: the
    q5_devgen and checkpoint phases share it)."""
    from flink_tpu_torch.nexmark.generator import bid_stream_device

    key = (cfg.batch_size, cfg.n_batches, cfg.events_per_ms,
           cfg.num_active_auctions, cfg.hot_ratio)
    if key not in _DEVGEN_GOLDEN:
        src = bid_stream_device(cfg)
        _DEVGEN_GOLDEN[key] = q5_golden(
            np, (src.keys_ts_host(i) for i in range(cfg.n_batches)),
            cfg.num_active_auctions, window_panes=10, pane_ms=1000)
    return _DEVGEN_GOLDEN[key]


def ms_stats(np, values):
    vals = [v for v in values if v is not None]
    if not vals:
        return {"n": 0, "p50": None, "max": None}
    return {"n": len(vals), "p50": float(np.median(vals)),
            "max": float(max(vals))}


def run_checkpointed(torch, np, build, conf, label, root, mode, limit=0,
                     fault=CKPT_FAULT):
    """One job through ``run_with_recovery`` into a
    ``TransactionalCollectSink``: mode 'none' without checkpoints (the
    final commit at end of input), 'clean' with a checkpoint at every
    batch boundary once the last is durable (interval 1 ms), 'chaos'
    the same with the faults ``fault`` (``CKPT_FAULT``, a storage write,
    by default) and a sink that fails
    its attempt at ``limit`` rows; each failure restarts the job from
    its latest checkpoint. Returns the committed rows in commit order,
    the wall seconds, the launches and the checkpoint figures."""
    from flink_tpu_torch import faults
    from flink_tpu_torch.api.sinks import TransactionalCollectSink
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.obs.tracing import tracer
    from flink_tpu_torch.runtime.supervisor import run_with_recovery

    class PoisonedSink(TransactionalCollectSink):
        seen = 0
        fired = False

        def write(self, batch):
            super().write(batch)
            self.seen += len(next(iter(batch.values())))
            if mode == "chaos" and not self.fired and self.seen >= limit:
                self.fired = True
                raise RuntimeError(f"{label}: poisoned sink at {self.seen} rows")

    values = dict(conf.to_dict(), **{
        "execution.checkpointing.dir": root,
        "execution.checkpointing.interval": 0 if mode == "none" else 1,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 5 if mode == "chaos" else 0,
        "restart-strategy.fixed-delay.delay": 1})
    if mode == "chaos":
        values.update({"faults.inject": fault, "faults.seed": SEED})
    sink = PoisonedSink()
    envs = []

    def build_env(c):
        envs.append(build(c, sink))
        return envs[-1]

    tracer.clear()
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        res = run_with_recovery(build_env, Configuration(values),
                                job_name=label)
        torch.cuda.synchronize()
    finally:
        faults.clear()
    wall = time.perf_counter() - t0
    launches = dict(wk.LAUNCHES)
    barrier = [s["duration_ms"] for s in tracer.spans("checkpoint.barrier")]
    freeze = [s["duration_ms"] for s in tracer.spans("checkpoint.freeze")]
    persists = [s for s in tracer.spans("checkpoint.persist")
                if "error" not in s["attributes"]]
    positions = []
    if mode != "none":
        for h in FsCheckpointStorage(root, label).list_complete():
            payload = FsCheckpointStorage.load(h)
            positions.append({
                "id": int(payload["checkpoint_id"]),
                # the changelog files (LSM runs) it hardlinked
                "aux_files": sum(len(m) for m in
                                 payload.get("op_aux_paths", {}).values()),
                "sub_factors": {str(k): int(v) for k, v in
                                payload.get("sub_factors", {}).items()},
                "positions": [int(p) for pos in payload["sources"].values()
                              for p in pos.values()]})
    coord = envs[-1]._driver._coordinator
    figures = {
        "attempts": len(envs),
        "recoveries": len(tracer.spans("recovery")),
        "injected": [s["attributes"]["point"] for s in tracer.spans("fault")],
        "checkpoints_completed": len(coord.stats) if coord else 0,
        "checkpoints_failed": len([s for s in tracer.spans("checkpoint.persist")
                                   if "error" in s["attributes"]]),
        # the loop thread's part of each checkpoint: its fire drain
        # (which waits for the steps in flight) and its freeze
        "loop_ms": ms_stats(np, [a + b for a, b in zip(barrier, freeze)]),
        "barrier_ms": ms_stats(np, barrier),
        "freeze_ms": ms_stats(np, freeze),
        # the last attempt's loop seconds in periodic checkpoints and in
        # the synchronous end-of-input one
        "loop_s": res.metrics.get("profile.driver.checkpoint_freeze", 0.0),
        "final_checkpoint_s": res.metrics.get(
            "profile.driver.checkpoint_final", 0.0),
        "persist_ms": ms_stats(np, [s["duration_ms"] for s in persists]),
        "bytes_per_checkpoint": ms_stats(
            np, [s["attributes"].get("bytes") for s in persists]),
        "retained": positions,
    }
    rows = [tuple(sorted((k, v.item() if hasattr(v, "item") else v)
                         for k, v in r.items())) for r in sink.committed]
    return rows, wall, launches, figures


def checkpoint_job(torch, np, name, build, conf, events, check_rows, on_path,
                   root, fault=CKPT_FAULT,
                   injected=("checkpoint.storage.write",)):
    """A job without checkpoints, with them, with them under faults,
    without again and with again (the second, warm runs give the rates
    printed side by side); the chaos run's committed rows must equal the
    clean run's in order, and all of them the golden; every fault point
    in ``injected`` must have fired."""
    runs = {}
    for mode in ("none", "clean", "chaos", "none-again", "clean-again"):
        m = mode.split("-")[0]
        limit = (len(runs["clean"][0]) // 3) if m == "chaos" else 0
        runs[mode] = run_checkpointed(
            torch, np, build, conf, f"ckpt-{name}-{mode}",
            os.path.join(root, f"{name}-{mode}"), m, limit=limit,
            fault=fault)
    none_rows, none_wall, _, _ = runs["none-again"]
    rows, wall, launches, fig = runs["clean-again"]
    c_rows, c_wall, c_launches, c_fig = runs["chaos"]
    check_rows(rows, f"checkpoint {name} clean")
    check(rows == runs["none"][0] == none_rows == runs["clean"][0],
          f"checkpoint {name}: rows with checkpoints differ from without")
    check(c_rows == rows,
          f"checkpoint {name}: the crashed and resumed run committed "
          f"{len(c_rows)} rows, the fault-free run {len(rows)}, or another "
          "order")
    check(c_fig["recoveries"] >= 1 and set(injected) <= set(c_fig["injected"]),
          f"checkpoint {name}: the chaos run did not crash as planned: {c_fig}")
    check(fig["checkpoints_completed"] > 1,
          f"checkpoint {name}: {fig['checkpoints_completed']} checkpoints")
    missing = [k for k in on_path if launches[k] == 0 or c_launches[k] == 0]
    check(not missing, f"checkpoint {name}: kernels not launched {missing}")
    return {"job": name, "events": events, "rows": len(rows),
            "events_per_s_with_checkpoints": events / wall,
            "events_per_s_without": events / none_wall,
            "events_per_s_first_runs": {
                "without": events / runs["none"][1],
                "with": events / runs["clean"][1]},
            "wall_s": {m: r[1] for m, r in runs.items()},
            "clean": fig, "clean_first_run": runs["clean"][3], "chaos": c_fig,
            "launches": {k: launches[k] for k in on_path}}


def phase_checkpoint(torch, np):
    """Exactly-once checkpoints on the card: three jobs crash and resume
    through the port's coordinator, storage and restart supervisor into
    a TransactionalCollectSink (see the module docstring)."""
    import shutil

    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import (
        NexmarkConfig, bid_stream, bid_stream_device)
    from flink_tpu_torch.nexmark.queries import q5_hot_items
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "flink_tpu_torch", "_build", "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    jobs = []
    q5_cols = ("auction", "window_end", "bid_count")

    def q5_view(rows):
        return [tuple(dict(r)[c] for c in q5_cols) for r in rows]

    # 1. the headline: bids made on the card, 4 sub-batches
    dcfg = NexmarkConfig(batch_size=DEVGEN_BATCH,
                         n_batches=CKPT_DEVGEN_BATCHES, events_per_ms=100,
                         num_active_auctions=10_000, hot_ratio=4)
    dconf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_headline.conf"))

    def build_devgen(c, sink):
        env = StreamExecutionEnvironment(c)
        q5_hot_items(env, bid_stream_device(dcfg), sink, window_ms=10_000,
                     slide_ms=1_000, out_of_orderness_ms=1_000)
        return env

    def check_devgen(rows, label):
        got = q5_view(rows)
        check(len(got) == len(set(got)) and set(got) == devgen_golden(np, dcfg),
              f"{label}: rows differ from the golden")

    out = checkpoint_job(
        torch, np, "q5_devgen", build_devgen, dconf,
        DEVGEN_BATCH * CKPT_DEVGEN_BATCHES, check_devgen,
        ("devgen_ingest", "window_counts", "topn_select_append",
         "ring_columns"), root)
    ran = ("clean_first_run", "clean", "chaos")
    mid = sum(1 for r in ran for c in out[r]["retained"]
              for p in c["positions"] if p % DEVGEN_SUB)
    check(all(c["sub_factors"] == {"0": DEVGEN_SUB}
              for r in ran for c in out[r]["retained"]),
          "q5_devgen: a checkpoint without the sub-batch factor 4")
    # a checkpoint's positions count sub-batches; the retained ones of a
    # run are its last three, so the run's own record says it too
    out["mid_logical_batch_checkpoints"] = mid
    check(mid > 0, "q5_devgen: no completed checkpoint cut a logical batch")
    jobs.append(out)

    # 2. Q5 host-fed on the native lane
    hcfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=CKPT_HOST_BATCHES,
                         events_per_ms=100, num_active_auctions=10_000,
                         hot_ratio=4)
    hconf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))

    def build_host(c, sink):
        env = StreamExecutionEnvironment(c)
        q5_hot_items(env, bid_stream(hcfg), sink, window_ms=10_000,
                     slide_ms=1_000, out_of_orderness_ms=1_000)
        return env

    jobs.append(checkpoint_job(
        torch, np, "q5_host_fed", build_host, hconf,
        Q5_BATCH * CKPT_HOST_BATCHES,
        lambda rows, label: check_q5_rows(np, q5_view(rows), hcfg, label),
        ("fused_step", "apply_pairs_u32", "window_counts",
         "topn_select_append", "ring_columns"), root))

    # 3. WindowWordCount: count_window(250).sum("n"), the count window's
    # five-array snapshot through the same storage
    wconf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_wordcount.conf"))

    def build_ww(c, sink):
        env = StreamExecutionEnvironment(c)
        (env.from_source(window_wordcount_source(np, CKPT_WW_BATCHES),
                         WatermarkStrategy.for_bounded_out_of_orderness(0))
         .key_by("word").count_window(CW_SIZE).sum("n").add_sink(sink))
        return env

    def check_ww(rows, label):
        want = sorted((int(k), int(c), float(c)) for keys, counts in
                      window_wordcount_golden(np, CKPT_WW_BATCHES)
                      for k, c in zip(keys, counts))
        got = sorted((d["key"], d["count"], d["sum_n"])
                     for d in map(dict, rows))
        check(got == want, f"{label}: rows differ from the golden")

    jobs.append(checkpoint_job(
        torch, np, "window_wordcount", build_ww, wconf,
        WC_BATCH * CKPT_WW_BATCHES, check_ww,
        ("scatter_lanes", "count_fire"), root))

    # 4. sessions (BASELINE config #4's shape) at host.parallelism 4: a
    # host pool task and a storage write fail, and the poisoned sink
    sgen = session_gen(np, CKPT_SESSION_BATCHES, SESSION_BATCH,
                       SESSION_USERS)
    sconf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_sessions.conf"))
    sconf.set("host.parallelism", 4)
    sgolden = sessions_golden(np, sgen, CKPT_SESSION_BATCHES)[0]

    def check_sessions(rows, label):
        cols = {f: np.array([dict(r)[f] for r in rows]) for f in
                ("key", "window_start", "window_end", "count")}
        got = final_session_rows(np, cols)
        check(got.shape == sgolden.shape and np.array_equal(got, sgolden),
              f"{label}: sessions differ from the golden")

    jobs.append(checkpoint_job(
        torch, np, "sessions",
        lambda c, sink: build_sessions(sgen, sink, c), sconf,
        SESSION_BATCH * CKPT_SESSION_BATCHES, check_sessions, (), root,
        fault=f"{CKPT_FAULT};{CKPT_POOL_FAULT}",
        injected=("checkpoint.storage.write", "host.pool.task")))
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "checkpoint", "jobs": jobs,
          "note": "events/s with and without checkpoints are smoke "
                  "figures of single runs, not a benchmark",
          "fault": CKPT_FAULT, "sessions_fault": CKPT_POOL_FAULT,
          "phase_s": time.perf_counter() - t_phase,
          "card": card_line()})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def busy_and_host(res):
    busy = {k.split(".")[-1]: v for k, v in res.metrics.items()
            if k.startswith("device_busy_ms.")}
    host = {k.split(".", 2)[-1]: v for k, v in res.metrics.items()
            if k.startswith("profile.")}
    return busy, host


def wordcount_source(np, n_batches):
    """bench.py:441-478's WordCount source: 2^20 word ids a batch,
    floor(u^2 * 30,000) from default_rng(i), ts = (i * 2^20 + j) // 100."""
    from flink_tpu_torch.api.sources import GeneratorSource

    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(i)
        u = rng.random(WC_BATCH)
        words = (u * u * WC_VOCAB).astype(np.int64)
        ts = (i * WC_BATCH + np.arange(WC_BATCH, dtype=np.int64)) // 100
        return ({"word": words}, ts)
    return GeneratorSource(gen), gen


def run_wordcount(torch, np, n_batches, label):
    """WordCount through the port's ``env.execute()`` at
    confs/bench_wordcount.conf: (rows as (key, window_end, count)
    arrays, launches, JobResult, wall seconds)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    env = StreamExecutionEnvironment(Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_wordcount.conf")))
    parts = []
    src, _ = wordcount_source(np, n_batches)
    (env.from_source(src, WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by("word").window(TumblingEventTimeWindows.of(1000)).count()
     .add_sink(FnSink(lambda b: parts.append(
         [np.asarray(b[k]).copy() for k in ("key", "window_end", "count")]))))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [np.concatenate([p[j] for p in parts]) for j in range(3)]
    return rows, dict(wk.LAUNCHES), res, wall


def wordcount_golden(np, n_batches):
    """Per-(word, 1 s window) counts of the first ``n_batches`` batches,
    as (key, window_end, count) sorted by (window_end, key)."""
    _, gen = wordcount_source(np, n_batches)
    hist = None
    for i in range(n_batches):
        words, ts = gen("0", i)
        cell = (ts // 1000) * WC_VOCAB + words["word"]
        h = np.bincount(cell, minlength=(int(ts[-1]) // 1000 + 1) * WC_VOCAB)
        if hist is None:
            hist = h
        else:
            hist = np.pad(hist, (0, len(h) - len(hist))) + h
    nz = np.flatnonzero(hist)
    return (nz % WC_VOCAB, (nz // WC_VOCAB + 1) * 1000,
            hist[nz].astype(np.int32))


def check_wordcount(np, rows, golden, label):
    key, end, cnt = rows
    order = np.lexsort((key, end))
    got = (key[order], end[order], cnt[order])
    check(len(key) == len(golden[0])
          and all(np.array_equal(g, w) for g, w in zip(got, golden)),
          f"{label}: rows differ from the golden ({len(key)} rows, "
          f"{len(golden[0])} expected)")


def phase_wordcount(torch, np):
    """BASELINE.json config #0 at its full shape through ``env.execute()``:
    one warm-up run of 4 batches, then timed runs of 24 batches of 2^20
    words, each checked in full against the numpy golden."""
    from flink_tpu_torch.config import Configuration, PipelineOptions, StateOptions

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_wordcount.conf"))
    check(int(conf.get(PipelineOptions.MICROBATCH_SIZE)) == WC_BATCH
          and int(conf.get(StateOptions.NUM_KEY_SHARDS)) == 128
          and int(conf.get(StateOptions.SLOTS_PER_SHARD)) == 512
          and int(conf.get(PipelineOptions.MAX_INFLIGHT_STEPS)) == 1,
          "confs/bench_wordcount.conf is not the WordCount shape")
    rows, _, _, _ = run_wordcount(torch, np, WC_WARMUP_BATCHES, "wc-warmup")
    check_wordcount(np, rows, wordcount_golden(np, WC_WARMUP_BATCHES),
                    "wordcount warm-up")
    runs = []
    for i in range(WC_RUNS):
        rows, launches, res, wall = run_wordcount(torch, np, WC_BATCHES,
                                                  f"wordcount-{i}")
        missing = [k for k in ("scatter_counts", "apply_pairs_u32",
                               "fire_pack", "ring_columns")
                   if launches[k] == 0]
        check(not missing, f"kernels not launched on WordCount: {missing}")
        runs.append((wall, rows, launches, res))
    # the golden's numpy work comes after the timed runs
    golden = wordcount_golden(np, WC_BATCHES)
    for i, (_, rows, _, _) in enumerate(runs):
        check_wordcount(np, rows, golden, f"wordcount run {i}")
    events = WC_BATCH * WC_BATCHES
    wall, rows, launches, res = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    busy, host = busy_and_host(res)
    prof = profile_run(torch, lambda: run_wordcount(
        torch, np, WC_WARMUP_BATCHES, "wordcount-profiled")[3])
    check(prof["kernels_per_call"].get("fire_pack") == 1,
          f"wordcount: fire_pack kernels a call {prof['kernels_per_call']}")
    out = {"phase": "wordcount", "conf": "confs/bench_wordcount.conf",
           "events": events, "batches": WC_BATCHES, "runs": WC_RUNS,
           "events_per_s_runs": [events / r[0] for r in runs],
           "events_per_s": events / wall, "wall_s": wall,
           "rows": len(rows[0]), "windows": int(len(np.unique(rows[1]))),
           "rows_per_window": len(rows[0]) / len(np.unique(rows[1])),
           "launches": launches, "device_busy_ms": busy,
           "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
           "host_profile_s": host,
           "profiled": {"batches": WC_WARMUP_BATCHES, **prof},
           "card": card_line()}
    emit(out)
    return launches, prof["device_ms_per_call"]


# the bid-aggregate golden's bound on a sum or avg, relative to the exact
# (f64) value of positive prices: each f32 add of the ingest (at most two
# a record: the host combine's rounding and the add into the pane),
# each of the fire's ring-column adds (at most 32 columns) and the avg's
# division round once by at most 2^-24 of the running total
def agg_rel_bound(count):
    return (2.0 * count + 34.0) * 2.0 ** -24


def run_bid_agg(torch, np, which, n_batches, label, mesh=None):
    """Job (a) multi(count, sum, max, min) or (b) multi(count, avg) of
    price per auction, sliding 10 s / 1 s, 1 s out-of-orderness, on the
    Q5 host-fed bids at confs/bench_q5_host_fed.conf (over ``mesh``, a
    mesh of device blocks, when given): (rows, launches, JobResult,
    wall)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    cfg = NexmarkConfig(batch_size=Q5_BATCH, n_batches=n_batches,
                        events_per_ms=100, num_active_auctions=10_000,
                        hot_ratio=4)
    agg = (ta.multi(ta.count(), ta.sum_of("price"), ta.max_of("price"),
                    ta.min_of("price")) if which == "a"
           else ta.multi(ta.count(), ta.avg_of("price")))
    env = StreamExecutionEnvironment(Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf")))
    parts = []
    (env.from_source(bid_stream(cfg),
                     WatermarkStrategy.for_bounded_out_of_orderness(1_000))
     .key_by("auction").window(SlidingEventTimeWindows.of(10_000, 1_000))
     .aggregate(agg)
     .add_sink(FnSink(lambda b: parts.append(
         {k: np.asarray(v).copy() for k, v in b.items()}))))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda", mesh_plan=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return rows, dict(wk.LAUNCHES), res, wall, cfg


def bid_golden(np, cfg):
    """Per-(auction, window end pane) count, f64 sum, max and min of
    price over sliding 10 s / 1 s windows: (n_auctions, n_ends) arrays,
    end pane e covering panes [e - 10, e)."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    n_a = cfg.num_active_auctions
    n_p = (cfg.batch_size * cfg.n_batches - 1) // cfg.events_per_ms // 1000 + 1
    cnt = np.zeros(n_a * n_p, np.int64)
    tot = np.zeros(n_a * n_p, np.float64)
    mx = np.full(n_a * n_p, -np.inf, np.float32)
    mn = np.full(n_a * n_p, np.inf, np.float32)
    for i in range(cfg.n_batches):
        data, ts = bid_batch(cfg, 0, i)
        cell = data["auction"] * n_p + ts // 1000
        cnt += np.bincount(cell, minlength=n_a * n_p)
        tot += np.bincount(cell, weights=data["price"].astype(np.float64),
                           minlength=n_a * n_p)
        np.maximum.at(mx, cell, data["price"])
        np.minimum.at(mn, cell, data["price"])
    shape = (n_a, n_p)
    cnt, tot, mx, mn = (x.reshape(shape) for x in (cnt, tot, mx, mn))
    n_e = n_p + 10
    out = {"count": np.zeros((n_a, n_e), np.int64),
           "sum": np.zeros((n_a, n_e)),
           "max": np.full((n_a, n_e), -np.inf, np.float32),
           "min": np.full((n_a, n_e), np.inf, np.float32)}
    for e in range(1, n_e):
        lo, hi = max(e - 10, 0), min(e, n_p)
        out["count"][:, e] = cnt[:, lo:hi].sum(axis=1)
        out["sum"][:, e] = tot[:, lo:hi].sum(axis=1)
        out["max"][:, e] = mx[:, lo:hi].max(axis=1)
        out["min"][:, e] = mn[:, lo:hi].min(axis=1)
    return out


def check_bid_agg(np, which, rows, golden, label):
    a = rows["key"].astype(np.int64)
    e = rows["window_end"] // 1000
    check(len(set(zip(a.tolist(), e.tolist()))) == len(a),
          f"{label}: duplicate (auction, window) rows")
    check(len(a) == int((golden["count"] > 0).sum()),
          f"{label}: {len(a)} rows, expected {int((golden['count'] > 0).sum())}")
    check(np.array_equal(rows["count"], golden["count"][a, e]),
          f"{label}: counts differ from the golden")
    cnt = golden["count"][a, e]
    exact = golden["sum"][a, e]
    if which == "a":
        check(np.array_equal(rows["max_price"], golden["max"][a, e])
              and np.array_equal(rows["min_price"], golden["min"][a, e]),
              f"{label}: max/min differ from the golden")
        got, want = rows["sum_price"].astype(np.float64), exact
    else:
        got = rows["avg_price"].astype(np.float64)
        want = exact / np.maximum(cnt, 1)
    rel = np.abs(got - want) / np.abs(want)
    check(bool((rel <= agg_rel_bound(cnt)).all()),
          f"{label}: sums outside the bound (max rel err {float(rel.max())})")
    return float(rel.max()), float((rel / agg_rel_bound(cnt)).max())


def phase_bid_aggs(torch, np):
    """Jobs (a) and (b) on 16 batches of 2^20 bids (after a 2-batch
    warm-up each), checked against the numpy golden."""
    out = {"phase": "bid_aggs", "conf": "confs/bench_q5_host_fed.conf",
           "events": Q5_BATCH * AGG_BATCHES, "batches": AGG_BATCHES,
           "rel_bound": "(2 * count + 34) * 2^-24"}
    launches_by_job, per_call = {}, {}
    runs = {}
    for which, path_kernel in (("a", "scatter_lanes"),
                               ("b", "scatter_pair_lanes")):
        run_bid_agg(torch, np, which, 2, f"bid-agg-{which}-warmup")
        rows, launches, res, wall, cfg = run_bid_agg(
            torch, np, which, AGG_BATCHES, f"bid-agg-{which}")
        missing = [k for k in (path_kernel, "fire_pack", "ring_columns")
                   if launches[k] == 0]
        check(not missing, f"job ({which}): kernels not launched: {missing}")
        if which == "a":
            # per record into 32,769 rows: the split upload, its bytes
            # decoded inside one scatter_lanes a batch
            check(launches["split_cells"] == 0
                  and launches["scatter_lanes"] == AGG_BATCHES,
                  f"job (a): split_cells {launches['split_cells']}, "
                  f"scatter_lanes {launches['scatter_lanes']} launches")
        runs[which] = (rows, cfg)
        busy, host = busy_and_host(res)
        prof = profile_run(torch, lambda: run_bid_agg(
            torch, np, which, 4, f"bid-agg-{which}-profiled")[3])
        check(prof["kernels_per_call"].get("fire_pack") == 1,
              f"job ({which}): fire_pack kernels a call "
              f"{prof['kernels_per_call']}")
        for k, v in prof["device_ms_per_call"].items():
            per_call.setdefault(k, v)
        launches_by_job[which] = launches
        out[which] = {"events_per_s": Q5_BATCH * AGG_BATCHES / wall,
                      "wall_s": wall, "rows": len(rows["key"]),
                      "windows": int(len(np.unique(rows["window_end"]))),
                      "launches": launches, "device_busy_ms": busy,
                      "device_idle_share":
                          1.0 - sum(busy.values()) / (wall * 1e3),
                      "host_profile_s": host,
                      "profiled": {"batches": 4, **prof}}
    # one ring_columns launch a purge or growth of the state block,
    # whatever its lanes: the same count for job (a)'s four lanes as for
    # job (b)'s two (the same bids, conf and watermarks)
    purges = {k: v["ring_columns"] for k, v in launches_by_job.items()}
    check(purges["a"] == purges["b"],
          f"ring_columns launches differ between the jobs: {purges}")
    golden = bid_golden(np, runs["a"][1])
    for which, (rows, _) in runs.items():
        rel, share = check_bid_agg(np, which, rows, golden, f"job ({which})")
        out[which]["max_rel_err"] = rel
        out[which]["max_share_of_bound"] = share
    out["card"] = card_line()
    emit(out)
    return launches_by_job, per_call


def window_wordcount_source(np, n_batches):
    """``wordcount_source``'s words, each carrying ``n = 1`` (the
    upstream example's ``Tuple2(word, 1)``)."""
    from flink_tpu_torch.api.sources import GeneratorSource

    _, words = wordcount_source(np, n_batches)
    ones = np.ones(WC_BATCH, np.int64)

    def gen(split, i):
        batch = words(split, i)
        if batch is None:
            return None
        data, ts = batch
        return ({"word": data["word"], "n": ones}, ts)
    return GeneratorSource(gen)


def run_window_wordcount(torch, np, n_batches, label, agg="sum"):
    """WindowWordCount through the port's ``env.execute()`` at
    confs/bench_wordcount.conf: ``count_window(250).sum("n")`` (or
    ``.count()``) keyed by word: (the sink's batches, launches,
    JobResult, wall seconds)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    env = StreamExecutionEnvironment(Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_wordcount.conf")))
    parts = []
    windows = (env.from_source(window_wordcount_source(np, n_batches),
                               WatermarkStrategy.for_bounded_out_of_orderness(0))
               .key_by("word").count_window(CW_SIZE))
    (windows.sum("n") if agg == "sum" else windows.count()).add_sink(
        FnSink(lambda b: parts.append(
            {k: np.asarray(v).copy() for k, v in b.items()})))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return parts, dict(wk.LAUNCHES), res, wall


def window_wordcount_golden(np, n_batches):
    """Per batch, the words whose count since their last fire reached 250
    by the batch's end (the trigger is checked at batch boundaries), as
    (words ascending, counts); their counts then restart."""
    _, gen = wordcount_source(np, n_batches)
    since = np.zeros(WC_VOCAB, np.int64)
    out = []
    for i in range(n_batches):
        data, _ = gen("0", i)
        since += np.bincount(data["word"], minlength=WC_VOCAB)
        fired = np.flatnonzero(since >= CW_SIZE)
        out.append((fired, since[fired].astype(np.int32)))
        since[fired] = 0
    return out


def check_window_wordcount(np, parts, golden, label, field=None):
    """Every emitted batch against its golden batch, as (key, count[,
    sum]) sorted by key; a batch that fires nothing emits nothing."""
    want = [g for g in golden if len(g[0])]
    check(len(parts) == len(want),
          f"{label}: {len(parts)} emitted batches, {len(want)} expected")
    for i, (part, (keys, counts)) in enumerate(zip(parts, want)):
        order = np.argsort(part["key"], kind="stable")
        ok = (np.array_equal(part["key"][order], keys)
              and np.array_equal(part["count"][order], counts)
              and np.all(part["window_end"] == 1 << 62))
        if field is not None:
            ok = ok and part[field].dtype == np.float32 and np.array_equal(
                part[field][order], counts.astype(np.float32))
        check(ok, f"{label}: emitted batch {i} differs from the golden")
    return sum(len(p["key"]) for p in parts)


def phase_window_wordcount(torch, np):
    """WindowWordCount (``count_window(250).sum("n")`` by word; the
    upstream example's slide of 150 dropped) on the WordCount stream and
    state at full width: one warm-up run of 4 batches, three timed runs
    of 24 batches of 2^20 words, every emitted batch checked against the
    numpy golden; then a ``count()`` job on 4 batches."""
    from flink_tpu_torch.config import Configuration, PipelineOptions, StateOptions

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_wordcount.conf"))
    check(int(conf.get(PipelineOptions.MICROBATCH_SIZE)) == WC_BATCH
          and int(conf.get(StateOptions.NUM_KEY_SHARDS)) == 128
          and int(conf.get(StateOptions.SLOTS_PER_SHARD)) == 512,
          "confs/bench_wordcount.conf is not the WordCount shape")
    parts, _, _, _ = run_window_wordcount(torch, np, WC_WARMUP_BATCHES,
                                          "ww-warmup")
    check_window_wordcount(np, parts, window_wordcount_golden(
        np, WC_WARMUP_BATCHES), "window_wordcount warm-up", "sum_n")
    runs = []
    for i in range(WC_RUNS):
        parts, launches, res, wall = run_window_wordcount(
            torch, np, WC_BATCHES, f"window-wordcount-{i}")
        missing = [k for k in ("scatter_lanes", "count_fire")
                   if launches[k] == 0]
        check(not missing, f"kernels not launched on WindowWordCount: "
              f"{missing}")
        runs.append((wall, parts, launches, res))
    # the golden's numpy work comes after the timed runs
    golden = window_wordcount_golden(np, WC_BATCHES)
    fired_rows = [check_window_wordcount(np, parts, golden,
                                         f"window_wordcount run {i}", "sum_n")
                  for i, (_, parts, _, _) in enumerate(runs)]
    events = WC_BATCH * WC_BATCHES
    wall, parts, launches, res = sorted(runs, key=lambda r: r[0])[len(runs) // 2]
    busy, host = busy_and_host(res)
    prof = profile_run(torch, lambda: run_window_wordcount(
        torch, np, WC_WARMUP_BATCHES, "window-wordcount-profiled")[3])
    per = prof["kernels_per_call"].get("count_fire")
    check(per == 1, f"window_wordcount: count_fire kernels a call {per}")
    c_parts, c_launches, _, c_wall = run_window_wordcount(
        torch, np, WC_WARMUP_BATCHES, "window-wordcount-count", agg="count")
    c_rows = check_window_wordcount(
        np, c_parts, window_wordcount_golden(np, WC_WARMUP_BATCHES),
        "window_wordcount count()")
    missing = [k for k in ("scatter_counts", "count_fire")
               if c_launches[k] == 0]
    check(not missing, f"kernels not launched on the count() job: {missing}")
    out = {"phase": "window_wordcount", "conf": "confs/bench_wordcount.conf",
           "job": f"key_by(word).count_window({CW_SIZE}).sum(n)",
           "events": events, "batches": WC_BATCHES, "runs": WC_RUNS,
           "events_per_s_runs": [events / r[0] for r in runs],
           "events_per_s": events / wall, "wall_s": wall,
           "fired_rows_runs": fired_rows,
           "emitted_batches": len(parts), "launches": launches,
           "device_busy_ms": busy,
           "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
           "host_profile_s": host,
           "profiled": {"batches": WC_WARMUP_BATCHES, **prof},
           "count_job": {"batches": WC_WARMUP_BATCHES, "rows": c_rows,
                         "wall_s": c_wall, "launches": c_launches},
           "card": card_line()}
    emit(out)
    return launches, prof["device_ms_per_call"]


def topn_lanes_inputs(torch, np, dev):
    """Job T's fire at the ``kernels`` phase's shapes: 32,769 rows, the
    32-column ring and 11-window fires of 10 s / 1 s windows after the
    first batch's growth, the lanes of ``multi(max_of("price"),
    avg_of("price"))`` (one sum, one max) for 10,000 auctions."""
    rng = np.random.default_rng(SEED + 6)
    rows, ring, ppw, W = 32_769, 32, 10, 11
    pane_lo, pane_hi = 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    counts, sums, maxs, _ = lane_state(np, rng, rows, ring, pane_lo, pane_hi,
                                       keys, (1, 1, 0), hot=100)
    used_np = np.zeros(rows, bool)
    used_np[keys] = True

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    ends = torch.arange(pane_hi - W + 2, pane_hi + 2, dtype=torch.int64,
                        device=dev)
    valid = torch.ones(W, dtype=torch.bool, device=dev)
    return {"rows": rows, "ring": ring, "ppw": ppw, "W": W,
            "pane_lo": pane_lo, "pane_hi": pane_hi, "counts": t(counts),
            "sums": t(sums), "maxs": t(maxs), "used": t(used_np),
            "ends": ends, "valid": valid,
            "lane_args": (t(sums), t(maxs), None, ends, valid, pane_lo,
                          pane_hi, ppw, rows)}


def topn_select_cases(torch, np, dev, inp, lanes, wc):
    """``topn_select_lanes``' two inputs at job T's fire (``inp``, its
    lanes ``lanes`` and window counts ``wc``): top-1 by max_price (the
    operator's finalize on the grid, two result columns) and job T's
    second run, top-3 by avg_price, which takes the threshold's later
    places; planted in the ranked lane: a +NaN above window 0's best,
    window 1's 3rd value tied on another candidate, window 2's 3rd place
    a +0.0 tied (IEEE) with a -0.0 below it, every other candidate there
    negative, and a -NaN for window 3's best. Each ``(args without the
    ring, n, plant)``; ``plant[w]`` is window w's candidates, best first."""
    from flink_tpu_torch.ops import aggregates as ta

    used, ends, valid = inp["used"], inp["ends"], inp["valid"]
    res = ta.multi(ta.max_of("price"), ta.avg_of("price")).finalize(
        lanes[0], lanes[1], lanes[2], wc)
    cols = torch.stack([res[f].to(torch.float32).view(torch.int32)
                        for f in ("avg_price", "max_price")], dim=2).contiguous()
    v = res["max_price"].contiguous()
    sel_cap = 256
    top1 = (wc, v, cols, used, ends, valid, inp["pane_lo"], 1, sel_cap)
    v3 = res["avg_price"].clone()
    cand = ((wc > 0) & used[:, None]).cpu().numpy()
    plant = {}
    for w in range(4):
        c = np.flatnonzero(cand[:, w])
        col = v3[torch.from_numpy(c).to(dev), w].cpu().numpy()
        plant[w] = c[np.argsort(-col, kind="stable")]
        check(len(c) > 4, f"window {w} has {len(c)} candidates")
    v3[int(plant[0][-1]), 0] = float("nan")
    v3[int(plant[1][-1]), 1] = v3[int(plant[1][2]), 1]
    rest = torch.from_numpy(plant[2][2:]).to(dev)
    v3[rest, 2] = -v3[rest, 2]
    v3[int(plant[2][2]), 2] = 0.0
    v3[int(plant[2][-1]), 2] = -0.0
    v3[int(plant[3][0]), 3] = -float("nan")
    cols3 = torch.stack([v3.view(torch.int32),
                         res["max_price"].view(torch.int32)],
                        dim=2).contiguous()
    top3 = (wc, v3, cols3, used, ends, valid, inp["pane_lo"], 3, sel_cap)
    return {"top1": top1, "top3": top3, "plant": plant, "v": v, "v3": v3}


def topn_lanes_kernel_cases(torch, np, dev, record, out):
    """window_lanes and topn_select_lanes against their plain versions at
    job T's shapes (``topn_lanes_inputs``), top-1 by max_price and the
    planted top-3 by avg_price (``topn_select_cases``). Every lane and the
    whole emit ring bit for bit (kernel and plain version add the sums in
    column order)."""
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import topn_lanes_kernels as tk
    from flink_tpu_torch.kernels import window_kernels as wk

    inp = topn_lanes_inputs(torch, np, dev)
    rows, ring, ppw, W = inp["rows"], inp["ring"], inp["ppw"], inp["W"]
    pane_lo, pane_hi = inp["pane_lo"], inp["pane_hi"]
    c_t, s_t, used = inp["counts"], inp["sums"], inp["used"]
    ends, valid = inp["ends"], inp["valid"]
    lane_args = inp["lane_args"]
    a = tk.window_lanes(*lane_args)
    b = tk.window_lanes_plain(*lane_args)
    torch.cuda.synchronize()
    check(all(x.shape == y.shape and same_bits(torch, x, y)
              for x, y in zip(a, b)),
          "window_lanes differs from its plain version")
    # the library yardstick: the sum lane times the (ring, W) column mask
    # in one f32 matmul, TF32 off (the reference's form of the sums)
    colmask = lk._live_columns(ends, ring, pane_lo, pane_hi, ppw).T.float()
    s2 = s_t[:, :, 0].contiguous()
    lib_ms = tf32_off(torch, lambda: time_ms(torch, lambda: s2 @ colmask))
    live = int(colmask.sum())                # live (pane, window) pairs
    live_cols = int((colmask.sum(dim=1) > 0).sum())
    lanes = 2
    record("window_lanes", "flink_tpu/ops/window.py:318", 0,
           time_ms(torch, lambda: tk.window_lanes(*lane_args)),
           time_ms(torch, lambda: tk.window_lanes_plain(*lane_args), iters=10),
           lib_ms, rows * live_cols * 4 * lanes + rows * W * 4 * lanes + W * 9,
           rows * live * lanes, source="topn_lanes_kernels.cu")
    out[-1]["library_call"] = "sums @ colmask (TF32 off), the sum lane"

    # TB: the operator's finalize on the grid, then the selection
    wc = wk.window_counts(c_t, ends, valid, pane_lo, pane_hi, ppw)
    sel = topn_select_cases(torch, np, dev, inp, a, wc)
    sel_args, v, n_top = sel["top1"], sel["v"], 1
    emit_ring = torch.zeros((2048 + 2, 5), dtype=torch.int32, device=dev)
    r1, r2 = emit_ring.clone(), emit_ring.clone()
    tk.topn_select_lanes(*sel_args, r1)
    tk.topn_select_lanes_plain(*sel_args, r2)
    torch.cuda.synchronize()
    check(torch.equal(r1[:-1], r2[:-1]),
          "topn_select_lanes differs from its plain version")
    written = int(r1[0, 0])
    check(written >= W and int(r1[0, 1]) == 0, f"ring head {r1[0].tolist()}")
    r3, r4 = emit_ring.clone(), emit_ring.clone()
    vt = v.T.contiguous()
    record("topn_select_lanes", "flink_tpu/ops/window.py:547", 0,
           time_ms(torch, lambda: tk.topn_select_lanes(*sel_args, r3)),
           time_ms(torch, lambda: tk.topn_select_lanes_plain(*sel_args, r4),
                   iters=10),
           time_ms(torch, lambda: torch.topk(vt, n_top, dim=1)),
           *topn_select_bytes_ops(rows, W, n_top, written),
           source="topn_lanes_kernels.cu")
    out[-1]["library_call"] = "torch.topk(v.T, n), the threshold only"

    # job T's second run, top-3 by avg_price, with the planted cells
    sel3, plant = sel["top3"], sel["plant"]
    r5, r6 = emit_ring.clone(), emit_ring.clone()
    tk.topn_select_lanes(*sel3, r5)
    tk.topn_select_lanes_plain(*sel3, r6)
    torch.cuda.synchronize()
    check(torch.equal(r5[:-1], r6[:-1]),
          "topn_select_lanes (top-3 by avg_price) differs from its plain "
          "version")
    written3 = int(r5[0, 0])
    check(written3 >= 2 * W and int(r5[0, 1]) == 0,
          f"top-3 ring head {r5[0].tolist()}")
    check_top3_plants(np, r5, plant, pane_lo - int(ends[0]))
    return {"window_lanes_cells": rows * W, "topn_select_lanes_rows": written,
            "topn_select_lanes_top3_rows": written3}


def topn_select_bytes_ops(rows, W, n, written):
    """``topn_select_lanes``' bound counts: reads the (rows, W) counts and
    ranking values and the used mask once, writes each appended row of 5
    words and the head."""
    return (rows * W * 8 + rows + W * 9 + written * 5 * 4 + 8,
            rows * W * (2 * n + 2))


def check_top3_plants(np, ring, plant, delta0):
    """The planted top-3 cells selected as the reference's rule does:
    window 0's +NaN out and its 2nd in, window 1's tie in, window 2's
    +0.0 and the -0.0 tied with it in, window 3's -NaN out."""
    written = int(ring[0, 0])
    got = ring[1:1 + written, :2].cpu().numpy()
    got = set(zip(got[:, 0].tolist(), (got[:, 1] + delta0).tolist()))
    check((int(plant[0][-1]), 0) not in got and (int(plant[0][1]), 0) in got
          and (int(plant[1][-1]), 1) in got and (int(plant[2][2]), 2) in got
          and (int(plant[2][-1]), 2) in got and (int(plant[3][0]), 3) not in got,
          "top-3: the planted NaN, tie and signed-zero cells did not select "
          "as the reference's rule does")


def phase_summary(rows_n, launches, res, wall, events, batches, prof):
    """A pipeline phase's common figures: events/s, rows, launches, the
    idle share by CUDA-event spans and by the profiler's run."""
    busy, host = busy_and_host(res)
    return {"events": events, "batches": batches, "wall_s": wall,
            "events_per_s": events / wall, "rows": rows_n,
            "launches": launches, "device_busy_ms": busy,
            "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
            "host_profile_s": host,
            "profiled": {"batches": SIDE_BATCHES, **prof}}


def bids_cfg(n_batches, n_auctions=10_000):
    from flink_tpu_torch.nexmark.generator import NexmarkConfig

    # bench.py:393-395's host-fed bids
    return NexmarkConfig(batch_size=Q5_BATCH, n_batches=n_batches,
                         events_per_ms=100, num_active_auctions=n_auctions,
                         hot_ratio=4)


def run_window_job(torch, np, source, window, agg, label, top=None,
                   ooo_ms=1_000, shape=None):
    """A keyed-by-auction window job on ``source`` through
    ``env.execute()`` at confs/bench_q5_host_fed.conf: (rows as columns,
    launches, JobResult, wall seconds). ``shape`` adds a trigger or an
    evictor to the windowed stream."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    env = StreamExecutionEnvironment(Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf")))
    parts = []
    windowed = (env.from_source(
        source, WatermarkStrategy.for_bounded_out_of_orderness(ooo_ms))
        .key_by("auction").window(window))
    if shape is not None:
        windowed = shape(windowed)
    stream = windowed.aggregate(agg)
    if top is not None:
        stream = stream.top(top[1], by=top[0])
    stream.add_sink(FnSink(lambda b: parts.append(
        {k: np.asarray(v).copy() for k, v in b.items()})))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return rows, dict(wk.LAUNCHES), res, wall


def run_topn_lanes(torch, np, n_batches, by, n, label):
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.ops import aggregates as ta

    return run_window_job(
        torch, np, bid_stream(bids_cfg(n_batches)),
        SlidingEventTimeWindows.of(10_000, 1_000),
        ta.multi(ta.max_of("price"), ta.avg_of("price")), label, top=(by, n))


def check_topn_lanes(np, rows, golden, by, n, label):
    """Job T's rows against the golden: each row's count, max and average
    (the average within ``agg_rel_bound``); the winners exactly by max,
    and by average under the margin rule. Returns the number of windows
    that took the narrow branch of the margin rule."""
    a = rows["key"].astype(np.int64)
    e = rows["window_end"] // 1000
    check(len(set(zip(a.tolist(), e.tolist()))) == len(a),
          f"{label}: duplicate (auction, window) rows")
    cnt = golden["count"]
    check(np.array_equal(rows["count"], cnt[a, e]),
          f"{label}: counts differ from the golden")
    check(np.array_equal(rows["max_price"], golden["max"][a, e]),
          f"{label}: max differs from the golden")
    avg = golden["sum"] / np.maximum(cnt, 1)
    rel = np.abs(rows["avg_price"].astype(np.float64) - avg[a, e]) / avg[a, e]
    check(bool((rel <= agg_rel_bound(cnt[a, e])).all()),
          f"{label}: averages outside the bound")
    got = {}
    for ai, ei in zip(a.tolist(), e.tolist()):
        got.setdefault(ei, set()).add(ai)
    ends = np.flatnonzero((cnt > 0).any(axis=0))
    check(set(got) == set(ends.tolist()),
          f"{label}: {len(got)} windows fired, {len(ends)} hold data")
    narrow = 0
    for ei in ends.tolist():
        cand = np.flatnonzero(cnt[:, ei] > 0)
        if by == "max_price":
            vals = golden["max"][cand, ei]
            thresh = np.sort(vals)[::-1][min(n, len(vals)) - 1]
            check(got[ei] == set(cand[vals >= thresh].tolist()),
                  f"{label}: window {ei}'s winners differ from the golden")
            continue
        vals = avg[cand, ei]
        bound = agg_rel_bound(cnt[cand, ei]) * np.abs(vals)
        order = np.argsort(-vals, kind="stable")
        if len(cand) <= n:
            check(got[ei] == set(cand.tolist()), f"{label}: window {ei}")
            continue
        t, u = order[n - 1], order[n]
        if vals[t] - vals[u] > bound[t] + bound[u]:
            check(got[ei] == set(cand[order[:n]].tolist()),
                  f"{label}: window {ei}'s winners differ from the golden")
        else:
            narrow += 1
            tied = set(cand[vals >= vals[t] - bound - bound[t]].tolist())
            check(got[ei] <= tied and len(got[ei]) >= n,
                  f"{label}: window {ei}'s winners are not among the tied")
    return narrow


def phase_topn_lanes(torch, np):
    """Job T: top-1 by max_price, then top-3 by avg_price, over
    ``multi(max_of("price"), avg_of("price"))`` on 16 batches of 2^20
    host-fed bids, each checked against the numpy golden."""
    on_path = ("scatter_lanes", "window_counts", "window_lanes",
               "topn_select_lanes", "ring_columns")
    out = {"phase": "topn_lanes", "conf": "confs/bench_q5_host_fed.conf",
           "job": 'key_by(auction).window(10 s / 1 s).aggregate(multi('
                  'max_of(price), avg_of(price))).top(n, by)',
           "rel_bound": "(2 * count + 34) * 2^-24"}
    runs, per_call, launches_first = [], {}, None
    for by, n in (("max_price", 1), ("avg_price", 3)):
        run_topn_lanes(torch, np, 2, by, n, f"topn-{by}-warmup")
        rows, launches, res, wall = run_topn_lanes(
            torch, np, TOPN_BATCHES, by, n, f"topn-{by}")
        missing = [k for k in on_path if launches[k] == 0]
        check(not missing, f"top {n} by {by}: kernels not launched: {missing}")
        check(launches["topn_select_append"] == 0
              and launches["fused_step"] == 0,
              f"top {n} by {by} took a count-only kernel: {launches}")
        # the split upload decoded inside one scatter_lanes a batch
        check(launches["split_cells"] == 0
              and launches["scatter_lanes"] == TOPN_BATCHES,
              f"top {n} by {by}: split_cells {launches['split_cells']}, "
              f"scatter_lanes {launches['scatter_lanes']} launches")
        prof = profile_run(torch, lambda: run_topn_lanes(
            torch, np, SIDE_BATCHES, by, n, f"topn-{by}-profiled")[3])
        # the max pass and the selection at top-1; above, the radix select
        # and the selection in one cooperative launch (five launches where
        # the grid does not fit the card at once)
        check(prof["kernels_per_call"].get("topn_select_lanes")
              in ((2,) if n == 1 else (1, 5)),
              f"top {n} by {by}: topn_select_lanes kernels a call "
              f"{prof['kernels_per_call']}")
        for k, v in prof["device_ms_per_call"].items():
            per_call.setdefault(k, v)
        runs.append((by, n, rows, launches, res, wall, prof))
        launches_first = launches_first or launches
    # the golden's numpy work comes after the timed runs
    golden = bid_golden(np, bids_cfg(TOPN_BATCHES))
    for by, n, rows, launches, res, wall, prof in runs:
        narrow = check_topn_lanes(np, rows, golden, by, n, f"top {n} by {by}")
        out[f"top{n}_{by}"] = {
            **phase_summary(len(rows["key"]), launches, res, wall,
                            Q5_BATCH * TOPN_BATCHES, TOPN_BATCHES, prof),
            "windows": int(len(np.unique(rows["window_end"]))),
            "narrow_margin_windows": narrow}
    out["card"] = card_line()
    emit(out)
    return launches_first, per_call


def changelog_source(np, n_batches):
    """Job C's feed: the host-fed bids with an int8 ``__op__`` column
    drawn from the seed, 70 % +I, 10 % +U, 10 % -U, 10 % -D."""
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.nexmark.generator import bid_batch
    from flink_tpu_torch.records import (
        OP_DELETE, OP_FIELD, OP_INSERT, OP_UPDATE_AFTER, OP_UPDATE_BEFORE)

    cfg = bids_cfg(n_batches)
    codes = np.array([OP_INSERT, OP_UPDATE_AFTER, OP_UPDATE_BEFORE,
                      OP_DELETE], np.int8)

    def batch(i):
        data, ts = bid_batch(cfg, 0, i)
        rng = np.random.default_rng(SEED + 1000 + i)
        data[OP_FIELD] = rng.choice(codes, len(ts), p=[0.7, 0.1, 0.1, 0.1])
        return data, ts

    def gen(split, i):
        return batch(i) if i < n_batches else None

    return GeneratorSource(gen), batch


def run_changelog(torch, np, n_batches, label):
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.ops import aggregates as ta

    source, _ = changelog_source(np, n_batches)
    return run_window_job(
        torch, np, source, TumblingEventTimeWindows.of(10_000),
        ta.multi(ta.changelog_count("net"), ta.changelog_sum_of("price"),
                 ta.changelog_avg_of("price")), label)


def check_changelog(np, rows, n_batches, label):
    """Job C against per-(auction, 10 s window) sums in f64: rows, counts
    and signed counts exactly; the signed sum within (2 * count + 34) *
    2^-24 of its absolute terms' sum, the average within that over its
    divisor plus 2 * 2^-24 of itself. Returns the largest share of the
    sum bound used."""
    from flink_tpu_torch.records import OP_DELETE, OP_FIELD, OP_UPDATE_BEFORE

    _, batch = changelog_source(np, n_batches)
    n_a = 10_000
    parts = [batch(i) for i in range(n_batches)]
    n_w = int(max(ts.max() for _, ts in parts)) // 10_000 + 1
    cnt = np.zeros(n_a * n_w, np.int64)
    net = np.zeros(n_a * n_w, np.int64)
    tot = np.zeros(n_a * n_w)
    ab = np.zeros(n_a * n_w)
    for data, ts in parts:
        cell = data["auction"] * n_w + ts // 10_000
        ops = data[OP_FIELD]
        sign = np.where((ops == OP_UPDATE_BEFORE) | (ops == OP_DELETE), -1, 1)
        price = data["price"].astype(np.float64)
        cnt += np.bincount(cell, minlength=n_a * n_w)
        net += np.bincount(cell, weights=sign, minlength=n_a * n_w).astype(
            np.int64)
        tot += np.bincount(cell, weights=sign * price, minlength=n_a * n_w)
        ab += np.bincount(cell, weights=price, minlength=n_a * n_w)
    c = rows["key"].astype(np.int64) * n_w + rows["window_start"] // 10_000
    check(len(np.unique(c)) == len(c), f"{label}: duplicate rows")
    check(len(c) == int((cnt > 0).sum()),
          f"{label}: {len(c)} rows, expected {int((cnt > 0).sum())}")
    check(np.array_equal(rows["count"], cnt[c])
          and np.array_equal(rows["net"], net[c]),
          f"{label}: counts or signed counts differ from the golden")
    bound = agg_rel_bound(cnt[c]) * ab[c]
    err = np.abs(rows["sum_price"].astype(np.float64) - tot[c])
    check(bool((err <= bound).all()), f"{label}: signed sums outside the bound")
    div = np.maximum(net[c], 1).astype(np.float64)
    want = tot[c] / div
    err_a = np.abs(rows["avg_price"].astype(np.float64) - want)
    check(bool((err_a <= bound / div + 2 * 2.0 ** -24 * np.abs(want)).all()),
          f"{label}: averages outside the bound")
    return float((err / np.maximum(bound, 1e-300)).max())


def phase_changelog(torch, np):
    """Job C on 16 batches of 2^20 changelog records, against the numpy
    golden."""
    run_changelog(torch, np, 2, "changelog-warmup")
    rows, launches, res, wall = run_changelog(torch, np, CHANGELOG_BATCHES,
                                              "changelog")
    missing = [k for k in ("scatter_lanes", "fire_pack", "ring_columns")
               if launches[k] == 0]
    check(not missing, f"changelog: kernels not launched: {missing}")
    # the split upload decoded inside one scatter_lanes a batch
    check(launches["split_cells"] == 0
          and launches["scatter_lanes"] == CHANGELOG_BATCHES,
          f"changelog: split_cells {launches['split_cells']}, scatter_lanes "
          f"{launches['scatter_lanes']} launches")
    prof = profile_run(torch, lambda: run_changelog(
        torch, np, SIDE_BATCHES, "changelog-profiled")[3])
    share = check_changelog(np, rows, CHANGELOG_BATCHES, "changelog")
    out = {"phase": "changelog", "conf": "confs/bench_q5_host_fed.conf",
           "job": "key_by(auction).window(10 s tumbling).aggregate(multi("
                  "changelog_count(net), changelog_sum_of(price), "
                  "changelog_avg_of(price)))",
           "op_mix": {"+I": 0.7, "+U": 0.1, "-U": 0.1, "-D": 0.1},
           **phase_summary(len(rows["key"]), launches, res, wall,
                           Q5_BATCH * CHANGELOG_BATCHES, CHANGELOG_BATCHES,
                           prof),
           "max_share_of_sum_bound": share, "card": card_line()}
    emit(out)
    return launches, prof["device_ms_per_call"]


def phase_q5_spill(torch, np):
    """Job S: Q5 host-fed with the host spill store at 100,000 auctions
    (about 3 x the 32,768 key slots), 8 batches of 2^20 bids, against
    Q5's numpy golden."""
    cfg = bids_cfg(SPILL_BATCHES, SPILL_AUCTIONS)
    run_q5_host_fed(torch, np, dataclasses.replace(cfg, n_batches=2),
                    "q5-spill-warmup", backend="spill")
    rows, launches, res, wall = run_q5_host_fed(torch, np, cfg, "q5-spill",
                                                backend="spill")
    missing = [k for k in ("window_counts", "topn_select_append",
                           "ring_columns", "scatter_split_counts")
               if launches[k] == 0]
    check(not missing, f"q5_spill: kernels not launched: {missing}")
    # the count lane's split upload is one launch a batch
    check(launches["split_cells"] == 0,
          "q5_spill: the count lane decoded its split upload apart")
    check(launches["fused_step"] == 0, "a fused step ran with spill")
    spilled = int(res.metrics["records_spilled"])
    check(spilled > 0, "q5_spill: no record was spilled")
    check(int(res.metrics["records_dropped_full"]) == 0,
          "q5_spill: records were dropped")
    side = dataclasses.replace(cfg, n_batches=SIDE_BATCHES)
    prof = profile_run(torch, lambda: run_q5_host_fed(
        torch, np, side, "q5-spill-profiled", backend="spill")[3])
    check_q5_rows(np, rows, cfg, "Q5 with spill")
    events = Q5_BATCH * SPILL_BATCHES
    out = {"phase": "q5_spill", "conf": "confs/bench_q5_host_fed.conf + "
                                        "state.backend: spill",
           "auctions": SPILL_AUCTIONS, "key_slots": 128 * 256,
           **phase_summary(len(rows), launches, res, wall, events,
                           SPILL_BATCHES, prof),
           "windows": len({w for _, w, _ in rows}),
           "records_spilled": spilled, "spilled_share": spilled / events,
           "card": card_line()}
    emit(out)
    return launches, prof["device_ms_per_call"]


def exact_bits(torch, a, b) -> bool:
    """Equal shapes and equal bits (NaN payloads and signs included)."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def job_e_survivors(np, data):
    """One 10 s window of job E at its fire: each auction's last
    ``E_KEEP`` bids in arrival order, grouped by auction (ascending).
    Returns (lengths, indices of the survivors into the batch)."""
    keep = E_KEEP
    a = data["auction"]
    order = np.argsort(a, kind="stable")
    n = np.bincount(a)
    lens = np.minimum(n[n > 0], keep)
    start = np.concatenate([[0], np.cumsum(n[n > 0])[:-1]])
    pos = np.arange(len(a)) - np.repeat(start, n[n > 0])
    survive = pos >= np.repeat(n[n > 0] - lens, n[n > 0])
    return lens, order[survive]


def segment_job_e(torch, np, dev):
    """segment_lanes' inputs at job E's fire: one 10 s window (one batch of
    2^20 bids, ~10,000 auctions, each keeping its last 100 bids: ~750k
    survivors), the lanes of ``multi(count(), avg_of("price"),
    max_of("price"))`` lifted on the card. Returns (args, lengths)."""
    from flink_tpu_torch.nexmark.generator import bid_batch
    from flink_tpu_torch.ops import aggregates as ta

    data, _ = bid_batch(bids_cfg(1), 0, 2)
    lens, idx = job_e_survivors(np, data)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    agg = ta.multi(ta.count(), ta.avg_of("price"), ta.max_of("price"))
    price = torch.from_numpy(data["price"][idx]).to(dev)
    s, mx, mn = agg.lift_masked({"price": price},
                                torch.ones(len(idx), dtype=torch.bool,
                                           device=dev))
    off_t = torch.from_numpy(offsets).to(dev)
    return (off_t, s.contiguous(), mx.contiguous(), mn.contiguous()), lens


def segment_edge_case(torch, np, dev):
    """segment_lanes' edge case: 300 segments of 1 to 40 elements, one of
    5,000 and one of 30, every lane the same column with planted +/-NaN
    (payloads; six NaNs and infinities and zeros in segment 20), +/-inf
    and +/-0, and a segment of -0 only. Returns (args, lengths)."""
    rng = np.random.default_rng(SEED + 7)
    e_lens = rng.integers(1, 40, 300)
    e_lens[[3, 10, 20, 200]] = [1, 5000, 30, 1]
    e_off = np.concatenate([[0], np.cumsum(e_lens)]).astype(np.int64)
    x = (rng.random(int(e_off[-1])) * 200 - 100).astype(np.float32)
    bits = x.view(np.uint32)
    plant = {0: [0x7FC00005], 1: [0xFFC0004D], 2: [0x7F800000, 0xFF800000],
             4: [0x00000000, 0x80000000], 5: [0x80000000], 10: [0x7FC00063,
             0x7F800000, 0x80000000, 0xFFC00001],
             # several NaNs of both signs, with payloads, in one segment
             20: [0xFFC00101, 0x7F800000, 0x7FC00202, 0x00000000,
                  0xFFC00303, 0x7FC00404]}
    for w, vals in plant.items():
        pos = e_off[w] + np.linspace(0, e_lens[w] - 1, len(vals)).astype(int)
        bits[pos] = vals
    bits[e_off[7]:e_off[8]] = 0x80000000          # a segment of -0 only
    xt = torch.from_numpy(x)[:, None].to(dev)
    return (torch.from_numpy(e_off).to(dev), xt, xt, xt), e_lens


def element_kernel_cases(torch, np, dev, record, out):
    """segment_lanes against its plain version on the card, bit for bit,
    at job E's fire (``segment_job_e``), then on the edge case
    (``segment_edge_case``: planted +/-NaN with payloads, several in one
    segment, +/-inf and +/-0 in every lane, one-element segments and a
    5,000-element one). Its library yardstick: one
    ``torch.segment_reduce`` sum over the sum lane (``index_add_`` by
    segment id where that call is missing)."""
    from flink_tpu_torch.kernels import element_kernels as ek

    args, lens = segment_job_e(torch, np, dev)
    got = ek.segment_lanes(*args)
    plain = ek.segment_lanes_plain(*args)
    torch.cuda.synchronize()
    check(all(exact_bits(torch, x, y) for x, y in zip(got, plain)),
          "segment_lanes differs from its plain version at job E's shape")
    check(got[3].cpu().numpy().tolist() == lens.tolist(),
          "segment_lanes counts differ from the segment lengths")
    n_seg, n_el = len(lens), int(lens.sum())
    lens_t = torch.from_numpy(lens.astype(np.int64)).to(dev)
    try:
        lib = torch.segment_reduce(args[1], "sum", lengths=lens_t, axis=0)
        lib_call = "torch.segment_reduce(sums, 'sum', lengths=...)"

        def lib_fn():
            return torch.segment_reduce(args[1], "sum", lengths=lens_t, axis=0)
    except (AttributeError, RuntimeError, NotImplementedError):
        seg_id = torch.repeat_interleave(
            torch.arange(n_seg, device=dev), lens_t)
        lib_call = "zeros(W, S).index_add_(0, segment id, sums)"

        def lib_fn():
            return torch.zeros((n_seg, 1), device=dev).index_add_(
                0, seg_id, args[1])
        lib = lib_fn()
    bound = (2.0 * lens_t[:, None] + 4) * 2.0 ** -24 * got[0]
    check(bool(((lib - got[0]).abs() <= bound).all()),
          "the library yardstick does not compute segment_lanes' sums")
    widths = sum(t.shape[1] for t in args[1:])
    record("segment_lanes", "flink_tpu/api/datastream.py:443", 0,
           time_ms(torch, lambda: ek.segment_lanes(*args)),
           time_ms(torch, lambda: ek.segment_lanes_plain(*args), iters=3,
                   warmup=1),
           time_ms(torch, lib_fn),
           n_el * widths * 4 + (n_seg + 1) * 8 + n_seg * (widths + 1) * 4,
           n_el * widths, source="element_kernels.cu")
    out[-1]["library_call"] = lib_call
    out[-1]["segments"], out[-1]["elements"] = n_seg, n_el

    # the edge case: every lane the same planted column
    e_args, e_lens = segment_edge_case(torch, np, dev)
    got_e = ek.segment_lanes(*e_args)
    plain_e = ek.segment_lanes_plain(*e_args)
    torch.cuda.synchronize()
    check(all(exact_bits(torch, a, b) for a, b in zip(got_e, plain_e)),
          "segment_lanes differs from its plain version on the edge case")
    mxb = got_e[1][:, 0].cpu().view(torch.int32).numpy().view(np.uint32)
    mnb = got_e[2][:, 0].cpu().view(torch.int32).numpy().view(np.uint32)
    check(mxb[0] == mnb[0] == 0x7FC00005 and mxb[1] == mnb[1] == 0xFFC0004D
          and mxb[10] == 0xFFC00001 and mnb[10] == 0x7FC00063
          and mxb[7] == mnb[7] == 0x80000000,
          "segment_lanes' NaN or signed-zero rule is not the reference's")
    # several NaNs in one segment: NaN, as the reference's jnp.max / min /
    # sum give; the max keeps the last, the min the first
    check(mxb[20] == 0x7FC00404 and mnb[20] == 0xFFC00101
          and bool(torch.isnan(got_e[0][20, 0])),
          "segment_lanes with several NaNs in one segment is not NaN or "
          "keeps another NaN than the rule's")
    return {"segment_lanes_job_e": {"segments": n_seg, "elements": n_el},
            "segment_lanes_edge": {"segments": len(e_lens),
                                   "longest": int(e_lens.max()),
                                   "nans_in_segment_20": 4}}


def mesh_cells(np, rng, n_auctions, n, slots, ring):
    """A source block's n global int32 cells: ``n_auctions`` keys on
    distinct slots of ``slots``, each record on one of them at a random
    ring column, 1 % invalid (-1)."""
    keys = rng.choice(slots, n_auctions, replace=False)
    cells = keys[rng.integers(0, n_auctions, n)] * ring + rng.integers(
        0, ring, n)
    cells[rng.random(n) < 0.01] = -1
    return cells.astype(np.int32)


def mesh_kernel_cases(torch, np, dev, record, out, wc, used, ends):
    """The key-sharded path's kernels against their plain versions on the
    card, bit for bit, at job M1's shapes (4 blocks of 8,192 slots + a
    dump row, a 32-column ring): ``bucket_records`` on one source block
    of a 2^20-bid chunk (2^18 records, 10,000 auctions over the global
    slots, 1 % invalid; capacity 2^18) and with job M2's three lifted
    lanes; ``hash_keys`` on a batch's 2^20 auction keys with extreme keys
    planted, also against ``hash_keys_numpy``; the distributed top-1 on
    the K2 grid (the host-fed Q5 fire, 11 windows) cut into the 4 blocks:
    ``topn_candidates`` per block into its columns of one gathered
    buffer, ``topn_global_threshold`` over it (the global k-th alone: no
    path launches it), ``topn_select_given`` per block against the
    gathered candidates, whose rows must be the single-device
    ``topn_select_append``'s, in its order; and
    ``fire_pack``'s row offset and the scatters' skip of invalid cells on
    a block's received records."""
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_batch
    from flink_tpu_torch.records import hash_keys_numpy

    rng = np.random.default_rng(SEED + 8)
    n_blk, ring = MESH_BLOCKS, 32
    spd = 128 * 256 // n_blk
    L = Q5_BATCH // n_blk
    extra = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)
                   if x is not None or y is not None)

    # X1 bucket_records, count only (job M1) and with three lanes (M2), on
    # the split upload's bytes (the form the path launches; its cells
    # decode to the flat form's, checked too)
    cells_np = mesh_cells(np, rng, 10_000, L, n_blk * spd, ring)
    cells, lanes = t(cells_np), t(rng.random((L, 3)).astype(np.float32))
    sc = t(split_bytes(np, cells_np, ring))
    for payload, label in ((None, "count"), (lanes, "lanes")):
        args = (sc, payload, n_blk, L, spd, ring)
        flat = (cells, payload, n_blk, L, spd, ring)
        got, plain = xk.bucket_records(*args), xk.bucket_records_plain(*args)
        got_flat = xk.bucket_records(*flat)
        torch.cuda.synchronize()
        check(same(got, plain) and same(got_flat, plain),
              f"bucket_records ({label}) differs from its plain version")
        C = 0 if payload is None else payload.shape[1]
        ms = time_ms(torch, lambda: xk.bucket_records(*args))
        plain_ms = time_ms(torch, lambda: xk.bucket_records_plain(*args),
                           iters=10)
        # each record read once (3 bytes and its lanes), every bucket
        # position (the padded layout) written once: its cell, valid byte
        # and lanes
        nbytes = L * (3 + 4 * C) + n_blk * L * (5 + 4 * C) + n_blk * 4
        if payload is None:
            record("bucket_records", "flink_tpu/exchange/keyby.py:37", 0,
                   ms, plain_ms, None, nbytes, L * n_blk,
                   source="exchange_kernels.cu")
            out[-1]["library_call"] = None
            out[-1]["records"] = L
            out[-1]["form"] = "the split upload's (B, 3) bytes"
            out[-1]["flat_cells_ms"] = time_ms(
                torch, lambda: xk.bucket_records(*flat))
        else:
            extra["bucket_records_lanes"] = {
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms(nbytes, L * n_blk)[0], "lanes": C}
    extra["bucket_records_per_dest"] = got[2].sum(dim=1).tolist()

    # one chunk's exchange on blocks of one card (each source block's
    # buckets straight into the owners' receive rows, no copy) against
    # the same exchange on the CPU (the plain versions)
    from flink_tpu_torch.exchange import keyby
    src = [cells] + [t(mesh_cells(np, rng, 10_000, L, n_blk * spd, ring))
                     for _ in range(n_blk - 1)]
    src_sc = [t(split_bytes(np, c.cpu().numpy(), ring)) for c in src]
    pays = [t(rng.random((L, 3)).astype(np.float32)) for _ in range(n_blk)]
    for payload, label in (([None] * n_blk, "count"), (pays, "lanes")):
        got = keyby.keyby_exchange(src_sc, payload, devices=[dev] * n_blk,
                                   capacity=L, spd=spd, ring=ring)
        want = keyby.keyby_exchange(
            [c.cpu() for c in src],
            [None if x is None else x.cpu() for x in payload],
            devices=[torch.device("cpu")] * n_blk, capacity=L, spd=spd,
            ring=ring)
        torch.cuda.synchronize()
        check(got[2] == want[2]
              and all(same([x.cpu() for x in a if x is not None],
                           [x for x in b if x is not None])
                      for a, b in zip(got[0], want[0]))
              and same([o.cpu() for o in got[1]], want[1]),
              f"the one-card exchange ({label}) differs from the CPU's")
    extra["exchange_chunk_bytes"] = got[2]

    # X2 hash_keys
    data, _ = bid_batch(bids_cfg(1), 0, 0)
    i64 = np.iinfo(np.int64)
    keys_np = data["auction"].astype(np.int64)
    keys_np[:6] = [0, -1, i64.max, i64.min, i64.min + 1, 1 << 40]
    kt = t(keys_np)
    got, plain = xk.hash_keys(kt), xk.hash_keys_plain(kt)
    torch.cuda.synchronize()
    check(torch.equal(got, plain)
          and np.array_equal(got.cpu().numpy(), hash_keys_numpy(keys_np)),
          "hash_keys differs from its plain version or hash_keys_numpy")
    n = len(keys_np)
    record("hash_keys", "flink_tpu/records.py:204", 0,
           time_ms(torch, lambda: xk.hash_keys(kt)),
           time_ms(torch, lambda: xk.hash_keys_plain(kt)), None, 16 * n,
           10 * n, source="exchange_kernels.cu")
    out[-1]["library_call"] = None

    # K3's distributed mode on the K2 grid cut into the blocks
    W, k, sel_cap, anchor = wc.shape[1], 1, 256, 1000
    w_valid = torch.ones(W, dtype=torch.bool, device=dev)
    zero_w = torch.zeros((1, W), dtype=wc.dtype, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    wcs = [torch.cat([wc[b * spd:(b + 1) * spd], zero_w]).contiguous()
           for b in range(n_blk)]
    useds = [torch.cat([used[b * spd:(b + 1) * spd], no]).contiguous()
             for b in range(n_blk)]
    rows = spd + 1
    # each block's candidates into its columns of one gathered buffer
    gathered = torch.empty((W, n_blk * k), dtype=torch.float32, device=dev)
    cands = [wk.topn_candidates(w, u, w_valid, k,
                                out=gathered[:, b * k:(b + 1) * k])
             for b, (w, u) in enumerate(zip(wcs, useds))]
    cands_p = [wk.topn_candidates_plain(w, u, w_valid, k)
               for w, u in zip(wcs, useds)]
    thresh = wk.topn_global_threshold(gathered, k)
    thresh_p = wk.topn_global_threshold_plain(gathered, k)
    rings = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
             for _ in range(2)]
    for b in range(n_blk):
        wk.topn_select_given(wcs[b], useds[b], ends, w_valid, anchor,
                             gathered, k, b * rows, sel_cap, rings[0])
        wk.topn_select_given_plain(wcs[b], useds[b], ends, w_valid, anchor,
                                   gathered, k, b * rows, sel_cap, rings[1])
    single = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    wk.topn_select_append(wc, used, ends, w_valid, anchor, k, 4 * sel_cap,
                          single)
    torch.cuda.synchronize()
    check(same(cands, cands_p) and torch.equal(thresh, thresh_p)
          and torch.equal(rings[0], rings[1]),
          "the distributed top-n differs from its plain versions")
    dist, one = rings[0].cpu().numpy(), single.cpu().numpy()
    n_rows = int(one[0, 0])
    body = dist[1:1 + int(dist[0, 0])].copy()
    body[:, 0] -= body[:, 0] // rows           # global row -> slot
    check(int(dist[0, 0]) == n_rows and n_rows >= W
          and np.array_equal(body, one[1:1 + n_rows]),
          "the distributed top-1 rows differ from the single-device ones")
    extra["topn_distributed_rows"] = n_rows
    v = [torch.where((w > 0) & u[:, None], w.float(),
                     torch.full((), -float("inf"), device=dev)).T.contiguous()
         for w, u in zip(wcs, useds)]
    record("topn_candidates", "flink_tpu/ops/window.py:1585", 0,
           time_ms(torch, lambda: wk.topn_candidates(wcs[0], useds[0],
                                                     w_valid, k)),
           time_ms(torch, lambda: wk.topn_candidates_plain(
               wcs[0], useds[0], w_valid, k)),
           time_ms(torch, lambda: torch.topk(v[0], k, dim=1)),
           rows * W * 4 + rows + W + W * k * 4, rows * W * 2 * k)
    out[-1]["library_call"] = "torch.topk(v.T, k) on the masked grid"
    out[-1]["per"] = "block"
    record("topn_global_threshold", "flink_tpu/ops/window.py:1608", 0,
           time_ms(torch, lambda: wk.topn_global_threshold(gathered, k)),
           time_ms(torch, lambda: wk.topn_global_threshold_plain(gathered,
                                                                 k)),
           time_ms(torch, lambda: torch.topk(gathered, k, dim=1)),
           gathered.numel() * 4 + W * 4, gathered.numel() * 2 * k)
    out[-1]["library_call"] = "torch.topk(gathered, k)"
    scratch = [r.clone() for r in rings]
    written = int(dist[0, 0]) // n_blk + 1
    record("topn_select_given", "flink_tpu/ops/window.py:1585", 0,
           time_ms(torch, lambda: wk.topn_select_given(
               wcs[0], useds[0], ends, w_valid, anchor, gathered, k, 0,
               sel_cap, scratch[0])),
           time_ms(torch, lambda: wk.topn_select_given_plain(
               wcs[0], useds[0], ends, w_valid, anchor, gathered, k, 0,
               sel_cap, scratch[1])), None,
           rows * W * 4 + rows + W * 9 + gathered.numel() * 4 + written * 12
           + 8, rows * W * 2 + gathered.numel() * 2 * k)
    out[-1]["per"] = "block"

    # fire_pack's row offset on one block; the scatters skip the -1 cells
    # of a block's received records
    from flink_tpu_torch.state.keyed import PaneStateLayout, init_state
    pane_lo, pane_hi, ppw = 1000, 1020, 10
    st = lane_state(np, rng, rows, ring, pane_lo, pane_hi,
                    rng.choice(spd, 2_500, replace=False), (1, 1, 1))
    stt = [t(x) for x in st]
    used_b = t(np.r_[np.ones(spd, bool), False])
    fargs = (stt[0], stt[1], stt[2], stt[3], ends[:4].contiguous(),
             w_valid[:4].contiguous(), used_b, pane_lo, pane_hi, ppw, 1 << 14,
             False)
    a = lk.fire_pack(*fargs, row_offset=2 * rows)
    b = lk.fire_pack_plain(*fargs, row_offset=2 * rows)
    torch.cuda.synchronize()
    nf = int(a[0][0, 0])
    check(nf > 0 and torch.equal(a[0][:nf + 1], b[0][:nf + 1])
          and torch.equal(a[1][:nf], b[1][:nf])
          and int(a[0][1:nf + 1, 0].min()) >= 2 * rows,
          "fire_pack with a row offset differs from its plain version")
    recv = torch.where(t(rng.random(n_blk * L) < 0.75),
                       torch.full((), -1, dtype=torch.int32, device=dev),
                       t(rng.integers(0, spd * ring, n_blk * L)
                         .astype(np.int32)))
    lay = PaneStateLayout(spd, ring, 1, 1, 1)
    on_card, on_cpu = init_state(lay, dev), init_state(lay, torch.device("cpu"))
    lanes3 = t(rng.random((n_blk * L, 3)).astype(np.float32))
    wk.scatter_counts(on_card.counts, recv, skip_negative=True)
    c_plain = init_state(lay, dev).counts
    wk.scatter_counts_plain(c_plain, recv, skip_negative=True)
    lk.scatter_lanes(on_card.counts, on_card.sums, on_card.maxs, on_card.mins,
                     recv, *(lanes3[:, i:i + 1].contiguous() for i in range(3)),
                     skip_negative=True)
    cpu = recv.cpu()
    wk.scatter_counts_plain(on_cpu.counts, cpu, skip_negative=True)
    lk.scatter_lanes_plain(on_cpu.counts, on_cpu.sums, on_cpu.maxs,
                           on_cpu.mins, cpu,
                           *(lanes3[:, i:i + 1].cpu().contiguous()
                             for i in range(3)), skip_negative=True)
    torch.cuda.synchronize()
    check(torch.equal(c_plain * 2, on_card.counts)
          and all(exact_bits(torch, x.cpu(), y) for x, y in (
              (on_card.counts, on_cpu.counts), (on_card.sums, on_cpu.sums),
              (on_card.maxs, on_cpu.maxs), (on_card.mins, on_cpu.mins))),
          "the scatters' skip of invalid cells differs from the plain ones")
    extra["fire_pack_row_offset_rows"] = nf
    extra["received_cells_valid"] = int((recv >= 0).sum())
    return extra


def mesh_split_cases(torch, np, dev):
    """``--mesh-kernels``: the key-sharded path's ``bucket_records`` and
    ``topn_candidates`` at job M1's shapes (4 blocks of 8,192 slots + a
    dump row, a 32-column ring), each held bit for bit against its plain
    version, then as loop ms (CUDA events, 50 calls), device ms and the
    device entries a call (``torch.profiler``, 10 calls) and host µs a
    call (1,000 calls without a sync; 200 for the exchange) beside its
    bound: X1 on one source block of a 2^20-bid chunk (2^18 records,
    10,000 auctions, 1 % invalid, capacity 2^18) count only, with M2's
    three lanes and with int64 cells, and at M3's shape (1,000 hot
    auctions, a 2^17-record chunk's block of 2^15 at capacity 16,384);
    one chunk's whole exchange as the operator runs it
    (``keyby.keyby_exchange`` over four blocks of the card, count only:
    the buckets and any copies, against the CPU's exchange); and
    ``topn_candidates`` on block 0 of the host-fed Q5 fire's window
    counts (8,193 rows x 11 windows) at top-1 and top-3, beside
    ``torch.topk`` on the -inf-masked grid."""
    from flink_tpu_torch.exchange import keyby
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.kernels import window_kernels as wk

    rng = np.random.default_rng(SEED + 15)
    n_blk, ring = MESH_BLOCKS, 32
    spd = 128 * 256 // n_blk
    L = Q5_BATCH // n_blk
    out = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def flat(x):
        if x is None:
            return []
        if isinstance(x, torch.Tensor):
            return [x.cpu()]
        if isinstance(x, int):
            return [torch.tensor(x)]
        return [y for v in x for y in flat(v)]

    def same(a, b):
        a, b = flat(a), flat(b)
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    def timed(name, fn, plain, nbytes, nops=0, calls=1000, library=None):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        check(same(got, want), f"{name} differs from its plain version")
        stages = kernel_stages(torch, fn)
        row = {"loop_ms": time_ms(torch, fn),
               "device_ms": sum(v["ms_per_call"] for v in stages.values()),
               "device_ops": sum(v["per_call"] for v in stages.values()),
               "host_us": host_us(torch, fn, calls),
               "bound_ms": bound_ms(nbytes, nops)[0], "stages": stages}
        if library is not None:
            row["library"] = {"loop_ms": time_ms(torch, library),
                              "device_ms": sum(
                                  v["ms_per_call"] for v in
                                  kernel_stages(torch, library).values())}
        out[name] = row
        return got

    m1 = mesh_cells(np, rng, 10_000, L, n_blk * spd, ring)
    m3 = mesh_cells(np, rng, 1_000, 1 << 15, n_blk * spd, ring)
    lanes = t(rng.random((L, 3)).astype(np.float32))
    for name, cells_np, payload, cap in (
            ("bucket_m1", m1, None, L), ("bucket_m2_lanes", m1, lanes, L),
            ("bucket_m3", m3, None, MESH_XCAP),
            ("bucket_int64", m1.astype(np.int64), None, L)):
        cells = t(cells_np)
        args = (cells, payload, n_blk, cap, spd, ring)
        C = 0 if payload is None else payload.shape[1]
        cb = cells.element_size()
        got = timed(name, lambda a=args: xk.bucket_records(*a),
                    lambda a=args: xk.bucket_records_plain(*a),
                    len(cells_np) * (cb + 4 * C)
                    + n_blk * cap * (cb + 1 + 4 * C) + 4 * n_blk,
                    len(cells_np) * n_blk)
        out[name]["records"] = len(cells_np)
        out[name]["capacity"] = cap
        out[name]["overflow"] = got[3].tolist()

    # one chunk's exchange as the operator runs it (count only, M1)
    src = [t(m1)] + [t(mesh_cells(np, rng, 10_000, L, n_blk * spd, ring))
                     for _ in range(n_blk - 1)]
    cpu_src = [c.cpu() for c in src]
    want = keyby.keyby_exchange(cpu_src, [None] * n_blk,
                                devices=[torch.device("cpu")] * n_blk,
                                capacity=L, spd=spd, ring=ring)

    def exchange():
        return keyby.keyby_exchange(src, [None] * n_blk,
                                    devices=[dev] * n_blk, capacity=L,
                                    spd=spd, ring=ring)

    got = timed("exchange_m1", exchange, lambda: want,
                n_blk * L * 4 + n_blk * n_blk * L * 5 + 4 * n_blk * n_blk,
                n_blk * L * n_blk, calls=200)
    out["exchange_m1"]["exchange_bytes"] = got[2]
    out["exchange_m1"]["copies_per_call"] = sum(
        v["per_call"] for k, v in out["exchange_m1"]["stages"].items()
        if k.startswith("Memcpy"))

    # topn_candidates at M1's fire: block 0 of the K2 grid
    st = q5_kernel_state(torch, np, dev)
    wc = wk.window_counts(st["counts"], st["ends"], st["w_valid"],
                          st["pane_lo"], st["pane_hi"], st["ppw"])
    W = wc.shape[1]
    wc0 = torch.cat([wc[:spd], torch.zeros((1, W), dtype=wc.dtype,
                                           device=dev)]).contiguous()
    used0 = torch.cat([st["used"][:spd], torch.zeros(
        1, dtype=torch.bool, device=dev)]).contiguous()
    rows, w_valid = spd + 1, st["w_valid"]
    v = torch.where((wc0 > 0) & used0[:, None], wc0.float(),
                    torch.full((), -float("inf"), device=dev)).T.contiguous()
    for k in (1, 3):
        got = timed(f"topn_candidates_top{k}",
                    lambda k=k: wk.topn_candidates(wc0, used0, w_valid, k),
                    lambda k=k: wk.topn_candidates_plain(wc0, used0,
                                                         w_valid, k),
                    rows * W * 4 + rows + W + W * k * 4, rows * W * 2 * k,
                    library=lambda k=k: torch.topk(v, k, dim=1))
        check(torch.equal(got, torch.topk(v, k, dim=1).values),
              f"topn_candidates top-{k} differs from torch.topk")
        out[f"topn_candidates_top{k}"]["rows"] = rows
    return out


def count_fire_cases(torch, np, dev):
    """``count_fire`` at WindowWordCount's fire (``count_fire_state``, the
    ``sum`` and the ``lanes`` shape), first held bit for bit against its
    plain version, purging and not (a base of half the counts), then,
    purging as the job runs it, as the kernel apart from the state's
    restore: loop ms (CUDA events around 50 restores and fires, less 50
    restores), device ms and kernels a call (``torch.profiler`` over 10
    restores and fires, the ``count_fire`` kernels only) and host µs a
    call (1,000 fires without a sync, on the state already fired, so
    nothing fires: the enqueue cost). No single torch call fires, packs
    and resets."""
    from flink_tpu_torch.kernels import count_window_kernels as cwk
    from flink_tpu_torch.kernels import window_kernels as wk

    rows, counts_np, cap, shapes = count_fire_state(np)
    out = {}
    for name, lanes in shapes.items():
        L = sum(1 for x in lanes if x is not None)
        for base_np in (None, counts_np // 2):
            runs = []
            for fn in (cwk.count_fire, cwk.count_fire_plain):
                st, _ = count_fire_tensors(torch, np, dev, counts_np, lanes,
                                           base_np)
                runs.append((fn(*st, CW_SIZE, cap), st))
            torch.cuda.synchronize()
            (a, sa), (b, sb) = runs
            n = int(b[0, 0])
            check(n > 0 and int(a[0, 0]) == n
                  and same_bits(torch, a[:n + 1], b[:n + 1])
                  and all(x is None or same_bits(torch, x, y)
                          for x, y in zip(sa, sb)),
                  f"count_fire ({name}, purge {base_np is None}) differs "
                  "from its plain version")
            if base_np is None:
                fired = n
            else:
                out[f"count_fire_{name}_keep_fired_rows"] = n
        st, restore = count_fire_tensors(torch, np, dev, counts_np, lanes)

        def fire():
            return cwk.count_fire(*st, CW_SIZE, cap)

        def restore_fire():
            restore()
            return fire()

        stages = kernel_stages(torch, restore_fire)
        mine = {k: v for k, v in stages.items() if k.startswith("count_fire")}
        restore_ms = time_ms(torch, restore)
        both_ms = time_ms(torch, restore_fire)
        b, by = bound_ms(count_fire_bytes(rows, fired, L), rows)
        out["count_fire_" + name] = {
            "rows": rows, "fired_rows": fired, "lanes": L, "out_cap": cap,
            "bound_ms": b, "bound_by": by,
            "tile_rows": cwk.FIRE_TILE,
            "loop_ms": both_ms - restore_ms, "loop_ms_with_restore": both_ms,
            "restore_loop_ms": restore_ms,
            "device_ms": sum(v["ms_per_call"] for v in mine.values()),
            "device_kernels": sum(v["per_call"] for v in mine.values()),
            "restore_device_ms": sum(v["ms_per_call"] for k, v in
                                     stages.items() if k not in mine),
            "host_us": host_us(torch, fire), "stages": stages}
    wk.check_errors(dev)
    return out


def devgen_ingest_cases(torch, np, dev):
    """The devgen path's make and ingest of one headline sub-batch
    (sub-batch 1 of logical batch 5: 2^20 bids of a 2^22 batch, 100
    bids/ms, 10,000 auctions, hot ratio 4, into 32,769 x 64), without and
    with stats, each first held bit for bit against the composed plain
    version (``nexmark_bids_plain``, then ``devgen_ingest_plain``), then
    as loop ms, device ms and host µs a call (``split_times``): the pair
    of launches (``nexmark_bids`` into device memory, ``devgen_ingest``
    reading it back), ``devgen_ingest`` alone on records already made
    (the memory form, as any other device source's ingest runs it) and
    the Nexmark form of ``devgen_ingest`` (one launch, the bids made in
    registers: the devgen path's), beside
    ``index_add_`` on the cells computed in advance."""
    from flink_tpu_torch.kernels import devgen_kernels as dk
    from flink_tpu_torch.kernels import window_kernels as wk

    n, total, key_domain, rows, ring = 1 << 20, 1 << 22, 10_000, 32_769, 64
    gen = (5, n, n, total, 100, 4, key_domain // 100, key_domain)
    keys, ts = dk.nexmark_bids_plain(*gen, dev)
    kw = dict(key_domain=key_domain, pane_ms=1000, offset_ms=0,
              dead_below=int(ts.min()) // 1000 - 1,
              refire_below=-(2 ** 63), dump_row=rows - 1)
    flat = keys * ring + torch.remainder(torch.div(ts, 1000,
                                                   rounding_mode="floor"), ring)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    n_cells = int(torch.unique(flat).numel())
    forms = {"pair": lambda c, stats: dk.devgen_ingest(
        c, *dk.nexmark_bids(*gen, dev), with_stats=stats, **kw),
             "memory": lambda c, stats: dk.devgen_ingest(
        c, keys, ts, with_stats=stats, **kw),
             "fused": lambda c, stats: dk.devgen_ingest_nexmark(
        c, gen, with_stats=stats, **kw)}
    out = {"records": n, "distinct_cells": n_cells}
    for stats in (False, True):
        want = torch.zeros((rows, ring), dtype=torch.int32, device=dev)
        want_stats = dk.devgen_ingest_plain(
            want, keys, ts, kw["key_domain"], kw["pane_ms"], kw["offset_ms"],
            kw["dead_below"], kw["refire_below"], kw["dump_row"],
            torch.zeros(dk.STATS_WORDS, dtype=torch.int32, device=dev)
            if stats else None)
        lib = want.clone()
        for form, fn in forms.items():
            c = torch.zeros_like(want)
            got = fn(c, stats)
            torch.cuda.synchronize()
            check(torch.equal(c, want)
                  and (not stats or torch.equal(got, want_stats)),
                  f"devgen_ingest ({form}, stats {stats}) differs from the "
                  "composed plain version")
            # the pair moves the records through HBM (16 B a record written
            # and read), the memory form reads them; each reads and writes
            # each cell once
            nbytes = {"pair": 32, "memory": 16}.get(form, 0) * n + 8 * n_cells
            b, by = bound_ms(nbytes, (15 if form == "memory" else 37) * n)
            out[f"{form}_{'stats' if stats else 'no_stats'}"] = {
                "bound_ms": b, "bound_by": by,
                "kernel": split_times(torch, lambda: fn(c, stats))}
        out["library_" + ("stats" if stats else "no_stats")] = split_times(
            torch, lambda: lib.view(-1).index_add_(0, flat, ones))
    out["library_call"] = "index_add_ on the cells computed in advance"
    wk.check_errors(dev)
    return out


def wordcount_pair_words(np):
    """WordCount's first 2^20-word batch as the native lane hands it to
    ``apply_pairs_u32``: its (slot, pane) pairs in first-seen order (128
    x 512 slots, a 16-column ring), each with its count (all below
    0xFFF) as one word."""
    from flink_tpu_torch.state.keyed import KeyDirectory

    _, gen = wordcount_source(np, 1)
    data, ts = gen("0", 0)
    slots = KeyDirectory(128, 512).assign(data["word"])
    cells = slots.astype(np.int64) * 16 + (ts // 1000) % 16
    pairs, first, cnts = np.unique(cells, return_index=True,
                                   return_counts=True)
    order = np.argsort(first, kind="stable")
    check(int(cnts.max()) < 0xFFF, "a WordCount pair count past 0xFFF")
    return 128 * 512, 16, pairs[order], cnts[order]


def apply_threshold_cases(torch, np, dev):
    """``apply_pairs_u32`` and the key-sharded top-n's global k-th, parent
    and change alike (the row reads which API its tree has), each held
    bit for bit against its plain version, then as loop ms, device ms and
    device entries a call and host µs a call (``split_times``):

    - ``apply_pairs_u32`` at the host-fed Q5 batch (~110k pairs into
      32,769 x 32, in the C scan's order and sorted by cell) and at
      WordCount's first batch (~294k pairs into
      65,537 x 16), on the real words and on the words padded to the
      power of two at or above them (the parent's native lane launched
      over the padded count, this tree's over the real one), beside
      ``index_add_``; each also as device ms after a 96 MB write that
      flushes the L2 (cold);
    - the fused step's fire of 11 ends, gate on (``fused_inputs``), on
      the padded and on the real upload, warm and cold;
    - one sharded top-n chunk at job M1's fire: the host-fed Q5 fire's
      state cut into 4 blocks of ``cuda:0`` (8,193 rows each, 11
      windows), top-1 and top-3, through the tree's own
      ``WindowOperator._topn_sharded`` (its window counts, candidates,
      gather, global k-th and selects), its rows against the one-block
      ``topn_select_append``'s; then each piece alone on block 0:
      ``window_counts``, ``topn_candidates``, the parent's ``torch.cat``,
      ``topn_global_threshold`` (beside ``torch.topk(gathered, k)``) and
      ``topn_select_given``."""
    import types

    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.ops.window import WindowOperator, preagg_encode_u32

    gathered_api = "k" in inspect.signature(wk.topn_select_given).parameters
    out = {"gathered_select": gathered_api,
           "fused_step_kernels": fk.FUSED_STEP_KERNELS}
    # a 96 MB write before each call pushes the state and the words out of
    # the 50 MB L2, as a pipeline's other work between two applies does
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def cold_ms(fn):
        """Device ms a call of ``fn`` after an L2 flush (the flush's fill
        kernel left out)."""
        stages = kernel_stages(torch, lambda: (flush.fill_(1), fn()))
        return sum(v["ms_per_call"] for k, v in stages.items()
                   if "FillFunctor" not in k)

    def pow2(n):
        return 1 << max(n - 1, 255).bit_length()

    # F1 at Q5 host-fed's and WordCount's batches
    f = fused_inputs(torch, np, dev)
    order = np.argsort(f["pairs"])
    shapes = {"q5": (f["slots"], f["ring"], f["pairs"], f["cnts"],
                     f["base"]),
              # the same pairs in cell order: a warp's adds on few lines
              "q5_sorted": (f["slots"], f["ring"], f["pairs"][order],
                            f["cnts"][order], f["base"]),
              "wordcount": (*wordcount_pair_words(np), None)}
    for name, (slots, ring, pairs, cnts, base) in shapes.items():
        if base is None:
            base = torch.zeros((slots + 1, ring), dtype=torch.int32,
                               device=dev)
        n = len(pairs)
        idx = torch.from_numpy(pairs.astype(np.int64)).to(dev)
        add = torch.from_numpy(cnts.astype(np.int32)).to(dev)
        lib_state = base.clone()
        row = {"pairs": n, "padded_words": pow2(n),
               "library": split_times(torch, lambda: lib_state.view(
                   -1).index_add_(0, idx, add)),
               "library_cold_device_ms": cold_ms(lambda: lib_state.view(
                   -1).index_add_(0, idx, add)),
               "library_call": "index_add_"}
        for form, cap in (("real", n), ("padded", pow2(n))):
            words = torch.from_numpy(preagg_encode_u32(pairs, cnts, cap)).to(
                dev)
            a, b = base.clone(), base.clone()
            fk.apply_pairs_u32(a, words, slots)
            fk.apply_pairs_u32_plain(b, words, slots)
            want = base.clone()
            want.view(-1).index_add_(0, idx, add)
            torch.cuda.synchronize()
            check(torch.equal(a, b) and torch.equal(a, want),
                  f"apply_pairs_u32 ({name}, {form}) differs from its plain "
                  "version or index_add_")
            b_ms, by = bound_ms(4 * cap + 8 * n, cap)
            row[form] = {"words": cap, "bound_ms": b_ms, "bound_by": by,
                         "kernel": split_times(
                             torch, lambda: fk.apply_pairs_u32(a, words,
                                                               slots)),
                         "cold_device_ms": cold_ms(
                             lambda: fk.apply_pairs_u32(a, words, slots))}
        out["apply_pairs_u32_" + name] = row

    # F2: the fire of 11 ends on the padded and on the real upload
    kw = dict(ppw=f["ppw"], n=1, sel_cap=256, dump_row=f["slots"],
              fire_gate=True, fire_pad=16)
    ring0 = torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
    for form, buf in (("padded", f["upload"](11, padded=True)),
                      ("real", f["upload"](11))):
        st = [f["base"].clone() for _ in range(3)]
        er = [ring0.clone() for _ in range(3)]
        fk.fused_step(st[0], er[0], buf, f["used"], **kw)
        fk.fused_step_plain(st[1], er[1], buf, f["used"], **kw)
        torch.cuda.synchronize()
        check(torch.equal(st[0], st[1]) and torch.equal(er[0][:-1], er[1][:-1]),
              f"fused_step ({form}) differs from its plain version")
        out["fused_step_ends11_" + form] = {
            "words": buf.numel(), "rows": int(er[0][0, 0]),
            "kernel": split_times(torch, lambda: fk.fused_step(
                st[2], er[2], buf, f["used"], **kw)),
            "cold_device_ms": cold_ms(lambda: fk.fused_step(
                st[2], er[2], buf, f["used"], **kw))}

    # the sharded top-n chunk at M1's fire: 4 blocks of cuda:0
    q = q5_kernel_state(torch, np, dev)
    state = q["counts"].clone()
    wk.scatter_counts_plain(state, q["idx"], q["cnt"])
    n_blk, W, ppw = MESH_BLOCKS, q["W"], q["ppw"]
    lo, hi, anchor = q["pane_lo"], q["pane_hi"], 1000
    spd = q["slots"] // n_blk
    rows = spd + 1
    ends, w_valid = q["ends"], q["w_valid"]
    zero_row = torch.zeros((1, q["ring"]), dtype=torch.int32, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    counts = [torch.cat([state[b * spd:(b + 1) * spd], zero_row]).contiguous()
              for b in range(n_blk)]
    used = [torch.cat([q["used"][b * spd:(b + 1) * spd], no]).contiguous()
            for b in range(n_blk)]
    wc_full = wk.window_counts_plain(state, ends, w_valid, lo, hi, ppw)
    wcs = [wk.window_counts_plain(c, ends, w_valid, lo, hi, ppw)
           for c in counts]
    hi_cap = min(hi, lo + q["ring"] - 1)
    spans = [range(max(e - ppw, lo), min(e - 1, hi_cap) + 1)
             for e in ends.tolist()]
    live_cols = len({p % q["ring"] for sp in spans for p in sp})
    live = sum(len(sp) for sp in spans)

    def operator(k):
        """A stand-in with the fields ``_topn_sharded`` reads, calling the
        tree's own methods."""
        op = types.SimpleNamespace(
            plan=types.SimpleNamespace(panes_per_window=ppw),
            layout=types.SimpleNamespace(rows=rows), _topn=("count", k),
            _blocks=[types.SimpleNamespace(counts=c) for c in counts],
            _devices=[dev] * n_blk, device=dev, _ring_anchor=anchor,
            _gathered_bufs={})
        for m in ("_on_blocks", "_topn_cap", "_gathered"):
            if hasattr(WindowOperator, m):
                setattr(op, m, types.MethodType(getattr(WindowOperator, m),
                                                op))
        return op

    for k in (1, 3):
        op = operator(k)
        rings = [ring0.clone() for _ in range(n_blk)]

        def chunk():
            WindowOperator._topn_sharded(op, ends, w_valid, lo, hi, used,
                                         rings)
        chunk()
        single = ring0.clone()
        wk.topn_select_append(wc_full, q["used"], ends, w_valid, anchor, k,
                              4 * 256, single)
        torch.cuda.synchronize()
        one = single.cpu().numpy()
        n_rows = int(one[0, 0])
        got = np.concatenate([r[1:1 + int(r[0, 0])] for r in
                              (x.cpu().numpy() for x in rings)])
        got[:, 0] -= got[:, 0] // rows        # global row -> slot
        check(n_rows >= W and len(got) == n_rows
              and np.array_equal(got, one[1:1 + n_rows]),
              f"the sharded top-{k} chunk's rows differ from the one-block "
              "top-n's")
        written = n_rows
        b_ms, by = bound_ms(n_blk * rows * (live_cols * 4 + 1) + W * 9
                            + written * 12 + 8 * n_blk,
                            n_blk * rows * (live + W * 2 * k))
        row = {"rows": written, "bound_ms": b_ms, "bound_by": by,
               "chunk": split_times(torch, chunk)}
        # each piece alone, block 0
        cands = [wk.topn_candidates_plain(w, u, w_valid, k)
                 for w, u in zip(wcs, used)]
        gathered = torch.cat(cands, dim=1)
        thresh = wk.topn_global_threshold(gathered, k)
        thresh_p = wk.topn_global_threshold_plain(gathered, k)
        torch.cuda.synchronize()
        check(torch.equal(thresh, thresh_p)
              and torch.equal(thresh, torch.topk(gathered, k, dim=1)
                              .values[:, k - 1]),
              f"topn_global_threshold (top-{k}) differs from its plain "
              "version or torch.topk")
        gb = torch.empty_like(gathered)
        cand_out = {"out": gb[:, :k]} if gathered_api else {}
        if gathered_api:
            sel_args = (wcs[0], used[0], ends, w_valid, anchor, gathered, k,
                        0, 256)
        else:
            sel_args = (wcs[0], used[0], ends, w_valid, anchor, thresh, 0,
                        256)
        r1, r2, r3 = (ring0.clone() for _ in range(3))
        wk.topn_select_given(*sel_args, r1)
        wk.topn_select_given_plain(*sel_args, r2)
        c0 = wk.topn_candidates(wcs[0], used[0], w_valid, k, **cand_out)
        torch.cuda.synchronize()
        check(torch.equal(r1[:-1], r2[:-1]) and torch.equal(c0, cands[0]),
              f"topn_select_given / topn_candidates (top-{k}) differ from "
              "their plain versions")
        sel_written = int(r1[0, 0])
        row["pieces"] = {
            "window_counts": split_times(torch, lambda: wk.window_counts(
                counts[0], ends, w_valid, lo, hi, ppw)),
            "topn_candidates": split_times(torch, lambda: wk.topn_candidates(
                wcs[0], used[0], w_valid, k, **cand_out)),
            "cat": split_times(torch, lambda: torch.cat(cands, dim=1)),
            "topn_global_threshold": split_times(
                torch, lambda: wk.topn_global_threshold(gathered, k)),
            "torch_topk_gathered": split_times(
                torch, lambda: torch.topk(gathered, k, dim=1)),
            "topn_select_given": split_times(
                torch, lambda: wk.topn_select_given(*sel_args, r3)),
        }
        row["topn_global_threshold_bound_ms"] = bound_ms(
            gathered.numel() * 4 + W * 4, gathered.numel() * 2 * k)[0]
        row["topn_select_given_bound_ms"] = bound_ms(
            rows * W * 4 + rows + W * 9 + gathered.numel() * 4
            + sel_written * 12 + 8, rows * W * 2 + W * gathered.shape[1] * 2
            * k)[0]
        row["topn_select_given_rows"] = sel_written
        out[f"sharded_top{k}"] = row
    wk.check_errors(dev)
    return out


def split_segment_cases(torch, np, dev):
    """The split upload's decode folded into the kernels that read it, and
    ``segment_lanes``' redesign, parent and change alike (the row reads
    which API its tree has), each held bit for bit, then as loop ms,
    device ms and device entries a call and host µs a call
    (``split_times``) beside its bound:

    - job (a)'s bid-aggregate batch: a 2^20-bid split upload into 32,769
      x 32 x (1 sum, 1 max, 1 min): ``split_cells`` alone,
      ``scatter_lanes`` alone on the flat cells, the pair (the decode,
      then the scatter: the parent's path) and, where the tree has it,
      ``scatter_lanes``' split form (this tree's path);
    - one source block of a mesh chunk (2^18 records, 1 % invalid, 4
      blocks of 8,192 slots, ring 32), count only (M1) and with M2's
      three lanes: ``split_cells`` alone, ``bucket_records`` alone on the
      flat cells, the pair and the split form; and one chunk's exchange of
      4 source blocks as ``keyby_exchange`` runs it on one card, from the
      bytes (the pair: four decodes, then the exchange; or the split
      form's exchange of the bytes);
    - ``segment_lanes`` at job E's fire, on the edge case and at the
      largest fire of a 2-batch job E2 run (its segment count and its
      shortest, median and longest segment), and, where the tree has both
      group forms, each forced (``SEGMENT_WARP_MEAN``)."""
    from flink_tpu_torch.exchange import keyby
    from flink_tpu_torch.kernels import element_kernels as ek
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.kernels import lane_kernels as lk
    from flink_tpu_torch.kernels import window_kernels as wk

    lanes_split = "dump_row" in inspect.signature(lk.scatter_lanes).parameters
    bucket_split = hasattr(xk, "bucket_cell_dtype")
    groups = hasattr(ek, "SEGMENT_WARP_MEAN")
    out = {"split_forms": lanes_split and bucket_split,
           "segment_groups": groups}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def flat(x):
        if x is None:
            return []
        if isinstance(x, torch.Tensor):
            return [x.cpu()]
        if isinstance(x, int):
            return [torch.tensor(x)]
        return [y for v in x for y in flat(v)]

    def same(a, b):
        a, b = flat(a), flat(b)
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    # -- K7 + L2 at job (a)'s batch
    rng = np.random.default_rng(SEED + 3)
    rows, ring, pane_lo, pane_hi = 32_769, 32, 1000, 1020
    keys = rng.choice(rows - 1, 10_000, replace=False)
    st = lane_state(np, rng, rows, ring, pane_lo, pane_hi, keys, (1, 1, 1),
                    hot=100)
    data, _, _, idx_np = scatter_lanes_batch(np, ring)
    dump_row, B = rows - 1, len(idx_np)
    sc, idx = t(split_bytes(np, idx_np, ring)), t(idx_np)
    price = t(data["price"][:, None])
    cells = int(np.unique(idx_np).size)

    def state():
        return [t(x.copy()) for x in st]

    a = state()
    lk.scatter_lanes(*a, wk.split_cells(sc, ring, dump_row), price, price,
                     price)
    cpu = [torch.from_numpy(x.copy()) for x in st]
    pc = torch.from_numpy(data["price"][:, None].copy())
    lk.scatter_lanes_plain(*cpu, wk.split_cells_plain(sc.cpu(), ring,
                                                      dump_row), pc, pc, pc)
    ok = all(same_bits(torch, x, y) for x, y in zip(a, cpu))
    if lanes_split:
        b = state()
        lk.scatter_lanes(*b, sc, price, price, price, dump_row=dump_row)
        ok = ok and all(same_bits(torch, x, y) for x, y in zip(a, b))
    torch.cuda.synchronize()
    check(ok, "job (a)'s split upload: the pair or the split form differs "
              "from the plain version on the CPU")
    s_l2, s_pair, s_split = state(), state(), state()
    lanes_io = B * 12 + cells * 16 * 2
    row = {"records": B, "distinct_cells": cells, "dump_row": dump_row,
           "split_cells": split_times(
               torch, lambda: wk.split_cells(sc, ring, dump_row)),
           "split_cells_bound_ms": bound_ms(B * 7, B * 4)[0],
           "scatter_lanes_flat": split_times(torch, lambda: lk.scatter_lanes(
               *s_l2, idx, price, price, price)),
           "scatter_lanes_flat_bound_ms": bound_ms(B * 4 + lanes_io, B * 4)[0],
           "pair": split_times(torch, lambda: lk.scatter_lanes(
               *s_pair, wk.split_cells(sc, ring, dump_row), price, price,
               price)),
           "bound_ms": bound_ms(B * 3 + lanes_io, B * 4)[0]}
    if lanes_split:
        row["split_form"] = split_times(torch, lambda: lk.scatter_lanes(
            *s_split, sc, price, price, price, dump_row=dump_row))
    out["bid_aggs_a"] = row

    # -- K7 + X1 on one source block of a mesh chunk, and the chunk
    rng = np.random.default_rng(SEED + 15)
    n_blk = MESH_BLOCKS
    spd = 128 * 256 // n_blk
    L = Q5_BATCH // n_blk
    m1 = mesh_cells(np, rng, 10_000, L, n_blk * spd, ring)
    c1, sc1 = t(m1), t(split_bytes(np, m1, ring))
    lanes3 = t(rng.random((L, 3)).astype(np.float32))
    for label, payload in (("mesh_m1", None), ("mesh_m2_lanes", lanes3)):
        C = 0 if payload is None else payload.shape[1]
        f_args = (c1, payload, n_blk, L, spd, ring)

        def pair(payload=payload):
            return xk.bucket_records(wk.split_cells(sc1, ring, n_blk * spd),
                                     payload, n_blk, L, spd, ring)
        want = xk.bucket_records_plain(*f_args)
        ok = same(pair(), want)
        if bucket_split:
            ok = ok and same(xk.bucket_records(sc1, payload, n_blk, L, spd,
                                               ring), want)
        torch.cuda.synchronize()
        check(ok, f"{label}: the pair or the split form differs from "
                  "bucket_records' plain version")
        out_io = n_blk * L * (5 + 4 * C) + n_blk * 4
        row = {"records": L, "lanes": C,
               "split_cells": split_times(
                   torch, lambda: wk.split_cells(sc1, ring, n_blk * spd)),
               "bucket_records_flat": split_times(
                   torch, lambda a=f_args: xk.bucket_records(*a)),
               "bucket_records_flat_bound_ms": bound_ms(
                   L * (4 + 4 * C) + out_io, L * n_blk)[0],
               "pair": split_times(torch, pair),
               "bound_ms": bound_ms(L * (3 + 4 * C) + out_io, L * n_blk)[0]}
        if bucket_split:
            row["split_form"] = split_times(
                torch, lambda payload=payload: xk.bucket_records(
                    sc1, payload, n_blk, L, spd, ring))
        out[label] = row
    src = [m1] + [mesh_cells(np, rng, 10_000, L, n_blk * spd, ring)
                  for _ in range(n_blk - 1)]
    src_sc = [t(split_bytes(np, c, ring)) for c in src]
    devs = [dev] * n_blk

    def chunk_pair():
        return keyby.keyby_exchange(
            [wk.split_cells(x, ring, n_blk * spd) for x in src_sc],
            [None] * n_blk, devices=devs, capacity=L, spd=spd, ring=ring)

    def chunk_split():
        return keyby.keyby_exchange(src_sc, [None] * n_blk, devices=devs,
                                    capacity=L, spd=spd, ring=ring)
    want = keyby.keyby_exchange(
        [torch.from_numpy(c) for c in src], [None] * n_blk,
        devices=[torch.device("cpu")] * n_blk, capacity=L, spd=spd,
        ring=ring)
    ok = same(chunk_pair(), want)
    if bucket_split:
        ok = ok and same(chunk_split(), want)
    torch.cuda.synchronize()
    check(ok, "the chunk's exchange from the split bytes differs from the "
              "CPU's")
    out["mesh_chunk"] = {"blocks": n_blk, "records": n_blk * L,
                         "pair": split_times(torch, chunk_pair)}
    if bucket_split:
        out["mesh_chunk"]["split_form"] = split_times(torch, chunk_split)

    # -- segment_lanes: job E's fire, the edge case, job E2's largest fire
    caught = {}
    orig = ek.segment_lanes

    def spy(offsets, sums, maxs, mins):
        if sums.shape[0] > caught.get("elements", -1):
            caught["elements"] = sums.shape[0]
            caught["args"] = tuple(x.clone() for x in (offsets, sums, maxs,
                                                       mins))
        return orig(offsets, sums, maxs, mins)
    ek.segment_lanes = spy
    try:
        run_job_e2(torch, np, ELEMENT_TRIGGER_BATCHES, "split-segment-e2")
    finally:
        ek.segment_lanes = orig
    fires = {"job_e": segment_job_e(torch, np, dev)[0],
             "edge": segment_edge_case(torch, np, dev)[0],
             "job_e2": caught["args"]}
    for name, args in fires.items():
        lens = (args[0][1:] - args[0][:-1]).cpu().numpy()
        n_el = int(lens.sum())
        widths = sum(x.shape[1] for x in args[1:])
        n_seg = len(lens)
        forms = {"wrapper": None}
        if groups:
            forms.update({"group_8": 1 << 62, "group_32": 0})
        row = {"segments": n_seg, "elements": n_el, "widths": [
                   x.shape[1] for x in args[1:]],
               "shortest": int(lens.min()), "median": float(np.median(lens)),
               "longest": int(lens.max()),
               "bound_ms": bound_ms(n_el * widths * 4 + (n_seg + 1) * 8
                                    + n_seg * (widths + 1) * 4,
                                    n_el * widths)[0]}
        if groups:
            row["group"] = ek.segment_group(n_seg, n_el, widths)
        plain = ek.segment_lanes_plain(*args)
        for form, mean in forms.items():
            keep = getattr(ek, "SEGMENT_WARP_MEAN", None)
            if mean is not None:
                ek.SEGMENT_WARP_MEAN = mean
            try:
                got = ek.segment_lanes(*args)
                torch.cuda.synchronize()
                check(all(exact_bits(torch, x, y) for x, y in zip(got, plain)),
                      f"segment_lanes ({name}, {form}) differs from its plain "
                      "version")
                row[form] = split_times(torch, lambda: ek.segment_lanes(*args))
            finally:
                if mean is not None:
                    ek.SEGMENT_WARP_MEAN = keep
        if name == "job_e":
            lens_t = torch.from_numpy(lens.astype(np.int64)).to(dev)
            row["library"] = split_times(torch, lambda: torch.segment_reduce(
                args[1], "sum", lengths=lens_t, axis=0))
        out[f"segment_lanes_{name}"] = row
    wk.check_errors(dev)
    return out


HW_BASE_BATCHES = 8     # hot_wide: distinct 2^20-bid batches, replayed
HW_TIMED = 50           # hot_wide: the batches timed (loop ms, host µs)
HW_PROFILED = 6         # hot_wide: the batches under torch.profiler


def hot_wide_cases(torch, np, dev):
    """The native lane's hot-key and wide Q5 batches, parent and change
    alike (the row reads which form its tree's fused step takes), at
    confs/bench_q5_host_fed.conf's operator (sliding 10 s / 1 s count,
    top-1, 128 x 256 slots, 1 s out of order):

    - ``hot``: q5-hot-keys' bids (1,000 auctions, half the bids on 10 of
      them, 2^20 a batch) at ring 32: a pair count past 0xFFF, so the
      parent folds each batch in with ``apply_pairs_u16`` and fires in
      the chunked path, the change in one ``fused_step`` on triples;
    - ``wide``: Q5's bids (10,000 auctions, hot ratio 4) with the ring
      grown to 64 after the first batch: a pair domain of 2^21, the same
      split.

    Each batch's ingest (``process_batch``) and its advance, the
    watermark 1 s behind the batch's newest bid: HW_BASE_BATCHES distinct
    batches replayed with their event time shifted, two of warm-up, then
    HW_TIMED timed (loop ms: CUDA events around them, over the batches;
    host µs a batch: the operator's pb_preagg + pb_dispatch + aw_dispatch;
    bytes uploaded a batch, through the operator's upload helpers), then
    HW_PROFILED under ``torch.profiler`` (device ms, kernels and copies a
    batch). A CPU twin runs the same batches on the plain versions: the
    rows drained after each stage and the final state must be equal.
    Then ``apply_pairs_u16`` alone on a hot batch's triples, padded to
    the power of two at or above them (the parent's upload) and the real
    ones (the change's), beside ``index_add_``, and in a tree whose fused
    step takes triples the fused step on them, all bit for bit against
    the plain versions."""
    from flink_tpu_torch import native_codec as nc
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.kernels import fused_kernels as fk
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_batch
    from flink_tpu_torch.ops import window as pw
    from flink_tpu_torch.ops.aggregates import count
    from torch.profiler import ProfilerActivity, profile

    triple_form = "form" in inspect.signature(fk.fused_step).parameters
    out = {"triple_form": triple_form,
           "fused_step_kernels": fk.FUSED_STEP_KERNELS}
    hot = NexmarkConfig(batch_size=Q5_BATCH, n_batches=HW_BASE_BATCHES,
                        events_per_ms=100, num_active_auctions=1_000,
                        hot_ratio=2)
    wide = dataclasses.replace(hot, num_active_auctions=10_000, hot_ratio=4)
    span_ms = Q5_BATCH // 100

    def batches(cfg):
        base = [bid_batch(cfg, 0, i) for i in range(HW_BASE_BATCHES)]
        rep = HW_BASE_BATCHES * span_ms

        def get(j):
            d, ts = base[j % HW_BASE_BATCHES]
            return (np.asarray(d["auction"], np.int64),
                    np.asarray(ts, np.int64) + (j // HW_BASE_BATCHES) * rep)
        return get

    def make(device):
        return pw.WindowOperator(
            SlidingEventTimeWindows.of(10_000, 1_000), count(),
            num_shards=128, slots_per_shard=256,
            max_out_of_orderness_ms=1_000, top_n=("count", 1), device=device)

    def step(op, get, j, ring):
        keys, ts = get(j)
        op.process_batch(keys, ts, {})
        op.advance_watermark(int(ts.max()) - 1_001)
        if op.plan.ring < ring:
            op._grow_ring(ring - 4, op._min_pane_seen, op._max_pane_seen)

    def drained(op):
        op.quiesce()
        d = op.drain_ring()
        return sorted(zip(*(np.asarray(d[k]).tolist()
                            for k in ("key", "window_end", "count"))))

    uploaded = [0]
    staged0, slot0 = pw.staged, pw.PinnedStage.upload_slot

    def staged_spy(arr, device):
        uploaded[0] += np.asarray(arr).nbytes
        return staged0(arr, device)

    def slot_spy(self, i, lo, hi):
        uploaded[0] += hi - lo
        return slot0(self, i, lo, hi)

    # a batch's pairs: the native lane's scan, or where it declines (the
    # wide batch's 10,000 keys x 64 columns) the general path's C combine
    scans = []
    scan0, combine0 = nc.ingest_fused_scan_native, nc.preagg_combine_native

    def scan_spy(*a, **k):
        r = scan0(*a, **k)
        if r is not None:
            scans.append(("scan", r[0].npairs))
        return r

    def combine_spy(*a, **k):
        r = combine0(*a, **k)
        if r is not None:
            scans.append(("combine", len(r[0])))
        return r

    HOST = ("pb_preagg", "pb_dispatch", "aw_dispatch")
    for name, cfg, ring in (("hot", hot, 32), ("wide", wide, 64)):
        get = batches(cfg)
        op = make(dev)
        rows = {}
        for j in range(2):
            step(op, get, j, ring)
        rows["warmup"] = drained(op)
        torch.cuda.synchronize()
        wk.reset_launch_counts()
        prof0 = dict(op.prof)
        uploaded[0] = 0
        scans.clear()
        pw.staged, pw.PinnedStage.upload_slot = staged_spy, slot_spy
        nc.ingest_fused_scan_native = scan_spy
        nc.preagg_combine_native = combine_spy
        try:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            for j in range(2, 2 + HW_TIMED):
                step(op, get, j, ring)
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pw.staged, pw.PinnedStage.upload_slot = staged0, slot0
            nc.ingest_fused_scan_native = scan0
            nc.preagg_combine_native = combine0
        launches = {k: v for k, v in wk.LAUNCHES.items() if v}
        host = {k: (v - prof0.get(k, 0.0)) / HW_TIMED * 1e6
                for k, v in op.prof.items()}
        rows["timed"] = drained(op)
        ends = len({w for _, w, _ in rows["timed"]}) / HW_TIMED
        # the scan's pairs a batch (a batch with misses scans twice: the
        # second continues the first's pairs), else the combine's
        last = {}
        for j, (how, npairs) in enumerate(scans):
            last[how] = last.get(how, []) + [npairs]
        pairs = max((sum(v) / HW_TIMED if k == "combine" else
                     sum(v) / len(v)) for k, v in last.items()) if last else 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for j in range(2 + HW_TIMED, 2 + HW_TIMED + HW_PROFILED):
                step(op, get, j, ring)
            torch.cuda.synchronize()
        rows["profiled"] = drained(op)
        kern = {"ms": 0.0, "n": 0}
        copies = {"ms": 0.0, "n": 0}
        by_name = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0)
            if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            acc = copies if e.key.startswith(("Memcpy", "Memset")) else kern
            acc["ms"] += us / 1e3 / HW_PROFILED
            acc["n"] += e.count / HW_PROFILED
            by_name[e.key[:80]] = {"per_batch": e.count / HW_PROFILED,
                                   "ms_per_batch": us / 1e3 / HW_PROFILED}
        # the CPU twin: the same batches on the plain versions
        twin = make("cpu")
        twin_rows = {}
        for stage, lo, hi in (("warmup", 0, 2), ("timed", 2, 2 + HW_TIMED),
                              ("profiled", 2 + HW_TIMED,
                               2 + HW_TIMED + HW_PROFILED)):
            for j in range(lo, hi):
                step(twin, get, j, ring)
            twin_rows[stage] = drained(twin)
        check(twin_rows == rows, f"hot_wide {name}: rows differ from the CPU "
              "twin's")
        check(torch.equal(op.state.counts.cpu(), twin.state.counts),
              f"hot_wide {name}: state differs from the CPU twin's")
        rows_n = op.layout.rows
        live_cols = min(ring, 10 + int(round(ends)) - 1)
        # the least bytes a batch: its pairs' triples uploaded, each
        # pair's cell read and written, the fire's live columns and used
        # mask read, one purged column written, the appended rows
        nbytes = (6 * pairs + 8 * pairs + 4 * rows_n * live_cols + rows_n
                  + 4 * rows_n + 12 * ends)
        b_ms, by = bound_ms(nbytes, pairs + rows_n * live_cols)
        out[name] = {
            "auctions": cfg.num_active_auctions, "ring": op.plan.ring,
            "pairs_per_batch": pairs, "ends_per_batch": ends,
            "loop_ms": e0.elapsed_time(e1) / HW_TIMED,
            "wall_ms": wall * 1e3 / HW_TIMED,
            "pair_source": sorted(last),
            "host_us": host,
            "host_us_sum": sum(host.get(k, 0.0) for k in HOST),
            "uploaded_bytes_per_batch": uploaded[0] / HW_TIMED,
            "launches_per_batch": {k: v / HW_TIMED
                                   for k, v in launches.items()},
            "device_ms": kern["ms"], "kernels_per_batch": kern["n"],
            "copy_ms": copies["ms"], "copies_per_batch": copies["n"],
            "device_entries": by_name, "bound_ms": b_ms, "bound_by": by,
            "rows": sum(len(v) for v in rows.values())}

    # F3 alone on a hot batch's triples (first-seen order, as the scan
    # records them), padded and real
    rng = np.random.default_rng(SEED + 19)
    keys, ts = batches(hot)(3)
    slot_of = rng.permutation(128 * 256)[:hot.num_active_auctions]
    cells = slot_of[keys] * 32 + (ts // 1000) % 32
    uniq, first, cnt = np.unique(cells, return_index=True, return_counts=True)
    order = np.argsort(first)
    pairs, cnts = uniq[order], cnt[order]
    check(cnts.max() >= 0xFFF, "hot_wide: the hot batch has no hot pair")
    base = torch.from_numpy(_hot_state(np, rng, slot_of)).to(dev)
    idx = torch.from_numpy(pairs.astype(np.int64)).to(dev)
    add = torch.from_numpy(cnts.astype(np.int32)).to(dev)
    lib = base.clone()
    f3 = {"pairs": len(pairs), "max_count": int(cnts.max()),
          "library": split_times(torch, lambda: lib.view(-1).index_add_(
              0, idx, add)), "library_call": "index_add_"}
    want = base.clone()
    want.view(-1).index_add_(0, idx, add)
    for form, cap in (("padded", 1 << max(len(pairs) - 1, 255).bit_length()),
                      ("real", len(pairs))):
        tri = torch.from_numpy(pw.preagg_encode_u16(pairs, cnts, cap)).to(dev)
        a, b = base.clone(), base.clone()
        fk.apply_pairs_u16(a, tri)
        fk.apply_pairs_u16_plain(b, tri)
        torch.cuda.synchronize()
        check(torch.equal(a, b) and torch.equal(a, want),
              f"apply_pairs_u16 ({form}) differs from its plain version or "
              "index_add_")
        b_ms, by = bound_ms(6 * cap + 8 * len(pairs), cap)
        f3[form] = {"triples": cap, "uploaded_bytes": 6 * cap,
                    "bound_ms": b_ms, "bound_by": by,
                    "kernel": split_times(torch, lambda: fk.apply_pairs_u16(
                        a, tri))}
    out["apply_pairs_u16_hot"] = f3
    if triple_form:
        n = len(pairs)
        t = np.full(2 * ((6 * n + 3) // 4), 0xFFFF, np.uint16)
        t[:3 * n] = pw.preagg_encode_u16(pairs, cnts, n).reshape(-1)
        hdr = np.zeros(fk.FUSED_HDR, np.int32)
        p_lo, p_hi = int(ts.min() // 1000), int(ts.max() // 1000)
        hdr[:6] = np.array([p_lo, p_hi, p_lo], np.int64).view(np.int32)
        deltas = np.full(fk.MIN_FIRE_PAD, fk.DELTA_SENTINEL, np.int64)
        deltas[:11] = np.arange(p_hi - 9, p_hi + 2) - p_lo
        hdr[8:8 + fk.MIN_FIRE_PAD] = deltas.astype(np.int32)
        buf = torch.from_numpy(np.concatenate([hdr, t.view(np.int32)])).to(dev)
        used = torch.zeros(base.shape[0], dtype=torch.bool, device=dev)
        used[torch.from_numpy(slot_of).to(dev)] = True
        kw = dict(ppw=10, n=1, sel_cap=256, dump_row=base.shape[0] - 1,
                  fire_gate=True, fire_pad=16, form=fk.FORM_TRIPLES)
        st = [base.clone() for _ in range(3)]
        er = [torch.zeros((2048 + 2, 3), dtype=torch.int32, device=dev)
              for _ in range(3)]
        fk.fused_step(st[0], er[0], buf, used, **kw)
        fk.fused_step_plain(st[1], er[1], buf, used, **kw)
        torch.cuda.synchronize()
        check(torch.equal(st[0], st[1]) and torch.equal(er[0][:-1], er[1][:-1]),
              "fused_step (triples, the hot batch) differs from its plain "
              "version")
        out["fused_step_triples_hot"] = {
            "words": buf.numel(), "rows": int(er[0][0, 0]),
            "kernel": split_times(torch, lambda: fk.fused_step(
                st[2], er[2], buf, used, **kw))}
    wk.check_errors(dev)
    return out


def _hot_state(np, rng, slot_of):
    """A 32,769 x 32 count lane with the hot auctions' rows live over 21
    panes (1,000 to 1,020), the hot batch's pairs' rows among them."""
    counts = np.zeros((128 * 256 + 1, 32), np.int32)
    for p in range(1000, 1021):
        counts[slot_of, p % 32] = rng.poisson(500, len(slot_of))
    return counts


# --cases NAME[,NAME...]: kernel cases, parent and change in turns. A row
# names the CUDA sources it needs (built alone) and its function (torch,
# np, dev) -> dict, printed as one JSON line under the row's name; the
# older flags each run one row (--ring-pairs: ring_pairs, ...). To compare
# with a parent, unpack it under _archive/ with this file copied in and
# run both in one call, in turns.
def checkpoint_cost_cases(torch, np, dev):
    """Where a checkpoint's cost goes on the headline devgen job (16 x
    2^22 bids, 4 sub-batches, a checkpoint at every batch boundary once
    the last is durable), each variant run in turns, three rounds: no
    checkpoints; the full path; the full path with the JAX package's
    byte assembly of the blobs; the full path with every fsync skipped;
    the full path writing each file in 256 KiB writes; the write replaced
    by a 25 ms sleep; the executor's write skipped (the
    fetch and the encode kept); the encode and the write skipped (the fetch
    kept); the fetch, encode and write skipped (the loop's part and the
    final commit only). A variant swaps the coordinator's or storage's
    function for one that skips its step; the committed rows of every
    run must equal the golden."""
    import shutil

    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import TransactionalCollectSink
    from flink_tpu_torch import fs
    from flink_tpu_torch.checkpoint import blobformat, coordinator, storage
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import NexmarkConfig, bid_stream_device
    from flink_tpu_torch.nexmark.queries import q5_hot_items
    from flink_tpu_torch.obs.tracing import tracer

    cfg = NexmarkConfig(batch_size=DEVGEN_BATCH,
                        n_batches=CKPT_DEVGEN_BATCHES, events_per_ms=100,
                        num_active_auctions=10_000, hot_ratio=4)
    root = os.path.join(ROOT, "flink_tpu_torch", "_build", "checkpoints")
    real_save = storage.FsCheckpointStorage.save_v2
    real_fsync = os.fsync
    real_write = fs._SyncOnClose.write

    def chunked_write(self, data):
        view = memoryview(data)
        for lo in range(0, len(view), 1 << 18):
            self._f.write(view[lo:lo + (1 << 18)])
        return len(view)
    real_blob_encode = blobformat.encode
    real_mat = coordinator.materialize_snapshot

    def no_write(self, cid, meta, blobs, reuse, savepoint=False):
        return storage.CheckpointHandle(
            cid, os.path.join(self.job_dir, f"chk-{cid}"), 0, savepoint,
            size_bytes=sum(len(b) for b in blobs.values()), op_files={})

    def host_only(obj):
        if isinstance(obj, torch.Tensor):
            return np.zeros(0, np.int32)
        if isinstance(obj, dict):
            return {k: host_only(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(host_only(v) for v in obj)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.replace(obj, **{
                f.name: host_only(getattr(obj, f.name))
                for f in dataclasses.fields(obj)})
        return obj

    def bytearray_encode(payload):
        """The JAX package's byte assembly of the same blob (a zeroed
        bytearray, each array's ``tobytes`` copied in, then ``bytes``):
        the same bytes, three more passes over the arrays."""
        e = blobformat._Encoder()
        tree = e.enc(payload)
        offsets, pos = [], 0
        for a in e.arrays:
            pos = (pos + blobformat._ALIGN - 1) // blobformat._ALIGN * \
                blobformat._ALIGN
            offsets.append(pos)
            pos += a.nbytes
        header = json.dumps({
            "tree": tree,
            "arrays": [{"dtype": str(a.dtype), "shape": list(a.shape),
                        "offset": off, "nbytes": a.nbytes}
                       for a, off in zip(e.arrays, offsets)],
            "pickle_escapes": e.pickle_escapes}).encode()
        out = bytearray(blobformat.MAGIC)
        out += len(header).to_bytes(4, "little") + header
        base = len(out)
        out += b"\0" * (pos if e.arrays else 0)
        for a, off in zip(e.arrays, offsets):
            out[base + off:base + off + a.nbytes] = a.tobytes()
        return bytes(out)

    probe = {"a": np.arange(1 << 20, dtype=np.int32), "t": (1, "x")}
    check(bytearray_encode(probe) == real_blob_encode(probe),
          "checkpoint_cost: the two byte assemblies differ")
    def sleep_write(self, cid, meta, blobs, reuse, savepoint=False):
        time.sleep(0.025)  # about the full path's write, GIL released
        return no_write(self, cid, meta, blobs, reuse, savepoint)

    variants = {
        "none": {},
        "full": {},
        "full_bytearray_encode": {"encode": bytearray_encode},
        "full_no_fsync": {"fsync": lambda fd: None},
        "full_chunked_write": {"chunked": True},
        "fetch_encode_sleep": {"save": sleep_write},
        "fetch_encode": {"save": no_write},
        "fetch": {"save": no_write, "encode": lambda payload: b""},
        "loop_only": {"save": no_write, "encode": lambda payload: b"",
                      "mat": host_only},
    }
    expect = devgen_golden(np, cfg)
    out = {name: [] for name in variants}
    for rnd in range(3):
        for name, patch in variants.items():
            shutil.rmtree(root, ignore_errors=True)
            storage.FsCheckpointStorage.save_v2 = patch.get("save", real_save)
            os.fsync = patch.get("fsync", real_fsync)
            fs._SyncOnClose.write = (chunked_write if patch.get("chunked")
                                     else real_write)
            blobformat.encode = patch.get("encode", real_blob_encode)
            coordinator.materialize_snapshot = patch.get("mat", real_mat)
            try:
                sink = TransactionalCollectSink()
                env = StreamExecutionEnvironment(Configuration.from_file(
                    os.path.join(ROOT, "confs", "bench_q5_headline.conf")).set(
                    "execution.checkpointing.interval",
                    0 if name == "none" else 1).set(
                    "execution.checkpointing.dir", root))
                q5_hot_items(env, bid_stream_device(cfg), sink,
                             window_ms=10_000, slide_ms=1_000,
                             out_of_orderness_ms=1_000)
                tracer.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = env.execute(f"ckpt-cost-{name}", device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                storage.FsCheckpointStorage.save_v2 = real_save
                os.fsync = real_fsync
                fs._SyncOnClose.write = real_write
                blobformat.encode = real_blob_encode
                coordinator.materialize_snapshot = real_mat
            got = {(int(r["auction"]), int(r["window_end"]),
                    int(r["bid_count"])) for r in sink.committed}
            check(got == expect, f"checkpoint_cost {name}: rows differ")
            persist = [s["duration_ms"] for s in
                       tracer.spans("checkpoint.persist")]
            out[name].append({
                "wall_s": wall,
                "checkpoints": res.metrics.get("checkpoints_completed", 0),
                "loop_s": res.metrics.get(
                    "profile.driver.checkpoint_freeze", 0.0),
                "final_s": res.metrics.get(
                    "profile.driver.checkpoint_final", 0.0),
                "persist_ms_p50": (float(np.median(persist))
                                   if persist else None)})
    shutil.rmtree(root, ignore_errors=True)
    events = DEVGEN_BATCH * CKPT_DEVGEN_BATCHES
    return {"events": events, "runs": out,
            "events_per_s_median": {
                name: events / float(np.median([r["wall_s"] for r in runs]))
                for name, runs in out.items()}}


def mesh_m1_cases(torch, np, dev):
    """Job M1 (Q5 host-fed over MESH_BLOCKS blocks of the card, 16 x 2^20
    bids, the mesh phase's job) three times in one process: its events/s
    a run, the last run's rows against the golden. Run in a tree and its
    parent in turns to tell a change from the host's spread."""
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    mesh = make_mesh_plan(128, 256, [dev] * MESH_BLOCKS)
    cfg = bids_cfg(Q5_BATCHES)
    rates = []
    for _ in range(3):
        rows, _, res, wall = run_q5_host_fed(torch, np, cfg, "mesh-m1",
                                             mesh=mesh)
        rates.append(Q5_BATCH * Q5_BATCHES / wall)
    check_q5_rows(np, rows, cfg, "M1")
    return {"m1_events_per_s": rates,
            "exchange_overflow": res.metrics["exchange_overflow"]}


KERNEL_CASES = {
    "ring_pairs": (("window_kernels", "lane_kernels"), ring_pair_cases),
    "fire_kernels": (("lane_kernels", "topn_lanes_kernels"),
                     fire_kernel_cases),
    "count_topn": (("window_kernels", "fused_kernels"), count_topn_cases),
    "count_lane": (("window_kernels", "fused_kernels"), count_lane_cases),
    "mesh_kernels": (("exchange_kernels", "window_kernels"),
                     mesh_split_cases),
    "count_fire": (("count_window_kernels",), count_fire_cases),
    "devgen_ingest": (("devgen_kernels",), devgen_ingest_cases),
    "apply_threshold": (("window_kernels", "fused_kernels"),
                        apply_threshold_cases),
    "split_segment": (("window_kernels", "lane_kernels", "exchange_kernels",
                       "element_kernels"), split_segment_cases),
    "hot_wide": (("window_kernels", "fused_kernels"), hot_wide_cases),
    "checkpoint_cost": (("window_kernels", "devgen_kernels"),
                        checkpoint_cost_cases),
    "mesh_m1": (KERNEL_SOURCES, mesh_m1_cases),
}


def phase_cases(torch, np, names):
    """Build the named rows' sources (one nvcc a source, together) and run
    each row: one JSON line a row, with the build's time and ptxas lines."""
    from flink_tpu_torch.kernels import build

    unknown = [n for n in names if n not in KERNEL_CASES]
    check(not unknown, f"unknown case rows {unknown}; known: "
          f"{sorted(KERNEL_CASES)}")
    sources = sorted({s for n in names for s in KERNEL_CASES[n][0]})
    t0 = time.perf_counter()
    build.build_all(sources)
    build_s = time.perf_counter() - t0
    for name in names:
        srcs, fn = KERNEL_CASES[name]
        ptxas = {s: [ln.strip() for ln in build.BUILD_LOG[s]["ptxas"]
                     .splitlines() if "registers" in ln or "spill" in ln
                     or "smem" in ln] for s in srcs}
        emit({"phase": name, "root": ROOT, "build_s": build_s,
              "ptxas": ptxas, **fn(torch, np, torch.device("cuda")),
              "card": card_line()})


def element_golden(np, n_batches):
    """Job E's and E2's input grouped by (auction, 10 s window) in arrival
    order: (cell id of each group, group starts, lengths, prices in
    group order, number of windows)."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    parts = [bid_batch(bids_cfg(n_batches), 0, i) for i in range(n_batches)]
    a = np.concatenate([d["auction"] for d, _ in parts])
    ts = np.concatenate([t for _, t in parts])
    price = np.concatenate([d["price"] for d, _ in parts])
    n_w = int(ts.max()) // 10_000 + 1
    cell = a * n_w + ts // 10_000
    order = np.argsort(cell, kind="stable")
    cells, start, lens = np.unique(cell[order], return_index=True,
                                   return_counts=True)
    return cells, start, lens, price[order], n_w


def check_job_e(np, rows, n_batches, label):
    """Each (auction, window) once, with its last ``E_KEEP`` bids: count
    and max exactly, the average within ``agg_rel_bound``."""
    keep = E_KEEP
    cells, start, lens, price, n_w = element_golden(np, n_batches)
    c = rows["key"].astype(np.int64) * n_w + rows["window_start"] // 10_000
    check(len(np.unique(c)) == len(c), f"{label}: duplicate rows")
    check(np.array_equal(np.sort(c), cells),
          f"{label}: {len(c)} rows, expected {len(cells)}")
    g = np.searchsorted(cells, c)
    n = np.minimum(lens, keep)
    pos = np.arange(len(price)) - np.repeat(start, lens)
    surv = pos >= np.repeat(lens - n, lens)
    grp = np.repeat(np.arange(len(cells)), lens)[surv]
    tot = np.bincount(grp, weights=price[surv].astype(np.float64))
    mx = np.full(len(cells), -np.inf, np.float32)
    np.maximum.at(mx, grp, price[surv])
    check(np.array_equal(rows["count"], n[g]), f"{label}: counts differ")
    check(np.array_equal(rows["max_price"], mx[g]), f"{label}: max differs")
    want = tot[g] / n[g]
    rel = np.abs(rows["avg_price"].astype(np.float64) - want) / want
    check(bool((rel <= agg_rel_bound(n[g])).all()),
          f"{label}: averages outside the bound")
    return int(n.sum()), float(rel.max())


def check_job_e2(np, rows, n_batches, label):
    """A row for each (auction, window) at each ``E2_EVERY``-th bid, over
    the prefix so far: count and min exactly, the sum within
    ``agg_rel_bound``."""
    every = E2_EVERY
    cells, start, lens, price, n_w = element_golden(np, n_batches)
    want = {}
    for g in np.flatnonzero(lens >= every).tolist():
        p = price[start[g]:start[g] + lens[g]]
        for j in range(every, int(lens[g]) + 1, every):
            want[(int(cells[g]), j)] = (float(p[:j].astype(np.float64).sum()),
                                        p[:j].min())
    c = rows["key"].astype(np.int64) * n_w + rows["window_start"] // 10_000
    got = list(zip(c.tolist(), rows["count"].tolist()))
    check(len(set(got)) == len(got) and set(got) == set(want),
          f"{label}: {len(got)} fires, expected {len(want)}")
    share = 0.0
    for (cg, j), s_, m_ in zip(got, rows["sum_price"].tolist(),
                               rows["min_price"].tolist()):
        ws, wm = want[(cg, j)]
        check(np.float32(m_) == wm, f"{label}: min differs")
        share = max(share, abs(s_ - ws) / (agg_rel_bound(j) * ws))
    check(share <= 1.0, f"{label}: sums outside the bound")
    return len(want), share


def run_job_e(torch, np, n_batches, label):
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.ops import aggregates as ta
    from flink_tpu_torch.ops.evicting_window import CountEvictor

    return run_window_job(
        torch, np, bid_stream(bids_cfg(n_batches)),
        TumblingEventTimeWindows.of(10_000),
        ta.multi(ta.count(), ta.avg_of("price"), ta.max_of("price")), label,
        shape=lambda ws: ws.evictor(CountEvictor.of(E_KEEP)))


def run_job_e2(torch, np, n_batches, label):
    from flink_tpu_torch.api.windowing import (
        CountTrigger, TumblingEventTimeWindows)
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.ops import aggregates as ta

    return run_window_job(
        torch, np, bid_stream(bids_cfg(n_batches)),
        TumblingEventTimeWindows.of(10_000),
        ta.multi(ta.count(), ta.sum_of("price"), ta.min_of("price")), label,
        shape=lambda ws: ws.trigger(CountTrigger.of(E2_EVERY)))


def phase_element_window(torch, np):
    """Jobs E (count evictor) and E2 (count trigger) on the element path,
    each against its numpy golden; segment_lanes must have launched."""
    out = {"phase": "element_window", "conf": "confs/bench_q5_host_fed.conf",
           "rel_bound": "(2 * count + 34) * 2^-24"}
    per_call, launches_e = {}, None
    jobs = (("E", run_job_e, ELEMENT_BATCHES, check_job_e,
             "key_by(auction).window(10 s tumbling).evictor(CountEvictor"
             ".of(100)).aggregate(multi(count(), avg_of(price), "
             "max_of(price)))"),
            ("E2", run_job_e2, ELEMENT_TRIGGER_BATCHES, check_job_e2,
             "key_by(auction).window(10 s tumbling).trigger(CountTrigger"
             ".of(1000)).aggregate(multi(count(), sum_of(price), "
             "min_of(price)))"))
    runs = []
    for name, run, n_batches, _, job in jobs:
        run(torch, np, 1, f"element-{name}-warmup")
        rows, launches, res, wall = run(torch, np, n_batches, f"element-{name}")
        check(launches["segment_lanes"] > 0,
              f"job {name}: segment_lanes never launched")
        check(int(res.metrics["late_records"]) == 0,
              f"job {name}: late records")
        prof = profile_run(torch, lambda: run(
            torch, np, ELEMENT_SIDE_BATCHES, f"element-{name}-profiled")[3])
        for k, v in prof["device_ms_per_call"].items():
            per_call.setdefault(k, v)
        launches_e = launches_e or launches
        runs.append((name, n_batches, rows, launches, res, wall, prof, job))
    # the goldens' numpy work comes after the timed runs
    for (name, n_batches, rows, launches, res, wall, prof, job), \
            (_, _, _, check_fn, _) in zip(runs, jobs):
        reduced, worst = check_fn(np, rows, n_batches, f"job {name}")
        busy_ms = prof["device_busy_ms"]
        out[name] = {
            "job": job,
            **phase_summary(len(rows["key"]), launches, res, wall,
                            Q5_BATCH * n_batches, n_batches, prof),
            "windows": int(len(np.unique(rows["window_end"]))),
            ("elements_reduced" if name == "E" else "fires"): reduced,
            ("max_rel_err" if name == "E" else "max_share_of_sum_bound"): worst,
            "segment_lanes_share_of_device_ms": (
                prof["device_ms_by_wrapper"].get("segment_lanes", 0.0)
                / busy_ms if busy_ms else "not measured"),
            "host_s": {k: v for k, v in res.metrics.items()
                       if k.startswith("profile.") and "op" in k}}
        out[name]["profiled"]["batches"] = ELEMENT_SIDE_BATCHES
    out["card"] = card_line()
    emit(out)
    return launches_e, per_call


def run_proc_time(torch, np, n_batches, label):
    from flink_tpu_torch.api.windowing import TumblingProcessingTimeWindows
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.ops import aggregates as ta

    return run_window_job(
        torch, np, bid_stream(bids_cfg(n_batches)),
        TumblingProcessingTimeWindows.of(1_000), ta.count(), label)


# the kernels job P's path launches: the native lane's pair apply (every
# record of a batch takes the clock's one pane), the packed fire and the
# purge
PROC_TIME_KERNELS = ("apply_pairs_u32", "fire_pack", "ring_columns")


def phase_proc_time(torch, np):
    """Job P: Q5's count by auction over 1 s processing-time windows on
    16 batches of 2^20 host-fed bids: each auction's counts add up to its
    bids, each (auction, window) fires once."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    run_proc_time(torch, np, 2, "proc-time-warmup")
    rows, launches, res, wall = run_proc_time(torch, np, PROC_BATCHES,
                                              "proc-time")
    missing = [k for k in PROC_TIME_KERNELS if launches[k] == 0]
    check(not missing, f"proc_time: kernels not launched: {missing}")
    prof = profile_run(torch, lambda: run_proc_time(
        torch, np, SIDE_BATCHES, "proc-time-profiled")[3])
    check(prof["kernels_per_call"].get("fire_pack") == 1,
          f"proc_time: fire_pack kernels a call {prof['kernels_per_call']}")
    cfg = bids_cfg(PROC_BATCHES)
    want = np.zeros(cfg.num_active_auctions, np.int64)
    for i in range(PROC_BATCHES):
        want += np.bincount(bid_batch(cfg, 0, i)[0]["auction"],
                            minlength=cfg.num_active_auctions)
    a = rows["key"].astype(np.int64)
    pairs = set(zip(a.tolist(), rows["window_start"].tolist()))
    check(len(pairs) == len(a), "proc_time: an (auction, window) fired twice")
    got = np.bincount(a, weights=rows["count"],
                      minlength=cfg.num_active_auctions).astype(np.int64)
    check(np.array_equal(got, want),
          "proc_time: an auction's counts do not add up to its bids")
    out = {"phase": "proc_time", "conf": "confs/bench_q5_host_fed.conf",
           "job": "key_by(auction).window(TumblingProcessingTimeWindows"
                  ".of(1 s)).count()",
           "kernels_on_path": list(PROC_TIME_KERNELS),
           **phase_summary(len(a), launches, res, wall,
                           Q5_BATCH * PROC_BATCHES, PROC_BATCHES, prof),
           "windows": int(len(np.unique(rows["window_start"]))),
           "card": card_line()}
    emit(out)
    return launches, prof["device_ms_per_call"]


MESH_PATH = ("bucket_records", "window_counts", "topn_candidates",
             "topn_select_given", "ring_columns")


def by_window(rows):
    """Committed rows stably in window order: one drain reads each block's
    rows of every fire it covers in turn, so the order across windows is
    the drain cadence's; within a window it is the rows' (ascending slot)
    on one block or many."""
    return sorted(rows, key=lambda r: r[1])


def mesh_summary(rows_n, launches, res, wall, n_batches):
    busy, host = busy_and_host(res)
    events = Q5_BATCH * n_batches
    return {"events": events, "batches": n_batches, "wall_s": wall,
            "events_per_s": events / wall, "rows": rows_n,
            "launches": {k: v for k, v in launches.items() if v},
            "exchange_bytes": res.metrics["exchange_bytes"],
            "exchange_overflow": res.metrics["exchange_overflow"],
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
            "host_profile_s": host}


def phase_mesh(torch, np, local_rows):
    """The key-sharded window operator on a mesh of MESH_BLOCKS blocks on
    cuda:0 (``env.execute(mesh_plan=...)``): job M1 Q5 hot items at
    confs/bench_q5_host_fed.conf on 16 x 2^20 bids, against the golden
    and the single-block native-lane run's rows (``local_rows``); M2 the
    bid-aggregate job (a) per record (``fire_pack`` on every block), 4
    batches; M3 1,000 hot auctions under ``pipeline.exchange-capacity:
    16384`` (the host splitter; no record may overflow), 4 batches; M4
    Q5 with ``exchange.impl: ring``, 4 batches; and a profiled M1 run of
    4 batches."""
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    mesh = make_mesh_plan(128, 256, ["cuda:0"] * MESH_BLOCKS)
    cfg = bids_cfg(Q5_BATCHES)
    side = bids_cfg(MESH_SIDE_BATCHES)
    hot = dataclasses.replace(side, num_active_auctions=1_000, hot_ratio=2)
    rows, launches, res, wall = run_q5_host_fed(torch, np, cfg, "mesh-q5",
                                                mesh=mesh)
    missing = [k for k in MESH_PATH + ("scatter_counts",) if not launches[k]]
    check(not missing, f"M1: kernels not launched on the mesh: {missing}")
    check(launches["fused_step"] == 0 and launches["apply_pairs_u32"] == 0,
          "M1 took the one-device native lane")
    check(launches["topn_global_threshold"] == 0,
          "M1 launched topn_global_threshold: the select works it out")
    check(launches["split_cells"] == 0,
          "M1 launched split_cells: bucket_records decodes the bytes")
    a_rows, a_launches, a_res, a_wall, a_cfg = run_bid_agg(
        torch, np, "a", MESH_SIDE_BATCHES, "mesh-bid-agg-a", mesh=mesh)
    missing = [k for k in ("bucket_records", "scatter_lanes", "fire_pack",
                           "ring_columns") if not a_launches[k]]
    check(not missing, f"M2: kernels not launched on the mesh: {missing}")
    h_rows, h_launches, h_res, h_wall = run_q5_host_fed(
        torch, np, hot, "mesh-q5-hot-capacity", mesh=mesh,
        conf_extra={"pipeline.exchange-capacity": MESH_XCAP})
    check(h_res.metrics["exchange_overflow"] == 0, "M3: records overflowed")
    check(a_launches["split_cells"] == h_launches["split_cells"] == 0,
          "M2 / M3 launched split_cells: bucket_records decodes the bytes")
    r_rows, r_launches, r_res, r_wall = run_q5_host_fed(
        torch, np, side, "mesh-q5-ring", mesh=mesh,
        conf_extra={"exchange.impl": "ring"})
    prof = profile_run(torch, lambda: run_q5_host_fed(
        torch, np, side, "mesh-q5-profiled", mesh=mesh)[3], names=True)
    per_call = prof["kernels_per_call"]
    check(all(per_call.get(k) == 1 for k in ("topn_select_given",
                                             "bucket_records",
                                             "topn_candidates")),
          f"M1: kernels a call {per_call} (topn_select_given, bucket_records "
          f"and the top-1 topn_candidates one each)")
    dtod = {k: v for k, v in prof["copies"].items() if "DtoD" in k}
    check(not dtod, f"M1: device-to-device copies on one card: {dtod}")
    # the top-n fire gathers in place: no threshold kernel, no cat
    gather = [k for k in prof.pop("kernel_names")
              if "topn_global_threshold_kernel" in k or "CatArray" in k]
    check(not gather, f"M1: the top-n fire's gather launched {gather}")
    a_prof = profile_run(torch, lambda: run_bid_agg(
        torch, np, "a", MESH_SIDE_BATCHES, "mesh-bid-agg-a-profiled",
        mesh=mesh)[3])
    # the goldens' numpy work comes after the timed runs
    check_q5_rows(np, rows, cfg, "M1")
    check(by_window(rows) == by_window(local_rows),
          "M1: rows differ from the single-block run's")
    rel, share = check_bid_agg(np, "a", a_rows, bid_golden(np, a_cfg), "M2")
    check_q5_rows(np, h_rows, hot, "M3")
    check_q5_rows(np, r_rows, side, "M4")
    # the bytes that crossed between distinct blocks: a 2^20-bid batch is
    # one chunk of MESH_BLOCKS blocks of L records (int32 cells and a
    # valid byte a position); all-to-all moves each block's n - 1 foreign
    # rows of L, ring n - 1 hops of each block's whole n rows
    L, n = Q5_BATCH // MESH_BLOCKS, MESH_BLOCKS
    check(res.metrics["exchange_bytes"] == n * (n - 1) * L * 5 * Q5_BATCHES
          and r_res.metrics["exchange_bytes"]
          == n * n * (n - 1) * L * 5 * MESH_SIDE_BATCHES,
          f"exchange bytes M1 {res.metrics['exchange_bytes']}, M4 "
          f"{r_res.metrics['exchange_bytes']}")
    out = {"phase": "mesh", "blocks": MESH_BLOCKS,
           "devices": [str(d) for d in mesh.devices],
           "conf": "confs/bench_q5_host_fed.conf",
           "M1": mesh_summary(len(rows), launches, res, wall, Q5_BATCHES),
           "M2": {**mesh_summary(len(a_rows["key"]), a_launches, a_res,
                                 a_wall, MESH_SIDE_BATCHES),
                  "max_rel_err": rel, "max_share_of_bound": share,
                  "profiled": {"batches": MESH_SIDE_BATCHES, **a_prof}},
           "M3": {**mesh_summary(len(h_rows), h_launches, h_res, h_wall,
                                 MESH_SIDE_BATCHES),
                  "auctions": hot.num_active_auctions,
                  "exchange_capacity": MESH_XCAP,
                  "dispatches": h_launches["bucket_records"] // MESH_BLOCKS},
           "M4": {**mesh_summary(len(r_rows), r_launches, r_res, r_wall,
                                 MESH_SIDE_BATCHES), "exchange_impl": "ring"},
           "profiled": {"batches": MESH_SIDE_BATCHES, **prof},
           "card": card_line()}
    emit(out)
    return launches, prof["device_ms_per_call"], a_prof["device_ms_per_call"]


def phase_mesh_cards(torch, np):
    """``--mesh-cards``: Q5 over a mesh of one block per visible card
    (the exchange's peer copies between cards), 16 x 2^20 bids, then the
    ring exchange on 4 batches; rows against the golden."""
    from flink_tpu_torch.parallel.mesh import make_mesh_plan

    n = torch.cuda.device_count()
    check(n > 1, f"--mesh-cards needs several cards, {n} visible")
    mesh = make_mesh_plan(128, 256, [f"cuda:{i}" for i in range(n)])
    cfg, side = bids_cfg(Q5_BATCHES), bids_cfg(MESH_SIDE_BATCHES)
    rows, launches, res, wall = run_q5_host_fed(torch, np, cfg,
                                                "mesh-cards-q5", mesh=mesh)
    missing = [k for k in MESH_PATH + ("scatter_counts",) if not launches[k]]
    check(not missing, f"kernels not launched on the cards: {missing}")
    r_rows, r_launches, r_res, r_wall = run_q5_host_fed(
        torch, np, side, "mesh-cards-ring", mesh=mesh,
        conf_extra={"exchange.impl": "ring"})
    check(launches["split_cells"] == r_launches["split_cells"] == 0,
          "split_cells launched over the cards: bucket_records decodes "
          "the bytes")
    check_q5_rows(np, rows, cfg, "Q5 over the cards")
    check_q5_rows(np, r_rows, side, "Q5 over the cards, ring")
    emit({"phase": "mesh_cards", "devices": [str(d) for d in mesh.devices],
          "cards": [torch.cuda.get_device_name(i) for i in range(n)],
          "q5": mesh_summary(len(rows), launches, res, wall, Q5_BATCHES),
          "ring": mesh_summary(len(r_rows), r_launches, r_res, r_wall,
                               MESH_SIDE_BATCHES),
          "card": card_line()})


# -- slice 21: sessions, Q8 and Q7 (the host pool's operators) ---------------

SESSION_USERS = 50_000          # bench.py:694, BASELINE config #4
SESSION_BATCH = 1 << 20         # confs/bench_sessions.conf
SESSION_BATCHES = 12
SESSION_GAP = 500
SESSION_LATENESS = 5_000
SESSION_OOO = 1_000
CKPT_SESSION_BATCHES = 4        # the checkpoint phase's sessions job
CKPT_POOL_FAULT = "host.pool.task=raise x1 +20"
Q8_PEOPLE = 100_000             # bench.py:408-438, confs/bench_q8.conf
Q8_BATCH = 1 << 18
Q8_BATCHES = 24
Q7_BATCH = 1 << 18              # bench.py:385-405, confs/bench_q7.conf
Q7_BATCHES = 24
DEFER_BATCHES = 8               # Q5 host-fed at pipeline.emit-defer 500 ms
Q8_DEVICE_KERNELS = ("scatter_lanes", "fire_pack", "ring_columns")


def columns_sink(np, parts):
    """A FnSink that keeps each delivered batch's columns."""
    from flink_tpu_torch.api.sinks import FnSink

    return FnSink(lambda b: parts.append(
        {k: np.asarray(v).copy() for k, v in b.items()}))


def concat_parts(np, parts):
    if not parts:
        return {}
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def run_timed(torch, env, label):
    """``env.execute`` on the card between syncs: (JobResult, wall
    seconds, the launches of the run)."""
    from flink_tpu_torch.kernels import window_kernels as wk

    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(wk.LAUNCHES)


def session_gen(np, n_batches, batch, users):
    """bench.py:697-708's clicks: ``users`` users, activity in 1 s bursts
    a batch apart in event time, 2 % of the records up to 3 s late."""
    def gen(split, i):
        if i >= n_batches:
            return None
        rng = np.random.default_rng(i)
        user = rng.integers(0, users, batch).astype(np.int64)
        base = i * batch // 100
        ts = base + rng.integers(0, 1000, batch)
        late = rng.random(batch) < 0.02
        ts = np.where(late, np.maximum(ts - 3000, 0), ts).astype(np.int64)
        return ({"user": user}, ts)
    return gen


def build_sessions(gen, sink, conf):
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.api.windowing import EventTimeSessionWindows
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    env = StreamExecutionEnvironment(conf)
    (env.from_source(GeneratorSource(gen),
                     WatermarkStrategy.for_bounded_out_of_orderness(SESSION_OOO))
        .key_by("user")
        .window(EventTimeSessionWindows.with_gap(SESSION_GAP))
        .allowed_lateness(SESSION_LATENESS)
        .count()
        .add_sink(sink))
    return env


def sessions_golden(np, gen, n_batches):
    """A brute-force sessionizer over every record: (user, start, end,
    count) sorted, and the records beyond the lateness when they arrive
    (the watermark before their batch)."""
    users, tss, late, wm_max = [], [], 0, None
    for i in range(n_batches):
        data, ts = gen("0", i)
        if wm_max is not None:
            wm = wm_max - SESSION_OOO - 1
            late += int((ts + SESSION_GAP - 1 + SESSION_LATENESS <= wm).sum())
        wm_max = max(wm_max or int(ts.max()), int(ts.max()))
        users.append(data["user"])
        tss.append(ts)
    u, t = np.concatenate(users), np.concatenate(tss)
    o = np.lexsort((t, u))
    u, t = u[o], t[o]
    new = np.ones(len(u), bool)
    new[1:] = (u[1:] != u[:-1]) | (t[1:] - t[:-1] > SESSION_GAP)
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], len(u))
    golden = np.stack([u[starts], t[starts], t[ends - 1] + SESSION_GAP,
                       ends - starts], axis=1)
    return golden, late


def final_session_rows(np, rows):
    """Each session's last row in commit order (a re-fired session
    supersedes its key's earlier rows whose start it covers), sorted."""
    k, s, e, c = (rows[f] for f in ("key", "window_start", "window_end",
                                    "count"))
    if len(np.unique(np.stack([k, s], 1), axis=0)) == len(k) and not (
            len(k) and _covered(np, k, s, e)):
        out = np.stack([k, s, e, c.astype(np.int64)], axis=1)
    else:
        final = {}
        for kk, ss, ee, cc in zip(k.tolist(), s.tolist(), e.tolist(),
                                  c.tolist()):
            final = {key: v for key, v in final.items()
                     if not (key[0] == kk and ss <= key[1] < ee)}
            final[(kk, ss)] = (ee, cc)
        out = np.array([(kk, ss, ee, cc) for (kk, ss), (ee, cc)
                        in final.items()], np.int64).reshape(-1, 4)
    return out[np.lexsort((out[:, 1], out[:, 0]))]


def _covered(np, k, s, e):
    """Whether any row's start lies inside another row of its key."""
    o = np.lexsort((s, k))
    k, s, e = k[o], s[o], e[o]
    return bool(((k[1:] == k[:-1]) & (s[1:] < e[:-1])).any())


def batch_copy_ms(torch, np, gen):
    """The time to copy one batch's columns (user and ts, int64) to the
    card and back, pageable host memory, median of 5 (ms each way)."""
    data, ts = gen("0", 0)
    cols = [data["user"], ts]
    up, down = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on = [torch.from_numpy(c).to("cuda") for c in cols]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = [t.cpu() for t in on]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(all(np.array_equal(b.numpy(), c) for b, c in zip(back, cols)),
              "sessions: the batch's round trip changed its columns")
        up.append((t1 - t0) * 1e3)
        down.append((t2 - t1) * 1e3)
    nbytes = sum(c.nbytes for c in cols)
    return {"bytes": nbytes, "to_card_ms": float(np.median(up[1:])),
            "to_host_ms": float(np.median(down[1:])),
            "to_card_GBps": nbytes / np.median(up[1:]) / 1e6}


def phase_sessions(torch, np):
    """BASELINE config #4 (bench.py:683-726, confs/bench_sessions.conf):
    session windows over a click stream through ``env.execute()`` at
    host.parallelism 1 and 4; rows byte-identical between the two and
    equal to the brute-force sessionizer, late drops equal to its
    count; no kernel launches (the lift and finalize are torch on the
    CPU by design); the batch's copy to the card and back beside."""
    from flink_tpu_torch.config import Configuration

    n_batches, batch = SESSION_BATCHES, SESSION_BATCH
    gen = session_gen(np, n_batches, batch, SESSION_USERS)
    runs = {}
    for w in (1, 4):
        conf = Configuration.from_file(
            os.path.join(ROOT, "confs", "bench_sessions.conf"))
        conf.set("pipeline.microbatch-size", batch)
        conf.set("host.parallelism", w)
        parts = []
        env = build_sessions(gen, columns_sink(np, parts), conf)
        res, wall, launches = run_timed(torch, env, f"sessions-w{w}")
        runs[w] = (concat_parts(np, parts), res, wall, launches)
    (r1, res1, _, l1), (r4, res4, _, l4) = runs[1], runs[4]
    check(set(r1) == set(r4) and all(
        r1[k].dtype == r4[k].dtype and np.array_equal(r1[k], r4[k])
        for k in r1), "sessions: rows at host.parallelism 4 differ from 1")
    golden, late = sessions_golden(np, gen, n_batches)
    got = final_session_rows(np, r1)
    check(got.shape == golden.shape and np.array_equal(got, golden),
          f"sessions: {len(got)} final sessions against the golden's "
          f"{len(golden)}, or other values")
    check(res1.metrics["late_records"] == res4.metrics["late_records"] == late,
          f"sessions: late drops {res1.metrics['late_records']} / "
          f"{res4.metrics['late_records']}, the golden {late}")
    for w, (_, _, _, launches) in runs.items():
        check(not any(launches.values()),
              f"sessions w={w} launched kernels: {launches}")
    events = n_batches * batch
    out = {"phase": "sessions", "events": events, "batches": n_batches,
           "rows": int(len(r1["key"])), "sessions": int(len(golden)),
           "late_records": late,
           "by_parallelism": {
               str(w): {"wall_s": wall, "events_per_s": events / wall,
                        "pool_tasks": res.metrics.get("hostpool.tasks_total"),
                        "host_profile_s": busy_and_host(res)[1]}
               for w, (_, res, wall, _) in runs.items()},
           "batch_copy": batch_copy_ms(torch, np, gen),
           "card": card_line()}
    emit(out)
    return out


def q8_cfg(n_batches, batch, people):
    from flink_tpu_torch.nexmark.generator import NexmarkConfig

    # bench.py:420-421
    return NexmarkConfig(batch_size=batch, n_batches=n_batches,
                         events_per_ms=100, num_active_people=people)


def run_q8(torch, np, mode, cfg):
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import auction_stream, person_stream
    from flink_tpu_torch.nexmark.queries import q8_monitor_new_users

    conf = Configuration.from_file(os.path.join(ROOT, "confs",
                                                "bench_q8.conf"))
    conf.set("pipeline.microbatch-size", cfg.batch_size)
    parts = []
    env = StreamExecutionEnvironment(conf)
    # bench.py:432-433: 1 s windows, 1 s out of order
    q8_monitor_new_users(env, person_stream(cfg), auction_stream(cfg),
                         columns_sink(np, parts), window_ms=1_000,
                         out_of_orderness_ms=1_000, mode=mode)
    res, wall, launches = run_timed(torch, env, f"q8-{mode}")
    return concat_parts(np, parts), res, wall, launches


def q8_sides(np, cfg):
    """Both inputs' (window end, key, carried field), from the
    generators' batches."""
    from flink_tpu_torch.nexmark.generator import auction_batch, person_batch

    L = [person_batch(cfg, 0, i) for i in range(cfg.n_batches)]
    R = [auction_batch(cfg, 0, i) for i in range(cfg.n_batches)]

    def side(parts, key, field):
        ts = np.concatenate([t for _, t in parts])
        return (ts // 1000 * 1000 + 1000,
                np.concatenate([d[key] for d, _ in parts]),
                np.concatenate([d[field] for d, _ in parts]))
    return side(L, "person", "state_id"), side(R, "seller", "reserve")


def q8_pairs_golden(np, cfg):
    """Every person ⋈ seller pair of a window, by searchsorted ranges of
    the sorted right side: (window_end, key, state_id, reserve) rows."""
    (lw, lk, ls), (rw, rk, rv) = q8_sides(np, cfg)
    span = int(max(lk.max(), rk.max())) + 1
    lcode, rcode = lw * span + lk, rw * span + rk
    o = np.argsort(rcode, kind="stable")
    rs = rcode[o]
    lo = np.searchsorted(rs, lcode, "left")
    n = np.searchsorted(rs, lcode, "right") - lo
    li = np.repeat(np.arange(len(lcode)), n)
    first = np.repeat(lo, n)
    within = np.arange(len(li)) - np.repeat(np.cumsum(n) - n, n)
    ri = o[first + within]
    return sort_rows(np, [lw[li], lk[li], ls[li].astype(np.float64),
                          rv[ri].astype(np.float64)])


def q8_aggregate_golden(np, cfg):
    """Per (key, window) on both sides: (key, window_end, each side's
    count and the max of its carried field), by group-by over sorted
    codes."""
    (lw, lk, ls), (rw, rk, rv) = q8_sides(np, cfg)
    span = int(max(lk.max(), rk.max())) + 1

    def groups(w, k, v):
        code = w * span + k
        o = np.argsort(code, kind="stable")
        c = code[o]
        starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
        return (c[starts], np.diff(np.r_[starts, len(c)]),
                np.maximum.reduceat(v[o].astype(np.float64), starts))

    lc, ln, lm = groups(lw, lk, ls)
    rc, rn, rm = groups(rw, rk, rv)
    common, li, ri = np.intersect1d(lc, rc, return_indices=True)
    return sort_rows(np, [common % span, common // span, ln[li],
                          lm[li], rn[ri], rm[ri]])


def sort_rows(np, cols):
    arr = np.stack([np.asarray(c, np.float64) for c in cols], axis=1)
    return arr[np.lexsort(arr.T[::-1])]


def phase_q8(torch, np):
    """BASELINE config #3, Nexmark Q8 (bench.py:408-438,
    confs/bench_q8.conf) through ``env.execute()`` in both join modes:
    pairs (the host row buffers and the ragged cross product) against
    the exact person ⋈ seller pairs of each window; aggregate (each side
    a device WindowOperator: scatter_lanes, fire_pack and ring_columns on
    the card) against each (key, window)'s counts and maxima."""
    cfg = q8_cfg(Q8_BATCHES, Q8_BATCH, Q8_PEOPLE)
    out = {"phase": "q8", "events": 2 * Q8_BATCHES * Q8_BATCH,
           "batches": Q8_BATCHES}
    pairs, res, wall, launches = run_q8(torch, np, "pairs", cfg)
    got = sort_rows(np, [pairs["window_end"], pairs["key"],
                         pairs["left_state_id"], pairs["right_reserve"]])
    want = q8_pairs_golden(np, cfg)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"q8 pairs: {len(got)} pairs against the golden's {len(want)}, "
          "or other values")
    check(not any(launches.values()), f"q8 pairs launched {launches}")
    out["pairs"] = {"rows": int(len(got)), "wall_s": wall,
                    "events_per_s": out["events"] / wall,
                    "late_records": res.metrics["late_records"],
                    "host_profile_s": busy_and_host(res)[1]}
    agg, res, wall, launches = run_q8(torch, np, "aggregate", cfg)
    got = sort_rows(np, [agg["key"], agg["window_end"], agg["left_count"],
                         agg["left_state_id"], agg["right_count"],
                         agg["right_reserve"]])
    want = q8_aggregate_golden(np, cfg)
    check(got.shape == want.shape and np.array_equal(got, want),
          f"q8 aggregate: {len(got)} rows against the golden's {len(want)}, "
          "or other values")
    missing = [k for k in Q8_DEVICE_KERNELS if not launches.get(k)]
    check(not missing, f"q8 aggregate: kernels not launched {missing}")
    ran = {k: launches[k] for k in UNLAUNCHED if launches.get(k)}
    check(not ran, f"q8 aggregate: launched kernels no path calls: {ran}")
    busy, host = busy_and_host(res)
    out["aggregate"] = {
        "rows": int(len(got)), "wall_s": wall,
        "events_per_s": out["events"] / wall,
        "launches": {k: launches.get(k, 0) for k in Q8_DEVICE_KERNELS},
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
        "host_profile_s": host}
    out["card"] = card_line()
    emit(out)
    return out


def phase_q7(torch, np):
    """BASELINE config #2, Nexmark Q7 (bench.py:385-405,
    confs/bench_q7.conf): the highest bid of each 10 s window through
    windowAll's host pane fold, against each window's max price and bid
    count from numpy."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import (
        NexmarkConfig, bid_batch, bid_stream)
    from flink_tpu_torch.nexmark.queries import q7_highest_bid

    n_batches, batch = Q7_BATCHES, Q7_BATCH
    cfg = NexmarkConfig(batch_size=batch, n_batches=n_batches,
                        events_per_ms=100, num_active_auctions=10_000,
                        hot_ratio=4)
    conf = Configuration.from_file(os.path.join(ROOT, "confs",
                                                "bench_q7.conf"))
    conf.set("pipeline.microbatch-size", batch)
    parts = []
    env = StreamExecutionEnvironment(conf)
    q7_highest_bid(env, bid_stream(cfg), columns_sink(np, parts),
                   window_ms=10_000, out_of_orderness_ms=1_000)
    res, wall, launches = run_timed(torch, env, "q7")
    rows = concat_parts(np, parts)
    bids = [bid_batch(cfg, 0, i) for i in range(n_batches)]
    price = np.concatenate([d["price"] for d, _ in bids])
    we = np.concatenate([t for _, t in bids]) // 10_000 * 10_000 + 10_000
    ends, inv, counts = np.unique(we, return_inverse=True, return_counts=True)
    best = np.full(len(ends), -np.inf, np.float32)
    np.maximum.at(best, inv, price)
    o = np.argsort(rows["window_end"], kind="stable")
    check(np.array_equal(rows["window_end"][o], ends)
          and np.array_equal(rows["max_price"][o], best)
          and np.array_equal(rows["count"][o], counts),
          "q7: windows, max prices or counts differ from the golden")
    check(not any(launches.values()), f"q7 launched {launches}")
    events = n_batches * batch
    out = {"phase": "q7", "events": events, "batches": n_batches,
           "windows": int(len(ends)), "wall_s": wall,
           "events_per_s": events / wall,
           "pool_tasks": res.metrics.get("hostpool.tasks_total"),
           "host_profile_s": busy_and_host(res)[1], "card": card_line()}
    emit(out)
    return out


def phase_emit_defer(torch, np):
    """Q5 host-fed at ``pipeline.emit-defer: 500ms`` commits the rows of
    the run at 0, in the same order (only their delivery waits)."""
    cfg = bids_cfg(DEFER_BATCHES)
    runs = {}
    for defer in ("0ms", "500ms"):
        rows, launches, res, wall = run_q5_host_fed(
            torch, np, cfg, f"q5-defer-{defer}",
            conf_extra={"pipeline.emit-defer": defer})
        runs[defer] = (rows, wall, res)
    check(runs["0ms"][0] == runs["500ms"][0],
          "emit_defer: rows at 500 ms differ from those at 0")
    check_q5_rows(np, runs["0ms"][0], cfg, "emit_defer")
    out = {"phase": "emit_defer", "rows": len(runs["0ms"][0]),
           "batches": DEFER_BATCHES,
           "wall_s": {k: v[1] for k, v in runs.items()},
           "emit_latency_ms": {
               k: {q: v[2].metrics.get(f"driver.emit_latency_ms.{q}")
                   for q in ("p50", "max")}
               for k, v in runs.items()},
           "card": card_line()}
    emit(out)
    return out


# -- the hybrid phase: one job across two processes on one card ---------------

HYBRID_BATCHES = 8              # 2^20-bid batches a split, a split a process
HYBRID_CRASH_BATCH = 3          # process 1 dies at this batch or later
HYBRID_PROFILED_BATCHES = 2     # a split's batches in the profiled run


def hybrid_cfg(n_batches):
    """bench.py:206-208's bids (100 a ms, 10,000 auctions, hot ratio 4) in
    two splits of ``n_batches`` 2^20-bid batches, interleaved in event
    time."""
    return dataclasses.replace(bids_cfg(n_batches), n_splits=2)


def hybrid_worker(torch, np, spec):
    """``--hybrid-worker SPEC``: one process of the hybrid phase's job.
    SPEC (JSON) names the process id, the peers and this process's ports
    (one a run), the secret, the output directory, and whether the run
    restores, crashes or is profiled. Writes its result as JSON to
    ``<out>/result-p<pid>-<tag>.json``."""
    from flink_tpu_torch.kernels import exchange_kernels as xk
    from flink_tpu_torch.kernels import window_kernels as wk

    pid, out = spec["pid"], spec["out"]
    result = {"pid": pid, "card": card_line()}
    if spec.get("crash"):
        result["crash"] = run_hybrid_job(torch, np, spec, "crash",
                                         HYBRID_BATCHES, crash=True)
    elif spec.get("restore"):
        result["restore"] = run_hybrid_job(torch, np, spec, "restore",
                                           HYBRID_BATCHES, restore=True)
    else:
        # the timed run: every X1 call's shape, for its bound
        shapes = []
        real = xk.bucket_records_into

        def recorded(cells, payload, n_dest, capacity, spd, ring, recv, j):
            shapes.append((int(cells.shape[0]), 3 if cells.dim() == 2
                           else cells.element_size(), int(n_dest),
                           int(capacity), int(spd), int(ring),
                           0 if payload is None else int(payload.shape[1])))
            return real(cells, payload, n_dest, capacity, spd, ring, recv, j)

        xk.bucket_records_into = recorded
        try:
            result["timed"] = run_hybrid_job(torch, np, spec, "timed",
                                             HYBRID_BATCHES)
        finally:
            xk.bucket_records_into = real
        result["timed"]["x1_shapes"] = shapes
        # a shorter run under torch.profiler: X1's kernels inside
        # intra_slice_exchange's ranges
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p = run_hybrid_job(torch, np, spec, "profiled",
                               HYBRID_PROFILED_BATCHES)
        p.update(x1_in_ranges(torch, prof, wk.LAUNCHES["bucket_records"]))
        result["profiled"] = p
        # one card a process and no mesh plan: each process runs its span
        # on one block (the single-device operator with its shard range)
        result["local"] = run_hybrid_job(torch, np, spec, "local",
                                         HYBRID_PROFILED_BATCHES, mesh=False)
    with open(os.path.join(out, f"result-p{pid}-{spec['tag']}.json"),
              "w") as f:
        json.dump(result, f)


def run_hybrid_job(torch, np, spec, run, n_batches, crash=False,
                   restore=False, mesh=True):
    """Q5's count stage (sliding 10 s / 1 s COUNT per auction, no top-n)
    at confs/bench_q5_host_fed.conf as process ``spec["pid"]`` of two,
    over its ``HybridMeshPlan`` of two blocks of cuda:0 (``mesh`` False:
    no plan, so the environment's own choice for one visible card, one
    block over the process's span), reading its split of
    ``hybrid_cfg(n_batches)``, into a ``FileTransactionalSink`` with a
    checkpoint every 1 ms (the profiled and local runs: no checkpoints).
    ``crash``:
    the source of process 1 exits (``os._exit(43)``) at batch
    HYBRID_CRASH_BATCH or later once a checkpoint of its own is
    complete."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FileTransactionalSink
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.parallel.mesh import make_hybrid_mesh_plan
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    pid = spec["pid"]
    root = os.path.join(spec["out"], run if run != "restore" else "crash")
    ckpt = os.path.join(root, "ckpt")
    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    for k, v in (("cluster.num-processes", 2), ("cluster.process-id", pid),
                 ("cluster.dcn-peers", spec["peers"][run]),
                 ("cluster.dcn-port", spec["ports"][run]),
                 ("cluster.dcn-secret", spec["secret"])):
        conf.set(k, v)
    if run not in ("profiled", "local"):
        conf.set("execution.checkpointing.interval", 1)
        conf.set("execution.checkpointing.dir", ckpt)
    if restore:
        conf.set("execution.checkpointing.restore", "latest")
    src = bid_stream(hybrid_cfg(n_batches))
    if crash and pid == 1:
        inner = src.gen

        def gen(split, i):
            if i >= HYBRID_CRASH_BATCH and FsCheckpointStorage(
                    ckpt, f"hybrid-p{pid}").latest() is not None:
                os._exit(43)
            return inner(split, i)
        src = GeneratorSource(gen, n_splits=src.n_splits)
    sink = FileTransactionalSink(os.path.join(root, f"sink-p{pid}"))
    env = StreamExecutionEnvironment(conf)
    (env.from_source(src, WatermarkStrategy.for_bounded_out_of_orderness(
        1_000))
     .key_by("auction").window(SlidingEventTimeWindows.of(10_000, 1_000))
     .count().add_sink(sink))
    plan = (make_hybrid_mesh_plan(128, 256, 2, pid, ["cuda:0", "cuda:0"])
            if mesh else None)
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute("hybrid", device="cuda", mesh_plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, host = busy_and_host(res)
    m = res.metrics
    events = Q5_BATCH * n_batches
    return {"events": events, "wall_s": wall, "events_per_s": events / wall,
            "launches": dict(wk.LAUNCHES),
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
            "records_in": m["records_in"], "late_records": m["late_records"],
            "exchange_overflow": m["exchange_overflow"],
            "intra_exchange_bytes": m["exchange_bytes"],
            "dcn_bytes_sent": m["dcn.bytes_sent"],
            "dcn_records_routed": m["dcn.records_routed"],
            "dcn_records_sent": m["dcn.records_sent"],
            "cross_slice_fraction": (m["dcn.records_sent"]
                                     / max(m["dcn.records_routed"], 1)),
            "rendezvous_wait_ms": {q: m[f"dcn.wait_ms.{q}"]
                                   for q in ("p50", "p99", "max", "count")},
            "checkpoints_completed": m.get("checkpoints_completed", 0),
            "mesh_devices": m.get("mesh_devices"), "host_profile_s": host}


def x1_in_ranges(torch, prof, launches):
    """X1's kernels in a profile and those inside the device-side marks of
    ``intra_slice_exchange``'s profiler ranges (from the first to the last
    kernel launched inside each)."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e for e in dev if e.name == "intra_slice_exchange"]
    x1 = [e for e in dev
          if any(k in e.name for k in PROFILED_KERNELS["bucket_records"])]
    inside = [k for k in x1 if any(
        m.time_range.start <= k.time_range.start
        and k.time_range.end <= m.time_range.end for m in marks)]
    cpu_ranges = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.name == "intra_slice_exchange")
    return {"x1_launches": launches, "x1_kernels": len(x1),
            "x1_in_intra_slice_exchange": len(inside),
            "intra_slice_exchange_calls": cpu_ranges,
            "intra_slice_exchange_marks": len(marks),
            "x1_device_ms_per_call": (
                sum(k.time_range.end - k.time_range.start for k in x1)
                / 1e3 / len(x1) if x1 else None)}


def spawn_hybrid(spec):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--hybrid-worker",
         json.dumps(spec)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def wait_hybrid(procs, label, expect=(0, 0)):
    """Wait for both workers (a hang fails the phase; every process is
    stopped before this returns) and check their exit codes; ``expect``
    None for a code that only must not be 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=HYBRID_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, want) in enumerate(zip(procs, expect)):
        ok = p.returncode != 0 if want is None else p.returncode == want
        check(ok, f"hybrid {label}: process {pid} exited {p.returncode}:\n"
                  + outs[pid][-4000:])
    return outs


HYBRID_TIMEOUT_S = 300


def hybrid_rows(root):
    from flink_tpu_torch.api.sinks import FileTransactionalSink

    return [(r["key"], r["window_end"], r["count"]) for pid in range(2)
            for r in FileTransactionalSink.committed_rows(
                os.path.join(root, f"sink-p{pid}"))]


def free_ports(n):
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def x1_hybrid_bound(shapes):
    """X1's bound a call on the hybrid path, as its kernels-phase row
    counts it: each record read once (its cell form and lanes), every
    bucket position written once (cell, valid byte, lanes), the overflow
    words."""
    bounds = [bound_ms(b * (cb + 4 * c) + n * cap * (5 + 4 * c) + 4 * n,
                       b * n)[0]
              for b, cb, n, cap, _, _, c in shapes]
    return sum(bounds) / len(bounds)


def phase_hybrid(torch, np):
    """One job across two processes on one card: Q5's count stage (sliding
    10 s / 1 s COUNT per auction, no top-n) at
    confs/bench_q5_host_fed.conf's widths on 16 x 2^20 bids in two splits,
    a split a process. Each process (this script with --hybrid-worker)
    runs ``make_hybrid_mesh_plan(128, 256, 2, pid, ["cuda:0", "cuda:0"])``
    through ``execute(mesh_plan=...)``, the processes connected on
    loopback with ``cluster.dcn-secret`` set, into a
    ``FileTransactionalSink`` with a checkpoint every 1 ms. Checks: the
    union of both processes' committed rows against the single-process
    run on the card and the numpy golden; every worker's exit code; X1's
    kernels inside ``intra_slice_exchange``'s profiler ranges; and a
    second run in which process 1 dies after a checkpoint, both restart
    with the negotiated restore, and the union is again the golden's."""
    import secrets
    import shutil

    from flink_tpu_torch.kernels import exchange_kernels as xk

    out = os.path.join(ROOT, "flink_tpu_torch", "_build", "hybrid")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg = hybrid_cfg(HYBRID_BATCHES)
    single, s_launches, s_res, s_wall = run_q5_count_only(
        torch, np, cfg, "hybrid-single-process")
    secret = secrets.token_hex(16)

    def specs(tag, runs, **kw):
        ports = {r: free_ports(2) for r in runs}
        peers = {r: ",".join(f"127.0.0.1:{p}" for p in ps)
                 for r, ps in ports.items()}
        return [dict(pid=pid, out=out, secret=secret, tag=tag, peers=peers,
                     ports={r: ports[r][pid] for r in runs}, **kw)
                for pid in range(2)]

    def results(tag):
        res = []
        for pid in range(2):
            with open(os.path.join(out, f"result-p{pid}-{tag}.json")) as f:
                res.append(json.load(f))
        return res

    # the timed run, then a profiled one and one without a mesh plan, in
    # the same two processes
    wait_hybrid([spawn_hybrid(s) for s in specs(
        "timed", ("timed", "profiled", "local"))], "timed run")
    timed = results("timed")
    rows = hybrid_rows(os.path.join(out, "timed"))
    local_rows = hybrid_rows(os.path.join(out, "local"))
    # process 1 dies after a checkpoint; process 0 fails on the exchange
    wait_hybrid([spawn_hybrid(s) for s in specs("crash", ("crash",),
                                                 crash=True)],
                "crash", expect=(None, 43))
    # both hold a completed checkpoint, so the restore resumes one (a
    # replay from the start would repeat an epoch committed already)
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

    for pid in range(2):
        check(FsCheckpointStorage(os.path.join(out, "crash", "ckpt"),
                                  f"hybrid-p{pid}").latest() is not None,
              f"hybrid crash: process {pid} holds no checkpoint")
    wait_hybrid([spawn_hybrid(s) for s in specs("restore", ("restore",),
                                                 restore=True)],
                "restore")
    restored = results("restore")
    crash_rows = hybrid_rows(os.path.join(out, "crash"))
    # X1 at the path's median shape: against its plain version (every
    # receive position and the overflow words, bit for bit), then its
    # loop ms
    shapes = sorted(s for r in timed for s in r["timed"]["x1_shapes"])
    check(shapes, "hybrid: no X1 call on the path")
    b, cb, n_dest, cap, spd, ring, C = shapes[len(shapes) // 2]
    rng = np.random.default_rng(SEED + 22)
    cells_np = mesh_cells(np, rng, 10_000, b, n_dest * spd, ring)
    sc = torch.from_numpy(split_bytes(np, cells_np, ring) if cb == 3
                          else cells_np).cuda()
    pay = (torch.from_numpy(rng.random((b, C)).astype(np.float32)).cuda()
           if C else None)

    def recv_rows():
        # filled with what neither version writes, so a position left
        # unwritten shows
        shape = (n_dest, n_dest, cap)
        return (torch.full(shape, -2, dtype=xk.bucket_cell_dtype(sc),
                           device="cuda"),
                torch.full(shape + (C,), -2.0, device="cuda") if C else None,
                torch.ones(shape, dtype=torch.bool, device="cuda"))
    recv, want = recv_rows(), recv_rows()
    for j in range(n_dest):
        ov = xk.bucket_records_into(sc, pay, n_dest, cap, spd, ring, recv, j)
        ov_plain = xk.bucket_records_into_plain(sc, pay, n_dest, cap, spd,
                                                ring, want, j)
        torch.cuda.synchronize()
        check(torch.equal(ov, ov_plain),
              f"hybrid: bucket_records_into's overflow {ov.tolist()} "
              f"differs from its plain version's {ov_plain.tolist()}")
    check(all(torch.equal(x, y) for x, y in zip(recv, want)
              if x is not None),
          "hybrid: bucket_records_into differs from its plain version at "
          f"the path's median shape {shapes[len(shapes) // 2]}")
    loop_ms = time_ms(torch, lambda: xk.bucket_records_into(
        sc, pay, n_dest, cap, spd, ring, recv, 0))
    # the goldens' numpy work comes after the timed runs
    check_q5_counts(np, single, cfg, "hybrid single process")
    check(sorted(rows) == sorted(single),
          "hybrid: the union of the processes' rows differs from the "
          "single-process run's")
    check_q5_counts(np, rows, cfg, "hybrid union")
    check_q5_counts(np, crash_rows, cfg, "hybrid union after the crash")
    check_q5_counts(np, local_rows, hybrid_cfg(HYBRID_PROFILED_BATCHES),
                    "hybrid union without a mesh plan")
    x1 = {"launches": sum(r["timed"]["launches"]["bucket_records"]
                          for r in timed)}
    for r in timed:
        t, p = r["timed"], r["profiled"]
        check(t["late_records"] == 0 and t["exchange_overflow"] == 0,
              f"hybrid p{r['pid']}: late or overflowed records {t}")
        check(t["launches"]["bucket_records"] > 0,
              f"hybrid p{r['pid']}: X1 never launched")
        check(t["launches"]["fused_step"] == 0,
              f"hybrid p{r['pid']}: the one-device native lane ran")
        check(p["x1_kernels"] > 0
              and p["x1_in_intra_slice_exchange"] == p["x1_kernels"]
              == p["x1_launches"],
              f"hybrid p{r['pid']}: X1's kernels under "
              f"intra_slice_exchange {p}")
        lo = r["local"]["launches"]
        check(lo["bucket_records"] == 0 and r["local"]["mesh_devices"] is None
              and lo["apply_pairs_u32"] + lo["apply_pairs_u16"] > 0,
              f"hybrid p{r['pid']} without a mesh plan: not the one-block "
              f"native lane {r['local']}")
    fleet_wall = max(r["timed"]["wall_s"] for r in timed)
    device_ms = [r["profiled"]["x1_device_ms_per_call"] for r in timed]
    x1.update({
        "loop_ms": loop_ms, "shape": {"records": b, "n_dest": n_dest,
                                      "capacity": cap, "spd": spd,
                                      "ring": ring},
        "device_ms": (sum(device_ms) / len(device_ms)
                      if None not in device_ms else None),
        "bound_ms": x1_hybrid_bound(shapes), "bound_by": "bytes"})
    summary = {
        "phase": "hybrid", "conf": "confs/bench_q5_host_fed.conf",
        "job": "key_by(auction).window(10 s / 1 s sliding).count()",
        "events": Q5_BATCH * HYBRID_BATCHES * 2, "processes": 2,
        "blocks": ["cuda:0", "cuda:0"],
        "fleet_events_per_s": Q5_BATCH * HYBRID_BATCHES * 2 / fleet_wall,
        "fleet_wall_s": fleet_wall,
        "single_process": {
            "wall_s": s_wall,
            "events_per_s": Q5_BATCH * HYBRID_BATCHES * 2 / s_wall,
            "launches": {k: v for k, v in s_launches.items() if v}},
        "rows": len(rows), "crash_rows": len(crash_rows),
        "x1": x1,
        "processes_detail": [
            {"pid": r["pid"],
             **{k: v for k, v in r["timed"].items()
                if k not in ("x1_shapes", "launches")},
             "launches": {k: v for k, v in r["timed"]["launches"].items()
                          if v},
             "x1_calls": len(r["timed"]["x1_shapes"]),
             "profiled": r["profiled"]} for r in timed],
        "restore": [r["restore"] for r in restored],
        "local": [{**r["local"],
                   "launches": {k: v for k, v in r["local"]["launches"].items()
                                if v}} for r in timed],
        "card": card_line()}
    emit(summary)
    shutil.rmtree(out, ignore_errors=True)
    launches = {k: sum(r["timed"]["launches"][k] for r in timed)
                for k in timed[0]["timed"]["launches"]}
    return launches, x1


TIER_BUDGET = 1 << 20           # S-LSM's delta budget: a seal about every batch
TIER_COMPACT_MIN_RUNS = 2       # the most runs Q5's purge leaves live at once
TIER_SLOTS_PER_SHARD = 1024     # 128 x 1024 slots hold job S's 100,000 keys
TIER_IDLE_GAP_MS = 2_000        # the process function's idle timeout
TIER_EMIT_DEFER = "20ms"        # the debloater job's delivery deferral


def tier_summary(res, wall, events):
    """events/s, wall and the card's idle share by the operators'
    CUDA-event spans (1.0 for a job with no device operator)."""
    busy, _ = busy_and_host(res)
    return {"events": events, "wall_s": wall, "events_per_s": events / wall,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3)}


def run_tier_job(torch, build, label):
    """One job of the host operators through ``env.execute()`` on the
    card: (JobResult, wall seconds)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.config import Configuration

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    conf.set("state.slots-per-shard", TIER_SLOTS_PER_SHARD)
    env = StreamExecutionEnvironment(conf)
    build(env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def running_agg_golden(np, cfg):
    """Per auction: count, sum and max of price, the sum folded as the
    operator folds it (each batch's f32 sum a key in record order, then
    a float64 total, rounded to f32 at the end)."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    n = cfg.num_active_auctions
    cnt = np.zeros(n, np.int64)
    tot = np.zeros(n, np.float64)
    mx = np.full(n, -np.inf, np.float32)
    for i in range(cfg.n_batches):
        d, _ = bid_batch(cfg, 0, i)
        a = d["auction"]
        price = d["price"].astype(np.float32)
        o = np.argsort(a, kind="stable")
        so = a[o]
        starts = np.flatnonzero(np.concatenate([[True], so[1:] != so[:-1]]))
        keys = so[starts]
        cnt[keys] += np.diff(np.append(starts, len(so)))
        # the (records, 1) lane the operator's lift makes, reduced as
        # the operator reduces it
        tot[keys] += np.add.reduceat(price[o].reshape(-1, 1), starts,
                                     axis=0)[:, 0]
        np.maximum.at(mx, a, price)
    seen = np.flatnonzero(cnt)
    return {int(k): (int(cnt[k]), np.float32(tot[k]), mx[k]) for k in seen}


def idle_golden(np, cfg, gap, ooo_ms):
    """The idle-timeout alerts: a key's activity is each batch whose max
    timestamp raises the key's running max m; its alert (key, m, m +
    gap) fires if the watermark after the batch before the key's next
    such batch has reached m + gap, or at the end of input if there is
    none."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    akeys, abatch, amax = [], [], []
    wm = []
    hi = -(1 << 62)
    for i in range(cfg.n_batches):
        d, ts = bid_batch(cfg, 0, i)
        a = d["auction"]
        o = np.lexsort((ts, a))
        sa, st = a[o], ts[o]
        last = np.flatnonzero(np.append(sa[1:] != sa[:-1], True))
        akeys.append(sa[last])
        amax.append(st[last])
        abatch.append(np.full(len(last), i))
        hi = max(hi, int(ts.max()))
        wm.append(hi - ooo_ms - 1)
    k = np.concatenate(akeys)
    b = np.concatenate(abatch)
    m = np.concatenate(amax).astype(np.int64)
    o = np.lexsort((b, k))
    k, b, m = k[o], b[o], m[o]
    first = np.append(True, k[1:] != k[:-1])
    # the key's running max before this batch: only a raise registers
    run = m.copy()
    starts = np.flatnonzero(first)
    for s, e in zip(starts, np.append(starts[1:], len(k))):
        run[s:e] = np.maximum.accumulate(m[s:e])
    prev = np.where(first, np.iinfo(np.int64).min, np.roll(run, 1))
    act = m > prev
    k, b, m = k[act], b[act], m[act]
    nxt_same = np.append(k[1:] == k[:-1], False)
    nxt_b = np.append(b[1:], 0)
    wm = np.asarray(wm, np.int64)
    fires = ~nxt_same | (wm[np.maximum(nxt_b - 1, 0)] >= m + gap)
    return {(int(x), int(y), int(y) + gap) for x, y in zip(k[fires], m[fires])}


def phase_state_tiers(torch, np):
    """Phase 21 (see the module docstring): S-LSM against job S's spill
    run, S-LSM crashed and resumed, the debloater, running aggregates
    and a KeyedProcessFunction, each against its golden."""
    import shutil

    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.functions import KeyedProcessFunction
    from flink_tpu_torch.api.sinks import FnSink, RetractSink, UpsertSink
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.nexmark.queries import q5_hot_items
    from flink_tpu_torch.ops.aggregates import count, max_of, multi, sum_of
    from flink_tpu_torch.state.api import ValueStateDescriptor
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "flink_tpu_torch", "_build", "state_tiers")
    shutil.rmtree(root, ignore_errors=True)
    cfg = bids_cfg(SPILL_BATCHES, SPILL_AUCTIONS)
    events = Q5_BATCH * SPILL_BATCHES
    out = {"phase": "state_tiers", "conf": "confs/bench_q5_host_fed.conf",
           "auctions": SPILL_AUCTIONS, "batches": SPILL_BATCHES,
           "batch": Q5_BATCH}

    # 1. S-LSM against job S's spill run (the spill run first, so both
    # run warm)
    spill_rows, _, spill_res, spill_wall = run_q5_host_fed(
        torch, np, cfg, "tiers-s-spill", backend="spill")
    lsm_conf = {"state.memory-budget-bytes": TIER_BUDGET,
                "state.lsm.compact-min-runs": TIER_COMPACT_MIN_RUNS,
                "state.lsm.dir": os.path.join(root, "lsm")}
    envs = []
    rows, launches, res, wall = run_q5_host_fed(
        torch, np, cfg, "tiers-s-lsm", backend="lsm", conf_extra=lsm_conf,
        envs=envs)
    (op,) = envs[0]._driver._ops.values()
    store = op._spill
    check(rows == spill_rows,
          f"S-LSM: {len(rows)} rows differ from job S's spill run's "
          f"{len(spill_rows)} (values or commit order)")
    check_q5_rows(np, rows, cfg, "S-LSM")
    check(store.seals >= 4 and store.compactions >= 1,
          f"S-LSM: {store.seals} seals, {store.compactions} compactions")
    missing = [k for k in ("scatter_split_counts", "window_counts",
                           "topn_select_append", "ring_columns")
               if launches[k] == 0]
    check(not missing, f"S-LSM: kernels not launched: {missing}")
    disk = sum(os.path.getsize(os.path.join(store.dir, f))
               for f in os.listdir(store.dir))
    out["s_lsm"] = {
        **tier_summary(res, wall, events), "rows": len(rows),
        "rows_equal_spill_run": True, "seals": store.seals,
        "compactions": store.compactions, "live_runs": store.run_count,
        "run_bytes_on_disk": disk,
        "records_spilled": int(res.metrics["records_spilled"]),
        "launches": launches,
        "spill_run": tier_summary(spill_res, spill_wall, events)}

    # 2. S-LSM crashed and resumed: a storage write fault and a poisoned
    # sink, every retained checkpoint kept to count its hardlinks
    from flink_tpu_torch.config import Configuration

    q5_cols = ("auction", "window_end", "bid_count")
    cconf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    for k, v in dict(lsm_conf, **{
            "state.backend": "lsm",
            "state.lsm.dir": os.path.join(root, "lsm-ckpt"),
            "execution.checkpointing.num-retained": 100}).items():
        cconf.set(k, v)

    def build_lsm(c, sink):
        env = StreamExecutionEnvironment(c)
        q5_hot_items(env, bid_stream(cfg), sink, window_ms=10_000,
                     slide_ms=1_000, out_of_orderness_ms=1_000)
        return env

    c_rows, c_wall, c_launches, c_fig = run_checkpointed(
        torch, np, build_lsm, cconf, "tiers-s-lsm-chaos",
        os.path.join(root, "ckpt"), "chaos", limit=len(rows) // 3)
    got = [tuple(dict(r)[c] for c in q5_cols) for r in c_rows]
    check(got == rows,
          f"S-LSM crash: {len(got)} committed rows, the fault-free run "
          f"{len(rows)}, or another order")
    check(c_fig["recoveries"] >= 1
          and "checkpoint.storage.write" in c_fig["injected"],
          f"S-LSM crash: did not crash as planned: {c_fig}")
    links = [c["aux_files"] for c in c_fig["retained"]]
    check(max(links, default=0) > 0, "S-LSM crash: no checkpoint "
          "hardlinked a run file")
    out["s_lsm_crash"] = {
        "events": events, "wall_s": c_wall, "rows": len(got),
        "rows_equal_fault_free": True, "attempts": c_fig["attempts"],
        "recoveries": c_fig["recoveries"], "injected": c_fig["injected"],
        "checkpoints_completed": c_fig["checkpoints_completed"],
        "run_files_linked_by_checkpoint": {
            str(c["id"]): c["aux_files"] for c in c_fig["retained"]},
        "bytes_per_checkpoint": c_fig["bytes_per_checkpoint"],
        "launches": {k: c_launches[k] for k in
                     ("scatter_split_counts", "window_counts",
                      "topn_select_append", "ring_columns")}}

    # 3. the debloater: the fire-to-sink p99 without a target, then a
    # target at half of it. Job S delivers each fire in the loop pass
    # that fired it, well under the key's 1 ms resolution, so the job
    # runs at pipeline.emit-defer TIER_EMIT_DEFER, both times: a fire
    # then waits for the next pass's drain
    plain_envs, deb_envs = [], []
    defer = {"pipeline.emit-defer": TIER_EMIT_DEFER}
    run_q5_host_fed(torch, np, cfg, "tiers-debloat-off", backend="spill",
                    conf_extra=defer, envs=plain_envs)
    p99 = plain_envs[0]._driver._lat_hist.quantile(0.99)
    print(json.dumps({"phase": "state_tiers.debloat_baseline",
                      "emit_defer": TIER_EMIT_DEFER,
                      "fire_to_sink_p99_ms": p99}), flush=True)
    target = int(p99 / 2)
    check(target >= 1, f"debloat: a p99 of {p99} ms leaves no target "
          "below it at the key's 1 ms resolution")
    d_rows, _, d_res, d_wall = run_q5_host_fed(
        torch, np, cfg, "tiers-debloat", backend="spill",
        conf_extra=dict(defer, **{"pipeline.target-latency": target}),
        envs=deb_envs)
    drv = deb_envs[0]._driver
    check_q5_rows(np, d_rows, cfg, "debloat")
    chunk = drv.registry.snapshot()["driver.debloat_chunk"]
    pushed = int(d_res.metrics["batches"])
    check(0 < chunk < Q5_BATCH,
          f"debloat: the chunk gauge ended at {chunk}, not below the "
          f"source batch {Q5_BATCH}")
    # a push a chunk: more pushes than source batches means a halving
    check(pushed > SPILL_BATCHES, f"debloat: {pushed} pushes, no halving")
    out["debloat"] = {
        **tier_summary(d_res, d_wall, events),
        "emit_defer": TIER_EMIT_DEFER,
        "p99_without_target_ms": p99, "target_ms": target,
        "p99_with_target_ms": drv._lat_hist.quantile(0.99),
        "chunk_end": chunk, "batches_pushed": pushed,
        "rows": len(d_rows)}

    # 4. running aggregates by auction, upsert and retract
    want = running_agg_golden(np, cfg)
    out["running_aggregate"] = {}
    for retract in (False, True):
        view = (RetractSink(key_fields=("key",)) if retract
                else UpsertSink(key_fields=("key",)))

        def build(env, view=view, retract=retract):
            (env.from_source(bid_stream(cfg), WatermarkStrategy
                             .for_bounded_out_of_orderness(1_000))
             .key_by("auction")
             .running_aggregate(multi(count(), sum_of("price"),
                                      max_of("price")), retract=retract)
             .add_sink(view))

        mode = "retract" if retract else "upsert"
        res, wall = run_tier_job(torch, build, f"tiers-running-{mode}")
        got = {int(r["key"]): (int(r["count"]), np.float32(r["sum_price"]),
                               np.float32(r["max_price"]))
               for r in view.view()}
        bad = [k for k in want if got.get(k) != want[k]]
        check(got.keys() == want.keys() and not bad,
              f"running_aggregate {mode}: {len(bad)} keys differ, "
              f"{len(got)} keys against {len(want)}")
        out["running_aggregate"][mode] = {
            **tier_summary(res, wall, events), "keys": len(got),
            "rows_emitted": int(res.metrics["records_out"])}

    # 5. a KeyedProcessFunction: an idle timeout a key
    last_desc = ValueStateDescriptor("last_ts", -1.0)

    class IdleTimeout(KeyedProcessFunction):
        def process_batch(self, ctx):
            last = ctx.value_state(last_desc)
            order = np.argsort(ctx.slots, kind="stable")
            sl, ts = ctx.slots[order], ctx.timestamps[order]
            uniq, starts = np.unique(sl, return_index=True)
            mx = np.maximum.reduceat(ts, starts)
            newer = mx > last[uniq]
            last[uniq[newer]] = mx[newer].astype(np.float64)
            ctx.register_event_time_timers(mx[newer] + TIER_IDLE_GAP_MS,
                                           slots=uniq[newer])

        def on_timer(self, ctx):
            last = ctx.value_state(last_desc)
            live = last[ctx.slots] + TIER_IDLE_GAP_MS == ctx.timestamps
            ctx.emit({"key": ctx.keys[live],
                      "idle_since": last[ctx.slots[live]].astype(np.int64)},
                     ts=ctx.timestamps[live])

    parts = []

    def build_process(env):
        (env.from_source(bid_stream(cfg), WatermarkStrategy
                         .for_bounded_out_of_orderness(1_000))
         .key_by("auction").process(IdleTimeout())
         .add_sink(FnSink(lambda b: parts.append(
             {k: np.asarray(v).copy() for k, v in b.items()}))))

    res, wall = run_tier_job(torch, build_process, "tiers-process")
    # an alert fires at its timer, idle_since + the gap
    got = [(int(k), int(s), int(s) + TIER_IDLE_GAP_MS) for p in parts
           for k, s in zip(p["key"], p["idle_since"])]
    pwant = idle_golden(np, cfg, TIER_IDLE_GAP_MS, 1_000)
    check(len(got) == len(set(got)) and set(got) == pwant,
          f"process: {len(set(got) - pwant)} extra, "
          f"{len(pwant - set(got))} missing alerts of {len(pwant)}")
    out["process"] = {**tier_summary(res, wall, events), "alerts": len(got),
                      "gap_ms": TIER_IDLE_GAP_MS}
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    emit(out)
    return launches


# -- phase 22: host patterns — CEP, async I/O and broadcast state -------------

HP_CEP_BATCHES = 4              # CEP: 2^20 bids a batch, keyed by bidder
HP_CEP_BATCHES_CUT = 2          # the same in the default run (its budget)
HP_ASYNC_BATCHES = 8            # async I/O and broadcast, 2^20 bids a batch
HP_WITHIN_MS = 10_000
HP_CATEGORIES = 64              # the lookup table's categories
HP_SLEEP_S = 0.002              # the stand-in RPC, a batch
HP_CAPACITY = 8


def hp_prices(np, cfg):
    """The CEP patterns' thresholds: the 20th, 99th and 99.9th
    percentiles of the job's bid prices."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    price = np.concatenate([bid_batch(cfg, 0, i)[0]["price"]
                            for i in range(cfg.n_batches)])
    return tuple(float(p) for p in np.percentile(price, [20, 99, 99.9]))


def hp_bids(np, cfg):
    """(bidder, ts, price) of every bid of ``cfg``, in stream order."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    parts = [bid_batch(cfg, 0, i) for i in range(cfg.n_batches)]
    return (np.concatenate([d["bidder"] for d, _ in parts]),
            np.concatenate([t for _, t in parts]),
            np.concatenate([d["price"] for d, _ in parts]))


def hp_automaton(np, cfg, prices, mode):
    """A plain per-key automaton of the three CEP runs, sharing no code
    with the port: each bidder's bids in time order; only bids that are
    low (< the 20th percentile) or high (> the 99th) move it, the rest
    can only age a partial out of its window, which the next low or high
    bid decides alike. ``mode``: 'first' (one partial a key, skip past
    the match), 'all' (every low bid opens a partial; a high bid
    completes every live one) or 'absence' (low, then high, then no top
    bid (> the 99.9th) within the window of the low: completed by a later
    bid of the key past the deadline, as the job runs without a
    watermark flush of its CEP node). The rows as (key, low_ts,
    high_ts[, end]) and, for 'all', the most partials a key held at
    once."""
    lo_p, hi_p, top_p = prices
    keys, ts, price = hp_bids(np, cfg)
    order = np.lexsort((ts, keys))
    keys, ts, price = keys[order], ts[order], price[order]
    last_ts = {}
    ends = np.flatnonzero(np.r_[keys[1:] != keys[:-1], True])
    for e in ends.tolist():
        last_ts[int(keys[e])] = int(ts[e])
    rel = (price < lo_p) | (price > hi_p)
    out, widest = [], 0
    w = HP_WITHIN_MS
    cur_key, start, high, parts = None, None, None, []
    for k, t, is_hi, is_top in zip(
            keys[rel].tolist(), ts[rel].tolist(),
            (price[rel] > hi_p).tolist(), (price[rel] > top_p).tolist()):
        if k != cur_key:
            if mode == "absence" and high is not None \
                    and last_ts[cur_key] - start > w:
                out.append((cur_key, start, high, start + w))
            cur_key, start, high, parts = k, None, None, []
        if mode == "all":
            parts = [s for s in parts if t - s <= w]
            if is_hi:
                out += [(k, s, t) for s in parts]
                parts = []
            else:
                parts.append(t)
                widest = max(widest, len(parts))
            continue
        if mode == "absence" and high is not None and t - start > w:
            out.append((k, start, high, start + w))
            start = high = None
        if start is not None and t - start > w:
            start = high = None
        if start is None:
            if not is_hi:
                start = t
        elif mode == "first":
            if is_hi:
                out.append((k, start, t))
                start = None
        elif high is None:
            if is_hi:
                high = t
        elif is_top:
            start = high = None     # a top bid kills it
    if mode == "absence" and high is not None \
            and last_ts[cur_key] - start > w:
        out.append((cur_key, start, high, start + w))
    return sorted(out), widest


def hp_job(torch, np, build, label, events):
    """One job of phase 22 through ``env.execute()`` on the card at
    confs/bench_q5_host_fed.conf: ``build(env, sink)`` wires it. (rows as
    columns, its figures)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk

    env = StreamExecutionEnvironment(Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf")))
    parts = []
    build(env, FnSink(lambda b: parts.append(
        {k: np.asarray(v) for k, v in b.items()})))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, host = busy_and_host(res)
    cols = ({k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            if parts else {})
    return cols, {"events": events, "wall_s": wall,
                  "events_per_s": events / wall,
                  "device_busy_ms": busy,
                  "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
                  "kernels": {k: v for k, v in wk.LAUNCHES.items() if v},
                  "late_records": res.metrics["late_records"],
                  "host_profile_s": host}


def hp_window_golden(np, cfg, table, keep=None):
    """(category, window_end, count) of the 1 s tumbling count over the
    bids' categories (``keep``: a mask of the bids that pass)."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    cats, ends = [], []
    for i in range(cfg.n_batches):
        d, t = bid_batch(cfg, 0, i)
        m = np.ones(len(t), bool) if keep is None else keep(d)
        cats.append(table[d["auction"][m]])
        ends.append(t[m] // 1000 * 1000 + 1000)
    pairs, counts = np.unique(np.stack([np.concatenate(cats),
                                        np.concatenate(ends)], 1),
                              axis=0, return_counts=True)
    return set(zip(pairs[:, 0].tolist(), pairs[:, 1].tolist(),
                   counts.tolist()))


def hp_window_rows(cols):
    rows = list(zip(cols["key"].tolist(), cols["window_end"].tolist(),
                    cols["count"].tolist()))
    check(len(rows) == len(set(rows)), "host patterns: a window twice")
    return set(rows)


def phase_host_patterns(torch, np, cep_batches=HP_CEP_BATCHES):
    """Phase 22: CEP, async I/O and broadcast state on bench.py:206-208's
    bids (100 a ms, 10,000 auctions, hot ratio 4) at
    confs/bench_q5_host_fed.conf, each against a numpy golden. The
    default run passes ``HP_CEP_BATCHES_CUT`` and lists the cut."""
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.cep import CEP, Pattern
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.ops.broadcast import BroadcastProcessFunction
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    wm = WatermarkStrategy.for_bounded_out_of_orderness(1_000)
    out = {"phase": "host_patterns", "conf": "confs/bench_q5_host_fed.conf",
           "batch": Q5_BATCH, "cep_batches": cep_batches,
           "async_batches": HP_ASYNC_BATCHES}
    if cep_batches != HP_CEP_BATCHES:
        out["cut"] = {"cep_batches": [HP_CEP_BATCHES, cep_batches]}

    # CEP: low then high bid of a bidder within 10 s
    cfg = bids_cfg(cep_batches)
    prices = lo_p, hi_p, top_p = hp_prices(np, cfg)
    want_all, widest = hp_automaton(np, cfg, prices, "all")
    runs = {
        "first": (Pattern.begin("low").where(lambda d: d["price"] < lo_p)
                  .followed_by("high").where(lambda d: d["price"] > hi_p)
                  .within(HP_WITHIN_MS), 8),
        "all": (Pattern.begin("low").where(lambda d: d["price"] < lo_p)
                .followed_by("high").where(lambda d: d["price"] > hi_p)
                .within(HP_WITHIN_MS).after_match("NO_SKIP"), widest),
        "absence": (Pattern.begin("low").where(lambda d: d["price"] < lo_p)
                    .followed_by("high").where(lambda d: d["price"] > hi_p)
                    .not_followed_by("top")
                    .where(lambda d: d["price"] > top_p)
                    .within(HP_WITHIN_MS), 8)}
    cep = {}
    for mode, (pattern, width) in runs.items():
        def build(env, sink, pattern=pattern, width=width):
            CEP.pattern(env.from_source(bid_stream(cfg), wm).key_by("bidder"),
                        pattern, max_partials=width).add_sink(sink)
        cols, fig = hp_job(torch, np, build, f"cep-{mode}",
                           Q5_BATCH * cep_batches)
        want = want_all if mode == "all" else hp_automaton(
            np, cfg, prices, mode)[0]
        fields = ["key", "low_ts", "high_ts"] + (
            ["match_end"] if mode == "absence" else [])
        got = sorted(zip(*(cols[f].tolist() for f in fields))) if cols else []
        check(got == want, f"cep {mode}: {len(got)} matches, the automaton "
                           f"{len(want)}; they differ")
        check(want, f"cep {mode}: no match (vacuous)")
        if mode == "absence" and cols:
            check((cols["top_ts"] == -1).all(),
                  "cep absence: the negated stage's column is not -1")
        cep[mode] = {**fig, "matches": len(got), "max_partials": width}
    out["cep"] = {"keyed_by": "bidder", "low_price": lo_p,
                  "high_price": hi_p, "top_price": top_p,
                  "within_ms": HP_WITHIN_MS, **cep}

    # async I/O: auction -> category from a table, a 2 ms RPC a batch,
    # into a keyed 1 s count on the card
    cfg = bids_cfg(HP_ASYNC_BATCHES)
    table = np.random.default_rng(SEED + 24).integers(
        0, HP_CATEGORIES, cfg.num_active_auctions)
    golden = hp_window_golden(np, cfg, table)
    for ordered in (True, False):
        # a batch by its first bids' auctions (a 2^20-bid batch's first
        # 16 never repeat in 8 batches): submit and release times
        submitted, released = {}, {}

        def submit(data):
            submitted[data["auction"][:16].tobytes()] = time.perf_counter()
            return data

        def lookup(data, ts):
            time.sleep(HP_SLEEP_S)
            return {**data, "category": table[data["auction"]]}

        def release(data):
            released[data["auction"][:16].tobytes()] = time.perf_counter()
            return data

        def build(env, sink, ordered=ordered):
            (env.from_source(bid_stream(cfg), wm).map(submit)
             .async_io(lookup, capacity=HP_CAPACITY, ordered=ordered)
             .map(release).key_by("category")
             .window(TumblingEventTimeWindows.of(1000)).count()
             .add_sink(sink))
        cols, fig = hp_job(torch, np, build, "async",
                           Q5_BATCH * HP_ASYNC_BATCHES)
        check(hp_window_rows(cols) == golden,
              f"async (ordered={ordered}): rows differ from the golden")
        check(fig["late_records"] == 0, f"async: late records {fig}")
        check(sum(fig["kernels"].values()) > 0,
              "async: the card window launched no kernel")
        check(len(released) == HP_ASYNC_BATCHES, "async: a batch lost")
        in_flight = sum(released[b] - submitted[b] for b in released)
        out["async_ordered" if ordered else "async_unordered"] = {
            **fig, "capacity": HP_CAPACITY, "sleep_ms": HP_SLEEP_S * 1e3,
            "mean_batches_in_flight": in_flight / fig["wall_s"],
            "rows": len(golden)}

    # broadcast: per-category thresholds in the control stream's first
    # (only) batch; the bids over their category's threshold go on to the
    # same card window
    thr = np.random.default_rng(SEED + 25).uniform(
        *np.percentile(hp_bids(np, cfg)[2], [50, 95]), HP_CATEGORIES)

    class OverThreshold(BroadcastProcessFunction):
        def process_element(self, data, ts, state):
            cat = table[data["auction"]]
            keep = data["price"] > state["thr"][cat]
            return {"category": cat[keep], "__ts__": ts[keep]}

        def process_broadcast_element(self, data, ts, state):
            state.setdefault("thr", np.zeros(HP_CATEGORIES))[
                data["cat"]] = data["thr"]

    def control(split, i):
        # timestamped past the bids: the finished control stream holds
        # no watermark back
        if i >= 1:
            return None
        return ({"cat": np.arange(HP_CATEGORIES, dtype=np.int64),
                 "thr": thr}, np.full(HP_CATEGORIES, 1 << 40, np.int64))

    def build(env, sink):
        from flink_tpu_torch.api.sources import GeneratorSource

        ctl = env.from_source(GeneratorSource(control), wm)
        (env.from_source(bid_stream(cfg), wm).connect(ctl)
         .process(OverThreshold()).key_by("category")
         .window(TumblingEventTimeWindows.of(1000)).count().add_sink(sink))
    cols, fig = hp_job(torch, np, build, "broadcast",
                       Q5_BATCH * HP_ASYNC_BATCHES)
    want = hp_window_golden(
        np, cfg, table,
        keep=lambda d: d["price"] > thr[table[d["auction"]]])
    check(hp_window_rows(cols) == want,
          "broadcast: rows differ from the golden")
    check(fig["late_records"] == 0 and sum(fig["kernels"].values()) > 0,
          f"broadcast: late records or no kernel {fig}")
    out["broadcast"] = {**fig, "rows": len(want)}
    out["card"] = card_line()
    emit(out)
    return out


# -- phase 23: rescale Q5's count stage from a checkpoint set ----------------

RESCALE_BATCHES = 16            # 2^20-bid batches a split, two splits
RESCALE_CUT = 8                 # the old fleet stops after this batch
RESCALE_BATCHES_CUT = 8         # both halved in the default run (its
RESCALE_CUT_CUT = 4             # budget)
RESCALE_TIMEOUT_S = 300


def rescale_plan(nproc, pid):
    """Two processes: each its ``make_hybrid_mesh_plan(128, 256, 2, pid,
    ["cuda:0", "cuda:0"])``; one process: mesh M1's four blocks of
    cuda:0."""
    from flink_tpu_torch.parallel.mesh import (make_hybrid_mesh_plan,
                                               make_mesh_plan)

    if nproc > 1:
        return make_hybrid_mesh_plan(128, 256, 2, pid, ["cuda:0", "cuda:0"])
    return make_mesh_plan(128, 256, ["cuda:0"] * MESH_BLOCKS)


def rescale_worker(torch, np, spec):
    """``--rescale-worker SPEC``: one process of phase 23. SPEC (JSON):
    the cut's directory, the run ('old' or 'new'), the process id and
    count, the peers, this process's port and the secret; a new run's
    restore path and checkpoint set. The old run checkpoints every step
    and stops after batch ``spec["cut"]``: across two processes (lockstep
    steps, so the last checkpoint covers the batch) process 1 exits at
    the next batch once process 0 holds that checkpoint too; alone, a
    synchronous checkpoint at the cut, then the exit. Writes its figures to ``<root>/result-<run>-p<pid>.json``."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FileTransactionalSink
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.api.windowing import SlidingEventTimeWindows
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.nexmark.generator import bid_stream
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    pid, nproc, run, root = (spec["pid"], spec["nproc"], spec["run"],
                             spec["root"])
    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    if nproc > 1:
        for k, v in (("cluster.num-processes", nproc),
                     ("cluster.process-id", pid),
                     ("cluster.dcn-peers", spec["peers"]),
                     ("cluster.dcn-port", spec["port"]),
                     ("cluster.dcn-secret", spec["secret"])):
            conf.set(k, v)
    conf.set("execution.checkpointing.dir", os.path.join(root, f"{run}-ckpt"))
    if run == "old":
        # the cut at a known batch: the source read when the loop needs
        # it, and steps in lockstep across processes
        conf.set("pipeline.source-prefetch", 0)
        conf.set("execution.checkpointing.interval", 1)
        conf.set("cluster.dcn-overlap", False)
    else:
        conf.set("execution.checkpointing.restore", spec["restore"])
        conf.set("cluster.rescale-from", ",".join(spec["rescale_from"]))
    inner = bid_stream(hybrid_cfg(spec["batches"])).gen
    env = StreamExecutionEnvironment(conf)
    read = [0]

    def latest(p):
        return FsCheckpointStorage(os.path.join(root, "old-ckpt"),
                                   f"rescale-p{p}").latest()

    def gen(split, i):
        if run == "old" and i >= spec["cut"]:
            if nproc == 1:
                env._driver.checkpoint_now()
                os._exit(43)
            if pid == 1:
                # process 0 finishes the step's checkpoint before this one
                # leaves (it then fails on the exchange)
                mine = latest(1).checkpoint_id
                deadline = time.time() + RESCALE_TIMEOUT_S / 2
                while ((latest(0) is None
                        or latest(0).checkpoint_id < mine)
                       and time.time() < deadline):
                    time.sleep(0.01)
                os._exit(43)
        out = inner(split, i)
        if out is not None:
            read[0] += len(out[1])
        return out

    sink = FileTransactionalSink(os.path.join(root, f"sink-{run}-p{pid}"))
    (env.from_source(GeneratorSource(gen, n_splits=2),
                     WatermarkStrategy.for_bounded_out_of_orderness(1_000))
     .key_by("auction").window(SlidingEventTimeWindows.of(10_000, 1_000))
     .count().add_sink(sink))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute("rescale", device="cuda",
                      mesh_plan=rescale_plan(nproc, pid))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, host = busy_and_host(res)
    m = res.metrics
    result = {"pid": pid, "nproc": nproc, "run": run, "events": read[0],
              "wall_s": wall, "events_per_s": read[0] / wall,
              "launches": {k: v for k, v in wk.LAUNCHES.items() if v},
              "device_busy_ms": busy,
              "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
              "restore_s": {k: m.get(f"profile.driver.restore_{k}", 0.0)
                            for k in ("load", "merge", "ops")},
              "late_records": m["late_records"],
              "exchange_overflow": m["exchange_overflow"],
              "mesh_devices": m.get("mesh_devices"),
              "card": card_line()}
    with open(os.path.join(root, f"result-{run}-p{pid}.json"), "w") as f:
        json.dump(result, f)


def spawn_rescale(spec):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rescale-worker",
         json.dumps(spec)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def wait_workers(procs, label, expect):
    """Wait for every worker (a hang fails the phase; each process is
    stopped before this returns) and check its exit code (None: any but
    0)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RESCALE_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, want) in enumerate(zip(procs, expect)):
        ok = p.returncode != 0 if want is None else p.returncode == want
        check(ok, f"{label}: process {pid} exited {p.returncode}:\n"
                  + outs[pid][-4000:])


def rescale_cut(torch, np, out, n_old, n_new, secret, batches, cut_after):
    """One cut of phase 23: the old fleet of ``n_old`` processes stops
    after batch ``cut_after`` of ``batches``; each old sink commits the
    epochs its
    process's last checkpoint staged (the restore's own step: the merged
    payload carries none); ``n_new`` processes restore their spans of the
    set through ``cluster.rescale-from`` and finish the job."""
    import shutil

    from flink_tpu_torch.api.sinks import FileTransactionalSink
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage

    root = os.path.join(out, f"{n_old}to{n_new}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def specs(run, nproc, **kw):
        ports = free_ports(nproc)
        peers = ",".join(f"127.0.0.1:{p}" for p in ports)
        return [dict(pid=pid, nproc=nproc, run=run, root=root, peers=peers,
                     port=ports[pid], secret=secret, batches=batches,
                     cut=cut_after, **kw)
                for pid in range(nproc)]

    t0 = time.perf_counter()
    wait_workers([spawn_rescale(s) for s in specs("old", n_old)],
                 f"rescale {n_old}->{n_new} old fleet",
                 (None, 43) if n_old == 2 else (43,))
    old_wall = time.perf_counter() - t0
    stores = [FsCheckpointStorage(
        os.path.join(root, "old-ckpt"),
        "rescale" + (f"-p{pid}" if n_old > 1 else "")) for pid in range(n_old)]
    for pid, st in enumerate(stores):
        check(st.latest() is not None,
              f"rescale {n_old}->{n_new}: process {pid} holds no checkpoint")
    cut = min(st.latest().checkpoint_id for st in stores)
    paths, positions = [], []
    for pid, st in enumerate(stores):
        (h,) = [h for h in st.list_complete() if h.checkpoint_id == cut]
        payload = FsCheckpointStorage.load(h)
        (staged,) = payload["sinks"].values()
        FileTransactionalSink(os.path.join(
            root, f"sink-old-p{pid}")).restore_staged(staged, cut)
        paths.append(h.path)
        positions.append({str(k): v for pos in payload["sources"].values()
                          for k, v in pos.items()})
    t0 = time.perf_counter()
    wait_workers([spawn_rescale(s) for s in specs(
        "new", n_new, restore=paths[0], rescale_from=paths)],
        f"rescale {n_old}->{n_new} new fleet", (0,) * n_new)
    new_wall = time.perf_counter() - t0
    results = []
    for pid in range(n_new):
        with open(os.path.join(root, f"result-new-p{pid}.json")) as f:
            results.append(json.load(f))
    rows = [(r["key"], r["window_end"], r["count"])
            for run, n in (("old", n_old), ("new", n_new))
            for pid in range(n)
            for r in FileTransactionalSink.committed_rows(
                os.path.join(root, f"sink-{run}-p{pid}"))]
    before = sum(1 for pid in range(n_old)
                 for _ in FileTransactionalSink.committed_rows(
                     os.path.join(root, f"sink-old-p{pid}")))
    check(before and len(rows) > before,
          f"rescale {n_old}->{n_new}: a half committed nothing")
    for r in results:
        lo = r["launches"]
        check(lo.get("bucket_records", 0) > 0,
              f"rescale {n_old}->{n_new}: the resumed half launched no "
              f"bucket_records: {lo}")
        check(sum(v for k, v in lo.items() if k != "bucket_records") > 0,
              f"rescale {n_old}->{n_new}: no window kernel launched: {lo}")
        check(r["late_records"] == 0 and r["exchange_overflow"] == 0,
              f"rescale {n_old}->{n_new}: late or overflowed records {r}")
    fleet_wall = max(r["wall_s"] for r in results)
    return rows, {
        "old_processes": n_old, "new_processes": n_new,
        "old_blocks": 2 if n_old == 2 else MESH_BLOCKS,
        "new_blocks": 2 if n_new == 2 else MESH_BLOCKS,
        "cut_checkpoint": cut, "cut_positions": positions,
        "old_fleet_wall_s": old_wall, "new_fleet_wall_s": new_wall,
        "rows_before": before, "rows_after": len(rows) - before,
        "resumed_events": sum(r["events"] for r in results),
        "resumed_events_per_s": sum(r["events"] for r in results) / fleet_wall,
        "processes": results}


def phase_rescale(torch, np, batches=RESCALE_BATCHES, cut_after=RESCALE_CUT):
    """Phase 23: Q5's count stage (the hybrid phase's job) rescaled 2 -> 1
    and 1 -> 2 from a checkpoint set; the union of both halves' committed
    rows against the golden, each (auction, window) once. The default
    run passes the ``*_CUT`` counts and lists the cut."""
    import secrets

    out = os.path.join(ROOT, "flink_tpu_torch", "_build", "rescale")
    secret = secrets.token_hex(16)
    cuts = {}
    rows = {}
    for n_old, n_new in ((2, 1), (1, 2)):
        rows[(n_old, n_new)], cuts[f"{n_old}to{n_new}"] = rescale_cut(
            torch, np, out, n_old, n_new, secret, batches, cut_after)
    # the golden's numpy work after the timed runs
    cfg = hybrid_cfg(batches)
    for (n_old, n_new), r in rows.items():
        check_q5_counts(np, r, cfg, f"rescale {n_old}->{n_new} union")
    summary = {"phase": "rescale", "conf": "confs/bench_q5_host_fed.conf",
               "job": "key_by(auction).window(10 s / 1 s sliding).count()",
               "batches": batches, "splits": 2, "batch": Q5_BATCH,
               "cut_after_batch": cut_after, **cuts, "card": card_line()}
    if batches != RESCALE_BATCHES:
        summary["cut"] = {"batches": [RESCALE_BATCHES, batches],
                          "cut_after_batch": [RESCALE_CUT, cut_after]}
    emit(summary)
    return summary


SQL_Q5 = ("SELECT auction, window_end, COUNT(*) AS bid_count "
          "FROM TABLE(HOP(TABLE bids, DESCRIPTOR(ts), "
          "INTERVAL '1' SECOND, INTERVAL '10' SECOND)) "
          "GROUP BY auction, window_start, window_end "
          "ORDER BY bid_count DESC LIMIT 1")
SQL_TUMBLE = ("SELECT auction, window_end, COUNT(*) AS c, SUM(price) AS s, "
              "MAX(price) AS mx, MIN(price) AS mn "
              "FROM TABLE(TUMBLE(TABLE bids, DESCRIPTOR(ts), "
              "INTERVAL '1' SECOND)) WHERE price > {median} "
              "GROUP BY auction, window_start, window_end")
SQL_BATCHES = 16                # SQL Q5 host-fed, 2^20 bids each
SQL_DEVGEN_BATCHES = 4          # SQL Q5 on the card's generator, 2^22 each
SQL_TUMBLE_BATCHES = 8          # the TUMBLE query with WHERE
SQL_CRASH_BATCHES = 8           # the crash-image job and the objstore job
SQL_CRASH_SEEDS = (0, 1)        # one journaled run a seed
SQL_IMAGES_PER_SEED = 3         # 6 crash images in all


def sql_env(conf, source, sink, query=SQL_Q5):
    """``query`` over a ``bids`` view of ``source`` (1 s out of
    orderness) into ``sink``: (environment, parse-plus-plan ms)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.table import TableEnvironment
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    env = StreamExecutionEnvironment(conf)
    t_env = TableEnvironment.create(env)
    bids = env.from_source(
        source, WatermarkStrategy.for_bounded_out_of_orderness(1_000))
    t_env.create_temporary_view("bids", bids,
                                schema=["auction", "bidder", "price"],
                                time_attr="ts")
    t0 = time.perf_counter()
    table = t_env.sql_query(query)
    plan_ms = (time.perf_counter() - t0) * 1e3
    table.add_sink(sink)
    return env, plan_ms


def run_sql(torch, np, conf, source, label, query=SQL_Q5):
    """``query`` through ``env.execute()`` on the card: (rows as columns
    in commit order, launches, JobResult, wall seconds, plan ms)."""
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.kernels import window_kernels as wk

    parts = []
    env, plan_ms = sql_env(conf, source, FnSink(lambda b: parts.append(
        {k: np.asarray(v).copy() for k, v in b.items()})), query)
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    return cols, dict(wk.LAUNCHES), res, wall, plan_ms


def q5_rows(cols):
    return [(int(a), int(w), int(c)) for a, w, c in zip(
        cols["auction"], cols["window_end"], cols["bid_count"])]


def host_fed_conf(extra=None):
    from flink_tpu_torch.config import Configuration

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_host_fed.conf"))
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def tumble_golden(np, cfg, median):
    """Per (auction, 1 s window end) of the bids above ``median``: count,
    f64 sum, max and min, for every cell with a bid."""
    from flink_tpu_torch.nexmark.generator import bid_batch

    n_a = cfg.num_active_auctions
    n_p = (cfg.batch_size * cfg.n_batches - 1) // cfg.events_per_ms // 1000 + 1
    cnt = np.zeros(n_a * n_p, np.int64)
    tot = np.zeros(n_a * n_p, np.float64)
    mx = np.full(n_a * n_p, -np.inf, np.float32)
    mn = np.full(n_a * n_p, np.inf, np.float32)
    for i in range(cfg.n_batches):
        data, ts = bid_batch(cfg, 0, i)
        keep = data["price"] > median
        price = data["price"][keep]
        cell = data["auction"][keep] * n_p + ts[keep] // 1000
        cnt += np.bincount(cell, minlength=n_a * n_p)
        tot += np.bincount(cell, weights=price.astype(np.float64),
                           minlength=n_a * n_p)
        np.maximum.at(mx, cell, price)
        np.minimum.at(mn, cell, price)
    return n_p, cnt, tot, mx, mn


def check_tumble(np, cols, golden, label):
    n_p, cnt, tot, mx, mn = golden
    cell = cols["auction"].astype(np.int64) * n_p + (
        cols["window_end"].astype(np.int64) // 1000 - 1)
    check(len(np.unique(cell)) == len(cell),
          f"{label}: duplicate (auction, window) rows")
    check(len(cell) == int((cnt > 0).sum()),
          f"{label}: {len(cell)} rows, expected {int((cnt > 0).sum())}")
    check(np.array_equal(cols["c"], cnt[cell]),
          f"{label}: counts differ from the golden")
    check(np.array_equal(cols["mx"], mx[cell])
          and np.array_equal(cols["mn"], mn[cell]),
          f"{label}: max/min differ from the golden")
    rel = np.abs(cols["s"].astype(np.float64) - tot[cell]) / np.abs(tot[cell])
    bound = agg_rel_bound(cnt[cell])
    check(bool((rel <= bound).all()),
          f"{label}: sums outside the bound (max rel err {float(rel.max())})")
    return float(rel.max()), float((rel / bound).max())


def sql_crash_images(torch, np, cfg, root, golden):
    """SQL Q5 host-fed checkpointing at every batch boundary into
    ``crash://`` (a journaled run a seed, into a transactional sink whose
    commits log the journal's length), then crash images restored on
    the card with ``restore: latest`` into the sink as the cut left it:
    each must commit the golden's rows once each, or fail loudly."""
    import random
    import shutil

    from flink_tpu_torch import fs_crash
    from flink_tpu_torch.api.sinks import TransactionalCollectSink
    from flink_tpu_torch.checkpoint.storage import FsCheckpointStorage
    from flink_tpu_torch.nexmark.generator import bid_stream

    label = "sql-q5-crash"
    recovered, loud, images = 0, 0, []
    mutate_s = []
    for seed in SQL_CRASH_SEEDS:
        run_root = os.path.join(root, f"run-{seed}")
        os.makedirs(run_root)
        cfs = fs_crash.install(run_root)
        log = []

        class LoggedSink(TransactionalCollectSink):
            def notify_checkpoint_complete(self, checkpoint_id):
                super().notify_checkpoint_complete(checkpoint_id)
                log.append((len(cfs.journal), len(self.committed),
                            self._last_committed))

        def conf_for(chk, restore):
            extra = {"execution.checkpointing.interval": 1,
                     "execution.checkpointing.dir": chk}
            if restore:
                extra["execution.checkpointing.restore"] = "latest"
            return host_fed_conf(extra)

        try:
            sink = LoggedSink()
            env, _ = sql_env(conf_for("crash://" + run_root + "/chk", False),
                             bid_stream(cfg), sink)
            t0 = time.perf_counter()
            env.execute(label, device="cuda")
            mutate_s.append(time.perf_counter() - t0)
            committed = [(int(r["auction"]), int(r["window_end"]),
                          int(r["bid_count"])) for r in sink.committed]
            check(cfs.journal, "sql crash: the journaled run recorded no "
                  "mutations (the checkpoints bypass the seam)")
            check(len(log) > 2, f"sql crash: {len(log)} checkpoints committed")
            check(set(committed) == golden
                  and len(committed) == len(golden),
                  "sql crash: the journaled run's rows differ from the golden")
            img = os.path.join(root, "img")
            for k in range(SQL_IMAGES_PER_SEED):
                dec = cfs.crash(img, rng=random.Random((seed << 20) ^ k),
                                seed=seed)
                done = [r for r in log if r[0] <= dec["cut"]]
                latest = FsCheckpointStorage(
                    os.path.join(img, "chk"), label).latest()
                image = {"seed": seed, "image": k, "cut": dec["cut"],
                         "journal": len(cfs.journal),
                         "decisions": len(dec["decisions"]),
                         "restored": latest.checkpoint_id if latest else None,
                         "committed_before": done[-1][1] if done else 0}
                sink2 = TransactionalCollectSink()
                if done:
                    sink2.committed.extend(sink.committed[:done[-1][1]])
                    sink2._last_committed = done[-1][2]
                env2, _ = sql_env(conf_for(os.path.join(img, "chk"), True),
                                  bid_stream(cfg), sink2)
                try:
                    t0 = time.perf_counter()
                    env2.execute(label, device="cuda")
                    image["resume_s"] = time.perf_counter() - t0
                except (ValueError, OSError) as e:
                    loud += 1
                    image["loud"] = f"{type(e).__name__}: {e}"[:200]
                    images.append(image)
                    continue
                rows = [(int(r["auction"]), int(r["window_end"]),
                         int(r["bid_count"])) for r in sink2.committed]
                check(len(rows) == len(set(rows)) and set(rows) == golden,
                      f"SILENT DIVERGENCE after recovery: {image} "
                      f"decisions={dec['decisions']}: {len(rows)} rows, "
                      f"{len(set(rows) ^ golden)} off the golden")
                recovered += 1
                images.append(image)
        finally:
            cfs.close()
            shutil.rmtree(os.path.join(root, "img"), ignore_errors=True)
    total = recovered + loud
    check(recovered >= max(1, total // 2),
          f"sql crash: only {recovered}/{total} images recovered cleanly")
    return {"batches": cfg.n_batches, "seeds": list(SQL_CRASH_SEEDS),
            "recovered": recovered, "loud": loud, "images": images,
            "journaled_run_s": mutate_s}


def phase_sql(torch, np):
    """Table/SQL on the card (see the module docstring, phase 24); the
    launches of each SQL job, by path, for the kernels line."""
    import shutil

    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.nexmark.generator import (
        NexmarkConfig, bid_batch, bid_stream, bid_stream_device)

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "flink_tpu_torch", "_build", "sql")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {"phase": "sql", "query": SQL_Q5}
    paths = {}

    # 1. SQL Q5 host-fed beside the DataStream job on the same batches
    cfg = bids_cfg(SQL_BATCHES)
    ds_rows, ds_launches, ds_res, ds_wall = run_q5_host_fed(
        torch, np, cfg, "sql-ds-q5-host-fed")
    cols, launches, res, wall, plan_ms = run_sql(
        torch, np, host_fed_conf(), bid_stream(cfg), "sql-q5-host-fed")
    rows = q5_rows(cols)
    check(launches == ds_launches,
          f"sql q5 host-fed: launches {launches} differ from the DataStream "
          f"job's {ds_launches}")
    check(rows == ds_rows,
          "sql q5 host-fed: rows differ from the DataStream job's")
    paths["sql_q5_host_fed"] = launches
    out["q5_host_fed"] = {
        "conf": "confs/bench_q5_host_fed.conf", "plan_ms": plan_ms,
        **q5_run_summary(rows, launches, res, wall, SQL_BATCHES),
        "datastream_events_per_s": Q5_BATCH * SQL_BATCHES / ds_wall,
        "launches_equal_datastream": True}

    # 2. SQL Q5 over the card's generator beside the DataStream devgen job
    dconf_path = os.path.join(ROOT, "confs", "bench_q5_headline.conf")
    dcfg = NexmarkConfig(batch_size=DEVGEN_BATCH, n_batches=SQL_DEVGEN_BATCHES,
                         events_per_ms=100, num_active_auctions=10_000,
                         hot_ratio=4)
    d_rows, d_launches, _, _ = run_devgen_q5(
        torch, np, Configuration.from_file(dconf_path), dcfg, "sql-ds-devgen")
    dcols, dl, dres, dwall, dplan = run_sql(
        torch, np, Configuration.from_file(dconf_path),
        bid_stream_device(dcfg), "sql-q5-devgen")
    drows = q5_rows(dcols)
    steps = SQL_DEVGEN_BATCHES * DEVGEN_SUB
    check(dl["devgen_ingest"] == steps and dl["nexmark_bids"] == 0
          and dres.metrics["devgen_host_batches"] == 0,
          f"sql q5 devgen: {dl['devgen_ingest']} devgen_ingest for {steps} "
          f"sub-batches, {dl['nexmark_bids']} nexmark_bids, "
          f"{dres.metrics['devgen_host_batches']} host batches")
    check(dl == d_launches, f"sql q5 devgen: launches {dl} differ from the "
          f"DataStream job's {d_launches}")
    check(drows == d_rows, "sql q5 devgen: rows differ from the DataStream "
          "devgen job's")
    paths["sql_q5_devgen"] = dl
    d_events = DEVGEN_BATCH * SQL_DEVGEN_BATCHES
    busy, _ = busy_and_host(dres)
    out["q5_devgen"] = {
        "conf": "confs/bench_q5_headline.conf", "plan_ms": dplan,
        "events": d_events, "logical_batches": SQL_DEVGEN_BATCHES,
        "sub_batches": DEVGEN_SUB, "wall_s": dwall,
        "events_per_s": d_events / dwall, "rows": len(drows),
        "launches": dl, "device_busy_ms": busy,
        "device_idle_share": 1.0 - sum(busy.values()) / (dwall * 1e3),
        "launches_equal_datastream": True}

    # 3. TUMBLE with WHERE over the bids above their median price
    tcfg = bids_cfg(SQL_TUMBLE_BATCHES)
    median = float(np.median(np.concatenate(
        [bid_batch(tcfg, 0, i)[0]["price"]
         for i in range(SQL_TUMBLE_BATCHES)])))
    query = SQL_TUMBLE.format(median=repr(median))
    tcols, tl, tres, twall, tplan = run_sql(
        torch, np, host_fed_conf(), bid_stream(tcfg), "sql-tumble-where",
        query)
    paths["sql_tumble"] = tl

    # 4. crash images and 5. the object store (the goldens' numpy work
    # comes after the timed runs above)
    ccfg = bids_cfg(SQL_CRASH_BATCHES)
    cgolden = q5_golden(np, ((d["auction"], t) for d, t in (
        bid_batch(ccfg, 0, i) for i in range(ccfg.n_batches))),
        ccfg.num_active_auctions, window_panes=10, pane_ms=1000)
    out["crash_images"] = sql_crash_images(
        torch, np, ccfg, os.path.join(root, "crash"), cgolden)

    def build_objstore(c, sink):
        return sql_env(c, bid_stream(ccfg), sink)[0]

    o_rows, o_wall, o_launches, o_fig = run_checkpointed(
        torch, np, build_objstore,
        host_fed_conf({"plugins.modules": "flink_tpu_torch.fs_objstore"}),
        "sql-q5-objstore", "objstore://" + os.path.join(root, "objstore"),
        "chaos", limit=1 << 62)
    got = [tuple(dict(r)[c] for c in ("auction", "window_end", "bid_count"))
           for r in o_rows]
    check(len(got) == len(set(got)) and set(got) == cgolden,
          "sql q5 objstore: the resumed rows differ from the golden")
    check(o_fig["recoveries"] >= 1
          and "checkpoint.storage.write" in o_fig["injected"],
          f"sql q5 objstore: the job did not crash as planned: {o_fig}")
    paths["sql_q5_objstore"] = o_launches
    out["objstore"] = {
        "dir": "objstore://", "plugins.modules": "flink_tpu_torch.fs_objstore",
        "fault": CKPT_FAULT, "events": Q5_BATCH * SQL_CRASH_BATCHES,
        "wall_s": o_wall, "events_per_s": Q5_BATCH * SQL_CRASH_BATCHES / o_wall,
        "rows": len(got), "attempts": o_fig["attempts"],
        "recoveries": o_fig["recoveries"],
        "checkpoints_completed": o_fig["checkpoints_completed"]}

    # the goldens of 1-3
    check_q5_rows(np, rows, cfg, "sql q5 host-fed")
    expect = devgen_golden(np, dcfg)
    check(set(drows) == expect and len(drows) == len(expect),
          "sql q5 devgen: rows differ from the golden")
    max_rel, max_share = check_tumble(
        np, tcols, tumble_golden(np, tcfg, median), "sql tumble")
    t_events = Q5_BATCH * SQL_TUMBLE_BATCHES
    out["tumble_where"] = {
        "query": query, "plan_ms": tplan, "rows": len(tcols["c"]),
        "kept_share": float(tcols["c"].sum()) / t_events,
        "sum_max_rel_err": max_rel, "sum_err_share_of_bound": max_share,
        "rel_bound": "(2 * count + 34) * 2^-24", "launches": tl,
        **tier_summary(tres, twall, t_events)}
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    emit(out)
    return paths

LOG_BATCH = 1 << 18             # confs/bench_q5_backfill.conf's batch
LOG_HIST = 8                    # history batches, then live ones
LOG_LIVE = 4
LOG_AUCTIONS = 10_000


def log_bid_gen(np, n_batches, start_batch=0):
    """``bench.py`` ``run_q5_backfill``'s bids (``:564-575``): 10,000
    auctions, a unique ``event_id`` and ``ts = event_id // 100``."""
    def gen(split, i):
        if i >= n_batches:
            return None
        j = start_batch + i
        rng = np.random.default_rng(9200 + j)
        auction = rng.integers(0, LOG_AUCTIONS, LOG_BATCH).astype(np.int64)
        price = rng.integers(100, 10_000, LOG_BATCH).astype(np.int64)
        eid = j * LOG_BATCH + np.arange(LOG_BATCH, dtype=np.int64)
        ts = eid // 100
        return ({"auction": auction, "price": price, "event_id": eid,
                 "ts_ms": ts}, ts)
    return gen


def log_conf(root, extra=None):
    """confs/bench_q5_backfill.conf with ``log.dir`` at ``root``."""
    from flink_tpu_torch.config import Configuration

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_q5_backfill.conf"))
    conf.set("log.dir", root)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def log_produce(torch, np, root, name, n_batches, start_batch=0):
    """The port's ``LogSink`` commits ``n_batches`` of bids into the
    topic ``root/name`` (2 partitions keyed on ``event_id``): wall s."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.log import LogSink

    conf = log_conf(root, {"log.partitions": 2})
    env = StreamExecutionEnvironment(conf)
    env.from_source(GeneratorSource(log_bid_gen(np, n_batches, start_batch))
                    ).add_sink(LogSink.from_config(conf, name,
                                                   key_field="event_id"))
    t0 = time.perf_counter()
    res = env.execute(f"log-producer-{name}", device="cuda")
    check(res.metrics["records_in"] == n_batches * LOG_BATCH,
          f"log producer {name}: {res.metrics['records_in']} records in")
    return time.perf_counter() - t0


def log_read_s(topic, starts):
    """Seconds to read and decode the topic from ``starts`` through the
    source's own path (zero-copy, coalesced, readahead), no job."""
    from flink_tpu_torch.log import LogSource

    src = LogSource(topic, ts_field="ts_ms", batch_records=LOG_BATCH)
    t0 = time.perf_counter()
    rows = 0
    for p in src.splits():
        it = src.open_split(p, int(starts.get(int(p), 0)))
        try:
            for data, ts in it:
                rows += len(ts)
        finally:
            it.close()
    return time.perf_counter() - t0, rows


def log_consume(torch, np, root, name, group, label):
    """Q5 over ``LogSource.from_config`` on the topic, in its consumer
    group, on the card: (rows in commit order, launches, JobResult,
    wall s)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sinks import FnSink
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.log import LogSource
    from flink_tpu_torch.nexmark.queries import q5_hot_items

    conf = log_conf(root, {"log.group.name": group})
    parts = []
    env = StreamExecutionEnvironment(conf)
    q5_hot_items(env, LogSource.from_config(conf, name, ts_field="ts_ms"),
                 FnSink(lambda b: parts.append(
                     {k: np.asarray(v).copy() for k, v in b.items()})),
                 window_ms=10_000, slide_ms=1_000, out_of_orderness_ms=1_000)
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(int(a), int(w), int(c)) for p in parts
            for a, w, c in zip(p["auction"], p["window_end"], p["bid_count"])]
    return rows, dict(wk.LAUNCHES), res, wall


def log_crash_run(torch, np, root, name, golden):
    """The consumer again, checkpointing at every batch boundary, its
    output into a ``LogSink`` topic, under ``run_with_recovery`` with a
    ``log.prefetch.read`` and a ``log.txn.commit`` fault armed: the
    output topic must hold each golden row once."""
    from flink_tpu_torch import faults
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.log import LogSink, LogSource, TopicReader
    from flink_tpu_torch.nexmark.queries import q5_hot_items
    from flink_tpu_torch.obs.tracing import tracer
    from flink_tpu_torch.runtime.supervisor import run_with_recovery

    out_topic = os.path.join(root, "q5-out")
    conf = log_conf(root, {
        "log.group.name": "crash",
        "execution.checkpointing.dir": os.path.join(root, "ckpt"),
        "execution.checkpointing.interval": 1,
        "restart-strategy.type": "fixed-delay",
        "restart-strategy.fixed-delay.attempts": 5,
        "restart-strategy.fixed-delay.delay": 1})

    def build(c):
        env = StreamExecutionEnvironment(c)
        q5_hot_items(env, LogSource.from_config(c, name, ts_field="ts_ms"),
                     LogSink(out_topic, partitions=1), window_ms=10_000,
                     slide_ms=1_000, out_of_orderness_ms=1_000)
        return env

    plan = (faults.FaultPlan(seed=SEED)
            .rule("log.prefetch.read", "raise", count=1, after=4)
            .rule("log.txn.commit", "raise", count=1))
    tracer.clear()
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    with plan.activate():
        res = run_with_recovery(build, conf, job_name="log-crash",
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fired = sorted({x[0] for x in plan.log})
    recoveries = len(tracer.spans("recovery"))
    check(fired == ["log.prefetch.read", "log.txn.commit"],
          f"log crash run: the faults fired were {plan.log}")
    check(1 <= recoveries <= 2, f"log crash run: {recoveries} recoveries")
    reader = TopicReader(out_topic)
    got = [(int(a), int(w), int(c)) for _, b in reader.read(0)
           for a, w, c in zip(b["auction"], b["window_end"], b["bid_count"])]
    check(len(got) == len(set(got)),
          f"log crash run: {len(got) - len(set(got))} rows committed twice")
    check(set(got) == golden,
          f"log crash run: {len(set(got) - golden)} extra and "
          f"{len(golden - set(got))} missing rows of {len(golden)}")
    # the storage the crash left, through the port's fsck: no error
    from flink_tpu_torch.fsck import fsck_path

    fsck = {}
    for kind, path in (("output_topic", out_topic),
                       ("checkpoints", os.path.join(root, "ckpt"))):
        findings = fsck_path(path)
        errors = [f for f in findings if f["severity"] == "error"]
        check(not errors, f"log crash run: fsck of the {kind}: {errors}")
        fsck[kind] = dict(collections.Counter(f["rule"] for f in findings))
    return {"wall_s": wall, "rows": len(got), "faults": fired,
            "recoveries": recoveries, "fsck": fsck,
            "checkpoints": len(tracer.spans("checkpoint.persist")),
            "launches": dict(wk.LAUNCHES),
            "output_committed": reader.committed_offsets()[0],
            "records_in_last_attempt": res.metrics["records_in"]}


def phase_log(torch, np):
    """The durable log tier feeding Q5 on the card (see the module
    docstring, phase 25): backfill from a compacted topic, then the live
    tail through the same consumer groups, then a crash run. Returns
    each consumer job's launches, by path, for the kernels line."""
    import shutil

    from flink_tpu_torch.log import Compactor, ConsumerGroups, describe_topic

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "flink_tpu_torch", "_build", "log")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    topics = {"compacted": "bids", "plain": "bids-ref"}
    groups = {"compacted": "q5-backfill", "plain": "ref"}
    out = {"phase": "log", "batch": LOG_BATCH, "history_batches": LOG_HIST,
           "live_batches": LOG_LIVE, "partitions": 2,
           "conf": "confs/bench_q5_backfill.conf"}
    produce_s = {k: log_produce(torch, np, root, t, LOG_HIST)
                 for k, t in topics.items()}
    t0 = time.perf_counter()
    comp = Compactor(os.path.join(root, topics["compacted"]),
                     key_field="event_id", min_segments=1).compact()
    compact_s = time.perf_counter() - t0
    check(comp["gen"] == 1 and all(
        e["rows_in"] == e["rows_out"] for e in comp["partitions"].values()),
        f"log: the compaction keyed on event_id dropped rows: {comp}")
    figures, paths, rows = {}, {}, {}
    for phase, n_batches in (("backfill", LOG_HIST), ("live", LOG_LIVE)):
        if phase == "live":
            for k, t in topics.items():
                produce_s[k + "_live"] = log_produce(
                    torch, np, root, t, LOG_LIVE, start_batch=LOG_HIST)
        for k, t in topics.items():
            topic = os.path.join(root, t)
            starts = ConsumerGroups.committed(topic, groups[k])
            got, launches, res, wall = log_consume(
                torch, np, root, t, groups[k], f"log-{phase}-{k}")
            check(res.metrics["records_in"] == n_batches * LOG_BATCH,
                  f"log {phase} {k}: {res.metrics['records_in']} records in "
                  f"for {n_batches * LOG_BATCH} bids")
            check(launches["fused_step"] + launches["topn_select_append"] > 0
                  and launches["fused_step"] + launches["window_counts"] > 0,
                  f"log {phase} {k}: no fire or top-n kernel launched: "
                  f"{launches}")
            rows[(phase, k)] = got
            paths[f"log_{phase}_{k}"] = launches
            if k == "compacted":
                read_s, read_rows = log_read_s(topic, starts)
                check(read_rows == n_batches * LOG_BATCH,
                      f"log {phase}: the read alone saw {read_rows} rows")
                busy, _ = busy_and_host(res)
                events = n_batches * LOG_BATCH
                read_wait = res.metrics.get("profile.driver.source_next", 0.0)
                push = res.metrics.get("profile.driver.push", 0.0)
                figures[phase] = {
                    "events": events, "wall_s": wall,
                    "events_per_s": events / wall, "rows": len(got),
                    "device_busy_ms": busy,
                    "device_idle_share": 1.0 - sum(busy.values()) / (
                        wall * 1e3),
                    "host_s": {"read_decode_wait": read_wait,
                               "push": push,
                               "rest": wall - read_wait - push},
                    "read_decode_alone_s": read_s,
                    "launches": {n: c for n, c in launches.items() if c}}
        check(sorted(rows[(phase, "compacted")])
              == sorted(rows[(phase, "plain")]),
              f"log {phase}: the compacted topic's rows differ from the "
              "never-compacted topic's")
    # the goldens' numpy work comes after the timed runs
    def golden(start_batch, n_batches):
        gen = log_bid_gen(np, n_batches, start_batch)
        return q5_golden(np, ((d["auction"], t) for d, t in (
            gen(0, i) for i in range(n_batches))), LOG_AUCTIONS,
            window_panes=10, pane_ms=1000)

    for phase, (start, n) in (("backfill", (0, LOG_HIST)),
                              ("live", (LOG_HIST, LOG_LIVE))):
        got = rows[(phase, "compacted")]
        check(len(got) == len(set(got)), f"log {phase}: duplicate rows")
        expect = golden(start, n)
        check(set(got) == expect,
              f"log {phase}: {len(set(got) - expect)} extra and "
              f"{len(expect - set(got))} missing rows of {len(expect)}")
    desc = describe_topic(os.path.join(root, topics["compacted"]))
    crash = log_crash_run(torch, np, root, topics["compacted"],
                          golden(0, LOG_HIST + LOG_LIVE))
    paths["log_crash"] = crash["launches"]
    out.update({
        "producer_s": produce_s, "compaction": {"seconds": compact_s, **comp},
        "backfill": figures["backfill"], "live": figures["live"],
        "rows_equal_never_compacted": True, "rows_equal_golden": True,
        "topic": {"compaction_generation": desc["compaction_generation"],
                  "committed_offsets": desc["committed_offsets"],
                  "groups": desc["groups"]},
        "crash": crash})
    shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card_line()
    emit(out)
    # the compact line: rates, idle share, host split, kernels, card
    emit({
        "log_summary": {
            "backfill_bids_per_s": figures["backfill"]["events_per_s"],
            "live_bids_per_s": figures["live"]["events_per_s"],
            "idle_share": {p: figures[p]["device_idle_share"]
                           for p in ("backfill", "live")},
            "host_s": {p: figures[p]["host_s"] for p in ("backfill", "live")},
            "kernels": figures["backfill"]["launches"],
            "crash_recoveries": crash["recoveries"],
            "fsck": crash["fsck"],
            "seconds": out["seconds"], "card": out["card"]}})
    return paths


BATCH_FILES = 16                # 2^20-word columnar parts, a part a split
BATCH_CSV_FILES = 2             # the CSV input through the C parser
BATCH_OUT = (("key", "i64"), ("window_end", "i64"), ("count", "i64"))
BATCH_IN = (("word", "i64"), ("ts", "i64"))
WC_KERNELS = ("fire_pack", "ring_columns")


def batch_write_input(np, root, fmt, n_batches):
    """The port's ``FileSink`` commits ``n_batches`` WordCount batches as
    parts of ``fmt``, one a batch, through a job: (the committed
    directory, the job's wall s)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.sources import GeneratorSource
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors import FileSink

    _, words = wordcount_source(np, n_batches)

    def gen(split, i):
        b = words(split, i)
        return None if b is None else ({"word": b[0]["word"], "ts": b[1]},
                                        b[1])

    env = StreamExecutionEnvironment(Configuration(
        {"pipeline.microbatch-size": WC_BATCH}))
    env.from_source(GeneratorSource(gen)).add_sink(
        FileSink(root, fmt, rolling_records=WC_BATCH))
    t0 = time.perf_counter()
    res = env.execute("batch-input", device="cuda")
    wall = time.perf_counter() - t0
    check(res.metrics["records_in"] == n_batches * WC_BATCH,
          f"batch input: {res.metrics['records_in']} words written")
    return os.path.join(root, "committed"), wall


def batch_wordcount(torch, np, root, in_dir, in_fmt, mode, parts, label):
    """WordCount from the files of ``in_dir`` into a CSV ``FileSink`` on
    the card, in ``mode`` (at ``parts`` shuffle partitions in batch
    mode): (committed rows as (key, window_end, count) sorted by
    (window_end, key), launches, JobResult, wall s)."""
    from flink_tpu_torch.api.environment import StreamExecutionEnvironment
    from flink_tpu_torch.api.windowing import TumblingEventTimeWindows
    from flink_tpu_torch.config import Configuration
    from flink_tpu_torch.connectors import FileSink, FileSource
    from flink_tpu_torch.formats import CsvFormat
    from flink_tpu_torch.kernels import window_kernels as wk
    from flink_tpu_torch.time.watermarks import WatermarkStrategy

    conf = Configuration.from_file(
        os.path.join(ROOT, "confs", "bench_wordcount.conf"))
    conf.set("execution.runtime-mode", mode)
    conf.set("execution.batch.shuffle-partitions", parts)
    conf.set("execution.batch.shuffle-dir", os.path.join(root, "shuffle"))
    out_dir = os.path.join(root, f"out-{label}")
    sink = FileSink(out_dir, CsvFormat(BATCH_OUT), rolling_records=WC_BATCH)
    env = StreamExecutionEnvironment(conf)
    (env.from_source(FileSource(in_dir, in_fmt, ts_field="ts",
                                batch_size=WC_BATCH),
                     WatermarkStrategy.for_bounded_out_of_orderness(0))
     .key_by("word").window(TumblingEventTimeWindows.of(1000)).count()
     .add_sink(sink))
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    res = env.execute(label, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(wk.LAUNCHES)
    got = sink.committed_batches()
    key, end, cnt = (np.concatenate([b[c] for b in got])
                     for c in ("key", "window_end", "count"))
    order = np.lexsort((key, end))
    return (key[order], end[order], cnt[order]), launches, res, wall


def phase_batch(torch, np, n_files=BATCH_FILES):
    """Bounded WordCount from files on the card, in streaming mode and
    in batch mode (see the module docstring, phase 26). Returns each
    run's launches, by path, for the kernels line."""
    import shutil

    from flink_tpu_torch.formats import CsvFormat
    from flink_tpu_torch.formats_columnar import ColumnarFormat

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "flink_tpu_torch", "_build", "batch")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    words = n_files * WC_BATCH
    col_dir, write_s = batch_write_input(
        np, os.path.join(root, "in-colb"), ColumnarFormat(BATCH_IN), n_files)
    csv_dir, csv_write_s = batch_write_input(
        np, os.path.join(root, "in-csv"), CsvFormat(BATCH_IN),
        BATCH_CSV_FILES)
    runs = {}
    for label, in_dir, fmt, mode, parts in (
            ("streaming", col_dir, ColumnarFormat(BATCH_IN), "streaming", 1),
            ("batch_p1", col_dir, ColumnarFormat(BATCH_IN), "batch", 1),
            ("batch_p4", col_dir, ColumnarFormat(BATCH_IN), "batch", 4),
            ("batch_csv", csv_dir, CsvFormat(BATCH_IN), "batch", 1)):
        runs[label] = batch_wordcount(torch, np, root, in_dir, fmt, mode,
                                      parts, label)
    figures, paths = {}, {}
    for label, (rows, launches, res, wall) in runs.items():
        n = BATCH_CSV_FILES * WC_BATCH if label == "batch_csv" else words
        m = res.metrics
        check(m["records_in"] == n,
              f"batch {label}: {m['records_in']} records in for {n} words")
        missing = [k for k in WC_KERNELS if launches[k] == 0]
        if launches["apply_pairs_u32"] + launches["scatter_counts"] == 0:
            missing.append("apply_pairs_u32/scatter_counts")
        check(not missing, f"batch {label}: kernels not launched: {missing}")
        if label != "streaming":
            check(m["batch_waves"] == 2 and m["shuffle_rows_spooled"] == n,
                  f"batch {label}: {m['batch_waves']} waves, "
                  f"{m['shuffle_rows_spooled']} rows spooled for {n}")
        busy, _ = busy_and_host(res)
        prof = {k.split(".")[-1]: v for k, v in m.items()
                if k.startswith("profile.driver.")}
        fig = {"words": n, "wall_s": wall, "words_per_s": n / wall,
               "rows": len(rows[0]), "device_busy_ms": busy,
               "device_idle_share": 1.0 - sum(busy.values()) / (wall * 1e3),
               "launches": {k: c for k, c in launches.items() if c}}
        if label != "streaming":
            fire = prof.get("batch_fire", 0.0)
            fig["waves_s"] = {
                "wave0_read_and_spool": prof.get("batch_wave0", 0.0),
                "wave1_replay_and_push": prof.get("batch_wave1", 0.0) - fire,
                "fire": fire, "commit": prof.get("batch_commit", 0.0)}
            fig["shuffle_bytes"] = m["shuffle_bytes_spooled"]
            fig["batch_wall_s"] = m["batch_wall_s"]
        figures[label] = fig
        paths[f"files_{label}"] = launches
    # the goldens' numpy work comes after the timed runs
    for label, n_b in (("streaming", n_files), ("batch_csv", BATCH_CSV_FILES)):
        golden = wordcount_golden(np, n_b)
        group = ([label] if label == "batch_csv"
                 else ["streaming", "batch_p1", "batch_p4"])
        for g in group:
            rows = runs[g][0]
            check(len(rows[0]) == len(golden[0]) and all(
                np.array_equal(a, b) for a, b in zip(rows, golden)),
                f"batch {g}: committed rows differ from the golden "
                f"({len(rows[0])} rows, {len(golden[0])} expected)")
    shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "batch", "conf": "confs/bench_wordcount.conf",
           "files": n_files, "csv_files": BATCH_CSV_FILES,
           "batch": WC_BATCH, "input_write_s": {"columnar": write_s,
                                                "csv": csv_write_s},
           "runs": figures, "rows_equal_across_runs": True,
           "rows_equal_golden": True,
           "seconds": time.perf_counter() - t_phase, "card": card_line()}
    emit(out)
    emit({"batch_summary": {
        "words_per_s": {k: f["words_per_s"] for k, f in figures.items()},
        "idle_share": {k: f["device_idle_share"] for k, f in figures.items()},
        "waves_s": {k: f["waves_s"] for k, f in figures.items()
                    if "waves_s" in f},
        "shuffle_bytes": {k: f["shuffle_bytes"] for k, f in figures.items()
                          if "shuffle_bytes" in f},
        "kernels": {k: {n: c for n, c in f["launches"].items()
                        if n in WC_KERNELS + ("apply_pairs_u32",
                                              "scatter_counts")}
                    for k, f in figures.items()},
        "seconds": out["seconds"], "card": out["card"]}})
    return paths


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "flink_tpu_torch")):
        print(f"chip_smoke: flink_tpu_torch/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    argv = sys.argv[1:]
    # a flag runs its phase alone: the phase's JSON line, the card line,
    # then the ok line
    modes = {
        "--scatter-lanes": phase_scatter_lanes,
        "--window-lanes": phase_window_lanes,
        "--launch-path": phase_launch_path,
        "--big-cells": phase_big_cells,
        "--checkpoint": lambda torch, np: (phase_build(),
                                           phase_checkpoint(torch, np)),
        "--mesh-cards": lambda torch, np: (phase_build(),
                                           phase_mesh_cards(torch, np)),
        "--hybrid": lambda torch, np: (phase_build(),
                                       phase_hybrid(torch, np)),
        "--state-tiers": lambda torch, np: (phase_build(),
                                            phase_state_tiers(torch, np)),
        "--host-patterns": lambda torch, np: (
            phase_build(), phase_host_patterns(torch, np)),
        "--rescale": lambda torch, np: (phase_build(),
                                        phase_rescale(torch, np)),
        "--sql": lambda torch, np: (phase_build(), phase_sql(torch, np)),
        "--log": lambda torch, np: (phase_build(), phase_log(torch, np)),
        "--batch": lambda torch, np: (phase_build(), phase_batch(torch, np)),
        "--host-operators": lambda torch, np: (
            phase_build(), phase_sessions(torch, np), phase_q8(torch, np),
            phase_q7(torch, np), phase_emit_defer(torch, np)),
        "--cases": lambda torch, np: phase_cases(
            torch, np, argv[argv.index("--cases") + 1].split(",")),
        **{"--" + name.replace("_", "-"): (
            lambda torch, np, name=name: phase_cases(torch, np, [name]))
           for name in ("ring_pairs", "fire_kernels", "count_topn",
                        "count_lane", "mesh_kernels")},
    }
    for worker_flag, worker in (("--hybrid-worker", hybrid_worker),
                                ("--rescale-worker", rescale_worker)):
        if worker_flag in argv:
            try:
                worker(torch, np, json.loads(
                    argv[argv.index(worker_flag) + 1]))
            except Exception:
                traceback.print_exc()
                return 1
            return 0
    # a run starts the file afresh (its worker processes append to it)
    if os.path.exists(PHASES_FILE):
        os.remove(PHASES_FILE)
    flag = next((a for a in argv if a in modes), None)
    if flag is not None:
        try:
            modes[flag](torch, np)
            print(card_line(), flush=True)
        except Exception:
            traceback.print_exc()
            return 1
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    try:
        phase_build()
        table = phase_kernels(torch, np)
        (host_fed, numpy_lane, hot_keys, count_only, q5_per_call,
         q5_rows) = phase_q5(torch, np)
        devgen, per_call = phase_q5_devgen(torch, np)
        wordcount, wc_per_call = phase_wordcount(torch, np)
        aggs, agg_per_call = phase_bid_aggs(torch, np)
        window_wc, ww_per_call = phase_window_wordcount(torch, np)
        topn_lanes, tl_per_call = phase_topn_lanes(torch, np)
        changelog, cl_per_call = phase_changelog(torch, np)
        q5_spill, sp_per_call = phase_q5_spill(torch, np)
        element, el_per_call = phase_element_window(torch, np)
        proc_time, pt_per_call = phase_proc_time(torch, np)
        mesh, mesh_per_call, m2_per_call = phase_mesh(torch, np, q5_rows)
        big = run_big_cells(torch, np)
        emit({"phase": "big_cells", **big, "card": card_line()})
        phase_checkpoint(torch, np)
        phase_sessions(torch, np)
        phase_q8(torch, np)
        phase_q7(torch, np)
        phase_emit_defer(torch, np)
        hybrid, hybrid_x1 = phase_hybrid(torch, np)
        q5_lsm = phase_state_tiers(torch, np)
        phase_host_patterns(torch, np, HP_CEP_BATCHES_CUT)
        phase_rescale(torch, np, RESCALE_BATCHES_CUT, RESCALE_CUT_CUT)
        sql_paths = phase_sql(torch, np)
        log_paths = phase_log(torch, np)
        batch_paths = phase_batch(torch, np)
        paths = {"q5_host_fed": host_fed, "q5_numpy_lane": numpy_lane,
                 "q5_hot_keys": hot_keys, "q5_count_only": count_only,
                 "q5_devgen": devgen,
                 "wordcount": wordcount, "bid_aggs_a": aggs["a"],
                 "bid_aggs_b": aggs["b"], "window_wordcount": window_wc,
                 "topn_lanes": topn_lanes, "changelog": changelog,
                 "q5_spill": q5_spill, "element_window": element,
                 "proc_time": proc_time, "mesh_q5": mesh,
                 "hybrid": hybrid, "q5_lsm": q5_lsm,
                 "big_cells": {k: big["launches"].get(k, 0)
                               for k in host_fed},
                 **sql_paths, **log_paths, **batch_paths}
        # each kernel's count on its own main path: the headline (devgen)
        # path for the Q5 kernels it runs, else host-fed Q5; the fused
        # step on host-fed Q5's native lane, scatter_counts on its numpy
        # lane, apply_pairs_u16 on its hot keys without the top-n (with it
        # they ride the fused step); apply_pairs_u32 and
        # fire_pack on WordCount; the two lane scatters on their
        # bid-aggregate job; count_fire on
        # WindowWordCount; the top-n lane kernels on job T's first run;
        # segment_lanes on job E; the key-sharded path's kernels on job M1
        own_path = {"scatter_counts": "q5_numpy_lane",
                    "fused_step": "q5_host_fed",
                    "apply_pairs_u16": "q5_count_only",
                    "apply_pairs_u32": "wordcount", "fire_pack": "wordcount",
                    "scatter_lanes": "bid_aggs_a",
                    "scatter_pair_lanes": "bid_aggs_b",
                    "scatter_split_counts": "q5_spill",
                    "count_fire": "window_wordcount",
                    "window_lanes": "topn_lanes",
                    "topn_select_lanes": "topn_lanes",
                    "segment_lanes": "element_window",
                    **{k: "mesh_q5" for k in MESH_KERNELS}}
        for row in table:
            name = row["name"]
            if name in UNLAUNCHED:
                # no path calls them (UNLAUNCHED); each is held against
                # its plain version in the kernels phase, and its count
                # over every path's run must stay 0
                row["launches_by_path"] = {p: l[name]
                                           for p, l in paths.items()}
                row["launches"] = sum(row["launches_by_path"].values())
                row["launches_path"] = None
                row["pipeline_device_ms"] = None
                check(row["launches"] == 0,
                      f"{name} launched on a path that should not call it")
                continue
            # device time per call inside the profiled pipeline runs (the
            # "ms" above is a launch loop, host-bound for short kernels)
            row["pipeline_device_ms"] = (mesh_per_call.get(name)
                                         if name in MESH_KERNELS else
                                         per_call.get(name)
                                         or wc_per_call.get(name)
                                         or agg_per_call.get(name)
                                         or q5_per_call.get(name)
                                         or ww_per_call.get(name)
                                         or tl_per_call.get(name)
                                         or cl_per_call.get(name)
                                         or sp_per_call.get(name)
                                         or el_per_call.get(name)
                                         or pt_per_call.get(name))
            if name == "scatter_lanes":
                # device ms a call on every path that folds records per
                # record: the profiled runs count one hist kernel a call
                row["pipeline_device_ms_by_path"] = by_path = {
                    "bid_aggs_a": agg_per_call.get(name),
                    "window_wordcount": ww_per_call.get(name),
                    "topn_lanes": tl_per_call.get(name),
                    "changelog": cl_per_call.get(name),
                    "mesh_m2": m2_per_call.get(name)}
                check(all(by_path.values()),
                      f"scatter_lanes has no device time a call on {by_path}")
            if name == "bucket_records":
                # X1 on the hybrid path: its launches by both processes'
                # intra_slice_exchange, loop ms at the path's median
                # shape, device ms a call (profiled), bound a call
                row["hybrid"] = hybrid_x1
            if name == "ring_columns":
                # device ms a call where the purge moves one lane (devgen
                # Q5, WordCount) and where it moves a four-lane block
                # (bid-aggs (a)) or two (job T)
                row["pipeline_device_ms_by_path"] = {
                    "q5_devgen": per_call.get(name),
                    "wordcount": wc_per_call.get(name),
                    "bid_aggs_a": agg_per_call.get(name),
                    "topn_lanes": tl_per_call.get(name)}
            path = own_path.get(name, "q5_devgen")
            row["launches"] = paths[path][name] or host_fed[name]
            row["launches_path"] = path
            row["launches_by_path"] = {p: l[name] for p, l in paths.items()}
            check(row["launches"] > 0, f"{name} never launched on its path")
        emit({"phase_seconds": {
            name: t - PHASE_ENDS[i][1]
            for i, (name, t) in enumerate(PHASE_ENDS[1:])}})
        print(card_line(), flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    record_line({"kernels_detail": table})
    emit({"kernels": [{k: row.get(k) for k in KERNEL_LINE_KEYS}
                      for row in table]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
