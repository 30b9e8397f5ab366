#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero; nothing is caught):
  1. card     — name, power limit, torch and CUDA versions
  2. build    — compile every kernel source in
                 risingwave_tpu_torch/kernels/csrc (sorted_runs.cu,
                 join_runs.cu, multiset_runs.cu, window_runs.cu,
                 skew_runs.cu, tier_runs.cu, expr_eval.cu, agg_pack.cu,
                 exchange.cu, datagen.cu: one nvcc each, in parallel) into
                 build/torch_kernels; then the host kernels
                 (risingwave_tpu_torch/native/rw_native.cpp, g++ into
                 build/torch_native), before the second process starts
  2'. native  — first of the main process's phases: each host kernel
                 against its numpy plain version, to the bit, at the
                 paths' host shapes (vnodes_i64 at 2^16 and 2^22 keys,
                 crc32_rows and memcmp_i64 at 2^16 rows), with the
                 medians of 15 host calls of each; after 4k, each
                 per-operator path's calls of them (q4e, q3e, q5e,
                 q4sql, q5sql, qlj_proc, q4e_m; zeroed just before its
                 drive, read just after), each path but q3e (keyed by
                 several columns only) with vnodes_i64 calls. All in the
                 {"main": ...} line's "native".
  3. kernels  — each of the nineteen kernels against its plain PyTorch
                 version on the card, at the main paths' shapes and on edge
                 cases: exact for integer and bool leaves, padding included;
                 a float SUM within 1e-12 of the summed magnitudes (the plain
                 version adds with atomics, in no fixed order); NaN where
                 the plain version has NaN. sort_cols is held with its
                 permutation (a row-index payload) on keys live in one
                 byte or none, with EMPTY rows, at a sort tile's row count
                 and one either side, and on q5's 10,485,760 pairs;
                 batch_reduce on segments ending at its tile edges, across
                 tiles, and few long ones with NaN, bool MIN / MAX (AND /
                 OR) included; merge_side with a side row and its delta
                 twin across every 2048-row tile edge of the merged order,
                 C + B at four tiles and one row either side, all deletes,
                 sign 0 and +2 deltas; merge the same way (twins across
                 every tile edge, C + B at four tiles and one row either
                 side with EMPTY rows or none, 30% twins at C = 2^21,
                 needed > C, all deletes, all-EMPTY state and delta,
                 REPLACE of bool, int32 and f64 beside f64 and bool MIN /
                 MAX); compact_rows at n = k x 2048 and one row either
                 side, out_len below the alive count, none or all alive;
                 batch_reduce_rows on (jk, pk) runs
                 crossing its tiles or ending at their edges and on
                 EMPTY_KEY segments (sorted row 0's payload);
                 ms_batch_reduce on one pair over 513 tiles, pair
                 boundaries at every tile edge and one row either side
                 (masked rows moving them, EMPTY_KEY k1 beside a live k2),
                 wrapping int64 sums and fewer rows than a tile;
                 touch_stamp, in both modes, on equal-key runs straddling
                 the edges of its merge-path pieces in all three runs, an
                 old run across pieces whose first row carries, 200,000
                 deleted old keys between new ones, no old rows, no or
                 only EMPTY_KEY touched keys and stamps exactly TIER_TTL
                 old; probe with queries in the main path's order
                 (batch_reduce_rows' sorted jk, sign-0 rows masked in
                 place) and in random order, with a total past 2^32 (2^16
                 queries of a key the side holds 2^17 times), with q not a
                 multiple of its 2048-query tile and m < q, all masked;
                 vnode_hists (a keyed node's one call) with a join's three
                 tables and an agg's two, an n = 0 table among them, and
                 four tables into three rows; topk_packed on runs crossing
                 a thread's 8-row, a warp's 256-row and a tile's 2048-row
                 edge, runs a tile long, across three tiles and to the
                 last row, an EMPTY tail at a tile edge and inside a
                 thread's rows, a run past the count clip, n = 1 .. 7,
                 counts <= 0 and rows not 16-byte aligned, then its
                 ticket word (zero), 20 calls replayed from one CUDA graph
                 (each equal to an eager call) and its CUDA launches a
                 call (one); ms_merge with a pair and its twin across
                 every 2048-row tile edge (living, dying, going below 0,
                 truncated), every pair dying and an all-masked delta;
                 ms_find on q5's multiset and queries, capacities 1 to
                 3 and either side of its 2047-pair sample, 2^14 and
                 2^20, with pairs below and above every pair, EMPTY q1
                 and live q1 with EMPTY q2 in random order, all queries
                 EMPTY, sorted queries with an EMPTY tail, q off its four
                 queries a thread and query views at odd 8-byte offsets
                 (`msf_edge_arrays`); expr_eval on 156 programs and on
                 its edges (`expr_edge_specs`: 1, 7, 9, 511, 513 and
                 2^20 + 3 rows, inputs at odd element offsets for every
                 width, a program at depth 8, one of 128 instructions,
                 16 inputs and 16 outputs);
                 agg_unpack at n_calls 1..6 and B from 1 (a tail only)
                 to 2^22, and on rows that are not 4-byte aligned;
                 bucket_exchange, to the bit, one source at n in {1, 3,
                 8} and B from 1 to 2^20 (off its tiles) in both forms
                 (the engines' cap = B, the fused exchange's ~2B / n
                 with sign-0 rows dead), int64 / f64 / int32 / bool
                 columns with their fills, all rows dead, one key that
                 overflows its bucket, bounds with empty blocks, and hot
                 keys broadcast and salted (negative pks); then the
                 one-call form over every source (`bxs_cases`) at n_src
                 = n in {1, 3, 8} and n_src = 1 with n = 8, B from 1 to
                 2^20 (2048: each source ends on a tile edge; 2047, 2049
                 one row either side), both forms, one source all dead,
                 one overflowing alone, bounds, hot keys broadcast and
                 salted in every source, and its CUDA launches a call
                 over 8 sources (at most three); gen_bids, to
                 the bit, at n in {1, 31, 2^18, 2^20 + 7, 2^22}, seeds 0,
                 42 and 2^33 + 7 (a high key word), 300, 10^4 and 10^6
                 auctions, skews 3.0, 2.0 and 0.5, and down a 50-epoch
                 key chain
Every main path runs under the reference's default arms: each keyed
node (agg, join) adds its vnode occupancy, heavy hitters and vnode
traffic to its stats every epoch (the vnode_hist and topk_packed
kernels) and stamps each row's last-touched epoch (touch_stamp; its
`tres` must equal the node's final live rows), and each path prints its
`skew_report` skew_ratio and rank-0 hot_key rows per keyed node. What
the telemetry and the touch arm cost is measured per path: each keyed
node's time in one epoch armed and disarmed (median of 9, in turns),
and the whole drive without the pull, bare and armed in turns.
  4a. q4      — Nexmark q4 (`SELECT auction, count(*), sum(price),
                 max(price) FROM bid GROUP BY auction`, pre-combine on) over
                 2^24 events in epochs of 2^20 from a 2^16 capacity, with a
                 checkpoint every 4 epochs; rows checked in key order against
                 a numpy group-by of the port generator's bid stream
  4a'. q4p, q4p_wide — the fused device pipeline (datagen -> hash agg
                 -> MV, `device/pipeline.py`): bids from gen_bids on the
                 card, no host traffic in an epoch. q4p is bench.py
                 stage_fused's shape (50 epochs of 262,144 bids over
                 10,000 auctions, count / sum / max of price, capacity
                 2^14), q4p_wide 16 epochs of 2^20 bids over 10^6
                 auctions at capacity 2^20 (~1.0M groups). Each runs
                 eagerly and as replays of one epoch captured as a CUDA
                 graph; both end in the same states, key and max_needed,
                 leaf by leaf, max_needed <= capacity is read once at the
                 end, and the MV equals a numpy group-by (bench.py's
                 numpy_q4) of the generator's replayed columns. Each
                 prints events/s, host and wall ms per epoch (the wall
                 also as the median of its epochs on the card's
                 timeline) and launches per epoch for both runs, and
                 gen_bids' call, device,
                 bound and plain times at its shape
  4b. q3a     — Nexmark q3a (`SELECT b.auction, b.price, a.seller,
                 a.category FROM bid b JOIN auction a ON b.auction = a.id
                 WHERE b.price > 500`) over 2^23 events in epochs of 2^20,
                 join sides and MV from 2^16, pairs from 4 x 2^16, a
                 checkpoint every 4 epochs; rows checked in (bid, auction)
                 row-id order against a numpy hash join of the port
                 generator's streams
  4c. q5      — Nexmark q5 (two HOP(2 s, 10 s) branches: count per (window,
                 auction), and the max of those counts per window through a
                 retractable max — a multiset — joined on the window with
                 num >= maxn) over 2^23 events in epochs of 2^20, every node
                 from 2^16 (pairs 4 x 2^16), a checkpoint every 4 epochs; the
                 sorted multiset of (auction, num) checked against a numpy
                 oracle of the port generator's bids
  4c'. q5obs  — q5 as a user's job runs it: the same job with its epoch
                 profiler on (the default), the profiler and a
                 BarrierTracer on one temporary data directory, the flight
                 recorder attached there (a boot record, one record a
                 barrier), a FreshnessTracker as the job's `freshness`,
                 each barrier wrapped in inject -> job_start / job_end ->
                 commit. Checked: (a) rows equal the oracle's and, in
                 order, the q5 path's; (b) one profile record per
                 dispatching barrier, phases within [0.9, 1.001] of each
                 wall over 1 ms, no h2d / promote_h2d / demote_d2h /
                 exchange time, one compile event per node, the jsonl's
                 offline summary equal to the live one; (c) no open epoch
                 in the trace, a clean Chrome export, a flight-recorder
                 bundle that gives back the records written; (d) one
                 freshness commit per checkpoint after a dispatch, each in
                 (0, drive wall); (e) `node_report` counts equal to the
                 unprofiled job's; (f) a fresh job whose overload ladder
                 is fed full credit starvation stretches its cadence to 2
                 from the third barrier, same rows in fewer barriers; (g)
                 16 reads from 4 threads through one MVReadCache make one
                 pull, one more after `invalidate`; (h) the drive with the
                 profiler off and on, in turns (off, on, on, off, three
                 times), no pull. Prints one [main] q5obs line
  4d. q7      — Nexmark q7 (the max price per TUMBLE(10 s) window joined back
                 to the bids of that window) over 2^23 events, the same
                 cadence; rows checked against a numpy oracle
  4e. q8      — Nexmark q8 (the persons who sold an auction in the TUMBLE(10
                 s) window they joined in: two distincts joined on (id =
                 seller, window)) over 2^26 events (Nexmark's usual 10^8, cut
                 for time), the same cadence; rows checked against a numpy
                 oracle of the port generator's persons and auctions, and
                 each distinct agg's telemetry against its final key table
                 (a numpy vnode histogram) and the rows it was routed
  4e'. q4_sql, q3a_sql, q5_sql, q7_sql, q8_sql — the same five main
                 paths from SQL, fused: CREATE SOURCE / CREATE
                 MATERIALIZED VIEW through the port's Database
                 (DeviceConfig(capacity=2^16), an in-memory store, every
                 arm at its default, a checkpoint every tick) on cuda:0,
                 lowered by try_fuse to a FusedJob (no source iterator on
                 the host), the hand-built paths' events in chunks of
                 2^14 (an epoch 2^20; q3a_sql at 2^21, a quarter of
                 q3a's depth, held to a device q3a run of that depth);
                 ticks until the job has drained
                 and once more (launches zeroed just before, read after
                 the SELECT), then SELECT *. The rows must pass the
                 path's oracle check and equal the visible columns of the
                 hand-built job's rows from this run, in order; each
                 kernel's launches per epoch are printed beside the
                 hand-built job's, and both node lists where they
                 differ. q5_sql also holds rw_fused_node_stats to
                 job.node_report() and EXPLAIN ANALYZE's node lines to
                 those rows. Each prints the drive, SELECT and MV-persist
                 walls (the persists run inside the drive), growth
                 replays, and the device memory after CREATE (beside the
                 job's own state) and at the end
  4e''. q5_sql_restart, q5_sql_inplace, qa_sql_tiered_restart — the
                 fused jobs' recovery, from SQL on cuda:0 over a data
                 directory in a temporary directory. q5_sql_restart: q5_sql
                 (2^23 events, epochs of 2^20, DeviceConfig(capacity=
                 2^16), a checkpoint every tick) driven to drained, SELECT
                 *, the Database dropped and collected, a new one opened on
                 the directory (launches zeroed just before, read just
                 after): the job fused again, its committed counter equal,
                 no growth replay added (presized from the job table),
                 every q5 kernel launched by the replay, the rows equal
                 the first run's and the oracle's; prints the DDL replay,
                 recover() and first SELECT walls and the device memory
                 after the reopen. q5_sql_inplace: one drive for each of
                 fused.dispatch, fused.device_sync, fused.checkpoint_commit
                 and fused.growth_replay, armed to fire once after the
                 second epoch (the growth replay's at the first capacity
                 of Q5_GROWTH_CAPS whose undisturbed drive grows after
                 it): one recovery, the same job object, the undisturbed
                 rows; prints each recovery's wall, its history and crash
                 window epochs and its kernel launches.
                 qa_sql_tiered_restart: the zipf:1.5 group-by host-fed
                 (nexmark.ingest='host', the overload manager's admission
                 bucket wired), tiering on, pre-combine off, held at 2^14
                 groups, epochs of 2^14, QAR_EVENTS events; one
                 fused.dispatch fault after the first demotion (one
                 recovery); it must demote, promote and write its tiering
                 journal; then a reopen on the directory rebuilds both
                 tiers: cold stores equal, rows equal the first run's and
                 the numpy group-by's, no growth replay added, every qa
                 kernel launched by the replay; tier walls of the drive
                 and of the replay printed
  4e'''. wire — the port's entry points on the card. A PgServer over
                 a Database (DeviceConfig(capacity=2^16), a data
                 directory in a temporary directory, a checkpoint every
                 tick) on cuda:0, spoken to by a raw protocol-v3 client
                 (PgClient): CREATE SOURCE, then q5's and q7's CREATE
                 MATERIALIZED VIEW (2^23 events, chunks of 2^14), each
                 driven by FLUSH until drained and once more (launches
                 zeroed just before, read just after the SELECT), read by
                 `SELECT *` (equal to the in-process serving path's and
                 db.query's rows, the oracle's, and q5's to q5_sql's rows
                 from this run; q5's launches per epoch equal q5_sql's)
                 and by a Parse / Bind / Execute with one BIGINT
                 parameter under a row limit below the result (the
                 portal must suspend and resume; its rows equal the
                 filtered SELECT's). COPY ... FROM STDIN (csv) of 2^16
                 seeded rows into a table with a device group-by over it,
                 read back equal to numpy's. The server stopped and the
                 directory released, each WIRE_CTL risectl command in a
                 process of its own (exit codes as listed, its JSON
                 parsed, fused-stats' committed events equal to the
                 drive's, compile-status' "aot" false, --offline exit 1);
                 a Database reopened on the directory with device="auto"
                 behind a second server, whose first SELECTs equal the
                 rows before; the e2e_test .slt files through the port's
                 run_slt_file with the device path on cuda:0. Prints the
                 server's start wall, each drive beside q5_sql's, each
                 SELECT's wall over the wire beside the in-process ones,
                 the portal's, the COPY rate, each risectl command's
                 wall, the reopen's and each .slt file's
  4f. q3a_tiered, qa_tiered — host-fed (HostIngest) in epochs of 2^14,
                 a checkpoint every 4: q3a over 2^22 events with its bid
                 side held at 2^21 slots (rows equal to a device q3a run's
                 of the same depth and the oracle's; it must demote), and
                 over 2^23 events a zipf:1.5 group-by with pre-combine
                 off held at 2^14 groups (rows equal a numpy group-by; it
                 must demote and promote; its heavy hitters stay out of
                 the cold stores); every tiering counter and the
                 promote_h2d / demote_d2h walls printed
  4g. qa_zipf_device — the zipf:1.5 group-by fed by the device generator
                 (its power-law picks on CUDA) over 2^22 events in epochs
                 of 2^20 from 2^12 groups; rows equal the host generator's
                 numpy group-by
  4h. q4e, q4e_r, q3e — the per-operator device path: executors under
                 a StreamJob over a MemoryStateStore, fed by ListReaders
                 (chunks of 2^16 rows) and wired as the SQL planner wires
                 them, state tables included. q4e: q4's aggregation
                 (DeviceHashAggExecutor, append-only) over 2^22 events, a
                 checkpoint barrier every 2^20, from 2^16 slots; q4e_r:
                 the same with a seeded third of each epoch's bids deleted
                 in the next (max through the multiset); q3e: q3a's join
                 (DeviceHashJoinExecutor, price > 500 evaluated on the
                 host) over 2^19 events, a barrier every 2^17. Rows equal
                 q4_oracle, a numpy group-by of the surviving bids, and
                 q3a_oracle; each path grows and replays; each prints its
                 per-barrier split between the engine's flush_epoch and
                 the executors' host work
  4h'. q5e — Nexmark q5 as the executor graph the SQL planner builds
                 with a DeviceConfig (q5e_graph): two NexmarkReader scans
                 of the bid table (polls of 2^16 events), each HOP(2 s,
                 10 s) -> Project -> DeviceHashAgg count(*) per (window,
                 auction); the max branch's DeviceHashAgg max(num) per
                 window over a retracting input (its multiset table);
                 DeviceHashJoin(starttime, num >= maxn) -> Project ->
                 Materialize; every state table as the planner's
                 make_state lays it out, over a SpillStateStore in a
                 temporary directory. 2^18 events, a checkpoint barrier
                 every 2^17, engines from 2^12 slots (the max agg's from
                 2^6); each grows and replays. Its MV equals the host
                 twin's (the same graph of host HashAgg / HashJoin over a
                 MemoryStateStore) and the numpy q5 oracle over the
                 readers' bids; a second SpillStateStore on the directory
                 reads every state table back equal. Prints the drive
                 wall, the host twin's, the per-barrier flush / host
                 split, growth replays, the directory's bytes and runs
                 and each kernel's launches per barrier
  4h''. q4sql, q5sql — Nexmark q4 and q5 from SQL: bench.py's bid
                 source and its Q4_MV / Q5_MV through the port's Database
                 (sql/: parser, optimizer, planner, batch engine) over a
                 spill store, `DeviceConfig(fuse=False, capacity=2^12)` on
                 cuda:0, a checkpoint every barrier, ticked until the
                 source is drained (launches zeroed just before the first
                 tick, read just after the last). q4sql: 2^22 events in
                 chunks of 2^14 (2^20 a tick); its plan a DeviceHashAgg
                 and no HashAgg; `SELECT * FROM q4` equals a numpy
                 group-by of the host generator's bids, two batch queries
                 (a filtered top-20, count(*) and sum(c), which must be
                 the bid count) equal numpy; the engine grows and
                 replays. q5sql: q5e's 2^18 events in chunks of 2^11
                 (2^17 a tick); its plan three DeviceHashAggs (the max's
                 with its multiset table) and one DeviceHashJoin, its
                 state tables laid out as q5e_graph's (ids shifted past
                 the source's two); rows equal the numpy q5 oracle, q5e's
                 and a host-only Database's driven through the same
                 statements; then a second Database on the directory
                 replays the DDL log, passes the device marker, reloads
                 every engine, and answers the same rows before and after
                 one more tick. Each prints the drive wall, ticks (and
                 those that carried events: not the first, the source's
                 initial barrier, nor the last), events, the SELECT and
                 batch walls, the twin's and the reopen's walls, growth
                 replays and launches per event-carrying tick
  4h'''. qlj_proc — worker-process placement: every auction LEFT JOIN its
                 bids (`SQL_QLJ_MV`, no join condition, so no device
                 join) through the port's Database with
                 `streaming_parallelism = 4`, `streaming_placement =
                 'process'`, `DeviceConfig(fuse=False, capacity=2^16)` on
                 cuda:0 and a checkpoint every barrier, over the auction
                 and bid sources at 2^18 events in chunks of 2^10: the join
                 in 4 worker processes (a RemoteStatefulSet; the
                 coordinator keeps its shadows), the agg over its
                 retractable output a DeviceHashAgg (its max on a multiset
                 table). Checks the plan, that nvidia-smi lists no worker
                 (no worker holds a CUDA context) before and after the
                 drive, the kernels' launches, rows equal to a numpy
                 oracle's and a host-only local-placement Database's, the
                 cluster metrics plane (`worker_epochs_total`,
                 `worker_liveness`, `rw_worker_liveness` all `ok`), then a
                 supervised arm (2^16 events, join worker 0 SIGKILLed
                 after the third tick, respawned in place from the
                 shadows, rows equal to the undisturbed run's). Prints
                 each worker's spawn-to-ADDR wall, the drive wall and
                 events/s, the device agg's push and flush walls and its
                 share of the drive, and the respawn's tick and spawn
                 walls
  4i. q4m, q5m, q3am, q4e_m, q3e_m — the sharded paths: MESH_SHARDS
                 (8) shards laid on the one card (all on cuda:0),
                 telemetry and tiering off, epochs of 2^20, a checkpoint
                 every 4. q4m (q4, 2^23 events, from 2^14 slots a shard),
                 q5m (2^23) and q3am (2^21: the pair pull) with their
                 exchanges armed by arm_exchange; their rows equal their
                 numpy oracles and, in order, their 1-shard runs (made
                 first, outside the counted launches). q4e_m: q4e's
                 executor with mesh=, 2^22 events from 2^12 slots a
                 shard, rescale_mesh to 3 shards after the second
                 barrier; q3e_m: q3e's with mesh=, 2^18 events; rows
                 equal q4_oracle and q3a_oracle. Each prints shards,
                 devices, the drive wall, the exchanges' host wall
                 (exchange_s), growth replays and the pull seconds
  4j. mesh_policy — the mesh skew policy, host ingest and tiering on a
                 mesh, serving replicas: five jobs created from SQL on the
                 port's Database, `DeviceConfig(mesh_shards=8,
                 capacity=2^16, rebalance_threshold=1.2)` on cuda:0 with
                 the skew, rebalance and hot-key arms at their defaults
                 and a commit every tick, each job's rows equal, in order,
                 to the same SQL's 1-shard run (made first, outside the
                 counted launches). q1_reb: Q1_MV (per-bidder count, sum,
                 max) over zipf:4 bids, 2^22 events in epochs of 2^18:
                 the job rebalances (bounds not the uniform ones, the
                 shard-skew ratio under them no higher), rw_key_skew has
                 shard_load and shard_skew rows, and a reopen of its
                 directory restores the bounds and the rows. q3_hot:
                 Q3_MV (bid JOIN auction, price > 500) over zipf:8 bids,
                 2^21 events: the join adopts hot_keys (0,), the auction
                 side broadcast, rows equal the 8-shard run with
                 hot_key_rep off; the largest shard's share of the
                 join's bid rows off and on. q1_fed8: Q1_MV host-fed
                 with its admission bucket, 2^21 events, per-shard feeds.
                 qa_tiered8: qa_tiered's zipf:1.5 group-by host-fed and
                 tiered, 2^21 events in epochs of 2^14, each shard's agg
                 clamped at 2^11 slots (blind growth: a projection would
                 size it past the clamp at the exchange's first
                 overflow): demotions, promotions, cold rows on at least
                 two shards. q5_rep: q5 on 4 shards x 2
                 replicas, 2^21 events: rows equal replicas=1's, four
                 SELECTs alternate over the replica columns. Each prints
                 its walls, launches per epoch, and its own figures
                 (rebuild-replay walls, per-shard loads, feed counts,
                 tier walls, the replica copy's wall and bytes)
  4k. mesh_devices — the fused mesh over several devices in one
                 process: four jobs from SQL, 8 shards dealt over
                 [cuda:0, cpu] (`Database(torch_device=[...])`), each
                 job's rows equal, in order, to the same SQL's run with
                 every shard on cuda:0 (made first, outside the counted
                 launches) and to its numpy oracle where there is one.
                 q1a_fed: Q1_MV host-fed over zipf:4 bids (per-shard
                 feeds to the card and to the CPU), rebalancing;
                 q3a_grow: Q3_MV from 2^12 slots a shard (its exchange
                 buckets overflow, it grows and replays); q5_rep: q5 on
                 4 shards x 2 replicas (the replica column on the CPU,
                 SELECTs alternating over it), then faulted once at
                 fused.dispatch and healed in place to the same rows;
                 qa_tiered: the tiered group-by in epochs of 2^14, 2^11
                 slots a shard, cold rows on a card shard and a CPU
                 shard. The per-source bucket_exchange (n_src = 1) held
                 to its plain version at q1a_fed's shape; with more than
                 one card, q3a over every card too. Each prints its
                 layout, walls, the collectives' cross-device copies
                 (bytes, calls, host wall by direction) and launches per
                 epoch; the phase's JSON lists the depth cuts (`cuts`)
  5. timings  — each kernel at its main-path shape: median of CUDA-event
                 times over 25 runs, beside its plain version, a PyTorch
                 library composition of the same function, and its
                 device-memory bound at 3.35 TB/s (H100 SXM), and by
                 CUDA-graph replay, without the host's launch path;
                 batch_reduce_rows split into its sort and its reduce,
                 ms_batch_reduce's sort timed alone (with the reduce's and
                 the sort's own byte bounds), touch_stamp at a q8
                 distinct's shape too (its bound counts only the old
                 stamps the run's data needs), vnode_hists as q8's agg
                 and join call it beside the one-table calls it
                 replaces at the same inputs, merge's bound counting
                 each run's live rows (the kernel stops at the first
                 all-EMPTY tile), and merge's and merge_side's peak
                 device memory of one call beyond its outputs. A count
                 of 32-byte sectors, a binary search's
                 (search_sectors_ms) or a gather's (reduce_sectors_ms),
                 is an estimate beside the bound, not a bound;
                 bucket_exchange, one call a whole exchange over the 8
                 sources, at q4m's agg exchange and q5m's join exchange
                 (every shard's last input, captured) and at the sharded
                 agg engine's shape, with its CUDA launches and its
                 temporaries beyond the buffers; agg_unpack's call and its
                 library composition's also in turns (200 pairs, median
                 and interquartile range of each); ms_merge's bound
                 counting each run's live pairs beside the every-row one,
                 and ms_find's its live queries' q2 beside the every-row
                 one

    python3 chip_smoke.py --mesh-policy

builds the kernels and runs only phase 4j (mesh_policy), printing the
card line and one {"mesh_policy": ...} line;

    python3 chip_smoke.py --recovery

builds the kernels and runs only phase 4e'' (the q5 oracle computed
first), printing the card line and one {"recovery": ...} line;

    python3 chip_smoke.py --placement [LOG2_EVENTS]

builds the kernels and runs only phase 4h''' (qlj_proc, its drive at
2^LOG2_EVENTS events if given), printing the card line and one
{"placement": ...} line;

    python3 chip_smoke.py --wire

builds the kernels, runs q5 and q7 hand-built and from SQL (what the
wire phase is held to), then only the wire phase (4e'''), printing the
card line and one {"wire": ...} line;

    python3 chip_smoke.py --merge-side-memory

builds the kernels and prints only merge_side's memory line at the timing
shape, for a tree whose merge_side is to be compared;

    python3 chip_smoke.py --kernel-turns

builds them and prints only the timings of topk_packed, agg_unpack (with
its call and the library's in turns), ms_merge, ms_find (at ms_merge's
result with its delta as queries, and at `msf_dense`: every query live,
unsorted), expr_eval (the five `expr_timings` programs, beside
`launch_floor`: a near-empty kernel replayed the same way) and the whole
bucket exchange through its seams (`exchange_turns`: q4m's agg and q5m's
join exchange after their drives, the engine's on seeded bids; call and
device ms, bound, CUDA launches, device memory) on seeded inputs at the
smoke's shapes (`kernel_turns`): run it from a parent's tree (this script
copied in) and from this one in turns to compare the two.
Launch counts are zeroed just before each main path and read just after.

Phases 4h .. 4h''' (qlj_proc first), 4j and 4k run in a second process
of this script (`--host-paths FILE`, its reports written to FILE), started
just after the build on the same card, beside the others: they are host
bound (per-row Python, host twins, worker processes) and read nothing of
the other phases. The main process takes their reports after 4i, and
fails if the second process failed or is still running 1100 s after the
start. Each process counts its own launches. The walls of both, and the
main process's kernel timings, are taken beside the other process's work.
The last four lines are the card line, the {"main": ...} line, the
{"kernels": [...]} line and the {"ok": ...} line, in that order; the
paths' {"telemetry": ...} lines come just before them.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from risingwave_tpu_torch import kernels as K
from risingwave_tpu_torch import native as N
from risingwave_tpu_torch import ops as O
from risingwave_tpu_torch.connectors.datagen import ListReader
from risingwave_tpu_torch.connectors.nexmark import (NexmarkConfig,
                                                     _event_kinds,
                                                     gen_surrogates)
from risingwave_tpu_torch.core import Column, Op, Schema, StreamChunk
from risingwave_tpu_torch.core import dtypes as T
from risingwave_tpu_torch.device import datagen as PD
from risingwave_tpu_torch.device import fused as F
from risingwave_tpu_torch.device import materialize as PM
from risingwave_tpu_torch.device import pipeline as PP
from risingwave_tpu_torch.device.agg_step import DeviceAggSpec, _row_deltas
from risingwave_tpu_torch.core.vnode import (VNODE_COUNT, _int_key_bytes,
                                             compute_vnodes_dev,
                                             crc32_bytes_matrix,
                                             vnodes_i64_plain)
from risingwave_tpu_torch.device.fuse_planner import (_TsShift, arm_exchange,
                                                      arm_telemetry,
                                                      host_ingest,
                                                      prune_ingest_columns,
                                                      tier_plans, to_ingest)
from risingwave_tpu_torch.device.join_step import JoinSide, join_core
from risingwave_tpu_torch.device.minput import SortedMultiset
from risingwave_tpu_torch.device.nexmark_gen import (GenCfg, gen_table,
                                                     table_mask)
from risingwave_tpu_torch.device.skew_stats import (SK_BUCKETS, SK_COUNT_MAX,
                                                    SK_KEY_MASK, SK_TOPK,
                                                    hot_key_set)
from risingwave_tpu_torch.device.sorted_state import (EMPTY_KEY, ReduceKind,
                                                      SortedState, _neutral)
from risingwave_tpu_torch.device.tiering import TIER_TTL, TieredState
from risingwave_tpu_torch.expr.agg import AggCall as SqlAggCall
from risingwave_tpu_torch.expr.expression import Case as F_Case
from risingwave_tpu_torch.expr.expression import InputRef, Literal
from risingwave_tpu_torch.expr.functions import build_func
from risingwave_tpu_torch.expr.functions import cast as F_cast
from risingwave_tpu_torch.ops.device_agg import (device_minput_count,
                                                 device_payload_dtypes)
from risingwave_tpu_torch.device import shard_exec as SE
from risingwave_tpu_torch.parallel import sharded_agg as SA
from risingwave_tpu_torch.parallel import sharded_join as SJ
from risingwave_tpu_torch.parallel.mesh import make_mesh
from risingwave_tpu_torch.runtime import StreamJob
from risingwave_tpu_torch.state import MemoryStateStore, StateTable
from risingwave_tpu_torch.config import ROBUSTNESS
from risingwave_tpu_torch.serving import MVReadCache
from risingwave_tpu_torch.utils import blackbox as BB
from risingwave_tpu_torch.utils import export as EX
from risingwave_tpu_torch.utils import profile as PR
from risingwave_tpu_torch.utils import trace as TR
from risingwave_tpu_torch.utils.freshness import FreshnessTracker
from risingwave_tpu_torch.utils.overload import PRESSURE, OverloadManager

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
CSRC = "risingwave_tpu_torch/kernels/csrc/"
REPLACES = {"sort_cols": "risingwave_tpu/device/sorted_state.py:189",
            "batch_reduce": "risingwave_tpu/device/sorted_state.py:108",
            "merge": "risingwave_tpu/device/sorted_state.py:227",
            "compact_rows": "risingwave_tpu/device/sorted_state.py:206",
            "batch_reduce_rows": "risingwave_tpu/device/join_step.py:57",
            "merge_side": "risingwave_tpu/device/join_step.py:83",
            "probe": "risingwave_tpu/device/join_step.py:118",
            "hop_expand": "risingwave_tpu/device/fused.py:786",
            "ms_batch_reduce": "risingwave_tpu/device/minput.py:79",
            "ms_merge": "risingwave_tpu/device/minput.py:98",
            "ms_find": "risingwave_tpu/device/minput.py:136",
            "vnode_hist": "risingwave_tpu/device/skew_stats.py:69",
            "topk_packed": "risingwave_tpu/device/skew_stats.py:102",
            "touch_stamp": "risingwave_tpu/device/fused.py:1186",
            "tier_partition": "risingwave_tpu/device/fused.py:1758",
            "expr_eval": "risingwave_tpu/expr/expression.py:156",
            "agg_unpack": "risingwave_tpu/device/agg_step.py:338",
            "bucket_exchange": "risingwave_tpu/device/shard_exec.py:165",
            "gen_bids": "risingwave_tpu/device/datagen.py:26"}
# every path runs armed: each keyed node launches both telemetry kernels
# and the tiering recency arm (touch_stamp); demotion (tier_partition)
# runs only on the host-fed tiered paths
SKEW_KERNELS = ("vnode_hist", "topk_packed", "touch_stamp")
Q4_KERNELS = ("sort_cols", "batch_reduce", "merge", "compact_rows") \
    + SKEW_KERNELS
# merge_side compacts in its own pass, so the join paths launch compact_rows
# only where an agg's merge or a hop's bound does. q3a's price filter,
# q5's join condition, q7's time bounds, q1c's Map and q2c's Filter run in
# expr_eval; q4's, q8's and qa's Maps are column references only and
# launch nothing
Q3A_KERNELS = ("sort_cols", "batch_reduce_rows", "merge_side", "probe",
               "expr_eval") + SKEW_KERNELS
# q5 runs every fused-path kernel; agg_unpack runs only on the
# per-operator agg path, bucket_exchange only on the sharded paths,
# gen_bids only on the fused device pipeline
Q5_KERNELS = tuple(k for k in REPLACES
                   if k not in ("tier_partition", "agg_unpack",
                                "bucket_exchange", "gen_bids"))
Q8_KERNELS = Q4_KERNELS + ("batch_reduce_rows", "merge_side", "probe",
                           "hop_expand")
Q7_KERNELS = Q8_KERNELS + ("expr_eval",)
Q1C_KERNELS = Q2C_KERNELS = Q4_KERNELS + ("expr_eval",)
Q3T_KERNELS = Q3A_KERNELS + ("tier_partition",)
QA_KERNELS = ("sort_cols", "batch_reduce", "merge", "compact_rows",
              "tier_partition") + SKEW_KERNELS
QZ_KERNELS = tuple(k for k in QA_KERNELS if k != "tier_partition")
_CU = {"join_step": "join_runs.cu", "minput": "multiset_runs.cu",
       "fused": "window_runs.cu", "sorted_state": "sorted_runs.cu",
       "skew_stats": "skew_runs.cu", "expression": "expr_eval.cu",
       "agg_step": "agg_pack.cu", "shard_exec": "exchange.cu",
       "datagen": "datagen.cu"}
SOURCE = {k: CSRC + _CU[v.split("/")[-1].split(".")[0]]
          for k, v in REPLACES.items()}
SOURCE["touch_stamp"] = SOURCE["tier_partition"] = CSRC + "tier_runs.cu"
MAX_EVENTS = 1 << 24
Q3_EVENTS = 1 << 23
QA_EVENTS = 1 << 23
QA_KEY_DIST = "zipf:1.5"
# The tiered paths' epochs: a checkpoint every CKPT_EVERY of them, and
# demotion acts one checkpoint after the pull that selects it, so a
# checkpoint window must be a small share of the clamp (at 2^20-event
# epochs the whole 2^23-event run is two checkpoints)
TIER_EPOCH_EVENTS = 1 << 14
# q3a_tiered: 2^22 events (half q3a's depth, so that the smoke keeps
# inside its time with the fused SQL paths), the bid side held at 2^21
# slots (the untiered run's final bid side takes 2^22, 2x); the auction
# side, pair buffer and MV start at sizes that never grow, so no other
# slot's growth replay drops a pending recency pull
Q3T_EVENTS = 1 << 22
Q3T_CLAMP = 1 << 21
Q3T_PRESIZE = {"a": Q3T_CLAMP, "b": 1 << 19, "pairs": 1 << 18,
               "mv": 1 << 23}
# qa_tiered: the agg (and its MV) held at 2^14 groups; untiered it
# takes 2^16
QA_CLAMP = 1 << 14
# qa_zipf_device: the same query fed by the device generator (its
# _zipf_ordinal on CUDA) over 2^22 events from 2^12 groups, so it grows
QZ_EVENTS = 1 << 22
QZ_CAPACITY = 1 << 12
# the per-operator device path (DeviceHashAggExecutor / DeviceHashJoin-
# Executor under a StreamJob): q4's aggregation over 2^22 events, its bids
# in 2^16-row chunks and a checkpoint barrier every 2^20 events, from
# 2^16 slots; q4e_r the same with a third of each epoch's bids deleted in
# the next; q3a's join over 2^19 events (cut from q3a's 2^23: the
# executor's per-row host work sets the wall, and the three paths are
# held to about a minute of the smoke), a barrier every 2^17
OP_CHUNK = 1 << 16
Q4E_EVENTS = 1 << 22
Q4E_EPOCH = 1 << 20
Q3E_EVENTS = 1 << 19
Q3E_EPOCH = 1 << 17
Q4E_KERNELS = ("agg_unpack", "sort_cols", "batch_reduce", "merge")
Q4ER_KERNELS = Q4E_KERNELS + ("ms_batch_reduce", "ms_merge", "ms_find")
Q3E_KERNELS = ("batch_reduce_rows", "merge_side", "probe")
# q5e: Nexmark q5 as the planner's executor graph over a SpillStateStore,
# with its host twin (the same graph of host executors) beside it. 2^18
# events: q5's 2^23 cut for the twin's per-row Python (at 2^19 the twin
# took 64.6 s on the card's host, past a minute, so halved), a
# checkpoint barrier every 2^17, the readers polling 2^16 events at a
# time, every engine from 2^12 slots but the max agg's, whose few
# hundred groups and multiset rows would never outgrow 2^12
Q5E_EVENTS = 1 << 18
Q5E_EPOCH = 1 << 17
Q5E_POLL = 1 << 16
Q5E_CAPACITY = 1 << 12
Q5E_MAX_CAPACITY = 1 << 6      # the max agg: a few hundred (window, num)
Q5E_KERNELS = Q4ER_KERNELS + Q3E_KERNELS
# the sharded paths: every one at MESH_SHARDS shards, all on cuda:0 (one
# card), telemetry and tiering off (as the reference's mesh tests run),
# epochs of 2^20 events, a checkpoint every 4. q4m and q5m over 2^23
# events, q3am over 2^21 (the pair pull), q4e_m over 2^22 with a rescale
# to 3 shards after the second barrier, q3e_m over 2^18; the engines
# start from 2^12 slots so they grow
MESH_SHARDS = 8
Q4M_EVENTS = 1 << 23
Q5M_EVENTS = 1 << 23
Q3AM_EVENTS = 1 << 21
Q4EM_EVENTS = 1 << 22
Q3EM_EVENTS = 1 << 18
OPM_CAPACITY = 1 << 12
MESH_CAPACITY = 1 << 14        # the fused sharded paths' per-shard start
Q4EM_RESCALE = (2, 3)          # after this barrier, to this many shards
Q4M_KERNELS = ("sort_cols", "batch_reduce", "merge", "compact_rows",
               "bucket_exchange")
Q5M_KERNELS = tuple(k for k in Q5_KERNELS if k not in SKEW_KERNELS) \
    + ("bucket_exchange",)
Q3AM_KERNELS = ("sort_cols", "batch_reduce_rows", "merge_side", "probe",
                "expr_eval", "bucket_exchange")
Q4EM_KERNELS = ("sort_cols", "batch_reduce", "merge", "bucket_exchange")
Q3EM_KERNELS = Q3E_KERNELS + ("bucket_exchange",)
# q2c keeps one auction in 123: too few groups to outgrow 2^16 slots over
# 2^24 events, so it starts at 2^12 to grow and replay as q4 does (q1c's
# bidders outgrow 2^16)
Q2C_CAPACITY = 1 << 12
Q5_EVENTS = 1 << 23
Q7_EVENTS = 1 << 23
Q8_EVENTS = 1 << 26
USEC = 1_000_000
TS = ("ts",)
EPOCH_EVENTS = 1 << 20
CAPACITY = 1 << 16
CKPT_EVERY = 4

S, MN, MX, R = (ReduceKind.SUM, ReduceKind.MIN, ReduceKind.MAX,
                ReduceKind.REPLACE)


def inner(state):
    """A node's state without its tiering wrapper."""
    return state.inner if isinstance(state, TieredState) else state


T_START = time.perf_counter()


# set in the smoke's second process (`--host-paths`)
LOG_TAG = ""
SMOKE_PROCS = 1


def log(msg: str) -> None:
    """A line on stderr, stamped with the seconds since the import."""
    print(f"[{time.perf_counter() - T_START:7.1f}s] {LOG_TAG}{msg}",
          file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in leaves(e)]
    raise TypeError(type(x))


def compare(name: str, case: str, got, want, float_atol: float = 0.0
            ) -> float:
    """Every leaf equal (integer/bool exactly; float within float_atol);
    returns the max abs difference."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}/{case}: {len(g)} leaves vs {len(w)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name}/{case} leaf {i}: {a.dtype}{tuple(a.shape)}"
                                 f" vs {b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            # NaN where the other has NaN, the same infinities elsewhere
            fin, nan = torch.isfinite(b), torch.isnan(b)
            inf = ~fin & ~nan
            if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
                    torch.isnan(a), nan) or not torch.equal(a[inf], b[inf]):
                raise AssertionError(f"{name}/{case} leaf {i}: non-finite differ")
            d = (a[fin] - b[fin]).abs()
            err = float(d.max()) if d.numel() else 0.0
            if err > float_atol:
                raise AssertionError(f"{name}/{case} leaf {i}: max abs err "
                                     f"{err} > {float_atol}")
            worst = max(worst, err)
        elif not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"{name}/{case} leaf {i}: {bad} elements differ")
    return worst


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def rand_keys(rng, n, lo, hi):
    return rng.integers(lo, hi, size=n, dtype=np.int64)


def payload(rng, n, dtype):
    if dtype == torch.float64:
        return torch.from_numpy(rng.normal(0, 1000, n))
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-1000, 1000, n, dtype=np.int32))
    return torch.from_numpy(rng.integers(-10**6, 10**6, n, dtype=np.int64))


ALL_KINDS = [(S, torch.int64), (MN, torch.int64), (MX, torch.int64),
             (R, torch.int64), (S, torch.int32), (R, torch.int32),
             (S, torch.float64), (MN, torch.float64), (MX, torch.float64),
             (R, torch.float64), (R, torch.bool)]
Q4_PRE_KINDS = [(S, torch.int64)] * 4 + [(MX, torch.int64), (S, torch.int64)]


BOOL_MINMAX = [(MN, torch.bool), (MX, torch.bool), (S, torch.bool)]
RED_TILE = 2048                # rows per tile of the reduce kernels and of
                               # merge_side's merged order
SORT_TILE = 4096               # rows per tile of the sort kernel's passes


def seg_keys(rng, bounds):
    """Shuffled keys whose sorted runs end at `bounds` (exclusive ends):
    run i holds key 7 i - 20."""
    lens = np.diff(np.concatenate([[0], bounds]))
    keys = np.repeat(np.arange(len(lens), dtype=np.int64) * 7 - 20, lens)
    return keys[rng.permutation(len(keys))]


def br_cases(rng, dev):
    """(case, keys, mask, vals, kinds) for batch_reduce at 2^20 and edges."""
    n = 1 << 20
    out = []

    def mk(case, keys, mask, spec, nan_rows=None):
        vals = [payload(rng, len(keys), d).to(dev) for _, d in spec]
        if nan_rows is not None:
            for v in vals:
                if v.dtype == torch.float64:
                    v[torch.from_numpy(nan_rows).to(dev)] = float("nan")
        out.append((case, torch.from_numpy(keys).to(dev),
                    torch.from_numpy(mask).to(dev), vals,
                    [k for k, _ in spec]))

    mk("q4_shape_2^20", rand_keys(rng, n, 0, 1 << 20), rng.random(n) < 0.92,
       [(S, torch.int64)] + Q4_PRE_KINDS)
    mk("all_kinds_2^20", rand_keys(rng, n, -5000, 5000),
       rng.random(n) < 0.9, ALL_KINDS)
    mk("n=1", rand_keys(rng, 1, 0, 10), np.ones(1, bool), ALL_KINDS)
    mk("all_keys_equal", np.full(n, 7, np.int64), np.ones(n, bool),
       ALL_KINDS)
    mk("all_masked", rand_keys(rng, 4096, 0, 100), np.zeros(4096, bool),
       ALL_KINDS)
    k = rand_keys(rng, 65536, 0, 1000)
    k[rng.random(65536) < 0.1] = EMPTY_KEY
    mk("empty_key_inside", k, rng.random(65536) < 0.9, ALL_KINDS)
    mk("negative_keys", rand_keys(rng, 65536, -(1 << 62), -(1 << 62) + 5000),
       rng.random(65536) < 0.9, ALL_KINDS)
    # segments that end at a tile edge and one row either side, and ones
    # that cross more than three tiles
    t = RED_TILE
    bounds = [t, 2 * t - 1, 2 * t + 1, 3 * t - 1, 3 * t, 3 * t + 1, 4 * t,
              8 * t - 1, 8 * t + 1, 13 * t, 13 * t + 2, 20 * t + 5]
    k = seg_keys(rng, bounds)
    mk("tile_edges", k, np.ones(len(k), bool), ALL_KINDS + BOOL_MINMAX)
    m = rng.random(len(k)) < 0.9
    mk("tile_edges_masked", k, m, ALL_KINDS + BOOL_MINMAX)
    # few long segments (a window per key, as the pre-combines see them):
    # REPLACE, f64 SUM with NaN in two of the segments, NaN MIN / MAX,
    # bool MIN / MAX
    k = rand_keys(rng, n, 0, 11)
    mk("few_long_segments", k, rng.random(n) < 0.92, ALL_KINDS + BOOL_MINMAX,
       nan_rows=np.isin(k, [3, 8]) & (rng.random(n) < 1e-4))
    mk("one_segment_nan", np.full(n, -4, np.int64), np.ones(n, bool),
       ALL_KINDS + BOOL_MINMAX, nan_rows=np.arange(n) == n // 3)
    return out


def sorted_unique(rng, m, lo, hi):
    return np.unique(rng.integers(lo, hi, size=m, dtype=np.int64))


def make_sorted_state(rng, cap, keys, spec, dev):
    """A SortedState of capacity `cap` holding `keys` (sorted unique); the
    first (dead) column is nonzero on every live row."""
    n = len(keys)
    kk = np.full(cap, EMPTY_KEY, np.int64)
    kk[:n] = keys
    vals = []
    for j, (k, d) in enumerate(spec):
        v = torch.full((cap,), _neutral(k, d), dtype=d)
        live = payload(rng, n, d)
        if j == 0:
            live = live.abs() + 1 if d != torch.bool else torch.ones(n, dtype=d)
        v[:n] = live
        vals.append(v.to(dev))
    return SortedState(torch.from_numpy(kk).to(dev),
                       torch.tensor(n, dtype=torch.int32, device=dev),
                       tuple(vals))


def merge_cases(rng, dev):
    """(case, state, dkeys, dvals, kinds, drop_dead) with sorted unique
    deltas (batch_reduce output order), EMPTY_KEY padded."""
    out = []

    def mk(case, cap, skeys, b, dkeys, spec, drop_dead=True, kill=0.2):
        st = make_sorted_state(rng, cap, skeys, spec, dev)
        nd = len(dkeys)
        dk = np.full(b, EMPTY_KEY, np.int64)
        dk[:nd] = dkeys
        dvals = []
        for k, d in spec:
            v = payload(rng, b, d)
            v[nd:] = _neutral(k, d)
            dvals.append(v)
        if nd and len(skeys):
            # some deltas take their group's dead column to 0 (death)
            pos = np.clip(np.searchsorted(skeys, dkeys), 0, len(skeys) - 1)
            kill_m = (skeys[pos] == dkeys) & (rng.random(nd) < kill)
            rows = torch.from_numpy(np.flatnonzero(kill_m))
            s0 = st.vals[0].cpu()[torch.from_numpy(pos[kill_m])]
            dvals[0][rows] = -s0 if spec[0][0] == S else torch.zeros_like(s0)
        out.append((case, st, torch.from_numpy(dk).to(dev),
                    [v.to(dev) for v in dvals], [k for k, _ in spec],
                    drop_dead))

    c, b = 1 << 21, 1 << 20
    agg = [(S, torch.int64)] * 4 + [(MX, torch.int64), (S, torch.int64)]
    mk("agg_C=2^21_B=2^20", c, sorted_unique(rng, 1 << 20, 0, 1 << 21), b,
       sorted_unique(rng, 300_000, 0, 1 << 21), agg)
    mv = [(R, torch.int32)] + [(R, torch.int64), (R, torch.bool)] * 3
    mk("mv_replace", c, sorted_unique(rng, 1 << 20, 0, 1 << 21), b,
       sorted_unique(rng, 300_000, 0, 1 << 21), mv)
    mk("all_kinds", 8192, sorted_unique(rng, 3000, -5000, 5000), 4096,
       sorted_unique(rng, 2000, -5000, 5000), ALL_KINDS)
    mk("no_drop_dead", 8192, sorted_unique(rng, 3000, -5000, 5000), 4096,
       sorted_unique(rng, 2000, -5000, 5000), ALL_KINDS, drop_dead=False)
    mk("needed>C", 4096, sorted_unique(rng, 3500, 0, 10**6), 4096,
       sorted_unique(rng, 3000, 0, 10**6), agg, kill=0.0)
    mk("n=1", 1, np.array([5], np.int64), 1, np.array([5], np.int64), agg,
       kill=0.0)
    mk("negative_keys", 8192, sorted_unique(rng, 3000, -(1 << 62),
                                            -(1 << 62) + 9000), 4096,
       sorted_unique(rng, 2000, -(1 << 62), -(1 << 62) + 9000), agg)
    mk("empty_state", 4096, np.zeros(0, np.int64), 4096,
       sorted_unique(rng, 1000, 0, 10**6), agg)
    # the one-pass kernel's edges: a state row and its delta twin across
    # every 2048-row tile edge of the merged order; C + B at four tiles
    # and one row either side, EMPTY rows or none
    t = RED_TILE
    for case, cap, nb, ns, nd in (("C+B=4x2048-1_full", 2 * t, 2 * t - 1,
                                   2 * t, 2 * t - 1),
                                  ("C+B=4x2048", 2 * t, 2 * t, 1900, 1700),
                                  ("C+B=4x2048+1", 2 * t + 1, 2 * t, 2 * t,
                                   1500),
                                  ("tile_edges_2^20", 1 << 20, 1 << 19,
                                   700_000, 400_000)):
        sk, dk = merge_runs(rng, straddle_items(rng, ns, nd, 0.3))
        mk(case, cap, sk, nb, dk, ALL_KINDS if cap < t * 4 else agg)
    sk = sorted_unique(rng, 1 << 20, 0, 1 << 23)
    twins = rng.choice(sk, 90_000, replace=False)
    mk("C=2^21_B=2^20_30%_twins", c, sk, b,
       np.unique(np.r_[twins, rng.integers(0, 1 << 23, 210_000)]), agg)
    mk("needed>C_2^20", 1 << 20, sorted_unique(rng, 1 << 20, 0, 1 << 22),
       1 << 20, sorted_unique(rng, 600_000, 0, 1 << 22), agg, kill=0.0)
    mk("all_deletes", c, sk, b, np.sort(twins), agg, kill=1.0)
    mk("all_empty_state_2^20", 1 << 20, np.zeros(0, np.int64), b,
       sorted_unique(rng, 600_000, 0, 1 << 22), agg)
    mk("all_empty", 1 << 20, np.zeros(0, np.int64), b, np.zeros(0, np.int64),
       agg)
    mk("replace_bool_i32_f64", 1 << 20, sorted_unique(rng, 600_000, 0,
                                                        1 << 21), b,
       sorted_unique(rng, 300_000, 0, 1 << 21),
       [(S, torch.int64), (R, torch.bool), (R, torch.int32),
        (R, torch.float64), (MN, torch.float64), (MX, torch.float64),
        (MN, torch.bool), (MX, torch.bool), (R, torch.int64)])
    return out


def compact_cases(rng, dev):
    out = []
    cols_spec = [torch.int64, torch.int32, torch.float64, torch.bool]

    def mk(case, alive, out_len):
        n = len(alive)
        keys = [torch.from_numpy(rand_keys(rng, n, 0, 1 << 40)).to(dev)]
        cols = [payload(rng, n, d).to(dev) for d in cols_spec]
        fills = [EMPTY_KEY, 0, -1, 0.5, False]
        out.append((case, torch.from_numpy(alive).to(dev), keys, cols,
                    out_len, fills))

    n = (1 << 21) + (1 << 20)
    mk("merge_shape", rng.random(n) < 0.4, 1 << 21)
    mk("needed>out_len", rng.random(n) < 0.9, 1 << 21)
    mk("all_alive", np.ones(1 << 20, bool), 1 << 20)
    mk("none_alive", np.zeros(1 << 20, bool), 1 << 20)
    mk("n=1", np.ones(1, bool), 1)
    mk("out_len>n", rng.random(1000) < 0.5, 5000)
    # the one-pass kernel's 2048-row tiles: n at k tiles and one row
    # either side, out_len below the alive count
    t = RED_TILE
    for k in (3, 512):
        for n in (k * t - 1, k * t, k * t + 1):
            mk(f"n={k}x2048{n - k * t:+d}_out_len<total", rng.random(n) < 0.6,
               n // 2)
    mk("none_alive_4097", np.zeros(4097, bool), 4097)
    mk("all_alive_out_len<total", np.ones((1 << 20) + 1, bool), 1 << 19)
    return out


def sort_cases(rng, dev):
    """(case, keys, cols) for sort_cols; cols[0] is the row index, so the
    permutation itself is compared."""
    out = []
    n = 1 << 20
    pay = [torch.int64, torch.int32, torch.float64, torch.bool]

    def mk(case, keys, payloads=pay):
        ks = [torch.from_numpy(np.asarray(k, np.int64)).to(dev) for k in keys]
        m = len(keys[0])
        cols = [torch.arange(m, device=dev)] + [
            payload(rng, m, d).to(dev) for d in payloads]
        out.append((case, ks, cols))

    def with_empty(k, p=0.08):
        k = k.copy()
        k[rng.random(len(k)) < p] = EMPTY_KEY
        return k

    k = rand_keys(rng, n, -(1 << 40), 1 << 40)
    k[rng.random(n) < 0.05] = EMPTY_KEY
    mk("one_key_2^20_with_empty", [k])
    mk("two_keys_2^20", [rand_keys(rng, n, 0, 1000),
                         rand_keys(rng, n, -(1 << 62), 1 << 62)])
    mk("all_equal_2^20", [np.full(n, -3, np.int64)])
    mk("n=1", [rand_keys(rng, 1, 0, 5)])
    mk("negative_keys", [rand_keys(rng, 65536, np.iinfo(np.int64).min,
                                   -(1 << 50))])
    # live keys that vary in one byte only, or not at all (the other
    # digits dead), with and without EMPTY rows
    shapes = {"top_byte_only": rng.integers(-128, 128, n) << 56,
              "middle_byte_only": (rng.integers(0, 256, n) << 24) + 12345,
              "constant": np.full(n, 42, np.int64)}
    for name, k in shapes.items():
        mk(name, [k])
        mk(name + "_with_empty", [with_empty(k)])
    mk("all_empty", [np.full(n, EMPTY_KEY, np.int64)])
    k = rand_keys(rng, n, -5000, 0)
    k[:3] = [np.iinfo(np.int64).min, EMPTY_KEY - 1, -1]
    mk("negative_next_to_empty", [with_empty(k, 0.3)])
    for m in (SORT_TILE - 1, SORT_TILE, SORT_TILE + 1, 100_003):
        mk(f"n={m}", [with_empty(rand_keys(rng, m, -(1 << 40), 1 << 40))])
    mk("two_keys_k1_constant", [np.full(n, 5, np.int64),
                                with_empty(rand_keys(rng, n, -999, 999))])
    mk("two_keys_k2_constant", [with_empty(rand_keys(rng, n, 0, 1000)),
                                np.full(n, -9, np.int64)])
    # q5's retractable max input: 10,485,760 masked (window, count) pairs
    k1, k2, _, m = q5_pairs(rng, 10_485_760)
    mk("q5_pairs_10485760", [np.where(m, k1, EMPTY_KEY),
                             np.where(m, k2, EMPTY_KEY)], payloads=[])
    return out


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def unique_pairs(rng, n, jk_hi, pk_hi):
    """n distinct (jk, pk) pairs in random order."""
    jk = rand_keys(rng, 2 * n + 16, 0, jk_hi)
    pk = rand_keys(rng, 2 * n + 16, 0, pk_hi)
    pairs = np.unique(np.stack([jk, pk], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))[:n]]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def brr_cases(rng, dev):
    """(case, jk, pk, signs, mask, vals) for batch_reduce_rows at the q3a
    shapes (an epoch's bids, the netting pass's 2m pair rows x 19
    columns) and on edge cases."""
    out = []

    def mk(case, jk, pk, signs, mask, dtypes):
        vals = [payload(rng, len(jk), d).to(dev) for d in dtypes]
        out.append((case, _dev(jk, dev), _dev(pk, dev),
                    _dev(np.asarray(signs, np.int32), dev), _dev(mask, dev),
                    vals))

    n = 1 << 20
    mk("q3a_bids_2^20", rand_keys(rng, n, 0, 1 << 19),
       np.arange(n, dtype=np.int64), np.ones(n), rng.random(n) < 0.92,
       [torch.int64] * 8)
    m2 = 1 << 21
    a, b = rand_keys(rng, m2, 0, 1 << 23), rand_keys(rng, m2, 0, 1 << 22)
    dup = rng.random(m2) < 0.3                 # pairs from both probes
    src = rng.integers(0, m2, m2)
    a[dup], b[dup] = a[src[dup]], b[src[dup]]
    mk("netting_2^21x19", a, b, rng.choice([-1, 1], m2),
       rng.random(m2) < 0.7, [torch.int64] * 15 + [torch.float64] * 4)
    k = 65536
    mk("dups_mixed_signs", rand_keys(rng, k, 0, 40), rand_keys(rng, k, 0, 30),
       rng.choice([-1, 0, 1, 2], k), rng.random(k) < 0.9,
       [torch.int64, torch.float64, torch.int32, torch.bool])
    jk, pk = unique_pairs(rng, k // 2, 1000, 1000)
    mk("net_zero", np.repeat(jk, 2), np.repeat(pk, 2), np.tile([1, -1], k // 2),
       np.ones(k, bool), [torch.int64, torch.float64])
    mk("all_masked", rand_keys(rng, 4096, 0, 9), rand_keys(rng, 4096, 0, 9),
       np.ones(4096), np.zeros(4096, bool), [torch.int64, torch.float64])
    mk("n=1", np.array([3]), np.array([4]), np.array([-1]), np.ones(1, bool),
       [torch.int64])
    jk = rand_keys(rng, k, 0, 100)
    jk[rng.random(k) < 0.1] = EMPTY_KEY
    mk("empty_jk_unmasked", jk, rand_keys(rng, k, 0, 100), np.ones(k),
       rng.random(k) < 0.9, [torch.int64, torch.float64])
    jk, pk = rand_keys(rng, k, 0, 50), rand_keys(rng, k, 0, 50)
    jk[: k // 2], pk[: k // 2] = 7, 9           # one hot (jk, pk) pair
    mk("hot_pair", jk, pk, rng.choice([-1, 1], k), np.ones(k, bool),
       [torch.int64])
    # runs crossing the reduce's 2048-row tiles, or ending at a tile edge
    # and one row either side of one; f64 / int32 / bool payloads
    t = RED_TILE
    m = 40 * t
    pick = rng.integers(0, 5, m)
    mk("segments_cross_tiles", np.array([3, 3, 8, 9, 9])[pick],
       np.array([1, 4, 0, 2, 7])[pick], rng.choice([-1, 0, 1, 2], m),
       rng.random(m) < 0.9, EDGE_DTYPES)
    ends = [t - 1, t, t + 1, 2 * t - 1, 2 * t + 1, 3 * t, 3 * t + 2,
            8 * t - 1, 8 * t + 1, 13 * t, 20 * t + 5]
    run = np.repeat(np.arange(len(ends)), np.diff(np.r_[0, ends]))
    o = rng.permutation(len(run))
    mk("tile_edges", (run // 3 * 5 - 7)[o], ((run % 3) * 11 + 2)[o],
       rng.choice([-1, 0, 1, 2], len(run)), np.ones(len(run), bool),
       EDGE_DTYPES)
    jk = rand_keys(rng, m, 0, 40)
    jk[rng.random(m) < 0.15] = EMPTY_KEY     # EMPTY segments: row 0's payload
    mk("empty_segment_row0", jk, rand_keys(rng, m, 0, 30),
       rng.choice([-1, 0, 1, 2], m), rng.random(m) < 0.9, EDGE_DTYPES)
    return out


EDGE_DTYPES = [torch.float64, torch.int32, torch.bool, torch.int64]


def straddle_items(rng, n_side, n_delta, p_pair):
    """Item kinds in merged order — "s" a side row alone, "d" a delta row
    alone, "p" a side row and its delta twin — up to n_side side and
    n_delta delta rows, a pair across every RED_TILE-row tile edge of the
    merged order (its side row the tile's last, its twin the next tile's
    first) while both runs have rows left; lone rows from either run in
    proportion to what it has left."""
    kinds, pos, ns, nd = [], 0, 0, 0
    while ns < n_side or nd < n_delta:
        room = ns < n_side and nd < n_delta
        if room and (pos + 1) % RED_TILE == 0:
            k = "p"
        elif room and rng.random() < p_pair and (pos + 2) % RED_TILE:
            k = "p"
        else:
            rs, rd = n_side - ns, n_delta - nd
            k = "s" if rng.random() * (rs + rd) < rs else "d"
        ds, dd = (k != "d"), (k != "s")
        kinds.append(k)
        ns, nd, pos = ns + ds, nd + dd, pos + ds + dd
    return np.array(kinds)


def straddle_pairs(rng, kinds):
    """The (jk, pk) of the side and of the delta for `straddle_items`'
    kinds: distinct pairs ascending, jk repeating (a multimap)."""
    n = len(kinds)
    jk = np.sort(rng.integers(0, max(n // 3, 1), n))
    pk = rng.integers(-(1 << 40), 1 << 40, n)
    o = np.lexsort((pk, jk))
    jk, pk = jk[o], pk[o]
    keep = np.r_[True, (jk[1:] != jk[:-1]) | (pk[1:] != pk[:-1])]
    if not keep.all():
        raise AssertionError("straddle_pairs: a duplicate pair")
    s, d = kinds != "d", kinds != "s"
    return (jk[s], pk[s]), (jk[d], pk[d])


def merge_runs(rng, kinds, lo=-(1 << 40)):
    """The state's and the delta's sorted unique keys for
    `straddle_items`' kinds: keys ascending in merged order, a pair's key
    in both runs."""
    keys = lo + np.cumsum(rng.integers(1, 1000, len(kinds)))
    return keys[kinds != "d"], keys[kinds != "s"]


def join_side(rng, cap, jk, pk, dtypes, dev):
    """A JoinSide of capacity `cap` holding the (jk, pk) rows, sorted."""
    order = np.lexsort((pk, jk))
    n = len(order)
    kk = np.full(cap, EMPTY_KEY, np.int64)
    pp = np.full(cap, EMPTY_KEY, np.int64)
    kk[:n], pp[:n] = np.asarray(jk)[order], np.asarray(pk)[order]
    vals = []
    for d in dtypes:
        v = torch.zeros(cap, dtype=d)
        v[:n] = payload(rng, n, d)
        vals.append(v.to(dev))
    return JoinSide(_dev(kk, dev), _dev(pp, dev),
                    torch.tensor(n, dtype=torch.int32, device=dev),
                    tuple(vals))


def side_delta(rng, b, jk, pk, signs, dtypes, dev):
    """(djk, dpk, dsign, dvals): the rows sorted by (jk, pk), padded to b
    with EMPTY_KEY — batch_reduce_rows' output order."""
    order = np.lexsort((pk, jk))
    n = len(order)
    kk = np.full(b, EMPTY_KEY, np.int64)
    pp = np.full(b, EMPTY_KEY, np.int64)
    ss = np.zeros(b, np.int32)
    kk[:n], pp[:n] = np.asarray(jk)[order], np.asarray(pk)[order]
    ss[:n] = np.asarray(signs)[order]
    return (_dev(kk, dev), _dev(pp, dev), _dev(ss, dev),
            [payload(rng, b, d).to(dev) for d in dtypes])


def ms_cases(rng, dev):
    """(case, side, djk, dpk, dsign, dvals) for merge_side."""
    out = []

    def mk(case, cap, b, s_pairs, d_pairs, signs, dtypes):
        side = join_side(rng, cap, *s_pairs, dtypes, dev)
        out.append((case, side) + side_delta(rng, b, *d_pairs, signs,
                                             dtypes, dev))

    # the bid side: ~3M rows, an epoch of 0.9M new bids (unique pks)
    n_s, n_d = 3_000_000, 900_000
    pk = rng.permutation(n_s + n_d)
    mk("q3a_bids_C=2^22_B=2^20", 1 << 22, 1 << 20,
       (rand_keys(rng, n_s, 0, 1 << 19), pk[:n_s]),
       (rand_keys(rng, n_d, 0, 1 << 19), pk[n_s:]), np.ones(n_d),
       [torch.int64] * 8)
    # the pair MV: inserts, retractions of present pairs, masked (0) rows
    sj, sp = unique_pairs(rng, 1_000_000, 1 << 22, 1 << 22)
    nj, np_ = unique_pairs(rng, 600_000, 1 << 22, 1 << 22)
    hit = rng.random(len(nj)) < 0.3
    pick = rng.integers(0, len(sj), len(nj))
    nj[hit], np_[hit] = sj[pick[hit]], sp[pick[hit]]
    dj, dp = np.unique(np.stack([nj, np_], 1), axis=0).T
    mk("mv_pairs_C=2^21", 1 << 21, 1 << 20, (sj, sp), (dj, dp),
       rng.choice([-1, 0, 1, 1, 1], len(dj)), [torch.int64] * 6)
    # upserts, deletes of present and absent rows, zero signs, net +2
    sj, sp = unique_pairs(rng, 3000, 200, 200)
    nj, np_ = unique_pairs(rng, 3000, 200, 200)
    dj, dp = np.unique(np.stack([np.r_[sj[:1500], nj], np.r_[sp[:1500], np_]],
                                1), axis=0).T
    mk("upsert_delete_absent_+2", 8192, 8192, (sj, sp), (dj, dp),
       rng.choice([-1, 0, 1, 2], len(dj)),
       [torch.int64, torch.float64, torch.int64])
    e = np.zeros(0, np.int64)
    mk("empty_state", 4096, 4096, (e, e), unique_pairs(rng, 1000, 99, 99),
       np.ones(1000), [torch.int64])
    mk("empty_delta", 4096, 4096, unique_pairs(rng, 1000, 99, 99), (e, e),
       e, [torch.int64])
    mk("needed>C", 4096, 4096, unique_pairs(rng, 3500, 10**6, 10**6),
       unique_pairs(rng, 3000, 10**6, 10**6), np.ones(3000), [torch.int64])
    mk("n=1", 1, 1, (np.array([5]), np.array([6])),
       (np.array([5]), np.array([6])), np.array([1]), [torch.int64])
    # the one-pass kernel's tiles: a side row and its delta twin across
    # every 2048-row tile edge of the merged order, C + B at four tiles and
    # one row either side (every slot live), all deletes, sign 0 and +2
    # only, an empty side and a delta of only EMPTY_KEY, truncation; f64 /
    # int32 / bool payloads
    t = RED_TILE

    def straddled(case, cap, b, n_side, n_delta, signs, p_pair=0.3):
        s_pairs, d_pairs = straddle_pairs(
            rng, straddle_items(rng, n_side, n_delta, p_pair))
        mk(case, cap, b, s_pairs, d_pairs,
           rng.choice(signs, len(d_pairs[0])), EDGE_DTYPES)
    straddled("straddle_C=2^20_B=2^18", 1 << 20, 1 << 18, (1 << 20) - 1000,
              (1 << 18) - 100, [-1, 0, 1, 2])
    for db in (-1, 0, 1):
        straddled(f"C+B=4x2048{db:+d}", 3 * t, t + db, 3 * t, t + db,
                  [1, 1, 1, -1])
    straddled("all_deletes", 1 << 16, 1 << 14, (1 << 16) - 50,
              (1 << 14) - 50, [-1])
    straddled("sign0_plus2", 1 << 16, 1 << 14, (1 << 16) - 50,
              (1 << 14) - 50, [0, 2])
    straddled("needed>C_straddle", 3 * t, t, 3 * t - 40, t - 30, [1],
              p_pair=0.05)
    straddled("empty_side_edge_dtypes", 3 * t, t, 0, t - 30, [1, 1, -1, 2])
    straddled("delta_all_empty_edge_dtypes", 3 * t, t, 3 * t - 40, 0, [1])
    return out


def probe_cases(rng, dev):
    """(case, side, qjk, qmask, m) for probe."""
    out = []

    def mk(case, side, qjk, qmask, m):
        out.append((case, side, _dev(qjk, dev), _dev(qmask, dev), m))

    q = 1 << 20
    # an epoch's bids probing the auction side (one match each)
    auctions = join_side(rng, 1 << 20, np.arange(500_000),
                         np.arange(500_000), [torch.int64] * 11, dev)
    mk("q3a_bids_x_auctions", auctions, rand_keys(rng, q, 0, 520_000),
       rng.random(q) < 0.92, 1 << 21)
    # new auctions probing the bid side (many matches each)
    big = join_side(rng, 1 << 22, rand_keys(rng, 3_000_000, 0, 1 << 19),
                    rng.permutation(3_000_000), [torch.int64], dev)
    qjk = rand_keys(rng, q, 0, 1 << 19)
    mk("total>m", big, qjk, rng.random(q) < 0.92, 1 << 16)
    jk = rand_keys(rng, 20_000, 0, 1000)
    jk[:5000] = 7                              # a hot key, 5000 matches
    hot = join_side(rng, 32768, jk, np.arange(20_000), [torch.int64], dev)
    qjk = rand_keys(rng, 65536, 0, 1000)
    qjk[rng.random(65536) < 0.003] = 7
    mk("hot_key_5000", hot, qjk, np.ones(65536, bool), 1 << 21)
    qjk = rand_keys(rng, 65536, 0, 1000)
    qjk[rng.random(65536) < 0.2] = EMPTY_KEY
    qm = rng.random(65536) < 0.8
    qm[-1] = False
    mk("masked_and_empty", hot, qjk, qm, 1 << 18)
    e = np.zeros(0, np.int64)
    mk("empty_side", join_side(rng, 4096, e, e, [torch.int64], dev),
       rand_keys(rng, 4096, 0, 10), np.ones(4096, bool), 4096)
    mk("q=1", hot, np.array([7]), np.ones(1, bool), 8192)
    # the main path's order: batch_reduce_rows' sorted jk, sign-0 rows
    # masked in place, EMPTY_KEY padding at the tail
    mk("sorted_bids_x_auctions", auctions, *brr_queries(rng, 960_000, q,
                                                        520_000), 1 << 21)
    mk("sorted_hot_key", hot, *brr_queries(rng, 60_000, 65536, 1000),
       1 << 21)
    mk("sorted_all_masked", auctions, brr_queries(rng, 5000, 8192,
                                                  520_000)[0],
       np.zeros(8192, bool), 4096)
    # pairs past 2^32: 2^16 queries of a key the side holds 2^17 times
    # (the 64-bit look-back; total exact), few slots
    eq = join_side(rng, 1 << 17, np.full(1 << 17, 5), np.arange(1 << 17),
                   [torch.int64], dev)
    mk("total>2^32", eq, np.full(1 << 16, 5), np.ones(1 << 16, bool),
       1 << 12)
    # q not a multiple of the 2048-query tile, m < q
    mk("q=100003,m<q", hot, rand_keys(rng, 100_003, 0, 1000),
       rng.random(100_003) < 0.9, 50_000)
    return out


def brr_queries(rng, n, q, hi, p_zero=0.1):
    """(qjk, qmask) in batch_reduce_rows' order: n keys sorted, a share
    p_zero of them masked in place (a net sign of 0), EMPTY_KEY padding
    to q."""
    qjk = np.full(q, EMPTY_KEY, np.int64)
    qjk[:n] = np.sort(rand_keys(rng, n, 0, hi))
    qmask = np.zeros(q, bool)
    qmask[:n] = rng.random(n) >= p_zero
    return qjk, qmask


def hop_cases(rng, dev):
    """(case, cols, time_col, hop, size, pk, sign, mask) for hop_expand:
    an epoch of the generator's bids (2^20 rows x 8 columns) under q5's
    HOP(2 s, 10 s) and q7's TUMBLE(10 s), and edge cases."""
    out = []
    n = EPOCH_EVENTS
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(0, n, dtype=torch.int64, device=dev)
    gen = gen_table(gencfg, "bid", ids)
    bid = [ids if nm == "_row_id" else gen[nm] for nm, _ in BID_COLS]
    one = torch.ones(n, dtype=torch.int32, device=dev)
    mask = table_mask("bid", ids)
    out.append(("q5_2^20x8_n=5", bid, 5, 2 * USEC, 10 * USEC, ids, one, mask))
    out.append(("q7_2^20x8_n=1", bid, 5, 10 * USEC, 10 * USEC, ids, one,
                mask))
    k = 4096
    ts = _dev(rng.integers(-10**8, 10**8, k), dev)
    ts[:4] = torch.tensor([0, -1, -7, 7])
    cols = [_dev(rng.integers(0, 100, k), dev), ts,
            payload(rng, k, torch.float64).to(dev),
            payload(rng, k, torch.int32).to(dev),
            payload(rng, k, torch.bool).to(dev)]
    sign = _dev(rng.choice([-1, 1], k).astype(np.int32), dev)
    m = _dev(rng.random(k) < 0.7, dev)
    out.append(("negative_ts_mixed_dtypes_n=3", cols, 1, 7, 21,
                _dev(rng.integers(-(1 << 62), 1 << 62, k), dev), sign, m))
    out.append(("pk_absent_n=5", cols, 1, 7, 35, None, sign, m))
    out.append(("n=1_row", [c[:1] for c in cols], 1, 5, 5, None, sign[:1],
                m[:1]))
    return out


def q5_pairs(rng, n, mask_p=0.6):
    """(k1, k2, delta, mask) rows like q5's retractable max input: packed
    window keys, per-(window, auction) counts, signs from a change
    stream (masked where a group did not change)."""
    return (rng.integers(0, 424, n), rng.integers(1, 60, n),
            rng.choice([-1, 1], n).astype(np.int64), rng.random(n) < mask_p)


def msbr_cases(rng, dev):
    """(case, k1, k2, delta, mask) for ms_batch_reduce."""
    out = []

    def mk(case, k1, k2, d, m):
        out.append((case,) + tuple(_dev(np.asarray(x), dev)
                                   for x in (k1, k2, d, m)))
    mk("q5_2^21", *q5_pairs(rng, 1 << 21))
    mk("all_masked", *q5_pairs(rng, 4096, mask_p=0.0))
    k1, k2 = unique_pairs(rng, 30_000, 500, 500)
    mk("cancelling", np.repeat(k1, 2), np.repeat(k2, 2),
       np.tile(np.array([1, -1], np.int64), len(k1)),
       np.ones(2 * len(k1), bool))
    k1, k2, d, m = q5_pairs(rng, 65536)
    k1[rng.random(65536) < 0.05] = EMPTY_KEY
    mk("empty_k1_unmasked", k1, k2, d, m)
    mk("n=1", np.array([3]), np.array([-7]), np.array([-1]),
       np.ones(1, bool))
    # the reduce's tiles (RED_TILE sorted rows): one pair over 2^20 + 3
    # rows (a segment across 513 tiles: the carry's in-order trees), pair
    # boundaries at each tile edge and one row either side (unmasked,
    # with masked rows moving them, and with EMPTY_KEY k1 beside a live
    # k2), deltas whose sums wrap int64, and fewer rows than a tile
    n = (1 << 20) + 3
    mk("one_pair_2^20+3", np.full(n, 5), np.full(n, -9),
       rng.choice([-1, 1, 2], n).astype(np.int64), np.ones(n, bool))
    k1, k2 = pair_runs(rng, [RED_TILE * i + e for i in range(1, 9)
                             for e in (-1, 0, 1)] + [12 * RED_TILE])
    d = rng.choice([-1, 1], len(k1)).astype(np.int64)
    mk("pair_tile_edges", k1, k2, d, np.ones(len(k1), bool))
    mk("pair_tile_edges_masked", k1, k2, d, rng.random(len(k1)) < 0.9)
    mk("empty_k1_at_tile_edges", np.where(k1 >= 8, EMPTY_KEY, k1), k2, d,
       rng.random(len(k1)) < 0.95)
    k1, k2, _, m = q5_pairs(rng, 1 << 18)
    mk("wrapping_deltas", k1, k2,
       rng.integers(1 << 61, (1 << 63) - 1, 1 << 18, dtype=np.int64), m)
    mk("n=1000", *q5_pairs(rng, 1000))
    return out


def pair_runs(rng, bounds):
    """Shuffled (k1, k2) rows whose (k1, k2)-sorted runs end at `bounds`
    (exclusive ends): run i holds the pair (i // 3, 5 (i % 3) - 4)."""
    lens = np.diff(np.concatenate([[0], bounds]))
    run = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    order = rng.permutation(len(run))
    return run[order] // 3, (run[order] % 3) * 5 - 4


def multiset(rng, cap, k1, k2, cnt, dev):
    """A SortedMultiset of capacity `cap` holding the (k1, k2) pairs."""
    order = np.lexsort((k2, k1))
    n = len(order)
    a1 = np.full(cap, EMPTY_KEY, np.int64)
    a2 = np.full(cap, EMPTY_KEY, np.int64)
    ac = np.zeros(cap, np.int64)
    a1[:n], a2[:n] = np.asarray(k1)[order], np.asarray(k2)[order]
    ac[:n] = np.asarray(cnt)[order]
    return SortedMultiset(_dev(a1, dev), _dev(a2, dev),
                          torch.tensor(n, dtype=torch.int32, device=dev),
                          _dev(ac, dev))


def msm_edge_arrays(rng):
    """(case, capacity, (k1, k2, count) of the multiset, (k1, k2, delta,
    mask) delta rows) numpy inputs of ms_merge's tile edges: a multiset
    pair and its delta twin across every 2048-row tile edge of the merged
    order (`straddle_items`), those twins dying (a delta of minus the
    count) or going below 0, truncation with pairs across the edges, every
    pair dying, and a delta of only masked rows (all EMPTY_KEY)."""
    t = RED_TILE
    out = []

    def straddled(case, cap, n_ms, n_delta, p_pair, twin):
        kinds = straddle_items(rng, n_ms, n_delta, p_pair)
        (s1, s2), (d1, d2) = straddle_pairs(rng, kinds)
        cnt = rng.integers(1, 5, len(s1))
        # a delta twin's count from its multiset pair's (`twin`), a lone
        # delta pair's at random
        pos = np.cumsum(kinds != "d") - 1
        pair = kinds[kinds != "s"] == "p"
        own = pos[kinds != "s"][pair]
        delta = rng.choice(np.array([-1, 1, 2]), len(d1))
        delta[pair] = twin(cnt[own])
        out.append((case, cap, (s1, s2, cnt),
                    (d1, d2, delta.astype(np.int64), np.ones(len(d1), bool))))
    straddled("straddle_tile_edges", 3 * t, 3 * t - 40, t - 30, 0.3,
              lambda c: rng.choice(np.array([-1, 1, 3]), len(c)))
    straddled("straddle_twins_die", 3 * t, 3 * t - 40, t - 30, 0.3,
              lambda c: -c)
    straddled("straddle_below_zero", 3 * t, 3 * t - 40, t - 30, 0.3,
              lambda c: -c - 1)
    straddled("needed>C_straddle", 2 * t, 2 * t - 10, 2 * t - 10, 0.05,
              lambda c: c)
    s1, s2 = unique_pairs(rng, 3000, 200, 200)
    cnt = rng.integers(1, 9, 3000)
    out.append(("every_pair_dies", 4096, (s1, s2, cnt),
                (s1, s2, -cnt, np.ones(3000, bool))))
    out.append(("delta_all_masked", 4096, (s1, s2, cnt),
                (s1, s2, cnt, np.zeros(3000, bool))))
    return out


def msm_cases(rng, dev):
    """(case, multiset, u1, u2, ud) for ms_merge, the deltas in
    ms_batch_reduce's order (made by its plain version)."""
    out = []

    def mk(case, ms, rows):
        u = K.ms_batch_reduce_plain(*(_dev(np.asarray(x), dev)
                                      for x in rows))
        out.append((case, ms) + tuple(u))
    s1, s2 = unique_pairs(rng, 12_000, 424, 60)
    cnt = rng.integers(1, 40, len(s1))
    q5_ms = multiset(rng, 1 << 14, s1, s2, cnt, dev)
    mk("q5_C=2^14_B=2^21", q5_ms, q5_pairs(rng, 1 << 21))
    small = unique_pairs(rng, 3000, 100, 100)
    sc = rng.integers(1, 3, 3000)
    ms = multiset(rng, 4096, *small, sc, dev)
    mk("retract_all_to_0", ms, (np.repeat(small[0], sc),
                                np.repeat(small[1], sc),
                                -np.ones(int(sc.sum()), np.int64),
                                np.ones(int(sc.sum()), bool)))
    mk("needed>C", ms, (rng.integers(200, 400, 4000),
                        rng.integers(0, 1000, 4000),
                        np.ones(4000, np.int64), np.ones(4000, bool)))
    z1 = np.concatenate([small[0][:1000], rng.integers(500, 600, 500)])
    z2 = np.concatenate([small[1][:1000], rng.integers(0, 50, 500)])
    mk("zero_count_deltas", ms, (np.repeat(z1, 2), np.repeat(z2, 2),
                                 np.tile(np.array([1, -1], np.int64),
                                         len(z1)),
                                 np.ones(2 * len(z1), bool)))
    mk("below_zero", ms, (np.repeat(small[0][:50], 5),
                          np.repeat(small[1][:50], 5),
                          -np.ones(250, np.int64), np.ones(250, bool)))
    e = np.zeros(0, np.int64)
    mk("empty_multiset", multiset(rng, 4096, e, e, e, dev),
       q5_pairs(rng, 8192))
    mk("C=1", multiset(rng, 1, [5], [6], [1], dev),
       (np.array([5, 5, 7]), np.array([6, 6, 1]), np.array([1, -1, 1]),
        np.ones(3, bool)))
    for case, cap, ms_rows, rows in msm_edge_arrays(rng):
        mk(case, multiset(rng, cap, *ms_rows, dev), rows)
    return out


def msf_cases(rng, dev):
    """(case, multiset, q1, q2) for ms_find: q5's multiset and queries,
    and capacities 1, 2, 3 (every slot live)."""
    out = []
    s1, s2 = unique_pairs(rng, 12_000, 424, 60)
    ms = multiset(rng, 1 << 14, s1, s2, rng.integers(1, 40, len(s1)), dev)
    q1, q2, _, m = q5_pairs(rng, 1 << 21)
    q1[~m] = EMPTY_KEY
    out.append(("q5_C=2^14_Q=2^21", ms, _dev(q1, dev), _dev(q2, dev)))
    for c in (1, 2, 3):
        k1, k2 = unique_pairs(rng, c, 4, 4)
        ms = multiset(rng, c, k1, k2, rng.integers(-2, 5, c), dev)
        q1 = np.concatenate([k1, rng.integers(-1, 6, 64), [EMPTY_KEY]])
        q2 = np.concatenate([k2, rng.integers(-1, 6, 64), [0]])
        out.append((f"C={c}", ms, _dev(q1, dev), _dev(q2, dev)))
    return out


MSF_SAMPLES = 2047     # pairs ms_find stages a block (multiset_runs.cu)
MSF_Q = 4              # queries a thread of ms_find


def msf_edge_arrays(rng):
    """(case, capacity, (k1, k2, count) of the multiset, q1, q2, (o1, o2))
    numpy inputs at ms_find's edges, (o1, o2) the query columns' offsets
    in 8-byte elements when they are laid out as views: capacities 1, 2,
    3, MSF_SAMPLES - 1 .. + 1 (the edges of its sample), 2^14 and 2^20,
    each with the pairs it holds (one with an EMPTY_KEY k2), pairs it
    lacks, pairs below and above every pair, EMPTY q1, and live q1 with
    EMPTY q2, in random order, q not a multiple of MSF_Q; all queries
    EMPTY; sorted unique queries with an EMPTY tail (the main path's
    order); queries at odd 8-byte offsets."""
    out = []

    def held(cap):
        live = cap if cap <= MSF_SAMPLES + 1 else cap - cap // 10
        hi1 = max(4, live // 8)
        k1, k2 = unique_pairs(rng, live, hi1, 64)
        if live > 1:
            k2[0] = EMPTY_KEY      # queried below: k1[:3] with EMPTY q2
        return (k1, k2, rng.integers(-3, 50, live)), hi1

    def queries(pairs, hi1, rem):
        """Shuffled queries, as many as the pieces give that leave `rem`
        over a multiple of MSF_Q."""
        k1, k2 = pairs[0], pairs[1]
        take = rng.permutation(len(k1))[:min(len(k1), 1 << 17)]
        m = min(len(k1), 1 << 16) + 8
        q1 = np.concatenate([k1[take], rng.integers(-2, hi1 + 3, m),
                             [-5, -(1 << 40), hi1 + 10, 1 << 50],
                             np.full(m // 4 + 3, EMPTY_KEY), k1[:3]])
        q2 = np.concatenate([k2[take], rng.integers(-2, 66, m),
                             [0, 7, 0, -(1 << 50)],
                             rng.integers(-2, 66, m // 4 + 3),
                             np.full(min(3, len(k1)), EMPTY_KEY)])
        q = len(q1) - (len(q1) - rem) % MSF_Q
        order = rng.permutation(len(q1))[:q]
        return q1[order].astype(np.int64), q2[order].astype(np.int64)

    for cap in (1, 2, 3, MSF_SAMPLES - 1, MSF_SAMPLES, MSF_SAMPLES + 1,
                1 << 14, 1 << 20):
        pairs, hi1 = held(cap)
        q1, q2 = queries(pairs, hi1, 1 + cap % 3)
        out.append((f"C={cap}", cap, pairs, q1, q2, (0, 0)))
    pairs, hi1 = held(1 << 14)
    q2 = rng.integers(0, 64, 5003)
    out.append(("all_empty", 1 << 14, pairs,
                np.full(5003, EMPTY_KEY, np.int64), q2, (0, 0)))
    # the main path's order: the reduced delta's unique pairs, ascending,
    # then its EMPTY tail
    pairs, hi1 = held(1 << 16)
    q1, q2 = queries(pairs, hi1, 0)
    live = q1 != EMPTY_KEY
    u = np.unique(np.stack([q1[live], q2[live]], 1), axis=0)
    tail = (1 << 20) + 2 - len(u)
    out.append(("sorted_empty_tail", 1 << 16, pairs,
                np.concatenate([u[:, 0], np.full(tail, EMPTY_KEY)]),
                np.concatenate([u[:, 1], np.full(tail, EMPTY_KEY)]),
                (0, 0)))
    pairs, hi1 = held(1 << 14)
    q1, q2 = queries(pairs, hi1, 3)
    out.append(("odd_offsets", 1 << 14, pairs, q1, q2, (1, 1)))
    out.append(("odd_q2_offset", 1 << 14, pairs, q1, q2, (0, 1)))
    return out


def offset_view(a, off, dev):
    """`a` on `dev` as a view `off` elements into a larger tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.empty(t.shape[0] + off, dtype=t.dtype, device=dev)
    buf[off:] = t.to(dev)
    return buf[off:]


def msf_edge_cases(rng, dev):
    """(case, multiset, q1, q2) of `msf_edge_arrays` on `dev`."""
    return [(case, multiset(rng, cap, *pairs, dev), offset_view(q1, o1, dev),
             offset_view(q2, o2, dev))
            for case, cap, pairs, q1, q2, (o1, o2) in msf_edge_arrays(rng)]


def one_bucket_keys(rng, n, bucket=3):
    """n keys whose vnodes all fall in one telemetry bucket."""
    pool = np.arange(1 << 18, dtype=np.int64)
    pool = pool[vnodes_i64_plain(pool) * SK_BUCKETS // 256 == bucket]
    return rng.choice(pool, n)


def vh_cases(rng, dev):
    """(case, keys, live, weights, out) for vnode_hist: an agg's key table
    (occupancy) at 2^23, an epoch's input at 2^20 (traffic, weighted),
    and edge cases; `out` is the histogram added into (None: zeros)."""
    out = []

    def mk(case, keys, live=None, weights=None, into=None):
        out.append((case, _dev(keys, dev),
                    None if live is None else _dev(live, dev),
                    None if weights is None else _dev(weights, dev),
                    None if into is None else _dev(into, dev)))
    c = 1 << 23
    table = np.full(c, EMPTY_KEY, np.int64)
    table[: 5_000_000] = np.sort(rand_keys(rng, 5_000_000, 0, 1 << 48))
    mk("occupancy_C=2^23", table)
    n = EPOCH_EVENTS
    k = rand_keys(rng, n, 0, 1 << 40)
    mk("traffic_2^20", k, rng.random(n) < 0.3)
    mk("weighted_2^20", k, rng.random(n) < 0.9,
       rng.integers(0, 1 << 20, n).astype(np.int64))
    mk("all_masked", k[:4096], np.zeros(4096, bool))
    mk("all_empty", np.full(4096, EMPTY_KEY, np.int64))
    mk("n=3", np.array([5, -5, EMPTY_KEY], np.int64))
    mk("n=0", np.zeros(0, np.int64))
    mk("negative_keys", rand_keys(rng, 65536, np.iinfo(np.int64).min, 0),
       rng.random(65536) < 0.8)
    mk("one_bucket", one_bucket_keys(rng, 65536))
    mk("weights_above_2^32", k[:65536], np.ones(65536, bool),
       rng.integers(1 << 33, 1 << 40, 65536).astype(np.int64))
    mk("added_into_out", k[:65536], None, None,
       rng.integers(0, 1000, SK_BUCKETS).astype(np.int64))
    return out


def vhs_cases(rng, dev):
    """(case, segments, rows) for vnode_hists, a keyed node's one call:
    a join's two key tables into one occupancy row plus its epoch's
    traffic, an agg's table plus its weighted (pre-combined) traffic,
    each with an n = 0 segment among them."""
    def seg(keys, live=None, weights=None, row=0):
        return (_dev(keys, dev), None if live is None else _dev(live, dev),
                None if weights is None else _dev(weights, dev), row)
    n = EPOCH_EVENTS
    ta = np.full(1 << 22, EMPTY_KEY, np.int64)
    ta[:3_000_000] = np.sort(rand_keys(rng, 3_000_000, 0, 1 << 48))
    tb = np.full(1 << 21, EMPTY_KEY, np.int64)
    tb[:900_000] = np.sort(rand_keys(rng, 900_000, 0, 1 << 48))
    k = rand_keys(rng, 2 * n, 0, 1 << 40)
    e = np.zeros(0, np.int64)
    return [
        ("join_3_segments", [seg(ta), seg(tb), seg(k, rng.random(2 * n)
                                                   < 0.9, row=1)], 2),
        ("join_with_n=0", [seg(ta), seg(e), seg(k, rng.random(2 * n)
                                                < 0.5, row=1)], 2),
        ("agg_2_segments", [seg(tb), seg(k[:n], rng.random(n) < 0.9,
                                         rng.integers(0, 1 << 20, n),
                                         row=1)], 2),
        ("agg_with_n=0", [seg(e), seg(k[:n], rng.random(n) < 0.9,
                                      rng.integers(1 << 33, 1 << 40, n),
                                      row=1)], 2),
        ("4_segments_3_rows", [seg(k[:4097]), seg(e, row=2),
                               seg(k[1:n + 1], rng.random(n) < 0.3, row=2),
                               seg(tb[::2].copy(), row=0)], 3),
    ]


def tk_cases(rng, dev):
    """(case, keys, counts) for topk_packed: weighted mode on (key, count)
    rows as a pre-combine emits them, runs mode (counts None) on sorted
    keys with EMPTY_KEY at the tail, at the main paths' shapes and on edge
    cases."""
    out = []

    def mk(case, keys, counts=None):
        out.append((case, _dev(keys, dev),
                    None if counts is None else _dev(counts, dev)))

    def runs(keys, live):
        return np.sort(np.where(live, keys, EMPTY_KEY))
    n = EPOCH_EVENTS
    uk = np.full(n, EMPTY_KEY, np.int64)
    u = sorted_unique(rng, 300_000, 0, 1 << 45)
    uk[: len(u)] = u
    cnt = np.zeros(n, np.int64)
    cnt[: len(u)] = rng.integers(1, 40, len(u))
    mk("weighted_2^20", uk, cnt)
    k = rand_keys(rng, 2 * n, 0, 1 << 30)
    mk("runs_join_2^21", runs(k, rng.random(2 * n) < 0.3))
    k = rand_keys(rng, 10_485_760, 0, 57)
    mk("runs_q5_max_agg_10485760", runs(k, rng.random(10_485_760) < 0.125))
    mk("weighted_all_zero_counts", uk[:4096], np.zeros(4096, np.int64))
    mk("runs_all_masked", np.full(4096, EMPTY_KEY, np.int64))
    mk("weighted_all_empty", np.full(4096, EMPTY_KEY, np.int64),
       np.ones(4096, np.int64))
    for m in (0, 1, 3):
        mk(f"weighted_n={m}", rand_keys(rng, m, 0, 9),
           rng.integers(-1, 5, m).astype(np.int64))
        mk(f"runs_n={m}", np.sort(rand_keys(rng, m, 0, 2)))
    neg = rand_keys(rng, 65536, np.iinfo(np.int64).min, -(1 << 50))
    mk("weighted_negative_keys", neg, rng.integers(-3, 60, 65536))
    mk("runs_negative_keys", np.sort(np.concatenate([neg[:1000]] * 7)))
    big = np.array([3, 4, 5, 6, 7], np.int64)
    mk("weighted_count>max", big, np.array([SK_COUNT_MAX + 1, 1 << 40,
                                            SK_COUNT_MAX, 2, 1 << 23]))
    hot = np.concatenate([np.full(SK_COUNT_MAX + 100, 42, np.int64),
                          np.arange(100, dtype=np.int64)])
    mk("runs_count>max_one_hot_key", np.sort(hot))
    same = (np.arange(8, dtype=np.int64) << 40) + 99     # equal low 40 bits
    mk("weighted_equal_packed_values", same, np.full(8, 7, np.int64))
    mk("runs_equal_packed_values", np.sort(np.repeat(same, 7)))
    for case, keys, counts in tk_edge_arrays(rng):
        mk(case, keys, counts)
    # rows not 16-byte aligned (the scalar loads): views one row into
    # their buffers
    for case, keys, counts in out[:3]:
        out.append((case + "_unaligned", keys.new_empty(
            keys.shape[0] + 1)[1:].copy_(keys),
            None if counts is None else counts.new_empty(
                counts.shape[0] + 1)[1:].copy_(counts)))
    return out


def run_keys(n, runs, empty_from=None, lo=-(1 << 41)):
    """n sorted int64 keys: one key for each (start, length) of `runs`,
    a key of its own on every other row, EMPTY_KEY from row `empty_from`
    on."""
    head = np.ones(n, bool)
    for start, length in runs:
        head[start + 1:start + length] = False
    keys = lo + 3 * np.cumsum(head, dtype=np.int64)
    if empty_from is not None:
        keys[empty_from:] = EMPTY_KEY
    return keys


TOPK_CLIP_RUN = (1 << 22) + 3       # one run past the count clip


def tk_edge_arrays(rng):
    """(case, keys, counts or None) numpy inputs of topk_packed's edges:
    in runs mode, runs of distinct lengths (so the top 4 hold each)
    crossing a thread's 8-row edge, a warp's 256-row edge and a tile's
    2048-row edge, a run exactly a tile long (aligned and not), one
    crossing two tile edges, one reaching the last row, the EMPTY tail
    starting at a tile edge and inside a thread's rows, one run over the
    whole input, one past the count clip (TOPK_CLIP_RUN rows), singletons
    only; both modes at n = 1 .. 7; weighted rows with counts <= 0 and an
    odd row count."""
    out = [
        ("runs_cross_thread_edges",
         run_keys(200, [(6, 3), (15, 10), (30, 4), (100, 5)]), None),
        ("runs_cross_warp_edges",
         run_keys(1100, [(250, 12), (500, 20), (767, 2), (1020, 30)]),
         None),
        ("runs_cross_tile_edges",
         run_keys(10_000, [(2040, 16), (4090, 9), (6143, 2), (8100, 200)]),
         None),
        ("runs_one_tile_long",
         run_keys(12_000, [(2048, 2048), (5000, 2048), (9000, 7),
                           (11_990, 10)]), None),
        ("runs_across_three_tiles",
         run_keys(9000, [(100, 6000), (7000, 3)]), None),
        ("runs_to_last_row",
         run_keys(4099, [(10, 50), (2047, 3), (4000, 99)]), None),
        ("runs_empty_from_tile_edge",
         run_keys(6000, [(10, 4), (2000, 48)], empty_from=2048), None),
        ("runs_empty_inside_a_thread",
         run_keys(6000, [(7, 2), (2030, 15)], empty_from=2045), None),
        ("runs_one_run", run_keys(5000, [(0, 5000)]), None),
        ("runs_singletons", run_keys(1 << 13, [], empty_from=5000), None),
        ("runs_past_count_clip",
         run_keys(TOPK_CLIP_RUN + 7, [(2, TOPK_CLIP_RUN), (TOPK_CLIP_RUN + 3,
                                                          4)]), None),
    ]
    for m in range(1, 8):
        out.append((f"runs_n={m}", np.sort(rand_keys(rng, m, -2, 2)), None))
        out.append((f"weighted_n={m}", rand_keys(rng, m, -3, 9),
                    rng.integers(-2, 4, m).astype(np.int64)))
    k = rand_keys(rng, 4097, -(1 << 45), 1 << 45)
    out.append(("weighted_counts<=0", k, -rng.integers(0, 5, 4097)))
    out.append(("weighted_odd_n", k, rng.integers(-1, 40, 4097)))
    return out


def check_topk_state(dev, cases) -> None:
    """topk_packed's persistent state after its cases: the ticket word is
    zero; at each of `cases`' shapes, 20 calls captured in one CUDA graph
    and replayed each give one eager call's `out`, the ticket zero again;
    one call makes one CUDA launch and no memset or copy."""
    state, _ = K.binding.topk_state(dev)

    def ticket_zero(when):
        torch.cuda.synchronize()
        if int(state[0]) != 0:
            raise AssertionError(f"topk_packed: ticket word {int(state[0])}"
                                 f" after {when}")
    ticket_zero("its cases")
    for case, keys, counts in cases:
        want = K.topk_packed(keys, counts)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs = [K.topk_packed(keys, counts) for _ in range(20)]
        g.replay()
        ticket_zero(f"{case}'s graph replay")
        for i, o in enumerate(outs):
            compare("topk_packed", f"{case} graph replay, call {i}", o, want)
        launches = topk_launches(keys, counts)
        if launches != 1:
            raise AssertionError(f"topk_packed/{case}: {launches} CUDA "
                                 "launches a call")
    log(f"[kernels] topk_packed: ticket zero after every case and graph "
        f"replay, 1 CUDA launch a call")


def topk_launches(keys, counts) -> int:
    """CUDA launches of one topk_packed call (memsets and copies count),
    by the profiler."""
    return sum(cuda_launches_of(lambda: K.topk_packed(keys, counts))
               .values())


def sorted_keys(n, live, hi, dev, dups=False):
    """n sorted int64 keys, the first `live` drawn from [0, hi) (unique
    unless `dups`), EMPTY_KEY after them."""
    if dups:
        k = torch.randint(0, hi, (live,), device=dev)
    else:
        k = torch.unique(torch.randint(0, hi, (2 * live + 64,), device=dev))
        k = k[torch.randperm(k.shape[0], device=dev)[:live]]
        if k.shape[0] != live:
            raise ValueError(f"{live} unique keys below {hi}: too dense")
    out = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=dev)
    out[:live] = torch.sort(k).values
    return out


def q8_touch_shape(dev):
    """touch_stamp's inputs at a q8 distinct's shape: C = 2^22 (2,825,318
    groups), 2.7M of them before the merge, T = 2^20 (600,000 touched)."""
    q8 = sorted_keys(1 << 22, 2_825_318, 1 << 40, dev)
    q8old = q8.clone()
    q8old[2_700_000:] = EMPTY_KEY
    return q8, q8old, sorted_keys(1 << 20, 600_000, 1 << 40, dev)


def ts_cases(rng, dev):
    """(case, keys, old keys, old touch, touched keys, promoted touch or
    None, tick) for touch_stamp: the main paths' shapes (q3a's bid side
    untiered, C = 2^23 with join keys repeating, T = 2 x 2^20; a q8
    distinct, C = 2^22) and the edges of its merge path (tiles of
    RED_TILE merged rows of the new and old keys, and of the new and
    touched keys): runs of equal keys straddling tile edges in all three
    runs, an old run across tiles whose first row carries, many deleted
    old keys between two new ones, no old rows, no touched keys, and
    stamps exactly TIER_TTL old."""
    torch.manual_seed(int(rng.integers(1 << 30)))
    tick = torch.tensor(9, dtype=torch.int64, device=dev)

    def touch(keys, lo=0, hi=10):
        t = torch.randint(lo, hi, keys.shape, device=dev)
        return torch.where(keys != EMPTY_KEY, t, 0)
    c = 1 << 23
    new = sorted_keys(c, 7_700_000, 480_000, dev, dups=True)
    old = new.clone()
    old[7_600_000:] = EMPTY_KEY
    tk = sorted_keys(1 << 21, 1_930_000, 500_000, dev, dups=True)
    yield "q3a_bid_side", new, old, touch(old), tk, None, tick
    yield "q3a_bid_side_promote", new, old, touch(old), tk, touch(tk), tick
    q8, q8old, q8t = q8_touch_shape(dev)
    yield "q8_distinct", q8, q8old, touch(q8old), q8t, None, tick
    e = torch.full((4096,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "all_empty", e, e, torch.zeros_like(e), e[:256], None, tick
    small = sorted_keys(4096, 3000, 1 << 20, dev)
    yield "grown", small, small[:2048].clone(), touch(small[:2048]), \
        small[::3].contiguous(), None, tick
    dup = sorted_keys(4096, 4000, 300, dev, dups=True)
    dold = sorted_keys(4096, 3500, 300, dev, dups=True)
    yield "join_dups", dup, dold, touch(dold), dup[::5].contiguous(), \
        touch(dup[::5]), tick
    for tk_ in (3, 4, 5, 12):
        t = torch.tensor(tk_, dtype=torch.int64, device=dev)
        yield f"tick{tk_}", small, small, touch(small, max(0, tk_ - 5),
                                                 tk_ + 1), \
            small[::7].contiguous(), None, t
    one = sorted_keys(1, 1, 10, dev)
    yield "one_row", one, one, touch(one), one, None, tick
    # runs of ~1.5K equal keys in all three runs, across every kind of
    # tile edge; both modes
    rk = sorted_keys(65536, 60_000, 40, dev, dups=True)
    ro = sorted_keys(65536, 50_000, 44, dev, dups=True)
    rs = pad_keys(torch.sort(torch.randint(0, 20, (30_000,), device=dev)
                             * 2).values, 32768, dev)   # half the keys
    yield "straddling_runs", rk, ro, touch(ro), rs, None, tick
    yield "straddling_runs_promote", rk, ro, touch(ro), rs, touch(rs), tick
    # an old run of 10,000 rows (each its own stamp) across five tiles,
    # 3,000 new rows of its key before it in the merged order
    ok_ = torch.cat([torch.arange(3000, device=dev) * 2,
                     torch.full((10_000,), 7001, device=dev),
                     torch.arange(3000, device=dev) * 2 + 8000])
    nk = torch.cat([torch.arange(1500, device=dev) * 4,
                    torch.full((3000,), 7001, device=dev),
                    torch.arange(2000, device=dev) * 3 + 8000])
    ok_, nk = pad_keys(ok_, 16384, dev), pad_keys(nk, 8192, dev)
    yield "old_run_across_tiles", nk, ok_, touch(ok_), nk[::11].contiguous(),\
        None, tick
    yield "old_run_across_tiles_promote", nk, ok_, touch(ok_), \
        nk[::11].contiguous(), touch(nk[::11]), tick
    # 200,000 old keys deleted between new ones: tiles of old rows only
    dk = pad_keys(torch.cat([torch.arange(50, device=dev) * 20_000,
                             torch.arange(100_000, device=dev)
                             + (1 << 30)]), 1 << 17, dev)
    dold = sorted_keys(1 << 18, 200_000, 1 << 20, dev)
    yield "deleted_old_keys", dk, dold, touch(dold), dk[::7].contiguous(), \
        None, tick
    none = torch.empty(0, dtype=torch.int64, device=dev)
    yield "n_old=0", small, none, none, small[::3].contiguous(), None, tick
    yield "n_old=0_promote", small, none, none, small[::3].contiguous(), \
        touch(small[::3]), tick
    e = torch.full((4096,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "touched_all_empty", small, small, touch(small), e, None, tick
    yield "touched_all_empty_promote", small, small[:2048].clone(), \
        touch(small[:2048]), e, torch.zeros_like(e), tick
    yield "n_touched=0", small, small, touch(small), none, None, tick
    # every carried stamp tick - TIER_TTL (cold) or one newer (not)
    at = torch.where(small != EMPTY_KEY, tick - TIER_TTL
                     + torch.randint(0, 2, small.shape, device=dev), 0)
    yield "age_at_ttl", small, small, at, small[::9].contiguous(), None, tick


def pad_keys(keys, n, dev):
    """`keys` (sorted int64) then EMPTY_KEY up to n rows."""
    out = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=dev)
    out[:keys.shape[0]] = keys
    return out


def tp_cases(rng, dev):
    """(case, keys, cols, fills, dkeys, hits) for tier_partition: a q3a
    bid side at the tiered clamp (2^21 rows x 11 columns, a demotion of
    2^17 keys, hits kept), an agg table with neutral fills, and the
    edges."""
    torch.manual_seed(int(rng.integers(1 << 30)))
    n = 1 << 21
    jk = sorted_keys(n, 1_800_000, 120_000, dev, dups=True)
    pk = torch.randint(0, 1 << 40, (n,), device=dev)
    cols = [jk, pk] + [torch.randint(-1 << 40, 1 << 40, (n,), device=dev)
                       for _ in range(8)] + [torch.randint(0, 99, (n,),
                                                           device=dev)]
    fills = [EMPTY_KEY, EMPTY_KEY] + [0] * 9
    live = jk[jk != EMPTY_KEY]
    dk = torch.full((1 << 17,), EMPTY_KEY, dtype=torch.int64, device=dev)
    pick = torch.unique(live[torch.randint(0, live.shape[0], (90_000,),
                                           device=dev)])
    dk[:pick.shape[0]] = pick
    yield "q3a_bid_side", jk, cols, fills, dk, True
    m = 1 << 14
    ak = sorted_keys(m, 13_000, 1 << 30, dev)
    acols = [ak, torch.randint(1, 99, (m,), device=dev),
             torch.rand(m, device=dev, dtype=torch.float64),
             torch.randint(0, 2, (m,), device=dev).bool(),
             torch.randint(0, 9, (m,), device=dev, dtype=torch.int32),
             torch.randint(0, 20, (m,), device=dev)]
    afills = [EMPTY_KEY, 0, float("inf"), False, -(1 << 31), 0]
    akl = ak[ak != EMPTY_KEY]
    adk = torch.full((4096,), EMPTY_KEY, dtype=torch.int64, device=dev)
    adk[:3000] = akl[torch.randperm(akl.shape[0], device=dev)[:3000]
                     ].sort().values
    yield "agg", ak, acols, afills, adk, False
    none = torch.full((64,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "no_dkeys", ak, acols, afills, none, True
    every = torch.full((m,), EMPTY_KEY, dtype=torch.int64, device=dev)
    every[:akl.shape[0]] = akl
    yield "every_row", ak, acols, afills, every, True
    e = torch.full((1024,), EMPTY_KEY, dtype=torch.int64, device=dev)
    yield "all_empty", e, [e, e.clone()], [EMPTY_KEY, 0], adk, True
    yield "join_dups", jk[:4096].contiguous(), [c[:4096].contiguous()
                                                for c in cols], fills, \
        torch.unique(jk[:4096:9]).contiguous(), True


def hop_leaves(r):
    cols, pk, sign, mask = r
    return list(cols) + ([] if pk is None else [pk]) + [sign, mask]


# ---- expr_eval: seeded typed programs, every opcode --------------------

EXPR_ROWS = 1 << 20
EXPR_TYPES = ("bool", "int16", "int32", "int64", "float32", "float64")
EXPR_DT = {"bool": T.BOOLEAN, "int16": T.INT16, "int32": T.INT32,
           "int64": T.INT64, "float32": T.FLOAT32, "float64": T.FLOAT64,
           "date": T.DATE, "timestamp": T.TIMESTAMP}
EXPR_NP = {"bool": np.bool_, "int16": np.int16, "int32": np.int32,
           "int64": np.int64, "float32": np.float32, "float64": np.float64,
           "date": np.int32, "timestamp": np.int64}
# the two columns of each type, then a date and a timestamp column
EXPR_COLS = [t for t in EXPR_TYPES for _ in range(2)] + ["date", "timestamp"]


def expr_edges(t):
    """A type's edge values: INT_MIN, -1, 0, INT_MAX (traps 2-3); NaN,
    +-inf, +-2^63, -0.0 and halves (traps 4-5)."""
    dt = EXPR_NP[t]
    if t == "bool":
        return np.array([True, False])
    if np.issubdtype(dt, np.integer):
        i = np.iinfo(dt)
        return np.array([i.min, i.min + 1, -2, -1, 0, 1, 2, i.max - 1,
                         i.max], dt)
    return np.array([np.nan, np.inf, -np.inf, 2.0 ** 63, -2.0 ** 63, 0.0,
                     -0.0, 0.5, -0.5, 1.5, 2.5, -2.5, 1.0, -1.0,
                     np.finfo(dt).max, -np.finfo(dt).max,
                     2.0 ** 31 + 0.5, 32767.5], np.float64).astype(dt)


def expr_columns(rng, n, dev):
    """EXPR_COLS as tensors of n rows: every pairing of the two columns'
    edge values first (each operand position), then random values, half
    of them small so integer divisors hit 0."""
    out = []
    for k, t in enumerate(EXPR_COLS):
        dt = EXPR_NP[t]
        if t == "bool":
            v = rng.random(n) < 0.5
        elif np.issubdtype(dt, np.integer):
            i = np.iinfo(dt)
            v = rng.integers(i.min, i.max, n, endpoint=True,
                             dtype=np.int64).astype(dt)
            v[::2] = rng.integers(-3, 4, (n + 1) // 2).astype(dt)
        else:
            v = rng.normal(0, 1000, n).astype(dt)
            v[::3] = rng.integers(-4, 5, (n + 2) // 3).astype(dt)
        if t == "timestamp":
            v[::2] = rng.integers(-10 ** 15, 10 ** 15, (n + 1) // 2)
        e = expr_edges(t)
        m = len(e) * len(e)
        v[:m] = np.repeat(e, len(e)) if k % 2 == 0 else np.tile(e, len(e))
        out.append(torch.from_numpy(v).to(dev))
    return out


def _col(t, which=0):
    return InputRef(EXPR_COLS.index(t) + which, EXPR_DT[t])


def _nullable(t, which=0):
    """Column t made NULL where a bool column is false (a CASE, no ELSE)."""
    return F_Case([(_col("bool", 1 - which), _col(t, which))], None,
                  EXPR_DT[t])


def expr_fixed_trees():
    """Every opcode at every type it takes: (name, tree)."""
    out = []
    num = ("int16", "int32", "int64", "float32", "float64")
    for t in num:
        for op in ("add", "subtract", "multiply", "divide", "modulus"):
            out.append((f"{op}_{t}", build_func(op, [_col(t), _col(t, 1)])))
        out.append((f"neg_{t}", build_func("neg", [_nullable(t)])))
        for f in ("abs", "floor", "ceil", "round", "sqrt", "exp", "ln",
                  "log10", "sin", "cos", "tan"):
            out.append((f"{f}_{t}", build_func(f, [_col(t)])))
    for t in EXPR_TYPES + ("date", "timestamp"):
        for op in ("equal", "not_equal", "less_than", "less_than_or_equal",
                   "greater_than", "greater_than_or_equal"):
            b = _col(t, 1) if t in EXPR_TYPES else _nullable(t)
            out.append((f"{op}_{t}", build_func(op, [_col(t), b])))
    for frm in EXPR_TYPES:
        for to in EXPR_TYPES:
            if frm != to:
                out.append((f"cast_{frm}_{to}", F_cast(_col(frm),
                                                       EXPR_DT[to])))
    out += [("ts_to_date", F_cast(_col("timestamp"), T.DATE)),
            ("date_to_ts", F_cast(_col("date"), T.TIMESTAMP)),
            ("and", build_func("and", [_nullable("bool"),
                                       _nullable("bool", 1)])),
            ("or", build_func("or", [_nullable("bool"),
                                     _nullable("bool", 1)])),
            ("not", build_func("not", [_nullable("bool")])),
            ("power", build_func("power", [_col("float64"),
                                           _col("float64", 1)])),
            ("power_int", build_func("power", [_col("int32"),
                                               _col("float32")])),
            ("tumble_start", build_func("tumble_start", [
                _col("timestamp"), _col("int64")])),
            ("is_null", build_func("is_null", [build_func("divide", [
                _col("int32"), _col("int32", 1)])])),
            ("is_not_null", build_func("is_not_null", [_nullable("float32")])),
            ("coalesce", build_func("coalesce", [
                _nullable("int32"), _nullable("int64", 1),
                _col("int16")])),
            ("case", F_Case([(build_func("greater_than", [
                _col("float64"), Literal(0.0, T.FLOAT64)]),
                _nullable("int64")), (_nullable("bool"), _col("int32"))],
                _col("int16"), T.INT64)),
            ("case_no_else", F_Case([(_nullable("bool", 1),
                                      _col("float32"))], None, T.FLOAT64)),
            ("greatest", build_func("greatest", [_col("int32"),
                                                 _col("float64")]))]
    return out


def rand_tree(rng, t, depth):
    """A seeded random expression of type t (an EXPR_TYPES name)."""
    if depth == 0 or rng.random() < 0.25:
        if rng.random() < 0.3:
            v = rng.choice(expr_edges(t))
            return Literal(v.item(), EXPR_DT[t])
        return _nullable(t, int(rng.integers(2))) if rng.random() < 0.3 \
            else _col(t, int(rng.integers(2)))
    d = depth - 1
    if t == "bool":
        k = int(rng.integers(5))
        if k == 0:
            s = str(rng.choice(EXPR_TYPES))
            op = str(rng.choice(["equal", "less_than", "greater_than",
                                 "not_equal"]))
            return build_func(op, [rand_tree(rng, s, d), rand_tree(rng, s, d)])
        if k == 1:
            return build_func(str(rng.choice(["and", "or"])),
                              [rand_tree(rng, t, d), rand_tree(rng, t, d)])
        if k == 2:
            return build_func("not", [rand_tree(rng, t, d)])
        if k == 3:
            s = str(rng.choice(EXPR_TYPES))
            return build_func(str(rng.choice(["is_null", "is_not_null"])),
                              [rand_tree(rng, s, d)])
        return F_Case([(rand_tree(rng, "bool", d), rand_tree(rng, t, d))],
                      rand_tree(rng, t, d), T.BOOLEAN)
    k = int(rng.integers(6))
    if k == 0:
        op = str(rng.choice(["add", "subtract", "multiply", "divide",
                             "modulus"]))
        return build_func(op, [rand_tree(rng, t, d), rand_tree(rng, t, d)])
    if k == 1:
        return build_func(str(rng.choice(["neg", "abs"])),
                          [rand_tree(rng, t, d)])
    if k == 2:
        return F_cast(rand_tree(rng, str(rng.choice(EXPR_TYPES)), d),
                      EXPR_DT[t])
    if k == 3:
        return F_Case([(rand_tree(rng, "bool", d), rand_tree(rng, t, d))],
                      rand_tree(rng, t, d) if rng.random() < 0.5 else None,
                      EXPR_DT[t])
    if k == 4:
        return build_func("coalesce", [rand_tree(rng, t, d),
                                       rand_tree(rng, t, d)])
    if t == "float64":
        f = str(rng.choice(["sqrt", "exp", "ln", "log10", "sin", "cos",
                            "tan", "floor", "ceil", "round"]))
        return build_func(f, [rand_tree(rng, t, d)])
    return build_func("round", [rand_tree(rng, t, d)])


def path_programs(dev):
    """The lowered Map / Filter / join-condition programs of the seven
    paths' node graphs: (path, program)."""
    out = []
    for name, make in (("q4", lambda: q4_job(dev, 1 << 20)),
                       ("q1c", lambda: q1c_job(dev, 1 << 20)),
                       ("q2c", lambda: q2c_job(dev, 1 << 20)),
                       ("q3a", lambda: q3a_job(dev, 1 << 20)),
                       ("q5", lambda: q5_job(dev, 1 << 20)),
                       ("q7", lambda: q7_job(dev, 1 << 20)),
                       ("q8", lambda: q8_job(dev, 1 << 20))):
        for node in make().program.nodes:
            for n in getattr(node, "chain", [node]):
                for low in (getattr(n, "lowered", None),
                            getattr(n, "cond_lowered", None)):
                    if low is not None:
                        out.append((name, low.declared))
    return out


def program_columns(rng, prog, n, dev):
    """Random columns for a path program: the types it reads at the
    column indices it reads (values around the paths' ranges, with the
    edges first)."""
    width = max(prog.inputs) + 1
    cols = [torch.zeros(n, dtype=torch.int64, device=dev)] * width
    for idx, code in zip(prog.inputs, prog.in_types):
        t = EXPR_TYPES[code]
        v = rng.integers(-(1 << 40), 1 << 40, n).astype(EXPR_NP[t])
        v[: n // 2] = rng.integers(0, 2000, n // 2)
        e = expr_edges(t)
        v[:len(e)] = e
        cols[idx] = torch.from_numpy(v).to(dev)
    return cols


def expr_cases(rng, dev, n=EXPR_ROWS, randoms=48):
    """(case, program, columns, mask): the fixed trees (four to a map
    program, and each boolean one as a predicate), `randoms` seeded random
    programs of depth 3 over every type, and the paths' own programs."""
    cols = expr_columns(rng, n, dev)
    mask = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    fixed = expr_fixed_trees()
    for k in range(0, len(fixed), 4):
        group = fixed[k:k + 4]
        yield ("+".join(nm for nm, _ in group),
               K.lower_map([e for _, e in group]), cols, None)
    for nm, e in fixed:
        if e.return_type.kind == T.TypeKind.BOOLEAN:
            yield f"pred_{nm}", K.lower_pred(e), cols, mask
    made = 0
    while made < randoms:
        t = EXPR_TYPES[made % len(EXPR_TYPES)]
        e = rand_tree(rng, t, 3)
        try:
            prog = K.lower_pred(e) if t == "bool" and made % 2 \
                else K.lower_map([e])
        except ValueError:
            continue            # deeper than the kernel's stack: draw again
        yield f"random_{made}_{t}", prog, cols, \
            mask if prog.mode == "mask" else None
        made += 1
    for path, prog in path_programs(dev):
        pc = program_columns(rng, prog, n, dev)
        yield f"{path}_{prog.mode}", prog, pc, \
            mask if prog.mode == "mask" else None


EXPR_XR = 8            # rows a thread of expr_eval (expr_eval.cu XR)
EXPR_XT = 512          # rows a block of expr_eval
EXPR_KIND = {"bool": "BOOLEAN", "int16": "INT16", "int32": "INT32",
             "int64": "INT64", "float32": "FLOAT32", "float64": "FLOAT64"}


def expr_ns():
    """The port's expression constructors, in the form
    `expr_edge_specs`' `build` functions take a package's."""
    return SimpleNamespace(T=T, InputRef=InputRef, Literal=Literal,
                           Case=F_Case, build_func=build_func, cast=F_cast)


def edge_column(rng, t, n, first):
    """n values of type t (an EXPR_TYPES name): its edges first (every
    pairing with the other column of its type when `first` is False),
    then random values, half of them small. No float edge makes a
    subnormal in the programs below (XLA's CPU flushes those)."""
    dt = EXPR_NP[t]
    if t == "bool":
        return rng.random(n) < 0.5
    if np.issubdtype(dt, np.integer):
        i = np.iinfo(dt)
        v = rng.integers(i.min, i.max, n, endpoint=True,
                         dtype=np.int64).astype(dt)
        v[::2] = rng.integers(-3, 4, (n + 1) // 2).astype(dt)
        e = np.array([i.min, i.min + 1, -2, -1, 0, 1, 2, i.max - 1, i.max],
                     dt)
    else:
        v = rng.normal(0, 1000, n).astype(dt)
        v[::3] = rng.integers(-4, 5, (n + 2) // 3).astype(dt)
        e = np.array([np.nan, np.inf, -np.inf, 2.0 ** 63, 0.0, -0.0, 0.5,
                      -2.5, 1.0, 3.5], dt)
    m = min(n, len(e) * len(e))
    v[:m] = (np.repeat(e, len(e)) if first else np.tile(e, len(e)))[:m]
    return v


def expr_edge_specs():
    """The edges of the expression kernel, as (case, types, n, offset,
    mode, build): `types` the EXPR_TYPES name of each input column,
    `offset` each column's offset in elements when laid out as a view
    (`offset_view`), and `build(pk)` the case's expressions (mode "map":
    a list) or predicate ("mask") from a package's constructors
    (`expr_ns()`, or the JAX package's in the CPU tests). Row counts 1,
    EXPR_XR - 1, EXPR_XR + 1, EXPR_XT - 1, EXPR_XT + 1 and 2^20 + 3 over
    every type (literal first operands, two literals, a CASE); every
    column at an odd element offset, an output of every width; a
    program at depth 8 whose folded stack keeps 7 values below its top;
    a program of 128 instructions; 16 inputs and 16 outputs."""
    mixed = [t for t in EXPR_TYPES for _ in range(2)]

    def col(pk, types, i):
        return pk.InputRef(i, getattr(pk.T, EXPR_KIND[types[i]]))

    def lit(pk, v, t):
        return pk.Literal(v, getattr(pk.T, EXPR_KIND[t]))

    def mix(pk):
        c = lambda t, k=0: col(pk, mixed, mixed.index(t) + k)  # noqa: E731
        f = pk.build_func
        return [f("add", [c("int64"), lit(pk, 7, "int64")]),
                f("subtract", [lit(pk, 100, "int32"), c("int32")]),
                f("multiply", [c("float64"), c("float64", 1)]),
                f("divide", [c("int16"), c("int16", 1)]),
                f("modulus", [c("float32"), lit(pk, 3.5, "float32")]),
                f("not", [c("bool")]),
                pk.Case([(c("bool", 1), c("int64"))], c("int64", 1),
                        pk.T.INT64),
                f("add", [lit(pk, 1, "int64"), lit(pk, 2, "int64")]),
                f("greater_than", [c("int16"), c("int16", 1)]),
                f("divide", [c("int32"), lit(pk, 0, "int32")])]

    def pred(pk):
        c = lambda t, k=0: col(pk, mixed, mixed.index(t) + k)  # noqa: E731
        f = pk.build_func
        return f("and", [f("greater_than", [c("int64"),
                                            lit(pk, 0, "int64")]),
                         f("or", [f("less_than", [c("float64"),
                                                  c("float64", 1)]),
                                  f("not", [c("bool")])])])

    def widths(pk):
        c = lambda t, k=0: col(pk, mixed, mixed.index(t) + k)  # noqa: E731
        f = pk.build_func
        return [f("not", [c("bool")]), f("neg", [c("int16")]),
                f("add", [c("int32"), c("int32", 1)]),
                f("multiply", [c("int64"), lit(pk, -3, "int64")]),
                f("subtract", [c("float32"), c("float32", 1)]),
                f("divide", [c("float64"), c("float64", 1)])]

    deep_t = ["int64"] * 7 + ["bool"]

    def deep8(pk):
        f = pk.build_func
        e = pk.Case([(col(pk, deep_t, 7), col(pk, deep_t, 5))],
                    col(pk, deep_t, 6), pk.T.INT64)
        for i in reversed(range(5)):
            e = f("add", [f("multiply", [col(pk, deep_t, i),
                                         lit(pk, 2, "int64")]), e])
        return [e]

    def chain(pk):
        ops = ("add", "multiply", "subtract", "divide", "modulus")
        vals = (3, -7, 0, 1, -1, 1 << 40, 5, -(1 << 20), 11)
        e = col(pk, ["int64"], 0)
        for k in range(63):
            e = pk.build_func(ops[k % 5], [e, lit(pk, vals[k % 9], "int64")])
        return [e]

    wide_t = [EXPR_TYPES[i % 6] for i in range(16)]

    def wide(pk):
        out = []
        for i in range(16):
            t, j = wide_t[i], (i + 1) % 16
            other = pk.cast(col(pk, wide_t, j), getattr(pk.T, EXPR_KIND[t]))
            out.append(pk.build_func("or" if t == "bool" else "add",
                                     [col(pk, wide_t, i), other]))
        return out

    out = []
    for n in (1, EXPR_XR - 1, EXPR_XR + 1, EXPR_XT - 1, EXPR_XT + 1,
              (1 << 20) + 3):
        out.append((f"rows={n}", mixed, n, [0] * 12, "map", mix))
        out.append((f"rows={n}_pred", mixed, n, [0] * 12, "mask", pred))
    out.append(("odd_offsets", mixed, 4099, [1, 3] * 6, "map", widths))
    out.append(("odd_offsets_pred", mixed, 4099, [3, 1] * 6, "mask", pred))
    out.append(("depth_8", deep_t, 4101, [0] * 8, "map", deep8))
    out.append(("ins_128", ["int64"], 4103, [0], "map", chain))
    out.append(("in_16_out_16", wide_t, 4105, [1] * 16, "map", wide))
    return out


def expr_edge_arrays(rng, types, n):
    """The input columns of an `expr_edge_specs` case (numpy) and a row
    mask."""
    cols = [edge_column(rng, t, n, k % 2 == 0) for k, t in enumerate(types)]
    return cols, rng.random(n) < 0.9


def expr_edge_cases(rng, dev):
    """(case, program, columns, mask) of `expr_edge_specs` on `dev`: the
    port's trees lowered, each column a view at its offset."""
    pk = expr_ns()
    for case, types, n, offs, mode, build in expr_edge_specs():
        cols, mask = expr_edge_arrays(rng, types, n)
        cols = [offset_view(c, o, dev) for c, o in zip(cols, offs)]
        e = build(pk)
        prog = K.lower_map(e) if mode == "map" else K.lower_pred(e)
        yield case, prog, cols, (torch.from_numpy(mask).to(dev)
                                 if mode == "mask" else None)


def compare_bits(name, case, got, want):
    """`compare` at 0 tolerance, and a zero's sign on float leaves."""
    compare(name, case, got, want)
    for a, b in zip(leaves(got), leaves(want)):
        if a.dtype.is_floating_point:
            keep = ~torch.isnan(b)
            if not torch.equal(torch.signbit(a[keep]), torch.signbit(b[keep])):
                raise AssertionError(f"{name}/{case}: the sign of a zero "
                                     "differs")


def check_expr_eval(dev, n=EXPR_ROWS) -> float:
    """The kernel against its plain version on every case of
    `expr_cases`: equal to the bit. Returns the max abs difference."""
    rng = np.random.default_rng(20261017)
    count = 0
    for case, prog, cols, mask in expr_cases(rng, dev, n):
        got = K.expr_eval.expr_eval(prog, cols, mask)
        want = K.expr_eval_plain(prog, cols, mask)
        torch.cuda.synchronize()
        compare_bits("expr_eval", case, got, want)
        count += 1
    for case, prog, cols, mask in expr_edge_cases(rng, dev):
        got = K.expr_eval.expr_eval(prog, cols, mask)
        want = K.expr_eval_plain(prog, cols, mask)
        torch.cuda.synchronize()
        compare_bits("expr_eval", case, got, want)
        count += 1
    log(f"[kernels] expr_eval: {count} programs (the edges included) equal "
        "their plain version to the bit")
    return 0.0


def check_kernels(dev) -> dict:
    rng = np.random.default_rng(20241017)
    err = {k: 0.0 for k in REPLACES}
    for case, keys, cols in sort_cases(rng, dev):
        got = K.sort_cols(keys, cols)
        want = K.sort_cols_plain(keys, cols)
        torch.cuda.synchronize()
        err["sort_cols"] = max(err["sort_cols"],
                               compare("sort_cols", case, got, want))
    for case, keys, mask, vals, kinds in br_cases(rng, dev):
        got = K.batch_reduce(keys, mask, vals, kinds)
        want = K.batch_reduce_plain(keys, mask, vals, kinds)
        torch.cuda.synchronize()
        # a float SUM may differ by rounding order: within 1e-12 of the
        # summed magnitudes (the plain version adds with atomics); NaN
        # rows are left out of the scale
        scale = max([float(v.abs().nansum()) for v in vals
                     if v.dtype.is_floating_point] or [0.0])
        err["batch_reduce"] = max(err["batch_reduce"], compare(
            "batch_reduce", case, got, want, float_atol=1e-12 * scale))
    for case, st, dk, dv, kinds, drop in merge_cases(rng, dev):
        got = K.merge(st, dk, dv, kinds, drop_dead=drop)
        want = K.merge_plain(st, dk, dv, kinds, drop_dead=drop)
        torch.cuda.synchronize()
        err["merge"] = max(err["merge"], compare("merge", case, got, want))
    for case, alive, keys, cols, out_len, fills in compact_cases(rng, dev):
        got = K.compact_rows(alive, keys, cols, out_len, fills)
        want = K.compact_rows_plain(alive, keys, cols, out_len, fills)
        torch.cuda.synchronize()
        err["compact_rows"] = max(err["compact_rows"], compare(
            "compact_rows", case, got, want))
    # the join-side kernels only gather and add ints: exact on every leaf
    for case, *args in brr_cases(rng, dev):
        got = K.batch_reduce_rows(*args)
        want = K.batch_reduce_rows_plain(*args)
        torch.cuda.synchronize()
        compare("batch_reduce_rows", case, got, want)
    for case, *args in ms_cases(rng, dev):
        got = K.merge_side(*args)
        want = K.merge_side_plain(*args)
        torch.cuda.synchronize()
        compare("merge_side", case, got, want)
    for case, *args in probe_cases(rng, dev):
        got = K.probe(*args)
        want = K.probe_plain(*args)
        torch.cuda.synchronize()
        compare("probe", case, got, want)
    # the window and multiset kernels copy, add and compare ints: exact
    for case, *args in hop_cases(rng, dev):
        got = K.hop_expand(*args)
        want = K.hop_expand_plain(*args)
        torch.cuda.synchronize()
        if (got[1] is None) != (want[1] is None):
            raise AssertionError(f"hop_expand/{case}: pk presence differs")
        compare("hop_expand", case, hop_leaves(got), hop_leaves(want))
    for case, *args in msbr_cases(rng, dev):
        got = K.ms_batch_reduce(*args)
        want = K.ms_batch_reduce_plain(*args)
        torch.cuda.synchronize()
        compare("ms_batch_reduce", case, got, want)
    for case, *args in msm_cases(rng, dev):
        got = K.ms_merge(*args)
        want = K.ms_merge_plain(*args)
        torch.cuda.synchronize()
        compare("ms_merge", case, got, want)
    for case, *args in msf_cases(rng, dev) + msf_edge_cases(rng, dev):
        got = K.ms_find(*args)
        want = K.ms_find_plain(*args)
        torch.cuda.synchronize()
        compare("ms_find", case, got, want)
    # the telemetry kernels add and compare ints: exact
    for case, keys, live, w, into in vh_cases(rng, dev):
        got = K.vnode_hist(keys, live, w, EMPTY_KEY,
                           None if into is None else into.clone())
        want = K.vnode_hist_plain(keys, live, w, EMPTY_KEY,
                                  None if into is None else into.clone())
        torch.cuda.synchronize()
        compare("vnode_hist", case, got, want)
    for case, segs, rows in vhs_cases(rng, dev):
        got = K.vnode_hists(segs, rows)
        want = K.vnode_hists_plain(segs, rows, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("vnode_hist", case, got, want)
    tk = tk_cases(rng, dev)
    for case, keys, counts in tk:
        got = K.topk_packed(keys, counts)
        want = K.topk_packed_plain(keys, counts, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("topk_packed", case, got, want)
    check_topk_state(dev, tk[:3])
    # the tiering kernels search, copy and add ints: exact
    for case, *args in ts_cases(rng, dev):
        got = K.touch_stamp(*args, TIER_TTL)
        want = K.touch_stamp_plain(*args, TIER_TTL, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("touch_stamp", case, got, want)
    for case, keys, cols, fills, dk, hits in tp_cases(rng, dev):
        got = K.tier_partition(keys, cols, fills, dk, hits)
        want = K.tier_partition_plain(keys, cols, fills, dk, hits, EMPTY_KEY)
        torch.cuda.synchronize()
        compare("tier_partition", case, list(got), list(want))
    # the exchange moves rows and counts them: exact, f64 bits included
    for case, keys, mask, n, cap, cols, fills, kw in bx_cases(rng, dev):
        got = K.bucket_exchange(keys, mask, n, cap, cols, fills, **kw)
        want = K.bucket_exchange_plain(keys, mask, n, cap, cols, fills,
                                       **kw)
        torch.cuda.synchronize()
        compare_bits("bucket_exchange", case, list(got), list(want))
        if case == "one key overflows" and int(got[2]) <= cap:
            raise AssertionError("bucket_exchange: the overflow case did "
                                 "not overflow")
    check_exchange_sources(rng, dev)
    # the unpack moves and compares bytes: exact
    for case, p8, n in au_cases(rng, dev):
        got = K.agg_unpack(p8, n)
        want = K.agg_unpack_plain(p8, n)
        torch.cuda.synchronize()
        compare("agg_unpack", case, list(got), list(want))
    err["expr_eval"] = check_expr_eval(dev)
    err["gen_bids"] = check_gen_bids(dev)
    return err


AU_WIDTHS = (1, 2, 3, 4, 5, 7, 255, 256, 257, 2047, 2048, 2049, 4093,
             1 << 16, (1 << 20) + 3, 1 << 22)


def au_p8(rng, n_calls, b, dev, offset=0):
    """A seeded int8 flag matrix [2 + n_calls, b]: signs in {-1, 0, 1},
    flags in {0, 1} (a few other bytes among them, which are `!= 0` too);
    `offset` > 0 places it that many bytes into its buffer, so its rows
    are not 4-byte aligned."""
    p8 = np.empty((2 + n_calls, b), np.int8)
    p8[0] = rng.integers(-1, 2, b)
    p8[1:] = rng.integers(0, 2, (1 + n_calls, b))
    p8[1:, ::97] = rng.integers(-128, 128, p8[1:, ::97].shape)
    buf = torch.empty(p8.size + offset, dtype=torch.int8, device=dev)
    out = buf[offset:].view(2 + n_calls, b)
    out.copy_(torch.from_numpy(p8))
    return out


def au_cases(rng, dev):
    """agg_unpack at n_calls 1..6 and B from 1 (a tail only) to 2^22, and
    on matrices whose rows are not 4-byte aligned (a base one byte into
    its buffer; B not a multiple of 4)."""
    for n in range(1, 7):
        for b in AU_WIDTHS:
            yield f"n={n} B={b}", au_p8(rng, n, b, dev), n
    for b in (4, 4096, 1 << 20):
        yield f"n=3 B={b} base+1", au_p8(rng, 3, b, dev, offset=1), 3


# bucket_exchange: row counts from one row to 2^20, off the kernel's
# 2048-row tile and 256-row round; bounds with empty blocks
BX_WIDTHS = (1, 2, 31, 255, 257, 2047, 2048, 2049, 4097, 65537, 1 << 20)
BX_BOUNDS = {3: (0, 0, 128, 256),
             8: (0, 0, 17, 17, 90, 200, 200, 255, 256)}
BX_FILLS = (EMPTY_KEY, 0.0, -1, True)


def bx_columns(rng, b, dev):
    """int64, f64, int32 and bool columns of b rows (their fills in
    BX_FILLS): the exchange ships each as it is."""
    return [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, b)).to(dev),
            torch.from_numpy(rng.normal(0, 1e6, b)).to(dev),
            torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, b)
                             .astype(np.int32)).to(dev),
            torch.from_numpy(rng.random(b) < 0.5).to(dev)]


def bx_args(rng, b, dev, live_p=0.9, distinct=1 << 40, sign0_p=0.0):
    """(keys, mask, sign, pk) of b rows: keys from `distinct` values,
    `live_p` of them masked in, `sign0_p` of the signs 0 (dead rows of
    the fused form), pks of both signs."""
    keys = torch.from_numpy(rng.integers(0, distinct, b)).to(dev)
    mask = torch.from_numpy(rng.random(b) < live_p).to(dev)
    sign = torch.from_numpy(np.where(rng.random(b) < sign0_p, 0,
                                     rng.choice([-1, 1], b))
                            .astype(np.int32)).to(dev)
    pk = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, b)).to(dev)
    return keys, mask, sign, pk


def bx_cases(rng, dev):
    """bucket_exchange at n in {1, 3, 8} over BX_WIDTHS, both forms (the
    engines' `_bucketize`: cap = B, no sign; the fused exchange: cap
    about 2B / n, rows of sign 0 dead), all four column types; then all
    rows dead, one hot destination that overflows, rebalanced bounds with
    empty blocks, hot keys broadcast and salted (negative pks)."""
    for n in (1, 3, 8):
        for b in BX_WIDTHS:
            keys, mask, sign, pk = bx_args(rng, b, dev, sign0_p=0.1)
            cols = bx_columns(rng, b, dev)
            yield (f"bucketize n={n} B={b}", keys, mask, n, b, cols,
                   BX_FILLS, {})
            cap = max(1, 2 * b // n)
            yield (f"fused n={n} B={b} cap={cap}", keys, mask, n, cap,
                   cols + [sign, pk], BX_FILLS + (0, 0),
                   dict(sign=sign, pk=pk))
    b = 1 << 16
    keys, mask, sign, pk = bx_args(rng, b, dev, live_p=0.0)
    yield ("all dead", keys, mask, 8, 4096, bx_columns(rng, b, dev),
           BX_FILLS, dict(sign=sign))
    keys, mask, sign, pk = bx_args(rng, b, dev, distinct=1)
    yield ("one key overflows", keys, mask, 8, 1000,
           bx_columns(rng, b, dev), BX_FILLS, dict(sign=sign))
    for n, bounds in BX_BOUNDS.items():
        keys, mask, sign, pk = bx_args(rng, (1 << 20) + 5, dev)
        yield (f"bounds n={n}", keys, mask, n, 1 << 20,
               bx_columns(rng, keys.shape[0], dev), BX_FILLS,
               dict(sign=sign, bounds=bounds))
    for n in (3, 8):
        for mode, name in ((K.exchange.HOT_BCAST, "broadcast"),
                           (K.exchange.HOT_SALT, "salt")):
            b = (1 << 18) + 77
            keys, mask, sign, pk = bx_args(rng, b, dev, distinct=5000)
            hot = tuple(int(k) for k in
                        torch.unique(keys[:64]).cpu().numpy()[:3])
            yield (f"hot {name} n={n}", keys, mask, n, b,
                   bx_columns(rng, b, dev) + [pk], BX_FILLS + (0,),
                   dict(sign=sign, pk=pk, hot_keys=hot, hot_mode=mode,
                        hot_mask=SK_KEY_MASK))


# the one-call exchange: B from one row to 2^20; at 2048 every source's
# last row ends a tile, 2047 and 2049 put it one row either side
BXS_WIDTHS = (1, 31, 2047, 2048, 2049, 65537, 1 << 20)
BXS_FORMS = ((1, 1), (3, 3), (8, 8), (1, 8))      # (n_src, n_dst)


def bxs_sources(rng, n_src, b, dev, per=None):
    """(keys, masks, signs, pks, columns) of `n_src` sources of b rows
    (`bx_args` with the arguments per[s] for source s, `bx_columns`)."""
    per = per or {}
    srcs = [bx_args(rng, b, dev, **per.get(s, {})) for s in range(n_src)]
    return ([x[0] for x in srcs], [x[1] for x in srcs],
            [x[2] for x in srcs], [x[3] for x in srcs],
            [bx_columns(rng, b, dev) for _ in range(n_src)])


def bxs_cases(rng, dev):
    """bucket_exchange_sources in each of BXS_FORMS (n_src = 1 with n_dst
    = 8 is one source's call on a mesh over several cards) over
    BXS_WIDTHS, both forms (the engines': cap = B, no sign; the fused
    exchange's: cap about 2B / n, rows of sign 0 dead), all four column
    types; then at 8 sources of 2^16 + 3 rows: one source all dead, one
    source overflowing alone, rebalanced bounds with empty blocks, and
    hot keys in every source broadcast and salted (negative pks)."""
    for n_src, n in BXS_FORMS:
        for b in BXS_WIDTHS:
            keys, masks, signs, pks, cols = bxs_sources(
                rng, n_src, b, dev, {s: dict(sign0_p=0.1)
                                     for s in range(n_src)})
            tag = f"n_src={n_src} n={n} B={b}"
            yield (f"bucketize {tag}", keys, masks, n, b, cols, BX_FILLS,
                   {})
            cap = max(1, 2 * b // n)
            yield (f"fused {tag} cap={cap}", keys, masks, n, cap,
                   [c + [sg, pk] for c, sg, pk in zip(cols, signs, pks)],
                   BX_FILLS + (0, 0), dict(signs=signs, pks=pks))
    b, n = (1 << 16) + 3, 8
    keys, masks, signs, pks, cols = bxs_sources(
        rng, n, b, dev, {5: dict(live_p=0.0), 3: dict(distinct=1)})
    yield ("source 5 all dead, source 3 overflows alone", keys, masks, n,
           b // 4, cols, BX_FILLS, dict(signs=signs))
    yield ("bounds n=8", keys, masks, n, b, cols, BX_FILLS,
           dict(signs=signs, bounds=BX_BOUNDS[8]))
    keys, masks, signs, pks, cols = bxs_sources(
        rng, n, b, dev, {s: dict(distinct=5000) for s in range(n)})
    hot = tuple(int(k) for k in torch.unique(keys[0][:64]).cpu().numpy()[:3])
    for mode, name in ((K.exchange.HOT_BCAST, "broadcast"),
                       (K.exchange.HOT_SALT, "salt")):
        yield (f"hot {name} in every source", keys, masks, n, b,
               [c + [pk] for c, pk in zip(cols, pks)], BX_FILLS + (0,),
               dict(signs=signs, pks=pks, hot_keys=hot, hot_mode=mode,
                    hot_mask=SK_KEY_MASK))


def check_exchange_sources(rng, dev) -> None:
    """The one-call exchange against its plain version on `bxs_cases`, to
    the bit; the overflow case overflows in its one source; a call makes
    at most three CUDA launches (memsets and copies counted) at 8
    sources."""
    count = 0
    for case, keys, masks, n, cap, cols, fills, kw in bxs_cases(rng, dev):
        got = K.bucket_exchange_sources(keys, masks, n, cap, cols, fills,
                                        **kw)
        want = K.bucket_exchange_sources_plain(keys, masks, n, cap, cols,
                                               fills, **kw)
        torch.cuda.synchronize()
        compare_bits("bucket_exchange", f"sources {case}", list(got),
                     list(want))
        count += 1
        need = [int(x) for x in got[2]]
        if "overflows alone" in case and not (
                need[3] > cap and max(need[:3] + need[4:]) <= cap
                and need[5] == 0):
            raise AssertionError(f"bucket_exchange: {case}: needs {need} "
                                 f"against cap {cap}")
        if case.startswith("hot broadcast"):
            launches = cuda_launches_of(lambda: K.bucket_exchange_sources(
                keys, masks, n, cap, cols, fills, **kw))
            if sum(launches.values()) > 3:
                raise AssertionError(f"bucket_exchange: {launches} CUDA "
                                     "launches a call over 8 sources")
            log(f"[kernels] bucket_exchange over 8 sources: CUDA launches "
                f"a call {launches}")
    log(f"[kernels] bucket_exchange: {count} one-call cases equal to the "
        "bit")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


BID_COLS = [("auction", T.INT64), ("bidder", T.INT64), ("price", T.INT64),
            ("channel", T.VARCHAR), ("url", T.VARCHAR),
            ("date_time", T.TIMESTAMP), ("extra", T.VARCHAR),
            ("_row_id", T.INT64)]
AUCTION_COLS = [("id", T.INT64), ("item_name", T.VARCHAR),
                ("description", T.VARCHAR), ("initial_bid", T.INT64),
                ("reserve", T.INT64), ("date_time", T.TIMESTAMP),
                ("expires", T.TIMESTAMP), ("seller", T.INT64),
                ("category", T.INT64), ("extra", T.VARCHAR),
                ("_row_id", T.INT64)]
# SELECT b.auction, b.price, a.seller, a.category — plus both row ids,
# the pair MV's hidden stream key — over the joined bid ++ auction columns
Q3A_OUT = [0, 2, 8 + 7, 8 + 8, 7, 8 + 10]


def bid_source(dev, max_events):
    """The bid source with every column, as the fuse planner builds it."""
    return F.SourceNode("bid", GenCfg.from_config(NexmarkConfig()),
                        [c for c, _ in BID_COLS], len(BID_COLS) - 1,
                        max_events, [d for _, d in BID_COLS], device=dev)


def table_stream(dev, table, max_events, names):
    """The port generator's rows of `table` over [0, max_events), as numpy
    columns."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    acc = {nm: [] for nm in names}
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = torch.arange(lo, min(lo + EPOCH_EVENTS, max_events),
                           dtype=torch.int64, device=dev)
        m = table_mask(table, ids)
        cols = gen_table(gencfg, table, ids)
        for nm in names:
            acc[nm].append(cols[nm][m].cpu().numpy())
    return [np.concatenate(acc[nm]) for nm in names]


def bid_stream(dev, max_events, names):
    """The port generator's bids over [0, max_events), as numpy columns."""
    return table_stream(dev, "bid", max_events, names)


def groupby_reduce(keys, cols):
    """Sort-reduceat group-by: [(reduce, col), ...] -> (ukeys, results)."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    bounds = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    out = []
    for how, c in cols:
        if how == "count":
            out.append(np.diff(np.r_[bounds, len(k)]))
        elif how == "sum":
            out.append(np.add.reduceat(c[order], bounds))
        elif how == "max":
            out.append(np.maximum.reduceat(c[order], bounds))
    return k[bounds], out


def q4_job(dev, max_events=MAX_EVENTS, precombine=True, telemetry=True,
           tier=True, mesh=None, capacity=None):
    """The node graph the fuse planner lowers q4 to: Source(bid) ->
    Map($0, $2, $2) -> [Precombine ->] Agg -> MVKeyed. With `mesh`, the
    program runs sharded, its exchanges armed (`arm_exchange`)."""
    src = bid_source(dev, max_events)
    mp = F.MapNode(0, [InputRef(0, T.INT64), InputRef(2, T.INT64),
                       InputRef(2, T.INT64)], device=dev)
    calls = [F.AggCall("count"), F.AggCall("sum", 1), F.AggCall("max", 2)]
    spec = DeviceAggSpec.build(["count_star", "sum", "max"],
                               [np.int64] * 3, append_only=True)
    pack = F.PackPlan.plan([src.ranges[0]])
    nodes = [src, mp]
    if precombine:
        nodes.append(F.PrecombineNode(1, [0], calls, pack, spec, device=dev))
    cap = CAPACITY if capacity is None else capacity
    agg = F.AggNode(len(nodes) - 1, [0], calls, pack, spec, cap, None,
                    device=dev)
    if precombine:
        agg.enable_precombine()
    nodes.append(agg)
    nodes.append(F.MVKeyedNode(len(nodes) - 1, agg, cap, device=dev))
    pull = F.MVPull("keyed", len(nodes) - 1,
                    [T.INT64, T.INT64, T.DECIMAL, T.INT64], [F.NUM] * 4,
                    agg=agg, out_map=[("g", 0), ("c", 0), ("c", 1), ("c", 2)])
    arm_telemetry(nodes, telemetry, telemetry, tier)
    if mesh is not None:
        arm_exchange(nodes, mesh, EPOCH_EVENTS)
    prog = F.FusedProgram(nodes, EPOCH_EVENTS, device=dev, mesh=mesh)
    return F.FusedJob("q4", prog, pull, max_events, device=dev, profile=False)


def q4_oracle(dev, max_events=MAX_EVENTS):
    """numpy group-by over the bid stream of the port's generator."""
    auction, price = bid_stream(dev, max_events, ("auction", "price"))
    k, (cnt, s, m) = groupby_reduce(auction, [("count", None),
                                              ("sum", price),
                                              ("max", price)])
    return k, cnt, s, m


def drive(job, last=None):
    """Drive a job to the end of its stream, then pull the MV. Returns the
    rows, the drive seconds (dispatch, checkpoint syncs, growth replays;
    ends synced), the pull seconds, the kernel launches and the epochs
    dispatched (replays included). The launch counts are zeroed just
    before the drive and read just after the pull. With `last` (a dict),
    last["at"] holds the last dispatched epoch's input states and first
    event id."""
    steps = [0]
    step = job.program.step

    def counted(states, event_lo, acc, feeds=None):
        steps[0] += 1
        if last is not None:
            last["at"] = (states, event_lo, feeds)
        return step(states, event_lo, acc, feeds)
    job.program.step = counted
    K.reset_launches()
    drive_s = run_epochs(job)
    t1 = time.perf_counter()
    rows = job.mv_rows_now()
    t2 = time.perf_counter()
    launches = dict(K.LAUNCHES)
    del job.program.step
    return rows, drive_s, t2 - t1, launches, steps[0]


def barriers(job):
    """(epoch, checkpoint?) of each barrier `run_epochs` gives a job: a
    checkpoint every CKPT_EVERY while its stream lasts, then one more."""
    epoch = 0
    while not job.drained:
        epoch += 1
        yield epoch, epoch % CKPT_EVERY == 0
    yield epoch + 1, True


def run_epochs(job) -> float:
    """The barrier loop to the end of the job's stream, a checkpoint
    every CKPT_EVERY epochs and one after the last; returns its seconds
    (ends synced)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch, ckpt in barriers(job):
        job.on_barrier(SimpleNamespace(is_checkpoint=ckpt,
                                       epoch=SimpleNamespace(curr=epoch)))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive_cost(make, rounds: int = 3) -> dict:
    """The drive's seconds with the telemetry disarmed and armed, in turns
    (bare, armed, armed, bare, `rounds` times), each a fresh job from
    `make(telemetry)` driven to its end with no pull."""
    out = {"bare_s": [], "armed_s": []}
    for on in (False, True, True, False) * rounds:
        job = make(on)
        out["armed_s" if on else "bare_s"].append(run_epochs(job))
        del job
    return out


def run_main(dev, max_events=MAX_EVENTS, precombine=True):
    """q4 through `drive`: (job, rows, drive s, pull s, launches, epochs)."""
    job = q4_job(dev, max_events, precombine)
    return (job,) + drive(job)


def check_rows(rows, oracle):
    k, cnt, s, m = oracle
    if len(rows) != len(k):
        raise AssertionError(f"q4: {len(rows)} rows vs oracle {len(k)}")
    auc = np.array([r[0] for r in rows], np.int64)
    if not np.all(auc[1:] > auc[:-1]):
        raise AssertionError("q4 rows are not in key order")
    if not np.array_equal(auc, k):
        raise AssertionError("q4 group keys differ from the oracle")
    if not np.array_equal(np.array([r[1] for r in rows], np.int64), cnt):
        raise AssertionError("q4 count(*) differs from the oracle")
    if not np.array_equal(np.array([int(r[2]) for r in rows], np.int64), s):
        raise AssertionError("q4 sum(price) differs from the oracle")
    if not np.array_equal(np.array([r[3] for r in rows], np.int64), m):
        raise AssertionError("q4 max(price) differs from the oracle")


def q1c_job(dev, max_events=MAX_EVENTS, precombine=True, telemetry=True,
            tier=True, capacity=CAPACITY):
    """The node graph the fuse planner lowers q1c to (`SELECT bidder,
    count(*) AS n, sum(price * 908 / 1000) AS dol_eur, max(price * 908 /
    1000) AS top_eur FROM bid GROUP BY bidder`, Nexmark q1's currency
    conversion in integers): Source(bid) -> Map($1, divide(multiply($2,
    908), 1000) twice) -> [Precombine ->] Agg -> MVKeyed, q4's
    configuration."""
    src = bid_source(dev, max_events)
    eur = build_func("divide", [build_func("multiply", [
        InputRef(2, T.INT64), Literal(908, T.INT32)]), Literal(1000, T.INT32)])
    mp = F.MapNode(0, [InputRef(1, T.INT64), eur, eur], device=dev)
    return _keyed_job("q1c", dev, src, mp, src.ranges[1],
                      [F.AggCall("count"), F.AggCall("sum", 1),
                       F.AggCall("max", 2)], max_events, precombine,
                      telemetry, tier, capacity=capacity)


def q2c_job(dev, max_events=MAX_EVENTS, precombine=True, telemetry=True,
            tier=True, capacity=Q2C_CAPACITY):
    """The node graph the fuse planner lowers q2c to (`SELECT auction,
    count(*) AS n, sum(price) AS dol FROM bid WHERE auction % 123 = 0
    GROUP BY auction`, Nexmark q2's selection): Source(bid) ->
    Filter(equal(modulus($0, 123), 0)) -> Map($0, $2) -> [Precombine ->]
    Agg -> MVKeyed, q4's configuration but for the capacity
    (Q2C_CAPACITY)."""
    src = bid_source(dev, max_events)
    sel = F.FilterNode(0, build_func("equal", [build_func("modulus", [
        InputRef(0, T.INT64), Literal(123, T.INT32)]), Literal(0, T.INT32)]),
        device=dev)
    mp = F.MapNode(1, [InputRef(0, T.INT64), InputRef(2, T.INT64)],
                   device=dev)
    return _keyed_job("q2c", dev, src, mp, src.ranges[0],
                      [F.AggCall("count"), F.AggCall("sum", 1)], max_events,
                      precombine, telemetry, tier, filt=sel,
                      capacity=capacity)


def _keyed_job(name, dev, src, mp, key_range, calls, max_events, precombine,
               telemetry, tier, filt=None, capacity=CAPACITY):
    """Source [-> Filter] -> Map -> [Precombine ->] Agg -> MVKeyed, the
    group key the Map's column 0, pulled as (key, count, sum as DECIMAL
    [, max])."""
    kinds = {"count": "count_star", "sum": "sum", "max": "max"}
    spec = DeviceAggSpec.build([kinds[c.kind] for c in calls],
                               [np.int64] * len(calls), append_only=True)
    pack = F.PackPlan.plan([key_range])
    nodes = [src] + ([filt] if filt is not None else []) + [mp]
    if precombine:
        nodes.append(F.PrecombineNode(len(nodes) - 1, [0], calls, pack, spec,
                                      device=dev))
    agg = F.AggNode(len(nodes) - 1, [0], calls, pack, spec, capacity, None,
                    device=dev)
    if precombine:
        agg.enable_precombine()
    nodes.append(agg)
    nodes.append(F.MVKeyedNode(len(nodes) - 1, agg, capacity, device=dev))
    dts = [T.INT64, T.INT64, T.DECIMAL, T.INT64][:len(calls) + 1]
    pull = F.MVPull("keyed", len(nodes) - 1, dts, [F.NUM] * len(dts),
                    agg=agg, out_map=[("g", 0)] + [("c", i) for i in
                                                   range(len(calls))])
    arm_telemetry(nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(nodes, EPOCH_EVENTS, device=dev)
    return F.FusedJob(name, prog, pull, max_events, device=dev, profile=False)


def trunc_div(a, b):
    """SQL integer division (truncating), as the reference computes it."""
    return np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))


def q1c_oracle(dev, max_events=MAX_EVENTS):
    """numpy group-by of the port generator's bids: (bidder, count,
    sum, max) of price * 908 / 1000."""
    bidder, price = bid_stream(dev, max_events, ("bidder", "price"))
    eur = trunc_div(price * 908, 1000)
    k, (cnt, s, m) = groupby_reduce(bidder, [("count", None), ("sum", eur),
                                             ("max", eur)])
    return k, cnt, s, m


def q2c_oracle(dev, max_events=MAX_EVENTS):
    """numpy group-by of the port generator's bids with auction % 123 ==
    0 (the dividend's sign, as SQL's %): (auction, count, sum(price))."""
    auction, price = bid_stream(dev, max_events, ("auction", "price"))
    sel = auction - trunc_div(auction, 123) * 123 == 0
    k, (cnt, s) = groupby_reduce(auction[sel], [("count", None),
                                                ("sum", price[sel])])
    return k, cnt, s


def check_keyed_rows(name, rows, oracle):
    """Rows in key order, every column equal to the oracle's."""
    want = np.stack(oracle, 1)
    got = np.array([[int(v) for v in r] for r in rows],
                   np.int64).reshape(-1, want.shape[1])
    if got.shape != want.shape:
        raise AssertionError(f"{name}: {got.shape[0]} rows vs oracle "
                             f"{want.shape[0]}")
    if not np.all(got[1:, 0] > got[:-1, 0]):
        raise AssertionError(f"{name} rows are not in key order")
    if not np.array_equal(got, want):
        bad = int(np.sum(np.any(got != want, axis=1)))
        raise AssertionError(f"{name}: {bad} rows differ from the oracle")




def q3a_job(dev, max_events=Q3_EVENTS, epoch_events=EPOCH_EVENTS,
            capacity=CAPACITY, telemetry=True, tier=True, host_fed=False,
            budget_mb=4096, presize=None, mesh=None):
    """The node graph the fuse planner lowers q3a to (`SELECT b.auction,
    b.price, a.seller, a.category FROM bid b JOIN auction a ON b.auction
    = a.id WHERE b.price > 500`): Source(bid), Source(auction) ->
    Join(auction = id, pair capacity 4 x capacity) -> Filter($2 > 500) ->
    Map -> MVPair. With `host_fed`, both sources are IngestNodes fed by
    the job's HostIngest, and the join demotes under `budget_mb`.
    `presize` ({"a", "b", "pairs", "mv"} -> slots) sets starting
    capacities above `capacity`. With `mesh`, the program runs sharded."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    srcs = [F.SourceNode(table, gencfg, [c for c, _ in cols], len(cols) - 1,
                         max_events, [d for _, d in cols], device=dev)
            for table, cols in (("bid", BID_COLS), ("auction", AUCTION_COLS))]
    # the join key packs over both sides' ranges (fuse_planner._join)
    (alo, ahi, ast), (blo, bhi, bst) = srcs[0].ranges[0], srcs[1].ranges[0]
    pack = F.PackPlan.plan([(min(alo, blo), max(ahi, bhi),
                             math.gcd(ast, bst) or 1)])
    join = F.JoinNode(0, 1, [0], [0], pack, None, capacity, 4 * capacity,
                      [torch.int64] * len(BID_COLS),
                      [torch.int64] * len(AUCTION_COLS), device=dev)
    filt = F.FilterNode(2, build_func(
        "greater_than", [InputRef(2, T.INT64), Literal(500, T.INT64)]),
        device=dev)
    mp = F.MapNode(3, [InputRef(i, T.INT64) for i in Q3A_OUT], device=dev)
    mv = F.MVPairNode(4, [torch.int64] * len(Q3A_OUT), capacity, device=dev)
    pull = F.MVPull("pair", 5, [T.INT64] * len(Q3A_OUT),
                    [F.NUM] * len(Q3A_OUT))
    nodes = srcs + [join, filt, mp, mv]
    if presize:
        join.preset_caps(presize)
        mv.preset_caps({"main": presize.get("mv", 0)})
    arm_telemetry(nodes, telemetry, telemetry, tier)
    return _job("q3a", nodes, pull, max_events, epoch_events, dev, host_fed,
                budget_mb, mesh)


def _job(name, nodes, pull, max_events, epoch_events, dev, host_fed=False,
         budget_mb=4096, mesh=None):
    """The FusedJob of a node list; `host_fed` makes its sources
    IngestNodes (only the columns some node reads ship) fed by a
    HostIngest, with the planner's tier plans and the memory budget;
    `mesh` runs it sharded, its exchanges armed."""
    if mesh is not None:
        arm_exchange(nodes, mesh, epoch_events)
    if not host_fed:
        prog = F.FusedProgram(nodes, epoch_events, device=dev, mesh=mesh)
        return F.FusedJob(name, prog, pull, max_events, device=dev,
                          hbm_budget_mb=budget_mb, profile=False)
    to_ingest(nodes)
    prune_ingest_columns(nodes)
    prog = F.FusedProgram(nodes, epoch_events, device=dev)
    ingest = host_ingest(prog, max_events)
    return F.FusedJob(name, prog, pull, max_events, device=dev,
                      hbm_budget_mb=budget_mb, ingest=ingest,
                      tier_plans=tier_plans(prog, ingest), profile=False)


def q3a_oracle(dev, max_events=Q3_EVENTS):
    """numpy hash join of the port generator's bid and auction streams,
    filtered on price > 500, in (bid row id, auction row id) order: an
    [n, 6] int64 array of the MV's columns."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    bids, aucs = [], []
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = torch.arange(lo, min(lo + EPOCH_EVENTS, max_events),
                           dtype=torch.int64, device=dev)
        for table, names, acc in (("bid", ("auction", "price"), bids),
                                  ("auction", ("id", "seller", "category"),
                                   aucs)):
            m = table_mask(table, ids)
            cols = gen_table(gencfg, table, ids)
            acc.append(np.stack([cols[c][m].cpu().numpy() for c in names]
                                + [ids[m].cpu().numpy()], 1))
    bid, auc = np.concatenate(bids), np.concatenate(aucs)
    bid = bid[bid[:, 1] > 500]
    order = np.argsort(auc[:, 0], kind="stable")
    aid = auc[order, 0]
    pos = np.clip(np.searchsorted(aid, bid[:, 0]), 0, len(aid) - 1)
    hit = aid[pos] == bid[:, 0]
    if len(np.unique(aid)) != len(aid):
        raise AssertionError("q3a oracle: auction ids are not unique")
    bid, a = bid[hit], auc[order[pos[hit]]]
    rows = np.stack([bid[:, 0], bid[:, 1], a[:, 1], a[:, 2], bid[:, 2],
                     a[:, 3]], 1)
    return rows[np.lexsort((rows[:, 5], rows[:, 4]))]


def check_q3a_visible(rows, oracle):
    """`SELECT *` of q3a — its four visible columns — against the oracle's
    in the same (bid row id, auction row id) order."""
    got = np.array(rows, dtype=np.int64).reshape(-1, 4)
    if got.shape != oracle[:, :4].shape \
            or not np.array_equal(got, oracle[:, :4]):
        raise AssertionError(f"q3a: {got.shape[0]} visible rows differ from "
                             f"the oracle's {oracle.shape[0]}")


def check_q3a_rows(rows, oracle):
    got = np.array(rows, dtype=np.int64).reshape(-1, len(Q3A_OUT))
    if got.shape != oracle.shape:
        raise AssertionError(f"q3a: {got.shape[0]} rows vs oracle "
                             f"{oracle.shape[0]}")
    if not np.array_equal(got, oracle):
        bad = int(np.sum(np.any(got != oracle, axis=1)))
        raise AssertionError(f"q3a: {bad} rows differ from the oracle")


# ---------------------------------------------------------------------------
# the host-fed tiered paths
# ---------------------------------------------------------------------------


def qa_job(dev, max_events=QA_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, budget_mb=4096, host_fed=True):
    """`SELECT auction, count(*), sum(price) FROM bid GROUP BY auction`
    over bids with `nexmark.key.dist='zipf:1.5'`, pre-combine off (the
    raw agg users set for exact aggs): Ingest(bid) -> Map($0, $2) -> Agg ->
    MVKeyed, every arm on, host-fed under `budget_mb`."""
    gencfg = GenCfg.from_config(NexmarkConfig(key_dist=QA_KEY_DIST))
    src = F.SourceNode("bid", gencfg, [c for c, _ in BID_COLS],
                       len(BID_COLS) - 1, max_events,
                       [d for _, d in BID_COLS], device=dev)
    mp = F.MapNode(0, [InputRef(0, T.INT64), InputRef(2, T.INT64)],
                   device=dev)
    calls = [F.AggCall("count"), F.AggCall("sum", 1)]
    spec = DeviceAggSpec.build(["count_star", "sum"], [np.int64] * 2,
                               append_only=True)
    agg = F.AggNode(1, [0], calls, F.PackPlan.plan([src.ranges[0]]), spec,
                    capacity, None, device=dev)
    mv = F.MVKeyedNode(2, agg, capacity, device=dev)
    pull = F.MVPull("keyed", 3, [T.INT64, T.INT64, T.DECIMAL], [F.NUM] * 3,
                    agg=agg, out_map=[("g", 0), ("c", 0), ("c", 1)])
    nodes = [src, mp, agg, mv]
    arm_telemetry(nodes)
    return _job("qa", nodes, pull, max_events, epoch_events, dev, host_fed,
                budget_mb)


def qa_oracle(max_events=QA_EVENTS):
    """numpy group-by over the zipf bid stream of the host generator:
    (auction, count, sum(price))."""
    gencfg = GenCfg.from_config(NexmarkConfig(key_dist=QA_KEY_DIST))
    auc, price = [], []
    for lo in range(0, max_events, EPOCH_EVENTS):
        ids = np.arange(lo, min(lo + EPOCH_EVENTS, max_events),
                        dtype=np.int64)
        ids = ids[_event_kinds(ids) == 2]
        cols = gen_surrogates(gencfg, "bid", ids, cols=["auction", "price"])
        auc.append(cols["auction"])
        price.append(cols["price"])
    k, (cnt, sm) = groupby_reduce(np.concatenate(auc),
                                  [("count", None),
                                   ("sum", np.concatenate(price))])
    return k, cnt, sm


def check_qa_rows(rows, oracle):
    k, cnt, sm = oracle
    got = np.array([(r[0], r[1], int(r[2])) for r in rows],
                   np.int64).reshape(-1, 3)
    want = np.stack([k, cnt, sm], 1)
    if got.shape[0] != len(k) or not np.all(got[1:, 0] > got[:-1, 0]) \
            or not np.array_equal(got, want):
        m = min(len(got), len(want))
        bad = np.flatnonzero(np.any(got[:m] != want[:m], axis=1))
        first = int(bad[0]) if len(bad) else m
        raise AssertionError(
            f"qa: {got.shape[0]} rows differ from the oracle's {len(k)}; "
            f"first at {first}: "
            f"{got[first].tolist() if first < len(got) else None} vs "
            f"{want[first].tolist() if first < len(want) else None}")


def tiered_tables(job) -> dict:
    """The key tables that demote, by name -> (capacity, device bytes):
    both sides of a join, an agg's main table and its lockstep MV's (the
    budget's own accounting, `cap_bytes` x capacity)."""
    out = {}
    for p in job.tiering.plans:
        if not p.recipes:
            continue
        node = job.program.nodes[p.node_idx]
        nodes = [(p.node_idx, node)]
        if p.mv_idx is not None:
            nodes.append((p.mv_idx, job.program.nodes[p.mv_idx]))
        for i, n in nodes:
            cur, b = n.cap_current(), n.cap_bytes()
            for sl in ("a", "b", "main"):
                if sl in cur:
                    out[f"{i}:{type(n).__name__}.{sl}"] = (cur[sl],
                                                           cur[sl] * b[sl])
    return out


def clamp_budget_mb(job, table: str, slots: int) -> int:
    """The memory budget that holds `table` (a `tiered_tables` name) at
    `slots` slots, in MiB."""
    i, rest = table.split(":")
    sl = rest.split(".")[1]
    return -(-slots * job.program.nodes[int(i)].cap_bytes()[sl] >> 20)


def check_tres(name, job) -> dict:
    """Each tier-armed node's `tres` high-water equals the live rows of its
    final state (both sides of a join)."""
    out = {}
    for i, node in enumerate(job.program.nodes):
        if not node.tier:
            continue
        st = inner(job.states[i])
        live = int(st.main.count) if isinstance(node, F.AggNode) \
            else int(st[0].count) + int(st[1].count)
        tres = job.program.node_stats(i, job._stat_totals)["tres"]
        if tres != live:
            raise AssertionError(f"{name} node {i}: tres {tres} vs "
                                 f"{live} live rows")
        out[f"{i}:{type(node).__name__}"] = live
    return out


def tiered_phase(name, job, events, kernels_needed, check, smi) -> dict:
    """Drive a host-fed tiered path, check its rows and its tiering: it
    demoted, stayed inside its memory budget, and launched its kernels.
    Prints every tiering counter and the tier phases' walls."""
    rows, drive_s, pull_s, launches, epochs = drive(job)
    t = time.perf_counter()
    check(rows)
    tm = job.tiering
    budget = job.hbm_budget_mb << 20
    tables = tiered_tables(job)
    rep = {"events": events, "drive_s": drive_s, "pull_s": pull_s,
           "events_per_s": events / drive_s, "rows": len(rows),
           "growth_replays": job.growth_replays,
           "capacities": {f"{i}:{type(n).__name__}": n.cap_current()
                          for i, n in enumerate(job.program.nodes)
                          if n.cap_current()},
           "tiered_tables": tables, "budget_bytes": budget,
           "tiering": dict(tm.counters), "tier_walls_s": dict(job.tier_walls),
           "tiering_report": job.tiering_report(),
           "cold_rows": {str(k): len(v) for k, v in tm.stores.items()},
           "ingest": {k: v for k, v in job.ingest.stats().items()
                      if k != "sources"},
           "launches": launches, "epochs_dispatched": epochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    job.ingest.close()
    log(f"[main] {name} {json.dumps(rep)}")
    if tm.counters["demotions"] <= 0:
        raise AssertionError(f"{name}: no demotion")
    past = {k: v for k, v in tables.items() if v[1] > budget}
    if past:
        raise AssertionError(f"{name}: {past} grew past the {budget}-byte "
                             "budget")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    return rep


def hop_ranges(tr, hop, size):
    """(window_start, window_end) ranges of a hop over the time range tr,
    as the fuse planner's interval analysis proves them."""
    ws = ((tr[0] // hop - size // hop) * hop, tr[1], hop)
    return ws, (ws[0] + size, tr[1] + size, hop)


def _i64(k):
    return InputRef(k, T.INT64)


def _ts(k):
    return InputRef(k, T.TIMESTAMP)


class _Graph:
    """Nodes appended in order; `add` returns the new node's index."""

    def __init__(self, dev):
        self.dev = dev
        self.nodes = []

    def add(self, cls, *args, **kw):
        self.nodes.append(cls(*args, device=self.dev, **kw))
        return len(self.nodes) - 1


def q5_job(dev, max_events=Q5_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, telemetry=True, tier=True, mesh=None,
           profile=False):
    """The node graph the fuse planner lowers Nexmark q5 to (pre-combine
    on): Source(bid) feeds two HOP(2 s, 10 s) branches.
      A: Hop -> Map(ws, auction) -> Precombine -> Agg count(*) per
         (window, auction), with row identity -> Map(auction, num, ws);
      B: Hop -> Map(auction, ws) -> Precombine -> Agg count(*) ->
         Map -> Map(ws, num) -> Agg max(num) per window, retractable (a
         multiset fed B's retracting change stream) -> Map(maxn, ws).
    Join(A.ws = B.ws, num >= maxn) -> Map -> MVPair. With `mesh`, the
    program runs sharded (every agg and both join inputs exchanged).
    `profile` is the job's epoch profiler (the smoke's paths run without
    it; q5obs runs with it, the default a user's job gets)."""
    g = _Graph(dev)
    src = bid_source(dev, max_events)
    g.nodes.append(src)
    rng = src.ranges
    hop, size = 2 * USEC, 10 * USEC
    ws, _ = hop_ranges(rng[5], hop, size)
    cnt = (0, (size // hop) * max_events, 1)      # count(*) after the hop
    count = [F.AggCall("count")]
    cspec = DeviceAggSpec.build(["count_star"], [np.int64])
    # branch A: count per (window, auction), row identity for the join
    h = g.add(F.HopNode, 0, 5, hop, size)
    m = g.add(F.MapNode, h, [_ts(8), _i64(0)])
    pack = F.PackPlan.plan([ws, rng[0]])
    p = g.add(F.PrecombineNode, m, [0, 1], count, pack, cspec)
    a = g.add(F.AggNode, p, [0, 1], count, pack, cspec, capacity,
              F.PackPlan.plan([ws, rng[0], cnt]))
    g.nodes[a].enable_precombine()
    left = g.add(F.MapNode, a, [_i64(1), _i64(2), _ts(0)])
    # branch B: the max of those counts per window
    h = g.add(F.HopNode, 0, 5, hop, size)
    m = g.add(F.MapNode, h, [_i64(0), _ts(8)])
    pack = F.PackPlan.plan([rng[0], ws])
    p = g.add(F.PrecombineNode, m, [0, 1], count, pack, cspec)
    b = g.add(F.AggNode, p, [0, 1], count, pack, cspec, capacity, None)
    g.nodes[b].enable_precombine()
    m = g.add(F.MapNode, b, [_i64(2), _ts(1), _i64(0)])
    m = g.add(F.MapNode, m, [_ts(1), _i64(0)])
    mspec = DeviceAggSpec.build(["max"], [np.int64], append_only=False,
                                arg_ids=[("ref", 1)])
    mx = g.add(F.AggNode, m, [0], [F.AggCall("max", 1)],
               F.PackPlan.plan([ws]), mspec, capacity,
               F.PackPlan.plan([ws, cnt]))
    right = g.add(F.MapNode, mx, [_i64(1), _ts(0)])
    j = g.add(F.JoinNode, left, right, [2], [1], F.PackPlan.plan([ws]),
              build_func("greater_than_or_equal", [_i64(1), _i64(3)]),
              capacity, 4 * capacity, [torch.int64] * 3, [torch.int64] * 2)
    out = g.add(F.MapNode, j, [_i64(0), _i64(1), _ts(2), _ts(4)])
    mv = g.add(F.MVPairNode, out, [torch.int64] * 4, capacity)
    pull = F.MVPull("pair", mv, [T.INT64, T.INT64, T.TIMESTAMP, T.TIMESTAMP],
                    [F.NUM, F.NUM, TS, TS])
    arm_telemetry(g.nodes, telemetry, telemetry, tier)
    if mesh is not None:
        arm_exchange(g.nodes, mesh, epoch_events)
    prog = F.FusedProgram(g.nodes, epoch_events, device=dev, mesh=mesh)
    return F.FusedJob("q5", prog, pull, max_events, device=dev,
                      profile=profile)


def q7_job(dev, max_events=Q7_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, telemetry=True, tier=True):
    """The node graph the fuse planner lowers Nexmark q7 to (pre-combine
    on): Source(bid) -> Hop(TUMBLE 10 s) -> Map(window_end, price) ->
    Precombine -> Agg max(price) per window (append-only), with row
    identity -> Map(maxprice, window_end); Join(bid.price = maxprice)
    -> Filter(date_time BETWEEN window_end - 10 s AND window_end) -> Map
    -> MVPair."""
    g = _Graph(dev)
    src = bid_source(dev, max_events)
    g.nodes.append(src)
    rng = src.ranges
    size = 10 * USEC
    _, we = hop_ranges(rng[5], size, size)
    h = g.add(F.HopNode, 0, 5, size, size)
    m = g.add(F.MapNode, h, [_ts(9), _i64(2)])
    calls = [F.AggCall("max", 1)]
    spec = DeviceAggSpec.build(["max"], [np.int64], append_only=True)
    pack = F.PackPlan.plan([we])
    p = g.add(F.PrecombineNode, m, [0], calls, pack, spec)
    a = g.add(F.AggNode, p, [0], calls, pack, spec, capacity,
              F.PackPlan.plan([we, rng[2]]))
    g.nodes[a].enable_precombine()
    right = g.add(F.MapNode, a, [_i64(1), _ts(0)])
    j = g.add(F.JoinNode, 0, right, [2], [0], F.PackPlan.plan([rng[2]]),
              None, capacity, 4 * capacity, [torch.int64] * len(BID_COLS),
              [torch.int64] * 2)
    pred = build_func("and", [
        build_func("greater_than_or_equal", [_ts(5),
                                             _TsShift(_ts(9), -size)]),
        build_func("less_than_or_equal", [_ts(5), _ts(9)])])
    f = g.add(F.FilterNode, j, pred)
    out = g.add(F.MapNode, f, [_i64(0), _i64(2), _i64(1), _ts(5), _i64(7),
                               _ts(9)])
    mv = g.add(F.MVPairNode, out, [torch.int64] * 6, capacity)
    pull = F.MVPull("pair", mv, [T.INT64, T.INT64, T.INT64, T.TIMESTAMP,
                                 T.INT64, T.TIMESTAMP],
                    [F.NUM, F.NUM, F.NUM, TS, F.NUM, TS])
    arm_telemetry(g.nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(g.nodes, epoch_events, device=dev)
    return F.FusedJob("q7", prog, pull, max_events, device=dev, profile=False)


def np_hop_expand(ts, hop, size):
    """Per-row window starts of HOP (the latest aligned start <= ts, then
    n - 1 back), row-major: row i repeats n times."""
    n = size // hop
    first = (ts // hop) * hop
    return (first[:, None] - (np.arange(n) * hop)[None, :]).reshape(-1)


def numpy_q5(auction, ts):
    """q5 over whole columns: per HOP(2 s, 10 s) window, the auctions whose
    bid count reaches the window's maximum — the sorted multiset of
    (auction, num)."""
    hop, size = 2 * USEC, 10 * USEC
    ws = np_hop_expand(ts, hop, size)
    au = np.repeat(auction, size // hop)
    wn = (ws - ws.min()) // hop       # small window ordinals
    keys, (num,) = groupby_reduce(wn * np.int64(1 << 32) + au,
                                  [("count", None)])
    kws, kau = keys >> 32, keys & ((1 << 32) - 1)
    rows = []
    for w in np.unique(kws):
        sel = kws == w
        mx = num[sel].max()
        top = num[sel] >= mx
        rows += [(int(a), int(c)) for a, c in zip(kau[sel][top],
                                                  num[sel][top])]
    return sorted(rows)


def numpy_q7(auction, bidder, price, ts):
    """q7 over whole columns: the bids at their TUMBLE(10 s) window's max
    price with date_time in [window_end - 10 s, window_end], sorted."""
    size = 10 * USEC
    wend = (ts // size) * size + size
    keys, (mp,) = groupby_reduce(wend, [("max", price)])
    rows = []
    for e, m in zip(keys, mp):
        sel = (price == m) & (ts >= e - size) & (ts <= e)
        rows += [(int(auction[i]), int(price[i]), int(bidder[i]), int(ts[i]))
                 for i in np.flatnonzero(sel)]
    return sorted(rows)


def q5_oracle(dev, max_events=Q5_EVENTS):
    return numpy_q5(*bid_stream(dev, max_events, ("auction", "date_time")))


def q7_oracle(dev, max_events=Q7_EVENTS):
    return numpy_q7(*bid_stream(dev, max_events, ("auction", "bidder",
                                                  "price", "date_time")))


def check_q5_rows(rows, oracle):
    got = sorted((int(r[0]), int(r[1])) for r in rows)
    if not oracle or got != oracle:
        raise AssertionError(f"q5: {len(got)} rows differ from the oracle's "
                             f"{len(oracle)}")


def check_q7_rows(rows, oracle):
    got = sorted((int(r[0]), int(r[1]), int(r[2]), int(r[3])) for r in rows)
    if not oracle or got != oracle:
        raise AssertionError(f"q7: {len(got)} rows differ from the oracle's "
                             f"{len(oracle)}")


PERSON_COLS = [("id", T.INT64), ("name", T.VARCHAR),
               ("email_address", T.VARCHAR), ("credit_card", T.VARCHAR),
               ("city", T.VARCHAR), ("state", T.VARCHAR),
               ("date_time", T.TIMESTAMP), ("extra", T.VARCHAR),
               ("_row_id", T.INT64)]


def q8_job(dev, max_events=Q8_EVENTS, epoch_events=EPOCH_EVENTS,
           capacity=CAPACITY, telemetry=True, tier=True):
    """The node graph the fuse planner lowers Nexmark q8 to (pre-combine
    on): two TUMBLE(10 s) distincts joined on (id = seller, window).
      P: Source(person) -> Hop -> Map(id, name, ws, we) -> Precombine ->
         Agg with no calls per (id, name, ws, we), with row identity ->
         Map;
      A: Source(auction) -> Hop -> Map(seller, ws, we) -> Precombine ->
         Agg with no calls per (seller, ws, we) -> Map.
    Join(P.(id, ws, we) = A.(seller, ws, we)) -> Map -> MVPair. Every
    PackPlan field is proven from the generator's ranges at this scale
    (the window bounds by `hop_ranges`, as the planner's interval
    analysis does), so a packbad stat never fires."""
    g = _Graph(dev)
    gencfg = GenCfg.from_config(NexmarkConfig())
    size = 10 * USEC
    none = DeviceAggSpec.build([], [])
    sides = []
    for table, cols, time_col, key_cols in (
            ("person", PERSON_COLS, 6, (0, 1)),
            ("auction", AUCTION_COLS, 5, (7,))):
        src = F.SourceNode(table, gencfg, [c for c, _ in cols], len(cols) - 1,
                           max_events, [d for _, d in cols], device=dev)
        g.nodes.append(src)
        h = g.add(F.HopNode, len(g.nodes) - 1, time_col, size, size)
        ws, we = hop_ranges(src.ranges[time_col], size, size)
        w = len(cols)                   # window_start, then window_end
        m = g.add(F.MapNode, h, [InputRef(k, cols[k][1]) for k in key_cols]
                  + [_ts(w), _ts(w + 1)])
        rng = [src.ranges[k] for k in key_cols] + [ws, we]
        gidx = list(range(len(rng)))
        pack = F.PackPlan.plan(rng)
        p = g.add(F.PrecombineNode, m, gidx, [], pack, none)
        a = g.add(F.AggNode, p, gidx, [], pack, none, capacity, pack)
        g.nodes[a].enable_precombine()
        out = g.add(F.MapNode, a, [InputRef(k, g.nodes[m].exprs[k]
                                            .return_type) for k in gidx])
        sides.append((out, rng, src))
    (left, lr, psrc), (right, rr, _) = sides
    # (id, ws, we) = (seller, ws, we), packed over both sides' ranges
    jpack = F.PackPlan.plan([(min(a[0], b[0]), max(a[1], b[1]),
                              math.gcd(a[2], b[2]) or 1)
                             for a, b in zip([lr[0], lr[2], lr[3]], rr)])
    j = g.add(F.JoinNode, left, right, [0, 2, 3], [0, 1, 2], jpack, None,
              capacity, 4 * capacity, [torch.int64] * 4, [torch.int64] * 3)
    dts = [T.INT64, T.VARCHAR, T.TIMESTAMP, T.TIMESTAMP, T.INT64,
           T.TIMESTAMP, T.TIMESTAMP]
    out = g.add(F.MapNode, j, [InputRef(k, d) for k, d in enumerate(dts)])
    mv = g.add(F.MVPairNode, out, [torch.int64] * len(dts), capacity)
    pull = F.MVPull("pair", mv, dts,
                    [F.NUM, psrc.decoders[1], TS, TS, F.NUM, TS, TS])
    arm_telemetry(g.nodes, telemetry, telemetry, tier)
    prog = F.FusedProgram(g.nodes, epoch_events, device=dev)
    return F.FusedJob("q8", prog, pull, max_events, device=dev, profile=False)


def numpy_q8(p_id, p_name, p_ts, a_seller, a_ts):
    """q8 over whole columns: the (id, name, window_start) of every person
    whose TUMBLE(10 s) window also holds an auction they sell — sorted
    unique rows as an [n, 3] int64 array (name as its surrogate)."""
    size = 10 * USEC
    pw, aw = (p_ts // size) * size, (a_ts // size) * size
    w0 = min(pw.min(), aw.min())
    persons = np.unique(np.stack([p_id, p_name, pw], 1), axis=0)
    # (id, window ordinal) packed into one int64 for the membership test
    shift = int(max(pw.max(), aw.max()) - w0) // size + 1
    pk = persons[:, 0] * shift + (persons[:, 2] - w0) // size
    sk = np.unique(a_seller * shift + (aw - w0) // size)
    return persons[np.isin(pk, sk)]


def q8_streams(dev, max_events=Q8_EVENTS):
    """(person id, name surrogate, date_time), (auction seller, date_time)
    of the port generator."""
    return (table_stream(dev, "person", max_events,
                         ("id", "name", "date_time")),
            table_stream(dev, "auction", max_events,
                         ("seller", "date_time")))


def check_q8_rows(rows, oracle, name_pool):
    """The MV's (id, name, starttime) against the oracle's rows, names
    through the source's surrogate pool."""
    index = {nm: i for i, nm in enumerate(name_pool)}
    got = np.array([(r[0], index[r[1]], r[2]) for r in rows],
                   np.int64).reshape(-1, 3)
    got = got[np.lexsort(got.T[::-1])]
    if not len(oracle) or got.shape != oracle.shape \
            or not np.array_equal(got, oracle):
        raise AssertionError(f"q8: {len(got)} rows differ from the oracle's "
                             f"{len(oracle)}")


def check_q8_telemetry(job, streams) -> dict:
    """Each distinct agg's telemetry against what the run holds: its
    occupancy high-water sums to its live groups and equals a numpy
    histogram of its final key table (the host `vnodes_i64_plain`); its
    traffic sums to the rows it was routed (its rows_in total), which is
    every person / auction row once."""
    (pid, _, _), (seller, _) = streams
    prog = job.program
    out = {}
    aggs = [i for i, n in enumerate(prog.nodes) if isinstance(n, F.AggNode)]
    for i, rows in zip(aggs, (len(pid), len(seller))):
        st = prog.node_stats(i, job._stat_totals)
        occ = np.array([st[f"skv{b}"] for b in range(SK_BUCKETS)])
        tv = np.array([st[f"tv{b}"] for b in range(SK_BUCKETS)])
        main = inner(job.states[i]).main
        live = int(main.count)
        keys = main.keys[:live].cpu().numpy()
        hist = np.bincount(vnodes_i64_plain(keys) * SK_BUCKETS // 256,
                           minlength=SK_BUCKETS)
        if occ.sum() != live or not np.array_equal(occ, hist):
            raise AssertionError(f"q8 node {i}: occupancy {occ.tolist()} vs "
                                 f"{live} live groups {hist.tolist()}")
        if tv.sum() != st["rows_in"] or tv.sum() != rows:
            raise AssertionError(f"q8 node {i}: traffic {int(tv.sum())} vs "
                                 f"rows_in {st['rows_in']}, {rows} rows")
        out[f"{i}:AggNode"] = {"live_groups": live, "routed_rows": rows}
    return out


def telemetry_line(name, job) -> dict:
    """Each keyed node's skew_ratio row and rank-0 hot_key row."""
    rows = {}
    for r in job.skew_report():
        if r[2] == "skew_ratio" or (r[2] == "hot_key" and r[3] == 0):
            rows.setdefault(f"{r[0]}:{r[1]}", {})[r[2]] = \
                [r[4], r[5], r[6]]
    return {"telemetry": name, "nodes": rows}


def node_times(job, keep=(), at=None):
    """One more epoch with a CUDA-event pair around each node's step (the
    result is discarded): per-node milliseconds, and the input deltas of
    the nodes in `keep` (index -> [Delta]). The epoch runs over `at`
    (states, first event id): by default the final state and the
    stream's first epoch."""
    prog = job.program
    evs = []
    kept = {}
    for i, node in enumerate(prog.nodes):
        orig = node.apply

        def timed(*a, _orig=orig, _evs=evs, _n=type(node).__name__, _i=i):
            if _i in keep:
                kept[_i] = a[1]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _orig(*a)
            e1.record()
            _evs.append((_n, e0, e1))
            return out
        node.apply = timed
    prog.epoch(*(at or (job.states, 0)))
    torch.cuda.synchronize()
    for node in prog.nodes:
        del node.apply
    return [(n, e0.elapsed_time(e1)) for n, e0, e1 in evs], kept


def telemetry_cost(job, rounds: int = 9, at=None) -> dict:
    """Per keyed node: the median of `rounds` node times of one epoch
    (`node_times`' `at`) with its telemetry armed and with it disarmed
    (in turns), and their difference."""
    prog = job.program
    keyed = [i for i, n in enumerate(prog.nodes) if n.skew or n.flow]
    armed = {i: [] for i in keyed}
    bare = {i: [] for i in keyed}
    for _ in range(rounds):
        for on, acc in ((True, armed), (False, bare)):
            for i in keyed:
                prog.nodes[i].skew = prog.nodes[i].flow = on
            ms, _ = node_times(job, at=at)
            for i in keyed:
                acc[i].append(ms[i][1])
    for i in keyed:
        prog.nodes[i].skew = prog.nodes[i].flow = True
    out = {}
    for i in keyed:
        a, b = float(np.median(armed[i])), float(np.median(bare[i]))
        out[f"{i}:{type(prog.nodes[i]).__name__}"] = dict(
            armed_ms=a, bare_ms=b, telemetry_ms=a - b)
    return out


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def lib_batch_reduce(keys, mask, vals, kinds):
    """PyTorch library composition: stable sort, unique_consecutive,
    scatter_reduce per column (SUM / MIN / MAX kinds)."""
    mk = torch.where(mask, keys, EMPTY_KEY)
    sk, perm = torch.sort(mk, stable=True)
    uk, inv = torch.unique_consecutive(sk, return_inverse=True)
    n, u = keys.shape[0], uk.shape[0]
    ukeys = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=keys.device)
    ukeys[:u] = uk
    outs = []
    red = {S: "sum", MN: "amin", MX: "amax"}
    for v, k in zip(vals, kinds):
        r = torch.full((n,), _neutral(k, v.dtype), dtype=v.dtype,
                       device=v.device)
        r[:u] = torch.zeros(u, dtype=v.dtype, device=v.device).scatter_reduce(
            0, inv, v[perm], red[k], include_self=False)
        outs.append(torch.where(ukeys == EMPTY_KEY, _neutral(k, v.dtype), r))
    return ukeys, outs


def lib_merge(state, dkeys, dvals, kinds):
    """PyTorch library composition: cat, stable sort with gather, the
    shifted combine, nonzero compaction."""
    c = state.capacity
    keys = torch.cat([state.keys, dkeys])
    sk, perm = torch.sort(keys, stable=True)
    same_next = torch.zeros_like(sk, dtype=torch.bool)
    same_next[:-1] = sk[:-1] == sk[1:]
    alive = sk != EMPTY_KEY
    alive[1:] &= ~same_next[:-1]
    vals = []
    for sv, dv, k in zip(state.vals, dvals, kinds):
        v = torch.cat([sv, dv])[perm]
        nxt = torch.cat([v[1:], v[-1:]])
        comb = v + nxt if k == S else torch.maximum(v, nxt)
        vals.append(torch.where(same_next, comb, v))
    alive &= vals[0] != 0
    idx = torch.nonzero(alive).squeeze(1)[:c]
    out = [torch.full((c,), EMPTY_KEY, dtype=torch.int64, device=sk.device)]
    out[0][:idx.shape[0]] = sk[idx]
    for v, k in zip(vals, kinds):
        o = torch.full((c,), _neutral(k, v.dtype), dtype=v.dtype,
                       device=v.device)
        o[:idx.shape[0]] = v[idx]
        out.append(o)
    return out


def lib_compact(alive, cols, out_len, fills):
    """PyTorch library composition: nonzero, then index."""
    idx = torch.nonzero(alive).squeeze(1)[:out_len]
    outs = []
    for c, f in zip(cols, fills):
        o = torch.full((min(out_len, c.shape[0]),), f, dtype=c.dtype,
                       device=c.device)
        o[:idx.shape[0]] = c[idx]
        outs.append(o)
    return outs


def timings(dev, final_caps) -> dict:
    """Each kernel at the main path's shapes: sort and batch_reduce at an
    epoch of 2^20 rows (the pre-combine's 7 columns), merge at the final
    agg capacity with a 2^20-row delta, compact_rows at that merge's
    C + B rows."""
    rng = np.random.default_rng(7)
    n = EPOCH_EVENTS
    out = {}
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(MAX_EVENTS - n, MAX_EVENTS, dtype=torch.int64,
                       device=dev)
    keys = gen_table(gencfg, "bid", ids)["auction"] - 1000
    mask = table_mask("bid", ids)
    vals = [payload(rng, n, torch.int64).to(dev) for _ in range(7)]
    kinds = [S, S, S, S, S, MX, S]
    mk = torch.where(mask, keys, EMPTY_KEY)

    out["sort_cols"] = dict(
        ms=median_ms(lambda: K.sort_cols([mk], [])),
        device_ms=graph_ms(lambda: K.sort_cols([mk], [])),
        plain_ms=median_ms(lambda: K.sort_cols_plain([mk], [])),
        library_ms=median_ms(lambda: torch.sort(mk, stable=True)),
        bound_ms=bound_ms(8 * n + 16 * n), bound_by="bytes")
    out["batch_reduce"] = dict(
        ms=median_ms(lambda: K.batch_reduce(keys, mask, vals, kinds)),
        device_ms=graph_ms(lambda: K.batch_reduce(keys, mask, vals, kinds)),
        plain_ms=median_ms(lambda: K.batch_reduce_plain(keys, mask, vals,
                                                        kinds)),
        library_ms=median_ms(lambda: lib_batch_reduce(keys, mask, vals,
                                                      kinds)),
        bound_ms=bound_ms(9 * n + 8 * 7 * n + 8 * n + 8 * 7 * n + 4),
        bound_by="bytes")

    c = final_caps
    spec = [(S, torch.int64)] * 4 + [(MX, torch.int64), (S, torch.int64)]
    live = min(c, 1 << 20)
    skeys = sorted_unique(rng, live, 0, 1 << 21)
    st = make_sorted_state(rng, c, skeys, spec, dev)
    dk_np = np.full(n, EMPTY_KEY, np.int64)
    d = sorted_unique(rng, 300_000, 0, 1 << 21)
    dk_np[:len(d)] = d
    dk = torch.from_numpy(dk_np).to(dev)
    dv = [torch.where(dk != EMPTY_KEY, v, 0)
          for v in (payload(rng, n, torch.int64).abs().to(dev) + 1
                    for _ in spec)]
    mkinds = [k for k, _ in spec]
    ncol = len(spec)
    _, mem = call_memory(lambda: K.merge(st, dk, dv, mkinds))
    # the kernel stops at the first tile whose merged rows are all EMPTY:
    # the data needs each run's live rows read once and C rows written
    out["merge"] = dict(
        ms=median_ms(lambda: K.merge(st, dk, dv, mkinds)),
        device_ms=graph_ms(lambda: K.merge(st, dk, dv, mkinds)),
        plain_ms=median_ms(lambda: K.merge_plain(st, dk, dv, mkinds)),
        library_ms=median_ms(lambda: lib_merge(st, dk, dv, mkinds)),
        bound_ms=bound_ms(8 * (1 + ncol) * (len(skeys) + len(d) + c) + 4),
        bound_by="bytes", shape=f"C={c} ({len(skeys)} live), B={n} "
        f"({len(d)} live) x {ncol} int64", memory=mem)

    m = c + n
    alive = torch.from_numpy(rng.random(m) < (live + len(d)) / m).to(dev)
    ccols = [torch.from_numpy(rand_keys(rng, m, 0, 1 << 40)).to(dev)] + \
        [payload(rng, m, torch.int64).to(dev) for _ in range(ncol)]
    fills = [EMPTY_KEY] + [0] * ncol
    n_alive = int(alive.sum())
    kept = min(n_alive, c)
    out["compact_rows"] = dict(
        ms=median_ms(lambda: K.compact_rows(alive, ccols[:1], ccols[1:], c,
                                            fills)),
        device_ms=graph_ms(lambda: K.compact_rows(alive, ccols[:1], ccols[1:], c,
                                            fills)),
        plain_ms=median_ms(lambda: K.compact_rows_plain(
            alive, ccols[:1], ccols[1:], c, fills)),
        library_ms=median_ms(lambda: lib_compact(alive, ccols, c, fills)),
        bound_ms=bound_ms(m + 8 * (1 + ncol) * (kept + c) + 4),
        bound_by="bytes")
    return out

def expr_entry(prog, tree, cols, mask, nbytes, **extra) -> dict:
    """One program's times: the kernel (host call and device, by CUDA
    graph), its plain version, and the eager torch composition of the
    tree (`eval_device`, the same ops as the plain version's: there is no
    one library call for an expression) as `library_ms`; the bound is
    each input column read once and each output written once."""
    run = lambda: K.expr_eval.expr_eval(prog, cols, mask)   # noqa: E731
    if mask is None:
        lib = lambda: tree.eval_device(cols)                # noqa: E731
    else:
        def lib():
            v, ok = tree.eval_device(cols)
            return mask & v & ok
    return dict(ms=median_ms(run), device_ms=graph_ms(run),
                plain_ms=median_ms(lambda: K.expr_eval_plain(prog, cols,
                                                             mask)),
                library_ms=median_ms(lib),
                library="the tree's eager torch ops (eval_device)",
                bound_ms=bound_ms(nbytes), bound_by="bytes",
                instructions=len(prog.ins),
                folded=len(getattr(prog, "code", prog.ins)), **extra)


def expr_timings(dev) -> dict:
    """expr_eval at the main paths' shapes, over the bid generator's last
    epoch of 2^20 events: q2c's Filter (the row; auction read, mask in
    and out), q1c's Map (price read, two int64 outputs), q3a's price
    filter, q5's join condition and q7's time bounds (int64 columns)."""
    n = EPOCH_EVENTS
    ids = torch.arange(MAX_EVENTS - n, MAX_EVENTS, dtype=torch.int64,
                       device=dev)
    gencfg = GenCfg.from_config(NexmarkConfig())
    gen = gen_table(gencfg, "bid", ids)
    cols = [gen[c] for c, _ in BID_COLS[:-1]] + [ids]
    mask = table_mask("bid", ids)
    f2 = q2c_job(dev, 1 << 20).program.nodes[0].chain[1]
    m1 = q1c_job(dev, 1 << 20).program.nodes[0].chain[1]
    out = expr_entry(f2.lowered.declared, f2.pred, cols, mask, 10 * n,
                     shape=f"q2c Filter over {n} rows")
    computed = [e for e in m1.exprs if not isinstance(e, InputRef)]
    out["q1c_map"] = expr_entry(
        m1.lowered.declared, _Outs(computed), cols, None, 24 * n,
        shape=f"q1c Map over {n} rows, 2 int64 outputs")
    rng = np.random.default_rng(5)
    for name, job, kind in (("q3a_filter", q3a_job(dev, 1 << 20), "filter"),
                            ("q5_cond", q5_job(dev, 1 << 20), "cond"),
                            ("q7_filter", q7_job(dev, 1 << 20), "filter")):
        nodes = [x for nd in job.program.nodes
                 for x in getattr(nd, "chain", [nd])]
        node = [x for x in nodes if (kind == "filter"
                                     and isinstance(x, F.FilterNode))
                or (kind == "cond" and isinstance(x, F.JoinNode)
                    and x.cond is not None)][0]
        low = node.lowered if kind == "filter" else node.cond_lowered
        tree = node.pred if kind == "filter" else node.cond
        prog = low.declared
        pc = program_columns(rng, prog, n, dev)
        out[name] = expr_entry(prog, tree, pc, mask,
                               (8 * len(prog.inputs) + 2) * n,
                               shape=f"{len(prog.inputs)} int64 columns, "
                               f"{n} rows")
    return out


class _Outs:
    """A Map's computed expressions as one `eval_device` (their values)."""

    def __init__(self, exprs):
        self.exprs = exprs

    def eval_device(self, cols):
        return [e.eval_device(cols)[0] for e in self.exprs]



def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of `fn`: `reps` calls captured in
    a CUDA graph, the replay timed by `median_ms`, divided by `reps` —
    the host's launch path (Python, ctypes) left out. `fn` must not
    synchronise."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return median_ms(g.replay, runs=11) / reps


def lib_vnode_hist(keys, live, weights):
    """PyTorch library composition: the CRC by int64 ops, then one
    bincount (float counts when weighted)."""
    bucket = compute_vnodes_dev(keys).to(torch.int64) * SK_BUCKETS // 256
    live = keys != EMPTY_KEY if live is None else live
    bucket = torch.where(live, bucket, SK_BUCKETS)
    return torch.bincount(bucket, weights=weights,
                          minlength=SK_BUCKETS + 1)[:SK_BUCKETS]


def lib_topk(keys, counts):
    """PyTorch library composition: (runs mode) unique_consecutive with
    counts over the sorted keys, then the pack and torch.topk."""
    if counts is None:
        keys, counts = torch.unique_consecutive(keys, return_counts=True)
    packed = torch.where((counts > 0) & (keys != EMPTY_KEY),
                         (torch.clamp(counts, max=SK_COUNT_MAX) << 40)
                         | (keys & ((1 << 40) - 1)), 0)
    return torch.topk(packed, min(SK_TOPK, packed.shape[0])).values


def hist_entry(keys, live=None, weights=None, **extra) -> dict:
    """vnode_hist at one shape, held against its plain version first."""
    compare("vnode_hist", extra.get("shape", "main_path"),
            K.vnode_hist(keys, live, weights, EMPTY_KEY),
            K.vnode_hist_plain(keys, live, weights, EMPTY_KEY))
    n = keys.shape[0]
    nbytes = 8 * n + (0 if live is None else n) \
        + (0 if weights is None else 8 * n) + 8 * SK_BUCKETS
    return dict(ms=median_ms(lambda: K.vnode_hist(keys, live, weights,
                                                  EMPTY_KEY)),
                device_ms=graph_ms(lambda: K.vnode_hist(keys, live, weights,
                                                        EMPTY_KEY)),
                plain_ms=median_ms(lambda: K.vnode_hist_plain(
                    keys, live, weights, EMPTY_KEY)),
                library_ms=median_ms(lambda: lib_vnode_hist(keys, live,
                                                            weights)),
                bound_ms=bound_ms(nbytes), bound_by="bytes", **extra)


def node_hist_entry(segs, rows, old, **extra) -> dict:
    """vnode_hists as a keyed node calls it (one launch for its
    occupancy and traffic), held against its plain version, beside
    `old`: the sequence of one-table calls it replaces (occupancy, then
    traffic) at the same inputs."""
    compare("vnode_hist", extra["shape"], K.vnode_hists(segs, rows),
            K.vnode_hists_plain(segs, rows, EMPTY_KEY))
    nbytes = 8 * SK_BUCKETS * rows + sum(
        k.shape[0] * (8 + (lv is not None) + 8 * (w is not None))
        for k, lv, w, _ in segs)
    return dict(ms=median_ms(lambda: K.vnode_hists(segs, rows)),
                device_ms=graph_ms(lambda: K.vnode_hists(segs, rows)),
                sequence_ms=median_ms(old), sequence_device_ms=graph_ms(old),
                plain_ms=median_ms(lambda: K.vnode_hists_plain(
                    segs, rows, EMPTY_KEY)),
                bound_ms=bound_ms(nbytes), bound_by="bytes", **extra)


def topk_entry(keys, counts=None, **extra) -> dict:
    """topk_packed at one shape, held against its plain version first. In
    runs mode its bound counts the keys before the EMPTY_KEY tail (the
    kernel stops at the first tile that starts in it);
    `every_row_bound_ms` counts every row."""
    compare("topk_packed", extra.get("shape", "main_path"),
            K.topk_packed(keys, counts),
            K.topk_packed_plain(keys, counts, EMPTY_KEY))
    n = keys.shape[0]
    row = 16 if counts is not None else 8
    need = n if counts is not None else min(
        n, int((keys != EMPTY_KEY).sum()) + 1)
    return dict(ms=median_ms(lambda: K.topk_packed(keys, counts)),
                device_ms=graph_ms(lambda: K.topk_packed(keys, counts)),
                plain_ms=median_ms(lambda: K.topk_packed_plain(
                    keys, counts, EMPTY_KEY)),
                library_ms=median_ms(lambda: lib_topk(keys, counts)),
                cuda_launches_per_call=topk_launches(keys, counts),
                bound_ms=bound_ms(row * need + 32),
                every_row_bound_ms=bound_ms(row * n + 32), bound_by="bytes",
                **extra)


def skew_timings(job, kept, ai, ji) -> dict:
    """The telemetry kernels on the q8 job's final state, fed the inputs
    its nodes saw in `node_times`' extra epoch (`ai`: the person agg,
    `ji`: the join): vnode_hist as the occupancy of the agg's key table
    and as the weighted traffic of its pre-combined input; topk_packed
    weighted over that input's (key, raw-row count) rows and in runs mode
    over the join's two sorted input deltas."""
    d = kept[ai][0]
    keys, cnt = d.cols[0], d.cols[1]
    live = d.mask & (d.sign != 0)
    table = inner(job.states[ai]).main.keys
    occ = hist_entry(table, shape=f"occupancy C={table.shape[0]}",
                     live_keys=int(inner(job.states[ai]).main.count))
    occ["traffic_weighted"] = hist_entry(
        keys, live, cnt.abs(), shape=f"traffic B={keys.shape[0]}, weighted",
        live_rows=int(live.sum()))
    ukeys, (ucnt,), _ = K.batch_reduce(keys, live, [cnt], [S])
    top = topk_entry(ukeys, ucnt, shape=f"weighted B={ukeys.shape[0]}")
    jn = job.program.nodes[ji]
    dl, dr = kept[ji]
    jk = torch.cat([jn.pack.pack([dl.cols[i] for i in jn.l_keys]),
                    jn.pack.pack([dr.cols[i] for i in jn.r_keys])])
    jlive = torch.cat([dl.mask & (dl.sign != 0), dr.mask & (dr.sign != 0)])
    (sk,), _ = K.sort_cols([torch.where(jlive, jk, EMPTY_KEY)], [])
    occ["traffic_join"] = hist_entry(jk, jlive, shape=f"traffic B="
                                     f"{jk.shape[0]}")
    # each node's one call against the two (agg) or three (join)
    # one-table calls it replaces, at the same inputs
    w = cnt.abs()
    occ["node_call_agg"] = node_hist_entry(
        [(table, None, None, 0), (keys, live, w, 1)], 2,
        lambda: (K.vnode_hist(table), K.vnode_hist(keys, live, w)),
        shape=f"agg: occupancy C={table.shape[0]} + weighted traffic "
        f"B={keys.shape[0]}")
    sa, sb = inner(job.states[ji])
    occ["node_call_join"] = node_hist_entry(
        [(sa.jk, None, None, 0), (sb.jk, None, None, 0), (jk, jlive, None,
                                                          1)], 2,
        lambda: (K.vnode_hist(sb.jk, out=K.vnode_hist(sa.jk)),
                 K.vnode_hist(jk, jlive)),
        shape=f"join: occupancy C={sa.jk.shape[0]} + {sb.jk.shape[0]}, "
        f"traffic B={jk.shape[0]}")
    top["runs_join"] = topk_entry(sk, shape=f"runs B={sk.shape[0]}",
                                  live_rows=int(jlive.sum()))
    return {"vnode_hist": occ, "topk_packed": top}


def _two_key_perm(k1, k2):
    """Stable order by (k1, k2) from two stable library sorts."""
    p1 = torch.sort(k2, stable=True).indices
    return p1[torch.sort(k1[p1], stable=True).indices]


def lib_batch_reduce_rows(jk, pk, signs, mask, vals):
    """PyTorch library composition: two stable sorts, unique_consecutive
    over the (jk, pk) pairs, index_add of the signs, a gather of each
    segment's last row."""
    n = jk.shape[0]
    mjk = torch.where(mask, jk, EMPTY_KEY)
    mpk = torch.where(mask, pk, EMPTY_KEY)
    perm = _two_key_perm(mjk, mpk)
    pairs = torch.stack([mjk[perm], mpk[perm]], 1)
    u, inv, cnt = torch.unique_consecutive(pairs, dim=0, return_inverse=True,
                                           return_counts=True)
    nseg = u.shape[0]
    usign = torch.zeros(n, dtype=torch.int32, device=jk.device).index_add_(
        0, inv, torch.where(mask, signs, 0).to(torch.int32)[perm])
    ujk = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=jk.device)
    upk = ujk.clone()
    ujk[:nseg], upk[:nseg] = u[:, 0], u[:, 1]
    # a segment's last row; row 0 for masked rows and the padding
    src = torch.full((n,), 0, dtype=torch.int64, device=jk.device)
    src[:nseg] = torch.cumsum(cnt, 0) - 1
    src = perm[torch.where(ujk != EMPTY_KEY, src, 0)]
    return (ujk, upk, torch.where(ujk != EMPTY_KEY, usign, 0),
            [v[src] for v in vals])


def lib_merge_side(side, djk, dpk, dsign, dvals):
    """PyTorch library composition: cat, two stable sorts with gathers,
    the shifted presence combine, nonzero compaction."""
    c = side.jk.shape[0]
    jk, pk = torch.cat([side.jk, djk]), torch.cat([side.pk, dpk])
    perm = _two_key_perm(jk, pk)
    jk, pk = jk[perm], pk[perm]
    pres = torch.cat([(side.jk != EMPTY_KEY).to(torch.int32), dsign])[perm]
    same = (jk[:-1] == jk[1:]) & (pk[:-1] == pk[1:])
    nxt_p = torch.cat([pres[1:], pres[-1:]])
    same_next = torch.cat([same, same[:1] & False])
    pres_m = torch.where(same_next, torch.clamp(pres + nxt_p, 0, 1), pres)
    take = same_next & (nxt_p > 0)
    alive = (jk != EMPTY_KEY) & (pres_m > 0)
    alive[1:] &= ~same
    idx = torch.nonzero(alive).squeeze(1)[:c]
    k = idx.shape[0]
    out = []
    for col, fill in [(jk, EMPTY_KEY), (pk, EMPTY_KEY)] + [
            (torch.cat([sv, dv])[perm], 0)
            for sv, dv in zip(side.vals, dvals)]:
        if fill == 0:
            col = torch.where(take, torch.cat([col[1:], col[-1:]]), col)
        o = torch.full((c,), fill, dtype=col.dtype, device=col.device)
        o[:k] = col[idx]
        out.append(o)
    return out


def lib_probe(side_jk, qjk, qmask, m):
    """PyTorch library composition: two searchsorted, cumsum, a
    searchsorted of the slots over the offsets, gathers."""
    q = torch.where(qmask, qjk, EMPTY_KEY)
    lo = torch.searchsorted(side_jk, q)
    hi = torch.searchsorted(side_jk, q, right=True)
    off = torch.cumsum(torch.where(qmask & (q != EMPTY_KEY), hi - lo, 0), 0)
    t = torch.arange(m, device=qjk.device)
    row = torch.clamp(torch.searchsorted(off, t, right=True), 0,
                      q.shape[0] - 1)
    prev = torch.where(row > 0, off[row - 1], 0)
    sidx = torch.clamp(lo[row] + t - prev, 0, side_jk.shape[0] - 1)
    return row.to(torch.int32), sidx, t < off[-1], off[-1]


def rows_split(jk, pk, signs, mask, vals) -> dict:
    """batch_reduce_rows' two parts apart: its two-key sort, and the
    reduce kernels on that sort's output."""
    mjk = torch.where(mask, jk, EMPTY_KEY)
    mpk = torch.where(mask, pk, EMPTY_KEY)
    perm, sk = K._sort_perm([mjk, mpk])
    sign = signs.to(torch.int32).contiguous()
    vals = [v.contiguous() for v in vals]

    def reduce():
        return K.binding.reduce_rows(sk, mpk, perm, sign, vals)
    return dict(sort_ms=median_ms(lambda: K._sort_perm([mjk, mpk])),
                sort_device_ms=graph_ms(lambda: K._sort_perm([mjk, mpk])),
                reduce_ms=median_ms(reduce), reduce_device_ms=graph_ms(reduce))


def call_memory(fn):
    """(fn's result, its device memory): the peak bytes one call of `fn`
    allocates beyond what was allocated before it, its outputs' bytes,
    and the difference — its temporaries."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = torch.cuda.memory_allocated() - base
    return out, dict(peak_bytes=peak, output_bytes=kept,
                     temp_bytes=peak - kept)


def merge_side_memory(dev) -> dict:
    """merge_side's device memory at the timing shape (`call_memory`), on
    inputs made on the card from a seed: a 2^23-slot side holding
    7,700,000 rows x 8 int64 columns, a delta of 2^20 slots with 964,689
    inserts."""
    c, b, live, nd, k = 1 << 23, 1 << 20, 7_700_000, 964_689, 8
    g = torch.Generator(device=dev)
    g.manual_seed(5)

    def run(cap, n, pk0):
        jk = torch.full((cap,), EMPTY_KEY, dtype=torch.int64, device=dev)
        pk = jk.clone()
        jk[:n] = torch.sort(torch.randint(0, 1 << 19, (n,), device=dev,
                                          generator=g)).values
        pk[:n] = pk0 + torch.arange(n, device=dev)   # ascending within a jk
        vals = [torch.randint(-10**6, 10**6, (cap,), device=dev, generator=g)
                for _ in range(k)]
        return jk, pk, vals
    sjk, spk, svals = run(c, live, 0)
    side = JoinSide(sjk, spk, torch.tensor(live, dtype=torch.int32,
                                           device=dev), tuple(svals))
    djk, dpk, dvals = run(b, nd, live)
    dsign = (djk != EMPTY_KEY).to(torch.int32)
    out, mem = call_memory(lambda: K.merge_side(side, djk, dpk, dsign,
                                                dvals))
    if int(out[1]) != live + nd:
        raise AssertionError(f"merge_side memory: needed {int(out[1])}")
    return dict(shape=f"C={c} ({live} live), B={b} ({nd} live) x {k} int64",
                **mem)


def join_timings(dev, job) -> dict:
    """The three join kernels on the q3a job's final state, fed the next
    epoch of the generator's bids: batch_reduce_rows on the epoch's 2^20
    bid rows x 8 columns (and, under "netting", on that epoch's 2m pair
    rows x 19 columns), merge_side of the reduced bids into the bid side
    at its final capacity, probe of the auction side by the reduced bids
    with the final pair capacity m."""
    rng = np.random.default_rng(11)
    jn = job.program.nodes[2]
    a, b = inner(job.states[2])
    n = EPOCH_EVENTS
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(Q3_EVENTS, Q3_EVENTS + n, dtype=torch.int64,
                       device=dev)
    cols = gen_table(gencfg, "bid", ids)
    vals = [ids if nm == "_row_id" else cols[nm] for nm, _ in BID_COLS]
    jk = jn.pack.pack([cols["auction"]])
    sign = torch.ones(n, dtype=torch.int32, device=dev)
    mask = table_mask("bid", ids)
    args = (jk, ids, sign, mask, vals)
    k = len(vals)
    # sort_cols on the (jk, pk) pairs batch_reduce_rows sorts
    sk1 = torch.where(mask, jk, EMPTY_KEY)
    sk2 = torch.where(mask, ids, EMPTY_KEY)
    idx = torch.arange(n, device=dev)
    compare("sort_cols", "q3a_jk_pk", K.sort_cols([sk1, sk2], [idx]),
            K.sort_cols_plain([sk1, sk2], [idx]))
    out = {"sort_cols": dict(
        ms=median_ms(lambda: K.sort_cols([sk1, sk2], [])),
        device_ms=graph_ms(lambda: K.sort_cols([sk1, sk2], [])),
        plain_ms=median_ms(lambda: K.sort_cols_plain([sk1, sk2], [])),
        library_ms=median_ms(lambda: _two_key_perm(sk1, sk2)),
        bound_ms=bound_ms(16 * n + 16 * n), bound_by="bytes",
        shape=f"2 keys x {n} (jk, pk)",
        library_note="two stable torch.sort calls: no one-call form")}
    out["batch_reduce_rows"] = dict(
        ms=median_ms(lambda: K.batch_reduce_rows(*args)),
        device_ms=graph_ms(lambda: K.batch_reduce_rows(*args)),
        plain_ms=median_ms(lambda: K.batch_reduce_rows_plain(*args)),
        library_ms=median_ms(lambda: lib_batch_reduce_rows(*args)),
        bound_ms=bound_ms(n * (8 + 8 + 4 + 1 + 8 * k)
                          + n * (8 + 8 + 4 + 8 * k)),
        bound_by="bytes", shape=f"B={n} x {k} int64", **rows_split(*args))
    dajk, dapk, dasign, davals = K.batch_reduce_rows(*args)
    c = a.jk.shape[0]
    margs = (a, dajk, dapk, dasign, davals)
    out["merge_side"] = dict(
        ms=median_ms(lambda: K.merge_side(*margs)),
        device_ms=graph_ms(lambda: K.merge_side(*margs)),
        plain_ms=median_ms(lambda: K.merge_side_plain(*margs)),
        library_ms=median_ms(lambda: lib_merge_side(*margs)),
        bound_ms=bound_ms(c * (16 + 8 * k) + n * (16 + 4 + 8 * k)
                          + c * (16 + 8 * k) + 4),
        bound_by="bytes", shape=f"C={c}, B={n} x {k} int64",
        live=int(a.count), memory=merge_side_memory(dev))
    qmask = dasign != 0
    cb, m = b.jk.shape[0], jn.m
    pargs = (b, dajk, qmask, m)
    total = int(K.probe_plain(*pargs)[3])
    out["probe"] = dict(
        ms=median_ms(lambda: K.probe(*pargs)),
        device_ms=graph_ms(lambda: K.probe(*pargs)),
        plain_ms=median_ms(lambda: K.probe_plain(*pargs)),
        library_ms=median_ms(lambda: lib_probe(b.jk, dajk, qmask, m)),
        bound_ms=bound_ms(n * 9 + cb * 8 + m * 13 + 8), bound_by="bytes",
        # an estimate, not a bound (the kernel beats it: the searches' top
        # levels stay in L2): one 32-byte sector per binary-search step,
        # per query over the side, per slot over the query offsets
        search_sectors_ms=bound_ms(32 * (n * math.log2(cb)
                                       + m * math.log2(n))),
        shape=f"C={cb}, Q={n}, m={m}", total=total)
    # the netting pass of that epoch: join_core's two pair sets
    bcols = gen_table(gencfg, "auction", ids)
    bvals = [ids if nm == "_row_id" else bcols[nm] for nm, _ in AUCTION_COLS]
    bmask = table_mask("auction", ids)
    _, _, o1, o2, _ = join_core(
        a, b, *args, jn.pack.pack([bcols["id"]]), ids, sign, bmask, bvals,
        m)
    sg = torch.cat([o1["sign"], o2["sign"]])
    nargs = (torch.cat([o1["a_pk"], o2["a_pk"]]),
             torch.cat([o1["b_pk"], o2["b_pk"]]), sg,
             torch.cat([o1["mask"], o2["mask"]]) & (sg != 0),
             [torch.cat([x, y]) for x, y in
              zip(o1["a_vals"] + o1["b_vals"], o2["a_vals"] + o2["b_vals"])])
    n2, k2 = 2 * m, len(nargs[4])
    out["batch_reduce_rows"]["netting"] = dict(
        ms=median_ms(lambda: K.batch_reduce_rows(*nargs)),
        device_ms=graph_ms(lambda: K.batch_reduce_rows(*nargs)),
        plain_ms=median_ms(lambda: K.batch_reduce_rows_plain(*nargs)),
        library_ms=median_ms(lambda: lib_batch_reduce_rows(*nargs)),
        bound_ms=bound_ms(n2 * (8 + 8 + 4 + 1 + 8 * k2)
                          + n2 * (8 + 8 + 4 + 8 * k2)),
        shape=f"B={n2} x {k2} int64", **rows_split(*nargs))
    return out


def lib_hop_expand(cols, time_col, hop, size, pk, sign, mask):
    """PyTorch library composition: repeat_interleave per column, arange
    arithmetic for the window bounds and row ids."""
    n = size // hop
    k = torch.arange(n, device=sign.device).repeat(sign.shape[0])
    first = torch.div(cols[time_col], hop, rounding_mode="floor") * hop
    start = first.repeat_interleave(n) - k * hop
    return ([c.repeat_interleave(n) for c in cols] + [start, start + size],
            pk.repeat_interleave(n) * n + k, sign.repeat_interleave(n),
            mask.repeat_interleave(n))


def lib_ms_batch_reduce(k1, k2, delta, mask):
    """PyTorch library composition: two stable sorts, unique_consecutive
    over the (k1, k2) pairs, index_add_ of the deltas."""
    n = k1.shape[0]
    m1 = torch.where(mask, k1, EMPTY_KEY)
    m2 = torch.where(mask, k2, EMPTY_KEY)
    perm = _two_key_perm(m1, m2)
    u, inv = torch.unique_consecutive(torch.stack([m1[perm], m2[perm]], 1),
                                      dim=0, return_inverse=True)
    ud = torch.zeros(n, dtype=torch.int64, device=k1.device).index_add_(
        0, inv, torch.where(mask, delta, 0)[perm])
    u1 = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=k1.device)
    u2 = u1.clone()
    u1[:u.shape[0]], u2[:u.shape[0]] = u[:, 0], u[:, 1]
    return u1, u2, torch.where(u1 == EMPTY_KEY, 0, ud)


def lib_ms_merge(ms, u1, u2, ud):
    """PyTorch library composition: cat, two stable sorts with gathers,
    the shifted compare, nonzero compaction."""
    c = ms.k1.shape[0]
    k1, k2 = torch.cat([ms.k1, u1]), torch.cat([ms.k2, u2])
    perm = _two_key_perm(k1, k2)
    k1, k2, cnt = k1[perm], k2[perm], torch.cat([ms.cnt, ud])[perm]
    same = (k1[:-1] == k1[1:]) & (k2[:-1] == k2[1:])
    merged = cnt.clone()
    merged[:-1] += torch.where(same, cnt[1:], 0)
    alive = (k1 != EMPTY_KEY) & (merged != 0)
    alive[1:] &= ~same
    idx = torch.nonzero(alive).squeeze(1)[:c]
    out = []
    for col, fill in ((k1, EMPTY_KEY), (k2, EMPTY_KEY), (merged, 0)):
        o = torch.full((c,), fill, dtype=torch.int64, device=col.device)
        o[:idx.shape[0]] = col[idx]
        out.append(o)
    return out


def ms_merge_entry(ms, u, **extra) -> dict:
    """ms_merge of the reduced delta `u` into `ms`, held against its plain
    version first. Its bound counts each run's live pairs (k1, k2 and
    count read once; the kernel stops at the first tile whose merged k1
    is EMPTY) and C rows and `needed` written; `every_row_bound_ms`
    counts every row of both runs."""
    margs = (ms,) + tuple(u)
    compare("ms_merge", extra.get("shape", "main_path"), K.ms_merge(*margs),
            K.ms_merge_plain(*margs))
    c, b = ms.k1.shape[0], u[0].shape[0]
    live_ms = int((ms.k1 != EMPTY_KEY).sum())
    live_d = int((u[0] != EMPTY_KEY).sum())
    return dict(
        ms=median_ms(lambda: K.ms_merge(*margs)),
        device_ms=graph_ms(lambda: K.ms_merge(*margs)),
        plain_ms=median_ms(lambda: K.ms_merge_plain(*margs)),
        library_ms=median_ms(lambda: lib_ms_merge(*margs)),
        bound_ms=bound_ms(24 * (live_ms + live_d) + 24 * c + 8),
        every_row_bound_ms=bound_ms(24 * c + 24 * b + 24 * c + 8),
        bound_by="bytes", live=live_ms, delta_live=live_d, **extra)


def q5_like_merge(dev):
    """A seeded stand-in for q5's ms_merge: a multiset of capacity 2^16
    holding 20,000 (window, count) pairs, and the reduced delta of
    10,485,760 change-stream rows of which 1/8 are live (q5_pairs'
    domain: at most 424 x 59 pairs)."""
    rng = np.random.default_rng(98)
    s1, s2 = unique_pairs(rng, 20_000, 424, 60)
    ms = multiset(rng, 1 << 16, s1, s2, rng.integers(1, 40, 20_000), dev)
    rows = q5_pairs(rng, 10_485_760, mask_p=0.125)
    return ms, K.ms_batch_reduce(*(_dev(np.asarray(x), dev) for x in rows))


def lib_ms_find(ms, q1, q2):
    """One searchsorted over (k1, k2) packed into one int64 key, valid only
    where every group key is in [0, 2^31) and every value in [0, 2^32)
    (the caller checks)."""
    def pack(a, b):
        return torch.where(a == EMPTY_KEY, EMPTY_KEY, (a << 32) | b)
    sk, qk = pack(ms.k1, ms.k2), pack(q1, q2)
    lo = torch.clamp(torch.searchsorted(sk, qk), max=sk.shape[0] - 1)
    found = (sk[lo] == qk) & (q1 != EMPTY_KEY)
    return found, torch.where(found, ms.cnt[lo], 0)


def _packable(k1, k2):
    live = k1 != EMPTY_KEY
    return bool(torch.all(~live | ((k1 >= 0) & (k1 < (1 << 31))
                                   & (k2 >= 0) & (k2 < (1 << 32)))))


def ms_find_entry(ms, q1, q2, **extra) -> dict:
    """ms_find of (q1, q2) in `ms`, held against its plain version (and
    the library's where the pairs pack) first. Its bound counts what the
    data needs: q1, found and count for every query, q2 for the live
    ones, the multiset once; `every_row_bound_ms` q2 for every query
    too."""
    fargs = (ms, q1, q2)
    case = extra.get("shape", "timing")
    compare("ms_find", case, K.ms_find(*fargs), K.ms_find_plain(*fargs))
    c, b = ms.k1.shape[0], q1.shape[0]
    live = int((q1 != EMPTY_KEY).sum())
    lib = None
    if _packable(ms.k1, ms.k2) and _packable(q1, q2):
        compare("ms_find", f"{case} library", lib_ms_find(*fargs),
                K.ms_find_plain(*fargs))
        lib = median_ms(lambda: lib_ms_find(*fargs))
    return dict(
        ms=median_ms(lambda: K.ms_find(*fargs)),
        device_ms=graph_ms(lambda: K.ms_find(*fargs)),
        plain_ms=median_ms(lambda: K.ms_find_plain(*fargs)),
        library_ms=lib,
        bound_ms=bound_ms(24 * c + 8 * b + 8 * live + 9 * b),
        every_row_bound_ms=bound_ms(24 * c + 16 * b + 9 * b),
        bound_by="bytes", live_queries=live,
        library_note=None if lib is not None else
        "no one-call library form: the pairs do not pack into one int64",
        **extra)


def msf_dense(dev):
    """ms_find's dense timing shape: `msf_cases`' q5 multiset (C = 2^14,
    12,000 pairs) and 2^21 queries, every one live, in random order."""
    rng = np.random.default_rng(1239)
    s1, s2 = unique_pairs(rng, 12_000, 424, 60)
    ms = multiset(rng, 1 << 14, s1, s2, rng.integers(1, 40, len(s1)), dev)
    q1, q2, _, _ = q5_pairs(rng, 1 << 21)
    return ms, _dev(q1, dev), _dev(q2, dev)


def window_multiset_timings(job, kept, hi, ai) -> dict:
    """The window and multiset kernels on the q5 job's final state, fed
    the inputs its nodes saw in `node_times`' extra epoch: hop_expand on
    the source's 2^20 rows x 8 columns (HOP 2 s / 10 s, n = 5);
    ms_batch_reduce on the retractable max agg's change-stream input;
    ms_merge of that reduced delta into the final multiset; ms_find of
    the delta's pairs in the merged multiset (`hi`, `ai`: the indices of
    the first HopNode and of the retractable max agg). Each kernel is
    also held against its plain version at these main-path shapes."""
    hn = job.program.nodes[hi]
    d = kept[hi][0]
    hargs = (d.cols, hn.time_col, hn.hop, hn.size, d.pk, d.sign, d.mask)
    rows, k, n = d.sign.shape[0], len(d.cols), hn.n
    compare("hop_expand", "q5_main_path", hop_leaves(K.hop_expand(*hargs)),
            hop_leaves(K.hop_expand_plain(*hargs)))
    out = {"hop_expand": dict(
        ms=median_ms(lambda: K.hop_expand(*hargs)),
        device_ms=graph_ms(lambda: K.hop_expand(*hargs)),
        plain_ms=median_ms(lambda: K.hop_expand_plain(*hargs)),
        library_ms=median_ms(lambda: lib_hop_expand(*hargs)),
        bound_ms=bound_ms(rows * (8 * k + 8 + 4 + 1)
                          + rows * n * (8 * k + 16 + 8 + 4 + 1)),
        bound_by="bytes", shape=f"{rows} x {k} int64, n={n}")}
    an = job.program.nodes[ai]
    d = kept[ai][0]
    keys = an.pack.pack([d.cols[i] for i in an.group_idx])
    s64 = torch.where(d.mask, d.sign, 0).to(torch.int64)
    bargs = (keys, d.cols[an.calls[0].arg], s64, d.mask)
    b = keys.shape[0]
    compare("ms_batch_reduce", "q5_main_path", K.ms_batch_reduce(*bargs),
            K.ms_batch_reduce_plain(*bargs))
    # the two-key sort it starts with, on the same masked pairs
    sk1 = torch.where(d.mask, keys, EMPTY_KEY)
    sk2 = torch.where(d.mask, bargs[1], EMPTY_KEY)
    out["ms_batch_reduce"] = dict(
        ms=median_ms(lambda: K.ms_batch_reduce(*bargs)),
        device_ms=graph_ms(lambda: K.ms_batch_reduce(*bargs)),
        plain_ms=median_ms(lambda: K.ms_batch_reduce_plain(*bargs)),
        library_ms=median_ms(lambda: lib_ms_batch_reduce(*bargs)),
        bound_ms=bound_ms(b * (8 + 8 + 8 + 1) + b * 3 * 8),
        bound_by="bytes",
        # the reduce after the sort: the sorted k1, the perm, and k2 and
        # delta through the perm each read once, the three outputs
        # written once
        reduce_bound_ms=bound_ms(b * (8 + 8 + 8 + 8) + b * 3 * 8),
        # an estimate, not a bound: the same with k2 and delta each a
        # 32-byte sector a value (the perm's gathers miss L2 at this size)
        reduce_sectors_ms=bound_ms(b * (8 + 8 + 32 + 32) + b * 3 * 8),
        # the two-key sort: both keys read, the perm and sorted k1 written
        sort_bound_ms=bound_ms(b * (16 + 16)),
        shape=f"B={b}", live=int(d.mask.sum()),
        sort_ms=median_ms(lambda: K.sort_cols([sk1, sk2], [])),
        sort_device_ms=graph_ms(lambda: K.sort_cols([sk1, sk2], [])))
    u = K.ms_batch_reduce(*bargs)
    ms = inner(job.states[ai]).minputs[0]
    c = ms.capacity
    out["ms_merge"] = ms_merge_entry(ms, u, shape=f"C={c}, B={b}")
    merged, _ = K.ms_merge(ms, *u)
    out["ms_find"] = ms_find_entry(merged, u[0], u[1],
                                   shape=f"q5_main_path C={c}, Q={b}")
    return out


def batch_reduce_few_keys(node, d) -> dict:
    """batch_reduce as `node` (a PrecombineNode, or an AggNode on raw
    rows) calls it on its epoch input `d`: with few distinct keys (a
    window per key) each segment is long, the worst case of the kernel's
    one-thread-per-segment walk."""
    keys = node.pack.pack([d.cols[i] for i in node.group_idx])
    deltas = _row_deltas(node.spec, d.sign, d.mask,
                         F._agg_inputs(node.calls, d.cols, keys))
    if isinstance(node, F.PrecombineNode):
        mask = d.mask & (d.sign != 0)
        vals = [torch.where(mask, 1, 0).to(torch.int64)] + deltas
        kinds = [S] + list(node.spec.kinds)
    else:
        mask, vals, kinds = d.mask, deltas, list(node.spec.kinds)
    args = (keys, mask, vals, kinds)
    scale = max([float(v.abs().nansum()) for v in vals
                 if v.dtype.is_floating_point] or [0.0])
    compare("batch_reduce", "few_keys", K.batch_reduce(*args),
            K.batch_reduce_plain(*args), float_atol=1e-12 * scale)
    b = keys.shape[0]
    width = sum(v.element_size() for v in vals)
    lib = None
    if all(k in (S, MN, MX) for k in kinds):
        lib = median_ms(lambda: lib_batch_reduce(*args))
    return dict(ms=median_ms(lambda: K.batch_reduce(*args)),
                device_ms=graph_ms(lambda: K.batch_reduce(*args)),
                plain_ms=median_ms(lambda: K.batch_reduce_plain(*args)),
                library_ms=lib,
                # keys and mask read, columns read, ukeys and columns written
                bound_ms=bound_ms(9 * b + width * b + 8 * b + width * b + 4),
                bound_by="bytes", shape=f"B={b} x {len(vals)}",
                live=int(mask.sum()),
                distinct_keys=int(torch.unique(keys[mask]).numel()))


def lib_touch_stamp(keys, old, old_touch, tkeys, tick, ttl):
    """PyTorch library composition: two searchsorted, gathers, where,
    two sums."""
    oi = torch.clamp(torch.searchsorted(old, keys), max=old.shape[0] - 1)
    ti = torch.clamp(torch.searchsorted(tkeys, keys), max=tkeys.shape[0] - 1)
    live = keys != EMPTY_KEY
    st = torch.where(live, torch.where(
        tkeys[ti] == keys, tick, torch.where(old[oi] == keys,
                                             old_touch[oi], 0)), 0)
    return st, live.sum(), (live & (tick - st >= ttl)).sum()


def lib_tier_partition(keys, cols, fills, dkeys):
    """PyTorch library composition: isin, then two nonzero compactions."""
    hit = torch.isin(keys, dkeys) & (keys != EMPTY_KEY)
    kept = (keys != EMPTY_KEY) & ~hit
    n = keys.shape[0]
    return lib_compact(kept, cols, n, fills), lib_compact(hit, cols, n, fills)


def touch_stamp_sectors(keys, old, tk) -> int:
    """The 32-byte sectors of old stamps the epoch form needs on these
    inputs: the stamp of the first old row of each live key of `keys`
    that the old table holds and `tk` does not (a touched key takes the
    tick). Those rows ascend with `keys`, so their sectors do too."""
    oidx = torch.searchsorted(old, keys).clamp(max=old.shape[0] - 1)
    tidx = torch.searchsorted(tk, keys).clamp(max=tk.shape[0] - 1)
    need = (keys != EMPTY_KEY) & (old[oidx] == keys) & (tk[tidx] != keys)
    rows = oidx[need]
    return int(torch.unique_consecutive(rows // 4).numel())


def touch_entry(args, **extra) -> dict:
    """touch_stamp timed on `args` (keys, old keys, old touch, touched keys,
    None, tick, ttl): the stamps' epoch form."""
    keys, old, old_touch, tk, _, tick, ttl = args
    c, c_old, t = keys.shape[0], old.shape[0], tk.shape[0]
    sectors = touch_stamp_sectors(keys, old, tk)
    return dict(
        ms=median_ms(lambda: K.touch_stamp(*args)),
        device_ms=graph_ms(lambda: K.touch_stamp(*args)),
        plain_ms=median_ms(lambda: K.touch_stamp_plain(*args, EMPTY_KEY)),
        library_ms=median_ms(lambda: lib_touch_stamp(keys, old, old_touch,
                                                     tk, tick, ttl)),
        # new, old and touched keys read once, the old stamps only where
        # this run's data needs them (whole 32-byte sectors), the stamps
        # and the counts written once
        bound_ms=bound_ms(8 * c + 8 * c_old + 8 * t + 32 * sectors
                          + 8 * c + 16),
        bound_by="bytes", stamp_sectors=sectors,
        # an estimate, not a bound (the parent's per-row searches beat
        # it): one 32-byte sector per binary-search step of each row, into
        # the old keys and into the touched keys
        search_sectors_ms=bound_ms(32 * c * (math.ceil(math.log2(c_old))
                                             + math.ceil(math.log2(t)))),
        shape=f"C={c}, T={t}", touched_live=int((tk != EMPTY_KEY).sum()),
        **extra)


def tier_timings(dev, qjob, tjob) -> dict:
    """The two tiering kernels at the main paths' shapes: touch_stamp over
    the device q3a job's final bid side (its epoch stamp: the side
    against itself, the touched keys the sort of the next epoch's bid and
    auction join keys, 2 x 2^20); tier_partition over the tiered q3a
    job's final bid side (11 columns with the touch) and a demotion
    batch of its oldest-touched join keys."""
    js = qjob.states[2]
    a, ta, tick = js.inner[0], js.touch[0], js.tick
    jn = qjob.program.nodes[2]
    n = EPOCH_EVENTS
    gencfg = GenCfg.from_config(NexmarkConfig())
    ids = torch.arange(Q3_EVENTS, Q3_EVENTS + n, dtype=torch.int64,
                       device=dev)
    jk = torch.cat([torch.where(table_mask("bid", ids), jn.pack.pack(
        [gen_table(gencfg, "bid", ids)["auction"]]), EMPTY_KEY),
        torch.where(table_mask("auction", ids), jn.pack.pack(
            [gen_table(gencfg, "auction", ids)["id"]]), EMPTY_KEY)])
    (tk,), _ = K.sort_cols([jk], [])
    args = (a.jk, a.jk, ta, tk, None, tick, TIER_TTL)
    compare("touch_stamp", "q3a_main_path", K.touch_stamp(*args),
            K.touch_stamp_plain(*args, EMPTY_KEY))
    out = {"touch_stamp": touch_entry(args, live=int(a.count))}
    # a q8 distinct's shape: unique keys, most carried, a quarter touched
    q8, q8old, q8t = q8_touch_shape(dev)
    q8touch = torch.where(q8old != EMPTY_KEY,
                          torch.randint(0, 10, q8old.shape, device=dev), 0)
    qargs = (q8, q8old, q8touch, q8t, None, tick, TIER_TTL)
    compare("touch_stamp", "q8_shape", K.touch_stamp(*qargs),
            K.touch_stamp_plain(*qargs, EMPTY_KEY))
    out["touch_stamp"]["q8_distinct"] = touch_entry(qargs)
    ts = tjob.states[2]
    b, tb = ts.inner[0], ts.touch[0]
    cols = [b.jk, b.pk] + list(b.vals) + [tb]
    fills = [EMPTY_KEY, EMPTY_KEY] + [0] * len(b.vals) + [0]
    live = int(b.count)
    order = torch.argsort(tb[:live], stable=True)
    dk = torch.unique(b.jk[:live][order[:live * 3 // 10]])
    dpad = torch.full((max(64, 1 << int(dk.shape[0] - 1).bit_length()),),
                      EMPTY_KEY, dtype=torch.int64, device=dev)
    dpad[:dk.shape[0]] = dk
    pargs = (b.jk, cols, fills, dpad, True)
    got = K.tier_partition(*pargs)
    compare("tier_partition", "q3a_tiered_main_path", list(got),
            list(K.tier_partition_plain(*pargs, EMPTY_KEY)))
    m, row = b.jk.shape[0], 8 * len(cols)
    out["tier_partition"] = dict(
        ms=median_ms(lambda: K.tier_partition(*pargs)),
        device_ms=graph_ms(lambda: K.tier_partition(*pargs)),
        plain_ms=median_ms(lambda: K.tier_partition_plain(*pargs,
                                                          EMPTY_KEY)),
        library_ms=median_ms(lambda: lib_tier_partition(b.jk, cols, fills,
                                                        dpad)),
        bound_ms=bound_ms(m * row + 8 * dpad.shape[0] + 2 * m * row + 8),
        bound_by="bytes",
        # an estimate, not a bound: one 32-byte sector per search step of
        # each row in two scan phases
        search_sectors_ms=bound_ms(32 * m * 2 * math.ceil(
            math.log2(dpad.shape[0]))),
        shape=f"C={m} x {len(cols)} int64, L={dpad.shape[0]}",
        live=live, demoted_rows=int(got[2][1]), demoted_keys=int(dk.shape[0]))
    return out


def tier_cost(job, rounds: int = 9, at=None) -> dict:
    """Per tier-armed node: the median of `rounds` node times of one epoch
    (`node_times`' `at`) with its touch arm on and off (in turns: off
    runs the node on its state without the TieredState wrapper), and
    their difference."""
    prog = job.program
    keyed = [i for i, n in enumerate(prog.nodes) if n.tier]
    states, *rest = at or (job.states, 0)
    bare_states = tuple(inner(s) for s in states)
    armed = {i: [] for i in keyed}
    bare = {i: [] for i in keyed}
    for _ in range(rounds):
        for on, st, acc in ((True, states, armed), (False, bare_states,
                                                    bare)):
            for i in keyed:
                prog.nodes[i].tier = on
            ms, _ = node_times(job, at=(st, *rest))
            for i in keyed:
                acc[i].append(ms[i][1])
    for i in keyed:
        prog.nodes[i].tier = True
    out = {}
    for i in keyed:
        a, b = float(np.median(armed[i])), float(np.median(bare[i]))
        out[f"{i}:{type(prog.nodes[i]).__name__}"] = dict(
            armed_ms=a, bare_ms=b, touch_ms=a - b)
    return out


def path_phase(name, job, events, kernels_needed, check, smi, last=None):
    """Drive one main path, check its rows, and report it (`last`: see
    `drive`)."""
    rows, drive_s, pull_s, launches, epochs = drive(job, last)
    t = time.perf_counter()
    check(rows)
    rep = {"events": events, "drive_s": drive_s, "pull_s": pull_s,
           "events_per_s": events / drive_s,
           "growth_replays": job.growth_replays, "rows": len(rows),
           "capacities": {f"{i}:{type(n).__name__}": n.cap_current()
                          for i, n in enumerate(job.program.nodes)
                          if n.cap_current()},
           "launches": launches, "epochs_dispatched": epochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    log(f"[main] {name} {json.dumps(rep)}")
    if job.growth_replays < 1:
        raise AssertionError(f"{name} main path made no growth replay")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    return rep


# ---------------------------------------------------------------------------
# q5obs: q5 profiled, traced, flight-recorded and freshness-tracked
# ---------------------------------------------------------------------------

Q5OBS_READERS = 4         # reader threads of the read-cache check
Q5OBS_READS = 16          # reads in all
Q5OBS_STRETCH = 2         # the degraded rung's cadence stretch
Q5OBS_ROUNDS = 3          # rounds of (off, on, on, off) profiler turns
NO_OPEN = "no OPEN epochs (every traced barrier committed)"


def observed_drive(job, tracer, before=None):
    """Drive `job` to the end of its stream as `Database.tick` drives a
    fused job: `before(epoch)` first (the overload manager's tick), then
    the barrier wrapped in the tracer's inject -> job_start / job_end ->
    commit, then one flight-recorder record. Returns the seconds (ends
    synced), the barriers, the checkpoints, and the epochs of the
    checkpoints that followed a dispatch (the commits freshness must
    see)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, ckpts, commits, moved = 0, 0, [], False
    for epoch, ckpt in barriers(job):
        if before is not None:
            before(epoch)
        c0 = job.counter
        span = tracer.inject(epoch, "checkpoint" if ckpt else "barrier")
        span.job_start(job.name)
        job.on_barrier(SimpleNamespace(is_checkpoint=ckpt,
                                       epoch=SimpleNamespace(curr=epoch)))
        span.job_end(job.name)
        span.commit()
        BB.RECORDER.record("barrier", {"job": job.name, "epoch": epoch,
                                       "checkpoint": ckpt})
        n += 1
        ckpts += ckpt
        moved = moved or job.counter != c0
        if ckpt and moved:
            commits.append(epoch)
            moved = False
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n, ckpts, commits


def check_profile(job, dispatching: int, path: str) -> dict:
    """(b): one record per dispatching barrier, each epoch's phases
    within [0.9, 1.001] of its wall (+ 0.05 ms) where the wall passes 1
    ms, no staging / tier / exchange time, one compile event per node,
    and the jsonl's offline summary equal to the live one."""
    prof = job.profiler
    recs = list(prof.ring)
    if len(recs) != dispatching or prof.epochs != dispatching:
        raise AssertionError(f"q5obs: {len(recs)} profile records, "
                             f"{dispatching} dispatching barriers")
    for r in recs:
        ph, wall = sum(r["ph_ms"].values()), r["wall_ms"]
        if ph > wall * 1.001 + 0.05 or (wall > 1.0 and ph < 0.9 * wall):
            raise AssertionError(f"q5obs: epoch {r['seq']} phases {ph} ms "
                                 f"against its wall {wall} ms")
        for p in ("h2d", "promote_h2d", "demote_d2h", "exchange"):
            if r["ph_ms"].get(p, 0.0) != 0.0:
                raise AssertionError(f"q5obs: epoch {r['seq']} {p} "
                                     f"{r['ph_ms'][p]} ms")
    firsts = [label.rsplit(":", 1)[0] for label, kind, _s in prof.compiles
              if kind == "compile"]
    if firsts != [f"{i}:{type(n).__name__}"
                  for i, n in enumerate(job.program.nodes)]:
        raise AssertionError(f"q5obs: compile events {firsts}")
    summ = PR.summarize_file(path)[job.name]
    live = prof.summary()
    if summ["epochs"] != live["epochs"]:
        raise AssertionError(f"q5obs: {summ['epochs']} epochs in the file, "
                             f"{live['epochs']} live")
    outside = {}
    for p in PR.PHASES:
        in_spans = sum(r["ph_ms"].get(p, 0.0) for r in recs)
        in_file = summ["phase_ms"].get(p, 0.0)
        # the file holds the records (to its 1e-3 ms rounding); the live
        # totals (to their 0.05 ms rounding) also hold what ran outside
        # any span: the drained job's last checkpoint
        extra = live["phase_s"][p] * 1e3 - in_file
        if abs(in_file - in_spans) > 1e-3 or extra < -0.051:
            raise AssertionError(f"q5obs: phase {p}: file {in_file} ms, "
                                 f"records {in_spans}, live "
                                 f"{live['phase_s'][p]} s")
        outside[p] = extra
    return {"epochs": live["epochs"], "phase_s": live["phase_s"],
            "outside_spans_ms": outside,
            "compiles": len(firsts),
            "retraces": sum(k == "retrace" for _l, k, _s in prof.compiles),
            "compile_s": live["compile_s"],
            "epoch_wall_ms": [r["wall_ms"] for r in recs]}


def check_recorder(d: str, n_barriers: int, dispatching: int,
                   checkpoints: int) -> dict:
    """(c): no open epoch in the barrier trace, a clean Chrome export,
    and a flight-recorder bundle that gives back the records written
    since the boot record."""
    msg = TR.diagnose(os.path.join(d, TR.TRACE_FILE), last=1 << 20,
                      stuck_only=True)
    if msg != NO_OPEN:
        raise AssertionError(f"q5obs: barrier trace: {msg}")
    doc = EX.export_chrome(d)
    probs = EX.validate_chrome(doc)
    if probs or not doc["traceEvents"]:
        raise AssertionError(f"q5obs: chrome export: {probs[:5]}")
    bundle = BB.RECORDER.dump("q5obs")
    got = BB.read_bundle(d, os.path.basename(bundle))
    with open(os.path.join(d, BB.RING_FILE)) as f:
        ring = [json.loads(line) for line in f]
    boot = [k for k, r in enumerate(got)
            if r["kind"] == "boot" and r.get("data_dir") == d]
    if len(boot) != 1 or got[boot[0]:] != ring:
        raise AssertionError("q5obs: the bundle's records are not the "
                             "ones written")
    kinds = {k: sum(r["kind"] == k for r in ring)
             for k in ("boot", "barrier", "epoch", "checkpoint")}
    if kinds != {"boot": 1, "barrier": n_barriers, "epoch": dispatching,
                 "checkpoint": checkpoints} or len(ring) != sum(
                     kinds.values()):
        raise AssertionError(f"q5obs: flight records {kinds} of "
                             f"{len(ring)}")
    return {"chrome_events": len(doc["traceEvents"]),
            "chrome_bytes": len(json.dumps(doc)),
            "records": kinds, "bundle_records": len(got)}


def check_read_cache(job, rows) -> dict:
    """(g): Q5OBS_READS reads from Q5OBS_READERS threads through one
    cache at the committed epoch make one device pull and each return
    `rows`; after `invalidate` the next read pulls once more."""
    cache = MVReadCache()
    pulls, got, lock = [], [], threading.Lock()

    def fill():
        pulls.append(1)
        return job.committed, job.mv_rows_now()

    def reader():
        for _ in range(Q5OBS_READS // Q5OBS_READERS):
            r = cache.get(job.name, job.committed, 0, fill)
            with lock:
                got.append(r)
    threads = [threading.Thread(target=reader)
               for _ in range(Q5OBS_READERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    if any(t.is_alive() for t in threads):
        raise AssertionError("q5obs: a reader thread did not finish")
    st = cache.stats()
    if len(pulls) != 1 or len(got) != Q5OBS_READS \
            or any(r != (job.committed, rows) for r in got):
        raise AssertionError(f"q5obs: {len(pulls)} pulls for {len(got)} "
                             "reads, or a read differs")
    cache.invalidate(job.name)
    if cache.get(job.name, job.committed, 0, fill)[1] != rows \
            or len(pulls) != 2:
        raise AssertionError("q5obs: a read after invalidate made "
                             f"{len(pulls) - 1} pulls")
    return {"pulls": len(pulls), "hits": st["hits"], "misses": st["misses"],
            "coalesced": st["coalesced"], "reads": len(got) + 1}


def stretched_drive(dev, rows, n_barriers: int) -> dict:
    """(f): a fresh profiled q5 job whose overload ladder (an
    OverloadManager over a stand-in for the database) is fed full credit
    starvation every tick: with no hold, the rung reaches `degraded` at
    the third tick and the manager's act step stretches the job's cadence
    to Q5OBS_STRETCH from then on. Rows equal `rows`, in fewer
    barriers."""
    keep = {k: getattr(ROBUSTNESS, k) for k in (
        "overload_stretch", "overload_hold_s", "overload_ladder",
        "load_shed")}
    job = q5_job(dev, profile=True)
    mgr = OverloadManager()
    db = SimpleNamespace(catalog=SimpleNamespace(objects={}),
                         _fused={job.name: job}, _remote_sets=lambda: ())
    stretches = []

    def tick(_epoch):
        PRESSURE.note("exchange_credit", ROBUSTNESS.overload_window_s)
        mgr.tick(db)
        stretches.append(job.cadence_stretch)
    try:
        ROBUSTNESS.overload_stretch = Q5OBS_STRETCH
        ROBUSTNESS.overload_hold_s = 0.0
        ROBUSTNESS.overload_ladder = True
        ROBUSTNESS.load_shed = False
        PRESSURE.reset()
        drive_s, n, _c, _f = observed_drive(job, TR.BarrierTracer(None),
                                            tick)
    finally:
        for k, v in keep.items():
            setattr(ROBUSTNESS, k, v)
        PRESSURE.reset()
    got = job.mv_rows_now()
    if stretches[:2] != [1, 1] \
            or any(x != Q5OBS_STRETCH for x in stretches[2:]):
        raise AssertionError(f"q5obs: cadence stretch {stretches}")
    if got != rows or n >= n_barriers:
        raise AssertionError(f"q5obs: stretched rows differ or {n} "
                             f"barriers >= {n_barriers}")
    return {"drive_s": drive_s, "barriers": n, "stretch": stretches,
            "profile_epochs": job.profiler.epochs,
            "state": mgr.controller(job.name).state,
            "growth_replays": job.growth_replays}


def q5obs_phase(dev, smi, q5_rows, oracle) -> dict:
    """q5 as a user's job runs it: profiled (the default), its profiler
    and a BarrierTracer on one temporary data directory, the flight
    recorder attached there (a boot record, one record a barrier), a
    FreshnessTracker as its `freshness`, each barrier wrapped in inject
    -> job_start / job_end -> commit. Checks (a)-(h) (see the docstring
    of each step); any failure raises."""
    d = tempfile.mkdtemp(prefix="rw_q5obs_")
    try:
        job = q5_job(dev, profile=True)
        job.profiler.attach(d)
        job.data_dir = d
        job.freshness = FreshnessTracker()
        tracer = TR.BarrierTracer(d)
        BB.RECORDER.attach(d)
        BB.RECORDER.record("boot", {"device": str(dev), "data_dir": d})
        steps = [0]
        step = job.program.step

        def counted(states, event_lo, acc, feeds=None):
            steps[0] += 1
            return step(states, event_lo, acc, feeds)
        job.program.step = counted
        K.reset_launches()
        drive_s, n, ckpts, commits = observed_drive(job, tracer)
        dispatching = -(-Q5_EVENTS // EPOCH_EVENTS)
        rep = {"events": Q5_EVENTS, "drive_s": drive_s,
               "events_per_s": Q5_EVENTS / drive_s, "barriers": n,
               "growth_replays": job.growth_replays}
        # (b) the profile, before any pull adds a sync outside the spans
        rep["profile"] = check_profile(job, dispatching,
                                       os.path.join(d, PR.PROFILE_FILE))
        t = time.perf_counter()
        rows = job.mv_rows_now()
        rep["pull_s"] = time.perf_counter() - t
        rep["launches"] = dict(K.LAUNCHES)
        rep["epochs_dispatched"] = steps[0]
        del job.program.step
        missing = [k for k in Q5_KERNELS if rep["launches"][k] == 0]
        if missing:
            raise AssertionError(f"q5obs path never launched {missing}")
        # (a) rows
        check_q5_rows(rows, oracle)
        if rows != q5_rows:
            raise AssertionError("q5obs rows differ from the unprofiled q5 "
                                 "path's")
        rep["rows"] = len(rows)
        # (c) trace, export, flight recorder
        rep["trace"] = check_recorder(d, n, dispatching, ckpts)
        BB.RECORDER.attach(None)
        # (d) freshness: a commit per checkpoint that followed a dispatch
        hist = job.freshness.history(job.name)
        if [h[0] for h in hist] != commits \
                or not all(0.0 < h[3] < drive_s for h in hist):
            raise AssertionError(f"q5obs: freshness {hist} against "
                                 f"checkpoints {commits}")
        fr = job.freshness.summary()[job.name]
        rep["freshness"] = {"commits": fr["commits"], "p50_s": fr["p50_s"],
                            "p99_s": fr["p99_s"],
                            "values_s": [h[3] for h in hist]}
        # (e) node report against the same job unprofiled
        off = q5_job(dev)
        run_epochs(off)

        def counts(job_):
            return [r[:6] for r in job_.node_report()]
        if counts(job) != counts(off) or off.profiler.rows() \
                or off.profiler.compiles:
            raise AssertionError("q5obs: node_report differs from the "
                                 "unprofiled job's, or it profiled")
        rep["node_report_rows"] = len(counts(job))
        del off
        # (g) the read cache, then (f) the stretched cadence
        rep["read_cache"] = check_read_cache(job, rows)
        rep["stretched"] = stretched_drive(dev, rows, n)
        del job
        # (h) the profiler's cost in turns: fresh jobs, no pull
        cost = {"off_s": [], "on_s": []}
        for on in (False, True, True, False) * Q5OBS_ROUNDS:
            j = q5_job(dev, profile=on)
            cost["on_s" if on else "off_s"].append(run_epochs(j))
            del j
        cost["median_off_s"] = float(np.median(cost["off_s"]))
        cost["median_on_s"] = float(np.median(cost["on_s"]))
        rep["profile_cost"] = cost
        rep["card"] = smi
    finally:
        BB.RECORDER.attach(None)
        shutil.rmtree(d, ignore_errors=True)
    log(f"[main] q5obs {json.dumps(rep)}")
    return rep


# ---------------------------------------------------------------------------
# the per-operator device path: executors under a StreamJob
# ---------------------------------------------------------------------------


def table_epochs(dev, table, max_events, epoch_events, names):
    """The port generator's rows of `table`, epoch by epoch: a list, one
    entry per `epoch_events` events, of numpy columns `names` (`_id`: the
    event id, the row id of the fused paths)."""
    gencfg = GenCfg.from_config(NexmarkConfig())
    out = []
    for lo in range(0, max_events, epoch_events):
        ids = torch.arange(lo, min(lo + epoch_events, max_events),
                           dtype=torch.int64, device=dev)
        m = table_mask(table, ids)
        cols = gen_table(gencfg, table, ids)
        cols["_id"] = ids
        out.append([cols[nm][m].cpu().numpy() for nm in names])
    return out


def op_chunks(cols, op=Op.INSERT):
    """int64 numpy columns as StreamChunks of OP_CHUNK rows."""
    n = len(cols[0])
    return [StreamChunk(np.full(min(OP_CHUNK, n - lo), int(op), np.int8),
                        [Column(T.INT64, c[lo:lo + OP_CHUNK]) for c in cols])
            for lo in range(0, n, OP_CHUNK)]


def op_source(names, injector, append_only):
    reader = ListReader([])
    schema = Schema.of(*[(nm, T.INT64) for nm in names])
    return reader, O.SourceExecutor(schema, reader, injector,
                                    append_only=append_only)


def q4e_graph(dev, append_only, mesh=None, capacity=CAPACITY):
    """Nexmark q4's aggregation on the per-operator path, wired as the
    SQL planner wires it (sql/planner.py `_make_hash_agg`): Source(bid:
    auction, price) -> DeviceHashAgg(GROUP BY auction: count(*),
    sum(price), max(price)) with its payload state table (and, when it
    retracts, the max's multiset table) -> Materialize(pk auction)."""
    store = MemoryStateStore()
    injector = O.BarrierInjector()
    reader, src = op_source(("auction", "price"), injector, append_only)
    calls = [SqlAggCall("count"), SqlAggCall("sum", InputRef(1, T.INT64)),
             SqlAggCall("max", InputRef(1, T.INT64))]
    st = StateTable(store, 10, [T.INT64] + device_payload_dtypes(
        calls, append_only), [0])
    mts = [StateTable(store, 11 + i, [T.INT64, T.INT64, T.INT64], [0, 1])
           for i in range(device_minput_count(calls, append_only))]
    agg = O.DeviceHashAggExecutor(src, [0], calls, state_table=st,
                                  minput_tables=mts, capacity=capacity,
                                  append_only=append_only, device=dev,
                                  mesh=mesh)
    mv = StateTable(store, 1, agg.schema.dtypes, [0])
    job = StreamJob(O.MaterializeExecutor(agg, mv), injector, store)
    return job, agg, mv, [reader]


def q4e_feeds(dev, retract, seed=4):
    """Per barrier, the chunks of each source: q4e's bids of each 2^20
    events; with `retract`, a seeded third of each epoch's bids deleted
    at the start of the next (and after the last, a barrier of deletes).
    Also returns the surviving (auction, price) for the oracle."""
    epochs = table_epochs(dev, "bid", Q4E_EVENTS, Q4E_EPOCH,
                          ("auction", "price"))
    rng = np.random.default_rng(seed)
    feeds, keep, pending = [], [], []
    for cols in epochs + ([None] if retract else []):
        chunks, pending = pending, []
        if cols is not None:
            auc, price = cols
            chunks = chunks + op_chunks([auc, price])
            alive = np.ones(len(auc), bool)
            if retract:
                gone = np.sort(rng.choice(len(auc), len(auc) // 3,
                                          replace=False))
                alive[gone] = False
                pending = op_chunks([auc[gone], price[gone]], Op.DELETE)
            keep.append((auc[alive], price[alive]))
        feeds.append([chunks])
    auc = np.concatenate([a for a, _ in keep])
    price = np.concatenate([p for _, p in keep])
    return feeds, auc, price


def q4e_oracle(auc, price):
    """numpy group-by of (auction, price) rows: count, sum, max."""
    k, (cnt, sm, mx) = groupby_reduce(auc, [("count", None), ("sum", price),
                                            ("max", price)])
    return k, cnt, sm, mx


def check_q4e_rows(name, rows, oracle):
    """MV rows (auction, count, sum, max) against a numpy group-by."""
    k, cnt, sm, mx = oracle
    got = np.array([(r[0], r[1], int(r[2]), r[3]) for r in sorted(rows)],
                   np.int64).reshape(-1, 4)
    want = np.stack([k, cnt, sm, mx], 1)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: {got.shape[0]} rows vs oracle "
                             f"{want.shape[0]}")
    if not np.array_equal(got, want):
        bad = int(np.sum(np.any(got != want, axis=1)))
        raise AssertionError(f"{name}: {bad} rows differ from the oracle")


Q3E_BID = ("auction", "price", "_id")
Q3E_AUCTION = ("id", "seller", "category", "_id")


def q3e_graph(dev, mesh=None, capacity=CAPACITY):
    """q3a's join on the per-operator path: Source(bid: auction, price,
    row id), Source(auction: id, seller, category, row id) ->
    DeviceHashJoin(auction = id, price > 500) with both sides' state
    tables (the planner's layout: row + degree) -> Materialize(pk: both
    row ids)."""
    store = MemoryStateStore()
    injector = O.BarrierInjector()
    breader, bsrc = op_source(Q3E_BID, injector, True)
    areader, asrc = op_source(Q3E_AUCTION, injector, True)
    cond = build_func("greater_than", [InputRef(1, T.INT64),
                                       Literal(500, T.INT64)])
    ls = StateTable(store, 20, [T.INT64] * (len(Q3E_BID) + 1),
                    list(range(len(Q3E_BID))))
    rs = StateTable(store, 21, [T.INT64] * (len(Q3E_AUCTION) + 1),
                    list(range(len(Q3E_AUCTION))))
    join = O.DeviceHashJoinExecutor(bsrc, asrc, [0], [0], condition=cond,
                                    left_state=ls, right_state=rs,
                                    capacity=capacity,
                                    pair_capacity=4 * capacity, device=dev,
                                    mesh=mesh)
    mv = StateTable(store, 1, join.schema.dtypes, [2, 6])
    job = StreamJob(O.MaterializeExecutor(join, mv), injector, store)
    return job, join, mv, [breader, areader]


def q3e_feeds(dev, events=Q3E_EVENTS):
    """Per barrier (every Q3E_EPOCH events), the bid and auction chunks."""
    bids = table_epochs(dev, "bid", events, Q3E_EPOCH, Q3E_BID)
    aucs = table_epochs(dev, "auction", events, Q3E_EPOCH, Q3E_AUCTION)
    return [[op_chunks(b), op_chunks(a)] for b, a in zip(bids, aucs)]


def check_q3e_rows(rows, oracle):
    """The join's MV rows, projected to q3a's columns (auction, price,
    seller, category, bid row id, auction row id), in row-id order."""
    got = np.array([(r[0], r[1], r[4], r[5], r[2], r[6]) for r in rows],
                   np.int64).reshape(-1, len(Q3A_OUT))
    check_q3a_rows(got[np.lexsort((got[:, 5], got[:, 4]))], oracle)


def time_flushes(engine, seconds):
    """Make `engine.flush_epoch` append its wall (the device step and its
    synchronised pulls) to `seconds`."""
    flush = engine.flush_epoch

    def timed():
        t = time.perf_counter()
        out = flush()
        seconds.append(time.perf_counter() - t)
        return out
    engine.flush_epoch = timed


def op_phase(name, graph, feeds, events, kernels_needed, check, smi,
             hooks=None):
    """Drive a per-operator graph barrier by barrier (each barrier's
    chunks pushed to its sources' readers, then `run_until_barrier`),
    check the MV's rows and report: the wall, each barrier's split
    between the engine's `flush_epoch` (the device step and its pulls,
    synced) and the executors' host work (the rest of the barrier's
    wall), growth replays, rows and launches (zeroed just before the
    first barrier, read just after the last). `hooks` maps a barrier's
    index to a call made right after it (its seconds are reported); an
    engine the call installs is timed from then on."""
    job, node, mv, readers = graph
    engines = []
    flush_s = []

    def wrap(engine):
        time_flushes(engine, flush_s)
        engines.append(engine)
    wrap(node.engine)
    hooks = hooks or {}
    hook_s = {}
    job.run_until_barrier()                      # the initial barrier
    torch.cuda.synchronize()
    reset_counts()
    barriers, n_flush = [], len(flush_s)
    t0 = time.perf_counter()
    for per_source in feeds:
        for reader, chunks in zip(readers, per_source):
            for c in chunks:
                reader.push(c)
        tb = time.perf_counter()
        if job.run_until_barrier() is None:
            raise AssertionError(f"{name}: the stream ended early")
        wall = time.perf_counter() - tb
        fl = sum(flush_s[n_flush:])
        n_flush = len(flush_s)
        barriers.append({"wall_s": wall, "flush_s": fl,
                         "host_s": wall - fl})
        if len(barriers) - 1 in hooks:
            hook_s[len(barriers) - 1] = hooks[len(barriers) - 1]()
            if node.engine is not engines[-1]:
                wrap(node.engine)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    native = dict(N.CALLS)
    rows = list(mv.iter_all())
    t = time.perf_counter()
    check(rows)
    flush_total = sum(b["flush_s"] for b in barriers)
    rep = {"events": events, "wall_s": wall, "events_per_s": events / wall,
           "flush_s": flush_total, "host_s": wall - flush_total,
           "flush_share": flush_total / wall, "barriers": barriers,
           "growth_replays": sum(e.growth_replays for e in engines),
           "rows": len(rows), "launches": launches,
           "native_calls": native,
           "flushes": len(barriers), "hook_s": hook_s,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    log(f"[main] {name} {json.dumps(rep)}")
    if rep["growth_replays"] < 1:
        raise AssertionError(f"{name} made no growth replay")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    return rep


# ---------------------------------------------------------------------------
# q5e: Nexmark q5 as the planner's executor graph, over the spill store
# ---------------------------------------------------------------------------


def q5e_ns(dev):
    """The port's names `q5e_graph` builds with (a test passes the JAX
    package's, with no `device=`)."""
    from risingwave_tpu_torch.connectors import nexmark as NX
    from risingwave_tpu_torch.ops import device_agg as DA
    from risingwave_tpu_torch.state import SpillStateStore
    return SimpleNamespace(
        ops=O, DeviceHashJoinExecutor=O.DeviceHashJoinExecutor, T=T,
        StateTable=StateTable, StreamJob=StreamJob,
        MemoryStateStore=MemoryStateStore, SpillStateStore=SpillStateStore,
        NexmarkConfig=NexmarkConfig, NexmarkGenerator=NX.NexmarkGenerator,
        NexmarkReader=NX.NexmarkReader, BID_SCHEMA=NX.BID_SCHEMA,
        InputRef=InputRef, AggCall=SqlAggCall, build_func=build_func,
        parse_interval=T.parse_interval,
        payload_dtypes=DA.device_payload_dtypes,
        minput_count=DA.device_minput_count, exec_kw={"device": dev})


def q5e_graph(ns, store, device, capacity=Q5E_CAPACITY,
              max_capacity=Q5E_MAX_CAPACITY, poll=Q5E_POLL):
    """Nexmark q5 (bench.py `Q5_MV`) as the executor graph the SQL
    planner builds for it, its state tables laid out as the planner's
    `make_state` lays them out (ids in the order it allocates them):
    two scans of the bid table, each HOP(2 s, 10 s) -> Project ->
    HashAgg count(*) GROUP BY (window_start, auction); the max branch
    then Project -> HashAgg max(num) GROUP BY window_start, whose input
    retracts; Join(starttime = starttime_c, num >= maxn) -> Project ->
    Materialize. With `device`, every agg is a `DeviceHashAggExecutor`
    (the max's multiset in its own table) and the join a
    `DeviceHashJoinExecutor`, each engine from `capacity` slots but the
    max agg's from `max_capacity`, as with a `DeviceConfig`
    (sql/planner.py:312-333,590-603); without, the host `HashAgg` /
    `HashJoin` the planner builds with `device=None` (:407,415,619).
    Each reader holds back what lies past its `max_events`, which the
    driver raises one barrier's worth at a time. Returns the job, the
    device executors, the MV table, the readers and every state table."""
    T_, O_ = ns.T, ns.ops
    inj = O_.BarrierInjector()
    tables, tid = [], [0]

    def make_state(dtypes, pk):
        tid[0] += 1
        t = ns.StateTable(store, tid[0], list(dtypes), list(pk))
        tables.append(t)
        return t

    def scan():
        r = ns.NexmarkReader("bid", ns.NexmarkGenerator(ns.NexmarkConfig()),
                             events_per_poll=poll, max_events=0)
        return r, O_.SourceExecutor(ns.BID_SCHEMA, r, inj, append_only=True)

    def hop(src):
        return O_.HopWindowExecutor(src, 5, ns.parse_interval("2 seconds"),
                                    ns.parse_interval("10 seconds"))

    def ref(i, kind):
        return ns.InputRef(i, getattr(T_, kind))

    devs = []

    def agg(inp, gk, calls, cap=capacity):
        gdt = [inp.schema.fields[i].dtype for i in gk]
        ao = bool(inp.append_only)
        if not device:
            st = make_state(gdt + [T_.BYTEA], range(len(gk)))
            return O_.HashAggExecutor(inp, gk, calls, state_table=st)
        st = make_state(gdt + ns.payload_dtypes(calls, ao), range(len(gk)))
        mts = [make_state(gdt + [T_.INT64, T_.INT64], range(len(gk) + 1))
               for _ in range(ns.minput_count(calls, ao))]
        a = O_.DeviceHashAggExecutor(inp, gk, calls, state_table=st,
                                     minput_tables=mts, capacity=cap,
                                     append_only=ao, **ns.exec_kw)
        devs.append(a)
        return a

    count = [ns.AggCall("count")]
    ra, sa = scan()
    a = agg(O_.ProjectExecutor(hop(sa), [ref(7, "TIMESTAMP"),
                                         ref(0, "INT64")]), [0, 1], count)
    left = O_.ProjectExecutor(a, [ref(1, "INT64"), ref(2, "INT64"),
                                  ref(0, "TIMESTAMP")])
    rb, sb = scan()
    b = agg(O_.ProjectExecutor(hop(sb), [ref(0, "INT64"),
                                         ref(7, "TIMESTAMP")]), [0, 1], count)
    m = agg(O_.ProjectExecutor(b, [ref(1, "TIMESTAMP"), ref(2, "INT64")]),
            [0], [ns.AggCall("max", ref(1, "INT64"))], max_capacity)
    right = O_.ProjectExecutor(m, [ref(1, "INT64"), ref(0, "TIMESTAMP")])
    cond = ns.build_func("greater_than_or_equal", [ref(1, "INT64"),
                                                   ref(3, "INT64")])
    ls = make_state([f.dtype for f in left.schema.fields] + [T_.INT64],
                    range(len(left.schema.fields)))
    rs = make_state([f.dtype for f in right.schema.fields] + [T_.INT64],
                    range(len(right.schema.fields)))
    if device:
        j = ns.DeviceHashJoinExecutor(left, right, [2], [1], condition=cond,
                                      left_state=ls, right_state=rs,
                                      capacity=capacity,
                                      pair_capacity=4 * capacity,
                                      **ns.exec_kw)
        devs.append(j)
    else:
        j = O_.HashJoinExecutor(left, right, [2], [1], O_.JoinType.INNER,
                                condition=cond, left_state=ls,
                                right_state=rs)
    out = O_.ProjectExecutor(j, [ref(0, "INT64"), ref(1, "INT64"),
                                 ref(2, "TIMESTAMP"), ref(4, "TIMESTAMP")])
    # the MV's pk is the planner's stream key: the join key, then each
    # side's (sql/database.py `_create_mv`, `ns.stream_key`)
    mv = make_state([f.dtype for f in out.schema.fields], [2, 0, 3])
    job = ns.StreamJob(O_.MaterializeExecutor(out, mv), inj, store)
    return job, devs, mv, [ra, rb], tables


def q5e_drive(graph, events=Q5E_EVENTS, epoch=Q5E_EPOCH, on_barrier=None):
    """The initial barrier (unless the job has passed it), then one
    checkpoint barrier per `epoch` events: both readers let `epoch` more
    events through, and the job runs until the barrier has passed the
    MV. `on_barrier(i, wall)` follows each; returns the walls."""
    job, _, _, readers, _ = graph
    if not job.barriers_seen:
        job.run_until_barrier()
    walls = []
    for i, hi in enumerate(range(epoch, events + epoch, epoch)):
        for r in readers:
            r.max_events = min(hi, events)
        t = time.perf_counter()
        b = job.run_until_barrier()
        if b is None or not b.is_checkpoint:
            raise AssertionError(f"q5e: barrier {i} did not checkpoint")
        walls.append(time.perf_counter() - t)
        if on_barrier is not None:
            on_barrier(i, walls[-1])
    return walls


def q5e_oracle(ns, events=Q5E_EVENTS):
    """numpy q5 over the bid columns the readers produce."""
    bid = ns.NexmarkGenerator(ns.NexmarkConfig()).gen_range(0, events)["bid"]
    return numpy_q5(bid.columns[0].values.astype(np.int64),
                    bid.columns[5].values.astype(np.int64))


def mv_rows(mv):
    """The MV's rows, sorted, as ints."""
    return sorted(tuple(int(v) for v in r) for r in mv.iter_all())


def check_reopened(directory, tables, ns):
    """A second spill store opened on `directory`: every state table's
    `iter_all` equals the live one's, row for row. Returns the rows
    compared per table."""
    store2 = ns.SpillStateStore(directory)
    counts = {}
    for t in tables:
        live = list(t.iter_all())
        again = list(ns.StateTable(store2, t.table_id, t.dtypes,
                                   t.pk_indices).iter_all())
        if live != again:
            raise AssertionError(f"q5e: table {t.table_id} reopened with "
                                 f"{len(again)} rows, live {len(live)}")
        counts[t.table_id] = len(live)
    return counts


def dir_usage(directory):
    """(bytes, run files) under a spill store's directory."""
    size, runs = 0, 0
    for root, _, files in os.walk(directory):
        for f in files:
            size += os.path.getsize(os.path.join(root, f))
            runs += f.endswith((".run", ".base"))
    return size, runs


def q5e_phase(dev, smi, events=Q5E_EVENTS, epoch=Q5E_EPOCH, kept=None):
    """q5e on the card over a SpillStateStore: the drive (launches zeroed
    just before its first barrier, read just after its last), each
    barrier's split between the engines' `flush_epoch` and the host
    work, the growth replays; then the host twin over a MemoryStateStore
    and the numpy oracle, both equal to the MV; then the store reopened;
    the spill directory's bytes and runs. With `kept` (a dict),
    kept["rows"] holds the MV's rows (q5sql holds its own to them)."""
    ns = q5e_ns(dev)
    directory = tempfile.mkdtemp(prefix="q5e_spill_")
    try:
        store = ns.SpillStateStore(directory)
        graph = q5e_graph(ns, store, True)
        job, devs, mv, _, tables = graph
        flush_s = []
        for d in devs:
            time_flushes(d.engine, flush_s)
        job.run_until_barrier()                  # the initial barrier
        barriers = []
        seen = [len(flush_s)]

        def split(i, wall):
            fl = sum(flush_s[seen[0]:])
            seen[0] = len(flush_s)
            barriers.append({"wall_s": wall, "flush_s": fl,
                             "host_s": wall - fl})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        q5e_drive(graph, events, epoch, split)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        native = dict(N.CALLS)
        rows = mv_rows(mv)
        t = time.perf_counter()
        twin = q5e_graph(ns, ns.MemoryStateStore(), False)
        twin_walls = q5e_drive(twin, events, epoch)
        twin_wall = time.perf_counter() - t
        twin_rows = mv_rows(twin[2])
        if rows != twin_rows:
            raise AssertionError(f"q5e: {len(rows)} MV rows differ from the "
                                 f"host twin's {len(twin_rows)}")
        check_q5_rows(rows, q5e_oracle(ns, events))
        if kept is not None:
            kept["rows"] = rows
        reopened = check_reopened(directory, tables, ns)
        size, runs = dir_usage(directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    flush_total = sum(b["flush_s"] for b in barriers)
    n = len(barriers)
    rep = {"events": events, "barrier_events": epoch, "wall_s": wall,
           "events_per_s": events / wall, "host_twin_wall_s": twin_wall,
           "host_twin_barrier_walls_s": twin_walls,
           "flush_s": flush_total, "host_s": wall - flush_total,
           "flush_share": flush_total / wall, "barriers": barriers,
           "growth_replays": {type(d).__name__ + f"#{i}":
                              d.engine.growth_replays
                              for i, d in enumerate(devs)},
           "rows": len(rows), "launches": launches, "flushes": n,
           "launches_per_epoch": {k: v / n for k, v in launches.items()
                                  if v}, "native_calls": native,
           "spill_bytes": size, "spill_runs": runs,
           "reopened_rows": reopened, "card": smi}
    log(f"[main] q5e {json.dumps(rep)}")
    if min(rep["growth_replays"].values()) < 1:
        raise AssertionError(f"q5e: an engine made no growth replay "
                             f"{rep['growth_replays']}")
    missing = [k for k in Q5E_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"q5e path never launched {missing}")
    return rep


# ---------------------------------------------------------------------------
# q4sql / q5sql: Nexmark q4 and q5 from SQL, through the port's Database
# ---------------------------------------------------------------------------

# bench.py's bid source (:77-81) and its q4 / q5 views (:94, :97), copied
SQL_BID_SRC = ("CREATE SOURCE bid (auction BIGINT, bidder BIGINT,"
               " price BIGINT, channel VARCHAR, url VARCHAR,"
               " date_time TIMESTAMP, extra VARCHAR) WITH (connector='nexmark',"
               " nexmark.table='bid', nexmark.max.events='{n}',"
               " nexmark.chunk.size='{c}')")
SQL_Q4_MV = ("CREATE MATERIALIZED VIEW q4 AS SELECT auction, count(*) AS c,"
             " sum(price) AS s, max(price) AS m FROM bid GROUP BY auction")
SQL_Q5_MV = """CREATE MATERIALIZED VIEW nexmark_q5 AS
SELECT AuctionBids.auction, AuctionBids.num FROM (
    SELECT bid.auction, count(*) AS num, window_start AS starttime
    FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
    GROUP BY window_start, bid.auction
) AS AuctionBids
JOIN (
    SELECT max(CountBids.num) AS maxn, CountBids.starttime_c
    FROM (
        SELECT count(*) AS num, window_start AS starttime_c
        FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
        GROUP BY bid.auction, window_start
    ) AS CountBids
    GROUP BY CountBids.starttime_c
) AS MaxBids
ON AuctionBids.starttime = MaxBids.starttime_c
   AND AuctionBids.num >= MaxBids.maxn"""
# q4sql: 2^22 events in chunks of 2^14, so that one tick (64 chunks,
# ops/source.py:211) carries 2^20 events, q4e's barrier; q5sql: q5e's 2^18
# events in chunks of 2^11, 2^17 a tick, q5e's barrier. Every device
# engine starts from 2^12 slots and a checkpoint closes every barrier.
Q4SQL_EVENTS = 1 << 22
Q4SQL_CHUNK = 1 << 14
Q5SQL_CHUNK = 1 << 11
SQL_CAPACITY = 1 << 12
Q4SQL_BATCH = ("SELECT auction, c FROM q4 WHERE c >= 50 "
               "ORDER BY c DESC, auction LIMIT 20",
               "SELECT count(*), sum(c) FROM q4")
Q4SQL_KERNELS = Q4E_KERNELS
Q5SQL_KERNELS = Q5E_KERNELS


def sql_database(directory, dev, capacity=SQL_CAPACITY):
    """The port's Database over a spill store in `directory`
    (None: in memory), a checkpoint every barrier: with `dev`, per-operator
    device plans (`DeviceConfig(fuse=False)`: q4sql / q5sql measure the
    executors; the fused SQL paths are `fused_sql_phase`'s) from
    `capacity` slots on `dev`; without, host-only."""
    from risingwave_tpu_torch.config import DeviceConfig
    from risingwave_tpu_torch.sql import Database
    if dev is None:
        return Database(data_dir=directory, checkpoint_frequency=1)
    return Database(data_dir=directory, checkpoint_frequency=1,
                    device=DeviceConfig(fuse=False, capacity=capacity),
                    torch_device=dev)


def sql_tree(db, name):
    """Every executor of a catalog object's streaming job."""
    from risingwave_tpu_torch.sql.database import _walk_executors
    return list(_walk_executors(
        db.catalog.get(name).runtime["shared"].upstream))


def sql_classes(db, name):
    """{executor class name: count} of a job's tree."""
    out = {}
    for e in sql_tree(db, name):
        out[type(e).__name__] = out.get(type(e).__name__, 0) + 1
    return out


def sql_drive(db, source="bid"):
    """Tick until the source's reader has read to its `max_events`, then
    once more. Returns the ticks and those that carried events (the
    first tick carries the source's initial barrier alone, the last
    none)."""
    reader = [e.reader for e in sql_tree(db, source)
              if isinstance(getattr(e, "reader", None), O.SourceReader)][0]
    ticks = loaded = 0
    while reader.next_event < reader.max_events:
        before = reader.next_event
        db.tick()
        ticks += 1
        loaded += reader.next_event > before
    db.tick()
    return ticks + 1, loaded


def sql_state_tables(db, name):
    """(id, dtypes, pk) of every state table a job's executors hold and
    of its MV table, by id."""
    tables = {}
    for e in sql_tree(db, name):
        for attr in ("state_table", "left_state", "right_state"):
            t = getattr(e, attr, None)
            if isinstance(t, StateTable):
                tables[t.table_id] = t
        for t in list(getattr(e, "minput_tables", ()) or ()) + list(
                (getattr(e, "state_tables", None) or {}).values()):
            if isinstance(t, StateTable):
                tables[t.table_id] = t
    mv = db.catalog.get(name).runtime["state_table"]
    tables[mv.table_id] = mv
    return [(tid, [repr(d) for d in t.dtypes], list(t.pk_indices))
            for tid, t in sorted(tables.items())]


def sql_engines(db, name):
    """The device executors of a job, by class name and position."""
    return [e for e in sql_tree(db, name)
            if isinstance(e, (O.DeviceHashAggExecutor,
                              O.DeviceHashJoinExecutor))]


def q4sql_oracle(events):
    """numpy q4 over the host generator's bids (as
    tests/test_nexmark_scale.py builds its oracle): {auction: (count,
    sum, max)} and the number of bids."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkGenerator
    bid = NexmarkGenerator().gen_range(0, events)["bid"]
    auction = bid.columns[0].values.astype(np.int64)
    price = bid.columns[2].values.astype(np.int64)
    k, (cnt, sm, mx) = groupby_reduce(auction, [("count", None),
                                                ("sum", price),
                                                ("max", price)])
    return {int(a): (int(c), int(x), int(m))
            for a, c, x, m in zip(k, cnt, sm, mx)}, len(auction)


def check_q4sql(db, oracle, n_bids):
    """`SELECT * FROM q4` equals the oracle; the two batch queries equal
    numpy's answers. Returns the walls."""
    walls = {}
    t = time.perf_counter()
    rows = db.query("SELECT * FROM q4")
    walls["select_s"] = time.perf_counter() - t
    got = {int(a): (int(c), int(s), int(m)) for a, c, s, m in rows}
    if len(got) != len(rows) or got != oracle:
        raise AssertionError(f"q4sql: {len(rows)} rows differ from the "
                             f"oracle's {len(oracle)} groups")
    top = sorted(((a, v[0]) for a, v in oracle.items() if v[0] >= 50),
                 key=lambda r: (-r[1], r[0]))[:20]
    t = time.perf_counter()
    got = [(int(a), int(c)) for a, c in db.query(Q4SQL_BATCH[0])]
    walls["batch_top_s"] = time.perf_counter() - t
    if got != top:
        raise AssertionError(f"q4sql: top-20 {got} vs numpy {top}")
    t = time.perf_counter()
    ((n, total),) = db.query(Q4SQL_BATCH[1])
    walls["batch_count_s"] = time.perf_counter() - t
    if (int(n), int(total)) != (len(oracle), n_bids):
        raise AssertionError(f"q4sql: count(*), sum(c) = {n}, {total} vs "
                             f"{len(oracle)} groups, {n_bids} bids")
    return walls


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def q4sql_phase(dev, smi, events=Q4SQL_EVENTS, chunk=Q4SQL_CHUNK,
                capacity=SQL_CAPACITY, kernels=Q4SQL_KERNELS) -> dict:
    """q4 from SQL on the card: `CREATE SOURCE` + `CREATE MATERIALIZED
    VIEW` through the port's Database over a spill store, its plan a
    DeviceHashAggExecutor and no HashAggExecutor; ticks until the source
    is drained (launches zeroed just before, read just after); the MV
    and two batch queries over it against numpy. Each of `kernels` must
    have launched (on the CPU the wrappers launch nothing: pass ())."""
    d = tempfile.mkdtemp(prefix="q4sql_")
    try:
        db = sql_database(d, dev, capacity)
        db.run(SQL_BID_SRC.format(n=events, c=chunk))
        db.run(SQL_Q4_MV)
        cls = sql_classes(db, "q4")
        if not cls.get("DeviceHashAggExecutor") or cls.get("HashAggExecutor"):
            raise AssertionError(f"q4sql: plan {cls}")
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        ticks, loaded = sql_drive(db)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        native = dict(N.CALLS)
        oracle, n_bids = q4sql_oracle(events)
        walls = check_q4sql(db, oracle, n_bids)
        (agg,) = sql_engines(db, "q4")
        replays = agg.engine.growth_replays
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rep = {"events": events, "chunk": chunk, "ticks": ticks,
           "event_ticks": loaded, "wall_s": wall,
           "events_per_s": events / wall, **walls,
           "groups": len(oracle), "growth_replays": replays,
           "plan": cls, "launches": launches,
           "launches_per_tick": {k: v / loaded for k, v in launches.items()
                                 if v}, "native_calls": native, "card": smi}
    log(f"[main] q4sql {json.dumps(rep)}")
    if replays < 1:
        raise AssertionError("q4sql: the agg engine made no growth replay")
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"q4sql path never launched {missing}")
    return rep


def q5sql_layout(dev):
    """(id, dtypes, pk) of q5e_graph's state tables (the graph written to
    be what the planner builds for `Q5_MV`)."""
    ns = q5e_ns(dev)
    *_, tables = q5e_graph(ns, MemoryStateStore(), True)
    return [(t.table_id, [repr(x) for x in t.dtypes], list(t.pk_indices))
            for t in tables]


def q5sql_rows(db):
    return sorted((int(a), int(n))
                  for a, n in db.query("SELECT * FROM nexmark_q5"))


def q5sql_phase(dev, smi, q5e_rows=None, events=Q5E_EVENTS,
                chunk=Q5SQL_CHUNK, capacity=Q5E_CAPACITY,
                kernels=Q5SQL_KERNELS) -> dict:
    """q5 from SQL on the card, through the port's Database over a spill
    store: its plan three DeviceHashAggExecutors (the max's with its
    multiset table) and one DeviceHashJoinExecutor, its state tables laid
    out as q5e_graph's; ticks until the source is drained (launches
    zeroed just before, read just after); rows against the numpy q5
    oracle, q5e's rows (`q5e_rows`, (auction, num, ...) tuples) and a
    host-only Database driven through the same statements. Then the
    database is dropped and a second one opened on its directory under
    the same policy: it replays the DDL log, passes the device marker and
    reloads every engine from its state tables; its rows equal the
    first's before and after one more tick. Each of `kernels` must have
    launched in the drive."""
    import gc
    d = tempfile.mkdtemp(prefix="q5sql_")
    stmts = (SQL_BID_SRC.format(n=events, c=chunk), SQL_Q5_MV)
    try:
        db = sql_database(d, dev, capacity)
        for s in stmts:
            db.run(s)
        cls = sql_classes(db, "nexmark_q5")
        if [cls.get(k) for k in ("DeviceHashAggExecutor",
                                 "DeviceHashJoinExecutor", "HashAggExecutor",
                                 "HashJoinExecutor")] != [3, 1, None, None]:
            raise AssertionError(f"q5sql: plan {cls}")
        mts = [len(e.minput_tables) for e in sql_engines(db, "nexmark_q5")
               if isinstance(e, O.DeviceHashAggExecutor)]
        if sorted(mts) != [0, 0, 1]:
            raise AssertionError(f"q5sql: multiset tables {mts}")
        layout = sql_state_tables(db, "nexmark_q5")
        ref = q5sql_layout(dev)
        # CREATE SOURCE took the first ids: its catalog id and its
        # split-offset table
        shift = layout[0][0] - ref[0][0]
        if [(i - shift, dt, pk) for i, dt, pk in layout] != ref:
            raise AssertionError(f"q5sql: state tables {layout} vs "
                                 f"q5e_graph's {ref}")
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        ticks, loaded = sql_drive(db)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        native = dict(N.CALLS)
        t = time.perf_counter()
        rows = q5sql_rows(db)
        select_s = time.perf_counter() - t
        check_q5_rows(rows, q5e_oracle(q5e_ns(dev), events))
        if q5e_rows is not None and rows != sorted(
                (int(r[0]), int(r[1])) for r in q5e_rows):
            raise AssertionError("q5sql rows differ from q5e's")
        replays = {f"{type(e).__name__}#{i}": e.engine.growth_replays
                   for i, e in enumerate(sql_engines(db, "nexmark_q5"))}
        t = time.perf_counter()
        twin = sql_database(None, None)
        for s in stmts:
            twin.run(s)
        sql_drive(twin)
        twin_rows = q5sql_rows(twin)
        twin_wall = time.perf_counter() - t
        if twin_rows != rows:
            raise AssertionError(f"q5sql: {len(rows)} rows differ from the "
                                 f"host twin's {len(twin_rows)}")
        del db, twin
        gc.collect()
        t = time.perf_counter()
        db2 = sql_database(d, dev, capacity)
        reopen_s = time.perf_counter() - t
        if len(sql_engines(db2, "nexmark_q5")) != 4:
            raise AssertionError("q5sql: the reopened plan lost an engine")
        t = time.perf_counter()
        again = q5sql_rows(db2)
        reopen_select_s = time.perf_counter() - t
        db2.tick()
        after = q5sql_rows(db2)
        if again != rows or after != rows:
            raise AssertionError(f"q5sql: reopened rows {len(again)} / "
                                 f"{len(after)} vs {len(rows)}")
        del db2
        gc.collect()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rep = {"events": events, "chunk": chunk, "ticks": ticks,
           "event_ticks": loaded, "wall_s": wall,
           "events_per_s": events / wall, "select_s": select_s,
           "host_twin_wall_s": twin_wall,
           "reopen_s": reopen_s, "reopen_select_s": reopen_select_s,
           "rows": len(rows),
           "growth_replays": replays, "plan": cls,
           "state_tables": len(layout), "state_table_id_shift": shift,
           "launches": launches,
           "launches_per_tick": {k: v / loaded for k, v in launches.items()
                                 if v}, "native_calls": native, "card": smi}
    log(f"[main] q5sql {json.dumps(rep)}")
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"q5sql path never launched {missing}")
    return rep


# ---------------------------------------------------------------------------
# qlj_proc: worker-process placement — a LEFT join in 4 worker processes
# feeding a device agg on the card
# ---------------------------------------------------------------------------

# 2^18 events in chunks of 2^10 (2^16 events a tick: 4 event ticks), cut
# from 2^20: the coordinator shadows every join input row in a state
# table (per-row Python, the reference's design) and the host twin joins
# and aggregates per row, so 2^20 would take the phase past ~90 s (see
# PERF.md, PR 24). The supervised arm runs 2^16 events in chunks of 2^8
# (4 event ticks) and kills a join worker after its third tick.
QLJ_EVENTS = 1 << 18
QLJ_CHUNK = 1 << 10
QLJ_CAPACITY = 1 << 16
QLJ_SUP_EVENTS = 1 << 16
QLJ_SUP_CHUNK = 1 << 8
QLJ_KILL_AFTER = 3
QLJ_KERNELS = Q4ER_KERNELS


def qlj_oracle(events):
    """numpy qlj over the host generator's events: every auction with
    (id, category, count of its bids, sum and max of their prices — NULL
    for an auction with none), sorted."""
    from risingwave_tpu_torch.connectors.nexmark import NexmarkGenerator
    g = NexmarkGenerator().gen_range(0, events)
    ids = g["auction"].columns[0].values.astype(np.int64)
    cat = g["auction"].columns[8].values.astype(np.int64)
    b_auc = g["bid"].columns[0].values.astype(np.int64)
    price = g["bid"].columns[2].values.astype(np.int64)
    hit = np.isin(b_auc, ids)
    k, (cnt, sm, mx) = groupby_reduce(b_auc[hit], [("count", None),
                                                   ("sum", price[hit]),
                                                   ("max", price[hit])])
    agg = {int(a): (int(c), int(x), int(m))
           for a, c, x, m in zip(k, cnt, sm, mx)}
    return sorted((int(i), int(c)) + agg.get(int(i), (0, None, None))
                  for i, c in zip(ids, cat))


def qlj_rows(db):
    return sorted(tuple(None if v is None else int(v) for v in r)
                  for r in db.query("SELECT * FROM qlj"))


def qlj_database(dev, events, chunk, placement="process",
                 supervise=False):
    """The port's Database (device plans from QLJ_CAPACITY slots on
    `dev`, or host-only with `dev` None; a checkpoint every barrier) with
    the auction and bid sources, parallelism 4 and `placement`, and qlj
    created. Returns (db, create wall)."""
    db = sql_database(None, dev, QLJ_CAPACITY)
    for src in (SQL_AUCTION_SRC, SQL_BID_SRC):
        db.run(src.format(n=events, c=chunk))
    db.run(f"SET streaming_parallelism = {QLJ_PARALLELISM}")
    db.run(f"SET streaming_placement = '{placement}'")
    if supervise:
        db.run("SET streaming_supervision TO true")
    t = time.perf_counter()
    db.run(SQL_QLJ_MV)
    return db, time.perf_counter() - t


def shutdown_sets(db):
    for _name, r in db._remote_sets():
        r.shutdown()


def gpu_apps(dev, workers):
    """Pids of the processes that hold a CUDA context, as nvidia-smi
    lists them (pids of its own namespace: the smoke may show as another
    pid); fails unless it lists the smoke's SMOKE_PROCS processes at most
    and no worker."""
    if dev.type != "cuda":
        return []
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    apps = [int(x) for x in out.split()]
    if set(apps) & set(workers) or len(apps) > SMOKE_PROCS:
        raise AssertionError(f"qlj: CUDA contexts {apps}, workers {workers}")
    return apps


def qlj_plan(db):
    """The join set and the device agg of qlj's plan, checked: one
    RemoteStatefulSet (a join over QLJ_PARALLELISM live workers) and one
    DeviceHashAggExecutor with one multiset table (the retractable max)."""
    sets = [r for _n, r in db._remote_sets()]
    aggs = [e for e in sql_engines(db, "qlj")
            if isinstance(e, O.DeviceHashAggExecutor)]
    if [type(r).__name__ for r in sets] != ["RemoteStatefulSet"] \
            or sets[0].kind != "join" \
            or len(sets[0].workers) != QLJ_PARALLELISM \
            or any(w.proc.poll() is not None for w in sets[0].workers):
        raise AssertionError(f"qlj: remote sets {sets}")
    if len(aggs) != 1 or len(aggs[0].minput_tables) != 1:
        raise AssertionError(f"qlj: device aggs {aggs}")
    return sets[0], aggs[0]


def worker_metrics(db, job, kind, n):
    """The cluster metrics plane after a drive: `worker_epochs_total`
    series of this set's workers and one `worker_liveness` series per
    slot in `REGISTRY.expose()`, and `rw_worker_liveness` rows all `ok`
    (polled: heartbeats are stamped by the drain threads)."""
    from risingwave_tpu_torch.utils.metrics import REGISTRY
    end = time.monotonic() + 30
    rows = []
    while time.monotonic() < end:
        rows = db.query("SELECT * FROM rw_worker_liveness")
        if len(rows) == n and all(r[5] == "ok" for r in rows):
            break
        time.sleep(0.1)
    else:
        raise AssertionError(f"{job}: rw_worker_liveness {rows}")
    text = REGISTRY.expose().splitlines()
    epochs = [ln for ln in text if ln.startswith("worker_epochs_total{")
              and f'worker="{kind}' in ln]
    live = [ln for ln in text
            if ln.startswith(f'worker_liveness{{job="{job}"')]
    if len(epochs) < n or len(live) != n:
        raise AssertionError(f"{job}: metrics {epochs} {live}")
    return {"worker_epochs_total": epochs, "worker_liveness": live,
            "rw_worker_liveness": [list(r) for r in rows]}


def qlj_supervised(dev, events=QLJ_SUP_EVENTS, chunk=QLJ_SUP_CHUNK,
                   kill_after=QLJ_KILL_AFTER) -> dict:
    """The supervised arm: qlj under `streaming_supervision`, undisturbed
    and then with join worker 0 SIGKILLed after tick `kill_after`; the
    killed slot respawns in place (a new pid, re-seeded from the
    coordinator's shadows) and the final rows equal the undisturbed
    run's and the oracle's."""
    import signal
    from risingwave_tpu_torch.config import ROBUSTNESS
    saved = ROBUSTNESS.respawn_backoff_s
    ROBUSTNESS.respawn_backoff_s = 0.001
    out = {"events": events, "chunk": chunk}
    try:
        db, _ = qlj_database(dev, events, chunk, supervise=True)
        try:
            sql_drive(db)
            calm = qlj_rows(db)
        finally:
            shutdown_sets(db)
        db, _ = qlj_database(dev, events, chunk, supervise=True)
        try:
            rset, _agg = qlj_plan(db)
            old = rset.workers[0].proc.pid
            for _ in range(kill_after):
                db.tick()
            os.kill(old, signal.SIGKILL)
            t = time.perf_counter()
            db.tick()
            out["respawn_tick_s"] = time.perf_counter() - t
            if rset.supervisor.respawns != 1:
                raise AssertionError(f"qlj supervised: "
                                     f"{rset.supervisor.respawns} respawns")
            new = rset.workers[0]
            if new.proc.pid == old or new.proc.poll() is not None:
                raise AssertionError("qlj supervised: slot 0 not respawned")
            out["respawn_spawn_s"] = new.spawn_s
            ticks, loaded = sql_drive(db)
            rows = qlj_rows(db)
            if rset.supervisor.respawns != 1 or \
                    rset.supervisor._escalated is not None:
                raise AssertionError("qlj supervised: escalated")
        finally:
            shutdown_sets(db)
    finally:
        ROBUSTNESS.respawn_backoff_s = saved
    if rows != calm or rows != qlj_oracle(events):
        raise AssertionError(f"qlj supervised: {len(rows)} rows differ from "
                             f"the undisturbed run's {len(calm)}")
    out.update(killed_pid=old, respawned_pid=new.proc.pid, rows=len(rows),
               ticks_after=ticks, respawns=1)
    return out


def placement_phase(dev, smi, events=QLJ_EVENTS, chunk=QLJ_CHUNK,
                    kernels=QLJ_KERNELS) -> dict:
    """qlj_proc: qlj through the port's Database with process placement —
    the LEFT join in QLJ_PARALLELISM worker processes (a RemoteStatefulSet,
    the coordinator keeping its shadows), the agg over its retractable
    output a DeviceHashAggExecutor on `dev`. Checks the plan, that no
    worker holds a CUDA context (nvidia-smi lists this process alone
    while the workers live), each worker's spawn-to-ADDR wall, the drive
    (launches zeroed just before, read just after; each of `kernels` must
    launch; the device agg's push and flush walls), rows equal to the
    numpy oracle's and a host-only Database's under local placement, the
    cluster metrics plane, then the supervised arm."""
    db, create_s = qlj_database(dev, events, chunk)
    try:
        rset, agg = qlj_plan(db)
        cls = sql_classes(db, "qlj")
        spawn_s = [w.spawn_s for w in rset.workers]
        pids = [w.proc.pid for w in rset.workers]
        apps = gpu_apps(dev, pids)
        flush_s, push_s = [], []
        time_flushes(agg.engine, flush_s)
        on_chunk = agg.on_chunk

        def timed_push(chunk_):
            t = time.perf_counter()
            out = on_chunk(chunk_)
            push_s.append(time.perf_counter() - t)
            return out
        agg.on_chunk = timed_push
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        ticks, loaded = sql_drive(db)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        native = dict(N.CALLS)
        apps_after = gpu_apps(dev, pids)
        t = time.perf_counter()
        rows = qlj_rows(db)
        select_s = time.perf_counter() - t
        metrics = worker_metrics(db, "qlj", "join", QLJ_PARALLELISM)
        replays = agg.engine.growth_replays
    finally:
        shutdown_sets(db)
    t = time.perf_counter()
    oracle = qlj_oracle(events)
    oracle_s = time.perf_counter() - t
    if rows != oracle:
        raise AssertionError(f"qlj: {len(rows)} rows differ from the "
                             f"oracle's {len(oracle)}")
    twin, _ = qlj_database(None, events, chunk, placement="local")
    t = time.perf_counter()
    sql_drive(twin)
    twin_rows = qlj_rows(twin)
    twin_s = time.perf_counter() - t
    if twin_rows != rows:
        raise AssertionError("qlj: rows differ from the host twin's")
    del twin
    sup = qlj_supervised(dev)
    rep = {"events": events, "chunk": chunk, "workers": QLJ_PARALLELISM,
           "create_s": create_s, "spawn_s": spawn_s, "worker_pids": pids,
           "cuda_apps": apps, "cuda_apps_after": apps_after,
           "smoke_pid": os.getpid(), "ticks": ticks, "event_ticks": loaded,
           "drive_s": wall, "events_per_s": events / wall,
           "agg_push_s": sum(push_s), "agg_flush_s": sum(flush_s),
           "agg_share": (sum(push_s) + sum(flush_s)) / wall,
           "select_s": select_s, "oracle_s": oracle_s,
           "host_twin_s": twin_s, "rows": len(rows),
           "growth_replays": replays, "plan": cls,
           "remote_set": type(rset).__name__,
           "launches": launches,
           "launches_per_tick": {k: v / loaded for k, v in launches.items()
                                 if v}, "native_calls": native,
           "metrics": metrics,
           "supervised": sup, "card": smi}
    log(f"[main] qlj_proc {json.dumps(rep)}")
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"qlj_proc path never launched {missing}")
    return rep


# ---------------------------------------------------------------------------
# q4_sql .. q8_sql: the main paths created by CREATE MATERIALIZED VIEW and
# lowered by the port's try_fuse into fused epoch programs
# ---------------------------------------------------------------------------

SQL_AUCTION_SRC = ("CREATE SOURCE auction (id BIGINT, item_name VARCHAR,"
                   " description VARCHAR, initial_bid BIGINT,"
                   " reserve BIGINT, date_time TIMESTAMP, expires TIMESTAMP,"
                   " seller BIGINT, category BIGINT, extra VARCHAR)"
                   " WITH (connector='nexmark', nexmark.table='auction',"
                   " nexmark.max.events='{n}', nexmark.chunk.size='{c}')")
SQL_PERSON_SRC = ("CREATE SOURCE person (id BIGINT, name VARCHAR,"
                  " email_address VARCHAR, credit_card VARCHAR,"
                  " city VARCHAR, state VARCHAR, date_time TIMESTAMP,"
                  " extra VARCHAR) WITH (connector='nexmark',"
                  " nexmark.table='person', nexmark.max.events='{n}',"
                  " nexmark.chunk.size='{c}')")
SQL_Q3A_MV = ("CREATE MATERIALIZED VIEW q3a AS SELECT b.auction, b.price,"
              " a.seller, a.category FROM bid b JOIN auction a"
              " ON b.auction = a.id WHERE b.price > 500")
SQL_Q7_MV = """CREATE MATERIALIZED VIEW nexmark_q7 AS
SELECT B.auction, B.price, B.bidder, B.date_time
FROM bid B
JOIN (
    SELECT MAX(price) AS maxprice, window_end as date_time
    FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)
    GROUP BY window_end
) B1 ON B.price = B1.maxprice
WHERE B.date_time BETWEEN B1.date_time - INTERVAL '10' SECOND
      AND B1.date_time"""
SQL_Q8_MV = """CREATE MATERIALIZED VIEW nexmark_q8 AS
SELECT P.id, P.name, P.starttime
FROM (
    SELECT id, name, window_start AS starttime, window_end AS endtime
    FROM TUMBLE(person, date_time, INTERVAL '10' SECOND)
    GROUP BY id, name, window_start, window_end
) P
JOIN (
    SELECT seller, window_start AS starttime, window_end AS endtime
    FROM TUMBLE(auction, date_time, INTERVAL '10' SECOND)
    GROUP BY seller, window_start, window_end
) A ON P.id = A.seller AND P.starttime = A.starttime
   AND P.endtime = A.endtime"""
# qlj_proc (the placement phase): every auction with its bids so far,
# auctions with none included — q4's inner per-auction max made outer.
# The LEFT join has no condition and is no device join, so process
# placement puts it in worker processes; the agg over its retractable
# output is a device agg (its max on the multiset tables)
SQL_QLJ_MV = ("CREATE MATERIALIZED VIEW qlj AS"
              " SELECT a.id, a.category, count(b.auction) AS bids,"
              " sum(b.price) AS volume, max(b.price) AS top"
              " FROM auction a LEFT JOIN bid b ON a.id = b.auction"
              " GROUP BY a.id, a.category")
QLJ_PARALLELISM = 4
# chunks of 2^14 events: a tick polls 64 of them, so a fused epoch is
# 2^20 events, the hand-built jobs' epoch; every node starts at 2^16 slots
SQL_FUSED_CHUNK = 1 << 14
SQL_FUSED_CAPACITY = 1 << 16
# path: (MV name, sources, CREATE MATERIALIZED VIEW, events, hand-built
# path, kernels that must launch). q3a_sql runs at a quarter of q3a's
# depth, held to a device q3a run of its own: its MV persist and SELECT
# of every join row took 87 s at 2^22 events, 125 s at 2^23
Q3S_EVENTS = 1 << 21
SQL_FUSED = {
    "q4_sql": ("q4", (SQL_BID_SRC,), SQL_Q4_MV, MAX_EVENTS, "q4",
               Q4_KERNELS),
    "q3a_sql": ("q3a", (SQL_BID_SRC, SQL_AUCTION_SRC), SQL_Q3A_MV,
                Q3S_EVENTS, "q3a", Q3A_KERNELS),
    "q5_sql": ("nexmark_q5", (SQL_BID_SRC,), SQL_Q5_MV, Q5_EVENTS, "q5",
               Q5_KERNELS),
    "q7_sql": ("nexmark_q7", (SQL_BID_SRC,), SQL_Q7_MV, Q7_EVENTS, "q7",
               Q7_KERNELS),
    "q8_sql": ("nexmark_q8", (SQL_PERSON_SRC, SQL_AUCTION_SRC), SQL_Q8_MV,
               Q8_EVENTS, "q8", Q8_KERNELS),
}


def tensor_bytes(x) -> int:
    """Bytes of every tensor reachable from a job's state tree."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(tensor_bytes(e) for e in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return sum(tensor_bytes(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return 0


def node_list(job):
    """The program's node classes, chains spelled out."""
    return [type(n).__name__ + ("[" + ">".join(type(m).__name__
                                               for m in n.chain) + "]"
                                if hasattr(n, "chain") else "")
            for n in job.program.nodes]


def check_node_stats(db, job, mv) -> dict:
    """rw_fused_node_stats equals the job's node_report, and EXPLAIN
    ANALYZE's line of each node carries that node's rows_in / rows_out
    and each slot's entries/capacity."""
    rows = db.query("SELECT * FROM rw_fused_node_stats")
    want = [(mv,) + r for r in job.node_report()]
    if [tuple(r) for r in rows] != want:
        raise AssertionError(f"{mv}: rw_fused_node_stats {rows} vs "
                             f"node_report {want}")
    out = db.run(f"EXPLAIN ANALYZE {mv}")[0]
    lines = out.splitlines()
    if not lines[0].startswith(f"Streaming EXPLAIN ANALYZE: {mv} (fused"):
        raise AssertionError(f"{mv}: EXPLAIN ANALYZE header {lines[0]!r}")
    by_node = {}
    for ln in lines[2:]:
        body = ln.strip().lstrip("-> ")
        by_node[int(body.split(":", 1)[0])] = body
    for (_job, node, _t, slot, rows_in, rows_out, entries, cap, _occ,
         _hbm, _ov) in rows:
        body = by_node[node]
        if f"rows_in={rows_in}" not in body \
                or f"rows_out={rows_out}" not in body \
                or (slot != "-" and f"{slot}={entries}/{cap}" not in body):
            raise AssertionError(f"{mv}: EXPLAIN ANALYZE {body!r} vs "
                                 f"rw_fused_node_stats {rows}")
    return {"node_stats_rows": len(rows), "explain_lines": len(lines)}


def fused_sql_phase(name, dev, smi, hand, check, keep=None) -> dict:
    """One main path from SQL: CREATE SOURCE / CREATE MATERIALIZED VIEW
    through the port's Database on `dev` (an in-memory store, every arm at
    its default, a checkpoint every tick), which must lower the MV through
    try_fuse to a FusedJob with no source iterator on the host; ticks
    until the job has drained, then once more (launches zeroed just
    before, read after the SELECT), then `SELECT *`. The rows must pass
    `check` (the path's numpy oracle) and equal the visible columns of the
    hand-built job's rows from this run (`hand`: its rows, launches,
    epochs dispatched and node list); each kernel's launches per epoch are
    set beside the hand-built job's, and the two node lists printed when
    they differ. Reports the drive wall, the SELECT wall, the MV persist
    walls (inside the drive), the growth replays and the device memory
    after CREATE (beside the job's own state) and at the end. With
    `keep` (a dict), the SELECT's rows are kept there as "rows"."""
    from risingwave_tpu_torch.config import DeviceConfig
    from risingwave_tpu_torch.sql import Database
    import gc
    mv, srcs, sql, events, hp, kernels = SQL_FUSED[name]
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    db = Database(device=DeviceConfig(capacity=SQL_FUSED_CAPACITY),
                  checkpoint_frequency=1, torch_device=dev)
    for src in srcs:
        db.run(src.format(n=events, c=SQL_FUSED_CHUNK))
    db.run(sql)
    create_s = time.perf_counter() - t
    job = (db.catalog.get(mv).runtime or {}).get("fused_job")
    if job is None or db._fused.get(mv) is not job:
        raise AssertionError(f"{name}: CREATE made no fused job")
    host_iters = [src.split()[2] for src in srcs
                  if src.split()[2] in db._iters]
    if host_iters:
        raise AssertionError(f"{name}: sources {host_iters} run on the host")
    torch.cuda.synchronize()
    mem_create = torch.cuda.memory_allocated(dev)
    state_bytes = tensor_bytes(job.states)
    walls = []
    persist = job._persist_mv

    def timed_persist(epoch):
        t0 = time.perf_counter()
        persist(epoch)
        walls.append(time.perf_counter() - t0)
    job._persist_mv = timed_persist
    steps = [0]
    step = job.program.step

    def counted(*a, **kw):
        steps[0] += 1
        return step(*a, **kw)
    job.program.step = counted
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    ticks = 0
    while not job.drained:
        db.tick()
        ticks += 1
    db.tick()
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    rows = db.query(f"SELECT * FROM {mv}")
    select_s = time.perf_counter() - t1
    launches = dict(K.LAUNCHES)
    del job.program.step, job._persist_mv
    t = time.perf_counter()
    check(rows)
    hand_rows, hand_launches, hand_epochs, hand_nodes = hand
    nv = len(rows[0]) if rows else 0
    if rows != [tuple(r[:nv]) for r in hand_rows]:
        raise AssertionError(f"{name}: {len(rows)} rows differ from the "
                             f"hand-built {hp}'s {len(hand_rows)}")
    check_s = time.perf_counter() - t
    nodes = node_list(job)
    per_epoch = {k: [launches.get(k, 0) / steps[0],
                     hand_launches.get(k, 0) / hand_epochs]
                 for k in sorted(set(launches) | set(hand_launches))
                 if launches.get(k, 0) or hand_launches.get(k, 0)}
    differ = {k: v for k, v in per_epoch.items() if v[0] != v[1]}
    rep = {"events": events, "ticks": ticks + 1, "create_s": create_s,
           "drive_s": drive_s, "events_per_s": events / drive_s,
           "select_s": select_s, "persist_walls_s": walls,
           "persist_s": sum(walls), "drive_minus_persist_s":
           drive_s - sum(walls), "growth_replays": job.growth_replays,
           "rows": len(rows), "oracle_and_hand_check_s": check_s,
           "capacities": {f"{i}:{type(n).__name__}": n.cap_current()
                          for i, n in enumerate(job.program.nodes)
                          if n.cap_current()},
           "memory_before_create": mem0,
           "memory_after_create": mem_create,
           "job_state_bytes_at_create": state_bytes,
           "memory_at_end": torch.cuda.memory_allocated(dev),
           "job_state_bytes_at_end": tensor_bytes(job.states),
           "plan_hash": job.plan_hash, "nodes": nodes,
           "launches": launches, "epochs_dispatched": steps[0],
           "launches_per_epoch_vs_hand": per_epoch,
           "launches_per_epoch_differ": differ, "card": smi}
    if nodes != hand_nodes:
        rep["hand_nodes"] = hand_nodes
        log(f"[main] {name} node list {nodes} vs hand-built {hp}'s "
            f"{hand_nodes}")
    if differ:
        log(f"[main] {name} launches per epoch differ from {hp}'s "
            f"(sql, hand): {differ}")
    if name == "q5_sql":
        rep["node_stats_check"] = check_node_stats(db, job, mv)
    if keep is not None:
        keep["rows"] = rows
    log(f"[main] {name} {json.dumps(rep)}")
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    # the Database and its job hold each other: collect them, so the
    # next phase starts without this job's device state
    del db, job
    gc.collect()
    return rep


# ---------------------------------------------------------------------------
# recovery of the fused SQL jobs: restart to the committed counter, in
# place from a device fault, the tiered job's journal
# ---------------------------------------------------------------------------

FUSED_POINTS = ("fused.dispatch", "fused.device_sync",
                "fused.checkpoint_commit", "fused.growth_replay")
# the growth replay's fault needs a growth after the second epoch: the
# first of these capacities whose undisturbed drive has one
Q5_GROWTH_CAPS = (SQL_FUSED_CAPACITY, 1 << 15, 1 << 14, 1 << 13, 1 << 12)
# qa_sql_tiered_restart: the hand-built qa_tiered's query and clamp from
# SQL, in epochs of 2^14 (chunks of 2^8), 2^21 events (a quarter of
# qa_tiered's, for the smoke's time: it must still demote)
QAR_EVENTS = 1 << 21
QAR_CHUNK = TIER_EPOCH_EVENTS // 64
SQL_QA_SRC = SQL_BID_SRC.replace(
    "nexmark.chunk.size='{c}')",
    "nexmark.chunk.size='{c}', nexmark.ingest='host',"
    f" nexmark.key.dist='{QA_KEY_DIST}')")
SQL_QA_MV = ("CREATE MATERIALIZED VIEW qa AS SELECT auction,"
             " count(*) AS n, sum(price) AS dol FROM bid GROUP BY auction")


def fused_database(dev, data_dir=None, **cfg):
    """The port's Database on `dev`, a checkpoint every tick, fusion on,
    every other arm at its default unless `cfg` says otherwise."""
    from risingwave_tpu_torch.config import DeviceConfig
    from risingwave_tpu_torch.sql import Database
    return Database(device=DeviceConfig(**cfg), checkpoint_frequency=1,
                    data_dir=data_dir, torch_device=dev)


def fused_job_of(db, mv, name):
    job = (db.catalog.get(mv).runtime or {}).get("fused_job")
    if job is None or db._fused.get(mv) is not job:
        raise AssertionError(f"{name}: {mv} is not a fused job")
    return job


def q5_sql_db(dev, capacity=None, data_dir=None):
    db = fused_database(dev, data_dir,
                        capacity=capacity or SQL_FUSED_CAPACITY)
    db.run(SQL_BID_SRC.format(n=Q5_EVENTS, c=SQL_FUSED_CHUNK))
    db.run(SQL_Q5_MV)
    return db, fused_job_of(db, "nexmark_q5", "q5_sql")


def drive_ticks(db, job, before_tick=None) -> list:
    """Tick until the job has drained, then once more; `before_tick(k)`
    runs before the k-th tick (from 0). Returns the growth replays after
    each tick."""
    trace = []
    while not job.drained:
        if before_tick is not None:
            before_tick(len(trace))
        db.tick()
        trace.append(job.growth_replays)
    db.tick()
    return trace


def timed_reopen(open_db):
    """`open_db()` (a Database over a directory that holds committed fused
    state) with its wall, the walls of every FusedJob.recover() inside it
    and the epochs those replayed (FusedProgram.step calls), launches
    zeroed just before and read just after."""
    walls, steps = [], [0]
    recover, step = F.FusedJob.recover, F.FusedProgram.step

    def timed_recover(self):
        t0 = time.perf_counter()
        recover(self)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    def counted(self, *a, **kw):
        steps[0] += 1
        return step(self, *a, **kw)
    F.FusedJob.recover, F.FusedProgram.step = timed_recover, counted
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        db = open_db()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        F.FusedJob.recover, F.FusedProgram.step = recover, step
    return db, wall, walls, steps[0], launches


def q5_sql_restart_phase(dev, smi, check) -> dict:
    """q5_sql over a data directory, then a reopen of it (phase 4e'')."""
    import gc
    d = tempfile.mkdtemp(prefix="rw_q5_restart_")
    try:
        db, job = q5_sql_db(dev, data_dir=d)
        t0 = time.perf_counter()
        trace = drive_ticks(db, job)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        rows = db.query("SELECT * FROM nexmark_q5")
        check(rows)
        before = (job.committed, job.growth_replays, job.retraces,
                  job.growths, [n.cap_current() for n in job.program.nodes])
        del db, job
        gc.collect()
        torch.cuda.synchronize()
        mem_closed = torch.cuda.memory_allocated(dev)
        db, ddl_s, rec_walls, epochs, launches = timed_reopen(
            lambda: fused_database(dev, d, capacity=SQL_FUSED_CAPACITY))
        job = fused_job_of(db, "nexmark_q5", "q5_sql_restart")
        mem_reopen = torch.cuda.memory_allocated(dev)
        after = (job.committed, job.growth_replays, job.retraces,
                 job.growths, [n.cap_current() for n in job.program.nodes])
        t1 = time.perf_counter()
        rows2 = db.query("SELECT * FROM nexmark_q5")
        select_s = time.perf_counter() - t1
        rep = {"events": Q5_EVENTS, "drive_s": drive_s,
               "growth_after_tick": trace, "committed": before[0],
               "growth_replays": before[1], "ddl_replay_s": ddl_s,
               "recover_s": rec_walls, "replayed_epochs": epochs,
               "first_select_s": select_s, "rows": len(rows),
               "memory_after_close": mem_closed,
               "memory_after_reopen": mem_reopen,
               "job_state_bytes": tensor_bytes(job.states),
               "launches": launches, "card": smi}
        log(f"[main] q5_sql_restart {json.dumps(rep)}")
        if after != before:
            raise AssertionError(f"q5_sql_restart: reopened (committed, "
                                 f"replays, retraces, growths, caps) {after}"
                                 f" vs {before}")
        if rows2 != rows:
            raise AssertionError("q5_sql_restart: the reopened rows differ")
        check(rows2)
        missing = [k for k in Q5_KERNELS if launches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"q5_sql_restart: the replay never "
                                 f"launched {missing}")
        rep["_rows"] = rows
        del db, job
        gc.collect()
        return rep
    finally:
        shutil.rmtree(d, ignore_errors=True)


def watch_recoveries(job) -> list:
    """Wrap the job's in-place recovery: each one's wall, the committed
    history it replayed and the crash window it re-dispatched (epochs),
    and the kernels it launched."""
    recs = []
    recover = job._recover_in_place
    e = job.program.epoch_events

    def timed(err):
        window = job._epoch_log.entries()
        committed = job.committed
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        recover(err)
        torch.cuda.synchronize()
        recs.append({"error": f"{type(err).__name__}: {err}",
                     "wall_s": time.perf_counter() - t0,
                     "history_epochs": -(-committed // e),
                     "window_epochs": len(window),
                     "launches": {k: K.LAUNCHES[k] - before.get(k, 0)
                                  for k in K.LAUNCHES
                                  if K.LAUNCHES[k] != before.get(k, 0)}})
    job._recover_in_place = timed
    return recs


def q5_sql_inplace_phase(dev, smi, want, trace) -> dict:
    """q5_sql driven once per fused.* failpoint, each armed to fire once
    after the second epoch (phase 4e'')."""
    import gc
    from risingwave_tpu_torch.utils import failpoint as FP
    grow_cap, tried = None, {}
    for cap in Q5_GROWTH_CAPS:
        if cap != SQL_FUSED_CAPACITY:
            db, job = q5_sql_db(dev, cap)
            trace = drive_ticks(db, job)
            if db.query("SELECT * FROM nexmark_q5") != want:
                raise AssertionError(f"q5_sql_inplace: capacity {cap}'s "
                                     "undisturbed rows differ")
            del db, job
            gc.collect()
        tried[cap] = trace
        if len(trace) > 2 and trace[-1] > trace[1]:
            grow_cap = cap
            break
    if grow_cap is None:
        raise AssertionError(f"q5_sql_inplace: no capacity grows after the "
                             f"second epoch: {tried}")
    rep = {"growth_capacity": grow_cap, "growth_traces": tried,
           "card": smi}
    for point in FUSED_POINTS:
        cap = grow_cap if point == "fused.growth_replay"             else SQL_FUSED_CAPACITY
        db, job = q5_sql_db(dev, cap)
        recs = watch_recoveries(job)

        def arm(k, point=point):
            if k == 2:
                FP.arm(point, 1.0, 0, 1)
        t0 = time.perf_counter()
        try:
            drive_ticks(db, job, arm)
        finally:
            FP.reset()
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        rows = db.query("SELECT * FROM nexmark_q5")
        rep[point] = {"capacity": cap, "drive_s": drive_s,
                      "recoveries": job.recoveries,
                      "growth_replays": job.growth_replays,
                      "recovery": recs}
        if job.recoveries != 1 or len(recs) != 1:
            raise AssertionError(f"q5_sql_inplace {point}: "
                                 f"{job.recoveries} recoveries")
        if db._fused.get("nexmark_q5") is not job:
            raise AssertionError(f"q5_sql_inplace {point}: the job was "
                                 "replaced")
        if rows != want:
            raise AssertionError(f"q5_sql_inplace {point}: rows differ "
                                 "from the undisturbed run's")
        del db, job
        gc.collect()
    log(f"[main] q5_sql_inplace {json.dumps(rep)}")
    return rep


def cold_dump(tm) -> dict:
    """Every cold store of a TieringManager as sorted (key, row) pairs of
    python scalars, per (node, side) and shard."""
    def scal(v):
        return v.item() if hasattr(v, "item") else v

    def row(r):
        if isinstance(r, tuple) and len(r) == 2 \
                and isinstance(r[0], tuple):        # agg: (vals, touch)
            return (tuple(scal(v) for v in r[0]), scal(r[1]))
        if isinstance(r, list):                     # join: [(pk, vals, t)]
            return sorted((scal(pk), tuple(scal(v) for v in vs), scal(t))
                          for pk, vs, t in r)
        return tuple(scal(v) for v in r)            # mv: vals tuple
    return {str(key): [sorted((scal(k), row(r)) for k, r in d.items())
                       for d in store.rows]
            for key, store in tm.stores.items()}


def qa_sql_tiered_restart_phase(dev, smi) -> dict:
    """The host-fed tiered group-by from SQL over QAR_EVENTS events:
    demotions, one in-place fault after them, then a reopen that rebuilds
    both tiers (phase 4e'')."""
    import gc
    from risingwave_tpu_torch.utils import failpoint as FP
    events = QAR_EVENTS
    d = tempfile.mkdtemp(prefix="rw_qa_restart_")
    cfg = dict(capacity=QA_CLAMP, agg_precombine=False, state_tiering=True)
    try:
        db = fused_database(dev, d, **cfg)
        db.run(SQL_QA_SRC.format(n=events, c=QAR_CHUNK))
        db.run(SQL_QA_MV)
        job = fused_job_of(db, "qa", "qa_sql_tiered_restart")
        if job.ingest is None or job.tiering is None:
            raise AssertionError("qa_sql_tiered_restart: not host-fed and "
                                 "tiered")
        if job.ingest.buckets.get("bid") is not db._overload.buckets.get(
                "bid"):
            raise AssertionError("qa_sql_tiered_restart: no admission "
                                 "bucket wired")
        ai = [i for i, n in enumerate(job.program.nodes)
              if isinstance(n, F.AggNode)][0]
        budget = clamp_budget_mb(job, f"{ai}:AggNode.main", QA_CLAMP)
        job.hbm_budget_mb = budget
        recs = watch_recoveries(job)
        tm = job.tiering
        armed = []

        def arm(_k):
            if not armed and tm.counters["demote_events"] > 0:
                FP.arm("fused.dispatch", 1.0, 0, 1)
                armed.append(job.counter)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        try:
            drive_ticks(db, job, arm)
        finally:
            FP.reset()
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        t1 = time.perf_counter()
        rows = db.query("SELECT * FROM qa")
        select_s = time.perf_counter() - t1
        oracle = qa_oracle(events)
        check_qa_rows(rows, oracle)
        journal = os.path.join(d, "tiering_journal_qa.jsonl")
        dump = cold_dump(tm)
        tables = tiered_tables(job)
        before = (job.committed, job.growth_replays,
                  [n.cap_current() for n in job.program.nodes])
        rep = {"events": events, "drive_s": drive_s,
               "events_per_s": events / drive_s, "select_s": select_s,
               "rows": len(rows), "budget_bytes": budget << 20,
               "tiered_tables": tables, "growth_replays": job.growth_replays,
               "tiering": dict(tm.counters),
               "tier_walls_s": dict(job.tier_walls),
               "fault_at_event": armed[0] if armed else None,
               "recoveries": job.recoveries, "recovery": recs,
               "journal_lines": (sum(1 for _ in open(journal))
                                 if os.path.exists(journal) else 0),
               "cold_rows": {k: sum(len(s) for s in v)
                             for k, v in dump.items()},
               "admission": db.query("SELECT * FROM rw_source_admission"),
               "ingest": {k: v for k, v in job.ingest.stats().items()
                          if k != "sources"},
               "launches": launches, "card": smi}
        if tm.counters["demote_events"] <= 0 \
                or tm.counters["promotions"] <= 0:
            raise AssertionError(f"qa_sql_tiered_restart: demotions / "
                                 f"promotions {tm.counters}")
        if not os.path.exists(journal):
            raise AssertionError("qa_sql_tiered_restart: no journal file")
        if job.recoveries != 1:
            raise AssertionError(f"qa_sql_tiered_restart: "
                                 f"{job.recoveries} recoveries")
        past = {k: v for k, v in tables.items() if v[1] > budget << 20}
        if past:
            raise AssertionError(f"qa_sql_tiered_restart: {past} past the "
                                 "budget")
        job.ingest.close()
        del db, job, tm
        gc.collect()
        db, ddl_s, rec_walls, epochs, rlaunches = timed_reopen(
            lambda: fused_database(dev, d, hbm_budget_mb=budget, **cfg))
        job = fused_job_of(db, "qa", "qa_sql_tiered_restart")
        after = (job.committed, job.growth_replays,
                 [n.cap_current() for n in job.program.nodes])
        dump2 = cold_dump(job.tiering)
        t1 = time.perf_counter()
        rows2 = db.query("SELECT * FROM qa")
        rep.update({"ddl_replay_s": ddl_s, "recover_s": rec_walls,
                    "replayed_epochs": epochs, "first_select_s":
                    time.perf_counter() - t1,
                    "replay_tier_walls_s": dict(job.tier_walls),
                    "replay_launches": rlaunches})
        log(f"[main] qa_sql_tiered_restart {json.dumps(rep)}")
        if after != before:
            raise AssertionError(f"qa_sql_tiered_restart: reopened "
                                 f"{after[:2]} vs {before[:2]}")
        if dump2 != dump:
            raise AssertionError("qa_sql_tiered_restart: the reopened cold "
                                 "stores differ")
        if rows2 != rows:
            raise AssertionError("qa_sql_tiered_restart: the reopened rows "
                                 "differ")
        missing = [k for k in QA_KERNELS if rlaunches.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"qa_sql_tiered_restart: the replay never "
                                 f"launched {missing}")
        job.ingest.close()
        del db, job
        gc.collect()
        return rep
    finally:
        shutil.rmtree(d, ignore_errors=True)


def recovery_phases(dev, smi, q5_check) -> dict:
    """Phase 4e'': the three recovery paths."""
    out = {"q5_sql_restart": q5_sql_restart_phase(dev, smi, q5_check)}
    want = out["q5_sql_restart"].pop("_rows")
    out["q5_sql_inplace"] = q5_sql_inplace_phase(
        dev, smi, want, out["q5_sql_restart"]["growth_after_tick"])
    out["qa_sql_tiered_restart"] = qa_sql_tiered_restart_phase(dev, smi)
    return out


# ---------------------------------------------------------------------------
# mesh_policy: the mesh skew policy, host ingest and tiering under a mesh,
# serving replicas — jobs created from SQL on MP_SHARDS shards of the card
# ---------------------------------------------------------------------------

MP_SHARDS = 8
MP_CAPACITY = 1 << 16
MP_THRESHOLD = 1.2
MP_CHUNK = 1 << 12                   # an epoch of 2^18 events
MP_Q1_EVENTS = 1 << 22
MP_Q3_EVENTS = 1 << 21
MP_FED_EVENTS = 1 << 21
MP_QA_EVENTS = 1 << 21
MP_QA_CHUNK = TIER_EPOCH_EVENTS // 64
MP_QA_CLAMP = 1 << 11                # slots a shard: qa's groups overflow it
MP_Q5_EVENTS = 1 << 21
MP_Q5_SHARDS = 4
MP_REPLICAS = 2
MP_SELECTS = 4
MP_BASE = ("sort_cols", "bucket_exchange", "vnode_hist", "topk_packed",
           "touch_stamp")
MP_AGG = MP_BASE + ("batch_reduce", "merge")
MP_KERNELS = {"q1_reb": MP_AGG,
              "q3_hot": MP_BASE + ("batch_reduce_rows", "merge_side",
                                   "probe", "expr_eval"),
              "q1_fed8": MP_AGG,
              "qa_tiered8": MP_AGG + ("tier_partition",),
              "q5_rep": MP_AGG + ("hop_expand", "ms_batch_reduce",
                                  "ms_merge", "ms_find", "merge_side",
                                  "probe", "expr_eval")}
MP_BID_SRC = SQL_BID_SRC.replace(
    "nexmark.chunk.size='{c}')", "nexmark.chunk.size='{c}'{x})")
MP_AUCTION_SRC = SQL_AUCTION_SRC.replace(
    "nexmark.chunk.size='{c}')", "nexmark.chunk.size='{c}'{x})")
MP_Q1_MV = ("CREATE MATERIALIZED VIEW q1a AS SELECT bidder,"
            " count(*) AS n, sum(price) AS dol, max(price) AS top"
            " FROM bid GROUP BY bidder")


def mp_db(dev, shards, data_dir=None, **cfg):
    """The phase's Database: `shards` shards on `dev`, the policy's
    threshold, every skew, rebalance and hot-key arm at its default."""
    cfg = {"capacity": MP_CAPACITY, **cfg}
    return fused_database(dev, data_dir, mesh_shards=shards,
                          rebalance_threshold=MP_THRESHOLD, **cfg)


def mp_job(dev, name, mv, srcs, events, shards, chunk=None,
           data_dir=None, **cfg):
    """A fused job from SQL: the sources (each `(text, extra options)`)
    and the MV on a Database of `shards` shards, polls of `chunk`
    (MP_CHUNK) events."""
    chunk = chunk or MP_CHUNK
    db = mp_db(dev, shards, data_dir, **cfg)
    for src, x in srcs:
        db.run(src.format(n=events, c=chunk, x=x))
    db.run(mv)
    view = mv.split()[3]
    return db, fused_job_of(db, view, name)


def mp_drive(db, job, count=True):
    """Tick the job to its end and on while a staged policy waits (a
    policy adopts at the checkpoint after its stage), the device synced
    before and after -> (drive s, launches, epochs stepped), launches
    zeroed just before the drive (with `count`)."""
    steps = [0]
    step = F.FusedProgram.step

    def counted(self, *a, **kw):
        steps[0] += 1
        return step(self, *a, **kw)
    F.FusedProgram.step = counted
    try:
        torch.cuda.synchronize()
        if count:
            K.reset_launches()
        t0 = time.perf_counter()
        drive_ticks(db, job)
        for _ in range(8):
            if job._pending_policy is None:
                break
            db.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        F.FusedProgram.step = step
    return wall, launches, steps[0]


def mp_rows(db, view):
    t0 = time.perf_counter()
    rows = db.query(f"SELECT * FROM {view}")
    return rows, time.perf_counter() - t0


def mp_one_shard(dev, name, mv, srcs, events, **cfg):
    """The same SQL's 1-shard fused run on the card: its rows."""
    db, job = mp_job(dev, name, mv, srcs, events, 1, **cfg)
    mp_drive(db, job, count=False)
    rows = mp_rows(db, mv.split()[3])[0]
    if job.ingest is not None:
        job.ingest.close()
    return rows


def mp_check(name, rows, one, launches, epochs, kernels=None):
    if not rows:
        raise AssertionError(f"{name}: no rows")
    if rows != one:
        raise AssertionError(f"{name}: rows differ from the 1-shard run's "
                             f"({len(rows)} vs {len(one)})")
    kernels = MP_KERNELS[name] if kernels is None else kernels
    missing = [k for k in kernels if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{name}: never launched {missing}")
    return {k: v / epochs for k, v in sorted(launches.items()) if v}


def mp_apply_walls(job) -> list:
    """Each policy adoption of the job (a rebuild-replay): the bounds it
    adopted and the occupancy histogram the checkpoint that staged it
    decided on, its wall and the committed event it replayed to."""
    adopted, staged = [], []
    stage, apply = job._stage_policy, job._apply_policy

    def kept(bounds, hot_map):
        staged.append(mp_occupancy(job) if any(
            n.skew and n.exch is not None for n in job.program.nodes)
            else None)
        stage(bounds, hot_map)

    def timed(epoch, bounds, hot_map):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply(epoch, bounds, hot_map)
        torch.cuda.synchronize()
        adopted.append({"wall_s": time.perf_counter() - t0,
                        "at_event": job.committed,
                        "bounds": [int(b) for b in bounds],
                        "hot_nodes": sorted(hot_map),
                        "occupancy": staged[-1]})
    job._stage_policy, job._apply_policy = kept, timed
    return adopted


def mp_occupancy(job):
    from risingwave_tpu_torch.device.skew_stats import SK_BUCKETS
    i = next(i for i, n in enumerate(job.program.nodes)
             if n.skew and n.exch is not None)
    st = job.program.node_stats(i, np.maximum(job._stat_totals,
                                              job._last_stats))
    return [int(st[f"skv{b}"]) for b in range(SK_BUCKETS)]


def mp_q1_reb(dev, smi) -> dict:
    """q1_reb: a per-bidder leaderboard over zipf:4 bids; the job
    rebalances its vnode blocks, survives a reopen."""
    import gc
    from risingwave_tpu_torch.device.skew_stats import (shard_loads,
                                                        shard_skew_ratio)
    from risingwave_tpu_torch.parallel.mesh import vnode_block_bounds
    name, ev = "q1_reb", MP_Q1_EVENTS
    srcs = ((MP_BID_SRC, ", nexmark.key.dist='zipf:4'"),)
    one = mp_one_shard(dev, name, MP_Q1_MV, srcs, ev)
    d = tempfile.mkdtemp(prefix="rw_mp_q1_")
    try:
        db, job = mp_job(dev, name, MP_Q1_MV, srcs, ev, MP_SHARDS,
                         data_dir=d)
        adopted = mp_apply_walls(job)
        drive_s, launches, epochs = mp_drive(db, job)
        rows, select_s = mp_rows(db, "q1a")
        lpe = mp_check(name, rows, one, launches, epochs)
        uniform = [int(v) for v in vnode_block_bounds(MP_SHARDS)]
        bounds = job.program.vnode_bounds
        skew = db.query("SELECT * FROM rw_key_skew WHERE job = 'q1a'")
        if job.rebalances < 1 or not adopted:
            raise AssertionError(f"{name}: no rebalance")
        # each adoption against the uniform blocks, on the histogram its
        # stage decided on: the first moves off them, none raises the
        # skew
        for a in adopted:
            a["shard_skew_uniform"] = shard_skew_ratio(a["occupancy"],
                                                       uniform)
            a["shard_skew_adopted"] = shard_skew_ratio(a["occupancy"],
                                                       a["bounds"])
            a["shard_loads_uniform"] = shard_loads(a["occupancy"], uniform)
            a["shard_loads_adopted"] = shard_loads(a["occupancy"],
                                                   a["bounds"])
            if a["shard_skew_adopted"] > a["shard_skew_uniform"] + 1e-9:
                raise AssertionError(f"{name}: an adoption raised the "
                                     f"shard skew: {a}")
        if adopted[0]["bounds"] == uniform:
            raise AssertionError(f"{name}: the first adoption kept the "
                                 "uniform blocks")
        if not any(r[3] == "shard_load" for r in skew) \
                or not any(r[3] == "shard_skew" for r in skew):
            raise AssertionError(f"{name}: rw_key_skew has no shard rows")
        rep = {"events": ev, "shards": MP_SHARDS, "drive_s": drive_s,
               "events_per_s": ev / drive_s, "select_s": select_s,
               "rows": len(rows), "rebalances": job.rebalances,
               "final_bounds": list(bounds) if bounds is not None
               else uniform, "adoptions": adopted,
               "rebalance_s": [a["wall_s"] for a in adopted],
               "growth_replays": job.growth_replays,
               "epochs_stepped": epochs, "launches": launches,
               "launches_per_epoch": lpe, "card": smi}
        del db, job
        gc.collect()
        db, reopen_s, rec_walls, rsteps, _rl = timed_reopen(
            lambda: mp_db(dev, MP_SHARDS, d))
        job = fused_job_of(db, "q1a", name)
        if job.program.vnode_bounds != bounds:
            raise AssertionError(f"{name}: reopened with bounds "
                                 f"{job.program.vnode_bounds}")
        if mp_rows(db, "q1a")[0] != one:
            raise AssertionError(f"{name}: reopened rows differ")
        rep.update({"reopen_s": reopen_s, "recover_s": rec_walls,
                    "reopen_epochs": rsteps})
        del db, job
        gc.collect()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return rep


def mp_join_input(job):
    """Count, per shard, the live rows each exchange of the join's bid
    input hands it, apart for epochs before and after the first policy
    adoption (device counters: nothing is synchronised per call). ->
    (counters, restore)."""
    from risingwave_tpu_torch.device import shard_exec as SE
    ji = next(i for i, n in enumerate(job.program.nodes)
              if isinstance(n, F.JoinNode))
    node = job.program.nodes[ji]
    acc = {}
    base = SE.exchange_delta

    def counted(mesh, nd, xi, deltas, **kw):
        out, need = base(mesh, nd, xi, deltas, **kw)
        if nd is node and xi == 0:
            k = "on" if job.rebalances else "off"
            got = torch.stack([d.mask.sum() for d in out])
            acc[k] = got if k not in acc else acc[k] + got
        return out, need
    SE.exchange_delta = counted

    def restore():
        SE.exchange_delta = base
    return acc, restore


def mp_share(counts) -> float:
    c = counts.cpu().numpy().astype(np.float64)
    return float(c.max() / c.sum()) if c.sum() else 0.0


def mp_q3_hot(dev, smi) -> dict:
    """q3_hot: bid JOIN auction with ~99% of the bids on one auction; the
    join replicates its hot key (the auction side broadcast, the bid side
    salted)."""
    name, ev = "q3_hot", MP_Q3_EVENTS
    srcs = ((MP_BID_SRC, ", nexmark.key.dist='zipf:8'"),
            (MP_AUCTION_SRC, ""))
    t0 = time.perf_counter()
    one = mp_one_shard(dev, name, SQL_Q3A_MV, srcs, ev)
    one_s = time.perf_counter() - t0
    off_db, off_job = mp_job(dev, name, SQL_Q3A_MV, srcs, ev, MP_SHARDS,
                             hot_key_rep=False)
    acc_off, restore = mp_join_input(off_job)
    try:
        off_s, off_launches, off_epochs = mp_drive(off_db, off_job)
    finally:
        restore()
    off_rows = mp_rows(off_db, "q3a")[0]
    off_growth = off_job.growth_replays
    if off_rows != one:
        raise AssertionError(f"{name}: hot_key_rep off: rows differ from "
                             "the 1-shard run's")
    del off_db, off_job
    db, job = mp_job(dev, name, SQL_Q3A_MV, srcs, ev, MP_SHARDS)
    adopted = mp_apply_walls(job)
    acc, restore = mp_join_input(job)
    try:
        drive_s, launches, epochs = mp_drive(db, job)
    finally:
        restore()
    rows, select_s = mp_rows(db, "q3a")
    lpe = mp_check(name, rows, one, launches, epochs)
    joins = [n for n in job.program.nodes if isinstance(n, F.JoinNode)]
    if not joins or joins[0].hot_keys != (0,) \
            or joins[0].hot_rep_side != 1:
        raise AssertionError(f"{name}: hot policy "
                             f"{[(n.hot_keys, n.hot_rep_side) for n in joins]}")
    if rows != off_rows:
        raise AssertionError(f"{name}: rows differ from hot_key_rep off")
    if "on" not in acc:
        raise AssertionError(f"{name}: no epoch ran under the policy")
    return {"events": ev, "shards": MP_SHARDS, "drive_s": drive_s,
            "events_per_s": ev / drive_s, "select_s": select_s,
            "one_shard_s": one_s, "drive_off_s": off_s,
            "growth_replays_off": off_growth,
            "rows": len(rows), "hot_keys": list(joins[0].hot_keys),
            "hot_rep_side": joins[0].hot_rep_side,
            "rebalances": job.rebalances, "adoptions": adopted,
            "bounds": (list(job.program.vnode_bounds)
                       if job.program.vnode_bounds is not None else None),
            "largest_shard_share_off": mp_share(acc_off["off"]),
            "largest_shard_share_on": mp_share(acc["on"]),
            "join_input_rows_on": acc["on"].cpu().tolist(),
            "bucket_exchange_per_epoch_off":
                off_launches["bucket_exchange"] / off_epochs,
            "bucket_exchange_per_epoch_on":
                launches["bucket_exchange"] / epochs,
            "growth_replays": job.growth_replays,
            "exch": [n.exch for n in joins], "epochs_stepped": epochs,
            "launches": launches, "launches_per_epoch": lpe, "card": smi}


def mp_q1_fed8(dev, smi) -> dict:
    """q1_fed8: Q1 host-fed (with its admission bucket) on 8 shards:
    each window cut into the shards' event blocks."""
    from risingwave_tpu_torch.device.ingest import shard_cuts
    name, ev = "q1_fed8", MP_FED_EVENTS
    srcs = ((MP_BID_SRC, ", nexmark.ingest='host'"),)
    one = mp_one_shard(dev, name, MP_Q1_MV, srcs, ev)
    db, job = mp_job(dev, name, MP_Q1_MV, srcs, ev, MP_SHARDS)
    if job.ingest is None or job.ingest.n_shards != MP_SHARDS:
        raise AssertionError(f"{name}: not host-fed per shard")
    if job.ingest.buckets.get("bid") is not db._overload.buckets.get("bid"):
        raise AssertionError(f"{name}: no admission bucket wired")
    drive_s, launches, epochs = mp_drive(db, job)
    rows, select_s = mp_rows(db, "q1a")
    lpe = mp_check(name, rows, one, launches, epochs)
    ee = job.program.epoch_events
    ids = job.ingest.host_window(0, ee)[0][0]
    counts = np.diff(shard_cuts(ids, 0, ee, MP_SHARDS)).tolist()
    st = job.ingest.stats()
    job.ingest.close()
    return {"events": ev, "shards": MP_SHARDS, "drive_s": drive_s,
            "events_per_s": ev / drive_s, "select_s": select_s,
            "rows": len(rows), "window0_shard_rows": counts,
            "ingest": {k: v for k, v in st.items() if k != "sources"},
            "rebalances": job.rebalances,
            "growth_replays": job.growth_replays, "epochs_stepped": epochs,
            "launches": launches, "launches_per_epoch": lpe, "card": smi}


def mp_qa_tiered8(dev, smi) -> dict:
    """qa_tiered8: the host-fed tiered zipf:1.5 group-by on 8 shards,
    each shard's agg clamped below its share of the groups: demotions
    into per-shard cold stores, promotions back."""
    name, ev = "qa_tiered8", MP_QA_EVENTS
    # blind growth: the exchange bucket's first overflow would otherwise
    # size every slot by its projection (the agg past its clamp: the 1
    # MiB budget floor is 8x a 2^11-slot table), and nothing would demote
    cfg = dict(agg_precombine=False, state_tiering=True,
               capacity=MP_QA_CLAMP, predictive_growth=False)
    srcs = ((SQL_QA_SRC, ""),)
    one = mp_one_shard(dev, name, SQL_QA_MV, srcs, ev, chunk=MP_QA_CHUNK,
                       **dict(cfg, capacity=MP_CAPACITY))
    db, job = mp_job(dev, name, SQL_QA_MV, srcs, ev, MP_SHARDS,
                     chunk=MP_QA_CHUNK, **cfg)
    if job.ingest is None or job.tiering is None:
        raise AssertionError(f"{name}: not host-fed and tiered")
    ai = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.AggNode)][0]
    job.hbm_budget_mb = clamp_budget_mb(job, f"{ai}:AggNode.main",
                                        MP_QA_CLAMP)
    drive_s, launches, epochs = mp_drive(db, job)
    rows, select_s = mp_rows(db, "qa")
    lpe = mp_check(name, rows, one, launches, epochs)
    tm = job.tiering
    store = tm.store(ai, -1)
    per_shard = [len(d) for d in store.rows]
    if tm.counters["demotions"] <= 0 or tm.counters["promotions"] <= 0:
        raise AssertionError(f"{name}: demotions / promotions "
                             f"{tm.counters}")
    if sum(1 for c in per_shard if c) < 2:
        raise AssertionError(f"{name}: cold rows on {per_shard}")
    job.ingest.close()
    return {"events": ev, "shards": MP_SHARDS, "drive_s": drive_s,
            "events_per_s": ev / drive_s, "select_s": select_s,
            "rows": len(rows), "clamp_slots": MP_QA_CLAMP,
            "agg_capacity": job.program.nodes[ai].capacity,
            "tiering": dict(tm.counters), "cold_rows_by_shard": per_shard,
            "tier_walls_s": dict(job.tier_walls),
            "rebalances": job.rebalances,
            "growth_replays": job.growth_replays, "epochs_stepped": epochs,
            "launches": launches, "launches_per_epoch": lpe, "card": smi}


def mp_tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(mp_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(mp_tree_bytes(v) for v in tree)
    return 0


def mp_q5_rep(dev, smi) -> dict:
    """q5_rep: q5 on 4 shards x 2 serving replicas: each replica column
    refreshed every epoch, SELECTs alternating over the columns."""
    from risingwave_tpu_torch.device import shard_exec as SE
    from risingwave_tpu_torch.utils.metrics import REGISTRY
    name, ev = "q5_rep", MP_Q5_EVENTS
    srcs = ((MP_BID_SRC, ""),)
    one = mp_one_shard(dev, name, SQL_Q5_MV, srcs, ev)
    one_db, one_job = mp_job(dev, name, SQL_Q5_MV, srcs, ev, MP_Q5_SHARDS)
    mp_drive(one_db, one_job, count=False)
    plain = mp_rows(one_db, "nexmark_q5")[0]
    del one_db, one_job
    if plain != one:
        raise AssertionError(f"{name}: replicas=1 rows differ from the "
                             "1-shard run's")
    db, job = mp_job(dev, name, SQL_Q5_MV, srcs, ev, MP_Q5_SHARDS,
                     replicas=MP_REPLICAS)
    prog = job.program
    if prog.mesh.replicas != MP_REPLICAS:
        raise AssertionError(f"{name}: {prog.mesh}")
    walls = []
    refresh = prog.refresh_replicas

    def timed(states):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh(states)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prog.refresh_replicas = timed
    try:
        drive_s, launches, epochs = mp_drive(db, job)
    finally:
        del prog.refresh_replicas
    lpe = mp_check(name, mp_rows(db, "nexmark_q5")[0], one, launches,
                   epochs)
    rep_bytes = mp_tree_bytes(prog.replica_states)
    state_bytes = mp_tree_bytes(job.states)
    SE.reset_pull_stats()
    c = REGISTRY.counter("serving_replica_pulls_total", "",
                         labels=("replica",))
    base = {r: c.labels(str(r)).value for r in range(MP_REPLICAS)}
    selects = []
    for _ in range(MP_SELECTS):
        db.read_cache.invalidate()
        rows, s = mp_rows(db, "nexmark_q5")
        if rows != one:
            raise AssertionError(f"{name}: a SELECT differs")
        selects.append(s)
    pulls = dict(SE.PULL_STATS["replica_pulls"])
    reg = {r: c.labels(str(r)).value - base[r] for r in range(MP_REPLICAS)}
    if set(pulls) != set(range(MP_REPLICAS)) \
            or max(pulls.values()) - min(pulls.values()) > 1:
        raise AssertionError(f"{name}: pulls by replica {pulls}")
    serving = db.query("SELECT * FROM rw_serving_pulls")
    return {"events": ev, "shards": MP_Q5_SHARDS,
            "replicas": MP_REPLICAS, "drive_s": drive_s,
            "events_per_s": ev / drive_s, "select_s": selects,
            "rows": len(one), "replica_pulls": pulls,
            "serving_replica_pulls_total": reg,
            "rw_serving_pulls": serving,
            "replica_copy_ms": {"median": 1e3 * float(np.median(walls)),
                                "max": 1e3 * max(walls),
                                "refreshes": len(walls)},
            "replica_bytes": rep_bytes, "state_bytes": state_bytes,
            "growth_replays": job.growth_replays, "epochs_stepped": epochs,
            "launches": launches, "launches_per_epoch": lpe, "card": smi}


MP_JOBS = (("q1_reb", mp_q1_reb), ("q3_hot", mp_q3_hot),
           ("q1_fed8", mp_q1_fed8), ("qa_tiered8", mp_qa_tiered8),
           ("q5_rep", mp_q5_rep))


def mesh_policy_phase(dev, smi) -> dict:
    """Phase 4j: the mesh skew policy, host ingest and tiering under
    a mesh, and serving replicas, each job from SQL on the port's
    Database with its rows held to the same SQL's 1-shard run (the
    1-shard runs outside the counted launches)."""
    import gc
    out = {}
    t0 = time.perf_counter()
    for name, fn in MP_JOBS:
        t = time.perf_counter()
        out[name] = fn(dev, smi)
        out[name]["phase_s"] = time.perf_counter() - t
        log(f"[mesh_policy] {name} {json.dumps(out[name])}")
        gc.collect()
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# mesh_devices: the fused mesh over a set of devices in one process
# ---------------------------------------------------------------------------

# 8 shards dealt over the card and the CPU (shard s on md_set(dev)[s % 2]);
# a CPU shard runs the kernels' plain versions because it lies on the CPU
MD_SHARDS = 8
MD_CHUNK = 1 << 14                   # a fused epoch: 64 chunks, 2^20 events
MD_EPOCHS = 4
MD_Q1_CHUNK = 1 << 11
MD_Q3_CHUNK = 1 << 10
MD_EVENTS = {"q1a_fed": MD_EPOCHS << 17, "q3a_grow": MD_EPOCHS << 16,
             "q5_rep": MD_EPOCHS << 20, "qa_tiered": 1 << 20}
# the depth each job was cut to and why: every cut is of depth only
MD_CUTS = {"q1a_fed": "4 epochs of 2^17 events (chunks of 2^11), not of "
                      "2^20: its four CPU shards took 19.6 s for 10 "
                      "epochs of 2^20 stepped (2 rebalances) on the card "
                      "host, 6.2 s for 14 of 2^18 (3)",
           "q3a_grow": "4 epochs of 2^16 events (chunks of 2^10), not of "
                       "2^20: ~0.9 MV rows an event go through the MV "
                       "persist and the SELECT in Python on each of two "
                       "runs (25 s at 4 x 2^17 on the card host)",
           "qa_tiered": "2^20 events (64 epochs of 2^14), half of "
                        "qa_tiered8's 2^21 (32 s there, both runs)"}
# slots a shard: a source's ~7,500 bids of a 2^16-event epoch overflow
# its ~940-row buckets at 512
MD_Q3_CAPACITY = 1 << 9
# x MP_REPLICAS: the data shards on the card, the replica column on the CPU
MD_Q5_SHARDS = 4
MD_QA_CHUNK = TIER_EPOCH_EVENTS // 64
MD_QA_CLAMP = MP_QA_CLAMP
MD_POINT = "fused.dispatch"
MD_KERNELS = {"q1a_fed": MP_KERNELS["q1_fed8"],
              "q3a_grow": MP_KERNELS["q3_hot"],
              "q5_rep": MP_KERNELS["q5_rep"],
              "qa_tiered": MP_KERNELS["qa_tiered8"]}


def md_set(dev):
    """The phase's device set: the card, then the CPU."""
    return [dev, torch.device("cpu")]


def md_copies():
    """Count the cross-device copies of the mesh collectives
    (`parallel.mesh.move`): bytes, calls and host wall by direction (a
    copy onto the CPU blocks, so its wall is the copy's; one onto the card
    returns once queued). -> (counters, restore)."""
    import risingwave_tpu_torch.parallel.mesh as MESH
    acc = {}
    base = MESH.move

    def counted(x, d):
        if x.device == d:
            return base(x, d)
        t0 = time.perf_counter()
        out = base(x, d)
        k = f"{x.device.type}->{d.type}"
        c = acc.setdefault(k, {"calls": 0, "bytes": 0, "host_s": 0.0})
        c["calls"] += 1
        c["bytes"] += x.numel() * x.element_size()
        c["host_s"] += time.perf_counter() - t0
        return out
    MESH.move = counted

    def restore():
        MESH.move = base
    return acc, restore


def md_stage(job):
    """Keep the last input of the job's first exchange (the per-source
    kernel's shapes on this path). -> (kept, restore)."""
    kept = {}
    base = SE.exchange_delta

    def keep(mesh, node, xi, deltas, **kw):
        if xi == 0 and (not kept or kept["node"] is node):
            kept.update(node=node, deltas=deltas)
        return base(mesh, node, xi, deltas, **kw)
    SE.exchange_delta = keep

    def restore():
        SE.exchange_delta = base
    return kept, restore


def md_one(dev, name, mv, srcs, events, shards, chunk, prepare=None,
           **cfg):
    """The same SQL with every shard on the card: its rows."""
    db, job = mp_job([dev], name, mv, srcs, events, shards, chunk, **cfg)
    if prepare is not None:
        prepare(job)
    mp_drive(db, job, count=False)
    rows = mp_rows(db, mv.split()[3])[0]
    if job.ingest is not None:
        job.ingest.close()
    return rows


def md_job(dev, smi, name, mv, srcs, shards=MD_SHARDS, chunk=MD_CHUNK,
           check=None, keep=None, prepare=None, **cfg):
    """One job of the phase: the SQL's run over `md_set(dev)` against its
    run with every shard on the card (rows in order) and `check` (its
    numpy oracle), launches, copies and walls of the mixed drive.
    `prepare(job)` runs on each job before its drive; `keep` (a dict)
    receives the mixed Database and job."""
    ev = MD_EVENTS[name]
    t0 = time.perf_counter()
    one = md_one(dev, name, mv, srcs, ev, shards, chunk, prepare, **cfg)
    one_s = time.perf_counter() - t0
    db, job = mp_job(md_set(dev), name, mv, srcs, ev, shards, chunk, **cfg)
    if prepare is not None:
        prepare(job)
    mesh = job.program.mesh
    copies, restore = md_copies()
    kept, unkeep = md_stage(job)
    try:
        drive_s, launches, epochs = mp_drive(db, job)
    finally:
        restore()
        unkeep()
    rows, select_s = mp_rows(db, mv.split()[3])
    lpe = mp_check(name, rows, one, launches, epochs, MD_KERNELS[name])
    if check is not None:
        check(rows)
    rep = {"events": ev, "epoch_events": job.program.epoch_events,
           "shards": shards, "replicas": mesh.replicas,
           "layout": mesh.layout(),
           "slots": [[str(d) for d in row] for row in mesh.slots],
           "single_device": mesh.single_device, "drive_s": drive_s,
           "events_per_s": ev / drive_s, "select_s": select_s,
           "one_device_s": one_s, "rows": len(rows),
           "equal_one_device": True, "oracle": check is not None,
           "copies": copies, "growth_replays": job.growth_replays,
           "rebalances": job.rebalances, "epochs_stepped": epochs,
           "launches": launches, "launches_per_epoch": lpe, "card": smi}
    if keep is not None:
        keep.update(db=db, job=job, rows=rows, stage=kept)
    elif job.ingest is not None:
        job.ingest.close()
    return rep


def md_per_source(stage) -> dict:
    """The per-source `bucket_exchange` (n_src = 1: a source's call on a
    mesh over several devices) at this path's shape: source 0, on the
    card, of the kept exchange, held to its plain version to the bit
    (`bxs_entry`)."""
    node = stage["node"]
    keys, masks, signs, arrays = stage_sources((node, stage["deltas"]))
    if keys[0].device.type != "cuda":
        raise AssertionError(f"per-source bucket_exchange: source 0 on "
                             f"{keys[0].device}")
    dts = "+".join(str(a.dtype).replace("torch.", "") for a in arrays[0])
    row = bxs_entry([keys[0]], [masks[0]], MD_SHARDS, node.exch,
                    [arrays[0]], [0] * len(arrays[0]),
                    f"q1a_fed agg, source 0 of {MD_SHARDS}: B="
                    f"{keys[0].shape[0]}, n={MD_SHARDS}, cap={node.exch}, "
                    f"{dts}", signs=[signs[0]])
    row["max_abs_err"] = 0.0
    return row


def md_q1a(dev, smi) -> dict:
    """q1a host-fed over zipf:4 bidders: per-shard feeds to the card and
    to the CPU, a rebalance whose rebuild-replay lays every shard anew on
    its device."""
    srcs = ((MP_BID_SRC, ", nexmark.ingest='host',"
             " nexmark.key.dist='zipf:4'"),)
    keep = {}
    rep = md_job(dev, smi, "q1a_fed", MP_Q1_MV, srcs, chunk=MD_Q1_CHUNK,
                 keep=keep)
    job = keep["job"]
    if job.ingest is None or job.ingest.n_shards != MD_SHARDS:
        raise AssertionError("q1a_fed: not host-fed per shard")
    if job.rebalances < 1:
        raise AssertionError("q1a_fed: no rebalance")
    rep["bounds"] = list(job.program.vnode_bounds or ())
    rep["ingest"] = {k: v for k, v in job.ingest.stats().items()
                     if k != "sources"}
    rep["bucket_exchange_per_source"] = md_per_source(keep["stage"])
    job.ingest.close()
    return rep


def md_q3a(dev, smi, devices=None) -> dict:
    """q3a with a small start capacity: its exchange buckets overflow and
    the job grows and replays over the set."""
    srcs = ((MP_BID_SRC, ""), (MP_AUCTION_SRC, ""))
    oracle = q3a_oracle(dev, MD_EVENTS["q3a_grow"])
    keep = {}
    rep = md_job(dev, smi, "q3a_grow", SQL_Q3A_MV, srcs, chunk=MD_Q3_CHUNK,
                 check=lambda r: check_q3a_visible(r, oracle), keep=keep,
                 capacity=MD_Q3_CAPACITY, hot_key_rep=False)
    rep["exch"] = {f"{i}:{type(n).__name__}": n.exch
                   for i, n in enumerate(keep["job"].program.nodes)
                   if n.exch is not None}
    if rep["growth_replays"] < 1 \
            or max(rep["exch"].values()) <= MD_Q3_CAPACITY:
        raise AssertionError(f"q3a_grow: {rep['growth_replays']} growth "
                             f"replays, exchange buckets {rep['exch']}")
    return rep


def md_q5(dev, smi) -> dict:
    """q5 on 4 shards x 2 replicas: the data shards on the card, the
    replica column on the CPU, SELECTs alternating over the two; then
    faulted once (`fused.dispatch` after the second epoch) and healed in
    place to the same rows."""
    from risingwave_tpu_torch.utils import failpoint as FP
    srcs = ((MP_BID_SRC, ""),)
    oracle = q5_oracle(dev, MD_EVENTS["q5_rep"])
    keep, walls = {}, []

    def timed_replicas(job):
        # each replica refresh's wall, the card synced around it: one
        # list a job, the card-only run's first
        prog = job.program
        refresh, w = prog.refresh_replicas, []
        walls.append(w)

        def timed(states):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refresh(states)
            torch.cuda.synchronize()
            w.append(1e3 * (time.perf_counter() - t0))
        prog.refresh_replicas = timed
    rep = md_job(dev, smi, "q5_rep", SQL_Q5_MV, srcs, shards=MD_Q5_SHARDS,
                 check=lambda r: check_q5_rows(r, oracle), keep=keep,
                 prepare=timed_replicas, replicas=MP_REPLICAS)
    db, job, want = keep["db"], keep["job"], keep["rows"]
    mesh = job.program.mesh
    if mesh.column(1) != [md_set(dev)[1]] * MD_Q5_SHARDS:
        raise AssertionError(f"q5_rep: replica column on {mesh.column(1)}")
    rep["replica_bytes"] = mp_tree_bytes(job.program.replica_states)
    # the copies into the replica column: to the CPU here, on the card in
    # the run with every slot on it
    one_w, w = walls
    rep["replica_copy_ms"] = {
        "to_cpu": {"median": float(np.median(w)), "max": max(w),
                   "refreshes": len(w)},
        "on_card": {"median": float(np.median(one_w)), "max": max(one_w),
                    "refreshes": len(one_w)}}
    SE.reset_pull_stats()
    for _ in range(MP_SELECTS):
        db.read_cache.invalidate()
        if mp_rows(db, "nexmark_q5")[0] != want:
            raise AssertionError("q5_rep: a SELECT differs")
    pulls = dict(SE.PULL_STATS["replica_pulls"])
    if set(pulls) != {0, 1} or max(pulls.values()) - min(pulls.values()) > 1:
        raise AssertionError(f"q5_rep: pulls by replica {pulls}")
    rep["replica_pulls"] = pulls
    del db, job, keep
    db, job = mp_job(md_set(dev), "q5_rep", SQL_Q5_MV, srcs,
                     MD_EVENTS["q5_rep"], MD_Q5_SHARDS, MD_CHUNK,
                     replicas=MP_REPLICAS)
    recs = watch_recoveries(job)

    def arm(k):
        if k == 2:
            FP.arm(MD_POINT, 1.0, 0, 1)
    t0 = time.perf_counter()
    try:
        drive_ticks(db, job, arm)
    finally:
        FP.reset()
    torch.cuda.synchronize()
    healed_s = time.perf_counter() - t0
    if job.recoveries != 1 or len(recs) != 1 \
            or db._fused.get("nexmark_q5") is not job:
        raise AssertionError(f"q5_rep {MD_POINT}: {job.recoveries} "
                             "recoveries")
    if mp_rows(db, "nexmark_q5")[0] != want:
        raise AssertionError(f"q5_rep {MD_POINT}: rows differ from the "
                             "undisturbed run's")
    rep["healed"] = {"point": MD_POINT, "drive_s": healed_s,
                     "recovery": recs}
    return rep


def md_qa(dev, smi) -> dict:
    """The tiered group-by, host-fed, each shard clamped below its share
    of the groups: cold rows demoted from the card's shards and from the
    CPU's into their shards' cold stores, promoted back."""
    cfg = dict(agg_precombine=False, state_tiering=True,
               capacity=MD_QA_CLAMP, predictive_growth=False)
    ev = MD_EVENTS["qa_tiered"]
    srcs = ((SQL_QA_SRC, ""),)
    oracle = qa_oracle(ev)
    keep = {}

    def agg_of(job):
        return [i for i, n in enumerate(job.program.nodes)
                if isinstance(n, F.AggNode)][0]

    def clamp(job):
        job.hbm_budget_mb = clamp_budget_mb(
            job, f"{agg_of(job)}:AggNode.main", MD_QA_CLAMP)
    rep = md_job(dev, smi, "qa_tiered", SQL_QA_MV, srcs, chunk=MD_QA_CHUNK,
                 check=lambda r: check_qa_rows(r, oracle), keep=keep,
                 prepare=clamp, **cfg)
    job = keep["job"]
    tm = job.tiering
    ai = agg_of(job)
    devs = job.program.mesh.devices
    per_shard = [len(d) for d in tm.store(ai, -1).rows]
    on = {str(x): sum(c for c, d in zip(per_shard, devs) if d == x)
          for x in md_set(dev)}
    if tm.counters["demotions"] <= 0 or not all(on.values()):
        raise AssertionError(f"qa_tiered: demotions {tm.counters}, cold "
                             f"rows by shard {per_shard}")
    rep.update({"clamp_slots": MD_QA_CLAMP, "tiering": dict(tm.counters),
                "cold_rows_by_shard": per_shard, "cold_rows_on": on,
                "tier_walls_s": dict(job.tier_walls)})
    job.ingest.close()
    return rep


MD_JOBS = (("q1a_fed", md_q1a), ("q3a_grow", md_q3a), ("q5_rep", md_q5),
           ("qa_tiered", md_qa))


def mesh_devices_phase(dev, smi) -> dict:
    """Phase 4k: the fused mesh over the card and the CPU in one process,
    each job from SQL on the port's Database (8 shards over
    `md_set(dev)`; q5 4 x 2 replicas) with its rows held, in order, to
    the same SQL's run with every shard on the card (outside the counted
    launches) and to its numpy oracle where the smoke has one; with more
    than one card, q3a over every card too."""
    import gc
    out = {"cuts": MD_CUTS, "device_count": torch.cuda.device_count()}
    t0 = time.perf_counter()
    for name, fn in MD_JOBS:
        t = time.perf_counter()
        out[name] = fn(dev, smi)
        out[name]["phase_s"] = time.perf_counter() - t
        log(f"[mesh_devices] {name} {json.dumps(out[name])}")
        gc.collect()
    out["bucket_exchange_per_source"] = \
        out["q1a_fed"].pop("bucket_exchange_per_source")
    layouts = {name: out[name]["layout"] for name, _ in MD_JOBS}
    if torch.cuda.device_count() > 1:
        srcs = ((MP_BID_SRC, ""), (MP_AUCTION_SRC, ""))
        ev = MD_EVENTS["q3a_grow"]
        t = time.perf_counter()
        db, job = mp_job(dev, "q3a_cards", SQL_Q3A_MV, srcs, ev, MD_SHARDS,
                         MD_Q3_CHUNK, capacity=MD_Q3_CAPACITY,
                         hot_key_rep=False)
        drive_s, _launches, _epochs = mp_drive(db, job, count=False)
        rows = mp_rows(db, "q3a")[0]
        one = md_one(dev, "q3a_cards", SQL_Q3A_MV, srcs, ev, MD_SHARDS,
                     MD_Q3_CHUNK, capacity=MD_Q3_CAPACITY,
                     hot_key_rep=False)
        if rows != one:
            raise AssertionError("q3a_cards: rows differ from cuda:0's")
        out["q3a_cards"] = {"layout": job.program.mesh.layout(),
                            "drive_s": drive_s, "rows": len(rows),
                            "phase_s": time.perf_counter() - t}
        layouts["q3a_cards"] = out["q3a_cards"]["layout"]
        del db, job
    out["layouts"] = layouts
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# wire: the port's Postgres wire server in front of the fused SQL path, the
# operator CLI behind it, the sqllogictest runner on the card
# ---------------------------------------------------------------------------

# COPY FROM STDIN (csv) into a table with a device-path MV over it
WIRE_COPY_ROWS = 1 << 16
WIRE_COPY_KEYS = 1 << 12
WIRE_COPY_FRAME = 1 << 16            # bytes a CopyData message
WIRE_COPY_TABLE = "CREATE TABLE wire_copy (k BIGINT, v BIGINT)"
WIRE_COPY_MV = ("CREATE MATERIALIZED VIEW wire_copy_agg AS SELECT k,"
                " count(*) AS c, sum(v) AS s FROM wire_copy GROUP BY k")
# (risectl arguments, exit code, prints JSON, opens the spill store and
# so takes the directory's process lock: these run one after another,
# the others in parallel beside them)
WIRE_CTL = ((("jobs",), 0, False, True), (("manifest",), 0, True, True),
            (("fused-stats",), 0, True, True),
            (("profile",), 0, True, False), (("trace",), 0, False, False),
            (("trace", "export"), 0, True, False),
            (("skew", "--json"), 0, True, False),
            (("tiering",), 0, False, True),
            (("blackbox", "list"), 0, False, False),
            (("dlq",), 0, False, True),
            (("compile-status",), 0, True, True),
            (("compile-status", "--offline"), 1, False, False),
            (("failpoints",), 0, False, False))
# the integer type OIDs of a RowDescription (int8, int2, int4)
_PG_INT = (20, 21, 23)


class PgClient:
    """A raw Postgres protocol-v3 client: startup, simple queries, the
    extended protocol and COPY FROM STDIN, each message as (tag, body)."""

    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=900)
        self.buf, self.pos = bytearray(), 0

    def _recv(self, n):
        """The next n bytes (the buffer is read by position: a large
        result costs the client no quadratic copying)."""
        while len(self.buf) - self.pos < n:
            got = self.sock.recv(1 << 20)
            if not got:
                raise ConnectionError("server closed the connection")
            if self.pos:
                del self.buf[:self.pos]
                self.pos = 0
            self.buf += got
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def send(self, tag, payload=b""):
        self.sock.sendall(tag + struct.pack(">I", len(payload) + 4)
                          + payload)

    def read_msg(self):
        tag = self._recv(1)
        (ln,) = struct.unpack(">I", self._recv(4))
        return tag, self._recv(ln - 4)

    def read_until(self, *stop):
        msgs = []
        while True:
            msgs.append(self.read_msg())
            if msgs[-1][0] in stop:
                return msgs

    def startup(self):
        body = struct.pack(">I", 196608) + b"user\0smoke\0database\0dev\0\0"
        self.sock.sendall(struct.pack(">I", len(body) + 4) + body)
        msgs = self.read_until(b"Z")
        if msgs[0] != (b"R", b"\0\0\0\0"):
            raise AssertionError(f"wire startup answered {msgs[0]!r}")
        return msgs

    def query(self, sql):
        """A simple-protocol query; raises on an ErrorResponse."""
        self.send(b"Q", sql.encode() + b"\0")
        return wire_ok(self.read_until(b"Z"), sql)

    def copy(self, sql, frames):
        """COPY ... FROM STDIN: the frames as CopyData, then CopyDone."""
        self.send(b"Q", sql.encode() + b"\0")
        t, b = self.read_msg()
        if t != b"G":
            raise AssertionError(f"{sql}: no CopyInResponse: {t!r} {b!r}")
        for f in frames:
            self.send(b"d", f)
        self.send(b"c")
        return wire_ok(self.read_until(b"Z"), sql)

    def portal(self, sql, oids, values, limit):
        """Parse / Bind (text parameters) / Describe / Execute with a row
        limit, repeated while the portal suspends, then Sync. Returns the
        messages and the number of suspensions."""
        self.send(b"P", b"\0" + sql.encode() + b"\0"
                  + struct.pack(f">H{len(oids)}I", len(oids), *oids))
        bind = b"\0\0" + struct.pack(">HH", 0, len(values))
        for v in values:
            bind += struct.pack(">I", len(v)) + v
        self.send(b"B", bind + struct.pack(">H", 0))
        self.send(b"D", b"P\0")
        msgs, suspended = [], 0
        while True:
            self.send(b"E", b"\0" + struct.pack(">I", limit))
            self.send(b"H")
            part = self.read_until(b"s", b"C", b"E")
            msgs += part
            if part[-1][0] != b"s":
                break
            suspended += 1
        self.send(b"S")
        msgs += self.read_until(b"Z")
        return wire_ok(msgs, sql), suspended

    def close(self):
        self.send(b"X")
        self.sock.close()


def wire_ok(msgs, what):
    err = [b for t, b in msgs if t == b"E"]
    if err:
        raise AssertionError(f"{what!r:.200}: ErrorResponse {err[0]!r}")
    return msgs


def wire_rows(msgs):
    """DataRows decoded by their RowDescription's type OIDs: integers,
    floats, booleans, TIMESTAMP to microseconds since the epoch (the
    engine's value), everything else text."""
    import datetime as dt
    from decimal import Decimal
    desc = next(b for t, b in msgs if t == b"T")
    (n,) = struct.unpack(">H", desc[:2])
    oids, pos = [], 2
    for _ in range(n):
        pos = desc.index(b"\0", pos) + 1
        oids.append(struct.unpack(">IHIhih", desc[pos:pos + 18])[2])
        pos += 18
    epoch = dt.datetime(1970, 1, 1)

    def value(raw, oid):
        s = raw.decode()
        if oid in _PG_INT:
            return int(s)
        if oid in (700, 701):
            return float(s)
        if oid == 1700:
            return Decimal(s)
        if oid == 16:
            return s == "t"
        if oid == 1114:
            return (dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S.%f")
                    - epoch) // dt.timedelta(microseconds=1)
        return s
    rows = []
    for t, b in msgs:
        if t != b"D":
            continue
        (k,) = struct.unpack(">H", b[:2])
        pos, row = 2, []
        for oid in oids[:k]:
            (ln,) = struct.unpack(">i", b[pos:pos + 4])
            pos += 4
            if ln < 0:
                row.append(None)
                continue
            row.append(value(b[pos:pos + ln], oid))
            pos += ln
        rows.append(tuple(row))
    return rows


def wire_tag(msgs):
    return [b.rstrip(b"\0").decode() for t, b in msgs if t == b"C"][-1]


def wire_select(client, db, lock, sql):
    """`sql` over the wire (simple protocol) beside the same statement
    in process: `db.query` (which flushes first) and the serving path
    the server runs (`_run_batch_select(serving=True)`, the wire's own
    cost the difference). The rows must be equal. Returns the rows, the
    walls and the launch counts read just after the wire's SELECT."""
    from risingwave_tpu_torch.sql.parser import parse_sql
    t = time.perf_counter()
    rows = wire_rows(client.query(sql))
    wire_s = time.perf_counter() - t
    _sync(db.torch_device or "cpu")
    launches = dict(K.LAUNCHES)
    with lock:
        t = time.perf_counter()
        served = db._run_batch_select(parse_sql(sql)[0], serving=True)
        served_s = time.perf_counter() - t
        t = time.perf_counter()
        queried = db.query(sql)
        query_s = time.perf_counter() - t
    if rows != served or rows != [tuple(r) for r in queried]:
        raise AssertionError(f"{sql}: {len(rows)} rows over the wire differ "
                             f"from the {len(served)} served in process")
    return rows, {"wire_s": wire_s, "serving_in_process_s": served_s,
                  "db_query_s": query_s, "rows": len(rows)}, launches


def wire_portal(client, sql, col, rows):
    """The extended protocol: `sql` with one BIGINT parameter (the median
    of column `col` of `rows`) under a row limit below the result, so the
    portal suspends and resumes; its rows must be `rows` with col >= $1,
    in order."""
    vals = sorted(r[col] for r in rows)
    bound = vals[len(vals) // 2]
    want = [r for r in rows if r[col] >= bound]
    limit = max(1, len(want) // 3)
    t = time.perf_counter()
    msgs, suspended = client.portal(sql, (20,), (str(bound).encode(),),
                                    limit)
    wall = time.perf_counter() - t
    got = wire_rows(msgs)
    if got != want or suspended < 1:
        raise AssertionError(f"{sql}: the portal gave {len(got)} rows "
                             f"({suspended} suspensions), want {len(want)}")
    return {"wire_s": wall, "rows": len(got), "param": bound,
            "row_limit": limit, "suspended": suspended}


def wire_drive(client, job, dev):
    """FLUSH over the wire until `job` has drained, then once more; the
    epochs it dispatched (FusedProgram.step calls), the FLUSHes and the
    wall, launches zeroed just before."""
    steps = [0]
    step = job.program.step

    def counted(*a, **kw):
        steps[0] += 1
        return step(*a, **kw)
    job.program.step = counted
    try:
        _sync(dev)
        K.reset_launches()
        t = time.perf_counter()
        flushes = 0
        while not job.drained:
            client.query("FLUSH")
            flushes += 1
        client.query("FLUSH")
        _sync(dev)
        wall = time.perf_counter() - t
    finally:
        del job.program.step
    return {"drive_s": wall, "flushes": flushes + 1,
            "epochs_dispatched": steps[0], "growth_replays":
            job.growth_replays}


def wire_copy(client, db, lock):
    """COPY FROM STDIN (csv) of WIRE_COPY_ROWS seeded (k, v) rows into a
    table with a device-path group-by over it; the MV read over the wire
    must equal a numpy group-by of the rows."""
    rng = np.random.default_rng(23)
    k = rng.integers(0, WIRE_COPY_KEYS, WIRE_COPY_ROWS)
    v = rng.integers(-(1 << 20), 1 << 20, WIRE_COPY_ROWS)
    text = "".join(f"{a},{b}\n" for a, b in zip(k.tolist(), v.tolist()))
    data = text.encode()
    cut, frames = 0, []
    while cut < len(data):
        end = data.rfind(b"\n", cut, cut + WIRE_COPY_FRAME) + 1 \
            if cut + WIRE_COPY_FRAME < len(data) else len(data)
        frames.append(data[cut:end])
        cut = end
    client.query(WIRE_COPY_TABLE)
    client.query(WIRE_COPY_MV)
    t = time.perf_counter()
    tag = wire_tag(client.copy("COPY wire_copy FROM STDIN WITH (FORMAT csv)",
                               frames))
    copy_s = time.perf_counter() - t
    if tag != f"COPY {WIRE_COPY_ROWS}":
        raise AssertionError(f"COPY answered {tag!r}")
    rows, sel, launches = wire_select(client, db, lock,
                                      "SELECT * FROM wire_copy_agg")
    keys, (cnt, tot) = groupby_reduce(k, [("sum", np.ones_like(k)),
                                          ("sum", v)])
    want = [(int(a), int(b), int(c)) for a, b, c in zip(keys, cnt, tot)]
    if sorted(rows) != want:
        raise AssertionError(f"wire_copy_agg: {len(rows)} rows differ from "
                             f"numpy's {len(want)}")
    engines = [type(e).__name__ for e in sql_engines(db, "wire_copy_agg")]
    if not engines:
        raise AssertionError("wire_copy_agg runs on no device engine")
    return rows, {"rows": WIRE_COPY_ROWS, "frames": len(frames),
                  "bytes": len(data), "copy_s": copy_s,
                  "rows_per_s": WIRE_COPY_ROWS / copy_s, "select": sel,
                  "engines": engines, "launches": launches}


def wire_ctl(d, dev, fused):
    """Each WIRE_CTL command of `python -m risingwave_tpu_torch.ctl` in a
    process of its own against the data directory (its Database, where
    it opens one, on the card): those that take the directory's lock
    one after another, the rest started together beside them. Its exit
    code, its JSON parsed, its wall (start to exit); fused-stats'
    committed events must equal `fused` (MV -> events)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)

    def start(args):
        argv = [sys.executable, "-m", "risingwave_tpu_torch.ctl", *args]
        if args != ("failpoints",):
            argv += ["--data-dir", d]
        if args == ("trace", "export"):
            argv += ["-o", os.path.join(d, "trace_export.json")]
        if dev.type == "cpu":
            argv += ["--torch-device", "cpu"]
        t = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=here, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        got = {}

        def wait():
            got["out"] = proc.communicate(timeout=600)
            got["wall"] = time.perf_counter() - t
        waiter = threading.Thread(target=wait)
        waiter.start()
        return argv, proc, waiter, got

    def finish(args, rc_want, is_json, argv, proc, waiter, got):
        waiter.join()
        (stdout, stderr), wall = got["out"], got["wall"]
        name = " ".join(args)
        if proc.returncode != rc_want:
            raise AssertionError(f"risectl {name}: exit {proc.returncode}, "
                                 f"want {rc_want}\n{stdout[-2000:]}"
                                 f"{stderr[-2000:]}")
        doc = None
        if is_json and args == ("trace", "export"):
            with open(argv[argv.index("-o") + 1]) as f:
                doc = json.load(f)
            if EX.validate_chrome(doc):
                raise AssertionError("risectl trace export: invalid Chrome "
                                     "trace")
        elif is_json:
            doc = json.loads(stdout)
        rep = {"wall_s": wall, "rc": proc.returncode,
               "stdout_bytes": len(stdout)}
        if args == ("fused-stats",):
            got = {mv: r["committed_events"] for mv, r in doc.items()}
            if got != fused:
                raise AssertionError(f"risectl fused-stats: committed events "
                                     f"{got}, the drive's {fused}")
            rep["committed_events"] = got
        if args == ("compile-status",):
            if any(r["aot"] for r in doc.values()):
                raise AssertionError("risectl compile-status: aot on")
            rep["signatures"] = {mv: len(r["signatures"])
                                 for mv, r in doc.items()}
        return name, rep

    out = {}
    t0 = time.perf_counter()
    free = [(c[:3], start(c[0])) for c in WIRE_CTL if not c[3]]
    for args, rc_want, is_json, _locks in (c for c in WIRE_CTL if c[3]):
        name, r = finish(args, rc_want, is_json, *start(args))
        out[name] = r
    for spec, started in free:
        name, r = finish(*spec, *started)
        out[name] = r
    out["all_s"] = time.perf_counter() - t0
    return out


def wire_slt(dev):
    """The e2e .slt files through the port's sqllogictest runner, each on
    a Database of its own with the device path (DeviceConfig defaults:
    eligible MVs fuse) on `dev`; each file's wall."""
    import glob
    from risingwave_tpu_torch.sql import Database
    from risingwave_tpu_torch.testing import run_slt_file
    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(here, "e2e_test", "**", "*.slt"),
                             recursive=True))
    if not paths:
        raise AssertionError("no .slt files under e2e_test/")
    out = {}
    for p in paths:
        t = time.perf_counter()
        db = run_slt_file(p, db=Database(device="on", torch_device=dev))
        _sync(dev)
        engines = {}
        for name, obj in db.catalog.objects.items():
            rt = obj.runtime if isinstance(obj.runtime, dict) else {}
            if rt.get("shared") is not None:
                for e in sql_engines(db, name):
                    k = type(e).__name__
                    engines[k] = engines.get(k, 0) + 1
        out[os.path.relpath(p, here)] = {
            "wall_s": time.perf_counter() - t, "fused": sorted(db._fused),
            "device_engines": engines}
    return out


def wire_only(dev, smi) -> dict:
    """`--wire`: q5 and q7 hand-built and from SQL (what the wire phase is
    held to), then the wire phase."""
    kept, sql, hand = {}, {}, {}
    for name, make, oracle, check, kernels, events in (
            ("q5", q5_job, q5_oracle, check_q5_rows, Q5_KERNELS, Q5_EVENTS),
            ("q7", q7_job, q7_oracle, check_q7_rows, Q7_KERNELS,
             Q7_EVENTS)):
        o = oracle(dev)
        kept[name] = lambda r, o=o, check=check: check(r, o)
        job = make(dev)
        got = {}
        r = path_phase(name, job, events, kernels,
                       lambda rows, got=got, c=kept[name]: (
                           got.update(rows=rows), c(rows)), smi)
        hand[name] = (got["rows"], r["launches"], r["epochs_dispatched"],
                      node_list(job))
        del job
    q5_rows = {}
    for name in ("q5_sql", "q7_sql"):
        hp = name[:2]
        sql[name] = fused_sql_phase(name, dev, smi, hand.pop(hp), kept[hp],
                                    q5_rows if name == "q5_sql" else None)
    return wire_phase(dev, smi, sql["q5_sql"], q5_rows["rows"], kept["q5"],
                      kept["q7"], sql["q7_sql"])


def wire_phase(dev, smi, q5_sql, q5_sql_rows, q5_check, q7_check,
               q7_sql=None, events=Q5_EVENTS, kernels=Q5_KERNELS) -> dict:
    """The `wire` phase: the port's PgServer over a Database on `dev`
    (DeviceConfig(capacity=2^16), a data directory, a checkpoint every
    tick); over the wire CREATE SOURCE, q5's and q7's CREATE MATERIALIZED
    VIEW, FLUSH until each has drained, SELECT * and a parameterised
    portal that suspends; the rows equal the oracles (q5's also q5_sql's
    from this run) and q5's launches per epoch equal q5_sql's; COPY into
    a table with a device MV over it; the server stopped, risectl in
    processes of their own on the directory; a Database reopened on it
    with device="auto" behind a second server, whose first SELECTs equal
    the rows before; the .slt files on the card."""
    import gc
    from risingwave_tpu_torch.pgwire import PgServer
    from risingwave_tpu_torch.sql import Database
    from risingwave_tpu_torch.state import SpillStateStore
    d = tempfile.mkdtemp(prefix="rw_wire_")
    rep = {"events": events, "card": smi}
    try:
        db = fused_database(dev, d, capacity=SQL_FUSED_CAPACITY)
        t = time.perf_counter()
        srv = PgServer(db).start()
        rep["server_start_s"] = time.perf_counter() - t
        t = time.perf_counter()
        c = PgClient(srv.host, srv.port)
        c.startup()
        rep["connect_s"] = time.perf_counter() - t
        c.query(SQL_BID_SRC.format(n=events, c=SQL_FUSED_CHUNK))
        rows, kept = {}, {}
        # (MV, CREATE, oracle check, the portal's parameter column)
        for mv, sql, check, (col, name) in (
                ("nexmark_q5", SQL_Q5_MV, q5_check, (1, "num")),
                ("nexmark_q7", SQL_Q7_MV, q7_check, (1, "price"))):
            t = time.perf_counter()
            c.query(sql)
            r = {"create_s": time.perf_counter() - t}
            job = fused_job_of(db, mv, f"{mv} over the wire")
            r.update(wire_drive(c, job, dev))
            rows[mv], r["select"], r["launches"] = wire_select(
                c, db, srv.lock, f"SELECT * FROM {mv}")
            check(rows[mv])
            r["portal"] = wire_portal(
                c, f"SELECT * FROM {mv} WHERE {name} >= $1", col, rows[mv])
            kept[mv] = job.counter
            rep[mv] = r
            log(f"[wire] {mv} {json.dumps(r)}")
            del job
        q5w = rep["nexmark_q5"]
        if rows["nexmark_q5"] != q5_sql_rows:
            raise AssertionError("q5 over the wire: rows differ from "
                                 "q5_sql's")
        # launches per epoch of the wire's q5 against q5_sql's
        per = {k: [q5w["launches"].get(k, 0) / q5w["epochs_dispatched"],
                   q5_sql["launches"].get(k, 0)
                   / q5_sql["epochs_dispatched"]]
               for k in sorted(set(q5w["launches"]) | set(q5_sql["launches"]))
               if q5w["launches"].get(k, 0) or q5_sql["launches"].get(k, 0)}
        q5w["launches_per_epoch_vs_q5_sql"] = per
        differ = {k: v for k, v in per.items() if v[0] != v[1]}
        if differ:
            raise AssertionError(f"q5 over the wire: launches per epoch "
                                 f"(wire, q5_sql) differ: {differ}")
        missing = [k for k in kernels if not q5w["launches"].get(k)]
        if missing:
            raise AssertionError(f"q5 over the wire never launched {missing}")
        if q7_sql is not None:
            q7w = rep["nexmark_q7"]
            q7w["launches_per_epoch_vs_q7_sql"] = {
                k: [q7w["launches"].get(k, 0) / q7w["epochs_dispatched"],
                    q7_sql["launches"].get(k, 0)
                    / q7_sql["epochs_dispatched"]]
                for k in sorted(set(q7w["launches"])
                                | set(q7_sql["launches"]))
                if q7w["launches"].get(k, 0)
                or q7_sql["launches"].get(k, 0)}
        rep["q5_sql_drive_s"] = q5_sql["drive_s"]
        rep["q5_sql_select_s"] = q5_sql["select_s"]
        K.reset_launches()
        rows["wire_copy_agg"], rep["copy"] = wire_copy(c, db, srv.lock)
        log(f"[wire] copy {json.dumps(rep['copy'])}")
        c.close()
        srv.stop()
        db.store.close()
        del db, srv, c
        gc.collect()
        # the process-lifetime directory lock passes to risectl
        SpillStateStore.release_dir_lock(d)
        rep["ctl"] = wire_ctl(d, dev, kept)
        log(f"[wire] risectl {json.dumps(rep['ctl'])}")
        t = time.perf_counter()
        db = Database(data_dir=d, device="auto",
                      torch_device=None if dev.type == "cuda" else dev)
        srv = PgServer(db).start()
        rep["reopen_s"] = time.perf_counter() - t
        if db.torch_device != dev:
            raise AssertionError(f"reopened on {db.torch_device}, not {dev}")
        c = PgClient(srv.host, srv.port)
        c.startup()
        rep["reopen_select_s"] = {}
        for mv in rows:
            t = time.perf_counter()
            again = wire_rows(c.query(f"SELECT * FROM {mv}"))
            rep["reopen_select_s"][mv] = time.perf_counter() - t
            if again != rows[mv]:
                raise AssertionError(f"{mv}: the reopened server's SELECT "
                                     f"differs from the rows before")
        c.close()
        srv.stop()
        db.store.close()
        del db, srv, c
        gc.collect()
        rep["slt"] = wire_slt(dev)
        log(f"[wire] reopen {rep['reopen_s']} s, first SELECTs "
            f"{rep['reopen_select_s']}; slt {json.dumps(rep['slt'])}")
        return rep
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the sharded paths: the mesh's shards all on cuda:0
# ---------------------------------------------------------------------------


def mesh_of(dev, n=MESH_SHARDS):
    """n shards laid on the one card."""
    return make_mesh(n, devices=[dev])


def mesh_phase(name, job, events, kernels_needed, check, smi, single=None,
               capture=None):
    """Drive one sharded fused path (as `path_phase`), also timing the
    host wall of its exchanges, and check its rows — against the 1-shard
    run's too, row order included, when `single` (its rows and drive
    seconds, `single_run`) is given. With `capture` (a dict), the last
    input of each exchange stage is kept there, keyed (node index,
    input), for the timings."""
    prog = job.program
    epoch = prog.epoch
    exch_s = [0.0]

    def timed(states, event_lo, feeds=None):
        out = epoch(states, event_lo, feeds)
        exch_s[0] += prog.last_exchange_s
        return out
    prog.epoch = timed
    base = SE.exchange_delta
    if capture is not None:
        def kept(mesh, node, xi, deltas, **kw):
            capture[(prog.nodes.index(node), xi)] = (node, deltas)
            return base(mesh, node, xi, deltas, **kw)
        SE.exchange_delta = kept
    try:
        rows, drive_s, pull_s, launches, epochs = drive(job)
    finally:
        SE.exchange_delta = base
        del prog.epoch
    t = time.perf_counter()
    check(rows)
    if single is not None and rows != single[0]:
        raise AssertionError(f"{name}: rows differ from the 1-shard run's")
    rep = {"events": events, "shards": prog.mesh.n,
           "devices": prog.mesh.layout(), "drive_s": drive_s,
           "drive_s_1_shard": None if single is None else single[1],
           "exchange_s": exch_s[0], "pull_s": pull_s,
           "events_per_s": events / drive_s,
           "growth_replays": job.growth_replays,
           "exch": {f"{i}:{type(n).__name__}": n.exch
                    for i, n in enumerate(prog.nodes) if n.exch is not None},
           "rows": len(rows), "equal_1_shard": single is not None,
           "capacities": {f"{i}:{type(n).__name__}": n.cap_current()
                          for i, n in enumerate(prog.nodes)
                          if n.cap_current()},
           "launches": launches, "epochs_dispatched": epochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    log(f"[main] {name} {json.dumps(rep)}")
    if job.growth_replays < 1:
        raise AssertionError(f"{name} made no growth replay")
    missing = [k for k in kernels_needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    return rep


def single_run(job):
    """(rows, drive seconds) of a 1-shard run of `job`, driven to its
    end."""
    drive_s = run_epochs(job)
    return job.mv_rows_now(), drive_s


def lib_route(keys, live, n, cap, bounds=None):
    """The live rows' placement by library calls -> (destination, slot,
    row) of each placed row, and the bucket counts: a stable argsort of
    the live rows by destination, `bincount`, and the rank in the
    bucket."""
    dest = K.exchange.route_dest(compute_vnodes_dev(keys), n, bounds)
    rows = torch.nonzero(live).squeeze(1)
    d = dest[rows]
    order = torch.argsort(d, stable=True)
    rows, d = rows[order], d[order]
    counts = torch.bincount(d, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(d.shape[0], device=d.device) - starts[d]
    keep = slot < cap
    return d[keep], slot[keep], rows[keep], counts


def lib_bucket_exchange_sources(keys, masks, n, cap, cols, fills,
                                signs=None):
    """PyTorch library composition of the same exchange over every source
    at once: the sources' rows concatenated, a stable argsort of the live
    rows by (destination, source) — the receiver-major bucket order —
    `bincount`, the rank in the bucket, then one scatter per column into
    [n, n_src, cap]."""
    n_src, b = len(keys), keys[0].shape[0]
    dev = keys[0].device
    live = torch.cat([m if signs is None else m & (signs[s] != 0)
                      for s, m in enumerate(masks)])
    dest = K.exchange.route_dest(compute_vnodes_dev(torch.cat(list(keys))),
                                 n, None)
    rows = torch.nonzero(live).squeeze(1)
    bucket = dest[rows] * n_src + torch.div(rows, b, rounding_mode="floor")
    order = torch.argsort(bucket, stable=True)
    rows, bucket = rows[order], bucket[order]
    counts = torch.bincount(bucket, minlength=n * n_src)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(bucket.shape[0], device=dev) - starts[bucket]
    keep = slot < cap
    at, rows = bucket[keep] * cap + slot[keep], rows[keep]
    bufs = []
    for j, f in enumerate(fills):
        col = torch.cat([cs[j] for cs in cols])
        buf = torch.full((n, n_src, cap), f, dtype=col.dtype, device=dev)
        buf.view(-1)[at] = col[rows]
        bufs.append(buf)
    cnt = counts.view(n, n_src).t()
    return bufs, cnt, cnt.max(1).values


def sector_bytes(rows, elt: int) -> int:
    """Bytes of the 32-byte sectors that hold elements `rows` (ascending
    indices) of an array of `elt`-byte elements: what reading just those
    elements moves."""
    if rows.numel() == 0:
        return 0
    return 32 * int(torch.unique_consecutive(rows * elt // 32).numel())


def bx_bound_bytes(keys, mask, n, cap, cols, sign=None) -> int:
    """Bytes bucket_exchange must move on this run's data: the mask read
    whole; the sign read at the masked-in rows, the key at the live rows
    and each column at the placed rows (rows past `cap` drop), each by
    32-byte sectors, and a column that is the key or the sign counted
    once; each [n, cap] buffer, the counts and `need` written."""
    def same(a, b):
        return b is not None and a.data_ptr() == b.data_ptr() \
            and a.dtype == b.dtype and a.numel() == b.numel()
    live = mask if sign is None else mask & (sign != 0)
    placed = lib_route(keys, live, n, cap)[2].sort().values
    nbytes = mask.numel() + sector_bytes(torch.nonzero(live).squeeze(1), 8)
    if sign is not None:
        nbytes += sector_bytes(torch.nonzero(mask).squeeze(1), 4)
    for c in cols:
        if not (same(c, keys) or same(c, sign)):
            nbytes += sector_bytes(placed, c.element_size())
        nbytes += n * cap * c.element_size()
    return nbytes + 8 * (n + 1)


def returned_bytes(tree) -> int:
    """Bytes of the distinct storages that `tree`'s tensors hold (lists,
    tuples and objects' attributes walked, e.g. routed Deltas)."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, (tuple, list)):
            for e in x:
                walk(e)
        elif hasattr(x, "__dict__"):
            for e in vars(x).values():
                walk(e)
    walk(tree)
    return sum(seen.values())


def temp_bytes(fn) -> dict:
    """Device memory of one call of `fn`: the peak above what was
    allocated before it, what its result holds, and the peak beyond that
    (the call's temporaries)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    held = returned_bytes(res)
    del res
    return {"peak_bytes": peak, "returned_bytes": held,
            "temp_bytes": peak - held}


def bxs_bound_bytes(keys, masks, n, cap, cols, signs=None) -> int:
    """The bytes of a whole exchange: each source's `bx_bound_bytes` (its
    share of the receiver-major buffers is its [n, cap] of each)."""
    return sum(bx_bound_bytes(keys[s], masks[s], n, cap, cols[s],
                              None if signs is None else signs[s])
               for s in range(len(keys)))


def bxs_entry(keys, masks, n, cap, cols, fills, shape, signs=None) -> dict:
    """A whole exchange in one bucket_exchange call at one shape: the
    kernel (host and CUDA-graph device times), its plain version, the
    library composition over every source, the bound (`bxs_bound_bytes`),
    the call's CUDA launches and its temporaries beyond the buffers."""
    kw = {} if signs is None else dict(signs=signs)
    got = K.bucket_exchange_sources(keys, masks, n, cap, cols, fills, **kw)
    compare_bits("bucket_exchange", f"timing {shape}", list(got),
                 list(K.bucket_exchange_sources_plain(keys, masks, n, cap,
                                                      cols, fills, **kw)))
    compare_bits("bucket_exchange", f"library {shape}", list(got),
                 list(lib_bucket_exchange_sources(keys, masks, n, cap, cols,
                                                  fills, signs)))
    out_bytes = sum(b.numel() * b.element_size() for b in got[0])
    out = [torch.empty_like(b) for b in got[0]]
    need = int(got[2].max())
    del got
    nbytes = bxs_bound_bytes(keys, masks, n, cap, cols, signs)
    mem = temp_bytes(lambda: K.bucket_exchange_sources(
        keys, masks, n, cap, cols, fills, **kw)[0])
    mem["temp_bytes"] = mem["peak_bytes"] - out_bytes
    return dict(
        ms=median_ms(lambda: K.bucket_exchange_sources(
            keys, masks, n, cap, cols, fills, out=out, **kw)),
        device_ms=graph_ms(lambda: K.bucket_exchange_sources(
            keys, masks, n, cap, cols, fills, out=out, **kw)),
        plain_ms=median_ms(lambda: K.bucket_exchange_sources_plain(
            keys, masks, n, cap, cols, fills, **kw)),
        library_ms=median_ms(lambda: lib_bucket_exchange_sources(
            keys, masks, n, cap, cols, fills, signs)),
        bound_ms=bound_ms(nbytes), bound_by="bytes", bound_bytes=nbytes,
        cuda_launches=cuda_launches_of(lambda: K.bucket_exchange_sources(
            keys, masks, n, cap, cols, fills, out=out, **kw)),
        memory=mem, shape=shape, sources=len(keys),
        live_rows=int(sum(int((m & (signs[s] != 0)).sum()
                              if signs is not None else m.sum())
                          for s, m in enumerate(masks))),
        need=need)


def stage_sources(stage):
    """(keys, masks, signs, shipped arrays) of every source shard of one
    captured exchange stage, as `shard_exec.exchange_apply` hands them to
    the kernel."""
    node, deltas = stage
    parts = [SE._exchange_arrays(node, 0, d, (), 1) for d in deltas]
    return ([p[0] for p in parts], [p[1] for p in parts],
            [p[2] for p in parts], [p[4] for p in parts])


def captured_entry(stage, label) -> dict:
    """The whole exchange of one captured stage (`mesh_phase`'s capture:
    every source shard's last input) at the path's final `exch`, in one
    bucket_exchange call as `Mesh.exchange` makes it."""
    node = stage[0]
    keys, masks, signs, arrays = stage_sources(stage)
    dts = "+".join(str(a.dtype).replace("torch.", "") for a in arrays[0])
    return bxs_entry(keys, masks, MESH_SHARDS, node.exch, arrays,
                     [0] * len(arrays[0]),
                     f"{label}: {MESH_SHARDS} sources x B="
                     f"{keys[0].shape[0]}, n={MESH_SHARDS}, "
                     f"cap={node.exch}, {dts}", signs=signs)


def engine_sources(dev):
    """The sharded agg engine's exchange at q4e_m's shape: MESH_SHARDS
    sources of 2^17 bids (ids s x 2^17 ..), keys packed from the auction,
    signs and three seeded (int64 value, valid) pairs; cap = B."""
    n = MESH_SHARDS
    b = EPOCH_EVENTS // n
    src = bid_source(dev, Q4M_EVENTS)
    pack = F.PackPlan.plan([src.ranges[0]])
    rng = np.random.default_rng(165)
    keys, masks, arrays = [], [], []
    for s in range(n):
        ids = torch.arange(s * b, (s + 1) * b, dtype=torch.int64, device=dev)
        cols = gen_table(src.gencfg, "bid", ids)
        key = pack.pack([cols["auction"]])
        vals = [torch.from_numpy(rng.integers(0, 1 << 30, b)).to(dev)
                for _ in range(3)]
        valid = torch.ones(b, dtype=torch.bool, device=dev)
        keys.append(key)
        masks.append(table_mask("bid", ids))
        arrays.append([key, torch.ones(b, dtype=torch.int32, device=dev)]
                      + [t for v in vals for t in (v, valid)])
    return keys, masks, arrays, [EMPTY_KEY, 0] + [0, False] * 3


def bx_timings(dev, stages) -> dict:
    """bucket_exchange, one call a whole exchange, at the sharded paths'
    shapes: q4m's agg exchange (every source shard's pre-combined epoch),
    q5m's join exchange (the window-count side, row identity carried),
    and the per-operator engine's (`engine_sources`)."""
    row = captured_entry(stages["q4m"], "q4m agg")
    row["q5m_join"] = captured_entry(stages["q5m"], "q5m join")
    keys, masks, arrays, fills = engine_sources(dev)
    row["engine"] = bxs_entry(keys, masks, MESH_SHARDS, keys[0].shape[0],
                              arrays, fills,
                              f"q4e_m: {MESH_SHARDS} sources x B="
                              f"{keys[0].shape[0]}, cap = B, keys, signs, "
                              "3 x (int64, bool)")
    return row


def op_mesh_phase(name, graph, feeds, events, kernels_needed, check, smi,
                  rescale=None):
    """`op_phase` over a sharded engine: with `rescale` (k, n), the
    executor moves to n shards after barrier k (`rescale_mesh`); the
    exchanges' host wall (`_exchange` of both engines) is kept."""
    exch_s = [0.0]
    base = SA._exchange

    def timed(*a, **kw):
        t = time.perf_counter()
        out = base(*a, **kw)
        exch_s[0] += time.perf_counter() - t
        return out
    SA._exchange = SJ._exchange = timed
    node = graph[1]
    shards = [node.mesh.n]
    hooks = {}
    if rescale is not None:
        k, n_new = rescale

        def move():
            t = time.perf_counter()
            node.rescale_mesh(mesh_of(node.mesh.devices[0], n_new))
            shards.append(node.mesh.n)
            return time.perf_counter() - t
        hooks[k] = move
    try:
        rep = op_phase(name, graph, feeds, events, kernels_needed, check,
                       smi, hooks)
    finally:
        SA._exchange = SJ._exchange = base
    rep.update(shards=shards, devices=node.mesh.layout(),
               exchange_s=exch_s[0])
    log(f"[main] {name} shards {shards} on {rep['devices']}, exchange "
        f"{exch_s[0]:.3f} s")
    return rep


def lib_agg_unpack(p8, n_calls):
    """PyTorch library composition: one `!= 0` over the flag rows, one
    cast of the signs."""
    nz = p8[1:2 + n_calls] != 0
    return p8[0].to(torch.int32), nz[0], nz[1:]


TURNS_PAIRS = 200


def in_turns(a, b, pairs: int = TURNS_PAIRS) -> dict:
    """`a` and `b` in turns in one process, each call timed as
    `median_ms` times one (CUDA events around one call on an idle
    stream): `pairs` pairs, the order within a pair swapped every pair
    -> {"a": ..., "b": ...}, each the median, quartiles and
    interquartile range in ms."""
    for _ in range(3):
        a()
        b()
    torch.cuda.synchronize()
    ts = {"a": [], "b": []}
    for i in range(pairs):
        for key in ("ab" if i % 2 == 0 else "ba"):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            (a if key == "a" else b)()
            e1.record()
            torch.cuda.synchronize()
            ts[key].append(e0.elapsed_time(e1))
    out = {}
    for key, v in ts.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        out[key] = dict(median=float(med), q1=float(q1), q3=float(q3),
                        iqr=float(q3 - q1))
    return out


AU_TIMING_SHAPES = (("main", 1 << 20, 3), ("wide", 1 << 22, 6))


def agg_unpack_timings(dev) -> dict:
    """agg_unpack at q4e's flush shape (B = 2^20, three calls) and at the
    widest checked (B = 2^22, six calls): p8 read once, signs, mask and
    valid written once; `in_turns`: its call and the library's in turns
    (`in_turns`, TURNS_PAIRS pairs)."""
    rng = np.random.default_rng(338)
    out = {}
    for key, b, n in AU_TIMING_SHAPES:
        p8 = au_p8(rng, n, b, dev)
        compare("agg_unpack", f"timing {key}", list(K.agg_unpack(p8, n)),
                list(K.agg_unpack_plain(p8, n)))
        turns = in_turns(lambda: K.agg_unpack(p8, n),
                         lambda: lib_agg_unpack(p8, n))
        out[key] = dict(
            ms=median_ms(lambda: K.agg_unpack(p8, n)),
            device_ms=graph_ms(lambda: K.agg_unpack(p8, n)),
            plain_ms=median_ms(lambda: K.agg_unpack_plain(p8, n)),
            library_ms=median_ms(lambda: lib_agg_unpack(p8, n)),
            in_turns={"kernel": turns["a"], "library": turns["b"]},
            bound_ms=bound_ms(b * (2 + n) + b * (4 + 1 + n)),
            bound_by="bytes", shape=f"p8 [2+{n}, {b}]")
    row = dict(out.pop("main"))
    row["wide"] = out["wide"]
    return row


def launch_floor(dev) -> dict:
    """The floor under a device time read by `graph_ms`: a near-empty
    kernel (torch's add_ on one element) replayed the same way, 20 calls
    in a CUDA graph, replay / 20."""
    x = torch.zeros(1, device=dev)
    return dict(device_ms=graph_ms(lambda: x.add_(1.0)),
                kernel="torch add_ of one float32 element")


def kernel_turns(dev) -> dict:
    """The kernels redesigned or timed in turns, each at the smoke's
    timing shapes on seeded inputs (the first three `tk_cases`,
    agg_unpack's two timing shapes, `q5_like_merge`; ms_find of that
    merge's delta in its merged multiset and at `msf_dense`; expr_eval
    at the five `expr_timings` programs beside `launch_floor`): call,
    device (CUDA graph), plain and library times and the bounds. Made to
    be run from two trees in turns (parent, change, change, parent), with
    this script copied into the parent's tree: it calls only the
    kernels' public functions."""
    out = {"topk_packed": {}}
    for case, keys, counts in tk_cases(np.random.default_rng(1238),
                                       dev)[:3]:
        out["topk_packed"][case] = topk_entry(keys, counts, shape=case)
    out["agg_unpack"] = agg_unpack_timings(dev)
    ms, u = q5_like_merge(dev)
    out["ms_merge"] = ms_merge_entry(ms, u, shape="q5-like C=2^16, "
                                     "B=10485760")
    merged, _ = K.ms_merge(ms, *u)
    out["ms_find"] = ms_find_entry(
        merged, u[0], u[1], shape="q5-like C=2^16, Q=10485760 (the merge's "
        "delta in its merged multiset)")
    out["ms_find"]["dense"] = ms_find_entry(
        *msf_dense(dev), shape="C=2^14, Q=2^21, every query live, unsorted")
    out["expr_eval"] = expr_timings(dev)
    out["expr_eval"]["launch_floor"] = launch_floor(dev)
    out["bucket_exchange"] = exchange_turns(dev)
    return out


def exchange_stage(name, cap):
    """The stage of `mesh_phase`'s capture that the timings take: q4m's
    agg exchange, q5m's join exchange of input 0 (the window-count side,
    row identity carried)."""
    if name == "q5m":
        return [v for (_, xi), v in cap.items()
                if xi == 0 and isinstance(v[0], F.JoinNode)][0]
    return next(iter(cap.values()))


def exchange_stages(dev) -> dict:
    """q4m's and q5m's exchange stages (`exchange_stage`) as their drives
    leave them: each job driven to its end on MESH_SHARDS shards of the
    card, with no pull and no check, keeping every source shard's last
    input of each exchange and its node (at its final `exch`)."""
    mesh = mesh_of(dev)
    cfg = dict(capacity=MESH_CAPACITY, telemetry=False, tier=False)
    base = SE.exchange_delta
    stages = {}
    for name, make in (("q4m", lambda: q4_job(dev, Q4M_EVENTS, mesh=mesh,
                                              **cfg)),
                       ("q5m", lambda: q5_job(dev, Q5M_EVENTS, mesh=mesh,
                                              **cfg))):
        job, cap = make(), {}

        def kept(mesh_, node, xi, deltas, cap=cap, nodes=job.program.nodes,
                 **kw):
            cap[(nodes.index(node), xi)] = (node, deltas)
            return base(mesh_, node, xi, deltas, **kw)
        SE.exchange_delta = kept
        try:
            run_epochs(job)
        finally:
            SE.exchange_delta = base
        stages[name] = exchange_stage(name, cap)
        del job
    return stages


def exchange_turn_entry(fn, nbytes: int, shape: str) -> dict:
    """One whole exchange through its seam (`fn`): call and device (CUDA
    graph) ms, its bound, its CUDA launches and its device memory."""
    return dict(ms=median_ms(fn), device_ms=graph_ms(fn),
                bound_ms=bound_ms(nbytes), bound_by="bytes",
                bound_bytes=nbytes, cuda_launches=cuda_launches_of(fn),
                memory=temp_bytes(fn), shape=shape)


def exchange_turns(dev) -> dict:
    """The whole exchange as a tree's seams run it, at the smoke's three
    shapes on seeded inputs: q4m's agg and q5m's join exchange through
    `shard_exec.exchange_apply` (`exchange_stages`), the engine's through
    `sharded_agg._exchange` (`engine_sources`). Only those two functions
    and `_exchange_arrays` are called, so a parent's tree runs it as
    well."""
    mesh = mesh_of(dev)
    out = {}
    for name, stage in exchange_stages(dev).items():
        node, deltas = stage
        keys, masks, signs, arrays = stage_sources(stage)
        out[name] = exchange_turn_entry(
            lambda node=node, deltas=deltas: SE.exchange_apply(
                mesh, node, 0, deltas),
            bxs_bound_bytes(keys, masks, MESH_SHARDS, node.exch, arrays,
                            signs),
            f"{name}: {MESH_SHARDS} sources x B={keys[0].shape[0]}, "
            f"cap={node.exch}, {len(arrays[0])} arrays")
    keys, masks, arrays, fills = engine_sources(dev)
    b = keys[0].shape[0]
    out["engine"] = exchange_turn_entry(
        lambda: SA._exchange(mesh, keys, masks, arrays, fills),
        bxs_bound_bytes(keys, masks, MESH_SHARDS, b, arrays),
        f"q4e_m: {MESH_SHARDS} sources x B={b}, cap = B")
    return out


# ---------------------------------------------------------------------------
# the fused device pipeline: gen_bids and bid_agg_epoch
# ---------------------------------------------------------------------------

GB_ROWS = (1, 31, 1 << 18, (1 << 20) + 7, 1 << 22)
GB_SEEDS = (0, 42, (1 << 33) + 7)
GB_AUCTIONS = (300, 10_000, 1_000_000)
GB_SKEWS = (3.0, 2.0, 0.5)
GB_CHAIN = 50
# gen_bids' 32-bit integer instructions a row, as sm_90 issues them (IADD3
# takes three inputs, LOP3 any three-input logic): three hashes of 74 (the
# key schedule's xor, two key adds, 20 rounds of add / funnel-shift / xor,
# five key injections of one add a word, the words' xor), the uniform's
# shift and or, and randint's three remainders by the launch's span (a
# multiply-high, a multiply-subtract, a compare and a correction each),
# its multiply-add and its + minval. The float multiplies and the float ->
# int64 conversion issue on other pipes and are left out.
GB_OPS_PER_ROW = 3 * 74 + 2 + 3 * 4 + 2
# the card's 32-bit integer rate: the card table's 67 T/s float32 is 128
# FP32 lanes an SM at two operations a fused multiply-add; an SM has 64
# lanes for 32-bit integer add, shift and logic (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), one
# operation each: a quarter of that rate
INT32_OPS_PER_S = 67e12 / 4
# the pipeline's arms: bench.py stage_fused's shape (:48-50, :236) and
# 2^20-bid epochs over ~1.0M auctions (the fused q4's group count)
PIPE_ARMS = {"q4p": dict(epochs=50, n=262_144, n_auctions=10_000,
                         capacity=1 << 14),
             "q4p_wide": dict(epochs=16, n=1 << 20, n_auctions=1_000_000,
                              capacity=1 << 20)}
PIPE_SEED = 42
PIPE_WARMUP = 3
PIPE_KERNELS = ("gen_bids", "sort_cols", "batch_reduce", "merge",
                "compact_rows")
Q4P_CALLS = ["count_star", "sum", "max"]


def check_gen_bids(dev) -> float:
    """The kernel against its plain version, to the bit, on every
    combination of GB_ROWS, GB_SEEDS, GB_AUCTIONS and GB_SKEWS, then down
    a GB_CHAIN-epoch key chain (each epoch's key the last one's next)."""
    count = 0
    for n in GB_ROWS:
        for seed in GB_SEEDS:
            key = PD.prng_key(seed, dev)
            for na in GB_AUCTIONS:
                for skew in GB_SKEWS:
                    got = K.gen_bids(key, n, na, skew)
                    want = K.gen_bids_plain(key, n, na, skew)
                    torch.cuda.synchronize()
                    compare("gen_bids", f"n={n} seed={seed} "
                            f"n_auctions={na} skew={skew}", got, want)
                    count += 1
    kk = kp = PD.prng_key(PIPE_SEED, dev)
    for epoch in range(GB_CHAIN):
        ga, gp, kk = K.gen_bids(kk, 1 << 18, 10_000)
        wa, wp, kp = K.gen_bids_plain(kp, 1 << 18, 10_000)
        torch.cuda.synchronize()
        compare("gen_bids", f"chain epoch {epoch}", (ga, gp, kk),
                (wa, wp, kp))
    log(f"[kernels] gen_bids: {count} cases and a {GB_CHAIN}-epoch key "
        "chain equal their plain version to the bit")
    return 0.0


def gen_bids_bound(n: int) -> dict:
    """gen_bids' bound: its 16 bytes a row (and the key) written and read
    once at the memory rate, against its integer work at INT32_OPS_PER_S;
    the larger bounds it."""
    by_bytes = bound_ms(16 * n + 32)
    by_ops = n * GB_OPS_PER_ROW / INT32_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes_ms=by_bytes, operations_ms=by_ops,
                operations=n * GB_OPS_PER_ROW)


def gen_bids_entry(dev, n: int, n_auctions: int) -> dict:
    """gen_bids at one arm's shape: the call (host clock through CUDA
    events), the device time (CUDA-graph replay) and the plain version.
    No one PyTorch call computes threefry, so the library column is the
    plain version's torch ops: the same reading as `plain_ms`."""
    key = PD.prng_key(PIPE_SEED, dev)
    compare("gen_bids", f"timing n={n}", K.gen_bids(key, n, n_auctions),
            K.gen_bids_plain(key, n, n_auctions))
    plain = median_ms(lambda: K.gen_bids_plain(key, n, n_auctions))
    return dict(
        ms=median_ms(lambda: K.gen_bids(key, n, n_auctions)),
        device_ms=graph_ms(lambda: K.gen_bids(key, n, n_auctions)),
        plain_ms=plain, library_ms=plain,
        shape=f"n={n}, n_auctions={n_auctions}, skew 3.0",
        **gen_bids_bound(n))


def cuda_launches_of(fn) -> dict:
    """The CUDA runtime's launches (kernels, memsets, copies) while `fn`
    runs, from the profiler's runtime-API events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = ("cudaLaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync")
    return {e.key: e.count for e in prof.key_averages() if e.key in names}


def epoch_marks(epochs: int) -> list:
    """One CUDA event before the first epoch and one after each: recorded
    on the stream between epochs, read once after the last (no sync in
    the loop)."""
    return [torch.cuda.Event(enable_timing=True) for _ in range(epochs + 1)]


def epoch_walls(marks) -> dict:
    """Each epoch's wall on the card's timeline (ms between consecutive
    marks: the device's work, or its wait for the host's launches): the
    median, the least and the most."""
    ms = np.array([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    return {"median": float(np.median(ms)), "min": float(ms.min()),
            "max": float(ms.max())}


def numpy_q4(auction, price):
    """bench.py's `numpy_q4` (:163) as arrays: (keys, count, sum, max) of
    a sort-reduceat group-by."""
    k, (cnt, s, m) = groupby_reduce(auction, [("count", None),
                                              ("sum", price),
                                              ("max", price)])
    return k, cnt, s, m


def replayed_bids(dev, epochs, n, n_auctions):
    """The generator's columns over `epochs` epochs from PIPE_SEED, kept
    on the card and pulled in one transfer (bench.py stage_fused)."""
    key = PD.prng_key(PIPE_SEED, dev)
    auctions, prices = [], []
    for _ in range(epochs):
        a, p, key = K.gen_bids(key, n, n_auctions)
        auctions.append(a)
        prices.append(p)
    both = torch.stack([torch.cat(auctions), torch.cat(prices)]).cpu()
    return both[0].numpy(), both[1].numpy()


def check_q4p_rows(name, mv, oracle):
    keys, cols, nulls = PM.mv_rows(mv, [torch.int64] * 3)
    k, cnt, s, m = oracle
    if len(keys) != len(k) or not np.array_equal(keys, k):
        raise AssertionError(f"{name}: MV keys differ from the oracle "
                             f"({len(keys)} vs {len(k)})")
    for what, got, want in (("count(*)", cols[0], cnt), ("sum", cols[1], s),
                            ("max", cols[2], m)):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {what} differs from the oracle")
    if any(nl.any() for nl in nulls):
        raise AssertionError(f"{name}: a NULL in the MV")


def pipeline_phase(name, dev, smi, epochs, n, n_auctions, capacity) -> dict:
    """One arm of the fused device pipeline, driven twice from the same
    seed: eagerly (`bid_agg_epoch` per epoch) and as replays of one
    captured epoch (`capture_bid_epoch`). Both must end in the same agg
    state, MV state, key and max_needed, leaf by leaf; max_needed is read
    once, after the last epoch; the MV rows must equal `numpy_q4` over
    the generator's replayed columns. Launch counts are zeroed before the
    eager arm and read after the replays: the eager epochs and their
    PIPE_WARMUP warm-up epochs, the capture's warm-up epoch and the
    captured epoch (its launches recorded into the graph, then replayed on
    the device without the wrappers). An eager epoch's CUDA launches
    (kernels and memsets, hand-written or torch's) are counted by the
    profiler; a replayed epoch is one graph launch. Each epoch's wall is
    read from CUDA events between epochs, and the arms are compared by
    their median epochs."""
    spec = DeviceAggSpec.build(Q4P_CALLS, [np.int64] * 3)
    args = (spec, n, n_auctions)
    K.reset_launches()

    def fresh():
        agg, mv = PP.make_bid_pipeline(spec, capacity, dev)
        return (agg, mv, PD.prng_key(PIPE_SEED, dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    # warm-up, dropped: PIPE_WARMUP chained epochs (the allocator's blocks
    # settle), the last under the profiler to count its CUDA launches
    state = fresh()
    for _ in range(PIPE_WARMUP - 1):
        state = PP.bid_agg_epoch(*args, *state)
    cuda_launches = cuda_launches_of(lambda: PP.bid_agg_epoch(*args,
                                                              *state))
    state = fresh()
    torch.cuda.synchronize()
    host = 0.0
    marks = epoch_marks(epochs)
    t0 = time.perf_counter()
    marks[0].record()
    for e in range(epochs):
        t = time.perf_counter()
        state = PP.bid_agg_epoch(*args, *state)
        host += time.perf_counter() - t
        marks[e + 1].record()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_epochs = epoch_walls(marks)
    eager_launches = dict(K.LAUNCHES)

    t = time.perf_counter()
    g = PP.capture_bid_epoch(spec, n, n_auctions, capacity, dev, PIPE_SEED)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    replay_host = 0.0
    marks = epoch_marks(epochs)
    t0 = time.perf_counter()
    marks[0].record()
    for e in range(epochs):
        t = time.perf_counter()
        g.step()
        replay_host += time.perf_counter() - t
        marks[e + 1].record()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay_epochs = epoch_walls(marks)
    launches = dict(K.LAUNCHES)

    compare(name, "replayed vs eager",
            [g.agg.keys, g.agg.count, *g.agg.vals, g.mv.keys, g.mv.count,
             *g.mv.vals, g.rng, g.max_needed],
            [state[0].keys, state[0].count, *state[0].vals, state[1].keys,
             state[1].count, *state[1].vals, state[2], state[3]])
    needed = int(state[3])
    if needed > capacity:
        raise AssertionError(f"{name}: state overflow ({needed} slots "
                             f"needed of {capacity}): results invalid")
    missing = [k for k in PIPE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name} path never launched {missing}")
    t = time.perf_counter()
    oracle = numpy_q4(*replayed_bids(dev, epochs, n, n_auctions))
    check_q4p_rows(name, g.mv, oracle)
    per_epoch = {k: v / (epochs + PIPE_WARMUP)
                 for k, v in eager_launches.items() if v}
    gb = gen_bids_entry(dev, n, n_auctions)
    events = epochs * n
    rep = {"events": events, "epochs": epochs, "rows_per_epoch": n,
           "n_auctions": n_auctions, "capacity": capacity,
           "groups": len(oracle[0]), "max_needed": needed,
           "eager": {"drive_s": eager_s, "events_per_s": events / eager_s,
                     "host_ms_per_epoch": host / epochs * 1e3,
                     "wall_ms_per_epoch": eager_s / epochs * 1e3,
                     "epoch_ms": eager_epochs,
                     "launches_per_epoch": per_epoch,
                     "cuda_launches_per_epoch": cuda_launches},
           "replayed": {"drive_s": replay_s,
                        "events_per_s": events / replay_s,
                        "host_ms_per_epoch": replay_host / epochs * 1e3,
                        "wall_ms_per_epoch": replay_s / epochs * 1e3,
                        "epoch_ms": replay_epochs,
                        "capture_s": capture_s,
                        "launches_per_epoch": g.launches,
                        "cuda_launches_per_epoch": {"graph": 1}},
           "eager_over_replayed": (eager_epochs["median"]
                                   / replay_epochs["median"]),
           "gen_bids": gb, "equal_states": True, "oracle_equal": True,
           "oracle_check_s": time.perf_counter() - t,
           "launches": launches,
           "epochs_dispatched": epochs + PIPE_WARMUP + 2,
           "card": smi}
    log(f"[main] {name} {json.dumps(rep)}")
    return rep


# ---------------------------------------------------------------------------
# native: the C++ host kernels (risingwave_tpu_torch/native/)
# ---------------------------------------------------------------------------

NATIVE_SRC = "risingwave_tpu_torch/native/rw_native.cpp"
# each wrapper's reference (the JAX package's wrapper and its C entry)
NATIVE_REPLACES = {
    "vnodes_i64": "risingwave_tpu/native/__init__.py:87 "
                  "(native/rw_native.cpp:77)",
    "crc32_rows": "risingwave_tpu/native/__init__.py:76 "
                  "(native/rw_native.cpp:58)",
    "memcmp_i64": "risingwave_tpu/native/__init__.py:97 "
                  "(native/rw_native.cpp:106)"}
# (wrapper, rows, what the shape is): q4e's chunk (OP_CHUNK rows a state
# table write or a dispatch) and q4e_m's rescale (at most Q4EM_EVENTS
# keys moved)
NATIVE_SHAPES = (("vnodes_i64", OP_CHUNK, "q4e's chunk"),
                 ("vnodes_i64", Q4EM_EVENTS, "q4e_m's rescale"),
                 ("crc32_rows", OP_CHUNK, "int64 keys' 8 big-endian bytes"),
                 ("memcmp_i64", OP_CHUNK, "int64 keys"))
NATIVE_RUNS = 15
# the per-operator paths whose host work reaches the wrappers, and the
# unit of each one's calls: a barrier, or an event tick from SQL
NATIVE_PATHS = {"q4e": "flushes", "q3e": "flushes", "q5e": "flushes",
                "q4sql": "event_ticks", "q5sql": "event_ticks",
                "qlj_proc": "event_ticks", "q4e_m": "flushes"}
# q3e's state tables and MV are keyed by several columns (the planner's
# layout: every join side's whole row), which neither package's
# `compute_vnodes` sends to the host kernel: its count is reported, and
# may be 0
NATIVE_MULTI_KEY = ("q3e",)


def reset_counts() -> None:
    """Zero the kernel launches and the host kernels' calls."""
    K.reset_launches()
    N.reset_calls()


def host_median_ms(fn, runs: int = NATIVE_RUNS) -> float:
    """Median host wall of `runs` calls, after one."""
    fn()
    ts = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names its first core (a virtual
    machine may report its model name as "unknown": vendor, family and
    model are kept beside it) and this process's usable cores."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, val = line.partition(":")
            info[key.strip()] = val.strip()
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} "
            f"family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}), "
            f"{len(os.sched_getaffinity(0))} cores")


def native_keys(rng, n):
    """n seeded int64 keys over the whole range, the sign edges first."""
    k = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                     dtype=np.int64, endpoint=True)
    edges = [np.iinfo(np.int64).min, -1, 0, np.iinfo(np.int64).max]
    k[:min(n, 4)] = edges[:min(n, 4)]
    return k


def native_phase(smi) -> dict:
    """Each host kernel against its plain version, to the bit, at the
    main paths' host shapes, and the medians of NATIVE_RUNS calls of
    each; the wrappers' calls here are not the paths' (they are zeroed
    before each path's drive)."""
    rng = np.random.default_rng(27)
    plain = {"vnodes_i64": vnodes_i64_plain,
             "crc32_rows": crc32_bytes_matrix,
             "memcmp_i64": N.memcmp_i64_plain}
    wrap = {"vnodes_i64": lambda k: N.vnodes_i64(k, VNODE_COUNT),
            "crc32_rows": N.crc32_rows, "memcmp_i64": N.memcmp_i64}
    rows = []
    for name, n, what in NATIVE_SHAPES:
        keys = native_keys(rng, n)
        arg = _int_key_bytes(keys) if name == "crc32_rows" else keys
        got = wrap[name](arg)
        want = plain[name](arg)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"native {name} at {n} rows differs from "
                                 f"its plain version")
        rows.append({"name": name, "route": "c++ (g++, host)",
                     "source": NATIVE_SRC,
                     "replaces": NATIVE_REPLACES[name],
                     "shape": f"{n} rows ({what})", "max_abs_err": 0,
                     "cpp_ms": host_median_ms(
                         lambda f=wrap[name], a=arg: f(a)),
                     "plain_ms": host_median_ms(
                         lambda f=plain[name], a=arg: f(a))})
        log(f"[native] {rows[-1]}")
    return {"library": os.path.relpath(N.library_path()), "rows": rows,
            "host_cpu": host_cpu(), "card": smi}


def native_paths(reports) -> dict:
    """Each per-operator path's host-kernel calls, in all and per unit
    of NATIVE_PATHS; fails if a path whose keys include one integral
    column made no `vnodes_i64` call."""
    out = {}
    for path, unit in NATIVE_PATHS.items():
        calls = reports[path]["native_calls"]
        units = reports[path][unit]
        out[path] = {"calls": calls, "unit": unit, "units": units,
                     "per_unit": {k: v / units for k, v in calls.items()}}
    log(f"[native] calls on the per-operator paths: {json.dumps(out)}")
    silent = [p for p in NATIVE_PATHS if p not in NATIVE_MULTI_KEY
              and out[p]["calls"]["vnodes_i64"] == 0]
    if silent:
        raise AssertionError(f"paths {silent} made no native vnodes_i64 "
                             f"call")
    return out


# ---------------------------------------------------------------------------


HOST_PATHS = "--host-paths"
# the seconds the main process waits for the second one, from its start
HOST_PATHS_WAIT = 1100


def host_paths(dev, smi) -> dict:
    """Phases 4h .. 4h''', 4j and 4k: the host-bound paths (per-row Python
    in the executors and their host twins, worker processes, the mesh
    policy's rebuild-replays and MV mirror, shards on the CPU), which read
    nothing of the other phases. qlj_proc comes first: nvidia-smi must list only the two
    processes of the smoke while its workers live, and the main process
    starts its own subprocesses with a CUDA context (risectl) only in the
    wire phase, minutes later. Returns each phase's report."""
    out = {"qlj_proc": placement_phase(dev, smi)}
    feeds, _, _ = q4e_feeds(dev, retract=False)
    out["q4e"] = op_phase("q4e", q4e_graph(dev, True), feeds, Q4E_EVENTS,
                          Q4E_KERNELS, lambda rows: check_q4e_rows(
                              "q4e", rows, q4_oracle(dev, Q4E_EVENTS)), smi)
    feeds, auc, price = q4e_feeds(dev, retract=True)
    out["q4e_r"] = op_phase("q4e_r", q4e_graph(dev, False), feeds,
                            Q4E_EVENTS, Q4ER_KERNELS,
                            lambda rows: check_q4e_rows(
                                "q4e_r", rows, q4e_oracle(auc, price)), smi)
    del feeds, auc, price
    out["q3e"] = op_phase("q3e", q3e_graph(dev), q3e_feeds(dev), Q3E_EVENTS,
                          Q3E_KERNELS, lambda rows: check_q3e_rows(
                              rows, q3a_oracle(dev, Q3E_EVENTS)), smi)
    q5e_kept = {}
    out["q5e"] = q5e_phase(dev, smi, kept=q5e_kept)
    out["q4sql"] = q4sql_phase(dev, smi)
    out["q5sql"] = q5sql_phase(dev, smi, q5e_kept.pop("rows"))
    out["mesh_policy"] = mesh_policy_phase(dev, smi)
    out["mesh_devices"] = mesh_devices_phase(dev, smi)
    return out


def start_host_paths(report):
    """This script again, `--host-paths report`, in a session of its own
    (its qlj workers with it), on the same card; the kernels are built."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), HOST_PATHS, report],
        cwd=here, stdout=subprocess.DEVNULL, start_new_session=True)


def wait_host_paths(child, report) -> dict:
    """The second process's reports; fails if it failed or is still
    running HOST_PATHS_WAIT seconds after the script started."""
    left = HOST_PATHS_WAIT - (time.perf_counter() - T_START)
    try:
        rc = child.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"host paths still running after "
                             f"{HOST_PATHS_WAIT} s")
    if rc != 0:
        raise AssertionError(f"host paths exited {rc}")
    with open(report) as f:
        return json.load(f)


def stop_host_paths(child) -> None:
    """Ends the second process's session: it, and any worker it left."""
    try:
        os.killpg(child.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    child.wait()


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.perf_counter()
    K.binding.build()
    log(f"[build] kernels built in {time.perf_counter() - t:.1f} s")
    built = not os.path.exists(N.library_path())
    t = time.perf_counter()
    N.get_lib()
    native_build = {"s": time.perf_counter() - t, "built": built}
    log(f"[build] host kernels {'built with g++ and ' if built else ''}"
        f"loaded in {native_build['s']:.1f} s "
        f"({os.path.relpath(N.library_path())})")
    if sys.argv[1:] == ["--merge-side-memory"]:
        print(smi)
        print(json.dumps({"merge_side_memory": merge_side_memory(dev)}))
        return 0
    if sys.argv[1:] == ["--kernel-turns"]:
        print(smi)
        print(json.dumps({"kernel_turns": kernel_turns(dev)}))
        return 0
    if sys.argv[1:] == ["--wire"]:
        print(smi)
        print(json.dumps({"wire": wire_only(dev, smi)}))
        return 0
    if sys.argv[1:2] == ["--placement"]:
        # an optional second argument: the drive's events as a power of 2
        events = 1 << int(sys.argv[2]) if len(sys.argv) > 2 else QLJ_EVENTS
        rep = placement_phase(dev, smi, events)
        print(smi)
        print(json.dumps({"placement": rep}))
        return 0
    if sys.argv[1:] == ["--mesh-policy"]:
        rep = mesh_policy_phase(dev, smi)
        print(smi)
        print(json.dumps({"mesh_policy": rep}))
        return 0
    if sys.argv[1:] == ["--mesh-devices"]:
        rep = mesh_devices_phase(dev, smi)
        print(smi)
        print(json.dumps({"mesh_devices": rep}))
        return 0
    if sys.argv[1:] == ["--recovery"]:
        oracle = q5_oracle(dev)
        rec = recovery_phases(dev, smi,
                              lambda r: check_q5_rows(r, oracle))
        print(smi)
        print(json.dumps({"recovery": rec}))
        return 0

    if sys.argv[1:2] == [HOST_PATHS]:
        # the second process of the whole smoke (see start_host_paths)
        global LOG_TAG, SMOKE_PROCS
        LOG_TAG, SMOKE_PROCS = "[host-paths] ", 2
        rep = host_paths(dev, smi)
        with open(sys.argv[2], "w") as f:
            json.dump(rep, f)
        return 0
    if sys.argv[1:]:
        log(f"chip_smoke: unknown arguments {sys.argv[1:]}")
        return 2

    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    report = os.path.join(directory, "host_paths.json")
    child = start_host_paths(report)
    try:
        return smoke(dev, smi, card, lambda: wait_host_paths(child, report),
                     native_build)
    finally:
        stop_host_paths(child)
        shutil.rmtree(directory, ignore_errors=True)


def smoke(dev, smi, card, host, native_build) -> int:
    """The whole smoke on `dev` but phases 4h .. 4h''', 4j and 4k, whose
    reports `host()` waits for; prints the last four lines.
    `native_build`: the host kernels' build (or load of a library built
    before) in `main`, seconds and whether it built."""
    native = native_phase(smi)
    native["build"] = native_build
    t = time.perf_counter()
    err = check_kernels(dev)
    log(f"[kernels] all {len(REPLACES)} kernels equal their plain versions "
        f"({time.perf_counter() - t:.1f} s); max abs err {err}")

    # ---- q4: the agg path --------------------------------------------
    job, rows, drive_s, pull_s, launches, epochs = run_main(dev)
    oracle = q4_oracle(dev)
    check_rows(rows, oracle)
    # what the SQL-built paths are held to: each hand-built path's rows,
    # launches, epochs and node list, and its oracle check
    hand, sql_check = {}, {}
    hand["q4"] = (rows, launches, epochs, node_list(job))
    sql_check["q4_sql"] = lambda r, o=oracle: check_rows(r, o)
    q4 = {"events": MAX_EVENTS, "drive_s": drive_s, "pull_s": pull_s,
          "events_per_s": MAX_EVENTS / drive_s,
          "growth_replays": job.growth_replays, "groups": len(rows),
          "agg_capacity": job.program.nodes[2].capacity,
          "mv_capacity": job.program.nodes[3].capacity,
          "launches": launches, "epochs_dispatched": epochs, "card": smi}
    log(f"[main] q4 {json.dumps(q4)}")
    if job.growth_replays < 1:
        raise AssertionError("q4 main path made no growth replay")
    missing = [k for k in Q4_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"q4 path never launched {missing}")
    if launches["expr_eval"]:
        raise AssertionError("q4's Map is column references only, yet it "
                             "launched expr_eval")
    # the raw (not pre-combined) agg arm, smaller, outside the counted run
    raw_job, raw_rows, *_ = run_main(dev, 1 << 22, precombine=False)
    check_rows(raw_rows, q4_oracle(dev, 1 << 22))
    log(f"[main] raw agg arm: 2^22 events, {len(raw_rows)} groups, "
        f"{raw_job.growth_replays} growth replays, oracle equal")
    q4["node_ms"], _ = node_times(job)
    log(f"[main] q4 one steady epoch by node (ms): {q4['node_ms']}")
    q4["tres_check"] = check_tres("q4", job)
    q4["telemetry_cost"] = telemetry_cost(job)
    q4["tier_cost"] = tier_cost(job)
    q4["drive_cost"] = drive_cost(lambda on: q4_job(dev, telemetry=on))
    q4["tier_drive_cost"] = drive_cost(lambda on: q4_job(dev, tier=on), 2)
    tele = [telemetry_line("q4", job), telemetry_line("q4_raw_agg", raw_job)]
    tm = timings(dev, job.program.nodes[2].capacity)
    del job, rows, oracle, raw_job, raw_rows

    # ---- q4p / q4p_wide: the fused device pipeline, eager and replayed -
    pipe = {name: pipeline_phase(name, dev, smi, **arm)
            for name, arm in PIPE_ARMS.items()}
    tm["gen_bids"] = dict(pipe["q4p"]["gen_bids"])
    tm["gen_bids"]["wide"] = pipe["q4p_wide"]["gen_bids"]

    # ---- q1c / q2c: q1's currency conversion, q2's selection -----------
    job = q1c_job(dev)
    q1c = path_phase("q1c", job, MAX_EVENTS, Q1C_KERNELS,
                     lambda rows: check_keyed_rows("q1c", rows,
                                                   q1c_oracle(dev)), smi)
    q1c["node_ms"], _ = node_times(job)
    log(f"[main] q1c one steady epoch by node (ms): {q1c['node_ms']}")
    q1c["tres_check"] = check_tres("q1c", job)
    tele.append(telemetry_line("q1c", job))
    job = q2c_job(dev)
    q2c = path_phase("q2c", job, MAX_EVENTS, Q2C_KERNELS,
                     lambda rows: check_keyed_rows("q2c", rows,
                                                   q2c_oracle(dev)), smi)
    q2c["node_ms"], _ = node_times(job)
    log(f"[main] q2c one steady epoch by node (ms): {q2c['node_ms']}")
    q2c["tres_check"] = check_tres("q2c", job)
    tele.append(telemetry_line("q2c", job))
    del job
    tm["expr_eval"] = expr_timings(dev)
    tm["expr_eval"]["launch_floor"] = launch_floor(dev)

    # ---- q3a: the join path ------------------------------------------
    qjob = q3a_job(dev)
    qrows, qdrive_s, qpull_s, qlaunches, qepochs = drive(qjob)
    t = time.perf_counter()
    q3_oracle = q3a_oracle(dev)
    check_q3a_rows(qrows, q3_oracle)
    jn = qjob.program.nodes[2]
    q3a = {"events": Q3_EVENTS, "drive_s": qdrive_s, "pull_s": qpull_s,
           "events_per_s": Q3_EVENTS / qdrive_s,
           "growth_replays": qjob.growth_replays, "rows": len(qrows),
           "bid_capacity": jn.cap_a, "auction_capacity": jn.cap_b,
           "pair_capacity": jn.m, "mv_capacity": qjob.program.nodes[4]
           .capacity, "launches": qlaunches, "epochs_dispatched": qepochs,
           "oracle_check_s": time.perf_counter() - t, "card": smi}
    log(f"[main] q3a {json.dumps(q3a)}")
    if qjob.growth_replays < 1:
        raise AssertionError("q3a main path made no growth replay")
    missing = [k for k in Q3A_KERNELS if qlaunches[k] == 0]
    if missing:
        raise AssertionError(f"q3a path never launched {missing}")
    del qrows, q3_oracle
    # q3a_sql is held to a device q3a run at its depth
    s_job = q3a_job(dev, Q3S_EVENTS)
    s_rows, _, _, s_launches, s_epochs = drive(s_job)
    hand["q3a"] = (s_rows, s_launches, s_epochs, node_list(s_job))
    sql_check["q3a_sql"] = lambda r, o=q3a_oracle(dev, Q3S_EVENTS): \
        check_q3a_visible(r, o)
    del s_job, s_rows, s_launches, s_epochs
    q3a["node_ms"], _ = node_times(qjob)
    log(f"[main] q3a one steady epoch by node (ms): {q3a['node_ms']}")
    q3a["tres_check"] = check_tres("q3a", qjob)
    q3a["telemetry_cost"] = telemetry_cost(qjob)
    q3a["tier_cost"] = tier_cost(qjob)
    q3a["drive_cost"] = drive_cost(lambda on: q3a_job(dev, telemetry=on))
    q3a["tier_drive_cost"] = drive_cost(lambda on: q3a_job(dev, tier=on), 2)
    tele.append(telemetry_line("q3a", qjob))
    jt = join_timings(dev, qjob)
    tm["sort_cols"]["q3a_jk_pk"] = jt.pop("sort_cols")
    tm.update(jt)

    # ---- q5: hop windows, retractable max, non-equi join ---------------
    job = q5_job(dev)
    q5_kept = {}

    def check_q5(rows):
        # the rows and the oracle stay for q5obs, which must equal both
        q5_kept["oracle"] = q5_oracle(dev)
        check_q5_rows(rows, q5_kept["oracle"])
        q5_kept["rows"] = rows
    q5 = path_phase("q5", job, Q5_EVENTS, Q5_KERNELS, check_q5, smi)
    hand["q5"] = (q5_kept["rows"], q5["launches"], q5["epochs_dispatched"],
                  node_list(job))
    sql_check["q5_sql"] = lambda r, o=q5_kept["oracle"]: check_q5_rows(r, o)
    hi = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.HopNode)][0]
    ai = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.AggNode) and n.spec.minputs][0]
    q5["node_ms"], kept = node_times(job, keep=(hi, ai))
    log(f"[main] q5 one steady epoch by node (ms): {q5['node_ms']}")
    q5["tres_check"] = check_tres("q5", job)
    q5["telemetry_cost"] = telemetry_cost(job)
    q5["tier_cost"] = tier_cost(job)
    q5["drive_cost"] = drive_cost(lambda on: q5_job(dev, telemetry=on))
    q5["tier_drive_cost"] = drive_cost(lambda on: q5_job(dev, tier=on), 2)
    tele.append(telemetry_line("q5", job))
    tm.update(window_multiset_timings(job, kept, hi, ai))
    tm["batch_reduce"]["q5_max_agg"] = batch_reduce_few_keys(
        job.program.nodes[ai], kept[ai][0])
    # the raw max agg's epoch_topk: its change stream, masked, sorted
    an, d = job.program.nodes[ai], kept[ai][0]
    mk = torch.where(d.mask & (d.sign != 0),
                     an.pack.pack([d.cols[i] for i in an.group_idx]),
                     EMPTY_KEY)
    (sk,), _ = K.sort_cols([mk], [])
    q5_topk = topk_entry(sk, shape=f"runs B={sk.shape[0]}",
                         live_rows=int((mk != EMPTY_KEY).sum()),
                         sort_ms=median_ms(lambda: K.sort_cols([mk], [])))
    del job, kept, mk, sk

    # ---- q5obs: q5 as a user's job runs it, profiled and observed ------
    q5obs = q5obs_phase(dev, smi, q5_kept["rows"], q5_kept["oracle"])

    # ---- q7: tumble window, max, join back, timestamp filter -----------
    job = q7_job(dev)
    q7_kept = {}

    def check_q7(rows):
        q7_kept["oracle"] = q7_oracle(dev)
        check_q7_rows(rows, q7_kept["oracle"])
        q7_kept["rows"] = rows
    q7 = path_phase("q7", job, Q7_EVENTS, Q7_KERNELS, check_q7, smi)
    hand["q7"] = (q7_kept["rows"], q7["launches"], q7["epochs_dispatched"],
                  node_list(job))
    sql_check["q7_sql"] = lambda r, o=q7_kept.pop("oracle"): \
        check_q7_rows(r, o)
    del q5_kept
    pi = [i for i, n in enumerate(job.program.nodes)
          if isinstance(n, F.PrecombineNode)][0]
    q7["node_ms"], kept = node_times(job, keep=(pi,))
    log(f"[main] q7 one steady epoch by node (ms): {q7['node_ms']}")
    q7["tres_check"] = check_tres("q7", job)
    q7["telemetry_cost"] = telemetry_cost(job)
    q7["tier_cost"] = tier_cost(job)
    q7["drive_cost"] = drive_cost(lambda on: q7_job(dev, telemetry=on))
    q7["tier_drive_cost"] = drive_cost(lambda on: q7_job(dev, tier=on), 2)
    tele.append(telemetry_line("q7", job))
    tm["batch_reduce"]["q7_precombine"] = batch_reduce_few_keys(
        job.program.nodes[pi], kept[pi][0])
    del job, kept

    # ---- q8: two tumble distincts joined, under the default telemetry --
    job = q8_job(dev)
    streams = q8_streams(dev)
    oracle = numpy_q8(*streams[0], *streams[1])
    pool = job.pull.decoders[1][1]
    last = {}
    q8_rows = []
    q8 = path_phase("q8", job, Q8_EVENTS, Q8_KERNELS,
                    lambda rows: (q8_rows.append(rows),
                                  check_q8_rows(rows, oracle, pool)), smi,
                    last)
    hand["q8"] = (q8_rows.pop(), q8["launches"], q8["epochs_dispatched"],
                  node_list(job))
    sql_check["q8_sql"] = lambda r, o=oracle, p=pool: check_q8_rows(r, o, p)
    q8["telemetry_check"] = check_q8_telemetry(job, streams)
    log(f"[main] q8 telemetry equals its live groups and routed rows: "
        f"{q8['telemetry_check']}")
    ai, ji = [[i for i, n in enumerate(job.program.nodes)
               if isinstance(n, cls)][0] for cls in (F.AggNode, F.JoinNode)]
    # the last epoch again, from the states before it: the distincts see
    # new groups (an epoch over the final state would change nothing)
    at = last.pop("at")
    q8["node_ms"], kept = node_times(job, keep=(ai, ji), at=at)
    log(f"[main] q8 last epoch by node (ms): {q8['node_ms']}")
    q8["tres_check"] = check_tres("q8", job)
    q8["telemetry_cost"] = telemetry_cost(job, at=at)
    q8["tier_cost"] = tier_cost(job, at=at)
    q8["drive_cost"] = drive_cost(lambda on: q8_job(dev, telemetry=on))
    q8["tier_drive_cost"] = drive_cost(lambda on: q8_job(dev, tier=on), 2)
    tele.append(telemetry_line("q8", job))
    tm.update(skew_timings(job, kept, ai, ji))
    tm["topk_packed"]["q5_max_agg"] = q5_topk
    del job, kept, streams, oracle, at

    # ---- q4_sql .. q8_sql: the same five paths from SQL, fused ---------
    sqlf = {}
    q5_check, q7_check = sql_check["q5_sql"], sql_check["q7_sql"]
    q5_sql_kept = {}
    for name, (_mv, _s, _q, _n, hp, _k) in SQL_FUSED.items():
        sqlf[name] = fused_sql_phase(
            name, dev, smi, hand.pop(hp), sql_check.pop(name),
            q5_sql_kept if name == "q5_sql" else None)
    del hand, sql_check

    # ---- q5_sql_restart, q5_sql_inplace, qa_sql_tiered_restart ---------
    rec = recovery_phases(dev, smi, q5_check)

    # ---- wire: q5 and q7 over the port's PgServer, risectl, .slt -------
    wire = wire_phase(dev, smi, sqlf["q5_sql"], q5_sql_kept.pop("rows"),
                      q5_check, q7_check, sqlf["q7_sql"])
    del q7_check

    # ---- the host-fed tiered paths -------------------------------------
    # the device q3a path's rows and the oracle at the tiered depth
    t_rows = drive(q3a_job(dev, Q3T_EVENTS))[0]
    t_oracle = q3a_oracle(dev, Q3T_EVENTS)
    tjob = q3a_job(dev, Q3T_EVENTS, epoch_events=TIER_EPOCH_EVENTS,
                   host_fed=True, presize=Q3T_PRESIZE)
    tjob.hbm_budget_mb = clamp_budget_mb(tjob, "2:JoinNode.a", Q3T_CLAMP)

    def check_q3t(rows):
        check_q3a_rows(rows, t_oracle)
        if rows != t_rows:
            raise AssertionError("q3a_tiered rows differ from the device "
                                 "q3a path's")
    q3t = tiered_phase("q3a_tiered", tjob, Q3T_EVENTS, Q3T_KERNELS,
                       check_q3t, smi)
    del t_rows, t_oracle
    tm.update(tier_timings(dev, qjob, tjob))
    del qjob, tjob
    ajob = qa_job(dev, epoch_events=TIER_EPOCH_EVENTS, capacity=QA_CLAMP)
    ajob.hbm_budget_mb = clamp_budget_mb(ajob, "2:AggNode.main", QA_CLAMP)
    qa_or = qa_oracle()
    qat = tiered_phase("qa_tiered", ajob, QA_EVENTS, QA_KERNELS,
                       lambda rows: check_qa_rows(rows, qa_or), smi)
    if ajob.tiering.counters["promotions"] <= 0:
        raise AssertionError("qa_tiered: no promotion")
    # the heavy hitters of the agg's telemetry sit in no cold store
    hot = set(hot_key_set(ajob.program.node_stats(
        2, np.maximum(ajob._stat_totals, ajob._last_stats))))
    cold = {int(k) & SK_KEY_MASK for st in ajob.tiering.stores.values()
            for d in st.rows for k in d}
    if not hot or hot & cold:
        raise AssertionError(f"qa_tiered: heavy hitters {sorted(hot)} vs "
                             f"{len(hot & cold)} demoted")
    qat["hot_keys"] = sorted(hot)
    tele.append(telemetry_line("qa_tiered", ajob))
    del ajob, qa_or

    # ---- the device generator under zipf:1.5 (_zipf_ordinal on CUDA) ---
    # its rows against the host generator's group-by, as qa_tiered's
    zjob = qa_job(dev, QZ_EVENTS, capacity=QZ_CAPACITY, host_fed=False)
    qz_or = qa_oracle(QZ_EVENTS)
    qaz = path_phase("qa_zipf_device", zjob, QZ_EVENTS, QZ_KERNELS,
                     lambda rows: check_qa_rows(rows, qz_or), smi)
    del zjob, qz_or

    tm["agg_unpack"] = agg_unpack_timings(dev)

    # ---- the sharded paths: MESH_SHARDS shards on the one card ---------
    mesh = mesh_of(dev)
    log(f"[mesh] {mesh}")
    # each fused path's 1-shard run (its rows in order) comes first, then
    # the sharded run, whose launches alone are counted
    cfg = dict(capacity=MESH_CAPACITY, telemetry=False, tier=False)
    stages, cap = {}, {}
    one = single_run(q4_job(dev, Q4M_EVENTS, **cfg))
    q4m = mesh_phase("q4m", q4_job(dev, Q4M_EVENTS, mesh=mesh, **cfg),
                     Q4M_EVENTS, Q4M_KERNELS, lambda rows: check_rows(
                         rows, q4_oracle(dev, Q4M_EVENTS)), smi, one, cap)
    stages["q4m"] = exchange_stage("q4m", cap)
    cap = {}
    one = single_run(q5_job(dev, Q5M_EVENTS, **cfg))
    # q5m runs at q5's depth, so q5's oracle holds it
    assert Q5M_EVENTS == Q5_EVENTS
    q5m = mesh_phase("q5m", q5_job(dev, Q5M_EVENTS, mesh=mesh, **cfg),
                     Q5M_EVENTS, Q5M_KERNELS, q5_check, smi, one, cap)
    stages["q5m"] = exchange_stage("q5m", cap)
    one = single_run(q3a_job(dev, Q3AM_EVENTS, **cfg))
    q3am = mesh_phase("q3am", q3a_job(dev, Q3AM_EVENTS, mesh=mesh, **cfg),
                      Q3AM_EVENTS, Q3AM_KERNELS, lambda rows: check_q3a_rows(
                          rows, q3a_oracle(dev, Q3AM_EVENTS)), smi, one)
    del one, cap, q5_check
    feeds, _, _ = q4e_feeds(dev, retract=False)
    q4em = op_mesh_phase(
        "q4e_m", q4e_graph(dev, True, mesh, OPM_CAPACITY), feeds,
        Q4EM_EVENTS, Q4EM_KERNELS, lambda rows: check_q4e_rows(
            "q4e_m", rows, q4_oracle(dev, Q4EM_EVENTS)), smi,
        rescale=Q4EM_RESCALE)
    del feeds
    q3em = op_mesh_phase(
        "q3e_m", q3e_graph(dev, mesh, OPM_CAPACITY),
        q3e_feeds(dev, Q3EM_EVENTS), Q3EM_EVENTS, Q3EM_KERNELS,
        lambda rows: check_q3e_rows(rows, q3a_oracle(dev, Q3EM_EVENTS)),
        smi)
    tm["bucket_exchange"] = bx_timings(dev, stages)
    del stages

    # ---- 4h .. 4h''', 4j and 4k, from the second process -------------
    hp = host()
    q4e, q4er, q3e, q5e = hp["q4e"], hp["q4e_r"], hp["q3e"], hp["q5e"]
    q4sql, q5sql, qlj = hp["q4sql"], hp["q5sql"], hp["qlj_proc"]
    mpol, mdev = hp["mesh_policy"], hp["mesh_devices"]
    tm["bucket_exchange"]["per_source"] = \
        mdev.pop("bucket_exchange_per_source")
    native["paths"] = native_paths({**hp, "q4e_m": q4em})

    paths = {"q4": (launches, epochs), "q3a": (qlaunches, qepochs),
             "q1c": (q1c["launches"], q1c["epochs_dispatched"]),
             "q2c": (q2c["launches"], q2c["epochs_dispatched"]),
             "q5": (q5["launches"], q5["epochs_dispatched"]),
             "q5obs": (q5obs["launches"], q5obs["epochs_dispatched"]),
             "q7": (q7["launches"], q7["epochs_dispatched"]),
             "q8": (q8["launches"], q8["epochs_dispatched"]),
             "q3a_tiered": (q3t["launches"], q3t["epochs_dispatched"]),
             "qa_tiered": (qat["launches"], qat["epochs_dispatched"]),
             "qa_zipf_device": (qaz["launches"], qaz["epochs_dispatched"]),
             "q4e": (q4e["launches"], q4e["flushes"]),
             "q4e_r": (q4er["launches"], q4er["flushes"]),
             "q3e": (q3e["launches"], q3e["flushes"]),
             "q5e": (q5e["launches"], q5e["flushes"]),
             "q4sql": (q4sql["launches"], q4sql["event_ticks"]),
             **{name: (r["launches"], r["epochs_dispatched"])
                for name, r in sqlf.items()},
             "q5sql": (q5sql["launches"], q5sql["event_ticks"]),
             "qlj_proc": (qlj["launches"], qlj["event_ticks"]),
             "q5_wire": (wire["nexmark_q5"]["launches"],
                         wire["nexmark_q5"]["epochs_dispatched"]),
             "q7_wire": (wire["nexmark_q7"]["launches"],
                         wire["nexmark_q7"]["epochs_dispatched"]),
             "q5_sql_restart": (rec["q5_sql_restart"]["launches"],
                                rec["q5_sql_restart"]["replayed_epochs"]),
             "qa_sql_tiered_restart": (
                 rec["qa_sql_tiered_restart"]["replay_launches"],
                 rec["qa_sql_tiered_restart"]["replayed_epochs"]),
             "q4m": (q4m["launches"], q4m["epochs_dispatched"]),
             "q5m": (q5m["launches"], q5m["epochs_dispatched"]),
             "q3am": (q3am["launches"], q3am["epochs_dispatched"]),
             "q4e_m": (q4em["launches"], q4em["flushes"]),
             "q3e_m": (q3em["launches"], q3em["flushes"]),
             **{name: (mpol[name]["launches"],
                       mpol[name]["epochs_stepped"])
                for name, _fn in MP_JOBS},
             **{f"md_{name}": (mdev[name]["launches"],
                               mdev[name]["epochs_stepped"])
                for name, _fn in MD_JOBS},
             "q4p": (pipe["q4p"]["launches"],
                     pipe["q4p"]["epochs_dispatched"]),
             "q4p_wide": (pipe["q4p_wide"]["launches"],
                          pipe["q4p_wide"]["epochs_dispatched"])}
    kernels = []
    for name in REPLACES:
        row = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": REPLACES[name],
               "launches": sum(lc[name] for lc, _ in paths.values()),
               "launches_per_epoch": {p: lc[name] / ep
                                      for p, (lc, ep) in paths.items()},
               "max_abs_err": err[name], "max_abs_diff": err[name]}
        row.update(tm[name])
        kernels.append(row)
        log(f"[timing] {name}: {tm[name]}")
    for line in tele:
        log(f"[telemetry] {json.dumps(line)}")
        print(json.dumps(line))
    print(smi)
    print(json.dumps({"main": {"q4": q4, "q1c": q1c, "q2c": q2c,
                               "q3a": q3a, "q5": q5, "q5obs": q5obs,
                               "q7": q7,
                               "q8": q8, "q3a_tiered": q3t,
                               "qa_tiered": qat, "qa_zipf_device": qaz,
                               "q4e": q4e, "q4e_r": q4er, "q3e": q3e,
                               "q5e": q5e, "q4sql": q4sql,
                               "q5sql": q5sql, "qlj_proc": qlj,
                               **sqlf, **rec,
                               "wire": wire,
                               "q4m": q4m, "q5m": q5m, "q3am": q3am,
                               "q4e_m": q4em, "q3e_m": q3em,
                               "mesh_policy": mpol,
                               "mesh_devices": mdev,
                               "q4p": pipe["q4p"],
                               "q4p_wide": pipe["q4p_wide"],
                               "native": native}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
