#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pilosa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero
                                     # without one, printing no result

Phases, in order; any failure exits non-zero (nothing is caught):

1. Device and build: the card's name and power limit (nvidia-smi), then
   the kernels built from pilosa_tpu_torch/csrc with nvcc, and what
   ptxas -v reported per kernel (lines "ptxas: <kernel><template args>:
   registers, stack frame, spills"), with whether program_count's
   instantiations up to depth 4 keep their operand stack in registers.
2. Server, Count path: the port's Server on a temp data dir; an index
   with existence tracking and a set field of 8 rows over 1024 shards
   (8.5k-40k bits per shard and row) loaded through API.import_bits plus
   one JSON import; PQL over HTTP, including Counts over 40 Rows (40
   leaves), checked against a numpy oracle built from the generated
   columns; then 32 concurrent clients x 8 Count(Intersect) queries.
   Launch counts are zeroed before the server starts and read after the
   last query: every kernel of the path must have launched. With
   --profile, a further concurrent pass runs under torch.profiler and the
   device's idle share over it is printed.
2q. Multi-tenant QoS, on the Count path's server after its passes (the
   plane put into enforce mode for this phase alone and back to off, so
   no other pass runs with it): (1) 8 interactive clients of tenant-a
   (X-API-Key: tenant-a, X-Pilosa-Priority: interactive, no quota) alone
   for 3 s, then with 24 batch clients of tenant-b (X-API-Key: tenant-b,
   X-Pilosa-Priority: batch, a queries-per-s quota of a fifth of the
   Count pass's q/s, printed) for 8 s under a device-profile capture,
   both sending phase 2's Count(Intersect) mix: every 200 equals the
   oracle, every 429 carries the JAX body and a Retry-After of 1-30 s
   (which the client honours), nothing else; each tenant's admitted and
   throttled counts, q/s, p50 and p99, tenant-a's p50 in the mix over its
   p50 alone, and the CountBatcher's cuts reordered by priority (a cut
   sorts only past one batch); (2) /debug/usage lists both tenants with
   queries, deviceMs and hbmBytes, and the deviceMs the mix charged,
   summed over principals (the batchers' wall-time share: host time),
   beside the capture's device busy ms; (3) three TopN(f, Row(f=a), n=3),
   exact, feed the class-cost EWMA, then a TopN with ?timeout= between
   the estimated wait and that cost is answered 503 with code "shed"
   and a query with an expired deadline 503 "deadline", neither
   launching a kernel; (4) a count latency objective of a hundredth of
   the Count pass's p50: after a few Counts /status reports health red
   with the SLO's reason and the next query is shed (healthRed); the
   objective is restored; (5) the admission's cost: the Count pass in
   four rounds, the plane off, enforce (no quota binds), enforce, off:
   the q/s ratio (no limit); (6) the event journal on the server's
   /debug/events since the phase began: health.transition to red with
   the SLO's reason and back (the sampler's tick taken before, at and
   after the red), qos.quota_debt of key:tenant-b (one query at a quota
   of QOS_DEBT_QPS, answered 429 with a Retry-After past the plane's
   QUOTA_DEBT_S), as many qos.shed_storm.start as the plane counted
   storms and an .end for each that ended; the counts by type printed.
   Also under --count-only.
3. Server, BSI path, on the same server and index (BASELINE.json
   configs[3], "BSI int field Range + Sum/Min/Max over 1B rows", the field
   of bench.py:837-842): an int field v with min 0 and max 1023 (depth 10)
   over the same 1024 shards. One reduction: values on 32768 random
   columns per shard (33.5M, uniform 0..1023) instead of every column;
   the device slab (11 planes of 128 MiB) is the same whatever the fill.
   Loaded through API.import_values, one JSON values import and a few
   Set(col, v=x) over HTTP; the cold slab build is timed apart; Sum, Min,
   Max (with and without a filter on f), Range counts, BETWEEN, != null,
   Not, a clamp and a ?shards= column list checked against a numpy
   oracle; then 32 clients x 4 Sum(Range(v > x), field=v) with varying
   thresholds (bench.py:870), every answer checked. Launch counts are
   zeroed before the phase: bsi_compare and bsi_sum_counts must launch,
   and the sum batcher must coalesce.
4. Server, TopN/Rows/GroupBy path, on the same server and index: a ranked
   set field t of 64 rows, row r with about 12000 / (r + 1) random bits
   per shard (a Zipf-like spread of segment sizes, about 58M bits), loaded
   through API.import_bits plus one JSON import, then Set/Clear over HTTP
   that must move the rank caches. TopN (the cache path; a Src Row(f=a) for
   every a; tanimotoThreshold; threshold; ids= with a Src), Rows (plain,
   limit/previous, column) and GroupBy (f x t: 8 x 64 groups, with limit,
   with filter=Range(v > 500); and three axes with limited Rows) checked
   against a numpy oracle; the cold first Src TopN (64 leaves of 128 MiB
   built from the host) and the cold first GroupBy (the 8 GiB rows slab)
   timed apart from warm repeats; then 32 clients x 1 TopN(t, Row(f=a),
   n=10) with varying a, every answer checked. Launch counts are zeroed
   before the phase: topn_counts_packed and cross_count_matrix must launch.
5. Server, hybrid sparse/run path, on the same server and index (Pilosa's
   Getting Started "Star Trace": a stargazer row holds the few
   repositories one user starred), with no rank caches: a set field s of
   32 rows, row a with
   min(4096, 8 * 2^(a mod 10)) random bits per shard (every row plans
   sparse, K = 8..4096; about 25M bits), and a set field r of 4 rows with
   2-16 intervals per shard totalling 5000-8000 bits (they plan run, about
   26M bits). sparse∩dense, sparse∩sparse, union, xor, difference, Not,
   sparse∩run, run∩dense, run∩run, a Range filter, Sum and a TopN Src over
   a sparse row checked against a numpy oracle, the cold first sparse
   leaf timed apart; Count(Row(s=a)) for every a, so that the leaves are
   resident; then 32 clients x 4 Count(Intersect(Row(s=a),
   Row(f=b))) with varying a and b, every answer checked. Launch counts
   are zeroed before the phase: sparse_intersect_dense must launch, and
   the port must have uploaded sparse and run leaves.
5c. Server, planner and plan cache, on the same server and index
   (bench.py bench_planner, :2015-2195, at full width): (a) a 4-row
   Count(Intersect) sequentially, the cache off, the planner off then on
   in one round of 20: p50 a side; (b) a dashboard of 32
   clients x 4 queries, 80 % ten shared 3-row Count(Intersect) panels
   over f and 20 % twenty 3-row Count(Union), each in a random operand
   order, in one round of cache off (cleared), on (warm), on (measured):
   q/s, p50/p99 and the hit rate (a device-profile capture in the first
   cache-off round); (c) a Count(Intersect) with a row of no bits: the
   planner answers 0 with no leaf read, upload or launch, and without the
   planner it uploads and launches; (d) three Intersect(Row(s=a),
   Row(f=b)) Row results read twice each: the second read hits, each
   holds 134,217,728 bytes, the 256 MiB default holds two and the third
   evicts one, and a Set into a row of the first (ingest path) reads back
   with the bit; (e) ?explain=true on a Count, BSI, TopN and hybrid query
   launches nothing and predicts no upload for resident leaves; a dense
   row written through the per-bit path predicts one 128 MiB plane, and
   executing the query uploads exactly that. /debug/vars planner and
   planCache equal /metrics planner_* and planCache_*. Launch counts are
   zeroed before the phase. Every other server pass runs with the plan
   cache off (Executor.plan_cache.enabled, the planner on) and says so.
5d. Server, frozen bulk loads, on the same server, each configuration in
   an index of its own loaded through Field.import_rows_frozen,
   View.load_frozen_fragment or Field.import_values_frozen on the
   server's holder, at the shapes of benches/scale_configs.py (BASELINE
   configs 2-4) and examples/similarity.py, cut only in row, shard or
   molecule counts (printed): config 2, 64 rows of 2000 bits and 1-bit
   tail rows over 10K columns (10M rows of 100M), Count of Union,
   Intersect, Xor and Difference, p50 of 9; config 3, a Zipf head of 50k
   rows and a 1-bit tail striped over 8 shards (12.5M rows of 1B),
   TopN(t, n=1000) exact with its p50 and topnRecountRows, Rows pages
   with previous=; config 4, an int field 0..1023 on every column of 96
   shards (of 953), Sum(Range), Min and Max with and without a filter,
   then 32 clients x 8 Min(Range(v > x))/Max(Range(v < x)) through the
   MinMaxBatcher with a device-profile capture (q/s, p50/p99, batches,
   mean batch, bsi_sum_counts launches per batch, which must stay under
   (D + 1) x queries); similarity, 200,000 molecules of 48 of 2048
   fingerprint bits in families of 100 (75 % motif retention) with a rank
   cache the size of the corpus, TopN(fingerprint, Row(fingerprint=7),
   n=20) and tanimotoThreshold 90, 70, 50 exact against a numpy brute
   force, through the sparse host walk (no topn_counts_packed launch,
   every candidate recounted once); a small frozen field (3000 rows of 40
   bits over 2 shards) where a Set into a candidate row sends the walk
   down the dense path (topn_counts_packed launches, exact). /debug/vars
   volatileFragments lists every frozen fragment with its mutations; the
   similarity fragment, snapshotted and reopened, parses frozen, answers
   the same and leaves the list. Per configuration: build seconds, bits,
   host RSS (ru_maxrss), device bytes resident. The indexes are deleted
   at the end (their host memory). Launch counts are zeroed before the
   phase.
5e. Server, typed fields (Star Trace), on the same server: index
   startrace, the reference's getting-started schema (examples/
   star_trace.py, docs/getting-started.md) over 1024 shards, loaded
   through POST /import in chunks of 64 shards: a time field stargazer
   (quantum YMD) where user u of 256 stars about 200,000 / (u + 1)
   uniformly random repositories (about 1.2M stars; the shape's 2,000,000
   cut ten times, see TYPED_STARS_HEAD) at uniform timestamps over
   2019-01-29..2019-02-28 (31 day views, 2 month views, the year view and
   the standard view; epoch numbers, the last chunk ISO-8601 strings); a
   mutex field license of 16 rows over the starred repositories, imported
   once and then a seeded 10 % reassigned (the last write wins); a bool
   field fork, about 20 % true; one shard of a set field extra through
   POST /import-roaring with a standard and a time view built with the
   port's roaring writer. Count(Range(stargazer=u, start, end)) over one
   week (7 day views), one month (1 view), a ragged span (day, month and
   day views) and the year (1 view), each window's cold first query and
   warm p50; Intersects with mutex and bool rows (2 and 3 leaves, and 3
   dense range leaves); TopN(stargazer), TopN(license, Range(...)), Rows,
   GroupBy(license x fork); then 32 clients x 4 Count(Intersect(Range(
   stargazer=u, window), Row(license=l))) over 8 users x 4 windows x 4
   licenses with a device-profile capture; then writes over HTTP with the
   reads they change (a timestamped Set into a covered day view, a mutex
   Set moving a column between rows, a bool Set, ClearRow of user 100's
   stars, Store) and
   Options (shards=, excludeColumns). Every answer is exact against a
   numpy oracle of the generated arrays. Printed: the import seconds per
   field, positions per view family, host RSS, device bytes resident, the
   phase's seconds. Launch counts are zeroed before the first query:
   pair_stream_counts, program_count, sparse_intersect_dense and
   topn_counts_packed must launch. The index stays for phase 5f.
5f. Server, string keys and attributes, on the same server. (A) On
   phase 5e's index: the schema's language set field with "keys": true,
   64 language names as row keys, every starred repository tagged with
   one (language r takes a share 1 / (r + 1)), imported over /import as
   rowKeys + columnIDs in phase 5e's chunks of 64 shards (one chunk a
   protobuf ImportRequest); row attributes {paradigm, year, typed} on all
   64 rows in one request of SetRowAttrs calls; TopN(language, n=10),
   TopN(language, Row(license=3), n=10), TopN by attrName/attrValues,
   GroupBy(Rows(language), Rows(fork)), a language row intersected with
   a one-week stargazer Range (user 4: phase 5e clears user 7), Rows with
   a previous key, a Row with its attributes; then 32 clients x 4 of
   those keyed queries with a device-profile capture; then an unknown
   key's Count reads 0 and mints nothing (the translate log's size is
   unchanged), and after a Set of it the same Count reads 1 with the plan
   cache on. (B) A keyed-column index of 1,048,575 user logins (ids start
   at 1, so they fill shard 0 exactly; cut by the time limit from a
   deployment of tens of millions of accounts): a keyed country field of
   200 names (share 1 / (r + 1)) and an int field followers 0..1,000,000,
   imported with columnKeys (rowKeys, values) in requests of 262,144
   keys, one of each field protobuf; column attributes on 1,000 logins in
   one request; Count and Sum(field=followers) of the four top countries
   (dense rows), Count(Range(followers > 500000)), the rarest country's
   Row with columnAttrs=true (its login keys and attribute sets), the
   largest Row of keys; one envelope of 500 keyed Set/Clear calls through
   the IngestBatcher, 400 of them minting logins; /export of shard 0 of
   country; DELETE of country, which must give its resident device bytes
   back (torch.cuda.memory_allocated). Every answer is exact against a
   numpy oracle built from the seed, keys and the ids minted in import
   order included. Printed: seconds per import, the mint us a key, the ms
   to render the largest Row of keys, the launches in the phase (zeroed
   before it): topn_counts_packed, cross_count_matrix,
   sparse_intersect_dense, pair_stream_counts, bsi_sum_counts and
   bsi_compare must launch. Both indexes are deleted at the end.
5g. The cluster (BASELINE.json configs[4], "16-shard distributed
   Intersect+Count: cluster mapReduce"; bench.py bench_distributed,
   three nodes): three node processes of `python -m pilosa_tpu_torch.cli
   server --config n<i>.toml` on the one card ([cluster] disabled =
   false, replicas 2, hosts naming all three, membership-interval 0.5,
   the default liveness-threshold 3 and probe-timeout 2 s, [anti-entropy]
   interval 5 s, the plan cache off; .id files node0 < node1 < node2, so
   node 0
   coordinates and mints keys), each node's kernel build 0 s (phase 1
   built the library). Index d over 128 shards (cut by the time limit
   from 1024; widths and shapes the single-node phases'): f's 8 dense rows
   and t's 64 ranked rows through node 0's /import-roaring one shard a
   request, s (8 sparse rows, K = 16..2048), v (0..1023 on 32768 columns
   a shard) and lang (16 keys on 4096 columns a shard) through its
   /import in chunks of 32 shards; node 0 forwards every part to its
   owners. Reads through node 0 and again through node 2, exact against
   a numpy oracle: every Count(Intersect) of f, a 3-way one, a Row of
   millions of columns, Sum/Min/Max with a filter, Count(Range(v > 500)),
   TopN(t, n=10) and with a Src (the phase-2 recount), Rows with a limit,
   GroupBy(Rows(f), Rows(t), limit=100), sparse∩dense Counts and keyed
   Counts; a ?profile=true Count whose tree holds one fan-out record per
   node the shards route to and the coalesced transport; 32 clients x 8
   Count(Intersect) through node 0 with a device-profile capture on every
   node (q/s, p50/p99, coalesce factor and dedups); the coalescing A/B
   (off, on; nothing claimed); 4 Counts through node 0 as X-API-Key:
   tenant-c at X-Pilosa-Priority: batch, node 1's /debug/usage listing
   key:tenant-c (the principal inherited through the envelope), and an
   envelope entry whose deadline has expired sent to node 1: refused,
   counted there as deadlineRemote, no kernel launched on node 1; 4
   writers x 4 envelopes of 500
   Set/Clear on a field w through nodes 0 and 1 under 16 exact readers
   and one keyed envelope through node 2 minting 100 keys through the
   primary; every acknowledged mutation read back from both of its owners
   (?remote=true over each node's shards); a Set into a new shard read
   through every node right after its ack; every node's .keys log equal
   to the primary's. The drill: (1) SIGKILL node 2 under 8 readers
   through node 0 (no read may fail): nodes 0 and 1 mark it down by
   probing (the seconds to each mark; the readers' p50 and slowest read
   before the kill, between the kill and the mark and after the mark),
   and ?profile=true Counts after the mark hold no failover record; (2) 4
   writers x (3 envelopes of 200 Sets + 25 single Sets) through nodes 0
   and 1 into node 2's shards, a shard no data holds included: every one
   acknowledged, hints queued on both (writes/s, hints pending), and a
   Clear of a loaded bit of w in a shard of nodes 1 and 2 through node 0
   acknowledged; (3) a
   Set planted on node 1 alone (remote=true) in a shard of nodes 0 and 1,
   and one of node 2's f fragments truncated inside its snapshot; (4)
   node 2 restarted: the file quarantined and the fence armed, 2 readers
   through node 2 exact while fenced (the fenced shards re-routed), the
   peers' hints replayed, the fence lifted, the file rebuilt (seconds to
   ready, hints, lift and rebuild); (5) node 2's first scrub pass (every
   node's passes since the restart, their last seconds, blocks merged),
   the planted bit carried to node 0, every outage write and the planted
   bit read back from each owner alone and the cleared bit on neither,
   and every read through node 2 exact. The event journal (every node
   logs to node.log in its data dir, node 1 as JSON lines; node 2 spools
   its events, 1 MiB): every response carries X-Pilosa-HLC; GET
   /cluster/events through node 0 lists all three ok, in HLC order, each
   node's seq rising, and holds the drill's chain in causal order (the
   probe peer.down of node 2 on nodes 0 and 1, then their hint.append
   for it; node 2's pre-kill events, reloaded from its spool across the
   SIGKILL, before both marks; its node.start, snapshot.quarantined of
   the truncated file and fence.armed after every append; each peer's
   hint.replay after the fence and before every fence.lifted of a shard
   that waited for the hints; a scrub.pass of node 2 after its last
   lift); SIGQUIT to node 1 writes events.crash-<ts>.jsonl into its data
   dir, every line of it in its /debug/events, and a Count through it
   is exact after; each node's log file parses, its WARN and ERROR
   records as many as its log.warn and log.error events plus the log
   lane's evictions; per node the events by type, the spool bytes and
   the checks' seconds printed. Printed: node start seconds,
   load seconds and forwarded bytes, each kernel's launches per node
   (program_count, pair_stream_counts, topn_counts_packed,
   bsi_sum_counts, bsi_compare, cross_count_matrix and
   sparse_intersect_dense must launch, summed over the nodes), the route
   and hedge counters, the resident bytes per node before and after.
   A node that exits early fails the run; every node is stopped at the
   end.
5h. Membership changes, on phase 5g's nodes after its drill, and SWIM
   gossip: (1) scale-out: node 3 starts as a CLI process with --join, an
   empty data dir and the three nodes as its hosts, under 4 readers and 1
   writer of single Sets through node 0; the seconds until all four
   report NORMAL with four members, the fragments and bytes node 3
   received and the reads and writes the RESIZING gate refused meanwhile
   (a refused Set is sent again until acknowledged); every acknowledged
   write read back from each owner alone, phase 5g's oracle reads
   through node 3 and node 0 exact, every node's fragment files of
   shards it owns only (node 3 holding f's of all of its shards), every
   .topology listing four ids, node 3 launching kernels; (2) rolling
   restart: POST /cluster/drain on node 2, a query to it answered 503
   with X-Pilosa-Shed-Reason: draining and Retry-After: 1, 8 readers
   through node 0 without a failure, the drain's snapshots, SIGTERM and
   exit 0 (seconds); (3) decommission: remove-node node 2 through node 1
   (forwarded to the coordinator; the leave job copies node 2's shards
   from their other replicas), nodes 0, 1 and 3 NORMAL with three members
   (seconds, fragments moved), the oracle reads through each exact, the
   read-back from each owner alone, no hints for node 2 anywhere; (4) the
   gossip pair g0 and g1, CLI processes started beside phase 5f with no
   hosts, replicas 2 and [gossip] (period 0.25 s, a shared secret, each
   other as seeds): the seconds until they are members of each other by
   gossip alone; a Count(Intersect) over 16 shards imported through g0
   exact through g0 and g1, both launching kernels; SIGKILL g1, and the
   seconds until g0 marks it down by suspicion; a Count through g0 exact
   while DEGRADED; the cipher's seal and open ms a datagram in g0's
   process. The event journal: drain.start and drain.complete on node 2
   and peer.draining on nodes 0, 1 and 3 before its SIGTERM, its spool
   ending with node.stop after; resize.start and resize.complete on the
   coordinator for the join and the leave, a topology.change naming the
   node on every other member (the coordinator records its own change as
   resize.complete, as the JAX package does), node 3's node.start; g0's
   peer.down of g1 by gossip, its next stamp past the last one g1 sent
   before the kill; at the end GET /cluster/events through node 0 (node
   2 absent or down, the rest ok) and `python -m pilosa_tpu_torch.cli
   timeline --host <node 0>` once (exit 0, one line an event). Phase
   5h's launches count with phase 5g's.
5i. Faults and operations (the JAX chaos suite, tests/test_chaos.py,
   against port nodes, with the operator's surfaces), after phase 5h:
   (a) three in-process port nodes on the card, replicas 2, 4 rows of f
   over 128 shards at phase 2's density imported through node 0 before
   any fault is armed; the failpoints' chaos schedule armed with the JAX
   suite's seed 20250804 at rate 0.08 on its five storm points (torn WAL
   appends, failed and partial RPC sends and reads, injected fan-out and
   dispatch faults); 8 clients send 320 Count(Intersect) and 192 Set
   through nodes 0 and 1, and node 2's listener closes halfway: every
   answer equals the oracle or is a clean JSON error; the fired counts
   by point, the acknowledged and refused Sets and the kernel launches
   during the storm (/debug/vars) are printed; faults reset, paced scrub
   passes until the co-owned block checksums agree (seconds); every
   acknowledged Set reads back on each survivor alone and through it,
   every Count equals the oracle; node 2 marked down, Sets into its
   shards acknowledged with hints. (b) A port writer process (the
   batched write path, PILOSA_TPU_WAL_FSYNC=always,
   PILOSA_TPU_CONTAINER_STORE=btree), started beside phase 5f, SIGKILLed
   after 2,000 acknowledged bits; a port server on the card opens its
   data dir and every acknowledged bit reads back through Row and Count.
   (c) Two port nodes over HTTPS with a throwaway certificate (openssl
   req) and skip-verify: Count(Intersect) over 16 shards fanned out over
   HTTPS equals the oracle. (d) The CLI against the storm's nodes: a CSV
   imported and exported back unchanged, check and inspect on fragment
   files and hint logs (OK; a damaged copy of each FAILED),
   profile-capture against node 0 (ok, its spool exists). (e) The first
   TLS node phones home to a listener inside the script every 0.5 s:
   exactly the documents sent are received, none after close; its
   [metric] poll-interval gauges are on /metrics. Launch counts are
   zeroed before the storm and read at the end: pair_stream_counts and
   program_count must have launched. `--faults-only` runs phases 1 and
   5i alone.
6. Server, write path, on the same server and index (bench.py's ingest
   stage, bench.py:1824-1935, cut to a fixed length): 8 keep-alive writers
   each send 2 envelopes of 500 calls, 80 % Set of a column of their own
   (column % 8 = writer) anywhere in the 1024 shards on one of f rows 0-7
   (dense), s rows 1-8 (sparse, K = 16..2048) or r row 0 (run), 20 %
   Clear of a (row, column) the writer set earlier: 8,000 mutations,
   served through the IngestBatcher, Fragment.apply_batch and the
   in-place patches of the resident leaves, while 32 clients run
   Count(Intersect(Row(f=a), Row(f=b))). Every changed flag is checked
   against a numpy oracle updated in each writer's own order (columns are
   disjoint per writer, so the state is exact whatever the interleaving);
   then read-backs (Count of every written row, 8 f pairs, 8 s∩f, a
   3-way Intersect, TopN with and without a Src, Not) are exact, the f
   rows are served from their patched leaves (no dense upload), no dense
   patch was dropped, and pair_stream_counts, program_count,
   sparse_intersect_dense and topn_counts_packed launch after the writes.
   Printed: acked mutations/s, the readers' p50/p99 against a writer-free
   round, the group-commit ratio, batches, patches and drops, the bytes
   uploaded by form after the writes, and the first Count(Intersect)
   after a burst of 1 envelope a writer with ingest on, then off
   (PILOSA_TPU_TORCH_INGEST=0), with the sparse rows read back after the
   batched burst. Launch counts are zeroed before the phase.
7. Kernels at full width: W = 32768 words, S = 1024 shards (1.07B
   columns), random planes from a seeded torch.Generator on the card. Each
   kernel is held against its plain torch version, exactly (integer
   counts, tolerance 0): pair_stream_counts for all 5 ops at K = 1024 over
   a 32-row slab (4 GiB), over every query and as the CountBatcher
   launches it (over the distinct canonical pairs); then both launches
   timed in turns (every, distinct, distinct, every) at bench.py's headline
   batch (K = 512 pairs of distinct rows among 16), at the batcher's cap
   of 512 and the server's mean batch over its 8 rows; program_count on
   a 4-leaf program with xor/andnot/not, a 40-leaf one and the BSI
   descents' two programs (each timed by CUDA events, on the device by
   torch.profiler and on the host), a balanced 16-leaf one (the deepest
   class) and 300-leaf ones that take the device table at each depth
   class; intersect_count (three times as well); bsi_compare for all 6 ops at depth 10 and gt at depth
   32 (4 GiB of planes); bsi_sum_counts, both forms (grid and staged)
   timed in turns, at K = 1, 2, 32 and the served mean batch at depth 10,
   and K = 1 at depth 32; topn_counts_packed at R = 64
   (the server's launch size) and at R = 130 over 256 shards (past the
   Pallas kernel's 128-row block); cross_count_matrix at P = 8 (the
   GroupBy's valid prefixes) and P = 16 (its chunk), R = 64;
   sparse_intersect_dense, both modes, at K past each edge of its work
   units, at every K the hybrid phase served and at K = 16384 (event,
   device and host times). Times by CUDA events (warm, median).
8. The last lines: nvidia-smi's name and power limit, one JSON object with
   a record per kernel (its launches summed over the eleven paths, with
   launches_by_path beside; bsi_sum_counts adds its launches by form and
   the form the served shape takes; served_device_ms_p50 is its device
   ms as served, from the paths' device-profile captures, over
   served_device_launches launches; served_stream_ms_p50 the time
   between the CUDA events around its launches, over the pairs that no
   other launch began or ended inside (an upper bound: plain-torch work
   of other request threads can fall between), served_stream_pairs how
   many, and served_stream_overlapped the pairs left out), and {"ok":
   true, "device": {...}}.

Observability, on every server path (phases 2-6), riding its concurrent
pass: one POST /debug/device-profile (2 s on the Count and write paths,
1 s on the others) whose spooled trace must name a port kernel, with the
device's idle share over it and each port kernel's device ms; one ?profile=true query whose tree must
hold the expected batcher dispatch record (CountBatcher on Count,
PlaneSumBatcher on Sum, none on TopN and hybrid), residency hits with no
host-to-device bytes, and calls within its elapsed time. At the end of
the path's window (launch counts and kernel statistics zeroed together):
/debug/vars, /metrics, /debug/hbm and /debug/heat scraped; the "pallas"
dispatches equal the eight kernels' launches, each kernel's launches in
the kernel statistics equal its count, every CUDA event pair resolved;
accounted device bytes, the distinct storages of the residency and the
plan cache (scalars hold none), fit in torch.cuda.memory_allocated() (the drift printed, with the JAX package's
sum of resident and plan-cache entry bytes beside); stream ms by events
(p50, p99) beside host ms per kernel. On
the write path the ingest counters of /metrics equal
Executor.ingest_snapshot(), and the heat map's writes equal the oracle's
count (every Set, and a Clear that changed a bit). The Count path also
runs five rounds of its pass, one of each: everything on, the heat
map off, the kernel statistics off, the telemetry sampler stopped, all
off. After the hybrid path,
phase 5b reads five fields in turn (5 x 1024 fragments, past the heat
map's 4096) in two rounds, the heat map on and then off: the heat-on
round must spill. Phase 1 times HeatTracker.touch_many over 1024 shards
(at most 100 µs), and charges that spill.

    python3 chip_smoke.py --count-only   # phases 1-2 only, then the Count
                                         # path's numbers as one JSON line

--count-only drives the Count path alone (same data, same clients) and
prints its served rate, latencies, the CountBatcher's host time per
batch and the path's observability checks (which need the routes of
the observability layer: a checkout older than it no longer runs here).

    python3 chip_smoke.py --kernel-times # phase 1, then program_count,
                                         # intersect_count and
                                         # sparse_intersect_dense alone

--kernel-times runs the program and sparse parts of phase 7 without the
server (8 random planes; K = 8..4096 as the hybrid phase serves them, and
16384) and prints their numbers as one JSON line. It calls only wrapper
functions an older checkout also has, so a copy beside one times it too.

    python3 chip_smoke.py --frozen-only         # phases 1 and 5d alone
    python3 chip_smoke.py --frozen-scale 1.0    # ... at full sizes
    python3 chip_smoke.py --frozen-scale 1.0 --frozen-configs 3

--frozen-only runs phase 5d on a fresh server at its own cuts;
--frozen-scale S at S of every configuration's full size (1.0: BASELINE's
100M rows, 1B rows, 953 shards; the similarity corpus at 10 S of its
500,000 molecules, at most all), and --frozen-configs picks among 2, 3, 4
and sim. Both print the host's free memory first and the phase's
numbers as one JSON line.

    python3 chip_smoke.py --typed-only   # phases 1 and 5e alone

--typed-only runs phase 5e on a fresh server and prints its numbers as
one JSON line.

    python3 chip_smoke.py --keyed-only   # phase 1, phase 5e's loads and
                                         # phase 5f alone

--keyed-only loads phase 5e's index without its passes and runs phase 5f
on it, printing its numbers as one JSON line.

    python3 chip_smoke.py --cluster-only # phases 1, 5g and 5h alone

--cluster-only runs phases 5g and 5h (three node processes, a fourth
that joins, the gossip pair) and prints their numbers as one JSON line.

    python3 chip_smoke.py --ingest-only  # phases 1-2, then phase 6 on
                                         # s and r loaded without phase 5

--ingest-only runs the Count path, loads s and r as phase 5 would, and
runs the write path, printing its numbers as one JSON line.

Bounds: the larger of the bytes each input read once over HBM's 3.35 TB/s
and the operations over the card's rate for their type. The integer rates
come from the CUDA C++ Programming Guide's arithmetic-instruction
throughput table for compute capability 9.0 (results per clock per SM: 64
for 32-bit integer add and bitwise ops, 16 for __popc), times the SM count
and the card's maximum SM clock as nvidia-smi reports them.
sparse_intersect_dense's bytes depend on the data: its indices in, its
output out, and the distinct 32-byte plane sectors its entries touch. The
pair stream's bound counts the distinct rows' bytes and the distinct
canonical pairs' operations (what the answers need); the earlier
formula, operations for every query, is printed beside it.
"""

from __future__ import annotations

import argparse
import collections
import gc
import http.client
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# results per clock per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput)
INT32_PER_CLK_SM = 64   # 32-bit integer add, and/or/xor/not
POPC_PER_CLK_SM = 16    # __popc
SHARD_WIDTH = 1 << 20
SOURCE = "pilosa_tpu_torch/csrc/bitmap_kernels.cu"
REPLACES = {
    "pair_stream_counts": "pilosa_tpu/ops/pallas_kernels.py:234",
    "program_count": "pilosa_tpu/ops/pallas_kernels.py:108",
    "intersect_count": "pilosa_tpu/ops/pallas_kernels.py:59",
    "bsi_compare": "pilosa_tpu/ops/pallas_kernels.py:451",
    "bsi_sum_counts": "pilosa_tpu/ops/pallas_kernels.py:504",
    "topn_counts_packed": "pilosa_tpu/ops/pallas_kernels.py:364",
    "cross_count_matrix": "pilosa_tpu/ops/pallas_kernels.py:182",
    "sparse_intersect_dense": "pilosa_tpu/ops/pallas_kernels.py:295",
}
COUNT_KERNELS = ("pair_stream_counts", "program_count", "intersect_count")
BSI_KERNELS = ("bsi_compare", "bsi_sum_counts")
TOPN_KERNELS = ("topn_counts_packed", "cross_count_matrix")
HYBRID_KERNELS = ("sparse_intersect_dense",)
# the device kernel of each form of bsi_sum_counts, as the profiler names
# it
SUM_FORM_KERNELS = {"grid": "bsi_sum_kernel",
                    "staged": "bsi_sum_staged_kernel"}
HYBRID_S_ROWS = 32  # rows of the stargazer-like set field s
HYBRID_R_ROWS = 4   # rows of the run field r
# the hybrid phase's pass: 4 a client since phase 5g joined the run (8
# since 5f, 16 before), for the time limit
HYBRID_CLIENTS, HYBRID_PER_CLIENT = 32, 4
SPARSE_SENTINEL = SHARD_WIDTH
# the write phase (bench.py:1824-1827 and 1830-1935, cut to a fixed length)
INGEST_WRITERS = 8      # keep-alive writer threads (bench.py:1824)
INGEST_CALLS = 500      # Set/Clear calls per envelope (bench.py:1825)
# envelopes per writer in the measured window: 2 since phase 5h joined
# the run (3 since the drill's healing steps joined phase 5g, 4 since 5g,
# 12 since 5f, 20 since 5e, 30 since 5d, 40 before), to keep the whole run
# inside its time limit
INGEST_ENVELOPES = 2
# per writer in each ingest on/off turn: 1 since phase 5g joined the run
# (3 since 5e, 5 before), to keep the whole run inside its time limit
INGEST_TURN_ENVELOPES = 1
INGEST_READERS = 32     # Count(Intersect) clients during the window
INGEST_S_ROWS = tuple(range(1, 9))  # rows of s written: K = 16..2048
INGEST_TURNS = ("on", "off")
# the K of the hybrid phase's rows (min(4096, 8 x 2^(a mod 10)) bits per
# shard, padded as the chooser pads), for runs without the server
SERVED_SPARSE_K = [8 << i for i in range(10)]
SPARSE_EDGE_K = (1, 31, 33, 255, 257, 511, 513, 2049, 4097)
TOPN_ROWS = 64  # rows of the set field t
TOPN_BITS = 12000  # bits per shard of t's row 0; row r holds ~this/(r+1)
# the TopN phase's concurrent pass: 4 per client since phase 5e joined the
# run (8 since 5d, 16 before), to keep the whole run inside its time limit
# the TopN pass: 2 a client since phase 5f joined the run (4 before), for
# the time limit
TOPN_CLIENTS, TOPN_PER_CLIENT = 32, 1  # 1 since phase 5g (2 before)
BSI_DEPTH = 10  # the int field v: min 0, max 1023
# int32 operations per plane word of the compare sweep (lt/gt: and, not,
# or, xor, not, and) and of the sum (and, add; plus one __popc)
CMP_OPS_PER_PLANE_WORD = 6
SUM_OPS_PER_PLANE_WORD = 2
# the 4-leaf program_count case: per word 4 combining ops, a popc, an add
PROGRAM = ("or", ("xor", ("leaf", 0), ("leaf", 1)),
           ("andnot", ("leaf", 2), ("not", ("leaf", 3))))
# 40 leaves, as Count(Union(...)) of 40 Rows gives: 39 combining ops
WIDE_PROGRAM = ("or", ("xor", *[("leaf", i) for i in range(0, 40, 2)]),
                ("andnot", *[("leaf", i) for i in range(1, 40, 2)]))
# the BSI Min descent's program (ops/bsi.py _ANDNOT2), launched D times a
# query, and ("leaf", 0) once
DESCENT_PROGRAM = ("andnot", ("leaf", 0), ("leaf", 1))


_T_RUN = time.perf_counter()  # the run's start, for the phase headers


def log(msg: str) -> None:
    """A line of the run's log; a phase header carries the seconds since
    the run started."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _T_RUN:.1f} s into the run]"
    print(msg, flush=True)


def smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader", *fmt))],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def int_rates() -> tuple[float, float]:
    """(32-bit integer ops/s, popc/s) of card 0 at its maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = float(smi("clocks.max.sm", "nounits")) * 1e6
    return sms * clk * INT32_PER_CLK_SM, sms * clk * POPC_PER_CLK_SM


def cuda_ms(fn, runs: int, warm: int = 2) -> float:
    """Median wall time of fn() on the card by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, runs: int, kernel, per_call: int = 1) -> float | None:
    """Mean device time per fn() call of the kernels whose name holds
    `kernel` (a string, or a tuple of alternatives), by torch.profiler's
    CUDA activity (CUPTI). A pass counts only if the profiler saw all
    runs x per_call launches; None where no pass of three did. Unlike
    cuda_ms it leaves out the wrapper's host work and the other launches
    of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then drops some of a pass's spans
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(n in e.name for n in names)]
        if len(spans) == runs * per_call:
            return sum(spans) / runs / 1e3
    return None


def host_ms(fn, runs: int) -> float:
    """Mean host time per fn() call: the wrapper's work up to the launch
    being queued (no synchronisation inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t = (time.perf_counter() - t0) / runs * 1e3
    torch.cuda.synchronize()
    return t


def batched_pairs(leaves, ii, jj, op: str, gather: bool = False):
    """pair_stream_counts as the CountBatcher launches it: over the
    queries' distinct canonical pairs (ops/kernels.py plan_pairs). Returns
    the [P, C] partials, or with gather the [K, C] partials of the
    queries."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    plan = kernels.plan_pairs(ii, jj, op)
    out = kernels.pair_stream_counts(leaves, plan.a, plan.b, op)
    if gather:
        inverse = torch.from_numpy(plan.inverse).to(out.device)
        out = out.index_select(0, inverse)
    return out


def bound(nbytes: float, int_ops: float, popcs: float,
          rates: tuple[float, float]) -> tuple[float, str]:
    """Least time in ms: bytes over HBM's rate, or each operation type
    over its own rate (the slower type; the two can issue together)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / rates[0], popcs / rates[1]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _us(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f}"


def max_abs_err(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max().item())


# ---------------------------------------------------------------- kernels


def kernel_phase(device, n_shards: int, words: int, slab_rows: int,
                 k_check: int, k_served: int, seed: int, runs: int) -> dict:
    """Each kernel against its plain version at the main path's shapes;
    returns name -> measurements. The record's ms, plain_ms and bound_ms
    are taken at the shapes the server gave the kernel."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed)
    slab = torch.empty((slab_rows, n_shards, words), dtype=torch.int32,
                       device=device)
    for r in range(slab_rows):
        slab[r] = torch.randint(-2**31, 2**31, (n_shards, words),
                                dtype=torch.int64, device=device,
                                generator=gen).to(torch.int32)
    slab[0, :, :64] = -1           # all-ones words
    slab[1, :, :64] = -2**31       # 0x80000000
    leaves = list(slab.unbind(0))
    plane_bytes = n_shards * words * 4
    n_words = n_shards * words
    n_chunks = -(-n_shards // kernels.SUM_SHARD_CHUNK)
    rng = np.random.default_rng(seed)
    out = {}

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    # pair_stream_counts: all five ops at K = k_check over the whole slab,
    # over every query and as the CountBatcher launches it (over the
    # distinct canonical pairs, mapped back to the queries)
    ii = rng.integers(0, slab_rows, size=k_check)
    jj = rng.integers(0, slab_rows, size=k_check)
    per_op = {}
    for op in kernels.PAIR_OPS:
        want = kernels.pair_stream_counts_plain(leaves, ii, jj, op)
        check(f"pair_stream_counts[{op}] K={k_check}",
              kernels.pair_stream_counts(leaves, ii, jj, op), want)
        check(f"pair_stream_counts[{op}] K={k_check} distinct pairs",
              batched_pairs(leaves, ii, jj, op, gather=True), want)
        per_op[op] = cuda_ms(lambda: batched_pairs(leaves, ii, jj, op), runs)
        log(f"  pair_stream_counts[{op}] K={k_check}: "
            f"{per_op[op] * 1e3:.1f} us over the distinct pairs, exact")

    # ... and "and" at a table of shapes, the launch over every query (the
    # batcher's before it deduplicated) and over the distinct pairs (the
    # batcher's now) timed in turns (every, distinct, distinct, every):
    # bench.py's headline batch (K = 512 pairs of distinct rows among 16,
    # bench.py:295-299), K = 512 and the served mean batch over the
    # server's 8 rows
    bench_rng = np.random.default_rng(23)
    bench = [tuple(bench_rng.choice(16, size=2, replace=False))
             for _ in range(512)]
    # the 8-row batches are drawn in the order (and from the generator
    # state) in which earlier versions of this script drew them, so
    # versions time the same queries
    eight = {}
    for k in sorted({k_served, 512}):
        eight[k] = (rng.integers(0, 8, size=k), rng.integers(0, 8, size=k))
    shapes = {
        "K=512 16 rows i!=j": ([p[0] for p in bench], [p[1] for p in bench]),
        "K=512 8 rows": eight[512],
        f"K={k_served} 8 rows (served)": eight[k_served],
    }
    ways = {"every_query": lambda ii, jj: kernels.pair_stream_counts(
                leaves, ii, jj, "and"),
            "distinct_pairs": lambda ii, jj: batched_pairs(leaves, ii, jj,
                                                           "and")}
    by_shape = {}
    for label, (ii, jj) in shapes.items():
        ii, jj = np.asarray(ii), np.asarray(jj)
        k = ii.size
        plan = kernels.plan_pairs(ii, jj, "and")
        want = kernels.pair_stream_counts_plain(leaves, ii, jj, "and")
        check(f"pair_stream_counts[and] {label}", ways["every_query"](ii, jj),
              want)
        check(f"pair_stream_counts[and] {label} distinct pairs",
              batched_pairs(leaves, ii, jj, "and", gather=True), want)
        turns = {w: [] for w in ways}
        for way in ("every_query", "distinct_pairs", "distinct_pairs",
                    "every_query"):
            turns[way].append(cuda_ms(lambda: ways[way](ii, jj), runs))
        ms = {w: statistics.mean(t) for w, t in turns.items()}
        dev = {w: device_ms(lambda: ways[w](ii, jj), runs,
                            "pair_stream_kernel") for w in ways}
        host = {w: host_ms(lambda: ways[w](ii, jj), runs) for w in ways}
        plain = cuda_ms(
            lambda: kernels.pair_stream_counts_plain(leaves, ii, jj, "and"),
            1 if k > 64 else 3, 1)
        # each input once: the distinct rows, ii/jj, the int32 partials;
        # operations for the distinct pairs (what the answers need) and,
        # labelled apart, for every query (the earlier formula)
        p = plan.a.size
        nbytes = plan.leaves.size * plane_bytes + 2 * k * 8 + k * n_chunks * 4
        b_ms, b_by = bound(nbytes, 2.0 * p * n_words, 1.0 * p * n_words,
                           rates)
        q_ms, q_by = bound(nbytes, 2.0 * k * n_words, 1.0 * k * n_words,
                           rates)
        by_shape[label] = {
            "k": k, "distinct_leaves": int(plan.leaves.size),
            "distinct_pairs": int(p), "ms": ms["distinct_pairs"],
            "ms_by_way": ms, "turns": turns, "device_ms_by_way": dev,
            "host_ms_by_way": host, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_per_query": q_ms,
            "bound_by_per_query": q_by, "bytes_once": nbytes,
            # planes each launch streams (2 per pair it runs over)
            "plane_reads": {"every_query": 2 * k, "distinct_pairs": 2 * p},
            "streamed_bytes_per_query": 2 * k * plane_bytes}
        log(f"  pair_stream_counts[and] {label} ({plan.leaves.size} rows, "
            f"{p} distinct pairs): every query {ms['every_query'] * 1e3:.1f} "
            f"us, distinct pairs {ms['distinct_pairs'] * 1e3:.1f} us (turns "
            f"{[round(x * 1e3, 1) for x in turns['every_query']]} / "
            f"{[round(x * 1e3, 1) for x in turns['distinct_pairs']]}); "
            f"device {_us(dev['every_query'])} / "
            f"{_us(dev['distinct_pairs'])} us, host "
            f"{_us(host['every_query'])} / {_us(host['distinct_pairs'])} us; "
            f"bound {b_ms * 1e3:.1f} us by {b_by} (distinct pairs), "
            f"{q_ms * 1e3:.1f} us by {q_by} (every query); plain "
            f"{plain:.2f} ms; both exact")
    served = by_shape[f"K={k_served} 8 rows (served)"]
    out["pair_stream_counts"] = {**served, "max_abs_err": 0,
                                 "per_op_ms_k_check": per_op,
                                 "k_check": k_check, "by_shape": by_shape}

    out.update(program_kernel_phase(leaves[:8], rates, runs))
    del slab, leaves
    torch.cuda.empty_cache()
    return out


def balanced(lo: int, hi: int):
    """A complete binary tree of and/or/xor over leaves lo..hi-1 (hi - lo
    a power of 2): stack depth log2(hi - lo) + 1."""
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    op = ("and", "or", "xor")[(hi - lo).bit_length() % 3]
    return (op, balanced(lo, mid), balanced(mid, hi))


def time_three(fn, runs: int, kernel) -> dict:
    """Event, device and host ms of fn() (see cuda_ms, device_ms, host_ms)."""
    return {"ms": cuda_ms(fn, runs), "device_ms": device_ms(fn, runs, kernel),
            "host_ms": host_ms(fn, runs)}


def program_kernel_phase(leaves: list, rates: tuple, runs: int) -> dict:
    """program_count and intersect_count against their plain versions over
    8 random [S, W] planes: the 4-leaf PROGRAM (xor/andnot/not), the
    40-leaf WIDE_PROGRAM over the 8 planes, the BSI descents' ("andnot",
    0, 1) and ("leaf", 0), a balanced 16-leaf program (stack depth 5, the
    deepest class), and programs too long for the kernel's parameter (a
    300-leaf chain, alone and combined with balanced trees of depth 3 and
    5), which take the device table at each depth class. Event, device and
    host ms of each served program, and of intersect_count."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    n_shards, words = leaves[0].shape
    plane_bytes = n_shards * words * 4
    n_words = n_shards * words

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    def count(progleaves, program):
        return kernels.program_count(progleaves, program)

    long_chain = ("or", *[("leaf", i) for i in range(300)])
    chain_leaves = [leaves[i % 8] for i in range(300)]
    cases = (
        ("4 leaves", PROGRAM, leaves[:4], True),
        ("40 leaves", WIDE_PROGRAM, [leaves[i % 8] for i in range(40)], True),
        ("descent andnot", DESCENT_PROGRAM, leaves[:2], True),
        ("descent leaf", ("leaf", 0), leaves[:1], True),
        ("16 leaves balanced", balanced(0, 16),
         [leaves[i % 8] for i in range(16)], False),
        ("300-leaf chain", long_chain, chain_leaves, False),
        ("300-leaf chain xor balanced(0, 4)",
         ("xor", long_chain, balanced(0, 4)), chain_leaves, False),
        ("300-leaf chain xor balanced(0, 16)",
         ("xor", long_chain, balanced(0, 16)), chain_leaves, False),
    )
    progs = {}
    for label, program, progleaves, timed in cases:
        want = kernels.program_count_plain(progleaves, program)
        plan = (kernels.program_plan(program, len(progleaves))
                if hasattr(kernels, "program_plan") else None)
        check(f"program_count {label}", count(progleaves, program), want)
        del want
        codes, _, depth = kernels.encode_program(program)
        rec = {"leaves": len(progleaves), "instructions": len(codes),
               "depth": depth}
        if plan is not None:
            rec.update(depth_class=plan.depth_class, form=plan.form)
        if timed:
            rec.update(time_three(lambda: count(progleaves, program), runs,
                                  "program_count"))
            rec["plain_ms"] = cuda_ms(
                lambda: kernels.program_count_plain(progleaves, program), 3, 1)
            combining = sum(c != kernels.LEAF for c in codes)
            distinct = len({t.data_ptr() for t in progleaves})
            nbytes = distinct * plane_bytes + n_shards * 4
            b_ms, b_by = bound(nbytes, (combining + 1.0) * n_words,
                               1.0 * n_words, rates)
            rec.update(bound_ms=b_ms, bound_by=b_by, bytes_once=nbytes)
            log(f"  program_count {label}: {rec['ms'] * 1e3:.1f} us, device "
                f"{_us(rec['device_ms'])} us, host {_us(rec['host_ms'])} us "
                f"(bound {b_ms * 1e3:.1f} us by {b_by}; depth {depth}"
                + (f", class {plan.depth_class}, {plan.form}" if plan else "")
                + "), exact")
        else:
            log(f"  program_count {label}: depth {depth}"
                + (f", class {plan.depth_class}, {plan.form}" if plan else "")
                + ", exact")
        progs[label] = rec
    out = {"program_count": {**progs["4 leaves"], "max_abs_err": 0,
                             "shape": "4 leaves", "all": progs,
                             "wide": progs["40 leaves"]}}

    err = check("intersect_count", kernels.intersect_count(leaves[0], leaves[1]),
                kernels.intersect_count_plain(leaves[0], leaves[1]))
    rec = time_three(lambda: kernels.intersect_count(leaves[0], leaves[1]),
                     runs, ("intersect_count", "program_count"))
    plain = cuda_ms(
        lambda: kernels.intersect_count_plain(leaves[0], leaves[1]), 3, 1)
    nbytes = 2 * plane_bytes + n_shards * 4
    b_ms, b_by = bound(nbytes, 2.0 * n_words, 1.0 * n_words, rates)
    out["intersect_count"] = {**rec, "plain_ms": plain, "bound_ms": b_ms,
                              "bound_by": b_by, "max_abs_err": err,
                              "bytes_once": nbytes}
    log(f"  intersect_count: {rec['ms'] * 1e3:.1f} us, device "
        f"{_us(rec['device_ms'])} us, host {_us(rec['host_ms'])} us (bound "
        f"{b_ms * 1e3:.1f} us by {b_by}), exact")
    return out


def minmax_descent_phase(device, n_shards: int, words: int, k_served: int,
                         seed: int, runs: int) -> dict:
    """The MinMaxBatcher's batched descent (ops/bsi.py bsi_min_max_batched,
    D + 1 bsi_sum_counts launches over one plane each) against its plain
    version at depth 10, at the batch phase 5d served and at K = 32: exact,
    with CUDA event ms beside the plain version's."""
    import torch

    from pilosa_tpu_torch.ops import bsi

    gen = torch.Generator(device=device).manual_seed(seed + 7)

    def rand(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                             device=device, generator=gen).to(torch.int32)

    planes = rand(BSI_DEPTH, n_shards, words)
    out = {}
    for k in sorted({max(1, k_served), 32}):
        cands = list(rand(k, n_shards, words).unbind(0))
        for is_min in (True, False):
            got = bsi.bsi_min_max_batched(planes, cands, is_min)
            want = bsi.bsi_min_max_batched_plain(planes, cands, is_min)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"batched descent at K = {k} differs "
                                     f"from its plain version ({err})")
        ms = cuda_ms(lambda: bsi.bsi_min_max_batched(planes, cands, True),
                     runs)
        plain = cuda_ms(
            lambda: bsi.bsi_min_max_batched_plain(planes, cands, True),
            max(2, runs // 4))
        out[k] = {"ms": ms, "plain_ms": plain, "max_abs_err": 0}
        log(f"  batched Min/Max descent, K = {k}, depth {BSI_DEPTH}: exact "
            f"against its plain version; {ms:.3f} ms a batch "
            f"({ms / k:.3f} ms a query), plain {plain:.3f} ms")
        del cands
    return out


def bsi_kernel_phase(device, n_shards: int, words: int, k_served: int,
                     seed: int, runs: int) -> dict:
    """bsi_compare and bsi_sum_counts against their plain versions at
    depth 10 (the served field) and depth 32; the record's numbers are
    taken at the shapes the server gave each kernel (gt over depth 10, the
    sum batcher's mean batch)."""
    import torch

    from pilosa_tpu_torch.ops import bsi, kernels

    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    plane_bytes = n_shards * words * 4
    n_words = n_shards * words

    def rand(*shape):
        t = torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
        t[..., :64] = -1           # all-ones words
        t[..., 64:96] = -2**31     # 0x80000000
        return t

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    out = {"bsi_compare": {}, "bsi_sum_counts": {}}
    for depth in (BSI_DEPTH, 32):
        planes = torch.empty((depth, n_shards, words), dtype=torch.int32,
                             device=device)
        for d in range(depth):
            planes[d] = rand(n_shards, words)
        exists = rand(n_shards, words)
        bits = bsi.value_to_bits(
            int(np.random.default_rng(seed).integers(1, 1 << depth)), depth)
        ops = kernels.BSI_OPS if depth == BSI_DEPTH else ("gt",)
        for op in ops:
            name = f"bsi_compare[{op}] D={depth}"
            check(name, kernels.bsi_compare(planes, exists, bits, op),
                  kernels.bsi_compare_plain(planes, exists, bits, op))
            ms = cuda_ms(lambda: kernels.bsi_compare(planes, exists, bits, op),
                         runs)
            plain = cuda_ms(
                lambda: kernels.bsi_compare_plain(planes, exists, bits, op),
                3, 1)
            # each input once (planes, exists, predicate), the mask out
            nbytes = (depth + 2) * plane_bytes + depth * 4
            b_ms, b_by = bound(nbytes,
                               CMP_OPS_PER_PLANE_WORD * depth * n_words, 0.0,
                               rates)
            out["bsi_compare"][f"{op} D={depth}"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "bytes_once": nbytes}
            log(f"  {name}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by "
                f"{b_by}), plain {plain:.2f} ms, exact")
        for k in sorted({1, 2, 32, k_served} if depth == BSI_DEPTH
                        else {1}):
            filters = [exists] + [rand(n_shards, words) for _ in range(k - 1)]
            name = f"bsi_sum_counts K={k} D={depth}"
            want = kernels.bsi_sum_counts_plain(planes, filters)
            for form in kernels.SUM_FORMS:
                check(f"{name} [{form}]",
                      kernels.bsi_sum_counts(planes, filters, form=form),
                      want)
            del want
            # both forms in turns (grid, staged, staged, grid)
            turns = {f: [] for f in kernels.SUM_FORMS}
            for form in ("grid", "staged", "staged", "grid"):
                turns[form].append(cuda_ms(
                    lambda: kernels.bsi_sum_counts(planes, filters,
                                                   form=form), runs))
            ms = {f: statistics.mean(t) for f, t in turns.items()}
            dev = {f: device_ms(
                lambda: kernels.bsi_sum_counts(planes, filters, form=f), runs,
                SUM_FORM_KERNELS[f])
                for f in kernels.SUM_FORMS}
            form = kernels.sum_form(k)  # the wrapper's default
            plain = cuda_ms(
                lambda: kernels.bsi_sum_counts_plain(planes, filters),
                3 if k < 8 else 1, 1)
            nbytes = (depth + k) * plane_bytes + k * (depth + 1) * n_shards * 4
            b_ms, b_by = bound(nbytes,
                               SUM_OPS_PER_PLANE_WORD * k * depth * n_words,
                               1.0 * k * (depth + 1) * n_words, rates)
            out["bsi_sum_counts"][f"K={k} D={depth}"] = {
                "k": k, "form": form, "ms": ms[form], "ms_by_form": ms,
                "turns": turns, "device_ms_by_form": dev, "plain_ms": plain,
                "bound_ms": b_ms,
                "bound_by": b_by, "bytes_once": nbytes,
                # planes (and filters) each form reads from HBM
                "plane_reads": {"grid": k * depth + k,
                                "staged": -(-k // 32) * depth + k}}
            log(f"  {name}: grid {ms['grid'] * 1e3:.1f} us, staged "
                f"{ms['staged'] * 1e3:.1f} us (turns "
                f"{[round(x * 1e3, 1) for x in turns['grid']]} / "
                f"{[round(x * 1e3, 1) for x in turns['staged']]}); device "
                f"{_us(dev['grid'])} / {_us(dev['staged'])} us; default "
                f"{form}; bound {b_ms * 1e3:.1f} us by {b_by}; plain "
                f"{plain:.2f} ms; both forms exact")
            del filters
        del planes, exists
        torch.cuda.empty_cache()
    cmp_ = out["bsi_compare"]
    sums = out["bsi_sum_counts"]
    return {
        "bsi_compare": {**cmp_[f"gt D={BSI_DEPTH}"], "max_abs_err": 0,
                        "shape": f"gt D={BSI_DEPTH}", "all": cmp_},
        "bsi_sum_counts": {**sums[f"K={k_served} D={BSI_DEPTH}"],
                           "max_abs_err": 0,
                           "shape": f"K={k_served} D={BSI_DEPTH}",
                           "all": sums},
    }


def topn_kernel_phase(device, n_shards: int, words: int, seed: int,
                      runs: int) -> dict:
    """topn_counts_packed at R = 64 over n_shards and R = 130 over 256
    shards, cross_count_matrix at P = 8 and 16 against R = 64 rows, each
    against its plain version; the records' numbers are taken at the
    shapes the server gave each kernel (R = 64; P = 8, R = 64)."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed + 2)

    def rand(*shape):
        t = torch.empty(shape, dtype=torch.int32, device=device)
        for i in range(shape[0]):  # one plane at a time: int64 staging
            t[i] = torch.randint(-2**31, 2**31, shape[1:], dtype=torch.int64,
                                 device=device, generator=gen).to(torch.int32)
        t[..., :64] = -1           # all-ones words
        t[..., 64:96] = -2**31     # 0x80000000
        return t

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    out = {"topn_counts_packed": {}, "cross_count_matrix": {}}
    for r, s in ((TOPN_ROWS, n_shards), (130, min(256, n_shards))):
        rows = rand(r, s, words)
        src = rand(1, s, words)[0]
        leaves = list(rows.unbind(0))
        name = f"topn_counts_packed R={r} S={s}"
        check(name, kernels.topn_counts_packed(leaves, src),
              kernels.topn_counts_packed_plain(leaves, src))
        ms = cuda_ms(lambda: kernels.topn_counts_packed(leaves, src), runs)
        plain = cuda_ms(lambda: kernels.topn_counts_packed_plain(leaves, src),
                        2, 1)
        n_words = s * words
        chunks = -(-s // kernels.SUM_SHARD_CHUNK)
        # each row and src once, the R leaf pointers, the int32 partials
        nbytes = (r + 1) * n_words * 4 + r * 8 + chunks * 3 * r * 4
        b_ms, b_by = bound(nbytes, 2.0 * r * n_words,
                           (2.0 * r + 1) * n_words, rates)
        out["topn_counts_packed"][f"R={r} S={s}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bytes_once": nbytes}
        log(f"  {name}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}), plain {plain:.2f} ms, exact")
        del rows, src, leaves
        torch.cuda.empty_cache()
    axis = rand(TOPN_ROWS, n_shards, words)
    prefix = rand(16, n_shards, words)
    n_words = n_shards * words
    chunks = -(-n_shards // kernels.SUM_SHARD_CHUNK)
    for p in (8, 16):
        pre = prefix[:p]
        name = f"cross_count_matrix P={p} R={TOPN_ROWS}"
        check(name, kernels.cross_count_matrix(pre, axis),
              kernels.cross_count_matrix_plain(pre, axis))
        ms = cuda_ms(lambda: kernels.cross_count_matrix(pre, axis), runs)
        plain = cuda_ms(lambda: kernels.cross_count_matrix_plain(pre, axis),
                        1, 1)
        nbytes = (p + TOPN_ROWS) * n_words * 4 + chunks * p * TOPN_ROWS * 4
        ops = 1.0 * p * TOPN_ROWS * n_words
        b_ms, b_by = bound(nbytes, 2.0 * ops, ops, rates)
        out["cross_count_matrix"][f"P={p} R={TOPN_ROWS}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "bytes_once": nbytes}
        log(f"  {name}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}), plain {plain:.2f} ms, exact")
    del axis, prefix
    torch.cuda.empty_cache()
    log(f"  TopN/GroupBy kernels: {time.perf_counter() - t_phase:.1f} s")
    tn, cc = out["topn_counts_packed"], out["cross_count_matrix"]
    first = f"R={TOPN_ROWS} S={n_shards}"
    return {
        "topn_counts_packed": {**tn[first], "max_abs_err": 0,
                               "shape": first, "all": tn},
        "cross_count_matrix": {**cc[f"P=8 R={TOPN_ROWS}"], "max_abs_err": 0,
                               "shape": f"P=8 R={TOPN_ROWS}", "all": cc},
    }


def hybrid_kernel_phase(device, n_shards: int, words: int, served_k: list,
                        seed: int, runs: int) -> dict:
    """sparse_intersect_dense (and its keep-misses mode) against its plain
    version at every K the server gave it and at K = 16384 (the JAX
    package's union cap), over n_shards random planes; the record's
    numbers are taken at the largest served K."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    rates = int_rates()
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    dense = torch.randint(-2**31, 2**31, (n_shards, words), dtype=torch.int64,
                          device=device, generator=gen).to(torch.int32)
    dense[:, :64] = -1  # all-ones words: every entry there hits

    def sparse_rows(k: int):
        """[n_shards, k] sorted unique ids, sentinel-padded after dedup;
        the last row sentinel only, the one before it half full."""
        idx = torch.randint(0, SHARD_WIDTH, (n_shards, k), dtype=torch.int32,
                            device=device, generator=gen)
        idx = torch.sort(idx, dim=1).values
        dup = torch.zeros_like(idx, dtype=torch.bool)
        dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
        idx = torch.where(dup, SPARSE_SENTINEL, idx)
        idx[-2, k // 2:] = SPARSE_SENTINEL
        idx[-1] = SPARSE_SENTINEL
        return torch.sort(idx, dim=1).values.contiguous()

    def check(name, got, want):
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(max abs err {err})")
        return err

    # K past each edge of the kernel's work units (warp: 32 x 8 entries;
    # block: thread steps of 256 entries, tiles of 2048), odd K: exact only
    for k in SPARSE_EDGE_K:
        sp = sparse_rows(k)
        for fn, plain in ((kernels.sparse_intersect_dense,
                           kernels.sparse_intersect_dense_plain),
                          (kernels.sparse_difference_dense,
                           kernels.sparse_difference_dense_plain)):
            check(f"{fn.__name__} K={k}", fn(sp, dense), plain(sp, dense))
    log(f"  sparse_intersect_dense K={list(SPARSE_EDGE_K)}: both modes exact")
    out = {}
    for k in sorted(set(served_k) | {16384}):
        sp = sparse_rows(k)
        check(f"sparse_intersect_dense K={k}",
              kernels.sparse_intersect_dense(sp, dense),
              kernels.sparse_intersect_dense_plain(sp, dense))
        check(f"sparse_difference_dense K={k}",
              kernels.sparse_difference_dense(sp, dense),
              kernels.sparse_difference_dense_plain(sp, dense))
        rec = time_three(lambda: kernels.sparse_intersect_dense(sp, dense),
                         runs, "sparse_dense_kernel")
        plain = cuda_ms(
            lambda: kernels.sparse_intersect_dense_plain(sp, dense), 3, 1)
        # each index read once, each slot written once, and the distinct
        # 32-byte plane sectors the entries below the sentinel touch
        live = sp < SPARSE_SENTINEL
        shard = torch.arange(n_shards, device=device,
                             dtype=torch.int64)[:, None].expand_as(sp)
        sector = shard * (words // 8) + (sp.to(torch.int64) >> 8)
        sectors = int(torch.unique(sector[live]).numel())
        entries = n_shards * k
        nbytes = 2 * entries * 4 + 32 * sectors
        b_ms, b_by = bound(nbytes, 8.0 * entries, 1.0 * entries, rates)
        plan = (kernels.sparse_plan(k, n_shards)._asdict()
                if hasattr(kernels, "sparse_plan") else None)
        out[f"K={k}"] = {**rec, "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes_once": nbytes,
                         "sectors": sectors, "plan": plan}
        log(f"  sparse_intersect_dense K={k} S={n_shards}: "
            f"{rec['ms'] * 1e3:.1f} us, device {_us(rec['device_ms'])} us, "
            f"host {_us(rec['host_ms'])} us (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}; {plan}), plain {plain:.2f} ms, both modes exact")
        del sp, shard, sector, live
    del dense
    torch.cuda.empty_cache()
    log(f"  hybrid kernels: {time.perf_counter() - t_phase:.1f} s")
    first = f"K={max(served_k)}"
    return {"sparse_intersect_dense": {**out[first], "max_abs_err": 0,
                                       "shape": first, "all": out}}


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    program_count_kernel<4> (the kernels live in one anonymous namespace:
    _ZN <len> <namespace> <len> <name> [I <args> E] ...)."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    pos = m.end() + int(m.group(1))
    m = re.match(r"(\d+)", mangled[pos:])
    if not m:
        return mangled
    end = pos + m.end() + int(m.group(1))
    name, rest = mangled[pos + m.end():end], mangled[end:]
    args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0]) \
        if rest.startswith("I") else []
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_phase(build) -> dict:
    """Print what ptxas -v reported per kernel (registers, stack frame,
    spills) and whether every program_count instantiation of the classes
    up to depth 4 keeps its stack in registers (0-byte frame, no spills);
    the deepest class keeps a local stack by design."""
    if not hasattr(build, "ptxas_report"):  # an older checkout
        for line in build.build_info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        return {}
    report = {}
    for mangled, r in build.ptxas_report(build.build_log()).items():
        if "registers" in r:
            report[kernel_label(mangled)] = r
    for label, r in sorted(report.items()):
        log(f"  ptxas: {label}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} / "
            f"{r.get('spill_loads')} bytes spill stores / loads")
    shallow = {k: r for k, r in report.items()
               if k.startswith("program_count") and k.endswith(("<2>", "<4>"))}
    ok = bool(shallow) and all(
        r.get("stack") == 0 and r.get("spill_stores") == 0
        and r.get("spill_loads") == 0 for r in shallow.values())
    log(f"  program_count classes up to depth 4 ({len(shallow)} "
        f"instantiations): stack in registers "
        + ("(0-byte frames, no spills)" if ok else "NOT confirmed"))
    return {"kernels": report, "program_count_register_stack": ok}


def kernel_times(device, n_shards: int, words: int, seed: int,
                 runs: int) -> dict:
    """program_count, intersect_count and sparse_intersect_dense alone, at
    the shapes the server phases give them: 8 random planes for the
    programs, the hybrid phase's K for the sparse rows."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    slab = torch.empty((8, n_shards, words), dtype=torch.int32, device=device)
    for r in range(8):
        slab[r] = torch.randint(-2**31, 2**31, (n_shards, words),
                                dtype=torch.int64, device=device,
                                generator=gen).to(torch.int32)
    log("phase 7: program_count and intersect_count")
    out = program_kernel_phase(list(slab.unbind(0)), int_rates(), runs)
    del slab
    torch.cuda.empty_cache()
    log("phase 7: sparse_intersect_dense")
    out.update(hybrid_kernel_phase(device, n_shards, words, SERVED_SPARSE_K,
                                   seed, runs))
    return out


# ----------------------------------------------------------------- server


def _http(uri_port: int, method: str, path: str, body: bytes = b"",
          conn=None):
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("localhost", uri_port, timeout=600)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        payload = json.loads(resp.read() or b"null")
        if resp.status != 200:
            raise AssertionError(f"{method} {path} -> {resp.status}: {payload}")
        return payload
    finally:
        if own:
            conn.close()


def _and_count(*packed: np.ndarray) -> int:
    """Set bits of the AND of packed rows, in 16 MiB slices (no
    full-size temporary)."""
    step = 1 << 24
    buf = np.empty(min(step, packed[0].size), dtype=np.uint8)
    total = 0
    for lo in range(0, packed[0].size, step):
        n = min(step, packed[0].size - lo)
        out = buf[:n]
        np.copyto(out, packed[0][lo:lo + n])
        for x in packed[1:]:
            np.bitwise_and(out, x[lo:lo + n], out=out)
        total += _popcount(out)
    return total


def _popcount(packed: np.ndarray) -> int:
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(packed).sum(dtype=np.int64))
    table = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
    return int(table[packed].sum())


def make_rows(n_rows: int, n_shards: int, seed: int) -> list[np.ndarray]:
    """Per row, sorted unique global columns with 8.5k-40k bits per shard
    (after dedup at least 8k: every row stays above the JAX planner's
    4096-bit sparse threshold, so its leaves are dense planes)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        cards = rng.integers(8500, 40001, size=n_shards)
        shard_of = np.repeat(np.arange(n_shards, dtype=np.int64), cards)
        cols = shard_of * SHARD_WIDTH + rng.integers(
            0, SHARD_WIDTH, size=int(cards.sum()))
        cols.sort()
        keep = np.concatenate(([True], cols[1:] != cols[:-1]))
        rows.append(cols[keep])
    return rows


def shard_major(rows: list, n_shards: int) -> tuple:
    """(row ids, columns) of sorted per-row column arrays, ordered by shard
    and then by row: one import call whose shard grouping is a no-op
    sort, and one snapshot per fragment."""
    edges = np.arange(n_shards + 1, dtype=np.int64) * SHARD_WIDTH
    bounds = [np.searchsorted(r, edges) for r in rows]
    ids, cols = [], []
    for s in range(n_shards):
        for i, r in enumerate(rows):
            seg = r[bounds[i][s]:bounds[i][s + 1]]
            ids.append(np.full(seg.size, i, dtype=np.int64))
            cols.append(seg)
    return np.concatenate(ids), np.concatenate(cols)


def packed_row(cols: np.ndarray, n_shards: int) -> np.ndarray:
    bits = np.zeros(n_shards * SHARD_WIDTH, dtype=bool)
    bits[cols] = True
    return np.packbits(bits, bitorder="little")


def _bit_test(packed: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Whether each global column is set in a little-endian packed row."""
    return ((packed[cols >> 3] >> (cols & 7).astype(np.uint8)) & 1).astype(bool)


def make_values(n_shards: int, per_shard: int, seed: int):
    """(sorted global columns, values): per_shard distinct random columns
    in every shard, values uniform in 0..1023."""
    rng = np.random.default_rng(seed + 7)
    offs = np.stack([rng.choice(SHARD_WIDTH, size=per_shard, replace=False)
                     for _ in range(n_shards)])
    offs.sort(axis=1)
    cols = (np.arange(n_shards, dtype=np.int64)[:, None] * SHARD_WIDTH
            + offs).reshape(-1)
    vals = rng.integers(0, 1 << BSI_DEPTH, size=cols.size, dtype=np.int64)
    return cols, vals


def last_wins(cols: np.ndarray, vals: np.ndarray) -> tuple:
    """Sorted unique columns with the last value written to each."""
    order = np.argsort(cols, kind="stable")
    cols, vals = cols[order], vals[order]
    last = np.concatenate([cols[1:] != cols[:-1], [True]])
    return cols[last], vals[last]


def bsi_phase(srv, port: int, packed: list, exists: np.ndarray,
              n_shards: int, per_shard: int, seed: int, clients: int,
              per_client: int) -> dict:
    """The BSI path on the Count phase's server and index; its own launch
    counts (zeroed before its first query, read after its last)."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    cols, vals = make_values(n_shards, per_shard, seed)
    log(f"  bsi data: {cols.size} values over {n_shards} shards "
        f"({per_shard} columns per shard, reduced from {SHARD_WIDTH}) "
        f"({time.perf_counter() - t0:.1f} s)")
    _http(port, "POST", "/index/i/field/v", json.dumps(
        {"options": {"type": "int", "min": 0,
                     "max": (1 << BSI_DEPTH) - 1}}).encode())
    t0 = time.perf_counter()
    srv.api.import_values("i", "v", cols, vals)
    rng = np.random.default_rng(seed + 8)
    n_total = n_shards * SHARD_WIDTH
    json_cols = np.concatenate([rng.choice(cols, size=500, replace=False),
                                rng.integers(0, n_total, size=500)])
    json_vals = rng.integers(0, 1 << BSI_DEPTH, size=json_cols.size)
    _http(port, "POST", "/index/i/field/v/import", json.dumps(
        {"columnIDs": json_cols.tolist(),
         "values": json_vals.tolist()}).encode())
    set_cols = np.array([int(cols[0]), int(cols[-1]), 3, n_total - 1],
                        dtype=np.int64)
    set_vals = np.array([1023, 0, 7, 512], dtype=np.int64)
    for c, x in zip(set_cols.tolist(), set_vals.tolist()):
        _http(port, "POST", "/index/i/query", f"Set({c}, v={x})".encode())
    import_s = time.perf_counter() - t0
    log(f"  bsi import: {import_s:.1f} s")
    cols, vals = last_wins(np.concatenate([cols, json_cols, set_cols]),
                           np.concatenate([vals, json_vals, set_vals]))
    hist = np.bincount(vals, minlength=1 << BSI_DEPTH).astype(np.int64)
    wsum = hist * np.arange(hist.size, dtype=np.int64)
    in_f1 = _bit_test(packed[1], cols)
    in_f0 = _bit_test(packed[0], cols)
    n_exists = _popcount(exists) + int((~_bit_test(exists, cols)).sum())

    def vc(sel) -> dict:
        return {"value": int(vals[sel].sum()), "count": int(sel.sum())}

    def extreme(sel, fn) -> dict:
        if not sel.any():
            return {"value": 0, "count": 0}
        x = int(fn(vals[sel]))
        return {"value": x, "count": int((vals[sel] == x).sum())}

    def query(pql: str, path: str = "/index/i/query"):
        return _http(port, "POST", path, pql.encode())["results"][0]

    start_window()  # the BSI path starts here
    t0 = time.perf_counter()
    got = query("Sum(field=v)")
    cold_ms = (time.perf_counter() - t0) * 1e3
    if got != vc(np.ones(vals.size, bool)):
        raise AssertionError(f"Sum(field=v): port {got}")
    log(f"  cold Sum(field=v) (plane slab built from the fragments): "
        f"{cold_ms:.1f} ms")
    everything = np.ones(vals.size, bool)
    checks = [
        ("Sum(field=v)", vc(everything)),
        ("Sum(Range(v > 511), field=v)",
         {"value": int(wsum[512:].sum()), "count": int(hist[512:].sum())}),
        ("Sum(Row(f=1), field=v)", vc(in_f1)),
        ("Min(field=v)", extreme(everything, np.min)),
        ("Max(field=v)", extreme(everything, np.max)),
        ("Min(Row(f=1), field=v)", extreme(in_f1, np.min)),
        ("Max(Intersect(Row(f=0), Row(f=1)), field=v)",
         extreme(in_f0 & in_f1, np.max)),
        ("Count(Range(v >< [100, 200]))", int(hist[100:201].sum())),
        ("Count(Intersect(Row(f=0), Range(v < 300)))",
         int((in_f0 & (vals < 300)).sum())),
        ("Count(Range(v != null))", int(vals.size)),
        ("Count(Not(Range(v == 7)))", n_exists - int(hist[7])),
        ("Count(Range(v > 5000))", 0),
    ]
    t0 = time.perf_counter()
    for pql, want in checks:
        got = query(pql)
        if got != want:
            raise AssertionError(f"{pql}: port {got} != oracle {want}")
        log(f"  {pql} = {got} (oracle agrees)")
    sub = [s for s in (0, 1) if s < n_shards]
    got = query("Range(v == 7)", "/index/i/query?shards="
                + ",".join(map(str, sub)))
    want_cols = cols[(vals == 7) & (cols < (max(sub) + 1) * SHARD_WIDTH)]
    if got["columns"] != want_cols.tolist():
        raise AssertionError("Range(v == 7) ?shards=0,1 differs from the "
                             "oracle")
    log(f"  Range(v == 7) ?shards={sub}: {want_cols.size} columns "
        "(oracle agrees)")
    single_s = time.perf_counter() - t0

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for i in range(per_client):
                x = 128 + 8 * ((cid * per_client + i) % 96)
                q = f"Sum(Range(v > {x}), field=v)"
                t = time.perf_counter()
                got = _http(port, "POST", "/index/i/query", q.encode(),
                            conn)["results"][0]
                dt = time.perf_counter() - t
                want = {"value": int(wsum[x + 1:].sum()),
                        "count": int(hist[x + 1:].sum())}
                with lock:
                    lat.append(dt)
                    if got != want:
                        errors.append((q, got, want))
        finally:
            conn.close()

    batcher = srv.executor.sum_batcher
    before = batcher.snapshot()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    obs = during_pass(port, ("Sum(Range(v > 300), field=v)",
                             "PlaneSumBatcher"), SHORT_CAPTURE_S)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        raise AssertionError(
            f"{len(errors)} concurrent Sums differ, "
            f"{clients * per_client - len(lat)} missing; first {errors[:1]}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the BSI path ends here
    forms = kernels.form_launch_counts()
    obs["scrape"] = observe_path(port, "bsi", launches)
    after = batcher.snapshot()
    res = srv.executor.residency.snapshot()
    stats = {
        "queries": len(lat), "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "max_batch_seen": after["max_batch_seen"],
        "batches": after["batches"] - before["batches"],
        "batched_queries": after["batched_queries"]
        - before["batched_queries"],
        "values": int(vals.size), "per_shard": per_shard,
        "import_s": import_s, "cold_slab_query_ms": cold_ms,
        "single_queries_s": single_s, "resident_bytes": res["bytes"],
        "resident_entries": res["entries"],
    }
    log(f"  concurrent: {clients} clients x {per_client} Sum(Range(v > x), "
        f"field=v), plan cache off: {stats['qps']:.1f} q/s, p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, "
        f"max_batch_seen {stats['max_batch_seen']} ({stats['batches']} "
        "batches)")
    log(f"  resident leaves: {res['entries']} entries, {res['bytes']} bytes")
    log(f"  launches on the BSI path: {launches}; by form: {forms}")
    for name in BSI_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the BSI path")
    if stats["max_batch_seen"] < 2:
        raise AssertionError("the PlaneSumBatcher never coalesced")
    return ({"launches": launches, "forms": forms, "stats": stats,
             "obs": obs}, (cols, vals))


def make_topn_rows(n_shards: int, top_bits: int, seed: int) -> list:
    """Sorted unique global columns of the TOPN_ROWS rows of t: row r with
    about top_bits / (r + 1) random bits per shard."""
    rng = np.random.default_rng(seed + 11)
    rows = []
    for r in range(TOPN_ROWS):
        card = max(top_bits // (r + 1), 1)
        cols = (np.repeat(np.arange(n_shards, dtype=np.int64), card)
                * SHARD_WIDTH
                + rng.integers(0, SHARD_WIDTH, size=card * n_shards))
        cols.sort()
        rows.append(cols[np.concatenate(([True], cols[1:] != cols[:-1]))])
    return rows


def _pairs(counts, ids=None) -> list:
    """TopN JSON of {row: count}: count desc, id asc, zeros dropped."""
    ids = range(len(counts)) if ids is None else ids
    got = sorted(((int(counts[i]), int(i)) for i in ids if counts[i] > 0),
                 key=lambda x: (-x[0], x[1]))
    return [{"id": i, "count": c} for c, i in got]


def _groups(names: list, counts: dict) -> list:
    """GroupBy JSON of {(row, ...): count}, lexicographic, zeros dropped."""
    return [{"group": [{"field": f, "rowID": int(r)}
                       for f, r in zip(names, key)], "count": int(c)}
            for key, c in sorted(counts.items()) if c > 0]


def topn_phase(srv, port: int, packed: list, values: tuple, rows: list,
               n_shards: int, seed: int, clients: int,
               per_client: int) -> dict:
    """TopN, Rows and GroupBy on the Count phase's server and index; its
    own launch counts (zeroed before its first query, read after its
    last). packed = the packed rows of f; values = (columns, values) of
    the int field v; rows = the columns of t's rows (make_topn_rows)."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    _http(port, "POST", "/index/i/field/t",
          json.dumps({"options": {"cacheType": "ranked"}}).encode())
    t0 = time.perf_counter()
    srv.api.import_bits("i", "t", *shard_major(rows, n_shards))
    rng = np.random.default_rng(seed + 12)
    n_total = n_shards * SHARD_WIDTH
    extra = _unique(rng.integers(0, n_total, size=5000))
    _http(port, "POST", "/index/i/field/t/import", json.dumps(
        {"rowIDs": [TOPN_ROWS - 1] * extra.size,
         "columnIDs": extra.tolist()}).encode())
    rows[-1] = _union(rows[-1], extra)
    # single bits: row 40 gains four columns of shard 0, row 0 loses one
    gain = _setdiff(np.arange(100, 1100, 250), rows[40])[:4]
    for c in gain.tolist():
        _http(port, "POST", "/index/i/query", f"Set({c}, t=40)".encode())
    lose = int(rows[0][0])
    _http(port, "POST", "/index/i/query", f"Clear({lose}, t=0)".encode())
    rows[40] = _union(rows[40], gain)
    rows[0] = rows[0][1:]
    import_s = time.perf_counter() - t0
    log(f"  topn import: {import_s:.1f} s")
    view = srv.holder.index("i").field("t").view("standard")
    frag0, cache0 = view.fragment(0), view.rank_caches[0]
    for r in (0, 40):
        want = int((rows[r] < SHARD_WIDTH).sum())
        if cache0.counts.get(r) != want or frag0.row_count(r) != want:
            raise AssertionError(f"rank cache of shard 0 row {r}: "
                                 f"{cache0.counts.get(r)} != {want}")
    log("  Set/Clear moved the rank cache of shard 0 (rows 0 and 40)")

    t0 = time.perf_counter()
    sizes = np.array([r.size for r in rows], dtype=np.int64)
    inter = np.array([[int(_bit_test(packed[a], rows[r]).sum())
                       for r in range(TOPN_ROWS)] for a in range(len(packed))])
    vcols, vvals = values
    packed_v = packed_row(vcols[vvals > 500], n_shards)
    log(f"  topn oracle: {time.perf_counter() - t0:.1f} s")

    def query(pql: str):
        return _http(port, "POST", "/index/i/query", pql.encode())["results"][0]

    def timed(pql: str, want, what: str) -> float:
        t = time.perf_counter()
        got = query(pql)
        ms = (time.perf_counter() - t) * 1e3
        if got != want:
            raise AssertionError(f"{pql}: port {str(got)[:300]} != oracle "
                                 f"{str(want)[:300]}")
        log(f"  {what}{pql[:100]}: {ms:.1f} ms (oracle agrees)")
        return ms

    start_window()  # the TopN/GroupBy path starts here
    times = {
        "topn_cache_cold_ms": timed("TopN(t, n=10)", _pairs(sizes)[:10],
                                    "cold "),
        "topn_src_cold_ms": timed("TopN(t, Row(f=0), n=10)",
                                  _pairs(inter[0])[:10], "cold "),
        "topn_src_warm_ms": timed("TopN(t, Row(f=0), n=10)",
                                  _pairs(inter[0])[:10], "warm "),
    }
    fxt = {(a, r): inter[a, r] for a in range(len(packed))
           for r in range(TOPN_ROWS)}
    names = ["f", "t"]
    times["groupby_cold_ms"] = timed("GroupBy(Rows(field=f), Rows(field=t))",
                                     _groups(names, fxt), "cold ")
    times["groupby_warm_ms"] = timed("GroupBy(Rows(field=f), Rows(field=t))",
                                     _groups(names, fxt), "warm ")

    # Tanimoto against row 5 itself: only rows near |t_5| are recounted
    packed5 = packed_row(rows[5], n_shards)
    with5 = np.array([int(_bit_test(packed5, rows[r]).sum())
                      for r in range(TOPN_ROWS)])
    union = sizes + sizes[5] - with5
    tani = np.where(100 * with5 > 50 * union, with5, 0)
    band = (sizes > sizes[5] * 0.5) & (sizes < sizes[5] * 2)
    tani = np.where(band, tani, 0)
    x = int(np.sort(inter[1])[TOPN_ROWS // 2])  # a threshold mid-way
    thr = np.where(inter[1] >= x, inter[1], 0)
    ids = [0, 5, 17, TOPN_ROWS - 1, 99]
    probe = int(rows[3][len(rows[3]) // 2])
    with_col = [r for r in range(TOPN_ROWS)
                if np.searchsorted(rows[r], probe) < rows[r].size
                and rows[r][np.searchsorted(rows[r], probe)] == probe]
    filt = {}
    for r in range(TOPN_ROWS):
        sel = rows[r][_bit_test(packed_v, rows[r])]
        for a in range(len(packed)):
            filt[(a, r)] = int(_bit_test(packed[a], sel).sum())
    three = {}
    for r in range(3):
        for a in range(2):
            in_a = _bit_test(packed[a], rows[r])
            for b in (6, 7):
                three[(a, r, b)] = int((in_a & _bit_test(packed[b],
                                                         rows[r])).sum())
    checks = [
        ("TopN(t, n=0)", _pairs(sizes)),
        ("TopN(t, Row(t=5), n=5, tanimotoThreshold=50)", _pairs(tani)[:5]),
        (f"TopN(t, Row(f=1), threshold={x}, n=10)", _pairs(thr)[:10]),
        ("TopN(t, Row(f=2), ids=[" + ", ".join(map(str, ids)) + "])",
         _pairs(np.append(inter[2], [0] * (100 - TOPN_ROWS)), ids)),
        ("Rows(field=t)", {"rows": list(range(TOPN_ROWS))}),
        ("Rows(field=t, limit=5, previous=3)", {"rows": [4, 5, 6, 7, 8]}),
        (f"Rows(field=t, column={probe})", {"rows": with_col}),
        ("GroupBy(Rows(field=f), Rows(field=t), limit=20)",
         _groups(names, fxt)[:20]),
        ("GroupBy(Rows(field=f), Rows(field=t), filter=Range(v > 500))",
         _groups(names, filt)),
        ("GroupBy(Rows(field=f, limit=2), Rows(field=t, limit=3), "
         "Rows(field=f, previous=5), limit=7)",
         _groups(["f", "t", "f"], three)[:7]),
    ]
    for a in range(1, len(packed)):
        checks.append((f"TopN(t, Row(f={a}), n=10)", _pairs(inter[a])[:10]))
    t0 = time.perf_counter()
    for pql, want in checks:
        timed(pql, want, "")
    single_s = time.perf_counter() - t0

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for i in range(per_client):
                a = (cid + i) % len(packed)
                q = f"TopN(t, Row(f={a}), n=10)"
                t = time.perf_counter()
                got = _http(port, "POST", "/index/i/query", q.encode(),
                            conn)["results"][0]
                dt = time.perf_counter() - t
                with lock:
                    lat.append(dt)
                    if got != _pairs(inter[a])[:10]:
                        errors.append((q, got))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    obs = during_pass(port, ("TopN(t, Row(f=1), n=10)", None),
                      TOPN_CAPTURE_S)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        raise AssertionError(
            f"{len(errors)} concurrent TopNs differ, "
            f"{clients * per_client - len(lat)} missing; first {errors[:1]}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the TopN/GroupBy path ends here
    obs["scrape"] = observe_path(port, "topn", launches)
    res = srv.executor.residency.snapshot()
    stats = {
        "queries": len(lat), "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "bits": int(sizes.sum()), "import_s": import_s,
        "single_queries_s": single_s, **times,
        "topn_recount_rows": srv.executor.topn_recount_rows,
        "groupby_host_syncs": srv.executor.groupby_host_syncs,
        "resident_bytes": res["bytes"], "resident_entries": res["entries"],
        "evictions": res["evictions"],
    }
    log(f"  concurrent: {clients} clients x {per_client} TopN(t, Row(f=a), "
        f"n=10), plan cache off: {stats['qps']:.1f} q/s, p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms")
    log(f"  resident leaves: {res['entries']} entries, {res['bytes']} bytes, "
        f"{res['evictions']} evictions")
    log(f"  launches on the TopN/GroupBy path: {launches}")
    for name in TOPN_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the TopN/GroupBy "
                                 "path")
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["cleared_t0_column"] = lose
    log(f"  TopN/GroupBy phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats, "obs": obs}


def make_hybrid_rows(n_shards: int, seed: int) -> tuple:
    """(s rows, r rows): sorted unique global columns. Row a of s holds
    min(4096, 8 * 2^(a mod 10)) random bits in every shard (after dedup a
    few fewer), so it plans sparse with K = 8..4096; each row of r holds
    2-16 intervals per shard totalling 5000-8000 bits (over the sparse
    threshold, far under 2048 intervals), so it plans run. Interval i of a
    shard starts at a distinct multiple of 8192 and is at most 8000 long:
    the intervals are disjoint and never adjacent."""
    rng = np.random.default_rng(seed + 21)
    shard_base = np.arange(n_shards, dtype=np.int64) * SHARD_WIDTH
    s_rows = []
    for a in range(HYBRID_S_ROWS):
        card = min(4096, 8 << (a % 10))
        cols = (np.repeat(shard_base, card)
                + rng.integers(0, SHARD_WIDTH, size=card * n_shards))
        cols.sort()
        s_rows.append(cols[np.concatenate(([True], cols[1:] != cols[:-1]))])
    r_rows = []
    slots = SHARD_WIDTH // 8192
    for _ in range(HYBRID_R_ROWS):
        parts = []
        for base in shard_base.tolist():
            n_iv = int(rng.integers(2, 17))
            total = int(rng.integers(5000, 8001))
            cuts = np.sort(rng.choice(np.arange(1, total), size=n_iv - 1,
                                      replace=False))
            lengths = np.diff(np.concatenate(([0], cuts, [total])))
            starts = np.sort(rng.choice(slots, size=n_iv,
                                        replace=False)) * 8192 + base
            parts += [np.arange(st, st + ln, dtype=np.int64)
                      for st, ln in zip(starts.tolist(), lengths.tolist())]
        r_rows.append(np.concatenate(parts))
    return s_rows, r_rows


def _unique(a) -> np.ndarray:
    """np.unique(a) by a sort and a mask. NumPy 2.3's np.unique hashes
    integer arrays: on the card's host it took about 40 s for the 25M
    columns of one row, where a sort takes under a second."""
    a = np.sort(np.asarray(a), axis=None)
    if a.size:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


def _union(a, b) -> np.ndarray:
    """np.union1d(a, b), as _unique does it."""
    return _unique(np.concatenate((np.ravel(a), np.ravel(b))))


def _setdiff(a, b) -> np.ndarray:
    """np.setdiff1d(a, b), as _unique does it."""
    a, b = _unique(a), _unique(b)
    return a[~_contains(b, a)] if b.size else a


def _contains(sorted_cols: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Whether each of cols lies in the sorted array sorted_cols."""
    i = np.searchsorted(sorted_cols, cols)
    i_c = np.minimum(i, max(sorted_cols.size - 1, 0))
    return (i < sorted_cols.size) & (sorted_cols[i_c] == cols)


def load_hybrid_fields(srv, port: int, n_shards: int, seed: int) -> tuple:
    """Create the set fields s and r and import make_hybrid_rows' rows ->
    (s rows, r rows, import seconds)."""
    t0 = time.perf_counter()
    s_rows, r_rows = make_hybrid_rows(n_shards, seed)
    log(f"  hybrid data: {HYBRID_S_ROWS} rows of s, "
        f"{sum(r.size for r in s_rows)} bits; {HYBRID_R_ROWS} rows of r, "
        f"{sum(r.size for r in r_rows)} bits "
        f"({time.perf_counter() - t0:.1f} s)")
    # no rank caches: no query ranks s or r, and the import skips the
    # per-shard cache rebuild
    for name in ("s", "r"):
        _http(port, "POST", f"/index/i/field/{name}",
              json.dumps({"options": {"cacheType": "none"}}).encode())
    t0 = time.perf_counter()
    srv.api.import_bits("i", "s", *shard_major(s_rows, n_shards))
    srv.api.import_bits("i", "r", *shard_major(r_rows, n_shards))
    import_s = time.perf_counter() - t0
    log(f"  hybrid import: {import_s:.1f} s")
    return s_rows, r_rows, import_s


def hybrid_phase(srv, port: int, packed: list, exists: np.ndarray,
                 values: tuple, t_rows: list, t_cleared: int,
                 n_shards: int, seed: int, clients: int,
                 per_client: int) -> dict:
    """Sparse and run leaves on the Count phase's server and index: a
    stargazer-like set field s and a run field r, checked against a numpy
    oracle, then clients x per_client Count(Intersect(Row(s=a), Row(f=b)));
    its own launch counts (zeroed before its first query, read after its
    last). packed = the packed rows of f; exists = their union; values =
    (columns, values) of v; t_rows = the columns of t's rows and
    t_cleared the column cleared from t's row 0 (still existent)."""
    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel.residency import HybridManager

    t_phase = time.perf_counter()
    s_rows, r_rows, import_s = load_hybrid_fields(srv, port, n_shards, seed)

    t0 = time.perf_counter()
    vcols, vvals = values
    bits = np.zeros(n_shards * SHARD_WIDTH, dtype=bool)
    for cols in [vcols, *t_rows, [t_cleared], *s_rows, *r_rows]:
        bits[cols] = True
    exists_all = np.packbits(bits, bitorder="little") | exists
    del bits
    n_exists = _popcount(exists_all)
    packed_r = [packed_row(c, n_shards) for c in r_rows[:2]]
    packed_v500 = packed_row(vcols[vvals > 500], n_shards)
    pair = np.array([[int(_bit_test(packed[b], s_rows[a]).sum())
                      for b in range(len(packed))]
                     for a in range(HYBRID_S_ROWS)])
    log(f"  hybrid oracle: {time.perf_counter() - t0:.1f} s")

    def query(pql: str):
        return _http(port, "POST", "/index/i/query", pql.encode())["results"][0]

    def inter(a_cols: np.ndarray, b_cols: np.ndarray) -> int:
        return int(_contains(b_cols, a_cols).sum())

    a, c, b = 3, 7, 1  # s rows of 64 and 1024 bits per shard, f row 1
    in_v = _contains(s_rows[5], vcols)
    packed_s5 = packed_row(s_rows[5], n_shards)
    tcounts = np.array([int(_bit_test(packed_s5, rows).sum())
                        for rows in t_rows])
    want_cols = s_rows[a][_bit_test(packed[b], s_rows[a])]
    checks = [
        (f"Count(Intersect(Row(s={a}), Row(f={b})))", int(pair[a, b])),
        (f"Count(Intersect(Row(f={b}), Row(s={a})))", int(pair[a, b])),
        (f"Intersect(Row(s={a}), Row(f={b}))",
         {"attrs": {}, "columns": want_cols.tolist()}),
        (f"Count(Intersect(Row(s={a}), Row(s={c})))",
         inter(s_rows[a], s_rows[c])),
        (f"Count(Union(Row(s={a}), Row(s={c})))",
         int(_union(s_rows[a], s_rows[c]).size)),
        (f"Count(Xor(Row(s={a}), Row(s={c})))",
         int(np.setxor1d(s_rows[a], s_rows[c], assume_unique=True).size)),
        (f"Count(Difference(Row(s=9), Row(f={b})))",
         int(s_rows[9].size - pair[9, b])),
        (f"Count(Not(Row(s={c})))", n_exists - int(s_rows[c].size)),
        (f"Count(Intersect(Row(s=9), Row(r=0)))", inter(s_rows[9], r_rows[0])),
        (f"Count(Intersect(Row(r=0), Row(f={b})))",
         int(_bit_test(packed[b], r_rows[0]).sum())),
        ("Count(Intersect(Row(r=0), Row(r=1)))",
         int(_bit_test(packed_r[1], r_rows[0]).sum())),
        ("Count(Row(r=2))", int(r_rows[2].size)),
        ("Count(Intersect(Row(s=9), Range(v > 500)))",
         int(_bit_test(packed_v500, s_rows[9]).sum())),
        ("Sum(Row(s=5), field=v)",
         {"value": int(vvals[in_v].sum()), "count": int(in_v.sum())}),
        ("TopN(t, Row(s=5), n=5)", _pairs(tcounts)[:5]),
    ]
    start_window()  # the hybrid path starts here
    t0 = time.perf_counter()
    got = query("Count(Row(s=9))")
    cold_ms = (time.perf_counter() - t0) * 1e3
    if got != int(s_rows[9].size):
        raise AssertionError(f"Count(Row(s=9)): port {got} != oracle "
                             f"{s_rows[9].size}")
    log(f"  cold Count(Row(s=9)) (one sparse leaf, K = 4096, built from "
        f"{n_shards} fragments): {cold_ms:.1f} ms (oracle agrees)")
    t0 = time.perf_counter()
    for pql, want in checks:
        got = query(pql)
        if got != want:
            raise AssertionError(f"{pql}: port {str(got)[:300]} != oracle "
                                 f"{str(want)[:300]}")
        log(f"  {pql[:100]} = {str(got)[:60]} (oracle agrees)")
    single_s = time.perf_counter() - t0
    # every row of s once, so the concurrent pass runs on resident leaves
    # (a burst of cold misses would build each leaf once per thread)
    t0 = time.perf_counter()
    for sa in range(HYBRID_S_ROWS):
        got = query(f"Count(Row(s={sa}))")
        if got != int(s_rows[sa].size):
            raise AssertionError(f"Count(Row(s={sa})): port {got} != oracle "
                                 f"{s_rows[sa].size}")
    warm_s = time.perf_counter() - t0
    log(f"  Count(Row(s=a)) for all {HYBRID_S_ROWS} rows (the leaves not yet "
        f"resident built from the host): {warm_s:.1f} s (oracle agrees)")

    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        rng = np.random.default_rng(seed + 3000 + cid)
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for _ in range(per_client):
                sa = int(rng.integers(HYBRID_S_ROWS))
                fb = int(rng.integers(len(packed)))
                q = f"Count(Intersect(Row(s={sa}), Row(f={fb})))"
                t = time.perf_counter()
                got = _http(port, "POST", "/index/i/query", q.encode(),
                            conn)["results"][0]
                dt = time.perf_counter() - t
                with lock:
                    lat.append(dt)
                    if got != int(pair[sa, fb]):
                        errors.append((q, got, int(pair[sa, fb])))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    obs = during_pass(port, ("Count(Intersect(Row(s=3), Row(f=1)))", None),
                      SHORT_CAPTURE_S)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * per_client:
        raise AssertionError(
            f"{len(errors)} concurrent hybrid Counts differ, "
            f"{clients * per_client - len(lat)} missing; first {errors[:1]}")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the hybrid path ends here
    obs["scrape"] = observe_path(port, "hybrid", launches)
    hyb = srv.executor.hybrid_snapshot()
    dense_equiv = HYBRID_S_ROWS * n_shards * SHARD_WIDTH // 8
    # the K of each row of s: its largest shard, padded as the chooser pads
    served_k = sorted({HybridManager.pad_slots(int(np.bincount(
        r // SHARD_WIDTH, minlength=n_shards).max())) for r in s_rows})
    stats = {
        "queries": len(lat), "qps": len(lat) / wall,
        "p50_ms": statistics.median(lat) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "s_bits": int(sum(r.size for r in s_rows)),
        "r_bits": int(sum(r.size for r in r_rows)),
        "import_s": import_s, "cold_sparse_leaf_ms": cold_ms,
        "single_queries_s": single_s, "warm_s_rows_s": warm_s,
        "hybrid": hyb,
        "s_rows_as_dense_bytes": dense_equiv, "served_k": served_k,
    }
    log(f"  concurrent: {clients} clients x {per_client} Count(Intersect("
        f"Row(s=a), Row(f=b))), plan cache off: {stats['qps']:.1f} q/s, p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms")
    log(f"  resident by form: sparse {hyb['residentSparseLeaves']} leaves, "
        f"{hyb['residentSparseBytes']} bytes (the {HYBRID_S_ROWS} rows of s "
        f"as planes: {dense_equiv} bytes); run {hyb['residentRunLeaves']} "
        f"leaves, {hyb['residentRunBytes']} bytes; dense "
        f"{hyb['residentDenseRowLeaves']} leaves, {hyb['residentDenseRowBytes']} "
        f"bytes")
    log(f"  hybrid uploads: sparse {hyb['sparseUploads']}, run "
        f"{hyb['runUploads']}, dense {hyb['denseUploads']}; expanded on the "
        f"device {hyb['materialized']}")
    log(f"  launches on the hybrid path: {launches}")
    if launches["sparse_intersect_dense"] < 1:
        raise AssertionError("sparse_intersect_dense never launched on the "
                             "hybrid path")
    if hyb["sparseUploads"] < 1 or hyb["runUploads"] < 1:
        raise AssertionError(f"no sparse or no run upload: {hyb}")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  hybrid phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats, "obs": obs,
            "data": (exists_all, s_rows, r_rows)}


def make_ingest_ops(n_shards: int, seed: int, writers: int, n_env: int,
                    calls: int, targets: list) -> list:
    """Per writer, n_env envelopes of `calls` (is_set, field, row, col)
    ops: 80 % Set of a random column of its own (col % writers ==
    writer) over all shards on a random target row, 20 % Clear of a
    (row, column) it set earlier (bench.py:1888-1897)."""
    n_cols = n_shards * SHARD_WIDTH
    out = []
    for w in range(writers):
        rng = np.random.default_rng(seed + 5000 + w)
        n = n_env * calls
        is_set = (rng.random(n) >= 0.2).tolist()
        tgt = rng.integers(len(targets), size=n).tolist()
        cols = (rng.integers(n_cols // writers, size=n) * writers
                + w).tolist()
        pick = rng.random(n).tolist()
        ops, done = [], []
        for k in range(n):
            if is_set[k] or not done:
                f, r = targets[tgt[k]]
                ops.append((True, f, r, cols[k]))
                done.append((f, r, cols[k]))
            else:
                f, r, c = done[int(pick[k] * len(done))]
                ops.append((False, f, r, c))
        out.append([ops[e * calls:(e + 1) * calls] for e in range(n_env)])
    return out


def envelope_pql(ops: list) -> bytes:
    return "".join(f"{'Set' if s else 'Clear'}({c}, {f}={r})"
                   for s, f, r, c in ops).encode()


class WriteOracle:
    """The bits the writers leave, updated in each writer's own order:
    columns are disjoint per writer, so the final state and every changed
    flag are exact whatever the interleaving."""

    def __init__(self, packed_f: list, exists: np.ndarray, sorted_rows: dict):
        self.packed_f = packed_f        # f row -> packed bits (updated)
        self.exists = exists            # packed existence (updated)
        self.base = sorted_rows         # (field, row) -> sorted columns
        self.rows = dict(sorted_rows)   # (field, row) -> current columns
        self.state: dict = {}           # (field, row, col) -> bit

    def _base_bits(self, keys: list) -> list:
        by_row: dict = {}
        for i, (f, r, c) in enumerate(keys):
            by_row.setdefault((f, r), []).append((i, c))
        out = [False] * len(keys)
        for (f, r), items in by_row.items():
            cols = np.array([c for _, c in items], dtype=np.int64)
            hit = (_bit_test(self.packed_f[r], cols) if f == "f"
                   else _contains(self.base[(f, r)], cols))
            for (i, _), h in zip(items, hit.tolist()):
                out[i] = h
        return out

    def flags(self, ops: list) -> list:
        """Each op's changed flag, in order; records the new state."""
        new = list({(f, r, c) for _, f, r, c in ops} - self.state.keys())
        self.state.update(zip(new, self._base_bits(new)))
        out = []
        for is_set, f, r, c in ops:
            key = (f, r, c)
            out.append(self.state[key] != is_set)
            self.state[key] = is_set
        return out

    def settle(self, set_cols: list) -> None:
        """Fold the state flags() recorded so far into the rows; set_cols:
        every column a Set named since the last settle (existence is never
        cleared)."""
        on: dict = {}
        off: dict = {}
        for (f, r, c), bit in self.state.items():
            (on if bit else off).setdefault((f, r), []).append(c)
        for key in set(on) | set(off):
            f, r = key
            a = np.array(on.get(key, []), dtype=np.int64)
            b = np.array(off.get(key, []), dtype=np.int64)
            if f == "f":
                p = self.packed_f[r]
                np.bitwise_or.at(p, a >> 3,
                                 np.left_shift(1, a & 7).astype(np.uint8))
                np.bitwise_and.at(p, b >> 3, ~np.left_shift(
                    1, b & 7).astype(np.uint8))
            else:
                self.rows[key] = _union(
                    _setdiff(self.base[key], b), a)
        if set_cols:
            c = np.asarray(set_cols, dtype=np.int64)
            np.bitwise_or.at(self.exists, c >> 3,
                             np.left_shift(1, c & 7).astype(np.uint8))

    def count(self, field: str, row: int) -> int:
        if field == "f":
            return _popcount(self.packed_f[row])
        return int(self.rows[(field, row)].size)


def _percentiles(lat: list) -> tuple:
    return (statistics.median(lat) * 1e3,
            float(np.percentile(lat, 99)) * 1e3)


def ingest_phase(srv, port: int, packed: list, exists: np.ndarray,
                 s_rows: list, r_rows: list, n_shards: int, seed: int,
                 writers: int, envelopes: int, calls: int, readers: int,
                 turn_envelopes: int, pair: np.ndarray = None) -> dict:
    """The coalesced write path on the earlier phases' server and index:
    `writers` keep-alive writers send `envelopes` envelopes of `calls`
    Set/Clear each (80/20) on f rows 0-7 (dense), the s rows
    INGEST_S_ROWS (sparse) and r row 0 (run), all resident, while
    `readers` clients run Count(Intersect(Row(f=a), Row(f=b))); then exact
    read-backs against the numpy oracle, and the first Count(Intersect)
    after a burst with ingest on, then off (PILOSA_TPU_TORCH_INGEST=0).
    Its own launch counts (zeroed before its first query). packed =
    the packed rows of f; exists = the packed existence row; s_rows /
    r_rows = the columns of s's and r's rows; pair = the Count path's
    pair oracle of f (f is as it was then), computed when not given."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    ex = srv.executor
    n_f = len(packed)
    # the interpreter's collector pauses, by generation, over the phase
    gc_pause = {0: 0.0, 1: 0.0, 2: 0.0}
    gc_t0: list = [0.0]

    def gc_watch(phase: str, info: dict) -> None:
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_pause[info["generation"]] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(gc_watch)
    targets = ([("f", a) for a in range(n_f)]
               + [("s", a) for a in INGEST_S_ROWS] + [("r", 0)])
    t0 = time.perf_counter()
    n_env = envelopes + len(INGEST_TURNS) * turn_envelopes
    ops = make_ingest_ops(n_shards, seed, writers, n_env, calls, targets)
    bodies = [[envelope_pql(e) for e in w] for w in ops]
    oracle = WriteOracle(packed, exists,
                         {**{("s", a): s_rows[a] for a in INGEST_S_ROWS},
                          ("r", 0): r_rows[0]})
    want_flags: list = [[None] * n_env for _ in ops]
    log(f"  write traffic: {writers} writers x {n_env} envelopes x {calls} "
        f"calls, {sum(f[0] for w in ops for e in w for f in e)} Sets "
        f"({time.perf_counter() - t0:.1f} s)")

    def query(pql: str, conn=None):
        return _http(port, "POST", "/index/i/query", pql.encode(),
                     conn)["results"]

    def send(w: int, lo: int, hi: int, acked: list, errors: list) -> None:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for e in range(lo, hi):
                got = query(bodies[w][e].decode(), conn)
                if got != want_flags[w][e]:
                    errors.append(f"writer {w} envelope {e}: changed flags "
                                  "differ from the oracle")
                acked[w] += len(got)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"writer {w}: {e!r}")
        finally:
            conn.close()

    def write_burst(lo: int, hi: int) -> tuple:
        """Every writer sends its envelopes lo..hi-1 -> (acked, seconds);
        their flags are simulated first, the oracle updated after."""
        for w in range(writers):
            for e in range(lo, hi):
                want_flags[w][e] = oracle.flags(ops[w][e])
        acked = [0] * writers
        errors: list = []
        ts = [threading.Thread(target=send, args=(w, lo, hi, acked, errors))
              for w in range(writers)]
        log(f"  writers start: envelopes {lo}..{hi - 1} each "
            f"({time.perf_counter() - t_phase:.1f} s into the phase)")
        t = time.perf_counter()
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        wall = time.perf_counter() - t
        log(f"  writers done in {wall:.2f} s")
        if errors:
            raise AssertionError(f"{len(errors)} writer errors: {errors[:3]}")
        oracle.settle([c for w in ops for e in w[lo:hi]
                       for s, _, _, c in e if s])
        return sum(acked), wall

    start_window()  # the write path starts here
    heat_writes0 = _http(port, "GET", "/debug/heat")["totals"]["writes"]
    # every written row resident before the writes
    t0 = time.perf_counter()
    for f, r in targets:
        if query(f"Count(Row({f}={r}))")[0] != oracle.count(f, r):
            raise AssertionError(f"Count(Row({f}={r})) differs before writes")
    resident_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if pair is None:
        pair = np.zeros((n_f, n_f), dtype=np.int64)
        for a in range(n_f):
            for b in range(a, n_f):
                pair[a, b] = pair[b, a] = _and_count(packed[a], packed[b])
    log(f"  {len(targets)} written rows made resident {resident_s:.1f} s;"
        f" pair oracle {time.perf_counter() - t0:.1f} s")

    def reader(rid: int, stop, n: int, lat: list, errors: list,
               check: bool) -> None:
        rng = np.random.default_rng(seed + 9000 + rid)
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            k = 0
            while (stop is None and k < n) or (stop is not None
                                               and not stop.is_set()):
                a, b = (int(x) for x in rng.integers(n_f, size=2))
                t = time.perf_counter()
                got = query(f"Count(Intersect(Row(f={a}), Row(f={b})))",
                            conn)[0]
                lat.append(time.perf_counter() - t)
                if check and got != int(pair[a, b]):
                    errors.append((a, b, got, int(pair[a, b])))
                k += 1
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            conn.close()

    def read_round(stop=None, n: int = 16, check: bool = True) -> list:
        lat: list = []
        errors: list = []
        ts = [threading.Thread(target=reader,
                               args=(i, stop, n, lat, errors, check))
              for i in range(readers)]
        for t in ts:
            t.start()
        return ts, lat, errors

    ts, base_lat, errors = read_round()
    for t in ts:
        t.join()
    if errors:
        raise AssertionError(f"writer-free round: {errors[:3]}")
    base_p50, base_p99 = _percentiles(base_lat)

    # -- the measured window: writers and readers together -------------
    before = ex.ingest_snapshot()
    hyb_before = ex.hybrid_snapshot()
    stop = threading.Event()
    ts, win_lat, errors = read_round(stop=stop, check=False)
    obs: dict = {}
    obs_errors: list = []

    def observe_window() -> None:
        try:
            obs.update(during_pass(
                port, ("Count(Intersect(Row(f=0), Row(f=1)))",
                       "CountBatcher"), CAPTURE_S))
        except Exception as e:  # noqa: BLE001 — raised after the join
            obs_errors.append(e)

    watcher = threading.Thread(target=observe_window)
    watcher.start()
    acked, wall = write_burst(0, envelopes)
    stop.set()
    watcher.join()
    for t in ts:
        t.join()
    if obs_errors:
        raise obs_errors[0]
    if errors:
        raise AssertionError(f"readers during the writes: {errors[:3]}")
    after = ex.ingest_snapshot()
    win_uploads = ex.hybrid_snapshot()["denseUploads"] - hyb_before[
        "denseUploads"]
    win_p50, win_p99 = _percentiles(win_lat)
    delta = {k: after[k] - before[k]
             for k in ("batches", "batched_queries", "mutations",
                       "setMutations", "clearMutations", "appliedBatches",
                       "walAppends", "walOps", "errors", "patchedDense",
                       "patchedSparse", "patchDropped", "patchDroppedDense",
                       "patchDroppedSparse", "hybridEvals", "applySeconds")}
    commit_ratio = ((delta["mutations"] + delta["setMutations"])
                    / max(delta["walAppends"], 1))
    log(f"  window (plan cache off): {acked} mutations acked in {wall:.2f} "
        "s = "
        f"{acked / wall:.1f} mutations/s; {len(win_lat)} reads, p50 "
        f"{win_p50:.2f} ms, p99 {win_p99:.2f} ms (writer-free round: p50 "
        f"{base_p50:.2f} ms, p99 {base_p99:.2f} ms); {win_uploads} dense "
        "leaves built from the host during the window")
    log(f"  apply: {delta['applySeconds']:.2f} s of host time in "
        f"{delta['batches']} batches (max_batch_seen "
        f"{after['max_batch_seen']} requests), fragment applies "
        f"{delta['appliedBatches']}, WAL appends {delta['walAppends']}, "
        f"group-commit ratio {commit_ratio:.2f}; patchedDense "
        f"{delta['patchedDense']}, patchedSparse {delta['patchedSparse']}, "
        f"patchDropped {delta['patchDropped']} (sparse bucket moves "
        f"{delta['patchDroppedSparse']}, dense {delta['patchDroppedDense']})")

    # -- read-backs: the f rows first, which must not be re-uploaded -----
    torch.cuda.synchronize()
    launches_writes = kernels.launch_counts()
    shards = srv.holder.index("i").available_shards_list()
    fview = srv.holder.index("i").field("f").view("standard")
    for a in range(n_f):
        gens = tuple(fview.fragment(s).row_generation(a) for s in shards)
        if ex.residency.peek(("row", "i", "f", "standard", a, tuple(shards),
                              gens)) is None:
            raise AssertionError(f"f row {a}: no resident leaf under its "
                                 "post-write generations (a patch missed)")
    p = packed
    pairs = [(a, (a + 1 + a // 4) % n_f) for a in range(n_f)]
    f_checks = ([(f"Count(Row(f={a}))", _popcount(p[a])) for a in range(n_f)]
                + [(f"Count(Intersect(Row(f={a}), Row(f={b})))",
                    _and_count(p[a], p[b])) for a, b in pairs]
                + [("Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))",
                    _and_count(p[0], p[1], p[2])),
                   ("TopN(f, Row(f=0), n=8)",
                    _pairs([_and_count(p[a], p[0]) for a in range(n_f)])[:8])])
    s_list = list(INGEST_S_ROWS)
    other_checks = (
        [(f"Count(Row(s={a}))", oracle.count("s", a)) for a in s_list]
        + [("Count(Row(r=0))", oracle.count("r", 0))]
        + [(f"Count(Intersect(Row(s={a}), Row(f={a % n_f})))",
            int(_bit_test(p[a % n_f], oracle.rows[("s", a)]).sum()))
           for a in s_list]
        + [("TopN(f, n=8)", _pairs([_popcount(x) for x in p])[:8]),
           ("Count(Not(Row(f=0)))", _popcount(oracle.exists & ~p[0]))])
    hyb0 = ex.hybrid_snapshot()
    for i, (pql, want) in enumerate(f_checks + other_checks):
        if i == len(f_checks):
            hyb1 = ex.hybrid_snapshot()
            if hyb1["denseUploads"] != hyb0["denseUploads"]:
                raise AssertionError(
                    f"{hyb1['denseUploads'] - hyb0['denseUploads']} dense "
                    "uploads while reading the written f rows: a patch was "
                    "missed")
        got = query(pql)[0]
        if got != want:
            raise AssertionError(f"{pql} after the writes: port "
                                 f"{str(got)[:200]} != oracle "
                                 f"{str(want)[:200]}")
        log(f"  {pql} = {str(got)[:60]} (oracle agrees)")
    torch.cuda.synchronize()
    launches_reads = kernels.launch_counts()
    hyb2 = ex.hybrid_snapshot()
    uploads_after = {
        form: {"uploads": hyb2[f"{form}Uploads"] - hyb0[f"{form}Uploads"],
               "bytes": (hyb2[f"{form}BytesUploaded"]
                         - hyb0[f"{form}BytesUploaded"])}
        for form in ("dense", "sparse", "run")}
    log(f"  read-backs done ({time.perf_counter() - t_phase:.1f} s into "
        "the phase)")
    log(f"  uploaded by form after the writes: {uploads_after} (the "
        "existence row and the dropped sparse and run leaves)")
    for name in ("pair_stream_counts", "program_count",
                 "sparse_intersect_dense", "topn_counts_packed"):
        if launches_reads[name] <= launches_writes[name]:
            raise AssertionError(f"{name} never launched after the writes")
    if delta["patchedDense"] < 1:
        raise AssertionError("no resident dense leaf was patched")
    if after["patchDroppedDense"]:
        raise AssertionError(f"{after['patchDroppedDense']} dense patches "
                             "raised and were dropped")

    # -- the first read after a burst, ingest on, then off --------------
    turns = []
    lo = envelopes
    pair_q = "Count(Intersect(Row(f=0), Row(f=1)))"
    for mode in INGEST_TURNS:
        hi = lo + turn_envelopes
        if mode == "off":
            os.environ["PILOSA_TPU_TORCH_INGEST"] = "0"
        try:
            n_acked, burst_s = write_burst(lo, hi)
        finally:
            os.environ.pop("PILOSA_TPU_TORCH_INGEST", None)
        lo = hi
        hyb_a = ex.hybrid_snapshot()
        t = time.perf_counter()
        got = query(pair_q)[0]
        first_ms = (time.perf_counter() - t) * 1e3
        hyb_b = ex.hybrid_snapshot()
        want = _and_count(p[0], p[1])
        if got != want:
            raise AssertionError(f"{pair_q} after an ingest-{mode} burst: "
                                 f"port {got} != oracle {want}")
        # after a batched burst, the sparse rows the read-backs made
        # resident were patched (or dropped on a bucket move): check them
        for a in s_list if mode == "on" else ():
            if query(f"Count(Row(s={a}))")[0] != oracle.count("s", a):
                raise AssertionError(f"Count(Row(s={a})) after an "
                                     f"ingest-{mode} burst")
        turns.append({"ingest": mode, "mutations": n_acked,
                      "mutations_per_s": n_acked / burst_s,
                      "first_read_ms": first_ms,
                      "first_read_dense_uploads": (hyb_b["denseUploads"]
                                                   - hyb_a["denseUploads"])})
        log(f"  ingest {mode}: {n_acked} mutations in {burst_s:.2f} s "
            f"({n_acked / burst_s:.1f} /s); first {pair_q} "
            f"{first_ms:.2f} ms, {turns[-1]['first_read_dense_uploads']} "
            "dense uploads (oracle agrees)")
    for a in range(n_f):
        if query(f"Count(Row(f={a}))")[0] != _popcount(p[a]):
            raise AssertionError(f"Count(Row(f={a})) after the turns")
    if query("Count(Not(Row(f=0)))")[0] != _popcount(oracle.exists & ~p[0]):
        raise AssertionError("Count(Not(Row(f=0))) after the turns")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the write path ends here
    final = ex.ingest_snapshot()
    obs["scrape"] = observe_path(port, "ingest", launches)
    # the ingest counters of /metrics are the executor's
    _, samples = parse_metrics(_text(port, "/metrics"))
    for label, k in (('{op="set"}', "setMutations"),
                     ('{op="clear"}', "clearMutations")):
        if samples[("pilosa_ingest_total", label)] != final[k]:
            raise AssertionError(f"/metrics ingest {label} != {k}")
    for fam, label, k in (
            ("pilosa_ingestBatches_total", '{kind="applied"}',
             "appliedBatches"),
            ("pilosa_ingestWal_total", '{key="appends"}', "walAppends"),
            ("pilosa_ingestWal_total", '{key="ops"}', "walOps"),
            ("pilosa_ingestPatch_total", '{kind="dense"}', "patchedDense"),
            ("pilosa_ingestPatch_total", '{kind="sparse"}', "patchedSparse"),
            ("pilosa_ingestPatch_total", '{kind="dropped"}', "patchDropped")):
        if samples[(fam, label)] != final[k]:
            raise AssertionError(f"/metrics {fam}{label} "
                                 f"{samples[(fam, label)]} != {k} {final[k]}")
    # the write heat: every Set, and a Clear that changed a bit (the batched
    # apply and the per-bit path alike, executor.py:3528-3540, :2495-2532)
    want_writes = sum(1 for w in range(writers) for e in range(n_env)
                      for op, ch in zip(ops[w][e], want_flags[w][e])
                      if op[0] or ch)
    heat_writes = (_http(port, "GET", "/debug/heat")["totals"]["writes"]
                   - heat_writes0)
    if heat_writes != want_writes:
        raise AssertionError(f"heat writes {heat_writes} != the oracle's "
                             f"{want_writes}")
    log(f"  /metrics ingest counters = Executor.ingest_snapshot(); heat "
        f"writes {heat_writes} = oracle {want_writes}")
    obs["heat_writes"] = heat_writes
    log(f"  launches on the write path: {launches}")
    stats = {
        "mutations": acked, "window_s": wall,
        "mutations_per_s": acked / wall, "group_commit_ratio": commit_ratio,
        "reads_in_window": len(win_lat), "read_p50_ms": win_p50,
        "read_p99_ms": win_p99, "base_read_p50_ms": base_p50,
        "base_read_p99_ms": base_p99, "window": delta,
        "max_batch_seen": after["max_batch_seen"],
        "dense_uploads_in_window": win_uploads,
        "uploads_after_writes": uploads_after, "turns": turns,
        "patched_sparse_total": final["patchedSparse"],
        "patch_dropped_sparse_total": final["patchDroppedSparse"],
    }
    gc.callbacks.remove(gc_watch)
    stats["gc_pause_s"] = gc_pause
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  write phase: {stats['phase_s']:.1f} s (garbage-collector "
        f"pauses by generation: {gc_pause})")
    return {"launches": launches, "stats": stats, "obs": obs}


def device_busy_ms(prof) -> float | None:
    """Union of the device intervals a torch.profiler run recorded, in ms
    (None where it recorded none)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


# -------------------------------------------------- observability checks

# the eight hand kernels' wrappers (the "pallas" kernel family)
PORT_KERNELS = tuple(REPLACES)
CAPTURE_S = 2.0        # device-profile capture on the Count and write paths
SHORT_CAPTURE_S = 1.0  # on the BSI and hybrid paths (shorter passes)
# On the TopN pass the 32 clients advance together through about 2.2 s of
# host work a query (p50 2220 ms, p99 2446 ms on NVIDIA H100 80GB HBM3,
# 700.00 W) and launch in waves: a 1 s window opened after one wave's first
# launch can close before the next wave. Six seconds hold at least two.
TOPN_CAPTURE_S = 6.0
# per client in each telemetry on/off round: 4 since phase 5f joined the
# run (8 since 5e, 16 since 5d, 32 before), to keep the whole run inside
# its time limit
COUNT_ROUND_QUERIES = 4
# the Count pass's rounds: everything on, the heat map off, the kernel
# statistics off, the telemetry sampler stopped, all off; one round of
# each since phase 5g joined the run (three, in turn and back, before)
OBS_MODES = ("on", "heat_off", "kernel_stats_off", "sampler_off", "off")
OBS_SWITCHES = OBS_MODES
# per client in each heat on/off round of five: 2 since phase 5f joined
# the run (4 since 5e, 8 since 5d, 16 before), to keep the whole run
# inside its time limit
SPILL_ROUND_QUERIES = 2
# one heat-on and one heat-off round since phase 5g joined the run (six,
# on and off in turn, before)
SPILL_SWITCHES = ("on", "off")
METRIC_LINE = None  # compiled at first use


def start_window() -> None:
    """Zero the launch counts and the kernel statistics together: a path's
    window starts here."""
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.utils import telemetry

    kernels.reset_launch_counts()
    telemetry.kernels.reset()


def _text(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("localhost", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        if resp.status != 200:
            raise AssertionError(f"GET {path} -> {resp.status}: {body[:200]}")
        return body
    finally:
        conn.close()


def parse_metrics(text: str) -> tuple:
    """({family: type}, {(name, labels): value}) of a Prometheus text
    exposition; raises on a line that does not parse, a sample of no
    declared family or a family declared twice."""
    import re

    global METRIC_LINE
    if METRIC_LINE is None:
        METRIC_LINE = re.compile(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? "
            r"([0-9eE+.\-]+|NaN|\+Inf|-Inf)$")
    types: dict = {}
    samples: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            fam, kind = line[7:].split(" ")
            if fam in types:
                raise AssertionError(f"/metrics: {fam} declared twice")
            types[fam] = kind
            continue
        m = METRIC_LINE.match(line)
        if m is None:
            raise AssertionError(f"/metrics: unparseable line {line!r}")
        name = m.group(1)
        base = next((name[:-len(x)] for x in ("_bucket", "_sum", "_count")
                     if name.endswith(x) and name[:-len(x)] in types), name)
        if base not in types:
            raise AssertionError(f"/metrics: {name} has no # TYPE")
        samples[(name, m.group(2) or "")] = float(m.group(3))
    return types, samples


def profile_probe(port: int, pql: str, batcher, warm: bool = True,
                  index: str = "i") -> dict:
    """One ?profile=true query: its tree must hold a dispatch record of
    `batcher` (or none), residency hits and no host-to-device bytes on
    warm leaves, and calls that fit in the query's elapsed time."""
    got = _http(port, "POST", f"/index/{index}/query?profile=true",
                pql.encode())
    prof = got["profile"]
    batchers = [d["batcher"] for d in prof["dispatches"]]
    if batchers != ([batcher] if batcher else []):
        raise AssertionError(f"{pql}: dispatch records {batchers}, "
                             f"expected {batcher}")
    res = prof["residency"]
    if warm and (res["hits"] < 1 or res["hostToDeviceBytes"]):
        raise AssertionError(f"{pql}: warm leaves but residency {res}")
    calls_ms = sum(c["ms"] for c in prof["calls"])
    if calls_ms > prof["elapsedMs"] + 1e-3:
        raise AssertionError(f"{pql}: calls {calls_ms} ms > elapsed "
                             f"{prof['elapsedMs']} ms")
    log(f"  ?profile=true {pql}: elapsed {prof['elapsedMs']} ms, calls "
        f"{prof['calls']}, dispatches {prof['dispatches']}, residency {res}")
    return {"pql": pql, "elapsedMs": prof["elapsedMs"],
            "calls": prof["calls"], "dispatches": prof["dispatches"],
            "residency": res}


def device_capture(port: int, seconds: float) -> dict:
    """POST /debug/device-profile during a pass: the spooled trace must
    name one of the port's kernels, and the capture gives the device's
    idle share over its window."""
    from pilosa_tpu_torch.ops import kernels

    doc = _http(port, "POST", f"/debug/device-profile?seconds={seconds}")
    if doc["status"] != "ok":
        raise AssertionError(f"device-profile capture: {doc}")
    with open(doc["trace"]) as f:
        trace = f.read()
    named = sorted(k for k in kernels.DEVICE_KERNELS if k in trace)
    if not named or not doc["kernels"]:
        raise AssertionError(f"the capture's trace names no port kernel: "
                             f"{doc}")
    log(f"  device-profile capture: {doc['seconds']} s, device busy "
        f"{doc['deviceBusyMs']} ms, idle share {doc['idleShare']}, kernels "
        f"{doc['kernels']}, device ms {doc['kernelMs']} ({doc['bytes']} "
        "bytes spooled)")
    return {k: doc[k] for k in ("seconds", "deviceBusyMs", "idleShare",
                                "kernels", "kernelMs", "bytes")}


def during_pass(port: int, probe: tuple, seconds: float) -> dict:
    """What every path does while its concurrent clients run: one
    device-profile capture, from the pass's first kernel launch on (a
    TopN pass spends its first seconds on the host), then one profiled
    query."""
    from pilosa_tpu_torch.ops import kernels

    start = sum(kernels.launch_counts().values())
    deadline = time.perf_counter() + 60
    while sum(kernels.launch_counts().values()) == start:
        if time.perf_counter() > deadline:
            raise AssertionError("no kernel launched in the pass's first "
                                 "60 s")
        time.sleep(0.01)
    capture = device_capture(port, seconds)
    return {"capture": capture, "profile": profile_probe(port, *probe)}


def observe_path(port: int, path: str, launches: dict) -> dict:
    """Scrape /debug/vars, /metrics, /debug/hbm and /debug/heat at the end
    of a path's window (zeroed by start_window, the card synchronized):
    the "pallas" dispatches equal the eight kernels' launches, each
    kernel's launches in the kernel statistics equal its launch count and
    every event pair resolved; the accounted device bytes (the distinct
    storages of the residency and the plan cache) fit in the
    allocator's."""
    import torch

    torch.cuda.synchronize()
    dv = _http(port, "GET", "/debug/vars")
    kb = dv["kernels"]
    pallas = sum(c["dispatches"] for c in kb["calls"]
                 if c["family"] == "pallas")
    total = sum(launches.values())
    if pallas != total:
        raise AssertionError(f"{path}: {pallas} pallas dispatches in "
                             f"/debug/vars, {total} launches")
    dev = kb["streamTimes"]
    if dev["pending"]:
        raise AssertionError(f"{path}: {dev['pending']} event pairs "
                             "unresolved after a synchronize")
    per_kernel = {}
    for name in PORT_KERNELS:
        rec = dev["byKernel"].get(name)
        n = launches[name]
        if (rec["launches"] if rec else 0) != n:
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"kernel statistics {rec}")
        if not n:
            continue
        per_kernel[name] = {k: rec.get(k) for k in (
            "launches", "timed", "overlapped", "p50Ms", "p99Ms",
            "hostAvgMs")}
        log(f"  {path} {name}: {n} launches, stream ms by events p50 "
            f"{rec.get('p50Ms')} p99 {rec.get('p99Ms')} ({rec['timed']} "
            f"pairs alone on the stream, {rec['overlapped']} overlapped), "
            f"host ms {rec['hostAvgMs']}")
    types, samples = parse_metrics(_text(port, "/metrics"))
    key = ("pilosa_kernelsDispatches_total", '{key="pallas",rep="dense"}')
    if samples.get(key, 0.0) != pallas:
        raise AssertionError(f"{path}: /metrics {key} = {samples.get(key)} "
                             f"!= /debug/vars {pallas}")
    hbm = _http(port, "GET", "/debug/hbm?top=8")
    allocated = torch.cuda.memory_allocated()
    if hbm["accountedBytes"] > allocated:
        raise AssertionError(f"{path}: accounted {hbm['accountedBytes']} "
                             f"bytes > allocated {allocated}")
    # the JAX package's accountedBytes: every entry, scalars at 256 bytes
    nominal = hbm["residentBytes"] + hbm["planCacheBytes"]
    heat = _http(port, "GET", "/debug/heat?top=3")
    out = {"pallas_dispatches": pallas, "untimed": dev["untimed"],
           "overlapped": dev["overlapped"],
           "event_pool_pairs": dev["poolPairs"], "kernels": per_kernel,
           "families": dev["byFamily"], "metric_families": len(types),
           "hbm_accounted_bytes": hbm["accountedBytes"],
           "hbm_nominal_bytes": nominal,
           "hbm_plan_cache_bytes": hbm["planCacheBytes"],
           "hbm_allocated_bytes": allocated,
           "hbm_drift_bytes": hbm["hbmDriftBytes"],
           "heat_totals": heat["totals"],
           "heat_tracked": heat["trackedFragments"],
           "heat_spilled": heat["spilledFragments"]}
    log(f"  {path}: /debug/vars pallas dispatches {pallas} = launches; "
        f"/metrics {len(types)} families; /debug/hbm accounted "
        f"{hbm['accountedBytes']} of {allocated} allocated bytes (distinct "
        f"storages of the residency and the plan cache; drift "
        f"{hbm['hbmDriftBytes']}; resident + plan-cache entries "
        f"{nominal}, of which plan cache {hbm['planCacheBytes']}); heat "
        f"{heat['totals']}, "
        f"{heat['trackedFragments']} tracked, {heat['spilledFragments']} "
        "spilled")
    return out


def heat_touch_us(n_shards: int, runs: int = 2000) -> dict:
    """Host µs of one HeatTracker.touch_many over n_shards shards, the
    charge applied (flush): the Frags form on a tracked field (a fresh
    shard tuple each call, as the executor passes it), the same keys as a
    list, and charges that spill at the default bound of 4096 fragments:
    five fields read in turn (every charge spills a field's worth), and a
    table full of hot fields that new keys enter by spilling each
    other."""
    from pilosa_tpu_torch.utils.heat import Frags, HeatTracker

    shards = tuple(range(n_shards))

    def timed(tr, keys_of, n: int, reads: int = 1) -> list:
        out = []
        for i in range(n):
            keys = keys_of(i)
            t = time.perf_counter()
            tr.touch_many(keys, reads=reads)
            tr.flush()
            out.append(time.perf_counter() - t)
        return out

    tr = HeatTracker()
    tr.touch_many(Frags("i", "g", "standard", shards), reads=1)
    arrays = timed(tr, lambda i: Frags("i", "g", "standard",
                                       tuple(shards)), runs)
    keys = Frags("i", "g", "standard", shards).keys()
    as_list = timed(tr, lambda i: keys, 200)
    tr = HeatTracker()
    rotation = timed(tr, lambda i: Frags("i", "abcde"[i % 5], "standard",
                                         tuple(shards)), 100)[5:]
    spilled = tr.spilled_fragments
    tr = HeatTracker()
    for f in "abcd":
        for _ in range(3):
            tr.touch_many(Frags("i", f, "standard", shards), reads=1)
    hot = timed(tr, lambda i: Frags("i", "xy"[i % 2], "standard",
                                    tuple(shards)), 40)
    out = {"arrays_us_p50": statistics.median(arrays) * 1e6,
           "arrays_us_p99": float(np.percentile(arrays, 99)) * 1e6,
           "list_us_p50": statistics.median(as_list) * 1e6,
           "spill_rotation_us_p50": statistics.median(rotation) * 1e6,
           "spill_rotation_spilled": spilled,
           "spill_hot_us_p50": statistics.median(hot) * 1e6,
           "spill_hot_spilled": tr.spilled_fragments}
    log(f"  heat: touch_many over {n_shards} shards, applied: "
        f"{out['arrays_us_p50']:.1f} us (p99 {out['arrays_us_p99']:.1f}); "
        f"as a list of keys {out['list_us_p50']:.1f} us; spilling at 4096: "
        f"{out['spill_rotation_us_p50']:.1f} us a charge over five fields "
        f"in turn ({spilled} spilled), {out['spill_hot_us_p50']:.1f} us "
        f"into a hot table ({out['spill_hot_spilled']} spilled)")
    if out["arrays_us_p50"] > 100:
        raise AssertionError("touch_many over a shard set takes more than "
                             "100 us")
    return out


def _switch(srv, mode: str) -> None:
    """Turn off what `mode` names (OBS_MODES; "on" turns nothing off)."""
    if mode in ("heat_off", "off"):
        os.environ["PILOSA_TPU_TORCH_HEAT"] = "0"
        srv.executor.heat.enabled = False
    if mode == "kernel_stats_off":
        os.environ["PILOSA_TPU_TORCH_KERNEL_STATS"] = "0"
    if mode == "off":
        os.environ["PILOSA_TPU_TORCH_TELEMETRY"] = "0"
    if mode in ("sampler_off", "off"):
        srv.telemetry.stop()


def _switch_back(srv, mode: str) -> None:
    for env in ("PILOSA_TPU_TORCH_TELEMETRY", "PILOSA_TPU_TORCH_HEAT",
                "PILOSA_TPU_TORCH_KERNEL_STATS"):
        os.environ.pop(env, None)
    srv.executor.heat.enabled = True
    if mode in ("sampler_off", "off"):
        srv.telemetry.start()


def obs_rounds(srv, run_clients) -> list:
    """The Count pass in interleaved rounds (OBS_SWITCHES): everything
    on, the heat map off (PILOSA_TPU_TORCH_HEAT=0 and its runtime
    toggle), the kernel statistics off (PILOSA_TPU_TORCH_KERNEL_STATS=0),
    the telemetry sampler stopped, and telemetry and heat off (the sampler
    stopped too): served q/s and p50 of each round, and the median of each
    mode."""
    rounds = []
    for i, mode in enumerate(OBS_SWITCHES):
        _switch(srv, mode)
        try:
            lat, wall, _ = run_clients(COUNT_ROUND_QUERIES, 3000 + 100 * i)
        finally:
            _switch_back(srv, mode)
        rounds.append({"mode": mode, "queries": len(lat),
                       "qps": len(lat) / wall,
                       "p50_ms": statistics.median(lat) * 1e3,
                       "p99_ms": float(np.percentile(lat, 99)) * 1e3})
        log(f"  round {i + 1} ({mode}, plan cache off): "
            f"{rounds[-1]['qps']:.1f} q/s, p50 "
            f"{rounds[-1]['p50_ms']:.2f} ms, p99 "
            f"{rounds[-1]['p99_ms']:.2f} ms")
    for mode in OBS_MODES:
        mine = [r for r in rounds if r["mode"] == mode]
        log(f"  {mode}: median {statistics.median(r['qps'] for r in mine):.1f}"
            f" q/s, p50 {statistics.median(r['p50_ms'] for r in mine):.2f} "
            f"ms over {len(mine)} rounds")
    return rounds


def concurrent_mix(port: int, clients: int, n_per_client: int,
                   queries: list, seed: int, during=None,
                   dealt=None, index: str = "i") -> tuple:
    """clients threads x n_per_client queries drawn from (pql, answer)
    pairs over HTTP, or each client's own list of them in `dealt` ->
    (latencies, wall seconds, what during() gave while they ran); answers
    checked."""
    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        if dealt is not None:
            mine = dealt[cid]
        else:
            rng = np.random.default_rng(seed + cid)
            mine = [queries[int(k)]
                    for k in rng.integers(len(queries), size=n_per_client)]
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for pql, want in mine:
                t = time.perf_counter()
                got = _http(port, "POST", f"/index/{index}/query",
                            pql.encode(), conn)["results"][0]
                with lock:
                    lat.append(time.perf_counter() - t)
                    if got != want:
                        errors.append((pql, got, want))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    seen = during() if during is not None else None
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(lat) != clients * n_per_client:
        raise AssertionError(f"{len(errors)} concurrent answers differ, "
                             f"{clients * n_per_client - len(lat)} missing; "
                             f"first {errors[:1]}")
    return lat, wall, seen


def five_field_queries(packed: list, values: tuple, t_rows: list,
                       s_rows: list, r_rows: list) -> list:
    """(pql, oracle answer) Counts over f, t, s, r and v: one row leaf or
    comparison mask each, 1024 shards a leaf (t's row 0 lost a column to
    the TopN phase and is left out)."""
    vals = values[1]
    return ([(f"Count(Row(f={a}))", _popcount(packed[a])) for a in range(4)]
            + [(f"Count(Row(t={a}))", int(t_rows[a].size)) for a in (1, 2)]
            + [(f"Count(Row(s={a}))", int(s_rows[a].size))
               for a in range(4)]
            + [(f"Count(Row(r={a}))", int(r_rows[a].size)) for a in (0, 1)]
            + [(f"Count(Range(v > {x}))", int((vals > x).sum()))
               for x in (300, 700)])


def spill_rounds(srv, port: int, clients: int, queries: list,
                 seed: int) -> dict:
    """Counts over five fields (f, t, s, r and v's bit planes: 5 x 1024
    fragments, past the heat map's bound of 4096) in interleaved rounds
    with the heat map on and off (SPILL_SWITCHES): with it on, a charge
    of a field not wholly tracked spills. Served q/s and p50 of each
    round and the fragments spilled in it (the heat-on rounds must
    spill); answers checked against the oracle."""
    heat = srv.executor.heat
    for pql, want in queries:  # every leaf resident before the rounds
        got = _http(port, "POST", "/index/i/query", pql.encode())
        if got["results"][0] != want:
            raise AssertionError(f"{pql}: port {got['results'][0]} != "
                                 f"oracle {want}")
    rounds = []
    for i, mode in enumerate(SPILL_SWITCHES):
        heat.flush()
        before = heat.spilled_fragments
        switch = "heat_off" if mode == "off" else "on"
        _switch(srv, switch)
        try:
            lat, wall, _ = concurrent_mix(port, clients,
                                          SPILL_ROUND_QUERIES, queries,
                                          seed + 5000 + 100 * i)
        finally:
            _switch_back(srv, switch)
        heat.flush()
        rounds.append({"heat": mode, "queries": len(lat),
                       "qps": len(lat) / wall,
                       "p50_ms": statistics.median(lat) * 1e3,
                       "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                       "spilled": heat.spilled_fragments - before})
        log(f"  five-field round {i + 1} (heat {mode}, plan cache off): "
            f"{rounds[-1]['qps']:.1f} q/s, p50 {rounds[-1]['p50_ms']:.2f} "
            f"ms, p99 {rounds[-1]['p99_ms']:.2f} ms, "
            f"{rounds[-1]['spilled']} fragments spilled")
    if not all(r["spilled"] for r in rounds if r["heat"] == "on"):
        raise AssertionError("a heat-on round over five fields spilled "
                             "nothing")
    return {"rounds": rounds,
            "tracked": heat.snapshot(top=1)["trackedFragments"]}


PLANNER_CHAIN = "Count(Intersect(Row(f=0), Row(f=5), Row(f=2), Row(f=7)))"
# sequential queries a side in each round: 20 since phase 5f joined the
# run (40 before), for the time limit
PLANNER_CHAIN_QUERIES = 20
# 2 since phase 5e joined the run (3 before), for the time limit
PLANNER_ROUNDS = 1  # 1 since phase 5g joined the run (2 before)
PLANNER_PANELS = 10  # shared 3-row Count(Intersect) dashboard panels
# 4 since phase 5g joined the run (8 since 5f, 16 before)
PLANNER_PER_CLIENT = 4
PLANNER_EMPTY_ROW = 4242  # a row of f that holds no bit


def planner_phase(srv, port: int, packed: list, rows: list, s_rows: list,
                  pair: np.ndarray, n_shards: int, clients: int,
                  seed: int) -> dict:
    """The planner and the plan cache on the Count phase's server and
    index (bench.py bench_planner, at full width), against the numpy
    oracle; its own launch counts (zeroed before its first query, read
    after its last):

    (a) PLANNER_CHAIN sequentially, the cache off, the planner off then
        on, PLANNER_ROUNDS rounds of PLANNER_CHAIN_QUERIES a side: p50;
    (b) a dashboard: clients x PLANNER_PER_CLIENT queries a side, 80 %
        the PLANNER_PANELS 3-row Count(Intersect) panels over f, each
        asked equally often, each time in a random operand order, and
        20 % ad-hoc Counts over three of f's rows (a Union, a Union of
        an Intersect, an Intersect of a Union) that no other query of the
        round asks; each round clears the cache and runs cache off, cache
        on (warm: the panels and its own ad-hoc queries) and cache on
        (measured: the cache-off side's queries again): q/s, p50, p99,
        the hit rate over warm and measured (as bench.py reports it) and
        the measured side's, which must hit every panel and miss every
        ad-hoc query; a device-profile capture in the first cache-off
        round;
    (c) Count(Intersect(Row(f=0), Row(f=PLANNER_EMPTY_ROW))): the planner
        short-circuits it (no leaf read, no upload, no launch); with the
        planner off it gives 0 by uploading and launching;
    (d) three Intersect(Row(s=a), Row(f=b)) Row results, each read
        twice: the second read hits, a result holds one [S, W] plane, the
        default 256 MiB budget holds two, and the third evicts; a Set
        through the ingest path into a row of the first reads back with
        the bit (a miss: the write changed the key), a Clear takes it out;
    (e) ?explain=true on a Count, a BSI, a TopN and a hybrid query
        launches nothing; a resident leaf predicts 0 upload bytes, a
        dense row written through the per-bit path (its leaf stale)
        predicts one plane, and executing the query uploads what EXPLAIN
        predicted.

    The existing passes run with the cache off; this phase leaves it
    off."""
    import itertools

    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.utils import telemetry

    t_phase = time.perf_counter()
    ex = srv.executor
    pc, pl = ex.plan_cache, ex.planner
    plane = n_shards * 32768 * 4  # one composed [S, W] row
    conn = http.client.HTTPConnection("localhost", port, timeout=600)

    def query(pql: str, args: str = "") -> dict:
        return _http(port, "POST", "/index/i/query" + args, pql.encode(),
                     conn)

    def check(pql: str, got, want) -> None:
        if got != want:
            raise AssertionError(f"{pql}: port {got} != oracle {want}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 7000)
    triples = list(itertools.combinations(range(len(packed)), 3))
    panels = [triples[i] for i in
              rng.permutation(len(triples))[:PLANNER_PANELS]]
    inter = {t: _and_count(*(packed[i] for i in t)) for t in triples}

    def rows_pql(rows, r) -> str:
        return ", ".join(f"Row(f={i})" for i in r.permutation(rows))

    def tri(*rows) -> int:
        return int(inter[tuple(sorted(rows))])

    # every ad-hoc shape over three rows, with its count from pair's
    # counts and the triple's (inclusion-exclusion): 56 + 168 + 168
    adhoc = []
    for a, b, c in triples:
        adhoc.append((lambda r, t=(a, b, c): (
            f"Count(Union({rows_pql(t, r)}))"),
            int(pair[a, a] + pair[b, b] + pair[c, c] - pair[a, b]
                - pair[a, c] - pair[b, c] + tri(a, b, c))))
    for a, b in itertools.combinations(range(len(packed)), 2):
        for c in set(range(len(packed))) - {a, b}:
            adhoc.append((lambda r, ab=(a, b), c=c: (
                f"Count(Union(Intersect({rows_pql(ab, r)}), Row(f={c})))"),
                int(pair[a, b] + pair[c, c] - tri(a, b, c))))
            adhoc.append((lambda r, ab=(a, b), c=c: (
                f"Count(Intersect(Union({rows_pql(ab, r)}), Row(f={c})))"),
                int(pair[a, c] + pair[b, c] - tri(a, b, c))))
    n_side = clients * PLANNER_PER_CLIENT
    n_adhoc = n_side // 5
    if 2 * n_adhoc > len(adhoc):
        raise AssertionError(f"{len(adhoc)} ad-hoc shapes for two sides of "
                             f"{n_adhoc}")

    def deal(r, fresh: list) -> list:
        """One side's queries, dealt to the clients: the panels equally
        often in random operand orders, then the fresh ad-hoc ones."""
        qs = [(f"Count(Intersect({rows_pql(panels[i % PLANNER_PANELS], r)}"
               "))", tri(*panels[i % PLANNER_PANELS]))
              for i in range(n_side - n_adhoc)]
        qs += [(make(r), want) for make, want in fresh]
        qs = [qs[i] for i in r.permutation(n_side)]
        return [qs[c::clients] for c in range(clients)]
    chain_want = _and_count(*(packed[i] for i in (0, 5, 2, 7)))
    log(f"  planner oracle: {time.perf_counter() - t0:.1f} s")

    start_window()  # the planner path starts here
    stats: dict = {"step_s": {}}
    t_step = [time.perf_counter()]

    def step(name: str) -> str:
        """Seconds since the previous step ended, kept under `name`."""
        now = time.perf_counter()
        stats["step_s"][name] = now - t_step[0]
        t_step[0] = now
        return f"({name}: {stats['step_s'][name]:.1f} s)"

    # (a) planning's own cost: the cache off, the planner off then on
    pc.enabled = False
    for _ in range(5):
        check(PLANNER_CHAIN, query(PLANNER_CHAIN)["results"][0], chain_want)
    chain = []
    for rnd in range(PLANNER_ROUNDS):
        p50 = {}
        for side in ("off", "on"):
            pl.enabled = side == "on"
            lat = []
            try:
                for _ in range(PLANNER_CHAIN_QUERIES):
                    t = time.perf_counter()
                    got = query(PLANNER_CHAIN)["results"][0]
                    lat.append(time.perf_counter() - t)
                    check(PLANNER_CHAIN, got, chain_want)
            finally:
                pl.enabled = True
            p50[side] = statistics.median(lat) * 1e3
        chain.append({"p50_ms_planner_off": p50["off"],
                      "p50_ms_planner_on": p50["on"]})
        log(f"  (a) round {rnd + 1}: {PLANNER_CHAIN}, plan cache off, "
            f"{PLANNER_CHAIN_QUERIES} sequential a side: p50 planner off "
            f"{p50['off']:.3f} ms, on {p50['on']:.3f} ms")
    stats["chain"] = chain
    log(f"  {step('a')}")

    # (b) the dashboard: cache off (cleared), on (warm), on (measured)
    probe = f"Count(Intersect({', '.join(f'Row(f={i})' for i in panels[0])}))"
    dash = []
    obs: dict = {}
    for rnd in range(PLANNER_ROUNDS):
        drng = np.random.default_rng(seed + 8000 + 100 * rnd)
        pick = drng.permutation(len(adhoc))
        warm = deal(drng, [adhoc[i] for i in pick[:n_adhoc]])
        measured = deal(drng,
                        [adhoc[i] for i in pick[n_adhoc:2 * n_adhoc]])
        pc.enabled = False
        pc.clear()
        during = ((lambda: during_pass(port, (probe, None), CAPTURE_S))
                  if rnd == 0 else None)
        lat_off, wall_off, seen = concurrent_mix(
            port, clients, PLANNER_PER_CLIENT, None, 0, during, measured)
        if seen is not None:
            obs.update(seen)
        pc.enabled = True
        s0 = pc.snapshot()
        concurrent_mix(port, clients, PLANNER_PER_CLIENT, None, 0, None,
                       warm)
        sw = pc.snapshot()
        lat_on, wall_on, _ = concurrent_mix(
            port, clients, PLANNER_PER_CLIENT, None, 0, None, measured)
        s1 = pc.snapshot()
        hits, misses = s1["hits"] - sw["hits"], s1["misses"] - sw["misses"]
        if (hits, misses) != (n_side - n_adhoc, n_adhoc):
            raise AssertionError(
                f"dashboard round {rnd + 1}: the measured side hit {hits} "
                f"and missed {misses} times; every one of its "
                f"{n_side - n_adhoc} panel queries must hit and each of its "
                f"{n_adhoc} ad-hoc queries miss")
        look = (s1["hits"] - s0["hits"]) + (s1["misses"] - s0["misses"])
        r = {"qps_cache_off": len(lat_off) / wall_off,
             "p50_ms_cache_off": statistics.median(lat_off) * 1e3,
             "p99_ms_cache_off": float(np.percentile(lat_off, 99)) * 1e3,
             "qps_cache_on": len(lat_on) / wall_on,
             "p50_ms_cache_on": statistics.median(lat_on) * 1e3,
             "p99_ms_cache_on": float(np.percentile(lat_on, 99)) * 1e3,
             "hit_rate": (s1["hits"] - s0["hits"]) / look,
             "hit_rate_measured": hits / (hits + misses),
             "plan_cache_bytes": s1["bytes"],
             "plan_cache_entries": s1["entries"]}
        dash.append(r)
        log(f"  (b) round {rnd + 1}: {clients} clients x "
            f"{PLANNER_PER_CLIENT} dashboard Counts; cache off "
            f"{r['qps_cache_off']:.1f} q/s, p50 {r['p50_ms_cache_off']:.2f} "
            f"ms, p99 {r['p99_ms_cache_off']:.2f} ms; cache on "
            f"{r['qps_cache_on']:.1f} q/s, p50 {r['p50_ms_cache_on']:.2f} "
            f"ms, p99 {r['p99_ms_cache_on']:.2f} ms; hit rate over warm "
            f"and measured {r['hit_rate']:.4f}, measured "
            f"{r['hit_rate_measured']:.4f} ({s1['entries']} entries, "
            f"{s1['bytes']} bytes)")
    stats["dashboard"] = dash
    log(f"  {step('b')}")

    # (c) the short-circuit
    pc.enabled = False
    empty = f"Count(Intersect(Row(f=0), Row(f={PLANNER_EMPTY_ROW})))"
    before = kernels.launch_counts()
    got = query(empty, "?profile=true")
    prof = got["profile"]
    if (got["results"] != [0] or prof["plan"][0]["shortCircuits"] != 1
            or prof["residency"] != {"hits": 0, "misses": 0,
                                     "hostToDeviceBytes": 0}
            or prof["dispatches"] or kernels.launch_counts() != before):
        raise AssertionError(f"{empty}: the short-circuit read, uploaded "
                             f"or launched: {got}")
    pl.enabled = False
    try:
        got_off = query(empty, "?profile=true")
    finally:
        pl.enabled = True
    res_off = got_off["profile"]["residency"]
    launched = sum(kernels.launch_counts().values()) - sum(before.values())
    if got_off["results"] != [0] or not res_off["hostToDeviceBytes"] \
            or launched < 1:
        raise AssertionError(f"{empty} with the planner off: {got_off}, "
                             f"{launched} launches")
    stats["short_circuit"] = {"residency_on": prof["residency"],
                              "residency_off": res_off,
                              "launches_off": launched}
    log(f"  (c) {empty}: planner on 0 with residency {prof['residency']}, "
        f"no dispatch, no launch; planner off 0 with residency {res_off}, "
        f"{launched} launches {step('c')}")

    # (d) Row results in the cache: two fit, the third evicts
    if pc.budget != 2 * plane:
        raise AssertionError(f"plan-cache budget {pc.budget} does not hold "
                             f"exactly two {plane}-byte rows")
    pc.clear()
    pc.enabled = True
    ev0 = pc.snapshot()["evictions"]

    def row_want(sa: int, fb: int, extra=()) -> list:
        cols = _union(s_rows[sa], np.asarray(extra, dtype=np.int64))
        return cols[_bit_test(packed[fb], cols)].tolist()

    def read(sa: int, fb: int, hit: bool, want: list) -> None:
        pql = f"Intersect(Row(s={sa}), Row(f={fb}))"
        got = query(pql, "?profile=true")
        events = got["profile"]["plan"][0]["cache"]
        if [e["hit"] for e in events] != [hit]:
            raise AssertionError(f"{pql}: cache events {events}, expected "
                                 f"hit={hit}")
        check(pql, got["results"][0]["columns"], want)

    def held(n_entries: int, evictions: int) -> None:
        hbm = _http(port, "GET", "/debug/hbm?top=0")
        n_ev = pc.snapshot()["evictions"] - ev0
        if (hbm["planCacheBytes"], hbm["planCacheEntries"], n_ev) != \
                (n_entries * plane, n_entries, evictions):
            raise AssertionError(
                f"plan cache holds {hbm['planCacheBytes']} bytes in "
                f"{hbm['planCacheEntries']} entries after {n_ev} "
                f"evictions; expected {n_entries} x {plane}, {evictions}")

    grown = []
    results = ((0, 1), (1, 2), (2, 3))
    for i, (sa, fb) in enumerate(results[:2]):
        read(sa, fb, False, row_want(sa, fb))
        read(sa, fb, True, row_want(sa, fb))
        held(i + 1, 0)
        grown.append(pc.snapshot()["bytes"])
    sa, fb = results[0]
    cand = rows[fb][:4096]  # a column of f=fb outside s=sa
    col = int(cand[~_contains(np.sort(s_rows[sa]), cand)][0])
    check(f"Set({col}, s={sa})", query(f"Set({col}, s={sa})")["results"],
          [True])
    read(sa, fb, False, row_want(sa, fb, [col]))  # the old key is stale
    held(2, 1)
    read(sa, fb, True, row_want(sa, fb, [col]))
    sc, fc = results[2]
    read(sc, fc, False, row_want(sc, fc))
    read(sc, fc, True, row_want(sc, fc))
    held(2, 2)
    check(f"Clear({col}, s={sa})", query(f"Clear({col}, s={sa})")["results"],
          [True])
    read(sa, fb, False, row_want(sa, fb))
    stats["row_cache"] = {"bytes_after_each": grown + [
        pc.snapshot()["bytes"]], "evictions": pc.snapshot()["evictions"] - ev0,
        "written_column": col}
    log(f"  (d) Row results: {plane} bytes each, plan cache "
        f"{' -> '.join(map(str, grown))} bytes; the third evicted one; "
        f"Set({col}, s={sa}) read back with the bit, Clear without it "
        f"{step('d')}")
    pc.enabled = False

    # (e) EXPLAIN launches nothing and predicts the uploads
    def explain(pql: str) -> dict:
        before = (kernels.launch_counts(),
                  telemetry.kernels.totals()["dispatches"],
                  ex.residency.snapshot()["misses"])
        doc = query(pql, "?explain=true")["explain"][0]
        after = (kernels.launch_counts(),
                 telemetry.kernels.totals()["dispatches"],
                 ex.residency.snapshot()["misses"])
        if after != before:
            raise AssertionError(f"EXPLAIN {pql} launched or read: "
                                 f"{before} -> {after}")
        return doc

    def leaves(node: dict) -> list:
        if node.get("kind") == "op":
            return [x for ch in node["children"] for x in leaves(ch)]
        return [node]

    explained = {}
    for name, pql in (
            ("count", "Count(Intersect(Row(f=0), Row(f=1), Row(f=2)))"),
            ("bsi", "Sum(Range(v > 500), field=v)"),
            ("topn", "TopN(t, Row(f=3), n=5)"),
            ("hybrid", "Count(Intersect(Row(s=5), Row(f=2)))")):
        doc = explain(pql)
        lv = leaves(doc["tree"])
        if name != "bsi" and any(x["estimatedH2dBytes"] for x in lv):
            raise AssertionError(f"EXPLAIN {pql}: a resident leaf predicts "
                                 f"an upload: {lv}")
        explained[name] = {"pql": pql, "estimatedH2dBytes":
                           doc["estimatedH2dBytes"],
                           "leaves": [(x["expr"], x["rep"],
                                       x["kernelFamily"],
                                       x["residency"]["resident"])
                                      for x in lv]}
        log(f"  (e) EXPLAIN {pql}: no launch; leaves "
            f"{explained[name]['leaves']}, estimatedH2dBytes "
            f"{doc['estimatedH2dBytes']}")
    cand = rows[6][:4096]  # a column of f=6 outside f=7
    col7 = int(cand[~_contains(rows[7], cand)][0])

    def per_bit(pql: str) -> None:
        os.environ["PILOSA_TPU_TORCH_INGEST"] = "0"
        try:
            check(pql, query(pql)["results"], [True])
        finally:
            os.environ.pop("PILOSA_TPU_TORCH_INGEST", None)

    per_bit(f"Set({col7}, f=7)")
    cold = "Count(Intersect(Row(f=7), Row(f=6)))"
    doc = explain(cold)
    f7 = [x for x in leaves(doc["tree"]) if x["expr"] == "Row(f=7)"][0]
    if (f7["rep"], f7["residency"]["generationMatch"],
            f7["estimatedH2dBytes"], doc["estimatedH2dBytes"]) != \
            ("dense", False, plane, plane):
        raise AssertionError(f"EXPLAIN {cold} after a per-bit write: {doc}")
    got = query(cold, "?profile=true")
    check(cold, got["results"][0], int(pair[6, 7]) + 1)
    res = got["profile"]["residency"]
    if res["hostToDeviceBytes"] != doc["estimatedH2dBytes"]:
        raise AssertionError(f"{cold}: uploaded {res}, EXPLAIN predicted "
                             f"{doc['estimatedH2dBytes']}")
    per_bit(f"Clear({col7}, f=7)")
    check("Count(Row(f=7))", query("Count(Row(f=7))")["results"][0],
          int(pair[7, 7]))  # resident again before the write path
    explained["cold"] = {"pql": cold, "predicted": doc["estimatedH2dBytes"],
                         "uploaded": res["hostToDeviceBytes"]}
    log(f"  (e) EXPLAIN {cold} after a per-bit Set: Row(f=7) dense, stale "
        f"generations, {f7['estimatedH2dBytes']} bytes predicted; executed: "
        f"{res['hostToDeviceBytes']} bytes uploaded {step('e')}")
    stats["explain"] = explained
    conn.close()

    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the planner path ends here
    obs["scrape"] = observe_path(port, "planner", launches)
    dv = _http(port, "GET", "/debug/vars")
    _, samples = parse_metrics(_text(port, "/metrics"))
    pairs = [(("pilosa_planner_total", f'{{key="{k}"}}'), dv["planner"][k])
             for k in ("plans", "reorders", "pushdowns", "shortCircuits")]
    pairs += [(("pilosa_planCache_total", f'{{key="{k}"}}'),
               dv["planCache"][k]) for k in ("hits", "misses", "evictions")]
    pairs += [(("pilosa_planCache", f'{{key="{k}"}}'), dv["planCache"][k])
              for k in ("bytes", "entries")]
    for key, want in pairs:
        if samples.get(key) != want:
            raise AssertionError(f"/metrics {key} = {samples.get(key)}, "
                                 f"/debug/vars {want}")
    stats["planner"] = {k: v for k, v in dv["planner"].items()
                        if k != "calibration"}
    stats["plan_cache"] = dv["planCache"]
    stats["calibration"] = {k: v for k, v in
                            dv["planner"]["calibration"].items()
                            if k != "entries"}
    log(f"  /debug/vars planner {stats['planner']} and planCache "
        f"{stats['plan_cache']} = /metrics planner_* and planCache_*; "
        f"calibration {stats['calibration']}")
    log(f"  launches on the planner path: {launches} {step('observe')}")
    if launches["program_count"] < 1:
        raise AssertionError("program_count never launched on the planner "
                             "path")
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  planner phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats, "obs": obs}


# ------------------------------------------------------ phase 5d: frozen

# BASELINE.json's configurations 2-4 (benches/scale_configs.py) and the
# chemical-similarity showcase (examples/similarity.py), and what phase 5d
# loads of each by default: only row, shard or molecule counts are cut,
# never a shape (shard width 2^20, depth 10, the distributions)
FROZEN_FULL = {"c2_rows": 100_000_000, "c3_rows": 1_000_000_000,
               "c4_shards": 953, "sim_molecules": 500_000}
# since phase 5h joined the run: config 3 at 12.5M rows (25M since the
# drill's healing steps joined phase 5g, 50M before), config 4 over 96
# shards (128 before) and the similarity search at 200k molecules (its
# full 500k before)
FROZEN_CUTS = {"c2_rows": 10_000_000, "c3_rows": 12_500_000,
               "c4_shards": 96, "sim_molecules": 200_000}
FROZEN_CONFIGS = ("2", "3", "4", "sim")
C2_COLS, C2_HEAD, C2_HEAD_BITS = 10_000, 64, 2000  # scale_configs.py:65-113
C3_SHARDS, C3_HEAD, C3_HEAD_CAP = 8, 50_000, 2000  # :115-194
C3_TOPN = 1000
C4_DEPTH_MAX = 1023  # :197-240, values uniform in 0..1023
FP_BITS, FP_PER_MOL, FP_FAMILY = 2048, 48, 100  # examples/similarity.py
FP_KEEP = 0.75
FP_QUERY = 7
FP_THRESHOLDS = (90, 70, 50)
FZ_ROWS, FZ_BITS = 3000, 40  # tests/test_topn.py:245-285
# the Min/Max pass: 8 a client since phase 5f joined the run (16 before)
MINMAX_CLIENTS, MINMAX_PER_CLIENT = 32, 8
# timed repeats of each query (scale_configs.py: 9): 5 since phase 5g
# joined the run
FROZEN_REPEATS = 5


def _rss_bytes() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _top_pairs(ids: np.ndarray, counts: np.ndarray, n) -> list:
    """[[id, count]] of the nonzero counts, count desc then id asc, at
    most n (the JSON of TopN's Pairs)."""
    keep = counts > 0
    ids, counts = ids[keep], counts[keep]
    order = np.lexsort((ids, -counts))
    if n:
        order = order[:n]
    return [{"id": int(i), "count": int(c)}
            for i, c in zip(ids[order], counts[order])]


def _p50_ms(fn, runs: int = FROZEN_REPEATS) -> float:
    samples = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t)
    return statistics.median(samples) * 1e3


def frozen_phase(srv, port: int, cuts: dict, configs, seed: int,
                 clients: int = MINMAX_CLIENTS,
                 per_client: int = MINMAX_PER_CLIENT) -> dict:
    """Phase 5d: the frozen bulk loads on the running server's holder, each
    configuration in an index of its own, queried over HTTP and checked
    exactly against numpy oracles built from the generated arrays; the
    sparse Src TopN walk; concurrent Min/Max through the MinMaxBatcher
    with a device-profile capture; the volatility contract. Its own launch
    counts (zeroed before its first load, read after its last query)."""
    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.storage import frozen as tfrozen

    t_phase = time.perf_counter()
    start_window()  # the frozen path starts here
    ex = srv.executor
    holder = srv.holder
    stats: dict = {"cuts": {k: {"loaded": cuts[k], "full": FROZEN_FULL[k]}
                            for k in cuts}}
    cut_text = ", ".join(
        f"{k} {cuts[k]:,} of {FROZEN_FULL[k]:,}" for k in cuts
        if cuts[k] != FROZEN_FULL[k]) or "none"
    log(f"  cuts (row, shard or molecule counts only): {cut_text}")
    rng = np.random.default_rng(seed + 5)
    made = []
    clock = [time.perf_counter()]  # when the configuration under way began

    def index(name: str, fields: list) -> None:
        clock[0] = time.perf_counter()
        _http(port, "POST", f"/index/{name}",
              json.dumps({"options": {"trackExistence": False}}).encode())
        for fname, opts in fields:
            _http(port, "POST", f"/index/{name}/field/{fname}",
                  json.dumps({"options": opts}).encode())
        made.append(name)

    def query(name: str, pql: str):
        return _http(port, "POST", f"/index/{name}/query",
                     pql.encode())["results"][0]

    def check(name: str, pql: str, want):
        got = query(name, pql)
        if got != want:
            raise AssertionError(f"{name} {pql}: port {str(got)[:300]} != "
                                 f"oracle {str(want)[:300]}")
        return got

    def resident() -> int:
        return ex.residency.snapshot()["bytes"]

    def loaded(key: str, build_s: float, bits: int) -> dict:
        rec = {"build_s": build_s, "bits": bits, "rss_bytes": _rss_bytes()}
        log(f"  {key}: built in {build_s:.1f} s, {bits:,} bits, host RSS "
            f"{rec['rss_bytes']:,} bytes (ru_maxrss, the process's peak)")
        return rec

    def queried(key: str, rec: dict, res0: int) -> None:
        """The device bytes the configuration's queries left resident, and
        its seconds, oracles included."""
        rec["device_resident_bytes"] = resident() - res0
        rec["config_s"] = time.perf_counter() - clock[0]
        log(f"  {key}: {rec['device_resident_bytes']:,} device bytes "
            f"resident after its queries; {rec['config_s']:.1f} s in all")

    # -- config 2: a set field of many 1-bit rows and 64 heavy rows -------
    if "2" in configs:
        res0 = resident()
        index("c2", [("f", {"type": "set"})])
        t0 = time.perf_counter()
        n_rows = cuts["c2_rows"]
        head_rows = np.repeat(np.arange(C2_HEAD, dtype=np.uint64),
                              C2_HEAD_BITS)
        head_cols = rng.integers(0, C2_COLS, head_rows.size).astype(np.uint64)
        tail_rows = np.arange(C2_HEAD, n_rows, dtype=np.uint64)
        tail_cols = rng.integers(0, C2_COLS, tail_rows.size).astype(np.uint64)
        holder.index("c2").field("f").import_rows_frozen(
            np.concatenate([head_rows, tail_rows]),
            np.concatenate([head_cols, tail_cols]))
        build_s = time.perf_counter() - t0
        del tail_rows, tail_cols
        rec = loaded("config 2", build_s, int(head_rows.size) + n_rows
                     - C2_HEAD)
        sets = [_unique(head_cols[head_rows == r]) for r in (0, 1)]
        want = {"Union": _union(*sets).size,
                "Intersect": np.intersect1d(*sets).size,
                "Xor": np.setxor1d(*sets).size,
                "Difference": _setdiff(*sets).size}
        rec["p50_ms"] = {}
        for op, n in want.items():
            pql = f"Count({op}(Row(f=0), Row(f=1)))"
            check("c2", pql, int(n))
            rec["p50_ms"][op] = _p50_ms(lambda: check("c2", pql, int(n)))
        check("c2", f"Count(Row(f={n_rows - 1}))", 1)
        log(f"  config 2 ({n_rows:,} rows x {C2_COLS:,} columns): Count of "
            f"Union/Intersect/Xor/Difference exact, p50 ms "
            f"{rec['p50_ms']}")
        queried("config 2", rec, res0)
        stats["config2"] = rec

    # -- config 3: TopN over a Zipf head and a 1-bit tail ------------------
    if "3" in configs:
        res0 = resident()
        index("c3", [("t", {"type": "set"})])
        t0 = time.perf_counter()
        n_rows = cuts["c3_rows"]
        head_n = np.maximum(np.minimum(
            C3_HEAD_CAP, n_rows // (10 * (np.arange(C3_HEAD) + 1))), 1)
        head_rows_all = np.repeat(np.arange(C3_HEAD, dtype=np.uint64), head_n)
        t_field = holder.index("c3").field("t")
        view = t_field.create_view_if_not_exists("standard")
        w = np.uint64(SHARD_WIDTH)

        def shard(s: int) -> tuple:
            """Generate and load one shard (each its own generator, so the
            shards build in parallel); its head rows' counts and bits."""
            r = np.random.default_rng([seed, 3, s])
            h_rows = head_rows_all[r.integers(0, C3_SHARDS,
                                              head_rows_all.size) == s]
            h_cols = r.integers(0, SHARD_WIDTH, h_rows.size).astype(
                np.uint64)
            head_pos = _unique(h_rows * w + h_cols)
            del h_rows, h_cols
            t_rows = np.arange(C3_HEAD + s, n_rows, C3_SHARDS,
                               dtype=np.uint64)
            t_pos = t_rows * w + r.integers(0, SHARD_WIDTH, t_rows.size
                                            ).astype(np.uint64)
            del t_rows
            # the tail rows follow the head's: sorted and unique as is
            positions = np.concatenate([head_pos, t_pos])
            del t_pos
            view.load_frozen_fragment(s, positions, presorted=True)
            return (np.bincount((head_pos // w).astype(np.int64),
                                minlength=C3_HEAD), positions.size)

        from concurrent.futures import ThreadPoolExecutor

        # a shard's build holds several transient arrays of 8 bytes a row:
        # all 8 shards at once at the cut's 25M rows, 2 at 1B rows
        workers = max(2, min(C3_SHARDS, 400_000_000 // n_rows))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            built = list(pool.map(shard, range(C3_SHARDS)))
        t_field.add_available_shards(list(range(C3_SHARDS)))
        head_counts = sum(b[0] for b in built)
        n_bits = sum(b[1] for b in built)
        build_s = time.perf_counter() - t0
        del head_rows_all
        rec = loaded("config 3", build_s, n_bits)
        want = _top_pairs(np.arange(C3_HEAD), head_counts, C3_TOPN)
        r0 = ex.topn_recount_rows
        check("c3", f"TopN(t, n={C3_TOPN})", want)
        rec["topn_p50_ms"] = _p50_ms(
            lambda: check("c3", f"TopN(t, n={C3_TOPN})", want))
        rec["topn_recount_rows"] = ex.topn_recount_rows - r0
        if rec["topn_recount_rows"] >= n_rows // 1000:
            raise AssertionError(f"TopN recounted {rec['topn_recount_rows']} "
                                 f"of {n_rows} rows")
        # every tail row holds a bit; a head row only where one of its
        # bits was drawn for some shard
        present = np.flatnonzero(head_counts)

        def rows_after(p: int) -> dict:
            head = present[present > p][:100].tolist()
            tail = range(max(p + 1, C3_HEAD), n_rows)
            return {"rows": (head + list(tail[:100 - len(head)]))}

        check("c3", "Rows(field=t, limit=100)", rows_after(-1))
        pages = iter(range(FROZEN_REPEATS * 2))

        def page():
            p = next(pages) * 997
            check("c3", f"Rows(field=t, previous={p}, limit=100)",
                  rows_after(p))

        page()
        rec["rows_page100_p50_ms"] = _p50_ms(page)
        log(f"  config 3 ({n_rows:,} rows over {C3_SHARDS} shards): "
            f"TopN(t, n={C3_TOPN}) exact, p50 {rec['topn_p50_ms']:.3f} ms, "
            f"topnRecountRows {rec['topn_recount_rows']}; Rows(field=t, "
            f"limit=100) and previous= pages exact, p50 "
            f"{rec['rows_page100_p50_ms']:.3f} ms")
        queried("config 3", rec, res0)
        stats["config3"] = rec

    # -- config 4: an int field on every column, Min/Max batched -----------
    if "4" in configs:
        res0 = resident()
        index("c4", [("v", {"type": "int", "min": 0,
                            "max": C4_DEPTH_MAX})])
        t0 = time.perf_counter()
        n_shards = cuts["c4_shards"]
        v_field = holder.index("c4").field("v")
        hist = np.zeros(C4_DEPTH_MAX + 1, dtype=np.int64)
        chunk = 16 * SHARD_WIDTH
        for lo in range(0, n_shards * SHARD_WIDTH, chunk):
            hi = min(lo + chunk, n_shards * SHARD_WIDTH)
            vals = rng.integers(0, C4_DEPTH_MAX + 1, hi - lo)
            v_field.import_values_frozen(np.arange(lo, hi, dtype=np.uint64),
                                         vals)
            hist += np.bincount(vals, minlength=C4_DEPTH_MAX + 1)
            del vals
        build_s = time.perf_counter() - t0
        depth = v_field.bit_depth
        rec = loaded("config 4", build_s,
                     int(sum(int(h) * bin(v).count("1")
                             for v, h in enumerate(hist)) + hist.sum()))
        vals_all = np.arange(C4_DEPTH_MAX + 1)

        def vc_sum(sel) -> dict:
            return {"value": int((vals_all[sel] * hist[sel]).sum()),
                    "count": int(hist[sel].sum())}

        def vc_ext(sel, is_min: bool) -> dict:
            have = np.flatnonzero(sel & (hist > 0))
            if not have.size:
                return {"value": 0, "count": 0}
            v = int(have[0] if is_min else have[-1])
            return {"value": v, "count": int(hist[v])}

        every = np.ones(hist.size, dtype=bool)
        check("c4", "Sum(field=v)", vc_sum(every))
        rec["sum_range_p50_ms"] = {}
        for x in (255, 511, 900):
            pql = f"Sum(Range(v > {x}), field=v)"
            check("c4", pql, vc_sum(vals_all > x))
            rec["sum_range_p50_ms"][x] = _p50_ms(
                lambda: check("c4", pql, vc_sum(vals_all > x)))
        for is_min in (True, False):
            agg = "Min" if is_min else "Max"
            check("c4", f"{agg}(field=v)", vc_ext(every, is_min))
            for x in (100, 700):
                check("c4", f"{agg}(Range(v > {x}), field=v)",
                      vc_ext(vals_all > x, is_min))
                check("c4", f"{agg}(Range(v < {x}), field=v)",
                      vc_ext(vals_all < x, is_min))
        # the concurrent pass: Min(Range(v > x)) and Max(Range(v < x))
        mix = []
        for x in range(0, C4_DEPTH_MAX + 1, 8):
            mix.append((f"Min(Range(v > {x}), field=v)",
                        vc_ext(vals_all > x, True)))
            mix.append((f"Max(Range(v < {x}), field=v)",
                        vc_ext(vals_all < x, False)))
        mm = ex.minmax_batcher
        snap0 = mm.snapshot()
        l0 = kernels.launch_counts()
        lat, wall, obs = concurrent_mix(
            port, clients, per_client, mix, seed + 4000,
            lambda: during_pass(port, ("Min(Range(v > 300), field=v)",
                                       "MinMaxBatcher", True, "c4"),
                                SHORT_CAPTURE_S), index="c4")
        torch.cuda.synchronize()
        l1 = kernels.launch_counts()
        snap1 = mm.snapshot()
        batches = snap1["batches"] - snap0["batches"]
        queries = snap1["batched_queries"] - snap0["batched_queries"]
        descent = l1["bsi_sum_counts"] - l0["bsi_sum_counts"]
        p50, p99 = _percentiles(lat)
        rec["minmax"] = {
            "queries": len(lat), "qps": len(lat) / wall, "p50_ms": p50,
            "p99_ms": p99, "batches": batches, "batched_queries": queries,
            "mean_batch": queries / max(batches, 1),
            "descent_launches": descent,
            "descent_launches_per_batch": descent / max(batches, 1),
            "unbatched_launches": (depth + 1) * queries,
            "capture": obs["capture"]}
        log(f"  config 4 ({n_shards} shards, {n_shards * SHARD_WIDTH:,} "
            f"columns, depth {depth}): Sum/Min/Max with and without a "
            f"filter exact; Sum(Range) p50 ms {rec['sum_range_p50_ms']}")
        log(f"  concurrent: {clients} clients x {per_client} Min(Range(v > "
            f"x))/Max(Range(v < x)), plan cache off: "
            f"{rec['minmax']['qps']:.1f} q/s, p50 {p50:.2f} ms, p99 "
            f"{p99:.2f} ms; minMaxBatcher {batches} batches, mean batch "
            f"{rec['minmax']['mean_batch']:.2f}; bsi_sum_counts (the "
            f"descent's kernel) {descent} launches, "
            f"{rec['minmax']['descent_launches_per_batch']:.2f} a batch, "
            f"against (D + 1) x queries = {(depth + 1) * queries} one "
            f"query at a time")
        if queries < len(lat) or descent >= (depth + 1) * queries:
            raise AssertionError(f"the Min/Max pass did not batch: "
                                 f"{queries} queries batched of {len(lat)}, "
                                 f"{descent} descent launches")
        queried("config 4", rec, res0)
        stats["config4"] = rec
        phase_obs = obs
    else:
        phase_obs = None

    # -- similarity: the sparse Src TopN walk ------------------------------
    if "sim" in configs:
        res0 = resident()
        n = cuts["sim_molecules"]
        index("sim", [("fingerprint", {"type": "set", "cacheSize": n})])
        t0 = time.perf_counter()
        n_fam = max(n // FP_FAMILY, 1)
        motifs = np.argsort(rng.random((n_fam, FP_BITS)),
                            axis=1)[:, :FP_PER_MOL]
        keep = rng.random((n, FP_PER_MOL)) < FP_KEEP
        noise = rng.integers(0, FP_BITS, (n, FP_PER_MOL))
        bits = np.where(keep, motifs[np.arange(n) % n_fam], noise)
        del keep, noise, motifs
        rows = np.repeat(np.arange(n, dtype=np.uint64), FP_PER_MOL)
        fp = holder.index("sim").field("fingerprint")
        fp.import_rows_frozen(rows, bits.reshape(-1).astype(np.uint64))
        build_s = time.perf_counter() - t0
        pos = _unique(rows * np.uint64(SHARD_WIDTH)
                        + bits.reshape(-1).astype(np.uint64))
        del rows, bits
        mol = (pos // np.uint64(SHARD_WIDTH)).astype(np.int64)
        col = (pos % np.uint64(SHARD_WIDTH)).astype(np.int64)
        rec = loaded("similarity", build_s, int(pos.size))
        sizes = np.bincount(mol, minlength=n)
        ids = np.arange(n)

        src = col[mol == FP_QUERY]
        inter_all = np.bincount(mol, weights=np.isin(col, src),
                                minlength=n).astype(np.int64)

        def oracle(thr: int) -> tuple:
            inter = inter_all
            cand = np.ones(n, dtype=bool)
            if thr:
                lo, hi = src.size * thr / 100, src.size * 100 / thr
                cand = (sizes > lo) & (sizes < hi)
                inter = np.where(
                    cand & (100 * inter > thr * (sizes + src.size - inter)),
                    inter, 0)
            return _top_pairs(ids, np.where(cand, inter, 0), 20), \
                int(cand.sum())

        rec["topn"] = {}
        for thr in (0, *FP_THRESHOLDS):
            pql = (f"TopN(fingerprint, Row(fingerprint={FP_QUERY}), n=20"
                   + (f", tanimotoThreshold={thr})" if thr else ")"))
            want, n_cand = oracle(thr)
            l0, r0 = kernels.launch_counts(), ex.topn_recount_rows
            t = time.perf_counter()
            check("sim", pql, want)
            times = [time.perf_counter() - t]
            l1, r1 = kernels.launch_counts(), ex.topn_recount_rows
            if l1["topn_counts_packed"] != l0["topn_counts_packed"]:
                raise AssertionError(f"{pql} launched topn_counts_packed: "
                                     "the sparse walk was not taken")
            if r1 - r0 != n_cand:
                raise AssertionError(f"{pql} recounted {r1 - r0} rows, "
                                     f"{n_cand} candidates")
            for _ in range(0 if thr else 2):  # the base query's p50 of 3
                t = time.perf_counter()
                check("sim", pql, want)
                times.append(time.perf_counter() - t)
            p50 = statistics.median(times) * 1e3
            rec["topn"][thr] = {"hits": len(want), "candidates": n_cand,
                                "first_ms": times[0] * 1e3, "p50_ms": p50,
                                "runs": len(times), "top": want[:3]}
            log(f"  {pql}: {len(want)} hits exact against the brute force, "
                f"{n_cand} candidates each recounted once on the host, no "
                f"topn_counts_packed launch; first {times[0] * 1e3:.1f} ms, "
                f"p50 {p50:.1f} ms ({len(times)} runs)")
        queried("similarity", rec, res0)
        stats["similarity"] = rec

    # -- the dense fallback: a Set into a frozen candidate row ------------
    index("fz", [("fz", {"type": "set", "cacheSize": 5000})])
    sets, rows_l, cols_l = {}, [], []
    for r in range(FZ_ROWS):
        c = _unique(rng.integers(0, 2 * SHARD_WIDTH, FZ_BITS))
        sets[r] = c
        rows_l.append(np.full(c.size, r, dtype=np.uint64))
        cols_l.append(c.astype(np.uint64))
    holder.index("fz").field("fz").import_rows_frozen(
        np.concatenate(rows_l), np.concatenate(cols_l))
    extra = 2 * SHARD_WIDTH - 1
    _http(port, "POST", "/index/fz/query", f"Set({extra}, fz=7)".encode())
    sets[7] = _union(sets[7], [extra])
    inter = np.array([np.intersect1d(sets[r], sets[7]).size
                      for r in range(FZ_ROWS)])
    l0 = kernels.launch_counts()
    check("fz", "TopN(fz, Row(fz=7), n=15)",
          _top_pairs(np.arange(FZ_ROWS), inter, 15))
    fell_back = (kernels.launch_counts()["topn_counts_packed"]
                 - l0["topn_counts_packed"])
    if fell_back < 1:
        raise AssertionError("the walk after a Set into a frozen candidate "
                             "row launched no topn_counts_packed")
    log(f"  fallback: after Set({extra}, fz=7) into a frozen candidate "
        f"row, TopN(fz, Row(fz=7), n=15) walks densely: exact, "
        f"{fell_back} topn_counts_packed launches")
    stats["fallback_launches"] = fell_back
    stats["fallback_s"] = time.perf_counter() - clock[0]

    # -- volatility ---------------------------------------------------------
    dv = _http(port, "GET", "/debug/vars")
    vol = {(v["index"], v["field"], v["view"], v["shard"]): v["mutations"]
           for v in dv.get("volatileFragments", [])}
    frozen_frags = {(i, f, v, s): fr.volatile_mutations
                    for i, f, v, s, fr in holder.walk_fragments()
                    if i in made}
    if vol != frozen_frags or vol.get(("fz", "fz", "standard", 1)) != 1:
        raise AssertionError(f"volatileFragments {len(vol)} entries, "
                             f"{len(frozen_frags)} frozen fragments loaded")
    log(f"  volatileFragments: {len(vol)} frozen fragments, mutations "
        f"{sum(vol.values())} (the fallback's Set)")
    if "sim" in configs:
        frag = holder.index("sim").field("fingerprint").view(
            "standard").fragment(0)
        pql = (f"TopN(fingerprint, Row(fingerprint={FP_QUERY}), n=20, "
               f"tanimotoThreshold={FP_THRESHOLDS[-1]})")
        want = query("sim", pql)
        t0 = time.perf_counter()
        frag.snapshot()
        snap_s = time.perf_counter() - t0
        n_containers = len(frag.storage.containers)
        frag.close()
        t0 = time.perf_counter()
        frag.open()
        open_s = time.perf_counter() - t0
        # a file of FROZEN_PARSE_MIN containers or more parses frozen (the
        # full corpus holds one container per molecule)
        parsed_frozen = isinstance(frag.storage.containers,
                                   tfrozen.FrozenContainers)
        if parsed_frozen != (n_containers >= tfrozen.FROZEN_PARSE_MIN):
            raise AssertionError(f"{n_containers} containers reopened "
                                 f"frozen={parsed_frozen}")
        check("sim", pql, want)
        dv = _http(port, "GET", "/debug/vars")
        if any(v["index"] == "sim" for v in dv.get("volatileFragments", [])):
            raise AssertionError("a snapshotted fragment is still volatile")
        stats["similarity"]["snapshot"] = {
            "snapshot_s": snap_s, "open_s": open_s,
            "file_bytes": os.path.getsize(frag.path),
            "containers": n_containers, "frozen_parse": parsed_frozen}
        log(f"  similarity fragment snapshotted in {snap_s:.2f} s "
            f"({os.path.getsize(frag.path):,} bytes, {n_containers:,} "
            f"containers), reopened in {open_s:.2f} s "
            + ("through the frozen parse" if parsed_frozen else
               "into a dict store (under FROZEN_PARSE_MIN)")
            + ": same answer, no longer in volatileFragments")

    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the frozen path ends here
    obs = phase_obs if phase_obs is not None else {}
    obs["scrape"] = observe_path(port, "frozen", launches)
    log(f"  launches on the frozen path: {launches}")
    for name in made:
        holder.delete_index(name)  # the host memory of the loads
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  frozen phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats, "obs": obs}


# -------------------------------------------------------- phase 5e: typed

TYPED_INDEX = "startrace"
TYPED_USERS = 256
# user u stars about this / (u + 1) repositories: the Star Trace shape's
# 2,000,000 cut ten times (about 1.2M stars, not 12M): every star of a
# time field costs a container in each of its four views, and the port's
# per-container host storage takes about 10 us each to load
TYPED_STARS_HEAD = 200_000
TYPED_LICENSES = 16
TYPED_FORK_SHARE = 0.2
TYPED_MOVED_SHARE = 0.1
TYPED_CHUNK_SHARDS = 64  # shards per HTTP import request
# 31 days since phase 5i joined the run (35 since phase 5h joined it, 45
# since the drill's healing steps joined phase 5g, 90 from 2019-01-01
# before): 35,840 fragments of the stargazer field (35 views), not 39,936,
# 51,200 or 97,280. They hold the whole of February, so that every window
# below spans views that hold data: the ragged span 7 days of January (3
# of them with data), the month of February and 9 days of March (17
# views, 4 of them with data)
TYPED_T0 = "2019-01-29T00:00:00"
TYPED_DAYS = 31  # 2019-01-29 .. 2019-02-28
TYPED_WINDOWS = (("2019-02-04T00:00", "2019-02-11T00:00", "one week"),
                 ("2019-02-01T00:00", "2019-03-01T00:00", "one month"),
                 ("2019-01-25T00:00", "2019-03-10T00:00", "ragged span"),
                 ("2019-01-01T00:00", "2020-01-01T00:00", "whole year"))
TYPED_USERS_MIX = (0, 1, 2, 3, 5, 8, 13, 21)  # the concurrent pass
TYPED_LICENSES_MIX = (0, 3, 7, 12)
# the typed pass (8 a client) and warm repeats (5) since phase 5f joined
# the run (16 and 10 before), for the time limit
# the typed pass: 4 a client since phase 5g joined the run (8 before); its
# warm repeats 3 (5 before)
TYPED_CLIENTS, TYPED_PER_CLIENT = 32, 4
TYPED_WARM_REPEATS = 3
# the user whose stars ClearRow empties: 100 (about 2,000 stars, so the
# fragments it touches stay near 8,000) since phase 5h joined the run; 7
# (about 25,000 stars) before
TYPED_CLEARED_USER = 100


def make_typed_data(n_shards: int, seed: int) -> dict:
    """The Star Trace-shaped data, vectorized from the seed: stars (user,
    repository, epoch second), every starred repository's license before
    and after a 10 % reassignment, and its fork flag."""
    rng = np.random.default_rng(seed + 5000)
    counts = np.maximum(1, np.round(
        TYPED_STARS_HEAD / (np.arange(TYPED_USERS) + 1)).astype(np.int64))
    users = np.repeat(np.arange(TYPED_USERS, dtype=np.int64), counts)
    repos = rng.integers(0, n_shards * SHARD_WIDTH, users.size)
    t0 = int(np.datetime64(TYPED_T0, "s").astype(np.int64))
    secs = t0 + rng.integers(0, TYPED_DAYS * 86400, users.size)
    starred = _unique(repos)
    lic0 = rng.integers(0, TYPED_LICENSES, starred.size)
    moved = np.sort(rng.choice(starred.size,
                               int(starred.size * TYPED_MOVED_SHARE),
                               replace=False))
    moved_to = rng.integers(0, TYPED_LICENSES, moved.size)
    lic = lic0.copy()
    lic[moved] = moved_to
    fork = (rng.random(starred.size) < TYPED_FORK_SHARE).astype(np.int64)
    return {"users": users, "repos": repos, "secs": secs,
            "starred": starred, "lic0": lic0, "moved": moved,
            "moved_to": moved_to, "license": lic, "fork": fork}


def _epoch(ts: str) -> int:
    return int(np.datetime64(ts, "s").astype(np.int64))


def _window_repos(d: dict, user: int, window) -> np.ndarray:
    """Sorted repositories `user` starred within [start, end)."""
    m = ((d["users"] == user) & (d["secs"] >= _epoch(window[0]))
         & (d["secs"] < _epoch(window[1])))
    return _unique(d["repos"][m])


def _post_import(port: int, path: str, body: dict) -> None:
    _http(port, "POST", path, json.dumps(body).encode())


def typed_import(port: int, d: dict, n_shards: int) -> dict:
    """The three fields through /import in chunks of TYPED_CHUNK_SHARDS
    shards (each fragment written by one request): stargazer with epoch
    timestamps (the last chunk as ISO-8601 strings), license, then the
    reassignment, fork. -> seconds per field."""
    out = {}
    sw = SHARD_WIDTH
    bounds = list(range(0, n_shards + 1, TYPED_CHUNK_SHARDS))
    if bounds[-1] != n_shards:
        bounds.append(n_shards)
    spans = list(zip(bounds[:-1], bounds[1:]))

    def chunks(cols: np.ndarray):
        order = np.argsort(cols, kind="stable")
        cuts = np.searchsorted(cols[order], [b * sw for b in bounds])
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            yield i, order[lo:hi]

    t0 = time.perf_counter()
    for i, idx in chunks(d["repos"]):
        secs = d["secs"][idx]
        stamps = (secs.tolist() if i < len(spans) - 1 else
                  [str(np.datetime64(int(s), "s")) + "Z" for s in secs])
        _post_import(port, f"/index/{TYPED_INDEX}/field/stargazer/import", {
            "rowIDs": d["users"][idx].tolist(),
            "columnIDs": d["repos"][idx].tolist(), "timestamps": stamps})
    out["stargazer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rows, cols in ((d["lic0"], d["starred"]),
                       (d["moved_to"], d["starred"][d["moved"]])):
        for _, idx in chunks(cols):
            _post_import(port, f"/index/{TYPED_INDEX}/field/license/import",
                         {"rowIDs": rows[idx].tolist(),
                          "columnIDs": cols[idx].tolist()})
    out["license"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _, idx in chunks(d["starred"]):
        _post_import(port, f"/index/{TYPED_INDEX}/field/fork/import",
                     {"rowIDs": d["fork"][idx].tolist(),
                      "columnIDs": d["starred"][idx].tolist()})
    out["fork"] = time.perf_counter() - t0
    return out


def _roaring_b64(positions: np.ndarray) -> str:
    """Shard-local positions as the port's roaring writer serializes them,
    base64 (the /import-roaring body)."""
    import base64
    import io

    from pilosa_tpu_torch.storage.roaring import Bitmap

    b = Bitmap()
    b.add_many(np.asarray(positions, dtype=np.uint64))
    buf = io.BytesIO()
    b.write_to(buf)
    return base64.b64encode(buf.getvalue()).decode()


def typed_phase(srv, port: int, n_shards: int, seed: int, clients: int,
                per_client: int, passes: bool = True) -> dict:
    """Phase 5e, typed fields (Star Trace): index startrace with a time
    field stargazer (quantum YMD), a mutex field license, a bool field
    fork and one shard of a set field extra loaded through
    /import-roaring; windows, intersections, TopN, Rows, GroupBy, writes
    (timestamped, mutex and bool Set, ClearRow, Store) and Options checked
    exactly against a numpy oracle, then clients x per_client
    Count(Intersect(Range(stargazer=u, window), Row(license=l))). Its own
    launch counts (zeroed before its first query, read after its last).
    passes=False stops after the loads. The index stays for phase 5f;
    "data" is the oracle's arrays after the phase's writes (the caller
    deletes the index, delete_typed)."""
    import torch

    from pilosa_tpu_torch.models.timequantum import views_by_time_range
    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    d = make_typed_data(n_shards, seed)
    log(f"  data: {d['users'].size} stars by {TYPED_USERS} users over "
        f"{d['starred'].size} repositories in {n_shards} shards (user u "
        f"about {TYPED_STARS_HEAD} / (u + 1); cut ten times from "
        f"2,000,000 / (u + 1)), timestamps over {TYPED_DAYS} days; "
        f"{time.perf_counter() - t_phase:.1f} s")
    _http(port, "POST", f"/index/{TYPED_INDEX}",
          json.dumps({"options": {"trackExistence": True}}).encode())
    for name, opts in (("stargazer", {"type": "time", "timeQuantum": "YMD"}),
                       ("license", {"type": "mutex"}),
                       ("fork", {"type": "bool"}), ("extra", {})):
        _http(port, "POST", f"/index/{TYPED_INDEX}/field/{name}",
              json.dumps({"options": opts}).encode())
    import_s = typed_import(port, d, n_shards)
    rng = np.random.default_rng(seed + 5100)
    extra = [_unique(rng.integers(0, SHARD_WIDTH, 3000 // (r + 1)))
             for r in range(4)]
    std = np.concatenate([c + r * SHARD_WIDTH for r, c in enumerate(extra)])
    day = extra[0][::3]
    t0 = time.perf_counter()
    _post_import(port, f"/index/{TYPED_INDEX}/field/extra/import-roaring/0",
                 {"views": {"": _roaring_b64(std),
                            "standard_20190203": _roaring_b64(day)}})
    import_s["extra"] = time.perf_counter() - t0
    f_star = srv.holder.index(TYPED_INDEX).field("stargazer")
    family = {"standard": 0, "year": 0, "month": 0, "day": 0}
    frags = 0
    for name, view in f_star.views.items():
        fam = ("standard" if name == "standard" else
               {4: "year", 6: "month", 8: "day"}[len(name) - 9])
        for frag in view.fragments.values():
            family[fam] += frag.bit_count()
            frags += 1
    log(f"  imports over HTTP: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in import_s.items())
        + f"; stargazer positions by view family {family} in {len(f_star.views)}"
        f" views and {frags} fragments; host RSS {_rss_bytes():,} bytes")
    xv = srv.holder.index(TYPED_INDEX).field("extra").view(
        "standard_20190203")
    if xv is None or xv.fragment(0).bit_count() != day.size:
        raise AssertionError("the import-roaring time view lost bits")
    if not passes:
        d["cleared_users"] = ()
        return {"data": d, "stats": {
            "import_s": import_s, "stargazer_fragments": frags,
            "phase_s": time.perf_counter() - t_phase}}

    t0 = time.perf_counter()
    lic_of = d["license"]
    starred = d["starred"]
    wrepos = {(u, k): _window_repos(d, u, w)
              for u in set(TYPED_USERS_MIX) | {7, 4}
              for k, w in enumerate(TYPED_WINDOWS)}

    def lic_counts(repos: np.ndarray) -> np.ndarray:
        return np.bincount(lic_of[np.searchsorted(starred, repos)],
                           minlength=TYPED_LICENSES)

    per_user = np.bincount(
        _unique(d["users"] * (n_shards * SHARD_WIDTH) + d["repos"])
        // (n_shards * SHARD_WIDTH), minlength=TYPED_USERS)
    fork_of = d["fork"]
    w02 = ("2019-01-01T00:00", "2019-03-01T00:00")
    u0_w02 = _window_repos(d, 0, w02)
    u0_w02_l3 = u0_w02[lic_of[np.searchsorted(starred, u0_w02)] == 3]
    lic_in_w = lic_counts(wrepos[(0, 2)])
    group = {}
    for lic_r in range(TYPED_LICENSES):
        for fk in (0, 1):
            group[(lic_r, fk)] = int(((lic_of == lic_r) & (fork_of == fk)).sum())
    log(f"  typed oracle: {time.perf_counter() - t0:.1f} s")

    def query(pql: str):
        return _http(port, "POST", f"/index/{TYPED_INDEX}/query",
                     pql.encode())["results"][0]

    def check(pql: str, want) -> None:
        t = time.perf_counter()
        got = query(pql)
        ms = (time.perf_counter() - t) * 1e3
        if got != want:
            raise AssertionError(f"{pql}: port {str(got)[:300]} != oracle "
                                 f"{str(want)[:300]}")
        log(f"  {pql[:110]} = {str(got)[:60]} (oracle agrees; {ms:.1f} ms)")

    def rng_pql(u: int, k: int) -> str:
        w = TYPED_WINDOWS[k]
        return f"Range(stargazer={u}, {w[0]}, {w[1]})"

    start_window()  # the typed path starts here
    windows = []
    for k, w in enumerate(TYPED_WINDOWS):
        n_views = len(views_by_time_range("standard",
                                          np.datetime64(w[0]).item(),
                                          np.datetime64(w[1]).item(), "YMD"))
        pql = f"Count({rng_pql(0, k)})"
        want = int(wrepos[(0, k)].size)
        t0 = time.perf_counter()
        got = query(pql)
        cold = (time.perf_counter() - t0) * 1e3
        if got != want:
            raise AssertionError(f"{pql}: port {got} != oracle {want}")
        warm = []
        for _ in range(TYPED_WARM_REPEATS):
            t0 = time.perf_counter()
            if query(pql) != want:
                raise AssertionError(f"{pql}: a warm answer differs")
            warm.append((time.perf_counter() - t0) * 1e3)
        windows.append({"window": w[2], "views": n_views, "count": got,
                        "cold_ms": cold,
                        "warm_p50_ms": statistics.median(warm)})
        log(f"  {pql} = {got} (oracle agrees): {n_views} views, cold "
            f"{cold:.1f} ms (the leaf built from {n_views} x {n_shards} "
            f"fragments), warm p50 {statistics.median(warm):.2f} ms")
    checks = [
        (f"Count(Intersect(Range(stargazer=0, {w02[0]}, {w02[1]}), "
         "Row(license=3)))", int(u0_w02_l3.size)),
        (f"Count(Intersect(Range(stargazer=0, {w02[0]}, {w02[1]}), "
         "Row(license=3), Row(fork=true)))",
         int((fork_of[np.searchsorted(starred, u0_w02_l3)] == 1).sum())),
        # three dense leaves: the program kernel's form
        (f"Count(Intersect({rng_pql(0, 3)}, {rng_pql(1, 3)}, "
         f"{rng_pql(2, 3)}))",
         int(np.intersect1d(np.intersect1d(wrepos[(0, 3)], wrepos[(1, 3)]),
                            wrepos[(2, 3)]).size)),
        (f"Count(Union({rng_pql(3, 0)}, {rng_pql(4, 1)}, {rng_pql(5, 2)}))",
         int(_union(_union(wrepos[(3, 0)], wrepos[(4, 1)]),
                        wrepos[(5, 2)]).size)),
        ("TopN(stargazer, n=10)", _pairs(per_user)[:10]),
        (f"TopN(license, {rng_pql(0, 2)}, n=5)", _pairs(lic_in_w)[:5]),
        ("Rows(field=license)", {"rows": list(range(TYPED_LICENSES))}),
        ("GroupBy(Rows(field=license), Rows(field=fork))",
         _groups(["license", "fork"], group)),
        ("Count(Row(fork=true))", int(fork_of.sum())),
        ("Count(Row(extra=1))", int(extra[1].size)),
    ]
    t0 = time.perf_counter()
    for pql, want in checks:
        check(pql, want)
    single_s = time.perf_counter() - t0

    # the concurrent pass over resident leaves: 32 range leaves and the
    # four license rows read once first
    mix = []
    t0 = time.perf_counter()
    for u in TYPED_USERS_MIX:
        for k in range(len(TYPED_WINDOWS)):
            check(f"Count({rng_pql(u, k)})", int(wrepos[(u, k)].size))
            lc = lic_counts(wrepos[(u, k)])
            mix += [(f"Count(Intersect({rng_pql(u, k)}, Row(license={lr})))",
                     int(lc[lr])) for lr in TYPED_LICENSES_MIX]
    for lr in TYPED_LICENSES_MIX:
        check(f"Count(Row(license={lr}))", int((lic_of == lr).sum()))
    warm_s = time.perf_counter() - t0
    lat, wall, obs = concurrent_mix(
        port, clients, per_client, mix, seed + 5200,
        lambda: during_pass(port, (mix[0][0], None, True, TYPED_INDEX),
                            SHORT_CAPTURE_S),
        index=TYPED_INDEX)
    stats = {"queries": len(lat), "qps": len(lat) / wall,
             "p50_ms": statistics.median(lat) * 1e3,
             "p99_ms": float(np.percentile(lat, 99)) * 1e3,
             "stars": int(d["users"].size),
             "repositories": int(starred.size),
             "import_s": import_s, "positions_by_view_family": family,
             "stargazer_views": len(f_star.views),
             "stargazer_fragments": frags, "windows": windows,
             "single_queries_s": single_s, "warm_leaves_s": warm_s}
    log(f"  concurrent: {clients} clients x {per_client} Count(Intersect("
        f"Range(stargazer=u, window), Row(license=l))) over "
        f"{len(TYPED_USERS_MIX)} users x {len(TYPED_WINDOWS)} windows x "
        f"{len(TYPED_LICENSES_MIX)} licenses, plan cache off: "
        f"{stats['qps']:.1f} q/s, p50 {stats['p50_ms']:.2f} ms, p99 "
        f"{stats['p99_ms']:.2f} ms")

    # writes over HTTP, each followed by the reads it changes
    t0 = time.perf_counter()
    free_col = int(_setdiff(np.arange(10_000, 20_000), d["repos"])[0])
    want = int(wrepos[(3, 0)].size) + 1
    check(f"Set({free_col}, stargazer=3, 2019-02-05T10:00)", True)
    check(f"Count({rng_pql(3, 0)})", want)
    lic2 = starred[lic_of == 2]
    c2 = int(lic2[0])
    n2, n5 = int(lic2.size), int((lic_of == 5).sum())
    check(f"Set({c2}, license=5)", True)
    check("Count(Row(license=2))", n2 - 1)
    check("Count(Row(license=5))", n5 + 1)
    check(f"Count(Intersect(Row(license=2), Row(license=5)))", 0)
    cf = int(starred[fork_of == 1][0])
    check(f"Set({cf}, fork=false)", True)
    check("Count(Row(fork=true))", int(fork_of.sum()) - 1)
    check(f"ClearRow(stargazer={TYPED_CLEARED_USER})", True)
    for k in range(len(TYPED_WINDOWS)):
        check(f"Count({rng_pql(TYPED_CLEARED_USER, k)})", 0)
    u0_w02_l3 = u0_w02_l3[u0_w02_l3 != c2]  # c2 had license 2, not 3
    check(f"Store(Intersect(Range(stargazer=0, {w02[0]}, {w02[1]}), "
          "Row(license=3)), saved=1)", True)
    check("Count(Row(saved=1))", int(u0_w02_l3.size))
    sub = (0, 5, 9)
    l3 = starred[lic_of == 3]
    check(f"Options(Row(license=3), shards=[{', '.join(map(str, sub))}])",
          {"attrs": {}, "columns": l3[np.isin(l3 // SHARD_WIDTH,
                                              sub)].tolist()})
    check("Options(Row(license=3), excludeColumns=true)",
          {"attrs": {}, "columns": []})
    writes_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the typed path ends here
    obs["scrape"] = observe_path(port, "typed", launches)
    res = srv.executor.residency.snapshot()
    stats.update({"writes_s": writes_s, "resident_bytes": res["bytes"],
                  "device_allocated_bytes": torch.cuda.memory_allocated(),
                  "host_rss_bytes": _rss_bytes()})
    log(f"  launches on the typed path: {launches}")
    log(f"  device bytes resident {res['bytes']:,} (allocated "
        f"{stats['device_allocated_bytes']:,}); host RSS "
        f"{stats['host_rss_bytes']:,} bytes; writes and their reads "
        f"{writes_s:.1f} s")
    for name in ("pair_stream_counts", "program_count",
                 "sparse_intersect_dense", "topn_counts_packed"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the typed path")
    # the oracle after the writes, for phase 5f on the same index
    after = dict(d, license=lic_of.copy(), fork=fork_of.copy(),
                 cleared_users=(TYPED_CLEARED_USER,))
    after["license"][np.searchsorted(starred, c2)] = 5
    after["fork"][np.searchsorted(starred, cf)] = 0
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"  typed phase: {stats['phase_s']:.1f} s")
    return {"launches": launches, "stats": stats, "obs": obs,
            "data": after}


def delete_typed(srv, stats: dict) -> None:
    """Delete phase 5e's index (its host memory and files)."""
    t0 = time.perf_counter()
    srv.holder.delete_index(TYPED_INDEX)
    stats["delete_s"] = time.perf_counter() - t0
    log(f"  index {TYPED_INDEX} deleted in {stats['delete_s']:.1f} s")


def typed_only(device, seed: int) -> dict:
    """Phase 5e alone on a fresh server."""
    from pilosa_tpu_torch.server import Server

    with tempfile.TemporaryDirectory(prefix="pilosa_torch_typed_") as tmp:
        srv = Server(os.path.join(tmp, "data"), port=0, device=device).open()
        srv.executor.plan_cache.enabled = False
        try:
            out = typed_phase(srv, srv.http.port, 1024, seed,
                              TYPED_CLIENTS, TYPED_PER_CLIENT)
            delete_typed(srv, out["stats"])
        finally:
            srv.close()
    return {"launches": out["launches"], **out["stats"]}


# ------------------------------------------------- phase 5f: keys, attributes

# the 64 languages of part A, ranked: language r tags a share of the
# repositories proportional to 1 / (r + 1)
KEYED_LANGS = (
    "JavaScript", "Python", "Java", "TypeScript", "C#", "C++", "PHP", "C",
    "Shell", "Go", "Ruby", "Rust", "Kotlin", "Swift", "Dart", "Scala",
    "Objective-C", "R", "Lua", "Perl", "Haskell", "Elixir", "Clojure",
    "Julia", "PowerShell", "MATLAB", "Groovy", "Vim Script", "Erlang",
    "OCaml", "F#", "Fortran", "Emacs Lisp", "CoffeeScript", "Elm", "Nim",
    "Crystal", "Racket", "Scheme", "Common Lisp", "Assembly", "Visual Basic",
    "Pascal", "Ada", "COBOL", "Prolog", "Smalltalk", "Tcl", "D", "Zsh",
    "Solidity", "Verilog", "VHDL", "Haxe", "Apex", "ABAP", "Awk", "Idris",
    "Agda", "Coq", "Lean", "PureScript", "ReasonML", "Standard ML")
# the row attributes: (paradigm, year) per language, typed from the list
KEYED_FUNCTIONAL = {"Haskell", "Elixir", "Clojure", "Erlang", "OCaml", "F#",
                    "Elm", "Racket", "Scheme", "Common Lisp", "Emacs Lisp",
                    "Idris", "Agda", "Coq", "Lean", "PureScript", "ReasonML",
                    "Standard ML", "Scala", "Julia"}
KEYED_TYPED = {"Java", "TypeScript", "C#", "C++", "C", "Go", "Rust",
               "Kotlin", "Swift", "Dart", "Scala", "Haskell", "OCaml", "F#",
               "Elm", "Nim", "Crystal", "Idris", "Agda", "Coq", "Lean",
               "PureScript", "ReasonML", "Standard ML", "Fortran", "Pascal",
               "Ada", "D", "Solidity", "Haxe", "Apex"}
KEYED_UNKNOWN = "Zig"  # a language no repository holds: no key minted
KEYED_PROTO_CHUNK = 1  # the chunk of each import sent as protobuf
KEYED_USER = 4  # phase 5e's ClearRow empties another user's stars
KEYED_CLIENTS, KEYED_PER_CLIENT = 32, 4  # 4 since phase 5g (8 before)
# part B: a keyed-column index of user logins (2^20 - 1 keys since phase
# 5h joined the run, 2^21 - 1 before: ids start at 1, so they fill shard
# 0 exactly, and the logins the keyed envelope mints land in shard 1,
# which the /export check of shard 0 relies on)
LOGIN_INDEX = "logins"
LOGINS = (1 << 20) - 1
LOGIN_EXPORT_SHARD = 0
LOGIN_COUNTRIES = 200
LOGIN_MAX_FOLLOWERS = 1_000_000
LOGIN_CHUNK = 1 << 18  # keys per import request
LOGIN_ATTRS = 1000  # logins given column attributes, in one request
LOGIN_ENVELOPE = 500  # keyed Set/Clear calls in one envelope


def _first_ids(stream: np.ndarray, n: int) -> np.ndarray:
    """The id each of the n keys (by index) takes when minted in the order
    of `stream`: 1 upwards by first appearance (0: never appears)."""
    uniq, first = np.unique(stream, return_index=True)
    ids = np.zeros(n, dtype=np.int64)
    ids[uniq[np.argsort(first, kind="stable")]] = np.arange(1, uniq.size + 1)
    return ids


def _post_proto(port: int, path: str, body: bytes) -> dict:
    from pilosa_tpu_torch.encoding.protobuf import CONTENT_TYPE

    conn = http.client.HTTPConnection("localhost", port, timeout=600)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": CONTENT_TYPE})
        resp = conn.getresponse()
        payload = json.loads(resp.read() or b"null")
        if resp.status != 200:
            raise AssertionError(f"POST {path} -> {resp.status}: {payload}")
        return payload
    finally:
        conn.close()


def _timed_mints(translate) -> list:
    """Wrap the store's batch translation of columns: -> [(keys,
    seconds)] of every call that minted, appended as they run (undone by
    `del translate.translate_columns`)."""
    spans: list = []
    inner = translate.translate_columns

    def timed(index, keys, create=True):
        before = translate.log_size()
        t = time.perf_counter()
        out = inner(index, keys, create)
        if translate.log_size() != before:
            spans.append((len(keys), time.perf_counter() - t))
        return out

    translate.translate_columns = timed
    return spans


def keyed_language(srv, port: int, n_shards: int, seed: int,
                   d: dict) -> dict:
    """Part A of phase 5f on phase 5e's index: the keyed language field
    of every starred repository, imported as rowKeys + columnIDs, its row
    attributes in one request, keyed reads against the oracle, the
    unknown key, and the concurrent keyed pass."""
    import torch

    from pilosa_tpu_torch.encoding.protobuf import Serializer

    ser = Serializer()
    rng = np.random.default_rng(seed + 6000)
    starred = d["starred"]
    share = 1.0 / (np.arange(len(KEYED_LANGS)) + 1)
    lang = rng.choice(len(KEYED_LANGS), starred.size, p=share / share.sum())
    names = np.array(KEYED_LANGS, dtype=object)
    _http(port, "POST", f"/index/{TYPED_INDEX}/field/language",
          json.dumps({"options": {"keys": True}}).encode())
    # the import: phase 5e's chunks of 64 shards, rowKeys + columnIDs
    bounds = list(range(0, n_shards + 1, TYPED_CHUNK_SHARDS))
    if bounds[-1] != n_shards:
        bounds.append(n_shards)
    cuts = np.searchsorted(starred, [b * SHARD_WIDTH for b in bounds])
    t0 = time.perf_counter()
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        keys = names[lang[lo:hi]].tolist()
        cols = starred[lo:hi]
        path = f"/index/{TYPED_INDEX}/field/language/import"
        if i == KEYED_PROTO_CHUNK:
            _post_proto(port, path, ser.encode_import_request(
                TYPED_INDEX, "language", row_keys=keys, column_ids=cols))
        else:
            _post_import(port, path, {"rowKeys": keys,
                                      "columnIDs": cols.tolist()})
    import_s = time.perf_counter() - t0
    lid = _first_ids(lang, len(KEYED_LANGS))  # language index -> row id
    by_id = {int(lid[i]): KEYED_LANGS[i] for i in range(len(KEYED_LANGS))}
    attrs = {k: {"paradigm": ("functional" if k in KEYED_FUNCTIONAL
                              else "imperative"),
                 "year": 1950 + (7 * i) % 70, "typed": k in KEYED_TYPED}
             for i, k in enumerate(KEYED_LANGS)}
    t0 = time.perf_counter()
    _http(port, "POST", f"/index/{TYPED_INDEX}/query", " ".join(
        "SetRowAttrs(language, %s, paradigm=%s, year=%d, typed=%s)" % (
            json.dumps(k), json.dumps(a["paradigm"]), a["year"],
            "true" if a["typed"] else "false")
        for k, a in attrs.items()).encode())
    attrs_s = time.perf_counter() - t0
    log(f"  language: {starred.size} repositories over {n_shards} shards "
        f"tagged with {len(KEYED_LANGS)} keyed rows (share 1 / (r + 1)) "
        f"over HTTP in {len(bounds) - 1} requests of {TYPED_CHUNK_SHARDS} "
        f"shards (request {KEYED_PROTO_CHUNK} a protobuf ImportRequest): "
        f"{import_s:.1f} s; {len(attrs)} SetRowAttrs in one request "
        f"{attrs_s * 1e3:.1f} ms")

    # the oracle
    counts = np.bincount(lang, minlength=len(KEYED_LANGS))
    lic, fork = d["license"], d["fork"]

    def top(cnt: np.ndarray, n: int, keep=None) -> list:
        order = sorted((i for i in range(len(KEYED_LANGS))
                        if cnt[i] > 0 and (keep is None or keep(i))),
                       key=lambda i: (-int(cnt[i]), int(lid[i])))[:n]
        return [{"id": int(lid[i]), "key": KEYED_LANGS[i],
                 "count": int(cnt[i])} for i in order]

    def top_src(lic_row: int) -> list:
        return top(np.bincount(lang[lic == lic_row],
                               minlength=len(KEYED_LANGS)), 10)

    groups = []
    for i in np.argsort(lid):
        for fk in (0, 1):
            c = int(((lang == i) & (fork == fk)).sum())
            if c:
                groups.append({"group": [
                    {"field": "language", "rowKey": KEYED_LANGS[i]},
                    {"field": "fork", "rowID": fk}], "count": c})
    week = TYPED_WINDOWS[0]
    user_week = _window_repos(d, KEYED_USER, week)

    def in_week(k: str) -> int:
        mine = starred[lang == KEYED_LANGS.index(k)]
        return int(np.intersect1d(mine, user_week).size)

    go_id = int(lid[KEYED_LANGS.index("Go")])
    after_go = [by_id[r] for r in sorted(by_id) if r > go_id][:5]
    functional = top(counts, 10, lambda i: KEYED_LANGS[i] in KEYED_FUNCTIONAL)
    checks = [
        ("TopN(language, n=10)", top(counts, 10)),
        ("TopN(language, Row(license=3), n=10)", top_src(3)),
        ('TopN(language, n=10, attrName="paradigm", '
         'attrValues=["functional"])', functional),
        ("GroupBy(Rows(field=language), Rows(field=fork))", groups),
        (f'Count(Intersect(Row(language="Go"), Range(stargazer='
         f'{KEYED_USER}, {week[0]}, {week[1]})))', in_week("Go")),
        ('Rows(field=language, previous="Go", limit=5)',
         {"rows": None, "keys": after_go}),
        ('Count(Row(language="Haskell"))',
         int(counts[KEYED_LANGS.index("Haskell")])),
    ]
    query = lambda pql: _http(port, "POST", f"/index/{TYPED_INDEX}/query",
                              pql.encode())["results"][0]
    single = {}
    for pql, want in checks:
        t0 = time.perf_counter()
        got = query(pql)
        single[pql] = (time.perf_counter() - t0) * 1e3
        if got != want:
            raise AssertionError(f"{pql}: port {str(got)[:300]} != oracle "
                                 f"{str(want)[:300]}")
        log(f"  {pql[:100]} = {str(got)[:70]} (oracle agrees; "
            f"{single[pql]:.1f} ms)")
    got = _http(port, "POST", f"/index/{TYPED_INDEX}/query",
                b'Row(language="Haskell")')["results"][0]
    hk = "Haskell"
    if got["attrs"] != attrs[hk] or got["columns"] != starred[
            lang == KEYED_LANGS.index(hk)].tolist():
        raise AssertionError(f"Row(language={hk!r}): attrs or columns "
                             "differ from the oracle")
    # the concurrent keyed pass: the TopNs (plain, with a Src, by
    # attribute), GroupBy, Row x week over four languages, paging
    mix = [(pql, want) for pql, want in checks[:4]]
    mix += [(f'Count(Intersect(Row(language="{k}"), Range(stargazer='
             f'{KEYED_USER}, {week[0]}, {week[1]})))', in_week(k))
            for k in ("Go", "Rust", "Python", "Haskell")]
    mix.append(checks[5])
    for pql, want in mix:  # every leaf resident before the pass
        if query(pql) != want:
            raise AssertionError(f"{pql}: differs from the oracle")
    probe = (mix[4][0], None, True, TYPED_INDEX)
    lat, wall, obs = concurrent_mix(
        port, KEYED_CLIENTS, KEYED_PER_CLIENT, mix, seed + 6100,
        lambda: during_pass(port, probe, SHORT_CAPTURE_S), index=TYPED_INDEX)
    # after the pass, an unknown key: 0, nothing minted; a Set mints it
    # and the same Count reads 1 with the plan cache on
    pc = srv.executor.plan_cache
    pc.enabled = True
    try:
        size = srv.translate.log_size()
        unknown = f'Count(Row(language="{KEYED_UNKNOWN}"))'
        for _ in range(2):
            if query(unknown) != 0:
                raise AssertionError(f"{unknown} is not 0")
        if srv.translate.log_size() != size:
            raise AssertionError("a read minted a key")
        repo = int(starred[0])
        if query(f'Set({repo}, language="{KEYED_UNKNOWN}")') is not True:
            raise AssertionError("the Set of a new key changed nothing")
        if query(unknown) != 1:
            raise AssertionError(f"{unknown} after its Set is not 1 with "
                                 "the plan cache on")
        minted = srv.translate.log_size() - size
    finally:
        pc.enabled = False
    log(f"  {unknown} = 0 twice, the translate log unchanged; after "
        f"Set({repo}, language=\"{KEYED_UNKNOWN}\") (a {minted}-byte "
        "record) it reads 1 with the plan cache on")

    torch.cuda.synchronize()
    stats = {"repositories": int(starred.size), "import_s": import_s,
             "row_attrs_s": attrs_s, "single_ms": single,
             "queries": len(lat), "qps": len(lat) / wall,
             "p50_ms": statistics.median(lat) * 1e3,
             "p99_ms": float(np.percentile(lat, 99)) * 1e3}
    log(f"  concurrent: {KEYED_CLIENTS} clients x {KEYED_PER_CLIENT} keyed "
        f"queries (TopN with a Src, TopN by attribute, GroupBy, "
        f"Row x Range, Rows paging), plan cache off: {stats['qps']:.1f} "
        f"q/s, p50 {stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms")
    return {"stats": stats, "obs": obs}


def keyed_logins(srv, port: int, seed: int) -> dict:
    """Part B of phase 5f: a keyed-column index of LOGINS user logins
    with a keyed country field (Zipf share over LOGIN_COUNTRIES) and an
    int field followers, imported with columnKeys; column attributes on
    LOGIN_ATTRS logins in one request; keyed Counts, Sums, a Range, a
    rare country's Row of keys with its attribute sets, an envelope of
    keyed writes through the IngestBatcher, /export, and the field's
    DELETE giving its device bytes back."""
    import gc

    import torch

    from pilosa_tpu_torch.encoding.protobuf import Serializer

    ser = Serializer()
    rng = np.random.default_rng(seed + 6500)
    n = LOGINS
    logins = np.array([f"u{i:07d}" for i in range(n)], dtype=object)
    share = 1.0 / (np.arange(LOGIN_COUNTRIES) + 1)
    country = rng.choice(LOGIN_COUNTRIES, n, p=share / share.sum())
    cnames = np.array([f"country-{c:03d}" for c in range(LOGIN_COUNTRIES)],
                      dtype=object)
    followers = rng.integers(0, LOGIN_MAX_FOLLOWERS + 1, n)
    _http(port, "POST", f"/index/{LOGIN_INDEX}", json.dumps(
        {"options": {"keys": True, "trackExistence": True}}).encode())
    _http(port, "POST", f"/index/{LOGIN_INDEX}/field/country",
          json.dumps({"options": {"keys": True}}).encode())
    _http(port, "POST", f"/index/{LOGIN_INDEX}/field/followers", json.dumps(
        {"options": {"type": "int", "min": 0,
                     "max": LOGIN_MAX_FOLLOWERS}}).encode())
    spans = _timed_mints(srv.translate)
    import_s = {}
    try:
        for field in ("country", "followers"):
            t0 = time.perf_counter()
            for i, lo in enumerate(range(0, n, LOGIN_CHUNK)):
                hi = min(n, lo + LOGIN_CHUNK)
                keys = logins[lo:hi].tolist()
                path = f"/index/{LOGIN_INDEX}/field/{field}/import"
                proto = i == KEYED_PROTO_CHUNK
                if field == "country":
                    rows = cnames[country[lo:hi]].tolist()
                    if proto:
                        _post_proto(port, path, ser.encode_import_request(
                            LOGIN_INDEX, field, row_keys=rows,
                            column_keys=keys))
                    else:
                        _post_import(port, path, {"rowKeys": rows,
                                                  "columnKeys": keys})
                elif proto:
                    _post_proto(port, path, ser.encode_import_value_request(
                        LOGIN_INDEX, field, column_keys=keys,
                        values=followers[lo:hi]))
                else:
                    _post_import(port, path, {
                        "columnKeys": keys,
                        "values": followers[lo:hi].tolist()})
            import_s[field] = time.perf_counter() - t0
    finally:
        del srv.translate.translate_columns
    minted = sum(k for k, _ in spans)
    mint_s = sum(s for _, s in spans)
    if minted != n:
        raise AssertionError(f"{minted} keys minted, not {n}")
    cid = _first_ids(country, LOGIN_COUNTRIES)  # country -> row id
    col = np.arange(1, n + 1, dtype=np.int64)  # login i -> column i + 1
    log(f"  logins: {n} column keys (shards 0-{n // SHARD_WIDTH}), country "
        f"{LOGIN_COUNTRIES}"
        f" keyed rows (share 1 / (r + 1)), followers 0..{LOGIN_MAX_FOLLOWERS}"
        f"; imports over HTTP in requests of {LOGIN_CHUNK} keys (request "
        f"{KEYED_PROTO_CHUNK} protobuf): country {import_s['country']:.1f} s"
        f", followers {import_s['followers']:.1f} s; mint "
        f"{mint_s / n * 1e6:.2f} us a key ({n} keys in {mint_s:.1f} s)")

    # column attributes on LOGIN_ATTRS logins, one request: the rare
    # country's first logins and random others
    rare = LOGIN_COUNTRIES - 1
    rare_idx = np.nonzero(country == rare)[0]
    pick = _unique(np.concatenate([
        rare_idx[:LOGIN_ATTRS // 2],
        rng.choice(n, LOGIN_ATTRS, replace=False)]))[:LOGIN_ATTRS]
    cattrs = {int(i): {"city": f"city{int(i) % 97}",
                       "stars": int(followers[i] % 1000)} for i in pick}
    t0 = time.perf_counter()
    _http(port, "POST", f"/index/{LOGIN_INDEX}/query", " ".join(
        f'SetColumnAttrs("{logins[i]}", city="{a["city"]}", '
        f'stars={a["stars"]})' for i, a in cattrs.items()).encode())
    attrs_s = time.perf_counter() - t0
    log(f"  {len(cattrs)} SetColumnAttrs in one request: "
        f"{attrs_s * 1e3:.1f} ms")

    def query(pql: str, args: str = ""):
        return _http(port, "POST", f"/index/{LOGIN_INDEX}/query{args}",
                     pql.encode())

    ccount = np.bincount(country, minlength=LOGIN_COUNTRIES)
    fsum = np.bincount(country, weights=followers,
                       minlength=LOGIN_COUNTRIES).astype(np.int64)
    checks = []
    for c in range(4):
        checks += [(f'Count(Row(country="{cnames[c]}"))', int(ccount[c])),
                   (f'Sum(Row(country="{cnames[c]}"), field=followers)',
                    {"value": int(fsum[c]), "count": int(ccount[c])})]
    checks.append(("Count(Range(followers > 500000))",
                   int((followers > 500000).sum())))
    for pql, want in checks:
        got = query(pql)["results"][0]
        if got != want:
            raise AssertionError(f"{pql}: port {got} != oracle {want}")
        log(f"  {pql} = {got} (oracle agrees)")
    # a rare country's Row: keys, and the attribute sets of its columns
    got = query(f'Row(country="{cnames[rare]}")', "?columnAttrs=true")
    want_sets = [{"id": int(col[i]), "attrs": cattrs[int(i)],
                  "key": logins[i]} for i in rare_idx if int(i) in cattrs]
    if got["results"][0] != {"attrs": {}, "keys": logins[rare_idx].tolist()} \
            or got["columnAttrSets"] != want_sets:
        raise AssertionError(f"Row(country={cnames[rare]!r}) with "
                             "columnAttrs: keys or sets differ")
    t0 = time.perf_counter()
    big = query(f'Row(country="{cnames[0]}")')["results"][0]["keys"]
    render_ms = (time.perf_counter() - t0) * 1e3
    if big != logins[country == 0].tolist():
        raise AssertionError("the largest Row of keys differs")
    log(f"  Row(country={cnames[rare]!r}) with columnAttrs=true: "
        f"{rare_idx.size} keys, {len(want_sets)} attribute sets (oracle "
        f"agrees); the largest Row, {len(big)} keys, rendered in "
        f"{render_ms:.1f} ms")

    # one envelope of keyed writes through the IngestBatcher: Sets that
    # mint new logins, Clears of imported bits
    snap0 = srv.executor.ingest_snapshot()
    size = srv.translate.log_size()
    n_set = LOGIN_ENVELOPE * 4 // 5
    clear_idx = rng.choice(np.nonzero(country < 4)[0],
                           LOGIN_ENVELOPE - n_set, replace=False)
    calls = [f'Set("new{j:05d}", country="{cnames[j % 4]}")'
             for j in range(n_set)]
    calls += [f'Clear("{logins[i]}", country="{cnames[country[i]]}")'
              for i in clear_idx]
    got = query(" ".join(calls))["results"]
    if got != [True] * LOGIN_ENVELOPE:
        raise AssertionError("the keyed envelope's changed flags differ")
    snap1 = srv.executor.ingest_snapshot()
    if snap1["mutations"] - snap0["mutations"] != LOGIN_ENVELOPE:
        raise AssertionError("the keyed envelope did not go through the "
                             "IngestBatcher")
    if srv.translate.log_size() <= size:
        raise AssertionError("the envelope minted no login")
    for j in range(n_set):
        ccount[j % 4] += 1
    np.subtract.at(ccount, country[clear_idx], 1)
    for c in range(4):
        pql = f'Count(Row(country="{cnames[c]}"))'
        if query(pql)["results"][0] != int(ccount[c]):
            raise AssertionError(f"{pql} after the envelope differs")
    country_after = country.copy()
    country_after[clear_idx] = -1
    log(f"  one envelope of {LOGIN_ENVELOPE} keyed Set/Clear calls ({n_set}"
        f" minting new logins) through the IngestBatcher: every flag and "
        f"the four Counts after it agree")

    # /export of a full shard of country
    t0 = time.perf_counter()
    text = _text(port, f"/export?index={LOGIN_INDEX}&field=country"
                       f"&shard={LOGIN_EXPORT_SHARD}")
    export_ms = (time.perf_counter() - t0) * 1e3
    in1 = (col // SHARD_WIDTH == LOGIN_EXPORT_SHARD) & (country_after >= 0)
    rid = cid[country_after[in1]]
    order = np.lexsort((col[in1], rid))
    want_text = "".join(f"{r},{c}\r\n" for r, c in
                        zip(rid[order].tolist(), col[in1][order].tolist()))
    if text != want_text:
        raise AssertionError(f"/export of shard {LOGIN_EXPORT_SHARD} "
                             "differs from the oracle")
    log(f"  /export of shard {LOGIN_EXPORT_SHARD} of country: "
        f"{int(in1.sum())} lines "
        f"({len(text)} bytes) in {export_ms:.1f} ms (oracle agrees)")

    # DELETE of country gives its device bytes back
    torch.cuda.synchronize()
    gc.collect()
    field_bytes = sum(nb for k, nb, _ in
                      srv.executor.residency.entries_snapshot()
                      if len(k) > 2 and k[1:3] == (LOGIN_INDEX, "country"))
    before = torch.cuda.memory_allocated()
    _http(port, "DELETE", f"/index/{LOGIN_INDEX}/field/country")
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    left = [k for k, _, _ in srv.executor.residency.entries_snapshot()
            if len(k) > 2 and k[1:3] == (LOGIN_INDEX, "country")]
    if left or field_bytes <= 0 or before - after < field_bytes:
        raise AssertionError(f"DELETE country: {len(left)} leaves left, "
                             f"{field_bytes} resident bytes, allocated "
                             f"{before} -> {after}")
    schema = _http(port, "GET", f"/index/{LOGIN_INDEX}")
    if "country" in [f["name"] for f in schema["fields"]]:
        raise AssertionError("the deleted field is still in the schema")
    log(f"  DELETE country: {field_bytes:,} resident bytes dropped; device "
        f"allocated {before:,} -> {after:,} bytes")
    return {"logins": n, "import_s": import_s,
            "mint_us_per_key": mint_s / n * 1e6, "column_attrs_s": attrs_s,
            "largest_row_keys": len(big), "render_ms": render_ms,
            "export_ms": export_ms, "delete_field_bytes": field_bytes,
            "allocated_before": before, "allocated_after": after}


def keyed_phase(srv, port: int, n_shards: int, seed: int, d: dict) -> dict:
    """Phase 5f: part A (keyed language on phase 5e's index) and part B
    (the keyed-column login index), with the launch counts zeroed before
    it and read after it; six kernels must launch."""
    import torch

    from pilosa_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    start_window()  # the keyed path starts here
    out = keyed_language(srv, port, n_shards, seed, d)
    out["stats"]["logins"] = keyed_logins(srv, port, seed)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()  # the keyed path ends here
    out["obs"]["scrape"] = observe_path(port, "keyed", launches)
    out["launches"] = launches
    t0 = time.perf_counter()
    _http(port, "DELETE", f"/index/{LOGIN_INDEX}")
    log(f"  index {LOGIN_INDEX} deleted in {time.perf_counter() - t0:.1f} s")
    out["stats"]["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches on the keyed path: {launches}")
    for name in ("topn_counts_packed", "cross_count_matrix",
                 "sparse_intersect_dense", "pair_stream_counts",
                 "bsi_sum_counts", "bsi_compare"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the keyed path")
    log(f"  keyed phase: {out['stats']['phase_s']:.1f} s")
    return out


def keyed_only(device, seed: int) -> dict:
    """Phase 5e's loads (no passes), then phase 5f, on a fresh server."""
    from pilosa_tpu_torch.server import Server

    with tempfile.TemporaryDirectory(prefix="pilosa_torch_keyed_") as tmp:
        srv = Server(os.path.join(tmp, "data"), port=0, device=device).open()
        srv.executor.plan_cache.enabled = False
        try:
            typed = typed_phase(srv, srv.http.port, 1024, seed,
                                TYPED_CLIENTS, TYPED_PER_CLIENT, passes=False)
            log(f"  phase 5e loads: {typed['stats']}")
            out = keyed_phase(srv, srv.http.port, 1024, seed, typed["data"])
            delete_typed(srv, typed["stats"])
        finally:
            srv.close()
    return {"launches": out["launches"], **out["stats"]}


# ---------------------------------------------------------- phase 5g: cluster

CLUSTER_NODES = 3
# cut by the time limit from the other phases' 1024: 128 since the drill's
# healing steps (256 before)
CLUSTER_SHARDS = 128
CLUSTER_CHUNK = 32  # shards per /import request
CLUSTER_LANGS = KEYED_LANGS[:16]
CLUSTER_LANG_BITS = 4096  # tagged columns per shard
CLUSTER_S_ROWS = 8  # sparse rows of s: K = 16 << a per shard, 16..2048
CLUSTER_CLIENTS, CLUSTER_PER_CLIENT = 32, 8
# the coalescing A/B rounds: one of each since the drill's healing steps
# (two of each before)
CLUSTER_AB = ("off", "on")
# 3 envelopes a writer since the fleet checks joined phase 5g (4 since
# phase 5h joined the run, 6 before)
CLUSTER_WRITERS, CLUSTER_ENVELOPES, CLUSTER_CALLS = 4, 3, 500
CLUSTER_READERS = 16
CLUSTER_W_ROWS = 8  # rows of the written field w
CLUSTER_NEW_KEYS = 100  # lang keys minted by the keyed envelope
CLUSTER_DRILL_READERS = 8
# the drill's outage writes: per writer, envelopes of Sets and single Sets
# into node 2's shards, on w's row CLUSTER_W_ROWS; the planted bit on the
# next row
CLUSTER_OUTAGE_WRITERS = 4
CLUSTER_OUTAGE_ENVELOPES, CLUSTER_OUTAGE_CALLS = 3, 200
CLUSTER_OUTAGE_BITS = 25
CLUSTER_AE_INTERVAL = 5.0  # the nodes' [anti-entropy] interval, seconds
CLUSTER_CAPTURE_S = 1.0
CLUSTER_PLATFORM = ""  # the nodes' [mesh] platform: "" is the card
CLUSTER_KERNELS = ("program_count", "pair_stream_counts",
                   "topn_counts_packed", "bsi_sum_counts", "bsi_compare",
                   "cross_count_matrix", "sparse_intersect_dense")
# phase 5h: readers and writers through node 0 while node 3 joins, readers
# through node 0 while node 2 drains; the gossip pair's protocol period
# and secret, and its index's shards
MEMBER_READERS, MEMBER_WRITERS, DRAIN_READERS = 4, 1, 8
# seconds the join's readers and writer go on after NORMAL (reads and
# acknowledged writes under the new topology; 2 before the fleet checks)
MEMBER_AFTER_S = 1.0
GOSSIP_PERIOD = 0.25
GOSSIP_SECRET = "phase-5h-secret"
GOSSIP_SHARDS = 16
# the kernels node 3 and each gossip node must launch (one of them)
MEMBER_KERNELS = ("pair_stream_counts", "program_count")
# the event journal's checks: each node's log file in its data dir, node
# 2's [metric] events-spool
NODE_LOG = "node.log"
EVENTS_SPOOL = 1 << 20
# node 0 exports its traces ([metric] trace-export) to this file in its
# data dir
TRACE_SPOOL = "trace-spool.jsonl"


def _get_raw(port: int, path: str) -> bytes:
    conn = http.client.HTTPConnection("localhost", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise AssertionError(f"GET {path} -> {resp.status}: {data!r}")
        return data
    finally:
        conn.close()


def _free_ports(n: int) -> list:
    """n free ports below the kernel's ephemeral range, so that a node
    that dies and restarts on its port cannot find it taken meanwhile as
    the source port of an outgoing connection."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    ports: list = []
    while len(ports) < n:
        p = rng.randrange(10000, max(low, 10001))
        if p in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                continue
        ports.append(p)
    return ports


class ClusterNodes:
    """The node processes of phase 5g: `python -m pilosa_tpu_torch.cli
    server --config n<i>.toml`, each with its own data dir and a pinned
    .id (node0 < node1 < node2, so node 0 coordinates and mints keys);
    add_joiner() adds one more that starts with --join (phase 5h). With
    gossip=True they are phase 5h's gossip pair instead: g0 and g1, no
    [cluster] hosts, [gossip] with a shared secret and each other as
    seeds."""

    def __init__(self, tmp: str, n: int, gossip: bool = False):
        self.tmp = tmp
        self.prefix = "g" if gossip else "n"
        self.ports = _free_ports(2 * n if gossip else n)
        self.gossip_ports = self.ports[n:]
        self.ports = self.ports[:n]
        self.ids = [f"g{i}" if gossip else f"node{i}" for i in range(n)]
        self.procs: list = [None] * n
        self.killed: set = set()
        self.joiners: set = set()
        self.configs = []
        for i in range(n):
            self._config(i, gossip)

    def _config(self, i: int, gossip: bool = False) -> None:
        data = os.path.join(self.tmp, f"{self.prefix}{i}")
        os.makedirs(data)
        with open(os.path.join(data, ".id"), "w") as f:
            f.write(self.ids[i])
        if gossip:
            seeds = ", ".join(f'"127.0.0.1:{p}"' for j, p in
                              enumerate(self.gossip_ports) if j != i)
            cluster = ("[cluster]\nreplicas = 2\n"
                       f"[gossip]\nport = {self.gossip_ports[i]}\n"
                       f"seeds = [{seeds}]\nperiod = {GOSSIP_PERIOD}\n"
                       f'secret = "{GOSSIP_SECRET}"\n')
        else:
            hosts = ", ".join(f'"http://127.0.0.1:{p}"'
                              for p in self.ports[:CLUSTER_NODES])
            cluster = ("[cluster]\ndisabled = false\nreplicas = 2\n"
                       f"hosts = [{hosts}]\nmembership-interval = 0.5\n"
                       "[anti-entropy]\n"
                       f"interval = {CLUSTER_AE_INTERVAL}\n")
        cfg = os.path.join(self.tmp, f"{self.prefix}{i}.toml")
        # every node logs into its data dir, node 1 as JSON lines
        logging = f'log-path = "{os.path.join(data, NODE_LOG)}"\n'
        if not gossip and i == 1:
            logging += 'log-format = "json"\n'
        # node 2 spools its events, node 0 exports its traces
        spool = (f"[metric]\nevents-spool = {EVENTS_SPOOL}\n"
                 if not gossip and i == 2 else
                 '[metric]\ntrace-export = "file"\n'
                 f'trace-export-path = "{os.path.join(data, TRACE_SPOOL)}"'
                 '\ntrace-export-format = "jaeger"\n'
                 "trace-export-sample = 1.0\n"
                 if not gossip and i == 0 else "")
        with open(cfg, "w") as f:
            f.write(f'data-dir = "{data}"\n'
                    f'bind = "127.0.0.1:{self.ports[i]}"\n' + logging
                    + cluster
                    # the passes measure the kernels: repeats would hit
                    # the plan cache and launch nothing
                    + "[query]\nplan-cache-bytes = 0\n" + spool
                    + f'[mesh]\nplatform = "{CLUSTER_PLATFORM}"\n')
        self.configs.append(cfg)

    def add_joiner(self) -> int:
        """One more node, on a fresh data dir, that joins with --join
        through the first three (its hosts). -> its index."""
        i = len(self.ports)
        self.ports.append(_free_ports(1)[0])
        self.ids.append(f"node{i}")
        self.procs.append(None)
        self.joiners.add(i)
        self._config(i)
        return i

    def start(self, i: int) -> None:
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        out = open(os.path.join(self.tmp, f"{self.prefix}{i}.log"), "ab")
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "--config", self.configs[i]]
            + (["--join"] if i in self.joiners else []), cwd=root, env=env,
            stdout=out, stderr=subprocess.STDOUT)
        out.close()
        self.killed.discard(i)

    def wait_ready(self, i: int, t0: float, timeout: float = 120.0) -> float:
        """Seconds from t0 until node i's /status lists every node."""
        while True:
            self.check_alive()
            try:
                st = _http(self.ports[i], "GET", "/status")
                if len(st["nodes"]) == len(self.ports):
                    return time.perf_counter() - t0
            except (OSError, AssertionError, ValueError):
                pass
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"node {i} not ready after {timeout} s:"
                                     f" {self.log_tail(i)}")
            time.sleep(0.1)

    def log_tail(self, i: int) -> str:
        with open(os.path.join(self.tmp, f"{self.prefix}{i}.log"),
                  "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def check_alive(self) -> None:
        for i, p in enumerate(self.procs):
            if p is not None and i not in self.killed \
                    and p.poll() is not None:
                raise AssertionError(f"node {i} exited early ({p.returncode}"
                                     f"): {self.log_tail(i)}")

    def kill(self, i: int) -> None:
        import signal

        self.killed.add(i)
        self.procs[i].send_signal(signal.SIGKILL)
        self.procs[i].wait(timeout=30)

    def terminate(self, i: int) -> tuple:
        """SIGTERM (the node drains, then exits) -> (exit code, seconds)."""
        self.killed.add(i)
        t0 = time.perf_counter()
        self.procs[i].terminate()
        rc = self.procs[i].wait(timeout=60)
        return rc, time.perf_counter() - t0

    def stop(self) -> None:
        for p in self.procs:
            if p is not None and p.poll() is None:
                p.terminate()
        for p in self.procs:
            if p is None:
                continue
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=20)


def _node_vars(port: int) -> dict:
    return _http(port, "GET", "/debug/vars")


def _node_launches(dv: dict) -> dict:
    g = dv["gauges"]
    return {k.split("/", 1)[1]: int(v) for k, v in g.items()
            if k.startswith("kernelLaunches/")}


def make_cluster_data(n_shards: int, seed: int) -> dict:
    """Phase 5g's data at the single-node phases' widths over n_shards."""
    rng = np.random.default_rng(seed + 61)
    base = np.arange(n_shards, dtype=np.int64) * SHARD_WIDTH
    s_rows = []
    for a in range(CLUSTER_S_ROWS):
        card = 16 << a
        cols = np.repeat(base, card) + rng.integers(0, SHARD_WIDTH,
                                                    card * n_shards)
        s_rows.append(_unique(cols))
    lcols = _unique(np.repeat(base, CLUSTER_LANG_BITS) + rng.integers(
        0, SHARD_WIDTH, CLUSTER_LANG_BITS * n_shards))
    share = 1.0 / (np.arange(len(CLUSTER_LANGS)) + 1)
    lang = rng.choice(len(CLUSTER_LANGS), lcols.size, p=share / share.sum())
    return {"f": make_rows(8, n_shards, seed), "s": s_rows,
            "t": make_topn_rows(n_shards, TOPN_BITS, seed),
            "v": make_values(n_shards, 32768, seed),
            "lang": (lcols, lang)}


def _roaring_shards(rows: list, n_shards: int) -> list:
    """Per shard, the /import-roaring body of the rows' bits there."""
    edges = np.arange(n_shards + 1, dtype=np.int64) * SHARD_WIDTH
    bounds = [np.searchsorted(r, edges) for r in rows]
    out = []
    for s in range(n_shards):
        pos = np.concatenate([
            r[bounds[i][s]:bounds[i][s + 1]] - s * SHARD_WIDTH
            + i * SHARD_WIDTH for i, r in enumerate(rows)])
        out.append(json.dumps({"views": {"": _roaring_b64(pos)}}).encode())
    return out


CLUSTER_SCHEMA = [
    ("/index/d", {"options": {"trackExistence": True}}),
    ("/index/d/field/f", {}), ("/index/d/field/t", {}),
    ("/index/d/field/s", {"options": {"cacheType": "none"}}),
    ("/index/d/field/v", {"options": {"type": "int", "min": 0,
                                      "max": (1 << BSI_DEPTH) - 1}}),
    ("/index/d/field/lang", {"options": {"keys": True}}),
    ("/index/d/field/w", {"options": {"cacheType": "none"}})]


def cluster_requests(data: dict, n_shards: int) -> list:
    """(field, route, [(path, body)], parallel requests) of the load: f
    and t a shard a request over /import-roaring, s, v and lang over
    /import in chunks of CLUSTER_CHUNK shards (lang one at a time: its
    keys are minted in the order they first appear)."""
    out = []
    for name in ("f", "t"):
        reqs = [(f"/index/d/field/{name}/import-roaring/{s}", b)
                for s, b in enumerate(_roaring_shards(data[name],
                                                      n_shards))]
        out.append((name, f"/import-roaring, {n_shards} requests of one "
                          "shard", reqs, 8))
    edges = np.array(list(range(0, n_shards, CLUSTER_CHUNK)) + [n_shards],
                     dtype=np.int64) * SHARD_WIDTH

    def chunked(name: str, cols: np.ndarray, body, workers: int) -> None:
        cuts = np.searchsorted(cols, edges)
        reqs = [(f"/index/d/field/{name}/import",
                 json.dumps(body(lo, hi)).encode())
                for lo, hi in zip(cuts[:-1], cuts[1:])]
        out.append((name, f"/import (JSON), {len(reqs)} requests of up to "
                          f"{CLUSTER_CHUNK} shards", reqs, workers))

    ids, cols = shard_major(data["s"], n_shards)
    order = np.argsort(cols, kind="stable")
    ids, cols = ids[order], cols[order]
    chunked("s", cols, lambda lo, hi: {
        "rowIDs": ids[lo:hi].tolist(), "columnIDs": cols[lo:hi].tolist()}, 8)
    vcols, vvals = data["v"]
    chunked("v", vcols, lambda lo, hi: {
        "columnIDs": vcols[lo:hi].tolist(),
        "values": vvals[lo:hi].tolist()}, 8)
    lcols, lang = data["lang"]
    chunked("lang", lcols, lambda lo, hi: {
        "rowKeys": [CLUSTER_LANGS[k] for k in lang[lo:hi].tolist()],
        "columnIDs": lcols[lo:hi].tolist()}, 1)
    return out


def cluster_load(port: int, requests: list) -> dict:
    """The schema, then every request through node 0's public routes;
    node 0 forwards each part to its owners."""
    from concurrent.futures import ThreadPoolExecutor

    for path, body in CLUSTER_SCHEMA:
        _http(port, "POST", path, json.dumps(body).encode())

    def post(path_body):
        _http(port, "POST", *path_body)

    routes, seconds = {}, {}
    for name, route, reqs, workers in requests:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(post, reqs))
        seconds[name] = time.perf_counter() - t0
        routes[name] = route
    return {"routes": routes, "seconds": seconds}


def cluster_oracle(data: dict, n_shards: int) -> list:
    """[(pql, answer JSON)] of the phase's reads."""
    f_rows, t_rows, s_rows = data["f"], data["t"], data["s"]
    packed = [packed_row(c, n_shards) for c in f_rows]
    vcols, vvals = data["v"]
    lcols, lang = data["lang"]
    reads = []
    for a in range(8):
        for b in range(a + 1, 8):
            reads.append((f"Count(Intersect(Row(f={a}), Row(f={b})))",
                          _and_count(packed[a], packed[b])))
    reads.append(("Count(Intersect(Row(f=1), Row(f=2), Row(f=3)))",
                  _and_count(packed[1], packed[2], packed[3])))
    reads.append(("Row(f=5)", {"attrs": {},
                               "columns": f_rows[5].tolist()}))
    for a in (0, 3):
        m = _bit_test(packed[a], vcols)
        sel = vvals[m]
        reads += [(f"Sum(Row(f={a}), field=v)",
                   {"value": int(sel.sum()), "count": int(sel.size)}),
                  (f"Min(Row(f={a}), field=v)",
                   {"value": int(sel.min()),
                    "count": int((sel == sel.min()).sum())}),
                  (f"Max(Row(f={a}), field=v)",
                   {"value": int(sel.max()),
                    "count": int((sel == sel.max()).sum())})]
    reads.append(("Count(Range(v > 500))", int((vvals > 500).sum())))
    t_counts = np.array([r.size for r in t_rows])
    reads.append(("TopN(t, n=10)", _pairs(t_counts)[:10]))
    for a in (0, 4):
        src = np.array([_bit_test(packed[a], r).sum() for r in t_rows])
        reads.append((f"TopN(t, Row(f={a}), n=10)", _pairs(src)[:10]))
    reads.append(("Rows(field=t, limit=5)", {"rows": list(range(5))}))
    cross = {(a, r): int(_bit_test(packed[a], t_rows[r]).sum())
             for a in range(8) for r in range(len(t_rows))}
    reads.append(("GroupBy(Rows(field=f), Rows(field=t), limit=100)",
                  _groups(["f", "t"], cross)[:100]))
    for a, b in ((0, 1), (5, 2), (7, 6)):
        reads.append((f"Count(Intersect(Row(s={a}), Row(f={b})))",
                      int(_bit_test(packed[b], s_rows[a]).sum())))
    for k in (0, 9, 15):
        reads.append((f'Count(Row(lang="{CLUSTER_LANGS[k]}"))',
                      int((lang == k).sum())))
    return reads


def _check_reads(port: int, reads: list, where: str) -> float:
    t0 = time.perf_counter()
    for pql, want in reads:
        got = _http(port, "POST", "/index/d/query", pql.encode())[
            "results"][0]
        if got != want:
            raise AssertionError(f"{where}: {pql[:80]}: port "
                                 f"{str(got)[:200]} != oracle "
                                 f"{str(want)[:200]}")
    return time.perf_counter() - t0


def _cluster_captures(ports: list) -> list:
    """One device-profile capture per node, all at once."""
    out: list = [None] * len(ports)

    def cap(i):
        out[i] = _http(ports[i], "POST", "/debug/device-profile?seconds="
                       f"{CLUSTER_CAPTURE_S}")

    ts = [threading.Thread(target=cap, args=(i,)) for i in range(len(ports))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def cluster_writes(nodes: ClusterNodes, n_shards: int, seed: int,
                   count_mix: list) -> dict:
    """CLUSTER_WRITERS writers x CLUSTER_ENVELOPES envelopes of
    CLUSTER_CALLS Set/Clear on field w through nodes 0 and 1 (80 % Set of
    a fresh (row, column), 20 % Clear of one the writer set), under
    CLUSTER_READERS exact Count(Intersect) readers; one keyed envelope
    through node 2 minting CLUSTER_NEW_KEYS lang keys through the
    primary. -> the oracle's w rows (sorted columns) and the numbers."""
    rng = np.random.default_rng(seed + 71)
    ports = nodes.ports
    per_writer: list = []
    state = [set() for _ in range(CLUSTER_WRITERS)]
    for w in range(CLUSTER_WRITERS):
        envs = []
        for _ in range(CLUSTER_ENVELOPES):
            calls, flags = [], []
            for _ in range(CLUSTER_CALLS):
                mine = sorted(state[w])
                if mine and rng.random() < 0.2:
                    row, col = mine[int(rng.integers(len(mine)))]
                    state[w].discard((row, col))
                    calls.append(f"Clear({col}, w={row})")
                else:
                    while True:
                        col = int(rng.integers(0, n_shards * SHARD_WIDTH
                                               // CLUSTER_WRITERS)) \
                            * CLUSTER_WRITERS + w
                        row = int(rng.integers(CLUSTER_W_ROWS))
                        if (row, col) not in state[w]:
                            break
                    state[w].add((row, col))
                    calls.append(f"Set({col}, w={row})")
                flags.append(True)
            envs.append(("\n".join(calls).encode(), flags))
        per_writer.append(envs)
    errors: list = []
    acked = [0] * CLUSTER_WRITERS
    lat: list = []
    stop = threading.Event()
    lock = threading.Lock()

    def writer(w: int) -> None:
        port = ports[w % 2]
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for body, flags in per_writer[w]:
                got = _http(port, "POST", "/index/d/query", body, conn)[
                    "results"]
                if got != flags:
                    errors.append(f"writer {w}: changed flags differ")
                acked[w] += len(got)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"writer {w}: {e!r}")
        finally:
            conn.close()

    def reader(r: int) -> None:
        port = ports[0 if r % 2 == 0 else 2]
        rr = np.random.default_rng(seed + 500 + r)
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            while not stop.is_set():
                pql, want = count_mix[int(rr.integers(len(count_mix)))]
                t = time.perf_counter()
                got = _http(port, "POST", "/index/d/query", pql.encode(),
                            conn)["results"][0]
                with lock:
                    lat.append(time.perf_counter() - t)
                if got != want:
                    errors.append(f"reader {r}: {pql} {got} != {want}")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"reader {r}: {e!r}")
        finally:
            conn.close()

    readers = [threading.Thread(target=reader, args=(r,))
               for r in range(CLUSTER_READERS)]
    writers = [threading.Thread(target=writer, args=(w,))
               for w in range(CLUSTER_WRITERS)]
    for t in readers:
        t.start()
    t0 = time.perf_counter()
    for t in writers:
        t.start()
    for t in writers:
        t.join()
    write_s = time.perf_counter() - t0
    stop.set()
    for t in readers:
        t.join()
    if errors:
        raise AssertionError(f"{len(errors)} write-pass errors: "
                             f"{errors[:3]}")
    # one keyed envelope through node 2, which is not the primary
    base = n_shards * SHARD_WIDTH - 4096
    keyed = "\n".join(f'Set({base + i}, lang="Zz{i}")'
                      for i in range(CLUSTER_NEW_KEYS))
    t1 = time.perf_counter()
    got = _http(ports[2], "POST", "/index/d/query", keyed.encode())["results"]
    keyed_ms = (time.perf_counter() - t1) * 1e3
    if got != [True] * CLUSTER_NEW_KEYS:
        raise AssertionError(f"keyed envelope through node 2: {got[:5]}")
    rows = [[] for _ in range(CLUSTER_W_ROWS)]
    for st in state:
        for row, col in st:
            rows[row].append(col)
    w_rows = [np.array(sorted(r), dtype=np.int64) for r in rows]
    n_mut = sum(acked)
    p50, p99 = _percentiles(lat) if lat else (None, None)
    return {"w_rows": w_rows, "stats": {
        "mutations": n_mut, "write_s": write_s,
        "mutations_per_s": n_mut / write_s, "reads": len(lat),
        "read_p50_ms": p50, "read_p99_ms": p99,
        "keyed_envelope_ms": keyed_ms, "keys_minted": CLUSTER_NEW_KEYS}}


def _owned(ids: list, n_shards: int) -> dict:
    """node id -> the shards below n_shards it holds a replica of (the
    placement every node computes)."""
    from pilosa_tpu_torch.parallel.cluster import Cluster, Node

    c = Cluster(ids[0], replica_n=2)
    c.set_static([Node(i) for i in ids])
    out = {i: [] for i in ids}
    for s in range(n_shards):
        for n in c.shard_nodes("d", s):
            out[n.id].append(s)
    return out


def _primaries(ids: list, n_shards: int) -> list:
    """The nodes a read over every shard fans out to: each shard's first
    owner, sorted."""
    from pilosa_tpu_torch.parallel.cluster import Cluster, Node

    c = Cluster(ids[0], replica_n=2)
    c.set_static([Node(i) for i in ids])
    return sorted(c.shards_by_node("d", list(range(n_shards))))


def _read_back(nodes: ClusterNodes, w_rows: list, owned: dict,
               live: list) -> int:
    """Every acknowledged mutation on every owner: each node's own
    fragments (?remote=true over the shards it owns) hold exactly the
    oracle's columns there. Returns the columns compared."""
    n = 0
    for i in live:
        shards = owned[nodes.ids[i]]
        qs = "?remote=true&shards=" + ",".join(map(str, shards))
        for r, cols in enumerate(w_rows):
            want = cols[np.isin(cols // SHARD_WIDTH, shards)]
            got = _http(nodes.ports[i], "POST", f"/index/d/query{qs}",
                        f"Row(w={r})".encode())["results"][0]["columns"]
            if got != want.tolist():
                raise AssertionError(f"node {i} row w={r}: {len(got)} "
                                     f"columns held, {want.size} acked")
            n += want.size
    return n


def cluster_phase(seed: int, started: ClusterNodes | None = None,
                  gossip: "GossipPair | None" = None) -> dict:
    """Phase 5g: three port node processes serve one index (BASELINE.json
    configs[4], bench.py bench_distributed: a 3-node mapReduce), every
    answer checked against a numpy oracle through node 0 and node 2; then
    phase 5h (membership_phase) on the same nodes and the gossip pair.
    `started`, `gossip`: nodes the caller started earlier (stopped here
    too)."""
    t_phase = time.perf_counter()
    n_shards = CLUSTER_SHARDS
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pilosa_torch_cluster_") as tmp:
        nodes = started or ClusterNodes(tmp, CLUSTER_NODES)
        pair = gossip
        try:
            t_start = time.perf_counter()
            if started is None:
                for i in range(CLUSTER_NODES):
                    nodes.start(i)
            if pair is None:
                pair = GossipPair(tmp)
            # the data, the request bodies and the oracle are made while
            # the nodes start
            t0 = time.perf_counter()
            data = make_cluster_data(n_shards, seed)
            requests = cluster_requests(data, n_shards)
            reads = cluster_oracle(data, n_shards)
            log(f"  data: {n_shards} shards (cut from 1024 by the time "
                f"limit): f 8 rows, {sum(r.size for r in data['f'])} bits; "
                f"t {len(data['t'])} rows, {sum(r.size for r in data['t'])}"
                f" bits; s {CLUSTER_S_ROWS} sparse rows (K = 16..2048), "
                f"{sum(r.size for r in data['s'])} bits; v "
                f"{data['v'][0].size} values; lang {len(CLUSTER_LANGS)} "
                f"keys on {data['lang'][0].size} columns; request bodies "
                f"and an oracle of {len(reads)} reads "
                f"({time.perf_counter() - t0:.1f} s)")
            starts = [nodes.wait_ready(i, t_start)
                      for i in range(CLUSTER_NODES)]
            ports = nodes.ports
            log(f"  {CLUSTER_NODES} nodes (python -m pilosa_tpu_torch.cli "
                f"server, replicas 2, plan cache off"
                + (", started before phase 5f" if started else "")
                + ") ready " + ", ".join(f"{s:.1f}" for s in starts)
                + " s into the phase")
            builds = [_node_vars(p)["gauges"]["kernelBuild/seconds"]
                      for p in ports]
            if any(builds):
                raise AssertionError(f"a node rebuilt the kernels: {builds}")
            sent0 = _node_vars(ports[0])["gauges"][
                "internalClient/bytesSent"]
            t0 = time.perf_counter()
            load = cluster_load(ports[0], requests)
            del requests
            load_s = time.perf_counter() - t0
            fwd = _node_vars(ports[0])["gauges"][
                "internalClient/bytesSent"] - sent0
            log(f"  load through node 0: {load_s:.1f} s "
                + ", ".join(f"{k} {v:.1f} s" for k, v in
                            load["seconds"].items())
                + f"; forwarded {int(fwd)} bytes to the other owners; "
                "routes " + json.dumps(load["routes"]))
            nodes.check_alive()
            # the create-shard announcements are asynchronous: wait until
            # nodes 1 and 2 plan over every shard
            deadline = time.perf_counter() + 60
            want0 = int(data["f"][0].size)
            for i in (1, 2):
                while _http(ports[i], "POST", "/index/d/query",
                            b"Count(Row(f=0))")["results"][0] != want0:
                    if time.perf_counter() > deadline:
                        raise AssertionError(f"node {i} never learned every"
                                             " shard")
                    time.sleep(0.1)
            res_before = [_node_vars(p)["deviceResidency"]["bytes"]
                          for p in ports]
            for i in (0, 2):
                s = _check_reads(ports[i], reads, f"node {i}")
                log(f"  {len(reads)} reads through node {i}: {s:.1f} s "
                    "(oracle agrees)")
            prof = _http(ports[0], "POST", "/index/d/query?profile=true",
                         b"Count(Intersect(Row(f=0), Row(f=1)))")["profile"]
            fan = [f for f in prof["fanout"] if "transport" in f]
            if sorted(f["node"] for f in fan) != _primaries(nodes.ids,
                                                            n_shards) \
                    or "coalesced" not in {f["transport"] for f in fan}:
                raise AssertionError(f"?profile=true fan-out: {fan}")
            log(f"  ?profile=true Count: fan-out {fan}; route "
                f"{prof['route']}; {len(prof['remoteProfiles'])} remote "
                "profiles")
            count_mix = [r for r in reads if r[0].startswith(
                "Count(Intersect(Row(f=")]
            caps: list = []
            lat, wall, _ = concurrent_mix(
                ports[0], CLUSTER_CLIENTS, CLUSTER_PER_CLIENT, count_mix,
                seed + 600, lambda: caps.extend(_cluster_captures(ports)),
                index="d")
            coal = _node_vars(ports[0])["netCoalesce"]
            p50, p99 = _percentiles(lat)
            out["pass"] = {"qps": len(lat) / wall, "p50_ms": p50,
                           "p99_ms": p99,
                           "mean_coalesce_factor":
                               coal["mean_coalesce_factor"],
                           "deduped": coal["deduped_queries"],
                           "captures": [{k: c.get(k) for k in (
                               "status", "seconds", "deviceBusyMs",
                               "idleShare", "kernels")} for c in caps]}
            log(f"  concurrent: {CLUSTER_CLIENTS} clients x "
                f"{CLUSTER_PER_CLIENT} Count(Intersect) through node 0: "
                f"{len(lat) / wall:.1f} q/s, p50 {p50:.2f} ms, p99 "
                f"{p99:.2f} ms; coalesce factor "
                f"{coal['mean_coalesce_factor']}, deduped "
                f"{coal['deduped_queries']}")
            for i, c in enumerate(caps):
                if c.get("status") != "ok":
                    raise AssertionError(f"node {i} capture: {c}")
                log(f"  node {i} device-profile capture: {c.get('status')}, "
                    f"busy {c.get('deviceBusyMs')} ms, idle share "
                    f"{c.get('idleShare')} (this node's kernels only), "
                    f"kernels {c.get('kernels')}")
            out["fleet"] = fleet_checks(nodes, count_mix, n_shards)
            ab = []
            for r, mode in enumerate(CLUSTER_AB):
                _http(ports[0], "POST", "/debug/net-coalesce",
                      json.dumps({"enabled": mode == "on"}).encode())
                before = _node_vars(ports[0])["netCoalesce"]
                lat, wall, _ = concurrent_mix(
                    ports[0], CLUSTER_CLIENTS, CLUSTER_PER_CLIENT,
                    count_mix, seed + 700 + r, index="d")
                after = _node_vars(ports[0])["netCoalesce"]
                nb = after["batches"] - before["batches"]
                nq = after["batched_queries"] - before["batched_queries"]
                p50, p99 = _percentiles(lat)
                ab.append({"mode": mode, "qps": len(lat) / wall,
                           "p50_ms": p50, "p99_ms": p99,
                           "coalesce_factor": nq / nb if nb else 0.0})
                log(f"  coalescing {mode}: {len(lat) / wall:.1f} q/s, p50 "
                    f"{p50:.2f} ms, p99 {p99:.2f} ms, factor "
                    f"{ab[-1]['coalesce_factor']:.2f} (nothing claimed)")
            _http(ports[0], "POST", "/debug/net-coalesce",
                  json.dumps({"enabled": True}).encode())
            out["coalescing_ab"] = ab
            out["qos"] = cluster_qos(ports, count_mix)
            wr = cluster_writes(nodes, n_shards, seed, count_mix)
            out["writes"] = wr["stats"]
            w_rows = wr["w_rows"]
            log(f"  writes: {CLUSTER_WRITERS} writers x {CLUSTER_ENVELOPES} "
                f"x {CLUSTER_CALLS} Set/Clear through nodes 0 and 1 under "
                f"{CLUSTER_READERS} readers: "
                f"{wr['stats']['mutations_per_s']:.1f} mutations/s, readers "
                f"p50 {wr['stats']['read_p50_ms']:.2f} ms, p99 "
                f"{wr['stats']['read_p99_ms']:.2f} ms; {CLUSTER_NEW_KEYS} "
                f"keys minted through node 2 in "
                f"{wr['stats']['keyed_envelope_ms']:.1f} ms")
            owned = _owned(nodes.ids, n_shards + 64)
            n_back = _read_back(nodes, w_rows, owned, [0, 1, 2])
            log(f"  read back {n_back} acknowledged columns on both of "
                "their owners")
            new_col = (n_shards + 44) * SHARD_WIDTH + 5
            _http(ports[1], "POST", "/index/d/query",
                  f"Set({new_col}, w=0)".encode())
            w_rows[0] = np.append(w_rows[0], new_col)
            for i in range(CLUSTER_NODES):
                got = _http(ports[i], "POST", "/index/d/query",
                            b"Count(Row(w=0))")["results"][0]
                if got != w_rows[0].size:
                    raise AssertionError(f"new shard: node {i} counts {got}"
                                         f" != {w_rows[0].size}")
            log(f"  Set into the new shard {n_shards + 44} through node 1: "
                "read through every node right after its ack")
            for i in (1, 2):  # reverse lookups tail the primary's log
                _http(ports[i], "POST", "/index/d/query",
                      b"Rows(field=lang)")
            logs = [_get_raw(p, "/internal/translate/data?offset=0")
                    for p in ports]
            if any(x != logs[0] for x in logs[1:]):
                raise AssertionError(f".keys logs differ: "
                                     f"{[len(x) for x in logs]} bytes")
            log(f"  .keys logs byte-identical on every node "
                f"({len(logs[0])} bytes)")
            reads += [(f'Count(Row(lang="Zz{i}"))', 1) for i in (0, 99)]
            reads += [(f"Count(Row(w={r}))", int(w_rows[r].size))
                      for r in range(CLUSTER_W_ROWS)]
            launches = [_node_launches(_node_vars(p)) for p in ports]
            out["resident_bytes_before_drill"] = [
                _node_vars(p)["deviceResidency"]["bytes"] for p in ports]
            out["drill"] = cluster_drill(nodes, reads, count_mix, owned,
                                         w_rows, n_shards, launches)
            res_after = [_node_vars(p)["deviceResidency"]["bytes"]
                         for p in ports]
            log(f"  resident bytes per node: before the reads {res_before},"
                f" before the drill {out['resident_bytes_before_drill']}, "
                f"after {res_after}")
            out["resident_bytes_after_drill"] = res_after
            final = [_node_launches(_node_vars(p)) for p in ports]
            # node 2 restarted: its count before the kill, then after
            by_node = [final[0], final[1],
                       {k: launches[2][k] + final[2][k] for k in final[2]}]
            total = {k: sum(n[k] for n in by_node) for k in final[0]}
            log(f"  launches by node: {by_node}")
            for k in CLUSTER_KERNELS:
                if total[k] < 1:
                    raise AssertionError(f"{k} never launched on the nodes")
            dvs = [_node_vars(p) for p in ports]
            out["routes"] = [d["iciServing"] for d in dvs]
            out["hedges"] = [d["hedges"] for d in dvs]
            log(f"  routes: {out['routes']}; hedges: {out['hedges']}")
            nodes.check_alive()
            out.update(launches=total, launches_by_node=by_node,
                       start_s=starts, load_s=load_s,
                       load=load["seconds"], routes_by_field=load["routes"],
                       forwarded_bytes=int(fwd),
                       obs={"scrape": {"kernels": {}}})
            out["phase_5g_s"] = time.perf_counter() - t_phase
            log(f"phase 5h: membership changes on phase 5g's nodes "
                f"(scale-out, rolling restart, decommission) and SWIM "
                f"gossip")
            out["membership"] = membership_phase(
                nodes, pair, out["drill"].pop("_reads"), count_mix, w_rows,
                n_shards, seed)
            # the launches of phase 5h's reads and writes count too
            for k, v in out["membership"]["launches"].items():
                total[k] += v
            fleet_s = [out["fleet"]["seconds"],
                       out["drill"]["fleet"]["seconds"],
                       out["membership"]["drain"]["fleet_s"]]
            out["fleet"]["all_seconds"] = sum(fleet_s)
            log(f"fleet view checks: {sum(fleet_s):.2f} s (after the pass "
                f"{fleet_s[0]:.2f}, during the kill {fleet_s[1]:.2f}, the "
                f"drain {fleet_s[2]:.2f})")
        finally:
            nodes.stop()
            if pair is not None:
                pair.stop()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  cluster phases 5g and 5h: {out['phase_s']:.1f} s")
    return out


# ------------------------------------------------- phase 5h: membership


class GossipPair(ClusterNodes):
    """Phase 5h's gossip pair, started at once; `watch` records, in a
    thread of its own, the seconds from the start until both serve and
    until both list each other (found by gossip alone)."""

    def __init__(self, tmp: str):
        super().__init__(tmp, 2, gossip=True)
        self.t0 = time.perf_counter()
        for i in range(2):
            self.start(i)
        self.seen: dict = {}
        self._watch = threading.Thread(target=self._watcher, daemon=True)
        self._watch.start()

    def _watcher(self) -> None:
        while "members" not in self.seen \
                and time.perf_counter() - self.t0 < 600:
            try:
                sts = [_http(p, "GET", "/status") for p in self.ports]
                now = time.perf_counter() - self.t0
                self.seen.setdefault("serving", now)
                if all(len(st["nodes"]) == 2 for st in sts):
                    self.seen["members"] = now
            except (OSError, AssertionError, ValueError):
                pass
            time.sleep(0.25)

    def discovered(self, timeout: float = 120.0) -> dict:
        self._watch.join(timeout)
        if "members" not in self.seen:
            self.check_alive()
            raise AssertionError(f"gossip pair never met: {self.seen}; "
                                 f"{self.log_tail(0)}")
        return self.seen


def _raw_http(port: int, method: str, path: str, body: bytes = b"",
              headers=None, conn=None) -> tuple:
    """(status, headers, JSON body) without raising on an error status;
    on `conn` (kept open) where given."""
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return (resp.status, dict(resp.getheaders()),
                json.loads(resp.read() or b"null"))
    finally:
        if own:
            conn.close()


def _members_normal(nodes: ClusterNodes, live: list) -> bool:
    for i in live:
        try:
            st = _http(nodes.ports[i], "GET", "/status")
        except (OSError, AssertionError, ValueError):
            return False
        if st["state"] != "NORMAL" or sorted(
                n["id"] for n in st["nodes"]) != sorted(
                    nodes.ids[j] for j in live):
            return False
    return True


def _disk_shards(nodes: ClusterNodes, i: int, field: str = "") -> set:
    """The shards node i holds a fragment file of (of `field`, or of any
    field of index d), from its data dir."""
    out: set = set()
    base = os.path.join(nodes.tmp, f"n{i}", "d")
    for fname in os.listdir(base):
        if field and fname != field:
            continue
        views = os.path.join(base, fname, "views")
        if not os.path.isdir(views):
            continue
        for v in os.listdir(views):
            fdir = os.path.join(views, v, "fragments")
            if os.path.isdir(fdir):
                out.update(int(x) for x in os.listdir(fdir) if x.isdigit())
    return out


def _resize_counts(port: int) -> tuple:
    c = _node_vars(port)["counts"]
    return (c.get("resize/fragmentsCopied", 0),
            c.get("resize/bytesCopied", 0),
            c.get("resize/fragmentsDropped", 0))


def _member_traffic(nodes: ClusterNodes, count_mix: list, seed: int,
                    row: int, n_shards: int, stop: threading.Event) -> tuple:
    """MEMBER_READERS exact readers and MEMBER_WRITERS writers of single
    Sets on w's row `row` through node 0 until `stop`. A refusal by the
    RESIZING gate, node 0's 503 or a peer's relayed by node 0, is counted
    apart, not as a failure; a writer sends a refused Set again until it
    is acknowledged, as a client would (a refused write may have reached
    some replicas: only its acknowledgement makes the bit the oracle's).
    -> (threads, tallies, acknowledged columns)."""
    port = nodes.ports[0]
    tally = {"reads": 0, "reads_503": 0, "writes": 0, "writes_503": 0,
             "failed": []}
    acked: list = []
    lock = threading.Lock()

    def one(pql: str, kind: str, want=None):
        """True: answered right; None: refused by RESIZING; False:
        failed."""
        st, _, body = _raw_http(port, "POST", "/index/d/query", pql.encode())
        with lock:
            if st != 200 and "cluster state RESIZING" in str(body):
                tally[kind + "_503"] += 1
                return None
            tally[kind] += 1
            if st != 200 or (want is not None
                             and body["results"][0] != want):
                tally["failed"].append((kind, pql, st, str(body)[:200]))
                return False
        return True

    def reader(r: int) -> None:
        rr = np.random.default_rng(seed + 1100 + r)
        while not stop.is_set():
            pql, want = count_mix[int(rr.integers(len(count_mix)))]
            one(pql, "reads", want)

    def writer(w: int) -> None:
        rr = np.random.default_rng(seed + 1200 + w)
        while not stop.is_set():
            col = int(rr.integers(n_shards)) * SHARD_WIDTH + \
                int(rr.integers(SHARD_WIDTH // MEMBER_WRITERS)) * \
                MEMBER_WRITERS + w
            deadline = time.perf_counter() + 300
            while True:
                ok = one(f"Set({col}, w={row})", "writes")
                if ok is not None or time.perf_counter() > deadline:
                    break
                time.sleep(0.05)
            if ok:
                with lock:
                    acked.append(col)
            time.sleep(0.01)

    ts = [threading.Thread(target=reader, args=(r,))
          for r in range(MEMBER_READERS)]
    ts += [threading.Thread(target=writer, args=(w,))
           for w in range(MEMBER_WRITERS)]
    for t in ts:
        t.start()
    return ts, tally, acked


def membership_phase(nodes: ClusterNodes, pair: GossipPair, reads: list,
                     count_mix: list, w_rows: list, n_shards: int,
                     seed: int) -> dict:
    """Phase 5h on phase 5g's nodes (nodes 0-2, after the drill): (1) node
    3 joins with --join under readers and a writer through node 0; (2)
    node 2 drains and exits on SIGTERM under readers; (3) node 2 is
    removed through node 1; (4) the gossip pair. -> its numbers and each
    kernel's launches on the nodes during it."""
    out: dict = {}
    ports = nodes.ports
    # each node's launches before the phase (node 3's start at 0)
    base = [_node_launches(_node_vars(ports[i])) for i in range(3)]
    # (1) scale-out
    j = nodes.add_joiner()
    row = len(w_rows)
    stop = threading.Event()
    t0 = time.perf_counter()
    nodes.start(j)
    live = [0, 1, 2, j]

    def serving() -> bool:
        nodes.check_alive()
        try:
            _http(ports[j], "GET", "/status")
            return True
        except (OSError, AssertionError, ValueError):
            return False

    # the traffic starts once node 3 serves (it knocks right after), not
    # beside its process start, which it would only slow
    seen = {"serving": _poll(serving, 240, "node 3's start", 0.05)}
    ts, tally, acked = _member_traffic(nodes, count_mix, seed, row,
                                       n_shards, stop)
    try:
        normal_s = _poll(lambda: nodes.check_alive() or
                         _members_normal(nodes, live), 240,
                         "node 3's join", 0.2) + seen["serving"]
        time.sleep(MEMBER_AFTER_S)
    finally:
        stop.set()
        for t in ts:
            t.join()
    if tally["failed"]:
        raise AssertionError(f"reads or writes failed during the join: "
                             f"{tally['failed'][:3]}")
    copied = _resize_counts(ports[j])
    w_rows.append(np.array(sorted(set(acked)), dtype=np.int64))
    reads = reads + [(f"Count(Row(w={row}))", int(w_rows[row].size))]
    owned = _owned(nodes.ids, n_shards + 64)
    n_back = _read_back(nodes, w_rows, owned, live)
    secs = {i: _check_reads(ports[i], reads, f"node {i} after the join")
            for i in (j, 0)}
    for i in live:
        extra = _disk_shards(nodes, i) - set(owned[nodes.ids[i]])
        if extra:
            raise AssertionError(f"node {i} keeps fragments of shards it "
                                 f"does not own: {sorted(extra)[:8]}")
    missing = set(s for s in owned[nodes.ids[j]] if s < n_shards) - \
        _disk_shards(nodes, j, "f")
    if missing:
        raise AssertionError(f"node 3 lacks f fragments of its shards "
                             f"{sorted(missing)[:8]}")
    for i in live:
        with open(os.path.join(nodes.tmp, f"n{i}", ".topology")) as f:
            topo = json.load(f)["nodeIDs"]
        if sorted(topo) != sorted(nodes.ids):
            raise AssertionError(f"node {i}'s .topology: {topo}")
    l3 = _node_launches(_node_vars(ports[j]))
    if MEMBER_KERNELS and sum(l3[k] for k in MEMBER_KERNELS) < 1:
        raise AssertionError(f"node 3 launched no kernel: {l3}")
    ev_s = _resize_events(nodes, "join", j, [1, 2, j])
    if not _has(_feed(ports[j])[0], "node.start"):
        raise AssertionError("node 3 recorded no node.start")
    dropped = sum(_resize_counts(ports[i])[2] for i in range(3))
    out["join"] = {"serving_s": seen["serving"], "normal_s": normal_s,
                   "fragments": copied[0],
                   "bytes": copied[1], "dropped": dropped,
                   "reads": tally["reads"], "reads_503": tally["reads_503"],
                   "writes": tally["writes"],
                   "writes_503": tally["writes_503"],
                   "acked_writes": int(w_rows[row].size),
                   "read_s": secs, "launches_node3": l3}
    out["steps_s"] = {"join": time.perf_counter() - t0}
    log(f"  scale-out: node 3 (--join, empty data dir) serving "
        f"{seen['serving']:.1f} s and NORMAL with 4 members {normal_s:.1f} s"
        f" after its start (traffic on for {MEMBER_AFTER_S:.0f} s more); it"
        f" received "
        f"{copied[0]} fragments, {copied[1]} bytes; the old owners dropped "
        f"{dropped}; through node 0 meanwhile {tally['reads']} reads and "
        f"{tally['writes']} writes answered, {tally['reads_503']} reads and "
        f"{tally['writes_503']} writes refused with the RESIZING 503, 0 "
        f"failed; {w_rows[row].size} acknowledged writes read back; "
        f"{n_back} acknowledged columns on each of their owners alone; "
        f"{len(reads)} reads through node 3 in {secs[j]:.1f} s and node 0 "
        f"in {secs[0]:.1f} s, exact; every fragment on its owners only; "
        f"every .topology lists 4 ids; node 3's launches {l3}")
    # (2) rolling restart of node 2
    t_step = time.perf_counter()
    phase = {"now": "draining"}
    stop = threading.Event()
    ts, lat, failed = _drill_readers(ports[0], count_mix, 1300,
                                     DRAIN_READERS, phase, stop)
    time.sleep(0.3)
    t0 = time.perf_counter()
    st = _http(ports[2], "POST", "/cluster/drain")
    if not st["draining"]:
        raise AssertionError(f"drain: {st}")
    code, hdr, body = _raw_http(ports[2], "POST", "/index/d/query",
                                b"Count(Row(f=0))")
    if (code, hdr.get("X-Pilosa-Shed-Reason"), hdr.get("Retry-After"),
            body.get("code")) != (503, "draining", "1", "shed"):
        raise AssertionError(f"a query to the draining node: {code} {hdr} "
                             f"{body}")
    drain_s = _poll(lambda: _node_vars(ports[2])["drain"]["drained"], 60,
                    "node 2's drain", 0.05)
    dinfo = _node_vars(ports[2])["drain"]
    # drained, node 2 stays DRAINING until its process goes
    t_fleet = time.perf_counter()
    n2 = next(n for n in _http(ports[0], "GET", "/cluster/stats")["fleet"][
        "nodes"] if n["id"] == nodes.ids[2])
    if n2["state"] != "DRAINING" or n2["health"]["score"] != "yellow":
        raise AssertionError(f"/cluster/stats of the draining node: "
                             f"{n2['state']}, {n2['health']}")
    fleet_s = time.perf_counter() - t_fleet
    phase["now"] = "drained"
    _poll(lambda: len(lat.get("drained", [])) >= 2 * DRAIN_READERS, 60,
          "reads after the drain")
    stop.set()
    for t in ts:
        t.join()
    if failed:
        raise AssertionError(f"{len(failed)} reads failed around the drain:"
                             f" {failed[:3]}")
    node2 = {k: v - base[2][k] for k, v in
             _node_launches(_node_vars(ports[2])).items()}
    t_ev = time.perf_counter()
    feed2, _ = _feed(ports[2])
    if not _has(feed2, "drain.start") or not _has(feed2, "drain.complete"):
        raise AssertionError("node 2 recorded no drain.start and "
                             "drain.complete")
    for i in (0, 1, j):
        if not _has(_feed(ports[i], "?type=peer.draining")[0], "peer.draining",
                    peer=nodes.ids[2]):
            raise AssertionError(f"node {i} recorded no peer.draining of "
                                 "node 2")
    ev_s += time.perf_counter() - t_ev
    rc, term_s = nodes.terminate(2)
    if rc != 0:
        raise AssertionError(f"node 2 exited {rc} on SIGTERM: "
                             f"{nodes.log_tail(2)}")
    with open(os.path.join(nodes.tmp, "n2", "events.spool.jsonl"),
              encoding="utf-8") as f:
        last = json.loads(f.read().splitlines()[-1])
    if last["type"] != "node.stop":
        raise AssertionError(f"node 2's spool ends with {last}")
    out["drain"] = {"drained_s": drain_s, "info": dinfo, "exit": rc,
                    "sigterm_s": term_s, "fleet_s": fleet_s,
                    "reads": {k: {"n": len(v), "p50_ms":
                                  statistics.median(v)}
                              for k, v in lat.items()}}
    log(f"  rolling restart: POST /cluster/drain on node 2, drained in "
        f"{drain_s:.2f} s ({dinfo['snapshotted']} fragments snapshotted, "
        f"{dinfo['shedQueries']} queries shed: 503, X-Pilosa-Shed-Reason "
        f"draining, Retry-After 1); {DRAIN_READERS} readers through node 0 "
        f"{_lat_line(sum(lat.values(), []))}, 0 failed; /cluster/stats "
        f"through node 0: node 2 DRAINING, yellow ({n2['health']['reasons']};"
        f" {fleet_s:.2f} s); SIGTERM: exit {rc} after {term_s:.2f} s")
    out["steps_s"]["drain"] = time.perf_counter() - t_step
    # (3) decommission node 2 through node 1
    live = [0, 1, j]
    before = {i: _resize_counts(ports[i])[0] for i in live}
    t0 = time.perf_counter()
    _http(ports[1], "POST", "/cluster/resize/remove-node",
          json.dumps({"id": nodes.ids[2]}).encode())
    leave_s = _poll(lambda: _members_normal(nodes, live), 240,
                    "node 2's removal", 0.2)
    moved = sum(_resize_counts(ports[i])[0] - before[i] for i in live)
    owned3 = _owned([nodes.ids[i] for i in live], n_shards + 64)
    secs = {i: _check_reads(ports[i], reads, f"node {i} after the leave")
            for i in live}
    n_back = _read_back(nodes, w_rows, owned3, live)
    for i in live:
        pend = _node_vars(ports[i])["writeHandoffs"]["pendingTargets"]
        if nodes.ids[2] in pend:
            raise AssertionError(f"node {i} holds hints for node 2: {pend}")
        extra = _disk_shards(nodes, i) - set(owned3[nodes.ids[i]])
        if extra:
            raise AssertionError(f"node {i} keeps fragments of shards it "
                                 f"does not own: {sorted(extra)[:8]}")
    ev_s += _resize_events(nodes, "leave", 2, [1, j])
    out["leave"] = {"normal_s": leave_s, "fragments": moved,
                    "read_s": secs}
    log(f"  decommission: remove-node node 2 through node 1, nodes 0, 1 "
        f"and 3 NORMAL with 3 members after {leave_s:.1f} s; {moved} "
        f"fragments moved; {n_back} acknowledged columns on each owner "
        f"alone; no peer holds hints for node 2; {len(reads)} reads "
        "through each survivor exact in " + ", ".join(
            f"{v:.1f}" for v in secs.values()) + " s")
    by_node = [node2]
    for i in (0, 1, j):
        now = _node_launches(_node_vars(ports[i]))
        by_node.append({k: now[k] - (base[i][k] if i < 3 else 0)
                        for k in now})
    out["steps_s"]["leave"] = time.perf_counter() - t0
    t_ev = time.perf_counter()
    out["timeline"] = member_timeline(nodes, [0, 1, j])
    ev_s += time.perf_counter() - t_ev
    t_step = time.perf_counter()
    out["gossip"] = gossip_checks(pair, seed)
    out["steps_s"]["gossip"] = time.perf_counter() - t_step
    by_node += out["gossip"].pop("launches_by_node")
    out["event_checks_s"] = ev_s + out["gossip"]["event_checks_s"]
    log(f"  event checks of phase 5h: drain.start and drain.complete on "
        f"node 2, peer.draining on nodes 0, 1 and 3, node 2's spool ending "
        f"with node.stop after its SIGTERM; resize.start and "
        f"resize.complete on the coordinator for the join and the leave, "
        f"topology.change on the other members, node 3's node.start; "
        f"g0's gossip peer.down of g1; {out['event_checks_s']:.2f} s")
    out["launches"] = {k: sum(n[k] for n in by_node) for k in node2}
    log(f"  launches in phase 5h (nodes 0-3 and the gossip pair): "
        f"{out['launches']}; seconds by step: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out["steps_s"].items()))
    return out


def gossip_checks(pair: GossipPair, seed: int) -> dict:
    """The gossip pair: found by gossip alone (seconds); a row over
    GOSSIP_SHARDS shards imported through g0 counted exactly through g0
    and g1, both launching; g1 killed and marked down by g0's suspicion
    (seconds); a Count through g0 exact while DEGRADED; the cipher's
    seconds a datagram in g0's process."""
    seen = pair.discovered()
    p0, p1 = pair.ports
    rng = np.random.default_rng(seed + 1400)
    rows = {r: _unique(rng.integers(0, GOSSIP_SHARDS * SHARD_WIDTH,
                                      200_000 // r)) for r in (1, 2)}
    _http(p0, "POST", "/index/d", b"{}")
    _http(p0, "POST", "/index/d/field/f", b"{}")
    for r, cols in rows.items():
        _http(p0, "POST", "/index/d/field/f/import", json.dumps(
            {"rowIDs": [r] * cols.size, "columnIDs": cols.tolist()}).encode())
    want = int(np.intersect1d(rows[1], rows[2]).size)
    q = b"Count(Intersect(Row(f=1), Row(f=2)))"
    for p in pair.ports:
        got = _http(p, "POST", "/index/d/query", q)["results"][0]
        if got != want:
            raise AssertionError(f"gossip pair: {got} != {want}")
    by_node = [_node_launches(_node_vars(p)) for p in pair.ports]
    launched = [sum(n[k] for k in MEMBER_KERNELS) for n in by_node]
    if MEMBER_KERNELS and min(launched) < 1:
        raise AssertionError(f"gossip pair launches: {launched}")
    g = _node_vars(p0)["gossip"]
    _, g1_stamp = _feed(p1)  # the last stamp g1 sent before its kill
    t0 = time.perf_counter()
    pair.kill(1)
    down_s = _poll(lambda: _http(p0, "GET", "/status")["state"]
                   == "DEGRADED", 60, "g1 marked down by gossip", 0.05)
    t_ev = time.perf_counter()
    downs, g0_stamp = _feed(p0, "?type=peer.down")
    if not _has(downs, "peer.down", peer="g1", detector="gossip") \
            or g0_stamp < g1_stamp:
        raise AssertionError(f"g0: peer.down {downs}, its stamp {g0_stamp}"
                             f" < g1's {g1_stamp}")
    ev_s = time.perf_counter() - t_ev
    got = _http(p0, "POST", "/index/d/query", q)["results"][0]
    if got != want:
        raise AssertionError(f"g0 while DEGRADED: {got} != {want}")
    g2 = _node_vars(p0)["gossip"]
    seal_ms = 1e3 * g2["sealSeconds"] / max(g2["sealed"], 1)
    open_ms = 1e3 * g2["openSeconds"] / max(g2["opened"], 1)
    stdlib = stdlib_cipher_ms()
    out = {"serving_s": seen["serving"], "members_s": seen["members"],
           "down_s": down_s, "launches": launched,
           "launches_by_node": by_node,
           "seal_ms": seal_ms, "open_ms": open_ms,
           "cipher_backend": g2["cipherBackend"], "stdlib": stdlib,
           "sealed": g2["sealed"], "opened": g2["opened"],
           "crypto_drops": g2["cryptoDrops"], "encrypted": g["encrypted"],
           "event_checks_s": ev_s}
    log(f"  gossip (period {GOSSIP_PERIOD} s, AES-GCM with a shared "
        f"secret): g0 and g1 serving {seen['serving']:.1f} s after their "
        f"start, members of each other {seen['members']:.1f} s after it, "
        f"by gossip alone; Count(Intersect) over {GOSSIP_SHARDS} shards "
        f"exact through both ({want}), launches {launched}; SIGKILL g1: "
        f"g0 DEGRADED after {down_s:.2f} s, its Count still exact; the "
        f"cipher in g0's process ({g2['cipherBackend']}): seal "
        f"{seal_ms:.3f} ms, open {open_ms:.3f} ms a datagram "
        f"({g2['sealed']} sealed, {g2['opened']} opened, "
        f"{g2['cryptoDrops']} dropped); the standard-library cipher here: "
        f"seal {stdlib['seal_ms']:.3f} ms, open {stdlib['open_ms']:.3f} ms "
        f"a {stdlib['bytes']}-byte datagram")
    return out


def stdlib_cipher_ms(n_bytes: int = 400, runs: int = 50) -> dict:
    """The pure-Python AES-GCM's seal and open ms on a datagram of
    n_bytes, on this host (the path a node takes where the
    `cryptography` package cannot be imported)."""
    from pilosa_tpu_torch.utils import aesgcm

    lib = aesgcm._LibAESGCM
    aesgcm._LibAESGCM = None
    try:
        key = aesgcm.AESGCM(aesgcm.derive_key(GOSSIP_SECRET))
    finally:
        aesgcm._LibAESGCM = lib
    data = bytes(range(256)) * (n_bytes // 256) + bytes(n_bytes % 256)
    t0 = time.perf_counter()
    sealed = [aesgcm.seal(key, data) for _ in range(runs)]
    t1 = time.perf_counter()
    for d in sealed:
        if aesgcm.open_sealed(key, d) != data:
            raise AssertionError("the standard-library cipher")
    t2 = time.perf_counter()
    return {"bytes": n_bytes, "seal_ms": 1e3 * (t1 - t0) / runs,
            "open_ms": 1e3 * (t2 - t1) / runs}


def _drill_readers(port: int, count_mix: list, seed: int, n: int,
                   phase: dict, stop: threading.Event) -> tuple:
    """n reader threads of count_mix through one node; each read's
    latency lands under the phase current when it started. -> (threads,
    {phase: [ms]}, failed)."""
    lat: dict = {}
    failed: list = []
    lock = threading.Lock()

    def reader(r: int) -> None:
        rr = np.random.default_rng(seed + r)
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            while not stop.is_set():
                pql, want = count_mix[int(rr.integers(len(count_mix)))]
                at = phase["now"]
                t = time.perf_counter()
                try:
                    got = _http(port, "POST", "/index/d/query",
                                pql.encode(), conn)["results"][0]
                    ok = got == want
                except Exception as e:  # noqa: BLE001 — counted
                    ok, got = False, repr(e)
                    conn.close()
                    conn = http.client.HTTPConnection("localhost", port,
                                                      timeout=600)
                with lock:
                    lat.setdefault(at, []).append(
                        (time.perf_counter() - t) * 1e3)
                    if not ok:
                        failed.append((at, pql, str(got)[:200]))
        finally:
            conn.close()

    ts = [threading.Thread(target=reader, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    return ts, lat, failed


def _lat_line(ms: list) -> str:
    if not ms:
        return "none"
    return (f"{len(ms)} reads, p50 {statistics.median(ms):.2f} ms, slowest "
            f"{max(ms):.1f} ms")


def _outage_writes(nodes: ClusterNodes, shards: list, seed: int) -> tuple:
    """CLUSTER_OUTAGE_WRITERS writers through nodes 0 and 1, each
    CLUSTER_OUTAGE_ENVELOPES envelopes of CLUSTER_OUTAGE_CALLS Sets and
    CLUSTER_OUTAGE_BITS single Sets on w's outage row, into `shards`.
    -> (sorted columns written, mutations acknowledged, seconds)."""
    rng = np.random.default_rng(seed + 81)
    n_w = CLUSTER_OUTAGE_WRITERS
    per_writer = []
    cols_all = []
    row = CLUSTER_W_ROWS
    for w in range(n_w):
        n = CLUSTER_OUTAGE_ENVELOPES * CLUSTER_OUTAGE_CALLS + \
            CLUSTER_OUTAGE_BITS
        sh = np.asarray(shards, dtype=np.int64)[rng.integers(0, len(shards),
                                                             n)]
        offs = rng.choice(SHARD_WIDTH // n_w, n, replace=False) * n_w + w
        cols = sh * SHARD_WIDTH + offs
        cols_all.append(cols)
        k = CLUSTER_OUTAGE_ENVELOPES * CLUSTER_OUTAGE_CALLS
        bodies = ["\n".join(f"Set({c}, w={row})" for c in
                            cols[e * CLUSTER_OUTAGE_CALLS:
                                 (e + 1) * CLUSTER_OUTAGE_CALLS].tolist())
                  for e in range(CLUSTER_OUTAGE_ENVELOPES)]
        bodies += [f"Set({c}, w={row})" for c in cols[k:].tolist()]
        per_writer.append(bodies)
    errors: list = []
    acked = [0] * n_w

    def writer(w: int) -> None:
        port = nodes.ports[w % 2]
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            for body in per_writer[w]:
                got = _http(port, "POST", "/index/d/query", body.encode(),
                            conn)["results"]
                if got != [True] * (body.count("\n") + 1):
                    errors.append(f"writer {w}: {got[:4]}")
                acked[w] += len(got)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"writer {w}: {e!r}")
        finally:
            conn.close()

    ts = [threading.Thread(target=writer, args=(w,)) for w in range(n_w)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    secs = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"outage writes not acknowledged: {errors[:3]}")
    return np.sort(np.concatenate(cols_all)), sum(acked), secs


def _poll(cond, timeout: float, what: str, step: float = 0.1) -> float:
    """Seconds until cond() holds (checked every `step`)."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not after {timeout} s")
        time.sleep(step)
    return time.perf_counter() - t0


def cluster_drill(nodes: ClusterNodes, reads: list, count_mix: list,
                  owned: dict, w_rows: list, n_shards: int,
                  launches: list) -> dict:
    """Phase 5g's node-death drill. (1) SIGKILL node 2 under readers
    through node 0: nodes 0 and 1 mark it down by probing, and reads
    started after the mark take no failover. (2) Writes through nodes 0
    and 1 into node 2's shards, one none of the data holds yet included,
    and a Clear of a loaded bit are acknowledged with hints. (3) A bit
    planted on node 1 alone in a shard it shares with node 0; one of node
    2's fragment files truncated inside its snapshot. (4) Node 2
    restarted on its data dir: the file quarantined, the read fence
    armed, reads through it exact and re-routed, the peers' hints
    replayed, the fence lifted, the file rebuilt from its replica. (5)
    Node 2's first anti-entropy pass; the planted bit carried to node 0;
    every outage write and the planted bit read back from each owner
    alone, the cleared bit from neither; every read through node 2."""
    ports = nodes.ports
    ids = nodes.ids
    out: dict = {}
    # (1) the death and the mark-down
    phase = {"now": "before"}
    stop = threading.Event()
    ts, lat, failed = _drill_readers(ports[0], count_mix, 900,
                                     CLUSTER_DRILL_READERS, phase, stop)
    time.sleep(0.5)
    launches[2] = _node_launches(_node_vars(ports[2]))
    t_kill = time.perf_counter()
    nodes.kill(2)
    phase["now"] = "after_kill"
    marks: list = [None, None]

    def degraded(i: int) -> bool:
        if marks[i] is None and \
                _http(ports[i], "GET", "/status")["state"] == "DEGRADED":
            marks[i] = time.perf_counter() - t_kill
            if i == 0:
                phase["now"] = "after_mark"
        return marks[i] is not None

    _poll(lambda: degraded(0) & degraded(1), 60, "mark-down", 0.02)
    _poll(lambda: len(lat.get("after_mark", [])) >= 2 * CLUSTER_DRILL_READERS,
          60, "reads after the mark")
    stop.set()
    for t in ts:
        t.join()
    if failed:
        raise AssertionError(f"{len(failed)} reads failed around the kill: "
                             f"{failed[:3]}")
    profs = [_http(ports[0], "POST", "/index/d/query?profile=true",
                   count_mix[k][0].encode())["profile"] for k in range(4)]
    failover = [f for p in profs for f in p["fanout"]
                if f.get("kind") == "failover" or f["node"] == ids[2]]
    if failover:
        raise AssertionError(f"reads after the mark still fail over: "
                             f"{failover[:2]}")
    out["fleet"] = fleet_during_kill(ports, ids)
    out["mark_s"] = marks
    out["reads"] = {k: {"n": len(v), "p50_ms": statistics.median(v),
                        "max_ms": max(v)} for k, v in lat.items()}
    log(f"  SIGKILL node 2 under {CLUSTER_DRILL_READERS} readers through "
        f"node 0: marked down by node 0 after {marks[0]:.2f} s, by node 1 "
        f"after {marks[1]:.2f} s; 0 failed reads; before the kill "
        f"{_lat_line(lat.get('before', []))}; after the kill, before the "
        f"mark {_lat_line(lat.get('after_kill', []))}; after the mark "
        f"{_lat_line(lat['after_mark'])}; 4 ?profile=true Counts after the "
        "mark: no failover record, node 2 in no fan-out")
    # (2) writes during the outage
    node2 = ids[2]
    shards2 = [s for s in owned[node2] if s < n_shards]
    fresh = next(s for s in owned[node2] if s > n_shards + 44)
    cols, n_mut, write_s = _outage_writes(nodes, shards2 + [fresh], 0)
    hints = [_node_vars(p)["writeHandoffs"] for p in ports[:2]]
    if any(h["queued"] < 1 for h in hints):
        raise AssertionError(f"no hints queued: {hints}")
    w_rows.append(cols)
    for i in (0, 1):
        got = _http(ports[i], "POST", "/index/d/query",
                    f"Count(Row(w={CLUSTER_W_ROWS}))".encode())["results"][0]
        if got != cols.size:
            raise AssertionError(f"outage row through node {i}: {got} != "
                                 f"{cols.size}")
    # a Clear of a loaded bit in a shard of nodes 1 and 2, through node 0,
    # which owns none of it: node 2's hint for it is held by a non-owner
    w0 = w_rows[0]
    clr_shard = next(s for s in shards2 if s in owned[ids[1]]
                     and np.any(w0 // SHARD_WIDTH == s))
    clr = int(w0[w0 // SHARD_WIDTH == clr_shard][0])
    got = _http(ports[0], "POST", "/index/d/query",
                f"Clear({clr}, w=0)".encode())["results"]
    if got != [True]:
        raise AssertionError(f"outage Clear({clr}, w=0): {got}")
    w_rows[0] = w0[w0 != clr]
    reads = [(q, int(w_rows[0].size) if q == "Count(Row(w=0))" else want)
             for q, want in reads]
    out["outage_writes"] = {
        "mutations": n_mut, "seconds": write_s,
        "mutations_per_s": n_mut / write_s,
        "hints_pending_bytes": [h["pendingBytes"] for h in hints],
        "hints_queued": [h["queued"] for h in hints]}
    log(f"  outage writes: {CLUSTER_OUTAGE_WRITERS} writers x "
        f"({CLUSTER_OUTAGE_ENVELOPES} envelopes of {CLUSTER_OUTAGE_CALLS} "
        f"Sets + {CLUSTER_OUTAGE_BITS} single Sets) through nodes 0 and 1 "
        f"into node 2's shards (new shard {fresh} included): {n_mut} "
        f"acknowledged, 0 refused, {n_mut / write_s:.1f} /s; hints queued "
        f"{[h['queued'] for h in hints]}, pending "
        f"{[h['pendingBytes'] for h in hints]} bytes on nodes 0 and 1; "
        f"Clear({clr}, w=0) of a loaded bit (shard {clr_shard}, owners node1"
        " and node2) through node 0 acknowledged")
    # (3) a planted divergence and a damaged file
    plant_shard = next(s for s in range(n_shards + 64)
                       if {i for i in owned if s in owned[i]}
                       == {ids[0], ids[1]})
    plant = plant_shard * SHARD_WIDTH + 123457
    plant_row = CLUSTER_W_ROWS + 1
    _http(ports[1], "POST",
          f"/index/d/query?remote=true&shards={plant_shard}",
          f"Set({plant}, w={plant_row})".encode())
    held0 = _http(ports[0], "POST",
                  f"/index/d/query?remote=true&shards={plant_shard}",
                  f"Row(w={plant_row})".encode())["results"][0]["columns"]
    if held0:
        raise AssertionError(f"the planted bit is on node 0: {held0}")
    w_rows.append(np.array([plant], dtype=np.int64))
    bad_shard = shards2[len(shards2) // 2]
    bad = os.path.join(nodes.tmp, "n2", "d", "f", "views", "standard",
                       "fragments", str(bad_shard))
    size = os.path.getsize(bad)
    with open(bad, "r+b") as fh:
        fh.truncate(size // 2)
    log(f"  planted Set({plant}, w={plant_row}) on node 1 alone (shard "
        f"{plant_shard}, owners node0 and node1); truncated node 2's "
        f"fragment d/f/standard/{bad_shard} from {size} to {size // 2} bytes")
    # (4) the return
    base_passes = [_node_vars(p)["counts"].get("antiEntropy/passes", 0)
                   for p in ports[:2]] + [0]
    t0 = time.perf_counter()
    nodes.start(2)
    restart_s = nodes.wait_ready(2, t0)
    phase2 = {"now": "fenced"}
    stop2 = threading.Event()
    ts2, lat2, failed2 = _drill_readers(ports[2], count_mix, 950, 2, phase2,
                                        stop2)
    dv2 = _node_vars(ports[2])
    dmg = [d for d in dv2.get("damagedFragments", [])
           if d["shard"] == bad_shard and d["field"] == "f"]
    fenced = dv2["counts"].get("readFence/fenced", 0)
    if not dmg or not dmg[0]["quarantinePath"] or not fenced:
        raise AssertionError(f"node 2 back: quarantined {dmg}, fenced "
                             f"{fenced}")
    stamps: dict = {}

    def returned() -> bool:
        now = time.perf_counter() - t0
        if "hints" not in stamps and all(
                _node_vars(p)["writeHandoffs"]["pendingBytes"] == 0
                for p in ports[:2]):
            stamps["hints"] = now
        dv = _node_vars(ports[2])
        if "fence" not in stamps and dv.get(
                "readFence", {"fencedShards": 0})["fencedShards"] == 0:
            stamps["fence"] = now
            phase2["now"] = "lifted"
        if "rebuild" not in stamps and any(
                d["shard"] == bad_shard and d["rebuiltFrom"]
                for d in dv.get("damagedFragments", [])):
            stamps["rebuild"] = now
        return len(stamps) == 3

    _poll(returned, 180, "node 2's return", 0.5)
    _poll(lambda: len(lat2.get("lifted", [])) >= 2, 60, "reads after lift")
    stop2.set()
    for t in ts2:
        t.join()
    fence = _node_vars(ports[2]).get("readFence", {"rerouted": 0,
                                                   "refusedRemote": 0})
    if failed2 or not fence["rerouted"]:
        raise AssertionError(f"reads through node 2 while fenced: failed "
                             f"{failed2[:3]}, fence {fence}")
    replayed = [_node_vars(p)["writeHandoffs"]["replayed"] for p in ports[:2]]
    out["return"] = {"ready_s": restart_s, "hints_replayed_s": stamps["hints"],
                     "fence_lifted_s": stamps["fence"],
                     "rebuilt_s": stamps["rebuild"], "fenced": fenced,
                     "fence": fence, "replayed": replayed,
                     "reads": {k: {"n": len(v),
                                   "p50_ms": statistics.median(v),
                                   "max_ms": max(v)}
                               for k, v in lat2.items()}}
    log(f"  node 2 restarted: ready after {restart_s:.1f} s (d/f/standard/"
        f"{bad_shard} quarantined, {fenced} shards fenced); hints replayed "
        f"{replayed} by {stamps['hints']:.1f} s; fence lifted at "
        f"{stamps['fence']:.1f} s ({fence['rerouted']} fenced shard reads "
        f"re-routed, {fence['refusedRemote']} remote reads refused); file "
        f"rebuilt at {stamps['rebuild']:.1f} s; reads through node 2 while "
        f"fenced {_lat_line(lat2.get('fenced', []))}, after "
        f"{_lat_line(lat2['lifted'])}, 0 failed")
    # (5) anti-entropy and the read-back from each owner alone: node 2's
    # first pass (its rebuild ran in it) and the planted bit on node 0
    t1 = time.perf_counter()
    _poll(lambda: _node_vars(ports[2])["counts"].get("antiEntropy/passes", 0)
          > 0, 60, "node 2's first scrub pass", 0.2)
    pass_s = time.perf_counter() - t1
    dvs = [_node_vars(p) for p in ports]
    scrub = [{"pass_s": d["gauges"].get("antiEntropy/lastPassSeconds"),
              "passes": d["counts"].get("antiEntropy/passes", 0) - b,
              "blocks_merged": d["counts"].get("antiEntropy/blocksMerged", 0),
              "rebuilt": d["counts"].get("antiEntropy/fragmentsRebuilt", 0)}
             for d, b in zip(dvs, base_passes)]
    carried_s = _poll(lambda: plant in _http(
        ports[0], "POST", f"/index/d/query?remote=true&shards={plant_shard}",
        f"Row(w={plant_row})".encode())["results"][0]["columns"],
        60, "the planted bit on node 0", 0.2)
    n_back = _read_back(nodes, w_rows, owned, [0, 1, 2])
    reads = reads + [(f"Count(Row(w={CLUSTER_W_ROWS}))", int(cols.size)),
                     (f"Count(Row(w={plant_row}))", 1)]
    s = _check_reads(ports[2], reads, "node 2 after its return")
    out["_reads"] = reads
    out["scrub"] = scrub
    out["planted_carried_s"] = carried_s
    log(f"  anti-entropy (interval {CLUSTER_AE_INTERVAL} s): node 2's "
        f"first pass within {pass_s:.1f} s of the heal; passes since the "
        f"restart {[x['passes'] for x in scrub]}, last pass seconds "
        + ", ".join("none" if x["pass_s"] is None else f"{x['pass_s']:.2f}"
                    for x in scrub)
        + f"; blocks merged {[x['blocks_merged'] for x in scrub]}; the "
        f"planted bit on node 0 after {carried_s:.1f} s more; read back "
        f"{n_back} acknowledged columns (every outage write and the planted "
        f"bit included, the cleared bit absent) from each owner alone; "
        f"{len(reads)} reads through node 2 in {s:.1f} s, exact")
    out["events"] = drill_events(nodes, bad_shard, reads)
    return out


# ------------------------------------------------- the fleet view


def _get_text(port: int, path: str) -> tuple:
    """(status, content type, body text) of a GET."""
    conn = http.client.HTTPConnection("localhost", port, timeout=600)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Content-Type", ""),
                resp.read().decode())
    finally:
        conn.close()


def _advice_lines(text: str) -> list:
    """Rendered advice without its decaying numbers (scores, reads a
    second and the fleet skew fall between two reads of a quiet node)."""
    import re

    return [re.sub(r"(score|reads/s|fleet)=\S+", r"\1=", line)
            for line in text.splitlines()]


def _spool_spans(path: str) -> list:
    """Every span of a Jaeger spool (one JSON batch a line; a line cut
    by a flush in progress is the last one and is skipped)."""
    if not os.path.exists(path):
        return []
    spans = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            try:
                spans += json.loads(line)["spans"]
            except ValueError:
                break
    return spans


def _trace_tree(spans: list, root_node: str, peers: list) -> bool:
    """One trace's spans hold a pilosa.query root of root_node, a
    fanout.<peer> span under it for every peer, and a pilosa.query span
    of that peer under its fan-out span."""

    def tags(s: dict) -> dict:
        return {t["key"]: t["value"] for t in s["tags"]}

    def parent(s: dict) -> str:
        return s["references"][0]["spanID"] if s["references"] else ""

    roots = [s for s in spans if s["operationName"] == "pilosa.query"
             and not parent(s)]
    if len(roots) != 1 or tags(roots[0]).get("node") != root_node:
        return False
    root = roots[0]["spanID"]
    for peer in peers:
        fan = {s["spanID"] for s in spans
               if s["operationName"] == f"fanout.{peer}"
               and parent(s) == root}
        if not any(s["operationName"] == "pilosa.query"
                   and tags(s).get("node") == peer and parent(s) in fan
                   for s in spans):
            return False
    return True


def fleet_checks(nodes: ClusterNodes, count_mix: list, n_shards: int,
                 field_f: tuple = ("d", "f", "standard")) -> dict:
    """Phase 5g's fleet-view checks through node 0, right after the pass
    (nothing else runs meanwhile): four ?profile=true Count(Intersect)
    exported to node 0's spool as one tree a trace, every node's
    pilosa.query grafted under its fan-out span; /cluster/stats every
    node green with the card's allocator bytes at least its resident
    bytes; /cluster/hbm's totals the sums of the nodes' /debug/hbm (read
    before and after it, and again while any node's residency moved);
    /cluster/heat's fragments the union of the nodes' /debug/heat?top=0
    with their cumulative charges summed; /cluster/usage's per-principal
    queries the sums of the nodes' /debug/usage; /debug/heat?advice=true
    with a pin set among f's fragments, eviction candidates with uploads,
    and advice equal to advise() of its own document; the dashboard with
    no http(s) URL and every route it fetches answering 200; the advise
    subcommand exiting 0 with the same recommendations. -> what was read,
    and the seconds it took."""
    from pilosa_tpu_torch.analysis.advisor import advise, render_advice
    from pilosa_tpu_torch.utils.heat import FIELDS, merge_heat_docs

    t0 = time.perf_counter()
    ports, ids = nodes.ports[:3], nodes.ids[:3]
    primaries = _primaries(ids, n_shards)
    peers = [i for i in primaries if i != ids[0]]
    out: dict = {}
    # (1) profiled queries: node 0 exports each finished tree
    traces = [_http(ports[0], "POST", "/index/d/query?profile=true",
                    count_mix[k][0].encode())["profile"]["traceId"]
              for k in range(4)]
    # (2) the fleet document
    fleet = _http(ports[0], "GET", "/cluster/stats")["fleet"]
    hbm = [_http(p, "GET", "/debug/hbm?top=0") for p in ports]
    by_id = {n["id"]: n for n in fleet["nodes"]}
    if [n["id"] for n in fleet["nodes"]] != ids or fleet["health"] != \
            "green" or fleet["counts"] != {"green": 3}:
        raise AssertionError(f"/cluster/stats: {fleet['health']}, "
                             f"{fleet['counts']}, "
                             f"{[n['id'] for n in fleet['nodes']]}")
    in_use = []
    for i, nid in enumerate(ids):
        n = by_id[nid]
        if n["state"] != "NORMAL" or n["xla"] is not None \
                or "kernels.dispatches_per_s" not in n["gauges"]:
            raise AssertionError(f"/cluster/stats {nid}: {n['state']}, "
                                 f"{n['xla']}, {sorted(n['gauges'])}")
        mem = [d["memoryStats"] for d in n["deviceMemory"]]
        # the sampler's device-memory gauge, and the allocator now
        if CLUSTER_PLATFORM == "" and (
                len(mem) != 1 or "device.bytes_in_use" not in n["gauges"]
                or mem[0]["bytes_in_use"] < hbm[i]["residentBytes"]):
            raise AssertionError(f"{nid}: device memory {mem}, resident "
                                 f"{hbm[i]['residentBytes']}")
        in_use.append(mem[0]["bytes_in_use"] if mem else None)
    out["stats"] = {"health": fleet["health"], "bytes_in_use": in_use,
                    "resident": [d["residentBytes"] for d in hbm]}
    # (3) the fleet's residency: a node whose residency moved between the
    # reads around /cluster/hbm makes the reading start again

    def moved(a: list, b: list) -> bool:
        return [(d["residentBytes"], d["entries"], d["planCacheBytes"])
                for d in a] != [(d["residentBytes"], d["entries"],
                                 d["planCacheBytes"]) for d in b]

    for attempt in range(3):
        before = hbm if attempt == 0 else [
            _http(p, "GET", "/debug/hbm?top=0") for p in ports]
        doc = _http(ports[0], "GET", "/cluster/hbm")
        hbm = [_http(p, "GET", "/debug/hbm?top=0") for p in ports]
        if not moved(before, hbm):
            break
    else:
        raise AssertionError("residency moved in every /cluster/hbm read")
    want = {f: sum(int(d.get(f, 0) or 0) for d in hbm)
            for f in doc["totals"]}
    if doc["totals"] != want or _fleet_status(doc) != dict.fromkeys(
            ids, "ok") or sorted(doc["byNode"]) != sorted(ids):
        raise AssertionError(f"/cluster/hbm totals {doc['totals']} != "
                             f"{want}; nodes {doc['nodes']}")
    card = in_use and by_id[ids[0]]["deviceMemory"]
    limit = card[0]["memoryStats"]["bytes_limit"] if card else 0
    out["hbm"] = {"totals": doc["totals"], "attempts": attempt + 1,
                  "card_bytes": limit,
                  "budget_over_card": (doc["totals"]["budgetBytes"] / limit
                                       if limit else None)}
    # (4) the fleet's heat: cumulative charges summed over the replicas
    # (the scores decay between the reads and are not compared)
    doc = _http(ports[0], "GET", "/cluster/heat")
    heat = {nid: _http(p, "GET", "/debug/heat?top=0")
            for nid, p in zip(ids, ports)}
    want = merge_heat_docs(heat)

    def frags(d: dict) -> dict:
        return {(e["index"], e["field"], e["view"], e["shard"]):
                (e["nodes"], [e[f] for f in FIELDS]) for e in d["hot"]}

    got_f, want_f = frags(doc), frags(want)
    if got_f != want_f or doc["totals"] != want["totals"] \
            or _fleet_status(doc) != dict.fromkeys(ids, "ok"):
        diff = sorted(set(got_f.items()) ^ set(want_f.items()))[:4]
        raise AssertionError(f"/cluster/heat: {len(got_f)} fragments "
                             f"against {len(want_f)}, e.g. {diff}; "
                             f"nodes {doc['nodes']}")
    replicated = sum(1 for n, _ in got_f.values() if n > 1)
    out["heat"] = {"fragments": len(got_f), "on_two_nodes": replicated,
                   "hot": doc["hotFragments"], "skew": doc["skew"]}
    # (5) the fleet's usage
    doc = _http(ports[0], "GET", "/cluster/usage")
    usage = [_http(p, "GET", "/debug/usage")["principals"] for p in ports]
    want = {}
    for u in usage:
        for name, e in u.items():
            want[name] = want.get(name, 0.0) + e["queries"]
    got = {name: e["queries"] for name, e in doc["principals"].items()}
    if got != want or _fleet_status(doc) != dict.fromkeys(ids, "ok"):
        raise AssertionError(f"/cluster/usage queries {got} != {want}")
    out["usage"] = got
    # (6) the advice, held against advise() of its own document
    doc = _http(ports[0], "GET", "/debug/heat?advice=true&top=0")
    advice = doc["advice"]
    pins = {(e["index"], e["field"], e["view"], e["shard"])
            for e in advice["hbmPinSet"]}
    f_frags = {(*field_f, s) for s in range(n_shards)}
    res = advice["residency"]
    again = advise(doc, residency=res, budget_bytes=res["budget"])
    # node 0 reads f's fragments of the shards it is the first owner of
    # (none of 4 shards in a CPU rehearsal)
    if (ids[0] in primaries and not pins) or not pins <= f_frags or any(
            e["uploads"] <= 0 for e in advice["evictionCandidates"]) \
            or again != advice:
        raise AssertionError(f"/debug/heat?advice=true: pins {sorted(pins)}"
                             f", evictions {advice['evictionCandidates']}, "
                             f"advise() equal: {again == advice}")
    out["advice"] = {"pins": len(pins),
                     "evictions": len(advice["evictionCandidates"]),
                     "tiers": {k: advice["tiers"][k]
                               for k in ("hbm", "host", "cold")}}
    # (7) the dashboard and every route it fetches
    import re

    st, ctype, html = _get_text(ports[0], "/debug/dashboard")
    urls = re.findall(r"https?://", html, re.IGNORECASE)
    paths = re.findall(r'fetch\("([^"]+)"', html)
    if st != 200 or not ctype.startswith("text/html") or urls or not paths:
        raise AssertionError(f"/debug/dashboard: {st} {ctype}, URLs {urls},"
                             f" fetches {paths}")
    for path in paths:
        _http(ports[0], "GET", path + ("0" if path.endswith("=") else ""))
    # (8) the advise subcommand against node 0
    t_cli = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cli = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "advise", "--host",
         f"http://127.0.0.1:{ports[0]}"], cwd=root, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=root))
    cli_s = time.perf_counter() - t_cli
    now = _http(ports[0], "GET", "/debug/heat?advice=true&top=0")["advice"]
    if cli.returncode != 0 or _advice_lines(cli.stdout.rstrip("\n")) != \
            _advice_lines(render_advice(now)):
        raise AssertionError(f"advise: exit {cli.returncode}, "
                             f"{cli.stdout[:600]!r} {cli.stderr[-600:]!r}")
    # (9) node 0's spool: one tree per profiled trace (flushed every 2 s)
    spool = os.path.join(nodes.tmp, "n0", TRACE_SPOOL)
    trees: dict = {}

    def exported() -> bool:
        spans = _spool_spans(spool)
        for t in traces:
            mine = [s for s in spans if s["traceID"] == t]
            if _trace_tree(mine, ids[0], peers):
                trees[t] = len(mine)
        return len(trees) == len(traces)

    _poll(exported, 30, "the profiled traces in node 0's spool", 0.1)
    out["traces"] = list(trees.values())
    out["seconds"] = time.perf_counter() - t0
    log(f"  fleet view through node 0: /cluster/stats all green, allocator "
        f"bytes {in_use} >= resident {out['stats']['resident']}; "
        f"/cluster/hbm totals = the sums of 3 /debug/hbm "
        f"({attempt + 1} read(s)): {doc_totals(out['hbm'])}; "
        f"/cluster/heat {len(got_f)} fragments, {replicated} on two nodes, "
        f"charges summed; /cluster/usage queries {got}; advice: "
        f"{len(pins)} pinned (all f's), {len(advice['evictionCandidates'])}"
        f" eviction candidates, tiers {out['advice']['tiers']}, advise() "
        f"of its document equal; dashboard self-contained, {len(paths)} "
        f"routes it fetches answer 200; advise subcommand exit 0, same "
        f"recommendations ({cli_s:.2f} s); {len(traces)} profiled traces "
        f"in node 0's spool, spans {out['traces']}, every remote "
        f"pilosa.query under its fanout span")
    log(f"  fleet checks: {out['seconds']:.2f} s")
    return out


def doc_totals(h: dict) -> str:
    t = h["totals"]
    over = h["budget_over_card"]
    return (f"resident {t['residentBytes']}, budget {t['budgetBytes']} "
            f"({'%.3f' % over if over else 'no card'} x the card's "
            f"{h['card_bytes']} bytes), entries {t['entries']}")


def _fleet_status(doc: dict) -> dict:
    return {n["id"]: n["status"] for n in doc["nodes"]}


def fleet_during_kill(ports: list, ids: list) -> dict:
    """While node 2 is SIGKILLed and marked down: node 0's /cluster/stats
    has it red for its liveness mark, and /cluster/heat and /cluster/usage
    answer with it down and every other node ok."""
    t0 = time.perf_counter()
    fleet = _http(ports[0], "GET", "/cluster/stats")["fleet"]
    n2 = next(n for n in fleet["nodes"] if n["id"] == ids[2])
    if n2["health"] != {"score": "red",
                        "reasons": ["node marked down (liveness)"]} \
            or fleet["health"] != "red":
        raise AssertionError(f"/cluster/stats during the kill: {n2}")
    want = {ids[0]: "ok", ids[1]: "ok", ids[2]: "down"}
    for path in ("/cluster/heat", "/cluster/usage"):
        doc = _http(ports[0], "GET", path)
        if _fleet_status(doc) != want:
            raise AssertionError(f"{path} during the kill: {doc['nodes']}")
    s = time.perf_counter() - t0
    log(f"  fleet view during the kill: node 2 red (node marked down "
        f"(liveness)), /cluster/heat and /cluster/usage with node 2 down, "
        f"no error ({s:.2f} s)")
    return {"seconds": s}


# ------------------------------------------------- the event journal


def _feed(port: int, query: str = "") -> tuple:
    """(a node's /debug/events events, the stamp its response carried)."""
    from pilosa_tpu_torch.utils import events as ev

    st, h, doc = _raw_http(port, "GET", "/debug/events" + query)
    stamp = ev.decode_hlc(h.get(ev.HLC_HEADER))
    if st != 200 or stamp is None:
        raise AssertionError(f"/debug/events{query}: {st}, stamp {stamp}")
    return doc["events"], stamp


def _has(events: list, etype: str, **match) -> list:
    """The events of one type whose fields hold `match`."""
    return [e for e in events if e["type"] == etype
            and all(e.get(k) == v for k, v in match.items())]


def _log_levels(path: str, as_json: bool) -> list:
    """The level of every record of a node's log file: JSON lines, or
    "<ts> <LEVEL> <msg>" lines (a line without that head continues the
    record before it)."""
    import re

    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    if as_json:
        return [json.loads(line)["level"] for line in lines]
    levels = []
    for line in lines:
        m = re.match(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d "
                     r"(INFO|WARN|ERROR|DEBUG) ", line)
        if m is not None:
            levels.append(m.group(1))
        elif not levels:
            raise AssertionError(f"{path}: no record head: {line[:200]!r}")
    return levels


def drill_events(nodes: ClusterNodes, bad_shard: int, reads: list) -> dict:
    """Phase 5g's event checks after the drill: every response stamped;
    GET /cluster/events through node 0 with every node ok, in HLC order,
    each node's seq rising; the drill's causal chain (the peers' probe
    peer.down, then their hint.append for node 2; node 2's pre-kill events
    reloaded from its spool, before both marks; node 2's node.start,
    snapshot.quarantined of the truncated file and fence.armed after every
    append; each peer's hint.replay after the fence, before every lift of
    a shard that waited for the hints; a scrub.pass after the last lift);
    SIGQUIT to node 1: its crash file, every line of it in its feed, and
    an exact Count through it after; each node's log file parsed, its WARN
    and ERROR records as many as its log.warn and log.error events plus
    the log lane's evictions. -> per node: events by type, spool bytes;
    and the seconds the checks took."""
    import glob
    import signal

    from pilosa_tpu_torch.utils import events as ev

    t0 = time.perf_counter()
    ports, ids = nodes.ports[:3], nodes.ids[:3]
    for p in ports:
        for method, path, body in (("GET", "/status", b""),
                                   ("POST", "/index/d/query",
                                    b"Count(Row(f=0))"),
                                   ("GET", "/no/such/route", b"")):
            _st, h, _ = _raw_http(p, method, path, body)
            if ev.decode_hlc(h.get(ev.HLC_HEADER)) is None:
                raise AssertionError(f"{method} {path} on port {p}: no "
                                     f"{ev.HLC_HEADER} header: {h}")
    doc = _http(ports[0], "GET", "/cluster/events")
    status = {n["id"]: n["status"] for n in doc["nodes"]}
    if status != dict.fromkeys(ids, "ok"):
        raise AssertionError(f"/cluster/events nodes: {status}")
    merged = doc["events"]
    keys = [ev.hlc_sort_key(e) for e in merged]
    if keys != sorted(keys):
        raise AssertionError("/cluster/events is not in HLC order")
    for nid in ids:
        seqs = [e["seq"] for e in merged if e["node"] == nid]
        if any(b <= a for a, b in zip(seqs, seqs[1:])):
            raise AssertionError(f"{nid}'s seq does not rise in HLC order")
    pos = {id(e): i for i, e in enumerate(merged)}

    def at(etype: str, **match) -> list:
        return [pos[id(e)] for e in _has(merged, etype, **match)]

    n2 = ids[2]
    reloaded = _node_vars(ports[2])["events"]["reloaded"]
    pre = [i for i, e in enumerate(merged)
           if e["node"] == n2 and e["seq"] <= reloaded]
    if not _has([merged[i] for i in pre], "node.start"):
        raise AssertionError(f"node 2 reloaded {reloaded} events from its "
                             "spool, its first node.start not among them")
    chain: dict = {}
    for i in (0, 1):
        downs = at("peer.down", node=ids[i], peer=n2, detector="probe")
        appends = at("hint.append", node=ids[i], target=n2)
        replays = at("hint.replay", node=ids[i], target=n2)
        if not downs or not appends or not replays \
                or min(appends) < downs[0]:
            raise AssertionError(f"node {i}: peer.down {downs}, "
                                 f"hint.append {appends[:3]}, hint.replay "
                                 f"{replays}")
        chain[i] = {"down": downs[0], "appends": appends,
                    "replay": replays[0]}
    if max(pre) > min(chain[i]["down"] for i in (0, 1)):
        raise AssertionError("node 2's pre-kill events sort after a mark")
    last_append = max(max(chain[i]["appends"]) for i in (0, 1))
    back = {etype: [i for i in at(etype, node=n2, **match)
                    if merged[i]["seq"] > reloaded]
            for etype, match in (
                ("node.start", {}),
                ("snapshot.quarantined",
                 {"fragment": f"d/f/standard/{bad_shard}"}),
                ("fence.armed", {}))}
    if any(not v or v[0] < last_append for v in back.values()):
        raise AssertionError(f"node 2's return {back}, last hint.append "
                             f"{last_append}")
    armed = back["fence.armed"][0]
    lifts = at("fence.lifted", node=n2)
    waited = [i for i in lifts if merged[i].get("awaitedHints")]
    last_replay = max(chain[i]["replay"] for i in (0, 1))
    if min(chain[i]["replay"] for i in (0, 1)) < armed or not waited \
            or min(waited) < last_replay or min(lifts) < armed:
        raise AssertionError(f"fence.armed {armed}, hint.replay "
                             f"{[chain[i]['replay'] for i in (0, 1)]}, "
                             f"lifts {lifts[:5]}, waited {waited[:5]}")
    scrubs = [i for i in at("scrub.pass", node=n2) if i > max(lifts)]
    if not scrubs:
        raise AssertionError("no scrub.pass of node 2 after its last lift")
    chain_s = time.perf_counter() - t0
    # SIGQUIT: node 1 writes its ring into its data dir and serves on
    t1 = time.perf_counter()
    d1 = os.path.join(nodes.tmp, "n1")
    had = set(glob.glob(os.path.join(d1, "events.crash-*.jsonl")))
    nodes.procs[1].send_signal(signal.SIGQUIT)
    _poll(lambda: set(glob.glob(os.path.join(
        d1, "events.crash-*.jsonl"))) - had, 30, "node 1's crash file", 0.05)
    crash = sorted(set(glob.glob(os.path.join(
        d1, "events.crash-*.jsonl"))) - had)[0]
    _http(ports[1], "GET", "/status")  # the handler has returned
    with open(crash, encoding="utf-8") as f:
        dumped = [json.loads(line) for line in f]
    feed1, _ = _feed(ports[1])
    have = {(e["seq"], e["type"], tuple(e["hlc"])) for e in feed1}
    if not dumped or any((e["seq"], e["type"], tuple(e["hlc"])) not in have
                         for e in dumped):
        raise AssertionError(f"{crash}: {len(dumped)} events, not all in "
                             "node 1's feed")
    nodes.check_alive()
    _check_reads(ports[1], reads[:4], "node 1 after SIGQUIT")
    quit_s = time.perf_counter() - t1
    # the log files
    per_node = []
    for i, p in enumerate(ports):
        snap = _node_vars(p)["events"]
        levels = _log_levels(os.path.join(nodes.tmp, f"n{i}", NODE_LOG),
                             as_json=i == 1)
        feed, _ = _feed(p)
        logged = len(_has(feed, "log.warn")) + len(_has(feed, "log.error"))
        warn_err = levels.count("WARN") + levels.count("ERROR")
        if warn_err != logged + snap["evicted"]["log"]:
            raise AssertionError(f"node {i}: {warn_err} WARN/ERROR records,"
                                 f" {logged} log events, {snap['evicted']}"
                                 " evicted")
        per_node.append({
            "by_type": dict(sorted(collections.Counter(
                e["type"] for e in feed).items())),
            "reloaded": snap["reloaded"], "spool_bytes": snap["spoolBytes"],
            "log_records": len(levels), "warn_error_records": warn_err})
    out = {"nodes": per_node, "merged": len(merged),
           "chain": {"pre_kill": len(pre),
                     "appends": [len(chain[i]["appends"]) for i in (0, 1)],
                     "lifts": len(lifts), "waited": len(waited)},
           "crash_file_events": len(dumped),
           "seconds": {"timeline": chain_s, "sigquit": quit_s,
                       "all": time.perf_counter() - t0}}
    log(f"  event journal: /cluster/events through node 0, {len(merged)} "
        f"events of 3 nodes in HLC order (each node's seq rising); the "
        f"chain: peer.down by probe on nodes 0 and 1, their hint.append for "
        f"node 2 ({out['chain']['appends']}), node 2's {len(pre)} pre-kill "
        f"events reloaded from its spool, its node.start, "
        f"snapshot.quarantined of d/f/standard/{bad_shard} and fence.armed, "
        f"both peers' hint.replay before the {len(waited)} of {len(lifts)} "
        f"lifts that waited for the hints, a scrub.pass after; every "
        f"response stamped; SIGQUIT: node 1 wrote {len(dumped)} events to "
        f"{os.path.basename(crash)}, all in its feed, and serves exact "
        f"Counts; log files parsed (node 1 JSON), WARN/ERROR records = log "
        f"events + evictions; {out['seconds']['all']:.2f} s "
        f"(timeline {chain_s:.2f} s, SIGQUIT {quit_s:.2f} s)")
    for i, n in enumerate(per_node):
        log(f"  node {i} events: {json.dumps(n['by_type'])}; spool "
            f"{n['spool_bytes']} bytes ({n['reloaded']} reloaded); log "
            f"{n['log_records']} records, {n['warn_error_records']} WARN/"
            "ERROR")
    return out


def _resize_events(nodes: ClusterNodes, event: str, k: int,
                   members: list) -> float:
    """resize.start and resize.complete of the `event` job of node k on
    the coordinator (node 0), and a topology.change naming node k on every
    other member (the coordinator records its own change as the job's
    completion, as the JAX package does). -> the seconds it took."""
    t0 = time.perf_counter()
    nid = nodes.ids[k]
    coord, _ = _feed(nodes.ports[0])
    for etype in ("resize.start", "resize.complete"):
        if not _has(coord, etype, event=event, node=nid):
            raise AssertionError(f"the coordinator recorded no {etype} of "
                                 f"the {event} of {nid}")
    for i in members:
        changes, _ = _feed(nodes.ports[i], "?type=topology.change")
        if not [e for e in changes
                if nid in e.get("removed" if event == "leave" else "nodes",
                                [])]:
            raise AssertionError(f"node {i} recorded no topology.change of "
                                 f"the {event} of {nid}: {changes}")
    return time.perf_counter() - t0


def member_timeline(nodes: ClusterNodes, live: list) -> dict:
    """GET /cluster/events through node 0 after the leave (node 2 absent
    or down, the others ok), then `python -m pilosa_tpu_torch.cli timeline
    --host <node 0>` once: exit 0 and one line for each event its header
    counts, no fewer than the merged document held."""
    from pilosa_tpu_torch.utils import events as ev

    port = nodes.ports[0]
    doc = _http(port, "GET", "/cluster/events")
    status = {n["id"]: n["status"] for n in doc["nodes"]}
    want = dict.fromkeys((nodes.ids[i] for i in live), "ok")
    if {k: v for k, v in status.items() if k != nodes.ids[2]} != want \
            or status.get(nodes.ids[2], "down") != "down":
        raise AssertionError(f"/cluster/events nodes after the leave: "
                             f"{status}")
    keys = [ev.hlc_sort_key(e) for e in doc["events"]]
    if keys != sorted(keys):
        raise AssertionError("/cluster/events is not in HLC order")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "timeline", "--host",
         f"http://127.0.0.1:{port}"], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=120)
    lines = run.stdout.splitlines()
    head = lines[0].split() if lines else []
    n = int(head[2]) if len(head) > 2 and head[2].isdigit() else -1
    body = lines[lines.index("") + 1:] if "" in lines else []
    if run.returncode != 0 or n != len(body) or n < len(doc["events"]):
        raise AssertionError(f"timeline: exit {run.returncode}, header "
                             f"{lines[:1]}, {len(body)} lines, "
                             f"{len(doc['events'])} merged; "
                             f"{run.stderr[-500:]}")
    log(f"  /cluster/events through node 0 after the leave: {status}, "
        f"{len(doc['events'])} events in HLC order; `timeline --host node "
        f"0`: exit 0, {n} events ({time.perf_counter() - t0:.2f} s)")
    return {"nodes": status, "events": len(doc["events"]),
            "timeline_events": n}


# ------------------------------------------------------- phase 2q: QoS

QOS_TENANTS = (("tenant-a", 8, "interactive"), ("tenant-b", 24, "batch"))
QOS_ALONE_S = 3.0  # tenant-a's clients alone, before the mix
QOS_MIX_S = 8.0    # both tenants at once, under a device-profile capture
# tenant-b's queries-per-s quota: this share of the Count pass's q/s
QOS_QUOTA_SHARE = 0.2
QOS_TOPNS = 3      # admitted TopNs that feed the class-cost EWMA
# the admission-cost rounds of the Count pass, interleaved
QOS_ROUNDS = ("off", "enforce", "enforce", "off")
# tenant-b's quota for the deep-debt query: its wait passes QUOTA_DEBT_S
QOS_DEBT_QPS = 0.1


def _quota_body(principal: str) -> dict:
    """The JAX server's 429 body (pilosa_tpu/net/http_server.py:309-319)."""
    return {"error": f"query rate quota exhausted for {principal}",
            "code": "quota-exhausted"}


def _qos_set(srv, mode: str, overrides: dict | None = None) -> None:
    """The plane's mode and per-principal overrides on the running server
    (quota state starts over)."""
    srv.qos.mode = mode
    srv.qos.overrides = dict(overrides or {})
    srv.qos._principals.clear()


def tenant_mix(port: int, tenants: list, seconds: float, queries: list,
               seed: int, during=None) -> tuple:
    """For `seconds`, each tenant's clients send Count(Intersect) queries
    with X-API-Key and X-Pilosa-Priority: every 200 equals the oracle,
    every 429 carries the JAX body and a Retry-After of 1-30 s, which the
    client honours; anything else fails. -> ({tenant: {lat, throttled}},
    wall seconds, what during() gave)."""
    stop_at = time.perf_counter() + seconds
    res = {name: {"lat": [], "throttled": 0, "retry_after": set()}
           for name, _, _ in tenants}
    errors: list = []
    lock = threading.Lock()

    def client(name: str, prio: str, cid: int) -> None:
        rng = np.random.default_rng(seed + cid)
        headers = {"X-API-Key": name, "X-Pilosa-Priority": prio}
        conn = http.client.HTTPConnection("localhost", port, timeout=600)
        try:
            while time.perf_counter() < stop_at:
                pql, want = queries[int(rng.integers(len(queries)))]
                t = time.perf_counter()
                st, h, got = _raw_http(port, "POST", "/index/i/query",
                                 pql.encode(), headers, conn)
                dt = time.perf_counter() - t
                if st == 200 and got["results"][0] == want:
                    with lock:
                        res[name]["lat"].append(dt)
                elif st == 429:
                    ra = h.get("Retry-After", "")
                    if got != _quota_body(f"key:{name}") \
                            or not ra.isdigit() or not 1 <= int(ra) <= 30:
                        raise AssertionError(f"429: {got}, Retry-After "
                                             f"{ra!r}")
                    with lock:
                        res[name]["throttled"] += 1
                        res[name]["retry_after"].add(int(ra))
                    time.sleep(min(float(ra), max(
                        0.0, stop_at - time.perf_counter())))
                else:
                    raise AssertionError(f"{pql}: {st} {got} (oracle "
                                         f"{want})")
        except Exception as e:  # noqa: BLE001 — reported below
            with lock:
                errors.append(f"{name} client {cid}: {e!r}")
        finally:
            conn.close()

    threads = []
    cid = 0
    for name, n, prio in tenants:
        for _ in range(n):
            threads.append(threading.Thread(target=client,
                                            args=(name, prio, cid)))
            cid += 1
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    seen = during() if during is not None else None
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{len(errors)} tenant clients failed: "
                             f"{errors[:3]}")
    return res, wall, seen


def _tenant_line(name: str, r: dict, wall: float) -> dict:
    p50, p99 = _percentiles(r["lat"]) if r["lat"] else (None, None)
    out = {"admitted": len(r["lat"]), "throttled": r["throttled"],
           "qps": len(r["lat"]) / wall, "p50_ms": p50, "p99_ms": p99,
           "retry_after_s": sorted(r["retry_after"])}
    log(f"  {name}: {out['admitted']} admitted, {out['throttled']} "
        f"throttled (Retry-After {out['retry_after_s']} s), "
        f"{out['qps']:.1f} q/s, p50 {p50 if p50 is None else round(p50, 2)}"
        f" ms, p99 {p99 if p99 is None else round(p99, 2)} ms")
    return out


def qos_phase(srv, port: int, count_mix: list, pair: np.ndarray,
              count_stats: dict, run_clients, seed: int) -> dict:
    """Phase 2q, on the Count path's server after its passes: the plane
    in enforce mode for the phase alone (off before and after, so no other
    pass runs with it), two tenants, doomed and expired queries shed
    before any launch, health turned red by an SLO, the usage ledger, and
    the admission's cost on the Count pass."""
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.utils import accounting

    t_phase = time.perf_counter()
    out: dict = {}
    # the event journal's cursor and the plane's storm counters before
    ev_seq = _http(port, "GET", "/debug/events")["seq"]
    storms0, active0 = srv.qos.storms, srv.qos.storm_active
    quota = max(1.0, QOS_QUOTA_SHARE * count_stats["qps"])
    overrides = {"key:tenant-b": {"queries_per_s": quota,
                                  "priority": "batch"}}
    log(f"  [qos] mode enforce for this phase; key:tenant-b queries-per-s "
        f"{quota:.2f} ({QOS_QUOTA_SHARE:g} of the Count pass's "
        f"{count_stats['qps']:.1f} q/s), key:tenant-a no quota")
    _qos_set(srv, "enforce", overrides)
    old_slo = srv.slo
    try:
        # tenant-a alone, then both tenants under a capture
        alone, wall, _ = tenant_mix(port, QOS_TENANTS[:1], QOS_ALONE_S,
                                    count_mix, seed + 4000)
        out["alone"] = _tenant_line("tenant-a alone", alone["tenant-a"],
                                    wall)
        usage0 = srv.usage.snapshot()["principals"]
        cuts0 = srv.executor.batcher.priority_cuts
        mix, wall, cap = tenant_mix(
            port, QOS_TENANTS, QOS_MIX_S, count_mix, seed + 4100,
            lambda: device_capture(port, QOS_MIX_S - 1.0))
        out["mix"] = {name: _tenant_line(name, mix[name], wall)
                      for name, _, _ in QOS_TENANTS}
        a, b = out["mix"]["tenant-a"], out["mix"]["tenant-b"]
        if not b["throttled"] or not a["admitted"] or a["throttled"]:
            raise AssertionError(f"tenant mix: {out['mix']}")
        out["p50_ratio"] = a["p50_ms"] / out["alone"]["p50_ms"]
        bs = srv.executor.batcher.snapshot()
        out["priority_cuts"] = srv.executor.batcher.priority_cuts - cuts0
        log(f"  tenant-a p50 in the mix / alone: {out['p50_ratio']:.3f} "
            f"({a['p50_ms']:.2f} / {out['alone']['p50_ms']:.2f} ms); "
            f"CountBatcher cuts reordered by priority: "
            f"{out['priority_cuts']} (a cut sorts only past one batch of "
            f"{srv.executor.batcher.max_batch}; largest batch "
            f"{bs['max_batch_seen']})")
        # the usage ledger over the mix, beside the capture's busy time
        doc = _http(port, "GET", "/debug/usage?top=0")
        for name in ("key:tenant-a", "key:tenant-b"):
            e = doc["principals"].get(name)
            if e is None or not e["queries"] or e["deviceMs"] <= 0 \
                    or "hbmBytes" not in e:
                raise AssertionError(f"/debug/usage {name}: {e}")
        dev_ms = sum(e["deviceMs"] - usage0.get(p, {}).get("deviceMs", 0.0)
                     for p, e in doc["principals"].items())
        out["usage"] = {p: {k: doc["principals"][p][k] for k in
                            ("queries", "deviceMs", "hbmBytes", "queueMs")}
                        for p in ("key:tenant-a", "key:tenant-b")}
        out["usage_device_ms"] = dev_ms
        out["capture"] = cap
        log(f"  /debug/usage: {json.dumps(out['usage'])}; deviceMs over "
            f"the mix, summed over principals {dev_ms:.1f} ms (the "
            f"batchers' wall-time share: host time), device busy in the "
            f"capture {cap['deviceBusyMs']} ms over {cap['seconds']} s")
        # deep debt: tenant-b's quota cut to QOS_DEBT_QPS, so that one
        # query's wait passes the plane's QUOTA_DEBT_S (qos.quota_debt)
        _qos_set(srv, "enforce", {"key:tenant-b": {
            "queries_per_s": QOS_DEBT_QPS, "priority": "batch"}})
        st, h, got = _raw_http(port, "POST", "/index/i/query",
                               count_mix[0][0].encode(),
                               {"X-API-Key": "tenant-b"})
        ra = h.get("Retry-After", "")
        if (st, got) != (429, _quota_body("key:tenant-b")) \
                or not ra.isdigit() or int(ra) < srv.qos.QUOTA_DEBT_S:
            raise AssertionError(f"deep debt: {st} {got}, Retry-After {ra}")
        log(f"  deep debt: key:tenant-b at {QOS_DEBT_QPS} queries/s: 429, "
            f"Retry-After {ra} s")
        _qos_set(srv, "enforce", overrides)

        # doomed work: admitted TopNs feed the class cost, then a TopN
        # whose deadline is under it is shed before it is planned
        topn = []
        for k in range(QOS_TOPNS):
            a_row = k % len(pair)
            want = _pairs(pair[a_row])[:3]
            got = _http(port, "POST", "/index/i/query",
                        f"TopN(f, Row(f={a_row}), n=3)".encode())
            if got["results"][0] != want:
                raise AssertionError(f"TopN(f, Row(f={a_row}), n=3): "
                                     f"{got} != {want}")
            topn.append(a_row)
        cost = srv.qos.class_cost_ms("topn")
        srv.qos._sig_t = 0.0  # the load signals as admission will read them
        srv.qos._refresh_signals(time.monotonic())
        wait = srv.qos.estimated_wait_ms()
        timeout_ms = (cost + wait) / 2
        if not wait < timeout_ms < cost:
            raise AssertionError(f"TopN cost {cost} ms, estimated wait "
                                 f"{wait} ms: no deadline lies between")
        before = kernels.launch_counts()
        shed0 = srv.qos.shed["estimatedCost"]
        st, h, got = _raw_http(port, "POST", f"/index/i/query?timeout="
                         f"{timeout_ms:.3f}ms", b"TopN(f, Row(f=1), n=3)")
        if st != 503 or got.get("code") != "shed" \
                or srv.qos.shed["estimatedCost"] != shed0 + 1:
            raise AssertionError(f"doomed TopN: {st} {got}")
        if kernels.launch_counts() != before:
            raise AssertionError("the doomed TopN launched a kernel")
        out["doomed"] = {"topn_cost_ms": cost, "estimated_wait_ms": wait,
                         "timeout_ms": timeout_ms, "status": st,
                         "body": got}
        log(f"  doomed TopN: class cost {cost:.1f} ms (EWMA of "
            f"{QOS_TOPNS} admitted, exact), estimated wait {wait:.2f} ms, "
            f"?timeout={timeout_ms:.1f}ms -> {st} {got}; "
            f"topn_counts_packed launches unchanged "
            f"({before['topn_counts_packed']})")
        # an already expired deadline: shed at admission
        before = kernels.launch_counts()
        st, h, got = _raw_http(port, "POST", "/index/i/query",
                         b"Count(Intersect(Row(f=0), Row(f=1)))",
                         {"X-Pilosa-Deadline": "-1"})
        if (st, h.get("X-Pilosa-Shed-Reason"), got) != (
                503, "deadline", {"error": "deadline already expired",
                                  "code": "shed"}) \
                or kernels.launch_counts() != before:
            raise AssertionError(f"expired deadline: {st} {h} {got}")
        out["expired"] = {"status": st, "body": got}
        log(f"  expired deadline: {st} {got}, Retry-After "
            f"{h.get('Retry-After')}, no launch")

        # health: a count objective far under the pass's p50 burns both
        # windows; /status turns red and the next query is shed. The
        # sampler's tick records each change of the score (one before,
        # one at red, one after the objective is restored)
        srv.telemetry.sample_once()
        target = count_stats["p50_ms"] / 100
        srv.slo = srv.api.slo = accounting.SLOTracker([
            accounting.Objective("availability", None, None, 0.999),
            accounting.Objective("count-latency", "count", target, 0.99)])
        # the four Counts run under a fresh cached verdict: one refreshed
        # after the first of them would shed the rest (healthRed)
        srv.qos._health = (time.monotonic(), "green")
        for pql, want in count_mix[:4]:
            if _http(port, "POST", "/index/i/query",
                     pql.encode())["results"][0] != want:
                raise AssertionError(f"{pql} differs from the oracle")
        time.sleep(srv.qos.HEALTH_TTL_S + 0.1)  # the plane's cached verdict
        health = _http(port, "GET", "/status")["health"]
        st, h, got = _raw_http(port, "POST", "/index/i/query",
                         count_mix[0][0].encode())
        if health["score"] != "red" \
                or not any(r.startswith("SLO count-latency")
                           for r in health["reasons"]) \
                or (st, h.get("X-Pilosa-Shed-Reason"), got) != (
                    503, "healthRed", {"error": "node health is red; "
                                                "shedding load",
                                       "code": "shed"}):
            raise AssertionError(f"health: {health}; {st} {h} {got}")
        srv.telemetry.sample_once()
        out["health"] = {"objective_ms": target, "health": health,
                         "shed": got, "retry_after": h.get("Retry-After")}
        log(f"  SLO count-latency {target:.3f} ms: /status health "
            f"{health}; the next query {st} {got} (Retry-After "
            f"{h.get('Retry-After')})")
    finally:
        srv.slo = srv.api.slo = old_slo
        srv.qos._health = (0.0, "green")
        _qos_set(srv, "off")
        srv.telemetry.sample_once()

    # the admission's cost: the Count pass with the plane off and in
    # enforce mode with no quota that binds, interleaved
    rounds = []
    for i, mode in enumerate(QOS_ROUNDS):
        _qos_set(srv, mode)
        try:
            lat, wall, _ = run_clients(COUNT_ROUND_QUERIES, 4200 + 100 * i)
        finally:
            _qos_set(srv, "off")
        rounds.append({"mode": mode, "qps": len(lat) / wall,
                       "p50_ms": statistics.median(lat) * 1e3})
        log(f"  admission round {i + 1} ({mode}): {rounds[-1]['qps']:.1f} "
            f"q/s, p50 {rounds[-1]['p50_ms']:.2f} ms")
    qps = {m: statistics.mean(r["qps"] for r in rounds if r["mode"] == m)
           for m in ("off", "enforce")}
    out["admission_rounds"] = rounds
    out["admission_qps_ratio"] = qps["enforce"] / qps["off"]
    out["events"] = qos_events(srv, port, ev_seq, storms0, active0)
    out["qos_vars"] = _http(port, "GET", "/debug/vars")["qos"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  admission's cost: enforce / off q/s {out['admission_qps_ratio']:.4f}"
        f" (mean of two rounds each; the JAX bench's budget was <= 1 %, "
        f"no limit here); qos counters {json.dumps(out['qos_vars']['shed'])}"
        f" shed, {json.dumps(out['qos_vars']['throttled'])} throttled; "
        f"phase 2q {out['phase_s']:.1f} s")
    return out


def qos_events(srv, port: int, seq: int, storms0: int,
               active0: bool) -> dict:
    """Phase 2q's events on the server's /debug/events since `seq`:
    health.transition to red with the SLO's reason and back from red;
    qos.quota_debt of key:tenant-b; as many qos.shed_storm.start as the
    plane counted storms (its STORM_N rejections within STORM_WINDOW_S,
    the JAX thresholds), and one .end for each storm that ended. ->
    the events by type."""
    t0 = time.perf_counter()
    evs, _ = _feed(port, f"?since={seq}")
    red = [e for e in _has(evs, "health.transition", toScore="red")
           if any(r.startswith("SLO count-latency") for r in e["reasons"])]
    back = [e for e in _has(evs, "health.transition", fromScore="red")
            if not red or e["seq"] > red[0]["seq"]]
    starts = len(_has(evs, "qos.shed_storm.start"))
    ends = len(_has(evs, "qos.shed_storm.end"))
    storms = srv.qos.storms - storms0
    if not red or not back \
            or not _has(evs, "qos.quota_debt", principal="key:tenant-b") \
            or starts != storms \
            or ends != storms + active0 - srv.qos.storm_active:
        raise AssertionError(f"phase 2q events: {len(red)} to red, "
                             f"{len(back)} back, {starts} storm starts and "
                             f"{ends} ends for {storms} storms; "
                             f"{[e['type'] for e in evs]}")
    by_type = dict(sorted(collections.Counter(
        e["type"] for e in evs).items()))
    log(f"  events of phase 2q: {json.dumps(by_type)} (storms the plane "
        f"counted: {storms}; health red with the SLO's reason and back; "
        f"key:tenant-b's quota debt); checks {time.perf_counter() - t0:.2f}"
        " s")
    return by_type


def cluster_qos(ports: list, count_mix: list) -> dict:
    """Phase 5g's QoS checks on its node processes: Counts through node 0
    as tenant-c at batch priority, node 1's ledger listing the inherited
    principal, and an envelope entry whose deadline has expired shed on
    node 1 (deadlineRemote) with no launch there."""
    from pilosa_tpu_torch.encoding.protobuf import Serializer
    from pilosa_tpu_torch.net.client import InternalClient

    hdrs = {"X-API-Key": "tenant-c", "X-Pilosa-Priority": "batch"}
    for pql, want in count_mix[:4]:
        st, _, got = _raw_http(ports[0], "POST", "/index/d/query", pql.encode(),
                         hdrs)
        if st != 200 or got["results"][0] != want:
            raise AssertionError(f"tenant-c {pql}: {st} {got} != {want}")
    seen = [_http(p, "GET", "/debug/usage?top=0")["principals"].get(
        "key:tenant-c") for p in ports]
    if not seen[1] or not seen[1]["queries"]:
        raise AssertionError(f"node 1 /debug/usage has no key:tenant-c: "
                             f"{seen}")
    dv = _node_vars(ports[1])
    shed0, launches0 = dv["qos"]["shed"], _node_launches(dv)
    raw = InternalClient().query_batch_raw(f"http://localhost:{ports[1]}", [
        {"index": "d", "query": count_mix[0][0], "remote": True,
         "timeout": 0.0, "principal": "key:tenant-c",
         "priority": "batch"}])
    err = Serializer().decode_query_response(raw[0])["err"]
    dv = _node_vars(ports[1])
    if "deadline" not in err \
            or dv["qos"]["shed"]["deadlineRemote"] \
            != shed0["deadlineRemote"] + 1 \
            or _node_launches(dv) != launches0:
        raise AssertionError(f"expired entry on node 1: {err!r}, shed "
                             f"{dv['qos']['shed']}, launches "
                             f"{_node_launches(dv)} (before {launches0})")
    out = {"tenant_c_by_node": seen, "expired_entry_error": err,
           "node1_shed": dv["qos"]["shed"]}
    log(f"  QoS: 4 Counts through node 0 as key:tenant-c (batch): node 1's "
        f"/debug/usage {json.dumps(seen[1])}, node 2's "
        f"{json.dumps(seen[2])}; an expired envelope entry on node 1: "
        f"{err!r}, deadlineRemote {dv['qos']['shed']['deadlineRemote']}, "
        "no launch")
    return out


# ----------------------------------------- phase 5i: faults and operations

FAULT_SHARDS = 128  # the size of phase 5g
FAULT_ROWS = 4  # rows of f at phase 2's density
FAULT_SEED = 20250804  # the JAX chaos suite's seed (tests/test_chaos.py)
FAULT_RATE = 0.08
FAULT_POINTS = ("storage.wal.append", "net.client.send", "net.client.read",
                "executor.fanout", "http.server.dispatch")
FAULT_CLIENTS = 8
FAULT_COUNTS, FAULT_SETS = 320, 192  # in all, over the clients
FAULT_WRITE_ROW = 9
FAULT_CRASH_ACKS = 2000  # acknowledged bits before the writer's SIGKILL
FAULT_CRASH_THREADS = 4
FAULT_HINTED = 12  # Sets acknowledged with a hint for the dead node
FAULT_CSV_BITS = 4000  # the CLI's CSV, over shards nodes 0 and 1 own
FAULT_TLS_SHARDS = 16
FAULT_DIAG_INTERVAL = 0.5
FAULT_POLL_INTERVAL = 0.25
FAULT_KERNELS = ("pair_stream_counts", "program_count")

CRASH_WRITER = r"""
import sys, threading
from pilosa_tpu_torch.executor import Executor
from pilosa_tpu_torch.models.holder import Holder

h = Holder(sys.argv[1]).open()
idx = h.create_index("i")
idx.create_field("f")
ex = Executor(h, device="cpu")  # the write path only: no card needed
plock = threading.Lock()

def writer(tid):
    col = tid * 1000003
    while True:  # SIGKILLed mid-stream
        cols = list(range(col, col + 5))
        ex.execute("i", "".join(f"Set({c}, f={tid})" for c in cols))
        # acknowledged: the batch's WAL records are written and fsynced
        with plock:
            print("".join(f"ACK {tid} {c}\n" for c in cols), end="",
                  flush=True)
        col += 5

ts = [threading.Thread(target=writer, args=(t,), daemon=True)
      for t in range(int(sys.argv[2]))]
for t in ts:
    t.start()
for t in ts:
    t.join()
"""


class CrashWriter:
    """A port writer process (Holder + Executor, the batched write path)
    with PILOSA_TPU_WAL_FSYNC=always and PILOSA_TPU_CONTAINER_STORE=btree,
    SIGKILLed from a reader thread once FAULT_CRASH_ACKS bits are
    acknowledged; the acks printed before the kill are kept."""

    def __init__(self, data_dir: str):
        import signal

        self.data_dir = data_dir
        env = dict(os.environ, PILOSA_TPU_WAL_FSYNC="always",
                   PILOSA_TPU_CONTAINER_STORE="btree",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__))
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("PILOSA_TPU_TORCH_INGEST", None)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CRASH_WRITER, data_dir,
             str(FAULT_CRASH_THREADS)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env)
        self.acked: list = []
        self.first_ack_s = None
        self.killed_s = None
        self.done = threading.Event()

        def read():
            try:
                for line in self.proc.stdout:
                    parts = line.split()
                    if len(parts) != 3 or parts[0] != b"ACK":
                        continue
                    if self.first_ack_s is None:
                        self.first_ack_s = time.perf_counter() - self.t0
                    self.acked.append((int(parts[1]), int(parts[2])))
                    if len(self.acked) >= FAULT_CRASH_ACKS \
                            and self.killed_s is None:
                        os.kill(self.proc.pid, signal.SIGKILL)
                        self.killed_s = time.perf_counter() - self.t0
            finally:
                self.done.set()

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()

    def wait(self, timeout: float = 300.0) -> list:
        if not self.done.wait(timeout):
            self.proc.kill()
            raise AssertionError("the crash writer did not reach "
                                 f"{FAULT_CRASH_ACKS} acks in {timeout} s")
        self.proc.wait(timeout=30)
        err = self.proc.stderr.read().decode(errors="replace")
        if self.killed_s is None:
            raise AssertionError(f"the crash writer exited by itself "
                                 f"({self.proc.returncode}): {err[-2000:]}")
        return self.acked

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _open_unprofiled(server):
    """server.open() without the device profiler's empty warm-up capture
    (the run's first server on this thread made it; of phase 5i's nodes
    only the storm's node 0 is captured): about 2 s an open on the card."""
    name = "PILOSA_TPU_TORCH_DEVICE_PROFILE"
    old = os.environ.get(name)
    os.environ[name] = "0"
    try:
        return server.open()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _status_json(port: int, path: str, body: bytes = b"",
                 method: str = "POST", timeout: float = 60.0) -> tuple:
    """(status, parsed JSON or the raw text) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(raw or b"null")
    except ValueError:
        return resp.status, raw.decode(errors="replace")


def _block_sums(servers) -> list:
    sums = []
    for s in servers:
        m = {}
        for iname, fname, vname, shard, frag in s.holder.walk_fragments():
            if s.cluster.owns_shard(s.node_id, iname, shard):
                m[(iname, fname, vname, shard)] = {
                    b: c.hex() for b, c in frag.blocks()}
        sums.append(m)
    return sums


def _converged(servers) -> bool:
    """Every fragment two live nodes co-own carries the same block
    checksums on both (the JAX chaos suite's test)."""
    a, b = _block_sums(servers)
    shared = set(a) & set(b)
    return bool(shared) and all(a[k] == b[k] for k in shared)


def _fault_storm(servers, mix: list, n_shards: int, seed: int) -> dict:
    """FAULT_CLIENTS threads send FAULT_COUNTS Count(Intersect) and
    FAULT_SETS Set through nodes 0 and 1 in turn under the armed chaos
    schedule; node 2's listener closes when half the operations are
    done. Every answer is right or a clean JSON error."""
    from pilosa_tpu_torch.utils import failpoints

    rng = np.random.default_rng(seed + 83)
    ops = [("count",) + mix[int(rng.integers(len(mix)))]
           for _ in range(FAULT_COUNTS)]
    for i in range(FAULT_SETS):
        shard = (i * 37) % n_shards
        ops.append(("set", shard * SHARD_WIDTH + 900_000 + i, None))
    order = rng.permutation(len(ops))
    dealt = [[ops[k] for k in order[c::FAULT_CLIENTS]]
             for c in range(FAULT_CLIENTS)]
    ports = [s.http.port for s in servers]
    lock = threading.Lock()
    done = [0]
    acked, refused, bad, errors = [], [], [], collections.Counter()
    kill_at = len(ops) // 2
    killed = threading.Event()

    def client(c: int) -> None:
        for k, (kind, arg, want) in enumerate(dealt[c]):
            port = ports[(c + k) % 2]
            if kind == "count":
                st, out = _status_json(port, "/index/x/query", arg.encode())
                if st == 200:
                    if out.get("results") != [want]:
                        bad.append((arg, out, want))
                elif not (isinstance(out, dict) and "error" in out):
                    bad.append(("error shape", st, out))
                else:
                    errors[st] += 1
            else:
                st, out = _status_json(
                    port, "/index/x/query",
                    f"Set({arg}, f={FAULT_WRITE_ROW})".encode())
                with lock:
                    if st == 200 and out.get("results") == [True]:
                        acked.append(arg)
                    elif st == 200:
                        bad.append(("set not true", arg, out))
                    elif isinstance(out, dict) and "error" in out:
                        refused.append(arg)
                        errors[st] += 1
                    else:
                        bad.append(("set error shape", st, out))
            with lock:
                done[0] += 1
                kill = done[0] >= kill_at and not killed.is_set()
                if kill:
                    killed.set()
            if kill:
                servers[2].http.close()  # node 2 dies mid-storm

    failpoints.arm_chaos(FAULT_SEED, rate=FAULT_RATE,
                         points=set(FAULT_POINTS))
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(FAULT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fired = {n: c["fired"] for n, c in failpoints.counters().items()
                 if c["fired"]}
        schedule = failpoints.describe()
    finally:
        failpoints.reset()
    storm_s = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"storm: {len(bad)} wrong answers or unclean "
                             f"errors, first {bad[:3]}; replay:\n{schedule}")
    if not killed.is_set():
        raise AssertionError("node 2 was never killed")
    if sum(fired.values()) < 1:
        raise AssertionError("no failpoint fired in the storm")
    return {"seconds": storm_s, "fired": fired, "acked": sorted(acked),
            "refused": len(refused), "errors_by_status": dict(errors),
            "operations": len(ops)}


def _fault_cli(servers, tmp: str, n_shards: int, seed: int) -> dict:
    """The CLI against the storm's nodes: a CSV imported and exported back
    unchanged through node 0 (shards nodes 0 and 1 own), check and inspect
    on fragment files and hint logs (all OK, a damaged copy of each
    FAILED), profile-capture against node 0."""
    import contextlib
    import io
    import shutil

    from pilosa_tpu_torch.cli import main as cli

    def run(argv: list) -> tuple:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                rc = cli.main(argv)
            except SystemExit as e:
                rc = e.code
        return rc, buf.getvalue()

    t0 = time.perf_counter()
    s0 = servers[0]
    host = s0.uri
    pair_ids = {servers[0].node_id, servers[1].node_id}
    shards = [s for s in range(4 * n_shards)
              if {n.id for n in s0.cluster.shard_nodes("csv", s)}
              == pair_ids][:4]
    rng = np.random.default_rng(seed + 97)
    cols = np.concatenate([s * SHARD_WIDTH + rng.integers(
        0, SHARD_WIDTH, FAULT_CSV_BITS // len(shards)) for s in shards])
    rows = rng.integers(0, 6, cols.size)
    want = sorted(set(zip(rows.tolist(), cols.tolist())))
    csv_in = os.path.join(tmp, "in.csv")
    with open(csv_in, "w") as f:
        f.writelines(f"{r},{c}\n" for r, c in zip(rows.tolist(),
                                                  cols.tolist()))
    rc, out = run(["import", "--host", host, "--index", "csv", "--field",
                   "f", "--create", "--batch-size", "1000", csv_in])
    if rc != 0 or f"imported {cols.size} records" not in out:
        raise AssertionError(f"cli import: rc {rc}: {out}")
    csv_out = os.path.join(tmp, "out.csv")
    rc, out = run(["export", "--host", host, "--index", "csv", "--field",
                   "f", "-o", csv_out])
    with open(csv_out) as f:
        got = sorted(tuple(map(int, line.split(","))) for line in f
                     if line.strip())
    if rc != 0 or got != want:
        raise AssertionError(f"cli export: rc {rc}, {len(got)} lines, "
                             f"want {len(want)}")
    import_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    frags = [frag.path for *_k, frag in s0.holder.walk_fragments()
             if frag.field == "f" and frag.index == "x"][:8]
    hint_logs = []
    for s in servers[:2]:
        d = os.path.join(s.data_dir, ".hints")
        if os.path.isdir(d):
            hint_logs += [os.path.join(d, n) for n in sorted(os.listdir(d))
                          if n.endswith(".hints")]
    if not hint_logs:
        raise AssertionError("no hint log to check")
    rc, out = run(["check", *frags, *hint_logs])
    oks = out.count(": OK (")
    if rc != 0 or oks != len(frags) + len(hint_logs):
        raise AssertionError(f"cli check: rc {rc}: {out}")
    inspected = []
    for path in frags[:2]:
        rc, out = run(["inspect", path])
        doc = json.loads(out)
        if rc != 0 or doc["bits"] < 1:
            raise AssertionError(f"cli inspect {path}: {out}")
        inspected.append({k: doc[k] for k in ("bits", "containers",
                                              "containerKinds", "opN")})
    bad_frag = os.path.join(tmp, "damaged-fragment")
    shutil.copy(frags[0], bad_frag)
    size = os.path.getsize(bad_frag)
    with open(bad_frag, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    bad_hints = os.path.join(tmp, "damaged.hints")
    shutil.copy(hint_logs[0], bad_hints)
    with open(bad_hints, "r+b") as f:
        f.truncate(os.path.getsize(bad_hints) - 3)
    rc, out = run(["check", frags[1], bad_frag, bad_hints])
    if rc != 1 or out.count(": FAILED: ") != 2 or out.count(": OK (") != 1:
        raise AssertionError(f"cli check of the damaged copies: rc {rc}: "
                             f"{out}")
    failed_lines = [line for line in out.splitlines() if "FAILED" in line]
    check_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rc, out = run(["profile-capture", "--host", host, "--seconds", "0.5",
                   "--json"])
    doc = json.loads(out)
    if rc != 0 or doc.get("status") != "ok" \
            or not os.path.exists(doc.get("trace", "")):
        raise AssertionError(f"cli profile-capture: rc {rc}: {out[:500]}")
    log(f"  cli: import {cols.size} records and export them back unchanged "
        f"({import_s:.2f} s); check OK on {len(frags)} fragment files and "
        f"{len(hint_logs)} hint logs, FAILED on the damaged copies "
        f"({failed_lines[0].split(': FAILED: ')[1][:60]}...; "
        f"{failed_lines[1].split(': FAILED: ')[1][:60]}...) "
        f"({check_s:.2f} s); inspect {inspected[0]}; profile-capture ok, "
        f"{doc.get('bytes')} bytes spooled ({time.perf_counter() - t0:.2f}"
        " s)")
    return {"import_export_s": import_s, "check_s": check_s,
            "fragments_checked": len(frags), "hint_logs": len(hint_logs),
            "inspect": inspected, "capture_bytes": doc.get("bytes")}


def _self_signed_pair(tmp: str) -> tuple:
    crt, key = os.path.join(tmp, "crt.pem"), os.path.join(tmp, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-subj", "/CN=localhost", "-keyout", key,
                    "-out", crt, "-days", "1"], check=True,
                   capture_output=True)
    return crt, key


class _DiagSink:
    """A local listener that keeps the diagnostics documents it receives."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        docs = self.docs = []

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                docs.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = HTTPServer(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/diag"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()


def _fault_tls_diag(tmp: str, rows: list, device: str) -> dict:
    """Two port nodes over HTTPS (a throwaway certificate, skip-verify),
    FAULT_TLS_SHARDS shards of f loaded through node 0; Count(Intersect)
    fanned out over HTTPS equals the oracle. Node 0 also phones home to a
    local listener every FAULT_DIAG_INTERVAL s and samples the runtime
    gauges every FAULT_POLL_INTERVAL s."""
    import ssl

    from pilosa_tpu_torch.server import Server

    t0 = time.perf_counter()
    crt, key = _self_signed_pair(tmp)
    sink = _DiagSink()
    nodes = []
    try:
        for i in range(2):
            kw = dict(diagnostics_url=sink.url,
                      diagnostics_interval=FAULT_DIAG_INTERVAL,
                      metric_poll_interval=FAULT_POLL_INTERVAL) if i == 0 \
                else {}
            s = _open_unprofiled(Server(
                os.path.join(tmp, f"tls{i}"), port=0, device=device,
                node_id=f"tls{i}", tls_certificate=crt, tls_key=key,
                tls_skip_verify=True, **kw))
            s.executor.plan_cache.enabled = False
            nodes.append(s)
        sent = [0]
        flush = nodes[0].diagnostics.flush

        def counted_flush():
            ok = flush()
            if ok:
                sent[0] += 1
            return ok

        nodes[0].diagnostics.flush = counted_flush
        uris = [s.uri for s in nodes]
        if not all(u.startswith("https://") for u in uris):
            raise AssertionError(f"TLS nodes serve {uris}")
        for s in nodes:
            s.cluster_hosts = uris
            s.refresh_membership()
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE

        def https(path: str, body: bytes = b"", method: str = "POST"):
            conn = http.client.HTTPSConnection(
                "localhost", nodes[0].http.port, timeout=120, context=ctx)
            try:
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                raw = resp.read()
                if resp.status != 200:
                    raise AssertionError(f"https {path}: {resp.status} "
                                         f"{raw[:300]}")
                return raw
            finally:
                conn.close()

        https("/index/t", b"{}")
        https("/index/t/field/f", b"{}")
        cut = [r[r < FAULT_TLS_SHARDS * SHARD_WIDTH] for r in rows]
        for s, body in enumerate(_roaring_shards(cut, FAULT_TLS_SHARDS)):
            https(f"/index/t/field/f/import-roaring/{s}", body)
        packed = [packed_row(c, FAULT_TLS_SHARDS) for c in cut]
        owners = {n.id for s in range(FAULT_TLS_SHARDS)
                  for n in nodes[0].cluster.shard_nodes("t", s)}
        if len(owners) != 2:
            raise AssertionError(f"the TLS pair's shards sit on {owners}")
        checked = 0
        for a in range(FAULT_ROWS):
            for b in range(a + 1, FAULT_ROWS):
                pql = f"Count(Intersect(Row(f={a}), Row(f={b})))"
                got = json.loads(https("/index/t/query",
                                       pql.encode()))["results"][0]
                want = _and_count(packed[a], packed[b])
                if got != want:
                    raise AssertionError(f"https {pql}: port {got} != "
                                         f"oracle {want}")
                checked += 1
        tls_s = time.perf_counter() - t0
        # diagnostics: at least three documents, then the node closes
        deadline = time.monotonic() + 30
        while sent[0] < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        metrics = https("/metrics", method="GET").decode()
        dv = json.loads(https("/debug/vars", method="GET"))
        for s in nodes:
            s.close()
        closed_sent = sent[0]
        time.sleep(2 * FAULT_DIAG_INTERVAL)
        received = len(sink.docs)
        if closed_sent < 3 or received != closed_sent \
                or sent[0] != closed_sent:
            raise AssertionError(f"diagnostics: {sent[0]} sent, "
                                 f"{received} received")
        doc = sink.docs[-1]
        if doc.get("NumIndexes") != 1 or doc.get("NumNodes") != 2:
            raise AssertionError(f"diagnostics document {doc}")
        g = dv["gauges"]
        need = ('pilosa_memory{key="rss"}', "# TYPE pilosa_threads gauge",
                'pilosa_garbage{key="collections"}')
        if not all(n in metrics for n in need) or g.get("threads", 0) < 1:
            raise AssertionError("the poll-interval gauges are missing")
    finally:
        for s in nodes:
            if not s.closed:
                s.close()
        sink.close()
    log(f"  TLS: two port nodes at {uris[0]} and {uris[1]} (self-signed, "
        f"skip-verify), {FAULT_TLS_SHARDS} shards of f over HTTPS, "
        f"{checked} Count(Intersect) fanned out over HTTPS = oracle "
        f"({tls_s:.2f} s)")
    log(f"  diagnostics: {closed_sent} documents sent every "
        f"{FAULT_DIAG_INTERVAL} s, {received} received, none after close "
        f"(Version {doc['Version']}, NumCPU {doc['NumCPU']}, MemTotal "
        f"{doc['MemTotal']}); poll-interval gauges on /metrics: threads "
        f"{g['threads']:.0f}, memory/rss {g['memory/rss']:.0f}")
    return {"tls_s": tls_s, "tls_checked": checked,
            "diagnostics_sent": closed_sent, "diagnostics_received": received,
            "runtime_gauges": {k: g[k] for k in ("threads", "memory/rss",
                                                  "garbage/collections")}}


def _fault_crash(writer: CrashWriter, device: str) -> dict:
    """Phase 5i (b): the writer was SIGKILLed after FAULT_CRASH_ACKS
    acknowledged bits; a port server on the card opens its data dir and
    every acknowledged bit reads back through Row and Count."""
    from pilosa_tpu_torch.server import Server

    acked = writer.wait()
    t0 = time.perf_counter()
    s = _open_unprofiled(Server(writer.data_dir, port=0, device=device))
    try:
        s.executor.plan_cache.enabled = False
        port = s.http.port
        by_row: dict = collections.defaultdict(set)
        for r, c in acked:
            by_row[r].add(c)
        counts = {}
        for r, cols in sorted(by_row.items()):
            got = set(_http(port, "POST", "/index/i/query",
                            f"Row(f={r})".encode())["results"][0]["columns"])
            missing = cols - got
            if missing:
                raise AssertionError(f"crash: {len(missing)} acknowledged "
                                     f"bits of row {r} lost")
            n = _http(port, "POST", "/index/i/query",
                      f"Count(Row(f={r}))".encode())["results"][0]
            # at most one unacknowledged envelope a writer thread
            if not len(cols) <= n <= len(cols) + 5 or n != len(got):
                raise AssertionError(f"crash: Count(Row(f={r})) {n}, "
                                     f"{len(cols)} acknowledged")
            counts[r] = n
        damaged = s.holder.damaged_fragments()
    finally:
        s.close()
    log(f"  crash: the writer (fsync always, B+Tree store) acknowledged "
        f"its first bit {writer.first_ack_s:.1f} s after its start and was "
        f"SIGKILLed at {writer.killed_s:.1f} s with {len(acked)} "
        f"acknowledged bits; a port server on the card read every one back "
        f"(counts by row {counts}; torn tails truncated: "
        f"{sum(1 for d in damaged if d.get('walTruncatedBytes'))}) "
        f"({time.perf_counter() - t0:.2f} s)")
    return {"acked": len(acked), "first_ack_s": writer.first_ack_s,
            "killed_s": writer.killed_s, "counts": counts,
            "truncated_tails": sum(1 for d in damaged
                                   if d.get("walTruncatedBytes"))}


def faults_phase(seed: int, device: str = "cuda",
                 writer: "CrashWriter | None" = None) -> dict:
    """Phase 5i: the JAX chaos suite's storm against three in-process port
    nodes on the card, crash durability, TLS, the CLI and diagnostics.
    `writer`: a CrashWriter the caller started earlier (stopped here)."""
    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import Server

    t_phase = time.perf_counter()
    n_shards = FAULT_SHARDS
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="pilosa_torch_faults_") as tmp:
        if writer is None:
            writer = CrashWriter(os.path.join(tmp, "crash"))
        servers = []
        try:
            t0 = time.perf_counter()
            rows = make_rows(FAULT_ROWS, n_shards, seed + 71)
            packed = [packed_row(c, n_shards) for c in rows]
            # the pairs batch into pair_stream_counts; the triples run
            # as programs (program_count) on every owner
            mix = [(f"Count(Intersect(Row(f={a}), Row(f={b})))",
                    _and_count(packed[a], packed[b]))
                   for a in range(FAULT_ROWS) for b in range(FAULT_ROWS)
                   if a != b]
            mix += [(f"Count(Intersect(Row(f={a}), Row(f={b}), "
                     f"Row(f={c})))", _and_count(packed[a], packed[b],
                                                 packed[c]))
                    for a, b, c in ((0, 1, 2), (1, 2, 3), (0, 2, 3),
                                    (0, 1, 3))]
            bodies = _roaring_shards(rows, n_shards)
            data_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(3):
                s = Server(os.path.join(tmp, f"n{i}"), port=0,
                           device=device, replica_n=2, node_id=f"node{i}")
                s = s.open() if i == 0 else _open_unprofiled(s)
                s.executor.plan_cache.enabled = False
                servers.append(s)
            open_s = time.perf_counter() - t0
            uris = [s.uri for s in servers]
            for s in servers:
                s.cluster_hosts = uris
                s.refresh_membership()
            p0 = servers[0].http.port
            _http(p0, "POST", "/index/x", b"{}")
            _http(p0, "POST", "/index/x/field/f", b"{}")
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(8) as pool:
                list(pool.map(lambda sb: _http(
                    p0, "POST", f"/index/x/field/f/import-roaring/{sb[0]}",
                    sb[1]), enumerate(bodies)))
            bits = sum(r.size for r in rows)
            load_s = time.perf_counter() - t0 - open_s
            for pql, want in mix[:3]:
                got = _http(p0, "POST", "/index/x/query",
                            pql.encode())["results"][0]
                if got != want:
                    raise AssertionError(f"before the storm: {pql}: port "
                                         f"{got} != oracle {want}")
            log(f"  3 in-process port nodes (replicas 2), {FAULT_ROWS} rows "
                f"of f over {n_shards} shards ({bits} bits, 8.5k-40k a "
                f"shard and row) loaded through node 0 before any fault "
                f"was armed (data {data_s:.1f} s, the nodes' open "
                f"{open_s:.1f} s, the load {load_s:.1f} s)")

            start_window()  # the faults path starts here
            storm = _fault_storm(servers, mix, n_shards, seed)
            storm_launches = kernels.launch_counts()
            dv_launches = _node_launches(_node_vars(p0))
            log(f"  storm: {storm['operations']} operations by "
                f"{FAULT_CLIENTS} clients in {storm['seconds']:.2f} s "
                f"(seed {FAULT_SEED}, rate {FAULT_RATE}); node 2 closed "
                f"halfway; fired by point {storm['fired']}; "
                f"{len(storm['acked'])} Sets acknowledged, "
                f"{storm['refused']} refused with clean errors (by "
                f"status {storm['errors_by_status']}); 0 wrong answers")
            log(f"  kernel launches during the storm: {storm_launches} "
                f"(/debug/vars kernelLaunches: {dv_launches})")

            live = servers[:2]
            t0 = time.perf_counter()
            for s in live:
                s.anti_entropy_pace = 0.0
            passes = 0
            while True:
                for s in live:
                    s.scrub_pass()
                passes += 1
                if _converged(live):
                    break
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("the replicas did not converge")
            converge_s = time.perf_counter() - t0
            for s in live:
                owned = [sh for sh in range(n_shards)
                         if s.cluster.owns_shard(s.node_id, "x", sh)]
                got = set(_http(
                    s.http.port, "POST",
                    "/index/x/query?remote=true&shards="
                    + ",".join(map(str, owned)),
                    f"Row(f={FAULT_WRITE_ROW})".encode())["results"][0][
                    "columns"])
                mine = [c for c in storm["acked"]
                        if c // SHARD_WIDTH in set(owned)]
                lost = [c for c in mine if c not in got]
                if lost:
                    raise AssertionError(f"{len(lost)} acknowledged Sets "
                                         f"lost on {s.node_id}")
                fan = set(_http(s.http.port, "POST", "/index/x/query",
                                f"Row(f={FAULT_WRITE_ROW})".encode())[
                    "results"][0]["columns"])
                if not set(storm["acked"]) <= fan:
                    raise AssertionError(f"acknowledged Sets missing "
                                         f"through {s.node_id}")
                for pql, want in mix:
                    got = _http(s.http.port, "POST", "/index/x/query",
                                pql.encode())["results"][0]
                    if got != want:
                        raise AssertionError(f"after the storm through "
                                             f"{s.node_id}: {pql}: port "
                                             f"{got} != oracle {want}")
            log(f"  faults reset; {passes} paced scrub passes a node "
                f"converged the co-owned block checksums in "
                f"{converge_s:.2f} s; every acknowledged Set reads back on "
                f"both survivors alone (remote=true) and through them; "
                f"{len(mix)} Counts through each = oracle")

            # hinted handoff: node 2 marked down, Sets into its shards are
            # acknowledged with a hint (the hint logs the CLI checks)
            dead = servers[2].node_id
            for s in live:
                s.cluster.mark_down(dead)
            hinted = []
            for sh in range(n_shards):
                if len(hinted) >= FAULT_HINTED:
                    break
                if dead in {n.id for n in
                            servers[0].cluster.shard_nodes("x", sh)}:
                    col = sh * SHARD_WIDTH + 777_777
                    got = _http(p0, "POST", "/index/x/query",
                                f"Set({col}, f={FAULT_WRITE_ROW})".encode())
                    if got["results"] != [True]:
                        raise AssertionError(f"hinted Set: {got}")
                    hinted.append(col)
            pending = sum(s.hints.pending(dead) for s in live)
            if pending < 1:
                raise AssertionError("no hint was logged for node 2")
            log(f"  node 2 marked down: {len(hinted)} Sets acknowledged "
                f"with hints ({pending} bytes of hint logs)")
            out["cli"] = _fault_cli(servers, tmp, n_shards, seed)
            for s in servers:
                s.close()
            out["crash"] = _fault_crash(writer, device)
            out["tls"] = _fault_tls_diag(tmp, rows, device)
            if device == "cuda":
                torch.cuda.synchronize()
            launches = kernels.launch_counts()  # the faults path ends here
        finally:
            for s in servers:
                if not s.closed:
                    s.close()
            writer.stop()
    log(f"  launches on the faults path: {launches}")
    if device == "cuda":
        for k in FAULT_KERNELS:
            if launches[k] < 1:
                raise AssertionError(f"{k} never launched on the faults "
                                     "path")
    out.update(storm={k: v for k, v in storm.items() if k != "acked"},
               acked=len(storm["acked"]), converge_s=converge_s,
               open_s=open_s, load_s=load_s,
               scrub_passes=passes, hinted=len(hinted),
               storm_launches=storm_launches, launches=launches,
               obs={"scrape": {"kernels": {}}})
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 5i: {out['phase_s']:.1f} s")
    return out


def server_phase(device, n_shards: int, n_rows: int, seed: int,
                 clients: int, per_client: int, profile: bool,
                 bsi: tuple, topn: tuple, hybrid: tuple, ingest: tuple,
                 count_only: bool = False, ingest_only: bool = False,
                 frozen: tuple = (FROZEN_CUTS, FROZEN_CONFIGS),
                 typed: tuple = (TYPED_CLIENTS, TYPED_PER_CLIENT)) -> dict:
    """The Count path, then (unless count_only or ingest_only) the BSI
    path, the TopN/GroupBy path, the hybrid path, the planner and the
    frozen loads, then (unless count_only) the write path, on the same
    server (bsi = values per shard, seed, clients, queries per client;
    topn = bits per shard of t's row 0, seed, clients, queries per client;
    hybrid = seed, clients, queries per client; ingest = writers,
    envelopes per writer, calls per envelope, readers, envelopes per
    writer in each on/off turn; frozen = phase 5d's cuts and
    configurations; typed = phase 5e's clients and queries per client).
    ingest_only loads s and r without the hybrid phase's checks."""
    import torch

    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.server import Server

    t0 = time.perf_counter()
    rows = make_rows(n_rows, n_shards, seed)
    extra = np.array([3, 99, SHARD_WIDTH + 5, 2 * SHARD_WIDTH + 7],
                     dtype=np.int64) % (n_shards * SHARD_WIDTH)
    t_rows = ([] if count_only or ingest_only
              else make_topn_rows(n_shards, *topn[:2]))
    log(f"  data: {n_rows} rows x {n_shards} shards, "
        f"{sum(r.size for r in rows)} bits; {len(t_rows)} rows of t, "
        f"{sum(r.size for r in t_rows)} bits "
        f"({time.perf_counter() - t0:.1f} s)")

    # the device profiler's first capture initialises the profiler's
    # client (the server does one at open); timed apart from the open
    t0 = time.perf_counter()
    if device == "cuda":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        with torch_profile(activities=[ProfilerActivity.CUDA]):
            pass
    log(f"  the profiler's first (empty) capture: "
        f"{time.perf_counter() - t0:.1f} s")
    start_window()  # the main path starts here
    with tempfile.TemporaryDirectory(prefix="pilosa_torch_smoke_") as tmp:
        t0 = time.perf_counter()
        srv = Server(os.path.join(tmp, "data"), port=0, device=device).open()
        port = srv.http.port
        log(f"  server open: {time.perf_counter() - t0:.1f} s")
        # every pass but the planner phase's runs with the plan cache off
        # (the planner on): repeated queries would hit it and launch
        # nothing, and the passes measure the kernels
        srv.executor.plan_cache.enabled = False
        try:
            _http(port, "POST", "/index/i",
                  json.dumps({"options": {"trackExistence": True}}).encode())
            _http(port, "POST", "/index/i/field/f", b"{}")
            t0 = time.perf_counter()
            srv.api.import_bits("i", "f", *shard_major(rows, n_shards))
            _http(port, "POST", "/index/i/field/f/import", json.dumps(
                {"rowIDs": [0] * extra.size,
                 "columnIDs": extra.tolist()}).encode())
            load_s = time.perf_counter() - t0
            log(f"  import: {load_s:.1f} s")
            t0 = time.perf_counter()
            rows[0] = _union(rows[0], extra)
            packed = [packed_row(c, n_shards) for c in rows]
            exists = packed[0].copy()
            for x in packed[1:]:
                exists |= x
            log(f"  oracle: {time.perf_counter() - t0:.1f} s")
            p = packed
            t0 = time.perf_counter()

            checks = [
                ("Count(Row(f=0))", _popcount(p[0])),
                ("Count(Row(f=6))", _popcount(p[6])),
                ("Count(Intersect(Row(f=0), Row(f=1)))", _popcount(p[0] & p[1])),
                ("Count(Intersect(Row(f=1), Row(f=2), Row(f=3)))",
                 _popcount(p[1] & p[2] & p[3])),
                ("Count(Intersect(Row(f=0), Row(f=1), Row(f=2), Row(f=3)))",
                 _popcount(p[0] & p[1] & p[2] & p[3])),
                ("Count(Union(Row(f=2), Row(f=5)))", _popcount(p[2] | p[5])),
                ("Count(Xor(Row(f=3), Row(f=4)))", _popcount(p[3] ^ p[4])),
                ("Count(Difference(Row(f=5), Row(f=6)))",
                 _popcount(p[5] & ~p[6])),
                ("Count(Not(Row(f=7)))", _popcount(exists & ~p[7])),
                ("Count(Not(Union(Row(f=0), Row(f=1))))",
                 _popcount(exists & ~(p[0] | p[1]))),
                ("Count(Union(Intersect(Row(f=0), Row(f=1)), "
                 "Xor(Row(f=2), Row(f=3)), Not(Row(f=4))))",
                 _popcount((p[0] & p[1]) | (p[2] ^ p[3]) | (exists & ~p[4]))),
            ]
            # 40 Rows resolve to 40 leaves, each read by the kernel
            wide = [int(r) for r in np.random.default_rng(seed).permutation(
                np.arange(40) % n_rows)]
            rows_pql = ", ".join(f"Row(f={r})" for r in wide)
            xor_all = np.zeros_like(p[0])
            for r in wide:
                xor_all ^= p[r]
            checks += [(f"Count(Union({rows_pql}))", _popcount(exists)),
                       (f"Count(Xor({rows_pql}))", _popcount(xor_all))]
            log(f"  the checks' oracle: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            for pql, want in checks:
                got = _http(port, "POST", "/index/i/query",
                            pql.encode())["results"][0]
                if got != want:
                    raise AssertionError(f"{pql}: port {got} != oracle {want}")
                log(f"  {pql[:100]} = {got} (oracle agrees)")
            sub = [s for s in (0, 1) if s < n_shards]
            got = _http(port, "POST", "/index/i/query?shards="
                        + ",".join(map(str, sub)), b"Row(f=2)")
            want_cols = rows[2][rows[2] < (max(sub) + 1) * SHARD_WIDTH]
            if got["results"][0]["columns"] != want_cols.tolist():
                raise AssertionError("Row(f=2) ?shards=0,1 differs from the "
                                     "oracle")
            log(f"  Row(f=2) ?shards={sub}: {want_cols.size} columns "
                "(oracle agrees)")
            single_s = time.perf_counter() - t0

            # the pair oracle: each unordered pair once (phase 6 reuses it)
            t0 = time.perf_counter()
            pair = np.zeros((n_rows, n_rows), dtype=np.int64)
            for a in range(n_rows):
                for b in range(a, n_rows):
                    pair[a, b] = pair[b, a] = _and_count(p[a], p[b])
            log(f"  single queries {single_s:.1f} s; pair oracle "
                f"{time.perf_counter() - t0:.1f} s")

            count_mix = [(f"Count(Intersect(Row(f={a}), Row(f={b})))",
                          int(pair[a, b]))
                         for a in range(n_rows) for b in range(n_rows)]

            def run_clients(n_per_client: int, salt: int, during=None):
                """clients threads x n_per_client Count(Intersect) over
                HTTP -> (latencies, wall seconds, what during() gave while
                they ran); answers checked."""
                return concurrent_mix(port, clients, n_per_client,
                                      count_mix, seed + salt, during)

            # host time of each batch's dispatch (plan, pointer table,
            # launch), timed around the CountBatcher's own method
            count_batcher = srv.executor.batcher
            dispatch, dispatch_s = count_batcher._dispatch, []

            def timed_dispatch(key, payloads):
                t = time.perf_counter()
                try:
                    return dispatch(key, payloads)
                finally:
                    dispatch_s.append(time.perf_counter() - t)

            count_batcher._dispatch = timed_dispatch
            t_pass = time.perf_counter()
            lat, wall, obs = run_clients(per_client, 1000, lambda: during_pass(
                port, ("Count(Intersect(Row(f=0), Row(f=1)))",
                       "CountBatcher"), CAPTURE_S))
            torch.cuda.synchronize()
            launches = kernels.launch_counts()  # the main path ends here
            del count_batcher._dispatch
            obs["scrape"] = observe_path(port, "count", launches)
            log(f"  (the pass and its scrape: "
                f"{time.perf_counter() - t_pass:.1f} s)")
            batcher = count_batcher.snapshot()
            res = srv.executor.residency.snapshot()
            stats = {
                "queries": len(lat), "qps": len(lat) / wall,
                "p50_ms": statistics.median(lat) * 1e3,
                "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                "max_batch_seen": batcher["max_batch_seen"],
                "batches": batcher["batches"],
                "batched_queries": batcher["batched_queries"],
                "resident_bytes": res["bytes"],
                "resident_entries": res["entries"],
                "import_s": load_s, "single_queries_s": single_s,
                "dispatch_host_ms": (statistics.mean(dispatch_s) * 1e3
                                     if dispatch_s else None),
                "dispatch_host_ms_p50": (statistics.median(dispatch_s) * 1e3
                                         if dispatch_s else None),
            }
            log(f"  concurrent: {clients} clients x {per_client} "
                f"Count(Intersect), plan cache off: {stats['qps']:.1f} q/s, "
                f"p50 "
                f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, "
                f"max_batch_seen {stats['max_batch_seen']}; dispatch host "
                f"{_us(stats['dispatch_host_ms'])} us a batch (mean)")
            log(f"  resident leaves: {res['entries']} entries, "
                f"{res['bytes']} bytes")
            if profile:
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as torch_profile

                n = max(per_client // 4, 1)
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    _, pwall, _ = run_clients(n, 2000)
                    torch.cuda.synchronize()
                busy = device_busy_ms(prof)
                stats["profiled_queries"] = clients * n
                stats["profiled_wall_ms"] = pwall * 1e3
                stats["device_busy_ms"] = busy
                stats["device_idle_share"] = (
                    None if busy is None else 1.0 - busy / (pwall * 1e3))
                log(f"  profiled pass: {clients} clients x {n} queries in "
                    f"{pwall * 1e3:.1f} ms, device busy "
                    + ("not measured (the profiler saw no device events)"
                       if busy is None else
                       f"{busy:.3f} ms, idle share "
                       f"{stats['device_idle_share']:.4f}"))
            log(f"  launches on the Count path: {launches}")
            for name in COUNT_KERNELS:
                if launches[name] < 1:
                    raise AssertionError(
                        f"{name} never launched on the Count path")
            if stats["max_batch_seen"] < 2:
                raise AssertionError("the CountBatcher never coalesced")
            t0 = time.perf_counter()
            obs["rounds"] = obs_rounds(srv, run_clients)
            log(f"  (rounds: {time.perf_counter() - t0:.1f} s)")
            log("phase 2q: multi-tenant QoS on the Count path's server")
            qos = qos_phase(srv, port, count_mix, pair, stats, run_clients,
                            seed)
            out = {"launches": launches, "stats": stats, "obs": obs,
                   "qos": qos}
            if count_only:
                return out
            if ingest_only:
                s_rows, r_rows, _ = load_hybrid_fields(srv, port, n_shards,
                                                       hybrid[0])
                exists_all = exists.copy()
                for cols in (*s_rows, *r_rows):
                    exists_all |= packed_row(cols, n_shards)
            else:
                log("phase 3: BSI path on the same server")
                out["bsi"], values = bsi_phase(srv, port, p, exists,
                                               n_shards, *bsi)
                log("phase 4: TopN/Rows/GroupBy path on the same server")
                out["topn"] = topn_phase(srv, port, p, values, t_rows,
                                         n_shards, *topn[1:])
                log("phase 5: hybrid sparse/run leaves on the same server")
                out["hybrid"] = hybrid_phase(
                    srv, port, p, exists, values, t_rows,
                    out["topn"]["stats"]["cleared_t0_column"], n_shards,
                    *hybrid)
                exists_all, s_rows, r_rows = out["hybrid"].pop("data")
                log("phase 5b: five fields read in turn, the heat map "
                    "spilling")
                out["spill"] = spill_rounds(
                    srv, port, clients, five_field_queries(
                        p, values, t_rows, s_rows, r_rows), seed)
                log("phase 5c: the planner and the plan cache on the same "
                    "server")
                out["planner"] = planner_phase(srv, port, p, rows, s_rows,
                                               pair, n_shards, clients, seed)
                log("phase 5d: frozen bulk loads on the same server")
                out["frozen"] = frozen_phase(srv, port, *frozen, seed)
                log("phase 5e: typed fields (Star Trace) on the same server")
                out["typed"] = typed_phase(srv, port, n_shards, seed, *typed)
                # phase 5g's node processes start now, so that their
                # start (host work in processes of their own) runs beside
                # phase 5f; cluster_phase stops them
                cl_tmp = tempfile.TemporaryDirectory(
                    prefix="pilosa_torch_cluster_")
                cl_nodes = ClusterNodes(cl_tmp.name, CLUSTER_NODES)
                gossip = None
                # phase 5i's crash writer starts here too (its own data
                # dir): it is SIGKILLed once it has acknowledged
                # FAULT_CRASH_ACKS bits, and phase 5i reopens its dir
                fw_tmp = tempfile.TemporaryDirectory(
                    prefix="pilosa_torch_crash_")
                fault_writer = CrashWriter(os.path.join(fw_tmp.name, "d"))
                try:
                    try:
                        for i in range(CLUSTER_NODES):
                            cl_nodes.start(i)
                        gossip = GossipPair(cl_tmp.name)
                        log("phase 5f: string keys and attributes (a keyed "
                            "language field on the Star Trace index, a "
                            "keyed-column index of user logins) on the same "
                            "server")
                        out["keyed"] = keyed_phase(srv, port, n_shards, seed,
                                                   out["typed"].pop("data"))
                        delete_typed(srv, out["typed"]["stats"])
                        # the node processes share the card: this server's
                        # resident leaves and cached results go (phase 6
                        # rebuilds what it reads), and so do the allocator's
                        # free blocks; with them kept, 5.9 GB was left and a
                        # node ran out
                        srv.executor.clear_caches()
                        torch.cuda.empty_cache()
                        log(f"phase 5g: the cluster, {CLUSTER_NODES} port "
                            f"node processes over {CLUSTER_SHARDS} shards, "
                            f"replicas 2 (device memory free "
                            f"{torch.cuda.mem_get_info()[0]} bytes)")
                        out["cluster"] = cluster_phase(seed, cl_nodes, gossip)
                    finally:
                        cl_nodes.stop()
                        if gossip is not None:
                            gossip.stop()
                        cl_tmp.cleanup()
                    log(f"phase 5i: faults and operations, 3 in-process "
                        f"port nodes over {FAULT_SHARDS} shards, replicas 2 "
                        f"(device memory free "
                        f"{torch.cuda.mem_get_info()[0]} bytes)")
                    out["faults"] = faults_phase(seed, device, fault_writer)
                finally:
                    fault_writer.stop()
                    fw_tmp.cleanup()
            log("phase 6: write path (coalesced Set/Clear) on the same "
                "server, under concurrent reads")
            out["ingest"] = ingest_phase(srv, port, p, exists_all, s_rows,
                                         r_rows, n_shards, seed, *ingest,
                                         pair=pair)
            return out
        finally:
            srv.close()


# the device kernels of each wrapper, as a capture's trace names them
DEVICE_NAMES = {"pair_stream_counts": ("pair_stream_kernel",),
                "program_count": ("program_count_kernel",
                                  "program_count_table_kernel"),
                "intersect_count": ("intersect_count_kernel",),
                "bsi_compare": ("bsi_compare_kernel",),
                "bsi_sum_counts": tuple(SUM_FORM_KERNELS.values()),
                "topn_counts_packed": ("topn_counts_kernel",),
                "cross_count_matrix": ("cross_count_kernel",),
                "sparse_intersect_dense": ("sparse_dense_kernel",)}


def served_times(name: str, paths: dict) -> dict:
    """A kernel as served: its device ms p50 from the path captures (the
    device kernel the captures saw most, on the capture that saw it most;
    None where none did), and its stream ms p50 by CUDA events over the
    pairs alone on the stream (on the path with the most such pairs;
    None where none was), how many, and the pairs overlapped on every
    path."""
    dev, seen = None, 0
    for p in paths.values():
        cap = p["obs"].get("capture")
        if cap is None:  # a path without a concurrent pass
            continue
        for k in DEVICE_NAMES[name]:
            if cap["kernels"].get(k, 0) > seen:
                seen, dev = cap["kernels"][k], cap["kernelMs"][k]["p50Ms"]
    best, over = None, 0
    for p in paths.values():
        rec = p["obs"]["scrape"]["kernels"].get(name)
        if rec is None:
            continue
        over += rec["overlapped"]
        if rec["timed"] and (best is None or rec["timed"] > best["timed"]):
            best = rec
    return {"served_device_ms_p50": dev, "served_device_launches": seen,
            "served_stream_ms_p50": None if best is None else best["p50Ms"],
            "served_stream_pairs": 0 if best is None else best["timed"],
            "served_stream_overlapped": over}


def obs_summary(paths: dict, touch: dict, spill: dict) -> dict:
    """Per path: the capture's idle share, the profiled query, the event
    pool; the Count pass's telemetry on/off rounds; the five-field heat
    on/off rounds; touch_many's µs."""
    out = {"heat_touch": touch, "rounds": paths["count"]["obs"]["rounds"],
           "spill_rounds": spill}
    for name, p in paths.items():
        o = p["obs"]
        if "capture" not in o:
            continue
        out[name] = {"capture": o["capture"],
                     "profile": {k: o["profile"][k] for k in
                                 ("pql", "elapsedMs", "residency")},
                     "untimed": o["scrape"]["untimed"],
                     "overlapped": o["scrape"]["overlapped"],
                     "event_pool_pairs": o["scrape"]["event_pool_pairs"],
                     "hbm_drift_bytes": o["scrape"]["hbm_drift_bytes"],
                     "heat_totals": o["scrape"]["heat_totals"]}
    return out


def frozen_only(device, scale, configs, seed: int) -> dict:
    """Phase 5d alone on a fresh server: at its own cuts (scale None), or
    every configuration at `scale` of its full size (the similarity corpus
    at ten times that share, at most its full 500,000 molecules)."""
    from pilosa_tpu_torch.server import Server

    if scale is None:
        cuts = dict(FROZEN_CUTS)
    else:
        cuts = {k: max(1, int(round(v * scale)))
                for k, v in FROZEN_FULL.items()}
        cuts["c2_rows"] = max(cuts["c2_rows"], 2 * C2_HEAD)
        cuts["c3_rows"] = max(cuts["c3_rows"], 2 * C3_HEAD)
        cuts["sim_molecules"] = min(FROZEN_FULL["sim_molecules"], max(
            1000, int(FROZEN_FULL["sim_molecules"] * scale * 10)))
    free = subprocess.run(["free", "-g"], capture_output=True,
                          text=True).stdout
    log(f"phase 5d alone at scale {scale}: {cuts}; host memory (free -g):"
        f"\n{free}")
    with tempfile.TemporaryDirectory(prefix="pilosa_torch_frozen_") as tmp:
        srv = Server(os.path.join(tmp, "data"), port=0, device=device).open()
        srv.executor.plan_cache.enabled = False
        try:
            out = frozen_phase(srv, srv.http.port, cuts, configs, seed)
        finally:
            srv.close()
    return {"scale": scale, "launches": out["launches"], **out["stats"]}


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--slab-rows", type=int, default=32)
    ap.add_argument("--k", type=int, default=1024)
    # timed runs a kernel measurement: 2 since the drill's healing steps
    # (3 since phase 5g joined the run, 4 since 5f, 6 since 5e, 10
    # before), to keep the whole run inside its time limit
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--clients", type=int, default=32)
    # the Count pass: 8 a client since phase 5g joined the run (16 since
    # 5f, 32 since 5e, 64 before)
    ap.add_argument("--per-client", type=int, default=8)
    ap.add_argument("--bsi-per-shard", type=int, default=32768,
                    help="int values per shard of the BSI phase")
    ap.add_argument("--bsi-clients", type=int, default=32)
    # the BSI pass: 4 a client since phase 5g joined the run (8 since 5f,
    # 16 before)
    ap.add_argument("--bsi-per-client", type=int, default=4)
    ap.add_argument("--profile", action="store_true",
                    help="after the measured pass, run one more under "
                         "torch.profiler and print the device's idle share")
    ap.add_argument("--count-only", action="store_true",
                    help="drive the Count path alone and print its numbers")
    ap.add_argument("--ingest-only", action="store_true",
                    help="drive the Count path's import and the write path "
                         "alone and print the write path's numbers")
    ap.add_argument("--frozen-only", action="store_true",
                    help="run phases 1 and 5d alone at phase 5d's own cuts "
                         "and print their numbers")
    ap.add_argument("--frozen-scale", type=float, default=None,
                    help="run phases 1 and 5d alone, every configuration "
                         "at this share of its full size (1.0: the "
                         "BASELINE's sizes), and print their numbers")
    ap.add_argument("--frozen-configs", default=",".join(FROZEN_CONFIGS),
                    help="phase 5d's configurations, comma-separated, of "
                         + ", ".join(FROZEN_CONFIGS))
    ap.add_argument("--typed-only", action="store_true",
                    help="run phases 1 and 5e alone and print their "
                         "numbers")
    ap.add_argument("--keyed-only", action="store_true",
                    help="run phase 1, phase 5e's loads and phase 5f alone "
                         "and print their numbers")
    ap.add_argument("--cluster-only", action="store_true",
                    help="run phases 1, 5g and 5h alone and print their "
                         "numbers")
    ap.add_argument("--faults-only", action="store_true",
                    help="run phases 1 and 5i alone and print their "
                         "numbers")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time program_count, intersect_count and "
                         "sparse_intersect_dense alone (no server) and "
                         "print their numbers")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from pilosa_tpu_torch.ops import _build

    device = "cuda"
    t_start = time.perf_counter()
    smi_name = smi("name,power.limit")
    log(f"phase 1: {smi_name}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    _build.load()
    log(f"  kernels built in {_build.build_info['seconds']:.1f} s: "
        f"{_build.build_info['path']}")
    ptxas = ptxas_phase(_build)
    touch = heat_touch_us(args.shards)

    if args.kernel_times:
        measured = kernel_times(device, args.shards, 32768, args.seed,
                                args.runs)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"kernel_times": measured, "ptxas": ptxas}),
              flush=True)
        return 0
    configs = tuple(c for c in args.frozen_configs.split(",") if c)
    if set(configs) - set(FROZEN_CONFIGS):
        raise SystemExit(f"unknown configurations {configs}")
    if args.typed_only:
        measured = typed_only(device, args.seed)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"typed": measured}), flush=True)
        return 0
    if args.cluster_only:
        log(f"phase 5g: the cluster, {CLUSTER_NODES} port node processes "
            f"over {CLUSTER_SHARDS} shards, replicas 2, then phase 5h")
        measured = cluster_phase(args.seed)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"cluster": measured}), flush=True)
        return 0
    if args.faults_only:
        log(f"phase 5i: faults and operations, 3 in-process port nodes "
            f"over {FAULT_SHARDS} shards, replicas 2")
        measured = faults_phase(args.seed, device)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"faults": measured}), flush=True)
        return 0
    if args.keyed_only:
        measured = keyed_only(device, args.seed)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"keyed": measured}), flush=True)
        return 0
    if args.frozen_only or args.frozen_scale is not None:
        measured = frozen_only(device, args.frozen_scale, configs, args.seed)
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"frozen": measured}), flush=True)
        return 0
    log(f"phase 2: server over {args.shards} shards, Count path")
    served = server_phase(device, args.shards, args.rows, args.seed,
                          args.clients, args.per_client, args.profile,
                          (args.bsi_per_shard, args.seed, args.bsi_clients,
                           args.bsi_per_client),
                          (TOPN_BITS, args.seed, TOPN_CLIENTS,
                           TOPN_PER_CLIENT),
                          (args.seed, HYBRID_CLIENTS, HYBRID_PER_CLIENT),
                          (INGEST_WRITERS, INGEST_ENVELOPES, INGEST_CALLS,
                           INGEST_READERS, INGEST_TURN_ENVELOPES),
                          args.count_only, args.ingest_only,
                          (FROZEN_CUTS, configs))
    st = served["stats"]
    if args.count_only:
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"count_path": st, "launches": served["launches"],
                          "obs": served["obs"], "qos": served["qos"],
                          "heat_touch": touch}), flush=True)
        return 0
    if args.ingest_only:
        log(f"  total {time.perf_counter() - t_start:.1f} s")
        print(smi_name)
        print(json.dumps({"write_path": served["ingest"]["stats"],
                          "launches": served["ingest"]["launches"]}),
              flush=True)
        return 0
    log(f"  phases 2-6: {time.perf_counter() - t_start:.1f} s since the "
        "start")
    k_served = max(1, round(st["batched_queries"] / max(st["batches"], 1)))
    bst = served["bsi"]["stats"]
    k_sum = max(1, round(bst["batched_queries"] / max(bst["batches"], 1)))

    gc.collect()  # the closed server's resident tensors
    torch.cuda.empty_cache()
    served_k = served["hybrid"]["stats"]["served_k"]
    log(f"phase 7: kernels at S={args.shards}, W=32768 (served mean "
        f"batches: pair stream K={k_served}, BSI sum K={k_sum}; sparse "
        f"rows K={served_k})")
    measured = kernel_phase(device, args.shards, 32768, args.slab_rows,
                            args.k, k_served, args.seed, args.runs)
    measured.update(bsi_kernel_phase(device, args.shards, 32768, k_sum,
                                     args.seed, args.runs))
    fst = served["frozen"]["stats"].get("config4")
    k_minmax = round(fst["minmax"]["mean_batch"]) if fst else 1
    descent = minmax_descent_phase(device, args.shards, 32768, k_minmax,
                                   args.seed, args.runs)
    measured.update(topn_kernel_phase(device, args.shards, 32768, args.seed,
                                      args.runs))
    measured.update(hybrid_kernel_phase(device, args.shards, 32768, served_k,
                                        args.seed, args.runs))

    records = []
    paths = {"count": served, "bsi": served["bsi"], "topn": served["topn"],
             "hybrid": served["hybrid"], "planner": served["planner"],
             "frozen": served["frozen"], "typed": served["typed"],
             "keyed": served["keyed"], "cluster": served["cluster"],
             "faults": served["faults"], "ingest": served["ingest"]}
    for name, m in measured.items():
        # launches on every path of the main run (each path zeroes the
        # counts before its first query and reads them after its last)
        by_path = {p: paths[p]["launches"][name] for p in paths}
        phase = (served["bsi"] if name in BSI_KERNELS
                 else served["topn"] if name in TOPN_KERNELS
                 else served["hybrid"] if name in HYBRID_KERNELS else served)
        record = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            **served_times(name, paths)}
        by_form = {k.split("/", 1)[1]: v
                   for k, v in phase.get("forms", {}).items()
                   if k.startswith(name + "/")}
        if by_form:
            record["launches_by_form"] = by_form
            record["form"] = m["form"]
        records.append(record)
    log("  library_ms: none (no single PyTorch call computes a popcount of "
        "a bitwise op, a bit-sliced comparison, per-plane filtered "
        "popcounts, packed TopN counts or a popcount cross matrix: torch "
        "has no popcount; nor a gather, bit test and ordered compaction)")
    details = {"kernels": measured, **served, "minmax_descent": descent}
    log(f"  details: {json.dumps(details)}")
    log("  observability: "
        + json.dumps(obs_summary(paths, touch, served["spill"])))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi_name)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
