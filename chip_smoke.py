#!/usr/bin/env python3
"""On-card smoke run of spark_rapids_tpu_torch, the PyTorch + CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero). Before
phase 1 the script exits non-zero unless every
``spark.rapids.sql.native.*`` gate is live (``native.master_enabled()``
and each ``kernel_enabled``), so no env key can make a run pass without
the kernels. After each phase from 3 on, the plan cache is cleared (its
templates pin their sources and packed encodings; a later phase's first
run stays a first run) and the peak and current host RSS and the
seconds since the script started are printed. An oracle is computed
once a run and shared by the phases that check the query.

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them.
2. Build: the hand-written kernels compile from ``csrc/`` into the
   package's ignored ``build/`` directory (one nvcc per source, all
   started together): ``radix_rank.cu`` (K1), ``join_probe.cu`` (K3),
   ``seg_scan.cu`` (K2) and ``rle_decode.cu`` (K4).
3. Kernel: ``stable_argsort_u32`` (kernel K1, one C call a sort) on
   random, duplicate-heavy and 0/1 (three digits of one bucket) u32 keys,
   and on random keys through a row permutation, at capacities 512,
   786 432 and 4 194 304 must equal its plain-PyTorch version and its
   library route (``native.stable_argsort_u32_library``: a stable
   ``torch.sort`` of the keys widened to int64, what
   ``native.radixSort=false`` runs) bit for bit; kernel, plain,
   ``torch.sort`` (gather, sort, gather with the permutation) and
   library-route times (CUDA events) beside the function's byte bound and
   the passes' byte bound.
   The profiler's device time of one 786 432-row sort is printed beside
   its CUDA-event time.
4. Path: TPC-H Q1 at scale factor 1 (8 partitions, seed 0) through
   ``tpch_q1_plan(...).collect()`` on the card, checked against a numpy
   oracle in this file (group keys and counts exact, sums and averages to
   rtol 1e-9); K1's launch counter must rise during the run.
5. Kernel: ``searchsorted_u64_pair`` (kernel K3) must equal its plain
   version bit for bit on edge cases (empty, 1- and 3-entry and
   all-sentinel builds, a run of equal keys longer than a pivot spacing,
   at every lane count the wrapper takes: 32, 16, 8 and 1), then on
   full-range u64 fingerprints with runs and a sentinel tail at (build x
   probe) 512 x 512 (32 lanes), 3 145 728 x 6 000 / 12 000 / 20 000 /
   150 000 (16, 8, 1 and 1 lanes) and 4 194 304 x 4 194 304 (1 lane, with
   its profiled device time);
   kernel and two-``torch.searchsorted`` times in turns (medians of 5),
   the plain version's time (also K3's library route, what
   ``native.joinProbe=false`` runs) and the bound, with the lane count
   and search steps of each launch.
6. Paths: TPC-H Q3 and Q4 at scale factor 1 (seed 0; ORDERS and LINEITEM
   in 8 partitions, CUSTOMER in 4) through ``tpch_q3_plan`` /
   ``tpch_q4_plan``, checked against numpy oracles in this file (keys,
   counts and the top-10 order exact, revenue to rtol 1e-9). K3 must
   launch during Q4 (its semi join probes a build with runs of 7); Q3's
   joins take the dense table and its K3 launches are printed (0
   expected). K3 is then checked and timed again on the exact
   fingerprints of Q4's first probe, warm, by its profiled device time,
   and with a cold L2 (64 MiB written before each call, per-call CUDA
   events).
7. Kernel: ``seg_reduce`` (kernel K2, the per-group function in one C
   call) for every kind (sum, min and max over u32 and over u64 keys) at
   512, 786 432 and 4 194 304 rows, in segments of 1-64 rows and segments
   spanning many tiles, must equal its plain version (running scan +
   finish) bit for bit, 20 launches in a row at the largest size, also
   with the whole column one segment and with a capacity below the
   largest id; against one ``scatter_reduce_`` into an identity-filled
   output bit for bit where every id fits, and against its library route
   (``native.segment_reduce_library``, the same scatter over sign-flipped
   keys with a slot for ids past the capacity, what
   ``native.segmentReduce=false`` runs). Times of K2, the plain version,
   the scatter_reduce and the library route beside the byte bound.
8. Path: TPC-H Q2 at scale factor 1 (PART and PARTSUPP in 4 partitions,
   SUPPLIER, NATION and REGION in 1) through ``tpch_q2_plan``, checked
   against a numpy oracle in this file: rows and their order exact. K2
   must launch during Q2 (its min aggregate) and K3 (the fast probe path);
   K1's launches and K2's and K3's shapes are printed. K2 is then checked
   (20 launches), timed and profiled again on Q2's largest launch, and K3
   on Q2's first probe.
9. Kernel: ``rle_decode`` (kernel K4, the wire codec's RLE expansion) at
   capacities 512, 786 432 and 4 194 304 for int8, int16, int32, int64,
   float32 and float64 run tables (-0.0 and NaN-payload runs among the
   values) with 1, 8, 2 048, 2 049, 4 096 and rows/4 runs and
   ``num_rows < cap``, full tables included, and a table of one run per
   row, must equal its plain version (searchsorted + gather, also K4's
   library route, what ``native.rleDecode=false`` runs) bit for bit;
   kernel and ``torch.repeat_interleave`` times in turns (medians of 5,
   the latter where the table is not full), the plain version's time
   and the byte bound, and at 4 194 304 rows with rows/4 runs the
   kernel's profiled device time. A table of at most
   ``native.RLE_SMEM_RUNS`` entries is staged whole by every block, a
   larger one is cut into block windows by searches; each log line names
   which. Then a 2 097 152-row int64 column in runs of 4 (524 288 runs,
   the most the encoder run-codes, far above the JAX package's 4 096-run
   ``rleDecode.maxRuns``) through the wire codec's upload must launch K4
   once, call no library route and give the column back.
10. Codec: the walls of q1, q3, q4 and q2 under the default ``v2`` wire
   codec and under ``plain`` (``ExecContext(conf)``): plain's first run
   (the sources pack their batches once per codec and keep them), then
   warm runs in turns (v2, plain, plain, v2), and the host encode time
   of one q1 partition split by column (its pack must equal the one q1's
   source kept). Each path above prints, for its first run, its
   ``codecCols.*`` counts and its encoded vs raw bytes; q3 must launch K4
   (its ``o_shippriority``
   ships as a run table: 8 launches expected), and K4 is checked and
   timed again on the exact inputs of q3's first launch.
11. DataFrame: TPC-H q1-q6 through ``TpuSession`` (``variableFloatAgg``
   on) and the port's ``benchmarks/tpch.py``, the reference's query text,
   over in-memory scans of the same SF1 columns: each query's planning
   time (host ms) and exec tree, its first run (launch counters around it
   alone) and a warm run (two until phase 23), every run checked against
   its numpy oracle (q5
   and q6 have theirs here); q1-q4's rows must equal the hand-built
   trees' (floats to rtol 1e-9) in this process. K1 must launch in every
   query but q6, K2 in q2, K3 in q4 and q2, K4 in q3. The inputs of
   every K2, K3 and K4 launch of each first run are recorded; each launch
   of a shape no hand-built path gave (q4's one probe of its whole
   coalesced ORDERS side) must equal the kernel's plain version bit for
   bit, and the largest such launch of a query is timed against its
   plain version and library call, with its device time. Then q1's
   device launches (``torch.profiler`` device events) in one warm run
   with the arithmetic's subnormal flush and in one with it patched out
   (as before the repair), both runs against the oracle.
12. Default conf: q1-q6 through ``TpuSession()`` with no conf (over
   phase 11's tables and oracles), whose
   float Sum/Avg aggregates the planner places on the host engine (numpy)
   between device subtrees, bridged by ``DeviceToHostExec`` and
   ``HostToDeviceExec``. Each query's host-tagged nodes must be the
   Aggregate in q1, q3, q5 and q6 and none in q2 and q4; its bridges and
   the rows and bytes each download moves are printed. Its first run
   (counters around it alone, every K1-K4 launch recorded) must match the
   numpy oracle and launch K1 in q1, q3, q5, q2 and q4, K2 in q2, K3 in
   q2 and q4, K4 in q3; each launch of a shape no earlier phase checked
   must equal the kernel's plain version bit for bit. Warm walls in one
   turn (three until phase 23, two until phase 24) beside the same query
   with
   ``variableFloatAgg`` on (phase 11's
   all-device tree), each run checked, with the host engine's share of
   each default-conf wall (host clock inside the host subtrees less the
   device subtrees and downloads below them).
13. Conditionals, IN lists, Divide and date parts: TPCxBB q5 (scale 1:
   4,000,000 clickstream rows, 100,000 customers, 20,000 demographics,
   18,000 items; the reference generator's stream replayed by
   ``benchmarks/suites.py``) and TPC-H q7, q8, q9, q12, q14 and q19
   (SF1) through ``TpuSession`` and the
   reference's query text, each once with ``variableFloatAgg`` on (every
   node on the card) and once under the default conf (the float Sum
   aggregates of q7, q8, q9, q14 and q19 on the host engine; q12's and
   xbb_q5's integer sums on the card). For each run: the plan's host
   nodes and bridges (checked), the rows and bytes each
   ``DeviceToHostExec`` downloads, the first run (counters around it
   alone, every K1-K4 launch recorded; no warm run since phase 24
   needed the time, two until phase 21), checked
   against a numpy oracle in this file (keys, counts and order exact,
   floats to rtol 1e-9; xbb_q5 as a multiset, the query has no order).
   K1 must launch in xbb_q5, q7, q8, q9 and q12 under both confs. Each
   K1-K4 launch of a shape no earlier phase checked must equal the
   kernel's plain version bit for bit. The phase's time is printed.
14. Grouping sets and windows: TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89
   and ds_q98 (scale 1: 2,880,000 store_sales rows, 18,000 items, 12
   stores, 731 dates; the reference generator's stream replayed by
   ``benchmarks/suites.py``) through ``TpuSession`` and the reference's
   query text, once with ``variableFloatAgg`` on and once under the
   default conf (each float Sum aggregate on the host engine, q67's
   ROLLUP ``ExpandExec`` with it; the windows and sorts on the card).
   For each run: host nodes and bridges (checked), rows and bytes
   downloaded, the first run (counters around it alone, every K1-K4
   launch recorded) and one warm run under ``variableFloatAgg`` (none
   under the default conf, for the script's time budget; two, and one
   for q67 under it, until phase 22), each checked
   against a numpy oracle in this file (q67, ds_q3, ds_q42 and ds_q55
   exactly, their sums being of whole numbers; ds_q89's averages and
   ds_q98's ratios to rtol 1e-9), and the peak device memory of the warm
   run. K1 must launch in every run, K2
   in ds_q89 and ds_q98 (the window's valid-row counts). Each K1-K4 launch
   of a shape no earlier phase checked must equal the kernel's plain
   version bit for bit; the largest new K1 shape is timed against its
   plain version and ``torch.sort``. The phase's time is printed.
15. COUNT DISTINCT and LIKE: TPCxBB xbb_q12 (scale 1: distinct
   non-NULL users per category over the 4,000,000 clickstream rows) and
   TPC-H q10, q13, q16, q17, q18 and q21 (SF1) through ``TpuSession`` and
   the reference's query text, once with ``variableFloatAgg`` on and once
   under the default conf (the float Sum/Avg aggregates of q10, q17 and
   q18 on the host engine; COUNT, COUNT DISTINCT and the joins on the
   card). For each run: host nodes and bridges (checked), rows and bytes
   downloaded, the first run (counters around it alone, every K1-K4
   launch recorded) and one warm run under ``variableFloatAgg`` (two
   until phase 21; none under the default conf, for the script's time
   budget), each checked against a numpy
   oracle in this file (keys, counts and order exact, floats to rtol
   1e-9; q10 as a set, as the reference compares it; the LIKE patterns
   of q13 and q16 evaluated by Python's ``re`` over the comment pools),
   and the peak device memory of the warm runs. K1 must launch in every
   run but q17 under the default conf, K3 in q13's left join and q21's
   self-joins, whose builds repeat keys. Each K1-K4 launch of a shape no
   earlier phase checked must equal the kernel's plain version bit for
   bit. The phase's time is printed.
16. The exchange: (a) ``repart`` (scale 1: all 4,000,000 clickstream
   rows through a 16-way hash exchange, then counted per bucket) under
   both confs, its bucket counts against a numpy murmur3 oracle in this
   file (they must sum to 4,000,000), and the repartition's
   ``ShuffleExchangeExec`` run alone: every row of output partition p
   must hash to p; (b) TPC-H q11, q15, q20 and q22 (SF1: cross joins for
   the scalar subqueries, a fixed-width cast, ``substr``) under both
   confs against numpy oracles (q11 as a set); (c) with
   ``spark.rapids.sql.shuffle.partitions=8``: q1 (hash and range
   exchanges), q4 (a shuffled semi join), q13 (a shuffled left join),
   q18, q21 (shuffled semi and anti joins with a residual), xbb_q12 (the
   distinct pipeline) and ds_q89 (a partitioned window), each against its
   oracle and its one-partition run in this process (phase 11's, 14's or
   15's first run under the same conf; floats to rtol
   1e-9; the runtime re-plan, on by default, demotes each shuffled join
   whose observed build fits 64 MiB to a broadcast join: phase 25
   prints which); (d) a full outer join of CUSTOMER (c_acctbal > 0) and
   ORDERS on
   the customer key at 1 and 8 partitions, its matched, left-only and
   right-only row counts against numpy. For each run: host nodes and
   bridges, rows downloaded, the first run (counters around it alone,
   every K1-K4 launch recorded; no warm wall since phase 25 needed the
   time, one until then, two until phase 21). K1 must launch in every
   run, K3 in the
   shuffled joins of (c) (q4, q13, q21) and (d), whose builds repeat keys,
   K2 in ds_q89. Each K1-K4 launch of a shape no earlier phase checked
   must equal the kernel's plain version bit for bit; the largest new
   K3 shape of each run is timed against two ``torch.searchsorted``
   calls, with its bound. The phase's time is printed.
18. The memory tier and out-of-core execution (runs after phase 16),
   each run under ``variableFloatAgg`` once in core and once under a
   ``spark.rapids.memory.tpu.budgetBytes`` chosen, and printed, so its
   mechanism engages: (a) every LINEITEM row (SF1: 5,997,887, with its
   ``l_linenumber``) ordered by supplier, part, order and line under
   128 MiB with a 160 MiB host tier (at least four range buckets, entries
   on disk through the native LZ4 codec), downloaded as numpy and held
   to ``np.lexsort`` bit for bit; (b) q67 under its window's in-core
   staged bytes (the window range-splits on ``i_category``), its rows
   equal to the in-core run's; (c) q21 and q4 at one partition under a
   third of their smallest LINEITEM build (grace joins of at least two
   buckets, K3 at least once per non-empty build bucket), against their
   numpy oracles (the default conf: at one partition the runtime re-plan
   has no candidate); (d) q18 at 8 partitions under a quarter of the
   catalog's in-core high-water mark and a host tier of an eighth
   (exchange pieces spill device -> host -> disk), equal to its
   one-partition run; (e) q18 at one partition with the caching
   allocator capped (``torch.cuda.set_per_process_memory_fraction``) at
   a share of its in-core peak, then (f) q18 at 8 partitions with the
   runtime re-plan on (its ``Cost@query`` printed: an OOM that exhausts
   the ladder inside the re-plan's build keeps the static plan): a real
   ``torch.OutOfMemoryError`` inside
   a retry site must be recovered on the card by the ladder (the rungs
   printed; where they leave a join's probe step short, by splitting its
   batch, ``splitRetries``), rows equal, the fraction restored. For each run: rows
   checked, the first wall (no warm wall, for the script's time budget)
   beside the in-core run's, the first run's peak device memory beside
   the in-core peak,
   ``outOfCoreBuckets``, ``graceJoinPartitions``, the catalog's spill
   and restore counts and LZ4 bytes, the ladder, and K1-K4 launches;
   every K1-K4 launch of a shape no earlier phase checked must equal the
   plain version bit for bit. Every run's leak report must be empty and
   no run of phases 4-18 may fall back to the host engine. The phase's
   time is printed.
19. The numeric, date-time and row-source surface (runs after phase 18),
   through ``TpuSession`` and ``benchmarks/rowsource.py``, each run once
   under ``variableFloatAgg`` + ``improvedFloatOps`` (every node on the
   card) and once under the default conf: (a) ``session.range(0, 2^24,
   num_partitions=8)`` (a batch of 2,097,152 built on the card in each
   partition) with ``rand(7)``, ``monotonically_increasing_id()``,
   ``spark_partition_id()`` and the hour, minute and second of
   ``from_unixtime(id * 37)``, grouped by ``pmod(id, 4096)`` (count,
   sums, min / max of rand and of the id), every column bit for bit
   against a numpy oracle that recomputes the SplitMix64 stream in
   uint64; (b) LINEITEM at SF1, its first 1,048,576 lines, through a
   25-column projection (datediff, dayofweek, weekday, dayofyear, quarter,
   last_day, trunc MM, add_months, date_add, round, bround, floor, ceil,
   log, sqrt, exp, pow, least, greatest, abs, signum, isnan, nanvl,
   at_least_n_non_nulls), grouped by (month, day of week) with integer
   sums, min / max of every projected column and first / last of
   ``l_orderkey`` at one partition (floats to rtol 1e-9, the rest
   exact), and the projection's 1,048,576 rows downloaded: dates,
   integers, round, bround, floor and ceil bit for bit, each
   transcendental (and sqrt) within 4 ulp of numpy, its largest distance
   printed; (c) ship and receipt dates of those lines as one column
   (UNION ALL, 2,097,152 rows) by year and quarter, and range(0, 2^25)
   UNION ALL range(2^25, 2^26) at 8 + 8 partitions counted by partition
   id. Under the default
   conf the projection (log / exp / pow) and union_dates' float sum run on
   the host engine. For each run: host nodes and bridges (checked), rows
   downloaded, the first run (counters around it alone, every K1-K4
   launch recorded), one warm wall (two until phase 21) and the peak
   device memory of the warm run. K1 must launch in every run, K2 in (a)
   and (b) (Min/Max and
   the first / last picks); each K1-K4 launch of a shape no earlier phase
   checked must equal the kernel's plain version bit for bit, and the
   largest new K1 shape is timed against its plain version and
   ``torch.sort``. The phase's time is printed.
20. The string surface and generate (runs after phase 19), through
   ``TpuSession`` and ``benchmarks/stringsource.py`` over the SF1 tables,
   each run once under ``stringsource.ALL_DEVICE`` (variableFloatAgg,
   incompatibleOps, castFloatToString, castStringToFloat: every node on
   the card, the reference's host roundtrips inside it) and once under
   the default conf (the case maps, the float <-> string casts and the
   float sum on the host engine): (a) ORDERS (1,500,000 rows) through
   ``orders_etl`` (upper, lower, initcap, length, reverse, repeat, trims,
   substring_index, split, locate, instr, concat, concat_ws with a NULL
   first argument on a seventh of the rows, md5, the key, date and price
   cast to strings and back), its first 262,144 rows by key downloaded
   and compared byte for byte with a Python oracle here (``str``,
   ``hashlib.md5`` and the reference's format and parse rules; every
   round trip gives its value back, the price bit for bit), and
   ``comment_groups`` (by first word and priority: count, integer and
   string Min/Max); (b) CUSTOMER (150,000 rows) through regexp_replace,
   regexp_extract, replace, lpad and a key parsed from the name, PART
   (200,000) through translate and rpad, each ordered by key and checked
   against ``re`` / ``str``, and ORDERS joined to CUSTOMER on the parsed
   key by country code (count, revenue to rtol 1e-9); (c) LINEITEM
   (5,997,887 rows) through posexplode of its three dates by (position,
   year), explode of ship mode and instruction by label, and
   explode_outer of two conditional labels (the NULL group included),
   exact against numpy, run under the all-device conf (the default conf
   must plan the same exec trees, with no host node; until phase 21
   needed the time they also ran under it). For each run: host nodes and bridges (checked),
   rows downloaded, the rows and bytes through each host roundtrip, the
   first run (counters around it alone, every K1-K4 launch recorded),
   the torch ops of ``_greedy_matches`` and of MD5 (no warm wall since
   phase 25 needed the time; one until then but for etl head and the
   default conf, two until phase 21). K1 must launch in every
   run,
   K2 in comment_groups; each K1-K4 launch of a shape no earlier phase
   checked must equal the kernel's plain version bit for bit. The
   phase's time is printed.
21. The UDF tier (runs after phase 20), through ``TpuSession`` and
   ``benchmarks/udfsource.py`` over the SF1 tables: (a) TPC-H q1 with
   its ship-date filter and derived columns written as ``udf`` lambdas
   and a quantity band summed beside its aggregates (every UDF must
   compile; under the all-device conf and the default conf the plan's
   host nodes must be q1's text's, with no host roundtrip), run beside
   q1's text under the all-device conf (rows equal q1's to rtol 1e-9,
   the band exact against numpy, K1 launches equal) and once under the
   default conf; (b) ORDERS before 1995-04-17 (about 750,000 rows, a
   selection vector on each batch) through two UDFs that do not compile
   (a dict lookup of the priority's rank, a loop counting the comment's
   vowels), grouped by the rank: count, revenue (rtol 1e-9), the largest
   price and the vowels exact against a Python and numpy oracle; explain
   must carry each compile error, no node may be on the host,
   ``island.pyudf.rows`` must be the filtered rows times two, K2 must
   launch (the float Max), and a ``PythonUDF`` evaluated on a card batch
   must return its column on that batch's device; (c) where pandas is
   installed, ``map_in_pandas``, ``apply_in_pandas``, ``agg_in_pandas``
   and a cogroup at ``shuffle.partitions=8`` against numpy oracles;
   where it is not (the check comes before the phase runs them), one
   line says so. Each run's first run with every K1-K4 launch recorded
   (new shapes against the plain versions), its peak device memory and
   host roundtrips are printed (no warm wall since phase 25 needed the
   time, one until then, two until phase 22), and the phase's time.
22. File I/O and plan-text ingest (runs after phase 21; pyarrow is
   required, and its and pandas' versions are printed): (a) the SF1
   tables q1, q3, q4 and q6 read (LINEITEM's ten columns in 8
   partitions, ORDERS' five, CUSTOMER's two) written by
   ``DataFrame.write.parquet`` from in-memory scans on the card (each
   batch downloaded and written), with each table's ``last_stats`` and
   write wall; (b) q1, q3, q4 and q6 through ``benchmarks/tpch.py``
   ``qN(session, data_dir)``, the reference's text reading the parquet
   files under ``variableFloatAgg``: exec tree and join strategies beside
   phase 11's, a first run (launch counters around it alone, every K1-K4
   launch recorded and each new shape held to its plain version bit for
   bit; the scan's ``bufferTime``, ``decodeTime``, ``numOutputRows`` and
   the pipeline's ``hostPrefetchMs``, ``consumerWaitMs``,
   ``overlapRatio``) and a warm run whose ``scanCacheHits`` must be
   above 0, each against phase 11's numpy oracles; K1 must launch in q1,
   q3 and q4 and K3 in q4, and K4's launches are printed (q3's
   ``o_shippriority`` ships as runs); (c) q6 under PERFILE,
   MULTITHREADED and COALESCING and with the pipeline off (scan cache
   off): the same rows; ``l_orderkey <=`` the first file's largest key
   below the second file's smallest must skip at least 7 of LINEITEM's 8
   row groups and count as numpy does; (d) ``input_file_name()`` over
   LINEITEM: rows per path equal each file's parquet row count; (e) ORC
   and CSV round trips of ORDERS' four q3 columns (200,000 rows in two
   files) give the written rows, and a pushed predicate skips one ORC
   stripe; (f) the captured Spark plans
   ``tests/fixtures/spark_plans/q6.txt`` and ``q3.txt`` ingested against
   the written files give the query text's rows; (g) with the scan cache
   still full, q18 (in memory, one partition) under a capped allocator,
   as phase 18's (e): a real OOM whose ladder must start with
   ``drop-scan-cache`` (the spill catalog does not hold the cache), leave
   no cache entry on the card and give the oracle's rows. The scan cache
   is cleared at the end, and the directory deleted after phase 23, which
   reads the files again; the phase's time is
   printed.
23. The native gates, the plan cache with bind slots and stage fusion
   (runs after phase 22), under ``variableFloatAgg``, every run against
   phase 11's numpy oracles (or its own, with its literals): (a) q1, q2,
   q3 and q4 on phase 11's templates, run in turns with the gates on,
   with ``native.enabled=false`` (zero K1-K4 launches, a library call
   where each kernel ran, rows bit for bit) and with only the query's own
   kernel's gate off (K1 in q1, K2 in q2, K4 in q3, K3 in q4: that kernel
   0 launches, the others as in phase 11), warm walls printed; every
   plain version is patched to raise, except K3's and K4's where their
   gate is off, as their plain versions are their library routes; (b) q1
   (ship-date cutoff) and q6 (date band, discount band, quantity bound)
   through ``prepare()`` at two bindings each over phase 11's tables, the
   plan cache cleared first: the second binding a hit adding one to
   ``planCacheHits`` and running the first binding's template, each
   binding's rows against numpy, a DataFrame rebuilt with the first
   binding's literals a hit on that template too;
   plan-or-bind host ms, ``packTime`` and first-run walls; (c) q1, q6
   and q67 (phase 14's template) fused and with
   ``stageFusion.enabled=false``: the same rows and K1-K4 launches, each
   plan's ``Fused stages`` lines and ``numFusedOps``; (d) q6 from phase
   22's parquet files at two ``l_shipdate`` bands of one template:
   ``numSkippedRowGroups`` as numpy's ship-date ranges of the files say,
   rows against numpy. Then the device memory that clearing the cached
   templates frees (none expected), and the phase's time.
24. The observability layer and the fault-injection registry (runs after
   phase 23, over phase 11's tables and oracles, under
   ``variableFloatAgg``; telemetry and the event log on for the whole
   phase through ``SRT_METRICS`` / ``SRT_EVENT_LOG``, every run against
   its numpy oracle): (a) q1, q2, q3 and q4 traced at ``operator`` level
   (plans of their own) beside an untraced run of phase 11's: rows bit
   for bit and K1-K4 launches equal, every span closed and inside the
   query's one ``collect`` span (but the scheduler's admission wait,
   which ends before it), every event under its minted id; each
   query's span-category ms; q3's ``trace_export`` written and loaded
   back; ``explain_analyze`` of q1 and q3; q1's ``metrics()`` at
   ESSENTIAL, MODERATE and ALL; (b) q1 warm with tracing off, at
   ``operator`` and at ``kernel`` (``syncs.install()``), in two turns,
   its ``timed`` calls a run, and one ``timed`` call's host cost off and
   on beside an unguarded ``record_function``; (c) q1 and q3 at
   ``kernel`` level under ``torch.cuda.set_sync_debug_mode("warn")``:
   sync spans and seconds, the top five ``sync_stats`` sites, torch's
   sync-debug warnings; (e) q1, q3 and q6 under
   ``oom@upload:1,oom@kernel:1,oom@concat:1`` and q1 under
   ``corrupt@wire:1,oom@upload:1`` with a 2 KiB device budget and no host
   tier (its exchange pieces on disk): rows bit for bit the fault-free
   device rows, ``faultsInjected`` and ``spillEscalations`` in
   ``Recovery@query`` (and one ``corruptionsDetected`` after a disk
   read), ``fault-injected`` and ``oom-rung`` instants in the trace, no
   leak; (d) ``srt_collects`` and ``srt_query_latency_ms`` count the
   phase's runs, every ``render_text`` line parses, the event log holds
   one record a run, q1's ``render_report``. The schedule is disarmed
   after the phase; its time is printed.
25. The recovery ladder, the runtime re-plan, concurrent stages and the
   partial skip (runs after phase 24, over phase 11's tables, phase 11's
   and 16's oracles, under ``variableFloatAgg``; every run against its
   oracle, none leaking): (a) q4, q13 and q21 at
   ``shuffle.partitions=8`` with ``aqe.replan.enabled`` on and off, in
   turns (on, off, off, on; q21, which demotes nothing, on, off): rows
   equal, ``replanChecks``,
   ``joinDemotions``, ``replanObservedBytes`` against the 64 MiB
   threshold, ``estimateErrorPct``, each checked join's type and
   whether its probe exchange materialized (a demoted join's never
   does: checked against ``joinDemotions``), K1 / K3 launches and the
   walls; q17 at 8 partitions with ``autoBroadcastJoinThreshold`` 1 MiB
   (``Q17_THRESHOLD``: PART's estimate, ~6.3 MB, above it, the filtered
   parts below), which must demote a join; (b) rows bit for bit the
   fault-free rows, with each run's ``Recovery@query`` and instants: q3
   at 8 partitions with auto-broadcast off under
   ``lostoutput@exchange.serve:1`` (``stageRecomputes`` 1; exactly one
   in-memory source runs twice, every sibling stage's once), q3 under
   ``transient@exchange.serve:1`` (``retriesAttempted`` 1 beside
   ``faultsInjected`` 1: the same context), q1 under
   ``corrupt@wire:2,oom@upload:1`` with phase 24's 2 KiB device budget
   and no host tier (``corruptionsDetected`` >= 1, ``stageRecomputes``
   1) and q6 under ``stall@kernel:1`` with the watchdog on at 1,000 ms
   (``watchdogKills`` 1, ``partitionRetries`` 1); (c) q3 at 8 partitions
   with auto-broadcast off, the pipeline on (the default: (b)'s
   fault-free plan) and off in turns: ``concurrentStages`` >= 2, rows
   equal bit for bit, both walls; (d) at 8 partitions, ``skipAggPassReductionRatio`` 0.85 and 1.0
   (off), in turns (0.85, 1.0, 1.0, 0.85 for ORDERS; 0.85, 1.0 for q18):
   ORDERS grouped by ``o_orderkey`` (count, sum of
   ``o_totalprice``; downloaded as numpy, held to numpy: counts exact,
   sums within ORACLE_RTOL or 4 ulp of the column's total, the rounding
   of group sums taken as differences of a running sum), whose partial
   must skip, and q18, whose ``l_orderkey`` partial must keep its
   grouping; each partial's decision, K1 launches and walls. The
   schedule and the trace are off after the phase; its time is
   printed.
26. The multi-query scheduler, QoS admission and the device semaphore
   (runs after phase 25, over phase 11's tables, phase 11's and 16's
   oracles, under ``variableFloatAgg``; every run against its oracle,
   none leaking): (a) q1, q3, q4 and q6 once each in turn, then from
   four threads at once at ``concurrentTpuTasks`` 2 and
   ``maxConcurrentQueries`` 2, then 4, with the trace on at query level:
   rows against the oracles, the most permit holders at once at most 2
   (counted by the semaphore and sampled every millisecond), one
   ``tpu-semaphore-acquire`` span (category ``queued``) a query with its
   ms, K1, K3 and K4 launched in each turn, the serial and concurrent
   walls; at 4 slots at least 3 queries admitted at once, so the permits
   and not admission bound the card; (b) q3
   through ``submit()`` under ``stall@kernel`` (its query tag only) and
   ``cancel()`` once it stalls: ``QueryCancelledError``; q6 through
   ``collect(timeout_ms=300)`` under the same stall: "deadline
   exceeded"; for both an empty leak report and, once the caller drops
   the error and its frames, ``torch.cuda.memory_allocated()`` back at
   its level before the query; (c) ``queueDepth`` 0 with the one run
   slot held: ``QueryRejectedError`` (``queue-full``) with a
   ``retry_after_ms`` hint, then ``collect_with_retry`` with the slot
   freed 0.3 s later: q6's rows, ``clientRetries`` >= 1; (d) QoS and
   preemption on, the device semaphore made anew at one permit: a
   background q18 at 8 partitions holding it, an interactive q6
   collected meanwhile: q18 yields at a partition boundary (the scenario
   again, up to three times, where timing gave no window), resumes on
   its context with ``preemptions`` and ``resumedStages`` >= 1, its rows
   equal bit for bit to its solo run and both against their oracles;
   (e) q18 at 8 partitions stalled at ``exchange.serve`` for 2 s (then
   retried on its context) with its exchange pieces in its catalog, and q6
   meanwhile under an injected OOM at ``upload`` (both schedules scoped
   by query tag): q6's ladder reaches ``evict-neighbors``, which spills
   q18's pieces (``crossQueryEvictions`` >= 1, the catalog bytes and
   what the caching allocator's count of allocated bytes fell by, which
   must be above 0), and both queries return their oracle rows. The
   semaphore is made anew at the default two permits after (d), the
   schedule disarmed after the phase; its time is printed.
27. Cost-based placement with the card's own constants and the shuffle
   transport SPI: TPC-H SF1's q1-q6 columns are written to parquet with
   pyarrow; (a) ``cost_sweep.run`` measures the three constants (the
   mean ``sync`` span and upload bytes over upload span time of q1 and
   q6 from the files, traced at kernel level; the host engine's bytes
   per second on q6), then times q6 over LINEITEM prefixes of SF 0.1,
   0.3 and 1 on the host engine and on the card in turns and prints the
   break-evens (measured; the model's at the measured constants without
   a query floor; the defaults') and the fitted query floor; it fails
   unless the defaults' break-even lies within 2x of the measured one;
   (b) q1-q6 from those files under the default conf with placement on
   and off (the scan cache off in both, the order alternating by
   query; one run each: ``cost_sweep.py --placement`` compares the
   walls): each plan's placements and estimates, both runs' launches
   and walls, rows against the phase-11 oracles; (e)'s workers start
   here; (c) q3
   and q18 at 8 partitions through ``inprocess``, ``hostfile`` and
   ``objectstore`` (the in-process stub): rows bit for bit equal,
   against the oracles, K1 / K3 / K4 launches and the transport
   counters printed, the spool and the store empty after each; (d) q3
   through ``hostfile`` with a shard file deleted after its stage
   committed: one stage recompute, rows bit for bit ``inprocess``'s;
   (e) the two ``spawn``-started worker processes, each with its own CUDA
   context (started before (c)), repartition half of LINEITEM's ``l_orderkey`` /
   ``l_quantity`` each on the card into the shared spool (one tag,
   announced over the rendezvous); this process fetches the 8 partitions
   onto the card and they equal its own in-process repartition of both
   halves row for row; the spool is empty at the end.
17. A ``{"kernels": [...]}`` line: each ported kernel's launches on the
   paths (q1 + q3 + q4 + q2 hand-built, then q1-q6 through the DataFrame
   front end, then q1-q6 under the default conf, then phase 13's
   fourteen runs, phase 14's twelve, phase 15's fourteen, phase 16's
   nineteen, phase 18's eleven, phase 19's ten, phase 20's thirteen,
   phase 21's eight (four without pandas), phase 22's sixteen, phase
   23's fifteen, phase 24's twenty-three, phase 25's thirty-one,
   phase 26's and phase 27's runs), its
   error against the plain version, its time, the
   plain version's, its bound, one PyTorch call's time for the same
   function (K1: the whole sort at 786 432 rows against ``torch.sort``;
   K2: the per-group function on q2's largest launch against the
   scatter_reduce; K3: two ``torch.searchsorted``; K4:
   ``torch.repeat_interleave``), the time of its library route, what its
   gate off runs (``library_route_ms``; K3's and K4's are their plain
   versions), and its library route's calls in phase 23 (a)
   (``library_calls``).

Every query runs under the default ``v2`` wire codec unless a phase says
otherwise. The total time of the script is printed before the last line,
which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
CAPS = (512, 786_432, 4_194_304)   # tiny, one q1 SF1 partition, batchSizeRows
PATH_CAP = 786_432
ORACLE_RTOL = 1e-9


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch
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


def turns_ms(fns: dict, iters: int, rounds: int = 5) -> dict:
    """Median over ``rounds`` of each function's :func:`cuda_ms`, the
    functions timed in turns (a, b, b, a, a, b, ...), so drift of the
    host or the card falls on all of them alike."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(cuda_ms(fns[k], iters))
    return {k: float(np.median(v)) for k, v in times.items()}


def bound_text(ms: float) -> str:
    """A bound in ms: four decimals, or three significant digits below
    0.001 ms (where four decimals would print 0.0000)."""
    return f"{ms:.4f}" if ms >= 1e-3 else f"{ms:.3g}"


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 3: kernel K1 against its plain version and torch.sort
# ---------------------------------------------------------------------------

SORT_KINDS = ("random", "dups", "zero_one", "random+perm")


def make_keys(kind: str, cap: int, seed: int):
    """int64-carried u32 keys on the card: full-range random, five values
    with the extremes, or a 0/1 word (three digits of one bucket)."""
    import torch
    rng = np.random.default_rng(seed)
    if kind.startswith("random"):
        k = rng.integers(0, 2 ** 32, cap, dtype=np.int64)
    elif kind == "dups":
        k = rng.choice(np.array([0, 1, 0x00FF00FF, 0x7FFFFFFF, 0xFFFFFFFF],
                                np.int64), cap)
    else:
        k = rng.integers(0, 2, cap, dtype=np.int64)
    return torch.from_numpy(k).cuda()


def sort_bound(cap: int, key_bytes: int, perm: bool) -> dict:
    """The function's byte bound (keys, and perm, read once; the order
    written once) and the byte bound of the kernel's passes: the
    histogram and pass 1 read the keys (and perm), passes 1-3 write and
    passes 2-4 read a u32 key and an int32 index, pass 4 writes the
    index (or gathers and writes perm[index], 8 B each)."""
    p = 8.0 if perm else 0.0
    fn = key_bytes + p + (8.0 if perm else 4.0)
    passes = (key_bytes + p) * 2 + 8.0 + 16.0 * 2 + 8.0 + \
        (16.0 if perm else 4.0)
    return dict(bound_ms=bytes_ms(fn * cap), fn_bytes_per_row=fn,
                pass_bound_ms=bytes_ms(passes * cap),
                pass_bytes_per_row=passes)


def kernel_phase(native) -> dict:
    """K1 bit for bit against its plain version and
    ``torch.sort(stable=True)`` at every capacity and key kind, then the
    kernel, plain and torch.sort times beside the bounds."""
    import torch
    results = {}
    for cap in CAPS:
        for kind in SORT_KINDS:
            keys = make_keys(kind, cap, seed=cap + len(kind))
            perm = None
            if kind.endswith("perm"):
                perm = torch.from_numpy(np.random.default_rng(cap).permutation(
                    cap).astype(np.int64)).cuda()
            native.reset_counters()
            got = native.stable_argsort_u32(keys, perm)
            torch.cuda.synchronize()
            launches = native.counters()["radix_sort"]
            plain = native.stable_argsort_u32_plain(keys, perm)
            lib = native.stable_argsort_u32_library(keys, perm)
            if launches != 1:
                raise AssertionError(f"K1 made {launches} C calls for one "
                                     f"sort at cap={cap} {kind}")
            err = max(max_abs_err(got, plain), max_abs_err(got, lib))
            if not torch.equal(got, plain) or err != 0:
                raise AssertionError(f"K1 != plain at cap={cap} {kind}")
            if not torch.equal(got, lib):
                raise AssertionError(f"K1 != torch.sort at cap={cap} {kind}")
            iters = 20 if cap < 4_000_000 else 10
            r = dict(sort_bound(cap, keys.element_size(), perm is not None),
                     max_abs_err=err, cap=cap, kind=kind)
            r["ms"] = cuda_ms(lambda: native.stable_argsort_u32(keys, perm),
                              iters)
            # One timed call at the largest cap (0.44 s a call), for the
            # script's time budget; three elsewhere.
            big = cap >= 4_000_000
            r["plain_ms"] = cuda_ms(
                lambda: native.stable_argsort_u32_plain(keys, perm),
                1 if big else 3, warmup=0 if big else 1)
            if perm is None:
                r["library_ms"] = cuda_ms(
                    lambda: torch.sort(keys, stable=True), iters)
            else:
                r["library_ms"] = cuda_ms(lambda: perm.index_select(
                    0, torch.sort(keys.index_select(0, perm),
                                  stable=True).indices), iters)
            # The library route: what native.radixSort=false runs.
            r["library_route_ms"] = cuda_ms(
                lambda: native.stable_argsort_u32_library(keys, perm), iters)
            results[(cap, kind)] = r
            lib_name = "torch.sort" if perm is None \
                else "gather + torch.sort + gather"
            log(f"K1 stable_argsort_u32 cap={cap} keys={kind}: bit-identical"
                f" to plain and torch.sort, one C call; kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, {lib_name} "
                f"{r['library_ms']:.4f} ms, library route "
                f"{r['library_route_ms']:.4f} ms, bound "
                f"{bound_text(r['bound_ms'])} ms "
                f"({r['fn_bytes_per_row']:.0f} B/row), passes' bound "
                f"{r['pass_bound_ms']:.4f} ms ({r['pass_bytes_per_row']:.0f} "
                f"B/row)")
    return results


def device_ms(fn, iters: int, attempts: int = 3):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``: the
    sum of the CUDA kernel and memset events over ``iters`` calls, or None
    when the profiler records no device time in any of ``attempts``
    profiles (a profile now and then comes back without device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and \
                    not getattr(e, "is_user_annotation", False):
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
        if total > 0:
            return total / 1e3 / iters
    return None


def sort_profile_phase(native, k1: dict) -> dict:
    """One 786,432-row sort (random keys): the CUDA-event time of the
    whole call beside the profiler's device time of its memset and five
    kernels, so host and device time stand apart."""
    keys = make_keys("random", PATH_CAP, seed=1)
    dev = device_ms(lambda: native.stable_argsort_u32(keys), 20)
    event = k1[(PATH_CAP, "random")]["ms"]
    shown = "not measured (no device events)" if dev is None \
        else f"{dev:.4f} ms"
    log(f"K1 one sort at {PATH_CAP} rows: {event:.4f} ms a call (CUDA "
        f"events, back to back), device time {shown} (torch.profiler: "
        f"memset, histogram and four onesweep passes)")
    return dict(event_ms=event, device_ms=dev)


# ---------------------------------------------------------------------------
# Phase 4: TPC-H Q1 at SF1 against a numpy oracle
# ---------------------------------------------------------------------------

def q1_oracle(cols: dict, cutoff: int) -> list:
    """TPC-H Q1 over the LINEITEM columns in plain numpy: rows sorted by
    (returnflag, linestatus)."""
    keep = cols["l_shipdate"] <= cutoff
    rf = cols["l_returnflag"][keep].astype(np.int64)
    ls = cols["l_linestatus"][keep].astype(np.int64)
    qty = cols["l_quantity"][keep]
    price = cols["l_extendedprice"][keep]
    disc = cols["l_discount"][keep]
    tax = cols["l_tax"][keep]
    disc_price = price * (1.0 - disc)
    charge = price * (1.0 - disc) * (1.0 + tax)
    key = rf * 256 + ls
    uniq, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)

    def s(v):
        return np.bincount(inv, weights=v)

    rows = []
    for g, k in enumerate(uniq):
        rows.append((chr(k // 256), chr(k % 256), s(qty)[g], s(price)[g],
                     s(disc_price)[g], s(charge)[g], s(qty)[g] / cnt[g],
                     s(price)[g] / cnt[g], s(disc)[g] / cnt[g],
                     int(cnt[g])))
    return rows


def check_q1(rows: list, want: list) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"q1: {len(rows)} groups, oracle {len(want)}")
    for got, exp in zip(rows, want):
        if got[:2] != exp[:2] or got[9] != exp[9]:
            raise AssertionError(f"q1 keys/count differ: {got} vs {exp}")
        vals = np.array(got[2:9], np.float64)
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"q1 non-finite values: {got}")
        if not np.allclose(vals, np.array(exp[2:9], np.float64),
                           rtol=ORACLE_RTOL, atol=0.0):
            raise AssertionError(f"q1 values differ: {got} vs {exp}")


def path_phase(entry, native) -> dict:
    import torch
    t0 = time.perf_counter()
    cols = entry.tpch_q1_columns(1.0, seed=0)
    parts = entry.tpch_q1_host_batches(1.0, partitions=8, seed=0)
    n_rows = sum(p[0].num_rows for p in parts)
    want = q1_oracle(cols, entry.Q1_SHIPDATE_CUTOFF)
    log(f"q1 SF1: {n_rows} LINEITEM rows in {len(parts)} partitions "
        f"(generated + oracle in {time.perf_counter() - t0:.2f} s)")
    from spark_rapids_tpu_torch.columnar import wire
    plan = entry.tpch_q1_plan(parts, device="cuda")
    native.reset_counters()
    wire.reset_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.counters()
    codec = codec_summary("q1", wire.counters())
    check_q1(rows, want)
    if launches["radix_sort"] <= 0:
        raise AssertionError(f"q1 did not launch K1: {launches}")
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check_q1(rows, want)
    for r in rows:
        log(f"  {r}")
    log(f"q1 SF1 matches the numpy oracle (keys and counts exact, values "
        f"rtol {ORACLE_RTOL}); first run {first_s:.3f} s, warm run "
        f"{warm_s:.3f} s, {n_rows / warm_s:.0f} input rows/s (warm); "
        f"K1 launches {launches}")
    return dict(launches=launches, first_s=first_s, warm_s=warm_s,
                rows=n_rows, codec=codec, plan=plan, parts=parts)


# ---------------------------------------------------------------------------
# Phase 5: kernel K3 (the join probe) against its plain version
# ---------------------------------------------------------------------------

# (build, probe): a tiny launch (32 lanes a probe), a 3 * 2^20 build rung
# probed at 16, 8 and 1 lanes (probe_lanes on 132 SMs; 1 just past the
# k-ary cut and further on), and 4M x 4M at 1 lane.
PROBE_SHAPES = ((512, 512), (3_145_728, 6_000), (3_145_728, 12_000),
                (3_145_728, 20_000), (3_145_728, 150_000),
                (4_194_304, 4_194_304))
U64_MAX = 0xFFFFFFFFFFFFFFFF
INT64_MIN = -(1 << 63)
# H100 SXM float32 rate outside the tensor cores, taken as its 32-bit
# integer ALU rate.
ALU_OPS_PER_S = 67e12


def probe_inputs(cap_b: int, cap_p: int, seed: int):
    """Sorted full-range u64 build fingerprints with runs of 1-7 and a
    sentinel tail (about 40% of the build); probes half hits, half
    random, with 0, 2^64-1 and 2^63 among them. int64 bit patterns on
    the card."""
    import torch
    rng = np.random.default_rng(seed)
    n_live = int(cap_b * 0.6)
    distinct = rng.integers(0, U64_MAX, max(n_live, 1), dtype=np.uint64,
                            endpoint=True)
    live = np.repeat(distinct, rng.integers(1, 8, len(distinct)))[:n_live]
    build = np.concatenate([np.sort(live), np.full(cap_b - len(live),
                                                   U64_MAX, np.uint64)])
    probe = np.where(rng.random(cap_p) < 0.5, rng.choice(build, cap_p),
                     rng.integers(0, U64_MAX, cap_p, dtype=np.uint64,
                                  endpoint=True))
    probe[:3] = [0, U64_MAX, 1 << 63]
    return (torch.from_numpy(build.view(np.int64)).cuda(),
            torch.from_numpy(probe.view(np.int64)).cuda())


def probe_bound(cap_b: int, cap_p: int) -> tuple:
    """(bound_ms, bound_by). Bytes: probe fingerprints in and lo/hi out
    (16 B a row), plus the distinct 32-byte build sectors the searches
    read. The lo and hi searches read the same sectors until their last
    step, and the top floor(log2 cap_p) levels of the search tree, about
    cap_p sectors in all, are shared by every probe; each deeper level
    reads at most one sector a probe, and no search reads more than the
    whole build (cap_b / 4 sectors). Operations: 2 ceil(log2 cap_b)
    search steps a row at 4 32-bit ALU operations each."""
    steps = max((cap_b - 1).bit_length(), 1)        # ceil(log2 cap_b)
    shared = max(cap_p.bit_length() - 1, 0)         # floor(log2 cap_p)
    sectors = min(cap_b / 4.0, cap_p * max(steps - shared + 1, 1))
    nbytes = 16.0 * cap_p + 32.0 * sectors
    ops_ms = 2.0 * steps * 4.0 * cap_p / ALU_OPS_PER_S * 1e3
    b_ms = bytes_ms(nbytes)
    return (b_ms, "bytes") if b_ms >= ops_ms else (ops_ms, "operations")


def cold_ms(fn, iters: int, flush_bytes: int = 64 << 20) -> float:
    """Mean device milliseconds of one call with a cold L2: a write of
    ``flush_bytes`` (more than the H100's 50 MB L2) before each call, and
    CUDA events around each call alone."""
    import torch
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def probe_design(native, cap_b: int, cap_p: int, device) -> str:
    """The lane count K3 takes for this launch, and its dependent steps:
    k-ary steps at G >= 2 lanes, halvings of the binary walk at 1."""
    lanes = native.probe_lanes(cap_p, native.sm_count(device))
    if lanes == 1:
        return (f"1 lane a probe, binary walk of "
                f"{max(cap_b - 1, 0).bit_length()} halvings")
    steps, t = 0, cap_b + 1
    while t > 1:
        t = (t + lanes) // (lanes + 1)
        steps += 1
    return f"{lanes} lanes a probe, {steps} k-ary steps"


def probe_check(native, build, probe, label: str, profiled: bool = False,
                cold: bool = False, timed: bool = True) -> dict:
    """K3 against its plain version (bit for bit); with ``timed``, then
    kernel and two-``torch.searchsorted`` times on the same inputs, in
    turns, and the plain version's (which is also K3's library route,
    what ``native.joinProbe=false`` runs); with ``profiled``, the kernel's
    device time; with ``cold``, also its time with a cold L2."""
    import torch
    cap_b, cap_p = build.numel(), probe.numel()
    lo, hi = native.searchsorted_u64_pair(build, probe)
    torch.cuda.synchronize()
    plo, phi = native.searchsorted_u64_pair_plain(build, probe)
    err = max((lo.to(torch.int64) - plo.to(torch.int64)).abs().max().item(),
              (hi.to(torch.int64) - phi.to(torch.int64)).abs().max().item())
    if err != 0 or not (torch.equal(lo, plo) and torch.equal(hi, phi)):
        raise AssertionError(f"K3 != plain at {label} ({cap_b} x {cap_p})")
    if not timed:
        return dict(max_abs_err=float(err), cap_b=cap_b, cap_p=cap_p)
    iters = 20 if cap_p >= 1_000_000 else 50
    bf, qf = build ^ INT64_MIN, probe ^ INT64_MIN

    def kernel():
        native.searchsorted_u64_pair(build, probe)

    def library():
        torch.searchsorted(bf, qf, side="left")
        torch.searchsorted(bf, qf, side="right")
    t = turns_ms({"ms": kernel, "library_ms": library}, iters)
    r = dict(t, plain_ms=cuda_ms(lambda: native.searchsorted_u64_pair_plain(
        build, probe), iters), max_abs_err=float(err), cap_b=cap_b,
        cap_p=cap_p, design=probe_design(native, cap_b, cap_p, probe.device))
    r["library_route_ms"] = r["plain_ms"]
    r["bound_ms"], r["bound_by"] = probe_bound(cap_b, cap_p)
    note = ""
    if profiled:
        dev = device_ms(kernel, 20)
        r["device_ms"] = dev
        note = "; device time " + (
            "not measured (no device events)" if dev is None
            else f"{dev:.4f} ms (torch.profiler)")
    if cold:
        r["cold_ms"] = cold_ms(kernel, 20)
        r["cold_library_ms"] = cold_ms(library, 20)
        note += (f"; cold L2 (64 MiB written before each call): kernel "
                 f"{r['cold_ms']:.4f} ms, two torch.searchsorted "
                 f"{r['cold_library_ms']:.4f} ms")
    log(f"K3 searchsorted_u64_pair {label} build={cap_b} probe={cap_p} "
        f"({r['design']}): bit-identical to plain; kernel {r['ms']:.4f} ms, "
        f"two torch.searchsorted {r['library_ms']:.4f} ms (medians of 5 "
        f"turns), plain {r['plain_ms']:.4f} ms, bound "
        f"{bound_text(r['bound_ms'])} ms ({r['bound_by']}){note}")
    return r


def probe_edges(native) -> int:
    """K3 bit for bit against its plain version, untimed, at the edges of
    its design: an empty build, builds of 1 and 3 entries, all-sentinel
    builds, and a run of equal keys longer than a pivot spacing, each
    probed at every lane count ``probe_lanes`` gives on 132 SMs: 32
    (2,048 probes), 16 (8,192), 8 (12,000) and 1 (300,000)."""
    import torch
    sentinel = U64_MAX - (1 << 64)        # 2^64 - 1 as an int64 pattern
    cases = 0
    for cap_p in (2_048, 8_192, 12_000, 300_000):
        _b, probe = probe_inputs(1_000, cap_p, seed=cap_p)
        run_b, run_p = probe_inputs(3_145_728, cap_p, seed=cap_p + 1)
        run_b = run_b.clone()
        run_b[1_000_000:1_400_000] = run_b[1_000_000]   # a 400,000-key run
        run_p[:100] = run_b[1_000_000]
        builds = [torch.empty(0, dtype=torch.int64, device="cuda"),
                  probe[:1].sort().values, probe[:3].sort().values,
                  torch.full((1,), sentinel, dtype=torch.int64,
                             device="cuda"),
                  torch.full((6_291_456,), sentinel, dtype=torch.int64,
                             device="cuda"),
                  run_b]
        for build in builds:
            bu = build ^ INT64_MIN
            build = (bu.sort().values ^ INT64_MIN).contiguous()
            p = run_p if build.numel() == run_b.numel() else probe
            lo, hi = native.searchsorted_u64_pair(build, p)
            plo, phi = native.searchsorted_u64_pair_plain(build, p)
            torch.cuda.synchronize()
            if not (torch.equal(lo, plo) and torch.equal(hi, phi)):
                raise AssertionError(f"K3 != plain at build={build.numel()} "
                                     f"probe={p.numel()} (edge case)")
            cases += 1
    log(f"K3 edge cases: {cases} launches bit-identical to plain (empty, "
        f"1- and 3-entry, all-sentinel builds, a 400,000-key run; 32, 16, 8 "
        f"and 1 lanes)")
    return cases


def probe_phase(native) -> dict:
    probe_edges(native)
    return {shape: probe_check(native, *probe_inputs(*shape, seed=shape[0]),
                               label="synthetic",
                               profiled=shape == PROBE_SHAPES[-1])
            for shape in PROBE_SHAPES}


# ---------------------------------------------------------------------------
# Phase 6: TPC-H Q3 and Q4 at SF1 against numpy oracles
# ---------------------------------------------------------------------------

def _semi_hit(sorted_keys, keys):
    """keys found in sorted_keys (a searchsorted membership test)."""
    if not len(sorted_keys):
        return np.zeros(len(keys), bool)
    pos = np.clip(np.searchsorted(sorted_keys, keys), 0, len(sorted_keys) - 1)
    return sorted_keys[pos] == keys


def q3_oracle(cols: dict, E) -> list:
    """TPC-H Q3 in plain numpy: (l_orderkey, o_orderdate,
    o_shippriority, revenue), top 10 by revenue desc, o_orderdate asc."""
    c, o, li = cols["customer"], cols["orders"], cols["lineitem"]
    seg = E.SEGMENTS.index(E.Q3_SEGMENT)
    cust = np.unique(c["c_custkey"][c["c_mktsegment"] == seg])
    om = o["o_orderdate"] < E.Q3_DATE
    om[om] = _semi_hit(cust, o["o_custkey"][om])
    okey = o["o_orderkey"][om]
    odate = o["o_orderdate"][om]
    oprio = o["o_shippriority"][om]
    order = np.argsort(okey, kind="stable")
    okey_s = okey[order]
    lm = li["l_shipdate"] > E.Q3_DATE
    lkey = li["l_orderkey"][lm]
    rev = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    hit = _semi_hit(okey_s, lkey)
    at = order[np.searchsorted(okey_s, lkey[hit])]
    keys, inv = np.unique(lkey[hit], return_inverse=True)
    revenue = np.bincount(inv, weights=rev[hit])
    gdate = np.zeros(len(keys), np.int64)
    gprio = np.zeros(len(keys), np.int64)
    gdate[inv] = odate[at]
    gprio[inv] = oprio[at]
    top = np.lexsort((gdate, -revenue))[:E.Q3_LIMIT]
    return [(int(keys[i]), int(gdate[i]), int(gprio[i]), float(revenue[i]))
            for i in top]


def check_q3(rows: list, want: list) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"q3: {len(rows)} rows, oracle {len(want)}")
    for got, exp in zip(rows, want):
        if tuple(got[:3]) != exp[:3]:
            raise AssertionError(f"q3 keys/order differ: {got} vs {exp}")
        if not np.isfinite(got[3]) or not np.isclose(
                got[3], exp[3], rtol=ORACLE_RTOL, atol=0.0):
            raise AssertionError(f"q3 revenue differs: {got} vs {exp}")


def q4_oracle(cols: dict, E) -> list:
    """TPC-H Q4 in plain numpy: (o_orderpriority, order_count) by
    priority."""
    o, li = cols["orders"], cols["lineitem"]
    late = np.unique(li["l_orderkey"][li["l_commitdate"]
                                      < li["l_receiptdate"]])
    om = (o["o_orderdate"] >= E.Q4_DATE_LO) & (o["o_orderdate"]
                                               < E.Q4_DATE_HI)
    prio = o["o_orderpriority"][om][_semi_hit(late, o["o_orderkey"][om])]
    counts = np.bincount(prio, minlength=len(E.PRIORITIES))
    return [(E.PRIORITIES[i], int(n)) for i, n in enumerate(counts) if n]


def check_q4(rows: list, want: list) -> None:
    if [tuple(r) for r in rows] != want:
        raise AssertionError(f"q4 differs: {rows} vs oracle {want}")


def _strings(m: np.ndarray) -> list:
    """Rows of a zero-padded (n, w) uint8 matrix as str."""
    return [bytes(r).rstrip(b"\0").decode() for r in m]


def q2_oracle(cols: dict, E) -> list:
    """TPC-H Q2 in plain numpy: for BRASS parts of size 15, the EUROPE
    suppliers at the part's minimum EUROPE supply cost, as (s_acctbal,
    s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment),
    top 100 by s_acctbal desc, n_name, s_name, p_partkey."""
    p, ps, s, n = (cols["part"], cols["partsupp"], cols["supplier"],
                   cols["nation"])
    europe = E.REGIONS.index(E.Q2_REGION_NAME)
    supp_ok = (n["n_regionkey"] == europe)[s["s_nationkey"]]
    ps_ok = supp_ok[ps["ps_suppkey"] - 1]
    pk, cost = ps["ps_partkey"], ps["ps_supplycost"]
    minc = np.full(len(p["p_partkey"]) + 1, np.inf)
    np.minimum.at(minc, pk[ps_ok], cost[ps_ok])
    ptype = p["p_type"]
    plen = (ptype != 0).sum(axis=1)
    suffix = np.frombuffer(E.Q2_TYPE_SUFFIX.encode(), np.uint8)
    at = plen[:, None] - len(suffix) + np.arange(len(suffix))[None, :]
    ends = (plen >= len(suffix)) & np.all(
        np.take_along_axis(ptype, np.clip(at, 0, ptype.shape[1] - 1), 1)
        == suffix, axis=1)
    part_ok = (p["p_size"] == E.Q2_SIZE) & ends
    hit = np.flatnonzero(ps_ok & part_ok[pk - 1] & (cost == minc[pk]))
    si = ps["ps_suppkey"][hit] - 1
    pi = pk[hit] - 1
    nations = [nm for nm, _ in E.NATIONS]
    comments = E.S_COMMENTS
    names, phones = _strings(s["s_name"][si]), _strings(s["s_phone"][si])
    mfgrs = _strings(p["p_mfgr"][pi])
    rows = [(float(s["s_acctbal"][a]), names[i],
             nations[int(s["s_nationkey"][a])], int(p["p_partkey"][b]),
             mfgrs[i], comments[int(s["s_address"][a])], phones[i],
             comments[int(s["s_comment"][a])])
            for i, (a, b) in enumerate(zip(si, pi))]
    rows.sort(key=lambda r: (-r[0], r[2], r[1], r[3]))
    return rows[:E.Q2_LIMIT]


def check_q2(rows: list, want: list) -> None:
    if not want:
        raise AssertionError("q2 oracle is empty: nothing would be checked")
    if [tuple(r) for r in rows] != want:
        raise AssertionError(f"q2 differs: {len(rows)} rows, oracle "
                             f"{len(want)}; first rows {rows[:3]} vs "
                             f"{want[:3]}")


def run_path(name: str, plan, native, check, want, show: int = 10) -> dict:
    """First and warm runs of one plan on the card, each checked; the
    launch counters are read around the first run alone. Prints the first
    ``show`` rows."""
    import torch
    from spark_rapids_tpu_torch.columnar import wire
    native.reset_counters()
    wire.reset_counters()
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.counters()
    codec = codec_summary(name, wire.counters())
    check(rows, want)
    t0 = time.perf_counter()
    rows = plan.collect()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(rows, want)
    for r in rows[:show]:
        log(f"  {r}")
    log(f"{name} SF1 matches the numpy oracle ({len(rows)} rows); first run "
        f"{first_s:.3f} s, warm run {warm_s:.3f} s; launches {launches}")
    return dict(launches=launches, first_s=first_s, warm_s=warm_s,
                codec=codec)


def codec_summary(name: str, counters: dict) -> dict:
    """The wire codec's per-kind column counts and encoded vs raw bytes
    of one run, printed."""
    cols = {k.split(".", 1)[1]: int(v) for k, v in sorted(counters.items())
            if k.startswith("codecCols.")}
    raw, enc = counters.get("rawBytes", 0), counters.get("encodedBytes", 0)
    log(f"{name} wire codec: columns {cols}; encoded {int(enc)} B vs raw "
        f"{int(raw)} B (ratio {raw / max(enc, 1):.3f}); staging "
        f"{int(counters.get('stagingBytes', 0))} B in "
        f"{int(counters.get('uploadTransfers', 0))} transfers")
    return dict(cols=cols, raw_bytes=raw, encoded_bytes=enc)


# The launch functions of K3, K2 and K4 (each wrapper's one launch site),
# the counter each adds to, and the shape of one launch's arguments.
LAUNCHES = {
    "join_probe": ("join_probe", lambda b, p, _lo, _hi: (
        b.numel(), p.numel())),
    "seg_reduce": ("seg_reduce", lambda g, k, kind, cap, _i: (
        g.numel(), str(k.dtype).replace("torch.", ""), kind, cap)),
    "rle_expand": ("rle_decode", lambda v, _e, n, out: (
        v.numel(), str(v.dtype).replace("torch.", ""), n, out.numel())),
}


@contextlib.contextmanager
def recording(native, seen: dict):
    """While the block runs, keep the arguments of every K3, K2 and K4
    launch in ``seen`` (launch function -> list of argument tuples); the
    launches themselves, and their counts, are unchanged."""
    saved = {fn: getattr(native, fn) for fn in LAUNCHES}

    def keeper(fn, launch):
        def recorder(*args):
            seen.setdefault(fn, []).append(args)
            return launch(*args)
        return recorder
    for fn, launch in saved.items():
        setattr(native, fn, keeper(fn, launch))
    try:
        yield seen
    finally:
        for fn, launch in saved.items():
            setattr(native, fn, launch)


def first_run(seen: dict, launches: dict) -> dict:
    """The recorded launches of a path's first run (``launches``: its
    counters), which come before its warm runs'."""
    return {fn: seen.get(fn, [])[:launches[counter]]
            for fn, (counter, _shape) in LAUNCHES.items()}


def launch_shapes(fn: str, calls: list) -> list:
    return sorted({LAUNCHES[fn][1](*args) for args in calls})


def join_paths_phase(entry, native, cols: dict) -> dict:
    t0 = time.perf_counter()
    want3 = q3_oracle(cols, entry)
    want4 = q4_oracle(cols, entry)
    q3 = entry.tpch_q3_plan(entry.tpch_q3_tables(cols), device="cuda")
    q4 = entry.tpch_q4_plan(entry.tpch_q4_tables(cols), device="cuda")
    log(f"q3/q4 SF1: {len(cols['lineitem']['l_orderkey'])} LINEITEM, "
        f"{len(cols['orders']['o_orderkey'])} ORDERS, "
        f"{len(cols['customer']['c_custkey'])} CUSTOMER rows (generated + "
        f"oracles in {time.perf_counter() - t0:.2f} s)")
    # Keep the inputs of every K4 launch of q3 (its o_shippriority ships
    # as a run table) and every K3 launch of q4: each kernel is then
    # checked and timed on the main path's own inputs.
    seen3, seen4 = {}, {}
    with recording(native, seen3):
        out = {"q3": run_path("q3", q3, native, check_q3, want3)}
    log(f"q3 K3 launches: {out['q3']['launches']['join_probe']} (its joins "
        f"take the dense table)")
    first = first_run(seen3, out["q3"]["launches"])["rle_expand"]
    if not first:
        raise AssertionError("q3 did not launch K4 (rle_decode) under the "
                             "default wire codec")
    log(f"q3 K4 launches {len(first)} (8 expected: one per ORDERS "
        f"partition) over (run_cap, value type, num_rows, cap) "
        f"{launch_shapes('rle_expand', first)}")
    vals, ends, nrows, out_t = first[0]
    out["q3_rle"] = rle_check(native, vals, ends, out_t.numel(), nrows,
                              "q3 first launch", timed=True, profiled=True)
    with recording(native, seen4):
        out["q4"] = run_path("q4", q4, native, check_q4, want4)
    probes = first_run(seen4, out["q4"]["launches"])["join_probe"]
    if not probes:
        raise AssertionError("q4 did not launch K3 (join_probe)")
    log(f"q4 K3 launches {len(probes)} over (build x probe) shapes "
        f"{launch_shapes('join_probe', probes)}")
    out["q4_probe"] = probe_check(native, *probes[0][:2],
                                  label="q4 first probe", profiled=True,
                                  cold=True)
    out["seen"] = [first_run(seen3, out["q3"]["launches"]),
                   first_run(seen4, out["q4"]["launches"])]
    out["plans"] = {"q3": q3, "q4": q4}
    return out


# ---------------------------------------------------------------------------
# Phase 7: kernel K2 (the sorted-segment reduce) against its plain version
# ---------------------------------------------------------------------------

SEG_KINDS = (("sum", 32), ("sum", 64), ("min", 32), ("max", 32),
             ("min", 64), ("max", 64))
SEG_NEUTRAL = {"sum": 0, "min": -1, "max": 0}
SEG_REPEATS = 20       # launches compared at the largest size


def seg_inputs(cap: int, bits: int, seed: int):
    """Nondecreasing int64 group ids, three quarters of the rows in
    segments of 1-64 rows and the last quarter in segments of 20,000 to
    60,000 rows (many 2,048-row tiles each), and full-range u32 or u64
    keys with 0 and the maximum salted in, as int32 / int64 bit patterns
    on the card."""
    import torch
    rng = np.random.default_rng(seed)
    head = cap - cap // 4
    lens = rng.integers(1, 65, head // 16 + 1)
    gid = np.repeat(np.arange(len(lens)), lens)[:head]
    tail = cap - len(gid)
    long_lens = rng.integers(20_000, 60_001, tail // 20_000 + 1)
    gid = np.concatenate([gid, len(lens) + np.repeat(
        np.arange(len(long_lens)), long_lens)[:tail]]).astype(np.int64)
    hi = (1 << bits) - 1
    k = rng.integers(0, hi, cap, dtype=np.uint64, endpoint=True)
    k[rng.random(cap) < 0.05] = hi
    k[rng.random(cap) < 0.05] = 0
    keys = k.astype(np.uint32).view(np.int32) if bits == 32 \
        else k.view(np.int64)
    return (torch.from_numpy(gid).cuda(),
            torch.from_numpy(np.ascontiguousarray(keys)).cuda())


def seg_bound(n: int, key_bytes: int, capacity: int) -> tuple:
    """(bound_ms, bound_by): each row's gid (8 B) and key read once and
    each of the ``capacity`` per-group slots written once, at 3.35 TB/s;
    one add or compare a row at the 32-bit ALU rate is far below it."""
    b_ms = bytes_ms(n * (8.0 + key_bytes) + capacity * key_bytes)
    ops_ms = n / ALU_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= ops_ms else (ops_ms, "operations")


def seg_check(native, gid, keys, kind: str, capacity: int, identity: int,
              label: str, repeats: int = 1, timed: bool = True,
              profiled: bool = False) -> dict:
    """K2 (the per-group function, one C call) against its plain version
    (running scan + finish) bit for bit over ``repeats`` launches, and
    again with the whole column one segment and with a capacity below the
    largest id; against one ``scatter_reduce_`` into an identity-filled
    output bit for bit where every id fits; with ``timed``, the times of
    K2, the plain version and the scatter_reduce beside the bound; with
    ``profiled``, also K2's device time."""
    import torch
    n = keys.numel()
    sign = -(1 << 31) if keys.dtype == torch.int32 else INT64_MIN
    plain = native.seg_reduce_plain(gid, keys, kind, capacity, identity)
    native.reset_counters()
    for i in range(repeats):
        got = native.seg_reduce(gid, keys, kind, capacity, identity)
        torch.cuda.synchronize()
        wrong = int((got != plain).sum())
        err = max_abs_err(got, plain, unsigned=True)
        if wrong or err != 0:
            raise AssertionError(f"K2 != plain at {label} {kind} n={n} "
                                 f"capacity={capacity}, launch {i}: {wrong} "
                                 f"slots differ, max abs err {err}")
    if native.counters()["seg_reduce"] != repeats:
        raise AssertionError(f"K2 made {native.counters()['seg_reduce']} C "
                             f"calls for {repeats} reductions")
    top = int(gid[-1])
    zero = torch.zeros_like(gid)
    for g, cap_ in ((zero, capacity), (gid, max(top // 2, 1))):
        if not torch.equal(native.seg_reduce(g, keys, kind, cap_, identity),
                           native.seg_reduce_plain(g, keys, kind, cap_,
                                                   identity)):
            raise AssertionError(f"K2 != plain at {label} {kind} (one "
                                 f"segment, or capacity {cap_} < max id)")
    lib_in = keys if kind == "sum" else keys ^ sign
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    fill = identity if kind == "sum" else identity ^ sign

    def library():
        return torch.full((capacity,), fill, dtype=keys.dtype,
                          device=keys.device).scatter_reduce_(
                              0, gid, lib_in, reduce)

    def route():
        # The library route: what native.segmentReduce=false runs.
        return native.segment_reduce_library(gid, keys, kind, capacity,
                                             identity)

    r = dict(max_abs_err=err, n=n, capacity=capacity, kind=kind,
             key_bits=8 * keys.element_size(), library_ms=None)
    if top < capacity:
        lib = library() if kind == "sum" else library() ^ sign
        if not torch.equal(got, lib):
            raise AssertionError(f"K2 != scatter_reduce at {label} {kind}")
    if not torch.equal(got, route()):
        raise AssertionError(f"K2 != its library route at {label} {kind}")
    if not timed:
        return r
    iters = 20 if n >= 1_000_000 else 50
    r["ms"] = cuda_ms(lambda: native.seg_reduce(gid, keys, kind, capacity,
                                                identity), iters)
    r["plain_ms"] = cuda_ms(lambda: native.seg_reduce_plain(
        gid, keys, kind, capacity, identity), 3, warmup=1)
    if top < capacity:
        r["library_ms"] = cuda_ms(library, iters)
    r["library_route_ms"] = cuda_ms(route, iters)
    r["bound_ms"], r["bound_by"] = seg_bound(n, keys.element_size(),
                                             capacity)
    lib_ms = "n/a (ids past capacity)" if r["library_ms"] is None \
        else f"{r['library_ms']:.4f} ms"
    note = ""
    if profiled:
        r["device_ms"] = device_ms(lambda: native.seg_reduce(
            gid, keys, kind, capacity, identity), 20)
        note = "; device time " + (
            "not measured (no device events)" if r["device_ms"] is None
            else f"{r['device_ms']:.4f} ms (torch.profiler)")
    log(f"K2 seg_reduce {label} {kind}{r['key_bits']} n={n} "
        f"capacity={capacity}: bit-identical to plain over {repeats} "
        f"launch(es); kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"scatter_reduce {lib_ms}, library route "
        f"{r['library_route_ms']:.4f} ms, bound {bound_text(r['bound_ms'])} "
        f"ms ({r['bound_by']}){note}")
    return r


def seg_phase(native) -> dict:
    out = {}
    for cap in CAPS:
        for kind, bits in SEG_KINDS:
            gid, keys = seg_inputs(cap, bits, seed=cap + bits)
            repeats = SEG_REPEATS if cap == CAPS[-1] else 2
            out[(cap, kind, bits)] = seg_check(
                native, gid, keys, kind, cap, SEG_NEUTRAL[kind], "synthetic",
                repeats=repeats)
    return out


# ---------------------------------------------------------------------------
# Phase 8: TPC-H Q2 at SF1 against a numpy oracle
# ---------------------------------------------------------------------------

def q2_phase(entry, native, cols: dict) -> dict:
    t0 = time.perf_counter()
    want = q2_oracle(cols, entry)
    plan = entry.tpch_q2_plan(entry.tpch_q2_tables(cols), device="cuda")
    log(f"q2 SF1: {len(cols['partsupp']['ps_partkey'])} PARTSUPP, "
        f"{len(cols['part']['p_partkey'])} PART, "
        f"{len(cols['supplier']['s_suppkey'])} SUPPLIER rows (oracle and "
        f"scans in {time.perf_counter() - t0:.2f} s)")
    # Keep the inputs of every K2 and K3 launch: each kernel is then
    # checked and timed on the main path's own launches (K2's largest,
    # K3's first).
    seen = {}
    with recording(native, seen):
        r = run_path("q2", plan, native, check_q2, want, show=5)
    c = r["launches"]
    r["seen"] = first_run(seen, c)
    first, probes = r["seen"]["seg_reduce"], r["seen"]["join_probe"]
    if not first:
        raise AssertionError("q2 did not launch K2 (seg_reduce)")
    if not probes:
        raise AssertionError("q2 did not launch K3 (join_probe)")
    log(f"q2 K2 launches {c['seg_reduce']} over (rows, key type, kind, "
        f"capacity) {launch_shapes('seg_reduce', first)}; K3 launches "
        f"{c['join_probe']} (the fast path, about 4 expected) over (build x "
        f"probe) {launch_shapes('join_probe', probes)}; K1 sorts "
        f"{c['radix_sort']}")
    gid, keys, kind, capacity, identity = max(
        first, key=lambda s: (s[1].numel(), s[1].element_size()))
    r["k2"] = seg_check(native, gid, keys, kind, capacity, identity,
                        "q2 largest launch", repeats=SEG_REPEATS,
                        profiled=True)
    r["k3"] = probe_check(native, *probes[0][:2], label="q2 first probe",
                          profiled=True)
    r["plan"] = plan
    return r


# ---------------------------------------------------------------------------
# Phase 11: TPC-H q1-q6 through the DataFrame front end
# ---------------------------------------------------------------------------

def q5_oracle(cols: dict, E) -> list:
    """TPC-H Q5 in plain numpy: (n_name, revenue) of the ASIA customers'
    1994 orders whose line's supplier shares the customer's nation, by
    revenue desc. Keys are positions: o_orderkey, c_custkey and
    s_suppkey count from 1, n_nationkey from 0."""
    n, c, o, li, s = (cols["nation"], cols["customer"], cols["orders"],
                      cols["lineitem"], cols["supplier"])
    asia = (n["n_regionkey"] == E.REGIONS.index(E.Q5_REGION_NAME))
    cust_nat = c["c_nationkey"]
    om = (o["o_orderdate"] >= E.Q5_DATE_LO) & (o["o_orderdate"]
                                               < E.Q5_DATE_HI)
    om &= asia[cust_nat[o["o_custkey"] - 1]]
    order_nat = np.full(len(o["o_orderkey"]) + 1, -1, np.int64)
    order_nat[o["o_orderkey"][om]] = cust_nat[o["o_custkey"][om] - 1]
    line_nat = order_nat[li["l_orderkey"]]
    hit = (line_nat >= 0) & (s["s_nationkey"][li["l_suppkey"] - 1]
                             == line_nat)
    rev = li["l_extendedprice"][hit] * (1.0 - li["l_discount"][hit])
    sums = np.bincount(line_nat[hit], weights=rev, minlength=25)
    present = np.bincount(line_nat[hit], minlength=25) > 0
    rows = [(E.NATIONS[k][0], float(sums[k])) for k in range(25)
            if present[k]]
    rows.sort(key=lambda r: -r[1])
    return rows


def check_q5(rows: list, want: list) -> None:
    if not want:
        raise AssertionError("q5 oracle is empty: nothing would be checked")
    if [r[0] for r in rows] != [w[0] for w in want]:
        raise AssertionError(f"q5 nations/order differ: {rows} vs {want}")
    for got, exp in zip(rows, want):
        if not np.isfinite(got[1]) or not np.isclose(
                got[1], exp[1], rtol=ORACLE_RTOL, atol=0.0):
            raise AssertionError(f"q5 revenue differs: {got} vs {exp}")


def q6_oracle(cols: dict, E) -> list:
    """TPC-H Q6 in plain numpy: one row, the 1994 revenue of lines with a
    discount of 0.05-0.07 and a quantity below 24 (NULL when none)."""
    li = cols["lineitem"]
    m = ((li["l_shipdate"] >= E.Q6_DATE_LO)
         & (li["l_shipdate"] < E.Q6_DATE_HI)
         & (li["l_discount"] >= E.Q6_DISCOUNT_LO)
         & (li["l_discount"] <= E.Q6_DISCOUNT_HI)
         & (li["l_quantity"] < E.Q6_QUANTITY_BELOW))
    if not m.any():
        return [(None,)]
    return [(float(np.sum(li["l_extendedprice"][m] * li["l_discount"][m])),)]


def check_q6(rows: list, want: list) -> None:
    if len(rows) != 1 or len(rows[0]) != 1:
        raise AssertionError(f"q6: expected one value, got {rows}")
    got, exp = rows[0][0], want[0][0]
    if exp is None or got is None:
        if got != exp:
            raise AssertionError(f"q6 differs: {rows} vs {want}")
    elif not np.isfinite(got) or not np.isclose(got, exp, rtol=ORACLE_RTOL,
                                                atol=0.0):
        raise AssertionError(f"q6 revenue differs: {rows} vs {want}")


def rows_close(a: list, b: list) -> bool:
    """Same rows in the same order: floats within ORACLE_RTOL, every other
    value exact."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not np.isclose(x, y, rtol=ORACLE_RTOL, atol=0.0):
                    return False
            elif x != y:
                return False
    return True


# Each query's numpy oracle and check; the kernels each must launch on the
# DataFrame path.
DF_QUERIES = ("q1", "q6", "q3", "q5", "q2", "q4")
DF_MUST_LAUNCH = {"q1": ("radix_sort",), "q6": (), "q3": (
    "radix_sort", "rle_decode"), "q5": ("radix_sort",), "q2": (
    "radix_sort", "seg_reduce", "join_probe"), "q4": (
    "radix_sort", "join_probe")}
DF_WARM_RUNS = 1      # 2 until phase 23 needed the time


# Expected rows, computed once a run: phases 11-25 hold their runs to the
# same oracles over the same generated columns. Keyed by the query and the
# columns' identity; the columns stay referenced, so an id is never reused.
_ORACLE_MEMO: dict = {}


# The checked rows of each query's first run at one partition under
# ``variableFloatAgg`` (phases 11, 14 and 15), against which phases 16 and
# 18 hold the query's runs at 8 partitions instead of running it again.
ONE_PARTITION_ROWS: dict = {}


def memo_oracle(q: str, cols: dict, compute):
    key = (q, id(cols))
    if key not in _ORACLE_MEMO:
        _ORACLE_MEMO[key] = (cols, compute())
    return _ORACLE_MEMO[key][1]


def df_oracles(cols: dict, E, queries=DF_QUERIES) -> dict:
    """(check, expected rows) of each of ``queries`` among q1-q6."""
    oracles = {
        "q1": (check_q1, lambda: q1_oracle(cols["lineitem"],
                                           E.Q1_SHIPDATE_CUTOFF)),
        "q6": (check_q6, lambda: q6_oracle(cols, E)),
        "q3": (check_q3, lambda: q3_oracle(cols, E)),
        "q5": (check_q5, lambda: q5_oracle(cols, E)),
        "q2": (check_q2, lambda: q2_oracle(cols, E)),
        "q4": (check_q4, lambda: q4_oracle(cols, E))}
    return {q: (check, memo_oracle(q, cols, oracle))
            for q, (check, oracle) in oracles.items() if q in queries}


def dataframe_phase(native, cols: dict, hand: dict, hand_seen: list) -> dict:
    """q1-q6 through ``TpuSession`` and the port's ``benchmarks/tpch.py``
    (the reference's query text) on the card: each query planned (host
    ms), run once (launch counters around that run alone, K2-K4's inputs
    recorded) and ``DF_WARM_RUNS`` times warm, every run checked against
    its numpy oracle; q1-q4's rows against the hand-built trees'
    (``hand``: query -> (plan, launches of its first run)) in this
    process. Then every K2, K3 and K4 launch whose shape no hand-built
    path gave (``hand_seen``: their recorded first runs) is held to the
    kernel's plain version: see :func:`df_kernel_checks`."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import wire
    t0 = time.perf_counter()
    session = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True})
    tables = tpch.tpch_tables(session, cols)
    oracles = df_oracles(cols, E)
    log(f"DataFrame phase: tables and oracles in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for q in DF_QUERIES:
        check, want = oracles[q]
        t0 = time.perf_counter()
        df = tpch.QUERIES[q](session, tables[q])
        phys = df._physical()
        plan_ms = (time.perf_counter() - t0) * 1e3
        log(f"{q} DataFrame plan ({plan_ms:.2f} ms host, query text to "
            f"exec tree):")
        for line in phys.tree().splitlines():
            log(f"  {line}")
        notes = [line.strip() for line in phys.explain().splitlines()
                 if "join strategy" in line]
        for line in notes:
            log(f"  note: {line}")
        native.reset_counters()
        wire.reset_counters()
        seen = {}
        with recording(native, seen):
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        launches = native.counters()
        check(rows, want)
        ONE_PARTITION_ROWS[q] = rows
        missing = [k for k in DF_MUST_LAUNCH[q] if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{q} on the DataFrame path launched no "
                                 f"{missing}: {launches}")
        warm = []
        for _ in range(DF_WARM_RUNS):
            t0 = time.perf_counter()
            rows = df.collect()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            check(rows, want)
        note = ""
        if q in hand:
            plan, hand_launches = hand[q]
            hand_rows = plan.collect()
            check(hand_rows, want)
            if not rows_close(rows, hand_rows):
                raise AssertionError(f"{q}: DataFrame rows differ from the "
                                     f"hand-built tree's: {rows[:3]} vs "
                                     f"{hand_rows[:3]}")
            same = "identical" if rows == hand_rows else \
                "equal within the oracle's tolerance"
            note = (f"; rows {same} to the hand-built tree's, whose first "
                    f"run launched {hand_launches}")
        log(f"{q} DataFrame path matches the numpy oracle ({len(rows)} "
            f"rows): plan {plan_ms:.2f} ms, first run {first_s:.3f} s, warm "
            f"{[round(w, 4) for w in warm]} s; launches {launches}{note}")
        out[q] = dict(plan_ms=plan_ms, first_s=first_s, warm_s=warm,
                      launches=launches, seen=first_run(seen, launches),
                      notes=notes, tree=phys.tree(), frame=df)
    out["flush_launches"] = flush_launches(out["q1"]["frame"],
                                           *oracles["q1"])
    out["oracles"] = oracles
    out["tables"] = tables
    out["kernel_checks"] = df_kernel_checks(
        native, {q: out[q]["seen"] for q in DF_QUERIES}, hand_seen)
    return out


def device_launches(fn) -> int:
    """CUDA kernels (and memsets) the device ran during one ``fn()``, from
    ``torch.profiler``'s device events; 0 when the profile holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def flush_launches(df, check, want) -> dict:
    """q1's device launches in one warm run with the arithmetic's
    subnormal flush (denormals-are-zero operands, flush-to-zero results
    of float +, -, *: the reference engine's rule) and with it patched
    out, as before the repair; both runs checked against the oracle."""
    import torch
    from spark_rapids_tpu_torch.exprs import arithmetic as A
    got = {}
    t0 = time.perf_counter()
    for label in ("with the flush", "without (before the repair)"):
        if label.startswith("without"):
            saved = A._daz, A._ftz
            A._daz, A._ftz = (lambda a, b: (a, b)), (lambda x: x)
        try:
            rows = []
            got[label] = device_launches(lambda: rows.append(df.collect()))
            torch.cuda.synchronize()
            check(rows[0], want)
        finally:
            if label.startswith("without"):
                A._daz, A._ftz = saved
    log(f"q1 device launches in one warm run (torch.profiler device "
        f"events): {got}; both profiled runs {time.perf_counter() - t0:.1f} "
        f"s")
    return got


def df_kernel_checks(native, df_seen: dict, hand_seen: list) -> list:
    """Each K2, K3 and K4 launch of the DataFrame path (``df_seen``: query
    -> recorded first run) whose shape no hand-built path launched
    (``hand_seen``) held to the kernel's plain version bit for bit; the
    largest such launch of a query and kernel also timed against its
    plain version and library call, with its device time. Shapes the
    hand-built paths gave were checked there."""
    known = {fn: set() for fn in LAUNCHES}
    for seen in hand_seen:
        for fn, calls in seen.items():
            known[fn].update(launch_shapes(fn, calls))
    out = []
    for q, seen in df_seen.items():
        for fn, calls in seen.items():
            if not calls:
                continue
            new = {}
            for args in calls:
                shape = LAUNCHES[fn][1](*args)
                if shape not in known[fn]:
                    new.setdefault(shape, args)
            log(f"{q} DataFrame {fn}: {len(calls)} launches, shapes "
                f"{launch_shapes(fn, calls)}; not launched by a hand-built "
                f"path: {sorted(new) or 'none'}")
            largest = max(new, default=None, key=lambda sh: [
                x for x in sh if isinstance(x, int)])
            for shape, args in sorted(new.items()):
                timed = shape == largest
                label = f"DataFrame {q} {'largest new' if timed else 'new'}"
                if fn == "join_probe":
                    r = probe_check(native, *args[:2], label=label,
                                    profiled=timed, timed=timed)
                elif fn == "seg_reduce":
                    r = seg_check(native, *args, label, timed=timed,
                                  profiled=timed)
                else:
                    vals, ends, nrows, out_t = args
                    r = rle_check(native, vals, ends, out_t.numel(), nrows,
                                  label, timed=timed, profiled=timed)
                out.append(dict(r, query=q, kernel=fn, shape=shape))
    return out


# ---------------------------------------------------------------------------
# Phase 12: TPC-H q1-q6 under the default conf (mixed device/host plans)
# ---------------------------------------------------------------------------

# The logical nodes the default conf places on the host (its float Sum/Avg
# aggregates), and the kernels each query must launch in this phase.
DEFAULT_HOST_NODES = {"q1": ["LogicalAggregate"], "q6": ["LogicalAggregate"],
                      "q3": ["LogicalAggregate"], "q5": ["LogicalAggregate"],
                      "q2": [], "q4": []}
DEFAULT_MUST_LAUNCH = {"q1": ("radix_sort",), "q6": (), "q3": (
    "radix_sort", "rle_decode"), "q5": ("radix_sort",), "q2": (
    "radix_sort", "seg_reduce", "join_probe"), "q4": (
    "radix_sort", "join_probe")}
DEFAULT_TURNS = 1     # 3 until phase 23, 2 until phase 24 needed the time
# Phase 3's K1 shapes: (rows, key dtype, with a permutation).
K1_CHECKED = {(cap, "int64", perm) for cap in CAPS for perm in (False, True)}


@contextlib.contextmanager
def recording_k1(native, seen: list):
    """While the block runs, keep the (keys, perm) of every K1 launch in
    ``seen``; the launches and their counts are unchanged."""
    launch = native.radix_sort

    def recorder(keys, perm, out):
        seen.append((keys, perm))
        return launch(keys, perm, out)
    native.radix_sort = recorder
    try:
        yield seen
    finally:
        native.radix_sort = launch


def k1_shape(keys, perm) -> tuple:
    return (keys.numel(), str(keys.dtype).replace("torch.", ""),
            perm is not None)


def k1_checks(native, q: str, calls: list, known=K1_CHECKED) -> list:
    """Each K1 launch of a shape not in ``known`` (default: phase 3's),
    again through the wrapper, bit for bit against the plain version."""
    import torch
    out = []
    for shape in sorted({k1_shape(*a) for a in calls} - set(known)):
        keys, perm = next(a for a in calls if k1_shape(*a) == shape)
        got = native.stable_argsort_u32(keys, perm)
        plain = native.stable_argsort_u32_plain(keys, perm)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        if not torch.equal(got, plain):
            raise AssertionError(f"{q}: K1 != plain at {shape}")
        out.append(dict(query=q, kernel="radix_sort", shape=shape,
                        max_abs_err=err))
    if out:
        log(f"{q} K1: {len(calls)} launches; new shapes "
            f"(rows, key type, perm) {[r['shape'] for r in out]} "
            f"bit-identical to the plain version")
    return out


def _bridges(e, parent=None, out=None) -> list:
    """(transition exec, its parent, its child) of every bridge."""
    out = [] if out is None else out
    name = type(e).__name__
    if name in ("DeviceToHostExec", "HostToDeviceExec"):
        out.append((e, parent, type(e.children[0]).__name__))
    for c in e.children:
        _bridges(c, name, out)
    return out


def host_engine_ms(ctx, wall_ms: float, root_on_device: bool) -> float:
    """The host engine's share of one run: the host clock inside the
    host subtrees (each HostToDeviceExec's pulls, or the whole wall when
    the root is on the host) less the device subtrees and downloads
    below them (each DeviceToHostExec's)."""
    h2d = d2h = 0.0
    for m in ctx.metrics.values():
        if m.owner == "HostToDeviceExec":
            h2d += m.values.get("hostTime", 0) / 1e6
        elif m.owner == "DeviceToHostExec":
            d2h += (m.values.get("deviceTime", 0)
                    + m.values.get("downloadTime", 0)) / 1e6
    return max((h2d if root_on_device else wall_ms) - d2h, 0.0)


def run_checked(native, label: str, phys, check, want, expect_hosted: list,
                must_launch, known_seen: list, known_k1=K1_CHECKED,
                collect=None) -> dict:
    """One query's checked first run on the card: the plan's host nodes
    against ``expect_hosted`` and its bridges (printed), the launch
    counters around the run alone with every K1-K4 launch recorded, the
    rows against the oracle, the kernels of ``must_launch`` launched, the
    rows and bytes each ``DeviceToHostExec`` downloads (printed), and
    every launch of a shape not in ``known_seen`` / ``known_k1`` held to
    its plain version bit for bit. ``collect(phys, ctx)`` runs the query
    (default ``phys.collect``). Returns the rows, ``first_s``,
    ``launches``, ``moved``, ``hosted``, ``seen`` (the recorded run),
    ``checks`` (the kernel checks made) and ``ctx``."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    hosted = phys.host_fallback_nodes()
    if hosted != expect_hosted:
        raise AssertionError(f"{label} placed {hosted} on the host, "
                             f"expected {expect_hosted}")
    bridges = _bridges(phys.root)
    if bool(hosted) != bool(bridges):
        raise AssertionError(f"{label}: host nodes {hosted} but bridges "
                             f"{bridges}")
    log(f"{label}: host nodes {hosted}; root on the "
        f"{'device' if phys.root_on_device else 'host'}; bridges "
        + (", ".join(f"{type(b).__name__} under {p} over {c}"
                     for b, p, c in bridges) or "none"))
    native.reset_counters()
    seen, seen_k1 = {}, []
    ctx = ExecContext(phys.conf)
    with recording(native, seen), recording_k1(native, seen_k1):
        t0 = time.perf_counter()
        rows = (collect or type(phys).collect)(phys, ctx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = native.counters()
    check(rows, want)
    missing = [k for k in must_launch if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}: {launches}")
    moved = [(ctx.metrics_for(b).values.get("downloadRows", 0),
              ctx.metrics_for(b).values.get("downloadBytes", 0))
             for b, _p, _c in bridges
             if type(b).__name__ == "DeviceToHostExec"]
    for r, nb in moved:
        log(f"  {label} DeviceToHostExec downloaded {int(r)} rows, "
            f"{int(nb)} B")
    first = first_run(seen, launches)
    checks = df_kernel_checks(native, {label: first}, known_seen) \
        + k1_checks(native, label, seen_k1, known_k1)
    return dict(rows=rows, first_s=first_s, launches=launches, moved=moved,
                hosted=hosted, seen=first, checks=checks, ctx=ctx)


def default_conf_phase(native, cols: dict, known_seen: list,
                       df_out: dict) -> dict:
    """q1-q6 through ``TpuSession()`` with no conf: float Sum/Avg
    aggregates run on the host engine between device subtrees. Each
    query's placement (host-tagged nodes, bridges, rows and bytes each
    download moves) is printed and checked; its first run is checked
    against the numpy oracle, with the launch counters around it alone
    and every K1-K4 launch recorded; new launch shapes are held to the
    plain versions. Then warm walls in turns beside the same query with
    ``variableFloatAgg`` on (the all-device tree), with the host
    engine's share of each default-conf wall."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t0 = time.perf_counter()
    # Phase 11's tables (the same host batches) and oracles.
    session = TpuSession()
    tables = {q: _rebound(session, df_out["tables"][q]) for q in DF_QUERIES}
    vsession = TpuSession({"spark.rapids.sql.variableFloatAgg.enabled": True})
    vtables = {q: _rebound(vsession, df_out["tables"][q])
               for q in DF_QUERIES}
    oracles = df_out["oracles"]
    log(f"default-conf phase: phase 11's tables and oracles rebound in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {"kernel_checks": []}
    for q in DF_QUERIES:
        check, want = oracles[q]
        phys = tpch.QUERIES[q](session, tables[q])._physical()
        vphys = tpch.QUERIES[q](vsession, vtables[q])._physical()
        r = run_checked(native, f"{q} default conf", phys, check, want,
                        DEFAULT_HOST_NODES[q], DEFAULT_MUST_LAUNCH[q],
                        known_seen)
        first_s, launches = r["first_s"], r["launches"]
        out["kernel_checks"] += r["checks"]
        check(vphys.collect(), want)             # warms the all-device tree
        walls = {"default": [], "vfa": []}
        host = []
        for turn in range(DEFAULT_TURNS):
            for which in (("default", "vfa") if turn % 2 == 0
                          else ("vfa", "default")):
                p = phys if which == "default" else vphys
                c = ExecContext(p.conf)
                t0 = time.perf_counter()
                rows = p.collect(c)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                check(rows, want)
                walls[which].append(wall)
                if which == "default":
                    host.append(host_engine_ms(c, wall, p.root_on_device))
        med = {k: float(np.median(v)) for k, v in walls.items()}
        shown = {k: [round(w, 2) for w in v] for k, v in walls.items()}
        share = float(np.median([h / w for h, w in zip(
            host, walls["default"])]))
        log(f"{q} default conf matches the numpy oracle ({len(rows)} rows):"
            f" first run {first_s:.3f} s, warm {med['default']:.2f} ms "
            f"(median of {DEFAULT_TURNS}; {shown['default']}), host engine "
            f"{share * 100:.1f}% of it; all-device warm {med['vfa']:.2f} ms "
            f"({shown['vfa']}); "
            f"launches {launches}")
        out[q] = dict(first_s=first_s, warm_ms=med["default"],
                      vfa_warm_ms=med["vfa"], host_share=share,
                      launches=launches, moved=r["moved"],
                      hosted=r["hosted"], seen=r["seen"])
    return out


# ---------------------------------------------------------------------------
# Phase 13: TPCxBB q5 and TPC-H q7, q8, q9, q12, q14 and q19 (conditionals,
# IN lists, Divide and date parts) under both confs
# ---------------------------------------------------------------------------

def _years(days: np.ndarray) -> np.ndarray:
    """Calendar year of each day count (numpy's datetime64, not the
    port's arithmetic)."""
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def _matrix_rows(m: np.ndarray, value: str) -> np.ndarray:
    """Rows of a zero-padded (n, w) uint8 string matrix equal to
    ``value``."""
    b = np.frombuffer(value.encode(), np.uint8)
    if len(b) > m.shape[1]:
        return np.zeros(len(m), bool)
    rest = m[:, len(b):]
    return np.all(m[:, :len(b)] == b, axis=1) & ~np.any(rest != 0, axis=1)


def _matrix_contains(m: np.ndarray, value: str) -> np.ndarray:
    b = np.frombuffer(value.encode(), np.uint8)
    hit = np.zeros(len(m), bool)
    for j in range(m.shape[1] - len(b) + 1):
        hit |= np.all(m[:, j:j + len(b)] == b, axis=1)
    return hit


def _packed_radixes(a: np.ndarray):
    """Each column's radix (its max + 1) when the 2-D integer array ``a``
    is non-empty and non-negative and the radixes' product fits an int64
    key, else None."""
    if a.dtype.kind not in "iu" or a.size == 0 or a.min() < 0:
        return None
    radixes = [int(c.max()) + 1 for c in a.T]
    total = 1
    for r in radixes:
        total *= r
    return radixes if total < 2 ** 63 else None


def _pack_rows(a: np.ndarray, radixes: list) -> np.ndarray:
    key = np.zeros(len(a), np.int64)
    for j, radix in enumerate(radixes):
        key = key * radix + a[:, j].astype(np.int64)
    return key


def _unique_rows(a: np.ndarray) -> tuple:
    """``np.unique(a, axis=0, return_inverse=True)`` of a 2-D integer
    array (rows in lexicographic order), through one packed int64 key a
    row where the columns allow it: the same rows and inverse, faster."""
    radixes = _packed_radixes(a)
    if radixes is None:
        uniq, inv = np.unique(a, axis=0, return_inverse=True)
        return uniq, inv.reshape(-1)
    ukey, inv = np.unique(_pack_rows(a, radixes), return_inverse=True)
    uniq = np.stack(_decode_key(ukey, radixes), axis=1).astype(a.dtype)
    return uniq.reshape(len(ukey), a.shape[1]), inv.reshape(-1)


def _group_sums(keys: list, *values) -> tuple:
    """(unique key rows, the sum of each value per key row): ``keys`` is a
    list of int arrays grouped together."""
    uniq, inv = _unique_rows(np.stack(keys, axis=1))
    return uniq, [np.bincount(inv, weights=v, minlength=len(uniq))
                  for v in values]


def q7_oracle(cols: dict, E) -> list:
    """TPC-H Q7 in plain numpy: (supp_nation, cust_nation, l_year,
    revenue) of 1995-1996 lines shipped between FRANCE and GERMANY."""
    li, o, c, s = (cols["lineitem"], cols["orders"], cols["customer"],
                   cols["supplier"])
    names = [n for n, _ in E.NATIONS]
    fr, de = names.index("FRANCE"), names.index("GERMANY")
    m = (li["l_shipdate"] >= E.days("1995-01-01")) & (
        li["l_shipdate"] <= E.days("1996-12-31"))
    sn = s["s_nationkey"][li["l_suppkey"][m] - 1]
    cn = c["c_nationkey"][o["o_custkey"][li["l_orderkey"][m] - 1] - 1]
    keep = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
    vol = (li["l_extendedprice"][m] * (1.0 - li["l_discount"][m]))[keep]
    yr = _years(li["l_shipdate"][m][keep])
    uniq, (rev,) = _group_sums([sn[keep], cn[keep], yr], vol)
    rows = [(names[a], names[b], int(y), float(r))
            for (a, b, y), r in zip(uniq, rev)]
    rows.sort(key=lambda r: r[:3])
    return rows


def q8_oracle(cols: dict, E) -> list:
    """TPC-H Q8 in plain numpy: (o_year, BRAZIL's share of the AMERICA
    customers' 1995-1996 volume of ECONOMY ANODIZED STEEL parts)."""
    li, o, c, s, p, n = (cols["lineitem"], cols["orders"],
                         cols["customer"], cols["supplier"], cols["part"],
                         cols["nation"])
    america = E.REGIONS.index("AMERICA")
    brazil = [nm for nm, _ in E.NATIONS].index("BRAZIL")
    part_ok = _matrix_rows(p["p_type"], "ECONOMY ANODIZED STEEL")
    cust_ok = n["n_regionkey"][c["c_nationkey"]] == america
    od = o["o_orderdate"]
    order_ok = (od >= E.days("1995-01-01")) & (od <= E.days("1996-12-31")) \
        & cust_ok[o["o_custkey"] - 1]
    oi = li["l_orderkey"] - 1
    m = part_ok[li["l_partkey"] - 1] & order_ok[oi]
    vol = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    is_br = s["s_nationkey"][li["l_suppkey"][m] - 1] == brazil
    uniq, (br, tot) = _group_sums([_years(od[oi[m]])],
                                  np.where(is_br, vol, 0.0), vol)
    return [(int(y), float(b / t)) for (y,), b, t in zip(uniq, br, tot)]


def q9_oracle(cols: dict, E) -> list:
    """TPC-H Q9 in plain numpy: (nation, o_year, sum_profit) of the lines
    of '%green%' parts, by nation asc and year desc."""
    li, o, s, p, ps = (cols["lineitem"], cols["orders"], cols["supplier"],
                       cols["part"], cols["partsupp"])
    names = [nm for nm, _ in E.NATIONS]
    m = _matrix_contains(p["p_name"], "green")[li["l_partkey"] - 1]
    pk, sk = li["l_partkey"][m], li["l_suppkey"][m]
    # Each line's supplier is one of its part's four partsupp rows.
    cand = (pk - 1)[:, None] * 4 + np.arange(4)[None, :]
    which = np.argmax(ps["ps_suppkey"][cand] == sk[:, None], axis=1)
    row = cand[np.arange(len(pk)), which]
    if not np.all(ps["ps_suppkey"][row] == sk):
        raise AssertionError("q9 oracle: a line's supplier is not one of "
                             "its part's")
    amount = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m]) \
        - ps["ps_supplycost"][row] * li["l_quantity"][m]
    nat = s["s_nationkey"][sk - 1]
    yr = _years(o["o_orderdate"][li["l_orderkey"][m] - 1])
    uniq, (prof,) = _group_sums([nat, yr], amount)
    rows = [(names[a], int(y), float(v)) for (a, y), v in zip(uniq, prof)]
    rows.sort(key=lambda r: (r[0], -r[1]))
    return rows


def q12_oracle(cols: dict, E) -> list:
    """TPC-H Q12 in plain numpy: (l_shipmode, high_line_count,
    low_line_count) of the MAIL and SHIP lines received in 1994 late."""
    li, o = cols["lineitem"], cols["orders"]
    modes = [E.SHIPMODES.index(x) for x in ("MAIL", "SHIP")]
    r = li["l_receiptdate"]
    m = np.isin(li["l_shipmode"], modes) \
        & (li["l_commitdate"] < r) & (li["l_shipdate"] < li["l_commitdate"]) \
        & (r >= E.days("1994-01-01")) & (r < E.days("1995-01-01"))
    prio = o["o_orderpriority"][li["l_orderkey"][m] - 1]
    high = np.isin(prio, [E.PRIORITIES.index("1-URGENT"),
                          E.PRIORITIES.index("2-HIGH")])
    mode = li["l_shipmode"][m]
    rows = [(E.SHIPMODES[k], int(np.sum(high[mode == k])),
             int(np.sum(~high[mode == k]))) for k in np.unique(mode)]
    rows.sort()
    return rows


def q14_oracle(cols: dict, E) -> list:
    """TPC-H Q14 in plain numpy: one row, 100 x the PROMO parts' share of
    September 1995's revenue (NULL when no line shipped)."""
    li, p = cols["lineitem"], cols["part"]
    m = (li["l_shipdate"] >= E.days("1995-09-01")) & (
        li["l_shipdate"] < E.days("1995-10-01"))
    if not m.any():
        return [(None,)]
    rev = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    promo = _matrix_rows(p["p_type"][:, :5], "PROMO")[li["l_partkey"][m]
                                                      - 1]
    return [(float(np.sum(np.where(promo, rev, 0.0)) * 100.0
                   / np.sum(rev)),)]


Q19_BRANCHES = (("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                 1.0, 11.0, 5),
                ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                 10.0, 20.0, 10),
                ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"),
                 20.0, 30.0, 15))


def q19_oracle(cols: dict, E) -> list:
    """TPC-H Q19 in plain numpy: one row, the revenue of AIR / REG AIR
    lines delivered in person whose part meets one of three brand,
    container, quantity and size branches (NULL when none does)."""
    li, p = cols["lineitem"], cols["part"]
    m = np.isin(li["l_shipmode"], [E.SHIPMODES.index("AIR"),
                                   E.SHIPMODES.index("REG AIR")]) \
        & (li["l_shipinstruct"] == E.SHIPINSTRUCT.index("DELIVER IN PERSON"))
    pi = li["l_partkey"][m] - 1
    qty = li["l_quantity"][m]
    hit = np.zeros(len(pi), bool)
    for brand, conts, lo, hi, size in Q19_BRANCHES:
        cont = np.zeros(len(p["p_partkey"]), bool)
        for x in conts:
            cont |= _matrix_rows(p["p_container"], x)
        part_ok = _matrix_rows(p["p_brand"], brand) & cont & (
            p["p_size"] >= 1) & (p["p_size"] <= size)
        hit |= part_ok[pi] & (qty >= lo) & (qty <= hi)
    if not hit.any():
        return [(None,)]
    rev = li["l_extendedprice"][m][hit] * (1.0 - li["l_discount"][m][hit])
    return [(float(np.sum(rev)),)]


def xbb_q5_oracle(cols: dict, S) -> list:
    """TPCxBB q5 in plain numpy: per user with a click, (wcs_user_sk,
    clicks in Books, college education, male, clicks in category ids
    1-7); a multiset (the query has no order)."""
    w, it, c, cd = (cols["web_clickstreams"], cols["item"], cols["customer"],
                    cols["customer_demographics"])
    user = w["wcs_user_sk"]
    ok = ~np.ma.getmaskarray(user)
    u = np.ma.getdata(user)[ok]
    item = w["wcs_item_sk"][ok] - 1
    users, inv = np.unique(u, return_inverse=True)
    n = len(users)
    books = np.bincount(inv, weights=(it["i_category"][item]
                                      == S.CATEGORIES.index("Books")),
                        minlength=n)
    ids = [np.bincount(inv, weights=(it["i_category_id"][item] == i),
                       minlength=n) for i in range(1, 8)]
    demo = c["c_current_cdemo_sk"][users - 1] - 1
    college = np.isin(cd["cd_education_status"][demo],
                      [S.EDU.index(x) for x in (
                          "Advanced Degree", "College", "4 yr Degree",
                          "2 yr Degree")])
    male = cd["cd_gender"][demo] == S.GENDERS.index("M")
    cols_out = [users, books, college, male] + ids
    return [tuple(int(v[i]) for v in cols_out) for i in range(n)]


def check_rows(name: str, rows: list, want: list,
               multiset: bool = False, exact: bool = False) -> None:
    """Rows against an oracle: same count, keys, counts and order exact
    (``multiset``: the same rows in any order), floats within
    ORACLE_RTOL (``exact``: equal) and finite; a NULL only where the
    oracle has one."""
    if not want:
        raise AssertionError(f"{name} oracle is empty: nothing would be "
                             "checked")
    rows = [tuple(r) for r in rows]
    if multiset:
        rows, want = sorted(rows), sorted(want)
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, oracle "
                             f"{len(want)}; first {rows[:3]} vs {want[:3]}")
    for got, exp in zip(rows, want):
        if len(got) != len(exp):
            raise AssertionError(f"{name} row width differs: {got} vs {exp}")
        for a, b in zip(got, exp):
            if isinstance(b, float):
                if not isinstance(a, float) or not np.isfinite(a) or \
                        not (a == b if exact else np.isclose(
                            a, b, rtol=ORACLE_RTOL, atol=0.0)):
                    raise AssertionError(f"{name} differs: {got} vs {exp}")
            elif a != b or type(a) is not type(b):
                raise AssertionError(f"{name} differs: {got} vs {exp}")


MORE_TPCH = ("q7", "q8", "q9", "q12", "q14", "q19")
MORE_QUERIES = ("xbb_q5",) + MORE_TPCH
# The logical nodes the default conf places on the host (the float Sum
# aggregates), and the kernels each query must launch under both confs.
MORE_DEFAULT_HOST = {"xbb_q5": [], "q7": ["LogicalAggregate"],
                       "q8": ["LogicalAggregate"],
                       "q9": ["LogicalAggregate"], "q12": [],
                       "q14": ["LogicalAggregate"],
                       "q19": ["LogicalAggregate"]}
MORE_MUST_LAUNCH = {q: ("radix_sort",) for q in (
    "xbb_q5", "q7", "q8", "q9", "q12")}
MORE_WARM_RUNS = 0    # 1 until phase 24 needed the time


def more_oracles(cols: dict, xcols: dict, E, S) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-13 query."""
    def check(name, multiset=False):
        return lambda rows, want: check_rows(name, rows, want, multiset)
    out = {"xbb_q5": (check("xbb_q5", multiset=True),
                      xbb_q5_oracle(xcols, S))}
    for q, oracle in (("q7", q7_oracle), ("q8", q8_oracle),
                      ("q9", q9_oracle), ("q12", q12_oracle),
                      ("q14", q14_oracle), ("q19", q19_oracle)):
        out[q] = (check(q), oracle(cols, E))
    return out


def more_queries_phase(native, cols: dict, known_seen: list,
                       known_k1: set) -> dict:
    """TPCxBB q5 (scale 1) and TPC-H q7, q8, q9, q12, q14 and q19 (SF1)
    through ``TpuSession()`` on the card, once with ``variableFloatAgg``
    on and once under the default conf. For each run: the plan's host
    nodes and bridges (checked against the reference's placement), the
    rows and bytes each ``DeviceToHostExec`` downloads, the first run
    (launch counters around it alone, every K1-K4 launch recorded) and
    ``MORE_WARM_RUNS`` warm runs, each checked against its numpy
    oracle. Every K1-K4 launch of a shape no earlier phase checked
    (``known_seen``: recorded K2-K4 first runs; ``known_k1``: K1 shapes)
    is held to the kernel's plain version bit for bit."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t_phase = time.perf_counter()
    xcols = suite_columns_sf1(S)
    oracles = more_oracles(cols, xcols, E, S)
    log(f"phase 13: TPCxBB scale 1 "
        f"({len(xcols['web_clickstreams']['wcs_item_sk'])} clickstream "
        f"rows) and oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    out = {"kernel_checks": []}
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = dict(tpch.tpch_tables(session, cols, MORE_TPCH),
                      **S.suite_tables(session, xcols, ("xbb_q5",)))
        for q in MORE_QUERIES:
            check, want = oracles[q]
            run = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            t0 = time.perf_counter()
            phys = run(session, tables[q])._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            label = f"{q} ({conf_name})"
            r = run_checked(native, label, phys, check, want,
                            MORE_DEFAULT_HOST[q] if conf_name == "default"
                            else [], MORE_MUST_LAUNCH.get(q, ()),
                            known_seen, known_k1)
            known_seen.append(r["seen"])
            known_k1 |= {c["shape"] for c in r["checks"]
                         if c["kernel"] == "radix_sort"}
            out["kernel_checks"] += r["checks"]
            warm = []
            for _ in range(MORE_WARM_RUNS):
                t0 = time.perf_counter()
                rows = phys.collect(ExecContext(phys.conf))
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(rows, want)
            log(f"{label} matches the numpy oracle ({len(r['rows'])} "
                f"rows): plan {plan_ms:.2f} ms, first run "
                f"{r['first_s']:.3f} s, warm {[round(w, 4) for w in warm]} "
                f"s; launches "
                f"{r['launches']}")
            out[(q, conf_name)] = dict(
                plan_ms=plan_ms, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], moved=r["moved"],
                hosted=r["hosted"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89 and ds_q98 (grouping
# sets and windows) under both confs
# ---------------------------------------------------------------------------

def _ds_joined(cols: dict, date_ok: np.ndarray, item_ok=None) -> tuple:
    """The store_sales rows whose date passes ``date_ok`` (and item
    ``item_ok``), as (date index, item index, row mask)."""
    ss = cols["store_sales"]
    d = ss["ss_sold_date_sk"] - 1
    i = ss["ss_item_sk"] - 1
    m = date_ok[d]
    if item_ok is not None:
        m &= item_ok[i]
    return d[m], i[m], m


def _mixed_key(parts: list, n: int) -> np.ndarray:
    """One int64 key for each of ``n`` rows from (small non-negative int
    column, its radix) pairs: 0 for every row when there are none."""
    key = np.zeros(n, np.int64)
    for v, radix in parts:
        key = key * radix + v
    return key


def _decode_key(key: np.ndarray, radixes: list) -> list:
    out = []
    for radix in reversed(radixes):
        out.append(key % radix)
        key = key // radix
    return out[::-1]


def q67_oracle(cols: dict, S) -> list:
    """TPC-DS q67 in plain numpy: the ROLLUP of sum(price * qty) over the
    eight keys (nine levels), rank() of sumsales descending within
    i_category (the grand total alone in the NULL partition), rk <= 100,
    the eight keys ascending nulls first, then sumsales and rk, first
    100 rows. Sums of whole numbers: exact."""
    dd, it, st = cols["date_dim"], cols["item"], cols["store"]
    ss = cols["store_sales"]
    ms = dd["d_month_seq"]
    d, i, m = _ds_joined(cols, (ms >= 1178) & (ms <= 1189))
    sales = ss["ss_sales_price"][m] * ss["ss_quantity"][m]
    store = ss["ss_store_sk"][m] - 1
    keys = [(it["i_category"][i], len(S.CATEGORIES)),
            (it["i_class"][i], len(S.CLASSES)),
            (it["i_brand"][i], len(S.BRANDS)),
            (it["i_product_name"][i], len(S.PRODUCTS)),
            (dd["d_year"][d] - 1998, 3), (dd["d_qoy"][d] - 1, 4),
            (dd["d_moy"][d] - 1, 12), (st["s_store_id"][store],
                                       len(st["s_store_id"]))]
    radixes = [r for _, r in keys]
    levels = []           # (level, decoded key columns, sums)
    for lvl in range(len(keys), -1, -1):
        key = _mixed_key(keys[:lvl], len(sales))
        uniq, inv = np.unique(key, return_inverse=True)
        sums = np.bincount(inv.reshape(-1), weights=sales,
                           minlength=len(uniq))
        levels.append((lvl, _decode_key(uniq, radixes[:lvl]), sums))
    n = sum(len(s) for _, _, s in levels)
    # Per output row: each key's value, or -1 for a rolled-up NULL.
    kv = np.full((len(keys), n), -1, np.int64)
    sumsales = np.empty(n)
    at = 0
    for lvl, dec, sums in levels:
        for k in range(lvl):
            kv[k, at:at + len(sums)] = dec[k]
        sumsales[at:at + len(sums)] = sums
        at += len(sums)
    # rank() over (partition by i_category order by sumsales desc).
    cat = kv[0]
    order = np.lexsort((-sumsales, cat))
    sc, sv = cat[order], sumsales[order]
    idx = np.arange(n)
    new_part = np.r_[True, sc[1:] != sc[:-1]]
    new_peer = new_part | np.r_[True, sv[1:] != sv[:-1]]
    rank_sorted = np.maximum.accumulate(np.where(new_peer, idx, 0)) - \
        np.maximum.accumulate(np.where(new_part, idx, 0)) + 1
    rk = np.empty(n, np.int64)
    rk[order] = rank_sorted
    keep = np.flatnonzero(rk <= 100)
    # ORDER BY the keys ascending, nulls first (a category by its name;
    # the other pools are in name order), then sumsales and rk.
    cat_rank = np.argsort(np.argsort(np.array(S.CATEGORIES)))
    sort_cols = [np.where(kv[0] < 0, -1, cat_rank[np.maximum(kv[0], 0)])] \
        + [kv[k] for k in range(1, len(keys))]
    sel = keep[np.lexsort(tuple([rk[keep], sumsales[keep]]
                                + [c[keep] for c in sort_cols[::-1]]))][:100]
    pools = (S.CATEGORIES, S.CLASSES, S.BRANDS, S.PRODUCTS)
    rows = []
    for r in sel.tolist():
        v = kv[:, r].tolist()
        row = [None if v[k] < 0 else pools[k][v[k]] for k in range(4)]
        row += [None if v[4] < 0 else v[4] + 1998,
                None if v[5] < 0 else v[5] + 1,
                None if v[6] < 0 else v[6] + 1,
                None if v[7] < 0 else S.STORE_IDS[v[7]]]
        rows.append(tuple(row) + (float(sumsales[r]), int(rk[r])))
    return rows


def _ds_group(keys: list, values: np.ndarray) -> tuple:
    """(unique key rows as columns, the sum of ``values`` per key row)."""
    uniq, sums = _group_sums(keys, values)
    return [uniq[:, k] for k in range(uniq.shape[1])], sums[0]


def ds_q3_oracle(cols: dict, S) -> list:
    """(d_year, i_brand, sum_agg) of November sales of category id 1,
    by year ascending, sum descending, brand ascending; first 100."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, dd["d_moy"] == 11,
                         it["i_category_id"] == 1)
    (year, brand), s = _ds_group([dd["d_year"][d], it["i_brand"][i]],
                                 ss["ss_sales_price"][m])
    o = np.lexsort((brand, -s, year))[:100]
    return [(int(year[j]), S.BRANDS[brand[j]], float(s[j])) for j in o]


def ds_q42_oracle(cols: dict, S) -> list:
    """(d_year, d_qoy, i_category, revenue) of 1999, by revenue
    descending, then year, quarter and category name; first 100."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, dd["d_year"] == 1999)
    (year, qoy, cat), s = _ds_group(
        [dd["d_year"][d], dd["d_qoy"][d], it["i_category"][i]],
        ss["ss_sales_price"][m])
    name = np.array(S.CATEGORIES)[cat]
    o = np.lexsort((name, qoy, year, -s))[:100]
    return [(int(year[j]), int(qoy[j]), str(name[j]), float(s[j]))
            for j in o]


def ds_q55_oracle(cols: dict, S) -> list:
    """(i_brand, ext_price) of December 1998, by revenue descending, then
    brand; first 100."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, (dd["d_moy"] == 12) & (dd["d_year"] == 1998))
    (brand,), s = _ds_group([it["i_brand"][i]], ss["ss_sales_price"][m])
    o = np.lexsort((brand, -s))[:100]
    return [(S.BRANDS[brand[j]], float(s[j])) for j in o]


def ds_q89_oracle(cols: dict, S) -> list:
    """(i_category, i_class, d_moy, sum_sales, avg_monthly_sales) of
    1999: monthly class sales above 110% of the class's average month,
    by category name, class and month."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    d, i, m = _ds_joined(cols, dd["d_year"] == 1999)
    (cat, cls, moy), s = _ds_group(
        [it["i_category"][i], it["i_class"][i], dd["d_moy"][d]],
        ss["ss_sales_price"][m])
    cc, inv = _unique_rows(np.stack([cat, cls], axis=1))
    avg = (np.bincount(inv, weights=s) / np.bincount(inv))[inv]
    keep = (s - avg) / avg > 0.1
    name = np.array(S.CATEGORIES)[cat]
    o = [j for j in np.lexsort((moy, cls, name)) if keep[j]]
    return [(str(name[j]), S.CLASSES[cls[j]], int(moy[j]), float(s[j]),
             float(avg[j])) for j in o]


def ds_q98_oracle(cols: dict, S) -> list:
    """(i_category, i_class, itemrevenue, revenueratio) of 1999 for
    Books, Home and Sports: class revenue and its percent of the
    category's, by category name and class."""
    dd, it, ss = cols["date_dim"], cols["item"], cols["store_sales"]
    picked = np.isin(it["i_category"], [S.CATEGORIES.index(c) for c in (
        "Books", "Home", "Sports")])
    d, i, m = _ds_joined(cols, dd["d_year"] == 1999, picked)
    (cat, cls), s = _ds_group([it["i_category"][i], it["i_class"][i]],
                              ss["ss_sales_price"][m])
    total = np.bincount(cat, weights=s, minlength=len(S.CATEGORIES))[cat]
    ratio = s * 100.0 / total
    name = np.array(S.CATEGORIES)[cat]
    o = np.lexsort((cls, name))
    return [(str(name[j]), S.CLASSES[cls[j]], float(s[j]), float(ratio[j]))
            for j in o]


DS_QUERIES = ("q67", "ds_q3", "ds_q42", "ds_q55", "ds_q89", "ds_q98")
# Queries whose every number is a sum of whole numbers (exact on both
# engines); ds_q89's average and ds_q98's ratio are divisions.
DS_EXACT = ("q67", "ds_q3", "ds_q42", "ds_q55")
# Under the default conf the float Sum aggregate of each runs on the host
# engine (q67's ExpandExec with it); the window and the sort stay on the
# card.
DS_DEFAULT_HOST = {q: ["LogicalAggregate"] for q in DS_QUERIES}
DS_MUST_LAUNCH = dict({q: ("radix_sort",) for q in DS_QUERIES},
                      ds_q89=("radix_sort", "seg_reduce"),
                      ds_q98=("radix_sort", "seg_reduce"))
# Warm runs by conf: none under the default conf, for the script's time
# budget.
DS_WARM_RUNS = {"vfa": 1, "default": 0}


_SUITE_SF1: dict = {}


def suite_columns_sf1(S) -> dict:
    """The suites' scale-1 columns (seed 0), generated once for the
    phases that read them (13, 14, 15, 16 and 18)."""
    if "cols" not in _SUITE_SF1:
        _SUITE_SF1["cols"] = S.suite_columns(1.0, seed=0)
    return _SUITE_SF1["cols"]


def ds_oracles(cols: dict, S, queries=DS_QUERIES) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-14 query (of
    ``queries``)."""
    out = {}
    for q in DS_QUERIES:
        if q not in queries:
            continue
        oracle = globals()[f"{q}_oracle"]
        out[q] = ((lambda q: lambda rows, want: check_rows(
            q, rows, want, exact=q in DS_EXACT))(q),
            memo_oracle(q, cols, lambda oracle=oracle: oracle(cols, S)))
    return out


def k1_time(native, keys, perm, label: str) -> dict:
    """One K1 launch shape timed: kernel, plain version and one PyTorch
    call for the same function (``torch.sort``, gathered through
    ``perm`` when there is one) in turns, beside the byte bound."""
    import torch
    r = dict(sort_bound(keys.numel(), keys.element_size(), perm is not None))
    fns = {"ms": lambda: native.stable_argsort_u32(keys, perm),
           "library_route_ms": lambda: native.stable_argsort_u32_library(
               keys, perm)}
    if perm is None:
        fns["library_ms"] = lambda: torch.sort(keys, stable=True)
    else:
        fns["library_ms"] = lambda: perm.index_select(0, torch.sort(
            keys.index_select(0, perm), stable=True).indices)
    r.update(turns_ms(fns, 10))
    r["plain_ms"] = cuda_ms(
        lambda: native.stable_argsort_u32_plain(keys, perm), 3, warmup=1)
    r["device_ms"] = device_ms(fns["ms"], 5)
    log(f"{label} K1 {k1_shape(keys, perm)}: kernel {r['ms']:.4f} ms "
        f"(device {r['device_ms']}), plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']:.4f} ms, library route "
        f"{r['library_route_ms']:.4f} ms, bound "
        f"{bound_text(r['bound_ms'])} ms")
    return r


def ds_queries_phase(native, known_seen: list, known_k1: set) -> dict:
    """TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89 and ds_q98 (scale 1)
    through ``TpuSession()`` on the card, once with ``variableFloatAgg``
    on and once under the default conf. For each run: the plan's host
    nodes and bridges, the rows and bytes each ``DeviceToHostExec``
    downloads, the first run (launch counters around it alone, every
    K1-K4 launch recorded) checked against its numpy oracle and the
    kernels it must launch, warm runs, and the peak device memory. Every
    K1-K4 launch of a shape no earlier phase checked is held to the
    kernel's plain version bit for bit; the largest new K1 shape (q67's
    window sort) is timed against its plain version and ``torch.sort``."""
    import torch
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t_phase = time.perf_counter()
    cols = suite_columns_sf1(S)
    oracles = ds_oracles(cols, S)
    log(f"phase 14: TPC-DS scale 1 "
        f"({len(cols['store_sales']['ss_item_sk'])} store_sales rows) and "
        f"oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": []}
    new_k1 = {}
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = S.suite_tables(session, cols, DS_QUERIES)
        for q in DS_QUERIES:
            check, want = oracles[q]
            t0 = time.perf_counter()
            phys = S.QUERIES[q](session, tables[q])._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            label = f"{q} ({conf_name})"
            k1_calls = []
            with recording_k1(native, k1_calls):
                r = run_checked(native, label, phys, check, want,
                                DS_DEFAULT_HOST[q] if conf_name == "default"
                                else [], DS_MUST_LAUNCH[q], known_seen,
                                known_k1)
            if conf_name == "vfa":
                ONE_PARTITION_ROWS[q] = r["rows"]
            for a in k1_calls:
                if k1_shape(*a) not in known_k1:
                    new_k1.setdefault(k1_shape(*a), a)
            del k1_calls
            known_seen.append(r["seen"])
            known_k1 |= {c["shape"] for c in r["checks"]
                         if c["kernel"] == "radix_sort"}
            out["kernel_checks"] += r["checks"]
            warm = []
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for _ in range(DS_WARM_RUNS[conf_name]):
                t0 = time.perf_counter()
                rows = phys.collect(ExecContext(phys.conf))
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(rows, want)
            peak = torch.cuda.max_memory_allocated() if warm else None
            peak_text = (f"peak device memory in the warm run "
                         f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
                         f"held before it)") if warm else \
                "no warm run (cut for time)"
            log(f"{label} matches the numpy oracle ({len(r['rows'])} rows):"
                f" plan {plan_ms:.2f} ms, first run {r['first_s']:.3f} s, "
                f"warm {[round(w, 4) for w in warm]} s, {peak_text}; "
                f"launches {r['launches']}")
            out[(q, conf_name)] = dict(
                plan_ms=plan_ms, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], moved=r["moved"],
                hosted=r["hosted"], peak_bytes=peak, held_bytes=held)
            if (q, conf_name) == ("q67", "vfa"):
                # Phase 23 (c) runs it again, fused and unfused.
                out["q67"] = dict(phys=phys, plan=S.QUERIES[q](
                    session, tables[q])._plan, check=check, want=want,
                    launches=r["launches"])
    if new_k1:
        keys, perm = new_k1[max(new_k1)]
        out["k1"] = k1_time(native, keys, perm, "phase 14 largest new")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: COUNT DISTINCT and LIKE (TPCxBB xbb_q12; TPC-H q10, q13, q16,
# q17, q18 and q21) under both confs
# ---------------------------------------------------------------------------

def _like_pool(pool, pattern: str) -> np.ndarray:
    """Which entries of a string pool match a LIKE pattern of ``%`` and
    ``_`` (no escapes), by Python's ``re``."""
    import re
    rx = re.compile("(?s)^" + "".join(
        ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
        for ch in pattern) + "$")
    return np.array([rx.match(v) is not None for v in pool])


def q10_oracle(cols: dict, E) -> list:
    """TPC-H Q10 in plain numpy: returned-item revenue per customer of
    the orders of 1993Q4, the top 20 as (c_custkey, c_name, revenue,
    c_acctbal, n_name, c_address, c_phone, c_comment); a set (near-equal
    revenues may swap, as the reference's ``_SET_COMPARE`` allows)."""
    o, li, c = cols["orders"], cols["lineitem"], cols["customer"]
    om = (o["o_orderdate"] >= E.days("1993-10-01")) & \
        (o["o_orderdate"] < E.days("1994-01-01"))
    lm = (li["l_returnflag"] == ord("R")) & om[li["l_orderkey"] - 1]
    cust = o["o_custkey"][li["l_orderkey"][lm] - 1]
    rev = li["l_extendedprice"][lm] * (1.0 - li["l_discount"][lm])
    keys, inv = np.unique(cust, return_inverse=True)
    revenue = np.bincount(inv.reshape(-1), weights=rev)
    top = np.argsort(-revenue, kind="stable")[:20]
    ci = keys[top] - 1
    names, phones = _strings(c["c_name"][ci]), _strings(c["c_phone"][ci])
    nations = [nm for nm, _ in E.NATIONS]
    return [(int(keys[t]), names[i], float(revenue[t]),
             float(c["c_acctbal"][ci[i]]),
             nations[int(c["c_nationkey"][ci[i]])],
             E.O_COMMENTS[int(c["c_address"][ci[i]])], phones[i],
             E.O_COMMENTS[int(c["c_comment"][ci[i]])])
            for i, t in enumerate(top)]


def q13_oracle(cols: dict, E) -> list:
    """TPC-H Q13 in plain numpy: for each count of non-'special requests'
    orders a customer has (0 for a customer with none: the left join's
    NULL is not counted), how many customers have it; by custdist desc,
    c_count desc."""
    o, c = cols["orders"], cols["customer"]
    keep = ~_like_pool(E.O_COMMENTS, "%special%requests%")[o["o_comment"]]
    n_cust = len(c["c_custkey"])
    c_count = np.bincount(o["o_custkey"][keep], minlength=n_cust + 1)[
        c["c_custkey"]]
    counts, custdist = np.unique(c_count, return_counts=True)
    order = np.lexsort((-counts, -custdist))
    return [(int(counts[i]), int(custdist[i])) for i in order]


def q16_oracle(cols: dict, E) -> list:
    """TPC-H Q16 in plain numpy: distinct suppliers without complaints
    per (p_brand, p_type, p_size) of the chosen parts; by supplier_cnt
    desc, then brand, type and size."""
    p, ps, s = cols["part"], cols["partsupp"], cols["supplier"]
    bad = _like_pool(E.S_COMMENTS, "%Customer%Complaints%")[s["s_comment"]]
    brands, types = _strings(p["p_brand"]), _strings(p["p_type"])
    sizes = {49, 14, 23, 45, 19, 3, 36, 9}
    ok = np.array([b != "Brand#45" and not t.startswith("MEDIUM POLISHED")
                   and int(z) in sizes
                   for b, t, z in zip(brands, types, p["p_size"])])
    psm = ok[ps["ps_partkey"] - 1] & ~bad[ps["ps_suppkey"] - 1]
    groups: dict = {}
    for pk, sk in zip(ps["ps_partkey"][psm].tolist(),
                      ps["ps_suppkey"][psm].tolist()):
        i = pk - 1
        groups.setdefault((brands[i], types[i], int(p["p_size"][i])),
                          set()).add(sk)
    rows = [k + (len(v),) for k, v in groups.items()]
    rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    return rows


def q17_oracle(cols: dict, E) -> list:
    """TPC-H Q17 in plain numpy: the yearly loss of the Brand#23 / MED BOX
    lines below a fifth of their part's average quantity (NULL when no
    line is)."""
    p, li = cols["part"], cols["lineitem"]
    pm = _matrix_rows(p["p_brand"], "Brand#23") & \
        _matrix_rows(p["p_container"], "MED BOX")
    lm = pm[li["l_partkey"] - 1]
    pk, qty = li["l_partkey"][lm], li["l_quantity"][lm]
    keys, inv = np.unique(pk, return_inverse=True)
    inv = inv.reshape(-1)
    avg = np.bincount(inv, weights=qty) / np.bincount(inv)
    small = qty < avg[inv] * 0.2
    if not small.any():
        return [(None,)]            # SUM of no rows is NULL
    return [(float(li["l_extendedprice"][lm][small].sum()) / 7.0,)]


def q18_oracle(cols: dict, E) -> list:
    """TPC-H Q18 in plain numpy: the orders whose lines hold more than 300
    units, as (c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum_qty), by o_totalprice desc, o_orderdate, top 100."""
    o, li, c = cols["orders"], cols["lineitem"], cols["customer"]
    qty = np.bincount(li["l_orderkey"], weights=li["l_quantity"])
    big = np.flatnonzero(qty > 300.0)
    oi = big - 1
    order = np.lexsort((o["o_orderdate"][oi], -o["o_totalprice"][oi]))
    oi = oi[order][:100]
    ci = o["o_custkey"][oi] - 1
    names = _strings(c["c_name"][ci])
    return [(names[i], int(c["c_custkey"][ci[i]]),
             int(o["o_orderkey"][k]), int(o["o_orderdate"][k]),
             float(o["o_totalprice"][k]), float(qty[o["o_orderkey"][k]]))
            for i, k in enumerate(oi)]


def q21_oracle(cols: dict, E) -> list:
    """TPC-H Q21 in plain numpy: late lines of SAUDI ARABIA suppliers in
    fulfilled orders where another supplier shipped too and none of the
    others was late, counted per supplier; by numwait desc, s_name."""
    o, li, s = cols["orders"], cols["lineitem"], cols["supplier"]
    saudi = [nm for nm, _ in E.NATIONS].index("SAUDI ARABIA")
    key, supp = li["l_orderkey"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    # Lines are contiguous per order: one segment each.
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    seg = np.cumsum(np.r_[True, key[1:] != key[:-1]]) - 1
    big = np.iinfo(np.int64).max
    lo = np.minimum.reduceat(supp, starts)[seg]
    hi = np.maximum.reduceat(supp, starts)[seg]
    late_lo = np.minimum.reduceat(np.where(late, supp, big), starts)[seg]
    late_hi = np.maximum.reduceat(np.where(late, supp, -1), starts)[seg]
    other = (lo != supp) | (hi != supp)
    other_late = (late_lo != supp) | (late_hi != supp)
    ok = late & (o["o_orderstatus"][key - 1] == ord("F")) & other & \
        ~other_late & (s["s_nationkey"][supp - 1] == saudi)
    counts = np.bincount(supp[ok], minlength=len(s["s_suppkey"]) + 1)
    names = _strings(s["s_name"])
    rows = [(names[k - 1], int(counts[k])) for k in np.flatnonzero(counts)]
    rows.sort(key=lambda r: (-r[1], r[0]))
    return rows[:100]


def xbb_q12_oracle(cols: dict, S) -> list:
    """TPCxBB q12 in plain numpy: distinct non-NULL users per item
    category, by category."""
    w, it = cols["web_clickstreams"], cols["item"]
    user = w["wcs_user_sk"]
    ok = ~np.ma.getmaskarray(user)
    cat = it["i_category"][w["wcs_item_sk"][ok] - 1]
    pairs, _inv = _unique_rows(np.stack([cat, np.ma.getdata(user)[ok]],
                                        axis=1))
    counts = np.bincount(pairs[:, 0], minlength=len(S.CATEGORIES))
    return sorted((S.CATEGORIES[i], int(n)) for i, n in enumerate(counts)
                  if n)


DISTINCT_TPCH = ("q10", "q13", "q16", "q17", "q18", "q21")
DISTINCT_QUERIES = ("xbb_q12",) + DISTINCT_TPCH
# Under the default conf the float Sum/Avg aggregates run on the host
# engine: q10's revenue sum, q17's average and sum, q18's two quantity
# sums. COUNT and COUNT DISTINCT stay on the card.
DISTINCT_DEFAULT_HOST = {"xbb_q12": [], "q10": ["LogicalAggregate"],
                         "q13": [], "q16": [],
                         "q17": ["LogicalAggregate", "LogicalAggregate"],
                         "q18": ["LogicalAggregate", "LogicalAggregate"],
                         "q21": []}
# Each query's group-by or sort on the card launches K1 under both confs,
# except q17 under the default conf, whose two aggregates are on the host
# and which has no sort; q13's left join and q21's self-joins probe builds
# with repeated keys (K3).
DISTINCT_MUST_LAUNCH = {
    (q, c): () if (q, c) == ("q17", "default") else
    ("radix_sort", "join_probe") if q in ("q13", "q21") else ("radix_sort",)
    for q in DISTINCT_QUERIES for c in ("vfa", "default")}
# Warm runs by conf: none under the default conf, for the script's time
# budget.
DISTINCT_WARM_RUNS = {"vfa": 1, "default": 0}


def distinct_oracles(cols: dict, xcols: dict, E, S,
                     queries=DISTINCT_QUERIES) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-15 query (of
    ``queries``); q10 as a set of rows."""
    out = {}
    if "xbb_q12" in queries:
        out["xbb_q12"] = ((lambda rows, want: check_rows(
            "xbb_q12", rows, want)), memo_oracle(
                "xbb_q12", xcols, lambda: xbb_q12_oracle(xcols, S)))
    for q in DISTINCT_TPCH:
        if q not in queries:
            continue
        out[q] = ((lambda q: lambda rows, want: check_rows(
            q, rows, want, multiset=q == "q10"))(q),
            memo_oracle(q, cols, lambda q=q: globals()[f"{q}_oracle"](
                cols, E)))
    return out


def distinct_queries_phase(native, cols: dict, known_seen: list,
                           known_k1: set) -> dict:
    """TPCxBB xbb_q12 (scale 1) and TPC-H q10, q13, q16, q17, q18 and q21
    (SF1) through ``TpuSession()`` on the card, once with
    ``variableFloatAgg`` on and once under the default conf. For each
    run: the plan's host nodes and bridges, the rows and bytes each
    ``DeviceToHostExec`` downloads, the first run (launch counters around
    it alone, every K1-K4 launch recorded) checked against its numpy
    oracle and the kernels it must launch, ``DISTINCT_WARM_RUNS`` warm
    runs, each checked, and the peak device memory of the warm runs.
    Every K1-K4 launch of a shape no earlier phase checked is held to the
    kernel's plain version bit for bit."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    t_phase = time.perf_counter()
    xcols = suite_columns_sf1(S)
    oracles = distinct_oracles(cols, xcols, E, S)
    log(f"phase 15: oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": []}
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = dict(tpch.tpch_tables(session, cols, DISTINCT_TPCH),
                      **S.suite_tables(session, xcols, ("xbb_q12",)))
        for q in DISTINCT_QUERIES:
            check, want = oracles[q]
            run = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            t0 = time.perf_counter()
            phys = run(session, tables[q])._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            label = f"{q} ({conf_name})"
            r = run_checked(native, label, phys, check, want,
                            DISTINCT_DEFAULT_HOST[q]
                            if conf_name == "default" else [],
                            DISTINCT_MUST_LAUNCH[q, conf_name], known_seen,
                            known_k1)
            if conf_name == "vfa":
                ONE_PARTITION_ROWS[q] = r["rows"]
            known_seen.append(r["seen"])
            known_k1 |= {c["shape"] for c in r["checks"]
                         if c["kernel"] == "radix_sort"}
            out["kernel_checks"] += r["checks"]
            warm = []
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for _ in range(DISTINCT_WARM_RUNS[conf_name]):
                t0 = time.perf_counter()
                rows = phys.collect(ExecContext(phys.conf))
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
                check(rows, want)
            peak = torch.cuda.max_memory_allocated() if warm else None
            peak_text = (f"peak device memory in the warm runs "
                         f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
                         f"held before them)") if warm else \
                "no warm run (cut for time)"
            log(f"{label} matches the numpy oracle ({len(r['rows'])} rows):"
                f" plan {plan_ms:.2f} ms, first run {r['first_s']:.3f} s, "
                f"warm {[round(w, 4) for w in warm]} s, {peak_text}; "
                f"launches {r['launches']}")
            out[(q, conf_name)] = dict(
                plan_ms=plan_ms, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], moved=r["moved"],
                hosted=r["hosted"], peak_bytes=peak, held_bytes=held)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the shuffle exchange, the shuffled and nested-loop joins,
# Substring and the fixed-width Cast
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix_k1(k1):
    k1 = (k1 * 0xCC9E2D51) & _M32
    k1 = ((k1 << 15) | (k1 >> 17)) & _M32
    return (k1 * 0x1B873593) & _M32


def _mix_h1(h1, k1):
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & _M32
    return (h1 * 5 + 0xE6546B64) & _M32


def murmur3_long(v: np.ndarray, seed: int = 42) -> np.ndarray:
    """Spark's murmur3 (Murmur3_x86_32.hashLong) of int64 values with
    ``seed``, as int32, in numpy uint64 lanes masked to 32 bits."""
    u = v.astype(np.int64).view(np.uint64)
    h = np.full(len(u), seed, np.uint64)
    h = _mix_h1(h, _mix_k1(u & np.uint64(_M32)))
    h = _mix_h1(h, _mix_k1(u >> np.uint64(32)))
    h ^= np.uint64(8)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(_M32)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(_M32)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32).view(np.int32)


def repart_buckets(keys: np.ndarray, n: int) -> np.ndarray:
    """pmod(murmur3(key), n) of each key."""
    return np.mod(murmur3_long(keys).astype(np.int64), n)


def repart_oracle(cols: dict, S) -> list:
    """repart in plain numpy: rows per hash bucket of wcs_item_sk."""
    key = np.ma.getdata(cols["web_clickstreams"]["wcs_item_sk"])
    counts = np.bincount(repart_buckets(key, S.REPART_N),
                         minlength=S.REPART_N)
    return [(b, int(c)) for b, c in enumerate(counts) if c]


def _nation(E, name: str) -> int:
    return [nm for nm, _ in E.NATIONS].index(name)


def q11_oracle(cols: dict, E) -> list:
    """TPC-H Q11 in plain numpy: the stock value of each part held by
    GERMANY's suppliers above 0.0001 of the total, by value desc (a set:
    near-equal values may swap, as the reference's ``_SET_COMPARE``
    allows)."""
    ps, s = cols["partsupp"], cols["supplier"]
    ger = s["s_nationkey"] == _nation(E, "GERMANY")
    keep = ger[ps["ps_suppkey"] - 1]
    value = ps["ps_supplycost"][keep] * ps["ps_availqty"][keep]
    total = value.sum()
    keys, inv = np.unique(ps["ps_partkey"][keep], return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=value)
    hit = sums > total * 0.0001
    order = np.argsort(-sums[hit], kind="stable")
    return [(int(k), float(v)) for k, v in
            zip(keys[hit][order], sums[hit][order])]


def q15_oracle(cols: dict, E) -> list:
    """TPC-H Q15 in plain numpy: the supplier(s) of the largest revenue
    shipped in 1996Q1, by s_suppkey."""
    li, s = cols["lineitem"], cols["supplier"]
    m = (li["l_shipdate"] >= E.days("1996-01-01")) & \
        (li["l_shipdate"] < E.days("1996-04-01"))
    rev = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    keys, inv = np.unique(li["l_suppkey"][m], return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=rev)
    top = np.flatnonzero(sums == sums.max())
    si = keys[top] - 1
    names, phones = _strings(s["s_name"][si]), _strings(s["s_phone"][si])
    return [(int(keys[t]), names[i], E.S_COMMENTS[int(s["s_address"][
        si[i]])], phones[i], float(sums[t])) for i, t in enumerate(top)]


def q20_oracle(cols: dict, E) -> list:
    """TPC-H Q20 in plain numpy: CANADA's suppliers of 'forest' parts
    whose stock exceeds half the quantity they shipped in 1994, by
    s_name."""
    p, li, ps, s = (cols["part"], cols["lineitem"], cols["partsupp"],
                    cols["supplier"])
    b = np.frombuffer(b"forest", np.uint8)
    forest = np.all(p["p_name"][:, :len(b)] == b, axis=1)
    m = (li["l_shipdate"] >= E.days("1994-01-01")) & \
        (li["l_shipdate"] < E.days("1995-01-01"))
    pair, sums = _group_sums([li["l_partkey"][m], li["l_suppkey"][m]],
                             li["l_quantity"][m])
    sums = sums[0]
    code = pair[:, 0] * (1 << 32) + pair[:, 1]
    order = np.argsort(code)
    ps_code = ps["ps_partkey"] * (1 << 32) + ps["ps_suppkey"]
    pos = np.clip(np.searchsorted(code[order], ps_code), 0,
                  max(len(code) - 1, 0))
    found = code[order][pos] == ps_code
    qty = sums[order][pos]
    ok = forest[ps["ps_partkey"] - 1] & found & \
        (ps["ps_availqty"].astype(np.float64) > qty * 0.5)
    supp = np.unique(ps["ps_suppkey"][ok])
    canada = s["s_nationkey"][supp - 1] == _nation(E, "CANADA")
    names = _strings(s["s_name"][supp[canada] - 1])
    return sorted((nm, E.S_COMMENTS[int(s["s_address"][k - 1])])
                  for nm, k in zip(names, supp[canada]))


def q22_oracle(cols: dict, E) -> list:
    """TPC-H Q22 in plain numpy: customers of seven phone country codes
    with an above-average positive balance and no orders, counted and
    summed per code, by code."""
    c, o = cols["customer"], cols["orders"]
    cc = (c["c_phone"][:, 0].astype(np.int64) - 48) * 10 + \
        (c["c_phone"][:, 1].astype(np.int64) - 48)
    sel = np.isin(cc, [13, 31, 23, 29, 30, 18, 17])
    bal = c["c_acctbal"]
    avg = bal[sel & (bal > 0.0)].mean()
    has_order = np.zeros(len(bal) + 1, bool)
    has_order[o["o_custkey"]] = True
    ok = sel & (bal > avg) & ~has_order[c["c_custkey"]]
    codes, inv = np.unique(cc[ok], return_inverse=True)
    inv = inv.reshape(-1)
    counts = np.bincount(inv, minlength=len(codes))
    sums = np.bincount(inv, weights=bal[ok], minlength=len(codes))
    return [(f"{int(k):02d}", int(n), float(t))
            for k, n, t in zip(codes, counts, sums)]


LAST_TPCH = ("q11", "q15", "q20", "q22")
LAST_QUERIES = ("repart",) + LAST_TPCH
# Under the default conf the float Sum/Avg aggregates run on the host
# engine: q11's total and per-part sums, q15's revenue sum (twice: the
# plan reads it on both sides of the cross join), q20's quantity sum,
# q22's average and its final sum. repart counts, on the card.
LAST_DEFAULT_HOST = {
    "repart": [], "q11": ["LogicalAggregate", "LogicalAggregate"],
    "q15": ["LogicalAggregate", "LogicalAggregate"],
    "q20": ["LogicalAggregate"],
    "q22": ["LogicalAggregate", "LogicalAggregate"]}
# repart's 16-way exchange sorts by partition id (K1) under both confs;
# each other query sorts its output on the card.
LAST_MUST_LAUNCH = {(q, c): ("radix_sort",) for q in LAST_QUERIES
                    for c in ("vfa", "default")}
# The 8-partition runs, each held to its oracle and to its one-partition
# run; the shuffled joins of q4, q13 and q21 probe builds with repeated
# keys, so K3 launches there.
SHUFFLED = ("q1", "q4", "q13", "q18", "q21", "xbb_q12", "ds_q89")
SHUFFLED_MUST_LAUNCH = dict(
    {q: ("radix_sort",) for q in SHUFFLED},
    q4=("radix_sort", "join_probe"), q13=("radix_sort", "join_probe"),
    q21=("radix_sort", "join_probe"), ds_q89=("radix_sort", "seg_reduce"))
SHUFFLE_PARTITIONS = 8
LAST_WARM_RUNS = 0    # 1 until phase 25 needed the time


def last_oracles(cols: dict, xcols: dict, E, S) -> dict:
    """chip_smoke.py's (check, expected rows) of each phase-16 query;
    q11 as a set of rows."""
    out = {"repart": ((lambda rows, want: check_rows(
        "repart", rows, want)), repart_oracle(xcols, S))}
    for q in LAST_TPCH:
        out[q] = ((lambda q: lambda rows, want: check_rows(
            q, rows, want, multiset=q == "q11"))(q),
            globals()[f"{q}_oracle"](cols, E))
    return out


def full_join_frames(session, cols: dict, E, L):
    """CUSTOMER (with c_acctbal > 0) full outer join ORDERS on the
    customer key, as the count of its matched, left-only and right-only
    rows (kind 0, 1 and 2)."""
    from spark_rapids_tpu_torch.api import DataFrame
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    cschema = (("c_custkey", dt.INT64), ("c_acctbal", dt.FLOAT64))
    oschema = (("o_orderkey", dt.INT64), ("o_custkey", dt.INT64))
    cust = DataFrame(session, L.InMemoryScan(cschema, E.table_partitions(
        cols["customer"], cschema, E.TABLE_PARTITIONS["customer"])))
    orders = DataFrame(session, L.InMemoryScan(oschema, E.table_partitions(
        cols["orders"], oschema, E.TABLE_PARTITIONS["orders"])))
    j = cust.filter(L.col("c_acctbal") > 0.0).join_on(
        orders, ["c_custkey"], ["o_custkey"], how="full")
    kind = L.when(L.col("c_custkey").isNull(), 2) \
        .when(L.col("o_orderkey").isNull(), 1).otherwise(0)
    return j.group_by(kind.alias("kind")).agg(
        L.agg_count().alias("n")).order_by("kind")


def full_join_oracle(cols: dict) -> list:
    c, o = cols["customer"], cols["orders"]
    keep = np.zeros(len(c["c_custkey"]) + 1, bool)
    keep[c["c_custkey"][c["c_acctbal"] > 0.0]] = True
    matched = int(keep[o["o_custkey"]].sum())
    has_order = np.zeros_like(keep)
    has_order[o["o_custkey"]] = True
    left_only = int((keep & ~has_order).sum())
    right_only = len(o["o_custkey"]) - matched
    return [(k, n) for k, n in enumerate((matched, left_only, right_only))
            if n]


def _warm(phys, check, want, runs: int) -> tuple:
    """Warm walls of ``runs`` checked runs and their peak device memory
    (bytes, and bytes held before them)."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    warm = []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for _ in range(runs):
        t0 = time.perf_counter()
        rows = phys.collect(ExecContext(phys.conf))
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(rows, want)
    return warm, torch.cuda.max_memory_allocated(), held


def _exchanges(e, out=None) -> list:
    out = [] if out is None else out
    if type(e).__name__ == "ShuffleExchangeExec":
        out.append(e)
    for c in e.children:
        _exchanges(c, out)
    return out


def repart_direct(phys, S) -> int:
    """Run repart's repartition exchange alone: every row of output
    partition p must hash to p, and every row must arrive once."""
    from spark_rapids_tpu_torch.columnar.host import download_batches
    from spark_rapids_tpu_torch.ops.base import ExecContext
    ex = next(e for e in _exchanges(phys.root)
              if e.partitioning.num_partitions == S.REPART_N)
    ctx = ExecContext(phys.conf)
    ctx.cache["engine"] = "device"
    total = 0
    for p in range(ex.num_partitions(ctx)):
        hbs = download_batches(list(ex.execute_device(ctx, p)))
        keys = np.concatenate([hb.columns[0].data for hb in hbs]) if hbs \
            else np.zeros(0, np.int64)
        bad = int((repart_buckets(keys, S.REPART_N) != p).sum())
        if bad:
            raise AssertionError(f"repart partition {p}: {bad} rows hash "
                                 "to another partition")
        total += len(keys)
    log(f"repart exchange alone: {ex.num_partitions(ctx)} partitions, "
        f"{total} rows, every row in the partition its key hashes to")
    return total


def exchange_phase(native, cols: dict, known_seen: list,
                   known_k1: set) -> dict:
    """(a) repart and (b) TPC-H q11, q15, q20 and q22 through
    ``TpuSession`` on the card under ``variableFloatAgg`` and under the
    default conf, against numpy oracles; (c) q1, q4, q13, q18, q21,
    xbb_q12 and ds_q89 at ``shuffle.partitions=8`` against their oracles
    and their one-partition runs; (d) a full outer join of CUSTOMER and
    ORDERS at one and eight partitions against numpy counts. For each
    run: host nodes and bridges, rows downloaded, the first run with
    every K1-K4 launch recorded (new shapes against the plain versions),
    ``LAST_WARM_RUNS`` warm walls and the peak device memory of the warm
    runs."""
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    xcols = suite_columns_sf1(S)
    n_clicks = len(xcols["web_clickstreams"]["wcs_item_sk"])
    oracles = last_oracles(cols, xcols, E, S)
    oracles.update(df_oracles(cols, E, SHUFFLED))
    oracles.update(distinct_oracles(cols, xcols, E, S, SHUFFLED))
    oracles.update(ds_oracles(xcols, S, ("ds_q89",)))
    fj_want = full_join_oracle(cols)
    oracles["full_join"] = ((lambda rows, want: check_rows(
        "full_join", rows, want)), fj_want)
    log(f"phase 16: oracles in {time.perf_counter() - t_phase:.2f} s")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": []}

    def run(label, phys, q, hosted, must, warm_runs=LAST_WARM_RUNS):
        check, want = oracles[q]
        r = run_checked(native, label, phys, check, want, hosted, must,
                        known_seen, known_k1)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        warm, peak, held = _warm(phys, check, want, warm_runs)
        peak_text = (f"warm {[round(w, 4) for w in warm]} s, peak device "
                     f"memory in the warm runs {peak / 2**30:.3f} GiB "
                     f"({held / 2**30:.3f} GiB held before them)") \
            if warm else "no warm run (cut for time)"
        log(f"{label} matches the numpy oracle ({len(r['rows'])} rows): "
            f"first run {r['first_s']:.3f} s, {peak_text}; launches "
            f"{r['launches']}")
        out[label] = dict(first_s=r["first_s"], warm_s=warm,
                          launches=r["launches"], moved=r["moved"],
                          hosted=r["hosted"], peak_bytes=peak,
                          held_bytes=held)
        return r["rows"]

    # (a) and (b): repart and q11, q15, q20, q22 under both confs.
    for conf_name, conf in (("vfa", {
            "spark.rapids.sql.variableFloatAgg.enabled": True}),
            ("default", {})):
        session = TpuSession(conf)
        tables = dict(tpch.tpch_tables(session, cols, LAST_TPCH),
                      **S.suite_tables(session, xcols, ("repart",)))
        for q in LAST_QUERIES:
            fn = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            phys = fn(session, tables[q])._physical()
            rows = run(f"{q} ({conf_name})", phys, q,
                       LAST_DEFAULT_HOST[q] if conf_name == "default"
                       else [], LAST_MUST_LAUNCH[q, conf_name])
            if q == "repart":
                if sum(n for _b, n in rows) != n_clicks:
                    raise AssertionError(f"repart counted {rows}, not "
                                         f"{n_clicks} rows")
                if repart_direct(phys, S) != n_clicks:
                    raise AssertionError("repart's exchange lost rows")

    # (c): the 8-partition runs against their one-partition runs.
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    by_n = {}
    for n in (1, SHUFFLE_PARTITIONS):
        session = TpuSession(dict(
            vfa, **{"spark.rapids.sql.shuffle.partitions": n}))
        tables = dict(tpch.tpch_tables(session, cols, [
            q for q in SHUFFLED if q in tpch.QUERIES]),
            **S.suite_tables(session, xcols, ("xbb_q12", "ds_q89")))
        for q in SHUFFLED:
            fn = S.QUERIES[q] if q in S.QUERIES else tpch.QUERIES[q]
            if n == 1:
                by_n[q] = ONE_PARTITION_ROWS.get(q)
                if by_n[q] is None:
                    by_n[q] = fn(session, tables[q])._physical().collect()
                continue
            phys = fn(session, tables[q])._physical()
            rows = run(f"{q} ({n} partitions)", phys, q, [],
                       SHUFFLED_MUST_LAUNCH[q])
            if not rows_close(rows, by_n[q]):
                raise AssertionError(f"{q} at {n} partitions differs from "
                                     "its one-partition run")
        if n != 1:
            log(f"{', '.join(SHUFFLED)} at {n} partitions equal their "
                "one-partition runs")

    # (d): a full outer join at one and eight partitions.
    for n in (1, SHUFFLE_PARTITIONS):
        session = TpuSession(dict(
            vfa, **{"spark.rapids.sql.shuffle.partitions": n}))
        phys = full_join_frames(session, cols, E, L)._physical()
        run(f"full outer join ({n} partitions)", phys, "full_join", [],
            ("radix_sort", "join_probe"))
    out["seconds"] = time.perf_counter() - t_phase
    out["oracles"] = oracles
    log(f"phase 16 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the memory tier and out-of-core execution
# ---------------------------------------------------------------------------

# No warm runs, for the script's time budget (they took ~13 s, the sort's
# ~6 s of it); each peak is then the first run's.
OOC_WARM_RUNS = 0
# (a): a device budget far below the sort's staged bytes (so at least four
# range buckets) and a host tier below them too (so entries reach disk).
SORT_BUDGET = 128 << 20
SORT_HOST_BYTES = 160 << 20
SORT_KEYS = ("l_suppkey", "l_partkey", "l_orderkey", "l_linenumber")
# (e), (f) and phase 22 (g): shares of the memory q18's uncapped run
# reserves above its start that the process may reserve, tried in turn
# until one raises a real OOM. The uncapped peak holds cached blocks a
# capped allocator frees first, so the first share that raises moves with
# the allocator's state from run to run. Near the peak the overshoot is
# small and spilling the catalog covers it; further below, a join's probe
# step that every spill left short splits its batch (splitRetries).
OOM_SHARES = (0.9, 0.8, 0.7, 0.6, 0.5)
_BUDGET_KEY = "spark.rapids.memory.tpu.budgetBytes"
_HOST_KEY = "spark.rapids.memory.host.spillStorageSize"


def lineitem_with_linenumber(cols: dict) -> dict:
    """Every LINEITEM row's key, part, supplier and price, with its
    ``l_linenumber`` (the line's position in its order, from 1:
    (l_orderkey, l_linenumber) is the table's primary key; the generator
    keeps an order's lines together)."""
    li = cols["lineitem"]
    key = li["l_orderkey"]
    n = len(key)
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    line = (np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))
            + 1).astype(np.int32)
    return {"l_orderkey": key, "l_linenumber": line,
            "l_partkey": li["l_partkey"], "l_suppkey": li["l_suppkey"],
            "l_extendedprice": li["l_extendedprice"]}


def lineitem_sort_frame(session, tcols: dict, E, L):
    """``tcols`` in LINEITEM's eight partitions, ordered by supplier,
    part, order and line."""
    from spark_rapids_tpu_torch.api import DataFrame
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    schema = (("l_orderkey", dt.INT64), ("l_linenumber", dt.INT32),
              ("l_partkey", dt.INT64), ("l_suppkey", dt.INT64),
              ("l_extendedprice", dt.FLOAT64))
    df = DataFrame(session, L.InMemoryScan(schema, E.table_partitions(
        tcols, schema, E.TABLE_PARTITIONS["lineitem"])))
    return df.order_by(*SORT_KEYS)


def sort_oracle(tcols: dict) -> dict:
    """The sorted columns by ``np.lexsort`` (by one packed int64 key where
    the keys allow it: the same order), after a check that the sort key
    is unique (so the order is fully determined)."""
    pk = tcols["l_orderkey"] * 8 + tcols["l_linenumber"]
    if len(np.unique(pk)) != len(pk):
        raise AssertionError("(l_orderkey, l_linenumber) is not unique")
    keys = np.stack([tcols[k] for k in SORT_KEYS], axis=1)
    radixes = _packed_radixes(keys)
    order = np.lexsort(tuple(tcols[k] for k in reversed(SORT_KEYS))) \
        if radixes is None else np.argsort(_pack_rows(keys, radixes),
                                           kind="stable")
    return {k: v[order] for k, v in tcols.items()}


def check_sorted(hbs: list, want: dict) -> None:
    """Downloaded host batches against the numpy sort, column by column,
    bit for bit, with no NULL."""
    n = len(want["l_orderkey"])
    got_n = sum(hb.num_rows for hb in hbs)
    if got_n != n:
        raise AssertionError(f"sort returned {got_n} rows, not {n}")
    for ci, name in enumerate(hbs[0].names):
        data = np.concatenate([np.asarray(hb.columns[ci].data)
                               for hb in hbs])
        valid = np.concatenate([np.asarray(hb.columns[ci].validity)
                                for hb in hbs])
        if not valid.all() or data.tobytes() != want[name].tobytes():
            raise AssertionError(f"sorted column {name} differs from "
                                 "np.lexsort's")


def ooc_counts(ctx) -> dict:
    """One run's out-of-core and recovery counts: operator metrics summed
    over operators (the Recovery@query entry apart), the window's staged
    bytes, each shuffled join's build bytes, and the catalog's counters."""
    ops, window_staged, builds = {}, 0, []
    for key, m in ctx.metrics.items():
        if key == "Recovery@query":
            continue
        for k in ("outOfCoreBuckets", "stagedBytes", "graceJoinPartitions",
                  "graceJoinBuildBuckets"):
            if k in m.values:
                ops[k] = ops.get(k, 0) + int(m.values[k])
        if m.owner == "WindowExec":
            window_staged += int(m.values.get("stagedBytes", 0))
        if "buildBytes" in m.values:
            builds.append(int(m.values["buildBytes"]))
    rec = ctx.metrics.get("Recovery@query")
    return dict(ops=ops, window_staged=window_staged, builds=builds,
                recovery={k: int(v) for k, v in rec.values.items()}
                if rec is not None else {},
                catalog=dict(ctx.last_spill_metrics or {}))


def check_teardown(label: str, ctx) -> dict:
    """No leak in one run; its counts."""
    if ctx.last_leak_report != []:
        raise AssertionError(f"{label}: leak report {ctx.last_leak_report}")
    return ooc_counts(ctx)


def ooc_runs(native, label: str, phys, check, want, must, known_seen: list,
             known_k1: set, collect=None) -> dict:
    """A checked first run (every K1-K4 launch recorded, new shapes held
    to the plain versions) and ``OOC_WARM_RUNS`` checked warm runs, with
    the peak device memory of the warm runs (of the first run where there
    is none) and each run's teardown checked."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    collect = collect or type(phys).collect
    warm_runs = OOC_WARM_RUNS
    if not warm_runs:
        torch.cuda.reset_peak_memory_stats()
    r = run_checked(native, label, phys, check, want, [], must, known_seen,
                    known_k1, collect=collect)
    known_seen.append(r["seen"])
    known_k1.update(c["shape"] for c in r["checks"]
                    if c["kernel"] == "radix_sort")
    counts = check_teardown(label, r["ctx"])
    recovery = dict(counts["recovery"])
    warm = []
    if warm_runs:
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for _ in range(warm_runs):
        ctx = ExecContext(phys.conf)
        t0 = time.perf_counter()
        rows = collect(phys, ctx)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(rows, want)
        add_counts(recovery, check_teardown(label, ctx)["recovery"])
        del rows
    peak = torch.cuda.max_memory_allocated()
    rows = r["rows"]
    n_rows = sum(hb.num_rows for hb in rows) \
        if rows and hasattr(rows[0], "num_rows") else len(rows)
    return dict(rows=rows, n_rows=n_rows, first_s=r["first_s"], warm_s=warm,
                launches=r["launches"], checks=r["checks"], counts=counts,
                recovery=recovery, peak_bytes=peak, held_bytes=held)


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def log_pair(label: str, budget: int, inc: dict, ooc: dict, note: str = ""):
    c = ooc["counts"]
    cat = c["catalog"]
    ratio = (cat.get("disk_bytes_raw", 0) /
             max(cat.get("disk_bytes_stored", 0), 1))
    log(f"{label} under budgetBytes={budget} ({budget / 2**20:.1f} MiB)"
        f"{note}: {ooc['n_rows']} rows checked in each run (in core "
        f"{inc['n_rows']}); first {ooc['first_s']:.3f} s, warm "
        f"{[round(w, 4) for w in ooc['warm_s']]} s (in core: first "
        f"{inc['first_s']:.3f} s, warm {[round(w, 4) for w in inc['warm_s']]}"
        f" s); peak device memory {ooc['peak_bytes'] / 2**30:.3f} GiB (in "
        f"core {inc['peak_bytes'] / 2**30:.3f} GiB; held before "
        f"{ooc['held_bytes'] / 2**30:.3f} / {inc['held_bytes'] / 2**30:.3f}"
        f" GiB); outOfCoreBuckets {c['ops'].get('outOfCoreBuckets', 0)}, "
        f"graceJoinPartitions {c['ops'].get('graceJoinPartitions', 0)} "
        f"({c['ops'].get('graceJoinBuildBuckets', 0)} non-empty build "
        f"buckets); catalog {cat} (LZ4 ratio {ratio:.2f}); ladder "
        f"{c['recovery'] or 'none'}; launches {ooc['launches']} (in core "
        f"{inc['launches']})")


def out_of_core_phase(native, cols: dict, known_seen: list,
                      known_k1: set) -> dict:
    """(a) An out-of-core sort of every LINEITEM row, (b) q67 with its
    window range-split, (c) q21 and q4 with grace joins, (d) q18 at
    eight partitions with its exchange pieces spilled, each beside its
    in-core run, and (e) a real device OOM recovered by the ladder. See
    the module doc for what each run checks and prints."""
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import suites as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.memory import compression, oom
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    if not isinstance(compression.get_codec("lz4"), compression.Lz4Codec):
        raise AssertionError("the lz4 codec is not the native one")
    oom.reset_degradation()
    xcols = suite_columns_sf1(S)
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    # Each run's Recovery@query metrics, summed over the phase.
    out = {"kernel_checks": [], "runs": [], "recovery": {}}
    log(f"phase 18: TPC-DS scale 1 columns in "
        f"{time.perf_counter() - t_phase:.2f} s")

    def pair(label, make, check, want, must, budget_of, collect=None,
             extra=None):
        """The in-core run, then the run under the budget ``budget_of``
        picks from the in-core run's counts."""
        inc = ooc_runs(native, f"{label} in core", make(vfa)._physical(),
                       check, want, must, known_seen, known_k1, collect)
        budget, conf, note = budget_of(inc)
        ooc = ooc_runs(native, f"{label} out of core",
                       make(dict(vfa, **conf))._physical(), check, want,
                       must, known_seen, known_k1, collect)
        out["kernel_checks"] += inc["checks"] + ooc["checks"]
        out["runs"] += [inc["launches"], ooc["launches"]]
        add_counts(out["recovery"], inc["recovery"])
        add_counts(out["recovery"], ooc["recovery"])
        log_pair(label, budget, inc, ooc, note)
        if extra is not None:
            extra(inc, ooc)
        return inc, ooc

    # (a) The sort.
    t0 = time.perf_counter()
    tcols = lineitem_with_linenumber(cols)
    sort_want = sort_oracle(tcols)
    log(f"(a) sort oracle ({len(sort_want['l_orderkey'])} rows) in "
        f"{time.perf_counter() - t0:.2f} s")

    def sort_budget(inc):
        return SORT_BUDGET, {_BUDGET_KEY: SORT_BUDGET,
                             _HOST_KEY: SORT_HOST_BYTES}, (
            f", spillStorageSize {SORT_HOST_BYTES}; the sort staged "
            f"{inc['counts']['ops'].get('stagedBytes', 0)} B in core")

    def sort_extra(inc, ooc):
        c = ooc["counts"]
        if c["ops"].get("outOfCoreBuckets", 0) < 4:
            raise AssertionError(f"(a) sort made {c['ops']} buckets, not 4+")
        if not c["catalog"]["spill_to_disk"] or \
                not c["catalog"]["restore_from_disk"]:
            raise AssertionError(f"(a) sort never reached disk: {c}")
        if not 0 < c["catalog"]["disk_bytes_stored"] < \
                c["catalog"]["disk_bytes_raw"]:
            raise AssertionError(f"(a) LZ4 did not shrink the spill: {c}")

    pair("(a) LINEITEM sort",
         lambda conf: lineitem_sort_frame(TpuSession(conf), tcols, E, L),
         check_sorted, sort_want, ("radix_sort",), sort_budget,
         collect=lambda phys, ctx: phys.collect_batches(ctx),
         extra=sort_extra)

    # (b) q67 with its window range-split on i_category.
    q67_check, q67_want = ds_oracles(xcols, S, ("q67",))["q67"]

    def make_q67(conf):
        session = TpuSession(conf)
        return S.QUERIES["q67"](session, S.suite_tables(
            session, xcols, ("q67",))["q67"])

    def q67_budget(inc):
        budget = inc["counts"]["window_staged"]
        return budget, {_BUDGET_KEY: budget}, (
            " (the window's staged bytes in core)")

    def q67_extra(inc, ooc):
        if ooc["counts"]["ops"].get("outOfCoreBuckets", 0) < 2:
            raise AssertionError(f"(b) q67 window did not split: "
                                 f"{ooc['counts']}")
        if ooc["rows"] != inc["rows"]:
            raise AssertionError("(b) q67 under the budget differs from "
                                 "its in-core run")

    pair("(b) q67", make_q67, q67_check, q67_want, ("radix_sort",),
         q67_budget, extra=q67_extra)

    # (c) q21 and q4 at one partition with grace joins.
    oracles = {"q21": ((lambda rows, want: check_rows("q21", rows, want)),
                       memo_oracle("q21", cols, lambda: q21_oracle(cols, E))),
               "q4": df_oracles(cols, E, ("q4",))["q4"]}
    for q in ("q21", "q4"):
        check, want = oracles[q]

        def make_q(conf, q=q):
            # The default conf: at one partition the runtime re-plan has
            # no candidate, so the grace path splits the shuffled joins.
            session = TpuSession(conf)
            return tpch.QUERIES[q](session, tpch.tpch_tables(
                session, cols, (q,))[q])

        def grace_budget(inc, q=q):
            builds = inc["counts"]["builds"]
            big = [b for b in builds if b >= max(builds) // 4]
            budget = min(big) // 3
            return budget, {_BUDGET_KEY: budget}, (
                f" (a third of the smallest LINEITEM build of {big})")

        def grace_extra(inc, ooc, q=q):
            c = ooc["counts"]["ops"]
            if c.get("graceJoinPartitions", 0) < 2:
                raise AssertionError(f"(c) {q}: no grace join: {c}")
            if ooc["launches"]["join_probe"] < c["graceJoinBuildBuckets"]:
                raise AssertionError(
                    f"(c) {q}: {ooc['launches']['join_probe']} K3 launches "
                    f"for {c['graceJoinBuildBuckets']} non-empty buckets")

        pair(f"(c) {q}", make_q, check, want, ("radix_sort", "join_probe"),
             grace_budget, extra=grace_extra)

    # (d) q18 at eight partitions with its exchange pieces spilled.
    q18_check, q18_want = ((lambda rows, want: check_rows("q18", rows, want)),
                           memo_oracle("q18", cols,
                                       lambda: q18_oracle(cols, E)))

    def make_q18(conf, n=SHUFFLE_PARTITIONS):
        session = TpuSession(dict(conf, **{
            "spark.rapids.sql.shuffle.partitions": n}))
        return tpch.QUERIES["q18"](session, tpch.tpch_tables(
            session, cols, ("q18",))["q18"])

    by_one = ONE_PARTITION_ROWS.get("q18")
    if by_one is None:
        by_one = make_q18(vfa, 1)._physical().collect()
    q18_check(by_one, q18_want)

    def q18_budget(inc):
        peak = inc["counts"]["catalog"]["peak_device_bytes"]
        budget = peak // 4
        return budget, {_BUDGET_KEY: budget, _HOST_KEY: budget // 2}, (
            f", spillStorageSize {budget // 2} (a quarter and an eighth of "
            f"the {peak} B the catalog held in core)")

    def q18_extra(inc, ooc):
        cat = ooc["counts"]["catalog"]
        if not (cat["spill_to_host"] and cat["spill_to_disk"]
                and cat["restore_from_host"] + cat["restore_from_disk"]):
            raise AssertionError(f"(d) q18 pieces did not spill to host "
                                 f"and disk: {cat}")
        if not rows_close(ooc["rows"], by_one):
            raise AssertionError("(d) q18 differs from its one-partition "
                                 "run")

    pair("(d) q18 (8 partitions)", make_q18, q18_check, q18_want,
         ("radix_sort",), q18_budget, extra=q18_extra)

    # (e) A real OOM: the process may reserve only part of q18's in-core
    # peak; the ladder must recover on the card. The default layout (one
    # partition, where the runtime re-plan has no candidate), then (f) 8
    # partitions with the re-plan on: it materializes the semi join's
    # build before the stage pass, and an exhausted ladder there keeps
    # the static plan (replanOomKeeps).
    oom_phys = make_q18(vfa, 1)._physical()
    out["oom"] = real_oom(oom_phys, q18_check, q18_want)
    out["runs"].append(out["oom"]["launches"])
    add_counts(out["recovery"], out["oom"]["recovery"])
    oom8_phys = make_q18(vfa)._physical()
    out["oom8"] = real_oom(oom8_phys, q18_check, q18_want, "(f)",
                           layout=f"{SHUFFLE_PARTITIONS} partitions")
    out["runs"].append(out["oom8"]["launches"])
    add_counts(out["recovery"], out["oom8"]["recovery"])
    log(f"(f) q18 at {SHUFFLE_PARTITIONS} partitions, re-plan on: "
        f"Cost@query of the recovered run {out['oom8']['cost']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 took {out['seconds']:.1f} s")
    return out


def real_oom(phys, check, want, label: str = "(e)",
             layout: str = "1 partition") -> dict:
    """Measure the reserved memory (the caching allocator's, which its
    cap counts) of one uncapped run, then cap the allocator
    (``set_per_process_memory_fraction``) at what it reserves now plus a
    share of that run's reserved peak above its start, for each of
    ``OOM_SHARES`` in turn, until a run raises a real
    ``torch.OutOfMemoryError`` inside a retry site. That run must recover
    on the card (a rung fired) and match its oracle.
    The fraction is restored after every run."""
    import gc
    import torch
    from spark_rapids_tpu_torch.memory import oom
    from spark_rapids_tpu_torch.ops import native
    from spark_rapids_tpu_torch.ops.base import ExecContext
    total = torch.cuda.get_device_properties(0).total_memory

    def settle() -> int:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    base = settle()
    torch.cuda.reset_peak_memory_stats()
    check(phys.collect(), want)
    torch.cuda.synchronize()
    span = torch.cuda.max_memory_reserved() - base
    for share in OOM_SHARES:
        limit = settle() + int(share * span)
        native.reset_counters()
        oom.last_ladder[:] = []
        ctx = ExecContext(phys.conf)
        torch.cuda.set_per_process_memory_fraction(limit / total)
        try:
            t0 = time.perf_counter()
            rows = phys.collect(ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        launches = native.counters()
        check(rows, want)
        c = check_teardown(f"{label} q18 under a memory cap", ctx)
        rec = c["recovery"]
        log(f"{label} q18 ({layout}) capped at {limit / 2**30:.3f} GiB "
            f"({share:.2f} of the {span / 2**30:.3f} GiB its uncapped run "
            f"reserved above {base / 2**30:.3f} GiB): {wall:.3f} s, rows "
            f"match; ladder {list(oom.last_ladder)}, recovery {rec}, "
            f"catalog {c['catalog']}")
        if rec.get("retriesAttempted", 0) > 0:
            if not oom.last_ladder:
                raise AssertionError(f"{label} a retry with no rung")
            cost = dict(ctx.metrics["Cost@query"].values) \
                if "Cost@query" in ctx.metrics else {}
            return dict(share=share, limit=limit, span=span, wall_s=wall,
                        ladder=list(oom.last_ladder), recovery=rec,
                        launches=launches, cost=cost)
    raise AssertionError(f"{label} no share of {OOM_SHARES} raised an OOM")


# ---------------------------------------------------------------------------
# Phase 9: kernel K4 (the wire codec's RLE decode) against its plain version
# ---------------------------------------------------------------------------

# Run values per wire type, as tests/test_native.py RLE_POOLS, with a NaN
# of a non-default payload among the floats (bit patterns, so -0.0 and the
# payload must survive the expansion).
RLE_POOLS = {
    "int8": (np.int8, [1, 2, -3]),
    "int16": (np.int16, [100, -2000]),
    "int32": (np.int32, [7, -9, 2 ** 30]),
    "int64": (np.int64, [2 ** 40, -5, 0]),
    "float32": (np.float32, [1.5, -0.0, np.nan, 0.0,
                             np.array(0x7FC00123, np.uint32)
                             .view(np.float32)]),
    "float64": (np.float64, [np.nan, -0.0, 0.0, 3.25, np.inf,
                             np.array(0x7FF8000000000123, np.uint64)
                             .view(np.float64)]),
}
RLE_RUNS = (1, 8, 2048, 2049, 4096, "n/4", "n")
_INT_OF = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def rle_inputs(cap: int, name: str, runs, seed: int):
    """A run table as the wire encoder builds it (``_try_rle``): ``runs``
    runs of random lengths over ``n`` rows (``n`` = cap - cap/8, or cap
    for one run per row), values drawn from the type's pool, zero-valued
    padding runs ending at cap. Returns (run_vals, run_ends, num_rows) on
    the card."""
    import torch
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    rng = np.random.default_rng(seed)
    n = cap if runs == "n" else cap - cap // 8
    runs = {"n": n, "n/4": n // 4}.get(runs, runs)
    runs = max(1, min(runs, n))
    np_t, pool = RLE_POOLS[name]
    pool = np.asarray(pool, np_t)
    run_cap = bucket_capacity(runs)
    cuts = np.sort(rng.choice(np.arange(1, n), runs - 1, replace=False)) \
        if runs > 1 else np.zeros(0, np.int64)
    vals = np.zeros(run_cap, np_t)
    vals[:runs] = pool[rng.integers(0, len(pool), runs)]
    ends = np.full(run_cap, cap, np.int32)
    ends[:runs - 1] = cuts
    ends[runs - 1] = n
    return (torch.from_numpy(vals).cuda(), torch.from_numpy(ends).cuda(),
            n)


def _as_bits(t):
    import torch
    return t.view(getattr(torch, _INT_OF[t.element_size()]))


def _as_f64(t, unsigned: bool):
    """Values as float64; integer bit patterns read as unsigned when
    ``unsigned`` (a u64 as hi * 2^32 + lo)."""
    import torch
    if t.is_floating_point() or not unsigned:
        return t.to(torch.float64)
    if t.element_size() < 8:
        return (t.to(torch.int64) & ((1 << 8 * t.element_size()) - 1)).to(
            torch.float64)
    hi = ((t >> 32) & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + (t & 0xFFFFFFFF).to(torch.float64)


def max_abs_err(got, plain, unsigned: bool = False) -> float:
    """Largest |got - plain| over the elements: 0 where the bit patterns
    agree, inf where they differ but the values compare equal or NaN
    (-0.0, NaN payloads)."""
    import torch
    same = _as_bits(got) == _as_bits(plain)
    d = (_as_f64(got, unsigned) - _as_f64(plain, unsigned)).abs()
    d = torch.where(same, torch.zeros_like(d),
                    torch.where(torch.isnan(d) | (d == 0),
                                torch.full_like(d, float("inf")), d))
    return float(d.max()) if d.numel() else 0.0


def rle_check(native, vals, ends, cap: int, nrows: int, label: str,
              timed: bool, profiled: bool = False) -> dict:
    """K4 against its plain version, bit for bit; with ``timed``, kernel,
    plain (also K4's library route, what ``native.rleDecode=false`` runs)
    and one ``torch.repeat_interleave`` times beside the bound; with
    ``profiled``, also the kernel's device time."""
    import torch
    got = native.rle_decode(vals, ends, cap, nrows)
    torch.cuda.synchronize()
    plain = native.rle_decode_plain(vals, ends, cap, nrows)
    if got.dtype != plain.dtype or got.shape != plain.shape:
        raise AssertionError(f"K4 {label}: {got.dtype}{tuple(got.shape)} vs "
                             f"plain {plain.dtype}{tuple(plain.shape)}")
    wrong = int((_as_bits(got) != _as_bits(plain)).sum())
    err = max_abs_err(got, plain)
    if wrong or err != 0:
        raise AssertionError(f"K4 != plain at {label} ({vals.dtype}, "
                             f"run_cap={vals.numel()}, cap={cap}): {wrong} "
                             f"rows differ, max abs err {err}")
    staging = "whole table staged" \
        if vals.numel() <= native.RLE_SMEM_RUNS else "window search"
    r = dict(max_abs_err=err, cap=cap, run_cap=vals.numel(),
             dtype=str(vals.dtype).replace("torch.", ""), staging=staging)
    if not timed:
        return r
    # Bound: the output written once and the run table read once.
    esize = vals.element_size()
    r["bound_ms"] = bytes_ms(cap * esize + vals.numel() * (esize + 4.0))
    r["bound_by"] = "bytes"
    iters = 20 if cap >= 1_000_000 else 50
    r["plain_ms"] = cuda_ms(
        lambda: native.rle_decode_plain(vals, ends, cap, nrows), iters)
    r["library_route_ms"] = r["plain_ms"]
    fns = {"ms": lambda: native.rle_decode(vals, ends, cap, nrows)}
    # One PyTorch call for the expansion: repeat each run by its length.
    # The padding runs cover [num_rows, cap) with zeros, so the counts sum
    # to cap unless the table is full.
    prev = torch.cat([ends.new_zeros(1), ends[:-1]])
    counts = (ends - prev).clamp(min=0)
    if int(counts.sum()) == cap:
        lib = torch.repeat_interleave(vals, counts, output_size=cap)
        if not torch.equal(_as_bits(lib), _as_bits(got)):
            raise AssertionError(f"repeat_interleave != K4 at {label}")
        fns["library_ms"] = lambda: torch.repeat_interleave(
            vals, counts, output_size=cap)
    r["library_ms"] = None
    r.update(turns_ms(fns, iters))
    lib_ms = "n/a (full table)" if r["library_ms"] is None \
        else f"{r['library_ms']:.4f} ms"
    dev_note = ""
    if profiled:
        r["device_ms"] = device_ms(
            lambda: native.rle_decode(vals, ends, cap, nrows), 20)
        dev_note = "; device time " + (
            "not measured (no device events)" if r["device_ms"] is None
            else f"{r['device_ms']:.4f} ms (torch.profiler)")
    log(f"K4 rle_decode {label} {r['dtype']} run_cap={r['run_cap']} "
        f"cap={cap} num_rows={nrows} ({staging}): bit-identical to plain; "
        f"kernel {r['ms']:.4f} ms, repeat_interleave {lib_ms} (medians of "
        f"5 turns), plain and library route (searchsorted + gather) "
        f"{r['plain_ms']:.4f} ms, bound "
        f"{bound_text(r['bound_ms'])} ms (bytes){dev_note}")
    return r


def rle_phase(native) -> dict:
    out = {}
    checked = 0
    for cap in CAPS:
        for name in RLE_POOLS:
            for runs in RLE_RUNS:
                vals, ends, nrows = rle_inputs(cap, name, runs,
                                               seed=cap + len(name))
                timed = cap != CAPS[0] and name in ("int8", "float64") \
                    and runs in (1, "n/4")
                out[(cap, name, runs)] = rle_check(
                    native, vals, ends, cap, nrows, f"runs={runs}", timed,
                    profiled=timed and cap == CAPS[-1] and runs == "n/4")
                checked += 1
    log(f"K4 rle_decode: {checked} tables bit-identical to the plain version "
        f"(caps {CAPS}, six types, runs {RLE_RUNS})")
    out["wire"] = rle_wire_check(native)
    return out


# The wire check's column: the most runs the encoder run-codes (rows/4).
RLE_WIRE_ROWS = 1 << 21
RLE_WIRE_RUN = 4


def rle_wire_check(native) -> dict:
    """A run table far above the JAX package's 4,096-run
    ``rleDecode.maxRuns`` through the wire codec's upload: K4 under its
    live gate, once, and no library route."""
    import torch
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar import wire
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    rng = np.random.default_rng(9)
    runs = RLE_WIRE_ROWS // RLE_WIRE_RUN
    col = np.repeat(rng.integers(-2 ** 62, 2 ** 62, runs, dtype=np.int64),
                    RLE_WIRE_RUN)
    hb = HostBatch(("v",), [HostColumn(dt.INT64, col,
                                       np.ones(col.size, np.bool_))])
    enc = wire.pack_batch(hb, mode="v2")
    spec = next(sp for sp in enc.specs if sp[0] == "rle")
    native.reset_counters()
    got = wire.upload_packed(enc, device="cuda").columns[0].data
    torch.cuda.synchronize()
    launches = native.counters()["rle_decode"]
    library = native.library_counters()["rle_decode"]
    if launches != 1 or library:
        raise AssertionError(f"K4 wire decode of {spec[3]} runs: "
                             f"{launches} launches, {library} library calls")
    if not np.array_equal(got[:col.size].cpu().numpy(), col):
        raise AssertionError("K4 wire decode: the column differs")
    log(f"K4 through the wire codec: {RLE_WIRE_ROWS} int64 rows in runs of "
        f"{RLE_WIRE_RUN} ({runs} runs, run_cap {spec[3]}): 1 launch, 0 "
        f"library calls, the column back bit for bit")
    return dict(runs=runs, run_cap=spec[3], launches=launches)


# ---------------------------------------------------------------------------
# Phase 19: the numeric, date-time and row-source surface
# ---------------------------------------------------------------------------

RANGE_N = 1 << 24               # one batch of 2,097,152 ids a partition
RANGE_PARTITIONS = 8
RANGE_UNION_N = 1 << 25         # each side of range_union
HEAD_ROWS = 1 << 20
# LINEITEM's first lines that (b) and (c) read (of SF1's 5,997,887).
ROWSOURCE_LINES = 1 << 20
ROWSOURCE_WARM_RUNS = 1
TRANSCENDENTAL_ULPS = 4
ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True,
              "spark.rapids.sql.improvedFloatOps.enabled": True}
# The logical nodes the default conf places on the host engine, by run:
# the projection's log / exp / pow and union_dates' float sum. The
# all-device conf places none.
ROWSOURCE_DEFAULT_HOST = {"range": [], "groups": ["LogicalProject"],
                          "head": ["LogicalProject"],
                          "union_dates": ["LogicalAggregate"],
                          "range_union": []}
ROWSOURCE_MUST_LAUNCH = {"range": ("radix_sort", "seg_reduce"),
                         "groups": ("radix_sort", "seg_reduce"),
                         "head": ("radix_sort",),
                         "union_dates": ("radix_sort",),
                         "range_union": ("radix_sort",)}

_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def rand_oracle(seed: int, pid: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """rand(seed) of rows (partition, row index) in numpy uint64: the
    premixed seed plus pid * MIX1 plus idx * GOLDEN through SplitMix64's
    finalizer, top 53 bits scaled into [0, 1)."""
    m64 = (1 << 64) - 1
    x = (seed * _GOLDEN) & m64
    x = ((x ^ (x >> 30)) * _MIX1) & m64
    x = ((x ^ (x >> 27)) * _MIX2) & m64
    premix = x ^ (x >> 31)
    u = np.uint64
    with np.errstate(over="ignore"):
        c = u(premix) + pid.astype(u) * u(_MIX1) + idx.astype(u) * u(_GOLDEN)
        c = (c ^ (c >> u(30))) * u(_MIX1)
        c = (c ^ (c >> u(27))) * u(_MIX2)
        c = c ^ (c >> u(31))
    return (c >> u(11)).astype(np.float64) * 2.0 ** -53


def _by_mod(values: np.ndarray, n: int, groups: int, fill, how):
    """``how`` (np.sum / np.min / np.max) of ``values`` (one per id
    0..n-1) by ``id % groups``: padded to whole rows of ``groups`` with
    ``fill`` and reduced down the columns."""
    m = -(-n // groups) * groups
    padded = np.full(m, fill, dtype=values.dtype)
    padded[:n] = values
    return how(padded.reshape(-1, groups), axis=0)


def range_oracle(n: int, parts: int) -> list:
    """range_query's rows: ids 0..n-1 in ``parts`` contiguous partitions
    of ceil(n / parts) rows; rand(7), the monotonic id (pid << 33) + row
    index, the hour / minute / second of id * 37 seconds, by id % 4096."""
    from spark_rapids_tpu_torch.benchmarks import rowsource as R
    g = R.RANGE_GROUPS
    ids = np.arange(n, dtype=np.int64)
    per = max(-(-n // parts), 1)
    pid = ids // per
    idx = ids - pid * per
    r = rand_oracle(7, pid, idx)
    m = (pid << 33) + idx
    secs = (ids * 37) % 86400
    h, mi, s = secs // 3600, (secs // 60) % 60, secs % 60
    cnt = _by_mod(np.ones(n, np.int64), n, g, 0, np.sum)
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    cols = [cnt, _by_mod(ids, n, g, 0, np.sum),
            _by_mod(r, n, g, np.inf, np.min),
            _by_mod(r, n, g, -np.inf, np.max),
            _by_mod(m, n, g, imax, np.min), _by_mod(m, n, g, imin, np.max),
            _by_mod(h, n, g, 0, np.sum), _by_mod(s, n, g, 0, np.sum),
            _by_mod(pid, n, g, -1, np.max)]
    return [(k,) + tuple(c[k].item() for c in cols)
            for k in range(g) if cnt[k] > 0]


def check_range_rows(rows: list, n: int, parts: int,
                     want: list = None) -> None:
    """range_query's rows bit for bit against ``range_oracle``."""
    check_rows("range", rows, want or range_oracle(n, parts), exact=True)


def _civil(days: np.ndarray):
    """(datetime64[D], year, month, day) of days since the epoch."""
    d = days.astype(np.int64).astype("datetime64[D]")
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    mo = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return d, y, mo, day


def projection_oracle(li: dict, n: int = None) -> dict:
    """lineitem_projection's columns of LINEITEM's first ``n`` rows in
    numpy: the calendar through datetime64, the rest by each function's
    definition (HALF_UP: floor(x*100 + 0.5) / 100 above zero)."""
    sl = slice(0, n)
    ship = li["l_shipdate"][sl].astype(np.int64)
    d, _y, mo, day = _civil(ship)
    month0 = d.astype("datetime64[M]")
    ext = li["l_extendedprice"][sl]
    disc, tax = li["l_discount"][sl], li["l_tax"][sl]
    price = ext * (1 - disc)
    scaled = price * 100.0
    nm = month0 + 1
    in_nm = ((nm + 1).astype("datetime64[D]")
             - nm.astype("datetime64[D]")).astype(np.int64)
    with np.errstate(invalid="ignore"):
        off = np.sqrt(disc - 0.05)
    isnan = np.isnan(off)
    i32 = np.int32
    return {
        "l_orderkey": li["l_orderkey"][sl],
        "datediff": (li["l_receiptdate"][sl].astype(np.int64)
                     - ship).astype(i32),
        "dow": ((ship + 4) % 7 + 1).astype(i32),
        "weekday": ((ship + 3) % 7).astype(i32),
        "doy": ((d - d.astype("datetime64[Y]")).astype(np.int64)
                + 1).astype(i32),
        "quarter": ((mo - 1) // 3 + 1).astype(i32),
        "last_day": ((month0 + 1).astype("datetime64[D]").astype(np.int64)
                     - 1).astype(i32),
        "trunc_mm": month0.astype("datetime64[D]").astype(np.int64)
        .astype(i32),
        "add_months": (nm.astype("datetime64[D]").astype(np.int64)
                       + np.minimum(day, in_nm) - 1).astype(i32),
        "commit_30": (li["l_commitdate"][sl].astype(np.int64)
                      + 30).astype(i32),
        "round2": np.where(scaled >= 0, np.floor(scaled + 0.5),
                           np.ceil(scaled - 0.5)) / 100.0,
        "bround2": np.round(scaled) / 100.0,
        "floor7": np.floor(ext / 7).astype(np.int64),
        "ceil7": np.ceil(ext / 7).astype(np.int64),
        "log_price": np.log(ext),
        "sqrt_price": np.sqrt(ext),
        "exp_tax": np.exp(-tax),
        "disc_sq": np.power(disc, 2.0),
        "least": np.minimum(tax, disc),
        "greatest": np.maximum(tax, disc),
        "abs_qty": np.abs(-li["l_quantity"][sl]),
        "signum": np.sign(disc - 0.05),
        "isnan": isnan,
        "nanvl": np.where(isnan, -1.0, off),
        "nn2": ((tax > 0).astype(np.int64) + (~isnan) + 1) >= 2,
    }


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between float64 arrays."""
    def key(x):
        i = np.asarray(x, np.float64).view(np.int64)
        return np.where(i < 0, np.int64(-2 ** 63) - i, i)
    return np.abs(key(a) - key(b))


def check_projection(hbs: list, li: dict, n: int, want: dict = None
                     ) -> dict:
    """The downloaded head of lineitem_projection (host batches) against
    ``projection_oracle`` (``want``, or computed here): every column but
    the transcendentals bit for bit, each transcendental within
    TRANSCENDENTAL_ULPS of numpy's. Returns each transcendental's largest
    ulp distance."""
    from spark_rapids_tpu_torch.benchmarks import rowsource as R
    if want is None:
        want = projection_oracle(li, n)
    else:
        want = {k: v[:n] for k, v in want.items()}
    rows = sum(hb.num_rows for hb in hbs)
    if rows != len(want["l_orderkey"]):
        raise AssertionError(f"projection head: {rows} rows, oracle "
                             f"{len(want['l_orderkey'])}")
    worst = {}
    for ci, (name, transcendental) in enumerate(R.PROJECTION):
        got = np.concatenate([np.asarray(hb.columns[ci].data)
                              for hb in hbs])
        valid = np.concatenate([np.asarray(hb.columns[ci].validity)
                                for hb in hbs])
        if not valid.all():
            raise AssertionError(f"projection head {name}: NULLs")
        exp = want[name]
        if transcendental or name == "sqrt_price":
            worst[name] = int(ulps(got, exp).max())
            if worst[name] > TRANSCENDENTAL_ULPS:
                raise AssertionError(f"projection head {name}: "
                                     f"{worst[name]} ulp from numpy")
        elif got.dtype != exp.dtype or \
                got.tobytes() != np.ascontiguousarray(exp).tobytes():
            bad = int(np.flatnonzero(got != exp)[0]) if got.shape == \
                exp.shape else 0
            raise AssertionError(f"projection head {name} differs "
                                 f"({got.dtype} vs {exp.dtype}) at row "
                                 f"{bad}: {got[bad]} vs {exp[bad]}")
    return worst


def _segments(key: np.ndarray):
    """(order, starts, ends) of the stable sort of ``key``."""
    order = np.argsort(key, kind="stable")
    sk = key[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    return order, starts, np.r_[starts[1:], len(key)]


def groups_oracle(li: dict, p: dict = None) -> list:
    """lineitem_groups' rows from ``projection_oracle`` (``p``, or computed
    here): by (month, day of week), first / last in scan order (a stable
    sort keeps it)."""
    p = p or projection_oracle(li)
    key = p["trunc_mm"].astype(np.int64) * 8 + p["dow"]
    order, starts, ends = _segments(key)

    def red(name, fn):
        return fn.reduceat(np.asarray(p[name])[order], starts)

    def total(name):
        return np.add.reduceat(np.asarray(p[name]).astype(np.int64)[order],
                               starts)
    cols = [ends - starts, total("datediff"), total("floor7"),
            total("ceil7"), total("weekday"), red("doy", np.minimum),
            red("quarter", np.maximum), red("last_day", np.minimum),
            red("add_months", np.maximum), red("commit_30", np.maximum),
            red("round2", np.minimum), red("bround2", np.maximum),
            red("log_price", np.minimum), red("sqrt_price", np.maximum),
            red("exp_tax", np.minimum), red("disc_sq", np.maximum),
            red("least", np.minimum), red("greatest", np.maximum),
            red("abs_qty", np.maximum), red("signum", np.minimum),
            red("nanvl", np.maximum), total("isnan"), total("nn2"),
            p["l_orderkey"][order[starts]], p["l_orderkey"][order[ends - 1]]]
    lead = order[starts]
    return [(p["trunc_mm"][lead[i]].item(), p["dow"][lead[i]].item())
            + tuple(c[i].item() for c in cols) for i in range(len(starts))]


def check_group_rows(rows: list, li: dict, want: list = None) -> None:
    check_rows("lineitem groups", rows, want or groups_oracle(li))


def union_oracle(li: dict) -> list:
    """union_dates' rows: ship and receipt dates with the quantity, by
    year and quarter."""
    days = np.concatenate([li["l_shipdate"], li["l_receiptdate"]])
    qty = np.concatenate([li["l_quantity"], li["l_quantity"]])
    _d, y, mo, _day = _civil(days)
    key = y * 4 + (mo - 1) // 3
    order, starts, ends = _segments(key)
    sums = np.add.reduceat(qty[order], starts)
    return [(int(key[order[s]] // 4), int(key[order[s]] % 4) + 1,
             int(e - s), float(t)) for s, e, t in zip(starts, ends, sums)]


def check_union_rows(rows: list, li: dict, want: list = None) -> None:
    check_rows("union_dates", rows, want or union_oracle(li))


def range_union_oracle(n: int, parts: int) -> list:
    """range_union's rows: range(0, n) then range(n, 2n), each in
    ``parts`` partitions; rows and id sums by the union's partition."""
    per = max(-(-n // parts), 1)
    out = []
    for side in range(2):
        for p in range(parts):
            lo, hi = min(p * per, n), min((p + 1) * per, n)
            if hi > lo:
                a, b = side * n + lo, side * n + hi - 1
                out.append((side * parts + p, hi - lo,
                            (a + b) * (hi - lo) // 2))
    return out


def check_range_union_rows(rows: list, n: int, parts: int,
                           want: list = None) -> None:
    check_rows("range_union", rows, want or range_union_oracle(n, parts),
               exact=True)


def _warm_batches(phys, check, runs: int) -> tuple:
    """``_warm`` for a run checked on its host batches."""
    import torch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    warm = []
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for _ in range(runs):
        t0 = time.perf_counter()
        hbs = phys.collect_batches(ExecContext(phys.conf))
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        check(hbs, None)
    return warm, torch.cuda.max_memory_allocated(), held


def rowsource_phase(native, cols: dict, known_seen: list,
                    known_k1: set) -> dict:
    """(a) ``range`` (16,777,216 ids in 8 partitions) with rand,
    monotonically_increasing_id, spark_partition_id and the time parts of
    from_unixtime, grouped by id % 4096; (b) LINEITEM's first 1,048,576
    lines at SF1 through the math and date-time projection, grouped by
    month and day of week with first / last, and the projection's rows
    downloaded; (c) their ship and receipt dates as one UNION ALL column
    by year and quarter, and
    range UNION ALL range at 8 + 8 partitions by partition id. Each under
    ``variableFloatAgg`` + ``improvedFloatOps`` (every node on the card)
    and under the default conf, against numpy oracles; for each run host
    nodes and bridges, rows downloaded, the first run with every K1-K4
    launch recorded (new shapes against the plain versions),
    ``ROWSOURCE_WARM_RUNS`` warm walls and the peak device memory of the
    warm runs."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import rowsource as R
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    li = {k: v[:ROWSOURCE_LINES] for k, v in cols["lineitem"].items()}
    proj = projection_oracle(li)
    want = {"range": range_oracle(RANGE_N, RANGE_PARTITIONS),
            "groups": groups_oracle(li, proj),
            "union_dates": union_oracle(li),
            "range_union": range_union_oracle(RANGE_UNION_N,
                                              RANGE_PARTITIONS)}
    log(f"phase 19: oracles in {time.perf_counter() - t_phase:.2f} s")
    checks = {
        "range": lambda rows, w: check_range_rows(rows, RANGE_N,
                                                  RANGE_PARTITIONS, w),
        "groups": lambda rows, w: check_group_rows(rows, li, w),
        "union_dates": lambda rows, w: check_union_rows(rows, li, w),
        "range_union": lambda rows, w: check_range_union_rows(
            rows, RANGE_UNION_N, RANGE_PARTITIONS, w)}
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": [], "runs": [], "ulps": {}}

    def run(label, phys, q, conf_name, collect=None, warm=None):
        hosted = ROWSOURCE_DEFAULT_HOST[q] if conf_name == "default" else []
        check = checks[q]
        r = run_checked(native, label, phys, check, want.get(q), hosted,
                        ROWSOURCE_MUST_LAUNCH[q], known_seen, known_k1,
                        collect=collect)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        walls, peak, held = (warm or _warm)(phys, check, want.get(q),
                                            ROWSOURCE_WARM_RUNS)
        log(f"{label} matches the numpy oracle: first run "
            f"{r['first_s']:.3f} s, warm {[round(w, 4) for w in walls]} s, "
            f"peak device memory in the warm runs {peak / 2**30:.3f} GiB "
            f"({held / 2**30:.3f} GiB held before them); launches "
            f"{r['launches']}")
        out[label] = dict(first_s=r["first_s"], warm_s=walls,
                          launches=r["launches"], moved=r["moved"],
                          hosted=r["hosted"], peak_bytes=peak,
                          held_bytes=held)
        out["runs"].append(r["launches"])
        return r["rows"]

    for conf_name, conf in (("device", ALL_DEVICE), ("default", {})):
        session = TpuSession(conf)
        ldf = R.lineitem(session, cols, rows=ROWSOURCE_LINES)
        run(f"range ({conf_name})", R.range_query(
            L, session, RANGE_N, RANGE_PARTITIONS)._physical(), "range",
            conf_name)
        seen_k1 = []
        with recording_k1(native, seen_k1):
            run(f"lineitem groups ({conf_name})",
                R.lineitem_groups(L, ldf)._physical(), "groups", conf_name)
        if conf_name == "device" and seen_k1:
            # The phase's largest new K1 shape: the groups' fingerprint
            # sort of the whole LINEITEM batch.
            keys, perm = max(seen_k1, key=lambda a: a[0].numel())
            out["k1"] = k1_time(native, keys, perm, "phase 19 largest new")
            del seen_k1
        # The head projects the first HEAD_ROWS lines only.
        head = R.projection_head(L, R.lineitem(session, cols,
                                               rows=HEAD_ROWS),
                                 HEAD_ROWS)._physical()
        worst = {}

        def head_check(hbs, _w, worst=worst):
            worst.update(check_projection(hbs, li, HEAD_ROWS, proj))
        checks["head"] = head_check
        run(f"projection head ({conf_name})", head, "head", conf_name,
            collect=lambda phys, ctx: phys.collect_batches(ctx),
            warm=lambda phys, check, _w, runs: _warm_batches(
                phys, check, runs))
        out["ulps"][conf_name] = dict(worst)
        log(f"projection head ({conf_name}): {HEAD_ROWS} rows, dates, "
            f"integers, round / bround / floor / ceil bit for bit; largest "
            f"ulp distance from numpy {worst}")
        run(f"union_dates ({conf_name})", R.union_dates(L, ldf)._physical(),
            "union_dates", conf_name)
        run(f"range_union ({conf_name})", R.range_union(
            L, session, RANGE_UNION_N, RANGE_PARTITIONS)._physical(),
            "range_union", conf_name)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the string surface and generate
# ---------------------------------------------------------------------------

ETL_HEAD_ROWS = 1 << 18
STRING_WARM_RUNS = 0  # 1 until phase 25 needed the time
# Queries whose warm run was cut for time (etl head: 3-5 s a run); no
# query has one under the default conf, for the script's time budget.
STRING_NO_WARM = ("etl",)
# The logical nodes the default conf places on the host engine, by run:
# orders_etl's case-map and float-format projection and its float-parse
# projection, country_revenue's float sum. The all-device conf places
# none.
STRING_DEFAULT_HOST = {"etl": ["LogicalProject", "LogicalProject"],
                       "revenue": ["LogicalAggregate"]}
STRING_MUST_LAUNCH = {"etl": ("radix_sort",),
                      "groups": ("radix_sort", "seg_reduce")}


def _java_float(f: float) -> bytes:
    """The reference's float -> string format: ``repr`` with a Java-style
    ``E`` exponent (1.0E16) and ``.0`` on an integral mantissa."""
    if f != f:
        return b"NaN"
    if f in (float("inf"), float("-inf")):
        return b"Infinity" if f > 0 else b"-Infinity"
    s = repr(f)
    if "e" in s:
        mant, ex = s.split("e")
        if "." not in mant:
            mant += ".0"
        s = f"{mant}E{int(ex)}"
    elif "." not in s:
        s += ".0"
    return s.encode()


def _initcap(s: str) -> str:
    """ASCII initcap: a letter after a space (or first) upper, the rest
    lower."""
    out, prev = [], " "
    for ch in s:
        out.append(ch.upper() if prev == " " else ch.lower())
        prev = ch
    return "".join(out)


def _ssi(s: str, d: str, c: int) -> str:
    parts = s.split(d)
    if c > 0:
        return d.join(parts[:c]) if len(parts) > c else s
    return d.join(parts[c:]) if len(parts) > -c else s


def _as_matrix(vals: list) -> tuple:
    """A list of bytes (None: NULL) as a zero-padded matrix, lengths and
    validity."""
    n = len(vals)
    valid = np.array([v is not None for v in vals], bool)
    vals = [v or b"" for v in vals]
    lens = np.fromiter(map(len, vals), np.int64, n)
    w = max(int(lens.max()) if n else 1, 1)
    m = np.zeros((n, w), np.uint8)
    total = int(lens.sum())
    if total:
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        m[rows, pos] = np.frombuffer(b"".join(vals), np.uint8)
    return m, lens, valid


def _column_matrix(hc) -> tuple:
    """A downloaded string column as (matrix, lengths, validity)."""
    valid = np.asarray(hc.validity, bool)
    if hc.str_matrix is not None:
        m, lens = np.asarray(hc.str_matrix), np.asarray(hc.str_lengths)
    else:
        m, lens, _ = _as_matrix([bytes(b) for b in hc.data])
    return m, np.where(valid, lens, 0), valid


def _same_strings(name: str, hc, want) -> None:
    """A string column equal, byte for byte, to ``want`` (a list of bytes,
    None for NULL, or its ``_as_matrix``): validity, lengths and every
    byte inside each length."""
    m, lens, valid = _column_matrix(hc)
    em, elens, evalid = _as_matrix(want) if isinstance(want, list) \
        else want
    if len(valid) != len(evalid) or not np.array_equal(valid, evalid):
        raise AssertionError(f"{name}: validity differs from the oracle")
    if not np.array_equal(lens, np.where(evalid, elens, 0)):
        i = int(np.flatnonzero(lens != np.where(evalid, elens, 0))[0])
        raise AssertionError(f"{name}: row {i} length {lens[i]}, oracle "
                             f"{em[i, :elens[i]].tobytes()!r}")
    w = max(m.shape[1], em.shape[1])
    a = np.zeros((len(lens), w), np.uint8)
    b = np.zeros((len(lens), w), np.uint8)
    a[:, :m.shape[1]] = m
    b[:, :em.shape[1]] = em
    inside = np.arange(w)[None, :] < lens[:, None]
    bad = np.flatnonzero(((a != b) & inside).any(axis=1))
    if len(bad):
        i = int(bad[0])
        raise AssertionError(f"{name}: row {i} is "
                             f"{a[i, :lens[i]].tobytes()!r}, oracle "
                             f"{b[i, :lens[i]].tobytes()!r}")


def etl_expected(cols: dict, n: int) -> dict:
    """orders_etl's first ``n`` rows (ORDERS' first orders: the keys ascend)
    column by column, from the generator's pools with Python's ``str``,
    ``hashlib.md5`` and the reference's format and parse rules."""
    import hashlib
    from spark_rapids_tpu_torch import entry as E
    o = cols["orders"]
    code = o["o_comment"][:n]
    pcode = o["o_orderpriority"][:n]
    status = [chr(c) for c in o["o_orderstatus"][:n].tolist()]
    key = o["o_orderkey"][:n]
    pool = list(E.O_COMMENTS)
    prios = list(E.PRIORITIES)

    def per_comment(fn):
        vals = [None if v is None else v.encode() for v in map(fn, pool)]
        return [vals[c] for c in code.tolist()]

    def word(s, i):
        parts = s.split(" ")
        return parts[i] if i < len(parts) else None
    prio = [prios[c] for c in pcode.tolist()]
    comment = [pool[c] for c in code.tolist()]
    dates = np.datetime_as_string(o["o_orderdate"][:n].astype(
        np.int64).astype("datetime64[D]"), unit="D")
    padded = lambda s: "  " + s + "  "                          # noqa: E731
    want = {
        "upper": per_comment(str.upper),
        "lower": [p.lower().encode() for p in prio],
        "initcap": per_comment(_initcap),
        "length": np.array([len(s) for s in comment], np.int32),
        "reverse": per_comment(lambda s: s[::-1]),
        "repeat": [(s * 3).encode() for s in status],
        "trim": per_comment(lambda s: padded(s).strip(" ")),
        "ltrim": per_comment(lambda s: padded(s).lstrip(" ")),
        "rtrim": per_comment(lambda s: padded(s).rstrip(" ")),
        "before2": per_comment(lambda s: _ssi(s, " ", 2)),
        "after1": per_comment(lambda s: _ssi(s, " ", -1)),
        "word1": per_comment(lambda s: word(s, 1)),
        "locate_the": np.array([s.find("the") + 1 for s in comment],
                               np.int32),
        "instr_ly": np.array([s.find("ly") + 1 for s in comment], np.int32),
        "prio_status": [f"{p}|{s}".encode() for p, s in zip(prio, status)],
        "dashed": [("-".join(([st] if k % 7 == 0 else []) + [p, c])).encode()
                   for k, st, p, c in zip(key.tolist(), status, prio,
                                          comment)],
        "md5": per_comment(lambda s: hashlib.md5(s.encode()).hexdigest()),
        "key_s": [str(k).encode() for k in key.tolist()],
        "date_s": [d.encode() for d in dates.tolist()],
        "price_s": [_java_float(f) for f in o["o_totalprice"][:n].tolist()],
        "key_back": key, "date_back": o["o_orderdate"][:n],
        "price_back": o["o_totalprice"][:n]}
    return {k: _as_matrix(v) if isinstance(v, list) else v
            for k, v in want.items()}


def check_etl(hbs: list, cols: dict, n: int, want: dict = None) -> None:
    """orders_etl's first ``n`` rows, byte for byte: every string column,
    the integer columns exact, and each round trip giving back its value
    (the price bit for bit)."""
    from spark_rapids_tpu_torch.benchmarks import stringsource as S
    want = want or etl_expected(cols, n)
    if len(hbs) != 1:
        hbs = [_concat_host(hbs)]
    hb = hbs[0]
    if hb.num_rows != n:
        raise AssertionError(f"etl head: {hb.num_rows} rows, expected {n}")
    for name, hc in zip(S.ETL_COLUMNS, hb.columns):
        if name == "o_orderkey":
            exp = cols["orders"]["o_orderkey"][:n]
        else:
            exp = want[name]
        if hc.dtype.is_string:
            _same_strings(f"etl {name}", hc, exp)
            continue
        got, exp = np.asarray(hc.data), np.asarray(exp)
        if not np.asarray(hc.validity, bool).all() or \
                got.dtype != exp.dtype or got.tobytes() != exp.tobytes():
            raise AssertionError(f"etl {name} differs from the oracle")


def _concat_host(hbs: list):
    from spark_rapids_tpu_torch.columnar.host import concat_host_batches
    return concat_host_batches([hb for hb in hbs if hb.num_rows])


def comment_groups_oracle(cols: dict) -> list:
    """comment_groups over every order: by (first word, priority), the
    count, the longest comment, the least position of 'the', the least
    MD5 and the greatest reversed comment."""
    import hashlib
    from spark_rapids_tpu_torch import entry as E
    o = cols["orders"]
    pool, prios = list(E.O_COMMENTS), list(E.PRIORITIES)
    combo = np.bincount(o["o_comment"].astype(np.int64) * len(prios)
                        + o["o_orderpriority"], minlength=len(pool) *
                        len(prios)).reshape(len(pool), len(prios))
    groups: dict = {}
    for ci, s in enumerate(pool):
        for pi, p in enumerate(prios):
            if combo[ci, pi]:
                g = groups.setdefault((s.split(" ")[0], p), [])
                g.append((int(combo[ci, pi]), s))
    out = []
    for (w0, p), members in sorted(groups.items()):
        texts = [s for _, s in members]
        out.append((w0, p, sum(n for n, _ in members),
                    max(len(s) for s in texts),
                    min(s.find("the") + 1 for s in texts),
                    min(hashlib.md5(s.encode()).hexdigest() for s in texts),
                    max(s[::-1] for s in texts)))
    return out


def revenue_oracle(cols: dict) -> list:
    """country_revenue: each order's customer (the key parsed back from
    its name is the customer key), by the phone's country code: count and
    the sum of the prices."""
    o, c = cols["orders"], cols["customer"]
    names = c["c_name"]
    ck = np.array([int(bytes(r).rstrip(b"\0").split(b"#")[-1])
                   for r in names], np.int64)
    country = [bytes(r).rstrip(b"\0").split(b"-")[0].decode()
               for r in c["c_phone"]]
    codes = {k: i for i, k in enumerate(sorted(set(country)))}
    cust_code = np.full(int(ck.max()) + 1, -1, np.int64)
    cust_code[ck] = [codes[k] for k in country]
    oc = cust_code[o["o_custkey"]]
    hit = oc >= 0
    n = np.bincount(oc[hit], minlength=len(codes))
    rev = np.bincount(oc[hit], weights=o["o_totalprice"][hit],
                      minlength=len(codes))
    return [(k, int(n[i]), float(rev[i])) for k, i in codes.items()
            if n[i]]


def _sorted_by_key(hbs: list):
    hb = _concat_host(hbs)
    order = np.argsort(np.asarray(hb.columns[0].data), kind="stable")
    return hb.take(order)


def customer_expected(cols: dict) -> dict:
    """customer_keys' string columns (by key) from Python's ``re`` and
    ``str`` over the generator's CUSTOMER rows, as ``_as_matrix``."""
    import re
    from spark_rapids_tpu_torch import entry as E
    c = cols["customer"]
    phone = [bytes(r).rstrip(b"\0") for r in c["c_phone"]]
    name = [bytes(r).rstrip(b"\0").decode() for r in c["c_name"]]
    seg = [E.SEGMENTS[i] for i in c["c_mktsegment"].tolist()]
    country = re.compile(r"^(\d+)-")
    want = {
        "phone_digits": [p.replace(b"-", b"") for p in phone],
        "country": [(m.group(1) if m else "").encode() for m in
                    (country.search(p.decode()) for p in phone)],
        "segment": [s.replace("AUTO", "auto").encode() for s in seg],
        "name20": [(s[:20] if len(s) >= 20 else
                    ("*" * 20)[:20 - len(s)] + s).encode() for s in name],
        "name8": [s[:8].encode() for s in name]}
    return {k: _as_matrix(v) for k, v in want.items()}


def check_customer_keys(hbs: list, cols: dict, want: dict = None) -> None:
    """customer_keys, ordered by key, against ``customer_expected``; the
    key parsed back from the name equals the customer key."""
    c = cols["customer"]
    want = want or customer_expected(cols)
    hb = _sorted_by_key(hbs)
    if not np.array_equal(np.asarray(hb.columns[0].data), c["c_custkey"]):
        raise AssertionError("customer_keys: keys differ")
    for i, name in enumerate(("phone_digits", "country", "segment",
                              "name20", "name8"), 1):
        _same_strings(name, hb.columns[i], want[name])
    ck = np.asarray(hb.columns[6].data)
    if not np.asarray(hb.columns[6].validity, bool).all() or \
            not np.array_equal(ck, c["c_custkey"]):
        raise AssertionError("customer_keys: the parsed key differs")


def part_expected(cols: dict) -> dict:
    """part_labels' string columns (by key): ``str.translate`` of the
    vowels and ``ljust`` to 12, as ``_as_matrix``."""
    p = cols["part"]
    vowels = str.maketrans("aeiou", "AEIOU")
    return {"name_uc": _as_matrix([
        bytes(r).rstrip(b"\0").decode().translate(vowels).encode()
        for r in p["p_name"]]), "brand12": _as_matrix([
            bytes(r).rstrip(b"\0").decode().ljust(12, ".")[:12].encode()
            for r in p["p_brand"]])}


def check_part_labels(hbs: list, cols: dict, want: dict = None) -> None:
    """part_labels, ordered by key, against ``part_expected``."""
    want = want or part_expected(cols)
    hb = _sorted_by_key(hbs)
    if not np.array_equal(np.asarray(hb.columns[0].data),
                          cols["part"]["p_partkey"]):
        raise AssertionError("part_labels: keys differ")
    _same_strings("name_uc", hb.columns[1], want["name_uc"])
    _same_strings("brand12", hb.columns[2], want["brand12"])


def positions_oracle(li: dict) -> list:
    """date_positions: (position, year, lines) of the three dates."""
    out = []
    for pos, name in enumerate(("l_shipdate", "l_commitdate",
                                "l_receiptdate")):
        y = _years(li[name])
        ys, n = np.unique(y, return_counts=True)
        out += [(pos, int(a), int(b)) for a, b in zip(ys, n)]
    return out


def _label_counts(pools_and_codes) -> dict:
    counts: dict = {}
    for pool, codes in pools_and_codes:
        n = np.bincount(codes, minlength=len(pool))
        for v, k in zip(pool, n.tolist()):
            if k:
                counts[v] = counts.get(v, 0) + k
    return counts


def labels_oracle(li: dict) -> list:
    """ship_labels: each ship mode and instruction of every line, by
    label."""
    from spark_rapids_tpu_torch import entry as E
    counts = _label_counts([(E.SHIPMODES, li["l_shipmode"]),
                            (E.SHIPINSTRUCT, li["l_shipinstruct"])])
    return sorted(counts.items())


def outer_oracle(li: dict) -> list:
    """outer_labels: the ship mode of lines over 45 units and the
    instruction of lines discounted over 0.09; a line with neither gives
    one NULL row (first in the order)."""
    from spark_rapids_tpu_torch import entry as E
    big = li["l_quantity"] > 45
    disc = li["l_discount"] > 0.09
    counts = _label_counts([(E.SHIPMODES, li["l_shipmode"][big]),
                            (E.SHIPINSTRUCT, li["l_shipinstruct"][disc])])
    return [(None, int((~big & ~disc).sum()))] + sorted(counts.items())


@contextlib.contextmanager
def counting_ops(module, fn_name: str, counts: dict):
    """While the block runs, count the torch ops each call of
    ``module.fn_name`` dispatches (view ops excluded: each counted op is
    at most one kernel launch) into ``counts[fn_name]``, and its calls
    into ``counts[fn_name + ' calls']``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    views = {"view", "_unsafe_view", "slice", "select", "expand",
             "unsqueeze", "permute", "t", "alias", "as_strided",
             "reshape", "squeeze", "detach", "lift_fresh"}
    launch = getattr(module, fn_name)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                counts[fn_name] = counts.get(fn_name, 0) + 1
            return func(*args, **(kwargs or {}))

    def counted(*args, **kwargs):
        counts[fn_name + " calls"] = counts.get(fn_name + " calls", 0) + 1
        with Count():
            return launch(*args, **kwargs)
    setattr(module, fn_name, counted)
    try:
        yield counts
    finally:
        setattr(module, fn_name, launch)


def island_counts(ctx) -> dict:
    """Rows and bytes through each host roundtrip of a run, summed over
    its operators' metrics (``island.<kind>.rows / bytesDown /
    bytesUp``)."""
    out: dict = {}
    for m in ctx.metrics.values():
        for k, v in m.values.items():
            if k.startswith("island."):
                out[k[len("island."):]] = out.get(k[len("island."):], 0) + \
                    int(v)
    return out


def greedy_check(cols: dict, device: str = "cuda") -> dict:
    """substring_index and split with two- and three-byte delimiters over
    ORDERS' first 262,144 comments on the card: the device half (its
    greedy occurrence scan, ``_greedy_matches``, a loop over the width)
    against the host half and Python's ``str``, with the scan's torch ops
    counted."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch import exprs as X
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.batch import (
        DeviceBatch, DeviceColumn)
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    from spark_rapids_tpu_torch.exprs import strings as ST
    n = ETL_HEAD_ROWS
    code = cols["orders"]["o_comment"][:n]
    pool = [s.encode() for s in E.O_COMMENTS]
    m, lens, valid = _as_matrix([pool[c] for c in code.tolist()])
    w = 64
    m = np.pad(m, ((0, 0), (0, w - m.shape[1])))
    dev = torch.device(device)
    batch = DeviceBatch((DeviceColumn(
        dt.STRING, torch.from_numpy(m).to(dev),
        torch.from_numpy(valid).to(dev),
        torch.from_numpy(lens.astype(np.int32)).to(dev)),),
        torch.tensor(n, dtype=torch.int32, device=dev))
    hb = HostBatch(("c",), [HostColumn(dt.STRING, None, valid, str_matrix=m,
                                       str_lengths=lens.astype(np.int32))])
    ref = X.BoundReference(0, dt.STRING)
    cases = {"substring_index(c, 'ly ', 1)": (
        X.SubstringIndex(ref, "ly ", 1), lambda s: _ssi(s, "ly ", 1)),
        "substring_index(c, 'ea', -1)": (
        X.SubstringIndex(ref, "ea", -1), lambda s: _ssi(s, "ea", -1)),
        "split(c, 'es', 1)": (X.StringSplit(ref, "es", 1), lambda s: (
            s.split("es")[1] if len(s.split("es")) > 1 else None))}
    ops: dict = {}
    for name, (e, oracle) in cases.items():
        with counting_ops(ST, "_greedy_matches", ops):
            col = e.eval(batch)
            torch.cuda.synchronize()
        got = HostColumn(dt.STRING, None, col.validity.cpu().numpy()[:n],
                         str_matrix=col.data.cpu().numpy()[:n],
                         str_lengths=col.lengths.cpu().numpy()[:n])
        want = [None if v is None else v.encode() for v in
                (oracle(s.decode()) for s in pool)]
        want = [want[c] for c in code.tolist()]
        _same_strings(f"{name} (device)", got, want)
        _same_strings(f"{name} (host)", e.eval_host(hb), want)
    log(f"greedy occurrence scan on the card: {list(cases)} over {n} "
        f"comments (width {w}) equal the host half and str; torch ops "
        f"{ops}")
    return ops


def string_phase(native, cols: dict, known_seen: list,
                 known_k1: set) -> dict:
    """(a) ORDERS at SF1 through orders_etl (its first 262,144 rows by key
    downloaded and checked byte for byte) and comment_groups; (b)
    CUSTOMER and PART through the host-roundtrip kinds (ordered by key)
    and ORDERS joined to CUSTOMER on the parsed key by country; (c)
    posexplode / explode / explode_outer over LINEITEM, grouped. Each
    under ``stringsource.ALL_DEVICE`` (every node on the card) and under
    the default conf, against oracles in this file; for each run host
    nodes and bridges, rows downloaded, the rows and bytes through each
    host roundtrip, the first run with every K1-K4 launch recorded (new
    shapes against the plain versions) and the torch ops of
    ``_greedy_matches`` and of MD5 counted, ``STRING_WARM_RUNS`` warm
    walls and the peak device memory of the warm runs. The explode
    queries run once, under the all-device conf: the default conf must
    plan them to the same exec tree, with no host node."""
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import stringsource as S
    from spark_rapids_tpu_torch.exprs import hash as H
    from spark_rapids_tpu_torch.exprs import strings as ST
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    li = cols["lineitem"]
    want = {"etl": etl_expected(cols, ETL_HEAD_ROWS),
            "customer": customer_expected(cols), "part": part_expected(cols),
            "groups": comment_groups_oracle(cols),
            "revenue": revenue_oracle(cols),
            "positions": positions_oracle(li),
            "labels": labels_oracle(li), "outer": outer_oracle(li)}
    log(f"phase 20: oracles in {time.perf_counter() - t_phase:.2f} s")
    out_ops = greedy_check(cols)
    checks = {
        "etl": lambda hbs, w: check_etl(hbs, cols, ETL_HEAD_ROWS, w),
        "groups": lambda rows, w: check_rows("groups", rows, w, exact=True),
        "customer": lambda hbs, w: check_customer_keys(hbs, cols, w),
        "part": lambda hbs, w: check_part_labels(hbs, cols, w),
        "revenue": lambda rows, w: check_rows("revenue", rows, w),
        "positions": lambda rows, w: check_rows("positions", rows, w,
                                                exact=True),
        "labels": lambda rows, w: check_rows("labels", rows, w, exact=True),
        "outer": lambda rows, w: check_rows("outer", rows, w, exact=True)}
    batches = {"etl", "customer", "part"}
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": [], "runs": [], "greedy_ops": out_ops}

    def run(label, phys, q, conf_name):
        hosted = STRING_DEFAULT_HOST.get(q, []) \
            if conf_name == "default" else []
        check = checks[q]
        ops: dict = {}
        collect = (lambda p, ctx: p.collect_batches(ctx)) \
            if q in batches else None
        with counting_ops(ST, "_greedy_matches", ops), \
                counting_ops(H, "md5_hex_matrix", ops):
            r = run_checked(native, label, phys, check, want.get(q), hosted,
                            STRING_MUST_LAUNCH.get(q, ("radix_sort",)),
                            known_seen, known_k1, collect=collect)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        islands = island_counts(r["ctx"])
        runs = 0 if q in STRING_NO_WARM or conf_name == "default" \
            else STRING_WARM_RUNS
        if q in batches:
            walls, peak, held = _warm_batches(
                phys, lambda hbs, _w: check(hbs, want.get(q)), runs)
        else:
            walls, peak, held = _warm(phys, check, want.get(q), runs)
        peak_text = (f"peak device memory in the warm run "
                     f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held "
                     f"before it)") if walls else "no warm run (cut for time)"
        log(f"{label} matches the oracle: first run {r['first_s']:.3f} s, "
            f"warm {[round(w, 4) for w in walls]} s, {peak_text}; launches "
            f"{r['launches']}; host roundtrips {islands or 'none'}; torch "
            f"ops of _greedy_matches / MD5 {ops or 'none'}")
        peak = peak if walls else None
        out[label] = dict(first_s=r["first_s"], warm_s=walls,
                          launches=r["launches"], moved=r["moved"],
                          hosted=r["hosted"], peak_bytes=peak,
                          held_bytes=held, islands=islands, ops=ops)
        out["runs"].append(r["launches"])

    for conf_name, conf in (("device", S.ALL_DEVICE), ("default", {})):
        session = TpuSession(conf)
        t = S.tables(session, cols)
        run(f"etl head ({conf_name})", S.etl_head(
            L, t["orders"], ETL_HEAD_ROWS)._physical(), "etl", conf_name)
        run(f"comment groups ({conf_name})", S.comment_groups(
            L, t["orders"])._physical(), "groups", conf_name)
        run(f"customer keys ({conf_name})", S.customer_keys(
            L, t["customer"]).order_by("c_custkey")._physical(), "customer",
            conf_name)
        run(f"part labels ({conf_name})", S.part_labels(
            L, t["part"]).order_by("p_partkey")._physical(), "part",
            conf_name)
        run(f"country revenue ({conf_name})", S.country_revenue(
            L, t["orders"], t["customer"])._physical(), "revenue",
            conf_name)
        explode = {"date positions": ("positions", S.date_positions(
            L, t["lineitem"])._physical()), "ship labels": (
            "labels", S.ship_labels(L, t["lineitem"])._physical()),
            "outer labels": ("outer", S.outer_labels(
                L, t["lineitem"])._physical())}
        if conf_name == "default":
            # The same exec trees as under the all-device conf, all on
            # the card: their runs there stand for both confs.
            for name, (_q, phys) in explode.items():
                if phys.host_fallback_nodes() or \
                        phys.tree() != trees[name]:
                    raise AssertionError(
                        f"{name} (default) plans otherwise than under the "
                        f"all-device conf: {phys.host_fallback_nodes()}\n"
                        f"{phys.tree()}")
            log(f"{sorted(explode)} (default): the all-device conf's exec "
                "trees, no host node; not run again")
            continue
        trees = {name: phys.tree() for name, (_q, phys) in explode.items()}
        seen_k1: list = []
        with recording_k1(native, seen_k1):
            run(f"date positions ({conf_name})",
                explode["date positions"][1], "positions", conf_name)
        if seen_k1:
            # The phase's largest K1 launch: a generate's output batch
            # (3 x 786,432 slots) sorted by its group fingerprint.
            keys, perm = max(seen_k1, key=lambda a: a[0].numel())
            out["k1"] = k1_time(native, keys, perm, "phase 20 largest")
        del seen_k1
        for name in ("ship labels", "outer labels"):
            run(f"{name} ({conf_name})", explode[name][1], explode[name][0],
                conf_name)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 20 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the UDF tier (compiled UDFs, the Python-UDF fallback, pandas)
# ---------------------------------------------------------------------------

UDF_WARM_RUNS = 0     # 1 until phase 25 needed the time
# The kernels each run of phase 21 must launch.
UDF_MUST_LAUNCH = {"q1": ("radix_sort",), "q1_udf": ("radix_sort",),
                   "ranks": ("radix_sort", "seg_reduce"),
                   "pandas_map": (), "pandas_apply": ("radix_sort",),
                   "pandas_agg": ("radix_sort",),
                   "pandas_cogroup": ("radix_sort",)}
UDF_ALL_DEVICE = {"spark.rapids.sql.variableFloatAgg.enabled": True}
UDF_PARTITIONS = 8


def q1_band_oracle(li: dict, cutoff: int) -> list:
    """q1's oracle rows with ``sum_band`` (lines of more than 25 units)
    appended to each group."""
    keep = li["l_shipdate"] <= cutoff
    key = li["l_returnflag"][keep].astype(np.int64) * 256 + \
        li["l_linestatus"][keep].astype(np.int64)
    big = li["l_quantity"][keep] > 25.0
    uniq, inv = np.unique(key, return_inverse=True)
    band = np.bincount(inv, weights=big).astype(np.int64)
    rows = q1_oracle(li, cutoff)
    if [(r[0], r[1]) for r in rows] != [
            (chr(k // 256), chr(k % 256)) for k in uniq.tolist()]:
        raise AssertionError("q1 band oracle: groups differ from q1's")
    return [r + (int(b),) for r, b in zip(rows, band.tolist())]


def check_q1_band(rows: list, want: list) -> None:
    check_q1([r[:-1] for r in rows], [w[:-1] for w in want])
    got = [(r[0], r[1], r[-1]) for r in rows]
    exp = [(w[0], w[1], w[-1]) for w in want]
    if got != exp:
        raise AssertionError(f"q1_udf sum_band differs: {got} vs {exp}")


def ranks_oracle(cols: dict, U, E) -> list:
    """(b)'s rows in Python and numpy: per priority rank of the orders
    before the cutoff, count, revenue, largest price, vowels."""
    o = cols["orders"]
    keep = o["o_orderdate"] < U.RANK_CUTOFF
    rank = np.array([U.PRIORITY_RANK[p] for p in E.PRIORITIES])[
        o["o_orderpriority"][keep]]
    vowels = np.array([U.vowels(c) for c in E.O_COMMENTS])[
        o["o_comment"][keep]]
    price = o["o_totalprice"][keep]
    return [(int(r), int((rank == r).sum()), float(price[rank == r].sum()),
             float(price[rank == r].max()), int(vowels[rank == r].sum()))
            for r in np.unique(rank).tolist()]


def check_ranks(rows: list, want: list) -> None:
    """Ranks, counts, the largest price and the vowels exact; revenue to
    rtol 1e-9."""
    exact = [(r[0], r[1], r[3], r[4]) for r in rows]
    if exact != [(w[0], w[1], w[3], w[4]) for w in want]:
        raise AssertionError(f"ranks differ: {rows} vs {want}")
    check_rows("ranks revenue", [(r[2],) for r in rows],
               [(w[2],) for w in want])


def pandas_oracles(cols: dict, U, E) -> dict:
    """(c)'s rows: each order's key and price in thousands (arrays); sorted,
    per priority
    the count, largest and smallest price; per status the count, least
    and largest price; per priority of either side of the cogroup the
    count and the count times its weight."""
    o = cols["orders"]
    price = o["o_totalprice"]
    prio = o["o_orderpriority"]
    status = o["o_orderstatus"]
    out = {"pandas_map": (o["o_orderkey"], price / 1000.0)}
    out["pandas_apply"] = sorted(
        (p, int((prio == i).sum()), float(price[prio == i].max()),
         float(price[prio == i].min()))
        for i, p in enumerate(E.PRIORITIES) if (prio == i).any())
    out["pandas_agg"] = sorted(
        (chr(s), int((status == s).sum()), float(price[status == s].min()),
         float(price[status == s].max())) for s in np.unique(status).tolist())
    weight = dict(zip(U.WEIGHTS["w_priority"], U.WEIGHTS["w"]))
    counts = {p: int((prio == i).sum()) for i, p in enumerate(E.PRIORITIES)}
    out["pandas_cogroup"] = sorted(
        (p, counts.get(p, 0), weight.get(p, 0.0) * counts.get(p, 0))
        for p in set(counts) | set(weight))
    return out


def check_price_k(rows: list, want: tuple) -> None:
    """(c)'s map: one row an order, its price in thousands exact, in any
    order."""
    keys, price_k = want
    got = np.array([r[0] for r in rows], np.int64)
    order = np.argsort(got, kind="stable")
    exp = np.argsort(keys, kind="stable")
    vals = np.array([r[1] for r in rows], np.float64)
    if not (np.array_equal(got[order], keys[exp]) and
            np.array_equal(vals[order], price_k[exp])):
        raise AssertionError("pandas_map: rows differ from the oracle")


def pyudf_device_check(U, udf, device) -> dict:
    """``PythonUDF`` on a batch on the card with a selection vector: the
    column comes back on the batch's device, NULL under the rows the
    selection drops, the rank of each kept row's priority."""
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch import exprs as X
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    from spark_rapids_tpu_torch.columnar.host import (
        HostBatch, host_to_device)
    n = 4096
    prios = [E.PRIORITIES[i % 5] for i in range(n)]
    hb = HostBatch.from_pydict([("p", dt.STRING)], {"p": prios})
    batch = host_to_device(hb, device=device)
    keep = torch.arange(batch.capacity, device=batch.device) % 3 != 0
    batch = batch.with_sel(keep)
    rank = U.rank_udfs(udf)["rank"]
    e = X.PythonUDF(rank.func, dt.INT32, [X.BoundReference(0, dt.STRING)])
    col = e.eval(batch)
    if col.data.device != batch.device or \
            col.validity.device != batch.device:
        raise AssertionError(f"PythonUDF returned a column on "
                             f"{col.data.device}, the batch is on "
                             f"{batch.device}")
    live = (np.arange(batch.capacity) < n) & \
        (np.arange(batch.capacity) % 3 != 0)
    valid = col.validity.cpu().numpy()
    data = col.data.cpu().numpy()
    want = np.array([U.PRIORITY_RANK[p] for p in prios])
    if not np.array_equal(valid, live) or not np.array_equal(
            data[:n][live[:n]], want[live[:n]]):
        raise AssertionError("PythonUDF on the card: wrong rows")
    log(f"PythonUDF on a {batch.device} batch of {n} rows (capacity "
        f"{batch.capacity}, selection vector): result on {col.data.device}, "
        f"{int(live.sum())} ranks, NULL under the dropped rows")
    return dict(device=str(col.data.device), rows=int(live.sum()))


def udf_phase(native, cols: dict, known_seen: list, known_k1: set) -> dict:
    """(a) TPC-H q1 through ``udfsource.q1_udf`` (its filter and derived
    columns compiled UDFs, plus a quantity band) beside q1's text under
    the all-device conf, and once under the default conf; (b) ORDERS
    before 1995-04-17 through two Python UDFs that do not compile (a dict
    lookup, a loop), grouped by the rank, under the all-device conf; (c)
    the four pandas execs at 8 partitions where pandas is installed. Each
    run against oracles in this file, its first run with every K1-K4
    launch recorded (new shapes against the plain versions), the host
    roundtrips' rows and bytes, warm walls and peak device memory."""
    import importlib.util
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import DataFrame, TpuSession
    from spark_rapids_tpu_torch.benchmarks import stringsource as S
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.benchmarks import udfsource as U
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.udf import udf
    t_phase = time.perf_counter()
    li = cols["lineitem"]
    want = {"q1": q1_oracle(li, U.Q1_CUTOFF),
            "q1_udf": q1_band_oracle(li, U.Q1_CUTOFF),
            "ranks": ranks_oracle(cols, U, E)}
    filtered = int((cols["orders"]["o_orderdate"] < U.RANK_CUTOFF).sum())
    log(f"phase 21: oracles in {time.perf_counter() - t_phase:.2f} s "
        f"({filtered} orders before the rank cutoff)")
    checks = {"q1": check_q1, "q1_udf": check_q1_band, "ranks": check_ranks}
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    out = {"kernel_checks": [], "runs": []}

    def run(label, phys, q, hosted=(), warm=UDF_WARM_RUNS):
        r = run_checked(native, label, phys, checks[q], want[q], list(hosted),
                        UDF_MUST_LAUNCH[q], known_seen, known_k1)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        islands = island_counts(r["ctx"])
        walls, peak, held = _warm(phys, checks[q], want[q], warm) \
            if warm else ([], 0, 0)
        warm_text = (f"warm {[round(w, 4) for w in walls]} s, peak device "
                     f"memory in the warm runs {peak / 2**30:.3f} GiB "
                     f"({held / 2**30:.3f} GiB held before them)") \
            if warm else "no warm run"
        log(f"{label} matches the oracle: first run {r['first_s']:.3f} s, "
            f"{warm_text}; launches {r['launches']}; host roundtrips "
            f"{islands or 'none'}")
        out[label] = dict(first_s=r["first_s"], warm_s=walls,
                          launches=r["launches"], hosted=r["hosted"],
                          peak_bytes=peak, held_bytes=held, islands=islands,
                          rows=r["rows"])
        out["runs"].append(r["launches"])
        return out[label]

    # (a) q1 written with compiled UDFs, beside q1's text.
    compiled = {k: u.compiled for k, u in U.q1_udfs(udf).items()}
    if not all(compiled.values()):
        raise AssertionError(f"q1's UDFs did not all compile: {compiled}")
    plans = {}
    for conf_name, conf in (("vfa", UDF_ALL_DEVICE), ("default", {})):
        session = TpuSession(conf)
        t = tpch.tpch_tables(session, cols, ("q1",))["q1"]
        plans[conf_name] = (tpch.q1(session, t)._physical(),
                            U.q1_udf(L, udf, t["lineitem"])._physical())
        text_hosted = plans[conf_name][0].host_fallback_nodes()
        if plans[conf_name][1].host_fallback_nodes() != text_hosted:
            raise AssertionError(
                f"q1_udf ({conf_name}) placed "
                f"{plans[conf_name][1].host_fallback_nodes()} on the host, "
                f"q1's text {text_hosted}")
        report = plans[conf_name][1].explain()
        if "roundtrip" in report:
            raise AssertionError(f"q1_udf ({conf_name}) has a host "
                                 f"roundtrip: {report}")
    log(f"q1_udf: UDFs compiled {compiled}; host nodes as q1's text "
        f"(vfa {plans['vfa'][0].host_fallback_nodes()}, default "
        f"{plans['default'][0].host_fallback_nodes()}); no roundtrip")
    text = run("q1 text (vfa)", plans["vfa"][0], "q1")
    with_udf = run("q1_udf (vfa)", plans["vfa"][1], "q1_udf")
    if not rows_close([r[:-1] for r in with_udf["rows"]], text["rows"]):
        raise AssertionError("q1_udf's rows differ from q1's text")
    same = [r[:-1] for r in with_udf["rows"]] == text["rows"]
    if with_udf["launches"]["radix_sort"] != text["launches"]["radix_sort"]:
        raise AssertionError(f"q1_udf launched K1 "
                             f"{with_udf['launches']['radix_sort']} times, "
                             f"q1's text {text['launches']['radix_sort']}")
    for label in ("q1 text (vfa)", "q1_udf (vfa)"):
        if out[label]["islands"]:
            raise AssertionError(f"{label}: host roundtrips "
                                 f"{out[label]['islands']}")
    how = "bit for bit" if same else "floats within rtol 1e-9"
    log(f"q1_udf rows equal q1's text ({how}); K1 "
        f"{text['launches']['radix_sort']} launches in both")
    run("q1_udf (default)", plans["default"][1], "q1_udf",
        hosted=plans["default"][0].host_fallback_nodes(), warm=0)
    out["q1_bit_identical"] = same

    # (b) two Python UDFs that do not compile, after a filter.
    u = U.rank_udfs(udf)
    errors = {k: v.compile_error for k, v in u.items()}
    if any(v.compiled for v in u.values()):
        raise AssertionError(f"(b)'s UDFs compiled: {errors}")
    out["pyudf_device"] = pyudf_device_check(U, udf, TpuSession(
        UDF_ALL_DEVICE).device)
    phys_by_conf = {}
    for conf_name, conf in (("vfa", UDF_ALL_DEVICE), ("default", {})):
        session = TpuSession(conf)
        orders = DataFrame(session, L.InMemoryScan(
            S.ORDERS, E.table_partitions(
                {n: cols["orders"][n] for n, _ in S.ORDERS}, S.ORDERS,
                E.TABLE_PARTITIONS["orders"])))
        phys_by_conf[conf_name] = U.order_ranks(L, udf, orders)._physical()
    report = phys_by_conf["vfa"].explain()
    for name, key in (("<lambda>", "rank"), ("vowels", "vowels")):
        note = (f"python UDF {name!r} could not be compiled to native "
                f"expressions ({errors[key]})")
        if note not in report:
            raise AssertionError(f"explain lacks {note!r}: {report}")
    log(f"order ranks: compile errors {errors} in explain; default conf "
        f"host nodes {phys_by_conf['default'].host_fallback_nodes()}")
    ranks = run("order ranks (vfa)", phys_by_conf["vfa"], "ranks")
    calls = len(u) * filtered
    if ranks["islands"].get("pyudf.rows") != calls:
        raise AssertionError(f"island.pyudf.rows "
                             f"{ranks['islands'].get('pyudf.rows')}, "
                             f"expected {calls}")
    log(f"order ranks: {calls} Python UDF calls a run ({filtered} rows x "
        f"{len(u)} UDFs); K1 {ranks['launches']['radix_sort']}, K2 "
        f"{ranks['launches']['seg_reduce']} launches")

    # (c) the pandas execs, where pandas is installed.
    if importlib.util.find_spec("pandas") is None:
        log("pandas is absent on this machine: map_in_pandas, "
            "apply_in_pandas, agg_in_pandas and cogroup were not run on "
            "the card")
        out["pandas"] = "absent"
    else:
        import pandas
        log(f"pandas {pandas.__version__} is installed: the four pandas "
            f"execs run at {UDF_PARTITIONS} partitions")
        want.update(pandas_oracles(cols, U, E))
        session = TpuSession(dict(UDF_ALL_DEVICE, **{
            "spark.rapids.sql.shuffle.partitions": UDF_PARTITIONS}))
        narrow = tuple((n, t) for n, t in S.ORDERS if n in (
            "o_orderkey", "o_totalprice", "o_orderstatus", "o_orderpriority"))
        orders = DataFrame(session, L.InMemoryScan(
            narrow, E.table_partitions(
                {n: cols["orders"][n] for n, _ in narrow}, narrow,
                E.TABLE_PARTITIONS["orders"])))
        flavors = {"pandas_map": U.pandas_map(L, orders),
                   "pandas_apply": U.pandas_apply(L, orders),
                   "pandas_agg": U.pandas_agg(L, orders),
                   "pandas_cogroup": U.pandas_cogroup(
                       L, orders, U.weights(session, L))}
        checks["pandas_map"] = check_price_k
        for q in ("pandas_apply", "pandas_agg", "pandas_cogroup"):
            checks[q] = (lambda name: lambda rows, w: check_rows(
                name, rows, w, multiset=True, exact=True))(q)
        for q, df in flavors.items():
            run(f"{q} ({UDF_PARTITIONS} partitions)", df._physical(), q,
                warm=0)
        out["pandas"] = "ran"
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 21 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 22: file I/O (the writer, parquet / ORC / CSV scans, pushdown, the
# scan cache, the partition pipeline, input_file_name, plan-text ingest)
# ---------------------------------------------------------------------------

FILE_QUERIES = ("q1", "q3", "q4", "q6")
FILE_MUST_LAUNCH = {"q1": ("radix_sort",), "q3": ("radix_sort",),
                    "q4": ("radix_sort", "join_probe"), "q6": ()}
# Cost placement off: this phase asserts K1-K4 launches and device
# execution of parquet queries, which the card's cost model may put on the
# host engine (phase 27 checks placement over the same kind of files).
FILE_VFA = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.rapids.sql.cost.enabled": False}
READER_TYPES = ("PERFILE", "MULTITHREADED", "COALESCING")
SMALL_ORDERS = 200_000
_NO_SCAN_CACHE = {"spark.rapids.sql.format.scanCache.maxBytes": 0}


def file_schemas(tpch, cols: dict) -> dict:
    """table -> the schema phase 22 writes: every column q1, q3, q4 and
    q6 read of it, in the generator's order."""
    types = {}
    for q in FILE_QUERIES:
        for t, schema in tpch.SCANS[q].items():
            types.setdefault(t, {}).update(schema)
    return {t: tuple((n, have[n]) for n in cols[t] if n in have)
            for t, have in types.items()}


def scan_metrics(ctx) -> dict:
    """The file scans' metrics of one query, summed over its scans."""
    out = {}
    for key, m in ctx.metrics.items():
        if key.startswith("FileScanExec["):
            for k, v in m.values.items():
                out[k] = out.get(k, 0) + v
    return out


def pipeline_metrics(ctx) -> dict:
    m = ctx.metrics.get("Pipeline@query")
    return {} if m is None else {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in sorted(m.values.items())}


def scan_text(sm: dict) -> str:
    return (f"bufferTime {sm.get('bufferTime', 0) / 1e6:.2f} ms, decodeTime "
            f"{sm.get('decodeTime', 0) / 1e6:.2f} ms, numOutputRows "
            f"{int(sm.get('numOutputRows', 0))}, numOutputBatches "
            f"{int(sm.get('numOutputBatches', 0))}, numSkippedRowGroups "
            f"{int(sm.get('numSkippedRowGroups', 0))}, scanCacheHits "
            f"{int(sm.get('scanCacheHits', 0))}")


def _files(path: str, suffix: str) -> list:
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(suffix))


def file_phase(native, cols: dict, df_out: dict, known_seen: list,
               known_k1: set) -> dict:
    """(a) the SF1 tables q1, q3, q4 and q6 read, written to parquet by
    ``DataFrame.write.parquet`` from in-memory scans on the card; (b)
    q1, q3, q4 and q6 through ``benchmarks/tpch.py`` ``qN(session,
    data_dir)``, the reference's text reading the files: a first run
    (every K1-K4 launch recorded, new shapes against the plain versions,
    the scan's and the pipeline's counters) and a warm run that must hit
    the scan cache, each against phase 11's oracles; (c) q6 under each
    reader type and with the pipeline off, and a pushed predicate that
    must skip 7 of LINEITEM's 8 row groups; (d) input_file_name() over
    LINEITEM; (e) an ORC and a CSV round trip of ORDERS' four columns,
    with one ORC stripe skipped; (f) the captured Spark plans of q6 and
    q3 ingested against the written files; (g) q18 under a capped
    allocator with the scan cache full: the OOM ladder must drop the
    cache first. pyarrow is required."""
    import shutil
    import tempfile
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import DataFrame, TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.columnar import wire
    from spark_rapids_tpu_torch.io.scan import DEVICE_SCAN_CACHE
    from spark_rapids_tpu_torch.memory import oom
    from spark_rapids_tpu_torch.ops.base import ExecContext
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    try:
        import pyarrow
        import pyarrow.parquet as papq
    except ImportError as e:
        raise AssertionError(f"phase 22 needs pyarrow: {e}")
    try:
        import pandas
        pandas_version = pandas.__version__
    except ImportError:
        pandas_version = "absent"
    log(f"phase 22: pyarrow {pyarrow.__version__}, pandas {pandas_version}")
    known_seen = list(known_seen)
    known_k1 = set(known_k1)
    oracles = df_out["oracles"]
    root = tempfile.mkdtemp(prefix="srt_phase22_")
    # The written files stay for phase 23 (d), which deletes ``root``.
    out = {"kernel_checks": [], "runs": [], "root": root}

    def run(label, phys, check, want, must=()):
        wire.reset_counters()
        r = run_checked(native, label, phys, check, want, [], must,
                        known_seen, known_k1)
        known_seen.append(r["seen"])
        known_k1.update(c["shape"] for c in r["checks"]
                        if c["kernel"] == "radix_sort")
        out["kernel_checks"] += r["checks"]
        out["runs"].append(r["launches"])
        r["codec"] = wire.counters()
        r["scan"] = scan_metrics(r["ctx"])
        return r

    done = False
    try:
        # (a) write the tables from in-memory scans on the card.
        session = TpuSession(FILE_VFA)
        schemas = file_schemas(tpch, cols)
        data_dir = os.path.join(root, "tpch")
        out["data_dir"] = data_dir
        out["write"] = {}
        for t, schema in schemas.items():
            df = DataFrame(session, L.InMemoryScan(schema, E.table_partitions(
                cols[t], schema, E.TABLE_PARTITIONS[t])))
            writer = df.write
            t0 = time.perf_counter()
            stats = writer.parquet(os.path.join(data_dir, t))
            wall = time.perf_counter() - t0
            groups = [papq.ParquetFile(p).metadata.num_row_groups
                      for p in tpch._paths(data_dir, t)]
            log(f"phase 22 write {t} ({len(schema)} columns): last_stats "
                f"{stats}; {wall:.3f} s; row groups a file {groups}")
            if stats["numOutputRows"] != len(cols[t][schema[0][0]]):
                raise AssertionError(f"{t}: wrote {stats} rows")
            out["write"][t] = dict(stats=stats, wall_s=wall)

        # (b) q1, q3, q4 and q6 from the files.
        for q in FILE_QUERIES:
            check, want = oracles[q]
            t0 = time.perf_counter()
            phys = tpch.QUERIES[q](session, data_dir)._physical()
            plan_ms = (time.perf_counter() - t0) * 1e3
            log(f"{q} from parquet: plan ({plan_ms:.2f} ms host):")
            for line in phys.tree().splitlines():
                log(f"  {line}")
            notes = [line.strip() for line in phys.explain().splitlines()
                     if "join strategy" in line]
            log(f"  join strategies over the files: {notes or 'none'}; "
                f"phase 11 in memory: {df_out[q]['notes'] or 'none'}")
            r = run(f"{q} from parquet", phys, check, want,
                    FILE_MUST_LAUNCH[q])
            rle_cols = int(r["codec"].get("codecCols.rle", 0))
            log(f"{q} from parquet matches the oracle ({len(r['rows'])} "
                f"rows): first run {r['first_s']:.3f} s (phase 11 in "
                f"memory {df_out[q]['first_s']:.3f} s); launches "
                f"{r['launches']}; K4 {r['launches']['rle_decode']} "
                f"launch(es), {rle_cols} column(s) shipped as runs; scan "
                f"{scan_text(r['scan'])}; pipeline "
                f"{pipeline_metrics(r['ctx'])}")
            if q == "q3" and not r["launches"]["rle_decode"]:
                shipped = {k: v for k, v in r["codec"].items()
                           if k.startswith("codecCols.")}
                log(f"q3 from parquet launched no K4: codec columns "
                    f"{shipped}")
            ctx = ExecContext(phys.conf)
            t0 = time.perf_counter()
            rows = phys.collect(ctx)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            check(rows, want)
            sm = scan_metrics(ctx)
            if not sm.get("scanCacheHits", 0):
                raise AssertionError(f"{q}: the warm run hit no scan cache "
                                     f"entry: {sm}")
            log(f"{q} from parquet warm run {warm_s:.4f} s (phase 11 in "
                f"memory warm {[round(w, 4) for w in df_out[q]['warm_s']]}"
                f" s); scan {scan_text(sm)}")
            out[q] = dict(first_s=r["first_s"], warm_s=warm_s,
                          launches=r["launches"], rows=r["rows"],
                          scan=r["scan"], pipeline=pipeline_metrics(
                              r["ctx"]), cache_hits=sm["scanCacheHits"])

        # (c) q6 under each reader type and with the pipeline off (the
        # scan cache off, so each reader reads), then a pushed predicate.
        check, want = oracles["q6"]
        for label, conf in [(rt, {
                "spark.rapids.sql.format.parquet.reader.type": rt})
                for rt in READER_TYPES] + [("pipeline off", {
                    "spark.rapids.sql.pipeline.enabled": False})]:
            s = TpuSession(dict(FILE_VFA, **_NO_SCAN_CACHE, **conf))
            r = run(f"q6 from parquet ({label})",
                    tpch.q6(s, data_dir)._physical(), check, want)
            same = "bit for bit" if r["rows"] == out["q6"]["rows"] else \
                "within rtol 1e-9"
            if not rows_close(r["rows"], out["q6"]["rows"]):
                raise AssertionError(f"q6 ({label}) rows differ: "
                                     f"{r['rows']} vs {out['q6']['rows']}")
            log(f"q6 ({label}): rows equal (b)'s {same}; {r['first_s']:.3f}"
                f" s; scan {scan_text(r['scan'])}; pipeline "
                f"{pipeline_metrics(r['ctx']) or 'none (serial)'}")
        keys = cols["lineitem"]["l_orderkey"]
        per = -(-len(keys) // E.TABLE_PARTITIONS["lineitem"])
        first = keys[:per]
        bound = int(first[first < keys[per]].max())
        li_paths = tpch._paths(data_dir, "lineitem")
        pushed = session.read.parquet(*li_paths).filter(
            L.col("l_orderkey") <= L.lit_col(bound)).agg(
            L.agg_count().alias("n"))
        phys = pushed._physical()
        count_want = [(int((keys <= bound).sum()),)]
        r = run("pushdown over LINEITEM", phys,
                lambda rows, w: check_rows("pushdown", rows, w), count_want)
        skipped = int(r["scan"].get("numSkippedRowGroups", 0))
        log(f"pushdown l_orderkey <= {bound} (the first file's largest key "
            f"below the second's smallest): {r['rows'][0][0]} rows as the "
            f"oracle; {skipped} of {len(li_paths)} row groups skipped; "
            f"scan {scan_text(r['scan'])}")
        if skipped < 7:
            raise AssertionError(f"pushdown skipped {skipped} row groups")
        out["skipped"] = skipped

        # (d) input_file_name() over LINEITEM: rows per path.
        per_file = session.read.parquet(*li_paths).select(
            L.input_file_name().alias("file"), L.col("l_orderkey")) \
            .group_by("file").agg(L.agg_count().alias("n"))
        file_want = sorted((p, papq.ParquetFile(p).metadata.num_rows)
                           for p in li_paths)
        r = run("input_file_name over LINEITEM", per_file._physical(),
                lambda rows, w: check_rows("input_file_name", sorted(rows),
                                           w), file_want)
        log(f"input_file_name: rows per path equal each file's parquet row "
            f"count ({[n for _, n in file_want]}); {r['first_s']:.3f} s")

        # (e) ORC and CSV round trips of ORDERS' four columns.
        o = cols["orders"]
        four = E.Q3_ORDERS
        sub = {n: o[n][:SMALL_ORDERS] for n, _ in four}
        small = DataFrame(session, L.InMemoryScan(four, E.table_partitions(
            sub, four, 2)))
        rows_want = [tuple(int(v) for v in row)
                     for row in zip(*(sub[n] for n, _ in four))]
        for fmt in ("orc", "csv"):
            path = os.path.join(root, f"orders_{fmt}")
            stats = getattr(small.write, fmt)(path)
            paths = _files(path, "." + fmt)
            reader = getattr(session.read, fmt)
            r = run(f"{fmt} round trip", reader(*paths)._physical(),
                    lambda rows, w: check_rows(
                        "round trip", [tuple(int(v) for v in row)
                                       for row in rows], w), rows_want)
            log(f"{fmt} round trip of {SMALL_ORDERS} orders, four columns: "
                f"last_stats {stats}; rows equal; read {r['first_s']:.3f} s")
            if fmt == "orc":
                last = int(sub["o_orderkey"][-(-SMALL_ORDERS // 2) - 1])
                r = run("orc pushdown", reader(*paths).filter(
                    L.col("o_orderkey") <= L.lit_col(last)).agg(
                    L.agg_count().alias("n"))._physical(),
                    lambda rows, w: check_rows("orc pushdown", rows, w),
                    [(int((sub["o_orderkey"] <= last).sum()),)])
                skipped = int(r["scan"].get("numSkippedRowGroups", 0))
                log(f"orc pushdown o_orderkey <= {last}: {skipped} stripe(s) "
                    f"of {len(paths)} skipped")
                if skipped != 1:
                    raise AssertionError(f"orc pushdown skipped {skipped}")

        # (f) plan-text ingest against the written files.
        tables = {t: tpch._paths(data_dir, t)
                  for t in ("lineitem", "orders", "customer")}
        fixtures = os.path.join(HERE, "tests", "fixtures", "spark_plans")
        for q in ("q6", "q3"):
            with open(os.path.join(fixtures, f"{q}.txt")) as f:
                text = f.read()
            df = session.ingest_spark_plan(text, tables)
            check, want = oracles[q]
            r = run(f"ingested {q}", df._physical(), check, want)
            if not rows_close(r["rows"], out[q]["rows"]):
                raise AssertionError(f"ingested {q} differs from the query "
                                     f"text's rows")
            same = "bit for bit" if r["rows"] == out[q]["rows"] else \
                "within rtol 1e-9"
            log(f"ingested {q}: rows equal the query text's ({same}); "
                f"{r['first_s']:.3f} s; launches {r['launches']}")

        # (g) a real OOM with the scan cache full: the ladder's first rung
        # drops it, as the spill catalog does not hold it.
        cached = DEVICE_SCAN_CACHE.nbytes
        if not cached:
            raise AssertionError("(g) the scan cache holds nothing")
        s18 = TpuSession(dict(FILE_VFA, **{
            "spark.rapids.sql.shuffle.partitions": 1}))
        q18 = tpch.QUERIES["q18"](s18, tpch.tpch_tables(
            s18, cols, ("q18",))["q18"])._physical()
        g = real_oom(q18, lambda rows, w: check_rows("q18", rows, w),
                     memo_oracle("q18", cols, lambda: q18_oracle(cols, E)),
                     "(g)")
        if g["ladder"][0] != oom.RUNG_DROP_SCAN_CACHE or \
                DEVICE_SCAN_CACHE.nbytes:
            raise AssertionError(f"(g) ladder {g['ladder']}; the scan cache "
                                 f"holds {DEVICE_SCAN_CACHE.nbytes} B")
        log(f"(g) q18 with {cached} B in the scan cache: a real OOM under "
            f"the cap, ladder {g['ladder']}, the cache emptied, rows match")
        out["oom"] = dict(g, cached_bytes=cached)
        out["runs"].append(g["launches"])
        done = True
    finally:
        DEVICE_SCAN_CACHE.clear()
        if not done:
            shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 22 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 23: the native gates, the plan cache with bind slots, stage fusion
# ---------------------------------------------------------------------------

GATE_QUERIES = ("q1", "q2", "q3", "q4")
# The kernel each gate-query launches that the others' runs may not.
OWN_GATE = {"q1": "radixSort", "q2": "segmentReduce", "q3": "rleDecode",
            "q4": "joinProbe"}
PLAIN_VERSIONS = ("stable_argsort_u32_plain", "seg_reduce_plain",
                  "searchsorted_u64_pair_plain", "rle_decode_plain")
Q1_CUTOFFS = ("1998-09-02", "1995-06-17")
# (date lo, date hi, discount lo, discount hi, quantity below)
Q6_BINDINGS = (("1994-01-01", "1995-01-01", 0.05, 0.07, 24.0),
               ("1995-01-01", "1996-06-01", 0.02, 0.09, 40.0))
# Ship-date bands for (d): TPC-H's, and one after every shipped line.
PUSHDOWN_BANDS = (("1994-01-01", "1995-01-01"), ("1999-01-01",
                                                 "2000-01-01"))
KERNEL_OF = {"radixSort": "radix_sort", "segmentReduce": "seg_reduce",
             "rleDecode": "rle_decode", "joinProbe": "join_probe"}
# Whether the plan holds a fused stage: q6's lone filter under its
# aggregate has nothing to fuse with.
FUSES = {"q1": True, "q6": False, "q67": True}


# K3's and K4's library routes are their plain versions.
PLAIN_ROUTE = {"joinProbe": "searchsorted_u64_pair_plain",
               "rleDecode": "rle_decode_plain"}


@contextlib.contextmanager
def plain_versions_raise(native, off=()):
    """Every plain version raises while the block runs, but K3's and
    K4's where their gate is in ``off``: on the card a K1-K4 call
    launches its kernel or takes its library route, never a plain
    version that is not that route."""
    allowed = {PLAIN_ROUTE[g] for g in off if g in PLAIN_ROUTE}
    saved = {n: getattr(native, n) for n in PLAIN_VERSIONS
             if n not in allowed}

    def boom(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"phase 23: {name} ran for a tensor on "
                                 f"the card")
        return raiser
    for n in saved:
        setattr(native, n, boom(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)


def q1_at(L, li, cutoff: int):
    """TPC-H q1's text (``benchmarks/tpch.py``) with its ship-date cutoff
    a parameter."""
    disc = li.filter(L.col("l_shipdate") <= L.lit_col(cutoff)) \
        .with_column("disc_price",
                     L.col("l_extendedprice") * (1.0 - L.col("l_discount"))) \
        .with_column("charge",
                     L.col("l_extendedprice") * (1.0 - L.col("l_discount"))
                     * (1.0 + L.col("l_tax")))
    return disc.group_by("l_returnflag", "l_linestatus").agg(
        L.agg_sum(L.col("l_quantity")).alias("sum_qty"),
        L.agg_sum(L.col("l_extendedprice")).alias("sum_base_price"),
        L.agg_sum(L.col("disc_price")).alias("sum_disc_price"),
        L.agg_sum(L.col("charge")).alias("sum_charge"),
        L.agg_avg(L.col("l_quantity")).alias("avg_qty"),
        L.agg_avg(L.col("l_extendedprice")).alias("avg_price"),
        L.agg_avg(L.col("l_discount")).alias("avg_disc"),
        L.agg_count().alias("count_order"),
    ).order_by("l_returnflag", "l_linestatus")


def q6_at(L, li, lo: int, hi: int, dlo: float, dhi: float, qty: float):
    """TPC-H q6's text with its date band, discount band and quantity
    bound parameters."""
    f = li.filter((L.col("l_shipdate") >= L.lit_col(lo))
                  & (L.col("l_shipdate") < L.lit_col(hi))
                  & (L.col("l_discount") >= dlo)
                  & (L.col("l_discount") <= dhi)
                  & (L.col("l_quantity") < qty))
    return f.agg(L.agg_sum(L.col("l_extendedprice") * L.col("l_discount"))
                 .alias("revenue"))


def q6_binding(E, lo: str, hi: str, dlo: float, dhi: float, qty: float):
    """The literals of one q6 binding, as ``q6_oracle`` reads them."""
    import types
    return types.SimpleNamespace(
        Q6_DATE_LO=E.days(lo), Q6_DATE_HI=E.days(hi), Q6_DISCOUNT_LO=dlo,
        Q6_DISCOUNT_HI=dhi, Q6_QUANTITY_BELOW=qty)


def _metric_sum(ctx, name: str, prefix: str = "") -> float:
    return sum(m.values.get(name, 0) for k, m in ctx.metrics.items()
               if k.startswith(prefix))


def _timed_collect(phys, ctx):
    import torch
    t0 = time.perf_counter()
    rows = phys.collect(ctx)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def gates_runs(native, df_out: dict, smi: str) -> dict:
    """(a) q1-q4, phase 11's templates, run on the card with the gates on,
    with ``native.enabled=false`` and with only the query's own kernel's
    gate off, in turns (on, off, own off), every plain version
    raising but those that are the run's library routes."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops.base import ExecContext
    out = {"library": {}}
    for q in GATE_QUERIES:
        check, want = df_out["oracles"][q]
        phys = df_out[q]["frame"]._physical()
        raw = dict(phys.conf.raw)
        confs = {"on": raw,
                 "off": dict(raw, **{"spark.rapids.sql.native.enabled":
                                     False}),
                 "own": dict(raw, **{f"spark.rapids.sql.native."
                                     f"{OWN_GATE[q]}.enabled": False})}
        runs = []
        gates_off = {"on": (), "off": native.KERNELS, "own": (OWN_GATE[q],)}
        for label in ("on", "off", "own"):
            native.reset_counters()
            with plain_versions_raise(native, gates_off[label]):
                rows, wall = _timed_collect(
                    phys, ExecContext(TpuConf(confs[label])))
                check(rows, want)
                runs.append((label, rows, wall, native.counters(),
                             native.library_counters()))
        native.maybe_configure(TpuConf())
        on_rows, on_l = runs[0][1], runs[0][3]
        if on_l != df_out[q]["launches"]:
            raise AssertionError(f"{q} gates on launched {on_l}, phase 11 "
                                 f"{df_out[q]['launches']}")
        for label, rows, _wall, launches, lib in runs[1:]:
            if rows != on_rows:
                raise AssertionError(f"{q} ({label}) rows differ from the "
                                     f"gates-on run's")
            if label == "off":
                if any(launches.values()):
                    raise AssertionError(f"{q} gates off launched "
                                         f"{launches}")
                missed = [k for k, n in on_l.items() if n and not lib[k]]
                if missed:
                    raise AssertionError(f"{q} gates off: no library call "
                                         f"for {missed} ({lib})")
                out["library"][q] = lib
            if label == "own":
                k = KERNEL_OF[OWN_GATE[q]]
                want_l = dict(on_l, **{k: 0})
                if launches != want_l or not lib[k]:
                    raise AssertionError(f"{q} with {OWN_GATE[q]} off "
                                         f"launched {launches}, library "
                                         f"{lib}; expected {want_l}")
        walls = {label: [round(w, 4) for lb, _r, w, _l, _b in runs
                         if lb == label] for label in ("on", "off", "own")}
        log(f"phase 23 (a) {q}: rows bit for bit under every gate setting; "
            f"gates on launches {on_l}; native.enabled=false launches 0, "
            f"library calls {runs[1][4]}; {OWN_GATE[q]} off launches "
            f"{runs[2][3]}, library calls {runs[2][4]}; warm walls in turns "
            f"(on, off, own off): on {walls['on']} s, off "
            f"{walls['off']} s, own off {walls['own']} s; {smi}")
        out[q] = dict(walls=walls, runs=[r[3] for r in runs],
                      library=[r[4] for r in runs])
    return out


def plan_cache_runs(native, cols: dict, df_out: dict, smi: str) -> dict:
    """(b) q1 and q6 through ``prepare()`` at two bindings each over phase
    11's tables, the plan cache cleared first (a miss is a first run):
    the second binding a hit on the first's template, each binding's rows
    against numpy, and a DataFrame rebuilt with the first binding's
    literals a hit that reuses the template's packed sources."""
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.ops.base import ExecContext
    from spark_rapids_tpu_torch.plan import logical as L
    from spark_rapids_tpu_torch.plan import plan_cache as PC
    PC.cache().clear()
    tables = df_out["tables"]
    out = {}
    # The first bindings are the query texts' literals: phase 11's
    # oracles serve them.
    first_q6 = vars(q6_binding(E, *Q6_BINDINGS[0]))
    if E.days(Q1_CUTOFFS[0]) != E.Q1_SHIPDATE_CUTOFF or \
            any(getattr(E, k) != v for k, v in first_q6.items()):
        raise AssertionError("phase 23 (b): the first bindings must be the "
                             "query texts' literals")
    memo = {("q1", Q1_CUTOFFS[0]): df_out["oracles"]["q1"],
            ("q6", Q6_BINDINGS[0][0]): df_out["oracles"]["q6"]}

    def oracle_of(q, name, compute):
        return lambda: memo.setdefault((q, name), compute())
    cases = {
        "q1": [(c, lambda li, c=c: q1_at(L, li, E.days(c)),
                oracle_of("q1", c, lambda c=c: (check_q1, q1_oracle(
                    cols["lineitem"], E.days(c)))))
               for c in Q1_CUTOFFS],
        "q6": [(b[0], lambda li, b=b: q6_at(L, li, E.days(b[0]),
                                            E.days(b[1]), *b[2:]),
                oracle_of("q6", b[0], lambda b=b: (check_q6, q6_oracle(
                    cols, q6_binding(E, *b)))))
               for b in Q6_BINDINGS]}
    for q, bindings in cases.items():
        li = tables[q]["lineitem"]
        runs = []
        for name, build, oracle in bindings + [bindings[0]]:
            hits0 = PC.counters().get("planCacheHits", 0)
            t0 = time.perf_counter()
            bound = build(li).prepare()
            bind_ms = (time.perf_counter() - t0) * 1e3
            ctx = ExecContext(bound.conf)
            rows, wall = _timed_collect(bound, ctx)
            check, want = oracle()
            check(rows, want)
            runs.append(dict(
                binding=name, hit=bound.cache_hit, bind_ms=bind_ms,
                first_s=wall, values=bound.bind_values,
                hits=PC.counters().get("planCacheHits", 0) - hits0,
                template=bound.template,
                pack_ms=_metric_sum(ctx, "packTime",
                                    "InMemorySourceExec") / 1e6))
        miss, hit, rebuilt = runs
        if miss["hit"] or not hit["hit"] or not rebuilt["hit"] \
                or hit["hits"] != 1 or rebuilt["hits"] != 1:
            raise AssertionError(f"{q} plan cache: {runs}")
        if hit["template"] is not miss["template"] \
                or rebuilt["template"] is not miss["template"]:
            raise AssertionError(f"{q}: a hit planned a template of its own")
        log(f"phase 23 (b) {q}: miss (binding {miss['binding']}, slots "
            f"{miss['values']}) plan-or-bind {miss['bind_ms']:.3f} ms, first "
            f"run {miss['first_s']:.3f} s, packTime {miss['pack_ms']:.1f} "
            f"ms; hit (binding {hit['binding']}, the miss's template) "
            f"plan-or-bind {hit['bind_ms']:.3f} ms, {hit['first_s']:.3f} s; "
            f"rebuilt DataFrame (binding "
            f"{rebuilt['binding']}) plan-or-bind {rebuilt['bind_ms']:.3f} "
            f"ms, first run {rebuilt['first_s']:.3f} s, packTime "
            f"{rebuilt['pack_ms']:.1f} ms; every binding's rows match "
            f"numpy; {smi}")
        for r in runs:
            del r["template"]       # no template outlives the phase
        out[q] = runs
    out["counters"] = PC.counters()
    return out


def fusion_runs(native, df_out: dict, ds_out: dict, smi: str) -> dict:
    """(c) q1, q6 (phase 11's templates) and q67 (phase 14's) fused, then
    planned with ``stageFusion.enabled=false``: the same rows and the
    same K1-K4 launches; the fused stages and their member counts."""
    from spark_rapids_tpu_torch.api import DataFrame, TpuSession
    from spark_rapids_tpu_torch.ops.base import ExecContext
    out = {}
    cases = {q: (df_out[q]["frame"]._physical(), df_out[q]["frame"]._plan,
                 *df_out["oracles"][q]) for q in ("q1", "q6")}
    q67 = ds_out["q67"]
    cases["q67"] = (q67["phys"], q67["plan"], q67["check"], q67["want"])
    for q, (fused, plan, check, want) in cases.items():
        unfused = DataFrame(TpuSession(dict(
            fused.conf.raw, **{"spark.rapids.sql.stageFusion.enabled":
                               False})), plan)._physical()
        got = {}
        for label, phys in (("fused", fused), ("unfused", unfused)):
            native.reset_counters()
            ctx = ExecContext(phys.conf)
            rows, wall = _timed_collect(phys, ctx)
            check(rows, want)
            got[label] = dict(rows=rows, wall=wall,
                              launches=native.counters(),
                              ops=_metric_sum(ctx, "numFusedOps",
                                              "FusedStageExec"),
                              stages=phys.num_fused_stages)
        f, u = got["fused"], got["unfused"]
        if f["rows"] != u["rows"] or f["launches"] != u["launches"]:
            raise AssertionError(f"{q}: fused {f['launches']} vs unfused "
                                 f"{u['launches']}, rows equal: "
                                 f"{f['rows'] == u['rows']}")
        if u["stages"] or bool(f["stages"]) != FUSES[q]:
            raise AssertionError(f"{q}: {f['stages']} fused stages, "
                                 f"{u['stages']} with fusion off")
        lines = [line for line in fused.explain().splitlines()
                 if "Fused stages" in line or "*Stage #" in line]
        log(f"phase 23 (c) {q}: fused and unfused rows bit for bit, "
            f"launches {f['launches']} both; {f['stages']} fused stage(s), "
            f"numFusedOps {int(f['ops'])}; walls fused {f['wall']:.4f} s "
            f"(warm), unfused {u['wall']:.4f} s (its first run); {smi}")
        for line in lines:
            log(f"  {line.strip()}")
        out[q] = dict(stages=f["stages"], ops=f["ops"],
                      launches=f["launches"], fused_s=f["wall"],
                      unfused_s=u["wall"], lines=lines)
    return out


def pushdown_runs(native, cols: dict, fi_out: dict, smi: str) -> dict:
    """(d) q6 over phase 22's LINEITEM files at two ``l_shipdate``
    bindings of one template: the row groups skipped must be those whose
    ship dates (read back with numpy) miss each band."""
    import pyarrow.parquet as papq
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    from spark_rapids_tpu_torch.plan import logical as L
    paths = tpch._paths(fi_out["data_dir"], "lineitem")
    dates = []
    for p in paths:
        d = papq.read_table(p, columns=["l_shipdate"]).column(0).to_numpy()
        if d.dtype.kind == "M":          # written as a parquet DATE
            d = d.astype("datetime64[D]")
        dates.append(d.astype(np.int64))
    session = TpuSession(FILE_VFA)
    out = {"runs": []}
    for lo, hi in PUSHDOWN_BANDS:
        b = (lo, hi, E.Q6_DISCOUNT_LO, E.Q6_DISCOUNT_HI,
             E.Q6_QUANTITY_BELOW)
        bound = q6_at(L, session.read.parquet(*paths), E.days(lo),
                      E.days(hi), *b[2:]).prepare()
        ctx = ExecContext(bound.conf)
        rows, wall = _timed_collect(bound, ctx)
        check_q6(rows, q6_oracle(cols, q6_binding(E, *b)))
        skipped = int(_metric_sum(ctx, "numSkippedRowGroups"))
        want = sum(1 for d in dates
                   if d.max() < E.days(lo) or d.min() >= E.days(hi))
        if skipped != want:
            raise AssertionError(f"q6 [{lo}, {hi}) skipped {skipped} row "
                                 f"groups, numpy says {want}")
        log(f"phase 23 (d) q6 from parquet, l_shipdate in [{lo}, {hi}): "
            f"plan cache {'hit' if bound.cache_hit else 'miss'}; "
            f"{skipped} of {len(paths)} row groups skipped, as numpy's "
            f"ship-date ranges say; rows match ({rows}); {wall:.3f} s; "
            f"{smi}")
        out["runs"].append(dict(band=(lo, hi), hit=bound.cache_hit,
                                skipped=skipped, wall=wall))
    if [r["hit"] for r in out["runs"]] != [False, True] or len(
            {r["skipped"] for r in out["runs"]}) != 2:
        raise AssertionError(f"(d) {out['runs']}")
    return out


def prepared_phase(native, cols: dict, df_out: dict, ds_out: dict,
                   fi_out: dict, smi: str) -> dict:
    """Phase 23: (a) the gates, (b) the plan cache, (c) fusion, (d)
    pushdown by binding; then whether the cached templates held device
    memory."""
    import gc
    import torch
    from spark_rapids_tpu_torch.plan import plan_cache as PC
    t_phase = time.perf_counter()
    out = dict(gates=gates_runs(native, df_out, smi),
               cache=plan_cache_runs(native, cols, df_out, smi),
               fusion=fusion_runs(native, df_out, ds_out, smi),
               pushdown=pushdown_runs(native, cols, fi_out, smi))
    # Tensors free by reference count; a cycle left uncollected here
    # would only show as more freed below, never as less.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    entries = PC.cache().stats()["entries"]
    PC.cache().clear()
    gc.collect()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    log(f"phase 23: clearing {entries} cached template(s) freed {freed} B "
        f"of device memory ({before} B allocated before)")
    out["template_device_bytes"] = freed
    out["runs"] = [r for q in GATE_QUERIES
                   for r in out["gates"][q]["runs"]] + [
        out["fusion"][q]["launches"] for q in out["fusion"]]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 23 took {out['seconds']:.1f} s; {smi}")
    return out


# ---------------------------------------------------------------------------
# Phase 24: the observability layer and the fault-injection registry
# ---------------------------------------------------------------------------

OBS_QUERIES = ("q1", "q2", "q3", "q4")
CHAOS_QUERIES = ("q1", "q3", "q6")
CHAOS_OOM = "oom@upload:1,oom@kernel:1,oom@concat:1"
# One flip per frame: the CRC re-read recovers it. The reference's
# corrupt@wire:2 flips a frame's read and its re-read too, which only its
# stage recompute (not ported) recovers; the port then fails loudly.
CHAOS_CORRUPT = "corrupt@wire:1,oom@upload:1"
# A device budget and host tier small enough that q1's exchange pieces
# spill to disk (frames the corruption site reads back).
CHAOS_DEVICE_BUDGET = 2048
CHAOS_HOST_BUDGET = 0
OBS_TURNS = 2
TIMED_CALLS = 20_000


def _rebound(session, tables: dict) -> dict:
    """Phase 11's in-memory tables (the same host batches) as DataFrames
    of ``session``, whose conf the plans then carry."""
    from spark_rapids_tpu_torch.api import DataFrame
    return {t: DataFrame(session, d._plan) for t, d in tables.items()}


def _span_check(monitoring, qid: int, evs: list, label: str) -> None:
    """Every span closed, one ``collect`` span holding every span of the
    query but the admission wait, which ends before it, every event
    under the query's minted id."""
    if monitoring.open_span_count() != 0:
        raise AssertionError(f"{label}: {monitoring.open_span_count()} "
                             f"unclosed span(s)")
    if qid < 1 or {e[6] for e in evs} != {qid}:
        raise AssertionError(f"{label}: events outside query {qid}: "
                             f"{sorted({e[6] for e in evs})}")
    spans = [e for e in evs if e[0] == "X"]
    collects = [e for e in spans if e[1] == "collect" and e[2] == "query"]
    if len(collects) != 1:
        raise AssertionError(f"{label}: {len(collects)} collect spans")
    c0, c1 = collects[0][3], collects[0][3] + collects[0][4]
    # The scheduler's admission wait precedes the collect it admits.
    outside = [e[1] for e in spans if e[1] != "admission-queue"
               and (e[3] < c0 or e[3] + e[4] > c1)]
    outside += [e[1] for e in spans if e[1] == "admission-queue"
                and e[3] + e[4] > c0]
    if outside:
        raise AssertionError(f"{label}: spans outside the collect span: "
                             f"{outside[:5]}")


def _categories(evs: list) -> dict:
    cats = {}
    for e in evs:
        if e[0] == "X":
            cats[e[2]] = cats.get(e[2], 0.0) + e[4] / 1e6
    return {c: round(ms, 3) for c, ms in sorted(cats.items())}


def _median(xs: list) -> float:
    return float(np.median(np.asarray(xs)))


def observability_phase(native, df_out: dict, smi: str) -> dict:
    """Phase 24 (runs after phase 23, over phase 11's tables and oracles):
    (a) traced q1-q4, (b) the tracing's cost, (c) sync attribution, (d)
    telemetry and the event log, (e) chaos under seeded fault schedules.
    Telemetry and the event log are on for the whole phase through their
    env keys (``SRT_METRICS``, ``SRT_EVENT_LOG``), so every query of the
    phase counts, whatever its conf."""
    import re
    import shutil
    import tempfile
    import warnings
    import torch
    from spark_rapids_tpu_torch import faults, monitoring
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.monitoring import history, syncs, telemetry
    from spark_rapids_tpu_torch.ops import base as B
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="srt-obs-")
    oracles, tables = df_out["oracles"], df_out["tables"]
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    ev_dir = os.path.join(tmp, "events")
    env_before = {k: os.environ.get(k) for k in ("SRT_METRICS",
                                                 "SRT_EVENT_LOG")}
    os.environ["SRT_METRICS"] = "1"
    os.environ["SRT_EVENT_LOG"] = ev_dir
    telemetry.reset()
    monitoring.reset()
    out = {"runs": []}
    queries = device_collects = 0

    def run(df, q: str):
        nonlocal queries, device_collects
        native.reset_counters()
        t0 = time.perf_counter()
        rows = df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = native.counters()
        out["runs"].append(launches)
        queries += 1
        device_collects += 1
        check, want = oracles[q]
        check(rows, want)
        return rows, launches, wall

    try:
        # (a) traced q1-q4 against their untraced runs
        sess_op = TpuSession(dict(vfa, **{
            "spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.trace.level": "operator"}))
        frames, bases = {}, {}
        for q in OBS_QUERIES:
            rows0, launches0, _ = run(df_out[q]["frame"], q)
            bases[q] = rows0
            df = tpch.QUERIES[q](sess_op, _rebound(sess_op, tables[q]))
            rows, launches, wall = run(df, q)
            if rows != rows0:
                raise AssertionError(f"(a) traced {q}: rows differ from "
                                     f"the untraced run's")
            if launches != launches0:
                raise AssertionError(f"(a) traced {q}: launches {launches} "
                                     f"against untraced {launches0}")
            qid = df._physical().last_ctx.cache["trace_query"]
            evs = monitoring.events(qid)
            _span_check(monitoring, qid, evs, f"(a) {q}")
            log(f"phase 24 (a) {q} traced (operator level, its first run "
                f"{wall:.3f} s): rows and K1-K4 launches {launches} equal "
                f"the untraced run's; query {qid}, {len(evs)} events, spans "
                f"well formed; category ms {_categories(evs)}; {smi}")
            frames[q] = df
        path = os.path.join(tmp, "q3_trace.json")
        doc = frames["q3"].trace_export(path)
        with open(path) as f:
            loaded = json.load(f)
        if loaded != doc or not loaded["traceEvents"]:
            raise AssertionError("(a) q3's trace export did not load back")
        log(f"phase 24 (a) q3 trace_export: {len(loaded['traceEvents'])} "
            f"trace events, {os.path.getsize(path)} B, loaded back equal")
        for q in ("q1", "q3"):
            log(f"phase 24 (a) {q} explain_analyze:")
            frames[q].explain_analyze()
        for level in ("ESSENTIAL", "MODERATE", "ALL"):
            # Set in the raw conf, not through set(): a new conf version
            # would plan the DataFrame anew, without its last collect.
            sess_op.conf.raw["spark.rapids.sql.metrics.level"] = level
            m = frames["q1"].metrics()
            log(f"phase 24 (a) q1 metrics() at {level}: "
                + "; ".join(f"{k.split('@')[0]} {sorted(v)}"
                            for k, v in m.items()))
        sess_op.conf.raw.pop("spark.rapids.sql.metrics.level")

        # (b) the cost: q1 warm, trace off / operator / kernel, in turns
        syncs.install()
        sess_k = TpuSession(dict(vfa, **{
            "spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.trace.level": "kernel"}))
        kframes = {q: tpch.QUERIES[q](sess_k, _rebound(sess_k, tables[q]))
                   for q in ("q1", "q3")}
        run(kframes["q1"], "q1")                  # its first run: packs
        walls = {"off": [], "operator": [], "kernel": []}
        entered = [0]
        enter = B.timed.__enter__

        def counting_enter(self):
            entered[0] += 1
            return enter(self)
        for i in range(OBS_TURNS):
            for label, df in (("off", df_out["q1"]["frame"]),
                              ("operator", frames["q1"]),
                              ("kernel", kframes["q1"])):
                if i == 0 and label == "off":
                    B.timed.__enter__ = counting_enter
                try:
                    walls[label].append(run(df, "q1")[2])
                finally:
                    B.timed.__enter__ = enter
        timed_calls = entered[0]
        m = B.Metrics("Probe")
        costs = {}
        for label, conf_on, level in (
                ("off", False, monitoring.LEVEL_OPERATOR),
                ("operator", True, monitoring.LEVEL_OPERATOR)):
            monitoring.configure(conf_on, level, max_events=256)
            t0 = time.perf_counter()
            for _ in range(TIMED_CALLS):
                with B.timed(m):
                    pass
            costs[label] = (time.perf_counter() - t0) / TIMED_CALLS * 1e6
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            with torch.profiler.record_function("Probe:totalTime"):
                pass
        costs["record_function"] = \
            (time.perf_counter() - t0) / TIMED_CALLS * 1e6
        monitoring.configure(False)
        monitoring.reset()
        out["walls"] = walls
        out["timed"] = dict(calls=timed_calls, us=costs)
        log(f"phase 24 (b) q1 warm walls in {OBS_TURNS} turns, s: "
            + ", ".join(f"{k} {[round(w, 4) for w in v]} (median "
                        f"{_median(v):.4f})" for k, v in walls.items())
            + f"; {timed_calls} timed() calls a q1 run; one timed() call "
            f"{costs['off']:.3f} us with tracing off, "
            f"{costs['operator']:.3f} us at operator level (a span), an "
            f"unguarded record_function {costs['record_function']:.3f} us "
            f"(host clock, {TIMED_CALLS} calls); {smi}")

        # (c) sync attribution at kernel level: q1 and q3
        out["syncs"] = {}
        run(kframes["q3"], "q3")                  # its first run: packs
        for q in ("q1", "q3"):
            monitoring.reset()
            prev = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run(kframes[q], q)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
            debug = sum(1 for w in caught
                        if "synchroniz" in str(w.message))
            qid = kframes[q]._physical().last_ctx.cache["trace_query"]
            stats = syncs.sync_stats(qid)
            n = sum(c for c, _ in stats.values())
            secs = sum(t for _, t in stats.values())
            top = sorted(stats.items(), key=lambda kv: -kv[1][0])[:5]
            out["syncs"][q] = dict(spans=n, seconds=secs, debug=debug)
            log(f"phase 24 (c) {q} at kernel level: {n} sync spans, "
                f"{secs:.4f} s; torch's sync-debug warnings {debug}; top "
                f"sites: " + "; ".join(f"{k} x{c} ({t * 1e3:.2f} ms)"
                                       for k, (c, t) in top) + f"; {smi}")

        # (e) chaos: q1, q3, q6 under seeded schedules
        out["chaos"] = {}
        for q in CHAOS_QUERIES:
            if q not in bases:
                bases[q] = run(df_out[q]["frame"], q)[0]
            out["chaos"][q] = _chaos_run(q, CHAOS_OOM, tables, bases[q],
                                         run, tmp, smi)
        out["chaos"]["corrupt"] = _chaos_run(
            "q1", CHAOS_CORRUPT, tables, bases["q1"], run, tmp, smi,
            budget=(CHAOS_DEVICE_BUDGET, CHAOS_HOST_BUDGET))
        faults.configure("")

        # (d) telemetry and the event log over the whole phase
        snap = telemetry.snapshot()["metrics"]
        collects = sum(x["value"] for x in snap["srt_collects"]["series"])
        lat = sum(x["count"] for x in
                  snap["srt_query_latency_ms"]["series"])
        if collects != device_collects or lat != queries:
            raise AssertionError(
                f"(d) srt_collects {collects} / srt_query_latency_ms "
                f"{lat} against the phase's {device_collects} device "
                f"collects / {queries} queries")
        text = telemetry.render_text()
        sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
                            r'(-?[0-9.e+-]+|NaN|[+-]Inf)$')
        bad = [ln for ln in text.splitlines()
               if not ln.startswith("#") and not sample.match(ln)]
        if bad or not text.endswith("# EOF\n"):
            raise AssertionError(f"(d) render_text lines do not parse: "
                                 f"{bad[:3]}")
        recs = history.read_events(ev_dir)
        if len(recs) != queries:
            raise AssertionError(f"(d) {len(recs)} event-log records for "
                                 f"{queries} queries")
        lines = text.count("\n")
        log(f"phase 24 (d) telemetry: srt_collects {collects:.0f}, "
            f"srt_query_latency_ms count {lat} (the phase's queries), "
            f"render_text {lines} lines all parse; event log {len(recs)} "
            f"records; q1's (operator level) report:")
        q1_qid = frames["q1"]._physical().last_ctx.cache["trace_query"]
        rec = next(r for r in recs if r["query_id"] == q1_qid)
        for line in history.render_report(rec).splitlines():
            log(f"  {line}")
    finally:
        faults.configure("")
        monitoring.configure(False)
        monitoring.reset()
        telemetry.configure(False)
        telemetry.reset()
        history.set_dir("")
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 24 took {out['seconds']:.1f} s; {smi}")
    return out


def _chaos_run(q: str, spec: str, tables: dict, base: list, run, tmp: str,
               smi: str, budget=None) -> dict:
    """``q`` under the fault schedule ``spec`` (seed 7; a plan of its own:
    an armed schedule bypasses the plan cache): rows bit for bit the
    fault-free device rows ``base``, the injections and ladder rungs
    counted in ``Recovery@query`` and present as instants in the query's
    trace."""
    from spark_rapids_tpu_torch import faults, monitoring
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    spill = os.path.join(tmp, f"spill-{q}-{len(spec)}")
    os.makedirs(spill, exist_ok=True)
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": True,
            "spark.rapids.sql.trace.enabled": True,
            "spark.rapids.sql.trace.level": "query",
            "spark.rapids.sql.test.faults": spec,
            "spark.rapids.sql.test.faults.seed": 7,
            "spark.rapids.memory.spill.dir": spill}
    if budget is not None:
        conf["spark.rapids.memory.tpu.budgetBytes"] = budget[0]
        conf["spark.rapids.memory.host.spillStorageSize"] = budget[1]
    faults.configure("")
    faults.reset_counters()
    session = TpuSession(conf)
    df = tpch.QUERIES[q](session, _rebound(session, tables[q]))
    rows, launches, wall = run(df, q)
    if rows != base:
        raise AssertionError(f"(e) {q} under {spec!r}: rows differ from "
                             f"the fault-free device rows")
    ctx = df._physical().last_ctx
    rec = dict(ctx.metrics["Recovery@query"].values)
    qid = ctx.cache["trace_query"]
    inst = [(e[1], e[7]) for e in monitoring.events(qid) if e[0] == "i"]
    names = {n for n, _ in inst}
    if rec.get("faultsInjected", 0) < 1 or \
            rec.get("spillEscalations", 0) < 1 or \
            not {"fault-injected", "oom-rung"} <= names:
        raise AssertionError(f"(e) {q} under {spec!r}: recovery "
                             f"{rec}, instants {inst}")
    spill_m = ctx.last_spill_metrics or {}
    if budget is not None and (
            rec.get("corruptionsDetected", 0) != 1
            or spill_m.get("restore_from_disk", 0) < 1):
        raise AssertionError(f"(e) {q} under {spec!r}: no frame read back "
                             f"from disk was corrupted and re-read "
                             f"({rec}, {spill_m})")
    if ctx.last_leak_report:
        raise AssertionError(f"(e) {q}: leaked {ctx.last_leak_report}")
    log(f"phase 24 (e) {q} under {spec!r}"
        + (f" (budgetBytes {budget[0]}, host tier {budget[1]})"
           if budget else "")
        + f": rows bit for bit the fault-free device rows, {wall:.3f} s; "
        f"Recovery@query {rec}; instants {inst}; spill "
        f"{ {k: v for k, v in spill_m.items() if v} }; launches "
        f"{launches}; {smi}")
    return dict(recovery=rec, instants=inst, wall=wall, launches=launches)


# ---------------------------------------------------------------------------
# Phase 25: the runtime re-plan, the recovery ladder, concurrent stages and
# the partial skip
# ---------------------------------------------------------------------------

REPLAN_QUERIES = ("q4", "q13", "q21")
# q17's PART build: its estimate (every PART row: ~6.3 MB at SF1) above
# this threshold, the 200-odd parts its filter keeps (a few KB) below, so
# the planner shuffles the join and the re-plan demotes it.
Q17_THRESHOLD = 1 << 20
ADAPTIVE_PARTITIONS = 8
Q3_SHUFFLED = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1}
SKIP_ON, SKIP_OFF = 0.85, 1.0
_RATIO_KEY = "spark.rapids.sql.agg.skipAggPassReductionRatio"


def _replan_joins(root) -> list:
    """(join, build exchange, probe exchange) of every join the re-plan
    checks: a shuffled hash join (not full outer) over two exchanges."""
    out = []

    def walk(op):
        for c in op.children:
            walk(c)
        if type(op).__name__ == "ShuffledHashJoinExec" and \
                op.join_type != "full" and all(
                    type(c).__name__ == "ShuffleExchangeExec"
                    for c in op.children):
            build_right = op.join_type != "right"
            b, p = (1, 0) if build_right else (0, 1)
            out.append((op, op.children[b], op.children[p]))

    walk(root)
    return out


def _materialized(ctx, ex) -> bool:
    m = ctx.metrics.get(f"{ex.name}@{id(ex):x}")
    return m is not None and "materializeTime" in m.values


def _partials(root) -> list:
    out = []

    def walk(op):
        if type(op).__name__ == "HashAggregateExec" and \
                op.mode == "partial":
            out.append(op)
        for c in op.children:
            walk(c)

    walk(root)
    return out


def _skip_decisions(phys) -> list:
    """(group keys, decision or None) of each partial aggregate of the
    last run."""
    ctx = phys.last_ctx
    out = []
    for a in _partials(phys.root):
        m = ctx.metrics_for(a).values
        out.append((a.group_names, None if "partialSkip" not in m
                    else bool(m["partialSkip"])))
    return out


def _source_batches(phys) -> dict:
    """numOutputBatches of each in-memory source of the last run, by its
    column names."""
    ctx = phys.last_ctx
    out = {}

    def walk(op):
        if type(op).__name__ == "InMemorySourceExec":
            m = ctx.metrics.get(f"{op.name}@{id(op):x}")
            out[tuple(n for n, _ in op.schema)] = \
                int(m.values.get("numOutputBatches", 0)) if m else 0
        for c in op.children:
            walk(c)

    walk(phys.root)
    return out


def check_orders_groups(hbs: list, orders: dict) -> float:
    """ORDERS grouped by o_orderkey (count, sum of o_totalprice) against
    numpy: every key once, counts exact, each sum its order's price within
    ORACLE_RTOL or the rounding of the aggregate's group sums, which are
    differences of a running sum over a batch (``_segment_sums``): a few
    ulp of that total, at most 4 ulp of the whole column's. Returns the
    largest absolute difference."""
    keys = np.concatenate([hb.columns[0].data for hb in hbs])
    counts = np.concatenate([hb.columns[1].data for hb in hbs])
    sums = np.concatenate([hb.columns[2].data for hb in hbs])
    order = np.argsort(keys, kind="stable")
    want_keys = np.sort(orders["o_orderkey"])
    if not np.array_equal(keys[order], want_keys):
        raise AssertionError("(d) ORDERS group-by keys differ from numpy")
    if not (counts == 1).all():
        raise AssertionError("(d) ORDERS group-by counts are not all 1")
    price = orders["o_totalprice"][np.argsort(orders["o_orderkey"],
                                              kind="stable")]
    diff = np.abs(sums[order] - price)
    atol = 4 * np.finfo(np.float64).eps * float(np.abs(price).sum())
    if not (diff <= ORACLE_RTOL * np.abs(price) + atol).all():
        raise AssertionError(f"(d) ORDERS group-by sums differ from numpy "
                             f"by up to {diff.max()} (atol {atol})")
    return float(diff.max())


def adaptive_phase(native, cols: dict, df_out: dict, ex_out: dict,
                   smi: str) -> dict:
    """Phase 25 (runs after phase 24, over phase 11's tables; oracles of
    phases 11 and 16): (a) the runtime re-plan, (b) the recovery ladder,
    (c) concurrent stages, (d) the partial skip. See the module doc."""
    import shutil
    import tempfile
    import torch
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch import faults, monitoring
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.plan import logical as L
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="srt-adaptive-")
    tables = df_out["tables"]
    oracles = dict(df_out["oracles"])
    oracles.update({q: ex_out["oracles"][q] for q in ("q13", "q18", "q21")})
    oracles["q17"] = distinct_oracles(cols, None, E, None, ("q17",))["q17"]
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    eight = dict(vfa, **{"spark.rapids.sql.shuffle.partitions":
                         ADAPTIVE_PARTITIONS})
    out = {"runs": []}

    def frame(conf, q):
        session = TpuSession(conf)
        return tpch.QUERIES[q](session, _rebound(session, tables[q]))

    def run(df, q=None, batches=False):
        """One run: launches around it alone, the wall, the rows checked
        against the query's oracle, no leak."""
        native.reset_counters()
        t0 = time.perf_counter()
        phys = df._physical()
        rows = phys.collect_batches() if batches else df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = native.counters()
        out["runs"].append(launches)
        if q is not None:
            check, want = oracles[q]
            check(rows, want)
        ctx = phys.last_ctx
        if ctx.last_leak_report:
            raise AssertionError(f"phase 25 {q}: leaked "
                                 f"{ctx.last_leak_report}")
        return rows, launches, wall, ctx

    try:
        # (a) The runtime re-plan at 8 partitions, on and off in turns.
        out["replan"] = {}
        for q in REPLAN_QUERIES:
            frames = {c: frame(dict(eight, **{
                "spark.rapids.sql.aqe.replan.enabled": c == "on"}), q)
                for c in ("on", "off")}
            res = {c: dict(walls=[]) for c in frames}
            # q21 demotes nothing (its ORDERS join is broadcast statically):
            # one turn, for the script's time budget.
            turns = (("on", "off"), ("off", "on"))[:1 if q == "q21" else 2]
            for order in turns:
                for c in order:
                    rows, launches, wall, ctx = run(frames[c], q)
                    r = res[c]
                    r["walls"].append(wall)
                    r.setdefault("rows", rows)
                    r.setdefault("launches", launches)
                    r["ctx"] = ctx
            if not rows_close(res["on"]["rows"], res["off"]["rows"]):
                raise AssertionError(f"(a) {q}: rows with the re-plan on "
                                     f"differ from its rows off")
            phys, ctx = frames["on"]._physical(), res["on"]["ctx"]
            cost = dict(ctx.metrics["Cost@query"].values) \
                if "Cost@query" in ctx.metrics else {}
            joins = [(j.join_type, _materialized(ctx, p))
                     for j, _b, p in _replan_joins(phys.root)]
            demoted = sum(1 for _t, m in joins if not m)
            if cost.get("replanChecks", 0) != len(joins) or \
                    cost.get("joinDemotions", 0) != demoted:
                raise AssertionError(f"(a) {q}: Cost@query {cost} against "
                                     f"the joins {joins}")
            off_ctx = res["off"]["ctx"]
            if "Cost@query" in off_ctx.metrics or not all(
                    _materialized(off_ctx, p) for _j, _b, p in
                    _replan_joins(frames["off"]._physical().root)):
                raise AssertionError(f"(a) {q}: the re-plan ran while off")
            out["replan"][q] = dict(
                cost=cost, joins=joins,
                walls={c: res[c]["walls"] for c in res},
                launches={c: res[c]["launches"] for c in res})
            log(f"phase 25 (a) {q} at {ADAPTIVE_PARTITIONS} partitions, "
                f"re-plan on: replanChecks {cost.get('replanChecks', 0)}, "
                f"joinDemotions {cost.get('joinDemotions', 0)}, "
                f"replanObservedBytes {cost.get('replanObservedBytes', 0)} "
                f"(threshold {64 << 20}), estimateErrorPct "
                f"{cost.get('estimateErrorPct', 0):.1f}; joins (type, probe "
                f"exchange materialized) {joins}; K1 / K3 launches on "
                f"{res['on']['launches']['radix_sort']} / "
                f"{res['on']['launches']['join_probe']}, off "
                f"{res['off']['launches']['radix_sort']} / "
                f"{res['off']['launches']['join_probe']}; walls on "
                f"{[round(w, 4) for w in res['on']['walls']]} s, off "
                f"{[round(w, 4) for w in res['off']['walls']]} s (first, "
                f"warm; in turns {[c for o in turns for c in o]}); rows "
                f"equal; {smi}")

        df17 = frame(dict(eight, **{
            "spark.rapids.sql.autoBroadcastJoinThreshold": Q17_THRESHOLD}),
            "q17")
        phys17 = df17._physical()
        notes = [line.strip() for line in phys17.explain().splitlines()
                 if "join strategy" in line]
        walls17 = []
        for _ in range(2):
            _rows, launches17, wall, ctx = run(df17, "q17")
            walls17.append(wall)
        cost = dict(ctx.metrics["Cost@query"].values)
        joins = [(j.join_type, getattr(j, "est_build_bytes", None),
                  _materialized(ctx, p))
                 for j, _b, p in _replan_joins(phys17.root)]
        demoted = sum(1 for _t, _e, m in joins if not m)
        if cost.get("joinDemotions", 0) < 1 or \
                cost["joinDemotions"] != demoted:
            raise AssertionError(f"(a) q17: no demotion with its probe "
                                 f"exchange unmaterialized: {cost}, {joins}")
        out["replan"]["q17"] = dict(cost=cost, joins=joins, walls=walls17,
                                    launches=launches17)
        log(f"phase 25 (a) q17 at {ADAPTIVE_PARTITIONS} partitions, "
            f"autoBroadcastJoinThreshold {Q17_THRESHOLD}: planner notes "
            f"{notes}; Cost@query {cost}; joins (type, estimate, probe "
            f"exchange materialized) {joins}: {demoted} demoted, its probe "
            f"never shuffled; launches {launches17}; walls "
            f"{[round(w, 4) for w in walls17]} s; {smi}")

        # (b) The recovery ladder: rows bit for bit the fault-free rows.
        out["recovery"] = {}
        q3conf = dict(eight, **Q3_SHUFFLED)
        free3 = frame(q3conf, "q3")
        base3, _, _, _ = run(free3, "q3")
        free_src = _source_batches(free3._physical())
        base1 = run(df_out["q1"]["frame"], "q1")[0]
        base6 = run(df_out["q6"]["frame"], "q6")[0]

        def chaos(label, q, conf, spec, base, expect):
            faults.configure("")
            faults.reset_counters()
            spill = os.path.join(tmp, f"spill-{len(out['recovery'])}")
            os.makedirs(spill, exist_ok=True)
            conf = dict(conf, **{
                "spark.rapids.sql.test.faults": spec,
                "spark.rapids.sql.test.faults.seed": 7,
                "spark.rapids.sql.retry.backoffMs": 1,
                "spark.rapids.sql.trace.enabled": True,
                "spark.rapids.sql.trace.level": "query",
                "spark.rapids.memory.spill.dir": spill})
            df = frame(conf, q)
            rows, launches, wall, ctx = run(df, q)
            if rows != base:
                raise AssertionError(f"(b) {label}: rows differ from the "
                                     f"fault-free rows")
            rec = {k: v for k, v in ctx.metrics["Recovery@query"]
                   .values.items()}
            qid = ctx.cache["trace_query"]
            inst = [(e[1], e[7]) for e in monitoring.events(qid)
                    if e[0] == "i"]
            bad = {k: (rec.get(k, 0), v) for k, v in expect.items()
                   if not (rec.get(k, 0) >= v[1] if isinstance(v, tuple)
                           else rec.get(k, 0) == v)}
            if bad:
                raise AssertionError(f"(b) {label}: Recovery@query {rec}; "
                                     f"expected {expect}")
            out["recovery"][label] = dict(recovery=rec, instants=inst,
                                          wall=wall, launches=launches)
            log(f"phase 25 (b) {label} under {spec!r}: rows bit for bit "
                f"the fault-free rows, {wall:.3f} s; Recovery@query {rec}; "
                f"instants {inst}; no leak; launches {launches}; {smi}")
            faults.configure("")
            return df

        lost = chaos("q3 lostoutput", "q3", q3conf,
                     "lostoutput@exchange.serve:1", base3,
                     {"stageRecomputes": 1, "faultsInjected": 1})
        lost_src = _source_batches(lost._physical())
        doubled = [k for k in free_src
                   if lost_src.get(k) == 2 * free_src[k] > 0]
        same = [k for k in free_src if lost_src.get(k) == free_src[k]]
        if len(doubled) != 1 or len(same) != len(free_src) - 1:
            raise AssertionError(f"(b) q3 lostoutput: sources ran "
                                 f"{lost_src} against {free_src}")
        log(f"phase 25 (b) q3 lostoutput: source batches {lost_src} "
            f"against the fault-free {free_src}: only {doubled[0]} ran "
            f"again, every sibling stage's source uploaded once")
        chaos("q3 transient", "q3", q3conf, "transient@exchange.serve:1",
              base3, {"retriesAttempted": 1, "faultsInjected": 1})
        chaos("q1 corrupt", "q1", dict(vfa, **{
            "spark.rapids.memory.tpu.budgetBytes": CHAOS_DEVICE_BUDGET,
            "spark.rapids.memory.host.spillStorageSize": CHAOS_HOST_BUDGET}),
            "corrupt@wire:2,oom@upload:1", base1,
            {"corruptionsDetected": (">=", 1), "stageRecomputes": 1})
        chaos("q6 stall", "q6", dict(vfa, **{
            "spark.rapids.sql.watchdog.enabled": True,
            "spark.rapids.sql.watchdog.taskTimeoutMs": 1000}),
            "stall@kernel:1", base6,
            {"watchdogKills": 1, "partitionRetries": 1})
        monitoring.configure(False)
        monitoring.reset()

        # (c) Concurrent stages: q3, the pipeline on and off in turns.
        # The pipeline's default (on) is (b)'s fault-free q3, warm; the off
        # plan's first run packs its sources.
        frames = {"on": free3, "off": frame(dict(q3conf, **{
            "spark.rapids.sql.pipeline.enabled": False}), "q3")}
        walls, rows_by, stages = {"on": [], "off": []}, {}, None
        for order in (("on", "off"), ("off", "on")):
            for c in order:
                rows, _launches, wall, ctx = run(frames[c], "q3")
                walls[c].append(wall)
                rows_by[c] = rows
                if c == "on":
                    stages = ctx.metrics["Pipeline@query"].values.get(
                        "concurrentStages", 0)
        if stages < 2 or rows_by["on"] != rows_by["off"]:
            raise AssertionError(f"(c) q3: concurrentStages {stages}, rows "
                                 f"equal {rows_by['on'] == rows_by['off']}")
        out["concurrent"] = dict(stages=stages, walls=walls)
        log(f"phase 25 (c) q3 at {ADAPTIVE_PARTITIONS} partitions, "
            f"auto-broadcast off: concurrentStages {stages} with the "
            f"pipeline on; rows equal bit for bit; walls on "
            f"{[round(w, 4) for w in walls['on']]} s, off "
            f"{[round(w, 4) for w in walls['off']]} s (in turns on, off, "
            f"off, on; the off plan's first run packs its sources); {smi}")

        # (d) The partial skip: ORDERS by o_orderkey and q18, at the
        # default ratio and off, in turns.
        orders = cols["orders"]
        out["skip"] = {}

        def orders_frame(ratio):
            session = TpuSession(dict(eight, **{_RATIO_KEY: ratio}))
            o = _rebound(session, tables["q18"])["orders"]
            return o.group_by("o_orderkey").agg(
                L.agg_count().alias("n"),
                L.agg_sum(L.col("o_totalprice")).alias("s"))

        for name, make, q, turns in (
                ("orders", orders_frame, None,
                 ((SKIP_ON, SKIP_OFF), (SKIP_OFF, SKIP_ON))),
                ("q18", lambda r: frame(dict(eight, **{_RATIO_KEY: r}),
                                        "q18"), "q18",
                 ((SKIP_ON, SKIP_OFF),))):
            frames = {r: make(r) for r in (SKIP_ON, SKIP_OFF)}
            res = {r: dict(walls=[]) for r in frames}
            for order in turns:
                for r in order:
                    rows, launches, wall, _ctx = run(frames[r], q,
                                                     batches=q is None)
                    if q is None:
                        res[r]["err"] = check_orders_groups(rows, orders)
                    res[r]["walls"].append(wall)
                    res[r].setdefault("launches", launches)
            dec = {r: _skip_decisions(frames[r]._physical()) for r in frames}
            if any(d is not None for _k, d in dec[SKIP_OFF]):
                raise AssertionError(f"(d) {name}: decided at ratio 1.0: "
                                     f"{dec[SKIP_OFF]}")
            if name == "orders" and dec[SKIP_ON] != [(("o_orderkey",),
                                                      True)]:
                raise AssertionError(f"(d) orders: {dec[SKIP_ON]}")
            if name == "q18" and (("l_orderkey",), False) not in \
                    dec[SKIP_ON]:
                raise AssertionError(f"(d) q18: {dec[SKIP_ON]}")
            out["skip"][name] = dict(decisions=dec[SKIP_ON], walls={
                str(r): res[r]["walls"] for r in res}, launches={
                str(r): res[r]["launches"] for r in res})
            log(f"phase 25 (d) {name} at {ADAPTIVE_PARTITIONS} partitions: "
                f"partial decisions (keys, skip) at {SKIP_ON} "
                f"{dec[SKIP_ON]}; K1 launches at {SKIP_ON} "
                f"{res[SKIP_ON]['launches']['radix_sort']}, at {SKIP_OFF} "
                f"{res[SKIP_OFF]['launches']['radix_sort']}; walls at "
                f"{SKIP_ON} {[round(w, 4) for w in res[SKIP_ON]['walls']]} "
                f"s, at {SKIP_OFF} "
                f"{[round(w, 4) for w in res[SKIP_OFF]['walls']]} s (in "
                f"turns {turns}); rows against numpy"
                + (f" (largest sum difference {res[SKIP_ON]['err']} / "
                   f"{res[SKIP_OFF]['err']})" if q is None else "")
                + f"; {smi}")
    finally:
        faults.configure("")
        monitoring.configure(False)
        monitoring.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 25 took {out['seconds']:.1f} s; {smi}")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the multi-query scheduler, QoS admission and the device
# semaphore
# ---------------------------------------------------------------------------

SCHED_QUERIES = ("q1", "q3", "q4", "q6")
# Query tags of the phase's fault schedules (distinct from minted ids).
TAG_CANCEL, TAG_DEADLINE, TAG_HOLDER, TAG_OOM = 9001, 9002, 9101, 9102
STALL_FOUND_S = 30.0
# (e): how long the holder's injected stall lasts (it then unwinds as a
# transient error, retried on the same context), and how long after the
# stall begins the OOM query starts (the holder's other stage threads
# settle).
EVICT_STALL_S = 2.0
EVICT_SETTLE_S = 0.3


def _reset_semaphore(stores) -> None:
    """Drop the process-wide device semaphore: the next collect makes it
    anew at its conf's ``concurrentTpuTasks`` (it is sized once)."""
    with stores._GLOBAL_SEM_LOCK:
        stores._GLOBAL_SEM = None


def _cuda_tensor_census() -> dict:
    """(shape, dtype) -> count of the CUDA tensors the garbage collector
    can reach (a diagnostic of what holds device memory)."""
    import gc
    import torch
    out: dict = {}
    for o in gc.get_objects():
        try:
            if isinstance(o, torch.Tensor) and o.is_cuda:
                k = (tuple(o.shape), str(o.dtype))
                out[k] = out.get(k, 0) + 1
        except Exception:
            continue
    return out


def _settled_allocated() -> int:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def scheduler_phase(native, df_out: dict, ex_out: dict, smi: str) -> dict:
    """Phase 26 (runs after phase 25, over phase 11's tables; oracles of
    phases 11 and 16): (a) concurrency under the semaphore, (b) cancel
    and deadline, (c) shedding and retries, (d) preemption, (e)
    cross-query eviction. See the module doc."""
    import threading
    import traceback
    import torch
    from spark_rapids_tpu_torch import faults, monitoring
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.memory import oom, stores
    from spark_rapids_tpu_torch.parallel import scheduler as SC
    t_phase = time.perf_counter()
    tables = df_out["tables"]
    oracles = dict(df_out["oracles"])
    oracles["q18"] = ex_out["oracles"]["q18"]
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}
    out = {"runs": []}
    stall_default = faults.STALL_TIMEOUT_S

    def frame(conf, q):
        session = TpuSession(conf)
        return tpch.QUERIES[q](session, _rebound(session, tables[q]))

    def checked(df, q, rows):
        check, want = oracles[q]
        check(rows, want)
        ctx = df._physical().last_ctx
        if ctx.last_leak_report:
            raise AssertionError(f"phase 26 {q}: leaked "
                                 f"{ctx.last_leak_report}")
        return ctx

    def join_all(threads, label, timeout=120):
        for t in threads:
            t.join(timeout)
            if t.is_alive():
                raise AssertionError(f"phase 26 {label}: a query thread "
                                     f"still runs after {timeout} s")

    try:
        # (a) Concurrency at maxConcurrentQueries 2, concurrentTpuTasks 2.
        conf = dict(vfa, **{"spark.rapids.sql.trace.enabled": True,
                            "spark.rapids.sql.trace.level": "query"})
        frames = {q: frame(conf, q) for q in SCHED_QUERIES}
        sem = stores.get_tpu_semaphore(2)
        if sem.permits != 2:
            raise AssertionError(f"(a) the device semaphore has "
                                 f"{sem.permits} permits, not 2")
        serial = {}
        native.reset_counters()
        t0 = time.perf_counter()
        for q in SCHED_QUERIES:
            t1 = time.perf_counter()
            rows = frames[q].collect()
            torch.cuda.synchronize()
            serial[q] = time.perf_counter() - t1
            checked(frames[q], q, rows)
        serial_wall = time.perf_counter() - t0
        out["runs"].append(native.counters())

        def concurrent_turn(slots, frames):
            """The four queries from four threads at once at ``slots``
            admission slots and the semaphore's 2 permits: rows against
            the oracles, one ``queued`` acquire span a query, the most
            permit holders and admitted queries at once (a thread samples
            both every millisecond), K1, K3 and K4 launched."""
            mgr = SC.get_query_manager(frames[SCHED_QUERIES[0]]._session.conf)
            if mgr.max_concurrent != slots:
                raise AssertionError(f"(a) the query manager has "
                                     f"{mgr.max_concurrent} slots, not "
                                     f"{slots}")
            SC.reset_counters()
            monitoring.reset()
            sem.reset_peak()
            native.reset_counters()
            results, errors = {}, {}
            barrier = threading.Barrier(len(SCHED_QUERIES), timeout=60)
            stop = threading.Event()
            peak = {"admitted": 0, "holders": 0}

            def run(q):
                try:
                    barrier.wait()
                    results[q] = frames[q].collect()
                except BaseException as e:
                    errors[q] = e

            def sample():
                while not stop.wait(0.001):
                    peak["admitted"] = max(peak["admitted"],
                                           mgr.active_count)
                    peak["holders"] = max(peak["holders"], sem.in_use)

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            threads = [threading.Thread(target=run, args=(q,), daemon=True)
                       for q in SCHED_QUERIES]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            try:
                join_all(threads, "(a)")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                stop.set()
                join_all([sampler], "(a) sampler", timeout=5)
            launches = native.counters()
            out["runs"].append(launches)
            if errors:
                raise AssertionError(f"(a) concurrent collects at {slots} "
                                     f"slots failed: {errors}")
            queued = {}
            for q in SCHED_QUERIES:
                ctx = checked(frames[q], q, results[q])
                qid = ctx.cache["trace_query"]
                spans = [e for e in monitoring.events(qid)
                         if e[0] == "X" and e[1] == "tpu-semaphore-acquire"]
                if len(spans) != 1 or spans[0][2] != "queued":
                    raise AssertionError(f"(a) {q}: semaphore spans {spans}")
                queued[q] = spans[0][4] / 1e6
            if not 1 <= sem.max_in_use <= 2 or peak["holders"] > 2:
                raise AssertionError(f"(a) {sem.max_in_use} permit holders "
                                     f"at once (sampled {peak['holders']}) "
                                     f"against 2 permits at {slots} slots")
            missing = [k for k in ("radix_sort", "join_probe", "rle_decode")
                       if launches[k] <= 0]
            if missing:
                raise AssertionError(f"(a) no launch of {missing} in the "
                                     f"concurrent run at {slots} slots: "
                                     f"{launches}")
            sched = SC.counters()
            turn = dict(wall=wall, max_in_use=sem.max_in_use,
                        sampled_admitted=peak["admitted"],
                        sampled_holders=peak["holders"], queued_ms=queued,
                        admission_queued_ms=sched.get("queuedMs", 0),
                        launches=launches)
            log(f"phase 26 (a) {', '.join(SCHED_QUERIES)} from 4 threads "
                f"at maxConcurrentQueries {slots}, concurrentTpuTasks 2: "
                f"rows match; concurrent wall {wall:.4f} s; most permit "
                f"holders at once {sem.max_in_use}; sampled at once: "
                f"admitted {peak['admitted']}, permit holders "
                f"{peak['holders']}; semaphore queued ms "
                f"{ {q: round(v, 3) for q, v in queued.items()} }; "
                f"admission queued ms {sched.get('queuedMs', 0):.3f}; "
                f"launches {launches}; {smi}")
            return turn

        at2 = concurrent_turn(2, frames)
        # At 4 admission slots, admission no longer keeps the queries on
        # the card to 2: the semaphore's permits are what bounds them.
        conf4 = dict(conf, **{
            "spark.rapids.sql.scheduler.maxConcurrentQueries": 4})
        at4 = concurrent_turn(4, {q: frame(conf4, q) for q in SCHED_QUERIES})
        if at4["sampled_admitted"] < 3:
            raise AssertionError(
                f"(a) at 4 slots at most {at4['sampled_admitted']} queries "
                f"were admitted at once: the permits were not contended")
        out["concurrency"] = dict(serial=serial, serial_wall=serial_wall,
                                  concurrent_wall=at2["wall"], at2=at2,
                                  at4=at4)
        log(f"phase 26 (a) serial walls "
            f"{ {q: round(w, 4) for q, w in serial.items()} } (sum "
            f"{serial_wall:.4f} s); concurrent walls {at2['wall']:.4f} s "
            f"at 2 slots, {at4['wall']:.4f} s at 4 slots; {smi}")
        monitoring.configure(False)
        monitoring.reset()

        # (b) Cancel and deadline on a stalled query.
        def stalled(q, tag):
            return frame(dict(vfa, **{
                "spark.rapids.sql.test.faults": f"stall@kernel/query={tag}:1",
                "spark.rapids.sql.test.faults.seed": 7,
                "spark.rapids.sql.test.faults.queryTag": tag}), q)

        def back_to(base, label, census):
            got = _settled_allocated()
            if got != base:
                after = _cuda_tensor_census()
                new = {k: v for k, v in after.items()
                       if v > census.get(k, 0)}
                raise AssertionError(f"(b) {label}: {got} B allocated "
                                     f"against {base} B before the query; "
                                     f"tensors now alive beyond those "
                                     f"before (shape, dtype): {new}")
            return got

        mgr = SC.get_query_manager(frames["q3"]._session.conf)
        frames["q3"].collect()              # warm: the rows' plan is made
        base = _settled_allocated()
        census = _cuda_tensor_census()
        faults.configure("")
        faults.reset_counters()
        df = stalled("q3", TAG_CANCEL)
        handle = df.submit()
        deadline = time.monotonic() + STALL_FOUND_S
        while not faults.counters().get("faultsInjected.stall@kernel") \
                and time.monotonic() < deadline and not handle.done():
            time.sleep(0.005)
        t0 = time.perf_counter()
        handle.cancel()
        try:
            handle.result(60)
            raise AssertionError("(b) the cancelled q3 returned rows")
        except faults.QueryCancelledError:
            cancel_s = time.perf_counter() - t0
        ctx = df._physical().last_ctx
        if ctx.last_leak_report != [] or \
                ctx.metrics["Scheduler@query"].values.get("cancelled") != 1:
            raise AssertionError(f"(b) cancel: leak {ctx.last_leak_report},"
                                 f" {ctx.metrics['Scheduler@query']}")
        # The handle's error holds the unwound frames (and their tensors)
        # until the caller drops it; the plan goes with the DataFrame.
        del handle, df, ctx
        back_to(base, "cancel", census)
        faults.configure("")
        df = stalled("q6", TAG_DEADLINE)
        t0 = time.perf_counter()
        try:
            df.collect(timeout_ms=300)
            raise AssertionError("(b) the deadlined q6 returned rows")
        except faults.QueryCancelledError as e:
            if "deadline exceeded" not in str(e):
                raise
            deadline_s = time.perf_counter() - t0
            traceback.clear_frames(e.__traceback__)
        ctx = df._physical().last_ctx
        if ctx.last_leak_report != [] or mgr.active_count:
            raise AssertionError(f"(b) deadline: leak "
                                 f"{ctx.last_leak_report}")
        del df, ctx
        back_to(base, "deadline", census)
        faults.configure("")
        out["cancel"] = dict(cancel_s=cancel_s, deadline_s=deadline_s,
                             allocated=base)
        log(f"phase 26 (b) q3 cancelled mid-stall: QueryCancelledError "
            f"{cancel_s:.3f} s after cancel(); q6 under timeout_ms=300: "
            f"deadline exceeded after {deadline_s:.3f} s; leak reports "
            f"[], {base} B allocated before and after each; {smi}")

        # (c) Shedding and retries.
        shed_conf = dict(vfa, **{
            "spark.rapids.sql.scheduler.maxConcurrentQueries": 1,
            "spark.rapids.sql.scheduler.queueDepth": 0})
        df = frame(shed_conf, "q6")
        mgr = SC.get_query_manager(df._session.conf)
        if (mgr.max_concurrent, mgr.queue_depth) != (1, 0):
            raise AssertionError("(c) the manager was not resized")
        SC.reset_counters()
        hog = mgr.admit()
        try:
            df.collect()
            raise AssertionError("(c) a collect was admitted past a full "
                                 "queue")
        except SC.QueryRejectedError as e:
            if e.kind != "queue-full" or not e.retry_after_ms:
                raise
            hint = e.retry_after_ms
        timer = threading.Timer(0.3, mgr.finish, args=(hog,))
        timer.start()
        t0 = time.perf_counter()
        rows = df.collect_with_retry()
        retry_s = time.perf_counter() - t0
        timer.join(10)
        checked(df, "q6", rows)
        retries = SC.counters().get("clientRetries", 0)
        if retries < 1:
            raise AssertionError("(c) collect_with_retry never retried")
        out["shed"] = dict(hint_ms=hint, retries=retries, wall=retry_s)
        log(f"phase 26 (c) queueDepth 0, the slot held: QueryRejectedError "
            f"queue-full, retry_after_ms {hint}; collect_with_retry "
            f"finished in {retry_s:.3f} s after {retries:.0f} retries, "
            f"rows match; {smi}")

        # (d) Preemption: a background q18 at 8 partitions, an interactive
        # q6, the semaphore at one permit.
        qos = dict(vfa, **{
            "spark.rapids.sql.shuffle.partitions": ADAPTIVE_PARTITIONS,
            "spark.rapids.sql.scheduler.qos.enabled": True,
            "spark.rapids.sql.scheduler.preemption.enabled": True,
            "spark.rapids.sql.concurrentTpuTasks": 1})
        _reset_semaphore(stores)
        solo = frame(qos, "q18")
        solo_rows = solo.collect()
        checked(solo, "q18", solo_rows)
        sem = stores.get_tpu_semaphore(1)
        pre = None
        for attempt in range(3):
            SC.reset_counters()
            bg = frame(qos, "q18")
            handle = bg.submit(priority="background")
            deadline = time.monotonic() + 30
            while not sem.holders and not handle.done() \
                    and time.monotonic() < deadline:
                time.sleep(0.0005)
            fg = frame(qos, "q6")
            t0 = time.perf_counter()
            fg_rows = fg.collect(priority="interactive")
            fg_s = time.perf_counter() - t0
            bg_rows = handle.result(120)
            checked(fg, "q6", fg_rows)
            ctx = checked(bg, "q18", bg_rows)
            m = dict(ctx.metrics["Scheduler@query"].values)
            if m.get("preemptions", 0) >= 1:
                pre = dict(attempt=attempt + 1, metrics=m, fg_s=fg_s,
                           requests=sem.preempt_requests)
                break
        if pre is None:
            raise AssertionError("(d) no preemption in 3 attempts")
        if pre["metrics"].get("resumedStages", 0) < 1:
            raise AssertionError(f"(d) resumed no stage: {pre}")
        if bg_rows != solo_rows:
            raise AssertionError("(d) the preempted q18's rows differ from "
                                 "its solo run's")
        out["preempt"] = pre
        log(f"phase 26 (d) background q18 at {ADAPTIVE_PARTITIONS} "
            f"partitions preempted by an interactive q6 (attempt "
            f"{pre['attempt']}): Scheduler@query "
            f"{ {k: round(v, 3) for k, v in pre['metrics'].items()} }; "
            f"q6 {fg_s:.4f} s; rows bit for bit the solo run's; {smi}")
        _reset_semaphore(stores)

        # (e) Cross-query eviction: q18 stalled holding its pieces, q6
        # under an injected OOM.
        spec = (f"stall@exchange.serve/query={TAG_HOLDER}:1,"
                f"oom@upload/query={TAG_OOM}:2")
        chaos = dict(vfa, **{"spark.rapids.sql.test.faults": spec,
                             "spark.rapids.sql.test.faults.seed": 7})
        holder = frame(dict(chaos, **{
            "spark.rapids.sql.shuffle.partitions": ADAPTIVE_PARTITIONS,
            "spark.rapids.sql.test.faults.queryTag": TAG_HOLDER}), "q18")
        victim_of_oom = frame(dict(chaos, **{
            "spark.rapids.sql.test.faults.queryTag": TAG_OOM}), "q6")
        faults.configure("")
        faults.reset_counters()
        SC.reset_counters()
        faults.STALL_TIMEOUT_S = EVICT_STALL_S
        handle = holder.submit()
        deadline = time.monotonic() + STALL_FOUND_S
        while not faults.counters().get(
                "faultsInjected.stall@exchange.serve") \
                and time.monotonic() < deadline and not handle.done():
            time.sleep(0.002)
        time.sleep(EVICT_SETTLE_S)
        t0 = time.perf_counter()
        rows = victim_of_oom.collect()
        oom_s = time.perf_counter() - t0
        ladder = list(oom.last_ladder)
        checked(victim_of_oom, "q6", rows)
        held = handle.result(120)
        faults.STALL_TIMEOUT_S = stall_default
        hctx = checked(holder, "q18", held)
        c = SC.counters()
        ev = dict(evictions=c.get("crossQueryEvictions", 0),
                  catalog_bytes=c.get("crossQueryEvictedBytes", 0),
                  allocator_bytes=c.get("crossQueryAllocatorBytes", 0),
                  ladder=ladder, oom_s=oom_s,
                  holder_recovery=dict(
                      hctx.metrics["Recovery@query"].values))
        if ev["evictions"] < 1 or "evict-neighbors" not in ladder \
                or ev["allocator_bytes"] <= 0:
            raise AssertionError(f"(e) no eviction freed the card: {ev}")
        out["evict"] = ev
        log(f"phase 26 (e) q18 at {ADAPTIVE_PARTITIONS} partitions stalled "
            f"at exchange.serve, q6 under oom@upload: q6's ladder "
            f"{ladder}, {oom_s:.3f} s; crossQueryEvictions "
            f"{ev['evictions']:.0f}, {ev['catalog_bytes']:.0f} catalog B, "
            f"allocated bytes fell by {ev['allocator_bytes']:.0f} B; q18 "
            f"Recovery@query {ev['holder_recovery']}; both match their "
            f"oracles; {smi}")
    finally:
        faults.configure("")
        faults.STALL_TIMEOUT_S = stall_default
        monitoring.configure(False)
        monitoring.reset()
        _reset_semaphore(stores)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 26 took {out['seconds']:.1f} s; {smi}")
    return out


_T_START = [time.perf_counter()]


# ---------------------------------------------------------------------------
# Phase 27: cost-based placement with the card's constants, and the shuffle
# transport SPI (inprocess, hostfile with its rendezvous, objectstore)
# ---------------------------------------------------------------------------

COST_SWEEP = (0.1, 0.3, 1.0)
COST_ROUNDS = 2
TRANSPORT_QUERIES = ("q3", "q18")
TRANSPORT_PARTS = 8
REPART_SCHEMA_NAMES = ("l_orderkey", "l_quantity")


def _repart_exchange(schema, parts, n_parts: int):
    """A hash repartition of ``parts`` (host batches) on column 0 into
    ``n_parts``, as its own exchange over an in-memory source on the
    card."""
    from spark_rapids_tpu_torch.exprs.base import BoundReference
    from spark_rapids_tpu_torch.ops.base import InMemorySourceExec
    from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.parallel.partitioning import \
        HashPartitioning
    return ShuffleExchangeExec(
        InMemorySourceExec(schema, parts),
        HashPartitioning([BoundReference(0, schema[0][1])], n_parts))


def _repart_parts(keys, vals, n_parts: int) -> list:
    from spark_rapids_tpu_torch import entry as E
    from spark_rapids_tpu_torch.columnar import dtypes as dt
    schema = ((REPART_SCHEMA_NAMES[0], dt.INT64),
              (REPART_SCHEMA_NAMES[1], dt.FLOAT64))
    return schema, E.table_partitions(
        {REPART_SCHEMA_NAMES[0]: keys, REPART_SCHEMA_NAMES[1]: vals},
        schema, n_parts)


def _repart_worker(spool, tag, worker, rv, keys, vals, n_parts, go, done,
                   results):
    """Phase 27 (e)'s worker process (started with ``spawn``, its own
    CUDA context): once ``go`` is set, its half of LINEITEM's two
    columns, repartitioned on the card by the exchange's map side into
    the shared hostfile spool under ``tag``; the commit is announced over
    the rendezvous. Starts its CUDA context before ``go``, so its start
    overlaps the parent's earlier work. Waits for ``done`` before its
    teardown removes what it wrote."""
    sys.path.insert(0, HERE)
    try:
        import torch
        torch.zeros(1, device="cuda")
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.ops import native
        from spark_rapids_tpu_torch.ops.base import ExecContext
        from spark_rapids_tpu_torch.parallel.transport.hostfile import \
            HostFileTransport
        schema, parts = _repart_parts(keys, vals, 4)
        ex = _repart_exchange(schema, parts, n_parts)
        conf = C.TpuConf({
            C.SHUFFLE_TRANSPORT.key: "hostfile",
            C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: spool,
            C.SHUFFLE_TRANSPORT_HOSTFILE_WORKER_ID.key: worker,
            C.SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS.key: rv})
        ctx = ExecContext(conf)
        # One tag for both workers' sessions (an exchange's own tag names
        # its process), so the parent fetches their union.
        ex._open_session = lambda c: HostFileTransport().open(
            conf, tag, n_parts, owner=id(ex), catalog=c.catalog,
            device=ex.plan_device())
        if not go.wait(300):
            raise TimeoutError("no go from the parent in 300 s")
        native.reset_counters()
        t0 = time.perf_counter()
        sess = ex._materialize_device(ctx)
        torch.cuda.synchronize()
        results.put((worker, dict(
            ok=True, write_s=time.perf_counter() - t0,
            launches=native.counters(), shards=sum(
                len(v) for v in sess._written.values()),
            bytes=sess.observed_bytes(),
            device=torch.cuda.get_device_name(0))))
        done.wait(300)
        ctx.close()
    except BaseException as e:      # reported to the parent, which fails
        import traceback
        results.put((worker, dict(ok=False, error="".join(
            traceback.format_exception(e)))))


def _partition_arrays(batches) -> tuple:
    """The live rows of one partition's served batches, as (keys, vals)
    numpy arrays in serve order."""
    from spark_rapids_tpu_torch.columnar.host import device_to_host
    ks, vs = [], []
    for b in batches:
        hb = device_to_host(b)
        ks.append(hb.columns[0].data)
        vs.append(hb.columns[1].data)
    return (np.concatenate(ks) if ks else np.zeros(0, np.int64),
            np.concatenate(vs) if vs else np.zeros(0, np.float64))


def transport_phase(native, cols: dict, df_out: dict, ex_out: dict,
                    smi: str) -> dict:
    """Phase 27: (a) the cost model's three constants measured on the
    card, the host-against-device break-even sweep of a q6-shaped
    aggregate and the fitted query floor (``cost_sweep.py``), the
    defaults' break-even within 2x of the measured one; (b) q1-q6 from
    parquet at SF1 under the default conf, placement on and off: each
    query's placements, rows against phase 11's oracles; (c) q3 and q18 at 8 partitions through ``hostfile`` and
    through ``objectstore`` against the stub, rows bit for bit those of
    ``inprocess``, with K1 / K3 / K4 launches; (d) a spool file deleted
    mid-query, recovered by a stage recompute with the same rows; (e)
    two worker processes on the card write a LINEITEM repartition (two
    columns) that this process fetches, equal to its own in-process
    result; the spool empty afterwards."""
    import multiprocessing
    import shutil
    import tempfile
    import torch
    from spark_rapids_tpu_torch import config as C
    from spark_rapids_tpu_torch import cost_sweep as CS
    from spark_rapids_tpu_torch import faults
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.base import ExecContext
    from spark_rapids_tpu_torch.parallel import transport as T
    from spark_rapids_tpu_torch.parallel.exchange import ShuffleExchangeExec
    from spark_rapids_tpu_torch.parallel.transport import rendezvous as RV
    from spark_rapids_tpu_torch.parallel.transport.hostfile import \
        HostFileTransport
    from spark_rapids_tpu_torch.parallel.transport.objectstore import \
        ObjectStoreStub
    from spark_rapids_tpu_torch.plan import cost as COST
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="srt_phase27_")
    out = {"runs": []}
    oracles = dict(df_out["oracles"])
    oracles["q18"] = ex_out["oracles"]["q18"]
    vfa = {"spark.rapids.sql.variableFloatAgg.enabled": True}

    def spool_files(d):
        return [os.path.join(a, f) for a, _, fs in os.walk(d) for f in fs]

    procs, srv = [], None
    try:
        # (b)'s tables, written once: (a) reads LINEITEM at SF1 there.
        t0 = time.perf_counter()
        data_dir = os.path.join(root, "tpch")
        CS.write_tables(cols, data_dir, DF_QUERIES)
        log(f"phase 27 q1-q6 tables written with pyarrow in "
            f"{time.perf_counter() - t0:.1f} s")

        # (a) The constants and the break-even sweep.
        t0 = time.perf_counter()
        COST.reset_calibration()
        cs = CS.run(cols, 1.0, COST_SWEEP, COST_ROUNDS, None, root,
                    data_dir=data_dir)
        m = cs["constants"]
        log(f"phase 27 (a) constants on {smi}: sync span mean "
            f"{m['sync_mean_ms']} ms over {m['syncs']} syncs (q1, q6 from "
            f"parquet, SF1, traced); upload {m['upload_bytes']:.0f} B at "
            f"{m['device_gbps']} GB/s; host engine q6 {m['host_q6_ms']:.2f} "
            f"ms over {m['model_bytes']:.0f} model bytes, {m['model_nodes']} "
            f"nodes: {m['host_gbps']} GB/s; per query {m['per_query']}")
        for pt in cs["sweep"]["points"]:
            hw = [round(w, 3) for w in pt["host_walls_ms"]]
            dw = [round(w, 3) for w in pt["device_walls_ms"]]
            log(f"phase 27 (a) sweep sf {pt['sf']}: {pt['rows']} rows, "
                f"{pt['bytes']} model bytes, {pt['syncs']} syncs; host "
                f"{pt['host_ms']:.3f} ms {hw}, device "
                f"{pt['device_ms']:.3f} ms {dw}; model "
                f"host {pt['model_host_ms']:.3f}, device "
                f"{pt['model_device_ms']:.3f} ms")
        meas = cs["sweep"]["measured_break_even_sf"]
        dflt = cs["sweep"]["default_break_even_sf"]
        log(f"phase 27 (a) break-even: measured sf {meas}, model sf "
            f"{cs['sweep']['model_break_even_sf']} at "
            f"{cs['model_constants']} without a query floor; fitted query "
            f"floor {cs.get('fitted_query_floor_ms')} ms; at the defaults "
            f"(sync {C.COST_SYNC_FLOOR_MS.default} ms, query "
            f"{C.COST_QUERY_FLOOR_MS.default} ms, "
            f"{C.COST_DEVICE_GBPS.default} GB/s, "
            f"{C.COST_HOST_GBPS.default} GB/s) sf {dflt} "
            f"({time.perf_counter() - t0:.1f} s)")
        # The defaults must still put q6's break-even within 2x of where
        # this card's walls cross.
        if meas is None or dflt is None or \
                max(meas, dflt) / min(meas, dflt) > 2.0:
            raise AssertionError(
                f"phase 27 (a): the defaults' break-even sf {dflt} is not "
                f"within 2x of the measured sf {meas}")
        out["cost"] = cs
        COST.reset_calibration()

        # (b) q1-q6 from parquet at SF1 under the default conf.
        t0 = time.perf_counter()
        out["placements"] = {}
        # The scan cache off in both runs (each reads the files) and the
        # order alternating by query; single runs: the placement walls
        # are compared by ``cost_sweep.py --placement``.
        confs = {"on": dict(_NO_SCAN_CACHE),
                 "off": dict(_NO_SCAN_CACHE,
                             **{"spark.rapids.sql.cost.enabled": False})}
        for i, q in enumerate(DF_QUERIES):
            check, want = oracles[q]
            runs = {}
            for label in (("on", "off") if i % 2 == 0 else ("off", "on")):
                phys = tpch.QUERIES[q](TpuSession(confs[label]),
                                       data_dir)._physical()
                native.reset_counters()
                t1 = time.perf_counter()
                rows = phys.collect()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                launches = native.counters()
                out["runs"].append(launches)
                check(rows, want)
                runs[label] = dict(phys=phys, wall=wall, launches=launches,
                                   rows=len(rows))
            rep = runs["on"]["phys"].cost_report
            out["placements"][q] = dict(
                placements=rep.placements, nodes=rep.nodes_host_placed,
                est_device_ms=rep.est_device_ms,
                est_host_ms=rep.est_host_ms, syncs=rep.est_syncs,
                root_on_device=runs["on"]["phys"].root_on_device,
                host_nodes=runs["on"]["phys"].host_fallback_nodes(),
                **{f"{k}_{m}": runs[k][m] for k in runs
                   for m in ("wall", "launches")})
            log(f"phase 27 (b) {q} from parquet, default conf: "
                f"{rep.placements} host placement(s) ({rep.nodes_host_placed}"
                f" nodes: host nodes "
                f"{runs['on']['phys'].host_fallback_nodes()}), est device "
                f"{rep.est_device_ms:.2f} ms ({rep.est_syncs} syncs) vs host "
                f"{rep.est_host_ms:.2f} ms, root on the "
                f"{'device' if runs['on']['phys'].root_on_device else 'host'}"
                f"; both runs match the oracle ({runs['on']['rows']} rows); "
                f"scan cache off, one run each: placement on "
                f"{runs['on']['wall']:.3f} s, launches "
                f"{runs['on']['launches']}; placement off "
                f"{runs['off']['wall']:.3f} s, launches "
                f"{runs['off']['launches']}")

        # (e)'s two worker processes start here, so their CUDA contexts
        # come up while (c) and (d) run; they write once ``go`` is set.
        spool = os.path.join(root, "spool")
        li = cols["lineitem"]
        keys = np.ascontiguousarray(li["l_orderkey"])
        vals = np.ascontiguousarray(li["l_quantity"], dtype=np.float64)
        half = len(keys) // 2
        n_parts = TRANSPORT_PARTS
        tag = "lineitem-repart"
        srv = RV.RendezvousServer()
        rv = f"{srv.addr[0]}:{srv.addr[1]}"
        mp = multiprocessing.get_context("spawn")
        go, done, results = mp.Event(), mp.Event(), mp.Queue()
        procs = [mp.Process(target=_repart_worker, args=(
            spool, tag, w, rv, keys[lo:hi], vals[lo:hi], n_parts, go, done,
            results)) for w, lo, hi in (("w0", 0, half),
                                        ("w1", half, len(keys)))]
        for pr in procs:
            pr.start()

        # (c) q3 and q18 at 8 partitions through the three transports.
        t0 = time.perf_counter()
        stub = ObjectStoreStub()
        base_tables = tpch.tpch_tables(TpuSession(vfa), cols,
                                       TRANSPORT_QUERIES)
        inprocess_rows = {}
        try:
            out["transports"] = {}
            for q in TRANSPORT_QUERIES:
                check, want = oracles[q]
                base = None
                for name in ("inprocess", "hostfile", "objectstore"):
                    conf = dict(vfa, **{
                        "spark.rapids.sql.shuffle.partitions":
                            TRANSPORT_PARTS,
                        C.SHUFFLE_TRANSPORT.key: name,
                        C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: spool,
                        C.SHUFFLE_TRANSPORT_OBJECTSTORE_ENDPOINT.key:
                            stub.endpoint})
                    session = TpuSession(conf)
                    df = tpch.QUERIES[q](session, _rebound(
                        session, base_tables[q]))
                    T.reset_counters()
                    native.reset_counters()
                    t1 = time.perf_counter()
                    rows = df.collect()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t1
                    launches = native.counters()
                    out["runs"].append(launches)
                    check(rows, want)
                    if base is None:
                        base = inprocess_rows[q] = rows
                    elif rows != base:
                        raise AssertionError(
                            f"phase 27 (c) {q} through {name} differs from "
                            f"inprocess: {rows[:3]} vs {base[:3]}")
                    tc = T.counters()
                    left = spool_files(spool) + stub.keys()
                    if left:
                        raise AssertionError(f"phase 27 (c) {q} {name} "
                                             f"left {left[:5]}")
                    out["transports"][(q, name)] = dict(
                        wall_s=wall, launches=launches, transport=tc)
                    log(f"phase 27 (c) {q} x{TRANSPORT_PARTS} through "
                        f"{name}: rows bit for bit inprocess's "
                        f"({len(rows)}), {wall:.3f} s; K1 "
                        f"{launches['radix_sort']}, K3 "
                        f"{launches['join_probe']}, K4 "
                        f"{launches['rle_decode']}; transport {tc}")
        finally:
            stub.close()
        log(f"phase 27 (c) {time.perf_counter() - t0:.1f} s")

        # (d) A spool file deleted under a running query.
        t0 = time.perf_counter()
        deleted = []
        orig = ShuffleExchangeExec._materialize_device_traced

        def materialize_then_lose(self, ctx, key):
            sess = orig(self, ctx, key)
            if not deleted:
                victims = sorted(f for f in spool_files(sess.root)
                                 if f.endswith(".shard"))
                if victims:
                    os.remove(victims[0])
                    deleted.append(victims[0])
            return sess

        conf = dict(vfa, **{
            "spark.rapids.sql.shuffle.partitions": TRANSPORT_PARTS,
            C.SHUFFLE_TRANSPORT.key: "hostfile",
            C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: spool})
        session = TpuSession(conf)
        df = tpch.QUERIES["q3"](session, _rebound(session,
                                                  base_tables["q3"]))
        ShuffleExchangeExec._materialize_device_traced = \
            materialize_then_lose
        faults.reset_counters()
        try:
            native.reset_counters()
            rows = df.collect()
            torch.cuda.synchronize()
        finally:
            ShuffleExchangeExec._materialize_device_traced = orig
        out["runs"].append(native.counters())
        rec = df.metrics().get("Recovery@query", {})
        if rows != inprocess_rows["q3"]:
            raise AssertionError(f"phase 27 (d) rows differ from "
                                 f"inprocess: {rows[:3]}")
        if len(deleted) != 1 or rec.get("stageRecomputes") != 1:
            raise AssertionError(f"phase 27 (d): deleted {deleted}, "
                                 f"recovery {rec}")
        if spool_files(spool):
            raise AssertionError(f"phase 27 (d) left {spool_files(spool)}")
        log(f"phase 27 (d) q3 through hostfile with "
            f"{os.path.basename(deleted[0])} deleted after its stage "
            f"committed: one stage recompute ({rec}), rows bit for bit "
            f"inprocess's, spool empty ({time.perf_counter() - t0:.1f} s)")

        # (e) Two worker processes write a LINEITEM repartition.
        t0 = time.perf_counter()
        try:
            go.set()
            # Its own in-process result meanwhile: the same exchange over
            # both halves in the workers' order.
            schema, p0 = _repart_parts(keys[:half], vals[:half], 4)
            _, p1 = _repart_parts(keys[half:], vals[half:], 4)
            ex = _repart_exchange(schema, p0 + p1, n_parts)
            ctx = ExecContext(C.TpuConf())
            native.reset_counters()
            mine = [_partition_arrays(list(ex.execute_device(ctx, p)))
                    for p in range(n_parts)]
            out["runs"].append(native.counters())
            ctx.close()
            workers = {}
            for _ in procs:
                w, r = results.get(timeout=240)
                if not r["ok"]:
                    raise AssertionError(f"phase 27 (e) worker {w}: "
                                         f"{r['error']}")
                workers[w] = r
            conf = C.TpuConf({
                C.SHUFFLE_TRANSPORT_HOSTFILE_DIR.key: spool,
                C.SHUFFLE_TRANSPORT_HOSTFILE_EXPECTED_WORKERS.key: 2,
                C.SHUFFLE_TRANSPORT_HOSTFILE_RENDEZVOUS.key: rv})
            fctx = ExecContext(conf)
            sess = HostFileTransport().open(conf, tag, n_parts,
                                            catalog=fctx.catalog)
            t1 = time.perf_counter()
            for p in range(n_parts):
                got = _partition_arrays([h.get() for h in
                                         sess.fetch_shards(p)])
                for h in sess.fetch_shards(p):
                    h.release()
                if not (np.array_equal(got[0], mine[p][0]) and
                        np.array_equal(got[1], mine[p][1])):
                    raise AssertionError(
                        f"phase 27 (e) partition {p}: fetched "
                        f"{len(got[0])} rows differ from the in-process "
                        f"{len(mine[p][0])}")
            fetch_s = time.perf_counter() - t1
            sess.close()
            fctx.close()
        finally:
            done.set()
            for pr in procs:
                pr.join(60)
                if pr.is_alive():
                    pr.kill()
                    pr.join(10)
            procs = []
            srv.close()
            srv = None
        left = spool_files(spool)
        if left:
            raise AssertionError(f"phase 27 (e) left {left[:5]}")
        out["workers"] = workers
        log(f"phase 27 (e) two spawned workers ({workers['w0']['device']}) "
            f"wrote {[workers[w]['shards'] for w in ('w0', 'w1')]} shards "
            f"({[workers[w]['bytes'] for w in ('w0', 'w1')]} B) in "
            f"{[round(workers[w]['write_s'], 3) for w in ('w0', 'w1')]} s "
            f"(launches {[workers[w]['launches'] for w in ('w0', 'w1')]}); "
            f"this process fetched all {n_parts} partitions in "
            f"{fetch_s:.3f} s, equal to its in-process result "
            f"({len(keys)} rows); spool empty "
            f"({time.perf_counter() - t0:.1f} s)")
    finally:
        for pr in procs:            # a failure before (e) ended
            pr.kill()
            pr.join(10)
        if srv is not None:
            srv.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return out


def end_phase(name: str) -> None:
    """Clear the plan cache (its templates pin their sources and packed
    encodings) and print the process's peak and current host RSS."""
    import resource
    from spark_rapids_tpu_torch.plan import plan_cache as PC
    n = PC.cache().stats()["entries"]
    PC.cache().clear()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    log(f"{name}: plan cache cleared ({n} template(s)); host RSS "
        f"{rss / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; "
        f"{time.perf_counter() - _T_START[0]:.1f} s into the script")


# ---------------------------------------------------------------------------
# Phase 10: the wire codec, v2 against plain
# ---------------------------------------------------------------------------

def codec_walls(plans: dict) -> dict:
    """Each plan's first wall under plain (its sources pack their batches
    for plain; the default v2 packed in the path's first run), then its
    warm walls under v2 and plain in turns (v2, plain, plain, v2), in this
    one process."""
    import torch
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import ExecContext
    out = {}
    for name, plan in plans.items():
        walls = {"v2": [], "plain": []}
        for i, mode in enumerate(("plain", "v2", "plain", "plain", "v2")):
            ctx = ExecContext(TpuConf({"spark.rapids.sql.wire.codec": mode}))
            t0 = time.perf_counter()
            plan.collect(ctx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if i == 0:
                first_plain = wall
            else:
                walls[mode].append(wall)
        out[name] = dict(walls, first_plain=first_plain)
        log(f"{name} walls by codec: plain first {first_plain:.4f} s; warm "
            f"v2 {walls['v2']} s, plain {walls['plain']} s (mean v2 "
            f"{np.mean(walls['v2']):.4f}, plain "
            f"{np.mean(walls['plain']):.4f})")
    return out


def encode_split(plan, parts) -> dict:
    """Host encode time of one q1 partition, by column, and of the whole
    pack (columns on the encode pool), under v2; the pack must equal the
    one the plan's source kept, byte for byte."""
    from spark_rapids_tpu_torch.columnar import wire
    from spark_rapids_tpu_torch.columnar.batch import bucket_capacity
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.ops import InMemorySourceExec
    wire.maybe_configure(TpuConf({"spark.rapids.sql.wire.codec": "v2"}))
    source = plan
    while not isinstance(source, InMemorySourceExec):
        source = source.children[0]
    path_packed = source.packed(0)[0]
    hb = parts[0][0]
    n = hb.num_rows
    cap = bucket_capacity(n)
    per = {}
    for name, hc in zip(hb.names, hb.columns):
        t0 = time.perf_counter()
        _arrs, spec = wire.encode_column(hc, name, n, cap, None)
        per[name] = (time.perf_counter() - t0, spec)
    t0 = time.perf_counter()
    enc = wire.pack_batch(hb)
    pack_s = time.perf_counter() - t0
    if enc.staging.tobytes() != path_packed.staging.tobytes():
        raise AssertionError("q1 partition 0 packs to other bytes than its "
                             "source kept")
    log(f"q1 partition 0 ({n} rows, cap {cap}) host encode by column: "
        + ", ".join(f"{k} {v[0] * 1e3:.2f} ms {v[1]}" for k, v in per.items())
        + f"; whole pack {pack_s * 1e3:.2f} ms ({enc.nbytes} B staging)")
    return dict(per_column_s={k: v[0] for k, v in per.items()},
                pack_s=pack_s, staging_bytes=enc.nbytes)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "spark_rapids_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "spark_rapids_tpu_torch package is missing)", file=sys.stderr)
        return 2
    t_start = _T_START[0] = time.perf_counter()
    sys.path.insert(0, HERE)
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.ops import cuda_build, native

    # Every kernel gate must be live: no env key may make a run pass
    # without the kernels.
    gates = native.gate_counters()
    if not native.master_enabled() or \
            gates["nativeKernels"] != list(native.KERNELS):
        print(f"chip_smoke: a spark.rapids.sql.native gate is off "
              f"({gates}); every kernel must run", file=sys.stderr)
        return 2

    # Phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")

    # Phase 2: build
    t0 = time.perf_counter()
    libs = cuda_build.build_all(["radix_rank", "join_probe", "seg_scan",
                                 "rle_decode"])
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        ptxas = path.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # Phase 3: kernel K1
    k1 = kernel_phase(native)
    sort_profile_phase(native, k1)

    end_phase("phase 3")

    # Phase 4: TPC-H q1
    path = path_phase(entry, native)

    end_phase("phase 4")

    # Phase 5: kernel K3
    probe_phase(native)

    end_phase("phase 5")

    # Phase 6: TPC-H q3 and q4
    t0 = time.perf_counter()
    cols = entry.tpch_columns(1.0, seed=0)
    log(f"TPC-H SF1 columns generated in {time.perf_counter() - t0:.2f} s")
    joins = join_paths_phase(entry, native, cols)

    end_phase("phase 6")

    # Phase 7: kernel K2
    seg_phase(native)

    end_phase("phase 7")

    # Phase 8: TPC-H q2
    q2 = q2_phase(entry, native, cols)

    end_phase("phase 8")

    # Phase 9: kernel K4
    rle_phase(native)

    end_phase("phase 9")

    # Phase 10: the wire codec, v2 against plain
    codec_walls({"q1": path["plan"], "q3": joins["plans"]["q3"],
                 "q4": joins["plans"]["q4"], "q2": q2["plan"]})
    encode_split(path["plan"], path["parts"])

    end_phase("phase 10")

    # Phase 11: TPC-H q1-q6 through the DataFrame front end
    df = dataframe_phase(native, cols, {
        "q1": (path["plan"], path["launches"]),
        "q3": (joins["plans"]["q3"], joins["q3"]["launches"]),
        "q4": (joins["plans"]["q4"], joins["q4"]["launches"]),
        "q2": (q2["plan"], q2["launches"])}, joins["seen"] + [q2["seen"]])

    end_phase("phase 11")

    # Phase 12: TPC-H q1-q6 under the default conf
    mixed = default_conf_phase(native, cols, joins["seen"] + [q2["seen"]]
                               + [df[q]["seen"] for q in DF_QUERIES], df)

    end_phase("phase 12")

    # Phase 13: TPCxBB q5 and TPC-H q7, q8, q9, q12, q14, q19, both confs
    known_k1 = set(K1_CHECKED) | {r["shape"] for r in mixed["kernel_checks"]
                                  if r["kernel"] == "radix_sort"}
    more = more_queries_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)

    end_phase("phase 13")

    # Phase 14: TPC-DS q67, ds_q3, ds_q42, ds_q55, ds_q89, ds_q98, both
    # confs
    ds = ds_queries_phase(native, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)

    end_phase("phase 14")

    # Phase 15: TPCxBB xbb_q12 and TPC-H q10, q13, q16, q17, q18, q21,
    # both confs
    dq = distinct_queries_phase(native, cols, joins["seen"] + [q2["seen"]]
                                + [df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)

    end_phase("phase 15")

    # Phase 16: the exchange, the shuffled and nested-loop joins, repart,
    # q11, q15, q20 and q22, and every query at 8 partitions
    ex = exchange_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1)
    ex_runs = [k for k in ex if k not in ("kernel_checks", "seconds",
                                          "oracles")]

    end_phase("phase 16")

    # Phase 18: the memory tier and out-of-core execution
    ooc = out_of_core_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex) for c in ph["kernel_checks"]
        if c["kernel"] == "radix_sort"})

    end_phase("phase 18")

    # Phase 19: the numeric, date-time and row-source surface
    rs = rowsource_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex) for c in ph["kernel_checks"]
        if c["kernel"] == "radix_sort"})

    end_phase("phase 19")

    # Phase 20: the string surface and generate
    st = string_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex, rs)
        for c in ph["kernel_checks"] if c["kernel"] == "radix_sort"})

    end_phase("phase 20")

    # Phase 21: the UDF tier
    ud = udf_phase(native, cols, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex, rs, st)
        for c in ph["kernel_checks"] if c["kernel"] == "radix_sort"})

    end_phase("phase 21")

    # Phase 22: file I/O and plan-text ingest
    fi = file_phase(native, cols, df, joins["seen"] + [q2["seen"]] + [
        df[q]["seen"] for q in DF_QUERIES] + [
        mixed[q]["seen"] for q in DF_QUERIES], known_k1 | {
        c["shape"] for ph in (more, ds, dq, ex, rs, st, ud)
        for c in ph["kernel_checks"] if c["kernel"] == "radix_sort"})
    end_phase("phase 22")

    # Phase 23: the gates, the plan cache with bind slots, stage fusion
    import shutil
    try:
        pp = prepared_phase(native, cols, df, ds, fi, smi)
    finally:
        shutil.rmtree(fi["root"], ignore_errors=True)
    end_phase("phase 23")

    # Phase 24: the observability layer and the fault-injection registry
    ob = observability_phase(native, df, smi)
    end_phase("phase 24")

    # Phase 25: the runtime re-plan, the recovery ladder, concurrent stages
    # and the partial skip
    ad = adaptive_phase(native, cols, df, ex, smi)
    end_phase("phase 25")

    # Phase 26: the multi-query scheduler, QoS admission and the device
    # semaphore
    sc = scheduler_phase(native, df, ex, smi)
    end_phase("phase 26")

    # Phase 27: cost-based placement with the card's constants and the
    # shuffle transports
    tp = transport_phase(native, cols, df, ex, smi)
    end_phase("phase 27")

    # Phase 17: the kernels line
    more_runs = tuple(more[(q, c)]["launches"] for c in ("vfa", "default")
                      for q in MORE_QUERIES) + tuple(
        ds[(q, c)]["launches"] for c in ("vfa", "default")
        for q in DS_QUERIES) + tuple(
        dq[(q, c)]["launches"] for c in ("vfa", "default")
        for q in DISTINCT_QUERIES) + tuple(
        ex[k]["launches"] for k in ex_runs) + tuple(ooc["runs"]) + tuple(
        rs["runs"]) + tuple(st["runs"]) + tuple(ud["runs"]) + tuple(
        fi["runs"]) + tuple(pp["runs"]) + tuple(ob["runs"]) + tuple(
        ad["runs"]) + tuple(sc["runs"]) + tuple(tp["runs"])
    runs = (path["launches"], joins["q3"]["launches"],
            joins["q4"]["launches"], q2["launches"]) + tuple(
                df[q]["launches"] for q in DF_QUERIES) + tuple(
                mixed[q]["launches"] for q in DF_QUERIES) + more_runs
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    replaces = {"radix_sort": "spark_rapids_tpu/ops/native.py:297",
                "join_probe": "spark_rapids_tpu/ops/native.py:315",
                "seg_reduce": "spark_rapids_tpu/ops/native.py:489",
                "rle_decode": "spark_rapids_tpu/ops/native.py:386"}
    sources = {"radix_sort": "radix_rank.cu", "join_probe": "join_probe.cu",
               "seg_reduce": "seg_scan.cu", "rle_decode": "rle_decode.cu"}
    # K1: the whole sort at the main path's size against torch.sort; K2:
    # the per-group function on q2's largest launch against one
    # identity-filled scatter_reduce_.
    timed = dict(radix_sort=k1[(PATH_CAP, "random")],
                 join_probe=joins["q4_probe"], seg_reduce=q2["k2"],
                 rle_decode=joins["q3_rle"])
    library = {k: sum(lib[k] for q in GATE_QUERIES
                      for lib in pp["gates"][q]["library"])
               for k in KERNEL_OF.values()}
    kernels = []
    for name in ("radix_sort", "join_probe", "seg_reduce", "rle_decode"):
        r = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": int(launches[name]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"],
            # The time of what the kernel's gate off runs (for K3 and K4
            # their plain versions).
            "library_route_ms": r["library_route_ms"],
            # Phase 23 (a): calls of the kernel's library route under
            # native.enabled=false and under its own gate off.
            "library_calls": int(library[name])})
    log(f"launches per path: q1 {runs[0]}, q3 {runs[1]}, q4 {runs[2]}, "
        f"q2 {runs[3]}; DataFrame path "
        + ", ".join(f"{q} {df[q]['launches']}" for q in DF_QUERIES)
        + "; default conf "
        + ", ".join(f"{q} {mixed[q]['launches']}" for q in DF_QUERIES)
        + "; phase 13 "
        + ", ".join(f"{q} ({c}) {more[(q, c)]['launches']}"
                    for c in ("vfa", "default") for q in MORE_QUERIES)
        + "; phase 14 "
        + ", ".join(f"{q} ({c}) {ds[(q, c)]['launches']}"
                    for c in ("vfa", "default") for q in DS_QUERIES)
        + "; phase 15 "
        + ", ".join(f"{q} ({c}) {dq[(q, c)]['launches']}"
                    for c in ("vfa", "default") for q in DISTINCT_QUERIES)
        + "; phase 16 "
        + ", ".join(f"{k} {ex[k]['launches']}" for k in ex_runs)
        + "; phase 18 " + ", ".join(str(r) for r in ooc["runs"])
        + f"; phase 18 recovery {ooc['recovery']}"
        + "; phase 19 " + ", ".join(str(r) for r in rs["runs"])
        + "; phase 20 " + ", ".join(str(r) for r in st["runs"])
        + "; phase 21 " + ", ".join(str(r) for r in ud["runs"])
        + "; phase 22 " + ", ".join(str(r) for r in fi["runs"])
        + "; phase 23 " + ", ".join(str(r) for r in pp["runs"])
        + f"; phase 23 library calls {library}"
        + "; phase 24 " + ", ".join(str(r) for r in ob["runs"])
        + "; phase 25 " + ", ".join(str(r) for r in ad["runs"])
        + "; phase 26 " + ", ".join(str(r) for r in sc["runs"])
        + "; phase 27 " + ", ".join(str(r) for r in tp["runs"]))
    log(f"nvidia-smi: {smi}")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
