#!/usr/bin/env python3
"""Drive redisson_tpu_torch on one CUDA card and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build the fourteen kernels' libraries
     from csrc/ (one nvcc per source, all at once) and print the build
     seconds; then, in a child process of this script (--kernels-a-call),
     count by torch.profiler the kernels one call launches of bitset_get
     and bitset_set (one plane, both set forms, and the table form at
     fanout's level), kmeans_assign (both routes), kmeans_update,
     knn_select, wc_words (auto form and delta form, config 4's first
     chunk) and segment_reduce (int32 sum and float32 max at 8,388,608 x
     1,024, and past the shared limit) at the main path's shapes, and fail
     unless each is 1 (kmeans_update 1 or 2, wc_words' delta form 1 to 4,
     segment_reduce past the shared limit 1 or 2: KERNELS_A_CALL);
  2. known answers: the CUDA hash chain, read back through hll_add,
     bloom_set and the fused add, gives the hashes the JAX package gives
     (constants below);
  3. each kernel against its plain version on the card at the main path's
     shapes (BASELINE configs 1-3), bit for bit; its time (CUDA events), the
     plain version's time and the least time the card could take.  The
     fused add (bloom_add) is also timed against the probe-then-set pair on
     the same add stream and on config 2's 10M-op populate, and checked on
     both sides of kernels.use_fused_add's size threshold; bloom_probe also
     at a single-key add's shape; hll_add also on one counter fed 1M-op
     batches; hll_rows' estimate on the bank config 3's adds leave and on a
     synthetic one, with registers up to 255, and its merge map beside
     torch.maximum (the merge's library call); bitset_get and bitset_set at
     config 5's shape (500 indexes into a 100,000-bit set on its 1 MiB
     plane: bitset_set's one-block form), on 1M indexes into a 2**28-bit
     plane (its cooperative form), and at the edges (negative,
     out-of-range and repeated indexes, a masked tail, n_valid 0; 6,000
     ops whose repeats lie in other blocks), beside index_select and
     index_put_; both in the table form (one launch a verb for a level of
     RBatch groups) at fanout's level (128 planes x 500 ops), timed beside
     128 one-plane launches, and on an edge table (planes of several sizes,
     one past 1 MiB, negative, out-of-plane and repeated indexes, one-op
     groups, both set forms); wc_words
     (both entry points) on config 4's two chunks, the first also as a
     slice 5 bytes past a 16-byte boundary, and at the edges (words
     over 63 bytes, control whitespace, a last byte that is not
     whitespace, eb below the end count, n_words 0), wc_sort_runs on config 4's 8,388,608-row
     stream, a stream shorter than d_max and an all-distinct one that
     overflows it, beside torch.sort, and segment_reduce (sum, max, min;
     int32, whole float32 values, whose sum is exact, and N(0, 1000)
     float32; max and min with NaN) on 8,388,608 values into 1,024 keys
     with negative and out-of-range keys, beside scatter_reduce_ (the
     float32 max on a row of its own); the vector kernels
     (check_vector): knn_score and knn_select in every metric, dtype and
     mask at config 7's 50,000 x 128 point, timed at config 7's points and
     at 1,000,000 x 128 L2 beside torch.matmul (TF32 off) and torch.topk
     (knn_score also by its tile route there, and by both of its routes,
     each checked, at 8 queries against the 1M bank, 1 against 65,536
     rows, the IVF route's 64 queries against 1,536 centroids, the narrow
     bank's edge, INT8 and FLOAT16 banks and W 70), and at the edges (k
     above the live rows, every row dead, duplicates, n_rows below
     capacity, k = 1, k = cap, k past a round of 256);
     ivf_score at config 7's IVF leg (nlist 1,536, nprobe 2, 4, 8); kmeans
     at 50,000 x 128 x 1,536, two runs equal bit for bit, the assign by the
     route W 128 takes (3xTF32 on the tensor cores) checked and timed, the
     tile route (float32) checked at KMEANS_WIDE's W 384, the route taken
     printed beside its bound (three TF32 products), the float32 bound and
     torch.matmul's time for the product alone (TF32 off), assign and
     update timed apart, the update bit for bit against its float32
     row-order reference on the host (np.add.at) beside its own bound and
     index_add_ of the weighted rows;
  4. the main path through redisson_tpu_torch.create() on its default
     device: config 2 (1,000-tenant bank, 10M keys populated in one window,
     100k-op contains flushes), config2_batch (the same bank: each flush an
     RBatch of 1,000 contains_async ops of 100 keys, beside the direct call,
     and one flush of 100,000 one-key ops), config 1 (one 1e7/0.01 filter),
     config 3 (10k HLL counters), graft (K10, the flagship fused step,
     through redisson_tpu_torch.graft_entry.entry(): bloom_probe, bloom_set
     or the fused add, hll_add on one stream, at entry()'s shape, then 100
     steps of 1M lanes into the same plane and bank; found, the plane and
     the registers bit for bit against the kernels' plain versions on
     clones; ms a step beside its bound by the sector rule, steps/s and
     ops/s), single-key adds (Redisson's
     RBloomFilter.add(key), the facade's add) into a filter of config 1's
     size, then fanout (config 5's per-tenant objects as one RBatch: 64
     filters in two fused runs, 64 fused add-then-contains pairs, 128 bit
     sets, a counter and a bucket per tenant; then BITOP OR and XOR of each
     tenant's two bit sets; one bitset_get and one bitset_set launch a rep,
     or it fails), each path with its kernels' launch counts set
     to 0 just before it and read just after its own work (config2_batch
     counts its RBatch flushes only, not the direct calls, parts and
     timings beside them); config2_batch and fanout are then timed with the
     engine's pinned staging pool on and off, in turns; last config 4
     (bench.py:343-396): put_all of 1M entries into an RMap, word_count
     twice (the cold scan, then the staged view), a KernelMapReduce sum of
     8,388,608 int32 values into 1,024 keys; each word_count times its
     own parts; then config7 (bench.py:1787-2031) through
     create().get_search(), nothing cut: the two FLAT points, the clustered
     corpus's FLAT, IVF (nlist 1,536, nprobe 2, 4, 8), INT8 and IVF over
     INT8 legs, and 1,000,000 x 128 L2 FLAT, each leg's qps, device ms a
     batch, recall@10 against the float64 oracle, ingest docs/s, bank and
     index bytes, H2D flushes and launches (set to 0 before each leg), the
     reference's quality and size floors held (FLAT recall >= 0.99; IVF
     nprobe 4 recall >= 0.97; INT8 recall >= 0.95 at <= 0.35x the bytes),
     its speed floor (IVF nprobe 4 at twice FLAT's wall qps) printed as
     held or NOT MET, and where a FLAT and an IVF batch's time goes (the
     dispatch's steps on the host, each kernel wrapper's call and device
     time, readback, finish, and the masked query's (Qb, cap) prefilter
     bias built and uploaded);
     last, the server (run_server): redisson_tpu_torch.server.ServerThread
     on the card, driven over TCP with the port's net.client.Connection
     (printing which RESP codec runs, native or Python): config 2 over the
     wire (BFA.RESERVE of the embedded bank's geometry, 10M keys in 100
     BFA.MADD64 frames, 30 BFA.MEXISTS64 frames of 100,000 keys: round-trip
     p50/p99, 0 false negatives, the false-positive rate in [0.005, 0.02],
     and a pipelined window of 50 frames), config 5's command stream
     (bench.py:399-428; a warm rep, then four timed reps, every probe found,
     fewer bloom launches a rep than its 128 BF blob commands, or it
     fails: the runs coalesced), config 3 over the wire (ten HLLA.MADD64
     frames of 1M ops, HLLA.MERGEROWS of 5,000 pairs, HLLA.ESTIMATE), one
     BFA.MEXISTS64 frame's spans with the tracer armed (parse, qos,
     dispatch, the kernel launch, readback, encode, reply), the collections
     leg (server_collections: tools/wire_stream.collections_stream on the
     card server and a CPU server, RESP2 then RESP3, equal under compare
     and byte for byte outside the unordered and random verbs; a
     leaderboard of 250,000 members by ZADD of 1,000 pairs, ZREVRANGE 0 99
     WITHSCORES against a host sort, 1,000 ZREVRANK and ZSCORE reads
     p50/p99, 10,000 ZINCRBY in frames of 1,000, ZREVRANGE again; a job
     queue: four producer connections RPUSH 2,500 ids (cut from 20,000,
     printed) in commands of 50,
     four consumer connections BLPOP 1 until empty, every id exactly once,
     a fifth connection's PING p99 while they park; config 5's stream with
     a SADD, an LPUSH and a ZADD a tenant, fewer bloom launches a rep than
     its 128 BF blob commands; handler ms by verb, each line with the
     card's name and power limit), and the mixed
     stream of every served verb (tools/wire_stream.py) on a card server
     and a CPU server, RESP2 then RESP3: equal replies, PFCOUNT and the
     HLLA estimates within their contract; the path must launch
     bloom_probe, bloom_set or bloom_add, hll_add, hll_rows, bitset_get and
     bitset_set; then the remote path (run_remote): the port's
     RemoteRedisson and AsyncRemoteRedisson against a port ServerThread on
     the card: config 2A (bench.py:737: the config-2 bank through
     RemoteBloomFilterArray, 1M keys in 100,000-key add_each frames, 12
     contains flushes of 100,000 keys sync, then gathered on one async
     connection; contains/s of each, async/sync beside the reference's aim
     of 10%, printed as met or NOT MET, not a gate; the OBJCALL fallback's
     contains_flushes against BFA.MEXISTS64), config 3 through
     RemoteHyperLogLogArray (10,000 counters, ten 1M-op frames), config 5's
     bit sets (SETBITS by the sync handle, SETBITSB by the async one,
     GETBITS, BITOP OR and XOR a tenant against numpy), a bloom handle's
     OBJCALL fallback (count), a RemoteBatch of 1,000 contains ops of 100
     keys, a MULTI/EXEC holding BF.MADD64 and BF.MEXISTS64, a TXEXEC
     commit, config 6's near cache (bench.py:804: 8 clients, 512 buckets,
     zipf 1.0, 99% reads; ops a client cut, printed) with server ops per
     issued op with tracking off and on, config 6's workload through
     RemoteLocalCachedMap (one map of 512 entries, each client writing only
     its own entries; sync INVALIDATE, then TRACKING; ops a client cut,
     printed): server ops per issued op and the near caches' hit share, the
     final values equal to the same streams' on a CPU server, and last a
     client stream and
     tools/wire_stream.objcall_stream on a card server and a CPU server:
     equal replies; the path must launch bloom_probe, bloom_set, hll_add,
     hll_rows, bitset_get and bitset_set; then the services path
     (run_services): a port ServerThread on the card driven by the port's
     Connection and RemoteRedisson: config 7's clustered corpus (50,000 x
     128 COSINE) ingested by HSET of FLOAT32 blobs in pipelined frames of
     1,000 into a FLAT index and an IVF index (nlist 1,536) over the same
     hashes, 20 FT.MSEARCH batches of 64 queries a leg (FLAT, IVF nprobe 2,
     4, 8): wire qps and batch p50/p99 beside the same run's embedded
     config 7 qps, recall@10 against the float64 oracle (FLAT >= 0.99, IVF
     nprobe 4 >= 0.97, or it fails), IVF nprobe 4 at 2x FLAT's qps printed
     as met or NOT MET (not a gate), single FT.SEARCH KNN queries and a
     hybrid query with a TAG filter, the banks and centroids on the card or
     it fails; a stream of 100,000 XADD entries (explicit IDs) read by a
     group of 4 consumers (XREADGROUP COUNT 100, XACK), every entry once,
     then XPENDING and XINFO; 100,000 GEOADD members and 1,000 GEOSEARCH
     BYRADIUS queries (the first 5 against a host haversine); a few hundred
     JSON.* commands; word_count(executor=...) on a worker-node child
     (python -m redisson_tpu_torch.node --workers 4) over config 4's values
     cut to 100,000, equal to the card's embedded word_count, the child
     stopped and waited for; and last tools/wire_stream.services_stream
     (X*, GEO*, JSON.*, FT.*, the script verbs) with FT.MSEARCH on the
     corpus cut to 10,000 rows on a card server and a CPU server, RESP2
     then RESP3: equal under the stream's clock and KNN contracts; the path
     must launch knn_score, knn_select, ivf_score and kmeans; then the
     cluster path (run_cluster, config 5, bench.py:452-490):
     redisson_tpu_torch.harness.ClusterRunner(masters=8, workers=16) on the
     card driven by the port's ClusterRedisson(scan_interval=0), config 5's
     stream (a warm rep, then four timed reps through execute_many, every
     probe found, no error reply, fewer bloom launches a rep than its 128
     BF blob commands: each shard's runs coalesced), a raw connection to
     every master that does not own a name's slot replying MOVED <slot>
     <owner>, and the same stream on a CPU ClusterRunner(masters=8), reply
     for reply; and the cluster_proc path (run_cluster_proc, config 5p,
     bench.py:498-530): ClusterSupervisor(masters=8) of server processes
     (--workers 16), each on the card, the same stream, then a SIGTERM to
     each: every exit code 0, each log naming cuda and the kernel launches
     it made (the path's launches are their sum); both paths must launch
     bloom_probe, bitset_set and bloom_set or bloom_add; then the sharded
     path (run_sharded, parallel/: every position on the one card, so
     nothing here is a multi-GPU result): config 2's bank (1,000 x 96,256
     lanes, k 7) as a ShardedBloomFilterArray on dp 2 x shard 4 over 8
     positions beside an unsharded BloomFilterArray, 100 add flushes of
     100,000 ops (config 2's 10M keys: the bank at its design load) and 20
     contains flushes (flags equal flush by flush, the gathered plane
     equal; flush p50s and launches a flush printed), config 3's 10,000
     counters (p 14) tenant-sharded over 4 beside a HyperLogLogArray (10
     batches of 1M; registers and estimate_all equal), a 2**28-bit
     ShardedBitSet over 4 shards beside a BitSet (1M sets, gets, clears and
     the cardinality equal), graft_entry.dryrun_multichip(8) (the live
     reshard 4 -> 8 -> 4 under traffic, 0 lost probes) and config 5d's A/B
     (bench.py:636-734: config 5's stream from 8 connections at once on a
     server with devices=1 and one with devices=4; replies bit-identical,
     ops/s, lane dispatches and peak lane concurrency printed); its counts
     are read there, the windowed kernels (bloom_probe, bloom_set,
     hll_add, bitset_get, bitset_set with a shard window, shard 1 of 4) are
     then held to their plain versions on parts of those records and timed
     beside their bounds (their rows in the kernels line, named "<kernel>
     window"), and the path fails unless each windowed form was launched;
     then the qos path (run_qos, bench.py:1409-1560's config 2q preempt
     leg on a devices=1 server: 2 bulk connections each send 30 frames of
     6 BF.MADD64 of 20,000 new keys with the sub-window at 20,000 items
     while an interactive connection probes 64 keys in a loop; armed, then
     with ioplane.set_preempt(False); the replies equal between the legs
     and to a CPU server's on the same stream, more than one sub-window a
     frame armed, each leg's interactive p50 and p99 and the lane's
     preemptions printed; then 3 QosRebalancer sweeps over an 8-master
     ClusterRunner on the card, each push summing to the global rate and
     following the demand), which must launch bloom_probe and bloom_set or
     bloom_add; and the sharded_vector path (run_sharded_vector, config 7s,
     bench.py:2034-2200: 40,000 x 64 COSINE, k 10, batches of 64, FLAT at
     SHARDS 1 and 8 over 8 positions of the card, ids equal outside near
     ties and recall@10 >= 0.99 against the float64 oracle, one IVF cell
     at SHARDS 8 (nlist 32, nprobe 8) with its recall printed), which must
     launch knn_score and knn_select; K19 (kernels.knn_sharded_merge, one
     knn_select launch a merge) is then held to its plain version at its
     shape, (64, 80) k 10, and timed beside torch.topk and its bound (its
     row "knn_select K19", its launches the path's merges); then the
     durability and observe paths (run_durability, run_observe:
     checkpoints, DUMP/RESTORE/COPY, TRACE/SLOWLOG/LATENCY/METRICS); then
     the warm path (run_warm, core/warmpool.py): config 2's bank, config
     3's counters and an HLL saved into a checkpoint, Engine.prewarm in
     this process (a second pass warms 0, the records equal their copies),
     and two server processes on the card restoring it, one with
     --prewarm: their first and second 100k-key BFA.MEXISTS64, PFADD and
     PFCOUNT at the client, and --prewarm's seconds and pool stats; and the
     replication path (run_replication, server/replication.py):
     ClusterRunner(masters=1, replicas_per_master=1) on the card, the
     master filled to configs 2 and 3's design loads, REPLICAOF timed (s
     and MB/s), bursts of 1,000 bank keys and 10,000 counter ops and one
     100,000-key flush each shipped by REPLFLUSH (bytes, delta or full,
     time), the replica equal to the master by torch.equal after each;
     BFA.MEXISTS64 through ClusterRedisson(read_mode="replica") equal to
     the master's bytes with the replica's bloom_probe launches counted;
     K23 (the packed upload) and K24 (the block patch), torch ops, held to
     per-array copies and to the numpy patch and timed beside their byte
     bounds (printed, not in the kernels line: no hand kernel); bad REPLPUSH
     deltas refused with the card still usable; REPLSTATE staleness and
     WAIT 1 p50/p99 under a 5 s writer; and a ClusterSupervisor replica
     process answering a READONLY read with the master's bytes; last the
     migration path (run_migration, server/migration.py): (a) two masters
     on the card with a journal directory, config 2's bank (1M keys), config
     3's counters (1M ops) and config 5's 64 tenants on master 0, a writer
     of 10,000-key BFA.MADD64 and HLLA.MADD64 frames, 10 ms apart, through
     the port's ClusterRedisson while three journaled migrate_slots windows move the
     bank's slot, the counters' slot and config 5's 64 slots to master 1:
     each window's seconds, bytes and MB/s, IMPORTRECORDS frames, the
     writer's p50/p99 before and during it and the ASK, MOVED and TRYAGAIN
     redirects it followed; every acked bank key reads 1 on the target,
     every record has one owner, and every plane equals the CPU replay of
     the same setup and acked frames bit for bit (and HLLA.ESTIMATE's
     reply); (b) config 5's records moved with the coordinator killed after
     PLANNED, WINDOW_OPEN, DRAINING:1, VIEW_COMMITTED and STABLE, each
     followed by resume_migrations: rolled back or completed, one owner,
     acked keys found, planes equal the CPU replay's; (d) config 5's
     records on a server of 8 positions on the card: rebalance_devices of
     half the slots killed at PLANNED, DRAINING:1 and STABLE and resumed,
     BF.MEXISTS64, GETBIT and GETBITSB replies equal those before and a
     CPU server's (the positions share the card: no move between cards is
     measured); (c) ClusterSupervisor(masters=2, replicas_per_master=1)
     processes on the card: the bank migrated with the coordinator killed
     after DRAINING:1 and the target SIGKILLed, the target restarted (its
     import journal replayed at boot), resume_migrations, a WAIT 1 covered
     write, the master killed and promote_replica, then rolling_restart of
     the masters with a client open: exit codes 0, generations +1, each
     old log ending with its kernel launches line, every acked key found
     after each step, each step's seconds; last the residency path
     (run_residency, core/residency.py): (a) config 8 (bench.py:2333): 64
     tenant filters of 100,000 keys at 1%, 512 member keys each, 1,200
     zipf(1.1) sessions of 4 calls of 64 keys all HOT, then under a budget
     of 1/4 of the footprint swept every 50 sessions: bench.py's eleven
     config8_* numbers, every probe found, the post-sweep HOT bytes within
     the budget, the overcommit at least 4x, the hot-hit ratio and the
     fault-in p99 beside the reference's floor and ceiling
     (tools/perf_gate.py) as MET or NOT MET; (b) a card server holding
     config 2's bank (96.3 MB) and config 3's counters (163.8 MB): each
     DEMOTEd to WARM and to COLD over the wire, a BFA.MEXISTS64 or
     HLLA.ESTIMATE after each byte-identical to the HOT reply and a CPU
     server's, each demotion's and fault-in's time and bytes, and
     memory_allocated falling by at least the record's bytes at each
     demotion; the CLUSTER RESIDENCY table and the METRICS residency rows;
     (c) config 5's records on 8 positions of the card, a budget pressuring
     position 0: the ResidencyRebalancer's SWEEP, then SHED, then CLUSTER
     DEVEVACUATE 1 DIR with position 0's lane flagged quarantined; replies
     equal those before and a CPU server's, positions 0 and 1 own no slot;
     (d) a vector bank grown past device-budget-bytes demotes colder bloom
     records first and, grown further, raises VectorBudgetError; last the
     faults path (run_faults: chaos/faults.py, the lane watchdog and
     quarantine, CLUSTER DEVPROBE) on a devices=8 server (8 positions of
     the card) holding config 2's bank, 10M keys in 100 BFA.MADD64
     frames: (a) a device_kernel streak on the bank's owner position
     replies -TRYAGAIN, then the quarantine reply on its keys; the FAULTS
     rows; DEVPROBE [0, 1]; DEVEVACUATE moves its slots and the bank to a
     survivor; every acked key found; DEVPROBE [1, 0] once the plane is
     cleared; every reply a CPU server's (8 CPU positions) for the same
     stream and schedule; (b) lane-watchdog-ms 50 and the owner lane's
     stream stalled ~2 s by torch.cuda._sleep (calibrated by CUDA events): a
     100,000-key BFA.MEXISTS64 frame replies -TRYAGAIN within 0.5 s, the
     owner's lane records watchdog_timeout, and once the stall drains the
     next frames reply as the CPU's and DEVPROBE passes; (c) a ballast
     sized from mem_get_info leaves less than a vector bank's growth:
     FT.SEARCH replies the fixed -OOM (the CPU's injected device_oom
     reply), the connection lives, the ballast freed the retry lands with
     the CPU's top-k, and memory_allocated returns to its level; (d) a
     BFA.MEXISTS64 frame's p50 with no plane and with an empty one,
     tools/chaos_overhead_bench's shipped/stripped ratio, and K25's
     DEVPROBE ping (printed on the torch_ops line); last the soak path
     (run_soak: chaos/soak.py's harnesses on 8 positions of the card, their
     own assertions the gates, each engine checked on the card before its
     leg's workload): (a) the standard profile, SoakHarness(SoakConfig(
     cycles=1, seconds_per_phase=1.0, positions=8)): a 2-master cluster
     with a replica each under transport faults, a master kill, failover
     and recovery, zero acked writes lost, and the embedded sharded bloom
     array (dp 2 x shard 4) resharded 4 -> 8 -> 4 with every acked add
     found, a flat census; (b) the device-shard profile,
     DeviceShardSoakHarness(DeviceShardSoakConfig(cycles=1, positions=8)):
     one server on 8 positions, its slot table rebalanced 8 -> 4 -> 8 under
     bucket and bloom traffic and tracked readers, no acked write lost, no
     stale tracked read, the lane census flat, host_colocations 0; each
     report's summary, each leg's wall seconds, memory_allocated before and
     after the path, and the windowed launches (the sharded bloom array's)
     counted as the sharded path counts them; last the multicard path
     (run_multicard): (a) on any card count, a devices=8 server with its
     positions on one card, each lane on a CUDA stream of its own: position
     0's lane spins ~500 ms under a 50 ms lane watchdog while positions 1-7
     serve 12 BF.MEXISTS64 frames of 10,000 keys each on their own
     connections: every one replies before the spin ends (p50/p99 printed),
     equal to a CPU server's, and only position 0's lane trips (a future
     behind the spin raises LaneWatchdogTimeout, a frame to position 0
     replies -TRYAGAIN); then a 1M-key filter made off the lanes is deleted
     while position 1's probe of it waits behind a spin, a buffer of its
     size filled with ones is allocated, and the plane's block is not handed
     out under the probe, whose flags equal the plain version's; (b) on two
     or more cards, a devices=8 server round robin over every card holding
     config 2's bank and config 3's counters: PFMERGE, PFCOUNT and BITOP
     across cards equal a CPU server's with no value through the host; a
     live rebalance 8 -> 4 -> 8 (positions 4-7's slots to positions on
     other cards, then back) under a BF.MADD64 writer: each step's seconds,
     bytes moved by peer copies and GB/s, every acked key read back, every
     record's tensors on its owner's card; the bank and counters then equal
     one card's bit for bit; the mixed stream RESP2 and RESP3 equal a CPU
     server's; sharded config 2 and 3 (dp 2 x shard 4 over the cards) equal
     one-card objects; the sharded_vector path over the cards; config 5d's
     ops/s on every card beside one card's, replies bit-identical;
     host_colocations 0.  On one card leg (b) prints that it needs two cards
     and saw one, which is not a pass of it.  The earlier paths with
     positions (sharded, sharded_vector, migration, residency, faults,
     soak) pass cuda:0, so their positions stay on one card;
  5. a small op stream and an RBatch stream through every batch verb
     (overlapped and serial, skip_result, atomic) through create() on the
     card and on the CPU: equal replies and equal final states; and
     word_count, device_word_count and KernelMapReduce on both: equal
     replies (the float32 sum of N(0, 100) within its limit); and a search
     stream (TEXT, TAG, NUMERIC and VECTOR fields, adds, updates, deletes,
     FLAT and IVF KNN in every metric and dtype, plain and hybrid) on both:
     equal replies, the CPU installing the card's trained IVF index; and an
     op stream through each collection family (lists, queues, sets, sorted
     sets, multimaps, topics, adders, Keys, MapCache) and a synchronizer
     stream (locks, fenced and read-write locks, semaphores, latches and a
     rate limiter from several threads in a fixed interleaving) on both:
     equal replies and final states; and the codec leg: a bloom filter and
     an HLL fed string keys and structured values through each codec beyond
     the default (composite, zlib, bz2, lzma, LZ4, CBOR, double, msgpack,
     and protobuf where google.protobuf is installed) and bytes keys, on
     both: equal planes, registers and replies.
Earlier paths keep their depth: the sharded path took 9.2 s on an H100 80GB
HBM3 at 700.00 W, inside the room the script's time limit had.
The second-to-last line is the kernels JSON; the last line is the ok JSON.
Without a CUDA card, or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM
# bytes per second, and the scalar 32-bit rate outside the tensor cores (67
# TFLOP/s float32, an FMA counting as two operations), used for the vector
# kernels' float32 FMAs and for the other kernels' integer operations (a
# lower bound: integer multiply and modulo take more issue slots than a
# float32 add).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# dense TF32 on the tensor cores (the same data sheet): kmeans_assign's
# tensor-core route runs three TF32 products (3xTF32)
TF32_OPS_PER_S = 495e12
# 32-bit integer operations in the source of csrc/hash.cuh and the kernels:
# the two murmur chains of a u64 key (2 x (2 rounds of 10 + xor + fmix of 8)
# + or), one bloom probe (mod, flat index, bounds, load, compare, step), one
# HLL add (mask, clz, flat index, bounds, load, compare, CAS) and one
# register of hll_rows (max, histogram increment).
OPS_HASH_U64 = 59
OPS_PROBE = 8
OPS_HLL_ADD = 10
OPS_ROW_REGISTER = 2
# wc_words: a byte's end test (2 compares, an and), its walk back (compare,
# step) and its two weighted adds (2 multiply-adds, 2 weight multiplies, the
# cap test); segment_reduce: a value's key wrap and bounds (3) and its atomic
OPS_WC_BYTE = 12
OPS_SEGMENT = 4

# Known answers from redisson_tpu.utils.hashing (HASH_VERSION 1).
KNOWN_U64 = {
    "keys": [0, 1, -1, 2**63 - 1, -(2**63 - 1), 2654435761],
    "h1": [773692376, 619189011, 1971636267, 3188012228, 3496309714, 2790771507],
    "h2": [2051978889, 2153448555, 747893459, 3131649621, 951840697, 3584982511],
}
KNOWN_BYTES = {
    "keys": [b"", b"a", b"abcd", b"abcde", b"hello world, seve"],
    "h1": [3954623016, 298494453, 4031219239, 3068932636, 1541924002],
    "h2": [1020716019, 2884439245, 2930714617, 2315107, 2468997313],
}

# BASELINE configurations (bench.py:36-340).
C2_TENANTS, C2_PER_TENANT, C2_FLUSH, C2_INGEST = 1000, 10_000, 100_000, 1_000_000
C1_N, C1_BATCH = 10_000_000, 1 << 20
C3_TENANTS, C3_BATCH, C3_BATCHES = 10_000, 1_000_000, 10
# config 2's contains flush as an RBatch of this many ops (BASELINE config 2:
# "RBatch of 100k contains() per flush")
C2_BATCH_OPS = 1000
# RBatch flushes and fanout reps timed with the engine's staging pool on and
# off, in turns (after each path's counted launches)
C2_POOL_AB, C5_POOL_AB = 20, 4
# config 5 (bench.py:399-428): 64 tenants, a 10,000-key filter each, and
# SETBITSB of 500 indexes below 100,000 into two bit sets each
C5_TENANTS, C5_PER, C5_BITS, C5_BIT_OPS, C5_REPS = 64, 10_000, 100_000, 500, 4
# a user-activity bitmap keyed by user id: 1M indexes into 2**28 bits
BITMAP_LOG2, BITMAP_OPS = 28, 1 << 20
# single-key adds, RBloomFilter.add(key): enough calls for a latency p99
SINGLE_ADDS = 200
# config 4 (bench.py:343-396): word count over a 1M-entry map, each value 8
# words drawn (seed 3) from w0..w999; word_count scans it in two chunks and
# counts up to 2**17 distinct words on the card
C4_ENTRIES, C4_VOCAB, C4_WORDS, C4_SEED = 1_000_000, 1000, 8, 3
WC_D_MAX = 1 << 17
# KernelMapReduce: config 4's word stream length of int32 values into 1,024 keys
KMR_N, KMR_KEYS = 8_388_608, 1024
# config 7 (bench.py:1787-2031): FLAT points (N, d, k), COSINE, batches of
# 64 queries, recall@10 of 64 oracle queries; the clustered corpus (512
# centres) for FLAT, IVF at nlist 1,536 (nprobe 2, 4, 8) and INT8; and
# 1,000,000 x 128 L2, the shape of ann-benchmarks' sift-128-euclidean
C7_POINTS = ((20_000, 64, 10), (50_000, 128, 10))
C7_SIFT = (1_000_000, 128, 10)
C7_QB, C7_ORACLE, C7_K, C7_MEASURE_S, C7_IVF_MEASURE_S = 64, 64, 10, 2.0, 1.5
C7_CLUSTERS, C7_NLIST, C7_NPROBES, C7_SEED = 512, 1536, (2, 4, 8), 77
KMEANS_ITERS = 6
# kmeans_assign's tile route, checked at a width past the tensor-core
# route's 256: (N, W, L), config 7's clustered corpus at W 384
KMEANS_WIDE = (20_000, 384, 1536)
# distances are held to their plain versions within DIST_TOL of the size of
# the terms they are made of (the kernel and torch add a dot product in
# different orders); ids where a distance stands more than TIE_GAP
# (relative) from its neighbours
DIST_TOL, TIE_GAP = 1e-5, 1e-5
VECTOR_KERNELS = ("knn_score", "knn_select", "ivf_score", "kmeans")
# the kernels each path of the main path must launch
PATH_KERNELS = {"config2": ("bloom_add", "bloom_probe"), "config2_batch": ("bloom_probe",),
                "config1": ("bloom_add", "bloom_probe"), "config3": ("hll_add", "hll_rows"),
                "single_adds": ("bloom_probe", "bloom_set"),
                "fanout": ("bloom_probe", "bloom_set", "bitset_set", "bitset_get"),
                "config4": ("wc_words", "wc_sort_runs", "segment_reduce"),
                "config7": VECTOR_KERNELS,
                "server": ("bloom_probe", "hll_add", "hll_rows", "bitset_get", "bitset_set"),
                "remote": ("bloom_probe", "bloom_set", "hll_add", "hll_rows", "bitset_get", "bitset_set"),
                "services": VECTOR_KERNELS, "graft": ("bloom_probe", "hll_add"),
                "cluster": ("bloom_probe", "bitset_set"), "cluster_proc": ("bloom_probe", "bitset_set"),
                "sharded": ("bloom_probe", "bloom_set", "hll_add", "hll_rows", "bitset_get", "bitset_set"),
                "qos": ("bloom_probe",), "sharded_vector": ("knn_score", "knn_select"),
                "durability": ("bloom_probe", "hll_rows"), "observe": ("bloom_probe",),
                "warm": ("bloom_probe", "hll_add", "hll_rows"), "replication": ("bloom_probe", "hll_add"),
                "migration": ("bloom_probe", "hll_add", "hll_rows", "bitset_get", "bitset_set"),
                "residency": ("bloom_probe", "hll_add", "hll_rows", "bitset_get", "bitset_set"),
                "faults": ("bloom_probe",), "soak": ("bloom_probe",), "multicard": ("bloom_probe",)}
# what leg (b) of the multicard path must launch on two or more cards
MC_CARD_KERNELS = ("bloom_probe", "bloom_set", "hll_add", "hll_rows", "bitset_get", "bitset_set", "knn_score",
                   "knn_select")
FPP = 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_kernel(fn, reps: int = 20, warm=None) -> float:
    """Median device ms per launch of fn(i), i < reps, after warm() (by
    default fn(0)).  A sleep kernel holds the stream while the host enqueues
    every launch, so the events bracket device work only, not host launch
    overhead."""
    (warm or (lambda: fn(0)))()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s at H100 clocks
    events[0].record()
    for i in range(reps):
        fn(i)
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(reps))


def time_plain(fn, reps: int = 5) -> float:
    """Median ms of fn(i) between CUDA events (plain versions sync inside)."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sectors(flat_positions: torch.Tensor) -> int:
    """Distinct 32-byte sectors a set of byte positions touches."""
    return int(torch.unique(flat_positions.reshape(-1) // 32).numel())


def assert_equal(name: str, got: torch.Tensor, want: torch.Tensor, equal_nan: bool = False) -> float:
    """Raise unless the kernel's result equals the plain version's (with
    equal_nan, NaN where the plain version has NaN); return their largest
    absolute difference over the other entries (0 when they agree)."""
    torch.cuda.synchronize()
    if equal_nan and got.shape == want.shape and torch.equal(got.isnan(), want.isnan()):
        got, want = got[~got.isnan()], want[~want.isnan()]
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.reshape(-1) != want.reshape(-1)).sum().item() if got.shape == want.shape else "shape"
        raise AssertionError(f"{name}: kernel differs from its plain version ({diff})")
    if got.numel() == 0:
        return 0.0
    return (got.to(torch.float64) - want.to(torch.float64)).abs().max().item()


def time_stream(name, kernel, plain, work, ref, batches, bytes_of):
    """Time a stream of in-place launches as the main path makes them: each
    batch is new and lands on the state the batches before it left, the
    kernel's into `work`, the plain version's into `ref` (equal at the
    start).  Returns the kernel's and the plain version's median ms, the
    median over the stream of bytes_of(batch, changed) (changed: the flat
    positions the plain version altered), and the states' max abs error."""
    ms = time_kernel(lambda i: kernel(work, batches[i]), reps=len(batches), warm=lambda: None)
    times, nbytes = [], []
    for b in batches:
        before = ref.clone()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plain(ref, b)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        nbytes.append(bytes_of(b, (ref != before).reshape(-1).nonzero().reshape(-1)))
        del before
    err = assert_equal(f"{name} after a stream of {len(batches)} batches", work, ref)
    return ms, statistics.median(times), statistics.median(nbytes), err


# --------------------------------------------------------------------------
# phase 2: known answers
# --------------------------------------------------------------------------

def check_known_answers(dev) -> None:
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    keys = np.array(KNOWN_U64["keys"], np.int64)
    lo, hi = H.int_keys_to_u32_pair(keys)
    words, nbytes = H.pack_keys(KNOWN_BYTES["keys"])
    cases = [("u64", K.Keys(n=1, lo=K.stage(lo[i:i + 1], dev), hi=K.stage(hi[i:i + 1], dev)),
              KNOWN_U64["h1"][i], KNOWN_U64["h2"][i]) for i in range(len(keys))]
    cases += [("bytes", K.Keys(n=1, words=K.stage(np.ascontiguousarray(words[:, i:i + 1]), dev),
                               nbytes=K.stage(nbytes[i:i + 1], dev)),
               KNOWN_BYTES["h1"][i], KNOWN_BYTES["h2"][i]) for i in range(len(KNOWN_BYTES["keys"]))]
    p, k, m = 14, 5, 1_000_003
    for kind, kb, h1, h2 in cases:
        regs = torch.zeros(1 << p, dtype=torch.uint8, device=dev)
        K.hll_add(regs, regs.numel(), kb, 1, p)
        rho = 33 if h2 == 0 else 32 - h2.bit_length() + 1
        want = torch.zeros_like(regs)
        want[h1 & ((1 << p) - 1)] = rho
        assert_equal(f"known answer hll_add {kind}", regs, want)
        want = torch.zeros(1_001_472, dtype=torch.uint8, device=dev)
        want[[((h1 + i * h2) & 0xFFFFFFFF) % m for i in range(k)]] = 1
        for name, add in (("bloom_set", lambda pl: K.bloom_set(pl, pl.numel(), kb, 1, k, m)),
                          ("bloom_add", lambda pl: K.bloom_add_fused(pl, pl.numel(), kb, 1, k, m))):
            plane = torch.zeros_like(want)
            add(plane)
            assert_equal(f"known answer {name} {kind}", plane, want)
    log(f"known answers: {len(cases)} keys hash on the card as in the JAX package")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def u64_batch(rng, n: int, b: int, dev, tenants: int = 0, dup: float = 0.1):
    """A padded key batch of n ops in b lanes, with duplicate keys and, for
    a bank, a few tenant ids outside [0, tenants)."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    keys = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    d = int(n * dup)
    keys[n - d:] = keys[:d]
    lo, hi = np.zeros(b, np.uint32), np.zeros(b, np.uint32)
    lo[:n], hi[:n] = H.int_keys_to_u32_pair(keys)

    if not tenants:
        return K.Keys(n=b, lo=K.stage(lo, dev), hi=K.stage(hi, dev))
    t = np.zeros(b, np.int32)
    t[:n] = rng.integers(0, tenants, n)
    # ids outside the bank, ids whose int32 product with the row width wraps,
    # and the last row
    bad = [-1, tenants, 2**31 - 1, -(2**31), 2**22, 2**22 + 1, -(2**22) + 2, tenants - 1]
    t[:len(bad)] = bad
    return K.Keys(n=b, tenant=K.stage(t, dev), lo=K.stage(lo, dev), hi=K.stage(hi, dev))


def byte_batch(rng, n: int, dev):
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    keys = [rng.bytes(int(rng.integers(0, 65))) for _ in range(n)]
    words, nbytes = H.pack_keys(keys)
    return K.Keys(n=n, words=K.stage(K.pad_to(words, 16, axis=0), dev), nbytes=K.stage(nbytes, dev))


def probe_positions(keys, width, size, k, m, n_valid):
    """Flat positions (in range) that n_valid ops probe, from the plain path."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    h1, h2 = K._hash(keys)
    g = K._flat_index(keys.tenant, H.bloom_indexes(h1, h2, k, m), width, size)[:n_valid]
    return g[g < size]


def needed_probe_positions(plane, keys, width, k, m, n_valid):
    """Flat positions (in range) that n_valid ops must read to answer a
    probe: each op's probes up to and including its first 0, all k when
    every one is set."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    h1, h2 = K._hash(keys)
    size = plane.numel()
    g = K._flat_index(keys.tenant, H.bloom_indexes(h1, h2, k, m), width, size)[:n_valid]
    inside = g < size
    zero = (inside & (plane.reshape(-1)[torch.where(inside, g, 0)] == 0)).to(torch.int32)
    after_a_zero = (torch.cumsum(zero, dim=1) - zero) > 0
    return g[inside & ~after_a_zero]


def check_kernels(dev, rng) -> dict:
    from redisson_tpu_torch.core import kernels as K

    from redisson_tpu_torch.client.objects.bloom import optimal_num_of_bits
    from redisson_tpu_torch.ops import bittensor as bt

    results = {}
    k = 7
    # -- bloom_probe / bloom_set on the config-2 bank and the config-1 plane --
    m2 = bt.padded_size(optimal_num_of_bits(C2_PER_TENANT, FPP))
    bank = (torch.rand((C2_TENANTS, m2), device=dev) < 0.5).to(torch.uint8)
    b2 = K.bucket_size(C2_FLUSH)
    flushes = [u64_batch(rng, C2_FLUSH, b2, dev, tenants=C2_TENANTS) for _ in range(8)]
    m1 = optimal_num_of_bits(C1_N, FPP)
    size1 = bt.padded_size(m1)
    plane1 = (torch.rand(size1, device=dev) < 0.5).to(torch.uint8)
    n1 = C1_BATCH - 1000
    single = u64_batch(rng, n1, C1_BATCH, dev)
    n_bytes = min(65536, C1_BATCH)
    bytes_kb = byte_batch(rng, n_bytes, dev)
    probe_cases = [
        (f"config-2 bank {C2_TENANTS}x{m2}, {C2_FLUSH} ops in {b2}", bank, m2, flushes[0], C2_FLUSH, m2),
        (f"config-1 plane {size1}, {n1} ops in {C1_BATCH}", plane1, size1, single, n1, m1),
        (f"config-1 plane, {n_bytes} byte keys of 0-64 bytes", plane1, size1, bytes_kb, n_bytes, m1)]
    checked, err = [], 0.0
    for label, plane, width, kb, nv, m in probe_cases:
        for newly in (False, True):
            for out in (K.FLAGS, K.BITS, K.COUNT):
                got = K.bloom_probe(plane, width, kb, nv, k, m, newly, out)
                want = K.bloom_probe_plain(plane, width, kb, nv, k, m, newly, out)
                err = max(err, assert_equal(f"bloom_probe {label} newly={newly} out={out}", got, want))
        checked.append(label)
    # a probe only reads, so the 8 flushes can be replayed on one bank
    ms = time_kernel(lambda i: K.bloom_probe(bank, m2, flushes[i % 8], C2_FLUSH, k, m2, False, K.BITS))
    plain = time_plain(lambda i: K.bloom_probe_plain(bank, m2, flushes[i % 8], C2_FLUSH, k, m2, False, K.BITS))
    # an op's answer needs its probes up to its first 0 (all k when found);
    # the bound over all k probes is kept for comparison
    touched = statistics.median(sectors(needed_probe_positions(bank, f, m2, k, m2, C2_FLUSH)) for f in flushes)
    every = statistics.median(sectors(probe_positions(f, m2, bank.numel(), k, m2, C2_FLUSH)) for f in flushes)
    bms, by = bound_ms(touched * 32 + 12 * C2_FLUSH + b2 // 8, C2_FLUSH * (OPS_HASH_U64 + k * OPS_PROBE))
    all_k_bms, _ = bound_ms(every * 32 + 12 * C2_FLUSH + b2 // 8, C2_FLUSH * (OPS_HASH_U64 + k * OPS_PROBE))
    # the single-key add's probe (the pair route's newly read of one byte
    # key in the config-1 plane): its launches outnumber the configs'
    singles = [byte_batch(rng, 1, dev) for _ in range(20)]
    for b in singles:
        err = max(err, assert_equal("bloom_probe single key", K.bloom_probe(plane1, size1, b, 1, k, m1, True),
                                    K.bloom_probe_plain(plane1, size1, b, 1, k, m1, True)))
    one_ms = time_kernel(lambda i: K.bloom_probe(plane1, size1, singles[i], 1, k, m1, True))
    one_sectors = statistics.median(sectors(needed_probe_positions(plane1, b, size1, k, m1, 1)) for b in singles)
    one_key_bytes = statistics.median(4 * b.words.shape[0] + 4 for b in singles)
    one_bms, _ = bound_ms(32 * one_sectors + one_key_bytes + 1, OPS_HASH_U64 + k * OPS_PROBE)
    checked.append("single-key newly probes, one byte key each, in the config-1 plane")
    results["bloom_probe"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                                  bound_all_probes_ms=all_k_bms, sectors_needed=touched, sectors_all_probes=every,
                                  single_key_ms=one_ms, single_key_bound_ms=one_bms,
                                  shape=f"config-2 contains flush: {probe_cases[0][0]}, k={k}, bitmap out",
                                  checked=checked)
    log(f"kernel bloom_probe: {ms:.4f} ms (plain {plain:.3f} ms, bound {bms:.4f} ms by {by} for the {touched} "
        f"sectors the answers need; {all_k_bms:.4f} ms for all {every} sectors of k probes); a single-key "
        f"newly probe {one_ms:.4f} ms (bound {one_bms:.7f} ms); equal to plain at {checked}")

    checked, err = [], 0.0
    for label, plane, width, kb, nv, m in probe_cases:
        a, b = plane.clone(), plane.clone()
        K.bloom_set(a, width, kb, nv, k, m)
        K.bloom_set_plain(b, width, kb, nv, k, m)
        err = max(err, assert_equal(f"bloom_set {label}", a, b))
        checked.append(label)
    # the main path's shape: a single-key add (the pair route, one byte key)
    # into the config-1 plane.  A blind store need not read the plane, so
    # the bound writes every touched sector once.
    n_small = 1
    small = [byte_batch(rng, n_small, dev) for _ in range(20)]
    ms = time_kernel(lambda i: K.bloom_set(plane1, size1, small[i], n_small, k, m1))
    plain = time_plain(lambda i: K.bloom_set_plain(plane1, size1, small[i], n_small, k, m1))
    touched = statistics.median(sectors(probe_positions(b, size1, size1, k, m1, n_small)) for b in small)
    # (the operations of a u64 key's hash, fewer than a byte key's)
    key_bytes = statistics.median(4 * b.words.shape[0] + 4 for b in small)
    bms, by = bound_ms(32 * touched + key_bytes, n_small * (OPS_HASH_U64 + k * OPS_PROBE))
    del bank, plane1, single, probe_cases, a, b, small, singles
    # config 1's add stream, for comparison with the fused add, which takes
    # it on the main path: ten new batches of distinct keys into a zeroed
    # plane
    stream = [u64_batch(rng, n1, C1_BATCH, dev, dup=0.0) for _ in range(C1_N // n1)]
    work = torch.zeros(size1, dtype=torch.uint8, device=dev)
    stream_ms, _, nbytes, stream_err = time_stream(
        "bloom_set", lambda pl, kb: K.bloom_set(pl, size1, kb, n1, k, m1),
        lambda pl, kb: K.bloom_set_plain(pl, size1, kb, n1, k, m1), work, torch.zeros_like(work), stream,
        lambda kb, changed: 32 * sectors(probe_positions(kb, size1, size1, k, m1, n1)) + 8 * n1)
    stream_bms, _ = bound_ms(nbytes, n1 * (OPS_HASH_U64 + k * OPS_PROBE))
    results["bloom_set"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=max(err, stream_err),
                                config1_stream_ms=stream_ms, config1_stream_bound_ms=stream_bms,
                                shape=f"single-key add into the config-1 plane {size1}, k={k}",
                                checked=checked + [f"a stream of {len(stream)} config-1 add batches"])
    log(f"kernel bloom_set: {ms:.4f} ms per single-key add (plain {plain:.3f} ms, bound {bms:.4f} ms by {by}); "
        f"{stream_ms:.4f} ms per config-1 batch (bound {stream_bms:.4f} ms); "
        f"equal to plain at {results['bloom_set']['checked']}")
    del work, stream
    results["bloom_add"] = check_bloom_add(dev, rng)

    # -- hll_add on the config-3 bank and one counter --
    p = 14
    m = 1 << p
    regs = torch.randint(0, 12, (C3_TENANTS, m), dtype=torch.uint8, device=dev)
    b3 = K.bucket_size(C3_BATCH)
    batch = u64_batch(rng, C3_BATCH, b3, dev, tenants=C3_TENANTS)
    one = torch.randint(0, 12, (m,), dtype=torch.uint8, device=dev)
    hll_cases = [
        (f"config-3 bank {C3_TENANTS}x{m}, {C3_BATCH} ops in {b3}", regs, m, batch, C3_BATCH),
        (f"one counter {m}, {n1} u64 ops", one, m, u64_batch(rng, n1, C1_BATCH, dev), n1),
        (f"one counter, {n_bytes} byte keys of 0-64 bytes", one, m, bytes_kb, n_bytes)]
    checked, err = [], 0.0
    for label, r, width, kb, nv in hll_cases:
        a, b = r.clone(), r.clone()
        K.hll_add(a, width, kb, nv, p)
        K.hll_add_plain(b, width, kb, nv, p)
        err = max(err, assert_equal(f"hll_add {label}", a, b))
        checked.append(label)
    del regs, batch, one, hll_cases, a, b
    # config 3's add stream: ten new batches into a zeroed bank, where nearly
    # every op raises its register.  A scatter-max must read every touched
    # sector and write back those whose registers it raised.
    stream = [u64_batch(rng, C3_BATCH, b3, dev, tenants=C3_TENANTS, dup=0.0) for _ in range(C3_BATCHES)]
    work = torch.zeros((C3_TENANTS, m), dtype=torch.uint8, device=dev)
    traffic = []

    def hll_bytes(kb, changed):
        h1, _ = K._hash(kb)
        g = K._flat_index(kb.tenant, h1 & (m - 1), m, work.numel())[:C3_BATCH]
        read, written = sectors(g[g < work.numel()]), sectors(changed)
        traffic.append((read, written))
        return 32 * (read + written) + 12 * C3_BATCH

    ms, plain, nbytes, stream_err = time_stream(
        "hll_add", lambda r, kb: K.hll_add(r, m, kb, C3_BATCH, p),
        lambda r, kb: K.hll_add_plain(r, m, kb, C3_BATCH, p), work, torch.zeros_like(work), stream, hll_bytes)
    bms, by = bound_ms(nbytes, C3_BATCH * (OPS_HASH_U64 + OPS_HLL_ADD))
    read, written = (statistics.median(x) for x in zip(*traffic))
    # the estimate of the bank that config 3's adds leave (~94% zeros),
    # beside the synthetic bank's below
    real_est = K.hll_rows(work, estimate=True)
    real_err = assert_equal("hll_rows estimate of the config-3 add stream's bank", real_est,
                            K.hll_rows_plain(work, estimate=True))
    real_ms = time_kernel(lambda i: K.hll_rows(work, estimate=True))
    del work, stream
    # one counter fed ten 1M-op batches, as a large add_all on one
    # RHyperLogLog makes them: every register takes ~64 ops a batch
    ones = [u64_batch(rng, n1, C1_BATCH, dev) for _ in range(C3_BATCHES)]
    counter = torch.zeros(m, dtype=torch.uint8, device=dev)
    one_ms, one_plain, one_bytes, one_err = time_stream(
        "hll_add one counter", lambda r, kb: K.hll_add(r, m, kb, n1, p), lambda r, kb: K.hll_add_plain(r, m, kb, n1, p),
        counter, torch.zeros_like(counter), ones, lambda kb, changed: m + 32 * sectors(changed) + 8 * n1)
    one_bms, _ = bound_ms(one_bytes, n1 * (OPS_HASH_U64 + OPS_HLL_ADD))
    del ones, counter
    results["hll_add"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                              max_abs_err=max(err, stream_err, one_err),
                              one_counter_ms=one_ms, one_counter_plain_ms=one_plain, one_counter_bound_ms=one_bms,
                              shape=f"config-3 add stream: {C3_BATCHES} batches of {C3_BATCH} ops in {b3} "
                                    f"into a zeroed {C3_TENANTS}x{m} bank",
                              sectors_read=read, sectors_written=written,
                              checked=checked + [f"a stream of {C3_BATCHES} add batches",
                                                 f"one counter fed {C3_BATCHES} batches of {n1} ops"])
    log(f"kernel hll_add: {ms:.4f} ms (plain {plain:.3f} ms, bound {bms:.4f} ms by {by}; median sectors read "
        f"{read}, written {written}); one counter fed {n1} ops {one_ms:.4f} ms (bound {one_bms:.4f} ms); "
        f"equal to plain at {results['hll_add']['checked']}")

    # -- hll_rows: estimate, merge rounds with duplicate dsts, union pairs --
    # registers with the rank distribution of real counters (P(r) ~ 2**-r)
    u = torch.rand((C3_TENANTS, m), device=dev)
    regs = torch.clamp(torch.floor(-torch.log2(u)) * (u < 0.9), 0, 33).to(torch.uint8)
    del u
    checked, worst = [], 0.0
    est_k = K.hll_rows(regs, estimate=True)
    est_p = K.hll_rows_plain(regs, estimate=True)
    worst = max(worst, assert_equal("hll_rows estimate config-3 bank", est_k, est_p))
    checked.append(f"estimate {C3_TENANTS}x{m}")
    pairs = C3_TENANTS // 2
    dst = torch.from_numpy(rng.integers(0, C3_TENANTS, pairs).astype(np.int32)).to(dev)
    src = torch.from_numpy(rng.integers(0, C3_TENANTS, pairs).astype(np.int32)).to(dev)
    src_map = torch.arange(C3_TENANTS, dtype=torch.int32, device=dev)
    src_map[dst.long()] = src
    a_out, b_out = torch.empty_like(regs), torch.empty_like(regs)
    K.hll_rows(regs, regs, None, src_map, out=a_out)
    K.hll_rows_plain(regs, regs, None, src_map, out=b_out)
    worst = max(worst, assert_equal("hll_rows merge map", a_out, b_out))
    # a second round reads its sources from the pre-merge bank `regs`
    round2 = src_map.flip(0).contiguous()
    k_out, p_out = torch.empty_like(regs), torch.empty_like(regs)
    K.hll_rows(a_out, regs, None, round2, out=k_out)
    K.hll_rows_plain(b_out, regs, None, round2, out=p_out)
    worst = max(worst, assert_equal("hll_rows merge map from", k_out, p_out))
    regs = k_out
    del p_out
    checked.append(f"merge map {C3_TENANTS} rows, {pairs} pairs with duplicate dsts, "
                   "then a second round from the pre-merge bank")
    pa = torch.from_numpy(rng.integers(-3, C3_TENANTS + 3, pairs).astype(np.int32)).to(dev)
    pb = torch.from_numpy(rng.integers(-3, C3_TENANTS + 3, pairs).astype(np.int32)).to(dev)
    est_k = K.hll_rows(regs, regs, pa, pb, estimate=True)
    est_p = K.hll_rows_plain(regs, regs, pa, pb, estimate=True)
    worst = max(worst, assert_equal("hll_rows union pairs", est_k, est_p))
    checked.append(f"union estimate of {pairs} pairs, ids beyond both ends")
    # registers no hash produces (up to 255) and a saturated row (NaN)
    odd = torch.randint(0, 256, (64, m), dtype=torch.uint8, device=dev)
    odd[1] = 33
    odd[2, ::5] = 0
    for args in [(odd, None, None, None), (odd, odd.flip(0).contiguous(), None, None)]:
        out_k, out_p = torch.empty_like(odd), torch.empty_like(odd)
        worst = max(worst, assert_equal("hll_rows unusual registers", K.hll_rows(*args, out=out_k, estimate=True),
                                        K.hll_rows_plain(*args, out=out_p, estimate=True), equal_nan=True))
        worst = max(worst, assert_equal("hll_rows unusual registers: rows", out_k, out_p))
    checked.append(f"{odd.shape[0]} rows of registers up to 255 with a saturated one, alone and merged")
    del odd, out_k, out_p
    ms = time_kernel(lambda i: K.hll_rows(regs, estimate=True))
    plain = time_plain(lambda i: K.hll_rows_plain(regs, estimate=True))
    bms, by = bound_ms(regs.numel() + 4 * C3_TENANTS, regs.numel() * OPS_ROW_REGISTER)
    # the merge map reads two banks and writes one; torch.maximum computes
    # the same with an identity map (the merge's library time)
    merge_ms = time_kernel(lambda i: K.hll_rows(regs, b_out, None, src_map, out=a_out))
    merge_lib_ms = time_kernel(lambda i: torch.maximum(regs, b_out, out=a_out))
    merge_bms, _ = bound_ms(3 * regs.numel() + 4 * C3_TENANTS, regs.numel() * OPS_ROW_REGISTER)
    results["hll_rows"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=max(worst, real_err),
                               estimate_config3_ms=real_ms, merge_map_ms=merge_ms, merge_map_bound_ms=merge_bms,
                               merge_map_library_ms=merge_lib_ms,
                               shape=f"config-3 estimate_all: bank {C3_TENANTS}x{m} u8 -> {C3_TENANTS} f32, "
                                     "synthetic registers (P(r) ~ 2**-r)",
                               checked=checked + ["estimate of the config-3 add stream's bank"])
    log(f"kernel hll_rows: {ms:.4f} ms on the synthetic bank, {real_ms:.4f} ms on config 3's (plain {plain:.3f} ms, "
        f"bound {bms:.4f} ms by {by}); merge map {merge_ms:.4f} ms (bound {merge_bms:.4f} ms, torch.maximum "
        f"{merge_lib_ms:.4f} ms); equal to plain at {results['hll_rows']['checked']}")
    del regs, a_out, b_out
    torch.cuda.empty_cache()
    return results


def boundary_batch(dev, size, k, m, chunk):
    """u64 keys (single plane) one of whose probes lands on a byte either
    side of a chunk boundary, and those bytes."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    cand = np.arange(1, 1 << 21, dtype=np.int64) * 2654435761
    lo, hi = H.int_keys_to_u32_pair(cand)
    pos = H.bloom_indexes(*H.hash_u64_pair(K.stage(lo, dev), K.stage(hi, dev)), k, m)
    edge = (pos % chunk == 0) | (pos % chunk == chunk - 1)
    rows = edge.any(dim=1).nonzero().reshape(-1)[:8192].cpu().numpy()
    n = len(rows)
    b = -(-n // 32) * 32
    l2, h2 = np.zeros(b, np.uint32), np.zeros(b, np.uint32)
    l2[:n], h2[:n] = lo[rows], hi[rows]
    return K.Keys(n=b, lo=K.stage(l2, dev), hi=K.stage(h2, dev)), n, pos[edge]


def config2_ingest():
    """Config 2's populate: 10M keys in ten 1M flushes, tenant = a hash of
    the key."""
    ingest = []
    for start in range(0, C2_TENANTS * C2_PER_TENANT, C2_INGEST):
        keys = np.arange(start, start + C2_INGEST, dtype=np.int64) * 2654435761
        ingest.append((((keys * 40503) % C2_TENANTS).astype(np.int32), keys))
    return ingest


def check_bloom_add(dev, rng) -> dict:
    """The fused add against its plain version (the newly result in every
    form and the plane after it) at the main path's shapes and adversarial
    ones, both sides of the size dispatch, and its time against the
    probe-then-set pair on config 1's add stream and config 2's populate."""
    import redisson_tpu_torch
    from redisson_tpu_torch.client.objects.bloom import optimal_num_of_bits
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import bittensor as bt

    k = 7
    m2 = bt.padded_size(optimal_num_of_bits(C2_PER_TENANT, FPP))
    bank = (torch.rand((C2_TENANTS, m2), device=dev) < 0.5).to(torch.uint8)
    m1 = optimal_num_of_bits(C1_N, FPP)
    size1 = bt.padded_size(m1)
    plane1 = (torch.rand(size1, device=dev) < 0.5).to(torch.uint8)
    n1 = C1_BATCH - 1000
    b2 = K.bucket_size(C2_FLUSH)
    chunk = 1 << K.ADD_CHUNK_LOG2
    flush = u64_batch(rng, C2_FLUSH, b2, dev, tenants=C2_TENANTS)
    last_row = u64_batch(rng, C2_FLUSH, b2, dev)._replace(
        tenant=torch.full((b2,), C2_TENANTS - 1, dtype=torch.int32, device=dev))
    edges, n_edge, edge_pos = boundary_batch(dev, size1, k, m1, chunk)
    plane_edges = plane1.clone()
    plane_edges[edge_pos] = 0  # so the boundary bytes decide "newly"
    cases = [
        (f"config-1 plane {size1}, {n1} ops in {C1_BATCH}, 10% duplicates", plane1, size1,
         u64_batch(rng, n1, C1_BATCH, dev), n1, m1),
        (f"config-2 bank {C2_TENANTS}x{m2}, {C2_FLUSH} ops in {b2}, ids outside and wrapping", bank, m2,
         flush, C2_FLUSH, m2),
        (f"config-2 bank, hash domain {m2 - 1000} narrower than the row", bank, m2, flush, C2_FLUSH, m2 - 1000),
        ("config-2 bank, every op in the last row", bank, m2, last_row, C2_FLUSH, m2),
        ("config-2 bank, n_valid = 0", bank, m2, flush, 0, m2),
        (f"config-1 plane, {n_edge} keys probing both sides of {chunk}-byte chunk boundaries", plane_edges,
         size1, edges, n_edge, m1),
        ("config-1 plane, 65536 byte keys of 0-64 bytes", plane1, size1, byte_batch(rng, 65536, dev), 65536, m1)]
    checked, err = [], 0.0
    for label, plane, width, kb, nv, m in cases:
        for out in (K.FLAGS, K.BITS, K.COUNT):
            a, b = plane.clone(), plane.clone()
            got = K.bloom_add_fused(a, width, kb, nv, k, m, out)
            want = K.bloom_add_plain(b, width, kb, nv, k, m, out)
            err = max(err, assert_equal(f"bloom_add {label} out={out}", got, want))
            err = max(err, assert_equal(f"bloom_add {label} out={out}: plane", a, b))
        checked.append(label)
    # both sides of the size dispatch, through bloom_add on the config-2 bank
    n_fused = int(np.ceil(K.FUSED_ADD_PROBES_PER_SECTOR * bank.numel() / 32 / k))
    for nv, route in ((n_fused - 1, "pair"), (n_fused, "fused")):
        kb = u64_batch(rng, nv, K.bucket_size(nv), dev, tenants=C2_TENANTS)
        a, b = bank.clone(), bank.clone()
        before = dict(K.launches)
        got = K.bloom_add(a, m2, kb, nv, k, m2, K.BITS)
        took = "fused" if K.launches["bloom_add"] > before["bloom_add"] else "pair"
        if took != route or K.use_fused_add(bank.numel(), nv, k) != (route == "fused"):
            raise AssertionError(f"bloom_add of {nv} ops took the {took} route, want {route}")
        err = max(err, assert_equal(f"bloom_add {route} route, {nv} ops", got,
                                    K.bloom_add_plain(b, m2, kb, nv, k, m2, K.BITS)))
        err = max(err, assert_equal(f"bloom_add {route} route, {nv} ops: plane", a, b))
        checked.append(f"bloom_add on the config-2 bank, {nv} ops: the {route} route")
    del bank, plane1, plane_edges, cases, a, b

    # config 1's add stream (as bloom_set's, newly counted as config 1 does):
    # the fused add and the probe-then-set pair, in turns on fresh planes.
    # A fused add must read every touched sector and write back the changed
    # ones, so its bound is both, plus the keys and the count.
    stream = [u64_batch(rng, n1, C1_BATCH, dev, dup=0.0) for _ in range(C1_N // n1)]
    routes = {
        "fused": lambda pl, kb: K.bloom_add_fused(pl, size1, kb, n1, k, m1, K.COUNT),
        "pair": lambda pl, kb: (K.bloom_probe(pl, size1, kb, n1, k, m1, True, K.COUNT),
                                K.bloom_set(pl, size1, kb, n1, k, m1))}
    plain = lambda pl, kb: K.bloom_add_plain(pl, size1, kb, n1, k, m1, K.COUNT)

    def add_bytes(kb, changed):
        return 32 * (sectors(probe_positions(kb, size1, size1, k, m1, n1)) + sectors(changed)) + 8 * n1 + 4

    times, first = {"fused": [], "pair": []}, {}
    for route in ("fused", "pair", "pair", "fused"):
        work = torch.zeros(size1, dtype=torch.uint8, device=dev)
        if route not in first:  # a route's first pass is checked against the plain version
            t, plain_t, nbytes_t, stream_err = time_stream(f"{route} add", routes[route], plain, work,
                                                           torch.zeros_like(work), stream, add_bytes)
            first[route] = (plain_t, nbytes_t)
            err = max(err, stream_err)
        else:
            t = time_kernel(lambda i: routes[route](work, stream[i]), reps=len(stream), warm=lambda: None)
        times[route].append(t)
        del work
    ms, pair_ms = statistics.median(times["fused"]), statistics.median(times["pair"])
    plain_ms, nbytes = first["fused"]
    bms, by = bound_ms(nbytes, n1 * (OPS_HASH_U64 + k * OPS_PROBE))
    checked.append(f"a stream of {len(stream)} add batches")
    del stream

    # config 2's populate: one window of ten 1M flushes into a zeroed bank,
    # packed as the facade packs it, one launch of each route
    client = redisson_tpu_torch.create()
    arr = client.get_bloom_filter_array("smoke:populate")
    arr.try_init(C2_TENANTS, C2_PER_TENANT, FPP)
    tlh, _, _ = arr._pack_flush_window(config2_ingest())
    arr.delete()
    client.shutdown()
    kb, nv = K._tlh_keys(tlh), tlh.shape[1]
    ref = torch.zeros((C2_TENANTS, m2), dtype=torch.uint8, device=dev)
    want = K.bloom_add_plain(ref, m2, kb, nv, k, m2, K.BITS)
    pop = {}
    for route in ("fused", "pair"):
        banks = [torch.zeros_like(ref) for _ in range(4)]

        def add(i, route=route, banks=banks):
            if route == "fused":
                return K.bloom_add_fused(banks[i], m2, kb, nv, k, m2, K.BITS)
            got = K.bloom_probe(banks[i], m2, kb, nv, k, m2, True, K.BITS)
            K.bloom_set(banks[i], m2, kb, nv, k, m2)
            return got

        pop[route] = time_kernel(lambda i: add(i + 1), reps=3, warm=lambda: add(0))
        err = max(err, assert_equal(f"config-2 populate, {route}", add(0, banks=[torch.zeros_like(ref)]), want))
        err = max(err, assert_equal(f"config-2 populate, {route}: bank", banks[1], ref))
        del banks
    touched = sectors(probe_positions(kb, m2, ref.numel(), k, m2, nv))
    written = int(torch.unique(ref.reshape(-1).nonzero().reshape(-1) // 32).numel())
    pop_bms, _ = bound_ms(32 * (touched + written) + 12 * nv + nv // 8, nv * (OPS_HASH_U64 + k * OPS_PROBE))
    checked.append(f"config-2 populate, {nv} ops in one window")
    del ref, want, tlh, kb
    torch.cuda.empty_cache()
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err, pair_ms=pair_ms,
               populate_ms=pop["fused"], populate_pair_ms=pop["pair"], populate_bound_ms=pop_bms,
               dispatch_probes_per_sector=K.FUSED_ADD_PROBES_PER_SECTOR, chunk_bytes=chunk,
               shape=f"config-1 add stream: {C1_N // n1} batches of {n1} new keys into a zeroed "
                     f"{size1}-lane plane, k={k}, count out", checked=checked)
    log(f"kernel bloom_add: {ms:.4f} ms per config-1 batch (probe-then-set pair {pair_ms:.4f} ms on the same "
        f"stream; plain {plain_ms:.3f} ms; bound {bms:.4f} ms by {by}); config-2 populate of {nv} ops: fused "
        f"{pop['fused']:.4f} ms, pair {pop['pair']:.4f} ms, bound {pop_bms:.4f} ms; equal to plain at {checked}")
    return out


def host_indexes(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """n int32 indexes in [lo, hi), the last 10% repeating the first."""
    idx = rng.integers(lo, hi, n).astype(np.int32)
    d = n // 10
    idx[n - d:] = idx[:d]
    return idx


def index_batch(rng, n: int, hi: int, dev) -> torch.Tensor:
    """host_indexes below `hi` on `dev`."""
    return torch.from_numpy(host_indexes(rng, n, 0, hi)).to(dev)


def check_bitset(dev, rng) -> dict:
    """bitset_get and bitset_set against their plain versions, bit for bit
    (replies and planes), at config 5's shape, on a 2**28-bit plane larger
    than L2, and at the edges; their times beside the bound (32-byte sectors
    touched, 5 bytes an op of index and reply), the plain versions' and
    index_select's (get) and index_put_'s (the write alone)."""
    from redisson_tpu_torch.client.objects.bitset import _DEFAULT_BITS
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import bittensor as bt

    checked, err = {"bitset_get": [], "bitset_set": []}, 0.0
    # edges: negative, out-of-range and repeated indexes, masked tails
    size = 4096
    plane = (torch.rand(size, device=dev) < 0.3).to(torch.uint8)
    idx = index_batch(rng, 1000, size, dev)
    idx[:10] = torch.tensor([-1, -size, -size - 1, size, size - 1, 0, 2**31 - 1, -(2**31), 5, 5],
                            dtype=torch.int32, device=dev)
    err = max(err, assert_equal("bitset_get edges", K.bitset_get(plane, idx), K.bitset_get_plain(plane, idx)))
    # 1000 ops take the one-block form, 6000 the cooperative grid, whose
    # repeats (ops 4000-4999 repeat ops 0-999) lie in other blocks
    big = torch.cat([idx, index_batch(rng, 3000, size, dev), idx, index_batch(rng, 1000, size, dev)])
    for ops, n_valids in ((idx, (0, 1, 963, 1000)), (big, (0, 1, 2048, 2049, 4500, 6000))):
        for n_valid in n_valids:
            for value in (0, 1):
                a, b = plane.clone(), plane.clone()
                got, want = K.bitset_set(a, ops, n_valid, value)[1], K.bitset_set_plain(b, ops, n_valid, value)[1]
                label = f"bitset_set edges, {ops.numel()} ops, n_valid={n_valid} value={value}"
                err = max(err, assert_equal(label, got, want))
                err = max(err, assert_equal(f"{label}: plane", a, b))
    for name in checked:
        checked[name].append("4096-lane plane, 1000 ops: negative, out-of-range and repeated indexes"
                             + (", n_valid 0 / 1 / 963 / 1000, value 0 and 1; 6000 ops (the cooperative form) "
                                "repeating ops 0-999 at 4000-4999, n_valid 0 / 1 / 2048 / 2049 / 4500 / 6000"
                                if name == "bitset_set" else ""))
    shapes = {"": (bt.padded_size(_DEFAULT_BITS), C5_BITS, C5_BIT_OPS),
              "bitmap_2_28_": (1 << BITMAP_LOG2, 1 << BITMAP_LOG2, BITMAP_OPS)}
    get, put = {}, {}
    for key, (size, hi, n) in shapes.items():
        label = f"{size}-lane plane, {n} indexes below {hi}, 10% repeated"
        plane = (torch.rand(size, device=dev) < 0.3).to(torch.uint8)
        batches = [index_batch(rng, n, hi, dev) for _ in range(20)]
        for b in batches[:3]:
            err = max(err, assert_equal(f"bitset_get {label}", K.bitset_get(plane, b), K.bitset_get_plain(plane, b)))
            x, y = plane.clone(), plane.clone()
            err = max(err, assert_equal(f"bitset_set {label}", K.bitset_set(x, b, n, 1)[1],
                                        K.bitset_set_plain(y, b, n, 1)[1]))
            err = max(err, assert_equal(f"bitset_set {label}: plane", x, y))
        del x, y
        touched = statistics.median(sectors(b.long()) for b in batches)
        get[key + "ms"] = time_kernel(lambda i: K.bitset_get(plane, batches[i]))
        get[key + "plain_ms"] = time_plain(lambda i: K.bitset_get_plain(plane, batches[i]))
        get[key + "library_ms"] = time_kernel(lambda i: torch.index_select(plane, 0, batches[i]))
        get[key + "bound_ms"], get[key + "bound_by"] = bound_ms(32 * touched + 5 * n, 0)
        # a stream of 20 new batches setting bits, each on the plane the
        # batches before it left; the write is bound by the sectors read and
        # the sectors changed
        ms, plain_ms, nbytes, stream_err = time_stream(
            "bitset_set", lambda pl, b: K.bitset_set(pl, b, n, 1), lambda pl, b: K.bitset_set_plain(pl, b, n, 1),
            plane.clone(), plane.clone(), batches,
            lambda b, changed: 32 * (sectors(b.long()) + sectors(changed)) + 5 * n)
        ones = torch.ones(n, dtype=torch.uint8, device=dev)
        lib = plane.clone()
        put.update({key + "ms": ms, key + "plain_ms": plain_ms,
                    key + "library_ms": time_kernel(lambda i: lib.index_put_((batches[i],), ones))})
        put[key + "bound_ms"], put[key + "bound_by"] = bound_ms(nbytes, 0)
        err = max(err, stream_err)
        for name in checked:
            checked[name].append(label + (", a stream of 20 batches" if name == "bitset_set" else ""))
        del plane, batches, lib
        torch.cuda.empty_cache()
    groups = check_bitset_groups(dev, rng)
    for name in checked:
        checked[name].append(f"the table form at fanout's level ({2 * C5_TENANTS} planes x {C5_BIT_OPS} ops) and "
                             "on an edge table (both set forms)")
    get.update(groups["bitset_get"])
    put.update(groups["bitset_set"])
    err = max(err, groups["bitset_get"]["groups_max_abs_err"])
    results = {}
    for name, r in (("bitset_get", get), ("bitset_set", put)):
        results[name] = dict(r, max_abs_err=err, checked=checked[name],
                             shape=f"config 5's SETBITSB: {C5_BIT_OPS} indexes below {C5_BITS} "
                                   f"in a {bt.padded_size(_DEFAULT_BITS)}-lane plane")
        log(f"kernel {name}: {r['ms']:.4f} ms at config 5's shape (plain {r['plain_ms']:.3f} ms, "
            f"{'index_select' if name == 'bitset_get' else 'index_put_'} {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms); {BITMAP_OPS} ops on 2**{BITMAP_LOG2} lanes {r['bitmap_2_28_ms']:.4f} ms "
            f"(plain {r['bitmap_2_28_plain_ms']:.3f}, library "
            f"{r['bitmap_2_28_library_ms']:.4f}, bound {r['bitmap_2_28_bound_ms']:.4f}); equal to plain at "
            f"{checked[name]}")
    return results


def assert_groups_equal(label: str, planes, idx, values) -> float:
    """kernels.bitset_groups against bitset_groups_plain on clones of the
    planes, bit for bit (replies and planes)."""
    from redisson_tpu_torch.core import kernels as K

    ref = [p.clone() for p in planes]
    got, firsts = K.bitset_groups(planes, idx, values)
    want, wfirsts = K.bitset_groups_plain(ref, torch.from_numpy(np.concatenate(idx)).to(planes[0].device),
                                          [a.size for a in idx], values)
    err = 0.0
    for g, a in enumerate(idx):
        err = max(err, assert_equal(f"{label}: group {g} replies", got[firsts[g]:firsts[g] + a.size],
                                    want[wfirsts[g]:wfirsts[g] + a.size]))
    for g, (p, r) in enumerate(zip(planes, ref)):
        err = max(err, assert_equal(f"{label}: group {g} plane", p, r))
    return err


def check_bitset_groups(dev, rng) -> dict:
    """The table form (kernels.bitset_groups: one upload, one bitset_get
    launch for a level's reads and one bitset_set launch for its sets)
    against its plain version, bit for bit: at fanout's shape (a level of
    config 5's 2 x 64 bit sets, 500 indexes below 100,000 on a 1 MiB plane
    each, all reads or all sets) and on an edge table (planes of 4,096 to
    2**21 + 4,096 lanes, negative and out-of-plane indexes, repeats, one-op
    groups, reads and both values; once with a set group past 2,048 ops,
    the cooperative form, once within the one-block form).  The fanout
    levels' device time (staged beforehand: the launches alone) beside 128
    one-plane launches of the same ops (the per-group path's), the plain
    version and the bound (32-byte sectors touched, 5 bytes an op, 32 a
    group)."""
    from redisson_tpu_torch.client.objects.bitset import _DEFAULT_BITS
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import bittensor as bt

    err = 0.0
    edge_sizes = [4096, 4099, (1 << 21) + 4096, 100, 4096, 1 << 16, 7, 1 << 20]
    edge_values = [None, 1, 1, 0, None, 0, None, 1]
    for label, big in (("cooperative", 5000), ("one-block", 2000)):
        counts = [300, 1, 700, 50, 1, big, 20, 2100 if big > 2048 else 900]
        planes = [(torch.rand(size, device=dev) < 0.3).to(torch.uint8) for size in edge_sizes]
        idx = [host_indexes(rng, n, -2 * size, 2 * size) for size, n in zip(edge_sizes, counts)]
        for a, size in zip(idx, edge_sizes):  # negative and out-of-plane edges
            a[: min(6, a.size)] = [-1, 2**31 - 1, -(2**31), 0, size, -size][: min(6, a.size)]
        err = max(err, assert_groups_equal(f"bitset_groups edge table ({label} form)", planes, idx, edge_values))
        del planes
    groups, size = 2 * C5_TENANTS, bt.padded_size(_DEFAULT_BITS)
    out = {"bitset_get": {}, "bitset_set": {}}
    for name, value in (("bitset_get", None), ("bitset_set", 1)):
        planes = [(torch.rand(size, device=dev) < 0.3).to(torch.uint8) for _ in range(groups)]
        values = [value] * groups
        batches = [[host_indexes(rng, C5_BIT_OPS, 0, C5_BITS) for _ in range(groups)] for _ in range(21)]
        idx = batches.pop()
        err = max(err, assert_groups_equal(f"{name} at fanout's level", planes, idx, values))
        levels = [K.bitset_stage(planes, b, values) for b in batches]
        single = [[torch.from_numpy(a).to(dev) for a in b] for b in batches]
        flat = [torch.from_numpy(np.concatenate(b)).to(dev) for b in batches]
        touched = statistics.median(sum(sectors(a.long()) for a in b) for b in single)
        r = out[name]
        r["fanout_ms"] = time_kernel(lambda i: K.bitset_launch(planes, levels[i]))
        if value is None:
            r["fanout_single_ms"] = time_kernel(lambda i: [K.bitset_get(p, a) for p, a in zip(planes, single[i])])
        else:
            r["fanout_single_ms"] = time_kernel(
                lambda i: [K.bitset_set(p, a, C5_BIT_OPS, 1) for p, a in zip(planes, single[i])])
        r["fanout_plain_ms"] = time_plain(
            lambda i: K.bitset_groups_plain(planes, flat[i], [C5_BIT_OPS] * groups, values))
        # a set dirties each sector it changes once more: bounded below by the reads
        r["fanout_bound_ms"] = bound_ms(32 * touched + 5 * groups * C5_BIT_OPS + 32 * groups, 0)[0]
        log(f"kernel {name}, table form at fanout's level ({groups} planes of {size} lanes x {C5_BIT_OPS} ops): "
            f"{r['fanout_ms']:.4f} ms one launch against {r['fanout_single_ms']:.4f} ms for {groups} one-plane "
            f"launches (plain {r['fanout_plain_ms']:.3f} ms, bound {r['fanout_bound_ms']:.5f} ms)")
        del planes, levels, single, flat
        torch.cuda.empty_cache()
    for r in out.values():
        r["groups_max_abs_err"] = err
    return out


def config4_values() -> list:
    """The values of config 4's map (bench.py:352-361): one draw of
    (1M, 8) word ids, seed 3, equal to the bench's per-entry draws."""
    ids = np.random.default_rng(C4_SEED).integers(0, C4_VOCAB, (C4_ENTRIES, C4_WORDS))
    vocab = [f"w{i}" for i in range(C4_VOCAB)]
    return [" ".join([vocab[j] for j in row]) for row in ids.tolist()]


def wc_chunks(values: list, dev) -> list:
    """word_count's two chunks of `values`: (buffer on `dev`, words, eb, base)."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.services import mapreduce as MR

    half = (len(values) + 1) // 2
    out, base = [], 0
    for part in (values[:half], values[half:]):
        _, buf, n_ends = MR._wc_chunk_bytes(part)
        out.append((torch.from_numpy(buf).to(dev), n_ends, K.bucket_size(max(1, n_ends)), base))
        base += buf.size
    return out


def key_sums(keys, vals, n_keys):
    """Per key, in float64: the count, sum |v| and sum v**2 of the values
    whose key segment_reduce keeps (a key in [-n_keys, 0) wraps once)."""
    k = keys.to(torch.int64)
    k = torch.where(k < 0, k + n_keys, k)
    keep = (k >= 0) & (k < n_keys)
    k, v = k[keep], vals[keep].to(torch.float64)
    zeros = torch.zeros(n_keys, dtype=torch.float64, device=vals.device)
    return (zeros.clone().index_add_(0, k, torch.ones_like(v)), zeros.clone().index_add_(0, k, v.abs()),
            zeros.clone().index_add_(0, k, v * v))


def float_sum_limit(keys, vals, n_keys):
    """The limit on two float32 sums of one key's zero-mean values added in
    different orders: 8 * 2**-24 * sqrt(count * sum v**2) a key.  One order's
    rounding error grows about as 2**-24 * count * rms(v) / sqrt(6), since
    the partial sums walk as sqrt(i) * rms(v); the limit is about four times
    the largest difference read on an H100 80GB HBM3 at 700 W (1.02 against
    3.9 at segment_reduce's 8,388,608 values of N(0, 1000) into 1,024 keys),
    and it bounds any order for counts up to 5."""
    cnt, _, sq = key_sums(keys, vals, n_keys)
    return 8 * 2.0**-24 * torch.sqrt(cnt * sq)


def check_wordcount(dev, rng, values: list) -> dict:
    """wc_words (both entry points), wc_sort_runs and segment_reduce against
    their plain versions on the card: the word-count kernels bit for bit at
    config 4's shapes (its two chunks, the 8,388,608-row stream) and at the
    edges, segment_reduce on 8,388,608 values into 1,024 keys with negative
    and out-of-range keys (int32, whole float32 values and float32 max and
    min exact, the float32 sum of N(0, 1000) within float_sum_limit); times
    beside the bound, the plain
    versions' and the library call's (torch.sort, scatter_reduce_)."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.services import mapreduce as MR
    from redisson_tpu_torch.utils import hashing as H

    def same3(label, got, want):
        return max(assert_equal(f"{label} {name}", g, w) for name, g, w in zip(("ha", "hb", "start"), got, want))

    chunks = wc_chunks(values, dev)
    err, checked = 0.0, []
    for i, (buf, n, eb, base) in enumerate(chunks):
        err = max(err, same3(f"wc_words auto chunk {i}", K.wc_extract_words_auto(buf, n, eb, base),
                             K.wc_extract_words_auto_plain(buf, n, eb, base)))
    checked.append(f"config 4's chunks ({chunks[0][0].numel()} and {chunks[1][0].numel()} bytes, "
                   f"eb {chunks[0][2]} and {chunks[1][2]}), auto form")
    buf0 = chunks[0][0].cpu().numpy()
    ws = buf0 == 32
    ends = np.nonzero(~ws & np.concatenate([ws[1:], [True]]))[0]
    deltas = torch.from_numpy(np.diff(np.concatenate([[-1], ends])).astype(np.int32)).to(dev)
    err = max(err, same3("wc_words deltas chunk 0", K.wc_extract_words(chunks[0][0], deltas, len(ends), 0),
                         K.wc_extract_words_plain(chunks[0][0], deltas, len(ends), 0)))
    checked.append("config 4's first chunk, delta form")
    # the first chunk as a slice 5 bytes past a 16-byte boundary
    big = torch.full((chunks[0][0].numel() + 16,), 32, dtype=torch.uint8, device=dev)
    sliced = big[5: 5 + chunks[0][0].numel()]
    sliced.copy_(chunks[0][0])
    err = max(err, same3("wc_words auto, the first chunk unaligned",
                         K.wc_extract_words_auto(sliced, *chunks[0][1:]),
                         K.wc_extract_words_auto_plain(sliced, *chunks[0][1:])))
    del big, sliced
    checked.append("config 4's first chunk 5 bytes past a 16-byte boundary, auto form")
    long_vals = ["x" * 200 + " short " + "y" * 64, "z" * 63 + " " + "z" * 64, "a\tb\nc\x0bd\x0ce\rf",
                 "g\x1ch\x1di\x1ej\x1fk", "  lead and  double  "] * 50
    _, lbuf, ln = MR._wc_chunk_bytes(long_vals)
    raw = np.frombuffer(b"last byte not space" * 40, np.uint8).copy()
    edges = [("words over 63 bytes and control whitespace", lbuf, ln, K.bucket_size(ln)),
             ("a last byte that is not whitespace", raw, 80, 80),
             ("eb below the end count", lbuf, ln, ln // 3),
             ("n_words 0", lbuf, 0, 256)]
    for label, b, n, eb in edges:
        t = torch.from_numpy(b).to(dev)
        err = max(err, same3(f"wc_words {label}", K.wc_extract_words_auto(t, n, eb, 77),
                             K.wc_extract_words_auto_plain(t, n, eb, 77)))
        d = torch.from_numpy(rng.integers(0, 90, eb).astype(np.int32)).to(dev)
        err = max(err, same3(f"wc_words deltas {label}", K.wc_extract_words(t, d, n, 2**32 - 9),
                             K.wc_extract_words_plain(t, d, n, 2**32 - 9)))
        checked.append(label + ", both forms")
    buf, n, eb, base = chunks[0]
    words = {"ms": time_kernel(lambda i: K.wc_extract_words_auto(buf, n, eb, base)),
             "deltas_ms": time_kernel(lambda i: K.wc_extract_words(buf, deltas, len(ends), base)),
             "plain_ms": time_plain(lambda i: K.wc_extract_words_auto_plain(buf, n, eb, base)),
             "deltas_plain_ms": time_plain(lambda i: K.wc_extract_words_plain(buf, deltas, len(ends), base)),
             "library_ms": None}
    # the buffer read once, three uint32 written a row (the delta form also
    # reads a delta a row)
    words["bound_ms"], words["bound_by"] = bound_ms(buf.numel() + 12 * eb, OPS_WC_BYTE * buf.numel())
    words["deltas_bound_ms"], _ = bound_ms(buf.numel() + 16 * len(ends), OPS_WC_BYTE * buf.numel())
    words.update(max_abs_err=err, checked=checked,
                 shape=f"config 4's first chunk: {buf.numel()} bytes, {n} words, eb {eb}")

    # -- wc_sort_runs ------------------------------------------------------
    parts = [K.wc_extract_words_auto(b, n, eb, base) for b, n, eb, base in chunks]
    ha, hb, st = (torch.cat([p[i] for p in parts]) for i in range(3))
    err, checked = assert_equal("wc_sort_runs config 4", K.wc_sort_runs(ha, hb, st, WC_D_MAX),
                                K.wc_sort_runs_plain(ha, hb, st, WC_D_MAX)), [f"config 4's {ha.numel()}-row stream, d_max 2**17"]
    small = K.wc_extract_words_auto(torch.from_numpy(lbuf).to(dev), ln, 512, 0)
    err = max(err, assert_equal("wc_sort_runs N < d_max", K.wc_sort_runs(*small, WC_D_MAX),
                                K.wc_sort_runs_plain(*small, WC_D_MAX)))
    checked.append("a 512-row stream, N < d_max")
    distinct = [torch.from_numpy(rng.integers(0, 2**32, 300_000, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)
                for _ in range(3)]
    got = K.wc_sort_runs(*distinct, WC_D_MAX)
    err = max(err, assert_equal("wc_sort_runs all distinct", got, K.wc_sort_runs_plain(*distinct, WC_D_MAX)))
    if int(got[0, -1]) >= 300_000:
        raise AssertionError("wc_sort_runs: an all-distinct stream must fill d_max with run starts")
    checked.append("300,000 distinct rows, overflowing d_max")
    n_rows, d = ha.numel(), min(ha.numel(), WC_D_MAX)
    key = ((H.lanes(ha) << 32) | H.lanes(hb)) ^ (-(2**63))
    sort = {"ms": time_kernel(lambda i: K.wc_sort_runs(ha, hb, st, WC_D_MAX)),
            "plain_ms": time_plain(lambda i: K.wc_sort_runs_plain(ha, hb, st, WC_D_MAX)),
            "library_ms": time_kernel(lambda i: torch.sort(key, stable=True))}
    sort["bound_ms"], sort["bound_by"] = bound_ms(12 * n_rows + 8 * d, 0)
    # the one-sweep design's own bytes: the histogram of every pass's digits
    # (8 a row), 8 passes that each read a key and a start and write them
    # (24), the run count (8) and the partition (12, and 8 an output row)
    sort["design_bound_ms"], _ = bound_ms((8 + 8 * 24 + 8 + 12) * n_rows + 8 * d, 0)
    sort.update(max_abs_err=err, checked=checked, shape=f"config 4's stream: {n_rows} rows, d_max 2**17")
    del ha, hb, st, parts, key

    # -- segment_reduce ----------------------------------------------------
    ivals = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, KMR_N).astype(np.int32)).to(dev)
    fvals = torch.from_numpy(rng.normal(0, 1000, KMR_N).astype(np.float32)).to(dev)
    # whole floats: while every key's sum |v| stays below 2**24, each partial
    # sum is exact, so any order of the float32 sum is held bit for bit
    whole = torch.from_numpy(rng.integers(-1000, 1001, KMR_N).astype(np.float32)).to(dev)
    keys = torch.remainder(ivals, KMR_KEYS)
    bad = keys.clone()
    pick = torch.from_numpy(rng.integers(0, KMR_N, KMR_N // 50)).to(dev)
    bad[pick] = torch.from_numpy(rng.integers(-3 * KMR_KEYS, 3 * KMR_KEYS, pick.numel()).astype(np.int32)).to(dev)
    err, sum_err, checked = 0.0, 0.0, []
    for label, k in (("keys in range", keys), ("2% of keys negative or out of range", bad)):
        if not float(key_sums(k, whole, KMR_KEYS)[1].max()) < 2**24:
            raise AssertionError(f"segment_reduce {label}: a key's whole float32 values reach 2**24")
        for v, kind in ((ivals, "int32"), (whole, "whole float32"), (fvals, "float32")):
            for reduce in K.SEGMENT_OPS:
                got = K.segment_reduce(k, v, KMR_KEYS, reduce)
                want = K.segment_reduce_plain(k, v, KMR_KEYS, reduce)
                name = f"segment_reduce {reduce} {kind} {label}"
                if v is fvals and reduce == "sum":
                    torch.cuda.synchronize()
                    diff = (got.double() - want.double()).abs()
                    if not bool((diff <= float_sum_limit(k, v, KMR_KEYS)).all()):
                        raise AssertionError(f"{name}: beyond the float32 sum's limit")
                    sum_err = max(sum_err, diff.max().item())
                else:
                    err = max(err, assert_equal(name, got, want))
        checked.append(f"{KMR_N} values into {KMR_KEYS} keys, {label}: sum, max, min of int32, of whole float32 "
                       "values (sum exact) and of N(0, 1000) float32 (the sum within 8 * 2**-24 * "
                       "sqrt(count * sum v**2) a key)")
    # a NaN wins its slot in a float32 max or min, as in XLA's
    nan_vals = fvals.clone()
    nan_vals[::9973] = float("nan")
    for reduce in ("max", "min"):
        err = max(err, assert_equal(f"segment_reduce {reduce} float32 with NaN", K.segment_reduce(bad, nan_vals, KMR_KEYS, reduce),
                                    K.segment_reduce_plain(bad, nan_vals, KMR_KEYS, reduce), equal_nan=True))
    del nan_vals
    checked.append(f"{KMR_N} float32 values into {KMR_KEYS} keys, 2% of keys negative or out of range, one in "
                   "9,973 NaN: max and min, the NaN kept")
    keys64 = keys.long()
    zeros = torch.zeros(KMR_KEYS, dtype=torch.int32, device=dev)
    seg = {"ms": time_kernel(lambda i: K.segment_reduce(keys, ivals, KMR_KEYS, "sum")),
           "plain_ms": time_plain(lambda i: K.segment_reduce_plain(keys, ivals, KMR_KEYS, "sum")),
           "library_ms": time_kernel(lambda i: zeros.clone().scatter_reduce_(0, keys64, ivals, "sum")),
           "max_ms": time_kernel(lambda i: K.segment_reduce(keys, fvals, KMR_KEYS, "max")),
           "max_plain_ms": time_plain(lambda i: K.segment_reduce_plain(keys, fvals, KMR_KEYS, "max")),
           "max_library_ms": time_kernel(lambda i: torch.full((KMR_KEYS,), -float("inf"), device=dev).scatter_reduce_(
               0, keys64, fvals, "amax"))}
    seg["bound_ms"], seg["bound_by"] = bound_ms(8 * KMR_N + 4 * KMR_KEYS, OPS_SEGMENT * KMR_N)
    # the float32 max moves the same bytes and makes the same atomics
    seg["max_bound_ms"], _ = bound_ms(8 * KMR_N + 4 * KMR_KEYS, OPS_SEGMENT * KMR_N)
    seg.update(max_abs_err=max(err, sum_err), float_sum_max_abs_err=sum_err, checked=checked,
               shape=f"KernelMapReduce sum: {KMR_N} int32 values into {KMR_KEYS} keys (v % {KMR_KEYS})")
    del ivals, fvals, keys, bad, keys64
    torch.cuda.empty_cache()
    # the launches one wrapper call makes (csrc/wordcount.cu, csrc/segment.cu)
    per_call = {"wc_words": "1 launch a call: tiles by ticket, 16-byte loads, decoupled look-back ranks, "
                            "one lane a word, a round's rows written by the block with 16-byte stores (the "
                            "delta form: a 3-launch scan, words)",
                "wc_sort_runs": "12 launches a call (and a memset of the look-back status): a histogram "
                                "of every pass's digits, 8 one-sweep passes (tile ticket, rank, decoupled "
                                "look-back, write in digit order), run count, scan, partition",
                "segment_reduce": "1 launch a call up to the shared limit: 16-byte loads, shared copies "
                                  "merged a cluster at a time, the first cluster's copy stored and the others' "
                                  "added by global atomics (past it: fill, global atomics)"}
    for name, r in (("wc_words", words), ("wc_sort_runs", sort), ("segment_reduce", seg)):
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        r["launches_per_call"] = per_call[name]
        log(f"kernel {name} ({per_call[name]}): {r['ms']:.4f} ms at {r['shape']} (plain {r['plain_ms']:.3f} ms, "
            f"library {lib}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
            + (f", the one-sweep design's bytes {r['design_bound_ms']:.4f} ms" if "design_bound_ms" in r else "")
            + (f", delta form {r['deltas_ms']:.4f} ms (plain {r['deltas_plain_ms']:.3f}, bound "
               f"{r['deltas_bound_ms']:.4f})" if "deltas_ms" in r else "")
            + (f", float32 max {r['max_ms']:.4f} ms (plain {r['max_plain_ms']:.3f}, library "
               f"{r['max_library_ms']:.4f} scatter_reduce_ amax, bound {r['max_bound_ms']:.4f})"
               if "max_ms" in r else "")
            + f"); equal to plain at {r['checked']}")
    return {"wc_words": words, "wc_sort_runs": sort, "segment_reduce": seg}


# --------------------------------------------------------------------------
# phase 3, vector search: knn_score, knn_select, ivf_score, kmeans
# --------------------------------------------------------------------------

def c7_cap(n: int) -> int:
    """The capacity a bank of n rows reaches: 256 rows, doubled until n fit
    (services/vector.py DEFAULT_BLOCK and its growth)."""
    cap = 256
    while cap < n:
        cap *= 2
    return cap


def vec_bank(rng, cap, w, dtype, dev):
    """A (cap, w) bank made from the seed, in `dtype` (INT8 with its per-row
    scale, as quantize_row makes it); rows 5-7 copy rows 1-3 (exact ties)
    and row 9 is zeros (COSINE distance 1)."""
    rows = rng.standard_normal((cap, w), dtype=np.float32)
    rows[5:8] = rows[1:4]
    rows[9] = 0.0
    scale = None
    if dtype == "FLOAT16":
        bank = torch.from_numpy(rows.astype(np.float16)).to(dev)
    elif dtype == "INT8":
        sc = np.abs(rows).max(1) / np.float32(127.0)
        sc[sc == 0] = 1.0
        bank = torch.from_numpy(np.clip(np.rint(rows / sc[:, None]), -127, 127).astype(np.int8)).to(dev)
        scale = torch.from_numpy(sc.astype(np.float32)).to(dev)
    else:
        bank = torch.from_numpy(rows).to(dev)
    del rows
    return bank, scale


def dist_scale(rows, q, metric: str) -> float:
    """The size of the terms a distance is made of: |q|^2 + |b|^2 for L2,
    |q| |b| for IP, 1 for COSINE; distances are held within DIST_TOL of it."""
    if metric == "L2":
        return float((q * q).sum(1).max() + (rows * rows).sum(1).max())
    if metric == "IP":
        return max(1.0, float(q.norm(dim=1).max() * rows.norm(dim=1).max()))
    return 1.0


def assert_near(name: str, got, want, scale: float) -> float:
    """Raise unless got and want are +inf at the same places and within
    DIST_TOL * scale elsewhere; return the largest difference."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if got.shape != want.shape or not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{name}: +inf at other places than the plain version's")
    diff = (got - want).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    if err > DIST_TOL * scale:
        raise AssertionError(f"{name}: {err} from the plain version, over {DIST_TOL} x {scale}")
    return err


def assert_ids_outside_near_ties(name: str, got_i, want_i, want_d) -> int:
    """Raise unless the ids are equal wherever the plain version's distance
    stands more than TIE_GAP (relative) from both neighbours; +inf places
    are not compared.  Returns the places compared."""
    torch.cuda.synchronize()
    d = want_d.double()
    gap = (d[:, 1:] - d[:, :-1]).abs() > TIE_GAP * d[:, 1:].abs().clamp(min=1.0)
    ok = torch.isfinite(d)
    ok[:, 1:] &= gap
    ok[:, :-1] &= gap
    if not torch.equal(got_i[ok], want_i[ok]):
        raise AssertionError(f"{name}: ids differ from the plain version's outside near-ties")
    return int(ok.sum())


def knn_bytes(bank, scale, bias, qbias, r: int, c: int, w: int) -> int:
    """knn_score's bytes: the bank, its scale and bias, the queries and the
    per-query bias read once, the distances written once."""
    return (bank.numel() * bank.element_size() + (0 if scale is None else 4 * c) + (0 if bias is None else 4 * c)
            + 4 * r * w + (0 if qbias is None else 4 * r * c) + 4 * r * c)


def kmeans_update_reference(pts, w, cent, assign):
    """kmeans_update's contract in numpy float32: each cell's sums of point
    * weight and of weights in row order (np.add.at adds in index order,
    one rounding a term), divided by max(weights, 1); an empty cell keeps
    its centroid."""
    live = assign >= 0
    sums, cnt = np.zeros_like(cent), np.zeros(cent.shape[0], np.float32)
    np.add.at(sums, assign[live], pts[live] * w[live, None])
    np.add.at(cnt, assign[live], w[live])
    return np.where(cnt[:, None] > 0, sums / np.maximum(cnt, np.float32(1))[:, None], cent)


# traces of one call that kernels_per_call takes before it gives up on an
# empty one, and processes that kernels_a_call starts before it does
TRACE_ATTEMPTS = 3
CHILD_ATTEMPTS = 3


def kernels_per_call(fn):
    """CUDA kernels one call of fn launches, read from a torch.profiler trace
    of that call (memsets and copies not counted); None where the profiler
    records no device activity in any of TRACE_ATTEMPTS traces (CUPTI on
    the card's machine now and then hands back an empty one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_ATTEMPTS):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        except RuntimeError as exc:  # a trace that cannot start measures nothing; the kernel ran above
            log(f"torch.profiler: {exc}")
            continue
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = sum(1 for n in names if not n.startswith(("Memset", "Memcpy")))
        if kernels:
            return kernels
        log(f"torch.profiler: an empty trace (attempt {attempt + 1} of {TRACE_ATTEMPTS})")
    return None


def kernels_a_call_here(dev, only=None) -> dict:
    """Kernels one call launches, by torch.profiler (kernels_per_call), for
    each wrapper held to one kernel a call, at the shapes the main path gives
    it: bitset_get and bitset_set at config 5's shape (bitset_set's
    one-block form), on 1M indexes into 2**28 lanes (its cooperative
    form) and in the table form at fanout's level (128 planes, all reads or
    all sets: one kernel a verb); kmeans_assign at config 7's training
    shape (the tensor-core route) and at KMEANS_WIDE (the tile route), and
    kmeans_update on each assignment (two kernels); knn_select (k 10) at 64 x
    1,048,576 and 64 x 65,536, the IVF route's 64 x 1,536 (k = nprobe) and
    the IVF candidates' 64 x nprobe x 112 slots with ids (config 7's cells
    hold 112).  Run in a process of its own (--kernels-a-call): in this
    script's long process torch.profiler's traces come back empty after the
    first few.  `only` (a set of keys) limits the counts to those keys."""
    from redisson_tpu_torch.client.objects.bitset import _DEFAULT_BITS
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import bittensor as bt

    rng = np.random.default_rng(5)
    counts = {}

    def measure(key, fn):
        if only is None or key in only:
            counts[key] = kernels_per_call(fn)
    for key, (size, hi, n) in {"config5": (bt.padded_size(_DEFAULT_BITS), C5_BITS, C5_BIT_OPS),
                               "bitmap_2_28": (1 << BITMAP_LOG2, 1 << BITMAP_LOG2, BITMAP_OPS)}.items():
        plane = torch.zeros(size, dtype=torch.uint8, device=dev)
        idx = index_batch(rng, n, hi, dev)
        measure(f"bitset_get {key}", lambda: K.bitset_get(plane, idx))
        measure(f"bitset_set {key}", lambda: K.bitset_set(plane, idx, n, 1))
        del plane, idx
    groups = 2 * C5_TENANTS
    planes = [torch.zeros(bt.padded_size(_DEFAULT_BITS), dtype=torch.uint8, device=dev) for _ in range(groups)]
    idx = [host_indexes(rng, C5_BIT_OPS, 0, C5_BITS) for _ in range(groups)]
    for wrapper, value in (("bitset_get", None), ("bitset_set", 1)):
        measure(f"{wrapper} table form, fanout's level of {groups}",
                lambda: K.bitset_groups(planes, idx, [value] * groups))
    del planes
    n, w, nlist = C7_POINTS[1][0], C7_POINTS[1][1], C7_NLIST
    for label, (rows, width, cents) in (("tensor-core", (n, w, nlist)), ("tile", KMEANS_WIDE)):
        pts = torch.randn((rows, width), device=dev)
        cent, wt = pts[:cents].clone(), torch.ones(rows, device=dev)
        measure(f"kmeans_assign {label} {rows} x {width} x {cents}", lambda: K.kmeans_assign(pts, wt, cent))
        assign = K.kmeans_assign(pts, wt, cent)
        measure(f"kmeans_update {rows} x {width} x {cents}", lambda: K.kmeans_update(pts, wt, cent, assign))
        del pts, cent, wt, assign
    shapes = [(c7_cap(C7_SIFT[0]), C7_K, False), (c7_cap(C7_POINTS[1][0]), C7_K, False)]
    shapes += [(nlist, nprobe, False) for nprobe in C7_NPROBES] + [(112 * nprobe, C7_K, True) for nprobe in C7_NPROBES]
    for cols, k, with_ids in shapes:
        d = torch.randn((C7_QB, cols), device=dev)
        ids = torch.randint(0, 1 << 20, (C7_QB, cols), dtype=torch.int32, device=dev) if with_ids else None
        measure(f"knn_select {C7_QB} x {cols} k {k}{' ids' if with_ids else ''}",
                lambda: K.knn_select(d, k, ids))
        del d, ids
    buf, n, eb, base = wc_chunks(config4_values(), dev)[0]
    host = buf.cpu().numpy()
    ws = host == 32
    deltas = torch.from_numpy(np.diff(np.concatenate([[-1], np.nonzero(~ws & np.concatenate(
        [ws[1:], [True]]))[0]])).astype(np.int32)).to(dev)
    measure("wc_words auto, config 4's first chunk", lambda: K.wc_extract_words_auto(buf, n, eb, base))
    measure("wc_words deltas, config 4's first chunk", lambda: K.wc_extract_words(buf, deltas, deltas.numel(), base))
    del buf, deltas
    vals = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, KMR_N).astype(np.int32)).to(dev)
    keys = torch.remainder(vals, KMR_KEYS)
    for label, v, reduce in (("int32 sum", vals, "sum"), ("float32 max", vals.to(torch.float32), "max")):
        measure(f"segment_reduce {label}, {KMR_N} x {KMR_KEYS}",
                lambda: K.segment_reduce(keys, v, KMR_KEYS, reduce))
    past = K.segment_shared_keys(dev) + 1
    measure(f"segment_reduce past the shared limit, {KMR_N} x {past}",
            lambda: K.segment_reduce(vals, vals, past, "sum"))
    if only is None or K25_KEY in only:
        import types

        from redisson_tpu_torch.core.engine import Engine
        from redisson_tpu_torch.server.verbs.admin import _dev_probe

        eng = Engine(device=dev)
        eng.enable_placement(n_devices=FA_POSITIONS)
        try:
            measure(K25_KEY, lambda: _dev_probe(types.SimpleNamespace(engine=eng), FA_POSITIONS - 1))
        finally:
            eng.shutdown()
    return counts


# the most kernels one call of a wrapper may launch, by the start of its
# kernels_a_call_here key (every other: exactly 1): kmeans_update's bucket
# and mean kernels; wc_words' delta form (off the main path): a three-launch
# scan of the deltas, then the words; segment_reduce past the shared limit
# (off the main path): a fill, then global atomics; K25c, DEVPROBE's ping
# (torch ops, not a hand kernel): the arange, then the add (its launches on
# the faults path are its probes times its count)
K25_KEY = "K25c DEVPROBE ping"
KERNELS_A_CALL = {"kmeans_update": 2, "wc_words deltas": 4, "segment_reduce past the shared limit": 2,
                  K25_KEY: 2}


def kernels_allowed(key: str) -> int:
    return next((v for k, v in KERNELS_A_CALL.items() if key.startswith(k)), 1)


def kernels_a_call() -> dict:
    """kernels_a_call_here's counts, taken in a child process of this
    script; raises unless each call launched one kernel, or between one and
    KERNELS_A_CALL's count for the wrappers listed there.  A key whose
    traces all came back empty is counted again in a new child, up to
    CHILD_ATTEMPTS children in all."""
    here = os.path.abspath(__file__)
    counts, only = {}, None
    for _ in range(CHILD_ATTEMPTS):
        args = [] if only is None else [json.dumps(sorted(only))]
        out = subprocess.run([sys.executable, here, "--kernels-a-call", *args], capture_output=True, text=True,
                             timeout=600, cwd=os.path.dirname(here))
        if out.returncode != 0:
            raise AssertionError(f"kernels a call: the child exited {out.returncode}: {out.stderr[-4000:]}")
        counts.update(json.loads(out.stdout.strip().splitlines()[-1]))
        only = {k for k, v in counts.items() if v is None}
        if not only:
            break
        log(f"kernels a call: empty traces for {sorted(only)}; counting them again in a new child")
    wrong = {k: v for k, v in counts.items() if v is None or not 1 <= v <= kernels_allowed(k)}
    if wrong:
        raise AssertionError(f"kernels a call by torch.profiler, not as KERNELS_A_CALL allows (None: an empty "
                             f"trace): {wrong}")
    return counts


def select_times(d, k: int, ids=None) -> dict:
    """knn_select on d (R, n) with k (and ids): its time, the plain
    version's, torch.topk's (no ids), its bound (the matrix read once, the
    k ids it maps, the outputs written; one compare an entry) and the
    kernels a call launches."""
    from redisson_tpu_torch.core import kernels as K

    r, n = d.shape
    t = {"ms": time_kernel(lambda i: K.knn_select(d, k, ids)),
         "plain_ms": time_plain(lambda i: K.knn_select_plain(d, k, ids)),
         "topk_ms": time_kernel(lambda i: torch.topk(d, k, dim=1, largest=False))}
    t["bound_ms"], t["bound_by"] = bound_ms(4 * r * n + (4 * r * k if ids is not None else 0) + 8 * r * k, r * n)
    return t


def select_edge_rows(rng, r: int, n: int, dev):
    """r rows of n for knn_select's edges: one value (every tie to the lower
    column), a third +inf, all +inf, -0.0 then +0.0, three values (equal keys
    across every segment boundary), descending (each column a new best),
    -inf, then random rows."""
    d = rng.standard_normal((r, n)).astype(np.float32)
    d[0] = 1.0
    d[1, ::3] = np.inf
    d[2] = np.inf
    d[3, : n // 2] = -0.0
    d[3, n // 2:] = 0.0
    d[4] = rng.integers(0, 3, n)
    d[5] = np.arange(n, 0, -1)
    d[7] = -np.inf
    return torch.from_numpy(d).to(dev)


def check_vector(dev, rng) -> dict:
    """knn_score, knn_select, ivf_score and kmeans against their plain
    versions on the card: every metric, dtype and mask at config 7's 50,000 x
    128 point; the timed shapes (config 7's points, COSINE, Qb 64, k 10, and
    1,000,000 x 128, L2, the shape of ann-benchmarks' sift-128-euclidean);
    the edges (k above the live rows, every row dead, exact duplicates,
    n_rows below capacity, k = 1, k = cap, k past a round of 256); ivf_score
    at config 7's IVF leg (nlist 1,536, nprobe 2, 4, 8, sentinel-padded
    cells from a k-means of the clustered corpus); kmeans at 50,000 x 128 x
    1,536, twice with equal bits.  Times beside the bound, the plain
    versions' and the library calls' (torch.matmul with TF32 off,
    torch.topk); knn_score's chosen route beside its tile route at the
    timed shapes, and both routes, each checked, at more shapes (8 queries
    against the 1M bank, 1 against 65,536 rows, the IVF route, the narrow
    bank's edge, INT8, FLOAT16, W 70)."""
    from redisson_tpu_torch.core import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    score_err, select_err, checked_s, checked_k = 0.0, 0.0, [], []
    # -- every metric, dtype and mask at config 7's 50,000 x 128 point ---------
    n, w = C7_POINTS[1][:2]
    c = c7_cap(n)
    q = torch.from_numpy(rng.standard_normal((C7_QB, w), dtype=np.float32)).to(dev)
    q[0] = 0.0  # a zero query (COSINE 1 everywhere)
    bias = torch.zeros(c, device=dev)
    bias[torch.from_numpy(rng.choice(n, 500, replace=False)).to(dev)] = float("inf")
    qbias = torch.where(torch.rand((C7_QB, c), device=dev) < 0.3, float("inf"), 0.0)
    for dtype in ("FLOAT32", "FLOAT16", "INT8"):
        bank, scale = vec_bank(rng, c, w, dtype, dev)
        rows = K._bank_f32(bank, scale)
        for metric in K.KNN_METRICS:
            s = dist_scale(rows, q, metric)
            for qb in (None, qbias):
                label = f"{metric} {dtype} {'masked' if qb is not None else 'unmasked'}"
                got = K.knn_score(bank, scale, bias, qb, q, n, metric)
                want = K.knn_score_plain(bank, scale, bias, qb, q, n, metric)
                score_err = max(score_err, assert_near(f"knn_score {label}", got, want, s))
                gv, gi = K.knn_select(got, C7_K)
                pv, pi = K.knn_select_plain(got, C7_K)
                select_err = max(select_err, assert_equal(f"knn_select {label}", gv, pv))
                assert_equal(f"knn_select ids {label}", gi, pi)
                wv, wi = K.knn_select_plain(want, C7_K)
                assert_ids_outside_near_ties(f"knn_topk {label}", gi, wi, wv)
        del bank, scale, rows
    checked_s.append(f"{n} of {c} rows x {w}: L2, COSINE, IP x FLOAT32, FLOAT16, INT8 x with and without a "
                     f"per-query bias, Qb {C7_QB}, 500 dead rows, a zero query")
    checked_k.append(f"the same {18} matrices, k {C7_K}: bit for bit; the composed ids equal outside near-ties")
    # -- the edges ---------------------------------------------------------------
    bank, _ = vec_bank(rng, 4096, 64, "FLOAT32", dev)
    qe = torch.from_numpy(rng.standard_normal((8, 64), dtype=np.float32)).to(dev)
    qe[1] = bank[5]
    live = torch.zeros(4096, device=dev)
    dead = torch.full((4096,), float("inf"), device=dev)
    edges = (("k above the live rows", live, 300, 400), ("every row dead", dead, 4096, 10),
             ("k = 1", live, 4096, 1), ("k = cap", live, 4096, 4096), ("n_rows below capacity", live, 1000, 10),
             ("k past a round of 256", live, 4096, 700))
    for label, b, n_rows, k in edges:
        got = K.knn_score(bank, None, b, None, qe, n_rows, "L2")
        want = K.knn_score_plain(bank, None, b, None, qe, n_rows, "L2")
        score_err = max(score_err, assert_near(f"knn_score {label}", got, want, dist_scale(bank, qe, "L2")))
        gv, gi = K.knn_select(got, k)
        pv, pi = K.knn_select_plain(got, k)
        assert_equal(f"knn_select {label}", gv, pv)
        assert_equal(f"knn_select ids {label}", gi, pi)
        finite = int(torch.isfinite(gv).sum(1).max())
        if finite != (0 if b is dead else min(k, n_rows)):
            raise AssertionError(f"knn_select {label}: {finite} finite entries")
    _, gi = K.knn_topk(bank, live, qe, 4096, 2, "L2")
    if gi[1].tolist() != [1, 5]:
        raise AssertionError(f"knn_topk duplicates: {gi[1].tolist()}, want [1, 5] (the lower index first)")
    checked_s.append("4096 x 64 L2 edges")
    checked_k.append("edges: " + ", ".join(e[0] for e in edges) + ", exact duplicates (the lower index first)")
    del bank
    # -- knn_select's own edges: rows just under and over the one-warp limit,
    # one and several segments, unaligned ends (a row length of no multiple
    # of 4, a base past a 16-byte boundary), k = n, k past 256, 19 rows, each
    # matrix twice (every call leaves the rows' tickets and bounds reset)
    sel_edges = ((K.SELECT_SMALL, 10), (K.SELECT_SMALL + 1, 10), (4099, 4099), (40001, 257), (70001, 10))
    for n_e, k_e in sel_edges:
        d = select_edge_rows(rng, 19, n_e, dev)
        flat = torch.empty(d.numel() + 1, device=dev)
        moved = flat[1:].view(d.shape)
        moved.copy_(d)
        for label, mat in (("aligned", d), ("unaligned", moved), ("aligned", d)):
            gv, gi = K.knn_select(mat, k_e)
            pv, pi = K.knn_select_plain(mat, k_e)
            assert_equal(f"knn_select {label} 19 x {n_e}, k {k_e}", gv.view(torch.int32), pv.view(torch.int32))
            assert_equal(f"knn_select ids {label} 19 x {n_e}, k {k_e}", gi, pi)
        del d, flat, moved
    checked_k.append("its own edges, 19 rows each (one value, +inf, -0.0 and +0.0, ties across segments, "
                     "descending, -inf), aligned and one element off, twice: "
                     + ", ".join(f"n {n_e} k {k_e}" for n_e, k_e in sel_edges))
    torch.cuda.empty_cache()

    # -- timed: config 7's points (COSINE) and the 1M x 128 L2 point --------------
    timed = []
    for (n, w, k), metric in ((C7_POINTS[0], "COSINE"), (C7_POINTS[1], "COSINE"), (C7_SIFT, "L2")):
        c = c7_cap(n)
        bank, _ = vec_bank(rng, c, w, "FLOAT32", dev)
        bias = torch.zeros(c, device=dev)
        q = torch.from_numpy(rng.standard_normal((C7_QB, w), dtype=np.float32)).to(dev)
        got = K.knn_score(bank, None, bias, None, q, n, metric)
        want = K.knn_score_plain(bank, None, bias, None, q, n, metric)
        score_err = max(score_err, assert_near(f"knn_score {n} x {w}", got, want, dist_scale(bank, q, metric)))
        gv, gi = K.knn_select(got, k)
        pv, pi = K.knn_select_plain(got, k)
        assert_equal(f"knn_select {n} x {w}", gv, pv)
        assert_equal(f"knn_select ids {n} x {w}", gi, pi)
        wv, wi = K.knn_select_plain(want, k)
        assert_ids_outside_near_ties(f"knn_topk {n} x {w}", gi, wi, wv)
        tile = K.knn_score(bank, None, bias, None, q, n, metric, route=K.KNN_TILE)
        score_err = max(score_err, assert_near(f"knn_score {n} x {w} by the tile route", tile, want,
                                               dist_scale(bank, q, metric)))
        del want, tile
        qbias = torch.zeros((C7_QB, c), device=dev)
        t = {"shape": f"{n} of {c} rows x {w} float32, {metric}, Qb {C7_QB}, k {k}",
             "score_route": K.knn_score_route(bank, q),
             "score_ms": time_kernel(lambda i: K.knn_score(bank, None, bias, None, q, n, metric)),
             "score_tile_ms": time_kernel(lambda i: K.knn_score(bank, None, bias, None, q, n, metric,
                                                                route=K.KNN_TILE)),
             "score_masked_ms": time_kernel(lambda i: K.knn_score(bank, None, bias, qbias, q, n, metric)),
             "score_plain_ms": time_plain(lambda i: K.knn_score_plain(bank, None, bias, None, q, n, metric)),
             "matmul_ms": time_kernel(lambda i: torch.matmul(q, bank.T)),
             "select_ms": time_kernel(lambda i: K.knn_select(got, k)),
             "select_plain_ms": time_plain(lambda i: K.knn_select_plain(got, k)),
             "topk_ms": time_kernel(lambda i: torch.topk(got, k, dim=1, largest=False))}
        t["score_bound_ms"], t["score_bound_by"] = bound_ms(knn_bytes(bank, None, bias, None, C7_QB, c, w),
                                                            2 * C7_QB * c * w + 2 * (C7_QB + c) * w)
        t["select_bound_ms"], t["select_bound_by"] = bound_ms(4 * C7_QB * c + 8 * C7_QB * k, C7_QB * c)
        timed.append(t)
        log(f"knn at {t['shape']}: knn_score {t['score_ms']:.4f} ms by route {t['score_route']} (the tile route "
            f"{t['score_tile_ms']:.4f}; with a per-query bias "
            f"{t['score_masked_ms']:.4f}; plain {t['score_plain_ms']:.3f}; torch.matmul {t['matmul_ms']:.4f}; "
            f"bound {t['score_bound_ms']:.4f} by {t['score_bound_by']}), knn_select {t['select_ms']:.4f} ms "
            f"(plain {t['select_plain_ms']:.3f}; torch.topk {t['topk_ms']:.4f}; bound {t['select_bound_ms']:.4f})")
        del bank, bias, q, got, qbias
        torch.cuda.empty_cache()
    checked_s.append("config 7's points (COSINE) and 1,000,000 x 128 L2, Qb 64")
    checked_k.append("the same three matrices, k 10")
    # -- knn_score's routes at more shapes: R <= 8 (8 queries against the 1M
    # bank, 1 against 65,536 rows), the IVF route (64 queries against config
    # 7's 1,536 centroids), the narrow bank's edge, INT8 and FLOAT16 banks and
    # a width whose rows take element loads; both designs checked, then timed
    routes = {}
    n50, w128 = C7_POINTS[1][:2]
    for label, r, n, c, w, dtype, metric in (
            ("r8", 8, C7_SIFT[0], c7_cap(C7_SIFT[0]), w128, "FLOAT32", "L2"),
            ("r1", 1, c7_cap(n50), c7_cap(n50), w128, "FLOAT32", "L2"),
            ("ivf_route", C7_QB, C7_NLIST, C7_NLIST, w128, "FLOAT32", "COSINE"),
            ("narrow_edge", C7_QB, K.KNN_NARROW_ROWS, K.KNN_NARROW_ROWS, w128, "FLOAT32", "COSINE"),
            ("int8", C7_QB, n50, c7_cap(n50), w128, "INT8", "COSINE"),
            ("float16", C7_QB, n50, c7_cap(n50), w128, "FLOAT16", "COSINE"),
            ("w70", C7_QB, n50, c7_cap(n50), 70, "FLOAT32", "L2")):
        bank, scale = vec_bank(rng, c, w, dtype, dev)
        q = torch.from_numpy(rng.standard_normal((r, w), dtype=np.float32)).to(dev)
        want = K.knn_score_plain(bank, scale, None, None, q, n, metric)
        s = dist_scale(K._bank_f32(bank, scale), q, metric)
        stream = K.knn_score_route(bank, q[:1])  # one query streams: 16-byte copies where the rows allow
        t = {"shape": f"{r} queries x {n} of {c} rows x {w} {dtype}, {metric}", "route": K.knn_score_route(bank, q),
             "stream_route": stream}
        for name, route in (("tile", K.KNN_TILE), ("stream", stream)):
            got = K.knn_score(bank, scale, None, None, q, n, metric, route=route)
            t[f"{name}_err"] = assert_near(f"knn_score {label} by route {route}", got, want, s)
            score_err = max(score_err, t[f"{name}_err"])
        t["ms"] = time_kernel(lambda i: K.knn_score(bank, scale, None, None, q, n, metric))
        t["tile_ms"] = time_kernel(lambda i: K.knn_score(bank, scale, None, None, q, n, metric, route=K.KNN_TILE))
        t["stream_ms"] = time_kernel(lambda i: K.knn_score(bank, scale, None, None, q, n, metric, route=stream))
        t["plain_ms"] = time_plain(lambda i: K.knn_score_plain(bank, scale, None, None, q, n, metric))
        rows = K._bank_f32(bank, scale)
        t["matmul_ms"] = time_kernel(lambda i: torch.matmul(q, rows.T))
        t["bound_ms"], _ = bound_ms(knn_bytes(bank, scale, None, None, r, c, w), 2 * r * c * w + 2 * (r + c) * w)
        routes[label] = t
        log(f"knn_score at {t['shape']}: {t['ms']:.4f} ms by route {t['route']} (the tile route "
            f"{t['tile_ms']:.4f}, the streamed route {stream} {t['stream_ms']:.4f}; plain {t['plain_ms']:.3f}; "
            f"torch.matmul of the float32 rows {t['matmul_ms']:.4f}; bound {t['bound_ms']:.4f}); both routes "
            f"within {DIST_TOL} of scale (errors {t['tile_err']:.3g}, {t['stream_err']:.3g})")
        del bank, scale, q, got, want, rows
        torch.cuda.empty_cache()
    checked_s.append("both routes at 8 queries x the 1M bank and 1 x 65,536 rows (L2), 64 x 1,536 centroids and "
                     "64 x 16,384 rows (COSINE), INT8 and FLOAT16 banks at 50,000 x 128, W 70 at 50,000 rows")

    # -- ivf_score at config 7's IVF leg; kmeans at 50,000 x 128 x 1,536 ------------
    n, w, nlist = C7_POINTS[1][0], C7_POINTS[1][1], C7_NLIST
    vecs = c7_clustered(np.random.default_rng(C7_SEED), n, w)
    pts = torch.from_numpy(vecs).to(dev)
    weights = torch.ones(n, device=dev)
    weights[torch.from_numpy(rng.choice(n, 200, replace=False)).to(dev)] = 0.0
    pts[weights == 0] = 0.0
    init = np.sort(np.random.default_rng(0x1DF5EED ^ n).choice(np.nonzero(weights.cpu().numpy())[0], nlist,
                                                                 replace=False))
    cent = pts[torch.from_numpy(init).to(dev)].clone()
    c1, a1 = K.kmeans_step(pts, weights, cent)
    c2, a2 = K.kmeans_step(pts, weights, cent)
    torch.cuda.synchronize()
    if not (torch.equal(c1.view(torch.int32), c2.view(torch.int32)) and torch.equal(a1, a2)):
        raise AssertionError("kmeans: two runs on the card gave different bits")
    # the update against its float32 row-order reference on the host, bit
    # for bit (so against the parent's seven-step design, which kept it)
    want_c = kmeans_update_reference(pts.cpu().numpy(), weights.cpu().numpy(), cent.cpu().numpy(),
                                     a1.cpu().numpy())
    if not np.array_equal(c1.cpu().numpy().view(np.int32), want_c.view(np.int32)):
        raise AssertionError("kmeans_update differs from the float32 row-order reference")
    pc, pa = K.kmeans_step_plain(pts, weights, cent)
    d = ((pts * pts).sum(1)[:, None] - 2 * (pts @ cent.T) + (cent * cent).sum(1)[None, :]).double()
    two = torch.topk(d, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > TIE_GAP * two[:, 0].abs().clamp(min=1.0)
    # each assign route at a width that takes it (the main path's W 128 the
    # tensor-core route, W 384 the tile route): the points that differ from
    # the plain version's inside the gap (allowed) and outside it (none)
    route_names = {K.KMEANS_MMA: "tensor-core (3xTF32)", K.KMEANS_TILE: "tile (float32)"}
    assign_route = K.kmeans_assign_route(pts, cent)
    wide = torch.from_numpy(c7_clustered(np.random.default_rng(C7_SEED + 2), KMEANS_WIDE[0], KMEANS_WIDE[1])).to(dev)
    route_diff = {}
    for r, (p_r, w_r, c_r, a_r) in ((assign_route, (pts, weights, cent, a1)),
                                    (K.kmeans_assign_route(wide, wide[:nlist]),
                                     (wide, torch.ones(len(wide), device=dev), wide[: KMEANS_WIDE[2]].clone(), None))):
        ga, gb = K.kmeans_assign(p_r, w_r, c_r), K.kmeans_assign(p_r, w_r, c_r)
        pa_r = K.kmeans_assign_plain(p_r, w_r, c_r)
        d_r = ((p_r * p_r).sum(1)[:, None] - 2 * (p_r @ c_r.T) + (c_r * c_r).sum(1)[None, :]).double()
        two_r = torch.topk(d_r, 2, dim=1, largest=False).values
        clear_r = (two_r[:, 1] - two_r[:, 0]) > TIE_GAP * two_r[:, 0].abs().clamp(min=1.0)
        torch.cuda.synchronize()
        if not torch.equal(ga, gb) or (a_r is not None and not torch.equal(ga, a_r)):
            raise AssertionError(f"kmeans_assign by the {route_names[r]} route: two runs gave different bits")
        route_diff[r] = (int((ga[~clear_r] != pa_r[~clear_r]).sum()), int((ga[clear_r] != pa_r[clear_r]).sum()),
                         int((~clear_r).sum()), f"{p_r.shape[0]} x {p_r.shape[1]} x {c_r.shape[0]}")
        log(f"kmeans_assign by the {route_names[r]} route at {route_diff[r][3]}: {route_diff[r][0]} of "
            f"{route_diff[r][2]} near-tied points and {route_diff[r][1]} of {int(clear_r.sum())} points outside "
            f"the gap ({TIE_GAP} relative) differ from the plain version")
        if route_diff[r][1] or not torch.equal(ga == -1, w_r == 0):
            raise AssertionError(f"kmeans_assign by the {route_names[r]} route: {route_diff[r][1]} assignments "
                                 "differ from the plain version's outside near-ties")
        del d_r
    del wide
    if sorted(route_diff) != sorted(route_names):
        raise AssertionError(f"kmeans_assign: routes checked {sorted(route_diff)}, not both")
    if not torch.equal(a1[clear], pa[clear]) or not torch.equal(a1 == -1, weights == 0):
        raise AssertionError("kmeans: assignments differ from the plain version's outside near-ties")
    moved = torch.zeros(nlist, dtype=torch.bool, device=dev)
    diff_rows = (a1 != pa).nonzero().reshape(-1)
    moved[a1[diff_rows].long().clamp(min=0)] = True
    moved[pa[diff_rows].long().clamp(min=0)] = True
    kerr = float((c1[~moved] - pc[~moved]).abs().max()) / float(pc.abs().max())
    if kerr > DIST_TOL:
        raise AssertionError(f"kmeans: centroids {kerr} (relative) from the plain version's")
    for _ in range(KMEANS_ITERS - 1):
        c1, a1 = K.kmeans_step(pts, weights, c1)
    cells, ccap = c7_cells(a1.cpu().numpy(), nlist)
    cells_t = torch.from_numpy(cells).to(dev)
    q = torch.from_numpy(c7_queries(np.random.default_rng(C7_SEED + 1), vecs, C7_QB)).to(dev)
    bias = torch.zeros(n, device=dev)
    bias[weights == 0] = float("inf")
    qmask = torch.where(torch.rand(n, device=dev) < 0.3, float("inf"), 0.0)
    ivf_err, ivf_times = 0.0, []
    # the least time this timing gives one launch: a one-element fill
    ivf_sel = {"launch_floor_ms": time_kernel(lambda i: torch.zeros(1, device=dev))}
    log(f"launch floor (torch.zeros(1) timed as the kernels are): {ivf_sel['launch_floor_ms']:.4f} ms")
    for nprobe in C7_NPROBES:
        route = K.knn_score(c1, None, None, None, q, nlist, "COSINE")
        rv, probe = K.knn_select(route, nprobe)
        pv, pp = K.knn_select_plain(route, nprobe)
        assert_equal(f"knn_select of the IVF route nprobe {nprobe}", rv.view(torch.int32), pv.view(torch.int32))
        assert_equal(f"knn_select ids of the IVF route nprobe {nprobe}", probe, pp)
        for qm in (qmask, None):
            gd, gids = K.ivf_score(pts, None, bias, qm, cells_t, probe, q, n, "COSINE")
            wd, wids = K.ivf_score_plain(pts, None, bias, qm, cells_t, probe, q, n, "COSINE")
            assert_equal(f"ivf_score ids nprobe {nprobe}", gids, wids)
            ivf_err = max(ivf_err, assert_near(f"ivf_score nprobe {nprobe}", gd, wd, 1.0))
            gv, gi = K.knn_select(gd, C7_K, gids)
            pv, pi = K.knn_select_plain(gd, C7_K, gids)
            assert_equal(f"knn_select over the candidates nprobe {nprobe}", gv.view(torch.int32),
                         pv.view(torch.int32))
            assert_equal(f"knn_select ids over the candidates nprobe {nprobe}", gi, pi)
        # the main path's selects of this batch: the route's (k = nprobe) and
        # the unmasked candidates' (k 10, through their row ids)
        for part, (mat, k_s, ids_s) in (("route", (route, nprobe, None)), ("cand", (gd, C7_K, gids))):
            t = select_times(mat, k_s, ids_s)
            ivf_sel.update({f"ivf_{part}_np{nprobe}_{key}": v for key, v in t.items()})
            log(f"knn_select at the IVF {part} shape, nprobe {nprobe}: {tuple(mat.shape)}, k {k_s}: {t['ms']:.4f} ms "
                f"(plain {t['plain_ms']:.3f}; torch.topk "
                f"{t['topk_ms']:.4f}; bound {t['bound_ms']:.4f} by {t['bound_by']})")
        valid = int(((gids >= 0) & (gids < n)).sum())
        t = {"nprobe": nprobe, "ms": time_kernel(lambda i: K.ivf_score(pts, None, bias, None, cells_t, probe, q, n,
                                                                       "COSINE")),
             "plain_ms": time_plain(lambda i: K.ivf_score_plain(pts, None, bias, None, cells_t, probe, q, n,
                                                                "COSINE")),
             "valid_slots": valid, "slots": gids.numel()}
        t["bound_ms"], t["bound_by"] = bound_ms(4 * w * valid + 4 * gids.numel() + 4 * C7_QB * w + 8 * gids.numel(),
                                                4 * w * valid)
        ivf_times.append(t)
    a0 = K.kmeans_assign(pts, weights, cent)
    assigned = a0 >= 0
    weighted, cell, acc = (pts * weights[:, None])[assigned], a0[assigned].long(), torch.zeros_like(cent)
    km = {"ms": time_kernel(lambda i: K.kmeans_step(pts, weights, cent)),
          "assign_ms": time_kernel(lambda i: K.kmeans_assign(pts, weights, cent)),
          "update_ms": time_kernel(lambda i: K.kmeans_update(pts, weights, cent, a0)),
          "update_plain_ms": time_plain(lambda i: K.kmeans_update_plain(pts, weights, cent, a0)),
          # the update's library yardstick: index_add_ of the weighted rows,
          # the sums alone (no counts, no division, no order kept)
          "update_library_ms": time_kernel(lambda i: acc.index_add_(0, cell, weighted)),
          # the update's bound: points, weights and assignment read once, the
          # centroids read and written once
          "update_bound_ms": bound_ms(4 * n * w + 8 * n + 8 * nlist * w, 0)[0],
          "plain_ms": time_plain(lambda i: K.kmeans_step_plain(pts, weights, cent)),
          # the product alone (TF32 off): no one PyTorch call computes the argmin of the distances
          "matmul_ms": time_kernel(lambda i: torch.matmul(pts, cent.T)),
          "library_ms": None,
          "assign_route": route_names[assign_route],
          "assign_near_tie_diffs": route_diff[assign_route][0]}
    # the bound of the route that ran: the tile route's float32 FMAs (the
    # product and the norms) at 67 TFLOP/s, the tensor-core route's three
    # TF32 products at 495 TFLOP/s; the bytes (points and weights read, the
    # centroids read for their norms and the product, the assignment
    # written) bound neither
    nbytes = 4 * n * w + 8 * nlist * w + 8 * n
    km["bound_fp32_ms"], fp32_by = bound_ms(nbytes, 2 * n * nlist * w + 2 * n * w)
    t_bytes, t_tf32 = nbytes / HBM_BYTES_PER_S * 1e3, 3 * 2 * n * nlist * w / TF32_OPS_PER_S * 1e3
    km["bound_3xtf32_ms"] = max(t_bytes, t_tf32)
    if assign_route == K.KMEANS_MMA:
        km["bound_ms"], km["bound_by"] = km["bound_3xtf32_ms"], "bytes" if t_bytes >= t_tf32 else "operations"
    else:
        km["bound_ms"], km["bound_by"] = km["bound_fp32_ms"], fp32_by
    log(f"kmeans_assign at {n} x {w} x {nlist}: route {km['assign_route']}, {km['assign_ms']:.4f} ms; bound "
        f"{km['bound_ms']:.4f} ms, the route's (float32 FMAs {km['bound_fp32_ms']:.4f} ms, three TF32 products "
        f"{km['bound_3xtf32_ms']:.4f} ms); torch.matmul, the product alone (TF32 off), {km['matmul_ms']:.4f} ms; "
        f"kmeans_update {km['update_ms']:.4f} ms (bound {km['update_bound_ms']:.4f} ms by bytes; index_add_ of the "
        f"weighted rows, the sums alone, {km['update_library_ms']:.4f} ms)")
    km.update(max_abs_err=kerr, checked=[f"{n} x {w} points (200 dead), {nlist} centroids from the training's "
                                         "seeded init: two runs equal bit for bit; assignments equal to the plain "
                                         f"version's outside near-ties ({int((~clear).sum())} near-tied points); "
                                         "centroids within "
                                         f"{DIST_TOL} relative where no assignment differs; the update bit for bit "
                                         "against the float32 row-order reference; each assign route, "
                                         "twice equal and equal to the plain version outside near-ties: "
                                         + ", ".join(f"the {route_names[r]} route at {d[3]}"
                                                     for r, d in route_diff.items())],
              shape=f"one Lloyd iteration, {n} x {w} points, {nlist} centroids",
              launches_per_call="2 wrapper launches a Lloyd step: kmeans_assign (one kernel: 3xTF32 on the "
                                "tensor cores up to W 256, float32 tiles wider), kmeans_update (two kernels: the "
                                "rows bucketed by cell a tile at a time, then one block a cell adds its bucket)")
    t4 = next(t for t in ivf_times if t["nprobe"] == 4)
    ivf = {"ms": t4["ms"], "plain_ms": t4["plain_ms"], "library_ms": None, "bound_ms": t4["bound_ms"],
           "bound_by": t4["bound_by"], "max_abs_err": ivf_err,
           "by_nprobe": {t["nprobe"]: {k: v for k, v in t.items() if k != "nprobe"} for t in ivf_times},
           "checked": [f"config 7's IVF leg: {n} x {w} COSINE, nlist {nlist}, cell cap {ccap} (sentinel-padded), "
                       f"Qb {C7_QB}, nprobe {', '.join(map(str, C7_NPROBES))}, with and without a (C,) mask: ids "
                       f"bit for bit, distances within {DIST_TOL}; knn_select over them bit for bit"],
           "shape": f"config 7's IVF leg, nprobe 4: {t4['valid_slots']} valid of {t4['slots']} slots",
           **{f"np{t['nprobe']}_{key}": v for t in ivf_times for key in ("ms", "plain_ms", "bound_ms")
              for v in [t[key]]}, "launch_floor_ms": ivf_sel["launch_floor_ms"],
           "launches_per_call": "1 launch a call: one block a (query, probe) pair compacts the cell's valid "
                                "slots by ballot and gathers only those, 16 bytes a load where the rows allow"}
    del pts, weights, cent, c1, c2, pc, d, cells_t, q, a0, assigned, weighted, cell, acc
    torch.cuda.empty_cache()

    big = timed[-1]
    c7 = timed[1]
    score = {"ms": big["score_ms"], "plain_ms": big["score_plain_ms"], "library_ms": big["matmul_ms"],
             "bound_ms": big["score_bound_ms"], "bound_by": big["score_bound_by"], "max_abs_err": score_err,
             "c7_ms": c7["score_ms"], "c7_bound_ms": c7["score_bound_ms"], "c7_plain_ms": c7["score_plain_ms"],
             "c7_library_ms": c7["matmul_ms"], "c7_20k_ms": timed[0]["score_ms"],
             "c7_20k_library_ms": timed[0]["matmul_ms"], "masked_ms": big["score_masked_ms"],
             "tile_ms": big["score_tile_ms"], "c7_tile_ms": c7["score_tile_ms"],
             "c7_20k_tile_ms": timed[0]["score_tile_ms"],
             **{f"{label}_{key}": v for label, r in routes.items() for key, v in r.items() if key.endswith("ms")},
             "checked": checked_s, "shape": big["shape"],
             "launches_per_call": "1 launch a call"}
    select = {"ms": big["select_ms"], "plain_ms": big["select_plain_ms"], "library_ms": big["topk_ms"],
              "bound_ms": big["select_bound_ms"], "bound_by": big["select_bound_by"], "max_abs_err": select_err,
              "c7_ms": c7["select_ms"], "c7_bound_ms": c7["select_bound_ms"], "c7_plain_ms": c7["select_plain_ms"],
              "c7_library_ms": c7["topk_ms"], "c7_20k_ms": timed[0]["select_ms"],
              **ivf_sel,
              "checked": checked_k + [f"the IVF route (k = nprobe) and candidates (k {C7_K}, with ids) at nprobe "
                                      f"{', '.join(map(str, C7_NPROBES))}"],
              "shape": big["shape"],
              "launches_per_call": "1 launch a call for k <= 256 (one a round of 256 past that): one warp a row "
                                   f"for rows of at most {K.SELECT_SMALL} columns, else a few segments a row whose "
                                   "lists the row's last block merges"}
    for name, r in (("knn_score", score), ("knn_select", select), ("ivf_score", ivf), ("kmeans", km)):
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"kernel {name} ({r['launches_per_call']}): {r['ms']:.4f} ms at {r['shape']} (plain {r['plain_ms']:.3f} "
            f"ms, library {lib}, bound {r['bound_ms']:.4f} ms by {r['bound_by']})"
            + (f"; assign {r['assign_ms']:.4f} ms, update {r['update_ms']:.4f} ms" if "assign_ms" in r else "")
            + f"; checked {r['checked']}")
    return {"knn_score": score, "knn_select": select, "ivf_score": ivf, "kmeans": km}


# --------------------------------------------------------------------------
# phase 4: the main path through the facade
# --------------------------------------------------------------------------

@contextlib.contextmanager
def staging(engine, on: bool):
    """The engine's pinned staging pool as it is (on), or none (off): every
    flush then packs into a fresh pageable buffer and copies synchronously."""
    pool = engine.staging
    if not on:
        engine.staging = None
    try:
        yield
    finally:
        engine.staging = pool


def pctl(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def fp_band(fp: float, what: str) -> None:
    # at design load the filters' expected false-positive rate is 0.01; the
    # band allows the sampling spread of >= 500k absent probes with margin
    if not 0.005 <= fp <= 0.02:
        raise AssertionError(f"{what}: false-positive rate {fp:.4f} outside [0.005, 0.02]")


def config2_flush(rng):
    """A 100k-op contains flush: even ops present keys, odd ops absent ones."""
    present = rng.integers(0, C2_TENANTS * C2_PER_TENANT, C2_FLUSH).astype(np.int64) * 2654435761
    absent = rng.integers(1 << 50, 1 << 60, C2_FLUSH).astype(np.int64)
    ks = np.where(np.arange(C2_FLUSH) % 2 == 0, present, absent)
    return ((ks * 40503) % C2_TENANTS).astype(np.int32), ks


def run_config2(client, rng) -> dict:
    """Config 2's populate and flushes; the bank stays for config2_batch."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K

    arr = client.get_bloom_filter_array("c2:tenants")
    if not arr.try_init(C2_TENANTS, C2_PER_TENANT, FPP):
        raise AssertionError("config2: bank exists")

    t0 = time.perf_counter()
    ingest = config2_ingest()
    newly, bb, lengths = arr.add_flushes_async(ingest)
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t0
    full = K.unpack_found(newly, len(lengths) * bb)
    n_new = sum(int(full[i * bb : i * bb + n].sum()) for i, n in enumerate(lengths))

    flushes = [config2_flush(rng) for _ in range(30)]
    arr.contains(*flushes[0])  # first call outside the timing
    lat, fps = [], []
    for t, ks in flushes:
        s = time.perf_counter()
        found = arr.contains(t, ks)
        lat.append(time.perf_counter() - s)
        if not found[0::2].all():
            raise AssertionError("config2: false negatives")
        fps.append(found[1::2].mean())
    fp = float(np.mean(fps))
    fp_band(fp, "config2")
    # the query cache on these flushes: what each one pays for its digest,
    # the pack and host-to-device copy that a hit skips, and a flush that hits
    # (pack and copy through the engine's pinned staging pool, as the path
    # packs, and with the pool off, as the engine packs without it: in turns)
    digest_s, pack_s, unpooled_s, hit_lat = [], [], [], []
    for i, (t, ks) in enumerate(flushes):
        s = time.perf_counter()
        K.QueryCache.digest(t, ks, extra=b"bfa")
        digest_s.append(time.perf_counter() - s)
        for pooled in ((True, False) if i % 2 == 0 else (False, True)):
            prev = ioplane.set_overlap(pooled)  # the engine stages through its pool only with overlap on
            torch.cuda.synchronize()
            s = time.perf_counter()
            arr._pack(t, ks)
            torch.cuda.synchronize()
            (pack_s if pooled else unpooled_s).append(time.perf_counter() - s)
            ioplane.set_overlap(prev)
    for _ in flushes:
        s = time.perf_counter()
        arr.contains(*flushes[0])
        hit_lat.append(time.perf_counter() - s)
    window = [flushes[i % 4] for i in range(50)]
    torch.cuda.synchronize()
    s = time.perf_counter()
    res = arr.contains_flushes(window)
    window_s = time.perf_counter() - s
    for (t, ks), found in zip(window, res):
        if not found[0::2].all():
            raise AssertionError("config2: false negatives in the window")
    # the bank against the same populate run through the plain versions
    tlh, _, _ = arr._pack_flush_window(ingest)
    plain = torch.zeros_like(client.engine.store.get("c2:tenants").arrays["bits"])
    K.bloom_set_plain(plain, plain.shape[1], K._tlh_keys(tlh), tlh.shape[1], arr.get_hash_iterations(), arr.get_size())
    assert_equal("config2 bank after populate", client.engine.store.get("c2:tenants").arrays["bits"], plain)
    del plain, tlh
    out = {"populate_keys": C2_TENANTS * C2_PER_TENANT, "populate_s": populate_s,
           "populate_newly": n_new, "flushes": len(flushes), "flush_ops": C2_FLUSH,
           "flush_p50_ms": pctl(lat, 50) * 1e3, "flush_p99_ms": pctl(lat, 99) * 1e3,
           "false_positive_rate": fp, "cache_digest_p50_ms": pctl(digest_s, 50) * 1e3,
           "pack_copy_p50_ms": pctl(pack_s, 50) * 1e3, "pack_copy_unpooled_p50_ms": pctl(unpooled_s, 50) * 1e3,
           "flush_hit_p50_ms": pctl(hit_lat, 50) * 1e3,
           "window_flushes": 50,
           "window_ops_per_s": 50 * C2_FLUSH / window_s}
    log(f"config2: populate {C2_TENANTS * C2_PER_TENANT} keys {populate_s:.3f}s ({n_new} newly), sync 100k flush "
        f"p50 {out['flush_p50_ms']:.3f} ms p99 {out['flush_p99_ms']:.3f} ms (repeated flush, a cache hit: "
        f"p50 {out['flush_hit_p50_ms']:.3f} ms; digest {out['cache_digest_p50_ms']:.3f} ms, pack and copy "
        f"{out['pack_copy_p50_ms']:.3f} ms through the pinned staging pool, {out['pack_copy_unpooled_p50_ms']:.3f} ms "
        f"without it), fp {fp:.5f}, "
        f"window of 50 flushes {out['window_ops_per_s'] / 1e6:.1f}M contains/s; bank equals plain")
    return out


def run_config2_batch(client, rng) -> dict:
    """Config 2's flush as BASELINE states it, an RBatch of 100k contains:
    1,000 BloomFilterArray.contains_async ops of 100 keys each, one
    execute() and every future's get(), on the bank run_config2 populated.
    Beside it the direct arr.contains on the same flushes, the flush's
    parts (the query cache's digest, pack and copy, the kernel, the
    readback) and one flush of 100,000 one-key ops.  Deletes the bank."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K

    name = "c2:tenants"
    arr = client.get_bloom_filter_array(name)
    per_op = C2_FLUSH // C2_BATCH_OPS

    def batched(t, ks, per=per_op):
        b = client.create_batch()
        bank = b.get_bloom_filter_array(name)
        futs = [bank.contains_async(t[i:i + per], ks[i:i + per]) for i in range(0, len(ks), per)]
        b.execute()
        return [f.get() for f in futs]

    flushes = [config2_flush(rng) for _ in range(30)]
    # the direct call first, its replies kept for the comparison (30 arrays:
    # keeping the batch's 30,000 reply slices instead would grow the heap
    # that each garbage collection walks); then the query cache is emptied,
    # so the batch flushes miss it as the direct ones did
    direct, direct_lat, fps = [], [], []
    for t, ks in flushes:
        s = time.perf_counter()
        found = arr.contains(t, ks)
        direct_lat.append(time.perf_counter() - s)
        if not found[0::2].all():
            raise AssertionError("config2_batch: false negatives")
        fps.append(found[1::2].mean())
        direct.append(found)
    fp = float(np.mean(fps))
    fp_band(fp, "config2_batch")
    client.engine.query_cache.clear()
    # the path's launch counts: from 0 just before its first RBatch flush to
    # just after its last; the direct calls above and the parts, the kernel's
    # timing and the staging A/B below launch outside this window
    K.reset_launches()
    batched(*config2_flush(rng))  # first call outside the timing
    # full (generation 2) garbage collections inside each timed flush: a
    # flush allocates ~4,000 tracked objects, and a full collection walks
    # every tracked object of the process
    full = [0]

    def on_gc(phase, info):
        if phase == "start" and info["generation"] == 2:
            full[0] += 1

    lat, probes, collections = [], [], []
    gc.callbacks.append(on_gc)
    try:
        for (t, ks), found in zip(flushes, direct):
            before, full[0] = K.launches["bloom_probe"], 0
            s = time.perf_counter()
            got = batched(t, ks)
            lat.append(time.perf_counter() - s)
            probes.append(K.launches["bloom_probe"] - before)
            collections.append(full[0])
            if len(got) != C2_BATCH_OPS or not all(
                    np.array_equal(g, found[i * per_op:(i + 1) * per_op]) for i, g in enumerate(got)):
                raise AssertionError("config2_batch: an op's reply differs from the direct reply's slice")
    finally:
        gc.callbacks.remove(on_gc)
    if probes != [1] * len(flushes):
        raise AssertionError(f"config2_batch: bloom_probe launches per flush {probes}, want one each")
    # BASELINE's literal shape: 100,000 one-key ops in one batch, timed once
    s = time.perf_counter()
    one_key = batched(*flushes[0], per=1)
    one_key_s = time.perf_counter() - s
    launches = dict(K.launches)
    if not np.array_equal(np.concatenate(one_key), direct[0]):
        raise AssertionError("config2_batch: one-key ops differ from the direct reply")
    # one bloom_probe for each RBatch flush (the warm-up, the 30 timed, the
    # one-key flush) and nothing else
    want = {k: len(flushes) + 2 if k == "bloom_probe" else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"config2_batch: launches {launches}, want {want}")
    # the flush's parts, on the same flushes
    rec = client.engine.store.get(name)
    bits, k, m = rec.arrays["bits"], rec.meta["k"], rec.meta["m"]
    b = K.bucket_size(C2_FLUSH)
    digest_s, pack_s, read_s = [], [], []
    for t, ks in flushes:
        s = time.perf_counter()
        K.QueryCache.digest(t, ks, extra=b"bfa%d" % b)
        digest_s.append(time.perf_counter() - s)
        torch.cuda.synchronize()
        s = time.perf_counter()
        tlh, n = arr._pack(t, ks)
        torch.cuda.synchronize()
        pack_s.append(time.perf_counter() - s)
        packed = K.bloom_bank_contains_packed_bits(bits, tlh, n, k, m)
        torch.cuda.synchronize()
        s = time.perf_counter()
        ioplane.force_all([ioplane.ReadbackFuture((packed,))])
        read_s.append(time.perf_counter() - s)
    kernel_ms = time_kernel(lambda i: K.bloom_bank_contains_packed_bits(bits, tlh, n, k, m))
    # the RBatch flush with the engine's pinned staging pool and without it,
    # in turns on fresh flushes, each a query-cache miss
    pooled = {True: [], False: []}
    for i in range(C2_POOL_AB):
        t, ks = config2_flush(rng)
        replies = []
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            client.engine.query_cache.clear()
            with staging(client.engine, on):
                s = time.perf_counter()
                replies.append(batched(t, ks))
                pooled[on].append(time.perf_counter() - s)
        if not all(np.array_equal(x, y) for x, y in zip(*replies)):
            raise AssertionError("config2_batch: replies differ with and without the staging pool")
    out = {"flushes": len(flushes), "ops_per_flush": C2_BATCH_OPS, "keys_per_op": per_op,
           "batch_flush_p50_ms": pctl(lat, 50) * 1e3, "batch_flush_p99_ms": pctl(lat, 99) * 1e3,
           "batch_flush_ms": [x * 1e3 for x in lat], "batch_flush_full_collections": collections,
           "direct_flush_p50_ms": pctl(direct_lat, 50) * 1e3, "direct_flush_p99_ms": pctl(direct_lat, 99) * 1e3,
           "false_positive_rate": fp, "digest_p50_ms": pctl(digest_s, 50) * 1e3,
           "pack_copy_p50_ms": pctl(pack_s, 50) * 1e3, "kernel_ms": kernel_ms,
           "readback_p50_ms": pctl(read_s, 50) * 1e3, "one_key_ops": C2_FLUSH, "one_key_flush_s": one_key_s,
           "one_key_us_per_op": one_key_s / C2_FLUSH * 1e6,
           "pool_ab_flushes": C2_POOL_AB, "pool_on_p50_ms": pctl(pooled[True], 50) * 1e3,
           "pool_off_p50_ms": pctl(pooled[False], 50) * 1e3,
           "pool_on_ms": [x * 1e3 for x in pooled[True]], "pool_off_ms": [x * 1e3 for x in pooled[False]],
           "launches": launches}
    out["digest_share_of_batch_flush"] = out["digest_p50_ms"] / out["batch_flush_p50_ms"]
    log(f"config2_batch: RBatch of {C2_BATCH_OPS} x {per_op}-key contains_async, p50 "
        f"{out['batch_flush_p50_ms']:.3f} ms p99 {out['batch_flush_p99_ms']:.3f} ms (direct arr.contains p50 "
        f"{out['direct_flush_p50_ms']:.3f} ms p99 {out['direct_flush_p99_ms']:.3f} ms; the slowest RBatch flush "
        f"{max(lat) * 1e3:.3f} ms, full garbage collections inside the flushes {collections}); parts: digest "
        f"{out['digest_p50_ms']:.3f} ms ({out['digest_share_of_batch_flush']:.0%} of the batch flush), pack and copy "
        f"{out['pack_copy_p50_ms']:.3f} ms, kernel {kernel_ms:.4f} ms, readback {out['readback_p50_ms']:.3f} ms; "
        f"one bloom_probe per flush, {launches['bloom_probe']} in the path; fp {fp:.5f}; {C2_FLUSH} one-key ops in "
        f"one batch {one_key_s:.3f} s ({out['one_key_us_per_op']:.2f} us an op); every reply equals the direct "
        f"reply's slice; staging pool on/off over {C2_POOL_AB} fresh flushes in turns: p50 "
        f"{out['pool_on_p50_ms']:.3f} / {out['pool_off_p50_ms']:.3f} ms")
    arr.delete()
    return out


def run_single_adds(client, rng) -> dict:
    """Single-key adds, as Redisson's RBloomFilter.add(key) makes them, into a
    filter of config 1's size: each takes the probe-then-set pair
    (kernels.use_fused_add), and every added key is then found."""
    bf = client.get_bloom_filter("single:adds")
    if not bf.try_init(C1_N, FPP):
        raise AssertionError("single adds: filter exists")
    # Python ints go through the codec, as Redisson's keys do: byte keys
    keys = [int(x) for x in rng.integers(1 << 61, 1 << 62, SINGLE_ADDS)]
    bf.add(keys[0])  # first call outside the timing
    lat, added = [], 0
    for key in keys[1:]:
        s = time.perf_counter()
        added += bf.add(key)
        lat.append(time.perf_counter() - s)
    if not bf.contains_each(keys).all():
        raise AssertionError("single adds: an added key is not found")
    out = {"adds": len(lat), "newly": added, "add_p50_ms": pctl(lat, 50) * 1e3, "add_p99_ms": pctl(lat, 99) * 1e3}
    log(f"single adds: {len(lat)} RBloomFilter.add(key) into a {C1_N}/{FPP} filter, p50 {out['add_p50_ms']:.3f} ms "
        f"p99 {out['add_p99_ms']:.3f} ms ({added} newly); every key found")
    bf.delete()
    return out


def run_config1(client) -> dict:
    bf = client.get_bloom_filter("c1:single")
    if not bf.try_init(C1_N, FPP):
        raise AssertionError("config1: filter exists")
    keys = np.arange(C1_N, dtype=np.int64)
    torch.cuda.synchronize()
    s = time.perf_counter()
    pending = [bf.add_all_async(keys[i:i + C1_BATCH]) for i in range(0, C1_N, C1_BATCH)]
    added = sum(int(c) for c in pending)
    add_s = time.perf_counter() - s
    q = np.concatenate([keys[: C1_BATCH // 2],
                        np.arange(1 << 40, (1 << 40) + C1_BATCH // 2, dtype=np.int64)])
    bf.contains_each(q)  # first call outside the timing
    s = time.perf_counter()
    found = bf.contains_each(q)
    contains_s = time.perf_counter() - s
    if not found[: C1_BATCH // 2].all():
        raise AssertionError("config1: false negatives")
    fp = float(found[C1_BATCH // 2:].mean())
    fp_band(fp, "config1")
    count = bf.count()
    if abs(count - C1_N) > 0.02 * C1_N:
        raise AssertionError(f"config1: count {count} far from {C1_N}")
    out = {"adds": C1_N, "add_s": add_s, "newly": added, "contains_keys": len(q),
           "contains_s": contains_s, "false_positive_rate": fp, "count": count}
    log(f"config1: add {C1_N} keys in batches of {C1_BATCH} {add_s:.3f}s ({added} newly), contains_each "
        f"of {len(q)} keys {contains_s * 1e3:.3f} ms, fp {fp:.5f}, count {count}")
    bf.delete()
    return out


def run_config3(client, rng) -> dict:
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    bank = client.get_hyper_log_log_array("c3:hll")
    if not bank.try_init(C3_TENANTS):
        raise AssertionError("config3: bank exists")
    batches = [(rng.integers(0, C3_TENANTS, C3_BATCH).astype(np.int32),
                rng.integers(0, 1 << 60, C3_BATCH).astype(np.int64)) for _ in range(C3_BATCHES)]
    torch.cuda.synchronize()
    s = time.perf_counter()
    for t, ks in batches:
        bank.add(t, ks)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - s
    dst = np.arange(0, C3_TENANTS, 2, dtype=np.int32)
    s = time.perf_counter()
    bank.merge_rows(dst, dst + 1)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - s
    s = time.perf_counter()
    ests = bank.estimate_all()
    est_s = time.perf_counter() - s
    # the same stream through the plain versions on the card
    regs = client.engine.store.get("c3:hll").arrays["regs"]
    plain = torch.zeros_like(regs)
    for t, ks in batches:
        lo, hi = H.int_keys_to_u32_pair(ks)
        tlh = K.pack_rows(t, lo, hi, size=K.bucket_size(C3_BATCH), device=plain.device)
        K.hll_add_plain(plain, plain.shape[1], K._tlh_keys(tlh), C3_BATCH, 14)
    src_map = torch.arange(C3_TENANTS, dtype=torch.int32, device=plain.device)
    src_map[torch.from_numpy(dst).long().to(plain.device)] = torch.from_numpy(dst + 1).to(plain.device)
    merged = torch.empty_like(plain)
    K.hll_rows_plain(plain, plain, None, src_map, out=merged)
    assert_equal("config3 registers", regs, merged)
    plain_est = K.hll_rows_plain(merged, estimate=True).cpu().numpy()
    if not np.array_equal(ests, plain_est):
        raise AssertionError("config3: estimates differ from the plain versions")
    expected = C3_BATCH * C3_BATCHES / C3_TENANTS
    out = {"adds": C3_BATCH * C3_BATCHES, "add_s": add_s, "merge_pairs": len(dst),
           "merge_s": merge_s, "estimate_all_s": est_s, "mean_estimate_even": float(ests[0::2].mean()),
           "mean_estimate_odd": float(ests[1::2].mean())}
    if not (0.95 * 2 * expected < out["mean_estimate_even"] < 1.05 * 2 * expected
            and 0.95 * expected < out["mean_estimate_odd"] < 1.05 * expected):
        raise AssertionError(f"config3: estimates off: {out}")
    log(f"config3: {C3_BATCHES} x {C3_BATCH} adds {add_s:.3f}s, merge_rows of {len(dst)} pairs "
        f"{merge_s * 1e3:.3f} ms, "
        f"estimate_all {est_s * 1e3:.3f} ms, mean estimate {out['mean_estimate_odd']:.1f} "
        f"(merged rows {out['mean_estimate_even']:.1f}); registers and estimates equal plain")
    bank.delete()
    return out


def fanout_rep(client, rng, tag: str, keysets, check: bool) -> tuple:
    """One rep of config 5's per-tenant objects (bench.py:399-428) as one
    embedded RBatch, on fresh names: 64 filters (10,000 expected, 0.01)
    each adding its 10,000 keys and then probing them (two fused runs over a
    stacked bank), the same traffic interleaved on 64 more filters (64 fused
    add-then-contains pairs), two bit sets a tenant each setting 500 random
    indexes below 100,000 and then reading 500 others, and a counter and a
    bucket per tenant; then BITOP OR and XOR of each tenant's two bit sets,
    as bench.py:425-426.  Returns (wall seconds, launches by kernel).  With
    `check`, every plane and reply is held against the plain versions, the
    BITOPs against numpy on the CPU."""
    from redisson_tpu_torch.client.objects.bitset import _DEFAULT_BITS
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import bittensor as bt

    dev = client.engine.device
    run = [f"{tag}:run:{t}" for t in range(C5_TENANTS)]
    pair = [f"{tag}:pair:{t}" for t in range(C5_TENANTS)]
    for name in run + pair:
        if not client.get_bloom_filter(name).try_init(C5_PER, FPP):
            raise AssertionError(f"fanout: {name} exists")
    bits = [f"{tag}:bits:{i}" for i in range(2 * C5_TENANTS)]
    set_idx = [rng.integers(0, C5_BITS, C5_BIT_OPS) for _ in bits]
    get_idx = [rng.integers(0, C5_BITS, C5_BIT_OPS) for _ in bits]
    torch.cuda.synchronize()
    before = dict(K.launches)
    s = time.perf_counter()
    b = client.create_batch()
    adds = [b.get_bloom_filter(name).add_async(keysets[t]) for t, name in enumerate(run)]
    probes = [b.get_bloom_filter(name).contains_async(keysets[t]) for t, name in enumerate(run)]
    for t, name in enumerate(pair):
        f = b.get_bloom_filter(name)
        adds.append(f.add_async(keysets[t]))
        probes.append(f.contains_async(keysets[t]))
    sets, gets = [], []
    for name, si, gi in zip(bits, set_idx, get_idx):
        sets.append(b.get_bit_set(name).set_async(si))
        gets.append(b.get_bit_set(name).get_async(gi))
    counters = [b.get_atomic_long(f"{tag}:n:{t}").add_and_get_async(t + 1) for t in range(C5_TENANTS)]
    for t in range(C5_TENANTS):
        b.get_bucket(f"{tag}:v:{t}").set_async(t)
    b.execute()
    added = [f.get() for f in adds]
    found = [f.get() for f in probes]
    old = [f.get() for f in sets]
    got = [f.get() for f in gets]
    counts = [f.get() for f in counters]
    for t in range(C5_TENANTS):
        first = client.get_bit_set(bits[t])
        first.or_(bits[C5_TENANTS + t])
        first.xor(bits[C5_TENANTS + t])
    torch.cuda.synchronize()
    wall = time.perf_counter() - s
    launches = {k: K.launches[k] - before[k] for k in K.launches}
    if not all(f.all() for f in found):
        raise AssertionError("fanout: false negatives")
    if counts != list(range(1, C5_TENANTS + 1)) or \
            [client.get_bucket(f"{tag}:v:{t}").get() for t in range(C5_TENANTS)] != list(range(C5_TENANTS)):
        raise AssertionError("fanout: counters or buckets wrong")
    if check:
        # every plane and newly count against the per-filter plain route
        for t, name in enumerate(run + pair):
            rec = client.engine.store.get(name)
            plane = torch.zeros_like(rec.arrays["bits"])
            _, lh, n = client.engine.pack_keys(keysets[t % C5_TENANTS], None)
            newly = K.bloom_add_plain(plane, plane.numel(), K._u64_keys(lh[0], lh[1]), n,
                                      rec.meta["k"], rec.meta["m"], K.COUNT)
            assert_equal(f"fanout {name}: plane", rec.arrays["bits"], plane)
            if int(newly) != added[t]:
                raise AssertionError(f"fanout {name}: newly {added[t]} != plain {int(newly)}")
        planes = []
        for name, si, gi, o, g in zip(bits, set_idx, get_idx, old, got):
            plane = bt.make(_DEFAULT_BITS, dev)
            _, want_old = K.bitset_set_plain(plane, torch.from_numpy(si.astype(np.int32)).to(dev), C5_BIT_OPS, 1)
            want_got = K.bitset_get_plain(plane, torch.from_numpy(gi.astype(np.int32)).to(dev))
            if not (np.array_equal(o, want_old.cpu().numpy()) and np.array_equal(g, want_got.cpu().numpy())):
                raise AssertionError(f"fanout {name}: replies differ from the plain versions")
            planes.append(plane.cpu().numpy())
        for i, name in enumerate(bits):
            want = planes[i]
            if i < C5_TENANTS:  # BITOP OR, then XOR, with the tenant's second set
                want = (want | planes[C5_TENANTS + i]) ^ planes[C5_TENANTS + i]
            assert_equal(f"fanout {name}: plane", client.engine.store.get(name).arrays["bits"],
                         torch.from_numpy(want).to(dev))
    for name in run + pair + bits:
        client.engine.store.delete(name)
    return wall, launches


def run_fanout(client, rng) -> dict:
    """Config 5's per-tenant objects as one embedded RBatch a rep (fanout_rep),
    C5_REPS reps, each held against the plain versions; the path's launches
    are read after them.  Then reps with the engine's staging pool on and
    off, in turns."""
    from redisson_tpu_torch.core import kernels as K

    keysets = [np.arange(t * C5_PER, (t + 1) * C5_PER, dtype=np.int64) * 2654435761 for t in range(C5_TENANTS)]
    ops = 4 * C5_TENANTS * C5_PER + 2 * (2 * C5_TENANTS) * C5_BIT_OPS + 4 * C5_TENANTS
    reps = []
    for rep in range(C5_REPS):
        wall, launches = fanout_rep(client, rng, f"fan{rep}", keysets, check=True)
        reps.append({"wall_s": wall, "ops_per_s": ops / wall, "launches": launches})
    path_launches = dict(K.launches)
    # the batch layer's levels: the 128 sets in one bitset_set launch, the
    # 128 gets in one bitset_get launch
    bit_launches = [(r["launches"]["bitset_get"], r["launches"]["bitset_set"]) for r in reps]
    if any(b != (1, 1) for b in bit_launches):
        raise AssertionError(f"fanout: (bitset_get, bitset_set) launches a rep {bit_launches}, not (1, 1)")
    pooled = {True: [], False: []}
    for i in range(C5_POOL_AB):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            with staging(client.engine, on):
                wall, _ = fanout_rep(client, rng, f"fanab{i}{on:d}", keysets, check=False)
            pooled[on].append(ops / wall)
    out = {"reps": reps, "ops_per_rep": ops, "ops_per_s": [r["ops_per_s"] for r in reps],
           "pool_on_ops_per_s": pooled[True], "pool_off_ops_per_s": pooled[False], "launches": path_launches,
           "bitset_launches_a_rep": bit_launches}
    log(f"fanout: {C5_REPS} reps of one RBatch with {ops} ops ({4 * C5_TENANTS} filter ops of {C5_PER} keys, two "
        f"fused runs and {C5_TENANTS} fused pairs; {2 * C5_TENANTS} bit sets x {C5_BIT_OPS} set + get; counters and "
        f"buckets; BITOP OR and XOR a tenant): {', '.join(f'{r:.3e}' for r in out['ops_per_s'])} ops/s; launches a "
        f"rep {reps[-1]['launches']} (bitset_get, bitset_set a rep: {bit_launches}); planes, bits and replies "
        f"equal the plain versions; staging pool on / off in "
        f"turns: {', '.join(f'{r:.3e}' for r in pooled[True])} / {', '.join(f'{r:.3e}' for r in pooled[False])} ops/s")
    return out


# K10, the flagship fused step (redisson_tpu_torch/graft_entry.py):
# entry()'s shape (__graft_entry__.py: k 7, m 2**20, p 14, 16 tenants, 4,096
# lanes, n_valid 3,996) once, then GRAFT_STEPS batches of GRAFT_LANES lanes
# (GRAFT_VALID valid) twice: at design fill, each step from one snapshot
# that a prefill of GRAFT_PREFILL keys left (~46,900 keys a tenant, so a
# step ends each tenant near the ~109,400 keys its 2**20 lanes hold at 1%
# false positives at k 7); then all into the same plane, which saturates
GRAFT_STEPS, GRAFT_LANES, GRAFT_VALID, GRAFT_SEED = 100, 1 << 20, 1_000_000, 61
GRAFT_PREFILL = 750_000


def graft_plain_step(bits, regs, keys, n_valid, k, m, p):
    """The fused step by the kernels' plain versions (core/kernels.py)."""
    from redisson_tpu_torch.core import kernels as K

    found = K.bloom_probe_plain(bits, bits.shape[1], keys, n_valid, k, m)
    K.bloom_set_plain(bits, bits.shape[1], keys, n_valid, k, m)
    K.hll_add_plain(regs, regs.shape[1], keys, n_valid, p)
    return found


def graft_step_bytes(bits, regs, keys, n_valid, k, m, p) -> tuple:
    """The bytes one step must move by the sector rule, from the state
    before it (which it leaves untouched): the 32-byte sectors of the plane
    its answers need and that it changes, the sectors of the bank its adds
    read and change, 12 operand bytes an op and a found byte a lane.
    Returns (bytes, found, bits after, regs after) on clones."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.ops import hll as hll_ops

    needed = sectors(needed_probe_positions(bits, keys, bits.shape[1], k, m, n_valid))
    b2, r2 = bits.clone(), regs.clone()
    found = graft_plain_step(b2, r2, keys, n_valid, k, m, p)
    changed = sectors((b2 != bits).reshape(-1).nonzero().reshape(-1))
    idx, _rho = hll_ops.idx_rho(*K._hash(keys), p)
    g = K._flat_index(keys.tenant, idx, regs.shape[1], regs.numel())[:n_valid]
    reg_read = sectors(g[g < regs.numel()])
    reg_changed = sectors((r2 != regs).reshape(-1).nonzero().reshape(-1))
    return 32 * (needed + changed + reg_read + reg_changed) + 12 * n_valid + keys.n, found, b2, r2


def run_graft(dev) -> dict:
    """K10 through graft_entry: entry()'s step on the card against the plain
    path on clones; then GRAFT_STEPS 1M-lane steps at design fill, each from
    one snapshot (ms a step by events around each step), and the same steps
    one after another into one plane, which saturates (steps/s and ops/s on
    the host clock; ms a step on the card from a held replay).  Every step's found, and the plane and bank after the
    last step of each series, against the plain path; ms a step beside its
    bound (the sector rule)."""
    from redisson_tpu_torch import graft_entry as G
    from redisson_tpu_torch.core import kernels as K

    card = card_line()
    k, m, p = G.ENTRY_K, G.ENTRY_M, G.ENTRY_P
    step, args = G.entry(dev)
    bits, regs, tenant, lo, hi, n_valid = args
    if bits.device.type != torch.device(dev).type:
        raise AssertionError(f"graft_entry.entry() did not land on {dev}")
    keys = K.Keys(n=lo.shape[0], tenant=tenant, lo=lo, hi=hi)
    entry_bytes, want_found, want_bits, want_regs = graft_step_bytes(bits, regs, keys, n_valid, k, m, p)
    found, bits, regs = step(*args)
    err = max(assert_equal("graft entry found", found, want_found),
              assert_equal("graft entry plane", bits, want_bits),
              assert_equal("graft entry registers", regs, want_regs))
    ops_a_step = n_valid * (OPS_HASH_U64 + k * OPS_PROBE + OPS_HLL_ADD)
    entry_bms, entry_by = bound_ms(entry_bytes, ops_a_step)
    # the entry shape's step replayed on its own state: ms a step on the card
    entry_ms = time_kernel(lambda i: step(bits, regs, tenant, lo, hi, n_valid))
    pb, pr = bits.clone(), regs.clone()
    entry_plain = time_plain(lambda i: graft_plain_step(pb, pr, keys, n_valid, k, m, p))
    del pb, pr

    # GRAFT_STEPS new batches of 1M lanes (a tenth repeating an earlier
    # lane of their batch), and the prefill's batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(GRAFT_SEED)
    batches = []
    for _ in range(GRAFT_STEPS + 1):
        t = torch.randint(0, G.ENTRY_TENANTS, (GRAFT_LANES,), dtype=torch.int32, device=dev, generator=gen)
        w = torch.randint(-2**31, 2**31, (2, GRAFT_LANES), dtype=torch.int32, device=dev, generator=gen)
        src = torch.randint(0, GRAFT_LANES, (GRAFT_LANES // 10,), device=dev, generator=gen)
        dst = torch.randint(0, GRAFT_LANES, (GRAFT_LANES // 10,), device=dev, generator=gen)
        t[dst], w[:, dst] = t[src], w[:, src]
        batches.append((t, w[0].contiguous(), w[1].contiguous()))
    prefill = batches.pop()
    ops_big = GRAFT_VALID * (OPS_HASH_U64 + k * OPS_PROBE + OPS_HLL_ADD)

    # design fill: every step from the snapshot, its events around the step
    # alone (the restore copies lie outside them); a sleep kernel holds the
    # stream while the host enqueues the series
    step(bits, regs, *prefill, GRAFT_PREFILL)
    snap_bits, snap_regs = bits.clone(), regs.clone()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in batches]
    founds = []
    torch.cuda._sleep(200_000_000)
    for (a, b), (t, l, h) in zip(events, batches):
        bits.copy_(snap_bits)
        regs.copy_(snap_regs)
        a.record()
        founds.append(step(bits, regs, t, l, h, GRAFT_VALID)[0])
        b.record()
    torch.cuda.synchronize()
    fill_ms = [a.elapsed_time(b) for a, b in events]
    fill_bytes = []
    for i, (t, l, h) in enumerate(batches):
        kb = K.Keys(n=GRAFT_LANES, tenant=t, lo=l, hi=h)
        if i % 10 == 0:  # the sector count of every tenth step's inputs
            fill_bytes.append(graft_step_bytes(snap_bits, snap_regs, kb, GRAFT_VALID, k, m, p)[0])
        ref_bits, ref_regs = snap_bits.clone(), snap_regs.clone()
        want = graft_plain_step(ref_bits, ref_regs, kb, GRAFT_VALID, k, m, p)
        err = max(err, assert_equal(f"graft design-fill step {i} found", founds[i], want))
    err = max(err, assert_equal("graft design-fill plane after the last step", bits, ref_bits),
              assert_equal("graft design-fill registers after the last step", regs, ref_regs))
    fill_share = [(x != 0).float().mean().item() for x in (snap_bits, bits)]
    fill_found = statistics.median(f[:GRAFT_VALID].float().mean().item() for f in founds)
    fill_bms, fill_by = bound_ms(statistics.median(fill_bytes), ops_big)
    design = {"prefill_keys": GRAFT_PREFILL, "ms_a_step": statistics.median(fill_ms), "ms_first": fill_ms[0],
              "ms_min": min(fill_ms), "ms_max": max(fill_ms),
              "ops_per_s": GRAFT_VALID / (statistics.median(fill_ms) / 1e3), "bound_ms": fill_bms,
              "bound_by": fill_by, "plane_fill_before_after": fill_share, "found_share_median": fill_found}
    del founds

    # saturated: the same batches one after another into one plane, from
    # the snapshot
    bits.copy_(snap_bits)
    regs.copy_(snap_regs)
    ref_bits, ref_regs = snap_bits, snap_regs
    torch.cuda.synchronize()
    founds = []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for t, l, h in batches:
        founds.append(step(bits, regs, t, l, h, GRAFT_VALID)[0])
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device_ms = e0.elapsed_time(e1)
    step_bytes, plain_ms = [], []
    for i, (t, l, h) in enumerate(batches):
        kb = K.Keys(n=GRAFT_LANES, tenant=t, lo=l, hi=h)
        if i % 10 == 0:  # the sector count of every tenth step's inputs
            step_bytes.append(graft_step_bytes(ref_bits, ref_regs, kb, GRAFT_VALID, k, m, p)[0])
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        want = graft_plain_step(ref_bits, ref_regs, kb, GRAFT_VALID, k, m, p)
        b.record()
        torch.cuda.synchronize()
        plain_ms.append(a.elapsed_time(b))
        err = max(err, assert_equal(f"graft saturated step {i} found", founds[i], want))
    err = max(err, assert_equal(f"graft plane after {GRAFT_STEPS} steps", bits, ref_bits),
              assert_equal(f"graft registers after {GRAFT_STEPS} steps", regs, ref_regs))
    big_bms, big_by = bound_ms(statistics.median(step_bytes), ops_big)
    found_share = [f[:GRAFT_VALID].float().mean().item() for f in (founds[0], founds[-1])]
    sat_fill = (bits != 0).float().mean().item()
    # the host's launch path paces the series above; the card's own time a
    # saturated step: the last 20 batches replayed behind a sleep kernel
    tail = batches[-20:]
    sat_ms = time_kernel(lambda i: step(bits, regs, *tail[i % len(tail)], GRAFT_VALID))
    launches = dict(K.launches)
    out = {"card": card, "entry": {"lanes": int(lo.shape[0]), "n_valid": n_valid, "ms": entry_ms,
                                   "plain_ms": entry_plain, "bound_ms": entry_bms, "bound_by": entry_by,
                                   "bytes": entry_bytes},
           "steps": GRAFT_STEPS, "lanes": GRAFT_LANES, "n_valid": GRAFT_VALID, "design_fill": design,
           "saturated": {"wall_s": wall, "stream_ms_a_step": device_ms / GRAFT_STEPS, "ms_a_step": sat_ms,
                         "steps_per_s": GRAFT_STEPS / wall, "ops_per_s": GRAFT_STEPS * GRAFT_VALID / wall,
                         "bound_ms": big_bms, "bound_by": big_by, "found_share_first_last": found_share,
                         "plane_fill_after": sat_fill},
           "plain_ms_a_step": statistics.median(plain_ms), "max_abs_err": err, "launches": launches}
    log(f"graft [{card}]: the fused step (K10: bloom_probe, bloom_set, hll_add; fused add "
        f"{K.use_fused_add(bits.numel(), GRAFT_VALID, k)}) at entry()'s shape ({G.ENTRY_TENANTS} x {m} plane, "
        f"p {p}, {lo.shape[0]} lanes, n_valid {n_valid}): {entry_ms:.4f} ms a step (plain {entry_plain:.3f} ms, "
        f"bound {entry_bms:.5f} ms by {entry_by}); {GRAFT_STEPS} steps of {GRAFT_LANES} lanes ({GRAFT_VALID} valid) "
        f"at design fill (each from a snapshot after a prefill of {GRAFT_PREFILL} keys; plane fill "
        f"{fill_share[0]:.4f} before, {fill_share[1]:.4f} after the last step; found share median "
        f"{fill_found:.6f}): median {design['ms_a_step']:.4f} ms a step on the card (first {fill_ms[0]:.4f}, "
        f"{min(fill_ms):.4f}-{max(fill_ms):.4f}), {design['ops_per_s']:.4e} ops/s at the median, bound "
        f"{fill_bms:.4f} ms by {fill_by}; the same {GRAFT_STEPS} steps one after another from the snapshot "
        f"(saturated: plane fill {sat_fill:.4f} after them, found share first / last step {found_share[0]:.4f} / "
        f"{found_share[1]:.4f}): {wall:.3f} s wall, "
        f"{GRAFT_STEPS / wall:.1f} steps/s, {GRAFT_STEPS * GRAFT_VALID / wall:.4e} ops/s on the host clock "
        f"({device_ms / GRAFT_STEPS:.4f} ms a step on the stream, the host's launch gaps included), "
        f"{sat_ms:.4f} ms a step on the card behind a held stream (plain {statistics.median(plain_ms):.3f} ms, "
        f"bound {big_bms:.4f} ms by {big_by}); found, plane and registers equal the plain path bit for bit; "
        f"launches {launches}")
    return out


# --------------------------------------------------------------------------
# phase 5: the card against the CPU on one op stream
# --------------------------------------------------------------------------

def run_config4(client, values: list) -> dict:
    """Config 4 (bench.py:343-396) through create(): put_all of the 1M
    entries into an RMap with StringCodec, word_count(m, workers=64) twice
    (the cold scan, then the view of the unchanged map), then a
    KernelMapReduce sum of 8,388,608 int32 values into 1,024 keys.  The
    launch counts are read just after that work.  Each word_count reports
    its own parts (word_count(parts=...)), which synchronizes the card
    between them."""
    from redisson_tpu_torch.client.codec import StringCodec
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.services import mapreduce as MR

    dev = client.engine.device
    m = client.get_map("bench:wc", codec=StringCodec())
    s = time.perf_counter()
    m.put_all({f"doc-{i}": v for i, v in enumerate(values)})
    put_s = time.perf_counter() - s
    K.reset_launches()
    MR.reset_stats()
    walls, counts, parts = [], [], [{}, {}]
    for p in parts:
        s = time.perf_counter()
        counts.append(MR.word_count(m, workers=64, parts=p))
        walls.append(time.perf_counter() - s)
    wc_launches = dict(K.launches)
    kmr = MR.KernelMapReduce(lambda v: (v % KMR_KEYS, v), "sum", KMR_KEYS, device=dev)
    x = np.random.default_rng(17).integers(-(2**31), 2**31 - 1, KMR_N).astype(np.int32)
    torch.cuda.synchronize()
    s = time.perf_counter()
    got = kmr.execute(x)
    kmr_s = time.perf_counter() - s
    launches = dict(K.launches)
    stats = dict(MR.STATS)
    # numpy: float64 sums are exact here (|sum| < 2**53), then wrapped to int32
    want = np.bincount(np.mod(x, KMR_KEYS), weights=x.astype(np.float64), minlength=KMR_KEYS).astype(np.int64)
    want = (((want + 2**31) % 2**32) - 2**31).astype(np.int32)
    if not np.array_equal(got, want):
        raise AssertionError("config4: KernelMapReduce sum differs from numpy")
    s = time.perf_counter()
    host = MR._host_word_count(values)
    host_s = time.perf_counter() - s
    for i, c in enumerate(counts):
        if c != host:
            raise AssertionError(f"config4: word_count run {i} differs from the host count")
    if sum(host.values()) != C4_ENTRIES * C4_WORDS or len(host) != C4_VOCAB:
        raise AssertionError(f"config4: {sum(host.values())} words over {len(host)}")
    if stats != {"device_scans": 1, "view_hits": 1, "host_fallbacks": 0}:
        raise AssertionError(f"config4: scans {stats}, want one device scan and one view hit")
    if wc_launches["wc_words"] != 2 or wc_launches["wc_sort_runs"] != 2:
        raise AssertionError(f"config4: word_count launched {wc_launches}")

    res = {"entries": C4_ENTRIES, "words": C4_ENTRIES * C4_WORDS, "put_all_s": put_s,
           "cold_s": walls[0], "warm_s": walls[1], "cold_entries_per_s": C4_ENTRIES / walls[0],
           "warm_entries_per_s": C4_ENTRIES / walls[1], "host_count_s": host_s,
           "kmr_values": KMR_N, "kmr_keys": KMR_KEYS, "kmr_s": kmr_s, "stats": stats,
           "cold_parts": parts[0], "warm_parts": parts[1], "launches": launches}
    log(f"config4: put_all {C4_ENTRIES} entries {put_s:.3f}s; word_count cold {walls[0]:.3f}s "
        f"({res['cold_entries_per_s']:.4g} entries/s), warm (staged view) {walls[1]:.4f}s "
        f"({res['warm_entries_per_s']:.4g} entries/s); host Counter {host_s:.3f}s; {len(host)} words, "
        f"{sum(host.values())} in all, equal to the host count; scans {stats}; KernelMapReduce sum of "
        f"{KMR_N} int32 into {KMR_KEYS} keys {kmr_s * 1e3:.1f} ms, equal to numpy; "
        + "; ".join(f"{which} scan's parts " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in p.items())
                    for which, p in (("cold", parts[0]), ("warm", parts[1]))))
    m.delete()
    return res


def c7_clustered(rng, n: int, d: int) -> np.ndarray:
    """Config 7's clustered corpus (bench.py:1933-1940): 512 centres, each
    row a centre plus N(0, 0.25**2) noise."""
    centers = rng.standard_normal((C7_CLUSTERS, d)).astype(np.float32)
    return (centers[rng.integers(C7_CLUSTERS, size=n)] + 0.25 * rng.standard_normal((n, d))).astype(np.float32)


def c7_queries(rng, vecs: np.ndarray, nq: int) -> np.ndarray:
    """Queries near the corpus: a row plus N(0, 0.1**2) noise."""
    return (vecs[rng.integers(vecs.shape[0], size=nq)] + 0.1 * rng.standard_normal((nq, vecs.shape[1]))).astype(
        np.float32)


def c7_cells(assign: np.ndarray, nlist: int):
    """Sentinel-padded (nlist, cap) cell lists of ascending row ids from an
    assignment (-1: none), cap as the service sizes it (3 x the mean)."""
    from redisson_tpu_torch.core import kernels as K

    live = np.nonzero(assign >= 0)[0]
    cap = K.bucket_size(max(4, int(round(3 * max(1, -(-live.size // nlist))))), minimum=4)
    cells = np.full((nlist, cap), 0x3FFFFFFF, np.int32)
    order = np.lexsort((live, assign[live]))
    rows, cell = live[order], assign[live[order]]
    rank = np.arange(rows.size) - np.searchsorted(cell, np.arange(nlist))[cell]
    keep = rank < cap
    cells[cell[keep], rank[keep]] = rows[keep]
    return cells, cap


def c7_truth(dev, vecs: np.ndarray, queries: np.ndarray, metric: str, k: int):
    """The float64 brute-force oracle's top k ids per query (stable order),
    computed on the card in float64."""
    v = torch.from_numpy(vecs).to(dev, torch.float64)
    q = torch.from_numpy(queries).to(dev, torch.float64)
    dots = q @ v.T
    if metric == "COSINE":
        den = q.norm(dim=1)[:, None] * v.norm(dim=1)[None, :]
        dist = 1.0 - torch.where(den > 0, dots / den, 0.0)
    else:
        dist = (q * q).sum(1)[:, None] - 2.0 * dots + (v * v).sum(1)[None, :]
    truth = torch.sort(dist, dim=1, stable=True).indices[:, :k].cpu().numpy()
    del v, q, dots, dist
    torch.cuda.empty_cache()
    return [set(t.tolist()) for t in truth]


def c7_leg(svc, name: str, spec: dict, vecs: np.ndarray, queries, oracle_q, truth, k: int, seconds: float,
           nprobe=None, ingest=True, numeric=False) -> dict:
    """One config-7 leg through the service, as bench.py measures it: ingest
    one add_document a doc (with `numeric`, each doc also carries a NUMERIC
    field, its row number), a warm query (the IVF training), stacked
    batches of Qb queries for `seconds` (one dispatch and one readback a
    batch), then recall@k of the oracle queries.  Returns the leg's numbers
    and its launch counts (set to 0 just before the leg)."""
    from redisson_tpu_torch.core import kernels as K

    K.reset_launches()
    ingest_s = None
    if ingest:
        schema = {"price": "NUMERIC", "emb": "VECTOR"} if numeric else {"emb": "VECTOR"}
        svc.create_index(name, schema, vector={"emb": spec})
        s = time.perf_counter()
        if numeric:
            for i in range(vecs.shape[0]):
                svc.add_document(name, f"d{i}", {"price": i, "emb": vecs[i]})
        else:
            for i in range(vecs.shape[0]):
                svc.add_document(name, f"d{i}", {"emb": vecs[i]})
        ingest_s = time.perf_counter() - s
    s = time.perf_counter()
    dev_, fin = svc.knn(name, "emb", queries, k, nprobe=nprobe)
    fin(dev_)
    warm_s = time.perf_counter() - s
    done, s = 0, time.perf_counter()
    while time.perf_counter() - s < seconds:
        dev_, fin = svc.knn(name, "emb", queries, k, nprobe=nprobe)
        fin(dev_)
        done += queries.shape[0]
    qps = done / (time.perf_counter() - s)
    dev_, fin = svc.knn(name, "emb", oracle_q, k, nprobe=nprobe)
    got = fin(dev_)
    hits = sum(len(truth[i] & {int(doc[1:]) for doc, _s in got[i][:k]}) for i in range(len(truth)))
    launches = {key: K.launches[key] for key in VECTOR_KERNELS}
    bank = svc._idx(name).vectors.banks["emb"]
    leg = {"n": int(vecs.shape[0]), "dim": int(vecs.shape[1]), "k": k, "metric": spec.get("metric"),
           "dtype": spec.get("dtype", "FLOAT32"), "algo": spec.get("algo", "FLAT"), "nprobe": nprobe,
           "ingested": ingest, "numeric_field": numeric,
           "qps": qps, "recall_at_10": hits / (k * len(truth)), "warm_s": warm_s,
           "bank_device_bytes": bank.device_bytes(), "index_device_bytes": bank.index_device_bytes(),
           "h2d_flushes": bank.h2d_flushes, "launches": launches}
    if ingest_s is not None:
        leg["ingest_docs_per_s"] = vecs.shape[0] / ingest_s
    leg["device_ms"] = c7_device_ms(bank, queries, k, nprobe)
    # the card's busy share of the timed window: device ms a batch over wall ms a batch
    leg["device_busy_share"] = leg["device_ms"] * qps / (1e3 * queries.shape[0])
    log(f"config7 {name}: N={leg['n']} d={leg['dim']} {leg['metric']} {leg['dtype']} {leg['algo']}"
        + (f" nprobe {nprobe}" if nprobe else "") + f": {qps:.1f} qps (batch {queries.shape[0]}), device "
        f"{leg['device_ms']:.4f} ms a batch (busy {leg['device_busy_share']:.3f} of the wall), recall@10 "
        f"{leg['recall_at_10']:.4f}"
        + (f", ingest {leg['ingest_docs_per_s']:.1f} docs/s" if ingest_s is not None else "")
        + f", bank {leg['bank_device_bytes']} B, index {leg['index_device_bytes']} B, {bank.h2d_flushes} H2D flushes;"
        f" launches {launches}")
    return leg


def c7_device_ms(bank, queries, k: int, nprobe) -> float:
    """Device ms of one batch's KNN program (bank.dispatch, as knn_async
    runs it; the leg's kernels queued behind a sleep kernel so host launch
    time does not count), on the bank's staged planes.  Not counted in the
    leg's launches."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.services import vector as V

    counts = dict(K.launches)
    with bank._lock:
        planes = bank.device_planes()
        staged = K.stage(bank._pad_queries(queries, V._query_bucket(queries.shape[0])), planes[0].device)
        ms = time_kernel(lambda i: bank.dispatch(planes, staged, k, nprobe))
    K.launches.update(counts)
    return ms


def host_ms(fn, reps: int) -> float:
    """Median host ms of fn() over reps calls, each ended by a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - s) * 1e3)
    return statistics.median(times)


def call_ms(fn, reps: int) -> float:
    """Median host ms of the call fn() alone over reps calls, from an idle
    card: its Python and its launches, not the device work it queues."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s = time.perf_counter()
        fn()
        times.append((time.perf_counter() - s) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def c7_parts(svc, name: str, queries, k: int, nprobe=None, condition=None) -> dict:
    """Where one batch's time goes, piece by piece on the bank's own
    operands (median of 20 each): a whole batch (svc.knn, then finish, to
    a synchronize), the dispatch alone (svc.knn, host ms to its return),
    the dispatch's own steps on the host (the training gate, the planes,
    for IVF the index sync and the device index check, staging the padded
    queries), each kernel wrapper's call on the host (`*_call_ms`) and its
    device ms (as time_kernel), the readback of (dist, idx) and finish.
    FLAT runs score and select; IVF the route's score and select, then
    ivf_score and the candidates' select.  With `condition` (FLAT), also
    building the (Qb, cap) float32 prefilter bias on the host and its
    upload (median of 3) and one masked query end to end.  Not counted in
    any launches."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.services import vector as V

    counts = dict(K.launches)
    bank = svc._idx(name).vectors.banks["emb"]
    planes, bias, scale, rows = bank.device_planes()
    dev = planes.device
    qb = V._query_bucket(queries.shape[0])
    metric = bank.spec.metric

    def batch():
        dev_, fin_ = svc.knn(name, "emb", queries, k, nprobe=nprobe)
        return fin_(dev_)

    def locked(fn):
        def run():
            with bank._lock:
                return fn()
        return run

    parts = {"batch_ms": host_ms(batch, 20),
             "dispatch_ms": call_ms(lambda: svc.knn(name, "emb", queries, k, nprobe=nprobe), 20),
             "train_gate_ms": call_ms(bank._maybe_train, 20),
             "planes_ms": call_ms(bank.device_planes, 20)}
    staged = K.stage(bank._pad_queries(queries, qb), dev)
    if bank.ivf_ready():
        parts["ivf_sync_ms"] = call_ms(locked(bank._ivf_sync), 20)
        parts["index_ms"] = call_ms(locked(bank._ensure_index_device), 20)
        dc, dl = bank._ensure_index_device()
        np_eff = bank._resolve_nprobe(nprobe)
        k_eff = max(1, min(k, np_eff * bank._ivf.cell_cap))
        route = K.knn_score(dc, None, None, None, staged, dc.shape[0], metric)
        probe = K.knn_select(route, np_eff)[1]
        cd, cids = K.ivf_score(planes, scale, bias, None, dl, probe, staged, rows, metric)
        steps = [("route_score", lambda: K.knn_score(dc, None, None, None, staged, dc.shape[0], metric)),
                 ("route_select", lambda: K.knn_select(route, np_eff)),
                 ("ivf_score", lambda: K.ivf_score(planes, scale, bias, None, dl, probe, staged, rows, metric)),
                 ("select", lambda: K.knn_select(cd, k_eff, cids))]
    else:
        k_eff = max(1, min(k, bank._cap))
        dist = K.knn_score(planes, scale, bias, None, staged, rows, metric)
        steps = [("score", lambda: K.knn_score(planes, scale, bias, None, staged, rows, metric)),
                 ("select", lambda: K.knn_select(dist, k_eff))]
    parts["stage_ms"] = call_ms(lambda: K.stage(bank._pad_queries(queries, qb), dev), 20)
    for step, fn in steps:
        parts[f"{step}_call_ms"] = call_ms(fn, 20)
        parts[f"{step}_ms"] = time_kernel(lambda i: fn())
    d, ix = steps[-1][1]()
    parts["readback_ms"] = host_ms(lambda: (d.cpu().numpy(), ix.cpu().numpy()), 20)
    host = (d.cpu().numpy(), ix.cpu().numpy())
    _dev, fin = svc.knn(name, "emb", queries, k, nprobe=nprobe)
    parts["finish_ms"] = host_ms(lambda: fin(host), 20)
    if condition is not None:
        allowed = np.fromiter(svc._idx(name)._rowid.values(), np.int64)[::2]

        def build():
            qbias = np.full((qb, bank._cap), np.inf, np.float32)
            qbias[:, allowed] = 0.0
            return qbias

        parts["qbias_build_ms"] = host_ms(build, 3)
        qbias = build()
        parts["qbias_upload_ms"] = host_ms(lambda: K.stage(qbias, dev), 3)
        parts["qbias_bytes"] = qbias.nbytes
        del qbias

        def masked():
            dev_, fin_ = svc.knn(name, "emb", queries, k, condition=condition)
            return fin_(dev_)

        parts["masked_query_ms"] = host_ms(masked, 1)
    K.launches.update(counts)
    return parts


def run_config7(client) -> dict:
    """Config 7 (bench.py:1787-2031) through create().get_search(), nothing
    cut: the two FLAT points (COSINE, ingest one add_document a doc, batches
    of 64 queries, recall@10 against the float64 oracle); the clustered
    corpus (50,000 x 128 COSINE): FLAT, IVF at nlist 1,536 with nprobe 2, 4
    and 8, INT8 FLAT and IVF over INT8; then 1,000,000 x 128 L2 FLAT.  Each
    leg's launches are set to 0 just before it; the path's are their sum.
    Fails unless the reference's quality and size floors hold
    (tests/test_vector_search.py:543-660): FLAT recall >= 0.99, IVF at
    nprobe 4 recall >= 0.97, INT8 recall >= 0.95 on <= 0.35x the float32
    bank's bytes.  The reference's speed floor, IVF at nprobe 4 at twice
    FLAT's wall qps on the same corpus (bench.py's
    config7_ivf_speedup_vs_flat), is computed as bench.py computes it and
    printed as held or NOT MET: on an H100 it is not met (PERF.md section
    5).  The device-ms ratio is printed beside it as a diagnostic."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.services.search import Range

    dev = client.engine.device
    svc = client.get_search()
    rng = np.random.default_rng(71)
    legs, parts = {}, {}
    for n, d, k in C7_POINTS:
        name = f"v7_{n}_{d}"
        vecs = rng.standard_normal((n, d)).astype(np.float32)
        rng.standard_normal((C7_QB, d))  # bench.py's warm-up queries (the leg warms on its own batch)
        queries = rng.standard_normal((C7_QB, d)).astype(np.float32)
        oracle_q = rng.standard_normal((C7_ORACLE, d)).astype(np.float32)
        truth = c7_truth(dev, vecs, oracle_q, "COSINE", k)
        legs[name] = c7_leg(svc, name, {"dim": d, "metric": "COSINE"}, vecs, queries, oracle_q, truth, k,
                            C7_MEASURE_S)
        if n == C7_POINTS[1][0]:
            parts[name] = c7_parts(svc, name, queries, k)
        svc.drop_index(name)
    n, d, k = C7_POINTS[1]
    vecs = c7_clustered(rng, n, d)
    queries = c7_queries(rng, vecs, C7_QB)
    oracle_q = c7_queries(rng, vecs, C7_ORACLE)
    truth = c7_truth(dev, vecs, oracle_q, "COSINE", k)
    cos = {"dim": d, "metric": "COSINE"}
    legs["v7c_flat"] = c7_leg(svc, "v7c_flat", cos, vecs, queries, oracle_q, truth, k, C7_IVF_MEASURE_S)
    parts["v7c_flat"] = c7_parts(svc, "v7c_flat", queries, k)
    svc.drop_index("v7c_flat")
    ivf_spec = dict(cos, algo="IVF", nlist=C7_NLIST)
    for i, nprobe in enumerate(C7_NPROBES):
        legs[f"v7c_ivf_np{nprobe}"] = c7_leg(svc, "v7c_ivf", ivf_spec, vecs, queries, oracle_q, truth, k,
                                             C7_IVF_MEASURE_S, nprobe=nprobe, ingest=i == 0)
        if nprobe == 4:
            parts["v7c_ivf_np4"] = c7_parts(svc, "v7c_ivf", queries, k, nprobe=4)
    svc.drop_index("v7c_ivf")
    legs["v7c_i8"] = c7_leg(svc, "v7c_i8", dict(cos, dtype="INT8"), vecs, queries, oracle_q, truth, k,
                            C7_IVF_MEASURE_S)
    svc.drop_index("v7c_i8")
    legs["v7c_ivf8"] = c7_leg(svc, "v7c_ivf8", dict(ivf_spec, dtype="INT8"), vecs, queries, oracle_q, truth, k,
                              C7_IVF_MEASURE_S, nprobe=4)
    svc.drop_index("v7c_ivf8")
    # the shape of ann-benchmarks' sift-128-euclidean: 1M x 128, L2
    n, d, k = C7_SIFT
    srng = np.random.default_rng(C7_SEED + 7)
    vecs = srng.standard_normal((n, d), dtype=np.float32)
    queries = srng.standard_normal((C7_QB, d), dtype=np.float32)
    oracle_q = srng.standard_normal((C7_ORACLE, d), dtype=np.float32)
    truth = c7_truth(dev, vecs, oracle_q, "L2", k)
    l2 = {"dim": d, "metric": "L2"}
    legs["v7_sift"] = c7_leg(svc, "v7_sift", l2, vecs, queries, oracle_q, truth, k, C7_MEASURE_S, numeric=True)
    parts["v7_sift"] = c7_parts(svc, "v7_sift", queries, k, condition=Range("price", hi=n // 2 - 0.5))
    svc.drop_index("v7_sift")
    del vecs
    # floors
    flat, ivf4 = legs["v7c_flat"], legs["v7c_ivf_np4"]
    wall_ratio = ivf4["qps"] / flat["qps"]  # bench.py's config7_ivf_speedup_vs_flat
    device_ratio = flat["device_ms"] / ivf4["device_ms"]
    int8_ratio = legs["v7c_i8"]["bank_device_bytes"] / flat["bank_device_bytes"]
    failures = [f"{nm} recall {leg['recall_at_10']:.4f} < 0.99" for nm, leg in legs.items()
                if leg["algo"] == "FLAT" and leg["dtype"] == "FLOAT32" and leg["recall_at_10"] < 0.99]
    if ivf4["recall_at_10"] < 0.97:
        failures.append(f"IVF nprobe 4 recall {ivf4['recall_at_10']:.4f} < 0.97")
    if legs["v7c_i8"]["recall_at_10"] < 0.95:
        failures.append(f"INT8 recall {legs['v7c_i8']['recall_at_10']:.4f} < 0.95")
    if int8_ratio > 0.35:
        failures.append(f"INT8 bytes {int8_ratio:.4f}x float32's > 0.35")
    missing = []
    for nm, leg in legs.items():
        want = ["knn_score", "knn_select"]
        if leg["algo"] == "IVF":
            want += ["ivf_score"] + (["kmeans"] if leg["ingested"] else [])  # the first query trains
        missing += [f"{nm}: {kname}" for kname in want if leg["launches"][kname] == 0]
    if missing:
        failures.append(f"legs that never launched their kernels: {missing}")
    if failures:
        raise AssertionError("config7: " + "; ".join(failures))
    launches = dict.fromkeys(K.launches, 0)
    for leg in legs.values():
        for key, v in leg["launches"].items():
            launches[key] += v
    speedup_held = wall_ratio >= 2.0
    log(f"config7 floors held: FLAT recall >= 0.99 at every FLAT float32 leg; IVF nprobe 4 recall "
        f"{ivf4['recall_at_10']:.4f} >= 0.97; INT8 recall {legs['v7c_i8']['recall_at_10']:.4f} >= 0.95 at "
        f"{int8_ratio:.4f}x the float32 bytes (<= 0.35)")
    log(f"config7 floor {'held' if speedup_held else 'NOT MET'}: IVF nprobe 4 at {wall_ratio:.3f}x FLAT's wall "
        f"qps on the clustered corpus ({ivf4['qps']:.1f} against {flat['qps']:.1f}; floor 2, bench.py's "
        f"config7_ivf_speedup_vs_flat); diagnostic: {device_ratio:.3f}x on device ms a batch "
        f"({ivf4['device_ms']:.4f} against {flat['device_ms']:.4f})")
    for nm, p in parts.items():
        log(f"config7 {nm} parts: " + ", ".join(f"{key} {v:.4f}" for key, v in p.items()))
    return {"legs": legs, "parts": parts, "ivf_speedup_wall": wall_ratio, "ivf_speedup_floor_held": speedup_held,
            "ivf_speedup_device": device_ratio, "int8_bytes_ratio": int8_ratio, "launches": launches}


def mapreduce_stream(client, rng) -> list:
    """word_count (cold, then the staged view, then after a put),
    device_word_count (also past its d_max) and KernelMapReduce sum, max
    and min over int32, float32 and whole float32 values, through one
    client: (label, reply, tolerance) in
    order, the tolerance None where the reply must be equal."""
    from redisson_tpu_torch.client.codec import StringCodec
    from redisson_tpu_torch.services import mapreduce as MR

    dev = client.engine.device
    vals = [" ".join(f"w{j}" for j in rng.integers(0, 3000, 8)) for _ in range(20_000)]
    vals += ["tab\tsep\x1cctl", "x" * 100 + " y", ""]
    m = client.get_map("mr:wc", codec=StringCodec())
    m.put_all({f"d{i}": v for i, v in enumerate(vals)})
    out = [("word_count cold", MR.word_count(m), None), ("word_count view", MR.word_count(m), None),
           ("device_word_count", MR.device_word_count(vals, device=dev), None)]
    # 3,000 distinct words past a d_max of 2**10: the sort runs again on the device
    fallbacks = MR.STATS["host_fallbacks"]
    out.append(("device_word_count past d_max", MR.device_word_count(vals, d_max_bits=10, device=dev), None))
    if MR.STATS["host_fallbacks"] != fallbacks:
        raise AssertionError("device_word_count past d_max took the host path")
    m.put("extra", "fresh words")
    out.append(("word_count after a put", MR.word_count(m), None))
    x = rng.integers(-(2**31), 2**31 - 1, 100_000).astype(np.int32)
    f = rng.normal(0, 100, 100_000).astype(np.float32)
    fkeys = np.mod((f * np.float32(10)).astype(np.int32), 64)
    tol = float_sum_limit(torch.from_numpy(fkeys), torch.from_numpy(f), 64).numpy()
    whole = np.rint(f)  # |sum| of a key's whole values < 100,000 * 500 < 2**24: exact in any order
    for reduce in ("sum", "max", "min"):
        kmr = MR.KernelMapReduce(lambda v: (v % 97 - 5, v), reduce, 90, device=dev)
        out.append((f"KernelMapReduce {reduce} int32", kmr.execute(x), None))
        kmr = MR.KernelMapReduce(lambda v: ((v * 10).to(torch.int32) % 64, v), reduce, 64, device=dev)
        out.append((f"KernelMapReduce {reduce} float32", kmr.execute(f), tol if reduce == "sum" else None))
        out.append((f"KernelMapReduce {reduce} whole float32", kmr.execute(whole), None))
    client.shutdown()
    return out


def check_mapreduce_card_against_cpu(create) -> None:
    on_card = mapreduce_stream(create(), np.random.default_rng(21))
    on_cpu = mapreduce_stream(create(device="cpu"), np.random.default_rng(21))
    for (label, a, tol), (_, b, _) in zip(on_card, on_cpu):
        if isinstance(a, dict):
            ok = a == b
        elif tol is not None:
            ok = bool(np.all(np.abs(a.astype(np.float64) - b) <= tol))
        else:
            ok = np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"MapReduce stream, {label}: card and cpu differ")
    log(f"MapReduce stream: {len(on_card)} replies (word_count cold, from its view and after a put, "
        "device_word_count, also past d_max, KernelMapReduce sum, max and min on int32, float32 and "
        "whole float32) equal on the card and the CPU (the float32 sum of N(0, 100) within float_sum_limit)")


def search_stream(client, snaps: dict, train: bool) -> list:
    """A search stream through create().get_search(): an index with TEXT,
    TAG, NUMERIC and VECTOR fields (add, update, delete; text, tag and
    numeric searches, an aggregation, FLAT KNN plain and hybrid with a
    numeric range), then FLAT and IVF KNN in every metric and dtype, plain
    and hybrid.  IVF indexes train on the card (`train`) and record their
    index in `snaps`; the CPU run installs it instead (its own k-means may
    differ in the last bits), so both score the same cells."""
    from redisson_tpu_torch.services.search import And, Eq, Range, Text

    rng = np.random.default_rng(31)
    svc = client.get_search()
    out = []
    svc.create_index("docs", {"title": "TEXT", "tag": "TAG", "price": "NUMERIC", "emb": "VECTOR"},
                     vector={"emb": {"dim": 32, "metric": "L2"}})
    vecs = rng.standard_normal((3000, 32)).astype(np.float32)
    for i in range(3000):
        svc.add_document("docs", f"d{i}", {"title": f"word{i % 7} item{i % 13}", "tag": "abc"[i % 3],
                                           "price": float(i), "emb": vecs[i]})
    for i in range(0, 3000, 15):  # updates: a new vector and price
        svc.add_document("docs", f"d{i}", {"title": f"word{i % 5}", "tag": "b", "price": float(-i),
                                           "emb": vecs[i] + 3.0})
    for i in range(7, 3000, 29):
        svc.remove_document("docs", f"d{i}")
    for cond, sort_by in ((Text("title", "word3"), "price"), (And([Eq("tag", "b"), Range("price", lo=100, hi=900)]),
                                                              None)):
        res = svc.search("docs", cond, sort_by=sort_by, limit=50)
        out.append((res.total, [(d, {f: v for f, v in fields.items() if f != "emb"}) for d, fields in res.docs]))
    out.append(svc.aggregate("docs", group_by="tag", reducers={"n": ("count", None), "avg": ("avg", "price")}))
    q = vecs[:16] + 0.01
    for cond in (None, Range("price", lo=500, hi=2500, lo_inc=False)):
        dev_, fin = svc.knn("docs", "emb", q, 10, condition=cond)
        out.append(fin(dev_))
    centers = rng.standard_normal((16, 24)).astype(np.float32)
    for algo in ("FLAT", "IVF"):
        for dtype in ("FLOAT32", "FLOAT16", "INT8"):
            for metric in ("L2", "COSINE", "IP"):
                name = f"s_{algo}_{dtype}_{metric}"
                spec = {"dim": 24, "metric": metric, "dtype": dtype, "algo": algo}
                if algo == "IVF":
                    spec.update(nlist=16, nprobe=4, train_min=256)
                svc.create_index(name, {"price": "NUMERIC", "emb": "VECTOR"}, vector={"emb": spec})
                v = (centers[rng.integers(16, size=1200)] + 0.3 * rng.standard_normal((1200, 24))).astype(np.float32)
                for i in range(1200):
                    svc.add_document(name, f"d{i}", {"price": i, "emb": v[i]})
                svc.remove_document(name, "d3")
                bank = svc._idx(name).vectors.banks["emb"]
                if algo == "IVF":
                    ivf = bank._ivf
                    if train:
                        bank.retrain()
                        snaps[name] = (ivf.centroids.copy(), ivf.assign.copy(), ivf.trained_rows, ivf.trains)
                    else:
                        cent, assign, ivf.trained_rows, ivf.trains = snaps[name]
                        ivf.centroids, ivf.assign = cent.copy(), assign.copy()
                        ivf.dirty_rows.clear()
                        ivf.cells_stale = True
                qv = v[:20] + 0.01
                for cond in (None, Range("price", hi=600)):
                    dev_, fin = svc.knn(name, "emb", qv, 10, condition=cond)
                    out.append(fin(dev_))
                svc.drop_index(name)
    return out


def check_search_card_against_cpu(create) -> None:
    snaps = {}
    on_card = search_stream(create(), snaps, train=True)
    on_cpu = search_stream(create(device="cpu"), snaps, train=False)
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if a != b:
            raise AssertionError(f"search stream reply {i}: card {a!r} != cpu {b!r}")
    log(f"search stream: {len(on_card)} replies (text, tag and numeric searches, an aggregation, FLAT and IVF KNN "
        "in every metric and dtype, plain and hybrid; adds, updates, deletes) equal on the card and the CPU")


def small_stream(client, rng) -> list:
    out = []
    a = client.get_bloom_filter_array("s:bank")
    a.try_init(16, 10_000, 0.01)
    t = rng.integers(0, 16, 20_000).astype(np.int32)
    ks = rng.integers(-(2**62), 2**62, 20_000)
    out.append(a.add_each(t, ks))
    out.append(a.add(t[:5000], ks[:5000]))
    out.append(a.contains(np.concatenate([t[:3000], t[:3000]]), np.concatenate([ks[:3000], ks[:3000] + 1])))
    out.append(a.add_flushes([(t[:700], ks[:700]), (t[700:3000], ks[700:3000])]))
    bf = client.get_bloom_filter("s:bf")
    bf.try_init(5000, 0.01)
    out.append(bf.add_all(["a", "b", 7, 2.5, "a"]))
    out.append(bf.add_each(np.arange(300)))
    out.append(bf.contains_each(["a", "zz", 7]))
    out.append(bf.count())
    h = client.get_hyper_log_log_array("s:hll")
    h.try_init(64)
    h.add(rng.integers(0, 64, 20_000).astype(np.int32), rng.integers(0, 2**60, 20_000))
    h.merge_rows([0, 0, 1, 5], [1, 2, 0, 0])
    out.append(h.estimate_all())
    out.append(h.estimate_union_pairs([0, 3, -1], [1, 63, 70]))
    x, y = client.get_hyper_log_log("s:x"), client.get_hyper_log_log("s:y")
    x.add_all([f"k{i}" for i in range(800)])
    y.add_all(np.arange(500, 2000))
    out.append((x.count(), x.count_with("s:y")))
    x.merge_with("s:y")
    out.append(x.count())
    from redisson_tpu_torch import state

    for name in ("s:bank", "s:bf", "s:hll", "s:x"):
        out.append(state.to_reference(client.engine.store.get(name))[2])
    return out


def same(a, b) -> bool:
    if isinstance(a, BaseException):
        return type(a) is type(b) and a.args == b.args
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def rbatch_stream(client, rng, overlap: bool) -> list:
    """Every verb of the Batch, in three batches (plain, skip_result,
    atomic): fused add and contains runs, a run that mixed geometry refuses,
    an add-then-contains pair, codec keys, an op on a missing filter (its
    error lands on its future), a bank, bit sets, HLL, a bucket and a
    counter; then BITOP AND, OR, XOR and NOT, cardinality, length and
    bitpos on the bit sets.  Returns the replies and the final states."""
    from redisson_tpu_torch import state
    from redisson_tpu_torch.core import ioplane

    prev = ioplane.set_overlap(overlap)
    try:
        out = []
        for i in range(3):
            client.get_bloom_filter(f"rb:{i}").try_init(10_000, 0.01)
        client.get_bloom_filter("rb:x").try_init(90_000, 0.001)
        client.get_bloom_filter("rb:s").try_init(2_000, 0.01)
        client.get_bloom_filter_array("rb:bank").try_init(8, 1000, 0.01)
        keys = [rng.integers(0, 1 << 60, 3000 + i).astype(np.int64) for i in range(4)]
        for skip, atomic in ((False, False), (True, False), (False, True)):
            b = client.create_batch(skip_result=skip, atomic=atomic)
            futs = [b.get_bloom_filter(f"rb:{i}").add_async(keys[i]) for i in range(3)]
            futs.append(b.get_bloom_filter("rb:x").add_async(keys[3]))
            futs += [b.get_bloom_filter(f"rb:{i}").contains_async(keys[i + 1]) for i in range(3)]
            futs.append(b.get_bloom_filter("rb:0").add_async(keys[2][:500]))
            futs.append(b.get_bloom_filter("rb:0").contains_async(keys[2]))
            futs.append(b.get_bloom_filter("rb:s").add_async(["a", 1, 2.5]))
            futs.append(b.get_bloom_filter("rb:s").contains_async(["a", "b"]))
            futs.append(b.get_bloom_filter("rb:missing").contains_async(keys[0][:5]))
            t = (keys[0] % 8).astype(np.int32)
            futs.append(b.get_bloom_filter_array("rb:bank").add_async(t, keys[0]))
            futs.append(b.get_bloom_filter_array("rb:bank").contains_async(t, keys[0] + 1))
            futs.append(b.get_bit_set("rb:bits").set_async(keys[1] % 50_000))
            futs.append(b.get_bit_set("rb:bits").get_async(keys[2] % 50_000))
            futs.append(b.get_bit_set("rb:bits").set_async(keys[3][:90] % 50_000, False))
            futs.append(b.get_hyper_log_log("rb:h").add_all_async(keys[0]))
            futs.append(b.get_bucket("rb:v").set_async([1, "x"]))
            futs.append(b.get_bucket("rb:v").get_async())
            futs.append(b.get_atomic_long("rb:n").add_and_get_async(3))
            try:
                b.execute()
            except RuntimeError:  # the missing filter's error, raised by the replies
                pass
            for f in futs:
                try:
                    out.append(f.get())
                except RuntimeError as e:
                    out.append(("error", str(e)))
        # BITOP and the other bit-set ops (torch ops) on the batch's bit set
        bits, other, third = (client.get_bit_set(n) for n in ("rb:bits", "rb:bits2", "rb:bits3"))
        out.append(other.set_each(keys[0][:700] % 70_000))
        out.append(third.set_each(keys[1][:900] % 90_000))
        bits.or_("rb:bits2")
        out.append((bits.cardinality(), bits.length(), bits.bitpos(True), bits.bitpos(False)))
        bits.xor("rb:bits2")
        out.append(bits.cardinality())
        third.and_("rb:bits", "rb:bits2")
        third.not_()
        out.append((third.cardinality(), third.length(), third.bitpos(False)))
        for name in ("rb:0", "rb:1", "rb:2", "rb:x", "rb:s", "rb:bank", "rb:bits", "rb:bits2", "rb:bits3",
                     "rb:h", "rb:v", "rb:n"):
            out.append(state.to_reference(client.engine.store.get(name)))
        return out
    finally:
        ioplane.set_overlap(prev)


# --------------------------------------------------------------------------
# phase 4, the server: redisson_tpu_torch.server on the card, over the wire
# --------------------------------------------------------------------------

# config 2 over the wire (bench.py:737-803's BFA.* blob flushes): the bank
# populated in frames of 100,000 keys, 30 synchronous BFA.MEXISTS64 frames
# and a pipelined window of 50; the embedded bank's geometry
SRV_C2_FRAME, SRV_C2_PROBES, SRV_C2_WINDOW = 100_000, 30, 50
C2_LANES, C2_K = 96_256, 7
# config 5's command stream on one server (bench.py:399-428): one warm rep,
# then timed reps; config 3 over the wire: ten HLLA.MADD64 frames of 1M ops
SRV_C5_REPS = 4
# the mixed stream of every served verb, card server against CPU server
SRV_MIXED_SCALE = 8


def server_config5_cmds(rng, tag: str):
    """bench.py:399-428's config 5 stream (`_mixed_cluster_cmds`), one rep:
    BF.RESERVE, BF.MADD64 and BF.MEXISTS64 a tenant (three runs of 64),
    SETBITSB of 500 indexes below 100,000 into two bit sets a tenant, then
    BITOP OR and XOR.  Returns (commands, ops counted as bench.py counts)."""
    keysets = [np.arange(t * C5_PER, (t + 1) * C5_PER, dtype=np.int64) * 2654435761
               for t in range(C5_TENANTS)]
    blobs = [np.ascontiguousarray(ks, "<i8").tobytes() for ks in keysets]
    cmds = [("BF.RESERVE", f"bf{tag}{{t{t}}}", FPP, C5_PER) for t in range(C5_TENANTS)]
    cmds += [("BF.MADD64", f"bf{tag}{{t{t}}}", blobs[t]) for t in range(C5_TENANTS)]
    cmds += [("BF.MEXISTS64", f"bf{tag}{{t{t}}}", blobs[t]) for t in range(C5_TENANTS)]
    ops = 2 * C5_TENANTS * C5_PER
    for t in range(C5_TENANTS):
        i1 = np.ascontiguousarray(rng.integers(0, C5_BITS, C5_BIT_OPS), "<i4").tobytes()
        i2 = np.ascontiguousarray(rng.integers(0, C5_BITS, C5_BIT_OPS), "<i4").tobytes()
        cmds.append(("SETBITSB", f"bits{tag}{{t{t}}}", i1))
        cmds.append(("SETBITSB", f"bits2{tag}{{t{t}}}", i2))
        cmds.append(("BITOP", "OR", f"bits{tag}{{t{t}}}", f"bits{tag}{{t{t}}}", f"bits2{tag}{{t{t}}}"))
        cmds.append(("BITOP", "XOR", f"bits{tag}{{t{t}}}", f"bits{tag}{{t{t}}}", f"bits2{tag}{{t{t}}}"))
        ops += 2 * C5_BIT_OPS + 2
    return cmds, ops


def _i8(a) -> bytes:
    return np.ascontiguousarray(a, "<i8").tobytes()


def _i4(a) -> bytes:
    return np.ascontiguousarray(a, "<i4").tobytes()


def traced(fn) -> tuple:
    """Run fn() with the tracer armed: (the frames' traces, fn's wall s)."""
    from redisson_tpu_torch.observe import trace as obs

    obs.TRACER.reset()
    prev = obs.set_tracing(True)
    try:
        s = time.perf_counter()
        fn()
        wall = time.perf_counter() - s
        for _ in range(100):  # the writer task closes a trace after its write
            if obs.TRACER.census()["trace_inflight"] == 0:
                break
            time.sleep(0.01)
    finally:
        obs.set_tracing(prev)
    return obs.TRACER.entries(), wall


def stage_ms(traces) -> dict:
    """Summed ms by stage over `traces` (member child spans excluded)."""
    out: dict = {}
    for tr in traces:
        for stage, us in tr.stage_totals().items():
            out[stage] = out.get(stage, 0.0) + us / 1e3
    return out


def verb_ms(server, fn) -> dict:
    """Handler ms and calls by verb while fn() runs (the server's
    command.<verb> timers, which every dispatch records)."""
    def snap():
        with server.metrics._lock:
            return {k: (t.count, t.total_s) for k, t in server.metrics._timers.items() if k.startswith("command.")}

    before = snap()
    fn()
    after = snap()
    return {k[len("command."):]: {"calls": c - before.get(k, (0, 0.0))[0],
                                  "ms": (t - before.get(k, (0, 0.0))[1]) * 1e3}
            for k, (c, t) in after.items() if c != before.get(k, (0, 0.0))[0]}


def server_config2(conn, engine, rng) -> dict:
    import redisson_tpu_torch

    if conn.execute("BFA.RESERVE", "srv:c2", C2_TENANTS, C2_PER_TENANT, FPP) != b"OK":
        raise AssertionError("server config2: BFA.RESERVE")
    rec = engine.store.get("srv:c2")
    embedded = redisson_tpu_torch.create(device="cpu")
    embedded.get_bloom_filter_array("c2").try_init(C2_TENANTS, C2_PER_TENANT, FPP)
    want = embedded.engine.store.get("c2")
    shape, want_shape = tuple(rec.arrays["bits"].shape), tuple(want.arrays["bits"].shape)
    if shape != want_shape or rec.meta["k"] != want.meta["k"] or (
            C2_TENANTS * C2_PER_TENANT == 10_000_000 and (shape, rec.meta["k"]) != ((C2_TENANTS, C2_LANES), C2_K)):
        raise AssertionError(f"server config2: bank {tuple(rec.arrays['bits'].shape)} k {rec.meta['k']}, "
                             f"not the embedded {tuple(want.arrays['bits'].shape)} k {want.meta['k']}")
    embedded.shutdown()
    frames = []
    for start in range(0, C2_TENANTS * C2_PER_TENANT, SRV_C2_FRAME):
        keys = np.arange(start, start + SRV_C2_FRAME, dtype=np.int64) * 2654435761
        frames.append(("BFA.MADD64", "srv:c2", _i4((keys * 40503) % C2_TENANTS), _i8(keys)))
    s = time.perf_counter()
    newly = 0
    for i in range(0, len(frames), 10):  # ten frames in flight at a time
        pending = [conn.execute_many_lazy([f]) for f in frames[i:i + 10]]
        for p in pending:
            newly += int(np.frombuffer(p.get()[0], np.uint8).sum())
    populate_s = time.perf_counter() - s
    flushes = [config2_flush(rng) for _ in range(SRV_C2_PROBES)]
    conn.execute("BFA.MEXISTS64", "srv:c2", _i4(flushes[0][0]), _i8(flushes[0][1]))  # warm
    lat, fps = [], []
    for t, ks in flushes:
        s = time.perf_counter()
        reply = conn.execute("BFA.MEXISTS64", "srv:c2", _i4(t), _i8(ks))
        lat.append(time.perf_counter() - s)
        found = np.frombuffer(reply, np.uint8)
        if found.size != C2_FLUSH or not found[0::2].all():
            raise AssertionError("server config2: false negatives")
        fps.append(found[1::2].mean())
    fp = float(np.mean(fps))
    fp_band(fp, "server config2")
    window = [("BFA.MEXISTS64", "srv:c2", _i4(t), _i8(ks)) for t, ks in flushes[:10]]
    s = time.perf_counter()
    pending = [conn.execute_many_lazy([window[i % len(window)]]) for i in range(SRV_C2_WINDOW)]
    for i, p in enumerate(pending):
        if not np.frombuffer(p.get()[0], np.uint8)[0::2].all():
            raise AssertionError("server config2: false negatives in the window")
    window_s = time.perf_counter() - s
    out = {"populate_keys": C2_TENANTS * C2_PER_TENANT, "populate_frames": len(frames),
           "populate_s": populate_s, "populate_newly": newly, "frame_ops": C2_FLUSH,
           "frame_p50_ms": pctl(lat, 50) * 1e3, "frame_p99_ms": pctl(lat, 99) * 1e3,
           "absent_probes": len(flushes) * C2_FLUSH // 2, "false_positive_rate": fp,
           "window_frames": SRV_C2_WINDOW, "window_contains_per_s": SRV_C2_WINDOW * C2_FLUSH / window_s}
    log(f"server config2: BFA.RESERVE {shape[0]} x {shape[1]} lanes k {rec.meta['k']} (the embedded bank's), "
        f"populate {out['populate_keys']} keys in {len(frames)} BFA.MADD64 frames {populate_s:.3f}s ({newly} newly); "
        f"{len(flushes)} BFA.MEXISTS64 frames of {C2_FLUSH}: round trip p50 {out['frame_p50_ms']:.3f} ms "
        f"p99 {out['frame_p99_ms']:.3f} ms, fp {fp:.5f} over {out['absent_probes']} absent keys, 0 false "
        f"negatives; pipelined window of {SRV_C2_WINDOW} frames {out['window_contains_per_s'] / 1e6:.1f}M contains/s")
    conn.execute("DEL", "srv:c2")
    return out


def server_config5(conn, server) -> dict:
    from redisson_tpu_torch.core import kernels as K

    rng = np.random.default_rng(17)
    bloom = ("bloom_probe", "bloom_set", "bloom_add")
    blob_cmds = 2 * C5_TENANTS
    reps = []
    for rep in range(SRV_C5_REPS + 1):  # the first rep warms
        cmds, ops = server_config5_cmds(rng, "w" if rep == 0 else f"r{rep}")
        torch.cuda.synchronize()
        before = dict(K.launches)
        s = time.perf_counter()
        replies = conn.execute_many(cmds)
        wall = time.perf_counter() - s
        launched = {k: K.launches[k] - before[k] for k in bloom}
        for t, r in enumerate(replies[2 * C5_TENANTS: 3 * C5_TENANTS]):
            if not np.frombuffer(r, np.uint8).all():
                raise AssertionError(f"server config5: false negatives t{t}")
        if any(isinstance(r, Exception) for r in replies):
            raise AssertionError(f"server config5: error replies {[r for r in replies if isinstance(r, Exception)][:3]}")
        if sum(launched.values()) >= blob_cmds:
            raise AssertionError(f"server config5: {launched} bloom launches for {blob_cmds} BF blob commands: "
                                 "the runs did not coalesce")
        if rep:
            reps.append({"wall_s": wall, "ops_per_s": ops / wall, "bloom_launches": launched})
    # one more rep, traced: where the rep's time goes, by stage over its
    # frames and by verb (handler time)
    cmds, _ = server_config5_cmds(rng, "traced")
    by_verb = {}
    traces, wall = traced(lambda: by_verb.update(verb_ms(server, lambda: conn.execute_many(cmds))))
    out = {"ops_per_rep": ops, "reps": reps, "ops_per_s": [r["ops_per_s"] for r in reps],
           "traced_rep": {"wall_ms": wall * 1e3, "frames": len(traces), "stage_ms": stage_ms(traces),
                          "verb_ms": by_verb}}
    log(f"server config5: {SRV_C5_REPS} reps of {len(cmds)} commands ({ops} ops, bench.py's count), one warm rep "
        f"first: {', '.join(f'{r:.3e}' for r in out['ops_per_s'])} ops/s; every probe found; bloom launches a rep "
        f"{reps[-1]['bloom_launches']} for {blob_cmds} BF blob commands (the runs coalesced)")
    log(f"server config5, a traced rep ({wall * 1e3:.1f} ms, {len(traces)} frames): by stage "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(out["traced_rep"]["stage_ms"].items(), key=lambda kv: -kv[1]))
        + " ms; handler time by verb " + ", ".join(f"{k} {v['ms']:.1f} ms / {v['calls']}"
                                                   for k, v in sorted(by_verb.items(), key=lambda kv: -kv[1]["ms"])))
    return out


def server_config3(conn, rng) -> dict:
    if conn.execute("HLLA.RESERVE", "srv:c3", C3_TENANTS) != 1:
        raise AssertionError("server config3: HLLA.RESERVE")
    frames = [("HLLA.MADD64", "srv:c3", _i4(rng.integers(0, C3_TENANTS, C3_BATCH)),
               _i8(rng.integers(0, 1 << 60, C3_BATCH))) for _ in range(C3_BATCHES)]
    add_s = []
    for f in frames:
        s = time.perf_counter()
        if conn.execute(*f) != b"OK":
            raise AssertionError("server config3: HLLA.MADD64")
        add_s.append(time.perf_counter() - s)
    dst = np.arange(0, C3_TENANTS, 2, dtype=np.int32)
    s = time.perf_counter()
    conn.execute("HLLA.MERGEROWS", "srv:c3", _i4(dst), _i4(dst + 1))
    merge_s = time.perf_counter() - s
    s = time.perf_counter()
    ests = np.frombuffer(conn.execute("HLLA.ESTIMATE", "srv:c3"), "<f8")
    est_s = time.perf_counter() - s
    expected = C3_BATCH * C3_BATCHES / C3_TENANTS
    even, odd = float(ests[0::2].mean()), float(ests[1::2].mean())
    if ests.size != C3_TENANTS or not (0.95 * 2 * expected < even < 1.05 * 2 * expected
                                       and 0.95 * expected < odd < 1.05 * expected):
        raise AssertionError(f"server config3: estimates off: {ests.size} rows, means {even} / {odd}")
    traces, wall = traced(lambda: conn.execute(*frames[0]))
    out = {"add_frames": len(frames), "frame_ops": C3_BATCH, "add_frame_ms": [x * 1e3 for x in add_s],
           "traced_frame": {"wall_ms": wall * 1e3, "stage_ms": stage_ms(traces)},
           "add_ops_per_s": C3_BATCH * len(frames) / sum(add_s), "merge_pairs": len(dst),
           "merge_ms": merge_s * 1e3, "estimate_ms": est_s * 1e3}
    log(f"server config3: HLLA.RESERVE {C3_TENANTS}; {len(frames)} HLLA.MADD64 frames of {C3_BATCH}: p50 "
        f"{pctl(add_s, 50) * 1e3:.3f} ms a frame ({out['add_ops_per_s'] / 1e6:.1f}M adds/s); HLLA.MERGEROWS of "
        f"{len(dst)} pairs {out['merge_ms']:.3f} ms; HLLA.ESTIMATE {out['estimate_ms']:.3f} ms (mean "
        f"{odd:.1f}, merged rows {even:.1f}); one HLLA.MADD64 frame traced ({wall * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["traced_frame"]["stage_ms"].items()) + " ms")
    conn.execute("DEL", "srv:c3")
    return out


def server_frame_spans(conn, rng, kernel_ms: float, device) -> dict:
    """One BFA.MEXISTS64 frame of 100,000 keys with the tracer armed: its
    spans (parse, qos, dispatch, the kernel launch, readback, encode,
    reply), beside the kernel's device time from the kernel table.  The
    parse span runs from the frame's first read to its last: it holds the
    wait for the rest of the 1.2 MB command."""
    conn.execute("BFA.RESERVE", "srv:span", C2_TENANTS, C2_PER_TENANT, FPP)
    t, ks = config2_flush(rng)
    frame = ("BFA.MEXISTS64", "srv:span", _i4(t), _i8(ks))
    conn.execute(*frame)  # warm
    traces, wall = traced(lambda: conn.execute(*frame))
    wall_ms = wall * 1e3
    trace = traces[-1]
    spans = [{"name": sp.name, "off_ms": sp.off_us / 1e3, "ms": sp.dur_us / 1e3, **(sp.attrs or {})}
             for sp in trace.spans]
    names = {sp["name"] for sp in spans}
    want = {"parse", "dispatch", "readback", "encode", "reply"} | ({"launch"} if device != "cpu" else set())
    if not want <= names:
        raise AssertionError(f"server spans: {sorted(names)}")
    out = {"verb": trace.verbs, "keys": C2_FLUSH, "total_ms": trace.total_us / 1e3, "client_wall_ms": wall_ms,
           "spans": spans, "kernel_device_ms": kernel_ms}
    log(f"server spans, one BFA.MEXISTS64 frame of {C2_FLUSH} keys (total {out['total_ms']:.3f} ms in the server, "
        f"{wall_ms:.3f} ms at the client; bloom_probe's device time {kernel_ms:.4f} ms from the kernel table): "
        + ", ".join(f"{sp['name']} +{sp['off_ms']:.3f} {sp['ms']:.3f} ms" for sp in spans))
    conn.execute("DEL", "srv:span")
    return out


def server_card_against_cpu(device) -> dict:
    """The mixed stream of every served verb (tools/wire_stream.py), RESP2
    then RESP3, on a card server and on a CPU server: the same replies,
    PFCOUNT and the HLLA estimates within their contract."""
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    stream = W.mixed_stream(seed=21, scale=SRV_MIXED_SCALE, estimates=True)
    waves = [stream, [("HELLO", "3")] + stream]
    out = {}
    for where in (device, "cpu"):
        with ServerThread(port=0, device=where) as st:
            out[where != "cpu"] = W.replies(st.server.host, st.server.port, waves)
    same_bytes = 0
    for wave, (craw, card), (wraw, cpu) in zip(waves, out[device != "cpu"], out[False]):
        bad = W.compare(wave, card, cpu)
        if bad:
            raise AssertionError(f"server card vs CPU: {len(bad)} replies differ: {bad[:3]}")
        same_bytes += craw == wraw
    verbs = sorted({str(c[0]) for c in stream})
    log(f"server card vs CPU: {len(stream)} commands ({len(verbs)} verbs) twice, RESP2 then RESP3: replies equal "
        f"(PFCOUNT and the HLLA estimates within their contract; raw bytes equal in {same_bytes} of 2 waves)")
    return {"commands": 2 * len(stream) + 1, "verbs": len(verbs), "waves_bytes_equal": same_bytes}



# the collections leg of the server phase (server_collections): the
# collections stream card against CPU, a leaderboard, a job queue and
# config 5's stream with collections
SRV_COLL_SEED, SRV_COLL_SCALE = 23, 2
SRV_LB_MEMBERS, SRV_LB_BATCH, SRV_LB_FRAME = 250_000, 1_000, 10
SRV_LB_READS, SRV_LB_INCRS, SRV_LB_INCR_FRAME = 1_000, 10_000, 1_000
# the job queue is cut from 20,000 ids: on the H100's host 20,000 took 15.7 s
# of a 26.8 s leg and 5,000 took 7.4 s of 22.0 (PERF.md section 5); the leg
# aims at ~15 s
SRV_JOBS, SRV_JOBS_DESIGN, SRV_JOB_BATCH, SRV_JOB_CONNS = 2_500, 20_000, 50, 4
SRV_C5C_REPS = 1


def verb_line(by_verb: dict, top: int = 8) -> str:
    return ", ".join(f"{k} {v['ms']:.1f} ms / {v['calls']}"
                     for k, v in sorted(by_verb.items(), key=lambda kv: -kv[1]["ms"])[:top])


def collections_card_against_cpu(st, card: str) -> dict:
    """tools/wire_stream.collections_stream, RESP2 then RESP3, on the card
    server and on a CPU server of the port: equal under compare, and every
    reply outside the unordered and random verbs equal byte for byte."""
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    stream = W.collections_stream(seed=SRV_COLL_SEED, scale=SRV_COLL_SCALE)
    waves = [stream, [("HELLO", "3")] + stream]
    got = {}
    by_verb = verb_ms(st.server, lambda: got.update(card=W.replies(st.server.host, st.server.port, waves)))
    with ServerThread(port=0, device="cpu") as cpu:
        want = W.replies(cpu.server.host, cpu.server.port, waves)
    loose = W.UNORDERED_VERBS | W.RANDOM_VERBS
    bytes_equal = 0
    for wave, (craw, c), (wraw, w) in zip(waves, got["card"], want):
        cs, ws = W.reply_spans(craw), W.reply_spans(wraw)
        if wave[0][0] == "HELLO":  # its reply holds the connection's id, which differs
            if c[0][b"proto"] != 3 or w[0][b"proto"] != 3:
                raise AssertionError("collections card vs CPU: HELLO 3")
            wave, c, w, cs, ws = wave[1:], c[1:], w[1:], cs[1:], ws[1:]
        bad = W.compare(wave, c, w)
        bad += [f"#{i} {wave[i][0]} bytes" for i in range(len(wave))
                if W._verb(wave[i]) not in loose and cs[i] != ws[i]]
        if bad:
            raise AssertionError(f"collections card vs CPU: {len(bad)} replies differ: {bad[:3]}")
        bytes_equal += sum(a == b for a, b in zip(cs, ws))
    verbs = {W._verb(c) for c in stream}
    log(f"collections stream [{card}]: {len(stream)} commands ({len(verbs)} verbs, scale {SRV_COLL_SCALE}) twice, "
        f"RESP2 then RESP3, card server against a CPU server: equal ({bytes_equal} of {2 * len(stream)} replies "
        f"byte for byte, the rest unordered or random under compare's contracts); handler time by verb "
        + verb_line(by_verb))
    return {"commands": 2 * len(stream), "verbs": len(verbs), "bytes_equal": bytes_equal, "verb_ms": by_verb}


def collections_leaderboard(conn, server, card: str) -> dict:
    """A leaderboard: ZADD of SRV_LB_BATCH pairs a command up to
    SRV_LB_MEMBERS members; ZREVRANGE 0 99 WITHSCORES against a host sort;
    SRV_LB_READS ZREVRANK and ZSCORE reads with no write between them;
    SRV_LB_INCRS ZINCRBY in frames; ZREVRANGE again.  The index is rebuilt
    once after each run of writes (the first read times it)."""
    from redisson_tpu_torch.server.verbs.common import _fnum

    rng = np.random.default_rng(29)
    n = SRV_LB_MEMBERS
    members = [f"player:{i}" for i in range(n)]
    scores = np.round(rng.gamma(2.0, 500.0, n), 2).tolist()
    host = dict(zip(members, scores))
    cmds = [("ZADD", "lb", *[x for i in range(s, min(n, s + SRV_LB_BATCH)) for x in (repr(scores[i]), members[i])])
            for s in range(0, n, SRV_LB_BATCH)]
    by_verb = {}

    def top100():
        want = sorted(host.items(), key=lambda kv: (kv[1], kv[0].encode()), reverse=True)[:100]
        return [x for m, sc in want for x in (m.encode(), _fnum(sc))]

    def write_phase():
        s = time.perf_counter()
        for i in range(0, len(cmds), SRV_LB_FRAME):
            if conn.execute_many(cmds[i:i + SRV_LB_FRAME]) != [SRV_LB_BATCH] * len(cmds[i:i + SRV_LB_FRAME]):
                raise AssertionError("leaderboard: ZADD replies")
        return time.perf_counter() - s

    out = {"members": n}
    by_verb.update(verb_ms(server, lambda: out.update(zadd_s=write_phase())))
    s = time.perf_counter()
    if conn.execute("ZREVRANGE", "lb", 0, 99, "WITHSCORES") != top100():
        raise AssertionError("leaderboard: ZREVRANGE 0 99 differs from the host sort")
    out["first_zrevrange_ms"] = (time.perf_counter() - s) * 1e3
    order = sorted(host, key=lambda m: (host[m], m.encode()), reverse=True)
    rank = {m: i for i, m in enumerate(order)}
    picks = [members[int(i)] for i in rng.integers(0, n, SRV_LB_READS)]
    lat = {"ZREVRANK": [], "ZSCORE": []}

    def reads():
        for m in picks:
            t = time.perf_counter()
            r = conn.execute("ZREVRANK", "lb", m)
            lat["ZREVRANK"].append(time.perf_counter() - t)
            t = time.perf_counter()
            sc = conn.execute("ZSCORE", "lb", m)
            lat["ZSCORE"].append(time.perf_counter() - t)
            if r != rank[m] or float(sc) != host[m]:
                raise AssertionError(f"leaderboard: {m} rank {r} score {sc!r}, not {rank[m]} {host[m]!r}")

    by_verb.update(verb_ms(server, reads))
    incr = [(members[int(i)], repr(float(d))) for i, d in
            zip(rng.integers(0, n, SRV_LB_INCRS), np.round(rng.normal(0, 100, SRV_LB_INCRS), 2))]

    def increments():
        s = time.perf_counter()
        for f in range(0, len(incr), SRV_LB_INCR_FRAME):
            frame = incr[f:f + SRV_LB_INCR_FRAME]
            replies = conn.execute_many([("ZINCRBY", "lb", d, m) for m, d in frame])
            for (m, d), r in zip(frame, replies):
                host[m] = host[m] + float(d)
                if float(r) != host[m]:
                    raise AssertionError(f"leaderboard: ZINCRBY {m} replied {r!r}, not {host[m]!r}")
        return time.perf_counter() - s

    by_verb.update({f"{k} (increments)": v for k, v in
                    verb_ms(server, lambda: out.update(zincrby_s=increments())).items()})
    s = time.perf_counter()
    conn.execute("ZREVRANK", "lb", members[0])  # the first read after the writes rebuilds the index
    out["rebuild_read_ms"] = (time.perf_counter() - s) * 1e3
    if conn.execute("ZREVRANGE", "lb", 0, 99, "WITHSCORES") != top100():
        raise AssertionError("leaderboard: ZREVRANGE 0 99 after the ZINCRBYs differs from the host sort")
    for verb, xs in lat.items():
        out[verb] = {"reads": len(xs), "p50_ms": pctl(xs, 50) * 1e3, "p99_ms": pctl(xs, 99) * 1e3}
    out["verb_ms"] = by_verb
    log(f"collections leaderboard [{card}]: {n} members by {len(cmds)} ZADD of {SRV_LB_BATCH} pairs in "
        f"{out['zadd_s']:.3f}s ({n / out['zadd_s']:.0f} pairs/s); ZREVRANGE 0 99 WITHSCORES equal to the host sort, "
        f"first read after the writes {out['first_zrevrange_ms']:.1f} ms (the index rebuilt); {SRV_LB_READS} "
        f"ZREVRANK p50 {out['ZREVRANK']['p50_ms']:.3f} p99 {out['ZREVRANK']['p99_ms']:.3f} ms, ZSCORE p50 "
        f"{out['ZSCORE']['p50_ms']:.3f} p99 {out['ZSCORE']['p99_ms']:.3f} ms, every one right; {SRV_LB_INCRS} "
        f"ZINCRBY in frames of {SRV_LB_INCR_FRAME} {out['zincrby_s']:.3f}s; the next ZREVRANK (rebuild) "
        f"{out['rebuild_read_ms']:.1f} ms; ZREVRANGE again equal; handler time by verb " + verb_line(by_verb))
    conn.execute("DEL", "lb")
    return out


def collections_job_queue(st, card: str) -> dict:
    """A job queue: SRV_JOB_CONNS producer connections RPUSH SRV_JOBS ids in
    commands of SRV_JOB_BATCH; SRV_JOB_CONNS consumer connections take them
    with BLPOP 1 until the queue stays empty; every id exactly once.  A
    further connection PINGs all along, while the consumers park."""
    import threading

    from redisson_tpu_torch.net.client import Connection

    host, port = st.server.host, st.server.port
    taken = [[] for _ in range(SRV_JOB_CONNS)]
    errors, pings, done = [], [], threading.Event()

    def consume(k):
        c = Connection(host, port, timeout=60.0)
        try:
            while True:
                r = c.execute("BLPOP", "jobs", "1")
                if r is None:
                    return
                taken[k].append(int(r[1]))
        except Exception as e:  # noqa: BLE001 — reported below, the run fails
            errors.append(e)
        finally:
            c.close()

    def produce(k):
        c = Connection(host, port, timeout=60.0)
        try:
            mine = list(range(k, SRV_JOBS, SRV_JOB_CONNS))
            for i in range(0, len(mine), SRV_JOB_BATCH):
                c.execute("RPUSH", "jobs", *mine[i:i + SRV_JOB_BATCH])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            c.close()

    def ping():
        c = Connection(host, port, timeout=60.0)
        try:
            while not done.is_set():
                t = time.perf_counter()
                if c.execute("PING") != b"PONG":
                    errors.append(AssertionError("PING"))
                pings.append(time.perf_counter() - t)
                time.sleep(0.002)
        finally:
            c.close()

    def run():
        consumers = [threading.Thread(target=consume, args=(k,)) for k in range(SRV_JOB_CONNS)]
        pinger = threading.Thread(target=ping)
        for t in consumers + [pinger]:
            t.start()
        time.sleep(0.1)  # the consumers park before any job arrives
        s = time.perf_counter()
        producers = [threading.Thread(target=produce, args=(k,)) for k in range(SRV_JOB_CONNS)]
        for t in producers:
            t.start()
        for t in producers + consumers:
            t.join(120)
        wall = time.perf_counter() - s
        done.set()
        pinger.join(10)
        if any(t.is_alive() for t in producers + consumers + [pinger]):
            raise AssertionError("job queue: a connection did not finish")
        return wall

    out = {}
    by_verb = verb_ms(st.server, lambda: out.update(wall_s=run()))
    if errors:
        raise AssertionError(f"job queue: {errors[:3]}")
    got = sorted(x for t in taken for x in t)
    if got != list(range(SRV_JOBS)):
        raise AssertionError(f"job queue: {len(got)} jobs taken, {len(set(got))} distinct, of {SRV_JOBS}")
    out.update(jobs=SRV_JOBS, per_consumer=[len(t) for t in taken], pings=len(pings),
               ping_p50_ms=pctl(pings, 50) * 1e3, ping_p99_ms=pctl(pings, 99) * 1e3,
               ping_max_ms=max(pings) * 1e3, verb_ms=by_verb)
    log(f"collections job queue [{card}]: {SRV_JOB_CONNS} producers RPUSH {SRV_JOBS} ids (cut from "
        f"{SRV_JOBS_DESIGN} to keep the leg near 15 s) in commands of "
        f"{SRV_JOB_BATCH}, {SRV_JOB_CONNS} consumers BLPOP 1 until empty: every id taken once "
        f"({out['per_consumer']} a consumer), {out['wall_s']:.3f}s from the first push to the last consumer's "
        f"timeout (1 s of it the last BLPOP's wait); a fifth connection's PING while they park: {len(pings)} "
        f"p50 {out['ping_p50_ms']:.3f} p99 {out['ping_p99_ms']:.3f} max {out['ping_max_ms']:.3f} ms; "
        f"handler time by verb " + verb_line(by_verb))
    return out


def server_config5_collection_cmds(rng, tag: str):
    """Config 5's stream (server_config5_cmds) with one SADD, one LPUSH and
    one ZADD a tenant after the tenant's bloom commands (ahead of its bit-set
    commands: the BF blob runs stay whole)."""
    cmds, ops = server_config5_cmds(rng, tag)
    t = C5_TENANTS
    assert len(cmds) == 3 * t + 4 * t
    out = cmds[:3 * t]
    for k in range(t):
        out += [("SADD", f"set{tag}{{t{k}}}", f"m{k}"), ("LPUSH", f"list{tag}{{t{k}}}", f"j{k}"),
                ("ZADD", f"zset{tag}{{t{k}}}", k, f"m{k}")]
        out += cmds[3 * t + 4 * k: 3 * t + 4 * k + 4]
    return out, ops + 3 * t


def collections_config5(conn, server, card: str) -> dict:
    from redisson_tpu_torch.core import kernels as K

    rng = np.random.default_rng(37)
    bloom = ("bloom_probe", "bloom_set", "bloom_add")
    reps, by_verb = [], {}
    for rep in range(SRV_C5C_REPS + 1):  # the first rep warms
        cmds, ops = server_config5_collection_cmds(rng, f"cw{rep}")
        torch.cuda.synchronize()
        before = dict(K.launches)
        got = {}
        s = time.perf_counter()
        counted = verb_ms(server, lambda: got.update(replies=conn.execute_many(cmds)))
        wall = time.perf_counter() - s
        replies = got["replies"]
        launched = {k: K.launches[k] - before[k] for k in bloom}
        if any(isinstance(r, Exception) for r in replies):
            raise AssertionError(f"config5 with collections: error replies {[r for r in replies if isinstance(r, Exception)][:3]}")
        coll = [r for c, r in zip(cmds, replies) if c[0] in ("SADD", "LPUSH", "ZADD")]
        if coll != [1] * (3 * C5_TENANTS):
            raise AssertionError(f"config5 with collections: SADD/LPUSH/ZADD replies {coll[:6]}")
        for t, r in enumerate(replies[2 * C5_TENANTS: 3 * C5_TENANTS]):
            if not np.frombuffer(r, np.uint8).all():
                raise AssertionError(f"config5 with collections: false negatives t{t}")
        if sum(launched.values()) >= 2 * C5_TENANTS:
            raise AssertionError(f"config5 with collections: {launched} bloom launches for {2 * C5_TENANTS} BF blob "
                                 "commands: the runs did not coalesce")
        if rep:
            reps.append({"wall_s": wall, "ops_per_s": ops / wall, "bloom_launches": launched})
            for k, v in counted.items():
                acc = by_verb.setdefault(k, {"calls": 0, "ms": 0.0})
                acc["calls"] += v["calls"]
                acc["ms"] += v["ms"]
    log(f"collections config5 [{card}]: config 5's stream with a SADD, an LPUSH and a ZADD a tenant ({len(cmds)} "
        f"commands, {ops} ops), {SRV_C5C_REPS} reps after a warm one: "
        + ", ".join(f"{r['ops_per_s']:.3e}" for r in reps) + f" ops/s; bloom launches a rep {reps[-1]['bloom_launches']} "
        f"for {2 * C5_TENANTS} BF blob commands (the runs still coalesce); handler time by verb " + verb_line(by_verb))
    return {"commands": len(cmds), "ops_per_rep": ops, "reps": reps, "verb_ms": by_verb}


def server_collections(conn, st, card: str) -> dict:
    """The collections leg of the server phase, on the card server."""
    start = time.perf_counter()
    out, parts = {}, {}
    for name, run in (("stream", lambda: collections_card_against_cpu(st, card)),
                      ("leaderboard", lambda: collections_leaderboard(conn, st.server, card)),
                      ("job_queue", lambda: collections_job_queue(st, card)),
                      ("config5", lambda: collections_config5(conn, st.server, card))):
        s = time.perf_counter()
        out[name] = run()
        parts[name] = time.perf_counter() - s
    out["seconds"], out["part_seconds"] = time.perf_counter() - start, parts
    log(f"collections leg [{card}]: {out['seconds']:.1f}s ("
        + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    return out


def run_server(kernels: dict, device="cuda") -> dict:
    """The server phase: redisson_tpu_torch.server.ServerThread on the card,
    driven with the port's net.client.Connection."""
    from redisson_tpu_torch.net import _native
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server import ServerThread

    start = time.perf_counter()
    lib = _native.load()
    codec = "native" if lib is not None else "python"
    log(f"server: RESP codec {codec}" + (f" ({os.path.basename(lib._name)})" if lib is not None else ""))
    rng = np.random.default_rng(31)
    out = {"codec": codec}
    with ServerThread(port=0, device=device) as st:
        if st.server.engine.device.type != torch.device(device).type:
            raise AssertionError(f"the server did not land on {device}")
        conn = Connection(st.server.host, st.server.port, timeout=600.0)
        try:
            out["config2"] = server_config2(conn, st.server.engine, rng)
            out["config5"] = server_config5(conn, st.server)
            out["config3"] = server_config3(conn, rng)
            out["frame"] = server_frame_spans(conn, rng, kernels["bloom_probe"]["ms"], device)
            out["collections"] = server_collections(conn, st, card_line())
        finally:
            conn.close()
    out["card_vs_cpu"] = server_card_against_cpu(device)
    out["seconds"] = time.perf_counter() - start
    log(f"server phase: {out['seconds']:.1f}s")
    return out



# the remote path (run_remote): the port's RemoteRedisson and
# AsyncRemoteRedisson against a port ServerThread on the card.  Config 2A
# (bench.py:737): the config-2 bank, 1M keys added in 100,000-key add_each
# frames, 12 contains flushes of 100,000 keys sync, then gathered on one
# async connection (the reference's aim: async within 10% of sync)
RM_C2_INGEST, RM_C2_FRAME, RM_C2_FLUSHES, RM_ASYNC_AIM = 1_000_000, 100_000, 12, 0.9
# config 6 (bench.py:804): 8 clients, zipf 1.0 reads over 512 buckets at
# 99% reads, tracking off then on; cut from 4,000 and 20,000 ops a client
RM_C6_CLIENTS, RM_C6_KEYS, RM_C6_READS, RM_C6_ZIPF = 8, 512, 0.99, 1.0
RM_C6_OPS, RM_C6_DESIGN_OPS = (500, 2_500), (4_000, 20_000)
# a RemoteBatch of config2_batch's shape, and the stream held card against CPU
RM_BATCH_OPS, RM_BATCH_KEYS, RM_STREAM_SEED = 1000, 100, 29
# config 6's workload through RemoteLocalCachedMap: the same 8 clients, zipf
# and read share over the 512 entries of one map, sync INVALIDATE then
# TRACKING; each client writes only its own entries (key % 8 == client), so
# the final values do not depend on the interleaving; cut from 20,000 ops a
# client
RM_LC_OPS, RM_LC_DESIGN_OPS, RM_LC_SEED = 2_500, 20_000, 19


def remote_config2(c, address: str, card: str, rng) -> dict:
    """Config 2A through the typed bank handles, sync then async."""
    import asyncio

    from redisson_tpu_torch.client.aio import AsyncRemoteRedisson

    bank = c.get_bloom_filter_array("rm:c2")
    if not bank.try_init(C2_TENANTS, C2_PER_TENANT, FPP):
        raise AssertionError("remote config2: BFA.RESERVE")
    keys = np.arange(RM_C2_INGEST, dtype=np.int64) * 2654435761
    tenants = ((keys * 40503) % C2_TENANTS).astype(np.int32)
    s = time.perf_counter()
    newly = sum(int(bank.add_each(tenants[i:i + RM_C2_FRAME], keys[i:i + RM_C2_FRAME]).sum())
                for i in range(0, RM_C2_INGEST, RM_C2_FRAME))
    populate_s = time.perf_counter() - s
    flushes = []
    for _ in range(RM_C2_FLUSHES):  # config2_flush's shape over the 1M keys added
        present = keys[rng.integers(0, RM_C2_INGEST, C2_FLUSH)]
        absent = rng.integers(1 << 50, 1 << 60, C2_FLUSH).astype(np.int64)
        ks = np.where(np.arange(C2_FLUSH) % 2 == 0, present, absent)
        flushes.append((((ks * 40503) % C2_TENANTS).astype(np.int32), ks))
    bank.contains(*flushes[0])  # warm
    s = time.perf_counter()
    sync = [bank.contains(t, k) for t, k in flushes]
    sync_s = time.perf_counter() - s
    for f in sync:
        if f.size != C2_FLUSH or not f[0::2].all():
            raise AssertionError("remote config2: false negatives")
    # 1M keys in a bank sized for 10M: the rate sits far below the design's
    fp = float(np.mean([f[1::2].mean() for f in sync]))
    if fp > 2 * FPP:
        raise AssertionError(f"remote config2: false-positive rate {fp:.5f} above {2 * FPP}")
    # the typed handle's OBJCALL fallback: contains_flushes on the server's bank
    fallback = bank.contains_flushes(flushes[:2])
    if not all(same(a, b) for a, b in zip(fallback, sync[:2])):
        raise AssertionError("remote config2: the OBJCALL fallback's replies differ from BFA.MEXISTS64's")

    async def gathered():
        client = await AsyncRemoteRedisson.connect(address, timeout=600.0)
        try:
            abank = client.get_bloom_filter_array("rm:c2")
            await abank.contains(*flushes[0])  # warm this connection
            t0 = time.perf_counter()
            outs = await asyncio.gather(*(abank.contains(t, k) for t, k in flushes))
            gather_s = time.perf_counter() - t0
            t0 = time.perf_counter()  # the same flushes awaited one at a time
            for t, k in flushes:
                await abank.contains(t, k)
            return outs, gather_s, time.perf_counter() - t0
        finally:
            await client.aclose()

    outs, async_s, one_s = asyncio.run(gathered())
    if not all(same(a, b) for a, b in zip(outs, sync)):
        raise AssertionError("remote config2: the async replies differ from the sync ones")
    n = RM_C2_FLUSHES * C2_FLUSH
    out = {"populate_keys": RM_C2_INGEST, "populate_frames": RM_C2_INGEST // RM_C2_FRAME, "populate_s": populate_s,
           "populate_newly": newly, "flushes": RM_C2_FLUSHES, "flush_ops": C2_FLUSH, "false_positive_rate": fp,
           "sync_contains_per_s": n / sync_s, "async_contains_per_s": n / async_s,
           "async_one_at_a_time_contains_per_s": n / one_s}
    out["async_over_sync"] = out["async_contains_per_s"] / out["sync_contains_per_s"]
    met = "met" if out["async_over_sync"] >= RM_ASYNC_AIM else "NOT MET"
    log(f"remote config2 [{card}]: RemoteBloomFilterArray {C2_TENANTS} x {C2_PER_TENANT} at {FPP}, "
        f"{RM_C2_INGEST} keys in {out['populate_frames']} add_each frames {populate_s:.3f}s ({newly} newly); "
        f"{RM_C2_FLUSHES} contains flushes of {C2_FLUSH}: sync {out['sync_contains_per_s'] / 1e6:.2f}M contains/s, "
        f"async (gathered on one connection) {out['async_contains_per_s'] / 1e6:.2f}M contains/s, async/sync "
        f"{out['async_over_sync']:.3f} (the reference's aim, within 10% of sync: {met}), awaited one at a time "
        f"{out['async_one_at_a_time_contains_per_s'] / 1e6:.2f}M contains/s; fp {fp:.5f}, "
        "0 false negatives; the OBJCALL fallback (contains_flushes) replies the same")
    c.execute("DEL", "rm:c2")
    return out


def remote_config3(c, card: str, rng) -> dict:
    """Config 3 through RemoteHyperLogLogArray: 10,000 counters."""
    hlla = c.get_hyper_log_log_array("rm:c3")
    if not hlla.try_init(C3_TENANTS):
        raise AssertionError("remote config3: HLLA.RESERVE")
    add_s = []
    for _ in range(C3_BATCHES):
        t, k = rng.integers(0, C3_TENANTS, C3_BATCH), rng.integers(0, 1 << 60, C3_BATCH)
        s = time.perf_counter()
        hlla.add(t, k)
        add_s.append(time.perf_counter() - s)
    dst = np.arange(0, C3_TENANTS, 2, dtype=np.int32)
    hlla.merge_rows(dst, dst + 1)
    s = time.perf_counter()
    ests = hlla.estimate_all()
    est_ms = (time.perf_counter() - s) * 1e3
    pairs = hlla.estimate_union_pairs(dst[:100], dst[:100] + 1)
    if not np.allclose(pairs, ests[dst[:100]], rtol=1e-6):  # a merged row is its pair's union
        raise AssertionError("remote config3: estimate_union_pairs differs from the merged rows")
    expected = C3_BATCH * C3_BATCHES / C3_TENANTS
    even, odd = float(ests[0::2].mean()), float(ests[1::2].mean())
    if ests.size != C3_TENANTS or not (0.95 * 2 * expected < even < 1.05 * 2 * expected
                                       and 0.95 * expected < odd < 1.05 * expected):
        raise AssertionError(f"remote config3: estimates off: {ests.size} rows, means {even} / {odd}")
    out = {"add_frames": C3_BATCHES, "frame_ops": C3_BATCH, "add_ops_per_s": C3_BATCH * C3_BATCHES / sum(add_s),
           "add_frame_p50_ms": pctl(add_s, 50) * 1e3, "estimate_ms": est_ms}
    log(f"remote config3 [{card}]: RemoteHyperLogLogArray of {C3_TENANTS}: {C3_BATCHES} add frames of {C3_BATCH}, "
        f"p50 {out['add_frame_p50_ms']:.3f} ms ({out['add_ops_per_s'] / 1e6:.1f}M adds/s); merge_rows of "
        f"{len(dst)} pairs; estimate_all {est_ms:.3f} ms (mean {odd:.1f}, merged rows {even:.1f})")
    c.execute("DEL", "rm:c3")
    return out


def remote_bitsets(c, address: str, card: str, rng) -> dict:
    """Config 5's bit sets (bench.py:399-428) through the bit-set handles:
    the sync handle's SETBITS and the async one's SETBITSB, GETBITS, then
    BITOP OR and XOR a tenant, each against numpy."""
    import asyncio

    from redisson_tpu_torch.client.aio import AsyncRemoteRedisson

    idx = [[host_indexes(rng, C5_BIT_OPS, 0, C5_BITS) for _ in range(2)] for _ in range(C5_TENANTS)]
    s = time.perf_counter()
    for t in range(C5_TENANTS):
        c.get_bit_set(f"rm:bits:{t}:a").set_each(idx[t][0])

    async def set_b():
        client = await AsyncRemoteRedisson.connect(address, timeout=600.0)
        try:
            await asyncio.gather(*(client.get_bit_set(f"rm:bits:{t}:b").set_each(idx[t][1])
                                   for t in range(C5_TENANTS)))
        finally:
            await client.aclose()

    asyncio.run(set_b())
    for t in range(C5_TENANTS):
        a, b = (set(int(i) for i in x) for x in idx[t])
        ha = c.get_bit_set(f"rm:bits:{t}:a")
        if not ha.get_each(idx[t][1]).tolist() == [int(i) in a for i in idx[t][1]]:
            raise AssertionError(f"remote bit sets: GETBITS t{t}")
        ha.or_(f"rm:bits:{t}:b")
        if ha.cardinality() != len(a | b):
            raise AssertionError(f"remote bit sets: BITOP OR t{t}")
        ha.xor(f"rm:bits:{t}:b")
        if ha.cardinality() != len(a - b):
            raise AssertionError(f"remote bit sets: BITOP XOR t{t}")
    wall = time.perf_counter() - s
    out = {"tenants": C5_TENANTS, "ops_per_set": C5_BIT_OPS, "wall_s": wall}
    log(f"remote bit sets [{card}]: {C5_TENANTS} tenants x 2 sets of {C5_BIT_OPS} indexes below {C5_BITS} "
        f"(SETBITS sync, SETBITSB async), GETBITS, BITOP OR and XOR each against numpy: {wall:.3f}s")
    for t in range(C5_TENANTS):
        c.execute("DEL", f"rm:bits:{t}:a", f"rm:bits:{t}:b")
    return out


def remote_objcall_tx(c, card: str, rng) -> dict:
    """A bloom handle's OBJCALL fallback, a RemoteBatch of 1,000 contains
    ops, a MULTI/EXEC holding BF.MADD64 and BF.MEXISTS64, and a TXEXEC
    commit."""
    bf = c.get_bloom_filter("rm:bf")
    if not bf.try_init(RM_BATCH_OPS * RM_BATCH_KEYS, FPP):
        raise AssertionError("remote objcall: BF.RESERVE")
    keys = rng.integers(0, 1 << 60, RM_BATCH_OPS * RM_BATCH_KEYS).astype(np.int64)
    newly = int(bf.add_each(keys).sum())
    count = bf.count()  # not a typed verb: OBJCALL get_bloom_filter.count
    if not 0.9 * keys.size < count < 1.1 * keys.size:
        raise AssertionError(f"remote objcall: count() {count} for {keys.size} keys")
    b = c.create_batch()
    bb = b.get_bloom_filter("rm:bf")
    probe = np.where(np.arange(keys.size) % 2 == 0, keys, rng.integers(1 << 60, 1 << 62, keys.size))
    for i in range(RM_BATCH_OPS):
        bb.contains_async(probe[i * RM_BATCH_KEYS:(i + 1) * RM_BATCH_KEYS])
    s = time.perf_counter()
    flags = b.execute()
    batch_ms = (time.perf_counter() - s) * 1e3
    found = np.concatenate(flags)
    if len(flags) != RM_BATCH_OPS or not found[0::2].all():
        raise AssertionError("remote objcall: RemoteBatch false negatives")
    more = rng.integers(1 << 62, (1 << 63) - 1, 1000).astype(np.int64)
    conn = c.node.pool.acquire()
    try:
        tx = conn.execute_many([("MULTI",), ("BF.MADD64", "rm:bf", _i8(more)), ("BF.MEXISTS64", "rm:bf", _i8(more)),
                                ("EXEC",)])
    finally:
        c.node.pool.release(conn)
    if tx[:3] != [b"OK", b"QUEUED", b"QUEUED"] or not np.frombuffer(tx[3][1], np.uint8).all():
        raise AssertionError(f"remote objcall: MULTI/EXEC {tx!r:.200}")
    t = c.create_transaction()
    t.get_bucket("rm:tx:b").set(newly)
    t.get_map("rm:tx:m").put("count", count)
    t.commit()
    if c.get_bucket("rm:tx:b").get() != newly or c.get_map("rm:tx:m").get("count") != count:
        raise AssertionError("remote objcall: TXEXEC commit not read back")
    out = {"batch_ops": RM_BATCH_OPS, "batch_keys": RM_BATCH_KEYS, "batch_ms": batch_ms, "newly": newly,
           "count": count}
    log(f"remote objcall [{card}]: BloomFilter add_each of {keys.size} ({newly} newly), count() {count} through "
        f"the OBJCALL fallback; a RemoteBatch of {RM_BATCH_OPS} contains ops of {RM_BATCH_KEYS} keys {batch_ms:.3f} ms "
        "(one BF.MEXISTS64); MULTI/EXEC of BF.MADD64 + BF.MEXISTS64; a TXEXEC commit read back")
    c.execute("DEL", "rm:bf", "rm:tx:b", "rm:tx:m")
    return out


def remote_config6(server, address: str, card: str) -> dict:
    """Config 6's near cache at a cut size: server ops per issued op with
    tracking off and on (bench.py:804's phases, fewer ops a client)."""
    import threading

    from redisson_tpu_torch.client.codec import DEFAULT_CODEC
    from redisson_tpu_torch.client.remote import RemoteRedisson

    rng = np.random.default_rng(17)
    p = 1.0 / np.power(np.arange(1, RM_C6_KEYS + 1), RM_C6_ZIPF)
    p /= p.sum()
    seed = RemoteRedisson(address, timeout=600.0)
    seed.execute_many([("SET", f"c6:{i}", DEFAULT_CODEC.encode(b"v0")) for i in range(RM_C6_KEYS)])
    seed.shutdown()

    def phase(tracked: bool, ops: int) -> dict:
        clients = [RemoteRedisson(address, timeout=600.0) for _ in range(RM_C6_CLIENTS)]
        handles = []
        for cl in clients:
            if tracked:
                plane = cl.enable_tracking(cache_entries=4 * RM_C6_KEYS, noloop=True)
                hs = [plane.get_bucket(f"c6:{i}") for i in range(RM_C6_KEYS)]
                for h in hs:
                    h.get()
                handles.append(hs)
            else:
                handles.append([cl.get_bucket(f"c6:{i}") for i in range(RM_C6_KEYS)])
        streams = [(rng.choice(RM_C6_KEYS, size=ops, p=p), rng.random(ops) >= RM_C6_READS)
                   for _ in range(RM_C6_CLIENTS)]
        start = threading.Barrier(RM_C6_CLIENTS + 1)
        errors = []

        def worker(ci):
            hs, (idx, writes) = handles[ci], streams[ci]
            try:
                start.wait()
                for j in range(ops):
                    if writes[j]:
                        hs[idx[j]].set(b"w%d-%d" % (ci, j))
                    else:
                        hs[idx[j]].get()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(ci,), daemon=True) for ci in range(RM_C6_CLIENTS)]
        for t in threads:
            t.start()
        before = server.stats["commands"]
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        server_ops = server.stats["commands"] - before
        for cl in clients:
            cl.shutdown()
        if errors:
            raise errors[0]
        issued = RM_C6_CLIENTS * ops
        return {"issued_ops": issued, "server_ops": server_ops, "wall_s": wall, "ops_per_s": issued / wall,
                "server_ops_per_issued": server_ops / issued}

    off, on = phase(False, RM_C6_OPS[0]), phase(True, RM_C6_OPS[1])
    out = {"clients": RM_C6_CLIENTS, "keys": RM_C6_KEYS, "read_ratio": RM_C6_READS, "zipf_s": RM_C6_ZIPF,
           "ops_per_client": RM_C6_OPS, "design_ops_per_client": RM_C6_DESIGN_OPS, "off": off, "on": on,
           "reduction": off["server_ops_per_issued"] / max(on["server_ops_per_issued"], 1e-12)}
    if on["server_ops_per_issued"] >= off["server_ops_per_issued"]:
        raise AssertionError(f"remote config6: tracking on did not cut server ops: {off} / {on}")
    log(f"remote config6 [{card}]: {RM_C6_CLIENTS} clients x zipf({RM_C6_ZIPF}) over {RM_C6_KEYS} buckets at "
        f"{RM_C6_READS:.0%} reads, {RM_C6_OPS[0]} / {RM_C6_OPS[1]} ops a client (cut from bench.py's "
        f"{RM_C6_DESIGN_OPS[0]} / {RM_C6_DESIGN_OPS[1]}): tracking off {off['server_ops_per_issued']:.4f} server ops "
        f"an op ({off['ops_per_s'] / 1e3:.1f}k ops/s), on {on['server_ops_per_issued']:.4f} "
        f"({on['ops_per_s'] / 1e3:.1f}k ops/s): {out['reduction']:.1f}x fewer")
    return out


def localcache_phase(address: str, server, strategy: str) -> dict:
    """One RM_LC_OPS-op stream a client through RemoteLocalCachedMap in
    `strategy` against `server`: server ops per issued op, the near caches'
    hit share, and the map's final values."""
    import threading

    from redisson_tpu_torch.client.objects.localcache import LocalCachedMapOptions, SyncStrategy
    from redisson_tpu_torch.client.remote import RemoteRedisson

    name = f"c6lc:{strategy.lower()}"
    rng = np.random.default_rng(RM_LC_SEED)
    p = 1.0 / np.power(np.arange(1, RM_C6_KEYS + 1), RM_C6_ZIPF)
    p /= p.sum()
    seed = RemoteRedisson(address, timeout=600.0)
    seed.get_map(name).put_all({f"k{i}": "v0" for i in range(RM_C6_KEYS)})
    clients = [RemoteRedisson(address, timeout=600.0) for _ in range(RM_C6_CLIENTS)]
    opts = LocalCachedMapOptions(sync_strategy=getattr(SyncStrategy, strategy))
    if strategy == "TRACKING":
        for cl in clients:
            cl.enable_tracking()
    handles = [cl.get_local_cached_map(name, options=opts) for cl in clients]
    streams = []
    for ci in range(RM_C6_CLIENTS):
        idx, writes = rng.choice(RM_C6_KEYS, size=RM_LC_OPS, p=p), rng.random(RM_LC_OPS) >= RM_C6_READS
        streams.append((np.where(writes, idx - idx % RM_C6_CLIENTS + ci, idx), writes))
    start = threading.Barrier(RM_C6_CLIENTS + 1)
    errors = []

    def worker(ci):
        h, (idx, writes) = handles[ci], streams[ci]
        try:
            start.wait()
            for j in range(RM_LC_OPS):
                if writes[j]:
                    h.put(f"k{idx[j]}", f"w{ci}-{j}")
                else:
                    h.get(f"k{idx[j]}")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(ci,), daemon=True) for ci in range(RM_C6_CLIENTS)]
    for t in threads:
        t.start()
    before = server.stats["commands"]
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    server_ops = server.stats["commands"] - before
    hits, misses = sum(h.hits for h in handles), sum(h.misses for h in handles)
    final = seed.get_map(name).read_all_map()
    for h in handles:
        h.destroy()
    for cl in clients + [seed]:
        cl.shutdown()
    if errors:
        raise errors[0]
    issued = RM_C6_CLIENTS * RM_LC_OPS
    return {"issued_ops": issued, "writes": int(sum(w.sum() for _i, w in streams)), "server_ops": server_ops,
            "server_ops_per_issued": server_ops / issued, "hit_share": hits / max(1, hits + misses),
            "wall_s": wall, "ops_per_s": issued / wall, "final": final}


def remote_localcache(server, address: str, card: str) -> dict:
    """Config 6's workload through RemoteLocalCachedMap on the card server,
    INVALIDATE then TRACKING, each leg's final values held against the
    same streams on a CPU server."""
    from redisson_tpu_torch.server import ServerThread

    out = {}
    for strategy in ("INVALIDATE", "TRACKING"):
        got = localcache_phase(address, server, strategy)
        with ServerThread(port=0, device="cpu") as cpu:
            want = localcache_phase(cpu.address, cpu.server, strategy)
        if got["final"] != want["final"] or len(got["final"]) != RM_C6_KEYS:
            bad = [k for k in want["final"] if got["final"].get(k) != want["final"][k]]
            raise AssertionError(f"local cache {strategy}: {len(bad)} final values differ from the CPU server's")
        got.pop("final")
        out[strategy.lower()] = got
        log(f"remote local cache {strategy} [{card}]: config 6's workload through RemoteLocalCachedMap "
            f"({RM_C6_CLIENTS} clients x zipf({RM_C6_ZIPF}) over {RM_C6_KEYS} entries at {RM_C6_READS:.0%} reads, "
            f"{RM_LC_OPS} ops a client, cut from {RM_LC_DESIGN_OPS}; {got['writes']} writes): "
            f"{got['server_ops_per_issued']:.4f} server ops an issued op, hit share {got['hit_share']:.4f}, "
            f"{got['ops_per_s'] / 1e3:.1f}k ops/s; final values equal a CPU server's")
    return out


def remote_stream(address: str, seed: int) -> list:
    """One op stream through the port's RemoteRedisson and
    AsyncRemoteRedisson (typed sketch handles, OBJCALL, OBJCALLM, a
    RemoteBatch, MULTI/EXEC with WATCH, transactions, a wire lock, a
    topic); its replies, the HLLA estimates rounded to 6 digits."""
    import asyncio

    from redisson_tpu_torch.client.aio import AsyncRemoteRedisson
    from redisson_tpu_torch.client.remote import RemoteRedisson

    rng = np.random.default_rng(seed)
    ints = rng.integers(-2**62, 2**62, 3000)
    tenants = rng.integers(0, 16, 3000).astype(np.int32)
    out = []

    def rec(fn, *a):
        try:
            out.append(fn(*a))
        except Exception as e:  # noqa: BLE001 — the error is the reply
            out.append(("raised", type(e).__name__, str(e)))

    c, c2 = RemoteRedisson(address, timeout=600.0), RemoteRedisson(address, timeout=600.0)
    try:
        bf = c.get_bloom_filter("rs:bf")
        for fn, *a in ((bf.try_init, 20_000, 0.01), (bf.add_each, ints[:1500]), (bf.contains_each, ints[750:2250]),
                       (bf.add_all, ["a", "b"]), (bf.contains, "a"), (bf.count,)):
            rec(fn, *a)
        bfa = c.get_bloom_filter_array("rs:bfa")
        for fn, *a in ((bfa.try_init, 16, 2000, 0.01), (bfa.add_each, tenants[:1500], ints[:1500]),
                       (bfa.contains, tenants[750:2250], ints[750:2250])):
            rec(fn, *a)
        hlla = c.get_hyper_log_log_array("rs:hlla")
        rec(hlla.try_init, 16)
        rec(hlla.add, tenants, ints)
        rec(hlla.merge_rows, [0, 2], [1, 3])
        out.append(np.round(hlla.estimate_all(), 6).tolist())
        h = c.get_hyper_log_log("rs:h")
        for fn, *a in ((h.add_all, ints[:2000]), (h.add_all, ["x", "y"]), (h.count,)):
            rec(fn, *a)
        bits = c.get_bit_set("rs:bits")
        idx = rng.integers(0, 50_000, 500)
        for fn, *a in ((bits.set_each, idx), (bits.get_each, idx + 1), (bits.set_each, idx[:50], False),
                       (bits.cardinality,), (c.get_bit_set("rs:bits2").set_each, idx[::3]), (bits.xor, "rs:bits2"),
                       (bits.cardinality,)):
            rec(fn, *a)
        m = c.get_map("rs:map")
        for fn, *a in ((m.put, "a", 1), (m.get, "a"), (m.read_all_map,), (m.nope,)):
            rec(fn, *a)
        rec(c.objcall_many, [("get_map", "rs:map", "get", ("a",), {}), ("get_map", "rs:map", "bogus", (), {}),
                             ("get_bloom_filter", "rs:bf", "contains_each", (ints[:8],), {})])
        b = c.create_batch()
        for i in range(20):
            b.get_bloom_filter("rs:bf").contains_async(ints[i * 100:(i + 1) * 100])
        b.get_map("rs:map").get("a")
        rec(b.execute)
        conn = c.node.pool.acquire()
        try:
            rec(conn.execute_many, [("WATCH", "rs:w"), ("MULTI",), ("INCR", "rs:w"),
                                    ("BF.MEXISTS64", "rs:bf", _i8(ints[:5])), ("EXEC",)])
            rec(conn.execute, "WATCH", "rs:w")
            rec(c2.execute, "INCR", "rs:w")
            rec(conn.execute_many, [("MULTI",), ("INCR", "rs:w"), ("EXEC",)])
        finally:
            c.node.pool.release(conn)
        tx = c.create_transaction()
        rec(tx.get_bucket("rs:tx").get)
        rec(c2.get_bucket("rs:tx").set, "racer")
        rec(tx.get_bucket("rs:tx").set, "lost")
        rec(tx.commit)
        tx = c.create_transaction()
        rec(tx.get_map("rs:txm").put, "k", 1)
        rec(tx.commit)
        lk, other = c.get_lock("rs:lock"), c2.get_lock("rs:lock")
        for fn in (lk.try_lock, other.try_lock, lk.unlock, other.try_lock, other.unlock):
            rec(fn)
        got = []
        c.get_topic("rs:topic").add_listener(lambda ch, msg: got.append((ch, msg)))
        time.sleep(0.2)
        rec(c2.get_topic("rs:topic").publish, "hello")
        deadline = time.time() + 10
        while not got and time.time() < deadline:
            time.sleep(0.01)
        out.append(got)
    finally:
        c2.shutdown()
        c.shutdown()

    async def aio():
        a = await AsyncRemoteRedisson.connect(address, timeout=600.0)
        try:
            abf = a.get_bloom_filter("rs:bf")
            return [await abf.contains_each(ints[:100]), await a.get_map("rs:map").get("a"),
                    list(await asyncio.gather(*(a.get_bit_set("rs:bits").get_each(idx[i::4]) for i in range(4))))]
        finally:
            await a.aclose()

    out.append(asyncio.run(aio()))
    return out


def remote_card_against_cpu(device, card: str) -> dict:
    """remote_stream and tools/wire_stream.objcall_stream (RESP2, RESP3) on
    a card server and a CPU server of the port: the same replies."""
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    stream = W.objcall_stream(seed=RM_STREAM_SEED)
    waves = [stream, [("HELLO", "3")] + stream]
    got = {}
    for where in (device, "cpu"):
        with ServerThread(port=0, device=where) as st:
            got[where] = (remote_stream(st.address, RM_STREAM_SEED),
                          W.replies(st.server.host, st.server.port, waves))
    card_s, card_w = got[device]
    cpu_s, cpu_w = got["cpu"]
    for i, (a, b) in enumerate(zip(card_s, cpu_s)):
        if not same(a, b) or len(card_s) != len(cpu_s):
            raise AssertionError(f"remote stream reply {i}: card {a!r:.200} != cpu {b!r:.200}")
    for wave, (craw, cr), (wraw, wr) in zip(waves, card_w, cpu_w):
        bad = W.compare(wave, cr, wr)
        if bad or craw != wraw:
            raise AssertionError(f"remote OBJCALL stream: {len(bad)} replies differ: {bad[:3]}")
    log(f"remote card vs CPU [{card}]: the client stream ({len(card_s)} replies, 3,000 keys, not cut) and the "
        f"OBJCALL stream ({len(stream)} commands, RESP2 then RESP3, byte for byte) equal on the card and the CPU")
    return {"stream_replies": len(card_s), "objcall_commands": 2 * len(stream) + 1}


def run_remote(device="cuda") -> dict:
    """The remote path: the port's RemoteRedisson and AsyncRemoteRedisson
    against a port ServerThread on the card."""
    from redisson_tpu_torch.client.remote import RemoteRedisson
    from redisson_tpu_torch.server import ServerThread

    start = time.perf_counter()
    card = card_line()
    rng = np.random.default_rng(37)
    out, parts = {}, {}
    with ServerThread(port=0, device=device) as st:
        if st.server.engine.device.type != torch.device(device).type:
            raise AssertionError(f"the server did not land on {device}")
        c = RemoteRedisson(st.address, timeout=600.0)
        try:
            for name, run in (("config2", lambda: remote_config2(c, st.address, card, rng)),
                              ("config3", lambda: remote_config3(c, card, rng)),
                              ("bitsets", lambda: remote_bitsets(c, st.address, card, rng)),
                              ("objcall_tx", lambda: remote_objcall_tx(c, card, rng)),
                              ("config6", lambda: remote_config6(st.server, st.address, card)),
                              ("localcache", lambda: remote_localcache(st.server, st.address, card))):
                s = time.perf_counter()
                out[name] = run()
                parts[name] = time.perf_counter() - s
        finally:
            c.shutdown()
    launches = {}
    from redisson_tpu_torch.core import kernels as K

    launches.update(K.launches)  # the card-against-CPU run below launches more
    s = time.perf_counter()
    out["card_vs_cpu"] = remote_card_against_cpu(device, card)
    parts["card_vs_cpu"] = time.perf_counter() - s
    out["launches"] = launches
    out["seconds"], out["part_seconds"] = time.perf_counter() - start, parts
    log(f"remote path [{card}]: {out['seconds']:.1f}s (" + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items())
        + ")")
    return out


# --------------------------------------------------------------------------
# the services path: config 7 over the wire, streams, geo, JSON, scripts and
# the executor on a port server on the card
# --------------------------------------------------------------------------

# search: config 7's clustered corpus (C7_POINTS[1]: 50,000 x 128, COSINE,
# k 10) ingested by HSET of FLOAT32 blobs in pipelined frames, FT.MSEARCH
# batches of C7_QB stacked queries; the card-against-CPU leg cuts the corpus
SV_FRAME, SV_BATCHES, SV_SINGLES, SV_SEED = 1_000, 20, 8, 79
SV_CMP_ROWS, SV_CMP_SCALE = 10_000, 3
# a stream of SV_STREAM entries (explicit IDs) read by SV_CONSUMERS consumers
# of one group, SV_READ entries a read, each read acknowledged
SV_STREAM, SV_STREAM_FRAME, SV_CONSUMERS, SV_READ = 100_000, 5_000, 4, 100
# SV_GEO members (SV_GEO_FRAME a GEOADD), SV_GEO_QUERIES radius searches
SV_GEO, SV_GEO_FRAME, SV_GEO_QUERIES, SV_GEO_RADIUS_KM = 100_000, 1_000, 1_000, 50
SV_JSON_DOCS = 80
# word_count(executor=...) on one worker-node child of SV_NODE_WORKERS
# threads over config 4's values, cut from C4_ENTRIES to SV_WC_ENTRIES
SV_WC_ENTRIES, SV_NODE_WORKERS, SV_NODE_WAIT_S = 100_000, 4, 180.0
# the repository root: the worker node child imports the package from it
HERE = os.path.dirname(os.path.abspath(__file__))


def bank_devices(server, index: str) -> set:
    """The device types holding `index`'s embedding banks and their IVF
    centroids and cells."""
    from redisson_tpu_torch.client.redisson import RedissonTpu

    svc = RedissonTpu(server.engine).get_search()
    out = set()
    for bank in svc._idx(index).vectors.banks.values():
        out |= {t.device.type for t in bank._get_planes() if t is not None}
        try:
            arrays = bank._rec().arrays
        except KeyError:
            arrays = {}
        out |= {arrays[k].device.type for k in ("centroids", "cells") if k in arrays}
    return out


def msearch_ids(reply, prefix: str) -> list:
    """FT.MSEARCH's reply -> a list of row ids a query."""
    return [[int(bytes(r[i])[len(prefix):]) for i in range(0, len(r), 2)] for r in reply[1:]]


def services_search(conn, server, card: str, c7: dict) -> dict:
    """Config 7 over the wire: HSET ingest of the clustered corpus into a
    FLAT COSINE index and an IVF index (nlist C7_NLIST) on the same hashes,
    SV_BATCHES FT.MSEARCH batches of C7_QB queries a leg (FLAT, IVF at
    nprobe 2, 4 and 8), single FT.SEARCH KNN queries and a hybrid query
    with a TAG filter, recall@10 against the float64 oracle.  Fails unless
    the banks and centroids are on the card and the reference's recall
    floors hold."""
    from redisson_tpu_torch.tools import wire_stream as W

    n, d, k = C7_POINTS[1]
    rng = np.random.default_rng(SV_SEED)
    vecs = c7_clustered(rng, n, d)
    batches = c7_queries(rng, vecs, SV_BATCHES * C7_QB).reshape(SV_BATCHES, C7_QB, d)
    oracle_q = c7_queries(rng, vecs, C7_ORACLE)
    truth = c7_truth(server.engine.device, vecs, oracle_q, "COSINE", k)
    knn = f"*=>[KNN {k} @emb $v]"
    for name, algo in (("sv_flat", ["FLAT", "6"]), ("sv_ivf", ["IVF", "8"])):
        extra = ["NLIST", str(C7_NLIST)] if algo[0] == "IVF" else []
        reply = conn.execute("FT.CREATE", name, "ON", "HASH", "PREFIX", "1", "sv:", "SCHEMA", "tag", "TAG",
                             "emb", "VECTOR", *algo, "TYPE", "FLOAT32", "DIM", str(d),
                             "DISTANCE_METRIC", "COSINE", *extra)
        if reply != b"OK":
            raise AssertionError(f"services FT.CREATE {name}: {reply!r}")
    s = time.perf_counter()
    for start in range(0, n, SV_FRAME):
        frame = [("HSET", f"sv:{i}", "tag", "abc"[i % 3], "emb", W.f32_blob(vecs[i]))
                 for i in range(start, min(n, start + SV_FRAME))]
        replies = conn.execute_many(frame)
        if any(r != 2 for r in replies):
            raise AssertionError(f"services HSET frame at {start}: {replies[:3]}")
    ingest_s = time.perf_counter() - s
    legs = {}
    for leg, name, nprobe in (("flat", "sv_flat", None), ("ivf_np2", "sv_ivf", 2), ("ivf_np4", "sv_ivf", 4),
                              ("ivf_np8", "sv_ivf", 8)):
        tail = ("NPROBE", str(nprobe)) if nprobe else ()
        s = time.perf_counter()  # the first query of an index syncs the hashes (and trains IVF)
        reply = conn.execute("FT.MSEARCH", name, knn, "PARAMS", "2", "v", W.f32_blob(oracle_q), *tail)
        first_s = time.perf_counter() - s
        if isinstance(reply, Exception) or reply[0] != C7_ORACLE:
            raise AssertionError(f"services {leg}: FT.MSEARCH replied {reply!r:.200}")
        got = msearch_ids(reply, "sv:")
        recall = sum(len(truth[i] & set(got[i][:k])) for i in range(C7_ORACLE)) / (k * C7_ORACLE)
        lat = []
        for b in range(SV_BATCHES):
            s = time.perf_counter()
            reply = conn.execute("FT.MSEARCH", name, knn, "PARAMS", "2", "v", W.f32_blob(batches[b]), *tail)
            lat.append(time.perf_counter() - s)
            if isinstance(reply, Exception) or reply[0] != C7_QB or any(len(r) != 2 * k for r in reply[1:]):
                raise AssertionError(f"services {leg}: batch {b} replied {reply!r:.200}")
        legs[leg] = {"recall_at_10": recall, "first_query_s": first_s, "qps": SV_BATCHES * C7_QB / sum(lat),
                     "batch_p50_ms": pctl(lat, 50) * 1e3, "batch_p99_ms": pctl(lat, 99) * 1e3}
    where = {name: bank_devices(server, name) for name in ("sv_flat", "sv_ivf")}
    log(f"services search banks: sv_flat on {sorted(where['sv_flat'])}, sv_ivf (bank, centroids, cells) on "
        f"{sorted(where['sv_ivf'])}")
    if any(w != {server.engine.device.type} for w in where.values()):  # "cuda" on the card run
        raise AssertionError(f"services: the search banks are not on the server's device: {where}")
    singles = {}
    for name in ("sv_flat", "sv_ivf"):
        lat = []
        for i in range(SV_SINGLES):
            s = time.perf_counter()
            reply = conn.execute("FT.SEARCH", name, knn, "PARAMS", "2", "v", W.f32_blob(oracle_q[i]), "NOCONTENT")
            lat.append(time.perf_counter() - s)
            ids = [int(bytes(x)[3:]) for x in reply[1::2]]
            if reply[0] != k or len(set(ids) & truth[i]) < k - 2:
                raise AssertionError(f"services FT.SEARCH {name}: {reply!r:.200}")
        s = time.perf_counter()
        reply = conn.execute("FT.SEARCH", name, f"(@tag:{{a}})=>[KNN {k} @emb $v]", "PARAMS", "2", "v",
                             W.f32_blob(oracle_q[0]), "NOCONTENT")
        hybrid_ms = (time.perf_counter() - s) * 1e3
        ids = [int(bytes(x)[3:]) for x in reply[1::2]]
        if reply[0] != k or any(i % 3 for i in ids):
            raise AssertionError(f"services hybrid {name}: {reply!r:.200}")
        singles[name] = {"p50_ms": pctl(lat, 50) * 1e3, "p99_ms": pctl(lat, 99) * 1e3, "hybrid_ms": hybrid_ms}
    flat, ivf4 = legs["flat"], legs["ivf_np4"]
    failures = []
    if flat["recall_at_10"] < 0.99:
        failures.append(f"FLAT recall {flat['recall_at_10']:.4f} < 0.99")
    if ivf4["recall_at_10"] < 0.97:
        failures.append(f"IVF nprobe 4 recall {ivf4['recall_at_10']:.4f} < 0.97")
    if failures:
        raise AssertionError("services search: " + "; ".join(failures))
    embedded = {"flat": c7["legs"]["v7c_flat"]["qps"],
                **{f"ivf_np{p}": c7["legs"][f"v7c_ivf_np{p}"]["qps"] for p in C7_NPROBES}} if c7 else {}
    for leg, r in legs.items():
        log(f"services search {leg} [{card}]: {n} x {d} COSINE over the wire, {SV_BATCHES} FT.MSEARCH batches of "
            f"{C7_QB}: {r['qps']:.1f} qps (embedded config7 {embedded.get(leg, float('nan')):.1f}), batch p50 "
            f"{r['batch_p50_ms']:.3f} ms p99 {r['batch_p99_ms']:.3f} ms, recall@10 {r['recall_at_10']:.4f}, "
            f"first query {r['first_query_s']:.3f} s")
    ratio = ivf4["qps"] / flat["qps"]
    log(f"services search [{card}]: ingest {n} HSET in frames of {SV_FRAME} {ingest_s:.3f} s "
        f"({n / ingest_s:.1f} docs/s); FT.SEARCH KNN p50 " + ", ".join(
            f"{nm} {v['p50_ms']:.3f} ms (p99 {v['p99_ms']:.3f}, hybrid TAG filter {v['hybrid_ms']:.3f} ms)"
            for nm, v in singles.items())
        + f"; floors held: FLAT recall {flat['recall_at_10']:.4f} >= 0.99, IVF nprobe 4 recall "
        f"{ivf4['recall_at_10']:.4f} >= 0.97; speed aim {'met' if ratio >= 2.0 else 'NOT MET'}: IVF nprobe 4 at "
        f"{ratio:.3f}x FLAT's wire qps (aim 2, not a gate)")
    for name in ("sv_flat", "sv_ivf"):
        conn.execute("FT.DROPINDEX", name)
    return {"n": n, "dim": d, "k": k, "ingest_s": ingest_s, "legs": legs, "singles": singles,
            "embedded_qps": embedded, "ivf_speedup_wire": ratio, "bank_devices": {a: sorted(b) for a, b in
                                                                                 where.items()}}


def services_streams(st, card: str) -> dict:
    """A stream of SV_STREAM entries (XADD with explicit IDs in pipelined
    frames) read by SV_CONSUMERS consumers of one group, each on its own
    connection (XREADGROUP COUNT SV_READ, then XACK of what it read); every
    entry delivered once and acknowledged; XPENDING and XINFO after."""
    from redisson_tpu_torch.net.client import Connection

    host, port = st.server.host, st.server.port
    conn = Connection(host, port, timeout=600.0)
    try:
        s = time.perf_counter()
        for start in range(0, SV_STREAM, SV_STREAM_FRAME):
            frame = [("XADD", "sv:events", f"{i + 1}-0", "user", f"u{i % 9973}", "event", "click",
                      "ts", str(1_700_000_000_000 + i)) for i in range(start, start + SV_STREAM_FRAME)]
            conn.execute_many(frame)
        add_s = time.perf_counter() - s
        if conn.execute("XLEN", "sv:events") != SV_STREAM or conn.execute(
                "XGROUP", "CREATE", "sv:events", "g", "0") != b"OK":
            raise AssertionError("services stream: XLEN or XGROUP CREATE")
        seen = [[] for _ in range(SV_CONSUMERS)]
        errors = []

        def consume(j):
            c = Connection(host, port, timeout=600.0)
            try:
                while True:
                    r = c.execute("XREADGROUP", "GROUP", "g", f"c{j}", "COUNT", str(SV_READ), "STREAMS",
                                  "sv:events", ">")
                    if r is None:
                        return
                    ids = [e[0] for e in r[0][1]]
                    seen[j] += ids
                    if c.execute("XACK", "sv:events", "g", *ids) != len(ids):
                        raise AssertionError("XACK acknowledged fewer entries than it read")
            except Exception as e:  # noqa: BLE001 — raised below, in the path
                errors.append(e)
            finally:
                c.close()

        s = time.perf_counter()
        threads = [threading.Thread(target=consume, args=(j,)) for j in range(SV_CONSUMERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        read_s = time.perf_counter() - s
        if errors:
            raise AssertionError(f"services stream consumer: {errors[0]!r}")
        every = [i for part in seen for i in part]
        if len(every) != SV_STREAM or len(set(every)) != SV_STREAM:
            raise AssertionError(f"services stream: {len(every)} entries read, {len(set(every))} distinct")
        pending = conn.execute("XPENDING", "sv:events", "g")
        groups = conn.execute("XINFO", "GROUPS", "sv:events")
        consumers = conn.execute("XINFO", "CONSUMERS", "sv:events", "g")
        if pending[0] != 0 or groups[0][3] != SV_CONSUMERS or groups[0][5] != 0:
            raise AssertionError(f"services stream: XPENDING {pending!r}, XINFO GROUPS {groups!r}")
        conn.execute("DEL", "sv:events")
    finally:
        conn.close()
    out = {"entries": SV_STREAM, "xadd_s": add_s, "xadd_per_s": SV_STREAM / add_s, "read_ack_s": read_s,
           "read_ack_per_s": SV_STREAM / read_s, "per_consumer": [len(p) for p in seen],
           "consumers_seen": len(consumers)}
    log(f"services stream [{card}]: {SV_STREAM} XADD (explicit IDs, frames of {SV_STREAM_FRAME}) {add_s:.3f} s "
        f"({out['xadd_per_s']:.1f} entries/s); {SV_CONSUMERS} consumers, XREADGROUP COUNT {SV_READ} + XACK: "
        f"{read_s:.3f} s ({out['read_ack_per_s']:.1f} entries/s), per consumer {out['per_consumer']}, every "
        f"entry once; XPENDING 0 pending, XINFO {len(consumers)} consumers")
    return out


def services_geo(conn, card: str) -> dict:
    """SV_GEO members by GEOADD (SV_GEO_FRAME a command), then
    SV_GEO_QUERIES GEOSEARCH FROMLONLAT BYRADIUS queries, the first few held
    to a float64 haversine on the host."""
    from redisson_tpu_torch.client.objects.geo import _haversine_m

    rng = np.random.default_rng(SV_SEED + 1)
    lon = rng.uniform(-10.0, 30.0, SV_GEO)
    lat = rng.uniform(35.0, 60.0, SV_GEO)
    s = time.perf_counter()
    for start in range(0, SV_GEO, SV_GEO_FRAME * 10):
        frame = []
        for c0 in range(start, min(SV_GEO, start + SV_GEO_FRAME * 10), SV_GEO_FRAME):
            cmd = ["GEOADD", "sv:geo"]
            for i in range(c0, min(SV_GEO, c0 + SV_GEO_FRAME)):
                cmd += [f"{lon[i]:.6f}", f"{lat[i]:.6f}", f"m{i}"]
            frame.append(tuple(cmd))
        conn.execute_many(frame)
    add_s = time.perf_counter() - s
    q = rng.integers(0, SV_GEO, SV_GEO_QUERIES)
    lat_ms, hits = [], 0
    plon, plat = np.round(lon, 6), np.round(lat, 6)
    for j, i in enumerate(q.tolist()):
        s = time.perf_counter()
        reply = conn.execute("GEOSEARCH", "sv:geo", "FROMLONLAT", f"{lon[i]:.6f}", f"{lat[i]:.6f}", "BYRADIUS",
                             str(SV_GEO_RADIUS_KM), "km", "ASC", "COUNT", "10", "WITHDIST")
        lat_ms.append((time.perf_counter() - s) * 1e3)
        hits += len(reply)
        if j < 5:
            d = _haversine_m(float(f"{lon[i]:.6f}"), float(f"{lat[i]:.6f}"), plon, plat)
            want = [f"m{x}".encode() for x in np.argsort(d, kind="stable")[:10] if d[x] <= SV_GEO_RADIUS_KM * 1e3]
            got = [bytes(r[0]) for r in reply]
            if got[:len(want)] != want[:len(got)] or len(got) != len(want):
                raise AssertionError(f"services geo query {j}: {got} != {want}")
    conn.execute("DEL", "sv:geo")
    out = {"members": SV_GEO, "geoadd_s": add_s, "members_per_s": SV_GEO / add_s, "queries": SV_GEO_QUERIES,
           "query_p50_ms": pctl(lat_ms, 50), "query_p99_ms": pctl(lat_ms, 99),
           "queries_per_s": SV_GEO_QUERIES / (sum(lat_ms) / 1e3), "mean_hits": hits / SV_GEO_QUERIES}
    log(f"services geo [{card}]: {SV_GEO} members by GEOADD of {SV_GEO_FRAME} {add_s:.3f} s "
        f"({out['members_per_s']:.1f} members/s); {SV_GEO_QUERIES} GEOSEARCH BYRADIUS {SV_GEO_RADIUS_KM} km: "
        f"p50 {out['query_p50_ms']:.3f} ms p99 {out['query_p99_ms']:.3f} ms ({out['queries_per_s']:.1f}/s, "
        f"{out['mean_hits']:.2f} hits a query; the first 5 equal to a host haversine)")
    return out


def services_json(conn, card: str) -> dict:
    """JSON.* over SV_JSON_DOCS documents: SET, NUMINCRBY, ARRAPPEND,
    STRAPPEND, GET, MERGE, TYPE and DEL, the final documents checked."""
    cmds = []
    for i in range(SV_JSON_DOCS):
        key = f"sv:j{i}"
        cmds += [("JSON.SET", key, "$", json.dumps({"id": i, "n": 0, "tags": ["a"], "s": "x", "o": {"k": 1}})),
                 ("JSON.NUMINCRBY", key, "$.n", str(i)), ("JSON.ARRAPPEND", key, "$.tags", '"b"', '"c"'),
                 ("JSON.STRAPPEND", key, "$.s", '"yz"'), ("JSON.MERGE", key, "$.o", '{"k": null, "m": 2}'),
                 ("JSON.TYPE", key, "$.tags")]
    s = time.perf_counter()
    replies = conn.execute_many(cmds)
    gets = conn.execute_many([("JSON.GET", f"sv:j{i}") for i in range(SV_JSON_DOCS)])
    dels = conn.execute_many([("JSON.DEL", f"sv:j{i}") for i in range(SV_JSON_DOCS)])
    wall = time.perf_counter() - s
    n_cmds = len(cmds) + 2 * SV_JSON_DOCS
    errors = [r for r in replies if isinstance(r, Exception)]
    for i, g in enumerate(gets):
        want = {"id": i, "n": i, "tags": ["a", "b", "c"], "s": "xyz", "o": {"m": 2}}
        if errors or json.loads(g) != want or dels[i] != 1:
            raise AssertionError(f"services JSON doc {i}: {g!r} ({errors[:2]})")
    log(f"services JSON [{card}]: {n_cmds} JSON.* commands over {SV_JSON_DOCS} documents in {wall * 1e3:.3f} ms "
        f"({n_cmds / wall:.1f} commands/s), every document as written")
    return {"commands": n_cmds, "seconds": wall}


class WireExecutor:
    """A coordinator's view of an executor service over the wire."""

    def __init__(self, client, name: str = "redisson_executor"):
        self._client, self._name = client, name

    def _call(self, method: str, *args):
        return self._client.objcall("get_executor_service", self._name, method, args, {})

    def submit_payload(self, payload):
        return self._call("submit_payload", payload)

    def task_state(self, task_id):
        return self._call("task_state", task_id)

    def await_task_result(self, task_id, timeout):
        return self._call("await_task_result", task_id, timeout)


def services_executor(st, card: str, values: list) -> dict:
    """word_count(executor=...) on one worker-node child process
    (``python -m redisson_tpu_torch.node --workers SV_NODE_WORKERS``) over
    config 4's values cut to SV_WC_ENTRIES, equal to the card's embedded
    word_count of the same map; the child is stopped and waited for."""
    from redisson_tpu_torch.client.codec import StringCodec
    from redisson_tpu_torch.client.redisson import RedissonTpu
    from redisson_tpu_torch.client.remote import RemoteRedisson
    from redisson_tpu_torch.services import mapreduce as MR

    cut = values[:SV_WC_ENTRIES]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    s = time.perf_counter()
    node = subprocess.Popen([sys.executable, "-m", "redisson_tpu_torch.node", "--address", st.address,
                             "--workers", str(SV_NODE_WORKERS), "--poll-interval", "0.05"],
                            cwd=HERE, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    client = RemoteRedisson(st.address, timeout=600.0)
    try:
        ex = WireExecutor(client)
        while ex._call("count_active_workers") < SV_NODE_WORKERS:
            if node.poll() is not None:
                raise AssertionError(f"services: the worker node exited: {node.stderr.read().decode()[-2000:]}")
            if time.perf_counter() - s > SV_NODE_WAIT_S:
                raise AssertionError("services: the worker node never registered its workers")
            time.sleep(0.1)
        start_s = time.perf_counter() - s
        m = client.get_map("sv:wc", codec=StringCodec())
        s = time.perf_counter()
        for i in range(0, len(cut), 10_000):
            m.put_all({f"doc-{j}": cut[j] for j in range(i, min(len(cut), i + 10_000))})
        put_s = time.perf_counter() - s
        s = time.perf_counter()
        counts = MR.word_count(m, workers=SV_NODE_WORKERS, executor=ex, timeout=600.0)
        wc_s = time.perf_counter() - s
        s = time.perf_counter()
        embedded = MR.word_count(RedissonTpu(st.server.engine).get_map("sv:wc", codec=StringCodec()))
        embedded_s = time.perf_counter() - s
        if counts != embedded or sum(counts.values()) != sum(len(v.split()) for v in cut):
            raise AssertionError(f"services word_count: the node's counts ({len(counts)} words, "
                                 f"{sum(counts.values())}) differ from the card's ({len(embedded)} words)")
        client.get_map("sv:wc").delete()
    finally:
        client.shutdown()
        if node.poll() is None:
            node.send_signal(signal.SIGINT)  # the node's main stops its workers and exits
        try:
            node.wait(timeout=30)
        except subprocess.TimeoutExpired:
            node.kill()
            node.wait(timeout=30)
    out = {"entries": SV_WC_ENTRIES, "cut_from": C4_ENTRIES, "node_workers": SV_NODE_WORKERS,
           "node_start_s": start_s, "put_s": put_s, "word_count_s": wc_s, "embedded_s": embedded_s,
           "distinct_words": len(counts), "node_exit": node.returncode}
    log(f"services executor [{card}]: config 4's values cut from {C4_ENTRIES} to {SV_WC_ENTRIES} entries; "
        f"one worker-node child of {SV_NODE_WORKERS} workers up in {start_s:.3f} s; put_all {put_s:.3f} s; "
        f"word_count(executor=...) {wc_s:.3f} s ({SV_WC_ENTRIES / wc_s:.1f} entries/s), equal to the card's "
        f"embedded word_count ({embedded_s:.3f} s, {len(counts)} words); the node exited {node.returncode}")
    return out


def services_card_against_cpu(device, card: str) -> dict:
    """tools/wire_stream.services_stream (RESP2, then RESP3) and a search
    leg on config 7's clustered corpus cut to SV_CMP_ROWS rows (FLAT and
    IVF at nprobe 2, 4, 8 by FT.MSEARCH), on a card server and a CPU
    server: the same replies under the stream's contracts.  The card trains
    the IVF indexes; the CPU server installs them (wire_stream.train_ivf)."""
    from redisson_tpu_torch.client.redisson import RedissonTpu
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    n, d, k = SV_CMP_ROWS, C7_POINTS[1][1], C7_POINTS[1][2]
    rng = np.random.default_rng(SV_SEED + 2)
    vecs = c7_clustered(rng, n, d)
    qs = c7_queries(rng, vecs, C7_QB)
    big = [("FT.CREATE", "cmp", "ON", "HASH", "PREFIX", "1", "cmp:", "SCHEMA", "emb", "VECTOR", "IVF", "8",
            "TYPE", "FLOAT32", "DIM", str(d), "DISTANCE_METRIC", "COSINE", "NLIST", str(C7_NLIST)),
           ("FT.CREATE", "cmpf", "ON", "HASH", "PREFIX", "1", "cmp:", "SCHEMA", "emb", "VECTOR", "FLAT", "6",
            "TYPE", "FLOAT32", "DIM", str(d), "DISTANCE_METRIC", "COSINE")]
    big += [("HSET", f"cmp:{i}", "emb", W.f32_blob(vecs[i])) for i in range(n)]
    knn = f"*=>[KNN {k} @emb $v]"
    big_q = [("FT.MSEARCH", "cmpf", knn, "PARAMS", "2", "v", W.f32_blob(qs))]
    big_q += [("FT.MSEARCH", "cmp", knn, "PARAMS", "2", "v", W.f32_blob(qs), "NPROBE", str(p)) for p in C7_NPROBES]
    servers = [ServerThread(port=0, device=device).start(), ServerThread(port=0, device="cpu").start()]
    try:
        shas = [W.load_scripts(RedissonTpu(st.server.engine)) for st in servers]
        if shas[0] != shas[1]:
            raise AssertionError("services: the two servers' script digests differ")
        setup, queries = W.services_stream(seed=SV_SEED, scale=SV_CMP_SCALE, shas=shas[0])
        setups = [W.replies(st.server.host, st.server.port, [setup, big]) for st in servers]
        svcs = [RedissonTpu(st.server.engine).get_search() for st in servers]
        for index in ("idx:i", "cmp"):
            W.train_ivf(svcs[0], svcs[1], index)
        waves = [queries + big_q, [("HELLO", "3")] + queries + big_q]
        got = [W.replies(st.server.host, st.server.port, waves) for st in servers]
    finally:
        for st in servers:
            st.stop()
    bad = []
    for cmds, a, b in zip([setup, big], setups[0], setups[1]):
        bad += W.compare(cmds, a[1], b[1])
    contract = set()
    for cmds, (craw, cr), (wraw, wr) in zip(waves, got[0], got[1]):
        bad += W.compare(cmds, cr, wr)
        spans = zip(W.reply_spans(craw), W.reply_spans(wraw))
        contract |= {W._verb(cmds[i]) for i, (x, y) in enumerate(spans) if x != y}
    if bad:
        raise AssertionError(f"services card vs CPU: {len(bad)} replies differ: {bad[:3]}")
    if contract - W.CLOCK_VERBS - {b"FT.SEARCH", b"FT.MSEARCH"}:
        raise AssertionError(f"services card vs CPU: bytes differ outside the contracts: {contract}")
    log(f"services card vs CPU [{card}]: the services stream (scale {SV_CMP_SCALE}: {len(setup)} set-up and "
        f"{len(queries)} queries, RESP2 then RESP3) and FT.MSEARCH on config 7's corpus cut from "
        f"{C7_POINTS[1][0]} to {n} rows (FLAT, IVF nprobe {'/'.join(map(str, C7_NPROBES))}) equal on the card "
        f"and the CPU; bytes differ only in {sorted(v.decode() for v in contract)} (the clock and KNN contracts)")
    return {"setup": len(setup), "queries": 2 * len(queries) + 1, "corpus_rows": n, "bytes_differ": sorted(
        v.decode() for v in contract)}


def run_services(c7, values: list, device="cuda") -> dict:
    """The services path: config 7's search over the wire (FT.CREATE,
    HSET, FT.MSEARCH, FT.SEARCH), streams, geo, JSON and the executor with a
    worker-node child, on a port ServerThread on the card driven by the
    port's Connection and RemoteRedisson; then the services stream on the
    card against the CPU.  `c7` is the run's config7 path (its qps are
    printed beside the wire's; None prints none), `values` config 4's."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server import ServerThread

    start = time.perf_counter()
    card = card_line()
    out, parts = {}, {}
    with ServerThread(port=0, device=device) as st:
        if st.server.engine.device.type != torch.device(device).type:
            raise AssertionError(f"the server did not land on {device}")
        conn = Connection(st.server.host, st.server.port, timeout=600.0)
        try:
            for name, run in (("search", lambda: services_search(conn, st.server, card, c7)),
                              ("streams", lambda: services_streams(st, card)),
                              ("geo", lambda: services_geo(conn, card)),
                              ("json", lambda: services_json(conn, card)),
                              ("executor", lambda: services_executor(st, card, values))):
                s = time.perf_counter()
                out[name] = run()
                parts[name] = time.perf_counter() - s
        finally:
            conn.close()
    launches = dict(K.launches)  # the card-against-CPU run below launches more
    s = time.perf_counter()
    out["card_vs_cpu"] = services_card_against_cpu(device, card)
    parts["card_vs_cpu"] = time.perf_counter() - s
    out["launches"] = launches
    out["seconds"], out["part_seconds"] = time.perf_counter() - start, parts
    log(f"services path [{card}]: {out['seconds']:.1f}s (" + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items())
        + f"); launches {json.dumps({k: launches[k] for k in VECTOR_KERNELS})}")
    return out


# the cluster paths: config 5 (bench.py:452-490, 8 in-process masters with
# 16 workers each) and config 5p (bench.py:498-530, the same 8 masters as
# server processes), config 5's stream (server_config5_cmds) through the
# port's ClusterRedisson; the ready timeout covers a child's torch import
# and CUDA start
CL_MASTERS, CL_WORKERS, CL_SEED, CL_READY_S = 8, 16, 11, 240


def cluster_reps(client, label: str, card: str, count: bool) -> tuple:
    """One warm rep, then SRV_C5_REPS timed reps of config 5's stream
    through client.execute_many: every probe found, no error reply, and
    with `count` (this process launches the kernels) fewer bloom launches a
    rep than its 128 BF blob commands, so each shard's runs coalesced.
    Returns (the timings, every rep's replies)."""
    from redisson_tpu_torch.core import kernels as K

    rng = np.random.default_rng(CL_SEED)
    bloom = ("bloom_probe", "bloom_set", "bloom_add")
    blob_cmds = 2 * C5_TENANTS
    reps, replies_by_rep = [], []
    for rep in range(SRV_C5_REPS + 1):  # the first rep warms
        cmds, ops = server_config5_cmds(rng, "w" if rep == 0 else f"r{rep}")
        before = dict(K.launches)
        s = time.perf_counter()
        replies = client.execute_many(cmds)
        wall = time.perf_counter() - s
        launched = {k: K.launches[k] - before[k] for k in bloom}
        errors = [r for r in replies if isinstance(r, Exception)]
        if errors:
            raise AssertionError(f"{label}: error replies {errors[:3]}")
        for t, r in enumerate(replies[2 * C5_TENANTS: 3 * C5_TENANTS]):
            if not np.frombuffer(r, np.uint8).all():
                raise AssertionError(f"{label}: false negatives t{t}")
        if count and sum(launched.values()) >= blob_cmds:
            raise AssertionError(f"{label}: {launched} bloom launches for {blob_cmds} BF blob commands: "
                                 "the shards' runs did not coalesce")
        replies_by_rep.append(replies)
        if rep:
            reps.append({"wall_s": wall, "ops_per_s": ops / wall, **({"bloom_launches": launched} if count else {})})
    out = {"ops_per_rep": ops, "reps": reps, "ops_per_s": [r["ops_per_s"] for r in reps]}
    log(f"{label} config5 [{card}]: {SRV_C5_REPS} reps of {len(cmds)} commands ({ops} ops, bench.py's count) "
        f"over {CL_MASTERS} masters, one warm rep first: {', '.join(f'{r:.3e}' for r in out['ops_per_s'])} ops/s; "
        "every probe found" + (f"; bloom launches a rep {reps[-1]['bloom_launches']} for {blob_cmds} BF blob "
                               "commands (each shard's runs coalesced)" if count else ""))
    return out, replies_by_rep


def cluster_moved(runner) -> str:
    """A raw connection to a master that does not own a name's slot gets
    MOVED <slot> <owner>; the owner serves it."""
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.net.resp import RespError
    from redisson_tpu_torch.utils.crc16 import calc_slot

    name = f"bfw{{t{C5_TENANTS - 1}}}"  # a filter of the warm rep
    slot = calc_slot(name.encode())
    owner = next(i for i, (lo, hi) in enumerate(runner.slot_ranges) if lo <= slot <= hi)
    blob = _i8(np.arange((C5_TENANTS - 1) * C5_PER, C5_TENANTS * C5_PER, dtype=np.int64) * 2654435761)
    want = f"MOVED {slot} {runner.masters[owner].address}"
    for i, m in enumerate(runner.masters):
        conn = Connection(m.server.server.host, m.port, timeout=600.0)
        try:
            reply = conn.execute("BF.MEXISTS64", name, blob)
        finally:
            conn.close()
        if i == owner:
            if isinstance(reply, Exception) or not np.frombuffer(reply, np.uint8).all():
                raise AssertionError(f"cluster: the owner of {name} replied {str(reply)[:80]}")
        elif not (isinstance(reply, RespError) and str(reply) == want):
            raise AssertionError(f"cluster: master {i} replied {str(reply)[:80]} for {name}, want {want}")
    return want


def run_cluster(device="cuda") -> dict:
    """The cluster path (config 5): ClusterRunner(masters=8, workers=16) of
    port servers on the card, driven by the port's ClusterRedisson; a MOVED
    from every master that does not own a name; then the same stream on a
    CPU cluster of 8 masters, reply for reply."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.harness import ClusterRunner

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    start = time.perf_counter()
    card = card_line()
    out = {}
    runner = ClusterRunner(masters=CL_MASTERS, workers=CL_WORKERS, device=device).run()
    try:
        landed = {m.server.server.engine.device.type for m in runner.masters}
        if landed != {torch.device(device).type}:
            raise AssertionError(f"cluster: masters on {landed}, not {device}")
        out["startup_s"] = time.perf_counter() - start
        client = runner.client(scan_interval=0, timeout=600.0)
        try:
            out["config5"], got = cluster_reps(client, "cluster", card, device != "cpu")
        finally:
            client.shutdown()
        out["moved"] = cluster_moved(runner)
    finally:
        runner.shutdown()
    launches = dict(K.launches)  # the CPU run below launches none
    s = time.perf_counter()
    cpu = ClusterRunner(masters=CL_MASTERS, workers=CL_WORKERS, device="cpu").run()
    try:
        client = cpu.client(scan_interval=0, timeout=600.0)
        try:
            _, want = cluster_reps(client, "cluster (CPU)", card, False)
        finally:
            client.shutdown()
    finally:
        cpu.shutdown()
    for rep, (g, w) in enumerate(zip(got, want)):
        bad = [i for i, (a, b) in enumerate(zip(g, w)) if not same(a, b)]
        if bad or len(g) != len(w):
            raise AssertionError(f"cluster: rep {rep} replies differ from the CPU cluster's at {bad[:5]}")
    out["card_vs_cpu"] = {"reps": len(got), "replies": sum(len(g) for g in got), "cpu_s": time.perf_counter() - s}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - start
    log(f"cluster path [{card}]: {out['seconds']:.1f}s (startup {out['startup_s']:.1f}s, CPU cluster "
        f"{out['card_vs_cpu']['cpu_s']:.1f}s); {out['card_vs_cpu']['replies']} replies equal to the CPU "
        f"cluster's; a non-owner replies {out['moved']!r}")
    return out


def run_cluster_proc(device="cuda") -> dict:
    """The cluster_proc path (config 5p): ClusterSupervisor(masters=8) of
    server processes (python -m redisson_tpu_torch.server, 16 workers), each
    on the card, config 5's stream through the port's ClusterRedisson, then
    a SIGTERM to each: every exit code 0, every log naming the device it
    served on and the kernels it launched (the path's launches are their
    sum)."""
    from redisson_tpu_torch.cluster import ClusterSupervisor

    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    start = time.perf_counter()
    card = card_line()
    out = {}
    sup = ClusterSupervisor(masters=CL_MASTERS, server_args=("--workers", str(CL_WORKERS)),
                            platform=None if device == "cuda" else device, ready_timeout=CL_READY_S)
    try:
        sup.start()
        out["startup_s"] = time.perf_counter() - start
        client = sup.client(scan_interval=0, timeout=600.0)
        try:
            if not client.wait_routable(timeout=60.0):
                raise AssertionError("cluster_proc: the processes never served every slot")
            out["config5"], _ = cluster_reps(client, "cluster_proc", card, False)
        finally:
            client.shutdown()
        codes = [sup.stop(node, timeout=60.0) for node in sup.masters]
        logs = [sup.log_tail(node, 1 << 16) for node in sup.masters]
    finally:
        sup.shutdown()
    if codes != [0] * CL_MASTERS:
        raise AssertionError(f"cluster_proc: exit codes {codes}\n" + logs[0][-2000:])
    launches, served = {}, set()
    for i, text in enumerate(logs):
        lines = text.splitlines()
        on = [ln.split()[-1] for ln in lines if ln.startswith("serving on ")]
        counts = [json.loads(ln[len("kernel launches "):]) for ln in lines if ln.startswith("kernel launches ")]
        if len(on) != 1 or torch.device(on[0]).type != torch.device(device).type or len(counts) != 1:
            raise AssertionError(f"cluster_proc: m{i} served on {on}, launch lines {len(counts)}:\n{text[-2000:]}")
        served.add(on[0])
        for k, v in counts[0].items():
            launches[k] = launches.get(k, 0) + v
    blob_cmds = 2 * C5_TENANTS * (SRV_C5_REPS + 1)
    bloom = sum(launches.get(k, 0) for k in ("bloom_probe", "bloom_set", "bloom_add"))
    if device != "cpu" and bloom >= blob_cmds:
        raise AssertionError(f"cluster_proc: {bloom} bloom launches for {blob_cmds} BF blob commands: "
                             "the shards' runs did not coalesce")
    out.update(exit_codes=codes, served_on=sorted(served), launches=launches,
               seconds=time.perf_counter() - start)
    log(f"cluster_proc path [{card}]: {out['seconds']:.1f}s (start of {CL_MASTERS} processes "
        f"{out['startup_s']:.1f}s); exit codes {codes}; served on {sorted(served)}; the children's launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    return out


# --------------------------------------------------------------------------
# the sharded path (parallel/): one logical object over the positions of a
# mesh, and a server owning several positions.  Every position is on the
# one card: nothing here measures a collective or a copy across GPUs.
# --------------------------------------------------------------------------

# config 2's bank (bench.py:36) on dp 2 x shard 4 over 8 positions; config
# 3's counters (bench.py:294) tenant-sharded over 4; a 2**28-bit set over 4
# shards (dp 1) with 1M set, get and cardinality operations
SH_DP, SH_SHARD, SH_POSITIONS = 2, 4, 8
SH_C2_ADDS, SH_C2_PROBES = C2_TENANTS * C2_PER_TENANT // C2_FLUSH, 20  # adds fill the bank to its design load
SH_C3_BATCHES = C3_BATCHES
SH_5D_POSITIONS, SH_5D_CONNS, SH_5D_REPS = 4, 8, 2
# the windowed kernels' rows in the kernels line: the TPU-side program each
# windowed form carries (parallel/sharded.py)
SH_WINDOW_REPLACES = {"bloom_probe": "redisson_tpu/parallel/sharded.py:50",
                      "bloom_set": "redisson_tpu/parallel/sharded.py:50",
                      "hll_add": "redisson_tpu/parallel/sharded.py:122",
                      "bitset_get": "redisson_tpu/parallel/sharded.py:173",
                      "bitset_set": "redisson_tpu/parallel/sharded.py:173"}


def window_name(kernel: str) -> str:
    return f"{kernel} window"


def launches_since(before: dict) -> dict:
    """The launches made since `before` (a copy of the counts), by kernel;
    the path's own counts run on."""
    from redisson_tpu_torch.core import kernels as K

    return {k: v - before[k] for k, v in K.launches.items() if v > before[k]}


def sharded_config2(client, card: str, where: str = "one card") -> tuple:
    """Config 2's bank as a ShardedBloomFilterArray beside an unsharded
    BloomFilterArray of the same m and k: 100k-op add flushes, then 100k-op
    contains flushes (half present keys, half absent), flags equal flush by
    flush and the gathered plane equal to the unsharded one.  Returns the
    leg's numbers and, for the window checks, the sharded record."""
    from redisson_tpu_torch.core import kernels as K

    rng = np.random.default_rng(91)
    sbf = client.get_sharded_bloom_filter_array("sh:c2")
    ubf = client.get_bloom_filter_array("sh:c2u")
    if not (sbf.try_init(C2_TENANTS, C2_PER_TENANT, FPP) and ubf.try_init(C2_TENANTS, C2_PER_TENANT, FPP)):
        raise AssertionError("sharded config2: bank exists")
    if (sbf.get_size(), sbf.get_hash_iterations()) != (ubf.get_size(), ubf.get_hash_iterations()):
        raise AssertionError(f"sharded config2: m, k {sbf.get_size(), sbf.get_hash_iterations()} against "
                             f"{ubf.get_size(), ubf.get_hash_iterations()}")
    lat = {"sharded add": [], "unsharded add": [], "sharded contains": [], "unsharded contains": []}
    launches_a_flush = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        s = time.perf_counter()
        got = fn()
        lat[label].append(time.perf_counter() - s)
        return got

    for i in range(SH_C2_ADDS):
        t = rng.integers(0, C2_TENANTS, C2_FLUSH).astype(np.int32)
        ks = rng.integers(0, 1 << 62, C2_FLUSH).astype(np.int64)
        ks[-1000:] = ks[:1000]  # equal keys in one flush: both read the pre-flush plane
        t[-1000:] = t[:1000]
        before = dict(K.launches)
        got = timed("sharded add", lambda: sbf.add_each(t, ks))
        if i == 0:
            launches_a_flush["add"] = launches_since(before)
        want = timed("unsharded add", lambda: ubf.add_each(t, ks))
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded config2: add flush {i} newly flags differ from the unsharded bank's")
    for i in range(SH_C2_PROBES):
        t, ks = config2_flush(rng)
        before = dict(K.launches)
        got = timed("sharded contains", lambda: sbf.contains_each(t, ks))
        if i == 0:
            launches_a_flush["contains"] = launches_since(before)
        want = timed("unsharded contains", lambda: ubf.contains(t, ks))
        if not np.array_equal(got, want):
            raise AssertionError(f"sharded config2: contains flush {i} differs from the unsharded bank's")
    rec = client.engine.store.get("sh:c2")
    assert_equal("sharded config2 plane (gathered) against the unsharded bank",
                 rec.arrays["bits"].gather(), client.engine.store.get("sh:c2u").arrays["bits"])
    out = {"bank": f"{C2_TENANTS}x{sbf.get_size()}, k {sbf.get_hash_iterations()}",
           "mesh": f"dp {SH_DP} x shard {SH_SHARD} over {SH_POSITIONS} positions of {where}",
           "add_flushes": SH_C2_ADDS, "contains_flushes": SH_C2_PROBES, "flush_ops": C2_FLUSH,
           **{f"{k.replace(' ', '_')}_p50_ms": pctl(v, 50) * 1e3 for k, v in lat.items()},
           "launches_a_flush": launches_a_flush}
    log(f"sharded config2 [{card}; {out['mesh']}]: bank {out['bank']}, {SH_C2_ADDS} add and {SH_C2_PROBES} "
        f"contains flushes of {C2_FLUSH} ops: add p50 {out['sharded_add_p50_ms']:.3f} ms (unsharded "
        f"{out['unsharded_add_p50_ms']:.3f} ms), contains p50 {out['sharded_contains_p50_ms']:.3f} ms (unsharded "
        f"{out['unsharded_contains_p50_ms']:.3f} ms); launches a flush {launches_a_flush}; flags and the "
        "gathered plane equal the unsharded bank's")
    ubf.delete()
    return out, rec


def sharded_config3(client, card: str) -> tuple:
    """Config 3's 10,000 counters (p 14) as a ShardedHllArray (tenants over
    4 shards) beside an unsharded HyperLogLogArray: registers equal, and
    estimate_all equal."""
    rng = np.random.default_rng(93)
    sh = client.get_sharded_hll_array("sh:c3")
    un = client.get_hyper_log_log_array("sh:c3u")
    if not (sh.try_init(C3_TENANTS) and un.try_init(C3_TENANTS)):
        raise AssertionError("sharded config3: bank exists")
    lat = {"sharded": [], "unsharded": []}
    for _ in range(SH_C3_BATCHES):
        t = rng.integers(0, C3_TENANTS, C3_BATCH).astype(np.int32)
        ks = rng.integers(0, 1 << 60, C3_BATCH).astype(np.int64)
        for label, fn in (("sharded", lambda: sh.add_each(t, ks)), ("unsharded", lambda: un.add(t, ks))):
            torch.cuda.synchronize()
            s = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat[label].append(time.perf_counter() - s)
    rec = client.engine.store.get("sh:c3")
    assert_equal("sharded config3 registers (gathered) against the unsharded bank",
                 rec.arrays["regs"].gather(), client.engine.store.get("sh:c3u").arrays["regs"])
    got, want = sh.estimate_all(), un.estimate_all()
    if not np.array_equal(got, want):
        raise AssertionError("sharded config3: estimate_all differs from the unsharded bank's")
    out = {"counters": C3_TENANTS, "batches": SH_C3_BATCHES, "batch_ops": C3_BATCH,
           "sharded_add_p50_ms": pctl(lat["sharded"], 50) * 1e3,
           "unsharded_add_p50_ms": pctl(lat["unsharded"], 50) * 1e3}
    log(f"sharded config3 [{card}]: {C3_TENANTS} counters over {SH_SHARD} shards, {SH_C3_BATCHES} batches of "
        f"{C3_BATCH}: add p50 {out['sharded_add_p50_ms']:.3f} ms (unsharded {out['unsharded_add_p50_ms']:.3f} ms); "
        "registers and estimate_all equal the unsharded bank's")
    un.delete()
    return out, rec


def sharded_bitset(client, card: str) -> tuple:
    """One 2**28-bit ShardedBitSet over 4 shards beside an unsharded BitSet:
    1M sets (old bits), 1M gets, cardinality, then 1M clears: equal."""
    rng = np.random.default_rng(95)
    sh = client.get_sharded_bit_set("sh:bits")
    un = client.get_bit_set("sh:bitsu")
    if not sh.try_init(1 << BITMAP_LOG2):
        raise AssertionError("sharded bitset: exists")
    lat = {}

    def both(label, fn_sh, fn_un):
        out = []
        for name, fn in (("sharded " + label, fn_sh), ("unsharded " + label, fn_un)):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out.append(fn())
            lat[name] = (time.perf_counter() - s) * 1e3
        if not np.array_equal(np.asarray(out[0], bool), np.asarray(out[1], bool)):
            raise AssertionError(f"sharded bitset: {label} differs from the unsharded bit set's")
        return out[0]

    idx = host_indexes(rng, BITMAP_OPS, 0, 1 << BITMAP_LOG2)
    both("set", lambda: sh.set_each(idx), lambda: un.set_each(idx))
    both("set again", lambda: sh.set_each(idx[::-1].copy()), lambda: un.set_each(idx[::-1].copy()))
    probe = host_indexes(rng, BITMAP_OPS, 0, 1 << BITMAP_LOG2)
    both("get", lambda: sh.get_each(probe), lambda: un.get_each(probe))
    card_sh, card_un = sh.cardinality(), un.cardinality()
    if card_sh != card_un:
        raise AssertionError(f"sharded bitset: cardinality {card_sh} against {card_un}")
    clear = idx[: BITMAP_OPS // 2]
    both("clear", lambda: sh.set_each(clear, False), lambda: un.set_each(clear, False))
    rec = client.engine.store.get("sh:bits")
    plane = rec.arrays["bits"].gather()
    assert_equal("sharded bitset plane (gathered) against the unsharded one", plane,
                 client.engine.store.get("sh:bitsu").arrays["bits"][: plane.numel()])
    out = {"bits": 1 << BITMAP_LOG2, "ops": BITMAP_OPS, "cardinality": card_sh,
           **{k.replace(" ", "_") + "_ms": v for k, v in lat.items()}}
    log(f"sharded bitset [{card}]: 2**{BITMAP_LOG2} bits over {SH_SHARD} shards, {BITMAP_OPS} sets, gets and "
        f"clears, cardinality {card_sh}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in lat.items())
        + "; old bits, gets, cardinality and the plane equal the unsharded bit set's")
    un.delete()
    return out, rec


def window_keys(batch, d: int, part):
    return batch.keys(d, part.device), batch.valid(d)


def needed_window_positions(part, width, kb, k, m, n_valid, col_lo):
    """Flat positions of `part` that n_valid ops must read to answer a
    windowed probe: each op's owned probes up to and including its first
    0 (another shard's probes read nothing)."""
    from redisson_tpu_torch.core import kernels as K

    size = part.numel()
    g = K._bloom_positions(part, width, kb, k, m, col_lo)[:n_valid]
    inside = g < size
    zero = (inside & (part.reshape(-1)[torch.where(inside, g, 0)] == 0)).to(torch.int32)
    after_a_zero = (torch.cumsum(zero, dim=1) - zero) > 0
    return g[inside & ~after_a_zero]


def check_windows(mgr, c2, c3, bits) -> dict:
    """Each windowed kernel at a non-zero window (shard 1 of 4) on a part of
    the sharded records the path left, at the main path's shapes, against
    its plain version; its time, the plain version's, and its bound: bytes
    at 3.35 TB/s over the 32-byte sectors touched."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.utils import hashing as H

    rng = np.random.default_rng(97)
    out = {}
    s = 1
    # bloom_probe and bloom_set on shard 1's columns of config 2's bank
    plane = c2.arrays["bits"]
    part = plane.parts[0, s]
    w = part.shape[1]
    k, m = c2.meta["k"], c2.meta["m"]
    geom = mgr.geometry()
    batches = []
    for _ in range(8):
        t, ks = config2_flush(rng)
        lo, hi = H.int_keys_to_u32_pair(ks)
        batch, _ = mgr.pad_batch(t, lo, hi, geom)
        batches.append(window_keys(batch, 0, part))
    err = 0.0
    for newly in (False, True):
        for kb, nv in batches[:2]:
            err = max(err, assert_equal(f"bloom_probe window newly={newly}",
                                        K.bloom_probe(part, w, kb, nv, k, m, newly, col_lo=s * w),
                                        K.bloom_probe_plain(part, w, kb, nv, k, m, newly, col_lo=s * w)))
    ms = time_kernel(lambda i: K.bloom_probe(part, w, batches[i % 8][0], batches[i % 8][1], k, m, col_lo=s * w))
    plain = time_plain(lambda i: K.bloom_probe_plain(part, w, batches[i % 8][0], batches[i % 8][1], k, m,
                                                     col_lo=s * w))
    nv = batches[0][1]
    touched = statistics.median(sectors(needed_window_positions(part, w, kb, k, m, n, s * w)) for kb, n in batches)
    bms, by = bound_ms(32 * touched + 12 * nv + nv, nv * (OPS_HASH_U64 + k * OPS_PROBE))
    out["bloom_probe"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                              shape=f"shard 1 of {plane.parts.shape[1]}: ({part.shape[0]}, {w}) columns "
                                    f"[{s * w}, {(s + 1) * w}) of config 2's bank, a dp slice of {nv} ops, k {k}")
    err = 0.0
    for kb, n in batches[:2]:
        a, b = part.clone(), part.clone()
        K.bloom_set(a, w, kb, n, k, m, col_lo=s * w)
        K.bloom_set_plain(b, w, kb, n, k, m, col_lo=s * w)
        err = max(err, assert_equal("bloom_set window", a, b))
    work = part.clone()
    ms = time_kernel(lambda i: K.bloom_set(work, w, batches[i % 8][0], batches[i % 8][1], k, m, col_lo=s * w))
    plain = time_plain(lambda i: K.bloom_set_plain(work, w, batches[i % 8][0], batches[i % 8][1], k, m,
                                                   col_lo=s * w))
    owned = statistics.median(sectors(g[g < part.numel()]) for g in
                              (K._bloom_positions(part, w, kb, k, m, s * w)[:n] for kb, n in batches))
    bms, by = bound_ms(32 * owned + 12 * nv, nv * (OPS_HASH_U64 + k * OPS_PROBE))
    out["bloom_set"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                            shape=out["bloom_probe"]["shape"] + ", stores of every owned probe")
    del work, a, b
    # hll_add on shard 1's rows of config 3's bank
    regs = c3.arrays["regs"]
    part = regs.parts[0, s]
    t_local, width = part.shape
    hb = []
    for _ in range(4):
        t = rng.integers(0, C3_TENANTS, C3_BATCH).astype(np.int32)
        lo, hi = H.int_keys_to_u32_pair(rng.integers(0, 1 << 60, C3_BATCH).astype(np.int64))
        batch, _ = mgr.pad_batch(t, lo, hi, geom)
        hb.append(window_keys(batch, 0, part))
    p = width.bit_length() - 1
    a, b = part.clone(), part.clone()
    for kb, n in hb:
        K.hll_add(a, width, kb, n, p, row_lo=s * t_local)
        K.hll_add_plain(b, width, kb, n, p, row_lo=s * t_local)
    err = assert_equal("hll_add window", a, b)
    ms = time_kernel(lambda i: K.hll_add(a, width, hb[i % 4][0], hb[i % 4][1], p, row_lo=s * t_local))
    plain = time_plain(lambda i: K.hll_add_plain(b, width, hb[i % 4][0], hb[i % 4][1], p, row_lo=s * t_local))
    kb, n = hb[0]
    h1, _ = K._hash(kb)
    r = kb.tenant.to(torch.int64)[:n] - s * t_local
    own = (r >= 0) & (r < t_local)
    read = sectors((r * width + (h1[:n] & (width - 1)).to(torch.int64))[own])
    # a register is written only where the rank raises it: at most every
    # sector read; the bound counts the reads and the op words
    bms, by = bound_ms(32 * read + 12 * n, n * (OPS_HASH_U64 + OPS_HLL_ADD))
    out["hll_add"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                          shape=f"shard 1 of {regs.parts.shape[1]}: rows [{s * t_local}, {(s + 1) * t_local}) "
                                f"of config 3's bank, a dp slice of {n} ops (owned: {int(own.sum())})")
    del a, b
    # bitset_get and bitset_set on shard 1's bits of the 2**28-bit set
    plane = bits.arrays["bits"]
    part = plane.parts[0, s]
    size = part.numel()
    ib = [K.stage(host_indexes(rng, BITMAP_OPS, 0, 1 << BITMAP_LOG2).astype(np.int32), part.device)
          for _ in range(4)]
    err = max(assert_equal("bitset_get window", K.bitset_get(part, i, lo=s * size),
                           K.bitset_get_plain(part, i, lo=s * size)) for i in ib)
    ms = time_kernel(lambda i: K.bitset_get(part, ib[i % 4], lo=s * size))
    plain = time_plain(lambda i: K.bitset_get_plain(part, ib[i % 4], lo=s * size))
    local = ib[0].to(torch.int64) - s * size
    owned = sectors(local[(local >= 0) & (local < size)])
    bms, by = bound_ms(32 * owned + 5 * BITMAP_OPS, BITMAP_OPS * 4)
    out["bitset_get"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                             shape=f"shard 1 of {plane.parts.shape[1]}: bits [{s * size}, {(s + 1) * size}) of "
                                   f"the 2**{BITMAP_LOG2}-bit set, {BITMAP_OPS} indexes over the whole set")
    err = 0.0
    for i in ib[:2]:
        a, b = part.clone(), part.clone()
        got, want = K.bitset_set(a, i, BITMAP_OPS, 1, lo=s * size)[1], K.bitset_set_plain(b, i, BITMAP_OPS, 1,
                                                                                          lo=s * size)[1]
        err = max(err, assert_equal("bitset_set window old bits", got, want), assert_equal("bitset_set window", a, b))
    del a, b

    def owned_sectors(i):
        local = i.to(torch.int64) - s * size
        return sectors(local[(local >= 0) & (local < size)])

    # a stream of 20 new batches, each on the part the batches before it
    # left (a bit already set is not written again); the write is bound by
    # the owned sectors read and the sectors changed
    stream = ib + [K.stage(host_indexes(rng, BITMAP_OPS, 0, 1 << BITMAP_LOG2).astype(np.int32), part.device)
                   for _ in range(16)]
    ms, plain, nbytes, stream_err = time_stream(
        "bitset_set window", lambda pl, i: K.bitset_set(pl, i, BITMAP_OPS, 1, lo=s * size),
        lambda pl, i: K.bitset_set_plain(pl, i, BITMAP_OPS, 1, lo=s * size), part.clone(), part.clone(), stream,
        lambda i, changed: 32 * (owned_sectors(i) + sectors(changed)) + 5 * BITMAP_OPS)
    bms, by = bound_ms(nbytes, BITMAP_OPS * 4)
    out["bitset_set"] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=max(err, stream_err),
                             shape=out["bitset_get"]["shape"] + ", a stream of 20 batches")
    del stream
    for name, v in out.items():
        v["library_ms"] = None  # no one PyTorch call computes a shard's windowed form
        log(f"kernel {window_name(name)}: {v['ms']:.4f} ms (plain {v['plain_ms']:.3f} ms, bound "
            f"{v['bound_ms']:.4f} ms by {v['bound_by']}); equal to plain at {v['shape']}")
    return {window_name(k): v for k, v in out.items()}


def c5d_leg(device, n_positions: int, card: str) -> dict:
    """Config 5's stream (bench.py:636-734's config 5d) against one server
    with placement on `n_positions` positions of the card: SH_5D_CONNS
    connections at once, each a share of the tenants, a warm rep then
    SH_5D_REPS timed reps; the replies in command order."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server.server import ServerThread

    st = ServerThread(port=0, devices=n_positions, workers=16, device=device).start()
    conns = [Connection(st.server.host, st.port, timeout=600.0) for _ in range(SH_5D_CONNS)]
    try:
        eng = st.server.engine
        if ioplane.replica_occupancy() is not None:
            raise AssertionError("config5d: the modelled occupancy is armed on the card")
        rng = np.random.default_rng(CL_SEED)
        rates, replies_by_rep = [], []
        for rep in range(SH_5D_REPS + 1):  # the first rep warms
            cmds, ops = server_config5_cmds(rng, "w" if rep == 0 else f"r{rep}")
            slices = [[] for _ in range(SH_5D_CONNS)]
            for i, c in enumerate(cmds):
                key = next(a for a in c[1:] if isinstance(a, str) and "{t" in a)
                slices[int(key.split("{t")[1].rstrip("}")) % SH_5D_CONNS].append(i)
            replies = [None] * len(cmds)
            errs = []
            start = threading.Barrier(SH_5D_CONNS + 1)

            def worker(j):
                try:
                    start.wait()
                    for i, r in zip(slices[j], conns[j].execute_many([cmds[i] for i in slices[j]])):
                        replies[i] = r
                except Exception as e:  # noqa: BLE001 — raised below
                    errs.append(e)

            threads = [threading.Thread(target=worker, args=(j,), daemon=True) for j in range(SH_5D_CONNS)]
            for th in threads:
                th.start()
            eng.lanes.reset_concurrency()
            start.wait()
            s = time.perf_counter()
            for th in threads:
                th.join()
            wall = time.perf_counter() - s
            if errs:
                raise errs[0]
            bad = [r for r in replies if isinstance(r, Exception)]
            if bad:
                raise AssertionError(f"config5d: error replies {bad[:3]}")
            for t, r in enumerate(replies[2 * C5_TENANTS: 3 * C5_TENANTS]):
                if not np.frombuffer(r, np.uint8).all():
                    raise AssertionError(f"config5d: false negatives t{t}")
            replies_by_rep.append(replies)
            if rep:
                rates.append(ops / wall)
        peak = eng.lanes.reset_concurrency()
        dispatches = {lane.dev_id: lane.dispatches for lane in eng.lanes.lanes()}
    finally:
        for c in conns:
            c.close()
        st.stop()
    return {"positions": n_positions, "ops_per_s": rates, "peak_lane_concurrency": peak,
            "lane_dispatches": dispatches, "replies": replies_by_rep}


def sharded_config5d(device, card: str) -> dict:
    """Config 5d's A/B: one server with placement on 1 position against one
    on SH_5D_POSITIONS positions, all of the one card; replies bit-identical."""
    one = c5d_leg(device, 1, card)
    many = c5d_leg(device, SH_5D_POSITIONS, card)
    for rep, (a, b) in enumerate(zip(one["replies"], many["replies"])):
        bad = [i for i, (x, y) in enumerate(zip(a, b)) if not same(x, y)]
        if bad or len(a) != len(b):
            raise AssertionError(f"config5d: rep {rep} replies differ between the legs at {bad[:5]}")
    out = {}
    for leg in (one, many):
        leg.pop("replies")
        out[f"{leg['positions']}_positions"] = leg
        log(f"config5d [{card}; {leg['positions']} position(s), all on the one card: no multi-GPU result]: "
            f"{', '.join(f'{r:.3e}' for r in leg['ops_per_s'])} ops/s, peak lane concurrency "
            f"{leg['peak_lane_concurrency']}, lane dispatches {leg['lane_dispatches']}")
    out["replies_bit_identical"] = True
    log("config5d: the two legs' replies are bit-identical")
    return out


def run_sharded(device="cuda") -> dict:
    """The sharded path: config 2's bank, config 3's counters and a
    2**28-bit set sharded over positions of the card beside their unsharded
    counterparts, dryrun_multichip (the live reshard), config 5d's A/B; the
    path's launch counts are read before the window checks, which follow."""
    import redisson_tpu_torch
    from redisson_tpu_torch import graft_entry
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.parallel.manager import MeshManager

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    cfg = Config()
    cfg.mesh.dp, cfg.mesh.shard, cfg.mesh.n_devices = SH_DP, SH_SHARD, SH_POSITIONS
    client = redisson_tpu_torch.create(cfg, device)
    out = {}
    try:
        mgr = MeshManager.of(client.engine)
        landed = {str(p.device) for p in mgr.mesh.devices.flat}
        if len(landed) != 1 or torch.device(device).type not in next(iter(landed)):
            raise AssertionError(f"sharded: positions on {landed}")
        out["config2"], c2 = sharded_config2(client, card)
        out["config3"], c3 = sharded_config3(client, card)
        mgr.reshard(1, SH_SHARD)  # the bit set: 4 shards, no dp replica
        out["bitset"], bits = sharded_bitset(client, card)
        out["dryrun_multichip"] = graft_entry.dryrun_multichip(SH_POSITIONS, device)
        out["config5d"] = sharded_config5d(device, card)
        out["launches"] = dict(K.launches)
        out["window_launches"] = dict(K.window_launches)
        missing = [k for k, v in out["window_launches"].items() if v == 0]
        if missing:
            raise AssertionError(f"sharded: the path never launched the windowed {missing}")
        mgr.reshard(SH_DP, SH_SHARD)
        out["kernels"] = check_windows(mgr, c2, c3, bits)
    finally:
        client.shutdown()
        if device != "cpu":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    log(f"sharded path [{card}]: {out['seconds']:.1f}s; window launches {out['window_launches']}")
    return out


# --------------------------------------------------------------------------
# the qos path: config 2q's preempt leg and the fleet rebalancer
# --------------------------------------------------------------------------

# bench.py:1440-1445's shape: frames of 6 BF.MADD64 of 20,000 keys, a
# 20,000-item sub-window (one command a chunk), a 64-key interactive probe
QS_CMDS, QS_KEYS, QS_SUB_ITEMS, QS_INT_KEYS = 6, 20_000, 20_000, 64
QS_FRAMES, QS_BULK_CONNS = 30, 2  # frames a bulk connection: the stream is fixed
QS_MASTERS, QS_RATE, QS_SWEEPS = 8, 100_000.0, 3


def qos_bulk_frames(conn_index: int) -> list:
    """The bulk frames of one connection: its own filters, new keys a frame
    (so the newly-added flags are the stream's, whatever the timing)."""
    frames = []
    for f in range(QS_FRAMES):
        base = (conn_index * QS_FRAMES + f) * QS_KEYS
        blob = _i8((np.arange(QS_KEYS, dtype=np.int64) + base) * 2654435761)
        frames.append([("BF.MADD64", f"q2q:b{conn_index}.{i}{{qq}}", blob) for i in range(QS_CMDS)])
    return frames


def qos_leg(device, armed: bool) -> dict:
    """One leg of config 2q's preempt A/B on a devices=1 server: QS_BULK_CONNS
    bulk connections each send their QS_FRAMES frames while an interactive
    connection probes QS_INT_KEYS keys in a loop; the replies, the probe
    latencies, the lane's preemptions and its bulk dispatches."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server.server import ServerThread

    prev = ioplane.set_preempt(armed)
    st = ServerThread(port=0, devices=1, workers=4, device=device).start()
    conns, stop = [], threading.Event()
    try:
        host, port = st.server.host, st.server.port
        admin = Connection(host, port, timeout=600.0)
        conns.append(admin)
        setup = [("CONFIG", "SET", "qos-bulk-subwindow-items", str(QS_SUB_ITEMS)),
                 ("BF.RESERVE", "q2q:int{qq}", "0.01", "10000"),
                 ("BF.MADD64", "q2q:int{qq}", _i8(np.arange(QS_INT_KEYS, dtype=np.int64) * 40503))]
        setup += [("BF.RESERVE", f"q2q:b{c}.{i}{{qq}}", "0.01", str(QS_FRAMES * QS_KEYS))
                  for c in range(QS_BULK_CONNS) for i in range(QS_CMDS)]
        replies = {"setup": admin.execute_many(setup)}
        lane = st.server.engine.lanes.lanes()[0]
        probe = ("BF.MEXISTS64", "q2q:int{qq}", _i8(np.arange(QS_INT_KEYS, dtype=np.int64) * 40503))
        samples, probes, errors = [], [], []
        before = lane.dispatches

        def bulk(c: int):
            try:
                conn = Connection(host, port, timeout=600.0)
                conns.append(conn)
                conn.execute("CLIENT", "QOS", "CLASS", "bulk")
                replies[f"bulk{c}"] = [conn.execute_many(fr, timeout=600.0) for fr in qos_bulk_frames(c)]
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        def interactive():
            try:
                conn = Connection(host, port, timeout=600.0)
                conns.append(conn)
                conn.execute("CLIENT", "QOS", "CLASS", "interactive")
                while not stop.is_set():
                    s = time.perf_counter()
                    probes.append(conn.execute(*probe, timeout=600.0))
                    samples.append(time.perf_counter() - s)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        it = threading.Thread(target=interactive, daemon=True)
        it.start()
        bulks = [threading.Thread(target=bulk, args=(c,), daemon=True) for c in range(QS_BULK_CONNS)]
        s = time.perf_counter()
        for th in bulks:
            th.start()
        for th in bulks:
            th.join()
        wall = time.perf_counter() - s
        stop.set()
        it.join(60)
        if errors:
            raise errors[0]
        if len(set(probes)) != 1 or not np.frombuffer(probes[0], np.uint8).all():
            raise AssertionError("qos: an interactive probe missed a present key")
        bulk_dispatches = lane.dispatches - before - len(probes)
        frames = QS_FRAMES * QS_BULK_CONNS
        out = {"armed": armed, "interactive_ops": len(samples),
               "interactive_p50_ms": pctl(samples, 50) * 1e3, "interactive_p99_ms": pctl(samples, 99) * 1e3,
               "preemptions": lane.preemptions, "bulk_dispatches": bulk_dispatches,
               "bulk_frames": frames, "bulk_wall_s": wall, "replies": replies, "probe": probes[0]}
        if armed and bulk_dispatches < 2 * frames:
            raise AssertionError(f"qos: {bulk_dispatches} bulk dispatches for {frames} frames armed")
        if not armed and lane.preemptions:
            raise AssertionError("qos: a disarmed lane yielded")
        return out
    finally:
        stop.set()
        for c in conns:
            with contextlib.suppress(Exception):
                c.close()
        st.stop()
        ioplane.set_preempt(prev)
        ioplane.set_bulk_subwindow_items(0)


def qos_stream_replies(device) -> dict:
    """The qos legs' stream on one connection a bulk sender, in order, on a
    server on `device` (the CPU's replies to hold the card's to)."""
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server.server import ServerThread

    with ServerThread(port=0, devices=1, workers=4, device=device) as st:
        conn = Connection(st.server.host, st.server.port, timeout=600.0)
        try:
            setup = [("CONFIG", "SET", "qos-bulk-subwindow-items", str(QS_SUB_ITEMS)),
                     ("BF.RESERVE", "q2q:int{qq}", "0.01", "10000"),
                     ("BF.MADD64", "q2q:int{qq}", _i8(np.arange(QS_INT_KEYS, dtype=np.int64) * 40503))]
            setup += [("BF.RESERVE", f"q2q:b{c}.{i}{{qq}}", "0.01", str(QS_FRAMES * QS_KEYS))
                      for c in range(QS_BULK_CONNS) for i in range(QS_CMDS)]
            out = {"setup": conn.execute_many(setup)}
            for c in range(QS_BULK_CONNS):
                out[f"bulk{c}"] = [conn.execute_many(fr, timeout=600.0) for fr in qos_bulk_frames(c)]
            return out
        finally:
            conn.close()


def qos_fleet(device, card: str) -> dict:
    """QS_SWEEPS QosRebalancer sweeps over an 8-master ClusterRunner on the
    card: one tenant's demand, skewed by master (master i gets i + 1 frames
    a sweep through its own CLIENT QOS TENANT connection), pushed splits
    summing to the global rate."""
    from contextlib import closing

    from redisson_tpu_torch.cluster.qos_control import QosRebalancer
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.utils.crc16 import calc_slot

    runner = ClusterRunner(masters=QS_MASTERS, workers=4, device=device).run()
    conns = []
    try:
        def factory(m):
            return lambda: closing(Connection(m.server.server.host, m.server.server.port, timeout=600.0))

        rb = QosRebalancer({m.address: factory(m) for m in runner.masters}, QS_RATE)
        names, j = {}, 0
        while len(names) < QS_MASTERS:  # a filter a master, on a slot it owns
            name = f"q2q:fleet{j}"
            owner = next(i for i, m in enumerate(runner.masters)
                         if m.server.server.owns_slot(calc_slot(name.encode())))
            names.setdefault(owner, name)
            j += 1
        for i, m in enumerate(runner.masters):
            conn = Connection(m.server.server.host, m.server.server.port, timeout=600.0)
            conns.append(conn)
            conn.execute("CLIENT", "QOS", "TENANT", "acme")
            conn.execute("BF.RESERVE", names[i], "0.01", "1000000")
        pushed = [rb.step()]
        for sweep in range(1, QS_SWEEPS):
            for i, conn in enumerate(conns):
                for f in range(i + 1):
                    conn.execute("BF.MADD64", names[i],
                                 _i8(np.arange(2000, dtype=np.int64) + 10_000 * (sweep * 64 + f)))
            pushed.append(rb.step())
        if pushed[0] != {}:
            raise AssertionError(f"qos fleet: the baseline sweep pushed {pushed[0]}")
        for split in (p["acme"] for p in pushed[1:]):
            if set(split) != {m.address for m in runner.masters} or abs(sum(split.values()) - QS_RATE) > 1e-6 * QS_RATE:
                raise AssertionError(f"qos fleet: split {split} does not sum to {QS_RATE} over the masters")
        last = pushed[-1]["acme"]
        by_master = [last[m.address] for m in runner.masters]
        if by_master != sorted(by_master):
            raise AssertionError(f"qos fleet: the split {by_master} does not follow the demand")
        rates = [m.server.server.scheduler._tenants["acme"].bucket.rate for m in runner.masters]
        if any(abs(r - s) > 1e-6 * QS_RATE for r, s in zip(rates, by_master)):
            raise AssertionError("qos fleet: a master's bucket is not its pushed rate")
        log(f"qos fleet [{card}]: {QS_SWEEPS} sweeps over {QS_MASTERS} masters, last split "
            + ", ".join(f"{r:.0f}" for r in by_master) + f" (sum {sum(by_master):.3f} of {QS_RATE:.0f})")
        return {"sweeps": rb.sweeps, "push_errors": rb.push_errors, "last_split": by_master}
    finally:
        for c in conns:
            c.close()
        runner.shutdown()


def run_qos(device="cuda") -> dict:
    """The qos path: config 2q's preempt leg (bench.py:1409-1560) armed and
    disarmed on a devices=1 server on the card, replies equal between the
    legs and to a CPU server's on the same stream; the interactive p50 and
    p99 and the lane's preemptions printed (this path claims no speed);
    then the fleet rebalancer over 8 masters on the card."""
    from redisson_tpu_torch.core import kernels as K

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    armed = qos_leg(device, True)
    disarmed = qos_leg(device, False)
    for key in armed["replies"]:
        if not all(same(a, b) for a, b in zip(armed["replies"][key], disarmed["replies"][key])):
            raise AssertionError(f"qos: the {key} replies differ between the armed and disarmed legs")
    cpu = qos_stream_replies("cpu")
    for key, want in cpu.items():
        got = armed["replies"][key]
        if len(got) != len(want) or not all(same(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"qos: the {key} replies differ from the CPU server's")
    out = {}
    for leg in (armed, disarmed):
        leg.pop("replies")
        leg.pop("probe")
        name = "armed" if leg["armed"] else "disarmed"
        out[name] = leg
        log(f"qos {name} [{card}]: interactive p50 {leg['interactive_p50_ms']:.3f} ms, p99 "
            f"{leg['interactive_p99_ms']:.3f} ms over {leg['interactive_ops']} probes; "
            f"{leg['bulk_dispatches']} bulk dispatches for {leg['bulk_frames']} frames, "
            f"{leg['preemptions']} preemptions; bulk wall {leg['bulk_wall_s']:.2f} s")
    out["fleet"] = qos_fleet(device, card)
    out["launches"] = dict(K.launches)  # the CPU server above launches none
    out["seconds"] = time.perf_counter() - start
    log(f"qos path [{card}]: {out['seconds']:.1f}s; the legs' replies equal each other and the CPU server's")
    return out


# --------------------------------------------------------------------------
# the sharded_vector path: config 7s
# --------------------------------------------------------------------------

# bench.py:2076-2077: 40,000 x 64 float32, COSINE, k 10, stacked batches of
# 64, a 64-query float64 oracle; FLAT at SHARDS 1 and 8 over 8 positions of
# the card, and one IVF cell (8 shards)
SV7_N, SV7_D, SV7_K, SV7_QB, SV7_ORACLE, SV7_MEASURE_S = 40_000, 64, 10, 64, 64, 1.5
SV7_SHARDS, SV7_IVF = 8, {"algo": "IVF", "nlist": 32, "nprobe": 8}


def sv7_leg(svc, name: str, spec: dict, vecs, queries, oracle_q, truth, card: str) -> dict:
    from redisson_tpu_torch.core import ioplane

    svc.create_index(name, {"emb": "VECTOR"},
                     vector={"emb": dict(spec, dim=SV7_D, metric="COSINE")})
    s = time.perf_counter()
    for i in range(SV7_N):
        svc.add_document(name, f"d{i}", {"emb": vecs[i]})
    ingest_s = time.perf_counter() - s
    dev, fin = svc.knn(name, "emb", queries, SV7_K)  # flush (and train) outside the clock
    fin(dev)
    merges = ioplane.STATS.snapshot()["sharded_knn_merges"]
    done, s = 0, time.perf_counter()
    while time.perf_counter() - s < SV7_MEASURE_S:
        dev, fin = svc.knn(name, "emb", queries, SV7_K)
        fin(dev)
        done += SV7_QB
    qps = done / (time.perf_counter() - s)
    dev, fin = svc.knn(name, "emb", oracle_q, SV7_K)
    raw = tuple(v.clone() for v in dev)
    got = fin(dev)
    merges = ioplane.STATS.snapshot()["sharded_knn_merges"] - merges
    hits = sum(len(truth[i] & {int(doc[1:]) for doc, _s in got[i][:SV7_K]}) for i in range(SV7_ORACLE))
    bank = svc._idx(name).vectors.banks["emb"]
    row = {"shards": spec.get("shards", 1), "algo": spec.get("algo", "FLAT"), "knn_qps": qps,
           "recall_at_10": hits / (SV7_K * SV7_ORACLE), "ingest_s": ingest_s, "merges": merges,
           "bank_device_bytes": bank.device_bytes(),
           "bytes_by_position": {str(d): b for d, b in sorted(bank.device_bytes_by_device().items())}}
    log(f"config7s {name} [{card}]: {qps:.1f} qps (batches of {SV7_QB}), recall@10 {row['recall_at_10']:.4f}, "
        f"ingest {ingest_s:.1f}s, {merges} sharded merges, bytes by position {row['bytes_by_position']}")
    return row, got, raw


def k19_times(dev, card: str) -> dict:
    """K19 alone at its main-path shape: 8 legs of (64, 10), sorted as a
    shard's top-k is, merged to k 10 over the (64, 80) concatenation, beside
    its plain version, torch.topk on the concatenation (the library call)
    and its bound (the legs' distances and ids read once, the three (64, 10)
    outputs written once; a compare an entry)."""
    from redisson_tpu_torch.core import kernels as K

    rng = np.random.default_rng(19)
    dists = [torch.from_numpy(np.sort(rng.standard_normal((SV7_QB, SV7_K)).astype(np.float32), axis=1)).to(dev)
             for _ in range(SV7_SHARDS)]
    idxs = [torch.from_numpy(rng.integers(0, SV7_N, (SV7_QB, SV7_K)).astype(np.int32)).to(dev)
            for _ in range(SV7_SHARDS)]
    sop = torch.arange(SV7_SHARDS, dtype=torch.int32, device=dev).repeat_interleave(SV7_K)
    got = K.knn_sharded_merge(dists, idxs, sop, SV7_K)
    want = K.knn_sharded_merge_plain(dists, idxs, sop, SV7_K)
    err = max(assert_equal(f"K19 {n}", g, w) for n, g, w in zip(("dist", "shard", "local"), got, want))
    cat = torch.cat(dists, dim=1)
    total = SV7_SHARDS * SV7_K
    t = {"max_abs_err": err,
         "ms": time_kernel(lambda i: K.knn_sharded_merge(dists, idxs, sop, SV7_K)),
         "plain_ms": time_plain(lambda i: K.knn_sharded_merge_plain(dists, idxs, sop, SV7_K)),
         "library_ms": time_kernel(lambda i: torch.topk(cat, SV7_K, dim=1, largest=False)),
         "select_ms": time_kernel(lambda i: K.knn_select(cat, SV7_K))}
    t["bound_ms"], t["bound_by"] = bound_ms(8 * SV7_QB * total + 12 * SV7_QB * SV7_K, SV7_QB * total)
    log(f"K19 (64, {total}) k {SV7_K} [{card}]: {t['ms']:.4f} ms (knn_select alone {t['select_ms']:.4f}), "
        f"plain {t['plain_ms']:.4f}, torch.topk {t['library_ms']:.4f}, bound {t['bound_ms']:.6f} ms")
    return t


def run_sharded_vector(device="cuda") -> dict:
    """The sharded_vector path: config 7s (bench.py:2034-2200) on 8
    positions of the card, FLAT at SHARDS 1 and 8 (ids equal outside near
    ties, recall@10 >= 0.99 against the float64 oracle), one IVF cell at
    SHARDS 8 with its recall, then K19 timed alone."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.core.engine import Engine
    from redisson_tpu_torch.services.search import SearchService

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    rng = np.random.default_rng(73)
    vecs = rng.standard_normal((SV7_N, SV7_D)).astype(np.float32)
    queries = rng.standard_normal((SV7_QB, SV7_D)).astype(np.float32)
    oracle_q = rng.standard_normal((SV7_ORACLE, SV7_D)).astype(np.float32)
    q64, v64 = oracle_q.astype(np.float64), vecs.astype(np.float64)
    dist64 = 1.0 - (q64 @ v64.T) / (np.linalg.norm(q64, axis=1)[:, None] * np.linalg.norm(v64, axis=1)[None, :])
    truth = [set(np.argsort(dist64[i], kind="stable")[:SV7_K].tolist()) for i in range(SV7_ORACLE)]
    eng = Engine(device=device)
    eng.enable_placement(n_devices=SV7_SHARDS)
    io_before = ioplane.STATS.snapshot()
    out = {}
    try:
        svc = SearchService(eng)
        out["flat_1"], got1, raw1 = sv7_leg(svc, "v7s_1", {"shards": 1}, vecs, queries, oracle_q, truth, card)
        merges = ioplane.STATS.snapshot()["sharded_knn_merges"]
        out["flat_8"], got8, raw8 = sv7_leg(svc, "v7s_8", {"shards": SV7_SHARDS}, vecs, queries, oracle_q,
                                            truth, card)
        out["ivf_8"], _, _ = sv7_leg(svc, "v7s_ivf", dict(SV7_IVF, shards=SV7_SHARDS), vecs, queries, oracle_q,
                                     truth, card)
        out["k19_merges"] = ioplane.STATS.snapshot()["sharded_knn_merges"] - merges
        launches = dict(K.launches)
        for leg in ("flat_1", "flat_8"):
            if out[leg]["recall_at_10"] < 0.99:
                raise AssertionError(f"config7s {leg}: recall@10 {out[leg]['recall_at_10']} < 0.99")
        if out["flat_1"]["merges"] or not out["flat_8"]["merges"]:
            raise AssertionError("config7s: merges on the 1-shard leg or none on the 8-shard leg")
        # ids: the 1-shard leg's rows against the 8-shard leg's global rowids
        ids8 = torch.from_numpy(svc._idx("v7s_8").vectors.banks["emb"].resolve_hits(raw8)[1])
        ids1 = raw1[1].cpu()
        d1 = raw1[0].cpu()
        out["ids_compared"] = assert_ids_outside_near_ties("config7s 8 shards", ids8[:SV7_ORACLE],
                                                           ids1[:SV7_ORACLE], d1[:SV7_ORACLE])
        if [[d for d, _s in r] for r in got1] != [[d for d, _s in r] for r in got8]:
            log("config7s: the doc lists differ between 1 and 8 shards at near ties only")
        out["host_colocations"] = ioplane.STATS.snapshot()["host_colocations"] - io_before["host_colocations"]
        if out["host_colocations"]:
            raise AssertionError("config7s: a sharded merge went through the host")
        for name in ("v7s_1", "v7s_8", "v7s_ivf"):
            svc.drop_index(name)
    finally:
        eng.shutdown()
        if device != "cpu":
            torch.cuda.empty_cache()
    out["launches"] = launches
    out["k19"] = k19_times(torch.device(device), card) if device != "cpu" else {}
    out["seconds"] = time.perf_counter() - start
    log(f"sharded_vector path [{card}]: {out['seconds']:.1f}s; FLAT 1 shard {out['flat_1']['knn_qps']:.1f} qps, "
        f"8 shards {out['flat_8']['knn_qps']:.1f} qps, IVF 8 shards recall@10 "
        f"{out['ivf_8']['recall_at_10']:.4f}; {out['ids_compared']} ids equal outside near ties; "
        f"{out['k19_merges']} K19 merges")
    return out


# --------------------------------------------------------------------------
# the durability path: checkpoints, DUMP/RESTORE/COPY, SAVE and --restore
# --------------------------------------------------------------------------

# config 2's bank (C2_*) and config 3's counters (C3_*) saved and loaded;
# over the wire one filter of DU_WIRE_KEYS keys and one HLL of as many
DU_WIRE_KEYS = 100_000


def _same_tensor(label: str, got, want) -> None:
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"{label}: not equal bit for bit")


def durability_wire(dev, wdir: str, card: str) -> dict:
    """DUMP, RESTORE and COPY of one bloom filter and one HLL on a one-master
    ClusterSupervisor whose node serves devices=1 on the card with its
    checkpoint path, then SAVE, one more write, SHUTDOWN SAVE and the
    supervisor's restart with --restore: the same replies come back, and
    the write made after SAVE proves the SHUTDOWN SAVE generation loaded."""
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    # one hash tag: COPY's two keys share a slot on a cluster node
    keys = (np.arange(DU_WIRE_KEYS, dtype=np.int64) * 2654435761) ^ 0x5DEECE66D
    probe = np.concatenate([keys[::2], keys[::2] + 1])
    reads = [("BF.MEXISTS64", "{du}:bf", _i8(probe)), ("PFCOUNT", "{du}:hll"),
             ("BF.MEXISTS64", "{du}:bf:r", _i8(probe)), ("PFCOUNT", "{du}:hll:r"),
             ("BF.MEXISTS64", "{du}:bf:c", _i8(probe)), ("PFCOUNT", "{du}:hll:c")]
    sup = ClusterSupervisor(masters=1, base_dir=os.path.join(wdir, "fleet"), server_args=["--devices", "1"],
                            platform="cpu" if dev == "cpu" else None, ready_timeout=300.0).start()
    try:
        node = sup.masters[0]
        path = node.checkpoint_path
        with sup.conn(node, timeout=600.0) as conn:
            setup = conn.execute_many([("BF.RESERVE", "{du}:bf", "0.01", str(4 * DU_WIRE_KEYS)),
                                       ("BF.MADD64", "{du}:bf", _i8(keys)), ("PFADD64", "{du}:hll", _i8(keys))])
            if setup[0] != b"OK":
                raise AssertionError(f"durability wire: setup {setup[0]!r}")
            s = time.perf_counter()
            blobs = conn.execute_many([("DUMP", "{du}:bf"), ("DUMP", "{du}:hll")])
            dump_ms = (time.perf_counter() - s) * 1e3
            s = time.perf_counter()
            restored = conn.execute_many([("RESTORE", "{du}:bf:r", "0", blobs[0]),
                                          ("RESTORE", "{du}:hll:r", "0", blobs[1]),
                                          ("COPY", "{du}:bf", "{du}:bf:c"), ("COPY", "{du}:hll", "{du}:hll:c")])
            restore_copy_ms = (time.perf_counter() - s) * 1e3
            if restored != [b"OK", b"OK", 1, 1]:
                raise AssertionError(f"durability wire: RESTORE/COPY replied {restored}")
            got = conn.execute_many(reads)
            if not (got[0] == got[2] == got[4] and got[1] == got[3] == got[5]):
                raise AssertionError("durability wire: a restored or copied object answers otherwise")
            if not np.frombuffer(got[0], np.uint8)[: len(keys) // 2].all():
                raise AssertionError("durability wire: a present key was not found")
            if conn.execute("SAVE") != b"OK":
                raise AssertionError("durability wire: SAVE")
            # only SHUTDOWN SAVE's generation holds this key
            if conn.execute("SET", "{du}:late", "after-save") != b"OK":
                raise AssertionError("durability wire: SET after SAVE")
            try:
                reply = conn.execute("SHUTDOWN", "SAVE")
            except (ConnectionError, EOFError):
                reply = b"OK"  # the server closed the connection as it stopped
            if reply != b"OK":
                raise AssertionError(f"durability wire: SHUTDOWN SAVE replied {reply!r}")
        rc = sup.wait_exit(node, 60.0)
        if rc != 0:
            raise AssertionError(f"durability wire: SHUTDOWN SAVE exit {rc}: {sup.log_tail(node)!r}")
        if not os.path.exists(path) or not os.path.exists(path + ".1"):
            raise AssertionError("durability wire: SAVE and SHUTDOWN SAVE left no two generations")
        s = time.perf_counter()
        sup.restart(node)
        boot_s = time.perf_counter() - s
        with sup.conn(node, timeout=600.0) as conn:
            again = conn.execute_many(reads + [("GET", "{du}:late")])
        text = sup.log_tail(node, 1 << 16)
    finally:
        sup.shutdown()
    if again[:-1] != got:
        raise AssertionError("durability wire: the restarted server answers otherwise")
    if again[-1] != b"after-save":
        raise AssertionError(f"durability wire: the restart did not load SHUTDOWN SAVE's generation: {again[-1]!r}")
    if f"serving on {dev}" not in text or "restored 7 records" not in text:
        raise AssertionError(f"durability wire: restart log {text[-1000:]!r}")
    out = {"dump_ms": dump_ms, "restore_copy_ms": restore_copy_ms, "blob_bytes": [len(b) for b in blobs],
           "restart_with_restore_s": boot_s, "shutdown_exit": rc}
    log(f"durability wire [{card}]: DUMP of a {DU_WIRE_KEYS}-key filter and an HLL {dump_ms:.1f} ms "
        f"({out['blob_bytes'][0]} and {out['blob_bytes'][1]} bytes), RESTORE and COPY of both "
        f"{restore_copy_ms:.1f} ms; SAVE, a write, SHUTDOWN SAVE (exit {rc}), and the supervisor's restart "
        f"with --restore in {boot_s:.1f} s answering the same and the write")
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def allocated() -> int:
    """torch.cuda.memory_allocated once the blocks freed behind other
    streams' work are settled: a tensor used on another stream than its own
    (a record claimed by a lane, DeviceStore.claim) is handed back by the
    caching allocator at its next allocation after that work passed, so
    sync the card and allocate a byte first."""
    torch.cuda.synchronize()
    torch.empty(1, device="cuda")
    return torch.cuda.memory_allocated()


def run_durability(device="cuda") -> dict:
    """The durability path, on its own create() client on the card: config
    2's bank filled to its 10M keys and config 3's 10,000 counters, a
    contains flush and estimate_all, checkpoint.save and checkpoint.load
    into a fresh engine on the card (its plane, registers, found flags and
    estimates equal the saved ones bit for bit; bloom_probe and hll_rows run
    on restored state) and into a port engine on the CPU (equal planes);
    then DUMP/RESTORE/COPY, SAVE and a --restore restart over the wire."""
    import shutil
    import tempfile

    import redisson_tpu_torch
    from redisson_tpu_torch.core import checkpoint
    from redisson_tpu_torch.core import kernels as K

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    dev = torch.device(device)
    rng = np.random.default_rng(91)
    wdir = tempfile.mkdtemp(prefix="rtpu-durability-")
    client = redisson_tpu_torch.create(device=device)
    out = {}
    try:
        arr = client.get_bloom_filter_array("du:c2")
        if not arr.try_init(C2_TENANTS, C2_PER_TENANT, FPP):
            raise AssertionError("durability: bank exists")
        arr.add_flushes_async(config2_ingest())
        bank = client.get_hyper_log_log_array("du:c3")
        bank.try_init(C3_TENANTS)
        for _ in range(C3_BATCHES):
            bank.add(rng.integers(0, C3_TENANTS, C3_BATCH).astype(np.int32),
                     rng.integers(0, 1 << 60, C3_BATCH).astype(np.int64))
        t, ks = config2_flush(rng)
        found = arr.contains(t, ks)
        ests = bank.estimate_all()
        if not found[0::2].all():
            raise AssertionError("durability: false negatives before the save")
        path = os.path.join(wdir, "engine.ckpt")
        _sync(dev)
        s = time.perf_counter()
        n = checkpoint.save(client.engine, path)
        save_s = time.perf_counter() - s
        nbytes = os.path.getsize(path)
        fresh = redisson_tpu_torch.create(device=device)
        try:
            s = time.perf_counter()
            if checkpoint.load(fresh.engine, path) != n:
                raise AssertionError("durability: load count differs from save count")
            _sync(dev)
            load_s = time.perf_counter() - s
            for name, key in (("du:c2", "bits"), ("du:c3", "regs")):
                _same_tensor(f"durability {name}", fresh.engine.store.get(name).arrays[key],
                             client.engine.store.get(name).arrays[key])
            found2 = fresh.get_bloom_filter_array("du:c2").contains(t, ks)
            ests2 = fresh.get_hyper_log_log_array("du:c3").estimate_all()
            if not np.array_equal(found, found2) or not np.array_equal(ests, ests2):
                raise AssertionError("durability: the restored state answers otherwise")
        finally:
            fresh.shutdown()
        cpu = redisson_tpu_torch.create(device="cpu")
        try:
            s = time.perf_counter()
            checkpoint.load(cpu.engine, path)
            cpu_load_s = time.perf_counter() - s
            for name, key in (("du:c2", "bits"), ("du:c3", "regs")):
                _same_tensor(f"durability {name} on the CPU", cpu.engine.store.get(name).arrays[key],
                             client.engine.store.get(name).arrays[key])
        finally:
            cpu.shutdown()
        launches = dict(K.launches)
        out.update({"records": n, "file_bytes": nbytes, "save_s": save_s, "save_mb_per_s": nbytes / save_s / 1e6,
                    "load_s": load_s, "load_mb_per_s": nbytes / load_s / 1e6, "cpu_load_s": cpu_load_s})
        log(f"durability [{card}]: checkpoint of config 2's bank ({C2_TENANTS * C2_PER_TENANT} keys) and config "
            f"3's {C3_TENANTS} counters, {nbytes} bytes: save {save_s:.3f} s ({out['save_mb_per_s']:.1f} MB/s), "
            f"load onto the card {load_s:.3f} s ({out['load_mb_per_s']:.1f} MB/s), onto the CPU {cpu_load_s:.3f} s; "
            f"plane, registers, {len(found)} found flags and {len(ests)} estimates equal bit for bit")
        out["wire"] = durability_wire(device, wdir, card)
    finally:
        client.shutdown()
        shutil.rmtree(wdir, ignore_errors=True)
        if device != "cpu":
            torch.cuda.empty_cache()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - start
    log(f"durability path [{card}]: {out['seconds']:.1f}s")
    return out


# --------------------------------------------------------------------------
# the observe path: TRACE, SLOWLOG, LATENCY, METRICS on the card
# --------------------------------------------------------------------------

OB_FRAMES, OB_SPANS = 20, ("parse", "stage", "dispatch", "readback", "reply")


def _span_pctls(traces, names) -> dict:
    """p50 and p99 ms of each named span over `traces` (wire entries)."""
    by = {n: [] for n in names}
    for t in traces:
        tot = {}
        for sp in t[7]:
            nm = bytes(sp[0]).decode()
            if nm in by:
                tot[nm] = tot.get(nm, 0) + int(sp[2])
        for nm, us in tot.items():
            by[nm].append(us / 1e3)
    return {n: {"p50_ms": pctl(v, 50), "p99_ms": pctl(v, 99), "frames": len(v)} for n, v in by.items() if v}


def observe_qos_spans(device, card: str) -> dict:
    """Config 2q's preempt leg, armed and disarmed, with the tracer armed:
    the interactive probe's stage (the lane-gate wait) and dispatch spans."""
    from redisson_tpu_torch.observe import trace as obs

    out = {}
    for armed in (True, False):
        obs.TRACER.reset()
        obs.TRACER.set_ring_capacity(1 << 16)
        prev = obs.set_tracing(True)
        try:
            leg = qos_leg(device, armed)
        finally:
            obs.set_tracing(prev)
        probes = [tr for tr in obs.TRACER.entries() if tr.qos_class == "interactive" and tr.verbs == "BF.MEXISTS64"]
        stats = {}
        for stage in ("stage", "dispatch", "readback"):
            vals = [tr.stage_us(stage) / 1e3 for tr in probes]
            stats[stage] = {"p50_ms": pctl(vals, 50), "p99_ms": pctl(vals, 99)}
        total = [tr.total_us / 1e3 for tr in probes]
        name = "armed" if armed else "disarmed"
        out[name] = {"probes": len(probes), "total_p50_ms": pctl(total, 50), "total_p99_ms": pctl(total, 99),
                     "client_p50_ms": leg["interactive_p50_ms"], "client_p99_ms": leg["interactive_p99_ms"],
                     "preemptions": leg["preemptions"], **stats}
        log(f"observe qos {name} [{card}]: {len(probes)} traced interactive probes, in the server total p50 "
            f"{out[name]['total_p50_ms']:.3f} ms p99 {out[name]['total_p99_ms']:.3f} ms; stage (lane-gate wait) "
            f"p50 {stats['stage']['p50_ms']:.3f} ms p99 {stats['stage']['p99_ms']:.3f} ms, dispatch p50 "
            f"{stats['dispatch']['p50_ms']:.3f} ms p99 {stats['dispatch']['p99_ms']:.3f} ms, readback p50 "
            f"{stats['readback']['p50_ms']:.3f} ms p99 {stats['readback']['p99_ms']:.3f} ms; at the client p50 "
            f"{leg['interactive_p50_ms']:.3f} ms p99 {leg['interactive_p99_ms']:.3f} ms")
    obs.TRACER.set_ring_capacity(512)
    return out


def observe_cluster_metrics(device, card: str) -> dict:
    """METRICS CLUSTER on a ClusterRunner of 3 masters on the card: one
    exposition with every node's rows under its node= label."""
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.net.client import Connection

    runner = ClusterRunner(masters=3, workers=4, device=device).run()
    try:
        m0 = runner.masters[0].server.server
        conn = Connection(m0.host, m0.port, timeout=600.0)
        try:
            text = bytes(conn.execute("METRICS", "CLUSTER")).decode()
        finally:
            conn.close()
        labels = {f'node="{m.address.split("://")[-1]}"' for m in runner.masters}
        seen = {lab for lab in labels if lab in text}
        if seen != labels:
            raise AssertionError(f"observe: METRICS CLUSTER merged {sorted(seen)} of {sorted(labels)}")
        rows = len(text.splitlines())
    finally:
        runner.shutdown()
    log(f"observe METRICS CLUSTER [{card}]: {rows} rows from 3 masters, each under its node= label")
    return {"rows": rows, "nodes": len(seen)}


def run_observe(device="cuda") -> dict:
    """The observe path, on a devices=1 server on the card: OB_FRAMES traced
    100k-key BFA.MEXISTS64 frames at config 2's shape, each carrying parse,
    stage, dispatch, readback and reply spans (their p50/p99 printed); the
    config-2q probes' stage and dispatch spans armed and disarmed; SLOWLOG
    GET, LATENCY LATEST and METRICS's stage timers; METRICS CLUSTER over 3
    masters."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.observe import trace as obs
    from redisson_tpu_torch.server.server import ServerThread

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    rng = np.random.default_rng(97)
    prev = obs.tracing_enabled()
    st = ServerThread(port=0, devices=1, device=device).start()
    out = {}
    try:
        conn = Connection(st.server.host, st.server.port, timeout=600.0)
        try:
            setup = [("CONFIG", "SET", "trace-enabled", "yes"), ("CONFIG", "SET", "slowlog-log-slower-than", "0"),
                     ("CONFIG", "SET", "slowlog-max-len", "1024"), ("CONFIG", "SET", "trace-ring-capacity", "1024"),
                     ("TRACE", "RESET"), ("SLOWLOG", "RESET"), ("LATENCY", "RESET"),
                     ("BFA.RESERVE", "ob:c2", C2_TENANTS, C2_PER_TENANT, FPP)]
            conn.execute_many(setup)
            for t, ks in config2_ingest()[:2]:
                conn.execute("BFA.MADD64", "ob:c2", _i4(t), _i8(ks))
            flushes = [config2_flush(rng) for _ in range(OB_FRAMES)]
            conn.execute("TRACE", "RESET")
            lat = []
            for t, ks in flushes:
                s = time.perf_counter()
                conn.execute("BFA.MEXISTS64", "ob:c2", _i4(t), _i8(ks))
                lat.append(time.perf_counter() - s)
            time.sleep(0.2)  # a trace ends after its reply's write
            traces = [tr for tr in conn.execute("TRACE", "GET", "1024") if bytes(tr[3]) == b"BFA.MEXISTS64"]
            if len(traces) != OB_FRAMES:
                raise AssertionError(f"observe: {len(traces)} traced frames of {OB_FRAMES}")
            for tr in traces:
                names = {bytes(sp[0]).decode() for sp in tr[7]}
                if not set(OB_SPANS) <= names:
                    raise AssertionError(f"observe: a frame's spans {sorted(names)} lack {set(OB_SPANS) - names}")
            spans = _span_pctls(traces, OB_SPANS + ("qos", "launch", "encode"))
            out["frame_spans"] = spans
            out["frame_client_p50_ms"], out["frame_client_p99_ms"] = pctl(lat, 50) * 1e3, pctl(lat, 99) * 1e3
            log(f"observe frames [{card}]: {OB_FRAMES} traced BFA.MEXISTS64 frames of {C2_FLUSH} keys, at the "
                f"client p50 {out['frame_client_p50_ms']:.3f} ms p99 {out['frame_client_p99_ms']:.3f} ms; spans "
                + ", ".join(f"{n} p50 {v['p50_ms']:.3f} p99 {v['p99_ms']:.3f} ms" for n, v in spans.items()))
            slow = conn.execute("SLOWLOG", "GET", "1024")
            n_slow = sum(1 for e in slow if bytes(e[3][0]) == b"BFA.MEXISTS64")
            latest = conn.execute("LATENCY", "LATEST")
            metrics = bytes(conn.execute("METRICS")).decode()
            stage_rows = [ln for ln in metrics.splitlines() if ln.startswith("rtpu_stage_")]
            if n_slow < OB_FRAMES or not latest or not any(ln.startswith("rtpu_stage_stage_") for ln in stage_rows):
                raise AssertionError(f"observe: SLOWLOG {n_slow} frames, LATENCY LATEST {len(latest)} rows, "
                                     f"{len(stage_rows)} stage timer rows")
            out.update({"slowlog_frames": n_slow, "latency_events": sorted(bytes(e[0]).decode() for e in latest),
                        "metrics_stage_rows": len(stage_rows)})
            log(f"observe [{card}]: SLOWLOG GET lists {n_slow} of the frames, LATENCY LATEST "
                f"{out['latency_events']}, METRICS {len(stage_rows)} stage.* timer rows")
            conn.execute("CONFIG", "SET", "trace-enabled", "no")
        finally:
            conn.close()
    finally:
        st.stop()
        obs.set_tracing(prev)
    out["qos"] = observe_qos_spans(device, card)
    out["cluster_metrics"] = observe_cluster_metrics(device, card)
    out["launches"] = dict(K.launches)
    out["seconds"] = time.perf_counter() - start
    log(f"observe path [{card}]: {out['seconds']:.1f}s")
    return out


# --------------------------------------------------------------------------
# the warm path: a checkpoint restored by two server processes on the card,
# one with --prewarm (core/warmpool.py)
# --------------------------------------------------------------------------

WM_HLL_KEYS, WM_PFADD, WM_READY_S = 100_000, 100, 300.0


def _spawn_server(args, log_path: str, device):
    """python -m redisson_tpu_torch.server with `args` on `device`, its
    output to log_path; returns (process, READY line's host, port)."""
    import select

    r, w = os.pipe()
    cmd = [sys.executable, "-m", "redisson_tpu_torch.server", "--port", "0", "--ready-fd", str(w), *args]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(cmd, cwd=HERE, pass_fds=(w,), stdout=logf, stderr=subprocess.STDOUT)
    os.close(w)
    buf, deadline = b"", time.monotonic() + WM_READY_S
    try:
        while b"\n" not in buf:
            ready, _, _ = select.select([r], [], [], 0.5)
            if ready:
                chunk = os.read(r, 4096)
                if not chunk:
                    break
                buf += chunk
            elif proc.poll() is not None or time.monotonic() > deadline:
                break
    finally:
        os.close(r)
    line = buf.decode(errors="replace").split()
    if len(line) < 3 or line[0] != "READY":
        proc.kill()
        proc.wait(30)
        with open(log_path, errors="replace") as f:
            raise AssertionError(f"warm: a server never reported ready:\n{f.read()[-2000:]}")
    return proc, line[1], int(line[2])


def _stop_server(proc, log_path: str) -> str:
    proc.terminate()
    try:
        rc = proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait(30)
    with open(log_path, errors="replace") as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"warm: a server exited {rc}:\n{text[-2000:]}")
    return text


def warm_firsts(host: str, port: int, rng) -> dict:
    """The first and second 100k-key BFA.MEXISTS64 frame, PFADD and
    PFCOUNT on a freshly restored server, in ms at the client."""
    from redisson_tpu_torch.net.client import Connection

    conn = Connection(host, port, timeout=600.0)
    out = {}
    try:
        for i in range(2):
            t, ks = config2_flush(rng)
            words = [f"wm:{i}:{j}" for j in range(WM_PFADD)]
            for verb, cmd in (("bfa_mexists64", ("BFA.MEXISTS64", "wm:c2", _i4(t), _i8(ks))),
                              ("pfadd", ("PFADD", "wm:hll", *words)), ("pfcount", ("PFCOUNT", "wm:hll"))):
                s = time.perf_counter()
                reply = conn.execute(*cmd)
                out[f"{verb}_{'first' if i == 0 else 'second'}_ms"] = (time.perf_counter() - s) * 1e3
                if verb == "bfa_mexists64" and not np.frombuffer(reply, np.uint8)[0::2].all():
                    raise AssertionError("warm: a present key was not found after the restore")
    finally:
        conn.close()
    return out


def run_warm(device="cuda") -> dict:
    """The warm path: config 2's bank at its design load, config 3's 10,000
    counters and one HLL, saved once into a checkpoint; in this process
    Engine.prewarm warms their kernels on throwaway planes (a second pass
    warms none, the records equal their copies by torch.equal); then two
    server processes on the card restore the checkpoint, one with
    --prewarm: the first and second 100k-key BFA.MEXISTS64 frame, PFADD and
    PFCOUNT of each, and --prewarm's own seconds and pool stats from its
    log."""
    import shutil
    import tempfile

    import redisson_tpu_torch
    from redisson_tpu_torch.core import checkpoint
    from redisson_tpu_torch.core import kernels as K

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    dev = torch.device(device)
    rng = np.random.default_rng(101)
    wdir = tempfile.mkdtemp(prefix="rtpu-warm-")
    client = redisson_tpu_torch.create(device=device)
    out = {}
    try:
        arr = client.get_bloom_filter_array("wm:c2")
        arr.try_init(C2_TENANTS, C2_PER_TENANT, FPP)
        arr.add_flushes_async(config2_ingest())
        bank = client.get_hyper_log_log_array("wm:c3")
        bank.try_init(C3_TENANTS)
        for _ in range(C3_BATCHES):
            bank.add(rng.integers(0, C3_TENANTS, C3_BATCH).astype(np.int32),
                     rng.integers(0, 1 << 60, C3_BATCH).astype(np.int64))
        client.get_hyper_log_log("wm:hll").add_all(rng.integers(0, 1 << 60, WM_HLL_KEYS).astype(np.int64))
        engine = client.engine
        before = {(n, k): v.clone() for n in ("wm:c2", "wm:c3", "wm:hll")
                  for k, v in engine.store.get(n).arrays.items()}
        _sync(dev)
        s = time.perf_counter()
        first = engine.prewarm()
        _sync(dev)
        prewarm_s = time.perf_counter() - s
        again = engine.prewarm()
        if first < 3 or again != 0:
            raise AssertionError(f"warm: prewarm warmed {first}, then {again}")
        for (n, k), v in before.items():
            _same_tensor(f"warm: {n}/{k} after prewarm", engine.store.get(n).arrays[k], v)
        del before
        stats = engine.warm_pool.stats()
        path = os.path.join(wdir, "warm.ckpt")
        _sync(dev)
        nrec = checkpoint.save(engine, path)
        out.update({"in_process": {"warmed": first, "second_pass": again, "prewarm_s": prewarm_s,
                                   "pool": stats}, "records": nrec, "file_bytes": os.path.getsize(path)})
        log(f"warm [{card}]: Engine.prewarm warmed {first} keys in {prewarm_s:.6f} s, a second pass {again}; "
            f"the records equal their copies; pool {json.dumps(stats)}; checkpoint of {nrec} records, "
            f"{out['file_bytes']} bytes")
    finally:
        client.shutdown()
        if device != "cpu":
            torch.cuda.empty_cache()
    launches = dict(K.launches)
    try:
        servers = {}
        for label, extra in (("cold", []), ("prewarm", ["--prewarm"])):
            log_path = os.path.join(wdir, f"{label}.log")
            s = time.perf_counter()
            proc, host, port = _spawn_server(["--checkpoint", path, "--restore", *extra], log_path, device)
            ready_s = time.perf_counter() - s
            try:
                firsts = warm_firsts(host, port, np.random.default_rng(103))
            finally:
                text = _stop_server(proc, log_path)
            if f"restored {nrec} records" not in text:
                raise AssertionError(f"warm: {label} server log {text[-1000:]!r}")
            servers[label] = {"ready_s": ready_s, **firsts}
            if extra:
                line = next((ln for ln in text.splitlines() if ln.startswith("prewarmed ")), None)
                if line is None:
                    raise AssertionError(f"warm: no prewarm line in {text[-1000:]!r}")
                # "prewarmed <n> keys in <seconds> s <pool stats JSON>"
                parts = line.split(maxsplit=6)
                servers[label].update({"prewarmed": int(parts[1]), "prewarm_s": float(parts[4]),
                                       "pool": json.loads(parts[6])})
                if servers[label]["prewarmed"] != first:
                    raise AssertionError(f"warm: the server warmed {parts[1]} keys, this process {first}")
            log(f"warm server {label} [{card}]: ready {ready_s:.1f} s after spawn; first BFA.MEXISTS64 of "
                f"{C2_FLUSH} keys {firsts['bfa_mexists64_first_ms']:.3f} ms (second "
                f"{firsts['bfa_mexists64_second_ms']:.3f}), first PFADD {firsts['pfadd_first_ms']:.3f} ms "
                f"(second {firsts['pfadd_second_ms']:.3f}), first PFCOUNT {firsts['pfcount_first_ms']:.3f} ms "
                f"(second {firsts['pfcount_second_ms']:.3f})"
                + (f"; --prewarm warmed {servers[label]['prewarmed']} keys in "
                   f"{servers[label]['prewarm_s']:.6f} s, pool {json.dumps(servers[label]['pool'])}"
                   if extra else ""))
        out["servers"] = servers
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - start
    log(f"warm path [{card}]: {out['seconds']:.1f}s")
    return out


# --------------------------------------------------------------------------
# the replication path: a master and a replica on the card
# (server/replication.py), and K23 and K24 against their plain versions
# --------------------------------------------------------------------------

RP_BANK_BURST, RP_HLL_BURST, RP_READ_FRAMES = 1000, 10_000, 5
RP_STALE_S = 5.0
# K24's planes: element counts that are not a whole number of 256-byte
# blocks (config 2's expanded bank is 96.3 MB of uint8)
RP_K24_U8, RP_K24_I32 = 96_300_017, 10_000_003
# K23's timed record: five arrays of odd sizes, ~46 MB
RP_K23_SHAPES = {"a": ((1_000_003,), np.bool_), "b": ((1000, 9_631), np.uint8), "c": ((4_000_037,), np.int32),
                 "d": ((3_001, 1_001), np.float32), "e": ((1_000_001,), np.int64)}


def _k23_record(rng, shapes) -> dict:
    out = {}
    for k, (shape, dt) in shapes.items():
        if dt == np.bool_:
            out[k] = rng.integers(0, 2, shape).astype(bool)
        elif np.dtype(dt).kind == "f":
            out[k] = rng.standard_normal(shape).astype(dt)
        else:
            info = np.iinfo(dt)
            out[k] = rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)
    return out


def _wall_ms(fn, dev, reps: int = 5) -> float:
    """Median wall ms of fn() between two syncs of the card."""
    fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        s = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - s) * 1e3)
    return statistics.median(times)


def check_k23(dev, rng, card: str) -> dict:
    """K23 (ioplane.scatter_host_arrays): a record of bool, uint8, int32,
    float32 and int64 arrays of odd sizes equals a per-array .to(device),
    small and at ~46 MB; timed with the pinned pool beside the per-array
    copies and the one host-to-device copy of the merged stream alone."""
    from redisson_tpu_torch.core import ioplane

    pool = ioplane.StagingPool(pin=dev.type == "cuda")
    small = _k23_record(rng, {"a": ((13,), np.bool_), "b": ((3, 7), np.uint8), "c": ((5,), np.int32),
                              "d": ((3, 3), np.float32), "e": ((7,), np.int64), "f": ((9,), np.uint8)})
    big = _k23_record(rng, RP_K23_SHAPES)
    for label, rec in (("small", small), ("timed", big)):
        got = ioplane.scatter_host_arrays(rec, dev, pool)
        for k, v in rec.items():
            _same_tensor(f"K23 {label} {k}", got[k], torch.from_numpy(v).to(dev))
    _, total = ioplane.scatter_layout(big)
    nbytes = sum(v.nbytes for v in big.values())
    ms = _wall_ms(lambda: ioplane.scatter_host_arrays(big, dev, pool), dev)
    plain_ms = _wall_ms(lambda: [torch.from_numpy(v).to(dev) for v in big.values()], dev)
    pinned = torch.empty(total, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    copy_ms = _wall_ms(lambda: pinned.to(dev, non_blocking=True), dev)
    bound, by = bound_ms(2 * nbytes, 0)
    out = {"name": "K23 scatter_host_arrays", "route": "torch ops", "source": "redisson_tpu_torch/core/ioplane.py",
           "replaces": "redisson_tpu/core/ioplane.py:753", "bytes": nbytes, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "h2d_copy_ms": copy_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}
    log(f"K23 [{card}]: {len(big)} arrays, {nbytes} bytes, equal to per-array copies; {ms:.3f} ms (pinned pool) "
        f"vs per-array .to() {plain_ms:.3f} ms, the merged stream's host-to-device copy alone {copy_ms:.3f} ms, "
        f"bound {bound:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return out


def _k24_numpy(host: np.ndarray, d: dict) -> np.ndarray:
    """The plain version: the numpy patch of the host copy."""
    be = d["data"].shape[1]
    flat = host.reshape(-1)
    nb = -(-flat.size // be)
    blocks = np.concatenate([flat, np.zeros(nb * be - flat.size, flat.dtype)]).reshape(nb, be)
    blocks[d["idx"]] = d["data"]  # numpy assigns in order: a repeated index keeps its last data
    return blocks.reshape(-1)[: flat.size].reshape(host.shape)


def check_k24(dev, rng, card: str) -> dict:
    """K24 (replication._apply_array_delta) on a uint8 and an int32 plane
    whose element counts are not whole blocks: 1 block, 1,000 blocks with
    repeats (the partial last block among them) and 60% of the blocks,
    each equal to the numpy patch of the host copy and timed beside it and
    beside its byte bound."""
    from redisson_tpu_torch.server import replication

    out = {"name": "K24 _apply_array_delta", "route": "torch ops",
           "source": "redisson_tpu_torch/server/replication.py",
           "replaces": "redisson_tpu/server/replication.py:102", "library_ms": None, "cases": {}}
    worst = None
    for dt, n in ((np.uint8, RP_K24_U8), (np.int32, RP_K24_I32)):
        host = (rng.integers(0, 256, n, dtype=np.uint8) if dt == np.uint8
                else rng.integers(-2**31, 2**31, n, dtype=np.int32))
        cur = torch.from_numpy(host).to(dev)
        be = replication._block_elems(np.dtype(dt))
        nb = -(-n // be)
        for label, idx in (("1 block", np.asarray([nb // 2])),
                           ("1000 blocks, repeats", np.concatenate([rng.choice(nb - 1, 950, replace=False),
                                                                    rng.choice(nb - 1, 49), [nb - 1]])),
                           ("60% of the blocks", rng.choice(nb, int(0.6 * nb), replace=False))):
            idx = idx.astype(np.int32)
            data = rng.integers(0, 127, (idx.size, be)).astype(dt)
            d = {"idx": idx, "data": data, "shape": host.shape, "dtype": str(np.dtype(dt)), "nblocks": nb}
            replication._validate_array_delta("k24", "a", cur, d)
            got = replication._apply_array_delta(cur, d)
            s = time.perf_counter()
            want = _k24_numpy(host, d)
            plain_ms = (time.perf_counter() - s) * 1e3
            _same_tensor(f"K24 {np.dtype(dt)} {label}", got, torch.from_numpy(want))
            _same_tensor(f"K24 {np.dtype(dt)} {label}: the plane is untouched", cur, torch.from_numpy(host))
            del got, want
            ms = _wall_ms(lambda: replication._apply_array_delta(cur, d), dev)
            bound, by = bound_ms(2 * host.nbytes + data.nbytes + idx.nbytes, 0)
            key = f"{np.dtype(dt)} {label}"
            out["cases"][key] = {"elements": n, "blocks": int(idx.size), "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound}
            log(f"K24 [{card}]: {np.dtype(dt)} plane of {n} elements, {label} ({idx.size} indexes): equal to the "
                f"numpy patch; {ms:.3f} ms vs numpy {plain_ms:.3f} ms, bound {bound:.4f} ms")
            if worst is None or label == "1000 blocks, repeats" and dt == np.uint8:
                worst = (ms, plain_ms, bound, by)
        del cur
    out.update(ms=worst[0], plain_ms=worst[1], bound_ms=worst[2], bound_by=worst[3], max_abs_err=0.0)
    return out


def _rp_records(server) -> dict:
    eng = server.engine
    return {n: eng.store.get_unguarded(n) for n in ("rp:c2", "rp:c3")}


def _rp_equal(master, replica, label: str) -> None:
    m, r = _rp_records(master), _rp_records(replica)
    for name, key in (("rp:c2", "bits"), ("rp:c3", "regs")):
        if r[name] is None or r[name].version != m[name].version:
            raise AssertionError(f"replication {label}: {name} version "
                                 f"{None if r[name] is None else r[name].version} vs {m[name].version}")
        _same_tensor(f"replication {label}: {name}", r[name].arrays[key], m[name].arrays[key])


def _rp_ship(conn, src, label: str, master, replica) -> dict:
    """One REPLFLUSH, timed; the bytes, full and delta records it shipped."""
    before = dict(src.stats)
    s = time.perf_counter()
    reply = conn.execute("REPLFLUSH")
    ship_s = time.perf_counter() - s
    _rp_equal(master, replica, label)
    out = {"ship_s": ship_s, "records": reply,
           **{k: src.stats[k] - before[k] for k in ("bytes", "records_full", "records_delta", "pushes")}}
    return out


def rp_fill(conn, rng) -> None:
    """Config 2's bank at its design load (100 flushes of 100,000 keys) and
    config 3's 10 batches of 1M ops into 10,000 counters, over the wire."""
    conn.execute("BFA.RESERVE", "rp:c2", C2_TENANTS, C2_PER_TENANT, FPP)
    for t, ks in config2_ingest():
        conn.execute_many([("BFA.MADD64", "rp:c2", _i4(t[i:i + C2_FLUSH]), _i8(ks[i:i + C2_FLUSH]))
                           for i in range(0, len(ks), C2_FLUSH)])
    conn.execute("HLLA.RESERVE", "rp:c3", C3_TENANTS)
    for _ in range(C3_BATCHES):
        conn.execute("HLLA.MADD64", "rp:c3", _i4(rng.integers(0, C3_TENANTS, C3_BATCH)),
                     _i8(rng.integers(0, 1 << 60, C3_BATCH)))


def rp_bad_deltas(replica, address) -> list:
    """REPLPUSH frames whose delta names a block past the plane and whose
    shipped shape differs: each must reply an error and write nothing."""
    from redisson_tpu_torch.net import safe_pickle
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server import replication

    rec = replica.engine.store.get_unguarded("rp:c2")
    plane = rec.arrays["bits"]
    shape = tuple(plane.shape)
    nb = -(-plane.numel() // 256)
    head = {"name": "rp:c2", "kind": rec.kind, "meta": dict(rec.meta), "version": rec.version + 1,
            "nonce": rec.nonce, "expire_at": rec.expire_at, "host_pickled": safe_pickle.dumps(rec.host, protocol=4),
            "delta_base": rec.version}
    row = np.zeros((1, 256), np.uint8)
    bad = {"past the plane": {"idx": np.asarray([nb + 5], np.int32), "data": row, "shape": shape,
                              "dtype": "uint8", "nblocks": nb},
           "another shape": {"idx": np.asarray([0], np.int32), "data": row, "shape": (shape[0], shape[1] + 256),
                             "dtype": "uint8", "nblocks": nb + shape[0]}}
    replies = []
    conn = Connection(*address, timeout=600.0)
    try:
        for label, d in bad.items():
            blob = replication._wire_payload([dict(head, arrays_delta={"bits": d})], None)
            try:
                reply = conn.execute("REPLPUSH", blob)
            except Exception as e:  # noqa: BLE001 — the error reply
                reply = e
            if "REPLPUSH delta" not in str(reply):
                raise AssertionError(f"replication: a bad delta ({label}) replied {reply!r}")
            replies.append(str(reply))
    finally:
        conn.close()
    if replica.engine.store.get_unguarded("rp:c2") is not rec:
        raise AssertionError("replication: a refused delta replaced the record")
    return replies


def rp_staleness(master_addr, replica_addr, src, rng) -> dict:
    """A writer of 1,000-key BFA.MADD64 frames for RP_STALE_S seconds with
    the shipper's interval at its default; REPLSTATE's staleness on the
    replica every 10 ms from a thread of its own, and WAIT 1's time on the
    master, one after another."""
    from redisson_tpu_torch.net.client import Connection

    stop = threading.Event()
    errors, stale = [], []

    def sampler():
        sconn = Connection(*replica_addr, timeout=600.0)
        try:
            while not stop.is_set():
                stale.append(int(sconn.execute("REPLSTATE")[2]))
                time.sleep(0.01)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            sconn.close()

    def writer():
        wconn = Connection(*master_addr, timeout=600.0)
        try:
            while not stop.is_set():
                keys = rng.integers(0, 1 << 60, RP_BANK_BURST).astype(np.int64)
                wconn.execute("BFA.MADD64", "rp:c2", _i4((keys * 40503) % C2_TENANTS), _i8(keys))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            wconn.close()

    mconn = Connection(*master_addr, timeout=600.0)
    waits = []
    threads = [threading.Thread(target=writer, daemon=True), threading.Thread(target=sampler, daemon=True)]
    pushes0 = dict(src.stats)
    try:
        for t in threads:
            t.start()
        deadline = time.perf_counter() + RP_STALE_S
        while time.perf_counter() < deadline:
            s = time.perf_counter()
            if mconn.execute("WAIT", 1, 1000) != 1:
                raise AssertionError("replication: WAIT 1 did not reach the replica")
            waits.append((time.perf_counter() - s) * 1e3)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        mconn.close()
    if errors:
        raise errors[0]
    if min(stale) < 0:
        raise AssertionError("replication: REPLSTATE says the replica never synced")
    return {"samples": len(stale), "waits": len(waits), "staleness_p50_ms": pctl(stale, 50),
            "staleness_p99_ms": pctl(stale, 99), "wait_p50_ms": pctl(waits, 50), "wait_p99_ms": pctl(waits, 99),
            **{k: src.stats[k] - pushes0[k] for k in ("pushes", "bytes", "records_full", "records_delta")}}


def rp_process_replica(device, card: str) -> dict:
    """ClusterSupervisor(masters=1, replicas_per_master=1), children on the
    card: a write, WAIT 1, and a READONLY read on the replica replying the
    master's bytes."""
    from redisson_tpu_torch.cluster import ClusterSupervisor

    start = time.perf_counter()
    keys = np.arange(C2_FLUSH, dtype=np.int64) * 2654435761
    probe = _i8(np.concatenate([keys[::2], keys[::2] + 1]))
    sup = ClusterSupervisor(masters=1, replicas_per_master=1, platform=None if device == "cuda" else device,
                            ready_timeout=WM_READY_S)
    try:
        sup.start()
        up_s = time.perf_counter() - start
        with sup.conn(sup.masters[0], timeout=600.0) as m:
            m.execute_many([("BF.RESERVE", "{rp}:bf", "0.01", str(4 * C2_FLUSH)), ("BF.MADD64", "{rp}:bf", _i8(keys))])
            s = time.perf_counter()
            acked = m.execute("WAIT", 1, 60000)
            wait_ms = (time.perf_counter() - s) * 1e3
            want = m.execute("BF.MEXISTS64", "{rp}:bf", probe)
        with sup.conn(sup.replicas[0], timeout=600.0) as r:
            r.execute("READONLY")
            got = r.execute("BF.MEXISTS64", "{rp}:bf", probe)
            role = r.execute("ROLE")
    finally:
        sup.shutdown()
    if acked != 1 or got != want or bytes(role[0]) != b"slave":
        raise AssertionError(f"replication process replica: WAIT {acked}, ROLE {role[0]!r}, equal {got == want}")
    out = {"start_s": up_s, "wait_ms": wait_ms, "seconds": time.perf_counter() - start}
    log(f"replication process replica [{card}]: master and replica processes up in {up_s:.1f} s; a "
        f"{C2_FLUSH}-key write, WAIT 1 in {wait_ms:.3f} ms, the replica's READONLY BF.MEXISTS64 equals the "
        f"master's")
    return out


def run_replication(device="cuda") -> dict:
    """The replication path on ClusterRunner(masters=1, replicas_per_master=1)
    on the card: the master filled to configs 2 and 3's design loads with
    its shipper stalled, then REPLICAOF (the full sync, timed); bursts of
    1,000 bank keys and 10,000 counter ops, each shipped by REPLFLUSH as a
    block delta, and one 100,000-key flush that ships in full; replica
    reads through ClusterRedisson(read_mode="replica"); K23 and K24 against
    their plain versions; bad deltas refused with the context usable;
    staleness and WAIT under a 5 s writer; a replica process."""
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.net.client import Connection

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    dev = torch.device(device)
    rng = np.random.default_rng(107)
    out = {}
    runner = ClusterRunner(masters=1, replicas_per_master=1, device=device, workers=4).run()
    try:
        mnode, rnode = runner.masters[0], runner.replicas[0]
        master, replica = mnode.server.server, rnode.server.server
        maddr, raddr = (master.host, master.port), (replica.host, replica.port)
        src = master.replication_source()
        mconn, rconn = Connection(*maddr, timeout=600.0), Connection(*raddr, timeout=600.0)
        try:
            runner.stall_replication(mnode)
            s = time.perf_counter()
            rp_fill(mconn, rng)
            _sync(dev)
            fill_s = time.perf_counter() - s
            state_bytes = sum(v.numel() * v.element_size() for rec in _rp_records(master).values()
                              for v in rec.arrays.values())
            s = time.perf_counter()
            rconn.execute("REPLICAOF", master.host, master.port, timeout=600.0)
            sync_s = time.perf_counter() - s
            _rp_equal(master, replica, "full sync")
            out["full_sync"] = {"fill_s": fill_s, "state_bytes": state_bytes, "sync_s": sync_s,
                                "mb_per_s": state_bytes / sync_s / 1e6}
            log(f"replication full sync [{card}]: {state_bytes} bytes of bank and registers (filled in "
                f"{fill_s:.1f} s) in {sync_s:.3f} s by REPLICAOF, {out['full_sync']['mb_per_s']:.1f} MB/s; "
                f"equal by torch.equal")
            # the shipper's interval thread sleeps through the timed ships
            src.interval = 3600.0
            time.sleep(0.5)
            runner.resume_replication(mnode)
            out["first_sweep"] = _rp_ship(mconn, src, "the first sweep after the sync", master, replica)
            deltas = {}
            keys = rng.integers(1 << 50, 1 << 60, RP_BANK_BURST).astype(np.int64)
            mconn.execute("BFA.MADD64", "rp:c2", _i4((keys * 40503) % C2_TENANTS), _i8(keys))
            deltas["bank 1000 keys"] = _rp_ship(mconn, src, "a 1,000-key burst", master, replica)
            mconn.execute("HLLA.MADD64", "rp:c3", _i4(rng.integers(0, C3_TENANTS, RP_HLL_BURST)),
                          _i8(rng.integers(0, 1 << 60, RP_HLL_BURST)))
            deltas["counters 10000 ops"] = _rp_ship(mconn, src, "a 10,000-op burst", master, replica)
            keys = rng.integers(1 << 50, 1 << 60, C2_FLUSH).astype(np.int64)
            mconn.execute("BFA.MADD64", "rp:c2", _i4((keys * 40503) % C2_TENANTS), _i8(keys))
            deltas["bank 100000 keys"] = _rp_ship(mconn, src, "a 100,000-key flush", master, replica)
            full = {"rp:c2": _rp_records(master)["rp:c2"].arrays["bits"].numel(),
                    "rp:c3": _rp_records(master)["rp:c3"].arrays["regs"].numel()}
            # the bursts move a few blocks and ship as deltas; the 100,000-key
            # flush ships as whichever the 60% rule says (printed)
            if deltas["bank 1000 keys"]["records_delta"] != 1 or deltas["counters 10000 ops"]["records_delta"] != 1:
                raise AssertionError(f"replication: the bursts shipped {deltas}")
            out["ships"] = {"first_sweep": out["first_sweep"], **deltas, "full_record_bytes": full}
            for label, d in [("first sweep", out["first_sweep"])] + list(deltas.items()):
                log(f"replication ship [{card}]: {label}: REPLFLUSH {d['ship_s'] * 1e3:.3f} ms, {d['bytes']} bytes "
                    f"on the wire ({d['records_delta']} delta, {d['records_full']} full records; the bank is "
                    f"{full['rp:c2']} bytes, the registers {full['rp:c3']}); replica equal by torch.equal")
            # replica reads, their launches counted on their own
            client = runner.client(read_mode="replica", scan_interval=0, timeout=600.0)
            try:
                frames = [config2_flush(rng) for _ in range(RP_READ_FRAMES)]
                reads0, probes0 = replica.stats["replica_reads"], K.launches["bloom_probe"]
                got = [client.execute("BFA.MEXISTS64", "rp:c2", _i4(t), _i8(ks)) for t, ks in frames]
                replica_probes = K.launches["bloom_probe"] - probes0
                replica_reads = replica.stats["replica_reads"] - reads0
                want = [mconn.execute("BFA.MEXISTS64", "rp:c2", _i4(t), _i8(ks)) for t, ks in frames]
            finally:
                client.shutdown()
            if got != want or replica_reads < RP_READ_FRAMES or replica_probes == 0:
                raise AssertionError(f"replication: replica reads equal {got == want}, {replica_reads} counted, "
                                     f"{replica_probes} bloom_probe launches")
            out["replica_reads"] = {"frames": RP_READ_FRAMES, "replica_reads": replica_reads,
                                    "bloom_probe_launches": replica_probes}
            log(f"replication replica reads [{card}]: {RP_READ_FRAMES} BFA.MEXISTS64 frames of {C2_FLUSH} keys "
                f"through ClusterRedisson(read_mode='replica') equal the master's bytes; replica_reads "
                f"{replica_reads}, bloom_probe launches {replica_probes}")
            launches = dict(K.launches)
            out["k23"] = check_k23(dev, rng, card)
            out["k24"] = check_k24(dev, rng, card)
            K.launches.update(launches)  # K23 and K24 launch no counted kernel
            out["bad_deltas"] = rp_bad_deltas(replica, raddr)
            again = mconn.execute("BFA.MEXISTS64", "rp:c2", _i4(frames[0][0]), _i8(frames[0][1]))
            if rconn.execute("READONLY") != b"OK":
                raise AssertionError("replication: READONLY")
            if rconn.execute("BFA.MEXISTS64", "rp:c2", _i4(frames[0][0]), _i8(frames[0][1])) != again:
                raise AssertionError("replication: after the bad deltas the replica answers otherwise")
            _sync(dev)  # the context is still usable
            log(f"replication bad deltas [{card}]: {len(out['bad_deltas'])} REPLPUSH frames refused "
                f"({'; '.join(r.split('ValueError: ')[-1][:48] for r in out['bad_deltas'])}); the replica answers "
                f"the master's bytes "
                f"and the card synchronizes")
            src.interval = 0.2
            out["staleness"] = rp_staleness(maddr, raddr, src, rng)
            st = out["staleness"]
            log(f"replication staleness [{card}]: {RP_STALE_S:.0f} s of {RP_BANK_BURST}-key writes: REPLSTATE "
                f"staleness over {st['samples']} samples p50 {st['staleness_p50_ms']:.1f} ms p99 "
                f"{st['staleness_p99_ms']:.1f} ms; WAIT 1 over {st['waits']} calls p50 {st['wait_p50_ms']:.3f} ms "
                f"p99 {st['wait_p99_ms']:.3f} ms; {st['pushes']} pushes, {st['bytes']} bytes, "
                f"{st['records_full']} full and {st['records_delta']} delta records")
        finally:
            mconn.close()
            rconn.close()
    finally:
        runner.shutdown()
        if device != "cpu":
            torch.cuda.empty_cache()
    out["launches"] = dict(K.launches)
    out["process_replica"] = rp_process_replica(device, card)
    out["seconds"] = time.perf_counter() - start
    log(f"replication path [{card}]: {out['seconds']:.1f}s")
    return out


# --------------------------------------------------------------------------
# the migration path: live slot migration, journals and failover on the card
# (server/migration.py, server/migration_journal.py, cluster/chaos.py)
# --------------------------------------------------------------------------

# config 2's bank and config 3's counters take C2_INGEST keys and C3_BATCH
# ops before the windows (their widths are the configs': 96.3 MB and 163.8
# MB); the writer's frames, the pause after each of its acks (a paced
# writer: its acked stream is replayed on the CPU) and its seconds before
# and after each window
MG_FRAME, MG_WRITER_GAP_S, MG_LEAD_S = 10_000, 0.01, 0.5
MG_PHASES = ("PLANNED", "WINDOW_OPEN", "DRAINING:1", "VIEW_COMMITTED", "STABLE")
MG_DEV_PHASES = ("PLANNED", "DRAINING:1", "STABLE")
MG_POSITIONS, MG_READY_S = 8, 300.0
# a key the writer sends is past every key of the fills
MG_WRITER_BASE = 20_000_000


def _mg_tags(owner_range, prefix: str, n: int) -> list:
    """n hash tags (each its own slot) whose slots lie in owner_range."""
    from redisson_tpu_torch.utils.crc16 import calc_slot

    lo, hi = owner_range
    out, slots = [], set()
    for i in range(1_000_000):
        t = f"{prefix}{i}"
        s = calc_slot(t.encode())
        if lo <= s <= hi and s not in slots:
            out.append(t)
            slots.add(s)
            if len(out) == n:
                return out
    raise AssertionError(f"migration: fewer than {n} tags on {owner_range}")


def _mg_config5(tags, rng) -> tuple:
    """Config 5's records on the given tags: a C5_PER-key filter and a
    C5_BITS-bit set a tenant (C5_BIT_OPS indexes).  Returns (commands, the
    filters' names, every name, {filter: its keys})."""
    cmds, filters, names, keys = [], [], [], {}
    for t, tag in enumerate(tags):
        f, b = f"mg:bf{{{tag}}}", f"mg:bits{{{tag}}}"
        ks = np.arange(t * C5_PER, (t + 1) * C5_PER, dtype=np.int64) * 2654435761
        cmds += [("BF.RESERVE", f, FPP, C5_PER), ("BF.MADD64", f, _i8(ks)),
                 ("SETBITSB", b, _i4(rng.integers(0, C5_BITS, C5_BIT_OPS)))]
        filters.append(f)
        names += [f, b]
        keys[f] = [ks]
    return cmds, filters, names, keys


def _mg_fill(bank: str, hll: str, rng) -> list:
    """Config 2's bank and config 3's counters, reserved and filled."""
    cmds = [("BFA.RESERVE", bank, C2_TENANTS, C2_PER_TENANT, FPP), ("HLLA.RESERVE", hll, C3_TENANTS)]
    keys = np.arange(C2_INGEST, dtype=np.int64) * 2654435761
    for i in range(0, C2_INGEST, C2_FLUSH):
        ks = keys[i:i + C2_FLUSH]
        cmds.append(("BFA.MADD64", bank, _i4((ks * 40503) % C2_TENANTS), _i8(ks)))
    for i in range(0, C3_BATCH, C2_FLUSH):
        cmds.append(("HLLA.MADD64", hll, _i4(rng.integers(0, C3_TENANTS, C2_FLUSH)),
                     _i8(rng.integers(0, 1 << 60, C2_FLUSH))))
    return cmds


def _mg_run(conn, cmds, label: str) -> None:
    """Send commands in frames of 16; every reply must be a success."""
    for i in range(0, len(cmds), 16):
        for cmd, reply in zip(cmds[i:i + 16], conn.execute_many(cmds[i:i + 16])):
            if isinstance(reply, Exception):
                raise AssertionError(f"{label}: {cmd[0]} {cmd[1]} replied {reply}")


def _mg_bank_keys(frames) -> tuple:
    """The (tenants, keys) of every BFA.MADD64 command among `frames`."""
    t = [np.frombuffer(c[2], "<i4") for c in frames if c[0] == "BFA.MADD64"]
    k = [np.frombuffer(c[3], "<i8") for c in frames if c[0] == "BFA.MADD64"]
    return np.concatenate(t), np.concatenate(k)


def _mg_all_found(conn, label: str, cmd: str, name: str, tenants, keys) -> int:
    """Every key reads 1 by BFA.MEXISTS64 (tenants given) or BF.MEXISTS64."""
    for i in range(0, len(keys), C2_FLUSH):
        args = (_i4(tenants[i:i + C2_FLUSH]),) if tenants is not None else ()
        reply = conn.execute(cmd, name, *args, _i8(keys[i:i + C2_FLUSH]))
        if isinstance(reply, Exception) or not np.frombuffer(reply, np.uint8).all():
            raise AssertionError(f"migration {label}: an acked key of {name} reads 0 ({str(reply)[:80]})")
    return len(keys)


def _mg_owners(masters, names) -> dict:
    """{name: the indexes of the masters holding it}."""
    return {n: [i for i, m in enumerate(masters) if m.server.server.engine.store.peek(n)] for n in names}


def _mg_one_owner(masters, names, want: int, label: str) -> None:
    bad = {n: o for n, o in _mg_owners(masters, names).items() if o != [want]}
    if bad:
        raise AssertionError(f"migration {label}: records not on exactly master {want}: {list(bad.items())[:4]}")


def _mg_same_planes(server, cpu_server, names, label: str) -> int:
    """Each record's arrays on `server` equal the CPU replay's bit for bit."""
    total = 0
    for n in names:
        got, want = server.engine.store.get_unguarded(n), cpu_server.engine.store.get_unguarded(n)
        if got is None or want is None or sorted(got.arrays) != sorted(want.arrays):
            raise AssertionError(f"migration {label}: {n} missing or of other arrays")
        for k, v in want.arrays.items():
            _same_tensor(f"migration {label}: {n}.{k}", got.arrays[k], v)
            total += v.numel() * v.element_size()
    return total


def _mg_imports(server) -> tuple:
    """(IMPORTRECORDS calls, their seconds) of a server's commandstats."""
    t = server.metrics._timers.get("command.importrecords")
    return (0, 0.0) if t is None else (t.count, t.total_s)


class _MgWriter(threading.Thread):
    """Sends BFA.MADD64 frames into the bank and HLLA.MADD64 frames into
    the counters through a ClusterRedisson, one at a time, each of MG_FRAME
    fresh keys, MG_WRITER_GAP_S apart; keeps every acked frame in order with
    its start and latency, and every failure."""

    def __init__(self, client, bank: str, hll: str):
        super().__init__(daemon=True, name="mg-writer")
        self.client, self.bank, self.hll = client, bank, hll
        self.frames, self.errors = [], []
        self.halt = threading.Event()

    def run(self):
        i = 0
        while not self.halt.is_set():
            keys = (MG_WRITER_BASE + np.arange(i * MG_FRAME, (i + 1) * MG_FRAME, dtype=np.int64)) * 2654435761
            if i % 2 == 0:
                cmd = ("BFA.MADD64", self.bank, _i4((keys * 40503) % C2_TENANTS), _i8(keys))
            else:
                cmd = ("HLLA.MADD64", self.hll, _i4(keys % C3_TENANTS), _i8(keys))
            i += 1
            s = time.perf_counter()
            try:
                self.client.execute(*cmd)
            except Exception as e:  # noqa: BLE001 — an unacked frame fails the leg
                self.errors.append(f"{cmd[0]}: {e!r}")
                continue
            self.frames.append((s, (time.perf_counter() - s) * 1e3, cmd))
            self.halt.wait(MG_WRITER_GAP_S)


def _mg_pctl(frames, lo: float, hi: float) -> dict:
    ms = [f[1] for f in frames if f[0] < hi and f[0] + f[1] / 1e3 > lo]
    return {"frames": len(ms), "p50_ms": pctl(ms, 50) if ms else None, "p99_ms": pctl(ms, 99) if ms else None}


def mg_live(runner, cpu, jd: str, card: str) -> dict:
    """Leg a: config 2's bank, config 3's counters and config 5's 64
    tenants on master 0, a writer of BFA.MADD64 and HLLA.MADD64 frames
    through the port's ClusterRedisson, and three journaled migrate_slots
    windows to master 1 (the bank's slot, the counters' slot, config 5's
    64 slots) while it writes."""
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server.migration import migrate_slots
    from redisson_tpu_torch.utils.crc16 import calc_slot

    rng = np.random.default_rng(211)
    src, dst = (m.server.server for m in runner.masters)
    b_tag, h_tag = _mg_tags(runner.slot_ranges[0], "mgb", 2)
    bank, hll = f"mg:c2{{{b_tag}}}", f"mg:c3{{{h_tag}}}"
    c5_cmds, filters, c5_names, _ = _mg_config5(_mg_tags(runner.slot_ranges[0], "mgt", C5_TENANTS), rng)
    setup = _mg_fill(bank, hll, rng) + c5_cmds
    conn = Connection(src.host, src.port, timeout=600.0)
    try:
        s = time.perf_counter()
        _mg_run(conn, setup, "setup")
        setup_s = time.perf_counter() - s
    finally:
        conn.close()
    client = runner.client(scan_interval=0, timeout=600.0)
    writer = _MgWriter(client, bank, hll)
    windows = []
    try:
        writer.start()
        time.sleep(MG_LEAD_S)
        for label, slots, names in (("bank", [calc_slot(b_tag.encode())], [bank]),
                                    ("counters", [calc_slot(h_tag.encode())], [hll]),
                                    ("config5", sorted({calc_slot(n.encode()) for n in c5_names}), c5_names)):
            redirects, (calls0, imp_s0) = dict(client.redirect_stats), _mg_imports(dst)
            s = time.perf_counter()
            moved = migrate_slots(src.address(), dst.address(), slots, journal_dir=jd)
            e = time.perf_counter()
            calls, imp_s = _mg_imports(dst)
            nbytes = sum(v.numel() * v.element_size() for n in names
                         for v in dst.engine.store.get_unguarded(n).arrays.values())
            windows.append({"window": label, "slots": len(slots), "records": moved, "bytes": nbytes,
                            "seconds": e - s, "mb_per_s": nbytes / (e - s) / 1e6,
                            "importrecords_frames": calls - calls0, "importrecords_s": imp_s - imp_s0,
                            "redirects": {k: client.redirect_stats[k] - v for k, v in redirects.items()},
                            "start": s, "end": e})
            time.sleep(MG_LEAD_S)
    finally:
        writer.halt.set()
        writer.join(120)
        client.shutdown()
    if writer.errors:
        raise AssertionError(f"migration live: {len(writer.errors)} writer frames failed: {writer.errors[:3]}")
    if [w["records"] for w in windows] != [1, 1, len(c5_names)]:
        raise AssertionError(f"migration live: records moved {[w['records'] for w in windows]}")
    acked = [f[2] for f in writer.frames]
    before = _mg_pctl(writer.frames, 0.0, windows[0]["start"])
    for w in windows:
        w["writer"] = _mg_pctl(writer.frames, w.pop("start"), w.pop("end"))
    names = [bank, hll] + c5_names
    _mg_one_owner(runner.masters, names, 1, "live")
    t, k = _mg_bank_keys([c for c in setup if c[1] == bank] + acked)
    conn = Connection(dst.host, dst.port, timeout=600.0)
    cconn = Connection(cpu.host, cpu.port, timeout=600.0)
    try:
        found = _mg_all_found(conn, "live", "BFA.MEXISTS64", bank, t, k)
        # the CPU replay: the same setup and acked frames, in order
        _mg_run(cconn, setup + acked, "CPU replay")
        if conn.execute("HLLA.ESTIMATE", hll) != cconn.execute("HLLA.ESTIMATE", hll):
            raise AssertionError("migration live: the counters' estimates differ from the CPU replay's")
    finally:
        conn.close()
        cconn.close()
    replayed = _mg_same_planes(dst, cpu, names, "live")
    out = {"setup_s": setup_s, "writer_before": before, "windows": windows, "acked_frames": len(acked),
           "acked_bank_keys_found": found, "planes_bytes_equal": replayed}
    log(f"migration live [{card}]: setup {setup_s:.1f} s; writer before the windows: {before['frames']} frames "
        f"p50 {before['p50_ms']:.3f} ms p99 {before['p99_ms']:.3f} ms")
    for w in windows:
        wr = w["writer"]
        log(f"migration live [{card}]: {w['window']}: {w['records']} records of {w['slots']} slots, {w['bytes']} "
            f"bytes in {w['seconds']:.3f} s ({w['mb_per_s']:.1f} MB/s; IMPORTRECORDS {w['importrecords_frames']} "
            f"frames, {w['importrecords_s']:.3f} s on the target); writer during it {wr['frames']} frames"
            + (f" p50 {wr['p50_ms']:.3f} ms p99 {wr['p99_ms']:.3f} ms" if wr["frames"] else "")
            + f"; redirects followed {w['redirects']}")
    log(f"migration live [{card}]: {len(acked)} acked writer frames; {found} acked bank keys read 1 on the target; "
        f"every record on master 1 alone; {replayed} bytes of planes equal the CPU replay bit for bit, and so "
        "do the counters' HLLA.ESTIMATE replies")
    return out, (setup + acked, filters, c5_names)


def mg_kills(runner, cpu, jd: str, card: str, filters, c5_names) -> dict:
    """Leg b: config 5's records moved between the masters by a journaled
    migrate_slots killed after each phase, each followed by
    resume_migrations, with an acked BF.MADD64 frame into every filter
    before each kill."""
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server.migration import CoordinatorKilled, migrate_slots, resume_migrations
    from redisson_tpu_torch.utils.crc16 import calc_slot

    slots = sorted({calc_slot(n.encode()) for n in c5_names})
    client = runner.client(scan_interval=0, timeout=600.0)
    acked, keys, phases = [], {f: [] for f in filters}, []
    try:
        for p, phase in enumerate(MG_PHASES):
            owner = _mg_owners(runner.masters, c5_names[:1])[c5_names[0]][0]
            a, b = (runner.masters[owner].server.server, runner.masters[1 - owner].server.server)
            for t, f in enumerate(filters):
                ks = (np.arange(C5_PER, dtype=np.int64) + (p + 1) * 10_000_000 + t * C5_PER) * 2654435761
                client.execute("BF.MADD64", f, _i8(ks))
                acked.append(("BF.MADD64", f, _i8(ks)))
                keys[f].append(ks)
            s = time.perf_counter()
            try:
                migrate_slots(a.address(), b.address(), slots, journal_dir=jd, crash_after=phase)
                killed = False
            except CoordinatorKilled:
                killed = True
            k = time.perf_counter()
            results = resume_migrations(jd)
            e = time.perf_counter()
            action = [r["action"] for r in results]
            want = (["rolled_back"] if phase == "PLANNED" else [] if phase == "STABLE" else ["completed"])
            if killed != (phase != "STABLE") or action != want:
                raise AssertionError(f"migration kills: {phase}: killed {killed}, resume {results}")
            holder = owner if phase == "PLANNED" else 1 - owner
            _mg_one_owner(runner.masters, c5_names, holder, f"kill at {phase}")
            phases.append({"phase": phase, "action": action, "holder": holder, "until_kill_s": k - s,
                           "resume_s": e - k})
        for f in filters:
            _mg_all_found(client, f"kills ({f})", "BF.MEXISTS64", f, None, np.concatenate(keys[f]))
    finally:
        client.shutdown()
    cconn = Connection(cpu.host, cpu.port, timeout=600.0)
    try:
        _mg_run(cconn, acked, "CPU replay")
    finally:
        cconn.close()
    holder = runner.masters[phases[-1]["holder"]].server.server
    replayed = _mg_same_planes(holder, cpu, c5_names, "kills")
    for ph in phases:
        log(f"migration kills [{card}]: coordinator killed after {ph['phase']}: {ph['until_kill_s']:.3f} s to the "
            f"kill, resume_migrations {ph['resume_s']:.3f} s -> {ph['action'] or 'nothing in flight'}; "
            f"{len(c5_names)} records on master {ph['holder']} alone")
    log(f"migration kills [{card}]: every acked key of {len(filters)} filters reads 1; {replayed} bytes of planes "
        f"equal the CPU replay bit for bit")
    return {"phases": phases, "planes_bytes_equal": replayed}


def _mg_last_generation_ends(log_text: str) -> str:
    """The last line an old generation of a node wrote before the last
    ``serving on`` line (the node's newest start)."""
    lines = [ln for ln in log_text.splitlines() if ln.strip()]
    starts = [i for i, ln in enumerate(lines) if ln.startswith("serving on ")]
    if len(starts) < 2:
        return ""
    return lines[starts[-1] - 1]


def mg_processes(device, card: str) -> dict:
    """Leg c: ClusterSupervisor(masters=2, replicas_per_master=1) server
    processes on the card (each with --checkpoint and --journal-dir):
    config 2's bank migrated with the coordinator killed after its first
    drain sweep and the target SIGKILLed (kill_pair_at_phase), the target
    restarted (its import journal replayed at boot), resume_migrations;
    then a WAIT 1 covered write, the master killed and promote_replica;
    then rolling_restart of the masters with a client connection open.
    Every acked key reads 1 after each step."""
    from redisson_tpu_torch.cluster import ClusterSupervisor
    from redisson_tpu_torch.cluster.chaos import kill_pair_at_phase
    from redisson_tpu_torch.server.migration import resume_migrations
    from redisson_tpu_torch.utils.crc16 import calc_slot

    steps, out = {}, {}
    rng = np.random.default_rng(223)
    sup = ClusterSupervisor(masters=2, replicas_per_master=1, platform=None if device == "cuda" else device,
                            ready_timeout=MG_READY_S)
    client = None
    try:
        s = time.perf_counter()
        sup.start()
        steps["start 4 processes"] = time.perf_counter() - s
        client = sup.client(scan_interval=0, timeout=600.0)
        if not client.wait_routable(timeout=60.0):
            raise AssertionError("migration processes: the fleet never served every slot")
        tag = _mg_tags(sup.slot_ranges[0], "mgp", 1)[0]
        bank = f"mg:c2{{{tag}}}"
        fill = [c for c in _mg_fill(bank, f"mg:unused{{{tag}}}", rng) if c[1] == bank]
        s = time.perf_counter()
        for cmd in fill:
            client.execute(*cmd)
        steps["fill the bank"] = time.perf_counter() - s
        t, k = _mg_bank_keys(fill)
        src, dst = sup.masters
        s = time.perf_counter()
        rcs = kill_pair_at_phase(sup, src, dst, [calc_slot(tag.encode())], "DRAINING:1")
        steps["migrate, coordinator killed after DRAINING:1, target SIGKILLed"] = time.perf_counter() - s
        if rcs != {"target": -signal.SIGKILL}:
            raise AssertionError(f"migration processes: kill_pair_at_phase {rcs}")
        s = time.perf_counter()
        sup.restart(dst)
        steps["restart the target (import journal replayed at boot)"] = time.perf_counter() - s
        s = time.perf_counter()
        results = resume_migrations(sup.journal_dir)
        steps["resume_migrations"] = time.perf_counter() - s
        if [r["action"] for r in results] != ["completed"]:
            raise AssertionError(f"migration processes: resume {results}")
        client.refresh_topology()
        _mg_all_found(client, "processes after the resume", "BFA.MEXISTS64", bank, t, k)
        ks = (MG_WRITER_BASE + np.arange(C2_FLUSH, dtype=np.int64)) * 2654435761
        ts = ((ks * 40503) % C2_TENANTS).astype(np.int32)
        with sup.conn(dst, timeout=600.0) as c:
            c.execute("BFA.MADD64", bank, _i4(ts), _i8(ks))
            s = time.perf_counter()
            acks = c.execute("WAIT", 1, 60000)
            steps["WAIT 1"] = time.perf_counter() - s
        if acks != 1:
            raise AssertionError(f"migration processes: WAIT 1 replied {acks}")
        t, k = np.concatenate([t, ts]), np.concatenate([k, ks])
        s = time.perf_counter()
        sup.kill(dst)
        promoted = sup.promote_replica(dst)
        steps["kill the master, promote_replica"] = time.perf_counter() - s
        if promoted is None:
            raise AssertionError("migration processes: no replica to promote")
        client.refresh_topology()
        _mg_all_found(client, "processes after the promotion", "BFA.MEXISTS64", bank, t, k)
        gens = [n.generation for n in sup.masters]
        s = time.perf_counter()
        rolled = sup.rolling_restart(nodes=list(sup.masters))
        steps["rolling_restart of the masters, a client open"] = time.perf_counter() - s
        codes = [r["exit_code"] for r in rolled]
        ends = [_mg_last_generation_ends(sup.log_tail(n, 1 << 20)) for n in sup.masters]
        if codes != [0, 0] or [n.generation for n in sup.masters] != [g + 1 for g in gens] \
                or not all(e.startswith("kernel launches {") for e in ends):
            raise AssertionError(f"migration processes: rolling restart codes {codes}, generations "
                                 f"{[n.generation for n in sup.masters]} from {gens}, old logs end {ends}")
        client.refresh_topology()
        found = _mg_all_found(client, "processes after the roll", "BFA.MEXISTS64", bank, t, k)
        logs = [sup.log_tail(n, 1 << 20) for n in sup.masters + sup.replicas]
    finally:
        if client is not None:
            client.shutdown()
        sup.shutdown()
    launches = {}
    for text in logs:
        for ln in text.splitlines():
            if ln.startswith("kernel launches "):
                for key, v in json.loads(ln[len("kernel launches "):]).items():
                    launches[key] = launches.get(key, 0) + v
    out.update(steps_s=steps, rolling_exit_codes=codes, acked_keys_found=found, children_launches=launches)
    for name, secs in steps.items():
        log(f"migration processes [{card}]: {name}: {secs:.3f} s")
    log(f"migration processes [{card}]: rolling restart exit codes {codes}, each generation +1, each old log "
        f"ends with its kernel launches line; {found} acked keys read 1 after each step; the children's launches "
        + json.dumps({key: v for key, v in launches.items() if v}))
    return out


def mg_rebalance(device, jd: str, card: str) -> dict:
    """Leg d: config 5's records on a server of MG_POSITIONS positions;
    rebalance_devices of half the slots, journaled, killed at each phase
    and resumed; BF.MEXISTS64, GETBIT and GETBITSB replies equal those
    before the moves and a CPU server's."""
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.server.migration import CoordinatorKilled, rebalance_devices, resume_device_rebalances
    from redisson_tpu_torch.utils.crc16 import calc_slot

    rng = np.random.default_rng(227)
    tags = [f"mgd{t}" for t in range(C5_TENANTS)]
    cmds, filters, names, keys = _mg_config5(tags, rng)
    probe = [("BF.MEXISTS64", f, _i8(np.concatenate([keys[f][0], keys[f][0] + 1]))) for f in filters]
    probe += [("GETBIT", n, int(i)) for n in names if n.startswith("mg:bits") for i in rng.integers(0, C5_BITS, 4)]
    probe += [("GETBITSB", n, _i4(rng.integers(0, C5_BITS, C5_BIT_OPS))) for n in names if n.startswith("mg:bits")]
    replies, phases = {}, []
    for where, on in (("cpu", "cpu"), ("card", device)):
        with ServerThread(port=0, device=on, devices=MG_POSITIONS) as st, st.client() as c:
            _mg_run(c, cmds, f"rebalance setup ({where})")
            replies[where] = c.execute_many(probe)
            if where == "cpu":
                continue
            engine = st.server.engine
            p = engine.placement
            slots = sorted({calc_slot(n.encode()) for n in names})
            for phase in MG_DEV_PHASES:
                targets = {s: (p.device_id_for_slot(s) + MG_POSITIONS // 2) % MG_POSITIONS
                           for s in slots[: len(slots) // 2]}
                s = time.perf_counter()
                try:
                    rebalance_devices(engine, targets, journal_dir=jd, crash_after=phase, batch=len(targets) // 2)
                    killed = False
                except CoordinatorKilled:
                    killed = True
                k = time.perf_counter()
                results = resume_device_rebalances(engine, jd)
                e = time.perf_counter()
                want = [] if phase == "STABLE" else ["completed"]
                if not killed or [r["action"] for r in results] != want:
                    raise AssertionError(f"migration rebalance: {phase}: killed {killed}, resume {results}")
                if any(p.device_id_for_slot(s) != d for s, d in targets.items()):
                    raise AssertionError(f"migration rebalance: {phase}: slots not on their targets")
                moved = [n for n in names if engine.store.get_unguarded(n).position
                         != p.device_id_for_slot(calc_slot(n.encode()))]
                if moved:
                    raise AssertionError(f"migration rebalance: {phase}: records off their owner: {moved[:4]}")
                got = c.execute_many(probe)
                if got != replies["card"]:
                    raise AssertionError(f"migration rebalance: {phase}: replies changed by the move")
                phases.append({"phase": phase, "slots": len(targets), "until_kill_s": k - s, "resume_s": e - k,
                               "moved": sum(r["moved"] for r in results)})
    if replies["card"] != replies["cpu"]:
        raise AssertionError("migration rebalance: the card's replies differ from the CPU server's")
    for ph in phases:
        log(f"migration rebalance [{card}]: {ph['slots']} of {C5_TENANTS} slots ({2 * C5_TENANTS} records) over "
            f"{MG_POSITIONS} positions, killed at {ph['phase']} after {ph['until_kill_s']:.3f} s, resumed in "
            f"{ph['resume_s']:.3f} s ({ph['moved']} records moved by the rebalance, as its journal counts); "
            f"{len(probe)} replies equal those before and the CPU's")
    log(f"migration rebalance [{card}]: the {MG_POSITIONS} positions share this one card: a move re-owns a record "
        "and copies nothing; nothing here measures a move between cards")
    return {"phases": phases, "probe_replies": len(probe)}


def run_migration(device="cuda") -> dict:
    """The migration path: leg a (live migration under a writer, in one
    process), b (the coordinator killed after each phase), c (server
    processes: a target SIGKILL, failover, rolling restart) and d (a device
    rebalance over positions on one card)."""
    import tempfile

    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.harness import ClusterRunner
    from redisson_tpu_torch.server import ServerThread

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    out = {}
    with tempfile.TemporaryDirectory(prefix="rtpu-mig-") as tmp:
        runner = ClusterRunner(masters=2, device=device, workers=4, journal_dir=os.path.join(tmp, "a")).run()
        cpu = ServerThread(port=0, device="cpu").start()
        try:
            landed = {m.server.server.engine.device.type for m in runner.masters}
            if landed != {torch.device(device).type}:
                raise AssertionError(f"migration: masters on {landed}, not {device}")
            s = time.perf_counter()
            out["live"], (_, filters, c5_names) = mg_live(runner, cpu.server, os.path.join(tmp, "a"), card)
            out["live"]["seconds"] = time.perf_counter() - s
            s = time.perf_counter()
            out["kills"] = mg_kills(runner, cpu.server, os.path.join(tmp, "a"), card, filters, c5_names)
            out["kills"]["seconds"] = time.perf_counter() - s
        finally:
            cpu.stop()
            runner.shutdown()
            if device != "cpu":
                torch.cuda.empty_cache()
        s = time.perf_counter()
        out["rebalance"] = mg_rebalance(device, os.path.join(tmp, "d"), card)
        out["rebalance"]["seconds"] = time.perf_counter() - s
        out["launches"] = dict(K.launches)  # the processes below launch in their own
        s = time.perf_counter()
        out["processes"] = mg_processes(device, card)
        out["processes"]["seconds"] = time.perf_counter() - s
    out["seconds"] = time.perf_counter() - start
    log(f"migration path [{card}]: {out['seconds']:.1f}s (live {out['live']['seconds']:.1f} s, kills "
        f"{out['kills']['seconds']:.1f} s, rebalance {out['rebalance']['seconds']:.1f} s, processes "
        f"{out['processes']['seconds']:.1f} s)")
    return out


# --------------------------------------------------------------------------
# the residency path: HOT/WARM/COLD tiers on the card (core/residency.py,
# CLUSTER RESIDENCY, DEVEVACUATE, cluster/residency_control.py)
# --------------------------------------------------------------------------

# config 8 (bench.py:2333-2453): 64 tenant filters of 100,000 keys at 1%,
# 512 member keys each, zipf(1.1) popularity over a permutation from seed 8,
# 1,200 sessions of 4 calls of 64 keys, a budget of 1/4 of the footprint
# swept every 50 sessions; the reference's floors (tools/perf_gate.py)
C8_TENANTS, C8_CAP, C8_KEYS, C8_SEED = 64, 100_000, 512, 8
C8_SESSIONS, C8_CALLS, C8_BATCH, C8_SWEEP_EVERY = 1200, 4, 64, 50
C8_HOT_HIT_FLOOR, C8_FAULT_P99_CEILING_MS, C8_OVERCOMMIT_FLOOR = 0.9, 250.0, 4.0
# leg c: config 5's records over 8 positions of the card; leg d: the
# vector bank's width and the bloom records it demotes as it grows
RS_POSITIONS, RS_VEC_DIM, RS_VEC_BLOOMS, RS_VEC_BLOOM_CAP = 8, 128, 6, 100_000


def rs_config8(device, card: str) -> dict:
    """Leg a, config 8 at its own size through create(): the all-HOT leg,
    then the overcommitted leg (budget 1/4 of the measured footprint, a
    sweep every 50 sessions).  Every probe is a member key; the post-sweep
    HOT bytes fit the budget; the overcommit is at least 4x."""
    import redisson_tpu_torch
    from redisson_tpu_torch.core import residency as R

    client = redisson_tpu_torch.create(device=device)
    eng = client._engine
    rng = np.random.default_rng(C8_SEED)
    filters, member = [], []
    for i in range(C8_TENANTS):
        bf = client.get_bloom_filter(f"cfg8:t{i}")
        if not bf.try_init(C8_CAP, FPP):
            raise AssertionError(f"config8: cfg8:t{i} exists")
        keys = np.arange(i * 1_000_000, i * 1_000_000 + C8_KEYS, dtype=np.int64)
        bf.add_all(keys)
        filters.append(bf)
        member.append(keys)
    popularity = 1.0 / np.arange(1, C8_TENANTS + 1, dtype=np.float64) ** 1.1
    popularity /= popularity.sum()
    order = rng.permutation(C8_TENANTS)

    def run_leg(sweep_every):
        mgr = eng.residency
        prom0 = mgr.promotions if mgr is not None else 0
        calls = 0
        t0 = time.perf_counter()
        for s in range(C8_SESSIONS):
            t = int(order[rng.choice(C8_TENANTS, p=popularity)])
            for _ in range(C8_CALLS):
                found = filters[t].contains_each(member[t][rng.integers(0, C8_KEYS, C8_BATCH)])
                calls += 1
                if not np.asarray(found).all():
                    raise AssertionError(f"config8: a false negative on tenant {t} after tier cycling")
            if mgr is not None and sweep_every and s % sweep_every == sweep_every - 1:
                mgr.sweep()
        elapsed = time.perf_counter() - t0
        faults = (mgr.promotions - prom0) if mgr is not None else 0
        return calls * C8_BATCH / elapsed, 1.0 - faults / calls, faults

    try:
        allhot_ops, _, _ = run_leg(0)
        mgr = eng.enable_residency(min_idle_s=0.01)
        hot0 = sum(mgr.hot_bytes_by_device().values())
        budget = max(1, hot0 // 4)
        prev_budget = R.set_device_budget_bytes(budget)
        prev_tier = R.set_tier(True)
        try:
            time.sleep(0.05)  # past min_idle_s, so the first sweep can demote
            mgr.sweep()
            over = sum(mgr.hot_bytes_by_device().values())
            if over > budget:
                raise AssertionError(f"config8: the sweep left {over} HOT bytes over the {budget}-byte budget")
            ops, hot_hit, faults = run_leg(C8_SWEEP_EVERY)
            samples = list(mgr.fault_in_samples)
            p99 = float(np.percentile(samples, 99)) if samples else 0.0
            out = {"config8_overcommit_ops_per_sec": round(ops), "config8_hot_hit_ratio": round(hot_hit, 4),
                   "config8_fault_in_p99_ms": round(p99, 3), "config8_overcommit_ratio": round(hot0 / budget, 2),
                   "config8_allhot_ops_per_sec": round(allhot_ops), "config8_fault_ins": int(faults),
                   "config8_demotions_warm": int(mgr.demotions_warm),
                   "config8_demotions_cold": int(mgr.demotions_cold), "config8_tenants": C8_TENANTS,
                   "config8_budget_bytes": int(budget), "config8_footprint_bytes": int(hot0)}
        finally:
            R.set_tier(prev_tier)
            R.set_device_budget_bytes(prev_budget)
    finally:
        client.shutdown()
    if out["config8_overcommit_ratio"] < C8_OVERCOMMIT_FLOOR:
        raise AssertionError(f"config8: overcommit {out['config8_overcommit_ratio']} under 4x")
    log(f"config8 [{card}]: {C8_TENANTS} tenants, footprint {hot0 / 1e6:.3f} MB, budget {budget / 1e6:.3f} MB "
        f"({hot0 / budget:.2f}x overcommit), post-sweep HOT {over / 1e6:.3f} MB; every probe found")
    log(f"config8 [{card}]: " + json.dumps(out))
    for label, value, bound, met in (
            ("hot-hit ratio", out["config8_hot_hit_ratio"], f">= {C8_HOT_HIT_FLOOR}",
             out["config8_hot_hit_ratio"] >= C8_HOT_HIT_FLOOR),
            ("fault-in p99 ms", out["config8_fault_in_p99_ms"], f"<= {C8_FAULT_P99_CEILING_MS}",
             out["config8_fault_in_p99_ms"] <= C8_FAULT_P99_CEILING_MS)):
        log(f"config8 [{card}]: {label} {value} against the reference's bound {bound} "
            f"(tools/perf_gate.py, not a claim): {'MET' if met else 'NOT MET'}")
    return out


def _rs_tier_cycle(conn, server, name: str, probe, want, cpu_reply, device, card: str) -> list:
    """DEMOTE `name` to WARM, then to COLD (from HOT again), each followed by
    the probe: its reply equals the HOT one and the CPU server's; the
    demotion's and the fault-in's times and bytes, and memory_allocated
    around each."""
    mgr = server.engine.residency
    rows = []
    for cold in (False, True):
        nbytes = sum(int(t.nbytes) for t in server.engine.store.get_unguarded(name).arrays.values())
        on_card = torch.device(device).type == "cuda"
        _sync(torch.device(device))
        m0 = allocated() if on_card else 0
        s = time.perf_counter()
        cmd = ("CLUSTER", "RESIDENCY", "DEMOTE", name) + (("COLD",) if cold else ())
        if conn.execute(*cmd) != 1:
            raise AssertionError(f"residency tiers: {' '.join(cmd)} did not demote")
        demote_s = time.perf_counter() - s
        m1 = allocated() if on_card else 0
        tier = conn.execute("CLUSTER", "RESIDENCY", "TIER", name)
        if tier != (b"cold" if cold else b"warm") or (on_card and m1 > m0 - nbytes):
            raise AssertionError(f"residency tiers: {name} is {tier}, memory_allocated {m0} -> {m1} "
                                 f"(the record holds {nbytes} bytes)")
        n0 = len(mgr.fault_in_samples)
        s = time.perf_counter()
        got = conn.execute(*probe)
        first_s = time.perf_counter() - s
        _sync(torch.device(device))
        m2 = allocated() if on_card else 0
        if len(mgr.fault_in_samples) != n0 + 1:
            raise AssertionError(f"residency tiers: the probe of {name} did not fault it in once")
        rec = server.engine.store.get_unguarded(name)
        if rec.tier != "hot" or any(t.device.type != torch.device(device).type for t in rec.arrays.values()):
            raise AssertionError(f"residency tiers: {name} is not back on the card")
        if got != want or got != cpu_reply:
            raise AssertionError(f"residency tiers: {probe[0]} of {name} differs after a "
                                 f"{'COLD' if cold else 'WARM'} cycle from the HOT reply or the CPU's")
        rows.append({"record": name, "tier": "cold" if cold else "warm", "bytes": nbytes,
                     "demote_ms": demote_s * 1e3, "fault_in_ms": mgr.fault_in_samples[-1],
                     "first_reply_ms": first_s * 1e3, "allocated_before": m0, "after_demote": m1,
                     "after_promote": m2})
        log(f"residency tiers [{card}]: {name} ({nbytes / 1e6:.1f} MB) HOT -> {rows[-1]['tier'].upper()} in "
            f"{rows[-1]['demote_ms']:.3f} ms (DEMOTE round trip), fault-in {rows[-1]['fault_in_ms']:.3f} ms "
            f"(the first {probe[0]} reply {rows[-1]['first_reply_ms']:.3f} ms); memory_allocated {m0} -> {m1} "
            f"-> {m2} bytes; the reply equals the HOT one and the CPU server's")
    return rows


def rs_tiers(device, card: str) -> dict:
    """Leg b: a card server holding config 2's 1,000-tenant bank (96.3 MB)
    and config 3's 10,000 counters (163.8 MB), filled by 1M keys and 1M
    ops; one BFA.MEXISTS64 and one HLLA.ESTIMATE reply while HOT, then
    each record DEMOTEd to WARM and to COLD over the wire, the same
    command after each; replies byte-identical to the HOT ones and a CPU
    server's.  The CLUSTER RESIDENCY table and the METRICS residency rows."""
    from redisson_tpu_torch.server import ServerThread

    rng = np.random.default_rng(131)
    t, ks = config2_ingest()[0]
    fill = [("BFA.RESERVE", "rs:c2", C2_TENANTS, C2_PER_TENANT, FPP), ("HLLA.RESERVE", "rs:c3", C3_TENANTS)]
    fill += [("BFA.MADD64", "rs:c2", _i4(t[i:i + C2_FLUSH]), _i8(ks[i:i + C2_FLUSH]))
             for i in range(0, len(ks), C2_FLUSH)]
    fill.append(("HLLA.MADD64", "rs:c3", _i4(rng.integers(0, C3_TENANTS, C3_BATCH)),
                 _i8(rng.integers(0, 1 << 60, C3_BATCH))))
    probe_t = np.concatenate([t[:C2_FLUSH // 2], rng.integers(0, C2_TENANTS, C2_FLUSH // 2).astype(np.int32)])
    probe_k = np.concatenate([ks[:C2_FLUSH // 2], rng.integers(1 << 40, 1 << 41, C2_FLUSH // 2)])
    probes = {"rs:c2": ("BFA.MEXISTS64", "rs:c2", _i4(probe_t), _i8(probe_k)),
              "rs:c3": ("HLLA.ESTIMATE", "rs:c3")}
    with ServerThread(port=0, device="cpu") as st, st.client() as c:
        c.execute_many(fill)
        cpu = {n: c.execute(*p) for n, p in probes.items()}
    out = {"cycles": []}
    with ServerThread(port=0, device=device, workers=4) as st, st.client() as c:
        for cmd, reply in zip(fill, c.execute_many(fill)):
            if isinstance(reply, Exception):
                raise AssertionError(f"residency tiers: {cmd[0]} replied {reply}")
        if c.execute("CONFIG", "SET", "residency-enabled", "yes") != b"OK":
            raise AssertionError("residency tiers: CONFIG SET residency-enabled refused")
        try:
            hot = {n: c.execute(*p) for n, p in probes.items()}
            found = np.frombuffer(hot["rs:c2"], np.uint8)
            if hot != cpu or not found[:C2_FLUSH // 2].all():
                raise AssertionError("residency tiers: the HOT replies differ from the CPU server's")
            for name in ("rs:c2", "rs:c3"):
                out["cycles"] += _rs_tier_cycle(c, st.server, name, probes[name], hot[name], cpu[name], device,
                                                card)
            table = c.execute("CLUSTER", "RESIDENCY")
            metrics = [ln for ln in bytes(c.execute("METRICS")).decode().splitlines() if "residency_" in ln]
            if not any("residency_bytes_dev0_hot" in ln for ln in metrics):
                raise AssertionError(f"residency tiers: METRICS has no residency rows: {metrics}")
            log(f"residency tiers [{card}]: CLUSTER RESIDENCY {table}")
            log(f"residency tiers [{card}]: METRICS residency rows {metrics}")
            out["table"] = str(table)
        finally:
            c.execute("CONFIG", "SET", "residency-enabled", "no")
    return out


def rs_shed(device, jd: str, card: str) -> dict:
    """Leg c: config 5's records on a server of 8 positions on the card, 16
    tenants on position 0 and 48 over the others; a budget that pressures
    position 0 alone (every record touched within min_idle_s, so a sweep
    frees nothing); ResidencyRebalancer.step() until it has issued SWEEP,
    then SHED (all of position 0's slots); then CLUSTER DEVEVACUATE 1 DIR
    <journal> with position 0's lane flagged quarantined (the flag the
    fault plane sets), so its survivors skip position 0.  BF.MEXISTS64,
    GETBIT and GETBITSB replies equal those before and a CPU server's;
    positions 0 and 1 own no slot at the end."""
    from contextlib import closing

    from redisson_tpu_torch.cluster import ResidencyRebalancer
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server import ServerThread

    rng = np.random.default_rng(233)
    span = 16384 // RS_POSITIONS
    tags = _mg_tags((0, span - 1), "rsz", C5_TENANTS // 4) + _mg_tags((span, 16383), "rsy", C5_TENANTS * 3 // 4)
    cmds, filters, names, keys = _mg_config5(tags, rng)
    bitsets = [n for n in names if n.startswith("mg:bits")]
    probe = [("BF.MEXISTS64", f, _i8(np.concatenate([keys[f][0], keys[f][0] + 1]))) for f in filters]
    probe += [("GETBIT", n, int(i)) for n in bitsets for i in rng.integers(0, C5_BITS, 4)]
    probe += [("GETBITSB", n, _i4(rng.integers(0, C5_BITS, C5_BIT_OPS))) for n in bitsets]
    with ServerThread(port=0, device="cpu", devices=RS_POSITIONS) as st, st.client() as c:
        _mg_run(c, cmds, "residency shed setup (cpu)")
        cpu = c.execute_many(probe)
    out = {}
    with ServerThread(port=0, device=device, devices=RS_POSITIONS, workers=4) as st, st.client() as c:
        srv = st.server
        # armed before the records exist, so each is touched at creation
        srv.enable_residency(min_idle_s=600.0)
        try:
            _mg_run(c, cmds, "residency shed setup (card)")
            before = c.execute_many(probe)
            if before != cpu:
                raise AssertionError("residency shed: the card's replies differ from the CPU server's")
            p = srv.engine.placement
            hot = srv.engine.residency.hot_bytes_by_device()
            others = max(v for d, v in hot.items() if d != 0)
            if hot.get(0, 0) <= others:
                raise AssertionError(f"residency shed: position 0 holds no more than the others: {hot}")
            budget = (hot[0] + others) // 2
            c.execute("CONFIG", "SET", "device-budget-bytes", budget)
            addr = (srv.host, srv.port)
            rb = ResidencyRebalancer({"node": lambda: closing(Connection(*addr, timeout=120.0))},
                                     shed_after=2, shed_count=p.slot_counts()[0], journal_dir=jd)
            steps = []
            s = time.perf_counter()
            while len(steps) < 4 and not any(a == "shed" for _n, a, _d in rb.last_actions):
                t0 = time.perf_counter()
                acts = rb.step()
                steps.append({"actions": acts, "ms": (time.perf_counter() - t0) * 1e3})
            shed_s = time.perf_counter() - s
            kinds = [a for st_ in steps for a in st_["actions"]]
            if kinds != [("node", "sweep", 0), ("node", "shed", 0)] or rb.push_errors:
                raise AssertionError(f"residency shed: the rebalancer's actions {kinds} (errors {rb.push_errors})")
            after_shed = c.execute_many(probe)
            counts_shed = p.slot_counts()
            srv.engine.lanes.lane(0).quarantined = True
            try:
                s = time.perf_counter()
                ev = c.execute("CLUSTER", "DEVEVACUATE", 1, "DIR", jd)
                evac_s = time.perf_counter() - s
            finally:
                srv.engine.lanes.lane(0).quarantined = False
            after = c.execute_many(probe)
            counts = p.slot_counts()
            if isinstance(ev, Exception) or after_shed != before or after != before:
                raise AssertionError(f"residency shed: DEVEVACUATE replied {ev}, or the replies changed")
            if counts[0] or counts[1] or sum(counts) != 16384:
                raise AssertionError(f"residency shed: slot counts at the end {counts}")
            moved = [n for n in names if srv.engine.store.get_unguarded(n).position in (0, 1)]
            if moved:
                raise AssertionError(f"residency shed: records still on positions 0 and 1: {moved[:4]}")
            out = {"budget": budget, "hot_by_position": hot, "steps": steps, "shed_s": shed_s,
                   "slots_after_shed": counts_shed, "evacuate": list(ev), "evacuate_s": evac_s,
                   "slots_after": counts, "probe_replies": len(probe)}
        finally:
            c.execute("CONFIG", "SET", "device-budget-bytes", 0)
            c.execute("CONFIG", "SET", "residency-enabled", "no")
    log(f"residency shed [{card}]: config 5's {len(names)} records over {RS_POSITIONS} positions, position 0 "
        f"{hot[0]} HOT bytes (the most of any other {others}), budget {budget}: the rebalancer issued "
        + ", then ".join(f"{a.upper()} on position {d} ({st_['ms']:.3f} ms)"
                         for st_ in steps for (_n, a, d) in st_["actions"])
        + f" in {shed_s:.3f} s (the sweep freed nothing: every record was touched within min_idle_s); slots "
        f"{counts_shed[:2]} on positions 0 and 1 after the shed")
    log(f"residency shed [{card}]: CLUSTER DEVEVACUATE 1 DIR replied {list(ev)} in {evac_s:.3f} s with position "
        f"0 flagged quarantined; slots {counts}; {len(probe)} BF.MEXISTS64, GETBIT and GETBITSB replies equal "
        "those before and the CPU server's.  The 8 positions share this one card: a move re-owns a record and "
        "copies nothing, and nothing here measures a move between cards")
    return out


def rs_vector(device, card: str) -> dict:
    """Leg d: a vector bank on the card grown past device-budget-bytes
    demotes colder bloom records first; grown further, past what can be
    demoted, it raises VectorBudgetError.  The blooms answer as before once
    the budget is lifted."""
    from redisson_tpu_torch.client.redisson import RedissonTpu
    from redisson_tpu_torch.core import residency as R
    from redisson_tpu_torch.core.engine import Engine
    from redisson_tpu_torch.services.search import SearchService
    from redisson_tpu_torch.services.vector import VectorBudgetError, bank_record_name

    rng = np.random.default_rng(271)
    client = RedissonTpu(Engine(device=device))
    eng = client._engine
    mgr = eng.enable_residency(min_idle_s=0.0)
    prev_tier, prev_budget = R.set_tier(True), R.set_device_budget_bytes(0)
    try:
        blooms, member = [], {}
        for i in range(RS_VEC_BLOOMS):
            name = f"rsv:bf{i}"
            bf = client.get_bloom_filter(name)
            bf.try_init(RS_VEC_BLOOM_CAP, FPP)
            member[name] = rng.integers(0, 1 << 40, 1000)
            bf.add_all(member[name])
            blooms.append(name)
        want = {n: np.asarray(client.get_bloom_filter(n).contains_each(member[n])) for n in blooms}
        bloom_bytes = sum(int(t.nbytes) for n in blooms for t in eng.store.get_unguarded(n).arrays.values())
        svc = SearchService(eng)
        svc.create_index("rsv", {"emb": "VECTOR"}, vector={"emb": {"dim": RS_VEC_DIM}})
        bank = bank_record_name("rsv", "emb")
        rows = [0]

        def fill(n):
            for _ in range(n):
                svc.add_document("rsv", f"rsv:d{rows[0]}", {"emb": rng.standard_normal(RS_VEC_DIM).astype(np.float32)})
                rows[0] += 1

        # grow the bank to the largest power-of-two capacity whose bytes stay
        # at most the blooms' (so one doubling can be paid by demoting them,
        # and the next cannot)
        per_row = RS_VEC_DIM * 4 + 4
        cap0 = 256
        while cap0 * 2 * per_row <= bloom_bytes:
            cap0 *= 2
        fill(cap0)
        svc.knn("rsv", "emb", np.ones(RS_VEC_DIM, np.float32), 5)
        bank_bytes = sum(int(t.nbytes) for t in eng.store.get_unguarded(bank).arrays.values())
        budget = bloom_bytes + bank_bytes + 4096
        R.set_device_budget_bytes(budget)
        _sync(torch.device(device))
        m0 = allocated() if torch.device(device).type == "cuda" else 0
        s = time.perf_counter()
        fill(256)  # one doubling: demote first
        grow_s = time.perf_counter() - s
        warm = [n for n in blooms if mgr.tier_of(n) == R.WARM]
        m1 = allocated() if torch.device(device).type == "cuda" else 0
        if not warm or mgr.tier_of(bank) != R.HOT:
            raise AssertionError(f"residency vector: growth demoted {warm}, the bank is {mgr.tier_of(bank)}")
        try:
            fill(cap0)  # the next doubling: not enough left to demote
            raise AssertionError("residency vector: growth past what can be demoted did not raise")
        except VectorBudgetError as e:
            refused = str(e)
        R.set_device_budget_bytes(0)
        for n in blooms:
            np.testing.assert_array_equal(np.asarray(client.get_bloom_filter(n).contains_each(member[n])), want[n])
        out = {"bloom_bytes": bloom_bytes, "bank_bytes": bank_bytes, "budget": budget, "demoted": len(warm),
               "grow_ms": grow_s * 1e3, "allocated": [m0, m1], "rows": rows[0]}
    finally:
        R.set_tier(prev_tier)
        R.set_device_budget_bytes(prev_budget)
        client.shutdown()
    log(f"residency vector [{card}]: a {RS_VEC_DIM}-wide bank of {bank_bytes} bytes beside {RS_VEC_BLOOMS} "
        f"bloom records of {bloom_bytes} bytes under a {budget}-byte budget: its doubling demoted {len(warm)} "
        f"blooms first ({grow_s * 1e3:.3f} ms for the 256 rows that grew it; memory_allocated {m0} -> {m1}); the "
        f"next doubling raised VectorBudgetError ({refused[:90]}...); the blooms answer as before")
    return out


def run_residency(device="cuda") -> dict:
    """The residency path: (a) config 8 at its own size, (b) config 2's bank
    and config 3's counters through WARM and COLD over the wire, (c) the
    pressure rebalancer's SWEEP and SHED, then DEVEVACUATE, on 8 positions,
    (d) a vector bank's growth demoting colder records, then refused."""
    import tempfile

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    out = {}
    for leg, run in (("config8", lambda: rs_config8(device, card)), ("tiers", lambda: rs_tiers(device, card))):
        s = time.perf_counter()
        out[leg] = run()
        out[leg]["seconds"] = time.perf_counter() - s
    with tempfile.TemporaryDirectory(prefix="rtpu-res-") as jd:
        s = time.perf_counter()
        out["shed"] = rs_shed(device, jd, card)
        out["shed"]["seconds"] = time.perf_counter() - s
    s = time.perf_counter()
    out["vector"] = rs_vector(device, card)
    out["vector"]["seconds"] = time.perf_counter() - s
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    log(f"residency path [{card}]: {out['seconds']:.1f}s (config8 {out['config8']['seconds']:.1f} s, tiers "
        f"{out['tiers']['seconds']:.1f} s, shed {out['shed']['seconds']:.1f} s, vector "
        f"{out['vector']['seconds']:.1f} s)")
    return out


# --------------------------------------------------------------------------
# the faults path: the fault plane and the device-fault domain on the card
# (chaos/faults.py, the lane watchdog and quarantine, CLUSTER DEVPROBE and
# DEVEVACUATE, the -OOM of a vector bank's growth)
# --------------------------------------------------------------------------

# config 2's bank on 8 positions of the card over the wire: 10M keys in 100
# BFA.MADD64 frames, BFA.MEXISTS64 frames of 100,000 keys
FA_FRAME, FA_POSITIONS = C2_FLUSH, 8
# leg b: the card's stream stalled FA_STALL_MS under a FA_WATCHDOG_MS
# watchdog: a frame must reply -TRYAGAIN within FA_TRIP_S
FA_STALL_MS, FA_WATCHDOG_MS, FA_TRIP_S, FA_CAL_CYCLES = 2000.0, 50, 0.5, 50_000_000
# leg c: a FLAT bank of FA_OOM_ROWS rows of FA_OOM_DIM floats, FA_OOM_MORE
# rows left pending (fewer than the bank's block, so the search's flush
# grows it: to twice the rows), FA_OOM_MARGIN bytes of the card left free:
# less than the growth's 33.6 MB, and room for the search's small tensors
# (the caching allocator gives each stream that allocates them a 2 MiB
# segment of its own, and the search touches its lane's stream and the
# default one)
FA_OOM_DIM, FA_OOM_ROWS, FA_OOM_MORE, FA_OOM_MARGIN = 512, 8192, 255, 16 << 20
# leg d: frames timed a variant, K25 probes timed
FA_P50_FRAMES, FA_PINGS = 40, 200
FA_TRYAGAIN = b"-TRYAGAIN device fault during dispatch; retry\r\n"
FA_PASS, FA_FAIL_QUARANTINED = b"*2\r\n:1\r\n:0\r\n", b"*2\r\n:0\r\n:1\r\n"


class _FaWire:
    """One connection to a server: send a wave, read its raw reply spans."""

    def __init__(self, server):
        import socket

        from redisson_tpu_torch.net import resp

        self._resp = resp
        self.sock = socket.create_connection((server.host, server.port), timeout=300)
        self.parser = resp.RespParser(use_native=False)

    def wave(self, cmds) -> list:
        from redisson_tpu_torch.tools import wire_stream as W

        self.sock.sendall(self._resp.encode_commands(list(cmds)))
        raw, got = [], 0
        while got < len(cmds):
            data = self.sock.recv(1 << 22)
            if not data:
                raise AssertionError("faults: the server closed the connection")
            raw.append(data)
            got += len(self.parser.feed(data))
        return W.reply_spans(b"".join(raw))

    def close(self) -> None:
        self.sock.close()


def _fa_devices(wire) -> list:
    """CLUSTER DEVICES without the labels (a position's label names its
    device: cuda:0 or cpu)."""
    from redisson_tpu_torch.net import resp

    (rows,) = resp.RespParser(use_native=False).feed(wire.wave([("CLUSTER", "DEVICES")])[0])
    return [rows[0]] + [[r[0], r[1]] + r[3:] for r in rows[1:]]


def _fa_bulk(span: bytes) -> bytes:
    return span[span.index(b"\r\n") + 2:-2]


def fa_frames() -> tuple:
    """Config 2's fill as BFA.MADD64 frames, the same keys as BFA.MEXISTS64
    frames (every key acked), and two mixed probe frames (config2_flush)."""
    fill, acked = [], []
    for start in range(0, C2_TENANTS * C2_PER_TENANT, FA_FRAME):
        keys = np.arange(start, start + FA_FRAME, dtype=np.int64) * 2654435761
        t = _i4((keys * 40503) % C2_TENANTS)
        fill.append(("BFA.MADD64", "fa:c2", t, _i8(keys)))
        acked.append(("BFA.MEXISTS64", "fa:c2", t, _i8(keys)))
    rng = np.random.default_rng(251)
    mixed = [("BFA.MEXISTS64", "fa:c2", _i4(t), _i8(ks)) for t, ks in (config2_flush(rng) for _ in range(2))]
    return fill, acked, mixed


def fa_injected(server, wire, frames, jd: str) -> tuple:
    """Leg a on one server: config 2's bank filled; a device_kernel streak
    on the bank's owner position (each frame of its own) replies -TRYAGAIN
    until the lane quarantines, then the quarantine reply; CLUSTER DEVICES'
    FAULTS rows; DEVPROBE [0, 1] while the plane faults; DEVEVACUATE moves
    the slots and the bank to a survivor; every acked key found; the mixed
    probes; the plane cleared, DEVPROBE [1, 0].  Returns ([(step,
    replies)], the owner, the plane's injections)."""
    import hashlib

    from redisson_tpu_torch.chaos.faults import FaultSchedule
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.utils.crc16 import calc_slot

    fill, acked, mixed = frames
    out = []

    def step(label, cmds):
        r = wire.wave(cmds)
        out.append((label, r))
        return r

    step("reserve", [("BFA.RESERVE", "fa:c2", C2_TENANTS, C2_PER_TENANT, FPP)])
    h = hashlib.sha256()
    for i in range(0, len(fill), 10):  # ten frames in flight at a time
        for span in wire.wave(fill[i:i + 10]):
            h.update(span)
    out.append(("fill", h.hexdigest()))
    victim = int(server.engine.placement.owner_snapshot()[calc_slot(b"fa:c2")])
    sched = FaultSchedule(25)
    sched.add("device_kernel", port=victim, after=0, count=1000)
    plane = sched.plane()
    with plane.active():
        for k in range(ioplane.quarantine_after()):
            step(f"launch fault {k}", [mixed[0]])
        step("quarantined", [mixed[0]])
        out.append(("devices quarantined", _fa_devices(wire)))
        step("probe faulted", [("CLUSTER", "DEVPROBE", victim)])
        step("evacuate", [("CLUSTER", "DEVEVACUATE", victim, "DIR", jd)])
        out.append(("devices evacuated", _fa_devices(wire)))
        missing = 0
        for i in range(0, len(acked), 10):
            for span in wire.wave(acked[i:i + 10]):
                missing += FA_FRAME - int(np.frombuffer(_fa_bulk(span), np.uint8).sum())
        out.append(("acked keys missing", missing))
        step("mixed", mixed)
    step("probe cleared", [("CLUSTER", "DEVPROBE", victim)])
    out.append(("devices cleared", _fa_devices(wire)))
    return out, victim, dict(plane.injected)


def _fa_check_injected(got: list, victim: int) -> None:
    steps = dict((label, r) for label, r in got)
    faults = [r for label, r in got if label.startswith("launch fault")]
    if faults != [[FA_TRYAGAIN]] * len(faults) or not faults:
        raise AssertionError(f"faults: the launch faults replied {faults}")
    want_q = f"-TRYAGAIN device {victim} quarantined; retry after evacuation\r\n".encode()
    if steps["quarantined"] != [want_q]:
        raise AssertionError(f"faults: the quarantined position replied {steps['quarantined']}")
    row = steps["devices quarantined"][1 + victim][-1]
    if row[:2] != [b"FAULTS", 1] or row[4] != b"kernel_launch":
        raise AssertionError(f"faults: the FAULTS row {row}")
    if steps["probe faulted"] != [FA_FAIL_QUARANTINED] or steps["probe cleared"] != [FA_PASS]:
        raise AssertionError(f"faults: DEVPROBE {steps['probe faulted']} then {steps['probe cleared']}")
    if steps["devices evacuated"][1 + victim][1] != 0 or steps["acked keys missing"] != 0:
        raise AssertionError(f"faults: evacuation left {steps['devices evacuated'][1 + victim][1]} slots, "
                             f"{steps['acked keys missing']} acked keys missing")


def fa_stall(server, wire, mixed, want: list, card: str) -> dict:
    """Leg b: lane-watchdog-ms 50; the owner lane's stream stalled ~2 s by
    torch.cuda._sleep launched under the lane's occupancy (its cycles
    calibrated by CUDA events); a BFA.MEXISTS64 frame replies -TRYAGAIN
    within 0.5 s and the owner's lane records watchdog_timeout; once the
    stall drains, the mixed frames reply as the CPU's and DEVPROBE
    passes."""
    from redisson_tpu_torch.utils.crc16 import calc_slot

    owner = int(server.engine.placement.owner_snapshot()[calc_slot(b"fa:c2")])
    lane = server.engine.lanes.lane(server.engine.placement.devices[owner])
    if wire.wave([("CONFIG", "SET", "lane-watchdog-ms", str(FA_WATCHDOG_MS))]) != [b"+OK\r\n"]:
        raise AssertionError("faults: CONFIG SET lane-watchdog-ms refused")
    try:
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(FA_CAL_CYCLES)
        e1.record()
        e1.synchronize()
        cycles_per_ms = FA_CAL_CYCLES / e0.elapsed_time(e1)
        faults0 = lane.total_faults
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with lane.occupy(1):  # the spin on the owner lane's own stream
            s0.record()
            torch.cuda._sleep(int(cycles_per_ms * FA_STALL_MS))
            s1.record()
        reply = wire.wave([mixed[0]])
        trip_s = time.perf_counter() - t0
        tripped = (lane.total_faults - faults0, lane.last_fault_kind)
        s1.synchronize()
        drained_s = time.perf_counter() - t0
        stall_ms = s0.elapsed_time(s1)
        after = wire.wave(mixed)
        probe = wire.wave([("CLUSTER", "DEVPROBE", owner)])
    finally:
        wire.wave([("CONFIG", "SET", "lane-watchdog-ms", "0")])
    if reply != [FA_TRYAGAIN] or trip_s > FA_TRIP_S:
        raise AssertionError(f"faults stall: a frame behind the stalled stream replied {reply[0][:80]} "
                             f"after {trip_s:.3f} s (limit {FA_TRIP_S} s)")
    if tripped != (1, "watchdog_timeout"):
        raise AssertionError(f"faults stall: the owner's lane recorded {tripped}")
    if after != want or probe != [FA_PASS]:
        raise AssertionError("faults stall: the frames after the stall differ from the CPU's, or DEVPROBE failed")
    out = {"cycles_per_ms": cycles_per_ms, "stall_ms": stall_ms, "trip_s": trip_s, "drained_s": drained_s,
           "watchdog_ms": FA_WATCHDOG_MS}
    log(f"faults stall [{card}]: the stream stalled {stall_ms:.1f} ms ({cycles_per_ms:.0f} cycles/ms); a "
        f"BFA.MEXISTS64 frame replied -TRYAGAIN after {trip_s * 1e3:.1f} ms under a {FA_WATCHDOG_MS} ms "
        f"watchdog, position {owner}'s lane recorded watchdog_timeout; drained at {drained_s:.3f} s, the next "
        f"frames equal the CPU's, DEVPROBE [1, 0]")
    return out


def _fa_topk(span: bytes) -> list:
    """The ids of an FT.SEARCH KNN reply (its scores are float sums whose
    last digit may differ between the card and the host)."""
    from redisson_tpu_torch.net import resp

    (reply,) = resp.RespParser(use_native=False).feed(span)
    return [reply[0]] + [bytes(x) for x in reply[1::2]]


def fa_oom_cmds() -> tuple:
    """Leg c's stream: the index, its rows, the pending rows, the query."""
    rng = np.random.default_rng(252)
    vecs = rng.standard_normal((FA_OOM_ROWS + FA_OOM_MORE, FA_OOM_DIM)).astype(np.float32)
    create = ("FT.CREATE", "fx", "ON", "HASH", "PREFIX", "1", "fx:", "SCHEMA", "emb", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", str(FA_OOM_DIM), "DISTANCE_METRIC", "L2")
    rows = [("HSET", f"fx:{i}", "emb", vecs[i].tobytes()) for i in range(FA_OOM_ROWS)]
    more = [("HSET", f"fx:{i}", "emb", vecs[i].tobytes()) for i in range(FA_OOM_ROWS, len(vecs))]
    knn = ("FT.SEARCH", "fx", "*=>[KNN 10 @emb $v]", "PARAMS", "2", "v", (vecs[3] + 0.01).tobytes(), "NOCONTENT")
    return create, rows, more, knn


def _fa_load(wire, create, rows, more) -> None:
    for cmds in ([create] if create is not None else [], *(rows[i:i + 512] for i in range(0, len(rows), 512)),
                 more):
        bad = [r for r in (wire.wave(cmds) if cmds else []) if r.startswith(b"-")]
        if bad:
            raise AssertionError(f"faults oom: the load replied {bad[0]}")


def _fa_build(wire, cmds) -> None:
    """Leg c's bank: its FA_OOM_ROWS rows, then a search (the index syncs
    its rows into the bank at a search: FA_OOM_ROWS rows, its capacity),
    then FA_OOM_MORE rows that wait for the next search, whose flush grows
    the bank to twice its rows."""
    create, rows, more, knn = cmds
    _fa_load(wire, create, rows, [])
    built = wire.wave([knn])
    if built[0].startswith(b"-"):
        raise AssertionError(f"faults oom: the search that builds the bank replied {built[0][:120]}")
    _fa_load(wire, None, [], more)


def fa_oom_cpu(cmds) -> list:
    """Leg c's want: a CPU server, an injected device_oom at the search's
    growth: [-OOM, the retry's reply]."""
    from redisson_tpu_torch.chaos.faults import FaultSchedule
    from redisson_tpu_torch.server import ServerThread

    create, rows, more, knn = cmds
    with ServerThread(port=0, device="cpu", devices=FA_POSITIONS, workers=4) as st:
        wire = _FaWire(st.server)
        try:
            _fa_build(wire, cmds)
            sched = FaultSchedule(26)
            sched.add("device_oom", after=0, count=1)
            with sched.plane().active():
                oom = wire.wave([knn])
            return oom + wire.wave([knn])
        finally:
            wire.close()


def fa_oom(wire, cmds, want: list, card: str) -> dict:
    """Leg c: the bank filled to FA_OOM_ROWS rows and FA_OOM_MORE pending;
    a ballast sized from mem_get_info leaves FA_OOM_MARGIN bytes, less than
    the growth's; FT.SEARCH replies the fixed -OOM (the CPU's injected one),
    the connection lives; the ballast freed, the retry lands with the CPU's
    top-k; FT.DROPINDEX DD returns memory_allocated to its level before
    (measured after one small index's create, search and drop: knn_select
    keeps a few bytes of state a device and stream from its first call, and
    each lane has a stream of its own, so the level is held net of that
    state, kernels.launch_state_bytes)."""
    from redisson_tpu_torch.core import kernels as K

    create, rows, more, knn = cmds
    warm = ["fw" if a == "fx" else "fw:" if a == "fx:" else a for a in create]
    _fa_load(wire, tuple(warm), [("HSET", f"fw:{i}", "emb", rows[i][3]) for i in range(8)], [])
    wire.wave([("FT.SEARCH", "fw", *knn[2:]), ("FT.DROPINDEX", "fw", "DD")])
    gc.collect()
    m0 = allocated() - sum(K.launch_state_bytes().values())
    _fa_build(wire, cmds)
    growth = 2 * FA_OOM_ROWS * (FA_OOM_DIM * 4 + 4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    ballast, size = None, free - FA_OOM_MARGIN
    while ballast is None:
        try:
            ballast = torch.empty(size, dtype=torch.uint8, device="cuda")
        except torch.OutOfMemoryError:
            size -= 2 << 20
    # the caching allocator may still hold free blocks of the growth's
    # size inside segments a live tensor keeps (empty_cache returns whole
    # segments only); the growth allocates on the default stream, as these
    # do, so they are taken too, until a block of the bank's size is
    # nowhere to be had
    bank_bytes = 2 * FA_OOM_ROWS * FA_OOM_DIM * 4
    absorbed = []
    while True:
        try:
            absorbed.append(torch.empty(bank_bytes, dtype=torch.uint8, device="cuda"))
        except torch.OutOfMemoryError:
            break
    left = torch.cuda.mem_get_info()[0]
    log(f"faults oom [{card}]: free {free} of {total} bytes; ballast {size} bytes and {len(absorbed)} cached "
        f"blocks of {bank_bytes}; {left} bytes left for a growth of {growth} bytes; reserved "
        f"{torch.cuda.memory_reserved()}, allocated {torch.cuda.memory_allocated()}")
    try:
        oom = wire.wave([knn])
        after = (torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
        pong = wire.wave([("PING",)])
    finally:
        del ballast, absorbed
    log(f"faults oom [{card}]: after the search {after[0]} bytes free, reserved {after[1]}, allocated "
        f"{after[2]}")
    retry = wire.wave([knn])
    if oom[0] != want[0] or not oom[0].startswith(b"-OOM device out of memory growing vector bank"):
        raise AssertionError(f"faults oom: the search replied {oom[0][:120]}, the CPU's injected {want[0][:120]}")
    if pong != [b"+PONG\r\n"] or _fa_topk(retry[0]) != _fa_topk(want[1]):
        raise AssertionError(f"faults oom: after the -OOM PING {pong}, the retry {retry[0][:120]} "
                             f"vs the CPU's {want[1][:120]}")
    if wire.wave([("FT.DROPINDEX", "fx", "DD")]) != [b"+OK\r\n"]:
        raise AssertionError("faults oom: FT.DROPINDEX")
    gc.collect()
    torch.cuda.synchronize()
    m1 = allocated() - sum(K.launch_state_bytes().values())
    if m1 != m0:
        raise AssertionError(f"faults oom: memory_allocated net of the launch state {m0} before the leg, "
                             f"{m1} after")
    log(f"faults oom [{card}]: FT.SEARCH replied {oom[0][:-2].decode()}; PING answered; the ballast freed, "
        f"the retry's top-k equals the CPU's; memory_allocated net of the launch state {m0} before and after")
    return {"free": free, "ballast": size, "left": left, "growth": growth, "memory_allocated": m0}


def fa_cost(server, wire, mixed, device, card: str) -> dict:
    """Leg d: a BFA.MEXISTS64 frame's p50 with no plane and with an empty
    plane, in turns; chaos_overhead_bench's shipped/stripped ratio; K25's
    ping timed in the process (CLUSTER DEVPROBE's _dev_probe) and over the
    wire."""
    from redisson_tpu_torch.chaos.faults import FaultSchedule
    from redisson_tpu_torch.server.verbs.admin import _dev_probe
    from redisson_tpu_torch.tools import chaos_overhead_bench as bench

    times = {"none": [], "empty": []}
    empty = FaultSchedule(0).plane()
    for k in range(2 * FA_P50_FRAMES):
        variant = ("none", "empty")[k % 2]
        with (empty.active() if variant == "empty" else contextlib.nullcontext()):
            s = time.perf_counter()
            wire.wave([mixed[k % 2]])
            times[variant].append((time.perf_counter() - s) * 1e3)
    p50 = {k: statistics.median(v) for k, v in times.items()}
    ratio = bench.measure(batches=20, pipeline=500, rounds=3, device=device)
    pos = server.engine.placement.n_devices - 1
    probe = [None]

    def ping():
        probe[0] = _dev_probe(server, pos)

    ping_ms = _wall_ms(ping, torch.device(device), reps=FA_PINGS)
    if probe[0] != [1, 0]:
        raise AssertionError(f"faults: K25's ping replied {probe[0]}")
    wire_ms = []
    for _ in range(FA_PINGS // 4):
        s = time.perf_counter()
        if wire.wave([("CLUSTER", "DEVPROBE", pos)]) != [FA_PASS]:
            raise AssertionError("faults: DEVPROBE over the wire failed")
        wire_ms.append((time.perf_counter() - s) * 1e3)
    dev = torch.device(device)
    plain_ms = _wall_ms(lambda: int((torch.arange(8, dtype=torch.int32, device=dev) + 1).sum()), dev,
                        reps=FA_PINGS)
    out = {"frame_p50_ms": p50, "bench": ratio, "ping_ms": ping_ms, "ping_wire_ms": statistics.median(wire_ms),
           "ping_plain_ms": plain_ms}
    log(f"faults cost [{card}]: a 100,000-key BFA.MEXISTS64 frame p50 {p50['none']:.3f} ms with no plane, "
        f"{p50['empty']:.3f} ms with an empty plane; chaos_overhead_bench shipped/none "
        f"{ratio['shipped/none']:.0f} ops/s, empty plane {ratio['shipped/empty-plane']:.0f}, stripped "
        f"{ratio['stripped']:.0f}: ratio {ratio['ratio']:.3f} (the reference aims at >= 0.97); K25's ping "
        f"{ping_ms:.4f} ms in the process ({plain_ms:.4f} ms for its ops alone), {out['ping_wire_ms']:.3f} ms "
        f"over the wire")
    return out


def run_faults(device="cuda") -> dict:
    """The faults path on a server of 8 positions of the card (devices=8;
    "all" is one position a card) with config 2's bank: (a) injected launch faults, the
    quarantine, DEVPROBE and DEVEVACUATE, every reply the CPU server's for
    the same stream and schedule; (b) a real stall of the card's stream
    under the armed watchdog; (c) a real CUDA OOM at a vector bank's growth;
    (d) the disarmed cost and K25's ping."""
    import tempfile

    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.server.verbs import admin

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    frames = fa_frames()
    out = {}
    with tempfile.TemporaryDirectory(prefix="rtpu-faults-") as jd:
        # the CPU server's stream first, closed before the card's opens:
        # the lanes' fault ledger is process-wide by position id
        s = time.perf_counter()
        with ServerThread(port=0, device="cpu", devices=FA_POSITIONS, workers=4) as cpu:
            wire = _FaWire(cpu.server)
            try:
                want, victim_cpu, injected_cpu = fa_injected(cpu.server, wire, frames, f"{jd}/cpu")
            finally:
                wire.close()
        cpu_s = time.perf_counter() - s
        oom_cmds = fa_oom_cmds()
        oom_want = fa_oom_cpu(oom_cmds)
        with ServerThread(port=0, device=device, devices=FA_POSITIONS, workers=4) as st:
            if st.server.engine.placement.n_devices != FA_POSITIONS:
                raise AssertionError("faults: the card server has "
                                     f"{st.server.engine.placement.n_devices} positions")
            wire = _FaWire(st.server)
            try:
                admin.probe_pings = 0  # the card's K25 pings, from 0 just before its legs
                s = time.perf_counter()
                got, victim, injected = fa_injected(st.server, wire, frames, f"{jd}/card")
                out["injected"] = {"seconds": time.perf_counter() - s, "cpu_seconds": cpu_s,
                                   "victim": victim, "faults_injected": injected}
                if victim != victim_cpu or injected != injected_cpu:
                    raise AssertionError(f"faults: owner {victim} vs the CPU's {victim_cpu}, injected "
                                         f"{injected} vs {injected_cpu}")
                for (label, a), (_l, b) in zip(got, want):
                    if a != b:
                        raise AssertionError(f"faults: {label} differs from the CPU server's: {str(a)[:300]} "
                                             f"vs {str(b)[:300]}")
                _fa_check_injected(got, victim)
                log(f"faults injected [{card}]: a device_kernel streak on position {victim} replied "
                    f"-TRYAGAIN {ioplane.quarantine_after()} times, then the quarantine reply; DEVPROBE "
                    f"[0, 1]; DEVEVACUATE {dict(got)['evacuate'][0]!r}; every one of "
                    f"{C2_TENANTS * C2_PER_TENANT} acked keys found; DEVPROBE [1, 0] once cleared; every "
                    f"reply the CPU server's ({out['injected']['seconds']:.1f} s, the CPU's {cpu_s:.1f} s)")
                mixed_want = dict(want)["mixed"]
                s = time.perf_counter()
                out["stall"] = fa_stall(st.server, wire, frames[2], mixed_want, card)
                out["stall"]["seconds"] = time.perf_counter() - s
                s = time.perf_counter()
                out["oom"] = fa_oom(wire, oom_cmds, oom_want, card)
                out["oom"]["seconds"] = time.perf_counter() - s
                s = time.perf_counter()
                out["cost"] = fa_cost(st.server, wire, frames[2], device, card)
                out["cost"]["seconds"] = time.perf_counter() - s
                probes = admin.probe_pings
            finally:
                wire.close()
    if probes == 0:
        raise AssertionError("faults: no K25 ping reached the card")
    cost = out["cost"]
    # launches: main() multiplies the probes by the kernels a probe launches
    out["k25"] = {"name": K25_KEY, "route": "torch ops",
                  "source": "redisson_tpu_torch/server/verbs/admin.py",
                  "replaces": "redisson_tpu/server/verbs/admin.py:500", "probes": probes,
                  "max_abs_err": 0.0, "ms": cost["ping_ms"], "plain_ms": cost["ping_plain_ms"],
                  "wire_ms": cost["ping_wire_ms"], "bound_ms": bound_ms(2 * 8 * 4, 8)[0],
                  "bound_by": bound_ms(2 * 8 * 4, 8)[1], "library_ms": None}
    out["seconds"] = time.perf_counter() - start
    log(f"faults path [{card}]: {out['seconds']:.1f}s (injected {out['injected']['seconds']:.1f} s, stall "
        f"{out['stall']['seconds']:.1f} s, oom {out['oom']['seconds']:.1f} s, cost {cost['seconds']:.1f} s)")
    return out


# --------------------------------------------------------------------------
# the soak path: two of chaos/soak.py's harnesses on 8 positions of the card
# --------------------------------------------------------------------------

SK_POSITIONS = 8


def sk_engines(harness) -> list:
    """The engines a soak harness built: its cluster's nodes, its server,
    its embedded client."""
    runner = getattr(harness, "_runner", None)
    nodes = runner.masters + runner.replicas if runner is not None else []
    server = getattr(harness, "_server", None)
    embedded = getattr(harness, "_embedded", None)
    return ([n.server.server.engine for n in nodes] + ([server.server.engine] if server is not None else [])
            + ([embedded._engine] if embedded is not None else []))


def sk_leg(name: str, harness, device, card: str, timed=()) -> dict:
    """Run one harness; its setup is checked to have put every engine on
    `device` before the leg's workload starts, and each method named in
    `timed` has its wall seconds a call recorded.  A failed assertion of
    the harness is not caught: it fails the script."""
    setup, kind = harness._setup, torch.device(device).type
    steps = {m: [] for m in timed}

    def timing(method, fn):
        def run(*a, **k):
            s = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                steps[method].append(time.perf_counter() - s)
        return run

    for m in timed:
        setattr(harness, m, timing(m, getattr(harness, m)))

    def checked_setup():
        setup()
        engines = sk_engines(harness)
        where = sorted({e.device.type for e in engines})
        if not engines or where != [kind]:
            raise AssertionError(f"soak {name}: the harness's engines are on {where}, not {kind}")

    harness._setup = checked_setup
    s = time.perf_counter()
    report = harness.run()
    seconds = time.perf_counter() - s
    log(f"soak {name} [{card}]: {seconds:.1f} s{''.join(f', {m} {v} s' for m, v in steps.items())}: "
        f"{report.summary()}")
    return {"seconds": seconds, "summary": report.summary(), "report": report, **steps}


def run_soak(device="cuda") -> dict:
    """The soak path, last: (a) the standard profile (transport faults, a
    master kill, failover and recovery, the embedded sharded bloom array
    resharded 4 -> 8 -> 4) and (b) the device-shard profile (one server on
    8 positions, the slot table rebalanced 8 -> 4 -> 8), both on 8
    positions of the card, the harnesses' own assertions the gates."""
    from redisson_tpu_torch.chaos import soak
    from redisson_tpu_torch.core import kernels as K

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    on_card = torch.device(device).type == "cuda"
    out = {"memory_allocated_before": allocated() if on_card else 0}
    a = sk_leg("standard", soak.SoakHarness(soak.SoakConfig(
        cycles=1, seconds_per_phase=1.0, device=device, positions=SK_POSITIONS)), device, card,
        timed=("_kill_failover_recover", "_bloom_phase"))
    ra = a.pop("report")
    if ra.cycles_completed != 1 or not ra.failovers or not ra.verified_writes \
            or not ra.bloom_keys_verified or len(ra.census) != 1:
        raise AssertionError(f"soak standard: {ra.summary()}")
    out["standard"] = {**a, "acked_writes": ra.acked_writes, "verified_writes": ra.verified_writes,
                       "errors": ra.errors, "failovers": len(ra.failovers),
                       "bloom_keys_verified": ra.bloom_keys_verified, "injected_faults": ra.injected_faults}
    b = sk_leg("device_shard", soak.DeviceShardSoakHarness(soak.DeviceShardSoakConfig(
        cycles=1, device=device, positions=SK_POSITIONS)), device, card, timed=("_rebalance",))
    rb = b.pop("report")
    if rb.cycles_completed != 1 or rb.rebalances != 2 or rb.stale_reads or rb.host_colocations \
            or not rb.bloom_keys_verified:
        raise AssertionError(f"soak device_shard: {rb.summary()}")
    out["device_shard"] = {**b, "writes_acked": rb.writes_acked, "reads": rb.reads, "errors": rb.errors,
                           "rebalances": rb.rebalances, "records_moved": rb.records_moved,
                           "bloom_keys_verified": rb.bloom_keys_verified,
                           "host_colocations": rb.host_colocations}
    out["launches"] = dict(K.launches)
    out["window_launches"] = dict(K.window_launches)
    # the reshard leg's sharded bloom array: windowed probes and sets
    missing = [k for k in ("bloom_probe", "bloom_set") if out["window_launches"][k] == 0]
    if missing:
        raise AssertionError(f"soak: the path never launched the windowed {missing}")
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        out["memory_allocated_after"] = allocated()
        torch.cuda.empty_cache()
    else:
        out["memory_allocated_after"] = 0
    out["seconds"] = time.perf_counter() - start
    log(f"soak path [{card}]: {out['seconds']:.1f}s (standard {a['seconds']:.1f} s, device_shard "
        f"{b['seconds']:.1f} s); memory_allocated {out['memory_allocated_before']} before the path, "
        f"{out['memory_allocated_after']} after; window launches {out['window_launches']}")
    return out


# the multicard path (run_multicard): (a) a lane stream for each position,
# on one card; (b) positions over every card of the host
MC_POSITIONS = 8
MC_WATCHDOG_MS, MC_SPIN_MS, MC_RACE_SPIN_MS = 50, 500, 100
MC_FRAME_KEYS, MC_FRAMES = 10_000, 6      # a position 1-7 frame's keys; frames each while position 0 spins
MC_FILTER_N = 200_000                     # each position's filter: capacity, and the keys added to it
MC_RACE_N = 1 << 20                       # the DEL race's filter
MC_WRITERS, MC_WRITER_FRAME = 16, 2_000   # the rebalance's writer: filters and keys a frame
MC_C5D_CONNS = 8


def one_card(device) -> str:
    """`device` with its index: a path's positions on one card stay on it
    on a host with several (parallel/mesh.local_devices)."""
    d = torch.device(device)
    return str(d if d.type != "cuda" or d.index is not None else torch.device("cuda", 0))


def mc_names(placement, prefix: str) -> list:
    """One name a position, each owned by that position."""
    names = [None] * placement.n_devices
    i = 0
    while any(n is None for n in names):
        n = f"{prefix}{i}"
        p = placement.device_id_for_name(n)
        if names[p] is None:
            names[p] = n
        i += 1
    return names


def mc_cycles_per_ms() -> float:
    torch.cuda._sleep(1_000_000)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(FA_CAL_CYCLES)
    e1.record()
    e1.synchronize()
    return FA_CAL_CYCLES / e0.elapsed_time(e1)


def mc_setup(names, rng) -> tuple:
    """Each position's filter filled with MC_FILTER_N keys, and each position
    1-7's MC_FRAMES probe frames (half the keys present)."""
    keys = {n: rng.integers(0, 1 << 62, MC_FILTER_N).astype(np.int64) for n in names}
    cmds = [("BF.RESERVE", n, FPP, MC_FILTER_N) for n in names]
    cmds += [("BF.MADD64", n, _i8(keys[n])) for n in names]
    frames = {}
    for p, n in enumerate(names):
        fr = []
        for _ in range(MC_FRAMES):
            ks = np.concatenate([rng.choice(keys[n], MC_FRAME_KEYS // 2),
                                 rng.integers(0, 1 << 62, MC_FRAME_KEYS - MC_FRAME_KEYS // 2)])
            fr.append(("BF.MEXISTS64", n, _i8(ks)))
        frames[p] = fr
    return cmds, frames


def mc_del_race(eng, name: str, cycles_per_ms: float) -> dict:
    """A filter made off the lanes (its plane's block in the default
    stream's pool) is probed on its owner's lane behind a spin; while the
    probe waits, the record is deleted from outside the lane and a buffer
    of the plane's size filled with ones is allocated on the default
    stream.  The allocator must not hand the plane's block out under the
    pending probe, and the probe's flags must equal the plain version's."""
    from redisson_tpu_torch.client.objects.bloom import BloomFilter
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.core.engine import Engine

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 62, MC_RACE_N).astype(np.int64)
    probe = np.concatenate([keys[: MC_RACE_N // 2], rng.integers(0, 1 << 62, MC_RACE_N // 2)]).astype(np.int64)
    plain = Engine(device="cpu")
    try:
        pbf = BloomFilter(plain, name)
        pbf.try_init(MC_RACE_N, FPP)
        pbf.add_all(keys)
        want = pbf.contains_each(probe)
    finally:
        plain.shutdown()
    bf = BloomFilter(eng, name)
    bf.try_init(MC_RACE_N, FPP)
    bf.add_all(keys)
    torch.cuda.synchronize()
    plane = eng.store.get(name).arrays["bits"]
    ptr, nbytes, dev = plane.data_ptr(), plane.numel(), plane.device
    del plane
    lane = eng.lanes.lane(eng.placement.devices[eng.placement.device_id_for_name(name)])
    end = torch.cuda.Event()
    with lane.occupy(1):
        torch.cuda._sleep(int(cycles_per_ms * MC_RACE_SPIN_MS))
        found, n = bf.contains_each_async(probe)
        fut = ioplane.ReadbackFuture((found,), lambda h: K.unpack_found(h[0], n))
        end.record()
    if not eng.store.delete(name):
        raise AssertionError("multicard DEL race: the record was not there to delete")
    junk = torch.full((nbytes,), 255, dtype=torch.uint8, device=dev)
    pending = not end.query()
    reused = junk.data_ptr() == ptr
    got = fut.result()
    if not pending:
        raise AssertionError("multicard DEL race: the probe had finished before the DEL; the race was not run")
    if reused or not np.array_equal(got, want):
        raise AssertionError(f"multicard DEL race: block reused under the probe {reused}, flags equal the plain "
                             f"version's {np.array_equal(got, want)}")
    del junk
    return {"keys": MC_RACE_N, "probe": int(probe.size), "block_reused": reused}


def mc_streams(card: str) -> dict:
    """Leg (a), on any card count: a devices=8 server with every position on
    one card.  Position 0's lane runs a MC_SPIN_MS device spin under a
    MC_WATCHDOG_MS lane watchdog while positions 1-7 each serve MC_FRAMES
    BF.MEXISTS64 frames on their own connections: every such frame replies
    before the spin ends, equal to a CPU server's, and only position 0's
    lane trips (a future made behind the spin, and a frame to position 0,
    reply LaneWatchdogTimeout and -TRYAGAIN).  Then the DEL race
    (mc_del_race) on position 1."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server import ServerThread

    dev = one_card("cuda")
    replies, out = {}, {}
    for where in ("cpu", "card"):
        rng = np.random.default_rng(301)
        with ServerThread(port=0, device="cpu" if where == "cpu" else dev, devices=MC_POSITIONS,
                          workers=16) as st:
            eng = st.server.engine
            names = mc_names(eng.placement, "mc:a")
            cmds, frames = mc_setup(names, rng)
            conns = [Connection(st.server.host, st.port, timeout=120.0) for _ in range(MC_POSITIONS)]
            try:
                setup = conns[0].execute_many(cmds)
                if any(isinstance(r, Exception) for r in setup):
                    raise AssertionError(f"multicard streams: setup failed ({where})")
                if where == "cpu":
                    replies["cpu"] = {p: conns[p].execute_many(frames[p]) for p in range(1, MC_POSITIONS)}
                    continue
                if {str(q.device) for q in eng.placement.devices} != {str(dev)}:
                    raise AssertionError(f"multicard streams: positions on {eng.placement.devices}")
                streams = {lane.dev_id: lane.stream for lane in eng.lanes.lanes()}
                if len({s.cuda_stream for s in streams.values()}) != MC_POSITIONS:
                    raise AssertionError("multicard streams: the lanes do not have a stream each")
                for p in range(MC_POSITIONS):  # every kernel and copy loaded before the spin
                    conns[p].execute_many(frames[p][:2])
                torch.arange(8, device=dev).cpu()
                cycles_per_ms = mc_cycles_per_ms()
                lanes = [eng.lanes.lane(eng.placement.devices[p]) for p in range(MC_POSITIONS)]
                faults0 = [ln.total_faults for ln in lanes]
                conns[0].execute("CONFIG", "SET", "lane-watchdog-ms", str(MC_WATCHDOG_MS))
                lat = {p: [] for p in range(1, MC_POSITIONS)}
                first = {}
                got = {}
                errs = []
                try:
                    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    with lanes[0].occupy(1):
                        s0.record()
                        torch.cuda._sleep(int(cycles_per_ms * MC_SPIN_MS))
                        s1.record()
                        behind = ioplane.ReadbackFuture((torch.arange(8, device=dev),))
                    t0 = time.perf_counter()

                    def serve(p):
                        try:
                            got[p] = []
                            for fr in frames[p]:
                                s = time.perf_counter()
                                got[p].append(conns[p].execute_many([fr])[0])
                                lat[p].append(time.perf_counter() - s)
                                first.setdefault(p, time.perf_counter() - t0)
                        except Exception as e:  # noqa: BLE001 — raised below
                            errs.append(e)

                    threads = [threading.Thread(target=serve, args=(p,), daemon=True)
                               for p in range(1, MC_POSITIONS)]
                    for th in threads:
                        th.start()
                    p0 = conns[0].execute_many(frames[0][1:2])[0]
                    for th in threads:
                        th.join()
                    served_s = time.perf_counter() - t0
                    spin_running = not s1.query()
                    try:
                        behind.result()
                        tripped = False
                    except ioplane.LaneWatchdogTimeout:
                        tripped = True
                    s1.synchronize()
                    spin_ms = s0.elapsed_time(s1)
                finally:
                    conns[0].execute("CONFIG", "SET", "lane-watchdog-ms", "0")
                if errs:
                    raise errs[0]
                faults = [ln.total_faults - f for ln, f in zip(lanes, faults0)]
                bad = [p for p in got if any(isinstance(r, Exception) for r in got[p])]
                if bad or not spin_running:
                    raise AssertionError(f"multicard streams: positions {bad} replied errors, or their frames "
                                         f"ended after the spin ({served_s * 1e3:.1f} ms, each position's first "
                                         f"reply by {max(first.values()) * 1e3:.1f} ms, spin {spin_ms:.1f} ms)")
                if not tripped or not faults[0] or any(faults[1:]) or lanes[0].last_fault_kind != "watchdog_timeout":
                    raise AssertionError(f"multicard streams: faults by lane {faults}, position 0 tripped {tripped}")
                if not (isinstance(p0, Exception) and "TRYAGAIN" in str(p0)):
                    raise AssertionError(f"multicard streams: position 0's frame behind the spin replied {p0!r:.80}")
                probe = conns[0].execute("CLUSTER", "DEVPROBE", 0)
                replies["card"] = got
                all_lat = [x for v in lat.values() for x in v]
                out = {"positions": MC_POSITIONS, "spin_ms": spin_ms, "watchdog_ms": MC_WATCHDOG_MS,
                       "frames": len(all_lat), "frame_keys": MC_FRAME_KEYS, "served_ms": served_s * 1e3,
                       "first_reply_ms": max(first.values()) * 1e3,
                       "p50_ms": pctl(all_lat, 50) * 1e3, "p99_ms": pctl(all_lat, 99) * 1e3,
                       "faults_by_lane": faults, "devprobe_after": [int(x) for x in probe],
                       "launch_state_bytes": sum(K.launch_state_bytes().values())}
                out["del_race"] = mc_del_race(eng, names[1] + ":race", cycles_per_ms)
            finally:
                for c in conns:
                    c.close()
    for p in range(1, MC_POSITIONS):
        if not all(same(a, b) for a, b in zip(replies["card"][p], replies["cpu"][p])):
            raise AssertionError(f"multicard streams: position {p}'s replies differ from the CPU server's")
    log(f"multicard streams [{card}; {MC_POSITIONS} positions of one card, a stream each]: position 0's lane "
        f"spun {out['spin_ms']:.1f} ms under a {MC_WATCHDOG_MS} ms watchdog; {out['frames']} BF.MEXISTS64 frames "
        f"of {MC_FRAME_KEYS} keys to positions 1-7 replied in {out['served_ms']:.1f} ms (each position's first "
        f"by {out['first_reply_ms']:.1f} ms), before the spin ended: "
        f"p50 {out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms, equal to the CPU server's; faults by lane "
        f"{out['faults_by_lane']} (position 0's future and frame: LaneWatchdogTimeout, -TRYAGAIN); DEVPROBE 0 "
        f"after the spin {out['devprobe_after']}; the shared launch state {out['launch_state_bytes']} bytes over "
        f"every (kernel, card, stream)")
    log(f"multicard DEL race [{card}]: a {MC_RACE_N}-key filter deleted off its lane while position 1's probe "
        f"of {2 * (MC_RACE_N // 2)} keys waited behind a {MC_RACE_SPIN_MS} ms spin; the plane's block was not "
        "handed out under it and the flags equal the plain version's")
    return out


def mc_on_owner_cards(eng, label: str) -> int:
    """Every record's tensors on its owner position's card; the count of
    tensors checked."""
    p = eng.placement
    n = 0
    for name in eng.store.keys():
        rec = eng.store.get_unguarded(name)
        if rec is None or rec.position is None:
            continue
        want = torch.device(p.devices[rec.position].device)
        for key, a in rec.arrays.items():
            if isinstance(a, torch.Tensor):
                n += 1
                if a.device != want:
                    raise AssertionError(f"multicard {label}: {name}.{key} on {a.device}, its owner "
                                         f"position {rec.position} on {want}")
    return n


def mc_k13(conn, cpu_conn, eng, cpu_eng, card: str) -> dict:
    """K13 across cards: counters and bit sets on positions of different
    cards, PFMERGE, PFCOUNT over several keys and BITOP OR/XOR: replies
    equal a CPU server's, the merged registers and planes its bit for bit,
    and no value through the host."""
    from redisson_tpu_torch.core import ioplane

    hs, bs = mc_names(eng.placement, "mc:kh"), mc_names(eng.placement, "mc:kb")
    rng = np.random.default_rng(17)
    cmds = []
    for h, b in zip(hs, bs):
        cmds.append(("PFADD", h, *[b"k%d" % int(x) for x in rng.integers(0, 1 << 40, 2000)]))
        cmds += [("SETBIT", b, int(x), 1) for x in rng.integers(0, 1 << 16, 64)]
    cmds += [("PFCOUNT", *hs), ("PFMERGE", hs[0], *hs[1:]), ("PFCOUNT", hs[0]),
             ("BITOP", "OR", bs[0], *bs), ("BITCOUNT", bs[0]), ("BITOP", "XOR", bs[1], *bs[1:]),
             ("BITCOUNT", bs[1])]
    before = ioplane.STATS.snapshot()
    got = conn.execute_many(cmds)
    after = ioplane.STATS.snapshot()
    want = cpu_conn.execute_many(cmds)
    if not all(same(a, b) for a, b in zip(got, want)):
        raise AssertionError("multicard K13: replies differ from the CPU server's")
    for name, key in ((hs[0], "regs"), (bs[0], "bits"), (bs[1], "bits")):
        assert_equal(f"multicard K13 {name}", eng.store.get(name).arrays[key].cpu(),
                     cpu_eng.store.get(name).arrays[key])
    cards = sorted({str(eng.placement.devices[eng.store.get(h).position].device) for h in hs})
    d2d = after["d2d_colocations"] - before["d2d_colocations"]
    host = after["host_colocations"] - before["host_colocations"]
    if len(cards) < 2 or not d2d or host:
        raise AssertionError(f"multicard K13: sources on {cards}, {d2d} peer copies, {host} through the host")
    log(f"multicard K13 [{card}]: PFMERGE and PFCOUNT over {len(hs)} counters and BITOP OR/XOR over {len(bs)} bit "
        f"sets on {cards}: replies, registers and planes equal the CPU server's; {d2d} peer copies of "
        f"{after['d2d_bytes'] - before['d2d_bytes']} bytes, none through the host")
    return {"cards": cards, "peer_copies": d2d, "host_colocations": host}


def mc_rebalance(st, conn, card: str) -> list:
    """A live rebalance 8 -> 4 -> 8 under a writer: positions 4-7's slots
    go to positions 1, 2, 3, 0 (another card each on two or four cards),
    then every slot back to its first owner; each step's seconds, the
    bytes its peer copies moved and their GB/s; after each step every
    acked key reads back and every record sits on its owner's card."""
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.net.client import Connection
    from redisson_tpu_torch.server.migration import rebalance_devices

    eng = st.server.engine
    p = eng.placement
    first = p.owner_snapshot().copy()
    writers = [f"mc:w{j}" for j in range(MC_WRITERS)]
    if any(isinstance(r, Exception) for r in conn.execute_many([("BF.RESERVE", w, FPP, 1_000_000)
                                                                 for w in writers])):
        raise AssertionError("multicard rebalance: reserve failed")
    acked = {w: [] for w in writers}
    stop = threading.Event()
    errs, tryagain = [], [0]
    wconn = Connection(st.server.host, st.port, timeout=120.0)

    def writer():
        rng = np.random.default_rng(29)
        j = 0
        try:
            while not stop.is_set():
                w = writers[j % MC_WRITERS]
                ks = rng.integers(0, 1 << 62, MC_WRITER_FRAME).astype(np.int64)
                r = wconn.execute_many([("BF.MADD64", w, _i8(ks))])[0]
                if isinstance(r, Exception):
                    if "TRYAGAIN" not in str(r):
                        raise AssertionError(f"writer: {r}")
                    tryagain[0] += 1
                else:
                    acked[w].append(ks)
                j += 1
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append(e)

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    steps = []
    try:
        time.sleep(0.2)
        plan = (("8 -> 4", {int(s): (int(o) - 3) % 4 for s, o in enumerate(first) if o >= 4}),
                ("4 -> 8", {int(s): int(o) for s, o in enumerate(first) if o >= 4}))
        for label, targets in plan:
            before = ioplane.STATS.snapshot()
            torch.cuda.synchronize()
            s = time.perf_counter()
            moved = rebalance_devices(eng, targets)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            secs = time.perf_counter() - s
            after = ioplane.STATS.snapshot()
            nbytes = after["d2d_bytes"] - before["d2d_bytes"]
            tensors = mc_on_owner_cards(eng, f"rebalance {label}")
            snap = {w: list(v) for w, v in acked.items()}
            n_acked = sum(k.size for v in snap.values() for k in v)
            got = conn.execute_many([("BF.MEXISTS64", w, _i8(np.concatenate(v))) for w, v in snap.items() if v])
            lost = sum(int((np.frombuffer(r, np.uint8) == 0).sum()) for r in got)
            if lost or any(isinstance(r, Exception) for r in got):
                raise AssertionError(f"multicard rebalance {label}: {lost} acked keys lost")
            if after["host_colocations"] != before["host_colocations"]:
                raise AssertionError(f"multicard rebalance {label}: a move went through the host")
            steps.append({"step": label, "slots": len(targets), "records_moved": moved, "seconds": secs,
                          "bytes": nbytes, "gb_per_s": nbytes / secs / 1e9, "acked_keys": n_acked,
                          "tensors_on_owner_cards": tensors})
    finally:
        stop.set()
        th.join()
        wconn.close()
    if errs:
        raise errs[0]
    for st in steps:
        log(f"multicard rebalance {st['step']} [{card}]: {st['slots']} slots, {st['records_moved']} records "
            f"re-owned in {st['seconds']:.3f} s, {st['bytes']} bytes by peer copies ({st['gb_per_s']:.2f} GB/s "
            f"over the step's wall clock); {st['acked_keys']} acked keys read back, "
            f"{st['tensors_on_owner_cards']} tensors on their owners' cards; writer -TRYAGAIN {tryagain[0]}")
    return steps


def mc_cards(card: str) -> dict:
    """Leg (b), on two or more cards: a devices=8 server round robin over
    every card holding config 2's bank and config 3's counters; K13 across
    cards; a sharded bloom (dp 2 x shard 4) over the cards beside one-card
    objects; config 5d's stream on every card beside one card; the mixed
    stream RESP2 and RESP3 equal a CPU server's; a live rebalance 8 -> 4 ->
    8 under a writer."""
    import redisson_tpu_torch
    from redisson_tpu_torch.config import Config
    from redisson_tpu_torch.core import ioplane
    from redisson_tpu_torch.core import kernels as K
    from redisson_tpu_torch.parallel.manager import MeshManager
    from redisson_tpu_torch.server import ServerThread
    from redisson_tpu_torch.tools import wire_stream as W

    n_cards = torch.cuda.device_count()
    out = {"cards": n_cards}
    io0 = ioplane.STATS.snapshot()
    with ServerThread(port=0, device="cuda", devices=MC_POSITIONS, workers=16) as st, st.client() as c, \
            ServerThread(port=0, device="cpu", devices=MC_POSITIONS, workers=4) as cpu, cpu.client() as cc:
        eng = st.server.engine
        cards = sorted({str(q.device) for q in eng.placement.devices})
        if len(cards) != n_cards:
            raise AssertionError(f"multicard cards: positions on {cards} of {n_cards} cards")
        s = time.perf_counter()
        rp_fill(c, np.random.default_rng(31))
        out["load_s"] = time.perf_counter() - s
        out["k13"] = mc_k13(c, cc, eng, cpu.server.engine, card)
        out["tensors_on_owner_cards"] = mc_on_owner_cards(eng, "load")
        out["rebalance"] = mc_rebalance(st, c, card)
        # the bank and the counters after both moves: equal to one-card objects fed the same stream
        ref = redisson_tpu_torch.create(device=one_card("cuda"))
        try:
            bank = ref.get_bloom_filter_array("rp:c2")
            bank.try_init(C2_TENANTS, C2_PER_TENANT, FPP)
            for t, ks in config2_ingest():
                for i in range(0, len(ks), C2_FLUSH):
                    bank.add(t[i:i + C2_FLUSH], ks[i:i + C2_FLUSH])
            regs = ref.get_hyper_log_log_array("rp:c3")
            regs.try_init(C3_TENANTS)
            rng = np.random.default_rng(31)
            for _ in range(C3_BATCHES):
                regs.add(rng.integers(0, C3_TENANTS, C3_BATCH), rng.integers(0, 1 << 60, C3_BATCH))
            for name, key in (("rp:c2", "bits"), ("rp:c3", "regs")):
                got = eng.store.get(name).arrays[key]
                assert_equal(f"multicard {name} on {got.device} against one card's", got.cpu(),
                             ref.engine.store.get(name).arrays[key].cpu())
        finally:
            ref.shutdown()
    stream = W.mixed_stream(seed=41, scale=2, estimates=True)
    waves = [stream, [("HELLO", "3")] + stream]
    raw = {}
    for where in ("cuda", "cpu"):
        with ServerThread(port=0, device=where, devices=MC_POSITIONS) as st:
            raw[where] = W.replies(st.server.host, st.server.port, waves)
    for wave, (_cr, got), (_wr, want) in zip(waves, raw["cuda"], raw["cpu"]):
        bad = W.compare(wave, got, want)
        if bad:
            raise AssertionError(f"multicard mixed stream: {len(bad)} replies differ from the CPU's: {bad[:3]}")
    out["mixed_commands"] = 2 * len(stream) + 1
    # a sharded bloom over the cards beside unsharded one-card banks; the
    # launches of the sharded objects counted a card
    cfg = Config()
    cfg.mesh.dp, cfg.mesh.shard, cfg.mesh.n_devices = SH_DP, SH_SHARD, SH_POSITIONS
    client = redisson_tpu_torch.create(cfg, "cuda")
    try:
        landed = sorted({str(q.device) for q in MeshManager.of(client.engine).mesh.devices.flat})
        if len(landed) != n_cards:
            raise AssertionError(f"multicard sharded: the mesh on {landed}")
        before = dict(K.card_launches)
        out["sharded_config2"], _rec = sharded_config2(client, card, where=f"{n_cards} cards")
        out["sharded_config3"], _rec = sharded_config3(client, card)
        after = dict(K.card_launches)
        by_card = {f"{k} cuda:{i}": v - before.get((k, i), 0) for (k, i), v in sorted(after.items())
                   if v != before.get((k, i), 0)}
    finally:
        client.shutdown()
    out["sharded_launches_by_card"] = by_card
    log(f"multicard sharded [{card}]: config 2 and 3's sharded objects (and their unsharded one-card "
        f"counterparts on cuda:0) launched by card {by_card}")
    out["sharded_vector"] = run_sharded_vector("cuda")
    one = c5d_leg(one_card("cuda"), MC_POSITIONS, card)
    many = c5d_leg("cuda", MC_POSITIONS, card)
    for rep, (a, b) in enumerate(zip(one["replies"], many["replies"])):
        if len(a) != len(b) or not all(same(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"multicard config5d: rep {rep} replies differ between one card and {n_cards}")
    out["config5d"] = {"one_card_ops_per_s": one["ops_per_s"], "cards_ops_per_s": many["ops_per_s"]}
    io1 = ioplane.STATS.snapshot()
    out["host_colocations"] = io1["host_colocations"] - io0["host_colocations"]
    if out["host_colocations"]:
        raise AssertionError(f"multicard cards: {out['host_colocations']} values went through the host")
    log(f"multicard cards [{card}; {n_cards} cards, positions {cards}]: config 2's bank and config 3's counters "
        f"loaded in {out['load_s']:.1f} s; after the rebalances both equal one card's bit for bit; "
        f"{out['tensors_on_owner_cards']} tensors on their owners' cards; the mixed stream's "
        f"{out['mixed_commands']} commands RESP2 and RESP3 equal a CPU server's; config5d ops/s on {n_cards} cards "
        f"{', '.join(f'{r:.3e}' for r in many['ops_per_s'])} beside one card's "
        f"{', '.join(f'{r:.3e}' for r in one['ops_per_s'])} (replies bit-identical); host_colocations 0")
    return out


def run_multicard(device="cuda") -> dict:
    """The multicard path: leg (a) on any card count, leg (b) on two or more
    cards; on one card leg (b) prints that it needs two cards, which is
    not a pass of it."""
    from redisson_tpu_torch.core import kernels as K

    gc.collect()
    start = time.perf_counter()
    card = card_line()
    out = {"streams": mc_streams(card)}
    launches = dict(K.launches)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out["cards"] = mc_cards(card)
        missing = [k for k in MC_CARD_KERNELS if K.launches[k] == launches[k]]
        if missing:
            raise AssertionError(f"multicard cards: leg (b) never launched {missing}")
    else:
        out["cards"] = None
        log(f"multicard cards [{card}]: leg (b) needs two cards and saw {n_cards}: not run, so placement over "
            "several cards (peer copies, K13 across cards, moves between cards) is unverified by this run")
    out["launches"] = {k: v for k, v in K.launches.items()}
    out["launches_leg_a"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - start
    log(f"multicard path [{card}]: {out['seconds']:.1f} s")
    return out


def collections_stream(client, rng) -> list:
    """An op stream through each collection family of create(): lists, the
    queues, the sets, the scored sorted set, multimaps, topics, adders, Keys
    and MapCache; then each record's state (the wall-clock instants it
    holds reduced to whether they are set)."""
    import threading

    v = [int(x) for x in rng.integers(-1000, 1000, 64)]
    out = []
    lst = client.get_list("c:list")
    lst.add_all(v[:10])
    lst.add_first("head")
    out += [lst.add_after("head", "after"), lst.remove_count(v[1], 1), lst.range(0, 4), lst.index_of(v[5]),
            lst.read_all()]
    d = client.get_deque("c:deque")
    for x in v[10:16]:
        d.add_first(x)
    out += [d.poll_last(), d.move("c:deque2", "LEFT", "RIGHT"), d.read_all()]
    bq = client.get_blocking_queue("c:bq")
    got = []
    th = threading.Thread(target=lambda: got.append(bq.poll_blocking(10.0)))
    th.start()
    bq.offer(v[16])
    th.join(10)
    out += [got, bq.poll_blocking(0.01)]
    pq = client.get_priority_queue("c:pq")
    for x in v[16:30]:
        pq.offer(x)
    out += [pq.poll(), pq.poll_many(3), pq.read_all()]
    rb = client.get_ring_buffer("c:rb")
    rb.try_set_capacity(4)
    for x in v[30:40]:
        rb.offer(x)
    out += [rb.read_all()]
    dest = client.get_blocking_queue("c:dest")
    dq = client.get_delayed_queue(dest)
    dq.offer("due", 0.0)
    dq.offer("later", 600.0)
    out += [dest.poll_blocking(10.0), dq.read_all()]
    s1, s2 = client.get_set("c:s1"), client.get_set("c:s2")
    s1.add_all(v[:20])
    s2.add_all(v[10:30])
    out += [sorted(s1.read_intersection("c:s2")), sorted(s1.read_diff("c:s2")), s1.size(),
            client.get_set("c:s3").union("c:s1", "c:s2")]
    z = client.get_scored_sorted_set("c:z")
    z.add_all({f"m{i}": float(x) for i, x in enumerate(v[:40])})
    out += [z.entry_range(0, 4), z.rank("m3"), z.rev_rank("m3"), z.add_score("m3", 2.5),
            z.value_range_by_score(-100.0, True, 100.0, False), z.poll_first_entry(), z.poll_last_entry(),
            z.count(-500.0, True, 500.0, True)]
    lex = client.get_lex_sorted_set("c:lex")
    lex.add_all(list("qwertyuiop"))
    out += [lex.range("e", True, "r", False)]
    mm = client.get_set_multimap("c:mm")
    for i, x in enumerate(v[:20]):
        mm.put(f"k{i % 4}", x)
    out += [mm.key_size(), mm.size(), sorted(mm.get_all("k1")), sorted(mm.remove_all("k2"))]
    heard = []
    t = client.get_topic("c:topic")
    lid = t.add_listener(lambda ch, msg: heard.append(msg))
    out += [t.publish(v[0]), t.publish({"x": v[1]})]
    t.remove_listener(lid)
    rt = client.get_reliable_topic("c:rt")
    sid = rt.add_subscriber()
    for x in v[:5]:
        rt.publish(x)
    out += [heard, rt.poll(sid), rt.size()]
    la, lb = client.get_long_adder("c:adder"), client.get_long_adder("c:adder")
    for i, x in enumerate(v[:20]):
        (la if i % 2 else lb).add(x)
    out += [la.sum(), lb.sum()]
    la.destroy()
    lb.destroy()
    mc = client.get_map_cache("c:mc")
    mc.put("a", v[0])
    mc.put_with_ttl("b", v[1], 600.0)
    out += [mc.get("a"), mc.get("b"), mc.size(), mc.try_set_max_size(2), mc.put("c", 1), mc.put("d", 2), mc.size()]
    keys = client.get_keys()
    out += [sorted(keys.get_keys("c:*")), keys.count_exists("c:list", "c:z", "c:none")]
    from redisson_tpu_torch import state

    for name in sorted(keys.get_keys("c:*")):
        kind, meta, _, host = state.to_reference(client.engine.store.get(name))
        if kind == "map_cache":
            host = {k: [c[0], c[1] is None, c[2], c[4]] for k, c in host.items()}
        elif kind == "delayed_queue":
            host = [raw for _, raw in sorted(host)]
        elif kind == "reliable_topic":
            host = {**host, "subscribers": sorted(off for off, _ in host["subscribers"].values())}
        elif isinstance(host, set):
            host = sorted(host)
        elif kind.endswith("multimap"):
            host = {k: sorted(x) for k, x in host["data"].items()}
        out.append((name, kind, meta, host))
    return out


def sync_stream(client) -> list:
    """Locks, semaphores and latches from several threads in a fixed
    interleaving (each step joins the thread it started)."""
    import threading

    def other(fn):
        box = []
        th = threading.Thread(target=lambda: box.append(fn()))
        th.start()
        th.join(30)
        if th.is_alive():
            raise AssertionError("sync stream: a holder did not finish")
        return box[0]

    out = []
    lk = client.get_lock("c:lock")
    out += [lk.try_lock(), lk.try_lock(), other(lambda: lk.try_lock()), lk.get_hold_count()]
    lk.unlock()
    lk.unlock()
    out += [other(lambda: lk.try_lock(lease_time=0.2)), lk.try_lock(wait_time=5.0), lk.is_held_by_current_thread()]
    lk.unlock()
    fl = client.get_fenced_lock("c:fenced")
    out += [fl.lock_and_get_token(), other(lambda: fl.try_lock_and_get_token())]
    fl.unlock()
    rw = client.get_read_write_lock("c:rw")
    out += [rw.read_lock().try_lock(), other(lambda: rw.read_lock().try_lock()),
            other(lambda: rw.write_lock().try_lock())]
    sem = client.get_semaphore("c:sem")
    out += [sem.try_set_permits(3), other(lambda: sem.try_acquire(2)), sem.try_acquire(2), sem.available_permits()]
    sem.release(2)
    out += [sem.available_permits()]
    latch = client.get_count_down_latch("c:latch")
    latch.try_set_count(2)
    waiter = []
    th = threading.Thread(target=lambda: waiter.append(latch.await_(30.0)))
    th.start()
    other(latch.count_down)
    out += [latch.get_count()]
    latch.count_down()
    th.join(30)
    out += [waiter, latch.get_count()]
    rl = client.get_rate_limiter("c:rate")
    out += [rl.try_set_rate("OVERALL", 3, 60.0), [rl.try_acquire() for _ in range(4)], other(lambda: rl.try_acquire())]
    from redisson_tpu_torch import state

    for name in ("c:lock", "c:fenced", "c:rw", "c:sem", "c:latch"):
        kind, meta, _, host = state.to_reference(client.engine.store.get(name))
        host = {k: (v is not None) if k in ("owner", "lease_until", "writer") else
                (len(v) if k == "readers" else v) for k, v in host.items()}
        out.append((name, kind, meta, host))
    return out


def check_card_against_cpu(create) -> None:
    on_card = small_stream(create(), np.random.default_rng(5))
    on_cpu = small_stream(create(device="cpu"), np.random.default_rng(5))
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if not same(a, b):
            raise AssertionError(f"small stream reply {i}: card {a!r} != cpu {b!r}")
    log(f"small stream: {len(on_card)} replies and final states equal on the card and the CPU")
    for overlap in (True, False):
        on_card = rbatch_stream(create(), np.random.default_rng(8), overlap)
        on_cpu = rbatch_stream(create(device="cpu"), np.random.default_rng(8), overlap)
        for i, (a, b) in enumerate(zip(on_card, on_cpu)):
            if not same(a, b):
                raise AssertionError(f"RBatch stream (overlap={overlap}) reply {i}: card {a!r} != cpu {b!r}")
        log(f"RBatch stream, overlap {'on' if overlap else 'off'}: {len(on_card)} replies (plain, skip_result and "
            "atomic batches, every verb) and final states equal on the card and the CPU")
    s = time.perf_counter()
    for name, stream in (("collections", lambda c: collections_stream(c, np.random.default_rng(9))),
                         ("synchronizers", sync_stream)):
        clients = [create(), create(device="cpu")]
        try:
            on_card, on_cpu = (stream(c) for c in clients)
        finally:
            for c in clients:
                c.shutdown()
        for i, (a, b) in enumerate(zip(on_card, on_cpu)):
            if not same(a, b) or len(on_card) != len(on_cpu):
                raise AssertionError(f"{name} stream reply {i}: card {a!r} != cpu {b!r}")
        log(f"{name} stream: {len(on_card)} replies and final states equal on the card and the CPU")
    log(f"collections and synchronizer streams: {time.perf_counter() - s:.1f}s")


# the codec leg: CODEC_KEYS string keys (and structured values where the
# codec takes them) through each codec of client/codec.py beyond the default,
# and CODEC_RAW bytes keys (hashed as they are, as in the reference), into a
# bloom filter and an HLL on the card and on the CPU; lzma encodes a key in
# ~1 ms on the host, so it takes CODEC_LZMA_KEYS of them
CODEC_KEYS, CODEC_LZMA_KEYS, CODEC_RAW, CODEC_SEED = 4_000, 500, 1_000, 67


def codec_cases() -> list:
    """(name, codec, keys) for each codec the leg feeds; protobuf needs
    google.protobuf's StringValue and is left out, said so, without it."""
    from redisson_tpu_torch.client import codec as C

    rng = np.random.default_rng(CODEC_SEED)
    words = [f"user:{i}:{rng.integers(0, 1 << 40)}" for i in range(CODEC_KEYS)]
    docs = [{"id": i, "tag": w[-6:], "score": float(i) / 3} for i, w in enumerate(words[: CODEC_KEYS // 2])]
    mixed = words[: CODEC_KEYS // 2] + docs
    cases = [("composite", C.CompositeCodec(C.StringCodec(), C.PickleCodec()), mixed),
             ("zlib", C.ZlibCodec(), mixed), ("bz2", C.Bz2Codec(), mixed),
             ("lzma", C.LzmaCodec(), mixed[: CODEC_LZMA_KEYS // 2] + mixed[-(CODEC_LZMA_KEYS // 2):]),
             ("lz4", C.Lz4Codec(), mixed), ("lz4 over string", C.Lz4Codec(C.StringCodec()), words),
             ("cbor", C.CborCodec(), mixed), ("double", C.DoubleCodec(), [float(i) / 7 for i in range(CODEC_KEYS)])]
    if C.MsgPackCodec is not None:
        cases.append(("msgpack", C.MsgPackCodec(), mixed))
    try:
        from google.protobuf import wrappers_pb2
    except ImportError:
        log("codec leg: protobuf left out (no google.protobuf on this machine)")
    else:
        cases.append(("protobuf", C.ProtobufCodec(wrappers_pb2.StringValue),
                      [wrappers_pb2.StringValue(value=w) for w in words]))
    return cases


def check_codecs_card_against_cpu(create) -> dict:
    """For each codec: a bloom filter and an HLL fed its keys (one add_all
    of the codec's keys, then the bytes keys) on the card and on the CPU;
    the planes, the registers and the replies must be equal."""
    from redisson_tpu_torch import state
    from redisson_tpu_torch.core import kernels as K

    card = card_line()
    s = time.perf_counter()
    raw = [np.random.default_rng(CODEC_SEED + 1).bytes(24) + b"%d" % i for i in range(CODEC_RAW)]
    clients = [create(), create(device="cpu")]
    K.reset_launches()
    out = {}
    try:
        for name, codec, keys in codec_cases():
            got = []
            for c in clients:
                bf = c.get_bloom_filter(f"codec:bf:{name}", codec)
                bf.try_init(2 * len(keys), FPP)
                hll = c.get_hyper_log_log(f"codec:hll:{name}", codec)
                replies = [bf.add_all(keys), bf.add_all(raw), hll.add_all(keys), hll.add_all(raw),
                           bf.contains_each(keys[::7]).tolist(), bf.count_contains(raw), hll.count()]
                recs = [state.to_reference(c.engine.store.get(f"codec:{kind}:{name}")) for kind in ("bf", "hll")]
                got.append((replies, recs))
            (card_r, card_s), (cpu_r, cpu_s) = got
            if not same(card_r, cpu_r):
                raise AssertionError(f"codec {name}: card replies {card_r!r:.200} != cpu {cpu_r!r:.200}")
            for (ck, cm, ca, ch), (pk, pm, pa, ph) in zip(card_s, cpu_s):
                if (ck, cm, ch) != (pk, pm, ph) or ca.keys() != pa.keys() or \
                        not all(np.array_equal(ca[a], pa[a]) for a in ca):
                    raise AssertionError(f"codec {name}: the card's {ck} state differs from the CPU's")
            out[name] = {"keys": len(keys), "added": card_r[0], "count": card_r[-1]}
    finally:
        for c in clients:
            c.shutdown()
    launches = {k: v for k, v in K.launches.items() if v}
    if not (launches.get("bloom_probe") and launches.get("hll_add")):
        raise AssertionError(f"codec leg: the card launched {launches}")
    log(f"codec leg [{card}]: {', '.join(out)}: a bloom filter and an HLL fed {CODEC_KEYS} keys through each "
        f"codec (lzma {CODEC_LZMA_KEYS}: ~1 ms a key to encode on the host) and {CODEC_RAW} bytes keys: planes, "
        f"registers and replies equal on the card and the CPU "
        f"({time.perf_counter() - s:.1f}s; launches {launches})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    import redisson_tpu_torch
    from redisson_tpu_torch.core import _build
    from redisson_tpu_torch.core import kernels as K

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_s = _build.build_all()
    log(f"build: {len(_build.SIGNATURES)} libraries from csrc/ in {build_s:.1f}s")
    per_call = kernels_a_call()
    log("kernels a call by torch.profiler, in a child process: " + json.dumps(per_call))
    rng = np.random.default_rng(1234)
    check_known_answers(dev)
    kernels = check_kernels(dev, rng)
    kernels.update(check_bitset(dev, rng))
    s = time.perf_counter()
    values = config4_values()
    log(f"config4: {len(values)} values built in {time.perf_counter() - s:.1f}s")
    kernels.update(check_wordcount(dev, rng, values))
    kernels.update(check_vector(dev, np.random.default_rng(4321)))

    client = redisson_tpu_torch.create()
    if client.engine.device.type != "cuda":
        raise AssertionError("create() did not land on the card")
    paths, main_launches = {}, dict.fromkeys(K.launches, 0)
    for name, run in (("config2", lambda: run_config2(client, np.random.default_rng(42))),
                      ("config2_batch", lambda: run_config2_batch(client, np.random.default_rng(43))),
                      ("config1", lambda: run_config1(client)),
                      ("config3", lambda: run_config3(client, np.random.default_rng(7))),
                      ("graft", lambda: run_graft(dev)),
                      ("single_adds", lambda: run_single_adds(client, np.random.default_rng(11))),
                      ("fanout", lambda: run_fanout(client, np.random.default_rng(13))),
                      ("config4", lambda: run_config4(client, values)),
                      ("config7", lambda: run_config7(client)),
                      ("server", lambda: run_server(kernels)),
                      ("remote", lambda: run_remote()),
                      ("services", lambda: run_services(paths["config7"], values)),
                      ("cluster", lambda: run_cluster()),
                      ("cluster_proc", lambda: run_cluster_proc()),
                      ("sharded", lambda: run_sharded(one_card("cuda"))),
                      ("qos", lambda: run_qos()),
                      ("sharded_vector", lambda: run_sharded_vector(one_card("cuda"))),
                      ("durability", lambda: run_durability()),
                      ("observe", lambda: run_observe()),
                      ("warm", lambda: run_warm()),
                      ("replication", lambda: run_replication()),
                      ("migration", lambda: run_migration(one_card("cuda"))),
                      ("residency", lambda: run_residency(one_card("cuda"))),
                      ("faults", lambda: run_faults(one_card("cuda"))),
                      ("soak", lambda: run_soak(one_card("cuda"))),
                      ("multicard", lambda: run_multicard())):
        K.reset_launches()  # each path's counts, from 0 just before it
        paths[name] = run()
        # a path that measures beside its own work reads its counts itself
        paths[name].setdefault("launches", dict(K.launches))
        for k, v in paths[name]["launches"].items():
            main_launches[k] += v
    client.shutdown()
    missing = [f"{path}: {k}" for path, ks in PATH_KERNELS.items() for k in ks if paths[path]["launches"][k] == 0]
    for path in ("server", "graft", "cluster", "cluster_proc", "qos", "migration", "residency", "faults",
                 "soak", "multicard"):
        if not paths[path]["launches"]["bloom_set"] + paths[path]["launches"]["bloom_add"]:
            missing.append(f"{path}: bloom_set or bloom_add")
    missing += [k for k, v in main_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    log("main-path launches: " + json.dumps({k: v["launches"] for k, v in paths.items()}))
    log("paths: " + json.dumps(paths))
    check_card_against_cpu(redisson_tpu_torch.create)
    check_mapreduce_card_against_cpu(redisson_tpu_torch.create)
    check_search_card_against_cpu(redisson_tpu_torch.create)
    check_codecs_card_against_cpu(redisson_tpu_torch.create)

    sources = {"bloom_probe": ("redisson_tpu_torch/csrc/bloom.cu", "redisson_tpu/core/kernels.py:184"),
               "bloom_set": ("redisson_tpu_torch/csrc/bloom.cu", "redisson_tpu/core/kernels.py:167"),
               "bloom_add": ("redisson_tpu_torch/csrc/bloom.cu", "redisson_tpu/core/kernels.py:167"),
               "hll_add": ("redisson_tpu_torch/csrc/hll.cu", "redisson_tpu/core/kernels.py:446"),
               "hll_rows": ("redisson_tpu_torch/csrc/hll.cu", "redisson_tpu/core/kernels.py:504"),
               "bitset_get": ("redisson_tpu_torch/csrc/bitset.cu", "redisson_tpu/core/kernels.py:526"),
               "bitset_set": ("redisson_tpu_torch/csrc/bitset.cu", "redisson_tpu/core/kernels.py:518"),
               "wc_words": ("redisson_tpu_torch/csrc/wordcount.cu", "redisson_tpu/core/kernels.py:995"),
               "wc_sort_runs": ("redisson_tpu_torch/csrc/wordcount.cu", "redisson_tpu/core/kernels.py:1014"),
               "segment_reduce": ("redisson_tpu_torch/csrc/segment.cu",
                                  "redisson_tpu/services/mapreduce.py:386"),
               "knn_score": ("redisson_tpu_torch/csrc/knn.cu", "redisson_tpu/core/kernels.py:646"),
               "knn_select": ("redisson_tpu_torch/csrc/knn.cu", "redisson_tpu/core/kernels.py:680"),
               "ivf_score": ("redisson_tpu_torch/csrc/knn.cu", "redisson_tpu/core/kernels.py:739"),
               "kmeans": ("redisson_tpu_torch/csrc/kmeans.cu", "redisson_tpu/core/kernels.py:861")}
    # the windowed forms (the sharded programs, K12): their own rows, their
    # launches the sharded path's windowed ones
    window = paths["sharded"].pop("kernels")
    kernels.update(window)
    by_path = {name: {path: v["launches"][name] for path, v in paths.items()} for name in K.launches}
    for name in window:
        base = name.split()[0]
        sources[name] = (sources[base][0], SH_WINDOW_REPLACES[base])
        by_path[name] = {path: paths[path]["window_launches"][base] for path in ("sharded", "soak")}
        main_launches[name] = sum(by_path[name].values())
    # K19, the sharded banks' merge: one knn_select launch a merge, its own
    # row (its launches the merges of the sharded_vector path)
    k19 = paths["sharded_vector"].pop("k19")
    kernels["knn_select K19"] = k19
    sources["knn_select K19"] = ("redisson_tpu_torch/csrc/knn.cu", "redisson_tpu/core/kernels.py:840")
    main_launches["knn_select K19"] = paths["sharded_vector"]["k19_merges"]
    by_path["knn_select K19"] = {"sharded_vector": main_launches["knn_select K19"]}
    per_kernel = {}  # the counts of kernels a call by kernel (kmeans_assign's and kmeans_update's under kmeans)
    for key, v in per_call.items():
        wrapper = key.split()[0]
        per_kernel.setdefault("kmeans" if wrapper.startswith("kmeans_") else wrapper, {})[key] = v
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": main_launches[name],
         "launches_by_path": by_path[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r.get("library_ms"),
         **({"kernels_a_call": per_kernel[name]} if name in per_kernel else {}),
         "more": {key: v for key, v in r.items()
                  if key.endswith("_ms") and key not in ("ms", "plain_ms", "bound_ms", "library_ms")}}
        for name, r in kernels.items()]}
    for name, r in kernels.items():
        log(json.dumps({"kernel": name, "launches": main_launches[name],
                        **{key: v for key, v in r.items() if isinstance(v, (int, float))}}))
    # K23, K24 and K25 are torch ops, not hand kernels: their line of their own
    k25 = paths["faults"].pop("k25")
    k25["kernels_a_probe"] = per_call[K25_KEY]
    k25["launches"] = k25["probes"] * k25["kernels_a_probe"]
    log(json.dumps({"torch_ops": [paths["replication"]["k23"], paths["replication"]["k24"], k25]}))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernels-a-call"]:
        keys = set(json.loads(sys.argv[2])) if len(sys.argv) > 2 else None
        print(json.dumps(kernels_a_call_here(torch.device("cuda"), keys)))
        sys.exit(0)
    sys.exit(main())
