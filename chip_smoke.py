#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's write and read paths on one GPU and check
every kernel.

    python3 chip_smoke.py
    python3 chip_smoke.py --rebalance-drill RUNS
    python3 chip_smoke.py --soak RUNS

Phases (any failure exits non-zero; nothing is caught into "ok"):
  0  report the card; build the kernels from t3fs_torch/csrc (into the
     ignored t3fs_torch/_build/) and print the build time; the host library
     (chunk engine, host CRC, io_uring reader, usrbio rings), /dev/shm's
     size, and usrbio.cpp through g++ -Wall -Wextra without a warning; the
     FUSE probe (the effective uid, /dev/fuse, the errno of opening it and
     of one trial mount(2) of fuse.t3fs with FuseKernelMount's options):
     "available" or "refused" with the first failing call
  1  B1 (CRC words) against its plain PyTorch version: random segments
     (4096 rows, and ragged 16-row units: 1, 7, 1001 rows), every run
     length 1..16 (chunks of 1..17, 24, 40 segments), 4 MiB chunks x 64, the
     check vector, front-padded odd lengths
  2  B2 (RAID-6 words) and the fused stripe step against plain, at the
     stripe bench's shape: RS(8+2), 1 MiB shards, 12 stripes
  3  storage write path: >= 256 concurrent payload_crc on the "tpu"
     checksum backend (mostly 4 MiB), every CRC checked
  4  EC stripe write path: 24 concurrent TorchECCodec.encode_verified on
     8 x 1 MiB shards, every parity byte and CRC checked
  5  CUDA-event times of B1 (64 x 4 MiB from HBM; 2 x 4 MiB resident in
     L2, replayed from a CUDA graph), B2 and the fused step beside their
     bounds (each the median of REPEATS samples, with their min and max)
  6  B3 (RAID-6 decode words), B4 (repair words) and B5 (byte-plane
     bit-matmul) against their plain versions: B3 on all 55 RS(8+2)
     erasure patterns of one 8 x 1 MiB stripe (uint4 and u32 paths), at
     RAID-6 k = 12, 31, 32 (survivors in several groups of 8) and at 12
     stripes for two patterns; B4 on the 10 single-row programs and the LRC
     all-ones program at 96 x 256 KiB sub-shards; B5 decode and encode on RS(6+3)
     (HDFS's RS-6-3-1024k policy) at 12 x 1 MiB shards; one rebuilt stripe
     of each kind against RSCode.decode_ref / eval_program_np
  7  degraded-read path: 24 concurrent TorchECCodec.reconstruct_verified on
     RS(8+2) 1 MiB shards in three erasure patterns (B3 + B1)
  8  repair path: 24 lost 1 MiB chunks of slot 3, each as 4 sub-shards of
     256 KiB over 8 helpers (96 concurrent repair calls, B4 + B1), CRCs
     stitched with crc32c_combine; then LRC local-parity encodes
  9  non-RAID-6 reconstruct: 12 concurrent RS(6+3) reconstruct calls at
     1 MiB shards losing 3 shards (B5)
 10  CUDA-event times of B3 (want (0, 9), (0, 1), (0, 5), (4, 8), (3,)),
     B4, B5 and the fused decode and repair steps beside their bounds (the
     decode step also replayed from a CUDA graph)
 11  B6 (CRC bytes) against its plain version: random segments, 64 x 4 MiB
     rows, 64 x (4 MiB - 5) rows (unaligned) and 64 x 1 000 000-byte rows
     (a ragged first run), rows at every base offset 0..15, odd lengths
     against crc32c_ref; the byte encode step (B5 + B6) and the byte decode
     step (B5 + B6) on RS(6+3) at 12 x 1 MiB against plain
 12  the byte-path EC routes: 24 concurrent RS(6+3) encode_verified at
     1 MiB cells (B5 + B6), 12 RS(6+3) reconstruct_verified losing 3
     shards (B5 + B6), 12 RAID-6 encode_verified at 1 000 000 bytes (B2 +
     B6), 24 repair calls at 250 000-byte sub-shards (B4 + B6); every
     parity, rebuilt byte and CRC checked
 13  PM-MSR on RS(8+2) pm-msr at 1 MiB chunks after warmup_msr: 24
     concurrent msr_encode_verified (B2 + B1), 24 msr_repair of slot 3
     (B4 + B1), 6 msr_decode_verified losing (0, 9) or (4, 9) (dense
     product + B1); one stripe of each against encode_np / repair_np /
     decode_np, every rebuilt byte and CRC checked
 17  codes past one kernel launch: B5's tiles (RAID-6 k = 254 decode in two
     input groups, RS(12+12) encode in two row groups, RS(28+8) decode of 8
     shards), B3's wrapper at k = 40 (B5 on the byte view) and B4 over 40
     helpers (two groups) against their plain versions; then 42 concurrent
     TorchECCodec calls at RAID-6 k = 40 and k = 254, RS(12+12) and RS(28+8)
     (encode_verified, reconstruct and reconstruct_verified of one and two
     losses, a 40-helper repair), every parity, rebuilt byte and CRC checked
 14  CUDA-event times of B6 at its three row shapes (beside B1's at the
     bytes of 64 x 4 MiB), the byte encode step and the PM-MSR repair step
 16  H1 (the bench's calibration copy) against its plain version at the
     bench's shape (12, 8, 256Ki words) and at ragged shapes, aligned and
     not; a CUDA-graph chained pass against the eager one; H1's time beside
     its bound, its plain version and torch.add, and H1 against torch.add in
     interleaved CUDA-graph replays; then the headline bench
     (`t3fs_torch.bench --quick`: value > 0, the card named, H1 launched)
     and the decode bench's microbench (--decode-ab at 12 x 1 MiB stripes)
 18  the device sort: 2^24 gensort rows (seed 2026) through sort_bench.measure
     (sort_columns and make_device_sorter both equal to lexsort_rows; the
     sort's CUDA-event time beside its bound, H2D, D2H, the host's column
     extraction and gather, np.lexsort), n = 0, 1, 1023, 1025 and all-0xFF
     keys against lexsort_rows, then `sort_bench --quick` (2^22)
 19  the codec mesh: graft_entry.run_mesh with 4 ranks, dp x cp = 2 x 2, at
     RS(8+2), 1 MiB shards, 24 stripes (NCCL with a card a rank, else gloo
     with the ranks sharing the card; the backend is printed): byte and word
     encode (B2 + B1), byte and word decode of want (0, 9) and (3,) (B3 +
     B1), the RS(6+3) word decode losing (1, 4, 7) (B5 + B1); every output
     against the unsharded steps on the card, CRCs spot-checked against
     crc32c_ref; each rank's step times beside those of B1, B2, B3, B5,
     the CRC combine and its all_reduce alone at the rank's block
 20  graft_entry.entry()'s step on the card against the plain step
 21  the CRAQ chain write (storage_bench's "CRAQ 3-replica chain write"):
     the port's StorageFabric of 3 nodes and one 3-replica chain, a
     CudaChecksumBackend per node on the card, the fabric's defaults (the
     native chunk engine, every target checked to be one, and io_uring
     reads), StorageClient with inline transfers, 4 MiB chunks; write_file_range of
     one seeded 512 MiB file, then phase 3's size mix through write_chunk
     on fresh inodes (1 MiB and (129 << 10) + 3 B writes, 40 000 B writes
     on the host path, appends through crc_combine, 1 MiB overwrites that
     recompute the chunk CRC on the host); once with write_pipeline "off",
     once with "overlap".  Every write is acked OK (the head's B1 CRC must
     equal the client's host CRC), every byte reads back, every replica's
     checksum equals the native host CRC of the expected bytes (full chunks
     also plain B1 on the card), every replica commits, and each node
     batched exactly its device-size updates; prints the wall and GB/s
 22  the EC stripe path (BASELINE.json configs #3 and #4): the port's
     StorageFabric of 5 nodes and 10 one-replica chains (two a node), a
     CudaChecksumBackend per node on the card, the native engine (every
     target checked) and io_uring reads, StorageClient and ECStorageClient
     over TorchECCodec; RS(8+2) at 1 MiB: 64 seeded stripes written 16 in
     flight (B2 + B1), read back healthy, every chunk of one chain removed
     and all 64 read degraded (B3 + B1), RepairDriver(concurrency=8) over
     the losses on the sub-shard path (B4 + B1), every stripe read back;
     then 8 stripes each of pm-msr (write, one-loss repair_stripe, two-loss
     read), RS(6+3) (write B5 + B6, read losing three shards, repair) and
     lrc-xor (6+2, groups of 4: write, a local-group repair), one RS(8+2)
     stripe ending mid-chunk (its trimmed tail's CRC on the host); last one
     node's server stops (two chains, the m = 2 limit) and 16 stripes read
     degraded.  Every byte against the written data, every returned CRC
     and every repaired chunk's stored checksum against plain B1 and the
     native host CRC, RepairDriver all on the reduced path, every codec
     route a cuda-* one; prints the walls, GB/s of data (write, degraded
     read) and of rebuilt and helper bytes (repair), codec flushes and
     items per flush, each node's B1 batches and items and io_uring reads,
     and the phase's launches
 23  target resync and EC recovery after a node loss (BASELINE.json config
     #4's resync half): the port's LocalCluster (mgmtd over the in-memory
     KV, heartbeats, the chains updater, 5 StorageServers with their resync
     workers, all in this process), 5 chains of 3 (chain c on nodes c, c+1,
     c+2 mod 5) and 10 one-replica EC chains, a CudaChecksumBackend a node
     on the card, the native engine (every target checked); a seeded 1 GiB
     file of 4 MiB chunks and 32 RS(8+2) stripes of 8 x 1 MiB
     (ECStorageClient over TorchECCodec, 16 in flight).  Node 2 fail-stops
     (timed to the reshape), 64 chunks are overwritten and a 256 MiB file
     written on the survivors (each checked committed there) and 16 stripes
     read degraded; node 2 restarts on its old disk (the resync sends only
     what changed: checked), node 4 restarts empty (every chunk of its
     chains resynced: checked); a ScrubScheduler scans until nothing is left
     (the wiped node's 64 shards by the full-k decode, then one shard
     bit-rotted on disk on the reduced path).  Every chunk of every replica
     read from its engine against the acked bytes, the native host CRC and
     plain B1, committed, no replica holding a chunk its chain's others
     lack; every stripe whole, every rebuilt shard's bytes and checksum
     against the plain encode; each successor's resync REPLACEs batched on
     B1; prints the walls, the bytes resynced and GB/s, the scrub's repairs,
     helper bytes and GB/s, each node's B1 batches and reads, the launches
 24  the file system and a parallel checkpoint (3FS's checkpointing
     workload): the port's LocalCluster with its meta service (MetaStore on
     the cluster's KV, MetaServer with its GC every 0.1 s in the same event
     loop), phase 23's layout and knobs.  FileSystem: mkdirs, a seeded
     256 MiB file at 4 MiB chunks (B1 on every hop), stat, read back,
     rename across directories, readdir, unlink, until meta's GC has
     removed every chunk from every replica.  Then t3fs_torch/ckpt at
     ckpt_bench's code and admission (RS(8+2), 256 KiB shards, window 8,
     per-chain 2) over a seeded 512 MiB tree (8 leaves of 64 MiB, uint8,
     float32 and int64; leaves of 4096 B, 1 000 003 B and 3 MiB + 17 B
     and an int64 scalar: partial stripes, trimmed tails): save (every
     stripe one fused encode-and-CRC call on a cuda-* route, the host CRC
     on the trimmed tails only), restore and restore_shard x 4 (dtype,
     shape and bytes), a re-save the CRC probe skips whole, one node
     fail-stopped (two EC chains, RAID-6's limit) and a degraded restore
     (B3 + B1), the node back on an empty disk and scrub(repair=True)
     until clean, every stored shard against the leaves, the plain encode,
     the native host CRC and plain B1, then a second step (2 leaves of
     64 MiB) and gc(keep_last=1) with none of step 1's chunks left (the
     counts of leaves cut from 16 and 4 to win back time under the run's
     limit); prints the walls
     and MB/s of logical bytes, the manifest commit, codec flushes and
     stripes a flush, each node's B1 batches and the launches.  Then
     `t3fs_torch.benchmarks.ckpt_bench --runs 1 --kill --json` in this
     process, its lines checked
 25  the GraySort-analog through storage, the KVCache store and its tier:
     (a) sort_bench's job at the reference's multi-process shape (8
     workers, 32 partitions, 1 MiB chunks; 128 MiB of gensort input, cut
     from its 1 GiB) on the port's
     in-process fabric (3 nodes, 1 replica, a CudaChecksumBackend a node:
     B1 on every chunk of 64 KiB and more), once with the device sorter on
     the card and once with numpy, each on a fresh fabric: the reference's
     checks (record count, key XOR, every partition sorted, boundaries in
     order) and the two runs' OUT files equal byte for byte; prints
     phase1_s, phase2_s, sort_MB_s, each node's B1 batches and items, the
     payloads on the nodes' host CRC and the time inside the device sorter.
     (b) kvcache_bench's phases through KVCacheStore (BASELINE.json config
     #5) on its fabric (3 nodes, 3 replicas): 2048 blocks of 16 KiB
     (every CRC on the host: checked), then 512 blocks of one DeepSeek-V3
     KV block of 16 tokens (1 124 352 B: B1 on every hop, checked); no miss
     before GC, every key removed; then seeded values read back exactly, a
     prefix chain's longest_prefix, a miss for every key after GC; prints
     the bench's IOPS, MB/s and latencies.  (c) `kvcache_fleet_bench
     --procs 2 --sessions 8 --turns 1 --prompts 16 --blocks 4
     --admission-ab --json` in this process: its workers run clients only,
     the host cell on the shm token arena within its window
 26  the usrbio ring data plane (3FS's USRBIO zero-copy client) on
     usrbio_bench's cluster (LocalCluster of 3 nodes, 2 chains of 2
     replicas, with meta, a CudaChecksumBackend a node): /dev/shm's size; an
     app ring opened from a second process (its pops wait on a
     process-shared semaphore).  (a) usrbio_bench's documented 4 KiB random
     reads (depth 64, 5 s) in --data-plane-ab and --cross-host-ab, one trial
     a cell, over an 8 MiB file (cut: see USRBIO_SMALL_FILE): rpc against
     ring, shm against cross-host batched against per-op; every read
     verified against the populated bytes, every CRC on the host.  (b) the
     same on the ring at 256 KiB blocks (the ring slot size) over 256 MiB:
     the populate rides the ring as inline WRITEs (B1 on every hop), the
     reads take the service's awaited path, then 64 app OP_WRITEs through
     the IoRing, read back, and every chunk of both replicas against the
     native host CRC and plain B1.  (c) the riders on data_plane="ring"
     (5 nodes: RS(8+2) with a node down): a 256 MiB checkpoint saved (B2 +
     B1), restored, a node fail-stopped and restored degraded (B3 + B1),
     512 KVCacheStore blocks of 16 KiB put and read by get_many; then
     `kvcache_scale_bench --smoke --json` in this process (its gates, the
     ring plane).  Every ring cell shows that the ring served: the nodes'
     SQEs equal the SQEs the clients sent (at least every IO of the run),
     no IO spilled to rpc, no address memoized as pre-ring, the client's
     plane up, `aliased` true same-host and false cross-host (where the
     Buf.batch doorbells moved); prints IOPS, p50, p99, GB/s, B1 batches
     and items a node, host-CRC payloads, the checkpoint walls, the scale
     bench's replay figures and the phase's wall
 27  BASELINE.json's harness at the reference's widths (t3fs_torch/benchmarks/
     {storage_bench,codec_economics,ec_recovery_bench,repair_drill_bench}.py,
     every node a CudaChecksumBackend on the card): (a) config #1,
     storage_bench --mode write --nodes 1 --replicas 1 --chunk-size 4 MiB
     (5 s), once on the card (B1 on every write) and once --cpu (the host
     CRC), every stored chunk's checksum against the host CRC of its bytes,
     and the ratio; (b) config #2, the Makefile's write-bench (--write-ab,
     4 MiB, 3 replicas, 16 ops): each pipeline's MB/s, p50, p99 and its
     three replicas checked equal and against the host CRC; (c)
     codec_economics at 64 KiB and 1 MiB chunks: the batches B1 reached
     under storage_bench's load, B1's rate on the device alone (CUDA-graph
     replays) and the host cost of one launch at each batch, the card's pinned host-to-device rate, the model table
     over the reference's interconnects and the measured one; (d) configs
     #3 / #4, ec_recovery_bench at its defaults (5 nodes, RS(8+2), 256 KiB
     chunks, 16 stripes: write, degraded read after a node kill, repair,
     every stripe read back), its decode metric line with the measured
     degraded-read MB/s; (e) repair_drill_bench at the Makefile's
     repair-drill size (12 stripes, 64 KiB chunks, --repair-mode both) on
     lrc-xor (repair_traffic_ratio < 0.5) and pm-msr (< 0.7), every read
     and cell verified.  Each part prints its B1-B6 launches and B1's items
     a batch on each node
 28  the port's own deployment (t3fs_torch/app, README's quick start): a
     DevCluster at its documented layout, every service its own process
     (monitor, mgmtd and meta on the durable WAL KV, 3 storage processes,
     each a CudaChecksumBackend on the card: B1), 2 chains of 3 replicas,
     1 MiB chunks; meta through the cluster's own spawn, its Parquet event
     trace where pyarrow is installed, else its JSON log lines (printed).
     Each process's pid and start wall; a seeded 256 MiB file through
     FileSystem over MetaClient and StorageClient (MB/s of client bytes
     both ways), then every chunk of every replica read back over the
     storage RPCs: equal replicas, each checksum the native host CRC of its
     bytes; storage2 SIGKILLed (the reshape timed on mgmtd's routing), the
     file read back, 16 MiB written on the survivors, storage2 restarted
     (timed to every target SERVING) and every replica checked again;
     `storage_bench --mgmtd` (a process of its own) at config #2's widths
     beside phase 27's one-loop figure; mgmtd's routing carries the
     monitor's scorecard and the monitor's sqlite holds samples of mgmtd,
     meta and every storage process; then health_smoke's 10 ms straggler on
     LocalCluster(with_monitor=True), flagged and cleared within its
     bounds; last, each storage process's B1 batches, items and launches as
     it logged them at its stop (each > 0), the launches added to the
     kernels line
 29  meta over the replicated and range-sharded KV: DevCluster(kv_shards=2)
     (phase 28's storage layout on B1, meta over two kv_main processes each
     on its own WAL), meta_bench --mgmtd at 1024 files, a 64 MiB file, kv2
     SIGKILLed amid create streams and respawned over its WAL, every
     acknowledged create stat, then kv_distributor_bench --smoke while the
     phase has time left; the storage processes' B1 launches from their logs
 30  only with --rebalance-drill RUNS, which runs phase 0 and then this
     phase RUNS times in turn, each run's checks all made, and exits 0
     only if every run passed every check; the default run leaves it out,
     since its fifth gate held in about half the drills on the card at
     this configuration.  Elastic membership under live traffic: the
     reference's rebalance drill
     (t3fs_torch/benchmarks/rebalance_drill_bench.run_bench, both cells) in
     this process's loop at its cluster (3 nodes, 2 replicas, 6 CR and 4
     RS(2+1) chains, 2 writers, 2 readers, heartbeat timeout 0.6 s) and
     --smoke windows, with 1 MiB chunks and writes and a 32 MB/s move
     budget, a CudaChecksumBackend a node: add an empty node, flap it
     mid-move, drain an original node.  All five gates in both cells (zero
     wrong bytes, zero foreground errors, the drill's read p50 within 1.3x
     of the baseline's + 0.5 ms, paced within budget, converged); before
     each cell's cluster stops, every chain's replicas equal in bytes and
     ChunkMeta, each checksum the host CRC and plain B1 of its bytes, the
     drained node holding no chain target and the added node its solver
     share; every resync REPLACE a move's destination applied queued for
     B1 on the device (counted per node), every codec route a cuda-* one;
     then the drill cell once more under race_audit (every apply_update
     audited, no race, its structural fields clean); prints both cells'
     p50s and p99s, the jobs, bytes moved, the pacer, B1 batches and items
     a node and each stall LoopStallDetector (0.1 s) saw on the timed
     run's loop, with its frames
 31  only with --soak RUNS, which runs phase 0 and then this phase RUNS
     times in turn, a JSON line of each run's gates, and exits 0 only if
     every run passed every check; the default run leaves it out, since its
     progress gate held in 8 of 21 runs on the card.  The mixed-workload
     soak: the reference's scenarios as shipped, through t3fs_torch/benchmarks/soak_bench.run_cell in this
     process's loop, every node a CudaChecksumBackend (B1) and every EC
     client's codec TorchECCodec on the card: (a) configs/soak.toml faults
     on, 75 s of six drivers at once (dataloader reads on the rpc and ring
     planes, EC RS(4+2) checkpoint cycles, KVCache churn under eviction, a
     metadata scan, a mini GraySort) over 5 nodes, 5 chains of 3 and 8
     RS(4+2) chains, with a straggler, a node add, a crash, a drain, bit rot
     and a second straggler, the rebalancer on; (b) configs/soak_smoke.toml
     faults off, 12 s, the cell that gates fairness.  Fails on a cell's own
     gates (zero wrong bytes and progress in every window in both, Jain
     fairness >= 0.8 in b), a fault of (a) whose injector failed, B1
     launched on no node in (a), or (a)'s checkpoint stripes on no cuda-*
     route (TorchECCodec.codec_counts); prints each workload's p50, p99 and
     ops, the fairness, each gate, the fault events, B1 batches and items a
     node, each cell's launches and codec routes, the worst trace's first
     12 lines (render_trace), the stalls LoopStallDetector (0.1 s) saw in
     (a), the host (CPU model, cores, load, a fixed Python loop's seconds)
     before and after, and the phase's wall; the tracing config it found
     is put back
 32  an operator's session through the port's admin CLI
     (t3fs_torch/cli/admin.py: its build_parser and dispatch in this
     process's loop, stdout captured) against the port's DevCluster at the
     deployment's defaults (3 storage processes on B1, 3 replicas, 1 MiB
     chunks, the WAL KV) with meta, monitor and 10 chains; the CLI's
     ckpt-verify codec a TorchECCodec on the card, built and warmed before
     the session.  The cluster commands (list-nodes, lease, routing,
     cluster-health, config-versions, client-sessions, space-info, and
     app-info, get-config, verify-config, hot-update-config on storage1,
     gen-chains without installing); a seeded 64 MiB file put (B1 on each
     replica of each chunk), ls, stat (its length), chmod, chown, get (equal
     bytes), checksum (the host CRC), mv, trash-put, trash-ls; dump-chunkmeta
     and query-chunk on its chunks, checksum-sweep of its chain (every chunk
     ok), fill-zero of chunks 0-1 (REPLACEs on B1), get (zeros there, the
     rest unchanged) and the sweep again; bench at its defaults; steps 10
     and 20 of one 64 MiB float32 leaf saved here at RS(8+2) over the 10
     chains, ckpt-list, ckpt-stat (rs=(8+2)), ckpt-verify (nothing missing),
     one data shard of step 20 removed and ckpt-verify --repair (repaired
     equal to the removed), ckpt-verify (missing=0), step 20 restored bit
     for bit, ckpt-gc --keep 1 (removed=[10]); `python -m
     t3fs_torch.cli.admin ... ckpt-verify` as a subprocess on the card, its
     line equal to the one in process; rm -r and trash-clean.  Fails on a
     command's non-zero return, a value not as stated, a storage process
     that launched no B1 (from its log at its stop), or no cuda-* route in
     the CLI's codec; prints each command with its first lines and wall,
     the bench line, B1 batches, items and launches a storage process, the
     codec's routes, the launches and the phase's wall
 33  when phase 0's probe says the kernel mount is available (else
     "[33] not run: <the probe's answer>"): a user's POSIX checkpoint
     through FUSE.  The port's DevCluster at the deployment's defaults (3
     storage processes on B1, 3 replicas, 1 MiB chunks, the WAL KV, meta)
     mounted by `python -m t3fs_torch.app.fuse_main` (a process, max_write
     128 KiB, group_source "registry", no GPU visible); from this process a
     seeded 64 MiB file in write(2)s of 1 MiB and a torch.save state dict
     of ~16 MiB (float32, bfloat16, int64, an odd length), fsync, stat,
     listdir, rename, symlink, readlink, get-conf/attr_timeout; that
     fuse_main stopped by SIGTERM (exit 0, unmounted) and a second one
     mounted: every byte back in 1 MiB preads in a seeded order and 256
     seeded 4 KiB preads, torch.load(map_location="cuda") every tensor
     equal; every chunk of every replica over the storage RPCs (replicas
     equal, each checksum the host CRC, each chunk its bytes); truncate,
     unlink, rmdir and meta's GC clearing every replica; `python -m
     t3fs_torch.benchmarks.meta_bench --fuse --json` at the reference's
     defaults (its own process), every op count the reference's formula,
     beside phase 29's meta_bench --mgmtd.  Fails on a wrong byte, size,
     listing or errno, a fuse_main exit other than 0, a mount left after
     its process stopped, a replica or checksum wrong, or a storage
     process with fewer B1 items than 64 MiB / 128 KiB (each 128 KiB
     WRITE payload on each replica); prints each step's wall, the MB/s
     through the mount, B1 batches, items and launches a storage process
     (the launches added to the kernels line) and meta_bench's JSON
 15  each phase's wall, the kernels line, the card line, then the ok line
     last (with --rebalance-drill or --soak, a line of each run's gates
     instead)

Every phase that drives TorchECCodec checks that no call took a plain
route on the card.  Launch counts: the counters are set to 0 just before
each main-path run (phases 3, 4, 7, 8, 9, 12, 13 and 17's codec calls, the
bench run of phase 16, which counts H1 only: its hundreds of B1 and B2
launches would drown the codec paths' counts, each mesh rank's one run of
its steps in phase 19, summed over the ranks, phase 20's step, each
pass of phase 21, each step of phases 22, 23 and 24 after its cluster's
start and warmups, each sort job and kvcache_bench run of phase 25 after
its fabric's start and warmup, phase 26's usrbio_bench runs (a and b) and
its riders after their cluster's start and warmups, each run of phase 27's
parts, 27d's before its microbench; phase 28's, 29's, 32's and 33's storage
processes each start at 0 and log their count at their stop, and phase
32's session in this process after its warm-ups; phase 30's drill, both
cells from their clusters' start; phase 31's cells, each from its
runner's warm-up) and read just after; launches
made to compare a kernel with its plain version (phases 1, 2, 5, 6, 10, 11,
14, 16's checks and 17's kernel checks) are not counted.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import io
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 20261016
# H100 SXM HBM3 rate (NVIDIA data sheet); the bound of a kernel that only
# has to move its bytes
HBM_BYTES_PER_S = 3.35e12
K, M = 8, 2
SHARD_BYTES = 1 << 20          # stripe write: 1 MiB shards, 12 stripes a step
STRIPES = 12
CHUNK_BYTES = 4 << 20          # storage write: 4 MiB chunks, 64 a batch
CHAIN_FILE_BYTES = 512 << 20   # phase 21: one file, 128 chunks over 3 replicas
CHUNKS = 64
SUBSHARDS = 4                  # ec_client.subshard_r(1 MiB): 4 x 256 KiB reads
LOST_CHUNKS = 24               # repair: 24 lost chunks -> 96 sub-shard repairs
LOST_SLOT = 3
READ_PATTERNS = ((2,), (0, 5), (4, 8))
K63, M63 = 6, 3                # HDFS RS-6-3-1024k: RS(6+3), 1 MiB cells
LOST63 = (1, 4, 7)
LRC_GROUP = 3                  # ECLayout.local_group_size
ODD_CHUNK = 1_000_000          # a chunk length that is not whole 512-byte segments
MSR_LOSSES = ((0, 9), (4, 9))  # pm-msr two-loss reads: a data + a parity slot
# B3's timed patterns (phase 10): (0, 9) one Horner row and one XOR fold,
# (0, 1) the decode bench's, (0, 5) and (4, 8) phase 7's, (3,) a pure XOR fold
B3_WANTS = ((0, 9), (0, 1), (0, 5), (4, 8), (3,))
# RAID-6 k past one group of 8 survivors, up to B3's limit (phase 6)
B3_GROUP_KS = (12, 31, 32)
# B6's timed shapes (phase 14): whole segments, rows at all 16 misalignments,
# and ODD_CHUNK (1954 segments: runs of 16 after a ragged first run of 2)
B6_SHAPES = (("64 x 4 MiB", CHUNK_BYTES),
             ("64 x (4 MiB - 5), rows unaligned", CHUNK_BYTES - 5),
             ("64 x 1 000 000 B, ragged first run", ODD_CHUNK))
SORT_RECORDS = 1 << 24         # phase 18: one reduce partition, 1.68 GB of rows
# phase 19: a 2 x 2 mesh (4 ranks) at the stripe bench's width, 24 stripes;
# the word decode of a data and a parity shard, and of one data shard
MESH_RANKS, MESH_DP, MESH_STRIPES = 4, 2, 24
MESH_WANTS = ((0, 9), (3,))
# phase 22: 64 RS(8+2) stripes of 8 x 1 MiB (512 MiB of data), 16 calls in
# flight; 8 stripes each of pm-msr, RS(6+3) and lrc-xor; 16 reads after a
# node's server stops
EC_STRIPES = 64
EC_INFLIGHT = 16
EC_SMALL_STRIPES = 8
EC_NODE_LOSS_READS = 16
# phase 23: the recovery drill on a LocalCluster of 5 nodes at storage_bench's
# 4 MiB chunks; only the chunk and stripe counts are cut from a storage_bench run
RECOVERY_FILE_CHUNKS = 256     # a 1 GiB file over 5 chains of 3 (3 GiB stored)
RECOVERY_OVERWRITES = 64       # chunks of it overwritten while a node is down
RECOVERY_NEW_CHUNKS = 64       # a 256 MiB file written while a node is down
RECOVERY_EC_STRIPES = 32       # RS(8+2) stripes of 8 x 1 MiB: 256 MiB of data
RECOVERY_DEGRADED_READS = 16
RECOVERY_INFLIGHT = 16         # chunk writes in flight
RECOVERY_FLAP_NODE = 2         # fail-stops, restarts on its old disk
RECOVERY_WIPE_NODE = 4         # restarts on an empty disk
RECOVERY_ROT_STRIPE = 5        # one shard of it bit-rotted on disk

# phase 24: the file system and a parallel checkpoint (ckpt_bench's code
# and admission), a 512 MiB tree: a cut of a real checkpoint's size (its
# count of leaves, never their width, cut from 16 to keep the run short)
CKPT_CHUNK = 256 << 10         # RS(8+2) shards of 256 KiB: 2 MiB stripes
CKPT_BIG_LEAVES = 8            # leaves of CKPT_LEAF_BYTES
CKPT_LEAF_BYTES = 64 << 20
CKPT_ODD_LEAVES = (4096, 1_000_003, (3 << 20) + 17)   # partial stripes, trimmed tails
CKPT_STEP2_LEAVES = 2          # the second step: 2 leaves of CKPT_LEAF_BYTES
CKPT_READERS = 4               # restore_shard readers
CKPT_NS_FILE = 256 << 20       # the namespace's file, CHUNK_BYTES chunks
CKPT_WINDOW = 8                # stripes in flight (ckpt_bench's default)
CKPT_PER_CHAIN = 2             # chunk writes in flight per chain
# phase 25: the GraySort-analog through storage (the reference's multi-process
# run, BENCH_e2e.json "r3_graysort_1GiB_multiprocess_32part", on the
# in-process fabric of one host), then kvcache_bench's shape (BASELINE.json
# config #5) and one DeepSeek-V3 KV block of 16 tokens
# (num_hidden_layers 61 x (kv_lora_rank 512 + qk_rope_head_dim 64) x 2 B
# of bf16), then kvcache_fleet_bench's CI smoke with the admission A/B
# Cut to keep the phase near 120 s of command time (the full counts took
# 146 s for the sort job's two runs and 129.6 s for the two stores, on an
# NVIDIA H100 80GB HBM3 at 700 W and its host): the input from 1 GiB to
# 128 MiB (256 MiB took 39.3 s for both runs on a slow host, which with
# phases 26 and 29 at their former counts put the whole default run at
# 935 s), the 16 KiB blocks from 16 384 to 2048 (kvcache_bench's
# documented run)
SORT_JOB_MB = 128              # 1 342 176 gensort records of 100 B
SORT_JOB_WORKERS = 8
SORT_JOB_PARTITIONS = 32
SORT_JOB_CHUNK = 1 << 20
KV_BLOCKS = 2048               # 16 KiB values: 32 MiB
KV_VALUE = 16 << 10
KV_BATCH = 32
KV_CONCURRENCY = 16
KV_SECONDS = 5.0
KV_DSV3_VALUE = 16 * 61 * (512 + 64) * 2     # 1 124 352 B: a 2 MiB block class
KV_DSV3_BLOCKS = 512
KV_DSV3_BATCH = 8
KV_DSV3_CONCURRENCY = 8
KV_CHECK_KEYS = 64             # distinct seeded values put, read, removed
FLEET_ARGS = ["--procs", "2", "--sessions", "8", "--turns", "1", "--prompts",
              "16", "--blocks", "4", "--admission-ab", "--json"]
# phase 26: the usrbio ring data plane on usrbio_bench's documented cluster
# (LocalCluster of 3 nodes, 2 chains of 2 replicas, with meta).  (a) its
# documented 4 KiB random reads (depth 64, 5 s a cell, one trial) over an
# 8 MiB file: cut from a KVCache node's working set so that each cell's
# 4 KiB populate (2048 chunk writes) stays near 4-8 s (the host of an
# NVIDIA H100 80GB HBM3 machine took 275-570 chunk writes/s, a 64 MiB
# file 79 s on the rpc plane, and a 16 MiB file 11-14 s a cell on a slow
# host); (b) the same at the
# ring slot size, 256 KiB blocks over a 256 MiB file, then 64 app OP_WRITEs;
# (c) a 256 MiB checkpoint (4 leaves of CKPT_LEAF_BYTES at RS(8+2), 256 KiB
# shards) and 512 KVCache blocks of 16 KiB on data_plane="ring"
USRBIO_ARGS = ["--nodes", "3", "--replicas", "2", "--chains", "2", "--depth", "64",
               "--seconds", "5", "--trials", "1", "--verify", "--seed", str(SEED + 26)]
USRBIO_SMALL_BLOCK = 4096
USRBIO_SMALL_FILE = 8 << 20
USRBIO_BIG_BLOCK = 256 << 10   # StorageClientConfig.ring_slot_size
USRBIO_BIG_FILE = 256 << 20
USRBIO_APP_WRITES = 64         # the app iov's depth: one wave
RING_CKPT_LEAVES = 4           # of CKPT_LEAF_BYTES: a 256 MiB tree
RING_KV_BLOCKS = 512
RING_KV_VALUE = 16 << 10
# a kernel's time is the median of this many samples of 20 calls each: one
# sample can sit well off the others, and the printed min and max show it
REPEATS = 5
# phase 27: BASELINE.json's harness at the reference's widths
HARNESS_CHUNK = 4 << 20        # configs #1 and #2: 4 MiB chunks
HARNESS_SECONDS = 5.0          # storage_bench's and codec_economics' default
HARNESS_WRITE_OPS = 16         # the Makefile's write-bench --num-ops
HARNESS_EC_STRIPES = 16        # ec_recovery_bench's default (the CPU rehearsal's)
ECON_SIZES = (65536, 1 << 20)  # codec_economics' default chunk sizes
DRILL_ARGS = ["--stripes", "12", "--chunk-size", "65536", "--repair-mode", "both"]
# phase 28: the port's own deployment at DevCluster's documented layout (3
# storage processes, 3 replicas, 2 chains, 1 MiB chunks, the durable WAL KV
# under mgmtd and meta, the monitor on); a 256 MiB file, a 16 MiB one written
# while storage2 is down, storage_bench --mgmtd at config #2's widths (4 MiB,
# concurrency 1, 16 chunks)
DEV_NODES, DEV_REPLICAS, DEV_CHAINS = 3, 3, 2
DEV_CHUNK = 1 << 20
DEV_FILE_BYTES = 256 << 20
DEV_DOWN_FILE_BYTES = 16 << 20
DEV_KILLED = 2
DEV_BENCH_ARGS = ["--mode", "write", "--chunk-size", str(HARNESS_CHUNK),
                  "--num-chunks", str(HARNESS_WRITE_OPS), "--concurrency", "1",
                  "--seconds", "3", "--json"]
# phase 29: meta over a range-sharded KV of two kv_main processes, each on
# its own WAL, the storage processes at phase 28's layout on B1; a 60 s
# heartbeat timeout (no storage process is killed here); meta_bench --mgmtd
# at the reference's defaults with 64 files a directory (1024 files; 2048
# took 65 s with the bench's start on a slow host), a
# 64 MiB file through FileSystem, then kv2 SIGKILLed amid creates and
# respawned over its WAL on the port it first bound
SHARD_KV = 2
META_BENCH_ARGS = ["--dirs", "16", "--files", "64", "--concurrency", "32"]
SHARD_FILE_BYTES = 64 << 20
SHARD_ACKED = 128           # creates acknowledged before the kill
SHARD_STREAM = 8            # creates in flight when kv2 dies
SHARD_STREAM_ACKED = 32     # stream creates acknowledged before the kill
SHARD_BUDGET_S = 150.0      # kv_distributor_bench runs only inside it
SHARD_DIST_ARGS = ["--smoke"]
# phase 30: elastic membership, the reference's rebalance drill at its cluster
# (3 nodes, 2 replicas, 6 CR and 4 EC chains, RS(2+1), 2 writers, 2 readers)
# and --smoke windows, with DevCluster's 1 MiB chunks and writes (the
# reference's 8 KiB lies under the backend's 64 KiB device cutoff, so no
# moved chunk would reach B1) and a 32 MB/s move budget; a stall is a loop
# gap past STALL_THRESHOLD_S
REBALANCE_ARGS = ["--smoke", "--chunk-size", "1048576", "--write-size", "1048576",
                  "--budget-mbps", "32"]
STALL_THRESHOLD_S = 0.1
# phase 31: the reference's scenarios as shipped, (a) the full mixed soak
# faults on, (b) the smoke scenario faults off (the cell that gates fairness)
SOAK_CELLS = (("configs/soak.toml", True), ("configs/soak_smoke.toml", False))



def log(msg: str) -> None:
    print(msg, flush=True)


def u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((u32(a) - u32(b)).abs().max().item()) if a.numel() else 0


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def expect_routes(codec, routes: tuple[str, ...]) -> None:
    for r in routes:
        expect(codec.codec_counts.get(r, 0) > 0, f"no call took route {r}")
    expect(all(r.startswith("cuda-") for r in codec.codec_counts),
           f"a plain route ran on the card: {codec.codec_counts}")


def rand_words(g: torch.Generator, dev: torch.device, *shape: int) -> torch.Tensor:
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                         device=dev, generator=g)


def front_padded_words(payloads: list[bytes], chunk_words: int,
                       dev: torch.device) -> torch.Tensor:
    arr = np.zeros((len(payloads), chunk_words * 4), dtype=np.uint8)
    for i, p in enumerate(payloads):
        arr[i, arr.shape[1] - len(p):] = np.frombuffer(p, dtype=np.uint8)
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def bucket_words(nbytes: int) -> int:
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend

    return CudaChecksumBackend._bucket_words(nbytes)


def plain_crcs(payloads: list[bytes], dev: torch.device, group: int = 8) -> list[int]:
    """CRC32C of each payload by the plain version of B1 (front-padded)."""
    from t3fs_torch.ops.crc32c import default_matrices
    from t3fs_torch.ops.cuda_codec import crc_words_raw_plain
    from t3fs_torch.ops.tables import codec_tables

    mats = default_matrices()
    out: dict[int, int] = {}
    by_bucket: dict[int, list[int]] = {}
    for i, p in enumerate(payloads):
        by_bucket.setdefault(bucket_words(len(p)), []).append(i)
    for cw, idx in by_bucket.items():
        tables = codec_tables(cw // 128, device=dev)
        for s in range(0, len(idx), group):
            part = idx[s:s + group]
            words = front_padded_words([payloads[i] for i in part], cw, dev)
            raw = u32(crc_words_raw_plain(words, tables)).cpu().tolist()
            for i, r in zip(part, raw):
                out[i] = r ^ mats.affine_const(len(payloads[i]))
    return [out[i] for i in range(len(payloads))]


# --- phase 1: B1 against plain -----------------------------------------------

def phase_crc(dev: torch.device, g: torch.Generator, chunk_words: int,
              chunks: int, seg_rows: int) -> int:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref, default_matrices
    from t3fs_torch.ops.tables import codec_tables

    worst = 0
    t1 = codec_tables(1, device=dev)
    for rows in (seg_rows, 1, 7, 1001):          # whole and ragged 16-row units
        segs = rand_words(g, dev, rows, 128)
        e = max_abs_err(cc.crc_seg_words(segs, t1), cc.crc_seg_words_plain(segs, t1))
        log(f"[1] crc_seg_words ({rows}, 128): max_abs_err={e}")
        worst = max(worst, e)
    # every run length the wrapper picks: spw = nseg for nseg <= 16
    e = 0
    for nseg in (*range(1, 17), 17, 24, 40):
        tn = codec_tables(nseg, device=dev)
        w = rand_words(g, dev, 3, nseg * 128)
        e = max(e, max_abs_err(cc.crc_words_raw(w, tn), cc.crc_words_raw_plain(w, tn)))
    log(f"[1] crc_words_raw (3, nseg * 128) for nseg 1..17, 24, 40 (every run "
        f"length 1..16): max_abs_err={e}")
    worst = max(worst, e)

    tables = codec_tables(chunk_words // 128, device=dev)
    words = rand_words(g, dev, chunks, chunk_words)
    got = cc.crc_words_raw(words, tables)
    subset = sorted({0, chunks // 3, chunks - 1})
    e = max_abs_err(got[subset], cc.crc_words_raw_plain(words[subset], tables))
    log(f"[1] crc_words_raw ({chunks}, {chunk_words}) = {chunks} x "
        f"{chunk_words * 4 >> 10} KiB: max_abs_err={e} on rows {subset} "
        "(the plain version expands every byte to 8 floats, so it runs on a "
        "subset)")
    worst = max(worst, e)

    mats = default_matrices()
    check = front_padded_words([b"123456789"], 128, dev)
    crc = int(u32(cc.crc_words_raw(check, t1)).item()) ^ mats.affine_const(9)
    log(f"[1] check vector crc32c(b'123456789') = {crc:#010x}")
    expect(crc == 0xE3069283, "check vector")

    rng = np.random.default_rng(SEED + 1)
    for n in (1000, (64 << 10) + 3, (129 << 10) + 3, chunk_words * 4 - 5):
        p = rng.bytes(n)
        cw = bucket_words(n)
        tw = codec_tables(cw // 128, device=dev)
        raw = int(u32(cc.crc_words_raw(front_padded_words([p], cw, dev), tw)).item())
        crc = raw ^ mats.affine_const(n)
        ref = crc32c_ref(p) if n <= (256 << 10) else plain_crcs([p], dev)[0]
        e = abs(crc - ref)
        log(f"[1] front-padded length {n}: crc={crc:#010x} ref={ref:#010x}")
        worst = max(worst, e)
    expect(worst == 0, f"B1 disagrees with its plain version (max_abs_err={worst})")
    return worst


# --- phase 2: B2 and the fused step against plain ----------------------------

def phase_stripe(dev: torch.device, g: torch.Generator, shard_words: int,
                 stripes: int) -> tuple[int, int]:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32

    tables = codec_tables(shard_words // 128, K, M, device=dev)
    words = rand_words(g, dev, stripes, K, shard_words)
    plain_par = cc.rs_raid6_words_plain(words, tables)
    e_rs = max_abs_err(cc.rs_raid6_words(words, tables), plain_par)
    log(f"[2] rs_raid6_words ({stripes}, {K}, {shard_words}): max_abs_err={e_rs}")

    step = cc.make_stripe_encode_step_words(shard_words, K, M, device=dev)
    parity, crcs = step(words)
    plain_crc = torch.cat([
        cc.crc_words_raw_plain(words.reshape(stripes * K, shard_words), tables)
        .reshape(stripes, K),
        cc.crc_words_raw_plain(plain_par.reshape(stripes * M, shard_words), tables)
        .reshape(stripes, M)], dim=1) ^ i32(tables.chunk_affine)
    e_par = max_abs_err(parity, plain_par)
    e_crc = max_abs_err(crcs, plain_crc)
    log(f"[2] fused stripe step: parity max_abs_err={e_par}, "
        f"crcs ({stripes}, {K + M}) max_abs_err={e_crc}")

    data0 = words[0].cpu().numpy().view(np.uint8)               # (k, L) bytes
    ref_par = default_rs(K, M).encode_ref(data0)
    par0 = parity[0].cpu().numpy().view(np.uint8)
    expect(np.array_equal(par0, ref_par), "stripe 0 parity != RSCode.encode_ref")
    c0 = crc32c_ref(data0[0].tobytes())
    expect(int(u32(crcs[0, 0]).item()) == c0, "stripe 0 shard 0 CRC != crc32c_ref")
    log("[2] stripe 0 parity == RSCode.encode_ref, shard 0 CRC == crc32c_ref")
    expect(e_rs == 0 and e_par == 0 and e_crc == 0,
           "B2 or the fused step disagrees with its plain version")
    return e_rs, e_crc


# --- phase 3: storage write path ---------------------------------------------

def storage_sizes(chunk_bytes: int) -> list[int]:
    """The write mix: mostly full chunks, some 1 MiB, some odd lengths above
    the 64 KiB cutoff, and a few below it (host path)."""
    return ([chunk_bytes] * 208 + [chunk_bytes // 4] * 32
            + [(129 << 10) + 3] * 12 + [40_000] * 4)


async def phase_storage(dev: torch.device, sizes: list[int]) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend, make_checksum_backend)
    from t3fs_torch.utils.status import StatusError

    backend = make_checksum_backend("tpu", device=dev)
    expect(isinstance(backend, CudaChecksumBackend), "'tpu' must map to CUDA")
    rng = np.random.default_rng(SEED + 3)
    order = rng.permutation(len(sizes))
    payloads = [rng.bytes(sizes[i]) for i in order]
    device_items = sum(len(p) >= DEFAULT_MIN_DEVICE_BYTES for p in payloads)

    cc.reset_launches()
    t0 = time.perf_counter()
    crcs = await asyncio.gather(*(backend.payload_crc(p) for p in payloads))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)

    ref = plain_crcs(payloads, dev)
    for i, p in enumerate(payloads):
        if len(p) < (256 << 10):
            ref[i] = crc32c_ref(p)      # odd and host-path lengths: the oracle
    bad = [i for i, (c, r) in enumerate(zip(crcs, ref)) if c != r]
    total = sum(len(p) for p in payloads)
    log(f"[3] storage write path: {len(payloads)} concurrent payload_crc, "
        f"{total / 2**20:.1f} MiB, {device_items} on the device in "
        f"{backend.batches} buckets ({backend.batched_items} items); "
        f"crc_words launches={launches['crc_words']}; wall {wall:.3f} s "
        f"({total / wall / 1e9:.2f} GB/s host clock); wrong CRCs: {len(bad)}")
    expect(not bad, f"storage path: {len(bad)} wrong CRCs")
    expect(backend.batched_items == device_items, "every >=64 KiB payload batched")
    expect(launches["crc_words"] == backend.batches > 0,
           "one B1 launch per device bucket")

    await backend.close()
    try:
        await backend.payload_crc(b"x" * (1 << 20))
    except StatusError:
        log("[3] payload_crc after close() fails fast")
    else:
        raise AssertionError("payload_crc after close() must fail")
    return launches


# --- phase 4: EC stripe write path -------------------------------------------

async def phase_ec(dev: torch.device, shard_bytes: int, requests: int) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32

    rng = np.random.default_rng(SEED + 4)
    stripes = [rng.integers(0, 256, (K, shard_bytes), dtype=np.uint8)
               for _ in range(requests)]
    codec = TorchECCodec(device=dev)
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(codec.encode_verified(s, K, M) for s in stripes))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()

    W = shard_bytes // 4
    tables = codec_tables(W // 128, K, M, device=dev)
    words = torch.from_numpy(np.stack(stripes).view(np.int32)).to(dev)
    plain_par = cc.rs_raid6_words_plain(words, tables)
    par = torch.from_numpy(np.stack([o[0] for o in outs]).view(np.int32)).to(dev)
    e_par = max_abs_err(par, plain_par)
    n = len(stripes)
    plain_crc = torch.cat([
        cc.crc_words_raw_plain(words.reshape(n * K, W), tables).reshape(n, K),
        cc.crc_words_raw_plain(plain_par.reshape(n * M, W), tables).reshape(n, M),
    ], dim=1) ^ i32(tables.chunk_affine)
    got_crc = torch.from_numpy(np.stack([o[1] for o in outs]).view(np.int32)).to(dev)
    e_crc = max_abs_err(got_crc, plain_crc)
    expect(np.array_equal(outs[0][0], default_rs(K, M).encode_ref(stripes[0])),
           "stripe 0 parity != RSCode.encode_ref")
    log(f"[4] EC stripe write path: {n} concurrent encode_verified "
        f"({K} x {shard_bytes >> 10} KiB), {codec.batches} batches, "
        f"codec_counts={codec.codec_counts}, launches={launches}, wall "
        f"{wall:.3f} s; parity max_abs_err={e_par}, crcs max_abs_err={e_crc}")
    expect(e_par == 0 and e_crc == 0, "EC path disagrees with plain")
    expect_routes(codec, ("cuda-encode-words",))
    expect(launches["rs_raid6_words"] > 0 and launches["crc_words"] > 0,
           "EC path must launch B2 and B1")
    return launches


# --- phase 5: times ----------------------------------------------------------

def time_ms(fn, iters: int, warm: int = 2) -> float:
    from t3fs_torch.benchmarks.devbench import event_ms

    return event_ms(fn, iters, warm)


def kernel_times(fn) -> dict:
    """ms per call: the median of REPEATS samples of 20 calls, and the
    samples' min and max."""
    samples = sorted(time_ms(fn, 20, warm=2 if i == 0 else 0)
                     for i in range(REPEATS))
    return {"ms": samples[len(samples) // 2], "min_ms": samples[0],
            "max_ms": samples[-1]}


def graph_kernel_times(fn) -> dict:
    """kernel_times of 20 calls captured once in a CUDA graph and replayed:
    for a call too short to hide the host's launch overhead."""
    from t3fs_torch.benchmarks.devbench import graph_samples

    samples = graph_samples(fn, 20, REPEATS)
    return {"ms": samples[len(samples) // 2], "min_ms": samples[0],
            "max_ms": samples[-1]}


def log_times(phase: int, out: dict) -> None:
    for name, t in out.items():
        log(f"[{phase}] {name} {t['shape']}: {t['ms'] * 1e3:.1f} us, median of "
            f"{REPEATS} (min {t['min_ms'] * 1e3:.1f}, max {t['max_ms'] * 1e3:.1f}) "
            f"(bound {t['bound_ms'] * 1e3:.1f} us by bytes at 3.35 TB/s, "
            f"{t['bound_ms'] / t['ms'] * 100:.1f}% of it); plain "
            f"{t['plain_ms'] * 1e3:.1f} us; library call: none")


def phase_times(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    out = {}
    cw = CHUNK_BYTES // 4
    tcrc = codec_tables(cw // 128, device=dev)
    words = rand_words(g, dev, CHUNKS, cw)
    nbytes = words.numel() * 4
    out["crc_words"] = {
        **kernel_times(lambda: cc.crc_words_raw(words, tcrc)),
        "plain_ms": time_ms(lambda: cc.crc_words_raw_plain(words, tcrc), 2, 1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"({CHUNKS}, {cw}) = {CHUNKS} x 4 MiB chunks",
    }
    l2 = words[:2]               # 8 MiB: stays in the 50 MB L2 across calls
    out["crc_words 8 MiB, L2-resident, CUDA graph"] = {
        **graph_kernel_times(lambda: cc.crc_words_raw(l2, tcrc)),
        "plain_ms": time_ms(lambda: cc.crc_words_raw_plain(l2, tcrc), 2, 1),
        "bound_ms": l2.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "shape": f"(2, {cw}) = 2 x 4 MiB chunks",
    }
    del words, l2
    sw = SHARD_BYTES // 4
    trs = codec_tables(sw // 128, K, M, device=dev)
    data = rand_words(g, dev, STRIPES, K, sw)
    rs_bytes = (K + M) * sw * 4 * STRIPES
    out["rs_raid6_words"] = {
        **kernel_times(lambda: cc.rs_raid6_words(data, trs)),
        "plain_ms": time_ms(lambda: cc.rs_raid6_words_plain(data, trs), 5),
        "bound_ms": rs_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"({STRIPES}, {K}, {sw}) = {STRIPES} stripes of {K} x 1 MiB",
    }
    step = cc.make_stripe_encode_step_words(sw, K, M, device=dev)

    def plain_step():
        par = cc.rs_raid6_words_plain(data, trs)
        cc.crc_words_raw_plain(data.reshape(STRIPES * K, sw), trs)
        cc.crc_words_raw_plain(par.reshape(STRIPES * M, sw), trs)

    out["stripe_step"] = {
        **kernel_times(lambda: step(data)),
        "plain_ms": time_ms(plain_step, 2, 1),
        "bound_ms": rs_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": out["rs_raid6_words"]["shape"],
    }
    log_times(5, out)
    return out


# --- phase 6: B3, B4 and B5 against plain ------------------------------------

def erasure_patterns(n: int = K + M) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """The 55 single and double erasures of RS(8+2): (present, want), present
    the first k survivors, as the EC client picks them."""
    losses = [(a,) for a in range(n)] + [(a, b) for a in range(n)
                                          for b in range(a + 1, n)]
    return [(present_of(lost, n, K), lost) for lost in losses]


def present_of(lost: tuple[int, ...], n: int, k: int) -> tuple[int, ...]:
    return tuple(s for s in range(n) if s not in lost)[:k]


def repair_plan(lost: int) -> tuple[list[int], tuple[int, ...]]:
    """ec_client._plan_reduced without holes: helpers sorted(survivors)[:k]
    and the single-row coefficients, zero ones dropped."""
    from t3fs_torch.ops.rs import default_rs

    present = sorted(s for s in range(K + M) if s != lost)[:K]
    row = default_rs(K, M).reconstruct_gfmatrix(present, [lost])[0]
    keep = [(s, int(c)) for s, c in zip(present, row) if c]
    return [s for s, _ in keep], tuple(c for _, c in keep)


def phase_read_kernels(dev: torch.device, g: torch.Generator) -> dict[str, int]:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.repair_program import (
        eval_program_np, schedule_repair_program, single_row_program, xor_program)
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import decode_tables, encode_map_tables, repair_tables

    rs = default_rs(K, M)
    W = SHARD_BYTES // 4
    errs = {}
    one = rand_words(g, dev, 1, K, W)
    odd = one[:, :, :W - 1].contiguous()         # w % 4 != 0: the u32 path
    e = 0
    for present, want in erasure_patterns():
        dec = decode_tables(present, want, rs, dev)
        for x in (one, odd):
            e = max(e, max_abs_err(cc.rs_reconstruct_words(x, dec),
                                   cc.rs_reconstruct_words_plain(x, dec)))
    log(f"[6] rs_reconstruct_words, all 55 RS(8+2) erasure patterns at (1, {K}, "
        f"{W}) (uint4 path) and (1, {K}, {W - 1}) (u32 path): max_abs_err={e}")
    for kk in B3_GROUP_KS:                       # survivors in several groups of 8
        rsk = default_rs(kk, M)
        x = rand_words(g, dev, 4, kk, W // 4)
        ek = 0
        for lost in ((0, kk + 1), (kk // 2,), (3, kk)):
            dec = decode_tables(present_of(lost, kk + M, kk), lost, rsk, dev)
            for xx in (x, x[:, :, 1:].contiguous()):
                ek = max(ek, max_abs_err(cc.rs_reconstruct_words(xx, dec),
                                         cc.rs_reconstruct_words_plain(xx, dec)))
        log(f"[6] rs_reconstruct_words RAID-6 k = {kk} at (4, {kk}, {W // 4}) and "
            f"(4, {kk}, {W // 4 - 1}), 3 patterns: max_abs_err={ek}")
        e = max(e, ek)
    words = rand_words(g, dev, STRIPES, K, W)
    for want in ((3,), (0, 9)):
        dec = decode_tables(present_of(want, K + M, K), want, rs, dev)
        got = cc.rs_reconstruct_words(words, dec)
        ew = max_abs_err(got, cc.rs_reconstruct_words_plain(words, dec))
        log(f"[6] rs_reconstruct_words want={want} at ({STRIPES}, {K}, {W}): "
            f"max_abs_err={ew}")
        e = max(e, ew)
    surv = words[0].cpu().numpy().view(np.uint8)
    present = present_of((0, 9), K + M, K)
    ref = rs.decode_ref(dict(zip(present, surv)), [0, 9])
    expect(np.array_equal(got[0].cpu().numpy().view(np.uint8), ref),
           "B3 stripe 0 != RSCode.decode_ref")
    errs["rs_reconstruct_words"] = e

    hw = SHARD_BYTES // SUBSHARDS // 4
    helpers = rand_words(g, dev, LOST_CHUNKS * SUBSHARDS, K, hw)
    progs = [single_row_program(rs, present_of((lost,), K + M, K), lost)
             for lost in range(K + M)] + [xor_program(LRC_GROUP)]
    e = 0
    for prog in progs:
        rep = repair_tables(prog, rs)
        x = helpers[:, :prog.num_helpers].contiguous()
        got = cc.repair_words(x, rep)
        e = max(e, max_abs_err(got, cc.repair_words_plain(x, rep)))
        ref = eval_program_np(prog, x[0].cpu().numpy().view(np.uint8), rs)
        expect(np.array_equal(got[0].cpu().numpy().view(np.uint8), ref),
               f"B4 row 0 != eval_program_np for {prog.coeffs}")
    slots, coeffs = repair_plan(LOST_SLOT)
    expect(schedule_repair_program(coeffs).is_xor, "slot 3's plan is the XOR fold")
    log(f"[6] repair_words, {len(progs)} programs (10 single-row + LRC all-ones "
        f"over {LRC_GROUP}) at ({LOST_CHUNKS * SUBSHARDS}, h, {hw}): "
        f"max_abs_err={e}; row 0 of each == eval_program_np")
    errs["repair_words"] = e
    del helpers, words

    rs63 = default_rs(K63, M63)
    shards = torch.randint(0, 256, (STRIPES, K63, SHARD_BYTES), dtype=torch.uint8,
                           device=dev, generator=g)
    present = present_of(LOST63, K63 + M63, K63)
    dec = decode_tables(present, LOST63, rs63, dev)
    enc = encode_map_tables(rs63, dev)
    got_d, got_e = cc.rs_bitmatmul(shards, dec), cc.rs_bitmatmul(shards, enc)
    e = max(max_abs_err(got_d, cc.rs_bitmatmul_plain(shards, dec)),
            max_abs_err(got_e, cc.rs_bitmatmul_plain(shards, enc)))
    s0 = shards[0].cpu().numpy()
    expect(np.array_equal(got_d[0].cpu().numpy(),
                          rs63.decode_ref(dict(zip(present, s0)), list(LOST63))),
           "B5 decode stripe 0 != RSCode.decode_ref")
    expect(np.array_equal(got_e[0].cpu().numpy(), rs63.encode_ref(s0)),
           "B5 encode stripe 0 != RSCode.encode_ref")
    log(f"[6] rs_bitmatmul RS({K63}+{M63}) decode want={LOST63} and encode at "
        f"({STRIPES}, {K63}, {SHARD_BYTES}), compared in full: max_abs_err={e}; "
        "stripe 0 == RSCode.decode_ref / encode_ref")
    errs["rs_bitmatmul"] = e
    expect(max(errs.values()) == 0, f"B3/B4/B5 disagree with plain: {errs}")
    return errs


def raid6_stripes(dev: torch.device, g: torch.Generator, n: int) -> np.ndarray:
    """(n, k+m, 1 MiB) uint8 stripes: random data, parity by B2 (held
    against RSCode.encode_ref in phase 2)."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    W = SHARD_BYTES // 4
    data = rand_words(g, dev, n, K, W)
    parity = cc.rs_raid6_words(data, codec_tables(1, K, M, device=dev))
    full = torch.cat([data, parity], dim=1).cpu().numpy()
    return full.view(np.uint8)


def plain_shard_crcs(full: np.ndarray, dev: torch.device) -> np.ndarray:
    """(n, s, L) uint8 -> (n, s) uint32 CRC32C by the plain version of B1."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32

    n, s, L = full.shape
    tables = codec_tables(L // 512, device=dev)
    words = torch.from_numpy(np.ascontiguousarray(full).view(np.int32)).to(dev)
    raw = torch.cat([cc.crc_words_raw_plain(part, tables)
                     for part in words.reshape(n * s, L // 4).split(48)])
    return (raw ^ i32(tables.chunk_affine)).cpu().numpy().view(np.uint32).reshape(n, s)


# --- phase 7: degraded-read path --------------------------------------------

async def phase_degraded(dev: torch.device, full: np.ndarray,
                         crcs: np.ndarray) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc

    codec = TorchECCodec(device=dev)
    # build each pattern's step (tables, first launch) off the timed path
    codec.warmup_decode([(present_of(w, K + M, K), w) for w in READ_PATTERNS],
                        full.shape[-1], K, M, batch_sizes=(8,))
    reqs = []
    for i in range(full.shape[0]):
        want = READ_PATTERNS[i % len(READ_PATTERNS)]
        present = present_of(want, K + M, K)
        reqs.append((i, present, want, np.ascontiguousarray(full[i, list(present)])))
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(codec.reconstruct_verified(rows, p, w, K, M)
                                  for _i, p, w, rows in reqs))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()
    bad_bytes = bad_crcs = 0
    for (i, present, want, _rows), (rebuilt, got) in zip(reqs, outs):
        bad_bytes += not np.array_equal(rebuilt, full[i, list(want)])
        bad_crcs += not np.array_equal(got, crcs[i, list(present + want)])
    log(f"[7] degraded-read path: {len(reqs)} concurrent reconstruct_verified "
        f"(RS({K}+{M}), {SHARD_BYTES >> 10} KiB shards, patterns {READ_PATTERNS}, "
        "after warmup_decode; codec_counts include the warmups): "
        f"{codec.flushes} flush(es), {codec.batches} groups, "
        f"{codec.batched_items} items, codec_counts={codec.codec_counts}, "
        f"launches={launches}, wall {wall:.3f} s; wrong stripes {bad_bytes}, "
        f"wrong CRC rows {bad_crcs}")
    expect(bad_bytes == 0 and bad_crcs == 0, "degraded reads disagree")
    expect_routes(codec, ("cuda-decode-words",))
    expect(codec.batches >= len(READ_PATTERNS), "one group per pattern")
    expect(launches["rs_reconstruct_words"] >= len(READ_PATTERNS)
           and launches["crc_words"] > 0, "degraded reads must launch B3 and B1")
    return launches


# --- phase 8: repair path ----------------------------------------------------

async def phase_repair(dev: torch.device, full: np.ndarray,
                       crcs: np.ndarray) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.codec import crc32c_combine

    slots, coeffs = repair_plan(LOST_SLOT)
    sub = SHARD_BYTES // SUBSHARDS
    n = LOST_CHUNKS
    codec = TorchECCodec(device=dev)
    codec.warmup_repair([coeffs], sub, K, M, batch_sizes=(32,))
    codec.warmup_repair([(1, 1, 1), (1, 1)], full.shape[-1], K, M,
                        batch_sizes=(STRIPES,))
    jobs = [np.ascontiguousarray(full[i, slots, q * sub:(q + 1) * sub])
            for i in range(n) for q in range(SUBSHARDS)]
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(codec.repair(rows, coeffs, K, M) for rows in jobs))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    groups, flushes = codec.batches, codec.flushes

    t1 = time.perf_counter()
    stitched = []
    for i in range(n):
        parts = outs[i * SUBSHARDS:(i + 1) * SUBSHARDS]
        crc = int(parts[0][1])
        for _p, c in parts[1:]:
            crc = crc32c_combine(crc, int(c), sub)
        stitched.append(crc)
    stitch_s = time.perf_counter() - t1
    bad_bytes = sum(not np.array_equal(
        np.concatenate([p for p, _c in outs[i * SUBSHARDS:(i + 1) * SUBSHARDS]]),
        full[i, LOST_SLOT]) for i in range(n))
    bad_crcs = sum(c != int(crcs[i, LOST_SLOT]) for i, c in enumerate(stitched))
    log(f"[8] repair path, after warmup_repair: {len(jobs)} concurrent repair calls ({n} lost "
        f"{SHARD_BYTES >> 10} KiB chunks of slot {LOST_SLOT} x {SUBSHARDS} "
        f"sub-shards of {sub >> 10} KiB over helpers {slots}, coeffs {coeffs}): "
        f"{flushes} flushes, {groups} groups, launches={launches}, wall "
        f"{wall:.3f} s; {n * (SUBSHARDS - 1)} crc32c_combine stitches took "
        f"{stitch_s * 1e3:.1f} ms; wrong chunks {bad_bytes}, wrong stitched "
        f"CRCs {bad_crcs}")
    expect(bad_bytes == 0 and bad_crcs == 0, "repairs disagree")

    # LRC local parities of a write: the all-ones program at the full chunk
    lrc = [(0, 1, 2), (3, 4, 5), (6, 7), (8, 9)]          # local_groups(), size 3
    stripes = STRIPES
    jobs = [(i, grp) for i in range(stripes) for grp in lrc]
    cc.reset_launches()
    t0 = time.perf_counter()
    louts = await asyncio.gather(*(
        codec.repair(np.ascontiguousarray(full[i, list(grp)]), (1,) * len(grp), K, M)
        for i, grp in jobs))
    lwall = time.perf_counter() - t0
    for name, v in cc.launches.items():
        launches[name] += v
    await codec.close()
    xors = np.stack([np.bitwise_xor.reduce(full[i, list(grp)], axis=0)
                     for i, grp in jobs])
    bad_lrc = sum(not np.array_equal(o, x) for (o, _c), x in zip(louts, xors))
    want_crc = plain_shard_crcs(xors[None], dev)[0]
    bad_lrc_crc = sum(int(c) != int(w) for (_o, c), w in zip(louts, want_crc))
    log(f"[8] LRC local-parity encodes: {len(jobs)} concurrent repair(rows, "
        f"(1,)*g) at {SHARD_BYTES >> 10} KiB (groups {lrc}), wall {lwall:.3f} s; "
        f"codec_counts={codec.codec_counts}; wrong parities {bad_lrc}, wrong "
        f"CRCs {bad_lrc_crc}")
    expect(bad_lrc == 0 and bad_lrc_crc == 0, "LRC local parities disagree")
    expect_routes(codec, ("cuda-repair-words",))
    expect(launches["repair_words"] > 0 and launches["crc_words"] > 0,
           "repair must launch B4 and B1")
    return launches


# --- phase 9: non-RAID-6 reconstruct ----------------------------------------

async def phase_nonraid6(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rs63 = default_rs(K63, M63)
    data = torch.randint(0, 256, (STRIPES, K63, SHARD_BYTES), dtype=torch.uint8,
                         device=dev, generator=g)
    # parity by the plain PyTorch bit-matmul, independent of B5
    parity = make_rs_encode_matmul(rs63, dev)(data)
    full = torch.cat([data, parity], dim=1).cpu().numpy()
    del data, parity
    present = present_of(LOST63, K63 + M63, K63)
    codec = TorchECCodec(device=dev)
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(
        codec.reconstruct(np.ascontiguousarray(f[list(present)]), present, LOST63,
                          K63, M63) for f in full))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()
    bad = sum(not np.array_equal(o, f[list(LOST63)]) for o, f in zip(outs, full))
    log(f"[9] non-RAID-6 reconstruct: {len(outs)} concurrent RS({K63}+{M63}) "
        f"reconstruct at {SHARD_BYTES >> 10} KiB shards, want={LOST63}: "
        f"{codec.batches} groups, codec_counts={codec.codec_counts}, "
        f"launches={launches}, wall {wall:.3f} s; wrong stripes {bad}")
    expect(bad == 0, "RS(6+3) reconstruct disagrees")
    expect_routes(codec, ("cuda-bitmatmul",))
    expect(launches["rs_bitmatmul"] > 0, "RS(6+3) reconstruct must launch B5")
    return launches


# --- phase 10: read-side times ----------------------------------------------

def phase_read_times(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.repair_program import schedule_repair_program, single_row_program
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import (
        codec_tables, decode_tables, encode_map_tables, repair_tables)

    rs = default_rs(K, M)
    out = {}
    W = SHARD_BYTES // 4
    words = rand_words(g, dev, STRIPES, K, W)
    tcrc = codec_tables(W // 128, device=dev)
    for want in B3_WANTS:
        present = present_of(want, K + M, K)
        dec = decode_tables(present, want, rs, dev)
        out[f"rs_reconstruct_words want={want}"] = {
            **kernel_times(lambda: cc.rs_reconstruct_words(words, dec)),
            "plain_ms": time_ms(lambda: cc.rs_reconstruct_words_plain(words, dec), 5),
            "bound_ms": (K + len(want)) * W * 4 * STRIPES / HBM_BYTES_PER_S * 1e3,
            "shape": f"({STRIPES}, {K}, {W}) -> ({STRIPES}, {len(want)}, {W})",
        }
    present, want = present_of((0, 9), K + M, K), (0, 9)
    step = cc.make_stripe_decode_step_words(W, present, want, K, M, device=dev)
    dec = decode_tables(present, want, rs, dev)

    def plain_decode_step():
        reb = cc.rs_reconstruct_words_plain(words, dec)
        cc.crc_words_raw_plain(words.reshape(STRIPES * K, W), tcrc)
        cc.crc_words_raw_plain(reb.reshape(STRIPES * 2, W), tcrc)

    out["decode_step want=(0, 9)"] = {
        **kernel_times(lambda: step(words)),
        "plain_ms": time_ms(plain_decode_step, 2, 1),
        "bound_ms": (K + 2) * W * 4 * STRIPES / HBM_BYTES_PER_S * 1e3,
        "shape": f"({STRIPES}, {K}, {W})",
    }
    # the step's time from the host against its time on the card alone
    out["decode_step want=(0, 9), CUDA graph"] = {
        **out["decode_step want=(0, 9)"], **graph_kernel_times(lambda: step(words)),
    }
    del words

    hw = SHARD_BYTES // SUBSHARDS // 4
    rows = LOST_CHUNKS * SUBSHARDS
    helpers = rand_words(g, dev, rows, K, hw)
    _slots, coeffs = repair_plan(LOST_SLOT)
    main_prog = schedule_repair_program(coeffs)
    for label, prog in (("slot 3, XOR fold", main_prog),
                        ("slot 9, Horner", single_row_program(
                            rs, present_of((9,), K + M, K), 9))):
        rep = repair_tables(prog, rs)
        out[f"repair_words {label}"] = {
            **kernel_times(lambda: cc.repair_words(helpers, rep)),
            "plain_ms": time_ms(lambda: cc.repair_words_plain(helpers, rep), 5),
            "bound_ms": (K + 1) * hw * 4 * rows / HBM_BYTES_PER_S * 1e3,
            "shape": f"({rows}, {K}, {hw}) -> ({rows}, {hw})",
        }
    rstep = cc.make_repair_step_words(hw, main_prog, device=dev)
    trep = codec_tables(hw // 128, device=dev)
    rep = repair_tables(main_prog, rs)

    def plain_repair_step():
        cc.crc_words_raw_plain(cc.repair_words_plain(helpers, rep), trep)

    out["repair_step slot 3"] = {
        **kernel_times(lambda: rstep(helpers)),
        "plain_ms": time_ms(plain_repair_step, 2, 1),
        "bound_ms": (K + 1) * hw * 4 * rows / HBM_BYTES_PER_S * 1e3,
        "shape": f"({rows}, {K}, {hw})",
    }
    del helpers

    rs63 = default_rs(K63, M63)
    shards = torch.randint(0, 256, (STRIPES, K63, SHARD_BYTES), dtype=torch.uint8,
                           device=dev, generator=g)
    for label, gmap in (
            (f"decode want={LOST63}", decode_tables(
                present_of(LOST63, K63 + M63, K63), LOST63, rs63, dev)),
            ("encode", encode_map_tables(rs63, dev))):
        out[f"rs_bitmatmul RS(6+3) {label}"] = {
            **kernel_times(lambda: cc.rs_bitmatmul(shards, gmap)),
            "plain_ms": time_ms(lambda: cc.rs_bitmatmul_plain(shards, gmap), 2, 1),
            "bound_ms": (K63 + gmap.rows) * SHARD_BYTES * STRIPES / HBM_BYTES_PER_S * 1e3,
            "shape": f"({STRIPES}, {K63}, {SHARD_BYTES}) -> ({STRIPES}, {gmap.rows}, "
                     f"{SHARD_BYTES}) u8",
        }
    log_times(10, out)
    return out


# --- phase 11: B6 and the byte steps against plain ----------------------------

def plain_crc_bytes(rows: torch.Tensor, group: int = 16) -> torch.Tensor:
    """(n, L) uint8 -> (n,) int32 CRC32C by the plain version of B6, in
    groups of rows (it expands every byte to 8 floats)."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import default_matrices
    from t3fs_torch.ops.tables import crc_bytes_tables, crc_nseg
    from t3fs_torch.ops.torch_codec import i32

    L = rows.shape[1]
    tables = crc_bytes_tables(crc_nseg(L), rows.device)
    raw = torch.cat([cc.crc_bytes_raw_plain(part, tables) for part in rows.split(group)])
    return raw ^ i32(default_matrices().affine_const(L))


def rand_bytes(g: torch.Generator, dev: torch.device, *shape: int) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)


def phase_crc_bytes(dev: torch.device, g: torch.Generator) -> int:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import (
        crc_bytes_tables, crc_nseg, decode_tables, encode_map_tables)

    errs = {}
    t1 = crc_bytes_tables(1, dev)
    segs = rand_bytes(g, dev, 4096, 512)
    errs["seg"] = max_abs_err(cc.crc_seg_bytes(segs, t1), cc.crc_seg_bytes_plain(segs, t1))
    log(f"[11] crc_seg_bytes (4096, 512): max_abs_err={errs['seg']}")
    subset = sorted({0, CHUNKS // 3, CHUNKS - 1})
    for L in (CHUNK_BYTES, CHUNK_BYTES - 5, ODD_CHUNK):
        rows = rand_bytes(g, dev, CHUNKS, L)
        tables = crc_bytes_tables(crc_nseg(L), dev)
        e = max_abs_err(cc.crc_bytes_raw(rows, tables)[subset],
                        cc.crc_bytes_raw_plain(rows[subset], tables))
        log(f"[11] crc_bytes_raw ({CHUNKS}, {L}): max_abs_err={e} on rows {subset} "
            f"(row r starts at byte r * {L}{': unaligned' if L % 16 else ''}; "
            f"runs a row: {cc.crc_bytes_runs(crc_nseg(L))}, the first of "
            f"{crc_nseg(L) % 16 or 16} segments)")
        errs[L] = e
    # rows at every offset 0..15 from a 16-byte boundary: views into one buffer
    L = ODD_CHUNK
    tables = crc_bytes_tables(crc_nseg(L), dev)
    flat = rand_bytes(g, dev, 4 * L + 16)
    e = 0
    for off in range(16):
        view = flat[off:off + 4 * L].view(4, L)
        e = max(e, max_abs_err(cc.crc_bytes_raw(view, tables),
                               cc.crc_bytes_raw_plain(view.contiguous(), tables)))
    log(f"[11] crc_bytes_raw (4, {L}) views at base offsets 0..15: max_abs_err={e}")
    errs["offsets"] = e
    del flat, rows
    rng = np.random.default_rng(SEED + 11)
    for n in (1, 9, 513, (129 << 10) + 3):
        p = rng.bytes(n)
        row = torch.frombuffer(bytearray(p), dtype=torch.uint8).reshape(1, n).to(dev)
        crc = int(u32(cc.make_crc32c_bytes(n, dev)(row)).item())
        errs[n] = abs(crc - crc32c_ref(p))
        log(f"[11] crc32c of {n} bytes: {crc:#010x}, crc32c_ref {crc32c_ref(p):#010x}")

    rs63 = default_rs(K63, M63)
    n, L = STRIPES, SHARD_BYTES
    shards = rand_bytes(g, dev, n, K63, L)
    parity, crcs = cc.make_stripe_encode_step_fast(L, K63, M63, dev)(shards)
    plain_par = cc.rs_bitmatmul_plain(shards, encode_map_tables(rs63, dev))
    plain_crc = torch.cat([plain_crc_bytes(shards.reshape(n * K63, L)).reshape(n, K63),
                           plain_crc_bytes(plain_par.reshape(n * M63, L)).reshape(n, M63)],
                          dim=1)
    errs["encode step"] = max(max_abs_err(parity, plain_par), max_abs_err(crcs, plain_crc))
    present = present_of(LOST63, K63 + M63, K63)
    full = torch.cat([shards, parity], dim=1)
    rows = full[:, list(present)].contiguous()
    rebuilt, dcrcs = cc.make_stripe_decode_step_bytes(L, present, LOST63, K63, M63, dev)(rows)
    plain_reb = cc.rs_bitmatmul_plain(rows, decode_tables(present, LOST63, rs63, dev))
    want_crc = plain_crc[:, list(present + LOST63)]
    errs["decode step"] = max(max_abs_err(rebuilt, plain_reb),
                              max_abs_err(rebuilt, full[:, list(LOST63)]),
                              max_abs_err(dcrcs, want_crc))
    log(f"[11] byte steps RS({K63}+{M63}) at ({n}, {K63}, {L}): encode (B5 + B6) and "
        f"decode want={LOST63} (B5 + B6) against plain: max_abs_err "
        f"{errs['encode step']} / {errs['decode step']}")
    worst = max(errs.values())
    expect(worst == 0, f"B6 or a byte step disagrees with plain: {errs}")
    return worst


# --- phase 12: the byte-path EC routes --------------------------------------

def add_launches(total: dict, part: dict) -> None:
    for name, v in part.items():
        total[name] = total.get(name, 0) + v


async def phase_byte_routes(dev: torch.device) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.codec import crc32c_combine
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rng = np.random.default_rng(SEED + 12)
    codec = TorchECCodec(device=dev)
    total: dict[str, int] = {}

    async def run(label: str, calls):
        cc.reset_launches()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*calls)
        wall = time.perf_counter() - t0
        launches = dict(cc.launches)
        add_launches(total, launches)
        log(f"[12] {label}: wall {wall:.3f} s (first call's table build included), "
            f"launches={launches}")
        return outs, launches

    # RS(6+3) stripe writes: B5 + B6
    data = [rng.integers(0, 256, (K63, SHARD_BYTES), dtype=np.uint8) for _ in range(24)]
    outs, launches = await run(f"24 concurrent encode_verified RS({K63}+{M63}) at "
                               f"{SHARD_BYTES >> 10} KiB",
                               [codec.encode_verified(d, K63, M63) for d in data])
    expect(launches["rs_bitmatmul"] > 0 and launches["crc_bytes"] > 0,
           "RS(6+3) writes must launch B5 and B6")
    full63 = np.stack([np.concatenate([d, o[0]]) for d, o in zip(data, outs)])
    enc = make_rs_encode_matmul(default_rs(K63, M63), dev)      # independent of B5
    want_par = torch.cat([enc(torch.from_numpy(full63[i:i + 4, :K63]).to(dev)).cpu()
                          for i in range(0, len(data), 4)]).numpy()
    crcs63 = plain_shard_crcs(full63, dev)                      # plain B1
    bad_par = int((full63[:, K63:] != want_par).any(axis=(1, 2)).sum())
    bad_crc = sum(not np.array_equal(o[1], c) for o, c in zip(outs, crcs63))
    log(f"[12] RS({K63}+{M63}) writes: wrong parity stripes {bad_par}, wrong CRC "
        f"rows {bad_crc} (parity by the plain bit-matmul, CRCs by plain B1)")
    expect(bad_par == 0 and bad_crc == 0, "RS(6+3) writes disagree")

    # RS(6+3) degraded reads losing three shards: B5 + B6
    present = present_of(LOST63, K63 + M63, K63)
    reqs = list(range(12))
    outs, launches = await run(
        f"12 concurrent reconstruct_verified RS({K63}+{M63}) want={LOST63}",
        [codec.reconstruct_verified(np.ascontiguousarray(full63[i, list(present)]),
                                    present, LOST63, K63, M63) for i in reqs])
    expect(launches["rs_bitmatmul"] > 0 and launches["crc_bytes"] > 0,
           "RS(6+3) reads must launch B5 and B6")
    bad = sum(not (np.array_equal(r, full63[i, list(LOST63)])
                   and np.array_equal(c, crcs63[i, list(present + LOST63)]))
              for i, (r, c) in zip(reqs, outs))
    log(f"[12] RS({K63}+{M63}) degraded reads: wrong stripes or CRC rows {bad}")
    expect(bad == 0, "RS(6+3) degraded reads disagree")

    # RAID-6 writes at a length that is not whole segments: B2 + B6
    L6 = ODD_CHUNK
    data = [rng.integers(0, 256, (K, L6), dtype=np.uint8) for _ in range(STRIPES)]
    outs, launches = await run(f"{STRIPES} concurrent encode_verified RS({K}+{M}) at "
                               f"{L6} bytes",
                               [codec.encode_verified(d, K, M) for d in data])
    expect(launches["rs_raid6_words"] > 0 and launches["crc_bytes"] > 0,
           "RAID-6 writes at odd lengths must launch B2 and B6")
    full6 = np.stack([np.concatenate([d, o[0]]) for d, o in zip(data, outs)])
    words = torch.from_numpy(full6[:, :K].copy().view(np.int32)).to(dev)
    from t3fs_torch.ops.tables import codec_tables

    want_par = cc.rs_raid6_words_plain(words, codec_tables(1, K, M, device=dev))
    bad_par = max_abs_err(torch.from_numpy(full6[:, K:].copy().view(np.int32)).to(dev),
                          want_par)
    crcs6 = plain_crc_bytes(torch.from_numpy(full6).to(dev).reshape(-1, L6)
                            ).cpu().numpy().view(np.uint32).reshape(STRIPES, K + M)
    bad_crc = sum(not np.array_equal(o[1], c) for o, c in zip(outs, crcs6))
    log(f"[12] RAID-6 writes at {L6} bytes: parity max_abs_err={bad_par} (plain B2), "
        f"wrong CRC rows {bad_crc} (plain B6)")
    expect(bad_par == 0 and bad_crc == 0, "RAID-6 odd-length writes disagree")

    # repair at sub-shards that are not whole segments: B4 + B6
    slots, coeffs = repair_plan(LOST_SLOT)
    sub = L6 // SUBSHARDS
    chunks = STRIPES // 2                  # 6 chunks x 4 sub-shards: 24 calls
    jobs = [np.ascontiguousarray(full6[i, slots, q * sub:(q + 1) * sub])
            for i in range(chunks) for q in range(SUBSHARDS)]
    outs, launches = await run(f"{len(jobs)} repair calls at {sub}-byte sub-shards "
                               f"of slot {LOST_SLOT}",
                               [codec.repair(rows, coeffs, K, M) for rows in jobs])
    expect(launches["repair_words"] > 0 and launches["crc_bytes"] > 0,
           "odd-length repair must launch B4 and B6")
    bad = 0
    for i in range(chunks):
        parts = outs[i * SUBSHARDS:(i + 1) * SUBSHARDS]
        crc = int(parts[0][1])
        for _p, c in parts[1:]:
            crc = crc32c_combine(crc, int(c), sub)
        ok = (np.array_equal(np.concatenate([p for p, _c in parts]), full6[i, LOST_SLOT])
              and crc == int(crcs6[i, LOST_SLOT]))
        bad += not ok
    log(f"[12] odd-length repair: wrong chunks or stitched CRCs {bad}; "
        f"codec_counts={codec.codec_counts}")
    expect(bad == 0, "odd-length repairs disagree")
    await codec.close()
    expect_routes(codec, ("cuda-encode-bytes", "cuda-decode-bytes",
                          "cuda-repair-words-odd"))
    return total


# --- phase 13: PM-MSR -------------------------------------------------------

async def phase_msr(dev: torch.device) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.msr import default_msr

    code = default_msr(K, M)
    L = SHARD_BYTES
    sub = L // code.alpha
    rng = np.random.default_rng(SEED + 13)
    data = [rng.integers(0, 256, (K, L), dtype=np.uint8) for _ in range(24)]
    codec = TorchECCodec(device=dev)
    codec.warmup_msr([LOST_SLOT], L, K, M, batch_sizes=(24,))
    total: dict[str, int] = {}

    async def run(label: str, calls):
        cc.reset_launches()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*calls)
        wall = time.perf_counter() - t0
        launches = dict(cc.launches)
        add_launches(total, launches)
        log(f"[13] {label}: wall {wall:.3f} s, launches={launches}")
        return outs, launches

    outs, launches = await run(f"24 concurrent msr_encode_verified RS({K}+{M}) pm-msr "
                               f"at {L >> 10} KiB (after warmup_msr)",
                               [codec.msr_encode_verified(d, K, M) for d in data])
    expect(launches["rs_raid6_words"] > 0 and launches["crc_words"] > 0,
           "pm-msr writes must launch B2 and B1")
    stored = np.stack([np.concatenate([d, o[0]]) for d, o in zip(data, outs)])
    crcs = plain_shard_crcs(stored, dev)                          # plain B1
    bad_crc = sum(not np.array_equal(o[1], c) for o, c in zip(outs, crcs))
    expect(np.array_equal(outs[0][0], code.encode_np(data[0])),
           "pm-msr stripe 0 parity != encode_np")
    log(f"[13] pm-msr writes: stripe 0 parity == encode_np; wrong CRC rows {bad_crc}")
    expect(bad_crc == 0, "pm-msr write CRCs disagree")

    sch = code.schedule(LOST_SLOT)
    helpers = [np.ascontiguousarray(
        stored[i, list(sch.helpers)].reshape(code.d, code.alpha, sub)[:, list(sch.selected)]
        .reshape(code.d, -1)) for i in range(len(data))]
    outs, launches = await run(f"{len(helpers)} msr_repair of slot {LOST_SLOT} over "
                               f"({code.d}, {helpers[0].shape[1] >> 10} KiB) helpers",
                               [codec.msr_repair(h, LOST_SLOT, K, M) for h in helpers])
    expect(launches["repair_words"] > 0 and launches["crc_words"] > 0,
           "pm-msr repair must launch B4 and B1")
    expect(np.array_equal(outs[0][0], code.repair_np(
        LOST_SLOT, helpers[0].reshape(code.d, sch.npl, sub))), "repair 0 != repair_np")
    bad = sum(not (np.array_equal(o, stored[i, LOST_SLOT]) and int(c) == int(crcs[i, LOST_SLOT]))
              for i, (o, c) in enumerate(outs))
    log(f"[13] pm-msr repair: chunk 0 == repair_np; wrong chunks or CRCs {bad} "
        "(every chunk against the stored shard, which parity errors would break)")
    expect(bad == 0, "pm-msr repairs disagree")

    jobs = [(i, MSR_LOSSES[i % len(MSR_LOSSES)]) for i in range(6)]
    outs, launches = await run(
        f"6 msr_decode_verified losing {MSR_LOSSES}",
        [codec.msr_decode_verified(np.ascontiguousarray(stored[i, list(present_of(lost, K + M, K))]),
                                   present_of(lost, K + M, K), lost, K, M)
         for i, lost in jobs])
    expect(launches["crc_words"] > 0, "pm-msr decode must launch B1")
    p0 = present_of(MSR_LOSSES[0], K + M, K)
    expect(np.array_equal(outs[0][0], code.decode_np(p0, stored[0, list(p0)], MSR_LOSSES[0])),
           "decode 0 != decode_np")
    bad = sum(not (np.array_equal(r, stored[i, list(lost)])
                   and np.array_equal(c, crcs[i, list(present_of(lost, K + M, K) + lost)]))
              for (i, lost), (r, c) in zip(jobs, outs))
    log(f"[13] pm-msr decode: stripe 0 == decode_np; wrong stripes or CRC rows {bad}; "
        f"codec_counts={codec.codec_counts}")
    expect(bad == 0, "pm-msr decodes disagree")
    await codec.close()
    expect_routes(codec, ("cuda-msr-encode", "cuda-msr-repair", "cuda-msr-decode"))
    return total


# --- phase 17: codes past one kernel launch ----------------------------------

# RAID-6 at k = 40 and k = 254 (the most RAID-6 takes), RS(12+12) and
# RS(28+8): B3 past k = 32 runs B5, B5 past 8 output shards or 227 KiB of
# tables runs as several tiles, B4 past 32 helpers as several groups.  Shards
# of 1 MiB, 256 KiB at k = 254 (a 64 MiB stripe).
BIG_CODES = ((40, 2, SHARD_BYTES), (254, 2, SHARD_BYTES // 4),
             (12, 12, SHARD_BYTES), (28, 8, SHARD_BYTES))
# a data shard lost, then two shards (data and parity, or two data)
BIG_LOSSES = {(40, 2): ((5,), (0, 41)), (254, 2): ((200,), (3, 254)),
              (12, 12): ((11,), (0, 13)), (28, 8): ((27,), (4, 30))}


def phase_big_kernels(dev: torch.device, g: torch.Generator) -> dict[str, int]:
    """B5's tiles (RAID-6 k = 254 decode: two input groups; RS(12+12)
    encode: two row groups; RS(28+8) decode: one 56 KiB tile), B3's wrapper
    at k = 40 (B5 on the byte view) and B4 over 40 helpers (two groups)
    against their plain versions, at 2 stripes of 64 KiB shards."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.repair_program import schedule_repair_program
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import decode_tables, encode_map_tables, repair_tables

    L = 64 << 10
    errs = {"rs_bitmatmul": 0, "repair_words": 0}
    for label, gmap in (
            ("RAID-6 k=254 decode want=(2, 255)", decode_tables(
                (0, 1, *range(3, 255)), (2, 255), default_rs(254, 2), dev)),
            ("RS(12+12) encode", encode_map_tables(default_rs(12, 12), dev)),
            ("RS(28+8) decode of 8", decode_tables(
                tuple(range(4, 32)), (0, 1, 2, 3, 32, 33, 34, 35), default_rs(28, 8), dev))):
        shards = rand_bytes(g, dev, 2, gmap.k, L)
        e = max_abs_err(cc.rs_bitmatmul(shards, gmap), cc.rs_bitmatmul_plain(shards, gmap))
        log(f"[17] rs_bitmatmul {label} in {len(gmap.tiles)} tile(s) at (2, {gmap.k}, {L}): "
            f"max_abs_err={e}")
        errs["rs_bitmatmul"] = max(errs["rs_bitmatmul"], e)
    rs = default_rs(40, 2)
    present = (*range(1, 40), 41)
    dec = decode_tables((*range(1, 39), 40, 41), (0, 39), rs, dev)
    words = rand_words(g, dev, 2, 40, L // 4)
    e = max_abs_err(cc.rs_reconstruct_words(words, dec),
                    cc.rs_reconstruct_words_plain(words, dec))
    log(f"[17] rs_reconstruct_words RAID-6 k=40 (B5 on the byte view) at (2, 40, "
        f"{L // 4}): max_abs_err={e}")
    errs["rs_bitmatmul"] = max(errs["rs_bitmatmul"], e)
    row = rs.reconstruct_gfmatrix(list(present), [0])[0]
    rep = repair_tables(schedule_repair_program(tuple(int(c) for c in row)), rs)
    e = max_abs_err(cc.repair_words(words, rep), cc.repair_words_plain(words, rep))
    log(f"[17] repair_words over 40 helpers in {len(rep.groups)} groups at (2, 40, "
        f"{L // 4}): max_abs_err={e}")
    errs["repair_words"] = e
    expect(max(errs.values()) == 0, f"tiled B5 / grouped B4 disagree with plain: {errs}")
    return errs


async def phase_big_codes(dev: torch.device) -> dict:
    """The EC routes at the codes of BIG_CODES: encode_verified, reconstruct
    and reconstruct_verified of one and two lost shards, and at RAID-6 k =
    40 a repair over 40 helpers; 2 stripes a code.  Parity against the plain
    PyTorch bit-matmul (its first 64 KiB of stripe 0 against
    RSCode.encode_ref), every rebuilt shard against the stripe, every CRC
    against plain B1."""
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rng = np.random.default_rng(SEED + 17)
    codec = TorchECCodec(device=dev)
    stripes = {}
    for k, m, L in BIG_CODES:
        data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
        parity = make_rs_encode_matmul(default_rs(k, m), dev)(
            torch.from_numpy(data).to(dev)).cpu().numpy()
        head = 64 << 10           # byte positions are independent: RSCode on a slice
        expect(np.array_equal(parity[0, :, :head],
                              default_rs(k, m).encode_ref(data[0, :, :head])),
               f"RS({k}+{m}) stripe 0: plain bit-matmul != RSCode.encode_ref")
        full = np.concatenate([data, parity], axis=1)
        stripes[k, m] = (full, plain_shard_crcs(full, dev))
    rs40 = default_rs(40, 2)
    helpers = (*range(1, 40), 41)
    coeffs = tuple(int(c) for c in rs40.reconstruct_gfmatrix(list(helpers), [0])[0])

    calls, checks = [], []
    for (k, m), (full, crcs) in stripes.items():
        for i in range(2):
            calls.append(codec.encode_verified(full[i, :k], k, m))
            checks.append((full[i, k:], crcs[i]))
            for lost in BIG_LOSSES[k, m]:
                present = present_of(lost, k + m, k)
                rows = np.ascontiguousarray(full[i, list(present)])
                calls.append(codec.reconstruct_verified(rows, present, lost, k, m))
                checks.append((full[i, list(lost)], crcs[i, list(present + lost)]))
                calls.append(codec.reconstruct(rows, present, lost, k, m))
                checks.append((full[i, list(lost)], None))
            if (k, m) == (40, 2):
                calls.append(codec.repair(np.ascontiguousarray(full[i, list(helpers)]),
                                          coeffs, k, m))
                checks.append((full[i, 0], crcs[i, 0]))
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*calls)
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()
    bad = 0
    for out, (want, want_crc) in zip(outs, checks):
        got, crc = (out, None) if want_crc is None else out
        bad += not np.array_equal(got, want)
        if want_crc is not None:
            bad += not np.array_equal(np.asarray(crc, dtype=np.uint32), want_crc)
    log(f"[17] codes past one launch, RAID-6 k=40 and k=254, RS(12+12), RS(28+8): "
        f"{len(calls)} concurrent calls, {codec.batches} groups, codec_counts="
        f"{codec.codec_counts}, launches={launches}, wall {wall:.3f} s (first use of "
        f"each code's tables included); wrong results {bad}")
    expect(bad == 0, "codes past one launch disagree")
    expect_routes(codec, ("cuda-encode-words", "cuda-decode-words", "cuda-rec-words",
                          "cuda-repair-words", "cuda-encode-bytes", "cuda-decode-bytes",
                          "cuda-bitmatmul"))
    expect(launches["rs_bitmatmul"] > 0 and launches["repair_words"] > 0
           and launches["crc_words"] > 0 and launches["crc_bytes"] > 0,
           "codes past one launch must launch B5, B4, B1 and B6")
    return launches


# --- phase 14: byte-path and PM-MSR times -----------------------------------

def phase_byte_times(dev: torch.device, g: torch.Generator, b1: dict) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops import msr_codec as mc
    from t3fs_torch.ops.msr import default_msr
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import crc_bytes_tables, crc_nseg, encode_map_tables

    out = {}
    for label, L in B6_SHAPES:
        rows = rand_bytes(g, dev, CHUNKS, L)
        tables = crc_bytes_tables(crc_nseg(L), dev)
        out[f"crc_bytes {label}"] = {
            **kernel_times(lambda: cc.crc_bytes_raw(rows, tables)),
            "plain_ms": time_ms(lambda: cc.crc_bytes_raw_plain(rows, tables), 2, 1),
            "bound_ms": (rows.numel() + 4 * CHUNKS) / HBM_BYTES_PER_S * 1e3,
            "shape": f"({CHUNKS}, {L}) u8",
        }
        del rows
    log(f"[14] B1 (crc_words) at the bytes of 64 x 4 MiB, from phase 5: "
        f"{b1['ms'] * 1e3:.1f} us")

    rs63 = default_rs(K63, M63)
    shards = rand_bytes(g, dev, STRIPES, K63, SHARD_BYTES)
    step = cc.make_stripe_encode_step_fast(SHARD_BYTES, K63, M63, dev)
    enc = encode_map_tables(rs63, dev)

    def plain_step():
        par = cc.rs_bitmatmul_plain(shards, enc)
        plain_crc_bytes(shards.reshape(-1, SHARD_BYTES), group=1 << 30)
        plain_crc_bytes(par.reshape(-1, SHARD_BYTES), group=1 << 30)

    out[f"byte encode step RS({K63}+{M63})"] = {
        **kernel_times(lambda: step(shards)),
        "plain_ms": time_ms(plain_step, 2, 1),
        "bound_ms": (K63 + M63) * SHARD_BYTES * STRIPES / HBM_BYTES_PER_S * 1e3,
        "shape": f"({STRIPES}, {K63}, {SHARD_BYTES}) u8",
    }
    # its launches called from the host can outlast the card's work: the
    # same step replayed from a CUDA graph
    out[f"byte encode step RS({K63}+{M63}), CUDA graph"] = {
        **out[f"byte encode step RS({K63}+{M63})"],
        **graph_kernel_times(lambda: step(shards)),
    }
    del shards

    code = default_msr(K, M)
    n, beta_len = 24, SHARD_BYTES // 2
    helpers = rand_bytes(g, dev, n, code.d, beta_len)
    step = mc.make_msr_repair_step(code, LOST_SLOT, SHARD_BYTES, dev)

    def plain_rows(chunk_len, device):
        from t3fs_torch.ops.tables import codec_tables
        from t3fs_torch.ops.torch_codec import i32

        t = codec_tables(chunk_len // 512, device=device)
        return lambda r: cc.crc_words_raw_plain(r.view(torch.int32), t) ^ i32(t.chunk_affine)

    def with_plain_kernels(fn):
        """Run fn with the step's B4 and B1 swapped for their plain versions."""
        kernels = (cc.repair_words, mc.make_crc32c_rows)
        cc.repair_words, mc.make_crc32c_rows = cc.repair_words_plain, plain_rows
        try:
            return fn()
        finally:
            cc.repair_words, mc.make_crc32c_rows = kernels

    plain = with_plain_kernels(
        lambda: mc.make_msr_repair_step(code, LOST_SLOT, SHARD_BYTES, dev))
    out[f"msr repair step slot {LOST_SLOT}"] = {
        **kernel_times(lambda: step(helpers)),
        "plain_ms": time_ms(lambda: with_plain_kernels(lambda: plain(helpers)), 2, 1),
        "bound_ms": n * (code.d * beta_len + SHARD_BYTES) / HBM_BYTES_PER_S * 1e3,
        "shape": f"({n}, {code.d}, {beta_len}) u8 -> ({n}, {SHARD_BYTES})",
    }
    log_times(14, out)
    return out


# --- phase 16: H1, the headline bench and the decode bench -------------------

def run_captured(main, argv: list[str], phase: int = 16) -> tuple[int, list[str]]:
    """A bench's main(argv) in this process: its lines echoed under the
    phase's tag, its exit code and its lines returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"[{phase}] {line}")
    return rc, lines


def h1_against_add(x: torch.Tensor) -> float:
    """H1 against torch.add(x, 1) where the card's clocks cannot drift
    between the two: 20 calls of each captured in a CUDA graph, replayed in
    turns H1, add, H1, add, ...  Returns H1's median over torch.add's."""
    from t3fs_torch.benchmarks import devbench as db

    pair = db.interleaved_graph_samples(
        {"H1": lambda: db.make_copy3d(x), "torch.add": lambda: torch.add(x, 1)},
        20, 2 * REPEATS)
    med = {name: v[len(v) // 2] for name, v in pair.items()}
    ratio = med["H1"] / med["torch.add"]
    log(f"[16] copy3d against torch.add, interleaved CUDA-graph replays of 20 "
        f"calls, {2 * REPEATS} samples each: H1 {med['H1'] * 1e3:.2f} us (min "
        f"{pair['H1'][0] * 1e3:.2f}, max {pair['H1'][-1] * 1e3:.2f}), torch.add "
        f"{med['torch.add'] * 1e3:.2f} us (min {pair['torch.add'][0] * 1e3:.2f}, "
        f"max {pair['torch.add'][-1] * 1e3:.2f}); H1 / torch.add {ratio:.4f}")
    return ratio


def phase_bench(dev: torch.device, g: torch.Generator) -> tuple[int, dict, dict]:
    from t3fs_torch import bench
    from t3fs_torch.benchmarks import devbench as db
    from t3fs_torch.benchmarks import ec_recovery_bench as ecb
    from t3fs_torch.ops import cuda_codec as cc

    x = rand_words(g, dev, STRIPES, K, SHARD_BYTES // 4)
    x.view(-1)[:2] = torch.tensor([-1, 2**31 - 1], dtype=torch.int32, device=dev)
    ragged = rand_words(g, dev, 3, 5, 1001)
    unaligned = rand_words(g, dev, 3 * 5 * 1001 + 1)[1:].view(3, 5, 1001)
    e = 0
    for label, t in (("the bench's shape, with both wraps", x), ("ragged", ragged),
                     ("ragged, 4 bytes off alignment", unaligned),
                     ("one vector and a tail", rand_words(g, dev, 1, 1, 7))):
        et = max_abs_err(db.make_copy3d(t), db.copy3d_plain(t))
        log(f"[16] copy3d {tuple(t.shape)} ({label}): max_abs_err={et}")
        e = max(e, et)
    expect(e == 0, f"H1 disagrees with its plain version (max_abs_err={e})")
    one = db.chained_timer(db.make_copy3d, x, 5)
    log(f"[16] a chained copy3d pass captured as a CUDA graph gives the eager "
        f"pass's acc; 5 iterations in {one() * 1e3:.3f} ms")

    nbytes = x.numel() * 4
    t = {**kernel_times(lambda: db.make_copy3d(x)),
         "plain_ms": kernel_times(lambda: db.copy3d_plain(x))["ms"],
         "library_ms": kernel_times(lambda: torch.add(x, 1))["ms"],
         "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"[16] copy3d ({STRIPES}, {K}, {SHARD_BYTES // 4}): {t['ms'] * 1e3:.1f} us, "
        f"median of {REPEATS} (min {t['min_ms'] * 1e3:.1f}, max {t['max_ms'] * 1e3:.1f}) "
        f"(bound {t['bound_ms'] * 1e3:.1f} us by bytes at 3.35 TB/s, "
        f"{t['bound_ms'] / t['ms'] * 100:.1f}% of it; {2 * nbytes / t['ms'] / 1e6:.1f} "
        f"GB/s r+w); plain {t['plain_ms'] * 1e3:.1f} us; library call torch.add "
        f"{t['library_ms'] * 1e3:.1f} us")
    h1_against_add(x)

    cc.reset_launches()
    db.reset_launches()
    rc, lines = run_captured(bench.main, ["--quick"])
    launches = {"copy3d": db.launches["copy3d"]}
    res = json.loads(lines[-1])
    log(f"[16] bench --quick: exit {rc}; its launches: copy3d {launches['copy3d']}, "
        f"codec {dict(cc.launches)}")
    expect(rc == 0 and res["value"] > 0, f"the bench failed: {lines[-1]}")
    expect(res["device"] == torch.cuda.get_device_name(0), "the bench line names no card")
    expect(launches["copy3d"] > 0, "the bench must launch H1")

    # the decode microbench alone (phase 27 runs the bench's cluster phases)
    micro = ecb.decode_microbench(ecb.parse_args(
        ["--chunk-size", str(SHARD_BYTES), "--decode-batch", str(STRIPES), "--decode-ab"]))
    log(f"[16] decode microbench: {json.dumps(micro)}")
    rates = {k: v for k, v in micro.items() if k.endswith("_GB_s")}
    expect(len(rates) == 3 and min(rates.values()) > 0,
           f"the decode bench gave no fused, word and byte-plane rates: {rates}")
    return e, t, launches


# --- phase 18: the device sort ------------------------------------------------

def phase_sort() -> None:
    from t3fs_torch.benchmarks import sort_bench as sb
    from t3fs_torch.ops.device_sort import KEY_LEN, lexsort_rows, make_device_sorter

    rows = sb.gensort_rows(SORT_RECORDS)
    res = sb.measure(rows)
    log(f"[18] device sort of {SORT_RECORDS} gensort rows (seed {sb.SEED}), "
        f"make_device_sorter and sort_columns both equal to lexsort_rows: sort "
        f"{res['sort_ms']:.3f} ms, median of 5 (bound {res['bound_ms']:.3f} ms by "
        f"bytes at 3.35 TB/s, {res['bound_ms'] / res['sort_ms'] * 100:.1f}% of it; "
        f"{res['records_per_s'] / 1e6:.1f} M records/s, {res['key_MB_s']:.0f} key "
        f"MB/s); H2D of the int64 columns {res['h2d_ms']:.3f} ms, D2H of the "
        f"permutation {res['d2h_ms']:.3f} ms; host: columns "
        f"{res['host_columns_ms']:.1f} ms, gather of the rows {res['gather_ms']:.1f} "
        f"ms, np.lexsort {res['lexsort_ms']:.1f} ms; make_device_sorter end to end "
        f"{res['sorter_wall_ms']:.1f} ms")
    sort_perm = make_device_sorter()
    ff = rows[:4096].copy()
    ff[::3, :KEY_LEN] = 0xFF
    for label, r in [(f"n={n}", rows[:n]) for n in (0, 1, 1023, 1025)] + [
            ("4096 rows, every third key all 0xFF", ff)]:
        perm = sort_perm(r)
        expect(perm.dtype == (np.int64 if len(r) == 0 else np.int32)
               and np.array_equal(perm, lexsort_rows(r)),
               f"the device sort differs from lexsort_rows at {label}")
    ff_rows = np.arange(0, len(ff), 3)
    expect(np.array_equal(sort_perm(ff)[-len(ff_rows):], ff_rows),
           "the all-0xFF keys must sort last, in row order")
    log("[18] n = 0, 1, 1023, 1025 and 4096 rows with all-0xFF keys: equal to "
        "lexsort_rows")
    del rows, ff
    rc, lines = run_captured(sb.main, ["--quick"], phase=18)
    expect(rc == 0 and json.loads(lines[-1])["perm_equals_lexsort"],
           f"the sort bench failed: {lines[-1]}")


# --- phase 19: the codec mesh ---------------------------------------------------

def phase_mesh(dev: torch.device) -> dict:
    """The 2 x 2 mesh (4 ranks) at the stripe bench's width, every output
    against the unsharded steps on the card, on graft_entry's backend for
    the box's card count; logs each rank's step times beside its kernels'
    and its CRC combine's alone; returns the ranks' summed launches of the
    counted run."""
    from t3fs_torch import graft_entry as ge
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rng = np.random.default_rng(SEED + 19)
    stripes = rng.integers(0, 256, (MESH_STRIPES, K, SHARD_BYTES), dtype=np.uint8)
    data63 = rng.integers(0, 256, (MESH_STRIPES, K63, SHARD_BYTES), dtype=np.uint8)
    W = SHARD_BYTES // 4
    x = torch.from_numpy(stripes.view(np.int32)).to(dev)
    parity, crcs = cc.make_stripe_encode_step_words(W, device=dev)(x)
    full = torch.cat([x, parity], dim=1)
    ref = {"parity": parity.cpu().numpy().view(np.uint32),
           "crcs": crcs.cpu().numpy().view(np.uint32)}
    for want in MESH_WANTS:
        present = ge.present_of(want, K, M)
        rebuilt, rcrcs = cc.make_stripe_decode_step_words(W, present, want, device=dev)(
            full[:, list(present)].contiguous())
        ref[want] = (rebuilt.cpu().numpy().view(np.uint8),
                     rcrcs[:, K:].cpu().numpy().view(np.uint32))
    d63 = torch.from_numpy(data63).to(dev)
    full63 = torch.cat([d63, make_rs_encode_matmul(default_rs(K63, M63), dev)(d63)],
                       dim=1)
    present63 = ge.present_of(ge.LOST63, K63, M63)
    surv63 = full63[:, list(present63)].contiguous()
    rebuilt63, c63 = cc.make_stripe_decode_step_bytes(
        SHARD_BYTES, present63, ge.LOST63, K63, M63, dev)(surv63)
    expect(torch.equal(rebuilt63, full63[:, list(ge.LOST63)]),
           "the unsharded RS(6+3) decode does not give back the lost shards")
    ref63 = (rebuilt63.cpu().numpy(), c63[:, K63:].cpu().numpy().view(np.uint32))
    surv63 = surv63.cpu().numpy()
    del x, parity, crcs, full, rebuilt, rcrcs, d63, full63, rebuilt63, c63
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = ge.run_mesh(MESH_RANKS, stripes, surv63, MESH_WANTS, dp=MESH_DP,
                      device=dev, timed=True, timeout_s=600)
    wall = time.perf_counter() - t0
    log(f"[19] mesh dp x cp = {res['dp']} x {res['cp']}, {MESH_STRIPES} x RS({K}+{M}) "
        f"stripes of {SHARD_BYTES >> 20} MiB shards: backend {res['backend']}, "
        f"{res['ranks_per_card']} rank(s) a card on {torch.cuda.device_count()} "
        f"card(s) in the box; spawn to join {wall:.1f} s")
    out = res["outputs"]
    pairs = [("enc_parity", ref["parity"].view(np.uint8)), ("enc_crcs", ref["crcs"]),
             ("wenc_parity", ref["parity"]), ("wenc_crcs", ref["crcs"]),
             ("wrec63", ref63[0]), ("wrec63_crcs", ref63[1])]
    for want in MESH_WANTS:
        t = ge.want_tag(want)
        pairs += [(f"rec{t}", ref[want][0]), (f"rec{t}_crcs", ref[want][1]),
                  (f"wrec{t}", ref[want][0]), (f"wrec{t}_crcs", ref[want][1])]
    for name, want_arr in pairs:
        expect(out[name].shape == want_arr.shape and np.array_equal(out[name], want_arr),
               f"mesh output {name} differs from the unsharded step on the card")
    spot = [(out["enc_crcs"][0, 0], stripes[0, 0]),
            (out["wenc_crcs"][-1, K + 1], out["enc_parity"][-1, 1]),
            (out[f"wrec{ge.want_tag(MESH_WANTS[0])}_crcs"][1, 0], stripes[1, MESH_WANTS[0][0]]),
            (out["wrec63_crcs"][0, 0], out["wrec63"][0, 0])]
    for crc, shard_bytes in spot:
        expect(int(crc) == crc32c_ref(shard_bytes.tobytes()), "a mesh CRC != crc32c_ref")
    log(f"[19] every parity byte, rebuilt byte and CRC of {len(pairs)} outputs (byte "
        f"and word encode; byte and word decode of want {', '.join(map(str, MESH_WANTS))}; "
        f"RS({K63}+{M63}) word decode of want {ge.LOST63}) equal to the unsharded "
        f"steps on the card; {len(spot)} CRCs equal to crc32c_ref")
    launches: dict[str, int] = {}
    for r, meta in enumerate(res["ranks"]):
        add_launches(launches, meta["launches"])
        log(f"[19] rank {r} (dp {meta['dp_index']}, cp {meta['cp_index']}) on "
            f"{meta['device']}, {res['backend']}, {res['ranks_per_card']} rank(s) a "
            f"card, ms a call (CUDA events, 5 calls): " + ", ".join(
                f"{name} {ms:.3f}" for name, ms in meta["ms"].items()))
    log(f"[19] the ranks' launches in the counted run: {launches}")
    for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words", "rs_bitmatmul"):
        expect(launches.get(name, 0) > 0, f"the mesh did not launch {name}")
    return launches


# --- phase 20: the graft entry -----------------------------------------------

def phase_entry(dev: torch.device) -> dict:
    from t3fs_torch import graft_entry as ge
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.torch_codec import make_stripe_encode_step

    fn, (words,) = ge.entry(dev)
    cc.reset_launches()
    parity, crcs = fn(words)
    torch.cuda.synchronize()
    launches = dict(cc.launches)
    pparity, pcrcs = make_stripe_encode_step(words.shape[2] * 4, device=dev)(
        words.view(torch.uint8))
    e = max(max_abs_err(parity.view(torch.uint8), pparity), max_abs_err(crcs, pcrcs))
    log(f"[20] graft_entry.entry() on {tuple(words.shape)} words: launches {launches}; "
        f"parity and CRCs against the plain step: max_abs_err={e}")
    expect(e == 0 and launches["crc_words"] > 0 and launches["rs_raid6_words"] > 0,
           "entry() disagrees with the plain step or ran no kernel")
    return launches


# --- phase 21: the CRAQ chain write ------------------------------------------

def chain_mix(full_chunks: int) -> list[list[tuple]]:
    """Phase 3's size mix through StorageClient.write_chunk, in rounds (each
    round's writes run concurrently; a chunk's writes follow its rounds):
    (inode, chunk index, offset, length).  Inode 2: 1 MiB writes, then
    appends of 1 MiB, (129 << 10) + 3 and 40 000 B (crc_combine), then 1 MiB
    overwrites inside them; inode 3: (129 << 10) + 3 B writes; inode 4:
    40 000 B writes (the host path); then 1 MiB overwrites inside the big
    file's full chunks (inode 1), which recompute the chunk CRC on the host."""
    mib, odd = 1 << 20, (129 << 10) + 3
    return [
        [(2, i, 0, mib) for i in range(8)] + [(3, i, 0, odd) for i in range(4)]
        + [(4, i, 0, 40_000) for i in range(4)],
        [(2, i, mib, mib) for i in range(8)],
        [(2, i, 2 * mib, odd) for i in range(8)],
        [(2, i, 2 * mib + odd, 40_000) for i in range(8)],
        [(2, i, mib // 2, mib) for i in range(8)]
        + [(1, i, mib + 4096 * i, mib) for i in range(min(8, full_chunks))],
    ]


async def phase_chain(dev: torch.device, pipeline: str, file_bytes: int,
                      chunk_bytes: int) -> dict:
    """One pass of the CRAQ 3-replica chain write through the port's entry
    points: StorageFabric(3 nodes, 3 replicas), a CudaChecksumBackend per
    node on `dev`, the fabric's default native engine and io_uring reads,
    `pipeline`, StorageClient with inline transfers.  write_file_range of one seeded file, then chain_mix on
    fresh inodes; every byte read back; every replica's ChunkMeta against
    the native host CRC of the expected bytes (and full chunks against
    plain B1 on the card), update_ver == commit_ver; each node's backend
    batched exactly its device-size updates.  Returns the pass's launches."""
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.ops import codec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)
    from t3fs_torch.storage.native_engine import NativeChunkEngine
    from t3fs_torch.storage.types import ChunkId
    from t3fs_torch.testing.fabric import StorageFabric

    expect(codec.host_impl() == "native", "the native host CRC did not build")
    rng = np.random.default_rng(SEED + 21)
    data = rng.bytes(file_bytes)
    fabric = StorageFabric(num_nodes=3, replicas=3,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev),
                           write_pipeline=pipeline)
    await fabric.start()
    sc = StorageClient(lambda: fabric.routing, client=fabric.client)
    try:
        engines = [type(t.engine).__name__ for n in fabric.nodes
                   for t in n.targets.values()]
        log(f"[21] write_pipeline={pipeline}: target engines {engines}, io_uring "
            f"worker on nodes {[n.node_id for n in fabric.nodes if n.aio is not None]}")
        expect(all(isinstance(t.engine, NativeChunkEngine) for n in fabric.nodes
                   for t in n.targets.values()),
               f"[21] a target is not on the native engine: {engines}")
        lay = FileLayout(chunk_size=chunk_bytes, chains=[fabric.chain_id])
        big_chunks = -(-file_bytes // chunk_bytes)
        mix = chain_mix(file_bytes // chunk_bytes)
        sizes = sorted({chunk_bytes, *(n for rnd in mix for *_, n in rnd)})
        for node in fabric.nodes:
            await asyncio.to_thread(node.codec.warmup,
                                    [n for n in sizes if n >= DEFAULT_MIN_DEVICE_BYTES])

        cc.reset_launches()
        t0 = time.perf_counter()
        results = await sc.write_file_range(lay, inode=1, offset=0, data=data)
        wall = time.perf_counter() - t0
        launches_file = cc.launches["crc_words"]
        expect(all(r.status.code == 0 for r in results),
               f"[21] a chunk write failed: {[r.status for r in results if r.status.code][:3]}")
        t1 = time.perf_counter()
        expected = {(1, i): bytearray(data[i * chunk_bytes:(i + 1) * chunk_bytes])
                    for i in range(big_chunks)}
        updates = [len(p) for p in (expected[k] for k in sorted(expected))]
        for rnd in mix:
            payloads = [rng.bytes(n) for *_, n in rnd]
            res = await asyncio.gather(*(
                sc.write_chunk(fabric.chain_id, ChunkId(inode, idx), off, p,
                               chunk_size=chunk_bytes)
                for (inode, idx, off, _), p in zip(rnd, payloads)))
            expect(all(r.status.code == 0 for r in res),
                   f"[21] a mix write failed: {[r.status for r in res if r.status.code][:3]}")
            for (inode, idx, off, n), p in zip(rnd, payloads):
                buf = expected.setdefault((inode, idx), bytearray())
                if len(buf) < off:
                    buf.extend(bytes(off - len(buf)))
                buf[off:off + n] = p
                updates.append(n)
        mix_wall = time.perf_counter() - t1
        launches = dict(cc.launches)

        # the client's checksums alone, on the native host CRC
        t2 = time.perf_counter()
        for i in range(big_chunks):
            codec.crc32c(memoryview(data)[i * chunk_bytes:(i + 1) * chunk_bytes])
        host_crc_s = time.perf_counter() - t2

        got, _ = await sc.read_file_range(lay, 1, 0, file_bytes)
        expect(got == b"".join(expected[(1, i)] for i in range(big_chunks)),
               "[21] the file read back differs")
        for inode in (2, 3, 4):
            keys = sorted(k for k in expected if k[0] == inode)
            for (_, idx) in keys:
                got, _ = await sc.read_file_range(lay, inode, idx * chunk_bytes,
                                                  len(expected[(inode, idx)]))
                expect(got == expected[(inode, idx)],
                       f"[21] inode {inode} chunk {idx} read back differs")

        want_crc = {k: codec.crc32c(bytes(v)) for k, v in expected.items()}
        full = [k for k, v in sorted(expected.items()) if len(v) == chunk_bytes]
        b1 = dict(zip(full, plain_crcs([bytes(expected[k]) for k in full], dev)))
        for i, node in enumerate(fabric.nodes):
            engine = node.targets[fabric.target_id(i)].engine
            for (inode, idx), crc in want_crc.items():
                meta = engine.get_meta(ChunkId(inode, idx))
                expect(meta is not None and meta.checksum == crc
                       and b1.get((inode, idx), crc) == crc,
                       f"[21] node {i + 1} chunk {inode}.{idx}: stored "
                       f"{meta and meta.checksum:#x} != native {crc:#x}")
                expect(meta.update_ver == meta.commit_ver
                       and meta.length == len(expected[(inode, idx)]),
                       f"[21] node {i + 1} chunk {inode}.{idx} not committed")
            for (inode, idx) in [(1, 0), (2, 0), (4, 0)]:
                expect(engine.read(ChunkId(inode, idx)) == expected[(inode, idx)],
                       f"[21] node {i + 1} holds other bytes for {inode}.{idx}")
        device_updates = sum(n >= DEFAULT_MIN_DEVICE_BYTES for n in updates)
        per_node = [(n.codec.batches, n.codec.batched_items) for n in fabric.nodes]
        log(f"[21] CRAQ chain write, write_pipeline={pipeline}: {file_bytes >> 20} MiB "
            f"file in {big_chunks} x {chunk_bytes >> 20} MiB chunks over 3 replicas, "
            f"wall {wall:.3f} s: {file_bytes / wall / 1e9:.3f} GB/s of client bytes, "
            f"{3 * file_bytes / wall / 1e9:.3f} GB/s replicated (host clock); "
            f"B1 launches {launches_file} for the file, {launches['crc_words']} with "
            f"the mix ({sum(len(r) for r in mix)} write_chunk in {len(mix)} rounds, "
            f"{mix_wall:.3f} s); the client's native host CRC of the file alone "
            f"{host_crc_s:.3f} s ({host_crc_s / wall * 100:.1f}% of the wall)")
        log(f"[21] per node (B1 batches, items, items per batch): " + ", ".join(
            f"n{i + 1} {b}, {it}, {it / max(b, 1):.1f}" for i, (b, it) in enumerate(per_node))
            + f"; device-size updates {device_updates}; every byte read back, every "
            f"replica's checksum equal to the native host CRC ({len(want_crc)} chunks) "
            f"and to plain B1 ({len(full)} full chunks), update_ver == commit_ver")
        expect(all(it == device_updates for _, it in per_node),
               f"[21] batched items {per_node} != device-size updates {device_updates}")
        expect(launches["crc_words"] > 0 or dev.type != "cuda",
               "[21] the chain write launched no B1")
        return launches
    finally:
        await sc.close()
        await fabric.stop()


def chain_device_times(dev: torch.device, chunk_bytes: int) -> dict:
    """What one chain hop puts on the card for a 4 MiB payload, each part
    timed alone with CUDA events: B1 on one row (the batch the chain's
    backend launched) and the pinned H2D copy of the payload."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    cw = chunk_bytes // 4
    tables = codec_tables(cw // 128, device=dev)
    host = torch.empty((1, cw), dtype=torch.int32, pin_memory=True)
    host.copy_(torch.randint(-2**31, 2**31, (1, cw), dtype=torch.int32))
    words = host.to(dev)
    b1 = kernel_times(lambda: cc.crc_words_raw(words, tables))
    h2d = kernel_times(lambda: words.copy_(host, non_blocking=True))
    bound = chunk_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[21] alone, CUDA events, median of {REPEATS} (min, max): B1 on (1, {cw}) = "
        f"one 4 MiB row {b1['ms'] * 1e3:.1f} us ({b1['min_ms'] * 1e3:.1f}, "
        f"{b1['max_ms'] * 1e3:.1f}; bound {bound * 1e3:.2f} us by bytes); pinned H2D "
        f"of 4 MiB {h2d['ms'] * 1e3:.1f} us ({h2d['min_ms'] * 1e3:.1f}, "
        f"{h2d['max_ms'] * 1e3:.1f})")
    return {"b1_ms": b1["ms"], "h2d_ms": h2d["ms"]}


# --- phase 22: the EC stripe path end to end ----------------------------------

def ec_target_engine(fabric, chain_id: int):
    """The engine of a one-replica chain's target, on a StorageFabric or on
    a LocalCluster (phase 23)."""
    if hasattr(fabric, "storage"):
        t = fabric.chain(chain_id).targets[0]
        return fabric.storage[t.node_id].node.targets[t.target_id].engine
    t = fabric.routing.chains[chain_id].targets[0]
    return fabric.nodes[t.node_id - 1].targets[t.target_id].engine


async def ec_remove(fabric, lay, inode: int, stripe: int, slot: int) -> None:
    """Remove one shard's chunk through Storage.remove_chunks at its chain's
    head (tests/test_torch_ec_client.py's _remove_shard)."""
    from t3fs_torch.storage.types import RemoveChunksReq

    chain_id = lay.shard_chain(stripe, slot)
    cid = lay.shard_chunk(inode, stripe, slot)
    head = fabric.routing.chains[chain_id].head()
    await fabric.client.call(
        fabric.routing.node_address(head.node_id), "Storage.remove_chunks",
        RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                        begin_index=cid.index, end_index=cid.index + 1))


async def limited(n: int, coros) -> list:
    """Await the coroutines with at most n in flight, results in order."""
    sem = asyncio.Semaphore(n)

    async def one(c):
        async with sem:
            return await c
    return await asyncio.gather(*(one(c) for c in coros))


def ec_ok(results) -> bool:
    return all(r.status.code == 0 for r in results)


async def ec_read_all(ec, lay, inode: int, stripes, stripe_len: int,
                      data: np.ndarray, want_crc: np.ndarray, tag: str,
                      phase: int = 22) -> None:
    """read_stripe_with_crcs of `stripes`, EC_INFLIGHT in flight: every byte
    against the written data, every returned CRC against plain B1."""
    outs = await limited(EC_INFLIGHT, (ec.read_stripe_with_crcs(
        lay, inode, s, stripe_len) for s in stripes))
    for s, (got, crcs) in zip(stripes, outs):
        expect(got == data[s].tobytes()[:stripe_len],
               f"[{phase}] {tag}: stripe {s} read back differs")
        expect(crcs == [int(c) for c in want_crc[s]],
               f"[{phase}] {tag}: stripe {s} CRCs {crcs} != plain B1 {want_crc[s].tolist()}")


def ec_check_repaired(fabric, lay, inode: int, lost: dict, data: np.ndarray,
                      want_crc: np.ndarray, tag: str, phase: int = 22) -> None:
    """Every repaired chunk committed, its stored bytes equal to the written
    chunk and its ChunkMeta.checksum to the native host CRC of them; a data
    chunk's checksum also equal to plain B1 of the written chunk, an RS
    parity chunk's bytes to the plain encode (RSCode.encode_ref) of data[s]."""
    from t3fs_torch.ops import codec
    from t3fs_torch.ops.rs import default_rs

    k = lay.k
    rs = default_rs(k, lay.m)
    for s, slots in lost.items():
        parity = None
        for slot in slots:
            engine = ec_target_engine(fabric, lay.shard_chain(s, slot))
            cid = lay.shard_chunk(inode, s, slot)
            meta = engine.get_meta(cid)
            if slot < k:
                want = data[s, slot].tobytes()
            else:
                expect(not lay.local_scheme and slot < k + lay.m,
                       f"[{phase}] {tag}: slot {slot} is not an RS parity slot")
                if parity is None:
                    parity = rs.encode_ref(data[s])
                want = parity[slot - k].tobytes()
            crc = codec.crc32c(want)
            expect(meta is not None and meta.checksum == crc
                   and meta.update_ver == meta.commit_ver
                   and (slot >= k or crc == int(want_crc[s, slot])),
                   f"[{phase}] {tag}: repaired stripe {s} slot {slot}: {meta} "
                   f"!= native {crc:#x}")
            expect(engine.read(cid) == want,
                   f"[{phase}] {tag}: repaired stripe {s} slot {slot}: stored bytes differ")


async def phase_ec_stripes(dev: torch.device, chunk_bytes: int = SHARD_BYTES,
                           stripes: int = EC_STRIPES,
                           small: int = EC_SMALL_STRIPES,
                           loss_reads: int = EC_NODE_LOSS_READS) -> dict:
    """The EC stripe path through the port's entry points: StorageFabric(5
    nodes, 10 one-replica chains, two a node), a CudaChecksumBackend per
    node on `dev`, the native engine and io_uring reads (the defaults),
    StorageClient, ECStorageClient over TorchECCodec(device=dev).  RS(8+2)
    at `chunk_bytes`: `stripes` seeded stripes written EC_INFLIGHT in
    flight, read back healthy; every chunk of one chain removed and every
    stripe read degraded; RepairDriver(concurrency=8) over those losses on
    the sub-shard path, every stripe read back; then `small` stripes each
    of pm-msr (8+2: write, one-loss repair_stripe, two-loss read), RS(6+3)
    (write, degraded read, repair) and lrc-xor (6+2, groups of 4: write, a
    local-group repair), one RS(8+2) stripe ending mid-chunk (its trimmed
    tail on the host CRC); last one node's server stops (two chains, the
    m = 2 limit) and `loss_reads` stripes read degraded.  Every byte and
    CRC against the data and plain B1; returns the phase's launches."""
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient, RepairIOStats
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.client.repair import RepairDriver, RepairJob
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.ops import codec as host
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)
    from t3fs_torch.storage.native_engine import NativeChunkEngine
    from t3fs_torch.testing.fabric import StorageFabric

    cs = chunk_bytes
    rng = np.random.default_rng(SEED + 22)
    fabric = StorageFabric(num_nodes=5, replicas=1, num_chains=10,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev))
    await fabric.start()
    sc = StorageClient(lambda: fabric.routing, client=fabric.client)
    codec = TorchECCodec(device=dev)
    ec = ECStorageClient(sc, codec=codec)
    try:
        engines = [(n.node_id, tid, type(t.engine).__name__)
                   for n in fabric.nodes for tid, t in sorted(n.targets.items())]
        log(f"[22] targets (node, target, engine): {engines}; io_uring worker "
            f"on nodes {[n.node_id for n in fabric.nodes if n.aio is not None]}")
        expect(all(isinstance(t.engine, NativeChunkEngine)
                   for n in fabric.nodes for t in n.targets.values()),
               f"[22] a target is not on the native engine: {engines}")
        lay = ECLayout.create(k=K, m=M, chunk_size=cs, chains=fabric.chain_ids)
        driver = RepairDriver(ec, concurrency=8)
        # the builds (tables, first launches) off the timed path
        for node in fabric.nodes:
            await asyncio.to_thread(node.codec.warmup,
                                    [n for n in (cs,) if n >= DEFAULT_MIN_DEVICE_BYTES])
        codec.warmup_decode([(tuple(range(1, K + 1)), (0,)),
                             ((0, 2, 3, 4, 5, 7, 8, 9), (1, 6))], cs, K, M)
        await driver.warmup([lay])
        data = rng.integers(0, 256, (stripes, K, cs), dtype=np.uint8)
        want_crc = plain_shard_crcs(data, dev)
        total = {}
        inode = 1

        cc.reset_launches()
        t0 = time.perf_counter()
        res = await limited(EC_INFLIGHT, (ec.write_stripe(lay, inode, s, data[s].tobytes())
                                          for s in range(stripes)))
        w_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        w_launches = dict(cc.launches)
        expect(all(ec_ok(r) for r in res), "[22] a stripe write failed")
        w_flush = (codec.flushes, codec.batched_items)

        cc.reset_launches()
        t0 = time.perf_counter()
        await ec_read_all(ec, lay, inode, range(stripes), K * cs, data, want_crc,
                          "healthy read")
        h_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        dead = fabric.chain_ids[0]
        losses = {s: tuple(sl for sl in range(K + M) if lay.shard_chain(s, sl) == dead)
                  for s in range(stripes)}
        for s, slots in losses.items():
            for sl in slots:
                await ec_remove(fabric, lay, inode, s, sl)
        n_lost = sum(map(len, losses.values()))
        cc.reset_launches()
        t0 = time.perf_counter()
        await ec_read_all(ec, lay, inode, range(stripes), K * cs, data, want_crc,
                          f"degraded read, chain {dead} lost")
        d_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        d_launches = dict(cc.launches)

        cc.reset_launches()
        t0 = time.perf_counter()
        report = await driver.run([RepairJob(
            layout=lay, inode=inode, stripe_len_of={s: K * cs for s in range(stripes)},
            losses=losses)])
        r_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        r_launches = dict(cc.launches)
        expect(not report.failed and report.repaired_shards == n_lost,
               f"[22] repair: {report}")
        expect(report.reduced_shards == n_lost and report.fallback_shards == 0,
               f"[22] repair took the full-k fallback: {report}")
        ec_check_repaired(fabric, lay, inode, losses, data, want_crc, "RepairDriver")
        cc.reset_launches()
        await ec_read_all(ec, lay, inode, range(stripes), K * cs, data, want_crc,
                          "read after repair")
        add_launches(total, cc.launches)

        data_bytes = stripes * K * cs
        log(f"[22] RS({K}+{M}) at {cs >> 10} KiB chunks, {stripes} stripes "
            f"({data_bytes >> 20} MiB of data, {stripes * (K + M) * cs >> 20} MiB "
            f"stored), {EC_INFLIGHT} calls in flight (host clock): write "
            f"{w_wall:.3f} s, {data_bytes / w_wall / 1e9:.3f} GB/s of data; healthy "
            f"read {h_wall:.3f} s, {data_bytes / h_wall / 1e9:.3f} GB/s; degraded "
            f"read (chain {dead} lost, {n_lost} shards) {d_wall:.3f} s, "
            f"{data_bytes / d_wall / 1e9:.3f} GB/s of data; RepairDriver "
            f"(concurrency 8, subshard) {r_wall:.3f} s: {report.bytes_repaired / r_wall / 1e9:.3f} "
            f"GB/s rebuilt, {report.bytes_read / r_wall / 1e9:.3f} GB/s of helper "
            f"bytes ({report.bytes_read / 2**20:.1f} MiB read for "
            f"{report.bytes_repaired / 2**20:.1f} MiB, {report.sub_reads} sub-reads, "
            f"reduced {report.reduced_shards}, fallback {report.fallback_shards}, "
            f"chain reads {report.min_chain_reads}..{report.max_chain_reads})")
        log(f"[22] launches: write {w_launches}; degraded read {d_launches}; "
            f"repair {r_launches}; codec flushes and items after the write "
            f"{w_flush[0]}, {w_flush[1]} ({w_flush[1] / max(w_flush[0], 1):.2f} a flush)")

        # pm-msr (8+2): write, one-loss projection repair, two-loss read
        small_data = rng.integers(0, 256, (small, K, cs), dtype=np.uint8)
        small_crc = plain_shard_crcs(small_data, dev)
        cc.reset_launches()
        t0 = time.perf_counter()
        msr = ECLayout.create(k=K, m=M, chunk_size=cs, chains=fabric.chain_ids,
                              local_scheme="pm-msr")
        res = await limited(EC_INFLIGHT, (ec.write_stripe(msr, 2, s, small_data[s].tobytes())
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), "[22] a pm-msr write failed")
        stats = RepairIOStats()
        for s in range(small):
            await ec_remove(fabric, msr, 2, s, 3)
        res = await limited(EC_INFLIGHT, (ec.repair_stripe(msr, 2, s, (3,), K * cs, stats=stats)
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res) and stats.reduced_shards == small
               and stats.fallback_shards == 0, f"[22] pm-msr repair: {stats}")
        ec_check_repaired(fabric, msr, 2, {s: (3,) for s in range(small)},
                          small_data, small_crc, "pm-msr repair")
        for s in range(small):
            for sl in (1, 8):
                await ec_remove(fabric, msr, 2, s, sl)
        await ec_read_all(ec, msr, 2, range(small), K * cs, small_data, small_crc,
                          "pm-msr two-loss read")
        msr_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        # RS(6+3): write (B5 + B6), degraded read, repair
        d63 = rng.integers(0, 256, (small, K63, cs), dtype=np.uint8)
        c63 = plain_shard_crcs(d63, dev)
        cc.reset_launches()
        t0 = time.perf_counter()
        rs63 = ECLayout.create(k=K63, m=M63, chunk_size=cs, chains=fabric.chain_ids)
        res = await limited(EC_INFLIGHT, (ec.write_stripe(rs63, 3, s, d63[s].tobytes())
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), "[22] an RS(6+3) write failed")
        for s in range(small):
            for sl in (0, 4, 7):
                await ec_remove(fabric, rs63, 3, s, sl)
        await ec_read_all(ec, rs63, 3, range(small), K63 * cs, d63, c63,
                          "RS(6+3) read, 3 lost")
        stats63 = RepairIOStats()
        res = await limited(EC_INFLIGHT, (ec.repair_stripe(rs63, 3, s, (0, 4, 7), K63 * cs,
                                                           stats=stats63)
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), f"[22] RS(6+3) repair: {stats63}")
        ec_check_repaired(fabric, rs63, 3, {s: (0, 4, 7) for s in range(small)},
                          d63, c63, "RS(6+3) repair")
        rs63_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        # lrc-xor (6+2, groups of 4): write, then a local-group repair
        lrc = ECLayout.create(k=6, m=2, chunk_size=cs, chains=fabric.chain_ids,
                              local_scheme="lrc-xor", local_group_size=4)
        dl = rng.integers(0, 256, (small, 6, cs), dtype=np.uint8)
        cl = plain_shard_crcs(dl, dev)
        cc.reset_launches()
        t0 = time.perf_counter()
        res = await limited(EC_INFLIGHT, (ec.write_stripe(lrc, 4, s, dl[s].tobytes())
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), "[22] an lrc-xor write failed")
        for s in range(small):
            await ec_remove(fabric, lrc, 4, s, 2)
        statsl = RepairIOStats()
        res = await limited(EC_INFLIGHT, (ec.repair_stripe(lrc, 4, s, (2,), 6 * cs,
                                                           stats=statsl)
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res) and statsl.reduced_shards == small
               and statsl.bytes_read == small * 4 * cs,
               f"[22] lrc-xor group repair: {statsl}")
        ec_check_repaired(fabric, lrc, 4, {s: (2,) for s in range(small)}, dl, cl,
                          "lrc-xor repair")
        await ec_read_all(ec, lrc, 4, range(small), 6 * cs, dl, cl, "lrc-xor read")
        lrc_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        # one RS(8+2) stripe ending mid-chunk: the trimmed tail's CRC is the
        # host's (stored), a rebuilt tail reports none
        tail_len = 5 * cs + cs // 2 + 123
        dt = rng.integers(0, 256, (1, K, cs), dtype=np.uint8)
        dt.reshape(-1)[tail_len:] = 0
        ct = plain_shard_crcs(dt, dev)
        tail = dt[0].tobytes()[:tail_len]
        ct[0, 5] = host.crc32c(tail[5 * cs:])
        cc.reset_launches()
        res = await ec.write_stripe(lay, 5, 0, tail)
        expect(ec_ok(res), "[22] the mid-chunk stripe write failed")
        meta = ec_target_engine(fabric, lay.shard_chain(0, 5)).get_meta(
            lay.shard_chunk(5, 0, 5))
        expect(meta.length == tail_len - 5 * cs and meta.checksum == int(ct[0, 5]),
               f"[22] the trimmed tail's stored CRC {meta}")
        got, crcs = await ec.read_stripe_with_crcs(lay, 5, 0, tail_len)
        # the tail reports its stored CRC when read, none when the first-k
        # read decoded it; the zero holes report none
        expect(got == tail and crcs[:5] == [int(c) for c in ct[0, :5]]
               and crcs[5] in (int(ct[0, 5]), None) and crcs[6:] == [None, None],
               f"[22] mid-chunk read {crcs}")
        await ec_remove(fabric, lay, 5, 0, 5)
        got, crcs = await ec.read_stripe_with_crcs(lay, 5, 0, tail_len)
        expect(got == tail and crcs[5] is None, f"[22] mid-chunk degraded read {crcs}")
        res = await ec.repair_stripe(lay, 5, 0, (5,), tail_len)
        meta = ec_target_engine(fabric, lay.shard_chain(0, 5)).get_meta(
            lay.shard_chunk(5, 0, 5))
        expect(ec_ok(res) and meta.checksum == int(ct[0, 5])
               and meta.update_ver == meta.commit_ver,
               f"[22] the repaired tail's stored CRC {meta}")
        add_launches(total, cc.launches)

        # one node's server stops: its two chains (the m = 2 limit) lost
        victim = fabric.nodes[1]
        lost_slots = tuple(sl for sl in range(K + M) if fabric.routing.chains[
            lay.shard_chain(0, sl)].targets[0].node_id == victim.node_id)
        await fabric.servers[1].stop()
        cc.reset_launches()
        t0 = time.perf_counter()
        await ec_read_all(ec, lay, inode, range(loss_reads), K * cs, data, want_crc,
                          f"node {victim.node_id} down, slots {lost_slots} lost")
        n_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        nbytes = loss_reads * K * cs
        log(f"[22] pm-msr ({small} stripes: write, repair of slot 3, two-loss read) "
            f"{msr_wall:.3f} s, repair {stats}; RS(6+3) ({small}: write, read "
            f"losing (0, 4, 7), repair) {rs63_wall:.3f} s, {stats63}; lrc-xor "
            f"(6+2, groups {lrc.local_groups()}: write, group repair of slot 2) "
            f"{lrc_wall:.3f} s, {statsl}; one stripe of {tail_len} B, its "
            f"tail's CRC on the host; node {victim.node_id} down (slots "
            f"{lost_slots}): {loss_reads} degraded reads {n_wall:.3f} s, "
            f"{nbytes / n_wall / 1e9:.3f} GB/s of data")
        per_node = [(n.node_id, n.codec.batches, n.codec.batched_items,
                     n.aio.completed if n.aio is not None else "no io_uring worker")
                    for n in fabric.nodes]
        log(f"[22] per node (B1 batches, items, io_uring reads completed): "
            + ", ".join(f"n{i} {b}, {it}, {a}" for i, b, it, a in per_node))
        log(f"[22] codec: {codec.flushes} flushes, {codec.batched_items} items "
            f"({codec.batched_items / max(codec.flushes, 1):.2f} a flush), "
            f"{codec.batches} key groups, codec_counts={codec.codec_counts}; "
            f"phase launches {total}")
        expect_routes(codec, ("cuda-encode-words", "cuda-decode-words",
                              "cuda-repair-words", "cuda-encode-bytes",
                              "cuda-decode-bytes", "cuda-msr-encode",
                              "cuda-msr-repair", "cuda-msr-decode"))
        if dev.type == "cuda":
            for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words",
                         "repair_words", "rs_bitmatmul", "crc_bytes"):
                expect(total.get(name, 0) > 0, f"[22] the EC path launched no {name}")
        return total
    finally:
        await ec.close()
        await sc.close()
        await fabric.stop()


# --- phase 23: the storage cluster under mgmtd, after a node loss -------------

def cluster_engine(cluster, t):
    """The engine of chain target `t` on a LocalCluster."""
    return cluster.storage[t.node_id].node.targets[t.target_id].engine


def fully_redundant(cluster) -> bool:
    """Every chain's every target SERVING, in mgmtd's routing."""
    return all(len(c.serving()) == len(c.targets)
               for c in cluster.mgmtd.state.routing().chains.values())


async def wait_state(pred, timeout_s: float, what: str, phase: int = 23) -> float:
    """Poll `pred` every 10 ms until it holds; the seconds it took.  A
    deadline, never a fixed sleep: detection and resync run on the
    cluster's wall clock."""
    t0 = time.perf_counter()
    while not pred():
        expect(time.perf_counter() - t0 < timeout_s,
               f"[{phase}] no {what} within {timeout_s} s")
        await asyncio.sleep(0.01)
    return time.perf_counter() - t0


def resync_sent(cluster, before: dict, skip: int) -> tuple[int, int, int]:
    """(REPLACEd chunks, their bytes, REMOVEs) the pushers' resync workers
    sent since `before`, node `skip` (the restarted successor) left out."""
    out = [0, 0, 0]
    for nid, ss in cluster.storage.items():
        if nid == skip or nid not in before:
            continue
        now = (ss.resync.replaced_chunks, ss.resync.replaced_bytes,
               ss.resync.removed_chunks)
        for i in range(3):
            out[i] += now[i] - before[nid][i]
    return tuple(out)


def resync_counts(cluster) -> dict:
    return {nid: (ss.resync.replaced_chunks, ss.resync.replaced_bytes,
                  ss.resync.removed_chunks) for nid, ss in cluster.storage.items()}


def check_replicas(cluster, lay, expected: dict, b1: dict) -> int:
    """On every replica of every replicated chain, read from its engine (not
    through the head): the same set of chunks as the chain's others and as
    the writes that were acked; each chunk's bytes equal to the last acked
    write, its ChunkMeta committed (update_ver == commit_ver) with the
    native host CRC of those bytes, and full chunks' CRC equal to plain B1.
    Runs in a thread: the reads must not stall the cluster's event loop."""
    from t3fs_torch.storage.types import ChunkId

    routing = cluster.mgmtd.state.routing()
    checked = 0
    for cid in lay.chains:
        chain = routing.chains[cid]
        want = {ChunkId(i, x) for (i, x) in expected if lay.chain_of(x) == cid}
        for t in chain.targets:
            have = {m.chunk_id for m in cluster_engine(cluster, t).all_metas()}
            expect(have == want, f"[23] chain {cid} target {t.target_id}: "
                   f"{len(have - want)} chunks the chain's others lack, "
                   f"{len(want - have)} acked chunks missing")
    for (inode, idx), (row, crc) in expected.items():
        buf = row.tobytes()
        expect(b1.get((inode, idx), crc) == crc,
               f"[23] chunk {inode}.{idx}: plain B1 {b1.get((inode, idx))} != native {crc:#x}")
        for t in routing.chains[lay.chain_of(idx)].targets:
            engine = cluster_engine(cluster, t)
            meta = engine.get_meta(ChunkId(inode, idx))
            expect(meta is not None and meta.checksum == crc
                   and meta.update_ver == meta.commit_ver
                   and meta.length == len(buf),
                   f"[23] target {t.target_id} chunk {inode}.{idx}: {meta} "
                   f"!= native {crc:#x}, {len(buf)} B, committed")
            expect(engine.read(ChunkId(inode, idx)) == buf,
                   f"[23] target {t.target_id} holds other bytes for {inode}.{idx}")
            checked += 1
    return checked


async def phase_recovery(dev: torch.device, chunk_bytes: int = CHUNK_BYTES,
                         file_chunks: int = RECOVERY_FILE_CHUNKS,
                         overwrites: int = RECOVERY_OVERWRITES,
                         new_chunks: int = RECOVERY_NEW_CHUNKS,
                         shard_bytes: int = SHARD_BYTES,
                         stripes: int = RECOVERY_EC_STRIPES,
                         degraded_reads: int = RECOVERY_DEGRADED_READS) -> dict:
    """Target resync and EC recovery after a node loss, through the port's
    LocalCluster (mgmtd, heartbeats, the chains updater, StorageServers with
    their resync workers): 5 nodes, 5 chains of 3 (chain c on nodes c, c+1,
    c+2 mod 5) and 10 one-replica EC chains, a CudaChecksumBackend a node on
    `dev`.  A seeded file of `file_chunks` x `chunk_bytes` striped over the
    replicated chains and `stripes` RS(8+2) stripes at `shard_bytes` written
    by ECStorageClient over TorchECCodec; then node RECOVERY_FLAP_NODE
    fail-stops (wait for the reshape), `overwrites` chunks of the file and a
    new file of `new_chunks` are written on the survivors and
    `degraded_reads` stripes read degraded; the node restarts on its old
    disk (resync of what changed), node RECOVERY_WIPE_NODE restarts empty
    (full resync; its EC chains come back empty), and a ScrubScheduler
    scans until nothing is left to repair, a shard bit-rotted on disk
    between scans.  Every replica, every chunk and every stripe is checked;
    returns the phase's launches."""
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.ops import codec as host
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)
    from t3fs_torch.storage.native_engine import NativeChunkEngine
    from t3fs_torch.storage.scrub_scheduler import ScrubScheduler
    from t3fs_torch.storage.types import ChunkId
    from t3fs_torch.testing.cluster import LocalCluster

    cs, flap, wipe = chunk_bytes, RECOVERY_FLAP_NODE, RECOVERY_WIPE_NODE
    rng = np.random.default_rng(SEED + 23)
    # the data and its expected checksums (native host CRC, plain B1 of full
    # chunks) before the cluster starts: none of it may stall the cluster's
    # event loop, whose heartbeats fence a node after 0.3 s of silence
    file_arr = rng.integers(0, 256, (file_chunks, cs), dtype=np.uint8)
    over_idx = sorted(rng.choice(file_chunks, overwrites, replace=False).tolist())
    over_arr = rng.integers(0, 256, (overwrites, cs), dtype=np.uint8)
    new_arr = rng.integers(0, 256, (new_chunks, cs), dtype=np.uint8)
    ec_data = rng.integers(0, 256, (stripes, K, shard_bytes), dtype=np.uint8)
    ec_crc = plain_shard_crcs(ec_data, dev)
    final = {(1, i): file_arr[i] for i in range(file_chunks)}
    final.update({(1, i): over_arr[j] for j, i in enumerate(over_idx)})
    final.update({(2, i): new_arr[i] for i in range(new_chunks)})
    keys = sorted(final)
    rows = np.stack([final[k] for k in keys])
    b1 = {k: int(c) for k, c in zip(keys, plain_shard_crcs(rows[:, None, :], dev)[:, 0])}
    expected = {k: (final[k], host.crc32c(final[k].tobytes())) for k in keys}
    del rows

    cluster = LocalCluster(num_nodes=5, replicas=3, num_chains=5, ec_chains=10,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev))
    await cluster.start()
    codec = TorchECCodec(device=dev)
    ec = ECStorageClient(cluster.sc, codec=codec)
    try:
        sc = cluster.sc
        engines = [(nid, tid, type(t.engine).__name__)
                   for nid, ss in sorted(cluster.storage.items())
                   for tid, t in sorted(ss.node.targets.items())]
        expect(all(isinstance(t.engine, NativeChunkEngine)
                   for ss in cluster.storage.values() for t in ss.node.targets.values()),
               f"[23] a target is not on the native engine: {engines}")
        lay = FileLayout(chunk_size=cs, chains=list(range(1, 6)))
        elay = ECLayout.create(k=K, m=M, chunk_size=shard_bytes,
                               chains=list(range(6, 16)))
        free = shutil.disk_usage(cluster.node_root(1).rsplit("/", 1)[0]).free
        log(f"[23] LocalCluster: 5 nodes, chains 1-5 of 3 replicas, EC chains 6-15 "
            f"of one; {len(engines)} targets, all NativeChunkEngine; mgmtd heartbeat "
            f"timeout {cluster.mgmtd_cfg.heartbeat_timeout_s} s, chains tick "
            f"{cluster.mgmtd_cfg.chains_update_period_s} s; {free / 2**30:.1f} GiB "
            f"free under the nodes' roots")
        sizes = [n for n in (cs, shard_bytes) if n >= DEFAULT_MIN_DEVICE_BYTES]
        for ss in cluster.storage.values():
            await asyncio.to_thread(ss.node.codec.warmup, sizes)
        codec.warmup_decode([(tuple(s for s in range(K + M) if s not in (1, 6))[:K], (1, 6)),
                             (tuple(s for s in range(K + M) if s not in (3, 8))[:K], (3, 8))],
                            shard_bytes, K, M)
        # stripes_per_tick above the stripe count: every tick probes the
        # whole file and wraps the walk at its end
        sched = ScrubScheduler(ec, repair_mode="subshard", concurrency=8,
                               stripes_per_tick=stripes + 1)
        await sched.driver.warmup([elay])
        steps: dict[str, dict] = {}
        cc.reset_launches()

        # each payload is copied out of its array when its write starts: a
        # copy of every payload up front would stall the event loop
        async def put(inode: int, arr: np.ndarray, j: int, i: int):
            return await sc.write_file_range(lay, inode, i * cs, arr[j].tobytes())

        async def put_stripe(s: int):
            return await ec.write_stripe(elay, 10, s, ec_data[s].tobytes())

        async def write_rows(inode: int, arr: np.ndarray, idx: list[int]) -> None:
            res = await limited(RECOVERY_INFLIGHT, (
                put(inode, arr, j, i) for j, i in enumerate(idx)))
            bad = [r.status for rr in res for r in rr if r.status.code]
            expect(not bad, f"[23] inode {inode}: a chunk write failed: {bad[:3]}")

        # the seeded file and the EC stripes on the healthy cluster
        t0 = time.perf_counter()
        await write_rows(1, file_arr, list(range(file_chunks)))
        f_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = await limited(EC_INFLIGHT, (put_stripe(s) for s in range(stripes)))
        e_wall = time.perf_counter() - t0
        expect(all(ec_ok(r) for r in res), "[23] a stripe write failed")
        steps["write"] = dict(cc.launches)
        log(f"[23] healthy: {file_chunks} x {cs >> 10} KiB chunks "
            f"({file_chunks * cs >> 20} MiB, x3 stored) in {f_wall:.3f} s, "
            f"{file_chunks * cs / f_wall / 1e9:.3f} GB/s of client bytes; {stripes} "
            f"RS({K}+{M}) stripes of {K} x {shard_bytes >> 10} KiB in {e_wall:.3f} s, "
            f"{stripes * K * shard_bytes / e_wall / 1e9:.3f} GB/s of data")

        # 1. fail-stop: mgmtd must move the node's targets out of every
        # chain's serving set
        cc.reset_launches()
        t0 = time.perf_counter()
        await cluster.kill_storage_node(flap)
        kill_s = time.perf_counter() - t0
        await wait_state(
            lambda: all(t.node_id != flap for c in
                        cluster.mgmtd.state.routing().chains.values()
                        for t in c.serving()), 30.0, "reshape after the kill")
        detect = time.perf_counter() - t0
        routing = cluster.mgmtd.state.routing()
        log(f"[23] node {flap} killed (the stop call {kill_s:.3f} s): every chain "
            f"reshaped {detect:.3f} s after the kill call; " + ", ".join(
                f"chain {c.chain_id} v{c.chain_ver} "
                + "/".join(f"{t.target_id}:{t.public_state.name}" for t in c.targets)
                for c in routing.chains.values() if c.chain_id <= 5))

        # 2. writes and degraded reads during the outage
        t0 = time.perf_counter()
        await write_rows(1, over_arr, over_idx)
        await write_rows(2, new_arr, list(range(new_chunks)))
        o_wall = time.perf_counter() - t0
        routing = cluster.mgmtd.state.routing()
        acked = [(1, i) for i in over_idx] + [(2, i) for i in range(new_chunks)]
        for inode, idx in acked:
            chain = routing.chains[lay.chain_of(idx)]
            serving = chain.serving()
            down = any(t.node_id == flap for t in chain.targets)
            expect(len(serving) == 3 - down and all(t.node_id != flap for t in serving),
                   f"[23] chain {chain.chain_id} serving {serving} during the outage")
            for t in serving:
                meta = cluster_engine(cluster, t).get_meta(ChunkId(inode, idx))
                expect(meta is not None and meta.update_ver == meta.commit_ver
                       and meta.checksum == expected[(inode, idx)][1],
                       f"[23] {inode}.{idx} not committed on survivor {t.target_id}: {meta}")
        lost_slots = tuple(s for s in range(K + M) if cluster.chain(
            elay.shard_chain(0, s)).targets[0].node_id == flap)
        t0 = time.perf_counter()
        await ec_read_all(ec, elay, 10, range(degraded_reads), K * shard_bytes, ec_data,
                          ec_crc, f"node {flap} down, slots {lost_slots} lost", phase=23)
        d_wall = time.perf_counter() - t0
        steps["outage"] = dict(cc.launches)
        nbytes = (overwrites + new_chunks) * cs
        log(f"[23] outage: {overwrites} overwrites and a {new_chunks}-chunk file "
            f"({nbytes / 2**20:.1f} MiB) acked by the survivors of each chain in "
            f"{o_wall:.3f} s, {nbytes / o_wall / 1e9:.3f} GB/s of client bytes; "
            f"{degraded_reads} stripes read degraded (slots {lost_slots}) in "
            f"{d_wall:.3f} s, {degraded_reads * K * shard_bytes / d_wall / 1e9:.3f} "
            f"GB/s of data")

        # 3. flap: the node returns on its old disk; resync sends what changed
        cc.reset_launches()
        before = resync_counts(cluster)
        t0 = time.perf_counter()
        await cluster.restart_storage_node(flap)
        await wait_state(lambda: fully_redundant(cluster), 120.0,
                         "full redundancy after the flap")
        flap_wall = time.perf_counter() - t0
        flap_sent = resync_sent(cluster, before, flap)
        flap_items = cluster.storage[flap].node.codec.batched_items
        steps["flap"] = dict(cc.launches)
        changed = sum(1 for k in acked if any(
            t.node_id == flap for t in cluster.chain(lay.chain_of(k[1])).targets))
        log(f"[23] flap: node {flap} restarted on its old disk, full redundancy "
            f"{flap_wall:.3f} s after the restart call; resync REPLACEd "
            f"{flap_sent[0]} chunks ({flap_sent[1] / 2**20:.1f} MiB, "
            f"{flap_sent[1] / flap_wall / 1e9:.3f} GB/s over the wall), removed "
            f"{flap_sent[2]}; {changed} chunks of its chains changed while it was "
            f"down; its B1 items {flap_items}")
        expect(flap_sent[0] == changed,
               f"[23] the flap's resync sent {flap_sent[0]} chunks, {changed} changed")
        expect(flap_items >= flap_sent[0],
               f"[23] node {flap} batched {flap_items} B1 items for "
               f"{flap_sent[0]} device-size REPLACEs")

        # 4. disk replaced: another node restarts empty; every chunk of its
        # replicated targets comes back by full resync, its EC chains empty
        cc.reset_launches()
        before = resync_counts(cluster)
        t0 = time.perf_counter()
        await cluster.restart_storage_node_empty(wipe)
        call_s = time.perf_counter() - t0
        await wait_state(lambda: fully_redundant(cluster), 300.0,
                         "full redundancy after the empty restart")
        wipe_wall = time.perf_counter() - t0
        wipe_sent = resync_sent(cluster, before, wipe)
        wipe_items = cluster.storage[wipe].node.codec.batched_items
        steps["wipe"] = dict(cc.launches)
        held = sum(1 for k in final
                   if any(t.node_id == wipe for t in cluster.chain(lay.chain_of(k[1])).targets))
        log(f"[23] empty disk: node {wipe} restart_storage_node_empty {call_s:.3f} s "
            f"(kill, detection, wipe, restart, heads back), full redundancy "
            f"{wipe_wall:.3f} s after the call; resync REPLACEd {wipe_sent[0]} chunks "
            f"({wipe_sent[1] / 2**20:.1f} MiB, {wipe_sent[1] / wipe_wall / 1e9:.3f} GB/s "
            f"over the wall); its chains hold {held} chunks; its B1 items {wipe_items}")
        expect(wipe_sent[0] == held, f"[23] the empty disk's resync sent "
               f"{wipe_sent[0]} chunks, its chains hold {held}")
        expect(wipe_items >= wipe_sent[0],
               f"[23] node {wipe} batched {wipe_items} B1 items for "
               f"{wipe_sent[0]} device-size REPLACEs")

        # 5. scrub until nothing is left to repair; a shard bit-rotted on
        # disk after the first repairing scan (before it, that stripe would
        # have lost three shards, past RAID-6's two)
        cc.reset_launches()
        stripe_lens = {s: K * shard_bytes for s in range(stripes)}
        sched.add_target("recovery", elay, 10, stripe_lens)
        wiped = tuple(s for s in range(K + M) if cluster.chain(
            elay.shard_chain(0, s)).targets[0].node_id == wipe)
        rot = (RECOVERY_ROT_STRIPE, next(s for s in range(K + M) if s not in wiped
                                         and s not in lost_slots))
        reports, rotted = [], False
        t0 = time.perf_counter()
        for _ in range(6):
            before = (sched.stats.shards_lost, sched.stats.shards_corrupt,
                      sched.stats.stripes_scanned)
            reports.append(await sched.scan_once())
            expect(sched.stats.stripes_scanned - before[2] == stripes,
                   f"[23] a scrub tick scanned {sched.stats.stripes_scanned - before[2]} "
                   f"stripes of {stripes}")
            clean = (sched.stats.shards_lost, sched.stats.shards_corrupt) == before[:2]
            if clean and rotted:
                break
            if not rotted and reports[-1].repaired_shards:
                expect(cluster.corrupt_chunk_on_disk(
                    elay.shard_chain(*rot), elay.shard_chunk(10, *rot)),
                    f"[23] stripe {rot[0]} slot {rot[1]} is not on disk")
                rotted = True
        s_wall = time.perf_counter() - t0
        st = sched.status()
        steps["scrub"] = dict(cc.launches)
        rebuilt = st["bytes_repaired"]
        log(f"[23] scrub: {len(reports)} scans in {s_wall:.3f} s; repaired "
            f"{st['repaired_shards']} shards ({st['reduced_shards']} reduced, "
            f"{st['fallback_shards']} full-k) of {st['repaired_stripes']} stripes, "
            f"lost {st['shards_lost']}, corrupt {st['shards_corrupt']}, failed "
            f"{st['stripes_failed']}; {st['bytes_read'] / 2**20:.1f} MiB of helper "
            f"bytes for {rebuilt / 2**20:.1f} MiB rebuilt: {rebuilt / s_wall / 1e9:.3f} "
            f"GB/s rebuilt, {st['bytes_read'] / s_wall / 1e9:.3f} GB/s of helper bytes")
        expect(rotted and st["stripes_failed"] == 0
               and st["shards_lost"] == stripes * len(wiped)
               and st["shards_corrupt"] == 1
               and st["repaired_shards"] == stripes * len(wiped) + 1
               and st["reduced_shards"] >= 1,
               f"[23] scrub: {st}")
        cc.reset_launches()
        await ec_read_all(ec, elay, 10, range(stripes), K * shard_bytes, ec_data,
                          ec_crc, "read after the scrub", phase=23)
        add_launches(steps["scrub"], cc.launches)
        total: dict = {}
        for part in steps.values():
            add_launches(total, part)

        # the guarantees: every acked write on every replica, every stripe whole
        expect(fully_redundant(cluster), "[23] a chain lost redundancy before the checks")
        checked = await asyncio.to_thread(check_replicas, cluster, lay, expected, b1)
        lost = {s: tuple(sorted(wiped + ((rot[1],) if s == rot[0] else ())))
                for s in range(stripes)}
        await asyncio.to_thread(ec_check_repaired, cluster, elay, 10, lost, ec_data,
                                ec_crc, "scrub repair", 23)
        per_node = [(nid, ss.node.codec.batches, ss.node.codec.batched_items,
                     ss.node.aio.completed if ss.node.aio is not None else None)
                    for nid, ss in sorted(cluster.storage.items())]
        log(f"[23] per node since its (re)start (B1 batches, items, items per batch, "
            f"reads): " + ", ".join(
                f"n{nid} {b}, {it}, {it / max(b, 1):.2f}, "
                + (f"io_uring {a}" if a is not None else "thread pool")
                for nid, b, it, a in per_node))
        log(f"[23] checks: {checked} replica chunks ({len(expected)} chunks x 3) "
            f"byte for byte from each target's engine, ChunkMeta committed with the "
            f"native host CRC, full chunks equal to plain B1; no replica holds a chunk "
            f"its chain's others lack; {stripes} stripes whole, "
            f"{sum(map(len, lost.values()))} rebuilt shards equal to the plain "
            f"encode's; codec {codec.codec_counts}")
        log(f"[23] launches: " + "; ".join(
            f"{k} {({n: c for n, c in v.items() if c})}" for k, v in steps.items())
            + f"; phase {total}")
        if dev.type == "cuda":
            from t3fs_torch.benchmarks.devbench import card_line

            log(f"[23] {card_line()}")
            expect_routes(codec, ("cuda-encode-words", "cuda-decode-words",
                                  "cuda-repair-words"))
            for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words",
                         "repair_words"):
                expect(total.get(name, 0) > 0, f"[23] the recovery drill launched no {name}")
            expect(steps["flap"].get("crc_words", 0) > 0
                   and steps["wipe"].get("crc_words", 0) > 0,
                   f"[23] a resync launched no B1: {steps}")
        return total
    finally:
        await ec.close()
        await cluster.stop()


# --- phase 24: the file system and a parallel checkpoint ---------------------

def ckpt_tree(rng: np.random.Generator, leaf_bytes: int, big: int,
              odd: tuple[int, ...]) -> dict:
    """The checkpoint's seeded tree: `big` leaves of `leaf_bytes` (uint8,
    float32, int64 and uint8 in turn, so dtype and shape must come back),
    uint8 leaves of the `odd` lengths (partial stripes, trimmed tails) and
    an int64 scalar."""
    layers = {}
    for i in range(big):
        raw = rng.integers(0, 256, leaf_bytes, dtype=np.uint8)
        arr = (raw.view(np.float32).reshape(-1, 1024) if i % 4 == 1 else
               raw.view(np.int64).reshape(256, -1) if i % 4 == 2 else raw)
        layers[f"l{i:02d}"] = {"w": arr}
    return {"layers": layers,
            "odd": [rng.integers(0, 256, n, dtype=np.uint8) for n in odd],
            "step": np.int64(7)}


def leaf_bytes_of(x) -> np.ndarray:
    """A leaf's bytes as a flat uint8 view (NaN payloads compare as bytes)."""
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def same_leaves(tree, have: dict) -> bool:
    """Every leaf of `tree` in `have` ({path: array}) with its dtype, shape
    and bytes."""
    from t3fs_torch.ckpt import flatten_tree

    want = dict(flatten_tree(tree)[0])
    if want.keys() != have.keys():
        return False
    for path in want:
        a, b = np.asarray(want[path]), np.asarray(have[path])
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(leaf_bytes_of(a), leaf_bytes_of(b)):
            return False
    return True


def ckpt_expected(tree, k: int, m: int, cs: int, dev: torch.device) -> dict:
    """path -> (stored lengths (stripes, k+m), parity (stripes, m, cs) by
    the plain RAID-6 encode, the native host CRC of each stored shard and
    plain B1 of each zero-padded shard, both (stripes, k+m) uint32)."""
    from t3fs_torch.ckpt import flatten_tree
    from t3fs_torch.ops import codec as host
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    out = {}
    enc_tables = codec_tables(1, k, m, device=dev)
    for path, leaf in flatten_tree(tree)[0]:
        flat = leaf_bytes_of(leaf)
        n = -(-len(flat) // (k * cs))
        padded = np.zeros((n, k, cs), dtype=np.uint8)
        padded.reshape(-1)[:len(flat)] = flat
        words = torch.from_numpy(padded.view(np.int32)).to(dev)
        parity = torch.cat([cc.rs_raid6_words_plain(part, enc_tables)
                            for part in words.split(8)]).cpu().numpy().view(np.uint8)
        full = np.concatenate([padded, parity], axis=1)
        b1 = plain_shard_crcs(full, dev)
        lens = np.zeros((n, k + m), dtype=np.int64)
        host_crc = np.zeros((n, k + m), dtype=np.uint32)
        for s in range(n):
            for j in range(k + m):
                ln = cs if j >= k else max(0, min(cs, len(flat) - (s * k + j) * cs))
                lens[s, j] = ln
                if ln:
                    host_crc[s, j] = host.crc32c(full[s, j, :ln].tobytes())
        out[path] = (lens, parity, host_crc, b1)
    return out


@contextlib.contextmanager
def counted_lengths(module, name: str):
    """The lengths `module.name` (a host CRC) is called on while the block
    runs: ECStorageClient.encode_stripe's trimmed tails through
    t3fs_torch.ops.codec.crc32c, which it imports at call time; the storage
    nodes' small payloads through codec_backend.cpu_crc32c."""
    orig, seen = getattr(module, name), []

    def counted(data, *args, **kwargs):
        seen.append(len(data))
        return orig(data, *args, **kwargs)
    setattr(module, name, counted)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def check_ckpt_shards(cluster, lay, manifest, tree, expected: dict) -> int:
    """Every shard of every stripe of `manifest` on its chain's engine: a
    hole absent, every other shard committed, its bytes equal to the leaf's
    (data) or to the plain encode's (parity), its ChunkMeta.checksum equal
    to the native host CRC of those bytes and, for a whole shard, to plain
    B1; the manifest's CRCs equal to the same.  Runs in a thread."""
    from t3fs_torch.ckpt import flatten_tree

    leaves = dict(flatten_tree(tree)[0])
    k, cs, checked = lay.k, lay.chunk_size, 0
    for lf in manifest.leaves:
        lens, parity, host_crc, b1 = expected[lf.path]
        flat = leaf_bytes_of(leaves[lf.path])
        for s in range(lf.num_stripes):
            expect(lf.stripe_crcs(lay, s) == [int(c) for c in host_crc[s]],
                   f"[24] {lf.path} stripe {s}: manifest CRCs differ from the host CRC")
            for j in range(lay.k + lay.m):
                engine = ec_target_engine(cluster, lay.shard_chain(s, j))
                cid = lay.shard_chunk(lf.inode, s, j)
                meta = engine.get_meta(cid)
                ln = int(lens[s, j])
                if not ln:
                    expect(meta is None, f"[24] {lf.path} stripe {s} hole {j} stored")
                    continue
                want = (flat[(s * k + j) * cs:(s * k + j) * cs + ln] if j < k
                        else parity[s, j - k]).tobytes()
                crc = int(host_crc[s, j])
                expect(meta is not None and meta.checksum == crc
                       and meta.update_ver == meta.commit_ver and meta.length == ln
                       and (ln < cs or crc == int(b1[s, j])),
                       f"[24] {lf.path} stripe {s} shard {j}: {meta} != native "
                       f"{crc:#x} / plain B1 {int(b1[s, j]):#x}, {ln} B, committed")
                expect(engine.read(cid) == want,
                       f"[24] {lf.path} stripe {s} shard {j}: stored bytes differ")
                checked += 1
    return checked


async def phase_ckpt(dev: torch.device, leaf_bytes: int = CKPT_LEAF_BYTES,
                     big_leaves: int = CKPT_BIG_LEAVES,
                     odd: tuple[int, ...] = CKPT_ODD_LEAVES,
                     chunk_bytes: int = CKPT_CHUNK,
                     ns_bytes: int = CKPT_NS_FILE,
                     ns_chunk: int = CHUNK_BYTES,
                     step2_leaves: int = CKPT_STEP2_LEAVES) -> dict:
    """The file system and a parallel checkpoint through the port's entry
    points, on the port's LocalCluster with its meta service (phase 23's
    layout: 5 nodes, chains 1-5 of 3 replicas, EC chains 6-15 of one, a
    CudaChecksumBackend a node on `dev`, heartbeat timeout 0.6 s).

    The namespace: FileSystem.mkdirs, a seeded `ns_bytes` file written at
    `ns_chunk` chunks (B1 on every hop), stat, read back, renamed across
    directories, readdir, unlinked; meta's GC (a task in the cluster's
    event loop) must remove every chunk from every replica.  The
    checkpoint, at ckpt_bench's code and admission (RS(8+2), `chunk_bytes`
    shards, window 8, per-chain 2): save (every stripe one fused
    encode-and-CRC call on a cuda-* route, no whole shard's CRC on the
    host), restore, restore_shard with CKPT_READERS readers, a re-save
    that the CRC probe skips whole, one node fail-stopped (two EC chains:
    the m = 2 limit) and a degraded restore (B3 + B1), the node back on an
    empty disk and scrub(repair=True) until clean, every shard's bytes and
    stored checksum against the plain encode and the native host CRC,
    then a second step and gc(keep_last=1).  Returns the phase's
    launches."""
    from t3fs_torch.ckpt import (CheckpointReader, CheckpointStore,
                                 CheckpointWriter, flatten_tree)
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.fuse.vfs import FileSystem
    from t3fs_torch.ops import codec as host_codec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)
    from t3fs_torch.storage.native_engine import NativeChunkEngine
    from t3fs_torch.storage.types import ChunkId
    from t3fs_torch.testing.cluster import LocalCluster

    cs, on_card = chunk_bytes, dev.type == "cuda"
    rng = np.random.default_rng(SEED + 24)
    # the data and what every shard must hold, before the cluster starts:
    # nothing may stall its event loop (a node fences itself after 0.3 s
    # without a heartbeat)
    t0 = time.perf_counter()
    tree = ckpt_tree(rng, leaf_bytes, big_leaves, odd)
    tree2 = ckpt_tree(rng, leaf_bytes, step2_leaves, ())
    ns_data = rng.integers(0, 256, ns_bytes, dtype=np.uint8).tobytes()
    expected = ckpt_expected(tree, K, M, cs, dev)
    logical = sum(leaf_bytes_of(x).nbytes for _, x in flatten_tree(tree)[0])
    logical2 = sum(leaf_bytes_of(x).nbytes for _, x in flatten_tree(tree2)[0])
    trimmed = sum(int(((lens[:, :K] > 0) & (lens[:, :K] < cs)).sum())
                  for lens, *_ in expected.values())
    stripes = sum(lens.shape[0] for lens, *_ in expected.values())
    log(f"[24] tree: {big_leaves} leaves of {leaf_bytes >> 20} MiB (uint8, float32, "
        f"int64), leaves of {', '.join(map(str, odd))} B and an int64 scalar: "
        f"{logical} B ({logical / 2**30:.3f} GiB, a cut of a real checkpoint), "
        f"{stripes} RS({K}+{M}) stripes of {K} x {cs >> 10} KiB, {trimmed} trimmed "
        f"tail shards; data, plain parity and CRCs made in "
        f"{time.perf_counter() - t0:.3f} s")

    cluster = LocalCluster(num_nodes=5, replicas=3, num_chains=5, ec_chains=10,
                           with_meta=True, heartbeat_timeout_s=0.6,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev))
    await cluster.start()
    codec = TorchECCodec(device=dev)
    ec = ECStorageClient(cluster.sc, codec=codec)
    fs = FileSystem(cluster.mc, cluster.sc)
    try:
        expect(all(isinstance(t.engine, NativeChunkEngine)
                   for ss in cluster.storage.values() for t in ss.node.targets.values()),
               "[24] a target is not on the native engine")
        expect(cluster.meta is not None and cluster.mc is not None,
               "[24] the cluster started no meta service")
        lay = ECLayout.create(k=K, m=M, chunk_size=cs, chains=list(range(6, 16)))
        victim = 3
        lost = tuple(s for s in range(K + M) if cluster.chain(
            lay.shard_chain(0, s)).targets[0].node_id == victim)
        sizes = [n for n in (ns_chunk, cs) if n >= DEFAULT_MIN_DEVICE_BYTES]
        for ss in cluster.storage.values():
            await asyncio.to_thread(ss.node.codec.warmup, sizes)
        codec.warmup_decode([(tuple(s for s in range(K + M) if s not in lost)[:K], lost)],
                            cs, K, M)
        await ec.encode_stripe(lay, bytes(K * cs))
        log(f"[24] LocalCluster with meta: 5 nodes, chains 1-5 of 3 replicas, EC "
            f"chains 6-15 of one; MetaServer GC every {cluster.meta.gc_period_s} s "
            f"in the cluster's event loop; heartbeat timeout "
            f"{cluster.mgmtd_cfg.heartbeat_timeout_s} s")
        steps: dict[str, dict] = {}

        # 1. the namespace
        cc.reset_launches()
        t0 = time.perf_counter()
        await fs.mkdirs("/ns/a")
        await fs.mkdirs("/ns/b")
        ino = await fs.write_file("/ns/a/big", ns_data, chunk_size=ns_chunk)
        w_wall = time.perf_counter() - t0
        expect((await fs.stat("/ns/a/big")).length == ns_bytes == ino.length,
               f"[24] stat: length {ino.length} != {ns_bytes}")
        t0 = time.perf_counter()
        back = await fs.read_file("/ns/a/big")
        r_wall = time.perf_counter() - t0
        expect(back == ns_data, "[24] the namespace file read back differs")
        del back
        await fs.rename("/ns/a/big", "/ns/b/big")
        expect([e.name for e in await fs.readdir("/ns/b")] == ["big"]
               and await fs.readdir("/ns/a") == [], "[24] readdir after the rename")
        expect((await fs.stat("/ns/b/big")).inode_id == ino.inode_id,
               "[24] the rename changed the inode")
        flay = ino.layout
        n_chunks = -(-ns_bytes // ns_chunk)

        def ns_present() -> int:
            return sum(cluster_engine(cluster, t).get_meta(ChunkId(ino.inode_id, i))
                       is not None for i in range(n_chunks)
                       for t in cluster.chain(flay.chain_of(i)).targets)
        expect(ns_present() == 3 * n_chunks,
               f"[24] {ns_present()} replica chunks of the file, not {3 * n_chunks}")
        gc0 = cluster.meta.gc_count
        t0 = time.perf_counter()
        await fs.unlink("/ns/b/big")
        await wait_state(lambda: ns_present() == 0 and cluster.meta.gc_count > gc0,
                         30.0, "GC of the unlinked file's chunks", phase=24)
        gc_wall = time.perf_counter() - t0
        steps["namespace"] = dict(cc.launches)
        log(f"[24] namespace: a {ns_bytes >> 20} MiB file of {ns_chunk >> 20} MiB chunks "
            f"on chain {flay.chains} (x3) written in {w_wall:.3f} s "
            f"({ns_bytes / w_wall / 1e6:.1f} MB/s), read back in {r_wall:.3f} s "
            f"({ns_bytes / r_wall / 1e6:.1f} MB/s); stat, rename across directories, "
            f"readdir; unlink -> every replica's chunks gone {gc_wall:.3f} s later "
            f"(meta GC)")

        # 2. save
        writer = CheckpointWriter(ec, fs, lay, "/ckpt/run", window=CKPT_WINDOW,
                                  per_chain=CKPT_PER_CHAIN)
        reader = CheckpointReader(ec, fs, "/ckpt/run", window=CKPT_WINDOW)
        store = CheckpointStore(fs, "/ckpt/run")
        commits: list[float] = []
        commit = writer.store.commit

        async def timed_commit(manifest):
            t = time.perf_counter()
            try:
                return await commit(manifest)
            finally:
                commits.append(time.perf_counter() - t)
        writer.store.commit = timed_commit
        cc.reset_launches()
        c0 = (codec.flushes, codec.batched_items, dict(codec.codec_counts))
        nodes0 = {nid: (ss.node.codec.batches, ss.node.codec.batched_items)
                  for nid, ss in cluster.storage.items()}
        with counted_lengths(host_codec, "crc32c") as host_lens:
            t0 = time.perf_counter()
            stats = await writer.save(1, tree, resume=False)
            save_wall = time.perf_counter() - t0
        flushes, items = codec.flushes - c0[0], codec.batched_items - c0[1]
        routes = {r: n - c0[2].get(r, 0) for r, n in codec.codec_counts.items()
                  if n - c0[2].get(r, 0)}
        steps["save"] = dict(cc.launches)
        expect(stats.stripes_total == stripes and stats.stripes_skipped == 0
               and stats.shards_retried == 0, f"[24] save: {stats}")
        expect(items == stripes and all(r.startswith("cuda-") for r in routes),
               f"[24] save: {items} codec items for {stripes} stripes, routes {routes}")
        expect(len(host_lens) == trimmed and all(n < cs for n in host_lens),
               f"[24] save: host CRC on {len(host_lens)} shards {host_lens[:8]}, "
               f"the {trimmed} trimmed tails expected")
        manifest = await store.load(1)
        expect(manifest.total_bytes() == logical, "[24] the manifest's byte count")
        per_node = {nid: (ss.node.codec.batches - nodes0[nid][0],
                          ss.node.codec.batched_items - nodes0[nid][1])
                    for nid, ss in sorted(cluster.storage.items())}
        log(f"[24] save: {stats.stripes_total} stripes, {stats.shards_written} shards "
            f"({stats.bytes_written / 2**20:.1f} MiB stored) in {save_wall:.3f} s: "
            f"{logical / save_wall / 1e6:.1f} MB/s of logical bytes; manifest commit "
            f"(temp file + rename) {commits[-1] * 1e3:.1f} ms; codec {flushes} flushes, "
            f"{items / max(flushes, 1):.2f} stripes a flush, routes {routes}; host CRC "
            f"on {len(host_lens)} trimmed tails ({sum(host_lens)} B), none on a whole "
            f"shard; B1 batches, items a batch per node: " + ", ".join(
                f"n{nid} {b} {it / max(b, 1):.2f}" for nid, (b, it) in per_node.items()))

        # 3. restore; 4. restore_shard with CKPT_READERS readers
        cc.reset_launches()
        t0 = time.perf_counter()
        got = await reader.restore()
        restore_wall = time.perf_counter() - t0
        expect(await asyncio.to_thread(same_leaves, tree, dict(flatten_tree(got)[0])),
               "[24] restore: a leaf's dtype, shape or bytes differ")
        del got
        t0 = time.perf_counter()
        parts = await asyncio.gather(*(reader.restore_shard(i, CKPT_READERS)
                                       for i in range(CKPT_READERS)))
        shard_wall = time.perf_counter() - t0
        paths = [p for part in parts for p in part]
        merged = {p: a for part in parts for p, a in part.items()}
        expect(len(paths) == len(set(paths)) == len(manifest.leaves),
               f"[24] restore_shard: {len(paths)} leaves, {len(set(paths))} distinct")
        expect(await asyncio.to_thread(same_leaves, tree, merged),
               "[24] restore_shard: a leaf differs")
        del parts, merged
        steps["restore"] = dict(cc.launches)
        log(f"[24] restore: {restore_wall:.3f} s, {logical / restore_wall / 1e6:.1f} "
            f"MB/s of logical bytes; restore_shard x{CKPT_READERS} readers (disjoint, "
            f"complete) {shard_wall:.3f} s, {logical / shard_wall / 1e6:.1f} MB/s")

        # 5. a re-save of the same step: the CRC probe skips every stripe
        cc.reset_launches()
        t0 = time.perf_counter()
        again = await writer.save(1, tree)
        resave_wall = time.perf_counter() - t0
        expect(again.stripes_skipped == again.stripes_total == stripes
               and again.shards_written == 0, f"[24] re-save: {again}")
        steps["resave"] = dict(cc.launches)
        log(f"[24] re-save of step 1: all {again.stripes_skipped} stripes skipped by "
            f"the CRC probe, {again.shards_skipped} shards, {resave_wall:.3f} s")

        # 6. a node fail-stops (two EC chains: RAID-6's limit); degraded restore
        await cluster.kill_storage_node(victim)
        await wait_state(lambda: all(
            cluster.chain(lay.shard_chain(0, s)).head() is None for s in lost),
            30.0, "EC chains of the killed node out of service", phase=24)
        await cluster.mgmtd_client.refresh()
        cc.reset_launches()
        dec0 = codec.codec_counts.get("cuda-decode-words", 0)
        t0 = time.perf_counter()
        got = await reader.restore()
        degraded_wall = time.perf_counter() - t0
        expect(await asyncio.to_thread(same_leaves, tree, dict(flatten_tree(got)[0])),
               "[24] degraded restore: a leaf differs")
        del got
        steps["degraded"] = dict(cc.launches)
        decodes = codec.codec_counts.get("cuda-decode-words", 0) - dec0
        expect(decodes > 0 or not on_card, "[24] the degraded restore decoded nothing")
        log(f"[24] degraded restore, node {victim} down (slots {lost}): "
            f"{degraded_wall:.3f} s, {logical / degraded_wall / 1e6:.1f} MB/s of logical "
            f"bytes, {decodes} fused decode calls")

        # 7. the node back on an empty disk (its replicated chains resync,
        # its EC chains come back empty); scrub until nothing is left
        shutil.rmtree(cluster.node_root(victim), ignore_errors=True)
        await cluster.start_storage_node(victim)
        await wait_state(lambda: fully_redundant(cluster), 300.0,
                         "full redundancy after the empty restart", phase=24)
        await cluster.mgmtd_client.refresh()
        cc.reset_launches()
        reports = []
        t0 = time.perf_counter()
        for _ in range(4):
            reports.append(await reader.scrub(1, repair=True))
            if not (reports[-1].shards_missing or reports[-1].shards_corrupt):
                break
        scrub_wall = time.perf_counter() - t0
        steps["scrub"] = dict(cc.launches)
        first, last = reports[0], reports[-1]
        holes = sum(int((lens[:, list(lost)] == 0).sum()) for lens, *_ in expected.values())
        expect(first.shards_missing == stripes * len(lost) - holes
               and first.shards_repaired == first.shards_missing
               and first.stripes_unrecoverable == 0 and len(reports) == 2
               and last.shards_missing == last.shards_corrupt == 0,
               f"[24] scrub: {reports}")
        rebuilt = first.shards_repaired * cs
        log(f"[24] scrub: {len(reports)} passes in {scrub_wall:.3f} s, "
            f"{first.shards_checked} shards checked a pass, {first.shards_missing} "
            f"missing, {first.shards_repaired} repaired ({rebuilt / 2**20:.1f} MiB, "
            f"{logical / scrub_wall / 1e6:.1f} MB/s of logical bytes audited, "
            f"{rebuilt / scrub_wall / 1e6:.1f} MB/s rebuilt), then clean: {last}")
        checked = await asyncio.to_thread(check_ckpt_shards, cluster, lay, manifest,
                                          tree, expected)
        log(f"[24] checks: {checked} stored shards byte for byte from each engine "
            f"against the leaves and the plain encode, ChunkMeta committed with the "
            f"native host CRC (whole shards also plain B1), holes absent, the "
            f"manifest's CRCs the same")

        # 8. a second step, then gc(keep_last=1): step 1's chunks go
        cc.reset_launches()
        t0 = time.perf_counter()
        stats2 = await writer.save(2, tree2)
        save2_wall = time.perf_counter() - t0
        got = await reader.restore(2)
        expect(await asyncio.to_thread(same_leaves, tree2, dict(flatten_tree(got)[0])),
               "[24] step 2 restore: a leaf differs")
        del got
        t0 = time.perf_counter()
        report = await store.gc(cluster.sc, keep_last=1)
        gc_ckpt_wall = time.perf_counter() - t0
        steps["step2"] = dict(cc.launches)
        expect(report.steps_removed == [1] and report.steps_kept == [2]
               and report.bytes_removed == logical
               and await store.list_steps() == [2], f"[24] gc: {report}")

        def step1_left() -> int:
            return sum(ec_target_engine(cluster, lay.shard_chain(s, j)).get_meta(
                lay.shard_chunk(lf.inode, s, j)) is not None
                for lf in manifest.leaves for s in range(lf.num_stripes)
                for j in range(K + M))
        left = await asyncio.to_thread(step1_left)
        expect(left == 0, f"[24] gc left {left} chunks of step 1")
        log(f"[24] step 2: {stats2.stripes_total} stripes saved in {save2_wall:.3f} s "
            f"({logical2 / save2_wall / 1e6:.1f} MB/s), manifest commit {commits[-1] * 1e3:.1f} ms; gc(keep_last=1) removed "
            f"step 1 ({report.leaves_removed} leaves, {report.bytes_removed} B) in "
            f"{gc_ckpt_wall:.3f} s, none of its chunks left")

        total: dict = {}
        for part in steps.values():
            add_launches(total, part)
        per_node = [(nid, ss.node.codec.batches, ss.node.codec.batched_items)
                    for nid, ss in sorted(cluster.storage.items())]
        log(f"[24] per node since its (re)start (B1 batches, items, items a batch): "
            + ", ".join(f"n{nid} {b}, {it}, {it / max(b, 1):.2f}"
                        for nid, b, it in per_node))
        log(f"[24] codec: {codec.flushes} flushes, {codec.batched_items} items, "
            f"{codec.batched_items / max(codec.flushes, 1):.2f} a flush; routes "
            f"{codec.codec_counts}; the byte-path CRC (B6) "
            f"{'ran' if total.get('crc_bytes') else 'did not run'}: trimmed tails "
            f"take the host CRC")
        log(f"[24] walls: save {save_wall:.3f} s, restore {restore_wall:.3f} s, "
            f"degraded {degraded_wall:.3f} s, scrub {scrub_wall:.3f} s; MB/s of "
            f"logical bytes: save {logical / save_wall / 1e6:.1f}, restore "
            f"{logical / restore_wall / 1e6:.1f}, degraded "
            f"{logical / degraded_wall / 1e6:.1f}, scrub {logical / scrub_wall / 1e6:.1f}")
        log(f"[24] launches: " + "; ".join(
            f"{k} {({n: c for n, c in v.items() if c})}" for k, v in steps.items())
            + f"; phase {total}")
        if on_card:
            from t3fs_torch.benchmarks.devbench import card_line

            log(f"[24] {card_line()}")
            expect_routes(codec, ("cuda-encode-words", "cuda-decode-words"))
            for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words"):
                expect(total.get(name, 0) > 0, f"[24] the checkpoint launched no {name}")
            expect(steps["save"].get("rs_raid6_words", 0) > 0
                   and steps["namespace"].get("crc_words", 0) > 0,
                   f"[24] launches: {steps}")
        return total
    finally:
        await ec.close()
        await cluster.stop()


def phase_ckpt_bench() -> None:
    """`t3fs_torch.benchmarks.ckpt_bench --runs 1 --kill --json` at its
    defaults, in this process: its result line parses, every route a cuda-*
    one, and its metric line last."""
    from t3fs_torch.benchmarks import ckpt_bench

    rc, lines = run_captured(ckpt_bench.main, ["--runs", "1", "--kill", "--json"],
                             phase=24)
    expect(rc == 0 and len(lines) >= 2, f"[24] ckpt_bench exit {rc}")
    result, metric = json.loads(lines[-2]), json.loads(lines[-1])
    expect(result["verified"] and result["save_MB_s"] > 0
           and result["restore_MB_s"] > 0 and result["degraded_restore_MB_s"] > 0
           and result["codec"] == "cuda"
           and all(r.startswith("cuda-") for r in result["codec_counts"]),
           f"[24] ckpt_bench: {result}")
    expect(set(metric["ckpt_metric"]) == {"rs8+2_save_MB_s", "restore_MB_s",
                                         "degraded_restore_MB_s"},
           f"[24] ckpt_bench metric line: {metric}")


# --- phase 25: the GraySort-analog through storage, the KVCache store and tier -

def node_batches(fabric) -> list[tuple[int, int]]:
    return [(n.codec.batches, n.codec.batched_items) for n in fabric.nodes]


def log_nodes(phase: str, per_node: list[tuple[int, int]], host: list[int]) -> None:
    log(f"[{phase}] per node (B1 batches, items, items per batch): " + ", ".join(
        f"n{i + 1} {b}, {it}, {it / max(b, 1):.2f}" for i, (b, it) in enumerate(per_node))
        + f"; payloads on the nodes' host CRC {len(host)} ({sum(host)} B, the "
        f"largest {max(host, default=0)} B)")


async def sort_job_run(backend: str, dev: torch.device, mb: int, workers: int,
                       parts: int, chunk: int) -> dict:
    """One run of sort_bench's job (`--sort-backend backend`) on a fresh
    in-process fabric (3 nodes, 1 replica, a CudaChecksumBackend a node on
    `dev`): the reference's checks inside `_run_job`; before its last
    cleanup every OUT file is read back and hashed.  Returns the result,
    the OUT hashes, the launches, the nodes' B1 batches and host CRCs, and
    the time inside the device sorter."""
    import hashlib

    from t3fs_torch.benchmarks import sort_bench as sb
    from t3fs_torch.benchmarks._env import make_env
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage import codec_backend
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend
    from t3fs_torch.storage.native_engine import NativeChunkEngine

    args = sb.parse_args(["--mb", str(mb), "--workers", str(workers),
                          "--partitions", str(parts), "--chunk-size", str(chunk),
                          "--sort-backend", backend]
                         + ([] if dev.type == "cuda" else ["--cpu"]))
    # the "cuda" backend a node, on `dev` (the CPU runs its plain versions)
    args.checksum_backend = lambda: CudaChecksumBackend(device=dev)
    env, sc, chains = await make_env(args)
    out_hashes: dict[int, str] = {}
    sorter_s: list[float] = []
    orig_sorter, orig_cleanup = sb.make_device_sorter, sb._cleanup_job_files
    cleanups = []

    def timed_sorter(device):
        sort_perm = orig_sorter(device)

        def timed(rows):
            t0 = time.perf_counter()
            perm = sort_perm(rows)
            sorter_s.append(time.perf_counter() - t0)
            return perm
        return timed

    async def hash_then_clean(args, sc, lay):
        if cleanups:
            for part in range(args.partitions):
                inode = sb.OUT_INODE + part
                n = await sc.query_last_chunk(lay, inode)
                data = (await sc.read_file_range(lay, inode, 0, n))[0] if n else b""
                out_hashes[part] = hashlib.sha256(data).hexdigest()
        cleanups.append(1)
        await orig_cleanup(args, sc, lay)

    try:
        expect(all(isinstance(t.engine, NativeChunkEngine) for n in env.nodes
                   for t in n.targets.values()), "[25] a target is not native")
        for node in env.nodes:
            await asyncio.to_thread(node.codec.warmup, [chunk])
        sb.make_device_sorter, sb._cleanup_job_files = timed_sorter, hash_then_clean
        with counted_lengths(codec_backend, "cpu_crc32c") as host:
            cc.reset_launches()
            result = await sb._run_job(args, sc, chains)
            launches = dict(cc.launches)
        return {"result": result, "out": out_hashes, "launches": launches,
                "nodes": node_batches(env), "host": list(host),
                "sorter_s": sorter_s}
    finally:
        sb.make_device_sorter, sb._cleanup_job_files = orig_sorter, orig_cleanup
        await sc.close()
        await env.stop()


async def phase_sort_job(dev: torch.device, mb: int = SORT_JOB_MB,
                         workers: int = SORT_JOB_WORKERS,
                         parts: int = SORT_JOB_PARTITIONS,
                         chunk: int = SORT_JOB_CHUNK) -> dict:
    """25a: sort_bench's GraySort-analog through the port's storage, with the
    device sorter, then with numpy, each on a fresh fabric.  Both pass the
    reference's checks and write the same OUT bytes.  Returns the device
    run's launches."""
    on_card = dev.type == "cuda"
    runs = {}
    for backend in ("device", "numpy"):
        r = await sort_job_run(backend, dev, mb, workers, parts, chunk)
        runs[backend] = r
        res = r["result"]
        log(f"[25] sort job --sort-backend {backend}: {res['records']} records "
            f"({res['bytes']} B), {workers} workers, {parts} partitions, "
            f"{chunk >> 10} KiB chunks, 3 nodes x 1 replica: phase1_s "
            f"{res['phase1_s']}, phase2_s {res['phase2_s']}, sort_wall_s "
            f"{res['sort_wall_s']}, sort_MB_s {res['sort_MB_s']} (host clock); "
            f"verified {res['verified']} (count, key XOR, every partition "
            f"sorted, boundaries in order); launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }"
            + (f"; inside the device sorter {sum(r['sorter_s']):.3f} s over "
               f"{len(r['sorter_s'])} partitions (columns, H2D, sort, D2H; the "
               f"largest {max(r['sorter_s'], default=0) * 1e3:.1f} ms)"
               if backend == "device" else ""))
        log_nodes("25", r["nodes"], r["host"])
    dev_run, np_run = runs["device"], runs["numpy"]
    walls = ("phase1_s", "phase2_s", "sort_wall_s", "sort_MB_s", "sort_backend")
    expect({k: v for k, v in dev_run["result"].items() if k not in walls}
           == {k: v for k, v in np_run["result"].items() if k not in walls},
           f"[25] the runs' results differ: {dev_run['result']} / {np_run['result']}")
    expect(len(dev_run["out"]) == parts and dev_run["out"] == np_run["out"],
           "[25] the device sort's OUT files differ from numpy's")
    expect(len(dev_run["sorter_s"]) > 0, "[25] the device sorter never ran")
    log(f"[25] the device run's {parts} OUT files equal the numpy run's byte for "
        f"byte (sha256)")
    if on_card:
        expect(dev_run["launches"].get("crc_words", 0) > 0,
               "[25] the sort job launched no B1")
    return dev_run["launches"]


async def phase_kvcache(dev: torch.device, blocks: int, value_size: int,
                        batch: int, concurrency: int, seconds: float) -> dict:
    """25b: kvcache_bench's phases (populate, batched random gets, GC removal
    of every key) through KVCacheStore on the bench's fabric (3 nodes, 3
    replicas, a CudaChecksumBackend a node unless on the CPU); then
    KV_CHECK_KEYS distinct seeded values put and read back exactly, a
    seeded prefix chain's longest_prefix, GC, and a miss for every key.
    Returns the bench's launches."""
    from t3fs_torch.benchmarks import kvcache_bench as kb
    from t3fs_torch.benchmarks._env import make_env
    from t3fs_torch.lib.kvcache import KVCacheConfig, KVCacheStore
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage import codec_backend
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)

    on_card = dev.type == "cuda"
    args = kb.parse_args(["--blocks", str(blocks), "--value-size", str(value_size),
                          "--batch", str(batch), "--concurrency", str(concurrency),
                          "--seconds", str(seconds)])
    args.checksum_backend = lambda: CudaChecksumBackend(device=dev)
    env, sc, chains = await make_env(args)
    block_cap = 1 << (args.value_size + 256 - 1).bit_length()
    kv = KVCacheStore(sc, chains, namespace=f"bench-{args.seed}",
                      config=KVCacheConfig(block_size=block_cap,
                                           gc_concurrency=args.concurrency))
    try:
        for node in env.nodes:
            if value_size >= DEFAULT_MIN_DEVICE_BYTES:
                await asyncio.to_thread(node.codec.warmup, [value_size + 64])
        with counted_lengths(codec_backend, "cpu_crc32c") as host:
            cc.reset_launches()
            res = await kb._run_phases(args, kv)
            launches = dict(cc.launches)
        per_node = node_batches(env)
        device_crcs = value_size >= DEFAULT_MIN_DEVICE_BYTES
        log(f"[25] kvcache_bench: {blocks} blocks of {value_size} B (block class "
            f"{block_cap} B), batch {batch}, concurrency {concurrency}, "
            f"{seconds:g} s of gets, 3 nodes x 3 replicas: populate_put_iops "
            f"{res['populate_put_iops']}, get_iops {res['get_iops']}, get_MB_s "
            f"{res['get_MB_s']}, get_p50_ms {res['get_p50_ms']}, get_p99_ms "
            f"{res['get_p99_ms']}, gc_remove_iops {res['gc_remove_iops']} (host "
            f"clock); get_miss {res['get_miss']}, gc_removed {res['gc_removed']}; "
            f"B1 launches {launches.get('crc_words', 0)}; "
            + ("every block's CRC on B1 on every hop" if device_crcs else
               "every CRC on the host (values under the nodes' 64 KiB device "
               "threshold)"))
        log_nodes("25", per_node, host)
        expect(res["get_miss"] == 0 and res["gc_removed"] == blocks
               and res["get_iops"] > 0, f"[25] kvcache_bench: {res}")
        if device_crcs:
            expect(all(it >= blocks for _, it in per_node)
                   and (launches.get("crc_words", 0) > 0 or not on_card),
                   f"[25] a node did not batch every block on B1: {per_node}")
        else:
            expect(all(b == 0 for b, _ in per_node) and not launches.get("crc_words")
                   and len(host) >= 3 * blocks,
                   f"[25] a small block's CRC left the host: {per_node}, {len(host)}")

        # exact bytes, a prefix chain and GC misses
        rng = np.random.default_rng(SEED + 25)
        keys = [f"check-{i}".encode() for i in range(KV_CHECK_KEYS)]
        values = [rng.bytes(int(n)) for n in rng.integers(
            value_size // 2, value_size + 1, KV_CHECK_KEYS)]
        await asyncio.gather(*(kv.put(k, v) for k, v in zip(keys, values)))
        got = await kv.get_many(keys)
        expect(got == values, "[25] a get returned other bytes than were put")
        blocks_chain = [rng.bytes(64) for _ in range(8)]
        chain = KVCacheStore.prefix_keys("dsv3-prefix", blocks_chain)
        for k, v in zip(chain[:5], values[:5]):
            await kv.put(k, v)
        n, vals = await kv.longest_prefix("dsv3-prefix", blocks_chain)
        expect(n == 5 and vals == values[:5], f"[25] longest_prefix {n} != 5")
        expect(await kv.remove_many(keys + chain[:5]) == KV_CHECK_KEYS + 5,
               "[25] GC did not remove every key")
        expect(all(v is None for v in await kv.get_many(keys + chain[:5])),
               "[25] a key was served after GC")
        expect((await kv.longest_prefix("dsv3-prefix", blocks_chain))[0] == 0,
               "[25] the prefix chain was served after GC")
        log(f"[25] {KV_CHECK_KEYS} seeded values read back exactly, longest_prefix "
            f"5 of 8 on a seeded chain, every key a miss after GC")
        return launches
    finally:
        await sc.close()
        await env.stop()


def phase_fleet(cpu: bool = False) -> None:
    """25c: `kvcache_fleet_bench` (the reference's CI smoke plus the
    admission A/B) in this process: its spawned workers run clients only;
    the host cell's tokens come from the shm arena and its peak stays
    within the window."""
    from t3fs_torch.benchmarks import kvcache_fleet_bench as fb

    rc, lines = run_captured(fb.main, FLEET_ARGS + (["--cpu"] if cpu else []),
                             phase=25)
    expect(rc == 0 and lines, f"[25] kvcache_fleet_bench exit {rc}")
    out = json.loads(lines[-1])
    on, off, adm = out["fleet"]["on"], out["fleet"]["off"], out["admission"]
    expect(on["sessions"] == off["sessions"] == 16 and on["puts"] > 0
           and off["put_p50_ms"] > 0, f"[25] fleet: {out['fleet']}")
    expect(out["gc"]["within_budget"] and out["gc"]["removed"] > 0,
           f"[25] fleet GC: {out['gc']}")
    host = adm["host"]
    expect(adm["bound_held"] and host["scope_effective"] == "host"
           and 0 < host["host_peak"] <= adm["window"],
           f"[25] host-scope admission: {adm}")
    log(f"[25] fleet: write-behind put p50 {on['put_p50_ms']} ms against "
        f"{off['put_p50_ms']} ms without ({out['put_p50_speedup']}x); GC removed "
        f"{out['gc']['removed']} within budget; admission: host scope on the shm "
        f"arena, peak {host['host_peak']} of window {adm['window']}, process "
        f"scope's concurrent peak {adm['process']['concurrent_held_peak']}")


async def phase_graysort_kvcache(dev: torch.device, sort_mb: int = SORT_JOB_MB,
                                 kv_blocks: int = KV_BLOCKS,
                                 dsv3_blocks: int = KV_DSV3_BLOCKS,
                                 kv_seconds: float = KV_SECONDS) -> dict:
    """Phase 25's storage parts on `dev`: 25a and 25b; returns their launches."""
    total: dict = {}
    t0 = time.perf_counter()
    add_launches(total, await phase_sort_job(dev, sort_mb))
    t1 = time.perf_counter()
    add_launches(total, await phase_kvcache(dev, kv_blocks, KV_VALUE, KV_BATCH,
                                            KV_CONCURRENCY, kv_seconds))
    add_launches(total, await phase_kvcache(dev, dsv3_blocks, KV_DSV3_VALUE,
                                            KV_DSV3_BATCH, KV_DSV3_CONCURRENCY,
                                            kv_seconds))
    log(f"[25] walls: the sort job's two runs {t1 - t0:.1f} s, the KVCache store "
        f"{time.perf_counter() - t1:.1f} s; launches {total}")
    return total


# --- phase 26: the usrbio ring data plane ----------------------------------------

def shm_line() -> str:
    """/dev/shm's size and free space: an over-large shm segment passes
    ftruncate on tmpfs and dies with SIGBUS on first touch."""
    import os

    try:
        st = os.statvfs("/dev/shm")
    except OSError as e:
        return f"/dev/shm: {e}"
    return (f"/dev/shm: {st.f_blocks * st.f_frsize / 2**20:.0f} MiB, "
            f"{st.f_bavail * st.f_frsize / 2**20:.0f} MiB free")


def shm_mapped() -> list[str]:
    """The usrbio shm segments (iovs and rings) this process still maps."""
    from pathlib import Path

    maps = Path("/proc/self/maps")
    if not maps.exists():
        return []
    return sorted({line.split(None, 5)[5] for line in maps.read_text().splitlines()
                   if "/t3fs-iov-" in line or "/t3fs-ior-" in line})


RING_CHILD = """
import sys
from t3fs_torch.lib import usrbio
ring = usrbio.IoRing(sys.argv[1], create=False)
iov = usrbio.IoVec(ring.iov_name, create=False)
left = int(sys.argv[2])
while left:
    sqes = ring.pop_sqes(max_n=64, timeout_ms=20000)
    if not sqes:
        sys.exit(3)
    for s in sqes:
        iov.write_at(s.iov_off, bytes([s.userdata & 0xFF]) * s.len)
    ring.complete_many([(s.userdata, s.len, 0) for s in sqes])
    left -= len(sqes)
iov.close(unlink=False)
ring.close()
"""


def ring_cross_process(waves: int = 2, per_wave: int = 32, block: int = 4096) -> None:
    """26: an app ring opened from a second process: this process preps and
    submits reads, the child pops them (a process-shared semaphore's wait),
    fills the iov slots and completes them; every CQE and byte checked."""
    import os
    import subprocess
    from pathlib import Path

    from t3fs_torch.lib import usrbio

    name = f"cs26-{os.getpid()}"
    iov = usrbio.IoVec(f"iov-{name}", waves * per_wave * block)
    ring = usrbio.IoRing(f"ring-{name}", entries=2 * per_wave, iov=iov)
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", RING_CHILD, f"ring-{name}",
                              str(waves * per_wave)], cwd=root, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        got = []
        for w in range(waves):
            for i in range(per_wave):
                u = w * per_wave + i
                ring.prep_io(True, 7, u * block, block, u * block, userdata=u + 1)
            ring.submit_ios()
            while len(got) < (w + 1) * per_wave:
                done = ring.wait_for_ios(max_n=per_wave, min_n=1, timeout_ms=60000)
                expect(bool(done), "[26] the second process completed nothing in 60 s")
                got += done
        out, _ = child.communicate(timeout=60)
        expect(child.returncode == 0, f"[26] the ring's second process: exit "
               f"{child.returncode}: {out}")
        expect(sorted(c.userdata for c in got) == list(range(1, waves * per_wave + 1))
               and all(c.result == block and c.status == 0 for c in got),
               "[26] cross-process CQEs")
        for c in got:
            u = c.userdata - 1
            expect(iov.read_at(u * block, block) == bytes([c.userdata & 0xFF]) * block,
                   f"[26] cross-process iov slot {u}")
        log(f"[26] an app ring opened from a second process: {len(got)} reads in "
            f"{waves} waves popped there (process-shared semaphores), every CQE and "
            f"iov byte checked; {time.perf_counter() - t0:.2f} s with the child's start")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        ring.close()
        iov.close()


def usrbio_args(dev: torch.device, block: int, file_size: int, extra=()):
    """usrbio_bench's arguments for one of phase 26's runs, its nodes'
    backend the CUDA one on `dev` (the CPU runs its plain versions)."""
    from t3fs_torch.benchmarks import usrbio_bench as ub
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend

    args = ub.parse_args([*USRBIO_ARGS, "--block-size", str(block), "--file-size",
                          str(file_size), *extra, *(["--cpu"] if dev.type == "cpu" else [])])
    args.checksum_backend = lambda: CudaChecksumBackend(device=dev)
    return args


def check_usrbio_cell(name: str, r: dict, aliased: bool | None, app_ios: int = 0) -> None:
    """One usrbio_bench run: no error, every read verified; on the rpc plane
    no SQE; on the ring plane no IO spilled to rpc, every SQE the clients
    sent taken by a node and none other, at least every IO of the run (the
    populate's chunk writes and every read, plus `app_ios` of each op; a
    retry sends one again), no address memoized as pre-ring, the client's
    plane up, every session's aliased bit as `aliased`."""
    ring = r["ring"]
    expect(r["errors"] == 0 and r.get("wrong_reads") == 0 and r["reads"] > 0,
           f"[26] {name}: {r['reads']} reads, {r['errors']} errors, "
           f"{r.get('wrong_reads')} wrong")
    if aliased is None:
        expect(ring["sqe_reads"] == ring["sqe_writes"] == ring["sent_reads"]
               == ring["sent_writes"] == 0 and not ring["aliased"],
               f"[26] {name}: the rpc plane took ring SQEs: {ring}")
        return
    expect(ring["spills"] == 0 and ring["sqe_reads"] == ring["sent_reads"]
           and ring["sqe_writes"] == ring["sent_writes"]
           and ring["sent_reads"] >= r["reads"] + app_ios
           and ring["sent_writes"] >= ring["populate_writes"] + app_ios,
           f"[26] {name}: ring SQEs {ring} for {r['reads']} reads, "
           f"{ring['populate_writes']} populate writes and {app_ios} app IOs each")
    expect(not ring["failed"] and ring["pre_ring"] == 0 and ring["aliased"]
           and all(a is aliased for a in ring["aliased"]),
           f"[26] {name}: {ring} (aliased should be {aliased})")


def log_usrbio_cell(name: str, r: dict) -> None:
    extra = (f", {r['doorbells']} doorbells, {r['ops_per_doorbell']} ops a doorbell, "
             f"{r['fallback_ops']} per-op" if r.get("cross_host") else "")
    log(f"[26] {name}: {r['iops']} IOPS, {r['MB_s']} MB/s, p50 {r['p50_ms']} ms, p99 "
        f"{r['p99_ms']} ms ({r['reads']} reads of {r['block_size']} B at depth "
        f"{r['depth']}, all verified); populate {r['populate_s']} s; the nodes' ring "
        f"SQEs {r['ring']['sqe_reads']} reads, {r['ring']['sqe_writes']} writes (as "
        f"the clients sent; {r['ring']['spills']} spills); aliased "
        f"{sorted(set(r['ring']['aliased']))}{extra}")


def phase_usrbio_small(dev: torch.device, file_size: int = USRBIO_SMALL_FILE) -> dict:
    """26a: usrbio_bench's documented 4 KiB random reads (depth 64, 5 s) in
    --data-plane-ab and --cross-host-ab, one trial a cell, over a
    `file_size` file: rpc against ring, shm against batched against per-op.
    Returns the cells' launches (none expected: 4 KiB CRCs are the host's)."""
    from t3fs_torch.benchmarks import usrbio_bench as ub
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage import codec_backend

    cc.reset_launches()
    with counted_lengths(codec_backend, "cpu_crc32c") as host:
        ab = ub.run_ab(usrbio_args(dev, USRBIO_SMALL_BLOCK, file_size))
        xh = ub.run_crosshost_ab(usrbio_args(dev, USRBIO_SMALL_BLOCK, file_size))
        launches = dict(cc.launches)
    cells = (("rpc", ab["rpc"], None), ("ring", ab["ring"], True),
             ("shm", xh["shm"], True), ("crosshost_batched", xh["crosshost_batched"], False),
             ("crosshost_perop", xh["crosshost_perop"], False))
    for name, r, aliased in cells:
        check_usrbio_cell(name, r, aliased)
        log_usrbio_cell(name, r)
    batched, perop = xh["crosshost_batched"], xh["crosshost_perop"]
    expect(batched["doorbells"] > 0 and batched["batched_ops"] > batched["doorbells"]
           and batched["fallback_ops"] == 0,
           f"[26] crosshost_batched: the batched transport did not carry it: {batched}")
    expect(perop["fallback_ops"] > 0 and perop["doorbells"] == 0,
           f"[26] crosshost_perop: not on per-op Buf RPCs: {perop}")
    log(f"[26] 4 KiB over {file_size >> 20} MiB: ring / rpc IOPS {ab['ring_vs_rpc_iops']}x, "
        f"crosshost batched / shm {xh['crosshost_batched_vs_shm_iops']}x, batched / "
        f"per-op {xh['batched_vs_perop_iops']}x; payloads on the nodes' host CRC "
        f"{len(host)} (the largest {max(host, default=0)} B), launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    expect(not launches.get("crc_words"), f"[26] a 4 KiB CRC left the host: {launches}")
    return launches


def check_usrbio_replicas(cluster, inode: int, chunk: int, expected: list[bytes],
                          host_crcs: list[int], b1: list[int], replicas: int) -> int:
    """Every chunk of the file on every replica (read from each engine):
    `replicas` copies an index, committed, the expected bytes, ChunkMeta's
    checksum equal to the native host CRC and plain B1.  Runs in a thread."""
    seen: dict[int, int] = {}
    for ss in cluster.storage.values():
        for t in ss.node.targets.values():
            for meta in t.engine.all_metas():
                if meta.chunk_id.inode != inode:
                    continue
                i = meta.chunk_id.index
                seen[i] = seen.get(i, 0) + 1
                expect(meta.length == chunk and meta.update_ver == meta.commit_ver
                       and meta.checksum == host_crcs[i] == b1[i],
                       f"[26] chunk {i} on node {ss.node.node_id}: {meta}, native "
                       f"{host_crcs[i]:#x}, plain B1 {b1[i]:#x}")
                expect(t.engine.read(meta.chunk_id) == expected[i],
                       f"[26] chunk {i} on node {ss.node.node_id}: stored bytes differ")
    expect(seen == {i: replicas for i in range(len(expected))},
           f"[26] replicas per chunk: {sorted(set(seen.values()))}, "
           f"{len(seen)} of {len(expected)} chunks")
    return sum(seen.values())


def phase_usrbio_big(dev: torch.device, block: int = USRBIO_BIG_BLOCK,
                     file_size: int = USRBIO_BIG_FILE,
                     app_writes: int = USRBIO_APP_WRITES) -> dict:
    """26b: usrbio_bench on the ring plane at the ring slot size: its
    populate rides the ring as plain inline WRITEs (B1 on every hop), its
    random reads take the service's awaited path (_ring_one); then
    `app_writes` whole-block OP_WRITEs through the app's IoRing, read back
    through it, and every chunk of both replicas checked.  Returns the
    run's launches."""
    from t3fs_torch.benchmarks import usrbio_bench as ub
    from t3fs_torch.ops import codec as host_codec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage import codec_backend
    from t3fs_torch.storage.codec_backend import DEFAULT_MIN_DEVICE_BYTES

    args = usrbio_args(dev, block, file_size, ["--data-plane", "ring"])
    n_chunks = file_size // block
    # the expected bytes and CRCs before any cluster starts
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 260)
    targets = sorted(int(i) for i in rng.choice(n_chunks, app_writes, replace=False))
    news = [rng.bytes(block) for _ in targets]
    blob = np.random.default_rng(args.seed).bytes(file_size)
    expected = [blob[i * block:(i + 1) * block] for i in range(n_chunks)]
    for i, data in zip(targets, news):
        expected[i] = data
    del blob
    host_crcs = [host_codec.crc32c(c) for c in expected]
    b1 = plain_crcs(expected, dev)
    log(f"[26] {n_chunks} chunks of {block >> 10} KiB and {app_writes} app writes: "
        f"data, native and plain B1 CRCs made in {time.perf_counter() - t0:.2f} s")
    facts: dict = {}

    async def after(cluster, fs, fh, iov, ring, ident, _blob):
        loop = asyncio.get_running_loop()

        async def wait_all(n: int) -> list:
            got = []
            while len(got) < n:
                done = await loop.run_in_executor(None, lambda: ring.wait_for_ios(
                    max_n=n, min_n=1, timeout_ms=60000))
                expect(bool(done), "[26] app ring: no completion in 60 s")
                got += done
            return got

        t = time.perf_counter()
        for j, (i, data) in enumerate(zip(targets, news)):
            iov.write_at(j * block, data)
            ring.prep_io(False, ident, j * block, block, i * block, userdata=j)
        ring.submit_ios()
        done = await wait_all(len(targets))
        expect(all(c.status == 0 and c.result == block for c in done),
               f"[26] app OP_WRITEs: {[c for c in done if c.status][:4]}")
        facts["write_s"] = time.perf_counter() - t
        for j in range(len(targets)):
            iov.write_at(j * block, bytes(block))
            ring.prep_io(True, ident, j * block, block, targets[j] * block,
                         userdata=1000 + j)
        ring.submit_ios()
        done = await wait_all(len(targets))
        expect(all(c.status == 0 and c.result == block for c in done),
               "[26] app OP_READs after the writes")
        expect(all(iov.read_at(j * block, block) == news[j] for j in range(len(targets))),
               "[26] an app write read back other bytes")
        facts["replicas"] = await asyncio.to_thread(
            check_usrbio_replicas, cluster, ident, block, expected, host_crcs, b1,
            args.replicas)
        facts["nodes"] = [(nid, ss.node.codec.batches, ss.node.codec.batched_items)
                          for nid, ss in sorted(cluster.storage.items())]

    async def run() -> dict:
        return await ub.run_bench(args, after=after)

    cc.reset_launches()
    with counted_lengths(codec_backend, "cpu_crc32c") as host:
        r = asyncio.run(run())
        launches = dict(cc.launches)
    check_usrbio_cell(f"{block >> 10} KiB ring", r, True, app_ios=app_writes)
    log_usrbio_cell(f"{block >> 10} KiB ring", r)
    log(f"[26] {block >> 10} KiB: populate {file_size >> 20} MiB in {r['populate_s']} s "
        f"({file_size / r['populate_s'] / 1e9:.3f} GB/s), reads {r['MB_s'] / 1e3:.3f} "
        f"GB/s; {app_writes} app OP_WRITEs in {facts['write_s']:.3f} s, read back; "
        f"{facts['replicas']} stored chunks checked byte for byte, committed, "
        f"ChunkMeta checksums equal to the native host CRC and plain B1; "
        f"per node (B1 batches, items, items a batch): " + ", ".join(
            f"n{nid} {b}, {it}, {it / max(b, 1):.2f}" for nid, b, it in facts["nodes"])
        + f"; host-CRC payloads {len(host)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    expect(not host or max(host) < DEFAULT_MIN_DEVICE_BYTES,
           f"[26] a {max(host, default=0)} B payload took the host CRC")
    if dev.type == "cuda":
        expect(launches.get("crc_words", 0) > 0, "[26] the 256 KiB ring writes launched no B1")
    return launches


async def phase_ring_riders(dev: torch.device, leaf_bytes: int = CKPT_LEAF_BYTES,
                            leaves: int = RING_CKPT_LEAVES, chunk_bytes: int = CKPT_CHUNK,
                            kv_blocks: int = RING_KV_BLOCKS,
                            kv_value: int = RING_KV_VALUE) -> dict:
    """26c: the ring's riders on one LocalCluster with meta (5 nodes, chains
    1-2 of 2 replicas, EC chains 3-12 of one: usrbio_bench's two chains of
    two, widened to RS(8+2) with a node down), its StorageClient on
    data_plane="ring" with an arena slot for every data shard of the tree:
    a seeded checkpoint saved (B2 + B1) and restored,
    KVCacheStore puts and get_many, one node fail-stopped and a degraded
    restore (B3 + B1).  Every IO the client sent rides the ring (counted at
    the client and as the nodes' SQEs), nothing spills to rpc.  Returns the
    launches."""
    from t3fs_torch.ckpt import CheckpointReader, CheckpointWriter, flatten_tree
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.fuse.vfs import FileSystem
    from t3fs_torch.lib.kvcache import KVCacheConfig, KVCacheStore
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend
    from t3fs_torch.testing.cluster import LocalCluster

    cs, on_card = chunk_bytes, dev.type == "cuda"
    rng = np.random.default_rng(SEED + 26)
    t0 = time.perf_counter()
    tree = ckpt_tree(rng, leaf_bytes, leaves, ())
    logical = sum(leaf_bytes_of(x).nbytes for _, x in flatten_tree(tree)[0])
    kv_keys = [f"ring-kv-{i}".encode() for i in range(kv_blocks)]
    kv_vals = [rng.bytes(kv_value) for _ in range(kv_blocks)]
    log(f"[26] riders: a {logical >> 20} MiB tree ({leaves} leaves) and {kv_blocks} "
        f"values of {kv_value >> 10} KiB made in {time.perf_counter() - t0:.2f} s")
    cluster = LocalCluster(num_nodes=5, replicas=2, num_chains=2, ec_chains=10,
                           with_meta=True,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev))
    await cluster.start()
    cluster.sc.cfg.data_plane = "ring"
    # an arena slot a data shard of the tree: the healthy restore reads
    # them all in one batch, and a smaller arena sends what does not fit to
    # rpc (arena pressure: the default 64 slots spilled 961 reads of a
    # 256 MiB tree); at least a slot a write channel and a window of stripe
    # reads
    cluster.sc.cfg.ring_slot_size = cs
    cluster.sc.cfg.ring_slots = max(-(-logical // cs), cluster.sc.cfg.num_channels,
                                    CKPT_WINDOW * K)
    codec = TorchECCodec(device=dev)
    ec = ECStorageClient(cluster.sc, codec=codec)
    fs = FileSystem(cluster.mc, cluster.sc)
    # every node, the one killed later included: its counters outlive it
    nodes = [ss.node for ss in cluster.storage.values()]

    def node_sqes() -> tuple[int, int]:
        return (sum(n.ring_reads for n in nodes), sum(n.ring_writes for n in nodes))
    try:
        lay = ECLayout.create(k=K, m=M, chunk_size=cs, chains=list(range(3, 13)))
        victim = 3
        lost = tuple(s for s in range(K + M) if cluster.chain(
            lay.shard_chain(0, s)).targets[0].node_id == victim)
        for ss in cluster.storage.values():
            await asyncio.to_thread(ss.node.codec.warmup, [cs])
        codec.warmup_decode([(tuple(s for s in range(K + M) if s not in lost)[:K], lost)],
                            cs, K, M)
        ring = cluster.sc._ring_plane()
        expect(ring is not None, "[26] the cluster's client has no ring plane")
        sent0 = dict(ring.sqes)
        steps: dict[str, dict] = {}
        walls: dict[str, float] = {}
        writer = CheckpointWriter(ec, fs, lay, "/ckpt/ring", window=CKPT_WINDOW,
                                  per_chain=CKPT_PER_CHAIN)
        reader = CheckpointReader(ec, fs, "/ckpt/ring", window=CKPT_WINDOW)

        async def step(name: str, coro):
            cc.reset_launches()
            t = time.perf_counter()
            out = await coro
            walls[name] = time.perf_counter() - t
            steps[name] = dict(cc.launches)
            return out
        before = node_sqes()
        stats = await step("save", writer.save(1, tree, resume=False))
        expect(stats.stripes_skipped == 0 and stats.shards_retried == 0,
               f"[26] ring save: {stats}")
        got = await step("restore", reader.restore())
        expect(await asyncio.to_thread(same_leaves, tree, dict(flatten_tree(got)[0])),
               "[26] ring restore: a leaf differs")
        del got

        kv = KVCacheStore(cluster.sc, [1, 2], namespace="ring-rider",
                          config=KVCacheConfig(block_size=1 << (kv_value + 256 - 1).bit_length()))
        kv_before = (ring.sqes["write"], ring.sqes["read"])
        await step("kv_put", asyncio.gather(*(kv.put(k, v) for k, v in zip(kv_keys, kv_vals))))
        kv_got = []

        async def gets():
            for s in range(0, kv_blocks, 32):
                kv_got.extend(await kv.get_many(kv_keys[s:s + 32]))
        await step("kv_get_many", gets())
        expect(kv_got == kv_vals, "[26] get_many on the ring returned other bytes")
        kv_ios = (ring.sqes["write"] - kv_before[0], ring.sqes["read"] - kv_before[1])
        expect(kv_ios[0] >= kv_blocks and kv_ios[1] >= kv_blocks and not ring.spills,
               f"[26] kvcache: {kv_ios} ring writes and reads for {kv_blocks} blocks, "
               f"{ring.spills} spills")

        await cluster.kill_storage_node(victim)
        await wait_state(lambda: all(
            cluster.chain(lay.shard_chain(0, s)).head() is None for s in lost),
            30.0, "EC chains of the killed node out of service", phase=26)
        await cluster.mgmtd_client.refresh()
        dec0 = codec.codec_counts.get("cuda-decode-words", 0)
        got = await step("degraded", reader.restore())
        expect(await asyncio.to_thread(same_leaves, tree, dict(flatten_tree(got)[0])),
               "[26] degraded ring restore: a leaf differs")
        del got
        decodes = codec.codec_counts.get("cuda-decode-words", 0) - dec0
        after = node_sqes()
        sqes = (after[0] - before[0], after[1] - before[1])
        sessions = [a for _, _, a in ring._sessions.values()]
        sent = (ring.sqes["read"] - sent0["read"], ring.sqes["write"] - sent0["write"])
        expect(ring.spills == 0, f"[26] riders spilled {ring.spills} IOs to rpc")
        expect(sqes == sent, f"[26] the nodes took {sqes} ring SQEs (reads, writes) "
               f"for the client's {sent}")
        expect(sessions and all(sessions) and not ring._no_ring
               and not cluster.sc._ring_state["failed"],
               f"[26] riders' sessions {sessions}, pre-ring {ring._no_ring}")
        total: dict = {}
        for part in steps.values():
            add_launches(total, part)
        per_node = [(nid, ss.node.codec.batches, ss.node.codec.batched_items)
                    for nid, ss in sorted(cluster.storage.items())]
        log(f"[26] riders on data_plane=ring: save {walls['save']:.3f} s "
            f"({logical / walls['save'] / 1e6:.1f} MB/s of logical bytes), restore "
            f"{walls['restore']:.3f} s ({logical / walls['restore'] / 1e6:.1f} MB/s), "
            f"degraded with node {victim} down (slots {lost}) {walls['degraded']:.3f} s "
            f"({logical / walls['degraded'] / 1e6:.1f} MB/s, {decodes} fused decodes); "
            f"KVCacheStore {kv_blocks} puts {walls['kv_put']:.3f} s, get_many "
            f"{walls['kv_get_many']:.3f} s ({kv_blocks / walls['kv_get_many']:.0f} gets/s), "
            f"every byte back")
        log(f"[26] riders' IOs: the client sent ring SQEs (reads, writes) {sent}, the "
            f"nodes took {sqes}, spills 0 (arena {cluster.sc.cfg.ring_slots} x "
            f"{cs >> 10} KiB); "
            f"{len(sessions)} sessions, all aliased; codec {codec.flushes} flushes, "
            f"{codec.batched_items / max(codec.flushes, 1):.2f} items a flush, routes "
            f"{codec.codec_counts}; per node (B1 batches, items, items a batch): "
            + ", ".join(f"n{nid} {b}, {it}, {it / max(b, 1):.2f}" for nid, b, it in per_node))
        log(f"[26] riders' launches: " + "; ".join(
            f"{k} {({n: c for n, c in v.items() if c})}" for k, v in steps.items()))
        if on_card:
            expect_routes(codec, ("cuda-encode-words", "cuda-decode-words"))
            expect(steps["save"].get("rs_raid6_words", 0) > 0
                   and steps["save"].get("crc_words", 0) > 0
                   and steps["degraded"].get("rs_reconstruct_words", 0) > 0,
                   f"[26] riders' launches: {steps}")
        return total
    finally:
        await ec.close()
        await cluster.stop()


def phase_scale_bench(cpu: bool = False) -> None:
    """26c: `kvcache_scale_bench --smoke --json` in this process: its hard
    gates hold and it ran on the ring plane."""
    from t3fs_torch.benchmarks import kvcache_scale_bench as ksb

    rc, lines = run_captured(ksb.main, ["--smoke", "--json"] + (["--cpu"] if cpu else []),
                             phase=26)
    expect(rc == 0 and lines, f"[26] kvcache_scale_bench exit {rc}")
    out = json.loads(lines[-1])
    gates = out["gates"]
    expect(out["data_plane"] == "ring" and out["wrong_bytes"] == 0
           and all(gates[g] for g in ("zero_wrong_bytes", "zero_lost_keys",
                                      "no_resurrected_dels", "bounded_replay")),
           f"[26] kvcache_scale_bench: data_plane {out['data_plane']}, gates {gates}")
    ab, last = out["compaction_ab"], out["curve"][-1]
    log(f"[26] kvcache_scale_bench --smoke on the {out['data_plane']} plane: "
        f"{out['sessions']} sessions over {out['tenants']} tenants, get p50 "
        f"{last['get_p50_ms']} ms, p99 {last['get_p99_ms']} ms; replay "
        f"{last['replay_s']} s over {last['replay_records']} records; compaction "
        f"replay {ab['before']['replay_s']} s -> {ab['after']['replay_s']} s "
        f"({ab['replay_speedup']}x, records {ab['record_ratio']}x fewer); gates {gates}")


def phase_usrbio(dev: torch.device) -> dict:
    """Phase 26 on `dev`: the cross-process ring, 26a, 26b and 26c; returns
    the launches of its main-path runs."""
    t0 = time.perf_counter()
    log(f"[26] {shm_line()}")
    ring_cross_process()
    total: dict = {}
    add_launches(total, phase_usrbio_small(dev))
    add_launches(total, phase_usrbio_big(dev))
    add_launches(total, asyncio.run(phase_ring_riders(dev)))
    phase_scale_bench(cpu=dev.type == "cpu")
    left = shm_mapped()
    expect(not left, f"[26] usrbio shm segments still mapped: {left}")
    log(f"[26] {shm_line()}; no usrbio segment left mapped")
    log(f"[26] phase: {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


# --- phase 27: BASELINE.json's harness, configs #1-#4 -------------------------

def harness_backend(dev: torch.device):
    """The nodes' checksum backend of a card run: "cuda", or on the CPU the
    same batching backend on B1's plain version."""
    if dev.type == "cuda":
        return "cuda"
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend
    return lambda: CudaChecksumBackend(device="cpu")


def stored_chunks(fabric, replicas_equal: bool) -> int:
    """Every chunk on every target of an in-process fabric, read from its
    engine: its length and native host CRC are its ChunkMeta's; with
    replicas_equal, the chain's replicas hold the same chunks and metas.
    Returns the chunks checked."""
    from t3fs_torch.ops.codec import crc32c

    per_node, n = [], 0
    for node in fabric.nodes:
        rows = {}
        for t in node.targets.values():
            for m in t.engine.all_metas():
                data = t.engine.read(m.chunk_id)
                expect(len(data) == m.length and crc32c(data) == m.checksum,
                       f"[27] node {node.node_id} chunk {m.chunk_id}: the stored "
                       f"checksum is not the host CRC of its bytes")
                rows[(m.chunk_id.inode, m.chunk_id.index)] = (
                    m.length, m.update_ver, m.commit_ver, m.checksum, data)
                n += 1
        per_node.append(rows)
    if replicas_equal:
        expect(all(r == per_node[0] for r in per_node[:fabric.replicas]),
               "[27] the chain's replicas differ")
    return n


def batches_line(nodes) -> str:
    """B1 batches, items and items a batch of each StorageNode (a node on
    the host CRC has no batches: 0)."""
    parts = []
    for node in nodes:
        b, it = getattr(node.codec, "batches", 0), getattr(node.codec, "batched_items", 0)
        parts.append(f"n{node.node_id} {b}, {it}, {it / max(b, 1):.2f}")
    return "per node (B1 batches, items, items a batch): " + ", ".join(parts)


def harness_write(dev: torch.device, host: bool) -> tuple[dict, dict]:
    """27a, config #1: storage_bench --mode write --nodes 1 --replicas 1
    --chunk-size 4 MiB on the card (host=False: B1 on every write) or on the
    host CRC (--cpu); every stored chunk's checksum against the host CRC of
    its bytes.  Returns the result and the launches."""
    from t3fs_torch.benchmarks import storage_bench as sb
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.testing.fabric import StorageFabric
    from t3fs_torch.testing.spies import checked_before_stop, spied

    args = sb.parse_args(["--mode", "write", "--nodes", "1", "--replicas", "1",
                          "--chunk-size", str(HARNESS_CHUNK), "--seconds",
                          str(HARNESS_SECONDS)] + (["--cpu"] if host else []))
    if not host:
        args.checksum_backend = harness_backend(dev)
    fabrics, checked = [], []
    t0 = time.perf_counter()
    with spied(StorageFabric, "start", fabrics), checked_before_stop(
            StorageFabric, lambda fab: checked.append(stored_chunks(fab, False))):
        cc.reset_launches()
        res = asyncio.run(sb.run_bench(args))
        launches = dict(cc.launches)
    label = "--cpu (host CRC)" if host else "the card (B1)"
    log(f"[27a] config #1 on {label}: {res['MB_s']} MB/s, {res['iops']} IOPS, "
        f"p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms, {res['ops']} ops, "
        f"{res['errors']} errors in {res['wall_s']} s; {checked} stored chunks "
        f"checked; {batches_line(fabrics[0].nodes)}; launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    expect(res["ops"] > 0 and res["errors"] == 0 and checked and checked[0] > 0,
           f"[27a] config #1 on {label}: {res}")
    b1 = fabrics[0].nodes[0].codec
    if host:
        expect(not any(launches.values()) and not getattr(b1, "batches", 0),
               "[27a] --cpu launched a kernel")
    else:
        expect(b1.batches > 0, "[27a] the node's backend batched nothing")
        expect(dev.type != "cuda" or launches["crc_words"] > 0,
               "[27a] B1 was not launched")
    return res, launches


def harness_pipelines(dev: torch.device) -> tuple[dict, dict]:
    """27b, config #2: the Makefile's write-bench (--write-ab, 4 MiB chunks,
    3 replicas, 16 ops) on the card; each pipeline's replicas checked equal
    and against the host CRC.  Returns the launches and the "off" run."""
    from t3fs_torch.benchmarks import storage_bench as sb
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.testing.fabric import StorageFabric
    from t3fs_torch.testing.spies import checked_before_stop

    modes = ("off", "overlap", "streamed")     # write_pipeline_ab's order
    seen = []
    t0 = time.perf_counter()
    with checked_before_stop(StorageFabric, lambda fab: seen.append(
            (stored_chunks(fab, True), batches_line(fab.nodes)))):
        cc.reset_launches()
        res = sb.write_pipeline_ab(value_size=HARNESS_CHUNK, num_ops=HARNESS_WRITE_OPS,
                                   replicas=3, checksum_backend=harness_backend(dev))
        launches = dict(cc.launches)
    expect(len(seen) == len(modes), f"[27b] {len(seen)} fabrics stopped, not 3")
    stored, nodes = ({m: v[i] for m, v in zip(modes, seen)} for i in (0, 1))
    for mode in modes:
        r = res[mode]
        log(f"[27b] config #2 write_pipeline={mode}: {r['ok']} ok, {r['errors']} "
            f"errors, {HARNESS_WRITE_OPS * HARNESS_CHUNK / r['wall_s'] / 1e6:.1f} MB/s "
            f"of client bytes ({r['wall_s']} s), p50 {r['p50_ms']} ms, p99 "
            f"{r['p99_ms']} ms, p50 against off {r.get('p50_vs_off', 1.0)}; "
            f"{stored[mode]} chunks checked over 3 equal replicas; {nodes[mode]}")
        expect(r["ok"] == HARNESS_WRITE_OPS and r["errors"] == 0
               and stored[mode] == 3 * (HARNESS_WRITE_OPS + 1),
               f"[27b] write_pipeline={mode}: {r}")
    expect(dev.type != "cuda" or launches["crc_words"] > 0, "[27b] B1 was not launched")
    log(f"[27b] launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches, res["off"]


def harness_economics(dev: torch.device) -> dict:
    """27c: codec_economics at its default chunk sizes; the batches the seam
    reached under storage_bench's load, then B1's device rate (CUDA-graph
    replays) and its host launch cost at each batch, the card's
    host-to-device rate, and the model table.
    Returns the launches of the batching runs."""
    from t3fs_torch.benchmarks import codec_economics as ce
    from t3fs_torch.ops import cuda_codec as cc

    t0 = time.perf_counter()
    measured = {}
    cc.reset_launches()
    for cs in ECON_SIZES:
        measured[f"chunk_{cs}"] = asyncio.run(ce.measure_batching(
            cs, HARNESS_SECONDS, 16, harness_backend(dev)))
    launches = dict(cc.launches)
    card = {f"chunk_{cs}": ce.measure_card(cs, measured[f"chunk_{cs}"]["items_per_batch"],
                                           dev) for cs in ECON_SIZES}
    h2d = ce.measure_h2d() if dev.type == "cuda" else None
    res = ce.report(measured, card, h2d, dev)
    for key, m in measured.items():
        c = card[key]
        log(f"[27c] {key}: write {m['write_MB_s']} MB/s, {m['batches']} B1 batches, "
            f"{m['batched_items']} items, {m['items_per_batch']} items a batch "
            f"({m['batch_bytes']} B); B1 at {c['rows']} x {c['chunk_words'] * 4} B: "
            f"{c['kernel_ms'] * 1e3:.2f} us on the device alone (graph-replayed), "
            f"{c['kernel_GBps']:.3f} GB/s of payload; host cost of one launch "
            f"{c['launch_us']:.2f} us")
        for link, row in res["model"][key].items():
            log(f"[27c]   {key} over {link}: serial {row['serial_GBps_at_measured_batch']} "
                f"GB/s, pipelined {row['pipelined_GBps_at_measured_batch']} GB/s "
                f"({row['pipelined_vs_line_rate']} of line rate), min batch for line "
                f"rate {row['serial_min_batch_for_line_rate']}")
        expect(m["batches"] > 0 and c["kernel_GBps"] > 0, f"[27c] {key}: {m}, {c}")
    log(f"[27c] host-to-device copy of {64 << 20} B pinned: {res['h2d_GBps']} GB/s; "
        f"batching runs' launches {launches}; {time.perf_counter() - t0:.1f} s")
    expect(dev.type != "cuda" or launches["crc_words"] > 0, "[27c] B1 was not launched")
    return launches


def harness_recovery(dev: torch.device) -> dict:
    """27d, configs #3 / #4: ec_recovery_bench at its defaults through its
    main (5 nodes, RS(8+2), 256 KiB chunks, 16 stripes: every stripe read
    back after the repair), its decode metric line last.  Returns the
    cluster phases' launches (those before the microbench)."""
    from t3fs_torch.benchmarks import ec_recovery_bench as ecb
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.testing.cluster import LocalCluster
    from t3fs_torch.testing.spies import spied

    before_micro: dict = {}
    orig = ecb.decode_microbench

    def micro(args, device="cuda"):
        before_micro.update(cc.launches)
        return orig(args, device)

    servers: list = []
    t0 = time.perf_counter()
    ecb.decode_microbench = micro
    try:
        with spied(LocalCluster, "start_storage_node", servers, result=True):
            cc.reset_launches()
            rc, lines = run_captured(ecb.main, ["--json"] + (
                [] if dev.type == "cuda" else ["--cpu", "--stripes", str(HARNESS_EC_STRIPES)]),
                phase=27)
    finally:
        ecb.decode_microbench = orig
    launches = before_micro or dict(cc.launches)
    expect(rc == 0, f"[27d] ec_recovery_bench failed: {lines[-1]}")
    res, metric = json.loads(lines[0]), json.loads(lines[-1])["decode_metric"]
    log(f"[27d] RS({res['k']}+{res['m']}) {res['chunk_size']} B chunks, "
        f"{res['stripes']} stripes: write {res['write_MB_s']} MB/s, degraded read "
        f"{res['degraded_read_MB_s']} MB/s, repair {res['repair_MB_s']} MB/s of "
        f"{res['repaired_shards']} shards (read {res['repair_bytes_read']} B for "
        f"{res['repair_bytes_repaired']} B); verified {res['verified']}; "
        f"{batches_line(ss.node for ss in servers)} (a restarted node twice); "
        f"cluster launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    expect(res["verified"] and res["repair_stripes_failed"] == 0
           and metric["degraded_read_MB_s"] == res["degraded_read_MB_s"] > 0,
           f"[27d] {res}")
    if dev.type == "cuda":
        expect(metric[f"rs{res['k']}+{res['m']}_reconstruct_GB_s"] > 0,
               "[27d] no fused decode rate")
        for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words"):
            expect(launches[name] > 0, f"[27d] {name} was not launched")
    return launches


def harness_drill(dev: torch.device, layout: str) -> dict:
    """27e: repair_drill_bench at the Makefile's repair-drill size on one
    layout: the node kill under live readers, subshard against full on
    identical damage, every read and cell verified.  Returns the launches."""
    from t3fs_torch.benchmarks import repair_drill_bench as drill
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.testing.cluster import LocalCluster
    from t3fs_torch.testing.spies import spied

    args = drill.parse_args(["--layout", layout, *DRILL_ARGS]
                            + ([] if dev.type == "cuda" else ["--cpu"]))
    servers: list = []
    t0 = time.perf_counter()
    with spied(LocalCluster, "start_storage_node", servers, result=True):
        cc.reset_launches()
        res = asyncio.run(drill.run_bench(args))
        launches = dict(cc.launches)
    log(f"[27e] {layout}: {res['lost_shards']} shards lost ({res['lost_bytes']} B), "
        f"repair_traffic_ratio {res['repair_traffic_ratio']}, verified "
        f"{res['verified']}, healthy p99 {res['healthy_p99_ms']} ms "
        f"({res['healthy_samples']} reads), read errors {res['read_errors']}")
    for c in res["cells"]:
        log(f"[27e]   {layout} {c['mode']} at budget {c['budget_mbps']} MB/s: read "
            f"{c['bytes_read']} B for {c['bytes_repaired']} B (x{c['read_amplification']}), "
            f"reduced {c['reduced_shards']}, full-k {c['fallback_shards']}, "
            f"{c['repair_s']} s, {c['repair_MB_s']} MB/s, paced waits {c['paced_waits']} "
            f"({c['paced_wait_s']} s), foreground p50 {c['fg_p50_ms']} / p99 "
            f"{c['fg_p99_ms']} ms over {c['fg_samples']}")
        expect(c["bytes_repaired"] == res["lost_bytes"], f"[27e] {layout} cell {c}")
    log(f"[27e] {layout}: {batches_line(ss.node for ss in servers)} (a restarted "
        f"node twice); codec {res['codec_stats']}; "
        f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    cells = {(c["mode"], c["budget_mbps"]): c for c in res["cells"]}
    limit = 0.5 if layout == "lrc-xor" else 0.7
    expect(res["verified"] and res["lost_shards"] > 0
           and res["repair_traffic_ratio"] is not None
           and res["repair_traffic_ratio"] < limit
           and cells[("subshard", 0.0)]["fallback_shards"] == 0
           and cells[("full", 0.0)]["reduced_shards"] == 0,
           f"[27e] {layout}: ratio {res['repair_traffic_ratio']}, cells {res['cells']}")
    if dev.type == "cuda":
        for name in ("crc_words", "repair_words"):
            expect(launches[name] > 0, f"[27e] {layout}: {name} was not launched")
    return launches


def phase_harness(dev: torch.device) -> tuple[dict, dict]:
    """Phase 27 on `dev`: 27a-27e; returns the launches of their main-path
    runs and config #2's "off" run."""
    t0 = time.perf_counter()
    total: dict = {}
    card, card_launches = harness_write(dev, host=False)
    host, _ = harness_write(dev, host=True)
    add_launches(total, card_launches)
    log(f"[27a] config #1, B1 against the host CRC on this host: "
        f"{card['MB_s'] / max(host['MB_s'], 1e-9):.3f}x")
    pipelines, config2 = harness_pipelines(dev)
    add_launches(total, pipelines)
    add_launches(total, harness_economics(dev))
    add_launches(total, harness_recovery(dev))
    for layout in ("lrc-xor", "pm-msr"):
        add_launches(total, harness_drill(dev, layout))
    log(f"[27] phase: {time.perf_counter() - t0:.1f} s; launches {total}")
    return total, config2


def dev_node_targets(routing, node_id: int) -> set[int]:
    return {t.target_id for ch in routing.chains.values() for t in ch.targets
            if t.node_id == node_id}


def dev_serving(routing, targets: set[int]) -> list[bool]:
    from t3fs_torch.mgmtd.types import PublicTargetState

    return [t.public_state == PublicTargetState.SERVING
            for ch in routing.chains.values() for t in ch.targets
            if t.target_id in targets]


async def dev_until(mgmtd, pred, timeout_s: float, what: str) -> float:
    """Seconds until pred(routing) holds, refreshing mgmtd's routing every
    20 ms: an event, never a fixed sleep."""
    t0 = time.perf_counter()
    while True:
        await mgmtd.refresh()
        if pred(mgmtd.routing()):
            return time.perf_counter() - t0
        expect(time.perf_counter() - t0 < timeout_s,
               f"[28] {what}: not within {timeout_s} s")
        await asyncio.sleep(0.02)


async def dev_check_replicas(mgmtd, files: dict, replicas: int,
                             phase: int = 28) -> int:
    """Every chunk of every target, read over the storage RPCs from the
    process that holds it: each chain's replicas hold the same chunks, each
    chunk's stored checksum is the native host CRC of its bytes, and every
    chunk of the files {inode: bytes} holds its slice.  Returns the chunks
    read."""
    from t3fs_torch.app.dev_cluster import read_replicas
    from t3fs_torch.net.client import Client
    from t3fs_torch.ops.codec import crc32c

    cli = Client()
    try:
        reps = await read_replicas(cli, mgmtd.routing())
    finally:
        await cli.close()
    by_chain: dict = {}
    n = 0
    for (chain_id, target_id), chunks in reps.items():
        rows = {}
        for key, (m, data) in chunks.items():
            expect(len(data) == m.length and crc32c(data) == m.checksum,
                   f"[{phase}] target {target_id} chunk {key}: the stored checksum "
                   f"is not the host CRC of its bytes")
            want = files.get(key[0])
            if want is not None:
                expect(data == want[key[1] * DEV_CHUNK:(key[1] + 1) * DEV_CHUNK],
                       f"[{phase}] target {target_id} chunk {key}: wrong bytes")
            rows[key] = (m.length, m.checksum, data)
            n += 1
        by_chain.setdefault(chain_id, []).append(rows)
    for chain_id, rows in by_chain.items():
        expect(len(rows) == replicas and all(r == rows[0] for r in rows),
               f"[{phase}] chain {chain_id}: its {len(rows)} replicas differ")
    for ino, data in files.items():
        held = sum(1 for rows in by_chain.values() for k in rows[0] if k[0] == ino)
        expect(held == -(-len(data) // DEV_CHUNK),
               f"[{phase}] inode {ino}: {held} chunks stored")
    return n


def meta_event_trace(phase: int) -> bool:
    """Whether meta can write its Parquet event trace here: it needs
    pyarrow, which the card's machine lacks; without it meta's events go
    to its log as JSON lines only."""
    import importlib.util

    if importlib.util.find_spec("pyarrow") is not None:
        return True
    log(f"[{phase}] no pyarrow on this host: meta starts with "
        "event_trace_path='' (its events as JSON log lines only)")
    return False


def timed_cluster(*a, **kw):
    """A DevCluster recording when each process was spawned (spawned) and
    when it first answered (ready), by name."""
    from t3fs_torch.app.dev_cluster import DevCluster

    class TimedCluster(DevCluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.spawned, self.ready = {}, {}

        def _spawn(self, name, module, cfg, env=None):
            self.spawned[name] = time.perf_counter()
            return super()._spawn(name, module, cfg, env)

        async def _wait_port(self, name, *a, **kw):
            addr = await super()._wait_port(name, *a, **kw)
            self.ready[name] = time.perf_counter()
            return addr

    return TimedCluster(*a, **kw)


def dev_monitor_rows(db_path: str) -> list[tuple]:
    import sqlite3

    con = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        return con.execute("SELECT node_type, node_id, COUNT(*) FROM metrics "
                           "GROUP BY node_type, node_id ORDER BY node_type, "
                           "node_id").fetchall()
    finally:
        con.close()


async def phase_dev_cluster(dev: torch.device, run_dir: str,
                            file_bytes: int = DEV_FILE_BYTES,
                            down_bytes: int = DEV_DOWN_FILE_BYTES,
                            bench_args: list[str] = DEV_BENCH_ARGS,
                            one_loop: dict | None = None) -> dict:
    """Phase 28: the port's DevCluster, each service its own process (the
    storage processes checksum on the card: B1), driven through the
    clients a user runs; one_loop is phase 27's config #2 ("off") of this
    run, printed beside storage_bench --mgmtd.  Returns what the storage
    processes counted."""
    import subprocess

    from t3fs_torch.client.meta_client import MetaClient
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
    from t3fs_torch.fuse.vfs import FileSystem

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 28)
    data = rng.integers(0, 256, file_bytes, dtype=np.uint8).tobytes()
    down = rng.integers(0, 256, down_bytes, dtype=np.uint8).tobytes()
    backend = "cuda" if dev.type == "cuda" else "cpu"
    c = timed_cluster(run_dir, num_storage=DEV_NODES, replicas=DEV_REPLICAS,
                      num_chains=DEV_CHAINS, with_meta=True, with_monitor=True,
                      chunk_size=DEV_CHUNK, checksum_backend=backend,
                      meta_event_trace=meta_event_trace(28))
    out: dict = {}
    mgmtd = None
    try:
        await c.start()
        for name in sorted(c.procs):
            log(f"[28] {name}: pid {c.procs[name].pid}, up in "
                f"{c.ready[name] - c.spawned[name]:.2f} s")
        log(f"[28] cluster up in {time.perf_counter() - t_phase:.1f} s: mgmtd "
            f"{c.mgmtd_address} (kv {c._kv_spec('mgmtd')}), meta {c.meta_address}, "
            f"monitor {c.monitor_address}; {DEV_NODES} storage processes on the "
            f"{backend} checksum backend")

        mgmtd = MgmtdClient(c.mgmtd_address, refresh_period_s=0.2)
        await mgmtd.start()
        sc = StorageClient(mgmtd.routing, config=StorageClientConfig(
            retry_backoff_s=0.1, max_retries=30), refresh_routing=mgmtd.refresh)
        meta = MetaClient([c.meta_address])
        fs = FileSystem(meta, sc)
        try:
            # (2) the file through FileSystem: write, read, every replica
            await fs.mkdirs("/p28")
            t0 = time.perf_counter()
            await fs.write_file("/p28/big", data)
            w = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = await fs.read_file("/p28/big")
            r = time.perf_counter() - t0
            expect(back == data, "[28] the file read back differs")
            files = {(await fs.stat("/p28/big")).inode_id: data}
            t0 = time.perf_counter()
            n = await dev_check_replicas(mgmtd, files, DEV_REPLICAS)
            log(f"[28] {file_bytes >> 20} MiB through FileSystem: write "
                f"{file_bytes / w / 1e6:.1f} MB/s of client bytes ({w:.2f} s), read "
                f"{file_bytes / r / 1e6:.1f} MB/s ({r:.2f} s); {n} stored chunks "
                f"over {DEV_CHAINS} chains x {DEV_REPLICAS} replicas read back over "
                f"the wire, equal and each checksum the host CRC "
                f"({time.perf_counter() - t0:.1f} s)")
            out.update(write_MB_s=file_bytes / w / 1e6, read_MB_s=file_bytes / r / 1e6)

            # (3) fail-stop storage2, then its restart
            victim = dev_node_targets(mgmtd.routing(), DEV_KILLED)
            await c.kill_node(f"storage{DEV_KILLED}", hard=True)
            reshape = await dev_until(
                mgmtd, lambda rt: not any(dev_serving(rt, victim)), 60,
                "the killed node's targets out of the serving sets")
            expect(await fs.read_file("/p28/big") == data,
                   "[28] the file read back differs with storage2 down")
            await fs.write_file("/p28/while_down", down)
            files[(await fs.stat("/p28/while_down")).inode_id] = down
            t0 = time.perf_counter()
            c.start_storage_node(DEV_KILLED)
            await c._wait_port(f"storage{DEV_KILLED}")
            up = time.perf_counter() - t0
            full = up + await dev_until(
                mgmtd, lambda rt: all(dev_serving(rt, {
                    t.target_id for ch in rt.chains.values() for t in ch.targets})),
                120, "every target back to SERVING")
            n = await dev_check_replicas(mgmtd, files, DEV_REPLICAS)
            log(f"[28] SIGKILL storage{DEV_KILLED}: chains reshaped in "
                f"{reshape:.3f} s (heartbeat timeout {c.heartbeat_timeout_s} s), the "
                f"file read back equal, {down_bytes >> 20} MiB written on the "
                f"survivors; restarted (pid {c.procs[f'storage{DEV_KILLED}'].pid}, "
                f"answering in {up:.2f} s), full redundancy {full:.3f} s after "
                f"the restart; {n} stored chunks read back, replicas equal")
            out.update(reshape_s=reshape, full_redundancy_s=full)
        finally:
            await meta.close_conn()
            await sc.close()

        # (4) storage_bench --mgmtd, as a user runs it, against this cluster
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "t3fs_torch.benchmarks.storage_bench",
                            "--mgmtd", c.mgmtd_address, *bench_args],
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                               filter(None, [os.path.dirname(os.path.abspath(
                                   __file__)), os.environ.get("PYTHONPATH")]))))
        expect(r.returncode == 0, f"[28] storage_bench --mgmtd failed: {r.stderr[-2000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        one = one_loop
        log(f"[28] storage_bench --mgmtd {' '.join(bench_args)}: {res['MB_s']} MB/s, "
            f"{res['ops']} ops, {res['errors']} errors, p50 {res['p50_ms']} ms, p99 "
            f"{res['p99_ms']} ms over {res['wall_s']} s; phase 27's config #2 in one "
            f"loop (write_pipeline off, this run): "
            + (f"{HARNESS_WRITE_OPS * HARNESS_CHUNK / one['wall_s'] / 1e6:.1f} MB/s, "
               f"p50 {one['p50_ms']} ms" if one else "not run")
            + f" ({time.perf_counter() - t0:.1f} s with the bench's start)")
        expect(res["ops"] > 0 and res["errors"] == 0, f"[28] storage_bench: {res}")
        out["bench"] = res

        # (5) the health plane: the scorecard rides mgmtd's routing, and
        # the monitor holds samples of every process that reports
        await dev_until(mgmtd, lambda rt: mgmtd.health is not None, 60,
                        "a scorecard in mgmtd's routing")
        h = mgmtd.health
        log(f"[28] mgmtd's routing carries the monitor's scorecard (version "
            f"{mgmtd._health_version}): " + (", ".join(
                f"{n.addr} node {n.node_id} {n.state}" for n in h.nodes)
                or "no node rows (the storage processes sample no spans)"))
        rows = dev_monitor_rows(c._path("metrics.sqlite"))
        seen = {(t, i) for t, i, _ in rows}
        want = {("mgmtd", 1), ("meta", 100)} | {
            ("storage", i) for i in range(1, DEV_NODES + 1)}
        log(f"[28] the monitor's sqlite: {rows}")
        expect(want <= seen, f"[28] no samples from {sorted(want - seen)}")
    finally:
        if mgmtd is not None:
            await mgmtd.stop()
        await c.stop()
    tails = {n: open(c._path(f"{n}.out")).read()[-600:]
             for n in ("mgmtd", "meta", "monitor") if os.path.exists(c._path(f"{n}.out"))}
    for name, tail in tails.items():
        expect("Traceback" not in tail, f"[28] {name} failed:\n{tail}")

    # (6) B1 in each storage process, as each logged at its stop
    from t3fs_torch.app.storage_main import read_codec_counters

    counters = {}
    for i in range(1, DEV_NODES + 1):
        got = read_codec_counters(c._path(f"storage{i}.log"))
        expect(got is not None, f"[28] storage{i} logged no counters at its stop")
        counters[i] = got
    log("[28] per storage process (B1 batches, items, items a batch, B1 "
        "launches; storage2 the restarted process): " + ", ".join(
            f"storage{i} {v['batches']}, {v['batched_items']}, "
            f"{v['batched_items'] / max(v['batches'], 1):.2f}, "
            f"{v['crc_words_launches']}" for i, v in counters.items()))
    if dev.type == "cuda":
        for i, v in counters.items():
            expect(v["backend"] == "cuda" and v["batches"] > 0
                   and v["crc_words_launches"] > 0,
                   f"[28] storage{i} ran no B1 batch: {v}")
    out["launches"] = {"crc_words": sum(v["crc_words_launches"]
                                        for v in counters.values())}
    return out


def phase_deployment(dev: torch.device, one_loop: dict | None = None) -> dict:
    """Phase 28 on `dev`: the multi-process cluster, then health_smoke's
    straggler check on LocalCluster(with_monitor=True); returns B1's
    launches in the storage processes."""
    import tempfile

    from t3fs_torch.benchmarks import health_smoke
    from t3fs_torch.benchmarks.devbench import card_line

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="t3fs-dev-") as run_dir:
        res = asyncio.run(phase_dev_cluster(dev, run_dir, one_loop=one_loop))
    hs = asyncio.run(health_smoke.measure("cuda" if dev.type == "cuda" else "cpu"))
    expect(hs["ok"], f"[28] health_smoke: {hs}")
    log(f"[28] health_smoke on LocalCluster(with_monitor=True): the 10 ms "
        f"straggler flagged in {hs['flagged_s']:.2f} s (bound "
        f"{hs['detect_bound_s']:.1f} s), cleared in {hs['cleared_s']:.2f} s "
        f"(bound {hs['clear_bound_s']:.1f} s)")
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"[28] phase: {time.perf_counter() - t0:.1f} s on {card}; storage "
        f"processes' launches {res['launches']}")
    return res["launches"]


async def kv_shard_rows(client, addresses: list[str]) -> list[dict]:
    """Each kv_main's rows by KeyPrefix (Kv.read_range over each prefix),
    its 2PC decision records by verdict, its seq and role (Kv.status)."""
    from t3fs_torch.kv.prefixes import KeyPrefix
    from t3fs_torch.kv.service import DEC_PREFIX, KvRangeReq

    out = []
    for addr in addresses:
        rows = {}
        for p in sorted(KeyPrefix, key=lambda p: p.value):
            rsp, _ = await client.call(addr, "Kv.read_range", KvRangeReq(
                begin=p.value, end=p.value + b"\xff"))
            if rsp.keys:
                rows[p.value.decode()] = len(rsp.keys)
        rsp, _ = await client.call(addr, "Kv.read_range", KvRangeReq(
            begin=DEC_PREFIX, end=DEC_PREFIX + b"\xff"))
        verdicts = [v[:1].decode() for v in rsp.values]
        st, _ = await client.call(addr, "Kv.status", None)
        out.append({"address": addr, "rows": rows,
                    "decisions": {v: verdicts.count(v) for v in "CA"},
                    "seq": st.seq, "primary": st.ok})
    return out


def shard_rows_line(shards: list[dict]) -> str:
    return "; ".join(
        f"kv{i} {s['address']}: seq {s['seq']}, rows "
        + (", ".join(f"{p} {n}" for p, n in s["rows"].items()) or "none")
        + f", 2PC decisions here {s['decisions']['C']} commit / "
        f"{s['decisions']['A']} abort"
        for i, s in enumerate(shards, 1))


async def phase_sharded_meta(dev: torch.device, run_dir: str,
                             file_bytes: int = SHARD_FILE_BYTES,
                             bench_args: list[str] = META_BENCH_ARGS,
                             acked_creates: int = SHARD_ACKED,
                             stream_acked: int = SHARD_STREAM_ACKED) -> dict:
    """Phase 29: meta over the range-sharded KV of two kv_main processes
    (DevCluster(kv_shards=2): a shards: spec split at the KeyPrefix
    boundaries, every meta op that touches both shards a cross-process
    2PC), the storage processes checksumming on the card (B1).  Returns
    what the storage processes counted and the phase's figures."""
    import subprocess

    from t3fs_torch.app.kv_main import read_recovered
    from t3fs_torch.app.storage_main import read_codec_counters
    from t3fs_torch.client.meta_client import MetaClient
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
    from t3fs_torch.fuse.vfs import FileSystem
    from t3fs_torch.net.client import Client
    from t3fs_torch.utils.status import StatusCode, StatusError

    t_phase = time.perf_counter()
    data = np.random.default_rng(SEED + 29).integers(
        0, 256, file_bytes, dtype=np.uint8).tobytes()
    backend = "cuda" if dev.type == "cuda" else "cpu"
    c = timed_cluster(run_dir, num_storage=DEV_NODES, replicas=DEV_REPLICAS,
                      num_chains=DEV_CHAINS, with_meta=True, durable=True,
                      kv_shards=SHARD_KV, chunk_size=DEV_CHUNK,
                      heartbeat_timeout_s=60.0, checksum_backend=backend,
                      meta_event_trace=meta_event_trace(29))
    out: dict = {}
    admin = Client()
    mgmtd = None
    try:
        await c.start()
        for name in sorted(c.procs):
            log(f"[29] {name}: pid {c.procs[name].pid}, up in "
                f"{c.ready[name] - c.spawned[name]:.2f} s")
        spec = next(line.split("=", 1)[1].strip().strip('"')
                    for line in open(c._path("meta.toml"))
                    if line.startswith("kv ="))
        expect(spec.startswith("shards:"), f"[29] meta's kv spec is {spec}")
        log(f"[29] cluster up in {time.perf_counter() - t_phase:.1f} s: mgmtd "
            f"{c.mgmtd_address}, meta {c.meta_address} over kv {spec} (kv1, "
            f"kv2 on {c._kv_spec('kv1')} and {c._kv_spec('kv2')}); "
            f"{DEV_NODES} storage processes on the {backend} checksum backend")
        kv_pids = {c.procs[f"kv{i}"].pid for i in range(1, SHARD_KV + 1)}
        for pid in kv_pids:
            env = open(f"/proc/{pid}/environ", "rb").read().split(b"\0")
            expect(b"CUDA_VISIBLE_DEVICES=" in env,
                   f"[29] kv_main pid {pid} runs with a GPU visible")

        # (1) meta_bench --mgmtd, as a user runs it, against this cluster
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "t3fs_torch.benchmarks.meta_bench",
                            "--mgmtd", c.mgmtd_address, *bench_args, "--json"],
                           capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                               filter(None, [os.path.dirname(os.path.abspath(
                                   __file__)), os.environ.get("PYTHONPATH")]))))
        expect(r.returncode == 0, f"[29] meta_bench --mgmtd failed: {r.stderr[-2000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        phases = ("mkdir", "create", "stat", "batch_stat", "list", "rename", "remove")
        log(f"[29] meta_bench --mgmtd {' '.join(bench_args)} ({res['total_files']} "
            f"files, {time.perf_counter() - t0:.1f} s with the bench's start): "
            + ", ".join(f"{p} {res[p]['ops_s']} ops/s ({res[p]['ops']} ops, "
                        f"{res[p]['wall_s']} s)" for p in phases)
            + f"; batch_stat {res['batch_stat']['inodes_s']} inodes/s")
        expect(all(res[p]["ops"] > 0 for p in phases), f"[29] meta_bench: {res}")
        out["meta_bench"] = {p: res[p]["ops_s"] for p in phases}

        # (2) both kv_main processes committed: rows and seqs
        shards = await kv_shard_rows(admin, c.kv_addresses)
        log(f"[29] after meta_bench: {shard_rows_line(shards)}")
        for i, sh in enumerate(shards, 1):
            expect(sh["rows"] and sh["seq"] > 0 and sh["primary"],
                   f"[29] kv{i} committed nothing: {sh}")
        expect(sum(sh["decisions"]["C"] for sh in shards) > 0,
               "[29] no cross-shard commit was decided")

        mgmtd = MgmtdClient(c.mgmtd_address, refresh_period_s=0.2)
        await mgmtd.start()
        sc = StorageClient(mgmtd.routing, config=StorageClientConfig(
            retry_backoff_s=0.1, max_retries=30), refresh_routing=mgmtd.refresh)
        meta = MetaClient([c.meta_address])
        fs = FileSystem(meta, sc)
        try:
            # (3) the data traffic: a file through FileSystem, on B1
            await fs.mkdirs("/p29")
            t0 = time.perf_counter()
            await fs.write_file("/p29/big", data)
            w = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = await fs.read_file("/p29/big")
            rd = time.perf_counter() - t0
            expect(back == data, "[29] the file read back differs")
            files = {(await fs.stat("/p29/big")).inode_id: data}
            n = await dev_check_replicas(mgmtd, files, DEV_REPLICAS, phase=29)
            log(f"[29] {file_bytes >> 20} MiB through FileSystem: write "
                f"{file_bytes / w / 1e6:.1f} MB/s ({w:.2f} s), read "
                f"{file_bytes / rd / 1e6:.1f} MB/s ({rd:.2f} s); {n} stored "
                f"chunks read back over the wire, replicas equal, each "
                f"checksum the host CRC")
            out.update(write_MB_s=file_bytes / w / 1e6, read_MB_s=file_bytes / rd / 1e6)

            # (4) durability: kv2 SIGKILLed amid creates, respawned over its WAL
            await meta.mkdirs("/p29/drill")
            acked: list[str] = []
            names = [f"/p29/drill/a{i:04d}" for i in range(acked_creates)]
            t0 = time.perf_counter()
            for i in range(0, len(names), 16):
                await asyncio.gather(*(meta.create(p) for p in names[i:i + 16]))
            acked += names
            log(f"[29] {len(names)} creates acknowledged in "
                f"{time.perf_counter() - t0:.2f} s")
            stop = asyncio.Event()
            failed: list[int] = []

            async def stream(k: int) -> None:
                j = 0
                while not stop.is_set():
                    p = f"/p29/drill/s{k}-{j:05d}"
                    j += 1
                    try:
                        await meta.create(p)
                    except StatusError as e:
                        failed.append(int(e.code))
                        return
                    acked.append(p)

            before = len(acked)
            writers = [asyncio.create_task(stream(k)) for k in range(SHARD_STREAM)]
            t0 = time.perf_counter()
            while len(acked) - before < stream_acked:
                expect(time.perf_counter() - t0 < 60 and not failed,
                       f"[29] the create stream stalled: {failed}")
                await asyncio.sleep(0.005)
            st, _ = await admin.call(c.kv_addresses[1], "Kv.status", None)
            await c.kill_node("kv2", hard=True)
            stop.set()
            await asyncio.wait_for(asyncio.gather(*writers), 120)
            log(f"[29] SIGKILL kv2 (seq {st.seq}) with {SHARD_STREAM} creates in "
                f"flight: {len(acked) - before} stream creates acknowledged, "
                f"{len(failed)} refused while it was down (codes "
                f"{sorted(set(failed))})")
            t0 = time.perf_counter()
            addr = await c.restart_kv_node(2)
            up = time.perf_counter() - t0
            expect(addr == c.kv_addresses[1], f"[29] kv2 came back on {addr}")
            while True:
                try:
                    await asyncio.wait_for(meta.create("/p29/drill/after"), 30)
                    break
                except StatusError as e:
                    expect(time.perf_counter() - t0 < 60,
                           f"[29] meta commits nothing after the respawn: {e}")
                    await asyncio.sleep(0.02)
            commit_s = time.perf_counter() - t0
            recovered = read_recovered(c._path("kv2.log"))
            expect(len(recovered) == 2, f"[29] kv2's recover_prepared lines: {recovered}")
            missing = []
            for i in range(0, len(acked), 64):
                got = await asyncio.gather(*(meta.stat(p) for p in acked[i:i + 64]),
                                           return_exceptions=True)
                missing += [(p, repr(g)) for p, g in zip(acked[i:i + 64], got)
                            if isinstance(g, BaseException)]
            expect(not missing, f"[29] {len(missing)} acknowledged creates lost: "
                   f"{missing[:8]}")
            ino = (await meta.stat("/p29/drill/a0000")).inode_id
            await meta.rename("/p29/drill/a0000", "/p29/renamed")
            expect((await meta.stat("/p29/renamed")).inode_id == ino,
                   "[29] the renamed file has another inode")
            try:
                await meta.stat("/p29/drill/a0000")
                expect(False, "[29] the rename left its source")
            except StatusError as e:
                expect(e.code == StatusCode.META_NOT_FOUND,
                       f"[29] stat after rename: {e}")
            st2, _ = await admin.call(addr, "Kv.status", None)
            log(f"[29] kv2 respawned over its WAL on {addr} (pid "
                f"{c.procs['kv2'].pid}), answering in {up:.2f} s at seq {st2.seq}, "
                f"recover_prepared re-armed {recovered[-1]['recovered']} prepared "
                f"txn(s), {recovered[-1]['resolved']} resolved through the decider "
                f"before it listened; meta's "
                f"next commit {commit_s:.3f} s after the respawn began; all "
                f"{len(acked)} acknowledged creates stat, and a cross-shard rename "
                f"committed")
            out.update(kv2_up_s=up, next_commit_s=commit_s, acked=len(acked),
                       **recovered[-1])
            shards = await kv_shard_rows(admin, c.kv_addresses)
            log(f"[29] at the end: {shard_rows_line(shards)}")
        finally:
            await meta.close_conn()
            await sc.close()
        if dev.type == "cuda":
            r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                "--format=csv,noheader"], capture_output=True,
                               text=True, timeout=60)
            pids = {int(x) for x in r.stdout.split() if x.strip().isdigit()}
            kv_pids = {c.procs[f"kv{i}"].pid for i in range(1, SHARD_KV + 1)}
            expect(not pids & kv_pids, f"[29] a kv_main holds a CUDA context: {pids}")
            log(f"[29] processes with a CUDA context per nvidia-smi: {sorted(pids)}; "
                f"the kv_main processes ({sorted(kv_pids)}) run with no GPU visible")
    finally:
        if mgmtd is not None:
            await mgmtd.stop()
        await admin.close()
        await c.stop()
    for n in ("mgmtd", "meta", "kv1", "kv2"):
        tail = open(c._path(f"{n}.out")).read()[-600:]
        expect("Traceback" not in tail, f"[29] {n} failed:\n{tail}")

    counters = {}
    for i in range(1, DEV_NODES + 1):
        got = read_codec_counters(c._path(f"storage{i}.log"))
        expect(got is not None, f"[29] storage{i} logged no counters at its stop")
        counters[i] = got
    log("[29] per storage process (B1 batches, items, B1 launches): " + ", ".join(
        f"storage{i} {v['batches']}, {v['batched_items']}, {v['crc_words_launches']}"
        for i, v in counters.items()))
    if dev.type == "cuda":
        for i, v in counters.items():
            expect(v["backend"] == "cuda" and v["batches"] > 0
                   and v["crc_words_launches"] > 0,
                   f"[29] storage{i} ran no B1 batch: {v}")
    out["launches"] = {"crc_words": sum(v["crc_words_launches"]
                                        for v in counters.values())}
    return out


def phase_sharded(dev: torch.device) -> dict:
    """Phase 29 on `dev`: meta over two kv_main shards, then, while the
    phase stays inside SHARD_BUDGET_S, kv_distributor_bench --smoke;
    returns the phase's figures, B1's launches in the storage processes
    under "launches"."""
    import tempfile

    from t3fs_torch.benchmarks import kv_distributor_bench as kdb
    from t3fs_torch.benchmarks.devbench import card_line

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="t3fs-shard-") as run_dir:
        res = asyncio.run(phase_sharded_meta(dev, run_dir))
    left = SHARD_BUDGET_S - (time.perf_counter() - t0)
    if left > 40:
        t1 = time.perf_counter()
        rc = asyncio.run(kdb.main_async(kdb.parse_args(SHARD_DIST_ARGS)))
        expect(rc == 0, "[29] kv_distributor_bench --smoke failed a gate")
        log(f"[29] kv_distributor_bench {' '.join(SHARD_DIST_ARGS)}: every gate "
            f"passed ({time.perf_counter() - t1:.1f} s)")
    else:
        log(f"[29] kv_distributor_bench not run: {left:.0f} s of the phase's "
            f"{SHARD_BUDGET_S:.0f} s left (the CPU tests run its --smoke)")
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"[29] phase: {time.perf_counter() - t0:.1f} s on {card}; meta_bench "
        f"ops/s {res['meta_bench']}; kv2 answering {res['kv2_up_s']:.2f} s and "
        f"meta's next commit {res['next_commit_s']:.3f} s after its respawn; "
        f"storage processes' launches {res['launches']}")
    return res


# --- phase 32: an operator's session through the port's admin CLI ------------

OPS_FILE_BYTES = 64 << 20      # the operator's file: 64 chunks of DEV_CHUNK
OPS_CHAINS = 10                # DevCluster chains of 3: one a shard of RS(8+2)
OPS_CKPT = "/ckpts/run"
OPS_LOST_SLOT = 2              # the data shard of step 20's stripe 0 removed


async def admin_cmd(ctx, parser, *argv, lines: int = 3) -> str:
    """One command through the port's CLI (its build_parser and dispatch) in
    this loop, its stdout captured; logs the command, its wall and its first
    lines, and fails the phase on a non-zero return."""
    from t3fs_torch.cli import admin

    args = parser.parse_args([str(a) for a in argv])
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = await admin.dispatch(ctx, args)
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = buf.getvalue()
    log(f"[32] $ t3fs-admin {' '.join(map(str, argv))}  ({wall_ms:.1f} ms)")
    for line in out.splitlines()[:lines]:
        log(f"[32]   {line}")
    expect(rc == 0, f"[32] {argv[0]} returned {rc}: {out[-600:]}")
    return out


def read_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def sweep_counts(out: str) -> tuple[int, int, int]:
    """(ok, bad, errors) of a checksum-sweep line."""
    import re

    m = re.search(r": (\d+) ok, (\d+) bad, (\d+) errors", out)
    expect(m is not None, f"[32] no sweep counts in {out!r}")
    return int(m[1]), int(m[2]), int(m[3])


def verify_counts(out: str) -> dict:
    """The key=value counts of a ckpt-verify line."""
    import re

    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", out)}


async def phase_operator_session(dev: torch.device, run_dir: str,
                                 file_bytes: int = OPS_FILE_BYTES,
                                 leaf_bytes: int = CKPT_LEAF_BYTES,
                                 chunk_bytes: int = DEV_CHUNK) -> dict:
    """Phase 32: an operator's session through the port's admin CLI against
    the port's DevCluster (its storage processes on B1), the CLI's
    ckpt-verify codec a TorchECCodec on `dev`; the module entry point once
    as a subprocess.  Returns the launches: this process's during the
    session, and B1's in each storage process from its log."""
    import subprocess

    from t3fs_torch.app.storage_main import read_codec_counters
    from t3fs_torch.ckpt import CheckpointReader, CheckpointStore, CheckpointWriter
    from t3fs_torch.cli import admin
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.codec import crc32c
    from t3fs_torch.storage.types import UpdateType

    t_phase = time.perf_counter()
    backend = "cuda" if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(SEED + 32)
    data = rng.integers(0, 256, file_bytes, dtype=np.uint8).tobytes()
    local = os.path.join(run_dir, "ops.bin")
    await asyncio.to_thread(write_file, local, data)
    leaves = {step: rng.standard_normal(leaf_bytes // 4, dtype=np.float32)
              for step in (10, 20)}
    c = timed_cluster(os.path.join(run_dir, "cluster"), with_meta=True,
                      with_monitor=True, num_chains=OPS_CHAINS,
                      chunk_size=chunk_bytes, checksum_backend=backend,
                      meta_event_trace=meta_event_trace(32))
    parser = admin.build_parser()
    writer_codec = TorchECCodec(device=backend)
    ctx = None
    out: dict = {}
    try:
        await c.start()
        ctx = admin.AdminContext(c.mgmtd_address, c.meta_address,
                                 c.monitor_address, device=backend)
        log(f"[32] DevCluster up {time.perf_counter() - t_phase:.1f} s into the "
            f"phase (its data made first): {c.num_storage} storage processes on "
            f"the {backend} checksum backend, {OPS_CHAINS} chains of "
            f"{c.replicas}, {chunk_bytes >> 10} KiB chunks, WAL KV, meta and "
            f"monitor; each process answering after (s): " + ", ".join(
                f"{n} {c.ready[n] - c.spawned[n]:.1f}" for n in sorted(c.ready)))
        # both codecs built and warmed off the loop before the session's clock
        lost_present = tuple(s for s in range(K + M) if s != OPS_LOST_SLOT)[:K]
        for codec in (ctx.ec_codec(), writer_codec):
            await codec.encode_verified(np.zeros((K, chunk_bytes), np.uint8), K, M)
            await asyncio.to_thread(codec.warmup_decode,
                                    [(lost_present, (OPS_LOST_SLOT,))], chunk_bytes)
        fs, sc = await ctx.fs(), await ctx.storage_client()
        s1 = (await ctx.mgmtd_client()).routing().node_address(1)
        cc.reset_launches()
        t_session = time.perf_counter()

        # (1) the cluster
        for argv in (("list-nodes",), ("lease",), ("routing",),
                     ("cluster-health",), ("config-versions",),
                     ("client-sessions",), ("space-info", s1), ("app-info", s1),
                     ("get-config", s1),
                     ("verify-config", s1, "resync_period_s=0.5"),
                     ("hot-update-config", s1, "resync_period_s=0.5"),
                     ("gen-chains", "--nodes", "1,2,3", "--chains", OPS_CHAINS)):
            await admin_cmd(ctx, parser, *argv)

        # (2) files: the seeded file up, its metadata, back, its CRC, trash
        await admin_cmd(ctx, parser, "mkdir", "/ops")
        await admin_cmd(ctx, parser, "put", local, "/ops/blob")
        await admin_cmd(ctx, parser, "ls", "/ops")
        st = await admin_cmd(ctx, parser, "stat", "/ops/blob")
        expect(f"length={file_bytes}" in st, f"[32] stat: {st}")
        await admin_cmd(ctx, parser, "chmod", "/ops/blob", "640")
        await admin_cmd(ctx, parser, "chown", "/ops/blob", 7, 8)
        got = os.path.join(run_dir, "got.bin")
        await admin_cmd(ctx, parser, "get", "/ops/blob", got)
        expect(await asyncio.to_thread(read_file, got) == data,
               "[32] get: the bytes differ")
        crc = crc32c(data)
        out_crc = await admin_cmd(ctx, parser, "checksum", "/ops/blob")
        expect(f"crc32c={crc:#010x} length={file_bytes}" in out_crc,
               f"[32] checksum {out_crc!r}, the host CRC {crc:#010x}")
        await admin_cmd(ctx, parser, "mv", "/ops/blob", "/ops/blob2")
        moved = await admin_cmd(ctx, parser, "trash-put", "/ops/blob2")
        path = moved.split(" -> ")[1].strip()
        await admin_cmd(ctx, parser, "trash-ls")

        # (3) storage: chunk metadata, sweeps, a FillZero repair
        ino = await fs.stat(path)
        routing = (await ctx.mgmtd_client()).routing()
        sweeps = {}
        for chain in sorted(set(ino.layout.chains)):
            head = routing.node_address(routing.chains[chain].head().node_id)
            meta_out = await admin_cmd(ctx, parser, "dump-chunkmeta", head, chain)
            chunks = len(meta_out.strip().splitlines()) - 1
            for idx in (0, 1, file_bytes // chunk_bytes - 1):
                await admin_cmd(ctx, parser, "query-chunk", head, chain,
                                ino.inode_id, idx)
            ok, bad, errors = sweep_counts(await admin_cmd(
                ctx, parser, "checksum-sweep", chain))
            expect((ok, bad, errors) == (chunks, 0, 0),
                   f"[32] sweep of chain {chain}: {ok} ok, {bad} bad, {errors} "
                   f"errors of {chunks} chunks")
            sweeps[chain] = chunks
        first = ino.layout.chains[0]
        await admin_cmd(ctx, parser, "fill-zero", first, ino.inode_id, 0, 2,
                        "--chunk-size", chunk_bytes)
        await admin_cmd(ctx, parser, "get", path, got)
        back = await asyncio.to_thread(read_file, got)
        zeroed = 2 * chunk_bytes
        expect(back[:zeroed] == bytes(zeroed) and back[zeroed:] == data[zeroed:],
               "[32] after fill-zero: [0, 2 chunks) not zeros or the rest changed")
        for chain in sweeps:
            ok, bad, errors = sweep_counts(await admin_cmd(
                ctx, parser, "checksum-sweep", chain))
            expect(bad == 0 and errors == 0 and ok == sweeps[chain],
                   f"[32] sweep after fill-zero: {ok} ok, {bad} bad, {errors} errors")

        # (4) the quick bench at its defaults
        bench = await admin_cmd(ctx, parser, "bench")
        expect(bench.startswith("write: "), f"[32] bench: {bench}")
        out["bench"] = bench.strip()

        # (5) checkpoints: two steps saved here, inspected, one shard lost
        # and repaired through the CLI, restored, the older step reclaimed
        lay = ECLayout.create(k=K, m=M, chunk_size=chunk_bytes,
                              chains=list(range(1, OPS_CHAINS + 1)))
        ec_w = ECStorageClient(sc, codec=writer_codec)
        writer = CheckpointWriter(ec_w, fs, lay, OPS_CKPT)
        t0 = time.perf_counter()
        for step, leaf in leaves.items():
            await writer.save(step, {"w": leaf})
        log(f"[32] steps 10 and 20 saved ({2 * leaf_bytes >> 20} MiB of float32 at "
            f"RS({K}+{M}), {chunk_bytes >> 10} KiB chunks): "
            f"{time.perf_counter() - t0:.2f} s; the writer's routes "
            f"{dict(writer_codec.codec_counts)}")
        await admin_cmd(ctx, parser, "ckpt-list", OPS_CKPT)
        st = await admin_cmd(ctx, parser, "ckpt-stat", OPS_CKPT, "--step", 10)
        expect(f"rs=({K}+{M})" in st, f"[32] ckpt-stat: {st}")
        v = verify_counts(await admin_cmd(ctx, parser, "ckpt-verify", OPS_CKPT))
        expect(v["missing"] == v["corrupt"] == v["unrecoverable"] == 0,
               f"[32] ckpt-verify: {v}")
        man = await CheckpointStore(fs, OPS_CKPT).load(20)
        lf = man.leaves[0]
        cid = man.layout.shard_chunk(lf.inode, 0, OPS_LOST_SLOT)
        r = await sc.write_chunk(man.layout.shard_chain(0, OPS_LOST_SLOT), cid, 0,
                                 b"", chunk_bytes, update_type=UpdateType.REMOVE)
        expect(r.status.code == 0, f"[32] REMOVE of {cid}: {r.status}")
        removed = 1
        v = verify_counts(await admin_cmd(ctx, parser, "ckpt-verify", OPS_CKPT,
                                          "--step", 20, "--repair"))
        expect(v["missing"] >= 1 and v["repaired"] == removed
               and v["unrecoverable"] == 0, f"[32] ckpt-verify --repair: {v}")
        v = verify_counts(await admin_cmd(ctx, parser, "ckpt-verify", OPS_CKPT,
                                          "--step", 20))
        expect(v["missing"] == 0 and v["corrupt"] == 0,
               f"[32] ckpt-verify after the repair: {v}")
        tree = await CheckpointReader(ECStorageClient(sc, codec=writer_codec), fs,
                                      OPS_CKPT).restore(20)
        expect(np.asarray(tree["w"]).tobytes() == leaves[20].tobytes(),
               "[32] step 20 restored differs")
        gc_out = await admin_cmd(ctx, parser, "ckpt-gc", OPS_CKPT, "--keep", 1)
        expect("kept=[20] removed=[10]" in gc_out, f"[32] ckpt-gc: {gc_out}")
        line = (await admin_cmd(ctx, parser, "ckpt-verify", OPS_CKPT)).strip()
        routes = dict(ctx.ec_codec().codec_counts)
        out["session_s"] = time.perf_counter() - t_session
        out["launches"] = dict(cc.launches)
        log(f"[32] the CLI's codec routes (warm-ups included) {routes}; this "
            f"process's launches in the session {out['launches']}")
        if dev.type == "cuda":
            expect(any(k.startswith("cuda-") for k in routes)
                   and all(k.startswith("cuda-") for k in routes),
                   f"[32] ckpt-verify's codec took no cuda-* route: {routes}")

        # (6) the module entry point, as an operator runs it (the card's
        # codec unless --cpu)
        t0 = time.perf_counter()
        r = await asyncio.to_thread(
            subprocess.run, [sys.executable, "-m", "t3fs_torch.cli.admin", "--mgmtd",
             c.mgmtd_address, "--meta", c.meta_address,
             *(["--cpu"] if dev.type == "cpu" else []), "ckpt-verify", OPS_CKPT],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
                HERE, os.environ.get("PYTHONPATH")]))))
        log(f"[32] $ python -m t3fs_torch.cli.admin ... ckpt-verify {OPS_CKPT}: "
            f"rc {r.returncode} in {time.perf_counter() - t0:.1f} s: "
            f"{r.stdout.strip()}")
        expect(r.returncode == 0 and r.stdout.strip() == line,
               f"[32] the entry point: rc {r.returncode}, {r.stdout!r} (in "
               f"process: {line!r}); {r.stderr[-1500:]}")

        # (7) cleanup
        await admin_cmd(ctx, parser, "rm", "-r", "/ops")
        await admin_cmd(ctx, parser, "trash-clean")
    finally:
        if ctx is not None:
            await ctx.close()
        await writer_codec.close()
        await c.stop()
    counters = {}
    for i in range(1, c.num_storage + 1):
        got = read_codec_counters(c._path(f"storage{i}.log"))
        expect(got is not None, f"[32] storage{i} logged no counters at its stop")
        counters[i] = got
    log("[32] per storage process (B1 batches, items, B1 launches): " + ", ".join(
        f"storage{i} {v['batches']}, {v['batched_items']}, {v['crc_words_launches']}"
        for i, v in counters.items()))
    if dev.type == "cuda":
        for i, v in counters.items():
            expect(v["backend"] == "cuda" and v["crc_words_launches"] > 0,
                   f"[32] storage{i} launched no B1: {v}")
    add_launches(out["launches"], {"crc_words": sum(
        v["crc_words_launches"] for v in counters.values())})
    return out


def phase_operator(dev: torch.device) -> dict:
    """Phase 32 on `dev`; returns its launches (this process's in the
    session and the storage processes')."""
    import tempfile

    from t3fs_torch.benchmarks.devbench import card_line

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="t3fs-ops-") as run_dir:
        res = asyncio.run(phase_operator_session(dev, run_dir))
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"[32] bench: {res['bench']}")
    log(f"[32] phase: {time.perf_counter() - t0:.1f} s on {card} (the session "
        f"{res['session_s']:.1f} s); launches {res['launches']}")
    return res["launches"]


# --- phase 33: a user's FUSE mount over the deployment ------------------------

# one seeded file, written by write(2)s of 1 MiB.  Cut from 256 MiB (and the
# state dict from 64 MiB): the kernel sends one WRITE at a time and the
# card's host took 25-54 ms a 128 KiB WRITE (2.4-4.8 MB/s), so the phase took
# 165 s alone at those sizes (113 s in the whole script at 128 and 32 MiB);
# the widths (1 MiB chunks, 3 replicas, 128 KiB max_write) are unchanged
MOUNT_FILE_BYTES = 64 << 20
MOUNT_IO = 1 << 20                 # the write(2) and pread(2) size, 1 MiB aligned
MOUNT_MAX_WRITE = 1 << 17          # fuse_main's default max_write: a WRITE's payload
MOUNT_SMALL_READS = 256            # seeded 4 KiB preads after the 1 MiB ones
# a fuse_main must mount and answer within it: a hang detector (the card's
# host took 0.9-1.3 s from the spawn, and 5.9-13.9 s while importing the
# package still imported torch)
MOUNT_WAIT_S = 30.0
# the torch.save state dict, ~16 MiB: float32, bfloat16, int64 and one
# tensor of odd length
MOUNT_STATE = (("layer.w", torch.float32, (2048, 1024)),
               ("layer.w_bf16", torch.bfloat16, (2048, 1024)),
               ("step_ids", torch.int64, (1 << 18,)),
               ("odd", torch.float32, (499_979,)))
# meta_bench --fuse at the reference's defaults: 8 dirs x 64 files, 32 workers
MOUNT_BENCH_ARGS = ["--fuse", "--json"]


def fuse_probe() -> str:
    """Phase 0's probe of the kernel mount: the effective uid, whether
    /dev/fuse exists, the errno of opening it and of one trial mount(2) of
    fuse.t3fs on an empty directory with FuseKernelMount.mount's options
    (then umount2(MNT_DETACH) and the fd closed).  Logs one line; returns
    "available" or "refused: <the first call that failed> <errno name>"."""
    import ctypes
    import errno
    import tempfile

    from t3fs_torch.fuse.kernel import MNT_DETACH, MS_NODEV, MS_NOSUID, _libc

    euid, present = os.geteuid(), os.path.exists("/dev/fuse")
    res = {"open": "-", "mount": "-"}
    answer = "available"
    try:
        fd = os.open("/dev/fuse", os.O_RDWR)
    except OSError as e:
        res["open"] = errno.errorcode.get(e.errno, str(e.errno))
        answer = f"refused: open(/dev/fuse) {res['open']}"
    else:
        res["open"] = "0"
        d = tempfile.mkdtemp(prefix="t3fs-fuse-probe-")
        try:
            opts = (f"fd={fd},rootmode=40000,user_id={os.getuid()},"
                    f"group_id={os.getgid()},allow_other")
            r = _libc.mount(b"t3fs", d.encode(), b"fuse.t3fs", MS_NOSUID | MS_NODEV,
                            opts.encode())
            if r == 0:
                res["mount"] = "0"
                _libc.umount2(d.encode(), MNT_DETACH)
            else:
                e = ctypes.get_errno()
                res["mount"] = errno.errorcode.get(e, str(e))
                answer = f"refused: mount(fuse.t3fs) {res['mount']}"
        finally:
            os.close(fd)
            os.rmdir(d)
    log(f"[0] fuse: euid {euid}, /dev/fuse {'present' if present else 'absent'}, "
        f"open(/dev/fuse, O_RDWR) errno {res['open']}, trial mount(2) of "
        f"fuse.t3fs errno {res['mount']}: {answer}")
    return answer


def spawn_fuse_main(mgmtd_address: str, mnt: str, out_path: str):
    """`python -m t3fs_torch.app.fuse_main` as a user starts it, at its
    defaults (max_write 128 KiB, group_source "registry"), with no GPU
    visible: the mount does no device work."""
    import subprocess

    with open(out_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "t3fs_torch.app.fuse_main",
             "--set", f"mgmtd_address={mgmtd_address}", "--set", f"mountpoint={mnt}"],
            stdout=out, stderr=subprocess.STDOUT, cwd=os.path.dirname(out_path),
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
                filter(None, [HERE, os.environ.get("PYTHONPATH")]))))


async def wait_mounted(proc, mnt: str, out_path: str) -> float:
    """Seconds from the spawn until the mount answers: mounted, and
    /t3fs-virt listed through it."""
    t0 = time.perf_counter()
    while True:
        if proc.poll() is not None:
            expect(False, f"[33] fuse_main exited {proc.returncode} before "
                   f"mounting {mnt}: {open(out_path).read()[-1500:]}")
        if os.path.ismount(mnt) and sorted(os.listdir(f"{mnt}/t3fs-virt")) == [
                "get-conf", "rm-rf", "set-conf"]:
            return time.perf_counter() - t0
        expect(time.perf_counter() - t0 < MOUNT_WAIT_S,
               f"[33] {mnt}: no mount within {MOUNT_WAIT_S} s")
        await asyncio.sleep(0.02)


async def stop_fuse_main(proc, mnt: str, out_path: str) -> float:
    """SIGTERM, as a user stops it: exit 0 and the mount gone."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    rc = await asyncio.to_thread(proc.wait, 60)
    expect(rc == 0, f"[33] fuse_main at {mnt} exited {rc}: "
           f"{open(out_path).read()[-1500:]}")
    expect(not os.path.ismount(mnt), f"[33] {mnt} still mounted after its "
           "fuse_main stopped")
    return time.perf_counter() - t0


def mount_state(seed: int, shapes=MOUNT_STATE) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, dtype, shape in shapes:
        if dtype.is_floating_point:
            out[name] = torch.randn(shape, generator=g).to(dtype)
        else:
            out[name] = torch.randint(-(1 << 62), 1 << 62, shape, generator=g,
                                      dtype=dtype)
    return out


async def chunks_of(mgmtd, inodes: set[int]) -> int:
    """Chunks of `inodes` that any target still holds (metadata only)."""
    from t3fs_torch.net.client import Client
    from t3fs_torch.storage.types import TargetOpReq

    await mgmtd.refresh()
    routing = mgmtd.routing()
    cli = Client()
    try:
        n = 0
        for chain in routing.chains.values():
            for t in chain.targets:
                rsp, _ = await cli.call(routing.node_address(t.node_id),
                                        "Storage.get_all_chunk_metadata",
                                        TargetOpReq(target_id=t.target_id))
                n += sum(1 for m in rsp.metas if m.chunk_id.inode in inodes)
        return n
    finally:
        await cli.close()


async def phase_mount_session(dev: torch.device, run_dir: str,
                              file_bytes: int = MOUNT_FILE_BYTES,
                              shapes=MOUNT_STATE,
                              bench_args: list[str] = MOUNT_BENCH_ARGS,
                              bench_shape: tuple[int, int] = (8, 64)) -> dict:
    """Phase 33: a user's POSIX checkpoint through the kernel FUSE mount.
    The port's DevCluster at the deployment's defaults (3 storage processes
    on `dev`'s checksum backend, 3 replicas, 1 MiB chunks, the WAL KV, meta),
    mounted by `python -m t3fs_torch.app.fuse_main`; this process writes a
    seeded file and a torch.save checkpoint through one mount and reads both
    back through a fresh one (a new superblock: every byte through the
    daemon's READ).  Returns the phase's figures and B1's launches in the
    storage processes."""
    import subprocess

    from t3fs_torch.app.storage_main import read_codec_counters
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.fuse.kernel import MNT_DETACH, _libc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 33)
    data = rng.integers(0, 256, file_bytes, dtype=np.uint8).tobytes()
    state = mount_state(SEED + 33, shapes)
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    backend = "cuda" if dev.type == "cuda" else "cpu"
    c = timed_cluster(os.path.join(run_dir, "cluster"), with_meta=True,
                      chunk_size=DEV_CHUNK, checksum_backend=backend,
                      meta_event_trace=meta_event_trace(33))
    mnts = [os.path.join(run_dir, f"mnt{i}") for i in (1, 2)]
    outs = [os.path.join(run_dir, f"fuse{i}.out") for i in (1, 2)]
    for mnt in mnts:
        os.makedirs(mnt)
    procs: list = []
    mgmtd = None
    out: dict = {"walls": {}}
    walls = out["walls"]
    try:
        t0 = time.perf_counter()
        await c.start()
        walls["cluster"] = time.perf_counter() - t0
        log(f"[33] DevCluster up {time.perf_counter() - t_phase:.1f} s into the "
            f"phase (its data made first, {state_bytes / 2**20:.1f} MiB of state "
            f"dict): {c.num_storage} storage processes on the {backend} checksum "
            f"backend, {c.replicas} replicas, {c.chunk_size >> 10} KiB chunks, WAL "
            f"KV, meta; each process answering after (s): " + ", ".join(
                f"{n} {c.ready[n] - c.spawned[n]:.1f}" for n in sorted(c.ready)))

        # (2) the writer's mount
        procs.append(spawn_fuse_main(c.mgmtd_address, mnts[0], outs[0]))
        walls["mount1"] = await wait_mounted(procs[0], mnts[0], outs[0])
        log(f"[33] fuse_main 1 (pid {procs[0].pid}) mounted {mnts[0]} and "
            f"listed /t3fs-virt {walls['mount1']:.2f} s after its spawn")

        # (3) POSIX I/O from this process: the mount's loop is in fuse_main's
        d1 = f"{mnts[0]}/ckpt"

        def write_through() -> tuple[float, float]:
            os.mkdir(d1)
            t = time.perf_counter()
            fd = os.open(f"{d1}/data.bin", os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                view = memoryview(data)
                for off in range(0, file_bytes, MOUNT_IO):
                    n = os.write(fd, view[off:off + MOUNT_IO])
                    expect(n == min(MOUNT_IO, file_bytes - off),
                           f"[33] short write at {off}: {n}")
                os.fsync(fd)
            finally:
                os.close(fd)
            w = time.perf_counter() - t
            t = time.perf_counter()
            with open(f"{d1}/state.pt", "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            return w, time.perf_counter() - t
        w, s = await asyncio.to_thread(write_through)
        walls.update(write=w, save=s)
        ckpt_len = os.stat(f"{d1}/state.pt").st_size
        expect(os.stat(f"{d1}/data.bin").st_size == file_bytes
               and ckpt_len > state_bytes, "[33] sizes through the mount")
        expect(sorted(os.listdir(d1)) == ["data.bin", "state.pt"],
               f"[33] listing: {os.listdir(d1)}")
        os.rename(f"{d1}/state.pt", f"{d1}/step-100.pt")
        os.symlink("step-100.pt", f"{d1}/latest")
        expect(os.readlink(f"{d1}/latest") == "step-100.pt"
               and sorted(os.listdir(d1)) == ["data.bin", "latest", "step-100.pt"],
               f"[33] rename and symlink: {sorted(os.listdir(d1))}")
        conf = os.readlink(f"{mnts[0]}/t3fs-virt/get-conf/attr_timeout")
        expect(conf == "1.0", f"[33] get-conf/attr_timeout {conf!r}")
        out.update(write_MB_s=file_bytes / w / 1e6, save_MB_s=ckpt_len / s / 1e6)
        log(f"[33] through mount 1: {file_bytes >> 20} MiB in write(2)s of "
            f"{MOUNT_IO >> 20} MiB (WRITEs of {MOUNT_MAX_WRITE >> 10} KiB), fsync: "
            f"{out['write_MB_s']:.1f} MB/s ({w:.2f} s); torch.save of "
            f"{len(state)} tensors ({ckpt_len} B), fsync: {out['save_MB_s']:.1f} "
            f"MB/s ({s:.2f} s); stat, listdir, rename, symlink, readlink and "
            f"get-conf/attr_timeout = {conf}")

        # (4) a fresh mount: a new superblock, so every byte comes through
        # the daemon's READ handler
        walls["unmount1"] = await stop_fuse_main(procs[0], mnts[0], outs[0])
        procs.append(spawn_fuse_main(c.mgmtd_address, mnts[1], outs[1]))
        walls["mount2"] = await wait_mounted(procs[1], mnts[1], outs[1])
        d2 = f"{mnts[1]}/ckpt"

        def read_through() -> tuple[float, int, bytes]:
            order = rng.permutation(file_bytes // MOUNT_IO)
            small = rng.integers(0, file_bytes - 4096, MOUNT_SMALL_READS)
            fd = os.open(f"{d2}/data.bin", os.O_RDONLY)
            try:
                t = time.perf_counter()
                bad = sum(os.pread(fd, MOUNT_IO, int(i) * MOUNT_IO)
                          != data[int(i) * MOUNT_IO:(int(i) + 1) * MOUNT_IO]
                          for i in order)
                r = time.perf_counter() - t
                bad += sum(os.pread(fd, 4096, int(o)) != data[int(o):int(o) + 4096]
                           for o in small)
            finally:
                os.close(fd)
            with open(f"{d2}/step-100.pt", "rb") as f:
                ckpt = f.read()
            return r, bad, ckpt
        r, bad, ckpt = await asyncio.to_thread(read_through)
        expect(bad == 0, f"[33] {bad} preads through mount 2 differ")
        t = time.perf_counter()
        loaded = await asyncio.to_thread(torch.load, f"{d2}/latest", map_location=dev)
        walls.update(read=r, load=time.perf_counter() - t)
        expect(sorted(loaded) == sorted(state) and all(
            loaded[k].device.type == dev.type and loaded[k].dtype == v.dtype
            and torch.equal(loaded[k].cpu(), v) for k, v in state.items()),
            "[33] the checkpoint loaded through mount 2 differs")
        out["read_MB_s"] = file_bytes / r / 1e6
        log(f"[33] through mount 2 (fuse_main 2, pid {procs[1].pid}, "
            f"{walls['mount2']:.2f} s to mount; mount 1 stopped by SIGTERM in "
            f"{walls['unmount1']:.2f} s, exit 0, unmounted): {file_bytes >> 20} "
            f"MiB in {file_bytes // MOUNT_IO} preads of 1 MiB in a seeded order, "
            f"{out['read_MB_s']:.1f} MB/s ({r:.2f} s), and {MOUNT_SMALL_READS} "
            f"seeded 4 KiB preads, every byte equal; torch.load(map_location="
            f"{dev.type!r}) through the symlink in {walls['load']:.2f} s, every "
            f"tensor equal")

        # (5) every chunk of every replica, over the storage RPCs
        mgmtd = MgmtdClient(c.mgmtd_address, refresh_period_s=0.2)
        await mgmtd.start()
        inos = {os.stat(f"{d2}/data.bin").st_ino: data,
                os.stat(f"{d2}/step-100.pt").st_ino: ckpt}
        t = time.perf_counter()
        n = await dev_check_replicas(mgmtd, inos, c.replicas, phase=33)
        walls["replicas"] = time.perf_counter() - t
        log(f"[33] {n} stored chunks over {c.replicas} replicas read back over "
            f"the wire: replicas equal, each checksum the host CRC of its bytes, "
            f"both files' chunks their bytes ({walls['replicas']:.1f} s)")

        # (6) the namespace through the mount, then meta's GC
        t = time.perf_counter()
        os.truncate(f"{d2}/data.bin", 10_000)
        expect(os.stat(f"{d2}/data.bin").st_size == 10_000, "[33] truncate: size")
        with open(f"{d2}/data.bin", "rb") as f:
            expect(f.read() == data[:10_000], "[33] truncate: bytes")
        for name in ("latest", "step-100.pt", "data.bin"):
            os.unlink(f"{d2}/{name}")
        os.rmdir(d2)
        expect(os.listdir(mnts[1]) == [], f"[33] root not empty: {os.listdir(mnts[1])}")
        while (left := await chunks_of(mgmtd, set(inos))) > 0:
            expect(time.perf_counter() - t < 60.0,
                   f"[33] meta's GC left {left} chunks after 60 s")
            await asyncio.sleep(0.2)
        walls["gc"] = time.perf_counter() - t
        log(f"[33] truncate to 10000 B (length and bytes right), unlink, rmdir; "
            f"meta's GC removed every chunk from every replica in "
            f"{walls['gc']:.2f} s")
        walls["unmount2"] = await stop_fuse_main(procs[1], mnts[1], outs[1])

        # (7) meta_bench --fuse, a process of its own: its in-process
        # cluster and kernel mount share that process's loop
        t = time.perf_counter()
        r = await asyncio.to_thread(
            subprocess.run, [sys.executable, "-m", "t3fs_torch.benchmarks.meta_bench",
                             *bench_args], capture_output=True, text=True,
            timeout=300, cwd=run_dir, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                filter(None, [HERE, os.environ.get("PYTHONPATH")]))))
        walls["meta_bench"] = time.perf_counter() - t
        expect(r.returncode == 0, f"[33] meta_bench --fuse: {r.stderr[-2000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        dirs, files = bench_shape
        want = {"mkdir": dirs, "create": dirs * files, "stat": dirs * files,
                "list": dirs, "rename": dirs * files, "remove": dirs * files}
        expect(res["path"] == "fuse-kernel-mount" and res["total_files"] == dirs * files
               and {p: res[p]["ops"] for p in want} == want,
               f"[33] meta_bench --fuse counts: {res}")
        log(f"[33] meta_bench --fuse ({walls['meta_bench']:.1f} s with the bench's "
            f"start): {json.dumps(res)}")
        out["meta_bench"] = {p: res[p]["ops_s"] for p in want}
        out["bench_files"] = res["total_files"]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for mnt in mnts:
            if os.path.ismount(mnt):
                _libc.umount2(mnt.encode(), MNT_DETACH)
        if mgmtd is not None:
            await mgmtd.stop()
        await c.stop()

    # (8) B1 in each storage process, as each logged at its stop
    counters = {}
    for i in range(1, c.num_storage + 1):
        got = read_codec_counters(c._path(f"storage{i}.log"))
        expect(got is not None, f"[33] storage{i} logged no counters at its stop")
        counters[i] = got
    log("[33] per storage process (B1 batches, items, items a batch, B1 "
        "launches): " + ", ".join(
            f"storage{i} {v['batches']}, {v['batched_items']}, "
            f"{v['batched_items'] / max(v['batches'], 1):.2f}, "
            f"{v['crc_words_launches']}" for i, v in counters.items()))
    if dev.type == "cuda":
        need = file_bytes // MOUNT_MAX_WRITE
        for i, v in counters.items():
            expect(v["backend"] == "cuda" and v["batched_items"] >= need
                   and v["crc_words_launches"] > 0,
                   f"[33] storage{i}: fewer than {need} B1 items: {v}")
    out["launches"] = {"crc_words": sum(v["crc_words_launches"]
                                        for v in counters.values())}
    return out


def phase_mount(dev: torch.device, sharded: dict | None = None) -> dict:
    """Phase 33 on `dev`; `sharded` is phase 29's meta_bench --mgmtd ops/s
    of this run, printed beside meta_bench --fuse.  Returns the storage
    processes' launches."""
    import tempfile

    from t3fs_torch.benchmarks.devbench import card_line

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="t3fs-mount-") as run_dir:
        res = asyncio.run(phase_mount_session(dev, run_dir))
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"[33] meta_bench ops/s: --fuse ({res['bench_files']} files as POSIX "
        f"calls through the kernel mount) {res['meta_bench']}; phase 29's --mgmtd "
        f"(meta RPCs over two kv_main shards) {sharded if sharded else 'not run'}")
    log(f"[33] walls (s): " + ", ".join(f"{k} {v:.2f}" for k, v in res["walls"].items()))
    log(f"[33] phase: {time.perf_counter() - t0:.1f} s on {card}; write "
        f"{res['write_MB_s']:.1f} MB/s, read {res['read_MB_s']:.1f} MB/s through "
        f"the mount; storage processes' launches {res['launches']}")
    return res["launches"]


# --- phase 30: elastic membership under live traffic --------------------------

_replace_at = contextvars.ContextVar("replace_at", default=None)


@contextlib.contextmanager
def counted_sync_replaces(counts: dict):
    """While the block runs, counts[node_id] = [the resync REPLACEs the node
    applied, those whose payload CRC its backend queued for the device]:
    the update handler marks its task with the node's backend, and the
    CUDA backend's payload_crc counts a call from a task so marked."""
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend
    from t3fs_torch.storage.service import StorageService
    from t3fs_torch.storage.types import UpdateType

    orig_update, orig_crc = StorageService._locked_update, CudaChecksumBackend.payload_crc

    async def update(self, node, chain, target, io, *a, **kw):
        if io.update_type != UpdateType.REPLACE or not io.is_sync:
            return await orig_update(self, node, chain, target, io, *a, **kw)
        counts.setdefault(node.node_id, [0, 0])[0] += 1
        token = _replace_at.set((node.node_id, node.codec))
        try:
            return await orig_update(self, node, chain, target, io, *a, **kw)
        finally:
            _replace_at.reset(token)

    async def payload_crc(self, data):
        at = _replace_at.get()
        if at is not None and at[1] is self and len(data) >= self.min_device_bytes:
            counts[at[0]][1] += 1
        return await orig_crc(self, data)

    StorageService._locked_update, CudaChecksumBackend.payload_crc = update, payload_crc
    try:
        yield counts
    finally:
        StorageService._locked_update, CudaChecksumBackend.payload_crc = orig_update, orig_crc


def check_rebalanced(cluster, nodes: int, dev: torch.device) -> dict:
    """A drill cell's cluster just before it stops, read from each target's
    engine: on every chain of mgmtd's routing, every replica holds the same
    chunks with the same bytes and the same ChunkMeta (length, versions,
    checksum, state; chain_ver is the chain's version at the write, newer
    on a resynced replica), committed, its checksum the native host CRC
    and plain B1 of its bytes.  In the drill cell (a node past `nodes`
    joined), the drained node holds no chain target and the added node
    holds exactly its solver share.  Runs in a thread: the cluster's loop
    keeps its heartbeats."""
    from t3fs_torch.mgmtd.chain_table import solve_for_routing
    from t3fs_torch.mgmtd.types import NodeStatus
    from t3fs_torch.ops.codec import crc32c
    from t3fs_torch.storage.types import ChunkState

    routing = cluster.mgmtd.state.routing()
    chunks = replicas = 0
    for cid, chain in sorted(routing.chains.items()):
        held = []
        for t in chain.targets:
            engine = cluster_engine(cluster, t)
            held.append({m.chunk_id: (m.length, m.update_ver, m.commit_ver, m.checksum,
                                      m.state, engine.read(m.chunk_id))
                         for m in engine.all_metas()})
        expect(all(h == held[0] for h in held[1:]),
               f"[30] chain {cid}: its replicas hold other chunks, bytes or metas")
        rows = sorted(held[0].items(), key=lambda kv: (kv[0].inode, kv[0].index))
        b1 = plain_crcs([row[5] for _, row in rows], dev)
        for (chunk, (length, uver, cver, crc, state, data)), plain in zip(rows, b1):
            expect(state == ChunkState.COMMIT and uver == cver and length == len(data)
                   and crc == crc32c(data) == plain,
                   f"[30] chain {cid} chunk {chunk}: meta {(length, uver, cver, crc, state)}"
                   f", host CRC {crc32c(data):#x}, plain B1 {plain:#x}")
        chunks += len(rows)
        replicas += len(rows) * len(held)
    out = {"chains": len(routing.chains), "chunks": chunks, "replica_chunks": replicas}
    added = sorted(n for n in routing.nodes if n > nodes)
    if added:
        drained = [n for n, info in routing.nodes.items() if "drain" in (info.tags or ())]
        expect(len(added) == 1 and len(drained) == 1,
               f"[30] added nodes {added}, drained nodes {drained}")
        on = {n: sum(1 for c in routing.chains.values()
                     for t in c.targets if t.node_id == n) for n in routing.nodes}
        expect(on[drained[0]] == 0,
               f"[30] the drained node {drained[0]} holds {on[drained[0]]} chain targets")
        cands = [info for n, info in sorted(routing.nodes.items())
                 if n != drained[0] and info.status == NodeStatus.ACTIVE]
        share = sum(added[0] in owners
                    for tid in sorted(routing.chain_tables)
                    for owners in solve_for_routing(routing, tid, cands).assignment.values())
        expect(on[added[0]] == share > 0,
               f"[30] the added node {added[0]} holds {on[added[0]]} chain targets, "
               f"its solver share {share}")
        out.update(added=added[0], drained=drained[0], share=share, targets_on=on)
    return out


async def phase_rebalance_drill(dev: torch.device, args: list[str]) -> dict:
    """The drill (rebalance_drill_bench.run_bench, both cells) in this
    process's loop under LoopStallDetector, each cell's cluster checked by
    check_rebalanced before it stops; then the drill cell once more under
    race_audit (a run apart: the auditor formats a stack on every
    apply_update, which would weigh on the timed cells' loop)."""
    from t3fs_torch.benchmarks import rebalance_drill_bench as rdb
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.migration.service import MigrationService
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.server import StorageServer
    from t3fs_torch.testing.cluster import LocalCluster
    from t3fs_torch.testing.race import LoopStallDetector, RaceError, race_audit
    from t3fs_torch.testing.spies import checked_before_stop, spied

    bargs = rdb.parse_args(args + (["--cpu"] if dev.type == "cpu" else []))
    started, cells, jobs, races, codecs = [], [], [], [], []
    b1_nodes: dict[int, dict] = {}     # cell -> node -> [B1 batches, items]
    replaces: dict = {}

    def server_stopped(ss) -> None:
        counts = b1_nodes.setdefault(len(started) - 1, {}).setdefault(ss.node_id, [0, 0])
        counts[0] += getattr(ss.node.codec, "batches", 0)
        counts[1] += getattr(ss.node.codec, "batched_items", 0)

    async def cluster_stopping(cluster) -> None:
        cells.append(await asyncio.to_thread(check_rebalanced, cluster, bargs.nodes, dev))

    with counted_sync_replaces(replaces), \
            spied(LocalCluster, "start", started), spied(TorchECCodec, "close", codecs), \
            checked_before_stop(StorageServer, server_stopped), \
            checked_before_stop(LocalCluster, cluster_stopping), \
            checked_before_stop(MigrationService, lambda m: jobs.extend(m.jobs.values())):
        cc.reset_launches()
        async with LoopStallDetector(threshold_s=STALL_THRESHOLD_S) as det:
            t0 = time.perf_counter()
            res = await rdb.run_bench(bargs)
            wall = time.perf_counter() - t0
        launches = dict(cc.launches)
    with race_audit() as auditor:
        enter = auditor.enter

        def audited_enter(key, who="?"):
            try:
                enter(key, who)
            except RaceError as e:
                races.append(str(e).splitlines()[0])
                raise
        auditor.enter = audited_enter
        t0 = time.perf_counter()
        audited = await rdb.run_drill(bargs)
        audit_wall = time.perf_counter() - t0
    return {"res": res, "wall": wall, "launches": launches, "cells": cells,
            "jobs": jobs, "b1_nodes": b1_nodes, "replaces": replaces,
            "stalls": det.stalls, "races": races, "audited": auditor.entries,
            "audited_drill": audited, "audit_wall": audit_wall,
            "routes": [dict(c.codec_counts) for c in codecs]}


def stall_frames(stack: str, depth: int = 8) -> str:
    """Where a stall's loop thread was: its `depth` innermost frames,
    innermost first, each as path:line in function (paths in this checkout
    relative to it, others from site-packages on)."""
    here = os.path.dirname(os.path.abspath(__file__))
    frames = []
    for ln in stack.splitlines():
        ln = ln.strip()
        if ln.startswith('File "'):
            path, line, fn = ln[6:].split(", ", 2)
            path = path.rstrip('"')
            path = os.path.relpath(path, here) if path.startswith(here + os.sep) \
                else path.split("site-packages/")[-1]
            frames.append(f"{path}:{line[5:]} in {fn[3:]}")
    return " < ".join(reversed(frames[-depth:])) or "<no frame>"


def phase_rebalance(dev: torch.device, args: list[str] | None = None) -> dict:
    """Phase 30 on `dev`: the reference's rebalance drill (add a node, flap
    it mid-move, drain an original node) with the checks listed in the
    module docstring; returns the drill's launches."""
    from t3fs_torch.migration.service import JobState

    out = asyncio.run(phase_rebalance_drill(dev, REBALANCE_ARGS if args is None else args))
    res, cells, jobs = out["res"], out["cells"], out["jobs"]
    base, drill = res["cells"]
    for c in (base, drill):
        log(f"[30] {c['name']}: read p50 {c['fg_read_p50_ms']} ms, p99 "
            f"{c['fg_read_p99_ms']} ms, write p50 {c['fg_write_p50_ms']} ms; "
            f"{c['fg_writes']} writes and {c['fg_reads']} reads in the window, "
            f"{c['fg_errors']} errors, {c['wrong_bytes']} wrong")
    done = [j for j in jobs if j.state == JobState.DONE.value]
    failed = [j for j in jobs if j.state == JobState.FAILED.value]
    moved = sum(j.bytes_moved for j in done)
    log(f"[30] jobs: {len(jobs)} submitted, {len(done)} done, "
        f"{sum(j.resumable for j in failed)} failed resumable and "
        f"{sum(not j.resumable for j in failed)} not, {drill['jobs_resumed']} resumed, "
        f"{sum(j.attempts for j in jobs)} drives; {moved} bytes moved "
        f"({moved / 2**20:.1f} MiB), converged in {drill['converge_s']} s; moves "
        f"{drill['moves_done']} of {drill['moves_total']} done")
    log(f"[30] pacer: bytes_submitted {drill['bytes_submitted']}, allowance "
        f"{drill['pacer_allowance_bytes']} (budget {res['budget_mbps']} MB/s x the "
        f"drill + a burst of {int(res['budget_mbps'] * 1e6)}), waits "
        f"{drill['paced_waits']} for {drill['paced_wait_s']} s")
    log(f"[30] gates {res['gates']}; fg p50 ratio {res['fg_p50_ratio']}; the "
        f"cells' codec routes {out['routes']}")
    stalls = out["stalls"]
    worst = max(stalls, key=lambda st: st.duration_s, default=None)
    log(f"[30] LoopStallDetector (threshold {STALL_THRESHOLD_S} s) over the drill's "
        f"loop: {len(stalls)} stalls" + (
            f", worst {worst.duration_s:.3f} s in {stall_frames(worst.stack)}"
            if worst else ""))
    for st in stalls:
        log(f"[30] stall {st.duration_s:.3f} s: {stall_frames(st.stack, 3)}")
    expect(len(cells) == 2 and "added" not in cells[0] and "added" in cells[1],
           f"[30] cells checked before their stop: {cells}")
    c = cells[1]
    log(f"[30] checks: {cells[0]['replica_chunks']} + {c['replica_chunks']} replica "
        f"chunks of {cells[0]['chunks']} + {c['chunks']} chunks on every chain "
        f"of both cells equal across replicas (bytes and ChunkMeta), committed, "
        f"each checksum the host CRC and plain B1 of its bytes; node "
        f"{c['drained']} drained (0 targets), node {c['added']} added with "
        f"{c['targets_on'][c['added']]} chain targets, its solver share {c['share']}; "
        f"targets a node {c['targets_on']}")
    reps = out["replaces"]
    log("[30] per node (B1 batches = launches, items; resync REPLACEs applied, of "
        "them CRC'd on the device): " + "; ".join(
            f"cell {i} " + ", ".join(
                f"n{n} {b}, {it}" + (f"; {reps[n][0]}, {reps[n][1]}" if i and n in reps else "")
                for n, (b, it) in sorted(nodes.items()))
            for i, nodes in sorted(out["b1_nodes"].items())))
    a = out["audited_drill"]
    log(f"[30] race_audit over a second drill cell ({out['audit_wall']:.1f} s): "
        f"{out['audited']} apply_update sections audited, {len(out['races'])} races; "
        f"{a['fg_errors']} foreground errors, {a['wrong_bytes']} wrong, converged "
        f"{a['converged']} in {a['converge_s']} s, node {a['drained_node']} left "
        f"{a['drained_node_targets']} targets, read p50 {a['fg_read_p50_ms']} ms")
    expect(out["audited"] > 0 and not out["races"], f"[30] race_audit: {out['races']}")
    expect(a["fg_errors"] == a["wrong_bytes"] == a["drained_node_targets"]
           == a["solver_diff_remaining"] == 0 and a["converged"]
           and a["all_serving"] and a["no_duplicate_targets"],
           f"[30] the audited drill cell: {a}")
    expect(drill["bytes_submitted"] > 0 and moved > 0, "[30] the drill moved nothing")
    if dev.type == "cuda":
        from t3fs_torch.benchmarks.devbench import card_line

        dests = {j.dst_node_id for j in done if j.bytes_moved}
        expect(c["added"] in dests and all(
            reps.get(n, [0, 0])[1] == reps.get(n, [0, 0])[0] > 0 for n in dests),
            f"[30] a destination's resync REPLACEs did not all reach B1: "
            f"destinations {sorted(dests)}, counts {reps}")
        expect(out["launches"].get("crc_words", 0) > 0,
               f"[30] the drill launched no B1: {out['launches']}")
        expect(len(out["routes"]) == 2 and all(
            r and all(k.startswith("cuda-") for k in r) for r in out["routes"]),
            f"[30] a cell's codec took a plain route or none: {out['routes']}")
        card = card_line()
    else:
        card = "cpu"
    log(f"[30] phase: {out['wall']:.1f} s of the drill on {card}; launches {out['launches']}")
    expect(res["verified"], f"[30] the drill missed a gate: {res['gates']}")
    return out["launches"]


def rebalance_runs(dev: torch.device, runs: int) -> int:
    """`--rebalance-drill RUNS`: phase 30 `runs` times in turn, a run that
    fails a check logged and the next one started; 0 only if every run
    passed every check."""
    from t3fs_torch.benchmarks import rebalance_drill_bench as rdb

    results, orig = [], rdb.run_bench

    async def run_bench(args):
        results.append(await orig(args))
        return results[-1]

    failed = []
    rdb.run_bench = run_bench
    try:
        for i in range(runs):
            t0 = time.perf_counter()
            try:
                phase_rebalance(dev)
            except AssertionError as e:
                failed.append(i + 1)
                log(f"[30] run {i + 1} of {runs} failed: {e}")
            log(f"[30] run {i + 1} of {runs}: {time.perf_counter() - t0:.1f} s")
    finally:
        rdb.run_bench = orig
    log(json.dumps({"rebalance_drill": [
        {"run": i + 1, "fg_p50_ratio": r["fg_p50_ratio"], "gates": r["gates"]}
        for i, r in enumerate(results)], "failed_runs": failed}))
    return 1 if failed else 0


# --- phase 31: the mixed-workload soak ----------------------------------------


async def phase_soak_cells(dev: torch.device, cells=SOAK_CELLS) -> dict:
    """Each cell through soak_bench.run_cell in this process's loop, with
    its launches counted from the cell's start (the runner's warm-up and
    setup included), each node's B1 batches and items read as its server
    stops, each EC codec's routes as it closes, and the faults-on cell
    under LoopStallDetector.  The tracing config the phase found is put
    back when it ends."""
    from t3fs_torch.benchmarks import soak_bench
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.soak import load_spec
    from t3fs_torch.storage.server import StorageServer
    from t3fs_torch.testing.cluster import LocalCluster
    from t3fs_torch.testing.race import LoopStallDetector
    from t3fs_torch.testing.spies import checked_before_stop, spied
    from t3fs_torch.utils import tracing

    backend = "cpu" if dev.type == "cpu" else "cuda"
    started, codecs = [], []
    b1_nodes: dict[int, dict] = {}     # cell -> node -> [B1 batches, items]
    routes: dict[int, list] = {}       # cell -> each closed codec's routes

    def server_stopped(ss) -> None:
        counts = b1_nodes.setdefault(len(started) - 1, {}).setdefault(ss.node_id, [0, 0])
        counts[0] += getattr(ss.node.codec, "batches", 0)
        counts[1] += getattr(ss.node.codec, "batched_items", 0)

    out = {"cells": [], "launches": [], "walls": [], "stalls": [],
           "b1_nodes": b1_nodes, "routes": routes}
    prev = tracing.get_config()
    try:
        with spied(LocalCluster, "start", started), \
                checked_before_stop(StorageServer, server_stopped), \
                spied(TorchECCodec, "close", codecs):
            for i, (config, faults_on) in enumerate(cells):
                spec = load_spec(os.path.join(HERE, config))
                cc.reset_launches()
                t0 = time.perf_counter()
                if faults_on:
                    async with LoopStallDetector(threshold_s=STALL_THRESHOLD_S) as det:
                        res = await soak_bench.run_cell(spec, True, 1, True, backend)
                    out["stalls"] = det.stalls
                else:
                    res = await soak_bench.run_cell(spec, False, 1, True, backend)
                out["walls"].append(time.perf_counter() - t0)
                out["launches"].append(dict(cc.launches))
                routes[i] = [dict(c.codec_counts) for c in codecs]
                del codecs[:]
                out["cells"].append((config, faults_on, res))
    finally:
        tracing.configure(prev)
        tracing.BUFFER.reset()
    return out


def host_probe() -> dict:
    """The host the loop runs on: its CPU model, the cores this process may
    use, the load average, and the seconds one core takes for a fixed pure
    Python loop (2 000 000 iterations), the loop's own kind of work."""
    model = ""
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), "")
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc ^= i
    return {"cpu": model, "cores": len(os.sched_getaffinity(0)),
            "loadavg": [round(x, 2) for x in os.getloadavg()],
            "py_loop_s": round(time.perf_counter() - t0, 4)}


def soak_cell_lines(config: str, faults_on: bool, res: dict) -> None:
    name = f"{os.path.basename(config)} faults {'on' if faults_on else 'off'}"
    log(f"[31] {name}: {res['elapsed_s']} s of traffic, fairness {res['fairness']}, "
        f"{res['wrong_bytes']} wrong bytes, passed {res['passed']}")
    for wl, w in res["workloads"].items():
        log(f"[31]   {wl} ({w['kind']}, {w['mode']}): {w['ops_ok']} ops ok, "
            f"{w['ops_err']} errors, {w['shed']} shed, {w['cancelled']} cancelled; "
            f"p50 {w['p50_ms']} ms, p99 {w['p99_ms']} ms, {w['ops_s']} ops/s, share "
            f"{w['share']}, {w['mb_moved']} MB; ops a window {w['window_ops']}")
    for gate, g in res["gates"].items():
        log(f"[31]   gate {gate}: {'PASS' if g['ok'] else 'FAIL'} ({g['detail']})")
    for f in res["faults"]:
        log(f"[31]   fault at {f['t']} s: {f['kind']} node {f['node']} "
            f"{'ok' if f['ok'] else 'FAILED'} ({f['detail']})")


def phase_soak(dev: torch.device, cells=SOAK_CELLS) -> dict:
    """Phase 31 on `dev`: the reference's scenarios, each cell's gates, the
    faults applied, B1 on the nodes and the cuda-* routes on the faults-on
    cell's checkpoint stripes (module docstring); returns the launches of
    both cells."""
    from t3fs_torch.benchmarks.devbench import card_line

    t0 = time.perf_counter()
    host = host_probe()
    log(f"[31] host before: {json.dumps(host)}")
    out = asyncio.run(phase_soak_cells(dev, cells))
    log(f"[31] host after: {json.dumps(host_probe())}")
    failed = []
    for i, (config, faults_on, res) in enumerate(out["cells"]):
        soak_cell_lines(config, faults_on, res)
        nodes = out["b1_nodes"].get(i, {})
        log(f"[31]   per node (B1 batches = launches, items): " + ", ".join(
            f"n{n} {b}, {it}" for n, (b, it) in sorted(nodes.items())))
        log(f"[31]   launches {out['launches'][i]}; EC codec routes "
            f"{out['routes'].get(i, [])}; cell wall {out['walls'][i]:.1f} s")
        for line in res["worst_trace_excerpt"].splitlines():
            log(f"[31]   | {line}")
        if not res["passed"]:
            failed.append(f"{os.path.basename(config)}: gates {res['gates']}")
        if faults_on:
            bad = [f for f in res["faults"] if not f["ok"]]
            if bad:
                failed.append(f"{os.path.basename(config)}: faults failed {bad}")
            if dev.type == "cuda":
                if not any(b > 0 for b, _ in nodes.values()):
                    failed.append(f"{os.path.basename(config)}: B1 launched on no "
                                  f"node: {nodes}")
                cell_routes = out["routes"].get(i, [])
                if not (any(r.get("cuda-encode-words", 0) > 0 for r in cell_routes)
                        and all(k.startswith("cuda-") for r in cell_routes for k in r)):
                    failed.append(f"{os.path.basename(config)}: the checkpoint "
                                  f"stripes took no cuda-* route: {cell_routes}")
    stalls = out["stalls"]
    worst = max(stalls, key=lambda st: st.duration_s, default=None)
    log(f"[31] LoopStallDetector (threshold {STALL_THRESHOLD_S} s) over the faults-on "
        f"cell's loop: {len(stalls)} stalls" + (
            f", worst {worst.duration_s:.3f} s in {stall_frames(worst.stack)}"
            if worst else ""))
    for st in sorted(stalls, key=lambda st: -st.duration_s)[:8]:
        log(f"[31] stall {st.duration_s:.3f} s: {stall_frames(st.stack, 3)}")
    launches: dict[str, int] = {}
    for part in out["launches"]:
        add_launches(launches, part)
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"[31] phase: {time.perf_counter() - t0:.1f} s on {card}; launches {launches}")
    expect(not failed, "[31] " + "; ".join(failed))
    return launches


def soak_runs(dev: torch.device, runs: int) -> int:
    """`--soak RUNS`: phase 31 `runs` times in turn, a run that fails a
    check logged and the next one started; 0 only if every run passed
    every check."""
    from t3fs_torch.benchmarks import soak_bench

    results, orig = [], soak_bench.run_cell

    async def run_cell(spec, faults_on, *a):
        results.append(await orig(spec, faults_on, *a))
        results[-1]["faults_on_cell"] = faults_on
        return results[-1]

    failed = []
    soak_bench.run_cell = run_cell
    try:
        for i in range(runs):
            del results[:]
            t0 = time.perf_counter()
            try:
                phase_soak(dev)
                err = ""
            except Exception as e:
                failed.append(i + 1)
                err = f"{type(e).__name__}: {e}"
                log(f"[31] run {i + 1} of {runs} failed: {e}")
            log(json.dumps({"soak_run": i + 1, "of": runs,
                            "wall_s": round(time.perf_counter() - t0, 1),
                            "cells": [{"faults_on": r["faults_on_cell"],
                                       "fairness": r["fairness"],
                                       "gates": {k: g["ok"] for k, g in r["gates"].items()},
                                       "faults_ok": all(f["ok"] for f in r["faults"])}
                                      for r in results], "failed": err}))
    finally:
        soak_bench.run_cell = orig
    log(json.dumps({"soak_runs": runs, "failed_runs": failed}))
    return 1 if failed else 0


def host_warnings() -> None:
    """usrbio.cpp through the host compiler with -Wall -Wextra (syntax
    only): its includes stand on their own and it warns of nothing."""
    import subprocess

    from t3fs_torch.ops import _build

    cxx = shutil.which("g++") or shutil.which("c++")
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    r = subprocess.run([cxx, "-std=c++20", "-fsyntax-only", "-Wall", "-Wextra",
                        str(_build.SRC_DIR / "usrbio.cpp")], capture_output=True, text=True)
    expect(r.returncode == 0 and not r.stderr.strip(),
           f"usrbio.cpp under {version} -Wall -Wextra: {r.stderr}")
    log(f"[0] usrbio.cpp under {version} with -Wall -Wextra: no warning")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    drill_runs = soak_runs_asked = 0
    if argv:
        if len(argv) != 2 or argv[0] not in ("--rebalance-drill", "--soak") \
                or not argv[1].isdigit() or int(argv[1]) < 1:
            print("usage: chip_smoke.py [--rebalance-drill RUNS | --soak RUNS]",
                  file=sys.stderr)
            return 2
        if argv[0] == "--soak":
            soak_runs_asked = int(argv[1])
        else:
            drill_runs = int(argv[1])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a GPU", file=sys.stderr)
        return 1
    from t3fs_torch.benchmarks.devbench import card_line
    from t3fs_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[0] {card}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()})")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[0] kernel build: {time.perf_counter() - t0:.1f} s")
    from t3fs_torch.ops.codec import host_impl
    from t3fs_torch.storage.aio import AioReadWorker
    t0 = time.perf_counter()
    expect(host_impl() == "native", "the native host library (csrc/chunk_engine.cpp, "
           "csrc/aio_reader.cpp) did not build or its CRC failed the self-check")
    log(f"[0] native host library: chunk engine, host CRC, io_uring reader and "
        f"usrbio rings (chunk_engine.cpp, aio_reader.cpp, usrbio.cpp, g++): "
        f"{time.perf_counter() - t0:.1f} s; io_uring available: "
        f"{AioReadWorker.available()}")
    log(f"[0] {shm_line()}")
    host_warnings()
    fuse = fuse_probe()
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"[0] nvcc {name}: {line.strip()}")

    if drill_runs:
        return rebalance_runs(dev, drill_runs)
    if soak_runs_asked:
        return soak_runs(dev, soak_runs_asked)

    walls: dict[int, float] = {}

    @contextlib.contextmanager
    def wall(phase: int):
        t0 = time.perf_counter()
        yield
        walls[phase] = walls.get(phase, 0.0) + time.perf_counter() - t0
        log(f"[{phase}] wall {walls[phase]:.1f} s")

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    with wall(1):
        e_crc = phase_crc(dev, g, CHUNK_BYTES // 4, CHUNKS, 4096)
    with wall(2):
        e_rs, e_step_crc = phase_stripe(dev, g, SHARD_BYTES // 4, STRIPES)
    with wall(3):
        main_runs = [asyncio.run(phase_storage(dev, storage_sizes(CHUNK_BYTES)))]
    with wall(4):
        main_runs.append(asyncio.run(phase_ec(dev, SHARD_BYTES, 24)))
    with wall(5):
        times = phase_times(dev, g)
    with wall(6):
        read_errs = phase_read_kernels(dev, g)
    with wall(7):
        full = raid6_stripes(dev, g, LOST_CHUNKS)
        crcs = plain_shard_crcs(full, dev)
        main_runs.append(asyncio.run(phase_degraded(dev, full, crcs)))
    with wall(8):
        main_runs.append(asyncio.run(phase_repair(dev, full, crcs)))
    del full
    with wall(9):
        main_runs.append(asyncio.run(phase_nonraid6(dev, g)))
    with wall(10):
        read_times = phase_read_times(dev, g)
    with wall(11):
        e_bytes = phase_crc_bytes(dev, g)
    with wall(12):
        main_runs.append(asyncio.run(phase_byte_routes(dev)))
    with wall(13):
        main_runs.append(asyncio.run(phase_msr(dev)))
    with wall(17):
        big_errs = phase_big_kernels(dev, g)
        main_runs.append(asyncio.run(phase_big_codes(dev)))
    with wall(14):
        byte_times = phase_byte_times(dev, g, times["crc_words"])
    with wall(16):
        e_copy, copy_times, bench_launches = phase_bench(dev, g)
    main_runs.append(bench_launches)
    with wall(18):
        phase_sort()
    with wall(19):
        main_runs.append(phase_mesh(dev))
    with wall(20):
        main_runs.append(phase_entry(dev))
    with wall(21):
        for pipeline in ("off", "overlap"):
            main_runs.append(asyncio.run(
                phase_chain(dev, pipeline, CHAIN_FILE_BYTES, CHUNK_BYTES)))
        chain_device_times(dev, CHUNK_BYTES)
    with wall(22):
        main_runs.append(asyncio.run(phase_ec_stripes(dev)))
    with wall(23):
        main_runs.append(asyncio.run(phase_recovery(dev)))
    with wall(24):
        main_runs.append(asyncio.run(phase_ckpt(dev)))
        phase_ckpt_bench()
    with wall(25):
        main_runs.append(asyncio.run(phase_graysort_kvcache(dev)))
        phase_fleet()
    with wall(26):
        main_runs.append(phase_usrbio(dev))
    with wall(27):
        launches27, config2 = phase_harness(dev)
    main_runs.append(launches27)
    with wall(28):
        main_runs.append(phase_deployment(dev, config2))
    with wall(29):
        sharded = phase_sharded(dev)
    main_runs.append(sharded["launches"])
    with wall(32):
        main_runs.append(phase_operator(dev))
    if fuse == "available":
        with wall(33):
            main_runs.append(phase_mount(dev, sharded["meta_bench"]))
    else:
        log(f"[33] not run: {fuse}")
    log(f"[15] phase walls (s) on {card}: " + ", ".join(
        f"{n} {w:.1f}" for n, w in sorted(walls.items()))
        + f"; all phases {sum(walls.values()):.1f}")

    from t3fs_torch.benchmarks.devbench import launches as _bench_names
    from t3fs_torch.ops.cuda_codec import launches as _codec_names

    # phases 7, 8, 12 and 13 check every CRC the fused steps returned
    # against plain B1 or B6 and every rebuilt byte, so a mismatch there
    # already failed
    meta = {
        "crc_words": ("t3fs_torch/csrc/crc_words.cu",
                      "t3fs/ops/pallas_codec.py:310", max(e_crc, e_step_crc),
                      times["crc_words"]),
        "rs_raid6_words": ("t3fs_torch/csrc/rs_raid6_words.cu",
                           "t3fs/ops/pallas_codec.py:261", e_rs,
                           times["rs_raid6_words"]),
        "rs_reconstruct_words": ("t3fs_torch/csrc/rs_reconstruct_words.cu",
                                 "t3fs/ops/pallas_codec.py:502",
                                 read_errs["rs_reconstruct_words"],
                                 read_times["rs_reconstruct_words want=(0, 9)"]),
        "repair_words": ("t3fs_torch/csrc/repair_words.cu",
                         "t3fs/ops/pallas_codec.py:587",
                         max(read_errs["repair_words"], big_errs["repair_words"]),
                         read_times["repair_words slot 3, XOR fold"]),
        "rs_bitmatmul": ("t3fs_torch/csrc/rs_bitmatmul.cu", "t3fs/ops/pallas_codec.py:68",
                         max(read_errs["rs_bitmatmul"], big_errs["rs_bitmatmul"]),
                         read_times[f"rs_bitmatmul RS(6+3) decode want={LOST63}"]),
        "crc_bytes": ("t3fs_torch/csrc/crc_bytes.cu",
                      "t3fs/ops/pallas_codec.py:116", e_bytes,
                      byte_times["crc_bytes 64 x 4 MiB"]),
        "copy3d": ("t3fs_torch/csrc/copy3d.cu", "benchmarks/devbench.py:91", e_copy,
                   copy_times),
    }
    kernels = []
    for name in [*_codec_names, *_bench_names]:
        source, replaces, err, t = meta[name]
        launched = sum(run.get(name, 0) for run in main_runs)
        expect(launched > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t.get("library_ms"),
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
