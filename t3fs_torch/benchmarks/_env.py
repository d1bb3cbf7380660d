"""Shared bench bootstrap: in-process fabric (default) or live cluster.

The benches (`kvcache_bench`, `sort_bench`) build their environment
here so client-setup fixes land in one place.  Returns
(env, sc, chains): `env` has an async `stop()`, `sc` is a ready
StorageClient, `chains` the usable chain ids.

The port of benchmarks/_env.py.  The in-process fabric's nodes checksum on
the backend `args.checksum_backend` names, the port's StorageFabric default
("cuda") where it names none; there is no twin of the reference's
`ensure_device_or_cpu`, whose one job is to fall back to the CPU.
"""

from __future__ import annotations

from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig


async def make_env(args, config: StorageClientConfig | None = None):
    config = config or StorageClientConfig()
    if getattr(args, "mgmtd", ""):
        from t3fs_torch.client.mgmtd_client import MgmtdClient
        mg = MgmtdClient(args.mgmtd, refresh_period_s=0.5)
        await mg.start()
        sc = StorageClient(mg.routing, refresh_routing=mg.refresh,
                           config=config)
        return mg, sc, sorted(mg.routing().chains)
    from t3fs_torch.testing.fabric import StorageFabric
    fab = StorageFabric(
        num_nodes=args.nodes, replicas=args.replicas,
        checksum_backend=getattr(args, "checksum_backend", None),
        aio_read=not getattr(args, "no_aio", False),
        write_pipeline=getattr(args, "write_pipeline", None),
        stream_threshold=getattr(args, "stream_threshold", None))
    await fab.start()
    sc = StorageClient(lambda: fab.routing, client=fab.client, config=config)
    return fab, sc, [fab.chain_id]


async def make_meta_env(mgmtd_address: str):
    """Meta-client sibling of make_env: discover meta servers from mgmtd
    routing and return (MetaClient, async stop).  Fails with a clear
    message (and a clean mgmtd stop) when routing has no meta nodes —
    an unreachable mgmtd otherwise surfaces as a bare assert deep in
    MetaClient while the refresh task leaks."""
    from t3fs_torch.client.meta_client import MetaClient
    from t3fs_torch.client.mgmtd_client import MgmtdClient

    mg = MgmtdClient(mgmtd_address, refresh_period_s=0.5)
    await mg.start()
    meta_addrs = [n.address for n in mg.routing().nodes.values()
                  if n.node_type == "meta" and n.address]
    if not meta_addrs:
        await mg.stop()
        raise SystemExit(
            f"no meta nodes in routing from {mgmtd_address} "
            "(cluster down, wrong address, or meta not started)")
    mc = MetaClient(meta_addrs)

    async def stop():
        await mc.close_conn()
        await mg.stop()

    return mc, stop


async def medianize(fn, n: int = 3):
    """Drift-proof measurement (docs/bench_protocol.md): run the async
    bench `fn` (no args, returns a float) n times and return
    (median, runs).  The caller records BOTH — value quotes the median,
    the runs array goes in the entry verbatim."""
    import statistics
    runs = []
    for _ in range(n):
        runs.append(await fn())
    return statistics.median(runs), runs


async def medianize_ab(fn_a, fn_b, n: int = 3):
    """Interleaved A/B per docs/bench_protocol.md: alternate a/b within
    one session so drift hits both sides equally.  Returns
    ((median_a, runs_a), (median_b, runs_b))."""
    import statistics
    runs_a, runs_b = [], []
    for _ in range(n):
        runs_a.append(await fn_a())
        runs_b.append(await fn_b())
    return ((statistics.median(runs_a), runs_a),
            (statistics.median(runs_b), runs_b))
