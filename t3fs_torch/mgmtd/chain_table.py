"""Rendezvous-hashed chain tables: elastic placement for CR and EC chains.

Reference analog: deploy/data_placement -type {CR,EC} — the reference
solves placement as an integer program per *epoch*; when membership
changes it re-solves from scratch and the new table can move almost
every chain.  t3fs instead derives the table from highest-random-weight
(rendezvous) hashing so membership change is *incremental by
construction*:

  score(chain, node) = mix64(chain_id, node_id)   # stable, uniform
  owners(chain)      = top-R nodes by score, one per failure domain

Removing a node only reassigns the chains where it was a top-R owner
(expected chains*R/N); every other chain's owner set is bit-identical.
Adding a node only steals the chains where it now ranks top-R.  A
bounded *capacity pass* then repairs statistical imbalance: nodes over
``ceil(chains*R/N) + cap_slack`` demote their lowest-score wins to the
best under-cap runner-up, so the table stays balanced without an ILP
while churn stays local.

Failure domains come from node tags (``domain:rackA``); untagged nodes
are their own domain.  EC tables are the R=1 case (single-replica shard
chains), CR tables R=replicas — same math, matching the reference's two
table types.

The port of t3fs/mgmtd/chain_table.py, a copy with its imports re-pointed:
the same seeds and node sets solve to the same tables in both packages.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from t3fs_torch.mgmtd.types import ChainInfo, NodeInfo, RoutingInfo

DOMAIN_TAG_PREFIX = "domain:"


def _mix64(x: int) -> int:
    """splitmix64 finalizer: deterministic across processes/runs (unlike
    Python's salted hash()) — the table must be reproducible everywhere."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def rendezvous_score(chain_id: int, node_id: int, salt: int = 0) -> int:
    """Stable per-(chain, node) weight; the whole table derives from it."""
    return _mix64((chain_id << 24) ^ (node_id << 4) ^ salt)


def node_domain(node: NodeInfo) -> str:
    """Failure domain from operator tags; untagged = its own domain."""
    for t in node.tags or ():
        if isinstance(t, str) and t.startswith(DOMAIN_TAG_PREFIX):
            return t[len(DOMAIN_TAG_PREFIX):]
    return f"node:{node.node_id}"


@dataclass
class SolvedTable:
    """Target assignment for one chain table."""
    table_type: str                               # "cr" | "ec"
    replicas: int
    assignment: dict[int, list[int]] = field(default_factory=dict)
    # chains whose owner set the capacity pass changed vs pure HRW
    # (observability: how much balance cost in churn)
    capacity_moves: int = 0

    def nodes_of(self, chain_id: int) -> list[int]:
        return self.assignment.get(chain_id, [])


def solve_chain_table(chain_ids: list[int], nodes: list[NodeInfo],
                      replicas: int, *, table_type: str = "cr",
                      cap_slack: int = 1, salt: int = 0) -> SolvedTable:
    """Rendezvous-derive the owner set of every chain, then repair
    imbalance with a bounded capacity pass.

    ``cap_slack`` trades balance for churn: 0 forces the tightest
    per-node load (more movement on membership change), larger values
    keep more pure-HRW wins (less movement, looser balance)."""
    if table_type == "ec":
        replicas = 1
    if replicas < 1:
        raise ValueError(f"replicas {replicas} < 1")
    if len(nodes) < replicas:
        raise ValueError(
            f"{len(nodes)} nodes < {replicas} replicas: cannot place")
    domains = {n.node_id: node_domain(n) for n in nodes}
    distinct_domains = len(set(domains.values()))
    solved = SolvedTable(table_type=table_type, replicas=replicas)

    # pass 1: pure HRW owner sets, one node per failure domain when the
    # topology has enough domains (else the constraint is vacuous and
    # dropped — a 3-node rack must still be placeable)
    want_domains = distinct_domains >= replicas
    ranked: dict[int, list[int]] = {}
    for cid in chain_ids:
        order = sorted((n.node_id for n in nodes),
                       key=lambda nid: rendezvous_score(cid, nid, salt),
                       reverse=True)
        ranked[cid] = order
        owners: list[int] = []
        used_domains: set[str] = set()
        for nid in order:
            if want_domains and domains[nid] in used_domains:
                continue
            owners.append(nid)
            used_domains.add(domains[nid])
            if len(owners) == replicas:
                break
        if len(owners) < replicas:       # domain filter too strict: relax
            for nid in order:
                if nid not in owners:
                    owners.append(nid)
                    if len(owners) == replicas:
                        break
        solved.assignment[cid] = owners

    # pass 2: capacity repair.  Overloaded nodes demote their LOWEST-
    # score wins (the ones a membership change would most likely move
    # anyway) to the best-scored under-cap candidate not already on the
    # chain.  Processing one demotion at a time keeps the pass greedy
    # and the churn bounded by the overload itself.
    total = len(chain_ids) * replicas
    cap = -(-total // max(1, len(nodes))) + max(0, cap_slack)
    load: dict[int, int] = {n.node_id: 0 for n in nodes}
    for owners in solved.assignment.values():
        for nid in owners:
            load[nid] += 1
    over = [nid for nid, c in load.items() if c > cap]
    for nid in over:
        # wins sorted ascending by score: shed the weakest claims first
        wins = sorted(
            (cid for cid, owners in solved.assignment.items()
             if nid in owners),
            key=lambda cid: rendezvous_score(cid, nid, salt))
        for cid in wins:
            if load[nid] <= cap:
                break
            owners = solved.assignment[cid]
            used = {domains[o] for o in owners if o != nid}
            for cand in ranked[cid]:
                if cand in owners or load[cand] >= cap:
                    continue
                if want_domains and domains[cand] in used:
                    continue
                owners[owners.index(nid)] = cand
                load[nid] -= 1
                load[cand] += 1
                solved.capacity_moves += 1
                break
    return solved


def solve_for_routing(routing: RoutingInfo, table_id: int,
                      nodes: list[NodeInfo], *, replicas: int | None = None,
                      cap_slack: int = 1) -> SolvedTable:
    """Solve one existing chain table against a candidate node set.
    Table 1 is CR, any other table is EC (single-replica shard chains).

    CR replication comes from the table's persisted ``replicas`` when
    set; the fallback for pre-15 tables uses the MODE of live chain
    widths, never the max — a chain mid-migration transiently carries
    R+1 targets (dst joined, src not yet detached), and solving for the
    inflated max would pair a second destination onto that chain and
    ratchet the whole table to R+1 on every subsequent solve."""
    table = routing.chain_tables.get(table_id)
    if table is None:
        raise ValueError(f"chain table {table_id} not in routing")
    table_type = getattr(table, "table_type", "") or \
        ("cr" if table_id == 1 else "ec")
    if replicas is None:
        if table_type != "cr":
            replicas = 1
        elif getattr(table, "replicas", 0) > 0:
            replicas = table.replicas
        else:
            widths = Counter(
                len(c.targets) for cid in table.chain_ids
                if (c := routing.chain(cid)) is not None)
            if not widths:
                replicas = 1
            else:
                top = max(widths.values())
                replicas = min(w for w, n in widths.items() if n == top)
    return solve_chain_table(list(table.chain_ids), nodes, replicas,
                             table_type=table_type, cap_slack=cap_slack)


@dataclass
class ChainMove:
    """One planned membership change: src target leaves, dst node joins."""
    chain_id: int = 0
    src_target_id: int = 0
    src_node_id: int = 0
    dst_node_id: int = 0
    dst_target_id: int = 0


def diff_table(routing: RoutingInfo, solved: SolvedTable,
               *, target_id_of=None) -> list[ChainMove]:
    """Per-chain moves from the CURRENT membership to the solved target.
    Pairs leaving nodes with joining nodes deterministically (sorted).
    Surplus leaves beyond the joins (an over-wide chain, e.g. R+1 left
    behind by an interrupted move whose JOIN applied but whose DETACH
    never ran) become *shrink* moves: the src is paired with a retained
    member already on the chain, so the migration driver sees the dst
    SERVING and skips straight to DRAIN+DETACH of the surplus target —
    without this the planner can never walk an over-wide chain back to
    R and the table wedges un-converged.  A chain that only GROWS is
    still not a move (that is repair's job, not the rebalancer's)."""
    from t3fs_torch.mgmtd.placement import target_id as _tid
    target_id_of = target_id_of or _tid
    moves: list[ChainMove] = []
    for cid in sorted(solved.assignment):
        chain = routing.chain(cid)
        if chain is None:
            continue
        current = {t.node_id: t.target_id for t in chain.targets}
        want = set(solved.assignment[cid])
        leave = sorted(n for n in current if n not in want)
        join = sorted(n for n in want if n not in current)
        for src_node, dst_node in zip(leave, join):
            moves.append(ChainMove(
                chain_id=cid,
                src_target_id=current[src_node], src_node_id=src_node,
                dst_node_id=dst_node,
                dst_target_id=target_id_of(dst_node, cid - 1)))
        keep = sorted(n for n in want if n in current)
        if keep:
            for src_node in leave[len(join):]:
                moves.append(ChainMove(
                    chain_id=cid,
                    src_target_id=current[src_node], src_node_id=src_node,
                    dst_node_id=keep[0],
                    # the retained member's EXISTING target: the driver
                    # finds it SERVING and goes straight to DRAIN
                    dst_target_id=current[keep[0]]))
    return moves


def reassigned_chains(before: SolvedTable, after: SolvedTable) -> list[int]:
    """Chains whose owner set changed between two solves (test/ops
    helper for the minimal-movement property)."""
    out = []
    for cid, owners in before.assignment.items():
        if sorted(after.assignment.get(cid, [])) != sorted(owners):
            out.append(cid)
    return out
