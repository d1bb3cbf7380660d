"""The port's rendezvous chain-table solver (t3fs_torch.mgmtd.chain_table)
against the JAX package's (t3fs.mgmtd.chain_table): every case of
tests/test_chain_table.py run on the port (minimal movement, balance,
domains: removing one node of N reassigns <= ceil(C/N) + slack chains;
solver output always passes validate_ec_chains), then solve_chain_table,
solve_for_routing and diff_table equal across the packages on seeded node
sets: CR and EC tables, replicas 1-5, tagged and untagged domains, a node
added, a node removed, a mid-migration chain."""

import math
from collections import Counter

import pytest

from t3fs_torch.mgmtd.chain_table import (
    ChainMove, diff_table, node_domain, reassigned_chains, rendezvous_score,
    solve_chain_table, solve_for_routing,
)
from t3fs_torch.mgmtd.placement import select_ec_chains, validate_ec_chains
from t3fs_torch.mgmtd.types import (
    ChainInfo, ChainTable, ChainTargetInfo, NodeInfo, PublicTargetState,
    RoutingInfo,
)


def nodes_n(n, tags=None):
    return [NodeInfo(node_id=i, tags=list(tags(i)) if tags else [])
            for i in range(1, n + 1)]


def load_of(solved):
    return Counter(n for owners in solved.assignment.values()
                   for n in owners)


# ---- determinism / score stability ----

def test_scores_and_solve_deterministic():
    # the table must be reproducible across processes: same inputs, same
    # assignment, bit for bit (scores come from splitmix64, not hash())
    assert rendezvous_score(7, 3) == rendezvous_score(7, 3)
    assert rendezvous_score(7, 3) != rendezvous_score(7, 4)
    chains, nodes = list(range(1, 21)), nodes_n(6)
    a = solve_chain_table(chains, nodes, 3)
    b = solve_chain_table(chains, nodes, 3)
    assert a.assignment == b.assignment
    # salt gives an independent table (different placement universe)
    c = solve_chain_table(chains, nodes, 3, salt=1)
    assert c.assignment != a.assignment


# ---- the minimal-movement property (the point of rendezvous hashing) ----

def test_ec_remove_one_node_moves_few_chains():
    """EC (R=1), 10 nodes, 50 chains: dropping any one node reassigns at
    most ceil(C/N) + slack chains (the dropped node's own holdings plus
    bounded capacity-pass churn) — never a table-wide reshuffle."""
    chains, nodes = list(range(1, 51)), nodes_n(10)
    base = solve_chain_table(chains, nodes, 1, table_type="ec")
    cap = math.ceil(50 / 10)
    for drop in range(1, 11):
        after = solve_chain_table(
            chains, [n for n in nodes if n.node_id != drop], 1,
            table_type="ec")
        moved = reassigned_chains(base, after)
        assert len(moved) <= cap + 4, \
            f"dropping node {drop} moved {len(moved)} chains"
        # every chain the dropped node did NOT own and the capacity pass
        # left alone keeps a bit-identical owner set
        assert drop not in {n for c in after.assignment.values() for n in c}


def test_cr_remove_one_node_moves_few_chains():
    chains, nodes = list(range(1, 51)), nodes_n(10)
    base = solve_chain_table(chains, nodes, 3)
    cap = math.ceil(50 * 3 / 10)
    for drop in range(1, 11):
        after = solve_chain_table(
            chains, [n for n in nodes if n.node_id != drop], 3)
        assert len(reassigned_chains(base, after)) <= cap + 6


def test_add_node_steals_only_its_wins():
    chains, nodes = list(range(1, 51)), nodes_n(10)
    base = solve_chain_table(chains, nodes, 1, table_type="ec")
    after = solve_chain_table(chains, nodes + [NodeInfo(node_id=11)], 1,
                              table_type="ec")
    moved = reassigned_chains(base, after)
    assert 0 < len(moved) <= math.ceil(50 / 11) + 4
    # every moved chain moved TO the new node (or was capacity churn);
    # the new node holds a fair share
    assert load_of(after)[11] >= 1


# ---- balance (the capacity pass) ----

@pytest.mark.parametrize("table_type,replicas", [("cr", 3), ("ec", 1)])
def test_load_within_cap(table_type, replicas):
    chains, nodes = list(range(1, 51)), nodes_n(10)
    solved = solve_chain_table(chains, nodes, replicas,
                               table_type=table_type)
    cap = math.ceil(50 * solved.replicas / 10) + 1      # cap_slack=1
    assert max(load_of(solved).values()) <= cap


def test_ec_forces_single_replica():
    solved = solve_chain_table([1, 2, 3], nodes_n(3), 3, table_type="ec")
    assert solved.replicas == 1
    assert all(len(o) == 1 for o in solved.assignment.values())


def test_too_few_nodes_raises():
    with pytest.raises(ValueError):
        solve_chain_table([1, 2], nodes_n(2), 3)


# ---- failure domains ----

def test_owners_span_domains():
    # 9 nodes in 3 racks, R=3: every chain's owners hit 3 distinct racks
    nodes = nodes_n(9, tags=lambda i: [f"domain:rack{(i - 1) % 3}"])
    doms = {n.node_id: node_domain(n) for n in nodes}
    solved = solve_chain_table(list(range(1, 31)), nodes, 3)
    for cid, owners in solved.assignment.items():
        assert len({doms[o] for o in owners}) == 3, f"chain {cid}: {owners}"


def test_domain_constraint_relaxed_when_too_few_domains():
    # all 3 nodes in ONE rack: the constraint is vacuous, placement must
    # still succeed (a 3-node rack is a valid test topology)
    nodes = nodes_n(3, tags=lambda i: ["domain:rackA"])
    solved = solve_chain_table([1, 2], nodes, 3)
    assert all(len(set(o)) == 3 for o in solved.assignment.values())


def test_untagged_node_is_own_domain():
    assert node_domain(NodeInfo(node_id=7)) == "node:7"
    assert node_domain(NodeInfo(node_id=7, tags=["domain:r1"])) == "r1"


# ---- solve_for_routing + diff_table (what the rebalancer consumes) ----

def make_routing(chain_nodes_map, tables=()):
    r = RoutingInfo()
    for cid, node_ids in chain_nodes_map.items():
        r.chains[cid] = ChainInfo(cid, 1, [
            ChainTargetInfo(n * 100 + cid, n, PublicTargetState.SERVING)
            for n in node_ids])
    for t in tables:
        r.chain_tables[t.table_id] = t
    return r


def test_solve_for_routing_infers_type_and_replicas():
    r = make_routing({1: [1, 2, 3], 2: [2, 3, 4], 3: [1], 4: [2]},
                     tables=[ChainTable(1, [1, 2], table_type="cr"),
                             ChainTable(2, [3, 4], table_type="ec")])
    cr = solve_for_routing(r, 1, nodes_n(4))
    assert cr.table_type == "cr" and cr.replicas == 3
    ec = solve_for_routing(r, 2, nodes_n(4))
    assert ec.table_type == "ec" and ec.replicas == 1
    with pytest.raises(ValueError):
        solve_for_routing(r, 9, nodes_n(4))


def test_solve_for_routing_prefers_persisted_replicas():
    # the table's persisted desired replication wins over any width
    # inference — even when every live chain is (transiently) wider
    r = make_routing({1: [1, 2, 3]},
                     tables=[ChainTable(1, [1], table_type="cr",
                                        replicas=2)])
    assert solve_for_routing(r, 1, nodes_n(4)).replicas == 2


def test_solve_for_routing_width_fallback_ignores_midmigration_chain():
    # a table without persisted replicas: chain 2 is mid-move and transiently
    # R+1 wide (dst joined, src not yet detached).  The fallback must
    # take the modal width (R=2), not the max — solving for the inflated
    # max would schedule a duplicate move and ratchet the table to R+1
    r = make_routing({1: [1, 2], 2: [1, 2, 3], 3: [2, 3]},
                     tables=[ChainTable(1, [1, 2, 3], table_type="cr")])
    assert solve_for_routing(r, 1, nodes_n(4)).replicas == 2
    # tie between widths: prefer the smaller (never inflate)
    r2 = make_routing({1: [1, 2], 2: [1, 2, 3]},
                      tables=[ChainTable(1, [1, 2], table_type="cr")])
    assert solve_for_routing(r2, 1, nodes_n(4)).replicas == 2


def test_diff_table_pairs_leave_with_join():
    r = make_routing({1: [1, 2]},
                     tables=[ChainTable(1, [1], table_type="cr")])
    solved = solve_chain_table([1], nodes_n(2), 2)
    solved.assignment[1] = [2, 3]            # want: node 1 out, node 3 in
    moves = diff_table(r, solved)
    assert moves == [ChainMove(chain_id=1, src_target_id=101,
                               src_node_id=1, dst_node_id=3,
                               dst_target_id=3 * 100 + 1)]


def test_diff_table_skips_pure_grow_emits_shrink():
    r = make_routing({1: [1, 2]},
                     tables=[ChainTable(1, [1], table_type="cr")])
    solved = solve_chain_table([1], nodes_n(2), 2)
    solved.assignment[1] = [1, 2, 3]         # grow only: not a *move*
    assert diff_table(r, solved) == []
    # shrink: an over-wide chain (e.g. an interrupted move that joined
    # its dst but never detached its src) must be walked back to R —
    # the surplus src pairs with a RETAINED member's existing target so
    # the driver skips straight to DRAIN+DETACH
    solved.assignment[1] = [1]
    assert diff_table(r, solved) == [
        ChainMove(chain_id=1, src_target_id=201, src_node_id=2,
                  dst_node_id=1, dst_target_id=101)]


def test_diff_table_shrinks_midmigration_leftover():
    # chain 1 is R+1 wide at [1, 2, 3] and the solver wants [1, 2]: one
    # shrink move removing node 3, alongside a normal swap on chain 2
    r = make_routing({1: [1, 2, 3], 2: [1, 4]},
                     tables=[ChainTable(1, [1, 2], table_type="cr")])
    solved = solve_chain_table([1, 2], nodes_n(4), 2)
    solved.assignment[1] = [1, 2]
    solved.assignment[2] = [1, 2]            # node 4 out, node 2 in
    moves = diff_table(r, solved)
    assert ChainMove(chain_id=1, src_target_id=301, src_node_id=3,
                     dst_node_id=1, dst_target_id=101) in moves
    assert ChainMove(chain_id=2, src_target_id=402, src_node_id=4,
                     dst_node_id=2, dst_target_id=2 * 100 + 2) in moves
    assert len(moves) == 2


def test_diff_table_converged_is_empty():
    nodes = nodes_n(5)
    solved = solve_chain_table(list(range(1, 11)), nodes, 1,
                               table_type="ec")
    r = make_routing({cid: owners
                      for cid, owners in solved.assignment.items()})
    assert diff_table(r, solved) == []


# ---- select_ec_chains: solve-then-validate ----

def test_select_ec_swap_repair_beats_greedy_ordering():
    """Greedy order (chain 10 first) blocks both alternatives; the swap
    local search must find the valid {11, 12} selection instead of
    raising — greedy failure is an ordering artifact here."""
    r = make_routing({10: [2, 3], 11: [1, 2], 12: [3, 4]})
    chains = select_ec_chains(r, 1, 1, candidates=[10, 11, 12])
    assert sorted(chains) == [11, 12]
    assert validate_ec_chains(r, chains, 1)


def test_select_ec_output_always_validates():
    # sweep small topologies: whenever select succeeds, the validator
    # agrees (the acceptance-criteria invariant)
    for n_nodes in (4, 5, 7):
        for n_chains in (8, 10, 14):
            r = make_routing({c: [(c - 1) % n_nodes + 1]
                              for c in range(1, n_chains + 1)})
            for m in (1, 2):
                k = min(n_chains - m, 2 * m + 2)
                try:
                    chains = select_ec_chains(r, k, m)
                except ValueError:
                    continue
                assert len(chains) == k + m
                assert validate_ec_chains(r, chains, m)


# ---- the port against the reference, on seeded node sets ----

import numpy as np                                    # noqa: E402

from t3fs.mgmtd import chain_table as ref_ct          # noqa: E402
from t3fs.mgmtd import types as ref_types             # noqa: E402
from t3fs_torch.mgmtd import chain_table as port_ct    # noqa: E402
from t3fs_torch.mgmtd import types as port_types      # noqa: E402

PACKAGES = ((ref_ct, ref_types), (port_ct, port_types))


def _nodes(types, ids, domains):
    return [types.NodeInfo(node_id=i, tags=[f"domain:{domains[i]}"]
                           if domains.get(i) else [])
            for i in ids]


def _routing(types, chains, tables):
    r = types.RoutingInfo()
    for cid, node_ids in chains.items():
        r.chains[cid] = types.ChainInfo(cid, 1, [
            types.ChainTargetInfo(n * 100 + cid, n,
                                  types.PublicTargetState.SERVING)
            for n in node_ids])
    for table_id, ids, ttype, replicas in tables:
        r.chain_tables[table_id] = types.ChainTable(
            table_id, list(ids), table_type=ttype, replicas=replicas)
    return r


def _solved(s):
    return (s.table_type, s.replicas, s.capacity_moves,
            sorted((c, list(o)) for c, o in s.assignment.items()))


def _moves(moves):
    return [(m.chain_id, m.src_target_id, m.src_node_id, m.dst_node_id,
             m.dst_target_id) for m in moves]


def _case(seed):
    """A seeded node set and chain table: 4-12 nodes (a few racks or none),
    10-60 chains, replicas 1-5, CR or EC."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 13))
    ids = sorted(int(x) for x in rng.choice(np.arange(1, 40), n,
                                             replace=False))
    racks = int(rng.integers(0, 4))
    domains = {i: f"rack{int(rng.integers(0, racks))}" for i in ids} \
        if racks else {}
    chains = list(range(1, int(rng.integers(10, 61)) + 1))
    ttype = "ec" if rng.random() < 0.3 else "cr"
    replicas = int(rng.integers(1, min(5, n) + 1))
    return rng, ids, domains, chains, ttype, replicas


@pytest.mark.parametrize("seed", range(24))
def test_solve_equal_across_packages(seed):
    """The same node set solves to the same owners, capacity moves and
    type in both packages; so does the set with a node added and one
    removed, and every cap_slack and salt tried."""
    rng, ids, domains, chains, ttype, replicas = _case(seed)
    extra = max(ids) + 1
    variants = [(ids, 1, 0), (ids + [extra], 1, 0), (ids[1:], 1, 0),
                (ids, 0, 0), (ids, 2, 7)]
    for node_ids, slack, salt in variants:
        if len(node_ids) < replicas:
            continue
        got = [_solved(ct.solve_chain_table(
            chains, _nodes(types, node_ids, domains), replicas,
            table_type=ttype, cap_slack=slack, salt=salt))
            for ct, types in PACKAGES]
        assert got[0] == got[1], (seed, node_ids, slack, salt)
    before = [ct.solve_chain_table(chains, _nodes(t, ids, domains), replicas,
                                   table_type=ttype) for ct, t in PACKAGES]
    after = [ct.solve_chain_table(chains, _nodes(t, ids + [extra], domains),
                                  replicas, table_type=ttype)
             for ct, t in PACKAGES]
    assert ref_ct.reassigned_chains(before[0], after[0]) == \
        port_ct.reassigned_chains(before[1], after[1])


@pytest.mark.parametrize("seed", range(24))
def test_routing_solve_and_diff_equal_across_packages(seed):
    """solve_for_routing and diff_table on one seeded routing (a CR table
    with and without persisted replicas, an EC table, one chain
    mid-migration at R+1) against a node set with one node removed and
    one added: the same SolvedTable owners and the same ChainMove list in
    both packages."""
    rng, ids, domains, chains, _ttype, replicas = _case(seed)
    replicas = max(2, min(replicas, len(ids) - 1))
    cr = chains[:len(chains) // 2 + 1]
    ec = chains[len(cr):]
    layout = {}
    for i, cid in enumerate(cr):
        layout[cid] = [ids[(i + j) % len(ids)] for j in range(replicas)]
    layout[cr[0]] = layout[cr[0]] + [
        n for n in ids if n not in layout[cr[0]]][:1]   # mid-migration
    for i, cid in enumerate(ec):
        layout[cid] = [ids[i % len(ids)]]
    persisted = replicas if seed % 2 else 0
    tables = [(1, cr, "cr", persisted), (2, ec, "ec", 0)] if ec \
        else [(1, cr, "cr", persisted)]
    cands = [n for n in ids if n != ids[seed % len(ids)]] + [max(ids) + 1]
    for table_id, *_ in tables:
        outs = []
        for ct, types in PACKAGES:
            r = _routing(types, layout, tables)
            solved = ct.solve_for_routing(r, table_id,
                                          _nodes(types, cands, domains))
            outs.append((_solved(solved), _moves(ct.diff_table(r, solved))))
        assert outs[0] == outs[1], (seed, table_id)
        assert outs[0][1], (seed, table_id)     # the removed node moves
