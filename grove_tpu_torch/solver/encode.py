"""Encode PodGangs into the dense, padded batch the solver consumes.

Shapes are static per (MG, MS, MP) bucket, so every wave of a bucket has one
shape (SURVEY.md §7 "ragged shapes" discipline):
  G  gangs in the batch          MG max PodGroups per gang
  MS max pack-sets per gang      MP max pods per gang
  N  nodes                       R  resource kinds
  L  topology levels

A *pack-set* is one packing constraint instance: (subset of groups, level) —
"all pods of these groups must land in ONE domain at this level". Gang-level
TopologyConstraint covers all groups (scheduler podgang.go:55-57), each
TopologyConstraintGroupConfig covers its subset (podgang.go:120-128), each
PodGroup constraint covers itself (podgang.go:84-88). Sets are ordered
broadest→narrowest so domain commitment can proceed top-down.

Every pod of a PodGroup shares one template (podgang.go:75 "share the same
PodTemplateSpec"), so a group is encoded as (request-vector, total, required)
and placement is count allocation, not per-pod assignment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.podgang import PodGang
from grove_tpu_torch.state.cluster import ClusterSnapshot, pod_request_vector


class GangBatch(NamedTuple):
    """Dense solver input; all arrays are numpy (device put happens in solve)."""

    group_req: np.ndarray  # f32 [G, MG, R] per-pod request of each group
    group_total: np.ndarray  # i32 [G, MG] pods referenced
    group_required: np.ndarray  # i32 [G, MG] gang floor (min_replicas, clamped)
    group_valid: np.ndarray  # bool [G, MG]
    set_member: np.ndarray  # bool [G, MS, MG]
    set_req_level: np.ndarray  # i32 [G, MS] topology level index, -1 = none
    set_pref_level: np.ndarray  # i32 [G, MS] topology level index, -1 = none
    set_valid: np.ndarray  # bool [G, MS]
    # Domain pin for incremental re-solve: when part of a gang is already
    # bound, a required pack-set stays in the domain its bound pods occupy
    # (encode_gangs' `bound_nodes_by_group`). -1 = unpinned.
    set_pinned: np.ndarray  # i32 [G, MS] domain ordinal at set_req_level
    pod_group: np.ndarray  # i32 [G, MP] group index of each pod slot, -1 pad
    pod_rank: np.ndarray  # i32 [G, MP] rank of pod within its group
    gang_valid: np.ndarray  # bool [G]
    # Allocation order over groups: required-pack-constrained groups first so
    # unconstrained groups can't consume a committed domain's capacity, then
    # biggest demand first (classic first-fit-decreasing).
    group_order: np.ndarray  # i32 [G, MG] permutation of group indices
    # Scaled gangs only schedule once their base gang is scheduled
    # (grove.io/base-podgang; podclique/components/pod/syncflow.go:347-387).
    # Index of the base gang within this batch (must be earlier), -1 = no dep.
    depends_on: np.ndarray  # i32 [G]
    # Cross-batch chaining (pipelined waves): each gang's slot in a
    # caller-defined global gang table, and the base gang's slot there when
    # the base was solved in an EARLIER batch. The solver resolves these
    # against the `ok_global` verdict bitmap it carries between waves, so
    # wave k+1 can be encoded and dispatched before wave k's results reach
    # the host. -1 = unset / no cross-batch dependency.
    global_index: np.ndarray  # i32 [G]
    depends_global: np.ndarray  # i32 [G]
    # ReuseReservationRef bias (podgang.go:65-71): nodes the gang's previous
    # incarnation occupied. Seeds the solver's per-gang locality (w_reuse), so
    # a rolling-updated gang prefers its old placement when capacity allows.
    reuse_nodes: np.ndarray = None  # bool [G, N]
    # Per-group node eligibility from pod nodeSelector (we ARE the scheduler,
    # so selector semantics are enforced here, not delegated): bool [G, MG, N]
    # or None when no pod in the batch carries a selector — the common case
    # pays nothing.
    group_node_ok: np.ndarray = None
    # Replica spread (PCS topologySpreadDomain): base gangs of one PCS repel
    # the spread-level domains sibling replicas occupy (w_spread). All three
    # are None unless some gang in the batch carries a spread constraint.
    spread_level: np.ndarray = None  # i32 [G] topology level index, -1 = none
    spread_family: np.ndarray = None  # i32 [G] batch slot of family root, -1
    spread_avoid: np.ndarray = None  # bool [G, N] sibling nodes live in store

    @property
    def n_gangs(self) -> int:
        return self.group_req.shape[0]


@dataclass
class GangDecodeInfo:
    """Host-side mapping from batch slots back to object names."""

    gang_names: list[str]
    # per gang, per pod slot: pod name ("" for padding)
    pod_names: list[list[str]]
    group_names: list[list[str]]
    # The decode's slot arrays, built once (slot_arrays).
    _slots: tuple | None = field(default=None, repr=False, compare=False)

    def slot_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(slot_gang i32 [S], slot_col i32 [S], slot_pod object [S]) over the
        NON-EMPTY pod-name slots, row-major (sorted by gang); decode_bindings
        gathers admitted (gang, slot) pairs against these."""
        if self._slots is None:
            if self.pod_names:
                pod_arr = np.asarray(self.pod_names, dtype=object)  # [G, MP]
                gi, sj = np.nonzero(pod_arr != "")
                self._slots = (gi.astype(np.int32), sj.astype(np.int32), pod_arr[gi, sj])
            else:
                empty = np.zeros((0,), dtype=np.int32)
                self._slots = (empty, empty, np.zeros((0,), dtype=object))
        return self._slots


def stack_batches(batches: list, pad_to: int | None = None) -> GangBatch:
    """Batches of one shape stacked field by field on a leading [W] axis
    (a scan chunk's input; drain.py `_solve_scan_chunk`'s stack_tree).
    `pad_to` appends null waves — every field zero, so no gang is valid —
    up to that many steps."""
    batches = list(batches)
    if pad_to is not None and pad_to > len(batches):
        null = GangBatch(*(None if x is None else np.zeros_like(np.asarray(x))
                           for x in batches[0]))
        batches += [null] * (pad_to - len(batches))
    return GangBatch(*(
        None if fields[0] is None else np.stack([np.asarray(x) for x in fields])
        for fields in zip(*batches)
    ))


def _level_index(snapshot: ClusterSnapshot, label_key: str | None) -> int:
    """Node-label key (IR constraint) → topology level index in the snapshot."""
    if label_key is None:
        return -1
    for li, domain in enumerate(snapshot.level_domains):
        level = snapshot.topology.label_key_for(domain)
        if level == label_key:
            return li
    return -1


def next_pow2(v: int) -> int:
    """Next power of two >= v (min 1) — THE bucketing rounding, shared by the
    sidecar's shape buckets and the drain planner so policy cannot diverge."""
    return max(1, 1 << (max(v, 1) - 1).bit_length())


_BLOCKING_EFFECTS = ("NoSchedule", "NoExecute")


def _tolerates(tolerations: list[dict], taint: dict) -> bool:
    """k8s toleration-vs-taint match: key equal (or empty key + Exists),
    operator Equal -> values equal, effect empty-or-equal."""
    for tol in tolerations:
        op = tol.get("operator", "Equal")
        key = tol.get("key", "")
        if key and key != taint.get("key"):
            continue
        if not key and op != "Exists":
            continue
        if op == "Equal" and tol.get("value", "") != taint.get("value", ""):
            continue
        eff = tol.get("effect", "")
        if eff and eff != taint.get("effect", ""):
            continue
        return True
    return False


def node_tolerated(tolerations: list[dict], taints: list[dict]) -> bool:
    """True iff every scheduling-blocking taint on the node is tolerated
    (PreferNoSchedule is soft and never blocks)."""
    return all(
        _tolerates(tolerations, t)
        for t in taints
        if t.get("effect") in _BLOCKING_EFFECTS
    )


def pack_set_count(gang: PodGang) -> int:
    """Number of pack-sets this gang encodes to (shape-bucketing input)."""
    tc = gang.spec.topology_constraint
    n = 1 if tc is not None and tc.pack_constraint is not None else 0
    n += sum(
        1
        for gc in gang.spec.topology_constraint_group_configs
        if gc.topology_constraint is not None
        and gc.topology_constraint.pack_constraint is not None
    )
    n += sum(
        1
        for grp in gang.spec.pod_groups
        if grp.topology_constraint is not None
        and grp.topology_constraint.pack_constraint is not None
    )
    return n


def gang_shape(gang: PodGang) -> tuple[int, int, int]:
    """(groups, pack-sets, pods) — the encode-shape signature. Batching gangs
    of one shape class instead of padding everything to the global maxima
    keeps small gangs on small compiled programs (measured 3.5x on the bench
    backlog's frontend class)."""
    return (len(gang.spec.pod_groups), pack_set_count(gang), gang.total_pods())


def _encode_cross_batch_fields(
    batch: GangBatch,
    gi: int,
    gang: PodGang,
    gang_index: dict[str, int],
    scheduled_gangs: set[str],
    global_index_of: dict[str, int] | None,
) -> None:
    """Batch-positional fields: global table slot + the base-gang gate."""
    if global_index_of is not None:
        batch.global_index[gi] = global_index_of.get(gang.name, -1)
    if gang.base_podgang_name is not None:
        base_idx = gang_index.get(gang.base_podgang_name, -1)
        if 0 <= base_idx < gi:
            batch.depends_on[gi] = base_idx
        elif (
            global_index_of is not None
            and gang.base_podgang_name in global_index_of
        ):
            # Base solved in an earlier wave: resolve the verdict on-device
            # via the solver's ok_global bitmap (pipelined chaining).
            batch.depends_global[gi] = global_index_of[gang.base_podgang_name]
        elif gang.base_podgang_name not in scheduled_gangs:
            # Base gang in neither this batch, the global table nor the
            # scheduled set: gate this gang out.
            batch.gang_valid[gi] = False


def _seed_reuse_row(
    reuse_arr: np.ndarray | None,
    gi: int,
    gang: PodGang,
    reuse_nodes_by_gang: dict[str, list[int]] | None,
    snapshot: ClusterSnapshot,
    g_count: int,
) -> np.ndarray | None:
    """ReuseReservationRef seed row; lazily materializes the [G, N] tensor."""
    for node_idx in (reuse_nodes_by_gang or {}).get(gang.name, []):
        if 0 <= node_idx < snapshot.capacity.shape[0]:
            if reuse_arr is None:
                reuse_arr = np.zeros((g_count, snapshot.capacity.shape[0]), dtype=bool)
            reuse_arr[gi, node_idx] = True
    return reuse_arr


# Shared rank table for the pod-slot fill: slicing a prebuilt arange is
# cheaper than allocating one per group; grown on demand for outsized gangs.
_RANKS = np.arange(4096, dtype=np.int32)


def _ranks(n: int) -> np.ndarray:
    global _RANKS
    if n > _RANKS.shape[0]:
        _RANKS = np.arange(max(n, 2 * _RANKS.shape[0]), dtype=np.int32)
    return _RANKS[:n]


# GangBatch fields that depend only on one gang's spec (+ snapshot epoch +
# bound-node pins): exactly the rows the encode-row cache may reuse. The
# rest (depends_on, global_index, depends_global, the base-gang gate, the
# reuse and spread seeds) depend on the batch's composition and are always
# recomputed.
_ROW_FIELDS = (
    "group_req",
    "group_total",
    "group_required",
    "group_valid",
    "set_member",
    "set_req_level",
    "set_pref_level",
    "set_valid",
    "set_pinned",
    "pod_group",
    "pod_rank",
    "group_order",
)


def encode_gangs(
    gangs: list[PodGang],
    pods_by_name: dict[str, Pod],
    snapshot: ClusterSnapshot,
    *,
    max_groups: int | None = None,
    max_sets: int | None = None,
    max_pods: int | None = None,
    pad_gangs_to: int | None = None,
    scheduled_gangs: set[str] | None = None,
    bound_nodes_by_group: dict[str, dict[str, list[int]]] | None = None,
    global_index_of: dict[str, int] | None = None,
    reuse_nodes_by_gang: dict[str, list[int]] | None = None,
    spread_avoid_by_gang: dict[str, list[int]] | None = None,
    row_cache=None,
    row_keys: list | None = None,
) -> tuple[GangBatch, GangDecodeInfo]:
    """Flatten gang CRs into the padded batch + decode info (the JAX
    package's encode_gangs, its vectorized fill; the output is the same
    array for array, with and without the row cache).

    A scaled gang whose base gang is neither in this batch (at an earlier
    index), nor in `global_index_of`, nor in `scheduled_gangs` (names of
    gangs admitted by earlier solves) is marked invalid
    (syncflow.go:347-387).

    `bound_nodes_by_group`: gang name -> group name -> node indices of that
    group's pods bound by earlier solves. A required pack-set is pinned to
    the domain the first bound member pod occupies (an incremental re-solve
    must not split a co-location guarantee across domains).

    `reuse_nodes_by_gang`: gang name -> snapshot node indices its previous
    incarnation occupied (ReuseReservationRef, podgang.go:65-71).

    `global_index_of`: gang name -> slot in a caller-defined global gang table
    (wave chaining). A base-gang dependency on a gang outside this batch
    becomes a `depends_global` reference resolved on the device against the
    solver's `ok_global` bitmap.

    `spread_avoid_by_gang`: gang name -> node indices sibling replicas occupy
    in the store (replica spread seed).

    `row_cache` / `row_keys` (solver/warm.py `EncodeRowCache`, and per gang
    a key that folds in its spec digest and the snapshot's encode_epoch()):
    each gang's spec rows are kept under (row key, resource axis, bound-node
    signature) at the bucket dims they were encoded under. A gang whose key
    recurs copies its rows from the cache instead of walking its spec; a
    hit whose dims differ from this batch's (bucket drift) is demoted and
    re-encoded. The constraint walk is memoized by the row key alone, so a
    demoted gang still skips it. Batch-positional fields are always
    recomputed.
    """
    g_count = pad_gangs_to if pad_gangs_to is not None else len(gangs)
    if g_count < len(gangs):
        raise ValueError("pad_gangs_to smaller than gang count")
    r = len(snapshot.resource_names)

    def _sets_of(gang: PodGang):
        """Return ((member group indices, req_level, pref_level, pin_names)
        broad→narrow, schedulable). `pin_names` are the member group names
        the pin lookup consults, None for the whole gang. A REQUIRED key that
        doesn't resolve to a snapshot topology level makes the gang
        unschedulable."""
        group_idx = {grp.name: k for k, grp in enumerate(gang.spec.pod_groups)}
        raw: list[tuple[list[int], int, int, list[str] | None]] = []
        unresolved_required = False

        def levels_of(pc) -> tuple[int, int]:
            nonlocal unresolved_required
            req = _level_index(snapshot, pc.required)
            if pc.required is not None and req < 0:
                unresolved_required = True
            return req, _level_index(snapshot, pc.preferred)

        if gang.spec.topology_constraint and gang.spec.topology_constraint.pack_constraint:
            req, pref = levels_of(gang.spec.topology_constraint.pack_constraint)
            raw.append((list(range(len(gang.spec.pod_groups))), req, pref, None))
        for gc in gang.spec.topology_constraint_group_configs:
            if gc.topology_constraint and gc.topology_constraint.pack_constraint:
                members = [group_idx[n] for n in gc.pod_group_names if n in group_idx]
                if members:
                    req, pref = levels_of(gc.topology_constraint.pack_constraint)
                    raw.append((members, req, pref, list(gc.pod_group_names)))
        for k, grp in enumerate(gang.spec.pod_groups):
            if grp.topology_constraint and grp.topology_constraint.pack_constraint:
                req, pref = levels_of(grp.topology_constraint.pack_constraint)
                raw.append(([k], req, pref, [grp.name]))
        # Drop sets with neither level resolvable.
        raw = [s for s in raw if s[1] >= 0 or s[2] >= 0]
        # Broadest required level first (-1 required sorts last).
        raw.sort(key=lambda s: (s[1] if s[1] >= 0 else 10**6))
        return raw, not unresolved_required

    mg = max_groups or max((len(g.spec.pod_groups) for g in gangs), default=1) or 1
    mp = max_pods or max((g.total_pods() for g in gangs), default=1) or 1
    # Row reuse: resolve cache entries before the spec walk, so hits skip
    # _sets_of (the stored n_sets feeds the ms default).
    bound_map = bound_nodes_by_group or {}
    row_entries: list = [None] * len(gangs)
    row_full_keys: list = [None] * len(gangs)
    cached = row_cache is not None and row_keys is not None
    if cached:
        if len(row_keys) != len(gangs):
            raise ValueError("row_keys length must match gangs")
        for gi, gang in enumerate(gangs):
            bound = bound_map.get(gang.name)
            bound_sig = (
                tuple(sorted((grp, tuple(idxs)) for grp, idxs in bound.items())) if bound else ()
            )
            row_full_keys[gi] = (row_keys[gi], r, bound_sig)
            row_entries[gi] = row_cache.peek(row_full_keys[gi])

    def _sets_resolve(gi: int, gang: PodGang):
        # The constraint walk per (spec digest, snapshot epoch): exactly the
        # row key, which folds in everything _sets_of reads.
        if cached:
            hit = row_cache.peek_sets(row_keys[gi])
            if hit is not None:
                return hit
        out = _sets_of(gang)
        if cached:
            row_cache.put_sets(row_keys[gi], out)
        return out

    sets_and_ok = [
        None if row_entries[gi] is not None else _sets_resolve(gi, g)
        for gi, g in enumerate(gangs)
    ]
    ms = max_sets or max(
        (
            row_entries[gi]["n_sets"] if row_entries[gi] is not None else len(sets_and_ok[gi][0])
            for gi in range(len(gangs))
        ),
        default=1,
    ) or 1
    # Demote hits whose bucket dims drifted: the stored rows are shaped by
    # the bucket they were encoded under.
    for gi in range(len(gangs)):
        if row_entries[gi] is not None and row_entries[gi]["dims"] != (mg, ms, mp):
            row_entries[gi] = None
            sets_and_ok[gi] = _sets_resolve(gi, gangs[gi])
    all_sets = [None if s is None else s[0] for s in sets_and_ok]
    sets_resolvable = [None if s is None else s[1] for s in sets_and_ok]

    batch = GangBatch(
        group_req=np.zeros((g_count, mg, r), dtype=np.float32),
        group_total=np.zeros((g_count, mg), dtype=np.int32),
        group_required=np.zeros((g_count, mg), dtype=np.int32),
        group_valid=np.zeros((g_count, mg), dtype=bool),
        set_member=np.zeros((g_count, ms, mg), dtype=bool),
        set_req_level=np.full((g_count, ms), -1, dtype=np.int32),
        set_pref_level=np.full((g_count, ms), -1, dtype=np.int32),
        set_valid=np.zeros((g_count, ms), dtype=bool),
        set_pinned=np.full((g_count, ms), -1, dtype=np.int32),
        pod_group=np.full((g_count, mp), -1, dtype=np.int32),
        pod_rank=np.zeros((g_count, mp), dtype=np.int32),
        gang_valid=np.zeros((g_count,), dtype=bool),
        group_order=np.tile(np.arange(mg, dtype=np.int32), (g_count, 1)),
        depends_on=np.full((g_count,), -1, dtype=np.int32),
        global_index=np.full((g_count,), -1, dtype=np.int32),
        depends_global=np.full((g_count,), -1, dtype=np.int32),
        # reuse_nodes / group_node_ok / spread_* stay None unless some gang
        # needs them: the dense [G, N] planes only materialize when in play.
    )
    decode = GangDecodeInfo(gang_names=[], pod_names=[], group_names=[])
    gang_index = {g.name: i for i, g in enumerate(gangs)}
    scheduled_gangs = scheduled_gangs or set()
    selector_masks: np.ndarray | None = None  # bool [G, MG, N], lazy
    reuse_arr: np.ndarray | None = None  # bool [G, N], lazy
    # One O(N) label scan per UNIQUE selector / toleration set, not per group.
    selector_rows: dict[tuple, np.ndarray] = {}
    toleration_rows: dict[tuple, np.ndarray] = {}
    tainted_idx = snapshot.tainted_node_indices(_BLOCKING_EFFECTS)
    # Normalize per resource before summing — raw units are incomparable.
    cap_scale = snapshot.cap_scale()
    n_nodes = snapshot.capacity.shape[0]

    # Hits are applied batched after the loop (one fancy-index copy per
    # field), and misses store their rows the same way (miss_puts).
    hit_rows: list[tuple[int, dict]] = []
    miss_puts: list[tuple] = []
    for gi, gang in enumerate(gangs):
        entry = row_entries[gi]
        if entry is not None:
            # The spec (and the snapshot epoch in the key) is unchanged since
            # the rows were built: reuse them, skip the spec walk. The
            # entry's name lists are private to the cache and only read.
            row_cache.hits += 1
            decode.gang_names.append(gang.name)
            decode.pod_names.append(entry["pod_names"])
            decode.group_names.append(entry["group_names"])
            batch.gang_valid[gi] = entry["resolvable"]
            hit_rows.append((gi, entry))
            if entry["sel_rows"]:
                if selector_masks is None:
                    selector_masks = np.ones((g_count, mg, n_nodes), dtype=bool)
                for k, sel_row in entry["sel_rows"].items():
                    selector_masks[gi, k] = sel_row
            _encode_cross_batch_fields(
                batch, gi, gang, gang_index, scheduled_gangs, global_index_of
            )
            reuse_arr = _seed_reuse_row(
                reuse_arr, gi, gang, reuse_nodes_by_gang, snapshot, g_count
            )
            continue
        if cached:
            row_cache.misses += 1
        if len(gang.spec.pod_groups) > mg:
            raise ValueError(f"gang {gang.name}: {len(gang.spec.pod_groups)} groups > bucket {mg}")
        if gang.total_pods() > mp:
            raise ValueError(f"gang {gang.name}: {gang.total_pods()} pods > bucket {mp}")
        decode.gang_names.append(gang.name)
        pod_names: list[str] = []
        group_names: list[str] = []
        miss_sel_rows: dict[int, np.ndarray] = {}
        batch.gang_valid[gi] = sets_resolvable[gi]
        reuse_arr = _seed_reuse_row(
            reuse_arr, gi, gang, reuse_nodes_by_gang, snapshot, g_count
        )
        _encode_cross_batch_fields(
            batch, gi, gang, gang_index, scheduled_gangs, global_index_of
        )
        slot = 0
        for k, grp in enumerate(gang.spec.pod_groups):
            group_names.append(grp.name)
            refs = [ref.name for ref in grp.pod_references]
            batch.group_total[gi, k] = len(refs)
            batch.group_required[gi, k] = min(grp.min_replicas, len(refs))
            batch.group_valid[gi, k] = True
            if refs:
                first = pods_by_name.get(refs[0])
                if first is None:
                    raise ValueError(
                        f"gang {gang.name}: pod {refs[0]!r} referenced by group "
                        f"{grp.name!r} not found in pods_by_name"
                    )
                batch.group_req[gi, k] = pod_request_vector(first, snapshot.resource_names)
                selector = first.spec.node_selector
                if selector or tainted_idx:
                    # nodeSelector + taint semantics: a node is eligible iff
                    # its labels are a superset of the selector AND every
                    # blocking taint is tolerated. Pods of one group share a
                    # template, so the first pod speaks for the group.
                    if selector_masks is None:
                        selector_masks = np.ones((g_count, mg, n_nodes), dtype=bool)
                    row = np.ones((n_nodes,), dtype=bool)
                    if selector:
                        key = tuple(sorted(selector.items()))
                        sel_row = selector_rows.get(key)
                        if sel_row is None:
                            sel_row = np.fromiter(
                                (
                                    all(lbl.get(sk) == sv for sk, sv in key)
                                    for lbl in snapshot.node_labels
                                ),
                                dtype=bool,
                                count=len(snapshot.node_labels),
                            )
                            selector_rows[key] = sel_row
                        row = row & sel_row
                    if tainted_idx:
                        tols = first.spec.tolerations
                        tkey = tuple(tuple(sorted(t.items())) for t in tols)
                        tol_row = toleration_rows.get(tkey)
                        if tol_row is None:
                            tol_row = np.ones((n_nodes,), dtype=bool)
                            for i in tainted_idx:
                                tol_row[i] = node_tolerated(tols, snapshot.node_taints[i])
                            toleration_rows[tkey] = tol_row
                        row = row & tol_row
                    selector_masks[gi, k] = row
                    miss_sel_rows[k] = row
            nr = len(refs)
            batch.pod_group[gi, slot : slot + nr] = k
            batch.pod_rank[gi, slot : slot + nr] = _ranks(nr)
            pod_names.extend(refs)
            slot += nr
        if len(all_sets[gi]) > ms:
            raise ValueError(f"gang {gang.name}: {len(all_sets[gi])} pack-sets > bucket {ms}")
        gang_bound = bound_map.get(gang.name, {})
        req_constrained: set[int] = set()
        for si, (members, req_l, pref_l, pin_names) in enumerate(all_sets[gi]):
            batch.set_valid[gi, si] = True
            batch.set_req_level[gi, si] = req_l
            batch.set_pref_level[gi, si] = pref_l
            for k in members:
                batch.set_member[gi, si, k] = True
                if req_l >= 0:
                    req_constrained.add(k)
            if req_l >= 0 and gang_bound:
                # The original member names: a fully bound group dropped
                # from an incremental sub-gang still anchors the pin.
                lookup = gang_bound.keys() if pin_names is None else pin_names
                for name in lookup:
                    for node_idx in gang_bound.get(name, []):
                        dom = int(snapshot.node_domain_id[req_l, node_idx])
                        if dom >= 0:
                            batch.set_pinned[gi, si] = dom
                            break
                    if batch.set_pinned[gi, si] >= 0:
                        break
        # Constrained groups first, then biggest normalized demand first.
        demand = (
            batch.group_total[gi] * (batch.group_req[gi] / cap_scale[None, :]).sum(axis=1)
        ).tolist()
        batch.group_order[gi] = np.array(
            sorted(range(mg), key=lambda k: (k not in req_constrained, -demand[k])),
            dtype=np.int32,
        )
        pod_names += [""] * (mp - len(pod_names))
        decode.pod_names.append(pod_names)
        decode.group_names.append(group_names)
        if cached:
            miss_puts.append((gi, len(all_sets[gi]), pod_names, group_names, miss_sel_rows))

    if hit_rows:
        # Entries stored together share their field stacks (_stacks, _row):
        # hits grouped by stack apply with one gather + assign per field.
        groups: dict[int, tuple] = {}
        for gi, entry in hit_rows:
            sd = entry["_stacks"]
            rec = groups.setdefault(id(sd), (sd, [], []))
            rec[1].append(gi)
            rec[2].append(entry["_row"])
        for sd, gis, js in groups.values():
            gi_arr = np.asarray(gis, dtype=np.intp)
            j_arr = np.asarray(js, dtype=np.intp)
            for fname in _ROW_FIELDS:
                getattr(batch, fname)[gi_arr] = sd[fname][j_arr]
    if miss_puts:
        midx = np.fromiter((m[0] for m in miss_puts), dtype=np.intp, count=len(miss_puts))
        # One contiguous copy per field for every miss gang; each stored row
        # is a view into the stack, which nothing writes after this point.
        stacks = {f: getattr(batch, f)[midx].copy() for f in _ROW_FIELDS}
        for j, (gi, n_sets, pod_names_j, group_names_j, sel_rows_j) in enumerate(miss_puts):
            rows = {f: stacks[f][j] for f in _ROW_FIELDS}
            rows.update(
                dims=(mg, ms, mp),
                n_sets=n_sets,
                resolvable=bool(sets_resolvable[gi]),
                pod_names=list(pod_names_j),
                group_names=list(group_names_j),
                sel_rows=sel_rows_j,
                _stacks=stacks,
                _row=j,
            )
            row_cache.put(row_full_keys[gi], rows)

    if selector_masks is not None:
        batch = batch._replace(group_node_ok=selector_masks)
    if reuse_arr is not None:
        batch = batch._replace(reuse_nodes=reuse_arr)

    # Replica spread: base gangs whose spec carries a resolvable spread_key
    # get a level, a family root (first base sibling of the same PCS in this
    # batch), and an avoid seed. No spread in the batch → all three None.
    spread_active = [
        gi
        for gi, gang in enumerate(gangs)
        if gang.spec.spread_key is not None
        and gang.base_podgang_name is None
        and _level_index(snapshot, gang.spec.spread_key) >= 0
    ]
    if spread_active:
        spread_level = np.full((g_count,), -1, dtype=np.int32)
        spread_family = np.full((g_count,), -1, dtype=np.int32)
        spread_avoid = np.zeros((g_count, n_nodes), dtype=bool)
        family_root: dict[str, int] = {}
        for gi in spread_active:
            gang = gangs[gi]
            spread_level[gi] = _level_index(snapshot, gang.spec.spread_key)
            fam_key = gang.pcs_name or gang.name
            spread_family[gi] = family_root.setdefault(fam_key, gi)
            for node_idx in (spread_avoid_by_gang or {}).get(gang.name, []):
                if 0 <= node_idx < n_nodes:
                    spread_avoid[gi, node_idx] = True
        batch = batch._replace(
            spread_level=spread_level,
            spread_family=spread_family,
            spread_avoid=spread_avoid,
        )
    return batch, decode
