"""Hierarchical capacity queues — the KAI/run.ai Queue analog.

The reference deploys KAI queues as CRs with a parent tree and per-resource
envelopes (`operator/e2e/yaml/queues.yaml:22-30`: `spec.parentQueue`,
`spec.resources.<res>.{quota,limit,overQuotaWeight}`; installed by
`operator/e2e/setup/kai_scheduler.go:90`). This module rebuilds those
semantics for the TPU control plane — a pure-Python admission calculus the
controller consults before a gang reaches the solver (no CRs, no scheduler
plugins: the tree lives in operator config).

Semantics (the KAI model, restated as rules):

- **quota** — the queue's deserved share, -1 = unlimited. Usage is
  HIERARCHICAL: a queue's usage includes every descendant's.
- **limit** — hard cap on (subtree) usage, -1 = none. Never exceedable.
- **overQuotaWeight** — 0 makes quota hard for that resource; > 0 lets the
  queue borrow beyond quota (up to limit) out of its parent's headroom,
  and orders contending borrowers in a pass (higher weight granted first).
- A ROOT queue can never exceed a set quota — there is no parent to borrow
  from. (This is also exactly the legacy flat-map behavior: flat queues are
  parentless, so their quotas stay hard and existing configs keep meaning
  what they meant.)
- **Reclaim** — a demand that fits its own queue's quota but is blocked
  because siblings' over-quota borrowing consumed the ancestor's headroom
  is entitled to evict those borrowers (in-quota beats borrowed). The tree
  names the victims; the controller performs the eviction with the same
  machinery as priority preemption.

The port's copy of grove_tpu/orchestrator/queues.py, whole; it imports nothing of
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_EPS = 1e-9


@dataclass(frozen=True)
class QueueResource:
    """One resource envelope: quota (deserved), limit (cap), weight."""

    quota: float = -1.0
    limit: float = -1.0
    over_quota_weight: float = 1.0


@dataclass
class QueueSpec:
    name: str
    parent: str | None = None
    resources: dict[str, QueueResource] = field(default_factory=dict)


@dataclass(frozen=True)
class Verdict:
    """Outcome of try_charge. `admitted` with `borrowed` distinguishes an
    in-quota grant from an over-quota one (grant ordering); a block carries
    the level it happened at and whether the contender was in-quota there
    (reclaim eligibility)."""

    admitted: bool
    borrowed: bool = False
    blocked_at: str | None = None
    blocked_reason: str = ""  # "limit" | "quota" | "root-quota"
    reclaim_eligible: bool = False


class QueueTree:
    """Validated queue forest + the admission calculus over a usage map.

    The usage map (`{queue: {res: used}}`, hierarchical — build it with
    `hierarchical_usage`) is owned by the caller and mutated by `charge`;
    the tree itself is immutable after construction.
    """

    def __init__(self, specs: dict[str, QueueSpec]):
        self.specs = dict(specs)
        for name, spec in self.specs.items():
            if spec.parent is not None and spec.parent not in self.specs:
                raise ValueError(
                    f"queue {name!r}: parentQueue {spec.parent!r} does not exist"
                )
        # Cycle check + ancestor chains (self first, root last).
        self._chain: dict[str, list[str]] = {}
        for name in self.specs:
            chain, seen = [], set()
            cur: str | None = name
            while cur is not None:
                if cur in seen:
                    raise ValueError(f"queue {name!r}: parentQueue cycle at {cur!r}")
                seen.add(cur)
                chain.append(cur)
                cur = self.specs[cur].parent
            self._chain[name] = chain
        self._children: dict[str, list[str]] = {n: [] for n in self.specs}
        for name, spec in self.specs.items():
            if spec.parent is not None:
                self._children[spec.parent].append(name)

    @classmethod
    def from_flat(cls, flat: dict[str, dict[str, float]]) -> "QueueTree":
        """Legacy `{queue: {res: quota}}` map -> parentless hard-quota trees
        (roots can't borrow, so the old hard-quota behavior is preserved)."""
        return cls(
            {
                name: QueueSpec(
                    name=name,
                    resources={
                        res: QueueResource(quota=float(q)) for res, q in rmap.items()
                    },
                )
                for name, rmap in flat.items()
            }
        )

    def ancestors(self, name: str) -> list[str]:
        """name, parent, ..., root."""
        return self._chain[name]

    def roots(self) -> list[str]:
        """Parentless queues, sorted — the subtree seams. Each root's
        subtree is a self-contained borrow domain (roots cannot borrow), so
        roots are exactly the boundaries the cellular control plane shards
        on (grove_tpu/cells/partition.py)."""
        return sorted(n for n, s in self.specs.items() if s.parent is None)

    def leaves(self) -> list[str]:
        """Childless queues, sorted — the queues gangs are actually
        submitted to (hierarchical usage charges ancestors automatically)."""
        return sorted(n for n, kids in self._children.items() if not kids)

    def root_of(self, name: str) -> str:
        """The root of `name`'s subtree (name itself when parentless)."""
        return self._chain[name][-1]

    def subtree(self, name: str) -> set[str]:
        out, stack = set(), [name]
        while stack:
            cur = stack.pop()
            out.add(cur)
            stack.extend(self._children[cur])
        return out

    def hierarchical_usage(
        self, leaf_usage: dict[str, dict[str, float]]
    ) -> dict[str, dict[str, float]]:
        """Per-queue usage where every queue includes its descendants.
        `leaf_usage` charges each gang to the queue it was submitted to
        (controller.queue_usage); unknown queue names are ignored."""
        out: dict[str, dict[str, float]] = {n: {} for n in self.specs}
        for qname, res in leaf_usage.items():
            if qname not in self.specs:
                continue
            for anc in self._chain[qname]:
                acc = out[anc]
                for rname, qty in res.items():
                    acc[rname] = acc.get(rname, 0.0) + qty
        return out

    def envelope(self, qname: str, rname: str) -> QueueResource:
        """The (quota, limit, weight) envelope for one resource at one
        level. A resource the spec doesn't mention is unconstrained."""
        return self.specs[qname].resources.get(rname, QueueResource())

    _res = envelope  # internal alias

    def borrow_weight(self, qname: str, demand: dict[str, float]) -> float:
        """Grant-ordering weight for an over-quota demand: the most
        conservative (minimum) overQuotaWeight across demanded resources."""
        if not demand:
            return 0.0
        return min(self._res(qname, r).over_quota_weight for r in demand)

    def try_charge(
        self,
        usage: dict[str, dict[str, float]],
        qname: str,
        demand: dict[str, float],
        commit: bool = True,
        allow_borrow: bool = True,
    ) -> Verdict:
        """Can `demand` land in `qname` given hierarchical `usage`?

        Walks the ancestor chain: every level's limit must hold; a level
        pushed past a set quota needs that level's weight > 0 for every
        over-quota resource AND a parent to borrow from. On admission (and
        commit=True) the demand is charged to the whole chain.

        `allow_borrow=False` treats EVERY set quota as hard — the serving
        pass uses it to classify: in-quota demands grant first (deserved
        before borrowed), over-quota candidates retry with borrowing in
        weight order afterward.
        """
        if qname not in self.specs:
            # Unknown queue: admission (api/admission.py) should have
            # rejected it; fail open here so a stale annotation cannot
            # wedge scheduling behind a KeyError.
            return Verdict(admitted=True)
        borrowed = False
        in_quota_at_self = True
        for level, anc in enumerate(self._chain[qname]):
            used = usage.get(anc, {})
            for rname, qty in demand.items():
                new = used.get(rname, 0.0) + qty
                env = self._res(anc, rname)
                if env.limit != -1 and new > env.limit + _EPS:
                    return Verdict(
                        admitted=False,
                        blocked_at=anc,
                        blocked_reason="limit",
                        reclaim_eligible=False,
                    )
                if env.quota != -1 and new > env.quota + _EPS:
                    if level == 0:
                        in_quota_at_self = False
                    is_root = self.specs[anc].parent is None
                    if is_root or env.over_quota_weight <= 0.0 or not allow_borrow:
                        return Verdict(
                            admitted=False,
                            blocked_at=anc,
                            blocked_reason="root-quota" if is_root else "quota",
                            # In-quota at its own level but squeezed out of
                            # an ancestor's headroom by borrowers -> may
                            # reclaim. (Meaningless in allow_borrow=False
                            # classification calls; callers consult it only
                            # on the borrowing retry.)
                            reclaim_eligible=in_quota_at_self and level > 0,
                        )
                    borrowed = True
        if commit:
            self.charge(usage, qname, demand)
        return Verdict(admitted=True, borrowed=borrowed)

    def charge(
        self, usage: dict[str, dict[str, float]], qname: str, demand: dict[str, float]
    ) -> None:
        for anc in self._chain.get(qname, ()):
            acc = usage.setdefault(anc, {})
            for rname, qty in demand.items():
                acc[rname] = acc.get(rname, 0.0) + qty

    def over_quota_queues(
        self, usage: dict[str, dict[str, float]], under: str
    ) -> set[str]:
        """Queues in `under`'s subtree whose own usage exceeds their own set
        quota on any resource — the reclaim victim pool (borrowers)."""
        out = set()
        for name in self.subtree(under):
            used = usage.get(name, {})
            for rname, qty in used.items():
                env = self._res(name, rname)
                if env.quota != -1 and qty > env.quota + _EPS:
                    out.add(name)
                    break
        return out

    def describe(self) -> dict[str, dict]:
        """Static tree shape for observability (statusz/CLI)."""
        return {
            name: {
                "parent": spec.parent,
                "quota": {r: e.quota for r, e in spec.resources.items()},
                "limit": {r: e.limit for r, e in spec.resources.items()},
                "overQuotaWeight": {
                    r: e.over_quota_weight for r, e in spec.resources.items()
                },
            }
            for name, spec in self.specs.items()
        }

    def depth(self, name: str) -> int:
        return len(self._chain[name]) - 1


def _parse_qty(value, ctx: str) -> float:
    """quota/limit value: -1 (unlimited) or a k8s quantity."""
    from grove_tpu_torch.api.quantity import parse_quantity

    if value == -1:
        return -1.0
    try:
        out = float(parse_quantity(value))
        if out < 0:
            raise ValueError("negative")
        return out
    except (ValueError, TypeError):
        raise ValueError(f"{ctx}: {value!r} is not a quantity or -1") from None


def parse_queue_config(
    queues: dict, errors: list[str] | None = None
) -> QueueTree | None:
    """`scheduling.queues` -> QueueTree. Both config shapes, per queue:

    - legacy flat `{resource: quota}` — a parentless hard-quota queue
      (exactly the pre-hierarchy behavior);
    - structured `{parentQueue: name?, resources: {res: {quota, limit,
      overQuotaWeight}}}` — the KAI Queue CR shape
      (e2e/yaml/queues.yaml:22-30).

    With `errors` (config validation), every problem is appended — one
    message per bad queue, `scheduling.queues.<q>...`-prefixed — and None
    is returned if any; without it (the manager booting validated config)
    the first problem raises ValueError.
    """
    if not queues:
        return None
    collected: list[str] = [] if errors is None else errors
    specs: dict[str, QueueSpec] = {}
    for qname, doc in queues.items():
        try:
            specs[qname] = _parse_one_queue(qname, doc)
        except ValueError as e:
            if errors is None:
                raise
            collected.append(str(e))
    if errors is not None and collected:
        return None
    try:
        return QueueTree(specs)
    except ValueError as e:
        msg = f"scheduling.queues: {e}"
        if errors is None:
            raise ValueError(msg) from None
        collected.append(msg)
        return None


def _parse_one_queue(qname: str, doc) -> QueueSpec:
    """One queue entry (either shape) -> QueueSpec; ValueError on the first
    problem with a `scheduling.queues.<q>...`-prefixed message."""
    ctx = f"scheduling.queues.{qname}"
    if not isinstance(doc, dict):
        raise ValueError(f"{ctx}: must map resource -> quota")
    if not ("resources" in doc or "parentQueue" in doc):
        # Legacy flat shape: {resource: quota}, parentless (hard quota).
        return QueueSpec(
            qname,
            None,
            {
                rname: QueueResource(quota=_parse_qty(q, f"{ctx}.{rname}"))
                for rname, q in doc.items()
            },
        )
    unknown = set(doc) - {"resources", "parentQueue"}
    if unknown:
        raise ValueError(f"{ctx}: unknown fields {sorted(unknown)}")
    parent = doc.get("parentQueue")
    if parent is not None and not isinstance(parent, str):
        raise ValueError(f"{ctx}.parentQueue: must be a queue name")
    resources: dict[str, QueueResource] = {}
    for rname, env in (doc.get("resources") or {}).items():
        rctx = f"{ctx}.resources.{rname}"
        if not isinstance(env, dict):
            raise ValueError(f"{rctx}: must map {{quota, limit, overQuotaWeight}}")
        bad = set(env) - {"quota", "limit", "overQuotaWeight"}
        if bad:
            raise ValueError(f"{rctx}: unknown fields {sorted(bad)}")
        quota = _parse_qty(env.get("quota", -1), f"{rctx}.quota")
        limit = _parse_qty(env.get("limit", -1), f"{rctx}.limit")
        weight = env.get("overQuotaWeight", 1)
        if (
            not isinstance(weight, (int, float))
            or isinstance(weight, bool)
            or weight < 0
        ):
            raise ValueError(f"{rctx}.overQuotaWeight: must be a number >= 0")
        if quota != -1 and limit != -1 and limit < quota:
            raise ValueError(f"{rctx}: limit {limit:g} is below quota {quota:g}")
        resources[rname] = QueueResource(quota, limit, float(weight))
    return QueueSpec(qname, parent, resources)
