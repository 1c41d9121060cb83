"""File-lease leader election — the k8s Lease-object analog.

Mirror of the reference's leader-election contract
(`operator/api/config/v1alpha1/types.go:73-104`): one holder at a time,
lease must be renewed within renewDeadline, a stale lease (past
leaseDuration) can be stolen. Implemented over an atomic
write-to-temp + rename on a shared filesystem path, which gives HA restarts
on a single host or a shared volume — the deployment surfaces this stack
actually targets (there is no kube-apiserver to host a Lease CR).
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import dataclass, field

from grove_tpu_torch.utils.fsio import atomic_write_json


@dataclass
class FileLease:
    path: str
    lease_duration_seconds: float = 15.0
    # Leader stands down if it failed to renew within this window (types.go:
    # renewDeadline): a stalled reconcile loop must stop acting as leader
    # BEFORE the lease can be stolen at lease_duration, so two leaders never
    # overlap. None = no deadline enforcement.
    renew_deadline_seconds: float | None = None
    identity: str = field(default_factory=lambda: f"{os.getpid()}-{uuid.uuid4().hex[:8]}")
    _last_renew: float | None = field(default=None, repr=False)

    def _read(self) -> dict | None:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _write(self, doc: dict) -> None:
        atomic_write_json(self.path, doc)

    def try_acquire(self, now: float | None = None) -> bool:
        """Acquire or renew; returns True when this process holds the lease.

        A different holder's lease is honored until it expires
        (leaseDurationSeconds past its last renewal), then stolen.
        """
        now = time.time() if now is None else now
        doc = self._read()
        if doc is not None:
            holder = doc.get("holder")
            renewed = float(doc.get("renewed", 0.0))
            if holder != self.identity and now - renewed < self.lease_duration_seconds:
                self._last_renew = None
                return False
        # Renew-deadline enforcement: if we held the lease but overslept the
        # renewal window (e.g. a reconcile pass stalled), stand down for this
        # tick instead of silently extending — the reference leader cancels
        # itself rather than risk overlapping a successor (types.go:73-104).
        if (
            self.renew_deadline_seconds is not None
            and self._last_renew is not None
            and now - self._last_renew > self.renew_deadline_seconds
        ):
            self._last_renew = None
            self.release()
            return False
        self._write({"holder": self.identity, "renewed": now})
        # Re-read to confirm we won any racing rename (last writer wins; the
        # loser observes the winner's identity here and stands down).
        doc = self._read()
        won = bool(doc and doc.get("holder") == self.identity)
        self._last_renew = now if won else None
        return won

    def held(self, now: float | None = None) -> bool:
        """True while this process holds the lease: the last try_acquire
        won, no stand-down happened since, and leaseDurationSeconds has not
        elapsed without renewal — an expired lease is stealable by anyone,
        so it no longer counts as held even if nobody has stolen it yet."""
        if self._last_renew is None:
            return False
        now = time.time() if now is None else now
        return now - self._last_renew < self.lease_duration_seconds

    def release(self) -> None:
        doc = self._read()
        if doc and doc.get("holder") == self.identity:
            try:
                os.unlink(self.path)
            except OSError:
                pass


_LEASE_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


class LeaseSet:
    """Multiple named leases held by ONE process — one per reconcile cell.

    Each name maps to its own `FileLease` at `<directory>/<name>.lease` with
    its OWN renewal clock (`_last_renew` is per-FileLease state), so a cell
    whose reconcile stalls past its renew deadline stands down for THAT
    lease only: losing one cell's lease never releases another's
    (tests/test_cells.py pins this with a fake clock). All leases share one
    process identity so a restarted process steals its own stale leases
    uniformly.
    """

    def __init__(
        self,
        directory: str,
        *,
        lease_duration_seconds: float = 15.0,
        renew_deadline_seconds: float | None = None,
        identity: str | None = None,
    ) -> None:
        self.directory = directory
        self.lease_duration_seconds = float(lease_duration_seconds)
        self.renew_deadline_seconds = renew_deadline_seconds
        self.identity = (
            identity
            if identity is not None
            else f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        self._leases: dict[str, FileLease] = {}

    def lease(self, name: str) -> FileLease:
        """The named lease (created lazily). Names are path components, so
        only [A-Za-z0-9._-] is accepted — a separator in a cell name must
        not escape the lease directory."""
        got = self._leases.get(name)
        if got is not None:
            return got
        if not name or not set(name) <= _LEASE_NAME_OK or name.startswith("."):
            raise ValueError(f"lease name {name!r}: use [A-Za-z0-9_-][A-Za-z0-9._-]*")
        got = FileLease(
            path=os.path.join(self.directory, f"{name}.lease"),
            lease_duration_seconds=self.lease_duration_seconds,
            renew_deadline_seconds=self.renew_deadline_seconds,
            identity=self.identity,
        )
        self._leases[name] = got
        return got

    def try_acquire(self, name: str, now: float | None = None) -> bool:
        """Acquire/renew one named lease; the other names' clocks are
        untouched (independent renewal — the whole point of the set)."""
        return self.lease(name).try_acquire(now)

    def held(self, now: float | None = None) -> dict[str, bool]:
        """Holdership per name (True = the most recent try_acquire won, no
        stand-down since, and the lease has not expired unrenewed). Pass
        `now` when driving the leases on a fake clock."""
        return {
            name: lease.held(now)
            for name, lease in sorted(self._leases.items())
        }

    def release(self, name: str) -> None:
        got = self._leases.get(name)
        if got is not None:
            got.release()

    def release_all(self) -> None:
        for lease in self._leases.values():
            lease.release()
