"""Deterministic fault injection (port of
``spark_rapids_tpu/fault/inject.py``).

Conf ``spark.rapids.sql.tpu.faults.spec`` names faults to fire at
instrumented sites, e.g.::

    dispatch:oom@3;d2h:device_lost@1;spill:slow=200ms@2

Grammar (entries joined by ``;``)::

    entry    := site ":" kind ["=" duration] "@" n ["+"]
    site     := dispatch | h2d | d2h | spill | unspill | exchange | scan
                | mesh
    kind     := oom | device_lost | slow
    duration := <float> ("ms" | "s")     (slow only; default ms)
    n        := 1-based call index at that site; "+" = that call AND
                every call after it (a persistent fault: it uses up the
                device replays and forces the host fallback)

Counters are per site and reset every ``session.execute`` (the spec is
installed per query).  Injected errors carry an explicit
``rapids_error_class``.

The sites: ``dispatch`` once per batch a GPU exec produces
(``plan/physical.py``: the JAX package fires it once per jitted call; the
port has no compiled stages), ``h2d`` and ``d2h`` (``batch.py``), ``spill``
(on the writer thread; the error surfaces at the consumer's next
``get()``) and ``unspill`` (``mem/catalog.py``), ``exchange``
(``parallel/exchange.py``) and ``scan`` (``io/scan_v2.py``, as each
chunk's decode is submitted).  ``mesh`` parses but fires nowhere yet: the
mesh stage it belongs to is not ported.  The port has no query scopes, so
the registry is the process's, installed and cleared by
``session.execute``.  Disarmed, a site costs one ``is None`` test.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.fault import metrics as fault_metrics
from spark_rapids_tpu_torch.fault.errors import ErrorClass

SITES = ("dispatch", "h2d", "d2h", "spill", "unspill", "exchange", "scan",
         "mesh")
KINDS = ("oom", "device_lost", "slow")


class InjectedFault(Exception):
    """An error fired by the fault registry; its class is explicit."""

    def __init__(self, message: str, error_class: ErrorClass):
        super().__init__(message)
        self.rapids_error_class = error_class


class _Rule:
    __slots__ = ("site", "kind", "at", "persistent", "duration_s")

    def __init__(self, site: str, kind: str, at: int, persistent: bool,
                 duration_s: float):
        self.site = site
        self.kind = kind
        self.at = at
        self.persistent = persistent
        self.duration_s = duration_s

    def matches(self, count: int) -> bool:
        return count == self.at or (self.persistent and count > self.at)

    def __repr__(self):
        arm = f"@{self.at}{'+' if self.persistent else ''}"
        dur = f"={self.duration_s * 1000:g}ms" if self.kind == "slow" else ""
        return f"{self.site}:{self.kind}{dur}{arm}"


def parse_spec(spec: str) -> List[_Rule]:
    """Parse a faults.spec string; a bad entry raises ValueError, so a
    typo fails the query instead of injecting nothing."""
    rules: List[_Rule] = []
    for raw in (spec or "").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        try:
            site, rest = entry.split(":", 1)
            kindspec, at = rest.rsplit("@", 1)
            persistent = at.endswith("+")
            n = int(at[:-1] if persistent else at)
            kind, _, arg = kindspec.partition("=")
            site, kind = site.strip(), kind.strip()
            if site not in SITES:
                raise ValueError(f"unknown site {site!r} (one of {SITES})")
            if kind not in KINDS:
                raise ValueError(f"unknown kind {kind!r} (one of {KINDS})")
            if n < 1:
                raise ValueError("call index must be >= 1")
            duration_s = 0.0
            if kind == "slow":
                a = arg.strip().lower() or "100ms"
                if a.endswith("ms"):
                    duration_s = float(a[:-2]) / 1000.0
                elif a.endswith("s"):
                    duration_s = float(a[:-1])
                else:
                    duration_s = float(a) / 1000.0
            elif arg:
                raise ValueError(f"kind {kind!r} takes no argument")
            rules.append(_Rule(site, kind, n, persistent, duration_s))
        except ValueError as e:
            raise ValueError(
                f"bad faults.spec entry {entry!r}: {e} "
                f"(grammar: site:kind[=dur]@N[+])") from None
    return rules


class FaultRegistry:
    def __init__(self, rules: List[_Rule]):
        self._rules: Dict[str, List[_Rule]] = {}
        for r in rules:
            self._rules.setdefault(r.site, []).append(r)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def fire(self, site: str) -> Optional[Tuple[_Rule, int]]:
        """Count one call at ``site``: the matching rule, if any, and the
        call index."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            for r in self._rules.get(site, ()):
                if r.matches(count):
                    return r, count
        return None


_ACTIVE: Optional[FaultRegistry] = None
_INSTALL_LOCK = threading.Lock()


def install(spec: str) -> None:
    """(Re)install the registry from a spec; empty clears it.  Counters
    restart at every install."""
    global _ACTIVE
    rules = parse_spec(spec)
    with _INSTALL_LOCK:
        _ACTIVE = FaultRegistry(rules) if rules else None


def uninstall() -> None:
    install("")


def active() -> bool:
    return _ACTIVE is not None


def maybe_fire(site: str) -> None:
    """The sites' hook: a no-op unless a spec is installed.  A matching
    rule raises :class:`InjectedFault` (oom, device_lost) or sleeps
    (slow)."""
    reg = _ACTIVE
    if reg is None:
        return
    hit = reg.fire(site)
    if hit is None:
        return
    rule, count = hit
    fault_metrics.record("faults_injected")
    if rule.kind == "oom":
        raise InjectedFault(
            f"RESOURCE_EXHAUSTED: injected OOM at {site} call {count} "
            f"({rule!r})", ErrorClass.RETRYABLE_OOM)
    if rule.kind == "device_lost":
        raise InjectedFault(
            f"INTERNAL: injected device loss (worker crashed) at {site} "
            f"call {count} ({rule!r})", ErrorClass.DEVICE_LOST)
    # slow: sleep in small slices so a deadline watchdog's exception
    # lands within ~10 ms of expiry, not after the whole stall
    deadline = time.monotonic() + rule.duration_s
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(0.01, left))
