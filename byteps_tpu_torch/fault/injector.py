"""Deterministic, seeded fault injection at named sites; port of
``byteps_tpu/fault/injector.py``, whole: the same spec grammar, the same
site names and the same string-seeded ``random.Random`` per rule, so one
spec and seed give one schedule in both packages, with the JAX
module's flight-recorder events (``fault.kill`` with a dump before the
exit, ``fault.bitflip``, ``fault.slow_cleared``, ``fault.partition``,
``fault.partition_healed``).  ``kill:site=coordinator`` fires only in
the process that hosts the membership bus (``fault/membership.py``).

The JAX package's description follows.  The subsystem exists so the
recovery path (detector → suspend → resume → restore) can be *proved*
to work: a
chaos run configures ``BYTEPS_FAULT_SPEC`` and the injector fires
scripted faults at well-known points of the stack.  Adaptive runtimes
treat degraded/late/lost participants as first-class states (PAPERS:
arxiv 2105.07829, 2412.14374); this is the harness that manufactures
those states on demand.

Spec grammar (``BYTEPS_FAULT_SPEC``, ``;``- or ``,``-separated faults)::

    kill:rank=1:step=40            die (os._exit) when this process's
                                   push_pull counter reaches step 40
    kill:site=coordinator:step=40  die at step 40 ONLY if this process
                                   is currently the membership
                                   coordinator (hosts the control
                                   plane) — chaos lanes kill "whoever
                                   coordinates" without hardcoding a
                                   rank.  Matches the PROCESS-LIFETIME
                                   push counter (which survives the
                                   disarm/re-arm of an elastic
                                   suspend/resume): a successor whose
                                   lifetime counter is already past the
                                   step is never cascade-killed by the
                                   re-armed schedule
    kill:site=serve_host_start:step=1   die at serve-host startup,
                                   BEFORE HOST-UP (step=N = the Nth
                                   start of this process; N=1 is the
                                   deterministic crash-looper the
                                   reconciler's flap ban is tested with)
    delay:site=dcn:p=0.01:ms=200   sleep 200ms with prob 0.01 per visit
    bitflip:site=server_push:p=0.001   flip one random bit of the pushed
                                   value with prob 0.001
    straggler:rank=2:ms=50         rank 2 sleeps 50ms at every dispatch
    drop:site=heartbeat:p=0.2      drop 20% of heartbeat sends
    slow:rank=1:site=sync:ms=300:n=20   GRAY failure: rank 1 sleeps
                                   300ms at EVERY visit of the sync
                                   site for its first 20 visits, then
                                   the fault clears (``n`` absent =
                                   slow forever).  Unlike ``delay``
                                   (probabilistic one-shots) this is a
                                   sustained per-rank throttle — the
                                   slow-but-alive condition the
                                   straggler chaos lane injects — and
                                   unlike ``straggler`` it has a
                                   bounded window, so recovery and
                                   probation readmission are testable
    partition:rank=2               SOCKET fault (site=transport, the
                                   default and only socket site): every
                                   transport socket operation on rank 2
                                   blackholes — connects refuse, sends
                                   vanish, received frames are
                                   discarded.  The per-send deadline
                                   surfaces the silence as ``AckLost``
                                   (never a hang); ``n=K`` bounds the
                                   partition to K socket ops (a healing
                                   partition), absent = partitioned
                                   forever
    conn_reset:p=0.05:n=3          SOCKET fault: the established
                                   connection is torn down with a real
                                   RST (SO_LINGER 0 close) mid
                                   send/recv with probability p; the
                                   supervisor reconnects and the sender
                                   retransmits from its sealed source
                                   copy (seq-token dedup absorbs a
                                   retry whose original landed).
                                   ``n=`` bounds total resets
    partial_write:p=0.05           SOCKET fault: a send writes only
                                   half its bytes, then RSTs — the
                                   receiver's length-prefixed read
                                   fails mid-frame and the connection
                                   dies exactly as a real half-written
                                   socket would
    slow_socket:ms=20:p=1          SOCKET fault: every matched send
                                   first sleeps ms — a sustained
                                   bandwidth/latency throttle on the
                                   wire, feeding the per-peer RTT
                                   histogram and the slowness tracker

Fields: ``rank`` (int, default: every rank), ``step`` (int, kill only),
``site`` (one of :data:`VALID_SITES`), ``p`` (probability in (0, 1],
default 1), ``ms`` (sleep milliseconds), ``n`` (visit budget, slow
only), ``code`` (kill exit code, default 1 — a *crash*, distinct from
the detector's restartable ``BYTEPS_FAILURE_EXIT_CODE``).  The set of
fields each kind accepts is exactly :data:`_KIND_FIELDS` — the master
table :data:`_FIELDS` is *derived* from it, so the two cannot drift
(pinned kind-by-field by tests/test_fault_injector.py).

Sites (where the hooks are woven):

- ``dispatch`` / ``sync`` — engine dispatcher pop / syncer completion
  (core/engine.py)
- ``dcn``    — collective dispatch (comm/collectives.py)
- ``server_push`` / ``server_pull`` — ServerEngine entry points
  (server/engine.py); ``bitflip`` corrupts the pushed value (or, with
  integrity envelopes armed, the sealed wire frame) here
- ``kv_push`` — KVStore delta pushes (server/kv_store.py); ``bitflip``
  corrupts the wire frame, ``drop`` loses the *acknowledgement* after
  the delta applied (the duplicate-retry scenario the seq dedup absorbs)
- ``serve_pull`` — the serving plane's pull-reply hop
  (server/serving.py); ``bitflip`` corrupts a reply frame (NACKed and
  retransmitted by the same envelope machine as pushes)
- ``heartbeat`` — the heartbeat client's UDP send
  (utils/failure_detector.py); ``drop`` suppresses the datagram

Determinism: every rule owns a :class:`random.Random` seeded from
``(BYTEPS_FAULT_SEED, rule index, kind, site)`` as a *string* — string
seeding is hash-randomization-free, so the same spec + seed produces the
identical injection schedule across processes and runs (pinned by
tests/test_fault_injector.py).

Disabled fast path: when no spec is armed, :data:`ENABLED` is ``False``
and every woven site is a single module-attribute check — nothing else
runs, no injector object exists, and the compiled collective programs
are byte-identical to a build without the hooks (the hooks live host-side,
never in-graph).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

from ..common.telemetry import counters
from ..common.logging import get_logger

_log = get_logger()

# Module-level fast path: hot call sites guard with `if injector.ENABLED:`
# — one attribute load + truth test when chaos is off.
ENABLED = False
_active: Optional["FaultInjector"] = None

# Process-lifetime push counter: unlike FaultInjector._step it survives
# the disarm/re-arm cycle of an elastic suspend/resume.  site=coordinator
# kills match THIS counter — with the per-incarnation counter, the
# surviving successor's re-armed schedule would re-approach the same step
# from zero and cascade-kill the new coordinator.
_lifetime_step = 0

# Process-lifetime visit accounting for `slow` rules (keyed by the
# rule's identity): a gray fault is a property of the HOST, not of one
# engine incarnation — an elastic suspend/resume (a demoted rank's
# rejoin!) re-arms the injector from config, and without this a slow
# fault whose n= window had already CLEARED would come back fresh and
# immediately re-demote the readmitted rank.
_slow_consumed: Dict[str, int] = {}


def _reset_lifetime_for_tests() -> None:
    global _lifetime_step
    _lifetime_step = 0
    _slow_consumed.clear()

# monkeypatch point for tests (a real os._exit would take pytest with it)
_exit = os._exit

VALID_KINDS = ("bitflip", "conn_reset", "delay", "drop", "kill",
               "partial_write", "partition", "slow", "slow_socket",
               "straggler")
VALID_SITES = (
    # bpslint: ignore[chaos-site] reason=kill-only predicate matched in on_step (die while hosting the control plane), never a woven fire() site
    "coordinator",
    "dcn",
    # durable-plane disk faults (server/wal.py): disk_full fails an
    # append with ENOSPC; fsync drops the sync the policy promised;
    # wal_write tears the on-disk record short (drop) or flips a bit in
    # it (bitflip) — the torn-tail/corrupt-segment recovery pins
    "disk_full", "dispatch", "fsync", "gossip", "heartbeat", "kv_push",
    "serve_host",
    # bpslint: ignore[chaos-site] reason=kill-only predicate matched in on_serve_start (die at serve-host startup, before HOST-UP), never a woven fire() site
    "serve_host_start",
    "serve_pull", "server_pull", "server_push", "sync", "transport",
    "wal_write")
# sites where corrupt() is actually woven; a bitflip elsewhere would
# silently never fire, so validation rejects it
CORRUPT_SITES = ("kv_push", "serve_pull", "server_push", "wal_write")
# socket-level kinds (comm/transport.py chaos shim): they act on raw
# socket operations via socket_fault(), not on fire()/corrupt() hooks,
# so they are only meaningful at the socket site(s) below — validation
# pins them there (and defaults them there)
SOCKET_KINDS = ("conn_reset", "partial_write", "partition", "slow_socket")
SOCKET_SITES = ("transport",)
# fields each kind actually reads — anything else is rejected, not
# silently ignored (kill:p=0.1 must fail loudly, not kill
# deterministically while the operator believes it is probabilistic)
_KIND_FIELDS = {
    "kill": ("rank", "step", "site", "code"),
    "delay": ("rank", "site", "p", "ms"),
    "straggler": ("rank", "site", "ms"),
    "slow": ("rank", "site", "ms", "n"),
    "drop": ("rank", "site", "p"),
    "bitflip": ("rank", "site", "p"),
    "partition": ("rank", "site", "n", "ranks", "ms"),
    "conn_reset": ("rank", "site", "p", "n"),
    "partial_write": ("rank", "site", "p", "n"),
    "slow_socket": ("rank", "site", "p", "ms"),
}
# the master field set is DERIVED from the per-kind tables: a field a
# kind reads but the master list forgot (or vice versa) is structurally
# impossible, instead of a drift the parser rejects at runtime
_FIELDS = tuple(sorted({f for fs in _KIND_FIELDS.values() for f in fs}))
assert set(_KIND_FIELDS) == set(VALID_KINDS)


class FaultRule:
    """One parsed fault clause plus its private deterministic RNG.

    ``left`` is the mutable visit budget of a ``slow`` rule (counts down
    from ``n``; ``None`` = unbounded) — the one piece of rule state that
    changes over a run, guarded by the injector's lock."""

    __slots__ = ("kind", "site", "rank", "step", "p", "ms", "code", "n",
                 "left", "skey", "rng", "ranks", "cut_t0", "healed")

    def __init__(self, kind: str, site: Optional[str], rank: Optional[int],
                 step: Optional[int], p: float, ms: float, code: int,
                 n: Optional[int] = None, ranks=None):
        self.kind = kind
        self.site = site
        self.rank = rank
        self.step = step
        self.p = p
        self.ms = ms
        self.code = code
        self.n = n
        self.left = n
        self.skey: Optional[str] = None  # lifetime-budget key (slow only)
        self.rng: Optional[random.Random] = None  # bound by FaultInjector
        # ranks-partition state (kind=partition with ranks=A|B): the two
        # sides as frozensets, the monotonic time of the FIRST severed
        # edge (the heal clock's zero when ms= is set), and the healed
        # latch — a healed partition never cuts again
        self.ranks = ranks
        self.cut_t0: Optional[float] = None
        self.healed = False

    def __repr__(self) -> str:  # actionable in logs and error messages
        parts = [self.kind]
        for f in ("site", "rank", "step", "p", "ms", "n"):
            v = getattr(self, f)
            if v is not None:
                parts.append(f"{f}={v}")
        if self.ranks is not None:
            parts.append("ranks=%s|%s" % (
                ".".join(map(str, sorted(self.ranks[0]))),
                ".".join(map(str, sorted(self.ranks[1])))))
        return ":".join(parts)


def _is_coordinator() -> bool:
    """The ``kill:site=coordinator`` predicate: does THIS process
    currently host the membership control plane (the coordinator of the
    active :class:`~byteps_tpu_torch.fault.membership.ElasticMembership`'s
    view)?  False when no elastic membership is running: the rule then
    never fires, matching "kill the coordinator" semantics for worlds
    that have none."""
    try:
        from .membership import active_membership
        m = active_membership()
        return m is not None and m.is_coordinator
    except Exception:  # noqa: BLE001 — the injector must never crash
        return False


def _fail(spec: str, clause: str, msg: str) -> ValueError:
    return ValueError(
        f"BYTEPS_FAULT_SPEC: bad clause {clause!r} in {spec!r}: {msg}")


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse and *validate* a fault spec; raises ValueError with the list
    of valid kinds/sites on any unknown token (eager validation is the
    init()-time contract — a typo must fail the run, not silently inject
    nothing)."""
    rules: List[FaultRule] = []
    for clause in spec.replace(";", ",").split(","):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, rest = clause.partition(":")
        kind = kind.strip()
        if kind not in VALID_KINDS:
            raise _fail(spec, clause,
                        f"unknown fault kind {kind!r}; valid kinds: "
                        f"{', '.join(VALID_KINDS)}")
        fields: Dict[str, str] = {}
        if rest:
            for item in rest.split(":"):
                key, sep, val = item.partition("=")
                key = key.strip()
                if not sep or key not in _FIELDS:
                    raise _fail(spec, clause,
                                f"unknown field {key!r}; valid fields: "
                                f"{', '.join(_FIELDS)}")
                if key not in _KIND_FIELDS[kind]:
                    raise _fail(spec, clause,
                                f"field {key!r} has no effect on "
                                f"{kind!r}; {kind} reads: "
                                f"{', '.join(_KIND_FIELDS[kind])}")
                fields[key] = val.strip()
        site = fields.get("site")
        if site is not None and site not in VALID_SITES:
            raise _fail(spec, clause,
                        f"unknown site {site!r}; valid sites: "
                        f"{', '.join(VALID_SITES)}")
        try:
            rank = int(fields["rank"]) if "rank" in fields else None
            step = int(fields["step"]) if "step" in fields else None
            p = float(fields.get("p", "1"))
            ms = float(fields.get("ms", "0"))
            code = int(fields.get("code", "1"))
            n = int(fields["n"]) if "n" in fields else None
        except ValueError:
            raise _fail(spec, clause, "rank/step/code/n must be integers, "
                                      "p/ms numbers") from None
        if not 0.0 < p <= 1.0:
            raise _fail(spec, clause, f"p={p} must be in (0, 1]")
        ranks = None
        if "ranks" in fields:
            # partition:ranks=A|B — two '.'-separated rank sets, e.g.
            # ranks=0|1.2 severs every edge between {0} and {1,2}
            sides = fields["ranks"].split("|")
            if len(sides) != 2:
                raise _fail(spec, clause,
                            "ranks must name exactly two sides as "
                            "A|B (ranks '.'-separated, e.g. 0|1.2)")
            try:
                a = frozenset(int(x) for x in sides[0].split(".") if x)
                b = frozenset(int(x) for x in sides[1].split(".") if x)
            except ValueError:
                raise _fail(spec, clause,
                            "ranks sides must be '.'-separated "
                            "integers") from None
            if not a or not b:
                raise _fail(spec, clause,
                            "both partition sides must be non-empty")
            if a & b:
                raise _fail(spec, clause,
                            f"partition sides overlap: "
                            f"{sorted(a & b)} on both")
            ranks = (a, b)
        if kind == "partition" and ms < 0:
            raise _fail(spec, clause,
                        "partition ms=N (heal-after window) must be "
                        ">= 0 (0 = never heals)")
        # per-kind requirements, checked here so a broken spec fails at
        # init() with an actionable message instead of never firing
        if kind == "kill" and step is None:
            raise _fail(spec, clause, "kill needs step=N (the push_pull "
                                      "count at which the process dies — "
                                      "the ANSWERED-PULL count for "
                                      "site=serve_host)")
        if kind == "kill" and site not in (None, "coordinator",
                                           "serve_host",
                                           "serve_host_start"):
            raise _fail(spec, clause,
                        "kill supports only site=coordinator (die only "
                        "while hosting the membership control plane), "
                        "site=serve_host (die at the Nth answered serving "
                        "pull — the ring-aware mid-storm host kill), or "
                        "site=serve_host_start (die at serve-host "
                        "startup, before HOST-UP — the launch crash the "
                        "reconciler's flap ban absorbs)")
        if kind != "kill" and site in ("coordinator", "serve_host_start"):
            raise _fail(spec, clause,
                        f"site={site} is a kill-only predicate, not a "
                        "woven code site")
        if kind in ("delay", "drop") and site is None:
            raise _fail(spec, clause,
                        f"{kind} needs site=S; valid sites: "
                        f"{', '.join(VALID_SITES)}")
        if kind == "bitflip":
            if site is None or site not in CORRUPT_SITES:
                raise _fail(spec, clause,
                            "bitflip needs site=S with S in "
                            f"{', '.join(CORRUPT_SITES)} (the sites where "
                            "value corruption is woven)")
        if kind == "straggler":
            if ms <= 0:
                raise _fail(spec, clause, "straggler needs ms=N > 0")
            site = site or "dispatch"
        if kind == "slow":
            if ms <= 0:
                raise _fail(spec, clause, "slow needs ms=N > 0 (the "
                                          "sustained per-visit delay)")
            if n is not None and n <= 0:
                raise _fail(spec, clause,
                            "slow n=N (visit budget) must be > 0")
            site = site or "dispatch"
        if kind in SOCKET_KINDS:
            # socket kinds act through the transport's socket shim
            # (comm/transport.py), not the fire()/corrupt() hooks — a
            # non-socket site would silently never fire
            site = site or "transport"
            if site not in SOCKET_SITES:
                raise _fail(spec, clause,
                            f"{kind} is a socket-level fault; site must "
                            f"be one of {', '.join(SOCKET_SITES)}")
            if kind == "slow_socket" and ms <= 0:
                raise _fail(spec, clause,
                            "slow_socket needs ms=N > 0 (the per-send "
                            "throttle)")
            if n is not None and n <= 0:
                raise _fail(spec, clause,
                            f"{kind} n=N (fault budget) must be > 0")
        rules.append(FaultRule(kind, site, rank, step, p, ms, code, n,
                               ranks=ranks))
    if not rules:
        raise ValueError(
            f"BYTEPS_FAULT_SPEC={spec!r} contains no fault clauses")
    return rules


class FaultInjector:
    """Deterministic fault schedule for one process.

    ``rank`` is the process identity faults match against (the launcher's
    DMLC_WORKER_ID / config.host_id — a per-process number that exists
    before any JAX state).  ``seed`` namespaces every rule's RNG; the
    schedule is a pure function of (spec, seed) and the visit sequence.
    """

    def __init__(self, spec: str, seed: int = 0, rank: int = 0):
        self.spec = spec
        self.seed = seed
        self.rank = rank
        self.rules = parse_spec(spec)
        for i, r in enumerate(self.rules):
            # string seeding: stable across processes (no hash salt)
            r.rng = random.Random(f"{seed}/{i}/{r.kind}/{r.site}")
            if r.n is not None and r.kind in ("slow",) + SOCKET_KINDS:
                # resume the lifetime visit budget: a re-armed schedule
                # (elastic suspend/resume) continues the SAME fault
                # window instead of restarting it
                r.skey = f"{seed}/{i}/{r.kind}/{r.site}/{r.rank}/" \
                         f"{r.ms}/{r.n}"
                r.left = max(0, r.n - _slow_consumed.get(r.skey, 0))
        self._by_site: Dict[str, List[FaultRule]] = {}
        for r in self.rules:
            if r.site is not None:
                self._by_site.setdefault(r.site, []).append(r)
        self._kills = [r for r in self.rules if r.kind == "kill"]
        # ranks-scoped partitions: consulted via edge_cut(peer) from any
        # peer-aware site (transport, heartbeat, bus, gossip), not via
        # the blanket socket_fault path
        self._edge_rules = [r for r in self.rules
                            if r.kind == "partition" and r.ranks is not None]
        self._step = 0
        self._serves = 0   # answered serving pulls (site=serve_host kills)
        self._serve_starts = 0   # serve-host startups (serve_host_start)
        # survives disarm(engine_scoped_only=True) — see module arm()
        self.persist = False
        self._lock = threading.Lock()

    # -- site hooks --------------------------------------------------------

    def on_step(self) -> None:
        """Advance the step counters (one per push_pull enqueue) and
        honor any matching kill rule — the simulated hard crash."""
        global _lifetime_step
        with self._lock:
            self._step += 1
            step = self._step
            _lifetime_step += 1
            life = _lifetime_step
        for r in self._kills:
            if r.rank is not None and r.rank != self.rank:
                continue
            if r.site == "serve_host":
                continue  # matched against the serve counter (on_serve)
            # coordinator kills count process-lifetime pushes (see the
            # module docstring: the per-incarnation counter restarts on
            # an elastic re-arm and would cascade-kill the successor)
            matched = life if r.site == "coordinator" else step
            if matched != r.step:
                continue
            if r.site == "coordinator" and not _is_coordinator():
                continue
            counters.inc("fault.kill")
            # log the counter the rule MATCHED (the lifetime one for
            # coordinator kills) so a postmortem can correlate the log
            # with the spec's step=N
            _log.error(
                "fault injector: kill at step %d (rank %d) — exiting %d",
                matched, self.rank, r.code)
            # black-box parity with a real crash: the flight recorder's
            # tail hits disk BEFORE the hard exit (os._exit runs no
            # atexit hooks)
            from ..common import flight_recorder as _flight
            _flight.record("fault.kill", step=matched, rank=self.rank,
                           code=r.code)
            _flight.dump("chaos_kill")
            _exit(r.code)

    def on_serve(self) -> None:
        """Advance the serving-pull counter and honor ``site=serve_host``
        kill rules — the ring-aware chaos hook: a serving host dies
        deterministically at its Nth ANSWERED pull, i.e. mid-storm,
        without the test choreographing a wall-clock race."""
        with self._lock:
            self._serves += 1
            n = self._serves
        for r in self._kills:
            if r.site != "serve_host":
                continue
            if r.rank is not None and r.rank != self.rank:
                continue
            if n != r.step:
                continue
            counters.inc("fault.kill")
            _log.error(
                "fault injector: serve_host kill at pull %d (host %d) — "
                "exiting %d", n, self.rank, r.code)
            from ..common import flight_recorder as _flight
            _flight.record("fault.kill", step=n, rank=self.rank,
                           code=r.code, site="serve_host")
            _flight.dump("chaos_kill")
            _exit(r.code)

    def on_serve_start(self) -> None:
        """Advance the serve-host startup counter and honor
        ``site=serve_host_start`` kill rules — die BEFORE HOST-UP, the
        deterministic launch crash (``step=1`` = die at the first start
        of this process) the reconciler's crash-loop backoff and flap
        ban are tested against."""
        with self._lock:
            self._serve_starts += 1
            n = self._serve_starts
        for r in self._kills:
            if r.site != "serve_host_start":
                continue
            if r.rank is not None and r.rank != self.rank:
                continue
            if n != r.step:
                continue
            counters.inc("fault.kill")
            _log.error(
                "fault injector: serve_host_start kill at start %d "
                "(host %d) — exiting %d", n, self.rank, r.code)
            from ..common import flight_recorder as _flight
            _flight.record("fault.kill", step=n, rank=self.rank,
                           code=r.code, site="serve_host_start")
            _flight.dump("chaos_kill")
            _exit(r.code)

    def fire(self, site: str) -> None:
        """Visit a site: apply delay/straggler/slow sleeps scheduled
        there."""
        for r in self._by_site.get(site, ()):
            if r.kind == "delay":
                if r.rank is not None and r.rank != self.rank:
                    continue
                if r.p >= 1.0 or r.rng.random() < r.p:
                    counters.inc("fault.delay")
                    time.sleep(r.ms / 1000.0)
            elif r.kind == "straggler":
                if r.rank is None or r.rank == self.rank:
                    counters.inc("fault.straggler")
                    time.sleep(r.ms / 1000.0)
            elif r.kind == "slow":
                if r.rank is not None and r.rank != self.rank:
                    continue
                # sustained per-rank throttle with a bounded visit
                # budget: decremented under the lock (sites fire from
                # several threads), and its exhaustion — the gray fault
                # CLEARING — is announced once so the straggler lane
                # can pin "readmitted after the fault window ends"
                with self._lock:
                    if r.left is not None:
                        if r.left <= 0:
                            continue
                        r.left -= 1
                        if r.skey is not None:
                            _slow_consumed[r.skey] = \
                                _slow_consumed.get(r.skey, 0) + 1
                        cleared = r.left == 0
                    else:
                        cleared = False
                counters.inc("fault.slow")
                if cleared:
                    counters.inc("fault.slow_cleared")
                    from ..common import flight_recorder as _flight
                    _flight.record("fault.slow_cleared", site=site,
                                   rank=self.rank, n=r.n)
                    _log.warning(
                        "fault injector: slow fault at %s cleared after "
                        "%d visits (rank %d)", site, r.n, self.rank)
                time.sleep(r.ms / 1000.0)

    def _consume_budget(self, r: FaultRule) -> bool:
        """Spend one unit of a rule's ``n=`` budget (lifetime-accounted,
        like ``slow`` — an elastic re-arm resumes the window instead of
        resurrecting an exhausted fault).  True = the fault fires."""
        with self._lock:
            if r.left is None:
                return True
            if r.left <= 0:
                return False
            r.left -= 1
            if r.skey is not None:
                _slow_consumed[r.skey] = _slow_consumed.get(r.skey, 0) + 1
            return True

    def socket_fault(self, site: str, op: str) -> Optional[str]:
        """Socket-level chaos decision for ONE socket operation at
        ``site`` (``op``: ``connect`` | ``send`` | ``recv``) — the hook
        the transport's chaos shim (comm/transport.py) consults before
        touching a real socket, so partitions/resets are injectable
        without a cooperating peer.

        Returns the failure the shim must simulate — ``"partition"``
        (blackhole the operation), ``"conn_reset"`` (tear the
        connection down with a real RST), ``"partial_write"`` (send a
        truncated frame, then RST) — or ``None``.  ``slow_socket``
        sleeps inline on sends and returns None (the operation
        proceeds, late)."""
        for r in self._by_site.get(site, ()):
            if r.kind not in SOCKET_KINDS:
                continue
            if r.rank is not None and r.rank != self.rank:
                continue
            if r.kind == "slow_socket":
                if op == "send" and (r.p >= 1.0 or r.rng.random() < r.p):
                    counters.inc("fault.slow_socket")
                    time.sleep(r.ms / 1000.0)
                continue
            if r.kind == "partition":
                if r.ranks is not None:
                    continue  # edge-scoped: consulted via edge_cut(peer)
                # unconditional while the budget lasts: a partition is
                # a state, not a per-op coin flip
                if self._consume_budget(r):
                    counters.inc("fault.partition")
                    return "partition"
                continue
            if op == "connect":
                continue  # resets model an ESTABLISHED connection dying
            if r.kind == "partial_write" and op != "send":
                continue
            if r.p < 1.0 and r.rng.random() >= r.p:
                continue
            if not self._consume_budget(r):
                continue
            if r.kind == "conn_reset":
                counters.inc("fault.conn_reset")
                return "conn_reset"
            counters.inc("fault.partial_write")
            return "partial_write"
        return None

    def edge_cut(self, peer: int) -> bool:
        """True when a ``partition:ranks=A|B`` rule severs the edge
        between THIS process and ``peer`` right now — the symmetric
        blackhole every peer-aware site (transport sends/recvs/dials,
        heartbeat datagrams, bus requests, gossip exchanges) consults.

        The heal clock starts at the FIRST severed edge (``cut_t0``):
        with ``ms=N`` the partition heals N milliseconds later and never
        cuts again (``fault.partition`` / ``fault.partition_healed``
        flight events bracket the incident for bps_doctor).  An ``n=``
        budget bounds the number of blackholed operations instead."""
        if peer is None or peer < 0 or not self._edge_rules:
            return False
        now = time.monotonic()
        for r in self._edge_rules:
            if r.healed:
                continue
            a, b = r.ranks
            if not ((self.rank in a and peer in b)
                    or (self.rank in b and peer in a)):
                continue
            with self._lock:
                if r.healed:
                    continue
                if r.cut_t0 is None:
                    r.cut_t0 = now
                    counters.inc("fault.partition")
                    from ..common import flight_recorder as _flight
                    _flight.record("fault.partition", rank=self.rank,
                                   side_a=sorted(a), side_b=sorted(b),
                                   heal_ms=r.ms or None)
                    _log.warning(
                        "fault injector: partition %s|%s active "
                        "(rank %d)", sorted(a), sorted(b), self.rank)
                if r.ms > 0 and (now - r.cut_t0) * 1000.0 >= r.ms:
                    r.healed = True
                    counters.inc("fault.partition_healed")
                    from ..common import flight_recorder as _flight
                    _flight.record(
                        "fault.partition_healed", rank=self.rank,
                        side_a=sorted(a), side_b=sorted(b),
                        after_ms=round((now - r.cut_t0) * 1000.0, 1))
                    _log.warning(
                        "fault injector: partition %s|%s healed "
                        "(rank %d)", sorted(a), sorted(b), self.rank)
                    continue
                if r.left is not None:
                    if r.left <= 0:
                        continue
                    r.left -= 1
                    if r.skey is not None:
                        _slow_consumed[r.skey] = \
                            _slow_consumed.get(r.skey, 0) + 1
            counters.inc("fault.edge_cut")
            return True
        return False

    def should_drop(self, site: str) -> bool:
        """True when a drop rule says to suppress this message."""
        for r in self._by_site.get(site, ()):
            if r.kind == "drop" and (r.rank is None or r.rank == self.rank):
                if r.p >= 1.0 or r.rng.random() < r.p:
                    counters.inc("fault.drop")
                    return True
        return False

    def corrupt(self, site: str, arr):
        """Return ``arr`` with one random bit flipped when a bitflip rule
        fires here; otherwise the input, untouched (no copy)."""
        import numpy as np
        for r in self._by_site.get(site, ()):
            if r.kind != "bitflip":
                continue
            if r.rank is not None and r.rank != self.rank:
                continue
            if r.p < 1.0 and r.rng.random() >= r.p:
                continue
            counters.inc("fault.bitflip")
            a = np.array(arr, copy=True)
            raw = a.view(np.uint8).reshape(-1)
            byte = r.rng.randrange(raw.size)
            raw[byte] ^= np.uint8(1 << r.rng.randrange(8))
            from ..common import flight_recorder as _flight
            _flight.record("fault.bitflip", site=site, byte=byte)
            _log.warning(
                "fault injector: bit flipped at %s (byte %d)", site, byte)
            return a
        return arr

    @property
    def step_count(self) -> int:
        with self._lock:
            return self._step


# -- module-level arm/disarm (the init()/shutdown() contract) ---------------


def arm(spec: str, seed: int = 0, rank: int = 0, *,
        persist: bool = False) -> FaultInjector:
    """Validate ``spec`` and install the process-wide injector.  Raises
    ValueError (with the valid kind/site lists) on a malformed spec —
    called eagerly by ``bps.init()`` so chaos-run typos fail fast.

    ``persist=True`` pins the injector across the engine lifecycle:
    ``disarm(engine_scoped_only=True)`` — what ``api.suspend()`` /
    ``api.shutdown()`` issue — leaves it armed.  A ``partition:ranks``
    blackhole must survive the very suspend/resume transition it
    provokes: the network does not heal because the engine restarted,
    only the ``ms=`` clock heals it."""
    global ENABLED, _active
    _active = FaultInjector(spec, seed=seed, rank=rank)
    _active.persist = persist
    ENABLED = True
    _log.warning("fault injection ARMED (rank %d, seed %d): %s",
                 rank, seed, "; ".join(map(repr, _active.rules)))
    return _active


def disarm(engine_scoped_only: bool = False) -> None:
    """Drop the process-wide injector.  ``engine_scoped_only=True`` is
    the engine-lifecycle form (init/shutdown): it spares an injector
    armed with ``persist=True``."""
    global ENABLED, _active
    if engine_scoped_only and _active is not None \
            and getattr(_active, "persist", False):
        return
    ENABLED = False
    _active = None


def active() -> Optional[FaultInjector]:
    return _active


# Hot-path delegates: sites call these only behind `if injector.ENABLED:`
# so the disarmed cost is the guard alone.

def on_step() -> None:
    if _active is not None:
        _active.on_step()


def on_serve() -> None:
    """Serving-host twin of :func:`on_step` (``kill:site=serve_host``)."""
    if _active is not None:
        _active.on_serve()


def on_serve_start() -> None:
    """Serve-host startup twin (``kill:site=serve_host_start`` — die
    before HOST-UP)."""
    if _active is not None:
        _active.on_serve_start()


def fire(site: str) -> None:
    if _active is not None:
        _active.fire(site)


def should_drop(site: str) -> bool:
    return _active is not None and _active.should_drop(site)


def socket_fault(site: str, op: str) -> Optional[str]:
    """Socket-shim delegate (see :meth:`FaultInjector.socket_fault`);
    None when chaos is disarmed."""
    return None if _active is None else _active.socket_fault(site, op)


def edge_cut(peer: int) -> bool:
    """Ranks-partition delegate (see :meth:`FaultInjector.edge_cut`);
    False when chaos is disarmed."""
    return _active is not None and _active.edge_cut(peer)


def corrupt(site: str, arr):
    return arr if _active is None else _active.corrupt(site, arr)


def corrupt_bytes(site: str, data: bytes) -> bytes:
    """Byte-payload twin of :func:`corrupt` for wire frames (integrity
    envelopes, compressed codec payloads): one random bit of the frame
    is flipped when a bitflip rule fires at ``site``."""
    if _active is None or not data:
        return data
    import numpy as np
    view = np.frombuffer(data, dtype=np.uint8)
    out = _active.corrupt(site, view)
    return data if out is view else out.tobytes()
