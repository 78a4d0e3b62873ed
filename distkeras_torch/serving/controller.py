"""Elastic fleet controller: the brain over the serving fabric.

Every actuator this loop drives already exists — drain/undrain and the
role-specialized pools (disaggregated serving), rolling weight pushes,
SLO burn-rate rules, per-replica stats probing, dynamic fleet
membership (:meth:`Router.add_replica` / :meth:`~Router.remove_replica`)
— but until now nothing wired them together: an operator watched the
dashboards and typed the drains. This module closes the loop, the same
move the reference system makes for training (workers join, die, and
lag while the coordinator keeps the job converging): the fleet becomes
elastic under the :class:`Autoscaler`, which watches fleet-aggregated
SLO burn, queue depth, and ``blocks_reclaimable``, and converges the
fleet by exactly three moves —

- **scale up**: spawn a replica (caller-supplied ``spawn`` actuator —
  the harness owns process/engine creation, so this module stays
  stdlib-only like the rest of the fabric layer) and join it to the
  router's probing, ring, and pools;
- **scale down**: drain the least-loaded mixed replica, wait for
  ``drained``, remove it from routing, and hand it to ``retire``;
- **rebalance**: flip a drained mixed replica's role via the
  declarative drain → ``reconfigure`` → undrain primitive — toward
  ``prefill`` when the TTFT objective burns (admission latency is
  prefill capacity), toward ``decode`` when ITL burns (stream latency
  is decode capacity).

Control-law structure — :class:`DecisionEngine` is deliberately a PURE
function of ``(state, signals, now)`` with no I/O, no clock reads, and
no randomness, so determinism is checkable: the :class:`Autoscaler`
records every ``(now, signals)`` poll it feeds the law, and
:meth:`Autoscaler.replay` re-runs the recorded timeline through a
fresh engine and must reproduce the live decision sequence exactly
(the fleet-sim harness asserts this).

Why the loop provably never flaps:

1. **Hysteresis band.** Scale-up pressure (``queue/replica >=
   queue_high``, an SLO burn, or an exhausted block pool) and
   scale-down idleness (``queue/replica <= queue_low`` and no burn)
   are disjoint predicates separated by the open band
   ``(queue_low, queue_high)``; a load level inside the band drives
   neither and resets both streaks.
2. **Consecutive-poll streaks.** An action requires its predicate to
   hold for ``up_consecutive`` (or ``down_consecutive``) *consecutive*
   polls; one poll of the opposite or neutral condition zeroes the
   streak.
3. **Cooldown.** Every action zeroes all streaks and arms
   ``cooldown_s`` during which :meth:`DecisionEngine.decide` returns
   ``None`` unconditionally.

Consequently two opposite actions are separated by at least
``cooldown_s + min(up_consecutive, down_consecutive) * poll interval``
AND by the load signal crossing the entire hysteresis band — a
constant offered load, however unlucky, cannot produce oscillation.
Role flips ride the same cooldown and additionally require spare mixed
capacity (``>= 2`` mixed replicas, fleet ``>= 3``), so the fleet can
never specialize itself out of serving ordinary traffic.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from distkeras_torch import telemetry
from distkeras_torch.serving.fleet import DRAINING, HEALTHY, Replica

ROLE_MIXED = "mixed"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


class DecisionEngine:
    """The pure control law: one poll's signals in, at most one action
    out. Holds only the hysteresis state (streak counters + cooldown
    deadline); never touches a socket, a clock, or a random source —
    ``now`` is injected — so a recorded signal timeline replayed
    through a fresh instance reproduces the decision sequence bit for
    bit.

    ``signals`` is a plain dict (see :meth:`Autoscaler.sample`):
    ``replicas`` (routable count), ``queue_depth`` (fleet sum),
    ``ttft_burn``/``itl_burn`` (any replica's SLO rule firing),
    ``blocks_reclaimable`` (fleet sum, or None for slot engines), and
    ``roles`` (routable count per advertised role).

    Returned actions are plain dicts: ``{"action": "scale_up"|
    "scale_down"|"rebalance", "reason": str}`` plus ``"role"`` for
    rebalances. ``None`` means hold.
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 queue_high: float = 4.0, queue_low: float = 0.5,
                 up_consecutive: int = 2, down_consecutive: int = 6,
                 cooldown_s: float = 10.0,
                 min_reclaimable_blocks: int = 0,
                 rebalance: bool = True):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1; got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        if queue_low >= queue_high:
            raise ValueError(
                f"hysteresis band is empty: queue_low ({queue_low}) "
                f">= queue_high ({queue_high}) — the no-flap argument "
                f"needs an open band between them")
        if up_consecutive < 1 or down_consecutive < 1:
            raise ValueError("streak thresholds must be >= 1")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0; got {cooldown_s}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.up_consecutive = int(up_consecutive)
        self.down_consecutive = int(down_consecutive)
        self.cooldown_s = float(cooldown_s)
        self.min_reclaimable_blocks = int(min_reclaimable_blocks)
        self.rebalance = bool(rebalance)
        # hysteresis state
        self.up_streak = 0
        self.down_streak = 0
        self.ttft_streak = 0
        self.itl_streak = 0
        self.cooldown_until = 0.0

    def config(self) -> Dict:
        """Constructor kwargs for cloning a fresh engine (replay)."""
        return dict(
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            queue_high=self.queue_high, queue_low=self.queue_low,
            up_consecutive=self.up_consecutive,
            down_consecutive=self.down_consecutive,
            cooldown_s=self.cooldown_s,
            min_reclaimable_blocks=self.min_reclaimable_blocks,
            rebalance=self.rebalance,
        )

    def decide(self, signals: Dict, now: float) -> Optional[Dict]:
        """One control-law evaluation. Streaks advance every call —
        including during cooldown, so a pressure condition that
        persists through a cooldown acts the instant it expires —
        but at most one action is returned, and none before
        ``cooldown_until``."""
        n = int(signals.get("replicas", 0))
        per = signals.get("queue_depth", 0) / max(n, 1)
        ttft_burn = bool(signals.get("ttft_burn"))
        itl_burn = bool(signals.get("itl_burn"))
        burn = ttft_burn or itl_burn
        recl = signals.get("blocks_reclaimable")
        low_blocks = (recl is not None
                      and recl <= self.min_reclaimable_blocks)
        pressure = per >= self.queue_high or burn or low_blocks
        idle = (per <= self.queue_low) and not burn and not low_blocks
        if pressure:
            self.up_streak += 1
            self.down_streak = 0
        elif idle:
            self.down_streak += 1
            self.up_streak = 0
        else:
            # inside the hysteresis band: neither direction accrues
            self.up_streak = 0
            self.down_streak = 0
        self.ttft_streak = self.ttft_streak + 1 if ttft_burn else 0
        self.itl_streak = self.itl_streak + 1 if itl_burn else 0
        if now < self.cooldown_until:
            return None
        # capacity first: a burning fleet below max_replicas grows
        # before it specializes (more of everything beats a different
        # mix of the same total)
        if self.up_streak >= self.up_consecutive:
            if n < self.max_replicas:
                self._acted(now)
                return {
                    "action": "scale_up",
                    "reason": ("slo_burn" if burn else
                               "blocks" if low_blocks else "queue"),
                }
            if self.rebalance and n >= 3:
                roles = signals.get("roles", {})
                mixed = int(roles.get(ROLE_MIXED, 0))
                if (ttft_burn and mixed >= 2
                        and int(roles.get(ROLE_PREFILL, 0)) < 1):
                    self._acted(now)
                    return {"action": "rebalance", "role": ROLE_PREFILL,
                            "reason": "ttft_burn"}
                if (itl_burn and mixed >= 2
                        and int(roles.get(ROLE_DECODE, 0)) < 1):
                    self._acted(now)
                    return {"action": "rebalance", "role": ROLE_DECODE,
                            "reason": "itl_burn"}
            return None
        if (self.down_streak >= self.down_consecutive
                and n > self.min_replicas):
            self._acted(now)
            return {"action": "scale_down", "reason": "idle"}
        return None

    def _acted(self, now: float):
        self.cooldown_until = now + self.cooldown_s
        self.up_streak = self.down_streak = 0
        self.ttft_streak = self.itl_streak = 0


class Autoscaler:
    """The control loop around :class:`DecisionEngine`: samples the
    fleet through a :class:`~distkeras_torch.serving.Router`, feeds the
    law, and actuates its decisions.

    Args:
      router: the started Router whose fleet this loop owns.
      spawn: scale-up actuator — returns a STARTED replica's
        ``(host, port, name)`` (or a built
        :class:`~distkeras_torch.serving.fleet.Replica`). The harness
        owns engine/process creation (device pinning, warmup,
        ``mark_steady``); the controller only joins the result to the
        router. ``None`` disables scale-up actuation (decisions are
        still logged).
      retire: scale-down actuator — called with the replica name
        AFTER it was drained and removed from routing; stops the
        underlying server/process. ``None`` = nothing to stop.
      interval_s: poll cadence of :meth:`start`'s loop.
      drain_timeout_s: bound on waiting for ``drained`` during
        scale-down / rebalance actuation.
      **law: forwarded to :class:`DecisionEngine`.

    Observability: every poll's ``(now, signals)`` lands in
    ``signal_log`` and every actuated decision in ``events``;
    ``controller_replicas`` / ``controller_actions_total{action}`` /
    ``controller_polls_total`` / ``controller_errors_total`` cover the
    loop itself, and each action records a zero-duration
    ``controller.<action>`` marker span for the fleet timeline.
    """

    def __init__(self, router, spawn: Optional[Callable] = None,
                 retire: Optional[Callable[[str], None]] = None,
                 interval_s: float = 0.5,
                 drain_timeout_s: float = 30.0,
                 registry: Optional[telemetry.MetricRegistry] = None,
                 tracer: Optional[telemetry.Tracer] = None,
                 **law):
        self.router = router
        self.spawn = spawn
        self.retire = retire
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.law = DecisionEngine(**law)
        self.registry = registry or telemetry.get_registry()
        self.tracer = tracer or telemetry.get_tracer()
        self.events: List[Dict] = []
        self.signal_log: List[Tuple[float, Dict]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_replicas = self.registry.gauge(
            "controller_replicas",
            "fleet size as the controller last observed it")
        self._m_polls = self.registry.counter(
            "controller_polls_total",
            "control-loop evaluations (sample + decide)")
        self._m_actions = self.registry.counter(
            "controller_actions_total",
            "actuated control decisions, by action",
            labelnames=("action",))
        self._m_errors = self.registry.counter(
            "controller_errors_total",
            "control-loop iterations that raised (sampling or "
            "actuation); the loop itself never dies")

    # -- sampling -----------------------------------------------------------

    def sample(self) -> Dict:
        """One fleet observation, as plain data: the routable
        replicas' cached stats (the probe loop keeps them fresh — no
        extra stats round trips here) plus one alerts fan-out for the
        SLO burn flags."""
        manager = self.router.manager
        routable = manager.routable()
        qd = sum(int(r.last_stats.get("queue_depth", 0))
                 for r in routable)
        active = sum(int(r.last_stats.get("active_slots", 0))
                     for r in routable)
        recl = [r.last_stats.get("blocks_reclaimable")
                for r in routable]
        recl = [v for v in recl if v is not None]
        roles: Dict[str, int] = {ROLE_MIXED: 0, ROLE_PREFILL: 0,
                                 ROLE_DECODE: 0}
        for r in routable:
            roles[r.role] = roles.get(r.role, 0) + 1
        ttft = itl = False
        for a in manager.aggregate_alerts():
            if not a.get("firing"):
                continue
            rule = str(a.get("rule", ""))
            if "ttft" in rule:
                ttft = True
            elif "itl" in rule:
                itl = True
        return {
            "replicas": len(routable),
            "replicas_total": len(manager.replicas),
            "queue_depth": qd,
            "active_slots": active,
            "blocks_reclaimable": sum(recl) if recl else None,
            "roles": roles,
            "ttft_burn": ttft,
            "itl_burn": itl,
        }

    # -- the loop -----------------------------------------------------------

    def step(self, now: Optional[float] = None) -> Optional[Dict]:
        """One control iteration: sample → decide → actuate. ``now``
        injection exists for deterministic tests; the background loop
        passes the real clock."""
        now = time.monotonic() if now is None else now
        signals = self.sample()
        self.signal_log.append((now, dict(signals)))
        self._m_polls.inc()
        self._m_replicas.set(signals["replicas_total"])
        action = self.law.decide(signals, now)
        if action is None:
            return None
        action = dict(action, t=now, poll=len(self.signal_log) - 1)
        try:
            self._actuate(action)
            action["ok"] = True
        except Exception as e:  # the loop survives a failed actuation
            action["ok"] = False
            action["error"] = f"{type(e).__name__}: {e}"
            self._m_errors.inc()
        self.events.append(action)
        self._m_actions.labels(action=action["action"]).inc()
        self.tracer.record(
            None, f"controller.{action['action']}", now, 0.0,
            reason=action.get("reason"),
            replica=action.get("replica"),
        )
        # every actuated decision (including failed ones — the ok
        # flag distinguishes) lands in the router's control-plane
        # journal, so `report --timeline` reconciles the journal's
        # scale events 1:1 against decisions()
        journal = getattr(self.router, "journal", None)
        if journal is not None:
            journal.append(action["action"],
                           target=action.get("replica"),
                           actor="autoscaler",
                           reason=action.get("reason"),
                           ok=action["ok"], poll=action["poll"])
        return action

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:
                    # a sampling blip (replica died mid-poll) must not
                    # kill the control loop; the next tick resamples
                    self._m_errors.inc()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- determinism --------------------------------------------------------

    def decisions(self) -> List[Dict]:
        """The live decision sequence in replay-comparable form
        (actuation outcome stripped — replay re-decides, it does not
        re-drain fleets)."""
        keep = ("action", "role", "reason", "poll")
        return [{k: e[k] for k in keep if k in e} for e in self.events]

    def replay(self, signal_log: Optional[Sequence] = None,
               ) -> List[Dict]:
        """Re-run a recorded ``(now, signals)`` timeline through a
        FRESH :class:`DecisionEngine` with this controller's config.
        Because the law is pure, the result must equal
        :meth:`decisions` for the live log — the determinism check the
        fleet-sim asserts (same seed → same traffic → same signals →
        same scaling decisions)."""
        law = DecisionEngine(**self.law.config())
        out: List[Dict] = []
        for i, (now, signals) in enumerate(
                self.signal_log if signal_log is None else signal_log):
            a = law.decide(signals, now)
            if a is not None:
                out.append(dict(a, poll=i))
        return out

    # -- actuation ----------------------------------------------------------

    def _actuate(self, action: Dict):
        kind = action["action"]
        if kind == "scale_up":
            if self.spawn is None:
                raise RuntimeError("scale_up decided but no spawn "
                                   "actuator was configured")
            spec = self.spawn()
            replica = self.router.add_replica(spec)
            action["replica"] = replica.name
        elif kind == "scale_down":
            victim = self._victim(prefer_roles=(ROLE_MIXED,))
            action["replica"] = victim.name
            self._drain_and_wait(victim)
            self.router.remove_replica(victim.name)
            if self.retire is not None:
                self.retire(victim.name)
        elif kind == "rebalance":
            role = action["role"]
            victim = self._victim(prefer_roles=(ROLE_MIXED,),
                                  require_mixed_spare=True)
            action["replica"] = victim.name
            self._drain_and_wait(victim)
            client = victim.client
            if client is None:
                raise RuntimeError(
                    f"{victim.name} lost its connection mid-flip")
            client.reconfigure(role)
            if victim.last_stats:
                victim.last_stats["role"] = role
            client.undrain()
            victim.state = HEALTHY
        else:
            raise ValueError(f"unknown action {kind!r}")

    def _victim(self, prefer_roles: Sequence[str],
                require_mixed_spare: bool = False) -> Replica:
        """Deterministic victim choice: the least-loaded routable
        replica of a preferred role (queue + active slots, name as the
        tiebreak — two controllers watching the same fleet pick the
        same victim)."""
        manager = self.router.manager
        pool = [r for r in manager.routable()
                if r.role in prefer_roles]
        if require_mixed_spare:
            mixed = [r for r in manager.routable()
                     if r.role == ROLE_MIXED]
            if len(mixed) < 2:
                raise RuntimeError(
                    "refusing role flip: fewer than 2 mixed replicas "
                    "would leave no general-purpose capacity")
        if not pool:
            pool = manager.routable()
        if not pool:
            raise RuntimeError("no routable replica to act on")
        return min(pool, key=lambda r: (
            int(r.last_stats.get("queue_depth", 0))
            + int(r.last_stats.get("active_slots", 0)),
            r.name,
        ))

    def _drain_and_wait(self, replica: Replica):
        """The declarative drain half of every destructive actuation:
        close admissions, take the replica out of routing (and forget
        its affinity placements via the manager's drain hook), then
        poll for ``drained`` — zero lost streams by construction,
        because removal/reconfigure only proceeds once every accepted
        stream has finished."""
        client = replica.client
        if client is None:
            raise RuntimeError(f"{replica.name} is not connected")
        client.drain()
        replica.state = DRAINING
        self.router.manager.note_drain(replica)
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline:
            st = client._call({"op": "stats"}, timeout=5.0)["stats"]
            if st.get("drained"):
                return
            time.sleep(0.02)
        raise TimeoutError(
            f"{replica.name} did not drain within "
            f"{self.drain_timeout_s}s")
