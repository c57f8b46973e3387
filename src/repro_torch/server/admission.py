"""SLO- and energy-aware admission control for the serving front door.

Twin of ``repro/server/admission.py``: the same inputs give the same
decision records.  Pure host-side policy logic -- no asyncio, no torch --
so every decision the front door makes is deterministic and unit-testable
in isolation:

* **per-tenant priorities** — strict priority classes (lower value serves
  first); within a class, tenants share capacity by weighted
  deficit-round-robin on *decoded tokens* (token-budget fairness: a tenant
  that has consumed more tokens per unit weight waits behind one that has
  consumed fewer).
* **energy SLOs** — each tenant may carry a joule budget
  (:attr:`TenantPolicy.energy_budget_j`) implemented as a token bucket:
  measured per-request energy (:attr:`repro_torch.serving.BatchScheduler.
  request_energy_j`: metered spike events x Table-II op energies)
  is charged against the bucket as it accrues, and the bucket refills at
  :attr:`TenantPolicy.refill_j_per_s`.  A tenant with an empty bucket is
  **throttled** (its requests stay queued) and — when
  :attr:`TenantPolicy.preempt` is set — its *running* requests are
  **preempted** (evicted and re-admitted once the bucket refills; token
  purity makes the restarted decode bit-identical, so the client stream
  just resumes).
* **decision records** — every admit / defer / preempt / re-admit is
  appended to :attr:`AdmissionController.records` with its reason, so SLO
  behaviour is observable (``GET /stats``) and assertable in tests.

The controller never touches the scheduler; the front door asks it *what*
to do and then drives :class:`repro_torch.serving.BatchScheduler`.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

# decision tags recorded per request event
ADMIT = "admit"
READMIT = "readmit"
DEFER_ENERGY = "defer:energy"
DEFER_SLOTS = "defer:slots"
DEFER_PAGES = "defer:pages"
DEFER_QUEUE = "defer:queue"
PREEMPT_ENERGY = "preempt:energy"


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Serving policy for one tenant.

    ``priority`` is a strict class (0 beats 1); ``weight`` divides decoded
    tokens for the fair-share comparison inside a class.  ``energy_budget_j``
    (None = unmetered) is the token-bucket capacity in joules;
    ``refill_j_per_s`` its refill rate.  With ``preempt`` set, a tenant
    that overruns its bucket mid-flight has its running requests evicted
    and re-admitted when the bucket refills (bit-exact resume); otherwise
    the overrun only blocks *new* admissions (soft SLO).
    """

    priority: int = 0
    weight: float = 1.0
    energy_budget_j: Optional[float] = None
    refill_j_per_s: float = 0.0
    preempt: bool = True


@dataclasses.dataclass
class TenantState:
    policy: TenantPolicy
    credit_j: float  # energy token bucket (inf when unmetered)
    spent_j: float = 0.0  # lifetime metered joules
    spent_tokens: int = 0  # lifetime decoded tokens (fairness counter)
    inflight: int = 0  # requests currently holding a slot

    @property
    def fair_share_key(self) -> float:
        return self.spent_tokens / max(self.policy.weight, 1e-9)

    @property
    def energy_ok(self) -> bool:
        return self.policy.energy_budget_j is None or self.credit_j > 0.0


@dataclasses.dataclass(frozen=True)
class AdmissionRecord:
    """One admission-control event: what happened to a request and why."""

    request_id: int
    tenant: str
    decision: str  # ADMIT / READMIT / DEFER_* / PREEMPT_ENERGY
    detail: str = ""


class AdmissionController:
    """Deterministic per-tenant admission, fairness and energy accounting."""

    def __init__(self, policies: Optional[Dict[str, TenantPolicy]] = None,
                 default: Optional[TenantPolicy] = None,
                 max_records: int = 4096, metrics=None):
        self._policies = dict(policies or {})
        self._default = default or TenantPolicy()
        self.tenants: Dict[str, TenantState] = {}
        # decision log: a bounded ring — a long-lived server keeps the
        # *recent* window for /stats and postmortems, while the monotone
        # per-decision counters below carry the lifetime totals
        self.records: Deque[AdmissionRecord] = deque(maxlen=max_records)
        # labeled admit/defer:*/preempt counters (repro_torch.obs registry);
        # None = uninstrumented, the controller stays dependency-free
        self._c_decisions = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        """Attach a :class:`repro_torch.obs.MetricsRegistry`: every decision
        increments ``xpike_admission_decisions_total{decision,tenant}``."""
        self._c_decisions = metrics.counter(
            "admission_decisions_total",
            "admission-control events by decision tag",
            ("decision", "tenant"))

    # -- tenant bookkeeping --------------------------------------------

    def tenant(self, name: str) -> TenantState:
        st = self.tenants.get(name)
        if st is None:
            pol = self._policies.get(name, self._default)
            credit = (float("inf") if pol.energy_budget_j is None
                      else pol.energy_budget_j)
            st = self.tenants[name] = TenantState(pol, credit)
        return st

    def set_policy(self, name: str, policy: TenantPolicy) -> None:
        """Install/replace a tenant's policy (bucket re-capped, not refilled
        beyond the new budget)."""
        self._policies[name] = policy
        st = self.tenants.get(name)
        if st is not None:
            st.policy = policy
            cap = (float("inf") if policy.energy_budget_j is None
                   else policy.energy_budget_j)
            st.credit_j = min(st.credit_j, cap)

    def grant(self, name: str, joules: float) -> None:
        """Credit a tenant's energy bucket (capped at its budget) — the
        manual-refill hook for operators and deterministic tests."""
        st = self.tenant(name)
        if st.policy.energy_budget_j is not None:
            st.credit_j = min(st.credit_j + joules, st.policy.energy_budget_j)

    def refill(self, dt_s: float) -> None:
        """Advance every tenant's token bucket by ``dt_s`` wall seconds."""
        if dt_s <= 0:
            return
        for st in list(self.tenants.values()):
            if st.policy.energy_budget_j is not None:
                st.credit_j = min(st.credit_j + st.policy.refill_j_per_s * dt_s,
                                  st.policy.energy_budget_j)

    def charge(self, name: str, joules: float, tokens: int = 0) -> None:
        """Book metered energy (and decoded tokens, for fairness) against a
        tenant — called by the front door with the scheduler's per-request
        energy deltas."""
        st = self.tenant(name)
        st.spent_j += joules
        st.spent_tokens += tokens
        if st.policy.energy_budget_j is not None:
            st.credit_j -= joules

    # -- decisions ------------------------------------------------------

    def pick(self, queued_tenants) -> Optional[str]:
        """The tenant whose head-of-queue request should be admitted next:
        strict priority first, then weighted token-fairness (least decoded
        tokens per unit weight), tenant name as the deterministic
        tie-break.  Tenants with an exhausted energy bucket are skipped
        (they stay queued — throttling, not rejection)."""
        best = None
        for name in queued_tenants:
            st = self.tenant(name)
            if not st.energy_ok:
                continue
            key = (st.policy.priority, st.fair_share_key, name)
            if best is None or key < best[0]:
                best = (key, name)
        return None if best is None else best[1]

    def should_preempt(self, name: str) -> bool:
        st = self.tenant(name)
        return (st.policy.energy_budget_j is not None and st.policy.preempt
                and st.credit_j <= 0.0)

    def record(self, request_id: int, tenant: str, decision: str,
               detail: str = "") -> None:
        self.records.append(AdmissionRecord(request_id, tenant, decision, detail))
        if self._c_decisions is not None:
            self._c_decisions.inc(1.0, decision, tenant)

    def decisions(self, request_id: Optional[int] = None) -> List[AdmissionRecord]:
        if request_id is None:
            return list(self.records)
        return [r for r in self.records if r.request_id == request_id]
