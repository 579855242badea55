"""Scheduling policies: the decision seams extracted from the engine.

Three decision points, one interface (ROADMAP item 4; PAPERS.md "Optimal
Scheduling Algorithms for LLM Inference: Theory and Practice" for the
SRPT result, UELLM for prediction-driven scheduling):

  (a) admission order — the candidate window the fair-share core
      releases per tick (`MQCore.next_window`) plus each runtime's
      pending-prefill queue: which waiting request claims the next
      decode slot (`order_admission` / `reorder_pending`);
  (b) prefill-span packing — the order `step_ragged` spends its token
      budget across in-flight chunked prefills (`pack_order`);
  (c) preemption victim — which slot is evicted for recompute when the
      KV pool runs dry (`victim_key`).

Policies only REORDER within what fairness already allowed: the native
core's per-user fair-share / VIP / boost / blocklist semantics decide
WHICH requests are released; a policy decides in what order the
released set is served. `fcfs` is bit-identical to the pre-extraction
engine and stays the default. `srpt` serves shortest-predicted-
remaining-first off an online output-length predictor (per-user EMA of
actual output lengths blended with a prompt-shape feature — host-side
and stdlib-only, like `_propose_drafts`). `edf` serves earliest-
deadline-first over `Request.deadline`, falling back to srpt order for
deadline-less requests.

Anti-starvation: under srpt/edf a waiting request's effective score
decays linearly to 0 over AGING_TICKS batch ticks; aged requests are
FIFO among themselves and beat any fresh score, so the journal
invariant "no starvation past 50 batches" stays green even under a
hostile stream of short requests.

Predictions and outcomes are exported live (`ollamamq_sched_pred_err`,
`ollamamq_sched_decisions_total`). This module is the JAX package's
policy code, unchanged, so both engines decide alike on the same inputs.
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional, Tuple

from ollamamq_tpu_torch.config import SCHEDULERS
from ollamamq_tpu_torch.telemetry import schema as tm

# Batch ticks for a waiting request's effective score to decay to 0 —
# well under the journal's 50-batch starvation bound, leaving slot-wait
# slack after the aged request reaches the front of the order.
AGING_TICKS = 32

# Prefill tokens ride many-per-dispatch in the ragged span path; weight
# the unprefilled prompt tail at one remaining "step" per this many
# tokens when scoring remaining work against decode tokens (one each).
PREFILL_TOKENS_PER_STEP = 16.0


class OutputLenPredictor:
    """Online output-length predictor: per-user EMA of actual output
    lengths blended with a global EMA and a prompt-shape feature (EMA
    of the output/prompt-length ratio). No ML dependencies. Cold start
    predicts the request's own max_tokens budget — the honest ceiling —
    so an unwarmed srpt degrades toward ordering by token budget."""

    WARMUP = 8  # (predicted, actual) pairs before accuracy() reports

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self._user: dict = {}                 # user -> output-length EMA
        self._global: Optional[float] = None  # fleet-wide output EMA
        self._ratio: Optional[float] = None   # output/prompt ratio EMA
        self._window: Deque[Tuple[int, int]] = collections.deque(maxlen=256)
        self.observed = 0

    def predict(self, user: str, n_prompt: int, max_tokens: int) -> int:
        cap = max(1, int(max_tokens))
        ue = self._user.get(user)
        if ue is not None and self._global is not None:
            base = 0.7 * ue + 0.3 * self._global
        elif ue is not None:
            base = ue
        elif self._global is not None:
            base = self._global
        else:
            return cap  # no observations yet: the budget is the guess
        if self._ratio is not None and n_prompt > 0:
            base = 0.75 * base + 0.25 * (self._ratio * n_prompt)
        return max(1, min(cap, int(round(base))))

    def observe(self, user: str, n_prompt: int, actual: int,
                predicted: Optional[int] = None) -> None:
        actual = max(0, int(actual))
        a = self.alpha
        ue = self._user.get(user)
        self._user[user] = actual if ue is None else (1 - a) * ue + a * actual
        self._global = actual if self._global is None \
            else (1 - a) * self._global + a * actual
        if n_prompt > 0:
            r = actual / n_prompt
            self._ratio = r if self._ratio is None \
                else (1 - a) * self._ratio + a * r
        if predicted is not None:
            self._window.append((int(predicted), actual))
        self.observed += 1

    def export_user(self, user: str) -> dict:
        """One user's predictor state for a KV migration blob: the
        target member's predictor shouldn't cold-start a user the fleet
        already learned."""
        return {"user_ema": self._user.get(user),
                "global_ema": self._global, "ratio_ema": self._ratio}

    def import_user(self, user: str, state: dict) -> None:
        """Merge a migrated user's predictor state: never clobber what
        this member already observed locally — migration fills gaps, it
        doesn't overwrite evidence."""
        ue = state.get("user_ema")
        if ue is not None and user not in self._user:
            self._user[user] = float(ue)
        if self._global is None and state.get("global_ema") is not None:
            self._global = float(state["global_ema"])
        if self._ratio is None and state.get("ratio_ema") is not None:
            self._ratio = float(state["ratio_ema"])

    def accuracy(self) -> Optional[float]:
        """Mean relative accuracy (1 - |pred - actual| / max(actual, 1))
        over the recent window, clamped to [0, 1]. None before warmup —
        the TUI renders that as "acc n/a"."""
        window = list(self._window)  # atomic snapshot: the TUI thread
        # reads accuracy at frame cadence while the engine appends.
        if len(window) < self.WARMUP:
            return None
        errs = [abs(p - a) / max(a, 1) for p, a in window]
        return max(0.0, 1.0 - sum(errs) / len(errs))


class SchedulerPolicy:
    """`fcfs`: first-come-first-served — bit-identical to the engine
    before the policy extraction (identity orderings; the legacy
    most-served-user/youngest-arrival victim key). Base class for the
    size-aware policies below. The predictor runs under every policy so
    its accuracy is observable live BEFORE promoting srpt/edf."""

    name = "fcfs"
    # Candidates popped from the fair-share core per admission window;
    # 1 = pop-and-place one at a time, exactly the legacy flow.
    admission_window = 1

    def __init__(self, ecfg=None):
        self.ecfg = ecfg
        self.predictor = OutputLenPredictor()
        self.decisions = 0  # reorders actually applied (stats/TUI)
        self._tick = 0
        self._seq = 0
        self._tm_dec = tm.SCHED_DECISIONS_TOTAL.labels(policy=self.name)

    # -- clock -------------------------------------------------------------
    def on_admit_tick(self) -> None:
        """One batch tick — the clock anti-starvation aging runs on.
        Called once per engine admission pass, in the live loop and the
        synchronous replay/simulate loops alike."""
        self._tick += 1

    def _seen(self, req) -> Tuple[int, int]:
        """(first-seen tick, arrival sequence), stamped the first time
        this policy scores the request and preserved across preemption
        requeues — aging must survive req_id churn."""
        seen = getattr(req, "_sched_seen", None)
        if seen is None:
            self._seq += 1
            seen = (self._tick, self._seq)
            req._sched_seen = seen
        return seen

    def _note_decision(self) -> None:
        self.decisions += 1
        self._tm_dec.inc()

    # -- predictor ---------------------------------------------------------
    def predict(self, req) -> int:
        """Predicted output length, cached at first scoring so the
        finish record journals the prediction the scheduler acted on."""
        p = getattr(req, "_predicted_tokens", None)
        if p is None:
            p = self.predictor.predict(
                req.user, len(req.prompt_tokens),
                getattr(req.sampling, "max_tokens", 1))
            req._predicted_tokens = p
        return p

    def observe_finish(self, req, model: Optional[str] = None) -> None:
        """Fold a served request's actual output length back into the
        predictor and the prediction-error histogram."""
        predicted = self.predict(req)
        actual = len(req.generated_ids)
        self.predictor.observe(req.user, len(req.prompt_tokens), actual,
                               predicted=predicted)
        tm.SCHED_PRED_ERR.labels(model=model or req.model or "?").observe(
            abs(predicted - actual))

    # -- scoring -----------------------------------------------------------
    def remaining(self, req) -> float:
        """Predicted remaining work in decode-step units: predicted
        output still to emit plus the unprefilled prompt tail."""
        pred = max(0, self.predict(req) - len(req.generated_ids))
        left = max(0, len(req.prompt_tokens)
                   - int(getattr(req, "_chunk_pos", 0) or 0))
        return pred + left / PREFILL_TOKENS_PER_STEP

    def score(self, req) -> float:
        """Effective priority (lower serves first), with linear anti-
        starvation aging: decays to 0 over AGING_TICKS, after which aged
        requests are FIFO among themselves and beat any fresh score."""
        seen_tick, _seq = self._seen(req)
        age = self._tick - seen_tick
        if age >= AGING_TICKS:
            return 0.0
        return self.remaining(req) * (AGING_TICKS - age) / AGING_TICKS

    def _order_key(self, req):
        _tick, seq = self._seen(req)
        return (self.score(req), seq)

    # -- decision point (a): admission order -------------------------------
    def order_admission(self, batch: List[tuple]) -> List[tuple]:
        """Order a window of (rid, user, model, req) candidates the
        fair-share core released this pass. fcfs: pop order, untouched."""
        return batch

    def reorder_pending(self, dq) -> None:
        """Order a runtime's pending-prefill deque in place — the slot-
        admission order. fcfs: untouched."""

    # -- decision point (b): prefill-span packing --------------------------
    def pack_order(self, chunking) -> list:
        """Order the in-flight chunked prefills `step_ragged` spends its
        token budget on. fcfs: FIFO."""
        return list(chunking)

    # -- decision point (c): preemption victim -----------------------------
    def victim_key(self, req, served: int):
        """Victim preference key (max wins; VIP/budget eligibility stays
        in the engine). fcfs keeps the legacy heuristic: the most-served
        user's youngest request loses its slot."""
        return (served, req.stats.enqueued_at)


class SrptPolicy(SchedulerPolicy):
    """Shortest-predicted-remaining-first with anti-starvation aging."""

    name = "srpt"
    admission_window = 8

    def order_admission(self, batch: List[tuple]) -> List[tuple]:
        if len(batch) < 2:
            # Still stamp the age anchor: a lone candidate's aging
            # starts when the scheduler first sees it, not when
            # contention appears.
            for t in batch:
                self._seen(t[3])
            return batch
        ordered = sorted(batch, key=lambda t: self._order_key(t[3]))
        if ordered != batch:
            self._note_decision()
        return ordered

    def reorder_pending(self, dq) -> None:
        if len(dq) < 2:
            if dq:
                self._seen(dq[0])
            return
        ordered = sorted(dq, key=self._order_key)
        if list(dq) != ordered:
            dq.clear()
            dq.extend(ordered)
            self._note_decision()

    def pack_order(self, chunking) -> list:
        return sorted(chunking, key=self._order_key)

    def victim_key(self, req, served: int):
        # The longest predicted remaining loses its slot first (keep
        # shorts running — SRPT's dual); fair-share standing and age
        # break ties, i.e. the fcfs key demoted to tie-break.
        return (self.remaining(req), served, req.stats.enqueued_at)


class EdfPolicy(SrptPolicy):
    """Earliest-deadline-first over `Request.deadline`; deadline-less
    requests fall back to srpt order BEHIND any deadline-carrying one
    (a request that told us its latency budget outranks one that
    didn't)."""

    name = "edf"

    def _order_key(self, req):
        _tick, seq = self._seen(req)
        if req.deadline is not None:
            return (0.0, req.deadline, seq)
        return (1.0, self.score(req), seq)

    def victim_key(self, req, served: int):
        # Deadline-less victims first (nobody's SLO dies for pages),
        # then the farthest deadline, then the srpt preference.
        if req.deadline is None:
            return (1.0, 0.0, self.remaining(req), served,
                    req.stats.enqueued_at)
        return (0.0, req.deadline, self.remaining(req), served,
                req.stats.enqueued_at)


_POLICIES = {"fcfs": SchedulerPolicy, "srpt": SrptPolicy, "edf": EdfPolicy}
assert set(_POLICIES) == set(SCHEDULERS)


def make_policy(ecfg) -> SchedulerPolicy:
    """Build the configured policy; loud on an unknown --scheduler (the
    CLI validates pre-device via config.validate_scheduler, but tests
    construct EngineConfig directly)."""
    name = getattr(ecfg, "scheduler", "fcfs") or "fcfs"
    cls = _POLICIES.get(name)
    if cls is None:
        raise ValueError(
            f"unknown --scheduler {name!r} (choose from {SCHEDULERS})")
    return cls(ecfg)
