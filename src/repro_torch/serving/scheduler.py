"""Host-side continuous-batching scheduler: slots, FIFO admission, eviction.

The port's own copy of ``repro.serving.scheduler`` (which imports no JAX):
the state machine is framework-free, and the port imports nothing of the
reference package.

The scheduler is the *only* policy component of the serving engine and is
deliberately model-free: it never touches device arrays, so the whole
admission/eviction state machine is testable step-by-step against synthetic
arrival traces with a fake model (the reference's tests/test_scheduler.py).

Model of operation (open-loop arrivals):

* ``submit(request, step=...)`` appends to an unbounded FIFO wait queue --
  arrivals are generated by the outside world regardless of server state.
* ``admit(step=...)`` moves waiters into free batch slots, strictly FIFO,
  until slots or waiters run out.  A request occupies exactly one slot from
  admission to completion.
* ``complete(slot, step=...)`` evicts the slot's request (EOS or
  ``max_new_tokens`` reached -- the engine decides *when*, the scheduler
  only does the bookkeeping) and frees the slot for the next admission.

Invariants (enforced with exceptions, not best-effort comments):

* a slot never holds two live requests (no double-occupancy);
* admission order == submission order (FIFO -- no starvation as long as
  completions keep happening, which the property suite checks);
* eviction only of occupied slots, completion recorded exactly once.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

FREE = -1  # slot sentinel: no rid occupies the slot


class SchedulerInvariantError(AssertionError):
    """A slot/queue invariant was violated (always a bug, never load)."""


@dataclasses.dataclass
class RequestState:
    """Per-request lifecycle record kept from submission to completion."""

    rid: int
    request: Any                  # serving.engine.Request (duck-typed)
    seed: int                     # per-request sampling seed (see engine)
    submit_step: int
    slot: Optional[int] = None
    admit_step: Optional[int] = None
    finish_step: Optional[int] = None
    tokens: list = dataclasses.field(default_factory=list)
    seq_logprob: float = 0.0
    # Strategy-specific per-request results (e.g. speculative decoding's
    # accepted-draft count); filled at drain from the strategy's outputs.
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def waiting(self) -> bool:
        return self.slot is None and self.finish_step is None

    @property
    def live(self) -> bool:
        return self.slot is not None and self.finish_step is None

    @property
    def done(self) -> bool:
        return self.finish_step is not None


class Scheduler:
    """FIFO continuous-batching scheduler over ``num_slots`` batch slots."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.slots: list[int] = [FREE] * num_slots   # slot -> rid
        self.queue: deque[int] = deque()             # waiting rids, FIFO
        self.records: dict[int, RequestState] = {}
        self._next_rid = 0

    # -- submission / admission / eviction ----------------------------------

    def submit(self, request, *, step: int = 0, seed: int | None = None) -> int:
        """Register an arrival; returns its rid.  ``seed`` defaults to the
        request's own ``seed`` attribute if set, else the rid -- so identical
        request streams sample identically whatever the engine (see the
        parity suite)."""
        rid = self._next_rid
        self._next_rid += 1
        if seed is None:
            seed = getattr(request, "seed", None)
        if seed is None:
            seed = rid
        self.records[rid] = RequestState(
            rid=rid, request=request, seed=seed, submit_step=step)
        self.queue.append(rid)
        return rid

    def admit(self, *, step: int = 0) -> list[RequestState]:
        """FIFO-admit waiters into free slots; returns the new admissions."""
        admitted = []
        for slot in range(self.num_slots):
            if not self.queue:
                break
            if self.slots[slot] != FREE:
                continue
            rid = self.queue.popleft()
            rec = self.records[rid]
            if rec.slot is not None:
                raise SchedulerInvariantError(
                    f"rid {rid} admitted twice (already in slot {rec.slot})")
            self.slots[slot] = rid
            rec.slot = slot
            rec.admit_step = step
            admitted.append(rec)
        return admitted

    def complete(self, slot: int, *, step: int = 0) -> RequestState:
        """Evict ``slot``'s request (it finished) and free the slot."""
        rid = self.slots[slot]
        if rid == FREE:
            raise SchedulerInvariantError(f"complete() on free slot {slot}")
        rec = self.records[rid]
        if rec.done:
            raise SchedulerInvariantError(f"rid {rid} completed twice")
        rec.finish_step = step
        rec.slot = None
        self.slots[slot] = FREE
        return rec

    # -- views ---------------------------------------------------------------

    @property
    def free_slots(self) -> list[int]:
        return [s for s, rid in enumerate(self.slots) if rid == FREE]

    @property
    def live_slots(self) -> list[int]:
        return [s for s, rid in enumerate(self.slots) if rid != FREE]

    @property
    def has_waiting(self) -> bool:
        return bool(self.queue)

    @property
    def all_done(self) -> bool:
        return not self.queue and not self.live_slots

    def record(self, rid: int) -> RequestState:
        return self.records[rid]

    def slot_record(self, slot: int) -> RequestState:
        rid = self.slots[slot]
        if rid == FREE:
            raise SchedulerInvariantError(f"slot {slot} is free")
        return self.records[rid]

    # -- invariant audit (cheap; called by tests after every simulated step) -

    def check_invariants(self):
        occupied = [rid for rid in self.slots if rid != FREE]
        if len(occupied) != len(set(occupied)):
            raise SchedulerInvariantError(f"rid in two slots: {self.slots}")
        for slot, rid in enumerate(self.slots):
            if rid != FREE:
                rec = self.records[rid]
                if rec.slot != slot or rec.done:
                    raise SchedulerInvariantError(
                        f"slot {slot} -> rid {rid} but record says "
                        f"slot={rec.slot} done={rec.done}")
        for rid in self.queue:
            if self.records[rid].slot is not None:
                raise SchedulerInvariantError(
                    f"queued rid {rid} also occupies a slot")
        # FIFO: the queue is ordered by submission.
        rids = list(self.queue)
        if rids != sorted(rids):
            raise SchedulerInvariantError(f"wait queue out of order: {rids}")
