"""Write-ahead control journal: the controller's durable state as an
append-only record log on simulated durable storage.

The Controller itself used to be the last single point of failure: a
controller crash lost the standby ledger, the storage-checkpoint
index, the staged delta plans and every in-flight `MigrationRun` —
the classic "stuck RUNNING operation" failure mode. This module makes
the control plane crash-consistent:

- every durable-state mutation appends one small JSON-typed record
  (`append`), charged through the CostModel (`bw_journal` +
  `journal_append_latency`) into the SimClock — group-committed on
  the overlap lane, so journaling never widens a downtime window;
- `replay` materializes the records into a plain JSON-typed state
  dict (group topology + staged plans, standby ledger, storage
  checkpoint index, epoch signature, and per-run step logs);
- replay is idempotent: records carry monotonic sequence numbers and
  a record at or below the state's high-water mark is a no-op, so
  replaying a prefix twice changes nothing;
- `compact` folds the whole log into one snapshot record (seq = the
  high-water mark) so replay cost stays bounded: snapshot + tail is
  replay-equivalent to the full log (property-tested).

Deliberately NOT journaled: the worker registry. Workers re-register
with the restarted controller (ktrdr-style) and the registry is
rebuilt from what the live cluster reports — persisting it would only
create a second source of truth that can drift from reality.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.cluster.costmodel import CostModel, DEFAULT

# record types a journal may contain; anything else is rejected at
# append time so replay never meets an unknown type
RECORD_TYPES = frozenset((
    "groups",            # full topology snapshot incl. staged plans
    "standbys",          # the standby ledger (full, it is tiny)
    "storage_index",     # storage-checkpoint metadata: (mid, step, slot)
    "epoch",             # committed epoch signature across the grid
    "run_begin",         # a MigrationRun started: op, params, step names
    "run_step",          # one journal step completed
    "run_invalidate",    # recovery dropped steps for re-execution
    "run_switch",        # a group switched: gid + the applied plan
    "run_revert",        # rollback reverted one switched group
    "run_resume",        # the run absorbed a fault and resumed
    "run_meta",          # op-specific adoption context (pairing, ...)
    "run_adopt",         # a restarted controller adopted the run
    "policy",            # a PolicyEngine decision: ranking + telemetry
    "snapshot",          # compaction: the materialized state itself
))


# ------------------------------------------------------------ replay
def empty_state() -> dict:
    """The materialized journal state before any record applied. Pure
    JSON types throughout (no int-keyed dicts, no sets) so a state
    survives a serialize/deserialize round trip bit-identically."""
    return {
        "last_seq": -1,
        "groups": {},          # gid -> {kind, members, channels, state}
        "standbys": [],
        "storage_index": [],   # [mid, step, [d, s]] triples
        "epoch": [],           # [mid, step] pairs
        "runs": {},            # jid -> run record (see _apply_run_begin)
        "policies": [],        # PolicyDecision.to_record() dicts, in order
    }


def apply_record(state: dict, rec: dict) -> dict:
    """Apply one record in place. Idempotent by sequence number: a
    record at or below the state's high-water mark is skipped, so
    replaying any prefix twice is a no-op."""
    if rec["seq"] <= state["last_seq"]:
        return state
    rtype, data = rec["type"], rec["data"]
    if rtype == "snapshot":
        # deep copy through JSON so later mutations never alias the
        # snapshot record still sitting in the log
        fresh = json.loads(json.dumps(data["state"]))
        state.clear()
        state.update(fresh)
        state["last_seq"] = rec["seq"]
        return state
    if rtype == "groups":
        state["groups"] = {g["gid"]: g for g in data["groups"]}
    elif rtype == "standbys":
        state["standbys"] = list(data["mids"])
    elif rtype == "storage_index":
        state["storage_index"] = [list(e) for e in data["entries"]]
    elif rtype == "epoch":
        state["epoch"] = [list(p) for p in data["sig"]]
    elif rtype == "policy":
        # setdefault: snapshots taken before the policy layer existed
        # materialize without the key, and must stay replayable
        state.setdefault("policies", []).append(
            json.loads(json.dumps(data)))
    elif rtype == "run_begin":
        state["runs"][data["run"]] = {
            "label": data["label"], "op": data["op"],
            "params": data["params"], "steps": list(data["steps"]),
            "done": [], "state": "idle", "resumes": 0,
            "meta": {}, "switched": [], "committed": False,
        }
    else:
        rr = state["runs"][data["run"]]
        if rtype == "run_step":
            if data["step"] not in rr["done"]:
                rr["done"].append(data["step"])
            rr["state"] = data["state"]
            rr["committed"] = data["state"] == "committed"
        elif rtype == "run_invalidate":
            rr["done"] = [n for n in rr["done"]
                          if n not in set(data["steps"])]
        elif rtype == "run_switch":
            rr["switched"].append({"gid": data["gid"],
                                   "plan": data["plan"]})
        elif rtype == "run_revert":
            rr["done"] = [n for n in rr["done"]
                          if n != f"switch:{data['gid']}"]
            rr["switched"] = [s for s in rr["switched"]
                              if s["gid"] != data["gid"]]
        elif rtype == "run_resume":
            rr["resumes"] += 1
        elif rtype == "run_meta":
            rr["meta"].update({k: v for k, v in data.items()
                               if k != "run"})
        else:
            assert rtype == "run_adopt", rtype
    state["last_seq"] = rec["seq"]
    return state


def replay_records(records: List[dict],
                   state: Optional[dict] = None) -> dict:
    """Materialize `records` into a state dict (continuing from
    `state` if given — idempotently, per record sequence numbers)."""
    state = state if state is not None else empty_state()
    for rec in records:
        apply_record(state, rec)
    return state


# ----------------------------------------------------------- journal
class ControlJournal:
    """Append-only durable log with CostModel-charged writes and
    snapshot+tail compaction. `clock=None` makes a free-standing
    journal (property tests); with a clock every append/compaction
    advances it on the overlap lane — journaling is group-committed
    off the critical path, only restart *replay* can land in a
    downtime window (charged by Controller.restart)."""

    def __init__(self, clock=None, cost: CostModel = DEFAULT,
                 compact_every: int = 64, lane: str = "overlap"):
        self.clock = clock
        self.cost = cost
        self.compact_every = compact_every
        self.lane = lane
        self.records: List[dict] = []
        self.seq = -1                  # high-water mark, survives compaction
        self.appends = 0               # lifetime appends (diagnostics)
        self.compactions = 0
        self.bytes_appended = 0.0      # lifetime bytes written

    # ------------------------------------------------------- plumbing
    @staticmethod
    def _rec_bytes(rec: dict) -> int:
        return len(json.dumps(rec, sort_keys=True))

    @property
    def bytes_durable(self) -> int:
        """Bytes a restart must read back: the compacted log only."""
        return sum(self._rec_bytes(r) for r in self.records)

    def _charge(self, nbytes: int, name: str) -> None:
        if self.clock is None:
            return
        t = self.cost.transfer(nbytes, self.cost.bw_journal,
                               self.cost.journal_append_latency)
        self.clock.advance(t, name, lane=self.lane)

    # -------------------------------------------------------- appends
    def append(self, rtype: str, data: Dict[str, Any]) -> dict:
        assert rtype in RECORD_TYPES, f"unknown record type {rtype!r}"
        self.seq += 1
        rec = {"seq": self.seq, "type": rtype, "data": data}
        self.records.append(rec)
        self.appends += 1
        nbytes = self._rec_bytes(rec)
        self.bytes_appended += nbytes
        self._charge(nbytes, f"journal:{rtype}")
        if self._tail_len() >= self.compact_every:
            self.compact()
        return rec

    def next_run_id(self) -> str:
        """Deterministic run id for the next run_begin: derived from
        the sequence counter, so it survives compaction and restart."""
        return f"r{self.seq + 1}"

    # ----------------------------------------------------- compaction
    def _tail_len(self) -> int:
        n = len(self.records)
        if n and self.records[0]["type"] == "snapshot":
            n -= 1
        return n

    def compact(self) -> None:
        """Fold the log into one snapshot record carrying the
        materialized state at the current high-water mark. Replay of
        snapshot+tail is equivalent to replay of the full log
        (property-tested), and replay cost stays bounded by
        `compact_every` records plus one snapshot."""
        state = self.replay()
        snap = {"seq": self.seq, "type": "snapshot",
                "data": {"state": state}}
        self.records = [snap]
        self.compactions += 1
        nbytes = self._rec_bytes(snap)
        self.bytes_appended += nbytes
        self._charge(nbytes, "journal:snapshot")

    # --------------------------------------------------------- replay
    def replay(self, state: Optional[dict] = None) -> dict:
        return replay_records(self.records, state)

    # -------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({"seq": self.seq, "records": self.records},
                          sort_keys=True)

    @classmethod
    def from_json(cls, s: str, clock=None, cost: CostModel = DEFAULT,
                  compact_every: int = 64) -> "ControlJournal":
        raw = json.loads(s)
        j = cls(clock=clock, cost=cost, compact_every=compact_every)
        j.records = raw["records"]
        j.seq = raw["seq"]
        return j
