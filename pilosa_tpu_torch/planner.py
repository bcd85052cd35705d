"""Cost-based query planner: reorders, short-circuits, pushdown marks, the
plan-cache keys, the per-leaf representation choice and the calibration
ring.

Port of pilosa_tpu/planner.py. Between parse and execution the planner
reads the statistics storage keeps (Fragment.row_cardinality, the per-row
write generations) and

  * reorders commutative Intersect/Union/Xor operands cheapest-first by
    estimated cardinality, the text breaking ties, so every permutation
    of the same operands plans to one tree and one plan-cache key
    (:140-406);
  * short-circuits provably empty branches: only exact zeros over valid
    subtrees rewrite, to the canonical empty call, zero-arg Union(),
    which the executor answers without a leaf read or a launch;
  * marks Count(bitmap) and TopN(src=bitmap) as pushdown (no host row
    bitmap);
  * keys the executor's plan cache (subtree_cache_key, :412-505): the
    canonical PQL, the shard set and every leaf's generations, so a write
    changes the key and invalidation is free;
  * picks each row leaf's device form (choose_representation) and records
    it on the executing plan node.

Planning is advisory: an estimation surprise degrades to the written
order, an ExecutionError still surfaces, and a parsed Call is never
mutated (parse_string_cached shares ASTs between threads).

Kill switches: PILOSA_TPU_TORCH_PLANNER=0 and PILOSA_TPU_TORCH_PLAN_CACHE=0
(read when an Executor is built), Server(plan="off", plan_cache_bytes=0).

The port has no key translation and no time views (ROADMAP Queue A 6):
a string row key raises NotPortedError, which estimates as unknown, and a
time Range is never cached.
"""

from __future__ import annotations

import collections
import contextvars
import threading
import time
from typing import NamedTuple, Optional

from pilosa_tpu_torch.constants import EXISTENCE_FIELD_NAME
from pilosa_tpu_torch.models.view import VIEW_STANDARD
from pilosa_tpu_torch.pql import Call
from pilosa_tpu_torch.pql.ast import Condition
from pilosa_tpu_torch.utils.heat import Frags
from pilosa_tpu_torch.utils.profile import truncate_pql

# the plan node of the call being executed: cache events and hybrid
# choices recorded deep in the evaluation land in the dict ?profile=true
# serializes
current_plan: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("pilosa_torch_current_plan", default=None)

BITMAP_CALLS = frozenset({"Row", "Union", "Intersect", "Difference", "Xor",
                          "Not", "Range"})
COMMUTATIVE = ("Intersect", "Union", "Xor")
# calls the executor hands to plan_call
PLANNED_CALLS = frozenset(BITMAP_CALLS | {"Count", "TopN", "Sum", "Min",
                                          "Max", "GroupBy"})

_EXPR_LIMIT = 96  # expr strings in plan and profile nodes
_NODE_ENTRIES = 48  # estimates, cache events, hybrid entries per node


def empty_operand_error(call: Call):
    """The zero-operand error of Intersect() and Difference(): names the
    PQL offset and the offending fragment (:96-105)."""
    from pilosa_tpu_torch.executor import ExecutionError
    where = (f" at PQL offset {call.pos}" if call.pos is not None else "")
    return ExecutionError(
        f"{call.name}() requires at least one bitmap operand{where} "
        f"(offending fragment: {call.to_pql()})")


def empty_call(like: Optional[Call] = None) -> Call:
    """The canonical provably empty bitmap call, zero-arg Union()."""
    return Call("Union", pos=like.pos if like is not None else None)


def is_empty_call(c: Call) -> bool:
    return c.name == "Union" and not c.children and not c.args


class Estimate(NamedTuple):
    """Cardinality estimate of one subtree over the query's shards: count
    is an upper bound (None: unknown), exact marks it exact for the
    current generations, valid marks a subtree the executor evaluates
    without a validation error (only valid subtrees are planned away)."""

    count: Optional[int]
    exact: bool
    valid: bool


UNKNOWN = Estimate(None, False, False)
ZERO = Estimate(0, True, True)


def _exact_zero(e: Estimate) -> bool:
    return e.exact and e.valid and e.count == 0


def _plan_expr(c: Call) -> str:
    return truncate_pql(c.to_pql(), _EXPR_LIMIT)


class QueryPlanner:
    """The executor's planning pass and its counters (/debug/vars
    `planner`, /metrics planner/*)."""

    def __init__(self, executor):
        self.executor = executor
        self.enabled = True
        self._lock = threading.Lock()
        self.plans = 0
        self.reorders = 0
        self.pushdowns = 0
        self.short_circuits = 0

    def plan_call(self, index, call: Call, shards) -> tuple:
        """(planned call, plan node) of one top-level call; the input tree
        is never mutated."""
        info = {"call": call.name, "reorders": 0, "shortCircuits": 0,
                "pushdown": False, "order": None, "estimates": [],
                "cache": [], "hostRowBitmapBytes": 0}
        if not self.enabled:
            return call, info
        from pilosa_tpu_torch.executor import ExecutionError
        try:
            planned = self._plan_top(index, call, list(shards), info)
        except ExecutionError:
            raise  # the zero-operand error
        except Exception:  # noqa: BLE001 — an estimation surprise keeps
            return call, info  # the written order
        with self._lock:
            self.plans += 1
            self.reorders += info["reorders"]
            self.short_circuits += info["shortCircuits"]
            if info["pushdown"]:
                self.pushdowns += 1
        return planned, info

    def snapshot(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "plans": self.plans,
                    "reorders": self.reorders, "pushdowns": self.pushdowns,
                    "shortCircuits": self.short_circuits}

    # ------------------------------------------------------- tree rewrite

    def _plan_top(self, index, call: Call, shards: list, info: dict) -> Call:
        memo: dict = {}  # the existence count, once per plan
        if call.name in BITMAP_CALLS:
            return self._plan_bitmap(index, call, shards, info, memo)[0]
        if call.name == "Count" and len(call.children) == 1:
            child, _ = self._plan_bitmap(index, call.children[0], shards,
                                         info, memo)
            if child.children or is_empty_call(child):
                info["pushdown"] = True
            if child is call.children[0]:
                return call
            return Call(call.name, call.args, [child], pos=call.pos)
        if call.name in ("TopN", "Sum", "Min", "Max") and call.children:
            child, _ = self._plan_bitmap(index, call.children[0], shards,
                                         info, memo)
            if call.name == "TopN" and (child.children
                                        or is_empty_call(child)):
                info["pushdown"] = True
            if child is call.children[0]:
                return call
            return Call(call.name, call.args,
                        [child] + list(call.children[1:]), pos=call.pos)
        if call.name == "GroupBy":
            changed = False
            children = []
            for ch in call.children:
                if ch.name in BITMAP_CALLS:  # the positional filter
                    new, _ = self._plan_bitmap(index, ch, shards, info, memo)
                    changed |= new is not ch
                    children.append(new)
                else:
                    children.append(ch)
            args = call.args
            filt = args.get("filter")
            if isinstance(filt, Call) and filt.name in BITMAP_CALLS:
                new, _ = self._plan_bitmap(index, filt, shards, info, memo)
                if new is not filt:
                    args = dict(args)
                    args["filter"] = new
                    changed = True
            if not changed:
                return call
            return Call(call.name, args, children, pos=call.pos)
        return call

    def _plan_bitmap(self, index, c: Call, shards: list, info: dict,
                     memo: dict) -> tuple:
        new, est = self._plan_bitmap_inner(index, c, shards, info, memo)
        self._note(info, new, est)
        return new, est

    @staticmethod
    def _rebuilt(c: Call, children: list) -> Call:
        """`c` itself when `children` are its own, else a new node."""
        if (len(children) == len(c.children)
                and all(a is b for a, b in zip(children, c.children))):
            return c
        return Call(c.name, c.args, children, pos=c.pos)

    def _plan_bitmap_inner(self, index, c: Call, shards: list, info: dict,
                           memo: dict) -> tuple:
        if c.name == "Row":
            return c, self._row_estimate(index, c, shards)
        if c.name == "Range":
            return c, UNKNOWN
        if c.name == "Not":
            if len(c.children) != 1:
                return c, UNKNOWN
            child, ce = self._plan_bitmap(index, c.children[0], shards,
                                          info, memo)
            ex_count = self._existence_count(index, shards, memo)
            if ex_count is None:
                est = UNKNOWN
            elif _exact_zero(ce):
                est = Estimate(ex_count, True, ce.valid)  # Not(empty)
            elif ex_count == 0 and ce.valid:
                est = ZERO  # no columns: Not is empty
            elif ce.count is not None:
                est = Estimate(max(ex_count - ce.count, 0), False, ce.valid)
            else:
                est = Estimate(ex_count, False, False)
            return self._rebuilt(c, [child]), est
        if c.name == "Difference":
            if not c.children:
                raise empty_operand_error(c)
            pairs = [self._plan_bitmap(index, ch, shards, info, memo)
                     for ch in c.children]
            first_est = pairs[0][1]
            all_valid = all(e.valid for _, e in pairs)
            if _exact_zero(first_est) and all_valid:
                info["shortCircuits"] += 1
                return empty_call(c), ZERO
            kept = [pairs[0]]
            for p in pairs[1:]:
                if _exact_zero(p[1]):
                    info["shortCircuits"] += 1  # a &~ empty = a
                else:
                    kept.append(p)
            est = Estimate(first_est.count,
                           first_est.exact and len(kept) == 1, all_valid)
            return self._rebuilt(c, [ch for ch, _ in kept]), est
        if c.name in COMMUTATIVE:
            if c.name == "Intersect" and not c.children:
                raise empty_operand_error(c)
            pairs = [self._plan_bitmap(index, ch, shards, info, memo)
                     for ch in c.children]
            all_valid = all(e.valid for _, e in pairs)
            if c.name == "Intersect":
                if all_valid and any(_exact_zero(e) for _, e in pairs):
                    info["shortCircuits"] += 1
                    return empty_call(c), ZERO
            else:  # Union / Xor: empty operands are identities
                kept = []
                for p in pairs:
                    if _exact_zero(p[1]):
                        info["shortCircuits"] += 1
                    else:
                        kept.append(p)
                if not kept:
                    return empty_call(c), ZERO
                pairs = kept
            # cheapest first, the text breaking ties: every permutation
            # of the same operands plans to one canonical order
            ordered = sorted(
                pairs, key=lambda p: (p[1].count if p[1].count is not None
                                      else float("inf"), p[0].to_pql()))
            if [p[0] for p in ordered] != [p[0] for p in pairs]:
                info["reorders"] += 1
            pairs = ordered
            info["order"] = [_plan_expr(ch) for ch, _ in pairs]
            known = [e.count for _, e in pairs if e.count is not None]
            if c.name == "Intersect":
                count = min(known) if known else None
                exact = all_valid and any(_exact_zero(e) for _, e in pairs)
            else:
                count = sum(known) if known else None
                exact = (all(e.exact for _, e in pairs)
                         and all(e.count == 0 for _, e in pairs))
            return (self._rebuilt(c, [ch for ch, _ in pairs]),
                    Estimate(count, exact, all_valid))
        return c, UNKNOWN

    # -------------------------------------------------------- estimation

    def _row_estimate(self, index, c: Call, shards: list) -> Estimate:
        try:
            field_name = c.field_arg()
            if index.field(field_name) is None:
                return UNKNOWN  # the executor raises "field not found"
            row_id = self.executor._row_id(c.args[field_name])
            return Estimate(self._row_cardinality(
                index, field_name, VIEW_STANDARD, shards, row_id),
                True, True)
        except Exception:  # noqa: BLE001 — estimation is advisory
            return UNKNOWN

    @staticmethod
    def _row_cardinality(index, field_name: str, view_name: str,
                         shards: list, row_id: int) -> int:
        f = index.field(field_name)
        view = f.view(view_name) if f is not None else None
        if view is None:
            return 0
        total = 0
        for s in shards:
            frag = view.fragment(s)
            if frag is not None:
                total += frag.row_cardinality(row_id)
        return total

    def _existence_count(self, index, shards: list,
                         memo: dict) -> Optional[int]:
        if "ex" not in memo:
            if index.existence_field() is None:
                memo["ex"] = None
            else:
                try:
                    memo["ex"] = self._row_cardinality(
                        index, EXISTENCE_FIELD_NAME, VIEW_STANDARD, shards, 0)
                except Exception:  # noqa: BLE001
                    memo["ex"] = None
        return memo["ex"]

    @staticmethod
    def _note(info: dict, call: Call, est: Estimate) -> None:
        if len(info["estimates"]) >= _NODE_ENTRIES:
            return
        info["estimates"].append({"expr": _plan_expr(call),
                                  "est": est.count, "exact": est.exact})


# --------------------------------------------------------------- cache keys


class _Uncacheable(Exception):
    pass


def subtree_cache_key(executor, index, call: Call,
                      shards) -> Optional[tuple]:
    """Plan-cache key of a bitmap subtree: (index, canonical PQL, shard
    tuple, per-leaf generations), or None for a shape that cannot be keyed
    (a missing field, a string key, a time Range, a non-bitmap call). The
    generations are read from the fragments on every lookup, so a write
    under the subtree gives another key."""
    gens: list = []
    shards_l = list(shards)

    def leaf(field: str, view: str, row_id: int) -> None:
        gens.append(("r", field, view,
                     executor._leaf_gens(index, field, view, shards_l,
                                         row_id)))

    def walk(c: Call) -> None:
        if c.name == "Row":
            field_name = c.field_arg()
            if index.field(field_name) is None:
                raise _Uncacheable
            leaf(field_name, VIEW_STANDARD,
                 executor._row_id(c.args[field_name]))
            return
        if c.name == "Range":
            if "_start" in c.args or "_end" in c.args:
                raise _Uncacheable  # time views are not ported
            cond_field = None
            for k, v in c.args.items():
                if isinstance(v, Condition):
                    cond_field = k
            if cond_field is None:
                raise _Uncacheable
            f = index.field(cond_field)
            if f is None or f.options.type != "int":
                raise _Uncacheable
            depth = f.bit_depth
            gens.append(("bsi", cond_field, depth, f.base, tuple(
                executor._leaf_gens(index, cond_field, f.bsi_view_name,
                                    shards_l, r)
                for r in range(depth + 1))))
            return
        if c.name == "Not":
            if index.existence_field() is None:
                raise _Uncacheable
            leaf(EXISTENCE_FIELD_NAME, VIEW_STANDARD, 0)
            for ch in c.children:
                walk(ch)
            return
        if c.name in ("Union", "Intersect", "Difference", "Xor"):
            for ch in c.children:
                walk(ch)
            return
        raise _Uncacheable

    try:
        walk(call)
    except Exception:  # noqa: BLE001 — an uncacheable shape just misses
        return None
    return (index.name, call.to_pql(), tuple(shards_l), tuple(gens))


def record_cache_event(call: Call, hit: bool) -> None:
    """A plan-cache hit or miss on the executing call's plan node."""
    plan = current_plan.get()
    if plan is None:
        return
    events = plan.get("cache")
    if events is not None and len(events) < _NODE_ENTRIES:
        events.append({"expr": _plan_expr(call), "hit": hit})


# ------------------------------------------------- hybrid representation


def choose_representation(hybrid, index, field_name: str, view_name: str,
                          shards: list, row_id: int,
                          call: Optional[Call] = None, peek: bool = False,
                          stats_out: Optional[dict] = None) -> tuple:
    """(rep, slots, frags, gens) for one row leaf (:522-597): rep is
    "sparse", "run" or "dense", slots the padded width of a sparse or run
    leaf, frags the row's fragments per shard (None where a shard has
    none) and gens their row generations, the version part of every
    residency key.

    One pass over the fragments reads the generations. The statistics the
    choice needs, the largest per-shard cardinality (Fragment.
    row_cardinality) and, above the sparse threshold with runs enabled,
    the largest interval count (Fragment.row_interval_count; the JAX
    package reads row_run_stats, whose max run length the choice never
    uses), are read from the fragments only when the generations differ
    from those of the row's last choice over the same shards: the manager
    keeps them (HybridManager.leaf_stats).

    With `call` given, the choice is recorded on the executing plan node's
    `hybrid` list. peek=True is EXPLAIN's mode: the same choice without
    advancing the hysteresis memory; `stats_out` receives the statistics
    it read (maxShardCardinality, runIntervals)."""
    f = index.field(field_name)
    view = f.view(view_name) if f is not None else None
    frags = [None if view is None else view.fragment(s) for s in shards]
    gens = tuple(0 if fr is None else fr.row_generation(row_id)
                 for fr in frags)
    if hybrid is None or not hybrid.active():
        if stats_out is not None:
            stats_out.update(maxShardCardinality=None, runIntervals=None)
        return "dense", 0, frags, gens
    shards_t = tuple(shards)
    stats = hybrid.leaf_stats(
        (index.name, field_name, view_name, row_id, shards_t), gens)
    if stats[0] is None:
        stats[0] = max((fr.row_cardinality(row_id) for fr in frags
                        if fr is not None), default=0)

    def intervals() -> int:
        if stats[1] is None:
            stats[1] = max((fr.row_interval_count(row_id) for fr in frags
                            if fr is not None), default=0)
        return stats[1]

    max_card = stats[0]
    run_stats: Optional[tuple] = None
    if max_card > hybrid.threshold and hybrid.run_threshold > 0:
        run_stats = (intervals(),)
    rep, slots = hybrid.choose((index.name, field_name, view_name, row_id),
                               max_card,
                               Frags(index.name, field_name, view_name,
                                     shards_t),
                               run_stats=run_stats, peek=peek)
    if rep == "run" and run_stats is None:
        # hysteresis kept a run row run without its statistics (the row
        # fell into the sparse band, or runs were switched off): the JAX
        # package sizes that leaf at 8 slots and drops every interval
        # past the eighth; the port sizes it from the statistics
        slots = hybrid.pad_slots(max(intervals(), 1))
    n_iv = int(run_stats[0]) if run_stats else 0
    if stats_out is not None:
        stats_out.update(maxShardCardinality=int(max_card),
                         runIntervals=n_iv)
    plan = current_plan.get()
    if plan is not None and call is not None:
        reps = plan.setdefault("hybrid", [])
        if len(reps) < _NODE_ENTRIES:
            reps.append({"expr": _plan_expr(call), "rep": rep,
                         "maxShardCardinality": int(max_card),
                         "slots": slots, "runIntervals": n_iv})
    return rep, slots, frags, gens


# --------------------------------------------------------- calibration ring


class CalibrationRing:
    """Estimate against actual, per planned call of every profiled query
    (:603-667): /debug/vars `planner.calibration`, and the aggregates on
    every EXPLAIN document."""

    def __init__(self, size: int = 256):
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(
            maxlen=max(1, int(size)))
        self.recorded = 0
        self.compared = 0  # entries with both an estimate and an actual
        self.abs_rel_err_sum = 0.0
        self.max_abs_rel_err = 0.0

    def record(self, entry: dict) -> None:
        est, actual = entry.get("est"), entry.get("actual")
        if est is not None and actual is not None:
            # against the actual, floored at 1: > 0 is an overestimate
            err = (float(est) - float(actual)) / max(float(actual), 1.0)
            entry = dict(entry, relErr=round(err, 4))
        with self._lock:
            self._buf.append(entry)
            self.recorded += 1
            if "relErr" in entry:
                self.compared += 1
                a = abs(entry["relErr"])
                self.abs_rel_err_sum += a
                self.max_abs_rel_err = max(self.max_abs_rel_err, a)

    def snapshot(self, limit: int = 32) -> dict:
        """Aggregates and the newest `limit` entries, newest first (0: the
        aggregates alone)."""
        with self._lock:
            entries = list(self._buf)[-int(limit):] if limit > 0 else []
            return {
                "size": self._buf.maxlen,
                "recorded": self.recorded,
                "compared": self.compared,
                "meanAbsRelErr": round(
                    self.abs_rel_err_sum / self.compared, 4)
                if self.compared else None,
                "maxAbsRelErr": round(self.max_abs_rel_err, 4)
                if self.compared else None,
                "entries": list(reversed(entries)),
            }

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self.recorded = 0
            self.compared = 0
            self.abs_rel_err_sum = 0.0
            self.max_abs_rel_err = 0.0


# one ring per process
calibration = CalibrationRing()


def record_calibration(prof, calls, results) -> None:
    """Feed the ring from one executed profiled query (:674-709): each
    plan node the profile holds, in call order, beside its call's result.
    A count calibrates the estimate; any other result records the
    estimate alone. The query's host-to-device bytes ride the first entry.
    Never raises."""
    try:
        plans = list(prof.plans)
        if not plans:
            return
        planned = [(c, r) for c, r in zip(calls, results)
                   if c.name in PLANNED_CALLS]
        h2d = int(prof.h2d_bytes)
        for plan, (_call, result) in zip(plans, planned):
            ests = plan.get("estimates") or []
            actual = None
            if isinstance(result, (int, float)) and not isinstance(result,
                                                                   bool):
                actual = int(result)
            calibration.record({
                "ts": round(time.time(), 3),
                "call": plan.get("call"),
                "expr": ests[0].get("expr") if ests else None,
                "exact": ests[0].get("exact") if ests else None,
                "est": ests[0].get("est") if ests else None,
                "actual": actual,
                "h2dBytes": h2d,
                "elapsedMs": prof.elapsed_ms or None,
            })
            h2d = 0
    except Exception:  # noqa: BLE001 — never breaks a response
        pass
