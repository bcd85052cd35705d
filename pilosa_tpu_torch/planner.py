"""The planner's per-leaf representation choice.

Port of pilosa_tpu/planner.py choose_representation (:522-597) without
its plan-node recording. The rest of the JAX planner (reorders,
short-circuits, the plan cache) is not ported: none of it changes an
answer.
"""

from __future__ import annotations

from typing import Optional

from pilosa_tpu_torch.utils.heat import Frags


def choose_representation(hybrid, index, field_name: str, view_name: str,
                          shards: list, row_id: int) -> tuple:
    """(rep, slots, frags, gens) for one row leaf: rep is "sparse", "run"
    or "dense", slots the padded width of a sparse or run leaf, frags the
    row's fragments per shard (None where a shard has none) and gens their
    row generations, the version part of every residency key.

    One pass over the fragments reads the generations. The statistics the
    choice needs, the largest per-shard cardinality (Fragment.
    row_cardinality) and, above the sparse threshold with runs enabled,
    the largest interval count (Fragment.row_interval_count; the JAX
    package reads row_run_stats, whose max run length the choice never
    uses), are read from the fragments only when the generations differ
    from those of the row's last choice over the same shards: the manager
    keeps them (HybridManager.leaf_stats)."""
    f = index.field(field_name)
    view = f.view(view_name) if f is not None else None
    frags = [None if view is None else view.fragment(s) for s in shards]
    gens = tuple(0 if fr is None else fr.row_generation(row_id)
                 for fr in frags)
    if hybrid is None or not hybrid.active():
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
                               run_stats=run_stats)
    if rep == "run" and run_stats is None:
        # hysteresis kept a run row run without its statistics (the row
        # fell into the sparse band, or runs were switched off): the JAX
        # package sizes that leaf at 8 slots and drops every interval
        # past the eighth; the port sizes it from the statistics
        slots = hybrid.pad_slots(max(intervals(), 1))
    return rep, slots, frags, gens
