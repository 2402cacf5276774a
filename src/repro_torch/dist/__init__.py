"""Fault-tolerance helpers of the search runtime: deadline-based straggler
ejection, batch redistribution over the survivors, checkpoint cadence.

A copy of `repro.dist.fault_tolerance`. The reference's sharding rules and
compressed all-reduce belong to the LM stack and are not ported yet.
"""
