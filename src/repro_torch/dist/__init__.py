"""Distributed-training substrate, the counterpart of `repro.dist`:
sharding rules (`sharding`), compressed gradient all-reduce
(`grad_compression`) and fault-tolerance helpers (`fault_tolerance`).

The rules resolve on abstract shapes (meta tensors against an abstract
mesh of axis names and sizes), so they are testable without devices and
hold from one card to a pod.
"""
