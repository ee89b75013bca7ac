"""Fault-tolerance control plane (heartbeats, stragglers, preemption)."""
