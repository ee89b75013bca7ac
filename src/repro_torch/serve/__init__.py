"""Continuous-batching image serving over compiled fold schedules."""
