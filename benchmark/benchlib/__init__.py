"""Shared pieces of the benchmark harness."""
